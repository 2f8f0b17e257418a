"""The port's copy of the legacy-family stream containers
(dcvc_tpu_torch/bitstream/legacy_container.py): a byte-for-byte copy of
dcvc_tpu's, so its DCVC-RT NAL stream (SPS, I and P NALs) is the JAX
writer's bytes, reads back, and dedupes its SPS the same way."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import io
import os

import pytest

from dcvc_tpu.bitstream import legacy_container as jlc
from dcvc_tpu_torch.bitstream import legacy_container as lc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_copy_is_byte_equal():
    def read(rel):
        with open(os.path.join(REPO, rel), "rb") as f:
            return f.read()
    assert read("dcvc_tpu_torch/bitstream/legacy_container.py") == \
        read("dcvc_tpu/bitstream/legacy_container.py")


def _rt_stream(mod, frames):
    """An RT stream: an SPS when the helper says it is new, then each
    frame's IP NAL with its qp."""
    f = io.BytesIO()
    helper = mod.RTSPSHelper()
    for (h, w, ec, is_i, qp, payload) in frames:
        sps = {"height": h, "width": w, "use_ada_i": 0, "ec_part": ec}
        sps_id, new = helper.get_sps_id(sps)
        if new:
            mod.rt_write_sps(f, {**sps, "sps_id": sps_id})
        mod.rt_write_ip(f, is_i, sps_id, qp, payload)
    return f.getvalue()


FRAMES = [
    (1080, 1920, 1, True, 32, b"\x01" * 300),
    (1080, 1920, 1, False, 40, b"\x02" * 70000),   # a 3-byte length
    (1080, 1920, 1, False, 36, b""),
    (720, 1280, 1, True, 71, bytes(range(256))),   # a new SPS
    (64, 64, 0, False, 0, b"\x07" * 5),
]


def test_rt_stream_bytes_equal_the_jax_writer():
    got = _rt_stream(lc, FRAMES)
    assert got == _rt_stream(jlc, FRAMES)
    assert len(got) > 70000


def test_rt_stream_reads_back():
    f = io.BytesIO(_rt_stream(lc, FRAMES))
    helper = lc.RTSPSHelper()
    seen = []
    while len(seen) < len(FRAMES):
        header = lc.rt_read_header(f)
        if header["nal_type"] == lc.RT_NAL_SPS:
            helper.add_sps_by_id(lc.rt_read_sps_remaining(f,
                                                          header["sps_id"]))
            continue
        sps = helper.get_sps_by_id(header["sps_id"])
        qp, payload = lc.rt_read_ip_remaining(f)
        seen.append((sps["height"], sps["width"], sps["ec_part"],
                     header["nal_type"] == lc.RT_NAL_I, qp, payload))
    assert seen == FRAMES
    assert f.read() == b""


def test_rt_sps_dedupe():
    helper = lc.RTSPSHelper()
    a = {"height": 64, "width": 64, "use_ada_i": 0, "ec_part": 0}
    assert helper.get_sps_id(a) == (0, True)
    assert helper.get_sps_id(dict(a)) == (0, False)
    assert helper.get_sps_id({**a, "ec_part": 1}) == (1, True)
    assert helper.get_sps_id({**a, "width": 96}) == (2, True)
    assert helper.get_sps_id(a) == (0, False)
    with pytest.raises(AssertionError):
        lc.rt_write_sps(io.BytesIO(), {**a, "sps_id": 0, "ec_part": 2})
