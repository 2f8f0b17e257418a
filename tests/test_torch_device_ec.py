"""The device-entropy decode (device_ec=True) of the port's three codecs at
their TINY configs, float32 on the CPU, where K2's wrapper runs its plain
version: DMCI, DMC-HTS and DMC-HTL must decode to exactly the encoder's
x_hat and final DPB and to the host-coder path's, with K2 called
5 / 2 / 5 times per decode (z, then the y rungs: HTS has one y call).

The weights are the port's own seeded random init (no JAX here); the
video models are damped (init_scale 0.5, as bench.py).  The random priors
put (almost) every scale below the skip threshold, so the biases of the
prior outputs' scales are lifted by 2 so that y symbols are coded (see
tests/test_torch_dmc_htl.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG, TINY_HTL_CONFIG
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.runtime import image_codec
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec

from test_torch_image_codec import _image
from test_torch_video_codec import RESETS, _chunks

IMAGE_CASES = [(64, 64, 0), (80, 112, 5)]
VIDEO_CASES = [(64, 64, 3), (80, 112, 5)]
K2_CALLS = {"dmci": 5, "hts": 2, "htl": 5}


@pytest.fixture
def k2_calls(monkeypatch):
    """Counts the codecs' calls of K2's wrapper."""
    calls = [0]
    real = image_codec.rans_decode

    def counted(*args):
        calls[0] += 1
        return real(*args)
    monkeypatch.setattr(image_codec, "rans_decode", counted)
    return calls


@pytest.fixture(scope="module")
def dmci():
    codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=TINY_CONFIG, dtype=torch.float32,
                                  device="cpu")
    cy = TINY_CONFIG.ch_y
    with torch.no_grad():
        codec.model.y_prior_fusion.conv[3].bias[:cy] += 2.0
        codec.model.y_spatial_prior.conv[3].bias[:cy] += 2.0
    return codec


def _video_codec(cfg):
    codec = DMCHTCodec.init_random(torch.Generator().manual_seed(1),
                                   cfg=cfg, init_scale=0.5,
                                   dtype=torch.float32, device="cpu")
    cy = cfg.ch_y
    with torch.no_grad():
        codec.model.y_prior_fusion.conv[3].bias[cy:2 * cy] += 2.0
        if not cfg.is_hts:
            codec.model.y_spatial_prior.conv[3].bias[:cy] += 2.0
    return codec


@pytest.fixture(scope="module")
def video():
    return {"hts": _video_codec(TINY_HT_CONFIG),
            "htl": _video_codec(TINY_HTL_CONFIG)}


def test_device_ec_is_off_by_default(dmci, video):
    assert not dmci.device_ec
    assert not any(c.device_ec for c in video.values())


@pytest.mark.parametrize("h,w,qp", IMAGE_CASES)
def test_dmci_device_decode_is_exact(dmci, k2_calls, h, w, qp):
    res = dmci.compress(_image(h, w, qp), qp)
    args = (qp, h, w, res["ec_parallel"])
    dmci.device_ec = False
    host = dmci.decompress(res["bit_stream"], *args)["x_hat"]
    dmci.device_ec = True
    try:
        dev = dmci.decompress(res["bit_stream"], *args)["x_hat"]
        assert k2_calls[0] == K2_CALLS["dmci"]
        lanes = dmci.upload_stream(res["bit_stream"], res["ec_parallel"])
        assert lanes.dtype == torch.uint8
        assert lanes.shape[0] == res["ec_parallel"]
        uploaded = dmci.decompress(lanes, *args)["x_hat"]
    finally:
        dmci.device_ec = False
    assert len(res["bit_stream"]) > 100
    assert torch.equal(dev, res["x_hat"]) and torch.equal(dev, host)
    assert torch.equal(uploaded, dev)


def _decode_all(codec, intra, res, qp, h, w):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.decompress(r["bit_stream"], qp, h, w, r["ec_parallel"],
                             reset_feature_memory=rs)["x_hat"]
            for r, rs in zip(res, RESETS)], codec.ref_feature


@pytest.mark.parametrize("variant", ["hts", "htl"])
@pytest.mark.parametrize("h,w,qp", VIDEO_CASES)
def test_video_device_decode_is_exact(video, k2_calls, variant, h, w, qp):
    """Three chunks, a reset on the second: every chunk's frames and the
    final DPB equal on the encoder, the host-coder decode and the device
    decode."""
    codec = video[variant]
    intra, chunks = _chunks(h, w, qp)
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    res = [codec.compress(x, qp, reset_feature_memory=rs, recon=True)
           for x, rs in zip(chunks, RESETS)]
    enc_dpb = codec.ref_feature
    host, host_dpb = _decode_all(codec, intra, res, qp, h, w)
    codec.device_ec = True
    try:
        dev, dev_dpb = _decode_all(codec, intra, res, qp, h, w)
    finally:
        codec.device_ec = False
    assert k2_calls[0] == K2_CALLS[variant] * len(RESETS)
    for u, r in enumerate(res):
        assert len(r["bit_stream"]) > 40, "the chunk codes no y symbol"
        assert torch.equal(dev[u], r["x_hat"]), f"chunk {u}"
        assert torch.equal(dev[u], host[u]), f"chunk {u}"
    assert torch.equal(dev_dpb, enc_dpb) and torch.equal(dev_dpb, host_dpb)


def test_zero_count_rung_decodes_to_zeros():
    """A rung that codes nothing (skip threshold above every scale) gives
    zeros from K2's plain version, as from the host coder."""
    codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=TINY_CONFIG, skip_thres=1e9,
                                  dtype=torch.float32, device="cpu")
    x = _image(64, 64, 1)
    res = codec.compress(x, 2)
    codec.device_ec = True
    out = codec.decompress(res["bit_stream"], 2, 64, 64,
                           res["ec_parallel"])["x_hat"]
    assert torch.equal(out, res["x_hat"])
    assert np.isfinite(out.numpy()).all()


def test_dmci_decompress_many_device_ec_is_exact(dmci, k2_calls):
    """decompress_many (depth 3, 4 images) with device_ec: each image's
    coroutine runs K2 and yields after each rung; the frames are the host
    coder's serial decodes' and the encoder's, with 5 K2 calls an
    image."""
    h, w = 64, 64
    qps = [0, 5, 2, 5]
    enc = [dmci.compress(_image(h, w, 40 + i), qp)
           for i, qp in enumerate(qps)]
    streams = [r["bit_stream"] for r in enc]
    ecs = [r["ec_parallel"] for r in enc]
    host = [dmci.decompress(bs, qp, h, w, ec)["x_hat"]
            for bs, qp, ec in zip(streams, qps, ecs)]
    dmci.device_ec = True
    try:
        lanes = [dmci.upload_stream(bs, ec) for bs, ec in zip(streams, ecs)]
        outs = dmci.decompress_many(lanes, qps, h, w, ecs, depth=3)
    finally:
        dmci.device_ec = False
    assert k2_calls[0] == K2_CALLS["dmci"] * len(qps)
    for r, o, want in zip(enc, outs, host):
        assert torch.equal(o["x_hat"], want)
        assert torch.equal(o["x_hat"], r["x_hat"])


@pytest.mark.parametrize("variant", ["hts", "htl"])
def test_video_decompress_sequence_device_ec_is_exact(video, k2_calls,
                                                      variant):
    """compress_sequence's streams decoded by decompress_sequence with
    device_ec: the host coder's serial frames and final DPB, bit for bit,
    with K2_CALLS per chunk."""
    codec = video[variant]
    h, w, qp = VIDEO_CASES[0]
    intra, chunks = _chunks(h, w, qp)
    qps = [qp] * len(chunks)
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    res = codec.compress_sequence(chunks, qps, RESETS)
    enc_dpb = codec.ref_feature
    host, host_dpb = _decode_all(codec, intra, res, qp, h, w)
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    codec.device_ec = True
    try:
        dev = codec.decompress_sequence(
            [r["bit_stream"] for r in res], qps, h, w,
            [r["ec_parallel"] for r in res], RESETS)
    finally:
        codec.device_ec = False
    assert k2_calls[0] == K2_CALLS[variant] * len(RESETS)
    for u, (d, x_hat) in enumerate(zip(dev, host)):
        assert torch.equal(d, x_hat), f"chunk {u}"
    assert torch.equal(codec.ref_feature, enc_dpb)
    assert torch.equal(host_dpb, enc_dpb)
