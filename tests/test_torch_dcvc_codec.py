"""Port parity, the DCVC-2021 P-frame codec: dcvc_tpu_torch's
runtime/dcvc_codec.py (DCVCCodec and its host AR) against dcvc_tpu's at
TINY_DCVC_CONFIG, float32 on the CPU.

- HostAR and its _lrelu are verbatim copies of the JAX package's (pinned
  to the source), and on the same numpy inputs and the same weights
  HostAR.encode gives the JAX arrays exactly; decode inverts it.
- The codec on tests/test_torch_dcvc_net.py's lifted weights (carried to
  the JAX codec by dcvc_params_to_jax; no flax init): three P frames from
  one reference at 64x64 and at the odd 48x80, each frame coding against
  the previous reconstruction, give the JAX codec's four strings (mv_z,
  mv_y, z, y) byte for byte, x_hat within atol = rtol = 2e-5; the
  decoder, from the same reference, reproduces every x_hat and the final
  reference frame bit for bit.  Encoding again from the reference gives
  the same bytes; a P frame with no reference raises.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_net as jnet
from dcvc_tpu.runtime import dcvc_codec as jcodec
from dcvc_tpu_torch.runtime import dcvc_codec
from test_torch_dcvc_net import JAX_TINY, TINY, _close, frames, \
    jax_params, lifted_model

STRINGS = ("mv_z_string", "mv_y_string", "z_string", "y_string")


@pytest.mark.parametrize("name", ["_lrelu", "HostAR"])
def test_copies_pinned(name):
    assert inspect.getsource(getattr(dcvc_codec, name)) == \
        inspect.getsource(getattr(jcodec, name))


@pytest.fixture(scope="module")
def codecs():
    """(the port's codec, the JAX codec) on the same lifted weights."""
    state = lifted_model(seed=1).state_dict()
    port = dcvc_codec.DCVCCodec(state, cfg=TINY, device="cpu")
    jax_codec = jcodec.DCVCCodec(jnet.DCVCNet(cfg=JAX_TINY),
                                 jax_params(state))
    return port, jax_codec


def test_host_ar_matches_jax(codecs):
    port, jax_codec = codecs
    rng = np.random.default_rng(2)
    for ar, jar, c in ((port.ar_y, jax_codec.ar_y, TINY.ch_m),
                       (port.ar_mv, jax_codec.ar_mv, TINY.ch_mv)):
        # y's prior: temporal + hyper (2C); mv's: hyper (2C)
        y = rng.normal(0, 3, (4, 5, c)).astype(np.float32)
        prior = rng.normal(0, 1, (4, 5, 2 * c)).astype(np.float32)
        got, want = ar.encode(y, prior), jar.encode(y, prior)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        y_q, scales, y_hat = got
        it = iter(y_q.reshape(4 * 5, c))
        np.testing.assert_array_equal(
            ar.decode(prior, lambda sc: next(it)), y_hat)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_streams_match_jax(codecs, h, w):
    port, jax_codec = codecs
    ref = frames(h, w, h)[0]
    seq = [np.clip(np.roll(ref, 2 * (i + 1), 2), 0, 1) for i in range(3)]
    port.set_ref_frame(ref, h, w)
    jax_codec.set_ref_frame(ref, h, w)
    encoded = []
    for x in seq:
        got, want = port.compress(x), jax_codec.compress(x)
        for k in STRINGS:
            assert got[k] == want[k], k
        assert len(got["y_string"]) > 40 and len(got["mv_y_string"]) > 20
        assert got["x_hat"].shape == (1, h, w, 3)
        _close(got["x_hat"], want["x_hat"])
        encoded.append(got)
    enc_ref = port.ref_frame
    port.set_ref_frame(ref, h, w)
    again = port.compress(seq[0])
    assert [again[k] for k in STRINGS] == [encoded[0][k] for k in STRINGS]
    port.set_ref_frame(ref, h, w)
    for res in encoded:
        out = port.decompress(res["mv_y_string"], res["mv_z_string"],
                              res["y_string"], res["z_string"], h, w)
        assert torch.equal(out["x_hat"], res["x_hat"])
    assert torch.equal(port.ref_frame, enc_ref)


def test_no_reference_raises():
    codec = dcvc_codec.DCVCCodec.init_random(
        torch.Generator().manual_seed(0), cfg=TINY, init_scale=0.4,
        device="cpu")
    with pytest.raises(RuntimeError, match="no reference frame"):
        codec.compress(np.zeros((1, 64, 64, 3), np.float32))
