"""Port parity, the DCVC-HEM P-frame codec: dcvc_tpu_torch's
runtime/hem_codec.py DMCHEMCodec against dcvc_tpu's at TINY_HEM_CONFIG,
float32 on the CPU, on the same weights (tests/test_torch_dcvc_hem.py's
lifted seeded init, bridged to flax by hem_params_to_jax; the JAX
codec's init_random is never called).

- The streams of 3 P frames after an intra-seeded DPB are byte-identical
  to the JAX codec's at 64x64 and at 48x80 (the odd 3x5 latent grid,
  padded to 64x128 by the pad to 64), at the q scales of the family
  runner's ladders at q index 0, 30 and 63; x_hat and the 4-tensor DPB
  within atol = rtol = 2e-5; mv and y symbols are coded.
- The port decodes its own streams bit-exactly (x_hat and the DPB), two
  encodes give the same bytes, and the bytes do not depend on torch's
  thread count (1 or 4).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu_torch.eval.family import interpolate_log
from dcvc_tpu_torch.legacy.dcvc_hem import DPB_KEYS, TINY_HEM_CONFIG as TINY
from dcvc_tpu_torch.runtime.hem_codec import DMCHEMCodec
from test_torch_dcvc_fm import fm_frames
from test_torch_dcvc_hem import jax_codec, lifted_model

TOL = 2e-5
SIZES = [(64, 64), (48, 80)]
MV_Q_SCALES = interpolate_log(0.5, 2.0)     # the family runner's ladders
Y_Q_SCALES = interpolate_log(0.3, 3.0)
Q_INDEXES = [0, 30, 63]


def q_scales(q):
    return float(MV_Q_SCALES[q]), float(Y_Q_SCALES[q])


@pytest.fixture(scope="module")
def state():
    return lifted_model().state_dict()


@pytest.fixture(scope="module")
def jcodec(state):
    return jax_codec(state)


@pytest.fixture(scope="module")
def tcodec(state):
    return DMCHEMCodec(state, cfg=TINY, device="cpu")


class _Spy:
    """Records the encoder's int16 y_q candidates (mv parts, then y)."""

    def __init__(self, codec):
        self.codec, self.orig, self.seen = codec, codec._enc_quant, []

    def __call__(self, *args):
        out = self.orig(*args)
        self.seen.append(out)
        return out

    def __enter__(self):
        self.codec._enc_quant = self
        return self

    def __exit__(self, *exc):
        del self.codec._enc_quant


def _encode(codec, frames, q):
    """Seed the DPB with frames[0] and code the rest; (streams, x_hats)."""
    codec.set_ref_frame(frames[0])
    out = [codec.compress(f, *q_scales(q)) for f in frames[1:]]
    return [r["bit_stream"] for r in out], [r["x_hat"] for r in out]


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("q", Q_INDEXES)
def test_streams_match_jax(jcodec, tcodec, h, w, q):
    frames = fm_frames(h, w, 4, seed=h)
    jcodec.set_ref_frame(jnp.asarray(frames[0]), h, w)
    tcodec.set_ref_frame(frames[0])
    for i in range(1, 4):
        want = jcodec.compress(jnp.asarray(frames[i]), *q_scales(q), h=h,
                               w=w)
        with _Spy(tcodec) as spy:
            got = tcodec.compress(frames[i], *q_scales(q))
        assert got["bit_stream"] == want["bit_stream"], i
        np.testing.assert_allclose(got["x_hat"].numpy(),
                                   np.asarray(want["x_hat"]), rtol=TOL,
                                   atol=TOL)
        mv = torch.cat([t.flatten() for t in spy.seen[:2]])
        y = torch.cat([t.flatten() for t in spy.seen[2:]])
        assert int((mv != 0).sum()) > 0 and int((y != 0).sum()) > 0
    for k in DPB_KEYS:
        np.testing.assert_allclose(tcodec.dpb[k].numpy(),
                                   np.asarray(jcodec.dpb[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert tcodec.dpb["ref_frame"].shape[1:3] == (-(-h // 64) * 64,
                                                  -(-w // 64) * 64)


@pytest.mark.parametrize("h,w", SIZES)
def test_round_trip_bit_exact_and_repeatable(tcodec, h, w):
    frames = fm_frames(h, w, 4, seed=h + 1)
    q = 30
    streams, x_hats = _encode(tcodec, frames, q)
    enc_dpb = dict(tcodec.dpb)
    again, _ = _encode(tcodec, frames, q)
    assert again == streams
    tcodec.set_ref_frame(frames[0])
    for s, x_hat in zip(streams, x_hats):
        out = tcodec.decompress(s, *q_scales(q), h, w)
        assert out["x_hat"].shape == (1, h, w, 3)
        assert torch.equal(out["x_hat"], x_hat)
    for k in DPB_KEYS:
        assert torch.equal(tcodec.dpb[k], enc_dpb[k]), k


def test_streams_do_not_depend_on_thread_count(tcodec):
    frames = fm_frames(64, 64, 3, seed=5)
    before = torch.get_num_threads()
    runs = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            runs.append(_encode(tcodec, frames, 0)[0])
    finally:
        torch.set_num_threads(before)
    assert runs[0] == runs[1]


def test_q_scale_changes_the_stream(tcodec):
    frames = fm_frames(64, 64, 2, seed=7)
    sizes = [len(_encode(tcodec, frames, q)[0][0]) for q in Q_INDEXES]
    assert len(set(sizes)) == len(sizes)


def test_empty_dpb_raises(state):
    codec = DMCHEMCodec(state, cfg=TINY, device="cpu")
    with pytest.raises(ValueError, match="DPB empty"):
        codec.compress(fm_frames(32, 32, 1)[0], 1.0, 1.0)
    with pytest.raises(ValueError, match="DPB empty"):
        codec.decompress(b"", 1.0, 1.0, 32, 32)
