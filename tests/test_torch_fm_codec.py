"""Port parity, the DCVC-FM P-frame codec: dcvc_tpu_torch's
runtime/fm_codec.py DMCFMCodec against dcvc_tpu's at TINY_FM_CONFIG,
float32 on the CPU, on the same weights.

The weights are tests/test_torch_dcvc_fm.py's lifted seeded init
(lifted_model: kernels x 0.7, the encoders' last convs x 10, the hyper
encoders' x 8 / x 30, the prior outputs' scale biases + 2, the q anchors
at 0.5 / 2.0 (enc) and 2.0 / 0.5 (dec)), so that every stream codes
non-zero y and mv symbols and every q_index its own quant scalars (at
the codec's init_scale 0.4 with the anchors at one, every symbol is 0
and every q_index gives q = 1).  The JAX codec is built around the
bridged params (fm_params_to_jax); its init_random is never called.

- The streams of 3 P frames after an intra-seeded DPB, fa_idx on
  INDEX_MAP_FM's schedule, are byte-identical to the JAX codec's at 64x64
  and at 48x80 (padded to 64x96: the odd 4x6 latent grid the pad to 32
  makes even), at q_index 0, 4 and qp_num - 1; x_hat and the DPB within
  atol = rtol = 2e-5.
- The port decodes its own streams bit-exactly (x_hat and the DPB), and
  two encodes give the same bytes.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu_torch.eval.family import INDEX_MAP_FM
from dcvc_tpu_torch.legacy.dcvc_fm import DPB_KEYS, TINY_FM_CONFIG as TINY
from dcvc_tpu_torch.runtime.fm_codec import DMCFMCodec
from test_torch_dcvc_fm import fm_frames, jax_codec, lifted_model

TOL = 2e-5
SIZES = [(64, 64), (48, 80)]
Q_INDEXES = [0, 4, TINY.qp_num - 1]


@pytest.fixture(scope="module")
def state():
    return lifted_model().state_dict()


@pytest.fixture(scope="module")
def jcodec(state):
    return jax_codec(state)


@pytest.fixture(scope="module")
def tcodec(state):
    return DMCFMCodec(state, cfg=TINY, device="cpu")


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
    streams, x_hats = [], []
    for i in range(1, len(frames)):
        r = codec.compress(frames[i], q, fa_idx=INDEX_MAP_FM[i])
        streams.append(r["bit_stream"])
        x_hats.append(r["x_hat"])
    return streams, x_hats


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("q", Q_INDEXES)
def test_streams_match_jax(jcodec, tcodec, h, w, q):
    frames = fm_frames(h, w, 4, seed=h)
    jcodec.set_ref_frame(jnp.asarray(frames[0]), h, w)
    tcodec.set_ref_frame(frames[0])
    for i in range(1, 4):
        fa = INDEX_MAP_FM[i]
        want = jcodec.compress(jnp.asarray(frames[i]), q, fa_idx=fa, h=h,
                               w=w)
        with _Spy(tcodec) as spy:
            got = tcodec.compress(frames[i], q, fa_idx=fa)
        assert got["bit_stream"] == want["bit_stream"], (i, fa)
        np.testing.assert_allclose(got["x_hat"].numpy(),
                                   np.asarray(want["x_hat"]), rtol=TOL,
                                   atol=TOL)
        mv = torch.cat([t.flatten() for t in spy.seen[:4]])
        y = torch.cat([t.flatten() for t in spy.seen[4:]])
        assert int((mv != 0).sum()) > 0 and int((y != 0).sum()) > 0
    for k in DPB_KEYS:
        np.testing.assert_allclose(tcodec.dpb[k].numpy(),
                                   np.asarray(jcodec.dpb[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert tcodec.dpb["ref_frame"].shape[1:3] == (-(-h // 32) * 32,
                                                  -(-w // 32) * 32)


@pytest.mark.parametrize("h,w", SIZES)
def test_round_trip_bit_exact_and_repeatable(tcodec, h, w):
    frames = fm_frames(h, w, 4, seed=h + 1)
    q = 4
    streams, x_hats = _encode(tcodec, frames, q)
    enc_dpb = dict(tcodec.dpb)
    again, _ = _encode(tcodec, frames, q)
    assert again == streams
    tcodec.set_ref_frame(frames[0])
    for i, (s, x_hat) in enumerate(zip(streams, x_hats), 1):
        out = tcodec.decompress(s, q, h, w, fa_idx=INDEX_MAP_FM[i])
        assert out["x_hat"].shape == (1, h, w, 3)
        assert torch.equal(out["x_hat"], x_hat), i
    for k in DPB_KEYS:
        assert torch.equal(tcodec.dpb[k], enc_dpb[k]), k


def test_q_index_changes_the_stream(tcodec):
    frames = fm_frames(64, 64, 2, seed=7)
    sizes = [len(_encode(tcodec, frames, q)[0][0]) for q in Q_INDEXES]
    assert len(set(sizes)) == len(sizes)


def test_empty_dpb_raises(state):
    codec = DMCFMCodec(state, cfg=TINY, device="cpu")
    with pytest.raises(ValueError, match="DPB empty"):
        codec.compress(fm_frames(32, 32, 1)[0], 0)
    with pytest.raises(ValueError, match="DPB empty"):
        codec.decompress(b"", 0, 32, 32)
