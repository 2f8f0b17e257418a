"""Port parity, the DCVC-DC P-frame codec: dcvc_tpu_torch's
runtime/dc_codec.py DMCDCCodec (FM's runtime on DMCDC) against
dcvc_tpu's at TINY_DC_CONFIG, float32 on the CPU, on the same weights.

The weights are tests/test_torch_dcvc_dc.py's lifted seeded init
(lifted_model), so that every stream codes non-zero y and mv symbols and
every q_index its own quant scalars (at the codec's init_scale 0.4 with
the anchors at one, every symbol is 0 and every q_index gives q = 1).
The JAX codec is built around the bridged params (dc_params_to_jax); its
init_random is never called.

- The streams of 3 P frames after an intra-seeded DPB, fa_idx on DC's
  INDEX_MAP schedule, are byte-identical to the JAX codec's at 64x64 and
  at 48x80 (the odd 3x5 latent grid, padded to 64x96: the pad to 32 makes
  it even), at fine q_index 0, 30 and 63; x_hat and the DPB within
  atol = rtol = 2e-5.
- The port decodes its own streams bit-exactly (x_hat and the DPB), and
  two encodes give the same bytes.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu_torch.legacy.dcvc_dc import INDEX_MAP, TINY_DC_CONFIG as TINY
from dcvc_tpu_torch.legacy.dcvc_fm import DPB_KEYS
from dcvc_tpu_torch.runtime.dc_codec import DMCDCCodec
from test_torch_dcvc_dc import jax_codec, lifted_model
from test_torch_dcvc_fm import fm_frames

TOL = 2e-5
SIZES = [(64, 64), (48, 80)]
Q_INDEXES = [0, 30, 63]


@pytest.fixture(scope="module")
def state():
    return lifted_model().state_dict()


@pytest.fixture(scope="module")
def jcodec(state):
    return jax_codec(state)


@pytest.fixture(scope="module")
def tcodec(state):
    return DMCDCCodec(state, cfg=TINY, device="cpu")


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
        r = codec.compress(frames[i], q, fa_idx=INDEX_MAP[i % 4])
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
        fa = INDEX_MAP[i % 4]
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
        out = tcodec.decompress(s, q, h, w, fa_idx=INDEX_MAP[i % 4])
        assert out["x_hat"].shape == (1, h, w, 3)
        assert torch.equal(out["x_hat"], x_hat), i
    for k in DPB_KEYS:
        assert torch.equal(tcodec.dpb[k], enc_dpb[k]), k


def test_q_index_changes_the_stream(tcodec):
    frames = fm_frames(64, 64, 2, seed=7)
    sizes = [len(_encode(tcodec, frames, q)[0][0]) for q in Q_INDEXES]
    assert len(set(sizes)) == len(sizes)


def test_empty_dpb_raises(state):
    codec = DMCDCCodec(state, cfg=TINY, device="cpu")
    with pytest.raises(ValueError, match="DPB empty"):
        codec.compress(fm_frames(32, 32, 1)[0], 0)
    with pytest.raises(ValueError, match="DPB empty"):
        codec.decompress(b"", 0, 32, 32)
