"""Port parity, the DMC-HTS chunk codec end to end: dcvc_tpu_torch's
DMCHTCodec against dcvc_tpu's at TINY_HT_CONFIG, float32 on the CPU, on
the same weights (through the bridge), frames and qp.

Each case codes three 8-frame chunks from a DPB seeded with the first
frame, with reset_feature_memory on the second chunk (so the third starts
over from the recon head's reset feature, through feature_adaptor_i).
64x64 gives an even 4x4 y grid, 80x112 an odd 5x7 one.  The port's round
trip must be bit-exact with equal final DPBs, its streams byte-identical
to the JAX codec's, and it must decode the JAX streams.  Reconstructions
of the two codecs are compared within an absolute 1e-4, the bound of
tests/test_torch_dmc_ht.py for the recon stage.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxCodec
from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax

CASES = [(64, 64, 3), (80, 112, 5)]
RESETS = [False, True, False]
X_HAT_ATOL = 1e-4


def _chunks(h, w, seed):
    """Intra frame + three chunks of slowly moving smooth frames."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 3.0)
    frames = [np.clip(np.roll(base, i, axis=1)
                      + rng.normal(0, 0.01, (h, w, 3)), 0, 1) - 0.5
              for i in range(8 * len(RESETS))]
    frames = [f[None].astype(np.float32) for f in frames]
    chunks = [np.concatenate(frames[8 * u:8 * u + 8], axis=-1)
              for u in range(len(RESETS))]
    return frames[0], chunks


@pytest.fixture(scope="module")
def codecs():
    # init_scale 0.5, as bench.py: the untrained temporal recurrence
    # overflows at full scale by the third chunk.  The damped random prior
    # puts every scale at or below the skip threshold, so nothing but z
    # would be coded; the scale third of the fusion output's bias is
    # lifted by 2 (on the shared weights) so that y symbols are coded.
    init = JaxCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                dtype=jnp.float32, init_scale=0.5)
    params = jax.tree.map(np.array, init.params)
    cy = JAX_TINY.ch_y
    params["y_prior_fusion"]["conv_3"]["conv"]["bias"][cy:2 * cy] += 2.0
    jcodec = JaxCodec(init.model, params)
    tcodec = DMCHTCodec(dmc_ht_params_from_jax(params), cfg=TINY_HT_CONFIG,
                        dtype=torch.float32, device="cpu")
    return jcodec, tcodec


def _encode(codec, intra, chunks, qp, recon=True):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.compress(x, qp, reset_feature_memory=rs, recon=recon)
            for x, rs in zip(chunks, RESETS)]


@pytest.fixture(scope="module")
def jax_results(codecs):
    """The JAX codec's streams and reconstructions of each case."""
    jcodec, _ = codecs
    out = {}
    for h, w, qp in CASES:
        intra, chunks = _chunks(h, w, qp)
        res = _encode(jcodec, intra, chunks, qp)
        out[(h, w, qp)] = (intra, chunks, [
            (r["bit_stream"], r["ec_parallel"],
             np.asarray(r["x_hat"]).reshape(8, h, w, 3)) for r in res])
    return out


def _decode(codec, intra, streams, qp, h, w):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.decompress(bs, qp, h, w, ec, reset_feature_memory=rs)
            ["x_hat"] for (bs, ec), rs in zip(streams, RESETS)]


@pytest.mark.parametrize("h,w,qp", CASES)
def test_roundtrip_bit_exact(codecs, h, w, qp):
    _, tcodec = codecs
    intra, chunks = _chunks(h, w, qp)
    res = _encode(tcodec, intra, chunks, qp)
    enc_dpb = tcodec.ref_feature
    outs = _decode(tcodec, intra,
                   [(r["bit_stream"], r["ec_parallel"]) for r in res],
                   qp, h, w)
    for u, (r, x_hat) in enumerate(zip(res, outs)):
        assert x_hat.shape == (8, h, w, 3)
        assert bool(torch.isfinite(x_hat).all())
        assert torch.equal(r["x_hat"], x_hat), f"chunk {u}"
    assert torch.equal(enc_dpb, tcodec.ref_feature)
    assert tcodec.memory is not None        # the last chunk had no reset


@pytest.mark.parametrize("h,w,qp", CASES)
def test_streams_byte_identical_to_jax(codecs, jax_results, h, w, qp):
    _, tcodec = codecs
    intra, chunks, jres = jax_results[(h, w, qp)]
    res = _encode(tcodec, intra, chunks, qp)
    for u, (r, (bs, ec, x_hat)) in enumerate(zip(res, jres)):
        assert len(bs) > 40, "the case codes (almost) no y symbol"
        assert r["ec_parallel"] == ec, f"chunk {u}"
        assert r["bit_stream"] == bs, f"chunk {u}"
        np.testing.assert_allclose(r["x_hat"].numpy(), x_hat, rtol=0,
                                   atol=X_HAT_ATOL, err_msg=f"chunk {u}")


@pytest.mark.parametrize("h,w,qp", CASES)
def test_decodes_jax_streams(codecs, jax_results, h, w, qp):
    _, tcodec = codecs
    intra, _, jres = jax_results[(h, w, qp)]
    outs = _decode(tcodec, intra, [(bs, ec) for bs, ec, _ in jres], qp, h, w)
    for u, (x_hat, (_, _, want)) in enumerate(zip(outs, jres)):
        np.testing.assert_allclose(x_hat.numpy(), want, rtol=0,
                                   atol=X_HAT_ATOL, err_msg=f"chunk {u}")


def test_sequence_calls_match_serial(codecs):
    """compress_sequence / decompress_sequence give the serial calls'
    streams, frames and DPB."""
    _, tcodec = codecs
    h, w, qp = CASES[1]
    intra, chunks = _chunks(h, w, qp)
    qps = [qp, qp, qp - 1]
    tcodec.clear_dpb()
    tcodec.add_ref_feature_from_frame(intra)
    serial = [tcodec.compress(x, q, rs) for x, q, rs in
              zip(chunks, qps, RESETS)]
    serial_dpb = tcodec.ref_feature
    tcodec.clear_dpb()
    tcodec.add_ref_feature_from_frame(intra)
    seq = tcodec.compress_sequence(chunks, qps, RESETS)
    assert torch.equal(tcodec.ref_feature, serial_dpb)
    for a, b in zip(serial, seq):
        assert a["bit_stream"] == b["bit_stream"]
        assert a["ec_parallel"] == b["ec_parallel"]
        assert b["x_hat"] is None

    streams = [r["bit_stream"] for r in seq]
    ecs = [r["ec_parallel"] for r in seq]
    tcodec.clear_dpb()
    tcodec.add_ref_feature_from_frame(intra)
    serial_out = [tcodec.decompress(bs, q, h, w, ec, rs)["x_hat"]
                  for bs, q, ec, rs in zip(streams, qps, ecs, RESETS)]
    tcodec.clear_dpb()
    tcodec.add_ref_feature_from_frame(intra)
    seq_out = tcodec.decompress_sequence(streams, qps, h, w, ecs, RESETS)
    assert torch.equal(tcodec.ref_feature, serial_dpb)
    for a, b in zip(serial_out, seq_out):
        assert torch.equal(a, b)


def test_dpb_must_be_seeded(codecs):
    _, tcodec = codecs
    tcodec.clear_dpb()
    with pytest.raises(ValueError, match="DPB empty"):
        tcodec.compress(np.zeros((1, 64, 64, 24), np.float32), 0)
