"""Port parity, DMC-HTL (DMCHTConfig(is_hts=False), the ladder codec):
dcvc_tpu_torch's DMCHT stage methods and DMCHTCodec against dcvc_tpu's at
TINY_HTL_CONFIG, float32 on the CPU, on the same weights (through the
bridge, hts=False), inputs and qp.

Stages: z_int8 exact, floats within 1e-5 of each tensor's peak, frames
within an absolute 1e-4 (the bounds of tests/test_torch_dmc_ht.py).  The
codec codes three 8-frame chunks from a DPB seeded with the first frame,
with reset_feature_memory on the second, at 64x64 (even 4x4 y grid) and
80x112 (odd 5x7): the port's round trip is bit-exact with equal final
DPBs, its streams are byte-identical to the JAX codec's, and it decodes
the JAX streams.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmc_ht import DMCHT as JaxDMCHT
from dcvc_tpu.models.dmc_ht import TINY_HTL_CONFIG as JAX_TINY
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxCodec
from dcvc_tpu.utils.torch_import import import_state_dict, key_fn_dmc_ht
from dcvc_tpu_torch.layers.blocks import SubpelConv2x
from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HTL_CONFIG
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax

from test_torch_video_codec import RESETS, _chunks, check_sequence_calls

REL = 1e-5
X_HAT_ATOL = 1e-4
QP = 3
CASES = [(64, 64, 3), (80, 112, 5)]


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL * scale


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def codecs():
    # init_scale 0.5, as bench.py.  The damped random priors put every
    # scale at or below the skip threshold, so the scale outputs' biases
    # are lifted by 2 (on the shared weights) so that y symbols are coded:
    # the fusion prior's scale third (step 0) and the spatial prior's
    # scale half (steps 1-3).
    init = JaxCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                dtype=jnp.float32, init_scale=0.5)
    params = jax.tree.map(np.array, init.params)
    cy = JAX_TINY.ch_y
    params["y_prior_fusion"]["conv_3"]["conv"]["bias"][cy:2 * cy] += 2.0
    params["y_spatial_prior"]["conv_3"]["conv"]["bias"][:cy] += 2.0
    jcodec = JaxCodec(init.model, params)
    tcodec = DMCHTCodec(dmc_ht_params_from_jax(params, hts=False),
                        cfg=TINY_HTL_CONFIG, dtype=torch.float32,
                        device="cpu")
    return jcodec, tcodec


@pytest.fixture(scope="module")
def models(codecs):
    jcodec, tcodec = codecs
    return (JaxDMCHT(cfg=JAX_TINY, dtype=jnp.float32),
            {"params": jcodec.params}, tcodec.model)


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(JaxDMCHT, method))


def test_state_dict_keys_and_importer_round_trip(models):
    """The bridge gives exactly the port's keys (recon heads at
    recon_head.conv.{i}.{m}, head 1x1 at entry 5), and dcvc_tpu's
    importer reads the port's state_dict back to the flax params."""
    _, v, tmodel = models
    state = dmc_ht_params_from_jax(v["params"], hts=False)
    assert set(state) == set(tmodel.state_dict())
    assert "recon_head.conv.7.5.weight" in state
    assert not any(k.startswith("recon_head.conv1") for k in state)
    np_state = {k: t.numpy() for k, t in tmodel.state_dict().items()}
    params, unused = import_state_dict(
        np_state, v["params"],
        key_fn=lambda p: key_fn_dmc_ht(p, hts=False))
    assert unused == []
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_subpel_conv_3x3_matches_flax():
    """SubpelConv2x with a 3x3 kernel and bias (HTL's decoder `up`)."""
    from dcvc_tpu.layers.blocks import SubpelConv2x as JaxSubpel
    x = _rand((1, 5, 7, 16), 4)
    jmod = JaxSubpel(24, 3, force_bias=True)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    conv = v["params"]["conv"]
    bias = np.asarray(conv["bias"]) + _rand((96,), 5)
    v = {"params": {"conv": {"kernel": conv["kernel"], "bias": bias}}}
    mod = SubpelConv2x(16, 24, kernel_size=3)
    mod.load_state_dict({
        "conv.0.weight": torch.from_numpy(
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy()),
        "conv.0.bias": torch.from_numpy(bias)})
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    _close(got, jmod.apply(v, jnp.asarray(x)))


def test_temporal_stages_match_flax(models):
    jmodel, v, tmodel = models
    c = TINY_HTL_CONFIG
    ref = _rand((1, 8, 8, c.ch_src_intra), 1, -0.5, 0.5)
    feat = _rand((1, 8, 8, c.ch_d), 2)
    mem = _rand((1, 8, 8, c.ch_m), 3)
    with torch.inference_mode():
        got_i = tmodel.adaptor_i(torch.from_numpy(ref))
        got_m = tmodel.adaptor_m(torch.from_numpy(mem),
                                 torch.from_numpy(feat))
        got_r = tmodel.reset_feature(torch.from_numpy(feat))
    for got, want in zip(got_i, _j(jmodel, v, "adaptor_i", jnp.asarray(ref))):
        _close(got, want)
    for got, want in zip(got_m, _j(jmodel, v, "adaptor_m", jnp.asarray(mem),
                                   jnp.asarray(feat))):
        _close(got, want)
    _close(got_r, _j(jmodel, v, "reset_feature", jnp.asarray(feat)))


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_coding_stages_match_flax(models, h, w):
    jmodel, v, tmodel = models
    c = TINY_HTL_CONFIG
    x = _rand((1, h, w, 3 * c.frame_delay), h, -0.5, 0.5)
    ctx = _rand((1, h // 8, w // 8, c.ch_d), h + 1)
    mem = _rand((1, h // 8, w // 8, c.ch_m), h + 2)

    y_j, z_j = _j(jmodel, v, "analysis", jnp.asarray(x), jnp.asarray(ctx),
                  QP)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x),
                                   torch.from_numpy(ctx), QP)
    _close(y_t, y_j)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))

    yh, yw = y_j.shape[1], y_j.shape[2]
    prior_j = _j(jmodel, v, "prior0", z_j, jnp.asarray(mem), QP, yh, yw)
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        prior_t = tmodel.prior0(torch.from_numpy(np.array(z_j)),
                                torch.from_numpy(mem), QP, yh, yw)
        spctx = torch.from_numpy(np.array(prior_j[4]))
        steps_t = [tmodel.prior_step(spctx, torch.from_numpy(y_hat), k)
                   for k in (1, 2, 3)]
        feat_t = tmodel.synthesis_feature(torch.from_numpy(y_hat),
                                          torch.from_numpy(ctx), QP)
        frames_t = tmodel.recon_frames(feat_t, QP, h, w)
    for got, want in zip(prior_t, prior_j):
        _close(got, want)
    for k, got in zip((1, 2, 3), steps_t):
        want = _j(jmodel, v, "prior_step", prior_j[4], jnp.asarray(y_hat), k)
        assert isinstance(got, tuple) and len(got) == 2  # scales, means
        for g, w_ in zip(got, want):
            _close(g, w_)
    feat_j = _j(jmodel, v, "synthesis_feature", jnp.asarray(y_hat),
                jnp.asarray(ctx), QP)
    _close(feat_t, feat_j)
    frames_j = np.asarray(_j(jmodel, v, "recon_frames", feat_j, QP, h, w))
    assert frames_t.shape == (c.frame_delay, h, w, 3)
    np.testing.assert_allclose(frames_t.numpy(),
                               frames_j.reshape(frames_t.shape), rtol=0,
                               atol=X_HAT_ATOL)


def _encode(codec, intra, chunks, qp, recon=True):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.compress(x, qp, reset_feature_memory=rs, recon=recon)
            for x, rs in zip(chunks, RESETS)]


def _decode(codec, intra, streams, qp, h, w):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.decompress(bs, qp, h, w, ec, reset_feature_memory=rs)
            ["x_hat"] for (bs, ec), rs in zip(streams, RESETS)]


@pytest.fixture(scope="module")
def jax_results(codecs):
    jcodec, _ = codecs
    out = {}
    for h, w, qp in CASES:
        intra, chunks = _chunks(h, w, qp)
        res = _encode(jcodec, intra, chunks, qp)
        out[(h, w, qp)] = (intra, chunks, [
            (r["bit_stream"], r["ec_parallel"],
             np.asarray(r["x_hat"]).reshape(8, h, w, 3)) for r in res])
    return out


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


def test_random_init_is_seeded():
    a, b = DMCHT(TINY_HTL_CONFIG), DMCHT(TINY_HTL_CONFIG)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert a.decoder.up.conv[0].weight.shape[2:] == (3, 3)
    dw = a.recon_head.conv[0][0].dc[2].weight.detach()
    assert 0 < float(dw.std()) < 0.05          # N(0, 0.02), as in the JAX


def test_sequence_calls_match_jax_pipelined(codecs):
    """HTL (the ladder: one index copy per rung): compress_sequence /
    decompress_sequence against the JAX codec's and the serial calls, a
    reset on the second chunk (check_sequence_calls)."""
    jcodec, tcodec = codecs
    h, w, qp = CASES[1]
    intra, chunks = _chunks(h, w, qp)
    check_sequence_calls(jcodec, tcodec, intra, chunks, [qp, qp, qp - 2],
                         RESETS, h, w)
