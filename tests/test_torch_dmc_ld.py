"""Port parity, DMC-LD: dcvc_tpu_torch's DMCLD and DMCLDCodec against
dcvc_tpu's at TINY_LD_CONFIG, float32 on the CPU, on the same weights
(through the bridge) and inputs.

- The checkerboard masks (make_mask_2x, phase_terms_2x) equal the JAX
  ones exactly, odd grids included, and the candidate-domain split /
  merge / valid of the 2x terms equal the JAX ones.
- The bridge gives the port's keys at TINY_LD_CONFIG and round-trips
  through dcvc_tpu's reference-checkpoint importer (the published
  config's keys and shapes: tests/test_torch_full_depth.py).
- Stage parity: z_int8 exact, floats within 1e-5 of each tensor's peak
  (the bound of tests/test_torch_dmc_ht.py), frames within an absolute
  1e-4.
- The codec: 4 frames after a DMCI-style seed frame, reset_feature_memory
  on the third, on an even (4x4) and an odd (5x7) y grid: the streams are
  byte-identical to the JAX DMCLDCodec's, the port's round trip is
  bit-exact with equal final DPBs, and device_ec (K2's plain version on
  the CPU: 2 calls per frame, z and one y pass) gives the host decode's
  frames and DPB.  The damped random prior (init_scale 0.5, as bench.py)
  puts every scale at or below the skip threshold, so the scale third of
  the fusion output's bias is lifted by 2 (as the HT tests do) so that y
  symbols are coded.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.core import masks as jmasks
from dcvc_tpu.models.dmc_ld import DMCLD as JaxDMCLD
from dcvc_tpu.models.dmc_ld import TINY_LD_CONFIG as JAX_TINY
from dcvc_tpu.runtime.video_codec import DMCLDCodec as JaxCodec
from dcvc_tpu.utils.torch_import import import_state_dict, key_fn_dmc_ld
from dcvc_tpu_torch.core import masks
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.runtime import image_codec
from dcvc_tpu_torch.runtime.video_codec import DMCLDCodec
from dcvc_tpu_torch.utils.jax_bridge import dmc_ld_params_from_jax

from test_torch_video_codec import check_sequence_calls

REL = 1e-5
X_HAT_ATOL = 1e-4
QP = 3
CASES = [(64, 64, 3), (80, 112, 5)]
RESETS = [False, False, True, False]


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL * scale


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ----------------------------------------------------------------- masks

@pytest.mark.parametrize("h,w,c", [(4, 6, 8), (5, 7, 16), (1, 1, 2),
                                   (45, 80, 16)])
def test_mask_2x_matches_jax(h, w, c):
    got, want = masks.make_mask_2x(h, w, c), jmasks.make_mask_2x(h, w, c)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == np.bool_
        np.testing.assert_array_equal(g, w_)
    assert masks.phase_terms_2x(c) == jmasks.phase_terms_2x(c)
    # the two steps' masks cover every position once
    np.testing.assert_array_equal(got[0] ^ got[1], np.ones((h, w, c), bool))


@pytest.mark.parametrize("h,w", [(4, 6), (5, 7), (45, 80), (1, 1)])
def test_phase_split_merge_valid_2x_match_jax(h, w):
    c = 16
    y = _rand((1, h, w, c), h * w)
    terms = masks.phase_terms_2x(c)
    for t, mask in zip(terms, masks.make_mask_2x(h, w, c)):
        split = masks.phase_split(torch.from_numpy(y), t)
        np.testing.assert_array_equal(
            split.numpy(), np.asarray(jmasks.phase_split(jnp.asarray(y), t)))
        np.testing.assert_array_equal(
            masks.phase_valid(h, w, masks.terms_key(t)),
            jmasks.phase_valid(h, w, jmasks.terms_key(t)))
        merged = masks.phase_merge(split, t, c, h, w)
        np.testing.assert_array_equal(
            merged.numpy(),
            np.asarray(jmasks.phase_merge(jnp.asarray(split.numpy()), t, c,
                                          h, w)))
        # the merge of one step is the input under that step's mask
        np.testing.assert_array_equal(merged.numpy()[0], y[0] * mask)


def test_grid_plan_2x():
    p = image_codec.grid_plan(720, 1280, 16, 8, "cpu", steps=2)
    assert p["y"] == (45, 80) and p["cand"] == (23, 40)
    assert p["cand_ch"] == 32 and p["n_cand"] == 23 * 40 * 32
    assert len(p["terms"]) == 2 and len(p["valid"]) == 2
    # the odd row's padded candidates are not coded
    assert int(sum(v.sum() for v in p["valid"])) == 45 * 80 * 16
    with pytest.raises(ValueError):
        image_codec.grid_plan(64, 64, 16, 8, "cpu", steps=3)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def jax_codec():
    """The JAX codec at TINY_LD_CONFIG (kernels damped by 0.5), with the
    scale third of the fusion output's bias lifted by 2."""
    init = JaxCodec.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY,
                                dtype=jnp.float32, init_scale=0.5)
    params = jax.tree.map(np.array, init.params)
    cy = JAX_TINY.ch_y
    params["y_prior_fusion"]["layers_3"]["conv"]["bias"][cy:2 * cy] += 2.0
    return JaxCodec(init.model, params)


@pytest.fixture(scope="module")
def models(jax_codec):
    tmodel = DMCLD(TINY_LD_CONFIG)
    tmodel.load_state_dict(dmc_ld_params_from_jax(jax_codec.params))
    return jax_codec.model, {"params": jax_codec.params}, tmodel.eval()


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(JaxDMCLD, method))


def test_state_dict_keys_match_bridge(models):
    _, v, tmodel = models
    state = dmc_ld_params_from_jax(v["params"])
    assert {k: tuple(t.shape) for k, t in state.items()} == \
        {k: tuple(t.shape) for k, t in tmodel.state_dict().items()}


def test_bridge_round_trips_through_importer(models):
    """The port's state_dict, read by dcvc_tpu's reference-checkpoint
    importer, gives back the flax params exactly and leaves no key."""
    _, v, tmodel = models
    state = {k: t.numpy() for k, t in tmodel.state_dict().items()}
    params, unused = import_state_dict(state, v["params"],
                                       key_fn=key_fn_dmc_ld)
    assert unused == []
    got = jax.tree_util.tree_leaves_with_path(params)
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(want[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_temporal_stages_match_flax(models):
    jmodel, v, tmodel = models
    c = TINY_LD_CONFIG
    ref = _rand((1, 8, 8, c.ch_src), 1, -0.5, 0.5)
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
    assert got_r.shape == (1, 8, 8, c.ch_src)
    _close(got_r, _j(jmodel, v, "reset_feature", jnp.asarray(feat)))


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_coding_stages_match_flax(models, h, w):
    jmodel, v, tmodel = models
    c = TINY_LD_CONFIG
    x = _rand((1, h, w, 3), h, -0.5, 0.5)
    ctx = _rand((1, h // 8, w // 8, c.ch_d), h + 1)
    mem = _rand((1, h // 8, w // 8, c.ch_m), h + 2)

    y_j, z_j = _j(jmodel, v, "analysis", jnp.asarray(x), jnp.asarray(ctx),
                  QP)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x),
                                   torch.from_numpy(ctx), QP)
    _close(y_t, y_j)
    assert z_t.dtype == torch.int8
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))

    yh, yw = y_j.shape[1], y_j.shape[2]
    prior_j = _j(jmodel, v, "prior0", z_j, jnp.asarray(mem), QP, yh, yw)
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        prior_t = tmodel.prior0(torch.from_numpy(np.array(z_j)),
                                torch.from_numpy(mem), QP, yh, yw)
        step_t = tmodel.prior_step(torch.from_numpy(np.array(prior_j[4])),
                                   torch.from_numpy(y_hat))
        feat_t = tmodel.synthesis_feature(torch.from_numpy(y_hat),
                                          torch.from_numpy(ctx), QP)
        frames_t = tmodel.recon_frames(feat_t, QP, h, w)
    for got, want in zip(prior_t, prior_j):
        _close(got, want)
    _close(step_t, _j(jmodel, v, "prior_step", prior_j[4],
                      jnp.asarray(y_hat)))
    feat_j = _j(jmodel, v, "synthesis_feature", jnp.asarray(y_hat),
                jnp.asarray(ctx), QP)
    _close(feat_t, feat_j)
    frames_j = np.asarray(_j(jmodel, v, "recon_frames", feat_j, QP, h, w))
    assert frames_t.shape == (1, h, w, 3)
    np.testing.assert_allclose(frames_t.numpy(), frames_j, rtol=0,
                               atol=X_HAT_ATOL)


def test_random_init_is_seeded_and_damps_every_conv():
    a = DMCLDCodec.init_random(torch.Generator().manual_seed(5),
                               cfg=TINY_LD_CONFIG, init_scale=0.5,
                               dtype=torch.float32, device="cpu")
    b = DMCLD(TINY_LD_CONFIG)
    b.reset_parameters(torch.Generator().manual_seed(5))
    damped = 0
    for name, pb in b.state_dict().items():
        pa = a.model.state_dict()[name]
        assert torch.isfinite(pa).all(), name
        if name.endswith(".weight"):       # recon head included
            assert torch.equal(pa, 0.5 * pb), name
            damped += 1
        else:
            assert torch.equal(pa, pb), name
    assert damped > 0
    assert torch.all(a.model.q_feature == 1.0)
    assert a.steps == 2 and a.single_pass and a.frame_delay == 1


# ---------------------------------------------------------------- codec

def _frames(h, w, seed):
    """A seed frame and len(RESETS) slowly moving smooth frames."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 3.0)
    frames = [np.clip(np.roll(base, i, axis=1)
                      + rng.normal(0, 0.01, (h, w, 3)), 0, 1) - 0.5
              for i in range(len(RESETS) + 1)]
    frames = [f[None].astype(np.float32) for f in frames]
    return frames[0], frames[1:]


@pytest.fixture(scope="module")
def tcodec(jax_codec):
    return DMCLDCodec(dmc_ld_params_from_jax(jax_codec.params),
                      cfg=TINY_LD_CONFIG, dtype=torch.float32, device="cpu")


def _encode(codec, intra, frames, qp, recon=True):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.compress(x, qp, reset_feature_memory=rs, recon=recon)
            for x, rs in zip(frames, RESETS)]


def _decode(codec, intra, streams, qp, h, w):
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    return [codec.decompress(bs, qp, h, w, ec, reset_feature_memory=rs)
            ["x_hat"] for (bs, ec), rs in zip(streams, RESETS)]


@pytest.mark.parametrize("h,w,qp", CASES)
def test_streams_byte_identical_to_jax(jax_codec, tcodec, h, w, qp):
    intra, frames = _frames(h, w, qp)
    jres = _encode(jax_codec, intra, frames, qp)
    res = _encode(tcodec, intra, frames, qp)
    for u, (r, j) in enumerate(zip(res, jres)):
        assert len(j["bit_stream"]) > 40, "the frame codes no y symbol"
        assert r["ec_parallel"] == j["ec_parallel"], f"frame {u}"
        assert r["bit_stream"] == j["bit_stream"], f"frame {u}"
        assert r["x_hat"].shape == (1, h, w, 3)
        np.testing.assert_allclose(
            r["x_hat"].numpy(), np.asarray(j["x_hat"]).reshape(1, h, w, 3),
            rtol=0, atol=X_HAT_ATOL, err_msg=f"frame {u}")
    # the port decodes the JAX streams
    outs = _decode(tcodec, intra, [(j["bit_stream"], j["ec_parallel"])
                                   for j in jres], qp, h, w)
    for u, (x_hat, r) in enumerate(zip(outs, res)):
        assert torch.equal(x_hat, r["x_hat"]), f"frame {u}"


@pytest.mark.parametrize("h,w,qp", CASES)
def test_roundtrip_and_device_decode_bit_exact(tcodec, monkeypatch, h, w,
                                               qp):
    calls = [0]
    real = image_codec.rans_decode

    def counted(*args):
        calls[0] += 1
        return real(*args)
    monkeypatch.setattr(image_codec, "rans_decode", counted)
    intra, frames = _frames(h, w, qp)
    res = _encode(tcodec, intra, frames, qp)
    enc_dpb = tcodec.ref_feature
    streams = [(r["bit_stream"], r["ec_parallel"]) for r in res]
    host = _decode(tcodec, intra, streams, qp, h, w)
    host_dpb = tcodec.ref_feature
    assert tcodec.memory is not None        # the last frame had no reset
    tcodec.device_ec = True
    try:
        dev = _decode(tcodec, intra, streams, qp, h, w)
    finally:
        tcodec.device_ec = False
    assert calls[0] == 2 * len(RESETS)
    for u, r in enumerate(res):
        assert bool(torch.isfinite(host[u]).all())
        assert torch.equal(host[u], r["x_hat"]), f"frame {u}"
        assert torch.equal(dev[u], host[u]), f"frame {u}"
    assert torch.equal(host_dpb, enc_dpb)
    assert torch.equal(tcodec.ref_feature, enc_dpb)


def test_sequence_calls_match_jax_pipelined(jax_codec, tcodec):
    """LD (frames, the checkerboard's single pass): compress_sequence /
    decompress_sequence against the JAX codec's and the serial calls, a
    reset on the third frame (check_sequence_calls)."""
    h, w, qp = CASES[0]
    intra, frames = _frames(h, w, qp)
    check_sequence_calls(jax_codec, tcodec, intra, frames,
                         [qp, qp + 1, qp, qp], RESETS, h, w)
