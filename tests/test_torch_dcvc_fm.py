"""Port parity, the DCVC-FM P-frame model: dcvc_tpu_torch's
legacy/dcvc_fm.py against dcvc_tpu's at TINY_FM_CONFIG, float32 on the
CPU, on the same weights and inputs (made from a numpy seed).

- The weights are the port's seeded init (DMCFM.reset_parameters,
  feature_adaptor_1 cloned into slots 0 and 2 as the codec's init does),
  lifted so that the codec's streams carry symbols (LIFT: every conv
  kernel and the fusion kernel x 0.7, the last convs of the contextual
  and mv encoders x 10, of the contextual and mv hyper encoders x 8 and
  x 30 (SpyNet's flows on the damped weights are ~0.1 px), the scale parts of
  the prior fusions' and spatial priors' last biases + 2, and the q
  anchors at 0.5 / 2.0 (enc) and 2.0 / 0.5 (dec), so that every q_index
  gives its own quant scalars), carried to flax by fm_params_to_jax;
  the JAX model is never initialised.
- Every submodule and every stage method, with the DPB empty and full and
  fa_idx 0, 1 and 2, within atol = rtol = 2e-5; the int16 z of both
  hyper encoders exactly; the training / eval forward (bpp, bits, x_hat)
  with and without JAX's rate noise.
- get_curr_q (XLA's exp / log, emulated) exactly, for every q_index of
  both ladders (TINY's 8 and the published 64).
The weights (the bridge, key_fn_fm, params.v1, .pth.tar) are held by
tests/test_torch_fm_weights.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dcvc_tpu.legacy import dcvc_fm as jfm
from dcvc_tpu_torch.legacy import dcvc_fm
from dcvc_tpu_torch.perf_probe import lifted_fm
from dcvc_tpu_torch.utils.jax_bridge import fm_params_to_jax

TOL = 2e-5
TINY = dcvc_fm.TINY_FM_CONFIG
JAX_TINY = jfm.TINY_FM_CONFIG
Q_INDEX = 5
# the lift of the seeded weights (module docstring)
LIFT = {"init_scale": 0.7, "y_gain": 10.0, "mv_gain": 10.0, "z_gain": 8.0,
        "mv_z_gain": 30.0, "scale_bias": 2.0, "q_enc": (0.5, 2.0),
        "q_dec": (2.0, 0.5), "recon_gain": 1.0, "recon_bias": 0.0}


def lifted_model(seed=0, cfg=TINY, lift=LIFT):
    """The port's DMCFM with seeded weights, lifted as LIFT says
    (perf_probe.lifted_fm, the smoke's lift with the tests' gains)."""
    return lifted_fm(cfg, seed, lift)


def jax_params(state):
    """A port state_dict as the flax param tree (jax arrays)."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        fm_params_to_jax(state))


def jax_codec(state, cfg=JAX_TINY):
    """dcvc_tpu's DMCFMCodec on the port's weights (no flax init)."""
    from dcvc_tpu.runtime.fm_codec import DMCFMCodec as JaxCodec
    return JaxCodec(jfm.DMCFM(cfg=cfg), jax_params(state))


def fm_frames(h, w, n, seed=0):
    """n frames (1, h, w, 3) in [0, 1] of a contrasty smooth picture
    drifting 2 pixels a frame."""
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 1, (h, w, 3)), 4.0)
    base = np.clip((base - 0.5) * 4 + 0.5, 0, 1)
    return [np.clip(np.roll(base, i * 2, 1)
                    + rng.normal(0, 0.01, (h, w, 3)), 0, 1)[None]
            .astype(np.float32) for i in range(n)]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def fm():
    """(port model, flax params, flax model, frames, full DPB): the DPB
    after the JAX eval forward of frame 1 against frame 0."""
    tm = lifted_model().eval()
    jp = jax_params(tm.state_dict())
    jm = jfm.DMCFM(cfg=JAX_TINY)
    frames = fm_frames(64, 64, 4)
    _, dpb = jm.apply({"params": jp}, jnp.asarray(frames[1]),
                      _jax_dpb(frames[0]), Q_INDEX, 1, None)
    return tm, jp, jm, frames, {k: np.asarray(v) for k, v in dpb.items()}


def _jax_dpb(ref_frame):
    return {"ref_frame": jnp.asarray(ref_frame), "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}


def _j(fm, method, *args):
    _, jp, jm, _, _ = fm
    return jm.apply({"params": jp}, *[None if a is None else jnp.asarray(a)
                                      if isinstance(a, np.ndarray) else a
                                      for a in args],
                    method=getattr(jfm.DMCFM, method))


def _ref(fm, full):
    frames, dpb = fm[3], fm[4]
    if full:
        return dpb
    return {"ref_frame": frames[0], "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}


# ---------------------------------------------------------- q and rates

def test_xla_exp_log_match_jax():
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(-20, 20, 200_000)).astype(np.float32)
    got = dcvc_fm.xla_log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.log)(x)))
    y = rng.uniform(-80, 80, 200_000).astype(np.float32)
    got = dcvc_fm.xla_exp_f32(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.exp)(y)))


@pytest.mark.parametrize("qp_num", [TINY.qp_num, dcvc_fm.FM_CONFIG.qp_num])
def test_get_curr_q_exact(qp_num):
    """Every q_index of the ladder, for the anchors at one, LIFT's and
    random ones, equal to the JAX package's jitted get_curr_q bit for
    bit; the model's four scalars too."""
    fn = jax.jit(jfm.get_curr_q, static_argnums=2)
    rng = np.random.default_rng(qp_num)
    anchors = [(1.0, 1.0), (0.5, 2.0), (2.0, 0.5)] + [
        tuple(np.exp(rng.uniform(-3, 3, 2))) for _ in range(6)]
    for lo, hi in anchors:
        a = np.array([lo, hi], np.float32).reshape(2, 1, 1, 1)
        got = np.stack([dcvc_fm.get_curr_q(torch.from_numpy(a), i, qp_num)
                        .numpy() for i in range(qp_num)])
        want = np.stack([np.asarray(fn(jnp.asarray(a), jnp.int32(i), qp_num))
                         for i in range(qp_num)])
        np.testing.assert_array_equal(got, want, err_msg=f"{lo}, {hi}")
    assert len(np.unique(got)) > qp_num // 2


def test_model_q_scalars_exact(fm):
    tm, jp = fm[0], fm[1]
    fn = jax.jit(jfm.get_curr_q, static_argnums=2)
    for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
        for i in range(TINY.qp_num):
            with torch.no_grad():
                got = tm._q(name, i).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(fn(jp[name], jnp.int32(i), TINY.qp_num)))


def test_get_curr_q_gradient_is_torch_formula():
    a = torch.tensor([0.5, 2.0]).view(2, 1, 1, 1).requires_grad_()
    dcvc_fm.get_curr_q(a, 3, 8).sum().backward()
    b = a.detach().clone().requires_grad_()
    torch.exp(torch.log(b[0]) + (torch.log(b[1]) - torch.log(b[0])) / 7
              * 3).sum().backward()
    torch.testing.assert_close(a.grad, b.grad)


def test_laplace_bits_matches_jax():
    rng = np.random.default_rng(1)
    y = np.round(rng.normal(0, 3, 4000)).astype(np.float32)
    s = np.exp(rng.uniform(-6, 3, 4000)).astype(np.float32)
    got = dcvc_fm.laplace_bits(torch.from_numpy(y), torch.from_numpy(s))
    _close(got, jfm.laplace_bits(jnp.asarray(y), jnp.asarray(s)))


# ------------------------------------------------------------ submodules

def _sub(fm, name, jcls, args, cfg=JAX_TINY, port=None):
    """The port's submodule `name` (or `port`) against the flax class
    jcls on the same weights and args."""
    if port is None:
        port, params = getattr(fm[0], name), fm[1][name]
    else:
        params = jax_params(port.state_dict())
    with torch.no_grad():
        got = port(*[_t(a) if isinstance(a, np.ndarray) else a
                     for a in args])
    want = jcls(cfg).apply({"params": params}, *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("groups", ["tiny", "g4"])
def test_offset_diversity_matches_flax(fm, groups):
    """OffsetDiversity: TINY's 2 groups x 2 offsets, and 4 groups of 3
    channels x 2 offsets (the unit order and the g contiguous fusion
    blocks differ from the feature groups)."""
    if groups == "tiny":
        cfg, jcfg, port = TINY, JAX_TINY, None
    else:
        cfg = dataclasses.replace(TINY, ch_1x=12, offset_group=4)
        jcfg = jfm.DMCFMConfig(**dataclasses.asdict(cfg))
        port = dcvc_fm.OffsetDiversity(cfg)
        with torch.no_grad():
            for i, p in enumerate(port.parameters()):
                p.copy_(torch.from_numpy(_rand(*p.shape, seed=i,
                                               scale=0.3)))
    # smooth features, as the extractor's are: the warp's ulp-level
    # sample shifts then move the result by float noise only
    x = gaussian_filter(_rand(1, 32, 40, cfg.ch_1x, seed=1), (0, 2, 2, 0))
    aux = _rand(1, 32, 40, cfg.ch_1x + 5, seed=2)
    flow = _rand(1, 32, 40, 2, seed=3, scale=3.0)
    _sub(fm, "align", jfm.OffsetDiversity, (x, aux, flow), cfg=jcfg,
         port=port)


def test_feature_extractor_matches_flax(fm):
    _sub(fm, "feature_extractor", jfm.FMFeatureExtractor,
         (_rand(1, 32, 32, TINY.ch_1x),))


def test_context_fusion_matches_flax(fm):
    c = TINY
    _sub(fm, "context_fusion_net", jfm.MultiScaleContextFusion,
         (_rand(1, 32, 32, c.ch_1x, seed=1), _rand(1, 16, 16, c.ch_2x,
                                                   seed=2),
          _rand(1, 8, 8, c.ch_4x, seed=3)))


@pytest.mark.parametrize("with_context", [False, True])
def test_mv_encoder_matches_flax(fm, with_context):
    ctx = _rand(1, 16, 16, TINY.ch_mv, seed=4) if with_context else None
    _sub(fm, "mv_encoder", jfm.MvEnc,
         (_rand(1, 64, 64, 2, scale=3.0), ctx, 1.3))


def test_mv_decoder_matches_flax(fm):
    _sub(fm, "mv_decoder", jfm.MvDec,
         (_rand(1, 4, 4, TINY.ch_mv, scale=2.0), 0.7))


def test_contextual_encoder_matches_flax(fm):
    c = TINY
    _sub(fm, "contextual_encoder", jfm.ContextualEncoder,
         (_rand(1, 64, 64, 3, seed=1), _rand(1, 64, 64, c.ch_1x, seed=2),
          _rand(1, 32, 32, c.ch_2x, seed=3), _rand(1, 16, 16, c.ch_4x,
                                                   seed=4),
          1.7))


def test_contextual_decoder_matches_flax(fm):
    c = TINY
    _sub(fm, "contextual_decoder", jfm.ContextualDecoder,
         (_rand(1, 4, 4, c.ch_16x, seed=1), _rand(1, 32, 32, c.ch_2x,
                                                  seed=2),
          _rand(1, 16, 16, c.ch_4x, seed=3), 0.6))


def test_recon_generation_matches_flax(fm):
    _sub(fm, "recon_generation_net", jfm.ReconGeneration,
         (_rand(1, 32, 32, 32, seed=1), _rand(1, 32, 32, TINY.ch_1x,
                                              seed=2)))


# --------------------------------------------------------- stage methods

def _port(fm, method, *args):
    with torch.no_grad():
        return getattr(fm[0], method)(*[_t(a) if isinstance(a, np.ndarray)
                                        else a for a in args])


def _stage(fm, method, *args):
    got = _port(fm, method, *args)
    want = _j(fm, method, *args)
    for g, w in zip(got, want):
        if g.dtype == torch.int16:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(np.abs(np.asarray(w)).max()) > 0
        else:
            _close(g, w)
    return [np.asarray(w) for w in want]


@pytest.mark.parametrize("full", [False, True])
def test_mv_analysis_matches_flax(fm, full):
    ref = _ref(fm, full)
    _stage(fm, "mv_analysis", fm[3][2], ref["ref_frame"],
           ref["ref_mv_feature"], Q_INDEX)


@pytest.mark.parametrize("full", [False, True])
def test_mv_prior_matches_flax(fm, full):
    """mv_prior0 on the JAX encoder's int16 mv_z, then the three spatial
    prior steps on a rounded y_hat so far."""
    ref = _ref(fm, full)
    mv_y, mv_z = _j(fm, "mv_analysis", fm[3][2], ref["ref_frame"],
                    ref["ref_mv_feature"], Q_INDEX)
    out = _stage(fm, "mv_prior0", np.asarray(mv_z), ref["ref_mv_y"], 4, 4)
    y_hat = np.round(np.asarray(mv_y))
    for step in (1, 2, 3):
        _stage(fm, "mv_prior_step", out[4], y_hat, step)


def test_mv_synthesis_matches_flax(fm):
    mv_y = np.round(_rand(1, 4, 4, TINY.ch_mv, scale=3.0))
    _stage(fm, "mv_synthesis", mv_y, Q_INDEX)


@pytest.mark.parametrize("full,fa_idx", [(False, 0), (True, 0), (True, 1),
                                         (True, 2)])
def test_mc_matches_flax(fm, full, fa_idx):
    ref = _ref(fm, full)
    mv_hat = np.asarray(_j(fm, "mv_synthesis", np.round(
        _rand(1, 4, 4, TINY.ch_mv, seed=5, scale=3.0)), Q_INDEX)[0])
    assert np.abs(mv_hat).max() > 0.5
    _stage(fm, "mc", ref["ref_frame"], ref["ref_feature"], fa_idx, mv_hat)


def _contexts(fm, full, fa_idx=1):
    ref = _ref(fm, full)
    mv_hat = np.asarray(_j(fm, "mv_synthesis", np.round(
        _rand(1, 4, 4, TINY.ch_mv, seed=5, scale=3.0)), Q_INDEX)[0])
    return [np.asarray(c) for c in _j(fm, "mc", ref["ref_frame"],
                                      ref["ref_feature"], fa_idx, mv_hat)]


def test_ctx_analysis_matches_flax(fm):
    c1, c2, c3 = _contexts(fm, True)
    _stage(fm, "ctx_analysis", fm[3][2], c1, c2, c3, Q_INDEX)


@pytest.mark.parametrize("full", [False, True])
def test_ctx_prior_matches_flax(fm, full):
    ref = _ref(fm, full)
    c1, c2, c3 = _contexts(fm, full)
    y, z = _j(fm, "ctx_analysis", fm[3][2], c1, c2, c3, Q_INDEX)
    out = _stage(fm, "ctx_prior0", np.asarray(z), ref["ref_y"], c3, 4, 4)
    y_hat = np.round(np.asarray(y))
    for step in (1, 2, 3):
        _stage(fm, "ctx_prior_step", out[4], y_hat, step)


def test_synthesis_matches_flax(fm):
    c1, c2, c3 = _contexts(fm, True, fa_idx=2)
    y_hat = np.round(_rand(1, 4, 4, TINY.ch_16x, seed=6, scale=3.0))
    x_hat, _ = _stage(fm, "synthesis", y_hat, c1, c2, c3, Q_INDEX)
    assert 0.0 <= x_hat.min() and x_hat.max() <= 1.0 and x_hat.std() > 0.01


def test_odd_latent_pad4_and_crop(fm):
    """A 48x80 frame padded to 64x96 by the codec: the /16 grid 4x6 is
    edge-padded to 4x8 for the hyper encoder, the hyper decoder's output
    cropped back."""
    ref, x = [np.pad(f, ((0, 0), (0, 16), (0, 16), (0, 0)), mode="edge")
              for f in fm_frames(48, 80, 2, seed=3)]
    mv_y, mv_z = _stage(fm, "mv_analysis", x, ref, None, Q_INDEX)
    assert mv_y.shape[1:3] == (4, 6) and mv_z.shape[1:3] == (1, 2)
    out = _stage(fm, "mv_prior0", mv_z, None, 4, 6)
    assert out[2].shape[1:3] == (4, 6)


# ---------------------------------------------------------------- forward

def test_eval_forward_chain_matches_flax(fm):
    """The eval forward (rates of the rounded latents) over frames 1-3 at
    fa_idx 1, 0, 2 from an empty DPB; each frame gets the JAX DPB."""
    frames = fm[3]
    tm, jp, jm = fm[0], fm[1], fm[2]
    dpb = {k: None for k in dcvc_fm.DPB_KEYS}
    dpb["ref_frame"] = frames[0]
    for i, fa in ((1, 1), (2, 0), (3, 2)):
        want, jdpb = jm.apply({"params": jp}, jnp.asarray(frames[i]),
                              {k: None if v is None else jnp.asarray(v)
                               for k, v in dpb.items()}, Q_INDEX, fa, None)
        with torch.no_grad():
            got, tdpb = tm(torch.from_numpy(frames[i]),
                           {k: _t(v) for k, v in dpb.items()}, Q_INDEX, fa)
        for k in ("x_hat", "mse", "bpp", "bits_y", "bits_z", "bits_mv_y",
                  "bits_mv_z", "mv_hat", "warp_frame"):
            _close(got[k], want[k])
        for k in dcvc_fm.DPB_KEYS:
            _close(tdpb[k], jdpb[k])
        assert float(got["bits_y"][0]) > 10 and \
            float(got["bits_mv_y"][0]) > 10
        dpb = {k: np.asarray(v) for k, v in jdpb.items()}


def test_training_forward_noise_matches_flax(fm):
    """With JAX's rate noise (split(rng, 4): y, mv_y, z, mv_z, drawn by
    add_noise) passed to the port as tensors."""
    frames, dpb = fm[3], fm[4]
    tm, jp, jm = fm[0], fm[1], fm[2]
    rng = jax.random.PRNGKey(11)
    c = TINY
    shapes = {"y": (1, 4, 4, c.ch_16x), "mv_y": (1, 4, 4, c.ch_mv),
              "z": (1, 1, 1, c.ch_z), "mv_z": (1, 1, 1, c.ch_mv_z)}
    noise = {k: _t(jax.random.uniform(r, shapes[k], jnp.float32, -0.5,
                                      0.5))
             for k, r in zip(("y", "mv_y", "z", "mv_z"),
                             jax.random.split(rng, 4))}
    want, _ = jm.apply({"params": jp}, jnp.asarray(frames[2]),
                       {k: jnp.asarray(v) for k, v in dpb.items()},
                       Q_INDEX, 2, rng)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(frames[2]),
                    {k: _t(v) for k, v in dpb.items()}, Q_INDEX, 2, noise)
    for k in ("bpp", "bits_y", "bits_z", "bits_mv_y", "bits_mv_z",
              "x_hat"):
        _close(got[k], want[k])
