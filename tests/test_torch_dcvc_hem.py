"""Port parity, the DCVC-HEM P-frame model: dcvc_tpu_torch's
legacy/dcvc_hem.py DMCHEM against dcvc_tpu's at TINY_HEM_CONFIG, float32
on the CPU, on the same weights and inputs (made from a numpy seed).

- The weights are the port's seeded init (DMCHEM.reset_parameters),
  lifted so that the codec's streams carry symbols and x_hat spreads
  (LIFT, perf_probe.lifted_hem: every kernel x 0.7, the last convs of
  the contextual and mv encoders x 100 and x 30, of the hyper encoders
  x 30 (z) and x 300 (mv_z: SpyNet's flows on the damped weights are
  ~0.1 px),
  the scale parts of the prior fusions' and spatial priors' last biases
  + 2, the reconstruction's last conv x 50 and its bias + 0.5), carried
  to flax by hem_params_to_jax; the JAX model is never initialised.
- Every submodule and helper (the pyramid, the fusion, the contextual
  coders, motion compensation, the dual prior) and every stage method,
  with the DPB empty and full, within atol = rtol = 2e-5; the int16 z of
  both hyper encoders exactly; the training / eval forward (bpp, x_hat,
  the DPB) with and without JAX's rate noise.
The weights (the bridge, key_fn_hem, params.v1, .pth.tar) are held by
tests/test_torch_hem_dc_weights.py, the codec by
tests/test_torch_hem_codec.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_hem as jhem
from dcvc_tpu_torch.legacy import dcvc_hem
from dcvc_tpu_torch.perf_probe import lifted_hem
from dcvc_tpu_torch.utils.jax_bridge import hem_params_to_jax
from test_torch_dcvc_fm import fm_frames

TOL = 2e-5
TINY = dcvc_hem.TINY_HEM_CONFIG
JAX_TINY = jhem.TINY_HEM_CONFIG
MV_Q, Y_Q = 1.3, 0.7           # the q scales of the stage tests
# the lift of the seeded weights (module docstring)
LIFT = {"init_scale": 0.7, "y_gain": 100.0, "mv_gain": 30.0, "z_gain": 30.0,
        "mv_z_gain": 300.0, "scale_bias": 2.0, "recon_gain": 50.0,
        "recon_bias": 0.5}


def lifted_model(seed=0, cfg=TINY):
    """The port's DMCHEM with seeded weights, lifted as LIFT says."""
    return lifted_hem(cfg, seed, LIFT)


def jax_params(state):
    """A port state_dict as the flax param tree (jax arrays)."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        hem_params_to_jax(state))


def jax_codec(state, cfg=JAX_TINY):
    """dcvc_tpu's DMCHEMCodec on the port's weights (no flax init)."""
    from dcvc_tpu.runtime.hem_codec import DMCHEMCodec as JaxCodec
    return JaxCodec(jhem.DMCHEM(cfg=cfg), jax_params(state))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _t(a):
    if a is None or isinstance(a, (int, float)):
        return a
    return torch.from_numpy(np.array(a))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _q(v):
    return np.float32(v)


def _jax_dpb(ref_frame):
    return {"ref_frame": jnp.asarray(ref_frame), "ref_feature": None,
            "ref_y": None, "ref_mv_y": None}


@pytest.fixture(scope="module")
def hem():
    """(port model, flax params, flax model, frames, full DPB): the DPB
    after the JAX eval forward of frame 1 against frame 0."""
    tm = lifted_model().eval()
    jp = jax_params(tm.state_dict())
    jm = jhem.DMCHEM(cfg=JAX_TINY)
    frames = fm_frames(64, 64, 4)
    out = jm.apply({"params": jp}, jnp.asarray(frames[1]),
                   _jax_dpb(frames[0]), MV_Q, Y_Q, None)
    return tm, jp, jm, frames, {k: np.asarray(v)
                                for k, v in out["dpb"].items()}


def _j(hem, method, *args):
    """dcvc_tpu's DMCHEM `method` (a name: a method or a submodule) on
    args."""
    _, jp, jm, _, _ = hem
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]
    return jm.apply({"params": jp}, *args,
                    method=lambda m, *a: getattr(m, method)(*a))


def _port(hem, method, *args):
    with torch.no_grad():
        return getattr(hem[0], method)(*[_t(a) if isinstance(a, np.ndarray)
                                         else a for a in args])


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    out = []
    for g, w in zip(got, want):
        if g.dtype == torch.int16:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(np.abs(np.asarray(w)).max()) > 0
        else:
            _close(g, w)
        out.append(np.asarray(w))
    return out


def _check(hem, method, *args, port_args=None):
    """The port's `method` against flax's on the same args (port_args when
    the port's signature differs)."""
    got = _port(hem, method, *(args if port_args is None else port_args))
    return _same(got, _j(hem, method, *args))


def _ref(hem, full):
    frames, dpb = hem[3], hem[4]
    return dpb if full else {"ref_frame": frames[0], "ref_feature": None,
                             "ref_y": None, "ref_mv_y": None}


def _zeros_like(ch, side=4):
    return np.zeros((1, side, side, ch), np.float32)


# ---------------------------------------------------- submodules, helpers

@pytest.mark.parametrize("name,shape", [
    ("optic_flow", None),
    ("mv_encoder", (1, 64, 64, 2)),
    ("mv_decoder", (1, 4, 4, TINY.ch_mv)),
    ("mv_hyper_prior_encoder", (1, 4, 4, TINY.ch_mv)),
    ("mv_hyper_prior_decoder", (1, 1, 1, TINY.ch_n)),
    ("mv_y_prior_fusion", (1, 4, 4, 3 * TINY.ch_mv)),
    ("mv_y_spatial_prior", (1, 4, 4, 4 * TINY.ch_mv)),
    ("contextual_hyper_prior_encoder", (1, 4, 4, TINY.ch_m)),
    ("contextual_hyper_prior_decoder", (1, 1, 1, TINY.ch_n)),
    ("temporal_prior_encoder", (1, 16, 16, TINY.ch_n)),
    ("y_prior_fusion", (1, 4, 4, 5 * TINY.ch_m)),
    ("y_spatial_prior", (1, 4, 4, 4 * TINY.ch_m)),
    ("rg_unet_1", (1, 32, 32, TINY.ch_n)),
    ("feature_extractor", (1, 32, 32, TINY.ch_n)),
])
def test_submodule_matches_flax(hem, name, shape):
    if shape is None:                  # SpyNet on two frames
        args = (hem[3][1], hem[3][0])
    else:
        args = (_rand(*shape, seed=len(name), scale=2.0),)
    _check(hem, name, *args)


def test_context_fusion_matches_flax(hem):
    n = TINY.ch_n
    _check(hem, "context_fusion", _rand(1, 32, 32, n, seed=1),
           _rand(1, 16, 16, n, seed=2), _rand(1, 8, 8, n, seed=3))


def test_contextual_coders_match_flax(hem):
    n, m = TINY.ch_n, TINY.ch_m
    c1, c2, c3 = (_rand(1, s, s, n, seed=s) for s in (64, 32, 16))
    _check(hem, "contextual_encoder", _rand(1, 64, 64, 3, seed=4), c1, c2,
           c3)
    _check(hem, "contextual_decoder", _rand(1, 4, 4, m, seed=5, scale=3.0),
           c2, c3)


@pytest.mark.parametrize("full", [False, True])
def test_motion_compensation_matches_flax(hem, full):
    ref = _ref(hem, full)
    mv = _rand(1, 64, 64, 2, seed=6, scale=3.0)
    dpb = {k: None if ref[k] is None else jnp.asarray(ref[k])
           for k in ("ref_frame", "ref_feature")}
    _check(hem, "motion_compensation", dpb, mv,
           port_args=(ref["ref_frame"], ref["ref_feature"], mv))


def test_forward_dual_prior_matches_flax(hem):
    """The training dual prior on the contextual side's spatial prior."""
    m = TINY.ch_m
    y = _rand(1, 4, 4, m, seed=7, scale=4.0)
    means, scales = _rand(1, 4, 4, m, seed=8), _rand(1, 4, 4, m, seed=9)
    q_step = np.abs(_rand(1, 4, 4, m, seed=10)) + 0.2
    _, jp, jm, _, _ = hem
    want = jm.apply({"params": jp}, *map(jnp.asarray, (y, means, scales,
                                                       q_step)),
                    method=lambda mod, *a: mod.forward_dual_prior(
                        *a, mod.y_spatial_prior))
    tm = hem[0]
    with torch.no_grad():
        got = tm.forward_dual_prior(*map(_t, (y, means, scales, q_step)),
                                    tm.y_spatial_prior)
    _same(got, want)


# --------------------------------------------------------- stage methods

@pytest.mark.parametrize("full", [False, True])
def test_mv_stages_match_flax(hem, full):
    """mv_analysis, mv_prior (ref_mv_y: zeros when the DPB has none),
    mv_spatial on a rounded y part and mv_synthesis."""
    ref = _ref(hem, full)
    x = hem[3][2]
    mv_y, mv_z = _check(hem, "mv_analysis", x, ref["ref_frame"], _q(MV_Q))
    ref_mv_y = ref["ref_mv_y"] if full else _zeros_like(TINY.ch_mv)
    q_step, scales, means = _check(hem, "mv_prior", mv_z, ref_mv_y)
    y_hat0 = np.round(mv_y)
    _check(hem, "mv_spatial", y_hat0, q_step, scales, means)
    _check(hem, "mv_synthesis", np.round(mv_y), _q(MV_Q))


@pytest.mark.parametrize("full", [False, True])
def test_ctx_stages_match_flax(hem, full):
    """mc (has_feature from the DPB), ctx_analysis, ctx_prior, ctx_spatial
    and synthesis on the JAX contexts."""
    ref = _ref(hem, full)
    x = hem[3][2]
    mv_hat = np.asarray(_j(hem, "mv_synthesis", np.round(
        _rand(1, 4, 4, TINY.ch_mv, seed=11, scale=3.0)), _q(MV_Q))[1])
    assert np.abs(mv_hat).max() > 0.1
    feat = ref["ref_feature"]
    c1, c2, c3 = _check(hem, "mc", ref["ref_frame"],
                        feat if full else ref["ref_frame"], full, mv_hat,
                        port_args=(ref["ref_frame"], feat, mv_hat))
    y, z = _check(hem, "ctx_analysis", x, c1, c2, c3, _q(Y_Q))
    ref_y = ref["ref_y"] if full else _zeros_like(TINY.ch_m)
    q_step, scales, means = _check(hem, "ctx_prior", z, c3, ref_y)
    _check(hem, "ctx_spatial", np.round(y), q_step, scales, means)
    _, x_hat, _ = _check(hem, "synthesis", np.round(y), c1, c2, c3,
                         _q(Y_Q))
    assert 0.0 <= x_hat.min() and x_hat.max() <= 1.0 and x_hat.std() > 0.01


# ---------------------------------------------------------------- forward

RESULT_KEYS = ("bpp", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z", "mse",
               "me_mse")


def test_eval_forward_chain_matches_flax(hem):
    """The eval forward (rates of the rounded latents) over frames 1-3
    from an empty DPB, each frame on the JAX DPB, at two q scale pairs."""
    frames = hem[3]
    tm, jp, jm = hem[0], hem[1], hem[2]
    dpb = {k: None for k in dcvc_hem.DPB_KEYS}
    dpb["ref_frame"] = frames[0]
    for i, (mq, yq) in ((1, (MV_Q, Y_Q)), (2, (0.5, 3.0)), (3, (2.0, 0.3))):
        want = jm.apply({"params": jp}, jnp.asarray(frames[i]),
                        {k: None if v is None else jnp.asarray(v)
                         for k, v in dpb.items()}, mq, yq, None)
        with torch.no_grad():
            got, tdpb = tm(torch.from_numpy(frames[i]),
                           {k: _t(v) for k, v in dpb.items()},
                           torch.tensor(mq), torch.tensor(yq))
        for k in RESULT_KEYS:
            _close(got[k], want[k])
        _close(got["x_hat"], want["dpb"]["ref_frame"])
        for k in dcvc_hem.DPB_KEYS:
            _close(tdpb[k], want["dpb"][k])
        assert float(got["bpp_y"][0]) > 0.01 and \
            float(got["bpp_mv_y"][0]) > 0.01
        dpb = {k: np.asarray(v) for k, v in want["dpb"].items()}


def test_training_forward_noise_matches_flax(hem):
    """With JAX's rate noise (split(rng, 4): y, mv_y, z, mv_z, drawn by
    add_noise) passed to the port as tensors; the first anchors as the
    q scales."""
    frames, dpb = hem[3], hem[4]
    tm, jp, jm = hem[0], hem[1], hem[2]
    rng = jax.random.PRNGKey(11)
    c = TINY
    shapes = {"y": (1, 4, 4, c.ch_m), "mv_y": (1, 4, 4, c.ch_mv),
              "z": (1, 1, 1, c.ch_n), "mv_z": (1, 1, 1, c.ch_n)}
    noise = {k: _t(jax.random.uniform(r, shapes[k], jnp.float32, -0.5,
                                      0.5))
             for k, r in zip(("y", "mv_y", "z", "mv_z"),
                             jax.random.split(rng, 4))}
    want = jm.apply({"params": jp}, jnp.asarray(frames[2]),
                    {k: jnp.asarray(v) for k, v in dpb.items()}, rng=rng)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(frames[2]),
                    {k: _t(v) for k, v in dpb.items()}, noise=noise)
    for k in RESULT_KEYS:
        _close(got[k], want[k])
