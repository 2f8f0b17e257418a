"""Port parity at full depth: every other parity test of the port runs a
depth-1 TINY config, so a key-map or block-order fault that shows only at
depth > 1 (DMCI's strided entry of enc_2, `_ENC_DOWN`; HTL's encoder 7,
decoder 11, FA_M 10) would pass them.

- Keys and shapes at the published configs (`DMCIConfig()`, `HTS_CONFIG`,
  `HTL_CONFIG`, `LD_CONFIG`): the flax params' shapes from `jax.eval_shape` (no
  compute), mapped through the bridge, equal the port's state_dict (built
  on the meta device, no memory) key for key and shape for shape.
- Stage parity at the TINY widths with the published depths, float32 on
  the CPU, the checks and tolerances of tests/test_torch_dmci.py::
  test_stages_match_flax and tests/test_torch_dmc_ht.py /
  test_torch_dmc_htl.py::test_{temporal,coding}_stages_match_flax: z_int8
  exact, floats within 1e-5 of each tensor's peak, frames within an
  absolute 1e-4.  The video models' kernels are damped by 0.5 (the
  codecs' init_scale, as bench.py): at 1.0 the deeper random trunks grow
  their activations by orders of magnitude per stage.  The flax models
  are initialised eagerly: compiling their init at these depths takes
  minutes on the CPU, running it op by op seconds.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models import dmc_ht as jax_dmc_ht
from dcvc_tpu.models import dmc_ld as jax_dmc_ld
from dcvc_tpu.models import dmci as jax_dmci
from dcvc_tpu_torch.models import dmc_ht, dmc_ld, dmci
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax, \
    dmc_ld_params_from_jax, dmci_params_from_jax

REL = 1e-5
X_HAT_ATOL = 1e-4
QP = 3
DEPTHS = {
    "dmci": ("enc_depth", "dec_depth"),
    "hts": ("enc_depth", "dec_depth", "fa_i_depth", "fa_m_depth", "fx_depth",
            "recon_shared_depth", "recon_depth"),
}
DEPTHS["htl"] = DEPTHS["hts"]


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL * scale


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _published(name):
    """(jax config, port config) of a published model."""
    return {"dmci": (jax_dmci.DMCIConfig(), dmci.DMCIConfig()),
            "hts": (jax_dmc_ht.HTS_CONFIG, dmc_ht.HTS_CONFIG),
            "htl": (jax_dmc_ht.HTL_CONFIG, dmc_ht.HTL_CONFIG),
            "ld": (jax_dmc_ld.LD_CONFIG, dmc_ld.LD_CONFIG)}[name]


def _tiny_full_depth(name):
    """(jax config, port config): the TINY widths at the published
    depths."""
    tiny = {"dmci": (jax_dmci.TINY_CONFIG, dmci.TINY_CONFIG),
            "hts": (jax_dmc_ht.TINY_HT_CONFIG, dmc_ht.TINY_HT_CONFIG),
            "htl": (jax_dmc_ht.TINY_HTL_CONFIG, dmc_ht.TINY_HTL_CONFIG)}[name]
    full = _published(name)
    depths = {k: getattr(full[0], k) for k in DEPTHS[name]}
    assert depths == {k: getattr(full[1], k) for k in DEPTHS[name]}
    return tuple(dataclasses.replace(c, **depths) for c in tiny)


def _flax_shapes(name, cfg):
    """The flax params of the model at `cfg` as ShapeDtypeStructs (both
    adaptor branches merged for DMC-HT and DMC-LD, as the JAX codec holds
    them)."""
    keys = (jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    if name == "dmci":
        model = jax_dmci.DMCI(cfg=cfg, dtype=jnp.float32)
        x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
        return jax.eval_shape(lambda a, b, x_: model.init(
            {"params": a}, x_, 0, b), *keys, x)["params"]
    if name == "ld":
        model = jax_dmc_ld.DMCLD(cfg=cfg, dtype=jnp.float32)
        ch_src = cfg.ch_src
    else:
        model = jax_dmc_ht.DMCHT(cfg=cfg, dtype=jnp.float32)
        ch_src = cfg.ch_src_intra

    def spec(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)
    x = spec(1, 64, 64, 3 * cfg.frame_delay)
    ref_i = spec(1, 8, 8, ch_src)
    ref_f, mem = spec(1, 8, 8, cfg.ch_d), spec(1, 8, 8, cfg.ch_m)
    p_i = jax.eval_shape(lambda a, b, *t: model.init(
        {"params": a}, t[0], t[1], None, 0, b), *keys, x, ref_i)["params"]
    p_m = jax.eval_shape(lambda a, b, *t: model.init(
        {"params": a}, *t, 0, b), *keys, x, ref_f, mem)["params"]
    return {**p_m, **p_i}


def _stand_in(tree):
    """ShapeDtypeStruct leaves -> float32 zero views of their shape (a
    broadcast of one zero, which the bridge copies)."""
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@pytest.mark.parametrize("name", ["dmci", "hts", "htl", "ld"])
def test_published_keys_and_shapes_match_bridge(name):
    jcfg, tcfg = _published(name)
    params = _stand_in(_flax_shapes(name, jcfg))
    if name == "dmci":
        state = dmci_params_from_jax(params)
        with torch.device("meta"):
            port = dmci.DMCI(tcfg)
    elif name == "ld":
        state = dmc_ld_params_from_jax(params)
        with torch.device("meta"):
            port = dmc_ld.DMCLD(tcfg)
    else:
        state = dmc_ht_params_from_jax(params, hts=name == "hts")
        with torch.device("meta"):
            port = dmc_ht.DMCHT(tcfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert sorted(set(want) - set(got)) == [], "keys the bridge misses"
    assert sorted(set(got) - set(want)) == [], "keys the port lacks"
    assert {k: v for k, v in got.items() if v != want[k]} == {}


@pytest.fixture(scope="module")
def dmci_models():
    jcfg, tcfg = _tiny_full_depth("dmci")
    jmodel = jax_dmci.DMCI(cfg=jcfg, dtype=jnp.float32)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, x0, 0,
                         jax.random.PRNGKey(1))["params"]
    tmodel = dmci.DMCI(tcfg)
    tmodel.load_state_dict(dmci_params_from_jax(params))
    return jmodel, {"params": params}, tmodel.eval()


@pytest.mark.parametrize("h,w", [(64, 64), (80, 112)])
def test_dmci_stages_match_flax_at_full_depth(dmci_models, h, w):
    jmodel, v, tmodel = dmci_models
    J = jax_dmci.DMCI
    x = np.random.default_rng(h).uniform(-0.5, 0.5, (1, h, w, 3)).astype(
        np.float32)
    y_j, z_j = jmodel.apply(v, jnp.asarray(x), QP, method=J.analysis)
    with torch.inference_mode():
        y_t, z_t = tmodel.analysis(torch.from_numpy(x), QP)
    _close(y_t, y_j)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))

    yh, yw = y_j.shape[1], y_j.shape[2]
    s_j, m_j, ctx_j = jmodel.apply(v, z_j, yh, yw, method=J.prior0)
    ctx = torch.from_numpy(np.array(ctx_j))
    y_hat = np.round(np.asarray(y_j)).astype(np.float32)
    with torch.inference_mode():
        s_t, m_t, ctx_t = tmodel.prior0(torch.from_numpy(np.array(z_j)),
                                        yh, yw)
        steps = [tmodel.prior_step(ctx, torch.from_numpy(y_hat), k)
                 for k in (1, 2, 3)]
        x_t = tmodel.synthesis(torch.from_numpy(y_hat), QP, h, w)
    for got, want in ((s_t, s_j), (m_t, m_j), (ctx_t, ctx_j)):
        _close(got, want)
    for k, got in zip((1, 2, 3), steps):
        want = jmodel.apply(v, ctx_j, jnp.asarray(y_hat), k,
                            method=J.prior_step)
        for g, w_ in zip(got, want):
            _close(g, w_)
    x_j = jmodel.apply(v, jnp.asarray(y_hat), QP, h, w, method=J.synthesis)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=X_HAT_ATOL)


@pytest.fixture(scope="module", params=["hts", "htl"])
def video_models(request):
    name = request.param
    jcfg, tcfg = _tiny_full_depth(name)
    jmodel = jax_dmc_ht.DMCHT(cfg=jcfg, dtype=jnp.float32)
    # dcvc_tpu.runtime.video_codec._init_both_branches without its jit: both
    # adaptor branches initialised and merged, the kernels damped
    r1, r2, _, r4 = jax.random.split(jax.random.PRNGKey(0), 4)
    x = jnp.zeros((1, 64, 64, 3 * jcfg.frame_delay), jnp.float32)
    ref_i = jnp.zeros((1, 8, 8, jcfg.ch_src_intra), jnp.float32)
    ref_f = jnp.zeros((1, 8, 8, jcfg.ch_d), jnp.float32)
    mem = jnp.zeros((1, 8, 8, jcfg.ch_m), jnp.float32)
    p_i = jmodel.init({"params": r1}, x, ref_i, None, 0, r2)["params"]
    p_m = jmodel.init({"params": r1}, x, ref_f, mem, 0, r4)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(leaf) * (
            0.5 if path[-1].key == "kernel" else 1.0), {**p_m, **p_i})
    tmodel = dmc_ht.DMCHT(tcfg)
    tmodel.load_state_dict(dmc_ht_params_from_jax(params, hts=name == "hts"))
    return jmodel, {"params": params}, tmodel.eval()


def _j(jmodel, v, method, *args):
    return jmodel.apply(v, *args, method=getattr(jax_dmc_ht.DMCHT, method))


def test_video_temporal_stages_match_flax_at_full_depth(video_models):
    jmodel, v, tmodel = video_models
    c = tmodel.cfg
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
def test_video_coding_stages_match_flax_at_full_depth(video_models, h, w):
    jmodel, v, tmodel = video_models
    c = tmodel.cfg
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
        if c.is_hts:                      # means only
            got, want = (got,), (want,)
        assert len(got) == len(want)
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
