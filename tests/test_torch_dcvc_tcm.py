"""Port parity, the DCVC-TCM P-frame model: dcvc_tpu_torch's
legacy/dcvc_tcm.py DMCTCM against dcvc_tpu's at TINY_TCM_CONFIG, float32
on the CPU, on the same weights and inputs (made from a numpy seed).

- The weights are the port's seeded init (DMCTCM.reset_parameters)
  lifted so that every latent is coded and the flow moves about a pixel
  (perf_probe.lifted_tcm with TINY_LIFT), carried to flax by
  tcm_params_to_jax; the JAX model is never initialised.
- Every stage method (mv_analysis, mv_prior, mv_synthesis, mc,
  ctx_analysis, ctx_prior, synthesis) on both mc branches (the first P
  frame after an intra frame, whose pyramid comes from the frame through
  feature_adaptor_I, and a later one, from the DPB's feature through
  feature_adaptor_P), and the training forward (the four bpp terms, bpp,
  mse, me_mse, recon_image, feature) on both branches, within atol =
  rtol = 2e-5 (tests/test_fused_dcb.py:57); the int16 z of both hyper
  encoders exactly.
- Weights: the key map's copy pinned; the bridge's tree has the shapes of
  jax.eval_shape of the flax init with both adaptor branches merged, at
  TINY and at TCM_CONFIG, and comes back unchanged; every flax leaf maps
  through the port's key_fn_tcm to a distinct reference key; params.v1
  files both ways; a reference .pth.tar synthesised through key_fn_tcm
  (ConvTranspose2d weights in torch's layout, the z priors as per-layer
  Bitparm tensors) loads through from_reference, and the JAX importer
  reads it into the same flax tree.
- The stage launch derivation (perf_probe.tcm_stage_launches) gives no
  K1 launch.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_tcm as jtcm
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.legacy import dcvc_tcm
from dcvc_tpu_torch.perf_probe import TCM_LIFT, lifted_tcm, \
    tcm_stage_launches
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import load_into, load_native_into, \
    save_native, tcm_params_from_jax, tcm_params_to_jax
from test_torch_dcvc_net import frames

TOL = 2e-5
TINY = dcvc_tcm.TINY_TCM_CONFIG
JAX_TINY = jtcm.TINY_TCM_CONFIG
# TCM_LIFT's gains are TCM_CONFIG's; at TINY the mv encoder and decoder
# need more (mv_y ~2, |mv_hat| ~0.9 on average at 64x64)
TINY_LIFT = {**TCM_LIFT, "mv_gain": 2.4e5, "mv_hat_gain": 500.0,
             "y_gain": 600.0}


def lifted_model(seed=0, cfg=TINY):
    return lifted_tcm(cfg, seed, TINY_LIFT)


def jax_params(state):
    """A port state_dict as the flax param tree (jax arrays)."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        tcm_params_to_jax(state))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def feature_of(h, w, seed):
    """A seeded stand-in for the DPB's feature, (1, h, w, ch_n)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.5, (1, h, w, TINY.ch_n)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(the port's lifted model, a function applying the flax model's
    method to numpy arguments)."""
    m = lifted_model()
    params = jax_params(m.state_dict())
    jm = jtcm.DMCTCM(cfg=JAX_TINY)

    def apply(method, *args):
        return jm.apply({"params": params}, *args, method=method)
    return m, apply


@pytest.mark.parametrize("has_feature", [False, True])
def test_stages_match_jax(pair, has_feature):
    m, apply = pair
    h, w = 64, 128
    ref, cur = frames(h, w, 1)
    feat = feature_of(h, w, 2) if has_feature else None
    D = jtcm.DMCTCM
    with torch.no_grad():
        mv_y, mv_z = m.mv_analysis(_t(cur), _t(ref))
        jmv_y, jmv_z = apply(D.mv_analysis, cur, ref)
        _close(mv_y, jmv_y)
        assert mv_z.dtype == torch.int16
        np.testing.assert_array_equal(mv_z.numpy(), np.asarray(jmv_z))
        assert mv_z.abs().max() > 0 and torch.round(mv_y).abs().max() > 0
        for g, wt in zip(m.mv_prior(mv_z), apply(D.mv_prior, jmv_z)):
            _close(g, wt)
        mv_y_hat = torch.round(mv_y)
        mv_hat = m.mv_synthesis(mv_y_hat)
        _close(mv_hat, apply(D.mv_synthesis, mv_y_hat.numpy()))
        assert mv_hat.abs().mean() > 0.2
        ctx = m.mc(_t(ref), None if feat is None else _t(feat), mv_hat)
        jctx = apply(D.mc, ref, ref if feat is None else feat, has_feature,
                     mv_hat.numpy())
        for g, wt in zip(ctx, jctx):
            _close(g, wt)
        ctx_np = [c.numpy() for c in ctx]
        y, z = m.ctx_analysis(_t(cur), *ctx)
        jy, jz = apply(D.ctx_analysis, cur, *ctx_np)
        _close(y, jy)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
        assert z.abs().max() > 0 and torch.round(y).abs().max() > 0
        for g, wt in zip(m.ctx_prior(z, *ctx),
                         apply(D.ctx_prior, jz, *ctx_np)):
            _close(g, wt)
        y_hat = torch.round(y)
        x_hat, feature = m.synthesis(y_hat, *ctx)
        jx_hat, jfeature = apply(D.synthesis, y_hat.numpy(), *ctx_np)
        _close(x_hat, jx_hat)
        _close(feature, jfeature)
        assert 0.05 < float(x_hat.std()) and x_hat.shape == (1, h, w, 3)


@pytest.mark.parametrize("has_feature", [False, True])
def test_forward_matches_jax(pair, has_feature):
    m, apply = pair
    h, w = 64, 128
    ref, cur = frames(h, w, 3)
    feat = feature_of(h, w, 4) if has_feature else None
    with torch.no_grad():
        got = m(_t(cur), _t(ref), None if feat is None else _t(feat))
    want = apply(jtcm.DMCTCM.__call__, cur, ref, feat)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])
    for k in ("bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z"):
        assert float(got[k][0]) > 1e-3, k


def test_stage_launches_are_zero():
    launches = tcm_stage_launches(dcvc_tcm.TCM_CONFIG, 1080, 1920)
    stages = ("mv_analysis", "mv_prior", "mv_synthesis", "mc",
              "ctx_analysis", "ctx_prior", "synthesis", "forward")
    assert set(launches) == {f"{which} {s}" for which in ("first", "later")
                             for s in stages}
    assert all(sum(c.values()) == 0 for c in launches.values())


# ------------------------------------------------------------ the weights

@pytest.mark.parametrize("name", ["key_fn_tcm", "_tcm_top", "_TCM_DECONV"])
def test_key_map_copies_pinned(name):
    got, want = getattr(keys, name), getattr(jkeys, name)
    if callable(want):
        assert inspect.getsource(got) == inspect.getsource(want)
    else:
        assert got == want


def flax_shapes(jcfg):
    """jax.eval_shape of the flax DMCTCM's params with both adaptor
    branches merged, as the JAX codec's init_random merges two inits."""
    x = jnp.zeros((1, 64, 64, 3))
    feat = jnp.zeros((1, 64, 64, jcfg.ch_n))
    jm = jtcm.DMCTCM(cfg=jcfg)
    first = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x,
                                           None))["params"]
    later = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x,
                                           feat))["params"]
    assert set(first) ^ set(later) == {"feature_adaptor_I",
                                       "feature_adaptor_P"}
    return {**first, **later}


@pytest.mark.parametrize("full", [False, True])
def test_bridge_tree_matches_flax_init(full):
    cfg, jcfg = ((dcvc_tcm.TCM_CONFIG, jtcm.TCM_CONFIG) if full
                 else (TINY, JAX_TINY))
    m = dcvc_tcm.DMCTCM(cfg)
    tree = tcm_params_to_jax(m.state_dict())
    shapes = flax_shapes(jcfg)
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    back = tcm_params_from_jax(tree)
    assert back.keys() == m.state_dict().keys()
    for k, t in m.state_dict().items():
        assert torch.equal(back[k], t), k
    # every flax leaf has its own reference key, whose tensor (synthesised
    # from the port's) has the shape the JAX importer expects
    ref = reference_state(m)
    names = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        segs = tuple(p.key for p in path)
        key = keys.key_fn_tcm(segs)
        if isinstance(key, tuple) and key[0] == "stack_last":
            names += key[1]
            assert all(ref[k].shape == (1, leaf.shape[1], 1, 1)
                       for k in key[1])
            continue
        deconv = isinstance(key, tuple)
        name = key[1] if deconv else key
        names.append(name)
        t = ref[name].numpy()
        if t.ndim == 4:
            t = t.transpose(2, 3, 0, 1) if deconv else t.transpose(2, 3, 1, 0)
        assert t.shape == leaf.shape, (segs, name)
    assert len(names) == len(set(names)) == len(ref)


def _stages(m, ref, cur):
    with torch.no_grad():
        mv_y, mv_z = m.mv_analysis(_t(cur), _t(ref))
        mv_hat = m.mv_synthesis(torch.round(mv_y))
        return (mv_y, mv_z, *m.mv_prior(mv_z), mv_hat,
                *m.mc(_t(ref), None, mv_hat))


def test_params_v1_both_ways(pair, tmp_path):
    m, apply = pair
    ref, cur = frames(64, 64, 5)
    save_native(m, str(tmp_path / "port.bin"))
    tree, hdr = load_params(str(tmp_path / "port.bin"))
    assert hdr["config"] == vars(TINY)
    jm = jtcm.DMCTCM(cfg=JAX_TINY)
    want = apply(jtcm.DMCTCM.mv_analysis, cur, ref)[0]
    got = jm.apply({"params": tree}, cur, ref,
                   method=jtcm.DMCTCM.mv_analysis)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    save_params(str(tmp_path / "jax.bin"),
                jax.tree.map(np.asarray, jax_params(m.state_dict())),
                JAX_TINY)
    loaded = load_native_into(dcvc_tcm.DMCTCM(TINY),
                              str(tmp_path / "jax.bin"))
    for g, w in zip(_stages(loaded, ref, cur), _stages(m, ref, cur)):
        assert torch.equal(g, w)


def reference_state(m):
    """The reference DCVC-TCM state_dict of the port model m: every
    parameter under key_fn_tcm's name (conv and ConvTranspose2d weights as
    they are), the z priors' banks as per-layer Bitparm tensors (1, C, 1,
    1)."""
    state = {}
    for k, t in m.state_dict().items():
        segs = k.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        ref = keys.key_fn_tcm(path)
        if isinstance(ref, tuple) and ref[0] == "stack_last":
            for i, name in enumerate(ref[1]):
                state[name] = t[..., i].reshape(1, -1, 1, 1).clone()
            continue
        state[ref[1] if isinstance(ref, tuple) else ref] = t.clone()
    return state


def test_reference_checkpoint_loads(pair, tmp_path):
    m, apply = pair
    path = str(tmp_path / "tcm.pth.tar")
    state = reference_state(m)
    assert "mv_decoder.8.weight" in state
    assert "context_fusion_net.conv3_up.0.weight" in state
    assert "bit_estimator_z.f1.h" in state
    torch.save({"state_dict": state}, path)
    loaded = load_into(dcvc_tcm.DMCTCM(TINY), path)
    for k, t in m.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    # the JAX importer reads the same file into the same flax tree
    tree = jax.tree.map(np.asarray, jax_params(m.state_dict()))
    imported, unused = jkeys.import_state_dict(
        {k: v.numpy() for k, v in state.items()}, tree,
        key_fn=jkeys.key_fn_tcm)
    assert unused == []
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(imported),
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
