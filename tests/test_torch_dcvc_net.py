"""Port parity, the DCVC-2021 P-frame model: dcvc_tpu_torch's
legacy/dcvc_net.py DCVCNet against dcvc_tpu's at TINY_DCVC_CONFIG,
float32 on the CPU, on the same weights and inputs (made from a numpy
seed).

- The weights are the port's seeded init (DCVCNet.reset_parameters)
  lifted so that every latent is coded (perf_probe.lifted_dcvc), carried
  to flax by dcvc_params_to_jax; the JAX model is never initialised.
- Every stage method (mv_analysis, mv_prior, mv_synthesis, ctx_analysis,
  ctx_prior, synthesis), motion compensation, both masked convs, the 1x1
  entropy-parameter chains and the eval forward (the four bpp terms,
  recon_image, context) within atol = rtol = 2e-5; the int16 z of both
  hyper encoders exactly.  laplace_bits_sum matches on a seeded grid.
- Weights: the key map's copy pinned; the bridge's tree has the shapes of
  jax.eval_shape of the flax init at TINY and at DCVC_CONFIG and comes
  back unchanged; params.v1 files both ways (the model's stages equal);
  a reference .pth.tar synthesised through key_fn_dcvc (ConvTranspose2d
  weights in torch's layout, the z priors as per-layer Bitparm tensors,
  the masked convs' `.mask` buffers) loads through from_reference.
- The stage launch derivation (perf_probe.dcvc_stage_launches) gives no
  K1 launch.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dcvc_tpu.legacy import dcvc_net as jnet
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.legacy import dcvc_net
from dcvc_tpu_torch.perf_probe import dcvc_stage_launches, lifted_dcvc
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import dcvc_params_from_jax, \
    dcvc_params_to_jax, load_into, load_native_into, save_native

TOL = 2e-5
TINY = dcvc_net.TINY_DCVC_CONFIG
JAX_TINY = jnet.TINY_DCVC_CONFIG


def frames(h, w, seed):
    """(ref, cur): a smooth seeded picture and itself shifted by 2 px
    with noise, (1, h, w, 3) in [0, 1]."""
    rng = np.random.default_rng(seed)
    ref = gaussian_filter(rng.uniform(0, 1, (1, h, w, 3)), (0, 2, 2, 0))
    ref = np.clip((ref - 0.5) * 3 + 0.5, 0, 1)
    cur = np.clip(np.roll(ref, 2, 2) + rng.normal(0, 0.02, ref.shape), 0, 1)
    return ref.astype(np.float32), cur.astype(np.float32)


def lifted_model(seed=0, cfg=TINY):
    return lifted_dcvc(cfg, seed)


def jax_params(state):
    """A port state_dict as the flax param tree (jax arrays)."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        dcvc_params_to_jax(state))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def pair():
    """(the port's lifted model, a function applying the flax model's
    method to numpy arguments)."""
    m = lifted_model()
    params = jax_params(m.state_dict())
    jm = jnet.DCVCNet(cfg=JAX_TINY)

    def apply(method, *args):
        return jm.apply({"params": params}, *args, method=method)
    return m, apply


def _t(a):
    return torch.from_numpy(np.array(a))


def test_stages_match_jax(pair):
    m, apply = pair
    ref, cur = frames(64, 128, 1)
    with torch.no_grad():
        mv_y, mv_z = m.mv_analysis(_t(cur), _t(ref))
        jmv_y, jmv_z = apply(jnet.DCVCNet.mv_analysis, cur, ref)
        _close(mv_y, jmv_y)
        assert mv_z.dtype == torch.int16
        np.testing.assert_array_equal(mv_z.numpy(), np.asarray(jmv_z))
        assert mv_z.abs().max() > 0
        _close(m.mv_prior(mv_z), apply(jnet.DCVCNet.mv_prior, jmv_z))
        mv_y_hat = torch.round(mv_y)
        context, temporal = m.mv_synthesis(mv_y_hat, _t(ref))
        jctx, jtemp = apply(jnet.DCVCNet.mv_synthesis, mv_y_hat.numpy(),
                            ref)
        _close(context, jctx)
        _close(temporal, jtemp)
        y, z = m.ctx_analysis(_t(cur), context)
        jy, jz = apply(jnet.DCVCNet.ctx_analysis, cur, context.numpy())
        _close(y, jy)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
        assert z.abs().max() > 0 and torch.round(y).abs().max() > 0
        _close(m.ctx_prior(z), apply(jnet.DCVCNet.ctx_prior, jz))
        y_hat = torch.round(y)
        _close(m.synthesis(y_hat, context),
               apply(jnet.DCVCNet.synthesis, y_hat.numpy(),
                     context.numpy()))


def test_submodules_match_jax(pair):
    """Motion compensation, the masked convs and the entropy-parameter
    chains on seeded inputs."""
    m, apply = pair
    rng = np.random.default_rng(4)
    ref = frames(32, 48, 2)[0]
    mv = rng.normal(0, 2, (1, 32, 48, 2)).astype(np.float32)
    with torch.no_grad():
        _close(m.motion_compensation(_t(ref), _t(mv)),
               apply(jnet.DCVCNet.motion_compensation, ref, mv))
        for name, ch in (("auto_regressive", TINY.ch_m),
                         ("auto_regressive_mv", TINY.ch_mv)):
            y = np.round(rng.normal(0, 3, (1, 5, 7, ch))).astype(np.float32)
            _close(getattr(m, name)(_t(y)),
                   apply(lambda mod, v: getattr(mod, name)(v), y))
        for name, ch in (("entropy_parameters", TINY.ch_m),
                         ("entropy_parameters_mv", TINY.ch_mv)):
            v = rng.normal(0, 1, (1, 3, 4, ch * 4)).astype(np.float32)
            _close(getattr(m, name)(_t(v)),
                   apply(lambda mod, a: getattr(mod, name)(a), v))


def test_masked_conv_is_type_a():
    """A change at one position moves the masked conv's output only at
    later raster positions."""
    conv = dcvc_net.MaskedConv2d(4, 6)
    dcvc_net.init_legacy_(conv, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    y = _t(rng.normal(0, 1, (1, 6, 6, 4)).astype(np.float32))
    y2 = y.clone()
    y2[0, 2, 3] += 3.0
    with torch.no_grad():
        d = (conv(y2) - conv(y)).abs().amax(-1)[0]
    changed = {tuple(p) for p in torch.nonzero(d > 0).tolist()}
    assert changed and all((r, c) > (2, 3) for r, c in changed)


def test_forward_matches_jax(pair):
    m, apply = pair
    ref, cur = frames(64, 128, 3)
    with torch.no_grad():
        got = m(_t(ref), _t(cur))
    want = apply(jnet.DCVCNet.__call__, ref, cur)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])
    for k in ("bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z"):
        assert float(got[k][0]) > 1e-3, k


def test_laplace_bits_sum_matches_jax():
    rng = np.random.default_rng(7)
    v = np.round(rng.normal(0, 4, (2, 3, 5, 6))).astype(np.float32)
    sigma = np.exp(rng.uniform(-14, 4, v.shape)).astype(np.float32)
    _close(dcvc_net.laplace_bits_sum(_t(v), _t(sigma)),
           jnet.laplace_bits_sum(v, sigma))


def test_stage_launches_are_zero():
    launches = dcvc_stage_launches(dcvc_net.DCVC_CONFIG, 1080, 1920)
    assert set(launches) == {"mv_analysis", "mv_prior", "mv_synthesis",
                             "ctx_analysis", "ctx_prior", "synthesis",
                             "forward"}
    assert all(sum(c.values()) == 0 for c in launches.values())


# ------------------------------------------------------------ the weights

@pytest.mark.parametrize("name", ["key_fn_dcvc", "_DCVC_TOP",
                                  "_DCVC_DECONV"])
def test_key_map_copies_pinned(name):
    got, want = getattr(keys, name), getattr(jkeys, name)
    if callable(want):
        assert inspect.getsource(got) == inspect.getsource(want)
    else:
        assert got == want


@pytest.mark.parametrize("full", [False, True])
def test_bridge_tree_matches_flax_init(full):
    cfg, jcfg = ((dcvc_net.DCVC_CONFIG, jnet.DCVC_CONFIG) if full
                 else (TINY, JAX_TINY))
    m = dcvc_net.DCVCNet(cfg)
    tree = dcvc_params_to_jax(m.state_dict())
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jnet.DCVCNet(cfg=jcfg).init(
        jax.random.PRNGKey(0), x, x))["params"]
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        jax.tree.map(lambda s: tuple(s.shape), shapes)
    back = dcvc_params_from_jax(tree)
    assert back.keys() == m.state_dict().keys()
    for k, t in m.state_dict().items():
        assert torch.equal(back[k], t), k


def _stages(m, ref, cur):
    with torch.no_grad():
        mv_y, mv_z = m.mv_analysis(_t(cur), _t(ref))
        context, temporal = m.mv_synthesis(torch.round(mv_y), _t(ref))
        return mv_y, mv_z, m.mv_prior(mv_z), context, temporal


def test_params_v1_both_ways(pair, tmp_path):
    m, apply = pair
    ref, cur = frames(64, 64, 5)
    save_native(m, str(tmp_path / "port.bin"))
    tree, hdr = load_params(str(tmp_path / "port.bin"))
    assert hdr["config"] == vars(TINY)
    jm = jnet.DCVCNet(cfg=JAX_TINY)
    want = apply(jnet.DCVCNet.mv_analysis, cur, ref)[0]
    got = jm.apply({"params": tree}, cur, ref,
                   method=jnet.DCVCNet.mv_analysis)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    save_params(str(tmp_path / "jax.bin"),
                jax.tree.map(np.asarray, jax_params(m.state_dict())),
                JAX_TINY)
    loaded = load_native_into(dcvc_net.DCVCNet(TINY),
                              str(tmp_path / "jax.bin"))
    for g, w in zip(_stages(loaded, ref, cur), _stages(m, ref, cur)):
        assert torch.equal(g, w)


def reference_state(m):
    """The reference DCVC state_dict of the port model m: every parameter
    under key_fn_dcvc's name (conv and ConvTranspose2d weights as they
    are), the z priors' banks as per-layer Bitparm tensors (1, C, 1, 1),
    and the masked convs' mask buffers."""
    state = {}
    for k, t in m.state_dict().items():
        segs = k.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        ref = keys.key_fn_dcvc(path)
        if isinstance(ref, tuple) and ref[0] == "stack_last":
            for i, name in enumerate(ref[1]):
                state[name] = t[..., i].reshape(1, -1, 1, 1).clone()
            continue
        state[ref[1] if isinstance(ref, tuple) else ref] = t.clone()
    for name in ("auto_regressive", "auto_regressive_mv"):
        w = state[f"{name}.weight"]
        state[f"{name}.mask"] = torch.ones_like(w)
    return state


def test_reference_checkpoint_loads(pair, tmp_path):
    m, apply = pair
    path = str(tmp_path / "model_dcvc.pth.tar")
    state = reference_state(m)
    assert "mvDecoder_part1.0.weight" in state
    assert "bitEstimator_z.f1.h" in state
    torch.save({"state_dict": state}, path)
    loaded = load_into(dcvc_net.DCVCNet(TINY), path)
    for k, t in m.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    # the JAX importer reads the same file into the same flax tree
    tree = jax.tree.map(np.asarray, jax_params(m.state_dict()))
    imported, unused = jkeys.import_state_dict(
        {k: v.numpy() for k, v in state.items()}, tree,
        key_fn=jkeys.key_fn_dcvc)
    assert sorted(unused) == ["auto_regressive.mask",
                              "auto_regressive_mv.mask"]
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(imported),
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
