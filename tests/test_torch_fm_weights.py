"""Port parity, DCVC-FM's weights: the port's DMCFM state_dict against
dcvc_tpu's flax tree at TINY_FM_CONFIG and FM_CONFIG.

- The bridge (fm_params_to_jax) gives the flax model's keys and shapes,
  checked against jax.eval_shape of DMCFM.init on both DPB branches (the
  JAX model is never initialised), and fm_params_from_jax gives the port's
  state_dict back exactly.
- key_fn_fm and its tables pinned byte for byte against dcvc_tpu's.
- A reference state_dict synthesised through key_fn_fm (the z priors'
  banks as per-layer Bitparm tensors, the fusion kernel as the grouped
  conv's weight) is read by dcvc_tpu's importer into the port's weights,
  and by DMCFM.from_reference through load_reference_into; an unknown
  key raises.
- params.v1 files both ways, byte-identical on a rewrite.
- DMCFMCodec.init_random clones feature_adaptor_1 into slots 0 and 2 and
  scales every kernel by init_scale, as dcvc_tpu's does.
The weights are tests/test_torch_dcvc_fm.py's lifted seeded init.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_fm as jfm
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu_torch.legacy import dcvc_fm
from dcvc_tpu_torch.runtime.fm_codec import DMCFMCodec
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import fm_params_from_jax, \
    fm_params_to_jax
from test_torch_dcvc_fm import JAX_TINY, TINY, _jax_dpb, jax_params, \
    lifted_model


@pytest.fixture(scope="module")
def weights():
    """(the lifted port model, its flax params)."""
    tm = lifted_model().eval()
    return tm, jax_params(tm.state_dict())


def reference_state(model):
    """The reference state_dict of a port DMCFM, synthesised through
    key_fn_fm: the z priors' banks split into per-layer Bitparm tensors
    (Q, C, 1, 1), the fusion kernel (g, I, ch/g) as the grouped conv's
    (ch, I, 1, 1) weight, every other tensor under its reference key."""
    ref = {}
    for key, t in model.state_dict().items():
        segs = key.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        k = keys.key_fn_fm(path)
        if isinstance(k, tuple) and k[0] == "stack_last":
            for i, rk in enumerate(k[1]):
                ref[rk] = t[..., i].reshape(t.shape[0], t.shape[1], 1, 1)
        elif isinstance(k, tuple):
            g, icpg, ocpg = model.align.fusion_kernel.shape
            ref[k[1]] = t if t.dim() == 1 else \
                t.transpose(1, 2).reshape(g * ocpg, icpg, 1, 1)
        else:
            ref[k] = t.clone()
    return ref



def test_configs_match_jax():
    for name in ("FM_CONFIG", "TINY_FM_CONFIG"):
        assert dataclasses.asdict(getattr(dcvc_fm, name)) == \
            dataclasses.asdict(getattr(jfm, name))


def _flax_shapes(cfg, h=64):
    """jax.eval_shape of DMCFM.init on both DPB branches (the first P
    frame: feature_adaptor_I, the adaptor_0s; a later one at fa_idx 1:
    feature_adaptor_1, the adaptor_1s), merged, with slots 0 and 2 cloned
    from feature_adaptor_1 as dcvc_tpu's DMCFMCodec.init_random does."""
    model = jfm.DMCFM(cfg=cfg)
    x = jnp.zeros((1, h, h, 3))
    dpb1 = {"ref_frame": x,
            "ref_feature": jnp.zeros((1, h, h, cfg.ch_1x)),
            "ref_mv_feature": jnp.zeros((1, h // 4, h // 4, cfg.ch_mv)),
            "ref_y": jnp.zeros((1, h // 16, h // 16, cfg.ch_16x)),
            "ref_mv_y": jnp.zeros((1, h // 16, h // 16, cfg.ch_mv))}
    shapes = {}
    for dpb, fa in ((_jax_dpb(x), 0), (dpb1, 1)):
        tree = jax.eval_shape(lambda r: model.init(
            {"params": r}, x, dpb, 0, fa, r), jax.random.PRNGKey(0))
        shapes.update({p: s.shape for p, s in
                       jax.tree_util.tree_leaves_with_path(tree["params"])})
    out = {tuple(k.key for k in p): s for p, s in shapes.items()}
    for i in (0, 2):
        for leaf in ("kernel", "bias"):
            out[(f"feature_adaptor_{i}", "conv", leaf)] = \
                out[("feature_adaptor_1", "conv", leaf)]
    return out


@pytest.mark.parametrize("name", ["TINY_FM_CONFIG", "FM_CONFIG"])
def test_bridge_matches_flax_tree(name):
    """The port's keys and shapes carried to flax are the flax model's
    (TINY: the seeded port; published widths: the port on the meta
    device)."""
    if name == "TINY_FM_CONFIG":
        port = dcvc_fm.DMCFM(TINY)
    else:
        with torch.device("meta"):
            port = dcvc_fm.DMCFM(dcvc_fm.FM_CONFIG)
    state = {k: torch.zeros(t.shape) for k, t in port.state_dict().items()}
    tree = fm_params_to_jax(state)
    got = {tuple(k.key for k in p): tuple(v.shape)
           for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == _flax_shapes(getattr(jfm, name))


def test_bridge_round_trip_exact(weights):
    tm, jp = weights
    back = fm_params_from_jax(jax.tree.map(np.asarray, jp))
    state = tm.state_dict()
    assert set(back) == set(state)
    for k, t in state.items():
        assert torch.equal(back[k], t), k
    assert tuple(jp["align"]["fusion_kernel"].shape) == (2, 8, 4)


@pytest.mark.parametrize("copy,original", [
    (keys._fm_dcb_sub, jkeys._fm_dcb_sub),
    (keys.key_fn_fm, jkeys.key_fn_fm),
])
def test_key_fn_fm_source_equal(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)


@pytest.mark.parametrize("name", ["_FM_RBU_SUB", "_FM_SUBPEL_PARENTS"])
def test_key_fn_fm_tables_equal(name):
    assert getattr(keys, name) == getattr(jkeys, name)


def test_reference_state_dict_both_importers(weights, tmp_path):
    """A reference state_dict synthesised through key_fn_fm: dcvc_tpu's
    importer fills the flax tree with the port's weights and uses every
    key; DMCFM.from_reference (through load_reference_into of a .pth.tar)
    gives the port's state_dict back."""
    from dcvc_tpu_torch.utils.checkpoint import load_reference_into
    tm, jp = weights
    ref = reference_state(tm)
    assert "align.fusion.weight" in ref and \
        "bit_estimator_z_mv.f4.h" in ref and \
        "optic_flow.me_8x.conv1.weight" in ref
    flax, unused = jkeys.import_state_dict(
        {k: v.numpy() for k, v in ref.items()},
        jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jp)),
        key_fn=jkeys.key_fn_fm)
    assert unused == []
    for (p, got), (_, want) in zip(
            jax.tree_util.tree_leaves_with_path(flax),
            jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=str(p))
    path = str(tmp_path / "fm.pth.tar")
    torch.save({"state_dict": ref}, path)
    model = load_reference_into(dcvc_fm.DMCFM(TINY), path)
    for k, t in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k
    ref["align.unknown.weight"] = torch.zeros(1)
    torch.save({"state_dict": ref}, path)
    with pytest.raises(KeyError, match="unused"):
        load_reference_into(dcvc_fm.DMCFM(TINY), path)


def test_params_v1_files_both_ways(weights, tmp_path):
    from dcvc_tpu.utils.checkpoint import load_params, save_params
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    tm, jp = weights
    path, again = str(tmp_path / "fm.bin"), str(tmp_path / "again.bin")
    save_params(path, jax.tree.map(np.asarray, jp), JAX_TINY)
    cfg = native_config(path, dcvc_fm.DMCFMConfig, None)
    assert cfg == TINY
    model = load_native_into(dcvc_fm.DMCFM(cfg), path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, tm.state_dict()[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    tree, header = load_params(again)
    assert header["config"] == dataclasses.asdict(JAX_TINY)
    jax.tree.map(np.testing.assert_array_equal, tree,
                 jax.tree.map(np.asarray, jp))


def test_init_random_clones_adaptors_and_damps():
    codec = DMCFMCodec.init_random(torch.Generator().manual_seed(2),
                                   cfg=TINY, init_scale=0.4, device="cpu")
    ref = dcvc_fm.DMCFM(TINY)
    ref.reset_parameters(torch.Generator().manual_seed(2))
    got = codec.model.state_dict()
    for k, t in ref.state_dict().items():
        src = k.replace("feature_adaptor_0.", "feature_adaptor_1.") \
            .replace("feature_adaptor_2.", "feature_adaptor_1.")
        t = ref.state_dict()[src]
        scale = 0.4 if k.endswith(".weight") or \
            k.endswith("fusion_kernel") else 1.0
        torch.testing.assert_close(got[k], t * scale, rtol=0, atol=0)
    assert float(got["align.fusion_kernel"].abs().max()) > 0
