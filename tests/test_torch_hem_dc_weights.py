"""Port parity, the weights of DCVC-HEM and DCVC-DC: the port's DMCHEM
and DMCDC state_dicts against dcvc_tpu's flax trees at TINY and at the
published configs.

- The bridge (hem_params_to_jax, dc_params_to_jax) gives the flax
  model's keys and shapes, checked against jax.eval_shape of the model's
  init on both DPB branches (the JAX models are never initialised; DC's
  adaptor slots 0 and 2 cloned from slot 1 as dcvc_tpu's
  DMCDCCodec.init_random does), and the *_params_from_jax bridge gives
  the port's state_dict back exactly.
- key_fn_hem, key_fn_dc and their helpers and tables pinned byte for
  byte against dcvc_tpu's.
- A reference state_dict synthesised through the key map (the z priors'
  banks as per-layer Bitparm tensors, DC's fusion kernel as the grouped
  conv's weight, HEM's SE Dense kernels as Linear weights) is read by
  dcvc_tpu's importer into the port's weights, and by the models'
  from_reference through load_reference_into; an unknown key raises.
  No real HEM or DC checkpoint is in the repo.
- params.v1 files both ways, byte-identical on a rewrite.
- The codecs' init_random: every kernel (DC: and the fusion kernel)
  times init_scale, DC's feature_adaptor_1 cloned into slots 0 and 2.
The weights are tests/test_torch_dcvc_hem.py's and
tests/test_torch_dcvc_dc.py's lifted seeded inits.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import dcvc_dc as jdc
from dcvc_tpu.legacy import dcvc_hem as jhem
from dcvc_tpu.utils import torch_import as jkeys
from dcvc_tpu_torch.legacy import dcvc_dc, dcvc_hem
from dcvc_tpu_torch.runtime.dc_codec import DMCDCCodec
from dcvc_tpu_torch.runtime.hem_codec import DMCHEMCodec
from dcvc_tpu_torch.utils import keys
from dcvc_tpu_torch.utils.jax_bridge import dc_params_from_jax, \
    dc_params_to_jax, hem_params_from_jax, hem_params_to_jax
import test_torch_dcvc_dc as tdc
import test_torch_dcvc_hem as them

MODELS = {
    "hem": {"port": dcvc_hem.DMCHEM, "jax": jhem.DMCHEM,
            "configs": ("TINY_HEM_CONFIG", "HEM_CONFIG"), "port_mod": dcvc_hem,
            "jax_mod": jhem, "key_fn": keys.key_fn_hem,
            "jax_key_fn": jkeys.key_fn_hem, "to_jax": hem_params_to_jax,
            "from_jax": hem_params_from_jax, "tests": them,
            "codec": DMCHEMCodec},
    "dc": {"port": dcvc_dc.DMCDC, "jax": jdc.DMCDC,
           "configs": ("TINY_DC_CONFIG", "DC_CONFIG"), "port_mod": dcvc_dc,
           "jax_mod": jdc, "key_fn": keys.key_fn_dc,
           "jax_key_fn": jkeys.key_fn_dc, "to_jax": dc_params_to_jax,
           "from_jax": dc_params_from_jax, "tests": tdc,
           "codec": DMCDCCodec},
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def weights(request):
    """(the model's entry of MODELS, the lifted port model, its flax
    params)."""
    spec = MODELS[request.param]
    tm = spec["tests"].lifted_model().eval()
    return spec, tm, spec["tests"].jax_params(tm.state_dict())


def test_hem_configs_match_jax():
    for name in ("HEM_CONFIG", "TINY_HEM_CONFIG"):
        assert dataclasses.asdict(getattr(dcvc_hem, name)) == \
            dataclasses.asdict(getattr(jhem, name))


def _flax_shapes(model, cfg, h=64):
    """jax.eval_shape of the flax model's init on both DPB branches (the
    first P frame; a later one), merged; DC's slots 0 and 2 cloned from
    feature_adaptor_1."""
    x = jnp.zeros((1, h, h, 3))
    full = {"ref_frame": x, "ref_mv_y": jnp.zeros((1, h // 16, h // 16,
                                                   cfg.ch_mv))}
    if model == "hem":
        full["ref_feature"] = jnp.zeros((1, h, h, cfg.ch_n))
        full["ref_y"] = jnp.zeros((1, h // 16, h // 16, cfg.ch_m))
        init = lambda r, dpb: jhem.DMCHEM(cfg=cfg).init(  # noqa: E731
            {"params": r}, x, dpb, rng=r)
    else:
        full["ref_feature"] = jnp.zeros((1, h, h, cfg.ch_1x))
        full["ref_mv_feature"] = jnp.zeros((1, h // 4, h // 4, cfg.ch_mv))
        full["ref_y"] = jnp.zeros((1, h // 16, h // 16, cfg.ch_16x))
        init = lambda r, dpb: jdc.DMCDC(cfg=cfg).init(  # noqa: E731
            {"params": r}, x, dpb, 0, int(dpb["ref_y"] is not None), r)
    empty = {k: x if k == "ref_frame" else None for k in full}
    shapes = {}
    for dpb in (empty, full):
        tree = jax.eval_shape(lambda r: init(r, dpb), jax.random.PRNGKey(0))
        shapes.update({tuple(k.key for k in p): s.shape for p, s in
                       jax.tree_util.tree_leaves_with_path(tree["params"])})
    if model == "dc":
        for i in (0, 2):
            for leaf in ("kernel", "bias"):
                shapes[(f"feature_adaptor_{i}", "conv", leaf)] = \
                    shapes[("feature_adaptor_1", "conv", leaf)]
    return shapes


@pytest.mark.parametrize("model,which", [(m, i) for m in sorted(MODELS)
                                         for i in (0, 1)])
def test_bridge_matches_flax_tree(model, which):
    """The port's keys and shapes carried to flax are the flax model's
    (TINY; the published widths on the meta device)."""
    spec = MODELS[model]
    name = spec["configs"][which]
    with torch.device("meta"):
        port = spec["port"](getattr(spec["port_mod"], name))
    state = {k: torch.zeros(t.shape) for k, t in port.state_dict().items()}
    tree = spec["to_jax"](state)
    got = {tuple(k.key for k in p): tuple(v.shape)
           for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == _flax_shapes(model, getattr(spec["jax_mod"], name))


def test_bridge_round_trip_exact(weights):
    spec, tm, jp = weights
    back = spec["from_jax"](jax.tree.map(np.asarray, jp))
    state = tm.state_dict()
    assert set(back) == set(state)
    for k, t in state.items():
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("name", ["key_fn_hem", "_hem_unet_sub", "_hem_top",
                                  "key_fn_dc"])
def test_key_fn_source_equal(name):
    assert inspect.getsource(getattr(keys, name)) == \
        inspect.getsource(getattr(jkeys, name))


@pytest.mark.parametrize("name", ["_HEM_RBU_SLOTS", "_DC_SUBPEL_PARENTS",
                                  "_DC_HYPER_DECS"])
def test_key_fn_tables_equal(name):
    assert getattr(keys, name) == getattr(jkeys, name)


def reference_state(model, key_fn):
    """The reference state_dict of a port model, synthesised through
    key_fn: the z priors' banks split into per-layer Bitparm tensors
    (Q, C, 1, 1), DC's fusion kernel (g, I, ch/g) as the grouped conv's
    (ch, I, 1, 1) weight, HEM's SE Linear weights as they are, every
    other tensor under its reference key."""
    ref = {}
    for key, t in model.state_dict().items():
        segs = key.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        k = key_fn(path)
        if isinstance(k, tuple) and k[0] == "stack_last":
            for i, rk in enumerate(k[1]):
                ref[rk] = t[..., i].reshape(t.shape[0], t.shape[1], 1, 1)
        elif isinstance(k, tuple) and k[0] == "group_conv":
            g, icpg, ocpg = model.align.fusion_kernel.shape
            ref[k[1]] = t if t.dim() == 1 else \
                t.transpose(1, 2).reshape(g * ocpg, icpg, 1, 1)
        elif isinstance(k, tuple):          # ("linear", key)
            ref[k[1]] = t.clone()
        else:
            ref[k] = t.clone()
    return ref


def test_reference_state_dict_both_importers(weights, tmp_path):
    """A reference state_dict synthesised through the key map: dcvc_tpu's
    importer fills the flax tree with the port's weights and uses every
    key; from_reference (through load_reference_into of a .pth.tar)
    gives the port's state_dict back."""
    from dcvc_tpu_torch.utils.checkpoint import load_reference_into
    spec, tm, jp = weights
    ref = reference_state(tm, spec["key_fn"])
    assert "bit_estimator_z_mv.f4.h" in ref and \
        "optic_flow.moduleBasic.0.conv1.weight" in ref
    flax, unused = jkeys.import_state_dict(
        {k: v.numpy() for k, v in ref.items()},
        jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jp)),
        key_fn=spec["jax_key_fn"])
    assert unused == []
    for (p, got), (_, want) in zip(
            jax.tree_util.tree_leaves_with_path(flax),
            jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=str(p))
    path = str(tmp_path / "p.pth.tar")
    torch.save({"state_dict": ref}, path)
    model = load_reference_into(spec["port"](tm.cfg), path)
    for k, t in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k
    ref["mv_encoder.unknown.weight"] = torch.zeros(1)
    torch.save({"state_dict": ref}, path)
    with pytest.raises(KeyError, match="unused"):
        load_reference_into(spec["port"](tm.cfg), path)


def test_params_v1_files_both_ways(weights, tmp_path):
    from dcvc_tpu.utils.checkpoint import load_params, save_params
    from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
        native_config, save_native
    spec, tm, jp = weights
    jcfg = getattr(spec["jax_mod"], spec["configs"][0])
    path, again = str(tmp_path / "p.bin"), str(tmp_path / "again.bin")
    save_params(path, jax.tree.map(np.asarray, jp), jcfg)
    cfg = native_config(path, type(tm.cfg), None)
    assert cfg == tm.cfg
    model = load_native_into(spec["port"](cfg), path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, tm.state_dict()[k]), k
    save_native(model, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    tree, header = load_params(again)
    assert header["config"] == dataclasses.asdict(jcfg)
    jax.tree.map(np.testing.assert_array_equal, tree,
                 jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_random_damps(model):
    spec = MODELS[model]
    cfg = getattr(spec["port_mod"], spec["configs"][0])
    codec = spec["codec"].init_random(torch.Generator().manual_seed(2),
                                      cfg=cfg, init_scale=0.4, device="cpu")
    ref = spec["port"](cfg)
    ref.reset_parameters(torch.Generator().manual_seed(2))
    want = ref.state_dict()
    got = codec.model.state_dict()
    for k in want:
        src = k.replace("feature_adaptor_0.", "feature_adaptor_1.") \
            .replace("feature_adaptor_2.", "feature_adaptor_1.")
        scale = 0.4 if k.endswith(".weight") or \
            k.endswith("fusion_kernel") else 1.0
        torch.testing.assert_close(got[k], want[src] * scale, rtol=0,
                                   atol=0)
    if model == "dc":
        assert float(got["align.fusion_kernel"].abs().max()) > 0
