"""The port's reference-checkpoint converter, dcvc_tpu_torch/utils/
import_cli.py, against dcvc_tpu's (utils/import_cli.py over
torch_import.import_state_dict), on the CPU.

- For every kind of the JAX registry (dmci, hts, htl, ld, fm, dc, hem,
  tcm, dcvc, rt, the eight EVCs, cheng2020, hyperprior) at a TINY config
  patched into both registries (the CLIs take no config flag): a port
  model of the kind with seeded random values in every parameter, its
  weights as a reference .pth.tar (each family's synthesiser of the
  port's tests, which also writes the coder tables, reparametrizers and
  `.mask` buffers a reference file holds where the family has them).  The
  port's params.v1 file has the JAX converter's tree leaf for leaf (the
  JAX template: the port model's tree through the bridge) and the same
  header (config, family, source); neither reports an unmapped key.
- Strict mode raises on an added unknown key in both, --lenient returns
  it in both; a missing parameter raises in both.  The tolerated keys
  are the JAX converter's.  all_kinds, the name hints and guess_kind on
  every hint name match; an unknown name raises in both.
- A converted TCM file loads through family_main --model_path_p and codes
  the bytes of the model it came from.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import functools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import dcvc_tpu.legacy as jlegacy
import dcvc_tpu.models.dmc_ht as jht
import dcvc_tpu.models.dmc_ld as jld
import dcvc_tpu.models.dmci as jdmci
from dcvc_tpu.runtime import compressai_codec as jcc
from dcvc_tpu.utils import import_cli as jcli
from dcvc_tpu.utils.checkpoint import load_params as jload_params
from dcvc_tpu_torch.eval import family_main
from dcvc_tpu_torch.legacy import compressai_zoo, dcvc_dc, dcvc_fm, \
    dcvc_hem, dcvc_net, dcvc_rt, dcvc_tcm, evc
from dcvc_tpu_torch.models import dmc_ht, dmc_ld, dmci
from dcvc_tpu_torch.utils import import_cli, keys
from dcvc_tpu_torch.utils.checkpoint import load_params
from dcvc_tpu_torch.utils.jax_bridge import _converters, save_native
import test_torch_compressai
import test_torch_dcvc_net
import test_torch_dcvc_tcm
import test_torch_evc
import test_torch_fm_weights
import test_torch_hem_dc_weights
import test_torch_rt
from test_torch_family_fm import png_seq  # noqa: F401

EVCS = ("ll", "mm", "ss", "lm", "ls", "ml", "sl", "ms")
# kind -> (the port's TINY config, the JAX package's)
TINY = {
    "dmci": (dmci.TINY_CONFIG, jdmci.TINY_CONFIG),
    "hts": (dmc_ht.TINY_HT_CONFIG, jht.TINY_HT_CONFIG),
    "htl": (dmc_ht.TINY_HTL_CONFIG, jht.TINY_HTL_CONFIG),
    "ld": (dmc_ld.TINY_LD_CONFIG, jld.TINY_LD_CONFIG),
    "fm": (dcvc_fm.TINY_FM_CONFIG, jlegacy.dcvc_fm.TINY_FM_CONFIG),
    "dc": (dcvc_dc.TINY_DC_CONFIG, jlegacy.dcvc_dc.TINY_DC_CONFIG),
    "hem": (dcvc_hem.TINY_HEM_CONFIG, jlegacy.dcvc_hem.TINY_HEM_CONFIG),
    "tcm": (dcvc_tcm.TINY_TCM_CONFIG, jlegacy.dcvc_tcm.TINY_TCM_CONFIG),
    "dcvc": (dcvc_net.TINY_DCVC_CONFIG, jlegacy.dcvc_net.TINY_DCVC_CONFIG),
    "rt": (dcvc_rt.TINY_RT_CONFIG, jlegacy.dcvc_rt.TINY_RT_CONFIG),
    **{f"evc_{v}": (evc.TINY_EVC_CONFIG, jlegacy.evc.TINY_EVC_CONFIG)
       for v in EVCS},
    "cheng2020": (compressai_zoo.TINY_CHENG2020,
                  jlegacy.compressai_zoo.TINY_CHENG2020),
    "hyperprior": (compressai_zoo.TINY_HYPERPRIOR,
                   jlegacy.compressai_zoo.TINY_HYPERPRIOR),
}
KINDS = list(TINY)


def _state(model):
    return dict(model.state_dict())


# kind -> the reference state_dict of a port model of that kind
REFERENCE = {
    "dmci": _state, "hts": _state, "htl": _state, "ld": _state,
    "fm": test_torch_fm_weights.reference_state,
    "dc": functools.partial(test_torch_hem_dc_weights.reference_state,
                            key_fn=keys.key_fn_dc),
    "hem": functools.partial(test_torch_hem_dc_weights.reference_state,
                             key_fn=keys.key_fn_hem),
    "tcm": test_torch_dcvc_tcm.reference_state,
    "dcvc": test_torch_dcvc_net.reference_state,
    "rt": test_torch_rt._reference_state,
    **{f"evc_{v}": test_torch_evc._reference_state for v in EVCS},
    "cheng2020": functools.partial(test_torch_compressai.reference_state,
                                   "cheng2020"),
    "hyperprior": functools.partial(test_torch_compressai.reference_state,
                                    "bmshj2018"),
}


def seeded_model(kind, seed=0):
    """The port model of `kind` at its TINY config, every parameter
    seeded N(0, 0.1) values."""
    cls = import_cli.REGISTRY[kind][0]
    m = cls(TINY[kind][0])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return m


@pytest.fixture
def tiny_registries(monkeypatch):
    """Both registries at the TINY configs, the JAX one's template the
    port model's tree (no flax init)."""
    def patch(kind, model):
        cfg, jcfg = TINY[kind]
        monkeypatch.setitem(import_cli.REGISTRY, kind,
                            (import_cli.REGISTRY[kind][0], cfg))
        tree = jax.tree.map(np.asarray, _converters(model)[1](
            model.state_dict()))
        if kind in jcli._COMPRESSAI:
            codec = jcli._COMPRESSAI[kind][0]
            monkeypatch.setattr(
                getattr(jcc, codec), "init_random",
                lambda rng=None: types.SimpleNamespace(
                    params=tree["params"], cfg=jcfg))
        else:
            _, key_fn, ok = jcli.REGISTRY[kind]
            monkeypatch.setitem(jcli.REGISTRY, kind,
                                (lambda: (tree, jcfg), key_fn, ok))
    return patch


def _write(state, path):
    torch.save({"state_dict": state}, path)
    return path


def _same_trees(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(x, np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("kind", KINDS)
def test_converts_like_jax(kind, tiny_registries, tmp_path):
    model = seeded_model(kind)
    tiny_registries(kind, model)
    src = _write(REFERENCE[kind](model), str(tmp_path / f"{kind}.pth.tar"))
    out, jout = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert import_cli.main([src, out, "--kind", kind]) == 0
    assert jcli.import_checkpoint(src, jout, kind=kind) == []
    tree, hdr = load_params(out)
    jtree, jhdr = jload_params(jout)
    assert hdr == jhdr
    assert hdr["family"] == kind and hdr["source"] == src
    assert hdr["config"] == json.loads(json.dumps(dataclasses.asdict(
        TINY[kind][0])))
    _same_trees(tree, jtree)


@pytest.mark.parametrize("kind", ["tcm", "dcvc", "cheng2020"])
def test_strict_and_lenient_like_jax(kind, tiny_registries, tmp_path):
    model = seeded_model(kind, 1)
    tiny_registries(kind, model)
    state = REFERENCE[kind](model)
    # the family's tolerated keys pass in strict mode
    tolerated = {"dcvc": "auto_regressive.mask",
                 "cheng2020": "entropy_bottleneck._offset"}
    assert tolerated.get(kind, next(iter(state))) in state
    state["unknown.weight"] = torch.zeros(3)
    src = _write(state, str(tmp_path / f"{kind}.pth.tar"))
    out = str(tmp_path / "o.bin")
    with pytest.raises(ValueError, match="unmapped"):
        import_cli.import_checkpoint(src, out, kind=kind)
    with pytest.raises(ValueError, match="unmapped"):
        jcli.import_checkpoint(src, out, kind=kind)
    got = import_cli.import_checkpoint(src, out, kind=kind, strict=False)
    want = jcli.import_checkpoint(src, out, kind=kind, strict=False)
    assert got == want == ["unknown.weight"]
    assert import_cli.main([src, out, "--kind", kind, "--lenient"]) == 0

    del state["unknown.weight"]
    del state[next(k for k in state if k.endswith(".weight"))]
    src = _write(state, str(tmp_path / "missing.pth.tar"))
    with pytest.raises(KeyError):
        import_cli.import_checkpoint(src, out, kind=kind)
    with pytest.raises(KeyError):
        jcli.import_checkpoint(src, out, kind=kind)


def test_tolerated_keys_are_the_jax_converters():
    assert import_cli._COMPRESSAI_UNUSED_OK == jcli._COMPRESSAI_UNUSED_OK
    assert set(import_cli._COMPRESSAI) == set(jcli._COMPRESSAI)
    for kind, (_, _, ok) in jcli.REGISTRY.items():
        assert import_cli._ALLOWED_SUFFIXES.get(kind, ()) == ok, kind
    for kind in import_cli._COMPRESSAI:
        assert import_cli._ALLOWED_SUFFIXES[kind] == (".mask",)


def test_kinds_and_name_hints_match_jax():
    assert import_cli.all_kinds() == jcli.all_kinds()
    assert set(import_cli.REGISTRY) == set(jcli.REGISTRY) | set(
        jcli._COMPRESSAI)
    assert import_cli._NAME_HINTS == jcli._NAME_HINTS
    for hint, kind in jcli._NAME_HINTS:
        path = f"/ckpt/{hint}_q1.pth.tar"
        assert import_cli.guess_kind(path) == jcli.guess_kind(path) == kind
    for guess in (import_cli.guess_kind, jcli.guess_kind):
        with pytest.raises(ValueError, match="cannot guess"):
            guess("/ckpt/unknown.pth.tar")


def test_converted_tcm_codes_the_same_bytes(png_seq, tmp_path,  # noqa: F811
                                            monkeypatch):
    cfg = TINY["tcm"][0]
    monkeypatch.setitem(import_cli.REGISTRY, "tcm", (dcvc_tcm.DMCTCM, cfg))
    model = test_torch_dcvc_tcm.lifted_model(seed=1)
    native = str(tmp_path / "tcm.bin")
    save_native(model, native)
    src = _write(test_torch_dcvc_tcm.reference_state(model),
                 str(tmp_path / "tcm.pth.tar"))
    converted = str(tmp_path / "converted.bin")
    assert import_cli.main([src, converted, "--kind", "tcm"]) == 0
    bins = {}
    for name, path in (("native", native), ("converted", converted)):
        out = tmp_path / name
        assert family_main.main([
            "--model", "tcm", "--test_config", png_seq[0], "--frame_num",
            "3", "--gop", "4", "--tiny", "--model_path_p", path,
            "--device", "cpu", "--stream_path", str(out), "--output_path",
            str(out) + ".json"]) == 0
        bins[name] = {f: (out / f).read_bytes()
                      for f in sorted(os.listdir(out))}
    assert len(bins["native"]) == 3
    assert bins["converted"] == bins["native"]
