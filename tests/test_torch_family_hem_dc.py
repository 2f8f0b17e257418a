"""The legacy-family evaluation of the port for DCVC-HEM and DCVC-DC
(eval/family.py, eval/family_main.py `--model hem | dc`, hem's `--fast`)
against dcvc_tpu's (eval/family.py), at TINY_HEM_CONFIG / TINY_DC_CONFIG
and TINY_INTRA_NOAR_CONFIG, float32 on the CPU.

The two runners load the same dcvc_tpu.params.v1 files, which the port
writes (save_native): the P model is tests/test_torch_dcvc_hem.py's or
tests/test_torch_dcvc_dc.py's lifted seeded model, the intra model
perf_probe.lifted_legacy_intra's IntraNoAR, so that both code symbols.
The JAX runner's _build calls its codecs' init_random; monkeypatch makes
that return codecs around these params, and the runner then loads the
files as the port's does.

On tests/test_torch_family_fm.py's 6-frame 48x80 PNG sequence at gop 4
(I P P P I P: the DPB reseeded by the second intra frame; DC's P frames
on INDEX_MAP_DC's adaptors 1, 0, 2 and 1) the port writes the JAX
runner's six per-frame container files byte for byte, and its numbers
(per-frame bpp, frame types, q index, the bit-exact flag) equal them,
the PSNRs within PSNR_ATOL (1e-4 dB: two samples a level apart at these
frames' low PSNRs).  The CLI gives the same files and numbers.  HEM's
estimated-bits mode (`--fast`) gives the JAX runner's bpp within 1e-5
relative and its PSNRs within PSNR_ATOL; DC's raises, as the JAX
runner's does.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcvc_tpu.eval import family as jfamily
from dcvc_tpu.legacy import dcvc_dc as jdc
from dcvc_tpu.legacy import dcvc_hem as jhem
from dcvc_tpu.legacy import hem_intra as jhi
from dcvc_tpu.runtime import dc_codec as jdc_codec
from dcvc_tpu.runtime import evc_codec as jevc
from dcvc_tpu.runtime import hem_codec as jhem_codec
from dcvc_tpu.utils.checkpoint import load_params
from dcvc_tpu_torch.eval import family, family_main
from dcvc_tpu_torch.legacy.hem_intra import IntraNoAR, \
    TINY_INTRA_NOAR_CONFIG
from dcvc_tpu_torch.perf_probe import lifted_legacy_intra
from dcvc_tpu_torch.utils.jax_bridge import save_native
from test_torch_family import _same_numbers
from test_torch_family_fm import GOP, N, _same_fast, png_seq  # noqa: F401
import test_torch_dcvc_dc
import test_torch_dcvc_hem

BINS = [f"cls_seq1_r0_q12_{i}.bin" for i in range(N)]
# each framework rounds its own float reconstruction to 8 bits, and the
# two agree within float noise, so a sample may land on the next level in
# one of them: at these frames' ~6-12 dB (random weights) that moves a
# 48x80 frame's PSNR by up to ~4e-5 dB ((2|e| + 1) over its squared
# error); PSNR_ATOL admits two such samples
PSNR_ATOL = 1e-4
# (the port's lifted P model, the JAX codec module and class, the flax
# model class) of each model
P_MODELS = {"hem": (test_torch_dcvc_hem.lifted_model, jhem_codec,
                    "DMCHEMCodec", jhem.DMCHEM),
            "dc": (test_torch_dcvc_dc.lifted_model, jdc_codec,
                   "DMCDCCodec", jdc.DMCDC)}


@pytest.fixture(scope="module", params=sorted(P_MODELS))
def model_files(request, tmp_path_factory):
    """(model, intra file, P file): dcvc_tpu.params.v1 files the port
    writes."""
    model = request.param
    d = tmp_path_factory.mktemp(f"models_{model}")
    paths = (str(d / "i.bin"), str(d / "p.bin"))
    save_native(lifted_legacy_intra(IntraNoAR, TINY_INTRA_NOAR_CONFIG, 0),
                paths[0])
    save_native(P_MODELS[model][0](), paths[1])
    return (model,) + paths


@contextlib.contextmanager
def _jax_runner(model_files, out):
    """dcvc_tpu's FamilyRunner(model, tiny) on model_files, its codecs'
    init_random replaced by codecs around the files' params."""
    model, path_i, path_p = model_files
    params_i = jax.tree.map(jnp.asarray, load_params(path_i)[0])
    params_p = jax.tree.map(jnp.asarray, load_params(path_p)[0])
    _, codec_mod, codec_name, flax_cls = P_MODELS[model]

    def intra(cls, rng=None, cfg=None, dtype=jnp.float32, init_scale=1.0):
        return cls(jhi.IntraNoAR(cfg=cfg), params_i)

    def p_frame(cls, rng=None, cfg=None, dtype=jnp.float32, init_scale=1.0):
        return cls(flax_cls(cfg=cfg), params_p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jevc.IntraNoARCodec, "init_random", classmethod(intra))
        mp.setattr(getattr(codec_mod, codec_name), "init_random",
                   classmethod(p_frame))
        yield jfamily.FamilyRunner(model, str(out), rate_num=1, tiny=True,
                                   model_path_i=path_i, model_path_p=path_p)


@pytest.fixture(scope="module")
def jax_runner(model_files, tmp_path_factory):
    with _jax_runner(model_files,
                     tmp_path_factory.mktemp("jax_bin")) as runner:
        yield runner


@pytest.fixture(scope="module")
def jax_run(jax_runner, png_seq):  # noqa: F811
    res = jax_runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    out = jax_runner.stream_dir
    return res, {f: open(os.path.join(out, f), "rb").read()
                 for f in sorted(os.listdir(out))}


def _port_runner(model_files, out):
    model, path_i, path_p = model_files
    return family.FamilyRunner(model, str(out), rate_num=1, tiny=True,
                               model_path_i=path_i, model_path_p=path_p,
                               device="cpu")


def _bins(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_runner_matches_jax(model_files, png_seq, jax_run,  # noqa: F811
                            tmp_path):
    jres, jbins = jax_run
    runner = _port_runner(model_files, tmp_path)
    res = runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    bins = _bins(tmp_path)
    assert list(bins) == list(jbins) == BINS
    assert bins == jbins
    _same_numbers(res, jres, PSNR_ATOL)
    r = res["rate_0"]
    np.testing.assert_array_equal(r["frame_bpp"],
                                  jres["rate_0"]["frame_bpp"])
    assert r["bitexact"] and r["frame_type"] == [0, 1, 1, 1, 0, 1]
    assert r["q_index"] == 12 and all(np.isfinite(r["frame_psnr"]))
    # every P frame codes more than its z symbols
    assert min(len(jbins[BINS[i]]) for i in (1, 2, 3, 5)) > 20


def test_cli_matches_jax(model_files, png_seq, jax_run,  # noqa: F811
                         tmp_path):
    jres, jbins = jax_run
    model = model_files[0]
    out = tmp_path / "out.json"
    code = family_main.main([
        "--model", model, "--test_config", png_seq[0], "--rate_num", "1",
        "--gop", str(GOP), "--tiny", "--stream_path", str(tmp_path / "bin"),
        "--output_path", str(out), "--model_path_i", model_files[1],
        "--model_path_p", model_files[2], "--device", "cpu"])
    assert code == 0
    data = json.loads(out.read_text())
    assert data["model"] == model
    _same_numbers(data["results"]["cls"]["seq1"], jres, PSNR_ATOL)
    assert _bins(tmp_path / "bin") == jbins


def test_fast_matches_jax(model_files, png_seq, jax_runner,  # noqa: F811
                          tmp_path):
    """HEM's estimated-bits mode, the runner and the CLI, against the JAX
    runner's; DC has none in either runner."""
    model = model_files[0]
    runner = _port_runner(model_files, tmp_path)
    if model == "dc":
        with pytest.raises(ValueError, match="no estimated-bits mode"):
            runner.run_sequence_fast(png_seq[1], 0, GOP)
        with pytest.raises(AssertionError, match="not implemented"):
            jax_runner.run_sequence_fast(png_seq[1], 0, GOP)
        return
    want = jax_runner.run_sequence_fast(png_seq[1], 0, GOP)
    got = runner.run_sequence_fast(png_seq[1], 0, GOP)
    _same_fast(got, want, PSNR_ATOL)
    assert all(b > 0.01 for b in got["frame_bpp"])
    out = tmp_path / "out.json"
    code = family_main.main([
        "--model", model, "--test_config", png_seq[0], "--rate_num", "1",
        "--gop", str(GOP), "--tiny", "--fast", "--stream_path",
        str(tmp_path / "bin"), "--output_path", str(out), "--model_path_i",
        model_files[1], "--model_path_p", model_files[2], "--device",
        "cpu"])
    assert code == 0
    _same_fast(json.loads(out.read_text())["results"]["cls"]["seq1"]
               ["rate_0"], want, PSNR_ATOL)
    assert not os.listdir(tmp_path / "bin")


def test_models_ported():
    assert set(family.MODELS) >= {"hem", "dc"}
    assert family.FAST_MODELS == ("fm", "hem", "dcvc", "tcm")
    assert family.INDEX_MAP_DC == jfamily.INDEX_MAP_DC
    for model in family.NOT_PORTED:
        with pytest.raises(ValueError, match="not ported yet"):
            family.FamilyRunner(model, "unused", device="cpu")
