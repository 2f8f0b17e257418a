"""The DCVC-TCM family path of the port against dcvc_tpu's, float32 on the
CPU at TINY_HYPERPRIOR / TINY_TCM_CONFIG.

- The port's FamilyRunner("tcm") and family_main --model tcm against
  dcvc_tpu's runner on tests/test_torch_family_fm.py's 6-frame 48x80 PNG
  sequence at gop 4 (I P P P I P), both runners loading the same
  dcvc_tpu.params.v1 files, which the port writes (save_native): the
  intra model perf_probe.lifted_compressai's bmshj2018, the P model
  tests/test_torch_dcvc_tcm.py's lifted DMCTCM.  The JAX runner's _build
  calls its codecs' init_random; monkeypatch makes that return codecs
  around these params (no flax init), and the runner then loads the files
  as the port's does.  The six per-frame files (the two-string intra
  container, TCM's one-string P file) are byte-identical, the numbers
  equal, the PSNRs within PSNR_ATOL.
- `--fast` (the intra frames coded, the P frames' bpp from DMCTCM's
  training forward against the previous clipped recon and the carried
  feature) gives the JAX runner's bpp within 1e-5 relative and writes no
  stream.
- Every model of the JAX runner is ported: NOT_PORTED is empty.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import json
import os

import jax
import numpy as np
import pytest

from dcvc_tpu.eval import family as jfamily
from dcvc_tpu.legacy import compressai_zoo as jzoo
from dcvc_tpu.legacy import dcvc_tcm as jtcm
from dcvc_tpu.runtime import compressai_codec as jcc
from dcvc_tpu.runtime import tcm_codec as jtc
from dcvc_tpu.utils.checkpoint import load_params
from dcvc_tpu_torch.eval import family, family_main
from dcvc_tpu_torch.legacy.compressai_zoo import TINY_HYPERPRIOR
from dcvc_tpu_torch.perf_probe import lifted_compressai
from dcvc_tpu_torch.utils.jax_bridge import save_native
from test_torch_dcvc_tcm import lifted_model
from test_torch_family import _same_numbers
from test_torch_family_fm import GOP, N, _same_fast, png_seq  # noqa: F401

BINS = [f"cls_seq1_r0_q12_{i}.bin" for i in range(N)]
# each framework rounds its own float reconstruction to 8 bits, and the
# two agree within float noise, so a sample may land on the next level in
# one of them (tests/test_torch_family_hem_dc.py)
PSNR_ATOL = 1e-4


def _tree(path):
    return jax.tree.map(np.asarray, load_params(path)[0])


@contextlib.contextmanager
def jax_init_from(files):
    """The JAX codecs' init_random returning codecs around the params.v1
    files' weights: files {"bmshj2018", "tcm"} -> path."""
    def intra(cls, rng=None, cfg=None, dtype=None):
        tree = _tree(files["bmshj2018"])
        return cls(jzoo.ScaleHyperprior(cfg=cfg), tree["params"],
                   tree["eb_params"])

    def p_frame(cls, rng=None, cfg=None, dtype=None, init_scale=1.0):
        return cls(jtcm.DMCTCM(cfg=cfg), _tree(files["tcm"]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcc.HyperpriorCodec, "init_random", classmethod(intra))
        mp.setattr(jtc.DMCTCMCodec, "init_random", classmethod(p_frame))
        yield


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("models_tcm")
    files = {name: str(d / f"{name}.bin") for name in ("bmshj2018", "tcm")}
    save_native(lifted_compressai("bmshj2018", TINY_HYPERPRIOR, 0),
                files["bmshj2018"])
    save_native(lifted_model(seed=1), files["tcm"])
    return files


@pytest.fixture(scope="module")
def jax_runner(model_files, tmp_path_factory):
    with jax_init_from(model_files):
        yield jfamily.FamilyRunner(
            "tcm", str(tmp_path_factory.mktemp("jax_bin")), rate_num=1,
            tiny=True, model_path_i=model_files["bmshj2018"],
            model_path_p=model_files["tcm"])


@pytest.fixture(scope="module")
def jax_run(jax_runner, png_seq):  # noqa: F811
    res = jax_runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    return res, _bins(jax_runner.stream_dir)


def _bins(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _port_runner(model_files, out):
    return family.FamilyRunner("tcm", str(out), rate_num=1, tiny=True,
                               model_path_i=model_files["bmshj2018"],
                               model_path_p=model_files["tcm"],
                               device="cpu")


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
    assert r["bitexact"] and r["frame_type"] == [0, 1, 1, 1, 0, 1]
    assert all(np.isfinite(r["frame_psnr"]))
    # every P frame codes its y and mv grids
    assert min(len(jbins[BINS[i]]) for i in (1, 2, 3, 5)) > 60


def test_cli_and_fast_match_jax(model_files, png_seq, jax_run,  # noqa: F811
                                jax_runner, tmp_path):
    jres, jbins = jax_run
    base = ["--model", "tcm", "--test_config", png_seq[0], "--rate_num",
            "1", "--gop", str(GOP), "--tiny", "--model_path_i",
            model_files["bmshj2018"], "--model_path_p", model_files["tcm"],
            "--device", "cpu"]
    out = tmp_path / "out.json"
    assert family_main.main(base + ["--stream_path", str(tmp_path / "bin"),
                                    "--output_path", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["model"] == "tcm"
    _same_numbers(data["results"]["cls"]["seq1"], jres, PSNR_ATOL)
    assert _bins(tmp_path / "bin") == jbins

    want = jax_runner.run_sequence_fast(png_seq[1], 0, GOP)
    got = _port_runner(model_files, tmp_path / "f").run_sequence_fast(
        png_seq[1], 0, GOP)
    _same_fast(got, want, PSNR_ATOL)
    assert all(b > 0.01 for b in got["frame_bpp"])
    assert family_main.main(base + ["--fast", "--stream_path",
                                    str(tmp_path / "fbin"), "--output_path",
                                    str(out)]) == 0
    _same_fast(json.loads(out.read_text())["results"]["cls"]["seq1"]
               ["rate_0"], want, PSNR_ATOL)
    assert not os.listdir(tmp_path / "fbin")


def test_tcm_ported():
    assert family.NOT_PORTED == ()
    # family_main's --model choices, test_video_family.py's
    assert set(family.MODELS) == {"dcvc", "tcm", "hem", "dc", "fm", "rt"}
    assert "tcm" in family.MODELS and "tcm" in family.FAST_MODELS
    assert family.P_CODECS["tcm"][0].__name__ == "DMCTCMCodec"
