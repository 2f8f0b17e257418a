"""The DCVC-2021 family path and the CompressAI image CLI of the port
against dcvc_tpu's, float32 on the CPU at TINY_CHENG2020 /
TINY_DCVC_CONFIG / TINY_HYPERPRIOR.

- Family: the port's FamilyRunner("dcvc") and family_main --model dcvc
  against dcvc_tpu's runner on tests/test_torch_family_fm.py's 6-frame
  48x80 PNG sequence at gop 4 (I P P P I P), both runners loading the
  same dcvc_tpu.params.v1 files, which the port writes (save_native):
  the intra model perf_probe.lifted_compressai's cheng2020, the P model
  tests/test_torch_dcvc_net.py's lifted DCVCNet.  The JAX runner's _build
  calls its codecs' init_random; monkeypatch makes that return codecs
  around these params (no flax init), and the runner then loads the files
  as the port's does.  The six per-frame container files (two strings for
  an intra frame, four for a P frame) are byte-identical, the numbers
  equal, the PSNRs within PSNR_ATOL.  `--fast` (the intra frames coded,
  the P frames' bpp from DCVCNet's forward) gives the JAX runner's bpp
  within 1e-5 relative and no stream.
- Image CLI: image_main --i_frame_model cheng2020 | bmshj2018 --tiny on
  the params.v1 files of lifted_compressai's models writes test_image.py's
  .bin files (its build_codec / code_one called in-process, init_random
  patched likewise) on a 64x96 and an odd 69x91 PNG, every image
  bit-exact; the seeded random weights run bit-exact too; --device_ec 1
  raises with either model.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import argparse
import contextlib
import json
import os

import jax
import numpy as np
import pytest

from dcvc_tpu.eval import family as jfamily
from dcvc_tpu.legacy import compressai_zoo as jzoo
from dcvc_tpu.legacy import dcvc_net as jnet
from dcvc_tpu.runtime import compressai_codec as jcc
from dcvc_tpu.runtime import dcvc_codec as jdc
from dcvc_tpu.utils.checkpoint import load_params
from dcvc_tpu_torch.eval import family, family_main, image_main
from dcvc_tpu_torch.legacy.compressai_zoo import TINY_CHENG2020, \
    TINY_HYPERPRIOR
from dcvc_tpu_torch.perf_probe import lifted_compressai
from dcvc_tpu_torch.utils.jax_bridge import save_native
from dcvc_tpu_torch.utils.metrics import calc_psnr
from dcvc_tpu_torch.utils.png import load_rgb, write_png
from test_torch_family import _same_numbers
from test_torch_family_fm import GOP, N, _same_fast, png_seq  # noqa: F401
from test_torch_dcvc_net import lifted_model

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
    files' weights: files {"cheng2020", "bmshj2018", "dcvc"} -> path."""
    def compressai(name, model_cls):
        def init(cls, rng=None, cfg=None, dtype=None):
            tree = _tree(files[name])
            return cls(model_cls(cfg=cfg), tree["params"], tree["eb_params"])
        return classmethod(init)

    def p_frame(cls, rng=None, cfg=None, dtype=None, init_scale=1.0):
        return cls(jnet.DCVCNet(cfg=cfg), _tree(files["dcvc"]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcc.Cheng2020Codec, "init_random",
                   compressai("cheng2020", jzoo.Cheng2020Anchor))
        mp.setattr(jcc.HyperpriorCodec, "init_random",
                   compressai("bmshj2018", jzoo.ScaleHyperprior))
        mp.setattr(jdc.DCVCCodec, "init_random", classmethod(p_frame))
        yield


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("models_dcvc")
    files = {name: str(d / f"{name}.bin")
             for name in ("cheng2020", "bmshj2018", "dcvc")}
    save_native(lifted_compressai("cheng2020", TINY_CHENG2020, 0),
                files["cheng2020"])
    save_native(lifted_compressai("bmshj2018", TINY_HYPERPRIOR, 0),
                files["bmshj2018"])
    save_native(lifted_model(seed=1), files["dcvc"])
    return files


@pytest.fixture(scope="module")
def jax_runner(model_files, tmp_path_factory):
    with jax_init_from(model_files):
        yield jfamily.FamilyRunner(
            "dcvc", str(tmp_path_factory.mktemp("jax_bin")), rate_num=1,
            tiny=True, model_path_i=model_files["cheng2020"],
            model_path_p=model_files["dcvc"])


@pytest.fixture(scope="module")
def jax_run(jax_runner, png_seq):  # noqa: F811
    res = jax_runner.run(png_seq[1], [0], GOP, seq_name="cls_seq1")
    out = jax_runner.stream_dir
    return res, _bins(out)


def _bins(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _port_runner(model_files, out):
    return family.FamilyRunner("dcvc", str(out), rate_num=1, tiny=True,
                               model_path_i=model_files["cheng2020"],
                               model_path_p=model_files["dcvc"],
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
    # every P frame codes its y and mv planes
    assert min(len(jbins[BINS[i]]) for i in (1, 2, 3, 5)) > 60


def test_cli_and_fast_match_jax(model_files, png_seq, jax_run,  # noqa: F811
                                jax_runner, tmp_path):
    jres, jbins = jax_run
    base = ["--model", "dcvc", "--test_config", png_seq[0], "--rate_num",
            "1", "--gop", str(GOP), "--tiny", "--model_path_i",
            model_files["cheng2020"], "--model_path_p", model_files["dcvc"],
            "--device", "cpu"]
    out = tmp_path / "out.json"
    assert family_main.main(base + ["--stream_path", str(tmp_path / "bin"),
                                    "--output_path", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["model"] == "dcvc"
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


def test_dcvc_ported():
    assert family.NOT_PORTED == ()
    assert "dcvc" in family.MODELS and "dcvc" in family.FAST_MODELS
    assert image_main.NOT_PORTED == ()


# ------------------------------------------------------------ image CLI

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp("compressai_png")
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (64, 96)), ("b.png", (69, 91))):
        img = gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (2, 2, 0))
        write_png(str(root / name),
                  np.clip((img - 127.5) * 3 + 127.5, 0, 255)
                  .astype(np.uint8))
    return root


def _port_image(pngs, out, model, *extra):
    argv = ["--i_frame_model", model, "--image_path", str(pngs), "--tiny",
            "--device", "cpu", "--stream_path", str(out), "--output_path",
            str(out) + ".json", *extra]
    rc = image_main.main(argv)
    with open(str(out) + ".json") as f:
        return rc, json.load(f)


def _jax_image(pngs, out, model, model_files):
    """test_image.py's build_codec / code_one, in-process."""
    import test_image
    args = argparse.Namespace(i_frame_model=model, tiny=True,
                              model_path=model_files[model])
    with jax_init_from(model_files):
        codec = test_image.build_codec(args)
    os.makedirs(out)
    res = {}
    for name in sorted(os.listdir(pngs)):
        rgb = load_rgb(str(pngs / name))
        h, w = rgb.shape[:2]
        x_dec, x_enc, n = test_image.code_one(
            codec, args, rgb.astype(np.float32) / 255.0, h, w,
            str(out / name.replace(".png", ".bin")))
        rec = np.clip(np.round(x_dec * 255), 0, 255)
        res[name] = {"bpp": n * 8 / (h * w),
                     "psnr": float(calc_psnr(rgb.astype(np.float64), rec)),
                     "bitexact": bool(np.array_equal(x_dec, x_enc))}
    return res


@pytest.mark.parametrize("model", ["cheng2020", "bmshj2018"])
def test_image_cli_matches_test_image(pngs, model_files, tmp_path, model):
    rc, got = _port_image(pngs, tmp_path / "port", model, "--model_path",
                          model_files[model])
    want = _jax_image(pngs, tmp_path / "jax", model, model_files)
    assert rc == 0 and got["model"] == model
    bins = _bins(tmp_path / "port")
    assert sorted(bins) == ["a.bin", "b.bin"]
    assert bins == _bins(tmp_path / "jax")
    assert min(len(b) for b in bins.values()) > 80
    for name, w in want.items():
        g = got["per_image"][name]
        assert g["bpp"] == w["bpp"] and g["bitexact"] and w["bitexact"]
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0,
                                   atol=PSNR_ATOL)


@pytest.mark.parametrize("model", ["cheng2020", "bmshj2018"])
def test_image_cli_random_weights_and_device_ec(pngs, tmp_path, model):
    rc, got = _port_image(pngs, tmp_path / "rand", model)
    assert rc == 0 and got["summary"]["images"] == 2
    assert all(r["bitexact"] for r in got["per_image"].values())
    with pytest.raises(ValueError, match="device entropy decode"):
        _port_image(pngs, tmp_path / "dev", model, "--device_ec", "1")
