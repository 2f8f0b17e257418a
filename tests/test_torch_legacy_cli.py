"""The legacy intra codecs in the port's image CLI, and the two faults the
port repaired, on the CPU in float32 at the TINY configs.

- Image CLI: image_main --i_frame_model evc | intra_noar --tiny on
  params.v1 files the JAX package writes (its seeded TINY codecs, lifted
  as tests/test_torch_evc.py and tests/test_torch_hem_intra.py lift them
  so that symbols are coded) writes the same .bin bytes and bpp as
  test_image.py's build_codec / code_one called in-process, with PSNRs
  within 1e-5 dB (each framework rounds its own float reconstruction to
  8 bits; the two agree within 2e-5, so a pixel may round apart), every
  image bit-exact.  The seeded random weights run bit-exact too; an EVC
  reference .pth.tar is read; --device_ec 1 raises with either model.
- PNG sequences without PIL: the harness on a PNG source with PIL
  blocked (sys.modules["PIL"] = None, as on the machine with the card)
  gives the .bin file and PSNRs it gives with video_io's PIL classes,
  and its --save_decoded_frame PNGs hold the same pixels.
- Family codecs in float32: family_dtype gives float32 for "cuda" (and
  the CPU) unless bf16 is asked for; FamilyRunner and family_main
  --dtype follow it.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import argparse
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dcvc_tpu.legacy import evc as jevc
from dcvc_tpu.legacy import hem_intra as jhi
from dcvc_tpu.runtime.evc_codec import EVCCodec as JaxEVC
from dcvc_tpu.runtime.evc_codec import IntraNoARCodec as JaxNoAR
from dcvc_tpu.utils.checkpoint import save_params
from dcvc_tpu_torch.eval import family, family_main, harness, image_main
from dcvc_tpu_torch.legacy.evc import EVC, TINY_EVC_CONFIG
from dcvc_tpu_torch.models.dmc_ld import TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCLDCodec
from dcvc_tpu_torch.utils import video_io
from dcvc_tpu_torch.utils.jax_bridge import load_native_into
from dcvc_tpu_torch.utils.metrics import calc_psnr
from dcvc_tpu_torch.utils.png import load_rgb, write_png

PSNR_ATOL = 1e-5


def _lift_evc(params, n):
    p = jax.tree.map(np.array, params)
    p["q_basic"] *= 0.02
    p["y_prior_fusion"]["layers_1"]["ffn"]["conv2"]["conv"]["bias"][
        n:2 * n] += 2.0
    sp = p["y_spatial_prior"]["layers_2"]["ffn"]["conv2"]["conv"]["bias"]
    sp[:n // 2] += 2.0
    sp[n:n + n // 2] += 2.0
    return p


def _lift_noar(params, n):
    p = jax.tree.map(np.array, params)
    p["enc"]["layers_6"]["conv"]["kernel"] *= 20.0
    p["hyper_enc"]["layers_8"]["conv"]["kernel"] *= 8.0
    p["y_prior_fusion"]["layers_4"]["conv"]["bias"][n:2 * n] += 2.0
    sp = p["y_spatial_prior"]["layers_4"]["conv"]["bias"]
    sp[:n // 2] += 2.0
    sp[n:n + n // 2] += 2.0
    return p


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two seeded PNGs (one of odd size) and params.v1 files of the JAX
    package's lifted TINY EVC and IntraNoAR."""
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp("legacy_images")
    os.makedirs(root / "png")
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (64, 96)), ("b.png", (69, 91))):
        img = gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (2, 2, 0))
        img = (img - 127.5) * 3 + 127.5
        write_png(str(root / "png" / name),
                  np.clip(img, 0, 255).astype(np.uint8))
    cfg = jevc.TINY_EVC_CONFIG
    init = JaxEVC.init_random(jax.random.PRNGKey(0), cfg=cfg,
                              init_scale=0.7)
    save_params(str(root / "evc.bin"), _lift_evc(init.params, cfg.n), cfg)
    cfg = jhi.TINY_INTRA_NOAR_CONFIG
    init = JaxNoAR.init_random(jax.random.PRNGKey(0), cfg=cfg,
                               init_scale=0.7)
    save_params(str(root / "intra_noar.bin"),
                _lift_noar(init.params, cfg.n), cfg)
    return root


def _port_run(root, out, model, *extra):
    argv = ["--i_frame_model", model, "--image_path", str(root / "png"),
            "--q_scale", "1.1", "--tiny", "--device", "cpu",
            "--stream_path", str(out), "--output_path", str(out) + ".json",
            *extra]
    rc = image_main.main(argv)
    with open(str(out) + ".json") as f:
        result = json.load(f)
    return rc, result


def _bins(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def _jax_run(root, out, model):
    """test_image.py's build_codec / code_one, in-process, on the PNGs."""
    import test_image
    args = argparse.Namespace(i_frame_model=model, tiny=True, q_scale=1.1,
                              model_path=str(root / f"{model}.bin"))
    codec = test_image.build_codec(args)
    os.makedirs(out)
    res = {}
    for name in sorted(os.listdir(root / "png")):
        rgb = load_rgb(str(root / "png" / name))
        h, w = rgb.shape[:2]
        x_dec, x_enc, n = test_image.code_one(
            codec, args, rgb.astype(np.float32) / 255.0, h, w,
            str(out / name.replace(".png", ".bin")))
        rec = np.clip(np.round(x_dec * 255), 0, 255)
        res[name] = {"bpp": n * 8 / (h * w),
                     "psnr": float(calc_psnr(rgb.astype(np.float64), rec)),
                     "bitexact": bool(np.array_equal(x_dec, x_enc))}
    return res


@pytest.mark.parametrize("model", ["evc", "intra_noar"])
def test_image_cli_matches_test_image(inputs, tmp_path, model):
    rc, got = _port_run(inputs, tmp_path / "port", model, "--model_path",
                        str(inputs / f"{model}.bin"))
    want = _jax_run(inputs, tmp_path / "jax", model)
    assert rc == 0 and got["model"] == model
    bins = _bins(tmp_path / "port")
    assert sorted(bins) == ["a.bin", "b.bin"]
    assert bins == _bins(tmp_path / "jax")
    assert min(len(b) for b in bins.values()) > 60
    for name, w in want.items():
        g = got["per_image"][name]
        assert g["bpp"] == w["bpp"] and g["bitexact"] and w["bitexact"]
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0,
                                   atol=PSNR_ATOL)


@pytest.mark.parametrize("model", ["evc", "intra_noar"])
def test_image_cli_random_weights_and_device_ec(inputs, tmp_path, model):
    rc, got = _port_run(inputs, tmp_path / "rand", model)
    assert rc == 0 and got["summary"]["images"] == 2
    assert all(r["bitexact"] for r in got["per_image"].values())
    with pytest.raises(ValueError, match="device entropy decode"):
        _port_run(inputs, tmp_path / "dev", model, "--device_ec", "1")


def test_image_cli_reads_an_evc_reference_checkpoint(inputs, tmp_path):
    """An EVC .pth.tar (the reference's key names) codes as the params.v1
    file of the same weights does; IntraNoAR takes params.v1 only."""
    from dcvc_tpu_torch.utils.checkpoint import save_reference
    model = load_native_into(EVC(TINY_EVC_CONFIG), str(inputs / "evc.bin"))
    state = {k: t.detach().clone() for k, t in model.state_dict().items()}
    for name in ("h", "b", "a"):
        bank = state.pop(f"bit_estimator_z.{name}")
        for i in range(bank.shape[-1]):
            state[f"bit_estimator_z.f{i + 1}.{name}"] = \
                bank[..., i].reshape(1, -1, 1, 1).clone()
    state["q_basic"] = state["q_basic"].reshape(1, -1, 1, 1)
    torch.save({"state_dict": state}, tmp_path / "evc.pth.tar")
    rc, got = _port_run(inputs, tmp_path / "pth", "evc", "--model_path",
                        str(tmp_path / "evc.pth.tar"))
    rc2, want = _port_run(inputs, tmp_path / "v1", "evc", "--model_path",
                          str(inputs / "evc.bin"))
    assert rc == rc2 == 0 and got["per_image"].keys() == \
        want["per_image"].keys()
    assert _bins(tmp_path / "pth") == _bins(tmp_path / "v1")
    save_reference(str(tmp_path / "noar.pth.tar"), model)
    with pytest.raises(ValueError, match="params.v1 files only"):
        _port_run(inputs, tmp_path / "x", "intra_noar", "--model_path",
                  str(tmp_path / "noar.pth.tar"))


# ----------------------------------------------- PNG sequences, no PIL

H, W, N = 64, 96, 3


def _png_seq(folder):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(2)
    base = gaussian_filter(rng.uniform(0, 255, (H, W, 3)), (4.0, 4.0, 0))
    os.makedirs(folder)
    for i in range(N):
        rgb = np.clip(np.roll(base, i, 1) + rng.normal(0, 2, base.shape),
                      0, 255).astype(np.uint8)
        write_png(os.path.join(folder, f"im{i + 1:05d}.png"), rgb)


def _point(src, out_dir):
    os.makedirs(out_dir)
    bin_path = os.path.join(out_dir, "ld_png.bin")
    return {"rate_idx": 0, "qp_i": 3, "qp_p": 5, "force_intra": False,
            "reset_interval": 2, "seq": "seq", "src_type": "png",
            "src_height": H, "src_width": W, "intra_period": 4,
            "frame_num": N, "calc_ssim": False, "src_path": src,
            "bin_folder": out_dir, "curr_bin_path": bin_path,
            "curr_rec_path": bin_path.replace(".bin", ".yuv"),
            "curr_json_path": bin_path.replace(".bin", ".json"),
            "save_decoded_frame": True, "verbose": 0}


def test_harness_png_sequence_without_pil(tmp_path, monkeypatch):
    pytest.importorskip("PIL")     # the comparison run reads with PIL
    from PIL import Image
    _png_seq(str(tmp_path / "seq"))

    def run(name):
        i_codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                        cfg=TINY_CONFIG, dtype=torch.float32,
                                        device="cpu")
        p_codec = DMCLDCodec.init_random(torch.Generator().manual_seed(1),
                                         cfg=TINY_LD_CONFIG, init_scale=0.5,
                                         dtype=torch.float32, device="cpu")
        args = _point(str(tmp_path / "seq"), str(tmp_path / name))
        res = harness.run_one_point_with_stream(p_codec, i_codec, 1, args)
        with open(args["curr_bin_path"], "rb") as f:
            return res, f.read()

    with monkeypatch.context() as m:
        m.setattr(harness, "PNGReader", video_io.PNGReader)
        m.setattr(harness, "PNGWriter", video_io.PNGWriter)
        want, want_bin = run("pil")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImportError):
            video_io.PNGReader(str(tmp_path / "seq")).read_one_frame()
        got, got_bin = run("no_pil")
    assert len(got_bin) > 50 and got_bin == want_bin

    def numbers(res):
        return {k: v for k, v in res.items() if "time" not in k}
    assert numbers(got) == numbers(want)
    assert np.isfinite(got["ave_all_frame_psnr"])
    names = sorted(f for f in os.listdir(tmp_path / "no_pil")
                   if f.endswith(".png"))
    assert names == [f"im{i:05d}.png" for i in range(1, N + 1)]
    for name in names:
        got_px = np.asarray(Image.open(tmp_path / "no_pil" / name)
                            .convert("RGB"))
        want_px = np.asarray(Image.open(tmp_path / "pil" / name)
                             .convert("RGB"))
        np.testing.assert_array_equal(got_px, want_px)


# ------------------------------------------------- family codecs in f32

@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_family_dtype_is_f32_unless_asked(device):
    assert family.family_dtype(device) is torch.float32
    assert family.family_dtype(device, "f32") is torch.float32
    assert family.family_dtype(device, "bf16") is torch.bfloat16


def test_family_runner_and_cli_build_f32(tmp_path):
    runner = family.FamilyRunner("rt", str(tmp_path / "s"), tiny=True,
                                 device="cpu")
    assert runner.dtype is torch.float32
    assert runner.i_codec.dtype is runner.p_codec.dtype is torch.float32
    assert next(runner.i_codec.model.parameters()).dtype is torch.float32
    base = ["--model", "rt", "--test_config", "c.json"]
    assert family_main.parse_args(base).dtype == "f32"
    assert family_main.parse_args(base + ["--dtype", "bf16"]).dtype == "bf16"
    runner = family.FamilyRunner("rt", str(tmp_path / "b"), tiny=True,
                                 device="cpu", dtype="bf16")
    assert runner.p_codec.dtype is torch.bfloat16
