"""Port parity, the evaluation entry: dcvc_tpu_torch's NAL container,
colour transforms, harness and CLI against dcvc_tpu's, on the CPU.

- NAL: a write / read round trip of SPS, I and P units (every adaptive
  uint width), byte-identical to the JAX writer's.
- Colour: torch ycbcr2rgb within 1e-6 of the JAX one (the numpy
  functions are pinned by source in tests/test_torch_core.py).
- Harness: a seeded 64x96 YUV420 sequence of 6 frames (intra_period 4,
  reset_interval 2: LD codes I P P P P I with resets on frames 2 and 4,
  HTS an I frame and one padded chunk with a reset), coded by the JAX
  harness with the JAX TINY codecs and by the port's with the same
  weights through the bridge, float32: the .bin files byte-identical,
  bits equal, PSNRs within 1e-6 (the same reconstructions, to the
  codecs' 1e-4, rounded to 8 bits; the metrics are numpy in both).  Once
  more for LD on a PNG sequence (RGB metrics through ycbcr2rgb).  The
  P-codecs are damped (init_scale 0.5) with the fusion prior's scale bias
  lifted by 2, as in tests/test_torch_dmc_ld.py, so that y is coded.
- CLI: video_main.main(argv) on the CPU with the TINY models writes the
  nested {class -> seq -> rate} JSON with the JAX CLI's keys;
  --device cuda without a card raises, with --worker 2 before any worker
  starts (tests/test_torch_eval_tools.py holds --worker 2 to --worker 1).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu import bitstream as jnal
from dcvc_tpu.core import color as jcolor
from dcvc_tpu.eval import harness as jharness
from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY_HT
from dcvc_tpu.models.dmc_ld import TINY_LD_CONFIG as JAX_TINY_LD
from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY_I
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxDMCI
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxHT
from dcvc_tpu.runtime.video_codec import DMCLDCodec as JaxLD
from dcvc_tpu_torch import bitstream as nal
from dcvc_tpu_torch.core import color
from dcvc_tpu_torch.eval import harness, video_main
from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG
from dcvc_tpu_torch.models.dmc_ld import TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec, DMCLDCodec
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax, \
    dmc_ld_params_from_jax, dmci_params_from_jax

H, W, N = 64, 96, 6
SEQ = f"synth_{W}x{H}_30.yuv"
PSNR_ATOL = 1e-6


# ------------------------------------------------------------------- NAL

def _units(mod):
    """SPS + I + P units of every adaptive-uint width, written by `mod`."""
    buf = io.BytesIO()
    sizes = [mod.write_sps(buf, {"sps_id": 3, "height": 1080,
                                 "width": 1920})]
    rng = np.random.default_rng(0)
    for n, is_i, reset in ((5, True, 0), (200, False, 1), (20000, False, 0)):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        sizes.append(mod.write_ip(buf, is_i, 3, 17, 5, reset, payload))
    return buf.getvalue(), sizes


def test_nal_round_trip_matches_jax():
    data, sizes = _units(nal)
    assert (data, sizes) == _units(jnal)
    f = io.BytesIO(data)
    helper = nal.SPSHelper()
    header = nal.read_header(f)
    assert header["nal_type"] == nal.NalType.NAL_SPS
    helper.add_sps_by_id(nal.read_sps_remaining(f, header["sps_id"]))
    assert helper.get_sps_by_id(3)["height"] == 1080
    rng = np.random.default_rng(0)
    for n, is_i, reset in ((5, True, 0), (200, False, 1), (20000, False, 0)):
        header = nal.read_header(f)
        assert header["nal_type"] == (nal.NalType.NAL_I if is_i
                                      else nal.NalType.NAL_P)
        assert header["sps_id"] == 3
        qp, ec, rs, payload = nal.read_ip_remaining(f)
        assert (qp, ec, rs) == (17, 5, reset)
        assert payload == rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert f.read() == b""


def test_ycbcr2rgb_matches_jax():
    x = np.random.default_rng(1).uniform(-0.1, 1.1, (5, 7, 3)).astype(
        np.float32)
    for clamp in (True, False):
        got = color.ycbcr2rgb(torch.from_numpy(x), clamp)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcolor.ycbcr2rgb(jnp.asarray(x), clamp)),
            rtol=0, atol=1e-6)


# -------------------------------------------------------------- sequences

def _write_yuv(folder):
    """The seeded YUV420 sequence of tests/test_harness.py at 64x96."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(0)
    base_y = gaussian_filter(rng.uniform(0, 255, (H, W)), 4.0)
    base_uv = gaussian_filter(rng.uniform(0, 255, (2, H // 2, W // 2)), 2.0)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, SEQ), "wb") as f:
        for i in range(N):
            y = np.clip(np.roll(base_y, i, 1) + rng.normal(0, 2, (H, W)),
                        0, 255).astype(np.uint8)
            uv = np.clip(base_uv + rng.normal(0, 2, base_uv.shape),
                         0, 255).astype(np.uint8)
            f.write(y.tobytes())
            f.write(uv.tobytes())


def _write_png(folder):
    from PIL import Image
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (H, W, 3)), (4.0, 4.0, 0))
    os.makedirs(folder, exist_ok=True)
    for i in range(N):
        rgb = np.clip(np.roll(base, i, 1) + rng.normal(0, 2, base.shape),
                      0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(folder, f"im{i + 1:05d}.png"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaldata")
    _write_yuv(str(root / "TestClass"))
    _write_png(str(root / "png_seq"))
    return root


def _point(src_type, src_path, out_dir, structure, verbose=0):
    os.makedirs(out_dir, exist_ok=True)
    bin_path = os.path.join(out_dir, f"{structure}_{src_type}.bin")
    return {"rate_idx": 0, "qp_i": 3, "qp_p": 5, "force_intra": False,
            "reset_interval": 2, "seq": SEQ, "src_type": src_type,
            "src_height": H, "src_width": W, "intra_period": 4,
            "frame_num": N, "calc_ssim": False, "src_path": src_path,
            "bin_folder": out_dir, "curr_bin_path": bin_path,
            "curr_rec_path": bin_path.replace(".bin", ".yuv"),
            "curr_json_path": bin_path.replace(".bin", ".json"),
            "save_decoded_frame": False, "verbose": verbose}


# ---------------------------------------------------------------- codecs

def _lift(params, fusion, cy):
    """The fusion prior's scale bias lifted by 2 (y symbols coded)."""
    params = jax.tree.map(np.array, params)
    params["y_prior_fusion"][fusion]["conv"]["bias"][cy:2 * cy] += 2.0
    return params


@pytest.fixture(scope="module")
def codecs():
    """{name: (jax codec, port codec)} on the same weights, float32."""
    ji = JaxDMCI.init_random(jax.random.PRNGKey(0), cfg=JAX_TINY_I,
                             dtype=jnp.float32)
    out = {"i": (ji, DMCICodec(dmci_params_from_jax(ji.params),
                               cfg=TINY_CONFIG, dtype=torch.float32,
                               device="cpu"))}
    init = JaxLD.init_random(jax.random.PRNGKey(1), cfg=JAX_TINY_LD,
                             dtype=jnp.float32, init_scale=0.5)
    jld = JaxLD(init.model, _lift(init.params, "layers_3", JAX_TINY_LD.ch_y))
    out["ld"] = (jld, DMCLDCodec(dmc_ld_params_from_jax(jld.params),
                                 cfg=TINY_LD_CONFIG, dtype=torch.float32,
                                 device="cpu"))
    init = JaxHT.init_random(jax.random.PRNGKey(1), cfg=JAX_TINY_HT,
                             dtype=jnp.float32, init_scale=0.5)
    jht = JaxHT(init.model, _lift(init.params, "conv_3", JAX_TINY_HT.ch_y))
    out["hts"] = (jht, DMCHTCodec(dmc_ht_params_from_jax(jht.params),
                                  cfg=TINY_HT_CONFIG, dtype=torch.float32,
                                  device="cpu"))
    return out


def _run_both(codecs, data, tmp_path, structure, src_type, verbose=0):
    src = (str(data / "TestClass" / SEQ) if src_type == "yuv420"
           else str(data / "png_seq"))
    (ji, ti), (jp, tp) = codecs["i"], codecs[structure]
    fd = jp.cfg.frame_delay
    jargs = _point(src_type, src, str(tmp_path / "jax"), structure, verbose)
    targs = _point(src_type, src, str(tmp_path / "port"), structure,
                   verbose)
    jres = jharness.run_one_point_with_stream(jp, ji, fd, jargs)
    tres = harness.run_one_point_with_stream(tp, ti, fd, targs)
    with open(jargs["curr_bin_path"], "rb") as f:
        jbin = f.read()
    with open(targs["curr_bin_path"], "rb") as f:
        tbin = f.read()
    return jres, tres, jbin, tbin


@pytest.mark.parametrize("structure,src_type", [
    ("ld", "yuv420"), ("hts", "yuv420"), ("ld", "png")])
def test_harness_bin_identical_to_jax(codecs, data, tmp_path, structure,
                                      src_type):
    jres, tres, jbin, tbin = _run_both(codecs, data, tmp_path, structure,
                                       src_type)
    assert len(tbin) > 200
    assert tbin == jbin
    assert set(tres) == set(jres)
    for k, v in jres.items():
        if k in ("test_time", "avg_encoding_time", "avg_decoding_time"):
            continue
        if "psnr" in k or "msssim" in k:
            np.testing.assert_allclose(tres[k], v, rtol=0, atol=PSNR_ATOL,
                                       err_msg=k)
        else:
            assert tres[k] == v, k
    assert tres["i_frame_num"] == (2 if structure == "ld" else 1)
    assert tres["p_frame_num"] == N - tres["i_frame_num"]
    assert np.isfinite(tres["ave_all_frame_psnr"])
    if src_type == "yuv420":
        assert "ave_all_frame_psnr_y" in tres


# ------------------------------------------------------------------- CLI

def _config(data, tmp_path):
    cfg = {"root_path": str(data), "test_classes": {"TestClass": {
        "test": 1, "base_path": "TestClass", "src_type": "yuv420",
        "sequences": {SEQ: {"width": W, "height": H, "frames": N,
                            "intra_period": 4}}}}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _argv(data, tmp_path, *extra):
    return ["--test_config", _config(data, tmp_path),
            "--output_path", str(tmp_path / "out" / "result.json"),
            "--stream_path", str(tmp_path / "bin"),
            "--rate_num", "2", "--qp_i", "1", "5", "--qp_p", "1", "5",
            "--tiny_model", "1", "--device", "cpu", *extra]


def test_cli_writes_the_jax_schema(codecs, data, tmp_path):
    got = video_main.main(_argv(data, tmp_path, "--model_structure", "ld",
                                "--verbose", "1"))
    with open(tmp_path / "out" / "result.json") as f:
        written = json.load(f)
    assert list(written) == ["TestClass"]
    assert list(written["TestClass"]) == [SEQ]
    rates = written["TestClass"][SEQ]
    assert list(rates) == ["000", "001"]
    # a point's keys: the JAX harness's result, plus the CLI's three
    jres, _, _, _ = _run_both(codecs, data, tmp_path, "ld", "yuv420", 1)
    want = set(jres) | {"ds_name", "seq", "rate_idx"}
    for idx, rate in rates.items():
        assert set(rate) == want
        assert rate["rate_idx"] == int(idx) and rate["seq"] == SEQ
        assert rate["i_frame_num"] == 2 and rate["p_frame_num"] == N - 2
        assert rate["ave_all_frame_bpp"] > 0
        assert 0 < rate["ave_all_frame_psnr"] <= 99.9
        # with verbose 1, the two frames after the warm-up are timed
        assert rate["avg_frame_encoding_time"] > 0
    # main() returns what it writes, before dump_json's rounding to 6
    assert round(got["TestClass"][SEQ]["001"]["ave_all_frame_bpp"], 6) == \
        rates["001"]["ave_all_frame_bpp"]
    bins = sorted(os.listdir(tmp_path / "bin" / "TestClass"))
    assert [b for b in bins if b.endswith(".bin")] == \
        [f"{SEQ}_q1.bin", f"{SEQ}_q5.bin"]


def test_cli_refuses_workers_and_a_missing_card(data, tmp_path):
    argv = _argv(data, tmp_path)[:-2]
    args = video_main.parse_args(argv)
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            video_main.build_codecs(args)
        # a worker pool on a missing card is refused before it spawns
        with pytest.raises(RuntimeError, match="no CUDA device"):
            video_main.main(argv + ["--worker", "2"])
