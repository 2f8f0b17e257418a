"""The port's BD-rate toolchain against the JAX package's, on the CPU.

- bd_metric: dcvc_tpu_torch/utils/bd_metric.py is a byte-for-byte copy
  of dcvc_tpu/utils/bd_metric.py, and tests/test_bd_rate.py's cases pass
  against it.
- compare_bd_rate: the port's main and compare_bd_rate.py's write the
  same JSON file, byte for byte, on the vendored VTM-17.0 anchor and a
  result file derived from it (rates x 0.9, PSNRs + 0.1 dB), per class,
  all frame types and one, two distortion metrics; per sequence, the
  JSON of compare_bd_rate.py on the files split into one class per
  sequence (its own sequence mode fails on a result file);
  --plot_path draws a PNG per class and raises without matplotlib.
- data/synth.py's scene and shift_frame are verbatim copies of
  scripts/make_synth_data.py's; the gate's stand-in sequence is
  run_bd_gate.py's, byte for byte.
- bd_gate: on a 64x96, 9-frame sequence, with the port's seeded TINY
  DMCI and HTS (the scale biases lifted as in
  tests/test_torch_params_v1.py) as dcvc_tpu.params.v1 files, the port's
  gate gives the RD points of run_bd_gate.py's pipeline on the same
  files (the JAX harness with the JAX codecs in float32, skip 0, at the
  same 4 QPs): bpp equal, PSNRs within 1e-4 dB (see PSNR_ATOL); the
  BD-rates vs the anchor within 1e-4 relative; the artifact strict
  JSON.  It refuses the JAX package's artifacts/BD_RATE_GATE.json, which
  stays unchanged.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import hashlib
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import compare_bd_rate as jax_compare
import run_bd_gate as jax_gate
from dcvc_tpu.eval import harness as jharness
from dcvc_tpu.models.dmc_ht import DMCHT as JaxDMCHT
from dcvc_tpu.models.dmc_ht import DMCHTConfig as JaxHTConfig
from dcvc_tpu.models.dmci import DMCIConfig as JaxDMCIConfig
from dcvc_tpu.runtime.image_codec import DMCICodec as JaxDMCI
from dcvc_tpu.runtime.video_codec import DMCHTCodec as JaxHT
from dcvc_tpu.utils.checkpoint import load_params as jax_load_params
from dcvc_tpu.utils.logjson import dump_json
from dcvc_tpu_torch.data import synth
from dcvc_tpu_torch.eval import bd_gate, compare_bd_rate, video_main
from dcvc_tpu_torch.utils import bd_metric
from dcvc_tpu_torch.utils.jax_bridge import save_native
from test_torch_params_v1 import _port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "test_cfg", "anchors",
                      "vtm_17.0_yuv420_LB_allf_ip0.json")
GATE_H, GATE_W, GATE_FRAMES = 64, 96, 9
# PSNR of a point: the two codecs' float reconstructions agree to ~1e-4
# and are rounded to 8 bits, where a value next to a rounding edge can
# land one level apart (~1e-5 dB per pixel of a 64x96 frame; one such
# pixel at qp 0 here); the bits are equal
PSNR_ATOL = 1e-4


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_bd_metric_is_pinned():
    assert _read(os.path.join(REPO, "dcvc_tpu_torch", "utils",
                              "bd_metric.py")) == \
        _read(os.path.join(REPO, "dcvc_tpu", "utils", "bd_metric.py"))


def test_bd_metric_cases():
    """tests/test_bd_rate.py::TestBDMetric's four cases."""
    bd_rate, bd_psnr = bd_metric.bd_rate, bd_metric.bd_psnr
    rate = [0.1, 0.2, 0.4, 0.8]
    psnr = [30, 33, 36, 39]
    assert abs(bd_rate(rate, psnr, rate, psnr)) < 1e-9
    assert abs(bd_psnr(rate, psnr, rate, psnr)) < 1e-9
    np.testing.assert_allclose(
        bd_rate(np.array(rate), psnr, np.array(rate) / 2, psnr), -50.0,
        atol=1e-6)
    psnr_a = np.array([30.0, 33, 36, 39])
    np.testing.assert_allclose(bd_psnr(rate, psnr_a, rate, psnr_a + 1.0),
                               1.0, atol=1e-6)
    assert bd_rate(rate, [30.0, 33, 36, 39], rate, [31.0, 34, 37, 40]) < -5


def test_synth_is_pinned():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_synth_data
    finally:
        sys.path.pop(0)
    for name in ("scene", "shift_frame"):
        assert inspect.getsource(getattr(synth, name)) == \
            inspect.getsource(getattr(make_synth_data, name)), name


# ------------------------------------------------------- compare_bd_rate

@pytest.fixture(scope="module")
def result_files(tmp_path_factory):
    """The anchor and a result derived from it (every bpp x 0.9, every
    PSNR + 0.1 dB)."""
    root = tmp_path_factory.mktemp("bd")
    with open(ANCHOR) as f:
        ours = json.load(f)
    for seqs in ours.values():
        for rates in seqs.values():
            for point in rates.values():
                for k in list(point):
                    if k.endswith("_bpp"):
                        point[k] *= 0.9
                    elif "_psnr" in k:
                        point[k] += 0.1
    path = str(root / "ours.json")
    with open(path, "w") as f:
        json.dump(ours, f)
    return path


@pytest.mark.parametrize("extra", [
    [],
    ["--compare_frame_type", "all"],
    ["--distortion_metrics", "psnr", "msssim", "--allow_extrapolation"],
])
def test_compare_bd_rate_writes_the_jax_json(result_files, tmp_path, extra):
    def argv(out):
        return ["--base_method", "VTM", "--log_paths", "VTM", ANCHOR,
                "ours", result_files, "--output_path", out, *extra]
    got = compare_bd_rate.main(argv(str(tmp_path / "port.json")))
    jax_compare.main(argv(str(tmp_path / "jax.json")))
    assert _read(tmp_path / "port.json") == _read(tmp_path / "jax.json")
    assert got["psnr"]["all"]["ours"]
    values = [v for ft in got["psnr"].values() for v in ft["ours"].values()]
    assert all(np.isfinite(v) and v < 0 for v in values)


def test_compare_bd_rate_per_sequence(result_files, tmp_path):
    """--compare_between sequence: each sequence's BD-rate is
    compare_bd_rate.py's on files whose classes hold one sequence each
    (its own sequence mode raises TypeError on a result file)."""
    split = {}
    for name, path in (("VTM", ANCHOR), ("ours", result_files)):
        with open(path) as f:
            classes = json.load(f)
        split[name] = str(tmp_path / f"{name}.json")
        with open(split[name], "w") as f:
            json.dump({seq: {seq: rates} for seqs in classes.values()
                       for seq, rates in seqs.items()}, f)
    got = compare_bd_rate.main(
        ["--base_method", "VTM", "--log_paths", "VTM", ANCHOR, "ours",
         result_files, "--compare_between", "sequence"])
    jax_compare.main(["--base_method", "VTM", "--log_paths", "VTM",
                      split["VTM"], "ours", split["ours"], "--output_path",
                      str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert got == want
    assert len(got["psnr"]["all"]["ours"]) > 10


def test_compare_bd_rate_plots(result_files, tmp_path, monkeypatch):
    argv = ["--base_method", "VTM", "--log_paths", "VTM", ANCHOR, "ours",
            result_files, "--compare_frame_type", "all",
            "--plot_path", str(tmp_path / "plots")]
    compare_bd_rate.main(argv)
    assert "rd_psnr_all_UVG.png" in os.listdir(tmp_path / "plots")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        compare_bd_rate.main(argv[:-1] + [str(tmp_path / "none")])


# --------------------------------------------------------------- bd_gate

@pytest.fixture(scope="module")
def gate_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    paths = (str(root / "i.bin"), str(root / "p.bin"))
    save_native(_port_model("dmci"), paths[0])
    save_native(_port_model("hts"), paths[1])
    return paths


def test_gate_sequence_is_run_bd_gates(tmp_path):
    jax_cfg = jax_gate.make_sequence(str(tmp_path / "jax"), GATE_H, GATE_W,
                                     GATE_FRAMES)
    cfg = bd_gate.make_sequence(str(tmp_path / "port"), GATE_H, GATE_W,
                                GATE_FRAMES)
    seq = os.path.join("UVG", bd_gate.SEQ)
    assert _read(tmp_path / "port" / seq) == _read(tmp_path / "jax" / seq)
    with open(jax_cfg) as f, open(cfg) as g:
        want, got = json.load(f), json.load(g)
    assert got["test_classes"] == want["test_classes"]


def _jax_pipeline(files, root):
    """run_bd_gate.py's flow on the JAX package at float32 (test_video.py
    runs bfloat16): its sequence, 4 points of the JAX harness with the
    JAX codecs on the same files, compare_bd_rate.py.  Returns (points
    as the artifact keeps them, BD JSON)."""
    cfg_path = jax_gate.make_sequence(root, GATE_H, GATE_W, GATE_FRAMES)
    i_params, i_hdr = jax_load_params(files[0])
    p_params, p_hdr = jax_load_params(files[1])
    i_codec = JaxDMCI(i_params, cfg=JaxDMCIConfig(**i_hdr["config"]),
                      dtype=jnp.float32)
    p_cfg = JaxHTConfig(**p_hdr["config"])
    p_codec = JaxHT(JaxDMCHT(cfg=p_cfg, dtype=jnp.float32), p_params)
    qp_num = i_hdr["config"]["qp_num"]
    qps = [str(int(round(q))) for q in np.linspace(0, qp_num - 1, 4)]
    args = video_main.parse_args([
        "--test_config", cfg_path, "--output_path", "unused",
        "--stream_path", os.path.join(root, "bin"), "--rate_num", "4",
        "--qp_i", *qps, "--qp_p", *qps])
    points = video_main.build_points(args, qp_num)[0]
    results = {f"{p['rate_idx']:03d}": jharness.run_one_point_with_stream(
        p_codec, i_codec, p_cfg.frame_delay, p) for p in points}
    result_json = os.path.join(root, "result.json")
    with open(result_json, "w") as f:      # as test_video.py writes it
        dump_json({"UVG": {jax_gate.SEQ: results}}, f, float_digits=6,
                  indent=2)
    with open(result_json) as f:
        results = json.load(f)["UVG"][jax_gate.SEQ]
    jax_compare.main(["--base_method", "VTM-17.0", "--log_paths",
                      "VTM-17.0", ANCHOR, "dcvc_tpu_hts", result_json,
                      "--compare_frame_type", "all", "--output_path",
                      os.path.join(root, "bd.json"),
                      "--allow_extrapolation"])
    with open(os.path.join(root, "bd.json")) as f:
        bd = json.load(f)
    pts = {rp: (v["ave_all_frame_bpp"], v["ave_all_frame_psnr"],
                v["ave_i_frame_bpp"], v["ave_p_frame_bpp"])
           for rp, v in results.items()}
    return pts, bd


def _strict(path):
    def refuse(token):
        raise ValueError(f"non-strict JSON token {token}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def test_gate_matches_the_jax_pipeline(gate_files, tmp_path):
    jax_artifact = os.path.join(REPO, "artifacts", "BD_RATE_GATE.json")
    before = hashlib.sha256(_read(jax_artifact)).hexdigest()
    out = str(tmp_path / "gate.json")
    argv = ["--model_path_i", gate_files[0], "--model_path_p",
            gate_files[1], "--device", "cpu", "--frames", str(GATE_FRAMES),
            "--height", str(GATE_H), "--width", str(GATE_W),
            "--allow_extrapolation"]
    with pytest.raises(ValueError, match="JAX package"):
        bd_gate.main(argv + ["--output_path", jax_artifact])
    rc = bd_gate.main(argv + ["--output_path", out])
    artifact = _strict(out)
    want, want_bd = _jax_pipeline(gate_files, str(tmp_path / "jax"))

    assert artifact["trained_weights"] and artifact["extrapolated"]
    assert rc == (0 if artifact["rd_monotone"] else 1)
    assert sorted(artifact["rd_points"]) == sorted(want) == \
        ["000", "001", "002", "003"]
    for rp, (bpp, psnr, i_bpp, p_bpp) in want.items():
        got = artifact["rd_points"][rp]
        assert (got["bpp"], got["i_bpp"], got["p_bpp"]) == \
            (bpp, i_bpp, p_bpp), rp
        np.testing.assert_allclose(got["psnr"], psnr, rtol=0,
                                   atol=PSNR_ATOL)
        assert np.isfinite(got["psnr"]) and got["bpp"] > 0
    got_bd = artifact["bd_rate_pct_vs_vtm17"]["psnr"]["all"]
    want_bd = want_bd["psnr"]["all"]
    assert list(got_bd) == list(want_bd) == ["dcvc_tpu_hts"]
    np.testing.assert_allclose(got_bd["dcvc_tpu_hts"]["UVG"],
                               want_bd["dcvc_tpu_hts"]["UVG"], rtol=1e-4)
    assert hashlib.sha256(_read(jax_artifact)).hexdigest() == before
