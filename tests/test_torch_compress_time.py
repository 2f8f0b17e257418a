"""The port's speed wrapper, dcvc_tpu_torch/eval/compress_time.py,
against the JAX repo's test_compress_time.py, on the CPU.

- Its entry command has test_compress_time.py's flags (its os.system
  line captured), run as `python3 -m dcvc_tpu_torch.eval.video_main`,
  with --device and --stream_path after them.
- On the same result JSON both print the same two lines.
- On a seeded 6-frame 64x64 HEVC_B sequence (write_sequence) a TINY LD
  run of the port's entry in its own process, on the CPU, gives the
  averages over its 4 rates; a 3-frame sequence (no unit past the 4
  warm-up ones) fails with a message that says so.
"""

import torch_threads  # (first: caps torch's threads)

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dcvc_tpu_torch.eval import compress_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ct():
    spec = importlib.util.spec_from_file_location(
        "jax_test_compress_time", os.path.join(REPO, "test_compress_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARGVS = [[], ["--img", "--tiny_model"],
         ["--model_structure", "ld", "--force_root_path", "/d",
          "--model_path_i", "i.bin", "--model_path_p", "p.bin",
          "--output_path", "o.json", "--test_config", "c.json"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_command_is_the_scripts(jax_ct, monkeypatch, capsys, argv):
    seen = []
    monkeypatch.setattr(jax_ct.os, "system",
                        lambda line: seen.append(line) or 1)
    with pytest.raises(SystemExit):
        jax_ct.main(argv)
    want = seen[0].split()
    assert want[:2] == ["python", "test_video.py"]
    got = compress_time.command(compress_time.parse_args(
        argv + ["--device", "cpu", "--stream_path", "bins"]))
    assert got[:3] == [sys.executable, "-m",
                       "dcvc_tpu_torch.eval.video_main"]
    assert got[3:] == want[2:] + ["--device", "cpu", "--stream_path",
                                  "bins"]


def _result(times):
    return {compress_time.DATASET: {"seq.yuv": {
        f"{i:03d}": {"avg_frame_encoding_time": e,
                     "avg_frame_decoding_time": d,
                     "i_frame_num": 1, "p_frame_num": 9}
        for i, (e, d) in enumerate(times)}}}


@pytest.mark.parametrize("structure", ["hts", "ld"])
def test_prints_the_scripts_lines(jax_ct, monkeypatch, capsys, tmp_path,
                                  structure):
    out = str(tmp_path / "out.json")
    with open(out, "w") as f:
        json.dump(_result([(0.0123, 0.0219), (0.0151, 0.0178)]), f)
    argv = ["--model_structure", structure, "--output_path", out]
    monkeypatch.setattr(jax_ct.os, "system", lambda line: 0)
    jax_ct.main(argv)
    want = capsys.readouterr().out.splitlines()[-2:]
    monkeypatch.setattr(compress_time.subprocess, "run",
                        lambda cmd, env: subprocess.CompletedProcess(cmd, 0))
    avg = compress_time.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-2:] == want
    assert avg == pytest.approx((0.0137, 0.01985))


def test_no_average_fails_clearly(monkeypatch, tmp_path):
    out = str(tmp_path / "out.json")
    res = _result([(0.01, 0.02)])
    del res[compress_time.DATASET]["seq.yuv"]["000"][
        "avg_frame_encoding_time"]
    with open(out, "w") as f:
        json.dump(res, f)
    monkeypatch.setattr(compress_time.subprocess, "run",
                        lambda cmd, env: subprocess.CompletedProcess(cmd, 0))
    with pytest.raises(SystemExit, match="warm-up units"):
        compress_time.main(["--output_path", out, "--device", "cpu"])


def test_write_sequence(tmp_path):
    cfg = compress_time.write_sequence(str(tmp_path), 32, 48, 3, seed=2)
    with open(cfg) as f:
        c = json.load(f)
    seqs = c["test_classes"]["HEVC_B"]["sequences"]
    (name, s), = seqs.items()
    assert s == {"width": 48, "height": 32, "frames": 3, "intra_period": -1}
    raw = np.fromfile(os.path.join(c["root_path"], "HEVC_B", name), np.uint8)
    assert raw.size == 3 * 32 * 48 * 3 // 2
    again = compress_time.write_sequence(str(tmp_path / "b"), 32, 48, 3,
                                         seed=2)
    with open(again) as f:
        name_b = list(json.load(f)["test_classes"]["HEVC_B"]["sequences"])
    assert np.array_equal(raw, np.fromfile(
        os.path.join(str(tmp_path / "b"), "HEVC_B", name_b[0]), np.uint8))


def _run(tmp_path, monkeypatch, frames):
    # the entry's process takes this worker's share of the cores
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch_threads.share_of_cores()))
    cfg = compress_time.write_sequence(str(tmp_path / "data"), 64, 64,
                                       frames)
    return compress_time.main([
        "--model_structure", "ld", "--tiny_model", "--device", "cpu",
        "--test_config", cfg, "--output_path", str(tmp_path / "out.json"),
        "--stream_path", str(tmp_path / "bins")])


def test_tiny_ld_gives_the_averages(tmp_path, monkeypatch, capsys):
    avg_enc, avg_dec = _run(tmp_path, monkeypatch, 6)
    assert avg_enc > 0 and avg_dec > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("Average encoding time on HEVC_B = ")
    assert lines[-1].startswith("Average decoding time on HEVC_B = ")
    with open(tmp_path / "out.json") as f:
        rates = json.load(f)["HEVC_B"]["synth_64x64_60.yuv"]
    assert len(rates) == 4
    assert all(r["avg_frame_encoding_time"] > 0 for r in rates.values())


def test_too_short_a_sequence_fails_clearly(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="needs more than 4 units"):
        _run(tmp_path, monkeypatch, 3)
