"""The port's stream-portability harness, dcvc_tpu_torch/eval/
cross_platform.py, against the JAX repo's scripts/
cross_platform_conformance.py, on the CPU at TINY configs (float32).

- encode + decode CPU -> CPU report every symbol sequence identical and
  every reconstruction bit-exact.
- The JAX script's own cmd_encode / cmd_decode, driving the port's codecs
  (its _build_codecs patched to them, its QPs and image at the TINY
  sizes), write the port's npz (the same keys, arrays equal) and the
  port's report (the same fields and values).
- `run` drives each direction in processes of its own (CPU only here),
  records a cross-platform stream that does not decode as a finding,
  fails when a same-platform leg is not identical, and never writes over
  the JAX harness's artifact.
"""

import torch_threads  # (first: caps torch's threads)

import argparse
import importlib.util
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.eval import cross_platform as xp
from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG
from dcvc_tpu_torch.models.dmci import TINY_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(cmd, d, **kw):
    return argparse.Namespace(cmd=cmd, dir=str(d), tiny=True, **kw)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("xplat_port")
    xp.cmd_encode(_args("encode", d, platform="cpu"))
    rep = str(d / "report.json")
    xp.cmd_decode(_args("decode", d, platform="cpu", src="cpu",
                        report=rep))
    with open(rep) as f:
        return d, json.load(f)


def test_cpu_to_cpu_identical(port_run):
    d, report = port_run
    assert report["encode_platform"] == report["decode_platform"] == "cpu"
    assert [e["qp"] for e in report["image"]] == xp.TINY_QPS
    assert len(report["video"]) == 2
    assert xp.identical(report)
    assert all(e["recon_psnr_vs_encoder"] == 99.0
               for e in report["image"] + report["video"])
    enc = np.load(os.path.join(d, "enc_cpu.npz"))
    # the case codes y symbols
    assert sum(enc[f"imgsym_{i}_y{k}"].size for i in range(3)
               for k in range(4)) > 0


def test_npz_and_report_are_the_scripts(port_run, tmp_path, monkeypatch):
    d, report = port_run
    spec = importlib.util.spec_from_file_location(
        "jax_xplat", os.path.join(REPO, "scripts",
                                  "cross_platform_conformance.py"))
    jx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jx)
    # the JAX script's protocol, on the port's codecs at TINY
    monkeypatch.setattr(jx, "_setup", lambda platform: None)
    monkeypatch.setattr(jx, "_build_codecs", lambda _, dd: xp._build_codecs(
        torch.device("cpu"), dd, (TINY_CONFIG, TINY_HT_CONFIG)))
    monkeypatch.setattr(jx, "QPS", xp.TINY_QPS)
    monkeypatch.setattr(jx, "_image", lambda: xp._image(*xp.TINY_IMAGE_HW))
    for name in ("params_i.bin", "params_p.bin"):
        shutil.copy(os.path.join(d, name), tmp_path / name)
    jx.cmd_encode(argparse.Namespace(platform="cpu", dir=str(tmp_path)))
    rep = str(tmp_path / "report.json")
    jx.cmd_decode(argparse.Namespace(platform="cpu", src="cpu",
                                     dir=str(tmp_path), report=rep))
    want = np.load(tmp_path / "enc_cpu.npz")
    got = np.load(os.path.join(d, "enc_cpu.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(rep) as f:
        assert json.load(f) == report


def test_run_cpu_in_processes(tmp_path, monkeypatch):
    # each process takes this worker's share of the cores
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch_threads.share_of_cores()))
    art = xp.main(["run", "--dir", str(tmp_path), "--platforms", "cpu",
                   "--tiny"])
    assert list(art["results"]) == ["cpu_encode_cpu_decode"]
    assert art["same_platform_identical"] == {"cpu": True}
    assert art["f32_highest_precision"] is True
    with open(tmp_path / "CROSS_PLATFORM.json") as f:
        assert json.load(f) == art


def _fake_runs(same_ok=True):
    """A subprocess.run for cmd_run: encodes succeed; a cuda -> cpu decode
    exits 1 (a stream that does not decode), cpu -> cuda reports a
    symbol that differs, the same-platform legs report `same_ok`."""
    def run(cmd, env):
        args = cmd[3:]
        if args[0] == "decode":
            dst, src = args[2], args[4]
            if (src, dst) == ("cuda", "cpu"):
                return subprocess.CompletedProcess(cmd, 1)
            ok = same_ok if src == dst else False
            rep = {"encode_platform": src, "decode_platform": dst,
                   "image": [{"qp": 2, "symbols_identical": ok,
                              "recon_psnr_vs_encoder": 99.0,
                              "recon_bitexact": True}],
                   "video": [{"chunk": 0, "recon_psnr_vs_encoder": 99.0,
                              "recon_bitexact": True}]}
            with open(args[args.index("--report") + 1], "w") as f:
                json.dump(rep, f)
        return subprocess.CompletedProcess(cmd, 0)
    return run


def test_run_records_cross_platform_failures(tmp_path, monkeypatch):
    monkeypatch.setattr(xp.subprocess, "run", _fake_runs())
    out = str(tmp_path / "art.json")
    art = xp.main(["run", "--dir", str(tmp_path), "--artifact", out])
    assert art["same_platform_identical"] == {"cuda": True, "cpu": True}
    res = art["results"]
    assert sorted(res) == sorted(f"{s}_encode_{d}_decode"
                                 for s in xp.PLATFORMS for d in xp.PLATFORMS)
    assert res["cuda_encode_cpu_decode"]["error"] == \
        "decode exited with code 1"
    assert not res["cpu_encode_cuda_decode"]["image"][0][
        "symbols_identical"]


def test_run_fails_on_a_same_platform_difference(tmp_path, monkeypatch):
    monkeypatch.setattr(xp.subprocess, "run", _fake_runs(same_ok=False))
    with pytest.raises(SystemExit, match="same-platform"):
        xp.main(["run", "--dir", str(tmp_path)])
    with open(tmp_path / "CROSS_PLATFORM.json") as f:
        assert json.load(f)["same_platform_identical"] == {
            "cuda": False, "cpu": False}


def test_run_never_writes_the_jax_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(xp.subprocess, "run", _fake_runs())
    with pytest.raises(SystemExit, match="refusing"):
        xp.main(["run", "--dir", str(tmp_path), "--artifact",
                 os.path.join(REPO, "artifacts", "CROSS_PLATFORM_r05.json")])
