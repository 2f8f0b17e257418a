"""The port's benchmark, dcvc_tpu_torch/bench.py, against the JAX repo's
bench.py, on the CPU at TINY_HT_CONFIG (float32).

- The frames: make_chunks gives the arrays of bench.py:45-59 (those
  statements of bench.py's main, executed as they stand with numpy in
  jnp's place) at a small (h, w).
- The protocol constants, the metric name and the DCVC-RT baseline are
  bench.py's.
- The core at TINY prints a last line of exactly bench.py's four keys,
  value and vs_baseline from the FPS of a stepping fake clock; a decoder whose final DPB is perturbed prints value 0.0
  with "error": "round-trip mismatch" and returns 1.
- On a machine without a card, --device cuda raises (no CPU fallback).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import ast
import json
import os
import types

import numpy as np
import pytest
import torch

from dcvc_tpu_torch import bench
from dcvc_tpu_torch.models.dmc_ht import TINY_HT_CONFIG
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")


def _bench_main():
    with open(BENCH_PY) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_chunks(h, w, n_chunks, frame_delay):
    """bench.py's frame statements (from `rng = ...` through the chunk
    loop) run as they stand, numpy standing in for jnp."""
    body = _bench_main().body
    first = next(i for i, s in enumerate(body)
                 if isinstance(s, ast.Assign)
                 and isinstance(s.targets[0], ast.Name)
                 and s.targets[0].id == "rng")
    last = next(i for i, s in enumerate(body)
                if isinstance(s, ast.For) and s.target.id == "ci")
    code = compile(ast.Module(body=body[first:last + 1], type_ignores=[]),
                   BENCH_PY, "exec")
    ns = {"np": np, "h": h, "w": w, "n_chunks": n_chunks,
          "frame_delay": frame_delay,
          "jnp": types.SimpleNamespace(asarray=np.asarray)}
    exec(code, ns)
    return ns["chunks"]


@pytest.mark.parametrize("h,w,n_chunks", [(24, 40, 3), (17, 9, 1)])
def test_chunks_are_bench_py_frames(h, w, n_chunks):
    want = _jax_chunks(h, w, n_chunks, 8)
    got = bench.make_chunks(h, w, n_chunks)
    assert len(got) == len(want) == n_chunks
    for g, x in zip(got, want):
        assert g.shape == (1, h, w, 24) and g.dtype == np.float32
        np.testing.assert_array_equal(g, x)


def test_protocol_and_baseline_are_bench_py():
    with open(BENCH_PY) as f:
        src = f.read()
    assert f'"metric": "{bench.METRIC}"' in src
    assert "baseline = 1.0 / (1.0 / 125.2 + 1.0 / 112.8)" in src
    assert bench.BASELINE_FPS == 1.0 / (1.0 / 125.2 + 1.0 / 112.8)
    for line in ("h, w = 1080, 1920", f"qp = {bench.QP}",
                 "warmup, iters = 2, 4", "frame_delay = 8",
                 "n_chunks = 6", "dtype=jnp.bfloat16, skip_thres=0.15",
                 "init_scale=0.5"):
        assert line in src, line
    import inspect
    sig = inspect.signature(bench.run_bench).parameters
    assert (sig["h"].default, sig["w"].default, sig["n_chunks"].default,
            sig["warmup"].default, sig["iters"].default) == \
        (1080, 1920, 6, 2, 4)


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_tiny_run_prints_the_json_line(capsys, monkeypatch):
    """The clock the port's bench reads (time.perf_counter as
    dcvc_tpu_torch/bench.py sees it) is a fake that steps by `step` at
    each read, so each timed encode and decode takes `step` and the FPS is
    known exactly."""
    step = 3 * 2.0 ** -10         # its multiples add up without rounding
    reads = iter(range(1, 1000))
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(reads) * step))
    rc, rec = bench.run_bench(TINY_HT_CONFIG, 32, 48, n_chunks=2, warmup=1,
                              iters=1, device="cpu")
    line = _last_json(capsys)
    assert rc == 0 and line == rec
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "dmc_hts_1080p_encdec_fps"
    n = 2 * TINY_HT_CONFIG.frame_delay
    fps = 1.0 / (step / n + step / n)
    assert line["unit"] == "fps" and line["value"] == round(fps, 3) > 0
    assert line["vs_baseline"] == round(fps / bench.BASELINE_FPS, 4)


def test_broken_round_trip_zeroes_the_value(capsys, monkeypatch):
    real = DMCHTCodec.decompress_sequence

    def perturbed(self, *args, **kwargs):
        outs = real(self, *args, **kwargs)
        self.ref_feature = self.ref_feature + 1.0
        return outs
    monkeypatch.setattr(DMCHTCodec, "decompress_sequence", perturbed)
    rc, rec = bench.run_bench(TINY_HT_CONFIG, 32, 32, n_chunks=1, warmup=1,
                              iters=1, device="cpu")
    assert rc == 1
    assert _last_json(capsys) == rec == {
        "metric": "dmc_hts_1080p_encdec_fps", "value": 0.0, "unit": "fps",
        "vs_baseline": 0.0, "error": "round-trip mismatch"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
