"""Benchmark of dcvc_tpu_torch, the PyTorch and CUDA port of DCVC-TPU:
one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is benchmark/workloads/<cell>.json; it names a configuration,
benchmark/configs/<config>.json (the sizes, precision and weight recipe)
with benchmark/configs/<config>.py (the program's codec behind its public
calls, and the frozen reference).  The per-layer metrics of a traced run
are read by benchmark/metrics/<metric>.py, one file each, for the metrics
that BENCHMARK.json lists for the cell.

A run: the weights are drawn on the card from the configuration's
weight seed (reference/weights.py), the program's codec is built and
warmed with one request per QP of the cell, then requests are coded one
after another (one client, closed loop) for --seconds: each request's
picture and QP chosen from the seed and its frames made on the card
(traffic.py), its encode call and its decode call each timed on the
host clock between synchronisations, and the codec's own gate held
(the decoder's frames or DPB equal the encoder's bit for bit; a request
that fails it counts as failed).  A
sample of the finished requests of each QP the cell compares (its
`limits`), drawn from the seed, keeps its decoded frames.  After the
window the peak memory is read, the program is freed, and the frozen
float32 reference codes the sampled requests' frames again from the
same weights; per QP, the widest per-frame mean absolute gap between
the program's decoded frames and the reference's is held to the cell's
limit for that QP.

--trace 0 prints the end-to-end metrics; --trace 1 runs the window under
torch.profiler (at most the cell's `trace_requests` requests) and prints
the per-layer metrics, the device's busy and window seconds and a
breakdown.  The last line of stdout is one JSON object; the numbers
compared, each beside its limit, are the last lines of stderr and the
last key of that object.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel and build caches at fixed paths inside the checkout
CACHE = os.path.join(HERE, "_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))

import torch  # noqa: E402

from benchmark import traffic  # noqa: E402
from benchmark.control import Control  # noqa: E402
from benchmark.reference import counts, weights  # noqa: E402
from benchmark.tracing import Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dcvc_tpu")
CODER_METHODS = ("encode_y", "encode_z", "flush", "get_encoded_stream",
                 "set_stream", "decode_y", "decode_z", "get_decoded")
SAMPLE_SEED = 0x5EED


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name, overrides=None):
    """(workload, config spec, config module) of cell `name`; overrides
    (tests, readings) update the workload, the config and its widths."""
    wl = load_json("workloads", f"{name}.json")
    spec = load_json("configs", f"{wl['config']}.json")
    if overrides:
        wl.update(overrides.get("workload", {}))
        spec.update(overrides.get("spec", {}))
        spec["widths"] = dict(spec["widths"], **overrides.get("widths", {}))
    mod = load_module(os.path.join(HERE, "configs", f"{wl['config']}.py"),
                      f"benchmark_config_{wl['config']}")
    return wl, spec, mod


def metric_readers(cell, benchmark):
    """{name: module} of the per-layer metrics BENCHMARK.json lists for
    `cell`."""
    out = {}
    for m in benchmark.get("per_layer", []):
        if cell in m.get("workloads", [cell]):
            out[m["name"]] = load_module(
                os.path.join(HERE, "metrics", f"{m['name']}.py"),
                "benchmark_metric_" + m["name"].replace(".", "_"))
    return out


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def coder_timer(bucket, spent):
    """Adds the host seconds spent inside the host rANS coder's methods
    (the program's RansEncoder / RansDecoder classes) to spent[bucket[0]],
    each call also a profiler span `rans.<method>`."""
    from dcvc_tpu_torch import rans
    patched = []
    for cls in (rans.RansEncoder, rans.RansDecoder):
        for name in CODER_METHODS:
            fn = cls.__dict__.get(name)
            if fn is None:
                continue

            def timed(*args, _fn=fn, _name=name, **kwargs):
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(f"rans.{_name}"):
                        return _fn(*args, **kwargs)
                finally:
                    spent[bucket[0]] = spent.get(bucket[0], 0.0) + \
                        time.perf_counter() - t0
            setattr(cls, name, timed)
            patched.append((cls, name, fn))
    try:
        yield
    finally:
        for cls, name, fn in patched:
            setattr(cls, name, fn)


class Reservoir:
    """A uniform sample of `k` of the finished requests, drawn from the
    seed as they finish."""

    def __init__(self, k, seed):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(int(seed) ^ SAMPLE_SEED)

    def offer(self, make_item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make_item())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make_item()


def frame_mae(a, b):
    """Per-frame mean absolute difference of (n, h, w, 3) frames."""
    d = (a.float() - b.float()).reshape(a.shape[0], -1)
    return d.abs().mean(dim=1).tolist()


def reference_check(wl, spec, mod, device, sample):
    """{qp: the widest per-frame mean absolute gap between the sampled
    requests' decoded frames at that QP and the frozen float32
    reference's}, coding the same frames from the same weights (TF32
    off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        meta = mod.reference(spec)
    with torch.device(device):
        model = mod.reference(spec)
    model.load_state_dict(weights.draw_state(meta, spec["weights"], device))
    model.eval()
    n = mod.frames_per_request(wl)
    worst = {}
    with torch.no_grad():
        for picture, qp, out in sample:
            frames = traffic.make_frames(*picture, n, wl["height"],
                                         wl["width"], device)
            ref = mod.reference_outputs(model, frames, qp, spec)
            worst[qp] = max([worst.get(qp, 0.0)] + frame_mae(out, ref))
    return worst


def request_work(wl, spec, mod):
    """FLOPs of one request's encode and decode and the K1 bound of its
    encode, from the frozen reference on the meta device."""
    with torch.device("meta"):
        model = mod.reference(spec).requires_grad_(False)
    enc, dec = mod.work_fns(model, wl, spec)
    flops_enc, k1_enc = counts.work(model, enc)
    flops_dec, _ = counts.work(model, dec)
    return {"flops.enc": flops_enc, "flops.dec": flops_dec,
            "k1_bound_ms.enc": k1_enc}


def short_name(name):
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def read_trace(prof, wl, spec, mod, frames, requests, coder_s):
    """The Trace of a profiled window, and the breakdown of its device
    operations and idle gaps."""
    from torch.autograd import DeviceType
    calls = {"enc": [], "dec": []}
    host_spans, device = [], []
    for e in prof.events():
        ours = e.name.startswith(("bench.", "rans."))
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors our host spans on the device's timeline
            # (GPU user annotations): they are no device operation
            if not ours:
                device.append((e.name, e.time_range.start,
                               e.time_range.end))
        elif e.name in ("bench.enc", "bench.dec"):
            calls[e.name[6:]].append((e.time_range.start, e.time_range.end))
            host_spans.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("rans."):
            host_spans.append((e.name, e.time_range.start, e.time_range.end))
    trace = Trace(calls=calls, device=device, frames=frames,
                  requests=requests, host_coder_s=coder_s,
                  work=request_work(wl, spec, mod))
    ops = {}
    for n, s, e in device:
        k = short_name(n)
        ops[k] = ops.get(k, 0.0) + (e - s) / 1e6
    idle = {}
    intervals = [(s, e) for _, s, e in device]
    for kind in ("enc", "dec"):
        for a, b in calls[kind]:
            for gs, ge in counts.gaps(intervals, a, b):
                mid = (gs + ge) / 2
                inner = [(s, n) for n, s, e in host_spans if s <= mid <= e]
                label = max(inner)[1] if inner else "bench." + kind
                if label.startswith("rans."):
                    label = f"bench.{kind}/{label}"
                idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    busy_s = counts.union_length(intervals) / 1e6
    return trace, {"device_ops": [list(x) for x in top],
                   "idle_gaps": [list(x) for x in gaps]}, busy_s


def run_cell(cell, seed, seconds, trace=False, device="cuda",
             overrides=None, readers=None, fault=None, control=False,
             max_requests=None, t_start=None):
    """One run of `cell`; returns the result object.  Readings and tests
    only: fault, a callable fault(program) that breaks the program under
    test; control, the float8 reference (control.Control) in the
    program's place; max_requests, the window also ends after that many
    requests."""
    t_start = T_START if t_start is None else t_start
    device = torch.device(device)
    wl, spec, mod = load_cell(cell, overrides)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    with torch.device("meta"):
        meta = mod.reference(spec)
    make = functools.partial(Control, mod) if control else mod.Program
    prog = make(weights.draw_state(meta, spec["weights"], device), spec, wl,
                device, dtype)
    if fault is not None:
        fault(prog)
    n_frames = mod.frames_per_request(wl)
    h, w = wl["height"], wl["width"]
    schedule = traffic.Schedule(wl, seed)

    coder_s, bucket = {}, ["enc"]

    def one(picture, qp):
        frames = traffic.make_frames(*picture, n_frames, h, w, device)
        req = prog.prepare(frames)
        sync(device)
        t0 = time.perf_counter()
        bucket[0] = "enc"
        with torch.profiler.record_function("bench.enc"):
            enc = prog.encode(req, qp)
            sync(device)
        t1 = time.perf_counter()
        bucket[0] = "dec"
        with torch.profiler.record_function("bench.dec"):
            dec = prog.decode(req, enc)
            sync(device)
        t2 = time.perf_counter()
        return enc, dec, t1 - t0, t2 - t1

    for k, qp in enumerate(wl["qps"]):          # warm every QP's call
        one((seed, -1 - k), qp)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start

    limits = wl["limits"]["recon_mae_max"]
    samples = {qp: Reservoir(wl["sample"], int(seed) + qp)
               for qp in wl["qps"] if str(qp) in limits}
    enc_t, dec_t, failed, stream_bytes = [], [], 0, 0
    limit_requests = wl["trace_requests"] if trace else max_requests
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            stack.enter_context(coder_timer(bucket, coder_s))
            prof = stack.enter_context(profile(activities=acts,
                                               acc_events=True))
        sync(device)
        w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - w0 < seconds and (
                limit_requests is None or i < limit_requests):
            picture, qp = schedule.request(i)
            try:
                enc, dec, te, td = one(picture, qp)
            except Exception:           # a request that never decodes
                traceback.print_exc(limit=4)
                failed += 1
                i += 1
                continue
            enc_t.append(te)
            dec_t.append(td)
            stream_bytes += prog.stream_bytes(enc)
            if not prog.gate(enc, dec):
                failed += 1
            if qp in samples:
                samples[qp].offer(lambda: (picture, qp, prog.outputs(dec)))
            del enc, dec
            i += 1
        sync(device)
        window_s = time.perf_counter() - w0
    attempted = i
    if on_card:
        mem_peak = torch.cuda.max_memory_allocated(device)
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": 1, "memory_peak_bytes": int(mem_peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    frames_done = len(enc_t) * n_frames
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": dev_info}
    breakdown = None
    if trace:
        tr, breakdown, busy_s = read_trace(
            prof, wl, spec, mod, {"enc": frames_done, "dec": frames_done},
            {"enc": len(enc_t), "dec": len(dec_t)}, coder_s)
        dev_info["busy_s"] = busy_s
        dev_info["window_s"] = window_s
        for name, reader in (readers or {}).items():
            value = reader.read(tr)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": reader.UNIT}
    elif enc_t:
        enc_s, dec_s = sum(enc_t), sum(dec_t)
        result["metrics"] = {
            "encode_fps": {"value": frames_done / enc_s, "unit": "frames/s"},
            "decode_fps": {"value": frames_done / dec_s, "unit": "frames/s"},
            "encode_p95_ms": {"value": 1e3 * counts.percentile(enc_t, 95),
                              "unit": "ms"},
            "decode_p95_ms": {"value": 1e3 * counts.percentile(dec_t, 95),
                              "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}

    print(f"# {cell} seed {seed}: {attempted} requests, {failed} failed, "
          f"{frames_done} frames, {stream_bytes} stream bytes "
          f"({8 * stream_bytes / max(1, frames_done * h * w):.4f} bpp), "
          f"window {window_s:.3f} s, setup {setup_s:.3f} s",
          file=sys.stderr, flush=True)
    if enc_t:
        print("# enc ms: " + " ".join(f"{1e3 * t:.2f}" for t in enc_t[:40]),
              file=sys.stderr)
        print("# dec ms: " + " ".join(f"{1e3 * t:.2f}" for t in dec_t[:40]),
              file=sys.stderr)

    sample = [item for r in samples.values() for item in r.items]
    gaps = reference_check(wl, spec, mod, device, sample)
    # "max": the value may not exceed the limit; "min": nor fall below it
    checks = {"failed_requests": {"value": failed, "limit": 0, "is": "max"},
              "compared_requests": {"value": len(sample), "limit": 1,
                                    "is": "min"}}
    for qp in samples:
        checks[f"recon_mae_max.qp{qp}"] = {
            "value": gaps.get(qp), "limit": limits[str(qp)], "is": "max"}
    # a compared QP with no sampled request has no value, and fails
    result["correct"] = attempted > 0 and all(
        c["value"] is not None and (c["value"] <= c["limit"]
                                    if c["is"] == "max"
                                    else c["value"] >= c["limit"])
        for c in checks.values())
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report(result):
    """The numbers compared, each beside its limit, as the last lines of
    stderr; then the result as the last line of stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} ({c['is']} {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    readers = metric_readers(args.workload, bench) if args.trace else None
    result = run_cell(args.workload, args.seed, args.seconds,
                      trace=bool(args.trace), device="cuda",
                      readers=readers)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
