"""Measurements of the port on the card, and the helpers chip_smoke.py
shares with them.

    python3 -m dcvc_tpu_torch.perf_probe shapes [--iters 50]
    python3 -m dcvc_tpu_torch.perf_probe profile [--runs 2]

`shapes` codes a warm 1080p DMCI frame (encode, decode) and, where the
checkout has the HTS codec, a warm later 1080p HTS chunk (encode without
recon, decode with it), all at qp 32 with seeded random weights in bf16.
A LaunchLog records the shape of every K1 launch these calls make; then
K1 and its plain version are timed at each distinct shape on random bf16
inputs (CUDA events, median of `iters` after 3 warm-ups).  It prints one
line per shape and K1's device time per call (sum of per-shape medians x
launches), then a JSON line of both.  To compare two checkouts in one
session on the card, copy this file into the other checkout's package and
run it from each root in turn: parent, change, change, parent.

`profile` runs torch.profiler over the same warm calls, `runs` times
each.  Per call it prints the wall time (host clock around the call,
synchronised, profiler on), the device busy time (the union of the
intervals of every kernel, copy and memset the profiler saw on the card),
the device idle share (1 - busy / wall), the host rANS coder's time
(inside its methods), and the kernels with the most device time.

Needs one CUDA device; prints the card's name and power limit first.
"""

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import time
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .kernels import fused_dcb as K1
from .models.dmci import DMCIConfig
from .runtime.image_codec import DMCICodec

QP = 32
H, W = 1080, 1920


class Launch(NamedTuple):
    """The shape of one K1 launch.  kind is 'fused_dcb' (s = 1) or
    'fused_dcb_stacked' (s entries); bcast: the stacked x is one tensor
    for every entry (a stack stride of 0)."""
    kind: str
    s: int
    h: int
    w: int
    cin: int
    c: int
    inner: int
    adaptor: bool
    shortcut: bool
    bcast: bool

    def __str__(self):
        stack = "" if self.kind == "fused_dcb" else f" S={self.s}"
        return (f"{self.kind}{stack} {self.h}x{self.w} {self.cin}->{self.c} "
                f"I={self.inner} adaptor={int(self.adaptor)} "
                f"shortcut={int(self.shortcut)} broadcast_x={int(self.bcast)}")


class LaunchLog:
    """Inside `with log:`, records the Launch of every K1 launch, per
    labelled call (`with log.call(label):`; a launch outside a call
    raises).  It wraps the wrappers' launch functions and leaves the
    launch counts to them."""

    def __init__(self):
        self.calls = []                # (label, Counter of Launch)
        self._cur = None

    def __enter__(self):
        self._saved = {}
        for name, kind in (("fused_dcb_launch", "fused_dcb"),
                           ("fused_dcb_stacked_launch", "fused_dcb_stacked")):
            fn = getattr(K1, name, None)   # an older checkout has no stack
            if fn is not None:
                self._saved[name] = fn
                setattr(K1, name, self._recorder(fn, kind))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(K1, name, fn)

    def _recorder(self, fn, kind):
        def launch(x, ops, *args):
            c, inner = ops["w2"].shape[-1], ops["w1"].shape[-1]
            if kind == "fused_dcb":
                shortcut = bool(args[0]) if args else False
                key = Launch(kind, 1, *x.shape[1:], c, inner, "wa" in ops,
                             shortcut, False)
            else:
                s = x.shape[0]
                key = Launch(kind, s, *x.shape[2:], c, inner, "wa" in ops,
                             False, s > 1 and x.stride(0) == 0)
            if self._cur is None:
                raise AssertionError(f"K1 launched outside a labelled call: "
                                     f"{key}")
            self._cur[key] += 1
            return fn(x, ops, *args)
        return launch

    @contextlib.contextmanager
    def call(self, label):
        self._cur = collections.Counter()
        self.calls.append((label, self._cur))
        try:
            yield self._cur
        finally:
            self._cur = None

    def totals(self):
        """Counter of every Launch over every call."""
        total = collections.Counter()
        for _, counts in self.calls:
            total.update(counts)
        return total


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of fn() over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def random_block(cin, c, inner, adaptor, gen):
    """DCB weights in fused_dcb layout, lecun-scaled, non-zero biases."""
    def w(i, o):
        return torch.randn(i, o, generator=gen) / i ** 0.5

    def b(n):
        return 0.1 * torch.randn(n, generator=gen)
    p = {}
    if adaptor:
        p["wa"], p["ba"] = w(cin, c), b(c)
    p["w1"], p["b1"] = w(c, inner), b(inner)
    p["wd"], p["bd"] = torch.randn(3, 3, inner, generator=gen) / 3.0, b(inner)
    p["w2"], p["b2"] = w(inner, c), b(c)
    p["w3"], p["b3"] = w(c, 4 * inner), b(4 * inner)
    p["w4"], p["b4"] = w(inner, c), b(c)
    return p


def block_inputs(key, gen, dev):
    """Random bf16 weights and input on `dev` for a launch of shape `key`.
    Returns (x, params, run, ref): run() goes through the kernel's wrapper,
    ref(x, params) is its plain version."""
    bf = torch.bfloat16
    blocks = [random_block(key.cin, key.c, key.inner, key.adaptor, gen)
              for _ in range(key.s)]
    if key.kind == "fused_dcb":
        p = {k: v.to(dev, bf) for k, v in blocks[0].items()}
        x = torch.randn(1, key.h, key.w, key.cin, generator=gen).to(dev, bf)
        ops = K1.prepare_operands(p)
        return (x, p, lambda: K1.fused_dcb(x, p, key.shortcut, ops=ops),
                lambda x_, p_: K1.fused_dcb_reference(x_, p_, key.shortcut))
    p = {k: torch.stack([b[k] for b in blocks]).to(dev, bf)
         for k in blocks[0]}
    x = torch.randn(1 if key.bcast else key.s, 1, key.h, key.w, key.cin,
                    generator=gen).to(dev, bf).expand(key.s, -1, -1, -1, -1)
    ops = K1.prepare_operands_stacked(p)
    return (x, p, lambda: K1.fused_dcb_stacked(x, p, ops=ops),
            K1.fused_dcb_stacked_reference)


def smooth_frame(h, w, seed, dev):
    """A smooth synthetic frame in [-0.5, 0.5]: uniform noise under an 8x8
    box blur (the recipe of bench.py), made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(1, 3, h + 7, w + 7, generator=gen, device=dev)
    x = F.avg_pool2d(x, 8, stride=1)
    return x.permute(0, 2, 3, 1).contiguous() - 0.5


def make_sequence(h, w, n, seed, dev):
    """n frames of one smooth picture drifting a pixel to the right per
    frame, plus a little noise (the recipe of bench.py), on the card."""
    base = smooth_frame(h, w, seed, dev) + 0.5
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    return [torch.clamp(torch.roll(base, i, dims=2) + 0.005 * torch.randn(
        base.shape, generator=gen, device=dev), 0, 1) - 0.5
        for i in range(n)]


def _hts_codec(dev):
    """The HTS codec at full width (init_scale 0.5, as bench.py), or None
    in a checkout that has none."""
    try:
        from .runtime.video_codec import DMCHTCodec
    except ImportError:
        return None
    return DMCHTCodec.init_random(torch.Generator().manual_seed(0),
                                  init_scale=0.5, skip_thres=0.15,
                                  dtype=torch.bfloat16, device=dev)


def warm_calls(dev):
    """[(label, codec, fn)] of the measured calls, each warmed up once:
    a 1080p DMCI encode and decode, and (where there is an HTS codec) a
    later 1080p HTS chunk's encode and decode; every fn() repeats its
    call from the same state."""
    h, w = H, W
    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    x = smooth_frame(h, w, 0, dev)
    res = dmci.compress(x, QP)
    bits = bytes(res["bit_stream"])
    dmci.decompress(bits, QP, h, w, res["ec_parallel"])
    calls = [("DMCI 1080p encode", dmci, lambda: dmci.compress(x, QP)),
             ("DMCI 1080p decode", dmci, lambda: dmci.decompress(
                 bits, QP, h, w, res["ec_parallel"]))]
    hts = _hts_codec(dev)
    if hts is None:
        return calls
    frames = make_sequence(h, w, 16, 2, dev)
    chunks = [torch.cat(frames[8 * u:8 * u + 8], dim=-1) for u in range(2)]

    def seeded():
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(frames[0])

    seeded()
    r0 = hts.compress(chunks[0], QP)
    after0 = (hts.ref_feature, hts.memory)
    r1 = hts.compress(chunks[1], QP)
    streams = [(bytes(r["bit_stream"]), r["ec_parallel"]) for r in (r0, r1)]
    seeded()
    hts.decompress(streams[0][0], QP, h, w, streams[0][1])
    hts.decompress(streams[1][0], QP, h, w, streams[1][1])

    def later(fn):
        hts.ref_feature, hts.memory = after0
        return fn()
    calls += [("HTS 1080p later chunk encode", hts,
               lambda: later(lambda: hts.compress(chunks[1], QP))),
              ("HTS 1080p later chunk decode", hts,
               lambda: later(lambda: hts.decompress(
                   streams[1][0], QP, h, w, streams[1][1])))]
    return calls


def run_shapes(dev, iters):
    calls = warm_calls(dev)
    log = LaunchLog()
    with log:
        for label, _, fn in calls:
            with log.call(label):
                fn()
    gen = torch.Generator().manual_seed(0)
    times = {}
    for key in sorted(log.totals()):
        with torch.inference_mode():
            x, p, run, ref = block_inputs(key, gen, dev)
            times[key] = (cuda_ms(run, iters),
                          cuda_ms(lambda: ref(x, p), iters))
        print(f"{key}: kernel_ms={times[key][0]} plain_ms={times[key][1]}",
              flush=True)
    sums = {}
    for label, counts in log.calls:
        sums[label] = [sum(n * times[k][i] for k, n in counts.items())
                       for i in (0, 1)]
        print(f"{label}: K1 launches {sum(counts.values())}, device time "
              f"(per-shape medians x launches) kernel_ms={sums[label][0]} "
              f"plain_ms={sums[label][1]}", flush=True)
    print(json.dumps({"shapes": {str(k): v for k, v in times.items()},
                      "calls": sums}))


@contextlib.contextmanager
def host_coder_timer(codec):
    """Adds the host time spent inside the codec's rANS coder methods to
    the yielded one-element list (seconds)."""
    spent = [0.0]
    patched = []
    for coder in (codec.encoder, codec.decoder):
        for name in ("encode_y", "encode_z", "flush", "get_encoded_stream",
                     "set_stream", "decode_y", "decode_z", "get_decoded"):
            fn = getattr(coder, name, None)
            if fn is None:
                continue

            def timed(*args, _fn=fn, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    spent[0] += time.perf_counter() - t0
            setattr(coder, name, timed)
            patched.append((coder, name))
    try:
        yield spent
    finally:
        for coder, name in patched:
            delattr(coder, name)


def busy_ms(intervals):
    """Length of the union of (start, end) intervals (us), in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_call(label, codec, fn, run, top=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with host_coder_timer(codec) as coder_s, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("torch.profiler recorded no device events")
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e.name.removeprefix("void ").replace(
            "(anonymous namespace)::", "").split("(")[0]
        kernels[name][0] += e.time_range.elapsed_us() / 1e3
        kernels[name][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    print(json.dumps({"call": label, "run": run, "wall_ms": wall,
                      "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                      "host_rans_ms": 1e3 * coder_s[0],
                      "kernels_ms_count": dict(ranked)}), flush=True)


def run_profile(dev, runs):
    for label, codec, fn in warm_calls(dev):
        for r in range(runs):
            profile_call(label, codec, fn, r)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("shapes", "profile"))
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per shape (shapes)")
    ap.add_argument("--runs", type=int, default=2,
                    help="profiled runs per call (profile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device: {nvidia_smi()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    # (the codecs' own methods run in inference mode; their weights must
    # not be made in it)
    if args.mode == "shapes":
        run_shapes(dev, args.iters)
    else:
        run_profile(dev, args.runs)


if __name__ == "__main__":
    main()
