"""Measurements of the port on the card, and the helpers chip_smoke.py
shares with them.

    python3 -m dcvc_tpu_torch.perf_probe shapes [--iters 50]
    python3 -m dcvc_tpu_torch.perf_probe profile [--runs 2]
    python3 -m dcvc_tpu_torch.perf_probe k2 [--symbols N] [--lanes n]
                                            [--clocks]
    python3 -m dcvc_tpu_torch.perf_probe tiles [--iters 50]

`shapes` codes a warm 1080p DMCI frame (encode, decode) and, for each
DMC-HT width the checkout has (HTS, HTL), a warm later 1080p chunk
(encode without recon, decode with it), all at qp 32 with seeded random
weights in bf16; where the checkout has the device-entropy decode, every
decode also runs through it.
A LaunchLog records the shape of every K1 launch these calls make; then
K1 and its plain version are timed at each distinct shape on random bf16
inputs (CUDA events, median of `iters` after 3 warm-ups).  It prints one
line per shape and K1's device time per call (sum of per-shape medians x
launches), then a JSON line of both.  To compare two checkouts in one
session on the card, copy this file into the other checkout's package and
run it from each root in turn: parent, change, change, parent.

`k2` times K2 on a synthetic stream coded by the host encoder (see
run_k2) against the host decoder's symbols, with its plain version's
time and its latency bound.  With --clocks it also runs K2's
cycle-counting build (-DK2_CLOCKS) on that stream and on every K2 call of
a recorded 1080p DMCI device decode, and prints where the cycles of a
symbol go (row fetch and CDF search, state update and renorm, escape
path, output store), the cycles per escape, and the SM clock under load
(cycles over %globaltimer ns).

`tiles` times each launch of K1's chain (torch.profiler) at the heaviest
main-path shapes under every GEMM tile the core has, and K1's host time
per call (run_tiles).

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
            # K-major operands: w2 (..., C, I), w1 (..., I, C)
            c, inner = ops["w2"].shape[-2], ops["w1"].shape[-2]
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


# ------------------------------------------------------------------ K2

class K2Call(NamedTuple):
    """One call of K2 on the main path, its inputs kept for a replay:
    the lanes (shared by a decode's calls), the state going in, idx, the
    count tensor (or int) and the bank (rows) of the call."""
    label: str
    streams: torch.Tensor
    st: torch.Tensor
    ptr: torch.Tensor
    idx: torch.Tensor
    count: object
    bank: dict

    def args(self):
        return ({"streams": self.streams, "st": self.st, "ptr": self.ptr},
                self.idx, self.count, self.bank)

    def signature(self):
        """Its shape: (lanes, lane bytes, cap, bank rows)."""
        return (self.streams.shape[0], self.streams.shape[1],
                self.idx.shape[0], self.bank["cdf"].shape[0])


class K2Log:
    """Inside `with log:`, keeps the inputs of every launch of K2 (wrapping
    the wrapper's launch function; the codecs call it through
    kernels.rans_decode.rans_decode), under the label set by
    `log.label`."""

    def __init__(self):
        self.calls = []
        self.label = None

    def __enter__(self):
        from .kernels import rans_decode as K2
        self._k2 = K2
        self._saved = K2.rans_decode_launch

        def launch(state, idx, count, bank):
            self.calls.append(K2Call(
                self.label, state["streams"], state["st"], state["ptr"], idx,
                count, bank))
            return self._saved(state, idx, count, bank)
        K2.rans_decode_launch = launch
        return self

    def __exit__(self, *exc):
        self._k2.rans_decode_launch = self._saved


def k2_fixtures():
    """The cases of tests/test_device_decode.py and
    tests/test_pallas_decode.py, made with numpy from their seeds and
    encoded by the port's host coder: [(name, n_lanes, stream, calls)],
    calls = [(idx (cap,) uint8, count, cdf, lengths, want)] on one lane
    state, want = the host decoder's symbols of the call."""
    import numpy as np
    from .entropy.cdf import pmf_to_quantized_cdf
    from .rans import RansDecoder, RansEncoder

    def bank(rng, n_cdf, alphabet):
        per = alphabet + 2
        cdf = np.zeros((n_cdf, per), np.int32)
        for i in range(n_cdf):
            cdf[i] = pmf_to_quantized_cdf(
                rng.dirichlet(np.full(alphabet + 1, 0.6)))
        return cdf, np.full((n_cdf,), per, np.int32)

    def pad(idx, cap):
        out = np.zeros(cap, np.uint8)
        out[:idx.size] = idx
        return out

    def coders(n_lanes, y_bank, z_bank=None):
        enc, dec = RansEncoder(), RansDecoder()
        for c in (enc, dec):
            c.set_cdf(*y_bank, 1)
            if z_bank is not None:
                c.set_cdf(*z_bank, 0)
            c.set_parallel(n_lanes)
        enc.reset()
        return enc, dec

    cases = []
    for n_lanes, seed, n, cap in [(1, 101, 1001, 1017), (2, 102, 1002, 1018),
                                  (3, 103, 1003, 1019), (5, 105, 1005, 1021),
                                  (8, 108, 1008, 1024), (8, 5, 5, 256),
                                  (3, 6, 0, 64)]:
        rng = np.random.default_rng(seed)
        yb = bank(rng, 7, 12)
        idx = rng.integers(0, 7, n).astype(np.uint8)
        sym = rng.integers(-5, 6, n).astype(np.int8)
        esc = rng.random(n) < 0.02          # bypass escapes
        sym[esc] = rng.integers(30, 120, esc.sum())
        enc, dec = coders(n_lanes, yb)
        enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
        enc.flush()
        stream = enc.get_encoded_stream()
        dec.set_stream(stream)
        want = np.zeros(0, np.int8)
        if n:
            dec.decode_y(idx)
            want = dec.get_decoded(n)
        name = (f"y {n_lanes} lanes, {n} symbols, {int(esc.sum())} escapes"
                if n >= n_lanes else f"y {n_lanes} lanes, count {n}")
        cases.append((name, n_lanes, stream,
                      [(pad(idx, cap), n, *yb, want)]))

    # z -> y1 -> y2 on one state (the decode ladder)
    rng = np.random.default_rng(17)
    n_lanes, ch, qp, nz, cap = 8, 4, 2, 256, 1024
    zb, yb = bank(rng, 12, 16), bank(rng, 9, 10)
    z = rng.integers(-7, 8, nz).astype(np.int8)
    i1 = rng.integers(0, 9, 700).astype(np.uint8)
    i2 = rng.integers(0, 9, 500).astype(np.uint8)
    s1 = rng.integers(-4, 5, 700).astype(np.int8)
    s2 = rng.integers(-4, 5, 500).astype(np.int8)
    enc, dec = coders(n_lanes, yb, zb)
    enc.encode_y(((s2.astype(np.int16) << 8) | i2).astype(np.int16))
    enc.encode_y(((s1.astype(np.int16) << 8) | i1).astype(np.int16))
    enc.encode_z(z, qp * ch, ch)
    enc.flush()
    stream = enc.get_encoded_stream()
    dec.set_stream(stream)
    dec.decode_z(nz, qp * ch, ch)
    wz = dec.get_decoded(nz)
    dec.decode_y(i1)
    w1 = dec.get_decoded(700)
    dec.decode_y(i2)
    w2 = dec.get_decoded(500)
    zrows = slice(qp * ch, qp * ch + ch)
    cases.append(("z -> y1 -> y2, 8 lanes", n_lanes, stream, [
        ((np.arange(nz) % ch).astype(np.uint8), nz, zb[0][zrows],
         zb[1][zrows], wz),
        (pad(i1, cap), 700, *yb, w1), (pad(i2, cap), 500, *yb, w2)]))
    return cases


def run_k2_case(case, dev, decode):
    """A fixture's calls through `decode` (K2's wrapper, its launch or its
    plain version) on `dev`.  Returns (final state, outputs)."""
    from .kernels.rans_decode import make_bank
    from .rans.device_decode import init_state, upload_lanes
    _, n_lanes, stream, calls = case
    state = init_state(upload_lanes(stream, n_lanes, dev))
    outs = []
    for idx, count, cdf, lengths, _ in calls:
        state, out = decode(
            state, torch.from_numpy(idx).to(dev),
            torch.tensor(count, dtype=torch.int32, device=dev),
            make_bank(cdf, lengths, dev))
        outs.append(out)
    return state, outs


# One symbol step's dependent chain (rans.cc dec_symbol): cum = st & mask,
# the compare that finds s, the select of cdf[s] / cdf[s + 1], the
# multiply-add of the new state, the renorm compare, the shift-or of the
# pulled byte: 6 dependent integer operations, each at least 4 cycles on
# Hopper's integer pipes.  The row, the byte and the next index do not
# depend on the state and can be fetched ahead.
K2_STEP_OPS = 6
# One bypass escape in closed form (csrc/rans_decode.cu): the compare of
# the state that gives j; the select of Y (the state's low 2j
# bits and the byte window shifted by 2j; the five shifts of the window
# need not wait for the state); the 3-input AND that marks the chunks that
# are not 3; the find-first-set that gives the run of 3s and so the count
# prefix; the multiply-add of n_bypass into the chunk count; the shift of
# the (parked state | next byte) by the count that gives the new state.
# 6 dependent operations; the raw value and the bytes taken are off the
# chain.
K2_ESCAPE_OPS = 6
K2_OP_CYCLES = 4


def k2_lane_sizes(count, n):
    """The symbols of each of the n lanes of a call (rans.cc's split)."""
    size0 = count // n
    return [size0] * (n - 1) + [count - size0 * (n - 1)]


def k2_lane_escapes(call, out):
    """The escaped symbols of each lane of a K2 call (K2Call), from its
    decoded symbols `out` (the plain version's): a symbol escaped if its
    value (zig-zag undone) is at least its row's len - 2.  A list of n
    ints."""
    count = int(call.count)
    n = call.streams.shape[0]
    sym = out[:count].to(torch.int64).cpu()
    rows = call.idx[:count].to(torch.int64).cpu().clamp_max(
        call.bank["len"].shape[0] - 1)
    value = 2 * sym.abs() - (sym > 0).to(torch.int64)
    esc = value >= call.bank["len"].cpu().to(torch.int64)[rows] - 2
    bounds = torch.tensor([0] + k2_lane_sizes(count, n)).cumsum(0).tolist()
    return [int(esc[a:b].sum()) for a, b in zip(bounds, bounds[1:])]


def k2_latency_bound_ms(calls, clock_mhz, escapes=None):
    """The least time of K2 on these calls: each lane is one dependent
    chain, so a call takes at least its longest lane's chain, K2_STEP_OPS
    dependent integer operations per symbol plus K2_ESCAPE_OPS per escaped
    symbol (escapes: each call's per-lane escape counts, k2_lane_escapes;
    None counts none: the symbols-only bound), each of K2_OP_CYCLES cycles at
    the SM clock; summed over the calls."""
    cycles = 0
    for i, c in enumerate(calls):
        sizes = k2_lane_sizes(int(c.count), c.streams.shape[0])
        esc = escapes[i] if escapes is not None else [0] * len(sizes)
        cycles += max(K2_STEP_OPS * n + K2_ESCAPE_OPS * e
                      for n, e in zip(sizes, esc)) * K2_OP_CYCLES
    return cycles / (clock_mhz * 1e3)


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16
# tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def k1_bound_ms(key):
    """(ms at the bf16 peak for the launch's matrix-product FLOPs, ms at
    the memory rate for its bytes: x read once (once for all entries when
    broadcast), weights and biases read once, the output written once;
    all bf16) of one K1 launch of shape `key`.  The bound is the larger."""
    pix = key.h * key.w
    i, c = key.inner, key.c
    macs = c * i + i * c + 4 * c * i + i * c          # dc_in, dc_out, FFN
    weights = macs + 9 * i + 2 * i + 4 * i + 3 * c    # + dw kernel, biases
    if key.adaptor:
        macs += key.cin * c
        weights += key.cin * c + c
    flops = key.s * pix * (2 * macs + 2 * 9 * i)
    x_reads = 1 if key.bcast else key.s
    nbytes = 2 * (x_reads * pix * key.cin + key.s * weights
                  + key.s * pix * c)
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S


# K1's kernels, one per launch of its chain (csrc/fused_dcb.cu), in order;
# the GEMMs run on the wgmma/TMA core
K1_KERNELS = ("k1_adaptor", "k1_h", "k1_dw", "k1_dc_out", "k1_ffn_in",
              "k1_ffn_out")
K1_GEMMS = tuple(k for k in K1_KERNELS if k != "k1_dw")


def k1_launch_flops(key):
    """The FLOPs of each launch of K1's chain at shape `key`, by kernel."""
    pix = key.s * key.h * key.w
    ci = key.c * key.inner
    flops = {"k1_h": 2 * pix * ci, "k1_dw": 2 * 9 * pix * key.inner,
             "k1_dc_out": 2 * pix * ci, "k1_ffn_in": 8 * pix * ci,
             "k1_ffn_out": 2 * pix * ci}
    if key.adaptor:
        flops["k1_adaptor"] = 2 * pix * key.cin * key.c
    return flops


def kernel_label(name):
    """'k1_h<128, 256>' from a demangled or mangled name of one of K1's
    kernels (a profiler event, a cuobjdump function), else None."""
    import re
    m = re.search(r"(k1_[a-z0-9_]*[a-z0-9])(?:<([0-9, ]+)>|I((?:Li\d+E)+)E)?",
                  name)
    if m is None:
        return None
    base, demangled, mangled = m.groups()
    args = (demangled.replace(" ", "") if demangled else
            ",".join(re.findall(r"Li(\d+)E", mangled)) if mangled else "")
    return f"{base}<{args}>" if args else base


def sass_counts(lib):
    """{kernel label: {'HGMMA': n, 'UTMALDG': n, 'HMMA': n}} of every
    function in the built library `lib`, from cuobjdump -sass."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1)) or m.group(1)
            counts[cur] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
        elif cur is not None:
            for op in counts[cur]:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def profile_launches(run, runs=5):
    """Device time of each of K1's kernels in a run of run() (a call of
    K1, which launches each kernel once), from torch.profiler over `runs`
    runs: {kernel: mean ms of its recorded launches}.  A first profile is
    discarded: the tracer may drop the events of its first one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
    us = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        label = kernel_label(e.name)
        if label is not None:
            us[label.split("<")[0]].append(e.time_range.elapsed_us())
    return {k: sum(v) / len(v) / 1e3 for k, v in us.items()}


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


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


def _video_codec(dev, cfg_name):
    """The DMC-HT codec at full width at models.dmc_ht.<cfg_name>
    (init_scale 0.5, as bench.py), or None in a checkout that has none."""
    try:
        from .models import dmc_ht
        from .runtime.video_codec import DMCHTCodec
        cfg = getattr(dmc_ht, cfg_name)
    except (ImportError, AttributeError):
        return None
    return DMCHTCodec.init_random(torch.Generator().manual_seed(0), cfg=cfg,
                                  init_scale=0.5, skip_thres=0.15,
                                  dtype=torch.bfloat16, device=dev)


def _device_ec(codec, fn):
    """fn() with the codec's device-entropy decode on."""
    codec.device_ec = True
    try:
        return fn()
    finally:
        codec.device_ec = False


def _later_chunk_calls(name, codec, dev):
    """Warm calls of a later 1080p chunk of `codec`: encode, decode and
    (where the checkout has it) the device decode."""
    h, w = H, W
    frames = make_sequence(h, w, 16, 2, dev)
    chunks = [torch.cat(frames[8 * u:8 * u + 8], dim=-1) for u in range(2)]

    def seeded():
        codec.clear_dpb()
        codec.add_ref_feature_from_frame(frames[0])

    seeded()
    r0 = codec.compress(chunks[0], QP)
    after0 = (codec.ref_feature, codec.memory)
    r1 = codec.compress(chunks[1], QP)
    streams = [(bytes(r["bit_stream"]), r["ec_parallel"]) for r in (r0, r1)]
    seeded()
    codec.decompress(streams[0][0], QP, h, w, streams[0][1])
    codec.decompress(streams[1][0], QP, h, w, streams[1][1])

    def later(fn):
        codec.ref_feature, codec.memory = after0
        return fn()

    def decode():
        return codec.decompress(streams[1][0], QP, h, w, streams[1][1])
    calls = [(f"{name} 1080p later chunk encode", codec,
              lambda: later(lambda: codec.compress(chunks[1], QP))),
             (f"{name} 1080p later chunk decode", codec,
              lambda: later(decode))]
    if hasattr(codec, "upload_stream"):
        calls.append((f"{name} 1080p later chunk device decode", codec,
                      lambda: later(lambda: _device_ec(codec, decode))))
        calls[-1][2]()
    return calls


def warm_calls(dev):
    """[(label, codec, fn)] of the measured calls, each warmed up once:
    a 1080p DMCI encode and decode, and, for each DMC-HT width the
    checkout has (HTS, HTL), a later 1080p chunk's encode and decode;
    where the checkout has the device-entropy decode, each decode also
    through it (its stream's upload included).  Every fn() repeats its
    call from the same state."""
    h, w = H, W
    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    x = smooth_frame(h, w, 0, dev)
    res = dmci.compress(x, QP)
    bits = bytes(res["bit_stream"])

    def decode():
        return dmci.decompress(bits, QP, h, w, res["ec_parallel"])
    decode()
    calls = [("DMCI 1080p encode", dmci, lambda: dmci.compress(x, QP)),
             ("DMCI 1080p decode", dmci, decode)]
    if hasattr(dmci, "upload_stream"):
        calls.append(("DMCI 1080p device decode", dmci,
                      lambda: _device_ec(dmci, decode)))
        calls[-1][2]()
    for name in ("HTS", "HTL"):
        codec = _video_codec(dev, f"{name}_CONFIG")
        if codec is not None:
            calls += _later_chunk_calls(name, codec, dev)
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


# the heaviest K1 shapes of chip_smoke.py's main path (launches x device
# time on an H100), and one with a 1024-wide adaptor
HEAVY_SHAPES = [
    Launch("fused_dcb", 1, 136, 240, 512, 512, 512, False, False, False),
    Launch("fused_dcb", 1, 68, 120, 512, 512, 512, False, False, False),
    Launch("fused_dcb", 1, 136, 240, 512, 512, 256, False, False, False),
    Launch("fused_dcb_stacked", 8, 136, 240, 256, 256, 256, False, False,
           False),
    Launch("fused_dcb", 1, 136, 240, 384, 384, 384, False, False, False),
    Launch("fused_dcb", 1, 68, 120, 768, 768, 768, False, False, False),
    Launch("fused_dcb", 1, 136, 240, 1024, 512, 256, True, False, False),
]
SWEEP_TILES = [None, (128, 256), (128, 128), (128, 64), (64, 256),
               (64, 128), (64, 64)]


def run_tiles(dev, iters):
    """Each launch of K1's chain at HEAVY_SHAPES under every tile of
    SWEEP_TILES (None: the plan's own), device ms by torch.profiler, and
    the whole call by CUDA events; then K1's host time per call at a
    small shape (back-to-back calls, the card idle most of the time)."""
    gen = torch.Generator().manual_seed(0)
    for key in HEAVY_SHAPES:
        x, p, _, _ = block_inputs(key, gen, dev)
        if key.kind == "fused_dcb":
            ops, xs, lead = K1.prepare_operands(p), x, ()
        else:
            ops, xs, lead = K1.prepare_operands_stacked(p), x[:, 0], (key.s,)
        for tile in SWEEP_TILES:
            def run():
                return K1._launch(xs, ops, key.shortcut, lead, tile=tile)
            with torch.inference_mode():
                ms = profile_launches(run)
                t = cuda_ms(run, iters)
            plan = K1.k1_plan(key.s, key.h, key.w, key.cin, key.c,
                              key.inner, key.adaptor, tile)
            tiles = {q.name: (q.bm, q.bn, q.stages) for q in plan}
            print(json.dumps({"shape": str(key), "tile": tile,
                              "plan": tiles, "call_ms": t,
                              "kernels_ms": ms,
                              "kernel_sum_ms": sum(ms.values())}),
                  flush=True)
    key = Launch("fused_dcb", 1, 12, 20, 128, 128, 128, False, False, False)
    x, p, run, _ = block_inputs(key, gen, dev)
    ops = K1.prepare_operands(p)

    def host_ms(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return ms
    with torch.inference_mode():
        host = {"wrapper": host_ms(run),
                "_launch": host_ms(lambda: K1._launch(x, ops, False, ())),
                "torch.empty x2": host_ms(lambda: (
                    torch.empty((1 << 20,), dtype=torch.uint8, device=dev),
                    torch.empty((1 << 16,), dtype=torch.bfloat16,
                                device=dev)))}
        device = cuda_ms(run, iters)
    print(json.dumps({"host_ms_per_call": host, "shape": str(key),
                      "call_ms": device}), flush=True)


def k2_clock_summary(clocks):
    """Where K2's cycles go, from the cycle-counting build's per-lane
    fields (kernels.rans_decode.CLOCK_FIELDS) of one call ((n, fields)
    tensor) or of several (a list of them): cycles per symbol of each part
    over every lane, escape-path cycles per escape, the escape share, the
    longest lane's ns per symbol, and the SM clock under load (the longest
    lanes' cycles over their %globaltimer ns, MHz)."""
    from .kernels.rans_decode import CLOCK_FIELDS
    if isinstance(clocks, torch.Tensor):
        clocks = [clocks]
    tot = dict.fromkeys(CLOCK_FIELDS, 0)
    longest = dict.fromkeys(CLOCK_FIELDS, 0)
    for clk in clocks:
        lanes = [dict(zip(CLOCK_FIELDS, row)) for row in clk.cpu().tolist()]
        for k in CLOCK_FIELDS:
            tot[k] += sum(r[k] for r in lanes)
        lane = max(lanes, key=lambda r: r["total"])
        for k in CLOCK_FIELDS:
            longest[k] += lane[k]
    sym = max(tot["symbols"], 1)
    return {"symbols": tot["symbols"], "escapes": tot["escapes"],
            "escape_share": tot["escapes"] / sym,
            "cycles_per_symbol": {k: tot[k] / sym for k in (
                "search", "update", "escape", "store", "total")},
            "escape_cycles_per_escape": tot["escape"] / max(tot["escapes"],
                                                            1),
            "longest_lane_symbols": longest["symbols"],
            "longest_lane_ns_per_symbol": longest["ns"] / max(
                longest["symbols"], 1),
            "sm_clock_mhz": 1e3 * longest["total"] / max(longest["ns"], 1)}


def k2_clocks_of_calls(calls):
    """Each recorded K2 call (K2Call) through the cycle-counting build,
    its symbols and lane state checked against the production build's.
    Returns [(label, signature, clocks)]."""
    from .kernels import rans_decode as K2
    out = []
    for c in calls:
        args = c.args()
        st_p, out_p = K2.rans_decode_launch(*args)
        st_c, out_c, clk = K2.rans_decode_clocks(*args)
        if not (torch.equal(out_p, out_c) and torch.equal(st_p["st"],
                                                          st_c["st"])
                and torch.equal(st_p["ptr"], st_c["ptr"])):
            raise AssertionError(f"K2's cycle-counting build disagrees with "
                                 f"the production build on {c.label}")
        out.append((c.label, c.signature(), clk))
    return out


def run_k2_clocks_dmci(dev):
    """The K2 calls of one 1080p DMCI device decode (qp 32, seeded random
    weights, bf16) recorded and replayed through the cycle-counting build;
    prints each call's breakdown and kernel ms, and the sum."""
    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    x = smooth_frame(H, W, 0, dev)
    res = dmci.compress(x, QP)
    bits = bytes(res["bit_stream"])
    log = K2Log()
    dmci.device_ec = True
    with log:
        log.label = "DMCI 1080p device decode"
        lanes = dmci.upload_stream(bits, res["ec_parallel"])
        out = dmci.decompress(lanes, QP, H, W, res["ec_parallel"])
    dmci.device_ec = False
    if not torch.equal(out["x_hat"], res["x_hat"]):
        raise AssertionError("the DMCI device decode differs from the "
                             "encoder")
    per_call = k2_clocks_of_calls(log.calls)
    from .kernels import rans_decode as K2
    for i, (call, (label, sig, clk)) in enumerate(zip(log.calls, per_call)):
        ms = cuda_ms(lambda: K2.rans_decode_launch(*call.args()), iters=5,
                     warmup=1)
        print(json.dumps({"k2_clocks": f"{label} call {i}",
                          "lanes_bytes_cap_rows": sig, "kernel_ms": ms,
                          **k2_clock_summary(clk)}), flush=True)
    print(json.dumps({"k2_clocks": "DMCI 1080p device decode, all calls",
                      **k2_clock_summary([c for _, _, c in per_call])}),
          flush=True)


def run_k2(dev, symbols, lanes, clocks=False):
    """K2 on a synthetic stream: `symbols` y symbols (rows uniform over the
    128 Gaussian CDFs, values ~ N(0, 6) rounded, |v| <= 127, so some
    escape) coded by the host encoder over `lanes` lanes; the kernel
    against the host decoder and timed (CUDA events), the plain version
    timed once (host clock), and the latency bound."""
    import numpy as np
    from .entropy.gaussian import GaussianConditional
    from .kernels import rans_decode as K2
    from .rans import RansEncoder
    from .rans.device_decode import init_state, upload_lanes
    cdf, lengths = GaussianConditional(0.15).compute_cdf_bank()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 128, symbols).astype(np.uint8)
    sym = np.clip(np.round(rng.normal(0, 6, symbols)), -127, 127).astype(
        np.int8)
    enc = RansEncoder()
    enc.set_cdf(cdf, lengths, 1)
    enc.set_parallel(lanes)
    enc.reset()
    enc.encode_y(((sym.astype(np.int16) << 8) | idx).astype(np.int16))
    enc.flush()
    stream = enc.get_encoded_stream()
    lane_t = upload_lanes(stream, lanes, dev)
    args = (torch.from_numpy(idx).to(dev),
            torch.tensor(symbols, dtype=torch.int32, device=dev),
            K2.make_bank(cdf, lengths, dev))
    state0 = init_state(lane_t)
    _, out = K2.rans_decode(state0, *args)
    equal = bool(np.array_equal(out.cpu().numpy(), sym))
    k_ms = cuda_ms(lambda: K2.rans_decode(init_state(lane_t), *args),
                   iters=5, warmup=1)
    t0 = time.perf_counter()
    _, out_p = K2.rans_decode_reference(init_state(lane_t), *args)
    p_ms = 1e3 * (time.perf_counter() - t0)
    call = K2Call("synthetic", lane_t, state0["st"], state0["ptr"], *args)
    escapes = k2_lane_escapes(call, out_p)
    longest = k2_lane_sizes(symbols, lanes)[-1]
    max_clock = max_sm_clock_mhz()
    summary = None
    if clocks:
        _, _, clk = K2.rans_decode_clocks(init_state(lane_t), *args)
        summary = k2_clock_summary(clk)
    clock = summary["sm_clock_mhz"] if summary else max_clock
    print(json.dumps({
        "k2_symbols": symbols, "lanes": lanes, "escapes": sum(escapes),
        "stream_bytes": len(stream), "equal_to_host": equal,
        "kernel_ms": k_ms, "plain_ms": p_ms,
        "ns_per_symbol_per_lane": 1e6 * k_ms / longest,
        "bound_ms": k2_latency_bound_ms([call], clock, [escapes]),
        "sm_clock_mhz": clock, "clock_from": "clocks build under load"
        if summary else "nvidia-smi clocks.max.sm",
        "bound_ms_symbols_only_max_clock": k2_latency_bound_ms([call],
                                                               max_clock),
        "max_sm_clock_mhz": max_clock}), flush=True)
    if clocks:
        print(json.dumps({"k2_clocks": f"synthetic {symbols} symbols, "
                          f"{lanes} lanes", **summary}), flush=True)
        run_k2_clocks_dmci(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("shapes", "profile", "k2", "tiles"))
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per shape (shapes)")
    ap.add_argument("--runs", type=int, default=2,
                    help="profiled runs per call (profile)")
    ap.add_argument("--symbols", type=int, default=2_000_000,
                    help="symbols of the synthetic stream (k2)")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lanes of the synthetic stream (k2)")
    ap.add_argument("--clocks", action="store_true",
                    help="k2: also the cycle-counting build's breakdown")
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
    elif args.mode == "k2":
        run_k2(dev, args.symbols, args.lanes, args.clocks)
    elif args.mode == "tiles":
        run_tiles(dev, args.iters)
    else:
        run_profile(dev, args.runs)


if __name__ == "__main__":
    main()
