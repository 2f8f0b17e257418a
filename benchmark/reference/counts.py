"""The yardstick's arithmetic: the published peaks of one H100 SXM, the
roofline bound of one DepthConvBlock, the 95th percentile, the union of
busy intervals, and the operation counts of a coding call taken from
the frozen reference on the meta device.  Frozen with the benchmark: a
later change to the program changes none of it.
"""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from .layers import DepthConvBlock

# NVIDIA's data sheet, H100 SXM, dense: the bf16 tensor-core rate and the
# HBM3 bandwidth, at the full power limit of 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def k1_bound_ms(h, w, cin, c, inner, adaptor, s=1, bcast=False):
    """(ms at the bf16 peak for a DepthConvBlock's matrix-product and
    depthwise FLOPs, ms at the memory rate for its bytes: x read once
    (once for all s entries when broadcast), weights and biases read
    once, the output written once; all bf16) of s blocks on an (h, w)
    grid.  The block's bound is the larger of the two."""
    pix = h * w
    macs = c * inner + inner * c + 4 * c * inner + inner * c
    weights = macs + 9 * inner + 2 * inner + 4 * inner + 3 * c
    if adaptor:
        macs += cin * c
        weights += cin * c + c
    flops = s * pix * (2 * macs + 2 * 9 * inner)
    x_reads = 1 if bcast else s
    nbytes = 2 * (x_reads * pix * cin + s * weights + s * pix * c)
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S


def percentile(values, q):
    """The q-th percentile of `values`, linear between order statistics
    (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(intervals, lo, hi):
    """The uncovered (start, end) pieces of [lo, hi] between the union of
    `intervals`."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def work(model, fn):
    """fn() run once, on meta tensors through `model`: (its FLOPs as
    FlopCounterMode counts them, the sum over every DepthConvBlock of
    `model` that it runs of k1_bound_ms's larger term)."""
    bound = [0.0]

    def hook(mod, args):
        x = args[0]
        bound[0] += max(k1_bound_ms(
            x.shape[1], x.shape[2], x.shape[3], mod.dc[0].weight.shape[1],
            mod.inner, mod.adaptor is not None))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, DepthConvBlock)]
    counter = FlopCounterMode(display=False)
    try:
        with counter, torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return counter.get_total_flops(), bound[0]
