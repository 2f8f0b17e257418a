"""The encode call's share of the chip's bf16 peak: the FLOPs of the
encode path, counted by FlopCounterMode on the frozen reference at the
cell's shapes (meta device), times the requests encoded, over the
encode calls' time, over 989 TFLOP/s (H100 SXM, dense bf16)."""

from benchmark.reference.counts import PEAK_BF16_FLOPS
from benchmark.tracing import call_us

LAYER = "whole coding call"
MOVES = "encode_fps"
UNIT = "%"
KIND = "enc"


def read(trace):
    wall_s = call_us(trace, KIND) / 1e6
    flops = trace.work.get(f"flops.{KIND}")
    if wall_s <= 0 or not flops:
        return None
    return 100.0 * flops * trace.requests[KIND] / wall_s / PEAK_BF16_FLOPS
