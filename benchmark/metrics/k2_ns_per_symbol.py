"""Device time of K2, the rANS decode kernel of csrc/rans_decode.cu, in
the traced decode calls (k2_ms_per_frame's kernels) per symbol: over the
program's entropy.symbols counter, the z and y symbols its encodes coded
in the traced window, every one of whose requests is decoded there
(benchmark/program_spans.py)."""

from benchmark.program_spans import split
from benchmark.tracing import kernel_us

LAYER = "kernels"
MOVES = "decode_fps"
UNIT = "ns/symbol"
KERNELS = r"rans_decode_kernel"


def read(trace):
    sp = split(trace)
    if sp is None:
        return None
    symbols = sp["counters"].get("entropy.symbols", 0)
    us = kernel_us(trace, "dec", KERNELS)
    if symbols <= 0 or us <= 0:
        return None
    return 1e3 * us / symbols
