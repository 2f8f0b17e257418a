"""Device time of K2, the rANS decode kernel of csrc/rans_decode.cu, in
the traced decode calls, per frame decoded."""

from benchmark.tracing import kernel_us

LAYER = "kernels"
MOVES = "decode_fps"
UNIT = "ms/frame"
KERNELS = r"rans_decode_kernel"


def read(trace):
    ms = kernel_us(trace, "dec", KERNELS) / 1e3
    if ms <= 0 or not trace.frames["dec"]:
        return None
    return ms / trace.frames["dec"]
