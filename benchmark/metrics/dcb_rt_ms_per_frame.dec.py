"""Device time of the kernels launched inside the program's dcb.rt spans
(DCVC-RT's two-way DepthConvBlock, plain ops) in the traced decode
calls, per frame decoded (span_kernels.py)."""

from benchmark import span_kernels

LAYER = "kernels"
MOVES = "decode_fps"
UNIT = "ms/frame"
KIND = "dec"


def read(trace):
    us = span_kernels.span_kernel_us(trace, KIND, "dcb.rt",
                                     span_kernels.profiler_events())
    if not us or not trace.frames[KIND]:
        return None
    return us / 1e3 / trace.frames[KIND]
