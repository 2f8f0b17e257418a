"""DCVC-RT's two-way DepthConvBlock's share of its roofline in the encode
calls: the sum, over every two-way block the frozen reference's encode
of a request runs at the cell's shapes, of the larger of FLOPs / 989
TFLOP/s and bytes / 3.35 TB/s (counts_rt.dcb_rt_bound_ms), times the
requests encoded, over the device time of the kernels launched inside
the program's dcb.rt spans in the traced encode calls (span_kernels.py).
The work is counted from the model, so it reads the same whatever
implements a block."""

from benchmark import span_kernels
from benchmark.reference import counts_rt

LAYER = "kernels"
MOVES = "encode_fps"
UNIT = "%"
KIND = "enc"


def read(trace):
    us = span_kernels.span_kernel_us(trace, KIND, "dcb.rt",
                                     span_kernels.profiler_events())
    bound = counts_rt.REQUEST_BOUND_MS.get(KIND)
    if not us or not bound:
        return None
    return 100.0 * bound * trace.requests[KIND] / (us / 1e3)

