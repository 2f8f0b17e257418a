"""K1's share of its roofline in the encode calls: the sum, over every
DepthConvBlock the frozen reference's encode path runs at the cell's
shapes, of the larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s
(counts.k1_bound_ms), times the requests encoded, over the device time
of K1's kernels (the chain of csrc/fused_dcb.cu, named below) in the
traced encode calls.  The work is counted from the model, so it reads
the same whatever implements a block."""

from benchmark.tracing import kernel_us

LAYER = "kernels"
MOVES = "encode_fps"
UNIT = "%"
KERNELS = r"k1_(adaptor|h|dw|dc_out|ffn_in|ffn_out)(?![a-z_])"


def read(trace):
    device_ms = kernel_us(trace, "enc", KERNELS) / 1e3
    bound = trace.work.get("k1_bound_ms.enc")
    if device_ms <= 0 or not bound:
        return None
    return 100.0 * bound * trace.requests["enc"] / device_ms
