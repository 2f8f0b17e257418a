"""The roofline bound of DCVC-RT's two-way DepthConvBlock, the twin of
counts.k1_bound_ms for RT's FFN, and the sum of it over the blocks a
coding call of the frozen reference runs.  Frozen with the benchmark.
"""

import torch

from .counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from .dcvc_rt import DepthConvBlockRT

# {kind: the bound in ms of one request's two-way blocks}, left by the
# configuration module's work functions (configs/dcvc_rt.py), which the
# harness runs before it reads a trace
REQUEST_BOUND_MS = {}


def dcb_rt_bound_ms(h, w, cin, c, adaptor):
    """(ms at the bf16 peak for a two-way DepthConvBlock's matrix-product
    and depthwise FLOPs, ms at the memory rate for its bytes: x read once,
    weights and biases read once, the output written once; all bf16) on
    an (h, w) grid.  The dc trunk's two 1x1s (c x c each), the FFN's c to
    4c and 2c to c, and the adaptor's cin to c where there is one.  The
    block's bound is the larger of the two."""
    pix = h * w
    macs = c * c + c * c + c * 4 * c + 2 * c * c
    # biases: dc 1x1, dw, dc 1x1 (c each), ffn in (4c), ffn out (c)
    weights = macs + 9 * c + 8 * c
    if adaptor:
        macs += cin * c
        weights += cin * c + c
    flops = pix * (2 * macs + 2 * 9 * c)
    nbytes = 2 * (pix * cin + weights + pix * c)
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S


def bound_ms(model, fn):
    """fn() run once through `model` (the reference, on meta tensors): the
    sum, over every two-way block it runs, of dcb_rt_bound_ms's larger
    term."""
    total = [0.0]

    def hook(mod, args):
        x = args[0]
        c = mod.dc[0].weight.shape[0]
        total[0] += max(dcb_rt_bound_ms(x.shape[1], x.shape[2], x.shape[3],
                                        c, mod.adaptor is not None))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, DepthConvBlockRT)]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]
