"""Gaussian conditional entropy model for y latents: scale -> CDF index
and the 128-level CDF bank (reference GaussianEncoder,
entropy_models.py:152-217, and the scale_to_index device mapping).

`get_scale_table` and `GaussianConditional` are verbatim copies of
`dcvc_tpu.entropy.gaussian` (whose package imports jax), pinned by
tests/test_torch_core.py.
"""

import functools
import math

import numpy as np
import torch

SCALE_MIN = 0.11
SCALE_MAX = 16.0
SCALE_LEVEL = 128
# The reference device kernels bake slightly-rounded log constants
# (def_const.h): keep them identical for stream-level conformance.
LOG_SCALE_MIN = -2.2073
LOG_SCALE_MAX = 2.7726
LOG_SCALE_STEP = (LOG_SCALE_MAX - LOG_SCALE_MIN) / (SCALE_LEVEL - 1)

# Bit patterns of the f32 scales at which the reference mapping
# floor((log(clip(s, SCALE_MIN, SCALE_MAX)) - LOG_SCALE_MIN) / LOG_SCALE_STEP)
# steps from k-1 to k (k = 1..126; 127 is never reached because
# log(SCALE_MAX) < LOG_SCALE_MAX).  They were found by evaluating the
# reference's f32 formula (dcvc_tpu.entropy.gaussian.scale_to_index, CPU)
# on every f32 in [SCALE_MIN, SCALE_MAX]; it is monotone there.  A compare
# against them is exact on every device, where a log is not: libm, SLEEF,
# XLA and CUDA logs differ by an ulp near some bin edges, which would
# change symbol indexes.  tests/test_torch_core.py re-derives the table.
_INDEX_THRESHOLD_BITS = (
    0x3dea4884, 0x3df3a705, 0x3dfd6570, 0x3e03c3d0, 0x3e0908c6, 0x3e0e83ae,
    0x3e1436af, 0x3e1a240b, 0x3e204e14, 0x3e26b739, 0x3e2d61fe, 0x3e345107,
    0x3e3b8709, 0x3e4306e0, 0x3e4ad37c, 0x3e52eff3, 0x3e5b5f71, 0x3e64254d,
    0x3e6d44f8, 0x3e76c20d, 0x3e805022, 0x3e8571c2, 0x3e8ac7e8, 0x3e9054b2,
    0x3e961a4d, 0x3e9c1b00, 0x3ea25925, 0x3ea8d736, 0x3eaf97bc, 0x3eb69d64,
    0x3ebdeaee, 0x3ec5833e, 0x3ecd694d, 0x3ed5a039, 0x3ede2b3f, 0x3ee70dbc,
    0x3ef04b2c, 0x3ef9e736, 0x3f01f2d0, 0x3f07252e, 0x3f0c8cbf, 0x3f122ba4,
    0x3f180414, 0x3f1e185e, 0x3f246ae2, 0x3f2afe21, 0x3f31d4b0, 0x3f38f142,
    0x3f4056a0, 0x3f4807b7, 0x3f50078c, 0x3f585948, 0x3f61002e, 0x3f69ffa6,
    0x3f735b3c, 0x3f7d16a4, 0x3f839ad5, 0x3f88de27, 0x3f8e575a, 0x3f940898,
    0x3f99f41b, 0x3fa01c38, 0x3fa68361, 0x3fad2c13, 0x3fb418f2, 0x3fbb4cb7,
    0x3fc2ca37, 0x3fca9466, 0x3fd2ae58, 0x3fdb1b36, 0x3fe3de56, 0x3fecfb30,
    0x3ff6754f, 0x4000283a, 0x40054840, 0x400a9cbf, 0x401027cf, 0x4015eb9e,
    0x401bea71, 0x402226a9, 0x4028a2b3, 0x402f6120, 0x40366498, 0x403dafde,
    0x404545cf, 0x404d2969, 0x40555dc7, 0x405de629, 0x4066c5e0, 0x40700071,
    0x4079997c, 0x4081ca66, 0x4086fb25, 0x408c6108, 0x4091fe2d, 0x4097d4cf,
    0x409de733, 0x40a437c0, 0x40aac8f4, 0x40b19d62, 0x40b8b7bc, 0x40c01acd,
    0x40c7c985, 0x40cfc6db, 0x40d81601, 0x40e0ba33, 0x40e9b6e1, 0x40f30f8c,
    0x40fcc7ec, 0x410371e4, 0x4108b397, 0x410e2b19, 0x4113da8d, 0x4119c43b,
    0x411fea6c, 0x41264f96, 0x412cf634, 0x4133e0ee, 0x413b127b, 0x41428da4,
    0x414a556a, 0x41526cd1, 0x415ad715, 0x41639777, 0x416cb17a, 0x417628ae,
)
INDEX_THRESHOLDS = np.asarray(_INDEX_THRESHOLD_BITS, np.int32).view(np.float32)


def get_scale_table():
    """128 log-spaced scales in [0.11, 16] (exact log endpoints, like the
    Python-side GaussianEncoder.get_scale_table used to build CDFs)."""
    return np.exp(np.linspace(math.log(SCALE_MIN), math.log(SCALE_MAX),
                              SCALE_LEVEL)).astype(np.float32)


def scale_to_index(scale):
    """Map a scale tensor to its CDF index in the 128-level log grid.

    Same result as the reference's f32 clamp-log-floor on every input:
    the number of bin thresholds at or below the f32 scale.  Returns
    int32 in [0, 126].
    """
    s = scale.to(torch.float32)
    return torch.bucketize(s, _thresholds(s.device), right=True).to(
        torch.int32)


@functools.lru_cache(maxsize=None)
def _thresholds(device):
    """INDEX_THRESHOLDS on `device`, copied there once (a copy per call
    would make the device decode wait for the host)."""
    return torch.from_numpy(INDEX_THRESHOLDS).to(device)


class GaussianConditional:
    """Stateless helper bundling the scale table and CDF bank builder."""

    def __init__(self, skip_thres=0.0):
        self.skip_thres = skip_thres
        self.scale_table = get_scale_table()

    def compute_cdf_bank(self):
        """128-level y CDF bank (GaussianEncoder.update, entropy_models.py:184-217)."""
        from .cdf import pmf_to_cdf, MAX_ENTROPY_CODING_VALUE
        from scipy.stats import norm

        mx = MAX_ENTROPY_CODING_VALUE
        scales = self.scale_table.astype(np.float64)      # (128,)
        sym_range = np.full(SCALE_LEVEL, mx, np.int32)
        for i in range(mx, 1, -1):
            probs = norm.cdf(i, loc=0.0, scale=scales)
            sym_range = np.where(probs > 0.999, i, sym_range)

        pmf_length = 2 * sym_range + 1
        max_length = 2 * mx + 1
        samples = (np.arange(max_length)[None, :] - sym_range[:, None]).astype(np.float64)
        upper = norm.cdf(samples + 0.5, loc=0.0, scale=scales[:, None])
        lower = norm.cdf(samples - 0.5, loc=0.0, scale=scales[:, None])
        pmf = (upper - lower).astype(np.float32)
        tail_mass = (2 * lower[:, :1]).astype(np.float32)

        quantized_cdf = pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        cdf_length = (pmf_length + 2).astype(np.int32)
        return quantized_cdf, cdf_length
