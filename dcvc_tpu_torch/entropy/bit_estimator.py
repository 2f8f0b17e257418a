"""Factorized prior over z: the 4-layer monotone MLP per (qp, channel)
(reference BitEstimator, entropy_models.py:78-149): its training-time
probability in torch, and its CDF bank.

`compute_cdf_bank` is numpy and a verbatim copy of
`dcvc_tpu.entropy.bit_estimator.BitEstimator.compute_cdf_bank` (whose
package imports jax); tests/test_torch_core.py pins the copy to the
original and the banks to each other byte for byte.
"""

import numpy as np
import torch
import torch.nn.functional as F


def bit_estimator_z_prob(x, h, b, a):
    """Accumulated probability (the monotone CDF network).  x: (..., C);
    h, b broadcastable to (..., C, 4), a to (..., C, 3)."""
    for i in range(4):
        x = x * F.softplus(h[..., i]) + b[..., i]
        if i != 3:
            x = x + torch.tanh(x) * torch.tanh(a[..., i])
    return torch.sigmoid(x)


def bit_estimator_z_fwd(x, h, b, a):
    """P(round(z) = x) = CDF(x + 0.5) - CDF(x - 0.5), computed in f32."""
    dtype = x.dtype
    x, h, b, a = x.float(), h.float(), b.float(), a.float()
    lower = bit_estimator_z_prob(x - 0.5, h, b, a)
    upper = bit_estimator_z_prob(x + 0.5, h, b, a)
    return (upper - lower).to(dtype)


class BitEstimator:
    """Holds the bank shape; params are {h: (Q, C, 4), b: (Q, C, 4),
    a: (Q, C, 3)} numpy arrays."""

    def __init__(self, qp_num, channel):
        self.qp_num = qp_num
        self.channel = channel

    def compute_cdf_bank(self, params, max_value):
        """Build the quantized CDF bank for all (qp, channel) pairs.

        Returns (quantized_cdf (Q*C, max_len+2) int32, cdf_length (Q*C,) int32)
        mirroring BitEstimator.update (entropy_models.py:113-149).
        Offline path: numpy + float64-free, deterministic.
        """
        from .cdf import pmf_to_cdf, MAX_ENTROPY_CODING_VALUE

        h = np.asarray(params["h"], np.float32)  # (Q, C, 4)
        b = np.asarray(params["b"], np.float32)
        a = np.asarray(params["a"], np.float32)
        Q, C = h.shape[:2]

        def cdf_net(x):  # x: (Q, C, N)
            x = x.astype(np.float32)
            for i in range(4):
                sp = np.logaddexp(0.0, h[:, :, i:i + 1]).astype(np.float32)
                x = x * sp + b[:, :, i:i + 1]
                if i != 3:
                    x = x + np.tanh(x) * np.tanh(a[:, :, i:i + 1])
            return 1.0 / (1.0 + np.exp(-x))

        mx = MAX_ENTROPY_CODING_VALUE
        zeros = np.zeros((Q, C, 1), np.float32)
        sym_range = np.full((Q, C, 1), mx, np.int32)
        for i in range(mx, 1, -1):
            neg = cdf_net(zeros - i)
            pos = cdf_net(zeros + i)
            sym_range = np.where((neg < 0.001) & (pos > 0.999), i, sym_range)

        pmf_length = sym_range * 2 + 1                      # (Q, C, 1)
        max_length = mx * 2 + 1
        samples = np.arange(max_length, dtype=np.float32)[None, None, :] - sym_range
        lower = cdf_net(samples - 0.5)
        upper = cdf_net(samples + 0.5)
        pmf = upper - lower                                 # (Q, C, L)
        up_at_range = cdf_net(sym_range.astype(np.float32))
        tail_mass = lower[:, :, :1] + (1.0 - up_at_range[:, :, -1:])

        pmf = pmf.reshape(-1, max_length)
        tail_mass = tail_mass.reshape(-1, 1)
        pmf_length = pmf_length.reshape(-1)
        quantized_cdf = pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        cdf_length = pmf_length + 2
        return quantized_cdf, cdf_length.astype(np.int32)
