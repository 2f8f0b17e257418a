"""Shared compression-model pieces of the DMCI and DMC-HTS inference
paths (counterpart of dcvc_tpu/models/common.py).

Only what inference needs: the prior splits, the quant-step ladder init,
and the z prior's parameter bank.  The training losses wait for the
training port.
"""

import numpy as np
import torch
import torch.nn as nn


class BitEstimatorModule(nn.Module):
    """Parameter holder of the factorized z prior (reference BitEstimator):
    banks h, b of shape (qp_num, C, 4) and a of shape (qp_num, C, 3).  The
    codec turns them into a CDF bank with entropy/bit_estimator.py."""

    def __init__(self, qp_num, channel):
        super().__init__()
        self.h = nn.Parameter(torch.zeros(qp_num, channel, 4))
        self.b = nn.Parameter(torch.zeros(qp_num, channel, 4))
        self.a = nn.Parameter(torch.zeros(qp_num, channel, 3))

    def bank(self):
        """{h, b, a} as float32 numpy arrays."""
        return {k: getattr(self, k).detach().float().cpu().numpy()
                for k in ("h", "b", "a")}


def separate_prior_image(params):
    """(..., 2C) prior -> (scales, means), each (..., C)."""
    scales, means = params.chunk(2, dim=-1)
    return scales, means


def separate_prior_video_infer(params):
    """(..., 3C) fused video prior -> (q_enc, q_dec, scales, means): the
    per-position quant step is bounded below by 0.5 in f32 (the
    inference form of lower_bound) and q_enc is its reciprocal."""
    quant_step, scales, means = params.chunk(3, dim=-1)
    q_dec = torch.clamp_min(quant_step.float(), 0.5)
    return 1.0 / q_dec, q_dec, scales, means


def q_ladder_init(lo, hi, qp_num, ch, inverse=False):
    """(qp_num, ch) quant-step bank: rows log-spaced lo -> hi along the QP
    axis (their reciprocals when `inverse`), as dcvc_tpu's q_ladder_init
    seeds the per-QP rows."""
    row = np.exp(np.linspace(np.log(lo), np.log(hi), qp_num))
    if inverse:
        row = 1.0 / row
    return torch.from_numpy(np.repeat(row[:, None], ch, 1).astype(np.float32))
