"""Generalized Divisive Normalization (counterpart of dcvc_tpu/legacy/
gdn.py; reference GDN, DCVC-family/DCVC/src/models/video_net.py:29-90):
y = x / sqrt(beta + gamma x^2) (the inverse multiplies), with
sqrt-reparameterized, lower-bounded parameters.  NHWC tensors.

The parameters are the flax leaves `beta` (C,) and `gamma` (C, C), so a
flax path `a/gdn/beta` is the state_dict key `a.gdn.beta`.  The norm pool
runs in float32 in the JAX order: x^2 times gamma^T (a 1x1 product), plus
beta, square root, then the divide.
"""

import torch
import torch.nn as nn

from ..core.quant import lower_bound


class GDN(nn.Module):
    def __init__(self, ch, inverse=False, beta_min=1e-6, gamma_init=0.1,
                 reparam_offset=2 ** -18):
        super().__init__()
        self.ch, self.inverse = ch, inverse
        self.gamma_init = gamma_init
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        self.beta = nn.Parameter(torch.zeros(ch))
        self.gamma = nn.Parameter(torch.zeros(ch, ch))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        """The flax initialisers: beta = sqrt(1 + pedestal), gamma =
        sqrt(gamma_init * I + pedestal)."""
        self.beta.copy_(torch.sqrt(torch.ones(self.ch) + self.pedestal))
        self.gamma.copy_(torch.sqrt(self.gamma_init * torch.eye(self.ch)
                                    + self.pedestal))

    def forward(self, x):
        beta = lower_bound(self.beta, self.beta_bound) ** 2 - self.pedestal
        gamma = lower_bound(self.gamma, self.gamma_bound) ** 2 \
            - self.pedestal
        xf = x.float()
        norm = torch.sqrt(torch.matmul(xf ** 2, gamma.float().t())
                          + beta.float())
        out = xf * norm if self.inverse else xf / norm
        return out.to(x.dtype)
