"""SpyNet optical flow (counterpart of dcvc_tpu/legacy/spynet.py;
reference ME_Spynet / MEBasic, DCVC-family/DCVC/src/models/
video_net.py:204-259): a 4-level coarse-to-fine pyramid; each level
refines the upsampled flow with a 5-layer conv stack over [target, warped
reference, flow].  The classic family uses 7x7 convs at every level;
DC / FM shrink the two finest to 5x5 (level_kernels (7, 7, 5, 5)).

The modules mirror the flax tree (`moduleBasic_{level}.conv{i}`), each
conv an explicit k // 2 pad.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fm_layers import Conv
from .ops import avg_pool_2x, bilinear_upsample_2x, flow_warp


class MEBasic(nn.Module):
    def __init__(self, kernel=7):
        super().__init__()
        chans = [8, 32, 64, 32, 16, 2]
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    Conv(chans[i], chans[i + 1], kernel, padding=kernel // 2))

    def forward(self, x):
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.conv5(x)


class MESpynet(nn.Module):
    """(im1, im2) (B, H, W, 3) -> flow (B, H, W, 2) warping im2 toward im1.
    level_kernels: each level's conv size, coarsest first (None: 7x7
    everywhere)."""

    def __init__(self, levels=4, level_kernels=None):
        super().__init__()
        self.levels = levels
        for level in range(levels):
            k = level_kernels[level] if level_kernels is not None else 7
            setattr(self, f"moduleBasic_{level}", MEBasic(k))

    def forward(self, im1, im2):
        im1_list, im2_list = [im1], [im2]
        for _ in range(self.levels - 1):
            im1_list.append(avg_pool_2x(im1_list[-1]))
            im2_list.append(avg_pool_2x(im2_list[-1]))
        b, h_c, w_c, _ = im2_list[-1].shape
        flow = torch.zeros(b, h_c // 2, w_c // 2, 2, dtype=torch.float32,
                           device=im1.device)
        for level in range(self.levels):
            flow_up = bilinear_upsample_2x(flow) * 2.0
            ref = im1_list[self.levels - 1 - level]
            warped = flow_warp(im2_list[self.levels - 1 - level], flow_up)
            inp = torch.cat([ref, warped, flow_up.to(ref.dtype)], dim=-1)
            flow = flow_up + getattr(self, f"moduleBasic_{level}")(inp)
        return flow
