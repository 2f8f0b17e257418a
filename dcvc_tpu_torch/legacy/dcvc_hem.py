"""DCVC-HEM (MM'22) building blocks (counterpart of the first part of
dcvc_tpu/legacy/dcvc_hem.py; reference DCVC-family/DCVC-HEM/src/models/
video_net.py): the ResBlock with its slope / start / end / bottleneck
options, the squeeze-excitation layer, the residual conv block and the
SE-augmented UNet that refines the IntraNoAR reconstruction
(legacy/hem_intra.py).  The P-frame model DMCHEM is not ported yet.

NHWC tensors; the module tree mirrors the flax one (legacy/fm_layers.py).
SELayer's Dense layers are nn.Linear (weight (out, in), the transpose of
the flax kernel).
"""

import torch
import torch.nn as nn

from .fm_layers import ConvK, SubpelConv, lrelu, max_pool_2x


class HEMResBlock(nn.Module):
    """video_net ResBlock with slope/start/end/bottleneck options."""

    def __init__(self, channel, slope=0.01, start_from_relu=True,
                 end_with_relu=False, bottleneck=False):
        super().__init__()
        self.slope = slope
        self.start_from_relu = start_from_relu
        self.end_with_relu = end_with_relu
        inner = channel // 2 if bottleneck else channel
        self.conv1 = ConvK(channel, inner)
        self.conv2 = ConvK(inner, channel)

    def _act(self, v):
        if self.slope < 1e-4:
            return torch.relu(v)
        return lrelu(v, self.slope)

    def forward(self, x):
        h = self._act(x) if self.start_from_relu else x
        h = self.conv2(self._act(self.conv1(h)))
        if self.end_with_relu:
            h = self._act(h)
        return x + h


class SELayer(nn.Module):
    def __init__(self, channel, reduction=16):
        super().__init__()
        self.fc1 = nn.Linear(channel, max(channel // reduction, 1),
                             bias=False)
        self.fc2 = nn.Linear(max(channel // reduction, 1), channel,
                             bias=False)

    def forward(self, x):
        y = torch.mean(x, dim=(1, 2))
        y = torch.sigmoid(self.fc2(torch.relu(self.fc1(y))))
        return x * y[:, None, None, :]


class ConvBlockResidual(nn.Module):
    def __init__(self, in_ch, out_ch, se_layer=True):
        super().__init__()
        self.conv1 = ConvK(in_ch, out_ch)
        self.conv2 = ConvK(out_ch, out_ch)
        self.se = SELayer(out_ch) if se_layer else None
        self.up_dim = ConvK(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv2(lrelu(self.conv1(x), 0.01))
        if self.se is not None:
            h = self.se(h)
        return h + self.up_dim(x)


class HEMUNet(nn.Module):
    def __init__(self, in_ch, out_ch=64):
        super().__init__()
        self.conv1 = ConvBlockResidual(in_ch, 32)
        self.conv2 = ConvBlockResidual(32, 64)
        self.conv3 = ConvBlockResidual(64, 128)
        for i in range(4):
            setattr(self, f"context_refine_{i}", HEMResBlock(128, slope=0.0))
        self.up3 = SubpelConv(128, 64, r=2, kernel=1)
        self.up_conv3 = ConvBlockResidual(128, 64)
        self.up2 = SubpelConv(64, 32, r=2, kernel=1)
        self.up_conv2 = ConvBlockResidual(64, out_ch)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool_2x(x1))
        x3 = self.conv3(max_pool_2x(x2))
        for i in range(4):
            x3 = getattr(self, f"context_refine_{i}")(x3)
        u3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=-1))
        u2 = self.up2(u3)
        return self.up_conv2(torch.cat([x1, u2], dim=-1))
