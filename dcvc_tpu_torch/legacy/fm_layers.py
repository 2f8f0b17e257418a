"""DCVC-FM layer zoo (counterpart of dcvc_tpu/legacy/fm_layers.py;
reference DCVC-family/DCVC-FM/src/models/layers.py, video_net.py):
LeakyReLU-flavoured depth-conv blocks, residual up/down blocks, and the
UNet2 used by ReconGeneration.  NHWC tensors.

The module tree mirrors the flax one: every child is named after its
flax scope (`conv`, `conv1`, `dc`, `ffn`, `layers_{i}` of a Sequential,
...), and every conv leaf is a `Conv` holding `weight` (O, I/groups, kh,
kw) and `bias`, so a flax leaf `a/b/kernel` is the state_dict key
`a.b.weight` (utils/jax_bridge.py: intra_noar_params_from_jax, which
serves any module of this tree).  Flax
Sequentials count their activation lambdas as layers, so `seq` holds
them as parameter-free `LReLU` modules at the same indexes.

Padding is flax's: an explicit k // 2 for a k x k conv, SAME (which
comes to 0 or 1 per side) for the strided 1x1 and 2x2 convs.
"""

import collections
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.shuffle import pixel_shuffle


def lrelu(x, slope=0.01):
    return F.leaky_relu(x, slope)


class LReLU(nn.Module):
    """lrelu as a parameter-free module (a flax Sequential's lambda)."""

    def __init__(self, slope=0.01):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return lrelu(x, self.slope)


def seq(*mods):
    """nn.Sequential whose children are named `layers_{i}`, as flax names
    the layers of its Sequential."""
    return nn.Sequential(collections.OrderedDict(
        (f"layers_{i}", m) for i, m in enumerate(mods)))


def _same_pad(size, k, s):
    """(lo, hi) padding of flax's SAME for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A flax conv leaf (nn.Conv or _PointwiseConv) on NHWC tensors.
    padding: an int (each side) or "same"."""

    def __init__(self, in_ch, out_ch, kernel=1, stride=1, padding="same",
                 groups=1, bias=True):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.groups = groups
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        if self.kernel == 1 and self.stride == 1 and self.groups == 1:
            y = torch.matmul(x, self.weight[:, :, 0, 0].t())
            return y if self.bias is None else y + self.bias
        x = x.permute(0, 3, 1, 2)
        pad = self.padding
        if pad == "same":
            (t, b), (l, r) = (_same_pad(x.shape[d], self.kernel, self.stride)
                              for d in (2, 3))
            if t == b and l == r:
                pad = (t, l)
            else:
                x = F.pad(x, (l, r, t, b))
                pad = 0
        y = F.conv2d(x, self.weight, self.bias, stride=self.stride,
                     padding=pad, groups=self.groups)
        return y.permute(0, 2, 3, 1)


def lecun_init_legacy_(module, generator):
    """Random init of every conv and Dense leaf in `module` as flax's
    defaults do it: lecun-normal kernels (normal truncated at 2 std,
    variance 1/fan_in) and zero biases.  Draws from `generator` in
    module order."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()


@torch.no_grad()
def damp_kernels_(module, scale):
    """Every conv and Dense kernel of `module` times `scale` (the JAX
    codecs' init_scale, applied to each param leaf named `kernel`)."""
    if scale != 1.0:
        for m in module.modules():
            if isinstance(m, (Conv, nn.Linear)):
                m.weight.mul_(scale)


def depthwise3x3(ch):
    """The 3x3 depthwise conv (feature_group_count=ch, padding 1)."""
    return Conv(ch, ch, 3, padding=1, groups=ch)


class ConvK(nn.Module):
    """kxk conv, padding k // 2 (SAME for a strided 1x1); the conv leaf is
    the child `conv`, as flax's ConvK scope holds it."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride,
                         "same" if kernel == 1 else kernel // 2)

    def forward(self, x):
        return self.conv(x)


class SubpelConv(nn.Module):
    """conv(k) to out * r^2 channels -> pixel shuffle r (subpel_conv3x3 /
    1x1)."""

    def __init__(self, in_ch, out_ch, r=2, kernel=3):
        super().__init__()
        self.r = r
        self.conv = ConvK(in_ch, out_ch * r ** 2, kernel)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.r)


class ResBlockFM(nn.Module):
    """lrelu -> conv3x3 -> lrelu -> conv3x3 + residual (reference ResBlock,
    video_net.py:26-44)."""

    def __init__(self, channel, slope=0.01):
        super().__init__()
        self.slope = slope
        self.conv1 = ConvK(channel, channel)
        self.conv2 = ConvK(channel, channel)

    def forward(self, x):
        h = self.conv1(lrelu(x, self.slope))
        h = self.conv2(lrelu(h, self.slope))
        return x + h


class ResidualBlockWithStrideFM(nn.Module):
    """conv3x3(stride) -> lrelu -> conv3x3 -> lrelu(0.1) + strided
    downsample shortcut (reference ResidualBlockWithStride)."""

    def __init__(self, in_ch, out_ch, stride=2):
        super().__init__()
        self.conv1 = ConvK(in_ch, out_ch, stride=stride)
        self.conv2 = ConvK(out_ch, out_ch)
        if stride > 1 or in_ch != out_ch:
            self.downsample = ConvK(in_ch, out_ch, kernel=1, stride=stride)
        else:
            self.downsample = None

    def forward(self, x):
        h = lrelu(self.conv1(x), 0.01)
        h = lrelu(self.conv2(h), 0.1)
        if self.downsample is not None:
            x = self.downsample(x)
        return h + x


class ResidualBlockUpsampleFM(nn.Module):
    """subpel1x1 up -> lrelu -> conv3x3 -> lrelu(0.1) + subpel1x1 shortcut
    (reference ResidualBlockUpsample)."""

    def __init__(self, in_ch, out_ch, r=2):
        super().__init__()
        self.subpel_conv = SubpelConv(in_ch, out_ch, r=r, kernel=1)
        self.conv = ConvK(out_ch, out_ch)
        self.upsample = SubpelConv(in_ch, out_ch, r=r, kernel=1)

    def forward(self, x):
        h = lrelu(self.subpel_conv(x))
        h = lrelu(self.conv(h), 0.1)
        return h + self.upsample(x)


class DepthConvFM(nn.Module):
    """1x1 -> lrelu -> dw3x3 -> 1x1 + residual (reference DepthConv)."""

    def __init__(self, in_ch, out_ch, slope=0.01):
        super().__init__()
        self.slope = slope
        self.adaptor = ConvK(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.conv1 = ConvK(in_ch, in_ch, 1)
        self.depth_conv = depthwise3x3(in_ch)
        self.conv2 = ConvK(in_ch, out_ch, 1)

    def forward(self, x):
        identity = x if self.adaptor is None else self.adaptor(x)
        h = lrelu(self.conv1(x), self.slope)
        h = self.conv2(self.depth_conv(h))
        return h + identity


def ffn_hidden(ch):
    """ConvFFN's capped hidden width: max(min(4C, 1024), 2C)."""
    return max(min(ch * 4, 1024), ch * 2)


class ConvFFNFM(nn.Module):
    """1x1 expand -> lrelu -> 1x1 + residual (reference ConvFFN)."""

    def __init__(self, in_ch, slope=0.1):
        super().__init__()
        self.slope = slope
        self.conv1 = ConvK(in_ch, ffn_hidden(in_ch), 1)
        self.conv2 = ConvK(ffn_hidden(in_ch), in_ch, 1)

    def forward(self, x):
        h = self.conv2(lrelu(self.conv1(x), self.slope))
        return x + lrelu(h, self.slope)


class ConvFFN3FM(nn.Module):
    """Split FFN: two halves at two slopes, added (reference ConvFFN3)."""

    def __init__(self, in_ch):
        super().__init__()
        internal = in_ch * 2
        self.conv = ConvK(in_ch, internal * 2, 1)
        self.conv_out = ConvK(internal, in_ch, 1)

    def forward(self, x):
        x1, x2 = self.conv(x).chunk(2, dim=-1)
        return x + self.conv_out(lrelu(x1, 0.1) + lrelu(x2, 0.01))


class DepthConvBlockFM(nn.Module):
    """DepthConv + ConvFFN (reference DepthConvBlock)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.dc = DepthConvFM(in_ch, out_ch)
        self.ffn = ConvFFNFM(out_ch)

    def forward(self, x):
        return self.ffn(self.dc(x))


class DepthConvBlock4FM(nn.Module):
    """DepthConv + ConvFFN3 (reference DepthConvBlock4)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.dc = DepthConvFM(in_ch, out_ch)
        self.ffn = ConvFFN3FM(out_ch)

    def forward(self, x):
        return self.ffn(self.dc(x))


def max_pool_2x(x):
    """2x2 max pool with stride 2 on an NHWC tensor with even H, W."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class UNet2(nn.Module):
    """3-level UNet over DepthConvBlock4 (reference UNet2,
    video_net.py:168-205); `block` another depth-conv block (DCVC-DC's
    UNet takes DepthConvBlockFM)."""

    def __init__(self, in_ch, out_ch=64, block=DepthConvBlock4FM):
        super().__init__()
        self.conv1 = block(in_ch, 32)
        self.conv2 = block(32, 64)
        self.conv3 = block(64, 128)
        for i in range(4):
            setattr(self, f"context_refine_{i}", block(128, 128))
        self.up3 = SubpelConv(128, 64, r=2, kernel=1)
        self.up_conv3 = block(128, 64)
        self.up2 = SubpelConv(64, 32, r=2, kernel=1)
        self.up_conv2 = block(64, out_ch)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool_2x(x1))
        x3 = self.conv3(max_pool_2x(x2))
        for i in range(4):
            x3 = getattr(self, f"context_refine_{i}")(x3)
        u3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=-1))
        u2 = self.up2(u3)
        return self.up_conv2(torch.cat([x1, u2], dim=-1))
