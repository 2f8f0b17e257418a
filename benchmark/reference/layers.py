"""Plain PyTorch building blocks of the frozen reference (the DCVC layers
of src/layers/layers.py) on NHWC tensors.

Parameters keep the reference torch layout and names (conv weights
(O, I, kh, kw), DepthConvBlock internals `dc.0/2/3`, `ffn.0/2`,
`adaptor`), so one state_dict fits this tree and the program's.

Every product (1x1 as a matmul, 3x3 and depthwise as conv2d) goes
through `Numerics.q`, which is the identity in float32 and rounds both
operands to float8 e4m3 (per-tensor scale) in the lower-precision
control.  Nothing here imports the program.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


class Numerics:
    """How the reference rounds the operands of its products: "f32" keeps
    them, "fp8" rounds each to float8 e4m3 under one scale per tensor
    (amax -> 448), the precision step below the configurations' bf16."""

    def __init__(self, kind="f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {kind!r}: f32 or fp8")
        self.kind = kind

    def q(self, t):
        if self.kind == "f32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-12)
        scale = FP8_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def pixel_unshuffle(x, r):
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r), torch's channel order."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def pixel_shuffle(x, r):
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def padding_size(h, w, p):
    """(pad_bottom, pad_right) rounding (h, w) up to multiples of p."""
    return (h + p - 1) // p * p - h, (w + p - 1) // p * p - w


def pad_replicate(x, pad_b, pad_r):
    """Edge-replicate pad on the bottom and right of an NHWC tensor."""
    if pad_b == 0 and pad_r == 0:
        return x
    out = F.pad(x.permute(0, 3, 1, 2), (0, pad_r, 0, pad_b),
                mode="replicate")
    return out.permute(0, 2, 3, 1)


def pad_to(x, p):
    return pad_replicate(x, *padding_size(x.shape[1], x.shape[2], p))


def wsilu(x):
    return x * torch.sigmoid(4.0 * x)


class Conv1x1(nn.Module):
    def __init__(self, num, in_ch, out_ch, bias=True):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        w = self.weight[:, :, 0, 0].t()
        y = torch.matmul(self.num.q(x), self.num.q(w))
        return y if self.bias is None else y + self.bias


class Conv3x3(nn.Module):
    def __init__(self, num, in_ch, out_ch, stride=1):
        super().__init__()
        self.num = num
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv2d(self.num.q(x.permute(0, 3, 1, 2)),
                     self.num.q(self.weight), self.bias,
                     stride=self.stride, padding=1)
        return y.permute(0, 2, 3, 1)


class DepthwiseConv3x3(nn.Module):
    def __init__(self, num, ch):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(ch, 1, 3, 3))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        y = F.conv2d(self.num.q(x.permute(0, 3, 1, 2)),
                     self.num.q(self.weight), self.bias, padding=1,
                     groups=x.shape[-1])
        return y.permute(0, 2, 3, 1)


class _Act(nn.Module):
    def forward(self, x):
        return wsilu(x)


class DepthConvBlock(nn.Module):
    """dc: 1x1 -> WSiLU -> dw3x3 -> 1x1, residual; ffn: 1x1 to 4x the
    inner width -> WSiLU -> the four chunks summed -> 1x1, residual;
    dcb2 halves the inner width; an adaptor 1x1 where in != out."""

    def __init__(self, num, in_ch, out_ch, dcb2=False, shortcut=False,
                 force_adaptor=False):
        super().__init__()
        inner = out_ch // (2 if dcb2 else 1)
        self.shortcut = shortcut
        self.adaptor = (Conv1x1(num, in_ch, out_ch)
                        if in_ch != out_ch or force_adaptor else None)
        self.dc = nn.Sequential(Conv1x1(num, out_ch, inner), _Act(),
                                DepthwiseConv3x3(num, inner),
                                Conv1x1(num, inner, out_ch))
        self.ffn = nn.Sequential(Conv1x1(num, out_ch, 4 * inner), _Act(),
                                 Conv1x1(num, inner, out_ch))
        self.inner = inner

    def forward(self, x):
        if self.adaptor is not None:
            x = self.adaptor(x)
        out = self.dc(x) + x
        f = wsilu(self.ffn[0](out))
        # the chunk-add: ffn_in's output channel c*4 + j belongs to chunk j
        f = f.reshape(*f.shape[:-1], self.inner, 4).sum(dim=-1)
        out = self.ffn[2](f) + out
        if self.shortcut:
            out = out + x
        return out


class SubpelConv2x(nn.Module):
    def __init__(self, num, in_ch, out_ch, kernel_size=1, force_bias=False):
        super().__init__()
        conv = (Conv1x1(num, in_ch, out_ch * 4, bias=force_bias)
                if kernel_size == 1 else Conv3x3(num, in_ch, out_ch * 4))
        self.conv = nn.Sequential(conv)

    def forward(self, x):
        return pixel_shuffle(self.conv[0](x), 2)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, num, in_ch, out_ch, dcb2=False, shortcut=True,
                 force_bias=False):
        super().__init__()
        self.up = SubpelConv2x(num, in_ch, out_ch, force_bias=force_bias)
        self.conv = DepthConvBlock(num, out_ch, out_ch, dcb2=dcb2,
                                   shortcut=shortcut)

    def forward(self, x):
        return self.conv(self.up(x))


class ResidualBlockWithStride2(nn.Module):
    def __init__(self, num, in_ch, out_ch, dcb2=False, shortcut=True):
        super().__init__()
        self.down = Conv1x1(num, in_ch * 4, out_ch)
        self.conv = DepthConvBlock(num, out_ch, out_ch, dcb2=dcb2,
                                   shortcut=shortcut)

    def forward(self, x):
        return self.conv(self.down(pixel_unshuffle(x, 2)))


PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
MASK_ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def mask_4x(h, w, c, step, device):
    """Boolean (1, h, w, c) quadtree mask of coding step `step`
    (reference get_mask_4x): channel quarter g takes the 2x2 phase
    PHASES[MASK_ORDERS[step][g]]."""
    m = torch.zeros(1, h, w, c, dtype=torch.bool, device=device)
    q = c // 4
    for g in range(4):
        yo, xo = PHASES[MASK_ORDERS[step][g]]
        m[:, yo::2, xo::2, g * q:(g + 1) * q] = True
    return m


def code_step(y, scales, means, mask, skip_thres):
    """One quadtree step at inference (reference process_with_mask with
    the skip): y - means rounded half to even and clamped to int8 where
    the mask holds and scales > skip_thres, else 0; returns this step's
    y_hat contribution (y_q + means on the mask, 0 elsewhere)."""
    coded = mask & (scales > skip_thres)
    y_q = torch.where(coded, torch.round(y - means), torch.zeros_like(y))
    y_q = torch.clamp(y_q, -128.0, 127.0)
    return torch.where(mask, y_q + means, torch.zeros_like(y))


# the std of a unit normal truncated at +-2, which flax's lecun_normal
# divides by so that the truncated draw keeps the variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


def lecun_std(weight):
    """The lecun-normal std of a conv weight (O, I, kh, kw) before the
    truncation at +-2 std: fan_in is I * kh * kw, as flax's default."""
    return math.sqrt(1.0 / weight[0].numel()) / TRUNC_STD
