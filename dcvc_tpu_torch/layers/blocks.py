"""NN building blocks on NHWC tensors (reference src/layers/layers.py).

Parameters keep the reference torch layout and names (conv weights
(O, I, kh, kw), DepthConvBlock internals `dc.0/2/3`, `ffn.0/2`,
`adaptor`), so a state_dict of the reference module tree loads as is.
A 1x1 conv is a matmul on the channel dim; a 3x3 conv runs F.conv2d on
an NCHW view.  A DepthConvBlock in bfloat16 at batch 1 on the card goes
through kernels.fused_dcb.fused_dcb, and a StackedDCB through
fused_dcb_stacked (the hand-written CUDA kernel); every other block, on
the CPU or in the float32 training forwards, runs the plain PyTorch
version (`kernel_path`).  DCVC-RT's two-way block (legacy/dcvc_rt.py)
shares `K1Block` with DepthConvBlock and takes the same route where its
channel counts are multiples of 16.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.shuffle import pixel_shuffle, pixel_unshuffle
from ..kernels.fused_dcb import fused_dcb, fused_dcb_reference, \
    fused_dcb_stacked, fused_dcb_stacked_reference, prepare_operands, \
    prepare_operands_stacked, wsilu_f32


def kernel_path(x, batch):
    """True where a DepthConvBlock runs K1: a bfloat16 tensor off the CPU
    (on the card, or on the meta device where perf_probe derives the
    launches) at batch 1, the inference form dcvc_tpu's gate (layers/blocks.py
    _fused_ok) sends to its Pallas kernel.  Anything else, the float32
    training forwards at batch > 1 among them, takes the plain block,
    which autograd differentiates (K1 has no backward, as the TPU kernel
    has none)."""
    return x.device.type != "cpu" and x.dtype == torch.bfloat16 \
        and batch == 1


class WSiLU(nn.Module):
    """Weighted SiLU: x * sigmoid(4x) (reference WSiLU, layers.py:106-111)."""

    def forward(self, x):
        return wsilu_f32(x)


class Conv1x1(nn.Module):
    """1x1 conv as a channel matmul; weight (O, I, 1, 1) as in torch."""

    def __init__(self, in_ch, out_ch, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def matrix(self):
        """(I, O) view of the weight."""
        return self.weight[:, :, 0, 0].t()

    def forward(self, x):
        y = torch.matmul(x, self.matrix())
        return y if self.bias is None else y + self.bias


class Conv3x3(nn.Module):
    """3x3 conv with padding 1, optionally strided."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=self.stride, padding=1)
        return y.permute(0, 2, 3, 1)


class Conv2x2Stride2(nn.Module):
    """2x2 conv with stride 2 and no padding (DCVC-RT's
    ResidualBlockWithStride2 down)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class DepthwiseConv3x3(nn.Module):
    """Weights of a per-channel 3x3 conv, (C, 1, 3, 3) and (C); the
    DepthConvBlock's kernel (or its plain version) applies them."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(ch, 1, 3, 3))
        self.bias = nn.Parameter(torch.zeros(ch))


class K1Block(nn.Module):
    """A DepthConvBlock's module tree as K1 reads it (`adaptor`, `dc.0/2/3`,
    `ffn.0/2`), shared by DepthConvBlock and DCVC-RT's two-way block: its
    weights in the layout of kernels/fused_dcb.py, and the kernel's
    operands made from them."""

    def block_params(self):
        """Weights in the layout of kernels/fused_dcb.py: 1x1 kernels
        (Cin, Cout), dw kernel (3, 3, I), ffn_in (C, 4I) as ffn.0 stores
        it (UF: output channel c*4 + j; RT: j*2C + c)."""
        dw = self.dc[2]
        p = {"w1": self.dc[0].matrix(), "b1": self.dc[0].bias,
             "wd": dw.weight[:, 0].permute(1, 2, 0), "bd": dw.bias,
             "w2": self.dc[3].matrix(), "b2": self.dc[3].bias,
             "w3": self.ffn[0].matrix(), "b3": self.ffn[0].bias,
             "w4": self.ffn[2].matrix(), "b4": self.ffn[2].bias}
        if self.adaptor is not None:
            p["wa"], p["ba"] = self.adaptor.matrix(), self.adaptor.bias
        return p

    def _kernel_operands(self):
        """prepare_operands(block_params()), kept until a parameter is
        moved, cast or written."""
        key = tuple((p.device, p.dtype, p.data_ptr(), p._version)
                    for p in self.parameters())
        if getattr(self, "_ops_key", None) != key:
            with torch.no_grad():
                self._ops = prepare_operands(self.block_params())
            self._ops_key = key
        return self._ops


class DepthConvBlock(K1Block):
    """Depth-conv block (reference DepthConvBlock, layers.py:128-159).

    dc branch:  1x1 -> WSiLU -> dw3x3 -> 1x1, residual.
    ffn branch: 1x1 (4x inner width) -> WSiLU -> 4-way chunk add -> 1x1,
                residual.  dcb2 halves the inner width.
    """

    def __init__(self, in_ch, out_ch, dcb2=False, shortcut=False,
                 force_adaptor=False):
        super().__init__()
        assert not (dcb2 and shortcut)
        inner = out_ch // (2 if dcb2 else 1)
        self.shortcut = shortcut
        self.adaptor = Conv1x1(in_ch, out_ch) \
            if in_ch != out_ch or force_adaptor else None
        self.dc = nn.Sequential(Conv1x1(out_ch, inner), WSiLU(),
                                DepthwiseConv3x3(inner),
                                Conv1x1(inner, out_ch))
        self.ffn = nn.Sequential(Conv1x1(out_ch, 4 * inner), WSiLU(),
                                 Conv1x1(inner, out_ch))

    def forward(self, x):
        x = x.contiguous()
        if not kernel_path(x, x.shape[0]):
            return fused_dcb_reference(x, self.block_params(),
                                       shortcut=self.shortcut)
        return fused_dcb(x, None, shortcut=self.shortcut,
                         ops=self._kernel_operands())


class StackedDCB:
    """S independent DepthConvBlocks run as one stacked call (reference
    per-frame recon decoders, video_model_ht.py:215-275; dcvc_tpu's
    StackedDCB): on the card one launch of each kind of the stacked
    kernel for all S entries, on the CPU the plain version per entry.

    The blocks stay where the reference module tree keeps them (the recon
    head's `conv1.{i}.{m}` / `conv2.{i}.{m}`), so a reference state_dict
    loads as is; this object only holds them in stack order and adds no
    parameters.  An entry has an adaptor iff in_ch != out_ch, no shortcut
    and no dcb2.

    Input and output: (S, 1, H, W, C); x may be one tensor expanded over
    the stack (stride 0), which the kernel reads without copies."""

    def __init__(self, blocks):
        self.blocks = tuple(blocks)
        for b in self.blocks:
            assert not b.shortcut
        self._ops_key = None

    def stacked_params(self, lo=0, hi=None):
        """block_params() of entries lo..hi-1, stacked on a leading axis."""
        ps = [b.block_params() for b in self.blocks[lo:hi]]
        return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}

    def _kernel_operands(self):
        """prepare_operands_stacked of all S entries, kept until a
        parameter is moved, cast or written."""
        key = tuple((p.device, p.dtype, p.data_ptr(), p._version)
                    for b in self.blocks for p in b.parameters())
        if self._ops_key != key:
            with torch.no_grad():
                self._ops = prepare_operands_stacked(self.stacked_params())
            self._ops_key = key
        return self._ops

    def __call__(self, x, rows=None):
        """rows=(lo, hi): run entries lo..hi-1 only (x then has hi - lo
        entries)."""
        lo, hi = rows if rows is not None else (0, len(self.blocks))
        if not kernel_path(x, x.shape[1]):
            return fused_dcb_stacked_reference(x, self.stacked_params(lo, hi))
        ops = {k: v[lo:hi] for k, v in self._kernel_operands().items()}
        return fused_dcb_stacked(x, None, ops=ops)


class SubpelConv2x(nn.Module):
    """conv (1x1 or 3x3) to 4*out channels -> pixel shuffle 2 (reference
    SubpelConv2x; dcvc_tpu/layers/blocks.py:311-330): a bias iff
    kernel_size > 1 or force_bias."""

    def __init__(self, in_ch, out_ch, kernel_size=1, force_bias=False):
        super().__init__()
        if kernel_size == 1:
            conv = Conv1x1(in_ch, out_ch * 4, bias=force_bias)
        elif kernel_size == 3:
            conv = Conv3x3(in_ch, out_ch * 4)
        else:
            raise ValueError(f"kernel_size {kernel_size}: 1 or 3")
        self.conv = nn.Sequential(conv)

    def forward(self, x):
        return pixel_shuffle(self.conv[0](x), 2)


class ResidualBlockUpsample(nn.Module):
    """SubpelConv2x(1x1) + DepthConvBlock (reference ResidualBlockUpsample)."""

    def __init__(self, in_ch, out_ch, dcb2=False, shortcut=True,
                 force_bias=False):
        super().__init__()
        self.up = SubpelConv2x(in_ch, out_ch, force_bias=force_bias)
        self.conv = DepthConvBlock(out_ch, out_ch, dcb2=dcb2,
                                   shortcut=shortcut)

    def forward(self, x):
        return self.conv(self.up(x))


class ResidualBlockWithStride2(nn.Module):
    """pixel_unshuffle(2) -> 1x1 -> DepthConvBlock (reference RBWS2)."""

    def __init__(self, in_ch, out_ch, dcb2=False, shortcut=True):
        super().__init__()
        self.down = Conv1x1(in_ch * 4, out_ch)
        self.conv = DepthConvBlock(out_ch, out_ch, dcb2=dcb2,
                                   shortcut=shortcut)

    def forward(self, x):
        return self.conv(self.down(pixel_unshuffle(x, 2)))


@torch.no_grad()
def lecun_init_(module, generator):
    """Random init of every conv in `module` as flax's defaults do it:
    lecun-normal kernels (normal truncated at 2 std, variance 1/fan_in)
    and zero biases.  Draws from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, (Conv1x1, Conv3x3, Conv2x2Stride2,
                          DepthwiseConv3x3)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
