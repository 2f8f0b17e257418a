"""EVC real-time image codec model (counterpart of dcvc_tpu/legacy/evc.py;
reference DCVC-family/EVC/src/models/): residual up / down blocks and
depth-conv blocks, a hyperprior with a dual (2-pass cross-checkerboard)
spatial prior, per-model q_basic * q_scale anchors (4 rate points,
interpolable).  The base topology with the L / M / S channel plans
(EVC_LL/LM/LS/SL/ML/SS/MM/MS, image_model.py:203-258) and the scalable
encoder (ScalableEVC: enc_num encoders whose latents are averaged,
scalable_encoder_model.py:15-100).  RGB in [0, 1], NHWC.

The modules are named after the reference's keys, the names dcvc_tpu's
key_fn_evc gives the flax leaves (utils/keys.py holds a pinned copy):
the enc / dec blocks wrap depth_conv and conv2 in a Sequential (`.0`),
the hyperprior's blocks do not, and the decoder's last subpel conv is
`dec.7.0`.  Two names differ from a reference state_dict, and
`EVC.from_reference` maps them: the z prior keeps the port's h / b / a
banks (the reference's Bitparm tensors `bit_estimator_z.f{i}.{h,b,a}`
are stacked into them), and q_basic the flax shape (1, 1, 1, N).

The blocks use lrelu / ReLU FFNs, not UF's WSiLU block, so nothing here
runs the fused DepthConvBlock kernel: on the card every layer is a
cuDNN conv or a cuBLAS product in float32.
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.quant import ste_round, z_to_int16
from ..core.shuffle import pixel_shuffle
from ..entropy.gaussian import gaussian_prob_train, probs_to_bits
from ..models import common
from ..utils.keys import key_fn_evc
from .dcvc_hem import dual_prior_train, spatial_params, split_spatial
from .fm_layers import Conv, LReLU, depthwise3x3, ffn_hidden, \
    lecun_init_legacy_, lrelu


@dataclasses.dataclass(frozen=True)
class EVCConfig:
    channels: tuple = (192, 192, 192, 192)   # enc plan: 2x, 4x, 8x, 16x
    dec_channels: tuple = None                # dec plan (None = channels)
    n: int = 192                              # latent/hyper channels
    anchor_num: int = 4
    # scalable-encoder variant (scalable_encoder_model.py): number of
    # progressive encoders and which one the forward uses
    enc_num: int = 1
    forward_enc_id: int = 0

    def __post_init__(self):
        # a config read from a JSON header holds lists
        for name in ("channels", "dec_channels"):
            v = getattr(self, name)
            if isinstance(v, list):
                object.__setattr__(self, name, tuple(v))

    @property
    def dec_plan(self):
        return self.dec_channels or self.channels


# reference channel plans (image_model.py:203-258)
_L = (192, 192, 192, 192)
_M = (128, 128, 192, 192)
_S = (64, 64, 128, 192)

EVC_CONFIG = EVCConfig()
EVC_LL_CONFIG = EVCConfig(channels=_L, dec_channels=_L)
EVC_MM_CONFIG = EVCConfig(channels=_M, dec_channels=_M)
EVC_SS_CONFIG = EVCConfig(channels=_S, dec_channels=_S)
EVC_LM_CONFIG = EVCConfig(channels=_L, dec_channels=_M)
EVC_LS_CONFIG = EVCConfig(channels=_L, dec_channels=_S)
EVC_ML_CONFIG = EVCConfig(channels=_M, dec_channels=_L)
EVC_SL_CONFIG = EVCConfig(channels=_S, dec_channels=_L)
EVC_MS_CONFIG = EVCConfig(channels=_M, dec_channels=_S)
SCALABLE_EVC_CONFIG = EVCConfig(channels=_S, dec_channels=_L, enc_num=4,
                                forward_enc_id=3)
TINY_EVC_CONFIG = EVCConfig(channels=(8, 8, 8, 8), n=8)
TINY_SCALABLE_EVC_CONFIG = EVCConfig(channels=(8, 8, 8, 8), n=8,
                                     enc_num=3, forward_enc_id=2)


def _wrap(m, wrapped):
    return nn.Sequential(m) if wrapped else m


class PixelShuffle(nn.Module):
    """NHWC pixel shuffle as a module (a subpel conv's second layer)."""

    def __init__(self, r):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


class EVCDepthConv(nn.Module):
    """1x1(+lrelu) -> dw(+lrelu) -> 1x1(+lrelu) + (strided) adaptor
    (reference EVC layers.DepthConv).  wrapped: depth_conv and conv2 sit
    in a Sequential, as in the encoder and decoder of the base model."""

    def __init__(self, in_ch, out_ch, stride=1, wrapped=True):
        super().__init__()
        self.conv1 = nn.Sequential(Conv(in_ch, in_ch, 1, stride))
        self.depth_conv = _wrap(depthwise3x3(in_ch), wrapped)
        self.conv2 = _wrap(Conv(in_ch, out_ch, 1), wrapped)
        if stride != 1:
            self.adaptor = Conv(in_ch, out_ch, 2, 2)
        elif in_ch != out_ch:
            self.adaptor = Conv(in_ch, out_ch, 1)
        else:
            self.adaptor = None

    def forward(self, x):
        identity = x if self.adaptor is None else self.adaptor(x)
        h = lrelu(self.conv1(x))
        h = lrelu(self.depth_conv(h))
        h = lrelu(self.conv2(h))
        return h + identity


class EVCConvFFN(nn.Module):
    """1x1 -> ReLU -> 1x1 -> ReLU + residual."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Sequential(Conv(ch, ch * 4, 1), nn.ReLU(),
                                  Conv(ch * 4, ch, 1))

    def forward(self, x):
        return x + torch.relu(self.conv(x))


class EVCDepthConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride=1, wrapped=True):
        super().__init__()
        self.block = nn.Sequential(
            EVCDepthConv(in_ch, out_ch, stride, wrapped), EVCConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class EVCResidualBlockWithStride(nn.Module):
    def __init__(self, in_ch, out_ch, stride=2):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3, stride, 1)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, 1)
        self.downsample = (Conv(in_ch, out_ch, 1, stride) if stride != 1
                           else None)

    def forward(self, x):
        h = lrelu(self.conv1(x))
        h = lrelu(self.conv2(h), 0.1)
        if self.downsample is not None:
            x = self.downsample(x)
        return h + x


class EVCResidualBlockUpsample(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.subpel_conv = nn.Sequential(Conv(in_ch, out_ch * 4, 1),
                                         PixelShuffle(2))
        self.conv = Conv(out_ch, out_ch, 3, 1, 1)
        self.upsample = nn.Sequential(Conv(in_ch, out_ch * 4, 1),
                                      PixelShuffle(2))

    def forward(self, x):
        h = lrelu(self.subpel_conv(x))
        h = lrelu(self.conv(h), 0.1)
        return h + self.upsample(x)


class HyperDepthConv(nn.Module):
    """The hyperprior's DepthConv (hyperprior.py:7-63): 1x1 -> lrelu ->
    dw3x3 -> 1x1 + residual."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Sequential(Conv(in_ch, in_ch, 1), LReLU())
        self.depth_conv = depthwise3x3(in_ch)
        self.conv2 = Conv(in_ch, out_ch, 1)
        self.adaptor = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        identity = x if self.adaptor is None else self.adaptor(x)
        return self.conv2(self.depth_conv(self.conv1(x))) + identity


class HyperConvFFN(nn.Module):
    """The capped ConvFFN (hidden max(min(4C, 1024), 2C), lrelu 0.1)."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Sequential(Conv(ch, ffn_hidden(ch), 1), LReLU(0.1),
                                  Conv(ffn_hidden(ch), ch, 1))

    def forward(self, x):
        return x + lrelu(self.conv(x), 0.1)


class EVCHyperDCB(nn.Module):
    """EVC's hyperprior-side DepthConvBlock: lrelu DepthConv + the capped
    ConvFFN, unlike the enc / dec blocks' plain 4x ReLU FFN."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(HyperDepthConv(in_ch, out_ch),
                                   HyperConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class EVCHyperBlockUpsample(nn.Module):
    """Hyper DCB + subpel upsample (hyperprior.py:66-74)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(HyperDepthConv(in_ch, out_ch),
                                   HyperConvFFN(out_ch),
                                   Conv(out_ch, out_ch * 4, 1))

    def forward(self, x):
        return pixel_shuffle(self.block(x), 2)


def make_encoder(plan, wrapped=True):
    """The analysis transform of one channel plan (2x, 4x, 8x, 16x)."""
    c2, c4, c8, c16 = plan
    return nn.Sequential(
        EVCResidualBlockWithStride(3, c2),
        EVCDepthConvBlock(c2, c2, wrapped=wrapped),
        EVCResidualBlockWithStride(c2, c4),
        EVCDepthConvBlock(c4, c4, wrapped=wrapped),
        EVCResidualBlockWithStride(c4, c8),
        EVCDepthConvBlock(c8, c8, wrapped=wrapped),
        Conv(c8, c16, 3, 2, 1))


class EVC(nn.Module):
    """EVC image codec (reference EVC, image_model.py:16-82)."""

    def __init__(self, cfg=EVC_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        N = c.n
        if c.enc_num > 1:
            # scalable-encoder variant: enc_num progressive encoders, named
            # encs_{i} (key_fn_evc does not wrap their blocks)
            for i in range(c.enc_num):
                setattr(self, f"encs_{i}", make_encoder(c.channels, False))
        else:
            self.enc = make_encoder(c.channels)
        d2, d4, d8, d16 = c.dec_plan
        self.dec = nn.Sequential(
            EVCDepthConvBlock(N, d16),
            EVCResidualBlockUpsample(d16, d8),
            EVCDepthConvBlock(d8, d8),
            EVCResidualBlockUpsample(d8, d4),
            EVCDepthConvBlock(d4, d4),
            EVCResidualBlockUpsample(d4, d2),
            EVCDepthConvBlock(d2, d2),
            nn.Sequential(Conv(d2, 3 * 4, 1), PixelShuffle(2)))
        self.hyper_enc = nn.Sequential(
            EVCHyperDCB(N, N), Conv(N, N, 3, 2, 1), LReLU(),
            Conv(N, N, 3, 2, 1))
        self.hyper_dec = nn.Sequential(
            EVCHyperBlockUpsample(N, N), EVCHyperBlockUpsample(N, N),
            EVCHyperDCB(N, N))
        self.y_prior_fusion = nn.Sequential(
            EVCHyperDCB(N, N * 2), EVCHyperDCB(N * 2, N * 3))
        self.y_spatial_prior = nn.Sequential(
            EVCHyperDCB(N * 4, N * 3), EVCHyperDCB(N * 3, N * 2),
            EVCHyperDCB(N * 2, N * 2))
        self.q_basic = nn.Parameter(torch.ones(1, 1, 1, N))
        self.q_scale = nn.Parameter(torch.ones(c.anchor_num, 1, 1, 1))
        self.bit_estimator_z = common.BitEstimatorModule(1, N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model:
        lecun-normal conv kernels, zero biases, q_basic / q_scale ones, z
        prior banks N(0, 0.01).  Draws from `generator` (a CPU
        torch.Generator)."""
        lecun_init_legacy_(self, generator)
        self.q_basic.fill_(1.0)
        self.q_scale.fill_(1.0)
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    def from_reference(self, state):
        """A reference state_dict (EVC's) -> this model's: the z prior's
        Bitparm tensors (key_fn_evc's `stack_last` entries, each (Q, C, 1,
        1)) stacked on a last axis into the h / b / a banks, as dcvc_tpu's
        importer does, and q_basic reshaped to (1, 1, 1, N); every other
        key as it is."""
        state = self.bit_estimator_z.from_reference(state, key_fn_evc)
        if "q_basic" in state:
            state["q_basic"] = state["q_basic"].reshape(self.q_basic.shape)
        return state

    @property
    def dtype(self):
        return self.q_basic.dtype

    def _curr_q(self, q_scale):
        return q_scale * self.q_basic

    def forward_dual_prior(self, y, means, scales, quant_step):
        """The 2-pass cross-checkerboard prior of the training forward
        (reference common_model.py:76-131).  Returns (y_res, y_q, y_hat,
        scales_hat)."""
        return dual_prior_train(y, quant_step, scales, means,
                                self.y_spatial_prior)

    # ----------------------------------------- inference stage methods
    # (reference image_model.py:131-200; shared by encoder and decoder)

    def _encode_latent(self, x):
        """The single encoder, or the scalable encoders' running mean up to
        forward_enc_id (scalable_encoder_model.py:15-24)."""
        c = self.cfg
        if c.enc_num <= 1:
            return self.enc(x)
        k = c.forward_enc_id
        ys = [getattr(self, f"encs_{i}")(x) for i in range(k + 1)]
        return sum(ys) / (k + 1)

    def analysis(self, x, q_scale):
        """x (1, H, W, 3) padded to 64 -> (y float32, z_int int16)."""
        curr_q = self._curr_q(q_scale).to(self.dtype)
        y = self._encode_latent(x.to(self.dtype)) / curr_q
        return y.float(), z_to_int16(self.hyper_enc(y))

    def prior(self, z_int):
        """z_int -> (q_step lower-bounded at 0.5, scales, means)."""
        params = self.y_prior_fusion(self.hyper_dec(z_int.to(self.dtype)))
        q_step, scales, means = params.chunk(3, dim=-1)
        return torch.clamp_min(q_step, 0.5), scales, means

    def spatial(self, y_hat_0, q_step, scales, means):
        """The second pass's (scales, means) from y_hat part 0."""
        return split_spatial(self.y_spatial_prior(spatial_params(
            y_hat_0, q_step, scales, means, self.dtype)))

    def synthesis(self, y_hat_acc, q_scale):
        y_hat = y_hat_acc * self._curr_q(q_scale).float()
        x_hat = self.dec(y_hat.to(self.dtype))
        return torch.clamp(x_hat.float(), 0.0, 1.0)

    def forward(self, x, q_scale=None):
        """Training forward.  x: (B, H, W, 3) RGB in [0, 1]; q_scale: a
        scalar (the first anchor when None).  x_hat is not clamped."""
        if q_scale is None:
            q_scale = self.q_scale[0, 0, 0, 0]
        curr_q = self._curr_q(q_scale).to(self.dtype)
        y = self._encode_latent(x.to(self.dtype)) / curr_q
        z_hat = ste_round(self.hyper_enc(y))
        params = self.y_prior_fusion(self.hyper_dec(z_hat))
        q_step, scales, means = params.chunk(3, dim=-1)
        _, y_q, y_hat, scales_hat = self.forward_dual_prior(
            y, means, scales, q_step)
        x_hat = self.dec(y_hat * curr_q)
        bits_y = probs_to_bits(gaussian_prob_train(
            y_q, scales_hat)).sum(dim=(1, 2, 3))
        bits_z = probs_to_bits(self.bit_estimator_z.get_prob(
            z_hat, 0)).sum(dim=(1, 2, 3))
        pixel_num = x.shape[1] * x.shape[2]
        bpp_y, bpp_z = bits_y / pixel_num, bits_z / pixel_num
        return {"x_hat": x_hat.float(), "bpp": bpp_y + bpp_z,
                "bpp_y": bpp_y, "bpp_z": bpp_z}
