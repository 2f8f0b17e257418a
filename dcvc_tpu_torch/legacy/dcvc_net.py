"""DCVC baseline (NeurIPS'21), the conditional-coding origin of the
family (counterpart of dcvc_tpu/legacy/dcvc_net.py; reference
DCVC-family/DCVC/src/models/DCVC_net.py).

SpyNet flow (7x7 at every level) -> GDN motion auto-encoder with a
hyperprior and a masked-conv autoregressive entropy model -> flow-warped
feature context -> conditional contextual coding (GDN analysis and
synthesis; the temporal prior, the hyper prior and the AR context fused
by a 1x1 chain; a Laplace y likelihood).  RGB in [0, 1], NHWC.

The module tree mirrors the flax one: a flax Sequential's layers are
`layers_{i}` (its activations parameter-free LReLU modules at their
indexes), so a flax leaf `a/b/kernel` is the state_dict key `a.b.weight`
(utils/jax_bridge.py: dcvc_params_from_jax / _to_jax).  A flax
ConvTranspose is a `Deconv` holding torch ConvTranspose2d's weight (I, O,
kh, kw), which is the flax kernel (kh, kw, I, O) flipped in space; the
masked conv holds a conv weight (O, I, 5, 5).  A reference checkpoint
loads through from_reference (key_fn_dcvc, utils/keys.py).

The stage methods are runtime/dcvc_codec.py's; the AR coding itself runs
on the host there (HostAR, the reference's serial slow path).  forward()
is the eval forward of one P frame on rounded latents, the family
runner's estimated-bits mode.
"""

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.quant import z_to_int16
from ..core.shuffle import pixel_shuffle
from ..models import common
from ..utils.keys import key_fn_dcvc
from .fm_layers import Conv, LReLU, lrelu, seq
from .gdn import GDN
from .ops import flow_warp
from .spynet import MESpynet


@dataclasses.dataclass(frozen=True)
class DCVCConfig:
    ch_mv: int = 128
    ch_n: int = 64
    ch_m: int = 96


DCVC_CONFIG = DCVCConfig()
TINY_DCVC_CONFIG = DCVCConfig(ch_mv=8, ch_n=8, ch_m=8)


class Deconv(nn.Module):
    """flax ConvTranspose with padding (k//2, k//2 + s - 1) and no kernel
    transpose, as torch's ConvTranspose2d(padding=k//2,
    output_padding=s-1) computes it: weight (I, O, kh, kw), the flax
    kernel flipped in space."""

    def __init__(self, in_ch, out_ch, kernel, stride):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                               self.bias, stride=self.stride,
                               padding=self.kernel // 2,
                               output_padding=self.stride - 1)
        return y.permute(0, 2, 3, 1)


def _conv(cin, cout, k, s=1):
    """flax Conv with explicit k // 2 padding."""
    return Conv(cin, cout, k, s, padding=k // 2)


def type_a_mask(k):
    """The PixelCNN type-A mask (k, k): zero at and after the centre tap
    of the centre row, and on every row below."""
    mask = torch.ones(k, k)
    mask[k // 2, k // 2:] = 0
    mask[k // 2 + 1:] = 0
    return mask


class MaskedConv2d(Conv):
    """PixelCNN type-A masked conv (reference layers.py:21-43): weight (O,
    I, k, k), masked at every call."""

    def __init__(self, in_ch, out_ch, kernel=5):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2)

    def forward(self, x):
        w = self.weight * type_a_mask(self.kernel).to(self.weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=self.kernel // 2)
        return y.permute(0, 2, 3, 1) + self.bias


class SubpelConv3x3(nn.Module):
    """3x3 conv to out * r^2 channels -> pixel shuffle r; the conv leaf is
    the child `conv`."""

    def __init__(self, in_ch, out_ch, r=2):
        super().__init__()
        self.r = r
        self.conv = _conv(in_ch, out_ch * r ** 2, 3)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.r)


class ResBlockD(nn.Module):
    """relu -> conv -> relu -> conv + (adapted) residual (video_net
    ResBlock)."""

    def __init__(self, in_ch, out_ch, k=3):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, k)
        self.conv2 = _conv(out_ch, out_ch, k)
        self.adapt_conv = _conv(in_ch, out_ch, 1) if in_ch != out_ch \
            else None

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        if self.adapt_conv is not None:
            x = self.adapt_conv(x)
        return x + h


class ResBlockLRelu(nn.Module):
    """conv -> lrelu(0.1) -> conv -> lrelu(0.1) + identity
    (ResBlock_LeakyReLU_0_Point_1)."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3)
        self.conv2 = _conv(ch, ch, 3)

    def forward(self, x):
        h = lrelu(self.conv1(x), 0.1)
        return x + lrelu(self.conv2(h), 0.1)


def laplace_bits_sum(values, sigma):
    """Reference feature_probs_based_sigma rate estimate
    (DCVC_net.py:200-211): Laplace prob, clamp(-log2, 0, 50), summed per
    sample."""
    sigma = torch.clamp(sigma.float(), 1e-5, 1e10)
    v = values.float()

    def cdf(t):
        return 0.5 + 0.5 * torch.sign(t) * (1.0 - torch.exp(-torch.abs(t)
                                                            / sigma))

    probs = cdf(v + 0.5) - cdf(v - 0.5)
    bits = torch.clamp(-torch.log(probs + 1e-5) / math.log(2.0), 0, 50)
    return torch.sum(bits, dim=(1, 2, 3))


@torch.no_grad()
def init_legacy_(module, generator):
    """Seeded random init of every conv, deconv and masked conv in
    `module`, in module order, as flax's defaults do it: lecun-normal
    kernels (normal truncated at 2 std, variance 1 / fan_in, fan_in =
    kh * kw * in channels) and zero biases; GDN at its own init."""
    for m in module.modules():
        if isinstance(m, (Conv, Deconv)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, Conv) \
                else w.shape[0] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, GDN):
            m.reset_parameters()


@torch.no_grad()
def damp_legacy_(module, scale):
    """Every conv, deconv and masked-conv kernel of `module` times `scale`
    (the JAX codecs' init_scale on each param leaf named `kernel`)."""
    for m in module.modules():
        if isinstance(m, (Conv, Deconv)):
            m.weight.mul_(scale)


def z_bits_sum(z, estimator):
    """The factorized z prior's rate estimate of z (qp 0): clamp(-log2(p +
    1e-5), 0, 50), summed per sample."""
    probs = estimator.get_prob(z, 0)
    bits = torch.clamp(-torch.log(probs + 1e-5) / math.log(2.0), 0, 50)
    return torch.sum(bits, dim=(1, 2, 3))


def _prior_encoder(cin, n):
    return seq(_conv(cin, n, 3), LReLU(), _conv(n, n, 5, 2), LReLU(),
               _conv(n, n, 5, 2))


def _entropy_parameters(c):
    return seq(_conv(c * 12 // 3, c * 10 // 3, 1), LReLU(),
               _conv(c * 10 // 3, c * 8 // 3, 1), LReLU(),
               _conv(c * 8 // 3, c * 6 // 3, 1))


def _gdn_ladder(cin, n, cout, k, s, lrelu_blocks=()):
    """conv/GDN ladder of four convs (k, stride s) with a GDN after each
    of the first three and a ResBlockLRelu after the GDNs listed."""
    layers = []
    for i in range(4):
        c_in, c_out = (cin if i == 0 else n), (cout if i == 3 else n)
        layers.append(_conv(c_in, c_out, k, s))
        if i < 3:
            layers.append(GDN(n))
            if i in lrelu_blocks:
                layers.append(ResBlockLRelu(n))
    return seq(*layers)


class DCVCNet(nn.Module):
    """DCVC baseline P-frame model."""

    def __init__(self, cfg=DCVC_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        N, M, MV = c.ch_n, c.ch_m, c.ch_mv
        self.optic_flow = MESpynet()
        self.feature_extract = seq(_conv(3, N, 3), ResBlockD(N, N))
        self.context_refine = seq(ResBlockD(N, N), _conv(N, N, 3))
        self.mv_encoder = _gdn_ladder(2, MV, MV, 3, 2)
        mv_dec = []
        for i in range(4):
            mv_dec.append(Deconv(MV, 2 if i == 3 else MV, 3, 2))
            if i < 3:
                mv_dec.append(GDN(MV, inverse=True))
        self.mv_decoder_part1 = seq(*mv_dec)
        ref_net = [_conv(5, 64, 3)]
        for _ in range(5):
            ref_net += [LReLU(), _conv(64, 64, 3)]
        self.mv_decoder_part2 = seq(*ref_net, LReLU(), _conv(64, 2, 3))
        # the conv5s2 / GDN ladder with ResBlock_LeakyReLU_0_Point_1
        # blocks after the first two GDNs (DCVC_net.py:80-90)
        self.contextual_encoder = _gdn_ladder(3 + N, N, M, 5, 2,
                                              lrelu_blocks=(0, 1))
        self.contextual_decoder_part1 = seq(
            SubpelConv3x3(M, N), GDN(N, inverse=True),
            SubpelConv3x3(N, N), GDN(N, inverse=True), ResBlockLRelu(N),
            SubpelConv3x3(N, N), GDN(N, inverse=True), ResBlockLRelu(N),
            SubpelConv3x3(N, N))
        self.contextual_decoder_part2 = seq(
            _conv(2 * N, N, 3), ResBlockD(N, N), ResBlockD(N, N),
            _conv(N, 3, 3))
        self.prior_encoder = _prior_encoder(M, N)
        self.prior_decoder = seq(
            Deconv(N, M, 5, 2), LReLU(), Deconv(M, M, 5, 2), LReLU(),
            Deconv(M, M, 3, 1))
        self.mv_prior_encoder = _prior_encoder(MV, N)
        self.mv_prior_decoder = seq(
            Deconv(N, N, 5, 2), LReLU(), Deconv(N, N * 3 // 2, 5, 2),
            LReLU(), Deconv(N * 3 // 2, MV * 2, 3, 1))
        self.temporal_prior_encoder = _gdn_ladder(N, N, M, 5, 2)
        self.auto_regressive = MaskedConv2d(M, M * 2)
        self.auto_regressive_mv = MaskedConv2d(MV, MV * 2)
        self.entropy_parameters = _entropy_parameters(M)
        self.entropy_parameters_mv = _entropy_parameters(MV)
        self.bit_estimator_z = common.BitEstimatorModule(1, N)
        self.bit_estimator_z_mv = common.BitEstimatorModule(1, N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model
        (init_legacy_), the z prior banks N(0, 0.01).  Draws from
        `generator` (a CPU torch.Generator)."""
        init_legacy_(self, generator)
        for be in (self.bit_estimator_z, self.bit_estimator_z_mv):
            for p in be.parameters():
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @torch.no_grad()
    def damp_(self, scale):
        """Every conv, deconv and masked-conv kernel times `scale` (the JAX
        codec's init_scale on each param leaf named `kernel`)."""
        damp_legacy_(self, scale)

    def from_reference(self, state):
        """A reference state_dict (DCVC_net.py's module tree) -> this
        model's: the z priors' Bitparm tensors stacked into their h / b /
        a banks, every other tensor renamed (conv and ConvTranspose2d
        weights keep their torch layouts); the masked convs' `.mask`
        buffers are constants and dropped."""
        from .dcvc_fm import state_from_reference
        state = {k: v for k, v in state.items() if not k.endswith(".mask")}
        return state_from_reference(self, state, key_fn_dcvc)

    @property
    def dtype(self):
        return self.bit_estimator_z.h.dtype

    def motion_compensation(self, ref, mv):
        ref_feature = self.feature_extract(ref.to(self.dtype))
        return self.context_refine(flow_warp(ref_feature, mv))

    # ------------------------------------------- inference stage methods
    # (the reference compress / decompress, DCVC_net.py:331-414; the
    # masked-conv AR coding runs on the host, runtime/dcvc_codec.py)

    def mv_analysis(self, x, ref):
        """Encoder-only: flow, mv encoding and its hyper encoder ->
        (mv_feature float32, mv_z_int int16)."""
        est_mv = self.optic_flow(x.to(self.dtype), ref.to(self.dtype))
        mv_feature = self.mv_encoder(est_mv)
        return mv_feature.float(), z_to_int16(
            self.mv_prior_encoder(mv_feature))

    def mv_prior(self, mv_z_int):
        return self.mv_prior_decoder(mv_z_int.to(self.dtype)).float()

    def mv_synthesis(self, mv_y_hat, ref):
        """mv decode + refine + motion compensation + temporal prior ->
        (context, temporal params float32)."""
        mv_up = self.mv_decoder_part1(mv_y_hat.to(self.dtype))
        refined = self.mv_decoder_part2(torch.cat(
            [mv_up, ref.to(self.dtype)], dim=-1)) + mv_up
        context = self.motion_compensation(ref, refined)
        return context, self.temporal_prior_encoder(context).float()

    def ctx_analysis(self, x, context):
        """Encoder-only: -> (feature float32, z_int int16)."""
        feature = self.contextual_encoder(torch.cat(
            [x.to(self.dtype), context], dim=-1))
        return feature.float(), z_to_int16(self.prior_encoder(feature))

    def ctx_prior(self, z_int):
        return self.prior_decoder(z_int.to(self.dtype)).float()

    def synthesis(self, y_hat, context):
        recon_feat = self.contextual_decoder_part1(y_hat.to(self.dtype))
        recon = self.contextual_decoder_part2(torch.cat(
            [recon_feat, context], dim=-1))
        return torch.clamp(recon.float(), 0.0, 1.0)

    # ------------------------------------------------------------ forward

    def forward(self, referframe, input_image):
        """The eval forward of one P frame on rounded latents (reference
        DCVC_net.forward, :414-465).  Frames (B, H, W, 3) RGB in [0, 1].
        Returns the bpp terms, recon_image and context."""
        x = input_image.to(self.dtype)
        ref = referframe.to(self.dtype)
        mv_feature = self.mv_encoder(self.optic_flow(x, ref))
        z_mv_hat = torch.round(self.mv_prior_encoder(mv_feature))
        params_mv = self.mv_prior_decoder(z_mv_hat)
        quant_mv = torch.round(mv_feature)
        means_mv, scales_mv = self.entropy_parameters_mv(torch.cat(
            [params_mv, self.auto_regressive_mv(quant_mv)],
            dim=-1)).chunk(2, dim=-1)
        mv_up = self.mv_decoder_part1(quant_mv)
        mv_refined = self.mv_decoder_part2(torch.cat([mv_up, ref], dim=-1)) \
            + mv_up
        context = self.motion_compensation(ref, mv_refined)
        temporal_params = self.temporal_prior_encoder(context)

        feature = self.contextual_encoder(torch.cat([x, context], dim=-1))
        z_hat = torch.round(self.prior_encoder(feature))
        params = self.prior_decoder(z_hat)
        y_hat = torch.round(feature)
        means, scales = self.entropy_parameters(torch.cat(
            [temporal_params, params, self.auto_regressive(y_hat)],
            dim=-1)).chunk(2, dim=-1)
        recon_feat = self.contextual_decoder_part1(y_hat)
        recon_image = self.contextual_decoder_part2(torch.cat(
            [recon_feat, context], dim=-1))

        # rates: round(y - mean) under Laplace(0, scale); z factorized
        pixel_num = x.shape[1] * x.shape[2]
        bpp_y = laplace_bits_sum(torch.round(feature - means), scales) \
            / pixel_num
        bpp_mv_y = laplace_bits_sum(torch.round(mv_feature - means_mv),
                                    scales_mv) / pixel_num
        bpp_z = z_bits_sum(z_hat, self.bit_estimator_z) / pixel_num
        bpp_mv_z = z_bits_sum(z_mv_hat, self.bit_estimator_z_mv) \
            / pixel_num
        return {"bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
                "bpp_mv_z": bpp_mv_z,
                "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z,
                "recon_image": recon_image.float(), "context": context}
