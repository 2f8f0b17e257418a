"""DCVC-FM P-frame model (counterpart of dcvc_tpu/legacy/dcvc_fm.py;
reference DCVC-family/DCVC-FM/src/models/video_model.py): SpyNet motion
estimation, offset-diversity motion compensation over a 3-scale feature
pyramid, conditional contextual coding with hyper and temporal priors, a
quadtree 4-part spatial prior (scales and means), the Laplace y
likelihood, and one model for a wide rate range through quant scalars
log-interpolated between two anchors.  RGB in [0, 1], NHWC.

The module tree mirrors the flax one (legacy/fm_layers.py): a flax leaf
`a/b/kernel` is the state_dict key `a.b.weight`, so utils/jax_bridge.py's
fm_params_from_jax / fm_params_to_jax carry the weights as they do
IntraNoAR's; OffsetDiversity keeps the flax grouped fusion leaves
(`fusion_kernel` (g, o*ch/g, ch/g), `fusion_bias`).  A reference
checkpoint loads through from_reference (key_fn_fm, utils/keys.py).

get_curr_q computes exp and log the way XLA's CPU backend does (the
Cephes polynomials with fused multiply-adds, division by qp_num - 1 as a
product with its float32 reciprocal), so the port's quant scalars equal
the JAX package's bit for bit: they scale y before it is rounded.  The
gradient is torch's exp / log.

The stage methods are the runtime's (runtime/fm_codec.py): analysis
stages emit int16 z, the prior and synthesis stages are shared by the
encoder and the decoder.  forward() is the training / eval forward of
one P frame (noise None: the rates of the rounded latents, the fast
estimated-bits mode of the family runner).
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.padding import pad_replicate_nhwc
from ..core.quant import add_noise, ste_round, z_to_int16
from ..entropy.gaussian import probs_to_bits
from ..models import common
from ..utils.keys import key_fn_fm
from .fm_layers import ConvK, DepthConvBlock4FM, DepthConvBlockFM, LReLU, \
    ResBlockFM, ResidualBlockUpsampleFM, ResidualBlockWithStrideFM, \
    SubpelConv, UNet2, damp_kernels_, lecun_init_legacy_, lrelu, seq
from .ops import bilinear_downsample_2x, bilinear_upsample_2x, block_mc, \
    flow_warp
from .spynet import MESpynet


@dataclasses.dataclass(frozen=True)
class DMCFMConfig:
    ch_1x: int = 48
    ch_2x: int = 64
    ch_4x: int = 96
    ch_8x: int = 96
    ch_16x: int = 128
    ch_z: int = 64
    ch_mv: int = 64
    ch_mv_z: int = 64
    qp_num: int = 64
    offset_group: int = 16
    offset_num: int = 2


FM_CONFIG = DMCFMConfig()
TINY_FM_CONFIG = DMCFMConfig(ch_1x=8, ch_2x=8, ch_4x=8, ch_8x=8, ch_16x=8,
                             ch_z=8, ch_mv=8, ch_mv_z=8, qp_num=8,
                             offset_group=2, offset_num=2)

DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")


def empty_dpb(ref_frame):
    """A DPB holding only the intra reconstruction."""
    return {k: ref_frame if k == "ref_frame" else None for k in DPB_KEYS}


def laplace_bits(y, sigma):
    """-log2 P(round) under Laplace(0, sigma) (reference
    get_y_laplace_bits, common_model.py:79-85)."""
    sigma = torch.clamp(sigma.float(), 1e-5, 1e10)
    y = y.float()

    def cdf(v):
        return 0.5 + 0.5 * torch.sign(v) * (1.0 - torch.exp(-torch.abs(v)
                                                            / sigma))
    return probs_to_bits(cdf(y + 0.5) - cdf(y - 0.5))


# ---------------------------------------------- XLA's float32 exp and log

def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32s is
    exact in float64)."""
    return (a.double() * b + c).float()


_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _f32(v):
    """v rounded to float32, as a Python float (made on the CPU, so that
    the model also runs on the meta device)."""
    return torch.tensor(v, dtype=torch.float32, device="cpu").item()


def xla_exp_f32(x):
    """exp of a float32 tensor as XLA's CPU backend computes it (Cephes:
    x = n ln2 + r, a degree-5 polynomial in r with fused multiply-adds,
    times 2^n); bit for bit on |x| < 87."""
    x = torch.clamp(x.float(), -87.8, 88.8)
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    r = _fma(n, -0.693359375, x)
    r = _fma(n, _f32(2.12194440e-4), r)
    y = torch.full_like(r, _f32(_EXP_P[0]))
    for p in _EXP_P[1:]:
        y = _fma(y, r, _f32(p))
    y = _fma(y, r * r, r) + 1.0
    return y * torch.exp2(n)


def xla_log_f32(x):
    """log of a positive float32 tensor as XLA's CPU backend computes it
    (Cephes / Eigen plog: mantissa in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial evaluated in three interleaved parts, ln2 split in two),
    bit for bit."""
    x = torch.clamp_min(x.float(), 1.17549435e-38)
    bits = x.view(torch.int32)
    e = (bits >> 23).float() - 126.0
    m = ((bits & ~0x7f800000) | 0x3f000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    p = [_f32(v) for v in _LOG_P]
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f32(-2.12194440e-4) * e)
    return (t - 0.5 * x2 + y) + 0.693359375 * e


def get_curr_q(q_anchors, q_index, qp_num):
    """Log-interpolate a quant scalar between the (min, max) anchors
    (reference get_one_q_scale, common_model.py:37-42): the JAX package's
    value bit for bit, with torch's exp / log gradient."""
    min_q, max_q = q_anchors[0], q_anchors[1]
    log_min = xla_log_f32(min_q)
    step = (xla_log_f32(max_q) - log_min) * _f32(1.0 / (qp_num - 1))
    q = xla_exp_f32(_fma(step, float(q_index), log_min))
    if torch.is_grad_enabled() and q_anchors.requires_grad:
        plain = torch.exp(torch.log(min_q) + (torch.log(max_q)
                                              - torch.log(min_q))
                          / (qp_num - 1) * q_index)
        q = plain + (q - plain).detach()
    return q


def state_from_reference(model, state, key_fn):
    """A reference state_dict -> the state_dict of a port model whose
    modules mirror the flax tree (DMCFM, DMCDC, DMCHEM), by key_fn of
    each parameter's flax path: the z priors' Bitparm tensors stacked into
    their h / b / a banks (BitEstimatorModule.from_reference), a grouped
    fusion conv (`group_conv`: (ch, o*ch/g, 1, 1)) turned into
    OffsetDiversity's (g, o*ch/g, ch/g) kernel, a Linear's weight
    (`linear`) kept as it is (its layout is nn.Linear's), every other
    tensor renamed.  Keys that no parameter maps from are left for the
    caller to report."""
    state = dict(state)
    for prefix in ("bit_estimator_z", "bit_estimator_z_mv"):
        state = getattr(model, prefix).from_reference(state, key_fn, prefix)
    out = {}
    for key, param in model.state_dict().items():
        if key in state and key.split(".")[0].startswith("bit_estimator_z"):
            out[key] = state.pop(key)
            continue
        segs = key.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        ref = key_fn(path)
        kind = None
        if isinstance(ref, tuple):           # (tag, key)
            kind, ref = ref
        if ref not in state:
            continue
        t = state.pop(ref)
        if kind == "group_conv":
            t = t.float()
            if t.dim() > 1:                  # (ch, I, 1, 1) -> (g, I, ch/g)
                g, icpg, ocpg = param.shape
                t = t.reshape(g, ocpg, icpg).transpose(1, 2)
            t = t.reshape(param.shape)
        out[key] = t
    out.update(state)
    return out


# ------------------------------------------------------------- modules

class OffsetDiversity(nn.Module):
    """Group-based offset / mask warping (reference OffsetDiversity,
    video_model.py:26-63).  Warp unit k = j*g + gi warps feature group gi
    with offset pair (2k, 2k+1) plus the flow; the units, concatenated in
    unit order, are split into g contiguous blocks for the grouped 1x1
    fusion (a block is not one feature group)."""

    def __init__(self, cfg, max_residue_magnitude=40.0):
        super().__init__()
        c = cfg
        g, o, ch = c.offset_group, c.offset_num, c.ch_1x
        self.g, self.o = g, o
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset_0 = ConvK(ch + 5, c.ch_2x, stride=2)
        self.conv_offset_1 = ConvK(c.ch_2x, c.ch_2x)
        self.conv_offset_2 = ConvK(c.ch_2x, 3 * g * o)
        self.fusion_kernel = nn.Parameter(torch.zeros(g, o * ch // g,
                                                      ch // g))
        self.fusion_bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x, aux_feature, flow):
        g, o = self.g, self.o
        b, h, w, ch = x.shape
        n, cg = g * o, ch // g
        out = lrelu(self.conv_offset_0(aux_feature), 0.1)
        out = lrelu(self.conv_offset_1(out), 0.1)
        out = bilinear_upsample_2x(self.conv_offset_2(out))
        o1, o2, mask = out.chunk(3, dim=-1)
        mask = torch.sigmoid(mask)                       # (B, H, W, n)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat([o1, o2], dim=-1))                 # (B, H, W, 2n)
        dx = offset[..., 0::2] + flow[..., 0:1]
        dy = offset[..., 1::2] + flow[..., 1:2]
        # all n warps in one batch: unit k takes group k % g
        units = x.reshape(b, h, w, g, cg).permute(0, 3, 1, 2, 4) \
            .repeat(1, o, 1, 1, 1).reshape(b * n, h, w, cg)
        fields = torch.stack([dx, dy], dim=-1).permute(0, 3, 1, 2, 4) \
            .reshape(b * n, h, w, 2)
        warped = flow_warp(units, fields).reshape(b, n, h, w, cg)
        warped = warped * mask.permute(0, 3, 1, 2)[..., None]
        xw = warped.permute(0, 2, 3, 1, 4).reshape(b, h, w, g, o * cg)
        y = torch.einsum("bhwgi,gio->bhwgo", xw,
                         self.fusion_kernel.to(xw.dtype))
        return y.reshape(b, h, w, ch) + self.fusion_bias.to(y.dtype)


class FMFeatureExtractor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.conv1 = ConvK(c.ch_1x, c.ch_1x)
        self.res_block1 = ResBlockFM(c.ch_1x)
        self.conv2 = ConvK(c.ch_1x, c.ch_2x, stride=2)
        self.res_block2 = ResBlockFM(c.ch_2x)
        self.conv3 = ConvK(c.ch_2x, c.ch_4x, stride=2)
        self.res_block3 = ResBlockFM(c.ch_4x)

    def forward(self, feature):
        l1 = self.res_block1(self.conv1(feature))
        l2 = self.res_block2(self.conv2(l1))
        l3 = self.res_block3(self.conv3(l2))
        return l1, l2, l3


class MultiScaleContextFusion(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.conv3_up = SubpelConv(c.ch_4x, c.ch_2x, r=2, kernel=3)
        self.res_block3_up = ResBlockFM(c.ch_2x)
        self.conv3_out = ConvK(c.ch_4x, c.ch_4x)
        self.res_block3_out = ResBlockFM(c.ch_4x)
        self.conv2_up = SubpelConv(2 * c.ch_2x, c.ch_1x, r=2, kernel=3)
        self.res_block2_up = ResBlockFM(c.ch_1x)
        self.conv2_out = ConvK(2 * c.ch_2x, c.ch_2x)
        self.res_block2_out = ResBlockFM(c.ch_2x)
        self.conv1_out = ConvK(2 * c.ch_1x, c.ch_1x)
        self.res_block1_out = ResBlockFM(c.ch_1x)

    def forward(self, c1, c2, c3):
        c3_up = self.res_block3_up(self.conv3_up(c3))
        c3_out = self.res_block3_out(self.conv3_out(c3))
        cat32 = torch.cat([c3_up, c2], dim=-1)
        c2_up = self.res_block2_up(self.conv2_up(cat32))
        c2_out = self.res_block2_out(self.conv2_out(cat32))
        c1_out = self.res_block1_out(self.conv1_out(
            torch.cat([c2_up, c1], dim=-1)))
        return c1 + c1_out, c2 + c2_out, c3 + c3_out


class MvEnc(nn.Module):
    """The mv encoder; `block` its depth-conv block (DCVC-DC's
    DepthConvBlockFM, dcvc_dc.DCMvEnc)."""

    def __init__(self, cfg, block=DepthConvBlock4FM):
        super().__init__()
        ch = cfg.ch_mv
        self.enc_1_0 = ResidualBlockWithStrideFM(2, ch)
        self.enc_1_1 = block(ch, ch)
        self.enc_2 = ResidualBlockWithStrideFM(ch, ch)
        self.adaptor_0 = block(ch, ch)
        self.adaptor_1 = block(2 * ch, ch)
        self.enc_3_0 = ResidualBlockWithStrideFM(ch, ch)
        self.enc_3_1 = block(ch, ch)
        self.enc_3_2 = ConvK(ch, ch, stride=2)

    def forward(self, x, context, quant_step):
        out = self.enc_1_1(self.enc_1_0(x)) * quant_step
        out = self.enc_2(out)
        if context is None:
            out = self.adaptor_0(out)
        else:
            out = self.adaptor_1(torch.cat([out, context], dim=-1))
        out = self.enc_3_1(self.enc_3_0(out))
        return self.enc_3_2(out)


class MvDec(nn.Module):
    """The mv decoder -> (mv, feature); `block` as MvEnc's."""

    def __init__(self, cfg, block=DepthConvBlock4FM):
        super().__init__()
        ch = cfg.ch_mv
        self.dec_1_0 = block(ch, ch)
        self.dec_1_1 = ResidualBlockUpsampleFM(ch, ch)
        self.dec_1_2 = block(ch, ch)
        self.dec_1_3 = ResidualBlockUpsampleFM(ch, ch)
        self.dec_1_4 = block(ch, ch)
        self.dec_2 = ResidualBlockUpsampleFM(ch, ch)
        self.dec_3_0 = block(ch, ch)
        self.dec_3_1 = SubpelConv(ch, 2, r=2, kernel=1)

    def forward(self, x, quant_step):
        f = self.dec_1_3(self.dec_1_2(self.dec_1_1(self.dec_1_0(x))))
        feature = self.dec_1_4(f)
        out = self.dec_2(feature) * quant_step
        return self.dec_3_1(self.dec_3_0(out)), feature


class ContextualEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.conv1 = ConvK(3 + c.ch_1x, c.ch_2x, stride=2)
        self.res1 = DepthConvBlock4FM(2 * c.ch_2x, 2 * c.ch_2x)
        self.conv2 = ConvK(2 * c.ch_2x, c.ch_4x, stride=2)
        self.res2 = DepthConvBlock4FM(2 * c.ch_4x, 2 * c.ch_4x)
        self.conv3 = ConvK(2 * c.ch_4x, c.ch_8x, stride=2)
        self.conv4 = ConvK(c.ch_8x, c.ch_16x, stride=2)

    def forward(self, x, c1, c2, c3, quant_step):
        f = self.conv1(torch.cat([x, c1], dim=-1))
        f = self.res1(torch.cat([f, c2], dim=-1)) * quant_step
        f = self.res2(torch.cat([self.conv2(f), c3], dim=-1))
        return self.conv4(self.conv3(f))


class ContextualDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.up1 = SubpelConv(c.ch_16x, c.ch_8x, r=2, kernel=3)
        self.up2 = SubpelConv(c.ch_8x, c.ch_4x, r=2, kernel=3)
        self.res1 = DepthConvBlock4FM(2 * c.ch_4x, 2 * c.ch_4x)
        self.up3 = SubpelConv(2 * c.ch_4x, c.ch_2x, r=2, kernel=3)
        self.res2 = DepthConvBlock4FM(2 * c.ch_2x, 2 * c.ch_2x)
        self.up4 = SubpelConv(2 * c.ch_2x, 32, r=2, kernel=3)

    def forward(self, x, c2, c3, quant_step):
        f = self.up2(self.up1(x))
        f = self.res1(torch.cat([f, c3], dim=-1))
        f = self.up3(f) * quant_step
        f = self.res2(torch.cat([f, c2], dim=-1))
        return self.up4(f)


class ReconGeneration(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch = cfg.ch_1x
        self.first_conv = ConvK(32 + ch, ch)
        self.unet_1 = UNet2(ch, ch)
        self.unet_2 = UNet2(ch, ch)
        self.recon_conv = ConvK(ch, 3)

    def forward(self, res, ctx):
        # the reference calls recon_generation_net(recon_feat, c1) against
        # a forward(ctx, res) signature (video_model.py:379): the concat
        # order is [recon_feat, context1]
        f = self.first_conv(torch.cat([res, ctx], dim=-1))
        f = self.unet_2(self.unet_1(f))
        return f, self.recon_conv(f)


def _hyper_encoder(cin, ch):
    return seq(DepthConvBlock4FM(cin, ch), ConvK(ch, ch, stride=2), LReLU(),
               ConvK(ch, ch, stride=2))


def _hyper_decoder(ch, cout):
    return seq(ResidualBlockUpsampleFM(ch, ch),
               ResidualBlockUpsampleFM(ch, ch), DepthConvBlock4FM(ch, cout))


def spatial_prior_stack(ch):
    """The spatial prior of FM and DC: three depth-conv blocks, 3 ch -> 2
    ch (scales and means)."""
    return seq(DepthConvBlockFM(3 * ch, 3 * ch),
               DepthConvBlockFM(3 * ch, 3 * ch),
               DepthConvBlockFM(3 * ch, 2 * ch))


class DMCFM(nn.Module):
    """DCVC-FM.  The DPB is a dict {ref_frame, ref_feature, ref_mv_feature,
    ref_y, ref_mv_y} (reference video_model.py:219-270); all but ref_frame
    are None before the first P frame."""

    # the quant parameters, set to one by reset_parameters
    Q_PARAMS = ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec")

    def __init__(self, cfg=FM_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        self.optic_flow = MESpynet(level_kernels=(7, 7, 5, 5))
        self.align = OffsetDiversity(c)
        self.mv_encoder = MvEnc(c)
        self.mv_hyper_prior_encoder = _hyper_encoder(c.ch_mv, c.ch_mv_z)
        self.mv_hyper_prior_decoder = _hyper_decoder(c.ch_mv_z, c.ch_mv)
        self._add_mv_prior(c)
        self.mv_decoder = MvDec(c)

        self._add_contexts(c)

        self.contextual_encoder = ContextualEncoder(c)
        self.contextual_hyper_prior_encoder = _hyper_encoder(c.ch_16x,
                                                             c.ch_z)
        self.contextual_hyper_prior_decoder = _hyper_decoder(c.ch_z,
                                                             c.ch_16x)
        self._add_y_prior(c)
        self.contextual_decoder = ContextualDecoder(c)
        self.recon_generation_net = ReconGeneration(c)

        for name in self.Q_PARAMS:
            setattr(self, name, nn.Parameter(torch.ones(2, 1, 1, 1)))
        self.bit_estimator_z = common.BitEstimatorModule(2, c.ch_z)
        self.bit_estimator_z_mv = common.BitEstimatorModule(2, c.ch_mv_z)

    # the module groups FM and DCVC-DC (legacy/dcvc_dc.py) share, added at
    # the same places of both trees

    def _add_mv_prior(self, c):
        """The mv prior's fusion (with its adaptors for an empty and a full
        DPB) and the spatial prior with its three step adaptors."""
        self.mv_y_prior_fusion_adaptor_0 = DepthConvBlockFM(c.ch_mv,
                                                            2 * c.ch_mv)
        self.mv_y_prior_fusion_adaptor_1 = DepthConvBlockFM(2 * c.ch_mv,
                                                            2 * c.ch_mv)
        self.mv_y_prior_fusion = seq(DepthConvBlockFM(2 * c.ch_mv,
                                                      3 * c.ch_mv),
                                     DepthConvBlockFM(3 * c.ch_mv,
                                                      3 * c.ch_mv))
        for i in (1, 2, 3):
            setattr(self, f"mv_y_spatial_prior_adaptor_{i}",
                    ConvK(4 * c.ch_mv, 3 * c.ch_mv, kernel=1))
        self.mv_y_spatial_prior = spatial_prior_stack(c.ch_mv)

    def _add_contexts(self, c):
        """The feature adaptors, the pyramid and the context fusion."""
        self.feature_adaptor_I = ConvK(3, c.ch_1x)
        for i in range(3):
            setattr(self, f"feature_adaptor_{i}",
                    ConvK(c.ch_1x, c.ch_1x, kernel=1))
        self.feature_extractor = FMFeatureExtractor(c)
        self.context_fusion_net = MultiScaleContextFusion(c)

    def _add_y_prior(self, c):
        """The contextual prior's temporal encoder, fusion (and adaptors)
        and spatial prior (and step adaptors)."""
        self.temporal_prior_encoder = seq(
            ConvK(c.ch_4x, c.ch_8x, stride=2), LReLU(0.1),
            ConvK(c.ch_8x, c.ch_16x, stride=2))
        self.y_prior_fusion_adaptor_0 = DepthConvBlockFM(2 * c.ch_16x,
                                                         3 * c.ch_16x)
        self.y_prior_fusion_adaptor_1 = DepthConvBlockFM(3 * c.ch_16x,
                                                         3 * c.ch_16x)
        self.y_prior_fusion = seq(DepthConvBlockFM(3 * c.ch_16x,
                                                   3 * c.ch_16x),
                                  DepthConvBlockFM(3 * c.ch_16x,
                                                   3 * c.ch_16x))
        for i in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{i}",
                    ConvK(4 * c.ch_16x, 3 * c.ch_16x, kernel=1))
        self.y_spatial_prior = spatial_prior_stack(c.ch_16x)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model:
        lecun-normal conv kernels (the grouped fusion kernel too, fan-in
        over its groups and inputs) and zero biases, the q anchors at one,
        z prior banks N(0, 0.01); feature_adaptor_1 cloned into slots 0
        and 2, as dcvc_tpu's DMCFMCodec.init_random does (its init traces
        reach only slot 1).  Draws from `generator` (a CPU
        torch.Generator)."""
        lecun_init_legacy_(self, generator)
        fk = self.align.fusion_kernel
        std = (1.0 / (fk.shape[0] * fk.shape[1])) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(fk, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.align.fusion_bias.zero_()
        for name in self.Q_PARAMS:
            getattr(self, name).fill_(1.0)
        for be in (self.bit_estimator_z, self.bit_estimator_z_mv):
            for p in be.parameters():
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))
        for i in (0, 2):
            getattr(self, f"feature_adaptor_{i}").load_state_dict(
                self.feature_adaptor_1.state_dict())

    @torch.no_grad()
    def damp_(self, scale):
        """Every conv kernel and the fusion kernel times `scale` (the JAX
        codec's init_scale on each `kernel` / `fusion_kernel` leaf)."""
        damp_kernels_(self, scale)
        self.align.fusion_kernel.mul_(scale)

    def from_reference(self, state):
        """A reference state_dict (DCVC-FM's video_model.py module tree)
        -> this model's (state_from_reference with key_fn_fm)."""
        return state_from_reference(self, state, key_fn_fm)

    @property
    def dtype(self):
        return self.feature_adaptor_I.conv.weight.dtype

    def _q(self, name, q_index):
        return get_curr_q(getattr(self, name), q_index,
                          self.cfg.qp_num).to(self.dtype)

    def _adaptors(self, side):
        prefix = "mv_y" if side == "mv" else "y"
        return [getattr(self, f"{prefix}_spatial_prior_adaptor_{i}")
                for i in (1, 2, 3)]

    # ------------------------------------------------------------ helpers

    def multi_scale_feature_extractor(self, ref_frame, ref_feature, fa_idx):
        if ref_feature is None:
            feature = self.feature_adaptor_I(ref_frame.to(self.dtype))
        else:
            feature = getattr(self, f"feature_adaptor_{fa_idx}")(
                ref_feature.to(self.dtype))
        return self.feature_extractor(feature)

    def motion_compensation(self, ref_frame, ref_feature, mv, fa_idx):
        warpframe = block_mc(ref_frame.to(self.dtype), mv)
        mv2 = bilinear_downsample_2x(mv) / 2
        mv3 = bilinear_downsample_2x(mv2) / 2
        f1, f2, f3 = self.multi_scale_feature_extractor(ref_frame,
                                                        ref_feature, fa_idx)
        context1_init = block_mc(f1, mv)
        context1 = self.align(f1, torch.cat(
            [context1_init, warpframe, mv.to(self.dtype)], dim=-1), mv)
        context2 = block_mc(f2, mv2)
        context3 = block_mc(f3, mv3)
        c1, c2, c3 = self.context_fusion_net(context1, context2, context3)
        return c1, c2, c3, warpframe

    def _mv_fusion(self, p, ref_mv_y):
        if ref_mv_y is None:
            p = self.mv_y_prior_fusion_adaptor_0(p)
        else:
            p = self.mv_y_prior_fusion_adaptor_1(
                torch.cat([p, ref_mv_y.to(self.dtype)], dim=-1))
        return self.mv_y_prior_fusion(p)

    def _ctx_fusion(self, hierarchical, ref_y, context3):
        temporal = self.temporal_prior_encoder(context3)
        if ref_y is None:
            p = self.y_prior_fusion_adaptor_0(
                torch.cat([temporal, hierarchical], dim=-1))
        else:
            p = self.y_prior_fusion_adaptor_1(torch.cat(
                [temporal, hierarchical, ref_y.to(self.dtype)], dim=-1))
        return self.y_prior_fusion(p)

    def _prior_step(self, side, spctx, y_hat_so_far, step):
        prior = self.mv_y_spatial_prior if side == "mv" \
            else self.y_spatial_prior
        sp_in = torch.cat([y_hat_so_far.to(self.dtype), spctx], dim=-1)
        return prior(self._adaptors(side)[step - 1](sp_in)).chunk(2, dim=-1)

    # --------------------------------------- inference stage methods
    # (the reference compress / decompress split, video_model.py:396-500;
    # every tensor a symbol decision depends on comes from a stage shared
    # by the encoder and the decoder, the encoder-only stages emit
    # integers)

    @staticmethod
    def _pad4(y):
        """Replicate-pad a /16 latent to a multiple of 4 (pad_for_y,
        common_model.py:96-112)."""
        return pad_replicate_nhwc(y, (-y.shape[1]) % 4, (-y.shape[2]) % 4)

    def mv_analysis(self, x, ref_frame, ref_mv_feature, q_index):
        """Encoder-only: motion estimation, mv encoding and its hyper
        encoder -> (mv_y float32, mv_z_int int16).  ref_mv_feature is None
        on the first P frame."""
        est_mv = self.optic_flow(x.to(self.dtype), ref_frame.to(self.dtype))
        mv_y = self.mv_encoder(est_mv, ref_mv_feature,
                               self._q("mv_y_q_enc", q_index))
        mv_z = self.mv_hyper_prior_encoder(self._pad4(mv_y))
        return mv_y.float(), z_to_int16(mv_z)

    def mv_prior0(self, mv_z_int, ref_mv_y, yh, yw):
        """Shared: the mv hyper decode and fusion -> (q_enc, q_dec,
        scales, means, spatial context) (mv_prior_param_decoder,
        video_model.py:316-325)."""
        p = self.mv_hyper_prior_decoder(mv_z_int.to(self.dtype))
        params = self._mv_fusion(p[:, :yh, :yw], ref_mv_y)
        return (*common.separate_prior_video_infer(params), params)

    def mv_prior_step(self, spctx, y_hat_so_far, step):
        return self._prior_step("mv", spctx, y_hat_so_far, step)

    def mv_synthesis(self, mv_y_hat, q_index):
        """Shared: the mv decoder -> (mv_hat, mv_feature)."""
        return self.mv_decoder(mv_y_hat.to(self.dtype),
                               self._q("mv_y_q_dec", q_index))

    def mc(self, ref_frame, ref_feature, fa_idx, mv_hat):
        """Shared: motion compensation -> (c1, c2, c3)."""
        return self.motion_compensation(ref_frame, ref_feature, mv_hat,
                                        fa_idx)[:3]

    def ctx_analysis(self, x, c1, c2, c3, q_index):
        """Encoder-only: contextual encoding and its hyper encoder ->
        (y float32, z_int int16)."""
        y = self.contextual_encoder(x.to(self.dtype), c1, c2, c3,
                                    self._q("y_q_enc", q_index))
        z = self.contextual_hyper_prior_encoder(self._pad4(y))
        return y.float(), z_to_int16(z)

    def ctx_prior0(self, z_int, ref_y, c3, yh, yw):
        """Shared: the contextual prior (contextual_prior_param_decoder,
        video_model.py:327-340) -> (q_enc, q_dec, scales, means, spatial
        context)."""
        hierarchical = self.contextual_hyper_prior_decoder(
            z_int.to(self.dtype))[:, :yh, :yw]
        params = self._ctx_fusion(hierarchical, ref_y, c3)
        return (*common.separate_prior_video_infer(params), params)

    def ctx_prior_step(self, spctx, y_hat_so_far, step):
        return self._prior_step("ctx", spctx, y_hat_so_far, step)

    def synthesis(self, y_hat, c1, c2, c3, q_index):
        """Shared: contextual decoding and recon -> (x_hat float32 in
        [0, 1], feature)."""
        recon_feat = self.contextual_decoder(y_hat.to(self.dtype), c2, c3,
                                             self._q("y_q_dec", q_index))
        feature, x_hat = self.recon_generation_net(recon_feat, c1)
        return torch.clamp(x_hat.float(), 0.0, 1.0), feature

    # ------------------------------------------------------------ forward

    def _four_part(self, side, y, params):
        prior = self.mv_y_spatial_prior if side == "mv" \
            else self.y_spatial_prior
        return common.forward_prior_4x_train(
            y, None, None, params, lambda p: p, self._adaptors(side), prior,
            spatial_prior_has_scales=True)

    def forward(self, x, dpb, q_index, fa_idx, noise=None):
        """The training / eval forward of one P frame.  x (B, H, W, 3) RGB
        in [0, 1]; dpb as the class says.  noise None: the rates of the
        rounded latents (the reference's fast no-bitstream mode,
        test_helper.py:134); else a dict of U(-0.5, 0.5) tensors {y, mv_y,
        z, mv_z} or a torch.Generator to draw them from in that order.
        Returns (result dict, new dpb)."""
        q = {name: self._q(name, q_index) for name in
             ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec")}
        return self._forward(x, dpb, q, fa_idx, noise)

    def _forward(self, x, dpb, q, fa_idx, noise):
        """forward() on the quant scalars `q` {mv_y_q_enc, mv_y_q_dec,
        y_q_enc, y_q_dec} (shared with DCVC-DC, legacy/dcvc_dc.py)."""
        ref_frame = dpb["ref_frame"]
        est_mv = self.optic_flow(x.to(self.dtype), ref_frame.to(self.dtype))
        mv_y = self.mv_encoder(est_mv, dpb["ref_mv_feature"],
                               q["mv_y_q_enc"])
        mv_z = self.mv_hyper_prior_encoder(mv_y)
        mv_z_hat = ste_round(mv_z)
        mv_params = self._mv_fusion(self.mv_hyper_prior_decoder(mv_z_hat),
                                    dpb["ref_mv_y"])
        mv_y_res, mv_y_q, mv_y_hat, mv_scales_hat = self._four_part(
            "mv", mv_y, mv_params)
        mv_hat, mv_feature = self.mv_decoder(mv_y_hat, q["mv_y_q_dec"])
        c1, c2, c3, warp_frame = self.motion_compensation(
            ref_frame, dpb["ref_feature"], mv_hat, fa_idx)

        y = self.contextual_encoder(x.to(self.dtype), c1, c2, c3,
                                    q["y_q_enc"])
        z = self.contextual_hyper_prior_encoder(y)
        z_hat = ste_round(z)
        params = self._ctx_fusion(self.contextual_hyper_prior_decoder(z_hat),
                                  dpb["ref_y"], c3)
        y_res, y_q, y_hat, scales_hat = self._four_part("ctx", y, params)
        recon_feat = self.contextual_decoder(y_hat, c2, c3, q["y_q_dec"])
        feature, x_hat = self.recon_generation_net(recon_feat, c1)
        x_hat = torch.clamp(x_hat.float(), 0.0, 1.0)

        if noise is None:
            y_noisy, mv_y_noisy, z_noisy, mv_z_noisy = y_q, mv_y_q, z_hat, \
                mv_z_hat
        else:
            if isinstance(noise, torch.Generator):
                noise = dict.fromkeys(("y", "mv_y", "z", "mv_z"), noise)
            y_noisy = add_noise(y_res, noise["y"])
            mv_y_noisy = add_noise(mv_y_res, noise["mv_y"])
            z_noisy = add_noise(z, noise["z"])
            mv_z_noisy = add_noise(mv_z, noise["mv_z"])
        bits_y = laplace_bits(y_noisy, scales_hat).sum(dim=(1, 2, 3))
        bits_mv_y = laplace_bits(mv_y_noisy, mv_scales_hat).sum(
            dim=(1, 2, 3))
        bits_z = probs_to_bits(self.bit_estimator_z.get_prob(
            z_noisy, 0)).sum(dim=(1, 2, 3))
        bits_mv_z = probs_to_bits(self.bit_estimator_z_mv.get_prob(
            mv_z_noisy, 0)).sum(dim=(1, 2, 3))
        pixel_num = x.shape[1] * x.shape[2]
        bpp = (bits_y + bits_z + bits_mv_y + bits_mv_z) / pixel_num
        mse = torch.mean((x_hat - x.float()) ** 2, dim=(1, 2, 3))
        new_dpb = {"ref_frame": x_hat, "ref_feature": feature,
                   "ref_mv_feature": mv_feature, "ref_y": y_hat,
                   "ref_mv_y": mv_y_hat}
        result = {"x_hat": x_hat, "mse": mse, "bpp": bpp, "bits_y": bits_y,
                  "bits_z": bits_z, "bits_mv_y": bits_mv_y,
                  "bits_mv_z": bits_mv_z, "mv_hat": mv_hat,
                  "warp_frame": warp_frame}
        return result, new_dpb
