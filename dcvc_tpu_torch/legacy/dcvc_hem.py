"""DCVC-HEM (MM'22), the hybrid spatial-temporal entropy model
(counterpart of dcvc_tpu/legacy/dcvc_hem.py; reference DCVC-family/
DCVC-HEM/src/models/video_model.py, video_net.py).

The building blocks (the ResBlock with its slope / start / end /
bottleneck options, the squeeze-excitation layer, the residual conv block
and the SE-augmented UNet) also refine the IntraNoAR reconstruction
(legacy/hem_intra.py).  The P-frame model DMCHEM: SpyNet motion (7x7 at
every level), flow-warp motion compensation over a 3-scale single-width
feature pyramid, latent-domain conditioning (ref_y / ref_mv_y feed the
priors), the dual cross-checkerboard spatial prior and one model for the
whole rate range through lower-bounded q_basic vectors times a
continuous q scale (a float32 scalar).  RGB in [0, 1], NHWC.

The module tree mirrors the flax one (legacy/fm_layers.py): a flax leaf
`a/b/kernel` is the state_dict key `a.b.weight`, so utils/jax_bridge.py's
hem_params_from_jax / hem_params_to_jax carry the weights; SELayer's
Dense layers are nn.Linear (weight (out, in), the transpose of the flax
kernel).  A reference checkpoint loads through from_reference
(key_fn_hem, utils/keys.py).

The stage methods are runtime/hem_codec.py's: analysis stages emit int16
z, the prior, spatial and synthesis stages are shared by the encoder and
the decoder.  forward() is the training / eval forward of one P frame
(noise None: the rates of the rounded latents, the family runner's
estimated-bits mode).
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.masks import _phase_np
from ..core.quant import add_noise, lower_bound, ste_round, z_to_int16
from ..entropy.gaussian import probs_to_bits
from ..models import common
from ..utils.keys import key_fn_hem
from .dcvc_fm import laplace_bits, state_from_reference
from .fm_layers import ConvK, LReLU, ResBlockFM, ResidualBlockUpsampleFM, \
    ResidualBlockWithStrideFM, SubpelConv, damp_kernels_, \
    lecun_init_legacy_, lrelu, max_pool_2x, seq
from .ops import bilinear_downsample_2x, flow_warp
from .spynet import MESpynet


@dataclasses.dataclass(frozen=True)
class DMCHEMConfig:
    ch_mv: int = 64
    ch_n: int = 64
    ch_m: int = 96
    anchor_num: int = 4


HEM_CONFIG = DMCHEMConfig()
TINY_HEM_CONFIG = DMCHEMConfig(ch_mv=8, ch_n=8, ch_m=8)

DPB_KEYS = ("ref_frame", "ref_feature", "ref_y", "ref_mv_y")


def empty_dpb(ref_frame):
    """A DPB holding only the intra reconstruction."""
    return {k: ref_frame if k == "ref_frame" else None for k in DPB_KEYS}


# ------------------------------------- the dual cross-checkerboard prior

def checkerboard_masks(y):
    """The dual checkerboard's two (1, h, w, 1) masks of y's grid, as
    y's dtype: phases (0,0)|(1,1), and the rest (common_model.py:102-145)."""
    h, w = y.shape[1], y.shape[2]
    m0 = torch.from_numpy(_phase_np(h, w, 0, 0) | _phase_np(h, w, 1, 1))
    m0 = m0.to(y.device)[None, :, :, None]
    return m0.to(y.dtype), (~m0).to(y.dtype)


def dual_prior_train(y, q_step, scales, means, spatial_prior):
    """The training-time 2-pass cross-checkerboard prior (reference
    common_model.py:76-131, dcvc_tpu's EVC.forward_dual_prior): the
    channel halves take opposite phases; the second pass is conditioned
    on the first through spatial_prior.  Returns (y_res, y_q, y_hat,
    scales_hat), y_hat scaled back by the lower-bounded quant step."""
    mask_0, mask_1 = checkerboard_masks(y)
    q_step = torch.clamp_min(q_step, 0.5)
    y = y / q_step
    y_0, y_1 = y.chunk(2, dim=-1)
    s_0, s_1 = scales.chunk(2, dim=-1)
    m_0, m_1 = means.chunk(2, dim=-1)
    r00, q00, h00, sh00 = common.process_with_mask_train(y_0, s_0, m_0,
                                                         mask_0)
    r11, q11, h11, sh11 = common.process_with_mask_train(y_1, s_1, m_1,
                                                         mask_1)
    sp = torch.cat([h00, h11, means, scales,
                    q_step.expand(y.shape).to(y.dtype)], dim=-1)
    s_0, m_0, s_1, m_1 = spatial_prior(sp).chunk(4, dim=-1)
    r01, q01, h01, sh01 = common.process_with_mask_train(y_0, s_0, m_0,
                                                         mask_1)
    r10, q10, h10, sh10 = common.process_with_mask_train(y_1, s_1, m_1,
                                                         mask_0)
    y_res = torch.cat([r00 + r01, r11 + r10], dim=-1)
    y_q = torch.cat([q00 + q01, q11 + q10], dim=-1)
    y_hat = torch.cat([h00 + h01, h11 + h10], dim=-1)
    scales_hat = torch.cat([sh00 + sh01, sh11 + sh10], dim=-1)
    return y_res, y_q, y_hat * q_step, scales_hat


def spatial_params(y_hat_0, q_step, scales, means, dtype):
    """The spatial prior's input at inference: [y_hat part 0, means,
    scales, the quant step broadcast to y's shape]."""
    return torch.cat([y_hat_0.to(dtype), means, scales,
                      q_step.expand(y_hat_0.shape).to(dtype)], dim=-1)


def split_spatial(out):
    """Spatial prior output [s0, m0, s1, m1] -> (scales, means) of the
    second pass, channel halves concatenated."""
    s0, m0, s1, m1 = out.chunk(4, dim=-1)
    return torch.cat([s0, s1], dim=-1), torch.cat([m0, m1], dim=-1)


# ---------------------------------------------------------- building blocks

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


# ---------------------------------------------------------- the P model

def _hem_res(ch):
    """HEM's enc / dec ResidualBlock: conv -> lrelu -> conv -> lrelu
    (+ identity), not FM's lrelu-first ResBlock (reference layers.py:
    75-99 through get_enc_dec_models)."""
    return HEMResBlock(ch, start_from_relu=False, end_with_relu=True)


def bottleneck_res(ch):
    """The contextual coders' bottleneck ResBlock (HEM's and DC's): starts
    from its activation (slope 0.1), as HEM's video_model.py:75-80 builds
    it."""
    return HEMResBlock(ch, slope=0.1, start_from_relu=True,
                       end_with_relu=True, bottleneck=True)


def _hyper_decoder(cin, ch):
    """conv -> subpel 1x1 -> conv to 3/2 ch -> subpel 1x1 -> conv to 2 ch,
    LeakyReLUs between."""
    c15 = ch * 3 // 2
    return seq(ConvK(cin, ch), LReLU(), SubpelConv(ch, ch, r=2, kernel=1),
               LReLU(), ConvK(ch, c15), LReLU(),
               SubpelConv(c15, c15, r=2, kernel=1), LReLU(),
               ConvK(c15, ch * 2))


def _prior_stack(cin, c1, c2, cout):
    """Three 3x3 convs (cin -> c1 -> c2 -> cout) with LeakyReLU(0.2)
    between (the prior fusions and the spatial priors)."""
    return seq(ConvK(cin, c1), LReLU(0.2), ConvK(c1, c2), LReLU(0.2),
               ConvK(c2, cout))


class DMCHEM(nn.Module):
    """DCVC-HEM.  The DPB is a dict {ref_frame, ref_feature, ref_y,
    ref_mv_y}; all but ref_frame are None before the first P frame (the
    reference substitutes zeros for the latents, video_model.py:424-446;
    the stage methods take those zeros from the codec)."""

    def __init__(self, cfg=HEM_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        MV, N, M = c.ch_mv, c.ch_n, c.ch_m
        self.optic_flow = MESpynet()
        self.mv_encoder = seq(
            ResidualBlockWithStrideFM(2, MV), _hem_res(MV),
            ResidualBlockWithStrideFM(MV, MV), _hem_res(MV),
            ResidualBlockWithStrideFM(MV, MV), _hem_res(MV),
            ConvK(MV, MV, stride=2))
        self.mv_decoder = seq(
            _hem_res(MV), ResidualBlockUpsampleFM(MV, MV),
            _hem_res(MV), ResidualBlockUpsampleFM(MV, MV),
            _hem_res(MV), ResidualBlockUpsampleFM(MV, MV),
            _hem_res(MV), SubpelConv(MV, 2, r=2, kernel=1))
        self.mv_hyper_prior_encoder = seq(
            ConvK(MV, N), LReLU(), ConvK(N, N), LReLU(),
            ConvK(N, N, stride=2), LReLU(), ConvK(N, N), LReLU(),
            ConvK(N, N, stride=2))
        self.mv_hyper_prior_decoder = _hyper_decoder(N, MV)
        self.mv_y_prior_fusion = _prior_stack(MV * 3, MV * 3, MV * 3,
                                               MV * 3)
        self.mv_y_spatial_prior = _prior_stack(MV * 4, MV * 3, MV * 3,
                                                MV * 2)

        self.feature_adaptor_I = ConvK(3, N)
        self.feature_adaptor_P = ConvK(N, N, kernel=1)
        # the 3-scale single-width pyramid (video_model.py:17-68)
        self.fx_conv1 = ConvK(N, N)
        self.fx_res1 = ResBlockFM(N)
        self.fx_conv2 = ConvK(N, N, stride=2)
        self.fx_res2 = ResBlockFM(N)
        self.fx_conv3 = ConvK(N, N, stride=2)
        self.fx_res3 = ResBlockFM(N)
        self.cf_conv3_up = SubpelConv(N, N, r=2, kernel=3)
        self.cf_res3_up = ResBlockFM(N)
        self.cf_conv3_out = ConvK(N, N)
        self.cf_res3_out = ResBlockFM(N)
        self.cf_conv2_up = SubpelConv(2 * N, N, r=2, kernel=3)
        self.cf_res2_up = ResBlockFM(N)
        self.cf_conv2_out = ConvK(2 * N, N)
        self.cf_res2_out = ResBlockFM(N)
        self.cf_conv1_out = ConvK(2 * N, N)
        self.cf_res1_out = ResBlockFM(N)

        self.ce_conv1 = ConvK(3 + N, N, stride=2)
        self.ce_res1 = bottleneck_res(2 * N)
        self.ce_conv2 = ConvK(2 * N, N, stride=2)
        self.ce_res2 = bottleneck_res(2 * N)
        self.ce_conv3 = ConvK(2 * N, N, stride=2)
        self.ce_conv4 = ConvK(N, M, stride=2)
        self.cd_up1 = SubpelConv(M, N, r=2, kernel=3)
        self.cd_up2 = SubpelConv(N, N, r=2, kernel=3)
        self.cd_res1 = bottleneck_res(2 * N)
        self.cd_up3 = SubpelConv(2 * N, N, r=2, kernel=3)
        self.cd_res2 = bottleneck_res(2 * N)
        self.cd_up4 = SubpelConv(2 * N, 32, r=2, kernel=3)

        self.contextual_hyper_prior_encoder = seq(
            ConvK(M, N), LReLU(), ConvK(N, N, stride=2), LReLU(),
            ConvK(N, N, stride=2))
        self.contextual_hyper_prior_decoder = _hyper_decoder(N, M)
        self.temporal_prior_encoder = seq(
            ConvK(N, M * 3 // 2, stride=2), LReLU(0.1),
            ConvK(M * 3 // 2, M * 2, stride=2))
        self.y_prior_fusion = _prior_stack(M * 5, M * 4, M * 3, M * 3)
        self.y_spatial_prior = _prior_stack(M * 4, M * 3, M * 3, M * 2)

        self.rg_first_conv = ConvK(32 + N, N)
        self.rg_unet_1 = HEMUNet(N, N)
        self.rg_unet_2 = HEMUNet(N, N)
        self.rg_recon_conv = ConvK(N, 3)

        self.mv_y_q_basic = nn.Parameter(torch.ones(1, 1, 1, MV))
        self.mv_y_q_scale = nn.Parameter(torch.ones(c.anchor_num, 1, 1, 1))
        self.y_q_basic = nn.Parameter(torch.ones(1, 1, 1, M))
        self.y_q_scale = nn.Parameter(torch.ones(c.anchor_num, 1, 1, 1))
        self.bit_estimator_z = common.BitEstimatorModule(1, N)
        self.bit_estimator_z_mv = common.BitEstimatorModule(1, N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model:
        lecun-normal conv and Dense kernels, zero biases, the q vectors and
        scales at one, z prior banks N(0, 0.01).  Draws from `generator`
        (a CPU torch.Generator)."""
        lecun_init_legacy_(self, generator)
        for name in ("mv_y_q_basic", "mv_y_q_scale", "y_q_basic",
                     "y_q_scale"):
            getattr(self, name).fill_(1.0)
        for be in (self.bit_estimator_z, self.bit_estimator_z_mv):
            for p in be.parameters():
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @torch.no_grad()
    def damp_(self, scale):
        """Every conv and Dense kernel times `scale` (the JAX codec's
        init_scale on each `kernel` leaf)."""
        damp_kernels_(self, scale)

    def from_reference(self, state):
        """A reference state_dict (DCVC-HEM's video_model.py module tree)
        -> this model's (dcvc_fm.state_from_reference with key_fn_hem)."""
        return state_from_reference(self, state, key_fn_hem)

    @property
    def dtype(self):
        return self.mv_y_q_basic.dtype

    def _curr_q(self, basic, scale):
        """lower_bound(q_basic, 0.5) x the q scale (a float32 scalar
        tensor), in the model's dtype."""
        return (lower_bound(basic, 0.5) * scale).to(self.dtype)

    # ------------------------------------------------------------ helpers

    def feature_extractor(self, feature):
        l1 = self.fx_res1(self.fx_conv1(feature))
        l2 = self.fx_res2(self.fx_conv2(l1))
        l3 = self.fx_res3(self.fx_conv3(l2))
        return l1, l2, l3

    def context_fusion(self, c1, c2, c3):
        c3_up = self.cf_res3_up(self.cf_conv3_up(c3))
        c3_out = self.cf_res3_out(self.cf_conv3_out(c3))
        cat32 = torch.cat([c3_up, c2], dim=-1)
        c2_up = self.cf_res2_up(self.cf_conv2_up(cat32))
        c2_out = self.cf_res2_out(self.cf_conv2_out(cat32))
        c1_out = self.cf_res1_out(self.cf_conv1_out(
            torch.cat([c2_up, c1], dim=-1)))
        return c1 + c1_out, c2 + c2_out, c3 + c3_out

    def motion_compensation(self, ref_frame, ref_feature, mv):
        ref = ref_frame.to(self.dtype)
        warpframe = flow_warp(ref, mv)
        mv2 = bilinear_downsample_2x(mv) / 2
        mv3 = bilinear_downsample_2x(mv2) / 2
        if ref_feature is None:
            feature = self.feature_adaptor_I(ref)
        else:
            feature = self.feature_adaptor_P(ref_feature.to(self.dtype))
        f1, f2, f3 = self.feature_extractor(feature)
        c1, c2, c3 = self.context_fusion(flow_warp(f1, mv),
                                         flow_warp(f2, mv2),
                                         flow_warp(f3, mv3))
        return c1, c2, c3, warpframe

    def contextual_encoder(self, x, c1, c2, c3):
        f = self.ce_conv1(torch.cat([x, c1], dim=-1))
        f = self.ce_res1(torch.cat([f, c2], dim=-1))
        f = self.ce_res2(torch.cat([self.ce_conv2(f), c3], dim=-1))
        return self.ce_conv4(self.ce_conv3(f))

    def contextual_decoder(self, y_hat, c2, c3):
        f = self.cd_up2(self.cd_up1(y_hat))
        f = self.cd_res1(torch.cat([f, c3], dim=-1))
        f = self.cd_res2(torch.cat([self.cd_up3(f), c2], dim=-1))
        return self.cd_up4(f)

    def recon_generation(self, recon_feat, c1):
        """-> (feature, x_hat in [0, 1] float32).  The reference's argument
        swap makes the concat [recon_feat, c1]."""
        feature = self.rg_first_conv(torch.cat([recon_feat, c1], dim=-1))
        feature = self.rg_unet_2(self.rg_unet_1(feature))
        recon = torch.clamp(self.rg_recon_conv(feature).float(), 0.0, 1.0)
        return feature, recon

    def forward_dual_prior(self, y, means, scales, quant_step,
                           spatial_prior):
        """The 2-pass cross-checkerboard training prior (HEM
        common_model.py:102-145): (y_res, y_q, y_hat, scales_hat)."""
        return dual_prior_train(y, quant_step, scales, means, spatial_prior)

    @staticmethod
    def _fusion_out(params):
        q_step, scales, means = params.chunk(3, dim=-1)
        return lower_bound(q_step, 0.5), scales, means

    # --------------------------------------- inference stage methods
    # (the reference compress / decompress, video_model.py:259-372: the
    # prior, spatial and synthesis stages are shared by the encoder and
    # the decoder; the q scales are float32 scalar tensors)

    def mv_analysis(self, x, ref_frame, mv_y_q_scale):
        """Encoder-only: flow, mv encoding and its hyper encoder ->
        (mv_y float32, mv_z_int int16)."""
        est_mv = self.optic_flow(x.to(self.dtype), ref_frame.to(self.dtype))
        mv_y = self.mv_encoder(est_mv) / self._curr_q(self.mv_y_q_basic,
                                                      mv_y_q_scale)
        return mv_y.float(), z_to_int16(self.mv_hyper_prior_encoder(mv_y))

    def mv_prior(self, mv_z_int, ref_mv_y):
        """Shared: the mv hyper decode and fusion -> (q_step lower-bounded
        at 0.5, scales, means).  ref_mv_y: zeros when the DPB has none
        (video_model.py:271-276)."""
        p = self.mv_hyper_prior_decoder(mv_z_int.to(self.dtype))
        return self._fusion_out(self.mv_y_prior_fusion(
            torch.cat([p, ref_mv_y.to(self.dtype)], dim=-1)))

    def mv_spatial(self, y_hat_0, q_step, scales, means):
        """Shared: the second checkerboard pass's (scales, means)
        (common_model.py:125-127)."""
        return split_spatial(self.mv_y_spatial_prior(spatial_params(
            y_hat_0, q_step, scales, means, self.dtype)))

    def mv_synthesis(self, mv_y_hat, mv_y_q_scale):
        """Shared: -> (mv_y_hat scaled by the q vector, mv_hat)."""
        mv_y_hat = mv_y_hat * self._curr_q(self.mv_y_q_basic,
                                           mv_y_q_scale).float()
        return mv_y_hat, self.mv_decoder(mv_y_hat.to(self.dtype))

    def mc(self, ref_frame, ref_feature, mv_hat):
        """Shared: motion compensation -> (c1, c2, c3); ref_feature None
        on the first P frame."""
        return self.motion_compensation(ref_frame, ref_feature, mv_hat)[:3]

    def ctx_analysis(self, x, c1, c2, c3, y_q_scale):
        """Encoder-only: contextual encoding and its hyper encoder ->
        (y float32, z_int int16)."""
        y = self.contextual_encoder(x.to(self.dtype), c1, c2, c3) \
            / self._curr_q(self.y_q_basic, y_q_scale)
        return y.float(), z_to_int16(self.contextual_hyper_prior_encoder(y))

    def ctx_prior(self, z_int, c3, ref_y):
        """Shared: the contextual prior -> (q_step, scales, means)."""
        hierarchical = self.contextual_hyper_prior_decoder(
            z_int.to(self.dtype))
        temporal = self.temporal_prior_encoder(c3)
        return self._fusion_out(self.y_prior_fusion(torch.cat(
            [temporal, hierarchical, ref_y.to(self.dtype)], dim=-1)))

    def ctx_spatial(self, y_hat_0, q_step, scales, means):
        return split_spatial(self.y_spatial_prior(spatial_params(
            y_hat_0, q_step, scales, means, self.dtype)))

    def synthesis(self, y_hat, c1, c2, c3, y_q_scale):
        """Shared: -> (y_hat scaled by the q vector, x_hat float32 in
        [0, 1], feature)."""
        y_hat = y_hat * self._curr_q(self.y_q_basic, y_q_scale).float()
        recon_feat = self.contextual_decoder(y_hat.to(self.dtype), c2, c3)
        feature, recon = self.recon_generation(recon_feat, c1)
        return y_hat, recon, feature

    # ------------------------------------------------------------ forward

    def forward(self, x, dpb, mv_y_q_scale=None, y_q_scale=None,
                noise=None):
        """The training / eval forward of one P frame (video_model.py:
        413-470).  x (B, H, W, 3) RGB in [0, 1]; dpb as the class says;
        the q scales float32 scalars (the first anchors when None).  noise
        None: the rates of the rounded latents; else a dict of
        U(-0.5, 0.5) tensors {y, mv_y, z, mv_z} or a torch.Generator to
        draw them from in that order.  Returns (result dict, new dpb)."""
        if mv_y_q_scale is None:
            mv_y_q_scale = self.mv_y_q_scale[0, 0, 0, 0]
        if y_q_scale is None:
            y_q_scale = self.y_q_scale[0, 0, 0, 0]
        curr_mv_q = self._curr_q(self.mv_y_q_basic, mv_y_q_scale)
        curr_y_q = self._curr_q(self.y_q_basic, y_q_scale)
        x = x.to(self.dtype)

        est_mv = self.optic_flow(x, dpb["ref_frame"].to(self.dtype))
        mv_y = self.mv_encoder(est_mv) / curr_mv_q
        mv_z = self.mv_hyper_prior_encoder(mv_y)
        mv_z_hat = ste_round(mv_z)
        ref_mv_y = dpb["ref_mv_y"]
        if ref_mv_y is None:
            ref_mv_y = torch.zeros_like(mv_y)
        mv_q_step, mv_scales, mv_means = self.mv_y_prior_fusion(torch.cat(
            [self.mv_hyper_prior_decoder(mv_z_hat), ref_mv_y.to(self.dtype)],
            dim=-1)).chunk(3, dim=-1)
        mv_y_res, mv_y_q, mv_y_hat, mv_scales_hat = self.forward_dual_prior(
            mv_y, mv_means, mv_scales, mv_q_step, self.mv_y_spatial_prior)
        mv_y_hat = mv_y_hat * curr_mv_q
        mv_hat = self.mv_decoder(mv_y_hat)
        c1, c2, c3, warp_frame = self.motion_compensation(
            dpb["ref_frame"], dpb["ref_feature"], mv_hat)

        y = self.contextual_encoder(x, c1, c2, c3) / curr_y_q
        z = self.contextual_hyper_prior_encoder(y)
        z_hat = ste_round(z)
        ref_y = dpb["ref_y"]
        if ref_y is None:
            ref_y = torch.zeros_like(y)
        q_step, scales, means = self.y_prior_fusion(torch.cat(
            [self.temporal_prior_encoder(c3),
             self.contextual_hyper_prior_decoder(z_hat),
             ref_y.to(self.dtype)], dim=-1)).chunk(3, dim=-1)
        y_res, y_q, y_hat, scales_hat = self.forward_dual_prior(
            y, means, scales, q_step, self.y_spatial_prior)
        y_hat = y_hat * curr_y_q
        feature, x_hat = self.recon_generation(
            self.contextual_decoder(y_hat, c2, c3), c1)

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
        pixel_num = x.shape[1] * x.shape[2]
        bpp_y = laplace_bits(y_noisy, scales_hat).sum(dim=(1, 2, 3)) \
            / pixel_num
        bpp_mv_y = laplace_bits(mv_y_noisy, mv_scales_hat).sum(
            dim=(1, 2, 3)) / pixel_num
        bpp_z = probs_to_bits(self.bit_estimator_z.get_prob(
            z_noisy, 0)).sum(dim=(1, 2, 3)) / pixel_num
        bpp_mv_z = probs_to_bits(self.bit_estimator_z_mv.get_prob(
            mv_z_noisy, 0)).sum(dim=(1, 2, 3)) / pixel_num
        mse = torch.mean((x_hat - x.float()) ** 2, dim=(1, 2, 3))
        me_mse = torch.mean((warp_frame.float() - x.float()) ** 2,
                            dim=(1, 2, 3))
        result = {"bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
                  "bpp_mv_z": bpp_mv_z,
                  "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z, "mse": mse,
                  "me_mse": me_mse, "x_hat": x_hat}
        new_dpb = {"ref_frame": x_hat, "ref_feature": feature,
                   "ref_y": y_hat, "ref_mv_y": mv_y_hat}
        return result, new_dpb
