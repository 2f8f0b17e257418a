"""DCVC-TCM (TMM'22), temporal context mining (counterpart of dcvc_tpu/
legacy/dcvc_tcm.py; reference DCVC-family/DCVC-TCM/src/models/
video_net_dmc.py).

SpyNet flow (7x7 at every level) -> GDN motion auto-encoder with a
hyperprior -> a 3-scale feature pyramid mined from the propagated
feature-domain DPB (the previous frame's feature; on the first P frame
after an intra frame, the frame itself through feature_adaptor_I) and
flow-warped into 3 contexts -> GDN contextual coding at 3 scales, the
hyper prior and a temporal prior over all 3 contexts fused into the
Laplace y parameters (no AR model), and the reconstruction generated from
the decoded feature and the first context.  RGB in [0, 1], NHWC.

The module tree mirrors the flax one (legacy/fm_layers.py): a flax
Sequential's layers are `layers_{i}` (its activation lambdas
parameter-free LReLU modules at their indexes, so mv_encoder's parameters
sit at 0, 1, 2, 4, 5, 6, 8, 9, 10, 12 as in the reference), a flax leaf
`a/b/kernel` is the state_dict key `a.b.weight`, and a flax ConvTranspose
is a `Deconv` holding ConvTranspose2d's weight (utils/jax_bridge.py:
tcm_params_from_jax / _to_jax).  A reference checkpoint loads through
from_reference (key_fn_tcm, utils/keys.py).

The stage methods are runtime/tcm_codec.py's: the analysis stages emit
int16 z, the prior, motion-compensation and synthesis stages are shared by
the encoder and the decoder.  forward() is the training forward of one P
frame on rounded latents (the family runner's estimated-bits mode).
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.quant import ste_round, z_to_int16
from ..models import common
from ..utils.keys import key_fn_tcm
from .dcvc_fm import state_from_reference
from .dcvc_hem import HEMResBlock
from .dcvc_net import Deconv, _conv, damp_legacy_, init_legacy_, \
    laplace_bits_sum, z_bits_sum
from .fm_layers import ConvK, LReLU, SubpelConv, seq
from .gdn import GDN
from .ops import bilinear_downsample_2x, flow_warp
from .spynet import MESpynet


@dataclasses.dataclass(frozen=True)
class DMCTCMConfig:
    ch_mv: int = 128
    ch_n: int = 64
    ch_m: int = 96


TCM_CONFIG = DMCTCMConfig()
TINY_TCM_CONFIG = DMCTCMConfig(ch_mv=8, ch_n=8, ch_m=8)


def _bres(ch):
    """The contextual coders' bottleneck ResBlock (slope 0.1, no leading
    activation, one at the end)."""
    return HEMResBlock(ch, slope=0.1, start_from_relu=False,
                       end_with_relu=True, bottleneck=True)


def _hyper_encoder(cin, n):
    """3x3 conv, then two stride-2 3x3 convs, LeakyReLUs between."""
    return seq(_conv(cin, n, 3), LReLU(), _conv(n, n, 3, 2), LReLU(),
               _conv(n, n, 3, 2))


def _hyper_decoder(n, c):
    """Two stride-2 3x3 deconvs (to c, then 3/2 c) and a stride-1 one to
    2 c, LeakyReLUs between."""
    return seq(Deconv(n, c, 3, 2), LReLU(), Deconv(c, c * 3 // 2, 3, 2),
               LReLU(), Deconv(c * 3 // 2, c * 2, 3, 1))


class DMCTCM(nn.Module):
    """The TCM P-frame model.  Its DPB is (ref_frame, ref_feature);
    ref_feature is None on the first P frame after an intra frame."""

    def __init__(self, cfg=TCM_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        MV, N, M = c.ch_mv, c.ch_n, c.ch_m
        self.optic_flow = MESpynet()

        mv_enc = []
        for i in range(3):
            mv_enc += [_conv(2 if i == 0 else MV, MV, 3, 2), GDN(MV),
                       HEMResBlock(MV, start_from_relu=False), LReLU(0.1)]
        self.mv_encoder = seq(*mv_enc, _conv(MV, MV, 3, 2))
        self.mv_prior_encoder = _hyper_encoder(MV, N)
        self.mv_prior_decoder = _hyper_decoder(N, MV)
        self.mv_decoder = seq(
            Deconv(MV, MV, 3, 2), LReLU(0.1),
            HEMResBlock(MV, start_from_relu=False), GDN(MV, inverse=True),
            Deconv(MV, MV, 3, 2), GDN(MV, inverse=True),
            Deconv(MV, MV, 3, 2), GDN(MV, inverse=True),
            Deconv(MV, 2, 3, 2))

        self.feature_adaptor_I = _conv(3, N, 3)
        self.feature_adaptor_P = ConvK(N, N, kernel=1)

        self.fx_conv1 = _conv(N, N, 3)
        self.fx_res1 = HEMResBlock(N)
        self.fx_conv2 = _conv(N, N, 3, 2)
        self.fx_res2 = HEMResBlock(N)
        self.fx_conv3 = _conv(N, N, 3, 2)
        self.fx_res3 = HEMResBlock(N)

        self.cf_conv3_up = SubpelConv(N, N, r=2, kernel=3)
        self.cf_res3_up = HEMResBlock(N)
        self.cf_conv3_out = _conv(N, N, 3)
        self.cf_res3_out = HEMResBlock(N)
        self.cf_conv2_up = SubpelConv(2 * N, N, r=2, kernel=3)
        self.cf_res2_up = HEMResBlock(N)
        self.cf_conv2_out = _conv(2 * N, N, 3)
        self.cf_res2_out = HEMResBlock(N)
        self.cf_conv1_out = _conv(2 * N, N, 3)
        self.cf_res1_out = HEMResBlock(N)

        # the contextual encoder: GDN at 3 scales (video_net_dmc.py:71-97)
        self.ce_conv1 = _conv(3 + N, N, 3, 2)
        self.ce_gdn1 = GDN(N)
        self.ce_res1 = _bres(2 * N)
        self.ce_conv2 = _conv(2 * N, N, 3, 2)
        self.ce_gdn2 = GDN(N)
        self.ce_res2 = _bres(2 * N)
        self.ce_conv3 = _conv(2 * N, N, 3, 2)
        self.ce_gdn3 = GDN(N)
        self.ce_conv4 = _conv(N, M, 3, 2)

        self.cd_up1 = SubpelConv(M, N, r=2, kernel=3)
        self.cd_gdn1 = GDN(N, inverse=True)
        self.cd_up2 = SubpelConv(N, N, r=2, kernel=3)
        self.cd_gdn2 = GDN(N, inverse=True)
        self.cd_res1 = _bres(2 * N)
        self.cd_up3 = SubpelConv(2 * N, N, r=2, kernel=3)
        self.cd_gdn3 = GDN(N, inverse=True)
        self.cd_res2 = _bres(2 * N)
        self.cd_up4 = SubpelConv(2 * N, 32, r=2, kernel=3)

        self.contextual_hyper_prior_encoder = _hyper_encoder(M, N)
        self.contextual_hyper_prior_decoder = _hyper_decoder(N, M)

        # the temporal prior over the 3 contexts (GDN, :127-147)
        self.tp_conv1 = _conv(N, N, 3, 2)
        self.tp_gdn1 = GDN(N)
        self.tp_conv2 = _conv(2 * N, M, 3, 2)
        self.tp_gdn2 = GDN(M)
        self.tp_conv3 = _conv(M + N, M * 3 // 2, 3, 2)
        self.tp_gdn3 = GDN(M * 3 // 2)
        self.tp_conv4 = _conv(M * 3 // 2, M * 2, 3, 2)

        self.contextual_entropy_parameter = seq(
            _conv(M * 4, M * 10 // 3, 3), LReLU(),
            _conv(M * 10 // 3, M * 8 // 3, 3), LReLU(),
            _conv(M * 8 // 3, M * 6 // 3, 3))

        self.rg_conv = _conv(32 + N, N, 3)
        self.rg_res1 = HEMResBlock(N)
        self.rg_res2 = HEMResBlock(N)
        self.rg_recon_conv = _conv(N, 3, 3)

        self.bit_estimator_z = common.BitEstimatorModule(1, N)
        self.bit_estimator_z_mv = common.BitEstimatorModule(1, N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model
        (dcvc_net.init_legacy_: lecun-normal conv and deconv kernels, zero
        biases, GDN at its own init), the z prior banks N(0, 0.01).  Draws
        from `generator` (a CPU torch.Generator)."""
        init_legacy_(self, generator)
        for be in (self.bit_estimator_z, self.bit_estimator_z_mv):
            for p in be.parameters():
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @torch.no_grad()
    def damp_(self, scale):
        """Every conv and deconv kernel times `scale` (the JAX codec's
        init_scale on each param leaf named `kernel`)."""
        damp_legacy_(self, scale)

    def from_reference(self, state):
        """A reference state_dict (video_net_dmc.py's module tree) -> this
        model's: the z priors' Bitparm tensors stacked into their h / b /
        a banks, every other tensor renamed by key_fn_tcm (conv and
        ConvTranspose2d weights keep their torch layouts)."""
        return state_from_reference(self, state, key_fn_tcm)

    @property
    def dtype(self):
        return self.rg_recon_conv.weight.dtype

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
        """-> (c1, c2, c3, warped frame); ref_feature None: the pyramid is
        mined from the frame (feature_adaptor_I), else from the feature
        (feature_adaptor_P)."""
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
        f = self.ce_gdn1(self.ce_conv1(torch.cat([x, c1], dim=-1)))
        f = self.ce_res1(torch.cat([f, c2], dim=-1))
        f = self.ce_gdn2(self.ce_conv2(f))
        f = self.ce_res2(torch.cat([f, c3], dim=-1))
        return self.ce_conv4(self.ce_gdn3(self.ce_conv3(f)))

    def temporal_prior(self, c1, c2, c3):
        t = self.tp_gdn1(self.tp_conv1(c1))
        t = self.tp_gdn2(self.tp_conv2(torch.cat([t, c2], dim=-1)))
        t = self.tp_gdn3(self.tp_conv3(torch.cat([t, c3], dim=-1)))
        return self.tp_conv4(t)

    def entropy_params(self, temporal, hierarchical):
        """-> (scales, means) of y."""
        return self.contextual_entropy_parameter(torch.cat(
            [temporal, hierarchical], dim=-1)).chunk(2, dim=-1)

    def contextual_decoder(self, y_hat, c1, c2, c3):
        """-> (recon (unclipped), feature).  The reference's argument
        swap makes the recon head's concat [recon_feat, c1]."""
        rf = self.cd_gdn1(self.cd_up1(y_hat))
        rf = self.cd_gdn2(self.cd_up2(rf))
        rf = self.cd_res1(torch.cat([rf, c3], dim=-1))
        rf = self.cd_gdn3(self.cd_up3(rf))
        rf = self.cd_res2(torch.cat([rf, c2], dim=-1))
        recon_feat = self.cd_up4(rf)
        feature = self.rg_res2(self.rg_res1(self.rg_conv(
            torch.cat([recon_feat, c1], dim=-1))))
        return self.rg_recon_conv(feature), feature

    # --------------------------------------- inference stage methods
    # (the reference compress / decompress, video_net_dmc.py:321-380:
    # one-shot dense coding, no spatial steps; the prior, mc and
    # synthesis stages are shared by the encoder and the decoder)

    def mv_analysis(self, x, ref_frame):
        """Encoder-only: flow, mv encoding and its hyper encoder ->
        (mv_y float32, mv_z_int int16)."""
        est_mv = self.optic_flow(x.to(self.dtype), ref_frame.to(self.dtype))
        mv_y = self.mv_encoder(est_mv)
        return mv_y.float(), z_to_int16(self.mv_prior_encoder(mv_y))

    def mv_prior(self, mv_z_int):
        """Shared: (scales, means) float32 of the dense mv grid."""
        scales, means = self.mv_prior_decoder(
            mv_z_int.to(self.dtype)).chunk(2, dim=-1)
        return scales.float(), means.float()

    def mv_synthesis(self, mv_y_hat):
        return self.mv_decoder(mv_y_hat.to(self.dtype))

    def mc(self, ref_frame, ref_feature, mv_hat):
        """Shared: motion compensation -> (c1, c2, c3); ref_feature None
        on the first P frame after an intra frame."""
        return self.motion_compensation(ref_frame, ref_feature, mv_hat)[:3]

    def ctx_analysis(self, x, c1, c2, c3):
        """Encoder-only: contextual encoding and its hyper encoder ->
        (y float32, z_int int16)."""
        y = self.contextual_encoder(x.to(self.dtype), c1, c2, c3)
        return y.float(), z_to_int16(self.contextual_hyper_prior_encoder(y))

    def ctx_prior(self, z_int, c1, c2, c3):
        """Shared: the hyper and temporal priors -> (scales, means)
        float32."""
        hierarchical = self.contextual_hyper_prior_decoder(
            z_int.to(self.dtype))
        scales, means = self.entropy_params(self.temporal_prior(c1, c2, c3),
                                            hierarchical)
        return scales.float(), means.float()

    def synthesis(self, y_hat, c1, c2, c3):
        """Shared: -> (x_hat float32 in [0, 1], feature)."""
        recon, feature = self.contextual_decoder(y_hat.to(self.dtype), c1,
                                                 c2, c3)
        return torch.clamp(recon.float(), 0.0, 1.0), feature

    # ------------------------------------------------------------ forward

    def forward(self, x, ref_frame, ref_feature):
        """The training forward of one P frame (video_net_dmc.py:430-...)
        on rounded latents.  x, ref_frame (B, H, W, 3) RGB in [0, 1];
        ref_feature the DPB's feature or None.  Returns the four bpp terms
        (over x's pixels), bpp, mse, me_mse, recon_image (unclipped,
        float32) and feature."""
        x = x.to(self.dtype)
        ref_frame = ref_frame.to(self.dtype)
        est_mv = self.optic_flow(x, ref_frame)
        mv_y = self.mv_encoder(est_mv)
        mv_z_hat = ste_round(self.mv_prior_encoder(mv_y))
        mv_scales, mv_means = self.mv_prior_decoder(mv_z_hat).chunk(2,
                                                                    dim=-1)
        mv_y_q = ste_round(mv_y - mv_means)
        mv_hat = self.mv_decoder(mv_y_q + mv_means)
        c1, c2, c3, warp_frame = self.motion_compensation(
            ref_frame, ref_feature, mv_hat)

        y = self.contextual_encoder(x, c1, c2, c3)
        z_hat = ste_round(self.contextual_hyper_prior_encoder(y))
        scales, means = self.entropy_params(
            self.temporal_prior(c1, c2, c3),
            self.contextual_hyper_prior_decoder(z_hat))
        y_q = ste_round(y - means)
        recon, feature = self.contextual_decoder(y_q + means, c1, c2, c3)
        recon_image = recon.float()

        pixel_num = x.shape[1] * x.shape[2]
        bpp_y = laplace_bits_sum(y_q, scales) / pixel_num
        bpp_mv_y = laplace_bits_sum(mv_y_q, mv_scales) / pixel_num
        bpp_z = z_bits_sum(z_hat, self.bit_estimator_z) / pixel_num
        bpp_mv_z = z_bits_sum(mv_z_hat, self.bit_estimator_z_mv) / pixel_num
        mse = torch.mean((recon_image - x.float()) ** 2, dim=(1, 2, 3))
        me_mse = torch.mean((warp_frame.float() - x.float()) ** 2,
                            dim=(1, 2, 3))
        return {"bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
                "bpp_mv_z": bpp_mv_z,
                "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z,
                "mse": mse, "me_mse": me_mse, "recon_image": recon_image,
                "feature": feature}
