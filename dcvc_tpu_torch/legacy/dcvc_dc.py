"""DCVC-DC (CVPR'23), diverse-context coding (counterpart of
dcvc_tpu/legacy/dcvc_dc.py; reference DCVC-family/DCVC-DC/src/models/
video_model.py, video_net.py): the direct predecessor of DCVC-FM, with
its topology (offset-diversity warping, 3-scale context fusion, the
quadtree 4-part prior with latent-domain conditioning, Laplace rates) on
v1 depth-conv blocks, bottleneck residuals in the contextual transforms,
a DepthConvBlock UNet in the reconstruction, the flat HEM-style hyper
coders, z at ch_16x, the 3-adaptor feature refresh schedule INDEX_MAP
and separate encoder / decoder quant vectors times 4 anchor scalars,
log-interpolated to 64 fine q indexes.  RGB in [0, 1], NHWC.

DMCDC is a DMCFM (legacy/dcvc_fm.py) with DC's modules: the stage
methods keep FM's signatures (mv_prior0, mv_prior_step, mc(..., fa_idx,
...), ctx_prior0, ctx_prior_step; the analysis and synthesis stages take
q_in_ckpt), so that runtime/dc_codec.py is FM's codec with DC's banks.
The module tree mirrors the flax one (a flax leaf `a/b/kernel` is the
state_dict key `a.b.weight`; dc_params_from_jax / dc_params_to_jax in
utils/jax_bridge.py); a reference checkpoint loads through
from_reference (key_fn_dc, utils/keys.py).

The fine quant scalar exp(log(a0) + step * q_index) is computed with
dcvc_fm.get_curr_q (XLA's float32 exp and log, emulated), so it equals
the JAX package's bit for bit.  DC's SpyNet keeps 7x7 convs at every
level, as the JAX model builds it (MESpynet with no level_kernels).
"""

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..core.quant import z_to_int16
from ..models import common
from ..utils.keys import key_fn_dc
from .dcvc_fm import DMCFM, MvDec, MvEnc, OffsetDiversity, get_curr_q, \
    state_from_reference
from .dcvc_hem import bottleneck_res
from .fm_layers import ConvK, DepthConvBlockFM, LReLU, SubpelConv, UNet2, \
    seq
from .spynet import MESpynet

INDEX_MAP = [0, 1, 0, 2]


@dataclasses.dataclass(frozen=True)
class DMCDCConfig:
    ch_1x: int = 48
    ch_2x: int = 64
    ch_4x: int = 96
    ch_8x: int = 96
    ch_16x: int = 128
    ch_mv: int = 64
    ch_n: int = 64
    anchor_num: int = 4
    offset_group: int = 16
    offset_num: int = 2


DC_CONFIG = DMCDCConfig()
TINY_DC_CONFIG = DMCDCConfig(ch_1x=8, ch_2x=8, ch_4x=8, ch_8x=8, ch_16x=8,
                             ch_mv=8, ch_n=8, offset_group=2)
FINE_QP_NUM = 64


def fine_q_scales(anchors, qp_num=FINE_QP_NUM):
    """Log-interpolate the anchors to qp_num fine scales between the first
    and the last (video_model.py:326-341), in float64 numpy."""
    anchors = np.asarray(anchors).reshape(-1)
    return np.exp(np.linspace(np.log(anchors[0]), np.log(anchors[-1]),
                              qp_num))


class DCMvEnc(MvEnc):
    def __init__(self, cfg):
        super().__init__(cfg, block=DepthConvBlockFM)


class DCMvDec(MvDec):
    def __init__(self, cfg):
        super().__init__(cfg, block=DepthConvBlockFM)


class DCContextualEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.conv1 = ConvK(3 + c.ch_1x, c.ch_2x, stride=2)
        self.res1 = bottleneck_res(2 * c.ch_2x)
        self.conv2 = ConvK(2 * c.ch_2x, c.ch_4x, stride=2)
        self.res2 = bottleneck_res(2 * c.ch_4x)
        self.conv3 = ConvK(2 * c.ch_4x, c.ch_8x, stride=2)
        self.conv4 = ConvK(c.ch_8x, c.ch_16x, stride=2)

    def forward(self, x, c1, c2, c3, quant_step):
        f = self.conv1(torch.cat([x, c1], dim=-1))
        f = self.res1(torch.cat([f, c2], dim=-1)) * quant_step
        f = self.res2(torch.cat([self.conv2(f), c3], dim=-1))
        return self.conv4(self.conv3(f))


class DCContextualDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg
        self.up1 = SubpelConv(c.ch_16x, c.ch_8x, r=2, kernel=3)
        self.up2 = SubpelConv(c.ch_8x, c.ch_4x, r=2, kernel=3)
        self.res1 = bottleneck_res(2 * c.ch_4x)
        self.up3 = SubpelConv(2 * c.ch_4x, c.ch_2x, r=2, kernel=3)
        self.res2 = bottleneck_res(2 * c.ch_2x)
        self.up4 = SubpelConv(2 * c.ch_2x, 32, r=2, kernel=3)

    def forward(self, x, c2, c3, quant_step):
        f = self.up2(self.up1(x))
        f = self.res1(torch.cat([f, c3], dim=-1))
        f = self.up3(f) * quant_step
        f = self.res2(torch.cat([f, c2], dim=-1))
        return self.up4(f)


class DCUNet(UNet2):
    """DC's 3-level UNet over DepthConvBlock (reference UNet,
    DCVC-DC/src/models/video_net.py:129-171)."""

    def __init__(self, in_ch, out_ch=64):
        super().__init__(in_ch, out_ch, block=DepthConvBlockFM)


class DCReconGeneration(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch = cfg.ch_1x
        self.first_conv = ConvK(ch + 32, ch)
        self.unet_1 = DCUNet(ch, ch)
        self.unet_2 = DCUNet(ch, ch)
        self.recon_conv = ConvK(ch, 3)

    def forward(self, res, ctx):
        # DC's ReconGeneration.forward(ctx, res) concatenates (ctx, res)
        # and is called as recon_generation_net(recon_feat, c1)
        # (video_model.py:227-232): the concat is [c1, recon_feat]
        f = self.first_conv(torch.cat([ctx, res], dim=-1))
        f = self.unet_2(self.unet_1(f))
        return f, self.recon_conv(f)


def _hyper_encoder(cin, ch, n_convs):
    """The flat hyper encoder (video_net.py:217-251): 3x3 convs with
    strides (1, 1, 2, 1, 2), or (1, 2, 2) for the contextual side's
    reduce_enc_layer variant, LeakyReLUs between."""
    strides = (1, 1, 2, 1, 2) if n_convs == 5 else (1, 2, 2)
    mods = []
    for i, s in enumerate(strides):
        mods += [ConvK(cin if i == 0 else ch, ch, stride=s), LReLU()]
    return seq(*mods[:-1])


def _hyper_decoder(cin, ch):
    """conv, subpel 1x1, conv, subpel 1x1, conv, LeakyReLUs between."""
    return seq(ConvK(cin, ch), LReLU(), SubpelConv(ch, ch, r=2, kernel=1),
               LReLU(), ConvK(ch, ch), LReLU(),
               SubpelConv(ch, ch, r=2, kernel=1), LReLU(), ConvK(ch, ch))


class DMCDC(DMCFM):
    """DCVC-DC.  The DPB is FM's dict {ref_frame, ref_feature,
    ref_mv_feature, ref_y, ref_mv_y}."""

    Q_PARAMS = ("mv_y_q_basic_enc", "mv_y_q_scale_enc", "mv_y_q_basic_dec",
                "mv_y_q_scale_dec", "y_q_basic_enc", "y_q_scale_enc",
                "y_q_basic_dec", "y_q_scale_dec")

    def __init__(self, cfg=DC_CONFIG):
        nn.Module.__init__(self)
        c = self.cfg = cfg
        self.optic_flow = MESpynet()
        self.align = OffsetDiversity(c)
        self.mv_encoder = DCMvEnc(c)
        self.mv_hyper_prior_encoder = _hyper_encoder(c.ch_mv, c.ch_n, 5)
        self.mv_hyper_prior_decoder = _hyper_decoder(c.ch_n, c.ch_mv)
        self._add_mv_prior(c)
        self.mv_decoder = DCMvDec(c)

        self._add_contexts(c)

        self.contextual_encoder = DCContextualEncoder(c)
        self.contextual_hyper_prior_encoder = _hyper_encoder(c.ch_16x,
                                                             c.ch_16x, 3)
        self.contextual_hyper_prior_decoder = _hyper_decoder(c.ch_16x,
                                                             c.ch_16x)
        self._add_y_prior(c)
        self.contextual_decoder = DCContextualDecoder(c)
        self.recon_generation_net = DCReconGeneration(c)

        basic_widths = {"mv_y_q_basic_enc": c.ch_mv,
                        "mv_y_q_basic_dec": c.ch_mv,
                        "y_q_basic_enc": 2 * c.ch_2x,
                        "y_q_basic_dec": c.ch_2x}
        for name in self.Q_PARAMS:
            shape = (1, 1, 1, basic_widths[name]) if name in basic_widths \
                else (c.anchor_num, 1, 1, 1)
            setattr(self, name, nn.Parameter(torch.ones(shape)))
        self.bit_estimator_z = common.BitEstimatorModule(1, c.ch_16x)
        self.bit_estimator_z_mv = common.BitEstimatorModule(1, c.ch_n)

    def from_reference(self, state):
        """A reference state_dict (DCVC-DC's video_model.py module tree)
        -> this model's (dcvc_fm.state_from_reference with key_fn_dc)."""
        return state_from_reference(self, state, key_fn_dc)

    def _q(self, name, q_index, q_in_ckpt=False):
        """The quant vector `name` (mv_y_q_enc, mv_y_q_dec, y_q_enc,
        y_q_dec): q_basic times anchor q_index when q_in_ckpt, else times
        the fine scale of q_index on the 64-level log ladder between the
        first and the last anchor (the JAX package's value bit for bit),
        in the model's dtype."""
        basic = getattr(self, name.replace("_q_", "_q_basic_"))
        anchors = getattr(self, name.replace("_q_", "_q_scale_")).reshape(-1)
        if q_in_ckpt:
            scale = anchors[q_index]
        else:
            scale = get_curr_q(anchors[[0, -1]], q_index, FINE_QP_NUM)
        return (basic * scale).to(self.dtype)

    # --------------------------------------- inference stage methods
    # (FM's, runtime/fm_codec.py; the ones that take a quant vector also
    # take q_in_ckpt)

    def mv_analysis(self, x, ref_frame, ref_mv_feature, q_index,
                    q_in_ckpt=False):
        est_mv = self.optic_flow(x.to(self.dtype), ref_frame.to(self.dtype))
        mv_y = self.mv_encoder(est_mv, ref_mv_feature,
                               self._q("mv_y_q_enc", q_index, q_in_ckpt))
        mv_z = self.mv_hyper_prior_encoder(self._pad4(mv_y))
        return mv_y.float(), z_to_int16(mv_z)

    def mv_synthesis(self, mv_y_hat, q_index, q_in_ckpt=False):
        return self.mv_decoder(mv_y_hat.to(self.dtype),
                               self._q("mv_y_q_dec", q_index, q_in_ckpt))

    def ctx_analysis(self, x, c1, c2, c3, q_index, q_in_ckpt=False):
        y = self.contextual_encoder(x.to(self.dtype), c1, c2, c3,
                                    self._q("y_q_enc", q_index, q_in_ckpt))
        z = self.contextual_hyper_prior_encoder(self._pad4(y))
        return y.float(), z_to_int16(z)

    def synthesis(self, y_hat, c1, c2, c3, q_index, q_in_ckpt=False):
        recon_feat = self.contextual_decoder(
            y_hat.to(self.dtype), c2, c3,
            self._q("y_q_dec", q_index, q_in_ckpt))
        feature, x_hat = self.recon_generation_net(recon_feat, c1)
        return torch.clamp(x_hat.float(), 0.0, 1.0), feature

    # ------------------------------------------------------------ forward

    def forward(self, x, dpb, q_index, frame_idx, noise=None):
        """The training / eval forward of one P frame (video_model.py:
        466-...): q_index selects an anchor (0 .. anchor_num - 1), the
        feature adaptor is INDEX_MAP[frame_idx % 4].  noise and the
        returns as DMCFM.forward's."""
        q = {name: self._q(name, q_index, q_in_ckpt=True) for name in
             ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec")}
        return self._forward(x, dpb, q, INDEX_MAP[frame_idx % 4], noise)
