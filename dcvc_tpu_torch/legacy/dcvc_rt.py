"""DCVC-RT P-frame codec model (counterpart of dcvc_tpu/legacy/dcvc_rt.py;
reference DCVC-RT/src/models/video_model.py).

No motion module: the temporal context comes from a feature adaptor (a
DepthConvBlock on the intra frame's 8x-unshuffled pixels, a 1x1 conv on
the previous decoder feature) and a feature extractor over a one-slot
DPB.  One latent (y 128ch @ /16, decoder feature 256ch, recon trunk
320ch), a 2-step checkerboard prior whose second step emits scales and
means (so the codec decodes it as a ladder, like HTL), and module-bank
rate control: the per-QP vectors and the z prior have qp_num + EXTRA_QP
rows for the periodic qp_shift = [0, 8, 4] schedule (`shift_qp`).  The
signal domain is [0, 1] (the reference feeds x / 255), and every
reconstruction is clamped to it.

RT's DepthConvBlock is not UF's: its FFN chunk-add is two-way (the 4C
activation's halves summed into 2C lanes of ffn_out), so it is not the
fused kernel's block.  The JAX package computes it in plain flax, outside
any Pallas kernel, and the port computes it in plain PyTorch
(`DepthConvBlockRT`), on the card too.

The module tree gives the reference key names that dcvc_tpu's importer
maps the flax params to (`key_fn_rt`, copied in utils/keys.py):
`feature_adaptor_i.adaptor.weight`, `feature_extractor.conv2.3.dc.0.weight`,
`hyper_encoder.conv.1.down.weight`, `temporal_prior_encoder.conv.ffn.2.bias`,
`recon_generation_net.head.weight`, ...; the z prior keeps the port's
`bit_estimator_z.{h,b,a}` banks (the reference's `f1..f4` Bitparm tensors
are stacked into them on load, `DMCRT.from_reference`).

The stage methods follow the video runtime's protocol (prior_steps=2,
single_pass=False); `forward(x, ref_feature, memory, qp, noise)` is the
training forward of one frame.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.masks import make_mask_2x
from ..core.padding import pad_for_y
from ..core.quant import ste_round
from ..core.shuffle import pixel_shuffle, pixel_unshuffle
from ..layers.blocks import (
    Conv1x1, Conv2x2Stride2, Conv3x3, DepthwiseConv3x3, SubpelConv2x, WSiLU,
    lecun_init_,
)
from ..models import common
from ..models.dmc_ld import Wrap
from ..runtime.video_codec import VideoCodecBase
from ..utils.keys import key_fn_rt
from ..utils.profiling import spanned

QP_SHIFT = [0, 8, 4]
EXTRA_QP = max(QP_SHIFT)
# fa schedule driving the qp_shift (reference test_video.py:164,197)
INDEX_MAP = [0, 1, 0, 2, 0, 2, 0, 2]


@dataclasses.dataclass(frozen=True)
class DMCRTConfig:
    ch_src_d: int = 3 * 8 * 8
    ch_y: int = 128
    ch_z: int = 128
    ch_d: int = 256
    ch_recon: int = 320
    qp_num: int = 64
    frame_delay: int = 1
    prior_steps: int = 2
    single_pass: bool = False     # scales change at step 1 -> ladder

    @property
    def qp_bank(self):
        return self.qp_num + EXTRA_QP


RT_CONFIG = DMCRTConfig()
TINY_RT_CONFIG = DMCRTConfig(ch_y=16, ch_z=8, ch_d=32, ch_recon=32,
                             qp_num=8)


def shift_qp(qp, fa_idx, qp_num=64):
    """Module-bank rate control: periodic refresh positions use shifted
    q banks (reference video_model.py:378-...)."""
    return min(qp + QP_SHIFT[fa_idx], qp_num + EXTRA_QP - 1)


class DepthConvBlockRT(nn.Module):
    """RT's DepthConvBlock (DCVC-RT/src/layers/layers.py:65-83): UF's dc
    trunk, and an FFN whose 4C activation is split in two halves that are
    summed into ffn_out's 2C inputs.  The parameters keep UF's names
    (`adaptor`, `dc.0/2/3`, `ffn.0/2`).  Each call is a span `dcb.rt`
    while torch.profiler is on."""

    def __init__(self, in_ch, out_ch, shortcut=False, force_adaptor=False):
        super().__init__()
        self.shortcut = shortcut
        self.adaptor = Conv1x1(in_ch, out_ch) \
            if in_ch != out_ch or force_adaptor else None
        self.dc = nn.Sequential(Conv1x1(out_ch, out_ch), WSiLU(),
                                DepthwiseConv3x3(out_ch),
                                Conv1x1(out_ch, out_ch))
        self.ffn = nn.Sequential(Conv1x1(out_ch, 4 * out_ch), WSiLU(),
                                 Conv1x1(2 * out_ch, out_ch))

    @spanned("dcb.rt")
    def forward(self, x):
        if self.adaptor is not None:
            x = self.adaptor(x)
        h = self.dc[1](self.dc[0](x))
        dw = self.dc[2]
        h = F.conv2d(h.permute(0, 3, 1, 2), dw.weight, dw.bias, padding=1,
                     groups=h.shape[-1]).permute(0, 2, 3, 1)
        out = self.dc[3](h) + x
        f1, f2 = self.ffn[1](self.ffn[0](out)).chunk(2, dim=-1)
        out = self.ffn[2](f1 + f2) + out
        if self.shortcut:
            out = out + x
        return out


class ResidualBlockWithStride2(nn.Module):
    """RT's RBWS2 (layers.py:135-144): a 2x2 stride-2 conv (not UF's
    unshuffle + 1x1) and a shortcut DCB."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.down = Conv2x2Stride2(in_ch, out_ch)
        self.conv = DepthConvBlockRT(out_ch, out_ch, shortcut=True)

    def forward(self, x):
        return self.conv(self.down(x))


class ResidualBlockUpsample(nn.Module):
    """RT's RBU (layers.py:147-156): a subpel 1x1 with a bias (RT's subpel
    convs always carry one, layers.py:29-35) and a shortcut DCB."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.up = SubpelConv2x(in_ch, out_ch, 1, force_bias=True)
        self.conv = DepthConvBlockRT(out_ch, out_ch, shortcut=True)

    def forward(self, x):
        return self.conv(self.up(x))


def _dcbs(chs):
    return nn.Sequential(*[DepthConvBlockRT(ci, co) for ci, co in chs])


class RTFeatureExtractor(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = _dcbs([(c.ch_d, c.ch_d)] * 2)
        self.conv2 = _dcbs([(c.ch_d, c.ch_d)] * 4)

    def forward(self, x, quant):
        x1 = self.conv1(x)
        return self.conv2(x1), x1 * quant       # (ctx, ctx_t)


class RTEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = Conv1x1(c.ch_src_d, c.ch_d)
        self.conv2 = _dcbs([(c.ch_d * 2, c.ch_d), (c.ch_d, c.ch_d)])
        self.conv3 = DepthConvBlockRT(c.ch_d, c.ch_d)
        self.down = Conv3x3(c.ch_d, c.ch_y, stride=2)

    def forward(self, x, ctx, quant_step):
        f = self.conv1(pixel_unshuffle(x, 8))
        f = self.conv3(self.conv2(torch.cat([f, ctx], dim=-1)))
        return self.down(f * quant_step)


class RTDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.up = SubpelConv2x(c.ch_y, c.ch_d, 3)
        self.conv1 = _dcbs([(c.ch_d * 2, c.ch_d)] + [(c.ch_d, c.ch_d)] * 2)
        self.conv2 = Conv1x1(c.ch_d, c.ch_d)

    def forward(self, y_hat, ctx, quant_step):
        f = torch.cat([self.up(y_hat), ctx], dim=-1)
        return self.conv2(self.conv1(f)) * quant_step


class RTReconGeneration(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = _dcbs([(c.ch_d, c.ch_recon)]
                          + [(c.ch_recon, c.ch_recon)] * 3)
        self.head = Conv1x1(c.ch_recon, c.ch_src_d)

    def forward(self, x, quant_step):
        out = pixel_shuffle(self.head(self.conv(x) * quant_step), 8)
        return torch.clamp(out, 0.0, 1.0)


class DMCRT(nn.Module):
    """RT P-frame codec (reference DMC, DCVC-RT video_model.py) with the
    stage methods of the video runtime."""

    def __init__(self, cfg=RT_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        cy = c.ch_y
        self.feature_adaptor_i = DepthConvBlockRT(c.ch_src_d, c.ch_d)
        self.feature_adaptor_p = Conv1x1(c.ch_d, c.ch_d)
        self.feature_extractor = RTFeatureExtractor(c)
        self.encoder = RTEncoder(c)
        self.hyper_encoder = Wrap(nn.Sequential(
            DepthConvBlockRT(cy, c.ch_z),
            ResidualBlockWithStride2(c.ch_z, c.ch_z),
            ResidualBlockWithStride2(c.ch_z, c.ch_z)))
        self.hyper_decoder = Wrap(nn.Sequential(
            ResidualBlockUpsample(c.ch_z, c.ch_z),
            ResidualBlockUpsample(c.ch_z, c.ch_z),
            DepthConvBlockRT(c.ch_z, cy)))
        self.temporal_prior_encoder = ResidualBlockWithStride2(c.ch_d, cy * 2)
        self.y_prior_fusion = Wrap(nn.Sequential(
            *[DepthConvBlockRT(cy * 3, cy * 3) for _ in range(3)],
            Conv1x1(cy * 3, cy * 3)))
        self.y_spatial_prior = Wrap(nn.Sequential(
            DepthConvBlockRT(cy * 4, cy * 3),
            DepthConvBlockRT(cy * 3, cy * 3),
            Conv1x1(cy * 3, cy * 2)))
        self.decoder = RTDecoder(c)
        self.recon_generation_net = RTReconGeneration(c)
        qb = c.qp_bank
        self.q_encoder = nn.Parameter(torch.ones(qb, c.ch_d))
        self.q_decoder = nn.Parameter(torch.ones(qb, c.ch_d))
        self.q_feature = nn.Parameter(torch.ones(qb, c.ch_d))
        self.q_recon = nn.Parameter(torch.ones(qb, c.ch_recon))
        self.bit_estimator_z = common.BitEstimatorModule(qb, c.ch_z)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as dcvc_tpu's DMCRT.init does it: lecun-normal
        convs with zero biases, the per-QP vectors at one, and N(0, 0.01)
        z prior banks.  Draws from `generator` (a CPU torch.Generator)."""
        lecun_init_(self, generator)
        for name in ("q_encoder", "q_decoder", "q_feature", "q_recon"):
            getattr(self, name).fill_(1.0)
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    def from_reference(self, state):
        """A reference state_dict (DCVC-RT's) -> this model's: the z
        prior's Bitparm tensors (`bit_estimator_z.f{i}.{h,b,a}`, each (Q,
        C, 1, 1), Q may be 1) stacked on a last axis into the h / b / a
        banks, as dcvc_tpu's importer does for key_fn_rt's `stack_last`
        entries; every other key as it is."""
        return self.bit_estimator_z.from_reference(state, key_fn_rt)

    @property
    def dtype(self):
        return self.q_encoder.dtype

    def _q(self, table, qp):
        return common.select_qp(table, qp)

    # ------------------------------------------------ runtime stage protocol

    def adaptor_i(self, ref_feature):
        """ref_feature: the 8x-unshuffled frame (192ch).  Returns (memory,
        ctx), both the adapted feature: the runtime threads it as the
        memory and as the context of analysis / prior0 / synthesis."""
        feature = self.feature_adaptor_i(ref_feature.to(self.dtype))
        return feature, feature

    def adaptor_m(self, memory, ref_feature):
        feature = self.feature_adaptor_p(ref_feature.to(self.dtype))
        return feature, feature

    def reset_feature(self, feature):
        """Feature refresh: re-seed through the recon head at bank 0."""
        frame = self.recon_generation_net(feature.to(self.dtype),
                                          self._q(self.q_recon, 0))
        return pixel_unshuffle(frame, 8)

    def analysis(self, x, feature, qp):
        """Padded frame (1, H, W, 3) in [0, 1] and the adapted feature ->
        (y, z_int8); y is replicate-padded to 4 for the hyper path alone
        (RT video_model.py:311)."""
        ctx, _ = self.feature_extractor(feature, self._q(self.q_feature, qp))
        y = self.encoder(x, ctx, self._q(self.q_encoder, qp))
        z = self.hyper_encoder(pad_for_y(y))
        z_int8 = torch.clamp(torch.round(z.float()), -128, 127).to(torch.int8)
        return y, z_int8

    def prior0(self, z_int8, feature, qp, yh, yw):
        """Shared enc/dec: hyper and temporal prior, fused -> (q_enc, q_dec,
        scales, means, params); params is the spatial prior's context.
        The hyper output is cropped to the y grid before the fusion."""
        _, ctx_t = self.feature_extractor(feature.to(self.dtype),
                                          self._q(self.q_feature, qp))
        temporal = self.temporal_prior_encoder(ctx_t)
        hyper = self.hyper_decoder(z_int8.to(self.dtype))[:, :yh, :yw, :]
        params = self.y_prior_fusion(torch.cat([hyper, temporal], dim=-1))
        q_enc, q_dec, scales, means = common.separate_prior_video_infer(
            params)
        return q_enc, q_dec, scales, means, params

    def prior_step(self, spctx, y_hat_so_far):
        """The second checkerboard step: (scales, means).  Shared enc/dec."""
        out = self.y_spatial_prior(torch.cat(
            [y_hat_so_far.to(self.dtype), spctx], dim=-1))
        scales, means = out.chunk(2, dim=-1)
        return scales, means

    def synthesis_feature(self, y_hat, feature, qp):
        """Final y_hat (already * q_dec) -> decoder feature, the DPB state;
        the decoder context is recomputed from the adapted feature."""
        ctx, _ = self.feature_extractor(feature, self._q(self.q_feature, qp))
        return self.decoder(y_hat.to(self.dtype), ctx,
                            self._q(self.q_decoder, qp))

    def recon_frames(self, feature, qp, out_h, out_w):
        """Decode-side: recon head -> the frame (1, out_h, out_w, 3) float32
        in [0, 1]."""
        x_hat = self.recon_generation_net(feature, self._q(self.q_recon, qp))
        return x_hat.float()[:, :out_h, :out_w, :]

    # ------------------------------------------------------ training path

    def forward(self, x, ref_feature, memory, qp, noise):
        """Training forward of one frame (dcvc_tpu's DMCRT.__call__).  x:
        (B, H, W, 3) RGB in [0, 1], H and W multiples of 64; ref_feature:
        the unshuffled frame (192ch) when memory is None, else the previous
        decoder feature; qp: int or (B,); noise: the rate terms' y / z
        noise (common.rate_terms).  Returns (result, feature, feature);
        result holds x_hat and mse, bpp, bits_y and bits_z, each (B,)."""
        if memory is None:
            feature = self.feature_adaptor_i(ref_feature)
        else:
            feature = self.feature_adaptor_p(ref_feature)
        ctx, ctx_t = self.feature_extractor(feature,
                                            self._q(self.q_feature, qp))
        y = self.encoder(x.to(self.dtype), ctx, self._q(self.q_encoder, qp))
        z = self.hyper_encoder(y)
        temporal = self.temporal_prior_encoder(ctx_t)
        yh, yw = y.shape[1], y.shape[2]
        hyper = self.hyper_decoder(ste_round(z))[:, :yh, :yw, :]
        params = self.y_prior_fusion(torch.cat([hyper, temporal], dim=-1))

        q_enc, q_dec, scales, means = common.separate_prior_video(params)
        y_scaled = y * q_enc
        mask_0, mask_1 = common._masks(make_mask_2x, y)
        y_res_0, _, y_hat_0, s_hat_0 = common.process_with_mask_train(
            y_scaled, scales, means, mask_0)
        scales1, means1 = self.prior_step(params, y_hat_0)
        y_res_1, _, y_hat_1, s_hat_1 = common.process_with_mask_train(
            y_scaled, scales1, means1, mask_1)
        y_hat = (y_hat_0 + y_hat_1) * q_dec

        feature_out = self.decoder(y_hat, ctx, self._q(self.q_decoder, qp))
        x_hat = self.recon_generation_net(feature_out,
                                          self._q(self.q_recon, qp))
        bits_y, bits_z, bpp = common.rate_terms(
            self.bit_estimator_z, y_res_0 + y_res_1, s_hat_0 + s_hat_1, z,
            qp, noise, x.shape[1] * x.shape[2])
        mse = torch.mean((x_hat.float() - x.float()) ** 2, dim=(1, 2, 3))
        return ({"bits_y": bits_y, "bits_z": bits_z, "bpp": bpp, "mse": mse,
                 "x_hat": x_hat}, feature_out, feature_out)


class DMCRTCodec(VideoCodecBase):
    """DMCRT under the video runtime: params a state_dict of DMCRT.  A unit
    is one frame, (1, H, W, 3) in [0, 1]; QPs run to cfg.qp_bank (the
    shifted banks), and the RT container's 1-bit SPS field caps the lanes
    at 2.  The P frames decode through the host coder or, with device_ec,
    through K2 (z, then one call per checkerboard step)."""

    MODEL = DMCRT
    DEFAULT_CFG = RT_CONFIG
    MAX_EC = 2
