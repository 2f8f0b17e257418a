"""DMC-LD low-delay per-frame video codec model (counterpart of
dcvc_tpu/models/dmc_ld.py; reference src/models/video_model_ld.py).

One frame at a time (frame_delay 1): the frame is 8x pixel-unshuffled to
192 channels, fused with the temporal context and compressed into one y
latent (128ch @ /16 of the frame).  Every DepthConvBlock is half-width
(dcb2, I = C / 2).  The spatial prior is a 2-step checkerboard whose
second step emits means only, so, as in HTS, every scale index is known
after the fused prior and y is coded in one entropy pass.

The module tree follows the reference torch DMC of video_model_ld.py, so
its state_dict keys are the reference's (the names
dcvc_tpu.utils.torch_import.key_fn_dmc_ld gives the flax params):
`feature_adaptor_i.conv.{i}...`, `encoder.conv1.0.adaptor.weight`,
`temporal_prior_encoder.conv.down.weight`, `y_prior_fusion.conv.3.weight`,
`y_spatial_prior.conv.{i}...`, `recon_head.conv.{i}...`,
`recon_head.head.weight`, ...

The stage methods are what the runtime calls; the encoder and the decoder
call the same adaptor_i / adaptor_m / prior0 / prior_step /
synthesis_feature / recon_frames / reset_feature, which keeps their priors
and reconstructions bit-identical.  `forward(x, ref_feature, memory, qp,
noise)` is the training forward of one frame.
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.padding import pad_for_y
from ..core.quant import ste_round
from ..core.shuffle import pixel_shuffle, pixel_unshuffle
from ..layers.blocks import (
    Conv1x1, Conv3x3, DepthConvBlock, ResidualBlockUpsample,
    ResidualBlockWithStride2, SubpelConv2x, lecun_init_,
)
from . import common


@dataclasses.dataclass(frozen=True)
class DMCLDConfig:
    frame_delay: int = 1
    ch_src: int = 3 * 8 * 8   # 192
    ch_y: int = 128
    ch_z: int = 128
    ch_d: int = 256
    ch_m: int = 256
    qp_num: int = 64

    @property
    def prior_steps(self):
        """Coding steps of the spatial prior: the 2-step checkerboard."""
        return 2

    @property
    def single_pass(self):
        """The second step emits means only: one entropy pass."""
        return self.prior_steps == 2


LD_CONFIG = DMCLDConfig()
TINY_LD_CONFIG = DMCLDConfig(ch_y=16, ch_z=8, ch_d=32, ch_m=32, qp_num=8)


def _dcb_seq(chs):
    """nn.Sequential of dcb2 DepthConvBlocks; chs = [(in, out), ...]."""
    return nn.Sequential(*[DepthConvBlock(ci, co, dcb2=True)
                           for ci, co in chs])


class Wrap(nn.Module):
    """One module under the attribute `conv`: the reference's wrappers of
    the adaptors, the extractor, the hyper codecs, the temporal prior
    encoder and the fusion."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class LDEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = _dcb_seq([(c.ch_src + c.ch_m, c.ch_d), (c.ch_d, c.ch_d)])
        self.conv2 = DepthConvBlock(c.ch_d, c.ch_d, dcb2=True)
        self.down = Conv3x3(c.ch_d, c.ch_y, stride=2)

    def forward(self, x, ctx, quant_step):
        f = torch.cat([pixel_unshuffle(x, 8), ctx], dim=-1)
        return self.down(self.conv2(self.conv1(f)) * quant_step)


class LDDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.up = SubpelConv2x(c.ch_y, c.ch_d, kernel_size=1)
        self.conv1 = _dcb_seq([(c.ch_d + c.ch_m, c.ch_d), (c.ch_d, c.ch_d),
                               (c.ch_d, c.ch_d)])
        self.conv2 = Conv1x1(c.ch_d, c.ch_d)

    def forward(self, y_hat, ctx, quant_step):
        f = torch.cat([self.up(y_hat), ctx], dim=-1)
        return self.conv2(self.conv1(f)) * quant_step


class LDReconHead(nn.Module):
    """Three plain dcb2 DCBs and a 1x1 conv to the 192 channels of an
    unshuffled frame."""

    def __init__(self, c):
        super().__init__()
        self.conv = _dcb_seq([(c.ch_d, c.ch_d)] * 3)
        self.head = Conv1x1(c.ch_d, c.ch_src)

    def forward(self, x, for_reset=False):
        x = self.head(self.conv(x))
        return x if for_reset else pixel_shuffle(x, 8)


class LDSpatialPrior(nn.Module):
    """2-step checkerboard prior: (y_hat_0, fused params) -> means
    (video_model_ld.py:169-179)."""

    def __init__(self, c):
        super().__init__()
        cy = c.ch_y
        self.conv = nn.Sequential(
            DepthConvBlock(cy * 4, cy * 2, dcb2=True),
            DepthConvBlock(cy * 2, cy * 2, dcb2=True),
            Conv1x1(cy * 2, cy))

    def forward(self, y_hat_0, params):
        return self.conv(torch.cat([y_hat_0.to(params.dtype), params],
                                   dim=-1))


class DMCLD(nn.Module):
    """Low-delay per-frame codec (reference DMC, video_model_ld.py:191-376)."""

    def __init__(self, cfg=LD_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        self.feature_adaptor_i = Wrap(_dcb_seq(
            [(c.ch_src, c.ch_m)] + [(c.ch_m, c.ch_m)] * 3))
        self.feature_adaptor_m = Wrap(_dcb_seq(
            [(c.ch_m + c.ch_d, c.ch_m)] + [(c.ch_m, c.ch_m)] * 3))
        self.feature_extractor = Wrap(_dcb_seq([(c.ch_m, c.ch_m)] * 5))
        self.encoder = LDEncoder(c)
        self.hyper_encoder = Wrap(nn.Sequential(
            DepthConvBlock(c.ch_y, c.ch_z, dcb2=True),
            ResidualBlockWithStride2(c.ch_z, c.ch_z, dcb2=True,
                                     shortcut=False),
            ResidualBlockWithStride2(c.ch_z, c.ch_z, dcb2=True,
                                     shortcut=False)))
        self.hyper_decoder = Wrap(nn.Sequential(
            ResidualBlockUpsample(c.ch_z, c.ch_z, dcb2=True, shortcut=False),
            ResidualBlockUpsample(c.ch_z, c.ch_z, dcb2=True, shortcut=False),
            DepthConvBlock(c.ch_z, c.ch_y, dcb2=True)))
        self.temporal_prior_encoder = Wrap(ResidualBlockWithStride2(
            c.ch_m, c.ch_y * 2, dcb2=True, shortcut=False))
        cy3 = c.ch_y * 3
        self.y_prior_fusion = Wrap(nn.Sequential(
            *[DepthConvBlock(cy3, cy3, dcb2=True) for _ in range(3)],
            Conv1x1(cy3, cy3)))
        self.y_spatial_prior = LDSpatialPrior(c)
        self.decoder = LDDecoder(c)
        self.recon_head = LDReconHead(c)
        self.q_encoder = nn.Parameter(torch.zeros(c.qp_num, c.ch_d))
        self.q_decoder = nn.Parameter(torch.zeros(c.qp_num, c.ch_d))
        self.q_feature = nn.Parameter(torch.zeros(c.qp_num, c.ch_y * 2))
        self.bit_estimator_z = common.BitEstimatorModule(c.qp_num, c.ch_z)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as dcvc_tpu's DMCLD.init does it: lecun-normal
        convs (depthwise included) with zero biases, the log-spaced
        q_encoder / q_decoder ladders, q_feature ones, and N(0, 0.01) z
        prior banks.  Draws from `generator` (a CPU torch.Generator)."""
        lecun_init_(self, generator)
        c = self.cfg
        self.q_encoder.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num, c.ch_d))
        self.q_decoder.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num, c.ch_d,
                                                  inverse=True))
        self.q_feature.fill_(1.0)
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @property
    def dtype(self):
        return self.q_encoder.dtype

    def _q(self, table, qp):
        """(qp_num, C) table -> the (C,) row of an int `qp`, or the
        (B, 1, 1, C) rows of a per-sample qp (B,)."""
        return common.select_qp(table, qp)

    # ----------------------------------------------------- temporal state

    def adaptor_i(self, ref_feature):
        """First frame after a refresh: memory from the intra frame's
        unshuffled pixels (or the reset feature)."""
        memory = self.feature_adaptor_i(ref_feature.to(self.dtype))
        return memory, self.feature_extractor(memory)

    def adaptor_m(self, memory, ref_feature):
        memory = self.feature_adaptor_m(torch.cat(
            [memory.to(self.dtype), ref_feature.to(self.dtype)], dim=-1))
        return memory, self.feature_extractor(memory)

    def reset_feature(self, feature):
        """The recon head's output before the pixel shuffle, unclipped, in
        the model dtype: the new DPB seed (video_model_ld.py)."""
        return self.recon_head(feature.to(self.dtype), for_reset=True)

    # ------------------------------------------------------ shared stages

    def _prior_params(self, z_hat, memory, qp):
        """Fused hyper and temporal prior.  The hyper output lives on the
        4-aligned grid; it is cropped to the temporal prior's (y) grid
        BEFORE the fusion (reference crop_hyper_params)."""
        temporal = self.temporal_prior_encoder(memory)
        hyper = self.hyper_decoder(z_hat)[
            :, :temporal.shape[1], :temporal.shape[2], :]
        return self.y_prior_fusion(torch.cat(
            [hyper, temporal * self._q(self.q_feature, qp)], dim=-1))

    def prior0(self, z_int8, memory, qp, yh, yw):
        """Shared enc/dec: fused prior -> (q_enc, q_dec, scales, means,
        params); params is the spatial prior's context."""
        params = self._prior_params(z_int8.to(self.dtype),
                                    memory.to(self.dtype), qp)
        params = params[:, :yh, :yw, :]
        q_enc, q_dec, scales, means = common.separate_prior_video_infer(
            params)
        return q_enc, q_dec, scales, means, params

    def prior_step(self, params, y_hat_0):
        """Second checkerboard step: the means.  Shared enc/dec."""
        return self.y_spatial_prior(y_hat_0, params)

    def analysis(self, x, ctx, qp):
        """Padded frame (1, H, W, 3) -> (y, z_int8).  y may sit on an odd
        grid; only the stride-2 hyper path needs 4-alignment, so y is
        replicate-padded for it alone."""
        y = self.encoder(x, ctx, self._q(self.q_encoder, qp))
        z = self.hyper_encoder(pad_for_y(y))
        z_int8 = torch.clamp(torch.round(z.float()), -128, 127).to(torch.int8)
        return y, z_int8

    def synthesis_feature(self, y_hat, ctx, qp):
        """Final y_hat (already * q_dec) -> decoder feature, the DPB state.
        The encoder stops here."""
        return self.decoder(y_hat.to(self.dtype), ctx,
                            self._q(self.q_decoder, qp))

    def recon_frames(self, feature, qp, out_h, out_w):
        """Decode-side: recon head -> the frame (1, out_h, out_w, 3)
        float32 in [-0.5, 0.5]."""
        del qp  # the recon head does not depend on the QP
        frame = self.recon_head(feature.to(self.dtype))
        frame = torch.clamp(frame.float(), -0.5, 0.5)
        return frame[:, :out_h, :out_w, :]

    # ------------------------------------------------------ training path

    def forward(self, x, ref_feature, memory, qp, noise):
        """Training forward of one frame (video_model_ld.py:308-343).

        x: (B, H, W, 3) YCbCr - 0.5, H and W multiples of 64;
        ref_feature: (B, H/8, W/8, 192) for the first frame, else the
        previous frame's decoder feature; memory: None for the first frame
        (feature adaptor I), else the previous memory (adaptor M); qp: int
        or (B,); noise: the rate terms' noise (common.rate_terms).
        Returns (result, feature, memory); result holds x_hat and mse,
        bpp, bits_y and bits_z, each (B,)."""
        if memory is None:
            memory = self.feature_adaptor_i(ref_feature)
        else:
            memory = self.feature_adaptor_m(
                torch.cat([memory, ref_feature], dim=-1))
        ctx = self.feature_extractor(memory)

        y = self.encoder(x, ctx, self._q(self.q_encoder, qp))
        z = self.hyper_encoder(y)
        params = self._prior_params(ste_round(z), memory, qp)
        params = params[:, :y.shape[1], :y.shape[2], :]
        y_res, _, y_hat, scales_hat = common.forward_prior_2x_train(
            y, params, self.y_spatial_prior)

        feature = self.decoder(y_hat, ctx, self._q(self.q_decoder, qp))
        x_hat = self.recon_head(feature)
        bits_y, bits_z, bpp = common.rate_terms(
            self.bit_estimator_z, y_res, scales_hat, z, qp, noise,
            x.shape[1] * x.shape[2])
        result = {"bits_y": bits_y, "bits_z": bits_z, "bpp": bpp,
                  "mse": common.get_mse(x, x_hat), "x_hat": x_hat}
        return result, feature, memory
