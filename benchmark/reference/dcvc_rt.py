"""Frozen plain reference of DCVC-RT's P-frame codec (Jia et al., "Towards
Practical Real-Time Neural Video Compression", CVPR 2025; microsoft/DCVC
DCVC-family/DCVC-RT/src/models/video_model.py and src/layers/layers.py),
float32, NHWC: the feature adaptors over a one-slot DPB, the feature
extractor, the analysis, the fused hyper and temporal prior, the 2-step
checkerboard whose second step emits scales as well as means, the skip,
the decoder and the recon generation, with module-bank rate control.
The module tree and the state_dict keys are the port's (its DMCRT).  It
imports nothing of the program.

Departures from video_model.py, each one the port's:
- frames are edge-padded to a multiple of 16 (not 64), and y to a
  multiple of 4 before the hyper encoder, whose output the hyper decoder
  crops back to y's grid;
- the z prior's Bitparm layers (`bit_estimator_z.f1..f4`) are stacked
  into three banks `bit_estimator_z.{h,b,a}` with one row per module
  bank; the reference codes z with them and computes nothing from them;
- the skip is the inference form of the reference's: a symbol is coded
  where its scale exceeds `skip_thres`, and y - means is rounded half to
  even and clamped to int8 there;
- the quant step of the fused prior is bounded below by 0.5 (the
  inference form of lower_bound) and q_enc is its reciprocal;
- the stream's lanes are pinned to 2 (the RT container's 1-bit field),
  which changes no number here;
- no frame of a segment resets the feature (the reference refreshes
  it every `reset_interval` frames; a segment of 8 is shorter).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dmc_hts import BitEstimatorZ, _Conv
from .layers import (Conv1x1, Conv3x3, DepthwiseConv3x3, Numerics,
                     SubpelConv2x, _Act, code_step, pad_replicate, pad_to,
                     padding_size, pixel_shuffle, pixel_unshuffle, wsilu)

# module-bank rate control (video_model.py): frame i of a period of 8
# codes at shift_qp(qp, INDEX_MAP[i]), the banks past qp_num included
QP_SHIFT = (0, 8, 4)
EXTRA_QP = max(QP_SHIFT)
INDEX_MAP = (0, 1, 0, 2, 0, 2, 0, 2)


def shift_qp(qp, fa_idx, qp_num):
    return min(qp + QP_SHIFT[fa_idx], qp_num + EXTRA_QP - 1)


class DepthConvBlockRT(nn.Module):
    """RT's DepthConvBlock (layers.py): dc 1x1 -> WSiLU -> dw3x3 -> 1x1,
    residual; ffn 1x1 to 4C -> WSiLU -> its two 2C halves summed -> 1x1
    to C, residual; an adaptor 1x1 where in != out."""

    def __init__(self, num, in_ch, out_ch, shortcut=False):
        super().__init__()
        c = out_ch
        self.shortcut = shortcut
        self.adaptor = Conv1x1(num, in_ch, c) if in_ch != c else None
        self.dc = nn.Sequential(Conv1x1(num, c, c), _Act(),
                                DepthwiseConv3x3(num, c), Conv1x1(num, c, c))
        self.ffn = nn.Sequential(Conv1x1(num, c, 4 * c), _Act(),
                                 Conv1x1(num, 2 * c, c))

    def forward(self, x):
        if self.adaptor is not None:
            x = self.adaptor(x)
        out = self.dc(x) + x
        f1, f2 = wsilu(self.ffn[0](out)).chunk(2, dim=-1)
        out = self.ffn[2](f1 + f2) + out
        if self.shortcut:
            out = out + x
        return out


class Conv2x2Stride2(nn.Module):
    def __init__(self, num, in_ch, out_ch):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        y = F.conv2d(self.num.q(x.permute(0, 3, 1, 2)),
                     self.num.q(self.weight), self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class ResidualBlockWithStride2(nn.Module):
    """RT's: a 2x2 stride-2 conv and a shortcut block."""

    def __init__(self, num, in_ch, out_ch):
        super().__init__()
        self.down = Conv2x2Stride2(num, in_ch, out_ch)
        self.conv = DepthConvBlockRT(num, out_ch, out_ch, shortcut=True)

    def forward(self, x):
        return self.conv(self.down(x))


class ResidualBlockUpsample(nn.Module):
    """RT's: a subpel 1x1 with a bias and a shortcut block."""

    def __init__(self, num, in_ch, out_ch):
        super().__init__()
        self.up = SubpelConv2x(num, in_ch, out_ch, force_bias=True)
        self.conv = DepthConvBlockRT(num, out_ch, out_ch, shortcut=True)

    def forward(self, x):
        return self.conv(self.up(x))


def _blocks(num, chs):
    return nn.Sequential(*[DepthConvBlockRT(num, ci, co) for ci, co in chs])


class FeatureExtractor(nn.Module):
    def __init__(self, num, cd):
        super().__init__()
        self.conv1 = _blocks(num, [(cd, cd)] * 2)
        self.conv2 = _blocks(num, [(cd, cd)] * 4)

    def forward(self, x, quant):
        x1 = self.conv1(x)
        return self.conv2(x1), x1 * quant       # (ctx, ctx_t)


class Encoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        cd = c["ch_d"]
        self.conv1 = Conv1x1(num, c["ch_src_d"], cd)
        self.conv2 = _blocks(num, [(2 * cd, cd), (cd, cd)])
        self.conv3 = DepthConvBlockRT(num, cd, cd)
        self.down = Conv3x3(num, cd, c["ch_y"], stride=2)

    def forward(self, x, ctx, quant_step):
        f = self.conv1(pixel_unshuffle(x, 8))
        f = self.conv3(self.conv2(torch.cat([f, ctx], dim=-1)))
        return self.down(f * quant_step)


class Decoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        cd = c["ch_d"]
        self.up = SubpelConv2x(num, c["ch_y"], cd, kernel_size=3)
        self.conv1 = _blocks(num, [(2 * cd, cd)] + [(cd, cd)] * 2)
        self.conv2 = Conv1x1(num, cd, cd)

    def forward(self, y_hat, ctx, quant_step):
        f = torch.cat([self.up(y_hat), ctx], dim=-1)
        return self.conv2(self.conv1(f)) * quant_step


class ReconGeneration(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        cr = c["ch_recon"]
        self.conv = _blocks(num, [(c["ch_d"], cr)] + [(cr, cr)] * 3)
        self.head = Conv1x1(num, cr, c["ch_src_d"])

    def forward(self, x, quant_step):
        out = pixel_shuffle(self.head(self.conv(x) * quant_step), 8)
        return torch.clamp(out, 0.0, 1.0)


def masks_2x(h, w, c, device):
    """The checkerboard's two boolean (1, h, w, c) masks (get_mask_2x):
    the first half of the channels codes phases (0, 0) and (1, 1) in the
    first step, the second half the other two; the second step is the
    complement."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    even = ((yy + xx) % 2 == 0)[None, :, :, None]
    first = torch.cat([even.expand(1, h, w, c // 2),
                       (~even).expand(1, h, w, c - c // 2)], dim=-1)
    return first, ~first


class DMCRT(nn.Module):
    def __init__(self, widths, numerics=None):
        super().__init__()
        num = numerics or Numerics("f32")
        c = self.c = dict(widths)
        cy, cz, cd = c["ch_y"], c["ch_z"], c["ch_d"]
        banks = c["qp_num"] + EXTRA_QP
        self.feature_adaptor_i = DepthConvBlockRT(num, c["ch_src_d"], cd)
        self.feature_adaptor_p = Conv1x1(num, cd, cd)
        self.feature_extractor = FeatureExtractor(num, cd)
        self.encoder = Encoder(num, c)
        self.hyper_encoder = _Conv(nn.Sequential(
            DepthConvBlockRT(num, cy, cz),
            ResidualBlockWithStride2(num, cz, cz),
            ResidualBlockWithStride2(num, cz, cz)))
        self.hyper_decoder = _Conv(nn.Sequential(
            ResidualBlockUpsample(num, cz, cz),
            ResidualBlockUpsample(num, cz, cz),
            DepthConvBlockRT(num, cz, cy)))
        self.temporal_prior_encoder = ResidualBlockWithStride2(num, cd,
                                                               2 * cy)
        self.y_prior_fusion = _Conv(nn.Sequential(
            *[DepthConvBlockRT(num, 3 * cy, 3 * cy) for _ in range(3)],
            Conv1x1(num, 3 * cy, 3 * cy)))
        self.y_spatial_prior = _Conv(nn.Sequential(
            DepthConvBlockRT(num, 4 * cy, 3 * cy),
            DepthConvBlockRT(num, 3 * cy, 3 * cy),
            Conv1x1(num, 3 * cy, 2 * cy)))
        self.decoder = Decoder(num, c)
        self.recon_generation_net = ReconGeneration(num, c)
        self.q_encoder = nn.Parameter(torch.zeros(banks, cd))
        self.q_decoder = nn.Parameter(torch.zeros(banks, cd))
        self.q_feature = nn.Parameter(torch.zeros(banks, cd))
        self.q_recon = nn.Parameter(torch.zeros(banks, c["ch_recon"]))
        self.bit_estimator_z = BitEstimatorZ(banks, cz)

    def frame_qps(self, qp, n):
        """The module bank of each of a segment's n frames at `qp`."""
        return [shift_qp(qp, INDEX_MAP[i % len(INDEX_MAP)], self.c["qp_num"])
                for i in range(n)]

    def seed_feature(self, frame):
        """The DPB seed of a segment: its first frame (in [0, 1]),
        edge-padded to 16 and 8x unshuffled."""
        pad = padding_size(frame.shape[1], frame.shape[2], 16)
        return pixel_unshuffle(pad_replicate(frame, *pad), 8)

    def adapt(self, dpb, seeded):
        """The adapted feature of the next frame: adaptor I on the seed,
        adaptor P on the last frame's decoder feature."""
        if seeded:
            return self.feature_adaptor_i(dpb)
        return self.feature_adaptor_p(dpb)

    def extract(self, feature, q):
        """(ctx, ctx_t) of the frame at module bank q."""
        return self.feature_extractor(feature, self.q_feature[q])

    def analysis(self, x, ctx, q):
        """The encoder's own stage: frame (1, H, W, 3) -> (y, z)."""
        x = pad_replicate(x, *padding_size(x.shape[1], x.shape[2], 16))
        y = self.encoder(x, ctx, self.q_encoder[q])
        z = self.hyper_encoder(pad_to(y, 4))
        return y, torch.clamp(torch.round(z), -128.0, 127.0)

    def prior(self, z, ctx_t, yh, yw):
        """The fused hyper and temporal prior -> its 3 * ch_y outputs
        (quant step, scales, means), the spatial prior's context."""
        temporal = self.temporal_prior_encoder(ctx_t)
        hyper = self.hyper_decoder(z)[:, :yh, :yw]
        return self.y_prior_fusion(torch.cat([hyper, temporal], dim=-1))

    def spatial_prior(self, y_hat, params):
        """The second step's (scales, means)."""
        return self.y_spatial_prior(torch.cat([y_hat, params],
                                              dim=-1)).chunk(2, dim=-1)

    def feature(self, y, z, ctx, ctx_t, q, skip_thres):
        """The stages the encoder and the decoder share: the prior, the two
        checkerboard steps and the decoder -> the frame's feature (the
        next DPB entry)."""
        yh, yw, cy = y.shape[1], y.shape[2], y.shape[3]
        params = self.prior(z, ctx_t, yh, yw)
        quant_step, scales, means = params.chunk(3, dim=-1)
        q_dec = torch.clamp_min(quant_step, 0.5)
        y = y * (1.0 / q_dec)
        first, second = masks_2x(yh, yw, cy, y.device)
        y_hat = code_step(y, scales, means, first, skip_thres)
        scales, means = self.spatial_prior(y_hat, params)
        y_hat = y_hat + code_step(y, scales, means, second, skip_thres)
        return self.decoder(y_hat * q_dec, ctx, self.q_decoder[q])

    def recon(self, feature, q, h, w):
        """The decoder's frame (1, h, w, 3) in [0, 1]."""
        x = self.recon_generation_net(feature, self.q_recon[q])
        return x[:, :h, :w]

    def code_segment(self, first_frame, frames, qp, skip_thres):
        """A closed segment: the DPB seeded with `first_frame` (1, H, W,
        3), then each frame (1, H, W, 3) coded in turn as a P frame at
        its module bank.  Returns the decoder's frames."""
        dpb, outs = self.seed_feature(first_frame), []
        for i, (x, q) in enumerate(zip(frames, self.frame_qps(qp,
                                                              len(frames)))):
            feature = self.adapt(dpb, i == 0)
            ctx, ctx_t = self.extract(feature, q)
            y, z = self.analysis(x, ctx, q)
            dpb = self.feature(y, z, ctx, ctx_t, q, skip_thres)
            outs.append(self.recon(dpb, q, x.shape[1], x.shape[2]))
        return outs
