"""Frozen plain reference of DCVC-UF's chunk codec DMC-HTS (microsoft/DCVC
src/models/video_model_ht.py, the DMC with is_hts), float32, NHWC: the
feature adaptors and extractor, the analysis, the fused hyper and
temporal prior, the 4 coding steps with the skip (means-only spatial
priors), the decoder trunk and the 8 per-frame recon heads, over a
closed segment of chunks from a DPB seeded with one frame.  The module
tree and the state_dict keys are the reference's.  It imports nothing
of the program.
"""

import collections

import torch
import torch.nn as nn

from .layers import (Conv1x1, Conv3x3, DepthConvBlock, Numerics,
                     ResidualBlockUpsample, ResidualBlockWithStride2,
                     SubpelConv2x, code_step, mask_4x, pad_replicate,
                     pad_to, padding_size, pixel_shuffle, pixel_unshuffle)


def _stack(num, chs, dcb2):
    return nn.Sequential(*[DepthConvBlock(num, ci, co, dcb2=dcb2)
                           for ci, co in chs])


class _Conv(nn.Module):
    """A module whose blocks sit under `conv` (the reference's name)."""

    def __init__(self, seq):
        super().__init__()
        self.conv = seq

    def forward(self, x):
        return self.conv(x)


class HTEncoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.conv1 = _stack(num, [(c["ch_src_d"] + c["ch_d"], c["ch_d"])]
                            + [(c["ch_d"], c["ch_d"])] * (c["enc_depth"] - 1),
                            True)
        self.down = Conv3x3(num, c["ch_d"], c["ch_y"], stride=2)

    def forward(self, x, ctx, quant_step):
        feature = torch.cat([pixel_unshuffle(x, 8), ctx], dim=-1)
        return self.down(self.conv1(feature) * quant_step)


class HTDecoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.up = SubpelConv2x(num, c["ch_y"], c["ch_d"], kernel_size=1)
        self.conv1 = _stack(num, [(c["ch_d"] * 2, c["ch_d"])]
                            + [(c["ch_d"], c["ch_d"])] * (c["dec_depth"] - 1),
                            True)

    def forward(self, y_hat, ctx, quant_step):
        return self.conv1(torch.cat([self.up(y_hat), ctx], dim=-1)) \
            * quant_step


class HTReconHead(nn.Module):
    """HTS: a trunk shared by each frame pair (conv1.{pair}), per-frame
    blocks (conv2.{frame}.{m}) and a per-frame 1x1 to 192 channels
    (conv2.{frame}.3)."""

    def __init__(self, num, c):
        super().__init__()
        fd = c["frame_delay"]
        self.conv1 = nn.ModuleList(
            nn.Sequential(*[DepthConvBlock(num, c["ch_d"], c["ch_d"])
                            for _ in range(c["recon_shared_depth"])])
            for _ in range(fd // 2))
        heads = []
        for _ in range(fd):
            blocks = [(str(m), DepthConvBlock(
                num, c["ch_d"] if m == 0 else c["ch_recon"], c["ch_recon"]))
                for m in range(c["recon_depth"])]
            blocks.append(("3", Conv1x1(num, c["ch_recon"],
                                        c["ch_src_intra"])))
            heads.append(nn.Sequential(collections.OrderedDict(blocks)))
        self.conv2 = nn.ModuleList(heads)

    def forward(self, feature):
        """feature (1, h, w, ch_d) -> (frame_delay, 1, h, w, 192)."""
        outs = []
        for pair, trunk in enumerate(self.conv1):
            t = trunk(feature)
            outs += [self.conv2[2 * pair](t), self.conv2[2 * pair + 1](t)]
        return torch.stack(outs)


class BitEstimatorZ(nn.Module):
    def __init__(self, qp_num, ch_z):
        super().__init__()
        self.h = nn.Parameter(torch.zeros(qp_num, ch_z, 4))
        self.b = nn.Parameter(torch.zeros(qp_num, ch_z, 4))
        self.a = nn.Parameter(torch.zeros(qp_num, ch_z, 3))


class DMCHTS(nn.Module):
    def __init__(self, widths, numerics=None):
        super().__init__()
        num = numerics or Numerics("f32")
        c = self.c = dict(widths)
        c["ch_src_d"] = c["ch_src_intra"] * c["frame_delay"]
        cy, cd, cm = c["ch_y"], c["ch_d"], c["ch_m"]
        self.feature_adaptor_i = _Conv(_stack(
            num, [(c["ch_src_intra"], cm)]
            + [(cm, cm)] * (c["fa_i_depth"] - 1), True))
        self.feature_adaptor_m = _Conv(_stack(
            num, [(cm + cd, cm)] + [(cm, cm)] * (c["fa_m_depth"] - 1), True))
        self.feature_extractor = _Conv(_stack(
            num, [(cm, cd)] + [(cd, cd)] * (c["fx_depth"] - 1), True))
        self.encoder = HTEncoder(num, c)
        self.hyper_encoder = _Conv(nn.Sequential(
            DepthConvBlock(num, cy, cy),
            ResidualBlockWithStride2(num, cy, cy, shortcut=False),
            ResidualBlockWithStride2(num, cy, c["ch_z"], shortcut=False)))
        self.hyper_decoder = _Conv(nn.Sequential(
            ResidualBlockUpsample(num, c["ch_z"], cy, shortcut=False),
            ResidualBlockUpsample(num, cy, cy, shortcut=False),
            DepthConvBlock(num, cy, cy)))
        self.temporal_prior_encoder = _Conv(
            ResidualBlockWithStride2(num, cd, cy * 2, shortcut=False))
        self.y_prior_fusion = _Conv(nn.Sequential(
            *[DepthConvBlock(num, cy * 3, cy * 3) for _ in range(3)],
            Conv1x1(num, cy * 3, cy * 3)))
        self.y_spatial_prior_reduction = Conv1x1(num, cy * 3, cy)
        for k in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{k}",
                    DepthConvBlock(num, cy * 2, cy * 2, force_adaptor=True))
        self.y_spatial_prior = _Conv(nn.Sequential(
            *[DepthConvBlock(num, cy * 2, cy * 2) for _ in range(3)],
            Conv1x1(num, cy * 2, cy)))
        self.decoder = HTDecoder(num, c)
        self.recon_head = HTReconHead(num, c)
        q = (c["qp_num"], cd)
        self.q_encoder = nn.Parameter(torch.zeros(q))
        self.q_decoder = nn.Parameter(torch.zeros(q))
        self.q_feature = nn.Parameter(torch.zeros(q))
        self.bit_estimator_z = BitEstimatorZ(c["qp_num"], c["ch_z"])

    def seed_feature(self, frame):
        """The DPB seed of a segment: its first frame, edge-padded to 16
        and 8x unshuffled."""
        pad = padding_size(frame.shape[1], frame.shape[2], 16)
        return pixel_unshuffle(pad_replicate(frame, *pad), 8)

    def adapt(self, ref_feature, memory):
        """(memory, ctx) of the next chunk: adaptor I after the seed,
        adaptor M after a chunk."""
        if memory is None:
            memory = self.feature_adaptor_i(ref_feature)
        else:
            memory = self.feature_adaptor_m(
                torch.cat([memory, ref_feature], dim=-1))
        return memory, self.feature_extractor(memory)

    def analysis(self, x, ctx, qp):
        """The encoder's own stage: chunk (1, H, W, 24) -> (y, z)."""
        x = pad_replicate(x, *padding_size(x.shape[1], x.shape[2], 16))
        y = self.encoder(x, ctx, self.q_encoder[qp])
        z = self.hyper_encoder(pad_to(y, 4))
        return y, torch.clamp(torch.round(z), -128.0, 127.0)

    def feature(self, y, z, memory, ctx, qp, skip_thres):
        """The stages the encoder and the decoder share: the fused prior,
        the 4 coding steps and the decoder trunk -> the chunk's feature
        (the next DPB reference)."""
        yh, yw, cy = y.shape[1], y.shape[2], y.shape[3]
        temporal = self.temporal_prior_encoder(memory * self.q_feature[qp])
        hyper = self.hyper_decoder(z)[:, :temporal.shape[1],
                                      :temporal.shape[2]]
        params = self.y_prior_fusion(torch.cat([hyper, temporal], dim=-1))
        params = params[:, :yh, :yw]
        quant_step, scales, means = params.chunk(3, dim=-1)
        q_dec = torch.clamp_min(quant_step, 0.5)
        y = y * (1.0 / q_dec)
        sctx = self.y_spatial_prior_reduction(params)
        y_hat = torch.zeros_like(y)
        for step in range(4):
            if step > 0:
                adaptor = getattr(self, f"y_spatial_prior_adaptor_{step}")
                means = self.y_spatial_prior(
                    adaptor(torch.cat([y_hat, sctx], dim=-1)))
            y_hat = y_hat + code_step(y, scales, means,
                                      mask_4x(yh, yw, cy, step, y.device),
                                      skip_thres)
        return self.decoder(y_hat * q_dec, ctx, self.q_decoder[qp])

    def recon(self, feature, h, w):
        """The decoder's frames of a chunk: (frame_delay, h, w, 3)
        clamped to [-0.5, 0.5]."""
        out = self.recon_head(feature)
        x = torch.clamp(pixel_shuffle(out[:, 0], 8), -0.5, 0.5)
        return x[:, :h, :w]

    def code_segment(self, first_frame, chunks, qp, skip_thres):
        """A closed segment: the DPB seeded with `first_frame` (1, H, W,
        3), then each chunk (1, H, W, 24) coded in turn.  Returns the
        decoder's frames per chunk."""
        ref, memory, outs = self.seed_feature(first_frame), None, []
        for x in chunks:
            memory, ctx = self.adapt(ref, memory)
            y, z = self.analysis(x, ctx, qp)
            ref = self.feature(y, z, memory, ctx, qp, skip_thres)
            outs.append(self.recon(ref, x.shape[1], x.shape[2]))
        return outs
