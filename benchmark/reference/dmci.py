"""Frozen plain reference of DCVC-UF's intra codec DMCI (microsoft/DCVC
src/models/image_model.py), float32, NHWC: the analysis, the hyper
prior, the 4-step quadtree prior with the skip, and the synthesis of one
image, end to end from the source to the clamped reconstruction.  The
module tree and the state_dict keys are the reference's.  It imports
nothing of the program.
"""

import collections

import torch
import torch.nn as nn

from .layers import (Conv1x1, Conv3x3, DepthConvBlock, Numerics,
                     ResidualBlockUpsample, ResidualBlockWithStride2,
                     code_step, mask_4x, pad_replicate, pad_to,
                     padding_size, pixel_shuffle, pixel_unshuffle)


class IntraEncoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.enc_1 = DepthConvBlock(num, c["ch_src"], c["ch_enc_dec"])
        blocks = [(str(i), DepthConvBlock(num, c["ch_enc_dec"],
                                          c["ch_enc_dec"]))
                  for i in range(c["enc_depth"])]
        # the reference's enc_2 holds 6 DCBs: its strided conv is entry 6
        blocks.append(("6", Conv3x3(num, c["ch_enc_dec"], c["ch_y"],
                                    stride=2)))
        self.enc_2 = nn.Sequential(collections.OrderedDict(blocks))

    def forward(self, x, quant_step):
        return self.enc_2(self.enc_1(pixel_unshuffle(x, 8)) * quant_step)


class IntraDecoder(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.dec_1 = nn.Sequential(
            ResidualBlockUpsample(num, c["ch_y"], c["ch_enc_dec"]),
            *[DepthConvBlock(num, c["ch_enc_dec"], c["ch_enc_dec"])
              for _ in range(c["dec_depth"])])
        self.dec_2 = DepthConvBlock(num, c["ch_enc_dec"], c["ch_src"])

    def forward(self, x, quant_step):
        return pixel_shuffle(self.dec_2(self.dec_1(x) * quant_step), 8)


class _Seq(nn.Module):
    def __init__(self, *mods):
        super().__init__()
        self.conv = nn.Sequential(*mods)

    def forward(self, x):
        return self.conv(x)


class BitEstimatorZ(nn.Module):
    """The z prior's banks (qp_num, ch_z, 4 | 3); the reconstruction does
    not use them, the weight recipe draws them."""

    def __init__(self, qp_num, ch_z):
        super().__init__()
        self.h = nn.Parameter(torch.zeros(qp_num, ch_z, 4))
        self.b = nn.Parameter(torch.zeros(qp_num, ch_z, 4))
        self.a = nn.Parameter(torch.zeros(qp_num, ch_z, 3))


class DMCI(nn.Module):
    def __init__(self, widths, numerics=None):
        super().__init__()
        num = numerics or Numerics("f32")
        c = self.c = dict(widths)
        cy = c["ch_y"]
        self.enc = IntraEncoder(num, c)
        self.hyper_enc = _Seq(
            DepthConvBlock(num, cy, c["ch_z"]),
            ResidualBlockWithStride2(num, c["ch_z"], c["ch_z"]),
            ResidualBlockWithStride2(num, c["ch_z"], c["ch_z"]))
        self.hyper_dec = _Seq(
            ResidualBlockUpsample(num, c["ch_z"], c["ch_z"]),
            ResidualBlockUpsample(num, c["ch_z"], c["ch_z"]),
            DepthConvBlock(num, c["ch_z"], cy))

        def prior_stack(cin):
            return _Seq(DepthConvBlock(num, cin, cy * 2),
                        DepthConvBlock(num, cy * 2, cy * 2),
                        DepthConvBlock(num, cy * 2, cy * 2),
                        Conv1x1(num, cy * 2, cy * 2))
        self.y_prior_fusion = prior_stack(cy)
        self.y_spatial_prior_reduction = Conv1x1(num, cy * 2, cy)
        for k in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{k}",
                    DepthConvBlock(num, cy * 2, cy * 2, force_adaptor=True))
        self.y_spatial_prior = prior_stack(cy * 2)
        self.dec = IntraDecoder(num, c)
        q = (c["qp_num"],)
        self.q_scale_enc = nn.Parameter(torch.zeros(q + (c["ch_enc_dec"],)))
        self.q_scale_dec = nn.Parameter(torch.zeros(q + (c["ch_enc_dec"],)))
        self.q_scale_y_enc = nn.Parameter(torch.zeros(q + (cy,)))
        self.q_scale_y_dec = nn.Parameter(torch.zeros(q + (cy,)))
        self.bit_estimator_z = BitEstimatorZ(c["qp_num"], c["ch_z"])

    def analysis(self, x, qp):
        """x (1, H, W, 3) in [-0.5, 0.5] -> (y scaled by q_scale_y_enc,
        z rounded): the encoder's own stage."""
        x = pad_replicate(x, *padding_size(x.shape[1], x.shape[2], 16))
        y = self.enc(x, self.q_scale_enc[qp])
        z = self.hyper_enc(pad_to(y, 4))
        z = torch.clamp(torch.round(z), -128.0, 127.0)
        return y * self.q_scale_y_enc[qp], z

    def reconstruct(self, y, z, qp, h, w, skip_thres):
        """The stages the encoder and the decoder share: the priors, the
        4 coding steps with the skip, and the synthesis -> (1, h, w, 3)
        clamped to [-0.5, 0.5]."""
        yh, yw, cy = y.shape[1], y.shape[2], y.shape[3]
        params = self.y_prior_fusion(self.hyper_dec(z)[:, :yh, :yw])
        scales, means = params.chunk(2, dim=-1)
        ctx = self.y_spatial_prior_reduction(params)
        y_hat = torch.zeros_like(y)
        for step in range(4):
            if step > 0:
                adaptor = getattr(self, f"y_spatial_prior_adaptor_{step}")
                out = self.y_spatial_prior(
                    adaptor(torch.cat([y_hat, ctx], dim=-1)))
                scales, means = out.chunk(2, dim=-1)
            y_hat = y_hat + code_step(y, scales, means,
                                      mask_4x(yh, yw, cy, step, y.device),
                                      skip_thres)
        x_hat = self.dec(y_hat * self.q_scale_y_dec[qp],
                         self.q_scale_dec[qp])
        return torch.clamp(x_hat, -0.5, 0.5)[:, :h, :w]

    def code(self, x, qp, skip_thres):
        """x (1, H, W, 3) -> the decoder's reconstruction (1, H, W, 3)."""
        y, z = self.analysis(x, qp)
        return self.reconstruct(y, z, qp, x.shape[1], x.shape[2],
                                skip_thres)
