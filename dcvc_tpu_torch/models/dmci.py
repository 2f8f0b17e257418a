"""DMCI intra (image) codec model (counterpart of dcvc_tpu/models/dmci.py).

Channel plan (default config): 8x pixel-unshuffled input (192ch) -> 384ch
encoder trunk -> y 256ch @ /16, hyper z 128ch @ /64, 4-step quadtree
spatial prior with scales+means, 64-QP per-channel quant vectors
(q_scale_{enc,dec,y_enc,y_dec}).

The module tree follows the reference torch DMCI (src/models/image_model.py),
so its state_dict keys are the reference's: `enc.enc_2.6.weight`,
`hyper_dec.conv.0.up.conv.0.weight`, `y_prior_fusion.conv.1.dc.0.bias`, ...
(the names dcvc_tpu.utils.torch_import.key_fn_dmci gives the flax params).

The stage methods (analysis / prior0 / prior_step / synthesis) are what
the runtime calls; the encoder and the decoder call the same prior0 /
prior_step / synthesis, which is what keeps their priors bit-identical.
`forward(x, qp, noise)` is the training forward, with per-sample QPs.
"""

import collections
import dataclasses

import torch
import torch.nn as nn

from ..core.padding import pad_for_y
from ..core.quant import ste_round
from ..core.shuffle import pixel_shuffle, pixel_unshuffle
from ..layers.blocks import (
    Conv1x1, Conv3x3, DepthConvBlock, ResidualBlockUpsample,
    ResidualBlockWithStride2, lecun_init_,
)
from . import common


@dataclasses.dataclass(frozen=True)
class DMCIConfig:
    ch_src: int = 3 * 8 * 8   # pixel-unshuffle(8) of RGB
    ch_enc_dec: int = 384
    ch_y: int = 256
    ch_z: int = 128
    enc_depth: int = 6        # DCBs in enc_2 before the strided conv
    dec_depth: int = 12       # DCBs in dec_1 after the upsample
    qp_num: int = 64


TINY_CONFIG = DMCIConfig(ch_enc_dec=32, ch_y=16, ch_z=8,
                         enc_depth=1, dec_depth=1, qp_num=8)
# mid-size config for trained quality gates: big enough that the RD
# behavior is representative, small enough to train on one chip in hours
SMALL_CONFIG = DMCIConfig(ch_enc_dec=128, ch_y=64, ch_z=32,
                          enc_depth=2, dec_depth=3, qp_num=16)

# the reference's enc_2 Sequential holds 6 DCBs, so its strided conv is
# entry 6 whatever enc_depth is
_ENC_DOWN = "6"


class IntraEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        assert c.enc_depth <= int(_ENC_DOWN)
        self.enc_1 = DepthConvBlock(c.ch_src, c.ch_enc_dec)
        blocks = [(str(i), DepthConvBlock(c.ch_enc_dec, c.ch_enc_dec))
                  for i in range(c.enc_depth)]
        blocks.append((_ENC_DOWN, Conv3x3(c.ch_enc_dec, c.ch_y, stride=2)))
        self.enc_2 = nn.Sequential(collections.OrderedDict(blocks))

    def forward(self, x, quant_step):
        out = self.enc_1(pixel_unshuffle(x, 8))
        return self.enc_2(out * quant_step)


class IntraDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dec_1 = nn.Sequential(
            ResidualBlockUpsample(c.ch_y, c.ch_enc_dec),
            *[DepthConvBlock(c.ch_enc_dec, c.ch_enc_dec)
              for _ in range(c.dec_depth)])
        self.dec_2 = DepthConvBlock(c.ch_enc_dec, c.ch_src)

    def forward(self, x, quant_step):
        out = self.dec_1(x) * quant_step
        return pixel_shuffle(self.dec_2(out), 8)


class IntraHyperEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Sequential(
            DepthConvBlock(c.ch_y, c.ch_z),
            ResidualBlockWithStride2(c.ch_z, c.ch_z),
            ResidualBlockWithStride2(c.ch_z, c.ch_z))

    def forward(self, x):
        return self.conv(x)


class IntraHyperDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Sequential(
            ResidualBlockUpsample(c.ch_z, c.ch_z),
            ResidualBlockUpsample(c.ch_z, c.ch_z),
            DepthConvBlock(c.ch_z, c.ch_y))

    def forward(self, x):
        return self.conv(x)


class _PriorStack(nn.Module):
    """Three DCBs and a 1x1 conv: the y prior fusion and the spatial prior."""

    def __init__(self, cin, cy):
        super().__init__()
        self.conv = nn.Sequential(
            DepthConvBlock(cin, cy * 2),
            DepthConvBlock(cy * 2, cy * 2),
            DepthConvBlock(cy * 2, cy * 2),
            Conv1x1(cy * 2, cy * 2))

    def forward(self, x):
        return self.conv(x)


class DMCI(nn.Module):
    """DCVC-UF intra codec (reference DMCI, image_model.py:126-227)."""

    def __init__(self, cfg=DMCIConfig()):
        super().__init__()
        c = self.cfg = cfg
        cy = c.ch_y
        self.enc = IntraEncoder(c)
        self.hyper_enc = IntraHyperEncoder(c)
        self.hyper_dec = IntraHyperDecoder(c)
        self.y_prior_fusion = _PriorStack(cy, cy)
        self.y_spatial_prior_reduction = Conv1x1(cy * 2, cy)
        self.y_spatial_prior_adaptor_1 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_2 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_3 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior = _PriorStack(cy * 2, cy)
        self.dec = IntraDecoder(c)
        q = (c.qp_num,)
        self.q_scale_enc = nn.Parameter(torch.zeros(q + (c.ch_enc_dec,)))
        self.q_scale_dec = nn.Parameter(torch.zeros(q + (c.ch_enc_dec,)))
        self.q_scale_y_enc = nn.Parameter(torch.zeros(q + (cy,)))
        self.q_scale_y_dec = nn.Parameter(torch.zeros(q + (cy,)))
        self.bit_estimator_z = common.BitEstimatorModule(c.qp_num, c.ch_z)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as dcvc_tpu's DMCI.init does it: lecun-normal
        convs with zero biases, the log-spaced quant-step ladders, and
        N(0, 0.01) z prior banks.  Draws from `generator` (a CPU
        torch.Generator)."""
        lecun_init_(self, generator)
        c = self.cfg
        for name, lo, hi, inv in (("q_scale_enc", 0.5, 2.0, False),
                                  ("q_scale_dec", 0.5, 2.0, True),
                                  ("q_scale_y_enc", 0.3, 3.0, False),
                                  ("q_scale_y_dec", 0.3, 3.0, True)):
            p = getattr(self, name)
            p.copy_(common.q_ladder_init(lo, hi, c.qp_num, p.shape[1], inv))
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @property
    def dtype(self):
        return self.q_scale_enc.dtype

    def _q(self, table, qp):
        """(qp_num, C) table -> the (C,) row of an int `qp`, or the
        (B, 1, 1, C) rows of a per-sample qp (B,)."""
        return common.select_qp(table, qp)

    # ------------------------------------------------------ training path

    def forward(self, x, qp, noise):
        """Training forward (reference forward_one_frame,
        image_model.py:150).  x: (B, H, W, 3) YCbCr - 0.5, H and W
        multiples of 64; qp: int or (B,); noise: the y / z noise of the
        rate terms (common.rate_terms).  Returns x_hat and the per-sample
        mse, bpp, bits_y and bits_z, each (B,)."""
        y = self.enc(x, self._q(self.q_scale_enc, qp))
        z = self.hyper_enc(y)
        params = self.y_prior_fusion(self.hyper_dec(ste_round(z)))
        params = params[:, :y.shape[1], :y.shape[2], :]
        adaptors = (self.y_spatial_prior_adaptor_1,
                    self.y_spatial_prior_adaptor_2,
                    self.y_spatial_prior_adaptor_3)
        y_res, _, y_hat, scales_hat = common.forward_prior_4x_train(
            y, self._q(self.q_scale_y_enc, qp),
            self._q(self.q_scale_y_dec, qp), params,
            self.y_spatial_prior_reduction, adaptors, self.y_spatial_prior)
        x_hat = self.dec(y_hat, self._q(self.q_scale_dec, qp))
        bits_y, bits_z, bpp = common.rate_terms(
            self.bit_estimator_z, y_res, scales_hat, z, qp, noise,
            x.shape[1] * x.shape[2])
        return {"x_hat": x_hat, "mse": common.get_mse(x, x_hat), "bpp": bpp,
                "bits_y": bits_y, "bits_z": bits_z}

    # ----------------------------------------------------- inference path

    def analysis(self, x, qp):
        """x (1, H, W, 3) padded -> (y * q_y_enc, z_int8).

        Frames pad to 16 so the y grid may be odd; the stride-2 hyper
        path needs 4-alignment, so y is replicate-padded for it alone."""
        y = self.enc(x, self._q(self.q_scale_enc, qp))
        z = self.hyper_enc(pad_for_y(y))
        z_int8 = torch.clamp(torch.round(z.float()), -128, 127).to(torch.int8)
        y_scaled = y * self._q(self.q_scale_y_enc, qp)
        return y_scaled, z_int8

    def prior0(self, z_int8, yh, yw):
        """z_int8 -> (scales0, means0, common_ctx).  Shared enc/dec.

        The hyper output lives on the 4-aligned grid; it is cropped to the
        (possibly odd) y grid BEFORE the fusion convs, as the reference
        does."""
        hyper = self.hyper_dec(z_int8.to(self.dtype))[:, :yh, :yw, :]
        params = self.y_prior_fusion(hyper)
        scales, means = common.separate_prior_image(params)
        ctx = self.y_spatial_prior_reduction(params)
        return scales, means, ctx

    def prior_step(self, ctx, y_hat_so_far, step):
        """Spatial prior for step k in {1, 2, 3}.  Shared enc/dec."""
        adaptor = (self.y_spatial_prior_adaptor_1,
                   self.y_spatial_prior_adaptor_2,
                   self.y_spatial_prior_adaptor_3)[step - 1]
        sp_in = torch.cat([y_hat_so_far.to(self.dtype), ctx], dim=-1)
        out = self.y_spatial_prior(adaptor(sp_in))
        scales, means = out.chunk(2, dim=-1)
        return scales, means

    def synthesis(self, y_hat_so_far, qp, out_h, out_w):
        """y_hat sum -> clamped reconstruction, cropped to (out_h, out_w)."""
        y_hat = y_hat_so_far.to(self.dtype) * self._q(self.q_scale_y_dec, qp)
        x_hat = self.dec(y_hat, self._q(self.q_scale_dec, qp))
        x_hat = torch.clamp(x_hat.float(), -0.5, 0.5)
        return x_hat[:, :out_h, :out_w, :]
