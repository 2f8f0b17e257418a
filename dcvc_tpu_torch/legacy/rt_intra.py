"""DCVC-RT intra (image) codec model (counterpart of
dcvc_tpu/legacy/rt_intra.py; reference DCVC-RT/src/models/image_model.py).

A DMCI predecessor: 8x-unshuffled input -> 368-channel trunk -> y 256ch
@ /16, hyper z 128ch @ /64, the same 4-step quadtree spatial prior; but
the y quantisation steps are hyper-predicted per-position maps, not per-QP
channel vectors: the prior fusion emits 2N+2 channels whose first two
become q_enc / q_dec through sigmoid() * 1.5 + 0.5
(DCVC-RT/src/models/common_model.py:63-73).  Only the feature-domain
per-QP banks (q_scale_enc / q_scale_dec at 368ch) remain.  The signal
domain is [0, 1] (the reference feeds x / 255 with no centring), and the
reconstruction is clamped to it.

Every block is UF's DepthConvBlock, so on the card each one runs K1, the
trunk's at C = 368 (a width with no 64-wide divisor: tail tiles).  The
sub-modules are models/dmci.py's, so the state_dict keys are DMCI's
without q_scale_y_enc / q_scale_y_dec (the names dcvc_tpu's key_fn_dmci
gives the flax params).  runtime/rt_image_codec.py codes with it.
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.masks import make_mask_4x
from ..core.padding import pad_for_y
from ..core.quant import ste_round
from ..layers.blocks import Conv1x1, DepthConvBlock, lecun_init_
from ..models import common
from ..models.dmci import DMCIConfig, IntraDecoder, IntraEncoder, \
    IntraHyperDecoder, IntraHyperEncoder, _PriorStack


@dataclasses.dataclass(frozen=True)
class DMCIRTConfig:
    ch_src: int = 3 * 8 * 8
    ch_enc_dec: int = 368     # reference g_ch_enc_dec (image_model.py:14)
    ch_y: int = 256
    ch_z: int = 128
    enc_depth: int = 6
    dec_depth: int = 12
    qp_num: int = 64

    def as_dmci(self):
        """The sub-modules are shared with models/dmci.py; they only read
        these fields."""
        return DMCIConfig(ch_src=self.ch_src, ch_enc_dec=self.ch_enc_dec,
                          ch_y=self.ch_y, ch_z=self.ch_z,
                          enc_depth=self.enc_depth, dec_depth=self.dec_depth,
                          qp_num=self.qp_num)


TINY_RT_INTRA_CONFIG = DMCIRTConfig(ch_enc_dec=32, ch_y=16, ch_z=8,
                                    enc_depth=1, dec_depth=1, qp_num=8)


class RTPriorFusion(nn.Module):
    """y_prior_fusion emitting 2N+2: [q_enc, q_dec, scales, means]
    (image_model.py:122-127)."""

    def __init__(self, cy):
        super().__init__()
        self.conv = nn.Sequential(
            DepthConvBlock(cy, cy * 2),
            DepthConvBlock(cy * 2, cy * 2),
            DepthConvBlock(cy * 2, cy * 2),
            Conv1x1(cy * 2, cy * 2 + 2))

    def forward(self, x):
        return self.conv(x)


def separate_prior_rt_image(params):
    """(..., 2N+2) -> q_enc, q_dec (sigmoid * 1.5 + 0.5, float32, each
    (..., 1)), scales, means (DCVC-RT common_model.py:68-73, image
    branch)."""
    q = torch.sigmoid(params[..., :2].float()) * 1.5 + 0.5
    scales, means = params[..., 2:].chunk(2, dim=-1)
    return q[..., 0:1], q[..., 1:2], scales, means


class DMCIRT(nn.Module):
    """DCVC-RT intra codec (image_model.py:103-209)."""

    def __init__(self, cfg=DMCIRTConfig()):
        super().__init__()
        c = self.cfg = cfg
        cy = c.ch_y
        dc = c.as_dmci()
        self.enc = IntraEncoder(dc)
        self.hyper_enc = IntraHyperEncoder(dc)
        self.hyper_dec = IntraHyperDecoder(dc)
        self.y_prior_fusion = RTPriorFusion(cy)
        self.y_spatial_prior_reduction = Conv1x1(cy * 2 + 2, cy)
        self.y_spatial_prior_adaptor_1 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_2 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_3 = DepthConvBlock(
            cy * 2, cy * 2, force_adaptor=True)
        self.y_spatial_prior = _PriorStack(cy * 2, cy)
        self.dec = IntraDecoder(dc)
        q = (c.qp_num, c.ch_enc_dec)
        self.q_scale_enc = nn.Parameter(torch.zeros(q))
        self.q_scale_dec = nn.Parameter(torch.zeros(q))
        self.bit_estimator_z = common.BitEstimatorModule(c.qp_num, c.ch_z)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as dcvc_tpu's DMCIRT.init does it:
        lecun-normal convs with zero biases, the log-spaced feature-domain
        quant-step ladders, and N(0, 0.01) z prior banks.  Draws from
        `generator` (a CPU torch.Generator)."""
        lecun_init_(self, generator)
        c = self.cfg
        self.q_scale_enc.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num,
                                                    c.ch_enc_dec))
        self.q_scale_dec.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num,
                                                    c.ch_enc_dec, True))
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @property
    def dtype(self):
        return self.q_scale_enc.dtype

    def _q(self, table, qp):
        return common.select_qp(table, qp)

    def _adaptor(self, step):
        return (self.y_spatial_prior_adaptor_1,
                self.y_spatial_prior_adaptor_2,
                self.y_spatial_prior_adaptor_3)[step - 1]

    # ------------------------------------------------------ training path

    def forward(self, x, qp, noise):
        """Training forward (dcvc_tpu's DMCIRT.__call__).  x: (B, H, W, 3)
        RGB in [0, 1], H and W multiples of 64; qp: int or (B,); noise: the
        rate terms' y / z noise (common.rate_terms).  Returns x_hat and
        the per-sample mse, bpp, bits_y and bits_z, each (B,)."""
        y = self.enc(x, self._q(self.q_scale_enc, qp))
        z = self.hyper_enc(y)
        params = self.y_prior_fusion(self.hyper_dec(ste_round(z)))
        yh, yw = y.shape[1], y.shape[2]
        params = params[:, :yh, :yw, :]
        q_enc, q_dec, scales, means = separate_prior_rt_image(params)

        y_s = y * q_enc.to(y.dtype)
        ctx = self.y_spatial_prior_reduction(params)
        masks = common._masks(make_mask_4x, y)
        y_res_all = s_all = 0
        y_hat_so_far = torch.zeros_like(y_s)
        for step in range(4):
            if step > 0:
                sp_in = torch.cat([y_hat_so_far, ctx], dim=-1)
                out = self.y_spatial_prior(self._adaptor(step)(sp_in))
                scales, means = out.chunk(2, dim=-1)
            y_res, _, y_hat, s_hat = common.process_with_mask_train(
                y_s, scales, means, masks[step])
            y_hat_so_far = y_hat_so_far + y_hat
            y_res_all = y_res_all + y_res
            s_all = s_all + s_hat
        y_hat = y_hat_so_far * q_dec.to(y_s.dtype)
        x_hat = self.dec(y_hat, self._q(self.q_scale_dec, qp))
        bits_y, bits_z, bpp = common.rate_terms(
            self.bit_estimator_z, y_res_all, s_all, z, qp, noise,
            x.shape[1] * x.shape[2])
        mse = torch.mean((x - x_hat) ** 2, dim=(1, 2, 3))
        return {"x_hat": x_hat, "mse": mse, "bpp": bpp, "bits_y": bits_y,
                "bits_z": bits_z}

    # ----------------------------------------------------- inference path
    # models/dmci.py's decomposition, but prior0 also gives the
    # hyper-predicted q_enc / q_dec maps, and synthesis takes q_dec.

    def analysis(self, x, qp):
        """x (1, H, W, 3) in [0, 1], padded -> (y float32 UNSCALED,
        z_int8); y is replicate-padded to 4 for the hyper path alone."""
        y = self.enc(x, self._q(self.q_scale_enc, qp))
        z = self.hyper_enc(pad_for_y(y))
        z_int8 = torch.clamp(torch.round(z.float()), -128, 127).to(torch.int8)
        return y.float(), z_int8

    def prior0(self, z_int8, yh, yw):
        """z_int8 -> (scales, means, ctx, q_enc, q_dec).  Shared enc/dec.
        The 4-aligned hyper grid is cropped to the (possibly odd) y grid
        before the fusion (reference crop_hyper_params)."""
        hyper = self.hyper_dec(z_int8.to(self.dtype))[:, :yh, :yw, :]
        params = self.y_prior_fusion(hyper)
        q_enc, q_dec, scales, means = separate_prior_rt_image(params)
        ctx = self.y_spatial_prior_reduction(params)
        return scales, means, ctx, q_enc, q_dec

    def prior_step(self, ctx, y_hat_so_far, step):
        """Spatial prior for step k in {1, 2, 3}.  Shared enc/dec."""
        sp_in = torch.cat([y_hat_so_far.to(self.dtype), ctx], dim=-1)
        out = self.y_spatial_prior(self._adaptor(step)(sp_in))
        scales, means = out.chunk(2, dim=-1)
        return scales, means

    def synthesis(self, y_hat_so_far, q_dec, qp, out_h, out_w):
        """y_hat sum * the hyper q_dec map -> the [0, 1]-clamped
        reconstruction, cropped to (out_h, out_w)."""
        y_hat = (y_hat_so_far * q_dec).to(self.dtype)
        x_hat = self.dec(y_hat, self._q(self.q_scale_dec, qp))
        x_hat = torch.clamp(x_hat.float(), 0.0, 1.0)
        return x_hat[:, :out_h, :out_w, :]
