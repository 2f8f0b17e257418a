"""IntraNoAR, the DCVC-HEM / DC / FM family intra (I-frame) codec model
(counterpart of dcvc_tpu/legacy/hem_intra.py; reference
DCVC-family/DCVC-HEM/src/models/image_model.py:15-100; FM widens N).

Residual conv encoder / decoder at /16 with a UNet refine head, hyper
prior at /64, dual cross-checkerboard spatial prior (gaussian), q_basic x
q_scale continuous rate control.  The stage methods are the EVC image
codec's (analysis / prior / spatial / synthesis), so runtime/evc_codec.py
drives both.  RGB in [0, 1], NHWC.

The JAX package has no reference key map for IntraNoAR, so the module
tree mirrors the flax one (legacy/fm_layers.py): q_basic keeps the flax
shape (1, 1, 1, N) and q_scale (anchor_num, 1, 1, 1).
"""

import dataclasses

import torch
import torch.nn as nn

from ..core.quant import add_noise, lower_bound, ste_round, z_to_int16
from ..entropy.gaussian import gaussian_prob_train, probs_to_bits
from ..models import common
from .dcvc_hem import HEMUNet, dual_prior_train, spatial_params, \
    split_spatial
from .fm_layers import ConvK, LReLU, SubpelConv, lecun_init_legacy_, \
    lrelu, seq


@dataclasses.dataclass(frozen=True)
class IntraNoARConfig:
    n: int = 192
    refine_ch: int = 16
    anchor_num: int = 4


INTRA_NOAR_CONFIG = IntraNoARConfig()
# FM's intra uses the same topology with N=256 (DCVC-FM image_model.py)
INTRA_NOAR_FM_CONFIG = IntraNoARConfig(n=256)
TINY_INTRA_NOAR_CONFIG = IntraNoARConfig(n=8, refine_ch=8)


class RBS(nn.Module):
    """ResidualBlockWithStride (HEM layers.py:42-73)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = ConvK(in_ch, out_ch, stride=2)
        self.conv2 = ConvK(out_ch, out_ch)
        self.downsample = ConvK(in_ch, out_ch, kernel=1, stride=2)

    def forward(self, x):
        h = lrelu(self.conv1(x), 0.01)
        h = lrelu(self.conv2(h), 0.1)
        return h + self.downsample(x)


class RB(nn.Module):
    """ResidualBlock (HEM layers.py:104-131)."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvK(ch, ch)
        self.conv2 = ConvK(ch, ch)

    def forward(self, x):
        h = lrelu(self.conv1(x), 0.01)
        h = lrelu(self.conv2(h), 0.01)
        return h + x


class RBU(nn.Module):
    """ResidualBlockUpsample (HEM layers.py:76-101)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.subpel_conv = SubpelConv(in_ch, out_ch, r=2, kernel=1)
        self.conv = ConvK(out_ch, out_ch)
        self.upsample = SubpelConv(in_ch, out_ch, r=2, kernel=1)

    def forward(self, x):
        h = lrelu(self.subpel_conv(x), 0.01)
        h = lrelu(self.conv(h), 0.1)
        return h + self.upsample(x)


class IntraNoAR(nn.Module):
    def __init__(self, cfg=INTRA_NOAR_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        N = c.n
        self.enc = seq(RBS(3, N), RB(N), RBS(N, N), RB(N), RBS(N, N), RB(N),
                       ConvK(N, N, stride=2))
        self.dec = seq(RB(N), RBU(N, N), RB(N), RBU(N, N), RB(N),
                       RBU(N, N), RB(N),
                       SubpelConv(N, c.refine_ch, r=2, kernel=1))
        self.refine_unet = HEMUNet(c.refine_ch, c.refine_ch)
        self.refine_out = ConvK(c.refine_ch, 3)
        self.hyper_enc = seq(
            ConvK(N, N), LReLU(), ConvK(N, N), LReLU(),
            ConvK(N, N, stride=2), LReLU(), ConvK(N, N), LReLU(),
            ConvK(N, N, stride=2))
        self.hyper_dec = seq(
            ConvK(N, N), LReLU(), SubpelConv(N, N, r=2, kernel=1), LReLU(),
            ConvK(N, N * 3 // 2), LReLU(),
            SubpelConv(N * 3 // 2, N * 3 // 2, r=2, kernel=1), LReLU(),
            ConvK(N * 3 // 2, N * 2))
        self.y_prior_fusion = seq(
            ConvK(N * 2, N * 3), LReLU(0.2), ConvK(N * 3, N * 3), LReLU(0.2),
            ConvK(N * 3, N * 3))
        self.y_spatial_prior = seq(
            ConvK(N * 4, N * 3), LReLU(0.2), ConvK(N * 3, N * 3), LReLU(0.2),
            ConvK(N * 3, N * 2))
        self.q_basic = nn.Parameter(torch.ones(1, 1, 1, N))
        self.q_scale = nn.Parameter(torch.ones(c.anchor_num, 1, 1, 1))
        self.bit_estimator_z = common.BitEstimatorModule(1, N)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as flax initialises the JAX model: lecun-normal
        conv and Dense kernels, zero biases, q_basic / q_scale ones, z prior
        banks N(0, 0.01).  Draws from `generator` (a CPU
        torch.Generator)."""
        lecun_init_legacy_(self, generator)
        self.q_basic.fill_(1.0)
        self.q_scale.fill_(1.0)
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @property
    def dtype(self):
        return self.q_basic.dtype

    def _curr_q(self, q_scale):
        return (lower_bound(self.q_basic, 0.5) * q_scale).to(self.dtype)

    def _refine(self, feat):
        return self.refine_out(self.refine_unet(feat))

    # ----------------------------------------- inference stage methods
    # (the EVC runtime's surface, image_model.py:131-200)

    def analysis(self, x, q_scale):
        """x (1, H, W, 3) padded to 64 -> (y float32, z_int int16)."""
        y = self.enc(x.to(self.dtype)) / self._curr_q(q_scale)
        return y.float(), z_to_int16(self.hyper_enc(y))

    def prior(self, z_int):
        """z_int -> (q_step lower-bounded at 0.5, scales, means)."""
        params = self.y_prior_fusion(self.hyper_dec(z_int.to(self.dtype)))
        q_step, scales, means = params.chunk(3, dim=-1)
        return torch.clamp_min(q_step, 0.5), scales, means

    def spatial(self, y_hat_0, q_step, scales, means):
        """The second pass's (scales, means) from y_hat part 0."""
        return split_spatial(self.y_spatial_prior(spatial_params(
            y_hat_0, q_step, scales, means, self.dtype)))

    def synthesis(self, y_hat_acc, q_scale):
        y_hat = y_hat_acc * self._curr_q(q_scale).float()
        x_hat = self._refine(self.dec(y_hat.to(self.dtype)))
        return torch.clamp(x_hat.float(), 0.0, 1.0)

    # ----------------------------------------------------------- forward

    def forward(self, x, q_scale=None, noise=None):
        """Training forward (image_model.py:53-100).  x: (B, H, W, 3) RGB
        in [0, 1]; noise: None (the rate of the rounded y), or a tensor of
        y's shape or a torch.Generator for the U(-0.5, 0.5) noise."""
        if q_scale is None:
            q_scale = self.q_scale[0, 0, 0, 0]
        curr_q = self._curr_q(q_scale)
        y = self.enc(x.to(self.dtype)) / curr_q
        z_hat = ste_round(self.hyper_enc(y))
        params = self.y_prior_fusion(self.hyper_dec(z_hat))
        q_step, scales, means = params.chunk(3, dim=-1)
        y_res, y_q, y_hat, scales_hat = dual_prior_train(
            y, q_step, scales, means, self.y_spatial_prior)
        x_hat = self._refine(self.dec(y_hat * curr_q))
        x_hat = torch.clamp(x_hat.float(), 0.0, 1.0)
        y_for_bit = y_q if noise is None else add_noise(y_res, noise)
        bits_y = probs_to_bits(gaussian_prob_train(
            y_for_bit, scales_hat)).sum(dim=(1, 2, 3))
        bits_z = probs_to_bits(self.bit_estimator_z.get_prob(
            z_hat, 0)).sum(dim=(1, 2, 3))
        pixel_num = x.shape[1] * x.shape[2]
        mse = torch.mean((x_hat - x.float()) ** 2, dim=(1, 2, 3))
        return {"x_hat": x_hat, "bpp_y": bits_y / pixel_num,
                "bpp_z": bits_z / pixel_num,
                "bpp": (bits_y + bits_z) / pixel_num, "mse": mse}
