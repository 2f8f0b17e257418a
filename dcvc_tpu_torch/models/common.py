"""Shared compression-model pieces of the DMCI, DMC-HT and DMC-LD models
(counterpart of dcvc_tpu/models/common.py; reference
src/models/common_model.py).

Inference: the prior splits, the quant-step ladder init and the z prior's
parameter bank.  Training: the straight-through mask quantization, the
quadtree (4x) and checkerboard (2x) prior passes, the per-sample QP
selection, the rate terms and the distortion of the RD loss.
"""

import numpy as np
import torch
import torch.nn as nn

from ..core.color import ycbcr2rgb
from ..core.masks import make_mask_2x, make_mask_4x
from ..core.quant import add_noise, lower_bound, ste_round, uniform_noise
from ..entropy.bit_estimator import bit_estimator_z_fwd
from ..entropy.gaussian import gaussian_prob_train, probs_to_bits

QP_NUM = 64


def select_qp(table, qp):
    """(qp_num, ...) table -> the row of `qp`: an int (or 0-d tensor)
    gives the (...) row; per-sample qp of shape (B,) gives (B, 1, 1, ...),
    which broadcasts over NHWC."""
    if isinstance(qp, torch.Tensor) and qp.ndim == 1:
        rows = table[qp.to(table.device)]
        return rows.reshape(rows.shape[:1] + (1, 1) + rows.shape[1:])
    return table[int(qp)]


class BitEstimatorModule(nn.Module):
    """The factorized z prior (reference BitEstimator): banks h, b of shape
    (qp_num, C, 4) and a of shape (qp_num, C, 3).  The training forwards
    take z's probability from it (get_prob, the JAX BitEstimator.get_prob);
    the codec turns the banks into a CDF bank with
    entropy/bit_estimator.py."""

    def __init__(self, qp_num, channel):
        super().__init__()
        self.h = nn.Parameter(torch.zeros(qp_num, channel, 4))
        self.b = nn.Parameter(torch.zeros(qp_num, channel, 4))
        self.a = nn.Parameter(torch.zeros(qp_num, channel, 3))

    def get_prob(self, x, qp):
        """Training-time P(round(z) = x) of x (B, H, W, C) at qp (int or
        (B,))."""
        return bit_estimator_z_fwd(x, select_qp(self.h, qp),
                                   select_qp(self.b, qp),
                                   select_qp(self.a, qp))

    def from_reference(self, state, key_fn, prefix="bit_estimator_z"):
        """`state` (a reference state_dict) with this prior's Bitparm
        tensors (key_fn's `stack_last` entries `{prefix}.f{i}.{h,b,a}`,
        each (Q, C, 1, 1), Q may be 1) stacked on a last axis into the h /
        b / a banks at `{prefix}.{h,b,a}`, as dcvc_tpu's importer does;
        every other key as it is."""
        state = dict(state)
        for name in ("h", "b", "a"):
            bank = getattr(self, name)
            kind, keys = key_fn((prefix, name))
            assert kind == "stack_last"
            if not all(k in state for k in keys):
                continue
            parts = [state.pop(k).float() for k in keys]
            parts = [p.reshape(p.shape[0], -1).expand(bank.shape[:-1])
                     for p in parts]
            state[f"{prefix}.{name}"] = torch.stack(parts, dim=-1)
        return state

    def bank(self):
        """{h, b, a} as float32 numpy arrays."""
        return {k: getattr(self, k).detach().float().cpu().numpy()
                for k in ("h", "b", "a")}


def separate_prior_image(params):
    """(..., 2C) prior -> (scales, means), each (..., C)."""
    scales, means = params.chunk(2, dim=-1)
    return scales, means


def separate_prior_video_infer(params):
    """(..., 3C) fused video prior -> (q_enc, q_dec, scales, means): the
    per-position quant step is bounded below by 0.5 in f32 (the
    inference form of lower_bound) and q_enc is its reciprocal."""
    quant_step, scales, means = params.chunk(3, dim=-1)
    q_dec = torch.clamp_min(quant_step.float(), 0.5)
    return 1.0 / q_dec, q_dec, scales, means


def q_ladder_init(lo, hi, qp_num, ch, inverse=False):
    """(qp_num, ch) quant-step bank: rows log-spaced lo -> hi along the QP
    axis (their reciprocals when `inverse`), as dcvc_tpu's q_ladder_init
    seeds the per-QP rows."""
    row = np.exp(np.linspace(np.log(lo), np.log(hi), qp_num))
    if inverse:
        row = 1.0 / row
    return torch.from_numpy(np.repeat(row[:, None], ch, 1).astype(np.float32))


# ------------------------------------------------------------- training

def separate_prior_video(params):
    """(..., 3C) fused video prior -> (q_enc, q_dec, scales, means), the
    quant step lower-bounded at 0.5 with the reference's gradient."""
    quant_step, scales, means = params.chunk(3, dim=-1)
    quant_step = lower_bound(quant_step, 0.5)
    return 1.0 / quant_step, quant_step, scales, means


def _masks(fn, y):
    """fn(h, w, c)'s numpy masks as tensors of y's dtype and device."""
    h, w, c = y.shape[-3:]
    return [torch.from_numpy(m).to(y.device, y.dtype) for m in fn(h, w, c)]


def process_with_mask_train(y, scales, means, mask):
    """Reference process_with_mask: STE round, no skip or clamp."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = ste_round(y_res)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


def forward_prior_4x_train(y, q_enc, q_dec, params, reduction_fn,
                           adaptor_fns, spatial_prior_fn,
                           spatial_prior_has_scales=False):
    """Training-time quadtree 4-step prior pass (common_model.py:231-282).

    reduction_fn(params) -> common context; the adaptors and the spatial
    prior give each later step's means (video: adaptor_fns[k](y_hat so
    far, common)) or scales and means (adaptor_fns[k](cat(y_hat so far,
    common))).  The image codec passes its per-channel q_enc / q_dec and
    a prior of scales and means; video passes q_enc=None and takes both
    from the fused prior."""
    if q_enc is None:
        q_enc, q_dec, scales, means = separate_prior_video(params)
    else:
        spatial_prior_has_scales = True
        scales, means = separate_prior_image(params)
    y = y * q_enc

    common = reduction_fn(params)
    masks = _masks(make_mask_4x, y)
    y_res_list, y_q_list, s_hat_list = [], [], []
    y_hat_so_far = torch.zeros_like(y)
    for step in range(4):
        if step > 0:
            if spatial_prior_has_scales:
                sp_in = torch.cat([y_hat_so_far, common], dim=-1)
                out = spatial_prior_fn(adaptor_fns[step - 1](sp_in))
                scales, means = out.chunk(2, dim=-1)
            else:
                means = spatial_prior_fn(
                    adaptor_fns[step - 1](y_hat_so_far, common))
        y_res, y_q, y_hat, s_hat = process_with_mask_train(
            y, scales, means, masks[step])
        y_hat_so_far = y_hat_so_far + y_hat
        y_res_list.append(y_res)
        y_q_list.append(y_q)
        s_hat_list.append(s_hat)

    y_hat = y_hat_so_far * q_dec
    y_res = (y_res_list[0] + y_res_list[1]) + (y_res_list[2] + y_res_list[3])
    y_q = (y_q_list[0] + y_q_list[1]) + (y_q_list[2] + y_q_list[3])
    scales_hat = (s_hat_list[0] + s_hat_list[1]) + \
        (s_hat_list[2] + s_hat_list[3])
    return y_res, y_q, y_hat, scales_hat


def forward_prior_2x_train(y, params, spatial_prior_fn):
    """Training-time checkerboard 2-step pass (common_model.py:212-229)."""
    q_enc, q_dec, scales, means = separate_prior_video(params)
    y = y * q_enc
    mask_0, mask_1 = _masks(make_mask_2x, y)
    y_res_0, y_q_0, y_hat_0, s_hat_0 = process_with_mask_train(
        y, scales, means, mask_0)
    means = spatial_prior_fn(y_hat_0, params)
    y_res_1, y_q_1, y_hat_1, s_hat_1 = process_with_mask_train(
        y, scales, means, mask_1)
    y_hat = (y_hat_0 + y_hat_1) * q_dec
    return y_res_0 + y_res_1, y_q_0 + y_q_1, y_hat, s_hat_0 + s_hat_1


def noise_shapes(cfg, b, h, w):
    """Shapes of the training forward's y and z noise for a (b, h, w)
    input (h, w multiples of 64): y at /16, z at /64."""
    return {"y": (b, h // 16, w // 16, cfg.ch_y),
            "z": (b, h // 64, w // 64, cfg.ch_z)}


def draw_noise(cfg, b, h, w, generator, device):
    """U(-0.5, 0.5) noise of one training forward, y then z, drawn from
    `generator` and moved to `device`."""
    return {k: uniform_noise(s, generator, device)
            for k, s in noise_shapes(cfg, b, h, w).items()}


def rate_terms(bit_estimator_z, y_res, scales_hat, z, qp, noise, pixel_num):
    """(bits_y, bits_z, bpp), each (B,): y and z with U(-0.5, 0.5) noise
    under the Gaussian and the factorized prior.  `noise`: {"y", "z"}
    tensors, or a torch.Generator to draw them from (y first)."""
    if isinstance(noise, torch.Generator):
        noise = {"y": noise, "z": noise}
    y_for_bit = add_noise(y_res, noise["y"])
    z_for_bit = add_noise(z, noise["z"])
    bits_y = get_y_bits(y_for_bit, scales_hat).sum(dim=(1, 2, 3))
    probs_z = bit_estimator_z.get_prob(z_for_bit, qp)
    bits_z = probs_to_bits(probs_z).sum(dim=(1, 2, 3))
    return bits_y, bits_z, (bits_y + bits_z) / pixel_num


# ------------------------------------------------------------------ loss

def get_mse_yuv_rgb(x, x_hat):
    """Per-channel YUV sums (B, 3) and the RGB sum (B,) of the squared
    error (reference get_mse_yuv_rgb); x, x_hat (B, H, W, 3) YCbCr."""
    mse_yuv = ((x - x_hat) ** 2).sum(dim=(1, 2))
    org_rgb = ycbcr2rgb(x, clamp=False)
    rec_rgb = ycbcr2rgb(x_hat, clamp=False)
    mse_rgb = ((org_rgb - rec_rgb) ** 2).sum(dim=(1, 2, 3))
    return mse_yuv, mse_rgb


def mse_weighted_average(mse_yuv, mse_rgb, pixel_num):
    """Log-domain YUV 10:1:1 geometric mix, 0.8/0.2 YUV/RGB blend
    (reference mse_weighted_average, layers.py:48-60)."""
    dtype = mse_yuv.dtype
    mse_yuv = mse_yuv.float() / pixel_num
    mse_rgb = mse_rgb.float() / pixel_num
    mse_y = torch.clamp_min(mse_yuv[:, 0], 1e-6)
    mse_u = torch.clamp_min(mse_yuv[:, 1], 1e-6)
    mse_v = torch.clamp_min(mse_yuv[:, 2], 1e-6)
    mix = torch.exp(0.0833 * (10 * torch.log(mse_y) + torch.log(mse_u)
                              + torch.log(mse_v))) * 3
    return (mix * 0.8 + mse_rgb * 0.2).to(dtype)


def get_mse(x, x_hat):
    mse_yuv, mse_rgb = get_mse_yuv_rgb(x, x_hat)
    return mse_weighted_average(mse_yuv, mse_rgb, x.shape[1] * x.shape[2])


def mse_8frames_sum(mse_list, dist_weights):
    """Chunk loss weighting [odd/even/last] (reference mse_8frames_sum)."""
    return ((mse_list[0] + mse_list[2] + mse_list[4] + mse_list[6]) * dist_weights[1]
            + (mse_list[1] + mse_list[3] + mse_list[5]) * dist_weights[2]
            + mse_list[7] * dist_weights[0])


def get_y_bits(y_noisy, scales_hat):
    return probs_to_bits(gaussian_prob_train(y_noisy, scales_hat))


def get_training_lambdas(lam_lo_hi, qp_num=QP_NUM):
    """Log-spaced lambda per QP (utils/common.py:184-187)."""
    return np.exp(np.linspace(np.log(lam_lo_hi[0]), np.log(lam_lo_hi[1]), qp_num))
