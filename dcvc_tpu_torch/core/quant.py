"""Quantization primitives with straight-through / bounded gradients
(counterpart of dcvc_tpu/core/quant.py; reference QuantFunc / LowerBound,
src/layers/layers.py:63-89), as torch.autograd.Functions.
"""

import torch


class SteRound(torch.autograd.Function):
    """round() (half to even) with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or the upstream
    gradient is negative: it may push x back above the bound but never
    further below it."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def ste_round(x):
    return SteRound.apply(x)


def lower_bound(x, bound):
    """max(x, bound) with the reference's backward; `bound` a float."""
    return LowerBound.apply(x, float(bound))


def uniform_noise(shape, generator, device, dtype=torch.float32):
    """U(-0.5, 0.5) noise of `shape`, drawn from `generator` on its own
    device and moved to `device`."""
    noise = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=dtype)
    return (noise - 0.5).to(device)


def add_noise(x, noise):
    """x + U(-0.5, 0.5) noise, no gradient through the noise (reference
    CompressionModel.add_noise).  `noise`: a tensor of x's shape, or a
    torch.Generator to draw it from."""
    if isinstance(noise, torch.Generator):
        noise = uniform_noise(x.shape, noise, x.device, x.dtype)
    return x + noise.detach()


def z_to_int16(z):
    """round(z) clipped to +-30000, as int16 (the legacy z symbols)."""
    return torch.clamp(torch.round(z.float()), -30000, 30000).to(
        torch.int16)
