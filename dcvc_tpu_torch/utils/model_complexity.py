"""Model complexity accounting (counterpart of dcvc_tpu/utils/
model_complexity.py, the role of the reference EVC model_complexity.py
MACs counter).

count_macs runs fn(*args) under torch.utils.flop_counter.FlopCounterMode
and returns its FLOPs / 2.  FlopCounterMode counts only the operators it
has formulas for: matrix products and convolutions (forward and, if the
call runs one, backward).  The JAX package reads XLA's cost analysis,
which counts elementwise work (activations, adds, the rounding) as well,
so its numbers are larger for the same model; the two are not converted
into each other.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.common import draw_noise
from ..models.dmci import DMCI


def count_macs(fn, *args):
    """Multiply-accumulates of fn(*args): FlopCounterMode's FLOPs / 2."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops() // 2


def _fm_inputs(model, h, w, device):
    """DCVC-FM's eval forward at (h, w): a later P frame (the DPB full:
    the previous frame, its feature, mv feature and both latents), q_index
    0, fa_idx 1 (DCVC-DC's: anchor 0, frame 1), the rates of the rounded
    latents."""
    cfg, z = model.cfg, torch.zeros
    dpb = {"ref_frame": z(1, h, w, 3, device=device),
           "ref_feature": z(1, h, w, cfg.ch_1x, device=device),
           "ref_mv_feature": z(1, h // 4, w // 4, cfg.ch_mv, device=device),
           "ref_y": z(1, h // 16, w // 16, cfg.ch_16x, device=device),
           "ref_mv_y": z(1, h // 16, w // 16, cfg.ch_mv, device=device)}
    return (z(1, h, w, 3, device=device), dpb, 0, 1)


def _hem_inputs(model, h, w, device):
    """DCVC-HEM's eval forward at (h, w): a later P frame (the DPB full:
    the previous frame, its feature and both latents), q scales 1, the
    rates of the rounded latents."""
    cfg, z = model.cfg, torch.zeros
    dpb = {"ref_frame": z(1, h, w, 3, device=device),
           "ref_feature": z(1, h, w, cfg.ch_n, device=device),
           "ref_y": z(1, h // 16, w // 16, cfg.ch_m, device=device),
           "ref_mv_y": z(1, h // 16, w // 16, cfg.ch_mv, device=device)}
    one = torch.ones((), device=device)
    return (z(1, h, w, 3, device=device), dpb, one, one)


def _inputs(model, h, w, device):
    """A training forward's inputs at (h, w): the frame (a chunk of
    frame_delay frames for a video model, a later chunk: the previous
    feature and memory given), qp 0 and its noise."""
    from ..legacy.compressai_zoo import Cheng2020Anchor, ScaleHyperprior
    from ..legacy.dcvc_fm import DMCFM
    from ..legacy.dcvc_hem import DMCHEM
    from ..legacy.dcvc_net import DCVCNet
    from ..legacy.dcvc_tcm import DMCTCM
    if isinstance(model, DMCFM):        # DMCDC too: the same arguments
        return _fm_inputs(model, h, w, device)
    if isinstance(model, DMCHEM):
        return _hem_inputs(model, h, w, device)
    frame = torch.zeros(1, h, w, 3, device=device)
    if isinstance(model, DCVCNet):      # (reference, current frame)
        return (frame, frame)
    if isinstance(model, DMCTCM):       # a later P frame: its feature given
        return (frame, frame, torch.zeros(1, h, w, model.cfg.ch_n,
                                          device=device))
    if isinstance(model, (ScaleHyperprior, Cheng2020Anchor)):
        return (frame,)
    cfg = model.cfg
    noise = draw_noise(cfg, 1, h, w, torch.Generator().manual_seed(0),
                       device)
    if isinstance(model, DMCI):
        return (torch.zeros(1, h, w, 3, device=device), 0, noise)
    zeros = torch.zeros
    return (zeros(1, h, w, 3 * cfg.frame_delay, device=device),
            zeros(1, h // 8, w // 8, cfg.ch_d, device=device),
            zeros(1, h // 8, w // 8, cfg.ch_m, device=device), 0, noise)


def model_macs_per_pixel(model, h=256, w=256):
    """kMACs per pixel of the training forward of a port DMCI, DMCHT or
    DMCLD (float32) at (h, w), rounded up to multiples of 64 as the
    training forward needs; per pixel of each of its frames (a video
    chunk codes frame_delay of them).  DCVC-FM's, DCVC-DC's and
    DCVC-HEM's (DMCFM, DMCDC, DMCHEM): the eval forward of a later P
    frame, one frame; DCVC-2021's (DCVCNet) its eval forward of a P frame,
    DCVC-TCM's (DMCTCM) its training forward of a later P frame, the
    CompressAI models' (ScaleHyperprior, Cheng2020Anchor) their
    estimation forward of an image."""
    h, w = -(-h // 64) * 64, -(-w // 64) * 64
    device = next(model.parameters()).device
    args = _inputs(model, h, w, device)
    # no autograd graph; FlopCounterMode's module hooks refuse no_grad
    wants = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        macs = count_macs(model, *args)
    finally:
        for p, want in zip(model.parameters(), wants):
            p.requires_grad_(want)
    frames = getattr(model.cfg, "frame_delay", 1)
    return macs / (h * w * frames) / 1000.0


def summarize(model, resolutions=((256, 256), (1080, 1920))):
    """Human-readable complexity summary across resolutions."""
    lines = []
    for h, w in resolutions:
        kmacs = model_macs_per_pixel(model, h, w)
        lines.append(f"{h}x{w}: {kmacs:.1f} kMACs/pixel")
    return "\n".join(lines)
