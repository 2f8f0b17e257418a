"""Motion ops of the legacy DCVC family (counterpart of
dcvc_tpu/legacy/ops.py; reference torch_warp, DCVC-family/DCVC/src/
models/video_net.py:93-135, and DCVC-FM's block_mc), NHWC tensors.

flow_warp is the JAX arithmetic step by step (border clamp, floor, the
four corner gathers, the top / bottom rows blended in the same order),
not F.grid_sample, whose normalised coordinates land an ulp away: the
FM codec rounds y against means computed downstream of the warp.  The
resizes are F.interpolate's bilinear, align_corners=False, which at 2x
up and (antialias off) at 2x down is jax.image.resize's "linear".
"""

import torch
import torch.nn.functional as F


def flow_warp(im, flow):
    """Backward-warp im (B, H, W, C) by flow (B, H, W, 2), pixel
    displacements (dx, dy): bilinear, border padding, align_corners=True
    semantics.  The blend runs in float32; the result has im's dtype."""
    b, h, w, c = im.shape
    xs = torch.arange(w, dtype=torch.float32, device=im.device)[None, None]
    ys = torch.arange(h, dtype=torch.float32, device=im.device)[None, :,
                                                                 None]
    src_x = torch.clamp(xs + flow[..., 0].float(), 0.0, w - 1.0)
    src_y = torch.clamp(ys + flow[..., 1].float(), 0.0, h - 1.0)
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    flat = im.reshape(b, h * w, c)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    return (top * (1 - fy) + bot * fy).to(im.dtype)


def block_mc(feature, flow):
    """Motion compensation: flow_warp's sampling (the reference's CUDA
    block_mc kernel has the same semantics)."""
    return flow_warp(feature, flow)


def avg_pool_2x(x):
    """2x2 average pool, stride 2, of an NHWC tensor with even H, W."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _resize(x, h, w):
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def bilinear_upsample_2x(x):
    """2x bilinear upsample, align_corners=False (reference
    bilinearupsacling, video_net.py:151-156)."""
    return _resize(x, 2 * x.shape[1], 2 * x.shape[2])


def bilinear_downsample_2x(x):
    """(H // 2, W // 2) bilinear downsample, align_corners=False and no
    antialias filter (video_net.py:18-23; dcvc_tpu's
    legacy/dcvc_fm.py bilinear_downsample_2x)."""
    return _resize(x, x.shape[1] // 2, x.shape[2] // 2)
