"""BT.709 color transforms (counterpart of dcvc_tpu/core/color.py;
reference src/utils/transforms.py).

The numpy functions the evaluation harness uses on the host are verbatim
copies of the JAX package's (pinned by tests/test_torch_core.py);
rgb2ycbcr and ycbcr2rgb are the torch forms of its jnp ones, for the
trainers' on-device conversion and the harness's RGB path.
"""

import numpy as np
import torch

# ITU-R BT.709 luma coefficients
KR, KG, KB = 0.2126, 0.7152, 0.0722


def rgb2ycbcr(rgb, clamp=True):
    """(..., 3) RGB in [0, 1] -> YCbCr in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1 - KB) + 0.5
    cr = 0.5 * (r - y) / (1 - KR) + 0.5
    out = torch.stack([y, cb, cr], dim=-1)
    if clamp:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def ycbcr2rgb(ycbcr, clamp=True):
    """(..., 3) YCbCr -> RGB; computed in f32 like the reference."""
    dtype = ycbcr.dtype
    ycbcr = ycbcr.float()
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    r = y + (2 - 2 * KR) * (cr - 0.5)
    b = y + (2 - 2 * KB) * (cb - 0.5)
    g = (y - KR * r - KB * b) / KG
    out = torch.stack([r, g, b], dim=-1)
    if clamp:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(dtype)


def rgb2ycbcr_np(rgb, quant=False):
    """Numpy HxWx3 RGB float -> YCbCr (reference rgb2ycbcr_np)."""
    r, g, b = np.split(rgb, 3, axis=2)
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1 - KB) + 0.5
    cr = 0.5 * (r - y) / (1 - KR) + 0.5
    ycbcr = np.concatenate((y, cb, cr), axis=2)
    ycbcr = np.clip(ycbcr, 0.0, 1.0)
    if quant:
        ycbcr = np.round(ycbcr * 255.0) / 255.0
    return ycbcr


def ycbcr420_to_444_np(y, uv, order=0):
    """y: (1,h,w), uv: (2,h/2,w/2) -> (3,h,w) via nearest (order=0) upsample.

    Matches reference ycbcr420_to_444_np (scipy.ndimage.zoom order=0 default).
    """
    if order == 0:
        uv = np.repeat(np.repeat(uv, 2, axis=1), 2, axis=2)
    else:
        import scipy.ndimage
        uv = scipy.ndimage.zoom(uv, (1, 2, 2), order=order)
    return np.concatenate((y, uv), axis=0)


def yuv_444_to_420_np(yuv):
    """Numpy (3,H,W) -> (y (1,H,W), uv (2,H/2,W/2)) via 2x2 average."""
    y = yuv[:1]
    uv = yuv[1:]
    c, h, w = uv.shape
    uv = uv.reshape(c, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    return y, uv
