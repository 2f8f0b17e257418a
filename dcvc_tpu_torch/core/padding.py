"""Padding helpers (reference CompressionModel.get_padding_size and the
replicate pad of the latent before the hyper path)."""

import torch.nn.functional as F


def get_padding_size(height, width, p=64):
    """Right/bottom padding that rounds H, W up to a multiple of p."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_w - width, new_h - height  # (padding_right, padding_bottom)


def pad_replicate_nhwc(x, pad_b, pad_r):
    """Edge-replicate pad on the bottom/right of an NHWC tensor."""
    if pad_b == 0 and pad_r == 0:
        return x
    out = F.pad(x.permute(0, 3, 1, 2), (0, pad_r, 0, pad_b), mode="replicate")
    return out.permute(0, 2, 3, 1)


def pad_for_y(y, p=4):
    """Replicate-pad an odd/unaligned latent up to a multiple of `p` before
    the stride-2 hyper path; the hyper output is cropped back to the y grid."""
    pad_r, pad_b = get_padding_size(y.shape[1], y.shape[2], p)
    return pad_replicate_nhwc(y, pad_b, pad_r)
