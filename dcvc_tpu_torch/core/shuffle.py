"""Pixel shuffle / unshuffle on NHWC tensors.

The channel order is torch's NCHW pixel_(un)shuffle order (output channel
c*r*r + i*r + j for unshuffle(r)), so both are F.pixel_(un)shuffle on an
NCHW view.
"""

import torch.nn.functional as F


def pixel_unshuffle(x, r):
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r)."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def pixel_shuffle(x, r):
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
