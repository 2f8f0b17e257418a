"""The spatial split of DMCI's transforms along H (counterpart of
dcvc_tpu/parallel/spatial.py and DMCICodec's `spatial_mesh`,
dcvc_tpu/runtime/image_codec.py): for frames too large for one card's
latency budget, the analysis and the synthesis run as row tiles, tile i
on devices[i] (on one card every entry is cuda:0).  Everything else stays
whole on the codec's device: the priors, quantisation, the symbol
decisions, rANS and K2.

Each tile is the frame's rows it owns (its core) plus a halo on either
side, clamped to the frame; the transforms run on the tile as on a frame,
and the core's rows of the result are kept.  The halo covers the
transform's receptive field, which `receptive_radius` derives from the
module tree (each DepthConvBlock's depthwise 3x3, each 3x3 conv, and the
strides of the pixel (un)shuffles), so a core row sees the same inputs as
in the whole frame: the zero padding of the tile's convolutions lies
outside every core row's field.  The analysis' tiles start on the z grid
(64 pixels: the pixel unshuffle by 8, the stride-2 conv and the hyper
encoder's two stride-2 blocks), and its halo is rounded up to that grid;
the frame's edge pad to 16 is applied before the split, so the last
tile's replicate pad of y (pad_for_y) is the whole frame's.  Every tile
is contiguous (K1 takes contiguous batch-1 tensors).

The tiles' rows are the whole frame's up to the rounding of the
convolutions, which may sum in another order on another shape: the split
codec's own encode -> decode is bit-exact (both sides run the same
tiles), its streams decode on the unsplit codec and the other way round
(the decisions are computed whole, from the same z), but its streams
need not equal the unsplit codec's byte for byte (dcvc_tpu's contract,
tests/test_spatial_stream.py).  A per-conv halo exchange, as GSPMD
inserts it, would compute no row twice; this form recomputes each halo.
"""

import copy
import math
from fractions import Fraction

import torch
import torch.nn as nn

from ..layers.blocks import Conv1x1, Conv3x3, DepthConvBlock, \
    ResidualBlockUpsample, ResidualBlockWithStride2, SubpelConv2x
from ..models.dmci import IntraDecoder, IntraEncoder, IntraHyperEncoder


def spatial_ops(module):
    """The ops of `module`'s forward that reach across rows, in order:
    ("conv", k, s) a k x k conv of stride s (a DepthConvBlock's depthwise
    3x3 is one), ("down", r) a pixel unshuffle by r, ("up", r) a pixel
    shuffle by r.  1x1 convs and pointwise ops reach no other row."""
    if isinstance(module, nn.Sequential):
        return [op for m in module for op in spatial_ops(m)]
    if isinstance(module, DepthConvBlock):
        return [("conv", 3, 1)]
    if isinstance(module, Conv3x3):
        return [("conv", 3, module.stride)]
    if isinstance(module, Conv1x1):
        return []
    if isinstance(module, SubpelConv2x):
        return spatial_ops(module.conv) + [("up", 2)]
    if isinstance(module, ResidualBlockUpsample):
        return spatial_ops(module.up) + spatial_ops(module.conv)
    if isinstance(module, ResidualBlockWithStride2):
        return [("down", 2)] + spatial_ops(module.conv)
    if isinstance(module, IntraEncoder):
        return [("down", 8)] + spatial_ops(module.enc_1) \
            + spatial_ops(module.enc_2)
    if isinstance(module, IntraHyperEncoder):
        return spatial_ops(module.conv)
    if isinstance(module, IntraDecoder):
        return spatial_ops(module.dec_1) + spatial_ops(module.dec_2) \
            + [("up", 8)]
    raise TypeError(f"no spatial rule for {type(module).__name__}")


def receptive_radius(ops):
    """(radius, stride) of a chain of spatial_ops: an output row o depends
    on input rows within `radius` of the block [o * stride, (o + 1) *
    stride), in input rows (Fractions: a shuffle makes the stride
    fractional)."""
    radius, jump = Fraction(0), Fraction(1)
    for kind, *arg in ops:
        if kind == "conv":
            k, s = arg
            radius += (k // 2) * jump
            jump *= s
        elif kind == "down":
            jump *= arg[0]
        else:
            jump /= arg[0]
    return radius, jump


def analysis_geometry(model):
    """(align, halo) of DMCI's analysis in pixels: tiles start on the z
    grid (align, the encoder's and hyper encoder's total stride) and the
    halo is the z rows' receptive radius rounded up to that grid."""
    radius, align = receptive_radius(spatial_ops(model.enc)
                                     + spatial_ops(model.hyper_enc))
    align = int(align)
    return align, int(math.ceil(radius / align)) * align


def synthesis_halo(model):
    """The synthesis' halo in y rows: the receptive radius of its output
    rows in y rows, rounded up."""
    radius, _ = receptive_radius(spatial_ops(model.dec))
    return int(math.ceil(radius))


def split_rows(n, tiles):
    """[lo, hi) of `tiles` nearly equal parts of n rows (the larger
    first)."""
    if not 1 <= tiles <= n:
        raise ValueError(f"{tiles} tiles of {n} rows")
    base, extra = divmod(n, tiles)
    bounds, lo = [], 0
    for i in range(tiles):
        hi = lo + base + (i < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def analysis_tiles(ph, n, align, halo):
    """The analysis' tiles of a frame padded to ph rows: (x_lo, x_hi,
    z_lo, z_hi) with the tile's pixel rows and the z rows it owns."""
    yh = ph // 16
    zh = (yh + 3) // 4
    return [(max(0, align * lo - halo), min(ph, align * hi + halo), lo, hi)
            for lo, hi in split_rows(zh, n)]


def synthesis_tiles(yh, n, halo):
    """The synthesis' tiles of a y grid of yh rows: (y_lo, y_hi, lo, hi)
    with the tile's y rows and the y rows it owns."""
    return [(max(0, lo - halo), min(yh, hi + halo), lo, hi)
            for lo, hi in split_rows(yh, n)]


def run_row_tiles(fn, x, tiles, halo, devices=None):
    """fn (a stride-1 NHWC transform whose receptive radius is `halo`
    rows) of x in `tiles` row tiles, tile i on devices[i] (x's device when
    None): the counterpart of dcvc_tpu's run_spatially_sharded."""
    parts = []
    for i, (lo, hi) in enumerate(split_rows(x.shape[1], tiles)):
        t_lo, t_hi = max(0, lo - halo), min(x.shape[1], hi + halo)
        dev = devices[i] if devices else x.device
        out = fn(x[:, t_lo:t_hi].to(dev).contiguous())
        parts.append(out[:, lo - t_lo:hi - t_lo].to(x.device))
    return torch.cat(parts, dim=1)


def _indexed(device):
    """`device` with its index (cuda -> cuda:<current>), so that equal
    devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SpatialSplit:
    """DMCI's analysis and synthesis split along H over `devices` (one
    tile each), the model replicated to every device it is not on."""

    def __init__(self, model, devices):
        if not devices:
            raise ValueError("spatial split: no devices")
        self.devices = [_indexed(d) for d in devices]
        home = next(model.parameters()).device
        self.replicas = {}
        for d in self.devices:
            if d not in self.replicas:
                self.replicas[d] = model if d == home else \
                    copy.deepcopy(model).to(d)
        self.align, self.halo = analysis_geometry(model)
        self.syn_halo = synthesis_halo(model)

    def analysis(self, x, qp):
        """DMCI.analysis of x (1, ph, pw, 3), the frame already padded to
        16, in row tiles; returns (y_scaled, z_int8) on x's device."""
        ph = x.shape[1]
        ys, zs = [], []
        for dev, (x_lo, x_hi, lo, hi) in zip(self.devices, analysis_tiles(
                ph, len(self.devices), self.align, self.halo)):
            tile = x[:, x_lo:x_hi].to(dev).contiguous()
            y, z = self.replicas[dev].analysis(tile, qp)
            z0 = x_lo // self.align
            y0, y1 = 4 * lo - x_lo // 16, min(4 * hi, ph // 16) - x_lo // 16
            ys.append(y[:, y0:y1].to(x.device))
            zs.append(z[:, lo - z0:hi - z0].to(x.device))
        return torch.cat(ys, dim=1), torch.cat(zs, dim=1)

    def synthesis(self, y_hat, qp, out_h, out_w):
        """DMCI.synthesis of y_hat (1, yh, yw, C) in row tiles, cropped to
        (out_h, out_w), on y_hat's device."""
        yh = y_hat.shape[1]
        parts = []
        for dev, (y_lo, y_hi, lo, hi) in zip(self.devices, synthesis_tiles(
                yh, len(self.devices), self.syn_halo)):
            tile = y_hat[:, y_lo:y_hi].to(dev).contiguous()
            x = self.replicas[dev].synthesis(tile, qp, 16 * (y_hi - y_lo),
                                             out_w)
            parts.append(x[:, 16 * (lo - y_lo):16 * (hi - y_lo)]
                         .to(y_hat.device))
        return torch.cat(parts, dim=1)[:, :out_h]
