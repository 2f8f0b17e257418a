"""Quadtree (4x) coding masks in the candidate domain, NHWC layout.

Every coding step of the 4-step quadtree prior selects, per channel
quarter, one 2x2 spatial phase (reference CompressionModel.get_mask_4x).
The runtime quantizes and entropy-codes in the packed "candidate domain"
(1, ceil(h/2), ceil(w/2), c): each term's phase subgrid, concatenated in
term order.  That order IS the symbol order of the stream.

`phase_terms_4x`, `phase_valid` and `terms_key` are numpy/pure Python and
are verbatim copies of `dcvc_tpu.core.masks` (whose package imports jax);
tests/test_torch_core.py pins them to the originals.  phase_split and
phase_merge are strided slices on the card.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def phase_terms_4x(c):
    """Per step: list of ((yo, xo), ch_lo, ch_hi) terms matching
    make_mask_4x.  Candidate shape per step: (1, h/2, w/2, c)."""
    assert c % 4 == 0
    q = c // 4
    orders = [(0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2)]
    return [
        [(_PHASES[order[g]], g * q, (g + 1) * q) for g in range(4)]
        for order in orders
    ]


def _pad_even(x):
    """Zero-pad an odd (h, w) grid to even; the padded lanes are excluded
    from coding by phase_valid() and cropped away by phase_merge()."""
    h, w = x.shape[1], x.shape[2]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return x


def phase_split(x, terms):
    """(1, h, w, c) -> candidate (1, ceil(h/2), ceil(w/2), sum(hi-lo)):
    each term's phase subgrid, concatenated in term order."""
    x = _pad_even(x)
    return torch.cat([x[:, yo::2, xo::2, lo:hi]
                      for ((yo, xo), lo, hi) in terms], dim=-1)


def phase_merge(xc, terms, c, out_h=None, out_w=None):
    """Inverse of phase_split: place candidate channels back at their
    (phase, channel-range) positions of the full (1, h, w, c) grid;
    positions not covered by any term are zero.  out_h/out_w crop the
    merged grid back to an odd size."""
    b, h2, w2 = xc.shape[0], xc.shape[1], xc.shape[2]
    out = xc.new_zeros((b, 2 * h2, 2 * w2, c))
    off = 0
    for ((yo, xo), lo, hi) in terms:
        out[:, yo::2, xo::2, lo:hi] = xc[..., off:off + hi - lo]
        off += hi - lo
    if out_h is not None and (out_h != 2 * h2 or out_w != 2 * w2):
        out = out[:, :out_h, :out_w, :]
    return out


@functools.lru_cache(maxsize=256)
def phase_valid(h, w, terms_key):
    """Flat bool (numpy) over the candidate domain of phase_split(x,
    terms) on an (h, w) grid: True where the candidate maps to a real
    grid position, False on the zero-padded even-ing row/col.  terms_key
    must be the tuple(terms) of the matching phase_split call.

    The runtimes AND this into the coding condition so odd grids emit
    exactly the reference's symbol set (mask generation at arbitrary
    sizes, common_model.py:95-100 crops the repeated micro mask to
    [:H, :W])."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    cols = []
    for ((yo, xo), lo, hi) in terms_key:
        vr = (yo + 2 * np.arange(h2)) < h
        vc = (xo + 2 * np.arange(w2)) < w
        v = vr[:, None] & vc[None, :]
        cols.append(np.repeat(v[:, :, None], hi - lo, 2))
    return np.concatenate(cols, axis=2).reshape(-1)


def terms_key(terms):
    """Hashable form of a phase-terms list (for phase_valid's cache)."""
    return tuple((tuple(ph), lo, hi) for (ph, lo, hi) in terms)
