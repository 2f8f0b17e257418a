"""Quadtree (4x) and checkerboard (2x) coding masks in the candidate
domain, NHWC layout.

Every coding step of the 4-step quadtree prior selects, per channel
quarter, one 2x2 spatial phase (reference CompressionModel.get_mask_4x);
each step of the 2-step checkerboard prior (DMC-LD) selects two opposite
phases per channel half (get_mask_2x).  The runtime quantizes and
entropy-codes in the packed "candidate domain" (1, ceil(h/2), ceil(w/2),
sum of the terms' channels): each term's phase subgrid, concatenated in
term order.  That order IS the symbol order of the stream.

`_phase_np`, `make_mask_2x`, `make_mask_4x` (the training masks),
`phase_terms_4x`, `phase_terms_2x`,
`phase_valid` and `terms_key` are numpy/pure Python and are verbatim
copies of `dcvc_tpu.core.masks` (whose package imports jax);
tests/test_torch_core.py pins them to the originals.  phase_split and
phase_merge are strided slices on the card.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _phase_np(h, w, yo, xo):
    """Boolean (h, w) grid true where (row % 2, col % 2) == (yo, xo)."""
    rows = (np.arange(h) % 2 == yo)[:, None]
    cols = (np.arange(w) % 2 == xo)[None, :]
    return rows & cols


@functools.lru_cache(maxsize=64)
def make_mask_2x(h, w, c):
    """Two checkerboard masks of shape (h, w, c).

    Channel halves use opposite phases; step 1 is the complement.
    Matches get_mask_2x: micro masks ((1,0),(0,1)) and ((0,1),(1,0)).
    """
    assert c % 2 == 0
    m0 = _phase_np(h, w, 0, 0) | _phase_np(h, w, 1, 1)   # ((1,0),(0,1))
    m1 = ~m0                                              # ((0,1),(1,0))
    half = c // 2
    mask_0 = np.concatenate([np.repeat(m0[:, :, None], half, 2),
                             np.repeat(m1[:, :, None], half, 2)], axis=2)
    mask_1 = ~mask_0
    # numpy (not jnp): these are cached; jnp arrays created during a jit
    # trace would leak tracers out of the cache.  numpy bools become
    # XLA constants at each use site.
    return mask_0, mask_1


@functools.lru_cache(maxsize=64)
def make_mask_4x(h, w, c):
    """Four quadtree masks of shape (h, w, c).

    Channel quarters get the four 2x2 phases, rotated per step exactly as
    get_mask_4x: step patterns over channel groups are
      step0: (m0, m1, m2, m3)
      step1: (m3, m2, m1, m0)
      step2: (m2, m3, m0, m1)
      step3: (m1, m0, m3, m2)
    where m0..m3 select the TL, TR, BL, BR pixel of each 2x2 block.
    """
    assert c % 4 == 0
    q = c // 4
    m = [_phase_np(h, w, 0, 0), _phase_np(h, w, 0, 1),
         _phase_np(h, w, 1, 0), _phase_np(h, w, 1, 1)]
    orders = [(0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2)]
    masks = []
    for order in orders:
        groups = [np.repeat(m[g][:, :, None], q, 2) for g in order]
        masks.append(np.concatenate(groups, axis=2))
    return tuple(masks)


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


def phase_terms_2x(c):
    """Per step: terms matching make_mask_2x.  Each channel half has two
    phases; candidate shape per step: (1, h/2, w/2, 2c)."""
    assert c % 2 == 0
    half = c // 2
    t0 = [((0, 0), 0, half), ((1, 1), 0, half),
          ((0, 1), half, c), ((1, 0), half, c)]
    t1 = [((0, 1), 0, half), ((1, 0), 0, half),
          ((0, 0), half, c), ((1, 1), half, c)]
    return [t0, t1]


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
