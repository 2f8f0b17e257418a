"""DCVC-FM runtime helpers (counterpart of dcvc_tpu/runtime/fm_codec.py):
the candidate domain <-> the reference's dense CHW write order of the
legacy family's checkerboard and quadtree steps.

`cand_to_chw` and `chw_to_cand` are numpy and verbatim copies of the JAX
package's (whose module imports jax), pinned by tests/test_torch_evc.py.
The FM P-frame codec (DMCFMCodec) is not ported yet.
"""

import numpy as np


def cand_to_chw(cand, terms):
    """Candidate (H/2, W/2, sum-of-term-widths) -> the reference's dense
    CHW write order (Cw*H*W,), Cw = per-term channel width.

    Candidate channels are laid out SEQUENTIALLY in term order
    (core/masks.py phase_split); every spatial phase of the write grid is
    covered by exactly one term (combine_for_writing /
    compress_dual_prior write grids)."""
    h2, w2, c = cand.shape[-3:]
    cand = np.asarray(cand).reshape(h2, w2, c)
    cw = terms[0][2] - terms[0][1]
    out = np.empty((cw, 2 * h2, 2 * w2), cand.dtype)
    off = 0
    for ((py, px), lo, hi) in terms:
        n = hi - lo
        assert n == cw, "write-grid terms must share one channel width"
        out[:, py::2, px::2] = cand[:, :, off:off + n].transpose(2, 0, 1)
        off += n
    return out.reshape(-1)


def chw_to_cand(flat, terms, h2, w2, dtype=np.int16):
    """Inverse of cand_to_chw."""
    cw = terms[0][2] - terms[0][1]
    grid = np.asarray(flat, dtype).reshape(cw, 2 * h2, 2 * w2)
    cand = np.empty((h2, w2, cw * len(terms)), dtype)
    off = 0
    for ((py, px), lo, hi) in terms:
        cand[:, :, off:off + cw] = grid[:, py::2, px::2].transpose(1, 2, 0)
        off += cw
    return cand
