"""Symbol compaction for the inference runtime (counterpart of
dcvc_tpu/runtime/symbols.py).

Compaction puts the coded candidates first, in candidate order, then the
skipped ones.  That order is the stream's symbol order.  The runtimes
compact without waiting for the device, as the JAX package does: the
indexes with one stable sort keyed on the skip flag (`compact_idx_sorted`),
the values by gathering them at the positions that sort returns
(`compact_vals_sorted`).  `compact_idx` and `compact_vals` give the same
results through a boolean-mask `nonzero` and boolean indexing, which wait
for the device; they are the plain forms the tests hold the sorted ones
against.  Expansion is a scatter by the carried positions.
"""

import torch


def compact_idx(idx_u8, cond):
    """Compact CDF indexes + original positions.

    idx_u8, cond: flat (N,).  Returns (packed_idx u8, packed_pos i32,
    count i32): the first `count` entries of packed_idx are the coded
    symbols' indexes in stable order; packed_pos[j] is entry j's original
    position (for ALL j, coded then skipped, stable)."""
    pos = torch.cat([torch.nonzero(cond).squeeze(1),
                     torch.nonzero(~cond).squeeze(1)])
    count = cond.sum(dtype=torch.int32)
    return idx_u8[pos], pos.to(torch.int32), count


def compact_idx_sorted(idx_u8, cond):
    """compact_idx without a host sync: one stable sort keyed on ~cond
    (dcvc_tpu/runtime/symbols.py:24-37).  Same results."""
    pos = torch.sort((~cond).to(torch.uint8), stable=True).indices
    count = cond.sum(dtype=torch.int32)
    return idx_u8.index_select(0, pos), pos.to(torch.int32), count


def compact_vals(vals, cond):
    """Compact a value buffer (same stable order as compact_idx)."""
    return torch.cat([vals[cond], vals[~cond]])


def compact_vals_sorted(vals, packed_pos):
    """compact_vals without a host sync: vals gathered at the positions
    compact_idx_sorted returned for the same cond.  Same result."""
    return vals.index_select(0, packed_pos)


def pack_symbols(y_q16, packed_idx):
    """The host coder's symbols: (y_q << 8) | CDF index, int16."""
    return (y_q16 << 8) | (packed_idx.to(torch.int16) & 0xFF)


def expand_from_pos(packed_pos, padded, n):
    """Place decoded symbols back on the candidate grid.

    packed_pos: (N,) permutation from compact_idx.  padded: (cap,) int8,
    decoded symbols in entries [0, count), zeros after.  Returns flat
    (N,) with decoded values at coded positions, zero elsewhere."""
    cap = padded.shape[0]
    if cap < n:
        padded = torch.cat([padded, padded.new_zeros(n - cap)])
    elif cap > n:
        padded = padded[:n]
    return torch.empty_like(padded).scatter_(0, packed_pos.long(), padded)


def quantize_candidate(y_c, means_c, cond):
    """Encoder-side candidate-domain quantization: round residual (half to
    even), zero where not coded, clamp to int8.
    y_c, means_c: (1, h2, w2, C); cond: flat (N,)."""
    y_q = torch.round(y_c.float() - means_c)
    y_q = torch.where(cond.reshape(y_q.shape), y_q, 0.0)
    return torch.clamp(y_q, -128.0, 127.0).to(torch.int8)
