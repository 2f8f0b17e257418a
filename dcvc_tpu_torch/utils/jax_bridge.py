"""Weights of the JAX package's flax models -> state_dicts of the port.

The port names its parameters after the reference torch module tree, so
the key of each flax leaf is exactly what dcvc_tpu's checkpoint importer
maps it from (`key_fn_dmci` for DMCI and its blocks, `key_fn_dmc_ht` for
DMC-HT, `key_fn_dmc_ld` for DMC-LD; the port's verbatim copies in
utils/keys.py).  This inverts that
importer's leaf conversion: conv kernels (kh, kw, I, O) go back to
(O, I, kh, kw),
depthwise kernels (3, 3, 1, C) to (C, 1, 3, 3); every other leaf keeps
its shape.  A stacked recon leaf (StackedDCB, the recon head's out_w /
out_b) maps to one reference key per entry and is split on axis 0: 1x1
kernels (I, O) -> (O, I, 1, 1), the depthwise dc_dw_w (3, 3, I) ->
(I, 1, 3, 3), biases as they are.
"""

import numpy as np
import torch

from .keys import _stacked_leaf, key_fn_dmc_ht, key_fn_dmc_ld, \
    key_fn_dmci


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _tensor(arr):
    """One flax leaf -> the port's tensor (conv kernels transposed)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 4:  # (kh, kw, I, O) -> (O, I, kh, kw)
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(arr.copy())


def _split_stacked(name, arr):
    """A stacked leaf (S, ...) -> S per-entry tensors in torch layout."""
    arr = np.asarray(arr, np.float32)
    if name == "dc_dw_w":            # (S, 3, 3, I) -> (S, I, 1, 3, 3)
        arr = arr.transpose(0, 3, 1, 2)[:, :, None]
    elif arr.ndim == 3:              # (S, I, O) -> (S, O, I, 1, 1)
        arr = arr.transpose(0, 2, 1)[..., None, None]
    return [torch.from_numpy(a.copy()) for a in arr]


def dmci_params_from_jax(flax_params):
    """flax DMCI params (nested dict of arrays) -> {key: float32 tensor},
    the state_dict of dcvc_tpu_torch.models.dmci.DMCI (or of any of its
    blocks, given that block's flax params)."""
    return {key_fn_dmci(path): _tensor(leaf)
            for path, leaf in _leaves(flax_params)}


def dmc_ht_params_from_jax(flax_params, hts=True):
    """flax DMCHT params (both adaptor branches merged, as the JAX codec
    holds them) -> the state_dict of dcvc_tpu_torch.models.dmc_ht.DMCHT;
    hts=False for an HTL model (recon heads at `recon_head.conv.{i}`)."""
    state = {}
    for path, leaf in _leaves(flax_params):
        key = key_fn_dmc_ht(path, hts=hts)
        if isinstance(key, list):
            state.update(zip(key, _split_stacked(path[-1], leaf)))
        else:
            state[key] = _tensor(leaf)
    return state


def dmc_ld_params_from_jax(flax_params):
    """flax DMCLD params (both adaptor branches merged, as the JAX codec
    holds them) -> the state_dict of dcvc_tpu_torch.models.dmc_ld.DMCLD.
    LD has no stacked leaf: every leaf takes the conv / depthwise
    conversion."""
    return {key_fn_dmc_ld(path): _tensor(leaf)
            for path, leaf in _leaves(flax_params)}


def stacked_dcb_params_from_jax(flax_params):
    """flax StackedDCB params -> the state_dict of an nn.ModuleList of its
    S DepthConvBlocks (keys `{i}.dc.0.weight`, ...)."""
    state = {}
    for name, leaf in flax_params.items():
        sub, kind = _stacked_leaf(name)
        for i, t in enumerate(_split_stacked(name, leaf)):
            state[f"{i}.{sub}.{kind}"] = t
    return state
