"""Weights of the JAX package's flax DMCI -> state_dicts of the port.

The port names its parameters after the reference torch module tree, so
the key of each flax leaf is exactly what dcvc_tpu's checkpoint importer
maps it from (`dcvc_tpu.utils.torch_import.key_fn_dmci` for DMCI and its
blocks).  This inverts that importer's leaf conversion: conv kernels
(kh, kw, I, O) go back to (O, I, kh, kw), depthwise kernels (3, 3, 1, C)
to (C, 1, 3, 3); every other leaf keeps its shape.

Only code that already holds flax parameters calls this (the parity
tests), so importing the key map from dcvc_tpu here loads nothing that
the caller has not loaded.
"""

import numpy as np
import torch


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def dmci_params_from_jax(flax_params):
    """flax DMCI params (nested dict of arrays) -> {key: float32 tensor},
    the state_dict of dcvc_tpu_torch.models.dmci.DMCI (or of any of its
    blocks, given that block's flax params)."""
    from dcvc_tpu.utils.torch_import import key_fn_dmci

    state = {}
    for path, leaf in _leaves(flax_params):
        arr = np.asarray(leaf, np.float32)
        if arr.ndim == 4:  # (kh, kw, I, O) -> (O, I, kh, kw)
            arr = arr.transpose(3, 2, 0, 1)
        state[key_fn_dmci(path)] = torch.from_numpy(arr.copy())
    return state
