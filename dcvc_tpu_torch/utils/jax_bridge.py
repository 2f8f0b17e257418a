"""Weights of the JAX package's flax models -> state_dicts of the port.

The port names its parameters after the reference torch module tree, so
the key of each flax leaf is exactly what dcvc_tpu's checkpoint importer
maps it from (`key_fn_dmci` for DMCI, its blocks and the DCVC-RT intra
model, `key_fn_dmc_ht` for DMC-HT, `key_fn_dmc_ld` for DMC-LD, `key_fn_rt`
for the DCVC-RT P model, whose z prior keeps the port's h / b / a banks;
the port's verbatim copies in utils/keys.py).  This inverts that
importer's leaf conversion: conv kernels (kh, kw, I, O) go back to
(O, I, kh, kw),
depthwise kernels (3, 3, 1, C) to (C, 1, 3, 3); every other leaf keeps
its shape.  A stacked recon leaf (StackedDCB, the recon head's out_w /
out_b) maps to one reference key per entry and is split on axis 0: 1x1
kernels (I, O) -> (O, I, 1, 1), the depthwise dc_dw_w (3, 3, I) ->
(I, 1, 3, 3), biases as they are.

The other way, dmci_params_to_jax / dmc_ht_params_to_jax /
dmc_ld_params_to_jax turn a port state_dict into the flax tree (keys
sorted at every level, as jax.tree.map leaves them, so that a tree the
JAX package wrote comes back in its own order).  Each reference key is
parsed back into its flax path (`_flax_path`: a DepthConvBlock's parts,
SubpelConv2x, the strided conv, each model's numbered scopes, the bare
conv scope of a plain conv), and the importer's map must give the key
back from that path, or it raises; the HT recon head's per-frame keys
are stacked back into their StackedDCB leaves.  load_native_into /
save_native move a port model to and from a dcvc_tpu.params.v1 file
(utils/checkpoint.py), its config in the header.

The legacy models: EVC's modules are named after key_fn_evc's keys
(evc_params_from_jax; evc_params_to_jax parses them back,
`_evc_flax_path`), IntraNoAR's, DCVC-FM's, DCVC-DC's and DCVC-HEM's
mirror the flax tree (intra_noar_params_from_jax / _to_jax, and its
aliases fm_, dc_ and hem_params_from_jax / _to_jax: the scopes joined
by '.').  Their leaves convert by name: a conv
`kernel` as above, a Dense `kernel` (I, O) to nn.Linear's (O, I), and
q_basic (1, 1, 1, N), FM's q anchors (2, 1, 1, 1) and its grouped fusion
kernel (g, I, O) keep their shapes.  DCVC-2021's and the CompressAI
codecs' and DCVC-TCM's modules mirror the flax tree too
(dcvc_params_from_jax / _to_jax, compressai_params_from_jax / _to_jax,
tcm_params_from_jax / _to_jax), with one more leaf kind: a flax
ConvTranspose kernel (kh, kw, I, O) is ConvTranspose2d's weight (I, O,
kh, kw) flipped in space, where the reference key map tags the leaf
"deconv"; a CompressAI codec's file is the JAX codec's {"params",
"eb_params"} tree, its EntropyBottleneck at `entropy_bottleneck.*` in the
port's state_dict.
"""

import numpy as np
import torch

from .checkpoint import PARAMS_V1, checkpoint_format, config_from_header, \
    load_header, load_params, load_reference_into, save_params
from .keys import _LD_SEQ_TOPS, _STACKED_SUB, _stacked_leaf, \
    key_fn_cheng2020, key_fn_dcvc, key_fn_dmc_ht, key_fn_dmc_ld, \
    key_fn_dmci, key_fn_evc, key_fn_hyperprior, key_fn_rt, key_fn_tcm


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _f32(arr):
    """A flax leaf (numpy / jax array, or a tensor read from a params.v1
    file, bfloat16 included) as a float32 numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().numpy()
    return np.asarray(arr, np.float32)


def _tensor(arr):
    """One flax leaf -> the port's tensor (conv kernels transposed)."""
    arr = _f32(arr)
    if arr.ndim == 4:  # (kh, kw, I, O) -> (O, I, kh, kw)
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(arr.copy())


def _split_stacked(name, arr):
    """A stacked leaf (S, ...) -> S per-entry tensors in torch layout."""
    arr = _f32(arr)
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


def rt_key(path):
    """key_fn_rt's reference key of a flax DMCRT path, but the port's own
    `bit_estimator_z.{h,b,a}` for the z prior's banks (key_fn_rt names the
    reference's per-layer Bitparm tensors they are stacked from)."""
    key = key_fn_rt(path)
    return ".".join(path) if isinstance(key, tuple) else key


def dmc_rt_params_from_jax(flax_params):
    """flax DMCRT params (both adaptor branches merged, as the JAX codec
    holds them) -> the state_dict of dcvc_tpu_torch.legacy.dcvc_rt.DMCRT.
    Every leaf takes the conv / depthwise conversion (the 2x2 stride-2
    kernels too)."""
    return {rt_key(path): _tensor(leaf)
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


# ------------------------------------------------------------- the inverse

_DCB_PARTS = {("dc", "0"): "dc_in", ("dc", "2"): "dc_dw",
              ("dc", "3"): "dc_out", ("ffn", "0"): "ffn_in",
              ("ffn", "2"): "ffn_out"}
_STACKED_NAME = {v: k for k, v in _STACKED_SUB.items()}


def _numbered_dmci(out, name, n):
    if name == "conv":
        return f"conv_{n}"
    if name == "enc_2":
        return "enc_2_down" if n == "6" else f"enc_2_{n}"
    if name == "dec_1":
        return "dec_1_up" if n == "0" else f"dec_1_{int(n) - 1}"
    return None


def _numbered_dmc_ht(out, name, n):
    return f"{name}_{n}" if name in ("conv", "conv1", "conv2") else None


def _numbered_dmc_ld(out, name, n):
    if name == "conv" and out and out[-1] in _LD_SEQ_TOPS:
        return f"layers_{n}"
    return f"{name}_{n}" if name in ("conv", "conv1") else None


def _flax_path(key, numbered):
    """Reference key -> flax param path (tuple of str), the inverse of
    keys._translate; numbered(out, name, n) names the flax scope of a
    `name.n` pair that is not a DepthConvBlock part (None: not one)."""
    segs = key.split(".")
    leaf = {"weight": "kernel"}.get(segs[-1], segs[-1])
    segs = segs[:-1]
    out, i = [], 0
    while i < len(segs):
        s = segs[i]
        nxt = segs[i + 1] if i + 1 < len(segs) else None
        if (s, nxt) in _DCB_PARTS:
            out += [_DCB_PARTS[(s, nxt)], "conv"]
            i += 2
        elif s in ("adaptor", "down"):
            out += [s, "conv"]
            i += 1
        elif s == "up" and segs[i + 1:i + 3] == ["conv", "0"]:
            out += ["up", "conv"]
            i += 3
        elif nxt is not None and nxt.isdigit() and \
                numbered(out, s, nxt) is not None:
            out.append(numbered(out, s, nxt))
            i += 2
        else:
            out.append(s)
            i += 1
    if leaf in ("kernel", "bias") and (not out or out[-1] != "conv"):
        out.append("conv")       # a plain conv's own scope
    return tuple(out) + (leaf,)


def _flax_leaf(t):
    """The port's tensor -> its flax leaf (conv kernels (O, I, kh, kw) ->
    (kh, kw, I, O)), in its own dtype, on the CPU."""
    t = t.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return t.contiguous()


def _stack_leaf(name, tensors):
    """The inverse of _split_stacked: S per-entry tensors -> one stacked
    leaf."""
    t = torch.stack([x.detach().cpu() for x in tensors])
    if name == "dc_dw_w":            # (S, I, 1, 3, 3) -> (S, 3, 3, I)
        t = t[:, :, 0].permute(0, 2, 3, 1)
    elif t.dim() == 5:               # (S, O, I, 1, 1) -> (S, I, O)
        t = t[..., 0, 0].transpose(1, 2)
    return t.contiguous()


def _nest(items):
    """{path: leaf} -> nested dicts, keys sorted at every level."""
    tree = {}
    for path, leaf in items.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = leaf

    def ordered(node):
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node)}
    return ordered(tree)


def _to_jax(state, numbered, key_fn, rename=None):
    """state_dict -> flax tree for a model without stacked leaves; each
    path checked against the importer's key map.  rename(key): the key
    to parse, where the importer's map adds a scope of its own."""
    items = {}
    for key, t in state.items():
        path = _flax_path(rename(key) if rename else key, numbered)
        if key_fn(path) != key:
            raise KeyError(f"{key}: no flax path maps to it (tried "
                           f"{'/'.join(path)})")
        items[path] = _flax_leaf(t)
    return _nest(items)


def dmci_params_to_jax(state):
    """The state_dict of a port DMCI (or of one of its blocks) -> the
    flax DMCI params, the inverse of dmci_params_from_jax."""
    return _to_jax(state, _numbered_dmci, key_fn_dmci)


_LD_TPE = "temporal_prior_encoder.conv."


def dmc_ld_params_to_jax(state):
    """The state_dict of a port DMCLD -> the flax DMCLD params (both
    adaptor branches), the inverse of dmc_ld_params_from_jax."""
    def rename(key):
        # the reference wraps the temporal prior encoder's RBWS2 in `conv`
        if key.startswith(_LD_TPE):
            return "temporal_prior_encoder." + key[len(_LD_TPE):]
        return key
    return _to_jax(state, _numbered_dmc_ld, key_fn_dmc_ld, rename)


def _numbered_rt(out, name, n):
    if name in ("conv1", "conv2"):
        return f"{name}_{n}"
    if name == "conv":
        # the recon net's blocks are a list attribute, the rest nn.Sequential
        return (f"conv_{n}" if out and out[-1] == "recon_generation_net"
                else f"layers_{n}")
    return None


def dmc_rt_params_to_jax(state):
    """The state_dict of a port DMCRT -> the flax DMCRT params (both
    adaptor branches), the inverse of dmc_rt_params_from_jax.  RT's
    ResidualBlockWithStride2 holds its 2x2 conv bare (`.../down/kernel`);
    the encoder's strided 3x3 is a wrapped conv (`encoder/down/conv`)."""
    items = {}
    for key, t in state.items():
        path = _flax_path(key, _numbered_rt)
        if "down" in path and not key.startswith("encoder.down."):
            i = path.index("down")
            path = path[:i + 1] + path[i + 2:]
        if rt_key(path) != key:
            raise KeyError(f"{key}: no flax path maps to it (tried "
                           f"{'/'.join(path)})")
        items[path] = _flax_leaf(t)
    return _nest(items)


def dmc_ht_params_to_jax(state, hts=True):
    """The state_dict of a port DMCHT -> the flax DMCHT params (both
    adaptor branches), the inverse of dmc_ht_params_from_jax; hts=False
    for an HTL model.  The recon head's per-frame keys (`recon_head.
    conv1.{i}.{j}...` trunk, `conv2` / HTL `conv` heads, the heads' last
    1x1 as out_w / out_b) are stacked over i."""
    coll = "conv2" if hts else "conv"
    items, stacked = {}, {}
    for key, t in state.items():
        segs = key.split(".")
        if segs[0] != "recon_head":
            path = _flax_path(key, _numbered_dmc_ht)
            if key_fn_dmc_ht(path, hts=hts) != key:
                raise KeyError(f"{key}: no flax path maps to it (tried "
                               f"{'/'.join(path)})")
            items[path] = _flax_leaf(t)
            continue
        trunk = hts and segs[1] == "conv1"
        if segs[1] not in ("conv1", coll) or (segs[1] == "conv1"
                                              and not hts):
            raise KeyError(f"{key}: not a recon head key of "
                           f"{'HTS' if hts else 'HTL'}")
        i, j, rest = int(segs[2]), segs[3], segs[4:]
        suffix = {"weight": "w", "bias": "b"}[rest[-1]]
        if len(rest) == 1:               # the head's last 1x1
            path = ("recon_head", f"out_{suffix}")
        else:
            name = _STACKED_NAME[".".join(rest[:-1])]
            path = ("recon_head", f"{'trunk' if trunk else 'heads'}_{j}",
                    f"{name}_{suffix}")
        stacked.setdefault(path, {})[i] = (key, t)
    frame_delay = 1 + max((i for p, e in stacked.items()
                           if "trunk" not in p[1] for i in e), default=-1)
    for path, entries in stacked.items():
        keys = key_fn_dmc_ht(path, frame_delay, hts)
        got = [entries[i][0] if i in entries else None
               for i in range(len(keys))]
        if got != keys or len(entries) != len(keys):
            raise KeyError(f"recon head leaf {'/'.join(path)}: keys {got}, "
                           f"expected {keys}")
        items[path] = _stack_leaf(path[-1], [entries[i][1]
                                             for i in range(len(keys))])
    return _nest(items)


# ------------------------------------------------- EVC and IntraNoAR

def _legacy_tensor(path, leaf):
    """A flax leaf of a legacy intra model -> the port's tensor: a conv
    `kernel` (kh, kw, I, O) -> (O, I, kh, kw), a Dense `kernel` (I, O) ->
    nn.Linear's (O, I); every other leaf (biases, q_basic (1, 1, 1, N),
    q_scale, the z prior's banks) as it is."""
    arr = _f32(leaf)
    if path[-1] == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return torch.from_numpy(arr.copy())


def _legacy_leaf(key, t):
    """The inverse of _legacy_tensor, in the tensor's own dtype."""
    t = t.detach().cpu()
    if key.endswith(".weight"):
        t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
    return t.contiguous()


def _mirror_key(path):
    """A flax path -> the key of a port module that mirrors the flax tree
    (legacy/fm_layers.py): the scopes joined by '.', `kernel` as
    `weight`."""
    return ".".join(path[:-1] + ({"kernel": "weight"}.get(path[-1],
                                                        path[-1]),))


def intra_noar_params_from_jax(flax_params):
    """flax IntraNoAR params -> the state_dict of
    dcvc_tpu_torch.legacy.hem_intra.IntraNoAR, whose modules mirror the
    flax tree (the JAX package has no reference key map for it)."""
    return {_mirror_key(path): _legacy_tensor(path, leaf)
            for path, leaf in _leaves(flax_params)}


def intra_noar_params_to_jax(state):
    """The state_dict of a port IntraNoAR -> the flax IntraNoAR params,
    the inverse of intra_noar_params_from_jax."""
    items = {}
    for key, t in state.items():
        segs = key.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        items[path] = _legacy_leaf(key, t)
    return _nest(items)


# DCVC-FM's modules mirror the flax tree as IntraNoAR's do (legacy/
# dcvc_fm.py): the same conversion, OffsetDiversity's grouped fusion
# kernel (g, I, O) and the q anchors (2, 1, 1, 1) kept as they are
fm_params_from_jax = intra_noar_params_from_jax
fm_params_to_jax = intra_noar_params_to_jax
# so do DCVC-DC's (legacy/dcvc_dc.py, the three feature adaptors under
# their flax names feature_adaptor_{0,1,2}) and DCVC-HEM's (legacy/
# dcvc_hem.py, its SE layers' Dense kernels as nn.Linear weights)
dc_params_from_jax = intra_noar_params_from_jax
dc_params_to_jax = intra_noar_params_to_jax
hem_params_from_jax = intra_noar_params_from_jax
hem_params_to_jax = intra_noar_params_to_jax


def evc_key(path):
    """key_fn_evc's reference key of a flax EVC path, but the port's own
    `bit_estimator_z.{h,b,a}` for the z prior's banks (key_fn_evc names
    the reference's per-layer Bitparm tensors they are stacked from)."""
    key = key_fn_evc(path)
    return ".".join(path) if isinstance(key, tuple) else key


def evc_params_from_jax(flax_params):
    """flax EVC params -> the state_dict of dcvc_tpu_torch.legacy.evc.EVC,
    whose modules are named after key_fn_evc's keys."""
    return {evc_key(path): _legacy_tensor(path, leaf)
            for path, leaf in _leaves(flax_params)}


# the dc parts of EVCDepthConv (enc / dec / encs_i blocks) that are a
# bare nn.Conv scope in flax; every other conv there is a ConvK (`/conv`)
_EVC_BARE_DC = ("conv1", "depth_conv")


def _evc_flax_path(key):
    """A key of the port's EVC -> its flax path, the inverse of
    key_fn_evc (checked against it by the caller)."""
    segs = key.split(".")
    if len(segs) == 1 or segs[0] == "bit_estimator_z":
        return tuple(segs)
    leaf = {"weight": "kernel"}.get(segs[-1], segs[-1])
    top, rest = segs[0], segs[1:-1]
    if top == "dec" and rest[:2] == ["7", "0"]:
        return ("dec_out", "conv", leaf)
    out = [top, f"layers_{rest[0]}"]
    r = rest[1:]
    if not r:                                   # a bare strided conv
        out.append("conv")
    elif r[0] == "block" and r[1] == "2":       # hyper upsample's 1x1
        out += ["up_conv", "conv"]
    elif r[0] == "block" and r[1] == "1":       # ffn conv.0 / conv.2
        out += ["ffn", {"0": "conv1", "2": "conv2"}[r[3]], "conv"]
    elif r[0] == "block":                       # the DepthConv
        evc_block = top in ("enc", "dec") or top.startswith("encs_")
        out += ["dc", r[2]]
        if r[2] != "depth_conv" and not (evc_block and r[2] in _EVC_BARE_DC):
            out.append("conv")
    elif r[0] == "downsample":                  # RBS' bare strided 1x1
        out.append("downsample")
    else:                                       # conv1 / conv2 / subpel
        out += [r[0], "conv"]
    return tuple(out) + (leaf,)


def evc_params_to_jax(state):
    """The state_dict of a port EVC -> the flax EVC params, the inverse of
    evc_params_from_jax."""
    items = {}
    for key, t in state.items():
        path = _evc_flax_path(key)
        if evc_key(path) != key:
            raise KeyError(f"{key}: no flax path maps to it (tried "
                           f"{'/'.join(path)})")
        items[path] = _legacy_leaf(key, t)
    return _nest(items)


# ------------------------------- DCVC-2021 and the CompressAI intra codecs
# Their modules mirror the flax tree too (legacy/dcvc_net.py,
# legacy/compressai_zoo.py), but a flax ConvTranspose kernel (kh, kw, I, O)
# is torch ConvTranspose2d's weight (I, O, kh, kw) flipped in space, as
# the JAX importer converts it: a leaf is a transposed conv where the
# reference key map tags it ("deconv", key).

def _is_deconv(key_fn, path):
    key = key_fn(path)
    return isinstance(key, tuple) and key[0] == "deconv"


def _mirror_from_jax(flax_params, key_fn):
    state = {}
    for path, leaf in _leaves(flax_params):
        if path[-1] == "kernel" and _is_deconv(key_fn, path):
            arr = _f32(leaf)[::-1, ::-1].transpose(2, 3, 0, 1)
            t = torch.from_numpy(arr.copy())
        else:
            t = _legacy_tensor(path, leaf)
        state[_mirror_key(path)] = t
    return state


def _mirror_to_jax(state, key_fn):
    items = {}
    for key, t in state.items():
        segs = key.split(".")
        path = tuple(segs[:-1]) + ({"weight": "kernel"}.get(segs[-1],
                                                            segs[-1]),)
        if path[-1] == "kernel" and _is_deconv(key_fn, path):
            items[path] = t.detach().cpu().permute(2, 3, 0, 1).flip(
                0, 1).contiguous()
        else:
            items[path] = _legacy_leaf(key, t)
    return _nest(items)


def dcvc_params_from_jax(flax_params):
    """flax DCVCNet params -> the state_dict of
    dcvc_tpu_torch.legacy.dcvc_net.DCVCNet (the masked convs' kernels as
    conv weights, the deconvs' flipped into ConvTranspose2d's layout)."""
    return _mirror_from_jax(flax_params, key_fn_dcvc)


def dcvc_params_to_jax(state):
    """The state_dict of a port DCVCNet -> the flax DCVCNet params, the
    inverse of dcvc_params_from_jax."""
    return _mirror_to_jax(state, key_fn_dcvc)


def tcm_params_from_jax(flax_params):
    """flax DMCTCM params (both adaptor branches merged, feature_adaptor_I
    and _P, as the JAX codec holds them) -> the state_dict of
    dcvc_tpu_torch.legacy.dcvc_tcm.DMCTCM (the deconvs' kernels flipped
    into ConvTranspose2d's layout where key_fn_tcm tags them)."""
    return _mirror_from_jax(flax_params, key_fn_tcm)


def tcm_params_to_jax(state):
    """The state_dict of a port DMCTCM -> the flax DMCTCM params (both
    adaptor branches), the inverse of tcm_params_from_jax."""
    return _mirror_to_jax(state, key_fn_tcm)


_EB = "entropy_bottleneck."


def compressai_params_from_jax(tree, key_fn):
    """A JAX CompressAI codec's {"params", "eb_params"} tree -> the
    state_dict of the port's ScaleHyperprior (key_fn_hyperprior) or
    Cheng2020Anchor (key_fn_cheng2020): the model's leaves mirrored, the
    eb_params under `entropy_bottleneck.`."""
    state = _mirror_from_jax(tree["params"], key_fn)
    state.update({_EB + k: torch.from_numpy(_f32(v).copy())
                  for k, v in tree["eb_params"].items()})
    return state


def compressai_params_to_jax(state, key_fn):
    """The inverse of compressai_params_from_jax: {"params": the flax
    model params, "eb_params": the EntropyBottleneck's}, the layout of the
    JAX package's params.v1 files of these codecs."""
    eb = {k[len(_EB):]: t.detach().cpu().contiguous()
          for k, t in state.items() if k.startswith(_EB)}
    return {"params": _mirror_to_jax(
        {k: t for k, t in state.items() if not k.startswith(_EB)}, key_fn),
        "eb_params": _nest({(k,): t for k, t in eb.items()})}


def _converters(model):
    """(flax tree -> state_dict, state_dict -> flax tree) of a port
    model."""
    from ..legacy.compressai_zoo import Cheng2020Anchor, ScaleHyperprior
    from ..legacy.dcvc_dc import DMCDC
    from ..legacy.dcvc_net import DCVCNet
    from ..legacy.dcvc_fm import DMCFM
    from ..legacy.dcvc_hem import DMCHEM
    from ..legacy.dcvc_rt import DMCRT
    from ..legacy.dcvc_tcm import DMCTCM
    from ..legacy.evc import EVC
    from ..legacy.hem_intra import IntraNoAR
    from ..legacy.rt_intra import DMCIRT
    from ..models.dmc_ht import DMCHT
    from ..models.dmc_ld import DMCLD
    from ..models.dmci import DMCI
    if isinstance(model, (DMCI, DMCIRT)):
        return dmci_params_from_jax, dmci_params_to_jax
    if isinstance(model, DMCRT):
        return dmc_rt_params_from_jax, dmc_rt_params_to_jax
    if isinstance(model, EVC):
        return evc_params_from_jax, evc_params_to_jax
    if isinstance(model, IntraNoAR):
        return intra_noar_params_from_jax, intra_noar_params_to_jax
    if isinstance(model, DMCFM):
        return fm_params_from_jax, fm_params_to_jax
    if isinstance(model, DMCDC):
        return dc_params_from_jax, dc_params_to_jax
    if isinstance(model, DMCHEM):
        return hem_params_from_jax, hem_params_to_jax
    if isinstance(model, DCVCNet):
        return dcvc_params_from_jax, dcvc_params_to_jax
    if isinstance(model, DMCTCM):
        return tcm_params_from_jax, tcm_params_to_jax
    if isinstance(model, (ScaleHyperprior, Cheng2020Anchor)):
        key_fn = key_fn_hyperprior if isinstance(model, ScaleHyperprior) \
            else key_fn_cheng2020
        return (lambda tree: compressai_params_from_jax(tree, key_fn),
                lambda state: compressai_params_to_jax(state, key_fn))
    if isinstance(model, DMCLD):
        return dmc_ld_params_from_jax, dmc_ld_params_to_jax
    if isinstance(model, DMCHT):
        hts = model.cfg.is_hts
        return (lambda tree: dmc_ht_params_from_jax(tree, hts),
                lambda state: dmc_ht_params_to_jax(state, hts))
    raise TypeError(f"no flax tree for {type(model).__name__}")


def load_native_into(model, path):
    """Fill `model` (a port DMCI, DMCHT, DMCLD, DMCIRT, DMCRT, EVC,
    IntraNoAR, DMCFM, DMCDC, DMCHEM, DCVCNet, DMCTCM, ScaleHyperprior or
    Cheng2020Anchor at the file's config: config_from_header of its
    header) from the dcvc_tpu.params.v1 file at `path`.  Raises KeyError on a parameter
    the file lacks or one the model does not use; load_state_dict raises on
    a shape that differs.  Returns the model."""
    tree, _ = load_params(path)
    state = _converters(model)[0](tree)
    want = set(model.state_dict())
    missing = sorted(want - set(state))
    unused = sorted(set(state) - want)
    if missing or unused:
        raise KeyError(f"{path}: keys missing {missing[:5]} "
                       f"({len(missing)}), unused {unused[:5]} "
                       f"({len(unused)})")
    model.load_state_dict(state)
    return model


def save_native(model, path, cfg=None):
    """`model` as a dcvc_tpu.params.v1 file: its flax tree (in the
    parameters' own dtype) and `cfg` (the model's when None) in the
    header, which the JAX package's load_params and its CLIs read."""
    tree = _converters(model)[1](model.state_dict())
    save_params(path, tree, model.cfg if cfg is None else cfg)


def is_native(path):
    """True for a dcvc_tpu.params.v1 file ('random' is none)."""
    return path != "random" and checkpoint_format(path) == PARAMS_V1


def native_config(path, cls, default):
    """The config of a model file: cls(**the header's config) for a
    dcvc_tpu.params.v1 file that holds one, else `default`."""
    if not is_native(path):
        return default
    return config_from_header(cls, load_header(path), default)


def load_into(model, path):
    """`model` filled from a dcvc_tpu.params.v1 file (load_native_into)
    or a reference .pth.tar (load_reference_into), as the file's header
    says."""
    if is_native(path):
        return load_native_into(model, path)
    return load_reference_into(model, path)
