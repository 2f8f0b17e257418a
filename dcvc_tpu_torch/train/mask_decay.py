"""EVC mask-decay training (counterpart of dcvc_tpu/train/mask_decay.py;
EVC, "Towards Real-Time Neural Image Compression with Mask Decay",
ICLR'23): per-channel gates on every hidden channel a `conv1` produces
for a sibling `conv2`, trained with a decay applied to the gates only,
then the channels whose gates collapsed are pruned.

The masks live outside the model, keyed as the JAX package keys them:
the '/'-joined flax path of the block that holds the conv1 / conv2 pair
(`enc/layers_1/dc`, `hyper_dec/layers_0/ffn`, ...), so one masks dict
names the same sites in both packages.  The flax paths of the port's EVC
come from its own keys through the bridge (utils/jax_bridge.py
`_evc_flax_path`, checked against utils/keys.py's key_fn_evc).

A gate scales its conv1's output channels: a torch conv weight is
(out, in, kh, kw), so the gate scales dim 0 and the bias.  The fold
returns new tensors for torch.func.functional_call; the module is not
changed.  A hidden channel whose gate is 0 contributes nothing further on
(lrelu(0) = relu(0) = 0, the depthwise convs are per channel), so a zero
gate is the hard-pruned channel.
"""

import torch
from torch.func import functional_call

from ..utils.jax_bridge import _evc_flax_path, _nest
from .step import Optimizer

MASK_LR = 1e-2      # plain SGD on the gates (dcvc_tpu's step)


def _flax_tree(model):
    """The flax path tree of a port EVC, each leaf its port key."""
    return _nest({_evc_flax_path(k): k for k in model.state_dict()})


def _conv_leaf(node):
    """ConvK wraps its nn.Conv in a child named 'conv'; plain nn.Conv
    keeps kernel/bias at the top."""
    if "kernel" in node:
        return node
    if "conv" in node and "kernel" in node["conv"]:
        return node["conv"]
    return None


def _walk_sites(tree):
    """((path, conv1 leaf node)) of every block with a conv1 -> conv2
    pair, in dcvc_tpu's walk order."""
    sites = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "conv1" in node and "conv2" in node:
            c1 = _conv_leaf(node["conv1"])
            if c1 is not None:
                sites.append((path, c1))
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return sites


def conv1_keys(model):
    """{site: (port key of its conv1 weight, of its bias or None)}, the
    site keyed by its '/'-joined flax path."""
    return {"/".join(path): (leaf["kernel"], leaf.get("bias"))
            for path, leaf in _walk_sites(_flax_tree(model))}


def mask_sites(model):
    """Paths (tuples of flax keys) to every block of a port EVC holding a
    prunable conv1 -> conv2 hidden-channel pair, with the hidden width."""
    state = model.state_dict()
    return [(path, int(state[leaf["kernel"]].shape[0]))
            for path, leaf in _walk_sites(_flax_tree(model))]


def init_masks(model):
    """All-ones float32 gate per maskable hidden channel, keyed by
    '/'-joined block path, on the model's device."""
    device = next(model.parameters()).device
    return {"/".join(p): torch.ones(c, device=device)
            for p, c in mask_sites(model)}


def fold_masks(model, params, masks):
    """params ({key: tensor}, the model's named parameters) with each
    site's conv1 weight (dim 0) and bias scaled by its gate; the other
    entries as they are.  Differentiable in both params and masks."""
    keys = conv1_keys(model)
    out = dict(params)
    for site, m in masks.items():
        weight, bias = keys[site]
        out[weight] = out[weight] * m.reshape((-1,) + (1,) * (
            out[weight].dim() - 1))
        if bias is not None:
            out[bias] = out[bias] * m
    return out


def folded_forward(model, masks, x):
    """The model's forward on x with `masks` folded in (functional_call
    over the folded parameters)."""
    params = dict(model.named_parameters())
    return functional_call(model, fold_masks(model, params, masks), (x,))


def _mean_f32(flags):
    """jnp.mean of a bool vector: its count times float32(1 / n)."""
    return float(flags.sum().float() * torch.tensor(1.0 / flags.numel(),
                                                    dtype=torch.float32))


def sparsity_report(masks, thresh=0.02):
    """Fraction of gates below `thresh` per site and overall."""
    per_site = {k: _mean_f32(m.abs() < thresh) for k, m in masks.items()}
    total = sum(int(m.numel()) for m in masks.values())
    dead = sum(int((m.abs() < thresh).sum()) for m in masks.values())
    return {"overall": dead / max(total, 1), "per_site": per_site,
            "total_gates": total, "dead_gates": dead}


def prune_masks(masks, thresh=0.02):
    """Hard-zero every gate below `thresh` (output-exact for the folded
    model: the pruned hidden channels were already contributing ~0)."""
    return {k: torch.where(m.abs() < thresh, torch.zeros_like(m), m)
            for k, m in masks.items()}


def create_mask_decay_state(model, lr, clip_norm):
    """The parameters' optimizer of the mask-decay step: train.step's
    global-norm clip + AdamW (dcvc_tpu's make_optimizer)."""
    return Optimizer(model, lr, clip_norm)


def make_mask_decay_step(model, opt, lam, mask_decay):
    """One mask-decay fine-tune step for an EVC image model (forward
    returns x_hat + bpp): step(masks, x) -> (masks, metrics).

    Loss = lam * mse + bpp; the gradient reaches the parameters and the
    gates through the fold; the gates also take the decay pull
    `mask_decay * m` (L2 decay on the gates only).  The parameters step
    through `opt` (create_mask_decay_state), the gates by plain SGD at
    MASK_LR.  x: (B, H, W, 3) RGB in [0, 1], or uint8 RGB."""

    def step(masks, x):
        if x.dtype == torch.uint8:   # EVC is an RGB [0, 1] codec
            x = x.float() / 255.0
        masks = {k: m.detach().requires_grad_(True) for k, m in
                 masks.items()}
        out = folded_forward(model, masks, x)
        mse = torch.mean((out["x_hat"] - x) ** 2)
        bpp = torch.mean(out["bpp"])
        loss = lam * mse + bpp
        loss.backward()
        grad_norm, skipped = opt.step()
        with torch.no_grad():
            new = {k: m - MASK_LR * (m.grad + mask_decay * m)
                   for k, m in masks.items()}
        metrics = {"loss": loss.detach(), "mse": mse.detach(),
                   "bpp": bpp.detach(), "grad_norm": grad_norm,
                   "skipped": skipped}
        return new, metrics

    return step
