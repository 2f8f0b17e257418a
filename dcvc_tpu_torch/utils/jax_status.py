"""The JAX trainers' resumable status files, read and written by the port.

dcvc_tpu's trainers keep one `status_epo{epoch}.bin` per epoch
(dcvc_tpu/utils/checkpoint.py:50-87): flax msgpack of {"epoch": a 0-d
int64 array, "params": the flax param tree, "opt_state": flax's
to_state_dict of the optimizer state[, "config": the model config]}.  The
optimizer is optax.chain(clip_by_global_norm, adamw) (dcvc_tpu/train/
step.py:32-38), whose state dict is {"0": {} (the clip), "1": {"0":
{"count", "mu", "nu"} (scale_by_adam), "1": {}, "2": {}}}.

The port reads and writes them through its own msgpack codec
(utils/msgpack.py).  The params and adamw's moment trees go through the
model's bridge functions (utils/jax_bridge.py: kernel transposes and the
stacked recon leaves), and adamw's count / mu / nu are
torch.optim.AdamW's step / exp_avg / exp_avg_sq of every parameter
(train/step.Optimizer: one AdamW over all the parameters, which step
together).  A file the port writes is the JAX trainers' layout, so that
they resume from it (load_latest_status + TrainStateRestore), and a file
they write resumes the port's trainers (resume).
"""

import dataclasses
import os
import struct

import numpy as np
import torch

from . import msgpack
from .checkpoint import load_latest_status as load_latest_pth
from .jax_bridge import _converters

PREFIX = "status_epo"
SUFFIX = ".bin"


def _adam_node(status):
    return status["opt_state"]["1"]["0"]


def _sorted(tree):
    """The tree with every dict's keys sorted, as flax's msgpack_serialize
    writes a tree (its copy through jax.tree_util sorts them)."""
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


def status_path(save_dir, epoch):
    return os.path.join(save_dir, f"{PREFIX}{epoch}{SUFFIX}")


def save_status(save_dir, model, opt, epoch, cfg=None):
    """`model` (a port model with a flax bridge) and `opt` (train.step.
    Optimizer over its parameters) as the JAX trainers' status after
    `epoch`: written to a temporary file and renamed into place, then
    every other status file of save_dir removed, as dcvc_tpu's
    save_status removes them."""
    to_jax = _converters(model)[1]
    count = 0
    mu, nu = {}, {}
    for name, p in model.named_parameters():
        s = opt.adamw.state.get(p, {})
        if s:
            count = int(s["step"])
        mu[name] = s.get("exp_avg", torch.zeros_like(p))
        nu[name] = s.get("exp_avg_sq", torch.zeros_like(p))
    status = {
        "epoch": np.asarray(epoch),
        "params": to_jax(model.state_dict()),
        "opt_state": {"0": {}, "1": {"0": {
            "count": np.asarray(count, np.int32),
            "mu": to_jax(mu), "nu": to_jax(nu)}, "1": {}, "2": {}}},
    }
    if cfg is not None:
        status["config"] = (cfg if isinstance(cfg, dict)
                            else dataclasses.asdict(cfg))
    os.makedirs(save_dir, exist_ok=True)
    curr = status_path(save_dir, epoch)
    with open(curr + ".tmp", "wb") as f:
        f.write(msgpack.packb(_sorted(status)))
    os.replace(curr + ".tmp", curr)
    for fn in os.listdir(save_dir):
        full = os.path.join(save_dir, fn)
        if PREFIX in fn and full != curr:
            os.remove(full)


def read_status(path):
    """The status dict of one file (tensors for arrays)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _status_files(save_dir, suffix):
    if not os.path.isdir(save_dir):
        return []
    files = [os.path.join(save_dir, f) for f in os.listdir(save_dir)
             if f.startswith(PREFIX) and f.endswith(suffix)]
    return sorted(files, key=os.path.getmtime)


def load_latest_status(save_dir):
    """The newest JAX status of save_dir that loads (of the last two, as
    dcvc_tpu's load_latest_status), or None."""
    for path in reversed(_status_files(save_dir, SUFFIX)[-2:]):
        try:
            return read_status(path)
        except (ValueError, IndexError, KeyError, TypeError, struct.error):
            continue
    return None


def load_into(model, opt, status):
    """Fill `model` and `opt` (train.step.Optimizer over its parameters)
    from a JAX status: the params, and AdamW's step / exp_avg / exp_avg_sq
    from adamw's count / mu / nu.  Returns the status's epoch."""
    from_jax = _converters(model)[0]
    state = from_jax(status["params"])
    want = set(model.state_dict())
    if set(state) != want:
        raise KeyError(f"status params: keys missing "
                       f"{sorted(want - set(state))[:5]}, unused "
                       f"{sorted(set(state) - want)[:5]}")
    model.load_state_dict(state)
    adam = _adam_node(status)
    mu, nu = from_jax(adam["mu"]), from_jax(adam["nu"])
    step = torch.tensor(float(int(adam["count"])), dtype=torch.float32)
    per_param = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        per_param[i] = {"step": step.clone(), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
    groups = opt.adamw.state_dict()["param_groups"]
    opt.adamw.load_state_dict({"state": per_param, "param_groups": groups})
    return int(status["epoch"])


def resume(save_dir, model, opt):
    """Resume a port trainer from the newest status of save_dir, its own
    (`status_epo{N}.pth`, utils/checkpoint.py) or a JAX trainer's
    (`status_epo{N}.bin`).  Returns (first epoch to run, step count), or
    None when there is no status."""
    pth = _status_files(save_dir, ".pth")
    bins = _status_files(save_dir, SUFFIX)
    if bins and (not pth or os.path.getmtime(bins[-1])
                 >= os.path.getmtime(pth[-1])):
        status = load_latest_status(save_dir)
        if status is not None:
            load_into(model, opt, status)
            return int(status["epoch"]) + 1, int(_adam_node(status)["count"])
    status = load_latest_pth(save_dir)
    if status is None:
        return None
    model.load_state_dict(status["model"])
    opt.load_state_dict(status["optimizer"])
    return status["epoch"] + 1, status["step"]
