"""Checkpoints: reference .pth.tar files (microsoft/DCVC) <-> the port's
models, and the trainers' per-epoch status files.

The port names its parameters after the reference torch module tree
(utils/keys.py), so a reference state_dict loads without a key map.
load_state_dict_file is the port's copy of dcvc_tpu's
load_torch_checkpoint (get_state_dict semantics) with torch tensors in
place of numpy arrays; load_reference_into fills a model from it and, as
dcvc_tpu's import_state_dict does, ignores only the entropy coder's
cached tables (`quantized_cdf`, `cdf_length`).  save_reference writes a
model's state_dict in that format, which load_reference_into reads back.

save_params / load_params / load_header read and write the JAX
package's native format, `dcvc_tpu.params.v1` (dcvc_tpu/utils/
checkpoint.py:18-47): an 8-byte little-endian header length, a JSON
header with `format` and `config`, then the flax msgpack of the param
tree (utils/msgpack.py, the port's own codec of it).  The trees are
flax's; utils/jax_bridge.py turns them into the port's state_dicts and
back (load_native_into, save_native).  checkpoint_format tells the two
kinds of file apart by their header.

save_status / load_latest_status keep the trainers' resumable state
(model, optimizer, epoch, step, config) as dcvc_tpu's save_status /
load_latest_status do: one `status_epo{epoch}` file, older ones pruned,
the newest of the last two that loads is resumed.
"""

import dataclasses
import json
import os
import pickle

import torch

from . import msgpack

PARAMS_V1 = "dcvc_tpu.params.v1"

_SKIPPED = ("quantized_cdf", "cdf_length")


def load_state_dict_file(path):
    """Load a reference .pth.tar into {key: tensor} on the CPU: unwrap
    `state_dict` / `net`, strip `module.` prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if "net" in ckpt:
        ckpt = ckpt["net"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = torch.as_tensor(v)
    return out


def load_reference_into(model, path):
    """Fill `model` (a port model at the checkpoint's config) from the
    reference checkpoint at `path`.  Raises KeyError on a parameter the
    file lacks or a key of the file that the model does not use (the
    entropy coder's cached tables aside); load_state_dict raises on a
    shape that differs.  A model whose reference names some parameters
    otherwise (DCVC-RT's z prior) turns the file's state_dict into its
    own with its `from_reference`.  Returns the model."""
    state = {k: v for k, v in load_state_dict_file(path).items()
             if not any(s in k for s in _SKIPPED)}
    if hasattr(model, "from_reference"):
        state = model.from_reference(state)
    want = set(model.state_dict())
    missing = sorted(want - set(state))
    unused = sorted(set(state) - want)
    if missing or unused:
        raise KeyError(f"{path}: keys missing {missing[:5]} "
                       f"({len(missing)}), unused {unused[:5]} "
                       f"({len(unused)})")
    model.load_state_dict(state)
    return model


def save_reference(path, model):
    """model's state_dict as a reference-format checkpoint
    ({"state_dict": ...}, CPU tensors)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"state_dict": state}, path)


def save_status(save_dir, model, optimizer, epoch, step, cfg):
    """The resumable status after `epoch`: written to a temporary file and
    renamed into place, then older status files are removed."""
    os.makedirs(save_dir, exist_ok=True)
    curr = os.path.join(save_dir, f"status_epo{epoch}.pth")
    status = {"epoch": epoch, "step": step,
              "model": {k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
              "optimizer": optimizer.state_dict(),
              "config": dataclasses.asdict(cfg)}
    torch.save(status, curr + ".tmp")
    os.replace(curr + ".tmp", curr)
    for fn in os.listdir(save_dir):
        full = os.path.join(save_dir, fn)
        if fn.startswith("status_epo") and full != curr:
            os.remove(full)


def load_latest_status(save_dir):
    """The newest status of save_dir that loads (of the last two), as
    save_status wrote it; None if there is none."""
    if not os.path.isdir(save_dir):
        return None
    files = [os.path.join(save_dir, f) for f in os.listdir(save_dir)
             if f.startswith("status_epo") and f.endswith(".pth")]
    files.sort(key=os.path.getmtime)
    for path in reversed(files[-2:]):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except (RuntimeError, EOFError, pickle.UnpicklingError):
            continue
    return None


def save_params(path, params, cfg=None, extra=None,
                chunk_bytes=msgpack.MAX_CHUNK_SIZE):
    """A param tree (nested dicts of tensors or numpy arrays) in
    dcvc_tpu.params.v1, byte for byte as dcvc_tpu's save_params writes
    it: the header {"format", "config": dataclasses.asdict(cfg), **extra}
    (json.dumps), then the tree's msgpack (arrays over chunk_bytes
    chunked, as flax does)."""
    payload = msgpack.packb(params, chunk_bytes)
    header = {"format": PARAMS_V1}
    if cfg is not None:
        header["config"] = (cfg if isinstance(cfg, dict)
                            else dataclasses.asdict(cfg))
    if extra:
        header.update(extra)
    header_bytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(header_bytes).to_bytes(8, "little"))
        f.write(header_bytes)
        f.write(payload)


def load_header(path):
    """The JSON header of a dcvc_tpu.params.v1 file, without the
    params."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n).decode())


def load_params(path):
    """(param tree of tensors, header dict) of a dcvc_tpu.params.v1
    file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        params = msgpack.unpackb(f.read())
    if header.get("format") != PARAMS_V1:
        raise ValueError(f"{path}: format {header.get('format')!r}, not "
                         f"{PARAMS_V1}")
    return params, header


def checkpoint_format(path):
    """PARAMS_V1 for a file that starts with that format's header, else
    "pth.tar" (a reference checkpoint; torch.load reads it)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if not 0 < n <= min(size - 8, 1 << 20):
            return "pth.tar"
        try:
            header = json.loads(f.read(n).decode())
        except ValueError:
            return "pth.tar"
    if isinstance(header, dict) and header.get("format") == PARAMS_V1:
        return PARAMS_V1
    return "pth.tar"


def config_from_header(cls, header, default):
    """cls(**header["config"]), or `default` when the header holds no
    config."""
    return cls(**header["config"]) if "config" in header else default
