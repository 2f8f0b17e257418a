"""Reference checkpoints (.pth.tar of microsoft/DCVC) -> the port's models.

The port names its parameters after the reference torch module tree
(utils/keys.py), so a reference state_dict loads without a key map.
load_state_dict_file is the port's copy of dcvc_tpu's
load_torch_checkpoint (get_state_dict semantics) with torch tensors in
place of numpy arrays; load_reference_into fills a model from it and, as
dcvc_tpu's import_state_dict does, ignores only the entropy coder's
cached tables (`quantized_cdf`, `cdf_length`).
"""

import torch

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
    shape that differs.  Returns the model."""
    state = {k: v for k, v in load_state_dict_file(path).items()
             if not any(s in k for s in _SKIPPED)}
    want = set(model.state_dict())
    missing = sorted(want - set(state))
    unused = sorted(set(state) - want)
    if missing or unused:
        raise KeyError(f"{path}: keys missing {missing[:5]} "
                       f"({len(missing)}), unused {unused[:5]} "
                       f"({len(unused)})")
    model.load_state_dict(state)
    return model
