"""The newest JAX status file of a save_dir -> a final dcvc_tpu.params.v1
checkpoint (params + config), so that a training run cut short still
yields a checkpoint the eval CLIs take (counterpart of
scripts/status_to_ckpt.py):

    python3 -m dcvc_tpu_torch.utils.status_to_ckpt SAVE_DIR [OUT.bin] \
        [--config dmci_small|dmci_tiny|hts_small|hts_tiny]

--config names a known model config for statuses written before the
config was carried in the status file.  The status is read by
utils/jax_status.py and the params written by utils/checkpoint.py's
save_params, byte for byte as the JAX script writes them.
"""

import importlib
import os
import sys

from .checkpoint import save_params
from .jax_status import load_latest_status

KNOWN = {
    "dmci_small": ("dcvc_tpu_torch.models.dmci", "SMALL_CONFIG"),
    "dmci_tiny": ("dcvc_tpu_torch.models.dmci", "TINY_CONFIG"),
    "hts_small": ("dcvc_tpu_torch.models.dmc_ht", "SMALL_HT_CONFIG"),
    "hts_tiny": ("dcvc_tpu_torch.models.dmc_ht", "TINY_HT_CONFIG"),
}


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    cfg = None
    if "--config" in args:
        i = args.index("--config")
        mod, name = KNOWN[args[i + 1]]
        cfg = getattr(importlib.import_module(mod), name)
        del args[i:i + 2]
    save_dir = args[0]
    out = args[1] if len(args) > 1 else os.path.join(save_dir, "ckpt.bin")
    status = load_latest_status(save_dir)
    if status is None:
        print(f"no status checkpoints under {save_dir}", file=sys.stderr)
        return 1
    save_params(out, status["params"], cfg or status.get("config"))
    print(f"epoch {int(status['epoch'])} params -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
