"""One-shot conversion of a reference torch checkpoint into the native
format (counterpart of dcvc_tpu/utils/import_cli.py and
scripts/import_checkpoint.py):

    python3 -m dcvc_tpu_torch.utils.import_cli SRC.pth.tar OUT.bin \\
        [--kind K] [--lenient]

OUT.bin is a dcvc_tpu.params.v1 file, which the port's CLIs
(--model_path_i / _p of eval/video_main.py and eval/family_main.py,
--model_path of eval/image_main.py) and the JAX package's read.  The
kind (--kind auto: guessed from the file name, as the JAX CLI guesses it)
names the model family; its port model is built at the family's published
config, filled from the file as load_reference_into fills it (each
model's from_reference renames the reference keys), and written through
the bridge's flax side (utils/jax_bridge.py) with the header {"family":
kind, "source": SRC}.  The result is the tree the JAX importer
(torch_import.import_state_dict over the JAX codec's template) writes.

Strict (the default) raises on a reference key that maps to no
parameter, beyond the ones the JAX converter tolerates (dcvc: the masked
convs' `.mask` buffers; cheng2020 / hyperprior: the EntropyBottleneck's
and GaussianConditional's coder tensors, the reparametrizers and `.mask`
buffers); --lenient returns (and prints) them.  A parameter the file
lacks raises either way.  No card is needed: the weights move, nothing is
computed.
"""

import argparse
import os
import sys

from .checkpoint import load_state_dict_file, save_params
from .jax_bridge import _converters

# the entropy coder's cached tables, which no converter reads
_SKIPPED = ("quantized_cdf", "cdf_length")

# filename hints -> kind (so `--kind auto` works on reference names)
_NAME_HINTS = (
    ("cvpr2026_image", "dmci"), ("cvpr2026_video_hts", "hts"),
    ("cvpr2026_video_htl", "htl"), ("cvpr2026_video_ld", "ld"),
    ("cvpr2024_video", "fm"), ("cvpr2023_video", "dc"),
    ("acmmm2022_video", "hem"), ("cvpr2025_video", "rt"),
    ("EVC_LL", "evc_ll"), ("EVC_LM", "evc_lm"), ("EVC_LS", "evc_ls"),
    ("EVC_ML", "evc_ml"), ("EVC_MM", "evc_mm"), ("EVC_SL", "evc_sl"),
    ("EVC_SS", "evc_ss"), ("EVC_MS", "evc_ms"),
    ("model_dcvc", "dcvc"),
    ("cheng2020-anchor", "cheng2020"), ("bmshj2018-hyperprior",
                                        "hyperprior"),
)

_COMPRESSAI = ("cheng2020", "hyperprior")
# the JAX converter's tolerated unmapped keys: suffixes by kind, and for
# the CompressAI codecs these prefixes and substrings besides `.mask`
_ALLOWED_SUFFIXES = {"dcvc": (".mask",), "cheng2020": (".mask",),
                     "hyperprior": (".mask",)}
_COMPRESSAI_UNUSED_OK = ("entropy_bottleneck", "gaussian_conditional")


def _registry():
    """kind -> (port model class, its published config)."""
    from ..legacy import evc
    from ..legacy.compressai_zoo import Cheng2020Anchor, Cheng2020Config, \
        HyperpriorConfig, ScaleHyperprior
    from ..legacy.dcvc_dc import DC_CONFIG, DMCDC
    from ..legacy.dcvc_fm import DMCFM, FM_CONFIG
    from ..legacy.dcvc_hem import DMCHEM, HEM_CONFIG
    from ..legacy.dcvc_net import DCVC_CONFIG, DCVCNet
    from ..legacy.dcvc_rt import DMCRT, RT_CONFIG
    from ..legacy.dcvc_tcm import DMCTCM, TCM_CONFIG
    from ..models.dmc_ht import DMCHT, HTL_CONFIG, HTS_CONFIG
    from ..models.dmc_ld import DMCLD, LD_CONFIG
    from ..models.dmci import DMCI, DMCIConfig
    reg = {"dmci": (DMCI, DMCIConfig()), "hts": (DMCHT, HTS_CONFIG),
           "htl": (DMCHT, HTL_CONFIG), "ld": (DMCLD, LD_CONFIG),
           "fm": (DMCFM, FM_CONFIG), "dc": (DMCDC, DC_CONFIG),
           "hem": (DMCHEM, HEM_CONFIG), "tcm": (DMCTCM, TCM_CONFIG),
           "dcvc": (DCVCNet, DCVC_CONFIG), "rt": (DMCRT, RT_CONFIG),
           "cheng2020": (Cheng2020Anchor, Cheng2020Config()),
           "hyperprior": (ScaleHyperprior, HyperpriorConfig())}
    for v in ("LL", "MM", "SS", "LM", "LS", "ML", "SL", "MS"):
        reg[f"evc_{v.lower()}"] = (evc.EVC, getattr(evc, f"EVC_{v}_CONFIG"))
    return reg


REGISTRY = _registry()


def all_kinds():
    return sorted(k for k in REGISTRY if k not in _COMPRESSAI) \
        + sorted(_COMPRESSAI)


def guess_kind(path):
    name = os.path.basename(path)
    for hint, kind in _NAME_HINTS:
        if hint in name:
            return kind
    raise ValueError(
        f"cannot guess model kind from {name!r}; pass --kind "
        f"(one of {all_kinds()})")


def _tolerated(kind, key):
    if key.endswith(_ALLOWED_SUFFIXES.get(kind, ())):
        return True
    return kind in _COMPRESSAI and (key.startswith(_COMPRESSAI_UNUSED_OK)
                                    or "reparam" in key)


def import_checkpoint(pth_path, out_path, kind="auto", strict=True):
    """Convert one reference checkpoint; returns the unused-key list (the
    unmapped reference keys the JAX converter would report)."""
    if kind == "auto":
        kind = guess_kind(pth_path)
    cls, cfg = REGISTRY[kind]
    model = cls(cfg)
    state = {k: v for k, v in load_state_dict_file(pth_path).items()
             if not any(s in k for s in _SKIPPED)}
    if hasattr(model, "from_reference"):
        state = model.from_reference(state)
    want = model.state_dict()
    missing = [k for k in want if k not in state]
    if missing:
        raise KeyError(f"{len(missing)} parameters of {kind} not in the "
                       f"checkpoint, e.g. {missing[:5]}")
    unused = [k for k in state
              if k not in want and not _tolerated(kind, k)]
    if strict and unused:
        raise ValueError(f"{len(unused)} unmapped reference keys, "
                         f"e.g. {unused[:5]} — wrong --kind?")
    model.load_state_dict({k: state[k] for k in want})
    save_params(out_path, _converters(model)[1](model.state_dict()), cfg,
                extra={"family": kind, "source": pth_path})
    return unused


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pth_path")
    ap.add_argument("out_path")
    ap.add_argument("--kind", default="auto",
                    choices=["auto"] + all_kinds())
    ap.add_argument("--lenient", action="store_true",
                    help="tolerate unmapped reference keys")
    args = ap.parse_args(argv)
    unused = import_checkpoint(args.pth_path, args.out_path,
                               kind=args.kind, strict=not args.lenient)
    if unused:
        print(f"! {len(unused)} unmapped keys: {unused[:8]}",
              file=sys.stderr)
    print(f"wrote {args.out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
