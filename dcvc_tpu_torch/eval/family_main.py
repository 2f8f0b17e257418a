"""Legacy-family evaluation CLI (counterpart of test_video_family.py):
a model end to end over its own stream container, decoded from disk.

    python3 -m dcvc_tpu_torch.eval.family_main --model fm \\
        --test_config cfg.json --rate_num 1 --gop 32 \\
        --stream_path streams --output_path result.json [--fast] \\
        [--model_path_i i.bin --model_path_p p.bin] [--device cpu]

The arguments and the result JSON are test_video_family.py's, with
`--device` (default cuda) and `--dtype` (default f32, the reference's
type on every device; bf16 on request).  The port runs every model of
the JAX CLI, `--model rt`, `fm`, `hem`, `dc`, `dcvc` and `tcm`
(eval/family.py).  `--fast` is the estimated-bits mode
(FamilyRunner.run_sequence_fast), for fm, hem, dcvc and tcm; it raises
for rt and dc, as the JAX runner does.  The model files are dcvc_tpu.params.v1
files or reference .pth.tar checkpoints.  Sources are PNG folders (read
with utils/png.py: the machine with the card has no PIL) or YUV420 files,
converted to RGB with the BT.709 transforms of core/color.py as the JAX
CLI does.  Exits 1 when a sequence's decode is not bit-exact with its
encode.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..core.color import ycbcr2rgb, ycbcr420_to_444_np
from ..utils.png import load_rgb
from ..utils.video_io import YUV420Reader, _png_name
from .family import FAST_MODELS, FamilyRunner


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   choices=["dcvc", "tcm", "hem", "dc", "fm", "rt"])
    p.add_argument("--test_config", required=True)
    p.add_argument("--rate_num", type=int, default=1)
    p.add_argument("--gop", type=int, default=32,
                   help="intra period; -1 = single intra frame")
    p.add_argument("--frame_num", type=int, default=-1,
                   help="cap frames per sequence (-1 = config value)")
    p.add_argument("--stream_path", default="out_bin_family")
    p.add_argument("--output_path", default="family_result.json")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (smoke/CI)")
    p.add_argument("--fast", action="store_true",
                   help="estimated-bits mode without entropy coding (fm, "
                        "hem, dcvc, tcm; reference test_helper.py:134)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_path_i", default=None,
                   help="I-codec model file (dcvc_tpu.params.v1 or "
                        "reference .pth.tar)")
    p.add_argument("--model_path_p", default=None,
                   help="P-codec model file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the codecs (cuda or cpu)")
    p.add_argument("--dtype", default="f32", choices=("f32", "bf16"),
                   help="the codecs' type (f32, as the reference codes "
                        "the legacy family)")
    return p.parse_args(argv)


def read_sequence_rgb(seq_dir_or_file, src_type, width, height, n):
    """Returns a list of at most n (3, h, w) uint8 RGB frames."""
    frames = []
    if src_type == "png":
        padding = os.path.exists(_png_name(seq_dir_or_file, 1, True))
        for i in range(1, n + 1):
            path = _png_name(seq_dir_or_file, i, padding)
            if not os.path.exists(path):
                break
            frames.append(load_rgb(path).transpose(2, 0, 1))
    else:
        reader = YUV420Reader(seq_dir_or_file, width, height)
        for _ in range(n):
            y, uv = reader.read_one_frame()
            if y is None:
                break
            yuv444 = ycbcr420_to_444_np(y.astype(np.float32),
                                        uv.astype(np.float32))
            rgb = ycbcr2rgb(torch.from_numpy(
                yuv444.transpose(1, 2, 0) / 255.0)).numpy()
            frames.append(np.clip(np.round(rgb * 255), 0, 255)
                          .transpose(2, 0, 1).astype(np.uint8))
        reader.close()
    return frames


def main(argv=None):
    args = parse_args(argv)
    if args.fast and args.model not in FAST_MODELS:
        raise ValueError(f"--fast: no estimated-bits mode for "
                         f"{args.model} (the JAX runner's covers "
                         f"{FAST_MODELS})")
    with open(args.test_config) as f:
        cfg = json.load(f)
    root = cfg.get("root_path", "")
    runner = FamilyRunner(args.model, args.stream_path,
                          rate_num=args.rate_num, tiny=args.tiny,
                          seed=args.seed, model_path_i=args.model_path_i,
                          model_path_p=args.model_path_p,
                          device=args.device, dtype=args.dtype)

    results = {}
    for cls_name, cls in cfg["test_classes"].items():
        if not cls.get("test", 0):
            continue
        results[cls_name] = {}
        for seq_name, seq in cls["sequences"].items():
            path = os.path.join(root, cls["base_path"], seq_name)
            n = seq["frames"] if args.frame_num < 0 \
                else min(args.frame_num, seq["frames"])
            frames = read_sequence_rgb(path, cls["src_type"],
                                       seq["width"], seq["height"], n)
            if not frames:
                print(f"! no frames for {seq_name}", file=sys.stderr)
                continue
            gop = args.gop
            ip = seq.get("intra_period", gop)
            if ip == -1:
                gop = len(frames) + 1   # single intra
            if args.fast:
                res = {f"rate_{r}": runner.run_sequence_fast(
                    frames, r, gop, seq_name=f"{cls_name}_{seq_name}_r{r}")
                    for r in range(args.rate_num)}
            else:
                res = runner.run(frames, list(range(args.rate_num)), gop,
                                 seq_name=f"{cls_name}_{seq_name}")
            results[cls_name][seq_name] = res
            for rk, rv in res.items():
                flag = "" if rv["bitexact"] else "  !! MISMATCH"
                print(f"{cls_name}/{seq_name} {rk}: bpp {rv['avg_bpp']:.4f} "
                      f"psnr {rv['avg_psnr']:.2f} "
                      f"(i {rv['avg_psnr_i']:.2f} p {rv['avg_psnr_p']:.2f})"
                      f"{flag}", flush=True)

    with open(args.output_path, "w") as f:
        json.dump({"model": args.model, "results": results}, f, indent=1)
    print(f"results -> {args.output_path}")
    bad = [1 for c in results.values() for s in c.values()
           for r in s.values() if not r["bitexact"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
