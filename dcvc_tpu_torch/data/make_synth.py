"""A small synthetic training corpus (counterpart of
scripts/make_synth_data.py): multi-scale textured scenes with global
motion, written in the ImageFolder / VideoFolder description formats
(data/datasets.py).

    python3 -m dcvc_tpu_torch.data.make_synth --root DIR [--images 160] \
        [--seqs 24] [--frames 17] [--size 256] [--seed 0]

The same flags, the same numpy draws in the same order (data/synth.py's
pinned `scene` / `shift_frame`) and the same description.json files as
the JAX package's script; the PNG files go through utils/png.write_png,
without PIL.
"""

import argparse
import json
import os

import numpy as np

from ..utils.png import write_png
from .synth import scene, shift_frame


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--images", type=int, default=160)
    ap.add_argument("--seqs", type=int, default=24)
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    s = args.size

    img_root = os.path.join(args.root, "images")
    os.makedirs(img_root, exist_ok=True)
    names = []
    for i in range(args.images):
        img = scene(rng, s, s)
        name = f"im{i:04d}.png"
        write_png(os.path.join(img_root, name),
                  (img * 255).astype(np.uint8))
        names.append(name)
    with open(os.path.join(img_root, "description.json"), "w") as f:
        json.dump(names, f)

    vid_root = os.path.join(args.root, "videos")
    os.makedirs(vid_root, exist_ok=True)
    frame_names = [f"im{i + 1}.png" for i in range(args.frames)]
    seqs = []
    for k in range(args.seqs):
        seq_dir = os.path.join(vid_root, f"seq{k:03d}")
        os.makedirs(seq_dir, exist_ok=True)
        img = scene(rng, s, s)
        vy, vx = rng.uniform(-1.5, 1.5, 2)
        for i, name in enumerate(frame_names):
            frame = shift_frame(img, vy * i, vx * i)
            frame = np.clip(frame + rng.normal(0, 0.004, frame.shape), 0, 1)
            write_png(os.path.join(seq_dir, name),
                      (frame * 255).astype(np.uint8))
        seqs.append({"path": f"seq{k:03d}", "height": s, "width": s,
                     "seq_length": args.frames})
    with open(os.path.join(vid_root, "description.json"), "w") as f:
        json.dump({"seqs": seqs, "frames": frame_names}, f)

    print(f"{args.images} images -> {img_root}")
    print(f"{args.seqs} x {args.frames}f sequences -> {vid_root}")
    return img_root, vid_root


if __name__ == "__main__":
    main()
