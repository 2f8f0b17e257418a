"""Speed benchmark wrapper of the port (counterpart of the JAX repo's
test_compress_time.py, itself the reference's): runs the port's
evaluation entry with --verbose 2 on the runtime_avg config (HEVC_B,
97-frame 1080p), averages the per-frame encode / decode times that it
reports, and prints ms and FPS (FPS = frame_delay / avg_unit_time).

    python3 -m dcvc_tpu_torch.eval.compress_time [--model_structure
        hts|htl|ld] [--img] [--test_config CFG] [--force_root_path DIR]
        [--output_path OUT.json] [--model_path_i P] [--model_path_p P]
        [--tiny_model] [--device cuda|cpu] [--stream_path DIR]

The entry runs in a process of its own (`python3 -m
dcvc_tpu_torch.eval.video_main`), as the reference runs test_video.py.
Its harness discards 4 warm-up units (eval/harness.py), so a sequence
must have more than 4 units (chunks of frame_delay frames, frames for LD
and intra) or it reports no average and the wrapper fails.  The default
config names BQTerrace, which is not in the repo: write_sequence writes
a synthetic HEVC_B sequence and a config in runtime_avg.json's format
for --test_config.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from ..data.synth import scene, shift_frame
from ..utils.video_io import YUV420Writer
from . import module_env

DATASET = "HEVC_B"
WARMUP_UNITS = 4


def write_sequence(root, h, w, frames, seed=0):
    """A seeded YUV420 sequence under root/HEVC_B (data/synth.py's scene
    drifting by a subpixel shift per frame, its channels read as Y, Cb, Cr,
    chroma 2x2-averaged) and a test config in test_cfg/runtime_avg.json's
    format naming it (intra period -1).  Returns the config's path."""
    rng = np.random.default_rng(seed)
    img = scene(rng, h, w)
    vy, vx = rng.uniform(-1.5, 1.5, 2)
    seq = f"synth_{w}x{h}_60.yuv"
    os.makedirs(os.path.join(root, DATASET), exist_ok=True)
    writer = YUV420Writer(os.path.join(root, DATASET, seq), w, h)
    for i in range(frames):
        yuv = np.round(shift_frame(img, vy * i, vx * i) * 255).transpose(
            2, 0, 1)
        uv = yuv[1:].reshape(2, h // 2, 2, w // 2, 2).mean((2, 4)).round()
        writer.write_one_frame(yuv[:1].astype(np.uint8), uv.astype(np.uint8))
    writer.close()
    cfg = {"root_path": root, "test_classes": {DATASET: {
        "test": 1, "base_path": DATASET, "src_type": "yuv420",
        "sequences": {seq: {"width": w, "height": h, "frames": frames,
                            "intra_period": -1}}}}}
    path = os.path.join(root, "runtime_synth.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_structure", type=str, default="hts",
                        choices=["htl", "hts", "ld"])
    parser.add_argument("--img", action="store_true",
                        help="benchmark the intra codec (force_intra)")
    parser.add_argument("--output_path", type=str, default="runtime_out.json")
    parser.add_argument("--model_path_i", type=str, default="random")
    parser.add_argument("--model_path_p", type=str, default="random")
    parser.add_argument("--test_config", type=str,
                        default="test_cfg/runtime_avg.json")
    parser.add_argument("--force_root_path", type=str, default=None)
    parser.add_argument("--tiny_model", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the codecs (cuda or cpu)")
    parser.add_argument("--stream_path", type=str, default="out_bin",
                        help="folder of the entry's .bin files")
    return parser.parse_args(argv)


def command(args):
    """The entry's command line: test_compress_time.py's flags, plus
    --device and --stream_path."""
    cmd = [sys.executable, "-m", "dcvc_tpu_torch.eval.video_main",
           "--verbose", "2", "--rate_num", "4",
           "--force_intra", "1" if args.img else "0",
           "--test_config", args.test_config,
           "--force_frame_num", "-1", "-w", "1",
           "--skip_thres", "0.15",
           "--output_path", args.output_path,
           "--model_path_i", args.model_path_i,
           "--model_path_p", args.model_path_p,
           "--model_structure", args.model_structure]
    if args.tiny_model:
        cmd += ["--tiny_model", "1"]
    if args.force_root_path:
        cmd += ["--force_root_path", args.force_root_path]
    return cmd + ["--device", args.device, "--stream_path", args.stream_path]


def average_times(result):
    """(avg encode, avg decode) seconds per unit over the DATASET points
    of the entry's result JSON; raises where a point has no average."""
    encoding_time, decoding_time = [], []
    for seq, rates in result[DATASET].items():
        for qp, point in rates.items():
            enc = point.get("avg_frame_encoding_time")
            dec = point.get("avg_frame_decoding_time")
            if enc is None or dec is None:
                frames = point.get("i_frame_num", 0) \
                    + point.get("p_frame_num", 0)
                raise ValueError(
                    f"{seq} rate {qp}: no average time; the harness "
                    f"discards {WARMUP_UNITS} warm-up units, so the "
                    f"sequence needs more than {WARMUP_UNITS} units "
                    f"({frames} frames given)")
            encoding_time.append(enc)
            decoding_time.append(dec)
    return (sum(encoding_time) / len(encoding_time),
            sum(decoding_time) / len(decoding_time))


def main(argv=None):
    """Runs the entry and prints the averages; returns (avg encode, avg
    decode) seconds per unit.  Exits 1 when the entry fails or reports
    no average."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    cmd = command(args)
    print(" ".join(cmd), flush=True)
    if subprocess.run(cmd, env=module_env()).returncode != 0:
        sys.exit(1)

    with open(args.output_path) as f:
        result = json.load(f)
    try:
        avg_enc, avg_dec = average_times(result)
    except ValueError as e:
        sys.exit(f"compress_time: {e}")
    frame_delay = 1 if args.model_structure == "ld" or args.img else 8
    print(f"Average encoding time on {DATASET}"
          f" = {avg_enc * 1000:.4f} ms / {frame_delay / avg_enc:.4f} fps")
    print(f"Average decoding time on {DATASET}"
          f" = {avg_dec * 1000:.4f} ms / {frame_delay / avg_dec:.4f} fps")
    return avg_enc, avg_dec


if __name__ == "__main__":
    main()
