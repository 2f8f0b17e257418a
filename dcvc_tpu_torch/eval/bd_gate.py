"""BD-rate gate of the port (counterpart of the JAX package's
run_bd_gate.py): the whole RD pipeline against the VTM anchor.

    python3 -m dcvc_tpu_torch.eval.bd_gate --output_path gate.json \
        [--model_path_i ckpt.bin] [--model_path_p ckpt.bin] \
        [--allow_extrapolation] [--force_intra] [--frames 65] \
        [--device cuda|cpu] [--tiny_model]

Draws a synthetic stand-in sequence from the training corpus's scene
distribution (data/synth.py, seed 777 as run_bd_gate.py), 256x384 YUV420
by default, into a temporary directory; codes it at 4 rate points with
DMCI + HTS through eval/video_main (in this process), the QPs spread
over the checkpoint's qp_num (8 with random weights); compares the
result against the vendored VTM-17.0 low-delay anchor
(test_cfg/anchors/vtm_17.0_yuv420_LB_allf_ip0.json) with
eval/compare_bd_rate; and writes the artifact of run_bd_gate.py
(`rd_monotone`, non-finite numbers as null, strict JSON) to
--output_path, the only file it writes.  It refuses the JAX package's
artifacts/BD_RATE_GATE.json, which comes from trained weights.

With random weights the RD curve lies far below VTM's quality range,
so the number vs the anchor needs --allow_extrapolation and is a
pipeline-validation number, not a quality claim.  With trained
checkpoints (dcvc_tpu.params.v1, whose header gives the config, or a
reference .pth.tar) the exit code is 1 when the RD curve is not
monotone, or when a BD-rate is NaN without --allow_extrapolation, as in
run_bd_gate.py.  Added: --device (default cuda) and --tiny_model (the
TINY configs for random weights); --height / --width size the sequence.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from ..core.color import rgb2ycbcr_np, yuv_444_to_420_np
from ..data.synth import scene, shift_frame
from ..utils.checkpoint import load_header
from ..utils.jax_bridge import is_native
from . import compare_bd_rate, video_main

SEQ = "Beauty_1920x1080_120fps_420_8bit_YUV.yuv"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ANCHOR = os.path.join("test_cfg", "anchors",
                      "vtm_17.0_yuv420_LB_allf_ip0.json")
JAX_ARTIFACT = os.path.join(REPO, "artifacts", "BD_RATE_GATE.json")


def make_sequence(root, h=192, w=256, n=9):
    """run_bd_gate.py's stand-in sequence (seed 777, held out from the
    corpus seeds) as an 8-bit YUV420 file under root/UVG, and its test
    config; returns the config's path."""
    os.makedirs(os.path.join(root, "UVG"), exist_ok=True)
    rng = np.random.default_rng(777)
    img = scene(rng, h, w)
    dy, dx = rng.uniform(-1.5, 1.5, 2)
    with open(os.path.join(root, "UVG", SEQ), "wb") as f:
        for i in range(n):
            frame = shift_frame(img, dy * i, dx * i)
            yuv = rgb2ycbcr_np(frame.astype(np.float32), quant=False)
            y, uv = yuv_444_to_420_np(yuv.transpose(2, 0, 1))
            f.write(np.clip(y * 255 + 0.5, 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(uv * 255 + 0.5, 0, 255).astype(np.uint8)
                    .tobytes())
    cfg = {"root_path": root, "test_classes": {"UVG": {
        "test": 1, "base_path": "UVG", "src_type": "yuv420",
        "sequences": {SEQ: {"width": w, "height": h, "frames": n,
                            "intra_period": -1}}}}}
    cfg_path = os.path.join(root, "bd_gate_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path


def nan_to_none(node):
    """Keep the artifact strict JSON (json.dump would write NaN)."""
    if isinstance(node, dict):
        return {k: nan_to_none(v) for k, v in node.items()}
    if isinstance(node, float) and not np.isfinite(node):
        return None
    return node


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output_path", required=True,
                    help="where the gate's JSON artifact goes")
    ap.add_argument("--model_path_i", default="random")
    ap.add_argument("--model_path_p", default="random")
    ap.add_argument("--allow_extrapolation", action="store_true",
                    help="only needed for untrained/random weights whose "
                         "RD range misses the anchor's")
    ap.add_argument("--force_intra", action="store_true",
                    help="image-only gate (every frame intra)")
    ap.add_argument("--frames", type=int, default=65,
                    help="gate sequence length; the VTM anchor averages "
                         "over 600 frames (one intra), so short sequences "
                         "structurally overweight the intra cost")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the codecs (cuda or cpu)")
    ap.add_argument("--tiny_model", action="store_true",
                    help="the TINY configs (random weights or a .pth.tar)")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the gate; returns the exit code (the artifact is at
    --output_path)."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if os.path.abspath(args.output_path) == JAX_ARTIFACT:
        raise ValueError(f"{args.output_path} is the JAX package's gate "
                         f"artifact; write the port's elsewhere")
    video_main.check_device(args.device)
    trained = args.model_path_i != "random" or args.model_path_p != "random"

    # rate points: 4 QPs across the whole quant ladder of the checkpoint
    qp_num = 8
    path = (args.model_path_i if args.model_path_i != "random"
            else args.model_path_p)
    if trained and is_native(path):
        qp_num = load_header(path).get("config", {}).get("qp_num", qp_num)
    qps = [str(int(round(q))) for q in np.linspace(0, qp_num - 1, 4)]

    with tempfile.TemporaryDirectory() as root:
        cfg_path = make_sequence(root, h=args.height, w=args.width,
                                 n=args.frames)
        result_json = os.path.join(root, "result.json")
        cmd = ["--test_config", cfg_path,
               "--output_path", result_json,
               "--stream_path", os.path.join(root, "bin"),
               "--model_structure", "hts",
               "--rate_num", "4", "--qp_i", *qps, "--qp_p", *qps,
               "--model_path_i", args.model_path_i,
               "--model_path_p", args.model_path_p,
               "--device", args.device]
        if args.tiny_model:
            cmd += ["--tiny_model", "1"]
        if args.force_intra:
            cmd += ["--force_intra", "1"]
        video_main.main(cmd)

        cmd = ["--base_method", "VTM-17.0",
               "--log_paths", "VTM-17.0", os.path.join(REPO, ANCHOR),
               "dcvc_tpu_hts", result_json,
               "--compare_frame_type", "all",
               "--output_path", os.path.join(root, "bd.json")]
        if args.allow_extrapolation:
            cmd.append("--allow_extrapolation")
        compare_bd_rate.main(cmd)

        with open(os.path.join(root, "bd.json")) as f:
            bd = json.load(f)
        with open(result_json) as f:
            rd = json.load(f)

    points = {rp: {"bpp": v["ave_all_frame_bpp"],
                   "psnr": v["ave_all_frame_psnr"],
                   "i_bpp": v.get("ave_i_frame_bpp"),
                   "p_bpp": v.get("ave_p_frame_bpp"),
                   "i_psnr": v.get("ave_i_frame_psnr"),
                   "p_psnr": v.get("ave_p_frame_psnr")}
              for rp, v in rd["UVG"][SEQ].items()}
    # RD sanity: higher rate must buy higher quality on trained models
    by_bpp = sorted(points.values(), key=lambda p: p["bpp"])
    monotone = all(a["psnr"] <= b["psnr"]
                   for a, b in zip(by_bpp, by_bpp[1:]))

    if trained:
        what = ("DMCI, every frame intra" if args.force_intra
                else "DMCI+HTS")
        note = (f"trained-checkpoint gate ({what}), BD-rate vs the "
                "VTM-17.0 anchor on the synthetic stand-in sequence; "
                "content differs from real UVG so the number measures the "
                "METHODOLOGY end-to-end, not published quality")
    else:
        note = ("pipeline-validation run: synthetic stand-in sequence, "
                f"UNTRAINED {'TINY' if args.tiny_model else 'full-width'} "
                "models with seeded random weights; pass --model_path_i/_p "
                "for the trained gate")
    has_nan = json.dumps(bd, allow_nan=True).find("NaN") >= 0

    artifact = {
        "note": note,
        "trained_weights": trained,
        "force_intra": args.force_intra,
        "rd_monotone": monotone,
        "anchor": ANCHOR,
        "extrapolated": args.allow_extrapolation,
        "bd_rate_pct_vs_vtm17": nan_to_none(bd),
        "rd_points": points,
    }
    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.output_path, "w") as f:
        json.dump(artifact, f, indent=2, allow_nan=False)
    print(json.dumps({k: artifact[k] for k in
                      ("trained_weights", "rd_monotone",
                       "bd_rate_pct_vs_vtm17")}, indent=2))
    print(f"wrote {args.output_path}")
    rc = 0
    if trained and not monotone:
        print("!! RD curve not monotone", file=sys.stderr)
        rc = 1
    if trained and has_nan and not args.allow_extrapolation:
        print("!! BD-rate is NaN (RD ranges do not overlap the anchor "
              "and --allow_extrapolation is off) — gate FAILED",
              file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
