"""Evaluation entry point of the port, CLI-compatible with the reference
test_video.py (counterpart of the JAX package's test_video.py).

    python3 -m dcvc_tpu_torch.eval.video_main --test_config cfg.json \
        --output_path out.json [--model_structure ld|hts|htl] \
        [--model_path_i random|ckpt.bin|ckpt.pth.tar] [--model_path_p ...] \
        [--device cuda|cpu] [--worker N] ...

Encodes each (class, sequence, rate) point to a real NAL bitstream,
decodes it back from disk, and writes the nested {class -> seq -> rate}
result JSON.  The arguments and the JSON are test_video.py's, plus
`--device` (default cuda; the models run in bfloat16 there and in
float32 on the CPU).  With --device cuda and no card it raises.
Checkpoints are `random` (seeded random weights, the P-codec's damped by
0.5), a dcvc_tpu.params.v1 file (the JAX package's trainers' ckpt.bin,
or the port's save_native), whose header's config wins over
--tiny_model as in test_video.py, or a reference .pth.tar
(utils/checkpoint.py) at the published config, or the TINY one under
--tiny_model; the file's header tells the two formats apart.  With
--worker 1 the points run one after another in this process; with
--worker N > 1 in a pool of N spawned processes, each of which takes an
explicit slot from a shared counter, pins card slot % device_count
(--device cuda) and builds its own codecs, as test_video.py's
_init_worker does; the results come back in point order.
"""

import argparse
import concurrent.futures
import copy
import json
import os
import time

import numpy as np
import torch

from ..models.dmc_ht import DMCHTConfig, HTL_CONFIG, HTS_CONFIG, \
    TINY_HT_CONFIG, TINY_HTL_CONFIG
from ..models.dmc_ld import DMCLDConfig, LD_CONFIG, TINY_LD_CONFIG
from ..models.dmci import DMCI, DMCIConfig, TINY_CONFIG
from ..runtime.image_codec import DMCICodec
from ..runtime.video_codec import DMCHTCodec, DMCLDCodec
from ..utils.jax_bridge import load_into, native_config
from ..utils.logjson import dump_json
from .harness import run_one_point_with_stream


def str2bool(v):
    return str(v).lower() in ["yes", "y", "true", "t", "1"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip_thres", type=float, default=0)
    parser.add_argument("--model_path_i", type=str, default="random")
    parser.add_argument("--model_path_p", type=str, default="random")
    parser.add_argument("--rate_num", type=int, default=4)
    parser.add_argument("--qp_i", type=int, nargs="+")
    parser.add_argument("--qp_p", type=int, nargs="+")
    parser.add_argument("--force_intra", type=str2bool, default=False)
    parser.add_argument("--force_frame_num", type=int, default=-1)
    parser.add_argument("--force_intra_period", type=int, default=-1)
    parser.add_argument("--reset_interval", type=int, default=32)
    parser.add_argument("--test_config", type=str, required=True)
    parser.add_argument("--force_root_path", type=str, default=None)
    parser.add_argument("--worker", "-w", type=int, default=1)
    parser.add_argument("--model_structure", type=str, default="ld",
                        choices=["htl", "hts", "ld"])
    parser.add_argument("--calc_ssim", type=str2bool, default=False)
    parser.add_argument("--check_existing", type=str2bool, default=False)
    parser.add_argument("--stream_path", type=str, default="out_bin")
    parser.add_argument("--save_decoded_frame", type=str2bool, default=False)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--verbose_json", type=str2bool, default=False)
    parser.add_argument("--verbose", type=int, default=0)
    parser.add_argument("--tiny_model", type=str2bool, default=False,
                        help="use scaled-down configs (CI/smoke testing)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the codecs (cuda or cpu)")
    return parser.parse_args(argv)


def _p_codec_spec(args):
    """(codec class, config) of --model_structure; a params.v1
    --model_path_p's header config wins."""
    if args.model_structure == "ld":
        cls, cfg_cls = DMCLDCodec, DMCLDConfig
        cfg = TINY_LD_CONFIG if args.tiny_model else LD_CONFIG
    else:
        cls, cfg_cls = DMCHTCodec, DMCHTConfig
        if args.model_structure == "hts":
            cfg = TINY_HT_CONFIG if args.tiny_model else HTS_CONFIG
        else:
            cfg = TINY_HTL_CONFIG if args.tiny_model else HTL_CONFIG
    return cls, native_config(args.model_path_p, cfg_cls, cfg)


def i_config(args):
    """The DMCI config: a params.v1 --model_path_i's header's, else TINY
    under --tiny_model, else the published one."""
    return native_config(args.model_path_i, DMCIConfig,
                         TINY_CONFIG if args.tiny_model else DMCIConfig())


def check_device(device):
    """torch.device(device); raises when it names a missing card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device "
                           "cpu to run on the CPU)")
    return device


def build_codecs(args, device_ec=False):
    """(i_codec, p_codec, frame_delay) on args.device: bfloat16 on a CUDA
    device, float32 on the CPU.  device_ec: the codecs decode their
    streams on the device (K2)."""
    device = check_device(args.device)
    kw = {"dtype": torch.bfloat16 if device.type == "cuda"
          else torch.float32, "device": device,
          "skip_thres": args.skip_thres, "device_ec": device_ec}

    i_cfg = i_config(args)
    if args.model_path_i == "random":
        i_codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                        cfg=i_cfg, **kw)
    else:
        model = load_into(DMCI(i_cfg), args.model_path_i)
        i_codec = DMCICodec(model.state_dict(), cfg=i_cfg, **kw)

    p_codec, frame_delay = None, 1
    if not args.force_intra:
        cls, cfg = _p_codec_spec(args)
        frame_delay = cfg.frame_delay
        if args.model_path_p == "random":
            # damp random kernels so the untrained temporal recurrence
            # stays finite over long sequences (smoke-test only)
            p_codec = cls.init_random(torch.Generator().manual_seed(1),
                                      cfg=cfg, init_scale=0.5, **kw)
        else:
            model = load_into(cls.MODEL(cfg), args.model_path_p)
            p_codec = cls(model.state_dict(), cfg=cfg, **kw)
    return i_codec, p_codec, frame_delay


_WORKER_STATE = {}


def _init_worker(args, slot_counter):
    """Pool initializer (test_video.py's _init_worker): an explicit slot
    from the shared counter, the card of that slot, the worker's own
    codecs."""
    with slot_counter.get_lock():
        slot = slot_counter.value
        slot_counter.value += 1
    args = copy.copy(args)
    if torch.device(args.device).type == "cuda":
        index = slot % torch.cuda.device_count()
        torch.cuda.set_device(index)
        args.device = f"cuda:{index}"
    i_codec, p_codec, frame_delay = build_codecs(args)
    _WORKER_STATE.update(i_codec=i_codec, p_codec=p_codec,
                         frame_delay=frame_delay)


def _run_point(cur):
    return run_one_point_with_stream(
        _WORKER_STATE["p_codec"], _WORKER_STATE["i_codec"],
        _WORKER_STATE["frame_delay"], cur)


def run_points(args, points):
    """Every point's result, in point order: in this process, or in a
    pool of args.worker spawned processes."""
    if args.worker <= 1:
        i_codec, p_codec, frame_delay = build_codecs(args)
        return [run_one_point_with_stream(p_codec, i_codec, frame_delay,
                                          cur) for cur in points]
    ctx = torch.multiprocessing.get_context("spawn")
    slot_counter = ctx.Value("i", 0)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=args.worker, mp_context=ctx,
            initializer=_init_worker,
            initargs=(args, slot_counter)) as pool:
        return list(pool.map(_run_point, points))


def build_points(args, qp_num):
    """The (class, sequence, rate) points of --test_config, each the args
    dict of harness.run_one_point_with_stream (their .bin folders made).
    Returns (points, frames, sequences, qp_i)."""
    with open(args.test_config) as f:
        config = json.load(f)

    rate_num = args.rate_num
    if args.qp_i is not None:
        assert len(args.qp_i) == rate_num
        qp_i = args.qp_i
    else:
        assert 2 <= rate_num <= qp_num
        qp_i = [int(i + 0.5) for i in np.linspace(0, qp_num - 1, num=rate_num)]
    qp_p = args.qp_p if args.qp_p is not None else qp_i
    if not args.force_intra:
        assert len(qp_p) == rate_num

    root_path = args.force_root_path or config["root_path"]
    config = config["test_classes"]

    points = []
    count_frames = count_sequences = 0
    for ds_name in config:
        if config[ds_name]["test"] == 0:
            continue
        for seq in config[ds_name]["sequences"]:
            count_sequences += 1
            for rate_idx in range(rate_num):
                seq_cfg = config[ds_name]["sequences"][seq]
                cur = {
                    "rate_idx": rate_idx,
                    "qp_i": qp_i[rate_idx],
                    "qp_p": qp_p[rate_idx],
                    "force_intra": args.force_intra,
                    "reset_interval": args.reset_interval,
                    "seq": seq,
                    "src_type": config[ds_name]["src_type"],
                    "src_height": seq_cfg["height"],
                    "src_width": seq_cfg["width"],
                    "intra_period": seq_cfg["intra_period"],
                    "frame_num": seq_cfg["frames"],
                    "calc_ssim": args.calc_ssim,
                    "dataset_path": os.path.join(
                        root_path, config[ds_name]["base_path"]),
                    "check_existing": args.check_existing,
                    "stream_path": args.stream_path,
                    "save_decoded_frame": args.save_decoded_frame,
                    "ds_name": ds_name,
                    "verbose": args.verbose,
                    "verbose_json": args.verbose_json,
                }
                if args.force_intra:
                    cur["intra_period"] = 1
                if args.force_intra_period > 0:
                    cur["intra_period"] = args.force_intra_period
                if args.force_frame_num > 0:
                    cur["frame_num"] = args.force_frame_num
                count_frames += cur["frame_num"]

                bin_folder = os.path.join(cur["stream_path"], ds_name)
                os.makedirs(bin_folder, exist_ok=True)
                cur["src_path"] = os.path.join(cur["dataset_path"], seq)
                cur["bin_folder"] = bin_folder
                cur["curr_bin_path"] = os.path.join(
                    bin_folder, f"{seq}_q{cur['qp_i']}.bin")
                cur["curr_rec_path"] = cur["curr_bin_path"].replace(".bin", ".yuv")
                cur["curr_json_path"] = cur["curr_bin_path"].replace(".bin", ".json")

                points.append(cur)
    return points, count_frames, count_sequences, qp_i


def main(argv=None):
    """Runs every point of the test config; returns the result dict that
    it writes to --output_path."""
    begin_time = time.time()
    args = parse_args(argv)
    args.skip_thres = max(0, args.skip_thres)
    check_device(args.device)
    points, count_frames, count_sequences, qp_i = build_points(
        args, i_config(args).qp_num)
    print(f"testing {args.rate_num} rates, using qp: "
          f"{', '.join(str(q) for q in qp_i)}")

    results = run_points(args, points)
    for cur, result in zip(points, results):
        result["ds_name"] = cur["ds_name"]
        result["seq"] = cur["seq"]
        result["rate_idx"] = cur["rate_idx"]

    log_result = {}
    for res in results:
        log_result.setdefault(res["ds_name"], {}).setdefault(
            res["seq"], {})[f"{res['rate_idx']:03d}"] = res

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.output_path, "w") as fp:
        dump_json(log_result, fp, float_digits=6, indent=2)

    total_minutes = (time.time() - begin_time) / 60
    print("Test finished")
    print(f"Tested {count_frames} frames from {count_sequences} sequences")
    print(f"Total elapsed time: {total_minutes:.1f} min")
    return log_result


if __name__ == "__main__":
    main()
