"""Benchmark of the port: the DMC-HTS video codec, 1080p per-frame
enc+dec FPS (counterpart of the JAX repo's bench.py, same protocol).

    python3 -m dcvc_tpu_torch.bench [--device cuda|cpu]

HTS at HTS_CONFIG with seeded random weights (init_scale 0.5), skip_thres
0.15, bfloat16 on the card (float32 on the CPU), qp 32.  Each pass codes 6
chunks of 8 frames through compress_sequence / decompress_sequence from a
DPB seeded with the first frame; 2 warm-up passes are discarded and 4 are
timed, each clock read after torch.cuda.synchronize.  FPS = 1 / (t_enc +
t_dec) per frame.  After every pass the decoder's final feature-domain DPB
must equal the encoder's bit for bit, or the result is zeroed and the
exit code is 1 (bench.py:98-106).

Baseline: DCVC-RT 1080p on A100 = 125.2 FPS encode / 112.8 FPS decode
(DCVC-family/DCVC-RT/README.md) -> combined cycle 59.34 FPS.

The last line of stdout is ONE JSON object {metric, value, unit,
vs_baseline}; the per-pass and per-frame lines go to stderr.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from .eval.video_main import check_device
from .models.dmc_ht import HTS_CONFIG
from .runtime.video_codec import DMCHTCodec

METRIC = "dmc_hts_1080p_encdec_fps"
BASELINE_FPS = 1.0 / (1.0 / 125.2 + 1.0 / 112.8)   # DCVC-RT A100 cycle
QP = 32
FRAME_DELAY = 8


def make_chunks(h, w, n_chunks, frame_delay=FRAME_DELAY):
    """The frames of bench.py:45-59: a seeded uniform picture under an 8x8
    box blur, rolled one pixel per frame, with a little noise; n_chunks
    numpy arrays (1, h, w, 3 * frame_delay) float32 in [-0.5, 0.5]."""
    rng = np.random.default_rng(0)
    from scipy.signal import convolve2d
    k = np.ones((8, 8), np.float32) / 64.0
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    for c in range(3):
        base[:, :, c] = convolve2d(base[:, :, c], k, mode="same",
                                   boundary="symm")
    chunks = []
    for ci in range(n_chunks):
        frames = [np.clip(np.roll(base, ci * 8 + i, 1)
                          + rng.normal(0, 0.005, (h, w, 3)).astype(np.float32),
                          0, 1) - 0.5
                  for i in range(frame_delay)]
        chunks.append(np.concatenate([f[None] for f in frames], axis=-1))
    return chunks


def sync(device):
    """Waits for the card's queue (the clock brackets); nothing on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(cfg=HTS_CONFIG, h=1080, w=1920, n_chunks=6, warmup=2,
              iters=4, device="cuda"):
    """bench.py's protocol at (cfg, h, w): prints the per-pass lines to
    stderr and the JSON line to stdout; returns (exit code, the JSON
    record)."""
    device = check_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    codec = DMCHTCodec.init_random(torch.Generator().manual_seed(0),
                                   cfg=cfg, dtype=dtype, skip_thres=0.15,
                                   init_scale=0.5, device=device)
    chunks = [torch.from_numpy(c).to(device)
              for c in make_chunks(h, w, n_chunks, cfg.frame_delay)]
    # the DPB seed is the intra codec's reconstruction, which is
    # device-resident in the real pipeline (the reference protocol
    # brackets exclude source upload, test_video.py:194-219)
    intra = chunks[0][..., :3].contiguous()
    sync(device)

    qp = min(QP, cfg.qp_num - 1)
    qps = [qp] * n_chunks
    n_frames = n_chunks * cfg.frame_delay
    enc_times, dec_times = [], []
    for i in range(warmup + iters):
        codec.clear_dpb()
        codec.add_ref_feature_from_frame(intra)
        sync(device)
        t0 = time.perf_counter()
        results = codec.compress_sequence(chunks, qps)
        sync(device)
        t1 = time.perf_counter()
        enc_ref = codec.ref_feature

        streams = [r["bit_stream"] for r in results]
        ecs = [r["ec_parallel"] for r in results]
        nbytes = sum(len(s) for s in streams)

        codec.clear_dpb()
        codec.add_ref_feature_from_frame(intra)
        sync(device)
        t2 = time.perf_counter()
        codec.decompress_sequence(streams, qps, h, w, ecs)
        sync(device)
        t3 = time.perf_counter()

        if i >= warmup:
            enc_times.append(t1 - t0)
            dec_times.append(t3 - t2)
        print(f"# iter {i}: {n_frames}f enc {(t1-t0)*1000:.0f} ms "
              f"dec {(t3-t2)*1000:.0f} ms stream {nbytes} B",
              file=sys.stderr, flush=True)
        # bit-exactness gate: the decoder's final feature-domain DPB must
        # equal the encoder's bit-for-bit after the WHOLE sequence (any
        # earlier mismatch propagates through the temporal recurrence)
        if not torch.equal(enc_ref, codec.ref_feature):
            rec = {"metric": METRIC, "value": 0.0, "unit": "fps",
                   "vs_baseline": 0.0, "error": "round-trip mismatch"}
            print(json.dumps(rec), flush=True)
            return 1, rec

    t_enc = float(np.mean(enc_times)) / n_frames   # per frame
    t_dec = float(np.mean(dec_times)) / n_frames
    fps = 1.0 / (t_enc + t_dec)
    rec = {"metric": METRIC, "value": round(fps, 3), "unit": "fps",
           "vs_baseline": round(fps / BASELINE_FPS, 4)}
    print(json.dumps(rec), flush=True)
    print(f"# per-frame enc {t_enc*1000:.1f} ms ({1/t_enc:.1f} fps), "
          f"dec {t_dec*1000:.1f} ms ({1/t_dec:.1f} fps)",
          file=sys.stderr, flush=True)
    return 0, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codec (cuda or cpu)")
    args = ap.parse_args(argv)
    return run_bench(device=args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
