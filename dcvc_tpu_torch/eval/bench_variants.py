"""Per-variant speed benchmark of the port: DMCI (UF-Intra), HTL, HTS
(counterpart of the JAX repo's scripts/bench_variants.py, same protocol
and JSON fields).

    python3 -m dcvc_tpu_torch.eval.bench_variants [dmci] [htl] [hts] \\
        [--res 2160p|1080p|720p|480p|240p] [--model_path DMCI.bin] \\
        [--model_path_p HT.bin] [--device_ec] [--device cuda|cpu]
    python3 -m dcvc_tpu_torch.eval.bench_variants --envelope LOG \\
        [dmci htl hts] [--device_ec] ...
    python3 -m dcvc_tpu_torch.eval.bench_variants --collect LOG OUT.json \\
        [--note TEXT]

Same protocol as dcvc_tpu_torch/bench.py (skip_thres 0.15, warm-up
discarded, bit-exact round-trip gate), bfloat16 on the card, float32 on
the CPU.  DMCI codes 8 images per pass through compress_many /
decompress_many (1 warm-up pass, 3 timed), each decoder x_hat equal to
the encoder's; its random weights are damped by 0.65 on every leaf the
JAX codec names `kernel` (through the weight bridge), which lands at
~15% coded symbols, a realistic operating point.  HTL and HTS code 6
chunks of 8 frames per pass through compress_sequence /
decompress_sequence (2 warm-up passes, 3 timed), the decoder's final DPB
equal to the encoder's.  --model_path / --model_path_p take trained
checkpoints (params.v1 or a reference .pth.tar) at their header's config
(tag `_trained`); --device_ec decodes on the card through K2 (tag
`_devec`).  dec_device_fps is the decode chain on the card alone (the
stages on zero symbol buffers, no entropy coder, with host syncs an
error): the number a decode converges to once the host's entropy work is
hidden.

Prints one JSON line per variant to stdout: {metric, value, unit,
vs_baseline, enc_fps, dec_fps, dec_device_fps, bpp}; vs_baseline is null
but at 1080p with the seeded weights and the host coder (the published
baselines are 1080p only).  --envelope runs one process per (variant,
resolution) of the speed envelope and appends their output to LOG;
--collect gathers a log's JSON lines into one artifact.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..bench import BASELINE_FPS as RT_A100_FPS, QP, sync
from ..models.dmc_ht import DMCHT, DMCHTConfig, HTL_CONFIG, HTS_CONFIG
from ..models.dmci import DMCI, DMCIConfig
from ..runtime.image_codec import DMCICodec
from ..runtime.symbols import expand_from_pos
from ..runtime.video_codec import DMCHTCodec
from ..utils.jax_bridge import dmci_params_from_jax, dmci_params_to_jax, \
    load_into, native_config
from . import module_env
from .video_main import check_device

VARIANTS = ("dmci", "htl", "hts")
# the reference's optimized-speed envelope (README.md "Measure
# compression speed" note; hint tables d3x3.cu:7-25)
RESOLUTIONS = {
    "2160p": (2160, 3840),
    "1080p": (1080, 1920),
    "720p": (720, 1280),
    "480p": (480, 832),
    "240p": (240, 416),
}
# scripts/run_envelope.sh's order and per-run time limit
ENVELOPE = ("1080p", "2160p", "720p", "480p", "240p")
ENVELOPE_TIMEOUT = 2400
UF_INTRA_A100_FPS = 1.0 / (1.0 / 81.5 + 1.0 / 95.0)   # UF-Intra @1080p
DMCI_DAMPING = 0.65
MODULE = "dcvc_tpu_torch.eval.bench_variants"


def make_frames(h, w, n, rng):
    """scripts/bench_variants.py:24-32: n frames of one seeded picture
    under an 8x8 box blur, each with its own noise; numpy (h, w, 3)
    float32 in [-0.5, 0.5]."""
    from scipy.signal import convolve2d
    k = np.ones((8, 8), np.float32) / 64.0
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    for c in range(3):
        base[:, :, c] = convolve2d(base[:, :, c], k, mode="same",
                                   boundary="symm")
    return [np.clip(base + rng.normal(0, 0.005, (h, w, 3)).astype(np.float32),
                    0, 1) - 0.5 for _ in range(n)]


def sync_free(device, fn):
    """fn() with every host sync an error on the card
    (torch.cuda.set_sync_debug_mode); plain fn() on the CPU."""
    if device.type != "cuda":
        return fn()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def damp_kernels(state, scale=DMCI_DAMPING):
    """A DMCI state_dict with every parameter that the JAX codec holds as
    a flax leaf named `kernel` multiplied by `scale` in float32 (the
    lambda of scripts/bench_variants.py:143-145), through the weight
    bridge: the port's `weight`s are not all kernels."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (torch.from_numpy(v.float().numpy() * np.float32(scale))
                 if k == "kernel" else v)
                for k, v in tree.items()}
    return dmci_params_from_jax(walk(dmci_params_to_jax(state)))


def _dtype(device):
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def dmci_codec(device, model_path=None, device_ec=False, cfg=None):
    """(DMCICodec, tag): a trained checkpoint at its header's config
    (`_trained`), else seeded random weights at `cfg` (DMCIConfig() when
    None) damped by damp_kernels."""
    kw = {"dtype": _dtype(device), "skip_thres": 0.15,
          "device_ec": device_ec, "device": device}
    tag = "_devec" if device_ec else ""
    if model_path:
        # trained checkpoint: the operating point (skip rate, bpp) is the
        # model's real one, at its own (header) config
        cfg = native_config(model_path, DMCIConfig, DMCIConfig())
        model = load_into(DMCI(cfg), model_path)
        return DMCICodec(model.state_dict(), cfg=cfg, **kw), "_trained" + tag
    cfg = cfg or DMCIConfig()
    model = DMCI(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return DMCICodec(damp_kernels(model.state_dict()), cfg=cfg, **kw), tag


def ht_codec(device, variant, model_path=None, device_ec=False, cfg=None):
    """(DMCHTCodec, tag): a trained checkpoint at its header's config (the
    variant's published one without), else seeded random weights at `cfg`
    (the variant's published config when None), init_scale 0.5."""
    kw = {"dtype": _dtype(device), "skip_thres": 0.15,
          "device_ec": device_ec, "device": device}
    tag = "_devec" if device_ec else ""
    published = HTL_CONFIG if variant == "htl" else HTS_CONFIG
    if model_path:
        cfg = native_config(model_path, DMCHTConfig, published)
        model = load_into(DMCHT(cfg), model_path)
        return DMCHTCodec(model.state_dict(), cfg=cfg, **kw), "_trained" + tag
    return DMCHTCodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=cfg or published, init_scale=0.5,
                                  **kw), tag


def device_decode_image(codec, h, w, qp=None, iters=3):
    """The DMCI decode chain on zero symbol buffers (prior0, then 4 x
    (expand_from_pos + step), then synthesis): no entropy coder, no state
    of the codec touched.  Host syncs are an error on the card.  Returns
    (ms per frame over `iters` timed chains after a warm one, the last
    chain's x_hat)."""
    device = codec.device
    p = codec._plan(h, w)
    zh, zw = p["z"]
    ch_y = codec.cfg.ch_y
    qp = min(QP, codec.cfg.qp_num - 1) if qp is None else qp
    z = torch.zeros((1, zh, zw, codec.cfg.ch_z), dtype=torch.int8,
                    device=device)
    pad = torch.zeros((min(1 << 16, p["n_cand"]),), dtype=torch.int8,
                      device=device)
    cand = (1,) + p["cand"] + (ch_y,)

    @torch.inference_mode()
    def one():
        means, ctx, _, packed_pos, _, _, q = codec._prior0(p, z)
        y_hat = torch.zeros((1,) + p["y"] + (ch_y,), dtype=torch.float32,
                            device=device)
        for k in range(4):
            y_q = expand_from_pos(packed_pos, pad, p["n_cand"]).reshape(cand)
            out = codec._step(p, k, y_q, means, y_hat, ctx)
            if k < 3:
                y_hat, means, _, packed_pos, _, _ = out
            else:
                y_hat = out
        return codec._synthesis(y_hat, q, qp, h, w)

    x = sync_free(device, one)            # warm
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        x = sync_free(device, one)
    sync(device)
    return (time.perf_counter() - t0) * 1000 / iters, x


def device_decode_video(codec, h, w, qp=None, iters=3):
    """The HT decode chain per chunk on zero symbol buffers (adaptor with
    memory, prior, the single-pass steps or the ladder's rungs, the
    decoder feature and the recon heads), threading its own DPB from the
    codec's (which must hold a memory: run a real decode first) and
    leaving the codec's untouched; no entropy coder.  Host syncs are an
    error on the card.  Returns (ms per chunk over `iters` timed chains
    after a warm one, the last chain's frames)."""
    device = codec.device
    if codec.memory is None:
        raise ValueError("run a real decode first (sets the DPB)")
    p = codec._plan(h, w)
    zh, zw = p["z"]
    ch_y, steps, n_cand = codec.cfg.ch_y, codec.steps, p["n_cand"]
    qp = min(QP, codec.cfg.qp_num - 1) if qp is None else qp
    z = torch.zeros((1, zh, zw, codec.cfg.ch_z), dtype=torch.int8,
                    device=device)
    cap = steps * n_cand if codec.single_pass else n_cand
    pad = torch.zeros((min(1 << 16, cap),), dtype=torch.int8, device=device)
    cand = (1,) + p["cand"] + (p["cand_ch"],)

    @torch.inference_mode()
    def one(mem, ref):
        mem, ctx = codec.model.adaptor_m(mem, ref)
        _, q_dec, means, spctx, _, packed_pos, _, _ = codec._prior(
            p, z, mem, qp)
        y_hat = torch.zeros((1,) + p["y"] + (ch_y,), dtype=torch.float32,
                            device=device)
        if codec.single_pass:
            y_qs = expand_from_pos(packed_pos, pad,
                                   steps * n_cand).reshape((steps,) + cand)
            for k in range(steps):
                y_hat, means = codec._step(p, k, y_qs[k], means, y_hat,
                                           spctx)
        else:
            for k in range(steps):
                y_q = expand_from_pos(packed_pos, pad, n_cand).reshape(cand)
                out = codec._step_ladder(p, k, y_q, means, y_hat, spctx)
                if k < steps - 1:
                    y_hat, means, _, packed_pos, _, _ = out
                else:
                    y_hat = out
        feature = codec._feature(y_hat, q_dec, ctx, qp)
        return codec._recon(feature, qp, h, w), mem, feature

    x, mem, ref = sync_free(device, lambda: one(codec.memory,
                                                codec.ref_feature))  # warm
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        x, mem, ref = sync_free(device, lambda: one(mem, ref))
    sync(device)
    return (time.perf_counter() - t0) * 1000 / iters, x


def _mismatch(metric):
    rec = {"metric": metric, "value": 0.0, "unit": "fps",
           "error": "round-trip mismatch"}
    print(json.dumps(rec), flush=True)
    return rec


def _frames_on(device, frames, h, w, n):
    """The first n of `frames` ((h, w, 3) or (1, h, w, 3) arrays or
    tensors), or make_frames(h, w, n) from seed 0 when None, as (1, h, w,
    3) float32 tensors on `device`."""
    if frames is None:
        frames = make_frames(h, w, n, np.random.default_rng(0))
    return [torch.as_tensor(f).to(device, torch.float32).reshape(1, h, w, 3)
            for f in frames[:n]]


def bench_dmci(h, w, res="1080p", model_path=None, device_ec=False,
               device="cuda", cfg=None, n=8, warmup=1, iters=3, frames=None):
    """scripts/bench_variants.py:117-191 on the port: prints and returns
    the variant's JSON record.  frames: the images to code (make_frames'
    from seed 0 when None; the first 8 of bench_ht's are the same)."""
    device = check_device(device)
    codec, tag = dmci_codec(device, model_path, device_ec, cfg)
    frames = _frames_on(device, frames, h, w, n)
    sync(device)
    qp = min(QP, codec.cfg.qp_num - 1)   # trained small cfgs have 16 QPs

    enc_times, dec_times = [], []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        results = codec.compress_many(frames, [qp] * n)
        sync(device)
        t1 = time.perf_counter()

        t2 = time.perf_counter()
        outs = codec.decompress_many([r["bit_stream"] for r in results],
                                     [qp] * n, h, w,
                                     [r["ec_parallel"] for r in results])
        sync(device)
        t3 = time.perf_counter()
        print(f"# dmci iter {i}: {n}f enc {(t1-t0)*1000:.0f} ms "
              f"dec {(t3-t2)*1000:.0f} ms", file=sys.stderr, flush=True)
        if i >= warmup:
            enc_times.append((t1 - t0) / n)
            dec_times.append((t3 - t2) / n)
        if not all(torch.equal(r["x_hat"], o["x_hat"])
                   for r, o in zip(results, outs)):
            return _mismatch(f"dmci_{res}_encdec_fps")
    t_enc, t_dec = float(np.mean(enc_times)), float(np.mean(dec_times))
    dev_ms, _ = device_decode_image(codec, h, w)
    fps = 1.0 / (t_enc + t_dec)
    bpp = sum(len(r["bit_stream"]) for r in results) * 8.0 / (h * w * n)
    rec = {"metric": f"dmci{tag}_{res}_encdec_fps",
           "value": round(fps, 3), "unit": "fps",
           # the published baseline is 1080p-only
           "vs_baseline": round(fps / UF_INTRA_A100_FPS, 4)
           if res == "1080p" and not tag else None,
           "enc_fps": round(1.0 / t_enc, 1),
           "dec_fps": round(1.0 / t_dec, 1),
           "dec_device_fps": round(1000.0 / dev_ms, 1),
           "bpp": round(bpp, 4)}
    print(json.dumps(rec), flush=True)
    return rec


def bench_ht(h, w, variant, res="1080p", model_path=None, device_ec=False,
             device="cuda", cfg=None, n_chunks=6, warmup=2, iters=3,
             frames=None):
    """scripts/bench_variants.py:194-273 on the port: prints and returns
    the variant's JSON record.  frames: the frames to code (make_frames'
    from seed 0 when None)."""
    device = check_device(device)
    codec, tag = ht_codec(device, variant, model_path, device_ec, cfg)
    fd = codec.frame_delay
    frames = _frames_on(device, frames, h, w, n_chunks * fd)
    chunks = [torch.cat(frames[ci * fd:(ci + 1) * fd], dim=-1)
              for ci in range(n_chunks)]
    intra = chunks[0][..., :3].contiguous()
    sync(device)
    qp = min(QP, codec.cfg.qp_num - 1)   # trained small cfgs have 16 QPs
    qps = [qp] * n_chunks
    n_frames = n_chunks * fd

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

        codec.clear_dpb()
        codec.add_ref_feature_from_frame(intra)
        sync(device)
        t2 = time.perf_counter()
        codec.decompress_sequence(streams, qps, h, w, ecs)
        sync(device)
        t3 = time.perf_counter()
        print(f"# {variant} iter {i}: {n_frames}f enc {(t1-t0)*1000:.0f} ms "
              f"dec {(t3-t2)*1000:.0f} ms", file=sys.stderr, flush=True)
        if i >= warmup:
            enc_times.append((t1 - t0) / n_frames)
            dec_times.append((t3 - t2) / n_frames)
        if not torch.equal(enc_ref, codec.ref_feature):
            return _mismatch(f"dmc_{variant}_{res}_encdec_fps")
    t_enc, t_dec = float(np.mean(enc_times)), float(np.mean(dec_times))
    dev_ms, _ = device_decode_video(codec, h, w)
    fps = 1.0 / (t_enc + t_dec)
    bpp = sum(len(s) for s in streams) * 8.0 / (h * w * n_frames)
    rec = {"metric": f"dmc_{variant}{tag}_{res}_encdec_fps",
           "value": round(fps, 3), "unit": "fps",
           # the published baseline is 1080p-only
           "vs_baseline": round(fps / RT_A100_FPS, 4)
           if res == "1080p" and not tag else None,
           "enc_fps": round(1.0 / t_enc, 1),
           "dec_fps": round(1.0 / t_dec, 1),
           "dec_device_fps": round(1000.0 * fd / dev_ms, 1),
           "bpp": round(bpp, 4)}
    print(json.dumps(rec), flush=True)
    return rec


def run_envelope(log, resolutions=ENVELOPE, variants=VARIANTS, extra=(),
                 timeout=ENVELOPE_TIMEOUT):
    """scripts/run_envelope.sh: one process of this module per (variant,
    resolution), each cut at `timeout` seconds (rc 124), its output
    appended to `log` (emptied first) between the script's markers.
    `extra`: more arguments for each run (--device_ec, --device ...).
    Returns {(variant, res): exit code}."""
    env = module_env()
    rcs = {}
    with open(log, "w") as f:
        for res in resolutions:
            f.write(f"=== RES {res} ===\n")
            f.flush()
            for v in variants:
                cmd = [sys.executable, "-m", MODULE, v, "--res", res, *extra]
                try:
                    rc = subprocess.run(cmd, stdout=f,
                                        stderr=subprocess.STDOUT, env=env,
                                        timeout=timeout).returncode
                except subprocess.TimeoutExpired:
                    rc = 124
                rcs[(v, res)] = rc
                f.write(f"--- done {v} {res} rc={rc} ---\n")
                f.flush()
        f.write("=== ENVELOPE COMPLETE ===\n")
    return rcs


def card_note():
    """The default artifact note: the protocol, and the card with its
    power limit as nvidia-smi reports them (`no card` without one)."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "no card"
    return (f"per-variant speed on {card} (protocol: dcvc_tpu_torch/bench.py"
            " — skip_thres 0.15, warm-up discarded, bit-exact round-trip "
            "gate; dec_device_fps = decode device compute with host entropy "
            "hops removed; _devec = K2 on-device entropy decode, zero "
            "blocking host hops)")


def collect_envelope(log, out, note=None):
    """scripts/collect_envelope.py: the JSON lines of an envelope log (the
    last line wins per metric) with the protocol note, written to `out`.
    Returns the artifact."""
    results = {}
    with open(log, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "metric" in rec:
                results[rec["metric"]] = rec
    art = {"note": card_note() if note is None else note,
           "results": results}
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(f"{len(results)} metrics -> {out}")
    return art


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=[],
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--res", default="1080p", choices=list(RESOLUTIONS))
    ap.add_argument("--model_path", default=None,
                    help="trained DMCI checkpoint")
    ap.add_argument("--model_path_p", default=None,
                    help="trained HT checkpoint")
    ap.add_argument("--device_ec", action="store_true",
                    help="decode on the card (K2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codecs (cuda or cpu)")
    ap.add_argument("--envelope", metavar="LOG", default=None,
                    help="run every resolution of the envelope, one "
                         "process each, into LOG")
    ap.add_argument("--collect", nargs=2, metavar=("LOG", "OUT"),
                    default=None, help="gather LOG's JSON lines into OUT")
    ap.add_argument("--note", default=None, help="the artifact's note")
    args = ap.parse_args(argv)
    which = args.variants or list(VARIANTS)
    if set(which) - set(VARIANTS):
        ap.error(f"variants: any of {', '.join(VARIANTS)}")
    if args.collect:
        collect_envelope(*args.collect, note=args.note)
        return 0
    if args.envelope:
        extra = ["--device", args.device]
        for flag in ("model_path", "model_path_p"):
            if getattr(args, flag):
                extra += [f"--{flag}", getattr(args, flag)]
        if args.device_ec:
            extra.append("--device_ec")
        rcs = run_envelope(args.envelope, variants=which, extra=extra)
        return 0 if all(rc == 0 for rc in rcs.values()) else 1
    h, w = RESOLUTIONS[args.res]
    recs = []
    if "dmci" in which:
        recs.append(bench_dmci(h, w, args.res, args.model_path,
                               args.device_ec, args.device))
    for v in ("htl", "hts"):
        if v in which:
            recs.append(bench_ht(h, w, v, args.res, args.model_path_p,
                                 args.device_ec, args.device))
    return 1 if any("error" in r for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
