"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from their sources, with K2's
cycle-counting build (-DK2_CLOCKS), the three nvcc runs started together
(dcvc_tpu_torch/csrc/fused_dcb.cu, K1, and csrc/rans_decode.cu, K2;
sm_90a).  K1 is a chain of launches whose GEMMs
run on one wgmma/TMA core: it prints each kernel of K1's library with its
count of HGMMA (wgmma) and UTMALDG (TMA load) instructions from
`cuobjdump -sass`, and fails if a GEMM kernel has none or any HMMA
(mma.sync) is left.  Holds K1 against its plain PyTorch
version at the edge-case shapes of tests/test_fused_dcb.py, and K2 against
its plain version and the host decoder on the fixtures of
tests/test_device_decode.py / tests/test_pallas_decode.py (1/2/3/5/8
lanes, escapes, a count below the lane count and of 0, z -> y -> y
threading).  Checks the stages of the three full-width models (DMCI, HTS,
HTL) in bf16 on the card against float32 on the CPU.  Then it drives the
main path, one part at a time, each with the launch counts set to 0 just
before it and read just after, recording every K1 launch's shape and
every K2 launch's inputs:
  - DMCICodec (full published width, bf16, seeded random weights):
    compress -> bytes -> decompress on 1080p frames at two QPs and a 720p
    frame, and each stream decoded again on the device (device_ec, K2);
  - DMCI -> DMCHTCodec at HTS_CONFIG (init_scale 0.5): three 8-frame
    chunks at 1080p (memory reset on the second) and one at 720p, each
    decoded through the host coder and on the device;
  - DMCI -> DMCHTCodec at HTL_CONFIG (the ladder codec), the same chunks.
Every device decode runs under torch.cuda.set_sync_debug_mode("error")
once its lanes are uploaded: a host sync fails it.  Last, both forms of K1 are held against their plain
versions and timed at every distinct shape the main path launched them
at (and, at the three heaviest, each launch of the chain is timed by
torch.profiler), and every K2 call of the main path is replayed against
its plain version and through its cycle-counting build, and timed.
It fails, with a non-zero exit code, if the card is missing, a kernel does
not build or launch or disagrees with its plain version, the main path did
not launch the kernels as often as derived, a reconstruction or final DPB
is not bit-exact between encoder, host-coder decode and device decode, a
device decode syncs with the host, or two encodes give different streams.

Output: one line per phase (K2's: a JSON line of its time, ns per symbol
per lane, cycles per symbol and latency bound per main-path label, with
the SM clock under load); then a JSON line with the kernel table; the
card's name and power limit; and last {"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import json
import sys
import time

import numpy as np
import torch

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.kernels import rans_decode as K2
from dcvc_tpu_torch.models.dmc_ht import DMCHT, HTL_CONFIG, HTS_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, DMCIConfig
from dcvc_tpu_torch.kernels._build import library_path
from dcvc_tpu_torch.perf_probe import K1_GEMMS, K1_KERNELS, K2Log, Launch, \
    LaunchLog, block_inputs, cuda_ms, k1_bound_ms, k1_launch_flops, \
    k2_clock_summary, k2_fixtures, k2_lane_escapes, k2_lane_sizes, \
    k2_latency_bound_ms, make_sequence, max_sm_clock_mhz, nvidia_smi, \
    profile_launches, run_k2_case, sass_counts, smooth_frame
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec

K1_SOURCE = "dcvc_tpu_torch/csrc/fused_dcb.cu"
K2_SOURCE = "dcvc_tpu_torch/csrc/rans_decode.cu"
REPLACES = {
    "fused_dcb": "dcvc_tpu/kernels/fused_dcb.py:66",
    # the stacked form: _fused_dcb_stacked (its pallas_call at :210),
    # entry fused_dcb_stacked (:274)
    "fused_dcb_stacked": "dcvc_tpu/kernels/fused_dcb.py:164",
}
# K2: _decode_kernel, its pallas_call at :267 (make_decode_fn_pallas :232)
K2_REPLACES = "dcvc_tpu/rans/pallas_decode.py:75"

# the shape cases of tests/test_fused_dcb.py (W=18, dcb2, shortcut): not
# on the main path, checked first
TEST_SHAPES = [
    Launch("fused_dcb", 1, 8, 16, 128, 128, 128, False, False, False),
    Launch("fused_dcb", 1, 8, 18, 256, 128, 128, True, False, False),
    Launch("fused_dcb", 1, 6, 16, 128, 128, 64, False, False, False),
    Launch("fused_dcb", 1, 4, 16, 128, 128, 128, False, True, False),
]
# Tolerance of the kernel against the plain version, both in bfloat16:
# each rounds to bf16 (2^-9 relative) at several points, the plain version
# after each of its ~12 ops and the kernel at its 5 cast points, so the
# two may differ by a few bf16 steps of the output's magnitude.  Allowed:
# 2^-6 of the largest |output| (4 bf16 steps at the peak), per stack entry.
K1_REL_TOL = 2.0 ** -6
# Stage outputs of the full-width model in bf16 on the card against the
# same (bf16-valued) weights in float32 on the CPU: relative RMS error.
# ~40 successive bf16 roundings at 2^-9 each accumulate to ~1-2%
# (phase_stages also admits twice the plain bf16 version's error).
STAGE_REL_TOL = 5e-2
STAGE_QP = 32
# K1 launches of one DMCI encode / decode
ENCODE_LAUNCHES, DECODE_LAUNCHES = 42, 32
# main-path frames: (height, width, qp, seed); 720p gives the odd 45x80
# y grid
CODEC_CASES = [(1080, 1920, 0, 0), (1080, 1920, 32, 0), (720, 1280, 32, 1)]
# K2 launches of one DMCI device decode: z, then 4 rungs
DMCI_K2_LAUNCHES = 5
# video main paths: (height, width, qp, seed, reset flag of each chunk),
# and the launches derived from models/dmc_ht.py: K1 (S = 1) per chunk
# encode / decode, later chunk and right after the intra frame or a reset
# (which runs FA_I instead of FA_M); stacked launches per recon (decode,
# encode with recon=True) and per reset (the last frame's head); K2
# launches per device decode
VIDEO = {
    # HTS: FA_I 4 blocks, FA_M 6; recon trunk + 3 head stacks; one y call
    "HTS": {"cfg": HTS_CONFIG,
            "cases": [(1080, 1920, 32, 2, (False, True, False)),
                      (720, 1280, 32, 3, (False,))],
            "encode": 46, "decode": 37, "first_encode": 44,
            "first_decode": 35, "recon": 4, "k2": 2},
    # HTL: FA_I 3, FA_M 10, encoder 7, decoder 11, FX 2; 5 head stacks, no
    # trunk; z + 4 y rungs
    "HTL": {"cfg": HTL_CONFIG,
            "cases": [(1080, 1920, 32, 4, (False, True, False)),
                      (720, 1280, 32, 5, (False,))],
            "encode": 52, "decode": 42, "first_encode": 45,
            "first_decode": 35, "recon": 5, "k2": 5},
}


def log(*args):
    print(*args, flush=True)


def check_launch(key, gen, dev):
    """K1 (either form) against its plain version on random bf16 inputs at
    the shape of one launch, each stack entry held to K1_REL_TOL of its
    own peak; returns (max abs error, kernel ms, plain ms)."""
    x, p, run, ref = block_inputs(key, gen, dev)
    out = run()
    torch.cuda.synchronize()
    plain = ref(x, p)
    plain32 = ref(x.float(), {k: v.float() for k, v in p.items()})
    if key.kind == "fused_dcb":            # as a stack of one entry
        out, plain, plain32 = out[None], plain[None], plain32[None]
    errs = [(o.float() - q.float()).abs().max().item()
            for o, q in zip(out, plain)]
    peaks = [q.abs().max().item() for q in plain32]
    err32 = (out.float() - plain32).abs().max().item()
    plain_err32 = (plain.float() - plain32).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and out.shape == plain.shape \
        and all(e <= K1_REL_TOL * pk for e, pk in zip(errs, peaks))
    t_k = cuda_ms(run)
    t_p = cuda_ms(lambda: ref(x, p))
    log(f"K1 {key}: max_abs_err={max(errs)} tol={K1_REL_TOL * min(peaks)}"
        f"..{K1_REL_TOL * max(peaks)} (vs f32 plain: kernel {err32}, bf16 "
        f"plain {plain_err32}) kernel_ms={t_k} plain_ms={t_p}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at {key}")
    return max(errs), t_k, t_p


def phase_sass():
    """Each kernel of K1's built library with its HGMMA (wgmma), UTMALDG
    (TMA load) and HMMA (mma.sync) instructions, from cuobjdump -sass.
    Fails unless every GEMM kernel of the chain has HGMMA and UTMALDG, the
    dw kernel is there, and no kernel has an HMMA."""
    counts = sass_counts(library_path("fused_dcb.cu"))
    log("K1 SASS, kernel: HGMMA UTMALDG HMMA: " + "; ".join(
        f"{k}: {v['HGMMA']} {v['UTMALDG']} {v['HMMA']}"
        for k, v in sorted(counts.items())))
    bases = {k.split("<")[0] for k in counts}
    bad = [k for k, v in counts.items() if k.split("<")[0] in K1_GEMMS
           and not (v["HGMMA"] and v["UTMALDG"])]
    bad += [k for k, v in counts.items() if v["HMMA"]]
    if bad or not bases >= set(K1_KERNELS):
        raise AssertionError(f"K1's SASS: kernels without wgmma / TMA or "
                             f"with mma.sync {bad}, kernels {sorted(bases)}")


def phase_launch_profile(heavy, total, gen, dev):
    """Each launch of K1's chain at the `heavy` shapes: device ms per call
    by kernel name (torch.profiler) and its TFLOP/s."""
    for key in heavy:
        _, _, run, _ = block_inputs(key, gen, dev)
        ms = profile_launches(run)
        flops = k1_launch_flops(key)
        parts = []
        for name in K1_KERNELS:
            if name not in flops:
                continue
            t = ms.get(name)
            parts.append(f"{name} {t} ms {flops[name] / t / 1e9} TFLOP/s"
                         if t else f"{name} not measured")
        log(f"K1 launches at {key} (main-path launches {total[key]}; "
            f"device ms per call, torch.profiler): " + "; ".join(parts))


def phase_edge_shapes(dev):
    """K1 against its plain version at the edge cases of the JAX package's
    tests (a partial tile, dcb2, the shortcut)."""
    gen = torch.Generator().manual_seed(1)
    for key in TEST_SHAPES:
        check_launch(key, gen, dev)


def phase_k2_fixtures(dev):
    """K2 against its plain version and the host decoder on the fixtures
    of the JAX package's decode tests: every call's symbols equal, zeros
    past the count, and the final lane states equal."""
    for case in k2_fixtures():
        st_k, outs_k = run_k2_case(case, dev, K2.rans_decode)
        torch.cuda.synchronize()
        st_p, outs_p = run_k2_case(case, dev, K2.rans_decode_reference)
        ok = (torch.equal(st_k["st"], st_p["st"])
              and torch.equal(st_k["ptr"], st_p["ptr"]))
        for (_, count, _, _, want), out_k, out_p in zip(case[3], outs_k,
                                                        outs_p):
            got = out_k.cpu().numpy()
            ok = ok and torch.equal(out_k, out_p) and np.array_equal(
                got[:count], want) and not got[count:].any()
        log(f"K2 fixture {case[0]} ({len(case[3])} calls): "
            f"{'equal to plain and host' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"K2 disagrees on the fixture {case[0]}")


def phase_kernels(dev, launch_log, launches):
    """Both forms of K1 against their plain versions at every distinct
    shape the main path launched them at.  Returns the kernel rows of the
    JSON table: ms / plain_ms is the device time of the main path's
    launches at the per-shape medians, bound_ms the sum over them of each
    launch's roofline bound (perf_probe.k1_bound_ms)."""
    gen = torch.Generator().manual_seed(0)
    total = launch_log.totals()
    rows = {kind: {"name": kind, "route": "cuda", "source": K1_SOURCE,
                   "replaces": REPLACES[kind], "launches": launches[kind],
                   "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": None, "library_ms": None}
            for kind in REPLACES}
    bound_parts = {kind: [0.0, 0.0] for kind in REPLACES}
    times = {}
    for key in sorted(total):
        err, t_k, t_p = check_launch(key, gen, dev)
        flop_ms, byte_ms = k1_bound_ms(key)
        log(f"  main-path launches: {total[key]}; bound "
            f"{max(flop_ms, byte_ms)} ms (FLOPs {flop_ms}, bytes {byte_ms})")
        times[key] = (t_k, t_p)
        row = rows[key.kind]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += total[key] * t_k
        row["plain_ms"] += total[key] * t_p
        row["bound_ms"] += total[key] * max(flop_ms, byte_ms)
        bound_parts[key.kind][0] += total[key] * flop_ms
        bound_parts[key.kind][1] += total[key] * byte_ms
    heavy = sorted(total, key=lambda k: -total[k] * times[k][0])[:3]
    phase_launch_profile(heavy, total, gen, dev)
    for kind, (flop_ms, byte_ms) in bound_parts.items():
        rows[kind]["bound_by"] = ("operations" if flop_ms >= byte_ms
                                  else "bytes")
    for label, counts in launch_log.calls:
        sums = {kind: [0, 0.0, 0.0, 0.0] for kind in REPLACES}
        for key, n in counts.items():
            s = sums[key.kind]
            s[0] += n
            s[1] += n * times[key][0]
            s[2] += n * times[key][1]
            s[3] += n * max(k1_bound_ms(key))
        log(f"K1 device time of {label} (per-shape medians x launches): "
            + "; ".join(f"{kind} launches={n} kernel_ms={k} plain_ms={p} "
                        f"bound_ms={b}"
                        for kind, (n, k, p, b) in sums.items() if n))
    return [rows[kind] for kind in REPLACES]


def phase_k2(k2_log, launches):
    """Every K2 call of the main path replayed on its recorded inputs:
    the kernel against its plain version (symbols and lane states equal),
    both timed (the kernel with CUDA events, the plain version, which runs
    on the host, by the host clock), and its cycle-counting build
    (-DK2_CLOCKS, equal symbols) for the SM clock under load and where a
    symbol's cycles go.  Prints one JSON line of K2 per main-path label.
    Returns K2's row of the JSON table; bound_ms is the latency bound of
    perf_probe.k2_latency_bound_ms (symbols and escapes, from the plain
    version's symbols) at the SM clock under load."""
    per_label = collections.defaultdict(lambda: {
        "launches": 0, "symbols": 0, "escapes": 0, "longest_lane_symbols": 0,
        "kernel_ms": 0.0, "plain_ms": 0.0, "calls": [], "escape_counts": [],
        "clocks": []})
    for call in k2_log.calls:
        args = call.args()
        st_k, out_k = K2.rans_decode_launch(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, out_p = K2.rans_decode_reference(*args)
        t_p = 1e3 * (time.perf_counter() - t0)
        st_c, out_c, clk = K2.rans_decode_clocks(*args)
        if not (torch.equal(out_k, out_p)
                and torch.equal(st_k["st"], st_p["st"])
                and torch.equal(st_k["ptr"], st_p["ptr"])
                and torch.equal(out_c, out_k)
                and torch.equal(st_c["st"], st_k["st"])
                and torch.equal(st_c["ptr"], st_k["ptr"])):
            raise AssertionError(f"K2 (or its cycle-counting build) "
                                 f"disagrees with its plain version on a "
                                 f"call of {call.label} {call.signature()}")
        t_k = cuda_ms(lambda: K2.rans_decode_launch(*args), iters=3,
                      warmup=1)
        esc = k2_lane_escapes(call, out_p)
        rec = per_label[call.label]
        rec["launches"] += 1
        rec["symbols"] += int(call.count)
        rec["escapes"] += sum(esc)
        rec["longest_lane_symbols"] += k2_lane_sizes(
            int(call.count), call.streams.shape[0])[-1]
        rec["kernel_ms"] += t_k
        rec["plain_ms"] += t_p
        rec["calls"].append(call)
        rec["escape_counts"].append(esc)
        rec["clocks"].append(clk)
    calls = [c for r in per_label.values() for c in r["calls"]]
    escapes = [e for r in per_label.values() for e in r["escape_counts"]]
    clocks = k2_clock_summary([c for r in per_label.values()
                               for c in r["clocks"]])
    clock = clocks["sm_clock_mhz"]
    max_clock = max_sm_clock_mhz()
    table = {}
    for label, r in per_label.items():
        table[label] = {
            k: r[k] for k in ("launches", "symbols", "escapes",
                              "longest_lane_symbols", "kernel_ms",
                              "plain_ms")}
        table[label]["ns_per_symbol_per_lane"] = \
            1e6 * r["kernel_ms"] / max(r["longest_lane_symbols"], 1)
        table[label]["bound_ms"] = k2_latency_bound_ms(
            r["calls"], clock, r["escape_counts"])
        table[label]["cycles_per_symbol"] = k2_clock_summary(
            r["clocks"])["cycles_per_symbol"]
    ms = sum(r["kernel_ms"] for r in per_label.values())
    plain_ms = sum(r["plain_ms"] for r in per_label.values())
    bound = k2_latency_bound_ms(calls, clock, escapes)
    bound_old = k2_latency_bound_ms(calls, max_clock)
    longest = sum(r["longest_lane_symbols"] for r in per_label.values())
    log(json.dumps({"k2_per_label": table,
                    "k2_cycles_build": {k: v for k, v in clocks.items()},
                    "sm_clock_mhz_under_load": clock,
                    "max_sm_clock_mhz": max_clock,
                    "ns_per_symbol_per_lane": 1e6 * ms / max(longest, 1),
                    "bound_ms": bound,
                    "bound_ms_symbols_only_max_clock": bound_old}))
    log(f"K2 main path: {len(calls)} calls equal to plain (and the "
        f"cycle-counting build equal to the kernel); kernel_ms={ms} "
        f"plain_ms={plain_ms}; latency bound {bound} ms (symbols and "
        f"escapes at the {clock} MHz SM clock under load; symbols only at "
        f"{max_clock} MHz: {bound_old} ms)")
    return {"name": "rans_decode", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None}


def rel_rms(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def stage_outputs(model, x, qp, z_int8, ctx, y_hat):
    """analysis, prior0, prior_step(1) and synthesis of `model` on a 64x64
    input; the shared inputs (z, ctx, y_hat) are the same for every model,
    moved to its device and type."""
    dev, dt = model.q_scale_enc.device, model.dtype
    with torch.inference_mode():
        y, _ = model.analysis(x.to(dev, dt), qp)
        scales0, means0, ctx0 = model.prior0(z_int8.to(dev), 4, 4)
        scales1, means1 = model.prior_step(ctx.to(dev, dt), y_hat.to(dev), 1)
        x_hat = model.synthesis(y_hat.to(dev), qp, 64, 64)
    return {"analysis y": y, "prior0 scales": scales0,
            "prior0 means": means0, "prior0 ctx": ctx0,
            "prior_step scales": scales1, "prior_step means": means1,
            "synthesis x_hat": x_hat}


def phase_stages(codec):
    """The full-width model's stages in bf16 on the card (every DCB through
    K1) against the same bf16-valued weights in float32 on the CPU (plain
    DCB).  A stage passes if its relative RMS error is within
    STAGE_REL_TOL, or within twice that of the plain version in bf16 (on
    the CPU): with random weights the decoder's activations grow through
    its 14 residual blocks, and bf16 error grows with them."""
    gpu = codec.model
    state = {k: v.float().cpu() for k, v in gpu.state_dict().items()}
    cpu32, cpu16 = DMCI(codec.cfg), DMCI(codec.cfg)
    cpu32.load_state_dict(state)
    cpu16.load_state_dict(state)
    cpu16.to(torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(1, 64, 64, 3, generator=gen) - 0.5
    qp = STAGE_QP
    with torch.inference_mode():
        y, z_int8 = cpu32.analysis(x, qp)
        ctx = cpu32.prior0(z_int8, 4, 4)[2]
    y_hat = torch.round(y)
    ref = stage_outputs(cpu32, x, qp, z_int8, ctx, y_hat)
    got = stage_outputs(gpu, x, qp, z_int8, ctx, y_hat)
    plain = stage_outputs(cpu16, x, qp, z_int8, ctx, y_hat)
    compare_stages("DMCI", ref, got, plain)


def compare_stages(name, ref, got, plain):
    """Each stage output on the card (got) and of the plain bf16 model on
    the CPU (plain) against float32 on the CPU (ref), by relative RMS."""
    errs = {k: (rel_rms(got[k], ref[k]), rel_rms(plain[k], ref[k]))
            for k in ref}
    log(f"{name} stages vs f32 CPU, relative RMS (K1 path on the card, "
        f"plain bf16 on the CPU; tol {STAGE_REL_TOL} or 2x plain): "
        + json.dumps(errs))
    bad = [k for k, (e, e_plain) in errs.items()
           if not (e <= STAGE_REL_TOL or e <= 2 * e_plain)]
    if bad:
        raise AssertionError(f"{name} stage outputs disagree with the CPU: "
                             f"{bad}")


def stage_outputs_video(model, x, ref, feature, memory, z_int8, spctx,
                        y_hat, qp):
    """Every HTS / HTL stage method of `model` on a 64x64 chunk (/8 grid
    8x8, y grid 4x4), each on the same shared inputs, moved to the model's
    device and type.  recon_frames and reset_feature run the stacked
    kernel on the card."""
    dev, dt = model.q_encoder.device, model.dtype

    def m(t):
        return t.to(dev, dt)
    with torch.inference_mode():
        mem_i, ctx_i = model.adaptor_i(m(ref))
        mem_m, ctx_m = model.adaptor_m(m(memory), m(feature))
        y, _ = model.analysis(m(x), m(feature), qp)
        q_enc, q_dec, scales, means, ctx0 = model.prior0(
            z_int8.to(dev), m(memory), qp, 4, 4)
        step = model.prior_step(m(spctx), y_hat.to(dev), 1)
        feat = model.synthesis_feature(y_hat.to(dev), m(feature), qp)
        frames = model.recon_frames(m(feature), qp, 64, 64)
        seed = model.reset_feature(m(feature))
    out = {"adaptor_i memory": mem_i, "adaptor_i ctx": ctx_i,
           "adaptor_m memory": mem_m, "adaptor_m ctx": ctx_m,
           "analysis y": y, "prior0 q_dec": q_dec, "prior0 scales": scales,
           "prior0 means": means, "prior0 ctx": ctx0,
           "synthesis_feature": feat, "recon_frames": frames,
           "reset_feature": seed}
    if model.cfg.is_hts:
        out["prior_step means"] = step
    else:
        out["prior_step scales"], out["prior_step means"] = step
    return out


def phase_stages_video(name, codec):
    """The full-width video model's stages in bf16 on the card (every DCB
    through K1, the recon heads through its stacked form) against the
    same bf16-valued weights in float32 on the CPU; the rule of
    phase_stages."""
    gpu = codec.model
    state = {k: v.float().cpu() for k, v in gpu.state_dict().items()}
    cpu32, cpu16 = DMCHT(codec.cfg), DMCHT(codec.cfg)
    cpu32.load_state_dict(state)
    cpu16.load_state_dict(state)
    cpu16.to(torch.bfloat16)
    c = codec.cfg
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(1, 64, 64, 3 * c.frame_delay, generator=gen) - 0.5
    ref = torch.rand(1, 8, 8, c.ch_src_intra, generator=gen) - 0.5
    feature = torch.randn(1, 8, 8, c.ch_d, generator=gen)
    memory = torch.randn(1, 8, 8, c.ch_m, generator=gen)
    qp = STAGE_QP
    with torch.inference_mode():
        y, z_int8 = cpu32.analysis(x, feature, qp)
        spctx = cpu32.prior0(z_int8, memory, qp, 4, 4)[4]
    y_hat = torch.round(y)
    args = (x, ref, feature, memory, z_int8, spctx, y_hat, qp)
    compare_stages(name, stage_outputs_video(cpu32, *args),
                   stage_outputs_video(gpu, *args),
                   stage_outputs_video(cpu16, *args))


def counted(launch_log, label, fn):
    """fn() on a synchronised card, its launches recorded under `label`;
    returns (result, ms, S = 1 launches, stacked launches, K2 launches)."""
    n1, ns = K1.fused_dcb.launches, K1.fused_dcb_stacked.launches
    n2 = K2.rans_decode.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_log.call(label):
        out = fn()
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (out, ms, K1.fused_dcb.launches - n1,
            K1.fused_dcb_stacked.launches - ns, K2.rans_decode.launches - n2)


def no_sync(fn):
    """fn() with every host sync an error (set_sync_debug_mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def expect(tag, got, want):
    if got != want:
        raise AssertionError(f"{tag}: (S=1, stacked, K2) launches {got}, "
                             f"expected {want}")


def device_decode(codec, k2_log, label, launch_log, stream, ec, *args):
    """One device decode (device_ec) of `stream`: its lanes uploaded, then
    the decode under no_sync.  Returns counted()'s tuple."""
    codec.device_ec = True
    try:
        lanes = codec.upload_stream(stream, ec)
        k2_log.label = label
        return counted(launch_log, label, lambda: no_sync(
            lambda: codec.decompress(lanes, *args)["x_hat"]))
    finally:
        codec.device_ec = False


def phase_codec(codec, dev, launch_log, k2_log):
    """The main path's image half: DMCI round trips at 1080p (two QPs) and
    720p, cold then warm, then each stream decoded on the device (K2,
    sync-checked).  Returns the (S = 1, stacked, K2) launches derived for
    it, each call's checked."""
    derived = [0, 0, 0]
    for (h, w, qp, seed) in CODEC_CASES:
        x = smooth_frame(h, w, seed, dev)
        runs = []
        for run in ("cold", "warm"):
            tag = f"DMCI {w}x{h} qp={qp} {run}"
            res, enc_ms, e1, es, e2 = counted(launch_log, f"{tag} encode",
                                              lambda: codec.compress(x, qp))
            x_dec, dec_ms, d1, ds, d2 = counted(
                launch_log, f"{tag} decode", lambda: codec.decompress(
                    bytes(res["bit_stream"]), qp, h, w,
                    res["ec_parallel"])["x_hat"])
            x_enc = res["x_hat"]
            if x_dec.shape != (1, h, w, 3) or x_enc.shape != x_dec.shape:
                raise AssertionError(f"x_hat shape {tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError("non-finite reconstruction")
            if not torch.equal(x_enc, x_dec):
                raise AssertionError(f"{tag}: decoder x_hat differs from "
                                     f"the encoder's")
            expect(f"{tag} encode", (e1, es, e2), (ENCODE_LAUNCHES, 0, 0))
            expect(f"{tag} decode", (d1, ds, d2), (DECODE_LAUNCHES, 0, 0))
            derived[0] += ENCODE_LAUNCHES + DECODE_LAUNCHES
            runs.append((res, x_dec, e1, d1, enc_ms, dec_ms))
        if runs[0][0]["bit_stream"] != runs[1][0]["bit_stream"]:
            raise AssertionError(f"{h}p qp {qp}: two encodes of one frame "
                                 f"gave different streams")
        res, x_dec, n_enc, n_dec, enc_ms, dec_ms = runs[1]
        tag = f"DMCI {w}x{h} qp={qp}"
        x_dev, dev_ms, v1, vs, v2 = device_decode(
            codec, k2_log, f"{tag} device decode", launch_log,
            bytes(res["bit_stream"]), res["ec_parallel"], qp, h, w,
            res["ec_parallel"])
        if not (torch.equal(x_dev, res["x_hat"]) and torch.equal(x_dev,
                                                                  x_dec)):
            raise AssertionError(f"{tag}: the device decode's x_hat differs "
                                 f"from the encoder's / host decode's")
        expect(f"{tag} device decode", (v1, vs, v2),
               (DECODE_LAUNCHES, 0, DMCI_K2_LAUNCHES))
        derived[0] += DECODE_LAUNCHES
        derived[2] += DMCI_K2_LAUNCHES
        nbytes = len(res["bit_stream"])
        mse = torch.mean((x_dec - x) ** 2).item()
        psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
        log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (h * w)} "
            f"psnr={psnr} ec_parallel={res['ec_parallel']} bit_exact=True "
            f"launches enc={n_enc} dec={n_dec} device_dec={v1}+K2 {v2} "
            f"warm encode_ms={enc_ms} decode_ms={dec_ms} "
            f"device_decode_ms={dev_ms}")
    return tuple(derived)


def expected_launches(spec, resets, u, encode, recon):
    """(S = 1, stacked, K2) launches of chunk u's encode or (host-coder)
    decode; a device decode adds spec['k2'] K2 launches."""
    first = u == 0 or resets[u - 1]
    if encode:
        s1 = spec["first_encode"] if first else spec["encode"]
    else:
        s1 = spec["first_decode"] if first else spec["decode"]
    return s1, spec["recon"] * (int(resets[u]) + int(recon)), 0


def phase_video(name, dmci, codec, dev, launch_log, k2_log):
    """The main path's video half for one variant: the DMCI reconstruction
    of a sequence's first frame seeds the DMCHTCodec, which codes its
    8-frame chunks.  Encode pass 1 (recon=True) against a host-coder decode
    and a device decode (K2, every call sync-checked), each from a fresh
    DPB: every chunk's x_hat and the final DPB bit-exact; encode pass 2
    (recon=False, warm): the same streams.  Returns the (S = 1, stacked,
    K2) launches derived for it, each call's checked."""
    spec = VIDEO[name]
    derived = [0, 0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        for i in range(3):
            derived[i] += want[i]

    for (h, w, qp, seed, resets) in spec["cases"]:
        frames = make_sequence(h, w, 8 * len(resets), seed, dev)
        chunks = [torch.cat(frames[8 * u:8 * u + 8], dim=-1)
                  for u in range(len(resets))]
        label = f"{name} {w}x{h} qp={qp}"
        intra, _, i1, is_, i2 = counted(
            launch_log, f"{label} intra frame (DMCI encode)",
            lambda: dmci.compress(frames[0], qp)["x_hat"])
        tally(f"{label} intra frame", (i1, is_, i2), (ENCODE_LAUNCHES, 0, 0))

        def seeded():
            codec.clear_dpb()
            codec.add_ref_feature_from_frame(intra)

        def encode(recon):
            seeded()
            kind = "encode (recon)" if recon else "encode"
            runs = [counted(launch_log, f"{label} chunk {u} {kind}",
                            lambda: codec.compress(x, qp, rs, recon=recon))
                    for u, (x, rs) in enumerate(zip(chunks, resets))]
            return runs, codec.ref_feature

        enc1, dpb1 = encode(True)
        enc2, dpb2 = encode(False)
        seeded()
        dec = [counted(launch_log, f"{label} chunk {u} decode",
                       lambda: codec.decompress(
                           bytes(r[0]["bit_stream"]), qp, h, w,
                           r[0]["ec_parallel"], rs)["x_hat"])
               for u, (r, rs) in enumerate(zip(enc1, resets))]
        dpb_host = codec.ref_feature
        seeded()
        ddec = [device_decode(codec, k2_log,
                              f"{label} chunk {u} device decode",
                              launch_log, bytes(r[0]["bit_stream"]),
                              r[0]["ec_parallel"], qp, h, w,
                              r[0]["ec_parallel"], rs)
                for u, (r, rs) in enumerate(zip(enc1, resets))]
        dpb_dev = codec.ref_feature
        for u, rs in enumerate(resets):
            tag = f"{label} chunk {u} reset={int(rs)}"
            (r1, _, e1, s1, _), (r2, enc_ms, e2, s2, _) = enc1[u], enc2[u]
            x_dec, dec_ms, d1, ds, dk = dec[u]
            x_dev, dev_ms, v1, vs, vk = ddec[u]
            if x_dec.shape != (8, h, w, 3) or r1["x_hat"].shape != x_dec.shape:
                raise AssertionError(f"{tag}: x_hat shape "
                                     f"{tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError(f"{tag}: non-finite reconstruction")
            if not torch.equal(r1["x_hat"], x_dec):
                raise AssertionError(f"{tag}: decoder x_hat differs from "
                                     f"the encoder's")
            if not torch.equal(x_dev, x_dec):
                raise AssertionError(f"{tag}: the device decode's x_hat "
                                     f"differs from the host decode's")
            if r1["bit_stream"] != r2["bit_stream"]:
                raise AssertionError(f"{tag}: two encodes gave different "
                                     f"streams")
            tally(f"{tag} encode (recon)", (e1, s1, enc1[u][4]),
                  expected_launches(spec, resets, u, True, True))
            tally(f"{tag} encode", (e2, s2, enc2[u][4]),
                  expected_launches(spec, resets, u, True, False))
            tally(f"{tag} decode", (d1, ds, dk),
                  expected_launches(spec, resets, u, False, True))
            s1_, st_, _ = expected_launches(spec, resets, u, False, True)
            tally(f"{tag} device decode", (v1, vs, vk),
                  (s1_, st_, spec["k2"]))
            nbytes = len(r1["bit_stream"])
            src = torch.cat(frames[8 * u:8 * u + 8]).float()
            mse = torch.mean((x_dec - src) ** 2).item()
            psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
            log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (8 * h * w)} "
                f"psnr={psnr} ec_parallel={r1['ec_parallel']} "
                f"bit_exact=True launches enc(recon)={e1}+{s1} "
                f"enc={e2}+{s2} dec={d1}+{ds} device_dec={v1}+{vs}+K2 {vk} "
                f"warm encode_ms={enc_ms} encode_recon_ms={enc1[u][1]} "
                f"decode_ms={dec_ms} device_decode_ms={dev_ms}")
        if not all(torch.equal(dpb1, d) for d in (dpb2, dpb_host, dpb_dev)):
            raise AssertionError(f"{label}: a final DPB differs (encoder, "
                                 f"host decode, device decode)")
        log(f"{label}: final DPB equal on the encoder, the host decode and "
            f"the device decode {tuple(dpb1.shape)}")
    return tuple(derived)


def launch_counts():
    return (K1.fused_dcb.launches, K1.fused_dcb_stacked.launches,
            K2.rans_decode.launches)


def zero_launch_counts():
    K1.fused_dcb.launches = K1.fused_dcb_stacked.launches = 0
    K2.rans_decode.launches = 0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # one nvcc per library, started together: K1, K2 and K2's
    # cycle-counting build
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for build in [pool.submit(K1.load_kernel), pool.submit(K2.load_kernel),
                      pool.submit(K2.load_kernel, True)]:
            build.result()
    log(f"build: fused_dcb.cu, rans_decode.cu (and -DK2_CLOCKS) -> sm_90a "
        f"in {time.perf_counter() - t0:.3f} s")
    phase_sass()
    with torch.inference_mode():
        phase_edge_shapes(dev)
        phase_k2_fixtures(dev)

    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    video = {name: DMCHTCodec.init_random(
        torch.Generator().manual_seed(0), cfg=spec["cfg"], init_scale=0.5,
        skip_thres=0.15, dtype=torch.bfloat16, device=dev)
        for name, spec in VIDEO.items()}
    phase_stages(dmci)
    for name, codec in video.items():
        phase_stages_video(name, codec)

    # the main path, one part at a time, each with the counts set to 0
    # just before it and read just after
    launch_log, k2_log = LaunchLog(), K2Log()
    parts = [("DMCI", lambda: phase_codec(dmci, dev, launch_log, k2_log))]
    parts += [(f"DMCI seed + {name}",
               lambda name=name: phase_video(name, dmci, video[name], dev,
                                             launch_log, k2_log))
              for name in VIDEO]
    got, want = {}, {}
    with launch_log, k2_log:
        for part, run in parts:
            zero_launch_counts()
            want[part] = run()
            got[part] = launch_counts()
    log("main path launches (fused_dcb, fused_dcb_stacked, rans_decode): "
        + "; ".join(f"{part} {got[part]}, derived {want[part]}"
                    for part, _ in parts))
    totals = [sum(g[i] for g in got.values()) for i in range(3)]
    launches = {"fused_dcb": totals[0], "fused_dcb_stacked": totals[1]}
    recorded = collections.Counter()
    for key, n in launch_log.totals().items():
        recorded[key.kind] += n
    if got != want or recorded != launches \
            or len(k2_log.calls) != totals[2]:
        raise AssertionError(f"main path launches {got}, recorded "
                             f"{dict(recorded)} + {len(k2_log.calls)} K2, "
                             f"derived {want}")
    if min(totals) == 0:
        raise AssertionError("the main path skipped a kernel")

    with torch.inference_mode():
        rows = phase_kernels(dev, launch_log, launches)
        rows.append(phase_k2(k2_log, totals[2]))

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
