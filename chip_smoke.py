"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel (dcvc_tpu_torch/csrc/fused_dcb.cu, nvcc for
sm_90a), holds it against its plain PyTorch version at the edge-case
shapes of tests/test_fused_dcb.py, and checks the stages of both
full-width models in bf16 on the card against float32 on the CPU.  Then
it drives the main path, recording the shape of every kernel launch:
DMCICodec (full published width, bf16, seeded random weights) through
compress -> bytes -> decompress on 1080p frames at two QPs and a 720p
frame; then DMCI codes the first frame of a sequence, its reconstruction
seeds DMCHTCodec (HTS_CONFIG, bf16, init_scale 0.5), and HTS codes three
8-frame chunks at 1080p (memory reset on the second) and one at 720p.
Last, both forms of the kernel (one block, and the stacked form of the
HTS recon heads) are held against their plain versions and timed at
every distinct shape the main path launched them at.
It fails, with a non-zero exit code, if the card is missing, the kernel
does not build or launch, disagrees with its plain version, the main
path did not go through both forms of the kernel as often as derived, a
reconstruction or the final DPB is not bit-exact between encoder and
decoder, or two encodes give different streams.

Output: one line per phase; then a JSON line with the kernel table; the
card's name and power limit; and last {"ok": true, "device": {...}}.
"""

import collections
import json
import sys
import time

import torch

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.models.dmc_ht import DMCHT, HTS_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, DMCIConfig
from dcvc_tpu_torch.perf_probe import Launch, LaunchLog, block_inputs, \
    cuda_ms, make_sequence, nvidia_smi, smooth_frame
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec

K1_SOURCE = "dcvc_tpu_torch/csrc/fused_dcb.cu"
REPLACES = {
    "fused_dcb": "dcvc_tpu/kernels/fused_dcb.py:66",
    # the stacked form: _fused_dcb_stacked (its pallas_call at :210),
    # entry fused_dcb_stacked (:274)
    "fused_dcb_stacked": "dcvc_tpu/kernels/fused_dcb.py:164",
}

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
# HTS main path: (height, width, qp, seed, reset flag of each chunk)
HTS_CASES = [(1080, 1920, 32, 2, (False, True, False)),
             (720, 1280, 32, 3, (False,))]
# K1 launches of one HTS chunk (from models/dmc_ht.py): a later chunk's
# encode / decode, and a chunk's right after the intra frame or a reset,
# which runs FA_I's 4 blocks instead of FA_M's 6
HTS_ENCODE_LAUNCHES, HTS_DECODE_LAUNCHES = 46, 37
HTS_FIRST_ENCODE, HTS_FIRST_DECODE = 44, 35
# stacked launches of one recon (decode, encode with recon=True) and of a
# reset's last-frame head
RECON_LAUNCHES = 4


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


def phase_edge_shapes(dev):
    """K1 against its plain version at the edge cases of the JAX package's
    tests (a partial tile, dcb2, the shortcut)."""
    gen = torch.Generator().manual_seed(1)
    for key in TEST_SHAPES:
        check_launch(key, gen, dev)


def phase_kernels(dev, launch_log, launches):
    """Both forms of K1 against their plain versions at every distinct
    shape the main path launched them at.  Returns the kernel rows of the
    JSON table: ms / plain_ms is the device time of the main path's
    launches at the per-shape medians."""
    gen = torch.Generator().manual_seed(0)
    total = launch_log.totals()
    rows = {kind: {"name": kind, "route": "cuda", "source": K1_SOURCE,
                   "replaces": REPLACES[kind], "launches": launches[kind],
                   "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
            for kind in REPLACES}
    times = {}
    for key in sorted(total):
        err, t_k, t_p = check_launch(key, gen, dev)
        log(f"  main-path launches: {total[key]}")
        times[key] = (t_k, t_p)
        row = rows[key.kind]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += total[key] * t_k
        row["plain_ms"] += total[key] * t_p
    for label, counts in launch_log.calls:
        sums = {kind: [0, 0.0, 0.0] for kind in REPLACES}
        for key, n in counts.items():
            s = sums[key.kind]
            s[0] += n
            s[1] += n * times[key][0]
            s[2] += n * times[key][1]
        log(f"K1 device time of {label} (per-shape medians x launches): "
            + "; ".join(f"{kind} launches={n} kernel_ms={k} plain_ms={p}"
                        for kind, (n, k, p) in sums.items() if n))
    return [rows[kind] for kind in REPLACES]


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


def stage_outputs_hts(model, x, ref, feature, memory, z_int8, spctx, y_hat,
                      qp):
    """Every HTS stage method of `model` on a 64x64 chunk (/8 grid 8x8, y
    grid 4x4), each on the same shared inputs, moved to the model's device
    and type.  recon_frames and reset_feature run the stacked kernel on
    the card."""
    dev, dt = model.q_encoder.device, model.dtype

    def m(t):
        return t.to(dev, dt)
    with torch.inference_mode():
        mem_i, ctx_i = model.adaptor_i(m(ref))
        mem_m, ctx_m = model.adaptor_m(m(memory), m(feature))
        y, _ = model.analysis(m(x), m(feature), qp)
        q_enc, q_dec, scales, means, ctx0 = model.prior0(
            z_int8.to(dev), m(memory), qp, 4, 4)
        means1 = model.prior_step(m(spctx), y_hat.to(dev), 1)
        feat = model.synthesis_feature(y_hat.to(dev), m(feature), qp)
        frames = model.recon_frames(m(feature), qp, 64, 64)
        seed = model.reset_feature(m(feature))
    return {"adaptor_i memory": mem_i, "adaptor_i ctx": ctx_i,
            "adaptor_m memory": mem_m, "adaptor_m ctx": ctx_m,
            "analysis y": y, "prior0 q_dec": q_dec, "prior0 scales": scales,
            "prior0 means": means, "prior0 ctx": ctx0,
            "prior_step means": means1, "synthesis_feature": feat,
            "recon_frames": frames, "reset_feature": seed}


def phase_stages_hts(codec):
    """The full-width HTS model's stages in bf16 on the card (every DCB
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
    compare_stages("HTS", stage_outputs_hts(cpu32, *args),
                   stage_outputs_hts(gpu, *args),
                   stage_outputs_hts(cpu16, *args))


def counted(launch_log, label, fn):
    """fn() on a synchronised card, its launches recorded under `label`;
    returns (result, ms, S = 1 launches, stacked launches)."""
    n1, ns = K1.fused_dcb.launches, K1.fused_dcb_stacked.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_log.call(label):
        out = fn()
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (out, ms, K1.fused_dcb.launches - n1,
            K1.fused_dcb_stacked.launches - ns)


def expect(tag, got, want):
    if got != want:
        raise AssertionError(f"{tag}: (S=1, stacked) launches {got}, "
                             f"expected {want}")


def phase_codec(codec, dev, launch_log):
    """The main path's image half: DMCI round trips at 1080p (two QPs) and
    720p, cold then warm.  Returns the (S = 1, stacked) launches derived
    for it, each call's checked."""
    derived = 0
    for (h, w, qp, seed) in CODEC_CASES:
        x = smooth_frame(h, w, seed, dev)
        runs = []
        for run in ("cold", "warm"):
            tag = f"DMCI {w}x{h} qp={qp} {run}"
            res, enc_ms, e1, es = counted(launch_log, f"{tag} encode",
                                          lambda: codec.compress(x, qp))
            x_dec, dec_ms, d1, ds = counted(
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
            expect(f"{tag} encode", (e1, es), (ENCODE_LAUNCHES, 0))
            expect(f"{tag} decode", (d1, ds), (DECODE_LAUNCHES, 0))
            derived += ENCODE_LAUNCHES + DECODE_LAUNCHES
            runs.append((res, x_dec, e1, d1, enc_ms, dec_ms))
        if runs[0][0]["bit_stream"] != runs[1][0]["bit_stream"]:
            raise AssertionError(f"{h}p qp {qp}: two encodes of one frame "
                                 f"gave different streams")
        res, x_dec, n_enc, n_dec, enc_ms, dec_ms = runs[1]
        nbytes = len(res["bit_stream"])
        mse = torch.mean((x_dec - x) ** 2).item()
        psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
        log(f"DMCI {w}x{h} qp={qp}: bytes={nbytes} bpp={8 * nbytes / (h * w)} "
            f"psnr={psnr} ec_parallel={res['ec_parallel']} bit_exact=True "
            f"launches enc={n_enc} dec={n_dec} warm encode_ms={enc_ms} "
            f"decode_ms={dec_ms}")
    return derived, 0


def expected_launches(resets, u, encode, recon):
    """(S = 1, stacked) launches of chunk u's encode or decode."""
    first = u == 0 or resets[u - 1]
    if encode:
        s1 = HTS_FIRST_ENCODE if first else HTS_ENCODE_LAUNCHES
    else:
        s1 = HTS_FIRST_DECODE if first else HTS_DECODE_LAUNCHES
    return s1, RECON_LAUNCHES * (int(resets[u]) + int(recon))


def phase_hts(dmci, codec, dev, launch_log):
    """The main path's video half: the DMCI reconstruction of a sequence's
    first frame seeds DMCHTCodec, which codes its 8-frame chunks.  Encode
    pass 1 (recon=True) against a decode from a fresh DPB: every chunk's
    x_hat and the final DPB bit-exact; encode pass 2 (recon=False, warm):
    the same streams.  Returns the (S = 1, stacked) launches derived for
    it, each call's checked."""
    derived = [0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        derived[0] += want[0]
        derived[1] += want[1]

    for (h, w, qp, seed, resets) in HTS_CASES:
        frames = make_sequence(h, w, 8 * len(resets), seed, dev)
        chunks = [torch.cat(frames[8 * u:8 * u + 8], dim=-1)
                  for u in range(len(resets))]
        name = f"HTS {w}x{h} qp={qp}"
        intra, _, i1, is_ = counted(
            launch_log, f"{name} intra frame (DMCI encode)",
            lambda: dmci.compress(frames[0], qp)["x_hat"])
        tally(f"{name} intra frame", (i1, is_), (ENCODE_LAUNCHES, 0))

        def encode(recon):
            codec.clear_dpb()
            codec.add_ref_feature_from_frame(intra)
            kind = "encode (recon)" if recon else "encode"
            runs = [counted(launch_log, f"{name} chunk {u} {kind}",
                            lambda: codec.compress(x, qp, rs, recon=recon))
                    for u, (x, rs) in enumerate(zip(chunks, resets))]
            return runs, codec.ref_feature

        enc1, dpb1 = encode(True)
        enc2, dpb2 = encode(False)
        codec.clear_dpb()
        codec.add_ref_feature_from_frame(intra)
        dec = [counted(launch_log, f"{name} chunk {u} decode",
                       lambda: codec.decompress(
                           bytes(r["bit_stream"]), qp, h, w,
                           r["ec_parallel"], rs)["x_hat"])
               for u, ((r, _, _, _), rs) in enumerate(zip(enc1, resets))]
        for u, rs in enumerate(resets):
            tag = f"{name} chunk {u} reset={int(rs)}"
            (r1, _, e1, s1), (r2, enc_ms, e2, s2) = enc1[u], enc2[u]
            x_dec, dec_ms, d1, ds = dec[u]
            if x_dec.shape != (8, h, w, 3) or r1["x_hat"].shape != x_dec.shape:
                raise AssertionError(f"{tag}: x_hat shape "
                                     f"{tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError(f"{tag}: non-finite reconstruction")
            if not torch.equal(r1["x_hat"], x_dec):
                raise AssertionError(f"{tag}: decoder x_hat differs from "
                                     f"the encoder's")
            if r1["bit_stream"] != r2["bit_stream"]:
                raise AssertionError(f"{tag}: two encodes gave different "
                                     f"streams")
            tally(f"{tag} encode (recon)", (e1, s1),
                  expected_launches(resets, u, True, True))
            tally(f"{tag} encode", (e2, s2),
                  expected_launches(resets, u, True, False))
            tally(f"{tag} decode", (d1, ds),
                  expected_launches(resets, u, False, True))
            nbytes = len(r1["bit_stream"])
            src = torch.cat(frames[8 * u:8 * u + 8]).float()
            mse = torch.mean((x_dec - src) ** 2).item()
            psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
            log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (8 * h * w)} "
                f"psnr={psnr} ec_parallel={r1['ec_parallel']} "
                f"bit_exact=True launches enc(recon)={e1}+{s1} "
                f"enc={e2}+{s2} dec={d1}+{ds} warm encode_ms={enc_ms} "
                f"encode_recon_ms={enc1[u][1]} decode_ms={dec_ms}")
        if not (torch.equal(dpb1, codec.ref_feature)
                and torch.equal(dpb2, codec.ref_feature)):
            raise AssertionError(f"{name}: the decoder's final DPB "
                                 f"differs from the encoder's")
        log(f"{name}: final DPB equal on both sides "
            f"{tuple(codec.ref_feature.shape)}")
    return tuple(derived)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K1.load_kernel()
    log(f"build: fused_dcb.cu -> sm_90a in {time.perf_counter() - t0:.3f} s")
    with torch.inference_mode():
        phase_edge_shapes(dev)

    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    hts = DMCHTCodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=HTS_CONFIG, init_scale=0.5,
                                 skip_thres=0.15, dtype=torch.bfloat16,
                                 device=dev)
    phase_stages(dmci)
    phase_stages_hts(hts)

    # the main path, one part at a time, each with the counts set to 0
    # just before it and read just after
    launch_log = LaunchLog()
    with launch_log:
        K1.fused_dcb.launches = K1.fused_dcb_stacked.launches = 0
        want_dmci = phase_codec(dmci, dev, launch_log)
        n_dmci = (K1.fused_dcb.launches, K1.fused_dcb_stacked.launches)
        K1.fused_dcb.launches = K1.fused_dcb_stacked.launches = 0
        want_hts = phase_hts(dmci, hts, dev, launch_log)
        n_hts = (K1.fused_dcb.launches, K1.fused_dcb_stacked.launches)
    log(f"main path launches (fused_dcb, fused_dcb_stacked): DMCI {n_dmci}, "
        f"derived {want_dmci}; DMCI seed + HTS {n_hts}, derived {want_hts}")
    launches = {"fused_dcb": n_dmci[0] + n_hts[0],
                "fused_dcb_stacked": n_dmci[1] + n_hts[1]}
    recorded = collections.Counter()
    for key, n in launch_log.totals().items():
        recorded[key.kind] += n
    if (n_dmci, n_hts) != (want_dmci, want_hts) or recorded != launches:
        raise AssertionError(f"main path launches {launches}, recorded "
                             f"{dict(recorded)}, derived {want_dmci} + "
                             f"{want_hts}")
    if min(launches.values()) == 0:
        raise AssertionError("the main path skipped a form of K1")

    with torch.inference_mode():
        rows = phase_kernels(dev, launch_log, launches)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
