"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel (dcvc_tpu_torch/csrc/fused_dcb.cu, nvcc for
sm_90a), holds it against its plain PyTorch version at every DepthConvBlock
shape of the DMCI intra codec at 1080p, then drives the codec itself
(DMCICodec at its full published width, bfloat16, seeded random weights)
through compress -> bytes -> decompress on a 1080p frame at two QPs and a
720p frame.  It fails, with a non-zero exit code, if the card is missing,
the kernel does not build or launch, disagrees with its plain version,
the main path did not go through the kernel, or a reconstruction is not
bit-exact between encoder and decoder.

Output: one line per phase; then a JSON line with the kernel table; the
card's name and power limit; and last {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.models.dmci import DMCI, DMCIConfig
from dcvc_tpu_torch.runtime.image_codec import DMCICodec

K1_SOURCE = "dcvc_tpu_torch/csrc/fused_dcb.cu"
K1_REPLACES = "dcvc_tpu/kernels/fused_dcb.py:66"

# Every distinct DepthConvBlock of DMCI at 1080p (frame padded to
# 1088x1920), with how often one encode runs it:
# (h, w, cin, c, inner, adaptor, shortcut, launches per encode)
DMCI_1080P_SHAPES = [
    (136, 240, 192, 384, 384, True, False, 1),    # enc_1
    (136, 240, 384, 384, 384, False, False, 18),  # enc_2 x6, dec_1 x12
    (136, 240, 384, 384, 384, False, True, 1),    # dec_1.0 (upsample)
    (136, 240, 384, 192, 192, True, False, 1),    # dec_2
    (68, 120, 256, 128, 128, True, False, 1),     # hyper_enc conv.0
    (68, 120, 128, 128, 128, False, True, 1),     # hyper_dec conv.1
    (68, 120, 128, 256, 256, True, False, 1),     # hyper_dec conv.2
    (68, 120, 256, 512, 512, True, False, 1),     # y_prior_fusion conv.0
    (68, 120, 512, 512, 512, False, False, 11),   # prior convs 1-2, spatial x9
    (68, 120, 512, 512, 512, True, False, 3),     # spatial adaptors 1-3
    (34, 60, 128, 128, 128, False, True, 2),      # hyper_enc conv.1, hyper_dec conv.0
    (17, 30, 128, 128, 128, False, True, 1),      # hyper_enc conv.2
]
# the shape cases of tests/test_fused_dcb.py (W=18, dcb2, shortcut)
TEST_SHAPES = [
    (8, 16, 128, 128, 128, False, False, 0),
    (8, 18, 256, 128, 128, True, False, 0),
    (6, 16, 128, 128, 64, False, False, 0),
    (4, 16, 128, 128, 128, False, True, 0),
]
# Tolerance of the kernel against the plain version, both in bfloat16:
# each rounds to bf16 (2^-9 relative) at several points, the plain version
# after each of its ~12 ops and the kernel at its 5 cast points, so the
# two may differ by a few bf16 steps of the output's magnitude.  Allowed:
# 2^-6 of the largest |output| (4 bf16 steps at the peak).
K1_REL_TOL = 2.0 ** -6
# Stage outputs of the full-width model in bf16 on the card against the
# same (bf16-valued) weights in float32 on the CPU: relative RMS error.
# ~40 successive bf16 roundings at 2^-9 each accumulate to ~1-2%
# (phase_stages also admits twice the plain bf16 version's error).
STAGE_REL_TOL = 5e-2
ENCODE_LAUNCHES, DECODE_LAUNCHES = 42, 32
# main-path frames: (height, width, qp, seed); 720p gives the odd 45x80
# y grid
CODEC_CASES = [(1080, 1920, 0, 0), (1080, 1920, 32, 0), (720, 1280, 32, 1)]


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of fn() over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def random_block(cin, c, inner, adaptor, gen):
    """DCB weights in fused_dcb layout, lecun-scaled, non-zero biases."""
    def w(i, o):
        return torch.randn(i, o, generator=gen) / i ** 0.5

    def b(n):
        return 0.1 * torch.randn(n, generator=gen)
    p = {}
    if adaptor:
        p["wa"], p["ba"] = w(cin, c), b(c)
    p["w1"], p["b1"] = w(c, inner), b(inner)
    p["wd"], p["bd"] = torch.randn(3, 3, inner, generator=gen) / 3.0, b(inner)
    p["w2"], p["b2"] = w(inner, c), b(c)
    p["w3"], p["b3"] = w(c, 4 * inner), b(4 * inner)
    p["w4"], p["b4"] = w(inner, c), b(c)
    return p


def phase_kernel(dev):
    """K1 against its plain version at every shape; returns the kernel
    row of the JSON table (without the launch count)."""
    gen = torch.Generator().manual_seed(0)
    worst, ms_enc, plain_enc = 0.0, 0.0, 0.0
    for (h, w, cin, c, inner, ad, sc, n) in DMCI_1080P_SHAPES + TEST_SHAPES:
        p = {k: v.to(dev, torch.bfloat16)
             for k, v in random_block(cin, c, inner, ad, gen).items()}
        x = torch.randn(1, h, w, cin, generator=gen).to(dev, torch.bfloat16)
        ops = K1.prepare_operands(p)
        out = K1.fused_dcb(x, p, sc, ops=ops)
        torch.cuda.synchronize()
        plain = K1.fused_dcb_reference(x, p, sc)
        plain32 = K1.fused_dcb_reference(
            x.float(), {k: v.float() for k, v in p.items()}, sc)
        peak = plain32.abs().max().item()
        err = (out.float() - plain.float()).abs().max().item()
        err32 = (out.float() - plain32).abs().max().item()
        plain_err32 = (plain.float() - plain32).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= K1_REL_TOL * peak
        t_k = cuda_ms(lambda: K1.fused_dcb(x, p, sc, ops=ops))
        t_p = cuda_ms(lambda: K1.fused_dcb_reference(x, p, sc))
        log(f"K1 {h}x{w} {cin}->{c} I={inner} adaptor={int(ad)} "
            f"shortcut={int(sc)}: max_abs_err={err} tol={K1_REL_TOL * peak} "
            f"(vs f32 plain: kernel {err32}, bf16 plain {plain_err32}) "
            f"kernel_ms={t_k} plain_ms={t_p} per_encode={n}")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(h, w, cin, c, inner, ad, sc)}")
        worst = max(worst, err)
        ms_enc += n * t_k
        plain_enc += n * t_p
    log(f"K1 device time per 1080p encode (sum of per-shape medians x "
        f"launches): kernel_ms={ms_enc} plain_ms={plain_enc}")
    return {"name": "fused_dcb", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "max_abs_err": worst,
            "ms": ms_enc, "plain_ms": plain_enc}


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
    qp = 32
    with torch.inference_mode():
        y, z_int8 = cpu32.analysis(x, qp)
        ctx = cpu32.prior0(z_int8, 4, 4)[2]
    y_hat = torch.round(y)
    ref = stage_outputs(cpu32, x, qp, z_int8, ctx, y_hat)
    got = stage_outputs(gpu, x, qp, z_int8, ctx, y_hat)
    plain = stage_outputs(cpu16, x, qp, z_int8, ctx, y_hat)
    errs = {k: (rel_rms(got[k], ref[k]), rel_rms(plain[k], ref[k]))
            for k in ref}
    log("stages vs f32 CPU, relative RMS (K1 path on the card, plain bf16 "
        f"on the CPU; tol {STAGE_REL_TOL} or 2x plain): " + json.dumps(errs))
    bad = [k for k, (e, e_plain) in errs.items()
           if not (e <= STAGE_REL_TOL or e <= 2 * e_plain)]
    if bad:
        raise AssertionError(f"stage outputs disagree with the CPU: {bad}")


def smooth_frame(h, w, seed, dev):
    """A smooth synthetic frame in [-0.5, 0.5]: uniform noise under an 8x8
    box blur (the recipe of bench.py), made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(1, 3, h + 7, w + 7, generator=gen, device=dev)
    x = F.avg_pool2d(x, 8, stride=1)
    return x.permute(0, 2, 3, 1).contiguous() - 0.5


def code_once(codec, x, qp):
    """compress -> bytes -> decompress; returns (result, x_hat_dec, enc
    launches, dec launches, enc ms, dec ms)."""
    h, w = x.shape[1], x.shape[2]
    n0 = K1.fused_dcb.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codec.compress(x, qp)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n1 = K1.fused_dcb.launches
    bits = bytes(res["bit_stream"])
    dec = codec.decompress(bits, qp, h, w, res["ec_parallel"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n2 = K1.fused_dcb.launches
    return (res, dec["x_hat"], n1 - n0, n2 - n1,
            1e3 * (t1 - t0), 1e3 * (t2 - t1))


def phase_codec(codec, dev):
    """The main path: DMCI round trips at 1080p (two QPs) and 720p."""
    for (h, w, qp, seed) in CODEC_CASES:
        x = smooth_frame(h, w, seed, dev)
        runs = [code_once(codec, x, qp) for _ in range(2)]  # cold, warm
        for res, x_dec, n_enc, n_dec, _, _ in runs:
            x_enc = res["x_hat"]
            if x_dec.shape != (1, h, w, 3) or x_enc.shape != x_dec.shape:
                raise AssertionError(f"x_hat shape {tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError("non-finite reconstruction")
            if not torch.equal(x_enc, x_dec):
                raise AssertionError(f"{h}p qp {qp}: decoder x_hat differs "
                                     f"from the encoder's")
            if (n_enc, n_dec) != (ENCODE_LAUNCHES, DECODE_LAUNCHES):
                raise AssertionError(f"K1 launches enc {n_enc} dec {n_dec}, "
                                     f"expected {ENCODE_LAUNCHES}/"
                                     f"{DECODE_LAUNCHES}")
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
        row = phase_kernel(dev)

    codec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=DMCIConfig(), skip_thres=0.15,
                                  dtype=torch.bfloat16, device=dev)
    phase_stages(codec)

    K1.fused_dcb.launches = 0
    phase_codec(codec, dev)
    row["launches"] = K1.fused_dcb.launches
    if row["launches"] == 0:
        raise AssertionError("the main path launched no K1 kernel")

    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
