"""Card <-> CPU stream portability conformance of the port (counterpart
of the JAX repo's scripts/cross_platform_conformance.py, the DCVC-RT
integerization role: a stream encoded on one device class should decode
on another).

The codec's bit-exactness contract ("the same stage code on both sides")
assumes encoder and decoder share a platform.  This harness measures the
cross-platform reality: encode on one device, decode on the other, and
compare

  * the exact coded symbol sequences (z + per-rung y + CDF indexes):
    symbol equality means the entropy decode never desyncs, i.e. the
    STREAM is portable;
  * reconstruction closeness (float synthesis differs across devices in
    ulps, so x_hat is compared by PSNR as well as bitwise).

Both sides run float32 (SMALL_CONFIG / SMALL_HT_CONFIG) with TF32 off and
deterministic cuDNN on the card (runtime/image_codec.set_deterministic),
to minimise decision flips (scale -> index, skip masks).  The weights
are drawn once, by the first process that runs, written as a
dcvc_tpu.params.v1 file into the directory and read by every later one.

    python3 -m dcvc_tpu_torch.eval.cross_platform encode --platform cuda \\
        --dir D
    python3 -m dcvc_tpu_torch.eval.cross_platform decode --platform cpu \\
        --src cuda --dir D --report D/report.json
    python3 -m dcvc_tpu_torch.eval.cross_platform run --dir D \\
        [--artifact OUT.json] [--platforms cuda cpu]

`run` encodes on each platform and decodes each encoding on each
platform, every step in a process of its own, and writes the artifact
(D/CROSS_PLATFORM.json unless --artifact says otherwise).  It fails when
a same-platform leg is not identical (every symbol sequence, every
reconstruction bit-exact); a cross-platform stream that does not decode
is a finding the artifact records.  --tiny runs TINY configs on a 64x64
image at QPs below their 8.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..models.dmc_ht import DMCHT, SMALL_HT_CONFIG, TINY_HT_CONFIG
from ..models.dmci import DMCI, SMALL_CONFIG, TINY_CONFIG
from ..runtime.image_codec import DMCICodec
from ..runtime.video_codec import DMCHTCodec
from ..utils.jax_bridge import load_native_into, save_native
from . import ROOT, module_env
from .video_main import check_device

QPS = [2, 8, 14]
P_QP = 3
IMAGE_HW = (192, 256)
CONFIGS = (SMALL_CONFIG, SMALL_HT_CONFIG)
# --tiny: TINY configs (qp_num 8), a small image
TINY_QPS = [2, 4, 6]
TINY_IMAGE_HW = (64, 64)
PLATFORMS = ("cuda", "cpu")
# the JAX harness's committed measurement, which this port never writes
JAX_ARTIFACT = os.path.join(ROOT, "artifacts", "CROSS_PLATFORM_r05.json")


def _setup(args):
    """(device, (image config, P config), QPs, (h, w)) of the command."""
    device = check_device(args.platform)
    if args.tiny:
        return device, (TINY_CONFIG, TINY_HT_CONFIG), TINY_QPS, TINY_IMAGE_HW
    return device, CONFIGS, QPS, IMAGE_HW


def _image(h=192, w=256):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(99)
    img = gaussian_filter(rng.uniform(-0.5, 0.5, (h, w, 3)), 2.0)
    return np.ascontiguousarray(img, np.float32)[None]


def _build_codecs(device, d, cfgs):
    """Deterministic weights: drawn once (by the first process that runs)
    and written to `d`, read back after, so both sides share them."""
    cfg_i, cfg_p = cfgs
    kw = {"dtype": torch.float32, "skip_thres": 0.15, "device": device}
    pi = os.path.join(d, "params_i.bin")
    pp = os.path.join(d, "params_p.bin")
    if os.path.exists(pi):
        icodec = DMCICodec(load_native_into(DMCI(cfg_i), pi).state_dict(),
                           cfg=cfg_i, **kw)
    else:
        icodec = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                       cfg=cfg_i, **kw)
        save_native(icodec.model, pi, cfg_i)
    if os.path.exists(pp):
        pcodec = DMCHTCodec(load_native_into(DMCHT(cfg_p), pp).state_dict(),
                            cfg=cfg_p, **kw)
    else:
        pcodec = DMCHTCodec.init_random(torch.Generator().manual_seed(1),
                                        cfg=cfg_p, init_scale=0.5, **kw)
        save_native(pcodec.model, pp, cfg_p)
    return icodec, pcodec


def _np(x):
    return x.detach().cpu().numpy()


def _sym_blob(entries):
    """Flatten collected symbol dicts into a savable dict of arrays."""
    blob = {}
    for i, e in enumerate(entries):
        blob[f"{i}_z"] = e["z"]
        for k, (y, idx) in enumerate(zip(e["y"], e["idx"])):
            blob[f"{i}_y{k}"] = y
            blob[f"{i}_i{k}"] = idx
    return blob


def cmd_encode(args):
    device, cfgs, qps, hw = _setup(args)
    os.makedirs(args.dir, exist_ok=True)
    icodec, pcodec = _build_codecs(device, args.dir, cfgs)
    x = _image(*hw)
    h, w = x.shape[1:3]

    icodec.collect_symbols = []
    img_streams, img_xhat = [], []
    for qp in qps:
        res = icodec.compress(x, qp)
        img_streams.append((res["bit_stream"], res["ec_parallel"]))
        img_xhat.append(_np(res["x_hat"]))

    f = pcodec.cfg.frame_delay
    frames = [np.roll(x, 2 * i, axis=2) for i in range(2 * f)]
    pcodec.clear_dpb()
    pcodec.add_ref_feature_from_frame(img_xhat[1])
    vid_streams, vid_xhat = [], []
    for u in range(2):
        chunk = np.concatenate(frames[u * f:(u + 1) * f], axis=-1)
        res = pcodec.compress(chunk, P_QP, recon=True)
        vid_streams.append((res["bit_stream"], res["ec_parallel"]))
        vid_xhat.append(_np(res["x_hat"]))

    np.savez(os.path.join(args.dir, f"enc_{args.platform}.npz"),
             h=h, w=w,
             img_xhat=np.stack(img_xhat),
             vid_xhat=np.stack(vid_xhat),
             n_img=len(qps), qps=np.asarray(qps),
             **{f"img_s{i}": np.frombuffer(s, np.uint8)
                for i, (s, _) in enumerate(img_streams)},
             **{f"img_e{i}": e for i, (_, e) in enumerate(img_streams)},
             **{f"vid_s{i}": np.frombuffer(s, np.uint8)
                for i, (s, _) in enumerate(vid_streams)},
             **{f"vid_e{i}": e for i, (_, e) in enumerate(vid_streams)},
             **{"imgsym_" + k: v
                for k, v in _sym_blob(icodec.collect_symbols).items()})
    print(f"encoded on {args.platform} -> {args.dir}")


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else -10 * np.log10(mse)


def cmd_decode(args):
    device, cfgs, _, _ = _setup(args)
    icodec, pcodec = _build_codecs(device, args.dir, cfgs)
    enc = np.load(os.path.join(args.dir, f"enc_{args.src}.npz"))
    h, w = int(enc["h"]), int(enc["w"])
    report = {"encode_platform": args.src,
              "decode_platform": args.platform, "image": [], "video": []}

    icodec.collect_symbols = []
    for i, qp in enumerate(enc["qps"]):
        stream = enc[f"img_s{i}"].tobytes()
        out = icodec.decompress(stream, int(qp), h, w,
                                int(enc[f"img_e{i}"]))
        got = _np(out["x_hat"])
        want = enc["img_xhat"][i]
        col = icodec.collect_symbols[-1]
        sym_ok = bool(
            np.array_equal(col["z"], enc[f"imgsym_{i}_z"]) and
            all(np.array_equal(col["y"][k], enc[f"imgsym_{i}_y{k}"]) and
                np.array_equal(col["idx"][k], enc[f"imgsym_{i}_i{k}"])
                for k in range(4)))
        report["image"].append({
            "qp": int(qp), "symbols_identical": sym_ok,
            "recon_psnr_vs_encoder": round(_psnr(got, want), 2),
            "recon_bitexact": bool(np.array_equal(got, want))})

    pcodec.clear_dpb()
    pcodec.add_ref_feature_from_frame(enc["img_xhat"][1])
    for u in range(2):
        stream = enc[f"vid_s{u}"].tobytes()
        out = pcodec.decompress(stream, P_QP, h, w, int(enc[f"vid_e{u}"]))
        got = _np(out["x_hat"])
        want = enc["vid_xhat"][u]
        report["video"].append({
            "chunk": u,
            "recon_psnr_vs_encoder": round(_psnr(got, want), 2),
            "recon_bitexact": bool(np.array_equal(got, want))})

    with open(args.report, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps(report, indent=1))


def identical(report):
    """Every symbol sequence identical and every reconstruction bit-exact
    (the gate of a same-platform leg)."""
    return bool(report.get("image") or report.get("video")) and all(
        e["symbols_identical"] and e["recon_bitexact"]
        for e in report.get("image", [])) and all(
        e["recon_bitexact"] for e in report.get("video", []))


def cmd_run(args):
    d = args.dir
    os.makedirs(d, exist_ok=True)
    out = args.artifact or os.path.join(d, "CROSS_PLATFORM.json")
    if os.path.abspath(out) == JAX_ARTIFACT:
        raise SystemExit(f"refusing to overwrite {out}, the JAX harness's "
                         f"measurement")
    env = module_env()
    tiny = ["--tiny"] if args.tiny else []

    def run(cmd):
        return subprocess.run(
            [sys.executable, "-m", "dcvc_tpu_torch.eval.cross_platform"]
            + cmd + tiny, env=env).returncode

    for p in args.platforms:
        if run(["encode", "--platform", p, "--dir", d]) != 0:
            raise SystemExit(f"encode on {p} failed")
    reports, gate = {}, {}
    for src in args.platforms:
        for dst in args.platforms:
            rp = os.path.join(d, f"report_{src}_to_{dst}.json")
            rc = run(["decode", "--platform", dst, "--src", src, "--dir", d,
                      "--report", rp])
            if rc == 0:
                with open(rp) as fi:
                    rep = json.load(fi)
            else:
                rep = {"encode_platform": src, "decode_platform": dst,
                       "error": f"decode exited with code {rc}"}
            reports[f"{src}_encode_{dst}_decode"] = rep
            if src == dst:
                gate[src] = identical(rep)

    art = {
        "note": ("cross-platform stream portability (DCVC-RT "
                 "integerization role): encode on one device, decode on "
                 "the other; symbols_identical == no entropy desync "
                 "(stream portable); recon compared by PSNR because "
                 "float synthesis differs across devices in ulps"),
        "f32_highest_precision": True,
        "same_platform_identical": gate,
        "results": reports,
    }
    with open(out, "w") as fo:
        json.dump(art, fo, indent=1)
    print(f"wrote {out}")
    if not all(gate.values()):
        raise SystemExit(f"a same-platform leg is not identical: {gate}")
    return art


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("encode")
    e.add_argument("--platform", required=True, choices=PLATFORMS)
    e.add_argument("--dir", required=True)
    dd = sub.add_parser("decode")
    dd.add_argument("--platform", required=True, choices=PLATFORMS)
    dd.add_argument("--src", required=True, choices=PLATFORMS)
    dd.add_argument("--dir", required=True)
    dd.add_argument("--report", required=True)
    r = sub.add_parser("run")
    r.add_argument("--dir", required=True)
    r.add_argument("--artifact", default=None,
                   help="the artifact's path (default DIR/CROSS_PLATFORM"
                        ".json)")
    r.add_argument("--platforms", nargs="+", choices=PLATFORMS,
                   default=list(PLATFORMS))
    for p in (e, dd, r):
        p.add_argument("--tiny", action="store_true",
                       help="TINY configs, a 64x64 image")
    args = ap.parse_args(argv)
    return {"encode": cmd_encode, "decode": cmd_decode,
            "run": cmd_run}[args.cmd](args)


if __name__ == "__main__":
    main()
