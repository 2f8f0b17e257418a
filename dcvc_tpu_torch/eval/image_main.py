"""Image evaluation entry point of the port (counterpart of the JAX
package's test_image.py, the reference EVC/test_image.py:121-235):

    python3 -m dcvc_tpu_torch.eval.image_main --image_path DIR --qp 32 \
        [--model_path ckpt.bin|ckpt.pth.tar] [--stream_path out_bin_img] \
        [--output_path image_result.json] [--device cuda|cpu] \
        [--device_ec 1]

DMCI over a folder of PNG files: per image, encode -> `.bin` -> the file
read back from disk -> decode -> PSNR, then a JSON of the per-image
entries and their averages, test_image.py's.  The gate: exit code 1 if
any image's decoder reconstruction differs from the encoder's (2 when
the folder holds no PNG).  PNGs are read by utils/png.py (the GPU
machine has no PIL), frames coded in the YCbCr [-0.5, 0.5] domain of
test_image.py:108-125.

The arguments are test_image.py's, plus `--device` (default cuda; with
no card it raises) and `--device_ec` (decode the stream on the device,
K2).  `--i_frame_model dmci` codes at `--qp`; --model_path takes a
dcvc_tpu.params.v1 file (its header's config wins over --tiny; float32,
skip 0, as test_image.py runs a trained gate) or a reference .pth.tar at
the published config (TINY under --tiny; the random weights' dtype and
skip 0.15).  Without it the weights are seeded random: bfloat16 on a
card at the published config, float32 on the CPU or under --tiny.

`--i_frame_model evc | intra_noar` (runtime/evc_codec.py) code RGB in
[0, 1] at `--q_scale`, in float32 on every device, as test_image.py:
74-85 builds them: EVC_CONFIG / INTRA_NOAR_CONFIG (TINY_* under --tiny),
seeded random weights damped by init_scale 0.4, or --model_path's (a
params.v1 file, its header's config winning; for EVC also a reference
.pth.tar at the published config).  The JAX codecs have no device
decode, so --device_ec 1 raises with either.

`--i_frame_model cheng2020 | bmshj2018` (runtime/compressai_codec.py)
are fixed-rate codecs of RGB in [0, 1], float32 on every device, as
test_image.py:86-95 builds them: CHENG2020_Q1_3 / BMSHJ2018_Q1_5
(TINY_CHENG2020 / TINY_HYPERPRIOR under --tiny), seeded random weights
at the JAX codecs' own init, or --model_path's (a params.v1 file, its
header's config winning, or a reference CompressAI .pth.tar).  Each image
goes into the two-string container (legacy_container.dcvc_encode_i, as
test_image.py:134-142 writes it); cheng2020's masked-conv AR runs on the
host.  --device_ec 1 raises with either (no device decode in the JAX
package).
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from ..bitstream.legacy_container import dcvc_decode_i, dcvc_encode_i
from ..core.color import rgb2ycbcr_np, ycbcr2rgb
from ..legacy.compressai_zoo import BMSHJ2018_Q1_5, CHENG2020_Q1_3, \
    TINY_CHENG2020, TINY_HYPERPRIOR
from ..legacy.evc import EVC_CONFIG, TINY_EVC_CONFIG
from ..legacy.hem_intra import INTRA_NOAR_CONFIG, TINY_INTRA_NOAR_CONFIG
from ..models.dmci import DMCI, DMCIConfig, TINY_CONFIG
from ..runtime.compressai_codec import Cheng2020Codec, HyperpriorCodec
from ..runtime.evc_codec import EVCCodec, IntraNoARCodec
from ..runtime.image_codec import DMCICodec
from ..utils.jax_bridge import is_native, load_into, native_config
from ..utils.metrics import calc_psnr
from ..utils.png import load_rgb
from .video_main import check_device, str2bool

# the legacy intra codecs: (codec class, published config, TINY config)
LEGACY_INTRA = {"evc": (EVCCodec, EVC_CONFIG, TINY_EVC_CONFIG),
                "intra_noar": (IntraNoARCodec, INTRA_NOAR_CONFIG,
                               TINY_INTRA_NOAR_CONFIG)}
# the fixed-rate CompressAI codecs, likewise
COMPRESSAI = {"cheng2020": (Cheng2020Codec, CHENG2020_Q1_3, TINY_CHENG2020),
              "bmshj2018": (HyperpriorCodec, BMSHJ2018_Q1_5,
                            TINY_HYPERPRIOR)}
NOT_PORTED = ()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--i_frame_model", default="dmci",
                   choices=("dmci",) + tuple(LEGACY_INTRA)
                   + tuple(COMPRESSAI))
    p.add_argument("--image_path", required=True,
                   help="folder of .png images")
    p.add_argument("--qp", type=int, default=32)
    p.add_argument("--q_scale", type=float, default=1.0)
    p.add_argument("--rate_num", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--model_path", default=None,
                   help="trained or imported checkpoint: a "
                        "dcvc_tpu.params.v1 file (its stored config "
                        "overrides --tiny) or a reference .pth.tar")
    p.add_argument("--stream_path", default="out_bin_img")
    p.add_argument("--output_path", default="image_result.json")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the codec (cuda or cpu)")
    p.add_argument("--device_ec", type=str2bool, default=False,
                   help="decode the rANS stream on the device (K2)")
    return p.parse_args(argv)


def build_legacy_codec(args, device):
    """The EVCCodec / IntraNoARCodec / Cheng2020Codec / HyperpriorCodec of
    the arguments: float32 (as test_image.py builds them), seeded random
    weights (EVC, IntraNoAR: at init_scale 0.4) or --model_path's."""
    if args.device_ec:
        raise ValueError(f"--device_ec: the {args.i_frame_model} codec has "
                         f"no device entropy decode (the JAX package's has "
                         f"none); decode through the host coder")
    compressai = args.i_frame_model in COMPRESSAI
    cls, published, tiny = (COMPRESSAI if compressai
                            else LEGACY_INTRA)[args.i_frame_model]
    default = tiny if args.tiny else published
    if args.model_path:
        if not is_native(args.model_path) and cls is IntraNoARCodec:
            raise ValueError(f"{args.model_path}: IntraNoAR reads "
                             f"dcvc_tpu.params.v1 files only (the JAX "
                             f"package has no reference key map for it)")
        cfg = native_config(args.model_path, cls.CONFIG_CLS, default)
        model = load_into(cls.MODEL_CLS(cfg), args.model_path)
        return cls(model.state_dict(), cfg=cfg, device=device)
    # the JAX codecs' own init: EVC / IntraNoAR damped by 0.4, the
    # CompressAI codecs undamped
    damping = {} if compressai else {"init_scale": 0.4}
    return cls.init_random(torch.Generator().manual_seed(0), cfg=default,
                           device=device, **damping)


def build_codec(args):
    """The codec of --i_frame_model on args.device."""
    device = check_device(args.device)
    if args.i_frame_model in LEGACY_INTRA or \
            args.i_frame_model in COMPRESSAI:
        return build_legacy_codec(args, device)
    kw = {"device": device, "device_ec": args.device_ec}
    default = TINY_CONFIG if args.tiny else DMCIConfig()
    if args.model_path and is_native(args.model_path):
        # trained gates run f32: the decision boundary is exact and the
        # checkpoint was trained in f32
        cfg = native_config(args.model_path, DMCIConfig, default)
        model = load_into(DMCI(cfg), args.model_path)
        return DMCICodec(model.state_dict(), cfg=cfg, skip_thres=0.0,
                         dtype=torch.float32, **kw)
    dtype = (torch.bfloat16 if device.type == "cuda" and not args.tiny
             else torch.float32)
    if args.model_path:
        model = load_into(DMCI(default), args.model_path)
        return DMCICodec(model.state_dict(), cfg=default, skip_thres=0.15,
                         dtype=dtype, **kw)
    return DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=default, skip_thres=0.15, dtype=dtype,
                                 **kw)


def _to_rgb(x_hat):
    """(1, H, W, 3) YCbCr tensor in [-0.5, 0.5] -> (H, W, 3) RGB numpy in
    [0, 1]."""
    return ycbcr2rgb(x_hat[0].float().cpu() + 0.5).numpy()


def code_one(codec, qp, rgb01, bin_path):
    """One image through the codec and a .bin file on disk.  Returns
    (decoder RGB in [0, 1], bytes, bit-exact: the decoder's x_hat equals
    the encoder's)."""
    h, w = rgb01.shape[:2]
    x = (rgb2ycbcr_np(rgb01)[None] - 0.5).astype(np.float32)
    res = codec.compress(x, qp)
    with open(bin_path, "wb") as f:
        f.write(res["bit_stream"])
    with open(bin_path, "rb") as f:
        stream = f.read()
    out = codec.decompress(stream, qp, h, w, res["ec_parallel"])
    bitexact = bool(torch.equal(out["x_hat"], res["x_hat"]))
    return _to_rgb(out["x_hat"]), len(res["bit_stream"]), bitexact


def code_one_legacy(codec, q_scale, rgb01, bin_path):
    """code_one for the EVC / IntraNoAR codecs: RGB in [0, 1] at
    q_scale."""
    h, w = rgb01.shape[:2]
    res = codec.compress(rgb01[None].astype(np.float32), q_scale, h, w)
    with open(bin_path, "wb") as f:
        f.write(res["bit_stream"])
    with open(bin_path, "rb") as f:
        stream = f.read()
    out = codec.decompress(stream, q_scale, h, w)
    bitexact = bool(torch.equal(out["x_hat"], res["x_hat"]))
    return out["x_hat"][0].cpu().numpy(), len(res["bit_stream"]), bitexact


def code_one_compressai(codec, rgb01, bin_path):
    """code_one for the CompressAI codecs: RGB in [0, 1], the two strings
    in the container file, decoded from it.  Returns (decoder RGB, the
    file's bytes, bit-exact)."""
    h, w = rgb01.shape[:2]
    res = codec.compress(rgb01[None].astype(np.float32), h, w)
    dcvc_encode_i(h, w, res["y_string"], res["z_string"], bin_path)
    hh, ww, y_s, z_s = dcvc_decode_i(bin_path)
    out = codec.decompress(y_s, z_s, hh, ww)
    bitexact = bool(torch.equal(out["x_hat"], res["x_hat"]))
    return (out["x_hat"][0].cpu().numpy(), os.path.getsize(bin_path),
            bitexact)


def main(argv=None):
    """Codes every PNG of --image_path; writes the JSON; returns the exit
    code (1 if an image is not bit-exact, 2 if there is no image)."""
    args = parse_args(argv)
    codec = build_codec(args)
    os.makedirs(args.stream_path, exist_ok=True)

    images = sorted(glob.glob(os.path.join(args.image_path, "*.png")))
    if not images:
        print(f"no .png images under {args.image_path}", file=sys.stderr)
        return 2

    results, bad = {}, 0
    for path in images:
        name = os.path.basename(path)
        rgb = load_rgb(path)
        h, w = rgb.shape[:2]
        rgb01 = rgb.astype(np.float32) / 255.0
        bin_path = os.path.join(args.stream_path,
                                name.replace(".png", ".bin"))
        t0 = time.time()
        if args.i_frame_model in LEGACY_INTRA:
            x_dec, n_bytes, bitexact = code_one_legacy(codec, args.q_scale,
                                                       rgb01, bin_path)
        elif args.i_frame_model in COMPRESSAI:
            x_dec, n_bytes, bitexact = code_one_compressai(codec, rgb01,
                                                           bin_path)
        else:
            x_dec, n_bytes, bitexact = code_one(codec, args.qp, rgb01,
                                                bin_path)
        dt = time.time() - t0
        bad += not bitexact
        rec = np.clip(np.round(x_dec * 255), 0, 255)
        psnr = calc_psnr(rgb.astype(np.float64), rec)
        results[name] = {
            "bpp": n_bytes * 8 / (h * w), "psnr": float(psnr),
            "bitexact": bitexact, "time": dt,
        }
        if args.verbose:
            print(f"{name}: bpp {results[name]['bpp']:.4f} "
                  f"psnr {psnr:.2f}{'' if bitexact else '  !! MISMATCH'}",
                  flush=True)

    avg = {"avg_bpp": float(np.mean([r["bpp"] for r in results.values()])),
           "avg_psnr": float(np.mean([r["psnr"] for r in results.values()])),
           "images": len(results)}
    with open(args.output_path, "w") as f:
        json.dump({"model": args.i_frame_model, "summary": avg,
                   "per_image": results}, f, indent=1)
    print(f"{args.i_frame_model}: {avg['images']} images, "
          f"bpp {avg['avg_bpp']:.4f}, psnr {avg['avg_psnr']:.2f} "
          f"-> {args.output_path}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
