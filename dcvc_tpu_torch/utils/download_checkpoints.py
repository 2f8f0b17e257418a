"""Download the reference's released checkpoints and (optionally) convert
them into the native format (counterpart of the JAX repo's
scripts/download_checkpoints.py, the same registry).

    python3 -m dcvc_tpu_torch.utils.download_checkpoints [FAMILY ...] \
        [--root checkpoints] [--import_native]

Counterpart of the reference's per-family download scripts
(DCVC-family/*/checkpoints/download.py and the OneDrive folder links in
each README): one registry instead of seven scripts.  A file already in
place is kept (`have`); an entry that is only a share folder prints
MANUAL (exit code 2); a download that fails prints FAILED (exit code 1).
--import_native converts every file in place through the port's
converter (utils/import_cli.py: guess_kind / import_checkpoint) into
<name>.native.bin, a dcvc_tpu.params.v1 file the CLIs read.

It needs a network connection, which a machine without one cannot give:
there, only files already in place are converted.
"""

import argparse
import os
import sys
from urllib.request import urlretrieve

ONE = "https://onedrive.live.com/download?cid=2866592D5C55DF8C&resid=2866592D5C55DF8C%21{rid}&authkey={key}"

# family -> {filename: url}.  Direct URLs mirror the reference download
# scripts; entries whose value starts with "folder:" are OneDrive share
# folders (the reference README only publishes a folder link for these —
# download manually and drop the files next to this registry's names).
REGISTRY = {
    # DCVC-UF (top level): README.md:125 folder link; 4 checkpoints
    "uf": {
        "cvpr2026_image.pth.tar": "folder:https://1drv.ms/f/c/2866592d5c55df8c/IgAalzb_985lQ79GkXyW2P5OASPpZHHcrcGWEVQxO-mQCVg?e=qyvMN6",
        "cvpr2026_video_hts.pth.tar": "folder:(same share as cvpr2026_image)",
        "cvpr2026_video_htl.pth.tar": "folder:(same share as cvpr2026_image)",
        "cvpr2026_video_ld.pth.tar": "folder:(same share as cvpr2026_image)",
    },
    # DCVC-RT: DCVC-family/DCVC-RT/README.md:91 folder link
    "rt": {
        "cvpr2025_image.pth.tar": "folder:https://1drv.ms/f/c/2866592d5c55df8c/Esu0KJ-I2kxCjEP565ARx_YB88i0UnR6XnODqFcvZs4LcA?e=by8CO8",
        "cvpr2025_video.pth.tar": "folder:(same share as cvpr2025_image)",
    },
    # DCVC-FM: DCVC-family/DCVC-FM/checkpoints/download.py
    "fm": {
        "cvpr2024_image.pth.tar": ONE.format(rid="1494", key="!AOxzcrEFT_h-iCk"),
        "cvpr2024_video.pth.tar": ONE.format(rid="1493", key="!AFxYv6oK1o6GrZc"),
    },
    # DCVC-DC: DCVC-family/DCVC-DC/checkpoints/download.py
    "dc": {
        "cvpr2023_image_psnr.pth.tar": ONE.format(rid="1259", key="AO_gFvTcYZUFd9U"),
        "cvpr2023_image_ssim.pth.tar": ONE.format(rid="1260", key="AFWlIyBB5PIudtw"),
        "cvpr2023_image_yuv420_psnr.pth.tar": ONE.format(rid="1261", key="AOB9I7Jv25RbyGY"),
        "cvpr2023_video_psnr.pth.tar": ONE.format(rid="1256", key="ACzRzK3XgbQxEyk"),
        "cvpr2023_video_ssim.pth.tar": ONE.format(rid="1258", key="AIRQMQyZqJWG15k"),
        "cvpr2023_video_yuv420_psnr.pth.tar": ONE.format(rid="1257", key="AEQHk7O606IiqGA"),
    },
    # DCVC-HEM: DCVC-family/DCVC-HEM/checkpoints/download.py
    "hem": {
        "acmmm2022_image_psnr.pth.tar": ONE.format(rid="1220", key="AMRg1W3PVt_F3yc"),
        "acmmm2022_image_ssim.pth.tar": ONE.format(rid="1219", key="ACJnPOPf1ntw_w0"),
        "acmmm2022_video_psnr.pth.tar": ONE.format(rid="1217", key="AKpdgXQtvs-OxRs"),
        "acmmm2022_video_ssim.pth.tar": ONE.format(rid="1218", key="ANxapLv3PcCJ4Vw"),
    },
    # EVC: DCVC-family/EVC/checkpoints/download.py
    "evc": {
        "EVC_LL.pth.tar": ONE.format(rid="1227", key="AD8e586WrFlT6IE"),
        "EVC_LM_MD.pth.tar": ONE.format(rid="1225", key="AOOYBdkfEmZ9rTo"),
        "EVC_LS_MD.pth.tar": ONE.format(rid="1226", key="ADp_pN4gvxbHMrw"),
        "EVC_ML_MD.pth.tar": ONE.format(rid="1228", key="AHCLXyxrm3UdXxU"),
        "EVC_MM_MD.pth.tar": ONE.format(rid="1229", key="AGT8gpE50lHHixI"),
        "EVC_SL_MD.pth.tar": ONE.format(rid="1230", key="ABwOafGhqBQcT9I"),
        "EVC_SS_MD.pth.tar": ONE.format(rid="1231", key="ANrIn85RgtBH2wM"),
        "Scale_EVC_SL_MDRRL.pth.tar": ONE.format(rid="1233", key="AC8tZbxQdbJDXCU"),
        "Scale_EVC_SS_MDRRL.pth.tar": ONE.format(rid="1232", key="AAy8Q8QMM0dUxKg"),
    },
    # DCVC (NeurIPS'21): folder link (README.md:64) + the CompressAI
    # I-frame models its baseline needs (download_compressai_models.py)
    "dcvc": {
        "model_dcvc_quality_0_psnr.pth": "folder:https://1drv.ms/u/s!AozfVVwtWWYoiS5mcGX320bFXI0k?e=iMeykH",
        "cheng2020-anchor-3-e49be189.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/cheng2020-anchor-3-e49be189.pth.tar",
        "cheng2020-anchor-4-98b0b468.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/cheng2020-anchor-4-98b0b468.pth.tar",
        "cheng2020-anchor-5-23852949.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/cheng2020-anchor-5-23852949.pth.tar",
        "cheng2020-anchor-6-4c052b1a.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/cheng2020-anchor-6-4c052b1a.pth.tar",
        "bmshj2018-hyperprior-3-5c6f152b.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/bmshj2018-hyperprior-3-5c6f152b.pth.tar",
        "bmshj2018-hyperprior-4-de1b779c.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/bmshj2018-hyperprior-4-de1b779c.pth.tar",
        "bmshj2018-hyperprior-5-f8b614e1.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/bmshj2018-hyperprior-5-f8b614e1.pth.tar",
        "bmshj2018-hyperprior-6-1ab9c41e.pth.tar": "https://compressai.s3.amazonaws.com/models/v1/bmshj2018-hyperprior-6-1ab9c41e.pth.tar",
    },
    # DCVC-TCM: folder link only (DCVC-family/DCVC-TCM/README.md:72)
    "tcm": {
        "model_dcvc_quality_0_psnr.pth.tar": "folder:https://onedrive.live.com/?authkey=%21ADwwaonwTGR%5FNR8&id=2866592D5C55DF8C%211234&cid=2866592D5C55DF8C",
    },
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=[],
                    help=f"subset of {sorted(REGISTRY)} (default: all)")
    ap.add_argument("--root", default="checkpoints")
    ap.add_argument("--import_native", action="store_true",
                    help="convert each downloaded .pth[.tar] to the "
                         "native format via utils/import_cli.py")
    args = ap.parse_args(argv)
    families = args.families or sorted(REGISTRY)

    rc = 0
    for fam in families:
        out_dir = os.path.join(args.root, fam)
        os.makedirs(out_dir, exist_ok=True)
        for name, url in REGISTRY[fam].items():
            target = os.path.join(out_dir, name)
            if os.path.exists(target):
                print(f"have {target}")
            elif url.startswith("folder:"):
                print(f"MANUAL: {name} — browse {url[7:]} and save to "
                      f"{target}")
                rc = 2
                continue
            else:
                print(f"downloading {target}")
                try:
                    urlretrieve(url, target)
                except OSError as e:
                    print(f"FAILED {name}: {e} (no network egress?)",
                          file=sys.stderr)
                    rc = 1
                    continue
            if args.import_native:
                from .import_cli import guess_kind, import_checkpoint
                try:
                    kind = guess_kind(target)
                except ValueError as e:
                    print(f"skip import of {name}: {e}", file=sys.stderr)
                    continue
                out = target.rsplit(".pth", 1)[0] + ".native.bin"
                import_checkpoint(target, out, kind=kind)
                print(f"imported -> {out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
