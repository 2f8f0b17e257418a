"""Result-JSON schema and fixed-precision dumping (reference
src/utils/common.py:31-116): per-sequence logs aggregate i/p/all frame
bpp + PSNR + MS-SSIM (optionally per Y/U/V) and timing."""

import json

import numpy as np


def dump_json(obj, fid, float_digits=-1, **kwargs):
    """json.dump with fixed float precision."""
    if float_digits is not None and float_digits >= 0:
        def _round(o):
            if isinstance(o, float):
                return round(o, float_digits)
            if isinstance(o, dict):
                return {k: _round(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [_round(v) for v in o]
            return o
        obj = _round(obj)
    json.dump(obj, fid, **kwargs)


def generate_log_json(frame_num, frame_pixel_num, test_time, frame_types,
                      bits, psnrs, ssims, verbose=False,
                      avg_encoding_time=None, avg_decoding_time=None):
    """Build the per-point result dict (schema-compatible with the
    reference generate_log_json).

    psnrs/ssims: per-frame lists; entry [overall] or
    [overall, y, u, v] when YUV metrics are included.
    """
    include_yuv = len(psnrs[0]) > 1
    assert not include_yuv or (len(psnrs[0]) == 4 and len(ssims[0]) == 4)

    metrics = ["psnr", "ssim"] + (
        ["psnr_y", "psnr_u", "psnr_v", "ssim_y", "ssim_u", "ssim_v"]
        if include_yuv else [])
    metric_idx = {"psnr": 0, "ssim": 0, "psnr_y": 1, "psnr_u": 2, "psnr_v": 3,
                  "ssim_y": 1, "ssim_u": 2, "ssim_v": 3}
    i_sum = {m: 0 for m in metrics}
    p_sum = {m: 0 for m in metrics}
    i_sum["bits"], p_sum["bits"] = 0, 0
    i_num, p_num = 0, 0

    for idx in range(frame_num):
        is_i = frame_types[idx] == 0
        target = i_sum if is_i else p_sum
        target["bits"] += bits[idx]
        for m in metrics:
            src = psnrs if "psnr" in m else ssims
            target[m] += src[idx][metric_idx[m]]
        if is_i:
            i_num += 1
        else:
            p_num += 1

    log = {
        "frame_pixel_num": frame_pixel_num,
        "i_frame_num": i_num,
        "p_frame_num": p_num,
    }
    for prefix, num, sums in [("i", i_num, i_sum), ("p", p_num, p_sum)]:
        log[f"ave_{prefix}_frame_bpp"] = (
            sums["bits"] / num / frame_pixel_num if num > 0 else 0)
        log[f"ave_{prefix}_frame_psnr"] = sums["psnr"] / num if num > 0 else 0
        log[f"ave_{prefix}_frame_msssim"] = sums["ssim"] / num if num > 0 else 0
        if include_yuv:
            for suffix in ["y", "u", "v"]:
                log[f"ave_{prefix}_frame_psnr_{suffix}"] = (
                    sums[f"psnr_{suffix}"] / num if num > 0 else 0)
                log[f"ave_{prefix}_frame_msssim_{suffix}"] = (
                    sums[f"ssim_{suffix}"] / num if num > 0 else 0)

    if verbose:
        log["frame_bpp"] = list(np.array(bits) / frame_pixel_num)
        log["frame_psnr"] = [v[0] for v in psnrs]
        log["frame_msssim"] = [v[0] for v in ssims]
        log["frame_type"] = list(frame_types)
        if include_yuv:
            for suffix, idx in [("y", 1), ("u", 2), ("v", 3)]:
                log[f"frame_psnr_{suffix}"] = [v[idx] for v in psnrs]
                log[f"frame_msssim_{suffix}"] = [v[idx] for v in ssims]

    log["test_time"] = test_time
    total_bits = i_sum["bits"] + p_sum["bits"]
    log["ave_all_frame_bpp"] = total_bits / (frame_num * frame_pixel_num)
    log["ave_all_frame_psnr"] = (i_sum["psnr"] + p_sum["psnr"]) / frame_num
    log["ave_all_frame_msssim"] = (i_sum["ssim"] + p_sum["ssim"]) / frame_num
    if avg_encoding_time is not None and avg_decoding_time is not None:
        log["avg_frame_encoding_time"] = avg_encoding_time
        log["avg_frame_decoding_time"] = avg_decoding_time
    if include_yuv:
        for suffix in ["y", "u", "v"]:
            log[f"ave_all_frame_psnr_{suffix}"] = (
                i_sum[f"psnr_{suffix}"] + p_sum[f"psnr_{suffix}"]) / frame_num
            log[f"ave_all_frame_msssim_{suffix}"] = (
                i_sum[f"ssim_{suffix}"] + p_sum[f"ssim_{suffix}"]) / frame_num
    return log
