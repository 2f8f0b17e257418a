"""Evaluation harness: encode -> NAL bitstream -> decode -> metrics
(counterpart of dcvc_tpu/eval/harness.py).

CLI / JSON-schema compatible with the reference test_video.py (same
argument names, same nested {class -> seq -> rate} output, same per-point
log via generate_log_json), and the JAX harness's .bin layout: the same
bits, JSON fields and warm-up discard.  Frames are read on the host as
numpy, handed to the codecs (which move them to their device) and come
back as numpy for the metrics.  PNG sequences are read and written
through utils/png_frames.py (no PIL: the machine with the card has
none).  Timing is the host clock around codec calls that end on the
host: an encode ends with the host rANS coder, a decode with the copy of
its frames to the host.
"""

import io
import json
import os
import time

import numpy as np
import torch

from ..bitstream import (
    NalType, SPSHelper, read_header, read_ip_remaining, read_sps_remaining,
    write_ip, write_sps,
)
from ..core.color import rgb2ycbcr_np, ycbcr2rgb, ycbcr420_to_444_np, \
    yuv_444_to_420_np
from ..utils.logjson import generate_log_json
from ..utils.metrics import calc_msssim, calc_msssim_rgb, calc_psnr
from ..utils.png_frames import PNGReader, PNGWriter
from ..utils.video_io import YUV420Reader, YUV420Writer


def get_src_reader(args):
    if args["src_type"] == "png":
        return PNGReader(args["src_path"])
    if args["src_type"] == "yuv420":
        return YUV420Reader(args["src_path"], args["src_width"],
                            args["src_height"])
    raise ValueError(args["src_type"])


def read_frames(args, src_reader, maximum_read, pad_to=None):
    """Reads up to maximum_read frames; returns (x (1,H,W,3*n) f32 in
    [-0.5,0.5] YCbCr, per-frame originals for metrics).  pad_to replicates
    the last frame to fill a short chunk (reference get_src_frame,
    test_video.py:104-110)."""
    xs, ys, uvs, rgbs = [], [], [], []
    read = 0
    while read < maximum_read:
        if args["src_type"] == "yuv420":
            y, uv = src_reader.read_one_frame()
            if y is None:
                break
            yuv444 = ycbcr420_to_444_np(y.astype(np.float32),
                                        uv.astype(np.float32))
            x = yuv444.transpose(1, 2, 0)[None] / 255.0 - 0.5
            ys.append(y)
            uvs.append(uv)
            rgbs.append(None)
        else:
            rgb = src_reader.read_one_frame()
            if rgb is None:
                break
            rgb_f = rgb.transpose(1, 2, 0).astype(np.float32) / 255.0
            ycbcr = rgb2ycbcr_np(rgb_f)
            x = ycbcr[None] - 0.5
            ys.append(None)
            uvs.append(None)
            rgbs.append(rgb)
        xs.append(x.astype(np.float32))
        read += 1
    pad_to = maximum_read if pad_to is None else pad_to
    while xs and len(xs) < pad_to:
        xs.append(xs[-1])
        ys.append(ys[-1])
        uvs.append(uvs[-1])
        rgbs.append(rgbs[-1])
    if not xs:
        return None, ys, uvs, rgbs
    return np.concatenate(xs, axis=-1), ys, uvs, rgbs


def _to_rgb(x_hat):
    """(H, W, 3) YCbCr numpy in [-0.5, 0.5] -> RGB numpy in [0, 1]."""
    return ycbcr2rgb(torch.from_numpy(np.ascontiguousarray(x_hat))
                     + 0.5).numpy()


def get_distortion(args, x_hat, y_org, uv_org, rgb_org):
    """x_hat: (1, H, W, 3) YCbCr numpy in [-0.5, 0.5].  Returns (psnr
    list, ssim list): [overall] or [overall, y, u, v]."""
    calc_ssim_flag = args.get("calc_ssim", False)
    if args["src_type"] == "yuv420":
        yuv = np.transpose(np.asarray(x_hat[0]) + 0.5, (2, 0, 1))
        y_rec, uv_rec = yuv_444_to_420_np(yuv)
        y_rec = np.clip(np.round(y_rec * 255), 0, 255)
        uv_rec = np.clip(np.round(uv_rec * 255), 0, 255)
        psnr_y = calc_psnr(y_org.astype(np.float64), y_rec)
        psnr_u = calc_psnr(uv_org[0].astype(np.float64), uv_rec[0])
        psnr_v = calc_psnr(uv_org[1].astype(np.float64), uv_rec[1])
        psnr = (6 * psnr_y + psnr_u + psnr_v) / 8  # test_video.py:44
        if calc_ssim_flag:
            ssim_y = calc_msssim(y_org[0], y_rec[0])
            ssim_u = calc_msssim(uv_org[0], uv_rec[0])
            ssim_v = calc_msssim(uv_org[1], uv_rec[1])
        else:
            ssim_y = ssim_u = ssim_v = 0.0
        ssim = (6 * ssim_y + ssim_u + ssim_v) / 8
        return [psnr, psnr_y, psnr_u, psnr_v], [ssim, ssim_y, ssim_u, ssim_v]

    rgb_rec = _to_rgb(x_hat[0])
    rgb_rec = np.clip(np.round(rgb_rec * 255), 0, 255).transpose(2, 0, 1)
    psnr = calc_psnr(rgb_org.astype(np.float64), rgb_rec)
    ssim = calc_msssim_rgb(rgb_org.astype(np.float64), rgb_rec) \
        if calc_ssim_flag else 0.0
    return [psnr], [ssim]


def run_one_point_with_stream(p_codec, i_codec, frame_delay, args):
    """Encode the sequence to a .bin, decode it back, measure metrics.
    Mirrors reference run_one_point_with_stream (test_video.py:166-398)."""
    if args.get("check_existing") and os.path.exists(args["curr_json_path"]) \
            and os.path.exists(args["curr_bin_path"]):
        with open(args["curr_json_path"]) as f:
            log_result = json.load(f)
        if (log_result["i_frame_num"] + log_result["p_frame_num"]
                == args["frame_num"]):
            return log_result

    frame_num = args["frame_num"]
    verbose = args.get("verbose", 0)
    reset_interval = args.get("reset_interval", 32)
    intra_period = args["intra_period"]
    pic_height, pic_width = args["src_height"], args["src_width"]

    frame_types, psnrs, msssims, bits = [], [], [], []
    encoding_time, decoding_time = [], []
    start_time = time.time()

    # ------------------------------------------------------------ encode
    src_reader = get_src_reader(args)
    output_buff = io.BytesIO()
    sps_helper = SPSHelper()
    frame_idx = 0
    while frame_idx < frame_num:
        is_intra = frame_idx == 0 or intra_period == 1
        if intra_period > 1 and frame_idx != 1 and frame_idx % intra_period == 1:
            is_intra = True

        maximum_read = 1 if is_intra else min(frame_delay,
                                              frame_num - frame_idx)
        pad_to = 1 if is_intra else frame_delay
        x, _, _, _ = read_frames(args, src_reader, maximum_read, pad_to)

        t0 = time.time()
        if is_intra:
            curr_qp = args["qp_i"]
            reset_feature_memory = 0
            encoded = i_codec.compress(x, curr_qp)
            if not args.get("force_intra"):
                p_codec.clear_dpb()
                p_codec.add_ref_feature_from_frame(encoded["x_hat"])
            frame_types.append(0)
        else:
            curr_qp = args["qp_p"]
            reset_feature_memory = int(
                reset_interval > 0
                and (frame_idx + frame_delay) % reset_interval == 1)
            encoded = p_codec.compress(
                x, curr_qp, reset_feature_memory=reset_feature_memory)
            frame_types.extend([1] * maximum_read)

        sps = {"sps_id": -1, "height": pic_height, "width": pic_width}
        sps_id, sps_new = sps_helper.get_sps_id(sps)
        sps["sps_id"] = sps_id
        sps_bytes = write_sps(output_buff, sps) if sps_new else 0
        stream_bytes = write_ip(output_buff, is_intra, sps_id, curr_qp,
                                encoded["ec_parallel"], reset_feature_memory,
                                encoded["bit_stream"])
        bits.append(stream_bytes * 8 + sps_bytes * 8)
        bits.extend([0] * (maximum_read - 1))
        encoding_time.append(time.time() - t0)
        if verbose >= 2:
            print(f"frame {frame_idx} encoded, "
                  f"{encoding_time[-1]*1000:.3f} ms, bits: {bits[-maximum_read]}")
        frame_idx += maximum_read
    src_reader.close()

    with open(args["curr_bin_path"], "wb") as f:
        f.write(output_buff.getbuffer())
    total_bytes = output_buff.getbuffer().nbytes
    output_buff.close()

    # ------------------------------------------------------------ decode
    sps_helper = SPSHelper()
    with open(args["curr_bin_path"], "rb") as f:
        input_buff = io.BytesIO(f.read())
    src_reader = get_src_reader(args)

    recon_writer = None
    if args.get("save_decoded_frame"):
        if args["src_type"] == "yuv420":
            total_kbps = int(total_bytes * 8 / (frame_num / 30) / 1000)
            out_path = args["curr_rec_path"].replace(
                ".yuv", f"_{total_kbps}kbps.yuv")
            recon_writer = YUV420Writer(out_path, pic_width, pic_height)
        else:
            recon_writer = PNGWriter(args["bin_folder"])

    decoded = 0
    while decoded < frame_num:
        t0 = time.time()
        header = read_header(input_buff)
        while header["nal_type"] == NalType.NAL_SPS:
            sps = read_sps_remaining(input_buff, header["sps_id"])
            sps_helper.add_sps_by_id(sps)
            header = read_header(input_buff)
        sps = sps_helper.get_sps_by_id(header["sps_id"])
        qp, ec_part, reset_feature_memory, bit_stream = \
            read_ip_remaining(input_buff)

        is_intra = header["nal_type"] == NalType.NAL_I
        if is_intra:
            out = i_codec.decompress(bit_stream, qp, sps["height"],
                                     sps["width"], ec_part)
            if not args.get("force_intra"):
                p_codec.clear_dpb()
                p_codec.add_ref_feature_from_frame(out["x_hat"])
            frames_out = out["x_hat"].cpu().numpy()  # (1, H, W, 3)
        else:
            out = p_codec.decompress(bit_stream, qp, sps["height"],
                                     sps["width"], ec_part,
                                     reset_feature_memory)
            frames_out = out["x_hat"].cpu().numpy()  # (F, H, W, 3) or packed
            if frames_out.ndim == 3:  # (F, H, W*3) packed rows -> view
                frames_out = frames_out.reshape(frames_out.shape[0],
                                                frames_out.shape[1], -1, 3)
        decoding_time.append(time.time() - t0)

        maximum_read = 1 if is_intra else min(frame_delay, frame_num - decoded)
        _, ys, uvs, rgbs = read_frames(args, src_reader, maximum_read)

        for i in range(maximum_read):
            x_hat = frames_out[i:i + 1]
            curr_psnr, curr_ssim = get_distortion(args, x_hat, ys[i],
                                                  uvs[i], rgbs[i])
            psnrs.append(curr_psnr)
            msssims.append(curr_ssim)
            if recon_writer is not None:
                _write_recon(args, recon_writer, x_hat)

        if verbose >= 2:
            print(f"frame {decoded} decoded, {decoding_time[-1]*1000:.3f} ms, "
                  f"bits: {len(bit_stream)*8}, PSNR: {psnrs[-1][0]:.4f}")
        decoded += maximum_read
    input_buff.close()
    src_reader.close()
    if recon_writer is not None:
        recon_writer.close()

    test_time = time.time() - start_time
    time_bypass = 4  # warm-up discard (test_video.py:380-388)
    if verbose >= 1 and len(encoding_time) > time_bypass:
        enc_t = encoding_time[time_bypass:]
        dec_t = decoding_time[time_bypass:]
        avg_encoding_time = sum(enc_t) / len(enc_t)
        avg_decoding_time = sum(dec_t) / len(dec_t)
        print(f"encoding/decoding {len(enc_t)} * {frame_delay} frames, "
              f"average encoding time {avg_encoding_time*1000:.3f} ms, "
              f"average decoding time {avg_decoding_time*1000:.3f} ms.")
    else:
        avg_encoding_time = avg_decoding_time = None

    log_result = generate_log_json(
        frame_num, pic_height * pic_width, test_time, frame_types, bits,
        psnrs, msssims, verbose=args.get("verbose_json", False),
        avg_encoding_time=avg_encoding_time,
        avg_decoding_time=avg_decoding_time)
    with open(args["curr_json_path"], "w") as fp:
        json.dump(log_result, fp, indent=2)
    return log_result


def _write_recon(args, writer, x_hat):
    if args["src_type"] == "yuv420":
        yuv = np.transpose(x_hat[0] + 0.5, (2, 0, 1))
        y, uv = yuv_444_to_420_np(yuv)
        writer.write_one_frame(
            np.clip(np.round(y * 255), 0, 255).astype(np.uint8),
            np.clip(np.round(uv * 255), 0, 255).astype(np.uint8))
    else:
        rgb = _to_rgb(x_hat[0])
        writer.write_one_frame(
            np.clip(np.round(rgb * 255), 0, 255).astype(np.uint8)
            .transpose(2, 0, 1))
