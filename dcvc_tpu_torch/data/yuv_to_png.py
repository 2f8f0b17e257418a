"""YUV420 -> numbered-PNG test sets (counterpart of test_data_to_png.py;
reference DCVC-family/DCVC-DC/test_data_to_png.py): prepares the RGB test
sets (test_cfg/all_RGB.json) from raw YUV sources through BT.709.

    python3 -m dcvc_tpu_torch.data.yuv_to_png --src seq.yuv --width 1920 \
        --height 1080 --dst out_png_dir [--frames N]

The same flags and arithmetic as the JAX package's script
(`_ycbcr2rgb_np` is a verbatim copy, pinned by
tests/test_torch_data_scripts.py); the PNG files go through
utils/png_frames.PNGWriter (im00001.png, ...), without PIL.
"""

import argparse
import os

import numpy as np

from ..core.color import ycbcr420_to_444_np
from ..utils.png_frames import PNGWriter
from ..utils.video_io import YUV420Reader


def _ycbcr2rgb_np(ycbcr):
    """BT.709 limited-range inverse, numpy (matches core/color.ycbcr2rgb)."""
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    cb = cb - 0.5
    cr = cr - 0.5
    r = y + 1.5748 * cr
    g = y - 0.1873 * cb - 0.4681 * cr
    b = y + 1.8556 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def convert_one_seq_to_png(src_path, width, height, dst_path, frames=-1):
    """Every frame of a YUV420 file (the first `frames` when >= 0) as
    dst_path/im{n:05d}.png; returns the number of frames written."""
    reader = YUV420Reader(src_path, width, height)
    writer = PNGWriter(dst_path)
    n = 0
    try:
        while frames < 0 or n < frames:
            y, uv = reader.read_one_frame()
            if y is None:
                break
            yuv = ycbcr420_to_444_np(y.astype(np.float32) / 255.0,
                                     uv.astype(np.float32) / 255.0)
            rgb = _ycbcr2rgb_np(np.transpose(yuv, (1, 2, 0)))
            writer.write_one_frame(
                np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
                .transpose(2, 0, 1))
            n += 1
    finally:
        reader.close()
        writer.close()
    print(src_path, n)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--height", type=int, required=True)
    parser.add_argument("--dst", type=str, required=True)
    parser.add_argument("--frames", type=int, default=-1)
    args = parser.parse_args(argv)
    os.makedirs(args.dst, exist_ok=True)
    return convert_one_seq_to_png(args.src, args.width, args.height,
                                  args.dst, args.frames)


if __name__ == "__main__":
    main()
