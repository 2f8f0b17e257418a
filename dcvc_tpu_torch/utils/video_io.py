"""Raw YUV420 and numbered-PNG readers/writers (reference
src/utils/video_reader.py, video_writer.py)."""

import os

import numpy as np


class YUV420Reader:
    """8-bit planar YUV420 file reader.

    read_one_frame() -> (y (1, H, W), uv (2, H/2, W/2)) uint8, or
    (None, None) at EOF.
    """

    def __init__(self, src_path, width, height, skip_frame=0):
        self.src_path = src_path
        self.width = width
        self.height = height
        self.eof = False
        self.y_size = width * height
        self.uv_size = self.y_size // 2
        self.file = open(src_path, "rb")
        if skip_frame:
            self.file.seek((self.y_size + self.uv_size) * skip_frame)

    def read_one_frame(self):
        if self.eof:
            return None, None
        y = self.file.read(self.y_size)
        uv = self.file.read(self.uv_size)
        if len(y) < self.y_size or len(uv) < self.uv_size:
            self.eof = True
            return None, None
        y = np.frombuffer(y, np.uint8).reshape(1, self.height, self.width)
        uv = np.frombuffer(uv, np.uint8).reshape(
            2, self.height // 2, self.width // 2)
        return y, uv

    def close(self):
        self.file.close()


class YUV420Writer:
    def __init__(self, dst_path, width, height):
        self.file = open(dst_path, "wb")
        self.width = width
        self.height = height

    def write_one_frame(self, y, uv):
        """y: (1, H, W) uint8; uv: (2, H/2, W/2) uint8."""
        self.file.write(np.ascontiguousarray(y).tobytes())
        self.file.write(np.ascontiguousarray(uv).tobytes())

    def close(self):
        self.file.close()


def _png_name(folder, idx, padding):
    if padding:
        return os.path.join(folder, f"im{idx:05d}.png")
    return os.path.join(folder, f"im{idx}.png")


class PNGReader:
    """Numbered PNG sequence reader: im1.png... or im00001.png...

    read_one_frame() -> (3, H, W) uint8 RGB or None at EOF.
    """

    def __init__(self, src_folder, start_idx=1):
        self.folder = src_folder
        self.idx = start_idx
        self.eof = False
        self.padding = os.path.exists(_png_name(src_folder, start_idx, True))

    def read_one_frame(self):
        from PIL import Image
        if self.eof:
            return None
        path = _png_name(self.folder, self.idx, self.padding)
        if not os.path.exists(path):
            self.eof = True
            return None
        rgb = np.asarray(Image.open(path).convert("RGB"))
        self.idx += 1
        return rgb.transpose(2, 0, 1)

    def close(self):
        pass


class PNGWriter:
    def __init__(self, dst_folder, padding=True):
        os.makedirs(dst_folder, exist_ok=True)
        self.folder = dst_folder
        self.idx = 1
        self.padding = padding

    def write_one_frame(self, rgb):
        """rgb: (3, H, W) uint8."""
        from PIL import Image
        path = _png_name(self.folder, self.idx, self.padding)
        Image.fromarray(rgb.transpose(1, 2, 0)).save(path)
        self.idx += 1

    def close(self):
        pass
