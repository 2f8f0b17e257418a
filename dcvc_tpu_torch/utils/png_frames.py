"""Numbered-PNG sequence reader and writer without PIL (the machine with
the card has none): utils/video_io.py's PNGReader / PNGWriter, which
stays a byte-pinned copy of the JAX package's, with the same interface,
file naming (`_png_name`: im1.png... or im00001.png..., the padding
found from the first frame's name) and (3, H, W) uint8 RGB frames, but
reading and writing through utils/png.py.
"""

import os

from .png import load_rgb, write_png
from .video_io import _png_name


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
        if self.eof:
            return None
        path = _png_name(self.folder, self.idx, self.padding)
        if not os.path.exists(path):
            self.eof = True
            return None
        rgb = load_rgb(path)
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
        write_png(_png_name(self.folder, self.idx, self.padding),
                  rgb.transpose(1, 2, 0))
        self.idx += 1

    def close(self):
        pass
