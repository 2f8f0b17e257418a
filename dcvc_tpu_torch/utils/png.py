"""PNG files on zlib and numpy, for the training datasets (the JAX
package reads them through PIL, dcvc_tpu/data/datasets.py:21-23, and
the GPU machine has no PIL).

read_png decodes 8-bit grey, RGB and RGBA images, not interlaced, with
any of the five scanline filters, to the array PIL gives for them;
anything else (palette, grey + alpha, 1/2/4/16-bit depths, Adam7
interlacing, a bad CRC, truncated data) raises ValueError.  load_rgb is
PIL's `Image.open(path).convert("RGB")`: grey replicated to three
channels, alpha dropped.  write_png writes the same three kinds with the
None filter on every row.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data):
    """(type, payload) of every chunk, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("png: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"png: truncated {kind!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"png: bad CRC in {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("png: no IEND chunk")


def _unfilter_average(row, up, bpp):
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        row[x] = (row[x] + ((a + up[x]) >> 1)) & 0xFF


def _unfilter_paeth(row, up, bpp):
    for x in range(len(row)):
        b = up[x]
        if x >= bpp:
            a, c = row[x - bpp], up[x - bpp]
        else:
            a = c = 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        row[x] = (row[x] + pred) & 0xFF


def _unfilter(raw, h, w, bpp):
    """Scanlines (h, 1 + w * bpp) -> the (h, w * bpp) uint8 image."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for i in range(h):
        ftype, line = rows[i, 0], rows[i, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:       # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:       # Up
            cur = line + up
        elif ftype in (3, 4):  # Average, Paeth: serial along the row
            cur = bytearray(line.tobytes())
            (_unfilter_average if ftype == 3 else _unfilter_paeth)(
                cur, up.tobytes(), bpp)
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"png: filter type {ftype} in row {i}")
        out[i] = cur
        up = cur
    return out


def read_png(path):
    """The image of a PNG file: (H, W) uint8 for grey, (H, W, 3) for RGB,
    (H, W, 4) for RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, color type {color}: "
                         f"only 8-bit grey, RGB and RGBA are read")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: compression {compression}, filter "
                         f"method {filt}")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    bpp = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: bad image data: {e}") from None
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{path}: {len(raw)} bytes of scanlines, expected "
                         f"{h * (1 + w * bpp)}")
    img = _unfilter(raw, h, w, bpp)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, bpp)


def load_rgb(path):
    """(H, W, 3) uint8 RGB of a PNG file, as PIL's convert("RGB")."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def write_png(path, img):
    """Write a (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 image."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {v: k for k, v in _CHANNELS.items()}[bpp]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * bpp)], axis=1)

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + \
            struct.pack(">I", zlib.crc32(kind + payload))
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
