"""The port's PNG reader (dcvc_tpu_torch/utils/png.py) against PIL's
decode, byte for byte: files written by PIL (RGB, RGBA and grey, odd
sizes, contents that make its adaptive filter pick each filter type it
uses: None, Sub, Up and Paeth, never Average), files whose rows this test
filters with each of the five filter types itself, and the port's own
writer.  Interlaced, 16-bit, palette and grey
+ alpha files, and a corrupted one, raise.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dcvc_tpu_torch.utils import png

MODES = {"L": 1, "RGB": 3, "RGBA": 4}
SIZES = [(1, 1), (7, 5), (33, 17), (64, 48)]


def content(h, w, ch, seed):
    """Noise, a gradient and flat areas: rows that PIL's adaptive filter
    codes with different filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (yy * 7 + xx * 3) % 256
    img = np.where((yy // 4) % 3 == 0, rng.integers(0, 256, (h, w)),
                   np.where((yy // 4) % 3 == 1, grad, 200))
    img = np.repeat(img[:, :, None], ch, axis=2) + np.arange(ch) * 40
    return (img % 256).astype(np.uint8).squeeze(axis=2) if ch == 1 \
        else (img % 256).astype(np.uint8)


def filter_types(path):
    """The filter type byte of every row of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, _, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = 1 + w * png._CHANNELS[color]
    raw = zlib.decompress(idat)
    return {raw[i * stride] for i in range(h)}


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered(path, img, ftype):
    """A PNG file whose every row uses filter `ftype` (0-4)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = []
    for i in range(h):
        x = rows[i]
        up = rows[i - 1] if i else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = [0, a, up, (a + up) // 2, paeth(a, up, c)][ftype]
        out.append(np.concatenate([[ftype], (x - pred) % 256]))
    raw = np.stack(out).astype(np.uint8).tobytes()
    color = {1: 0, 3: 2, 4: 6}[bpp]
    _write_raw(path, w, h, 8, color, 0, zlib.compress(raw))


def _write_raw(path, w, h, depth, color, interlace, idat):
    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + \
            struct.pack(">I", zlib.crc32(kind + payload))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def assert_same_as_pil(path):
    with Image.open(path) as im:
        want = np.asarray(im)
        want_rgb = np.asarray(im.convert("RGB"))
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    rgb = png.load_rgb(path)
    assert rgb.shape == want_rgb.shape and rgb.tobytes() == want_rgb.tobytes()


@pytest.mark.parametrize("mode", list(MODES))
def test_pil_written_files(tmp_path, mode):
    seen = set()
    for i, (h, w) in enumerate(SIZES):
        for level in (1, 9):
            path = tmp_path / f"{mode}_{h}x{w}_{level}.png"
            Image.fromarray(content(h, w, MODES[mode], i), mode).save(
                path, compress_level=level)
            seen |= filter_types(path)
            assert_same_as_pil(path)
    # PIL's adaptive filter picks None, Sub, Up and Paeth; it never writes
    # Average, which test_each_filter_type covers
    assert seen == {0, 1, 2, 4}, seen


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("mode", list(MODES))
def test_each_filter_type(tmp_path, mode, ftype):
    img = content(29, 31, MODES[mode], 7 + ftype)
    path = tmp_path / "f.png"
    write_filtered(path, img, ftype)
    assert filter_types(path) == {ftype}
    assert_same_as_pil(path)
    assert png.read_png(path).tobytes() == img.tobytes()


@pytest.mark.parametrize("mode", list(MODES))
def test_writer_round_trips_through_pil(tmp_path, mode):
    img = content(19, 23, MODES[mode], 3)
    path = tmp_path / "w.png"
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == mode
        assert np.asarray(im).tobytes() == img.tobytes()
    assert png.read_png(path).tobytes() == img.tobytes()


UNSUPPORTED = {
    "16bit": lambda p: Image.fromarray(
        np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(p),
    "palette": lambda p: Image.fromarray(
        content(8, 8, 3, 0)).convert("P").save(p),
    "grey_alpha": lambda p: Image.fromarray(
        content(8, 8, 4, 0)).convert("LA").save(p),
    "interlaced": lambda p: _write_raw(
        p, 8, 8, 8, 2, 1, zlib.compress(bytes(8 * 25))),
    "not_a_png": lambda p: p.write_bytes(b"GIF89a" + bytes(20)),
}


@pytest.mark.parametrize("kind", list(UNSUPPORTED))
def test_unsupported_files_raise(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    UNSUPPORTED[kind](path)
    with pytest.raises(ValueError):
        png.read_png(path)


def test_corrupted_file_raises(tmp_path):
    path = tmp_path / "crc.png"
    png.write_png(path, content(8, 8, 3, 1))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF                        # inside IDAT
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)
