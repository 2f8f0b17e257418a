"""msgpack in pure Python and numpy: what flax's msgpack_serialize /
msgpack_restore write and read for a param tree, so that the port reads
and writes the JAX package's `dcvc_tpu.params.v1` checkpoints on a
machine with neither flax nor msgpack.

packb(tree) gives the bytes of flax's
`msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)`
after its chunking, unpackb(data) the tree of flax's msgpack_restore:
- maps (dicts, keys in their order), arrays (lists), str, bin (bytes),
  int, float (always float64, as msgpack-python writes a Python float),
  bool and nil, each in msgpack's smallest encoding;
- ext type 1, an ndarray: the msgpack of (shape, dtype name, C-order
  bytes).  A torch tensor or a numpy array is written; a tensor is read
  (a `bfloat16` array as torch.bfloat16, which numpy has no type for);
- ext type 3, a numpy scalar, written from and read as np.generic (a
  bfloat16 scalar is read as a 0-d tensor);
- flax's chunked form of an array over `chunk_bytes` (2^30, flax's
  MAX_CHUNK_SIZE): {"__msgpack_chunked_array__": True, "shape": {"0":
  d0, ...}, "chunks": {"0": flat chunk, ...}}, written for such arrays
  and joined back into one tensor when read.
Any other type, ext type or tag raises: ValueError when reading,
TypeError when writing.
"""

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ----------------------------------------------------------------- write

def _head(out, n, fix, fix_max, tags):
    """A length or count header: the fix form below fix_max, else the
    first of the 8/16/32-bit forms (tags; None where there is none) that
    holds n."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise TypeError(f"msgpack: length {n} too large")


def _int(out, x):
    if 0 <= x < 128:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for tag, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                              (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if x < top:
                out.append(bytes([tag]) + struct.pack(fmt, x))
                return
        raise TypeError(f"msgpack: int {x} too large")
    else:
        for tag, fmt, low in ((0xd0, ">b", -(1 << 7)),
                              (0xd1, ">h", -(1 << 15)),
                              (0xd2, ">i", -(1 << 31)),
                              (0xd3, ">q", -(1 << 63))):
            if x >= low:
                out.append(bytes([tag]) + struct.pack(fmt, x))
                return
        raise TypeError(f"msgpack: int {x} too small")


def _ext(out, code, data):
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(bytes([code]))
    out.append(data)


def _array_payload(arr):
    """(shape, dtype name, C-order bytes) of a tensor or numpy array, as
    flax's _ndarray_to_bytes packs them."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"msgpack: tensor dtype {t.dtype}")
        name = _DTYPE_NAMES[t.dtype]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        shape, data = tuple(t.shape), raw.numpy().tobytes()
    else:
        arr = np.asarray(arr)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise TypeError(f"msgpack: numpy dtype {arr.dtype}")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = [b"\x93"]
    _head(out, len(shape), 0x90, 16, (None, 0xdc, 0xdd))
    for d in shape:
        _int(out, int(d))
    _pack(name, out)
    _pack(bytes(data), out)
    return b"".join(out)


def _nbytes(arr):
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr, chunk_bytes):
    """flax's _chunk: the array as flat chunks of chunk_bytes / itemsize
    elements."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, int(chunk_bytes / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size]
                       for i, s in enumerate(range(0, n, size))}}


def _pack(obj, out, chunk_bytes=None):
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _int(out, obj)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif t in (bytes, bytearray):
        _head(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(bytes(obj))
    elif t is dict:
        _head(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out, chunk_bytes)
            _pack(v, out, chunk_bytes)
    elif t is list:
        _head(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out, chunk_bytes)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        if chunk_bytes is not None and _nbytes(obj) > chunk_bytes:
            _pack(_chunk(obj, chunk_bytes), out, chunk_bytes)
        else:
            _ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot write {t.__name__}")


def packb(tree, chunk_bytes=MAX_CHUNK_SIZE):
    """The msgpack bytes of `tree` as flax's msgpack_serialize writes
    them (arrays over chunk_bytes in the chunked form)."""
    out = []
    _pack(tree, out, chunk_bytes)
    return b"".join(out)


# ------------------------------------------------------------------ read

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"),
                 0xc6: ("bin", ">I"), 0xc7: ("ext", ">B"),
                 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
                 0xd9: ("str", ">B"), 0xda: ("str", ">H"),
                 0xdb: ("str", ">I"), 0xdc: ("array", ">H"),
                 0xdd: ("array", ">I"), 0xde: ("map", ">H"),
                 0xdf: ("map", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: unknown tag 0x{b:02x}")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            if arr.dtype == torch.bfloat16:
                return arr
            return arr.numpy()[()]
        raise ValueError(f"msgpack: unknown ext type {code}")


def _array_from_payload(data):
    r = _Reader(data)
    shape, name, buf = r.read()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes in an ndarray")
    if name not in _TORCH_DTYPES:
        raise ValueError(f"msgpack: ndarray dtype {name!r}")
    dtype = _TORCH_DTYPES[name]
    if not buf:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def _unchunk(tree):
    """flax's _unchunk_array_leaves_in_place, without the in place."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """The tree of msgpack bytes, as flax's msgpack_restore reads it
    (chunked arrays joined)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(tree)
