"""ctypes binding for the host-side C++ rANS coder (rans.cc).

The shared library is built on first import with g++ (cached next to the
source, keyed by source mtime).  API mirrors the reference pybind module
MLCodec_extensions_cpp (RansEncoder / RansDecoder) plus host-side
compaction helpers that replace the reference's device compaction kernels.
"""

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "rans.cc")
_LIB = os.path.join(_HERE, "librans.so")

MAX_EC_PARALLEL = 8
MIN_SYMBOLS_PER_STREAM = 32768  # reference def_const.h:18


def _build():
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", _LIB, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_LIB)
    c = ctypes
    sigs = {
        "dcvc_rans_encoder_new": ([], c.c_void_p),
        "dcvc_rans_encoder_free": ([c.c_void_p], None),
        "dcvc_rans_encoder_set_cdf": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_int], None),
        "dcvc_rans_encoder_set_parallel": ([c.c_void_p, c.c_int], None),
        "dcvc_rans_encoder_reset": ([c.c_void_p], None),
        "dcvc_rans_encoder_encode_y": ([c.c_void_p, c.c_void_p, c.c_int], None),
        "dcvc_rans_encoder_encode_z": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int], None),
        "dcvc_rans_encoder_flush": ([c.c_void_p], None),
        "dcvc_rans_encoder_get_stream": (
            [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        "dcvc_rans_decoder_new": ([], c.c_void_p),
        "dcvc_rans_decoder_free": ([c.c_void_p], None),
        "dcvc_rans_decoder_set_cdf": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_int], None),
        "dcvc_rans_decoder_set_parallel": ([c.c_void_p, c.c_int], None),
        "dcvc_rans_decoder_set_stream": ([c.c_void_p, c.c_void_p, c.c_int], None),
        "dcvc_rans_decoder_decode_y": ([c.c_void_p, c.c_void_p, c.c_int], None),
        "dcvc_rans_decoder_decode_z": (
            [c.c_void_p, c.c_int, c.c_int, c.c_int], None),
        "dcvc_rans_decoder_get_decoded": (
            [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        "dcvc_irans_encoder_new": ([], c.c_void_p),
        "dcvc_irans_encoder_free": ([c.c_void_p], None),
        "dcvc_irans_encoder_add_cdf": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p,
             c.c_void_p], c.c_int),
        "dcvc_irans_encoder_reset": ([c.c_void_p], None),
        "dcvc_irans_encoder_encode": (
            [c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_int], None),
        "dcvc_irans_encoder_flush": ([c.c_void_p], None),
        "dcvc_irans_encoder_get_stream": (
            [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        "dcvc_irans_decoder_new": ([], c.c_void_p),
        "dcvc_irans_decoder_free": ([c.c_void_p], None),
        "dcvc_irans_decoder_add_cdf": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p,
             c.c_void_p], c.c_int),
        "dcvc_irans_decoder_set_stream": (
            [c.c_void_p, c.c_void_p, c.c_int], None),
        "dcvc_irans_decoder_decode": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p], None),
        "dcvc_compact_i16": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_void_p], c.c_int),
        "dcvc_compact_u8": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_void_p], c.c_int),
        "dcvc_count_cond": ([c.c_void_p, c.c_int], c.c_int),
        "dcvc_scatter_i8": (
            [c.c_void_p, c.c_void_p, c.c_int, c.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


_lib = _load()


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def compute_ec_parallel(symbol_count):
    """clamp(symbols / 32768, 1, 8) (reference dmc_common.cpp)."""
    return max(1, min(MAX_EC_PARALLEL, symbol_count // MIN_SYMBOLS_PER_STREAM))


class RansEncoder:
    def __init__(self):
        self._free = _lib.dcvc_rans_encoder_free
        self._h = _lib.dcvc_rans_encoder_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)

    def set_cdf(self, cdfs, cdf_lengths, bank):
        cdfs = np.ascontiguousarray(cdfs, np.int32)
        sizes = np.ascontiguousarray(cdf_lengths, np.int32).reshape(-1)
        n, per = cdfs.shape
        _lib.dcvc_rans_encoder_set_cdf(self._h, _ptr(cdfs), n, per, _ptr(sizes), bank)

    def set_parallel(self, n):
        _lib.dcvc_rans_encoder_set_parallel(self._h, int(n))

    def reset(self):
        _lib.dcvc_rans_encoder_reset(self._h)

    def encode_y(self, symbols):
        symbols = np.ascontiguousarray(symbols, np.int16)
        _lib.dcvc_rans_encoder_encode_y(self._h, _ptr(symbols), symbols.size)

    def encode_z(self, symbols, cdf_offset, ch):
        symbols = np.ascontiguousarray(symbols, np.int8)
        _lib.dcvc_rans_encoder_encode_z(
            self._h, _ptr(symbols), symbols.size, int(cdf_offset), int(ch))

    def flush(self):
        _lib.dcvc_rans_encoder_flush(self._h)

    def get_encoded_stream(self):
        cap = 1 << 20
        while True:
            out = np.empty(cap, np.uint8)
            size = _lib.dcvc_rans_encoder_get_stream(self._h, _ptr(out), cap)
            if size <= cap:
                return out[:size].tobytes()
            cap = size


class RansDecoder:
    def __init__(self):
        self._free = _lib.dcvc_rans_decoder_free
        self._h = _lib.dcvc_rans_decoder_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)

    def set_cdf(self, cdfs, cdf_lengths, bank):
        cdfs = np.ascontiguousarray(cdfs, np.int32)
        sizes = np.ascontiguousarray(cdf_lengths, np.int32).reshape(-1)
        n, per = cdfs.shape
        _lib.dcvc_rans_decoder_set_cdf(self._h, _ptr(cdfs), n, per, _ptr(sizes), bank)

    def set_parallel(self, n):
        _lib.dcvc_rans_decoder_set_parallel(self._h, int(n))

    def set_stream(self, data):
        buf = np.frombuffer(bytes(data), np.uint8)
        _lib.dcvc_rans_decoder_set_stream(self._h, _ptr(buf), buf.size)

    def decode_y(self, indexes):
        indexes = np.ascontiguousarray(indexes, np.uint8)
        self._n = indexes.size
        _lib.dcvc_rans_decoder_decode_y(self._h, _ptr(indexes), indexes.size)

    def decode_z(self, total_size, cdf_offset, ch):
        self._n = int(total_size)
        _lib.dcvc_rans_decoder_decode_z(
            self._h, int(total_size), int(cdf_offset), int(ch))

    def get_decoded(self, n=None):
        n = self._n if n is None else int(n)
        out = np.empty(n, np.int8)
        _lib.dcvc_rans_decoder_get_decoded(self._h, _ptr(out), n)
        return out


class IndexedRansEncoder:
    """Legacy-family entropy encoder (encode_with_indexes semantics,
    reference DCVC-family/DCVC-FM/src/cpp/rans/rans.cpp): dense symbol
    grids, per-symbol CDF row index, per-row offsets, bypass escapes.
    CDF groups are registered with add_cdf and addressed by index."""

    def __init__(self):
        self._free = _lib.dcvc_irans_encoder_free
        self._h = _lib.dcvc_irans_encoder_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)

    def add_cdf(self, cdfs, cdf_lengths, offsets):
        cdfs = np.ascontiguousarray(cdfs, np.int32)
        sizes = np.ascontiguousarray(cdf_lengths, np.int32).reshape(-1)
        offsets = np.ascontiguousarray(offsets, np.int32).reshape(-1)
        n, per = cdfs.shape
        return _lib.dcvc_irans_encoder_add_cdf(
            self._h, _ptr(cdfs), n, per, _ptr(sizes), _ptr(offsets))

    def reset(self):
        _lib.dcvc_irans_encoder_reset(self._h)

    def encode_with_indexes(self, symbols, indexes, group):
        symbols = np.ascontiguousarray(
            np.clip(symbols, -30000, 30000), np.int16).reshape(-1)
        indexes = np.ascontiguousarray(indexes, np.int16).reshape(-1)
        assert symbols.size == indexes.size
        _lib.dcvc_irans_encoder_encode(self._h, _ptr(symbols), _ptr(indexes),
                                       symbols.size, int(group))

    def flush(self):
        _lib.dcvc_irans_encoder_flush(self._h)

    def get_encoded_stream(self):
        cap = 1 << 20
        while True:
            out = np.empty(cap, np.uint8)
            size = _lib.dcvc_irans_encoder_get_stream(self._h, _ptr(out), cap)
            if size <= cap:
                return out[:size].tobytes()
            cap = size


class IndexedRansDecoder:
    def __init__(self):
        self._free = _lib.dcvc_irans_decoder_free
        self._h = _lib.dcvc_irans_decoder_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._free(h)

    def add_cdf(self, cdfs, cdf_lengths, offsets):
        cdfs = np.ascontiguousarray(cdfs, np.int32)
        sizes = np.ascontiguousarray(cdf_lengths, np.int32).reshape(-1)
        offsets = np.ascontiguousarray(offsets, np.int32).reshape(-1)
        n, per = cdfs.shape
        return _lib.dcvc_irans_decoder_add_cdf(
            self._h, _ptr(cdfs), n, per, _ptr(sizes), _ptr(offsets))

    def set_stream(self, data):
        buf = np.frombuffer(bytes(data), np.uint8)
        _lib.dcvc_irans_decoder_set_stream(self._h, _ptr(buf), buf.size)

    def decode_stream(self, indexes, group):
        indexes = np.ascontiguousarray(indexes, np.int16).reshape(-1)
        out = np.empty(indexes.size, np.int16)
        _lib.dcvc_irans_decoder_decode(self._h, _ptr(indexes), indexes.size,
                                       int(group), _ptr(out))
        return out


def compact_i16(symbols, cond):
    symbols = np.ascontiguousarray(symbols, np.int16)
    cond = np.ascontiguousarray(cond, np.uint8)
    out = np.empty(symbols.size, np.int16)
    k = _lib.dcvc_compact_i16(_ptr(symbols), _ptr(cond), symbols.size, _ptr(out))
    return out[:k]


def compact_u8(indexes, cond):
    indexes = np.ascontiguousarray(indexes, np.uint8)
    cond = np.ascontiguousarray(cond, np.uint8)
    out = np.empty(indexes.size, np.uint8)
    k = _lib.dcvc_compact_u8(_ptr(indexes), _ptr(cond), indexes.size, _ptr(out))
    return out[:k]


def count_cond(cond):
    cond = np.ascontiguousarray(cond, np.uint8)
    return _lib.dcvc_count_cond(_ptr(cond), cond.size)


def scatter_i8(compacted, cond):
    compacted = np.ascontiguousarray(compacted, np.int8)
    cond = np.ascontiguousarray(cond, np.uint8)
    out = np.empty(cond.size, np.int8)
    _lib.dcvc_scatter_i8(_ptr(compacted), _ptr(cond), cond.size, _ptr(out))
    return out
