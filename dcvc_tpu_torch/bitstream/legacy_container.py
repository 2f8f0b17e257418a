"""Per-frame `.bin` container formats of the pre-UF DCVC family.

Each legacy generation writes ONE FILE PER FRAME with plain big-endian
uint headers; formats evolve per model:

  * DCVC / TCM (and their CompressAI I-frames):
    I: {h u32, w u32, y_len u32, z_len u32, y, z}
       (DCVC/src/utils/stream_helper.py:108-130, DCVC-TCM:61-83)
    P(DCVC): {h u32, w u32, 4x len u32, mv_y, mv_z, y, z}
       (DCVC:132-160)
    P(TCM): {len u32, stream}  (DCVC-TCM:85-99)
  * HEM: I: {h u32, w u32, q_index u16, len u32, stream}
         P: {mv_y_q u16, y_q u16, len u32, stream}
       (DCVC-HEM/src/utils/stream_helper.py:102-133)
  * DC:  I: {h u32, w u32, (q_in_ckpt<<7 | q_index<<1) u8, len u32, stream}
         P: {flag u8, frame_idx u8, len u32, stream}
       (DCVC-DC/src/utils/stream_helper.py:94-128)
  * FM: NAL/SPS container with {qp(6), fa_idx(2)} in the SPS — see
    FMSPSHelper below (DCVC-FM/src/utils/stream_helper.py:128-235).

Byte-compatible with the reference formats (struct '>I'/'>H' packing).
"""

import struct


def _w_uints(f, values):
    f.write(struct.pack(f">{len(values)}I", *values))


def _r_uints(f, n):
    return struct.unpack(f">{n}I", f.read(4 * n))


def _w_ushorts(f, values):
    f.write(struct.pack(f">{len(values)}H", *values))


def _r_ushorts(f, n):
    return struct.unpack(f">{n}H", f.read(2 * n))


def _w_uchars(f, values):
    f.write(struct.pack(f">{len(values)}B", *values))


def _r_uchars(f, n):
    return struct.unpack(f">{n}B", f.read(n))


# ------------------------------------------------------------ DCVC / TCM

def dcvc_encode_i(height, width, y_string, z_string, output):
    with open(output, "wb") as f:
        _w_uints(f, (height, width, len(y_string), len(z_string)))
        f.write(y_string)
        f.write(z_string)


def dcvc_decode_i(path):
    with open(path, "rb") as f:
        h, w, ylen, zlen = _r_uints(f, 4)
        return h, w, f.read(ylen), f.read(zlen)


def dcvc_encode_p(height, width, mv_y, mv_z, y, z, output):
    with open(output, "wb") as f:
        _w_uints(f, (height, width, len(mv_y), len(mv_z), len(y), len(z)))
        for s in (mv_y, mv_z, y, z):
            f.write(s)


def dcvc_decode_p(path):
    with open(path, "rb") as f:
        h, w, l1, l2, l3, l4 = _r_uints(f, 6)
        return h, w, f.read(l1), f.read(l2), f.read(l3), f.read(l4)


def tcm_encode_p(string, output):
    with open(output, "wb") as f:
        _w_uints(f, (len(string),))
        f.write(string)


def tcm_decode_p(path):
    with open(path, "rb") as f:
        (n,) = _r_uints(f, 1)
        return f.read(n)


# ------------------------------------------------------------------- HEM

def hem_encode_i(height, width, q_index, bit_stream, output):
    with open(output, "wb") as f:
        _w_uints(f, (height, width))
        _w_ushorts(f, (q_index,))
        _w_uints(f, (len(bit_stream),))
        f.write(bit_stream)


def hem_decode_i(path):
    with open(path, "rb") as f:
        h, w = _r_uints(f, 2)
        (q_index,) = _r_ushorts(f, 1)
        (n,) = _r_uints(f, 1)
        return h, w, q_index, f.read(n)


def hem_encode_p(string, mv_y_q_index, y_q_index, output):
    with open(output, "wb") as f:
        _w_ushorts(f, (mv_y_q_index, y_q_index))
        _w_uints(f, (len(string),))
        f.write(string)


def hem_decode_p(path):
    with open(path, "rb") as f:
        mv_q, y_q = _r_ushorts(f, 2)
        (n,) = _r_uints(f, 1)
        return mv_q, y_q, f.read(n)


# -------------------------------------------------------------------- DC

def dc_encode_i(height, width, q_in_ckpt, q_index, bit_stream, output):
    with open(output, "wb") as f:
        _w_uints(f, (height, width))
        _w_uchars(f, ((int(q_in_ckpt) << 7) + (q_index << 1),))
        _w_uints(f, (len(bit_stream),))
        f.write(bit_stream)


def dc_decode_i(path):
    with open(path, "rb") as f:
        h, w = _r_uints(f, 2)
        (flag,) = _r_uchars(f, 1)
        q_in_ckpt = (flag >> 7) > 0
        q_index = (flag & 0x7F) >> 1
        (n,) = _r_uints(f, 1)
        return h, w, q_in_ckpt, q_index, f.read(n)


def dc_encode_p(string, q_in_ckpt, q_index, frame_idx, output):
    with open(output, "wb") as f:
        _w_uchars(f, ((int(q_in_ckpt) << 7) + (q_index << 1), frame_idx))
        _w_uints(f, (len(string),))
        f.write(string)


def dc_decode_p(path):
    with open(path, "rb") as f:
        flag, frame_idx = _r_uchars(f, 2)
        q_in_ckpt = (flag >> 7) > 0
        q_index = (flag & 0x7F) >> 1
        (n,) = _r_uints(f, 1)
        return q_in_ckpt, q_index, frame_idx, f.read(n)


# ----------------------------------------------------------- FM NAL/SPS

def _write_uint_adaptive(f, v):
    """FM's 2/4-byte adaptive uint (DCVC-FM stream_helper.py:99-113):
    2 bytes big-endian if <= 32767, else 4 bytes with the top bit set.
    (UF's 1/2/4-byte variant lives in bitstream/nal.py.)"""
    if v <= 32767:
        _w_uchars(f, (v >> 8, v & 0xFF))
        return 2
    assert v < (1 << 30)
    _w_uchars(f, (((v >> 24) & 0xFF) | 0x80, (v >> 16) & 0xFF,
                  (v >> 8) & 0xFF, v & 0xFF))
    return 4


def _read_uint_adaptive(f):
    b3, b2 = _r_uchars(f, 2)
    if (b3 >> 7) == 0:
        return (b3 << 8) + b2
    b1, b0 = _r_uchars(f, 2)
    return ((b3 & 0x7F) << 24) + (b2 << 16) + (b1 << 8) + b0


FM_NAL_SPS = 0
FM_NAL_I = 1
FM_NAL_P = 2


class FMSPSHelper:
    """FM SPS dedupe by (h, w, qp, fa_idx)
    (DCVC-FM/src/utils/stream_helper.py:135-165)."""

    def __init__(self):
        self.spss = []

    def get_sps_id(self, target):
        min_id = -1
        for sps in self.spss:
            if all(sps[k] == target[k]
                   for k in ("height", "width", "qp", "fa_idx")):
                return sps["sps_id"], False
            min_id = max(min_id, sps["sps_id"])
        assert min_id < 15
        sps = dict(target)
        sps["sps_id"] = min_id + 1
        self.spss.append(sps)
        return sps["sps_id"], True

    def add_sps_by_id(self, sps):
        for i, old in enumerate(self.spss):
            if old["sps_id"] == sps["sps_id"]:
                self.spss[i] = dict(sps)
                return
        self.spss.append(dict(sps))

    def get_sps_by_id(self, sps_id):
        for sps in self.spss:
            if sps["sps_id"] == sps_id:
                return sps
        return None


def fm_write_sps(f, sps):
    """FM stream_helper.py:168-181."""
    assert sps["sps_id"] < 16 and sps["qp"] < 64 and sps["fa_idx"] < 4
    _w_uchars(f, ((FM_NAL_SPS << 4) + sps["sps_id"],))
    n = 1
    n += _write_uint_adaptive(f, sps["height"])
    n += _write_uint_adaptive(f, sps["width"])
    _w_uchars(f, ((sps["qp"] << 2) + sps["fa_idx"],))
    return n + 1


def fm_read_header(f):
    (flag,) = _r_uchars(f, 1)
    return {"nal_type": flag >> 4, "sps_id": flag & 0x0F}


def fm_read_sps_remaining(f, sps_id):
    sps = {"sps_id": sps_id}
    sps["height"] = _read_uint_adaptive(f)
    sps["width"] = _read_uint_adaptive(f)
    (flag,) = _r_uchars(f, 1)
    sps["qp"] = flag >> 2
    sps["fa_idx"] = flag & 0x03
    return sps


def fm_write_ip(f, is_i_frame, sps_id, bit_stream):
    """FM stream_helper.py:219-227."""
    _w_uchars(f, ((int(FM_NAL_I if is_i_frame else FM_NAL_P) << 4)
                  + sps_id,))
    n = 1 + _write_uint_adaptive(f, len(bit_stream))
    f.write(bit_stream)
    return n + len(bit_stream)


def fm_read_ip_remaining(f):
    n = _read_uint_adaptive(f)
    return f.read(n)


# ---------------------------------------------------------------- DCVC-RT
# NAL/SPS container (DCVC-RT/src/utils/stream_helper.py:108-218): SPS
# carries {height, width, ec_part(1b), use_ada_i(1b)}; the per-frame IP
# payload carries {qp u8, adaptive length, bytes} — unlike FM, qp lives
# in the IP NAL (it changes per frame under the qp_shift schedule).
# RT already uses UF's 1/2/4-byte adaptive uint (stream_helper.py:68-105),
# not FM's 2/4-byte one.

from .nal import read_uint_adaptive as _rt_read_uint
from .nal import write_uint_adaptive as _rt_write_uint

RT_NAL_SPS = 0
RT_NAL_I = 1
RT_NAL_P = 2


class RTSPSHelper:
    """RT SPS dedupe by (h, w, use_ada_i, ec_part)
    (DCVC-RT/src/utils/stream_helper.py:114-145)."""

    def __init__(self):
        self.spss = []

    def get_sps_id(self, target):
        min_id = -1
        for sps in self.spss:
            if all(sps[k] == target[k]
                   for k in ("height", "width", "use_ada_i", "ec_part")):
                return sps["sps_id"], False
            min_id = max(min_id, sps["sps_id"])
        assert min_id < 15
        sps = dict(target)
        sps["sps_id"] = min_id + 1
        self.spss.append(sps)
        return sps["sps_id"], True

    def add_sps_by_id(self, sps):
        for i, old in enumerate(self.spss):
            if old["sps_id"] == sps["sps_id"]:
                self.spss[i] = dict(sps)
                return
        self.spss.append(dict(sps))

    def get_sps_by_id(self, sps_id):
        for sps in self.spss:
            if sps["sps_id"] == sps_id:
                return sps
        return None


def rt_write_sps(f, sps):
    """RT stream_helper.py:148-162."""
    assert sps["sps_id"] < 16 and sps["use_ada_i"] < 2 and sps["ec_part"] < 2
    _w_uchars(f, ((RT_NAL_SPS << 4) + sps["sps_id"],))
    n = 1
    n += _rt_write_uint(f, sps["height"])
    n += _rt_write_uint(f, sps["width"])
    _w_uchars(f, ((sps["ec_part"] << 2) + sps["use_ada_i"],))
    return n + 1


def rt_read_header(f):
    (flag,) = _r_uchars(f, 1)
    return {"nal_type": flag >> 4, "sps_id": flag & 0x0F}


def rt_read_sps_remaining(f, sps_id):
    sps = {"sps_id": sps_id}
    sps["height"] = _rt_read_uint(f)
    sps["width"] = _rt_read_uint(f)
    (flag,) = _r_uchars(f, 1)
    sps["ec_part"] = (flag >> 2) & 0x01
    sps["use_ada_i"] = flag & 0x01
    return sps


def rt_write_ip(f, is_i_frame, sps_id, qp, bit_stream):
    """RT stream_helper.py:198-209 — qp u8 per frame (qp_shift schedule)."""
    assert 0 <= qp < 256
    _w_uchars(f, ((int(RT_NAL_I if is_i_frame else RT_NAL_P) << 4)
                  + sps_id,))
    _w_uchars(f, (qp,))
    n = 2 + _rt_write_uint(f, len(bit_stream))
    f.write(bit_stream)
    return n + len(bit_stream)


def rt_read_ip_remaining(f):
    (qp,) = _r_uchars(f, 1)
    n = _rt_read_uint(f)
    return qp, f.read(n)
