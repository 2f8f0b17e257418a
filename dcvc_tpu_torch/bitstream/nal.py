"""NAL-style bitstream container, byte-compatible with the reference
format (src/utils/stream_helper.py):

  NAL header   : 1 byte = nal_type(4) | sps_id(4)
  SPS payload  : height, width as adaptive uints
  I/P payload  : qp u8; ec_part(7) | reset_feature_memory(1); adaptive
                 length; raw rANS bytes
  adaptive uint: 1 byte  (<2^7,  tag 0), 2 bytes (<2^14, tag 0b10 in the
                 high byte), 4 bytes (<2^30, tag 0b11)
"""

import enum
import os


class NalType(enum.IntEnum):
    NAL_SPS = 0
    NAL_I = 1
    NAL_P = 2


def filesize(path):
    return os.stat(path).st_size


def write_uint_adaptive(f, a):
    if a < (1 << 7):
        f.write(bytes((a,)))
        return 1
    if a < (1 << 14):
        f.write(bytes((((a >> 8) & 0xFF) | (0x02 << 6), a & 0xFF)))
        return 2
    assert a < (1 << 30)
    f.write(bytes((((a >> 24) & 0xFF) | (0x03 << 6),
                   (a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF)))
    return 4


def read_uint_adaptive(f):
    a3 = f.read(1)[0]
    if (a3 >> 7) == 0:
        return a3
    a2 = f.read(1)[0]
    if (a3 >> 6) == 0x02:
        return ((a3 & 0x3F) << 8) + a2
    a1 = f.read(1)[0]
    a0 = f.read(1)[0]
    return ((a3 & 0x3F) << 24) + (a2 << 16) + (a1 << 8) + a0


def write_sps(f, sps):
    assert sps["sps_id"] < 16
    written = 0
    f.write(bytes(((int(NalType.NAL_SPS) << 4) + sps["sps_id"],)))
    written += 1
    written += write_uint_adaptive(f, sps["height"])
    written += write_uint_adaptive(f, sps["width"])
    return written


def write_ip(f, is_i_frame, sps_id, qp, ec_part, reset_feature_memory, bit_stream):
    written = 0
    nal = NalType.NAL_I if is_i_frame else NalType.NAL_P
    f.write(bytes(((int(nal) << 4) + sps_id,)))
    written += 1
    assert 0 <= qp < 256
    f.write(bytes((qp,)))
    written += 1
    f.write(bytes(((ec_part << 1) + int(reset_feature_memory),)))
    written += 1
    written += write_uint_adaptive(f, len(bit_stream))
    f.write(bit_stream)
    written += len(bit_stream)
    return written


def read_header(f):
    header = {}
    flag = f.read(1)[0]
    nal_type = flag >> 4
    header["nal_type"] = NalType(nal_type)
    if nal_type < 3:
        header["sps_id"] = flag & 0x0F
        return header
    # multi-frame grouped header (reserved nal types >= 3)
    frame_num = (flag & 0x0F) + 1
    header["frame_num"] = frame_num
    sps_ids = []
    for _ in range(0, frame_num, 2):
        flag = f.read(1)[0]
        sps_ids.append(flag >> 4)
        sps_ids.append(flag & 0x0F)
    header["sps_ids"] = sps_ids[:frame_num]
    return header


def read_sps_remaining(f, sps_id):
    return {
        "sps_id": sps_id,
        "height": read_uint_adaptive(f),
        "width": read_uint_adaptive(f),
    }


def read_ip_remaining(f):
    qp = f.read(1)[0]
    flag = f.read(1)[0]
    ec_part = (flag >> 1) & 0x7F
    reset_feature_memory = flag & 0x01
    stream_length = read_uint_adaptive(f)
    bit_stream = f.read(stream_length)
    return qp, ec_part, reset_feature_memory, bit_stream


class SPSHelper:
    """Deduplicates SPS entries by resolution (reference SPSHelper)."""

    def __init__(self):
        self.spss = []

    def add_sps_by_id(self, sps):
        for i, existing in enumerate(self.spss):
            if existing["sps_id"] == sps["sps_id"]:
                self.spss[i] = sps.copy()
                return
        self.spss.append(sps.copy())

    def get_sps_by_id(self, sps_id):
        for sps in self.spss:
            if sps["sps_id"] == sps_id:
                return sps
        return None

    def get_sps_id(self, target_sps):
        min_id = -1
        for sps in self.spss:
            if (sps["height"] == target_sps["height"]
                    and sps["width"] == target_sps["width"]):
                return sps["sps_id"], False
            min_id = max(min_id, sps["sps_id"])
        assert min_id < 15
        sps = target_sps.copy()
        sps["sps_id"] = min_id + 1
        self.spss.append(sps)
        return sps["sps_id"], True
