from .nal import (
    NalType, SPSHelper, read_header, read_sps_remaining, read_ip_remaining,
    write_sps, write_ip, read_uint_adaptive, write_uint_adaptive, filesize,
)

__all__ = [
    "NalType", "SPSHelper", "read_header", "read_sps_remaining",
    "read_ip_remaining", "write_sps", "write_ip",
    "read_uint_adaptive", "write_uint_adaptive", "filesize",
]
