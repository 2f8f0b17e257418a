"""Self time of the program's entropy.encode spans (the host rANS encode
of a unit: reset, lanes, the encode calls, flush, the stream) in the
traced encode calls, per frame encoded (benchmark/program_spans.py); the
program's twin of host_rans_ms_per_frame.enc."""

from benchmark.program_spans import self_us, split

LAYER = "entropy"
MOVES = "encode_fps"
UNIT = "ms/frame"
KIND = "enc"


def read(trace):
    sp = split(trace)
    if sp is None or not trace.frames[KIND]:
        return None
    us = self_us(sp["spans"][KIND], "entropy.encode")
    if us <= 0:
        return None
    return us / 1e3 / trace.frames[KIND]
