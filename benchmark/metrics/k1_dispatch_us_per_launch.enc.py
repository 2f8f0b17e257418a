"""Host time of one K1 dispatch in the encode calls: the mean duration of
the program's k1.launch spans (fused_dcb_launch and
fused_dcb_stacked_launch: the operand checks, the plan and the ctypes
call) in the traced encode calls (benchmark/program_spans.py)."""

from benchmark.program_spans import split

LAYER = "kernels"
MOVES = "encode_fps"
UNIT = "us/launch"
KIND = "enc"


def read(trace):
    sp = split(trace)
    if sp is None:
        return None
    times = [e - s for s, e, _, n in sp["spans"][KIND] if n == "k1.launch"]
    if not times:
        return None
    return sum(times) / len(times)
