"""Device-idle time of the decode calls under the program's dispatch spans
(stage.*, k1.launch, k2.launch: the host queueing a codec stage or a
kernel while the card has nothing to run), over the calls' wall time
(benchmark/program_spans.py)."""

from benchmark.program_spans import split
from benchmark.tracing import busy_us, call_us

LAYER = "device"
MOVES = "decode_fps"
UNIT = "%"
KIND = "dec"


def read(trace):
    sp, wall = split(trace), call_us(trace, KIND)
    if sp is None or wall <= 0 or busy_us(trace, KIND) <= 0:
        return None
    return 100.0 * sp["by_category"][KIND].get("dispatch", 0.0) / wall
