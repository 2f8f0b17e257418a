"""Device idle share of the encode calls: 1 - (union of the device
operations' intervals) / (the calls' wall time), from torch.profiler."""

from benchmark.tracing import busy_us, call_us

LAYER = "device"
MOVES = "encode_fps"
UNIT = "%"
KIND = "enc"


def read(trace):
    wall, busy = call_us(trace, KIND), busy_us(trace, KIND)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
