"""What a traced run hands the per-layer readers, and the arithmetic
they share.

A `Trace` holds, for the traced window: the host spans of the coding
calls by kind ("enc", "dec") as the benchmark recorded them
(torch.profiler.record_function), every device operation the profiler
saw (kernels, copies, memsets) on the same clock, the frames and
requests coded, the host seconds inside the rANS coder's methods per
kind, and the work of one request counted on the frozen reference
(FLOPs per kind, the K1 roofline bound of the encode).  Times are in
microseconds.
"""

import dataclasses
import re

from benchmark.reference.counts import union_length


@dataclasses.dataclass
class Trace:
    calls: dict            # kind -> [(start_us, end_us)]
    device: list           # [(name, start_us, end_us)]
    frames: dict           # kind -> frames coded in the traced calls
    requests: dict         # kind -> requests coded
    host_coder_s: dict     # kind -> host seconds inside the coder
    work: dict             # flops.enc, flops.dec, k1_bound_ms.enc per request


def in_calls(trace, kind):
    """The device operations that start inside a call of `kind` (each
    call is bracketed by synchronisations, so its device work lies in its
    host span)."""
    spans = sorted(trace.calls[kind])
    out = []
    for name, s, e in trace.device:
        for a, b in spans:
            if a <= s <= b:
                out.append((name, s, e))
                break
    return out


def call_us(trace, kind):
    return sum(b - a for a, b in trace.calls[kind])


def busy_us(trace, kind):
    return union_length([(s, e) for _, s, e in in_calls(trace, kind)])


def kernel_us(trace, kind, pattern):
    """Device time of the operations of `kind`'s calls whose names match
    the regular expression `pattern`."""
    rx = re.compile(pattern)
    return sum(e - s for n, s, e in in_calls(trace, kind) if rx.search(n))
