"""The device time of the kernels launched inside the program's spans of
one name, read through the profiler's correlation of each kernel with
the CPU operation that launched it.

The program's spans are FUNCTION-scope profiler events
(dcvc_tpu_torch.utils.profiling), so the profiler's event tree holds
each span with the operations called inside it, and the profiler
attaches each kernel (FunctionEvent.kernels) to the CPU operation that
launched it: a span's kernels are those of the span and of every event
under it.  The Trace the harness hands its readers keeps the device
operations' names and times but not that correlation.  The profiler the
trace was read from is still held by the harness's run (run.run_cell)
while the readers run, in one of their callers' frames: `profiler_events`
takes its events from there, and returns None where no caller holds one
(the readers then say None).  Times are in microseconds.
"""

import sys

import torch


def profiler_events():
    """The events of the innermost torch.profiler.profile that a caller's
    frame holds, or None."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, torch.profiler.profile):
                return value.events()
        frame = frame.f_back
    return None


def span_kernel_us(trace, kind, name, events):
    """Summed durations of the kernels launched inside the spans called
    `name` that open in a call of `kind`, or None where no such span is
    among `events`."""
    if events is None:
        return None
    calls = sorted(trace.calls[kind])
    seen, total, found = set(), 0.0, False
    for event in events:
        if event.name != name or not any(
                a <= event.time_range.start <= b for a, b in calls):
            continue
        found = True
        stack = [event]
        while stack:
            ev = stack.pop()
            if id(ev) in seen:          # a span nested in another
                continue
            seen.add(id(ev))
            total += sum(k.duration for k in ev.kernels)
            stack.extend(ev.cpu_children)
    return total if found else None
