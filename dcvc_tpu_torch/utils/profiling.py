"""The port's spans and counters, on torch.profiler's clock, and the
operator's trace (counterpart of dcvc_tpu/utils/profiling.py: the
reference brackets encode and decode with CUDA events; the port traces
with torch.profiler).

`span(name)` brackets a stage of the codecs; `count(name, n)` adds to a
named counter.  Both record only while torch.profiler is on: off, a span
is one check of the profiler's flag and a shared null context (no
allocation, no record_function), and a count is the same check.  On, a
span enters a FUNCTION-scope profiler event (`_RecordFunctionFast`), so
the host event lands in the profiler's events and Chrome trace on the
kernels' clock, and it appends (name, parent index, request id, start_ns,
end_ns) to an in-memory list, with time.time_ns() times (the profiler's
timestamps are unix-epoch ns too).  record_function is not used: it costs
~12 us a span even with the profiler off, and its USER_SCOPE events are
mirrored on the device's timeline as GPU user annotations, where they
would read as device work.  A span whose name starts with "codec." and
that has no parent is a request: it draws a new request id, which every
span under it carries.  The recorder keeps one stack of open spans, so
spans are recorded from one thread at a time (the codecs run on one).
Nothing here reads a device tensor or waits for the card.

The names the codecs use (README, "Tracing"): requests codec.compress,
codec.decompress, codec.compress_many, codec.compress_sequence,
codec.decompress_many, codec.decompress_sequence, codec.dpb_seed; halves
codec.compress_async, codec.compress_finish, codec.decode_unit; device
stages stage.analysis, stage.adaptor, stage.prior, stage.quant,
stage.step, stage.synthesis, stage.final, stage.recon, stage.seed (the
DPB seed's pad and unshuffle); host copies copy.start, wait.copy;
entropy entropy.encode, entropy.upload, entropy.decode_z,
entropy.decode_y; kernels k1.launch, k2.launch; blocks dcb.rt (a call of
DCVC-RT's two-way DepthConvBlock, which runs as plain ops).  The counter:
entropy.symbols, the z and y symbols coded by compress_finish.
"""

import contextlib
import functools
import json
import os
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

MAX_SPANS = 1 << 20

_NULL = contextlib.nullcontext()
_spans = []            # [name, parent index, request id, start_ns, end_ns]
_stack = []            # indexes of the open spans, outermost first
_counters = {}
_state = {"dropped": 0, "requests": 0}


class _Span:
    """A span while the profiler is on (span() makes one)."""

    __slots__ = ("name", "event", "entry")

    def __init__(self, name):
        self.name = name
        self.event = _RecordFunctionFast(name)
        self.entry = None

    def __enter__(self):
        self.event.__enter__()
        if len(_spans) >= MAX_SPANS:
            _state["dropped"] += 1
            return self
        if _stack:
            parent = _stack[-1]
            request = _spans[parent][2]
        else:
            parent = -1
            request = None
            if self.name.startswith("codec."):
                _state["requests"] += 1
                request = _state["requests"]
        self.entry = [self.name, parent, request, time.time_ns(), None]
        _stack.append(len(_spans))
        _spans.append(self.entry)
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[4] = time.time_ns()
            _stack.pop()
        self.event.__exit__(*exc)
        return False


def span(name):
    """A context manager recording the enclosed block as span `name` while
    torch.profiler is on; a shared null context otherwise."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


def spanned(name):
    """Decorator: each call of the function is a span `name` (off, one
    check and the call)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name, n):
    """Adds n to counter `name` while torch.profiler is on."""
    if _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + int(n)


def records():
    """{"spans": [(name, parent index, request id, start_ns, end_ns)],
    "counters": {name: total}, "dropped": spans not kept (past
    MAX_SPANS)}, without clearing them; a span still open has end_ns
    None, a span with no parent the index -1."""
    return {"spans": [tuple(s) for s in _spans],
            "counters": dict(_counters), "dropped": _state["dropped"]}


def reset():
    """Clears the spans, counters and drops (outside every span)."""
    _spans.clear()
    _stack.clear()
    _counters.clear()
    _state["dropped"] = 0


@contextlib.contextmanager
def trace(log_dir):
    """A Chrome trace of the enclosed block (host, with the codecs' spans,
    and the card's kernels when there is one) written under log_dir as
    trace.json, and the block's counters as counters.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    rec = records()
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump({"counters": rec["counters"], "spans": len(rec["spans"]),
                   "dropped": rec["dropped"]}, f, indent=1)
