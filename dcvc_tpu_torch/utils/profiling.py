"""Tracing and stage timing (counterpart of dcvc_tpu/utils/profiling.py:
the reference brackets encode and decode with CUDA events; the port
traces with torch.profiler).
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """A Chrome trace of the enclosed block (host, and the card's kernels
    when there is one) written under log_dir as trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Wall-clock stage timing with device synchronization: the role of
    the reference's CUDA-event brackets (test_video.py:194-264)."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        """Times the block; `sync`, a tensor, is waited for first (on a
        CUDA device: its stream is synchronised)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.current_stream(sync.device).synchronize()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self):
        return {name: {"mean_ms": 1000 * sum(v) / len(v), "count": len(v)}
                for name, v in self.times.items()}
