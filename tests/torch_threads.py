"""Caps torch's intra-op thread pool in a process that runs the port's
tests: every tests/test_torch_*.py imports this module first.

Under pytest-xdist each worker's torch would otherwise start one thread
per core, so that `-n 6` on 8 cores runs ~48 busy threads and the port's
CPU tests take several times their single-process wall.  The cap gives
each worker its share of the cores (at least one thread); a run without
xdist keeps torch's default.  The results must not depend on it:
tests/test_torch_hem_codec.py holds a codec's bytes at 1 and at 4
threads.
"""

import os

import torch


def share_of_cores():
    """The cores this process may use over the number of test workers
    (PYTEST_XDIST_WORKER_COUNT, which xdist sets in each worker)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


def cap_threads():
    n = min(torch.get_num_threads(), share_of_cores())
    if n != torch.get_num_threads():
        torch.set_num_threads(n)
    return n


cap_threads()
