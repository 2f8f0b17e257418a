"""The dcvc_rt configuration's tiny sizes in test_bench_cells.py's tables
(TINY, TINY_LADDERS), which its cell-generic tests look up by
configuration: that file names the configurations it was written with,
and test_bench_rt.py holds dcvc_rt's."""

import sys


def pytest_collection_modifyitems(session, config, items):
    cells = sys.modules.get("benchmark.test_bench_cells")
    if cells is None:
        return
    from benchmark import test_bench_rt as rt
    cells.TINY.setdefault(rt.CONFIG, rt.TINY_WIDTHS)
    cells.TINY_LADDERS.setdefault(rt.CONFIG, rt.TINY_LADDERS)
