"""Readings that set a cell's limits on `recon_mae_max.qp<q>`, in one
process:

    python3 benchmark/readings.py --workload <cell> --seeds S1 S2 ... \\
        [--control-seeds C1 C2 C3] [--seconds 4]

For each of --seeds, a run of the cell (run.run_cell, a short window at
the cell's own load and sizes, every QP compared): per QP, the program's
widest per-frame mean absolute gap to the float32 reference (the lower
reading is the largest over the seeds).  For each of --control-seeds,
the control (control.Control: the reference itself computed in float8
e4m3, the precision below the configurations' bfloat16) put in the
program's place in a run of the cell, on as many requests of each QP as
a run compares (the upper reading is the smallest).  One JSON
line per reading; the last line sums them up per QP.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run  # noqa: E402


def every_qp(cell):
    """Overrides that compare every QP of the cell, at no limit."""
    wl, _, _ = run.load_cell(cell)
    return {"workload": {"limits": {"recon_mae_max": {
        str(q): float("inf") for q in wl["qps"]}}}}


def gaps(result):
    """{qp: value} of a run's recon_mae_max checks."""
    return {k.split(".qp")[1]: c["value"]
            for k, c in result["checks"].items() if k.startswith("recon_")}


def control_run(cell, seed, device="cuda", overrides=None):
    """A run of the cell with the control in the program's place, on the
    cell's first `sample` requests of each QP (as many as a run
    compares)."""
    wl, _, _ = run.load_cell(cell, overrides)
    return run.run_cell(cell, seed, 1e9, device=device, overrides=overrides,
                        control=True,
                        max_requests=wl["sample"] * len(wl["qps"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    program, control = [], []
    for seed in args.seeds:
        t0 = time.time()
        res = run.run_cell(args.workload, seed, args.seconds, t_start=t0,
                           overrides=every_qp(args.workload))
        program.append(gaps(res))
        print(json.dumps({"reading": "program", "seed": seed,
                          "gap": program[-1], "failed": res["failed"],
                          "attempted": res["attempted"],
                          "metrics": res["metrics"],
                          "seconds": time.time() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.time()
        res = control_run(args.workload, seed,
                          overrides=every_qp(args.workload))
        control.append(gaps(res))
        print(json.dumps({"reading": "control", "seed": seed,
                          "gap": control[-1],
                          "seconds": time.time() - t0}), flush=True)
    qps = sorted({q for g in program + control for q in g}, key=int)
    print(json.dumps({
        "workload": args.workload,
        "lower": {q: max((g[q] for g in program if g.get(q) is not None),
                         default=None) for q in qps},
        "upper": {q: min((g[q] for g in control if q in g), default=None)
                  for q in qps}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
