"""Assemble a training-evidence artifact from trainer logs (counterpart
of the JAX repo's scripts/collect_train_artifact.py).

Parses the per-step metric lines the trainers print ("Time: ..., epoch N
step M: loss X mse Y bpp Z gnorm G lr L"; the port's train/image_main.py
and train/video_main.py print the JAX trainers' format) into per-stage
loss curves and bundles them with the BD gate's RD points, so that one
artifact shows the loss trajectory and the resulting rate-distortion
behaviour.

    python3 -m dcvc_tpu_torch.eval.collect_train_artifact \
        --stage stage1=train_hts_s1.log --stage stage2=train_hts_s2.log \
        --note "..." --gate BD_GATE.json --out TRAIN_HTS.json
"""

import argparse
import json
import os
import re

LINE = re.compile(
    r"Time: ([0-9.]+)s, epoch (\d+) step (\d+): loss ([-0-9.e+]+) "
    r"mse ([-0-9.e+]+) bpp ([-0-9.e+]+) gnorm ([-0-9.e+]+) lr ([-0-9.e+]+)")


def parse_log(path):
    """Per-epoch metric trajectory: first and last printed step of each
    epoch (the trainers print every 50/200 steps)."""
    epochs = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = LINE.search(line)
            if not m:
                continue
            t, ep, step, loss, mse, bpp, gnorm, lr = m.groups()
            rec = {"step": int(step), "loss": float(loss),
                   "mse": float(mse), "bpp": float(bpp),
                   "grad_norm": float(gnorm), "lr": float(lr)}
            epochs.setdefault(int(ep), []).append(rec)
    out = []
    for ep in sorted(epochs):
        recs = epochs[ep]
        entry = {"epoch": ep, **{k: recs[-1][k] for k in
                                 ("loss", "mse", "bpp", "grad_norm", "lr")}}
        out.append(entry)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", action="append", default=[],
                    help="name=logpath (repeatable, ordered)")
    ap.add_argument("--cmd", action="append", default=[],
                    help="name=trainer command (repeatable)")
    ap.add_argument("--note", required=True)
    ap.add_argument("--gate", default=None,
                    help="BD-gate artifact to embed rd_points from")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    stages = {}
    for spec in args.stage:
        name, path = spec.split("=", 1)
        stages[name] = parse_log(path)
        if not stages[name]:
            raise SystemExit(f"no metric lines parsed from {path}")
    cmds = dict(s.split("=", 1) for s in args.cmd)

    artifact = {"note": args.note, "trainer_cmds": cmds,
                "loss_curves": stages}
    if args.gate:
        with open(args.gate) as f:
            gate = json.load(f)
        artifact["bd_gate"] = {
            k: gate.get(k) for k in
            ("rd_monotone", "bd_rate_pct_vs_vtm17", "rd_points",
             "trained_weights", "extrapolated")}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    n = {k: len(v) for k, v in stages.items()}
    print(f"wrote {args.out} (epochs per stage: {n})")
    return artifact


if __name__ == "__main__":
    main()
