"""BD-rate comparison against an anchor (counterpart of the JAX
package's compare_bd_rate.py, the role of the reference
compare_bd_rate.py):

    python3 -m dcvc_tpu_torch.eval.compare_bd_rate --base_method VTM \
        --log_paths VTM anchor.json ours result.json \
        [--compare_between class|sequence] [--compare_frame_type all] \
        [--output_path bd.json] [--plot_path DIR] [--allow_extrapolation]

Loads {name: result JSON} written by eval/video_main (or any file of the
test_video.py schema, such as the vendored VTM-17.0 anchor), averages
each rate point over the sequences of a class weighted by frame counts,
computes the Bjøntegaard BD-rate (utils/bd_metric.py) per class (or
sequence) and frame type against the anchor, prints the table and, with
--output_path, writes the JSON: the arguments, table and JSON of
compare_bd_rate.py.  --compare_between sequence treats each sequence as
a class of one (compare_bd_rate.py's own sequence mode raises on the
rate level of any result file).  --plot_path draws the RD curves with
matplotlib, imported only then; without matplotlib (the GPU machine has
none) it raises rather than skip the plots.
"""

import argparse
import json
import os
import sys

import numpy as np

from ..utils.bd_metric import bd_rate


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--compare_between", type=str, default="class",
                        choices=["class", "sequence"])
    parser.add_argument("--compare_frame_type", type=str, default="default",
                        choices=["default", "all"])
    parser.add_argument("--base_method", type=str, required=True)
    parser.add_argument("--log_paths", type=str, required=True, nargs="+",
                        help="pairs: name path name path ...")
    parser.add_argument("--output_path", type=str, default="stdout")
    parser.add_argument("--plot_path", type=str, default="")
    parser.add_argument("--allow_extrapolation", action="store_true",
                        help="BD-rate over the union distortion range "
                             "when curves do not overlap (labeled, "
                             "out-of-spec; for untrained sanity runs)")
    parser.add_argument("--distortion_metrics", type=str, nargs="+",
                        default=["psnr"],
                        choices=["psnr", "msssim", "psnr_y", "psnr_u",
                                 "psnr_v", "msssim_y", "msssim_u", "msssim_v"])
    return parser.parse_args(argv)


def mean_over_sequence(res, metric):
    """Average each rate point over the sequences of a class, weighted by
    frame counts (reference mean_over_rate_point/mean_over_sequence)."""
    out = {}
    for method, classes in res.items():
        out[method] = {}
        for ds_name, seqs in classes.items():
            rate_points = {}
            for seq_results in seqs.values():
                for rp, v in seq_results.items():
                    rate_points.setdefault(rp, []).append(v)
            out[method][ds_name] = {
                rp: _mean_point(vals, metric)
                for rp, vals in sorted(rate_points.items())}
    return out


def _mean_point(vals, metric):
    agg = {}
    for ft in ("i", "p", "all"):
        bpp = dist = n = 0.0
        for v in vals:
            if ft == "i":
                num = v["i_frame_num"]
            elif ft == "p":
                num = v["p_frame_num"]
            else:
                num = v["i_frame_num"] + v["p_frame_num"]
            bpp += v[f"ave_{ft}_frame_bpp"] * num
            dist += v[f"ave_{ft}_frame_{metric}"] * num
            n += num
        n = max(n, 1)
        agg[f"ave_{ft}_frame_bpp"] = bpp / n
        agg[f"ave_{ft}_frame_{metric}"] = dist / n
    return agg


def _curve(points, metric, frame_type):
    bpp = [p[f"ave_{frame_type}_frame_bpp"] for p in points.values()]
    dist = [p[f"ave_{frame_type}_frame_{metric}"] for p in points.values()]
    return bpp, dist


def compute_bd_rates(data, base, metric, frame_type,
                     allow_extrapolation=False):
    """data: method -> class -> rate_point -> means."""
    results = {}
    for method, classes in data.items():
        if method == base:
            continue
        results[method] = {}
        for ds_name, points in classes.items():
            if ds_name not in data[base]:
                continue
            bpp_a, dist_a = _curve(data[base][ds_name], metric, frame_type)
            bpp_t, dist_t = _curve(points, metric, frame_type)
            if (len(bpp_t) >= 3 and bpp_a[0] > 0 and dist_t[0]
                    and dist_t[0] > 0):
                results[method][ds_name] = bd_rate(
                    bpp_a, dist_a, bpp_t, dist_t,
                    extrapolate=allow_extrapolation)
    return results


def print_table(results, title):
    ds_names = sorted({d for m in results.values() for d in m})
    methods = sorted(results)
    if not ds_names:
        return
    col = max([len(d) for d in ds_names] + [12])
    header = "method".ljust(24) + "".join(d.rjust(col + 2) for d in ds_names) \
        + "    average".rjust(col)
    print(f"\n== BD-rate (%) vs anchor — {title} ==")
    print(header)
    for m in methods:
        row = m.ljust(24)
        vals = []
        for d in ds_names:
            v = results[m].get(d)
            row += (f"{v:+.2f}".rjust(col + 2) if v is not None
                    else "-".rjust(col + 2))
            if v is not None and np.isfinite(v):
                vals.append(v)
        avg = np.mean(vals) if vals else float("nan")
        row += f"{avg:+.2f}".rjust(col)
        print(row)


def plot_rd_curves(data, metric, frame_type, plot_path):
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--plot_path needs matplotlib, which is not "
                           "installed; run without --plot_path") from e
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    os.makedirs(plot_path, exist_ok=True)
    ds_names = sorted({d for m in data.values() for d in m})
    for ds_name in ds_names:
        plt.figure()
        for method, classes in data.items():
            if ds_name not in classes:
                continue
            bpp, dist = _curve(classes[ds_name], metric, frame_type)
            order = np.argsort(bpp)
            plt.plot(np.asarray(bpp)[order], np.asarray(dist)[order],
                     marker="o", label=method)
        plt.grid(True)
        plt.xlabel("bpp")
        plt.ylabel(metric)
        plt.title(ds_name)
        plt.legend(loc="lower right")
        plt.savefig(os.path.join(plot_path,
                                 f"rd_{metric}_{frame_type}_{ds_name}.png"))
        plt.close("all")


def main(argv=None):
    """Prints the tables; returns {metric: {frame type: BD-rates}}, which
    --output_path receives."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if len(args.log_paths) % 2:
        raise ValueError("--log_paths takes name path pairs")
    raw = {}
    for i in range(0, len(args.log_paths), 2):
        name, path = args.log_paths[i], args.log_paths[i + 1]
        with open(path) as f:
            raw[name] = json.load(f)
    if args.base_method not in raw:
        raise ValueError(f"anchor {args.base_method} not in logs")

    if args.compare_between == "sequence":
        # each sequence a class of its own (compare_bd_rate.py wraps the
        # rate points one level too shallow and fails on any result file)
        raw = {m: {seq: {seq: rates} for seqs in classes.values()
                   for seq, rates in seqs.items()}
               for m, classes in raw.items()}

    frame_types = (["i", "p", "all"] if args.compare_frame_type == "default"
                   else ["all"])

    out = {}
    for metric in args.distortion_metrics:
        data = mean_over_sequence(raw, metric)
        out[metric] = {}
        for ft in frame_types:
            results = compute_bd_rates(data, args.base_method, metric, ft,
                                       args.allow_extrapolation)
            out[metric][ft] = results
            print_table(results, f"{metric}, {ft}-frames")
            if args.plot_path:
                plot_rd_curves(data, metric, ft, args.plot_path)

    if args.output_path != "stdout":
        with open(args.output_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
