"""The port's single-card compile check and multi-rank dry run
(counterpart of __graft_entry__.py's entry / dryrun_multichip).

    python3 -m dcvc_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]
        [--inputs smooth|noise]

entry(): the DMCI training forward at 256x256 in bfloat16 on the card,
from seeded random weights, as (fn, example_args).

dryrun_multichip(n): one data-parallel training step of the TINY DMCI
(a global batch of 2n uint8 64x64 pictures) and one cascaded,
rematerialised 2-chunk step of the TINY DMC-LD (2n clips), over n ranks
spawned as processes, each on its rows (parallel/ddp.py: the gradient
averaged by one all-reduce before the clip), every process with the
trainers' settings (train.step.training_device).  Rank 0 reports the
ranks' mean loss, the grad norm, the clipped gradient and the parameters
after the step.  They are held against two references: one process on
each rank's rows in turn, its gradients averaged as the all-reduce
averages them (what the ranks must compute: within 1e-6), and one
process on the whole batch (loss and grad norm within 1e-5, relative,
the gradient and the parameters by params_close), which a batch split
may miss only by float32 rounding.  On the CPU the ranks talk over gloo;
on the card every rank uses cuda:0, also over gloo, whose CUDA
all-reduce goes through the host (NCCL refuses two ranks on one device).
A build of torch without gloo's CUDA all-reduce fails the run with its
error.  The pictures are smooth and the TINY models' kernels damped
(DAMP), so that the losses stay near 1; --inputs noise takes uniform
noise instead, on which the TINY LD runs near overflow.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from ..models.common import draw_noise, get_training_lambdas
from ..models.dmc_ld import DMCLD, TINY_LD_CONFIG
from ..models.dmci import DMCI, DMCIConfig, TINY_CONFIG
from ..train.step import Optimizer, image_loss, image_train_step, \
    training_device
from ..train.video_step import video_loss, video_train_step
from . import ddp

LR = 1e-4
SIDE = 64
REL = 1e-5          # against one process on the whole batch: loss and
GRAD_REL = 1e-5     # grad norm (relative), the gradient (of its norm)
SAME = 1e-6         # against one process on each rank's rows in turn
SIGN_SHARE = 1e-3   # params_close: the share of a moment's peak it trusts
EPS = 1e-8          # AdamW's eps


def entry(device="cuda"):
    """(fn, example_args): fn(x, qp, noise) -> (x_hat, bpp, mse), the
    training forward of DMCI at DMCIConfig() in bfloat16 on `device`,
    seeded random weights, on a (1, 256, 256, 3) input."""
    gen = torch.Generator().manual_seed(0)
    cfg = DMCIConfig()
    model = DMCI(cfg)
    model.reset_parameters(gen)
    model.to(device, torch.bfloat16).eval()
    x = torch.zeros(1, 256, 256, 3, dtype=torch.bfloat16, device=device)
    qp = torch.zeros(1, dtype=torch.long, device=device)
    noise = {k: v.to(torch.bfloat16) for k, v in
             draw_noise(cfg, 1, 256, 256, gen, device).items()}

    def fn(x, qp, noise):
        out = model(x, qp, noise)
        return out["x_hat"], out["bpp"], out["mse"]
    return fn, (x, qp, noise)


# conv kernels x this of the seeded init, by input: the TINY outputs stay
# in range on the smooth pictures; on uniform noise the TINY LD's cascaded
# outputs run near overflow (its loss ~1e4 on the CPU, ~5e6 on the card)
DAMP = {"smooth": {"image": 0.7, "ld": 0.5},
        "noise": {"image": 0.7, "ld": 0.7}}
MODELS = (("image", DMCI, TINY_CONFIG, 0.1), ("ld", DMCLD, TINY_LD_CONFIG,
                                               0.2))
# name: (train step, loss, their keyword arguments)
STEPS = {"image": (image_train_step, image_loss, {}),
         "ld": (video_train_step, video_loss,
                {"cascaded": True, "use_remat": True})}


def _damped(cls, cfg, seed, scale):
    """cls(cfg) from a seeded init, conv kernels x scale."""
    model = cls(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(scale)
    return model


def _pictures(rng, b, n, inputs):
    """n uint8 frames of b pictures: smooth ones drifting a pixel a
    frame, or uniform noise."""
    if inputs == "noise":
        return [rng.integers(0, 256, (b, SIDE, SIDE, 3), dtype=np.uint8)
                for _ in range(n)]
    from scipy.ndimage import uniform_filter
    base = rng.uniform(0, 255, (b, SIDE // 8 + 2, SIDE // 8 + 2, 3))
    img = uniform_filter(np.kron(base, np.ones((1, 8, 8, 1))),
                         size=(1, 9, 9, 1))
    return [np.clip(img[:, i:i + SIDE, i:i + SIDE], 0, 255).astype(np.uint8)
            for i in range(n)]


def _batches(n, inputs):
    """The global batches of the dry run: 2n samples each (numpy-seeded
    pictures), and the per-sample qp."""
    b = 2 * n
    rng = np.random.default_rng(0)
    image = _pictures(rng, b, 1, inputs)[0]
    frames = _pictures(rng, b, 1 + 2 * TINY_LD_CONFIG.frame_delay, inputs)
    seed = frames[0].astype(np.float32) / 255 - 0.5
    fd = TINY_LD_CONFIG.frame_delay
    clips = np.stack([np.concatenate(frames[1 + k * fd:1 + (k + 1) * fd],
                                     axis=-1) for k in range(2)], 1)
    qp = np.arange(b) % TINY_CONFIG.qp_num
    return {"image": image, "seed": seed, "clips": clips, "qp": qp}


def _problem(name, cls, cfg, n, device, inputs):
    """The damped TINY model of `name` on `device`, and args(rows): the
    step's arguments after the model and the optimizer, for these rows of
    the global batch and of its noise (drawn for the whole batch from one
    seeded generator, as every rank draws it)."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _batches(n, inputs).items()}
    total = 2 * n
    model = _damped(cls, cfg, 0, DAMP[inputs][name]).to(device)
    lambdas = torch.tensor(get_training_lambdas((8.0, 256.0), cfg.qp_num),
                           dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(42)
    noise = [draw_noise(cfg, total, SIDE, SIDE, gen, device)
             for _ in range(1 if name == "image" else 2)]

    def args(rows):
        qp = batch["qp"][rows].long()
        mine = [{k: v[rows] for k, v in d.items()} for d in noise]
        if name == "image":
            return batch["image"][rows], qp, lambdas, mine[0]
        return batch["seed"][rows], batch["clips"][rows], qp, lambdas, mine
    return model, args


def _result(metrics, model, opt):
    """(metrics as floats, state dict, first moments), on the CPU."""
    return ({k: float(v) for k, v in metrics.items() if k != "skipped"},
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {k: opt.adamw.state[p]["exp_avg"].cpu() for k, p in
             model.named_parameters()})


def _steps(dp, n, device, inputs):
    """One image step and one LD step on this rank's rows (all rows when
    dp is None), with the trainers' settings on the card (TF32 off,
    deterministic cuDNN: train.step.training_device, in every process).
    Returns {name: _result}; the metrics are the ranks' means."""
    device = training_device(device)
    rows = ddp.rows(dp, 2 * n)
    out = {}
    for name, cls, cfg, clip in MODELS:
        model, args = _problem(name, cls, cfg, n, device, inputs)
        opt = Optimizer(model, LR, clip, data_parallel=dp is not None)
        step, _, kw = STEPS[name]
        m = step(model, opt, *args(rows), **kw)
        if m["skipped"]:
            raise AssertionError(f"dry run: the {name} step was skipped")
        out[name] = _result(ddp.mean_metrics(m), model, opt)
    return out


def _rows_in_turn(n, device, inputs):
    """One process on each rank's rows in turn, what the ranks compute
    with no process group: each rank's loss and gradient, summed in rank
    order and divided by n (what the all-reduce does), then one clipped
    AdamW step.  Returns {name: _result}."""
    device = training_device(device)
    out = {}
    for name, cls, cfg, clip in MODELS:
        model, args = _problem(name, cls, cfg, n, device, inputs)
        opt = Optimizer(model, LR, clip)
        _, loss_fn, kw = STEPS[name]
        flat, metrics = None, []
        for r in range(n):
            loss, m = loss_fn(model, *args(ddp.rows(ddp.Rank(r, n, device),
                                                    2 * n)), **kw)
            loss.backward()
            g = torch.cat([(p.grad if p.grad is not None else
                            torch.zeros_like(p)).reshape(-1)
                           for p in opt.params])
            flat = g if flat is None else flat + g
            metrics.append({k: v.detach().float() for k, v in m.items()})
            opt.zero_grad()
        flat /= n
        offset = 0
        for p in opt.params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()
        grad_norm, skipped = opt.step()
        if skipped:
            raise AssertionError(f"dry run: the {name} step was skipped")
        m = {k: sum(mm[k] for mm in metrics) / n for k in metrics[0]}
        out[name] = _result(dict(m, grad_norm=grad_norm), model, opt)
    return out


def _rank_main(rank, n, device, inputs, init_method, out_path):
    dp = ddp.init(rank, n, device, init_method, backend="gloo")
    try:
        result = _steps(dp, n, device, inputs)
        if rank == 0:
            torch.save(result, out_path)
    finally:
        ddp.shutdown(dp)


def gaps(got, want):
    """How far one step (_result) is from another: loss and grad norm
    (relative), the clipped gradient (AdamW's first moment / 0.1; its
    largest element difference over the global norm, overall and in the
    per-QP tables, the parameters named q_*) and the parameters after the
    step (the largest difference)."""
    (gm, gs, gmom), (wm, ws, wmom) = got, want
    norm = float(torch.sqrt(sum((m / 0.1).pow(2).sum() for m in
                                wmom.values())))
    grad = {k: float((gmom[k] - wmom[k]).abs().max()) / 0.1 / norm
            for k in wmom}
    return {"loss": abs(gm["loss"] - wm["loss"]) / abs(wm["loss"]),
            "grad_norm": abs(gm["grad_norm"] - wm["grad_norm"]) /
            wm["grad_norm"],
            "grad": max(grad.values()),
            "grad_per_qp": max(v for k, v in grad.items()
                               if k.startswith("q_")),
            "params": max(float((gs[k] - ws[k]).abs().max()) for k in ws)}


def params_close(got, want, got_moments, moments, lr=LR):
    """One rank group's step against one process's on the whole batch,
    from the same parameters: every element of the averaged, clipped
    gradient (AdamW's first moment / 0.1) within GRAD_REL of one
    process's global gradient norm (a batch split sums in another order:
    elements that cancel over the batch's pixels, the per-QP tables',
    keep an error of ~1e-7 of the norm, while a rank's missing or doubled
    rows would move them by ~the norm itself); the parameters after the
    step within 1e-6 of each tensor's peak |p| plus 1e-4 lr where the
    gradient is at least SIGN_SHARE of its peak and 100 eps, else within
    2 lr (a near-zero gradient's sign may differ;
    tests/test_torch_train_step.py's rule).  Returns the count of
    elements outside the tight bound."""
    n_sign = 0
    norm = float(torch.sqrt(sum((m / 0.1).pow(2).sum() for m in
                                moments.values())))
    for name, w in want.items():
        g, gg = moments[name] / 0.1, got_moments[name] / 0.1
        peak = float(g.abs().max())
        if float((gg - g).abs().max()) > GRAD_REL * norm:
            raise AssertionError(f"{name}: the averaged gradient is "
                                 f"{float((gg - g).abs().max())} off (norm "
                                 f"{norm})")
        err = (got[name] - w).abs()
        tight = 1e-6 * float(w.abs().max()) + 1e-4 * lr
        sure = g.abs() >= max(SIGN_SHARE * peak, 100 * EPS)
        worst = float(err[sure].max()) if sure.any() else 0.0
        if worst > tight:
            raise AssertionError(f"{name}: {worst} > {tight}")
        if float(err.max()) > 2 * lr + tight:
            raise AssertionError(f"{name}: {float(err.max())}")
        n_sign += int((err > tight).sum())
    return n_sign


def dryrun_multichip(n_devices, device="cuda", init_method=None,
                     inputs="smooth"):
    """One data-parallel image step and one LD step over n_devices ranks
    (processes) on `device` (every rank on the same device), held against
    one process on each rank's rows in turn (within SAME) and against one
    process on the whole batch (REL, params_close).  Prints the gaps of
    both comparisons, then raises if either fails.  Returns {name:
    {"ranks", "rows_in_turn", "one_process": metrics, "gaps": {"ranks vs
    rows_in_turn", "ranks vs one_process": gaps()}}}."""
    want = _steps(None, n_devices, device, inputs)
    turn = _rows_in_turn(n_devices, device, inputs)
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    try:
        if init_method is None:
            init_method = f"tcp://localhost:{ddp.free_port()}"
        out_path = os.path.join(tmp, "rank0.pt")
        mp.spawn(_rank_main, args=(n_devices, str(device), inputs,
                                   init_method, out_path),
                 nprocs=n_devices, join=True)
        got = torch.load(out_path, weights_only=True)
    finally:
        shutil.rmtree(tmp)
    result, failed = {}, []
    for name, _, _, _ in MODELS:
        g = {"ranks vs rows_in_turn": gaps(got[name], turn[name]),
             "ranks vs one_process": gaps(got[name], want[name])}
        result[name] = {"ranks": got[name][0], "rows_in_turn": turn[name][0],
                        "one_process": want[name][0], "gaps": g}
        print(f"dryrun_multichip({n_devices}) {name} on {inputs} inputs: "
              f"loss={got[name][0]['loss']:.6f} (one process "
              f"{want[name][0]['loss']:.6f}), grad_norm="
              f"{got[name][0]['grad_norm']:.6f} (one process "
              f"{want[name][0]['grad_norm']:.6f}); gaps {json.dumps(g)}",
              flush=True)
        same = g["ranks vs rows_in_turn"]
        if max(same.values()) > SAME:
            failed.append(f"{name}: the ranks differ from one process on "
                          f"their rows ({same})")
        try:
            for k in ("loss", "grad_norm"):
                if g["ranks vs one_process"][k] > REL:
                    raise AssertionError(f"{k}: {got[name][0][k]} vs one "
                                         f"process's {want[name][0][k]}")
            params_close(got[name][1], want[name][1], got[name][2],
                         want[name][2])
        except AssertionError as e:
            failed.append(f"{name} against one process on the whole "
                          f"batch: {e}")
    if failed:
        raise AssertionError(f"dryrun_multichip({n_devices}): "
                             + "; ".join(failed))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inputs", choices=sorted(DAMP), default="smooth")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, inputs=args.inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
