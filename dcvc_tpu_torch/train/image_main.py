"""Image (DMCI) trainer of the port, CLI-compatible with the JAX package's
train_image.py (reference train_image.py):

    python3 -m dcvc_tpu_torch.train.image_main --train_dataset DIR \
        --save_dir OUT --lambdas 8 256 [--model_size tiny|small|full] \
        [--device cuda|cpu] ...

The 105-epoch schedule with patch growth 256 -> 512, AdamW with a
global-norm clip of 0.1 and the non-finite skip, a random QP per sample
with its log-spaced lambda, and a resumable status file per epoch
(utils/checkpoint.py).  The flags are train_image.py's plus `--device`
(default cuda; with no card it raises).  The model trains in float32
with TF32 off (runtime.image_codec.set_deterministic), from seeded
random weights.  At the end it writes `ckpt.pth.tar` in the reference
format and `ckpt.bin` in the JAX package's dcvc_tpu.params.v1 (as
train_image.py writes it, the config in its header); DMCICodec takes
either through utils/jax_bridge.load_into, the JAX package's CLIs the
latter.
Data parallelism as the JAX trainer's `data` mesh (parallel/ddp.py): under
torchrun (`torchrun --nproc_per_node N -m dcvc_tpu_torch.train.image_main
...`, NCCL on cards, gloo with --device cpu) --batch_size is the global
batch, each rank trains on its rows and averages the gradient, and rank 0
alone writes the status files, checkpoints and log.  Without WORLD_SIZE
it runs in one process.
"""

import argparse
import sys
import time

import torch

from ..data.datasets import BatchLoader, ImageFolder
from ..models.common import draw_noise, get_training_lambdas
from ..models.dmci import DMCI, DMCIConfig, SMALL_CONFIG, TINY_CONFIG
from ..parallel import ddp
from ..utils.checkpoint import save_reference, save_status
from ..utils.jax_status import resume
from ..utils.jax_bridge import save_native
from .step import Optimizer, image_train_step, training_device

CLIP_NORM = 0.1


def get_training_strategy():
    # [epoch_ref, lr, patch_w, patch_h] (reference train_image.py:19-33)
    return (
        [[0,   2e-4, 256, 256]] * 45
        + [[49,  5e-5, 256, 256]] * 25
        + [[69,  1e-5, 256, 256]] * 20
        + [[90,  2e-4, 512, 512]] * 5
        + [[95,  5e-5, 512, 512]] * 4
        + [[99,  1e-5, 512, 512]] * 4
        + [[103, 1e-6, 512, 512]] * 2
        + [[105, 1e-6, 512, 512]]
    )


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("-e", "--epochs", default=104, type=int)
    parser.add_argument("--lambdas", type=float, nargs="+", required=True)
    parser.add_argument("-n", "--num_workers", type=int, default=4)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--train_dataset", type=str, required=True)
    parser.add_argument("--tiny_model", action="store_true")
    parser.add_argument("--model_size", type=str, default=None,
                        choices=["tiny", "small", "full"],
                        help="overrides --tiny_model; `small` is the "
                             "mid-size trained-gate config")
    parser.add_argument("--max_steps_per_epoch", type=int, default=-1)
    parser.add_argument("--data_repeat", type=int, default=1,
                        help="passes over the corpus per epoch (fresh "
                             "random crops each pass; for small corpora)")
    parser.add_argument("--max_patch", type=int, default=-1,
                        help="clamp the schedule's patch size (e.g. when "
                             "the corpus images are smaller than the "
                             "reference schedule's 512)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dp = ddp.from_env(args.device)
    try:
        return train(args, dp)
    finally:
        ddp.shutdown(dp)


def train(args, dp):
    """The training run of main; dp: this process's data-parallel Rank,
    or None."""
    device = training_device(str(dp.device) if dp else args.device)
    rows = ddp.rows(dp, args.batch_size)
    main_rank = ddp.is_main(dp)
    size = args.model_size or ("tiny" if args.tiny_model else "full")
    cfg = {"tiny": TINY_CONFIG, "small": SMALL_CONFIG,
           "full": DMCIConfig()}[size]
    model = DMCI(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    lambdas_np = get_training_lambdas(args.lambdas, cfg.qp_num)
    lambdas = torch.tensor(lambdas_np, dtype=torch.float32, device=device)

    strategy = get_training_strategy()
    _, lr0, pw, ph = strategy[0]
    # raw_rgb: uint8 batches, converted on the device
    dataset = ImageFolder(args.train_dataset, ph, pw, cfg.qp_num, lambdas_np,
                          raw_rgb=True)
    opt = Optimizer(model, lr0, CLIP_NORM, data_parallel=dp is not None)
    begin_epoch, step = 0, 0
    resumed = resume(args.save_dir, model, opt)
    if resumed is not None:
        begin_epoch, step = resumed
        if main_rank:
            print(f"resumed from epoch {begin_epoch}", flush=True)

    noise_gen = torch.Generator(device=device).manual_seed(42)
    for epoch in range(begin_epoch, args.epochs):
        _, lr, patch_w, patch_h = strategy[min(len(strategy) - 1, epoch)]
        if args.max_patch > 0:
            patch_w = min(patch_w, args.max_patch)
            patch_h = min(patch_h, args.max_patch)
        dataset.set_patch_size(patch_w, patch_h)
        opt.set_lr(lr)
        loader = BatchLoader(dataset, args.batch_size, seed=epoch,
                             repeats=args.data_repeat,
                             workers=args.num_workers,
                             pin_memory=device.type == "cuda")
        t0 = time.time()
        for i, batch in enumerate(loader):
            if 0 <= args.max_steps_per_epoch <= i:
                break
            x = batch["x"][rows].to(device, non_blocking=True)
            qp = batch["qp"][rows].to(device, non_blocking=True).long()
            noise = draw_noise(cfg, args.batch_size, *x.shape[1:3],
                               noise_gen, device)
            m = image_train_step(model, opt, x, qp, lambdas,
                                 {k: v[rows] for k, v in noise.items()})
            step += 1
            if i % 200 == 0:
                m = ddp.mean_metrics(m)
            if i % 200 == 0 and main_rank:
                print(f"Time: {time.time() - t0:.1f}s, epoch {epoch} step "
                      f"{i}: loss {float(m['loss']):.4f} mse "
                      f"{float(m['mse']):.5f} bpp {float(m['bpp']):.4f} "
                      f"gnorm {float(m['grad_norm']):.3f} lr {lr:.1e}"
                      + (" (skipped)" if m["skipped"] else ""), flush=True)
                t0 = time.time()
        if main_rank:
            save_status(args.save_dir, model, opt, epoch, step, cfg)

    if main_rank:
        save_reference(f"{args.save_dir}/ckpt.pth.tar", model)
        save_native(model, f"{args.save_dir}/ckpt.bin", cfg)
        print(f"saved final checkpoint to {args.save_dir}/ckpt.pth.tar and "
              f"ckpt.bin", flush=True)
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
