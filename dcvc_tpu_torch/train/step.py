"""Training step with the reference's safety semantics (counterpart of
dcvc_tpu/train/step.py; reference train_image.py:51-98,
train_video.py:118-189): AdamW, a global-norm clip, the update skipped on
a non-finite gradient norm, per-sample QP with a log-spaced lambda.

The optimizer is optax.chain(clip_by_global_norm(clip), adamw(lr)) as the
JAX package builds it: the clip is optax's rule (scale by max_norm / norm
where norm >= max_norm), and AdamW takes optax's defaults (betas 0.9 /
0.999, eps 1e-8, weight decay 1e-4 on every parameter).  A skipped step
leaves the parameters and every AdamW state, its step count included,
as they were.
"""

import torch

from ..core.color import rgb2ycbcr
from ..parallel.ddp import all_reduce_mean_
from ..runtime.image_codec import set_deterministic


def training_device(name):
    """The trainers' torch.device.  On the card it turns TF32 off (and
    cuDNN's autotuning), so that the models train in float32 as the JAX
    trainers' do; with no card it raises."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        set_deterministic()
    return device


def to_model_domain(x):
    """uint8 RGB batches convert on the device to YCbCr - 0.5 (the
    loaders ship uint8: a quarter of float32's host-to-device bytes);
    float input passes through."""
    if x.dtype == torch.uint8:
        return rgb2ycbcr(x.float() / 255.0) - 0.5
    return x


def global_norm(grads):
    """sqrt of the sum of squares over every gradient (optax.global_norm),
    a 0-d tensor on the gradients' device."""
    return torch.sqrt(torch.stack([g.pow(2).sum() for g in grads]).sum())


class Optimizer:
    """clip_by_global_norm(clip_norm) then AdamW(lr), with the non-finite
    skip, over the parameters of `model`.  data_parallel: the gradients
    are first averaged over the process group's ranks (parallel/ddp.py),
    so that the clip and the skip see the global batch's gradient."""

    def __init__(self, model, lr, clip_norm, data_parallel=False):
        self.params = list(model.parameters())
        self.clip_norm = float(clip_norm)
        self.data_parallel = data_parallel
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=1e-4)

    def set_lr(self, lr):
        for group in self.adamw.param_groups:
            group["lr"] = lr

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        """Clip the gradients and update, unless their global norm is not
        finite.  A parameter with no gradient counts as a zero gradient,
        as in the JAX step (its AdamW moments decay and its weight decays).
        Returns (grad_norm, skipped): the norm before the clip, a 0-d
        tensor, and a bool (the step's one host sync)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.data_parallel:
            all_reduce_mean_(grads)
        norm = global_norm(grads)
        skipped = not bool(torch.isfinite(norm))
        if not skipped:
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm) * self.clip_norm))
            self.adamw.step()
        self.zero_grad()
        return norm.detach(), skipped

    def state_dict(self):
        return self.adamw.state_dict()

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state)


def image_loss(model, x, qp, lambdas, noise):
    """The DMCI RD loss and its metrics.  x: (B, H, W, 3) uint8 RGB or
    YCbCr - 0.5 on the model's device; qp: (B,) int64; lambdas: (qp_num,)
    float32 tensor; noise: the rate terms' noise
    (models.common.rate_terms)."""
    out = model(to_model_domain(x), qp, noise)
    loss = (lambdas[qp] * out["mse"] + out["bpp"]).mean()
    return loss, {"loss": loss, "mse": out["mse"].mean(),
                  "bpp": out["bpp"].mean(), "bits_y": out["bits_y"].mean(),
                  "bits_z": out["bits_z"].mean()}


def image_train_step(model, opt, x, qp, lambdas, noise):
    """One step of image_loss and opt.  Returns the metrics (0-d tensors;
    skipped a bool)."""
    loss, metrics = image_loss(model, x, qp, lambdas, noise)
    loss.backward()
    grad_norm, skipped = opt.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(grad_norm=grad_norm, skipped=skipped)
    return metrics
