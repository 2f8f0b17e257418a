"""Video training step: cascaded multi-chunk BPTT with rematerialisation
(counterpart of dcvc_tpu/train/video_step.py; reference
train_video.py:118-189).

  * a frozen intra model seeds the reference feature with its no-grad
    reconstruction, pixel-unshuffled by 8 (the training form of
    add_ref_feature_from_frame);
  * the chunks run one after another, each under
    torch.utils.checkpoint.checkpoint when use_remat (its activations
    are recomputed in the backward pass instead of kept);
  * cascaded=True backpropagates through every chunk; cascaded=False
    detaches the feature and the memory between chunks;
  * each chunk's RD loss takes the variant's distortion weights; the
    optimizer is train.step.Optimizer (AdamW, clip, non-finite skip).

Each chunk's noise is drawn before its checkpointed call and passed in:
checkpoint restores the global RNG state for the recomputation, not that
of a torch.Generator, so a draw inside the chunk would differ on replay.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..core.shuffle import pixel_unshuffle
from ..models import common
from .step import to_model_domain

# DMC-HT: mse_8frames_sum weights [last, even, odd]
HT_DIST_WEIGHTS = (1.5, 0.16, 0.4)
# DMC-LD: per-frame distortion weight by the frame's position in the
# 8-frame schedule (video_model_ld.py:231-240)
LD_INDEX_MAP = (0, 1, 0, 2, 0, 2, 0, 2)
LD_WEIGHTS = (0.52, 1.33, 0.83)


def chunk_mse(cfg, result, poc0):
    """The chunk's weighted distortion (B,); poc0 is the POC of its first
    frame."""
    if hasattr(cfg, "is_hts"):
        return common.mse_8frames_sum(result["mse"], HT_DIST_WEIGHTS)
    return result["mse"] * LD_WEIGHTS[LD_INDEX_MAP[poc0 % 8]]


@torch.no_grad()
def intra_seed(i_model, x, qp, noise):
    """The frozen intra model's reconstruction of x (B, H, W, 3) uint8 RGB
    or YCbCr - 0.5 (its training forward, no gradient)."""
    return i_model(to_model_domain(x), qp, noise)["x_hat"]


def video_loss(model, intra_recon, chunks, qp, lambdas, noise, cascaded=True,
               use_remat=True):
    """The cascaded loss over n chunks and its metrics.

    model: DMCHT or DMCLD; intra_recon: (B, H, W, 3) seed; chunks: (B, n,
    H, W, 3 * frame_delay) uint8 RGB or YCbCr - 0.5; qp: (B,) int64;
    lambdas: (qp_num,) tensor; noise: a list of n per-chunk noises
    ({"y", "z"} tensors), or a torch.Generator to draw them from, chunk
    by chunk, before each call."""
    cfg = model.cfg
    b, n, h, w, c = chunks.shape
    if chunks.dtype == torch.uint8:
        chunks = to_model_domain(chunks.reshape(b, n, h, w, c // 3, 3)) \
            .reshape(b, n, h, w, c)
    ref = pixel_unshuffle(intra_recon.detach(), 8)
    lam = lambdas[qp]

    def run_chunk(chunk, ref, memory, noise, poc0):
        result, feature, memory = model(chunk, ref, memory, qp, noise)
        mse = chunk_mse(cfg, result, poc0)
        loss = (lam * mse + result["bpp"]).mean()
        return loss, result["bpp"].mean(), mse.mean(), feature, memory

    memory, losses, bpps, mses = None, [], [], []
    for k in range(n):
        chunk_noise = noise[k] if isinstance(noise, (list, tuple)) else \
            common.draw_noise(cfg, b, h, w, noise, chunks.device)
        args = (chunks[:, k], ref, memory, chunk_noise,
                k * cfg.frame_delay + 1)
        if use_remat:
            out = checkpoint(run_chunk, *args, use_reentrant=False)
        else:
            out = run_chunk(*args)
        loss, bpp, mse, ref, memory = out
        if not cascaded:
            ref, memory = ref.detach(), memory.detach()
        losses.append(loss)
        bpps.append(bpp)
        mses.append(mse)
    loss = torch.stack(losses).mean()
    return loss, {"loss": loss, "bpp": torch.stack(bpps).mean(),
                  "mse": torch.stack(mses).mean()}


def video_train_step(model, opt, intra_recon, chunks, qp, lambdas, noise,
                     cascaded=True, use_remat=True):
    """One step of video_loss and opt (train.step.Optimizer).  Returns the
    metrics (0-d tensors, grad_norm; skipped a bool)."""
    loss, metrics = video_loss(model, intra_recon, chunks, qp, lambdas,
                               noise, cascaded, use_remat)
    loss.backward()
    grad_norm, skipped = opt.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(grad_norm=grad_norm, skipped=skipped)
    return metrics
