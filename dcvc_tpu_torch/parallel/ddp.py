"""Data parallelism of the trainers (counterpart of dcvc_tpu/parallel/
mesh.py, the `data` mesh both JAX trainers shard the batch over).

One process per rank, as torchrun starts them (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL between cards, gloo on the
CPU.  --batch_size is the global batch and must divide by the world size,
as the JAX trainers assert.  Every rank forms the same global batch from
the same loader seed and draws the same global noise from the same
generator, and keeps its rows of both (`rows`).  After the backward pass
the flat gradient is averaged over the ranks with one all-reduce
(`all_reduce_mean_`, called by train.step.Optimizer), and only then
clipped by its global norm and checked for the non-finite skip, as XLA
reduces before optax's clip.  So W ranks take the step one process takes
on the whole batch.  The parameters start equal on every rank (the same
seed or file) and stay equal.  Only rank 0 writes status files,
checkpoints and logs.

The loaders' crop and flip draws follow their threads' order when
--num_workers > 1, in one process as across ranks; with -n 1 every rank
sees exactly the global batch of one process.
"""

import os
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist


class Rank(NamedTuple):
    """This process's place in a data-parallel job."""
    rank: int
    world: int
    device: torch.device


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank, world, device, init_method, backend=None):
    """Join the process group (NCCL for a CUDA device, else gloo, unless
    `backend` names one); "cuda" with no index is the current card.
    Returns the Rank."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return Rank(rank, world, device)


def from_env(device):
    """The trainers' data parallelism: None when WORLD_SIZE is unset (one
    process, no process group), else this rank of a torchrun job with its
    process group joined; a CUDA device becomes cuda:LOCAL_RANK.  A job
    of one rank with no MASTER_PORT listens on a free local port."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world != 1:
            raise RuntimeError("WORLD_SIZE > 1 needs MASTER_ADDR and "
                               "MASTER_PORT (torchrun sets them)")
        port = free_port()
    addr = os.environ.get("MASTER_ADDR", "localhost")
    return init(rank, world, device, f"tcp://{addr}:{port}")


def shutdown(dp):
    if dp is not None:
        dist.destroy_process_group()


def rows(dp, batch):
    """This rank's rows of a global batch of `batch` samples (all of them
    with no data parallelism)."""
    if dp is None:
        return slice(0, batch)
    if batch % dp.world:
        raise ValueError(f"batch {batch} must divide by the world size "
                         f"{dp.world}")
    b = batch // dp.world
    return slice(dp.rank * b, (dp.rank + 1) * b)


def all_reduce_mean_(tensors):
    """Average `tensors` over the ranks in place, with one all-reduce of
    their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean_metrics(metrics):
    """The ranks' mean of each tensor metric (the global batch's mean of a
    per-rank mean); other entries as they are."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)
            and v.is_floating_point()]
    if not keys or not dist.is_initialized():
        return metrics
    vals = torch.stack([metrics[k].float() for k in keys])
    all_reduce_mean_([vals])
    return dict(metrics, **{k: v for k, v in zip(keys, vals)})


def is_main(dp):
    return dp is None or dp.rank == 0
