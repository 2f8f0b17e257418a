"""The general traffic generator: the requests of a cell from its
workload file and the run's seed.

A request is `frames` consecutive frames of one picture and a QP.  The
picture is bench.py's recipe made on the device: uniform noise under an
8x8 box blur, drifting one pixel to the right per frame, with N(0,
0.005) noise on each frame, clipped to [0, 1] and shifted to [-0.5,
0.5].  A picture is drawn from a pair (seed, index), so a request can be
made again after the window for the reference.

Which pictures, at which QPs (`Schedule`): without a `corpus` in the
workload, request i has a picture of its own, (run seed, i), and the
workload's `qps` come in blocks, each block a permutation of them drawn
from the seed, so every seed codes the same mix of rate points in
another order.  With `"corpus": {"pictures": P, "seed": s}` the pictures
are (s, 0) ... (s, P - 1) for every run, and the run's seed only orders
the requests: in passes of P x len(qps) requests, each (picture, QP)
pair once a pass and every QP once in each round of len(qps) requests.
A picture's coding time depends on its content (a rare symbol can send a
decode down a slower path), so with a corpus every seed does the same
work in another order.
"""

import random

import torch
import torch.nn.functional as F

# a seed is any whole number up to a little over 2**31; (seed, index)
# maps to one 63-bit generator seed
_MIX = 1_000_003


def request_seed(seed, index):
    return (int(seed) * _MIX + int(index)) % (2 ** 63 - 1)


def make_frames(seed, index, n, h, w, device):
    """The `n` frames (1, h, w, 3) float32 of request `index`."""
    gen = torch.Generator(device=device).manual_seed(request_seed(seed,
                                                                  index))
    x = torch.rand(1, 3, h + 7, w + 7, generator=gen, device=device)
    base = F.avg_pool2d(x, 8, stride=1).permute(0, 2, 3, 1).contiguous()
    noise = torch.randn((n,) + tuple(base.shape), generator=gen,
                        device=device)
    return [torch.clamp(torch.roll(base, i, dims=2) + 0.005 * noise[i],
                        0.0, 1.0) - 0.5 for i in range(n)]


class Schedule:
    """request(i) of a run: (picture, qp), the picture as the (seed,
    index) that make_frames draws it from."""

    def __init__(self, workload, seed):
        self.seed = int(seed)
        self.qps = list(workload["qps"])
        self.corpus = workload.get("corpus")
        self.rng = random.Random(self.seed)
        self.order = []
        if self.corpus is None:
            self.fresh = QpSchedule(self.qps, self.seed)

    def request(self, index):
        if self.corpus is None:
            return (self.seed, index), self.fresh.qp(index)
        while len(self.order) <= index:
            self.order += self._pass()
        return self.order[index]

    def _pass(self):
        n, seed = self.corpus["pictures"], self.corpus["seed"]
        perms = {}
        for q in self.qps:
            perms[q] = list(range(n))
            self.rng.shuffle(perms[q])
        out = []
        for j in range(n):
            rnd = list(self.qps)
            self.rng.shuffle(rnd)
            out += [((seed, perms[q][j]), q) for q in rnd]
        return out


class QpSchedule:
    """qp(i) of request i: blocks of the workload's QPs, each block in an
    order drawn from the seed."""

    def __init__(self, qps, seed):
        self.qps = list(qps)
        self.rng = random.Random(int(seed))
        self.order = []

    def qp(self, index):
        while len(self.order) <= index:
            block = list(self.qps)
            self.rng.shuffle(block)
            self.order += block
        return self.order[index]
