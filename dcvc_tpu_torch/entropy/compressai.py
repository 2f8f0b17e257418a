"""CompressAI-lineage entropy banks of the vendored I-frame codecs
(counterpart of dcvc_tpu/entropy/compressai.py; reference DCVC-family/
DCVC/src/entropy_models/entropy_models.py): the GaussianConditional's
64-level exponential scale table [0.11, 256] and its CDF bank, its
scale -> row index map, and the EntropyBottleneck's parameters and
per-channel CDF bank.

Like the legacy banks (entropy/legacy.py) these code DENSE symbol grids
in natural value order with per-row integer offsets: the host's indexed
rANS coder (rans.IndexedRansEncoder / IndexedRansDecoder).  The banks are
built on the host CPU in torch float32, on purpose: the quantized CDF
rows must be bit-identical to the reference's, which computes them with
torch float32 ops.

`compressai_scale_table`, `compressai_gaussian_bank`, `build_indexes`,
`eb_init_params`, `_eb_logits_torch` and `eb_bank` are verbatim copies of
the JAX package's (whose module imports jax), pinned by
tests/test_torch_compressai.py.  The training likelihoods are not ported:
no path of the port trains these models.
"""

import math

import numpy as np
from scipy.stats import norm as _norm

from .legacy import _pmf_to_cdf_plain

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def compressai_scale_table(smin=SCALES_MIN, smax=SCALES_MAX,
                           levels=SCALES_LEVELS):
    """get_scale_table (priors.py:194-196): exp-spaced levels, computed
    in torch float32 so the table (and hence the CDF bank) is
    bit-identical to the reference's."""
    import torch
    return torch.exp(torch.linspace(math.log(smin), math.log(smax),
                                    levels)).numpy()


def compressai_gaussian_bank(scale_table=None, tail_mass=1e-9):
    """GaussianConditional.update (entropy_models.py:457-481): per-level
    CDF rows in natural order with offset = -pmf_center."""
    # the pmf is evaluated with torch float32 ops so the quantized CDF
    # rows are BIT-IDENTICAL to the reference bank — required to decode
    # reference-encoded streams (entropy_models.py:459-481 runs erfc in
    # torch float32; scipy's erfc rounds differently at ~0.5% of entries)
    import torch
    table_np = np.asarray(scale_table if scale_table is not None
                          else compressai_scale_table(), np.float32)
    table = torch.from_numpy(table_np)
    multiplier = float(-_norm.ppf(tail_mass / 2))
    pmf_center = torch.ceil(table * multiplier).int()
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max().item())

    samples = torch.abs(torch.arange(max_length).int()
                        - pmf_center[:, None]).float()
    s = table[:, None].float()

    def std_cum(x):
        return 0.5 * torch.erfc(float(-(2 ** -0.5)) * x)

    upper = std_cum((0.5 - samples) / s)
    lower = std_cum((-0.5 - samples) / s)
    pmf = (upper - lower).numpy().astype(np.float32)
    tail = (2 * lower[:, :1]).numpy().astype(np.float32)
    pmf_center = pmf_center.numpy()
    pmf_length = pmf_length.numpy()

    cdf = _pmf_to_cdf_plain(pmf, tail, pmf_length, max_length)
    return cdf, pmf_length + 2, -pmf_center


def build_indexes(scales, scale_table=None):
    """GaussianConditional.build_indexes (entropy_models.py:509-514)."""
    table = np.asarray(scale_table if scale_table is not None
                       else compressai_scale_table(), np.float32)
    scales = np.maximum(np.asarray(scales, np.float32), table[0])
    idx = np.full(scales.shape, len(table) - 1, np.int32)
    for s in table[:-1]:
        idx -= (scales <= s).astype(np.int32)
    return idx


def eb_init_params(channels, filters=(3, 3, 3, 3), init_scale=10.0,
                   rng=None):
    """Parameter pytree matching EntropyBottleneck.__init__
    (entropy_models.py:221-265)."""
    rng = np.random.default_rng(0) if rng is None else rng
    fs = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1 / (len(filters) + 1))
    p = {}
    for i in range(len(filters) + 1):
        init = math.log(math.expm1(1 / scale / fs[i + 1]))
        p[f"matrix_{i}"] = np.full((channels, fs[i + 1], fs[i]), init,
                                   np.float32)
        p[f"bias_{i}"] = rng.uniform(
            -0.5, 0.5, (channels, fs[i + 1], 1)).astype(np.float32)
        if i < len(filters):
            p[f"factor_{i}"] = np.zeros((channels, fs[i + 1], 1), np.float32)
    p["quantiles"] = np.tile(
        np.array([-init_scale, 0.0, init_scale], np.float32), (channels, 1, 1))
    return p


def _eb_logits_torch(params, x, n_filters):
    """_logits_cumulative (entropy_models.py:313-334) in torch float32
    for bit-parity with the reference bank.  x: torch (C, 1, L)."""
    import torch
    logits = x
    for i in range(n_filters + 1):
        m = torch.nn.functional.softplus(
            torch.from_numpy(np.asarray(params[f"matrix_{i}"], np.float32)))
        logits = torch.matmul(m, logits)
        logits = logits + torch.from_numpy(
            np.asarray(params[f"bias_{i}"], np.float32))
        if i < n_filters:
            f = torch.tanh(torch.from_numpy(
                np.asarray(params[f"factor_{i}"], np.float32)))
            logits = logits + f * torch.tanh(logits)
    return logits


def eb_bank(params, n_filters=4):
    """EntropyBottleneck.update (entropy_models.py:272-311): per-channel
    CDF rows + offsets + medians.  torch float32 ops for bit-parity with
    the reference bank (required to decode reference streams)."""
    import torch
    q = torch.from_numpy(np.asarray(params["quantiles"], np.float32))
    medians = q[:, 0, 1]
    minima = torch.clamp(torch.ceil(medians - q[:, 0, 0]).int(), min=0)
    maxima = torch.clamp(torch.ceil(q[:, 0, 2] - medians).int(), min=0)
    offset = -minima
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max().item())

    samples = torch.arange(max_length) + pmf_start[:, None, None]  # (C,1,L)
    lower = _eb_logits_torch(params, samples - 0.5, n_filters)
    upper = _eb_logits_torch(params, samples + 0.5, n_filters)
    sign = -torch.sign(lower + upper)

    pmf = torch.abs(torch.sigmoid(sign * upper)
                    - torch.sigmoid(sign * lower))[:, 0, :]
    tail = (torch.sigmoid(lower[:, 0, :1]) + torch.sigmoid(-upper[:, 0, -1:]))
    cdf = _pmf_to_cdf_plain(pmf.numpy().astype(np.float32),
                            tail.numpy().astype(np.float32),
                            pmf_length.numpy(), max_length)
    return (cdf, pmf_length.numpy() + 2, offset.numpy(),
            medians.numpy().astype(np.float32))
