"""Quantized-CDF construction for the rANS coder.

Mirrors the reference pipeline exactly (bit-for-bit) so that encoder and
decoder banks agree and streams are conformant with the reference format:
  * pmf_to_quantized_cdf: 16-bit quantization with min-freq stealing
    (src/cpp/py_rans/py_rans.cpp:35-94, ryg_rans lineage).
  * reorder_prob: symmetric pmf -> 0, +1, -1, +2, -2, ... zig-zag order
    (src/models/entropy_models.py:45-57).
  * pmf_to_cdf: per-row reorder + quantize into a fixed-width int32 table
    (entropy_models.py:67-75).
"""

import numpy as np

MAX_ENTROPY_CODING_VALUE = 8


def pmf_to_quantized_cdf(pmf):
    """pmf (float sequence) -> quantized CDF (len(pmf)+1 ints, last = 65536).

    Integer semantics match the C++ implementation: initial rounding at
    float32 precision, 64-bit rescale, then min-freq stealing.
    """
    precision = 16
    prob_max = 1 << precision
    min_freq = 1

    pmf = np.asarray(pmf, dtype=np.float32)
    n = pmf.shape[0]
    cdf = [0] * (n + 1)
    for i in range(n):
        cdf[i + 1] = int(np.float32(pmf[i]) * np.float32(prob_max) + np.float32(0.5))

    total = sum(cdf)
    cdf = [(prob_max * p) // total for p in cdf]
    # partial sum
    for i in range(1, n + 1):
        cdf[i] += cdf[i - 1]
    cdf[n] = prob_max

    for i in range(n):
        if cdf[i] + min_freq > cdf[i + 1]:
            # steal frequency from the lowest-frequency symbol that can give
            best_freq = None
            best_steal = -1
            for j in range(n):
                freq = cdf[j + 1] - cdf[j]
                if freq >= min_freq * 2 and (best_freq is None or freq < best_freq):
                    best_freq = freq
                    best_steal = j
            assert best_steal != -1
            if best_steal < i:
                for j in range(best_steal + 1, i + 1):
                    cdf[j] -= min_freq
            else:
                assert best_steal > i
                for j in range(i + 1, best_steal + 1):
                    cdf[j] += min_freq

    assert cdf[0] == 0 and cdf[-1] == prob_max
    return np.asarray(cdf, dtype=np.int32)


def reorder_prob(prob):
    """[p(-k)..p(0)..p(k), tail] -> [p(0), p(1), p(-1), ..., tail]."""
    prob = np.asarray(prob)
    length = prob.shape[0]
    out = prob.copy()
    center = (length - 1) // 2
    out[0] = prob[center]
    for i in range(1, center + 1):
        out[2 * i - 1] = prob[center + i]
        out[2 * i - 0] = prob[center - i]
    return out


def pmf_to_cdf(pmf, tail_mass, pmf_length, max_length):
    """Batched CDF build: (N, max_length) pmf rows -> (N, max_length+2) int32."""
    pmf = np.asarray(pmf, np.float32)
    tail_mass = np.asarray(tail_mass, np.float32).reshape(-1, 1)
    pmf_length = np.asarray(pmf_length).reshape(-1)
    n = pmf.shape[0]
    cdf = np.zeros((n, max_length + 2), dtype=np.int32)
    for i in range(n):
        prob = np.concatenate([pmf[i, :pmf_length[i]], tail_mass[i]])
        prob1 = reorder_prob(prob)
        _cdf = pmf_to_quantized_cdf(prob1)
        cdf[i, :_cdf.shape[0]] = _cdf
    return cdf


def build_z_cdf_bank(bit_estimator, params):
    """Convenience: full z bank for all QPs; index = qp*C + channel."""
    return bit_estimator.compute_cdf_bank(params, MAX_ENTROPY_CODING_VALUE)


def build_y_cdf_bank(gaussian):
    return gaussian.compute_cdf_bank()
