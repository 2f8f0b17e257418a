"""Port parity, the legacy family's entropy banks
(dcvc_tpu_torch/entropy/legacy.py) against dcvc_tpu.entropy.legacy on
the CPU, exact.

- The numpy copies are pinned to the originals' source.
- The gaussian and laplace scale tables' CDF banks and a seeded z
  bitparm bank are equal array for array.
- build_indexes (a count of f32 thresholds) equals the JAX package's f32
  log formula on a seeded sample and on every threshold +-2 ulps, and
  each threshold is re-derived from the JAX function by bisection over
  f32 bit patterns.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.entropy import legacy as jlegacy
from dcvc_tpu_torch.entropy import legacy

DISTS = ("gaussian", "laplace")


@pytest.mark.parametrize("name", [
    "_pmf_to_cdf_plain", "_norm_cdf", "_laplace_cdf", "legacy_bitparm_bank",
    "build_z_indexes", "LegacyGaussianTable.__init__",
    "LegacyGaussianTable.compute_cdf_bank",
    "LegacyGaussianTable.build_indexes_np"])
def test_copies_pinned(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    assert inspect.getsource(get(legacy)) == inspect.getsource(get(jlegacy))


@pytest.mark.parametrize("dist", DISTS)
def test_scale_table_banks_equal(dist):
    got = legacy.LegacyGaussianTable(dist).compute_cdf_bank()
    want = jlegacy.LegacyGaussianTable(dist).compute_cdf_bank()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("qp_num,channel", [(1, 8), (2, 16)])
def test_bitparm_bank_equal(qp_num, channel):
    rng = np.random.default_rng(qp_num * channel)
    params = {k: (0.5 * rng.standard_normal((qp_num, channel, n)))
              .astype(np.float32) for k, n in (("h", 4), ("b", 4), ("a", 3))}
    got = legacy.legacy_bitparm_bank(params, qp_num, channel)
    want = jlegacy.legacy_bitparm_bank(params, qp_num, channel)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(legacy.build_z_indexes(1, channel, 3, 5),
                                  jlegacy.build_z_indexes(1, channel, 3, 5))


def _jax_index(dist, scales):
    fn = jax.jit(jlegacy.LegacyGaussianTable(dist).build_indexes)
    return np.asarray(fn(jnp.asarray(np.asarray(scales, np.float32))))


def _port_index(dist, scales):
    return legacy.LegacyGaussianTable(dist).build_indexes(
        torch.from_numpy(np.asarray(scales, np.float32))).numpy()


@pytest.mark.parametrize("dist", DISTS)
def test_thresholds_rederived_from_jax_formula(dist):
    """Each threshold is the smallest f32 at which the JAX package's
    build_indexes reaches k: bisect over f32 bit patterns."""
    t = legacy.LegacyGaussianTable(dist)
    thr = legacy.INDEX_THRESHOLDS[dist]
    assert thr.shape == (t.levels - 1,) and np.all(np.diff(thr) > 0)
    lo = np.full(t.levels - 1, np.float32(t.scale_min / 2).view(np.int32),
                 np.int64)
    hi = np.full(t.levels - 1, np.float32(t.scale_max * 2).view(np.int32),
                 np.int64)
    k = np.arange(1, t.levels)
    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        up = _jax_index(dist, mid.astype(np.int32).view(np.float32)) >= k
        hi = np.where(up, mid, hi)
        lo = np.where(up, lo, mid)
    np.testing.assert_array_equal(hi.astype(np.int32).view(np.float32), thr)


@pytest.mark.parametrize("dist", DISTS)
def test_build_indexes_exact(dist):
    thr = legacy.INDEX_THRESHOLDS[dist].view(np.int32)
    edges = (thr[:, None] + np.arange(-2, 3)[None, :]).reshape(-1)
    rng = np.random.default_rng(5)
    grid = np.concatenate([
        edges.astype(np.int32).view(np.float32),
        np.exp(rng.uniform(np.log(1e-6), np.log(200.0), 100_000)),
        rng.normal(0, 2, 10_000),
        [-1.0, 0.0, 1e-5, 0.01, 0.11, 63.999, 64.0, 64.001, 1e9]]) \
        .astype(np.float32)
    got = _port_index(dist, grid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax_index(dist, grid))
    # numpy's f32 log is not XLA's: the host formula steps an ulp apart at
    # some edges, which is why the device map is a threshold table
    host = legacy.LegacyGaussianTable(dist).build_indexes_np(grid)
    assert np.count_nonzero(host != got) < 0.01 * grid.size
