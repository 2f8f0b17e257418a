"""Port parity, the legacy family's motion ops: dcvc_tpu_torch's
legacy/ops.py (flow_warp, block_mc, avg_pool_2x, the 2x bilinear
resizes) and legacy/spynet.py (MEBasic, MESpynet) against dcvc_tpu's,
float32 on the CPU, on inputs made from a numpy seed, within
atol = rtol = 2e-5.

flow_warp is held on smooth random flows, on large flows that clamp at
every border, at odd sizes and with several channels; a zero flow gives
the input back exactly.  The resizes at odd and even sizes, their border
rows and columns included.  SpyNet with DC / FM's (7, 7, 5, 5) levels on
a 64x64 pair, on the port's seeded weights carried to flax by the bridge
(its modules mirror the flax tree).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dcvc_tpu.legacy import dcvc_fm as jfm
from dcvc_tpu.legacy import ops as jops
from dcvc_tpu.legacy import spynet as jspynet
from dcvc_tpu_torch.legacy import dcvc_fm, ops, spynet
from dcvc_tpu_torch.legacy.fm_layers import lecun_init_legacy_
from dcvc_tpu_torch.utils.jax_bridge import fm_params_to_jax

TOL = 2e-5


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _both(fn_t, fn_j, *arrays):
    return (fn_t(*[torch.from_numpy(a) for a in arrays]),
            fn_j(*[jnp.asarray(a) for a in arrays]))


def _smooth(shape, seed, sigma=2.0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.normal(0, 1, shape), (0, sigma, sigma, 0))
    return (x * scale / max(np.abs(x).max(), 1e-6)).astype(np.float32)


# (b, h, w, c, flow amplitude in pixels, seed)
WARP_CASES = [
    (1, 16, 24, 3, 3.0, 0),       # smooth, inside the frame
    (2, 13, 17, 5, 2.5, 1),       # odd sizes, batch 2
    (1, 15, 9, 2, 40.0, 2),       # large: clamps at every border
    (1, 32, 32, 8, 12.0, 3),
]


@pytest.mark.parametrize("b,h,w,c,amp,seed", WARP_CASES)
def test_flow_warp_matches_jax(b, h, w, c, amp, seed):
    rng = np.random.default_rng(seed + 100)
    im = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    flow = _smooth((b, h, w, 2), seed, scale=amp)
    got, want = _both(ops.flow_warp, jops.flow_warp, im, flow)
    _close(got, want)
    if amp > w:
        # the clamped samples hit the border rows and columns
        src_x = np.arange(w)[None, None] + flow[..., 0]
        assert (src_x < 0).any() and (src_x > w - 1).any()


def test_block_mc_is_flow_warp():
    rng = np.random.default_rng(4)
    feat = rng.normal(0, 1, (1, 12, 20, 6)).astype(np.float32)
    flow = _smooth((1, 12, 20, 2), 4, scale=5.0)
    got, want = _both(ops.block_mc, jops.block_mc, feat, flow)
    _close(got, want)
    assert torch.equal(got, ops.flow_warp(torch.from_numpy(feat),
                                          torch.from_numpy(flow)))


@pytest.mark.parametrize("h,w", [(16, 16), (11, 7)])
def test_flow_warp_zero_flow_is_identity(h, w):
    im = np.random.default_rng(h).normal(0, 1, (1, h, w, 4)).astype(
        np.float32)
    out = ops.flow_warp(torch.from_numpy(im), torch.zeros(1, h, w, 2))
    np.testing.assert_array_equal(out.numpy(), im)


def test_flow_warp_integer_flow_is_a_shift():
    """A flow of (+1, 0) reads each pixel's right neighbour; the last
    column clamps to itself."""
    im = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6, 1)
    flow = np.zeros((2, 5, 6, 2), np.float32)
    flow[..., 0] = 1.0
    out = ops.flow_warp(torch.from_numpy(im), torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(out[:, :, :-1], im[:, :, 1:])
    np.testing.assert_array_equal(out[:, :, -1], im[:, :, -1])


def test_avg_pool_2x_matches_jax():
    x = np.random.default_rng(5).normal(0, 1, (2, 10, 14, 5)).astype(
        np.float32)
    got, want = _both(ops.avg_pool_2x, jops.avg_pool_2x, x)
    _close(got, want)


@pytest.mark.parametrize("h,w", [(7, 9), (8, 12), (1, 5)])
def test_bilinear_upsample_2x_matches_jax(h, w):
    x = np.random.default_rng(h * w).normal(0, 1, (1, h, w, 3)).astype(
        np.float32)
    got, want = _both(ops.bilinear_upsample_2x, jops.bilinear_upsample_2x,
                      x)
    _close(got, want)
    # the border rows and columns (JAX renormalises its edge weights)
    _close(got[:, [0, -1]], np.asarray(want)[:, [0, -1]])
    _close(got[:, :, [0, -1]], np.asarray(want)[:, :, [0, -1]])


@pytest.mark.parametrize("h,w", [(9, 13), (16, 24), (6, 10)])
def test_bilinear_downsample_2x_matches_jax(h, w):
    x = np.random.default_rng(h + w).normal(0, 1, (2, h, w, 2)).astype(
        np.float32)
    got, want = _both(ops.bilinear_downsample_2x,
                      jfm.bilinear_downsample_2x, x)
    assert got.shape == (2, h // 2, w // 2, 2)
    _close(got, want)


def _spynet_pair(side=64):
    base = _smooth((1, side, side, 3), 9, sigma=3.0, scale=0.5) + 0.5
    im2 = np.roll(base, (2, -3), axis=(1, 2))
    return base, im2.astype(np.float32)


@pytest.mark.parametrize("kernel", [7, 5])
def test_mebasic_matches_flax(kernel):
    m = spynet.MEBasic(kernel)
    with torch.no_grad():
        lecun_init_legacy_(m, torch.Generator().manual_seed(kernel))
    params = fm_params_to_jax(m.state_dict())
    x = np.random.default_rng(kernel).normal(0, 1, (1, 16, 20, 8)).astype(
        np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    want = jspynet.MEBasic(kernel=kernel).apply({"params": params},
                                                jnp.asarray(x))
    _close(got, want)


def test_mespynet_matches_flax():
    """MESpynet with FM's (7, 7, 5, 5) levels: flow of a shifted 64x64
    pair, coarsest level first, from a (h/16, w/16) zero flow."""
    m = spynet.MESpynet(level_kernels=(7, 7, 5, 5))
    with torch.no_grad():
        lecun_init_legacy_(m, torch.Generator().manual_seed(3))
    params = fm_params_to_jax(m.state_dict())
    assert params["moduleBasic_0"]["conv1"]["kernel"].shape == (7, 7, 8, 32)
    assert params["moduleBasic_3"]["conv5"]["kernel"].shape == (5, 5, 16, 2)
    im1, im2 = _spynet_pair()
    with torch.no_grad():
        got = m(torch.from_numpy(im1), torch.from_numpy(im2))
    want = jspynet.MESpynet(level_kernels=(7, 7, 5, 5)).apply(
        {"params": params}, jnp.asarray(im1), jnp.asarray(im2))
    _close(got, want)
    assert got.shape == (1, 64, 64, 2) and float(got.abs().max()) > 0.5


def test_fm_model_spynet_levels():
    m = dcvc_fm.DMCFM(dcvc_fm.TINY_FM_CONFIG)
    ks = [getattr(m.optic_flow, f"moduleBasic_{i}").conv1.kernel
          for i in range(4)]
    assert ks == [7, 7, 5, 5]
