"""Port parity, layers and the fused-DCB kernel's plain version:
dcvc_tpu_torch against the flax modules and the Pallas kernel (interpret
mode) of dcvc_tpu, float32 on the CPU.

Tolerance atol = rtol = 2e-5, the JAX package's own bound for the fused
kernel against the XLA path (tests/test_fused_dcb.py): the same f32 sums
taken in another order.  The CUDA kernel itself is compared with its plain
version on the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.kernels.fused_dcb import fused_dcb as jax_fused_dcb
from dcvc_tpu.layers import blocks as jblocks
from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.layers import blocks
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _parity(jmod, tmod, x, seed=1):
    """Init the flax module, load its weights into the torch module through
    the bridge, run both on x."""
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod.load_state_dict(dmci_params_from_jax(variables["params"]))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, want, variables["params"]


@pytest.mark.parametrize("cin,cout,kw", [
    (32, 32, {}),
    (16, 32, {}),                            # adaptor
    (32, 32, {"force_adaptor": True}),
    (32, 32, {"shortcut": True}),
    (32, 32, {"dcb2": True}),
])
@pytest.mark.parametrize("h,w", [(8, 8), (5, 7)])
def test_depth_conv_block_matches_flax(cin, cout, kw, h, w):
    x = _x((1, h, w, cin))
    got, want, _ = _parity(jblocks.DepthConvBlock(cin, cout, **kw),
                           blocks.DepthConvBlock(cin, cout, **kw), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w", [(8, 12), (6, 10)])
def test_residual_block_with_stride2_matches_flax(h, w):
    x = _x((1, h, w, 16))
    got, want, _ = _parity(jblocks.ResidualBlockWithStride2(16, 24),
                           blocks.ResidualBlockWithStride2(16, 24), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w", [(4, 6), (3, 5)])
def test_residual_block_upsample_matches_flax(h, w):
    x = _x((1, h, w, 24))
    got, want, _ = _parity(jblocks.ResidualBlockUpsample(24, 16),
                           blocks.ResidualBlockUpsample(24, 16), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_subpel_conv_matches_flax():
    x = _x((1, 3, 5, 8))
    jmod = jblocks.SubpelConv2x(12, 1)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = blocks.SubpelConv2x(8, 12)
    # the reference wraps the 1x1 conv in a Sequential (`conv.0`)
    kernel = np.asarray(variables["params"]["conv"]["kernel"])
    tmod.load_state_dict({"conv.0.weight": torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy())})
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 6, 10, 12)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w", [(8, 8), (9, 7)])
def test_conv3x3_stride2_matches_flax(h, w):
    x = _x((1, h, w, 16))
    got, want, _ = _parity(jblocks.Conv3x3(8, stride=2),
                           blocks.Conv3x3(16, 8, stride=2), x)
    np.testing.assert_allclose(got, want, **TOL)


def _kernel_params(p, has_adaptor):
    """flax DepthConvBlock params -> fused_dcb layout (numpy)."""
    def mat(name):
        return np.asarray(p[name]["conv"]["kernel"][0, 0])
    out = {"w1": mat("dc_in"), "b1": p["dc_in"]["conv"]["bias"],
           "wd": np.asarray(p["dc_dw"]["conv"]["kernel"][:, :, 0, :]),
           "bd": p["dc_dw"]["conv"]["bias"],
           "w2": mat("dc_out"), "b2": p["dc_out"]["conv"]["bias"],
           "w3": mat("ffn_in"), "b3": p["ffn_in"]["conv"]["bias"],
           "w4": mat("ffn_out"), "b4": p["ffn_out"]["conv"]["bias"]}
    if has_adaptor:
        out["wa"], out["ba"] = mat("adaptor"), p["adaptor"]["conv"]["bias"]
    return {k: np.array(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("cin,cout,dcb2,shortcut,h,w", [
    (128, 128, False, False, 8, 16),
    (256, 128, False, False, 8, 18),
    (128, 128, True, False, 6, 16),
    (128, 128, False, True, 4, 16),
    (384, 384, False, False, 4, 8),
])
def test_fused_dcb_reference_matches_pallas(cin, cout, dcb2, shortcut, h, w):
    """The plain version against the Pallas kernel in interpret mode, on
    the shape cases of tests/test_fused_dcb.py plus a 384-channel one."""
    block = jblocks.DepthConvBlock(cin, cout, dcb2=dcb2, shortcut=shortcut)
    x = _x((1, h, w, cin))
    variables = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _kernel_params(variables["params"], cin != cout)
    want = np.asarray(jax_fused_dcb(jnp.asarray(x), params,
                                    shortcut=shortcut, interpret=True))
    got = K1.fused_dcb_reference(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in params.items()}, shortcut)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prepare_operands_regroups_ffn_j_major():
    rng = np.random.default_rng(4)
    c, inner = 16, 8
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("w1", (c, inner)), ("b1", (inner,)),
                      ("wd", (3, 3, inner)), ("bd", (inner,)),
                      ("w2", (inner, c)), ("b2", (c,)),
                      ("w3", (c, 4 * inner)), ("b3", (4 * inner,)),
                      ("w4", (inner, c)), ("b4", (c,)))}
    ops = K1.prepare_operands(p)
    for j in range(4):
        for i in range(inner):
            assert torch.equal(ops["w3"][j][:, i], p["w3"][:, i * 4 + j])
            assert ops["b3"][j, i] == p["b3"][i * 4 + j]


def test_kernel_operands_follow_parameter_writes():
    blk = blocks.DepthConvBlock(16, 16)
    first = blk._kernel_operands()
    assert blk._kernel_operands() is first
    with torch.no_grad():
        blk.dc[0].weight.add_(1.0)
    again = blk._kernel_operands()
    assert again is not first
    assert torch.equal(again["w1"], blk.dc[0].weight[:, :, 0, 0].t())


def test_launch_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    ops = K1.prepare_operands(blocks.DepthConvBlock(16, 16).block_params())
    with pytest.raises(ValueError, match="CUDA"):
        K1.fused_dcb_launch(x, ops)
