"""Port parity, layers and the fused-DCB kernel's plain versions (one
block and the stacked form):
dcvc_tpu_torch against the flax modules and the Pallas kernel (interpret
mode) of dcvc_tpu, float32 on the CPU.

Tolerance atol = rtol = 2e-5, the JAX package's own bound for the fused
kernel against the XLA path (tests/test_fused_dcb.py): the same f32 sums
taken in another order.  The CUDA kernel itself is compared with its plain
version on the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.kernels.fused_dcb import fused_dcb as jax_fused_dcb
from dcvc_tpu.kernels.fused_dcb import \
    fused_dcb_stacked as jax_fused_dcb_stacked
from dcvc_tpu.layers import blocks as jblocks
from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.layers import blocks
from dcvc_tpu_torch.utils.jax_bridge import dmci_params_from_jax, \
    stacked_dcb_params_from_jax

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
    # every matrix K-major, (N, K); ffn_in (4, I, C), row i of plane j
    # being output channel i*4 + j
    for k in ("w1", "w2", "w4"):
        assert torch.equal(ops[k], p[k].t()), k
    assert ops["w3"].shape == (4, inner, c)
    for j in range(4):
        for i in range(inner):
            assert torch.equal(ops["w3"][j][i, :], p["w3"][:, i * 4 + j])
            assert ops["b3"][j, i] == p["b3"][i * 4 + j]


def test_kernel_operands_follow_parameter_writes():
    blk = blocks.DepthConvBlock(16, 16)
    first = blk._kernel_operands()
    assert blk._kernel_operands() is first
    with torch.no_grad():
        blk.dc[0].weight.add_(1.0)
    again = blk._kernel_operands()
    assert again is not first
    # K-major: the (out, in) matrix of the 1x1 conv's weight
    assert torch.equal(again["w1"], blk.dc[0].weight[:, :, 0, 0])


def test_launch_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    ops = K1.prepare_operands(blocks.DepthConvBlock(16, 16).block_params())
    with pytest.raises(ValueError, match="CUDA"):
        K1.fused_dcb_launch(x, ops)


def _stacked_modules(s, cin, cout):
    return torch.nn.ModuleList(blocks.DepthConvBlock(cin, cout)
                               for _ in range(s))


@pytest.mark.parametrize("s,cin,cout,rows", [
    (3, 32, 32, None),
    (2, 48, 32, None),                       # adaptor
    (8, 16, 16, (2, 6)),                     # rows: entries 2..5
    (4, 32, 16, (0, 2)),                     # adaptor and rows
])
@pytest.mark.parametrize("h,w", [(8, 8), (5, 7)])
def test_stacked_dcb_matches_flax(s, cin, cout, rows, h, w):
    """StackedDCB over S DepthConvBlocks against the flax StackedDCB on
    the same weights (split per entry by the bridge)."""
    n = s if rows is None else rows[1] - rows[0]
    x = _x((n, 1, h, w, cin))
    jmod = jblocks.StackedDCB(s, cin, cout)
    variables = jmod.init(jax.random.PRNGKey(3),
                          jnp.asarray(_x((s, 1, h, w, cin))))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), rows=rows))
    mods = _stacked_modules(s, cin, cout)
    mods.load_state_dict(stacked_dcb_params_from_jax(variables["params"]))
    with torch.inference_mode():
        got = blocks.StackedDCB(mods)(torch.from_numpy(x), rows=rows)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _stacked_kernel_params(p):
    """flax StackedDCB params -> fused_dcb_stacked layout (numpy)."""
    out = {"w1": p["dc_in_w"], "b1": p["dc_in_b"],
           "wd": p["dc_dw_w"], "bd": p["dc_dw_b"],
           "w2": p["dc_out_w"], "b2": p["dc_out_b"],
           "w3": p["ffn_in_w"], "b3": p["ffn_in_b"],
           "w4": p["ffn_out_w"], "b4": p["ffn_out_b"]}
    if "adaptor_w" in p:
        out["wa"], out["ba"] = p["adaptor_w"], p["adaptor_b"]
    return {k: np.array(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("s,cin,cout,h,w", [
    (3, 128, 128, 8, 16),
    (2, 256, 128, 4, 16),                    # adaptor
])
def test_fused_dcb_stacked_reference_matches_pallas(s, cin, cout, h, w):
    """The stacked plain version against the Pallas kernel's stacked form
    in interpret mode, on the stacked cases of tests/test_fused_dcb.py."""
    block = jblocks.StackedDCB(s, cin, cout)
    x = _x((s, 1, h, w, cin))
    variables = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _stacked_kernel_params(variables["params"])
    want = np.asarray(jax_fused_dcb_stacked(jnp.asarray(x), params,
                                            interpret=True))
    got = K1.fused_dcb_stacked_reference(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in params.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prepare_operands_stacked_keeps_entries():
    """The stacked operands are the per-entry operands, stacked."""
    mods = _stacked_modules(3, 32, 16)
    gen = torch.Generator().manual_seed(6)
    for m in mods:
        blocks.lecun_init_(m, gen)
    stacked = K1.prepare_operands_stacked(
        blocks.StackedDCB(mods).stacked_params())
    for s, m in enumerate(mods):
        one = K1.prepare_operands(m.block_params())
        assert set(one) == set(stacked)
        for k, v in one.items():
            assert torch.equal(stacked[k][s], v), k


def test_stacked_kernel_operands_follow_parameter_writes():
    mods = _stacked_modules(2, 16, 16)
    stack = blocks.StackedDCB(mods)
    first = stack._kernel_operands()
    assert stack._kernel_operands() is first
    with torch.no_grad():
        mods[1].ffn[2].bias.add_(1.0)
    again = stack._kernel_operands()
    assert again is not first
    assert torch.equal(again["b4"][1], mods[1].ffn[2].bias)


def test_stacked_launch_refuses_cpu_tensors():
    mods = _stacked_modules(2, 64, 64)
    ops = K1.prepare_operands_stacked(blocks.StackedDCB(mods).stacked_params())
    x = torch.zeros(2, 1, 4, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        K1.fused_dcb_stacked_launch(x, ops)


@pytest.mark.parametrize("kind,s,cin,cout,bcast", [
    ("fused_dcb", 1, 128, 64, False),
    ("fused_dcb_stacked", 4, 64, 64, True),     # one x for every entry
    ("fused_dcb_stacked", 2, 128, 64, False),   # adaptor
])
def test_launch_log_records_launch_shapes(kind, s, cin, cout, bcast):
    """perf_probe.LaunchLog (chip_smoke.py's record of the main path)
    notes each launch's shape under its call, leaves the counting to the
    wrapper (the CPU launch raises before it counts) and unwraps on exit."""
    from dcvc_tpu_torch.perf_probe import Launch, LaunchLog, block_inputs
    key = Launch(kind, s, 4, 8, cin, cout, cout, cin != cout, False, bcast)
    x, p, run, ref = block_inputs(key, torch.Generator().manual_seed(0),
                                  "cpu")
    assert torch.equal(run(), ref(x, p))
    launch = getattr(K1, f"{kind}_launch")
    counter = getattr(K1, kind)
    before = counter.launches
    log = LaunchLog()
    with log:
        with pytest.raises(AssertionError, match="outside"):
            getattr(K1, f"{kind}_launch")(x, K1.prepare_operands(p))
        with log.call("one"), pytest.raises(ValueError, match="CUDA"):
            getattr(K1, f"{kind}_launch")(x, K1.prepare_operands(p))
    assert getattr(K1, f"{kind}_launch") is launch
    assert counter.launches == before
    assert log.calls == [("one", {key: 1})]
    assert log.totals() == {key: 1}


def test_busy_ms_is_the_union_of_intervals():
    from dcvc_tpu_torch.perf_probe import busy_ms
    assert busy_ms([]) == 0.0
    assert busy_ms([(30, 40), (0, 10), (5, 20), (12, 15)]) == 0.03
