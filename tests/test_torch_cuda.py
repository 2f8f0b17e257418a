"""The CUDA kernels of the port on the card: K1 (csrc/fused_dcb.cu), one
block and the stacked form, and K2 (csrc/rans_decode.cu), against their
plain PyTorch versions (K2 also against the host decoder), and the
wrappers' refusals.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so it also runs on the GPU machine, where
tests/conftest.py (which imports jax) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.kernels import rans_decode as K2
from dcvc_tpu_torch.layers import blocks
from dcvc_tpu_torch.perf_probe import k2_fixtures, run_k2_case
from dcvc_tpu_torch.rans.device_decode import init_state


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c,shortcut", [
    (8, 18, 256, 128, False),
    (17, 30, 128, 128, True),
    (5, 7, 192, 384, False),
])
def test_cuda_kernel_matches_plain(cuda_device, h, w, cin, c, shortcut):
    """The CUDA kernel against its plain version, both bf16: within 2^-6
    of the output's largest magnitude (the two round at different points,
    see chip_smoke.py)."""
    gen = torch.Generator().manual_seed(0)
    blk = blocks.DepthConvBlock(cin, c, shortcut=shortcut)
    blocks.lecun_init_(blk, gen)
    blk = blk.to(cuda_device, torch.bfloat16)
    x = torch.randn(1, h, w, cin, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    with torch.inference_mode():
        n = K1.fused_dcb.launches
        out = blk(x)
        torch.cuda.synchronize()
        assert K1.fused_dcb.launches == n + 1
        ref = K1.fused_dcb_reference(x, blk.block_params(), shortcut)
    peak = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= peak * 2 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("ch,dtype,match", [
    (64, torch.float32, "bfloat16"),
    (48, torch.bfloat16, "multiples of 64"),
])
def test_cuda_wrapper_raises(cuda_device, ch, dtype, match):
    """On the card the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    blk = blocks.DepthConvBlock(ch, ch).to(cuda_device, dtype)
    n = K1.fused_dcb.launches
    with pytest.raises(ValueError, match=match):
        blk(torch.zeros(1, 4, 4, ch, device=cuda_device, dtype=dtype))
    assert K1.fused_dcb.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,c,inner", [
    (9, 17, 2048, 512, 256),     # the HTS encoder's adaptor, Cin = 2048
    (7, 13, 768, 768, 768),      # the HTS prior fusion, C = I = 768
])
def test_cuda_kernel_hts_widths(cuda_device, h, w, cin, c, inner):
    """The one-block kernel at the HTS widths that need the adaptor
    pre-pass and the 32-row FFN blocks."""
    gen = torch.Generator().manual_seed(1)
    blk = blocks.DepthConvBlock(cin, c, dcb2=inner < c)
    blocks.lecun_init_(blk, gen)
    blk = blk.to(cuda_device, torch.bfloat16)
    x = torch.randn(1, h, w, cin, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
    with torch.inference_mode():
        out = blk(x)
        torch.cuda.synchronize()
        ref = K1.fused_dcb_reference(x, blk.block_params())
    peak = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= peak * 2 ** -6


def _stack(s, cin, c, device):
    gen = torch.Generator().manual_seed(s)
    mods = torch.nn.ModuleList(blocks.DepthConvBlock(cin, c)
                               for _ in range(s))
    for m in mods:
        blocks.lecun_init_(m, gen)
    return mods.to(device, torch.bfloat16), gen


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,c,h,w,broadcast", [
    (2, 128, 128, 5, 7, False),
    (4, 256, 256, 9, 16, True),   # one x for every entry (stride 0)
    (8, 256, 128, 17, 30, False),  # adaptor
    (8, 192, 128, 4, 5, False),    # adaptor, Cin not a multiple of 128
])
def test_cuda_stacked_kernel_matches_plain(cuda_device, s, cin, c, h, w,
                                          broadcast):
    """The stacked kernel (one launch of each kind for S entries) against
    its per-entry plain version, each entry within 2^-6 of its peak; and
    rows= runs a sub-range of the stack to the same bits."""
    mods, gen = _stack(s, cin, c, cuda_device)
    stack = blocks.StackedDCB(mods)
    if broadcast:
        x = torch.randn(1, 1, h, w, cin, generator=gen).to(
            cuda_device, torch.bfloat16).expand(s, 1, h, w, cin)
    else:
        x = torch.randn(s, 1, h, w, cin, generator=gen).to(
            cuda_device, torch.bfloat16)
    with torch.inference_mode():
        n = K1.fused_dcb_stacked.launches
        out = stack(x)
        part = stack(x[s // 2:], rows=(s // 2, s))
        torch.cuda.synchronize()
        assert K1.fused_dcb_stacked.launches == n + 2
        ref = K1.fused_dcb_stacked_reference(x, stack.stacked_params())
    assert out.shape == ref.shape == (s, 1, h, w, c)
    assert torch.equal(part, out[s // 2:])
    for e in range(s):
        peak = ref[e].float().abs().max().item()
        err = (out[e].float() - ref[e].float()).abs().max().item()
        assert err <= peak * 2 ** -6, e


@pytest.mark.cuda
def test_cuda_stacked_wrapper_raises(cuda_device):
    """A stacked shape the kernel does not take raises on the card: x with
    a stack stride that is neither 0 nor one entry, and weights of
    another stack size."""
    mods, _ = _stack(2, 64, 64, cuda_device)
    ops = blocks.StackedDCB(mods)._kernel_operands()
    n = K1.fused_dcb_stacked.launches
    big = torch.zeros(4, 1, 4, 4, 64, device=cuda_device,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stack stride"):
        K1.fused_dcb_stacked_launch(big[::2], ops)
    with pytest.raises(ValueError, match="entries"):
        K1.fused_dcb_stacked_launch(big[:3], ops)
    assert K1.fused_dcb_stacked.launches == n


@pytest.mark.cuda
def test_cuda_rans_decode_matches_plain_and_host(cuda_device):
    """K2 on the fixtures of the JAX package's decode tests (1/2/3/5/8
    lanes with escapes, count < lanes, count 0, z -> y -> y): each call's
    symbols are the host decoder's, zeros past the count, and symbols and
    final lane states equal the plain version's."""
    for fixture in k2_fixtures():
        n = K2.rans_decode.launches
        st_k, outs_k = run_k2_case(fixture, cuda_device, K2.rans_decode)
        torch.cuda.synchronize()
        assert K2.rans_decode.launches == n + len(fixture[3])
        st_p, outs_p = run_k2_case(fixture, cuda_device,
                                   K2.rans_decode_reference)
        assert torch.equal(st_k["st"], st_p["st"]), fixture[0]
        assert torch.equal(st_k["ptr"], st_p["ptr"]), fixture[0]
        for (_, count, _, _, want), out_k, out_p in zip(fixture[3], outs_k,
                                                        outs_p):
            assert torch.equal(out_k, out_p), fixture[0]
            got = out_k.cpu().numpy()
            np.testing.assert_array_equal(got[:count], want)
            assert not got[count:].any(), fixture[0]


def _k2_args(device, lanes=2, idx_device=None, st_dtype=torch.int32):
    streams = torch.zeros(lanes, 16, dtype=torch.uint8, device=device)
    state = init_state(streams)
    state["st"] = state["st"].to(st_dtype)
    idx = torch.zeros(8, dtype=torch.uint8, device=idx_device or device)
    bank = K2.make_bank(np.array([[0, 65535, 65536]], np.int32),
                        np.array([3], np.int32), device)
    return state, idx, 8, bank


@pytest.mark.cuda
@pytest.mark.parametrize("kind,match", [
    ("cpu state", "one device"),
    ("9 lanes", "1 <= n <= 8"),
    ("int64 st", "st must be torch.int32"),
])
def test_cuda_rans_decode_wrapper_raises(cuda_device, kind, match):
    """K2's wrapper launches or raises on the card, never falls back: a
    CPU state with a CUDA idx, more than 8 lanes, a wrong dtype."""
    if kind == "cpu state":
        args = _k2_args("cpu", idx_device=cuda_device)
    elif kind == "9 lanes":
        args = _k2_args(cuda_device, lanes=9)
    else:
        args = _k2_args(cuda_device, st_dtype=torch.int64)
    n = K2.rans_decode.launches
    with pytest.raises(ValueError, match=match):
        K2.rans_decode(*args)
    assert K2.rans_decode.launches == n
