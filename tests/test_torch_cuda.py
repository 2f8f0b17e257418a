"""The CUDA kernel of the port on the card: K1 (csrc/fused_dcb.cu) against
its plain PyTorch version, and the wrapper's refusals.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so it also runs on the GPU machine, where
tests/conftest.py (which imports jax) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import pytest
import torch

from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.layers import blocks


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
