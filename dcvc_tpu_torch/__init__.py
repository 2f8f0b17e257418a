"""PyTorch/CUDA port of DCVC-TPU for NVIDIA Hopper (H100).

Mirrors the layout and public names of `dcvc_tpu` (the JAX reference): a
module `dcvc_tpu/X/y.py` has its counterpart at `dcvc_tpu_torch/X/y.py`.
Public functions keep the NHWC layout (B, H, W, C).  The Pallas kernels of
the reference become hand-written CUDA kernels under `csrc/`, built with
nvcc at first use and bound with ctypes (`kernels/`).

This package never imports jax, flax or `dcvc_tpu`, so that it runs on a
machine without JAX.  Framework-free code it needs from the reference
package (the host rANS coder, the CDF tables) is carried as byte-equal
copies, pinned to the originals by tests/test_torch_core.py.
"""

__version__ = "0.1.0"
