"""Fused DepthConvBlock: the hand-written Hopper kernel
(csrc/fused_dcb.cu, replacing dcvc_tpu/kernels/fused_dcb.py::_dcb_kernel)
and its plain PyTorch version, in both forms of the TPU kernel: one block
(`fused_dcb`) and S independent blocks with stacked weights
(`fused_dcb_stacked`, the DMC-HTS recon heads).

Each wrapper launches the CUDA kernel for a tensor on the card and takes
the plain version only for a tensor on the CPU.  On the card it never
falls back: a shape, type or layout the kernel does not take raises.  The
kernel is built with nvcc at its first launch (kernels/_build.py);
importing this module builds nothing.

params use the layout of dcvc_tpu's fused_dcb: optional 'wa'/'ba'
(adaptor), and 'w1 b1 wd bd w2 b2 w3 b3 w4 b4' with 1x1 kernels
(Cin, Cout), the dw kernel (3, 3, I) and ffn_in (C, 4I) whose output
channel c*4 + j belongs to chunk j.  Stacked params carry a leading S.

No backward: the TPU kernel has none either.  Call under
torch.inference_mode().
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library


def wsilu_f32(x):
    return x * torch.sigmoid(4.0 * x)


def fused_dcb_reference(x, params, shortcut=False):
    """Plain DepthConvBlock (the unfused path of dcvc_tpu's
    layers/blocks.py DepthConvBlock) in the dtype of x and params."""
    if "wa" in params:
        x = torch.matmul(x, params["wa"]) + params["ba"]
    inner = params["w1"].shape[-1]
    h = wsilu_f32(torch.matmul(x, params["w1"]) + params["b1"])
    wd = params["wd"].permute(2, 0, 1).unsqueeze(1)          # (I, 1, 3, 3)
    h = F.conv2d(h.permute(0, 3, 1, 2), wd, params["bd"], padding=1,
                 groups=inner).permute(0, 2, 3, 1)
    out = torch.matmul(h, params["w2"]) + params["b2"] + x
    f = wsilu_f32(torch.matmul(out, params["w3"]) + params["b3"])
    # chunk-add: channels (c*4 + j) summed over j
    f = f.reshape(*f.shape[:-1], inner, 4).sum(dim=-1)
    out = torch.matmul(f, params["w4"]) + params["b4"] + out
    if shortcut:
        out = out + x
    return out


def fused_dcb_stacked_reference(x, params):
    """Plain StackedDCB: x (S, 1, H, W, Cin), params with a leading S;
    entry s is fused_dcb_reference(x[s], params[s])."""
    return torch.stack([
        fused_dcb_reference(x[s], {k: v[s] for k, v in params.items()})
        for s in range(x.shape[0])])


def prepare_operands(params):
    """params -> the kernel's operands: contiguous tensors, ffn_in
    regrouped j-major to (..., 4, C, I) (and its bias to (..., 4, I)) so
    the kernel's four chunk matmuls accumulate the chunk-add.  Leading
    (stack) dims are kept."""
    ops = {k: params[k].contiguous()
           for k in ("w1", "b1", "wd", "bd", "w2", "b2", "w4", "b4")}
    if "wa" in params:
        ops["wa"] = params["wa"].contiguous()
        ops["ba"] = params["ba"].contiguous()
    inner = params["w1"].shape[-1]
    w3, b3 = params["w3"], params["b3"]
    ops["w3"] = w3.reshape(*w3.shape[:-1], inner, 4).movedim(-1, -3) \
        .contiguous()
    ops["b3"] = b3.reshape(*b3.shape[:-1], inner, 4).movedim(-1, -2) \
        .contiguous()
    return ops


# stacked params (leading S) -> the stacked kernel's operands, each with
# the same leading S
prepare_operands_stacked = prepare_operands


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the CUDA kernel's C entry point."""
    fn = load_library("fused_dcb.cu").dcvc_fused_dcb
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device, align):
    if t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"fused_dcb: {name} must be bfloat16 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_dcb: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"fused_dcb: {name} must be contiguous and "
                         f"{align}-byte aligned")


def _launch(x, ops, shortcut, lead):
    """Launch the kernel on x (S, H, W, Cin) bf16, whose entries are each
    contiguous and either consecutive or all the same (entry stride 0),
    with operands whose leading dims are `lead` ((), or (S,)).  Returns
    (S, H, W, C) bf16."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_dcb: the kernel runs on a CUDA device, "
                         f"x is on {x.device}")
    nst, hh, ww, cin = x.shape
    cout, inner = ops["w2"].shape[-1], ops["w1"].shape[-1]
    if min(cin, cout, inner) <= 0 or cin % 64 or cout % 64 or inner % 64:
        raise ValueError(f"fused_dcb: channel counts must be multiples of "
                         f"64, got Cin={cin} C={cout} I={inner}")
    dev = x.device
    _check("x[0]", x[0], (hh, ww, cin), dev, 16)
    x_stride = x.stride(0) if nst > 1 else hh * ww * cin
    if x_stride not in (0, hh * ww * cin):
        raise ValueError(f"fused_dcb: x's stack stride must be 0 or "
                         f"H*W*Cin, got {x_stride}")
    has_adaptor = "wa" in ops
    if has_adaptor:
        _check("wa", ops["wa"], lead + (cin, cout), dev, 16)
        _check("ba", ops["ba"], lead + (cout,), dev, 4)
    elif cin != cout:
        raise ValueError(f"fused_dcb: Cin={cin} != C={cout} needs an adaptor")
    for name, shape, align in (
            ("w1", (cout, inner), 16), ("b1", (inner,), 4),
            ("wd", (3, 3, inner), 2), ("bd", (inner,), 2),
            ("w2", (inner, cout), 16), ("b2", (cout,), 4),
            ("w3", (4, cout, inner), 16), ("b3", (4, inner), 4),
            ("w4", (inner, cout), 16), ("b4", (cout,), 4)):
        _check(name, ops[name], lead + shape, dev, align)

    out = torch.empty((nst, hh, ww, cout), dtype=torch.bfloat16, device=dev)
    # scratch of the kernel's launches: out1 (f32) and, with an adaptor,
    # the adapted x
    out1 = torch.empty((nst * hh * ww * cout,), dtype=torch.float32,
                       device=dev)
    xa = (torch.empty((nst * hh * ww * cout,), dtype=torch.bfloat16,
                      device=dev) if has_adaptor else None)
    ptr = {k: v.data_ptr() for k, v in ops.items()}
    err = load_kernel()(
        x.data_ptr(), ptr.get("wa"), ptr.get("ba"), ptr["w1"], ptr["b1"],
        ptr["wd"], ptr["bd"], ptr["w2"], ptr["b2"], ptr["w3"], ptr["b3"],
        ptr["w4"], ptr["b4"], out1.data_ptr(),
        None if xa is None else xa.data_ptr(), out.data_ptr(),
        nst, x_stride, hh, ww, cin, cout, inner, int(bool(shortcut)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_dcb: kernel launch failed with CUDA error "
                           f"{err} (S={nst} H={hh} W={ww} Cin={cin} C={cout} "
                           f"I={inner})")
    return out


def fused_dcb_launch(x, ops, shortcut=False):
    """Launch the CUDA kernel on x (1, H, W, Cin) bf16 with operands from
    prepare_operands.  Returns (1, H, W, C) bf16.  Counts the launch in
    fused_dcb.launches."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"fused_dcb: x must be (1, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    out = _launch(x, ops, shortcut, ())
    fused_dcb.launches += 1
    return out


def fused_dcb_stacked_launch(x, ops):
    """Launch the stacked CUDA kernel on x (S, 1, H, W, Cin) bf16 with
    operands from prepare_operands_stacked.  x's entries may all be one
    tensor (a stack stride of 0, as x.expand gives).  Returns
    (S, 1, H, W, C) bf16.  Counts the launch in
    fused_dcb_stacked.launches."""
    if x.dim() != 5 or x.shape[1] != 1:
        raise ValueError(f"fused_dcb_stacked: x must be (S, 1, H, W, Cin), "
                         f"got {tuple(x.shape)}")
    nst = x.shape[0]
    if ops["w1"].dim() != 3 or ops["w1"].shape[0] != nst:
        raise ValueError(f"fused_dcb_stacked: x has {nst} entries, the "
                         f"weights {tuple(ops['w1'].shape)}")
    out = _launch(x[:, 0], ops, False, (nst,))
    fused_dcb_stacked.launches += 1
    return out[:, None]


def fused_dcb(x, params, shortcut=False, ops=None):
    """One DepthConvBlock on x (1, H, W, Cin): the CUDA kernel on the card,
    the plain version on the CPU.  `ops`, when given, are the kernel's
    operands already made by prepare_operands(params)."""
    if x.device.type == "cpu":
        return fused_dcb_reference(x, params, shortcut)
    return fused_dcb_launch(x, prepare_operands(params) if ops is None
                            else ops, shortcut)


def fused_dcb_stacked(x, params, ops=None):
    """S independent DepthConvBlocks on x (S, 1, H, W, Cin) with stacked
    params: the CUDA kernel on the card (one launch of each kind for all
    S), the plain version on the CPU.  `ops`, when given, are the
    kernel's operands already made by prepare_operands_stacked(params)."""
    if x.device.type == "cpu":
        return fused_dcb_stacked_reference(x, params)
    return fused_dcb_stacked_launch(
        x, prepare_operands_stacked(params) if ops is None else ops)


# kernel launches since the last reset (plain integers; the main path's
# counts are read by chip_smoke.py)
fused_dcb.launches = 0
fused_dcb_stacked.launches = 0
