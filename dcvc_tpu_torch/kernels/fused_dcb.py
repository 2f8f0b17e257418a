"""Fused DepthConvBlock: the hand-written Hopper kernel
(csrc/fused_dcb.cu, replacing dcvc_tpu/kernels/fused_dcb.py::_dcb_kernel)
and its plain PyTorch version, in both forms of the TPU kernel: one block
(`fused_dcb`) and S independent blocks with stacked weights
(`fused_dcb_stacked`, the DMC-HTS/HTL recon heads).  The one-block form
also runs DCVC-RT's two-way block, whose FFN sums two planes where UF's
sums four (`ffn_planes`).

On the card a call is a chain of launches (adaptor, h, dw, dc_out,
ffn_in, ffn_out; see csrc/fused_dcb.cu), the GEMMs on one wgmma/TMA core.
`k1_plan` decides here, in Python, which launches run and each one's
tile, grid and shared memory; the C entry checks the plan.  Channel
counts are multiples of 16: a width with no 64-wide divisor (368, the
DCVC-RT intra trunk) gets tail tiles, whose out-of-range columns TMA
reads as zeros and the epilogues do not store.

Each wrapper launches the CUDA kernel for a tensor on the card and takes
the plain version only for a tensor on the CPU.  On the card it never
falls back: a shape, type or layout the kernel does not take raises.  The
kernel is built with nvcc at its first launch (kernels/_build.py);
importing this module builds nothing.

params use the layout of dcvc_tpu's fused_dcb: optional 'wa'/'ba'
(adaptor), and 'w1 b1 wd bd w2 b2 w3 b3 w4 b4' with 1x1 kernels
(Cin, Cout), the dw kernel (3, 3, I) and ffn_in (C, 4I), whose 4I outputs
are P chunks of I_ffn = 4I / P summed into ffn_out's I_ffn inputs (w4
(I_ffn, C)): UF's P = 4 chunks interleaved (output channel c*4 + j
belongs to chunk j), RT's P = 2 contiguous halves (channel j*I_ffn + c;
RT's I is C, so I_ffn = 2C).  Stacked params carry a leading S.

No backward: the TPU kernel has none either.  Call under
torch.inference_mode().
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from ._build import load_library


def wsilu_f32(x):
    return x * torch.sigmoid(4.0 * x)


def ffn_planes(params):
    """P, the number of chunks the FFN's chunk-add sums: ffn_in's outputs
    (w3 (..., C, P * I_ffn)) over ffn_out's inputs (w4 (..., I_ffn, C));
    4 for UF's block, 2 for RT's two-way block."""
    planes = params["w3"].shape[-1] // params["w4"].shape[-2]
    if planes not in (2, 4) or \
            params["w3"].shape[-1] != planes * params["w4"].shape[-2]:
        raise ValueError(f"fused_dcb: ffn_in has {params['w3'].shape[-1]} "
                         f"outputs for {params['w4'].shape[-2]} inputs of "
                         f"ffn_out; the chunk-add sums 2 or 4 chunks")
    return planes


def fused_dcb_reference(x, params, shortcut=False):
    """Plain DepthConvBlock (the unfused path of dcvc_tpu's
    layers/blocks.py DepthConvBlock, and of its legacy/dcvc_rt.py two-way
    block) in the dtype of x and params."""
    if "wa" in params:
        x = torch.matmul(x, params["wa"]) + params["ba"]
    inner = params["w1"].shape[-1]
    h = wsilu_f32(torch.matmul(x, params["w1"]) + params["b1"])
    wd = params["wd"].permute(2, 0, 1).unsqueeze(1)          # (I, 1, 3, 3)
    h = F.conv2d(h.permute(0, 3, 1, 2), wd, params["bd"], padding=1,
                 groups=inner).permute(0, 2, 3, 1)
    out = torch.matmul(h, params["w2"]) + params["b2"] + x
    f = wsilu_f32(torch.matmul(out, params["w3"]) + params["b3"])
    if ffn_planes(params) == 4:
        # chunk-add: channels (c*4 + j) summed over j
        f = f.reshape(*f.shape[:-1], inner, 4).sum(dim=-1)
    else:
        # two-way chunk-add: the contiguous halves summed
        f1, f2 = f.chunk(2, dim=-1)
        f = f1 + f2
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


WEIGHTS = ("wa", "ba", "w1", "b1", "wd", "bd", "w2", "b2", "w3", "b3",
           "w4", "b4")


class KernelOperands(dict):
    """prepare_operands' result: a dict of the kernel's operands that also
    remembers the signature it was last checked for (`checked`) and the
    operands' addresses in WEIGHTS order (`ptrs`), so that a module's
    cached operands are checked once and not at every call."""
    checked = None
    ptrs = None


def prepare_operands(params):
    """params -> the kernel's operands: contiguous tensors, every matrix
    K-major, (N, K) as a 1x1 conv stores it (wa (C, Cin), w1 (I, C),
    w2 (C, I), w4 (C, I_ffn)), and ffn_in regrouped j-major to
    (..., P, I_ffn, C) (its bias to (..., P, I_ffn)), so that one block
    multiplies the P chunk planes and sums the chunk-add.  Leading
    (stack) dims are kept."""
    def kmajor(w):
        return w.transpose(-1, -2).contiguous()
    ops = {k: params[k].contiguous() for k in ("b1", "wd", "bd", "b2", "b4")}
    for k in ("w1", "w2", "w4"):
        ops[k] = kmajor(params[k])
    if "wa" in params:
        ops["wa"] = kmajor(params["wa"])
        ops["ba"] = params["ba"].contiguous()
    inner = params["w1"].shape[-1]
    w3, b3 = params["w3"], params["b3"]
    if ffn_planes(params) == 4:      # UF: output channel c*4 + j
        ops["w3"] = kmajor(w3.reshape(*w3.shape[:-1], inner, 4)
                           .movedim(-1, -3))
        ops["b3"] = b3.reshape(*b3.shape[:-1], inner, 4).movedim(-1, -2) \
            .contiguous()
    else:                            # RT: output channel j*I_ffn + c
        ops["w3"] = kmajor(w3.reshape(*w3.shape[:-1], 2, -1).movedim(-2, -3))
        ops["b3"] = b3.reshape(*b3.shape[:-1], 2, -1).contiguous()
    return KernelOperands(ops)


# stacked params (leading S) -> the stacked kernel's operands, each with
# the same leading S
prepare_operands_stacked = prepare_operands


# ------------------------------------------------------------ launch plan

K1_SMS = 132              # SMs of an H100 SXM
K1_SMEM_LIMIT = 232448    # shared memory a Hopper block may use
GEMM_BK = 64              # depth of a pipeline stage (hopper_gemm.cuh)
DW_TILE = (8, 32)         # dw launch: pixel rows x columns per block
DW_CHANNELS = 64          # channels per dw block
CHAIN = ("adaptor", "h", "dw", "dc_out", "ffn_in", "ffn_out")


class K1Launch(NamedTuple):
    """One launch of K1's chain.  A GEMM ('adaptor', 'h', 'dc_out',
    'ffn_in', 'ffn_out') multiplies s entries of (m x k) by (k x n) in
    blocks of bm rows by bn accumulator columns, bn_out of them output
    columns (ffn_in: P j planes of 256 / P, bn = 256), through a ring of
    `stages` pipeline stages.  'dw': bm x bn is the pixel tile, bn_out the
    channels of a block (the last block's tail masked), m = H * W, n = I,
    stages 0."""
    name: str
    s: int
    m: int
    n: int
    k: int
    bm: int
    bn: int
    bn_out: int
    stages: int
    grid: tuple
    smem: int


def gemm_stages(bm, bn):
    """4 stages for ffn_in's 256-wide tiles (their 128 accumulators per
    thread leave room for one block per SM anyway); 3 for the others, so
    that 2-4 blocks share an SM and one's epilogue overlaps another's
    products."""
    return 4 if bn == 256 else 3


def gemm_smem(bm, bn, stages):
    """Shared memory of a GEMM block (hopper_gemm.cuh smem_bytes)."""
    return stages * (bm + bn) * GEMM_BK * 2 + 16 * stages + 1024


def epilogue_tile_bytes(bm, bn):
    """The epilogue's f32 tile of sums (hopper_gemm.cuh tile_ld), which
    reuses the stages."""
    return bm * (bn + 4) * 4


def tile_fits(bn, n):
    """A bn-wide tile may cover n columns: bn divides n, or n (a multiple
    of 16) has no 64-wide divisor, and the last tile has a tail that the
    kernel masks (RT's 368-channel trunk)."""
    return n % bn == 0 or n % 64 != 0


def _gemm(name, s, m, n, k, tile=None, planes=4):
    """BM = 128 with the widest BN <= 128 that fits n (tile_fits) and gives
    at least a wave of blocks (K1_SMS), else BM = 64 likewise, else the
    most blocks (BM = 64, the narrowest BN).  ffn_in's blocks are 256 /
    `planes` output columns wide (its P j planes, 256 accumulators; the
    last tile may have a tail).  A 256-wide tile of the other products
    leaves room for one block per SM; two 128-wide ones share it and
    measured faster (`perf_probe tiles`, PERF.md §6).  tile=(bm, bn)
    forces a tile (bn where it is a width the kernel has and fits n, else
    the narrowest)."""
    widths = (256 // planes,) if name == "ffn_in" else (128, 64)

    def fits(bn):
        return name == "ffn_in" or tile_fits(bn, n)
    pick = (64, widths[-1])
    if tile is not None:
        bm, bn = tile
        pick = (bm, bn if bn in widths and fits(bn) else widths[-1])
    else:
        for bm in (128, 64):
            wide = [bn for bn in widths if fits(bn)
                    and s * math.ceil(m / bm) * math.ceil(n / bn) >= K1_SMS]
            if wide:
                pick = (bm, wide[0])
                break
    bm, bn_out = pick
    bn = planes * bn_out if name == "ffn_in" else bn_out
    stages = gemm_stages(bm, bn)
    return K1Launch(name, s, m, n, k, bm, bn, bn_out, stages,
                    (math.ceil(m / bm) * math.ceil(n / bn_out), s, 1),
                    gemm_smem(bm, bn, stages))


@functools.lru_cache(maxsize=None)
def k1_plan(s, h, w, cin, c, inner, adaptor, tile=None, ffn_inner=None,
            planes=4):
    """The launches of one call of K1 on s entries of (h, w, cin) with
    channels c and the dc trunk's inner width `inner`, in order; the FFN
    sums `planes` planes of ffn_inner columns (default 4 * inner /
    planes, ffn_in's 4I outputs split in P): UF I and 4, RT 2c and 2.
    tile=(bm, bn) forces every GEMM's tile (the card tests)."""
    if ffn_inner is None:
        ffn_inner = 4 * inner // planes
    m = h * w
    th, tw = DW_TILE
    dw = K1Launch("dw", s, m, inner, 9, th, tw, DW_CHANNELS, 0,
                  (math.ceil(h / th) * math.ceil(w / tw),
                   math.ceil(inner / DW_CHANNELS), s),
                  (th + 2) * (tw + 2) * DW_CHANNELS * 2)
    chain = [_gemm("adaptor", s, m, c, cin, tile)] if adaptor else []
    return tuple(chain + [_gemm("h", s, m, inner, c, tile), dw,
                          _gemm("dc_out", s, m, c, inner, tile),
                          _gemm("ffn_in", s, m, ffn_inner, c, tile, planes),
                          _gemm("ffn_out", s, m, c, ffn_inner, tile)])


def gemm_block_tile(launch, bx, by):
    """The outputs block (bx, by) of a GEMM launch computes, as the kernel
    decodes it: (entry, first row, end row, first column, end column),
    rows clipped to m and columns to n (the tail tile's masked stores)."""
    m_tile, n_tile = divmod(bx, math.ceil(launch.n / launch.bn_out))
    m0, n0 = m_tile * launch.bm, n_tile * launch.bn_out
    return (by, m0, min(launch.m, m0 + launch.bm), n0,
            min(launch.n, n0 + launch.bn_out))


PLAN_INTS = 9     # per launch of CHAIN


@functools.lru_cache(maxsize=None)
def plan_ints(plan):
    """The plan as the C entry reads it: a row of PLAN_INTS ints per launch
    of CHAIN, [on, bm, bn, bn_out, stages, grid x, grid y, grid z, smem],
    zeros for a launch that does not run."""
    rows = {q.name: [1, q.bm, q.bn, q.bn_out, q.stages, *q.grid, q.smem]
            for q in plan}
    flat = [v for name in CHAIN for v in rows.get(name, [0] * PLAN_INTS)]
    return (ctypes.c_int * len(flat))(*flat)


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the CUDA kernel's C entry point."""
    fn = load_library("fused_dcb.cu").dcvc_fused_dcb
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
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


def _launch(x, ops, shortcut, lead, tile=None, keep=None):
    """Launch the kernel on x (S, H, W, Cin) bf16, whose entries are each
    contiguous and either consecutive or all the same (entry stride 0),
    with operands whose leading dims are `lead` ((), or (S,)).  Returns
    (S, H, W, C) bf16.  tile: k1_plan's.  keep: a dict that receives the
    chain's intermediates (xa, h, d, out1, out1c, s; each (S, H, W, N))."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_dcb: the kernel runs on a CUDA device, "
                         f"x is on {x.device}")
    nst, hh, ww, cin = x.shape
    cout, inner = ops["w2"].shape[-2], ops["w1"].shape[-2]
    planes, ffn_inner = ops["w3"].shape[-3], ops["w4"].shape[-1]
    if min(cin, cout, inner, ffn_inner) <= 0 or cin % 16 or cout % 16 \
            or inner % 16 or ffn_inner % 16:
        raise ValueError(f"fused_dcb: channel counts must be multiples of "
                         f"16, got Cin={cin} C={cout} I={inner} "
                         f"I_ffn={ffn_inner}")
    dev = x.device
    if x.dtype != torch.bfloat16 or x.stride()[1:] != (ww * cin, cin, 1) \
            or x.data_ptr() % 16:
        raise ValueError(f"fused_dcb: x must be bfloat16 with contiguous, "
                         f"16-byte aligned entries, got {x.dtype} strides "
                         f"{x.stride()}")
    x_stride = x.stride(0) if nst > 1 else hh * ww * cin
    if x_stride not in (0, hh * ww * cin):
        raise ValueError(f"fused_dcb: x's stack stride must be 0 or "
                         f"H*W*Cin, got {x_stride}")
    has_adaptor = "wa" in ops
    sig = (dev, lead, cin, cout, inner, has_adaptor, ffn_inner, planes)
    if getattr(ops, "checked", None) != sig:
        ptrs = _check_operands(ops, sig)
    else:
        ptrs = ops.ptrs

    plan = k1_plan(nst, hh, ww, cin, cout, inner, has_adaptor, tile,
                   ffn_inner, planes)
    size, offs = workspace(nst * hh * ww, cout, inner, has_adaptor,
                           keep is not None, ffn_inner)
    ws = torch.empty((size,), dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    at = {name: base + off for name, (off, _, _) in offs.items()}
    out = torch.empty((nst, hh, ww, cout), dtype=torch.bfloat16, device=dev)
    err = load_kernel()(
        x.data_ptr(), *ptrs, at.get("xa"), at["h"], at["d"], at["out1"],
        at["out1c"], at.get("s", at["h"]), out.data_ptr(), nst, x_stride,
        hh, ww, cin, cout, inner, ffn_inner, planes, int(bool(shortcut)),
        ctypes.addressof(plan_ints(plan)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_dcb: kernel launch failed with CUDA error "
                           f"{err} (S={nst} H={hh} W={ww} Cin={cin} C={cout} "
                           f"I={inner})")
    if keep is not None:
        for name, (off, ch, width) in offs.items():
            dtype = torch.float32 if width == 4 else torch.bfloat16
            keep[name] = ws[off:off + nst * hh * ww * ch * width].view(
                dtype).view(nst, hh, ww, ch)
    return out


@functools.lru_cache(maxsize=None)
def workspace(pix, cout, inner, adaptor, keep, ffn_inner):
    """The chain's intermediates in one buffer: (bytes, {name: (offset,
    channels, bytes per element)}) for h, d, out1 (f32), out1c, xa (with an
    adaptor) and, when they are kept or wider than h (ffn_inner: RT's 2C),
    the FFN sum s; otherwise s reuses h's buffer (h is dead once dc_out
    has run).  Each part starts on a 256-byte boundary."""
    parts = [("h", inner, 2), ("d", inner, 2), ("out1", cout, 4),
             ("out1c", cout, 2)]
    if adaptor:
        parts.append(("xa", cout, 2))
    if keep or ffn_inner > inner:
        parts.append(("s", ffn_inner, 2))
    offs, size = {}, 0
    for name, ch, width in parts:
        offs[name] = (size, ch, width)
        size += -(-pix * ch * width // 256) * 256
    return size, offs


def _check_operands(ops, sig):
    """Raise unless ops are what the kernel takes for the signature
    (device, lead dims, Cin, C, I, adaptor, I_ffn, P); return their
    addresses in WEIGHTS order, and remember both on a KernelOperands."""
    dev, lead, cin, cout, inner, has_adaptor, ffn_inner, planes = sig
    if planes not in (2, 4):
        raise ValueError(f"fused_dcb: ffn_in has {planes} planes, the "
                         f"kernel sums 2 or 4")
    if has_adaptor:
        _check("wa", ops["wa"], lead + (cout, cin), dev, 16)
        _check("ba", ops["ba"], lead + (cout,), dev, 8)
    elif cin != cout:
        raise ValueError(f"fused_dcb: Cin={cin} != C={cout} needs an adaptor")
    for name, shape, align in (
            ("w1", (inner, cout), 16), ("b1", (inner,), 8),
            ("wd", (3, 3, inner), 16), ("bd", (inner,), 16),
            ("w2", (cout, inner), 16), ("b2", (cout,), 8),
            ("w3", (planes, ffn_inner, cout), 16),
            ("b3", (planes, ffn_inner), 8),
            ("w4", (cout, ffn_inner), 16), ("b4", (cout,), 8)):
        _check(name, ops[name], lead + shape, dev, align)
    ptrs = tuple(ops[k].data_ptr() if k in ops else None for k in WEIGHTS)
    if isinstance(ops, KernelOperands):
        ops.checked, ops.ptrs = sig, ptrs
    return ptrs


@spanned("k1.launch")
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


@spanned("k1.launch")
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
