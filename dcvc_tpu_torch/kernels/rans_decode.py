"""K2, the on-device rANS decoder: the hand-written Hopper kernel
(csrc/rans_decode.cu, replacing dcvc_tpu/rans/pallas_decode.py::
_decode_kernel) and its plain version.

    state, out = rans_decode(state, idx, count, bank)

decodes `count` symbols of one call (a z decode or a y rung) over the
lanes of `state` (rans/device_decode.py::init_state), bit-exact with the
host coder (rans.cc dec_symbol, the lane split of decode_y / decode_z):
  - state: {"streams": (n, L) uint8, "st": (n,) int32 (the uint32 rANS
    states), "ptr": (n,) int32}, n <= 8; the returned state carries the
    new st and ptr (the streams are shared);
  - idx: (cap,) uint8, the CDF row of each packed symbol (a z call passes
    i % ch_z and the qp's ch_z rows of the bank);
  - count: a 0-dim int32 tensor on the same device (the kernel reads it
    from device memory; the host never does), or a Python int;
  - bank: {"cdf": (R, per) int32, "len": (R,) int32} (`make_bank`);
  - out: (cap,) int8, the symbols in [0, count), zeros after.

The wrapper launches the kernel when every tensor is on the card and takes
the plain version when every tensor is on the CPU; mixed devices, more
than 8 lanes or another dtype raise.  On the card it never falls back.
The kernel is built with nvcc at its first launch (kernels/_build.py).
"""

import ctypes
import functools

import torch

from ._build import load_library

K_SCALE_BITS = 16
K_RANS_L = 1 << 23
K_DEC_MASK = (1 << K_SCALE_BITS) - 1
K_BYPASS_BITS = 2
K_MAX_BYPASS = (1 << K_BYPASS_BITS) - 1
# the kernel's bounds (csrc/rans_decode.cu): a valid stream needs at most
# 2 pulls per symbol and 4 bypass chunks per escape
MAX_PULLS = 4
MAX_BYPASS_CHUNKS = 16
MAX_LANES = 8
# the rows of one call sit in shared memory: rows * (per + 1) int32
MAX_SMEM_BYTES = 48 * 1024
THREADS = 256


def make_bank(cdf, lengths, device):
    """A CDF bank (numpy (R, per) int32 and (R,) int32, as the host coder's
    set_cdf takes it) as K2's device tensors."""
    return {"cdf": torch.as_tensor(cdf, dtype=torch.int32).contiguous()
            .to(device),
            "len": torch.as_tensor(lengths, dtype=torch.int32).reshape(-1)
            .contiguous().to(device)}


def _u32(v):
    return v & 0xFFFFFFFF


def _i32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _c_zigzag_int8(value):
    """rans.cc's `(int8_t)((value % 2 == 1) ? (value + 1) / 2
    : -(value + 1) / 2)` on an int32, with C's truncating division."""
    value = _i32(value)
    if value >= 0 and value % 2 == 1:        # C's % is -1 for odd < 0
        v = (value + 1) // 2
    else:
        a = -(value + 1)                     # negate, then truncate
        v = a // 2 if a >= 0 else -((-a) // 2)
    return ((v + 128) % 256) - 128


def rans_decode_reference(state, idx, count, bank):
    """Plain version of K2 (same arguments and results): rans.cc's
    dec_symbol in a Python loop per lane, with the kernel's bounds on
    pulls and bypass chunks (which no valid stream reaches) and rows
    clamped to the bank, as the kernel does."""
    dev = idx.device
    streams = state["streams"]
    n, lane_len = streams.shape
    data = streams.cpu().contiguous().numpy().tobytes()
    cdf = bank["cdf"].cpu().tolist()
    lens = bank["len"].cpu().tolist()
    rows = len(cdf)
    rows_of = [min(r, rows - 1) for r in idx.cpu().tolist()]
    cap = len(rows_of)
    count = int(count)
    count = min(max(count, 0), cap)
    st_all = [_u32(s) for s in state["st"].cpu().tolist()]
    ptr_all = state["ptr"].cpu().tolist()
    out = [0] * cap
    size0 = count // n
    for lane in range(n):
        base = lane * lane_len
        offs = size0 * lane
        size = count - size0 * (n - 1) if lane == n - 1 else size0
        st, ptr = st_all[lane], ptr_all[lane]

        def pull():
            nonlocal ptr
            b = data[base + ptr] if 0 <= ptr < lane_len else 0
            ptr += 1
            return b

        def get_bits():
            nonlocal st
            val = st & K_MAX_BYPASS
            st >>= K_BYPASS_BITS
            if st < K_RANS_L:
                st = _u32(st << 8) | pull()
            return val

        for pos in range(offs, offs + size):
            row = rows_of[pos]
            c, rlen = cdf[row], lens[row]
            cum = st & K_DEC_MASK
            s = 1
            while s < rlen and c[s] <= cum:
                s += 1
            s -= 1
            lo, hi = c[s], c[s + 1]
            st = _u32(_u32(hi - lo) * (st >> K_SCALE_BITS) + cum - lo)
            for _ in range(MAX_PULLS):
                if st >= K_RANS_L:
                    break
                st = _u32(st << 8) | pull()
            value = s
            max_value = rlen - 2
            if value == max_value:
                val = get_bits()
                n_bypass = val
                for _ in range(MAX_BYPASS_CHUNKS):
                    if val != K_MAX_BYPASS:
                        break
                    val = get_bits()
                    n_bypass += val
                raw = 0
                for k in range(min(n_bypass, MAX_BYPASS_CHUNKS)):
                    raw |= get_bits() << (k * K_BYPASS_BITS)
                value = _i32(raw + max_value)
            out[pos] = _c_zigzag_int8(value)
        st_all[lane], ptr_all[lane] = st, ptr
    new_state = {"streams": streams,
                 "st": torch.tensor([_i32(s) for s in st_all],
                                    dtype=torch.int32, device=dev),
                 "ptr": torch.tensor(ptr_all, dtype=torch.int32, device=dev)}
    return new_state, torch.tensor(out, dtype=torch.int8, device=dev)


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (at first use) and bind the CUDA kernel's C entry point."""
    fn = load_library("rans_decode.cu").dcvc_rans_decode
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _operands(state, idx, count, bank):
    """Checks shared by both paths; returns the tensors of the call."""
    tensors = {"streams": state["streams"], "st": state["st"],
               "ptr": state["ptr"], "idx": idx, "cdf": bank["cdf"],
               "len": bank["len"]}
    if isinstance(count, torch.Tensor):
        tensors["count"] = count
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"rans_decode: every tensor must be on one device, "
                         f"got {sorted(map(str, devices))}")
    want = {"streams": torch.uint8, "st": torch.int32, "ptr": torch.int32,
            "idx": torch.uint8, "cdf": torch.int32, "len": torch.int32,
            "count": torch.int32}
    for name, t in tensors.items():
        if t.dtype != want[name]:
            raise ValueError(f"rans_decode: {name} must be {want[name]}, "
                             f"got {t.dtype}")
    n = tensors["streams"].shape[0]
    if tensors["streams"].dim() != 2 or not 1 <= n <= MAX_LANES:
        raise ValueError(f"rans_decode: streams must be (n, L) with 1 <= n "
                         f"<= {MAX_LANES}, got {tuple(state['streams'].shape)}")
    if tensors["st"].shape != (n,) or tensors["ptr"].shape != (n,):
        raise ValueError(f"rans_decode: st and ptr must be ({n},)")
    if idx.dim() != 1:
        raise ValueError(f"rans_decode: idx must be 1-D, got "
                         f"{tuple(idx.shape)}")
    rows, per = bank["cdf"].shape
    if bank["len"].shape != (rows,) or not 2 <= per <= 32:
        raise ValueError(f"rans_decode: bank must be (R, per <= 32) CDFs and "
                         f"(R,) lengths, got {tuple(bank['cdf'].shape)} and "
                         f"{tuple(bank['len'].shape)}")
    if "count" in tensors and count.dim() != 0:
        raise ValueError("rans_decode: count must be a 0-dim tensor")
    return tensors


def rans_decode_launch(state, idx, count, bank):
    """Launch the CUDA kernel (every tensor on the card).  Counts the launch
    in rans_decode.launches."""
    t = _operands(state, idx, count, bank)
    dev = t["idx"].device
    if dev.type != "cuda":
        raise ValueError(f"rans_decode: the kernel runs on a CUDA device, "
                         f"got {dev}")
    rows, per = t["cdf"].shape
    if rows * (per + 1) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"rans_decode: {rows} CDF rows of {per} do not fit "
                         f"in {MAX_SMEM_BYTES} bytes of shared memory")
    for name in ("streams", "st", "ptr", "idx", "cdf", "len"):
        if not t[name].is_contiguous():
            raise ValueError(f"rans_decode: {name} must be contiguous")
    n, lane_len = t["streams"].shape
    cap = t["idx"].shape[0]
    st = torch.empty_like(t["st"])
    ptr = torch.empty_like(t["ptr"])
    out = torch.empty((cap,), dtype=torch.int8, device=dev)
    zero_blocks = min(64, -(-cap // (THREADS * 16))) if cap else 0
    count_t = t.get("count")
    err = load_kernel()(
        t["streams"].data_ptr(), lane_len, n, t["cdf"].data_ptr(),
        t["len"].data_ptr(), rows, per, t["idx"].data_ptr(), cap,
        None if count_t is None else count_t.data_ptr(),
        0 if count_t is not None else int(count),
        t["st"].data_ptr(), t["ptr"].data_ptr(), st.data_ptr(),
        ptr.data_ptr(), out.data_ptr(), zero_blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rans_decode: kernel launch failed with CUDA "
                           f"error {err} (lanes={n} L={lane_len} cap={cap} "
                           f"rows={rows} per={per})")
    rans_decode.launches += 1
    return {"streams": t["streams"], "st": st, "ptr": ptr}, out


def rans_decode(state, idx, count, bank):
    """Decode one call: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  Returns (state, out)."""
    t = _operands(state, idx, count, bank)
    if t["idx"].device.type == "cpu":
        return rans_decode_reference(state, idx, count, bank)
    return rans_decode_launch(state, idx, count, bank)


# kernel launches since the last reset (a plain integer; the main path's
# count is read by chip_smoke.py)
rans_decode.launches = 0
