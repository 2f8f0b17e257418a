"""K2, the on-device rANS decoder: the hand-written Hopper kernel
(csrc/rans_decode.cu, replacing dcvc_tpu/rans/pallas_decode.py::
_decode_kernel), its plain version, and a plain model of the kernel's
algorithm.

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
  - bank: `make_bank`'s dict, every entry indexed by row (so a slice of
    rows is a bank): "cdf" (R, per) int32, "len" (R,) int32, and the
    kernel's search tables "bucket" (R, 256) uint8 and "sym" (R, P, 4)
    int32 (see make_bank);
  - out: (cap,) int8, the symbols in [0, count), zeros after.

The wrapper launches the kernel when every tensor is on the card and takes
the plain version (rans_decode_reference, rans.cc's loop) when every
tensor is on the CPU; mixed devices, more than 8 lanes or another dtype
raise.  On the card it never falls back.  The kernel is built with nvcc
at its first launch (kernels/_build.py).  rans_decode_kernel_model runs
the kernel's own algorithm (bucket search, byte window, closed-form
escapes, the escape-free and full group bodies and the switch between
them) in Python, so that the CPU tests hold it against the host decoder;
nothing on the main path calls it.
"""

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import spanned
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
# the search tables of one call sit in shared memory (R * (256 + 16 P)
# bytes); an H100 block may have 227 KB
MAX_SMEM_BYTES = 227 * 1024
THREADS = 256
# the bucket table: one entry per row and value of the top BUCKET_BITS of
# cum (16 bits), the first symbol whose interval reaches into the bucket
BUCKET_BITS = 8
# the fix-up bounds the kernel is built for (the template instances of
# csrc/rans_decode.cu's entry): a bank's largest spread, rounded up to one
# of them
FIXUPS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)
# symbols of an aligned group (one idx load and one out store), and the
# full-body groups in a row without an escape after which a lane returns
# to the escape-free body (csrc/rans_decode.cu, kGroup and kCleanRun)
GROUP = 16
CLEAN_RUN = 4
# a start no cum reaches: the "sym" entries past a row's length
NO_START = 0x7FFFFFFF


def _linear_search(cdf, lengths, cum):
    """rans.cc's inverse CDF (the count of 1 <= s < len with cdf[s] <= cum;
    the rows increase) for every row of (R, per) `cdf` at each value of the
    1-D tensor `cum`: (R, cum.numel()) int64."""
    cdf = torch.as_tensor(cdf, dtype=torch.int64)
    lengths = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1, 1)
    s = torch.zeros((cdf.shape[0], cum.numel()), dtype=torch.int64)
    for k in range(1, cdf.shape[1]):
        s += (cdf[:, k:k + 1] <= cum) & (k < lengths)
    return s


def make_bank(cdf, lengths, device):
    """A CDF bank (numpy (R, per) int32 and (R,) int32, as the host coder's
    set_cdf takes it) as K2's device tensors, with the kernel's search
    tables, made once per codec:
      - "bucket" (R, 256) uint8: for each row and bucket b (cum >> 8), the
        symbol T(b) that the inverse CDF gives at the bucket's first cum;
      - "sym" (R, P, 4) int32: per row and symbol s, {cdf[s], cdf[s + 1] -
        cdf[s] (the kernel's uint32 product operand; 0 past the row as
        the parent kernel read it), s | (s == len - 2) << 8 (the escape
        symbol), 0}; entries s >= len start at NO_START, which no cum
        reaches.  P = per + F, F (the fix-up bound) the largest number of
        symbols that start inside one bucket after T(b), over the rows,
        rounded up to one of FIXUPS: the kernel compares cum with the
        starts of T(b) + 1 .. T(b) + F and takes the last one reached."""
    cdf = np.asarray(cdf, np.int64)
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    rows, per = cdf.shape
    first = torch.arange(1 << BUCKET_BITS) << (K_SCALE_BITS - BUCKET_BITS)
    lo = _linear_search(cdf, lengths, first)
    hi = _linear_search(cdf, lengths, first + (first[1] - 1))
    spread = int((hi - lo).max()) if rows else 0
    fix = next((f for f in FIXUPS if f >= spread), None)
    if fix is None:
        raise ValueError(f"make_bank: {spread} symbols start inside one "
                         f"bucket of 1/{1 << BUCKET_BITS} (at most "
                         f"{FIXUPS[-1]})")
    nxt = np.concatenate([cdf[:, 1:], np.zeros((rows, 1), np.int64)], 1)
    s = np.arange(per + fix)[None, :]
    inside = s < lengths[:, None]
    pad = np.zeros((rows, fix), np.int64)
    sym = np.stack([
        np.where(inside, np.concatenate([cdf, pad], 1), NO_START),
        np.where(inside, np.concatenate([nxt - cdf, pad], 1), 0),
        np.where(inside, s | ((s == lengths[:, None] - 2) << 8), 0),
        np.zeros((rows, per + fix), np.int64)], -1)
    return {"cdf": torch.as_tensor(cdf, dtype=torch.int32).contiguous()
            .to(device),
            "len": torch.as_tensor(lengths, dtype=torch.int32).contiguous()
            .to(device),
            "bucket": lo.to(torch.uint8).contiguous().to(device),
            "sym": torch.as_tensor(sym.astype(np.uint32).view(np.int32))
            .contiguous().to(device)}


def fixup_bound(bank):
    """The bank's fix-up bound F (P - per)."""
    return bank["sym"].shape[1] - bank["cdf"].shape[1]


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


def escape_fast(st, win):
    """The kernel's closed-form escape (csrc/rans_decode.cu, escape_fast):
    st >= 2^23 after the renorm, win the lane's next 4 bytes as a
    little-endian uint32.  The first 16 chunks are Y = the low 2j bits of
    st | win << 2j; the count prefix (a run of 3s, then a chunk < 3,
    summed) is found by one lowest-set-bit of the chunks that are not 3,
    the raw value is the next n_bypass chunks of Y, and after k chunks the
    state is st >> 2k (k < j) or ((st >> 2j) << 8 | byte (k - j) / 4) >>
    2((k - j) % 4): the state's top bits stay parked while each new byte
    feeds 4 chunks, low bits first.  Returns (raw, st, bytes taken), or None
    when the escape needs more than 16 chunks (the kernel then takes the
    chunk-by-chunk path)."""
    j2 = (st.bit_length() - 22) & ~1           # 2j
    y = (st & ((1 << j2) - 1)) | ((win << j2) & 0xFFFFFFFF)
    not3 = ~(y & (y >> 1)) & 0x55555555        # bit 2i: chunk i != 3
    if not3 == 0:
        return None
    c2 = (not3 & -not3).bit_length() - 1       # 2 x the run of 3s
    n_bypass = min(3 * (c2 >> 1) + ((y >> c2) & 3), MAX_BYPASS_CHUNKS)
    k = (c2 >> 1) + 1 + n_bypass               # chunks of the escape
    if k > 16:
        return None
    raw = (y >> (c2 + 2)) & ((1 << (2 * n_bypass)) - 1)
    if 2 * k < j2:
        return raw, st >> (2 * k), 0
    m = k - (j2 >> 1)
    byte = (win >> (8 * (m >> 2))) & 0xFF
    return raw, (((st >> j2) << 8) | byte) >> (2 * (m & 3)), (m >> 2) + 1


def rans_decode_kernel_model(state, idx, count, bank, groups=None):
    """A plain model of the kernel's algorithm (same arguments and results
    as rans_decode_reference), for the CPU tests only: the inverse CDF by
    the bucket table and its fix-up over the "sym" entries, the renorm as
    one shift of the state and the lane's next bytes (a byte window) by
    8 x the pulls its value asks for, the bypass escape in closed form
    (escape_fast), and the kernel's schedule: a lane's unaligned head and
    tail one symbol at a time, and between them aligned groups of GROUP
    symbols, each by the escape-free body or the full body (the switch
    rule of csrc/rans_decode.cu, CLEAN_RUN); an escape-free group that
    meets an escape or a state of 0 is decoded again by the full body,
    and a full-body group that meets a state of 0 or an escape of more
    than 16 chunks one symbol at a time, taking rans.cc's loops for that
    symbol, both from the lane as it was at the group's start.

    groups: a list, to which each lane's group counts are appended as the
    counting build's fields (free_groups, redone_groups, full_groups): the
    groups kept from the escape-free body, those it redid, and those run
    on the full body."""
    dev = idx.device
    streams = state["streams"]
    n, lane_len = streams.shape
    data = streams.cpu().contiguous().numpy().tobytes()
    bucket = bank["bucket"].cpu().tolist()
    sym = bank["sym"].cpu().tolist()
    fix = fixup_bound(bank)
    rows = len(bucket)
    rows_of = [min(r, rows - 1) for r in idx.cpu().tolist()]
    cap = len(rows_of)
    count = min(max(int(count), 0), cap)
    st_all = [_u32(v) for v in state["st"].cpu().tolist()]
    ptr_all = state["ptr"].cpu().tolist()
    out = [0] * cap
    size0 = count // n
    for lane in range(n):
        lane_bytes = data[lane * lane_len:(lane + 1) * lane_len]

        def byte(at):
            return lane_bytes[at] if 0 <= at < lane_len else 0

        def entry(row, cum):
            """The bucket search: the {start, freq, s | escape << 8}
            entry of the symbol whose interval holds cum."""
            t = bucket[row][cum >> (K_SCALE_BITS - BUCKET_BITS)]
            cand = sym[row][t:t + fix + 1]
            return cand[sum(c[0] <= cum for c in cand[1:])][:3]

        def body(st, ptr, group_rows, escapes):
            """One run of steps (csrc/rans_decode.cu, step_fast) over the
            rows, by the full body (escapes) or the escape-free one:
            (st, ptr, symbols, slow, esc).  At the first symbol that sets
            slow the rest is dropped, as the kernel drops it."""
            vals, esc = [], False
            for row in group_rows:
                cum = st & K_DEC_MASK
                start, freq, meta = entry(row, cum)
                x = _u32(_u32(freq) * (st >> K_SCALE_BITS) + cum - start)
                escape = meta >> 8
                if x == 0 or (escape and not escapes):
                    return st, ptr, vals, True, esc
                # the pulls a state >= 1 needs, from its value alone
                pulls = (x < K_RANS_L) + (x < 1 << 15) + (x < 1 << 7)
                st = x
                for _ in range(pulls):
                    st = _u32(st << 8) | byte(ptr)
                    ptr += 1
                value = meta & 0xFF
                if escape:
                    fast = escape_fast(st, sum(byte(ptr + i) << (8 * i)
                                               for i in range(4)))
                    if fast is None:
                        return st, ptr, vals, True, True
                    raw, st, taken = fast
                    ptr += taken
                    value = _i32(raw + value)
                    esc = True
                vals.append(_c_zigzag_int8(value))
            return st, ptr, vals, False, esc

        def slow_symbol(st, ptr, row):
            """rans.cc's loops for one symbol (the kernel's slow_path)."""
            def get_bits():
                nonlocal st, ptr
                val = st & K_MAX_BYPASS
                st >>= K_BYPASS_BITS
                if st < K_RANS_L:
                    st = _u32(st << 8) | byte(ptr)
                    ptr += 1
                return val

            cum = st & K_DEC_MASK
            start, freq, meta = entry(row, cum)
            st = _u32(_u32(freq) * (st >> K_SCALE_BITS) + cum - start)
            for _ in range(MAX_PULLS):
                if st >= K_RANS_L:
                    break
                st = _u32(st << 8) | byte(ptr)
                ptr += 1
            value = meta & 0xFF
            if meta >> 8:
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
                value = _i32(raw + value)
            return st, ptr, _c_zigzag_int8(value)

        def serial(st, ptr, a, b):
            """Symbols [a, b) one at a time (the kernel's serial)."""
            for pos in range(a, b):
                row = rows_of[pos]
                st1, ptr1, vals, slow, _ = body(st, ptr, [row], True)
                if slow:
                    st, ptr, out[pos] = slow_symbol(st, ptr, row)
                else:
                    st, ptr, out[pos] = st1, ptr1, vals[0]
            return st, ptr

        offs = size0 * lane
        end = offs + (count - size0 * (n - 1) if lane == n - 1 else size0)
        st, ptr = st_all[lane], ptr_all[lane]
        pos = min(end, (offs + GROUP - 1) // GROUP * GROUP)
        st, ptr = serial(st, ptr, offs, pos)
        escape_free, clean = True, 0
        free_groups = redone = full = 0
        while pos + GROUP <= end:
            group_rows = rows_of[pos:pos + GROUP]
            slow = False
            if escape_free:
                st1, ptr1, vals, slow, _ = body(st, ptr, group_rows, False)
                redone += slow
                free_groups += not slow
            if not escape_free or slow:
                st1, ptr1, vals, slow, esc = body(st, ptr, group_rows, True)
                full += 1
                clean = 0 if esc or slow else clean + 1
                escape_free = clean >= CLEAN_RUN
            if slow:
                st, ptr = serial(st, ptr, pos, pos + GROUP)
            else:
                st, ptr = st1, ptr1
                out[pos:pos + GROUP] = vals
            pos += GROUP
        st, ptr = serial(st, ptr, pos, end)
        st_all[lane], ptr_all[lane] = st, ptr
        if groups is not None:
            groups.append((free_groups, redone, full))
    new_state = {"streams": streams,
                 "st": torch.tensor([_i32(v) for v in st_all],
                                    dtype=torch.int32, device=dev),
                 "ptr": torch.tensor(ptr_all, dtype=torch.int32, device=dev)}
    return new_state, torch.tensor(out, dtype=torch.int8, device=dev)


# the fields of one lane in the cycle-counting build's output (csrc/
# rans_decode.cu, kClk*): clock64() cycles of the row fetch and CDF
# search, the state update and renorm, the escape path and the output
# store; the lane's whole loop; %globaltimer ns over it; symbols; escapes;
# aligned groups kept from the escape-free body, redone after it, and run
# on the full body
CLOCK_FIELDS = ("search", "update", "escape", "store", "total", "ns",
                "symbols", "escapes", "free_groups", "redone_groups",
                "full_groups")


@functools.lru_cache(maxsize=None)
def load_kernel(clocks=False):
    """Build (at first use) and bind the CUDA kernel's C entry point;
    clocks=True: the cycle-counting build (-DK2_CLOCKS, a separate
    library; the entry's clocks argument is its output)."""
    lib = load_library("rans_decode.cu", ("K2_CLOCKS",) if clocks else ())
    fn = lib.dcvc_rans_decode
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _operands(state, idx, count, bank):
    """Checks shared by both paths; returns the tensors of the call."""
    missing = {"cdf", "len", "bucket", "sym"} - set(bank)
    if missing:
        raise ValueError(f"rans_decode: the bank lacks {sorted(missing)} "
                         f"(make_bank makes them)")
    tensors = {"streams": state["streams"], "st": state["st"],
               "ptr": state["ptr"], "idx": idx, "cdf": bank["cdf"],
               "len": bank["len"], "bucket": bank["bucket"],
               "sym": bank["sym"]}
    if isinstance(count, torch.Tensor):
        tensors["count"] = count
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"rans_decode: every tensor must be on one device, "
                         f"got {sorted(map(str, devices))}")
    want = {"streams": torch.uint8, "st": torch.int32, "ptr": torch.int32,
            "idx": torch.uint8, "cdf": torch.int32, "len": torch.int32,
            "bucket": torch.uint8, "sym": torch.int32, "count": torch.int32}
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
    if bank["bucket"].shape != (rows, 1 << BUCKET_BITS) or \
            bank["sym"].dim() != 3 or bank["sym"].shape[0] != rows or \
            bank["sym"].shape[2] != 4 or fixup_bound(bank) not in FIXUPS:
        raise ValueError(f"rans_decode: the bank's search tables must be "
                         f"({rows}, {1 << BUCKET_BITS}) and ({rows}, per + F, "
                         f"4), F in {FIXUPS} (make_bank), got "
                         f"{tuple(bank['bucket'].shape)} and "
                         f"{tuple(bank['sym'].shape)}")
    if "count" in tensors and count.dim() != 0:
        raise ValueError("rans_decode: count must be a 0-dim tensor")
    return tensors


@spanned("k2.launch")
def rans_decode_launch(state, idx, count, bank):
    """Launch the CUDA kernel (every tensor on the card).  Counts the launch
    in rans_decode.launches."""
    new_state, out = _launch(state, idx, count, bank)
    rans_decode.launches += 1
    return new_state, out


def rans_decode_clocks(state, idx, count, bank):
    """The cycle-counting build of the kernel on one call (a measurement,
    not counted in rans_decode.launches): (state, out, clocks), clocks an
    (n, len(CLOCK_FIELDS)) int64 tensor on the card."""
    n = state["streams"].shape[0]
    clocks = torch.zeros((n, len(CLOCK_FIELDS)), dtype=torch.int64,
                         device=idx.device)
    new_state, out = _launch(state, idx, count, bank, clocks)
    return new_state, out, clocks


def _aligned(t, multiple=1):
    """t, or a zero-padded copy, with a 16-byte aligned start and a last
    dimension a multiple of `multiple` (the kernel's 16-byte loads)."""
    pad = -t.shape[-1] % multiple
    if pad or t.data_ptr() % 16:
        t = torch.nn.functional.pad(t, (0, pad))
    return t


def _launch(state, idx, count, bank, clocks=None):
    t = _operands(state, idx, count, bank)
    dev = t["idx"].device
    if dev.type != "cuda":
        raise ValueError(f"rans_decode: the kernel runs on a CUDA device, "
                         f"got {dev}")
    rows, per = t["cdf"].shape
    sym_per = t["sym"].shape[1]
    smem = rows * (16 * sym_per + (1 << BUCKET_BITS))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rans_decode: the search tables of {rows} rows "
                         f"({smem} bytes) do not fit in {MAX_SMEM_BYTES} "
                         f"bytes of shared memory")
    for name in ("streams", "st", "ptr", "idx", "bucket", "sym"):
        if not t[name].is_contiguous():
            raise ValueError(f"rans_decode: {name} must be contiguous")
    for name in ("bucket", "sym"):
        if t[name].data_ptr() % 16:
            raise ValueError(f"rans_decode: {name} must start 16-byte "
                             f"aligned")
    # upload_lanes pads the lanes to 16 bytes: no copy on the main path
    streams = _aligned(t["streams"], 16)
    idx = _aligned(t["idx"])
    n, lane_len = streams.shape
    cap = idx.shape[0]
    st = torch.empty_like(t["st"])
    ptr = torch.empty_like(t["ptr"])
    out = torch.empty((cap,), dtype=torch.int8, device=dev)
    zero_blocks = min(64, -(-cap // (THREADS * 16))) if cap else 0
    count_t = t.get("count")
    err = load_kernel(clocks is not None)(
        streams.data_ptr(), lane_len, n, t["sym"].data_ptr(),
        t["bucket"].data_ptr(), rows, sym_per, sym_per - per,
        idx.data_ptr(), cap,
        None if count_t is None else count_t.data_ptr(),
        0 if count_t is not None else int(count),
        t["st"].data_ptr(), t["ptr"].data_ptr(), st.data_ptr(),
        ptr.data_ptr(), out.data_ptr(), zero_blocks,
        None if clocks is None else clocks.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rans_decode: kernel launch failed with CUDA "
                           f"error {err} (lanes={n} L={lane_len} cap={cap} "
                           f"rows={rows} per={per} F={sym_per - per})")
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
