// K2: rANS decode on the card, bit-exact with the host coder.
//
// Replaces dcvc_tpu/rans/pallas_decode.py::_decode_kernel (the Pallas TPU
// kernel built by make_decode_fn_pallas).  It computes what rans.cc
// dec_symbol / dec_get_bits compute (dcvc_tpu/rans/rans.cc:124-161) with
// the lane split of decode_y / decode_z (:612-659):
//   - lane i of n decodes the contiguous block [size0 * i, size0 * i +
//     size_i) of the packed symbols, size0 = count / n, the last lane
//     taking the remainder (all of them when count < n);
//   - per symbol: the CDF row idx[pos] (clamped to the bank), the inverse
//     CDF (the count of 1 <= s < len with cdf[s] <= cum), the uint32 state
//     update, byte pulls while the state is below 2^23 (at most 4), 2-bit
//     bypass escapes when s == len - 2 (the count prefix of 3s capped at
//     16 more chunks, n_bypass capped at 16), zig-zag to int8;
//   - the state (st, ptr) of every lane comes in and goes out in device
//     tensors, so one frame's calls (z, then each y rung) thread it on the
//     card; count is read from device memory and the host never sees it.
// Bytes past a lane's end read as 0 (the zero padding split_streams
// gives); nothing is read out of bounds.
//
// What bounds it: latency.  Each lane is one dependent chain (a symbol's
// state is the next one's input), at most 8 chains, so the card's width
// is idle; the time is the longest lane's symbol count times the
// dependent latency of one symbol step.  The design takes everything it
// can off that chain:
//   - One chain per lane, in one thread, in a block of its own: no warp
//     collective, and lanes never share a warp or an SM's schedulers.  The
//     block's other threads only stage the bank into shared memory.
//   - The inverse CDF in O(1): make_bank's per-row bucket table gives, for
//     the top 8 bits of cum, the first candidate symbol T; the kernel loads
//     the F + 1 entries {start, freq, s | escape flag} of T .. T + F at
//     once (F: the bank's largest number of symbols starting inside one
//     bucket, a template argument) and takes the last one whose start
//     <= cum by a tree of selects (the starts increase).  Two dependent
//     shared-memory loads and no loop.
//   - Byte pulls off the chain: the lane's bytes come in aligned 16-byte
//     chunks, one chunk ahead of the two the 8-byte window is cut from, so
//     the refill load is issued ~16 bytes (~10 symbols) before it is read.
//     A renorm is one funnel shift of the state and the window's
//     byte-reversed head by 8 x the pulls, which a state >= 1 determines
//     by itself (state < 2^23, < 2^15, < 2^7).
//   - Bypass escapes in closed form.  After a renorm the state is >= 2^23;
//     with j the first j >= 1 with st >> 2j < 2^23, the escape's chunks are
//     the low 2j bits of st, then the next bytes low bits first, 4 chunks
//     a byte, while the state's top bits stay parked.  So the first 16
//     chunks are Y = low 2j bits of st | window << 2j; the run of 3s is one
//     find-first-set over the chunks that are not 3; raw is a shift and a
//     mask of Y; and after k chunks the state is st >> 2k (k < j) or
//     ((st >> 2j) << 8 | byte (k - j) / 4) >> 2((k - j) % 4), having taken
//     (k - j) / 4 + 1 bytes.  Escapes of more than 16 chunks (none in a
//     valid int8 stream) and a state of 0 after the advance (a corrupt
//     stream) take rans.cc's loops, then reload the window.
//   - No branch in the steady state: a lane decodes aligned groups of 16
//     symbols, each group one basic block of 16 steps that compute and
//     select (the window's refill too), in which the compiler can overlap
//     a symbol's independent work (the window, the next rows, the output)
//     with the chain.  The group's rows come in one 16-byte load issued a
//     group ahead, and its symbols go out in one 16-byte store (the
//     unaligned head and tail of a lane's block one at a time, by bytes).
//     A single thread issues in order, so the chain's latency is hidden
//     only by work scheduled beside it.
//   - Two bodies for a group, chosen by what the lane has seen, each in a
//     loop of its own.  The full body computes every symbol's escape in
//     closed form and selects it, so the escape's ~20 dependent
//     operations sit on every symbol's chain, escaped or not.  The
//     escape-free body takes the renormed state as the next one and ORs
//     each symbol's escape flag (the "sym" entry's) into the group's flag
//     beside x == 0; a group so flagged is not stored, and the lane goes
//     to the full body's loop, which decodes the group again from a copy
//     of the lane taken at its start.  That loop goes back to the
//     escape-free one after kCleanRun groups in a row without an escape
//     (the entries' escape words ORed into an integer, which leaves the
//     predicates to the chain).  So a stream without escapes (the
//     benchmark's y and z streams) never pays for them, and one dense in
//     escapes stays on the full body at the cost of a compare a group.
//     With both bodies under a branch in one loop the full body ran 2-4%
//     slower than alone on an H100; in a loop of its own it does not.
//   - A group that the full body cannot finish (a state of 0, an escape of
//     more than 16 chunks) is decoded again from its first symbol, one
//     symbol at a time, out of line (serial).
//   - Extra blocks zero out[count, cap) in the same launch.
// kernels/rans_decode.py::rans_decode_kernel_model is this algorithm in
// Python, held against the host decoder by the CPU tests.
//
// Built with -DK2_CLOCKS (kernels/_build.py, a separate library), the
// kernel also writes, per lane, the clock64() cycles of the search, the
// update and renorm, the escape, and the output store with the window's
// refill; the loop's cycles and %globaltimer ns; the symbols and escapes;
// the groups kept from the escape-free body, those it had to redo, and
// those run on the full body.  The production build carries none of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kScaleBits = 16;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kDecMask = (1u << kScaleBits) - 1;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kMaxBypassVal = (1u << kBypassBits) - 1;
constexpr int kThreads = 256;
// A valid state is >= 128 after the advance, so it needs at most two
// pulls; the bound only keeps a corrupt stream from looping forever.
constexpr int kMaxPulls = 4;
// Bypass chunks of a 32-bit raw value (a valid int8 escape needs <= 4).
constexpr int kMaxBypassChunks = 16;
constexpr int kBucketShift = 8;      // bucket = cum >> 8: 256 per row
constexpr int kBuckets = 1 << (kScaleBits - kBucketShift);
constexpr int kGroup = 16;           // symbols per idx load and out store
// full-body groups in a row without an escape after which a lane returns
// to the escape-free body
constexpr int kCleanRun = 4;

// the per-lane fields of the cycle-counting build (CLOCK_FIELDS in
// kernels/rans_decode.py)
enum { kClkSearch, kClkUpdate, kClkEscape, kClkStore, kClkTotal, kClkNs,
       kClkSymbols, kClkEscapes, kClkFreeGroups, kClkRedoneGroups,
       kClkFullGroups, kClkFields };

#ifdef K2_CLOCKS
__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
// a volatile store of v before the stamp: the stamp issues only once v
// is ready (a warp issues in order)
__shared__ uint32_t k2_sink;
struct Clocks {
  long long f[kClkFields] = {};
  long long last = 0;
  __device__ __forceinline__ void mark(int field, uint32_t v) {
    *static_cast<volatile uint32_t*>(&k2_sink) = v;
    const long long t = stamp();
    f[field] += t - last;
    last = t;
  }
};
#else
struct Clocks {
  __device__ __forceinline__ void mark(int, uint32_t) {}
};
#endif

// The lane's bytes as aligned 16-byte chunks: a and b hold the bytes
// [base, base + 32) the window is cut from (ptr - base < 16 at a symbol's
// start), c the next chunk, loaded when b became current.
struct Window {
  const uint4* chunks;
  int n_chunks;                      // lane length / 16
  int base;
  uint4 a, b, c;

  __device__ __forceinline__ uint4 load(int i) const {
    return (i >= 0 && i < n_chunks) ? __ldg(chunks + i)
                                    : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void reset(int ptr) {
    base = (ptr >> 4) << 4;
    a = load(base >> 4);
    b = load((base >> 4) + 1);
    c = load((base >> 4) + 2);
  }
  // the 8 bytes from ptr, little-endian, as (lo, hi)
  __device__ __forceinline__ void at(int ptr, uint32_t& lo,
                                     uint32_t& hi) const {
    const int o = ptr - base;
    const int q = o >> 2;
    const uint32_t x0 = q < 2 ? (q == 0 ? a.x : a.y) : (q == 2 ? a.z : a.w);
    const uint32_t x1 = q < 2 ? (q == 0 ? a.y : a.z) : (q == 2 ? a.w : b.x);
    const uint32_t x2 = q < 2 ? (q == 0 ? a.z : a.w) : (q == 2 ? b.x : b.y);
    lo = __funnelshift_r(x0, x1, (o & 3) * 8);
    hi = __funnelshift_r(x1, x2, (o & 3) * 8);
  }
  // after a symbol (which takes at most 7 bytes): the next chunk once ptr
  // has left a, by selects and a predicated load (no branch)
  __device__ __forceinline__ void advance(int ptr) {
    const bool step = ptr - base >= 16;
    const int i = (base >> 4) + 3;
    uint4 next = make_uint4(0, 0, 0, 0);
    if (step && i >= 0 && i < n_chunks) next = __ldg(chunks + i);
    a = step ? b : a;
    b = step ? c : b;
    c = step ? next : c;
    base += step ? 16 : 0;
  }
};

// What a lane carries from one symbol to the next.
struct Lane {
  uint32_t st;
  int ptr;
  Window win;
};

// rans.cc's loops, byte by byte: the renorm of a state of 0 and escapes
// of more than 16 chunks (neither occurs in a valid stream)
struct Bytes {
  const uint8_t* p;
  int len;
  __device__ uint32_t pull(int& ptr) const {
    const uint32_t v = (ptr >= 0 && ptr < len) ? __ldg(p + ptr) : 0u;
    ++ptr;
    return v;
  }
  __device__ uint32_t get_bits(uint32_t& st, int& ptr) const {
    const uint32_t val = st & kMaxBypassVal;
    st >>= kBypassBits;
    if (st < kRansL) st = (st << 8) | pull(ptr);
    return val;
  }
};

// Inlined: a call would take the addresses of st and ptr and keep them in
// local memory, a load and a store on the chain of every symbol.
__device__ __forceinline__ int32_t slow_path(uint32_t& st, int& ptr,
                                          Bytes bytes, bool renorm,
                                          bool escape, int32_t value) {
  if (renorm)
    for (int k = 0; k < kMaxPulls && st < kRansL; ++k)
      st = (st << 8) | bytes.pull(ptr);
  if (escape) {
    uint32_t val = bytes.get_bits(st, ptr);
    int32_t n_bypass = static_cast<int32_t>(val);
    for (int k = 0; k < kMaxBypassChunks && val == kMaxBypassVal; ++k) {
      val = bytes.get_bits(st, ptr);
      n_bypass += static_cast<int32_t>(val);
    }
    if (n_bypass > kMaxBypassChunks) n_bypass = kMaxBypassChunks;
    uint32_t raw = 0;
    for (int k = 0; k < n_bypass; ++k)
      raw |= bytes.get_bits(st, ptr) << (k * kBypassBits);
    value += static_cast<int32_t>(raw);
  }
  return value;
}

// The closed-form escape (see the head of the file).  st >= 2^23; w: the
// lane's next 4 bytes, little-endian.  False when it needs more than 16
// chunks.
__device__ __forceinline__ bool escape_fast(uint32_t st, uint32_t w,
                                            uint32_t& raw, uint32_t& st_out,
                                            int& taken) {
  // 2j, 2..10 (and 2, harmlessly, for a state below 2^23)
  const int j2 = 2 + 2 * ((st >= (1u << 25)) + (st >= (1u << 27)) +
                          (st >= (1u << 29)) + (st >= (1u << 31)));
  const uint32_t y = (st & ((1u << j2) - 1)) | (w << j2);
  const uint32_t not3 = ~(y & (y >> 1)) & 0x55555555u;  // bit 2i: chunk i != 3
  const int c2 = not3 ? __ffs(not3) - 1 : 0;            // 2 x the run of 3s
  const int n_bypass =
      min(3 * (c2 >> 1) + static_cast<int>((y >> c2) & 3), kMaxBypassChunks);
  const int k = (c2 >> 1) + 1 + n_bypass;               // chunks taken
  const uint32_t mask =
      n_bypass >= 16 ? ~0u : (1u << (2 * n_bypass)) - 1u;
  raw = __funnelshift_rc(y, 0u, c2 + 2) & mask;
  const int m = k - (j2 >> 1);
  const uint32_t byte = __byte_perm(w, 0u, 0x4440u | ((m >> 2) & 3));
  const uint32_t parked = ((st >> j2) << 8) | byte;
  const bool refilled = 2 * k >= j2;
  st_out = refilled ? parked >> (2 * (m & 3)) : st >> (2 * k);
  taken = refilled ? (m >> 2) + 1 : 0;
  return not3 != 0 && k <= 16;
}

// The monotone pick: of candidates Lo..Hi, the last k with p[k] (p[Lo]
// holds); a tree of selects ceil(log2(Hi - Lo + 1)) deep.
template <int Lo, int Hi>
__device__ __forceinline__ int4 pick(const int4* c, const bool* p) {
  if constexpr (Lo == Hi) {
    return c[Lo];
  } else {
    constexpr int Mid = (Lo + Hi + 1) / 2;
    const int4 up = pick<Mid, Hi>(c, p);
    const int4 down = pick<Lo, Mid - 1>(c, p);
    return p[Mid] ? up : down;
  }
}

// The inverse CDF: the entry {start, freq, s | escape << 8} of the symbol
// whose interval holds cum.
template <int F>
__device__ __forceinline__ int4 search(uint32_t cum,
                                       const uint8_t* __restrict__ bucket_row,
                                       const int4* __restrict__ sym_row) {
  const int t = bucket_row[cum >> kBucketShift];
  int4 c[F + 1];
  bool p[F + 1];
#pragma unroll
  for (int k = 0; k <= F; ++k) {
    c[k] = sym_row[t + k];
    p[k] = c[k].x <= static_cast<int32_t>(cum);
  }
  return pick<0, F>(c, p);
}

__device__ __forceinline__ int8_t zigzag(int32_t value) {
  return static_cast<int8_t>((value % 2 == 1) ? (value + 1) / 2
                                              : -(value + 1) / 2);
}

// One symbol without a branch, by the full body (Escapes) or the
// escape-free one.  The full body computes the renorm by the pulls a state
// >= 1 asks for and the escape in closed form, and selects; it sets `slow`
// when the symbol needs rans.cc's loops instead (a state of 0 after the
// advance, an escape of more than 16 chunks) and ORs the entry's word
// s | escape << 8 into `esc`.  The escape-free body takes the renormed
// state and sets `slow` at an escape too.  Once `slow` is set the lane's
// state is garbage and the caller decodes again from a copy.
template <int F, bool Escapes>
__device__ __forceinline__ int8_t step_fast(
    Lane& l, const uint8_t* __restrict__ bucket_row,
    const int4* __restrict__ sym_row, bool& slow, uint32_t& esc,
    Clocks& clk) {
  const uint32_t cum = l.st & kDecMask;
  const int4 e = search<F>(cum, bucket_row, sym_row);
  clk.mark(kClkSearch, e.x + e.y);
  const uint32_t x = static_cast<uint32_t>(e.y) * (l.st >> kScaleBits) +
                     cum - static_cast<uint32_t>(e.x);
  uint32_t lo, hi;
  l.win.at(l.ptr, lo, hi);
  const int sh = (x < kRansL ? 8 : 0) + (x < (1u << 15) ? 8 : 0) +
                 (x < (1u << 7) ? 8 : 0);
  const uint32_t st = __funnelshift_lc(__byte_perm(lo, 0u, 0x0123u), x, sh);
  const int ptr = l.ptr + (sh >> 3);
  clk.mark(kClkUpdate, st);
  const bool escape = (e.z >> 8) != 0;
  int32_t value = e.z & 0xff;
  if constexpr (Escapes) {
    uint32_t raw, st_e;
    int taken;
    const bool fits =
        escape_fast(st, __funnelshift_r(lo, hi, sh), raw, st_e, taken);
    slow |= x == 0 || (escape && !fits);
    esc |= static_cast<uint32_t>(e.z);
    l.st = escape ? st_e : st;
    l.ptr = ptr + (escape ? taken : 0);
    value += escape ? static_cast<int32_t>(raw) : 0;
    clk.mark(kClkEscape, l.st + value);
#ifdef K2_CLOCKS
    clk.f[kClkEscapes] += escape;
#endif
  } else {
    slow |= x == 0 || escape;
    l.st = st;
    l.ptr = ptr;
  }
  l.win.advance(l.ptr);
  return zigzag(value);
}

// One symbol, any stream: the fast step, or rans.cc's loops from the
// state before it (then the window is reloaded).
template <int F>
__device__ __forceinline__ int8_t step(Lane& l, Bytes bytes,
                                       const uint8_t* __restrict__ bucket_row,
                                       const int4* __restrict__ sym_row,
                                       Clocks& clk) {
  const Lane before = l;
  bool slow = false;
  uint32_t esc = 0;
  const int8_t v = step_fast<F, true>(l, bucket_row, sym_row, slow, esc, clk);
  if (!slow) return v;
  l = before;
  const uint32_t cum = l.st & kDecMask;
  const int4 e = search<F>(cum, bucket_row, sym_row);
  l.st = static_cast<uint32_t>(e.y) * (l.st >> kScaleBits) + cum -
         static_cast<uint32_t>(e.x);
  const int32_t value =
      slow_path(l.st, l.ptr, bytes, true, (e.z >> 8) != 0, e.z & 0xff);
  l.win.reset(l.ptr);
  return zigzag(value);
}

// Symbols [from, to) one at a time, each written as a byte: the unaligned
// head and the tail of a lane's block, and a group that met a slow symbol.
// Out of line, and the lane passed by value, so that the main loop keeps
// the lane in registers.
template <int F>
__device__ __noinline__ Lane serial(Lane l, Bytes bytes, int from, int to,
                                    const uint8_t* __restrict__ idx,
                                    int rows, int sym_per,
                                    const uint8_t* s_bucket, const int4* s_sym,
                                    int8_t* __restrict__ out, Clocks& clk) {
  for (int q = from; q < to; ++q) {
    int r = __ldg(idx + q);
    r = r < rows ? r : rows - 1;
    out[q] = step<F>(l, bytes, s_bucket + r * kBuckets, s_sym + r * sym_per,
                     clk);
    clk.mark(kClkStore, q);
  }
  return l;
}

// One aligned group of 16 symbols by one body (step_fast), one basic
// block: the rows packed in `in`, the symbols packed into `o`.
template <int F, bool Escapes>
__device__ __forceinline__ void group(Lane& l, const uint32_t (&in)[4],
                                      int rows, int sym_per,
                                      const uint8_t* s_bucket,
                                      const int4* s_sym, uint32_t (&o)[4],
                                      bool& slow, uint32_t& esc, Clocks& clk) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    int r = (in[j >> 2] >> (8 * (j & 3))) & 0xff;
    r = r < rows ? r : rows - 1;
    const int8_t v = step_fast<F, Escapes>(l, s_bucket + r * kBuckets,
                                           s_sym + r * sym_per, slow, esc,
                                           clk);
    o[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                 << (8 * (j & 3));
    clk.mark(kClkStore, o[j >> 2]);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint8_t* __restrict__ streams, int lane_len,
                   int n_lanes, const uint4* __restrict__ sym,
                   const uint4* __restrict__ bucket, int rows, int sym_per,
                   const uint8_t* __restrict__ idx, int cap,
                   const int32_t* __restrict__ count_ptr, int count_host,
                   const int32_t* __restrict__ st_in,
                   const int32_t* __restrict__ ptr_in,
                   int32_t* __restrict__ st_out, int32_t* __restrict__ ptr_out,
                   int8_t* __restrict__ out, long long* __restrict__ clocks) {
  int count = count_ptr != nullptr ? *count_ptr : count_host;
  count = count < 0 ? 0 : (count > cap ? cap : count);

  if (blockIdx.x >= n_lanes) {  // zero the output past count
    const int stride = (gridDim.x - n_lanes) * blockDim.x;
    for (int i = count + (blockIdx.x - n_lanes) * blockDim.x + threadIdx.x;
         i < cap; i += stride)
      out[i] = 0;
    return;
  }

  // the bank's search tables in shared memory: sym, then bucket
  extern __shared__ uint4 smem[];
  const int n_sym = rows * sym_per;                // 16-byte entries
  const int n_bucket = rows * kBuckets / 16;
  for (int i = threadIdx.x; i < n_sym; i += blockDim.x) smem[i] = sym[i];
  for (int i = threadIdx.x; i < n_bucket; i += blockDim.x)
    smem[n_sym + i] = bucket[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int4* s_sym = reinterpret_cast<const int4*>(smem);
  const uint8_t* s_bucket = reinterpret_cast<const uint8_t*>(smem + n_sym);

  const int lane = blockIdx.x;
  const int size0 = count / n_lanes;
  const int offs = size0 * lane;
  const int end =
      offs + (lane == n_lanes - 1 ? count - size0 * (n_lanes - 1) : size0);
  const uint8_t* lane_bytes = streams + static_cast<size_t>(lane) * lane_len;
  const Bytes bytes{lane_bytes, lane_len};
  Lane l;
  l.st = static_cast<uint32_t>(st_in[lane]);
  l.ptr = ptr_in[lane];
  l.win.chunks = reinterpret_cast<const uint4*>(lane_bytes);
  l.win.n_chunks = lane_len / 16;
  l.win.reset(l.ptr);
  Clocks clk;
#ifdef K2_CLOCKS
  const long long ns0 = global_ns();
  clk.last = stamp();
  const long long c_start = clk.last;
#endif

  // Aligned groups of 16 symbols: their rows in one 16-byte load issued a
  // group ahead, one body's 16 steps, the symbols out in one 16-byte
  // store.  An escape-free group that met an escape (or a state of 0) is
  // decoded again by the full body, and a full-body group that met a slow
  // symbol one symbol at a time; both from the lane as it was at the
  // group's first symbol (`first`).
  int pos = min(end, (offs + kGroup - 1) & ~(kGroup - 1));
  l = serial<F>(l, bytes, offs, pos, idx, rows, sym_per, s_bucket, s_sym,
                out, clk);
  if (pos + kGroup <= end) {
    uint4 rows_now = __ldg(reinterpret_cast<const uint4*>(idx + pos));
    Lane first = l;
    while (pos + kGroup <= end) {
      // the escape-free body, until a group meets an escape
      for (; pos + kGroup <= end; pos += kGroup) {
        const uint4 rows_next =
            pos + 2 * kGroup <= end
                ? __ldg(reinterpret_cast<const uint4*>(idx + pos + kGroup))
                : make_uint4(0, 0, 0, 0);
        const uint32_t in[4] = {rows_now.x, rows_now.y, rows_now.z,
                                rows_now.w};
        first = l;
        bool slow = false;
        uint32_t esc = 0;
        uint32_t o[4] = {0, 0, 0, 0};
        group<F, false>(l, in, rows, sym_per, s_bucket, s_sym, o, slow, esc,
                        clk);
#ifdef K2_CLOCKS
        ++clk.f[slow ? kClkRedoneGroups : kClkFreeGroups];
#endif
        if (slow) {
          l = first;
          break;
        }
        *reinterpret_cast<uint4*>(out + pos) =
            make_uint4(o[0], o[1], o[2], o[3]);
        rows_now = rows_next;
      }
      // the full body, from that group on, until kCleanRun groups in a row
      // without an escape
      for (int clean = 0; clean < kCleanRun && pos + kGroup <= end;
           pos += kGroup) {
        const uint4 rows_next =
            pos + 2 * kGroup <= end
                ? __ldg(reinterpret_cast<const uint4*>(idx + pos + kGroup))
                : make_uint4(0, 0, 0, 0);
        const uint32_t in[4] = {rows_now.x, rows_now.y, rows_now.z,
                                rows_now.w};
        first = l;
        bool slow = false;
        uint32_t esc = 0;
        uint32_t o[4] = {0, 0, 0, 0};
        group<F, true>(l, in, rows, sym_per, s_bucket, s_sym, o, slow, esc,
                       clk);
#ifdef K2_CLOCKS
        ++clk.f[kClkFullGroups];
#endif
        clean = (esc >> 8) != 0 || slow ? 0 : clean + 1;
        if (slow)
          l = serial<F>(first, bytes, pos, pos + kGroup, idx, rows, sym_per,
                        s_bucket, s_sym, out, clk);
        else
          *reinterpret_cast<uint4*>(out + pos) =
              make_uint4(o[0], o[1], o[2], o[3]);
        rows_now = rows_next;
      }
    }
  }
  l = serial<F>(l, bytes, pos, end, idx, rows, sym_per, s_bucket, s_sym, out,
                clk);
#ifdef K2_CLOCKS
  clk.f[kClkTotal] = stamp() - c_start;
  clk.f[kClkNs] = global_ns() - ns0;
  clk.f[kClkSymbols] = end - offs;
  for (int f = 0; f < kClkFields; ++f)
    clocks[lane * kClkFields + f] = clk.f[f];
#endif
  st_out[lane] = static_cast<int32_t>(l.st);
  ptr_out[lane] = l.ptr;
}

template <int F>
cudaError_t launch(const void* streams, int lane_len, int n_lanes,
                   const void* sym, const void* bucket, int rows, int sym_per,
                   const void* idx, int cap, const void* count_ptr,
                   int count_host, const void* st_in, const void* ptr_in,
                   void* st_out, void* ptr_out, void* out, int zero_blocks,
                   void* clocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * (sym_per * 16 + kBuckets);
  static size_t smem_set = 48 * 1024;  // the attribute, per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rans_decode_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  rans_decode_kernel<F><<<n_lanes + zero_blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(streams), lane_len, n_lanes,
      static_cast<const uint4*>(sym), static_cast<const uint4*>(bucket), rows,
      sym_per, static_cast<const uint8_t*>(idx), cap,
      static_cast<const int32_t*>(count_ptr), count_host,
      static_cast<const int32_t*>(st_in), static_cast<const int32_t*>(ptr_in),
      static_cast<int32_t*>(st_out), static_cast<int32_t*>(ptr_out),
      static_cast<int8_t*>(out), static_cast<long long*>(clocks));
  return cudaGetLastError();
}

}  // namespace

// fix: the bank's fix-up bound F (sym_per - per), one of 1..8, 16, 32
// (kernels/rans_decode.py FIXUPS); clocks: the cycle-counting build's
// output, (n_lanes, kClkFields) int64 (ignored by the production build).
extern "C" int dcvc_rans_decode(const void* streams, int lane_len,
                                int n_lanes, const void* sym,
                                const void* bucket, int rows, int sym_per,
                                int fix, const void* idx, int cap,
                                const void* count_ptr, int count_host,
                                const void* st_in, const void* ptr_in,
                                void* st_out, void* ptr_out, void* out,
                                int zero_blocks, void* clocks, void* stream) {
  if (n_lanes < 1 || n_lanes > 8 || lane_len % 16 != 0 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define K2_ARGS                                                            \
  streams, lane_len, n_lanes, sym, bucket, rows, sym_per, idx, cap,        \
      count_ptr, count_host, st_in, ptr_in, st_out, ptr_out, out,          \
      zero_blocks, clocks, s
  cudaError_t err;
  switch (fix) {
    case 1: err = launch<1>(K2_ARGS); break;
    case 2: err = launch<2>(K2_ARGS); break;
    case 3: err = launch<3>(K2_ARGS); break;
    case 4: err = launch<4>(K2_ARGS); break;
    case 5: err = launch<5>(K2_ARGS); break;
    case 6: err = launch<6>(K2_ARGS); break;
    case 7: err = launch<7>(K2_ARGS); break;
    case 8: err = launch<8>(K2_ARGS); break;
    case 16: err = launch<16>(K2_ARGS); break;
    case 32: err = launch<32>(K2_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K2_ARGS
  return static_cast<int>(err);
}
