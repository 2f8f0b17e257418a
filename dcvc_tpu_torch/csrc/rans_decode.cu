// K2: rANS decode on the card, bit-exact with the host coder.
//
// Replaces dcvc_tpu/rans/pallas_decode.py::_decode_kernel (the Pallas TPU
// kernel built by make_decode_fn_pallas).  It computes what rans.cc
// dec_symbol / dec_get_bits compute (dcvc_tpu/rans/rans.cc:124-161) with
// the lane split of decode_y / decode_z (:612-659):
//   - lane i of n decodes the contiguous block [size0 * i, size0 * i +
//     size_i) of the packed symbols, size0 = count / n, the last lane
//     taking the remainder (all of them when count < n);
//   - per symbol: the CDF row idx[pos], the inverse CDF (first s >= 1 with
//     cdf[s] > cum, minus 1), the uint32 state update, byte pulls while
//     the state is below 2^23, 2-bit bypass escapes when s == max_value
//     (rlen - 2), zig-zag to int8;
//   - the state (st, ptr) of every lane comes in and goes out in device
//     tensors, so one frame's calls (z, then each y rung) thread it on the
//     card; count is read from device memory and the host never sees it.
// Bytes past a lane's end read as 0 (the zero padding split_streams
// gives); nothing is read out of bounds.
//
// What bounds it: latency.  Each lane is one dependent chain (a symbol's
// state is the next one's input), at most 8 chains, so the card's width
// is idle; the time is the longest lane's symbol count times the
// dependent latency of one symbol step.  The design shortens the step:
// one warp per lane, the whole row of the CDF (<= 32 entries) compared
// at once by the warp's 32 threads and reduced with one ballot instead of
// a sequential search, cdf[s] and cdf[s + 1] fetched with shuffles, the
// rows of the call staged in shared memory, and the next symbol's row
// index loaded before the current symbol's state update (it does not
// depend on the state).  The 32 threads of a warp hold the same state and
// take the same branches, so escapes do not diverge.
//
// The Mosaic workarounds of the TPU kernel are not carried over: no LE
// word packing of the streams, no padding of the lane dimension to 128,
// no idx pre-gather or out post-gather (the kernel reads idx[pos] and
// writes out[pos] directly), no power-of-two length buckets.
//
// Launch: blocks of 256 threads.  Block 0 decodes (warp i is lane i; the
// warps past n_lanes only help stage the CDF rows); blocks 1.. zero
// out[count, cap) in the same launch, so the output is complete without a
// separate memset.  No atomics: every output byte has one writer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kScaleBits = 16;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kDecMask = (1u << kScaleBits) - 1;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kMaxBypassVal = (1u << kBypassBits) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// A valid state is >= 128 after the advance, so it needs at most two
// pulls; the bound only keeps a corrupt stream from looping forever.
constexpr int kMaxPulls = 4;
// Bypass chunks of a 32-bit raw value (a valid int8 escape needs <= 4).
constexpr int kMaxBypassChunks = 16;

struct LaneState {
  const uint8_t* bytes;
  int len;
  uint32_t st;
  int ptr;

  __device__ __forceinline__ uint32_t pull() {
    const uint32_t b = (ptr >= 0 && ptr < len) ? __ldg(bytes + ptr) : 0u;
    ++ptr;
    return b;
  }

  // rans.cc dec_get_bits
  __device__ __forceinline__ uint32_t get_bits() {
    const uint32_t val = st & kMaxBypassVal;
    st >>= kBypassBits;
    if (st < kRansL) st = (st << 8) | pull();
    return val;
  }
};

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint8_t* __restrict__ streams, int lane_len,
                   int n_lanes, const int32_t* __restrict__ cdf,
                   const int32_t* __restrict__ lengths, int rows, int per,
                   const uint8_t* __restrict__ idx, int cap,
                   const int32_t* __restrict__ count_ptr, int count_host,
                   const int32_t* __restrict__ st_in,
                   const int32_t* __restrict__ ptr_in,
                   int32_t* __restrict__ st_out, int32_t* __restrict__ ptr_out,
                   int8_t* __restrict__ out) {
  int count = count_ptr != nullptr ? *count_ptr : count_host;
  count = count < 0 ? 0 : (count > cap ? cap : count);

  if (blockIdx.x > 0) {  // zero the output past count
    const int stride = (gridDim.x - 1) * blockDim.x;
    for (int i = count + (blockIdx.x - 1) * blockDim.x + threadIdx.x;
         i < cap; i += stride)
      out[i] = 0;
    return;
  }

  extern __shared__ int32_t smem[];
  int32_t* s_cdf = smem;                 // rows * per
  int32_t* s_len = smem + rows * per;    // rows
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) s_cdf[i] = cdf[i];
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s_len[i] = lengths[i];
  __syncthreads();

  const int lane = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  if (lane >= n_lanes) return;

  const int size0 = count / n_lanes;
  const int offs = size0 * lane;
  const int size = lane == n_lanes - 1 ? count - size0 * (n_lanes - 1) : size0;
  LaneState ls{streams + static_cast<size_t>(lane) * lane_len, lane_len,
               static_cast<uint32_t>(st_in[lane]), ptr_in[lane]};

  auto row_of = [&](int pos) {
    const int r = __ldg(idx + pos);
    return r < rows ? r : rows - 1;
  };
  int next_row = size > 0 ? row_of(offs) : 0;
  for (int j = 0; j < size; ++j) {
    const int row = next_row;
    if (j + 1 < size) next_row = row_of(offs + j + 1);
    const int rlen = s_len[row];
    const int32_t c = t < per ? s_cdf[row * per + t] : 0;
    const int32_t cum = static_cast<int32_t>(ls.st & kDecMask);
    // inverse CDF: the count of entries 1 <= s < rlen with cdf[s] <= cum
    // is the first s >= 1 with cdf[s] > cum, minus 1 (the CDF increases)
    const unsigned le = __ballot_sync(kFull, t >= 1 && t < rlen && c <= cum);
    const int s = __popc(le);
    const int32_t lo = __shfl_sync(kFull, c, s);
    const int32_t hi = __shfl_sync(kFull, c, s + 1);
    ls.st = static_cast<uint32_t>(hi - lo) * (ls.st >> kScaleBits)
        + (ls.st & kDecMask) - static_cast<uint32_t>(lo);
    for (int k = 0; k < kMaxPulls && ls.st < kRansL; ++k)
      ls.st = (ls.st << 8) | ls.pull();

    int32_t value = s;
    const int max_value = rlen - 2;
    if (value == max_value) {
      uint32_t val = ls.get_bits();
      int32_t n_bypass = static_cast<int32_t>(val);
      for (int k = 0; k < kMaxBypassChunks && val == kMaxBypassVal; ++k) {
        val = ls.get_bits();
        n_bypass += static_cast<int32_t>(val);
      }
      if (n_bypass > kMaxBypassChunks) n_bypass = kMaxBypassChunks;
      uint32_t raw = 0;
      for (int k = 0; k < n_bypass; ++k)
        raw |= ls.get_bits() << (k * kBypassBits);
      value = static_cast<int32_t>(raw) + max_value;
    }
    if (t == 0)
      out[offs + j] = static_cast<int8_t>(
          (value % 2 == 1) ? (value + 1) / 2 : -(value + 1) / 2);
  }
  if (t == 0) {
    st_out[lane] = static_cast<int32_t>(ls.st);
    ptr_out[lane] = ls.ptr;
  }
}

}  // namespace

extern "C" int dcvc_rans_decode(const void* streams, int lane_len,
                                int n_lanes, const void* cdf,
                                const void* lengths, int rows, int per,
                                const void* idx, int cap,
                                const void* count_ptr, int count_host,
                                const void* st_in, const void* ptr_in,
                                void* st_out, void* ptr_out, void* out,
                                int zero_blocks, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * (per + 1) * sizeof(int32_t);
  rans_decode_kernel<<<1 + zero_blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), lane_len, n_lanes,
      static_cast<const int32_t*>(cdf), static_cast<const int32_t*>(lengths),
      rows, per, static_cast<const uint8_t*>(idx), cap,
      static_cast<const int32_t*>(count_ptr), count_host,
      static_cast<const int32_t*>(st_in), static_cast<const int32_t*>(ptr_in),
      static_cast<int32_t*>(st_out), static_cast<int32_t*>(ptr_out),
      static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
