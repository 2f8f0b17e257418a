// Fused DepthConvBlock for Hopper (sm_90a), bf16 in and out, f32 sums.
//
// Replaces the TPU kernel dcvc_tpu/kernels/fused_dcb.py::_dcb_kernel in
// both of its forms: one block (entry fused_dcb, S = 1) and S independent
// blocks with stacked weights (_fused_dcb_stacked via fused_dcb_stacked,
// the DMC-HTS/HTL recon heads).  Per block:
//
//   [adaptor 1x1] -> dc_in 1x1 -> WSiLU -> (zero outside the image)
//   -> depthwise 3x3 + bias -> dc_out 1x1 + residual (out1, f32)
//   -> FFN: 4 (C x I) products, each through WSiLU, summed (the
//      reference's 4-way chunk-add; the 4I-wide activation never exists)
//   -> ffn_out 1x1 + out1 [+ shortcut]
//
// What bounds it on the H100: arithmetic.  At C = I = 384 a block costs
// about 2 MFLOP per pixel (7 C x I products), against ~1.5 KB of
// activation traffic per pixel, far above the card's ~295 FLOP/byte
// balance point: the work belongs on the tensor cores at a tile size that
// reads the weights and activations from L2 as few times as it can.
//
// Design: a chain of launches that splits the block at the TPU kernel's
// own bf16 cast points (x after the adaptor, h after WSiLU and the mask,
// d after the dw bias, out1 rounded for the FFN, the FFN sum before
// ffn_out), so it computes the same function.  Each product is a GEMM on
// one Hopper core (hopper_gemm.cuh: TMA, wgmma, mbarrier ring) with a
// fused epilogue; the depthwise conv is a CUDA-core stencil.
//
//   launch   computes                                          kernel
//   adaptor  xa = bf16(x wa + ba)           (only with wa)     k1_adaptor
//   h        h = bf16(wsilu(xin w1 + b1)), each pixel once     k1_h
//   dw       d = bf16(sum_{dy,dx} h wd + bd), h = 0 outside    k1_dw
//   dc_out   out1 = (d w2 + b2) + xin (f32), out1c = bf16(out1) k1_dc_out
//   ffn_in   s = bf16(sum_j wsilu(out1c w3[j] + b3[j]))         k1_ffn_in
//   ffn_out  out = bf16((s w4 + b4) + out1 [+ xin])             k1_ffn_out
//
// xin is xa where the block has an adaptor, else x.  Weights are K-major
// (N, K), as a 1x1 conv stores them; ffn_in's are (4, I, C), j-major, and
// one block multiplies the four j planes of 64 output columns at once
// (BN = 256 accumulators), summing the four WSiLUs in its epilogue in the
// order j = 0..3.  h, d, out1, out1c and s are scratch the caller
// allocates.  The stack entry is blockIdx.y of every GEMM launch and
// blockIdx.z of the dw launch; the tensor maps are 3-D with the entry as a
// coordinate, and an x with entry stride 0 (every entry reads the same x,
// as the recon trunk's input) is read at entry 0.
//
// The launch plan (which launches run, each one's tile, grid and shared
// memory) comes from the caller (kernels/fused_dcb.py::k1_plan); the entry
// checks it and returns cudaErrorInvalidValue on a plan it cannot run.
// No atomics and a fixed summation order: the same input gives the same
// bits on every run, which the codec's encoder/decoder contract needs.
//
// Channel counts are multiples of 16.  Where one has no 64-wide divisor
// (368, the DCVC-RT intra trunk), the last column tile of a GEMM has a
// tail: TMA reads the rows of B past N and the columns of A and B past K
// as zeros (the maps' bounds), so the depth runs over ceil(K / 64) stages
// and the tail's sums are zero or, in ffn_in, the next plane's; the
// epilogue stores no column past N.  The dw launch's last channel block
// likewise stages zeros past I and stores nothing there.  16 keeps every
// row a multiple of 32 bytes: the 16-byte vectors of the epilogues and the
// dw launch never straddle the end of a row.
//
// Plain C interface for ctypes; dcvc_fused_dcb returns the first CUDA
// error.

#include "hopper_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf16x2;

// x * sigmoid(4x) with the fast exponential and division (a few ulp of
// f32; the result is rounded to bf16)
__device__ __forceinline__ float wsilu(float v) {
  return __fdividef(v, 1.0f + __expf(-4.0f * v));
}
// four bf16 <-> four floats, 8 bytes
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<bf16x2*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<bf16x2*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 wsilu4(float4 v) {
  return make_float4(wsilu(v.x), wsilu(v.y), wsilu(v.z), wsilu(v.w));
}

// ------------------------------------------------------------ GEMM launches

enum Kind { kAdaptor, kH, kDcOut, kFfnIn, kFfnOut };

struct GemmParams {
  int M, N, K;          // rows per entry, output columns, depth
  int n_tiles;          // output column tiles (ceil(N / bn_out))
  int bn_out;           // output columns per block
  int stages;           // of the core's ring
  int b_step;           // B rows between a block's boxes (ffn_in: I)
  int a_bcast;          // every entry reads entry 0 of A
  const bf16* bias;     // per entry bias_stride elements
  int bias_stride;
  const bf16* res;      // bf16 residual xin (S, M, N), or null
  long long res_stride; // its entry stride (0: one xin for every entry)
  const float* res32;   // f32 residual out1 (S, M, N) (ffn_out)
  bf16* out;            // (S, M, N)
  float* out32;         // out1 (S, M, N) (dc_out)
};

// The epilogue of each launch, on the block's f32 tile of sums: the
// consumer threads take 4 adjacent output columns at a time, row by row,
// so that a warp reads and writes whole rows of global memory.  A tail
// tile's columns past N (a multiple of 16, so a group of 4 is all in or
// all out) are neither read nor stored.
template <int KIND, int BM, int BN>
struct Epilogue {
  const GemmParams& p;
  int s, m0, n0;
  __device__ __forceinline__ void operator()(const float* tile, int ld,
                                             int tid, int nthreads) const {
    constexpr int kOut = KIND == kFfnIn ? BN / 4 : BN;  // output columns
    constexpr int kVecs = kOut / 4;
    static_assert(KIND != kFfnIn || BN == 256,
                  "ffn_in multiplies four 64-wide planes");
    const size_t entry = (size_t)p.M * p.N;
    const bf16* bias = p.bias + (size_t)s * p.bias_stride;
    const int rows = min(BM, p.M - m0);
#pragma unroll 4
    for (int e = tid; e < rows * kVecs; e += nthreads) {
      const int r = e / kVecs, c = (e % kVecs) * 4;
      const int col = n0 + c;
      if (col >= p.N) continue;
      const size_t o = (size_t)(m0 + r) * p.N + col;
      const float* t = tile + r * ld + c;
      float4 y;
      if constexpr (KIND == kFfnIn) {
        // s = sum_j wsilu(out1c w3[j] + b3[j]), j = 0..3 in order
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 f = wsilu4(add4(
              *reinterpret_cast<const float4*>(t + j * kOut),
              load4(bias + j * p.N + col)));
          y = j == 0 ? f : add4(y, f);
        }
      } else {
        y = add4(*reinterpret_cast<const float4*>(t), load4(bias + col));
        if constexpr (KIND == kH) {
          y = wsilu4(y);
        } else if constexpr (KIND == kDcOut) {
          y = add4(y, load4(p.res + s * p.res_stride + o));
          *reinterpret_cast<float4*>(p.out32 + s * entry + o) = y;
        } else if constexpr (KIND == kFfnOut) {
          y = add4(y, *reinterpret_cast<const float4*>(p.res32 + s * entry +
                                                       o));
          if (p.res) y = add4(y, load4(p.res + s * p.res_stride + o));
        }
      }
      store4(p.out + s * entry + o, y);
    }
  }
};

// Block (m_tile, n_tile) = divmod(blockIdx.x, n_tiles) of entry blockIdx.y
// (kernels/fused_dcb.py::gemm_block_tile mirrors this).
template <int KIND, int BM, int BN>
__device__ __forceinline__ void gemm_body(const CUtensorMap& a,
                                          const CUtensorMap& b,
                                          const GemmParams& p) {
  hgemm::Tile t;
  t.s = blockIdx.y;
  t.a_entry = p.a_bcast ? 0 : t.s;
  t.m0 = (blockIdx.x / p.n_tiles) * BM;
  const int n0 = (blockIdx.x % p.n_tiles) * p.bn_out;
  t.b_row0 = n0;
  t.b_step = p.b_step;
  t.nk = (p.K + hgemm::kBK - 1) / hgemm::kBK;  // a K tail reads as zeros
  t.stages = p.stages;
  const Epilogue<KIND, BM, BN> epi{p, t.s, t.m0, n0};
  hgemm::gemm_core<BM, BN>(reinterpret_cast<uint64_t>(&a),
                           reinterpret_cast<uint64_t>(&b), t, epi);
}

// one kernel name per launch of the chain, so that a profile tells them
// apart
#define K1_GEMM_KERNEL(NAME, KIND)                                         \
  template <int BM, int BN>                                                \
  __global__ void __launch_bounds__(2 * BM + 32, 1)                        \
      NAME(const __grid_constant__ CUtensorMap a,                          \
           const __grid_constant__ CUtensorMap b,                          \
           const __grid_constant__ GemmParams p) {                         \
    gemm_body<KIND, BM, BN>(a, b, p);                                      \
  }
K1_GEMM_KERNEL(k1_adaptor, kAdaptor)
K1_GEMM_KERNEL(k1_h, kH)
K1_GEMM_KERNEL(k1_dc_out, kDcOut)
K1_GEMM_KERNEL(k1_ffn_in, kFfnIn)
K1_GEMM_KERNEL(k1_ffn_out, kFfnOut)
#undef K1_GEMM_KERNEL

// the tiles of the plain products: BM 64 / 128 x BN 64 / 128 (a 256-wide
// tile holds 128 accumulators a thread, which leaves room for one block
// per SM, and measured slower than two 128-wide blocks sharing the SM)
#define K1_PICK(NAME, bm, bn)                                              \
  ((bm) == 64 ? ((bn) == 64 ? (const void*)NAME<64, 64>                    \
                            : (const void*)NAME<64, 128>)                  \
              : ((bn) == 64 ? (const void*)NAME<128, 64>                   \
                            : (const void*)NAME<128, 128>))

const void* gemm_kernel(int kind, int bm, int bn) {
  switch (kind) {
    case kAdaptor: return K1_PICK(k1_adaptor, bm, bn);
    case kH: return K1_PICK(k1_h, bm, bn);
    case kDcOut: return K1_PICK(k1_dc_out, bm, bn);
    case kFfnIn:
      return bm == 64 ? (const void*)k1_ffn_in<64, 256>
                      : (const void*)k1_ffn_in<128, 256>;
    default: return K1_PICK(k1_ffn_out, bm, bn);
  }
}
#undef K1_PICK

// -------------------------------------------------------------- dw launch

// A block: TH x TW pixels of one 64-channel chunk of one entry.  It stages
// the (TH + 2) x (TW + 2) halo of h (zeros outside the image: the TPU
// kernel's mask, the dw conv's zero padding) in shared memory, 16 bytes a
// load, and writes d with 16-byte stores.  The last chunk of an I that 64
// does not divide stages zeros past I and its threads there store
// nothing.  A thread keeps 8 channels' 9
// taps and walks one column of the tile; the 9 products are summed in
// dy-major order, as the TPU kernel sums them.
constexpr int kDwTH = 8, kDwTW = 32, kDwCh = 64, kDwThreads = 256;
constexpr int kDwSmem = (kDwTH + 2) * (kDwTW + 2) * kDwCh * 2;
static_assert(kDwThreads == kDwTW * (kDwCh / 8), "a thread per column x 8");

struct DwParams {
  const bf16* h;   // (S, H, W, I)
  const bf16* wd;  // (S, 3, 3, I)
  const bf16* bd;  // (S, I)
  bf16* d;         // (S, H, W, I)
  int H, W, I;
};

__global__ void __launch_bounds__(kDwThreads) k1_dw(const DwParams p) {
  __shared__ __align__(16) bf16 halo[(kDwTH + 2) * (kDwTW + 2) * kDwCh];
  hgemm::grid_dependency_wait();  // h is the previous launch's
  constexpr int kHW = kDwTW + 2, kVec = kDwCh / 8;
  const int s = blockIdx.z, c0 = blockIdx.y * kDwCh;
  const int tiles_w = (p.W + kDwTW - 1) / kDwTW;
  const int ty0 = (blockIdx.x / tiles_w) * kDwTH;
  const int tx0 = (blockIdx.x % tiles_w) * kDwTW;
  const size_t entry = (size_t)p.H * p.W * p.I;
  const bf16* h = p.h + s * entry + c0;
  for (int e = threadIdx.x; e < (kDwTH + 2) * kHW * kVec; e += kDwThreads) {
    const int r = e / kVec, v = e % kVec;
    const int iy = ty0 - 1 + r / kHW, ix = tx0 - 1 + r % kHW;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c0 + v * 8 < p.I)
      val = *reinterpret_cast<const uint4*>(
          h + ((size_t)iy * p.W + ix) * p.I + v * 8);
    *reinterpret_cast<uint4*>(halo + r * kDwCh + v * 8) = val;
  }
  __syncthreads();

  const int v = threadIdx.x % kVec, qx = threadIdx.x / kVec;
  const int ix = tx0 + qx;
  const int c = c0 + v * 8;
  if (ix >= p.W || c >= p.I) return;
  float wk[9][8], bias[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        p.wd + ((size_t)s * 9 + k) * p.I + c);
    const bf16* w = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) wk[k][e] = __bfloat162float(w[e]);
  }
  {
    const uint4 u =
        *reinterpret_cast<const uint4*>(p.bd + (size_t)s * p.I + c);
    const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) bias[e] = __bfloat162float(b[e]);
  }
  bf16* d = p.d + s * entry;
  for (int qy = 0; qy < kDwTH; ++qy) {
    const int iy = ty0 + qy;
    if (iy >= p.H) break;
    float acc[8];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            halo + ((qy + dy) * kHW + qx + dx) * kDwCh + v * 8);
        const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t =
              __fmul_rn(__bfloat162float(hv[e]), wk[dy * 3 + dx][e]);
          acc[e] = (dy == 0 && dx == 0) ? t : __fadd_rn(acc[e], t);
        }
      }
    uint4 o;
    bf16x2* o2 = reinterpret_cast<bf16x2*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o2[e] = __floats2bfloat162_rn(__fadd_rn(acc[2 * e], bias[2 * e]),
                                    __fadd_rn(acc[2 * e + 1],
                                              bias[2 * e + 1]));
    *reinterpret_cast<uint4*>(d + ((size_t)iy * p.W + ix) * p.I + c) = o;
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (so the library needs no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Encoded maps of recent calls, direct-mapped by their arguments: a
// module's weights keep their addresses, and the caching allocator hands
// the scratch of a shape the same addresses again, so most calls encode
// nothing.
struct MapEntry {
  const void* base;
  long long rows, entry_stride;
  int cols, entries;
  CUtensorMap map;
};
constexpr int kMapCache = 512;

// A 3-D map of bf16 (entries, rows, cols), entry stride in elements, read
// in 64 x 64 boxes with the 128-byte swizzle (hopper_gemm.cuh)
bool make_map(CUtensorMap* map, const void* base, long long rows, int cols,
              int entries, long long entry_stride) {
  static MapEntry cache[kMapCache];
  const uint64_t key = reinterpret_cast<uint64_t>(base) ^
                       ((uint64_t)rows << 20) ^ ((uint64_t)cols << 40) ^
                       ((uint64_t)entries << 52) ^
                       ((uint64_t)entry_stride * 0x9E3779B97F4A7C15ull);
  MapEntry& e = cache[(key ^ (key >> 29) ^ (key >> 47)) % kMapCache];
  if (e.base == base && e.rows == rows && e.cols == cols &&
      e.entries == entries && e.entry_stride == entry_stride) {
    *map = e.map;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)entries};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)entry_stride * 2};
  const cuuint32_t box[3] = {hgemm::kBK, hgemm::kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e = MapEntry{base, rows, entry_stride, cols, entries, *map};
  return true;
}

// One row of the plan: [on, bm, bn, bn_out, stages, grid x, grid y,
// grid z, smem] for the launches adaptor, h, dw, dc_out, ffn_in, ffn_out
// in that order.  dw: bm x bn = the pixel tile, bn_out = channels per
// block, stages 0.
struct Slot {
  int on, bm, bn, bn_out, stages, gx, gy, gz, smem;
};
constexpr int kSlots = 6, kSlotInts = 9;

bool gemm_slot_ok(const Slot& q, int S, int M, int N, int K, bool ffn_in,
                  int max_smem) {
  if (q.on != 1 || (q.bm != 64 && q.bm != 128)) return false;
  if (ffn_in ? (q.bn != 256 || q.bn_out != 64)
             : ((q.bn != 64 && q.bn != 128) || q.bn_out != q.bn))
    return false;
  if (N % 16 || K % 16 || K < 16) return false;
  if (q.gx != ((M + q.bm - 1) / q.bm) * ((N + q.bn_out - 1) / q.bn_out) ||
      q.gy != S ||
      q.gz != 1 || !hgemm::stages_ok(q.bm, q.bn, q.stages))
    return false;
  return q.smem == hgemm::smem_bytes(q.bm, q.bn, q.stages) &&
         q.smem <= max_smem;
}

bool dw_slot_ok(const Slot& q, int S, int H, int W, int I) {
  return q.on == 1 && q.bm == kDwTH && q.bn == kDwTW && q.bn_out == kDwCh &&
         q.stages == 0 &&
         q.gx == ((H + kDwTH - 1) / kDwTH) * ((W + kDwTW - 1) / kDwTW) &&
         q.gy == (I + kDwCh - 1) / kDwCh && q.gz == S && q.smem == kDwSmem;
}

// Raises a kernel's dynamic shared-memory limit to what its largest plan
// needs, once per kernel and size (a CUDA call per launch would add to
// every call's host time).
cudaError_t allow_smem(const void* fn, int bytes) {
  static const void* fns[64];
  static int set[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && set[i] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && i < 64) {
    fns[i] = fn;
    set[i] = bytes;
    if (i == n) ++n;
  }
  return err;
}

// Every launch of the chain may start while the kernel ahead of it in the
// stream finishes (programmatic dependent launch): its blocks set up and
// then wait for that grid (hgemm::grid_dependency_wait), which hides most
// of the launch latency between the chain's six kernels.
cudaError_t launch(const void* fn, dim3 grid, dim3 block, int smem,
                   void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_gemm(int kind, const Slot& q, const CUtensorMap& a,
                        const CUtensorMap& b, const GemmParams& p,
                        cudaStream_t stream) {
  const void* fn = gemm_kernel(kind, q.bm, q.bn);
  cudaError_t err = allow_smem(fn, q.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<CUtensorMap*>(&a), const_cast<CUtensorMap*>(&b),
                  const_cast<GemmParams*>(&p)};
  return launch(fn, dim3(q.gx, q.gy, q.gz), dim3(hgemm::threads(q.bm)),
                q.smem, args, stream);
}

GemmParams gemm_params(const Slot& q, int M, int N, int K, const void* bias,
                       int bias_stride, void* out) {
  GemmParams p = {};
  p.M = M;
  p.N = N;
  p.K = K;
  p.bn_out = q.bn_out;
  p.stages = q.stages;
  p.n_tiles = (N + q.bn_out - 1) / q.bn_out;
  p.b_step = hgemm::kBoxRows;
  p.bias = static_cast<const bf16*>(bias);
  p.bias_stride = bias_stride;
  p.out = static_cast<bf16*>(out);
  return p;
}

}  // namespace

// S blocks (S = 1: one DepthConvBlock) on x (S, H, W, Cin), entry stride
// x_stride elements (0: every entry reads the same x).  Weights carry a
// leading S and are K-major: wa (C, Cin), w1 (I, C), w2 (C, I),
// w3 (4, I, C), w4 (C, I); wd (3, 3, I); biases (N), b3 (4, I).  Scratch:
// xa (S, H, W, C) (with an adaptor), h and d (S, H, W, I), out1 (S, H, W,
// C) f32, out1c (S, H, W, C), s (S, H, W, I; it may be h's buffer: h is
// dead once dc_out has run).  out (S, H, W, C) bf16.  plan: kSlots rows of
// kSlotInts ints, a Slot each (kernels/fused_dcb.py::plan_ints).
extern "C" int dcvc_fused_dcb(
    const void* x, const void* wa, const void* ba, const void* w1,
    const void* b1, const void* wd, const void* bd, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* w4,
    const void* b4, void* xa, void* h, void* d, void* out1, void* out1c,
    void* s_buf, void* out, int S, long long x_stride, int H, int W, int Cin,
    int C, int I, int shortcut, const int* plan, void* stream) {
  const bool adaptor = wa != nullptr;
  const long long M = (long long)H * W;
  if (Cin % 16 || C % 16 || I % 16 || H < 1 || W < 1 || S < 1 ||
      (adaptor ? xa == nullptr : Cin != C) || plan == nullptr)
    return cudaErrorInvalidValue;
  const bool bcast = S > 1 && x_stride == 0;
  if (S > 1 && !bcast && x_stride != M * Cin) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int max_smem_of[64];  // per device, read once
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (max_smem_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&max_smem_of[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const int max_smem = max_smem_of[dev];
  Slot q[kSlots];
  for (int i = 0; i < kSlots; ++i) {
    const int* r = plan + kSlotInts * i;
    q[i] = Slot{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]};
  }
  const bool plan_ok =
      (adaptor ? gemm_slot_ok(q[0], S, M, C, Cin, false, max_smem)
               : q[0].on == 0) &&
      gemm_slot_ok(q[1], S, M, I, C, false, max_smem) &&
      dw_slot_ok(q[2], S, H, W, I) &&
      gemm_slot_ok(q[3], S, M, C, I, false, max_smem) &&
      gemm_slot_ok(q[4], S, M, I, C, true, max_smem) &&
      gemm_slot_ok(q[5], S, M, C, I, false, max_smem);
  if (!plan_ok) return cudaErrorInvalidValue;

  // the block's input: the adapted x, or x itself
  const void* xin = adaptor ? xa : x;
  const bool xin_bcast = !adaptor && bcast;
  const long long xin_stride = xin_bcast ? 0 : M * C;

  CUtensorMap m_x, m_wa, m_xin, m_w1, m_d, m_w2, m_o1c, m_w3, m_s, m_w4;
  const int xe = bcast ? 1 : S;
  bool maps_ok =
      make_map(&m_xin, xin, M, C, xin_bcast ? 1 : S, M * C) &&
      make_map(&m_w1, w1, I, C, S, (long long)I * C) &&
      make_map(&m_d, d, M, I, S, M * I) &&
      make_map(&m_w2, w2, C, I, S, (long long)C * I) &&
      make_map(&m_o1c, out1c, M, C, S, M * C) &&
      make_map(&m_w3, w3, 4LL * I, C, S, 4LL * I * C) &&
      make_map(&m_s, s_buf, M, I, S, M * I) &&
      make_map(&m_w4, w4, C, I, S, (long long)C * I);
  if (adaptor)
    maps_ok = maps_ok && make_map(&m_x, x, M, Cin, xe, M * Cin) &&
              make_map(&m_wa, wa, C, Cin, S, (long long)C * Cin);
  if (!maps_ok) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (adaptor) {
    GemmParams p = gemm_params(q[0], M, C, Cin, ba, C, xa);
    p.a_bcast = bcast;
    err = launch_gemm(kAdaptor, q[0], m_x, m_wa, p, st);
    if (err != cudaSuccess) return err;
  }
  {
    GemmParams p = gemm_params(q[1], M, I, C, b1, I, h);
    p.a_bcast = xin_bcast;
    err = launch_gemm(kH, q[1], m_xin, m_w1, p, st);
    if (err != cudaSuccess) return err;
  }
  {
    DwParams p;
    p.h = static_cast<const bf16*>(h);
    p.wd = static_cast<const bf16*>(wd);
    p.bd = static_cast<const bf16*>(bd);
    p.d = static_cast<bf16*>(d);
    p.H = H;
    p.W = W;
    p.I = I;
    void* args[] = {&p};
    err = launch((const void*)k1_dw, dim3(q[2].gx, q[2].gy, q[2].gz),
                 dim3(kDwThreads), 0, args, st);
    if (err != cudaSuccess) return err;
  }
  {
    GemmParams p = gemm_params(q[3], M, C, I, b2, C, out1c);
    p.res = static_cast<const bf16*>(xin);
    p.res_stride = xin_stride;
    p.out32 = static_cast<float*>(out1);
    err = launch_gemm(kDcOut, q[3], m_d, m_w2, p, st);
    if (err != cudaSuccess) return err;
  }
  {
    GemmParams p = gemm_params(q[4], M, I, C, b3, 4 * I, s_buf);
    p.b_step = I;
    err = launch_gemm(kFfnIn, q[4], m_o1c, m_w3, p, st);
    if (err != cudaSuccess) return err;
  }
  GemmParams p = gemm_params(q[5], M, C, I, b4, C, out);
  p.res32 = static_cast<const float*>(out1);
  if (shortcut) {
    p.res = static_cast<const bf16*>(xin);
    p.res_stride = xin_stride;
  }
  return launch_gemm(kFfnOut, q[5], m_s, m_w4, p, st);
}
