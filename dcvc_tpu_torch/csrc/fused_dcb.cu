// Fused DepthConvBlock for Hopper (sm_90a), bf16 in and out, f32 sums.
//
// Replaces the TPU kernel dcvc_tpu/kernels/fused_dcb.py::_dcb_kernel in
// both of its forms: one block (entry fused_dcb, S = 1) and S independent
// blocks with stacked weights (_fused_dcb_stacked via fused_dcb_stacked,
// the DMC-HTS recon heads, S = 4 and 8).  Per block:
//
//   [adaptor 1x1] -> dc_in 1x1 -> WSiLU -> zero h outside the image
//   -> depthwise 3x3 + bias -> dc_out 1x1 + residual (out1, f32)
//   -> FFN: 4 accumulated (C x I) matmuls, each through WSiLU (the
//      reference's 4-way chunk-add; the 4I-wide activation never exists)
//   -> ffn_out 1x1 + out1 [+ shortcut]
//
// with the TPU kernel's cast points: x after the adaptor, h after WSiLU
// and the mask, d after the dw bias, out1 as the FFN input, and the FFN
// sum before ffn_out are rounded to bf16; out1 stays f32 for the residual.
//
// What bounds it on the H100: arithmetic.  At C = I = 384 a block costs
// about 2 MFLOP per pixel (7 C x I matmuls), 67 GFLOP on the /8 grid of a
// 1080p frame, against ~1.5 KB of activation traffic per pixel, far above
// the card's ~295 FLOP/byte balance point: the work belongs on the tensor
// cores, and what limits a tile is how often it re-reads the weights
// (<= 9.5 MB at C = I = 768, L2-resident) for how many pixels.  The second
// bound is shared memory: a block may hold 227 KB (232,448 B), and the
// TPU kernel keeps (TH + 2) whole rows in ~12 MB of VMEM.
//
// Design: up to three launches per call, each with the stack entry as
// blockIdx.y, so S blocks cost one launch of each kind, not S:
//  * adaptor launch (only where the block has an adaptor): a tiled GEMM,
//    xa = bf16(x @ wa + ba), 128 x 64 outputs per block, both operands
//    streaming through 32-deep slabs (44.5 KB of shared memory whatever
//    Cin is; the HTS encoder's adaptor takes Cin = 2048).  The TPU kernel
//    rounds the adaptor output to bf16 as well, so the pre-pass computes
//    the same numbers, each pixel once instead of once per halo that
//    holds it, and its output is also the adapted shortcut input.
//  * dc launch: a TH x TW output tile (8x8, or 4x8 / 4x4 where 8x8 does
//    not fit) plus a 1-pixel halo of the (adapted) C-wide input.  dc_in
//    runs on the halo too (the 3x3 stencil needs h there) and goes
//    through I in 64-wide chunks, each chunk's h living only in shared
//    memory until the depthwise conv has consumed it.  Writes out1 (f32).
//    At the HTS widths: C = 512 / I = 256 takes 195,008 B at 8x8,
//    C = I = 512 227,776 B at 8x8, C = I = 768 186,368 B at 4x8.
//  * FFN launch: 128 pixels per block where they fit, else 64, else 32
//    (C = I = 768: 173,056 B).  For each 64-wide slice of I it runs the
//    four chunk matmuls with their accumulators in registers, applies
//    WSiLU and sums them, so only the I-wide bf16 sum reaches shared
//    memory; then ffn_out and the residuals.  Each block reads the FFN
//    weights once for its pixels.
//  * Matmuls: mma.sync m16n8k16 bf16 -> f32.  A operands (activations)
//    stay in shared memory and are read by ldmatrix; weights stream from
//    L2 in slabs of 16-64 rows by cp.async, 3-4 slabs in flight, shared
//    by the block's warps, with fragments double-buffered in registers.
//    Rows are padded by 8 elements against bank conflicts.  Epilogues
//    work on column pairs (bf16x2 / float2).  wgmma, TMA and persistence
//    are left for later work.
//  * Stacked form: weights carry a leading S and entry s finds its own by
//    offset; scratch (xa, out1) is per entry.  The input's entry stride
//    may be 0 (every entry reads the same x, as the recon trunk does).
//  * No atomics and a fixed summation order: the same input gives the
//    same bits on every run, which the codec's encoder/decoder contract
//    needs.  An entry's result does not depend on S or on its index.
//
// Plain C interface for ctypes; dcvc_fused_dcb returns cudaGetLastError().
// Channel counts must be multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;       // shared-memory row padding, in elements
constexpr int kChunk = 64;    // weight columns per staged slab
constexpr int kLds = kChunk + kPad;

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 b16(float v) { return __float2bfloat16(v); }

// x * sigmoid(4x) with the fast exponential and division (a few ulp of
// f32; the result is rounded to bf16)
__device__ __forceinline__ float wsilu(float v) {
  return __fdividef(v, 1.0f + __expf(-4.0f * v));
}

typedef __nv_bfloat162 bf16x2;
__device__ __forceinline__ float2 f32x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf16x2*>(p));
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<bf16x2*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lane l addresses row (l % 16), column block l / 16
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-wide product of a shared-memory A with one 64-column slice of
// PLANES global weight matrices:
//   out_p[m, n] = sum_k A[m, k] * B_p[k, n0 + n],  m < 16 * m_tiles, n < 64
// A: rows of `lda` elements.  B_p: K x ldb row-major at B + p * plane.
// The block's warps split the (m, n) tile into items of MI*16 x NI*8 and
// a warp runs up to IPW items.  Weight slabs of KS rows stream through
// `stage` (STAGES x PLANES x KS x kLds elements) by cp.async, STAGES - 1
// slabs ahead of the one being multiplied.  The results go out in pairs
// of columns: epi(row, col, v0, v1) with v0[p], v1[p] plane p's values at
// (row, col) and (row, col + 1), col = n0 + n even.  K must be a multiple
// of KS.  Every thread of the block must call this.
template <int PLANES, int MI, int NI, int IPW, int KS, int STAGES, class Epi>
__device__ void block_gemm(const bf16* A, int lda, int m_tiles,
                           const bf16* B, int ldb, size_t plane, int n0,
                           int K, bf16* stage, Epi&& epi) {
  static_assert(NI % 2 == 0, "NI must be even");
  constexpr int NG = kChunk / (NI * 8);
  constexpr int kSlabP = KS * kLds;        // one plane's slab
  constexpr int kBuf = PLANES * kSlabP;    // one stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_groups = (m_tiles + MI - 1) / MI;
  const int items = m_groups * NG;

  float acc[IPW][PLANES][MI][NI][4];
#pragma unroll
  for (int it = 0; it < IPW; ++it)
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[it][p][mi][ni][e] = 0.0f;

  const int nk = K / KS;
  // slab kt -> buffer kt % STAGES; one commit group per slab, empty past
  // the end so that wait_group counts stay uniform
  auto load = [&](int kt) {
    if (kt < nk) {
      bf16* s = stage + (kt % STAGES) * kBuf;
      constexpr int kVec = kChunk / 8;  // 16-byte vectors per slab row
      for (int e = threadIdx.x; e < PLANES * KS * kVec; e += kThreads) {
        const int p = e / (KS * kVec), rem = e % (KS * kVec);
        const int r = rem / kVec, v = rem % kVec;
        cp_async16(s + p * kSlabP + r * kLds + v * 8,
                   B + p * plane + (size_t)(kt * KS + r) * ldb + n0 + v * 8);
      }
    }
    cp_async_commit();
  };

  // A and B fragments of one 16-deep step, double-buffered in registers
  // so the next step's ldmatrix overlaps this step's mma
  uint32_t fa[2][IPW][MI][4];
  uint32_t fb[2][IPW][PLANES][NI / 2][4];
  auto load_frags = [&](int buf, const bf16* s, int kt, int kk) {
#pragma unroll
    for (int it = 0; it < IPW; ++it) {
      const int item = warp + it * kWarps;
      if (item < items) {
        const int mg = item % m_groups, ng = item / m_groups;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int mt = min(mg * MI + mi, m_tiles - 1);
          ldsm_x4(fa[buf][it][mi], A + (size_t)(mt * 16 + (lane & 15)) * lda +
                                       kt * KS + kk + (lane >> 4) * 8);
        }
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj)
            ldsm_x4_t(fb[buf][it][p][nj],
                      s + p * kSlabP + (kk + (lane & 15)) * kLds +
                          (ng * NI + 2 * nj) * 8 + (lane >> 4) * 8);
      }
    }
  };

#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) load(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab kt has landed; slab kt - 1 is consumed
    load(kt + STAGES - 1);
    const bf16* s = stage + (kt % STAGES) * kBuf;
    load_frags(0, s, kt, 0);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      if (ks + 1 < KS / 16) load_frags((ks + 1) & 1, s, kt, (ks + 1) * 16);
#pragma unroll
      for (int it = 0; it < IPW; ++it) {
        if (warp + it * kWarps >= items) continue;
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj)
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              const uint32_t(&b)[4] = fb[ks & 1][it][p][nj];
              mma_bf16(acc[it][p][mi][2 * nj], fa[ks & 1][it][mi], b[0], b[1]);
              mma_bf16(acc[it][p][mi][2 * nj + 1], fa[ks & 1][it][mi], b[2],
                       b[3]);
            }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with `stage` before it is reused

  // accumulator elements of an m16n8 tile: (row g, columns 2t and 2t + 1)
  // and (row g + 8, the same columns)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int it = 0; it < IPW; ++it) {
    const int item = warp + it * kWarps;
    if (item >= items) continue;
    const int mg = item % m_groups, ng = item / m_groups;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int mt = mg * MI + mi;
      if (mt >= m_tiles) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0[PLANES], v1[PLANES];
#pragma unroll
          for (int p = 0; p < PLANES; ++p) {
            v0[p] = acc[it][p][mi][ni][2 * h];
            v1[p] = acc[it][p][mi][ni][2 * h + 1];
          }
          epi(mt * 16 + g + h * 8, n0 + (ng * NI + ni) * 8 + 2 * t, v0, v1);
        }
    }
  }
}

// The products of the dc launch: 64-row weight slabs, 3 in flight.
#define DC_GEMM block_gemm<1, 1, 4, 1, 64, 3>
constexpr int kDcStage = 3 * 64 * kLds;

// The FFN launch takes ROWS pixels per block: 128 where shared memory
// holds them, else 64, else 32; its ffn_in planes and ffn_out stream with
// slabs sized so that the stages fit beside the two activation buffers.
// 64 and 32 rows share one plan (at 32 rows half the warps sit out the
// products).
template <int ROWS>
struct Ffn {
  static_assert(ROWS == 64 || ROWS == 32, "FFN blocks are 128, 64 or 32");
  static constexpr int kStage = 4 * 4 * 32 * kLds;  // >= 4 * 64 * kLds
  template <class Epi>
  __device__ static void in(const bf16* A, int lda, const bf16* B, int ldb,
                            size_t plane, int n0, int K, bf16* stage,
                            Epi&& epi) {
    block_gemm<4, 1, 2, 1, 32, 4>(A, lda, ROWS / 16, B, ldb, plane, n0, K,
                                  stage, static_cast<Epi&&>(epi));
  }
  template <class Epi>
  __device__ static void out(const bf16* A, int lda, const bf16* B, int ldb,
                             int n0, int K, bf16* stage, Epi&& epi) {
    block_gemm<1, 1, 2, 1, 64, 4>(A, lda, ROWS / 16, B, ldb, 0, n0, K, stage,
                                  static_cast<Epi&&>(epi));
  }
};
template <>
struct Ffn<128> {
  static constexpr int kStage = 3 * 4 * 16 * kLds;  // >= 3 * 32 * kLds
  template <class Epi>
  __device__ static void in(const bf16* A, int lda, const bf16* B, int ldb,
                            size_t plane, int n0, int K, bf16* stage,
                            Epi&& epi) {
    block_gemm<4, 2, 2, 1, 16, 3>(A, lda, 8, B, ldb, plane, n0, K, stage,
                                  static_cast<Epi&&>(epi));
  }
  template <class Epi>
  __device__ static void out(const bf16* A, int lda, const bf16* B, int ldb,
                             int n0, int K, bf16* stage, Epi&& epi) {
    block_gemm<1, 2, 2, 1, 32, 3>(A, lda, 8, B, ldb, 0, n0, K, stage,
                                  static_cast<Epi&&>(epi));
  }
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// -------------------------------------------------------- adaptor launch

// xa = bf16(x @ wa + ba) per entry: (M x K) @ (K x N), 128 x 64 outputs
// per block, 8 warps of 32 x 32.  x and wa stream through 32-deep slabs,
// 3 in flight (cp.async); rows past M read as zeros and are not stored.
// A block's column tile varies fastest, so the blocks that share an x
// slab run together and read it from L2.
constexpr int kAdThreads = 256;
constexpr int kAdBM = 128, kAdBN = 64, kAdBK = 32, kAdStages = 3;
constexpr int kAdLdA = kAdBK + kPad, kAdLdB = kAdBN + kPad;

struct AdaptorParams {
  const bf16* x; size_t x_stride;  // (S, M, K), entry stride in elements
  const bf16* wa; const bf16* ba;  // (S, K, N), (S, N)
  bf16* xa;                        // (S, M, N)
  int M, K, N;
};

__global__ void __launch_bounds__(kAdThreads) adaptor_kernel(
    const AdaptorParams p) {
  __shared__ __align__(128) bf16 As[kAdStages][kAdBM * kAdLdA];
  __shared__ __align__(128) bf16 Bs[kAdStages][kAdBK * kAdLdB];
  const int s = blockIdx.y;
  const int n_tiles = p.N / kAdBN;
  const int m0 = (blockIdx.x / n_tiles) * kAdBM;
  const int n0 = (blockIdx.x % n_tiles) * kAdBN;
  const bf16* x = p.x + s * p.x_stride;
  const bf16* wa = p.wa + (size_t)s * p.K * p.N;
  const bf16* ba = p.ba + (size_t)s * p.N;
  bf16* xa = p.xa + (size_t)s * p.M * p.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;

  const int nk = p.K / kAdBK;
  auto load = [&](int kt) {
    if (kt < nk) {
      bf16* a = As[kt % kAdStages];
      bf16* b = Bs[kt % kAdStages];
      const int k0 = kt * kAdBK;
      constexpr int kVa = kAdBK / 8, kVb = kAdBN / 8;
      for (int e = threadIdx.x; e < kAdBM * kVa; e += kAdThreads) {
        const int r = e / kVa, v = e % kVa;
        bf16* dst = a + r * kAdLdA + v * 8;
        if (m0 + r < p.M)
          cp_async16(dst, x + (size_t)(m0 + r) * p.K + k0 + v * 8);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      for (int e = threadIdx.x; e < kAdBK * kVb; e += kAdThreads) {
        const int r = e / kVb, v = e % kVb;
        cp_async16(b + r * kAdLdB + v * 8,
                   wa + (size_t)(k0 + r) * p.N + n0 + v * 8);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int kt = 0; kt < kAdStages - 1; ++kt) load(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kAdStages - 2>();
    __syncthreads();  // slab kt has landed; slab kt - 1 is consumed
    load(kt + kAdStages - 1);
    const bf16* a = As[kt % kAdStages];
    const bf16* b = Bs[kt % kAdStages];
#pragma unroll
    for (int kk = 0; kk < kAdBK; kk += 16) {
      uint32_t fa[2][4], fb[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(fa[mi], a + (wm + mi * 16 + (lane & 15)) * kAdLdA + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_t(fb[nj], b + (kk + (lane & 15)) * kAdLdB + wn + nj * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], fa[mi], fb[nj][0], fb[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], fa[mi], fb[nj][2], fb[nj][3]);
        }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        const int col = n0 + wn + ni * 8 + 2 * t;
        if (row >= p.M) continue;
        const float2 bb = f32x2(ba + col);
        store2(xa + (size_t)row * p.N + col, acc[mi][ni][2 * h] + bb.x,
               acc[mi][ni][2 * h + 1] + bb.y);
      }
}

// ------------------------------------------------------------- dc launch

struct DcParams {
  const bf16* x; size_t x_stride;  // (S, H, W, C) dc input: x or adapted x
  const bf16* w1; const bf16* b1;  // (S, C, I), (S, I)
  const bf16* wd; const bf16* bd;  // (S, 3, 3, I), (S, I)
  const bf16* w2; const bf16* b2;  // (S, I, C), (S, C)
  float* out1;                     // (S, H, W, C)
  int H, W, C, I, TH, TW;
};

// Shared-memory plan of the dc launch, identical on host and device:
//   tables  image pixel of each halo row (-1 outside), and image pixel and
//           halo row of each output pixel (ints)
//   X  (Mh x C+8)     input halo
//   Hc (Mh x 64+8)    one 64-wide chunk of h on the halo
//   D  (P x I+8)      depthwise output
//   stage             weight slabs
struct DcLayout {
  int Mh, P, ldx, ldi;
  size_t x, hc, d;  // bf16 offsets past the tables
  __host__ __device__ DcLayout(int TH, int TW, int C, int I) {
    Mh = round16((TH + 2) * (TW + 2));
    P = TH * TW;
    ldx = C + kPad;
    ldi = I + kPad;
    x = 0;
    hc = x + (size_t)Mh * ldx;
    d = hc + (size_t)Mh * kLds;
  }
  __host__ __device__ size_t table_bytes() const {
    return (size_t)(Mh + 2 * P) * sizeof(int);
  }
  __host__ __device__ size_t stage() const { return d + (size_t)P * ldi; }
  __host__ __device__ size_t bytes() const {
    return table_bytes() + (stage() + kDcStage) * sizeof(bf16);
  }
};

__global__ void __launch_bounds__(kThreads, 1) dc_kernel(const DcParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DcLayout L(p.TH, p.TW, p.C, p.I);
  int* halo_pix = reinterpret_cast<int*>(smem_raw);  // per halo row
  int* q_pix = halo_pix + L.Mh;                       // per output pixel
  int* q_row = q_pix + L.P;                           // its halo row
  bf16* sm = reinterpret_cast<bf16*>(smem_raw + L.table_bytes());
  bf16* X = sm + L.x;
  bf16* Hc = sm + L.hc;
  bf16* D = sm + L.d;
  bf16* stage = sm + L.stage();

  // this block's stack entry
  const int s = blockIdx.y;
  const size_t ci = (size_t)p.C * p.I;
  const bf16* x = p.x + s * p.x_stride;
  const bf16* w1 = p.w1 + s * ci;
  const bf16* b1 = p.b1 + (size_t)s * p.I;
  const bf16* wd = p.wd + (size_t)s * 9 * p.I;
  const bf16* bd = p.bd + (size_t)s * p.I;
  const bf16* w2 = p.w2 + s * ci;
  const bf16* b2 = p.b2 + (size_t)s * p.C;
  float* out1 = p.out1 + (size_t)s * p.H * p.W * p.C;

  const int HWd = p.TW + 2;  // halo tile width
  const int tiles_w = (p.W + p.TW - 1) / p.TW;
  const int ty0 = (blockIdx.x / tiles_w) * p.TH;
  const int tx0 = (blockIdx.x % tiles_w) * p.TW;
  for (int r = threadIdx.x; r < L.Mh; r += kThreads) {
    const int iy = ty0 - 1 + r / HWd, ix = tx0 - 1 + r % HWd;
    const bool in = r < (p.TH + 2) * HWd && iy >= 0 && iy < p.H && ix >= 0 &&
                    ix < p.W;
    halo_pix[r] = in ? iy * p.W + ix : -1;
  }
  for (int q = threadIdx.x; q < L.P; q += kThreads) {
    const int iy = ty0 + q / p.TW, ix = tx0 + q % p.TW;
    q_pix[q] = (iy < p.H && ix < p.W) ? iy * p.W + ix : -1;
    q_row[q] = (q / p.TW + 1) * HWd + q % p.TW + 1;
  }
  __syncthreads();

  // 0. input halo -> X, zeros outside the image
  const int vec = p.C / 8;
  for (int e = threadIdx.x; e < L.Mh * vec; e += kThreads) {
    const int r = e / vec, v = e % vec;
    const int pix = halo_pix[r];
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pix >= 0)
      val = reinterpret_cast<const uint4*>(x + (size_t)pix * p.C)[v];
    reinterpret_cast<uint4*>(X + (size_t)r * L.ldx)[v] = val;
  }
  __syncthreads();

  // 1. per 64-wide chunk of I: h = bf16(wsilu(X @ w1 + b1)), zero outside
  //    the image (the dw conv's zero padding lives in h); then the
  //    depthwise 3x3: D = bf16(sum_{dy,dx} h * wd + bd), dy-major order.
  //    A thread keeps one channel of the chunk and its 9 taps.
  const int c = threadIdx.x % kChunk;
  for (int i0 = 0; i0 < p.I; i0 += kChunk) {
    DC_GEMM(X, L.ldx, L.Mh / 16, w1, p.I, 0, i0, p.C, stage,
            [&](int r, int n, const float* v0, const float* v1) {
              const float2 b = f32x2(b1 + n);
              const bool in = halo_pix[r] >= 0;
              store2(Hc + (size_t)r * kLds + n - i0,
                     in ? wsilu(v0[0] + b.x) : 0.0f,
                     in ? wsilu(v1[0] + b.y) : 0.0f);
            });
    __syncthreads();
    float wk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wk[k] = f32(wd[k * p.I + i0 + c]);
    const float bias = f32(bd[i0 + c]);
    for (int q = threadIdx.x / kChunk; q < L.P; q += kThreads / kChunk) {
      const bf16* hq = Hc + (size_t)(q_row[q] - HWd - 1) * kLds + c;
      float d = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float t = __fmul_rn(f32(hq[(size_t)(dy * HWd + dx) * kLds]),
                                    wk[dy * 3 + dx]);
          d = (dy == 0 && dx == 0) ? t : __fadd_rn(d, t);
        }
      D[(size_t)q * L.ldi + i0 + c] = b16(__fadd_rn(d, bias));
    }
    __syncthreads();
  }

  // 2. dc_out: out1 = (D @ w2 + b2) + x (f32)
  for (int n0 = 0; n0 < p.C; n0 += kChunk)
    DC_GEMM(D, L.ldi, L.P / 16, w2, p.C, 0, n0, p.I, stage,
            [&](int q, int n, const float* v0, const float* v1) {
              const int pix = q_pix[q];
              if (pix < 0) return;
              const float2 x2 = f32x2(X + (size_t)q_row[q] * L.ldx + n);
              const float2 b = f32x2(b2 + n);
              *reinterpret_cast<float2*>(out1 + (size_t)pix * p.C + n) =
                  make_float2((v0[0] + b.x) + x2.x, (v1[0] + b.y) + x2.y);
            });
}

// ------------------------------------------------------------ FFN launch

struct FfnParams {
  const float* out1;               // (S, HW, C)
  const bf16* xs; size_t xs_stride;  // (S, HW, C) shortcut input, or null
  const bf16* w3; const bf16* b3;  // (S, 4, C, I) j-major, (S, 4, I)
  const bf16* w4; const bf16* b4;  // (S, I, C), (S, C)
  bf16* out;                       // (S, HW, C)
  int HW, C, I;
};

// A (ROWS x C+8) bf16(out1), S (ROWS x I+8) the FFN sum, weight stages
template <int ROWS>
size_t ffn_bytes(int C, int I) {
  return ((size_t)ROWS * (C + kPad) + (size_t)ROWS * (I + kPad) +
          Ffn<ROWS>::kStage) * sizeof(bf16);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1) ffn_kernel(const FfnParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldc = p.C + kPad, ldi = p.I + kPad;
  bf16* A = reinterpret_cast<bf16*>(smem_raw);
  bf16* S = A + (size_t)ROWS * ldc;
  bf16* stage = S + (size_t)ROWS * ldi;
  const int p0 = blockIdx.x * ROWS;

  // this block's stack entry
  const int s = blockIdx.y;
  const size_t entry = (size_t)p.HW * p.C;
  const float* out1 = p.out1 + s * entry;
  const bf16* xs = p.xs ? p.xs + s * p.xs_stride : nullptr;
  const bf16* w3 = p.w3 + (size_t)s * 4 * p.C * p.I;
  const bf16* b3 = p.b3 + (size_t)s * 4 * p.I;
  const bf16* w4 = p.w4 + (size_t)s * p.I * p.C;
  const bf16* b4 = p.b4 + (size_t)s * p.C;
  bf16* out = p.out + s * entry;

  // 0. A = bf16(out1) of the block's pixels, zeros past the image
  const int vec = p.C / 4;
  for (int e = threadIdx.x; e < ROWS * vec; e += kThreads) {
    const int r = e / vec, v = e % vec;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < p.HW)
      f = reinterpret_cast<const float4*>(out1 + (size_t)(p0 + r) * p.C)[v];
    bf16* dst = A + (size_t)r * ldc + v * 4;
    store2(dst, f.x, f.y);
    store2(dst + 2, f.z, f.w);
  }
  __syncthreads();

  // 1. S = bf16(sum_j wsilu(A @ w3[j] + b3[j])), j = 0..3 in order, one
  //    64-wide slice of I at a time
  for (int i0 = 0; i0 < p.I; i0 += kChunk)
    Ffn<ROWS>::in(A, ldc, w3, p.I, (size_t)p.C * p.I, i0, p.C, stage,
                  [&](int r, int n, const float* v0, const float* v1) {
                  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float2 b = f32x2(b3 + j * p.I + n);
                    const float f0 = wsilu(v0[j] + b.x);
                    const float f1 = wsilu(v1[j] + b.y);
                    s0 = j == 0 ? f0 : s0 + f0;
                    s1 = j == 0 ? f1 : s1 + f1;
                  }
                  store2(S + (size_t)r * ldi + n, s0, s1);
                });
  __syncthreads();

  // 2. out = bf16((S @ w4 + b4) + out1 [+ x])
  for (int n0 = 0; n0 < p.C; n0 += kChunk)
    Ffn<ROWS>::out(S, ldi, w4, p.C, n0, p.I, stage,
                   [&](int r, int n, const float* v0, const float* v1) {
                   const int pix = p0 + r;
                   if (pix >= p.HW) return;
                   const size_t o = (size_t)pix * p.C + n;
                   const float2 b = f32x2(b4 + n);
                   const float2 r1 = *reinterpret_cast<const float2*>(out1 + o);
                   float y0 = (v0[0] + b.x) + r1.x, y1 = (v1[0] + b.y) + r1.y;
                   if (xs) {
                     const float2 x2 = f32x2(xs + o);
                     y0 += x2.x;
                     y1 += x2.y;
                   }
                   store2(out + o, y0, y1);
                 });
}

template <int ROWS>
cudaError_t launch_ffn(const FfnParams& f, int S, cudaStream_t s) {
  const size_t smem = ffn_bytes<ROWS>(f.C, f.I);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((f.HW + ROWS - 1) / ROWS, S);
  ffn_kernel<ROWS><<<grid, kThreads, smem, s>>>(f);
  return cudaGetLastError();
}

}  // namespace

// S blocks (S = 1: one DepthConvBlock) on x (S, H, W, Cin), entry stride
// x_stride elements (0: every entry reads the same x).  Weights carry a
// leading S.  out1 (S, H, W, C) f32 and, with an adaptor, xa (S, H, W, C)
// bf16 are scratch; out (S, H, W, C) bf16.
extern "C" int dcvc_fused_dcb(const void* x, const void* wa, const void* ba,
                              const void* w1, const void* b1, const void* wd,
                              const void* bd, const void* w2, const void* b2,
                              const void* w3, const void* b3, const void* w4,
                              const void* b4, void* out1, void* xa,
                              void* out, int S, long long x_stride, int H,
                              int W, int Cin, int C, int I, int shortcut,
                              void* stream) {
  if (Cin % kChunk || C % kChunk || I % kChunk || H < 1 || W < 1 || S < 1 ||
      x_stride < 0)
    return cudaErrorInvalidValue;
  const bool adaptor = wa != nullptr;
  if (!adaptor && Cin != C) return cudaErrorInvalidValue;
  if (adaptor && xa == nullptr) return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  // the largest output tile whose working set fits in shared memory
  static const int kTiles[3][2] = {{8, 8}, {4, 8}, {4, 4}};
  int th = 0, tw = 0;
  size_t dc_smem = 0;
  for (const auto& t : kTiles) {
    const size_t need = DcLayout(t[0], t[1], C, I).bytes();
    if (need <= (size_t)max_smem) {
      th = t[0];
      tw = t[1];
      dc_smem = need;
      break;
    }
  }
  // FFN blocks of 128 pixels where they fit, else 64, else 32
  int ffn_rows = 0;
  if (ffn_bytes<128>(C, I) <= (size_t)max_smem)
    ffn_rows = 128;
  else if (ffn_bytes<64>(C, I) <= (size_t)max_smem)
    ffn_rows = 64;
  else if (ffn_bytes<32>(C, I) <= (size_t)max_smem)
    ffn_rows = 32;
  if (th == 0 || ffn_rows == 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dc_smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const size_t entry = (size_t)HW * C;

  if (adaptor) {
    AdaptorParams a;
    a.x = static_cast<const bf16*>(x);
    a.x_stride = (size_t)x_stride;
    a.wa = static_cast<const bf16*>(wa);
    a.ba = static_cast<const bf16*>(ba);
    a.xa = static_cast<bf16*>(xa);
    a.M = HW;
    a.K = Cin;
    a.N = C;
    const dim3 grid((C / kAdBN) * ((HW + kAdBM - 1) / kAdBM), S);
    adaptor_kernel<<<grid, kAdThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // the dc and FFN launches read the adapted x where there is an adaptor
  const bf16* xin = adaptor ? static_cast<const bf16*>(xa)
                            : static_cast<const bf16*>(x);
  const size_t xin_stride = adaptor ? entry : (size_t)x_stride;

  DcParams d;
  d.x = xin;
  d.x_stride = xin_stride;
  d.w1 = static_cast<const bf16*>(w1);
  d.b1 = static_cast<const bf16*>(b1);
  d.wd = static_cast<const bf16*>(wd);
  d.bd = static_cast<const bf16*>(bd);
  d.w2 = static_cast<const bf16*>(w2);
  d.b2 = static_cast<const bf16*>(b2);
  d.out1 = static_cast<float*>(out1);
  d.H = H;
  d.W = W;
  d.C = C;
  d.I = I;
  d.TH = th;
  d.TW = tw;
  const dim3 dc_grid(((H + th - 1) / th) * ((W + tw - 1) / tw), S);
  dc_kernel<<<dc_grid, kThreads, dc_smem, s>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  FfnParams f;
  f.out1 = static_cast<const float*>(out1);
  f.xs = shortcut ? xin : nullptr;
  f.xs_stride = xin_stride;
  f.w3 = static_cast<const bf16*>(w3);
  f.b3 = static_cast<const bf16*>(b3);
  f.w4 = static_cast<const bf16*>(w4);
  f.b4 = static_cast<const bf16*>(b4);
  f.out = static_cast<bf16*>(out);
  f.HW = HW;
  f.C = C;
  f.I = I;
  if (ffn_rows == 128) return launch_ffn<128>(f, S, s);
  if (ffn_rows == 64) return launch_ffn<64>(f, S, s);
  return launch_ffn<32>(f, S, s);
}
