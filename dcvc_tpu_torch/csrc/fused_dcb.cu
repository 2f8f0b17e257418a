// Fused DepthConvBlock for Hopper (sm_90a), bf16 in and out, f32 sums.
//
// Replaces the TPU kernel dcvc_tpu/kernels/fused_dcb.py::_dcb_kernel
// (launched by _fused_dcb_stacked, entry point fused_dcb), S = 1 form:
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
// (<= 3.7 MB, L2-resident) for how many pixels.
//
// Design: two launches, because one tile's working set does not fit a
// block's 227 KB of shared memory at C = I = 512 (the TPU kernel holds
// whole rows in ~12 MB of VMEM).  Both run 16 warps per block, one block
// per SM, so that the warps of a sub-partition hide each other's latency.
//  * dc launch: a TH x TW output tile (8x8, or 4x8 where 8x8 does not fit)
//    plus a 1-pixel halo.  The adaptor and dc_in run on the halo too (the
//    3x3 stencil needs h there); dc_in goes through I in 64-wide chunks,
//    each chunk's h living only in shared memory until the depthwise conv
//    has consumed it.  Writes out1 (f32) and, for an adapted shortcut, the
//    adapted x.
//  * FFN launch: 128 pixels per block (64 where C + I > 768).  For each
//    64-wide slice of I it runs the four chunk matmuls with their
//    accumulators in registers, applies WSiLU and sums them, so only the
//    I-wide bf16 sum reaches shared memory; then ffn_out and the
//    residuals.  Each block reads the FFN weights once for its pixels.
//  * Matmuls: mma.sync m16n8k16 bf16 -> f32.  A operands (activations)
//    stay in shared memory and are read by ldmatrix; weights stream from
//    L2 in slabs of 16-64 rows by cp.async, 3-4 slabs in flight, shared
//    by the block's warps, with fragments double-buffered in registers.
//    Rows are padded by 8 elements against bank conflicts.  Epilogues
//    work on column pairs (bf16x2 / float2).  wgmma, TMA and persistence
//    are left for later work.
//  * No atomics and a fixed summation order: the same input gives the
//    same bits on every run, which the codec's encoder/decoder contract
//    needs.
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

// The FFN launch takes ROWS pixels per block, 128 where shared memory
// holds them and 64 otherwise; its ffn_in planes and ffn_out stream with
// slabs sized so that the stages fit beside the two activation buffers.
template <int ROWS>
struct Ffn;
template <>
struct Ffn<64> {
  static constexpr int kStage = 4 * 4 * 32 * kLds;  // >= 4 * 64 * kLds
  template <class Epi>
  __device__ static void in(const bf16* A, int lda, const bf16* B, int ldb,
                            size_t plane, int n0, int K, bf16* stage,
                            Epi&& epi) {
    block_gemm<4, 1, 2, 1, 32, 4>(A, lda, 4, B, ldb, plane, n0, K, stage,
                                  static_cast<Epi&&>(epi));
  }
  template <class Epi>
  __device__ static void out(const bf16* A, int lda, const bf16* B, int ldb,
                             int n0, int K, bf16* stage, Epi&& epi) {
    block_gemm<1, 1, 2, 1, 64, 4>(A, lda, 4, B, ldb, 0, n0, K, stage,
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

// ------------------------------------------------------------- dc launch

struct DcParams {
  const bf16* x;                   // (H, W, Cin)
  const bf16* wa; const bf16* ba;  // (Cin, C), (C) or null: no adaptor
  const bf16* w1; const bf16* b1;  // (C, I), (I)
  const bf16* wd; const bf16* bd;  // (3, 3, I), (I)
  const bf16* w2; const bf16* b2;  // (I, C), (C)
  float* out1;                     // (H, W, C)
  bf16* xa;                        // (H, W, C) adapted x, or null
  int H, W, Cin, C, I, TH, TW;
};

// Shared-memory plan of the dc launch, identical on host and device:
//   tables  image pixel of each halo row (-1 outside), and image pixel and
//           halo row of each output pixel (ints)
//   X  (Mh x Cin+8)   x halo
//   XA (Mh x C+8)     adapted x halo (adaptor only; X serves otherwise)
//   Hc (Mh x 64+8)    one 64-wide chunk of h on the halo
//   D  (P x I+8)      depthwise output
//   stage             weight slabs
struct DcLayout {
  int Mh, P, ldx, ldc, ldi;
  size_t x, xa, hc, d;  // bf16 offsets past the tables
  __host__ __device__ DcLayout(int TH, int TW, int Cin, int C, int I,
                               bool adaptor) {
    Mh = round16((TH + 2) * (TW + 2));
    P = TH * TW;
    ldx = Cin + kPad;
    ldc = C + kPad;
    ldi = I + kPad;
    x = 0;
    xa = x + (size_t)Mh * ldx;
    hc = xa + (adaptor ? (size_t)Mh * ldc : 0);
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
  const bool adaptor = p.wa != nullptr;
  const DcLayout L(p.TH, p.TW, p.Cin, p.C, p.I, adaptor);
  int* halo_pix = reinterpret_cast<int*>(smem_raw);  // per halo row
  int* q_pix = halo_pix + L.Mh;                       // per output pixel
  int* q_row = q_pix + L.P;                           // its halo row
  bf16* sm = reinterpret_cast<bf16*>(smem_raw + L.table_bytes());
  bf16* X = sm + L.x;
  bf16* XA = adaptor ? sm + L.xa : X;
  const int ldxa = adaptor ? L.ldc : L.ldx;
  bf16* Hc = sm + L.hc;
  bf16* D = sm + L.d;
  bf16* stage = sm + L.stage();

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

  // 0. x halo -> X, zeros outside the image
  const int vec = p.Cin / 8;
  for (int e = threadIdx.x; e < L.Mh * vec; e += kThreads) {
    const int r = e / vec, v = e % vec;
    const int pix = halo_pix[r];
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pix >= 0)
      val = reinterpret_cast<const uint4*>(p.x + (size_t)pix * p.Cin)[v];
    reinterpret_cast<uint4*>(X + (size_t)r * L.ldx)[v] = val;
  }
  __syncthreads();

  // 1. adaptor: XA = bf16(X @ wa + ba)
  if (adaptor) {
    for (int n0 = 0; n0 < p.C; n0 += kChunk)
      DC_GEMM(X, L.ldx, L.Mh / 16, p.wa, p.C, 0, n0, p.Cin, stage,
              [&](int r, int n, const float* v0, const float* v1) {
                const float2 b = f32x2(p.ba + n);
                store2(XA + (size_t)r * ldxa + n, v0[0] + b.x, v1[0] + b.y);
              });
    __syncthreads();
  }

  // 2. per 64-wide chunk of I: h = bf16(wsilu(XA @ w1 + b1)), zero outside
  //    the image (the dw conv's zero padding lives in h); then the
  //    depthwise 3x3: D = bf16(sum_{dy,dx} h * wd + bd), dy-major order.
  //    A thread keeps one channel of the chunk and its 9 taps.
  const int c = threadIdx.x % kChunk;
  for (int i0 = 0; i0 < p.I; i0 += kChunk) {
    DC_GEMM(XA, ldxa, L.Mh / 16, p.w1, p.I, 0, i0, p.C, stage,
            [&](int r, int n, const float* v0, const float* v1) {
              const float2 b = f32x2(p.b1 + n);
              const bool in = halo_pix[r] >= 0;
              store2(Hc + (size_t)r * kLds + n - i0,
                     in ? wsilu(v0[0] + b.x) : 0.0f,
                     in ? wsilu(v1[0] + b.y) : 0.0f);
            });
    __syncthreads();
    float wk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wk[k] = f32(p.wd[k * p.I + i0 + c]);
    const float bias = f32(p.bd[i0 + c]);
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

  // 3. dc_out: out1 = (D @ w2 + b2) + x (f32); the adapted x of the tile
  //    goes out too when the shortcut needs it
  for (int n0 = 0; n0 < p.C; n0 += kChunk)
    DC_GEMM(D, L.ldi, L.P / 16, p.w2, p.C, 0, n0, p.I, stage,
            [&](int q, int n, const float* v0, const float* v1) {
              const int pix = q_pix[q];
              if (pix < 0) return;
              const bf16* xq = XA + (size_t)q_row[q] * ldxa + n;
              const float2 x2 = f32x2(xq), b = f32x2(p.b2 + n);
              const size_t o = (size_t)pix * p.C + n;
              *reinterpret_cast<float2*>(p.out1 + o) =
                  make_float2((v0[0] + b.x) + x2.x, (v1[0] + b.y) + x2.y);
              if (p.xa)
                *reinterpret_cast<bf16x2*>(p.xa + o) =
                    *reinterpret_cast<const bf16x2*>(xq);
            });
}

// ------------------------------------------------------------ FFN launch

struct FfnParams {
  const float* out1;               // (HW, C)
  const bf16* xs;                  // (HW, C) shortcut input, or null
  const bf16* w3; const bf16* b3;  // (4, C, I) j-major, (4, I)
  const bf16* w4; const bf16* b4;  // (I, C), (C)
  bf16* out;                       // (HW, C)
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

  // 0. A = bf16(out1) of the block's pixels, zeros past the image
  const int vec = p.C / 4;
  for (int e = threadIdx.x; e < ROWS * vec; e += kThreads) {
    const int r = e / vec, v = e % vec;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < p.HW)
      f = reinterpret_cast<const float4*>(p.out1 + (size_t)(p0 + r) * p.C)[v];
    bf16* dst = A + (size_t)r * ldc + v * 4;
    store2(dst, f.x, f.y);
    store2(dst + 2, f.z, f.w);
  }
  __syncthreads();

  // 1. S = bf16(sum_j wsilu(A @ w3[j] + b3[j])), j = 0..3 in order, one
  //    64-wide slice of I at a time
  for (int i0 = 0; i0 < p.I; i0 += kChunk)
    Ffn<ROWS>::in(A, ldc, p.w3, p.I, (size_t)p.C * p.I, i0, p.C, stage,
                  [&](int r, int n, const float* v0, const float* v1) {
                  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const float2 b = f32x2(p.b3 + j * p.I + n);
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
    Ffn<ROWS>::out(S, ldi, p.w4, p.C, n0, p.I, stage,
                   [&](int r, int n, const float* v0, const float* v1) {
                   const int pix = p0 + r;
                   if (pix >= p.HW) return;
                   const size_t o = (size_t)pix * p.C + n;
                   const float2 b = f32x2(p.b4 + n);
                   const float2 r1 = *reinterpret_cast<const float2*>(p.out1 + o);
                   float y0 = (v0[0] + b.x) + r1.x, y1 = (v1[0] + b.y) + r1.y;
                   if (p.xs) {
                     const float2 x2 = f32x2(p.xs + o);
                     y0 += x2.x;
                     y1 += x2.y;
                   }
                   store2(p.out + o, y0, y1);
                 });
}

}  // namespace

extern "C" int dcvc_fused_dcb(const void* x, const void* wa, const void* ba,
                              const void* w1, const void* b1, const void* wd,
                              const void* bd, const void* w2, const void* b2,
                              const void* w3, const void* b3, const void* w4,
                              const void* b4, void* out1, void* xa,
                              void* out, int H, int W, int Cin, int C, int I,
                              int shortcut, void* stream) {
  if (Cin % kChunk || C % kChunk || I % kChunk || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const bool adaptor = wa != nullptr;
  if (!adaptor && Cin != C) return cudaErrorInvalidValue;
  if (shortcut && adaptor && xa == nullptr) return cudaErrorInvalidValue;
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
    const size_t need = DcLayout(t[0], t[1], Cin, C, I, adaptor).bytes();
    if (need <= (size_t)max_smem) {
      th = t[0];
      tw = t[1];
      dc_smem = need;
      break;
    }
  }
  // FFN blocks of 128 pixels where they fit, else 64
  const bool ffn128 = ffn_bytes<128>(C, I) <= (size_t)max_smem;
  const int ffn_rows = ffn128 ? 128 : 64;
  const size_t ffn_smem = ffn128 ? ffn_bytes<128>(C, I) : ffn_bytes<64>(C, I);
  if (th == 0 || ffn_smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dc_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ffn128 ? ffn_kernel<128> : ffn_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ffn_smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  DcParams d;
  d.x = static_cast<const bf16*>(x);
  d.wa = static_cast<const bf16*>(wa);
  d.ba = static_cast<const bf16*>(ba);
  d.w1 = static_cast<const bf16*>(w1);
  d.b1 = static_cast<const bf16*>(b1);
  d.wd = static_cast<const bf16*>(wd);
  d.bd = static_cast<const bf16*>(bd);
  d.w2 = static_cast<const bf16*>(w2);
  d.b2 = static_cast<const bf16*>(b2);
  d.out1 = static_cast<float*>(out1);
  d.xa = shortcut && adaptor ? static_cast<bf16*>(xa) : nullptr;
  d.H = H;
  d.W = W;
  d.Cin = Cin;
  d.C = C;
  d.I = I;
  d.TH = th;
  d.TW = tw;
  const int dc_grid = ((H + th - 1) / th) * ((W + tw - 1) / tw);
  dc_kernel<<<dc_grid, kThreads, dc_smem, s>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  FfnParams f;
  f.out1 = static_cast<const float*>(out1);
  f.xs = !shortcut ? nullptr
                   : adaptor ? static_cast<const bf16*>(xa)
                             : static_cast<const bf16*>(x);
  f.w3 = static_cast<const bf16*>(w3);
  f.b3 = static_cast<const bf16*>(b3);
  f.w4 = static_cast<const bf16*>(w4);
  f.b4 = static_cast<const bf16*>(b4);
  f.out = static_cast<bf16*>(out);
  f.HW = H * W;
  f.C = C;
  f.I = I;
  const int ffn_grid = (H * W + ffn_rows - 1) / ffn_rows;
  if (ffn128)
    ffn_kernel<128><<<ffn_grid, kThreads, ffn_smem, s>>>(f);
  else
    ffn_kernel<64><<<ffn_grid, kThreads, ffn_smem, s>>>(f);
  return cudaGetLastError();
}
