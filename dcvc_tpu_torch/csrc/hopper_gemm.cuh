// One GEMM core for Hopper (sm_90a): TMA loads into a ring of shared-memory
// stages, wgmma.mma_async (m64nBNk16, bf16 -> f32) on them, the sums kept
// in registers, and an epilogue functor that receives them as an f32 tile
// in shared memory.  Every product of K1 (csrc/fused_dcb.cu) runs on it.
//
//   out[s, m, n] = sum_k A[s, m, k] * B[s, n, k]      (both K-major)
//
// A block computes BM rows x BN accumulator columns of one stack entry.
//  * Operands reach shared memory by TMA as boxes of 64 rows x 64 elements
//    (128 bytes) with the 128-byte swizzle, which is also the layout wgmma
//    reads (K-major, SW128).  A block's B tile is BN / 64 boxes whose
//    starting rows are b_row0 + i * b_step: consecutive rows for a plain
//    product, one box per plane where a block multiplies several weight
//    planes at once (ffn_in's four j products, b_step = I).
//  * Tensor maps are 3-D, (entries, rows, 64-element columns); the entry
//    is a coordinate, so a tile never reads another entry's rows, and
//    rows past the end of an entry read as zeros, as do the columns past
//    the end of a row: a depth K that 64 does not divide runs ceil(K / 64)
//    stages, the last one's tail zero in A and in B (the box's bytes,
//    zeros included, count towards the stage's transaction).
//  * Pipeline: a ring of `stages` stages (2-4, chosen by the caller: fewer
//    stages let 2-3 blocks share an SM, so that one block's epilogue
//    overlaps another's products) with a full and an empty mbarrier each.
//    One thread of an extra producer warp issues the copies; BM / 64
//    consumer warpgroups each multiply a 64-row slice of A with the whole
//    B tile.  Two stages' products may be in flight (wgmma.wait_group 1);
//    a stage is handed back to the producer when its products are done.
//  * Epilogue: the consumers write their sums to shared memory as one
//    f32 tile (the stages are free by then) and hand it to the caller's
//    functor, which reads it row by row in 16-byte vectors, so that its
//    global loads and stores are coalesced.
//  * Launched with programmatic stream serialisation, a block sets up its
//    barriers while the kernel ahead of it finishes, then waits for it
//    (grid_dependency_wait) before the first copy.
//  * The depth loop runs in order, no split-K and no atomics: a given
//    input gives the same bits on every run.
//
// Block: 128 * (BM / 64) + 32 threads; dynamic shared memory
// smem_bytes(BM, BN, stages).

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: the library does not link libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hgemm {

constexpr int kBK = 64;                       // depth of one stage
constexpr int kBoxRows = 64;                  // rows of one TMA box
constexpr int kBoxBytes = kBoxRows * kBK * 2; // 8 KB, bf16
constexpr int kMaxStages = 4;

__host__ __device__ constexpr int threads(int bm) { return 2 * bm + 32; }
// the stages, their barriers, and 1 KB of slack to start the tiles on a
// 1024-byte boundary (the swizzle pattern follows the address bits)
__host__ __device__ constexpr int smem_bytes(int bm, int bn, int stages) {
  return stages * (bm + bn) * kBK * 2 + 2 * stages * 8 + 1024;
}
// the epilogue's f32 tile: BM rows of BN + 4 (the pad spreads a warp's
// fragment stores over the banks); it reuses the stages
__host__ __device__ constexpr int tile_ld(int bn) { return bn + 4; }
__host__ __device__ constexpr bool stages_ok(int bm, int bn, int stages) {
  return stages >= 2 && stages <= kMaxStages &&
         bm * tile_ld(bn) * 4 <= stages * (bm + bn) * kBK * 2;
}

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// ~2^34 cycles (seconds) is a fault of the pipeline and traps, so that it
// fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Programmatic dependent launch: the kernel may be launched before the
// one ahead of it in the stream has finished (the launch attribute set by
// the host); this waits until that grid has completed and its writes are
// visible.  Every thread calls it before it reads what an earlier kernel
// wrote.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_tmap(uint64_t map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// one box of a 3-D map into shared memory, completion counted on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, uint64_t map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma operand descriptor of a K-major, 128-byte-swizzled tile: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); the tile starts on a
// 1024-byte boundary.  Adding 2 steps 16 elements (32 bytes) along K.
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  uint64_t desc = (smem_u32(tile) & 0x3FFFF) >> 4;
  desc |= (uint64_t)1 << 16;            // LBO (unused with this swizzle)
  desc |= (uint64_t)(1024 >> 4) << 32;  // SBO
  desc |= (uint64_t)1 << 62;            // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16, descriptor da) * B (N x 16, descriptor db)^T
// (scale-d, the predicate that keeps d, is set: the sums start at zero)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},\n"
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128 or 256");
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// ---------------------------------------------------------------- the core

// What a block multiplies: A rows m0.. of entry a_entry, B boxes at rows
// b_row0 + i * b_step of entry s, nk steps of depth kBK through a ring of
// `stages` stages.
struct Tile {
  int s, a_entry, m0, b_row0, b_step, nk, stages;
};

// a barrier of the consumer warpgroups only (the producer warp has left)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Every thread of the block calls this.  The consumer threads end in
// epi(tile, ld, tid, n): tile is the block's BM x BN sums in shared
// memory, f32, rows ld apart; tid < n numbers the consumer threads, which
// all call it.  The producer warp returns without calling epi.
template <int BM, int BN, class Epi>
__device__ __forceinline__ void gemm_core(uint64_t map_a, uint64_t map_b,
                                          const Tile& t, const Epi& epi) {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  constexpr int kWarpgroups = BM / 64;
  constexpr int kConsumers = 128 * kWarpgroups;
  constexpr int kBoxesB = BN / kBoxRows;
  constexpr int kBytesA = BM * kBK * 2;
  constexpr int kStageBytes = (BM + BN) * kBK * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + t.stages * kStageBytes);
  uint64_t* empty = full + t.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < t.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kWarpgroups);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_tmap(map_a);
    prefetch_tmap(map_b);
  }
  __syncthreads();
  grid_dependency_wait();

  if (warp == 4 * kWarpgroups) {  // the producer warp
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;  // parity of the ring's current lap
      for (int kb = 0; kb < t.nk; ++kb) {
        if (kb >= t.stages) mbar_wait(&empty[st], phase ^ 1);
        uint8_t* a = smem + st * kStageBytes;
        uint8_t* b = a + kBytesA;
        mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
        for (int i = 0; i < kWarpgroups; ++i)
          tma_load_3d(a + i * kBoxBytes, map_a, &full[st], kb * kBK,
                      t.m0 + i * kBoxRows, t.a_entry);
#pragma unroll
        for (int i = 0; i < kBoxesB; ++i)
          tma_load_3d(b + i * kBoxBytes, map_b, &full[st], kb * kBK,
                      t.b_row0 + i * t.b_step, t.s);
        if (++st == t.stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int st = 0, prev = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < t.nk; ++kb) {
    mbar_wait(&full[st], phase);
    const uint8_t* a = smem + st * kStageBytes;
    const uint64_t da = make_desc(a + wg * kBoxBytes);
    const uint64_t db = make_desc(a + kBytesA);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) wgmma<BN>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();  // the products of the previous stage are done
    fence_acc(acc);
    if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = st;
    if (++st == t.stages) {
      st = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the sums to shared memory: the fragment's element 4 q + 2 h + e sits
  // at row r + 8 h, column 8 q + c + e
  consumers_sync(kConsumers);  // every warpgroup is done with the stages
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int ld = tile_ld(BN);
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r + 8 * h) * ld + 8 * q + c) =
          make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
  consumers_sync(kConsumers);
  epi(tile, ld, static_cast<int>(threadIdx.x), kConsumers);
}

}  // namespace hgemm
