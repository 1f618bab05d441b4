// Hopper int8 GEMM mainloop: a ring of shared-memory stages filled by
// cp.async.bulk under mbarriers, one producer warp, two consumer warpgroups
// issuing wgmma.mma_async s8 x s8 -> s32.  Written for the blind-rotate
// kernels (blind_rotate.cu) and meant to be reused by vertical packing.
//
// Operand layout ("k-major tiles").  wgmma reads 8-bit operands K-major
// from shared memory in 8-row x 16-byte core matrices.  Every operand of
// the mainloop is kept in device memory already in that order, so each
// stage is ONE contiguous bulk copy and needs no tensor map or swizzle:
//   byte (row, k) of a [rows][K] matrix (rows % 8 == 0, K % kBK == 0) sits at
//   ((k / kBK) * (rows / 8) + row / 8) * (8 * kBK)
//     + ((k % kBK) / 16) * 128 + (row % 8) * 16 + k % 16.
// A stage holds kBK bytes of K for a run of rows: rows [r0, r0 + n) at
// k-block kb start at (kb * rows + r0) * kBK and are n * kBK bytes long.
// In shared memory the core matrix (row group g, K chunk c) of a stage
// starts at g * 8 * kBK + c * 128: the descriptor's leading (K) byte offset
// is 128, its stride (M/N) byte offset 8 * kBK, no swizzle.
//
// Tile: the two consumer warpgroups own rows [0, 64) and [64, 128) of the
// A stage (128 rows); both multiply all BN rows of the B stage.  Each
// thread's accumulator d[BN / 2] follows the wgmma layout: warp w of the
// warpgroup, lane l, register 4 * n8 + 2 * i + j holds
//   row 16 * w + l / 4 + 8 * i,  column 8 * n8 + 2 * (l % 4) + j.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {
namespace sm90 {

constexpr int kBK = 64;            // K bytes of one stage
constexpr int kRowsA = 128;        // A rows of one stage (two warpgroups)
constexpr int kConsumers = 256;    // consumer threads
constexpr int kThreads = 288;      // + one producer warp (warp 8)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A barrier that never completes traps (a launch error) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// Bulk copy global -> shared (bytes % 16 == 0, both ends 16-byte aligned),
// completing `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16-byte copy global -> shared by one thread (cp.async, L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barrier over the consumer threads only (the producer warp may have
// left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading (K)
// byte offset 128, stride (M/N) byte offset 8 * kBK, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  const uint64_t addr = (smem_u32(p) & 0x3FFFF) >> 4;
  return addr | (uint64_t(128 >> 4) << 16) | (uint64_t((8 * kBK) >> 4) << 32);
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

__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128, "tile width");
  if constexpr (BN == 128)
    wgmma_m64n128k32(d, da, db, scale_d);
  else
    wgmma_m64n64k32(d, da, db, scale_d);
}

// The offset of (row, k) in the k-major tile layout of a [rows][K] matrix
// is kmajor_col(k, rows) + kmajor_row(row) (32-bit: matrices below 2^31
// bytes).
__host__ __device__ __forceinline__ int kmajor_col(int k, int rows) {
  return (k / kBK) * rows * kBK + ((k % kBK) >> 4) * 128 + (k & 15);
}
__host__ __device__ __forceinline__ int kmajor_row(int row) {
  return (row >> 3) * (8 * kBK) + (row & 7) * 16;
}

// The ring: STAGES x (A stage of kRowsA rows, B stage of BN rows), kBK
// bytes of K each, and its full/empty barriers.
template <int BN, int STAGES>
struct Ring {
  static constexpr int kABytes = kRowsA * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBytes = STAGES * kStageBytes;

  uint8_t* buf;      // kBytes, 1024-byte aligned
  uint64_t* full;    // STAGES barriers, one arrival + the stage's bytes
  uint64_t* empty;   // STAGES barriers, one arrival per consumer warpgroup

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
  }

  // Producer (one thread): n stages; src(i, a, b) sets the global source of
  // stage i's A rows and B rows (each one contiguous run, see above).
  template <class Src>
  __device__ void produce(int n, Src src) {
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      const int8_t* a;
      const int8_t* b;
      src(i, a, b);
      uint8_t* dst = buf + s * kStageBytes;
      mbar_expect_tx(&full[s], kStageBytes);
      bulk_g2s(dst, a, kABytes, &full[s]);
      bulk_g2s(dst + kABytes, b, kBBytes, &full[s]);
    }
  }

  // Consumers (both warpgroups): n stages, K blocks of kb_per_tile stages
  // per output tile.  The first stage of a tile overwrites d.  Each stage
  // is released as soon as its wgmma group has completed, so the producer
  // keeps STAGES - 1 copies in flight; after the last stage of a tile,
  // epi(tile) runs.
  template <class Epi>
  __device__ void consume(int n, int kb_per_tile, int (&d)[BN / 2], Epi epi) {
    const int wg = threadIdx.x >> 7;
    const bool leader = (threadIdx.x & 127) == 0;
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int kb = i % kb_per_tile;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* a = buf + s * kStageBytes + wg * (kABytes / 2);
      const uint8_t* b = buf + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_tile<BN>(d, desc_kmajor(a + kk * 256), desc_kmajor(b + kk * 256),
                       kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (leader) mbar_arrive(&empty[s]);
      if (kb == kb_per_tile - 1) epi(i / kb_per_tile);
    }
  }

  // The same, with a second wgmma group in flight: stage i is started before
  // stage i - 1 is waited for and released, so the tensor cores do not
  // drain between the stages of a tile (n % kb_per_tile == 0).  The waits
  // sit in straight-line code of the tile loop: a wait in a branch made
  // ptxas serialize the wgmma (its note C7518), and that form was slower
  // than consume().  While a group is in flight its accumulators must stay
  // in their registers: use this only in a kernel that ptxas compiles
  // without spills (with 96 registers and 112 bytes of stack the vertical
  // packing's forward kernel gave wrong words; at 168 registers its inverse
  // kernel is exact and a seventh faster).
  template <class Epi>
  __device__ void consume_pipelined(int n, int kb_per_tile, int (&d)[BN / 2],
                                    Epi epi) {
    const int wg = threadIdx.x >> 7;
    const bool leader = (threadIdx.x & 127) == 0;
    for (int t = 0, i = 0; t < n / kb_per_tile; ++t) {
      for (int kb = 0; kb < kb_per_tile; ++kb, ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const uint8_t* a = buf + s * kStageBytes + wg * (kABytes / 2);
        const uint8_t* b = buf + s * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_tile<BN>(d, desc_kmajor(a + kk * 256),
                         desc_kmajor(b + kk * 256), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (leader && kb > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) asm volatile("" : "+r"(d[r])::"memory");
      if (leader) mbar_arrive(&empty[(i - 1) % STAGES]);
      epi(t);
    }
  }
};

}  // namespace sm90
}  // namespace tfhe
