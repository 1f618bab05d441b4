// Blind rotation on Hopper: the whole n-step CMux loop of one PBS batch,
// two launches a step.
//
// Replaces the Pallas TPU kernel tfhe_aes_tpu/ops/pallas_blind_rotate.py
// (_kernel, built by _build_call, driven by blind_rotate_pallas).  Same
// mathematics in the mod-2^q' rotate domain (q' = 48), per BSK step s:
//   K1  forward digit NTT as one int8 product  A [bits x R digit rows, dn]
//       x fwd [dn, lo | hi residue columns], the residues lo + 256 hi, the
//       external-product MAC against the step's BSK rows and the twiddle
//       (psi^(a_s (2j+1)) - 1) of the mod-switched mask a_s -> X, the int8
//       limbs of delta_hat [P][bits x (k+1)][2N];
//   K2  the P per-prime inverse NTT products X_k x inv_k (n^-1 and the CRT
//       premultiplier folded in), the canonical residues, the explicit CRT,
//       acc += delta (mod 2^q'), and the next step's gadget digits A.
// The first step's digits come from one decomposition launch before the
// loop.  Setup (mod-switch, X^-b~ * test, rounding to q') and the final
// rescale to 2^64 stay in the wrapper (ops/cuda_blind_rotate.py).
//
// The bound.  At PARAM_TPU (k+1 = 5, 3 levels, N = 512, 5 primes, 12-bit
// digits as two int8 limbs, dn = 2N) one step on B bits does
//   forward  2 * (15B) * 1024 * 5120 = 157.3 M * B int8 operations,
//   inverse  2 * (5B) * 1024 * 1024 * 5 = 52.4 M * B,
// 209.7 M * B together: 0.43 ms a step at 4096 bits at the 1979 TOPS int8
// peak.  Its device traffic is the digits A (16 B rows padded, dn bytes,
// written by K2 and read by K1), X (5 * 5B * 2N bytes, both ways), acc
// (8 bytes a word, read and written) and one BSK step (250 KB x 2.5 at
// PARAM_TPU): ~0.5 GB a step at 4096 bits, ~0.15 ms at 3.35 TB/s.  So the
// step is bound by the products' operations.
//
// What the design does about what held the previous five-launch version
// back:
//   * products on mma.sync from registers, loads never overlapping math:
//     both products run on wgmma.mma_async from a ring of shared-memory
//     stages (four in K1, five in K2) that one producer warp fills with
//     cp.async.bulk under mbarriers (sm90_gemm.cuh); two consumer
//     warpgroups do the math.  The
//     operands are stored in device memory in the tile order wgmma reads,
//     so each stage is one contiguous bulk copy.  What the epilogues read
//     besides (the BSK rows, the masks; K2's accumulator words, prefetched
//     into L2) is fetched with cp.async or plain loads issued before the
//     product, so it lands while the tensor cores run;
//   * int32 intermediates through device memory: the forward residues dh
//     (629 MB at 4096 bits) live only in shared memory between K1's
//     product and its MAC, and the inverse residues Y (210 MB) only in
//     K2's shared memory between its products and the CRT;
//   * a 64-bit % for every residue: every reduction is a 32-bit Barrett
//     reduction (reduce_canonical), exact for every int32 |x| < 2^31 -
//     2^16.  The forward sums are small enough that lo + 256 hi fits that
//     range (checked by the wrapper) and takes one reduction; the MAC's and
//     the inverse products' hi is reduced before lo + 256 hi is formed; the
//     twiddle product of two balanced residues stays below 2^30;
//   * five launches a step: two (K1, K2), the decomposition fused into K2.
// A K1 block owns whole bits (each bit's R <= 32 digit rows padded to 16
// or 32, so its MAC never leaves the block) and 64 residue columns with
// their paired hi columns, two blocks an SM; the grid runs the column
// tiles of one row tile together, so the A tile is read from L2.  From
// 4 tiles an SM on (ops/cuda_blind_rotate.py k1_persistent) K1 runs
// persistently instead, one block an SM keeping a column tile's forward
// slice and BSK rows for a run of row tiles (br_forward_mac_kernel_persistent
// in csrc/blind_rotate_k1.cu).  A K2
// block owns 128 rows of (bit, GLWE component) and 32 output coefficients
// across all primes, two blocks an SM, so one block's epilogue can run
// beside the other's products; its CRT gives each thread four adjacent
// coefficients of a row, so that the accumulator words move 16 bytes, the
// residues 8 and each digit row's digits 4 at a time.  Where that grid
// fills under a third of the card
// (at N = 512 on the H100 a batch of up to 128 bits: every rotate of a
// session), a block streaming all P x 2N / 64 stages in one chain is what a
// step waits for: there K2 runs a thread-block cluster of P blocks a tile,
// one prime a block, which share the CRT's rows through distributed shared
// memory (the chain P times shorter, the epilogue split P ways).
//
// Left for later (stage cuts, scripts/br_stage_cut.py, on the H100 at
// PARAM_OPT 2048 bits): K1 one block a tile takes 0.79 ms a step; the
// persistent K1 0.55 ms, 0.16 of it without its epilogue, whose residues'
// reductions and __dp4a MAC (two warpgroups an SM) are the rest.  Clusters
// of two CTAs sharing the fwd tile through multicast copies gave the same
// words but ran slower.  K2 takes 0.24 ms a step: 0.12 without its
// epilogue, 0.07 without its operand copies too.  Its blocks read 1.26 GB
// a step from L2 (X 52.4 MB once a coefficient tile, 839 MB; the inverse
// matrices 5.24 MB once a row tile, 419 MB), yet without X's copies K2
// took only 6% less: L2 traffic does not set its pace, and multicasting X
// over a cluster of coefficient tiles was not built.  Its mainloop moves
// 28 KB of shared memory a stage (16 KB read by wgmma, 12 KB written by
// the copies) against 16 KB without the copies, in the same ratio as the
// two times; the residues of each prime (0.06 ms) and the CRT (0.05)
// follow it.  Two groups of warpgroups a block walking every other tile
// (each group's epilogue beside the other's products) ran at 0.30-0.38 ms:
// 20 warps an SM leave 96 registers a thread, and it spilled.  Neither a
// second wgmma group in flight (Ring::consume_pipelined) nor a persistent
// step loop is tried here (a CUDA graph of the WoPBS already holds the
// gaps between the 2n launches).
//
// Exact by construction: the products are exact int32 sums, the reductions
// exact, and the CRT alpha uses the same 2^-40 fixed point as the plain
// version, so the words equal blind_rotate_plain's bit for bit.
#include "blind_rotate.cuh"

namespace tfhe {

constexpr int kBitStride1 = kConsumers / kCols1;
// K2: 32 output coefficients (+ their hi columns) a tile, five stages,
// two blocks an SM (~100 KB of shared memory each).
constexpr int kCols2 = 32, kBN2 = 2 * kCols2, kStages2 = 5, kBlocks2 = 2;
constexpr int kMaxBitsPerThread = kRowsA / 16 / kBitStride1;  // rpad 16

// Balanced gadget digits of W accumulator words of one row (m2 = b (k+1) +
// u of acc) and W consecutive coefficients n, n + 1, ... into the digit
// rows b * rpad + u * lev + l of A; a_lo (a_hi) is the k-major column
// offset of the first word's coefficient n (N + n: wide digits as two
// base-2^6 limbs).  W = 4 (n % 4 == 0): the four words' digits of a row
// lie side by side, one 4-byte store.
template <int W>
__device__ __forceinline__ void decompose_store(
    const unsigned long long (&v)[W], int m2, int a_lo, int a_hi,
    const Shape& s, int8_t* __restrict__ A) {
  static_assert(W == 1 || W == 4, "one word or four");
  const int b = m2 / s.J;
  const int row0 = b * s.rpad + (m2 - b * s.J) * s.lev;
  const unsigned long long mask = (1ULL << s.blog) - 1;
  const unsigned long long half = 1ULL << (s.blog - 1);
  unsigned long long u[W];
  unsigned long long carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    u[w] = s.shift > 0 ? (v[w] + (1ULL << (s.shift - 1))) >> s.shift : v[w];
    carry[w] = 0;
  }
  for (int l = s.lev - 1; l >= 0; --l) {  // the least significant first
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned long long tv = (u[w] & mask) + carry[w];
      u[w] >>= s.blog;
      carry[w] = tv >= half ? 1 : 0;
      const int d = static_cast<int>(tv) - static_cast<int>(carry[w] << s.blog);
      const int h6 = s.wide ? (d + 32) >> 6 : 0;
      lo |= static_cast<uint32_t>(static_cast<uint8_t>(d - (h6 << 6))) << (8 * w);
      hi |= static_cast<uint32_t>(static_cast<uint8_t>(h6)) << (8 * w);
    }
    const int ro = kmajor_row(row0 + l);
    if constexpr (W == 4) {
      *reinterpret_cast<uint32_t*>(A + a_lo + ro) = lo;
      if (s.wide) *reinterpret_cast<uint32_t*>(A + a_hi + ro) = hi;
    } else {
      A[a_lo + ro] = static_cast<int8_t>(lo);
      if (s.wide) A[a_hi + ro] = static_cast<int8_t>(hi);
    }
  }
}

// The first step's digits: one thread per accumulator word (B (k+1) N
// words, below 2^31).
__global__ void br_decompose_kernel(const long long* __restrict__ acc,
                                    Shape s, int8_t* __restrict__ A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.B * s.J * s.N) return;
  const int n = i % s.N;
  const unsigned long long v[1] = {static_cast<unsigned long long>(acc[i])};
  decompose_store(v, i / s.N, kmajor_col(n, s.rows1),
                  kmajor_col(s.N + n, s.rows1), s, A);
}

// K1: forward product + residues + MAC + twiddle -> X, for 128 digit rows
// (128 / rpad bits) x 64 residue columns, all of one prime (N % 64 == 0).
template <int J>
__global__ void __launch_bounds__(kThreads, kBlocks1)
br_forward_mac_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ fwd,
                      const int8_t* __restrict__ bsk,
                      const int16_t* __restrict__ rot,
                      const int32_t* __restrict__ tilde, int tstride,
                      int step, Shape s, RnsConsts c,
                      int8_t* __restrict__ X) {
  using Ring = sm90::Ring<kBN1, kStages1>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int rows2j = s.R * 2 * J;
  int8_t* gs = reinterpret_cast<int8_t*>(smem + Ring::kBytes);  // [R*2J][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Ring::kBytes +
                                               rows2j * kCols1);
  Ring ring{smem, bars, bars + kStages1};
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int c0 = ct * kCols1;
  const int n_kb = s.dn / kBK;
  const int k = c0 / s.N;
  Prime32 q = c.pr[0];
#pragma unroll
  for (int i = 1; i < kMaxPrimes; ++i)
    if (i == k) q = c.pr[i];

  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    if ((threadIdx.x & 31) == 0)
      ring.produce(n_kb, [&](int i, const int8_t*& a, const int8_t*& b) {
        a = A + ((long long)i * s.rows1 + rt * kRowsA) * kBK;
        b = fwd + ((long long)i * s.bp_rows + ct * kBN1) * kBK;
      });
    return;
  }

  // While the product runs: the step's BSK rows at this block's columns
  // land in shared memory (cp.async), and the masks a_s of this thread's
  // bits in registers.  Thread -> column t % kCols1 and the tile's bits
  // t / kCols1 + kBitStride1 * i.
  const int8_t* g = bsk + (long long)step * rows2j * s.PN + c0;
  for (int i = threadIdx.x; i < rows2j * kCols1 / 16; i += kConsumers) {
    const int r = i / (kCols1 / 16), cc = (i % (kCols1 / 16)) * 16;
    sm90::cp_async16(gs + r * kCols1 + cc, g + (long long)r * s.PN + cc);
  }
  sm90::cp_async_commit();
  const int col = threadIdx.x % kCols1;
  const int gc = c0 + col;
  const int nbits = kRowsA / s.rpad;
  const int bgrp = threadIdx.x / kCols1;
  int mask_a[kMaxBitsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxBitsPerThread; ++i) {
    const int bl = bgrp + kBitStride1 * i, b = rt * nbits + bl;
    mask_a[i] = bl < nbits && b < s.B ? tilde[(long long)b * tstride + step] : 0;
  }

  int d[kBN1 / 2];
  ring.consume(n_kb, n_kb, d, [](int) {});

  // The twiddles rot[a_s] - 1, landing during the epilogue below.
  int tw1[kMaxBitsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxBitsPerThread; ++i)
    tw1[i] = rot[mask_a[i] * s.PN + gc] - 1;

  // Residues dh = lo + 256 hi (mod p, balanced) into shared memory, over
  // the ring (every wgmma of both warpgroups has completed).  |lo + 256 hi|
  // <= dn |digit| (128 + 256 * 126) < 2^31 - 2^16 (checked by the
  // wrapper): one reduction.
  sm90::consumers_sync();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  int16_t* dh = reinterpret_cast<int16_t*>(smem);  // [128 rows][kCols1]
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n8 = 0; n8 < kCols1 / 8; ++n8) {
    const int col0 = n8 * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
      const int e = n8 * 4 + 2 * h, eh = e + kCols1 / 2;
      const int v0 = reduce_balanced(d[e] + 256 * d[eh], q);
      const int v1 = reduce_balanced(d[e + 1] + 256 * d[eh + 1], q);
      *reinterpret_cast<uint32_t*>(dh + row * kCols1 + col0) = pack16(v0, v1);
    }
  }
  sm90::cp_async_wait_all();
  sm90::consumers_sync();

  // MAC over each bit's R rows.
  const int n = gc - k * s.N;
  // |d| <= p/2 < 2^15, |limb| <= 128, R <= 32 terms: |sum| < 2^27.
  int sl[kMaxBitsPerThread][J], sh[kMaxBitsPerThread][J];
#pragma unroll
  for (int i = 0; i < kMaxBitsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) sl[i][j] = sh[i][j] = 0;
#pragma unroll 4
  for (int r = 0; r < s.R; ++r) {
    int gl[J], gh[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      gl[j] = gs[(r * 2 * J + j) * kCols1 + col];
      gh[j] = gs[(r * 2 * J + J + j) * kCols1 + col];
    }
#pragma unroll
    for (int i = 0; i < kMaxBitsPerThread; ++i) {
      const int bl = bgrp + kBitStride1 * i;
      if (bl >= nbits) continue;
      const int dv = dh[(bl * s.rpad + r) * kCols1 + col];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        sl[i][j] += dv * gl[j];
        sh[i][j] += dv * gh[j];
      }
    }
  }
  int8_t* xk = X + (long long)k * s.rows2 * 2 * s.N;
  const int x_lo = kmajor_col(n, s.rows2), x_hi = kmajor_col(s.N + n, s.rows2);
#pragma unroll
  for (int i = 0; i < kMaxBitsPerThread; ++i) {
    const int bl = bgrp + kBitStride1 * i, b = rt * nbits + bl;
    if (bl >= nbits || b >= s.B) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int prod =
          reduce_balanced(sl[i][j] + 256 * reduce_balanced(sh[i][j], q), q);
      // |tw1 prod| <= (p + 1)/2 (p - 1)/2 < 2^30
      const int delta = reduce_balanced(tw1[i] * prod, q);
      const int h8 = (delta + 128) >> 8;
      const int ro = kmajor_row(b * J + j);
      xk[x_lo + ro] = static_cast<int8_t>(delta - (h8 << 8));
      xk[x_hi + ro] = static_cast<int8_t>(h8);
    }
  }
}

// K2: per-prime inverse products -> canonical residues (shared memory) ->
// CRT -> acc += delta (mod 2^q) -> the next step's digits (A == nullptr on
// the last step), for 128 (bit, component) rows x 32 coefficients.
//
// kSplit = false: one block a (coefficient tile, row tile) streams every
// prime's 2N / 64 stages in turn and finishes the tile's rows.
// kSplit = true, for grids far too small to fill the card: one block a (tile,
// prime), the P blocks of a tile one thread-block cluster (grid.x = P x
// coefficient tiles, cluster (P, 1, 1), rank = prime).  Each streams only
// its prime's stages and keeps its residues in its own shared memory; after
// a cluster barrier each finishes a P-th of the tile's rows, reading the
// other primes' residues from their blocks' shared memory, and a second
// barrier keeps every block resident until no other block reads it.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kBlocks2)
br_inverse_crt_kernel(const int8_t* __restrict__ X,
                      const int8_t* __restrict__ inv, Shape s, RnsConsts c,
                      long long* __restrict__ acc, int8_t* __restrict__ A) {
  using Ring = sm90::Ring<kBN2, kStages2>;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ Prime32 sp[kMaxPrimes];
  const int n_ys = kSplit ? 1 : c.count;  // [n_ys][128][32] residues
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + Ring::kBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ys + n_ys * kRowsA * kCols2);
  Ring ring{smem, bars, bars + kStages2};
  const int k0 = kSplit ? blockIdx.x % c.count : 0;  // the first prime
  const int ct = kSplit ? blockIdx.x / c.count : blockIdx.x;
  const int rt = blockIdx.y;
  const int n0 = ct * kCols2;
  const int n_kb = 2 * s.N / kBK;
  const long long x_prime = (long long)s.rows2 * 2 * s.N;
  const long long inv_prime = 4LL * s.N * s.N;
  const int mrows = s.B * s.J;
  // The tile's rows this block finishes: [r_lo, r_hi) of its valid rows.
  const int valid = min(kRowsA, mrows - rt * kRowsA);
  const int r_lo = kSplit ? k0 * valid / c.count : 0;
  const int r_hi = kSplit ? (k0 + 1) * valid / c.count : valid;

  if (threadIdx.x < c.count) sp[threadIdx.x] = c.pr[threadIdx.x];
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    if ((threadIdx.x & 31) == 0)
      ring.produce(n_ys * n_kb,
                   [&](int i, const int8_t*& a, const int8_t*& b) {
                     const int k = k0 + i / n_kb, kb = i % n_kb;
                     a = X + k * x_prime +
                         ((long long)kb * s.rows2 + rt * kRowsA) * kBK;
                     b = inv + k * inv_prime +
                         ((long long)kb * 2 * s.N + ct * kBN2) * kBK;
                   });
    if constexpr (kSplit) {  // its part in both cluster barriers below
      sm90::cluster_sync();
      sm90::cluster_sync();
    }
    return;
  }

  // The accumulator words this block finishes, into L2 during the products:
  // a 128-byte line a thread.
  if (threadIdx.x < 2 * (r_hi - r_lo))
    sm90::prefetch_l2(acc + (long long)(rt * kRowsA + r_lo + threadIdx.x / 2) *
                                s.N + n0 + 16 * (threadIdx.x & 1));

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  int d[kBN2 / 2];
  ring.consume(n_ys * n_kb, n_kb, d, [&](int t) {
    const Prime32 q = sp[k0 + t];
    uint16_t* yk = ys + t * kRowsA * kCols2;
#pragma unroll
    for (int n8 = 0; n8 < kCols2 / 8; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        const int col0 = n8 * 8 + (lane & 3) * 2;
        const int e = n8 * 4 + 2 * h, eh = e + kCols2 / 2;
        const int y0 = reduce_canonical(d[e] + 256 * reduce_balanced(d[eh], q), q);
        const int y1 =
            reduce_canonical(d[e + 1] + 256 * reduce_balanced(d[eh + 1], q), q);
        *reinterpret_cast<uint32_t*>(yk + row * kCols2 + col0) = pack16(y0, y1);
      }
  });
  if constexpr (kSplit)
    sm90::cluster_sync();  // every prime's residues in its block
  else
    sm90::consumers_sync();

  // Explicit CRT: x = sum_k y_k (M/p_k) - alpha M, alpha from 2^-40 fixed
  // point.  Thread -> four coefficients 4 (t % 8) .. + 3 and the rows
  // r_lo + t / 8 + 32 i: the accumulator words in 16-byte loads and stores
  // (all of a thread's issued before its first CRT), each prime's four
  // residues in one 8-byte load, each digit row's four digits in one
  // 4-byte store.
  constexpr int kQuads = kCols2 / 4, kRowStep = kConsumers / kQuads;
  constexpr int kRowsThread = kRowsA / kRowStep;
  const int n = n0 + 4 * (threadIdx.x % kQuads);
  const int r0 = r_lo + threadIdx.x / kQuads;
  const int a_lo = kmajor_col(n, s.rows1), a_hi = kmajor_col(s.N + n, s.rows1);
  ulonglong2 words[kRowsThread][2];
#pragma unroll
  for (int i = 0; i < kRowsThread; ++i)
    if (r0 + i * kRowStep < r_hi) {
      const ulonglong2* w = reinterpret_cast<const ulonglong2*>(
          acc + (long long)(rt * kRowsA + r0 + i * kRowStep) * s.N + n);
      words[i][0] = w[0];
      words[i][1] = w[1];
    }
#pragma unroll
  for (int i = 0; i < kRowsThread; ++i) {
    const int r = r0 + i * kRowStep;
    if (r >= r_hi) break;
    const int m2 = rt * kRowsA + r;
    const uint16_t* y = ys + r * kCols2 + n - n0;
    uint64_t yq[kMaxPrimes];  // four residues a prime
#pragma unroll
    for (int k = 0; k < kMaxPrimes; ++k) {
      if (k >= c.count) break;
      if constexpr (kSplit)
        yq[k] = sm90::ld_cluster_u64(y, k);
      else
        yq[k] = *reinterpret_cast<const uint64_t*>(y + k * kRowsA * kCols2);
    }
    const unsigned long long old[4] = {words[i][0].x, words[i][0].y,
                                       words[i][1].x, words[i][1].y};
    unsigned long long v[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      v[w] = (old[w] + crt_word(c, [&](int k) {
               return static_cast<int>((yq[k] >> (16 * w)) & 0xFFFF);
             })) & c.qmask;
    ulonglong2* out = reinterpret_cast<ulonglong2*>(acc + (long long)m2 * s.N + n);
    out[0] = make_ulonglong2(v[0], v[1]);
    out[1] = make_ulonglong2(v[2], v[3]);
    if (A != nullptr) decompose_store(v, m2, a_lo, a_hi, s, A);
  }
  if constexpr (kSplit) sm90::cluster_sync();  // none leaves while read
}

using ForwardKernel = void (*)(const int8_t*, const int8_t*, const int8_t*,
                               const int16_t*, const int32_t*, int, int, Shape,
                               RnsConsts, int8_t*);

static ForwardKernel forward_kernel(int kp1) {
  switch (kp1) {
    case 2: return br_forward_mac_kernel<2>;
    case 3: return br_forward_mac_kernel<3>;
    case 4: return br_forward_mac_kernel<4>;
    default: return br_forward_mac_kernel<5>;
  }
}

}  // namespace tfhe

using namespace tfhe;

// Runs n_steps CMux steps on acc [B][k+1][N] in place.  All pointers are
// device memory except the per-prime constant arrays (host).  fwd_tiles:
// the forward matrix as K1's B operand ([128 rows a 64-column tile: lo
// then hi][dn], k-major tiles); inv_tiles: per prime, the inverse matrix
// as K2's B operand ([64 rows a 32-coefficient tile][2N], k-major tiles).
// Scratch, zero-filled by the caller: A [rows1][dn] and X [P][rows2][2N],
// k-major tiles (rows1, rows2 as in Shape), each below 2^31 bytes.
// k2_cluster: 1 runs K2 a block a tile, n_primes a cluster of one block a
// prime a tile (ops/cuda_blind_rotate.py k2_cluster decides).  k1_blocks:
// 0 runs K1 a block a tile; else k1_persistent (csrc/blind_rotate_k1.cu
// tfhe_k1_persistent) runs the persistent K1 each step on that many blocks
// (one an SM), walking k1_rounds rounds with k1_stages A stages a
// warpgroup (ops/cuda_blind_rotate.py k1_persistent, walk_rounds,
// k1_stages).  Returns a cudaError_t (0 = ok).
extern "C" int tfhe_blind_rotate(
    long long* acc, const int32_t* tilde, int tstride, const int8_t* bsk,
    const int8_t* fwd_tiles, const int8_t* inv_tiles, const int16_t* rot,
    int8_t* A, int8_t* X, int B, int n_steps, int kp1, int N, int lev,
    int blog, int q, const int* primes, const unsigned* barrett_m,
    const unsigned* barrett_off, const unsigned long long* mk,
    const long long* fp, int n_primes, unsigned long long m, int k2_cluster,
    int k1_blocks, int k1_rounds, int k1_stages, void* k1_persistent,
    void* stream) {
  const int R = kp1 * lev;
  if (n_primes < 1 || n_primes > kMaxPrimes || R > 32 || N % 64 != 0 ||
      kp1 < 2 || kp1 > 5 || blog > 12 || B < 1 ||
      (k2_cluster != 1 && k2_cluster != n_primes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RnsConsts c =
      make_consts(primes, barrett_m, barrett_off, mk, fp, n_primes, m, q);

  Shape s{};
  s.B = B;
  s.J = kp1;
  s.N = N;
  s.PN = n_primes * N;
  s.R = R;
  s.rpad = R <= 16 ? 16 : 32;
  s.lev = lev;
  s.blog = blog;
  s.shift = q - blog * lev;
  s.wide = blog > 8;
  s.dn = s.wide ? 2 * N : N;
  const int nbits = kRowsA / s.rpad;
  s.rows1 = (B + nbits - 1) / nbits * kRowsA;
  s.rows2 = (B * kp1 + kRowsA - 1) / kRowsA * kRowsA;
  s.bp_rows = s.PN / kCols1 * kBN1;

  const ForwardKernel k1 = forward_kernel(kp1);
  const size_t smem1 = sm90::Ring<kBN1, kStages1>::kBytes +
                       (size_t)R * 2 * kp1 * kCols1 + 2 * kStages1 * 8;
  using InverseKernel = void (*)(const int8_t*, const int8_t*, Shape,
                                 RnsConsts, long long*, int8_t*);
  const bool split = k2_cluster > 1;
  const InverseKernel k2 = split ? br_inverse_crt_kernel<true>
                                 : br_inverse_crt_kernel<false>;
  const size_t smem2 = sm90::Ring<kBN2, kStages2>::kBytes +
                       (size_t)(split ? 1 : n_primes) * kRowsA * kCols2 * 2 +
                       2 * kStages2 * 8;
  const K1PersistentFn k1p = reinterpret_cast<K1PersistentFn>(k1_persistent);
  if (k1_blocks > 0 && k1p == nullptr) return (int)cudaErrorInvalidValue;
  TFHE_CHECK(raise_smem_limit((const void*)k1, smem1));
  TFHE_CHECK(raise_smem_limit((const void*)k2, smem2));
  const dim3 grid1(s.PN / kCols1, s.rows1 / kRowsA);
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k2_cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg2{};
  cfg2.gridDim = dim3(k2_cluster * (N / kCols2), s.rows2 / kRowsA);
  cfg2.blockDim = dim3(kThreads);
  cfg2.dynamicSmemBytes = smem2;
  cfg2.stream = st;
  cfg2.attrs = &cluster;
  cfg2.numAttrs = split ? 1 : 0;

  const long long words = (long long)B * kp1 * N;
  br_decompose_kernel<<<(unsigned)((words + 255) / 256), 256, 0, st>>>(acc, s,
                                                                       A);
  TFHE_CHECK(cudaGetLastError());
  for (int step = 0; step < n_steps; ++step) {
    if (k1_blocks > 0) {
      const int rc = k1p(A, fwd_tiles, bsk, rot, tilde, tstride, step, &s,
                         &c, k1_blocks, k1_rounds, k1_stages, X, stream);
      if (rc != 0) return rc;
    } else {
      k1<<<grid1, kThreads, smem1, st>>>(A, fwd_tiles, bsk, rot, tilde,
                                         tstride, step, s, c, X);
      TFHE_CHECK(cudaGetLastError());
    }
    TFHE_CHECK(cudaLaunchKernelEx(&cfg2, k2, X, inv_tiles, s, c, acc,
                                  step + 1 < n_steps ? A : nullptr));
  }
  return 0;
}
