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
//     stages (four in K1, three in K2) that one producer warp fills with
//     cp.async.bulk under mbarriers (sm90_gemm.cuh); two consumer
//     warpgroups do the math.  The
//     operands are stored in device memory in the tile order wgmma reads,
//     so each stage is one contiguous bulk copy.  What the epilogues read
//     besides (the BSK rows, the accumulator words, the masks) is fetched
//     with cp.async or plain loads issued before the product, so it lands
//     while the tensor cores run;
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
// tiles of one row tile together, so the A tile is read from L2.  A K2
// block owns 128 rows of (bit, GLWE component) and 32 output coefficients
// across all primes, two blocks an SM, so one block's epilogue overlaps
// the other's products and small batches still fill some of the card.
//
// Left for later: K1's epilogue (the residues, the MAC, the twiddle) costs
// about as much as its products at 4096 bits; L2 traffic does not bound it
// (clusters of two CTAs sharing the fwd tile through multicast copies gave
// the same words but ran slower).
// At small batches K2's few blocks each stream all primes in turn.  A
// persistent step loop or a CUDA graph of the 2n launches would remove the
// launch gaps.
//
// Exact by construction: the products are exact int32 sums, the reductions
// exact, and the CRT alpha uses the same 2^-40 fixed point as the plain
// version, so the words equal blind_rotate_plain's bit for bit.
#include "rns32.cuh"
#include "sm90_gemm.cuh"

namespace tfhe {

using sm90::kBK;
using sm90::kConsumers;
using sm90::kRowsA;
using sm90::kThreads;
using sm90::kmajor_col;
using sm90::kmajor_row;

// K1: 64 residue columns (+ their hi columns) a tile, four stages, two
// blocks an SM so that one block's epilogue overlaps the other's products.
constexpr int kCols1 = 64, kBN1 = 2 * kCols1, kStages1 = 4, kBlocks1 = 2;
constexpr int kBitStride1 = kConsumers / kCols1;
// K2: 32 output coefficients (+ their hi columns) a tile, three stages,
// two blocks an SM (~108 KB of shared memory each).
constexpr int kCols2 = 32, kBN2 = 2 * kCols2, kStages2 = 3, kBlocks2 = 2;
constexpr int kMaxBitsPerThread = kRowsA / 16 / kBitStride1;  // rpad 16

// The shapes of one rotate call.  Every scratch operand is below 2^31
// bytes (checked by the wrapper), so offsets into it are 32-bit.
struct Shape {
  int B, J, N, PN, R, rpad, lev, blog, shift, wide, dn;
  int rows1;    // digit rows: bits padded to 128 / rpad, x rpad
  int rows2;    // X rows a prime: B * J padded to 128
  int bp_rows;  // K1's B operand rows: 2 kCols1 a column tile
};

// Balanced gadget digits of one accumulator word (row m2 = b (k+1) + u of
// acc) into the digit rows b * rpad + u * lev + l of A; a_lo (a_hi) is the
// k-major column offset of the word's coefficient n (N + n: wide digits as
// two base-2^6 limbs).
__device__ __forceinline__ void decompose_store(unsigned long long v, int m2,
                                                int a_lo, int a_hi,
                                                const Shape& s,
                                                int8_t* __restrict__ A) {
  if (s.shift > 0) v = (v + (1ULL << (s.shift - 1))) >> s.shift;
  const int b = m2 / s.J;
  const int row0 = b * s.rpad + (m2 - b * s.J) * s.lev;
  const unsigned long long mask = (1ULL << s.blog) - 1;
  const unsigned long long half = 1ULL << (s.blog - 1);
  unsigned long long carry = 0;
  for (int l = s.lev - 1; l >= 0; --l) {
    const unsigned long long tv =
        ((v >> (s.blog * (s.lev - 1 - l))) & mask) + carry;
    carry = tv >= half ? 1 : 0;
    const int d = static_cast<int>(tv) - static_cast<int>(carry << s.blog);
    const int ro = kmajor_row(row0 + l);
    if (s.wide) {
      const int h6 = (d + 32) >> 6;
      A[a_lo + ro] = static_cast<int8_t>(d - (h6 << 6));
      A[a_hi + ro] = static_cast<int8_t>(h6);
    } else {
      A[a_lo + ro] = static_cast<int8_t>(d);
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
  decompose_store(static_cast<unsigned long long>(acc[i]), i / s.N,
                  kmajor_col(n, s.rows1), kmajor_col(s.N + n, s.rows1), s, A);
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
__global__ void __launch_bounds__(kThreads, kBlocks2)
br_inverse_crt_kernel(const int8_t* __restrict__ X,
                      const int8_t* __restrict__ inv, Shape s, RnsConsts c,
                      long long* __restrict__ acc, int8_t* __restrict__ A) {
  using Ring = sm90::Ring<kBN2, kStages2>;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ Prime32 sp[kMaxPrimes];
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + Ring::kBytes);
  long long* accs = reinterpret_cast<long long*>(
      smem + Ring::kBytes + c.count * kRowsA * kCols2 * 2);  // [128][32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(accs + kRowsA * kCols2);
  Ring ring{smem, bars, bars + kStages2};
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int n0 = ct * kCols2;
  const int n_kb = 2 * s.N / kBK;
  const long long x_prime = (long long)s.rows2 * 2 * s.N;
  const long long inv_prime = 4LL * s.N * s.N;
  const int mrows = s.B * s.J;

  if (threadIdx.x < c.count) sp[threadIdx.x] = c.pr[threadIdx.x];
  if (threadIdx.x == 0) {
    ring.init();
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    if ((threadIdx.x & 31) == 0)
      ring.produce(c.count * n_kb,
                   [&](int i, const int8_t*& a, const int8_t*& b) {
                     const int k = i / n_kb, kb = i % n_kb;
                     a = X + k * x_prime +
                         ((long long)kb * s.rows2 + rt * kRowsA) * kBK;
                     b = inv + k * inv_prime +
                         ((long long)kb * 2 * s.N + ct * kBN2) * kBK;
                   });
    return;
  }

  // This block's accumulator words land in shared memory during the
  // products.
  for (int i = threadIdx.x; i < kRowsA * kCols2 / 2; i += kConsumers) {
    const int r = i / (kCols2 / 2), cc = (i % (kCols2 / 2)) * 2;
    if (rt * kRowsA + r < mrows)
      sm90::cp_async16(accs + r * kCols2 + cc,
                       acc + (long long)(rt * kRowsA + r) * s.N + n0 + cc);
  }
  sm90::cp_async_commit();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  int d[kBN2 / 2];
  ring.consume(c.count * n_kb, n_kb, d, [&](int k) {
    const Prime32 q = sp[k];
    uint16_t* yk = ys + k * kRowsA * kCols2;
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
  sm90::cp_async_wait_all();
  sm90::consumers_sync();

  // Explicit CRT: x = sum_k y_k (M/p_k) - alpha M, alpha from 2^-40 fixed
  // point; thread -> coefficient t % kCols2, rows t / kCols2 + step * i.
  constexpr int kRowStep = kConsumers / kCols2;
  const int col = threadIdx.x % kCols2;
  const int n = n0 + col;
  const int a_lo = kmajor_col(n, s.rows1), a_hi = kmajor_col(s.N + n, s.rows1);
#pragma unroll 4
  for (int i = 0; i < kRowsA / kRowStep; ++i) {
    const int r = threadIdx.x / kCols2 + kRowStep * i;
    const int m2 = rt * kRowsA + r;
    if (m2 >= mrows) continue;
    const unsigned long long x = crt_word(
        c, [&](int k) { return ys[(k * kRowsA + r) * kCols2 + col]; });
    const unsigned long long v =
        (static_cast<unsigned long long>(accs[r * kCols2 + col]) + x) & c.qmask;
    acc[(long long)m2 * s.N + n] = static_cast<long long>(v);
    if (A != nullptr) decompose_store(v, m2, a_lo, a_hi, s, A);
  }
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
// Returns a cudaError_t (0 = ok).
extern "C" int tfhe_blind_rotate(
    long long* acc, const int32_t* tilde, int tstride, const int8_t* bsk,
    const int8_t* fwd_tiles, const int8_t* inv_tiles, const int16_t* rot,
    int8_t* A, int8_t* X, int B, int n_steps, int kp1, int N, int lev,
    int blog, int q, const int* primes, const unsigned* barrett_m,
    const unsigned* barrett_off, const unsigned long long* mk,
    const long long* fp, int n_primes, unsigned long long m, void* stream) {
  const int R = kp1 * lev;
  if (n_primes < 1 || n_primes > kMaxPrimes || R > 32 || N % 64 != 0 ||
      kp1 < 2 || kp1 > 5 || blog > 12 || B < 1)
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
  const size_t smem2 = sm90::Ring<kBN2, kStages2>::kBytes +
                       (size_t)n_primes * kRowsA * kCols2 * 2 +
                       (size_t)kRowsA * kCols2 * 8 + 2 * kStages2 * 8;
  TFHE_CHECK(cudaFuncSetAttribute(k1,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem1));
  TFHE_CHECK(cudaFuncSetAttribute(br_inverse_crt_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem2));
  const dim3 grid1(s.PN / kCols1, s.rows1 / kRowsA);
  const dim3 grid2(N / kCols2, s.rows2 / kRowsA);

  const long long words = (long long)B * kp1 * N;
  br_decompose_kernel<<<(unsigned)((words + 255) / 256), 256, 0, st>>>(acc, s,
                                                                       A);
  TFHE_CHECK(cudaGetLastError());
  for (int step = 0; step < n_steps; ++step) {
    k1<<<grid1, kThreads, smem1, st>>>(A, fwd_tiles, bsk, rot, tilde, tstride,
                                       step, s, c, X);
    TFHE_CHECK(cudaGetLastError());
    br_inverse_crt_kernel<<<grid2, kThreads, smem2, st>>>(
        X, inv_tiles, s, c, acc, step + 1 < n_steps ? A : nullptr);
    TFHE_CHECK(cudaGetLastError());
  }
  return 0;
}
