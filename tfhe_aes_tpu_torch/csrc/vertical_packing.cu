// Vertical-packing CMux rotations on Hopper: three launches a selector bit.
//
// Replaces the Pallas TPU kernel tfhe_aes_tpu/ops/pallas_vp.py (_kernel,
// built by _build_call, driven by vp_rotations_pallas).  Same mathematics
// in the mod-2^64 torus domain, for every (byte, LUT output) accumulator,
// over the nbits selector bits LSB first.  Per bit s (static roll c = 2^s):
//   digits  diff = X^(-c) * acc - acc (negacyclic roll), one balanced
//           base-2^15 digit a word (cbs_level == 1), split into two int8
//           limbs d = lo + 256 hi -> the digit operand A [rows, 2N];
//   V1      the forward NTT as one int8 product A x fwd [2N, lo | hi residue
//           columns], the balanced residues lo + 256 hi, and the MAC of each
//           accumulator's k+1 digit rows against its byte's GGSW rows -> X,
//           the int8 limbs of delta_hat [P][accumulators x (k+1)][2N];
//   V2      the P per-prime inverse NTT products X_k x inv_k (n^-1 and the
//           CRT premultiplier folded in), the canonical residues, the
//           explicit CRT, acc += delta (mod 2^64).
//
// The bound.  At PARAM_TPU (k+1 = 5, N = 512, 6 primes) one bit on M =
// bytes x LUT outputs x 5 digit rows does
//   forward  2 * M * 1024 * 6144 = 12.6 M * M int8 operations,
//   inverse  2 * M * 1024 * 1024 * 6 = 12.6 M * M,
// 0.78 ms a bit at 512 bytes x 24 outputs (M = 61440) at the 1979 TOPS int8
// peak.  Its device traffic is the digits A (2N bytes a row, written and
// read), X (6 * 2N bytes a row, both ways), acc (8 bytes a word, read twice,
// written once) and the bit's GGSW (6 * 25 * N int32 a byte): ~1.6 GB a bit
// at that shape, ~0.5 ms at 3.35 TB/s.  So a bit is bound by the products'
// operations.  (The TPU kernel splits the digit into three base-2^5 limbs,
// 3N deep; two int8 limbs are a third fewer operations and operand bytes,
// and lo + 256 hi still fits one reduction.)
//
// What the design does about what held the previous five-launch version
// (mma.sync products from registers, int32 dh and Y through device memory,
// a 64-bit % for every residue) back: both products run on wgmma.mma_async
// from the cp.async.bulk ring of sm90_gemm.cuh, their operands stored in
// device memory in the k-major tile order, as in the blind rotate
// (blind_rotate.cu).  The forward residues dh live only in V1's shared
// memory between its product and its MAC, the inverse residues Y only in
// V2's between its products and the CRT.  Every reduction is the 32-bit
// Barrett step of rns32.cuh; each site's input range is derived in
// ops/cuda_vp.py, which refuses a shape outside it:
//   forward  N lo and N hi limbs of a digit (|lo| <= 128, |hi| <= 64)
//            against |lo| <= 128, |hi| <= 80: lo + 256 hi < 2^31 - 2^16 at
//            N = 512, reduced once;
//   MAC      k+1 terms of two balanced residues, (k+1) ((p-1)/2)^2 <
//            2^31 - 2^16 for p <= 40961: summed in int32 as they are,
//            reduced once (no limb split of the GGSW);
//   inverse  2N terms of int8 x int8; hi brought into (-p, 2p) by
//            reduce_partial before lo + 256 hi is reduced.
//
// Row grouping.  An accumulator has only k+1 digit rows and its MAC must
// not leave the block, so whole accumulators are packed densely into the
// 128-row digit tiles: 128 / (k+1) accumulators a tile (25 of 5 rows, 125
// of 128 rows used), the rest of the tile zero.  X's rows stay dense,
// accumulator * (k+1) + component, as acc's.  The GGSW operand belongs to
// the byte, not to the batch: a tile's accumulators span a few bytes
// (`span`, 2 at 24 LUT outputs, 4 at 8), whose (k+1)^2 rows at the block's
// 64 columns land in shared memory by cp.async under the product.
//
// A V1 block owns 128 digit rows and 64 residue columns with their paired
// hi columns, four stages, two blocks an SM (the wrapper caps `span` so
// that two fit).  Its residues go to shared memory in rows padded to 72 so
// that the fragment stores hit 32 banks; in the MAC a thread walks a run of
// consecutive accumulators and keeps the byte's (k+1)^2 GGSW words in
// registers until the byte changes.
// A V2 block owns 128 X rows and 64 coefficients across all primes, alone
// on its SM: with six primes its residues take 96 KB (their 8-column groups
// exchanged by the row's low bits, for the same reason as the padding),
// which leaves the ring eight stages because the accumulator tile (64 KB)
// is fetched into the ring's own memory once the last product has been
// read, under the last residue pass.
//
// What scripts/vp_stage_cut.py measured on an NVIDIA H100 80GB HBM3 at
// 700 W, 512 bytes x 24 outputs x 8 bits (a call's 8 launches of each
// kernel summed): digits 1.1 ms, V1 10.0 ms, V2 10.7 ms.  With every
// epilogue cut out the products alone take 4.9 ms (V1) and 6.2 ms (V2); V1
// without its product 3.9 ms, V2 without its products 3.1 ms.  So in both
// kernels the products and the epilogues add up rather than overlap, also
// with two blocks an SM: V1 alone on its SM takes 13.3 ms, but starting the
// second block of each SM a third of a block's life late changes nothing
// (10.1 ms), and V2 on 32-coefficient tiles with two blocks an SM takes
// 13.1 ms.  The card draws 686 to 698 W at 1530 to 1770 of its 1980 MHz
// while the kernel runs back to back.  V2 keeps a second wgmma group in
// flight (Ring::consume_pipelined; 12.7 ms with one): alone on its SM its
// two warpgroups otherwise let the tensor cores drain between stages.  V1
// does not: that loop made it spill (see sm90_gemm.cuh), and with four
// warpgroups an SM its products gained nothing.  Reducing one prime's
// residues from a second accumulator set under the next prime's product
// was slower and did not stay.
//
// The digits stay a launch of their own: the roll reaches up to N/4
// coefficients away, across V2's 64-coefficient column tiles, so the next
// bit's diff cannot be formed in V2's epilogue the way the blind rotate
// forms its next digits.
//
// Exact by construction, so the words equal vp_rotations_plain's.
#include "rns32.cuh"
#include "sm90_gemm.cuh"

namespace tfhe {

using sm90::kBK;
using sm90::kConsumers;
using sm90::kRowsA;
using sm90::kThreads;
using sm90::kmajor_col;
using sm90::kmajor_row;

constexpr int kCols1 = 64, kBN1 = 2 * kCols1, kStages1 = 4, kBlocks1 = 2;
constexpr int kRuns1 = kConsumers / kCols1;  // accumulator runs of the MAC
constexpr int kDhStride = kCols1 + 8;        // int16 a row of dh, padded
constexpr int kCols2 = 64, kBN2 = 2 * kCols2, kStages2 = 8, kBlocks2 = 1;
// Dynamic shared memory of a block when two share an SM (228 KB an SM,
// 1 KB reserved a block).
constexpr int kSmemTwoBlocks = 112 * 1024;

// The shapes of one call.  Every scratch operand is below 2^31 bytes
// (checked by the wrapper), so offsets into it are 32-bit.
struct VpShape {
  int B, L, J, N, PN, blog;
  int accs;     // B * L accumulators
  int group;    // accumulators a 128-row digit tile: 128 / J
  int span;     // bytes whose GGSW rows a V1 block stages
  int rows1;    // digit rows: 128 a group of accumulators
  int rows2;    // X rows a prime: accs * J padded to 128
  int bp_rows;  // V1's B operand rows: 2 kCols1 a column tile
};

// The digits of X^(-c) * acc - acc: one thread per four consecutive words
// of a row (row m = accumulator * J + component of acc, below 2^31 words),
// so that each limb leaves as one 32-bit store into its 16-byte run of A.
// N % 4 == 0; a roll by a multiple of 4 wraps all four words together.
__global__ void vp_digits_kernel(const long long* __restrict__ acc, VpShape s,
                                 int c, int8_t* __restrict__ A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = s.N / 4;
  if (i >= s.accs * s.J * quads) return;
  const int n = (i % quads) * 4, m = i / quads;
  const unsigned long long* row =
      reinterpret_cast<const unsigned long long*>(acc) + (long long)m * s.N;
  unsigned long long w[4], r[4];
  *reinterpret_cast<ulonglong2*>(w) =
      *reinterpret_cast<const ulonglong2*>(row + n);
  *reinterpret_cast<ulonglong2*>(w + 2) =
      *reinterpret_cast<const ulonglong2*>(row + n + 2);
  if ((c & 3) == 0) {
    const bool wrap = n + c >= s.N;
    const unsigned long long* src = row + (wrap ? n + c - s.N : n + c);
    *reinterpret_cast<ulonglong2*>(r) =
        *reinterpret_cast<const ulonglong2*>(src);
    *reinterpret_cast<ulonglong2*>(r + 2) =
        *reinterpret_cast<const ulonglong2*>(src + 2);
    if (wrap) {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = 0ULL - r[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = n + j + c < s.N ? row[n + j + c] : 0ULL - row[n + j + c - s.N];
  }
  const int dshift = 64 - s.blog;
  uint32_t lo4 = 0, hi4 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned long long diff = r[j] - w[j];
    const unsigned long long vbar =
        (diff + (1ULL << (dshift - 1))) >> dshift;
    const int raw = static_cast<int>(vbar & ((1ULL << s.blog) - 1));
    const int carry = raw >= (1 << (s.blog - 1)) ? 1 : 0;
    const int d = raw - (carry << s.blog);
    const int h8 = (d + 128) >> 8;
    lo4 |= static_cast<uint32_t>((d - (h8 << 8)) & 0xFF) << (8 * j);
    hi4 |= static_cast<uint32_t>(h8 & 0xFF) << (8 * j);
  }
  const int a = m / s.J;
  const int tile = a / s.group;
  const int ro =
      kmajor_row(tile * kRowsA + (a - tile * s.group) * s.J + (m - a * s.J));
  *reinterpret_cast<uint32_t*>(A + kmajor_col(n, s.rows1) + ro) = lo4;
  *reinterpret_cast<uint32_t*>(A + kmajor_col(s.N + n, s.rows1) + ro) = hi4;
}

// V1: forward product + residues + MAC -> X, for one group of accumulators
// (128 digit rows) x 64 residue columns, all of one prime (N % 64 == 0).
// G: this bit's GGSW [P][B][J][J][N] balanced int32.
template <int J>
__global__ void __launch_bounds__(kThreads, kBlocks1)
vp_forward_mac_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ fwd,
                      const int32_t* __restrict__ G, VpShape s, RnsConsts c,
                      int8_t* __restrict__ X) {
  using Ring = sm90::Ring<kBN1, kStages1>;
  extern __shared__ __align__(1024) uint8_t smem[];
  int32_t* gs = reinterpret_cast<int32_t*>(smem + Ring::kBytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(gs + s.span * J * J * kCols1);
  Ring ring{smem, bars, bars + kStages1};
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int c0 = ct * kCols1;
  const int n_kb = 2 * s.N / kBK;
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

  // While the product runs: the GGSW rows of the bytes this group's
  // accumulators belong to, at this block's columns, land in shared memory
  // as [byte - b0][u * J + j][64].  In G the rows of consecutive bytes
  // follow each other, N words apart.
  const int a0 = rt * s.group;
  const int b0 = a0 / s.L;
  const int n0 = c0 - k * s.N;
  const int32_t* g = G + ((long long)k * s.B + b0) * J * J * s.N + n0;
  const int g_rows = min(s.span, s.B - b0) * J * J;
  for (int i = threadIdx.x; i < g_rows * (kCols1 / 4); i += kConsumers) {
    const int r = i / (kCols1 / 4), cc = (i % (kCols1 / 4)) * 4;
    sm90::cp_async16(gs + r * kCols1 + cc, g + (long long)r * s.N + cc);
  }
  sm90::cp_async_commit();

  int d[kBN1 / 2];
  ring.consume(n_kb, n_kb, d, [](int) {});

  // Residues dh = lo + 256 hi (mod p, balanced) into shared memory, over
  // the ring (every wgmma of both warpgroups has completed).
  sm90::consumers_sync();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  int16_t* dh = reinterpret_cast<int16_t*>(smem);  // [128 rows][kDhStride]
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
      *reinterpret_cast<uint32_t*>(dh + row * kDhStride + col0) =
          pack16(v0, v1);
    }
  }
  sm90::cp_async_wait_all();
  sm90::consumers_sync();

  // MAC of each accumulator's J digit rows against its byte's rows; thread
  // -> column t % kCols1 and the t / kCols1-th run of the tile's
  // accumulators.  |sum| <= J ((p-1)/2)^2 (checked by the wrapper).
  const int col = threadIdx.x % kCols1;
  const int n = n0 + col;
  int8_t* xk = X + (long long)k * s.rows2 * 2 * s.N;
  const int x_lo = kmajor_col(n, s.rows2), x_hi = kmajor_col(s.N + n, s.rows2);
  const int per = (s.group + kRuns1 - 1) / kRuns1;
  const int gl0 = (threadIdx.x / kCols1) * per;
  const int gl1 = min(min(gl0 + per, s.group), s.accs - a0);
  int gr[J * J];
  int left = 0;  // accumulators left of the byte whose rows gr holds
  for (int gl = gl0; gl < gl1; ++gl) {
    const int a = a0 + gl;
    if (left == 0) {
      const int byte = a / s.L;
      left = (byte + 1) * s.L - a;
      const int32_t* gb = gs + (byte - b0) * J * J * kCols1 + col;
#pragma unroll
      for (int i = 0; i < J * J; ++i) gr[i] = gb[i * kCols1];
    }
    --left;
    int dv[J];
#pragma unroll
    for (int u = 0; u < J; ++u) dv[u] = dh[(gl * J + u) * kDhStride + col];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int sum = 0;
#pragma unroll
      for (int u = 0; u < J; ++u) sum += dv[u] * gr[u * J + j];
      const int delta = reduce_balanced(sum, q);
      const int h8 = (delta + 128) >> 8;
      const int ro = kmajor_row(a * J + j);
      xk[x_lo + ro] = static_cast<int8_t>(delta - (h8 << 8));
      xk[x_hi + ro] = static_cast<int8_t>(h8);
    }
  }
}

// Where column `col` of row `row` sits in a kCols2-column uint16 row of
// V2's residues: the 8-column groups are exchanged by the row's low bits,
// so that the eight rows of a wgmma fragment store hit 32 different banks.
__device__ __forceinline__ int ys_col(int row, int col) {
  return col ^ (((row * kCols2 / 64) & (kCols2 / 8 - 1)) << 3);
}

// V2: per-prime inverse products -> canonical residues (shared memory) ->
// CRT -> acc += delta (mod 2^64), for 128 rows of acc x 64 coefficients.
__global__ void __launch_bounds__(kThreads, kBlocks2)
vp_inverse_crt_kernel(const int8_t* __restrict__ X,
                      const int8_t* __restrict__ inv, VpShape s, RnsConsts c,
                      long long* __restrict__ acc) {
  using Ring = sm90::Ring<kBN2, kStages2>;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ Prime32 sp[kMaxPrimes];
  static_assert(kRowsA * kCols2 * 8 <= Ring::kBytes, "acc tile in the ring");
  long long* accs = reinterpret_cast<long long*>(smem);  // [128][64], late
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + Ring::kBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ys + c.count * kRowsA * kCols2);
  Ring ring{smem, bars, bars + kStages2};
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int n0 = ct * kCols2;
  const int n_kb = 2 * s.N / kBK;
  const long long x_prime = (long long)s.rows2 * 2 * s.N;
  const long long inv_prime = 4LL * s.N * s.N;
  const int mrows = s.accs * s.J;

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

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  int d[kBN2 / 2];
  ring.consume_pipelined(c.count * n_kb, n_kb, d, [&](int k) {
    if (k == c.count - 1) {
      // Both warpgroups have read the last stage: this block's accumulator
      // words land over the ring during the last residue pass.
      sm90::consumers_sync();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = threadIdx.x; i < kRowsA * kCols2 / 2; i += kConsumers) {
        const int r = i / (kCols2 / 2), cc = (i % (kCols2 / 2)) * 2;
        if (rt * kRowsA + r < mrows)
          sm90::cp_async16(accs + r * kCols2 + cc,
                           acc + (long long)(rt * kRowsA + r) * s.N + n0 + cc);
      }
      sm90::cp_async_commit();
    }
    const Prime32 q = sp[k];
    uint16_t* yk = ys + k * kRowsA * kCols2;
#pragma unroll
    for (int n8 = 0; n8 < kCols2 / 8; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        const int col0 = ys_col(row, n8 * 8 + (lane & 3) * 2);
        const int e = n8 * 4 + 2 * h, eh = e + kCols2 / 2;
        const int y0 = reduce_canonical(d[e] + 256 * reduce_partial(d[eh], q), q);
        const int y1 =
            reduce_canonical(d[e + 1] + 256 * reduce_partial(d[eh + 1], q), q);
        *reinterpret_cast<uint32_t*>(yk + row * kCols2 + col0) = pack16(y0, y1);
      }
  });
  sm90::cp_async_wait_all();
  sm90::consumers_sync();

  // Thread -> coefficient t % kCols2, rows t / kCols2 + step * i.
  constexpr int kRowStep = kConsumers / kCols2;
  const int col = threadIdx.x % kCols2;
#pragma unroll 4
  for (int i = 0; i < kRowsA / kRowStep; ++i) {
    const int r = threadIdx.x / kCols2 + kRowStep * i;
    const int m2 = rt * kRowsA + r;
    if (m2 >= mrows) continue;
    const int ycol = ys_col(r, col);
    const unsigned long long x = crt_word(
        c, [&](int k) { return ys[(k * kRowsA + r) * kCols2 + ycol]; });
    acc[(long long)m2 * s.N + n0 + col] = static_cast<long long>(
        static_cast<unsigned long long>(accs[r * kCols2 + col]) + x);
  }
}

using ForwardKernel = void (*)(const int8_t*, const int8_t*, const int32_t*,
                               VpShape, RnsConsts, int8_t*);

static ForwardKernel forward_kernel(int kp1) {
  switch (kp1) {
    case 2: return vp_forward_mac_kernel<2>;
    case 3: return vp_forward_mac_kernel<3>;
    case 4: return vp_forward_mac_kernel<4>;
    default: return vp_forward_mac_kernel<5>;
  }
}

}  // namespace tfhe

using namespace tfhe;

// Runs the nbits CMux rotations on acc [B][L][kp1][N] in place.  All
// pointers are device memory except the per-prime constant arrays (host).
// ggsw [nbits][P][B][kp1][kp1][N] int32, LSB first.  fwd_tiles: the forward
// matrix of two-limb digits (ops/cuda_vp.py, forward_matrix) as V1's B
// operand ([128 rows a 64-column tile: lo then hi][2N], k-major tiles);
// inv_tiles: per prime, vp_inv_full as V2's B operand ([64 rows a
// 64-coefficient tile][2N], k-major tiles).  Scratch, zero-filled by the
// caller: A [rows1][2N] and X [P][rows2][2N], k-major tiles (rows1, rows2
// as in VpShape), each below 2^31 bytes.  Returns a cudaError_t (0 = ok).
extern "C" int tfhe_vp_rotations(
    long long* acc, const int32_t* ggsw, const int8_t* fwd_tiles,
    const int8_t* inv_tiles, int8_t* A, int8_t* X, int B, int L, int nbits,
    int kp1, int N, int blog, const int* primes, const unsigned* barrett_m,
    const unsigned* barrett_off, const unsigned long long* mk,
    const long long* fp, int n_primes, unsigned long long m, void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || N % 64 != 0 || kp1 < 2 ||
      kp1 > 5 || blog < 2 || blog > 15 || B < 1 || L < 1 || (1 << nbits) > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RnsConsts c =
      make_consts(primes, barrett_m, barrett_off, mk, fp, n_primes, m, 64);

  VpShape s{};
  s.B = B;
  s.L = L;
  s.J = kp1;
  s.N = N;
  s.PN = n_primes * N;
  s.blog = blog;
  s.accs = B * L;
  s.group = kRowsA / kp1;
  s.span = (s.group + L - 2) / L + 1;
  if (s.span > B) s.span = B;
  s.rows1 = (s.accs + s.group - 1) / s.group * kRowsA;
  s.rows2 = (s.accs * kp1 + kRowsA - 1) / kRowsA * kRowsA;
  s.bp_rows = s.PN / kCols1 * kBN1;

  const ForwardKernel v1 = forward_kernel(kp1);
  const size_t smem1 = sm90::Ring<kBN1, kStages1>::kBytes +
                       (size_t)s.span * kp1 * kp1 * kCols1 * 4 +
                       2 * kStages1 * 8;
  const size_t smem2 = sm90::Ring<kBN2, kStages2>::kBytes +
                       (size_t)n_primes * kRowsA * kCols2 * 2 +
                       2 * kStages2 * 8;
  if (smem1 > kSmemTwoBlocks) return (int)cudaErrorInvalidValue;
  TFHE_CHECK(cudaFuncSetAttribute(v1,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem1));
  TFHE_CHECK(cudaFuncSetAttribute(vp_inverse_crt_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem2));
  const dim3 grid1(s.PN / kCols1, s.rows1 / kRowsA);
  const dim3 grid2(N / kCols2, s.rows2 / kRowsA);
  const long long quads = (long long)s.accs * kp1 * N / 4;
  const long long bit_words = (long long)n_primes * B * kp1 * kp1 * N;
  for (int bit = 0; bit < nbits; ++bit) {
    vp_digits_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
        acc, s, 1 << bit, A);
    TFHE_CHECK(cudaGetLastError());
    v1<<<grid1, kThreads, smem1, st>>>(A, fwd_tiles, ggsw + bit * bit_words,
                                       s, c, X);
    TFHE_CHECK(cudaGetLastError());
    vp_inverse_crt_kernel<<<grid2, kThreads, smem2, st>>>(X, inv_tiles, s, c,
                                                          acc);
    TFHE_CHECK(cudaGetLastError());
  }
  return 0;
}
