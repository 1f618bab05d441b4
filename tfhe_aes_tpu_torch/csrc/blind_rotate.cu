// Blind rotation on Hopper: the whole n-step CMux loop of one PBS batch.
//
// Replaces the Pallas TPU kernel tfhe_aes_tpu/ops/pallas_blind_rotate.py
// (_kernel, built by _build_call, driven by blind_rotate_pallas).  Same
// mathematics in the mod-2^q' rotate domain (q' = 48): per BSK step s
//   1. balanced gadget decomposition of the accumulator (12-bit digits as
//      two base-2^6 int8 limbs on the wide path);
//   2. one int8 tensor-core product against the prime-merged forward NTT
//      matrix fwd_cat, recombined to balanced residues in its epilogue;
//   3. the external-product MAC against the step's BSK limb rows, then the
//      twiddle (psi^(a_s (2j+1)) - 1) gathered from rot_table by the
//      mod-switched mask a_s, written as int8 limbs;
//   4. per-prime int8 tensor-core inverse-NTT products (n^-1 and the CRT
//      premultiplier folded in) -> canonical residues;
//   5. explicit CRT and acc += delta (mod 2^q').
// Setup (mod-switch, X^-b~ * test, rounding to q') and the final rescale to
// 2^64 stay in the Python wrapper (ops/cuda_blind_rotate.py).
//
// What bounds it on this card: the forward product, 2*(15B)*1024*5120 int8
// operations per step at PARAM_TPU (B bits), is ~70% of the work; the
// inverse products are ~25%.  Both run on the tensor cores through
// mma.sync.m16n8k32 from shared-memory tiles.  Between the launches the
// accumulator and the per-step intermediates (residues as int32) go through
// device memory: ~0.27 MB per bit per step, which at the main path's
// batches stays below the products' time.  Later work: wgmma/TMA tiles and
// an accumulator resident in shared memory across steps.
//
// Exact by construction: every reduction is integer % on int32/int64, the
// CRT alpha uses the same fixed point as the plain version, so the words
// equal blind_rotate_plain's bit for bit.
#include "common.cuh"

namespace tfhe {

// acc [B][kp1][N] (mod 2^q) -> A rows (b*kp1 + u)*lev + l, dn columns.
__global__ void br_decompose_kernel(const long long* __restrict__ acc,
                                    long long count, int N, int lev, int blog,
                                    int shift, int wide,
                                    int8_t* __restrict__ A) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long bu = i / N;
  const int n = static_cast<int>(i % N);
  unsigned long long v = static_cast<unsigned long long>(acc[i]);
  if (shift > 0) v = (v + (1ULL << (shift - 1))) >> shift;
  const unsigned long long mask = (1ULL << blog) - 1;
  const unsigned long long half = 1ULL << (blog - 1);
  const int dn = wide ? 2 * N : N;
  unsigned long long carry = 0;
  for (int l = lev - 1; l >= 0; --l) {
    const unsigned long long tv = ((v >> (blog * (lev - 1 - l))) & mask) + carry;
    carry = tv >= half ? 1 : 0;
    const int d = static_cast<int>(tv) - static_cast<int>(carry << blog);
    int8_t* row = A + (bu * lev + l) * dn;
    if (wide) {
      const int h6 = (d + 32) >> 6;
      row[n] = static_cast<int8_t>(d - (h6 << 6));
      row[N + n] = static_cast<int8_t>(h6);
    } else {
      row[n] = static_cast<int8_t>(d);
    }
  }
}

// MAC against the step's BSK rows + twiddle, one thread per (b, lane c).
// dh [B*R][PN] balanced; g [R*2J][PN] int8 limbs; rot [2N][PN] int16;
// X [P][B*J][2N] int8 limbs of delta_hat.
template <int J>
__global__ void br_mac_twiddle_kernel(const int32_t* __restrict__ dh,
                                      const int8_t* __restrict__ g,
                                      const int16_t* __restrict__ rot,
                                      const int32_t* __restrict__ tilde,
                                      int tstride, int step, int B, int R,
                                      int N, int PN, Primes pr,
                                      int8_t* __restrict__ X) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)B * PN) return;
  const int c = static_cast<int>(i % PN);
  const int b = static_cast<int>(i / PN);
  const int k = c / N, n = c % N;
  const int p = pr.p[k];
  // |d| <= p/2 < 2^15, |limb| <= 128, R <= 25 terms: |s| < 2^27.
  int s_lo[J], s_hi[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s_lo[j] = s_hi[j] = 0;
  for (int r = 0; r < R; ++r) {
    const int d = dh[((long long)b * R + r) * PN + c];
    const int8_t* gr = g + (long long)r * 2 * J * PN + c;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s_lo[j] += d * gr[(long long)j * PN];
      s_hi[j] += d * gr[(long long)(J + j) * PN];
    }
  }
  const int a = tilde[(long long)b * tstride + step];
  const long long tw1 = static_cast<long long>(rot[(long long)a * PN + c]) - 1;
  const long long xrows = (long long)B * J;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int prod = (s_lo[j] + 256 * (s_hi[j] % p)) % p;
    const int delta = bal_mod(tw1 * prod, p);
    put_limbs(X + ((long long)k * xrows + (long long)b * J + j) * 2 * N + n,
              N, delta);
  }
}

template <int J>
static cudaError_t launch_mac(const int32_t* dh, const int8_t* g,
                              const int16_t* rot, const int32_t* tilde,
                              int tstride, int step, int B, int R, int N,
                              int PN, const Primes& pr, int8_t* X,
                              cudaStream_t s) {
  const long long count = (long long)B * PN;
  br_mac_twiddle_kernel<J><<<(count + 255) / 256, 256, 0, s>>>(
      dh, g, rot, tilde, tstride, step, B, R, N, PN, pr, X);
  return cudaGetLastError();
}

}  // namespace tfhe

using namespace tfhe;

#define TFHE_CHECK(call)                  \
  do {                                    \
    const cudaError_t e_ = (call);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Runs n_steps CMux steps on acc in place.  All pointers are device memory
// except the per-prime constant arrays (host).  Scratch: A [B*R][dn] int8,
// dh [B*R][PN] int32, X [P][B*kp1][2N] int8, Y [P][B*kp1][N] int32.
// fwd_t = fwd_cat transposed [2*PN][dn]; inv_t = inv_crt_full with each
// prime's matrix transposed [P][2N][2N].  Returns a cudaError_t (0 = ok).
extern "C" int tfhe_blind_rotate(
    long long* acc, const int32_t* tilde, int tstride, const int8_t* bsk,
    const int8_t* fwd_t, const int8_t* inv_t, const int16_t* rot,
    int8_t* A, int32_t* dh, int8_t* X, int32_t* Y,
    int B, int n_steps, int kp1, int N, int lev, int blog, int q,
    const int* primes, const unsigned long long* mk, const long long* fp,
    int n_primes, unsigned long long m, void* stream) {
  if (n_primes > kMaxPrimes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Primes pr = make_primes(primes, mk, fp, n_primes, m);
  const int R = kp1 * lev;
  const int PN = n_primes * N;
  const int wide = blog > 8;
  const int dn = wide ? 2 * N : N;
  const int shift = q - blog * lev;
  const unsigned long long qmask = q >= 64 ? ~0ULL : (1ULL << q) - 1;
  const long long acc_count = (long long)B * kp1 * N;
  const long long step_rows = (long long)R * 2 * kp1 * PN;
  for (int step = 0; step < n_steps; ++step) {
    br_decompose_kernel<<<(acc_count + 255) / 256, 256, 0, s>>>(
        acc, acc_count, N, lev, blog, shift, wide, A);
    TFHE_CHECK(cudaGetLastError());
    TFHE_CHECK(gemm_pair(A, 0, fwd_t, 0, B * R, dn, PN, N, 1, pr, 0, dh, 0,
                         s));
    const int8_t* g = bsk + step * step_rows;
    switch (kp1) {
      case 2: TFHE_CHECK(launch_mac<2>(dh, g, rot, tilde, tstride, step, B, R,
                                       N, PN, pr, X, s)); break;
      case 3: TFHE_CHECK(launch_mac<3>(dh, g, rot, tilde, tstride, step, B, R,
                                       N, PN, pr, X, s)); break;
      case 4: TFHE_CHECK(launch_mac<4>(dh, g, rot, tilde, tstride, step, B, R,
                                       N, PN, pr, X, s)); break;
      case 5: TFHE_CHECK(launch_mac<5>(dh, g, rot, tilde, tstride, step, B, R,
                                       N, PN, pr, X, s)); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const long long m2 = (long long)B * kp1;
    TFHE_CHECK(gemm_pair(X, m2 * 2 * N, inv_t, 4LL * N * N, (int)m2, 2 * N, N,
                         N, n_primes, pr, 1, Y, m2 * N, s));
    TFHE_CHECK(crt_accumulate(Y, acc_count, pr, qmask, acc, s));
  }
  return 0;
}
