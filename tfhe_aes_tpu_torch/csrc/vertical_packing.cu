// Vertical-packing CMux rotations on Hopper.
//
// Replaces the Pallas TPU kernel tfhe_aes_tpu/ops/pallas_vp.py (_kernel,
// built by _build_call, driven by vp_rotations_pallas).  Same mathematics
// in the mod-2^64 torus domain, for every (byte, LUT output) accumulator,
// over the nbits selector bits LSB first.  Per bit s (static roll 2^s):
//   1. rotated = X^(-2^s) * acc (negacyclic roll), diff = rotated - acc,
//      one balanced base-2^15 digit, split into three base-2^5 int8 limbs;
//   2. one int8 tensor-core product against the prime-merged vp_fwd3,
//      recombined to balanced residues in its epilogue;
//   3. MAC against that byte's GGSW residues (cbs_level == 1: k+1 rows),
//      written as int8 limbs;
//   4. per-prime int8 tensor-core inverse-NTT products (vp_inv_full);
//   5. explicit CRT mod 2^64 and acc += delta.
//
// What bounds it on this card: the forward product, 2*(5*L*B)*1536*6144
// int8 operations per bit at PARAM_TPU (B bytes, L LUT outputs), and the
// inverse products, 2*(5*L*B)*1024*1024*6; both run on the tensor cores via
// mma.sync.  The GGSW operand is read once per bit straight from the
// circuit bootstrap's int32 residues (no limb staging).  Later work:
// wgmma/TMA tiles and an accumulator resident in shared memory across bits.
//
// Exact by construction, so the words equal vp_rotations_plain's.
#include "common.cuh"

namespace tfhe {

// acc [M][N] u64 words -> A [M][3N] int8 digit limbs of X^(-c)*acc - acc.
__global__ void vp_rotate_decompose_kernel(const long long* __restrict__ acc,
                                           long long count, int N, int c,
                                           int blog,
                                           int8_t* __restrict__ A) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long m = i / N;
  const int n = static_cast<int>(i % N);
  const unsigned long long* row =
      reinterpret_cast<const unsigned long long*>(acc) + m * N;
  const unsigned long long a = row[n];
  const unsigned long long r = n + c < N ? row[n + c] : 0ULL - row[n + c - N];
  const unsigned long long diff = r - a;
  const int dshift = 64 - blog;
  const unsigned long long vbar = (diff + (1ULL << (dshift - 1))) >> dshift;
  const int raw = static_cast<int>(vbar & ((1ULL << blog) - 1));
  const int carry = raw >= (1 << (blog - 1)) ? 1 : 0;
  const int d = raw - (carry << blog);
  const int h5 = (d + 512) >> 10;
  const int mid = d - (h5 << 10);
  const int m5 = (mid + 16) >> 5;
  int8_t* out = A + m * 3 * N;
  out[n] = static_cast<int8_t>(mid - (m5 << 5));
  out[N + n] = static_cast<int8_t>(m5);
  out[2 * N + n] = static_cast<int8_t>(h5);
}

// One thread per (byte b, LUT output l, lane c).  dh [B*L*J][PN] balanced;
// G [P][B][J(u)][J(j)][N] balanced int32 (this bit's GGSW);
// X [P][B*L*J][2N] int8 limbs of the MAC result.
template <int J>
__global__ void vp_mac_kernel(const int32_t* __restrict__ dh,
                              const int32_t* __restrict__ G, int B, int L,
                              int N, int PN, Primes pr,
                              int8_t* __restrict__ X) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long rows = (long long)B * L;
  if (i >= rows * PN) return;
  const int c = static_cast<int>(i % PN);
  const long long bl = i / PN;
  const int b = static_cast<int>(bl / L);
  const int k = c / N, n = c % N;
  const int p = pr.p[k];
  long long s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = 0;
  const int32_t* gk = G + (((long long)k * B + b) * J * J) * N + n;
#pragma unroll
  for (int u = 0; u < J; ++u) {
    const long long d = dh[(bl * J + u) * PN + c];
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] += d * gk[(u * J + j) * N];
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    put_limbs(X + ((long long)k * rows * J + bl * J + j) * 2 * N + n, N,
              bal_mod(s[j], p));
}

template <int J>
static cudaError_t launch_vp_mac(const int32_t* dh, const int32_t* G, int B,
                                 int L, int N, int PN, const Primes& pr,
                                 int8_t* X, cudaStream_t s) {
  const long long count = (long long)B * L * PN;
  vp_mac_kernel<J><<<(count + 255) / 256, 256, 0, s>>>(dh, G, B, L, N, PN,
                                                      pr, X);
  return cudaGetLastError();
}

}  // namespace tfhe

using namespace tfhe;

#define TFHE_CHECK(call)                  \
  do {                                    \
    const cudaError_t e_ = (call);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Runs the nbits CMux rotations on acc [B][L][kp1][N] in place.  ggsw
// [nbits][P][B][kp1][kp1][N] int32; fwd_t = vp_fwd3 transposed [2*PN][3N];
// inv_t = vp_inv_full with each prime's matrix transposed [P][2N][2N].
// Scratch: A [B*L*kp1][3N] int8, dh [B*L*kp1][PN] int32,
// X [P][B*L*kp1][2N] int8, Y [P][B*L*kp1][N] int32.  Host arrays for the
// per-prime constants.  Returns a cudaError_t (0 = ok).
extern "C" int tfhe_vp_rotations(
    long long* acc, const int32_t* ggsw, const int8_t* fwd_t,
    const int8_t* inv_t, int8_t* A, int32_t* dh, int8_t* X, int32_t* Y,
    int B, int L, int nbits, int kp1, int N, int blog,
    const int* primes, const unsigned long long* mk, const long long* fp,
    int n_primes, unsigned long long m, void* stream) {
  if (n_primes > kMaxPrimes || blog > 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Primes pr = make_primes(primes, mk, fp, n_primes, m);
  const int PN = n_primes * N;
  const long long M = (long long)B * L * kp1;
  const long long count = M * N;
  const long long bit_words = (long long)n_primes * B * kp1 * kp1 * N;
  for (int bit = 0; bit < nbits; ++bit) {
    vp_rotate_decompose_kernel<<<(count + 255) / 256, 256, 0, s>>>(
        acc, count, N, 1 << bit, blog, A);
    TFHE_CHECK(cudaGetLastError());
    TFHE_CHECK(gemm_pair(A, 0, fwd_t, 0, (int)M, 3 * N, PN, N, 1, pr, 0, dh,
                         0, s));
    const int32_t* G = ggsw + bit * bit_words;
    switch (kp1) {
      case 2: TFHE_CHECK(launch_vp_mac<2>(dh, G, B, L, N, PN, pr, X, s)); break;
      case 3: TFHE_CHECK(launch_vp_mac<3>(dh, G, B, L, N, PN, pr, X, s)); break;
      case 4: TFHE_CHECK(launch_vp_mac<4>(dh, G, B, L, N, PN, pr, X, s)); break;
      case 5: TFHE_CHECK(launch_vp_mac<5>(dh, G, B, L, N, PN, pr, X, s)); break;
      default: return (int)cudaErrorInvalidValue;
    }
    TFHE_CHECK(gemm_pair(X, M * 2 * N, inv_t, 4LL * N * N, (int)M, 2 * N, N,
                         N, n_primes, pr, 1, Y, M * N, s));
    TFHE_CHECK(crt_accumulate(Y, count, pr, ~0ULL, acc, s));
  }
  return 0;
}
