// Residue arithmetic shared by the blind-rotate and the vertical-packing
// kernels: the per-prime constants passed by value into kernel parameter
// space, the exact 32-bit Barrett reductions, and the explicit CRT of
// canonical residues.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

constexpr int kMaxPrimes = 6;

// One prime's 32-bit Barrett constants: m = floor(2^32 / p), off = the
// least multiple of p >= 2^31, half = (p - 1) / 2.
struct Prime32 {
  uint32_t p, m, off, half;
};

struct RnsConsts {
  Prime32 pr[kMaxPrimes];
  unsigned long long mk[kMaxPrimes];  // (M / p_k) mod 2^q
  long long fp[kMaxPrimes];           // floor(2^40 / p_k)
  unsigned long long m;               // M mod 2^q
  unsigned long long qmask;
  int count;
};

// From the host arrays of ops/cuda_build.py (prime_args); q is the
// accumulator's modulus 2^q.
inline RnsConsts make_consts(const int* primes, const unsigned* barrett_m,
                             const unsigned* barrett_off,
                             const unsigned long long* mk, const long long* fp,
                             int n_primes, unsigned long long m, int q) {
  RnsConsts c{};
  for (int k = 0; k < n_primes && k < kMaxPrimes; ++k) {
    c.pr[k] = Prime32{(uint32_t)primes[k], barrett_m[k], barrett_off[k],
                      (uint32_t)(primes[k] - 1) / 2};
    c.mk[k] = mk[k];
    c.fp[k] = fp[k];
  }
  c.m = m;
  c.qmask = q >= 64 ? ~0ULL : (1ULL << q) - 1;
  c.count = n_primes;
  return c;
}

// x mod p in [0, p) for int32 x < 2^31 - 2^16: u = x + off lies in
// [0, 2^32) (off < 2^31 + 2^16), and Barrett's quotient __umulhi(u, m) is
// floor(u / p) or one less.
__device__ __forceinline__ int reduce_canonical(int x, const Prime32& q) {
  const uint32_t u = static_cast<uint32_t>(x) + q.off;
  const uint32_t r = u - __umulhi(u, q.m) * q.p;
  return static_cast<int>(r >= q.p ? r - q.p : r);
}

// Balanced residue in [-(p-1)/2, (p-1)/2], same range.
__device__ __forceinline__ int reduce_balanced(int x, const Prime32& q) {
  const int r = reduce_canonical(x, q);
  return r > static_cast<int>(q.half) ? r - static_cast<int>(q.p) : r;
}

// A cheaper representative of x mod p, in (-p, 2p), for any int32 x: the
// signed quotient __mulhi(x, m) is floor(x / p) or one more or one less.
// For a value that is reduced again after it has been scaled and added to.
__device__ __forceinline__ int reduce_partial(int x, const Prime32& q) {
  return x - __mulhi(x, static_cast<int>(q.m)) * static_cast<int>(q.p);
}

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (static_cast<uint32_t>(hi) << 16) | (static_cast<uint32_t>(lo) & 0xFFFF);
}

// Explicit CRT of one word's canonical residues y(k) in [0, p_k):
// x = sum_k y_k (M/p_k) - alpha M (mod 2^64), alpha = round(sum_k y_k / p_k)
// from the same 2^-40 fixed point as the plain version.
template <class Y>
__device__ __forceinline__ unsigned long long crt_word(const RnsConsts& c,
                                                       Y y) {
  unsigned long long x = 0;
  long long afx = 0;
#pragma unroll
  for (int k = 0; k < kMaxPrimes; ++k) {
    if (k >= c.count) break;
    const long long yk = y(k);
    x += static_cast<unsigned long long>(yk) * c.mk[k];
    afx += yk * c.fp[k];
  }
  const long long alpha = (afx + (1LL << 39)) >> 40;
  return x - static_cast<unsigned long long>(alpha) * c.m;
}

}  // namespace tfhe

#define TFHE_CHECK(call)                   \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
