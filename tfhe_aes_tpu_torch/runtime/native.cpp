// Native host data-plane for tfhe_aes_tpu.
//
// The reference's host-side performance-critical code is native Rust
// (tfhe-rs core + rayon work stealing, SURVEY.md section 2b/2c).  The TPU
// framework's device math is JAX/XLA; this library is the native equivalent
// for the *host* runtime: key-material preprocessing (limb packing, residue
// conversion, negacyclic NTT for bootstrap-key staging) and a CSPRNG, all
// multithreaded.  Python binds via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//        native.cpp -o libtfheaes_native.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Simple parallel-for over hardware threads.
template <typename F>
void parallel_for(int64_t n, F f) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? static_cast<int64_t>(hw) : 2;
  if (nt > n) nt = n > 0 ? n : 1;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back([=] { for (int64_t i = lo; i < hi; ++i) f(i); });
  }
  for (auto& th : ts) th.join();
}

inline uint64_t mulmod_small(uint64_t a, uint64_t b, uint64_t p) {
  return (a * b) % p;  // operands < 2^16/2^32: the 128-bit path is not needed
}

}  // namespace

extern "C" {

// u64 values -> balanced signed 8-bit limbs (int8), n_limbs per value.
// out layout: [n, n_limbs], limb 0 = least significant.
// Matches utils/torus.py::signed_limbs.
void signed_limbs_u64(const uint64_t* v, int8_t* out, int64_t n,
                      int n_limbs) {
  parallel_for(n, [&](int64_t i) {
    uint64_t x = v[i];
    uint64_t carry = 0;
    for (int l = 0; l < n_limbs; ++l) {
      uint64_t t = ((x >> (8 * l)) & 0xFF) + carry;
      uint64_t c = t >= 128 ? 1 : 0;
      out[i * n_limbs + l] =
          static_cast<int8_t>(static_cast<int64_t>(t) - (c << 8));
      carry = c;
    }
  });
}

// u64 -> balanced residue mod p (int32 in [-(p-1)/2, (p-1)/2]), same signed
// representative convention as ops/ntt.py::u64_to_residues.
void balanced_residues_u64(const uint64_t* v, int32_t* out, int64_t n,
                           int64_t p) {
  // 2^(8l) mod p table.
  uint64_t pw[9];
  pw[0] = 1 % p;
  for (int l = 1; l < 9; ++l) pw[l] = (pw[l - 1] * 256) % p;
  parallel_for(n, [&](int64_t i) {
    uint64_t x = v[i];
    int64_t acc = 0;
    uint64_t carry = 0;
    for (int l = 0; l < 8; ++l) {
      uint64_t t = ((x >> (8 * l)) & 0xFF) + carry;
      uint64_t c = t >= 128 ? 1 : 0;
      int64_t limb = static_cast<int64_t>(t) - static_cast<int64_t>(c << 8);
      acc += limb * static_cast<int64_t>(pw[l]);
      carry = c;
    }
    int64_t r = acc % static_cast<int64_t>(p);
    int64_t half = (static_cast<int64_t>(p) - 1) / 2;
    if (r > half) r -= p;
    if (r < -half) r += p;
    out[i] = static_cast<int32_t>(r);
  });
}

// Negacyclic NTT (matmul form) mod p of balanced int32 rows.
// rows: [m, n] int32 (|.| <= p), mat: [n, n] int32 canonical [0,p),
// out: [m, n] int32 balanced.  Used for host bootstrap-key staging —
// mirrors utils/crt.py::ntt_fwd_host + balancing.
void ntt_rows_mod(const int32_t* rows, const int32_t* mat, int32_t* out,
                  int64_t m, int64_t n, int64_t p) {
  int64_t half = (p - 1) / 2;
  parallel_for(m, [&](int64_t r) {
    const int32_t* a = rows + r * n;
    for (int64_t j = 0; j < n; ++j) {
      int64_t acc = 0;
      for (int64_t c = 0; c < n; ++c) {
        // |a| <= p < 2^15.5, mat < p: product < 2^31; accumulate in 64-bit
        // and fold periodically to avoid overflow (n <= 1024: no fold needed,
        // |acc| <= 1024 * 2^31 < 2^41).
        acc += static_cast<int64_t>(a[c]) * mat[c * n + j];
      }
      int64_t v = acc % static_cast<int64_t>(p);
      if (v > half) v -= p;
      if (v < -half) v += p;
      out[r * n + j] = static_cast<int32_t>(v);
    }
  });
}

// ChaCha20 (RFC 8439) keystream — the framework's CSPRNG for key, mask and
// noise sampling (reference dependency: tfhe-csprng, SURVEY.md 2b).  Counter
// mode makes the fill embarrassingly parallel: each thread owns a contiguous
// block range.  Validated against the RFC 8439 2.3.2 test vector
// (tests/test_csprng.py).

static inline uint32_t rotl32(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

static inline void chacha_quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d) {
  a += b; d ^= a; d = rotl32(d, 16);
  c += d; b ^= c; b = rotl32(b, 12);
  a += b; d ^= a; d = rotl32(d, 8);
  c += d; b ^= c; b = rotl32(b, 7);
}

static void chacha20_block(const uint32_t key[8], uint32_t counter,
                           const uint32_t nonce[3], uint32_t out[16]) {
  uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                    key[0], key[1], key[2], key[3],
                    key[4], key[5], key[6], key[7],
                    counter, nonce[0], nonce[1], nonce[2]};
  uint32_t x[16];
  std::memcpy(x, s, sizeof(x));
  for (int r = 0; r < 10; ++r) {  // 20 rounds = 10 double rounds
    chacha_quarter(x[0], x[4], x[8], x[12]);
    chacha_quarter(x[1], x[5], x[9], x[13]);
    chacha_quarter(x[2], x[6], x[10], x[14]);
    chacha_quarter(x[3], x[7], x[11], x[15]);
    chacha_quarter(x[0], x[5], x[10], x[15]);
    chacha_quarter(x[1], x[6], x[11], x[12]);
    chacha_quarter(x[2], x[7], x[8], x[13]);
    chacha_quarter(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

// Fill n_blocks * 8 u64 words of ChaCha20 keystream starting at block
// `counter0` (little-endian serialization, exactly the RFC keystream).
void chacha20_fill_u64(uint64_t* out, int64_t n_blocks,
                       const uint32_t key[8], const uint32_t nonce[3],
                       uint32_t counter0) {
  parallel_for(n_blocks, [&](int64_t i) {
    uint32_t block[16];
    chacha20_block(key, counter0 + static_cast<uint32_t>(i), nonce, block);
    for (int w = 0; w < 8; ++w) {
      out[i * 8 + w] = static_cast<uint64_t>(block[2 * w]) |
                       (static_cast<uint64_t>(block[2 * w + 1]) << 32);
    }
  });
}

}  // extern "C"
