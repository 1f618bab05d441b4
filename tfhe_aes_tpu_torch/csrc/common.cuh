// Device code of the vertical-packing kernel (the blind rotate has its own,
// on wgmma: sm90_gemm.cuh).
//
// It runs the exact RNS external product per CMux step:
//   digits -> (int8 tensor-core product against a prime-merged forward NTT
//   matrix) -> per-prime MAC in the NTT domain -> (int8 tensor-core products
//   against per-prime inverse-NTT matrices) -> explicit CRT -> acc += delta.
// Every reduction is exact integer arithmetic, so the words equal the plain
// torch version's (and the JAX reference's) bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

constexpr int kMaxPrimes = 8;

// Per-prime constants, passed by value into the kernels' parameter space.
struct Primes {
  int p[kMaxPrimes];
  unsigned long long mk[kMaxPrimes];  // (M / p_k) mod 2^q
  long long fp[kMaxPrimes];           // floor(2^40 / p_k)
  unsigned long long m;               // M mod 2^q
  int count;
};

inline Primes make_primes(const int* p, const unsigned long long* mk,
                          const long long* fp, int count,
                          unsigned long long m) {
  Primes c{};
  for (int k = 0; k < count && k < kMaxPrimes; ++k) {
    c.p[k] = p[k];
    c.mk[k] = mk[k];
    c.fp[k] = fp[k];
  }
  c.m = m;
  c.count = count;
  return c;
}

// Balanced residue of t mod p: [-(p-1)/2, (p-1)/2] (p odd).
__device__ __forceinline__ int bal_mod(long long t, int p) {
  int r = static_cast<int>(t % p);     // (-p, p)
  const int half = (p - 1) >> 1;
  if (r > half) r -= p;
  if (r < -half) r += p;
  return r;
}

// Writes a balanced residue |d| <= p/2 < 2^15 as two int8 limbs
// d = lo + 256*hi at lo_ptr[0] and lo_ptr[n] (the [lo | hi] row blocks the
// inverse-NTT matrices expect).
__device__ __forceinline__ void put_limbs(int8_t* lo_ptr, int n, int d) {
  const int h8 = (d + 128) >> 8;
  lo_ptr[0] = static_cast<int8_t>(d - (h8 << 8));
  lo_ptr[n] = static_cast<int8_t>(h8);
}

// ---------------------------------------------------------------------------
// Paired int8 GEMM with a residue epilogue.
//
//   lo[m][c] = sum_k A[z][m][k] * Bt[z][c][k]
//   hi[m][c] = sum_k A[z][m][k] * Bt[z][c + NH][k]        (c < NH)
//   out[z][m][c] = (lo + 256*hi) mod p_{z + c/seg}, balanced, or canonical
//                  [0, p) when `canonical`.
//
// A is row-major [M][K]; Bt is the matrix transposed ([2*NH][K], K
// contiguous), so both operands feed mma.sync with 32-bit fragment loads.
// Accumulators are int32: every caller contracts <= 3N = 1536 terms of
// |a| <= 128, |b| <= 128 (< 2^25); the epilogue widens to int64.
// Tile: 64 rows x 64 lo columns (+ the 64 paired hi columns), K step 32,
// 4 warps each owning a 32 x 32 (lo and hi) sub-tile.  M is masked; K must
// be a multiple of 32 and NH, seg multiples of 64 (checked by the host).
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32, kPad = 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(128)
gemm_pair_kernel(const int8_t* __restrict__ A, long long a_z,
                 const int8_t* __restrict__ Bt, long long b_z,
                 int M, int K, int NH, int seg, Primes pr, int canonical,
                 int32_t* __restrict__ out, long long o_z) {
  const int z = blockIdx.z;
  A += z * a_z;
  Bt += z * b_z;
  out += z * o_z;
  const int m0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;

  __shared__ __align__(16) int8_t As[kBM][kBK + kPad];
  __shared__ __align__(16) int8_t Bs[2 * kBN][kBK + kPad];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc_lo[2][4][4], acc_hi[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_lo[i][j][e] = acc_hi[i][j][e] = 0;

  // Loader mapping: one 16-byte chunk of A and two of Bt per thread.
  const int la_row = tid >> 1, la_col = (tid & 1) * 16;
  const int ga_row = m0 + la_row;
  int lb_row[2], lb_col[2];
  long long gb_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 128;
    lb_row[i] = idx >> 1;
    lb_col[i] = (idx & 1) * 16;
    gb_row[i] = lb_row[i] < kBN ? c0 + lb_row[i] : NH + c0 + lb_row[i] - kBN;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    uint4 ra = make_uint4(0, 0, 0, 0);
    if (ga_row < M)
      ra = *reinterpret_cast<const uint4*>(A + (long long)ga_row * K + k0 +
                                           la_col);
    uint4 rb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rb[i] = *reinterpret_cast<const uint4*>(Bt + gb_row[i] * K + k0 +
                                              lb_col[i]);
    __syncthreads();   // the previous step's fragments are read
    *reinterpret_cast<uint4*>(&As[la_row][la_col]) = ra;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&Bs[lb_row[i]][lb_col[i]]) = rb[i];
    __syncthreads();

    unsigned af[2][4], bl[4][2], bh[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const unsigned*>(&As[r][t * 4]);
      af[mi][1] = *reinterpret_cast<const unsigned*>(&As[r + 8][t * 4]);
      af[mi][2] = *reinterpret_cast<const unsigned*>(&As[r][16 + t * 4]);
      af[mi][3] = *reinterpret_cast<const unsigned*>(&As[r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + g;
      bl[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[c][t * 4]);
      bl[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[c][16 + t * 4]);
      bh[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[kBN + c][t * 4]);
      bh[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[kBN + c][16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_s8(acc_lo[mi][ni], af[mi], bl[ni]);
        mma_s8(acc_hi[mi][ni], af[mi], bh[ni]);
      }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = c0 + wn + ni * 8 + t * 2 + (e & 1);
        if (row >= M) continue;
        const int p = pr.p[z + col / seg];
        int r = bal_mod((long long)acc_lo[mi][ni][e] +
                            256LL * acc_hi[mi][ni][e], p);
        if (canonical && r < 0) r += p;
        out[(long long)row * NH + col] = r;
      }
}

// Launches gemm_pair_kernel over Z independent problems.
inline cudaError_t gemm_pair(const int8_t* A, long long a_z, const int8_t* Bt,
                             long long b_z, int M, int K, int NH, int seg,
                             int Z, const Primes& pr, int canonical,
                             int32_t* out, long long o_z, cudaStream_t s) {
  dim3 grid(NH / kBN, (M + kBM - 1) / kBM, Z);
  gemm_pair_kernel<<<grid, 128, 0, s>>>(A, a_z, Bt, b_z, M, K, NH, seg, pr,
                                        canonical, out, o_z);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Explicit CRT of canonical residues y_k [P][M2*N] into acc += x (mod 2^q):
//   x = sum_k y_k * (M/p_k) - alpha * M,  alpha = round(sum_k y_k / p_k)
// with alpha from the same 2^-40 fixed point as the plain version.
// ---------------------------------------------------------------------------
__global__ void crt_accumulate_kernel(const int32_t* __restrict__ Y,
                                      long long count, Primes pr,
                                      unsigned long long qmask,
                                      long long* __restrict__ acc) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  unsigned long long x = 0;
  long long afx = 0;
  for (int k = 0; k < pr.count; ++k) {
    const long long y = Y[k * count + i];
    x += static_cast<unsigned long long>(y) * pr.mk[k];
    afx += y * pr.fp[k];
  }
  const long long alpha = (afx + (1LL << 39)) >> 40;
  x -= static_cast<unsigned long long>(alpha) * pr.m;
  acc[i] = static_cast<long long>(
      (static_cast<unsigned long long>(acc[i]) + x) & qmask);
}

inline cudaError_t crt_accumulate(const int32_t* Y, long long count,
                                  const Primes& pr, unsigned long long qmask,
                                  long long* acc, cudaStream_t s) {
  const int threads = 256;
  crt_accumulate_kernel<<<(count + threads - 1) / threads, threads, 0, s>>>(
      Y, count, pr, qmask, acc);
  return cudaGetLastError();
}

}  // namespace tfhe
