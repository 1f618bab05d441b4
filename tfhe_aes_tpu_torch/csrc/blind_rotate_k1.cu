// The blind rotation's forward kernel K1, persistent: for batches whose
// tiles fill the card several times over (ops/cuda_blind_rotate.py
// k1_persistent decides), one launch a step from the step loop of
// csrc/blind_rotate.cu (tfhe_blind_rotate), which calls tfhe_k1_persistent
// below through a pointer.  Its own library, so that its build runs beside
// blind_rotate.cu's (utils/warmup.py): one file of both made the build
// twice as long as either.
//
// Replaces no TPU kernel of its own: it computes what K1 computes (the
// forward digit NTT as one int8 product, the residues, the MAC against the
// step's BSK rows and the twiddle, see csrc/blind_rotate.cu), bound by
// the same products (157.3 M int8 operations a bit a step at PARAM_OPT's
// 25 rows padded to 32).  What held K1 back at bulk batches, and what this
// kernel does about it:
//   * every (column tile, row tile) block copied its column tile's
//     forward slice (64 KB at PARAM_OPT) and BSK rows (16 KB) again, 1.67
//     of the 3.01 GB a step read from L2 at 2048 bits: here a block keeps
//     them for the run of row tiles it walks in that column tile;
//   * a block's epilogue ran after its products, and two blocks an SM hid
//     half of it at best: here each of two consumer warpgroups runs its
//     previous tile's MAC, then its next tile's products, then their
//     residues, so that one's epilogue runs beside the other's products;
//   * the MAC loaded a byte or an int16 a lane from shared memory, 275
//     loads a thread a tile: here 16-byte loads of words of four rows, and
//     __dp4a.
#include "blind_rotate.cuh"

namespace tfhe {

// The design.  One block an SM walks a static list of (column tile, row
// tile) pairs (ops/cuda_blind_rotate.py k1_walk; walk_tile here computes
// the same pairs).  Entering a column tile, the block copies the tile's
// forward slice (128 B rows x dn, dn / 64 chunks of 8 KB) into shared
// memory and keeps it for the run of row tiles it walks there; only the
// digit tiles stream, 64 rows a consumer warpgroup, through a ring of each
// warpgroup's own that a producer warp of its own fills (one warp for both
// rings starved one ring while it waited on the other).  A third producer
// warp writes each run's BSK rows at its 64 columns into shared memory as
// the MAC reads them, four rows a word, one buffer ahead.  Each warpgroup
// runs its previous row tile's MAC, then the next tile's products, then
// writes that tile's residues dh into its own planes as int8 limbs lo +
// 256 hi, four rows a word (a 4 x 4 byte transpose over the lanes of the
// accumulator layout).  The MAC takes each bit's rows four at a time
// (__dp4a): two threads a column, one summing the BSK rows' lo limbs and
// one their hi limbs, which swap sums for the last steps.  The sums are the
// same integers as br_forward_mac_kernel's, reduced by the same steps, so
// the words equal blind_rotate_plain's bit for bit.
constexpr int kHalfRows = kRowsA / 2;           // A rows of a warpgroup
constexpr int kKbBytes = kHalfRows * kBK;       // one k-block of them: 4 KB
constexpr int kFwdChunk = kBN1 * kBK;           // a k-block of the slice
constexpr int kDhPlane = kHalfRows * kCols1;    // a warpgroup's lo or hi limbs
constexpr int kMaxWalk = 1024;                  // tiles a block walks at most
constexpr int kMaxStagesP = 6;                  // A stages a warpgroup
constexpr int kMaxKb = 16;                      // dn <= 1024
constexpr int kBarrierBytes = 1024;
constexpr size_t kSmemPersistent = 232448;      // the H100's per-block limit
constexpr int kThreadsP = kConsumers + 96;      // + three producer warps

// Row tiles of column tile c that the walk's rounds before m take, in
// closed form (ops/cuda_blind_rotate.py _walk_cum).
__device__ __forceinline__ int walk_cum(int c, int m, int cols, int blocks) {
  const int q = m / cols, r = m - q * cols;
  const int u = (cols - r + 1) % cols;
  const int a = ((c * blocks - u) % cols + cols) % cols;
  const int x = a + blocks;
  return blocks * q + (x / cols) * r + min(x % cols, r) - min(a, r);
}

// Block s's (column tile, row tile) in round m (walk_tile).
__device__ __forceinline__ void walk_tile(int s, int m, int cols, int blocks,
                                          int& c, int& rt) {
  const int ring = cols * blocks;
  const int x = ((s * cols - m) % ring + ring) % ring;
  c = x / blocks;
  rt = walk_cum(c, m, cols, blocks) + (x - c * blocks) / cols;
}

template <int J, int kWords, int kStageKb>
__global__ void __launch_bounds__(kThreadsP, 1)
br_forward_mac_kernel_persistent(const int8_t* __restrict__ A,
                                 const int8_t* __restrict__ fwd,
                                 const int8_t* __restrict__ bsk,
                                 const int16_t* __restrict__ rot,
                                 const int32_t* __restrict__ tilde,
                                 int tstride, int step, Shape s, RnsConsts c,
                                 int rounds, int stages,
                                 int8_t* __restrict__ X) {
  // kWords: a bit's GGSW rows, four a word (R <= 4 kWords); padded to
  // kRpad, in 16-byte chunks.  kStageKb: the k-blocks of an A stage (4
  // where dn allows: half the waits of 2, 6% faster at PARAM_OPT).
  constexpr int kHalfStage = kStageKb * kKbBytes;
  constexpr int kRpad = kWords <= 4 ? 16 : 32;
  constexpr int kChunks = kRpad / 16;
  constexpr int kBitsWg = kHalfRows / kRpad;  // bits of a warpgroup's rows
  constexpr int kFin = kBitsWg / 2;           // bits a thread finishes
  constexpr int kBskBytes = 2 * J * kRpad * kCols1;  // [2J][chunk][col][16]
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_kb = s.dn / kBK;
  uint8_t* fwd_s = smem;                                  // [n_kb][8 KB]
  uint8_t* ring_s = fwd_s + n_kb * kFwdChunk;  // [2][stages][kHalfStage]
  int8_t* dh_s = reinterpret_cast<int8_t*>(ring_s + 2 * stages * kHalfStage);
  uint8_t* bsk_s = reinterpret_cast<uint8_t*>(dh_s + 4 * kDhPlane);  // [2]
  int* walk = reinterpret_cast<int*>(bsk_s + 2 * kBskBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(walk + kMaxWalk);
  uint64_t* fwd_full = bars;                  // a chunk of a run landed
  uint64_t* fwd_empty = bars + kMaxKb;        // both warpgroups done with it
  uint64_t* bsk_full = bars + 2 * kMaxKb;     // [2]
  uint64_t* bsk_empty = bsk_full + 2;         // [2]
  uint64_t* full = bsk_full + 4;              // [2][kMaxStagesP]
  uint64_t* empty = full + 2 * kMaxStagesP;   // [2][kMaxStagesP]
  int& n_walk = *reinterpret_cast<int*>(empty + 2 * kMaxStagesP);
  const int cols = s.PN / kCols1, row_tiles = s.rows1 / kRowsA;

  // The walk, one round a thread, then compacted by warp 0: a round whose
  // row tile lies past the last is skipped.
  int* tmp = reinterpret_cast<int*>(dh_s);    // 16 KB, written later
  for (int m = threadIdx.x; m < rounds; m += kThreadsP) {
    int ct, rt;
    walk_tile(blockIdx.x, m, cols, gridDim.x, ct, rt);
    tmp[m] = rt < row_tiles ? (ct << 16) | rt : -1;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_kb; ++i) {
      sm90::mbar_init(&fwd_full[i], 1);
      sm90::mbar_init(&fwd_empty[i], 2);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&bsk_full[i], 32);
      sm90::mbar_init(&bsk_empty[i], 2);
    }
    for (int i = 0; i < 2 * stages; ++i) {
      const int h = i / stages, j = i % stages;
      sm90::mbar_init(&full[h * kMaxStagesP + j], 1);
      sm90::mbar_init(&empty[h * kMaxStagesP + j], 1);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < rounds; base += 32) {
      const int v = base + lane < rounds ? tmp[base + lane] : -1;
      const unsigned ok = __ballot_sync(0xffffffffu, v >= 0);
      if (v >= 0) walk[n + __popc(ok & ((1u << lane) - 1))] = v;
      n += __popc(ok);
    }
    if (lane == 0) n_walk = n;
  }
  __syncthreads();
  const int n = n_walk;

  if (threadIdx.x >= kConsumers + 64) {  // producer warp 2: the BSK rows
    // Lane -> (BSK row jl, four columns): 16 rows of four columns' limbs
    // (as 16 words) become four columns' 16 rows (as four uint4), by 4 x 4
    // byte transposes.
    const int lane = threadIdx.x & 31;
    const int8_t* g = bsk + (long long)step * s.R * 2 * J * s.PN;
    for (int i = 0, prev = -1, seg = -1; i < n; ++i) {
      const int ct = walk[i] >> 16;
      if (ct == prev) continue;
      prev = ct;
      ++seg;
      const int buf = seg & 1;
      if (seg > 1)
        sm90::mbar_wait_sleep(&bsk_empty[buf], ((seg >> 1) - 1) & 1, 1000);
      uint8_t* dst = bsk_s + buf * kBskBytes;
      for (int item = lane; item < 2 * J * (kCols1 / 4); item += 32) {
        const int jl = item / (kCols1 / 4), c4 = 4 * (item % (kCols1 / 4));
        const int8_t* src = g + (long long)jl * s.PN + ct * kCols1 + c4;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          uint32_t x[16];
#pragma unroll
          for (int r = 0; r < 16; ++r)
            x[r] = 16 * ch + r < s.R
                       ? __ldg(reinterpret_cast<const uint32_t*>(
                             src + (long long)(16 * ch + r) * 2 * J * s.PN))
                       : 0u;
          uint32_t y[4][4];  // [column][word]
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t t0 = __byte_perm(x[4 * w], x[4 * w + 1], 0x5140);
            const uint32_t t1 = __byte_perm(x[4 * w], x[4 * w + 1], 0x7362);
            const uint32_t t2 = __byte_perm(x[4 * w + 2], x[4 * w + 3], 0x5140);
            const uint32_t t3 = __byte_perm(x[4 * w + 2], x[4 * w + 3], 0x7362);
            y[0][w] = __byte_perm(t0, t2, 0x5410);
            y[1][w] = __byte_perm(t0, t2, 0x7632);
            y[2][w] = __byte_perm(t1, t3, 0x5410);
            y[3][w] = __byte_perm(t1, t3, 0x7632);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            *reinterpret_cast<uint4*>(
                dst + ((jl * kChunks + ch) * kCols1 + c4 + cc) * 16) =
                make_uint4(y[cc][0], y[cc][1], y[cc][2], y[cc][3]);
        }
      }
      sm90::mbar_arrive(&bsk_full[buf]);
    }
    return;
  }
  if (threadIdx.x >= kConsumers) {  // producer warp h feeds ring h
    const int h = (threadIdx.x - kConsumers) >> 5;
    if ((threadIdx.x & 31) == 0) {
      uint64_t* rf = full + h * kMaxStagesP;
      uint64_t* re = empty + h * kMaxStagesP;
      uint8_t* ring = ring_s + h * stages * kHalfStage;
      int prev = -1, seg = -1, slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n; ++i) {
        const int ct = walk[i] >> 16, rt = walk[i] & 0xFFFF;
        if (ct != prev) {
          prev = ct;
          ++seg;
          if (h == 0) {  // the run's forward slice
            for (int kb = 0; kb < n_kb; ++kb) {
              if (seg > 0)
                sm90::mbar_wait_sleep(&fwd_empty[kb], (seg - 1) & 1, 64);
              sm90::mbar_expect_tx(&fwd_full[kb], kFwdChunk);
              const long long chunk = (long long)kb * s.bp_rows + ct * kBN1;
              sm90::bulk_g2s(fwd_s + kb * kFwdChunk, fwd + chunk * kBK,
                             kFwdChunk, &fwd_full[kb]);
            }
          }
        }
        for (int kb = 0; kb < n_kb; kb += kStageKb) {
          sm90::mbar_wait_sleep(&re[slot], phase ^ 1, 64);
          sm90::mbar_expect_tx(&rf[slot], kHalfStage);
#pragma unroll
          for (int k2 = 0; k2 < kStageKb; ++k2)
            sm90::bulk_g2s(ring + slot * kHalfStage + k2 * kKbBytes,
                           A + ((long long)(kb + k2) * s.rows1 +
                                rt * kRowsA + h * kHalfRows) * kBK,
                           kKbBytes, &rf[slot]);
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const bool leader = t == 0;
  uint64_t* rf = full + wg * kMaxStagesP;
  uint64_t* re = empty + wg * kMaxStagesP;
  const uint8_t* ring = ring_s + wg * stages * kHalfStage;
  int8_t* dlo = dh_s + wg * 2 * kDhPlane;     // [bit][chunk][64 cols][16 B]
  int8_t* dhi = dlo + kDhPlane;
  // MAC: thread -> column t / 2; t & 1 sums the BSK rows' lo (0) or hi (1)
  // limbs for every bit of the warpgroup, and finishes bits t & 1 + 2 i.
  const int col = t >> 1, jh = t & 1;
  const int nbits = kRowsA / kRpad;
  // Residues: the lane group of the transposes and its selectors.
  const int bsel = (lane >> 2) & 3, hq = lane >> 4, qq = lane & 3;
  const uint32_t sel1 = (bsel & 1) ? 0x3715 : 0x6240;
  const uint32_t sel2 = (bsel & 2) ? 0x3276 : 0x5410;
  int mask_next[kFin];
  auto masks = [&](int i) {
    const int rt = walk[i] & 0xFFFF;
#pragma unroll
    for (int m = 0; m < kFin; ++m) {
      const int b = rt * nbits + wg * kBitsWg + 2 * m + jh;
      mask_next[m] = b < s.B ? __ldg(tilde + (long long)b * tstride + step)
                             : 0;
    }
  };
  if (n > 0) masks(0);

  // MAC of a tile whose residues are in this warpgroup's planes: each bit's
  // rows four at a __dp4a against this thread's half of the run's BSK rows
  // (rows past R are 0 there); a limb's sums are combined as lo + 256 hi.
  // |d| <= p/2 < 2^15, |limb| <= 128, R <= 32 terms: |sum| < 2^27.  Then
  // the sums are swapped with the other thread of the column, so that bit
  // 2 m + jh has both, and twiddled: delta[m][j].
  auto mac = [&](int sg, const Prime32& qp, const int (&tw1)[kFin],
                 int (&delta)[kFin][J]) {
    const uint8_t* bt = bsk_s + (sg & 1) * kBskBytes;
    uint32_t gw[J][4 * kChunks];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            bt + (((jh * J + j) * kChunks + ch) * kCols1 + col) * 16);
        gw[j][4 * ch] = v.x, gw[j][4 * ch + 1] = v.y, gw[j][4 * ch + 2] = v.z,
        gw[j][4 * ch + 3] = v.w;
      }
    int sum[kBitsWg][J];
#pragma unroll
    for (int bl = 0; bl < kBitsWg; ++bl) {
      uint32_t lo[4 * kChunks], hi[4 * kChunks];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int o = ((bl * kChunks + ch) * kCols1 + col) * 16;
        const uint4 l4 = *reinterpret_cast<const uint4*>(dlo + o);
        const uint4 h4 = *reinterpret_cast<const uint4*>(dhi + o);
        lo[4 * ch] = l4.x, lo[4 * ch + 1] = l4.y, lo[4 * ch + 2] = l4.z,
        lo[4 * ch + 3] = l4.w;
        hi[4 * ch] = h4.x, hi[4 * ch + 1] = h4.y, hi[4 * ch + 2] = h4.z,
        hi[4 * ch + 3] = h4.w;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        int sl = 0, sh = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          sl = __dp4a(static_cast<int>(lo[w]), static_cast<int>(gw[j][w]), sl);
          sh = __dp4a(static_cast<int>(hi[w]), static_cast<int>(gw[j][w]), sh);
        }
        sum[bl][j] = sl + 256 * sh;
      }
    }
#pragma unroll
    for (int m = 0; m < kFin; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int mine = jh ? sum[2 * m + 1][j] : sum[2 * m][j];
        const int theirs = __shfl_xor_sync(
            0xffffffffu, jh ? sum[2 * m][j] : sum[2 * m + 1][j], 1);
        const int sl = jh ? theirs : mine, sh = jh ? mine : theirs;
        const int prod =
            reduce_balanced(sl + 256 * reduce_balanced(sh, qp), qp);
        // |tw prod| <= (p + 1)/2 (p - 1)/2 < 2^30
        delta[m][j] = reduce_balanced((tw1[m] - 1) * prod, qp);
      }
  };
  // Tile (rt, ct)'s twiddled limbs of this thread's bits into X.
  auto store_x = [&](int rt, int ct, int kp, const int (&delta)[kFin][J]) {
    const int n_col = ct * kCols1 + col - kp * s.N;
    int8_t* xk = X + (long long)kp * s.rows2 * 2 * s.N;
    const int x_lo = kmajor_col(n_col, s.rows2);
    const int x_hi = kmajor_col(s.N + n_col, s.rows2);
#pragma unroll
    for (int m = 0; m < kFin; ++m) {
      const int b = rt * nbits + wg * kBitsWg + 2 * m + jh;
      if (b >= s.B) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int h8 = (delta[m][j] + 128) >> 8;
        const int ro = kmajor_row(b * J + j);
        xk[x_lo + ro] = static_cast<int8_t>(delta[m][j] - (h8 << 8));
        xk[x_hi + ro] = static_cast<int8_t>(h8);
      }
    }
  };

  // The current tile and the previous one, whose residues are in the
  // planes.
  int prev = -1, seg = -1, slot = 0;
  uint32_t phase = 0;
  int ct = 0, rt = 0, kp = 0, tw1[kFin];
  bool last = false;
  Prime32 q = c.pr[0];
  int p_rt = 0, p_ct = 0, p_kp = 0, p_seg = 0, p_tw[kFin];
  bool p_last = false;
  Prime32 p_q = c.pr[0];
  // Tile i's walk entry, prime, twiddles, and, on a run's first tile, the
  // waits for its forward slice and its BSK rows.
  auto begin = [&](int i) {
    ct = walk[i] >> 16;
    rt = walk[i] & 0xFFFF;
    const bool fresh = ct != prev;
    if (fresh) {
      prev = ct;
      ++seg;
    }
    kp = ct * kCols1 / s.N;
    q = c.pr[kp];
    last = i + 1 == n || (walk[i + 1] >> 16) != ct;
    // The twiddles rot[a_s] of this tile and the masks of the next land
    // during the products.
#pragma unroll
    for (int m = 0; m < kFin; ++m)
      tw1[m] = __ldg(rot + mask_next[m] * s.PN + ct * kCols1 + col);
    if (i + 1 < n) masks(i + 1);
    if (fresh) {
      for (int kb = 0; kb < n_kb; ++kb)
        sm90::mbar_wait(&fwd_full[kb], seg & 1);
      sm90::mbar_wait(&bsk_full[seg & 1], (seg >> 1) & 1);
    }
  };
  // The tile's products: only the waits for its A stages lie between the
  // wgmma groups.
  auto issue = [&](int (&d)[kBN1 / 2]) {
    for (int kb = 0; kb < n_kb; kb += kStageKb) {
      sm90::mbar_wait(&rf[slot], phase);
      const uint8_t* a = ring + slot * kHalfStage;
      sm90::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < kStageKb; ++k2) {
        const uint8_t* b = fwd_s + (kb + k2) * kFwdChunk;
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          sm90::wgmma_m64n128k32(
              d, sm90::desc_kmajor(a + k2 * kKbBytes + kk * 256),
              sm90::desc_kmajor(b + kk * 256), kb + k2 > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  };
  // Once they have completed: the tile's A stages (and, on the run's last
  // tile, the slice's chunks) are released.
  auto finish = [&](int (&d)[kBN1 / 2]) {
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kBN1 / 2; ++r) asm volatile("" : "+r"(d[r])::"memory");
    if (leader) {
      const int held = n_kb / kStageKb;
      for (int k = 0, sl = (slot + stages - held % stages) % stages; k < held;
           ++k, sl = sl + 1 == stages ? 0 : sl + 1)
        sm90::mbar_arrive(&re[sl]);
      if (last)
        for (int kb = 0; kb < n_kb; ++kb) sm90::mbar_arrive(&fwd_empty[kb]);
    }
  };
  // Residues dh = lo + 256 hi (mod p, balanced) as int8 limbs into this
  // warpgroup's planes, four rows a word.  |lo + 256 hi| <= dn |digit|
  // (128 + 256 * 126) < 2^31 - 2^16 (checked by the wrapper): one
  // reduction.  A thread's 32 residues make 8 words of lo limbs and 8 of
  // hi limbs, byte k its value for column k of four; a 4 x 4 byte
  // transpose over the lane group {l, l ^ 4, l ^ 8, l ^ 12} then gives lane
  // b the four rows of column b.  All 16 words go through each shuffle
  // together, so that their latencies overlap.
  auto residues = [&](const int (&d)[kBN1 / 2]) {
    uint32_t wd[16];  // [group 4 i2 + p][lo, hi]
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int i2 = g >> 2, p = g & 3;
      int v[4];
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int e = 4 * (2 * p + (kx >> 1)) + 2 * i2 + (kx & 1);
        v[kx] = reduce_balanced(d[e] + 256 * d[e + kCols1 / 2], q);
      }
      wd[2 * g] = __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                              __byte_perm(v[2], v[3], 0x0040), 0x5410);
      wd[2 * g + 1] =
          __byte_perm(__byte_perm(v[0] + 128, v[1] + 128, 0x0051),
                      __byte_perm(v[2] + 128, v[3] + 128, 0x0051), 0x5410);
    }
#pragma unroll
    for (int x = 0; x < 16; ++x)
      wd[x] = __byte_perm(wd[x], __shfl_xor_sync(0xffffffffu, wd[x], 4), sel1);
#pragma unroll
    for (int x = 0; x < 16; ++x)
      wd[x] = __byte_perm(wd[x], __shfl_xor_sync(0xffffffffu, wd[x], 8), sel2);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int i2 = g >> 2, p = g & 3;
      const int rw = 16 * warp + 8 * i2 + 4 * hq;  // the word's first row
      const int bl = rw / kRpad, rr = rw % kRpad;
      const int colb = 8 * (2 * p + (bsel >> 1)) + 2 * qq + (bsel & 1);
      const int off = ((bl * kChunks + (rr >> 4)) * kCols1 + colb) * 16 +
                      ((rr >> 2) & 3) * 4;
      *reinterpret_cast<uint32_t*>(dlo + off) = wd[2 * g];
      *reinterpret_cast<uint32_t*>(dhi + off) = wd[2 * g + 1];
    }
    sm90::named_sync(2 + wg, 128);
    p_rt = rt, p_ct = ct, p_kp = kp, p_seg = seg, p_last = last, p_q = q;
#pragma unroll
    for (int m = 0; m < kFin; ++m) p_tw[m] = tw1[m];
  };
  // The planes and, after a run's last tile, its BSK rows are free once
  // every thread of the warpgroup has read them.
  auto release = [&]() {
    sm90::named_sync(2 + wg, 128);
    if (p_last && leader) sm90::mbar_arrive(&bsk_empty[p_seg & 1]);
  };

  // Tile i - 1's MAC runs while the other warpgroup's products run, then
  // tile i's products are issued and waited for, and its residues fill the
  // planes.  (Tile i - 1's MAC between tile i's wgmma and their wait ran
  // 8% slower: the issue itself waits for the tensor cores.)
  if (n == 0) return;
  int d[kBN1 / 2];
  int delta[kFin][J];
  begin(0);
  issue(d);
  finish(d);
  residues(d);
  for (int i = 1; i < n; ++i) {
    begin(i);
    mac(p_seg, p_q, p_tw, delta);
    issue(d);
    finish(d);
    release();
    store_x(p_rt, p_ct, p_kp, delta);
    residues(d);
  }
  mac(p_seg, p_q, p_tw, delta);
  release();
  store_x(p_rt, p_ct, p_kp, delta);
}

using PersistentKernel = void (*)(const int8_t*, const int8_t*, const int8_t*,
                                  const int16_t*, const int32_t*, int, int,
                                  Shape, RnsConsts, int, int, int8_t*);

// The instance for k + 1 and R GGSW rows, stages of 4 k-blocks where dn
// allows (stage_kb 4), else 2: the shapes of the port's parameter sets,
// k + 1 = 3 with R <= 16 (4 words of rows a bit; the toy sets) and k + 1 =
// 5 with 16 < R <= 28 (7 words; PARAM_OPT's 25, the 25-row toy set);
// nullptr for any other (ops/cuda_blind_rotate.py k1_persistent keeps
// those on br_forward_mac_kernel).
static PersistentKernel persistent_kernel(int kp1, int R, int stage_kb) {
  if (stage_kb != 2 && stage_kb != 4) return nullptr;
  const bool wide = stage_kb == 4;
  if (kp1 == 3 && R <= 16)
    return wide ? br_forward_mac_kernel_persistent<3, 4, 4>
                : br_forward_mac_kernel_persistent<3, 4, 2>;
  if (kp1 == 5 && R > 16 && R <= 28)
    return wide ? br_forward_mac_kernel_persistent<5, 7, 4>
                : br_forward_mac_kernel_persistent<5, 7, 2>;
  return nullptr;
}

}  // namespace tfhe

using namespace tfhe;

// One step's persistent K1 on `blocks` blocks (one an SM), walking `rounds`
// rounds with `stages` A stages a warpgroup, on the stream; its shared-
// memory limit is raised to the card's most on the first call of an
// instance on a device (tfhe_k1_prepare raises every instance's).  Returns
// a cudaError_t (0 = ok): cudaErrorInvalidValue for a shape it has no
// instance for, or whose slice, BSK rows and ring do not fit.
extern "C" int tfhe_k1_persistent(const int8_t* A, const int8_t* fwd_tiles,
                                  const int8_t* bsk, const int16_t* rot,
                                  const int32_t* tilde, int tstride, int step,
                                  const Shape* s, const RnsConsts* c,
                                  int blocks, int rounds, int stages,
                                  int8_t* X, void* stream) {
  const int stage_kb = s->dn % (4 * kBK) == 0 ? 4 : 2;
  const PersistentKernel k1p = persistent_kernel(s->J, s->R, stage_kb);
  const size_t smem = (size_t)s->dn / kBK * kFwdChunk +
                      (size_t)2 * stages * stage_kb * kKbBytes +
                      4 * kDhPlane + (size_t)2 * 2 * s->J * s->rpad * kCols1 +
                      4 * kMaxWalk + kBarrierBytes;
  if (k1p == nullptr || blocks < 1 || rounds > kMaxWalk ||
      stages <= s->dn / kBK / stage_kb || stages > kMaxStagesP ||
      s->dn % (stage_kb * kBK) != 0 || s->dn / kBK > kMaxKb ||
      smem > kSmemPersistent)
    return (int)cudaErrorInvalidValue;
  TFHE_CHECK(raise_smem_limit((const void*)k1p, kSmemPersistent));
  k1p<<<blocks, kThreadsP, smem, static_cast<cudaStream_t>(stream)>>>(
      A, fwd_tiles, bsk, rot, tilde, tstride, step, *s, *c, rounds, stages, X);
  return (int)cudaGetLastError();
}

// Raises every instance's shared-memory limit on the current device to the
// card's most: called on every rotate call (it makes no runtime call after
// the first), so that a small batch's eager call has set them before a
// graph of a larger batch is captured.  Returns a cudaError_t.
extern "C" int tfhe_k1_prepare() {
  for (const int kp1 : {3, 5})
    for (const int stage_kb : {2, 4})
      TFHE_CHECK(raise_smem_limit(
          (const void*)persistent_kernel(kp1, 4 * kp1, stage_kb),
          kSmemPersistent));
  return 0;
}
