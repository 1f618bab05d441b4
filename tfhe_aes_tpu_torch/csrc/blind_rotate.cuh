// What the blind rotation's two libraries share: csrc/blind_rotate.cu (the
// decomposition, K1 one block a tile, K2, the step loop) and
// csrc/blind_rotate_k1.cu (the persistent K1, built beside it so that the
// two builds run at once): K1's tile and the shapes of one rotate call.
#pragma once

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

// The shapes of one rotate call.  Every scratch operand is below 2^31
// bytes (checked by the wrapper), so offsets into it are 32-bit.
struct Shape {
  int B, J, N, PN, R, rpad, lev, blog, shift, wide, dn;
  int rows1;    // digit rows: bits padded to 128 / rpad, x rpad
  int rows2;    // X rows a prime: B * J padded to 128
  int bp_rows;  // K1's B operand rows: 2 kCols1 a column tile
};

// One step's persistent K1 (csrc/blind_rotate_k1.cu tfhe_k1_persistent):
// the digits A, K1's B operand, the BSK, the twiddles, the mod-switched
// masks and their stride, the step, the shapes, the primes, its blocks,
// rounds and A stages a warpgroup, X and the stream; a cudaError_t.
using K1PersistentFn = int (*)(const int8_t*, const int8_t*, const int8_t*,
                               const int16_t*, const int32_t*, int, int,
                               const Shape*, const RnsConsts*, int, int, int,
                               int8_t*, void*);

}  // namespace tfhe
