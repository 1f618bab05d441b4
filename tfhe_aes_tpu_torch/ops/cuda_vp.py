"""Wrapper of the CUDA vertical-packing kernel (csrc/vertical_packing.cu).

Counterpart of tfhe_aes_tpu/ops/pallas_vp.vp_rotations_pallas: the CMux
rotations over the low selector bits at cbs_level == 1, same words out.
The kernel's C entry point runs three launches a selector bit on PyTorch's
current stream (digits, forward product + MAC, inverse products + CRT).
This wrapper derives the shapes of its operands (the dense grouping of
accumulators into 128-row digit tiles, the bytes of GGSW rows a block
stages, the input range of every 32-bit reduction) and refuses what the
kernel does not take, lays the forward matrix of two-limb digits (from
fwd_limbs) and vp_inv_full out in the k-major tile order once per key set,
allocates the two scratch operands, and counts its calls as "vp_calls" in
utils/profiling's store.  The kernel splits a digit into two int8
limbs, not the three base-2^5 limbs vp_fwd3 is staged for, so that leaf is
not read here.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import ParamSet
from ..utils import profiling
from . import cuda_blind_rotate as cbr
from . import cuda_build, modular, ntt
from .keys import DeviceKeys

_P = ctypes.c_void_p
_I = ctypes.c_int

TILE_ROWS = cbr.TILE_ROWS
# V1's ring: four stages of 128 digit rows and 128 matrix rows, BK bytes
# of K each, and its eight barriers (csrc/vertical_packing.cu).
V1_RING_BYTES = 4 * (TILE_ROWS + 2 * cbr.K1_COLS) * cbr.BK + 64
# Dynamic shared memory of a block when two share an SM (kSmemTwoBlocks).
SMEM_TWO_BLOCKS = 112 * 1024
V2_COLS = 64        # output coefficients of an inverse tile (kCols2)


def _lib():
    lib = cuda_build.load("vertical_packing")
    fn = lib.tfhe_vp_rotations
    fn.argtypes = [_P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _I, ctypes.c_uint64, _P]
    fn.restype = _I
    return fn


def group_size(kp1: int) -> int:
    """Accumulators of k+1 digit rows packed into one 128-row digit tile."""
    return TILE_ROWS // kp1


def ggsw_span(kp1: int, n_bytes: int, n_luts: int) -> int:
    """The most bytes a tile's accumulators (byte-major, n_luts a byte)
    belong to: their GGSW rows are what a V1 block stages."""
    return min(n_bytes, (group_size(kp1) + n_luts - 2) // n_luts + 1)


def v1_shared_bytes(kp1: int, n_bytes: int, n_luts: int) -> int:
    """V1's dynamic shared memory: the ring and (k+1)^2 int32 rows of 64
    columns a staged byte."""
    return V1_RING_BYTES + ggsw_span(kp1, n_bytes, n_luts) * kp1 * kp1 \
        * cbr.K1_COLS * 4


def forward_matrix(fwd_limbs: torch.Tensor) -> torch.Tensor:
    """fwd_limbs [P, 2, 2, N, N] (input limb i, output limb j) -> the
    prime-merged forward matrix [2N, 2 P N] of digits d = lo + 256 hi: row
    blocks = the digit's two int8 limbs (the 2^8 scale of the hi limb
    folded in), columns [0, P N) the lo output limbs (prime k at k N),
    [P N, 2 P N) the hi limbs."""
    pcount, _, _, n, _ = fwd_limbs.shape
    return fwd_limbs.permute(1, 3, 2, 0, 4).reshape(2 * n, 2 * pcount * n)


def scratch_rows(kp1: int, n_accs: int) -> tuple[int, int]:
    """(rows of the digit operand A, rows a prime of X): 128 rows a group
    of accumulators; the accumulators' k+1 rows dense, padded to 128."""
    rows1 = -(-n_accs // group_size(kp1)) * TILE_ROWS
    rows2 = -(-n_accs * kp1 // TILE_ROWS) * TILE_ROWS
    return rows1, rows2


def reduction_bounds(params: ParamSet, plan: ntt.NttPlan) -> dict[str, int]:
    """The largest |x| the kernel feeds each of its 32-bit Barrett
    reductions, from the shapes.  Forward: N lo and N hi limbs of a digit
    (|lo| <= 128, |hi| <= 64 at 15 bits) against the matrix's int8 limbs of
    balanced residues (|lo| <= 128, |hi| <= 80 below p = 40961), lo + 256 hi
    combined unreduced.  The MAC: k+1 products of two balanced residues.
    Inverse: 2N int8 residue limbs against int8 matrix limbs, the hi sum
    brought into (-p, 2p) (reduce_partial, any int32) before lo + 256 hi."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    p_max = max(plan.primes)
    half = (p_max - 1) // 2
    digit_hi = ((1 << (params.cbs_base_log - 1)) + 128) >> 8
    matrix_hi = (half + 128) >> 8
    inv = 2 * n * 128 * 128
    return {"forward lo + 256 hi":
            n * (128 + digit_hi) * (128 + 256 * matrix_hi),
            "mac": kp1 * half * half,
            "inverse hi": inv, "inverse lo + 256 hi": inv + 256 * 2 * p_max}


def check_shape(params: ParamSet, plan: ntt.NttPlan, n_bytes: int,
                n_luts: int, nbits: int) -> None:
    """Raise ValueError unless the kernel takes this call."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    if params.cbs_level != 1 or not 2 <= params.cbs_base_log <= 15 \
            or (1 << nbits) > n or n % 64 or not 2 <= kp1 <= 5:
        raise ValueError("VP kernel needs cbs_level == 1, cbs_base_log <= 15,"
                         " 2^nbits <= N, N a multiple of 64 and 2 <= k+1 <= 5")
    if plan.n_primes > 6 or max(plan.primes) >= 1 << 16 \
            or plan.fp_shift != 40 or plan.q_bits != 64 \
            or max(reduction_bounds(params, plan).values()) \
            > modular.BARRETT32_BOUND:
        raise ValueError("VP kernel needs <= 6 primes below 2^16 of a mod-2^64"
                         " plan and every reduction's input in 31 bits")
    if n_bytes < 1 or n_luts < 1:
        raise ValueError("VP kernel needs at least one byte and one LUT")
    if v1_shared_bytes(kp1, n_bytes, n_luts) > SMEM_TWO_BLOCKS:
        raise ValueError(
            f"VP kernel: {n_luts} LUT outputs a byte spread a digit tile's "
            f"{group_size(kp1)} accumulators over "
            f"{ggsw_span(kp1, n_bytes, n_luts)} bytes, more GGSW rows than "
            f"its shared memory holds; stack more outputs a byte")
    rows1, rows2 = scratch_rows(kp1, n_bytes * n_luts)
    if max(rows1, rows2) > 65535 * TILE_ROWS \
            or max(rows1, rows2) * 2 * n >= 1 << 31:
        raise ValueError(f"VP kernel: {n_bytes} bytes x {n_luts} LUT outputs "
                         f"are more rows than its grid holds")


def vp_tiles(keys: DeviceKeys) -> tuple:
    """V1's and V2's B operands of a key set's NTT matrices, made once per
    leaf (cuda_build.derived)."""
    pn = keys.plan.n_primes * keys.params.polynomial_size
    return (cuda_build.derived(
                keys.fwd_limbs, "vp forward_tiles",
                lambda m: cbr.forward_tiles(forward_matrix(m), pn)),
            cuda_build.derived(keys.vp_inv_full, "vp inverse_tiles",
                               lambda m: cbr.inverse_tiles(m, V2_COLS)))


@profiling.counted("vp_calls")
def vp_rotations_cuda(keys: DeviceKeys, acc: torch.Tensor,
                      ggsw_ntt: torch.Tensor) -> torch.Tensor:
    """acc [B, L, k+1, N] u64 words; ggsw_ntt [nbits, P, B, k+1, k+1, N]
    int32 (LSB first).  Returns acc after the nbits CMux rotations."""
    p, plan = keys.params, keys.plan
    B, L, kp1, n = acc.shape
    nbits, pcount = ggsw_ntt.shape[0], plan.n_primes
    pn = pcount * n
    check_shape(p, plan, B, L, nbits)
    expect = cuda_build.expect
    expect(acc, "acc", torch.int64,
           (B, L, p.glwe_dimension + 1, p.polynomial_size))
    expect(ggsw_ntt, "ggsw_ntt", torch.int32, (nbits, pcount, B, kp1, kp1, n))
    expect(keys.fwd_limbs, "fwd_limbs", torch.int8, (pcount, 2, 2, n, n))
    expect(keys.vp_inv_full, "vp_inv_full", torch.int8, (pcount, 2 * n, 2 * n))

    fn = _lib()
    dev = acc.device
    acc = acc.contiguous().clone()
    g = ggsw_ntt.contiguous()
    fwd, inv = vp_tiles(keys)
    rows1, rows2 = scratch_rows(kp1, B * L)
    a_buf = torch.zeros(rows1 * 2 * n, dtype=torch.int8, device=dev)
    x_buf = torch.zeros(pcount * rows2 * 2 * n, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(acc.data_ptr(), g.data_ptr(), fwd.data_ptr(), inv.data_ptr(),
                a_buf.data_ptr(), x_buf.data_ptr(),
                B, L, nbits, kp1, n, p.cbs_base_log,
                *cuda_build.prime_args(plan), stream)
    cuda_build.check(rc, "vertical-packing kernel")
    return acc
