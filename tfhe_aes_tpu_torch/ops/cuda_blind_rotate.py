"""Wrapper of the CUDA blind-rotate kernel (csrc/blind_rotate.cu).

Counterpart of tfhe_aes_tpu/ops/pallas_blind_rotate.blind_rotate_pallas:
same inputs, same words out.  The kernel's C entry point runs all n CMux
steps on PyTorch's current stream, two launches a step; this wrapper does
the setup and the final rescale in torch, lays the NTT matrices out in the
k-major tile order the kernel's bulk copies read (``kmajor_tiles``, once
per key set: ``cuda_build.derived``), allocates the two scratch operands,
and counts its launches in ``blind_rotate_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import ParamSet
from . import cuda_build, modular, ntt
from .blind_rotate import rotate_finish, rotate_setup

_P = ctypes.c_void_p
_I = ctypes.c_int

BK = 64            # K bytes of one tile stage (csrc/sm90_gemm.cuh kBK)
TILE_ROWS = 128    # rows of an A stage (two warpgroups)
K1_COLS = 64       # residue columns of a forward tile (kCols1)
K2_COLS = 32       # output coefficients of an inverse tile (kCols2)


def _lib():
    lib = cuda_build.load("blind_rotate")
    fn = lib.tfhe_blind_rotate
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _I, ctypes.c_uint64, _P]
    fn.restype = _I
    return fn


def kmajor_tiles(m: torch.Tensor) -> torch.Tensor:
    """[..., rows, K] -> the k-major tile order of csrc/sm90_gemm.cuh:
    [..., K / BK, rows / 8, BK / 16, 8, 16], contiguous (rows % 8 == 0,
    K % BK == 0)."""
    *lead, rows, k = m.shape
    t = m.reshape(*lead, rows // 8, 8, k // BK, BK // 16, 16)
    n = len(lead)
    return t.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4).contiguous()


def forward_tiles(fwd_full: torch.Tensor, pn: int) -> torch.Tensor:
    """fwd_cat [dn, 2PN] -> K1's B operand: for each 64-column tile its 64
    lo rows then its 64 hi rows, k-major (pn % 64 == 0)."""
    dn = fwd_full.shape[0]
    n_tiles = pn // K1_COLS
    t = fwd_full.t().reshape(2, n_tiles, K1_COLS, dn).transpose(0, 1)
    return kmajor_tiles(t.reshape(2 * pn, dn))


def inverse_tiles(inv_crt_full: torch.Tensor,
                  cols: int = K2_COLS) -> torch.Tensor:
    """inv_crt_full [P, 2N, 2N] (x @ M) -> K2's B operand per prime: for
    each tile of `cols` coefficients its lo rows then its hi rows, k-major."""
    pcount, two_n, _ = inv_crt_full.shape
    n = two_n // 2
    t = inv_crt_full.transpose(1, 2).reshape(pcount, 2, n // cols, cols,
                                             two_n).transpose(1, 2)
    return kmajor_tiles(t.reshape(pcount, two_n, two_n))


def scratch_rows(params: ParamSet, n_bits: int) -> tuple[int, int]:
    """(rows of the digit operand A, rows a prime of X): bits padded to
    whole 128-row tiles of R rows padded to 16 or 32; B (k+1) padded to
    128."""
    kp1 = params.glwe_dimension + 1
    rpad = 16 if kp1 * params.pbs_level <= 16 else 32
    per_tile = TILE_ROWS // rpad
    rows1 = -(-n_bits // per_tile) * TILE_ROWS
    rows2 = -(-n_bits * kp1 // TILE_ROWS) * TILE_ROWS
    return rows1, rows2


def forward_sum_bound(params: ParamSet) -> int:
    """The largest |lo + 256 hi| of K1's forward product, which the kernel
    reduces in one 32-bit step: dn digit limbs (|limb| <= 32 for wide
    digits, 2^(base_log-1) for narrow) against the matrix's int8 limbs of
    balanced residues (|lo| <= 128, |hi| <= 126)."""
    n, blog = params.polynomial_size, params.pbs_base_log
    dn, digit = (2 * n, 32) if blog > 8 else (n, 1 << (blog - 1))
    return dn * digit * (128 + 256 * 126)


def blind_rotate_cuda(plan: ntt.NttPlan, params: ParamSet,
                      bsk_limbs: torch.Tensor, lwe_ct: torch.Tensor,
                      test_glwe: torch.Tensor, fwd_full: torch.Tensor,
                      inv_crt_full: torch.Tensor,
                      rot_table: torch.Tensor) -> torch.Tensor:
    """lwe_ct [B, n+1] -> acc [B, k+1, N] u64 words, on the card."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    lev, blog = params.pbs_level, params.pbs_base_log
    pcount, q = plan.n_primes, plan.q_bits
    pn, r_rows = pcount * n, kp1 * lev
    dn = 2 * n if blog > 8 else n
    B = lwe_ct.shape[0]
    rows1, rows2 = scratch_rows(params, B)
    if (blog > 12 or n % 64 or r_rows > 32 or not 2 <= kp1 <= 5
            or pcount > 6 or B < 1 or max(rows1, rows2) > 65535 * TILE_ROWS
            or max(rows1 * dn, rows2 * 2 * n) >= 1 << 31
            or forward_sum_bound(params) > modular.BARRETT32_BOUND
            or max(plan.primes) >= 1 << 16 or plan.fp_shift != 40):
        raise ValueError(
            "blind-rotate kernel needs base_log <= 12, N a multiple of 64, "
            "(k+1) * levels <= 32, 2 <= k+1 <= 5, <= 6 primes below 2^16, "
            "forward sums in 31 bits and a batch its grid holds; got "
            f"N={n}, base_log={blog}, k+1={kp1}, "
            f"levels={lev}, {pcount} primes, {B} bits")
    expect = cuda_build.expect
    expect(lwe_ct, "lwe_ct", torch.int64, (B, params.lwe_dimension + 1))
    if bsk_limbs.shape[0] < params.lwe_dimension:
        raise ValueError("bsk_limbs has fewer steps than lwe_dimension")
    expect(bsk_limbs, "bsk_limbs", torch.int8,
           (bsk_limbs.shape[0], r_rows * 2 * kp1, pn))
    expect(fwd_full, "fwd_full", torch.int8, (dn, 2 * pn))
    expect(inv_crt_full, "inv_crt_full", torch.int8, (pcount, 2 * n, 2 * n))
    expect(rot_table, "rot_table", torch.int16, (2 * n, pn))

    fn = _lib()
    dev = lwe_ct.device
    tilde, acc = rotate_setup(plan, params, lwe_ct, test_glwe)
    tilde = tilde.contiguous()
    acc = acc.contiguous().clone()
    fwd = cuda_build.derived(fwd_full, "forward_tiles",
                             lambda m: forward_tiles(m, pn))
    inv = cuda_build.derived(inv_crt_full, "inverse_tiles", inverse_tiles)
    bsk = bsk_limbs.contiguous()
    rot = rot_table.contiguous()
    a_buf = torch.zeros(rows1 * dn, dtype=torch.int8, device=dev)
    x_buf = torch.zeros(pcount * rows2 * 2 * n, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(acc.data_ptr(), tilde.data_ptr(), tilde.shape[1],
                bsk.data_ptr(), fwd.data_ptr(), inv.data_ptr(),
                rot.data_ptr(), a_buf.data_ptr(), x_buf.data_ptr(),
                B, params.lwe_dimension, kp1, n, lev, blog, q,
                *cuda_build.prime_args(plan), stream)
    blind_rotate_cuda.launches += 1
    cuda_build.check(rc, "blind-rotate kernel")
    return rotate_finish(acc, q)


blind_rotate_cuda.launches = 0
