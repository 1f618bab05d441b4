"""Wrapper of the CUDA blind-rotate kernel (csrc/blind_rotate.cu).

Counterpart of tfhe_aes_tpu/ops/pallas_blind_rotate.blind_rotate_pallas:
same inputs, same words out.  The kernel's C entry point runs all n CMux
steps on PyTorch's current stream, two launches a step; this wrapper does
the setup and the final rescale in torch, lays the NTT matrices out in the
k-major tile order the kernel's bulk copies read (``kmajor_tiles``, once
per key set: ``cuda_build.derived``), allocates the two scratch operands,
picks K1's launch (``k1_persistent``: one block a tile, or one block an SM
walking ``k1_walk``) and K2's (``k2_cluster``), and counts its calls in
utils/profiling's store: "rotate_calls", those whose K2 ran split
"rotate_split_calls" and those whose K1 ran persistently
"rotate_persistent_calls".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..params import ParamSet
from ..utils import profiling
from . import cuda_build, modular, ntt
from .blind_rotate import rotate_finish, rotate_setup

_P = ctypes.c_void_p
_I = ctypes.c_int

BK = 64            # K bytes of one tile stage (csrc/sm90_gemm.cuh kBK)
TILE_ROWS = 128    # rows of an A stage (two warpgroups)
K1_COLS = 64       # residue columns of a forward tile (kCols1)
K2_COLS = 32       # output coefficients of an inverse tile (kCols2)
K2_BLOCKS_PER_SM = 2  # K2 blocks an SM holds at once (kBlocks2)
K2_SPLIT_SHARE = 3    # split K2 below 1 / this of what the card holds
# The persistent K1 (csrc/blind_rotate_k1.cu br_forward_mac_kernel_persistent).
K1_SMEM = 232448      # shared memory one block may use on the H100
K1_KB = TILE_ROWS // 2 * BK          # a warpgroup's A rows of a k-block, 4 KB
K1_RING = 48 * 1024   # a warpgroup's A ring at most (kMaxStagesP stages)
K1_FWD_CHUNK = 2 * K1_COLS * BK       # one k-block of a column tile's fwd
K1_DH = TILE_ROWS * K1_COLS * 2       # both warpgroups' residue planes
K1_MAX_WALK = 1024    # tiles one block walks at most (kMaxWalk)
K1_BARRIERS = 1024    # bytes kept for the barriers
# The edge: K1 runs persistently from this many tiles an SM.  On the H100 at
# PARAM_OPT a whole rotation was 0.91x as long with the persistent K1 at 9.7
# tiles an SM (128 bits) and 1.03x at 2.4 (32 bits), 1.15-1.17x at 0.6-1.2
# (chip_smoke.py phase 1; PERF.md's kernel table).
K1_TILES_PER_SM = 4


def _lib():
    lib = cuda_build.load("blind_rotate")
    fn = lib.tfhe_blind_rotate
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _I, ctypes.c_uint64, _I, _I, _I, _I,
                   _P, _P]
    fn.restype = _I
    return fn


def _k1_lib():
    """The persistent K1's library (csrc/blind_rotate_k1.cu, built beside
    blind_rotate.cu): the address of its step launch, which the step loop
    calls, and its limits' set-up."""
    lib = cuda_build.load("blind_rotate_k1")
    lib.tfhe_k1_prepare.argtypes, lib.tfhe_k1_prepare.restype = [], _I
    return (ctypes.cast(lib.tfhe_k1_persistent, ctypes.c_void_p).value,
            lib.tfhe_k1_prepare)


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


def rotate_tiles(fwd_full: torch.Tensor,
                 inv_crt_full: torch.Tensor) -> tuple:
    """K1's and K2's B operands of a key set's NTT matrices, made once per
    leaf (cuda_build.derived)."""
    pn = fwd_full.shape[1] // 2
    return (cuda_build.derived(fwd_full, "forward_tiles",
                               lambda m: forward_tiles(m, pn)),
            cuda_build.derived(inv_crt_full, "inverse_tiles", inverse_tiles))


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


def k2_cluster(params: ParamSet, n_bits: int, n_primes: int,
               sm_count: int) -> int:
    """The blocks K2 spreads a tile's primes over: n_primes, a thread-block
    cluster a tile and one prime a block, while its grid of (N / 32) x
    (rows2 / 128) tiles is under a third of the blocks the card holds at
    once (K2_BLOCKS_PER_SM an SM); else 1, each block streaming all primes
    in turn.  A third: on the H100 (132 SMs, 264 blocks) at N = 512 and
    5 primes the split K2 took 0.79-0.82x the time at 80 tiles (128 bits)
    and 1.03-1.14x at 96 and 128 (144 and 192 bits), its 5-fold grid then
    queueing on the SMs."""
    _, rows2 = scratch_rows(params, n_bits)
    tiles = params.polynomial_size // K2_COLS * (rows2 // TILE_ROWS)
    split = K2_SPLIT_SHARE * tiles < K2_BLOCKS_PER_SM * sm_count
    return n_primes if split else 1


def k1_stage_kb(params: ParamSet) -> int:
    """The k-blocks of one of the persistent K1's A stages: 4 where dn / 64
    divides by 4 (half the barrier waits of 2, 6% faster at PARAM_OPT 2048
    bits on the H100), else 2."""
    n = params.polynomial_size
    dn = 2 * n if params.pbs_base_log > 8 else n
    return 4 if dn % (4 * BK) == 0 else 2


def k1_stages(params: ParamSet) -> int:
    """The A stages a consumer warpgroup of the persistent K1 rings, as many
    as fit beside what stays resident, in K1_RING at most: the column
    tile's forward slice (128 rows x dn), two buffers of the step's BSK
    rows at its 64 columns (2 (k+1) x rpad x 64 bytes each), the two
    warpgroups' residue planes, the walk and the barriers.  A warpgroup
    holds a tile's stages until its products are done, so the ring needs
    one more than those to fetch ahead; 0 where they do not fit."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    rpad = 16 if kp1 * params.pbs_level <= 16 else 32
    dn = 2 * n if params.pbs_base_log > 8 else n
    stage_kb = k1_stage_kb(params)
    fixed = (dn // BK * K1_FWD_CHUNK + 2 * 2 * kp1 * rpad * K1_COLS + K1_DH
             + 4 * K1_MAX_WALK + K1_BARRIERS)
    stages = min(K1_RING, (K1_SMEM - fixed) // 2) // (stage_kb * K1_KB)
    held = dn // BK // stage_kb
    return stages if dn % (2 * BK) == 0 and stages > held else 0


def _walk_cum(c: int, m: int, cols: int, blocks: int) -> int:
    """The row tiles of column tile c that the walk's rounds before m take:
    the rounds' block positions of column c (see k1_walk), counted in
    closed form."""
    q, r = divmod(m, cols)
    u = (cols - r + 1) % cols
    a = (c * blocks - u) % cols

    def below(x):
        return x // cols * r + min(x % cols, r)
    return blocks * q + below(a + blocks) - below(a)


def walk_tile(s: int, m: int, cols: int, blocks: int) -> tuple[int, int]:
    """(column tile, row tile) of block s in round m of the walk; the row
    tile may lie past the last one (the block then skips the round)."""
    x = (s * cols - m) % (cols * blocks)
    c = x // blocks
    return c, _walk_cum(c, m, cols, blocks) + (x - c * blocks) // cols


@functools.cache
def walk_rounds(cols: int, blocks: int, row_tiles: int) -> int:
    """The rounds the walk takes until every column tile's row tiles are
    taken."""
    m = row_tiles * cols // blocks
    while any(_walk_cum(c, m, cols, blocks) < row_tiles
              for c in range(cols)):
        m += 1
    return m


def k1_walk(cols: int, blocks: int, row_tiles: int) -> list:
    """The persistent K1's static schedule: for each of `blocks` blocks (one
    an SM) its (column tile, row tile) pairs in the order it runs them.

    Block s stands at position s * cols on a circle of cols * blocks points,
    column tile c owns the arc [c * blocks, (c + 1) * blocks), so each
    column tile holds blocks / cols blocks on average; round m turns the
    circle by one point.  In a round each block takes the next row tile of
    its column tile (the column's blocks in turn), so every column tile
    advances blocks / cols row tiles a round, within a few of the others:
    the blocks read the same digit tiles at about the same time (from L2),
    and a block changes column tile only when it crosses an arc's end,
    every `blocks` rounds.  A pure function of the three counts: the
    kernel computes the same pairs (walk_tile) and skips the row tiles past
    the last."""
    lists = [[] for _ in range(blocks)]
    for m in range(walk_rounds(cols, blocks, row_tiles)):
        for s in range(blocks):
            c, rt = walk_tile(s, m, cols, blocks)
            if rt < row_tiles:
                lists[s].append((c, rt))
    return lists


def k1_instance(params: ParamSet) -> bool:
    """Whether csrc/blind_rotate_k1.cu has an instance for the set's shape:
    k + 1 = 3 with R <= 16 GGSW rows (the toy sets) or k + 1 = 5 with
    16 < R <= 28 (PARAM_OPT's 25, the 25-row toy set)."""
    kp1 = params.glwe_dimension + 1
    r_rows = kp1 * params.pbs_level
    return (kp1 == 3 and r_rows <= 16) or (kp1 == 5 and 16 < r_rows <= 28)


def k1_tiles(params: ParamSet, n_bits: int, n_primes: int) -> tuple:
    """(column tiles, row tiles) of K1's grid."""
    rows1, _ = scratch_rows(params, n_bits)
    return n_primes * params.polynomial_size // K1_COLS, rows1 // TILE_ROWS


def k1_persistent(params: ParamSet, n_bits: int, n_primes: int,
                  sm_count: int) -> bool:
    """Whether K1 runs persistently: one block an SM walking k1_walk with
    its column tile's forward slice and BSK rows resident, and the
    epilogue of one warpgroup's row tile beside the other's products.
    Where the resident slice fits (k1_stages), the kernel has an instance
    (k1_instance), the walk is at most K1_MAX_WALK tiles a block, and K1's
    tiles are at least K1_TILES_PER_SM an SM; else one block a tile, as
    small batches want many blocks."""
    cols, row_tiles = k1_tiles(params, n_bits, n_primes)
    return (k1_stages(params) > 0 and k1_instance(params) and n_primes <= 6
            and cols * row_tiles >= K1_TILES_PER_SM * sm_count
            and walk_rounds(cols, sm_count, row_tiles) <= K1_MAX_WALK)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def forward_sum_bound(params: ParamSet) -> int:
    """The largest |lo + 256 hi| of K1's forward product, which the kernel
    reduces in one 32-bit step: dn digit limbs (|limb| <= 32 for wide
    digits, 2^(base_log-1) for narrow) against the matrix's int8 limbs of
    balanced residues (|lo| <= 128, |hi| <= 126)."""
    n, blog = params.polynomial_size, params.pbs_base_log
    dn, digit = (2 * n, 32) if blog > 8 else (n, 1 << (blog - 1))
    return dn * digit * (128 + 256 * 126)


@profiling.counted("rotate_calls")
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
    fwd, inv = rotate_tiles(fwd_full, inv_crt_full)
    bsk = bsk_limbs.contiguous()
    rot = rot_table.contiguous()
    a_buf = torch.zeros(rows1 * dn, dtype=torch.int8, device=dev)
    x_buf = torch.zeros(pcount * rows2 * 2 * n, dtype=torch.int8, device=dev)
    sms = _sm_count(dev.index)
    cluster = k2_cluster(params, B, pcount, sms)
    persistent = k1_persistent(params, B, pcount, sms)
    cols, row_tiles = k1_tiles(params, B, pcount)
    k1_launch, k1_prepare = _k1_lib()
    walk = ((sms, walk_rounds(cols, sms, row_tiles), k1_stages(params),
             k1_launch) if persistent else (0, 0, 0, None))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(k1_prepare(), "persistent K1's set-up")
        rc = fn(acc.data_ptr(), tilde.data_ptr(), tilde.shape[1],
                bsk.data_ptr(), fwd.data_ptr(), inv.data_ptr(),
                rot.data_ptr(), a_buf.data_ptr(), x_buf.data_ptr(),
                B, params.lwe_dimension, kp1, n, lev, blog, q,
                *cuda_build.prime_args(plan), cluster, *walk, stream)
    cuda_build.check(rc, "blind-rotate kernel")
    if cluster > 1:
        profiling.count("rotate_split_calls")
    if persistent:
        profiling.count("rotate_persistent_calls")
    return rotate_finish(acc, q)
