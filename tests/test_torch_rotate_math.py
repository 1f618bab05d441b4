"""The CUDA blind-rotate kernel's arithmetic and layouts, on the CPU.

csrc/blind_rotate.cu runs only on the card.  What it computes besides the
int8 products is checked here: its 32-bit Barrett reduction (mirrored by
modular.host_barrett32) against % over every input range the kernel feeds
it, for every prime of the rotate plans, and its operand layouts (the
k-major tiles of ops/cuda_blind_rotate.py) through a numpy emulation of
its two launches a step that must give blind_rotate_plain's words.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tfhe_aes_tpu_torch.backend import numpy_backend as nb
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import blind_rotate, keys, modular
from tfhe_aes_tpu_torch.ops import cuda_blind_rotate as cbr
from tfhe_aes_tpu_torch.params import (PARAM_OPT, PARAM_TOY, PARAM_TOY_WIDE,
                                       PARAM_TPU)
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

SETS = (PARAM_TOY, PARAM_TOY_WIDE, PARAM_TPU, PARAM_OPT)
RANGES = ("forward lo + 256 hi", "mac hi", "mac lo + 256 hi", "twiddle",
          "inverse hi", "inverse lo + 256 hi")
PRIMES = sorted({p for s in SETS for p in keys.make_rotate_plan(s).primes})
PARAM_TOY_R25 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_R25",
                                    glwe_dimension=4, pbs_level=5)


def reduction_ranges(params, plan) -> dict[str, int]:
    """The largest |x| the kernel feeds each of its 32-bit Barrett
    reductions, from the shapes (csrc/blind_rotate.cu): the forward sums
    combined unreduced (cbr.forward_sum_bound), balanced residues (< p/2)
    against int8 BSK limbs over R rows, the twiddle product of two
    balanced residues, and int8 residue limbs against int8 matrix limbs
    over 2N terms."""
    n = params.polynomial_size
    r_rows = (params.glwe_dimension + 1) * params.pbs_level
    half = (max(plan.primes) - 1) // 2
    limb = 128                                # |int8 limb of a residue|
    mac = r_rows * half * limb
    inv = 2 * n * limb * limb
    return {"forward lo + 256 hi": cbr.forward_sum_bound(params),
            "mac hi": mac, "mac lo + 256 hi": mac + 256 * half,
            "twiddle": (half + 1) * half, "inverse hi": inv,
            "inverse lo + 256 hi": inv + 256 * half}


def _check(x: np.ndarray, p: int) -> None:
    np.testing.assert_array_equal(modular.host_barrett32(x, p), x % p)
    bal = np.where(x % p > (p - 1) // 2, x % p - p, x % p)
    np.testing.assert_array_equal(modular.host_barrett32(x, p, True), bal)


@pytest.mark.parametrize("what", RANGES)
@pytest.mark.parametrize("params", SETS, ids=lambda p: p.name)
def test_barrett32_exact_over_the_kernel_range(params, what):
    """Each reduction site's input range, from the set's shapes, lies in
    the Barrett step's exact range, and the step equals % over it: both
    ends and their neighbours, multiples of p, and random samples."""
    plan = keys.make_rotate_plan(params)
    bound = reduction_ranges(params, plan)[what]
    assert bound <= modular.BARRETT32_BOUND
    rng = np.random.default_rng(bound)
    for p in plan.primes:
        ends = np.arange(-bound, -bound + 4 * p)
        edges = np.concatenate([ends, -ends, np.arange(-3 * p, 3 * p)])
        _check(edges, p)
        _check(rng.integers(-bound, bound + 1, 100_000), p)


@settings(max_examples=300, deadline=None)
@given(x=st.integers(-modular.BARRETT32_BOUND, modular.BARRETT32_BOUND),
       i=st.integers(0, len(PRIMES) - 1))
def test_barrett32_exact_hypothesis(x, i):
    _check(np.array([x]), PRIMES[i])


def test_barrett32_refuses_out_of_range():
    with pytest.raises(ValueError):
        modular.host_barrett32(np.array([modular.BARRETT32_BOUND + 1]),
                               PRIMES[0])


# -- K2's launch: one block a tile, or a cluster of one block a prime --------

@pytest.mark.parametrize("params,bits,primes,want", [
    (PARAM_OPT, 8, 5, 5), (PARAM_OPT, 9, 5, 5),      # a session's ripple add
    (PARAM_OPT, 128, 5, 5),          # key schedule, rounds: 80 tiles < 88
    (PARAM_OPT, 144, 5, 1),          # bulk ripple add, 96 tiles
    (PARAM_OPT, 2048, 5, 1),         # bulk rounds, 1280 tiles
    (PARAM_OPT, 4096, 5, 1),         # the noise study's batch
    (PARAM_TPU, 2048, 5, 1),         # the same N and primes: the same rule
    (PARAM_TOY, 9, 3, 3),            # fewer primes: a cluster of P
    (PARAM_TOY, 896, 3, 3),          # 4 x 21 = 84 tiles
    (PARAM_TOY, 897, 3, 1),          # 4 x 22 = 88 tiles
    (PARAM_TOY, 9, 1, 1),            # one prime: nothing to split
], ids=lambda v: getattr(v, "name", str(v)))
def test_k2_splits_below_a_third_of_the_h100(params, bits, primes, want):
    """K2's tiles, (N / 32) x (rows2 / 128), under a third of the 264
    blocks the H100's 132 SMs hold (2 an SM) run as clusters of one block
    a prime; from 88 tiles on, one block a tile streams every prime."""
    assert cbr.k2_cluster(params, bits, primes, 132) == want
    _, rows2 = cbr.scratch_rows(params, bits)
    tiles = params.polynomial_size // cbr.K2_COLS * rows2 // cbr.TILE_ROWS
    assert (tiles < 88) == (want > 1 or primes == 1)


# -- K1's launch: one block a tile, or the persistent walk -------------------

PARAM_WIDE_SLICE = dataclasses.replace(PARAM_TOY, name="PARAM_N2048",
                                       polynomial_size=2048)
PARAM_R35 = dataclasses.replace(PARAM_TOY, name="PARAM_R35",
                                glwe_dimension=4, pbs_level=7)
PARAM_K4 = dataclasses.replace(PARAM_TOY, name="PARAM_K4", glwe_dimension=3)


def _k1_edge(params, primes, sms=132):
    """(the last batch of one block a tile, the first persistent one)."""
    b = 1
    while not cbr.k1_persistent(params, b, primes, sms):
        b += 1
    return b - 1, b


@pytest.mark.parametrize("params,bits,primes,want", [
    (PARAM_OPT, 8, 5, False), (PARAM_OPT, 9, 5, False),    # a session's
    (PARAM_OPT, 16, 5, False),       # 160 tiles: 1.2 an SM
    (PARAM_OPT, 32, 5, False),       # the SubWord, 320 tiles: 2.4 an SM
    (PARAM_OPT, 72, 5, True),        # 720 tiles: 5.5 an SM
    (PARAM_OPT, 128, 5, True),       # key schedule, rounds: 1280 tiles
    (PARAM_OPT, 144, 5, True),       # bulk ripple add, 1440 tiles
    (PARAM_OPT, 2048, 5, True),      # bulk rounds, 20480 tiles
    (PARAM_OPT, 4096, 5, True),      # the noise study's batch
    (PARAM_TPU, 64, 5, False),       # 320 tiles, but no room for a ring
    (PARAM_TPU, 8192, 5, False),     # a 128 KB slice leaves no ring for a tile
    (PARAM_TOY, 9, 5, False),        # 10 column tiles
    (PARAM_TOY, 1024, 5, True),      # 1280 tiles
    (PARAM_WIDE_SLICE, 4096, 5, False),  # a 256 KB slice does not fit
    (PARAM_R35, 4096, 5, False),     # 35 GGSW rows
    (PARAM_K4, 4096, 5, False),      # k + 1 = 4: no instance
    (PARAM_OPT, 2048, 7, False),     # 7 primes
], ids=lambda v: getattr(v, "name", str(v)))
def test_k1_runs_persistently_where_its_tiles_pay(params, bits, primes, want):
    """K1 runs persistently from K1_TILES_PER_SM tiles an SM of the H100's
    132 on, where the resident slice fits beside a ring that holds a
    tile's A stages and one more and the kernel has an instance; below,
    where it does not fit (a 128 KB or 256 KB slice), and for other k + 1
    or more than 28 GGSW rows, one block a tile."""
    assert cbr.k1_persistent(params, bits, primes, 132) == want
    cols, row_tiles = cbr.k1_tiles(params, bits, primes)
    kp1 = params.glwe_dimension + 1
    fits = (cbr.k1_stages(params) > 0 and primes <= 6 and kp1 in (3, 5)
            and kp1 * params.pbs_level <= 28)
    assert fits == (params.name not in ("PARAM_N2048", "PARAM_R35",
                                        "PARAM_TPU", "PARAM_K4")
                    and primes <= 6)
    if fits:
        assert want == (cols * row_tiles >= cbr.K1_TILES_PER_SM * 132)


@pytest.mark.parametrize("params", [PARAM_OPT, PARAM_TOY],
                         ids=lambda p: p.name)
def test_k1_edge_lies_between_two_batches(params):
    """The last batch of one block a tile and the first persistent one lie
    on either side of K1_TILES_PER_SM tiles an SM."""
    last, first = _k1_edge(params, 5)
    tiles = [np.prod(cbr.k1_tiles(params, b, 5)) for b in (last, first)]
    edge = cbr.K1_TILES_PER_SM * 132
    assert tiles[0] < edge <= tiles[1]
    assert not cbr.k1_persistent(params, last, 5, 132)
    assert cbr.k1_persistent(params, first, 5, 132)


def test_k1_stages_fill_the_h100s_shared_memory():
    """The A stages a warpgroup beside the resident slice: 3 of 4 k-blocks
    (16 KB) where the slice is 64 KB (8-bit digits, dn = N = 512), of which
    a tile holds 2; 6 of 2 k-blocks at N = 128 (dn = 128); none where the
    slice is 128 KB (PARAM_TPU's two-limb digits: a tile holds 4, and 1
    fits) or 256 KB.  PARAM_OPT's fills the H100's 227 KB a block to
    within one stage a warpgroup."""
    assert (cbr.k1_stages(PARAM_OPT), cbr.k1_stage_kb(PARAM_OPT)) == (3, 4)
    assert (cbr.k1_stages(PARAM_TOY), cbr.k1_stage_kb(PARAM_TOY)) == (6, 2)
    assert cbr.k1_stages(PARAM_TPU) == 0
    assert cbr.k1_stages(PARAM_WIDE_SLICE) == 0
    kp1, rpad = 5, 32
    used = (512 // cbr.BK * cbr.K1_FWD_CHUNK + 2 * 2 * kp1 * rpad * cbr.K1_COLS
            + cbr.K1_DH + 4 * cbr.K1_MAX_WALK + cbr.K1_BARRIERS
            + 2 * 3 * 4 * cbr.K1_KB)
    assert used <= cbr.K1_SMEM < used + 2 * 4 * cbr.K1_KB


WALKS = {"PARAM_OPT 2048 bits": (40, 512), "PARAM_OPT 4096 bits": (40, 1024),
         "PARAM_OPT 144 bits": (40, 36), "PARAM_OPT 128 bits": (40, 32),
         "PARAM_TPU 8192 bits": (40, 1024), "toy, 10 column tiles": (10, 66)}


@pytest.mark.parametrize("shape", sorted(WALKS))
def test_walk_covers_every_tile_once_and_keeps_rows_together(shape):
    """The walk on the H100's 132 SMs takes every (column tile, row tile)
    exactly once; in each round the row tiles the blocks take lie within
    16 of each other (14 at most at these shapes), so the 3-4 blocks of a
    column tile interleave their rows instead of each running down a
    stretch of its own; the slowest block's tiles over the mean are
    1.0055 at 512 row tiles and more; a block changes column tile at most
    four times."""
    cols, row_tiles = WALKS[shape]
    sms = 132
    walks = cbr.k1_walk(cols, sms, row_tiles)
    pairs = sorted(p for w in walks for p in w)
    assert pairs == sorted((c, r) for c in range(cols)
                           for r in range(row_tiles))
    for m in range(cbr.walk_rounds(cols, sms, row_tiles)):
        rows = [rt for s in range(sms)
                for _, rt in [cbr.walk_tile(s, m, cols, sms)]
                if rt < row_tiles]
        assert max(rows) - min(rows) <= 16
    slowest = max(len(w) for w in walks) / (cols * row_tiles / sms)
    if row_tiles >= 512:
        assert round(slowest, 4) == 1.0055
    for w in walks:
        changes = sum(a[0] != b[0] for a, b in zip(w, w[1:]))
        assert changes <= 4


def test_walk_cum_is_the_rounds_count():
    """The closed form of a column tile's row tiles before round m equals
    counting the blocks that stood on its arc in each earlier round."""
    for cols, blocks in ((40, 132), (10, 3), (7, 5), (3, 132)):
        counted = np.zeros(cols, dtype=np.int64)
        for m in range(3 * cols + 7):
            assert [cbr._walk_cum(c, m, cols, blocks)
                    for c in range(cols)] == counted.tolist()
            for s in range(blocks):
                counted[((s * cols - m) % (cols * blocks)) // blocks] += 1


def test_kmajor_tiles_layout():
    rows, k = 24, 192
    m = torch.arange(rows * k, dtype=torch.int32).reshape(rows, k)
    flat = cbr.kmajor_tiles(m).reshape(-1)
    r, c = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    off = (((c // cbr.BK) * (rows // 8) + r // 8) * 8 * cbr.BK
           + ((c % cbr.BK) // 16) * 128 + (r % 8) * 16 + c % 16)
    np.testing.assert_array_equal(flat.numpy()[off], m.numpy())


@pytest.mark.parametrize("params", SETS, ids=lambda p: p.name)
def test_k2_writes_four_coefficients_a_word(params):
    """K2's CRT takes four coefficients n .. n + 3 (n % 4 == 0) of a row a
    thread; in the k-major tiles of the digits A their digits at every
    digit row lie in one aligned 4-byte word, at the offset of n (and of
    N + n for the second limb of wide digits), which decompose_store<4>
    writes at once."""
    n = params.polynomial_size
    dn = 2 * n if params.pbs_base_log > 8 else n
    rows1, _ = cbr.scratch_rows(params, 9)
    r, c = np.meshgrid(np.arange(rows1), np.arange(0, dn, 4), indexing="ij")
    first = _offset(r, c, rows1)
    assert (first % 4 == 0).all()
    for w in range(1, 4):
        np.testing.assert_array_equal(_offset(r, c + w, rows1), first + w)


# -- emulation of the kernel's two launches a step ----------------------------

def _untile(flat: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    t = flat.reshape(k // cbr.BK, rows // 8, cbr.BK // 16, 8, 16)
    return t.permute(1, 3, 0, 2, 4).reshape(rows, k).long()


def _offset(row, k, rows):
    return (((k // cbr.BK) * (rows // 8) + row // 8) * 8 * cbr.BK
            + ((k % cbr.BK) // 16) * 128 + (row % 8) * 16 + k % 16)


def _red(x: torch.Tensor, p: int, balanced: bool) -> torch.Tensor:
    return torch.from_numpy(modular.host_barrett32(
        x.reshape(-1).numpy(), p, balanced)).reshape(x.shape)


def _forward_tile(am, fwd, g, tw1, rt, ct, p, params, blocks):
    """One K1 tile, (row tile rt, column tile ct): the product of its 128
    digit rows with the column tile's forward slice, the residues, the MAC
    over each bit's R rows and the twiddle; (bits, limbs delta [bits, J,
    C]).  The persistent K1 (blocks given) takes the residues as int8 limbs
    lo + 256 hi and sums each limb's products apart."""
    J = params.glwe_dimension + 1
    R, B = J * params.pbs_level, tw1.shape[0]
    rpad = 16 if R <= 16 else 32
    C, c0 = cbr.K1_COLS, ct * cbr.K1_COLS
    rows = am[rt * cbr.TILE_ROWS:(rt + 1) * cbr.TILE_ROWS]
    lo = rows @ fwd[2 * C * ct:2 * C * ct + C].T
    hi = rows @ fwd[2 * C * ct + C:2 * C * (ct + 1)].T
    dh = _red(lo + 256 * hi, p, True).reshape(-1, rpad, C)[:, :R]
    bits = torch.arange(dh.shape[0]) + rt * (cbr.TILE_ROWS // rpad)
    dh, bits = dh[bits < B], bits[bits < B]
    gl, gh = g[:, :J, c0:c0 + C], g[:, J:, c0:c0 + C]
    if blocks is None:
        sl = torch.einsum("brc,rjc->bjc", dh, gl)
        sh = torch.einsum("brc,rjc->bjc", dh, gh)
    else:
        h8 = (dh + 128) >> 8
        l8 = dh - (h8 << 8)
        assert l8.abs().max() <= 128 and h8.abs().max() <= 128
        sl = (torch.einsum("brc,rjc->bjc", l8, gl)
              + 256 * torch.einsum("brc,rjc->bjc", h8, gl))
        sh = (torch.einsum("brc,rjc->bjc", l8, gh)
              + 256 * torch.einsum("brc,rjc->bjc", h8, gh))
    prod = _red(sl + 256 * _red(sh, p, True), p, True)
    return bits, _red(tw1[bits, None, c0:c0 + C] * prod, p, True)


def emulate_kernel(plan, params, bsk, lwe, test, fwd_full, inv_crt_full,
                   rot, blocks=None) -> torch.Tensor:
    """What csrc/blind_rotate.cu computes, with its operand layouts: the
    digits A and the limbs X as k-major tiles, the products read back from
    the tiles the bulk copies fetch, every reduction the 32-bit Barrett
    step.  K1 runs one tile at a time: one block a tile (blocks None), or
    as the persistent K1's `blocks` blocks walk cbr.k1_walk, each keeping
    its column tile's forward slice and BSK rows while it stays there."""
    n, J = params.polynomial_size, params.glwe_dimension + 1
    lev, blog = params.pbs_level, params.pbs_base_log
    P, q = plan.n_primes, plan.q_bits
    PN, R, B = P * n, J * lev, lwe.shape[0]
    wide = blog > 8
    dn = 2 * n if wide else n
    rpad = 16 if R <= 16 else 32
    rows1, rows2 = cbr.scratch_rows(params, B)
    C = cbr.K1_COLS
    tilde, acc = blind_rotate.rotate_setup(plan, params, lwe, test)
    acc = acc.reshape(-1).clone()
    fwd = _untile(cbr.forward_tiles(fwd_full, PN).reshape(-1), 2 * PN, dn)
    inv = cbr.inverse_tiles(inv_crt_full).reshape(P, -1)
    inv = [_untile(inv[k], 2 * n, 2 * n) for k in range(P)]
    A = torch.zeros(rows1 * dn, dtype=torch.int8)
    X = torch.zeros(P, rows2 * 2 * n, dtype=torch.int8)
    m2 = torch.arange(B * J).repeat_interleave(n)
    nn = torch.arange(n).repeat(B * J)
    row0 = (m2 // J) * rpad + (m2 % J) * lev
    cols, row_tiles = PN // C, rows1 // cbr.TILE_ROWS
    if blocks is None:
        walks = [[(ct, rt)] for rt in range(row_tiles) for ct in range(cols)]
    else:
        walks = cbr.k1_walk(cols, blocks, row_tiles)

    def decompose(words):
        v = words & ((1 << q) - 1)
        shift = q - blog * lev
        if shift > 0:
            v = (v + (1 << (shift - 1))) >> shift
        carry = torch.zeros_like(v)
        for l in range(lev - 1, -1, -1):
            tv = ((v >> (blog * (lev - 1 - l))) & ((1 << blog) - 1)) + carry
            carry = (tv >= 1 << (blog - 1)).long()
            d = tv - (carry << blog)
            if wide:
                h6 = (d + 32) >> 6
                A[_offset(row0 + l, nn, rows1)] = (d - (h6 << 6)).to(torch.int8)
                A[_offset(row0 + l, n + nn, rows1)] = h6.to(torch.int8)
            else:
                A[_offset(row0 + l, nn, rows1)] = d.to(torch.int8)

    decompose(acc)
    for step in range(params.lwe_dimension):
        # K1: forward product -> residues -> MAC -> twiddle -> X limbs,
        # tile by tile in each block's order
        am = _untile(A, rows1, dn)
        tw1 = rot[tilde[:, step].long()].long() - 1              # [B, PN]
        g = bsk[step].long().reshape(R, 2 * J, PN)
        done = torch.zeros(cols, row_tiles, dtype=torch.long)
        for walk in walks:
            for ct, rt in walk:
                k = ct * C // n
                bits, delta = _forward_tile(am, fwd, g, tw1, rt, ct,
                                            plan.primes[k], params, blocks)
                done[ct, rt] += 1
                h8 = (delta + 128) >> 8
                rows_x = (bits[:, None] * J + torch.arange(J)).reshape(-1, 1)
                col = (ct * C - k * n) + torch.arange(C)[None, :]
                X[k][_offset(rows_x, col, rows2)] = \
                    (delta - (h8 << 8)).reshape(-1, C).to(torch.int8)
                X[k][_offset(rows_x, n + col, rows2)] = \
                    h8.reshape(-1, C).to(torch.int8)
        assert torch.equal(done, torch.ones_like(done))
        # K2: per-prime inverse products -> canonical residues -> CRT
        x = torch.zeros(B * J, n, dtype=torch.long)
        afx = torch.zeros_like(x)
        for k, p in enumerate(plan.primes):
            xm = _untile(X[k], rows2, 2 * n)[:B * J]
            for ct in range(n // cbr.K2_COLS):
                w = cbr.K2_COLS
                lo = xm @ inv[k][2 * w * ct:2 * w * ct + w].T
                hi = xm @ inv[k][2 * w * ct + w:2 * w * (ct + 1)].T
                y = _red(lo + 256 * _red(hi, p, True), p, False)
                x[:, ct * w:(ct + 1) * w] += y * torus.signed(int(plan.mk64[k]))
                afx[:, ct * w:(ct + 1) * w] += y * int(plan.fp[k])
        alpha = (afx + (1 << 39)) >> 40
        x = x - alpha * torus.signed(int(plan.m64))
        acc = (acc + x.reshape(-1)) & ((1 << q) - 1)
        decompose(acc)
    return blind_rotate.rotate_finish(acc.reshape(B, J, n), q)


EMULATED_BLOCKS = 3      # blocks of the persistent K1's emulated walk


@pytest.mark.parametrize("blocks", [None, EMULATED_BLOCKS],
                         ids=["one block a tile", "persistent walk"])
@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_WIDE, PARAM_TOY_R25],
                         ids=lambda p: p.name)
def test_kernel_emulation_equals_plain(params, blocks):
    """Both K1s: one block a tile, and the persistent K1's walk on three
    blocks, each of which crosses at least two column tiles (keeping each
    one's slice and BSK rows while it stays), its residues summed as int8
    limbs."""
    steps = 6
    cut = dataclasses.replace(params, lwe_dimension=steps)
    client = Client(params, seed=11)
    k = client.make_device_keys(fast=False, device="cpu")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 9).astype(np.uint64)
    small = nb.lwe_encrypt(client.sk.lwe_key, bits << np.uint64(63),
                           params.lwe_noise_std, rng)
    small = np.concatenate([small[:, :steps], small[:, -1:]], axis=1)
    test = np.zeros((params.glwe_dimension + 1, params.polynomial_size),
                    np.uint64)
    test[-1] = np.uint64(1) << np.uint64(60)
    args = (k.rplan, cut, k.bsk_limbs, torus.from_u64(small),
            torus.from_u64(test))
    if blocks is not None:
        cols, row_tiles = cbr.k1_tiles(params, 9, k.rplan.n_primes)
        walks = cbr.k1_walk(cols, blocks, row_tiles)
        assert all(len({ct for ct, _ in w}) >= 2 for w in walks)
    want = blind_rotate.blind_rotate_plain(*args, k.rfwd_limbs,
                                           k.rinv_crt_limbs, k.rot_table)
    got = emulate_kernel(*args, k.fwd_full, k.inv_crt_full, k.rot_table,
                         blocks)
    assert torch.equal(got, want)
