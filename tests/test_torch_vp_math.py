"""The CUDA vertical-packing kernel's arithmetic and layouts, on the CPU.

csrc/vertical_packing.cu runs only on the card.  What it computes besides
the int8 products is checked here: its 32-bit Barrett reduction (mirrored
by modular.host_barrett32) against % over every input range the kernel
feeds it, for the six primes of the mod-2^64 plans; its operand layouts
(the dense grouping of accumulators into 128-row digit tiles, the staged
GGSW rows, the k-major tiles of the forward matrix, vp_inv_full, A and X)
through a numpy emulation of its three launches a bit that must give
vp_rotations_plain's words; and what the wrapper refuses.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch.ops import cuda_blind_rotate as cbr
from tfhe_aes_tpu_torch.ops import (cuda_build, cuda_vp, keys, modular, ntt,
                                    vertical_packing)
from tfhe_aes_tpu_torch.params import PARAM_TOY, PARAM_TPU
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)
# k + 1 = 5 digit rows an accumulator, as PARAM_TPU, at N = 128.
PARAM_TOY_VP_K4 = dataclasses.replace(PARAM_TOY_VP, name="PARAM_TOY_VP_K4",
                                      glwe_dimension=4)
SETS = (PARAM_TPU, PARAM_TOY_VP, PARAM_TOY_VP_K4)
RANGES = ("forward lo + 256 hi", "mac", "inverse hi", "inverse lo + 256 hi")


def _plan(params):
    return ntt.make_plan(params.polynomial_size)


def _check(x: np.ndarray, p: int) -> None:
    np.testing.assert_array_equal(modular.host_barrett32(x, p), x % p)
    bal = np.where(x % p > (p - 1) // 2, x % p - p, x % p)
    np.testing.assert_array_equal(modular.host_barrett32(x, p, True), bal)


@pytest.mark.parametrize("what", RANGES)
@pytest.mark.parametrize("params", SETS, ids=lambda p: p.name)
def test_barrett32_exact_over_the_vp_ranges(params, what):
    """Each reduction site's input range, from the set's shapes, lies in
    the Barrett step's exact range, and the step equals % over it: both
    ends and their neighbours, multiples of p, and random samples."""
    plan = _plan(params)
    assert len(plan.primes) == 6
    bounds = cuda_vp.reduction_bounds(params, plan)
    assert sorted(bounds) == sorted(RANGES)
    bound = bounds[what]
    assert bound <= modular.BARRETT32_BOUND
    rng = np.random.default_rng(bound)
    for p in plan.primes:
        ends = np.arange(-bound, -bound + 4 * p)
        edges = np.concatenate([ends, -ends, np.arange(-3 * p, 3 * p)])
        _check(edges, p)
        _check(rng.integers(-bound, bound + 1, 100_000), p)


@pytest.mark.parametrize("params", SETS, ids=lambda p: p.name)
def test_partial_reduction_over_the_inverse_hi_range(params):
    """reduce_partial keeps the residue and lands in (-p, 2p) over the
    whole range of the inverse product's hi sums (and of int32)."""
    plan = _plan(params)
    bound = cuda_vp.reduction_bounds(params, plan)["inverse hi"]
    rng = np.random.default_rng(bound)
    for p in plan.primes:
        for top in (bound, (1 << 31) - 1):
            x = np.concatenate([np.arange(-top, -top + 4 * p),
                                np.arange(top - 4 * p, top + 1),
                                np.arange(-3 * p, 3 * p),
                                rng.integers(-top, top + 1, 100_000)])
            r = modular.host_partial32(x, p)
            np.testing.assert_array_equal(r % p, x % p)
            assert -p < r.min() and r.max() < 2 * p


def test_forward_sum_takes_one_reduction_up_to_n512():
    """At N = 512 the forward product's lo + 256 hi stays inside the exact
    range unreduced; at N = 1024 it would not, and the wrapper refuses."""
    wide = dataclasses.replace(PARAM_TPU, polynomial_size=1024)
    plan = _plan(PARAM_TPU)
    assert cuda_vp.reduction_bounds(PARAM_TPU, plan)["forward lo + 256 hi"] \
        <= modular.BARRETT32_BOUND
    assert cuda_vp.reduction_bounds(wide, plan)["forward lo + 256 hi"] \
        > modular.BARRETT32_BOUND
    with pytest.raises(ValueError, match="31 bits"):
        cuda_vp.check_shape(wide, plan, 16, 8, 8)


def test_mac_sums_need_no_limb_split():
    """k + 1 = 5 products of balanced residues of the largest prime stay
    inside the exact range, so the MAC sums them in int32 as they are."""
    half = (max(_plan(PARAM_TPU).primes) - 1) // 2
    assert 5 * half * half <= modular.BARRETT32_BOUND < 6 * half * half


# -- the layouts' arithmetic --------------------------------------------------

@pytest.mark.parametrize("kp1", [2, 3, 4, 5])
def test_ggsw_span_covers_every_tile(kp1):
    """The staged bytes b0 .. b0 + span - 1 hold the byte of every
    accumulator of every digit tile, at any LUT count and byte count."""
    group = cuda_vp.group_size(kp1)
    assert group * kp1 <= cuda_vp.TILE_ROWS < (group + 1) * kp1
    for n_luts in range(1, 41):
        for n_bytes in (1, 2, 5, 16, 37):
            span = cuda_vp.ggsw_span(kp1, n_bytes, n_luts)
            accs = n_bytes * n_luts
            for a0 in range(0, accs, group):
                last = min(a0 + group, accs) - 1
                assert last // n_luts - a0 // n_luts < span
            assert span <= n_bytes


def test_scratch_rows():
    # 512 bytes x 24 outputs at k+1 = 5: 12288 accumulators, 25 a tile
    assert cuda_vp.scratch_rows(5, 512 * 24) == (492 * 128, 61440)
    assert cuda_vp.scratch_rows(5, 26) == (256, 256)
    assert cuda_vp.scratch_rows(3, 42) == (128, 128)
    assert cuda_vp.scratch_rows(3, 43) == (256, 256)


# -- what the wrapper refuses -------------------------------------------------

def test_wrapper_takes_the_paths_shapes():
    plan = _plan(PARAM_TPU)
    for n_luts in (8, 9, 16, 24, 32):
        for n_bytes in (4, 12, 16, 64, 512):
            cuda_vp.check_shape(PARAM_TPU, plan, n_bytes, n_luts, 8)
            assert cuda_vp.v1_shared_bytes(5, n_bytes, n_luts) \
                <= cuda_vp.SMEM_TWO_BLOCKS
    cuda_vp.check_shape(PARAM_TPU, plan, 32, 9, 9)


@pytest.mark.parametrize("case", ["cbs_level", "nbits", "few_luts",
                                  "wide_digit", "rows"])
def test_wrapper_refuses(case):
    params, n_bytes, n_luts, nbits = PARAM_TPU, 16, 8, 8
    if case == "cbs_level":
        params = dataclasses.replace(PARAM_TPU, cbs_level=2, cbs_base_log=10)
    elif case == "nbits":
        nbits = 10                        # 2^10 > N = 512
    elif case == "few_luts":
        n_luts = 3                        # 25 accumulators over 9 bytes
        assert cuda_vp.ggsw_span(5, n_bytes, n_luts) == 9
    elif case == "wide_digit":
        params = dataclasses.replace(PARAM_TPU, cbs_base_log=16)
    elif case == "rows":
        n_bytes = 1 << 17                 # 2N x rows of A pass 2^31 bytes
    with pytest.raises(ValueError, match="VP kernel"):
        cuda_vp.check_shape(params, _plan(params), n_bytes, n_luts, nbits)


def test_wrapper_takes_few_luts_of_few_bytes():
    """Few LUT outputs are refused only where they spread a tile over more
    bytes than shared memory holds."""
    cuda_vp.check_shape(PARAM_TPU, _plan(PARAM_TPU), 7, 1, 8)
    cuda_vp.check_shape(PARAM_TPU, _plan(PARAM_TPU), 512, 4, 8)


def test_derived_operands_are_built_once_per_leaf():
    calls = []

    def build(m):
        calls.append(1)
        return m + 1

    leaf = torch.arange(4)
    first = cuda_build.derived(leaf, "test", build)
    assert cuda_build.derived(leaf, "test", build) is first
    assert len(calls) == 1
    other = torch.arange(4)
    assert cuda_build.derived(other, "test", build) is not first
    assert len(calls) == 2
    n_held = len(cuda_build._derived)
    del leaf, other
    gc.collect()
    assert len(cuda_build._derived) == n_held - 2


# -- emulation of the kernel's three launches a bit ---------------------------

def _untile(flat: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    t = flat.reshape(k // cbr.BK, rows // 8, cbr.BK // 16, 8, 16)
    return t.permute(1, 3, 0, 2, 4).reshape(rows, k).long()


def _offset(row, k, rows):
    return (((k // cbr.BK) * (rows // 8) + row // 8) * 8 * cbr.BK
            + ((k % cbr.BK) // 16) * 128 + (row % 8) * 16 + k % 16)


def _red(x: torch.Tensor, p: int, balanced: bool) -> torch.Tensor:
    return torch.from_numpy(modular.host_barrett32(
        x.reshape(-1).numpy(), p, balanced)).reshape(x.shape)


def emulate_kernel(k, acc: torch.Tensor, ggsw: torch.Tensor) -> torch.Tensor:
    """What csrc/vertical_packing.cu computes, with its operand layouts:
    the digits A (accumulators grouped densely into 128-row tiles) and the
    limbs X as k-major tiles, the products read back from the tiles the
    bulk copies fetch, the GGSW rows of the bytes a block stages, every
    reduction the 32-bit Barrett step."""
    p, plan = k.params, k.plan
    B, L, J, n = acc.shape
    P, blog, nbits = plan.n_primes, p.cbs_base_log, ggsw.shape[0]
    PN, accs, T = P * n, B * L, cuda_vp.TILE_ROWS
    cuda_vp.check_shape(p, plan, B, L, nbits)
    group, span = cuda_vp.group_size(J), cuda_vp.ggsw_span(J, B, L)
    rows1, rows2 = cuda_vp.scratch_rows(J, accs)
    C, W = cbr.K1_COLS, cuda_vp.V2_COLS
    fwd = _untile(cbr.forward_tiles(cuda_vp.forward_matrix(k.fwd_limbs),
                                    PN).reshape(-1), 2 * PN, 2 * n)
    inv = cbr.inverse_tiles(k.vp_inv_full, W).reshape(P, -1)
    inv = [_untile(inv[i], 2 * n, 2 * n) for i in range(P)]
    words = acc.reshape(accs * J, n).clone()
    A = torch.zeros(rows1 * 2 * n, dtype=torch.int8)
    X = torch.zeros(P, rows2 * 2 * n, dtype=torch.int8)
    m = torch.arange(accs * J).repeat_interleave(n)
    nn = torch.arange(n).repeat(accs * J)
    a_of = m // J
    a_row = (a_of // group) * T + (a_of % group) * J + m % J
    jj, cc = torch.arange(J)[:, None], torch.arange(C)[None, :]
    for bit in range(nbits):
        # digits: X^(-c) acc - acc, one balanced digit, two int8 limbs
        idx = torch.arange(n) + (1 << bit)
        rot = torch.where(idx < n, words[:, idx % n], -words[:, idx % n])
        vbar = torus.shr(rot - words + (1 << (63 - blog)), 64 - blog)
        raw = vbar & ((1 << blog) - 1)
        d = raw - ((raw >= 1 << (blog - 1)).long() << blog)
        h8 = (d + 128) >> 8
        for i, limb in enumerate((d - (h8 << 8), h8)):
            assert -128 <= int(limb.min()) and int(limb.max()) <= 127
            A[_offset(a_row, i * n + nn, rows1)] = \
                limb.reshape(-1).to(torch.int8)
        # V1: forward product -> residues -> MAC against the staged rows
        am = _untile(A, rows1, 2 * n)
        for rt in range(rows1 // T):
            a0 = rt * group
            b0 = a0 // L
            tile = am[rt * T:(rt + 1) * T]
            for ct in range(PN // C):
                kk, c0 = ct * C // n, ct * C
                n0, prime = c0 - kk * n, plan.primes[kk]
                lo = tile @ fwd[2 * C * ct:2 * C * ct + C].T
                hi = tile @ fwd[2 * C * ct + C:2 * C * (ct + 1)].T
                dh = _red(lo + 256 * hi, prime, True)
                staged = ggsw[bit, kk, b0:b0 + min(span, B - b0), :, :,
                              n0:n0 + C].long()
                for gl in range(min(group, accs - a0)):
                    a = a0 + gl
                    s = torch.einsum("uc,ujc->jc", dh[gl * J:(gl + 1) * J],
                                     staged[a // L - b0])
                    delta = _red(s, prime, True)
                    h8 = (delta + 128) >> 8
                    X[kk][_offset(a * J + jj, n0 + cc, rows2)] = \
                        (delta - (h8 << 8)).to(torch.int8)
                    X[kk][_offset(a * J + jj, n + n0 + cc, rows2)] = \
                        h8.to(torch.int8)
        # V2: per-prime inverse products -> canonical residues -> CRT
        x = torch.zeros(accs * J, n, dtype=torch.long)
        afx = torch.zeros_like(x)
        for kk, prime in enumerate(plan.primes):
            xm = _untile(X[kk], rows2, 2 * n)[:accs * J]
            for ct in range(n // W):
                lo = xm @ inv[kk][2 * W * ct:2 * W * ct + W].T
                hi = xm @ inv[kk][2 * W * ct + W:2 * W * (ct + 1)].T
                part = torch.from_numpy(modular.host_partial32(hi.numpy(),
                                                               prime))
                y = _red(lo + 256 * part, prime, False)
                x[:, ct * W:(ct + 1) * W] += y * torus.signed(
                    int(plan.mk64[kk]))
                afx[:, ct * W:(ct + 1) * W] += y * int(plan.fp[kk])
        alpha = (afx + (1 << 39)) >> 40
        words = words + x - alpha * torus.signed(int(plan.m64))
    return words.reshape(B, L, J, n)


def _toy_keys(params):
    """A key set with the plans' constant leaves only: the rotations read
    no key material besides the GGSW they are given."""
    plan, rplan = _plan(params), keys.make_rotate_plan(params)
    none = torch.zeros(1, dtype=torch.int8)
    return keys._keys_from_arrays(params, plan, rplan, dict(
        bsk_limbs=none, ksk_limbs=none, pfpksk_limbs=none,
        **keys.host_leaves(plan, rplan, params)))


@pytest.mark.parametrize("params,n_bytes,n_luts", [
    (PARAM_TOY_VP, 7, 9),       # 63 accumulators: tiles of 42 and 21
    (PARAM_TOY_VP_K4, 5, 9),    # 45 accumulators: tiles of 25 and 20
    (PARAM_TOY_VP_K4, 3, 24),   # 72 accumulators, the AES rounds' 24 outputs
], ids=lambda v: getattr(v, "name", str(v)))
def test_kernel_emulation_equals_plain(params, n_bytes, n_luts):
    k = _toy_keys(params)
    plan, n = k.plan, params.polynomial_size
    kp1, nbits = params.glwe_dimension + 1, 7
    rows1, rows2 = cuda_vp.scratch_rows(kp1, n_bytes * n_luts)
    assert rows1 > cuda_vp.TILE_ROWS                # more than one digit tile
    assert n_bytes * n_luts % cuda_vp.group_size(kp1)       # a ragged group
    assert n_bytes * n_luts * kp1 % cuda_vp.TILE_ROWS       # a ragged X tile
    rng = np.random.default_rng(n_bytes * n_luts)
    acc = torus.from_u64(rng.integers(
        0, 1 << 64, (n_bytes, n_luts, kp1, n), dtype=np.uint64))
    ggsw = torch.stack([torch.from_numpy(rng.integers(
        -(q - 1) // 2, (q - 1) // 2 + 1, (nbits, n_bytes, kp1, kp1, n)
    ).astype(np.int32)) for q in plan.primes], dim=1)
    want = vertical_packing.vp_rotations_plain(k, acc, ggsw)
    got = emulate_kernel(k, acc, ggsw)
    assert torch.equal(got, want)
