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


def test_kmajor_tiles_layout():
    rows, k = 24, 192
    m = torch.arange(rows * k, dtype=torch.int32).reshape(rows, k)
    flat = cbr.kmajor_tiles(m).reshape(-1)
    r, c = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    off = (((c // cbr.BK) * (rows // 8) + r // 8) * 8 * cbr.BK
           + ((c % cbr.BK) // 16) * 128 + (r % 8) * 16 + c % 16)
    np.testing.assert_array_equal(flat.numpy()[off], m.numpy())


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


def emulate_kernel(plan, params, bsk, lwe, test, fwd_full, inv_crt_full,
                   rot) -> torch.Tensor:
    """What csrc/blind_rotate.cu computes, with its operand layouts: the
    digits A and the limbs X as k-major tiles, the products read back from
    the tiles the bulk copies fetch, every reduction the 32-bit Barrett
    step."""
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
    rows_x = (torch.arange(B)[:, None] * J + torch.arange(J)).reshape(-1, 1)
    for step in range(params.lwe_dimension):
        # K1: forward product -> residues -> MAC -> twiddle -> X limbs
        am = _untile(A, rows1, dn)
        tw1 = rot[tilde[:, step].long()].long() - 1              # [B, PN]
        g = bsk[step].long().reshape(R, 2 * J, PN)
        for ct in range(PN // C):
            k, c0 = ct * C // n, ct * C
            p = plan.primes[k]
            lo = am @ fwd[2 * C * ct:2 * C * ct + C].T
            hi = am @ fwd[2 * C * ct + C:2 * C * (ct + 1)].T
            dh = _red(lo + 256 * hi, p, True)
            dh = dh[:B * rpad].reshape(B, rpad, C)[:, :R]
            sl = torch.einsum("brc,rjc->bjc", dh, g[:, :J, c0:c0 + C])
            sh = torch.einsum("brc,rjc->bjc", dh, g[:, J:, c0:c0 + C])
            prod = _red(sl + 256 * _red(sh, p, True), p, True)
            delta = _red(tw1[:, None, c0:c0 + C] * prod, p, True)
            h8 = (delta + 128) >> 8
            col = (c0 - k * n) + torch.arange(C)[None, :]
            X[k][_offset(rows_x, col, rows2)] = \
                (delta - (h8 << 8)).reshape(B * J, C).to(torch.int8)
            X[k][_offset(rows_x, n + col, rows2)] = \
                h8.reshape(B * J, C).to(torch.int8)
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


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_WIDE, PARAM_TOY_R25],
                         ids=lambda p: p.name)
def test_kernel_emulation_equals_plain(params):
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
    want = blind_rotate.blind_rotate_plain(*args, k.rfwd_limbs,
                                           k.rinv_crt_limbs, k.rot_table)
    got = emulate_kernel(*args, k.fwd_full, k.inv_crt_full, k.rot_table)
    assert torch.equal(got, want)
