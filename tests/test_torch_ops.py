"""The torch port's ops against the JAX package's, word for word (CPU).

Same seeded numpy inputs through the jnp function and its torch
counterpart; every comparison is exact (integer arithmetic throughout).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.params import PARAM_TOY, PARAM_TOY_WIDE
from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.ops import decompose as jdec
from tfhe_aes_tpu.ops import keys as jkeys
from tfhe_aes_tpu.ops import keyswitch as jks
from tfhe_aes_tpu.ops import lwe as jlwe
from tfhe_aes_tpu.ops import modular as jmod
from tfhe_aes_tpu.ops import ntt as jntt
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import decompose, keys, keyswitch, lwe, modular, ntt
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

U64 = np.uint64
EDGES = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
                  (1 << 64) - 1, (1 << 62), 3 << 62], dtype=U64)


def _u64(rng, shape):
    return np.concatenate([
        rng.integers(0, 1 << 64, size=int(np.prod(shape)) - len(EDGES),
                     dtype=U64), EDGES]).reshape(shape)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype == U64:
        np.testing.assert_array_equal(torus.to_u64(got), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# -- torus carrier -----------------------------------------------------------

def test_torus_roundtrip_and_wraps():
    rng = np.random.default_rng(0)
    a, b = _u64(rng, (64,)), _u64(rng, (64,))[::-1].copy()
    ta, tb = torus.from_u64(a), torus.from_u64(b)
    np.testing.assert_array_equal(torus.to_u64(ta), a)
    _same(ta + tb, a + b)
    _same(ta - tb, a - b)
    _same(ta * tb, a * b)
    _same(-ta, U64(0) - a)


@pytest.mark.parametrize("k", [0, 1, 8, 16, 49, 63])
def test_torus_logical_shift(k):
    a = _u64(np.random.default_rng(k), (64,))
    _same(torus.shr(torus.from_u64(a), k), a >> U64(k))


def test_torus_unsigned_compare_and_constants():
    rng = np.random.default_rng(1)
    a, b = _u64(rng, (64,)), _u64(rng, (64,))[::-1].copy()
    ta, tb = torus.from_u64(a), torus.from_u64(b)
    np.testing.assert_array_equal(torus.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal((~torus.ult(ta, tb)).numpy(), a >= b)
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 64):
        t = torch.tensor(torus.signed(v), dtype=torch.int64)
        assert int(t.numpy().view(U64)) == v % (1 << 64)
        assert torus.signed(v) == int(np.array(v % (1 << 64), U64)
                                      .view(np.int64))


# -- modular, lwe, decompose --------------------------------------------------

def test_barrett_and_limbs():
    p = 64513
    rng = np.random.default_rng(2)
    t = rng.integers(-(1 << 30), 1 << 30, size=4096).astype(np.int32)
    t[:4] = [0, p // 2, -(p // 2), (1 << 30) - 1]
    inv = float(np.float32(1.0 / p))
    got = modular.barrett_reduce(torch.from_numpy(t), p, inv)
    _same(got, jmod.barrett_reduce(jnp.asarray(t), p, inv))
    x = (t % p - p // 2).astype(np.int32)
    for g, w in zip(modular.to_balanced_limbs2(torch.from_numpy(x)),
                    jmod.to_balanced_limbs2(jnp.asarray(x))):
        _same(g, w)
    np.testing.assert_array_equal(modular.host_balanced(t, p),
                                  jmod.host_balanced(t, p))
    np.testing.assert_array_equal(modular.host_balanced_limbs2(x),
                                  jmod.host_balanced_limbs2(x))


@pytest.mark.parametrize("two_n", [256, 1024])
def test_modswitch(two_n):
    a = _u64(np.random.default_rng(3), (9, 33))
    _same(lwe.modswitch(torus.from_u64(a), two_n),
          jlwe.modswitch(jnp.asarray(a), two_n))


def test_rotations_and_extract():
    rng = np.random.default_rng(4)
    polys = _u64(rng, (5, 3, 128))
    amounts = rng.integers(0, 256, size=5).astype(np.int32)
    _same(lwe.neg_rotate(torus.from_u64(polys),
                         torch.from_numpy(amounts)[:, None]),
          jlwe.neg_rotate(jnp.asarray(polys), jnp.asarray(amounts)[:, None]))
    for amount in (0, 1, 127, 128, 200, 255):
        _same(lwe.neg_rotate_const(torus.from_u64(polys), amount),
              jlwe.neg_rotate_const(jnp.asarray(polys), amount))
    _same(lwe.sample_extract0(torus.from_u64(polys)),
          jlwe.sample_extract0(jnp.asarray(polys)))


def test_lwe_trivial():
    rng = np.random.default_rng(12)
    m = _u64(rng, (3, 5))
    for n in (1, 32):
        _same(lwe.lwe_trivial(torus.from_u64(m), n),
              jlwe.lwe_trivial(jnp.asarray(m), n))


@pytest.mark.parametrize("base_log,levels,q_bits",
                         [(8, 4, 48), (12, 3, 48), (2, 6, 64), (12, 3, 64),
                          (15, 1, 64)])
def test_gadget_decompose(base_log, levels, q_bits):
    v = _u64(np.random.default_rng(base_log), (4, 3, 64))
    if q_bits < 64:
        v = v & U64((1 << q_bits) - 1)
    _same(decompose.gadget_decompose(torus.from_u64(v), base_log, levels,
                                     q_bits),
          jdec.gadget_decompose(jnp.asarray(v), base_log, levels, q_bits))
    _same(decompose.glwe_digits_flat(torus.from_u64(v), base_log, levels,
                                     q_bits),
          jdec.glwe_digits_flat(jnp.asarray(v), base_log, levels, q_bits))


# -- ntt: host plan tables and device half ------------------------------------

@pytest.fixture(scope="module")
def plans():
    rplan_j = jkeys.make_rotate_plan(PARAM_TOY_WIDE)
    plan_j = jntt.make_plan(128)
    return ((plan_j, ntt.make_plan(128)),
            (rplan_j, keys.make_rotate_plan(PARAM_TOY_WIDE)))


def test_make_plan_tables_equal_jax(plans):
    for pj, pt in plans:
        assert pt.primes == pj.primes and pt.q_bits == pj.q_bits
        for f in ("fwd_limbs", "inv_limbs", "inv_crt_limbs", "p_i32",
                  "inv_f32", "mk64", "fp", "pow2_8i", "rot_table"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f), f)
        assert int(pt.m64) == int(pj.m64) and pt.fp_shift == pj.fp_shift
        for fn in ("inv_crt_full_host", "fwd_full_host", "fwd_full_wide_host",
                   "fwd_cat3_host", "rot_table_merged"):
            np.testing.assert_array_equal(getattr(ntt, fn)(pt),
                                          getattr(jntt, fn)(pj), fn)
        for blog in (8, 12):
            np.testing.assert_array_equal(ntt.fwd_cat_for(pt, blog),
                                          jntt.fwd_cat_for(pj, blog))


def _res(rng, plan, shape):
    """Balanced residues [P, *shape] of random values."""
    return np.stack([modular.host_balanced(rng.integers(0, 1 << 30, shape), p)
                     for p in plan.primes]).astype(np.int32)


def test_forward_transforms(plans):
    (pj, pt), _ = plans
    rng = np.random.default_rng(6)
    fwd = pj.fwd_limbs
    d8 = rng.integers(-128, 128, size=(3, 6, 128)).astype(np.int8)
    _same(ntt.ntt_fwd_digits(pt, torch.from_numpy(d8), torch.from_numpy(fwd)),
          jntt.ntt_fwd_digits(pj, jnp.asarray(d8), jnp.asarray(fwd)))
    d15 = rng.integers(-(1 << 14), 1 << 14, size=(3, 6, 128)).astype(np.int32)
    _same(ntt.ntt_fwd_wide(pt, torch.from_numpy(d15), torch.from_numpy(fwd)),
          jntt.ntt_fwd_wide(pj, jnp.asarray(d15), jnp.asarray(fwd)))
    res = _res(rng, pj, (4, 128))
    _same(ntt.ntt_fwd_residues(pt, torch.from_numpy(res),
                               torch.from_numpy(fwd)),
          jntt.ntt_fwd_residues(pj, jnp.asarray(res), jnp.asarray(fwd)))


def test_macs_and_rotate_delta(plans):
    _, (pj, pt) = plans
    rng = np.random.default_rng(7)
    dhat = _res(rng, pj, (2, 4, 6, 128))            # [P, B, F, R, N]
    ghat = _res(rng, pj, (2, 6, 3, 128))            # [P, B, R, J, N]
    _same(ntt.mac_batched(pt, torch.from_numpy(dhat), torch.from_numpy(ghat)),
          jntt.mac_batched(pj, jnp.asarray(dhat), jnp.asarray(ghat)))
    d = _res(rng, pj, (3, 9, 128))                  # [P, B, R, N]
    dl, dh = jmod.to_balanced_limbs2(jnp.asarray(d))
    g = rng.integers(-128, 128, size=(pj.n_primes, 9 * 6, 128)).astype(np.int8)
    want = jntt.mac_rows(pj, dl, dh, jnp.asarray(g), 3)
    got = ntt.mac_rows(pt, torch.from_numpy(np.array(dl)),
                       torch.from_numpy(np.array(dh)), torch.from_numpy(g), 3)
    _same(got, want)
    tw = _res(rng, pj, (3, 128))
    p_j, inv_j, _ = jntt._prime_consts(pj, 4)
    p_t, inv_t, _ = ntt._prime_consts(pt, 4, "cpu")
    _same(ntt.barrett_rotate_delta(pt, got, torch.from_numpy(tw), p_t, inv_t),
          jntt.barrett_rotate_delta(pj, want, jnp.asarray(tw), p_j, inv_j))


def test_pointwise_mac_equals_jax_and_the_limb_macs(plans):
    """The golden elementwise MAC against the JAX one, dhat
    relaxed-balanced (|.| <= p) and ghat balanced; then the limb MACs
    (mac_batched, mac_shared) against it, as tests/test_device_ntt.py
    holds the JAX ones."""
    _, (pj, pt) = plans
    rng = np.random.default_rng(13)
    P, B, F, R, J, n = pj.n_primes, 3, 2, 7, 5, 128
    primes = np.array(pj.primes, dtype=np.int64)[:, None, None, None, None]
    dhat = (rng.integers(-1 << 20, 1 << 20, (P, B, F, R, n)) % (2 * primes + 1)
            - primes).astype(np.int32)                  # |.| <= p
    half = primes // 2
    ghat = (rng.integers(-1 << 20, 1 << 20, (P, B, R, J, n)) % (2 * half + 1)
            - half).astype(np.int32)                    # |.| <= p/2
    want = jntt.pointwise_mac(pj, jnp.asarray(dhat), jnp.asarray(ghat[:, :, None]))
    got = ntt.pointwise_mac(pt, torch.from_numpy(dhat),
                            torch.from_numpy(ghat[:, :, None]))
    assert got.dtype == torch.int32
    _same(got, want)
    bal = (dhat + primes) % primes                      # balanced dhat
    bal = np.where(bal > primes // 2, bal - primes, bal).astype(np.int32)
    golden = ntt.pointwise_mac(pt, torch.from_numpy(bal),
                               torch.from_numpy(ghat[:, :, None]))
    assert torch.equal(ntt.mac_batched(pt, torch.from_numpy(bal),
                                       torch.from_numpy(ghat)), golden)
    golden_s = ntt.pointwise_mac(pt, torch.from_numpy(bal[:, :, 0]),
                                 torch.from_numpy(ghat[:, None, 0]))
    assert torch.equal(ntt.mac_shared(pt, torch.from_numpy(bal[:, :, 0]),
                                      torch.from_numpy(ghat[:, 0])), golden_s)


@pytest.mark.parametrize("which", ["torus64", "rotate48"])
def test_intt_crt_and_residues(plans, which):
    pj, pt = plans[0] if which == "torus64" else plans[1]
    rng = np.random.default_rng(8)
    res = _res(rng, pj, (3, 5, 128))
    inv = pj.inv_crt_limbs
    _same(ntt.intt_crt_u64(pt, torch.from_numpy(res), torch.from_numpy(inv)),
          jntt.intt_crt_u64(pj, jnp.asarray(res), jnp.asarray(inv)))
    x = _u64(rng, (3, 5, 128))
    _same(ntt.u64_to_residues(pt, torus.from_u64(x)),
          jntt.u64_to_residues(pj, jnp.asarray(x)))


# -- keyswitch, keys, client ---------------------------------------------------

def test_int8_dot_shapes():
    rng = np.random.default_rng(9)
    for m, k, n in ((1, 5, 3), (17, 64, 24), (40, 6147, 16), (3, 8, 9)):
        a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
        b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
        got = ntt.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(),
                                      a.astype(np.int64) @ b.astype(np.int64))


@pytest.fixture(scope="module")
def toy_keys():
    jc = JaxClient(PARAM_TOY, seed=11)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=11)
    return jc, jd, tc, tc.make_device_keys(fast=False, device="cpu")


def test_make_device_keys_equal_jax(toy_keys):
    _, jd, _, td = toy_keys
    for name in keys.KEY_LEAVES:
        got = getattr(td, name)
        want = np.asarray(getattr(jd, name))
        assert got.dtype == torch.from_numpy(want).dtype, name
        np.testing.assert_array_equal(got.numpy(), want, name)
    assert td.plan.primes == jd.plan.primes
    assert td.rplan.primes == jd.rplan.primes
    assert td.rplan.q_bits == jd.rplan.q_bits
    moved = keys.keys_from_numpy(jd)
    for name in keys.KEY_LEAVES:
        assert torch.equal(getattr(moved, name), getattr(td, name)), name
    assert moved.to("cpu").bsk_limbs.device.type == "cpu"


def test_client_keys_and_ciphertexts_equal_jax(toy_keys):
    jc, _, tc, _ = toy_keys
    np.testing.assert_array_equal(tc.sk.lwe_key, jc.sk.lwe_key)
    np.testing.assert_array_equal(tc.sk.glwe_key, jc.sk.glwe_key)
    x = 0x0123456789ABCDEF0FEDCBA987654321
    ct = tc.encrypt_u128(x)
    np.testing.assert_array_equal(ct, jc.encrypt_u128(x))
    assert tc.decrypt_state_u128(ct) == x


def test_circuit_bootstrap_bits(toy_keys):
    """[B, nbits, n+1] small bits -> the GGSW NTT stack [nbits, P, B, R2,
    k+1, N], word for word against JAX."""
    from tfhe_aes_tpu.ops import wopbs as jwopbs
    from tfhe_aes_tpu_torch.ops import wopbs
    jc, jd, tc, td = toy_keys
    cts = np.stack([tc.encrypt_byte(v) for v in (0xA5, 0x3C)])[:, :3]
    small = keyswitch.keyswitch(PARAM_TOY, td.ksk_limbs, torus.from_u64(cts))
    got = wopbs.circuit_bootstrap_bits(td, small)
    want = jwopbs.circuit_bootstrap_bits(jd, jnp.asarray(torus.to_u64(small)))
    p = PARAM_TOY
    assert tuple(got.shape) == (3, td.plan.n_primes, 2,
                                (p.glwe_dimension + 1) * p.cbs_level,
                                p.glwe_dimension + 1, p.polynomial_size)
    _same(got, want)


def test_keyswitch(toy_keys):
    jc, jd, tc, td = toy_keys
    p = PARAM_TOY
    rng = np.random.default_rng(10)
    digits = rng.integers(-8, 8, size=(5, td.ksk_limbs.shape[0])
                          ).astype(np.int8)
    _same(keyswitch.limb_matmul_u64(torch.from_numpy(digits), td.ksk_limbs,
                                    p.lwe_dimension + 1),
          jks.limb_matmul_u64(jnp.asarray(digits), jnp.asarray(jd.ksk_limbs),
                              p.lwe_dimension + 1))
    cts = tc.encrypt_byte(0xA5)
    got = keyswitch.keyswitch(p, td.ksk_limbs, torus.from_u64(cts))
    _same(got, jks.keyswitch(p, jnp.asarray(jd.ksk_limbs), jnp.asarray(cts)))
    from tfhe_aes_tpu.backend import numpy_backend as nb
    bits = nb.lwe_decrypt_bit(tc.sk.lwe_key, torus.to_u64(got))
    assert [int(b) for b in bits] == [(0xA5 >> j) & 1 for j in range(8)]

