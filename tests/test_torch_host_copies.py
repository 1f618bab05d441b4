"""The port's copies of the JAX package's host modules against their
originals (CPU).

The port imports nothing of tfhe_aes_tpu, so it keeps its own copies of
the jax-free host modules it needs.  Each case holds one copy against its
original: the same constants and tables, and the same words from the same
seeds.
"""

import dataclasses

import numpy as np
import pytest

from tfhe_aes_tpu import params as jparams
from tfhe_aes_tpu import runtime as jruntime
from tfhe_aes_tpu.backend import numpy_backend as jnb
from tfhe_aes_tpu.models import aes_plain as jaes_plain
from tfhe_aes_tpu.models import luts as jluts
from tfhe_aes_tpu.models import tables as jtables
from tfhe_aes_tpu.utils import crt as jcrt
from tfhe_aes_tpu.utils import csprng as jcsprng
from tfhe_aes_tpu.utils import noise_model as jnoise_model
from tfhe_aes_tpu.utils import torus as jtorus
from tfhe_aes_tpu_torch import params, runtime
from tfhe_aes_tpu_torch.backend import numpy_backend as nb
from tfhe_aes_tpu_torch.models import aes_plain, luts, tables
from tfhe_aes_tpu_torch.utils import crt, csprng, host_torus, noise_model

SET_NAMES = ("PARAM_OPT", "PARAM_TPU", "PARAM_TOY", "PARAM_TOY_WIDE",
             "PARAM_TOY_N512")
KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


def _equal(got, want):
    """Recursive equality of numpy arrays, sequences and scalars."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def check_params():
    for name in SET_NAMES:
        got, want = getattr(params, name), getattr(jparams, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        for prop in ("big_lwe_dimension", "glwe_size", "log2_poly_size",
                     "message_bits", "delta_log"):
            assert getattr(got, prop) == getattr(want, prop), (name, prop)


def check_tables():
    _equal(tables.sbox(), jtables.sbox())
    _equal(tables.inv_sbox(), jtables.inv_sbox())
    _equal(tables.RCON, jtables.RCON)
    for c in range(256):
        _equal(tables.gf_mul_table(c), jtables.gf_mul_table(c))


def check_aes_plain():
    kb = aes_plain.u128_to_bytes_be(KEY)
    assert kb == jaes_plain.u128_to_bytes_be(KEY)
    _equal(aes_plain.key_expansion(kb), jaes_plain.key_expansion(kb))
    rng = np.random.default_rng(3)
    for _ in range(4):
        blk = [int(v) for v in rng.integers(0, 256, 16)]
        ct = aes_plain.encrypt_block(kb, blk)
        assert ct == jaes_plain.encrypt_block(kb, blk)
        assert aes_plain.decrypt_block(kb, ct) == \
            jaes_plain.decrypt_block(kb, ct) == blk
        assert aes_plain.bytes_be_to_u128(blk) == \
            jaes_plain.bytes_be_to_u128(blk)
    assert aes_plain.ctr_keystream(KEY, IV, 5) == \
        jaes_plain.ctr_keystream(KEY, IV, 5)


def check_luts():
    p = params.PARAM_TOY
    sbox = tables.sbox()
    for nbits in (7, 8, 9):
        _equal(luts.lut_polys_from_tables(p, sbox[None], nbits),
               jluts.lut_polys_from_tables(jparams.PARAM_TOY, sbox[None],
                                           nbits))
    per = np.stack([sbox[None], tables.inv_sbox()[None]])
    _equal(luts.lut_polys_per_batch(p, per, 8),
           jluts.lut_polys_per_batch(jparams.PARAM_TOY, per, 8))


def check_crt():
    _equal(crt.MAX_TWO_N, jcrt.MAX_TWO_N)
    _equal(crt.ntt_primes(), jcrt.ntt_primes())
    for name in SET_NAMES:
        p = getattr(params, name)
        q = max(48, p.pbs_base_log * p.pbs_level)
        args = (q, p.polynomial_size, p.pbs_base_log, p.glwe_dimension,
                p.pbs_level)
        primes = crt.rotate_primes(*args)
        _equal(primes, jcrt.rotate_primes(*args))
        for q_bits in (q, 64):
            _equal(crt.crt_constants(primes, q_bits),
                   jcrt.crt_constants(primes, q_bits))
    for p in crt.ntt_primes()[:2]:
        for n in (128, 512):
            assert crt.root_of_unity(p, 2 * n) == jcrt.root_of_unity(p, 2 * n)
            _equal(crt.ntt_matrices(p, n), jcrt.ntt_matrices(p, n))
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 64, (3, 128), dtype=np.uint64)
    primes = crt.ntt_primes()
    res = np.stack([np.asarray(a % np.uint64(p), np.int64) for p in primes])
    _equal(crt.crt_reconstruct_u64_host(res, primes),
           jcrt.crt_reconstruct_u64_host(res, primes))


def check_csprng():
    for seed in (0, 7):
        got = csprng.default_rng(seed).integers(0, 1 << 64, 64,
                                                dtype=np.uint64)
        want = jcsprng.default_rng(seed).integers(0, 1 << 64, 64,
                                                  dtype=np.uint64)
        _equal(got, want)
    key = bytes(range(32))
    _equal(csprng.Csprng(key).integers(0, 1 << 64, 100, dtype=np.uint64),
           jcsprng.Csprng(key).integers(0, 1 << 64, 100, dtype=np.uint64))
    _equal(csprng.chacha20_keystream_u64(key, bytes(12), 1, 37),
           jcsprng.chacha20_keystream_u64(key, bytes(12), 1, 37))


def check_host_torus():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 64, (4, 33), dtype=np.uint64)
    for base_log, levels in ((8, 4), (12, 3), (2, 6)):
        _equal(host_torus.gadget_decompose(v, base_log, levels),
               jtorus.gadget_decompose(v, base_log, levels))
    _equal(host_torus.signed_limbs(v, 8), jtorus.signed_limbs(v, 8))
    _equal(host_torus.sample_gaussian_torus(np.random.default_rng(1),
                                            2.0 ** -25, (5, 7)),
           jtorus.sample_gaussian_torus(np.random.default_rng(1),
                                        2.0 ** -25, (5, 7)))


def check_numpy_backend():
    sk = nb.gen_secret_keys(params.PARAM_TOY, np.random.default_rng(11))
    jsk = jnb.gen_secret_keys(jparams.PARAM_TOY, np.random.default_rng(11))
    for leaf in ("lwe_key", "glwe_key", "big_lwe_key"):
        _equal(getattr(sk, leaf), getattr(jsk, leaf))
    p = params.PARAM_TOY
    m = np.arange(6, dtype=np.uint64) << np.uint64(60)
    _equal(nb.lwe_encrypt(sk.lwe_key, m, p.lwe_noise_std,
                          np.random.default_rng(2)),
           jnb.lwe_encrypt(jsk.lwe_key, m, p.lwe_noise_std,
                           np.random.default_rng(2)))
    poly = np.zeros((2, p.polynomial_size), np.uint64)
    poly[:, 3] = np.uint64(1) << np.uint64(62)
    _equal(nb.glwe_encrypt(sk.glwe_key, poly, p.glwe_noise_std,
                           np.random.default_rng(3)),
           jnb.glwe_encrypt(jsk.glwe_key, poly, p.glwe_noise_std,
                            np.random.default_rng(3)))
    _equal(nb.bsk_gen(sk, np.random.default_rng(4)),
           jnb.bsk_gen(jsk, np.random.default_rng(4)))
    _equal(nb.ksk_gen(sk, np.random.default_rng(5)),
           jnb.ksk_gen(jsk, np.random.default_rng(5)))


def check_noise_model():
    for name in SET_NAMES:
        got = noise_model.budget(getattr(params, name))
        want = jnoise_model.budget(getattr(jparams, name))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.certified == want.certified


def check_runtime():
    rng = np.random.default_rng(6)
    v = rng.integers(0, 1 << 64, (3, 50), dtype=np.uint64)
    _equal(runtime.signed_limbs(v, 8), jruntime.signed_limbs(v, 8))
    p = crt.ntt_primes()[0]
    _equal(runtime.balanced_residues(v, p), jruntime.balanced_residues(v, p))
    rows = rng.integers(-(p // 2), p // 2, (4, 128)).astype(np.int32)
    mat, _ = crt.ntt_matrices(p, 128)
    _equal(runtime.ntt_rows_mod(rows, mat, p),
           jruntime.ntt_rows_mod(rows, mat, p))


@pytest.mark.parametrize("module", [
    "params", "tables", "aes_plain", "luts", "crt", "csprng", "host_torus",
    "numpy_backend", "noise_model", "runtime"])
def test_copy_equals_original(module):
    globals()[f"check_{module}"]()
