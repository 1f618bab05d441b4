"""The torch port's homomorphic AES decryption and circuit noise audit
against the JAX package (CPU, PARAM_TOY, seed 11): word for word, and the
result decrypts to the plaintext oracle."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu import params as param_sets
from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import aes_plain
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.params import PARAM_OPT, PARAM_TOY
from tfhe_aes_tpu.utils import noise as jnoise
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import fhe_aes
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import noise, torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF
ALL_PARAMS = [getattr(param_sets, n) for n in (
    "PARAM_OPT", "PARAM_TPU", "PARAM_TOY", "PARAM_TOY_WIDE", "PARAM_TOY_N512")]


@pytest.fixture(scope="module")
def ctx():
    jc = JaxClient(PARAM_TOY, seed=11)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=11)
    return jc, jd, tc, tc.make_device_keys(fast=False, device="cpu")


def test_decrypt_luts_equal_jax():
    for inv in (False, True):
        np.testing.assert_array_equal(fhe_aes._sbox_lut(PARAM_TOY, inv),
                                      jaes._sbox_lut(PARAM_TOY, inv=inv))
    for name in ("_inv_mul_luts", "_identity_lut"):
        np.testing.assert_array_equal(getattr(fhe_aes, name)(PARAM_TOY),
                                      getattr(jaes, name)(PARAM_TOY))
    np.testing.assert_array_equal(fhe_aes._IMC_VAR, jaes._IMC_VAR)
    assert fhe_aes.INV_SHIFT == jaes.INV_SHIFT
    state = np.arange(2 * 16 * 3).reshape(2, 16, 3)
    np.testing.assert_array_equal(
        fhe_aes.inv_shift_rows(torch.from_numpy(state)).numpy(),
        np.asarray(jaes.inv_shift_rows(jnp.asarray(state))))


def test_aes_decrypt_equals_jax_and_decrypts(ctx):
    """One block under client-encrypted round keys (isolates decryption
    from key expansion)."""
    jc, jd, tc, td = ctx
    rks = np.stack([np.stack([jc.encrypt_byte(b) for b in rk]) for rk in
                    aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))])
    ct = aes_plain.bytes_be_to_u128(aes_plain.encrypt_block(
        aes_plain.u128_to_bytes_be(KEY), aes_plain.u128_to_bytes_be(IV)))
    state = jc.encrypt_u128(ct)[None]
    want = np.asarray(jaes.aes_decrypt_jit(jd, jnp.asarray(rks),
                                           jnp.asarray(state)))
    got = torus.to_u64(Server(td).aes_decrypt(torus.from_u64(rks),
                                              torus.from_u64(state)))
    np.testing.assert_array_equal(got, want)
    assert tc.decrypt_state_u128(got[0]) == IV


@pytest.mark.parametrize("params", ALL_PARAMS, ids=lambda p: p.name)
def test_noise_audit_equals_jax(params):
    got = noise.audit_all(params)
    assert got == jnoise.audit_all(params)
    assert got["decrypt"]["wopbs_in"] <= params.max_noise_level
    assert got["key_expansion_pk"]["wopbs_in"] == 5


def test_noise_audit_catches_violation():
    """With a budget of 4 the real circuits fail the audit: the levels
    come from the circuits, not from the audit."""
    tight = dataclasses.replace(PARAM_OPT, max_noise_level=4)
    with pytest.raises(AssertionError, match="exceeds budget"):
        noise.audit_all(tight)
