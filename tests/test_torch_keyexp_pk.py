"""The torch port's public key, server-side RCON encryption and both key
schedules against the JAX package (CPU, PARAM_TOY, seed 11): word for
word, and the round keys decrypt to the AES key schedule."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import aes_plain
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.server import Server as JaxServer
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import fhe_aes
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
SCHEDULE = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))


@pytest.fixture(scope="module")
def ctx():
    jc = JaxClient(PARAM_TOY, seed=11)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=11)
    td = tc.make_device_keys(fast=False, device="cpu")
    return jc, jd, jc.make_public_key(), tc, td, tc.make_public_key()


def _assert_schedule(client, rks):
    for r in range(11):
        assert [client.decrypt_byte(rks[r, i]) for i in range(16)] == \
            SCHEDULE[r], f"round key {r}"


def test_public_key_and_rcon_encryption_equal_jax(ctx):
    jc, jd, jpk, tc, td, tpk = ctx
    np.testing.assert_array_equal(tpk.zeros, jpk.zeros)
    bits = np.random.default_rng(3).integers(0, 2, (5, 8)).astype(np.uint64)
    got = tpk.encrypt_bits(bits, np.random.default_rng(4))
    np.testing.assert_array_equal(
        got, jpk.encrypt_bits(bits, np.random.default_rng(4)))
    assert [int(b) for b in tc.decrypt_bits(got).reshape(-1)] == \
        [int(b) for b in bits.reshape(-1)]
    rcon = Server(td, tpk, rng=np.random.default_rng(7)).encrypt_rcon()
    np.testing.assert_array_equal(
        rcon, JaxServer(jd, jpk, rng=np.random.default_rng(7)).encrypt_rcon())
    assert [tc.decrypt_byte(rcon[i]) for i in range(10)] == \
        [int(r) for r in fhe_aes.tables.RCON]
    with pytest.raises(ValueError, match="public key"):
        Server(td).encrypt_rcon()


def test_pk_key_expansion_equals_jax_and_decrypts(ctx):
    """The 3-WoPBS schedule on RCON encrypted by the server."""
    jc, jd, jpk, tc, td, tpk = ctx
    enc_key = jc.encrypt_u128(KEY)
    rcon = JaxServer(jd, jpk, rng=np.random.default_rng(7)).encrypt_rcon()
    want = np.asarray(jaes.aes_key_expansion_jit(jd, jnp.asarray(enc_key),
                                                 jnp.asarray(rcon)))
    server = Server(td, tpk, rng=np.random.default_rng(7))
    got = torus.to_u64(server.aes_key_expansion(torus.from_u64(enc_key),
                                                pk_rcon=True))
    np.testing.assert_array_equal(got, want)
    _assert_schedule(tc, got)


def test_trivial_key_expansion_equals_staged(ctx):
    """rcon_cts=None: the one-WoPBS-per-round loop gives the words of the
    JAX package's aes_key_expansion_staged."""
    jc, jd, jpk, tc, td, tpk = ctx
    enc_key = jc.encrypt_u128(KEY)
    want = np.asarray(jaes.aes_key_expansion_staged(jd, jnp.asarray(enc_key)))
    got = torus.to_u64(fhe_aes.aes_key_expansion(td,
                                                 torus.from_u64(enc_key)))
    np.testing.assert_array_equal(got, want)
    _assert_schedule(tc, got)
