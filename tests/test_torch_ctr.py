"""The torch port's CTR keystream through the Server facade, against the
JAX package word for word and against plaintext AES (CPU, PARAM_TOY)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import aes_plain
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


@pytest.fixture(scope="module")
def ctx():
    jc = JaxClient(PARAM_TOY, seed=11)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=11)
    return jc, jd, tc, tc.make_device_keys(fast=False, device="cpu")


def _encrypted_round_keys(client, key):
    """Client-encrypted expanded key (isolates CTR from key expansion)."""
    rks = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(key))
    return np.stack([np.stack([client.encrypt_byte(b) for b in rk])
                     for rk in rks])


def test_server_ctr_keystream_equals_jax_and_decrypts(ctx):
    jc, jd, tc, td = ctx
    rks = _encrypted_round_keys(jc, KEY)
    enc_iv = jc.encrypt_u128(IV)
    want = np.asarray(jaes.ctr_keystream(jd, jnp.asarray(rks),
                                         jnp.asarray(enc_iv), 1, offset=7))
    got = Server(td).ctr_keystream(torus.from_u64(rks),
                                   torus.from_u64(enc_iv), 1, offset=7)
    np.testing.assert_array_equal(torus.to_u64(got), want)
    assert tc.fetch_and_verify_ctr(got, KEY, IV, offset=7) == \
        aes_plain.ctr_keystream(KEY, IV + 7, 1)


def test_server_add_scalar_carry_chain(ctx):
    _, _, tc, td = ctx
    iv = 0x000000000000000000000000000001FF       # multi-byte carries
    state = torus.from_u64(tc.encrypt_u128(iv))[None].expand(2, -1, -1, -1)
    offs = [1, 0x101]
    i_bytes = np.stack([np.array(aes_plain.u128_to_bytes_be(o), np.uint64)
                        for o in offs])
    out = torus.to_u64(Server(td).add_scalar(state, i_bytes))
    for bi, o in enumerate(offs):
        assert tc.decrypt_state_u128(out[bi]) == iv + o
