"""Balanced chunks of the torch port (CPU): the WoPBS tail's byte chunks
and ctr_keystream's block_chunk path, against the JAX package's
_chunk_size and ctr_keystream (tests/test_chunking.py's cases)."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.ops.wopbs import _chunk_size as jax_chunk_size
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes, luts, tables
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.parallel.multihost_ctr import tiny_params
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


@pytest.mark.parametrize("b,target,want_chunk,want_n", [
    (37, 32, 19, 2),
    (257, 256, 129, 2),
    (64, 32, 32, 2),
    (96, 32, 32, 3),
    (16, 32, 16, 1),
    (33, 32, 17, 2),
])
def test_chunk_size_balanced_as_jax(b, target, want_chunk, want_n):
    bc = wopbs._chunk_size(b, target)
    assert bc == jax_chunk_size(b, target) == want_chunk
    assert -(-b // bc) == want_n
    assert bc <= target


def test_many_wopbs_balanced_tail_chunks_keep_the_words(monkeypatch):
    """5 bytes under a cap of 4 run as 3 + 2 (not 4 + 1), word for word
    the one-chunk call, and decrypt to the S-box."""
    client = Client(PARAM_TOY, seed=11)
    keys = client.make_device_keys(fast=False, device="cpu")
    values = [0x00, 0x53, 0xA7, 0xFF, 0x1C]
    cts = torus.from_u64(np.stack([client.encrypt_byte(v) for v in values]))
    lut = torus.from_u64(luts.lut_polys_from_tables(
        PARAM_TOY, tables.sbox()[None], 8))
    chunks = []
    stage = wopbs._stage_and_pack

    def spy(keys, bigs, nbytes, nbits, lut_polys):
        chunks.append(nbytes)
        return stage(keys, bigs, nbytes, nbits, lut_polys)
    monkeypatch.setattr(wopbs, "_stage_and_pack", spy)
    got = wopbs.many_wopbs(keys, cts, lut, vp_chunk=4)
    assert chunks == [3, 2]
    want = wopbs.many_wopbs(keys, cts, lut)
    assert chunks == [3, 2, 5]
    assert torch.equal(got, want)
    out = torus.to_u64(got)
    assert [client.decrypt_byte(out[i]) for i in range(5)] == \
        [int(tables.sbox()[v]) for v in values]


def test_ctr_keystream_block_chunk_equals_one_batch_and_jax():
    """block_chunk=1 on 2 blocks (the ripple add at the full batch, AES a
    block at a time) gives the one-batch words and the JAX package's
    ctr_keystream(block_chunk=1) words, which decrypt to AES-CTR."""
    tiny = tiny_params()
    jc = JaxClient(tiny, seed=0)
    jd = jc.make_device_keys(fast=False)
    tc = Client(tiny, seed=0)
    td = tc.make_device_keys(fast=False, device="cpu")
    rks = np.stack([np.stack([jc.encrypt_byte(b) for b in rk]) for rk in
                    aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))])
    enc_iv = jc.encrypt_u128(IV)
    want = np.asarray(jaes.ctr_keystream(jd, jnp.asarray(rks),
                                         jnp.asarray(enc_iv), 2, offset=3,
                                         block_chunk=1))
    args = (td, torus.from_u64(rks), torus.from_u64(enc_iv), 2, 3)
    chunked = torus.to_u64(fhe_aes.ctr_keystream(*args, block_chunk=1))
    whole = torus.to_u64(fhe_aes.ctr_keystream(*args))
    np.testing.assert_array_equal(chunked, want)
    np.testing.assert_array_equal(whole, want)
    assert tc.decrypt_and_verify_ctr(chunked, KEY, IV, offset=3) == \
        aes_plain.ctr_keystream(KEY, IV + 3, 2)


def test_ctr_keystream_dispatch_count(monkeypatch):
    """37 blocks under block_chunk=32 run AES as two balanced chunks of 19
    (the ragged one wrap-padded) and reassemble the batch; the AES and
    the ripple add units they dispatch to are stubbed (identity over the
    state)."""
    calls = []

    def fake_aes(keys, round_keys, state):
        calls.append(state.shape[0])
        return state

    monkeypatch.setattr(fhe_aes, "aes_encrypt_jit", fake_aes)
    monkeypatch.setattr(fhe_aes, "add_scalar_device_jit",
                        lambda keys, state, lut_lsb, luts_rest: state)
    keys = SimpleNamespace(params=PARAM_TOY)
    enc_iv = torch.arange(16 * 8 * 4, dtype=torch.int64).reshape(16, 8, 4)
    out = fhe_aes.ctr_keystream(keys, None, enc_iv, 37, block_chunk=32)
    assert calls == [19, 19]
    assert torch.equal(out, enc_iv[None].expand(37, -1, -1, -1))
