"""Decryption on the states' device (Client.decrypt_bits_device,
verify_ctr_device) and the --device-verify flag of the torch port's CLI,
against the JAX package (CPU, PARAM_TOY)."""

import argparse

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu import cli as jcli
from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu_torch import cli
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import aes_plain
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

U64 = np.uint64
KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


@pytest.fixture(scope="module")
def clients():
    jc, tc = JaxClient(PARAM_TOY, seed=5), Client(PARAM_TOY, seed=5)
    np.testing.assert_array_equal(tc.sk.big_lwe_key, jc.sk.big_lwe_key)
    return jc, tc


def test_decrypt_bits_device_equals_jax(clients):
    """Random words (every phase, carries and the top bit alike) and real
    encryptions decrypt to the JAX package's bits, bit for bit."""
    jc, tc = clients
    big = PARAM_TOY.big_lwe_dimension
    rng = np.random.default_rng(2024)
    states = rng.integers(0, 1 << 64, size=(3, 16, 8, big + 1), dtype=U64)
    got = tc.decrypt_bits_device(torus.from_u64(states))
    want = np.asarray(jc.decrypt_bits_device(jnp.asarray(states)))
    assert got.dtype == want.dtype == U64 and got.shape == (3, 16, 8)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < got.size
    real = np.stack([tc.encrypt_u128(x) for x in (0, (1 << 128) - 1, KEY)])
    bits = tc.decrypt_bits_device(torus.from_u64(real))
    np.testing.assert_array_equal(bits, tc.decrypt_bits(real))
    np.testing.assert_array_equal(
        bits, np.asarray(jc.decrypt_bits_device(jnp.asarray(real))))


def test_verify_ctr_device_passes_and_flags_a_flipped_block(clients):
    _, tc = clients
    blocks = aes_plain.ctr_keystream(KEY, IV + 4, 3)
    states = torus.from_u64(np.stack([tc.encrypt_u128(b) for b in blocks]))
    assert tc.verify_ctr_device(states, KEY, IV, offset=4) == blocks
    assert tc.decrypt_states_device(states) == blocks
    assert tc.fetch_and_verify_ctr(states, KEY, IV, offset=4,
                                   chunk=2) == blocks
    states[1, 9, 3, -1] += 1 << 63                 # flip one bit of block 1
    with pytest.raises(AssertionError, match="CTR block 1"):
        tc.verify_ctr_device(states, KEY, IV, offset=4)
    with pytest.raises(AssertionError, match="CTR block 1"):
        tc.fetch_and_verify_ctr(states, KEY, IV, offset=4, chunk=2)


def _jax_fields(monkeypatch, main, argv) -> dict:
    """The fields a JAX entry point's parser gives argv, caught before it
    runs anything."""
    class Parsed(Exception):
        pass
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(self, args=None, namespace=None):
        seen.update(vars(parse(self, args, namespace)))
        raise Parsed
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed):
            main(argv)
    return seen


@pytest.mark.parametrize("which", ["cli"])
def test_device_verify_parses_as_in_jax(monkeypatch, which):
    argv = ["--params", "tpu", "--device-verify", "--number-of-outputs",
            "2", "--iv", hex(IV), "--key", hex(KEY), "--seed", "3"]
    port = vars(cli._parser().parse_args(argv))
    seen = _jax_fields(monkeypatch, jcli.main, argv)
    must = {"device_verify", "params", "number_of_outputs", "iv", "key",
            "seed", "no_verify", "host_verify", "decrypt"}
    shared = port.keys() & seen.keys()
    assert must <= shared
    assert {k: port[k] for k in shared} == {k: seen[k] for k in shared}
    assert port["device_verify"] is True


def test_cli_device_verify_on_the_cpu(capsys):
    rc = cli.main(["--params", "toy", "--device", "cpu", "--seed", "11",
                   "--no-cache", "--number-of-outputs", "1",
                   "--iv", hex(IV), "--key", hex(KEY), "--device-verify"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[server] warm-up (overlapped): {" in out
    assert "[client] verified 1 blocks bit-exact vs plaintext AES" in out
    assert f"[client] first block: " \
        f"{aes_plain.ctr_keystream(KEY, IV, 1)[0]:#034x}" in out
