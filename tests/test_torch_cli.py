"""The torch port's live noise sanitizer against the JAX package's, and its
command-line entry point (CPU, PARAM_TOY)."""

import argparse
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu import cli as jcli
from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import aes_plain, luts, tables
from tfhe_aes_tpu.ops import wopbs as jwopbs
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.utils import noise_asserts as jnoise_asserts
from tfhe_aes_tpu_torch import cli
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.utils import noise_asserts, torus

torch.set_num_threads(1)

U64 = np.uint64
REPO = pathlib.Path(__file__).resolve().parent.parent
KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


@pytest.fixture(scope="module")
def ctx():
    jc = JaxClient(PARAM_TOY, seed=21)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=21)
    return jc, jd, tc, tc.make_device_keys(fast=False, device="cpu")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    noise_asserts.disable()
    jnoise_asserts.disable()


def _sbox_both(ctx, byte_cts):
    """The same S-box WoPBS through both packages' many_wopbs."""
    jc, jd, tc, td = ctx
    lut = luts.lut_polys_from_tables(PARAM_TOY, tables.sbox()[None], 8)
    jax.block_until_ready(jwopbs.many_wopbs(jd, jnp.asarray(byte_cts),
                                            jnp.asarray(lut)))
    return torus.to_u64(wopbs.many_wopbs(td, torus.from_u64(byte_cts),
                                         torus.from_u64(lut)))


def test_noise_asserts_record_like_jax(ctx):
    jc, jd, tc, td = ctx
    jnoise_asserts.enable(jc.sk)
    noise_asserts.enable(tc.sk)
    out = _sbox_both(ctx, np.stack([jc.encrypt_byte(0x3A)]))
    assert tc.decrypt_byte(out[0]) == int(tables.sbox()[0x3A])
    got, want = noise_asserts.checks(), jnoise_asserts.checks()
    assert [c["tag"] for c in got] == ["wopbs_input", "wopbs_output"]
    for key in ("tag", "shape", "log2_sigma", "log2_max_err", "log2_rms"):
        assert [c[key] for c in got] == [c[key] for c in want], key
    noise_asserts.assert_clean()


def test_noise_asserts_flag_a_corrupted_input(ctx):
    """An error above the leveled budget but below the 2^62 decode
    threshold (a wrong schedule's signature) is flagged at the input."""
    jc, jd, tc, td = ctx
    noise_asserts.enable(tc.sk)
    byte_cts = np.stack([jc.encrypt_byte(0x3A)])
    byte_cts[..., -1] += U64(1) << U64(61)
    wopbs.many_wopbs(td, torus.from_u64(byte_cts), torus.from_u64(
        luts.lut_polys_from_tables(PARAM_TOY, tables.sbox()[None], 8)))
    assert [f["tag"] for f in noise_asserts.failures()] == ["wopbs_input"]
    with pytest.raises(AssertionError, match="wopbs_input"):
        noise_asserts.assert_clean()


def test_noise_asserts_disarmed_record_nothing(ctx, monkeypatch):
    jc, jd, tc, td = ctx
    calls = []
    monkeypatch.setattr(noise_asserts, "check_big_lwe",
                        lambda *a: calls.append(a))
    wopbs.many_wopbs(td, torus.from_u64(np.stack([jc.encrypt_byte(0x11)])),
                     torus.from_u64(luts.lut_polys_from_tables(
                         PARAM_TOY, tables.sbox()[None], 8)))
    assert calls == []                 # no host copy, no device sync
    assert noise_asserts.checks() == [] and noise_asserts.failures() == []
    noise_asserts.assert_clean()


def test_cli_toy_on_cpu(capsys):
    """Keygen, pk-RCON key expansion, one CTR block, the decrypt
    round-trip and the sanitizer, through the entry point."""
    rc = cli.main(["--params", "toy", "--device", "cpu", "--seed", "11",
                   "--no-cache", "--number-of-outputs", "1",
                   "--iv", hex(IV), "--key", hex(KEY),
                   "--pk-rcon", "--decrypt", "--noise-asserts"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[client] verified 1 blocks bit-exact vs plaintext AES" in out
    assert f"[client] first block: " \
        f"{aes_plain.ctr_keystream(KEY, IV, 1)[0]:#034x}" in out
    assert "homomorphic decryption round-trip verified" in out
    assert "noise asserts:" in out and "all within modelled sigma" in out
    assert not noise_asserts.enabled()


@pytest.mark.parametrize("argv", [["--device", "cuda"], []],
                         ids=["device_cuda", "default_device"])
def test_cli_cuda_without_a_card_fails(capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(argv + ["--params", "toy", "--number-of-outputs", "1",
                          "--iv", "0", "--key", "0"])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_module_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "tfhe_aes_tpu_torch.cli", "--params", "toy",
         "--test"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "Passed" not in proc.stdout


def test_cli_needs_its_inputs():
    with pytest.raises(SystemExit):
        cli.main(["--params", "toy", "--device", "cpu"])


def test_cli_accepts_the_reference_host_verify_flag(monkeypatch):
    """A JAX command line with --host-verify parses in the port to the
    reference's fields, and the port's main returns 0 on it."""
    argv = ["--params", "tpu", "--host-verify", "--number-of-outputs", "2",
            "--iv", hex(IV), "--key", hex(KEY), "--seed", "3"]
    port = vars(cli._parser().parse_args(argv))

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
            jcli.main(argv)
    shared = port.keys() & seen.keys()
    assert {"host_verify", "params", "number_of_outputs", "iv", "key",
            "seed", "no_verify", "decrypt", "pk_rcon"} <= shared
    assert {k: port[k] for k in shared} == {k: seen[k] for k in shared}
    assert port["host_verify"] is True

    ran = []
    monkeypatch.setattr(cli.warmup, "precompile",
                        lambda *a, **k: SimpleNamespace(join=dict))
    monkeypatch.setattr(cli, "client_and_keys", lambda *a: (None, None))
    monkeypatch.setattr(cli, "_run", lambda args, *a: ran.append(args))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert ran and ran[0].host_verify


def test_harness_nist_vectors_equal_aes_plain():
    assert cli.NIST_KEY == KEY
    for plain, cipher in zip(cli.NIST_PLAINS, cli.NIST_CIPHERS):
        assert cli.aes_block(cli.NIST_KEY, plain) == cipher
        assert aes_plain.bytes_be_to_u128(aes_plain.encrypt_block(
            aes_plain.u128_to_bytes_be(KEY),
            aes_plain.u128_to_bytes_be(plain))) == cipher
