"""The torch port's WoPBS and key expansion against the JAX package (CPU),
and the port's independence from jax.

Same seed, same keys, same ciphertexts on both sides; every comparison is
word for word, and the results decrypt to the plaintext oracle.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import aes_plain, tables
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.ops import wopbs as jwopbs
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import fhe_aes
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ctx():
    jc = JaxClient(PARAM_TOY, seed=11)
    jd = jc.make_device_keys(fast=False)
    tc = Client(PARAM_TOY, seed=11)
    return jc, jd, tc, tc.make_device_keys(fast=False, device="cpu")


def test_lut_builders_equal_jax():
    for name in ("_fwd_luts", "_refresh_sbox_lut"):
        np.testing.assert_array_equal(getattr(fhe_aes, name)(PARAM_TOY),
                                      getattr(jaes, name)(PARAM_TOY))
    np.testing.assert_array_equal(fhe_aes._sbox_lut(PARAM_TOY, inv=False),
                                  jaes._sbox_lut(PARAM_TOY, inv=False))
    np.testing.assert_array_equal(fhe_aes.trivial_rcon(PARAM_TOY),
                                  jaes.trivial_rcon(PARAM_TOY))
    np.testing.assert_array_equal(fhe_aes.counter_bytes(3, 0x1FF),
                                  jaes.counter_bytes(3, 0x1FF))
    i_bytes = fhe_aes.counter_bytes(2, 0xFE)
    for got, want in zip(fhe_aes.add_scalar_luts(PARAM_TOY, i_bytes),
                         jaes.add_scalar_luts(PARAM_TOY, i_bytes)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lut_kind", ["shared", "per_byte"])
def test_many_wopbs_equals_jax(ctx, lut_kind):
    """A shared LUT stack (AES round: S-box, 2*S-box, 3*S-box) and per-byte
    LUTs (the counter add), whole-batch and in ragged byte chunks."""
    jc, jd, tc, td = ctx
    vals = (0x00, 0x5A, 0xFF, 0x80)
    cts = np.stack([jc.encrypt_byte(b) for b in vals])
    if lut_kind == "shared":
        lut = fhe_aes._fwd_luts(PARAM_TOY)
        sbox = tables.sbox()
        tabs = [sbox, tables.gf_mul_table(2)[sbox],
                tables.gf_mul_table(3)[sbox]]
    else:
        i_bytes = fhe_aes.counter_bytes(4, 0xFD)
        lut, _ = fhe_aes.add_scalar_luts(PARAM_TOY, i_bytes)
    want = np.asarray(jwopbs.many_wopbs(jd, jnp.asarray(cts),
                                        jnp.asarray(lut)))
    got = torus.to_u64(wopbs.many_wopbs(td, torus.from_u64(cts),
                                        torus.from_u64(lut)))
    np.testing.assert_array_equal(got, want)
    chunked = torus.to_u64(wopbs.many_wopbs(td, torus.from_u64(cts),
                                            torus.from_u64(lut), vp_chunk=3))
    np.testing.assert_array_equal(chunked, want)
    for bi, v in enumerate(vals):
        bits = [int(b) for b in tc.decrypt_bits(got[bi])]
        if lut_kind == "shared":
            assert bits == [(int(tabs[o // 8][v]) >> (o % 8)) & 1
                            for o in range(24)]
        else:
            s = v + int(i_bytes[bi, 15])
            assert bits == [((s % 256) >> o) & 1 for o in range(8)] \
                + [int(s > 255)]


def test_server_key_expansion_equals_jax_staged(ctx):
    jc, jd, tc, td = ctx
    enc_key = jc.encrypt_u128(KEY)
    want = np.asarray(jaes.aes_key_expansion_staged(jd, jnp.asarray(enc_key)))
    got = torus.to_u64(Server(td).aes_key_expansion(torus.from_u64(enc_key)))
    np.testing.assert_array_equal(got, want)
    sched = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    for r in range(11):
        assert [tc.decrypt_byte(got[r, i]) for i in range(16)] == sched[r]


_NO_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises,
sys.modules["tfhe_aes_tpu"] = None   # and of the JAX package
import numpy as np
import torch
torch.set_num_threads(1)
import tfhe_aes_tpu_torch
for m in pkgutil.walk_packages(tfhe_aes_tpu_torch.__path__,
                               "tfhe_aes_tpu_torch."):
    importlib.import_module(m.name)
from tfhe_aes_tpu_torch.models import luts, tables
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.utils import torus
c = Client(PARAM_TOY, seed=3)
k = c.make_device_keys(fast=False, device="cpu")
vals = [7, 200]
cts = torus.from_u64(np.stack([c.encrypt_byte(v) for v in vals]))
lut = torus.from_u64(luts.lut_polys_from_tables(PARAM_TOY,
                                                tables.sbox()[None], 8))
out = torus.to_u64(wopbs.many_wopbs(k, cts, lut))
assert [c.decrypt_byte(out[i]) for i in range(2)] == \\
    [int(tables.sbox()[v]) for v in vals]
from tfhe_aes_tpu_torch.utils import noise
assert noise.audit_all(PARAM_TOY)["key_expansion_pk"]["wopbs_in"] == 5
fast = Client(PARAM_TOY, seed=3).make_device_keys(fast=True, device="cpu")
assert fast.bsk_limbs.shape == k.bsk_limbs.shape
for name in ("cli", "utils.serialization", "client.keygen_fast",
             "utils.noise_asserts", "utils.noise"):
    assert "tfhe_aes_tpu_torch." + name in sys.modules, name
assert not [m for m, v in sys.modules.items()
            if v is not None and m.split(".")[0] in ("jax", "tfhe_aes_tpu")]
print("no-jax ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout
