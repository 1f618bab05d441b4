"""The torch port's device keygen and key cache against the JAX package
(CPU, PARAM_TOY, seed 11): the same keys word for word, and one cache
format that either package reads from the other."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import tables
from tfhe_aes_tpu.ops import ntt as jntt
from tfhe_aes_tpu.params import PARAM_TOY, PARAM_TPU
from tfhe_aes_tpu.utils import crt
from tfhe_aes_tpu.utils import serialization as jser
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import fhe_aes
from tfhe_aes_tpu_torch.ops import ntt, wopbs
from tfhe_aes_tpu_torch.ops.keys import KEY_LEAVES
from tfhe_aes_tpu_torch.utils import serialization, torus

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fast_keys():
    """(JAX fast keys, torch fast keys, torch client) from one seed."""
    jd = JaxClient(PARAM_TOY, seed=11).make_device_keys(fast=True)
    tc = Client(PARAM_TOY, seed=11)
    return jd, tc.make_device_keys(fast=True, device="cpu"), tc


@pytest.fixture(scope="module")
def host_keys():
    tc = Client(PARAM_TOY, seed=7)
    return tc.sk, tc.make_device_keys(fast=False, device="cpu")


@pytest.fixture(scope="module")
def default_keys():
    """(JAX keys, torch keys), each package's make_device_keys() with its
    defaults (the torch one on the CPU), from one seed."""
    return (JaxClient(PARAM_TOY, seed=11).make_device_keys(),
            Client(PARAM_TOY, seed=11).make_device_keys(device="cpu"))


@pytest.mark.parametrize("name", KEY_LEAVES)
def test_default_keygen_equals_jax_default(default_keys, name):
    jd, td = default_keys
    np.testing.assert_array_equal(getattr(td, name).numpy(),
                                  np.asarray(getattr(jd, name)))


def _leaves_equal(got, want):
    for name in KEY_LEAVES:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert tuple(got.plan.primes) == tuple(want.plan.primes)
    assert tuple(got.rplan.primes) == tuple(want.rplan.primes)
    assert got.rplan.q_bits == want.rplan.q_bits


@pytest.mark.parametrize("n", [128, 512])
def test_mac_shared_equals_jax(n):
    primes = crt.ntt_primes()
    rng = np.random.default_rng(n)
    half = (np.array(primes) - 1) // 2
    dhat = np.stack([rng.integers(-h, h + 1, (5, 4, n)) for h in half])
    ghat = np.stack([rng.integers(-h, h + 1, (4, 2, n)) for h in half])
    want = jntt.mac_shared(jntt.make_plan(n, primes),
                           jnp.asarray(dhat, jnp.int32),
                           jnp.asarray(ghat, jnp.int32))
    got = ntt.mac_shared(ntt.make_plan(n, primes),
                         torch.from_numpy(dhat.astype(np.int32)),
                         torch.from_numpy(ghat.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", KEY_LEAVES)
def test_fast_keygen_equals_jax(fast_keys, name):
    jd, td, _ = fast_keys
    leaf = getattr(td, name)
    assert leaf.device.type == "cpu"
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(jd, name)))


def test_fast_keys_evaluate_the_sbox(fast_keys):
    _, td, tc = fast_keys
    vals = (0x00, 0x53, 0xFF)
    cts = torus.from_u64(np.stack([tc.encrypt_byte(v) for v in vals]))
    lut = torus.from_u64(fhe_aes._sbox_lut(PARAM_TOY, False))
    out = torus.to_u64(wopbs.many_wopbs(td, cts, lut))
    assert [tc.decrypt_byte(out[i]) for i in range(3)] == \
        [int(tables.sbox()[v]) for v in vals]


@pytest.mark.parametrize("interchange", [False, True],
                         ids=["device_layout", "interchange"])
def test_torch_save_jax_load(tmp_path, host_keys, interchange):
    sk, td = host_keys
    path = tmp_path / "keys.npz"
    serialization.save_keys(path, sk, td, interchange=interchange)
    jsk, jd = jser.load_keys(path)
    np.testing.assert_array_equal(jsk.lwe_key, sk.lwe_key)
    np.testing.assert_array_equal(jsk.glwe_key, sk.glwe_key)
    _leaves_equal(jd, td)


@pytest.mark.parametrize("interchange", [False, True],
                         ids=["device_layout", "interchange"])
def test_jax_save_torch_load(tmp_path, interchange):
    jc = JaxClient(PARAM_TOY, seed=7)
    jd = jc.make_device_keys(fast=False)
    path = tmp_path / "keys.npz"
    jser.save_keys(path, jc.sk, jd, interchange=interchange)
    sk, td = serialization.load_keys(path)
    np.testing.assert_array_equal(sk.lwe_key, jc.sk.lwe_key)
    np.testing.assert_array_equal(sk.glwe_key, jc.sk.glwe_key)
    assert all(getattr(td, n).device.type == "cpu" for n in KEY_LEAVES)
    _leaves_equal(td, jd)


def test_cache_path_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TFHE_AES_TPU_CACHE", str(tmp_path))
    for params, seed in ((PARAM_TOY, 11), (PARAM_TPU, 0), (PARAM_TOY, None)):
        got = serialization.cache_path(params, seed)
        assert got == jser.cache_path(params, seed)
        assert got.parent == tmp_path
    assert serialization.KEY_FORMAT == jser.KEY_FORMAT
    monkeypatch.delenv("TFHE_AES_TPU_CACHE")
    assert serialization.default_cache_dir() == jser.default_cache_dir()
