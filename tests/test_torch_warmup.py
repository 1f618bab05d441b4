"""The torch port's cold-start warm-up (tfhe_aes_tpu_torch/utils/warmup.py)
and what it rests on, on the CPU at PARAM_TOY: the counterpart of
tests/test_warmup.py.

The warm-up only helps if the real keys find what it made: zero keys of
the real leaves' shapes, constant leaves that are one object per device
(their kernel tiles are keyed on the leaf), one plan object per
parameters, and one build of each library and tile under threads.
"""

import os
import stat
import sys
import threading

import numpy as np
import pytest
import torch

from tfhe_aes_tpu.client import keygen_fast as jkeygen_fast
from tfhe_aes_tpu.ops import keys as jkeys
from tfhe_aes_tpu_torch.client import keygen_fast
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import cuda_build, keys as keys_mod, ntt
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.utils import crt, serialization, warmup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_keys():
    return Client(PARAM_TOY, seed=11).make_device_keys(fast=False,
                                                      device="cpu")


def test_zero_keys_have_the_shapes_of_real_keys(host_keys):
    zero = keygen_fast.zero_device_keys(PARAM_TOY, device="cpu")
    shapes = keys_mod.device_keys_shapes(PARAM_TOY, device="cpu")
    jax_shapes = jkeys.device_keys_shapes(PARAM_TOY)
    for name in keys_mod.KEY_LEAVES:
        z, s, h = (getattr(k, name) for k in (zero, shapes, host_keys))
        assert z.shape == s.shape == h.shape, name
        assert z.dtype == s.dtype == h.dtype, name
        assert tuple(z.shape) == tuple(np.shape(getattr(jax_shapes, name)))
        assert z.device.type == "cpu", name
    for name in keys_mod.MATERIAL_LEAVES:
        assert getattr(shapes, name).device.type == "meta", name
        assert not getattr(zero, name).any(), name
    assert zero.plan is host_keys.plan and zero.rplan is host_keys.rplan


def test_zero_keys_are_packed_zero_keys():
    """All-zero host keys pack to all-zero limbs: the zero keys are what
    packing zero keys gives, as the JAX zero_device_keys makes them."""
    p = PARAM_TOY
    k, n = p.glwe_dimension, p.polynomial_size
    u64 = np.uint64
    packed = keygen_fast.pack_device_keys(
        p, np.zeros((k, n), u64),
        np.zeros((p.lwe_dimension, p.pbs_level, k + 1, k + 1, n), u64),
        np.zeros((p.big_lwe_dimension, p.ks_level, p.lwe_dimension + 1),
                 u64),
        np.zeros((k + 1, p.big_lwe_dimension + 1, p.pfks_level, k + 1, n),
                 u64),
        ntt.make_plan(n), device="cpu")
    zero = keygen_fast.zero_device_keys(p, device="cpu")
    want = jkeygen_fast.zero_device_keys(p)
    for name in keys_mod.KEY_LEAVES:
        assert torch.equal(getattr(zero, name), getattr(packed, name)), name
        np.testing.assert_array_equal(getattr(zero, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_constant_leaves_are_one_object_per_device(host_keys, tmp_path,
                                                   monkeypatch):
    """Zero keys, host keygen, device keygen, a key-cache load and .to()
    share each constant leaf: the kernels' tiles of it are made once."""
    monkeypatch.setenv("TFHE_AES_TPU_CACHE", str(tmp_path))
    client = Client(PARAM_TOY, seed=11)
    fast = client.make_device_keys(fast=True, device="cpu")
    path = serialization.cache_path(PARAM_TOY, 11)
    serialization.save_keys(path, client.sk, fast)
    _, loaded = serialization.load_keys(path)
    sets = [keygen_fast.zero_device_keys(PARAM_TOY, device="cpu"),
            keys_mod.device_keys_shapes(PARAM_TOY, device="cpu"),
            host_keys, host_keys.to("cpu"), host_keys.to(torch.device("cpu")),
            fast, loaded, loaded.to("cpu")]
    for name in keys_mod.CONSTANT_LEAVES:
        leaf = getattr(sets[0], name)
        assert all(getattr(k, name) is leaf for k in sets), name
    for name in keys_mod.MATERIAL_LEAVES:
        assert torch.equal(getattr(loaded, name), getattr(fast, name)), name


def test_make_plan_is_one_object_under_racing_threads():
    """Four threads' first calls for one plan get one object (the plan
    keys the shared leaves and their tiles)."""
    args = (64, tuple(crt.ntt_primes()), 47)    # a plan no other test makes
    out, errors = [], []
    barrier = threading.Barrier(4)

    def grab():
        try:
            barrier.wait(timeout=30)
            out.append(ntt.make_plan(*args))
        except Exception as e:              # pragma: no cover
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=grab) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert ntt.make_plan(64, list(crt.ntt_primes()), 47) is out[0]


def test_precompile_on_the_cpu_runs_every_target():
    report = {}
    warm = warmup.precompile(PARAM_TOY, 2, device="cpu", report=report)
    got = warm.join()
    assert got is report
    assert set(got) == {"tiles", "zero_key_wopbs", "waited", "joined_at"}
    assert all(v >= 0 for v in got.values())


def test_precompile_takes_the_jax_block_chunk_keyword(monkeypatch):
    """precompile(params, n_blocks, block_chunk=32), the JAX signature:
    accepted and, like n_blocks, ignored (nothing warmed depends on the
    batch)."""
    import inspect
    from tfhe_aes_tpu.utils import warmup as jwarmup
    assert "block_chunk" in inspect.signature(jwarmup.precompile).parameters
    targets = []
    monkeypatch.setattr(warmup, "_tiles",
                        lambda params, device: targets.append("tiles"))
    monkeypatch.setattr(warmup, "_zero_key_wopbs",
                        lambda params, device: targets.append("wopbs"))
    for kw in ({"block_chunk": 32}, {"block_chunk": None}, {}):
        report = warmup.precompile(PARAM_TOY, 64, device="cpu", **kw).join()
        assert {"tiles", "zero_key_wopbs"} <= set(report)
    assert targets == ["tiles", "wopbs"] * 3


def test_a_failing_target_fails_join(monkeypatch):
    def broken(params, device):
        raise RuntimeError("tiles failed")
    monkeypatch.setattr(warmup, "_tiles", broken)
    report = {}
    warm = warmup.precompile(PARAM_TOY, 1, device="cpu", report=report)
    with pytest.raises(RuntimeError, match="tiles failed"):
        warm.join()
    assert "zero_key_wopbs" not in report       # it needs the tiles


def _fake_nvcc(tmp_path):
    """An executable that takes nvcc's command line, counts its runs and
    writes its -o file after a pause."""
    runs = tmp_path / "runs"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.3)\n"
        f"open({str(runs)!r}, 'a').write('x')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script, runs


def test_load_builds_a_library_once_under_threads(tmp_path, monkeypatch):
    script, runs = _fake_nvcc(tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_build_locks", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: ("loaded", os.path.basename(path)))
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        cuda_build.load("blind_rotate"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert runs.read_text() == "x"                 # one nvcc
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert out[0][1] == cuda_build.library_path("blind_rotate").name
    assert [p.name for p in (tmp_path / "build").iterdir()] == [out[0][1]]


def test_derived_builds_once_under_threads():
    leaf = torch.arange(8)
    calls = []
    barrier = threading.Barrier(4)

    def build(m):
        calls.append(1)
        threading.Event().wait(0.2)
        return m * 2

    out = []

    def grab():
        barrier.wait(timeout=30)
        out.append(cuda_build.derived(leaf, "test x2", build))
    threads = [threading.Thread(target=grab) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(out) == 4
    assert all(o is out[0] for o in out)
    assert torch.equal(out[0], leaf * 2)
    # A copy of a leaf is another leaf: its tiles are built again.
    assert cuda_build.derived(leaf.clone(), "test x2", build) is not out[0]
    assert len(calls) == 2
