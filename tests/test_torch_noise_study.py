"""The port's measured noise study (tfhe_aes_tpu_torch/noise_study.py)
against the reference study's arithmetic through the JAX package (CPU).

Keys are made once by the port's host keygen, saved with the port's key
cache and loaded into the JAX package with its own load_keys (one
KEY_FORMAT), so both packages run on the same keys; the draws are the
reference's (default_rng(123), in its order).  The arithmetic is exact,
so the error samples must be equal, not close.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.backend import numpy_backend as jnb
from tfhe_aes_tpu.models import luts as jluts
from tfhe_aes_tpu.ops import cbs as jcbs
from tfhe_aes_tpu.ops import wopbs as jwopbs
from tfhe_aes_tpu.params import PARAM_TOY as JAX_PARAM_TOY
from tfhe_aes_tpu.utils import serialization as jserialization
from tfhe_aes_tpu_torch import noise_study
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.utils import serialization

torch.set_num_threads(1)

U64 = np.uint64
SEED = 31
REPO = noise_study.REPO
# The cbs_level=1 toy set of tests/test_torch_kernels.py: its WoPBS runs the
# vertical-packing rotations (the plain version of the VP kernel).
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)
JAX_PARAM_TOY_VP = dataclasses.replace(JAX_PARAM_TOY, name="PARAM_TOY_VP",
                                       cbs_level=1, cbs_base_log=15)


def _signed(phase, want):
    return (phase - want).astype(np.int64).astype(np.float64)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("key_cache")


@pytest.fixture(scope="module")
def keysets(cache_dir):
    """name -> (port sk, port keys, JAX sk, JAX keys), the same keys."""
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("TFHE_AES_TPU_CACHE", str(cache_dir))
        m.setitem(jserialization._PARAM_SETS, "PARAM_TOY_VP",
                  JAX_PARAM_TOY_VP)
        for p in (PARAM_TOY, PARAM_TOY_VP):
            client = Client(p, seed=SEED)
            keys = client.make_device_keys(fast=False, device="cpu")
            path = serialization.cache_path(p, SEED)
            serialization.save_keys(path, client.sk, keys)
            jsk, jkeys = jserialization.load_keys(path)
            assert jsk.params.name == p.name
            out[p.name] = (client.sk, keys, jsk, jax.device_put(jkeys))
    return out


def test_pbs_errors_equal_jax(keysets):
    sk, keys, jsk, jkeys = keysets["PARAM_TOY"]
    got = noise_study.pbs_errors(keys, sk, 64, np.random.default_rng(123))

    rng = np.random.default_rng(123)
    bits = rng.integers(0, 2, 64).astype(U64)
    small = jnb.lwe_encrypt(jsk.lwe_key, bits << U64(63),
                            JAX_PARAM_TOY.lwe_noise_std, rng)
    out = np.asarray(jax.jit(jcbs.pbs_boolean, static_argnums=2)(
        jkeys, jnp.asarray(small), 62))
    want = _signed(jnb.lwe_phase(jsk.big_lwe_key, out), bits << U64(62))
    assert got.shape == (64,)
    assert np.array_equal(got, want)
    assert 0 < np.abs(got).max() < 2.0 ** 61


@pytest.mark.parametrize("name", ["PARAM_TOY", "PARAM_TOY_VP"])
def test_wopbs_errors_equal_jax(keysets, name):
    sk, keys, jsk, jkeys = keysets[name]
    p = jsk.params
    got = noise_study.wopbs_errors(keys, sk, 4, np.random.default_rng(123))

    rng = np.random.default_rng(123)
    byts = rng.integers(0, 256, 4).astype(np.int64)
    bb = ((byts[:, None] >> np.arange(8)) & 1).astype(U64)
    cts = jnb.lwe_encrypt(jsk.big_lwe_key, bb << U64(63), p.glwe_noise_std,
                          rng)
    ident = jnp.asarray(jluts.lut_polys_from_tables(
        p, np.arange(256, dtype=np.uint64)[None], 8))
    out = np.asarray(jwopbs.many_wopbs_jit(jkeys, jnp.asarray(cts), ident))
    want = _signed(jnb.lwe_phase(jsk.big_lwe_key, out), bb << U64(63))
    assert got.shape == (4, 8)
    assert np.array_equal(got, want)
    assert 0 < np.abs(got).max() < 2.0 ** 62


def test_classic_errors_equal_the_reference_golden_model(keysets):
    sk, _, jsk, _ = keysets["PARAM_TOY"]
    got = noise_study.classic_errors(sk, 1, np.random.default_rng(123))

    p = jsk.params
    rng = np.random.default_rng(123)
    bits = rng.integers(0, 2, 1).astype(U64)
    small = jnb.lwe_encrypt(jsk.lwe_key, bits << U64(63), p.lwe_noise_std,
                            rng)
    bsk = jnb.bsk_gen(jsk, np.random.default_rng(0))
    two_n = 2 * p.polynomial_size
    test = jnb.cbs_test_glwe(p, 62)
    ct = small[0].copy()
    ct[-1] += U64(1) << U64(62)
    acc = jnb.blind_rotate(bsk, ct, test, p.pbs_base_log, p.pbs_level)
    tilde = jnb.modswitch(ct, two_n)
    rot = (int((tilde[:-1] * jsk.lwe_key.astype(np.int64)).sum())
           - int(tilde[-1])) % two_n
    want = _signed(jnb.glwe_phase(jsk.glwe_key, acc),
                   jnb.polynomial_rotate(test[-1], rot))
    assert got.shape == (p.polynomial_size,)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("classic", [0, 1])
def test_main_writes_only_its_report(keysets, cache_dir, monkeypatch,
                                     tmp_path, capsys, classic):
    """The CLI at PARAM_TOY on the CPU, keys from the cache: the report goes
    to --out and nowhere else, the TPU's reports stay as they are, and the
    exit code is the verdict of its checks on the same draws."""
    sk, keys = keysets["PARAM_TOY"][:2]
    monkeypatch.setenv("TFHE_AES_TPU_CACHE", str(cache_dir))
    tpu_reports = {f: f.read_bytes() for f in (REPO / "NOISE_REPORT.md",
                                               REPO / "NOISE_REPORT_TPU.md")}
    root_reports = sorted(REPO.glob("NOISE_REPORT*"))
    cached = sorted(cache_dir.iterdir())
    out = tmp_path / "report.md"
    rc = noise_study.main(["--params", "toy", "--device", "cpu", "--seed",
                           str(SEED), "--pbs", "32", "--wopbs-bytes", "2",
                           "--classic", str(classic), "--out", str(out)])
    assert sorted(tmp_path.iterdir()) == [out]
    assert sorted(REPO.glob("NOISE_REPORT*")) == root_reports
    assert sorted(cache_dir.iterdir()) == cached
    for f, text in tpu_reports.items():
        assert f.read_bytes() == text

    rng = np.random.default_rng(123)
    pbs = noise_study.Stage.of(noise_study.pbs_errors(keys, sk, 32, rng))
    wop = noise_study.Stage.of(noise_study.wopbs_errors(keys, sk, 2, rng))
    ok = noise_study.budget_ok(PARAM_TOY, pbs, wop, classic > 0)
    assert rc == (0 if ok else 1)
    report = out.read_text()
    printed = capsys.readouterr().out
    assert report in printed
    assert f"# budget check: {'PASS' if ok else 'FAIL'}" in printed
    assert "Device: cpu" in report
    assert f"| boolean PBS (device, twiddle) | 32 | {pbs.sigma:.2f} | " \
        f"{pbs.max_err:.2f} |" in report
    assert f"| many-LUT WoPBS output (device) | 16 | {wop.sigma:.2f} |" \
        in report
    if classic:
        assert f"mod-2^{keys.rplan.q_bits} rotate domain" in report
        assert "| boolean PBS (golden, classic CMux, mod 2^64) | 128 |" \
            in report
    else:
        assert "Analytic model" in report and "classic" not in report


def test_run_makes_and_saves_keys_without_a_cache(tmp_path, monkeypatch,
                                                  capsys):
    """No cache file: device keygen, saved; the next run loads it and
    measures the same errors."""
    monkeypatch.setenv("TFHE_AES_TPU_CACHE", str(tmp_path / "cache"))
    kwargs = dict(n_pbs=8, n_wopbs_bytes=1, n_classic=0, seed=5,
                  device="cpu", out=tmp_path / "r.md")
    first = noise_study.run(PARAM_TOY, **kwargs)
    assert "[client] saved keys to" in capsys.readouterr().out
    assert serialization.cache_path(PARAM_TOY, 5).exists()
    second = noise_study.run(PARAM_TOY, **kwargs)
    assert "[client] loaded cached keys" in capsys.readouterr().out
    assert np.array_equal(first.pbs, second.pbs)
    assert np.array_equal(first.wopbs, second.wopbs)
    assert second.classic is None


@pytest.mark.parametrize("argv, params, classic", [
    (["tpu"], "tpu", 0),
    (["--params", "tpu"], "tpu", 0),
    (["tpu", "--params", "tpu", "--classic", "2"], "tpu", 2),
    ([], "prod", 8),
    (["--params", "toy"], "toy", 8),
], ids=["positional_tpu", "flag_tpu", "both_tpu", "default", "toy"])
def test_parse_args(argv, params, classic):
    args = noise_study.parse_args(argv)
    assert (args.params, args.classic) == (params, classic)
    assert (args.pbs, args.wopbs_bytes, args.seed, args.device) == \
        (4096, 512, 0, "cuda")


def test_positional_tpu_refuses_another_set():
    with pytest.raises(SystemExit):
        noise_study.parse_args(["tpu", "--params", "prod"])
