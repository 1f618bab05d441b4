"""The frozen bounds against the kernel table's and against chip_smoke's
arithmetic, and the work model against the circuits' own accounting."""

from __future__ import annotations

import collections
import dataclasses
import json

import pytest

from benchmark import harness, rooflines

def _port_set(name: str) -> dict:
    """A parameter set of the port that no cell runs, as a dict."""
    from tfhe_aes_tpu_torch import params as port_params
    p = dataclasses.asdict(getattr(port_params, name))
    del p["name"]
    return p


# param_opt as its cell runs it; PARAM_TPU, the port's default set, for
# the kernel table's shapes.
CONFIGS = {"param_opt": json.loads((harness.ROOT / "benchmark" / "configs"
                                    / "param_opt.json").read_text())["params"],
           "param_tpu": _port_set("PARAM_TPU")}
# The shapes of PERF.md's kernel table: rotate bits, VP (bytes, L).
ROTATE_BITS = {"param_tpu": (8192, 4096, 1024, 576, 512, 256, 128, 96, 72,
                             64, 36, 32, 18, 16),
               "param_opt": (4096, 512, 128, 36, 32)}
VP_SHAPES = ((1024, 24), (1024, 8), (512, 24), (512, 8), (128, 24),
             (128, 8), (64, 32), (64, 24), (64, 8), (32, 24), (32, 8),
             (16, 32), (16, 16), (16, 8), (12, 8), (4, 8))


@dataclasses.dataclass
class Primes:
    """A stand-in plan: the count holds the design's primes, not the
    port's plan."""
    n_primes: int


def test_kernel_table_bounds():
    ms = 1e3
    assert rooflines.rotate_seconds(CONFIGS["param_tpu"], 8192) * ms == \
        pytest.approx(580.76, abs=0.005)
    assert rooflines.rotate_seconds(CONFIGS["param_tpu"], 4096) * ms == \
        pytest.approx(290.38, abs=0.005)
    assert rooflines.rotate_seconds(CONFIGS["param_opt"], 4096) * ms == \
        pytest.approx(254.08, abs=0.005)
    assert rooflines.vp_seconds(CONFIGS["param_tpu"], 1024, 24, 8) * ms == \
        pytest.approx(12.50, abs=0.005)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bounds_equal_chip_smoke(config):
    import chip_smoke
    from tfhe_aes_tpu_torch import params as port_params
    p = CONFIGS[config]
    ps = getattr(port_params, "PARAM_" + config.split("_")[1].upper())
    assert chip_smoke.PEAK_INT8_OPS == rooflines.PEAK_INT8_OPS
    assert chip_smoke.PEAK_BYTES == rooflines.PEAK_BYTES
    for bits in ROTATE_BITS[config]:
        want = chip_smoke.rotate_bound(
            ps, Primes(rooflines.ROTATE_PRIMES), bits)[0] / 1e3
        assert rooflines.rotate_seconds(p, bits) == pytest.approx(want,
                                                                  rel=1e-12)
    for n_bytes, luts in VP_SHAPES:
        for nbits in (8, 9):
            want = chip_smoke.vp_bound(
                ps, Primes(rooflines.VP_PRIMES), n_bytes, luts, nbits)[0] / 1e3
            assert rooflines.vp_seconds(p, n_bytes, luts, nbits) == \
                pytest.approx(want, rel=1e-12)


def test_rooflines_read_nothing_of_the_program():
    from benchmark.tests.test_bench_rules import imported
    assert imported(harness.ROOT / "benchmark" / "rooflines.py") == {
        "__future__"}


@pytest.mark.parametrize("blocks", [1, 16])
def test_ctr_work_is_the_circuits_own(blocks):
    import torch
    from tfhe_aes_tpu_torch.models import fhe_aes
    lut_lsb = torch.zeros(blocks, 9, 1, 1)
    luts_rest = torch.zeros(15, blocks, 9, 1, 1)
    want = (fhe_aes._ripple_wopbs(lut_lsb, luts_rest)
            + fhe_aes._encrypt_wopbs(blocks))
    assert collections.Counter(rooflines.ctr_step_wopbs(blocks)) == want


@pytest.mark.parametrize("blocks", [1, 4, 16])
def test_decrypt_work_is_the_circuits_own(blocks):
    from tfhe_aes_tpu_torch.models import fhe_aes
    assert collections.Counter(rooflines.decrypt_wopbs(blocks)) == \
        fhe_aes._decrypt_wopbs(blocks)


@pytest.mark.parametrize("rcon", ["trivial", "pk"])
def test_key_schedule_work_is_the_circuits_own(rcon):
    import torch
    from tfhe_aes_tpu_torch.models import fhe_aes
    want = fhe_aes._key_expansion_wopbs(torch.zeros(10, 8, 1), rcon == "pk")
    got = rooflines.key_expansion_wopbs(rcon)
    assert collections.Counter(got) == want
    # The reference's schedule: 4 S-boxes and 16 refreshes a round.
    assert sum(b for b, _, _ in got) == (200 if rcon == "pk" else 164)


def test_work_counts_launches():
    p = CONFIGS["param_tpu"]
    w = rooflines.work(p, rooflines.ctr_step_wopbs(16)
                       + rooflines.key_expansion_wopbs())
    assert w["rotate_calls"] == 26 + 11
    assert w["rotate_steps"] == 37 * 669
    assert w["vp_bits"] == 8 + 15 * 9 + 10 * 8 + 11 * 8
    rounds = 10 * rooflines.rotate_seconds(p, 16 * 16 * 8)
    assert w["rotate_s"] > rounds
