"""The port's whole-function dispatch units against the JAX package's at
PARAM_TOY (cbs_level 2: two rotates a WoPBS), on the CPU, through a stub
capture (tests/test_torch_units.py has all five at the cbs_level=1 toy
set, and the bookkeeping; each file is one worker's).  ctr_step_jit and
aes_decrypt_jit are held against the JAX units at PARAM_TOY through the
server, on the CPU's eager path of the same units, by
tests/test_torch_ctr.py and tests/test_torch_decrypt.py: at one block
each costs two minutes here."""

import pytest
import torch

from tfhe_aes_tpu.params import PARAM_TOY
from test_torch_units import (ReplayOnce, _graphed_through, _toy_keys,
                              check_unit_equals_jax)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy():
    return _toy_keys(PARAM_TOY)


@pytest.mark.parametrize("unit", ["add_scalar_device_jit", "aes_encrypt_jit",
                                  "aes_key_expansion_jit",
                                  "aes_key_expansion_jit pk-RCON"])
def test_unit_equals_jax_at_param_toy(toy, monkeypatch, unit):
    check_unit_equals_jax(toy, _graphed_through(monkeypatch, ReplayOnce()),
                          unit)
