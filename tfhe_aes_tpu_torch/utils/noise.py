"""Noise-budget audit derived from the real circuits.

Counterpart of tfhe_aes_tpu/utils/noise.py.  The port's own circuits
(models/fhe_aes.py) run with every ciphertext replaced by a one-word
tensor holding its noise level and ``ops.wopbs.many_wopbs`` and
``many_wopbs_jit`` replaced by a stub that (a) records the level of every
bootstrap input and (b) returns fresh level-1 outputs.  A fresh
encryption or bootstrap output is level 1; adding two ciphertexts adds
their levels.  Since the circuits run as
they are, any change to their add/refresh structure shows up here.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from ..params import ParamSet
from ..models import fhe_aes
from ..ops import wopbs

I64 = torch.int64


class _Ledger:
    """Records the highest noise level fed into any WoPBS."""

    def __init__(self):
        self.max_wopbs_in = 0

    def observe(self, lvl: int) -> None:
        self.max_wopbs_in = max(self.max_wopbs_in, lvl)


class _StubKeys:
    """DeviceKeys stand-in: with WoPBS stubbed, circuits only read .params."""

    def __init__(self, params: ParamSet):
        self.params = params


@contextlib.contextmanager
def _audit_context(ledger: _Ledger):
    def stub(keys, byte_bits, lut_polys):
        ledger.observe(int(byte_bits.max()))
        return torch.ones((byte_bits.shape[0], lut_polys.shape[-3], 1),
                          dtype=I64)

    with mock.patch.object(wopbs, "many_wopbs", stub), \
            mock.patch.object(wopbs, "many_wopbs_jit", stub):
        yield


def _fresh(*shape) -> torch.Tensor:
    """A level-1 (fresh encryption / bootstrap output) stand-in."""
    return torch.ones(shape, dtype=I64)


def _audit(run) -> dict[str, int]:
    ledger = _Ledger()
    with _audit_context(ledger):
        out = run()
    return {"wopbs_in": ledger.max_wopbs_in, "output": int(out.max())}


def audit_encrypt(params: ParamSet) -> dict[str, int]:
    return _audit(lambda: fhe_aes.aes_encrypt(
        _StubKeys(params), _fresh(11, 16, 8, 1), _fresh(1, 16, 8, 1)))


def audit_decrypt(params: ParamSet) -> dict[str, int]:
    return _audit(lambda: fhe_aes.aes_decrypt(
        _StubKeys(params), _fresh(11, 16, 8, 1), _fresh(1, 16, 8, 1)))


def audit_key_expansion(params: ParamSet) -> dict[str, int]:
    """Default schedule: trivial noise-free RCON encodings (level 0)."""
    return _audit(lambda: fhe_aes.aes_key_expansion(
        _StubKeys(params), _fresh(16, 8, 1),
        torch.zeros((10, 8, 1), dtype=I64), rcon_fresh=False))


def _level_rcon(params: ParamSet) -> np.ndarray:
    """trivial_rcon as noise levels: noise-free encodings, level 0."""
    return np.zeros((10, 8, 1), dtype=np.uint64)


def audit_key_expansion_staged(params: ParamSet) -> dict[str, int]:
    """The server's default schedule (Server.aes_key_expansion): trivial
    RCON, the prologue WoPBS on the whole key reordered."""
    with mock.patch.object(fhe_aes, "trivial_rcon", _level_rcon):
        return _audit(lambda: fhe_aes.aes_key_expansion_staged(
            _StubKeys(params), _fresh(16, 8, 1)))


def audit_key_expansion_pk(params: ParamSet) -> dict[str, int]:
    """Reference-faithful schedule: public-key RCON, fresh level 1."""
    return _audit(lambda: fhe_aes.aes_key_expansion(
        _StubKeys(params), _fresh(16, 8, 1), _fresh(10, 8, 1),
        rcon_fresh=True))


def audit_ctr_step(params: ParamSet) -> dict[str, int]:
    """The CTR unit: ripple-carry counter add + AES encrypt.  The LUT
    stand-ins carry only the LUT axis the stub reads: {8 sum bits + 1
    carry} per ripple step."""
    return _audit(lambda: fhe_aes.ctr_step(
        _StubKeys(params), _fresh(11, 16, 8, 1), _fresh(16, 8, 1),
        torch.zeros((1, 9, 1, 1), dtype=I64),
        torch.zeros((15, 1, 9, 1, 1), dtype=I64)))


def audit_all(params: ParamSet) -> dict[str, dict[str, int]]:
    """Audit every circuit the port ships.  Raises AssertionError if any
    WoPBS input or output exceeds params.max_noise_level."""
    out = {
        "encrypt": audit_encrypt(params),
        "decrypt": audit_decrypt(params),
        "key_expansion": audit_key_expansion(params),
        "key_expansion_staged": audit_key_expansion_staged(params),
        "key_expansion_pk": audit_key_expansion_pk(params),
        "ctr_step": audit_ctr_step(params),
    }
    for name, levels in out.items():
        for where, lvl in levels.items():
            if lvl > params.max_noise_level:
                raise AssertionError(
                    f"{name}/{where}: noise level {lvl} exceeds budget "
                    f"{params.max_noise_level}")
    return out
