"""Runtime noise assertions on real ciphertexts: the live sanitizer.

Counterpart of tfhe_aes_tpu/utils/noise_asserts.py as a plain host check.
When armed, every WoPBS input and output (ops/wopbs.many_wopbs) is copied
to the host, its phase error measured against the secret key and held
against the analytic model's sigma (tfhe_aes_tpu/utils/noise_model.py).
Violations are recorded and raised by ``assert_clean``.  Disarmed, the
hooks cost one flag test: no copy, no device sync.

Client-side and for tests and debugging only: it needs the secret key.

    noise_asserts.enable(client.sk)
    ... run circuits ...
    noise_asserts.assert_clean()

Messages are bits at delta 2^63, so a ciphertext's phase error is the
signed distance of its phase to the nearest multiple of 2^63.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import noise_model
from . import torus

U64 = np.uint64


@dataclasses.dataclass
class _State:
    big_key: np.ndarray            # [kN] u64 binary
    budget: noise_model.NoiseBudget
    max_noise_level: int
    tol_sigmas: float
    checks: list
    failures: list


_state: _State | None = None


def enable(sk, *, tol_sigmas: float = 8.0) -> None:
    """Arm the checks for the client's SecretKeys `sk`.  A measured |error|
    above tol_sigmas x the modelled sigma is flagged (8 sigma of a
    correctly modelled Gaussian fires with p ~ 1e-15)."""
    global _state
    p = sk.params
    _state = _State(
        big_key=np.asarray(sk.big_lwe_key, dtype=U64),
        budget=noise_model.budget(p),
        max_noise_level=p.max_noise_level,
        tol_sigmas=float(tol_sigmas),
        checks=[],
        failures=[],
    )


def disable() -> None:
    global _state
    _state = None


def enabled() -> bool:
    return _state is not None


def checks() -> list:
    return list(_state.checks) if _state else []


def failures() -> list:
    return list(_state.failures) if _state else []


def assert_clean() -> None:
    """Raise if any checked point exceeded its noise bound."""
    if _state and _state.failures:
        lines = "\n".join(
            f"  {f['tag']}: max|err| 2^{f['log2_max_err']:.1f} > "
            f"{_state.tol_sigmas:g} * sigma 2^{f['log2_sigma']:.1f} "
            f"(shape {f['shape']})" for f in _state.failures)
        raise AssertionError(f"runtime noise assertions failed:\n{lines}")


def _phase_errors(cts: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Signed distance of each phase to the nearest multiple of 2^63."""
    ph = cts[..., -1] - np.einsum("...i,i->...", cts[..., :-1], key,
                                  dtype=U64, casting="unsafe").astype(U64)
    half = U64(1) << U64(62)
    e = (ph + half) & ((U64(1) << U64(63)) - U64(1))
    return e.astype(np.int64) - np.int64(half)


def _run_check(tag: str, log2_sigma: float, cts: np.ndarray) -> None:
    st = _state
    e = _phase_errors(cts, st.big_key).astype(np.float64)
    max_err = float(np.abs(e).max()) if e.size else 0.0
    rec = {
        "tag": tag,
        "log2_sigma": log2_sigma,
        "log2_max_err": math.log2(max_err) if max_err else float("-inf"),
        "log2_rms": (0.5 * math.log2(float(np.mean(e * e)))
                     if e.size and np.any(e) else float("-inf")),
        "shape": tuple(cts.shape[:-1]),
    }
    st.checks.append(rec)
    if max_err > st.tol_sigmas * 2.0 ** log2_sigma:
        st.failures.append(rec)


def check_big_lwe(tag: str, cts, kind: str):
    """Check a batch of big-LWE bit ciphertexts [..., kN+1] (u64 words in
    an int64 tensor); returns `cts` unchanged.

    kind: 'fresh' - a WoPBS output (sigma_wopbs);
          'input' - a WoPBS input after leveled additions, bounded by
                    sqrt(max_noise_level) * sigma_wopbs.
    A no-op unless enable() armed the module.
    """
    if _state is None:
        return cts
    b = _state.budget
    if kind == "fresh":
        log2_sigma = b.sigma_wopbs
    elif kind == "input":
        log2_sigma = b.sigma_wopbs + 0.5 * math.log2(_state.max_noise_level)
    else:
        raise ValueError(kind)
    _run_check(tag, log2_sigma, torus.to_u64(cts))
    return cts
