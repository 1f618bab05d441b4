"""The comparison that decides a run's `correct`.

Every block a run's window answered (a keystream block, or the inverse
cipher of a ciphertext block), and the round keys of the sessions it
checks, are decrypted with the benchmark's own secret key and compared with
plain AES: the keystream with AES-CTR of the session's key and IV, an
inverse cipher's answer with the plaintext the ciphertext was made from.
Two numbers, each beside its limit:

  wrong_bits   bits that decrypt to another value than AES gives: limit 0,
               an exact comparison;
  noise_share  the root mean square of the answer bits' phase errors
               over the largest standard deviation at which a bit still
               decrypts wrong with at most the configuration's p_fail
               (2^62 / z, erfc(z / sqrt 2) = p_fail): limit 1, the
               configuration's own guarantee.
"""

from __future__ import annotations

import math

import numpy as np

from . import aes, lwe

LIMITS = {"wrong_bits": 0, "noise_share": 1.0}


def budget_sigma(p_fail: float) -> float:
    """The largest noise deviation (torus units of 2^-64) at which a bit
    decrypts wrong with probability p_fail: the threshold 2^62 over z,
    erfc(z / sqrt 2) = p_fail, z found by bisection."""
    lo, hi = 0.0, 40.0
    for _ in range(200):
        mid = (lo + hi) / 2
        if math.erfc(mid / math.sqrt(2.0)) > p_fail:
            lo = mid
        else:
            hi = mid
    return 2.0 ** 62 / lo


class Judge:
    """Collects the answers of a run, then compares them all at once.

    key: the flattened GLWE key (the outputs' key); p_fail: the
    configuration's decryption-failure bound."""

    def __init__(self, key: np.ndarray, p_fail: float):
        self.key = key
        self.p_fail = p_fail
        # (ciphertexts, a function giving the bytes they should decrypt
        # to), in the order of the requests
        self.answers = []
        self.round_keys = []      # (ciphertexts, key)

    def keystream(self, cts: np.ndarray, key: int, iv: int,
                  offset: int) -> None:
        """A request's answer: cts [n, 16, 8, k N + 1] u64, block t being
        AES(key, iv + offset + t), bytes most significant first."""
        self.answers.append((cts, lambda: aes.ctr_keystream(
            key, iv, offset, cts.shape[0])))

    def decrypt(self, cts: np.ndarray, plain: np.ndarray) -> None:
        """A request's answer: cts [n, 16, 8, k N + 1] u64, block t being
        plain[t] [16] uint8, bytes most significant first."""
        self.answers.append((cts, lambda: plain))

    def schedule(self, cts: np.ndarray, key: int) -> None:
        """A session's round keys: cts [11, 16, 8, k N + 1] u64."""
        self.round_keys.append((cts, key))

    def verdict(self) -> tuple[dict, list[bool]]:
        """({number: {"value", "limit"}}, whether each answer was wrong in
        any bit)."""
        wrong_total, sq, count, failed = 0, 0.0, 0, []
        for cts, expected in self.answers:
            want = aes.bits_of(expected())
            wrong, err = lwe.decrypt(self.key, cts, want)
            wrong_total += wrong
            failed.append(wrong > 0)
            sq += float(np.sum(np.square(err)))
            count += err.size
        for cts, key in self.round_keys:
            want = aes.bits_of(aes.key_expansion(key))
            wrong_total += lwe.decrypt(self.key, cts, want)[0]
        # No answer at all has no noise to read, and fails.
        share = (math.sqrt(sq / count) / budget_sigma(self.p_fail)
                 if count else None)
        values = {"wrong_bits": wrong_total, "noise_share": share}
        return ({name: {"value": values[name], "limit": LIMITS[name]}
                 for name in LIMITS}, failed)


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
