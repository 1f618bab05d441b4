"""LWE on the discretised torus Z / 2^64, in numpy: the benchmark's secret
keys, the encryption of its inputs and the decryption that judges the
program's outputs.

A ciphertext of n + 1 u64 words is a mask a[0..n-1] then the body
b = <a, s> + m + e (mod 2^64), a bit m encoded at 2^63.  Outputs of the
circuits are LWE ciphertexts under the flattened GLWE key (k N words).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
ROWS = 4096          # rows a block of the decryption


def draw_secret_keys(rng: np.random.Generator, lwe_dimension: int,
                     glwe_dimension: int, polynomial_size: int):
    """Binary keys: the small LWE key [n] and the GLWE key [k, N]."""
    lwe_key = rng.integers(0, 2, size=lwe_dimension, dtype=U64)
    glwe_key = rng.integers(0, 2, size=(glwe_dimension, polynomial_size),
                            dtype=U64)
    return lwe_key, glwe_key


def encrypt_bits(key: np.ndarray, bits: np.ndarray, std: float,
                 rng: np.random.Generator) -> np.ndarray:
    """bits [...] in {0, 1} -> ciphertexts [..., n + 1] u64, Gaussian noise
    of standard deviation std (a share of the torus)."""
    bits = np.asarray(bits, dtype=U64)
    a = rng.integers(0, 1 << 64, size=bits.shape + key.shape, dtype=U64)
    e = np.round(rng.normal(0.0, std * 2.0 ** 64, size=bits.shape))
    b = a @ key + (bits << U64(63)) + e.astype(np.int64).astype(U64)
    return np.concatenate([a, b[..., None]], axis=-1)


def decrypt(key: np.ndarray, cts: np.ndarray, want: np.ndarray):
    """Decrypt cts [..., n + 1] against the bits the reference wants
    [...]: (wrong bits, the phase errors as float64 [...]).  The error of
    a bit is its phase less 2^63 times the wanted bit, as a signed 64-bit
    number: a wrong bit's is about 2^62 or more in size."""
    shape = np.shape(want)
    flat = cts.reshape(-1, cts.shape[-1])
    want = np.asarray(want, dtype=U64).reshape(-1)
    err = np.empty(flat.shape[0], np.float64)
    wrong = 0
    for lo in range(0, flat.shape[0], ROWS):
        rows, bits = flat[lo:lo + ROWS], want[lo:lo + ROWS]
        phase = rows[:, -1] - rows[:, :-1] @ key
        got = (phase + U64(1 << 62)) >> U64(63)
        wrong += int(np.count_nonzero(got != bits))
        err[lo:lo + ROWS] = (phase - (bits << U64(63))).view(np.int64)
    return wrong, err.reshape(shape)
