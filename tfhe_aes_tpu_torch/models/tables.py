"""AES-128 constants, computed from first principles (FIPS-197).

The S-box is generated algebraically (multiplicative inverse in GF(2^8) then
the affine map) rather than hard-coded, and verified against known vectors in
tests; the reference ships it as literal tables
(reference src/tables/table.rs).
"""

from __future__ import annotations

import functools

import numpy as np


def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


@functools.lru_cache(maxsize=None)
def sbox() -> np.ndarray:
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    out = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        out[x] = (b ^ ((b << 1) | (b >> 7)) ^ ((b << 2) | (b >> 6))
                  ^ ((b << 3) | (b >> 5)) ^ ((b << 4) | (b >> 4)) ^ 0x63) & 0xFF
    return out


@functools.lru_cache(maxsize=None)
def inv_sbox() -> np.ndarray:
    s = sbox()
    out = np.zeros(256, dtype=np.uint8)
    out[s] = np.arange(256, dtype=np.uint8)
    return out


def _mul_table(c: int) -> np.ndarray:
    return np.array([_gf_mul(x, c) for x in range(256)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def gf_mul_table(c: int) -> np.ndarray:
    """256-entry table of x -> c*x in GF(2^8) (c in {2,3,9,11,13,14})."""
    return _mul_table(c)


RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                dtype=np.uint8)
