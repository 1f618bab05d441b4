"""Exact u64 torus arithmetic helpers (host / numpy side).

Everything here is bit-exact modular arithmetic on Z_{2^64}; numpy's uint64
wraparound gives us the native torus modulus for free (the reference's
``ciphertext_modulus: native`` — reference src/client/client.rs:55).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
Q_BITS = 64


def to_u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


def gadget_decompose(v: np.ndarray, base_log: int, levels: int) -> np.ndarray:
    """Balanced (signed) gadget decomposition of u64 torus values.

    Returns int64 digits d[..., level] for level = 0..levels-1 where level 0 is
    the MOST significant digit, with digits in [-B/2, B/2 - 1] and

        sum_l d[..., l] * 2^(64 - base_log*(l+1))  ~=  v   (mod 2^64),

    with rounding error at most 2^(63 - base_log*levels).  This mirrors the
    closest-representable decomposition used by the reference's tfhe-rs calls
    (SURVEY.md section 2b) up to the choice of balanced digit set; any signed
    digit set of this magnitude yields the same noise growth.  The digit range
    is chosen so base 2^8 digits always fit int8 (MXU operand type on TPU).
    """
    v = np.asarray(v, dtype=np.uint64)
    B = 1 << base_log
    shift = 64 - base_log * levels
    # Round to the closest multiple of 2^shift (carry into bit 64 wraps to 0).
    vbar = (v + (U64(1) << U64(shift - 1))) >> U64(shift)  # < 2^(base_log*levels) + 1
    digits = np.empty(v.shape + (levels,), dtype=np.int64)
    carry = np.zeros(v.shape, dtype=np.uint64)
    for l in range(levels - 1, -1, -1):  # extract LSB digit first
        # t in [0, B]: raw base-B digit plus incoming carry.
        t = ((vbar >> U64(base_log * (levels - 1 - l))) & U64(B - 1)) + carry
        c = (t >= U64(B // 2)).astype(np.uint64)
        digits[..., l] = t.astype(np.int64) - (c.astype(np.int64) << base_log)
        carry = c  # carry into the next more significant digit
    return digits


def gadget_recompose(digits: np.ndarray, base_log: int, levels: int) -> np.ndarray:
    """Inverse of gadget_decompose (up to rounding): sum d_l * 2^(64-b(l+1))."""
    out = np.zeros(digits.shape[:-1], dtype=np.uint64)
    for l in range(levels):
        out = out + (digits[..., l].astype(np.uint64)
                     << U64(64 - base_log * (l + 1)))
    return out


def signed_limbs(v: np.ndarray, n_limbs: int, limb_bits: int = 8) -> np.ndarray:
    """Decompose unsigned integers into balanced signed limbs (int8-safe).

    Returns int64 limbs L[..., i], i = 0 least significant, each in
    [-2^(limb_bits-1), 2^(limb_bits-1) - 1], with
        sum_i L[..., i] << (limb_bits*i) == v  (mod 2^(limb_bits*n_limbs)).
    Used to stage u64 key material / mod-p twiddles as int8 MXU operands.
    """
    v = np.asarray(v, dtype=np.uint64)
    B = 1 << limb_bits
    half = B // 2
    limbs = np.empty(v.shape + (n_limbs,), dtype=np.int64)
    carry = np.zeros(v.shape, dtype=np.uint64)
    for i in range(n_limbs):
        t = ((v >> U64(limb_bits * i)) & U64(B - 1)) + carry
        c = (t >= U64(half)).astype(np.uint64)
        limbs[..., i] = t.astype(np.int64) - (c.astype(np.int64) << limb_bits)
        carry = c
    return limbs


def recompose_limbs_mod(limbs: np.ndarray, limb_bits: int, modulus: int) -> np.ndarray:
    """Recompose signed limbs modulo `modulus` (exact, via python-int safety)."""
    acc = np.zeros(limbs.shape[:-1], dtype=np.int64)
    for i in range(limbs.shape[-1]):
        acc = (acc + (limbs[..., i] % modulus) * pow(2, limb_bits * i, modulus)) % modulus
    return acc


def sample_gaussian_torus(rng: np.random.Generator, std_rel: float,
                          shape) -> np.ndarray:
    """Gaussian torus noise: round(N(0, std_rel) * 2^64) mod 2^64 as u64."""
    e = rng.normal(0.0, std_rel * (2.0 ** 64), size=shape)
    # Clip to avoid float->int overflow; 16 sigma is beyond any p_fail concern.
    lim = 2.0 ** 63 - 2.0 ** 32
    e = np.clip(e, -lim, lim)
    return np.round(e).astype(np.int64).astype(np.uint64)


def torus_close(a: np.ndarray, b: np.ndarray, slack_bits: int) -> np.bool_:
    """True if |a - b| (as signed torus distance) < 2^slack_bits everywhere."""
    d = (np.asarray(a, dtype=np.uint64) - np.asarray(b, dtype=np.uint64))
    d = d.astype(np.int64)
    return bool(np.all(np.abs(d) < (1 << slack_bits)))
