"""Exact modular arithmetic for the RNS/NTT pipeline (torch).

Counterpart of tfhe_aes_tpu/ops/modular.py: balanced residues mod small
primes p < 2^16 in int32, reduced by a Barrett step with an f32 reciprocal
whose quotient is fixed up by conditional subtracts.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the quotient estimates match too.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def barrett_reduce(t: torch.Tensor, p, inv_p) -> torch.Tensor:
    """Balanced reduction mod p of int32 t with |t| < ~2^30.9.

    p, inv_p: Python scalars or broadcastable int32 / float32 tensors.
    """
    q = t.to(torch.float32).mul_(inv_p).round_().to(I32)
    r = q.mul_(p).neg_().add_(t)                     # t - q*p
    half = (p - 1) // 2
    r.sub_((r > half) * p)
    return r.add_((r < -half) * p)


def to_balanced_limbs2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced residues (|x| < 2^15) -> two signed 8-bit limbs (lo, hi)."""
    hi = (x + 128) >> 8
    lo = x - (hi << 8)
    return lo.to(torch.int8), hi.to(torch.int8)


def host_balanced(x: np.ndarray, p: int) -> np.ndarray:
    """Host: canonical residues [0,p) -> balanced [-(p-1)/2, (p-1)/2]."""
    x = np.asarray(x) % p
    return np.where(x > p // 2, x - p, x).astype(np.int64)


def host_balanced_limbs2(x: np.ndarray) -> np.ndarray:
    """Host version of to_balanced_limbs2 -> int8 [..., 2]."""
    x = np.asarray(x, dtype=np.int64)
    hi = (x + 128) >> 8
    lo = x - (hi << 8)
    if lo.min() < -128 or lo.max() > 127 or hi.min() < -128 or hi.max() > 127:
        raise ValueError("residues too wide for two int8 limbs")
    return np.stack([lo, hi], axis=-1).astype(np.int8)


# The CUDA blind-rotate kernels reduce with a 32-bit Barrett step
# (csrc/blind_rotate.cu, reduce_canonical): u = x + off in [0, 2^32), then
# r = u - umulhi(u, m) * p in [0, 2p), one conditional subtract.  With off
# the least multiple of p >= 2^31 (< 2^31 + 2^16), u fits 32 bits for every
# |x| <= BARRETT32_BOUND; host_barrett32 mirrors it step by step.
BARRETT32_BOUND = (1 << 31) - (1 << 16) - 1


def barrett32_consts(p: int) -> tuple[int, int]:
    """(m, off) for a prime p < 2^16: m = floor(2^32 / p), off = the least
    multiple of p >= 2^31."""
    return (1 << 32) // p, -(-(1 << 31) // p) * p


def host_partial32(x, p: int) -> np.ndarray:
    """numpy mirror of the kernels' reduce_partial: a representative of
    x mod p in (-p, 2p) for any int32 x, from the signed high word of x m."""
    x = np.asarray(x, dtype=np.int64)
    m, _ = barrett32_consts(p)
    return x - ((x * m) >> 32) * p


def host_barrett32(x, p: int, balanced: bool = False) -> np.ndarray:
    """numpy mirror of the kernels' reduce_canonical (reduce_balanced when
    `balanced`): x mod p for int |x| <= BARRETT32_BOUND, in 32-bit unsigned
    steps."""
    x = np.asarray(x, dtype=np.int64)
    if x.size and np.abs(x).max() > BARRETT32_BOUND:
        raise ValueError("input outside the 32-bit Barrett range")
    m, off = barrett32_consts(p)
    u = (x + off).astype(np.uint64)
    if x.size and u.max() >= 1 << 32:
        raise ValueError("x + off does not fit 32 bits")
    quot = (u * np.uint64(m)) >> np.uint64(32)
    r = (u - quot * np.uint64(p)) & np.uint64(0xFFFFFFFF)
    r = np.where(r >= p, r - np.uint64(p), r).astype(np.int64)
    return np.where(r > (p - 1) // 2, r - p, r) if balanced else r
