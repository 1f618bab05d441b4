"""Balanced gadget decomposition (torch, exact u64 carried in int64).

Counterpart of tfhe_aes_tpu/ops/decompose.py.
"""

from __future__ import annotations

import torch

from ..utils import torus


def gadget_decompose(v: torch.Tensor, base_log: int, levels: int,
                     q_bits: int = 64) -> torch.Tensor:
    """2^q_bits-torus [...] -> int32 digits [..., levels] in [-B/2, B/2-1],
    level 0 = MSB.  Exact (no rounding term) when q_bits == base_log*levels.
    """
    B = 1 << base_log
    shift = q_bits - base_log * levels
    if shift < 0:
        raise ValueError("base_log * levels exceeds q_bits")
    vbar = torus.shr(v + (1 << (shift - 1)), shift) if shift > 0 else v
    digits = [None] * levels
    carry = torch.zeros_like(v)
    for l in range(levels - 1, -1, -1):
        t = (torus.shr(vbar, base_log * (levels - 1 - l)) & (B - 1)) + carry
        c = (t >= B // 2).to(torch.int64)
        digits[l] = (t - (c << base_log)).to(torch.int32)
        carry = c
    return torch.stack(digits, dim=-1)


def glwe_digits_flat(glwe: torch.Tensor, base_log: int, levels: int,
                     q_bits: int = 64) -> torch.Tensor:
    """GLWE [..., k+1, N] -> flat digit rows [..., (k+1)*levels, N].

    Row r = u * levels + l (component-major), the GGSW row layout of
    ops.keys.pack_bsk and the external-product MAC.
    """
    d = gadget_decompose(glwe, base_log, levels, q_bits)   # [..,k+1,N,lev]
    d = d.movedim(-1, -2)                                  # [..,k+1,lev,N]
    sh = d.shape
    return d.reshape(sh[:-3] + (sh[-3] * sh[-2], sh[-1]))
