"""LWE/GLWE structural ops (torch): rotations, extraction, modswitch.

Counterpart of tfhe_aes_tpu/ops/lwe.py.  Torus words are int64 tensors
(utils/torus.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import torus


def lwe_trivial(m: torch.Tensor, n: int) -> torch.Tensor:
    """The noise-free LWE of body m [...] (torus words): [..., n+1], a zero
    mask of n words."""
    z = torch.zeros(m.shape + (n,), dtype=torch.int64, device=m.device)
    return torch.cat([z, m[..., None].to(torch.int64)], dim=-1)


def modswitch(ct: torch.Tensor, two_n: int) -> torch.Tensor:
    """Round torus values to Z_2N: round(x * 2N / 2^64) -> int32 [0, 2N)."""
    shift = 64 - int(np.log2(two_n))
    t = torus.shr(ct + (1 << (shift - 1)), shift)
    return (t & (two_n - 1)).to(torch.int32)


def neg_rotate(polys: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """Multiply polys[..., N] by X^amounts (negacyclic), amounts int mod 2N.

    amounts broadcasts against polys' leading axes (one rotation per batch
    element).  Gather from the doubled [poly, -poly] table.
    """
    n = polys.shape[-1]
    ext = torch.cat([polys, -polys], dim=-1)                   # [..., 2N]
    j = torch.arange(n, device=polys.device)
    idx = (j - amounts[..., None].to(torch.int64)) % (2 * n)  # [..., N]
    idx = idx.expand(polys.shape[:-1] + (n,))
    return torch.gather(ext, -1, idx)


def neg_rotate_const(polys: torch.Tensor, amount: int) -> torch.Tensor:
    """Static negacyclic rotation by `amount` (pure roll + sign)."""
    n = polys.shape[-1]
    amount = amount % (2 * n)
    ext = torch.cat([polys, -polys], dim=-1)
    return torch.roll(ext, amount, dims=-1)[..., :n]


def sample_extract0(glwe: torch.Tensor) -> torch.Tensor:
    """GLWE [..., k+1, N] -> big-LWE [..., k*N+1] of coefficient 0."""
    kp1, n = glwe.shape[-2], glwe.shape[-1]
    k = kp1 - 1
    j = torch.arange(n, device=glwe.device)
    idx = (-j) % n
    sign = torch.where(j == 0, 1, -1).to(torch.int64)
    a = glwe[..., :k, :][..., idx] * sign
    a = a.reshape(glwe.shape[:-2] + (k * n,))
    return torch.cat([a, glwe[..., k, :1]], dim=-1)
