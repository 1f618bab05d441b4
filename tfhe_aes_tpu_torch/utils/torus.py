"""The u64 torus carried in ``torch.int64``.

torch has no usable uint64 arithmetic, so every torus word Z_{2^64} lives
in an int64 tensor: add, sub and mul wrap in two's complement, which is
exact mod 2^64.  What differs from unsigned arithmetic:

  * right shift must be LOGICAL: ``shr`` masks off the sign fill;
  * order compares (carries, borrows) must be UNSIGNED: ``ult`` flips the
    sign bit of both sides first;
  * Python constants >= 2^63 do not fit a signed int64: ``signed`` maps
    them to the signed value with the same 64 bits.

At public boundaries numpy uint64 arrays convert to and from torch through
``.view(np.int64)`` (``from_u64`` / ``to_u64``): the bits never change.
"""

from __future__ import annotations

import numpy as np
import torch

_MIN = -(1 << 63)


def signed(v: int) -> int:
    """The int64 value whose 64 bits equal v mod 2^64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 words by a static k in [0, 64)."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 words."""
    return (a ^ _MIN) < (b ^ _MIN)


def from_u64(x, device=None) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64)).view(np.int64)
    t = torch.from_numpy(arr.copy())
    return t if device is None else t.to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) -> numpy uint64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)
