"""Timing helpers: a device completion fence and the PBS accounting.

Counterpart of tfhe_aes_tpu/utils/profiling.py.
"""

from __future__ import annotations

import torch


def device_fence(x: torch.Tensor) -> torch.Tensor:
    """Wait until the work producing `x` is done (a CUDA sync on its
    device; nothing to wait for on the CPU).  Returns `x`."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def count_pbs_per_block(params) -> int:
    """PBS-class bootstraps per AES-128 CTR block: each circuit-
    bootstrapped bit costs cbs_level blind rotates, bit extraction none;
    encrypt is 10 rounds x 128 bits, the ripple add 8 + 15 x 9 bits."""
    return (10 * 128 + 8 + 15 * 9) * params.cbs_level
