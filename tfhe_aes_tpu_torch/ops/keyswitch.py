"""Batched LWE keyswitch (big -> small) as one int8 product mod 2^64.

Counterpart of tfhe_aes_tpu/ops/keyswitch.py.
"""

from __future__ import annotations

import torch

from ..params import ParamSet
from . import decompose
from .keys import ContractionShard
from .ntt import int8_dot


def limb_matmul_u64(digits_i8: torch.Tensor, key_limbs_i8: torch.Tensor,
                    out_cols: int,
                    shard: ContractionShard | None = None) -> torch.Tensor:
    """[B, T] int8 @ [T, out_cols*8] int8 -> u64 words (int64) [B, out_cols].

    int32 accumulation is exact (T*128*128 < 2^31 for every key here); the
    recombination sum_l m_l * 2^(8l) wraps mod 2^64 in int64.  With a
    `shard`, the key holds only this rank's rows `shard.ksk_rows` and the
    int32 product is summed over the shard's group before recombination.
    """
    if shard is None:
        m = int8_dot(digits_i8, key_limbs_i8)
    else:
        m = shard.int8_dot(digits_i8, key_limbs_i8, shard.ksk_rows)
    m = m.reshape(m.shape[:-1] + (out_cols, 8)).to(torch.int64)
    out = m[..., 0]
    for l in range(1, 8):
        out = out + (m[..., l] << (8 * l))
    return out


def keyswitch(params: ParamSet, ksk_limbs: torch.Tensor, ct: torch.Tensor,
              shard: ContractionShard | None = None) -> torch.Tensor:
    """ct [..., big+1] under the big key -> [..., n+1] under the small key
    (`shard`: see limb_matmul_u64)."""
    a, b = ct[..., :-1], ct[..., -1]
    d = decompose.gadget_decompose(a, params.ks_base_log, params.ks_level)
    sh = d.shape
    d = d.reshape(sh[:-2] + (sh[-2] * sh[-1],)).to(torch.int8)   # [..., T]
    lead = d.shape[:-1]
    ks = limb_matmul_u64(d.reshape(-1, d.shape[-1]), ksk_limbs,
                         params.lwe_dimension + 1, shard)
    ks = ks.reshape(lead + (params.lwe_dimension + 1,))
    out = torch.zeros_like(ks)
    out[..., -1] = b
    return out - ks
