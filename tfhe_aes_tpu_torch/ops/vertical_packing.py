"""Vertical packing: batched multi-LUT evaluation from GGSW bits (torch).

Counterpart of tfhe_aes_tpu/ops/vertical_packing.py: all LUT output
polynomials ride one accumulator batch axis, every CMux step is a batched
external product against the per-byte GGSW.  The CMux rotations over the
low selector bits go to the CUDA kernel (ops/cuda_vp.py) for CUDA tensors
when cbs_level == 1, as the reference sends them to its Pallas kernel.
"""

from __future__ import annotations

import torch

from . import blind_rotate, lwe
from .keys import DeviceKeys


def vp_rotations_plain(keys: DeviceKeys, acc: torch.Tensor,
                       ggsw_ntt: torch.Tensor) -> torch.Tensor:
    """The CMux rotations, plain: bit j (LSB first) selects X^(-2^j).

    acc [B, L, k+1, N] u64 words; ggsw_ntt [nbits, P, B, R2, k+1, N].
    """
    p = keys.params
    n = p.polynomial_size
    for j in range(ggsw_ntt.shape[0]):
        rot = lwe.neg_rotate_const(acc, 2 * n - (1 << j))
        acc = acc + blind_rotate.external_product_ntt(
            keys.plan, rot - acc, ggsw_ntt[j], p.cbs_base_log, p.cbs_level,
            keys.fwd_limbs, keys.inv_crt_limbs)
    return acc


def vp_rotations(keys: DeviceKeys, acc: torch.Tensor,
                 ggsw_ntt: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if acc.is_cuda:
        from . import cuda_vp
        return cuda_vp.vp_rotations_cuda(keys, acc, ggsw_ntt)
    return vp_rotations_plain(keys, acc, ggsw_ntt)


def vertical_packing(keys: DeviceKeys, ggsw_ntt: torch.Tensor,
                     lut_polys: torch.Tensor) -> torch.Tensor:
    """Evaluate LUTs under GGSW-encrypted selector bits.

    ggsw_ntt:  [nbits, P, B, R2, k+1, N] int32 (bit j at index j, LSB first).
    lut_polys: [B or 1, L, C, N] u64 words, C = 2^tree_bits chunk polys.
    Returns big-LWE [B, L, big+1] of lut[value] per (batch, output).
    """
    plan, p = keys.plan, keys.params
    nbits = ggsw_ntt.shape[0]
    n = p.polynomial_size
    n_rot = min(nbits, p.log2_poly_size)
    tree_bits = nbits - n_rot
    B = ggsw_ntt.shape[2]
    L, C = lut_polys.shape[1], lut_polys.shape[2]
    if C != 1 << tree_bits:
        raise ValueError("LUT chunk count does not match the selector bits")

    acc = torch.zeros((B, L, C, p.glwe_dimension + 1, n), dtype=torch.int64,
                      device=ggsw_ntt.device)
    acc[..., -1, :] = lut_polys.expand(B, L, C, n)

    # CMux tree over the high bits: halves the chunk axis per layer.
    for t in range(tree_bits):
        a0, a1 = acc[:, :, 0::2], acc[:, :, 1::2]
        acc = a0 + blind_rotate.external_product_ntt(
            plan, a1 - a0, ggsw_ntt[n_rot + t], p.cbs_base_log, p.cbs_level,
            keys.fwd_limbs, keys.inv_crt_limbs)
    acc = acc[:, :, 0]                                  # [B, L, k+1, N]

    if p.cbs_level == 1 and n_rot > 0:
        acc = vp_rotations(keys, acc, ggsw_ntt[:n_rot])
    else:
        acc = vp_rotations_plain(keys, acc, ggsw_ntt[:n_rot])
    return lwe.sample_extract0(acc)
