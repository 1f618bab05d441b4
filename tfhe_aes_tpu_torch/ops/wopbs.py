"""Many-LUT WoPBS: extract bits -> circuit bootstrap -> vertical packing.

Counterpart of tfhe_aes_tpu/ops/wopbs.py.  The circuit-bootstrap blind
rotates run at the full bit batch; the packing-keyswitch / NTT-staging /
vertical-packing tail runs over byte chunks in a Python loop, the chunk
sized from the device's free memory.
"""

from __future__ import annotations

import torch

from ..utils import noise_asserts
from . import cbs as cbs_mod
from . import keyswitch, vertical_packing
from .keys import DeviceKeys


def extract_bits(keys: DeviceKeys, byte_bits_big: torch.Tensor) -> torch.Tensor:
    """[..., nbits, big+1] -> [..., nbits, n+1] small-LWE bits (one
    keyswitch per bit with 1-bit radix blocks)."""
    return keyswitch.keyswitch(keys.params, keys.ksk_limbs, byte_bits_big,
                               keys.shard)


def _stage_and_pack(keys: DeviceKeys, bigs: torch.Tensor, nbytes: int,
                    nbits: int, lut_polys: torch.Tensor) -> torch.Tensor:
    """CBS tail + VP for one byte chunk: bigs [lev, nbytes*nbits, big+1]."""
    g = cbs_mod.cbs_stage_ggsw(keys, bigs)       # [P, nbytes*nbits, ...]
    g = g.reshape((g.shape[0], nbytes, nbits) + g.shape[2:])
    ggsw = g.movedim(2, 0).contiguous()           # [nbits, P, nbytes, ...]
    return vertical_packing.vertical_packing(keys, ggsw, lut_polys)


def chunk_bytes(keys: DeviceKeys, n_bytes: int, n_luts: int,
                nbits: int) -> int:
    """Bytes per WoPBS tail chunk: everything on the CPU; on a card, as
    many as fit half of its free memory by a per-byte working-set bound."""
    if keys.device.type != "cuda":
        return n_bytes
    p = keys.params
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    ggsw_words = nbits * p.cbs_level * kp1 * kp1 * n
    # A word of the VP accumulators holds 8 bytes in each of three live
    # copies (the LUT accumulator, the kernel's clone, the result), ~3
    # bytes of digit limbs and 2 bytes a prime of X: counted twice over.
    vp_bytes = n_luts * kp1 * n * 2 * (24 + 4 + 2 * keys.plan.n_primes)
    per_byte = 160 * ggsw_words + vp_bytes             # bytes, generous
    free, _ = torch.cuda.mem_get_info(keys.device)
    return max(1, min(n_bytes, free // 2 // per_byte))


def many_wopbs(keys: DeviceKeys, byte_bits_big: torch.Tensor,
               lut_polys: torch.Tensor, *,
               vp_chunk: int | None = None) -> torch.Tensor:
    """Evaluate L LUT output polynomials on a batch of radix "bytes".

    byte_bits_big: [B, nbits, big+1] u64 words, LSB first.
    lut_polys:     [B or 1, L, C, N] u64 words.
    Returns [B, L, big+1] fresh big-LWEs of each output bit.
    vp_chunk: bytes per tail chunk (default: chunk_bytes).  On keys with
    a contraction shard every chunk's products are summed over the
    shard's group, so its ranks take the least of their chunks.
    When utils/noise_asserts is armed, the input and the output are
    checked against the noise model.
    """
    if noise_asserts.enabled():
        noise_asserts.check_big_lwe("wopbs_input", byte_bits_big, "input")
    B, nbits = byte_bits_big.shape[0], byte_bits_big.shape[1]
    small = extract_bits(keys, byte_bits_big)
    bigs = cbs_mod.cbs_pbs_levels(keys, small.reshape(B * nbits, -1))
    lev, np1 = bigs.shape[0], bigs.shape[-1]
    bigs = bigs.reshape(lev, B, nbits, np1)
    bc = vp_chunk or chunk_bytes(keys, B, lut_polys.shape[1], nbits)
    if keys.shard is not None:
        bc = keys.shard.agree_min(bc, byte_bits_big.device)
    outs = []
    for lo in range(0, B, bc):
        hi = min(B, lo + bc)
        luts = lut_polys if lut_polys.shape[0] == 1 else lut_polys[lo:hi]
        outs.append(_stage_and_pack(
            keys, bigs[:, lo:hi].reshape(lev, (hi - lo) * nbits, np1),
            hi - lo, nbits, luts))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    if noise_asserts.enabled():
        noise_asserts.check_big_lwe("wopbs_output", out, "fresh")
    return out
