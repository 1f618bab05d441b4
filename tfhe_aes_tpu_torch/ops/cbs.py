"""Circuit bootstrap: bit LWE -> GGSW (NTT-ready), batched (torch).

Counterpart of tfhe_aes_tpu/ops/cbs.py: per cbs level a boolean PBS, then
one int8 product applies all k+1 private functional packing keyswitches,
then the rows are NTT-transformed once for vertical packing.
"""

from __future__ import annotations

import torch

from . import blind_rotate, decompose, lwe, ntt
from .keys import DeviceKeys
from .ntt import int8_dot


def pbs_boolean(keys: DeviceKeys, lwe_small: torch.Tensor,
                out_scale_log: int) -> torch.Tensor:
    """[B, n+1] bit at delta 2^63 -> [B, big+1] of bit * 2^out_scale_log."""
    p = keys.params
    ct = lwe_small.clone()
    ct[..., -1] += 1 << 62
    test = torch.zeros((p.glwe_dimension + 1, p.polynomial_size),
                       dtype=torch.int64, device=ct.device)
    test[-1, :] = -(1 << (out_scale_log - 1))
    acc = blind_rotate.blind_rotate(keys.rplan, p, keys.bsk_limbs, ct, test,
                                    keys.rfwd_limbs, keys.fwd_full,
                                    keys.rinv_crt_limbs, keys.inv_crt_full,
                                    keys.rot_table)
    out = lwe.sample_extract0(acc)
    out[..., -1] += 1 << (out_scale_log - 1)
    return out


def pfpksk_apply_all(keys: DeviceKeys, big_lwe: torch.Tensor) -> torch.Tensor:
    """Apply all k+1 packing keyswitches: [B, big+1] -> [B, k+1_u, k+1_j, N].

    12-bit digits split into two int8 limbs; two int8 products against the
    pre-limbed key, recombined mod 2^64.  On keys with a contraction shard
    the key holds only this rank's rows, and each int32 product is summed
    over the shard's group before recombination.
    """
    p = keys.params
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    d = decompose.gadget_decompose(big_lwe, p.pfks_base_log, p.pfks_level)
    sh = d.shape
    d = d.reshape(sh[:-2] + (sh[-2] * sh[-1],))          # [B, T2] 12-bit
    hi = (d + 128) >> 8
    lo = (d - (hi << 8)).to(torch.int8)
    hi = hi.to(torch.int8)
    out_cols = kp1 * kp1 * n
    out = None
    shard = keys.shard
    for i, dl in enumerate((lo, hi)):
        if shard is None:
            m = int8_dot(dl, keys.pfpksk_limbs)
        else:
            m = shard.int8_dot(dl, keys.pfpksk_limbs, shard.pfpksk_rows)
        m = m.reshape(m.shape[:-1] + (out_cols, 8)).to(torch.int64)
        for l in range(8):
            if 8 * l + 8 * i >= 64:
                continue                                  # 0 mod 2^64
            term = m[..., l] << (8 * l + 8 * i)
            out = term if out is None else out + term
    return out.reshape(out.shape[:-1] + (kp1, kp1, n))


def cbs_pbs_levels(keys: DeviceKeys, lwe_small: torch.Tensor) -> torch.Tensor:
    """The PBS half of circuit bootstrap: [B, n+1] -> [cbs_level, B, big+1]."""
    p = keys.params
    return torch.stack([
        pbs_boolean(keys, lwe_small, 64 - p.cbs_base_log * (l + 1))
        for l in range(p.cbs_level)])


def cbs_stage_ggsw(keys: DeviceKeys, bigs: torch.Tensor) -> torch.Tensor:
    """Packing keyswitch + NTT staging: [lev, B, big+1] -> GGSW residues
    [P, B, R2, k+1, N] int32, R2 = (k+1)*cbs_level, row u*cbs_level + l."""
    p = keys.params
    rows = [pfpksk_apply_all(keys, bigs[l]) for l in range(p.cbs_level)]
    g = torch.stack(rows, dim=2)                      # [B, u, lev, j, N]
    sh = g.shape
    g = g.reshape(sh[0], sh[1] * sh[2], sh[3], sh[4])
    res = ntt.u64_to_residues(keys.plan, g)
    return ntt.ntt_fwd_residues(keys.plan, res, keys.fwd_limbs)


def circuit_bootstrap(keys: DeviceKeys, lwe_small: torch.Tensor) -> torch.Tensor:
    """[B, n+1] bit -> GGSW NTT residues [P, B, R2, k+1, N] int32."""
    return cbs_stage_ggsw(keys, cbs_pbs_levels(keys, lwe_small))
