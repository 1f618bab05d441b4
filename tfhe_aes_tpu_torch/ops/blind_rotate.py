"""Batched blind rotation (torch), dispatched to the CUDA kernel on a card.

Counterpart of tfhe_aes_tpu/ops/blind_rotate.py: the TFHE accumulator loop
acc = X^-b~ * v;  acc += (X^a~_i - 1) * (G^-1(acc) (x) BSK_i), with the
monomial applied after the MAC as an NTT-domain twiddle, in the mod-2^q'
rotate domain (q' = 48; the reference module's docstring has the noise
accounting).

``blind_rotate`` takes the plain version for CPU tensors and the
hand-written kernel (ops/cuda_blind_rotate.py) for CUDA tensors; there is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..params import ParamSet
from ..utils import torus
from . import decompose, lwe, modular, ntt


def external_product_ntt(plan: ntt.NttPlan, diff: torch.Tensor,
                         ggsw_ntt_i32: torch.Tensor, base_log: int,
                         levels: int, fwd_limbs, inv_crt_limbs
                         ) -> torch.Tensor:
    """GGSW (NTT residues) x GLWE-delta (u64 words) -> GLWE (u64 words).

    diff: [B, F..., k+1, N] against per-batch GGSW ggsw_ntt_i32
    [P, B, R, k+1, N].  Returns diff's shape.
    """
    digits = decompose.glwe_digits_flat(diff, base_log, levels)
    if base_log <= 8:
        dhat = ntt.ntt_fwd_digits(plan, digits.to(torch.int8), fwd_limbs)
    else:
        dhat = ntt.ntt_fwd_wide(plan, digits, fwd_limbs)
    P = dhat.shape[0]
    lead = dhat.shape[1:-2]
    r, n = dhat.shape[-2], dhat.shape[-1]
    b = ggsw_ntt_i32.shape[1]
    dh = dhat.reshape(P, b, -1, r, n)
    prod = ntt.mac_batched(plan, dh, ggsw_ntt_i32)
    kp1 = ggsw_ntt_i32.shape[-2]
    prod = prod.reshape((P,) + lead + (kp1, n))
    return ntt.intt_crt_u64(plan, prod, inv_crt_limbs)


def rotate_setup(plan: ntt.NttPlan, params: ParamSet, lwe_ct: torch.Tensor,
                 test_glwe: torch.Tensor):
    """Mod-switch the LWE batch and build acc0 = X^(-b~) * test in the
    mod-2^q' domain.  Returns (tilde int32 [B, n+1], acc0 [B, k+1, N])."""
    two_n = 2 * params.polynomial_size
    q = plan.q_bits
    if not params.pbs_base_log * params.pbs_level <= q <= 64:
        raise ValueError("rotate plan modulus below the gadget's digit bits")
    tilde = lwe.modswitch(lwe_ct, two_n)
    b_t = tilde[:, -1]
    if test_glwe.dim() == 2:
        test_glwe = test_glwe[None].expand((lwe_ct.shape[0],)
                                           + test_glwe.shape)
    acc0 = lwe.neg_rotate(test_glwe, ((two_n - b_t) % two_n)[:, None])
    if q < 64:                                   # mod-switch once to q'
        acc0 = torus.shr(acc0 + (1 << (63 - q)), 64 - q)
    return tilde, acc0


def rotate_finish(acc: torch.Tensor, q: int) -> torch.Tensor:
    """Mask the mod-2^q' accumulator and scale it back to the 2^64 torus."""
    if q < 64:
        return (acc & ((1 << q) - 1)) << (64 - q)
    return acc


def blind_rotate_plain(plan: ntt.NttPlan, params: ParamSet,
                       bsk_limbs: torch.Tensor, lwe_ct: torch.Tensor,
                       test_glwe: torch.Tensor, fwd_limbs: torch.Tensor,
                       inv_crt_limbs: torch.Tensor,
                       rot_table: torch.Tensor) -> torch.Tensor:
    """Plain torch blind rotation (the reference module's XLA loop).

    lwe_ct [B, n+1]; test_glwe [k+1, N] or [B, k+1, N]; bsk_limbs
    [n_pad, R*2(k+1), P*N] int8; rot_table [2N, P*N] int16.
    Returns acc [B, k+1, N] u64 words encrypting X^(-phase~) * test.
    """
    n_poly = params.polynomial_size
    kp1 = params.glwe_dimension + 1
    q = plan.q_bits
    pcount = plan.n_primes
    tilde, acc = rotate_setup(plan, params, lwe_ct, test_glwe)
    base_log, levels = params.pbs_base_log, params.pbs_level
    p_c, inv_c, _ = ntt._prime_consts(plan, 4, acc.device)
    for i in range(params.lwe_dimension):
        digits = decompose.glwe_digits_flat(acc, base_log, levels, q)
        if base_log <= 8:
            dhat = ntt.ntt_fwd_digits(plan, digits.to(torch.int8), fwd_limbs)
        else:
            dhat = ntt.ntt_fwd_wide(plan, digits, fwd_limbs)
        dl, dh = modular.to_balanced_limbs2(dhat)       # [P, B, R, N]
        g_m = bsk_limbs[i]                              # [R*2J, P*N]
        g = g_m.reshape(g_m.shape[0], pcount, n_poly).permute(1, 0, 2)
        prod = ntt.mac_rows(plan, dl, dh, g, kp1)       # [P, B, J, N]
        tw_m = rot_table[tilde[:, i].to(torch.int64)]   # [B, P*N] int16
        tw = tw_m.to(torch.int32).reshape(-1, pcount, n_poly).permute(1, 0, 2)
        delta_hat = ntt.barrett_rotate_delta(plan, prod, tw, p_c, inv_c)
        acc = acc + ntt.intt_crt_u64(plan, delta_hat, inv_crt_limbs)
        if q < 64:
            acc = acc & ((1 << q) - 1)
    return rotate_finish(acc, q)


def blind_rotate(plan: ntt.NttPlan, params: ParamSet, bsk_limbs: torch.Tensor,
                 lwe_ct: torch.Tensor, test_glwe: torch.Tensor,
                 fwd_limbs: torch.Tensor, fwd_full: torch.Tensor,
                 inv_crt_limbs: torch.Tensor, inv_crt_full: torch.Tensor,
                 rot_table: torch.Tensor) -> torch.Tensor:
    """lwe_ct [B, n+1] -> acc [B, k+1, N]; the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if lwe_ct.is_cuda:
        from . import cuda_blind_rotate
        return cuda_blind_rotate.blind_rotate_cuda(
            plan, params, bsk_limbs, lwe_ct, test_glwe, fwd_full,
            inv_crt_full, rot_table)
    return blind_rotate_plain(plan, params, bsk_limbs, lwe_ct, test_glwe,
                              fwd_limbs, inv_crt_limbs, rot_table)
