"""Wrapper of the CUDA blind-rotate kernel (csrc/blind_rotate.cu).

Counterpart of tfhe_aes_tpu/ops/pallas_blind_rotate.blind_rotate_pallas:
same inputs, same words out.  The kernel's C entry point runs all n CMux
steps on PyTorch's current stream; this wrapper does the setup and the
final rescale in torch, allocates the scratch, and counts its launches in
``blind_rotate_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from tfhe_aes_tpu.params import ParamSet
from . import cuda_build, ntt
from .blind_rotate import rotate_finish, rotate_setup

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = cuda_build.load("blind_rotate")
    fn = lib.tfhe_blind_rotate
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _I, ctypes.c_uint64, _P]
    fn.restype = _I
    return fn


def blind_rotate_cuda(plan: ntt.NttPlan, params: ParamSet,
                      bsk_limbs: torch.Tensor, lwe_ct: torch.Tensor,
                      test_glwe: torch.Tensor, fwd_full: torch.Tensor,
                      inv_crt_full: torch.Tensor,
                      rot_table: torch.Tensor) -> torch.Tensor:
    """lwe_ct [B, n+1] -> acc [B, k+1, N] u64 words, on the card."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    lev, blog = params.pbs_level, params.pbs_base_log
    pcount, q = plan.n_primes, plan.q_bits
    pn, r_rows = pcount * n, kp1 * lev
    dn = 2 * n if blog > 8 else n
    if blog > 12 or n % 64:
        raise ValueError("blind-rotate kernel needs base_log <= 12 and N a "
                         "multiple of 64")
    B = lwe_ct.shape[0]
    expect = cuda_build.expect
    expect(lwe_ct, "lwe_ct", torch.int64, (B, params.lwe_dimension + 1))
    if bsk_limbs.shape[0] < params.lwe_dimension:
        raise ValueError("bsk_limbs has fewer steps than lwe_dimension")
    expect(bsk_limbs, "bsk_limbs", torch.int8,
           (bsk_limbs.shape[0], r_rows * 2 * kp1, pn))
    expect(fwd_full, "fwd_full", torch.int8, (dn, 2 * pn))
    expect(inv_crt_full, "inv_crt_full", torch.int8, (pcount, 2 * n, 2 * n))
    expect(rot_table, "rot_table", torch.int16, (2 * n, pn))

    fn = _lib()
    dev = lwe_ct.device
    tilde, acc = rotate_setup(plan, params, lwe_ct, test_glwe)
    tilde = tilde.contiguous()
    acc = acc.contiguous().clone()
    fwd_t = fwd_full.t().contiguous()
    inv_t = inv_crt_full.transpose(1, 2).contiguous()
    bsk = bsk_limbs.contiguous()
    rot = rot_table.contiguous()
    a_buf = torch.empty(B * r_rows * dn, dtype=torch.int8, device=dev)
    dh = torch.empty(B * r_rows * pn, dtype=torch.int32, device=dev)
    x_buf = torch.empty(pcount * B * kp1 * 2 * n, dtype=torch.int8, device=dev)
    y_buf = torch.empty(pcount * B * kp1 * n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(acc.data_ptr(), tilde.data_ptr(), tilde.shape[1],
                bsk.data_ptr(), fwd_t.data_ptr(), inv_t.data_ptr(),
                rot.data_ptr(), a_buf.data_ptr(), dh.data_ptr(),
                x_buf.data_ptr(), y_buf.data_ptr(),
                B, params.lwe_dimension, kp1, n, lev, blog, q,
                *cuda_build.prime_args(plan), stream)
    blind_rotate_cuda.launches += 1
    cuda_build.check(rc, "blind-rotate kernel")
    return rotate_finish(acc, q)


blind_rotate_cuda.launches = 0
