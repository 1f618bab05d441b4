"""Wrapper of the CUDA vertical-packing kernel (csrc/vertical_packing.cu).

Counterpart of tfhe_aes_tpu/ops/pallas_vp.vp_rotations_pallas: the CMux
rotations over the low selector bits at cbs_level == 1, same words out.
Counts its launches in ``vp_rotations_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .keys import DeviceKeys

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = cuda_build.load("vertical_packing")
    fn = lib.tfhe_vp_rotations
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _I, ctypes.c_uint64, _P]
    fn.restype = _I
    return fn


def vp_rotations_cuda(keys: DeviceKeys, acc: torch.Tensor,
                      ggsw_ntt: torch.Tensor) -> torch.Tensor:
    """acc [B, L, k+1, N] u64 words; ggsw_ntt [nbits, P, B, k+1, k+1, N]
    int32 (LSB first).  Returns acc after the nbits CMux rotations."""
    p, plan = keys.params, keys.plan
    B, L, kp1, n = acc.shape
    nbits, pcount = ggsw_ntt.shape[0], plan.n_primes
    pn = pcount * n
    if p.cbs_level != 1 or p.cbs_base_log > 15 or (1 << nbits) > n \
            or n % 64:
        raise ValueError("VP kernel needs cbs_level == 1, cbs_base_log <= 15,"
                         " 2^nbits <= N and N a multiple of 64")
    expect = cuda_build.expect
    expect(acc, "acc", torch.int64,
           (B, L, p.glwe_dimension + 1, p.polynomial_size))
    expect(ggsw_ntt, "ggsw_ntt", torch.int32, (nbits, pcount, B, kp1, kp1, n))
    expect(keys.vp_fwd3, "vp_fwd3", torch.int8, (3 * n, 2 * pn))
    expect(keys.vp_inv_full, "vp_inv_full", torch.int8, (pcount, 2 * n, 2 * n))

    fn = _lib()
    dev = acc.device
    acc = acc.contiguous().clone()
    g = ggsw_ntt.contiguous()
    fwd_t = keys.vp_fwd3.t().contiguous()
    inv_t = keys.vp_inv_full.transpose(1, 2).contiguous()
    m = B * L * kp1
    a_buf = torch.empty(m * 3 * n, dtype=torch.int8, device=dev)
    dh = torch.empty(m * pn, dtype=torch.int32, device=dev)
    x_buf = torch.empty(pcount * m * 2 * n, dtype=torch.int8, device=dev)
    y_buf = torch.empty(pcount * m * n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(acc.data_ptr(), g.data_ptr(), fwd_t.data_ptr(),
                inv_t.data_ptr(), a_buf.data_ptr(), dh.data_ptr(),
                x_buf.data_ptr(), y_buf.data_ptr(),
                B, L, nbits, kp1, n, p.cbs_base_log,
                *cuda_build.prime_args(plan), stream)
    vp_rotations_cuda.launches += 1
    cuda_build.check(rc, "vertical-packing kernel")
    return acc


vp_rotations_cuda.launches = 0
