"""The plain versions of the two ported kernels against the JAX package (CPU).

blind_rotate_plain and vp_rotations_plain are what the CUDA kernels are
held against on the card (tests/test_torch_cuda.py, chip_smoke.py); here
they are held, word for word, against the JAX XLA path and the Pallas TPU
kernels run in interpret mode, on the same keys (keys_from_numpy) and the
same seeded inputs.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.backend import numpy_backend as nb
from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import luts, tables
from tfhe_aes_tpu.ops import blind_rotate as jbr
from tfhe_aes_tpu.ops import pallas_blind_rotate as jpbr
from tfhe_aes_tpu.ops import pallas_vp as jpvp
from tfhe_aes_tpu.ops import wopbs as jwopbs
from tfhe_aes_tpu.params import PARAM_TOY, PARAM_TOY_WIDE
from tfhe_aes_tpu_torch.ops import (blind_rotate, cbs, keys, lwe,
                                    vertical_packing, wopbs)
from tfhe_aes_tpu_torch.utils import torus

torch.set_num_threads(1)

U64 = np.uint64
PARAM_TOY_L5 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_L5", pbs_level=5)
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)


@pytest.fixture(scope="module")
def keysets():
    """params -> (JAX client, JAX DeviceKeys, port DeviceKeys), built once."""
    cache = {}

    def get(params):
        if params.name not in cache:
            jc = JaxClient(params, seed=11)
            jd = jc.make_device_keys(fast=False)
            cache[params.name] = (jc, jd, keys.keys_from_numpy(jd))
        return cache[params.name]
    return get


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_L5, PARAM_TOY_WIDE],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("n_batch", [1, 3, 9])
def test_blind_rotate_plain_equals_jax_xla_and_pallas(keysets, params,
                                                      n_batch):
    jc, jd, td = keysets(params)
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, n_batch).astype(U64)
    small = nb.lwe_encrypt(jc.sk.lwe_key, bits << U64(63),
                           params.lwe_noise_std, rng)
    test = np.zeros((params.glwe_dimension + 1, params.polynomial_size), U64)
    test[-1, :] = U64(1) << U64(60)

    want = np.asarray(jax.jit(jbr.blind_rotate, static_argnums=(0, 1))(
        jd.rplan, params, jnp.asarray(jd.bsk_limbs), jnp.asarray(small),
        jnp.asarray(test), jnp.asarray(jd.rfwd_limbs),
        jnp.asarray(jd.fwd_full), jnp.asarray(jd.rinv_crt_limbs),
        jnp.asarray(jd.inv_crt_full), jnp.asarray(jd.rot_table)))
    pallas = np.asarray(jpbr.blind_rotate_pallas(
        jd.rplan, params, jnp.asarray(jd.bsk_limbs), jnp.asarray(small),
        jnp.asarray(test), jnp.asarray(jd.fwd_full),
        jnp.asarray(jd.inv_crt_full), jnp.asarray(jd.rot_table),
        interpret=True))
    got = blind_rotate.blind_rotate_plain(
        td.rplan, params, td.bsk_limbs, torus.from_u64(small),
        torus.from_u64(test), td.rfwd_limbs, td.rinv_crt_limbs, td.rot_table)
    np.testing.assert_array_equal(torus.to_u64(got), want)
    np.testing.assert_array_equal(torus.to_u64(got), pallas)
    # and the device dispatch takes the plain version for CPU tensors
    got2 = blind_rotate.blind_rotate(
        td.rplan, params, td.bsk_limbs, torus.from_u64(small),
        torus.from_u64(test), td.rfwd_limbs, td.fwd_full, td.rinv_crt_limbs,
        td.inv_crt_full, td.rot_table)
    assert torch.equal(got2, got)


def test_vp_rotations_plain_equals_pallas_vp_through_sbox_wopbs(keysets):
    """4 bytes through extract -> CBS -> VP of the S-box at a cbs_level=1
    toy set (N=128: one CMux-tree bit, then 7 rotation bits)."""
    p = PARAM_TOY_VP
    jc, jd, td = keysets(p)
    sbox = tables.sbox()
    vals = (0x5A, 0x01, 0xFF, 0x80)
    cts = np.stack([jc.encrypt_byte(b) for b in vals])
    lut_np = luts.lut_polys_from_tables(p, sbox[None], 8)

    # The rotations' inputs, from a real circuit bootstrap through the port.
    small = wopbs.extract_bits(td, torus.from_u64(cts)).reshape(4 * 8, -1)
    g = cbs.cbs_stage_ggsw(td, cbs.cbs_pbs_levels(td, small))
    ggsw = g.reshape((g.shape[0], 4, 8) + g.shape[2:]).movedim(2, 0)
    lut = torus.from_u64(lut_np)
    acc = torch.zeros((4, 8, 2, p.glwe_dimension + 1, p.polynomial_size),
                      dtype=torch.int64)
    acc[..., -1, :] = lut.expand(4, 8, 2, p.polynomial_size)
    acc = acc[:, :, 0] + blind_rotate.external_product_ntt(
        td.plan, acc[:, :, 1] - acc[:, :, 0], ggsw[7], p.cbs_base_log,
        p.cbs_level, td.fwd_limbs, td.inv_crt_limbs)

    got = vertical_packing.vp_rotations_plain(td, acc, ggsw[:7])
    want = jpvp.vp_rotations_pallas(jd, jnp.asarray(torus.to_u64(acc)),
                                    jnp.asarray(ggsw[:7].numpy()),
                                    interpret=True)
    np.testing.assert_array_equal(torus.to_u64(got), np.asarray(want))

    # The whole port WoPBS equals the JAX one and decrypts to the S-box.
    out = torus.to_u64(wopbs.many_wopbs(td, torus.from_u64(cts),
                                        torus.from_u64(lut_np)))
    np.testing.assert_array_equal(
        out, np.asarray(jwopbs.many_wopbs(jd, jnp.asarray(cts),
                                          jnp.asarray(lut_np))))
    np.testing.assert_array_equal(out, torus.to_u64(lwe.sample_extract0(got)))
    for bi, b in enumerate(vals):
        assert sum(int(jc.decrypt_bits(out[bi, ob])) << ob
                   for ob in range(8)) == int(sbox[b])
