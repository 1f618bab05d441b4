"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports nothing of the
JAX package and no jax (the machine with the card has none), so run it
without the repository's conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch.backend import numpy_backend as nb
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import luts, tables
from tfhe_aes_tpu_torch.ops import (blind_rotate, cuda_blind_rotate, cuda_vp,
                                    vertical_packing, wopbs)
from tfhe_aes_tpu_torch.ops.keys import KEY_LEAVES
from tfhe_aes_tpu_torch.params import PARAM_TOY, PARAM_TOY_WIDE
from tfhe_aes_tpu_torch.utils import torus

pytestmark = pytest.mark.cuda

U64 = np.uint64
PARAM_TOY_L5 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_L5", pbs_level=5)
# (k+1) * levels = 25 > 16 GGSW rows: the kernel pads each bit to 32 rows.
PARAM_TOY_R25 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_R25",
                                    glwe_dimension=4, pbs_level=5)
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)
# k + 1 = 5 digit rows an accumulator, as PARAM_TPU: 25 accumulators a
# 128-row digit tile.
PARAM_TOY_VP_K4 = dataclasses.replace(PARAM_TOY_VP, name="PARAM_TOY_VP_K4",
                                      glwe_dimension=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(params, seed, dev):
    client = Client(params, seed=seed)
    return client, client.make_device_keys(fast=False, device=dev)


def _rotate_inputs(client, n_batch):
    p = client.params
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, n_batch).astype(U64)
    small = nb.lwe_encrypt(client.sk.lwe_key, bits << U64(63),
                           p.lwe_noise_std, rng)
    test = np.zeros((p.glwe_dimension + 1, p.polynomial_size), U64)
    test[-1, :] = U64(1) << U64(60)
    return small, test


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_L5, PARAM_TOY_WIDE,
                                    PARAM_TOY_R25], ids=lambda p: p.name)
@pytest.mark.parametrize("n_batch", [1, 9, 128])
def test_blind_rotate_kernel_matches_plain(dev, params, n_batch):
    client, k = _keys(params, 11, dev)
    small, test = _rotate_inputs(client, n_batch)
    args = (k.rplan, params, k.bsk_limbs, torus.from_u64(small, dev),
            torus.from_u64(test, dev))
    want = blind_rotate.blind_rotate_plain(*args, k.rfwd_limbs,
                                           k.rinv_crt_limbs, k.rot_table)
    got = cuda_blind_rotate.blind_rotate_cuda(*args, k.fwd_full,
                                              k.inv_crt_full, k.rot_table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_VP_TABLES = {                      # LUT stacks of the AES circuits
    "sbox_L8": lambda: tables.sbox()[None],
    "inv_sbox_L8": lambda: tables.inv_sbox()[None],
    "inv_mul_L32": lambda: np.stack([tables.gf_mul_table(c)
                                     for c in (9, 11, 13, 14)]),
}


# 5 bytes at k + 1 = 5: 40 or 160 accumulators fill neither a whole number
# of 25-accumulator groups nor of 128-row tiles of X.
@pytest.mark.parametrize("p,vals", [
    (PARAM_TOY_VP, (0x5A, 0x01, 0xFF, 0x80)),
    (PARAM_TOY_VP_K4, (0x5A, 0x01, 0xFF, 0x80, 0x33)),
], ids=lambda v: getattr(v, "name", None))
@pytest.mark.parametrize("lut_kind", sorted(_VP_TABLES))
def test_vp_kernel_matches_plain_through_wopbs(dev, monkeypatch, lut_kind, p,
                                               vals):
    client, k = _keys(p, 11, dev)
    tabs = _VP_TABLES[lut_kind]()
    lut = torus.from_u64(luts.lut_polys_from_tables(p, tabs, 8), dev)
    cts = torus.from_u64(np.stack([client.encrypt_byte(b) for b in vals]), dev)
    before = cuda_vp.vp_rotations_cuda.launches
    got = wopbs.many_wopbs(k, cts, lut)
    assert cuda_vp.vp_rotations_cuda.launches == before + 1

    monkeypatch.setattr(vertical_packing, "vp_rotations",
                        vertical_packing.vp_rotations_plain)
    want = wopbs.many_wopbs(k, cts, lut)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = torus.to_u64(got)
    for bi, b in enumerate(vals):
        for t, tab in enumerate(tabs):
            val = sum(int(client.decrypt_bits(out[bi, 8 * t + ob])) << ob
                      for ob in range(8))
            assert val == int(tab[b])


@pytest.mark.parametrize("params,n_bytes,n_luts", [
    (PARAM_TOY_VP, 7, 9),       # 63 accumulators: groups of 42 and 21
    (PARAM_TOY_VP_K4, 5, 9),    # 45 accumulators: groups of 25 and 20
    (PARAM_TOY_VP_K4, 3, 24),   # 72 accumulators, 24 outputs a byte
    (PARAM_TOY_VP_K4, 11, 8),   # a digit tile's group spans 5 bytes
], ids=lambda v: getattr(v, "name", str(v)))
def test_vp_kernel_matches_plain_at_ragged_shapes(dev, params, n_bytes,
                                                  n_luts):
    """Random accumulators and balanced GGSW residues at byte and LUT counts
    that leave a ragged group of accumulators and a ragged tile of X."""
    _, k = _keys(params, 11, dev)
    kp1, n, nbits = params.glwe_dimension + 1, params.polynomial_size, 7
    assert n_bytes * n_luts % cuda_vp.group_size(kp1)
    assert n_bytes * n_luts * kp1 % cuda_vp.TILE_ROWS
    rng = np.random.default_rng(n_bytes * n_luts)
    acc = torus.from_u64(rng.integers(
        0, 1 << 64, (n_bytes, n_luts, kp1, n), dtype=np.uint64), dev)
    ggsw = torch.stack([torch.from_numpy(rng.integers(
        -(q - 1) // 2, (q - 1) // 2 + 1, (nbits, n_bytes, kp1, kp1, n)
    ).astype(np.int32)) for q in k.plan.primes], dim=1).to(dev)
    want = vertical_packing.vp_rotations_plain(k, acc, ggsw)
    got = cuda_vp.vp_rotations_cuda(k, acc, ggsw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fast_keygen_on_the_card_equals_the_cpu(dev):
    """Device keygen with its products and staging on the card gives the
    CPU's keys, leaf by leaf."""
    want = Client(PARAM_TOY, seed=11).make_device_keys(fast=True,
                                                       device="cpu")
    got = Client(PARAM_TOY, seed=11).make_device_keys(fast=True, device=dev)
    for name in KEY_LEAVES:
        leaf = getattr(got, name)
        assert leaf.is_cuda, name
        assert torch.equal(leaf.cpu(), getattr(want, name)), name
