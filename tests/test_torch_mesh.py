"""The torch port's device mesh (parallel/mesh.py) on the CPU, in real
gloo worlds of spawned processes, against the JAX package and the
unsharded port at PARAM_DRYRUN."""

import dataclasses
import json
import multiprocessing
import os
import pathlib

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import luts
from tfhe_aes_tpu_torch.ops import keys as keys_mod
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.parallel import mesh
from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port, tiny_params
from tfhe_aes_tpu_torch.utils import serialization

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0xFF        # block 1 = 0x100: the counter add carries into byte 14
N_BLOCKS = 2
BYTES = (0x00, 0x5A, 0x99, 0xFF)


def _spawn_world(target, world: int, out_dir: pathlib.Path):
    """Start `world` spawned ranks of target(out_dir) in one gloo world."""
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world, port, str(out_dir)))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, timeout=240):
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, "a rank did not finish"
    assert [p.exitcode for p in procs] == [0] * len(procs)


def _rank_main(target, rank, world, port, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        target(pathlib.Path(out_dir))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _mesh_coordinates(out_dir):
    m = mesh.make_mesh(n_dp=4, n_mp=2, device="cpu")
    rank = torch.distributed.get_rank()
    (out_dir / f"{rank}.json").write_text(json.dumps(
        {"shape": m.shape, "names": m.axis_names, "dp": m.dp_rank,
         "mp": m.mp_rank, "device": str(m.device)}))


def test_make_mesh_8_ranks(tmp_path):
    _join(_spawn_world(_mesh_coordinates, 8, tmp_path))
    for rank in range(8):
        got = json.loads((tmp_path / f"{rank}.json").read_text())
        assert got == {"shape": [4, 2], "names": ["dp", "mp"],
                       "dp": rank // 2, "mp": rank % 2, "device": "cpu"}


def _sharded_world(out_dir):
    """dp=2 x mp=2: the sharded CTR keystream, gathered, and the
    contraction-sharded many_wopbs next to the unsharded one."""
    m = mesh.make_mesh(n_dp=2, n_mp=2, device="cpu")
    rank = torch.distributed.get_rank()
    keys = Client(tiny_params(), seed=0).make_device_keys(fast=False,
                                                          device="cpu")
    skeys = mesh.shard_keys(m, keys, shard_contractions=True)
    x = {k: torch.from_numpy(v)
         for k, v in np.load(out_dir / "in.npz").items()}

    want = wopbs.many_wopbs(keys, x["bytes"], x["lut"])
    got = wopbs.many_wopbs(skeys, x["bytes"], x["lut"])
    # Each mp rank asks for its own tail chunk (1 or 3 of the 4 bytes), as
    # ranks whose free memory differs would: they must still cut alike.
    chunked = wopbs.many_wopbs(skeys, x["bytes"], x["lut"],
                               vp_chunk=1 + 2 * m.mp_rank)
    fn = mesh.sharded_ctr_fn(m, skeys, N_BLOCKS, shard_bytes=True)
    local, first = fn(x["rks"], x["iv"], x["lut_lsb"], x["luts_rest"])
    whole = mesh.gather_blocks(m, local)
    np.savez(out_dir / f"out{rank}.npz", whole=whole.numpy(),
             wopbs_equal=torch.equal(got, want),
             chunked_equal=torch.equal(chunked, want),
             ksk_rows=skeys.ksk_limbs.shape[0],
             pfpksk_rows=skeys.pfpksk_limbs.shape[0], first=first)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(rank outputs, JAX keystream, JAX client, unsharded key rows)."""
    import jax.numpy as jnp
    from tfhe_aes_tpu.client.client import Client as JaxClient
    from tfhe_aes_tpu.models import aes_plain
    from tfhe_aes_tpu.models import fhe_aes as jaes

    out_dir = tmp_path_factory.mktemp("mesh")
    tiny = tiny_params()
    jc = JaxClient(tiny, seed=0)
    jd = jc.make_device_keys(fast=False)
    rks = np.stack([np.stack([jc.encrypt_byte(b) for b in rk]) for rk in
                    aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))])
    enc_iv = jc.encrypt_u128(IV)
    lut_lsb, luts_rest = jaes.add_scalar_luts(tiny,
                                              jaes.counter_bytes(N_BLOCKS))
    table = np.arange(256, dtype=np.uint64)[::-1].copy()
    np.savez(out_dir / "in.npz", **{
        k: np.ascontiguousarray(v, np.uint64).view(np.int64) for k, v in {
            "rks": rks, "iv": enc_iv, "lut_lsb": lut_lsb,
            "luts_rest": luts_rest,
            "bytes": np.stack([jc.encrypt_byte(b) for b in BYTES]),
            "lut": luts.lut_polys_from_tables(tiny, table[None], 8)}.items()})
    procs = _spawn_world(_sharded_world, 4, out_dir)
    try:
        want = np.asarray(jaes.ctr_keystream(jd, jnp.asarray(rks),
                                             jnp.asarray(enc_iv), N_BLOCKS))
    finally:
        _join(procs)
    outs = [dict(np.load(out_dir / f"out{r}.npz")) for r in range(4)]
    return outs, want, jc, (jd.ksk_limbs.shape[0], jd.pfpksk_limbs.shape[0])


def test_sharded_ctr_equals_jax(sharded):
    """dp=2 x mp=2, contraction rows and bytes sharded: every rank's
    gathered keystream equals the JAX package's ctr_keystream."""
    outs, want, _, _ = sharded
    for rank, o in enumerate(outs):
        assert o["first"] == (rank // 2) * (N_BLOCKS // 2)
        assert np.array_equal(o["whole"].view(np.uint64), want), rank


def test_sharded_ctr_decrypts_to_aes(sharded):
    outs, _, jc, _ = sharded
    jc.decrypt_and_verify_ctr(outs[0]["whole"].view(np.uint64), KEY, IV)


def test_contraction_sharded_wopbs_equals_unsharded(sharded):
    outs, _, _, (ksk_rows, pfpksk_rows) = sharded
    for o in outs:
        assert o["wopbs_equal"]
        assert o["ksk_rows"] < ksk_rows
        assert o["pfpksk_rows"] < pfpksk_rows
    # The mp pair of a dp row holds every row between them.
    assert outs[0]["ksk_rows"] + outs[1]["ksk_rows"] == ksk_rows
    assert outs[0]["pfpksk_rows"] + outs[1]["pfpksk_rows"] == pfpksk_rows


def test_contraction_sharded_wopbs_with_unequal_chunks(sharded):
    """The mp ranks ask for different tail chunks; they agree on one, and
    the result is still the unsharded one."""
    outs, _, _, _ = sharded
    assert all(o["chunked_equal"] for o in outs)


def test_row_share_splits_like_tensor_split():
    t = torch.arange(11 * 3).reshape(11, 3)
    got = [mesh._row_share(t, 4, r) for r in range(4)]
    assert [(s.start, s.stop) for s, _ in got] == [(0, 3), (3, 6), (6, 9),
                                                  (9, 11)]
    assert torch.equal(torch.cat([part for _, part in got]), t)


def test_save_refuses_sharded_keys(tmp_path):
    client = Client(tiny_params(), seed=0)
    keys = client.make_device_keys(fast=False, device="cpu")
    sharded_keys = dataclasses.replace(keys, shard=keys_mod.ContractionShard(
        None, slice(0, 1), slice(0, 1)))
    with pytest.raises(ValueError, match="rows"):
        serialization.save_keys(tmp_path / "k.npz", client.sk, sharded_keys)
    assert not list(tmp_path.iterdir())
