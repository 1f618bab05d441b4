"""The torch port's device mesh (parallel/mesh.py) on the CPU, in real
gloo worlds of spawned processes, against the JAX package and the
unsharded port at PARAM_DRYRUN.

The card's capture cannot run here: the graphed mesh function runs
through a stub capture that serves CPU tensors (as in
tests/test_torch_units.py), with the gloo groups taken as capturable."""

import dataclasses
import json
import multiprocessing
import os
import pathlib
import types

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import luts
from tfhe_aes_tpu_torch.ops import graphs
from tfhe_aes_tpu_torch.ops import keys as keys_mod
from tfhe_aes_tpu_torch.ops import wopbs
from tfhe_aes_tpu_torch.parallel import mesh
from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port, tiny_params
from tfhe_aes_tpu_torch.utils import profiling, serialization

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


class StubCapture:
    """Capture by recording: warm() eagerly, then the captured call once;
    its replay runs the captured call again on the static inputs, inside
    the unit, and writes the static output, as a graph's replay does."""

    def __init__(self):
        self.warmed = self.captured = 0

    def capture(self, device, warm, fn):
        self.warmed += 1
        warm()
        self.captured += 1
        output = fn()

        def replay():
            with graphs.GRAPHS.unit():
                output.copy_(fn())
        return types.SimpleNamespace(replay=replay), output


def _graphed_run(m, skeys, x):
    """The mesh function through the graph cache with a stub capture, the
    gloo groups taken as capturable, each 'mp' rank choosing its own tail
    chunks (a third of the bytes on one, a half on the other), as ranks
    whose free memory differs would: two calls, gathered; what the
    ranks agreed and what the WoPBS saw."""
    stub = StubCapture()
    graphs.GRAPHS = graphs.GraphCache(capture=stub)
    profiling.reset()               # its captures and replays from zero
    graphs.capturable = lambda group: True
    chosen = {}

    def chunk_bytes(keys, n_bytes, n_luts, nbits):
        chosen[(n_bytes, n_luts, nbits)] = max(1, n_bytes // (2 + m.mp_rank))
        return chosen[(n_bytes, n_luts, nbits)]
    wopbs.chunk_bytes = chunk_bytes
    agreed = []
    agree_min = keys_mod.ContractionShard.agree_min

    def counted(shard, n, device):
        agreed.append(n)
        return agree_min(shard, n, device)
    keys_mod.ContractionShard.agree_min = counted
    split, cuts = set(), set()
    many = wopbs._many_wopbs

    def seen(keys, byte_bits_big, lut_polys, cap):
        if keys.shard.split_batch:
            split.add(id(keys))
        cuts.add((byte_bits_big.shape[0], lut_polys.shape[1],
                  byte_bits_big.shape[1], cap))
        return many(keys, byte_bits_big, lut_polys, cap)
    wopbs._many_wopbs = seen
    fn = mesh.sharded_ctr_fn(m, skeys, N_BLOCKS, shard_bytes=True)
    wholes, n_agreed = [], []
    for _ in range(2):
        local, _ = fn(x["rks"], x["iv"], x["lut_lsb"], x["luts_rest"])
        wholes.append(mesh.gather_blocks(m, local))
        n_agreed.append(len(agreed))
    ((key, _),) = graphs.GRAPHS.graphs(skeys).items()
    return dict(
        graphed=torch.stack(wholes).numpy(), n_agreed=n_agreed,
        runs=(stub.warmed, stub.captured, graphs.GRAPHS.captures,
              graphs.GRAPHS.replays),
        caps=json.dumps(key[1][-1]), chosen=json.dumps(sorted(
            chosen.items())), cuts=json.dumps(sorted(cuts)),
        split_once=split == {id(skeys.split_batch_keys)})


def _sharded_world(out_dir):
    """dp=2 x mp=2: the sharded CTR keystream, gathered, eager and graphed,
    and the contraction-sharded many_wopbs next to the unsharded one."""
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
    eager = (graphs.capturable(m.mp_group), len(graphs.GRAPHS))
    np.savez(out_dir / f"out{rank}.npz", whole=whole.numpy(),
             wopbs_equal=torch.equal(got, want),
             chunked_equal=torch.equal(chunked, want),
             ksk_rows=skeys.ksk_limbs.shape[0],
             pfpksk_rows=skeys.pfpksk_limbs.shape[0], first=first,
             eager=eager, **_graphed_run(m, skeys, x))


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


def test_gloo_is_not_capturable_and_runs_eagerly(sharded):
    """Over gloo the mesh function never reaches the graph cache."""
    outs, _, _, _ = sharded
    for o in outs:
        assert o["eager"].tolist() == [False, 0]


def test_graphed_mesh_equals_eager_and_jax(sharded):
    """Through the graph cache (a stub capture, the groups taken as
    capturable), both calls give every rank the eager keystream, the JAX
    package's ctr_keystream word for word."""
    outs, want, _, _ = sharded
    for rank, o in enumerate(outs):
        for graphed in o["graphed"]:
            assert np.array_equal(graphed, o["whole"]), rank
            assert np.array_equal(graphed.view(np.uint64), want), rank


def test_graphed_mesh_captures_once_then_replays(sharded):
    """The first call runs a warm-up call and captures one graph, then
    replays it; the second call only replays.  agree_min runs once a
    WoPBS shape at the first call (the warm-up's first block is the
    slice's one block here: the same shapes), never in the replay."""
    outs, _, _, _ = sharded
    for o in outs:
        assert o["runs"].tolist() == [1, 1, 1, 2]
        shapes = len(json.loads(str(o["caps"])))
        assert shapes == 4
        assert o["n_agreed"].tolist() == [shapes, shapes]


def test_graphed_mesh_ranks_cut_the_same_chunks(sharded):
    """Each 'mp' rank alone would cut other tail chunks: the caps are
    agreed once, before the warm-up call, the least of the pair's; every
    WoPBS of both ranks ran under them; the split-batch keys were one
    object across the rounds and the calls."""
    outs, _, _, _ = sharded
    for dp in range(2):
        pair = outs[2 * dp:2 * dp + 2]
        caps = [dict((tuple(s), c) for s, c in json.loads(str(o["caps"])))
                for o in pair]
        chosen = [dict((tuple(s), c) for s, c in json.loads(str(o["chosen"])))
                  for o in pair]
        assert caps[0] == caps[1]
        assert caps[0] == {s: min(c[s] for c in chosen) for s in caps[0]}
        assert any(chosen[0][s] != caps[0][s] for s in caps[0])
        for o in pair:
            assert {tuple(c) for c in json.loads(str(o["cuts"]))} == \
                {(*s, c) for s, c in caps[0].items()}
            assert o["split_once"]


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
