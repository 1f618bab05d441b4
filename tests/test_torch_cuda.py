"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports nothing of the
JAX package and no jax (the machine with the card has none), so run it
without the repository's conftest:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections
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
from tfhe_aes_tpu_torch.utils import profiling, torus

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


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _last_split_batch(params, n_primes, sm_count) -> int:
    """The largest batch whose K2 runs as clusters on this card."""
    n = 1
    while cuda_blind_rotate.k2_cluster(params, n + 1, n_primes,
                                       sm_count) > 1:
        n += 1
    return n


def _last_tiled_batch(params, n_primes, sm_count) -> int:
    """The largest batch whose K1 runs one block a tile on this card."""
    n = 1
    while not cuda_blind_rotate.k1_persistent(params, n + 1, n_primes,
                                              sm_count):
        n += 1
    return n


def _persistent_calls(params, runs: dict, n_primes, sm_count) -> int:
    """The rotate calls of WoPBS runs {(bytes, luts, bits): count} (one a
    cbs level, bytes x bits LWE bits each) whose K1 runs persistently."""
    return sum(count * params.cbs_level * cuda_blind_rotate.k1_persistent(
        params, n_bytes * bits, n_primes, sm_count)
        for (n_bytes, _, bits), count in runs.items())


def _replay_adds(graph, before) -> bool:
    """Whether the store grew by the graph's record and its unit's replay
    since `before` (a copy of profiling.COUNTS), and by nothing else."""
    return profiling.COUNTS - before == graph.record.counts + \
        collections.Counter({("unit", graph.name, "replays"): 1})


def _rotate_matches_plain(dev, params, k, client, n_batch):
    """The kernel's words equal the plain version's, and the call counts as
    split iff k2_cluster says so, as persistent iff k1_persistent does."""
    small, test = _rotate_inputs(client, n_batch)
    args = (k.rplan, params, k.bsk_limbs, torus.from_u64(small, dev),
            torus.from_u64(test, dev))
    want = blind_rotate.blind_rotate_plain(*args, k.rfwd_limbs,
                                           k.rinv_crt_limbs, k.rot_table)
    before = profiling.COUNTS.copy()
    got = cuda_blind_rotate.blind_rotate_cuda(*args, k.fwd_full,
                                              k.inv_crt_full, k.rot_table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    split = cuda_blind_rotate.k2_cluster(params, n_batch, k.rplan.n_primes,
                                         _sm_count(dev)) > 1
    persistent = cuda_blind_rotate.k1_persistent(
        params, n_batch, k.rplan.n_primes, _sm_count(dev))
    assert profiling.COUNTS - before == collections.Counter(
        {"rotate_calls": 1, "rotate_split_calls": int(split),
         "rotate_persistent_calls": int(persistent)})
    return split


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_L5, PARAM_TOY_WIDE,
                                    PARAM_TOY_R25], ids=lambda p: p.name)
@pytest.mark.parametrize("n_batch", [1, 9, 128, "last split", "first unsplit",
                                     "last non-persistent",
                                     "first persistent"])
def test_blind_rotate_kernel_matches_plain(dev, params, n_batch):
    """Both K2 paths: the small batches and the largest batch of the
    card's rule run split (a cluster of one block a prime a tile), the
    next batch one block a tile.  Both K1 paths: the largest batch of one
    block a tile and the next, K1 persistent (k1_persistent)."""
    client, k = _keys(params, 11, dev)
    sms, primes = _sm_count(dev), k.rplan.n_primes
    if n_batch in ("last split", "first unsplit"):
        last = _last_split_batch(params, primes, sms)
        n_batch = last if n_batch == "last split" else last + 1
    elif isinstance(n_batch, str):
        last = _last_tiled_batch(params, primes, sms)
        n_batch = last if n_batch == "last non-persistent" else last + 1
        assert cuda_blind_rotate.k1_persistent(params, n_batch, primes,
                                               sms) == (n_batch > last)
    split = _rotate_matches_plain(dev, params, k, client, n_batch)
    assert split == (n_batch <= _last_split_batch(params, primes, sms))


def test_blind_rotate_kernel_matches_plain_at_param_opt_split(dev):
    """PARAM_OPT (25 GGSW rows, 8-bit digits) at 9 bits, the ripple add's
    batch of a one-block session: K2 as clusters, on the keys of
    chip_smoke.py's kernel phase (device keygen, seed 0)."""
    from tfhe_aes_tpu_torch.params import PARAM_OPT
    client = Client(PARAM_OPT, seed=0)
    k = client.make_device_keys(fast=True, device=dev)
    assert _rotate_matches_plain(dev, PARAM_OPT, k, client, 9)


@pytest.mark.parametrize("set_name,n_batch", [("PARAM_OPT", 512),
                                              ("PARAM_OPT", 2048),
                                              ("PARAM_TPU", 1024)])
def test_blind_rotate_kernel_matches_plain_at_bulk_batches(dev, set_name,
                                                           n_batch):
    """A bulk batch on device keys from seed 0: PARAM_OPT at 512 bits (a
    4-block CTR round) and 2048 bits (a 16-block round: K2's 1280 tiles,
    almost five times what the card holds at once) runs K1 persistently;
    PARAM_TPU at 1024 bits (its two-limb digits make a 128 KB forward
    slice, which leaves no room for the ring) one block a tile."""
    from tfhe_aes_tpu_torch import params as param_sets
    params = getattr(param_sets, set_name)
    client = Client(params, seed=0)
    k = client.make_device_keys(fast=True, device=dev)
    persistent = cuda_blind_rotate.k1_persistent(
        params, n_batch, k.rplan.n_primes, _sm_count(dev))
    assert persistent == (set_name == "PARAM_OPT")
    assert not _rotate_matches_plain(dev, params, k, client, n_batch)


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
    before = profiling.COUNTS["vp_calls"]
    got = wopbs.many_wopbs(k, cts, lut)
    assert profiling.COUNTS["vp_calls"] == before + 1

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


def test_warmup_leaves_nothing_to_build(dev, monkeypatch):
    """After the warm-up's join(), a key expansion on real keys runs no
    nvcc and builds no tile: the libraries are loaded and the real keys'
    constant leaves are the warm-up's, with their tiles."""
    from tfhe_aes_tpu_torch.models import fhe_aes
    from tfhe_aes_tpu_torch.ops import cuda_build, graphs
    from tfhe_aes_tpu_torch.utils import device as device_mod, warmup

    graphs.GRAPHS.clear()               # their graphs read the constants
    cuda_build._libs.clear()
    cuda_build._derived.clear()
    device_mod._constants.clear()
    warm = warmup.precompile(PARAM_TOY_VP, 1, device=dev)
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    report = warm.join()
    assert {"tiles", "zero_key_wopbs", "nvcc_blind_rotate",
            "nvcc_blind_rotate_k1", "nvcc_vertical_packing",
            "nvcc_marks"} <= set(report), report
    assert set(cuda_build._libs) == {"blind_rotate", "blind_rotate_k1",
                                     "vertical_packing", "marks"}

    built = []

    def no_nvcc():
        built.append("nvcc")
        raise AssertionError("nvcc after the warm-up")

    derived = cuda_build.derived

    def spy(leaf, what, build):
        return derived(leaf, what, lambda m: built.append(what) or build(m))
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "derived", spy)
    before = profiling.COUNTS.copy()
    enc_key = torus.from_u64(client.encrypt_u128(0x2B7E1516), dev)
    rks = fhe_aes.aes_key_expansion(k, enc_key)
    torch.cuda.synchronize()
    assert built == []
    added = profiling.COUNTS - before
    assert added["rotate_calls"] > 0 and added["vp_calls"] > 0
    assert tuple(rks.shape) == (11,) + tuple(enc_key.shape)


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_VP, PARAM_TOY_VP_K4],
                         ids=lambda p: p.name)
def test_graphed_wopbs_equals_eager_and_replays_count(dev, params):
    """many_wopbs_jit: the first call captures, a replay on other inputs
    gives the eager words, and adds the launches its graph holds (the
    rotate once a cbs level; VP once at cbs_level 1, none at 2)."""
    from tfhe_aes_tpu_torch.ops import graphs
    client, k = _keys(params, 11, dev)
    lut = torus.from_u64(luts.lut_polys_from_tables(
        params, tables.sbox()[None], 8), dev)
    runs = [torus.from_u64(np.stack([client.encrypt_byte(b) for b in vals]),
                           dev) for vals in ((0x5A, 0x01, 0xFF),
                                             (0x00, 0x80, 0x33))]
    first = wopbs.many_wopbs_jit(k, runs[0], lut)
    (graph,) = graphs.GRAPHS.graphs(k).values()
    # A toy rotate's K2 runs split (clusters of one block a prime), its K1
    # (24 bits: 30 tiles) one block a tile.
    assert _persistent_calls(params, {(3, 1, 8): 1}, k.rplan.n_primes,
                             _sm_count(dev)) == 0
    assert graph.record.counts == collections.Counter({
        "rotate_calls": params.cbs_level,
        "vp_calls": int(params.cbs_level == 1),
        "mark_launches": len(graph.record.labels),
        "rotate_split_calls": params.cbs_level, ("wopbs", 3, 8, 8): 1})
    before = profiling.COUNTS.copy()
    second = wopbs.many_wopbs_jit(k, runs[1], lut)
    assert _replay_adds(graph, before)
    again = wopbs.many_wopbs_jit(k, runs[0], lut)
    torch.cuda.synchronize()
    for cts, got in zip(runs + runs[:1], (first, second, again)):
        assert torch.equal(got, wopbs.many_wopbs(k, cts, lut))
    assert torch.equal(first, again)
    out = torus.to_u64(second)
    assert [client.decrypt_byte(out[i]) for i in range(3)] == \
        [int(tables.sbox()[v]) for v in (0x00, 0x80, 0x33)]


def test_graphed_key_expansions_equal_eager(dev, monkeypatch):
    """The staged key expansion (11 replays of one graph) and the pk-RCON
    schedule (two graphs, three shapes) against the same schedules with
    every WoPBS eager, at a cbs_level=1 toy set."""
    from tfhe_aes_tpu_torch.models import fhe_aes
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    enc_key = torus.from_u64(client.encrypt_u128(0x2B7E1516), dev)
    rcon = torus.from_u64(client.make_public_key().encrypt_bits(
        np.stack([np.array([(int(r) >> j) & 1 for j in range(8)], U64)
                  for r in tables.RCON]), np.random.default_rng(3)), dev)
    graphed = (fhe_aes.aes_key_expansion_staged(k, enc_key),
               fhe_aes.aes_key_expansion(k, enc_key, rcon))
    monkeypatch.setattr(wopbs, "many_wopbs_jit", wopbs.many_wopbs)
    eager = (fhe_aes.aes_key_expansion(k, enc_key),
             fhe_aes.aes_key_expansion(k, enc_key, rcon))
    torch.cuda.synchronize()
    for got, want in zip(graphed, eager):
        assert torch.equal(got, want)


def test_a_capture_after_every_graph_died_opens_a_new_pool(dev):
    """Once the key sets of every graph of a device's pool are gone,
    PyTorch releases the pool; the next capture must not reuse its
    handle."""
    import gc
    from tfhe_aes_tpu_torch.ops import graphs
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    lut = torus.from_u64(luts.lut_polys_from_tables(
        PARAM_TOY_VP, tables.sbox()[None], 8), dev)
    cts = torus.from_u64(np.stack([client.encrypt_byte(0x42)]), dev)
    want = wopbs.many_wopbs(k, cts, lut)
    for _ in range(2):
        graphs.GRAPHS.clear()
        gc.collect()
        fresh = k.to(dev)                   # another owner, the same leaves
        wopbs.many_wopbs_jit(fresh, cts, lut)
        got = wopbs.many_wopbs_jit(fresh, cts, lut)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        del fresh, got


def _big_unit(owner, x):
    """A unit whose intermediate takes 1 GiB, whatever its input's shape."""
    tmp = torch.ones(1 << 30, dtype=torch.uint8, device=x.device)
    return x + tmp[:x.numel()].sum()


def _small_warm(owner, x):
    """A warm-up call with nothing to prepare."""
    return x + 1


def test_a_new_shapes_first_call_reuses_the_graph_pool(dev):
    """Beside a graph whose intermediates the pool holds between replays,
    a new shape's first call (a small warm-up, its capture and its first
    replay) takes that memory again instead of as much beside it."""
    from tfhe_aes_tpu_torch.ops import graphs
    class Owner:
        """A stand-in for a key set."""
    cache, owner = graphs.GraphCache(), Owner()
    profiling.reset()                   # its captures and replays from zero
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    for n in (16, 32):
        x = torch.zeros(n, dtype=torch.int64, device=dev)
        for _ in range(2):
            assert torch.equal(cache(_big_unit, owner, (x,),
                                     warm=_small_warm), x + n)
    torch.cuda.synchronize()
    assert cache.captures == 2 and cache.replays == 4
    grew = torch.cuda.max_memory_reserved() - base
    assert (1 << 30) <= grew < (3 << 29), grew / 2**30


def test_an_earlier_eager_run_does_not_change_the_chunk_cap(dev):
    """The WoPBS chunk cap counts the allocator's cached blocks as
    available: an eager run that leaves a quarter of the card cached does
    not change it, so a graph captured after it cuts the eager chunks."""
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    many = 1 << 40                      # bytes: the memory decides
    torch.cuda.synchronize()
    before = wopbs.chunk_bytes(k, many, 24, 8)
    free, total = torch.cuda.mem_get_info(dev)
    tmp = torch.ones(total // 4, dtype=torch.uint8, device=dev)
    del tmp
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved(dev) - \
        torch.cuda.memory_allocated(dev) >= total // 4
    after = wopbs.chunk_bytes(k, many, 24, 8)
    torch.cuda.empty_cache()
    assert abs(after - before) <= before // 100, (before, after)


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_VP],
                         ids=lambda p: p.name)
def test_a_graphs_kernel_nodes_are_the_launches_it_counts(dev, params,
                                                          monkeypatch,
                                                          tmp_path):
    """The kernel nodes of a captured WoPBS (its DOT dump) are the
    launches its replays add: a decomposition and n steps of K1 and K2 a
    rotate call, three VP kernels a rotated selector bit (min(8, log2 N))
    a VP call."""
    from tfhe_aes_tpu_torch.ops import graphs
    monkeypatch.setattr(graphs.GRAPHS.cuda, "keep", True)
    client, k = _keys(params, 11, dev)
    lut = torus.from_u64(luts.lut_polys_from_tables(
        params, tables.sbox()[None], 8), dev)
    cts = torus.from_u64(np.stack([client.encrypt_byte(b) for b in (7, 9)]),
                         dev)
    wopbs.many_wopbs_jit(k, cts, lut)
    (graph,) = graphs.GRAPHS.graphs(k).values()
    nodes = graphs.kernel_nodes(graph, tmp_path / "graph.dot")
    counts = graph.record.counts
    rot, vp, marks, split, persistent = (counts[key] for key in (
        "rotate_calls", "vp_calls", "mark_launches", "rotate_split_calls",
        "rotate_persistent_calls"))
    assert split == rot                 # toy batches: K2 runs split
    assert persistent == 0              # and K1 (16 bits) one block a tile
    n, bits = params.lwe_dimension, min(8, params.log2_poly_size)
    want = {"br_decompose_kernel": rot, "br_forward_mac_kernel": n * rot,
            "br_forward_mac_kernel_persistent": n * persistent,
            "br_inverse_crt_kernel": n * rot,
            "br_inverse_crt_kernelILb1E": n * split,    # the split K2
            "vp_digits_kernel": bits * vp,
            "vp_forward_mac_kernel": bits * vp,
            "vp_inverse_crt_kernel": bits * vp, "tfhe_mark": marks}
    assert {name: sum(c for f, c in nodes.items() if name in f)
            for name in want} == want
    assert rot == params.cbs_level and vp == int(params.cbs_level == 1)
    assert marks == len(graph.record.labels) == 5       # one chunk


def _unit_cases(client, dev, aes_plain, fhe_aes):
    """unit label -> (the unit, the function it graphs, static keywords,
    its arguments on inputs A and on inputs B), 2 blocks at most."""
    p = client.params

    def u64(x):
        return torus.from_u64(x, dev)
    sched = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(0x2B7E1516))
    rks = u64(np.stack([np.stack([client.encrypt_byte(b) for b in rk])
                        for rk in sched]))
    iv = u64(client.encrypt_u128(0x1FF))
    states = {s: u64(np.stack([client.encrypt_u128(v + 0x33 * i)
                               for i in range(2)])) for s, v in
              (("A", 7), ("B", 9))}
    lut = {s: tuple(u64(t) for t in fhe_aes.add_scalar_luts(
        p, fhe_aes.counter_bytes(2, off))) for s, off in (("A", 1),
                                                          ("B", 0x101))}
    keys = {s: u64(client.encrypt_u128(k)) for s, k in (("A", 5), ("B", 6))}
    rcon = u64(client.make_public_key().encrypt_bits(
        np.stack([np.array([(int(r) >> j) & 1 for j in range(8)], U64)
                  for r in tables.RCON]), np.random.default_rng(3)))
    return {
        "add_scalar_device_jit": (fhe_aes.add_scalar_device, {},
                                  lambda s: (states[s], *lut[s])),
        "ctr_step_jit": (fhe_aes.ctr_step, {},
                         lambda s: (rks, iv, *lut[s])),
        "aes_encrypt_jit": (fhe_aes.aes_encrypt, {},
                            lambda s: (rks, states[s])),
        "aes_decrypt_jit": (fhe_aes.aes_decrypt, {},
                            lambda s: (rks, states[s])),
        "aes_key_expansion_jit": (fhe_aes.aes_key_expansion, {},
                                  lambda s: (keys[s],)),
        "aes_key_expansion_jit pk-RCON": (fhe_aes.aes_key_expansion,
                                          {"rcon_fresh": True},
                                          lambda s: (keys[s], rcon)),
    }


@pytest.mark.parametrize("label", [
    "add_scalar_device_jit", "ctr_step_jit", "aes_encrypt_jit",
    "aes_decrypt_jit", "aes_key_expansion_jit",
    "aes_key_expansion_jit pk-RCON"])
def test_graphed_unit_equals_eager_and_counts_its_launches(dev, label,
                                                           monkeypatch,
                                                           tmp_path):
    """Each whole-function unit at a cbs_level=1 toy set: its first call
    (a warm-up call on the first block or round, the capture, a replay)
    and a replay on other inputs give the words of the function run
    eagerly; its graph holds one rotate and one VP call a WoPBS, equal to
    its kernel nodes (DOT dump), and a replay adds them to the counts."""
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs
    monkeypatch.setattr(graphs.GRAPHS.cuda, "keep", True)
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    plain, kw, args = _unit_cases(client, dev, aes_plain, fhe_aes)[label]
    unit = getattr(fhe_aes, label.split()[0])
    with monkeypatch.context() as m:
        m.setattr(wopbs, "many_wopbs_jit", wopbs.many_wopbs)
        want = {s: plain(k, *args(s), **kw) for s in "AB"}
    first = unit(k, *args("B"), **kw)
    ((key, graph),) = graphs.GRAPHS.graphs(k).items()
    before = profiling.COUNTS.copy()
    second = unit(k, *args("A"), **kw)
    assert _replay_adds(graph, before)
    torch.cuda.synchronize()
    assert torch.equal(first, want["B"]) and torch.equal(second, want["A"])
    static = key[1]
    runs = key[0].wopbs(*graph.inputs, *static[:-1])
    n_wopbs = sum(runs.values())
    # K2 runs split at these batches; K1 persistently from 4 tiles an SM
    # (the rounds' 256 bits: 320 tiles, one block a tile on a 132-SM card).
    counts = graph.record.counts
    persistent = _persistent_calls(PARAM_TOY_VP, runs, k.rplan.n_primes,
                                   _sm_count(dev))
    assert {key: counts[key] for key in (
        "rotate_calls", "vp_calls", "mark_launches", "rotate_split_calls",
        "rotate_persistent_calls")} == {
        "rotate_calls": n_wopbs, "vp_calls": n_wopbs,
        "mark_launches": len(graph.record.labels),
        "rotate_split_calls": n_wopbs, "rotate_persistent_calls": persistent}
    assert profiling.tagged("wopbs", counts) == {
        ("wopbs", *shape): c for shape, c in runs.items()}
    assert all(cap >= shape[0] for shape, cap in static[-1])  # one chunk
    nodes = graphs.kernel_nodes(graph, tmp_path / "graph.dot")
    bits = sum(c * min(s[2], PARAM_TOY_VP.log2_poly_size)
               for s, c in runs.items())
    n = PARAM_TOY_VP.lwe_dimension
    want_nodes = {"br_decompose_kernel": n_wopbs,
                  "br_forward_mac_kernel": n * n_wopbs,
                  "br_forward_mac_kernel_persistent": n * persistent,
                  "br_inverse_crt_kernel": n * n_wopbs,
                  "vp_digits_kernel": bits, "vp_forward_mac_kernel": bits,
                  "vp_inverse_crt_kernel": bits,
                  "tfhe_mark": len(graph.record.labels)}
    assert {name: sum(c for f, c in nodes.items() if name in f)
            for name in want_nodes} == want_nodes


def test_one_rank_nccl_mesh_is_one_graph_equal_to_ctr_keystream(
        dev, monkeypatch, tmp_path):
    """parallel/mesh.sharded_ctr_fn on a one-rank NCCL world, dp=1 x mp=1,
    contraction rows and bytes sharded, at a cbs_level=1 toy set: its
    first call captures one graph of the CTR unit, a second call on other
    counters replays it, both equal to ctr_keystream word for word; a
    replay adds the graph's launches, one rotate and one VP call a WoPBS;
    the graph holds the ten byte all-gathers, each a copy NCCL makes."""
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs
    from tfhe_aes_tpu_torch.parallel import mesh
    from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port
    monkeypatch.setattr(graphs.GRAPHS.cuda, "keep", True)
    for name, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                            MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(name, value)
    p, n = PARAM_TOY_VP, 2
    client, keys = _keys(p, 11, dev)
    rks = torus.from_u64(np.stack([
        np.stack([client.encrypt_byte(b) for b in rk]) for rk in
        aes_plain.key_expansion(aes_plain.u128_to_bytes_be(0x2B7E1516))]),
        dev)
    iv = torus.from_u64(client.encrypt_u128(0xFF), dev)
    offsets = {"A": 0, "B": 0x1FE}
    lut = {s: tuple(torus.from_u64(t) for t in fhe_aes.add_scalar_luts(
        p, fhe_aes.counter_bytes(n, off))) for s, off in offsets.items()}
    want = {s: fhe_aes.ctr_keystream(keys, rks, iv, n, off)
            for s, off in offsets.items()}
    m = mesh.make_mesh(n_dp=1, n_mp=1)
    try:
        assert graphs.capturable(m.mp_group)
        skeys = mesh.shard_keys(m, keys, shard_contractions=True)
        fn = mesh.sharded_ctr_fn(m, skeys, n, shard_bytes=True)
        captures, replays = graphs.GRAPHS.captures, graphs.GRAPHS.replays
        first, lo = fn(rks, iv, *lut["B"])
        ((key, graph),) = graphs.GRAPHS.graphs(skeys).items()
        before = profiling.COUNTS.copy()
        second, _ = fn(rks, iv, *lut["A"])
        assert _replay_adds(graph, before)
        assert (graphs.GRAPHS.captures - captures,
                graphs.GRAPHS.replays - replays) == (1, 2)
        torch.cuda.synchronize()
        assert lo == 0
        assert torch.equal(first, want["B"]) and torch.equal(second,
                                                             want["A"])
        assert key[0] is fhe_aes._CTR_STEP and key[1][0] is m.mp_group
        n_wopbs = sum(key[0].wopbs(*graph.inputs, *key[1][:-1]).values())
        counts = graph.record.counts
        assert (counts["rotate_calls"], counts["vp_calls"]) == \
            (n_wopbs, n_wopbs) == (26, 26)
        copies = graphs.memcpy_nodes(graph, tmp_path / "graph.dot")
        big1 = p.big_lwe_dimension + 1
        assert {L: copies[("default (DEVICE to DEVICE)",
                           16 * n * L * big1 * 8)] for L in (24, 8)} == \
            {24: 9, 8: 1}
    finally:
        torch.distributed.destroy_process_group()


# -- device marks (utils/profiling.py) ----------------------------------------

def _ctr_args(client, dev, fhe_aes, aes_plain, offset):
    p = client.params
    sched = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(0x2B7E1516))
    rks = torus.from_u64(np.stack([np.stack([client.encrypt_byte(b)
                                             for b in rk])
                                   for rk in sched]), dev)
    iv = torus.from_u64(client.encrypt_u128(0x1FF), dev)
    lut = tuple(torus.from_u64(t, dev) for t in fhe_aes.add_scalar_luts(
        p, fhe_aes.counter_bytes(2, offset)))
    return rks, iv, lut


def test_replayed_marks_decode_in_order_and_leave_the_keystream(
        dev, monkeypatch):
    """ctr_step_jit at 2 blocks, traced over two replays: each replay's
    marks decode to its own ordered stamps, the second's after the
    first's; ctr_step holds ripple_add (16 WoPBS) then aes_rounds (10),
    which together take no more than it; and the words are those of
    ctr_step run eagerly with no mark at all."""
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    rks, iv, lut = {}, {}, {}
    for s, off in (("A", 1), ("B", 0x101)):
        rks[s], iv[s], lut[s] = _ctr_args(client, dev, fhe_aes, aes_plain,
                                          off)
    with monkeypatch.context() as m:
        m.setattr(wopbs, "many_wopbs_jit", wopbs.many_wopbs)
        m.setattr(profiling, "mark", lambda *a, **kw: None)
        want = {s: fhe_aes.ctr_step(k, rks[s], iv[s], *lut[s]) for s in "AB"}
    fhe_aes.ctr_step_jit(k, rks["A"], iv["A"], *lut["A"])   # the capture
    ((_, graph),) = graphs.GRAPHS.graphs(k).items()
    labels = graph.record.labels
    assert labels[0] == "|ctr_step,ripple_add"
    assert labels[-1] == "aes_rounds,ctr_step|"
    assert len(labels) == 3 + 5 * 26 == graph.record.counts["mark_launches"]
    profiling.reset()
    profiling.enable()
    try:
        got = {s: fhe_aes.ctr_step_jit(k, rks[s], iv[s], *lut[s])
               for s in "BA"}
    finally:
        profiling.disable()
    torch.cuda.synchronize()
    for s in "AB":
        assert torch.equal(got[s], want[s])
    rep = profiling.report()
    assert rep["lost"] == []
    assert rep["marks_logged"] == len(rep["marks"]) == 2 * len(labels)
    stamps = [m["ns"] for m in rep["marks"]]
    assert stamps == sorted(stamps)
    n = len(labels)
    assert stamps[n - 1] <= stamps[n]        # the replays do not overlap
    spans = rep["device_spans"]
    steps = [s for s in spans if s["name"] == "ctr_step"]
    assert len(steps) == 2 and steps[0]["end_ns"] <= steps[1]["start_ns"]
    for step in steps:
        kids = [s for s in spans if s["parent"] == step["id"]]
        assert [s["name"] for s in kids] == ["ripple_add", "aes_rounds"]
        assert sum(e["end_ns"] - e["start_ns"] for e in kids) <= \
            step["end_ns"] - step["start_ns"]
        for kid, n_wopbs in zip(kids, (16, 10)):
            assert sum(s["parent"] == kid["id"] and s["name"] == "wopbs"
                       for s in spans) == n_wopbs
    assert rep["counters"]["units"]["ctr_step"]["replays"] == 2


def test_the_staged_key_expansion_is_one_device_span_of_eleven_wopbs(dev):
    """Traced, the staged key expansion (11 replays of one WoPBS graph and
    the eager work between) decodes to one key_expansion span over 11
    WoPBS, inside the server's top-level host span."""
    from tfhe_aes_tpu_torch.server import Server
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    server = Server(k)
    enc_key = torus.from_u64(client.encrypt_u128(0x2B7E1516), dev)
    server.aes_key_expansion(enc_key)                  # the capture
    profiling.reset()
    profiling.enable()
    try:
        server.aes_key_expansion(enc_key)
    finally:
        profiling.disable()
    rep = profiling.report()
    assert rep["lost"] == []
    spans = rep["device_spans"]
    (top,) = [s for s in rep["host_spans"] if s["parent"] is None]
    assert top["name"] == "aes_key_expansion"
    (kx,) = [s for s in spans if s["name"] == "key_expansion"]
    assert kx["request"] == top["id"] and kx["end_ns"] > kx["start_ns"]
    assert sum(s["name"] == "wopbs" and s["parent"] == kx["id"]
               for s in spans) == 11
    assert rep["counters"]["units"]["wopbs"]["replays"] == 11
    assert {s["name"] for s in rep["host_spans"]} >= {"glue", "copy_in",
                                                      "replay", "clone"}


def test_a_profile_holds_a_record_a_logged_mark_and_no_span_on_the_card(
        dev):
    """Under torch.profiler a replayed WoPBS's marks are MARK_KERNEL
    records, as many as the marks logged; the host spans are host records
    only, with no mirror on the card's timeline."""
    client, k = _keys(PARAM_TOY_VP, 11, dev)
    lut = torus.from_u64(luts.lut_polys_from_tables(
        PARAM_TOY_VP, tables.sbox()[None], 8), dev)
    cts = torus.from_u64(np.stack([client.encrypt_byte(b) for b in (7, 9)]),
                         dev)
    wopbs.many_wopbs_jit(k, cts, lut)                  # the capture
    profiling.reset()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("request"):
            for _ in range(2):
                wopbs.many_wopbs_jit(k, cts, lut)
        torch.cuda.synchronize()
    events = prof.events()
    rep = profiling.report()
    marks = sum(e.device_type == cuda and profiling.MARK_KERNEL in e.name
                for e in events)
    assert marks == rep["marks_logged"] == 10
    spans = {profiling.SPAN_PREFIX + name
             for name in ("request", "copy_in", "replay", "clone")}
    assert not [e.name for e in events if e.device_type == cuda
                and e.name in spans]
    assert spans <= {e.name for e in events if e.device_type != cuda}
