"""The port's compiled dispatch units (CPU): the graph cache of
ops/graphs.py, many_wopbs_jit and aes_key_expansion_staged against the JAX
package, and the constants made once a device.

The cache's bookkeeping runs through an injected stub capture: the card's
capture cannot run here.  The stub records a call, and its replay runs the
function again on the static inputs and writes the static output in
place, as a graph's replay does.
"""

import dataclasses
import gc
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.ops import wopbs as jwopbs
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes, tables
from tfhe_aes_tpu_torch.ops import (cuda_blind_rotate, cuda_vp, graphs,
                                    modular, ntt, wopbs)
from tfhe_aes_tpu_torch.ops.keys import ContractionShard
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import noise_asserts, profiling, torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)


@pytest.fixture(autouse=True)
def fresh_counts():
    """The counts of utils/profiling from zero, before and after each
    test (the graph cache's captures and replays are among them)."""
    profiling.reset()
    yield
    profiling.reset()


class StubCapture:
    """Capture by recording.  capture() runs the warm-up call, then the
    captured call once (it counts into the capture's record, as the
    card's capture runs the Python body) and keeps its result as the
    static output; the graph's replay runs the captured call again on the
    static inputs and writes the static output in place."""

    def __init__(self, fail=False):
        self.fail = fail
        self.eager = self.captured = 0

    def capture(self, device, warm, fn):
        self.eager += 1
        warm()
        self.captured += 1
        output = fn()
        if self.fail:
            raise RuntimeError("capture refused")
        return types.SimpleNamespace(
            replay=lambda: output.copy_(fn())), output


class Owner:
    """A stand-in for a key set: weakly referenceable."""


def _affine(owner, x, y, scale):
    """A unit that launches its owner's 'kernel' a twice and b once."""
    a, b = owner.kernels
    profiling.count(a, 2)
    profiling.count(b)
    return x * scale + y.sum()


def _owner(kernels=("a", "b")):
    o = Owner()
    o.kernels = kernels
    return o


def _counts(keys=("a", "b")) -> tuple:
    return tuple(profiling.COUNTS[k] for k in keys)


def test_graph_key_is_shapes_static_arguments_and_owner():
    stub = StubCapture()
    cache = graphs.GraphCache(capture=stub)
    k1, k2 = _owner(), _owner()
    x, y = torch.arange(4), torch.arange(3)
    for _ in range(3):
        cache(_affine, k1, (x, y), (2,))
    assert (stub.eager, stub.captured, cache.captures, cache.replays) == \
        (1, 1, 1, 3)
    cache(_affine, k1, (torch.arange(5), y), (2,))        # another shape
    cache(_affine, k1, (x.to(torch.int32), y), (2,))      # another dtype
    cache(_affine, k1, (x, y), (3,))                      # another static
    cache(_affine, k2, (x, y), (2,))                      # another owner
    assert cache.captures == stub.captured == 5
    assert cache.replays == 7
    assert len(cache.graphs(k1)) == 4 and len(cache.graphs(k2)) == 1
    assert len(cache) == 2


def test_replay_copies_the_inputs_into_the_static_buffers():
    cache = graphs.GraphCache(capture=StubCapture())
    k = _owner()
    cache(_affine, k, (torch.arange(4), torch.arange(3)), (2,))
    x, y = torch.tensor([5, -1, 7, 0]), torch.tensor([1, 1, 9])
    got = cache(_affine, k, (x, y), (2,))
    assert torch.equal(got, x * 2 + 11)
    (graph,) = cache.graphs(k).values()
    assert torch.equal(graph.inputs[0], x) and torch.equal(graph.inputs[1], y)
    assert graph.inputs[0].data_ptr() != x.data_ptr()


def test_an_output_held_by_a_caller_survives_a_later_replay():
    cache = graphs.GraphCache(capture=StubCapture())
    k = _owner()
    y = torch.arange(3)
    first = cache(_affine, k, (torch.arange(4), y), (2,))
    second = cache(_affine, k, (torch.tensor([1, 2, 3, 4]), y), (2,))
    cache(_affine, k, (torch.tensor([9, 9, 9, 9]), y), (2,))
    assert torch.equal(first, torch.arange(4) * 2 + 3)
    assert torch.equal(second, torch.tensor([1, 2, 3, 4]) * 2 + 3)
    (graph,) = cache.graphs(k).values()
    assert torch.equal(graph.output, torch.tensor([9, 9, 9, 9]) * 2 + 3)


def test_a_first_call_warms_up_captures_and_replays():
    """The warm-up call runs once, eagerly, on the caller's tensors and
    static arguments, before the capture; the first result is the
    graph's."""
    stub = StubCapture()
    cache = graphs.GraphCache(capture=stub)
    k = _owner()
    seen = []

    def warm(owner, x, y, scale):
        seen.append((owner, x, scale, stub.captured))
        return x[:1] * scale
    x, y = torch.arange(4), torch.arange(3)
    for _ in range(2):
        assert torch.equal(cache(_affine, k, (x, y), (2,), warm=warm),
                           x * 2 + 3)
    assert len(seen) == 1 and seen[0][0] is k and seen[0][1] is x
    assert seen[0][2:] == (2, 0)                    # before the capture
    assert (cache.captures, cache.replays) == (1, 2)


def test_the_wopbs_warm_up_is_its_first_byte(toy):
    """many_wopbs_jit warms up on one byte: the first byte's words of the
    whole call."""
    _, _, tc, td = toy(PARAM_TOY)
    cts, lut = _sbox_inputs(tc, PARAM_TOY, (0x3A, 0x00, 0xC5))
    per_byte = lut.expand((3,) + lut.shape[1:])
    for luts in (lut, per_byte):
        np.testing.assert_array_equal(
            wopbs._one_byte(td, cts, luts, 3).numpy(),
            wopbs.many_wopbs(td, cts, luts)[:1].numpy())


def test_entries_go_when_the_owner_dies():
    cache = graphs.GraphCache(capture=StubCapture())
    k = _owner()
    cache(_affine, k, (torch.arange(4), torch.arange(3)), (2,))
    cache.memo(k, "cap", lambda: 7)
    assert len(cache) == 1
    del k
    gc.collect()
    assert len(cache) == 0


def _harness_reads(cache) -> tuple:
    """What benchmark/harness.py reads: the rotate's and VP's launches and
    the captures."""
    return (cuda_blind_rotate.blind_rotate_cuda.launches,
            cuda_vp.vp_rotations_cuda.launches, cache.captures)


@pytest.mark.parametrize("kernels", [("a", "b"),
                                     ("rotate_calls", "vp_calls")])
def test_a_replay_adds_the_launches_its_graph_holds(kernels):
    """The counts of a unit's kernels, by name; with the rotate's and VP's
    keys, the views the benchmark's harness reads follow them."""
    cache = graphs.GraphCache(capture=StubCapture())
    k = _owner(kernels)
    args = (torch.arange(4), torch.arange(3))
    cache(_affine, k, args, (2,))
    # The warm-up call and the first replay counted; the capture added
    # nothing.
    assert _counts(kernels) == (4, 2)
    (graph,) = cache.graphs(k).values()
    assert graph.record.counts == {kernels[0]: 2, kernels[1]: 1}
    harness = kernels == ("rotate_calls", "vp_calls")
    if harness:
        assert _harness_reads(cache) == (4, 2, 1)
    for n in range(1, 4):
        cache(_affine, k, args, (2,))
        assert _counts(kernels) == (4 + 2 * n, 2 + n)
        if harness:
            assert _harness_reads(cache) == (4 + 2 * n, 2 + n, 1)


def test_a_failed_capture_raises_and_keeps_no_entry():
    stub = StubCapture(fail=True)
    cache = graphs.GraphCache(capture=stub)
    k = _owner()
    with pytest.raises(RuntimeError, match="capture refused"):
        cache(_affine, k, (torch.arange(4), torch.arange(3)), (2,))
    assert cache.graphs(k) == {} and cache.captures == 0
    assert _counts() == (2, 1)      # the warm-up's alone
    assert stub.eager == 1


def test_cpu_tensors_run_eagerly_without_a_capture():
    cache = graphs.GraphCache()
    k = _owner()
    for _ in range(2):
        cache(_affine, k, (torch.arange(4), torch.arange(3)), (2,))
    assert cache.graphs(k) == {} and cache.captures == cache.replays == 0
    assert _counts() == (4, 2)


_DOT_NODE = """"graph_1_node_{i}"[style="bold" shape="record" label="{{KERNEL
| {{ID | {i} (topoId: {i}) | {name}\\<\\<\\<{{8,2}},256,1024\\>\\>\\>}}
| {{{{node handle | func handle}} | {{0x00000000 | 0x00000000}}}}
| {{cooperative | 0}}
}}"];
"""


def test_kernel_nodes_reads_the_graphs_dot_dump(tmp_path):
    """kernel_nodes counts a graph's kernel nodes by function name from
    cudaGraphDebugDotPrint's format (as the card writes it); memcpy nodes
    and edges are not kernels."""
    names = ["_ZN4tfhe19br_decompose_kernelEPKx"] + \
        ["_ZN4tfhe21br_forward_mac_kernelILi5EEEvPKa", "_ZN4tfhe21br_"
         "inverse_crt_kernelEPKi"] * 3
    text = "digraph dot {\n" + "".join(
        _DOT_NODE.format(i=i, name=n) for i, n in enumerate(names)) + \
        '"graph_1_node_9"[style="bold" shape="record" label="{MEMCPY\n' \
        '| {ID | 9 (topoId: 0)}}"];\n' \
        '"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];\n}\n'

    class Dumped:
        def debug_dump(self, path):
            with open(path, "w") as f:
                f.write(text)
    graph = graphs.Graph(Dumped(), (), torch.zeros(1), (1, 0))
    got = graphs.kernel_nodes(graph, tmp_path / "g.dot")
    assert got == {names[0]: 1, names[1]: 3, names[2]: 3}


def test_the_chunk_cap_ignores_the_allocators_cache(toy, monkeypatch):
    """On a card, chunk_bytes counts the allocator's free blocks as
    available: an earlier run that left its memory cached (less free on
    the device, as much more reserved) does not lower the cap."""
    _, _, _, td = toy(PARAM_TOY)
    card = types.SimpleNamespace(params=td.params, plan=td.plan,
                                 device=torch.device("cuda", 0))
    state = {"free": 40 << 30, "reserved": 2 << 30, "allocated": 1 << 30}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (state["free"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev: state["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev: state["allocated"])
    many = 1 << 40                      # bytes: the memory decides
    before = wopbs.chunk_bytes(card, many, 24, 8)
    state["free"] -= 30 << 30           # an eager run's cache
    state["reserved"] += 30 << 30
    assert wopbs.chunk_bytes(card, many, 24, 8) == before
    state["free"] -= 8 << 30            # live tensors do count
    state["reserved"] += 8 << 30
    state["allocated"] += 8 << 30
    assert wopbs.chunk_bytes(card, many, 24, 8) < before


# -- many_wopbs_jit ----------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """params -> (JAX client, JAX keys, port client, port keys)."""
    made = {}

    def get(params):
        if params.name not in made:
            jc = JaxClient(params, seed=11)
            tc = Client(params, seed=11)
            made[params.name] = (jc, jc.make_device_keys(fast=False), tc,
                                 tc.make_device_keys(fast=False, device="cpu"))
        return made[params.name]
    return get


def _sbox_inputs(client, params, vals):
    cts = torus.from_u64(np.stack([client.encrypt_byte(v) for v in vals]))
    lut = torus.from_u64(fhe_aes._sbox_lut(params, False))
    return cts, lut


@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_VP],
                         ids=lambda p: p.name)
def test_many_wopbs_jit_equals_many_wopbs_and_jax(toy, params):
    jc, jd, tc, td = toy(params)
    vals = (0x00, 0x9C, 0xFF)
    cts, lut = _sbox_inputs(tc, params, vals)
    got = wopbs.many_wopbs_jit(td, cts, lut)
    assert torch.equal(got, wopbs.many_wopbs(td, cts, lut))
    want = np.asarray(jwopbs.many_wopbs_jit(
        jd, jnp.asarray(torus.to_u64(cts)), jnp.asarray(torus.to_u64(lut))))
    np.testing.assert_array_equal(torus.to_u64(got), want)
    out = torus.to_u64(got)
    assert [tc.decrypt_byte(out[i]) for i in range(len(vals))] == \
        [int(tables.sbox()[v]) for v in vals]


def test_graphed_wopbs_keeps_the_eager_noise_checks(toy, monkeypatch):
    """Armed noise asserts: a call of many_wopbs_jit, captured or
    replayed, adds the eager call's checkpoints, with its tags and shapes,
    and gives its words."""
    _, _, tc, td = toy(PARAM_TOY)
    stub = StubCapture()
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache(capture=stub))
    cts, lut = _sbox_inputs(tc, PARAM_TOY, (0x11, 0xE0))
    noise_asserts.enable(tc.sk)
    try:
        want = wopbs.many_wopbs(td, cts, lut)
        eager = [(c["tag"], c["shape"]) for c in noise_asserts.checks()]
        assert [t for t, _ in eager] == ["wopbs_input", "wopbs_output"]
        outs = [wopbs.many_wopbs_jit(td, cts, lut) for _ in range(2)]
        got = [(c["tag"], c["shape"]) for c in noise_asserts.checks()]
        noise_asserts.assert_clean()
    finally:
        noise_asserts.disable()
    assert got == eager * 3
    assert (stub.captured, graphs.GRAPHS.replays) == (1, 2)
    assert all(torch.equal(o, want) for o in outs)


def test_sharded_keys_run_eagerly(toy, monkeypatch):
    """Keys with a contraction shard whose group a capture cannot hold
    (a stand-in here, gloo's in tests/test_torch_mesh.py) never reach the
    graph cache."""
    _, _, tc, td = toy(PARAM_TOY)
    cache = graphs.GraphCache(capture=StubCapture(fail=True))
    monkeypatch.setattr(graphs, "GRAPHS", cache)
    calls = []
    monkeypatch.setattr(wopbs, "many_wopbs",
                        lambda *a, **kw: calls.append(kw) or "eager")
    sharded = dataclasses.replace(td, shard=object())
    cts, lut = _sbox_inputs(tc, PARAM_TOY, (1,))
    assert wopbs.many_wopbs_jit(sharded, cts, lut, vp_chunk=3) == "eager"
    assert calls == [{"vp_chunk": 3}]
    assert len(cache) == 0 and cache.captures == 0


def test_sharded_keys_over_a_capturable_group_are_graphed(toy,
                                                          monkeypatch):
    """many_wopbs_jit on keys whose shard's group a capture can hold: one
    graph, its cap the one agreed over the group at the first call (one
    agree_min, outside the capture), never read again."""
    _, _, tc, td = toy(PARAM_TOY)
    stub = StubCapture()
    monkeypatch.setattr(graphs, "GRAPHS", graphs.GraphCache(capture=stub))
    group = object()
    monkeypatch.setattr(graphs, "capturable", lambda g: g is group)
    agreed = []
    monkeypatch.setattr(ContractionShard, "agree_min",
                        lambda shard, n, device: agreed.append(
                            (n, stub.captured)) or 1)
    cuts = []
    monkeypatch.setattr(wopbs, "_many_wopbs", lambda k, x, lut, cap: (
        cuts.append(cap), torch.zeros((x.shape[0], lut.shape[1],
                                       x.shape[-1]), dtype=torch.int64))[1])
    sharded = dataclasses.replace(td, shard=ContractionShard(
        group, slice(0, 1), slice(0, 1)))
    cts, lut = _sbox_inputs(tc, PARAM_TOY, (1, 2, 3))
    for _ in range(3):
        wopbs.many_wopbs_jit(sharded, cts, lut)
    assert agreed == [(3, 0)]           # the CPU's cap: every byte
    assert stub.captured == 1 and graphs.GRAPHS.replays == 3
    ((key, _),) = graphs.GRAPHS.graphs(sharded).items()
    assert key[1] == (1,) and set(cuts) == {1}


def test_the_chunk_cap_is_decided_once_and_keyed(toy, monkeypatch):
    """The cap comes from chunk_bytes at the first call of a shape and is
    a static argument of its graph: later calls read no free memory."""
    _, _, tc, td = toy(PARAM_TOY)
    cache = graphs.GraphCache(capture=StubCapture())
    monkeypatch.setattr(graphs, "GRAPHS", cache)
    asked = []

    def chunk_bytes(keys, n_bytes, n_luts, nbits):
        asked.append((n_bytes, n_luts, nbits))
        return 2
    monkeypatch.setattr(wopbs, "chunk_bytes", chunk_bytes)
    cts, lut = _sbox_inputs(tc, PARAM_TOY, (3, 4, 5))
    outs = [wopbs.many_wopbs_jit(td, cts, lut) for _ in range(2)]
    assert asked == [(3, 8, 8)]
    ((_, static, _),) = cache.graphs(td)
    assert static == (2,)
    assert torch.equal(outs[0], outs[1])


# -- aes_key_expansion_staged ---------------------------------------------------

def test_staged_key_expansion_equals_jax_and_the_loop(toy):
    jc, jd, tc, td = toy(PARAM_TOY)
    enc_key = jc.encrypt_u128(KEY)
    want = np.asarray(jaes.aes_key_expansion_staged(jd, jnp.asarray(enc_key)))
    t_key = torus.from_u64(enc_key)
    got = torus.to_u64(fhe_aes.aes_key_expansion_staged(td, t_key))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torus.to_u64(fhe_aes.aes_key_expansion(td, t_key)), want)
    sched = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    assert [[tc.decrypt_byte(got[r, i]) for i in range(16)]
            for r in range(11)] == sched


def test_server_trivial_schedule_is_the_staged_one(monkeypatch):
    seen = []
    monkeypatch.setattr(fhe_aes, "aes_key_expansion_staged",
                        lambda keys, k: seen.append("staged") or k)
    monkeypatch.setattr(fhe_aes, "aes_key_expansion",
                        lambda *a, **kw: seen.append("loop"))
    key = torch.zeros(3)
    assert Server(dkeys=None).aes_key_expansion(key) is key
    assert seen == ["staged"]


# -- constants made once a device ---------------------------------------------

def test_prime_constants_are_made_once_and_equal_the_old_values():
    plan = ntt.make_plan(64, q_bits=48)
    first = ntt.prime_constants(plan, "cpu")
    assert ntt.prime_constants(plan, torch.device("cpu")) is first
    p, inv, c16 = ntt._prime_consts(plan, 3, "cpu")
    assert p.shape == (plan.n_primes, 1, 1)
    assert p.data_ptr() == first[0].data_ptr()
    np.testing.assert_array_equal(p.flatten().numpy(), plan.p_i32)
    np.testing.assert_array_equal(inv.flatten().numpy(), plan.inv_f32)
    np.testing.assert_array_equal(
        c16.flatten().numpy(),
        [modular.host_balanced(1 << 16, q) for q in plan.primes])
    x = torch.arange(-5, 5, dtype=torch.int64)
    res = ntt.u64_to_residues(plan, x)
    again = ntt.u64_to_residues(plan, x)
    assert torch.equal(res, again)
    for k, q in enumerate(plan.primes):
        np.testing.assert_array_equal(
            (res[k].numpy() - x.numpy()) % q, 0)


def test_aes_tables_and_indices_are_made_once_and_equal_the_old_values():
    like = torch.zeros(1, dtype=torch.int64)
    for make, args in ((fhe_aes._fwd_luts, ()), (fhe_aes._sbox_lut, (True,)),
                       (fhe_aes._inv_mul_luts, ()),
                       (fhe_aes._refresh_sbox_lut, ()),
                       (fhe_aes._identity_lut, ()), (fhe_aes.trivial_rcon, ())):
        t = fhe_aes._on(like, make, PARAM_TOY, *args)
        assert fhe_aes._on(like, make, PARAM_TOY, *args) is t
        np.testing.assert_array_equal(torus.to_u64(t), make(PARAM_TOY, *args))
    state = torch.arange(16 * 2).reshape(1, 16, 2)
    np.testing.assert_array_equal(fhe_aes.shift_rows(state).numpy(),
                                  state[:, list(fhe_aes.SHIFT)].numpy())
    np.testing.assert_array_equal(fhe_aes.inv_shift_rows(state).numpy(),
                                  state[:, list(fhe_aes.INV_SHIFT)].numpy())
    assert fhe_aes._index(state, fhe_aes.SHIFT) is \
        fhe_aes._index(state, fhe_aes.SHIFT)
    mul = torch.arange(16 * 3 * 2).reshape(1, 16, 3, 2)
    byte_idx, var_idx = fhe_aes._mix_indices(fhe_aes._MC_VAR)
    np.testing.assert_array_equal(
        fhe_aes._mix(mul, fhe_aes._MC_VAR).numpy(),
        mul[:, torch.as_tensor(byte_idx), torch.as_tensor(var_idx)]
        .sum(dim=2).numpy())
