"""The port's whole-function dispatch units (CPU): add_scalar_device_jit,
ctr_step_jit, aes_encrypt_jit, aes_decrypt_jit and aes_key_expansion_jit
of models/fhe_aes, against the JAX package's, and their bookkeeping in the
graph cache (ops/graphs.py).

The card's capture cannot run here: the cache runs through an injected
stub capture.  StubCapture runs the warm-up call, then the captured call
once, inside the unit (so its WoPBS run inline); its replay runs the
captured call again on the static inputs, inside the unit, and writes the
static output in place, as a graph's replay does.  The bookkeeping tests
swap the WoPBS body for a cheap stand-in that records each call.  The
tests against the JAX package run the real circuits at toy parameters,
where one AES call takes a minute on the CPU: there ReplayOnce stands in,
whose capture records the call and whose replay runs it once (the words
of a graphed call are its replay's); the warm-up call is held by the
bookkeeping tests.  This file holds the cbs_level=1 toy set (the card's
VP path), tests/test_torch_units_toy.py PARAM_TOY.
"""

import collections
import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_aes_tpu.client.client import Client as JaxClient
from tfhe_aes_tpu.models import fhe_aes as jaes
from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes, tables
from tfhe_aes_tpu_torch.ops import graphs, wopbs
from tfhe_aes_tpu_torch.ops.keys import ContractionShard
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import noise_asserts, profiling, torus

torch.set_num_threads(1)

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x000102030405060708090A0B0C0D0EFF      # the counter add carries
OFFSET = 0x101
ROUNDS = 2          # the key schedules' rounds held against JAX
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)
UNITS = ("add_scalar_device_jit", "ctr_step_jit", "aes_encrypt_jit",
         "aes_decrypt_jit", "aes_key_expansion_jit",
         "aes_key_expansion_jit pk-RCON")


UNIT_OBJECTS = {"add_scalar_device_jit": fhe_aes._ADD_SCALAR,
                "ctr_step_jit": fhe_aes._CTR_STEP,
                "aes_encrypt_jit": fhe_aes._ENCRYPT,
                "aes_decrypt_jit": fhe_aes._DECRYPT,
                "aes_key_expansion_jit": fhe_aes._KEY_EXPANSION}


class StubCapture:
    """Capture by recording, as on the card: warm() eagerly, then the
    captured call once; its replay runs the captured call again on the
    static inputs, inside the unit, and writes the static output."""

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


class ReplayOnce:
    """Capture by recording only: the replay runs the captured call on the
    static inputs, inside the unit, and takes its result as the static
    output."""

    def __init__(self):
        self.captured = 0

    def capture(self, device, warm, fn):
        self.captured += 1
        output = torch.empty(0, dtype=torch.int64)

        def replay():
            with graphs.GRAPHS.unit():
                output.set_(fn())
        return types.SimpleNamespace(replay=replay), output


def _graphed_through(monkeypatch, capture):
    """graphs.GRAPHS through `capture`, the counts of utils/profiling
    (its captures and replays among them) from zero."""
    cache = graphs.GraphCache(capture=capture)
    monkeypatch.setattr(graphs, "GRAPHS", cache)
    profiling.reset()
    return types.SimpleNamespace(cache=cache, capture=capture)


def _calls(counts) -> tuple:
    """The rotate and VP calls of a count store or a graph's record."""
    return counts["rotate_calls"], counts["vp_calls"]


@pytest.fixture
def stub(monkeypatch):
    return _graphed_through(monkeypatch, StubCapture())


# -- the units against the JAX package ------------------------------------------

def _toy_keys(params):
    """(JAX client, JAX keys, port client, port keys) of seed 11."""
    jc, tc = JaxClient(params, seed=11), Client(params, seed=11)
    return (jc, jc.make_device_keys(fast=False), tc,
            tc.make_device_keys(fast=False, device="cpu"))


@pytest.fixture(scope="module")
def toy():
    return _toy_keys(PARAM_TOY_VP)


def _schedule(rounds=10):
    return aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))[
        :rounds + 1]


def _aes(value):
    return aes_plain.ctr_keystream(KEY, value, 1)[0]


def _cases(jc):
    """unit -> (the port unit, the JAX unit, its u64 arguments, its
    static keywords, what its result decrypts to): one block; the key
    schedules over their first ROUNDS rounds (a round a row of RCON, in
    both packages)."""
    rks = np.stack([np.stack([jc.encrypt_byte(b) for b in rk])
                    for rk in _schedule()])
    iv = jc.encrypt_u128(IV)
    lsb, rest = jaes.add_scalar_luts(jc.params, jaes.counter_bytes(1, OFFSET))
    rcon = jc.make_public_key().encrypt_bits(np.stack([
        np.array([(int(r) >> j) & 1 for j in range(8)], np.uint64)
        for r in tables.RCON]), np.random.default_rng(5))[:ROUNDS]
    trivial = fhe_aes.trivial_rcon(jc.params)[:ROUNDS]
    enc_key = jc.encrypt_u128(KEY)
    return {
        "add_scalar_device_jit": (
            fhe_aes.add_scalar_device_jit, jaes.add_scalar_device_jit,
            (iv[None], lsb, rest), {}, [IV + OFFSET]),
        "ctr_step_jit": (fhe_aes.ctr_step_jit, jaes.ctr_step_jit,
                         (rks, iv, lsb, rest), {}, [_aes(IV + OFFSET)]),
        "aes_encrypt_jit": (fhe_aes.aes_encrypt_jit, jaes.aes_encrypt_jit,
                            (rks, iv[None]), {}, [_aes(IV)]),
        "aes_decrypt_jit": (fhe_aes.aes_decrypt_jit, jaes.aes_decrypt_jit,
                            (rks, jc.encrypt_u128(_aes(IV))[None]), {},
                            [IV]),
        "aes_key_expansion_jit": (
            fhe_aes.aes_key_expansion_jit, jaes.aes_key_expansion_jit,
            (enc_key, trivial), {"rcon_fresh": False}, _schedule(ROUNDS)),
        "aes_key_expansion_jit pk-RCON": (
            fhe_aes.aes_key_expansion_jit, jaes.aes_key_expansion_jit,
            (enc_key, rcon), {"rcon_fresh": True}, _schedule(ROUNDS)),
    }


def check_unit_equals_jax(keys, graphed, unit):
    """The unit, graphed (one capture, one replay), gives the JAX unit's
    words on the same inputs, and its result decrypts as AES says."""
    jc, jd, tc, td = keys
    port, jax_unit, args, static, plain = _cases(jc)[unit]
    want = np.asarray(jax_unit(jd, *map(jnp.asarray, args), **static))
    got = port(td, *(torus.from_u64(a) for a in args), **static)
    assert (graphed.capture.captured, graphed.cache.replays) == (1, 1)
    ((key, _),) = graphed.cache.graphs(td).items()
    assert key[0] is UNIT_OBJECTS[unit.split()[0]]
    out = torus.to_u64(got)
    np.testing.assert_array_equal(out, want)
    if unit.startswith("aes_key_expansion"):
        assert [[tc.decrypt_byte(out[r, i]) for i in range(16)]
                for r in range(ROUNDS + 1)] == plain
    else:
        assert [tc.decrypt_state_u128(s) for s in out] == plain


@pytest.mark.parametrize("unit", UNITS)
def test_unit_equals_jax(toy, monkeypatch, unit):
    check_unit_equals_jax(toy, _graphed_through(monkeypatch, ReplayOnce()),
                          unit)


# -- the bookkeeping, on a stand-in WoPBS ----------------------------------------

class FakeKeys:
    """A key set for the stand-in WoPBS: the circuits read its params, the
    caps its device."""
    params = PARAM_TOY
    shard = None
    device = torch.device("cpu")


@pytest.fixture
def fake_wopbs(monkeypatch, stub):
    """wopbs._many_wopbs as a cheap function of its input that counts one
    rotate and one VP call, records (shape, cap, inside a unit) a call."""
    calls = []

    def many(keys, x, luts, cap):
        calls.append(((x.shape[0], luts.shape[1], x.shape[1]), cap,
                      graphs.GRAPHS.inside()))
        profiling.count("rotate_calls")
        profiling.count("vp_calls")
        out = x.sum(dim=1, keepdim=True) * 3 + luts.sum()
        return out.expand(x.shape[0], luts.shape[1], x.shape[-1]).clone()
    monkeypatch.setattr(wopbs, "_many_wopbs", many)
    return calls


def _fake_ctr_args(n_blocks, seed=0, width=5):
    rng = np.random.default_rng(seed)
    lsb, rest = (torch.from_numpy(t.astype(np.int64)) for t in
                 fhe_aes.add_scalar_luts(PARAM_TOY, fhe_aes.counter_bytes(
                     n_blocks, seed)))
    rks = torch.from_numpy(rng.integers(0, 1 << 40, (11, 16, 8, width)))
    iv = torch.from_numpy(rng.integers(0, 1 << 40, (16, 8, width)))
    return rks, iv, lsb, rest


def _ctr_wopbs(n_blocks):
    _, _, lsb, rest = _fake_ctr_args(n_blocks)
    return fhe_aes._ripple_wopbs(lsb, rest) + fhe_aes._encrypt_wopbs(n_blocks)


def test_a_unit_captures_once_a_shape_with_its_wopbs_inline(stub,
                                                            fake_wopbs):
    """ctr_step_jit: one warm-up call on the first block, one capture and
    one replay a batch size, later calls a replay each; every WoPBS of
    the warm-up, the capture and the replays runs inline (no graph of its
    own), as many as the unit says; each result is ctr_step's."""
    keys = FakeKeys()
    calls = [(2, 1), (2, 2), (3, 3), (2, 4)]        # (blocks, seed)
    want = []
    for n, seed in calls:
        caps = tuple((s, s[0]) for s in _ctr_wopbs(n))
        with graphs.GRAPHS.unit(), wopbs.decided_caps(caps):
            want.append(fhe_aes.ctr_step(keys, *_fake_ctr_args(n, seed)))
    fake_wopbs.clear()
    for (n, seed), w in zip(calls, want):
        assert torch.equal(fhe_aes.ctr_step_jit(keys,
                                                *_fake_ctr_args(n, seed)), w)
    graphs_by_key = stub.cache.graphs(keys)
    assert len(graphs_by_key) == 2
    assert (stub.capture.warmed, stub.capture.captured,
            stub.cache.captures, stub.cache.replays) == (2, 2, 2, 4)
    assert all(inside for _, _, inside in fake_wopbs)
    runs = collections.Counter(s for s, _, _ in fake_wopbs)
    assert runs == _ctr_wopbs(1) + _ctr_wopbs(1) + \
        sum([_ctr_wopbs(2)] * 4 + [_ctr_wopbs(3)] * 2, collections.Counter())
    for (fn, static, _), graph in graphs_by_key.items():
        assert fn is fhe_aes._CTR_STEP
        (caps,) = static
        assert all(cap == shape[0] for shape, cap in caps)   # CPU: all bytes
        assert _calls(graph.record.counts) == (26, 26)


def test_the_caps_are_decided_once_before_the_capture_and_keyed(
        stub, fake_wopbs, monkeypatch):
    """Every WoPBS shape of a unit gets its cap before the warm-up call
    and the capture, once a key set (shared with many_wopbs_jit); the caps
    are the graph's static argument, and the WoPBS inside run under them."""
    keys = FakeKeys()
    asked = []

    def chunk_bytes(k, n_bytes, n_luts, nbits):
        asked.append(((n_bytes, n_luts, nbits), stub.capture.captured))
        return n_bytes // 2 + 1
    monkeypatch.setattr(wopbs, "chunk_bytes", chunk_bytes)
    state = torch.zeros((2, 16, 8, 5), dtype=torch.int64)
    rks = torch.ones((11, 16, 8, 5), dtype=torch.int64)
    for _ in range(3):
        fhe_aes.aes_decrypt_jit(keys, rks, state)
    want_caps = tuple(sorted((s, s[0] // 2 + 1)
                             for s in fhe_aes._decrypt_wopbs(2)))
    ((_, static, _),) = stub.cache.graphs(keys)
    assert static == (want_caps,)
    # the call's shapes, then the warm-up's (its first block), before any
    # capture; never again
    assert sorted(s for s, _ in asked[:2]) == sorted(fhe_aes._decrypt_wopbs(2))
    assert sorted(s for s, _ in asked[2:]) == sorted(fhe_aes._decrypt_wopbs(1))
    assert all(n == 0 for _, n in asked)
    caps = dict(want_caps) | {s: s[0] // 2 + 1
                              for s in fhe_aes._decrypt_wopbs(1)}
    assert all(cap == caps[shape] for shape, cap, _ in fake_wopbs)
    # many_wopbs_jit of a decided shape takes the same cap (no new read)
    x = torch.zeros((32, 8, 5), dtype=torch.int64)
    lut = torus.from_u64(fhe_aes._sbox_lut(PARAM_TOY, True))
    wopbs.many_wopbs_jit(keys, x, lut)
    assert len(asked) == 4 and fake_wopbs[-1][1] == 17


def test_an_undecided_cap_inside_a_unit_raises(stub, fake_wopbs):
    """Nothing inside a unit reads the free memory: a WoPBS whose shape
    the unit did not decide raises."""
    keys = FakeKeys()
    x = torch.zeros((3, 8, 5), dtype=torch.int64)
    lut = torus.from_u64(fhe_aes._sbox_lut(PARAM_TOY, False))
    with graphs.GRAPHS.unit(), wopbs.decided_caps((((3, 8, 9), 3),)):
        with pytest.raises(RuntimeError, match="no chunk cap was decided"):
            wopbs.many_wopbs_jit(keys, x, lut)
        assert fake_wopbs == []
        with wopbs.decided_caps((((3, 8, 8), 2),)):
            wopbs.many_wopbs_jit(keys, x, lut)
        assert fake_wopbs == [((3, 8, 8), 2, True)]
        with pytest.raises(RuntimeError, match="nested call must run inline"):
            graphs.GRAPHS(lambda k, t: t, keys, (x,))


def test_a_unit_graph_adds_its_wopbs_launches_a_replay(stub, fake_wopbs):
    """A unit's graph holds the launches of every WoPBS it ran; the
    warm-up call counts its own, the capture none, each replay the
    graph's."""
    keys = FakeKeys()
    enc_key = torch.zeros((16, 8, 5), dtype=torch.int64)
    rcon = torch.ones((10, 8, 5), dtype=torch.int64)
    fhe_aes.aes_key_expansion_jit(keys, enc_key, rcon)      # pk-RCON
    ((_, graph),) = stub.cache.graphs(keys).items()
    assert _calls(graph.record.counts) == (30, 30)
    assert _calls(profiling.COUNTS) == (3 + 30, 3 + 30)    # first round
    for n in (1, 2):
        fhe_aes.aes_key_expansion_jit(keys, enc_key, rcon)
        assert _calls(profiling.COUNTS) == (33 + 30 * n, 33 + 30 * n)


@pytest.mark.parametrize("unit", ["add_scalar_device_jit", "ctr_step_jit",
                                  "aes_decrypt_jit",
                                  "aes_key_expansion_jit"])
def test_the_warm_up_call_is_the_first_block(stub, fake_wopbs, unit):
    """A batch unit warms up on its first block, every batch-leading
    tensor sliced; the key schedule on its first round.  Then the capture
    and the replay run the whole call, every WoPBS inline."""
    keys = FakeKeys()
    rks, iv, lsb, rest = _fake_ctr_args(3)
    state = iv[None].expand(3, -1, -1, -1)
    rcon = rks[1:, 0]
    ripple, enc = fhe_aes._ripple_wopbs, fhe_aes._encrypt_wopbs
    args, warm, full = {
        "add_scalar_device_jit": ((state, lsb, rest),
                                  ripple(lsb[:1], rest[:, :1]),
                                  ripple(lsb, rest)),
        "ctr_step_jit": ((rks, iv, lsb, rest),
                         ripple(lsb[:1], rest[:, :1]) + enc(1),
                         ripple(lsb, rest) + enc(3)),
        "aes_decrypt_jit": ((rks, state), fhe_aes._decrypt_wopbs(1),
                            fhe_aes._decrypt_wopbs(3)),
        "aes_key_expansion_jit": ((iv, rcon),
                                  fhe_aes._key_expansion_wopbs(rcon[:1], True),
                                  fhe_aes._key_expansion_wopbs(rcon, True)),
    }[unit]
    getattr(fhe_aes, unit)(keys, *args)
    n_warm = sum(warm.values())
    assert collections.Counter(s for s, _, _ in fake_wopbs[:n_warm]) == warm
    assert collections.Counter(s for s, _, _ in fake_wopbs[n_warm:]) == \
        full + full                              # the capture, the replay
    assert all(inside for _, _, inside in fake_wopbs)


# -- dispatch -----------------------------------------------------------------

def _recording(monkeypatch, names):
    seen = []
    for name in names:
        monkeypatch.setattr(fhe_aes, name, (lambda name: lambda *a, **kw: (
            seen.append(name), a[1])[1])(name))
    return seen


def test_server_dispatches_through_the_units(monkeypatch):
    seen = _recording(monkeypatch, ["aes_encrypt_jit", "aes_decrypt_jit",
                                    "aes_key_expansion_jit",
                                    "aes_encrypt", "aes_decrypt",
                                    "aes_key_expansion"])
    server = Server(dkeys=None, public_key=types.SimpleNamespace(
        encrypt_bits=lambda bits, rng: np.zeros(bits.shape + (3,),
                                                np.uint64)))
    x = torch.zeros(3)
    server.aes_encrypt(x, x)
    server.aes_decrypt(x, x)
    server.aes_key_expansion(x, pk_rcon=True)
    assert seen == ["aes_encrypt_jit", "aes_decrypt_jit",
                    "aes_key_expansion_jit"]


@pytest.mark.parametrize("block_chunk", [None, 2])
def test_ctr_keystream_and_add_scalar_dispatch_through_the_units(
        monkeypatch, block_chunk):
    """One batch: ctr_step_jit; chunked (block_chunk below the batch): the
    ripple add once through add_scalar_device_jit, then aes_encrypt_jit a
    chunk; add_scalar: add_scalar_device_jit.  Never the plain
    functions."""
    seen = _recording(monkeypatch, ["ctr_step_jit", "add_scalar_device_jit",
                                    "aes_encrypt_jit", "ctr_step",
                                    "add_scalar_device", "aes_encrypt"])
    keys = FakeKeys()
    iv = torch.zeros((16, 8, 5), dtype=torch.int64)
    rks = torch.zeros((11, 16, 8, 5), dtype=torch.int64)
    fhe_aes.ctr_keystream(keys, rks, iv, 3, block_chunk=block_chunk)
    if block_chunk is None:
        assert seen == ["ctr_step_jit"]
    else:
        assert seen == ["add_scalar_device_jit"] + ["aes_encrypt_jit"] * 2
    seen.clear()
    fhe_aes.add_scalar(keys, iv[None], fhe_aes.counter_bytes(1))
    assert seen == ["add_scalar_device_jit"]


def test_sharded_keys_run_a_unit_eagerly(stub, fake_wopbs, monkeypatch):
    """Keys with a contraction shard never reach the graph cache: the
    unit runs its function, each WoPBS through many_wopbs."""
    calls = []
    monkeypatch.setattr(wopbs, "many_wopbs",
                        lambda k, x, luts, **kw: calls.append(x.shape[0])
                        or torch.zeros((x.shape[0], luts.shape[1],
                                        x.shape[-1]), dtype=torch.int64))
    keys = FakeKeys()
    keys.shard = object()
    fhe_aes.ctr_step_jit(keys, *_fake_ctr_args(2))
    assert len(calls) == 26 and fake_wopbs == []
    assert len(stub.cache) == 0 and stub.cache.captures == 0


# -- sharded keys over a capturable group -------------------------------------

GROUP = object()        # a stand-in process group, taken as capturable


@pytest.fixture
def agreed(monkeypatch, fake_wopbs):
    """GROUP capturable (and nothing else); the shard's agree_min records
    each cap it is given and returns the least of it and 3, as peers
    with smaller caps would.  Returns the recorded caps."""
    monkeypatch.setattr(graphs, "capturable", lambda group: group is GROUP)
    agreed = []
    monkeypatch.setattr(ContractionShard, "agree_min",
                        lambda shard, n, device: agreed.append(n)
                        or min(n, 3))
    return agreed


def _sharded(keys):
    keys.shard = ContractionShard(GROUP, slice(0, 1), slice(0, 1))
    return keys


def test_only_an_nccl_group_is_capturable():
    """A stand-in is no process group: eager, as a gloo group is (held in
    tests/test_torch_mesh.py's world, NCCL's on the card)."""
    assert not graphs.capturable(None)
    assert not graphs.capturable(object())
    keys = FakeKeys()
    assert wopbs.graphable(keys)
    keys.shard = object()
    assert not wopbs.graphable(keys)
    keys.shard = ContractionShard(object(), slice(0, 1), slice(0, 1))
    assert not wopbs.graphable(keys)


def test_sharded_keys_over_a_capturable_group_reach_the_cache(
        stub, fake_wopbs, agreed, monkeypatch):
    """ctr_step_jit on keys whose shard's group a capture can hold: one
    warm-up call, one capture, replays; every WoPBS inline, under the
    agreed caps, none through many_wopbs."""
    keys = _sharded(FakeKeys())
    calls = []
    monkeypatch.setattr(wopbs, "many_wopbs",
                        lambda *a, **kw: calls.append(a))
    for seed in (1, 2):
        fhe_aes.ctr_step_jit(keys, *_fake_ctr_args(2, seed))
    assert calls == []
    assert (stub.capture.warmed, stub.cache.captures,
            stub.cache.replays) == (1, 1, 2)
    ((key, graph),) = stub.cache.graphs(keys).items()
    assert key[0] is fhe_aes._CTR_STEP
    assert key[1] == (tuple((s, min(s[0], 3))
                            for s in sorted(_ctr_wopbs(2))),)
    assert all(inside and cap == min(shape[0], 3)
               for shape, cap, inside in fake_wopbs)
    assert _calls(graph.record.counts) == (26, 26)


def test_sharded_caps_are_agreed_once_a_shape_never_in_a_replay(
        stub, fake_wopbs, agreed):
    """agree_min runs once for each WoPBS shape of the call and of its
    warm-up (the first block) at the first call, before the warm-up and
    the capture, and never again: a replay reads nothing on the host."""
    keys = _sharded(FakeKeys())
    fhe_aes.ctr_step_jit(keys, *_fake_ctr_args(2, 1))
    shapes = sorted(_ctr_wopbs(2)) + sorted(_ctr_wopbs(1))
    assert agreed == [s[0] for s in shapes]
    for seed in (2, 3):
        fhe_aes.ctr_step_jit(keys, *_fake_ctr_args(2, seed))
    assert len(agreed) == len(shapes)
    assert stub.cache.replays == 3
    # many_wopbs_jit of a decided shape takes the agreed cap, no new read
    x = torch.zeros((32, 8, 5), dtype=torch.int64)
    wopbs.many_wopbs_jit(keys, x, torus.from_u64(
        fhe_aes._fwd_luts(PARAM_TOY)))
    assert len(agreed) == len(shapes) and fake_wopbs[-1][1] == 3


def test_split_batch_keys_are_one_object_across_rounds_and_calls(
        toy, stub, fake_wopbs, agreed, monkeypatch):
    """With the bytes split over a group, every round's WoPBS runs on the
    shard's split-batch keys, one object made once a key set (a graph is
    held by its key object), across the rounds of a call and the calls;
    the ripple add's on the keys themselves."""
    _, _, _, td = toy
    keys = dataclasses.replace(td, shard=ContractionShard(
        GROUP, slice(0, 1), slice(0, 1)))
    seen = []
    many = wopbs._many_wopbs
    monkeypatch.setattr(wopbs, "_many_wopbs",
                        lambda k, x, luts, cap: seen.append(
                            (id(k), k.shard.split_batch))
                        or many(k, x, luts, cap))
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "all_gather_into_tensor",
                        lambda out, x, group=None: out.copy_(
                            torch.cat([x, x])))
    for seed in (1, 2):
        fhe_aes.ctr_step_jit(keys, *_fake_ctr_args(2, seed),
                             byte_group=GROUP)
    split = keys.split_batch_keys
    assert split is keys.split_batch_keys and split.shard.split_batch
    assert split.shard.group is GROUP and not keys.shard.split_batch
    # warm-up, capture, two replays: 10 rounds and 16 ripple steps each
    assert collections.Counter(seen) == {(id(split), True): 40,
                                         (id(keys), False): 64}
    ((key, _),) = stub.cache.graphs(keys).items()
    assert key[1][0] is GROUP
    assert {s for s, _ in key[1][1]} == set(
        fhe_aes._ripple_wopbs(*_fake_ctr_args(2)[2:])) | {(16, 24, 8),
                                                          (16, 8, 8)}


def test_armed_noise_checks_fire_once_a_wopbs(toy, stub):
    """While the noise checks are armed a unit runs eagerly, each WoPBS
    through many_wopbs_jit (its own graph): an input and an output check
    a WoPBS, as in the eager call, and the eager call's words."""
    jc, _, tc, td = toy
    state = torus.from_u64(tc.encrypt_u128(IV))[None]
    lsb, rest = (torus.from_u64(t) for t in fhe_aes.add_scalar_luts(
        PARAM_TOY_VP, fhe_aes.counter_bytes(1, 1)))
    noise_asserts.enable(tc.sk)
    try:
        want = fhe_aes.add_scalar_device(td, state, lsb, rest)
        eager = [c["tag"] for c in noise_asserts.checks()]
        got = fhe_aes.add_scalar_device_jit(td, state, lsb, rest)
        tags = [c["tag"] for c in noise_asserts.checks()][len(eager):]
        noise_asserts.assert_clean()
    finally:
        noise_asserts.disable()
    assert eager == ["wopbs_input", "wopbs_output"] * 16
    assert tags == eager
    assert torch.equal(got, want)
    assert all(fn is wopbs._many_wopbs for fn, _, _ in
               stub.cache.graphs(td))           # the WoPBS graphs only
    assert tc.decrypt_state_u128(torus.to_u64(got)[0]) == IV + 1
