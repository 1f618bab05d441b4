"""The port's tracing (utils/profiling.py) on the CPU: host spans off and
under torch.profiler, the span tree of one toy keystream request, the
units' and WoPBS counters through a stub capture, the ring decoder on a
synthetic ring, and the benchmark's readers of the program's record
(benchmark/metrics/) on synthetic traces.

The toy keystream runs the real circuits with each WoPBS stage (extract,
circuit-bootstrap rotate, staging, vertical packing) replaced by a stand-in
of the same shapes: the marks and spans are the circuits' own, the
arithmetic is not what is tested here.
"""

import collections
import dataclasses
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch.models import fhe_aes
from tfhe_aes_tpu_torch.ops import cbs, graphs, vertical_packing, wopbs
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = ("extract", "cbs_rotate", "staging", "vp")


@pytest.fixture(autouse=True)
def fresh():
    """Tracing off and nothing recorded, before and after each test."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


class ToyKeys:
    """What the circuits read of a key set at PARAM_TOY."""
    params = PARAM_TOY
    shard = None
    device = torch.device("cpu")


@pytest.fixture
def stand_in_stages(monkeypatch):
    """Each WoPBS stage as a cheap function of the shapes it gives."""
    p = PARAM_TOY
    big1, small1 = p.big_lwe_dimension + 1, p.lwe_dimension + 1
    monkeypatch.setattr(wopbs, "extract_bits",
                        lambda keys, x: x[..., :small1] + 1)
    monkeypatch.setattr(cbs, "cbs_pbs_levels", lambda keys, s: torch.zeros(
        (p.cbs_level, s.shape[0], big1), dtype=torch.int64))
    monkeypatch.setattr(cbs, "cbs_stage_ggsw", lambda keys, b: torch.zeros(
        (1, b.shape[1], 2), dtype=torch.int64))
    monkeypatch.setattr(vertical_packing, "vertical_packing",
                        lambda keys, g, lut: torch.ones(
                            (g.shape[2], lut.shape[1], big1),
                            dtype=torch.int64))


def _request_inputs(n_blocks=1):
    width = PARAM_TOY.big_lwe_dimension + 1
    rng = np.random.default_rng(3)
    rks = torch.from_numpy(rng.integers(0, 1 << 40, (11, 16, 8, width)))
    iv = torch.from_numpy(rng.integers(0, 1 << 40, (16, 8, width)))
    return rks, iv


# -- host spans ---------------------------------------------------------------

def test_spans_off_record_nothing_and_open_no_range(monkeypatch,
                                                    stand_in_stages):
    """Tracing off: a request records no span, mark or device read, and
    opens no profiler range; a profile taken afterwards holds no tfhe:
    event.  The counters count all the same."""
    def refused(*args, **kwargs):
        raise AssertionError("a profiler range or a ring read while "
                             "tracing is off")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    monkeypatch.setattr(profiling, "_read_rings", refused)
    assert not profiling.tracing()
    Server(ToyKeys()).ctr_keystream(*_request_inputs(), 1)
    monkeypatch.undo()
    rep = profiling.report()
    assert rep["host_spans"] == rep["device_spans"] == rep["marks"] == []
    assert rep["marks_logged"] == 0
    assert sum(r["runs"] for r in rep["counters"]["wopbs"]) == 26
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
    assert not [e for e in prof.events()
                if e.name.startswith(profiling.SPAN_PREFIX)]


def test_spans_under_the_profiler_nest_in_order_on_its_clock():
    """While a torch.profiler records, tracing is on: each span is a
    tfhe: range inside the caller's outer range, nested and ordered as
    the blocks ran, and an in-memory record with its parent and request."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with torch.profiler.record_function("outer"):
            with profiling.span("a"):
                with profiling.span("b"):
                    torch.ones(4).sum()
            with profiling.span("c"):
                torch.ones(4).sum()
    assert not profiling.tracing()
    ev = {e.name: e.time_range for e in prof.events()
          if e.name in ("outer", "tfhe:a", "tfhe:b", "tfhe:c")}
    assert set(ev) == {"outer", "tfhe:a", "tfhe:b", "tfhe:c"}
    outer, a, b, c = (ev[k] for k in ("outer", "tfhe:a", "tfhe:b",
                                      "tfhe:c"))
    assert outer.start <= a.start <= b.start <= b.end <= a.end <= c.start \
        <= c.end <= outer.end
    host = {s["name"]: s for s in profiling.report()["host_spans"]}
    assert host["b"]["parent"] == host["a"]["id"]
    assert host["a"]["parent"] is host["c"]["parent"] is None
    assert host["b"]["request"] == host["a"]["id"] == host["a"]["request"]
    assert host["a"]["start_ns"] <= host["b"]["start_ns"] \
        <= host["b"]["end_ns"] <= host["a"]["end_ns"] <= host["c"]["start_ns"]


# -- the span tree of one request ---------------------------------------------

def test_the_span_tree_of_one_toy_ctr_keystream(stand_in_stages, tmp_path):
    """One traced request: the server's top-level host span holds the
    host's counter LUTs and their upload; the device spans are ctr_step,
    then ripple_add holding 16 WoPBS and aes_rounds holding 10, each WoPBS
    its four stages in order, all of one request; self times add up."""
    profiling.enable()
    Server(ToyKeys()).ctr_keystream(*_request_inputs(), 1)
    profiling.disable()
    rep = profiling.report()
    assert rep["lost"] == []
    (top,) = [s for s in rep["host_spans"] if s["parent"] is None]
    assert top["name"] == "ctr_keystream"
    assert [s["name"] for s in rep["host_spans"] if s["parent"] ==
            top["id"]] == ["luts", "lut_upload"]
    spans = rep["device_spans"]
    assert {s["request"] for s in spans} == {top["id"]}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)
    (step,) = kids[None]
    assert step["name"] == "ctr_step"
    ripple, rounds = kids[step["id"]]
    assert (ripple["name"], rounds["name"]) == ("ripple_add", "aes_rounds")
    for part, n in ((ripple, 16), (rounds, 10)):
        assert [s["name"] for s in kids[part["id"]]] == ["wopbs"] * n
        for w in kids[part["id"]]:
            assert [s["name"] for s in kids[w["id"]]] == list(STAGES)
            starts = [s["start_ns"] for s in kids[w["id"]]]
            assert starts == sorted(starts)
    layers = rep["layers"]["device"]
    assert layers["wopbs"]["count"] == 26
    stages = sum(layers[s]["s"] for s in STAGES)
    assert layers["wopbs"]["self_s"] == pytest.approx(
        layers["wopbs"]["s"] - stages, abs=1e-9)
    assert layers["ctr_step"]["self_s"] == pytest.approx(
        layers["ctr_step"]["s"] - layers["ripple_add"]["s"]
        - layers["aes_rounds"]["s"], abs=1e-9)
    assert rep["layers"]["host"]["ctr_keystream"]["count"] == 1
    profiling.dump(tmp_path / "trace.json")
    assert (tmp_path / "trace.json").read_text().startswith("{")


# -- counters through a stub capture ------------------------------------------

class StubCapture:
    """Capture by recording, as tests/test_torch_units.py's: warm()
    eagerly, then the captured call once; a replay runs the captured call
    again on the static inputs, inside the unit."""

    def capture(self, device, warm, fn):
        warm()
        output = fn()

        def replay():
            with graphs.GRAPHS.unit():
                output.copy_(fn())
        return types.SimpleNamespace(replay=replay), output


def test_unit_counters_under_the_stub_capture(monkeypatch, stand_in_stages):
    """ctr_step_jit through a stub capture: the first call warms up on one
    block, captures and replays once, the second replays; the WoPBS
    counters count the warm-up's 26 one-block WoPBS and each replay's 26
    of the batch, which the graph holds with its marks' labels."""
    cache = graphs.GraphCache(capture=StubCapture())
    monkeypatch.setattr(graphs, "GRAPHS", cache)
    rks, iv = _request_inputs()
    keys = ToyKeys()
    lut_lsb, luts_rest = (torch.from_numpy(t.astype(np.int64)) for t in
                          fhe_aes.add_scalar_luts(
                              PARAM_TOY, fhe_aes.counter_bytes(2, 5)))
    fhe_aes.ctr_step_jit(keys, rks, iv, lut_lsb, luts_rest)
    units = profiling.report()["counters"]["units"]
    assert units == {"ctr_step": {"warm_ups": 1, "captures": 1,
                                  "replays": 1}}
    fhe_aes.ctr_step_jit(keys, rks, iv, lut_lsb, luts_rest)
    rep = profiling.report()["counters"]
    assert rep["units"]["ctr_step"] == {"warm_ups": 1, "captures": 1,
                                        "replays": 2}
    runs = {(r["bytes"], r["luts"], r["bits"]): r["runs"]
            for r in rep["wopbs"]}
    assert runs == {(1, 9, 8): 1, (1, 9, 9): 15, (16, 24, 8): 9,
                    (16, 8, 8): 1, (2, 9, 8): 2, (2, 9, 9): 30,
                    (32, 24, 8): 18, (32, 8, 8): 2}
    (graph,) = cache.graphs(keys).values()
    assert graph.name == "ctr_step"
    # Its WoPBS by shape, and no kernel: the CPU launches none.
    assert graph.record.counts == {
        ("wopbs", 2, 9, 8): 1, ("wopbs", 2, 9, 9): 15,
        ("wopbs", 32, 24, 8): 9, ("wopbs", 32, 8, 8): 1}
    labels = graph.record.labels
    assert len(labels) == 3 + 5 * 26
    assert labels[:2] == ["|ctr_step,ripple_add", "|wopbs,extract"]
    assert labels[-1] == "aes_rounds,ctr_step|"


def _rotates(bits):
    """A request's rotate calls of `bits` bits each at PARAM_OPT on the
    H100's 132 SMs, counted as blind_rotate_cuda counts them: the call,
    and whether its K2 ran split and its K1 persistently."""
    from tfhe_aes_tpu_torch.ops import cuda_blind_rotate as cbr
    from tfhe_aes_tpu_torch.params import PARAM_OPT

    def request(owner, x):
        for b in bits:
            profiling.count("rotate_calls")
            if cbr.k2_cluster(PARAM_OPT, b, 5, 132) > 1:
                profiling.count("rotate_split_calls")
            if cbr.k1_persistent(PARAM_OPT, b, 5, 132):
                profiling.count("rotate_persistent_calls")
        return x + 1
    return request


def test_split_rotates_count_as_launches_do_under_the_stub_capture():
    """The rotate calls whose K2 ran split, and those whose K1 ran
    persistently, count as the launches do: the warm-up call counts
    itself, a capture nothing, each replay what its graph holds; report()
    shows them beside the rotate calls.  A PARAM_OPT 16-block request's 26
    rotates on the H100's 132 SMs: the ripple add's first (128 bits)
    splits, its 15 later (144 bits) and the rounds' ten (2048 bits) do
    not; all 26 run K1 persistently (1280 tiles and more, K1_TILES_PER_SM
    an SM from 528).  The whole counters section, every key and value."""
    cache = graphs.GraphCache(capture=StubCapture())
    request = _rotates([128] + [144] * 15 + [2048] * 10)
    owner = ToyKeys()
    for n in (1, 2, 3):
        cache(request, owner, (torch.arange(4),))
        counters = profiling.report()["counters"]
        assert counters == {
            "units": {"request": {"warm_ups": 1, "captures": 1,
                                  "replays": n}},
            "wopbs": [], "mark_launches": 0,
            "rotate_calls": 26 * (n + 1), "rotate_split_calls": n + 1,
            "rotate_persistent_calls": 26 * (n + 1)}
    (graph,) = cache.graphs(owner).values()
    assert graph.record.counts == {"rotate_calls": 26,
                                   "rotate_split_calls": 1,
                                   "rotate_persistent_calls": 26}


def test_a_session_rotate_below_the_edge_counts_no_persistent_k1():
    """A one-block session's ripple add (8 and 9 bits: 80 and 90 K1 tiles)
    and SubWord (32 bits: 320 tiles, 2.4 an SM) run K1 one block a tile on
    the H100, its key schedule rounds (128 bits: 1280 tiles) persistently:
    the fifth count of a graph holds only the rounds where the first holds
    every rotate."""
    cache = graphs.GraphCache(capture=StubCapture())
    request = _rotates([8] + [9] * 15 + [32] * 4 + [128] * 4)
    owner = ToyKeys()
    cache(request, owner, (torch.arange(4),))
    (graph,) = cache.graphs(owner).values()
    assert graph.record.counts == {"rotate_calls": 24,
                                   "rotate_split_calls": 24,
                                   "rotate_persistent_calls": 4}
    counters = profiling.report()["counters"]     # the warm-up's and the
    assert (counters["rotate_calls"],             # first replay's
            counters["rotate_persistent_calls"]) == (48, 8)


# -- the ring decoder ---------------------------------------------------------

def _synthetic(monkeypatch, slots, entries, ring):
    """profiling's log and ring as given: a ring of `slots` entries holding
    (label, ns) at each written slot of `ring`, entries (first slot,
    labels) logged in order on one card, the head after the last."""
    card = torch.device("cuda", 0)
    monkeypatch.setattr(profiling, "RING_SLOTS", slots)
    ids, stamps = np.zeros(slots, np.uint64), np.zeros(slots, np.uint64)
    for slot, (text, ns) in ring.items():
        ids[slot % slots] = profiling._label_id(text)
        stamps[slot % slots] = ns
    head = max(first + len(labels) for first, labels in entries)
    monkeypatch.setattr(profiling, "_read_rings",
                        lambda log: {card: (ids, stamps, head)})
    for first, labels in entries:
        profiling._log.append(profiling._Logged(card, first, tuple(labels),
                                                None, None))


def test_the_ring_decoder_wraps_pairs_and_loses_what_was_overwritten(
        monkeypatch):
    """A ring of 8 slots after 14 marks: slots 0-5 are overwritten (lost,
    with a reason), 6-13 decode across the wrap; begin and end pair up
    into nested spans with their self time; a span with a lost stamp has
    no duration and is left out of the layers."""
    old = [(0, "|x"), (1, "x|")]
    new = [(6, "|a,b"), (7, "b|c"), (8, "c|"), (9, "|d"), (10, "d|"),
           (11, "a|"), (12, "|a"), (13, "a|")]
    ring = {slot: (text, 1000 * (slot + 1)) for slot, text in new}
    _synthetic(monkeypatch, 8, [(0, [t for _, t in old]),
                                (6, [t for _, t in new])], ring)
    rep = profiling.report()
    assert len(rep["lost"]) == 2 and "wrapped" in rep["lost"][0]
    assert [m["ns"] for m in rep["marks"]] == [None, None] + \
        [1000 * (s + 1) for s, _ in new]
    spans = {(s["name"], s["start_ns"]): s for s in rep["device_spans"]}
    x = spans[("x", None)]
    assert x["end_ns"] is None
    a, b, c, d = (spans[k] for k in (("a", 7000), ("b", 7000), ("c", 8000),
                                     ("d", 10000)))
    assert b["parent"] == c["parent"] == d["parent"] == a["id"]
    assert (a["end_ns"], b["end_ns"], c["end_ns"], d["end_ns"]) == \
        (12000, 8000, 9000, 11000)
    layers = rep["layers"]["device"]
    assert "x" not in layers
    assert layers["a"] == {"count": 2, "s": pytest.approx(6e-6),
                           "self_s": pytest.approx(3e-6)}
    assert layers["b"]["self_s"] == pytest.approx(1e-6)


def test_a_mark_that_ran_out_of_order_is_lost_not_misread(monkeypatch):
    """A slot that holds another mark's id than the log says (two streams
    ran in another order than the host launched them) gives no stamp."""
    _synthetic(monkeypatch, 8, [(0, ["|p", "p|"])],
               {0: ("p|", 5), 1: ("|p", 9)})
    rep = profiling.report()
    assert [m["ns"] for m in rep["marks"]] == [None, None]
    assert len(rep["lost"]) == 2 and "another mark" in rep["lost"][0]


def test_report_opens_and_closes_only_what_the_marks_say(monkeypatch):
    """Closing a span that is not open is reported, not guessed."""
    _synthetic(monkeypatch, 8, [(0, ["q|"])], {0: ("q|", 3)})
    assert profiling.report()["lost"] == ["a mark closes 'q', which is "
                                          "not open"]


# -- the benchmark's readers --------------------------------------------------

def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _trace(n_marks):
    from benchmark import reduce
    ops = [("tfhe::br_forward_mac_kernel<5>", 0.0, 1.0)] + \
        [(profiling.MARK_KERNEL, 0.1 * i, 0.1 * i + 1e-6)
         for i in range(n_marks)]
    return reduce.Trace(ops, [], (0.0, 2.0), {"rotate_s": 1.0, "vp_s": 1.0},
                        [])


def _span(i, name, start, end, parent=None, request=None):
    return {"id": i, "name": name, "start_ns": int(start * 1e9),
            "end_ns": int(end * 1e9), "parent": parent,
            "request": i if request is None else request}


SYNTHETIC = {
    "marks_logged": 6,
    "device_spans": [
        _span(0, "ctr_step", 0.0, 10.0), _span(1, "ripple_add", 0.0, 1.0, 0),
        _span(2, "aes_rounds", 1.0, 10.0, 0), _span(3, "wopbs", 1.0, 5.0, 2),
        _span(4, "extract", 1.0, 1.2, 3), _span(5, "staging", 2.0, 2.5, 3),
        _span(6, "wopbs", 5.0, 9.0, 2), _span(7, "extract", 5.0, 5.2, 6),
        _span(8, "staging", 6.0, 6.5, 6),
        _span(9, "key_expansion", 20.0, 20.7),
        _span(10, "key_expansion", 30.0, 30.9),
        _span(11, "key_expansion", 40.0, 40.8)],
    "host_spans": [
        _span(1, "ctr_keystream", 0.0, 3.0), _span(2, "luts", 0.0, 0.02, 1, 1),
        _span(3, "lut_upload", 0.02, 0.03, 1, 1),
        _span(4, "ctr_step_jit", 0.03, 3.0, 1, 1),
        _span(5, "copy_in", 0.03, 0.035, 4, 1),
        _span(6, "replay", 0.035, 0.04, 4, 1),
        _span(7, "ctr_keystream", 5.0, 6.0), _span(8, "luts", 5.0, 5.04, 7, 7),
        _span(9, "lut_upload", 5.04, 5.05, 7, 7),
        _span(10, "ctr_keystream", 7.0, 8.0),
        _span(11, "luts", 7.0, 7.01, 10, 10)]}


@pytest.mark.parametrize("name,want", [
    ("ripple_share.bulk", 10.0), ("ripple_share.session", 10.0),
    ("extract_share.bulk", 5.0), ("staging_share.bulk", 12.5),
    ("keyexp_device_s", 0.8), ("host_prep_s.bulk", 0.035)])
def test_metric_reads_the_programs_record(monkeypatch, name, want):
    """Each reader on a synthetic trace whose mark records are the marks
    the program logged; None from a trace with no device record, and
    None when the counts differ (records the profiler dropped, or marks
    outside the traced window)."""
    monkeypatch.setattr(profiling, "report", lambda: SYNTHETIC)
    read = _reader(name)
    assert read(_trace(6)) == pytest.approx(want)
    assert read(_trace(5)) is None and read(_trace(7)) is None
    assert read(dataclasses.replace(_trace(6), ops=[])) is None


def test_metric_readers_are_silent_on_a_program_without_tracing(
        monkeypatch):
    """A program whose profiling has no report (one before this tracing)
    gives every new reader None, and none raises."""
    monkeypatch.delattr(profiling, "report")
    for name in ("ripple_share.bulk", "ripple_share.session",
                 "extract_share.bulk", "staging_share.bulk",
                 "keyexp_device_s", "host_prep_s.bulk"):
        assert _reader(name)(_trace(6)) is None


def test_the_cli_traces_its_run_and_writes_the_report(monkeypatch,
                                                      tmp_path):
    """--trace-out: tracing is on while the run runs and off after it, and
    the report is written at exit, also when the run fails."""
    from tfhe_aes_tpu_torch import cli
    seen = []

    def run(ap, args, device, params):
        seen.append(profiling.tracing())
        with profiling.span("run"):
            pass
        if len(seen) == 2:
            raise RuntimeError("the run failed")
        return 0
    monkeypatch.setattr(cli, "_main", run)
    path = tmp_path / "trace.json"
    argv = ["--device", "cpu", "--trace-out", str(path)]
    assert cli.main(argv) == 0
    assert "run" in path.read_text() and not profiling.tracing()
    path.unlink()
    with pytest.raises(RuntimeError, match="the run failed"):
        cli.main(argv)
    assert path.exists() and seen == [True, True]
    assert not profiling.tracing()
