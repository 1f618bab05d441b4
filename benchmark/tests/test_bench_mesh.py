"""A cell across ranks on the CPU: the toy mesh cell, two ranks over gloo
at PARAM_DRYRUN, through harness.run_cell: correct, with the ranks'
schedules equal word for word and both mesh metrics readable from what
the ranks report; its planted faults (a broadcast left out among them)
and its control not correct, the control also through benchmark.control,
a process a seed; a rank that raises ending benchmark.run with no result
line; a cell added as data alone reaching the toy checkout; and the rule
that a configuration's mesh fills its cells' chips.  A run takes ~30 s with
two torch threads a rank."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, ranks, reduce
from benchmark.tests import toy

SEED = 2 ** 32 + 7
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.checkout(tmp_path_factory.mktemp("mesh"))


@pytest.fixture
def few_threads(monkeypatch):
    """Two torch threads here and in every rank started from here."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _run(root, program, override=None):
    return harness.run_cell(harness.load_cell("toy-mesh", root), SEED, 0.01,
                            False, device="cpu", program=program,
                            override=override, log=lambda _: None)


class Recording(ranks.MeshPort):
    """The program as it is; rank 0 keeps what the ranks reported."""
    reported = []

    def collect(self):
        out = super().collect()
        if self.rank == 0:
            Recording.reported.append(out)
        return out


class OtherSlice(ranks.MeshPort):
    """Every rank computes rank 0's slice of each batch."""
    def _ctr_fn(self, keys):
        from tfhe_aes_tpu_torch.parallel import mesh as mesh_mod
        first = dataclasses.replace(self.mesh, dp_rank=0)
        return mesh_mod.sharded_ctr_fn(first, keys, self.blocks)


class OutOfOrder(ranks.MeshPort):
    """The ranks' blocks gathered last rank first."""
    def _gather(self, local):
        return super()._gather(local).roll(local.shape[0], 0)


class UnequalSchedule(ranks.MeshPort):
    """Rank 1 shows rank 0 a schedule one word off its own."""
    def _compare(self, rks):
        if self.rank == 1:
            rks = rks.clone()
            rks.view(-1)[0] += 1
        super()._compare(rks)


class NoBroadcast(ranks.MeshPort):
    """Every rank keeps the keys it made: nothing is broadcast."""
    def _stage(self, raw):
        return raw


class Raises(ranks.MeshPort):
    """Rank 1 raises at its first request of the window."""
    def _step(self, rks, enc_iv, blocks, offset):
        if self.rank == 1 and self.calls:
            raise RuntimeError("planted: rank 1 fails")
        return super()._step(rks, enc_iv, blocks, offset)


def test_mesh_cell_runs_correct_and_its_metrics_read(root, few_threads):
    res = _run(root, Recording)
    assert res["correct"] and (res["attempted"], res["failed"]) == (1, 0)
    assert res["checks"]["rank_schedule_words"] == {"value": 0, "limit": 0}
    assert res["checks"]["wrong_bits"]["value"] == 0
    assert set(res["metrics"]) == {"blocks_per_min", "peak_reserved_gib",
                                   "setup_s"}
    # One CTR call a rank in the window (the warm request's left out).
    call_s = Recording.reported[-1]["call_s"]
    assert [len(s) for s in call_s] == [1, 1] and min(map(min, call_s)) > 0
    cell = harness.load_cell("toy-mesh", root)
    assert {"gather_share.dp4", "rank_skew.dp4", "lut_build_s.dp4",
            "idle_share.bulk"} <= {m["name"] for m in cell.per_layer}
    read = {m["name"]: harness.metric_reader(cell, m["name"])
            for m in cell.per_layer}
    # A run on the CPU has no device records: both stay silent.
    cpu = reduce.Trace([], [("gather", 0.0, 1.0)], (0.0, 1.0), {}, [],
                       call_s)
    assert all(read[m](cpu) is None for m in ("gather_share.dp4",
                                              "rank_skew.dp4"))
    card = dataclasses.replace(cpu, ops=[
        ("tfhe::br_forward_mac_kernel<5>", 0.0, 0.75),
        ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
         0.75, 1.0)])
    assert read["gather_share.dp4"](card) == pytest.approx(25.0)
    medians = sorted(s[0] for s in call_s)
    assert read["rank_skew.dp4"](card) == pytest.approx(
        100 * (medians[1] - medians[0]) / medians[0])
    no_gather = dataclasses.replace(card, spans=[])
    assert read["gather_share.dp4"](no_gather) is None


@pytest.mark.parametrize("program", [OtherSlice, OutOfOrder,
                                     UnequalSchedule, NoBroadcast])
def test_planted_faults_are_not_correct(root, few_threads, program):
    res = _run(root, program)
    assert not res["correct"]
    words = res["checks"]["rank_schedule_words"]["value"]
    wrong = res["checks"]["wrong_bits"]["value"]
    if program is UnequalSchedule:
        assert (words, wrong, res["failed"]) == (1, 0, 0)
    elif program is NoBroadcast:
        # Rank 1's own keys: its schedule and its blocks are wrong.
        assert words > 0 and wrong > 0 and res["failed"] == 1
    else:
        assert words == 0 and wrong > 0 and res["failed"] == 1


def test_the_control_runs_a_process_a_seed(root, few_threads):
    """benchmark.control: one line a seed, each from a process of its
    own, the control not correct in each."""
    seeds = [SEED, SEED + 1]
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload",
         "toy-mesh", "--seeds", ",".join(map(str, seeds)), "--seconds",
         "0.01", "--control", "--device", "cpu"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(harness.ROOT)),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [x["seed"] for x in lines] == seeds
    for x in lines:
        assert x["control"] == {"pbs_level": 1} and not x["correct"]
        assert x["checks"]["noise_share"]["value"] > 1.0


def test_control_is_not_correct(root, few_threads):
    cell = harness.load_cell("toy-mesh", root)
    override = {k: v for k, v in cell.config["control"].items()
                if k != "why"}
    res = _run(root, None, override)
    assert not res["correct"]
    assert res["checks"]["noise_share"]["value"] > 1.0


def test_a_rank_that_raises_ends_the_run(root, few_threads):
    """benchmark.run past its look for cards, rank 1 raising: a non-zero
    exit, no result line, rank 1's error on stderr, well inside a run's
    limit."""
    code = ("import sys; from benchmark import run, ranks; "
            "from benchmark.tests.test_bench_mesh import Raises; "
            "ranks.MeshPort = Raises; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", "toy-mesh", "--seed",
         str(SEED), "--seconds", "0.01", "--trace", "0"], cwd=root,
        env=env, capture_output=True, text=True, timeout=300)
    assert time.monotonic() - t0 < 300
    assert proc.returncode != 0 and proc.stdout == ""
    assert "planted: rank 1 fails" in proc.stderr


def test_a_cell_added_as_data_gets_its_toy_cells(tmp_path):
    """A cell a later PR adds, named in metrics' workloads, needs no edit
    of the tests' toy checkout: its toy cells follow from its files."""
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"] += [
        {"name": "made-up-mesh", "config": "param_opt_dp4",
         "traffic": "bulk", "chips": 4, "why": "test"},
        {"name": "made-up-session", "config": "param_opt_dp4",
         "traffic": "session", "chips": 4, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("blocks_per_min", "idle_share.session"):
            m["workloads"].append("made-up-mesh")
        if m["name"] == "session_s":
            m["workloads"] = ["made-up-session"]
    root = toy.checkout(tmp_path, spec)
    assert harness.load_cell("toy-mesh", root).per_layer
    built = json.loads((root / "BENCHMARK.json").read_text())
    want = {"blocks_per_min": ["toy-bulk", "toy-bulk4", "toy-mesh"],
            "idle_share.session": ["toy-session", "toy-mesh"],
            "session_s": ["toy-mesh"]}
    for m in built["end_to_end"] + built["per_layer"]:
        if m["name"] in want:
            assert m["workloads"] == want[m["name"]], m["name"]


def test_a_mesh_fills_its_cells_chips():
    configs = {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
               for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        mesh = configs[w["config"]].get("mesh")
        want = mesh["dp"] * mesh["mp"] if mesh else 1
        assert w["chips"] == want, w["name"]
        if mesh:
            traffic = json.loads((harness.ROOT / "benchmark" / "traffic" /
                                  f"{w['traffic']}.json").read_text())
            assert not traffic["key_per_session"]
            assert traffic["blocks_per_request"] % mesh["dp"] == 0
