"""The harness on the CPU: a throwaway cell added by files alone and run
end to end through the port at a toy set, its control and its faults
seen as not correct, and the measuring path refusing to run without a
card.  The end-to-end runs take a few minutes each with two torch threads
(the port's plain CPU paths)."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generator, harness, run
from benchmark.reference import aes, lwe
from benchmark.tests import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> pathlib.Path:
    return toy.checkout(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def few_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _run(root, cell, trace=False, seconds=0.01, **kw):
    lines = []
    res = harness.run_cell(harness.load_cell(cell, root), 2 ** 32 + 7,
                           seconds, trace, device="cpu", log=lines.append,
                           **kw)
    return res, lines


def test_bulk_cell_runs_end_to_end_traced(root, few_threads):
    res, lines = _run(root, "toy-bulk", trace=True)
    assert res["correct"] and (res["attempted"], res["failed"]) == (1, 0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["checks"]["wrong_bits"] == {"value": 0, "limit": 0}
    assert 0 < res["checks"]["noise_share"]["value"] < 0.2
    # The CPU has no device records: every device metric stays silent.
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert any("traced records" in line for line in lines)
    json.dumps(res)


def test_session_cell_runs_end_to_end(root, few_threads):
    res, _ = _run(root, "toy-session")
    assert res["correct"] and res["attempted"] == 1
    assert set(res["metrics"]) == {"session_s", "peak_reserved_gib",
                                   "setup_s"}
    assert res["metrics"]["session_s"]["unit"] == "s"


def test_control_is_not_correct(root, few_threads):
    cell = harness.load_cell("toy-bulk", root)
    override = {k: v for k, v in cell.config["control"].items()
                if k != "why"}
    res, _ = _run(root, "toy-bulk", override=override)
    assert not res["correct"]
    assert res["checks"]["noise_share"]["value"] > 1.0


class Oracle:
    """A stand-in for the program that answers right: plain AES under the
    inputs' keys, freshly encrypted; the faults below break it."""

    def __init__(self, config, device, override=None):
        self.device = torch.device("cpu")
        self.std = config["params"]["glwe_noise_std"]

    def start(self, inputs, traffic, log):
        self.key = inputs.big_key
        self.rng = np.random.default_rng(1)

    def _plain(self, cts) -> int:
        bits = ((cts[..., -1] - cts[..., :-1] @ self.key + np.uint64(1 << 62))
                >> np.uint64(63)).astype(np.int64)
        return int.from_bytes(bytes((bits << np.arange(8)).sum(-1)
                                    .astype(np.uint8)), "big")

    def _enc(self, byts):
        return lwe.encrypt_bits(self.key, aes.bits_of(byts), self.std,
                                self.rng)

    def upload(self, cts):
        return cts

    def key_expansion(self, enc_key):
        return (self._plain(enc_key), self._enc(aes.key_expansion(
            self._plain(enc_key))))

    def keystream(self, rks, enc_iv, blocks, offset):
        return self._enc(aes.ctr_keystream(rks[0], self._plain(enc_iv),
                                           offset, blocks))

    def fetch(self, t):
        return t[1] if isinstance(t, tuple) else t

    def fence(self):
        pass

    def counters(self):
        return {"rotate_calls": 0, "vp_calls": 0, "captures": 0}

    def memory_peak(self):
        return 0

    def close(self):
        pass


class Unchanged(Oracle):
    def keystream(self, rks, enc_iv, blocks, offset):
        return np.broadcast_to(enc_iv, (blocks,) + enc_iv.shape).copy()


class HalfBatch(Oracle):
    def keystream(self, rks, enc_iv, blocks, offset):
        out = super().keystream(rks, enc_iv, blocks, offset)
        out[blocks // 2:] = out[:blocks - blocks // 2]
        return out


class Altered(Oracle):
    def keystream(self, rks, enc_iv, blocks, offset):
        out = super().keystream(rks, enc_iv, blocks, offset)
        out[-1, 3, 5, -1] ^= np.uint64(1 << 63)
        return out


class SameSchedule(Oracle):
    """Round keys that are the key itself, every round."""
    def key_expansion(self, enc_key):
        key, _ = super().key_expansion(enc_key)
        return key, self._enc(np.tile(aes.to_bytes(key), (11, 1)))


# The session cell's batch is one block: it has no half to leave out.
@pytest.mark.parametrize("cell, program, correct", [
    ("toy-bulk4", Oracle, True), ("toy-bulk4", Unchanged, False),
    ("toy-bulk4", HalfBatch, False), ("toy-bulk4", Altered, False),
    ("toy-bulk4", SameSchedule, False), ("toy-session", Oracle, True),
    ("toy-session", Unchanged, False), ("toy-session", Altered, False),
    ("toy-session", SameSchedule, False)])
def test_faults_are_not_correct(root, cell, program, correct):
    res, _ = _run(root, cell, program=program)
    assert res["correct"] is correct
    assert (res["checks"]["wrong_bits"]["value"] == 0) is correct
    keystream_fault = program not in (Oracle, SameSchedule)
    assert res["failed"] == (res["attempted"] if keystream_fault else 0)


def test_sessions_drawn_in_the_window_are_left_out_of_it(root):
    """A window longer than the sessions drawn in set-up draws more, the
    same ones a seed gives in one draw, and leaves that time out."""
    res, lines = _run(root, "toy-session", program=Oracle, seconds=0.5)
    assert res["correct"] and res["attempted"] > 2
    window = [line for line in lines if line.startswith("# window:")][0]
    assert float(window.split("; ")[-1].split()[0]) > 0
    cell = harness.load_cell("toy-session", root)
    inputs = generator.make_inputs(cell.config["params"], cell.traffic, 5)
    assert len(inputs.sessions) == 2
    inputs.draw(2)
    once = generator.make_inputs(cell.config["params"],
                                 {**cell.traffic, "sessions": 4}, 5)
    assert [(s.key, s.iv) for s in inputs.sessions] == \
        [(s.key, s.iv) for s in once.sessions]
    assert all(np.array_equal(a.enc_key, b.enc_key)
               for a, b in zip(inputs.sessions, once.sessions))


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only refusal")
    rc = run.main(["--workload", "opt-ctr-bulk16", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_cell(harness.load_cell("opt-ctr-bulk16"), 1, 1.0, False,
                         device="cuda", log=lambda _: None)


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    for part in ("benchmark", "BENCHMARK.json"):
        src = harness.ROOT / part
        if src.is_dir():
            subprocess.run(["cp", "-r", str(src), str(tmp_path)], check=True)
        else:
            (tmp_path / part).write_text(src.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "opt-session-1blk", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
