"""The harness on the CPU: throwaway cells added by files alone (CTR, the
public-key RCON schedule, the inverse cipher) and run end to end through
the port at a toy set, their control and their faults seen as not
correct, traffic the harness does not drive refused, and the measuring
path refusing to run without a card.  The end-to-end runs take one to
three minutes each with two torch threads (the port's plain CPU
paths)."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

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
    inputs' keys, freshly encrypted; the faults below break it, each in
    the answer it makes from what it was given (fault)."""

    def __init__(self, config, device, override=None):
        self.device = torch.device("cpu")
        self.std = config["params"]["glwe_noise_std"]

    def start(self, inputs, traffic, log):
        self.key = inputs.big_key
        self.rng = np.random.default_rng(1)

    def _bytes(self, cts) -> np.ndarray:
        bits = ((cts[..., -1] - cts[..., :-1] @ self.key + np.uint64(1 << 62))
                >> np.uint64(63)).astype(np.int64)
        return (bits << np.arange(8)).sum(-1).astype(np.uint8)

    def _plain(self, cts) -> int:
        return int.from_bytes(bytes(self._bytes(cts)), "big")

    def _enc(self, byts):
        return lwe.encrypt_bits(self.key, aes.bits_of(byts), self.std,
                                self.rng)

    def upload(self, cts):
        return cts

    def key_expansion(self, enc_key):
        return (self._plain(enc_key), self._enc(aes.key_expansion(
            self._plain(enc_key))))

    def keystream(self, rks, enc_iv, blocks, offset):
        return self.fault(self._enc(aes.ctr_keystream(
            rks[0], self._plain(enc_iv), offset, blocks)),
            np.broadcast_to(enc_iv, (blocks,) + enc_iv.shape).copy())

    def decrypt(self, rks, blocks):
        return self.fault(self._enc(aes.decrypt_blocks(
            aes.key_expansion(rks[0]), self._bytes(blocks))), blocks.copy())

    def fault(self, out, given):
        return out

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
    def fault(self, out, given):
        return given


class HalfBatch(Oracle):
    def fault(self, out, given):
        n = out.shape[0]
        out[n // 2:] = out[:n - n // 2]
        return out


class Altered(Oracle):
    def fault(self, out, given):
        out[-1, 3, 5, -1] ^= np.uint64(1 << 63)
        return out


class Swapped(Oracle):
    """The first two blocks of an answer in each other's place."""
    def fault(self, out, given):
        return out[[1, 0] + list(range(2, out.shape[0]))]


class Encrypted(Oracle):
    """The cipher answered in place of the inverse cipher."""
    def decrypt(self, rks, blocks):
        return self._enc(aes.encrypt_blocks(aes.key_expansion(rks[0]),
                                            self._bytes(blocks)))


class SameSchedule(Oracle):
    """Round keys that are the key itself, every round."""
    def key_expansion(self, enc_key):
        key, _ = super().key_expansion(enc_key)
        return key, self._enc(np.tile(aes.to_bytes(key), (11, 1)))


# The session cells' batch is one block: it has no half to leave out.
@pytest.mark.parametrize("cell, program, correct", [
    ("toy-bulk4", Oracle, True), ("toy-bulk4", Unchanged, False),
    ("toy-bulk4", HalfBatch, False), ("toy-bulk4", Altered, False),
    ("toy-bulk4", SameSchedule, False), ("toy-session", Oracle, True),
    ("toy-session", Unchanged, False), ("toy-session", Altered, False),
    ("toy-session", SameSchedule, False),
    ("toy-pk-session", Oracle, True), ("toy-pk-session", Altered, False),
    ("toy-pk-session", SameSchedule, False),
    ("toy-decrypt", Oracle, True), ("toy-decrypt", Unchanged, False),
    ("toy-decrypt", HalfBatch, False), ("toy-decrypt", Altered, False),
    ("toy-decrypt", Swapped, False), ("toy-decrypt", Encrypted, False),
    ("toy-decrypt", SameSchedule, False)])
def test_faults_are_not_correct(root, cell, program, correct):
    res, _ = _run(root, cell, program=program)
    assert res["correct"] is correct
    assert (res["checks"]["wrong_bits"]["value"] == 0) is correct
    answer_fault = program not in (Oracle, SameSchedule)
    assert res["failed"] == (res["attempted"] if answer_fault else 0)


@pytest.mark.parametrize("cell", ["toy-pk-session", "toy-decrypt"])
def test_new_circuit_cells_run_end_to_end_traced(root, few_threads, cell):
    """The public-key RCON schedule and the inverse cipher, through the
    port, traced: correct, and the traced work priced from the traffic."""
    res, lines = _run(root, cell, trace=True)
    assert res["correct"] and (res["attempted"], res["failed"]) == (1, 0)
    assert res["checks"]["wrong_bits"] == {"value": 0, "limit": 0}
    assert 0 < res["checks"]["noise_share"]["value"] < 0.2
    want = {"toy-pk-session": 30 + 26, "toy-decrypt": 19}[cell]
    assert any(f"of {want} in the work" in line for line in lines), lines


class ForeignRcon(harness.Port):
    """The program with RCON encrypted under the public key of another
    client's secret key."""

    def start(self, inputs, traffic, log):
        from tfhe_aes_tpu_torch.client.client import Client
        super().start(inputs, traffic, log)
        self.server.public_key = Client(self.params, seed=1).make_public_key()


def test_rcon_under_another_key_is_not_correct(root, few_threads):
    res, _ = _run(root, "toy-pk-session", program=ForeignRcon)
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["wrong_bits"]["value"] > 0


@pytest.mark.parametrize("cell", ["toy-pk-session", "toy-decrypt"])
def test_control_is_not_correct_on_the_new_circuits(root, few_threads, cell):
    override = {k: v for k, v in harness.load_cell(
        cell, root).config["control"].items() if k != "why"}
    res, _ = _run(root, cell, override=override)
    assert not res["correct"]
    assert res["checks"]["noise_share"]["value"] > 1.0


def _with_traffic(root, tmp_path, traffic: dict, config="toy"):
    """A copy of the toy checkout with one more cell, on `traffic`."""
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    (copy / "benchmark" / "traffic" / "extra.json").write_text(
        json.dumps(traffic))
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "extra", "config": config,
                              "traffic": "extra", "chips": 1, "why": "t"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    return copy


@pytest.mark.parametrize("config, change", [
    ("toy", {"rcon": "public"}), ("toy", {"op": "encrypt"}),
    ("toy_mesh", {"rcon": "pk"}), ("toy_mesh", {"op": "decrypt"}),
    ("toy_mesh", {"key_per_session": True})])
def test_traffic_it_does_not_drive_is_refused(root, tmp_path, config,
                                              change):
    traffic = {**toy.TRAFFIC["toy_bulk2"], **change}
    copy = _with_traffic(root, tmp_path, traffic, config)
    with pytest.raises(ValueError):
        harness.load_cell("extra", copy)
    if config == "toy":
        with pytest.raises(ValueError):
            generator.make_inputs(toy.TOY_PARAMS, traffic, 1)


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


def test_a_cell_names_an_end_to_end_metric_of_its_own(root, tmp_path,
                                                     few_threads):
    """An end-to-end metric "<quantity>.<suffix>", added to BENCHMARK.json
    alone, reads the quantity in the cells it lists and in no other."""
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "session_s.pk", "unit": "s",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["toy-pk-session"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    res, lines = _run(copy, "toy-pk-session", program=Oracle)
    assert res["correct"] and set(res["metrics"]) == {
        "session_s.pk", "peak_reserved_gib", "setup_s"}
    window = [line for line in lines if line.startswith("# window:")][0]
    took = float(window.split("blocks in ")[1].split()[0])
    assert res["metrics"]["session_s.pk"]["unit"] == "s"
    assert res["metrics"]["session_s.pk"]["value"] == pytest.approx(
        took / res["attempted"], abs=1e-4)
    assert "session_s.pk" not in _run(copy, "toy-session",
                                      program=Oracle)[0]["metrics"]


def test_decrypt_inputs_are_made_outside_the_window(root, monkeypatch):
    """A decrypt request's ciphertexts are the benchmark's work: made
    before the request's clock starts, and left out of the window."""
    made = generator.ciphertexts

    def slow(session, req):
        time.sleep(0.3)
        return made(session, req)

    monkeypatch.setattr(generator, "ciphertexts", slow)
    res, lines = _run(root, "toy-decrypt", program=Oracle)
    assert res["correct"]
    window = [line for line in lines if line.startswith("# window:")][0]
    took, rest = window.split("blocks in ")[1].split(" s; a request median ")
    assert float(rest.split()[0]) < 0.3 and float(took) < 0.3
    assert float(window.split("; ")[-1].split()[0]) >= \
        0.3 * res["attempted"]


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


def test_decrypt_inputs_are_fixed_by_the_seed():
    """A decrypt request's plaintexts come from the seed, one stream of
    their own; its input is their AES-128 ciphertext, noiseless."""
    tr = toy.TRAFFIC["toy_decrypt"]
    a, b, c = (generator.make_inputs(toy.TOY_PARAMS, tr, s)
               for s in (2 ** 40 + 3, 2 ** 40 + 3, 2 ** 40 + 4))
    first = [[r.plain for r in [x.warm_request] + [
        next(reqs) for reqs in [generator.requests(tr, x)] for _ in range(3)]]
        for x in (a, b, c)]
    assert all(np.array_equal(p, q) for p, q in zip(first[0], first[1]))
    assert not any(np.array_equal(p, q) for p, q in zip(first[0], first[2]))
    assert len({p.tobytes() for p in first[0]}) == 4
    assert first[0][0].shape == (2, 16) and first[0][0].dtype == np.uint8
    enc = generator.ciphertexts(a.warm, a.warm_request)
    assert enc.shape == (2, 16, 8, 257) and not enc[..., :-1].any()
    cts = ((enc[..., -1] >> np.uint64(63)).astype(np.uint8)
           << np.arange(8, dtype=np.uint8)).sum(-1).astype(np.uint8)
    assert np.array_equal(aes.decrypt_blocks(aes.key_expansion(a.warm.key),
                                             cts), first[0][0])
