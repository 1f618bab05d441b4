"""What the benchmark's files must be: the import rules, BENCHMARK.json's
shape, every file found by name, the configurations against the port's
parameter sets, traffic fixed by the seed."""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest

from benchmark import generator, harness, reduce

HERE = harness.ROOT / "benchmark"
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported(path: pathlib.Path) -> set[str]:
    """The top-level names of the absolute imports of a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def py_files(folder: pathlib.Path) -> list[pathlib.Path]:
    return sorted(folder.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "tfhe_aes_tpu"}
    for path in py_files(HERE):
        assert not imported(path) & forbidden, path
    # Whole names: the port's name begins with the JAX package's.
    assert "tfhe_aes_tpu_torch" not in forbidden


def test_the_reference_imports_nothing_of_the_program():
    for path in py_files(HERE / "reference"):
        assert imported(path) <= {"__future__", "math", "numpy"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    assert "tfhe_aes_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_benchmark_json_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        names = [e["name"] for e in SPEC[part]]
        assert len(set(names)) == len(names)
        for e in SPEC[part]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "source", "layer"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_file_loads_by_name():
    used = set()
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert set(cell.traffic) >= {"blocks_per_request", "key_per_session",
                                     "rcon", "sessions", "checked_schedules",
                                     "trace_requests"}
        for m in cell.per_layer:
            assert callable(harness.metric_reader(cell, m["name"]))
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]


def test_each_metric_moves_what_its_cells_report():
    for m in SPEC["per_layer"]:
        for w in m["workloads"]:
            reported = {e["name"] for e in harness.load_cell(w).end_to_end}
            assert m["moves"] in reported, (m["name"], w)
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_metric_readers_read_nothing_from_an_empty_trace():
    empty = reduce.Trace([], [], (0.0, 1.0), {"rotate_s": 1.0, "vp_s": 1.0},
                         [])
    for m in SPEC["per_layer"]:
        cell = harness.load_cell(m["workloads"][0])
        assert harness.metric_reader(cell, m["name"])(empty) is None


def test_a_trace_counts_the_records_its_window_cuts_off():
    # The device's clock, mapped onto the host's, put a request's last
    # mark and copy past the host's end of the request on the card.
    events = [("bench:request", False, 1.0, 2.0),
              ("tfhe_mark", True, 1.1, 1.1001),
              ("tfhe_mark", True, 1.9995, 2.0003),
              ("tfhe_mark", True, 2.0004, 2.0005),
              ("Memcpy DtoH (Device -> Pageable)", True, 2.0006, 2.0016)]
    tr = reduce.from_profile(events, {}, [])
    assert tr.count("tfhe_mark") == 3
    assert [op[0] for op in tr.ops] == ["tfhe_mark"] * 2
    assert tr.window == (1.0, 2.0) and max(op[2] for op in tr.ops) == 2.0


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configs_agree_with_the_port(config):
    from tfhe_aes_tpu_torch import params as port_params
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    port = dataclasses.asdict(getattr(port_params, cfg["program_set"]))
    assert port.pop("name") == cfg["program_set"]
    assert cfg["params"] == port
    assert 0 < cfg["guarantees"]["p_fail"] < 1e-18
    control = {k: v for k, v in cfg["control"].items() if k != "why"}
    assert control == {"pbs_level": cfg["params"]["pbs_level"] - 1}


@pytest.mark.parametrize("traffic", ["bulk", "session"])
def test_traffic_is_fixed_by_the_seed(traffic):
    cfg = json.loads((HERE / "configs" / "param_opt.json").read_text())
    tr = dict(json.loads((HERE / "traffic" / f"{traffic}.json").read_text()))
    tr["sessions"] = min(tr["sessions"], 3)
    seed = 2 ** 31 + 12345
    a, b, c = (generator.make_inputs(cfg["params"], tr, s)
               for s in (seed, seed, seed + 1))
    for x, y in ((a, b), (a, c)):
        same = (np.array_equal(x.glwe_key, y.glwe_key)
                and x.keygen_seed == y.keygen_seed
                and all(np.array_equal(s.enc_key, t.enc_key)
                        and s.key == t.key and s.iv == t.iv
                        for s, t in zip(x.sessions, y.sessions)))
        assert same == (y is b)
    reqs = generator.requests(tr, a)
    first = [next(reqs) for _ in range(3)]
    if tr["key_per_session"]:
        assert [(r.session, r.offset) for r in first] == [(0, 0), (1, 0),
                                                          (2, 0)]
        # The first draw holds the sessions whose schedules are checked;
        # then requests name sessions not drawn yet, which the harness
        # draws.
        assert len(a.sessions) == max(3, 2 * tr["checked_schedules"])
        rest = [next(reqs) for _ in range(len(a.sessions) - 2)]
        assert rest[-1].session == len(a.sessions)
    else:
        n = tr["blocks_per_request"]
        assert [r.offset for r in first] == [n, 2 * n, 3 * n]
    assert a.sessions[0].enc_key.shape == (16, 8, 2049)
