"""A throwaway checkout for the CPU tests: the benchmark's files, plus a
toy configuration and toy traffic added as files alone, and a
BENCHMARK.json that names them.  The toy set has no security and is
never a cell of the benchmark."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark import harness

TOY_PARAMS = {
    "lwe_dimension": 8, "glwe_dimension": 2, "polynomial_size": 128,
    "lwe_noise_std": 2.0 ** -25, "glwe_noise_std": 2.0 ** -40,
    "pbs_base_log": 8, "pbs_level": 4, "ks_base_log": 4, "ks_level": 4,
    "pfks_base_log": 12, "pfks_level": 3, "cbs_base_log": 10,
    "cbs_level": 2, "message_modulus": 2, "carry_modulus": 1,
    "max_noise_level": 5}

TOY_CONFIG = {
    "name": "toy", "source": "tests only", "program_set": "PARAM_TOY",
    "params": TOY_PARAMS, "reduced": [],
    "guarantees": {"output": "AES-128-CTR", "p_fail": 2.0 ** -64,
                   "security_bits": 0},
    "control": {"pbs_level": 1, "why": "one level of 8 bits"}}

TRAFFIC = {
    "toy_bulk": {"blocks_per_request": 1, "key_per_session": False,
                 "rcon": "trivial", "sessions": 1, "checked_schedules": 1,
                 "trace_requests": 1},
    "toy_bulk4": {"blocks_per_request": 4, "key_per_session": False,
                  "rcon": "trivial", "sessions": 1, "checked_schedules": 1,
                  "trace_requests": 1},
    "toy_session": {"blocks_per_request": 1, "key_per_session": True,
                    "rcon": "trivial", "sessions": 2,
                    "checked_schedules": 1, "trace_requests": 1}}


def checkout(tmp: pathlib.Path) -> pathlib.Path:
    """tmp/ holding the benchmark's files, the toy configuration and
    traffic, and a BENCHMARK.json whose cells are the toy ones."""
    root = tmp / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark" / "configs" / "toy.json").write_text(
        json.dumps(TOY_CONFIG))
    for name, traffic in TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    cells = {"toy-bulk": "toy_bulk", "toy-bulk4": "toy_bulk4",
             "toy-session": "toy_session"}
    spec["workloads"] = [{"name": c, "config": "toy", "traffic": t,
                          "chips": 1, "why": "test"}
                         for c, t in cells.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            bulk = any("bulk" in w for w in m["workloads"])
            m["workloads"] = (["toy-bulk", "toy-bulk4"] if bulk
                              else ["toy-session"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
