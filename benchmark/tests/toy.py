"""A throwaway checkout for the CPU tests: the benchmark's files, plus
toy configurations (one on a mesh of two ranks) and toy traffic (the
public-key RCON schedule and the inverse cipher among it) added as files
alone, and a BENCHMARK.json that names them.  The toy sets have no
security and are never a cell of the benchmark."""

from __future__ import annotations

import copy
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

# The multi-rank launcher's PARAM_DRYRUN (parallel/multihost_ctr.
# tiny_params), the smallest set the whole CTR path runs at: a mesh run
# pays a run a rank.
MESH_CONFIG = {
    **TOY_CONFIG, "name": "toy_mesh", "program_set": "PARAM_DRYRUN",
    "params": {**TOY_PARAMS, "glwe_dimension": 1, "polynomial_size": 64,
               "lwe_noise_std": 2.0 ** -30, "ks_level": 2, "pfks_level": 2,
               "cbs_level": 1},
    "mesh": {"dp": 2, "mp": 1, "shard_keys": False}}

TRAFFIC = {
    "toy_bulk": {"blocks_per_request": 1, "key_per_session": False,
                 "rcon": "trivial", "sessions": 1, "checked_schedules": 1,
                 "trace_requests": 1},
    "toy_bulk4": {"blocks_per_request": 4, "key_per_session": False,
                  "rcon": "trivial", "sessions": 1, "checked_schedules": 1,
                  "trace_requests": 1},
    "toy_session": {"blocks_per_request": 1, "key_per_session": True,
                    "rcon": "trivial", "sessions": 2,
                    "checked_schedules": 1, "trace_requests": 1},
    "toy_bulk2": {"blocks_per_request": 2, "key_per_session": False,
                  "rcon": "trivial", "sessions": 1, "checked_schedules": 1,
                  "trace_requests": 1},
    "toy_pk_session": {"blocks_per_request": 1, "key_per_session": True,
                       "rcon": "pk", "sessions": 2, "checked_schedules": 1,
                       "trace_requests": 1},
    "toy_decrypt": {"blocks_per_request": 2, "key_per_session": False,
                    "rcon": "trivial", "op": "decrypt", "sessions": 1,
                    "checked_schedules": 1, "trace_requests": 1}}

CELLS = {"toy-bulk": ("toy", "toy_bulk", 1),
         "toy-bulk4": ("toy", "toy_bulk4", 1),
         "toy-session": ("toy", "toy_session", 1),
         "toy-mesh": ("toy_mesh", "toy_bulk2", 2),
         "toy-pk-session": ("toy", "toy_pk_session", 1),
         "toy-decrypt": ("toy", "toy_decrypt", 1)}


def toy_cells(root: pathlib.Path, spec: dict, workload: str) -> list:
    """The toy cells that stand for a cell of the benchmark, by what its
    files under root hold: a configuration with a mesh the toy mesh;
    traffic of the inverse cipher the toy decrypt cell, with a key a
    session and public-key RCON the toy pk sessions, with a key a session
    the toy sessions, other traffic the toy bulk cells."""
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    if "mesh" in json.loads((root / config["file"]).read_text()):
        return ["toy-mesh"]
    traffic = json.loads((root / "benchmark" / "traffic" /
                          f"{w['traffic']}.json").read_text())
    if traffic.get("op", "ctr") == "decrypt":
        return ["toy-decrypt"]
    if traffic["key_per_session"]:
        return ["toy-pk-session"] if traffic["rcon"] == "pk" \
            else ["toy-session"]
    return ["toy-bulk", "toy-bulk4"]


def checkout(tmp: pathlib.Path, spec: dict | None = None) -> pathlib.Path:
    """tmp/ holding the benchmark's files, the toy configuration and
    traffic, and a BENCHMARK.json whose cells are the toy ones; spec: the
    BENCHMARK.json to start from (the repo's by default).  A metric of a
    real cell is a metric of the toy cells that stand for it."""
    root = tmp / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if spec is None:
        spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    for config in (TOY_CONFIG, MESH_CONFIG):
        (root / "benchmark" / "configs" / f"{config['name']}.json"
         ).write_text(json.dumps(config))
    for name, traffic in TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            toys = [t for w in m["workloads"]
                    for t in toy_cells(root, spec, w)]
            m["workloads"] = list(dict.fromkeys(toys))
    spec["workloads"] = [{"name": c, "config": cfg, "traffic": t,
                          "chips": chips, "why": "test"}
                         for c, (cfg, t, chips) in CELLS.items()]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
