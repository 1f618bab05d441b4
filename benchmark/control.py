"""Readings of the numbers that decide `correct`, over many seeds: the
program as the configuration states it, or with the configuration's
control switched on (``--control``: its "control" keys override the
parameter set, e.g. the bootstrap key's gadget one level shorter).  The
benchmark's own runs never run the control.

    python -m benchmark.control --workload <name> --seeds 1,2,3
        --seconds <s> [--control]

Each seed runs in a process of its own (a process joins one NCCL world:
joining a second after leaving the first crashes it), which prints one
JSON line on stdout: the seed, the checks, ``correct``, the requests
attempted; a run that raises, or a process that dies, is reported with
its error, as a control that crashes has failed.  ``--device cpu`` skips
the look for a card, for the tests only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, each a run")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--one", action="store_true",
                    help="run the one seed given in this process")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(_reading(cell, int(args.seeds), args)), flush=True)
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        proc = subprocess.run(
            [sys.executable, "-m", "benchmark.control", "--one",
             "--workload", cell.name, "--seeds", str(seed), "--seconds",
             str(args.seconds), "--device", args.device]
            + ["--control"] * args.control,
            cwd=harness.ROOT, stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if lines else json.dumps(
            {"workload": cell.name, "seed": seed, "correct": False,
             "error": f"exit code {proc.returncode}"}), flush=True)
    return 0


def _reading(cell, seed: int, args) -> dict:
    from benchmark import harness
    override = None
    if args.control:
        override = {k: v for k, v in cell.config["control"].items()
                    if k != "why"}
    line = {"workload": cell.name, "seed": seed, "control": override}
    try:
        res = harness.run_cell(cell, seed, args.seconds, False,
                               device=args.device, override=override)
        line.update(correct=res["correct"], attempted=res["attempted"],
                    failed=res["failed"], checks=res["checks"],
                    metrics=res["metrics"])
    except Exception as e:      # a crashed control has failed
        line.update(correct=False, error=f"{type(e).__name__}: {e}")
    return line


if __name__ == "__main__":
    sys.exit(main())
