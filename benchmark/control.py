"""Readings of the numbers that decide `correct`, over many seeds in one
process: the program as the configuration states it, or with the
configuration's control switched on (``--control``: its "control" keys
override the parameter set, e.g. the bootstrap key's gadget one level
shorter).  The benchmark's own runs never run the control.

    python -m benchmark.control --workload <name> --seeds 1,2,3
        --seconds <s> [--control]

One JSON line a seed on stdout: the seed, the checks, ``correct``, the
requests attempted; a run that raises is reported with its error, as a
control that crashes has failed.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, each a run")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    override = None
    if args.control:
        override = {k: v for k, v in cell.config["control"].items()
                    if k != "why"}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": cell.name, "seed": seed, "control": override}
        try:
            res = harness.run_cell(cell, seed, args.seconds, False,
                                   override=override)
            line.update(correct=res["correct"], attempted=res["attempted"],
                        failed=res["failed"], checks=res["checks"],
                        metrics=res["metrics"])
        except Exception as e:      # a crashed control has failed
            line.update(correct=False, error=f"{type(e).__name__}: {e}")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
