"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line on stdout is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with --trace 1 its per-layer ones), ``device``, with --trace 1
``breakdown``, and last ``checks``, each number the reference compared
beside its limit.  Everything else goes to stderr, whose last lines are
those checks.  Without the cards, or with a JAX module loaded once the
window has closed, it exits non-zero and prints no result.  A cell whose
configuration has a "mesh" runs one process a card (benchmark/ranks.py):
this one is rank 0, and a rank that fails or loads JAX ends the run the
same way.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()        # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    # One write a line: a mesh cell's ranks log from threads too.
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def main(argv=None, device: str = "cuda") -> int:
    """device: "cpu" skips the look for cards and runs on the CPU, for
    the tests only."""
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count()} available")
        return 2
    log(f"# {cell.name}: seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device=device, t0=T0,
                              log=log)
    if device == "cuda":
        card = harness.card()
        log(f"# on {card['name']}, power limit {card['power_limit']}")
    leaked = harness.forbidden_modules()
    if leaked:
        log(f"the run loaded {', '.join(leaked)}: no result")
        return 3
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
