#!/usr/bin/env python3
"""The torch port's bench with its WoPBS graphed and eager, and against
another checkout, on one card.

    python3 scripts/graph_ab.py [--blocks N] LABEL=ROOT[:eager] ...

Each argument is one run, in the order given, of ``python -m
tfhe_aes_tpu_torch.bench --blocks N --repeats 2 --decrypt 4`` (N: 64,
the bench's default, unless given) from the
checkout at ROOT (a directory that holds ``tfhe_aes_tpu_torch/``), all on
one key cache in a temporary directory (the first run's device keygen
saves the PARAM_TPU seed-0 keys, the others load them).  ``:eager`` runs
a checkout that has ``ops/graphs.py`` with its circuits dispatched
eagerly (``wopbs.many_wopbs_jit`` swapped for ``many_wopbs`` and, where
the checkout has them, the whole-function units of ``models/fhe_aes``
for the functions they graph: the dispatch of the checkouts before
graphs).  Pass the runs in turns (A, B,
B, A) to compare them on one card.  Prints every child's output, a JSON
line a run (the bench's first and warm key expansion, seconds a CTR batch
and blocks/min, decrypt seconds and blocks/min, peak device memory
allocated and, where the checkout prints it, reserved, then the whole
process's peak allocated and reserved) and
the median of each number by label.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from cold_start import _child, _env, _number  # noqa: E402

BENCH_ARGS = ["--repeats", "2", "--decrypt", "4"]

# Runs the bench as `python -m` does, optionally with every WoPBS eager,
# and prints the process's peak device memory when it ends (a checkout's
# bench may print allocated only).
RUNNER = """
import runpy, sys
import torch
if sys.argv[1] == "1":
    from tfhe_aes_tpu_torch.models import fhe_aes
    from tfhe_aes_tpu_torch.ops import wopbs
    wopbs.many_wopbs_jit = wopbs.many_wopbs
    for name in ("add_scalar_device", "ctr_step", "aes_encrypt",
                 "aes_decrypt", "aes_key_expansion"):
        if hasattr(fhe_aes, name + "_jit"):
            setattr(fhe_aes, name + "_jit", getattr(fhe_aes, name))
sys.argv = ["tfhe_aes_tpu_torch.bench"] + sys.argv[2:]
try:
    runpy.run_module("tfhe_aes_tpu_torch.bench", run_name="__main__",
                     alter_sys=True)
finally:
    print("# process peak device memory: allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB",
          file=sys.stderr)
"""

NUMBERS = {
    "key_expansion_first_s": r"key expansion \(first\): ([0-9.]+)s",
    "key_expansion_warm_s": r"key expansion \(warm\): ([0-9.]+)s",
    "ctr_s_per_batch": r"steady-state: ([0-9.]+)s/batch",
    "ctr_blocks_per_min": r'"value": ([0-9.]+)',
    "decrypt_s": r"homomorphic decrypt: ([0-9.]+)s",
    "decrypt_blocks_per_min": r"homomorphic decrypt: .* = ([0-9.]+) blocks",
    "peak_gib": r"peak device memory: ([0-9.]+) GiB",
    "peak_reserved_gib": r"peak device memory: .*\(reserved ([0-9.]+) GiB",
    "process_peak_gib": r"process peak device memory: allocated ([0-9.]+)",
    "process_peak_reserved_gib":
        r"process peak device memory: .* reserved ([0-9.]+) GiB",
}


def one_run(label: str, root: str, eager: bool, cache: str,
            blocks: int) -> dict:
    out, _ = _child(label, [sys.executable, "-c", RUNNER,
                            "1" if eager else "0", "--blocks", str(blocks)]
                    + BENCH_ARGS, root, _env(root, cache), (), 1200)
    if ("round-trip verified" not in out
            or f"# verified {blocks} blocks" not in out):
        raise RuntimeError(f"{label}: the bench did not verify its blocks")
    row = {"run": label, "eager": eager, "blocks": blocks}
    row.update({key: _number(pattern, out)
                for key, pattern in NUMBERS.items()})
    return row


def main(argv: list[str]) -> int:
    blocks = 64
    if argv[:1] == ["--blocks"]:
        blocks, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cache = tempfile.mkdtemp(prefix="tfhe_aes_graph_ab_")
    rows = []
    try:
        for arg in argv:
            label, _, rest = arg.partition("=")
            root, _, opt = rest.partition(":")
            if opt not in ("", "eager"):
                raise SystemExit(f"unknown option {opt!r} in {arg!r}")
            rows.append(one_run(label + (":eager" if opt else ""),
                                os.path.abspath(root), opt == "eager", cache,
                                blocks))
            print(json.dumps(rows[-1]), flush=True)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    print(f"# {smi}")
    for row in rows:
        print(json.dumps(row))
    for label in dict.fromkeys(row["run"] for row in rows):
        mine = [row for row in rows if row["run"] == label]
        medians = {key: statistics.median(row[key] for row in mine)
                   for key in NUMBERS
                   if all(row[key] is not None for row in mine)}
        print(f"# median of {len(mine)} {label}: {json.dumps(medians)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
