#!/usr/bin/env python3
"""The torch port's multi-process CTR launcher on one card, against
another checkout.

    python3 scripts/mesh_ab.py [--blocks N] LABEL=ROOT[:shard] ...

Each argument is one run, in the order given, of ``python -m
tfhe_aes_tpu_torch.parallel.multihost_ctr --procs 1 --blocks N --params
tpu --seed 0`` (N: 8 unless given) from the checkout at ROOT (a directory
that holds ``tfhe_aes_tpu_torch/``): one rank over NCCL, its keys made by
device keygen from seed 0 (an empty key cache in a temporary directory).
``:shard`` adds ``--shard-keys``: the keys' contraction rows over the
one-rank 'mp' group, every keyswitch product all-reduced over it.  Pass
the runs in turns (A, B, B, A) to compare them on one card.  Prints every
child's output, a JSON line a run (the timed run's seconds and
blocks/min; where the checkout prints them, the untimed first call's
seconds and the rank's peak device memory) and the median of each number
by label.  Needs a CUDA card and nvcc.
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

NUMBERS = {
    "timed_s": r'"seconds": ([0-9.]+)',
    "blocks_per_min": r"# procs=1: ([0-9.]+) blocks/min",
    "first_call_s": r"first call ([0-9.]+) s",
    "peak_gib": r"peak device memory ([0-9.]+) GiB",
    "peak_reserved_gib": r"peak device memory .*\(reserved ([0-9.]+)\)",
}


def one_run(label: str, root: str, shard: bool, blocks: int) -> dict:
    cache = tempfile.mkdtemp(prefix="tfhe_aes_mesh_ab_")
    try:
        cmd = [sys.executable, "-m",
               "tfhe_aes_tpu_torch.parallel.multihost_ctr", "--procs", "1",
               "--blocks", str(blocks), "--params", "tpu", "--seed", "0",
               "--timeout", "900"] + (["--shard-keys"] if shard else [])
        out, _ = _child(label, cmd, root, _env(root, cache), (), 1000)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    if f"{blocks}/{blocks} blocks verified" not in out:
        raise RuntimeError(f"{label}: the launcher did not verify its "
                           f"blocks")
    row = {"run": label, "shard_keys": shard, "blocks": blocks}
    row.update({key: _number(pattern, out)
                for key, pattern in NUMBERS.items()})
    return row


def main(argv: list[str]) -> int:
    blocks = 8
    if argv[:1] == ["--blocks"]:
        blocks, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for arg in argv:
        label, _, rest = arg.partition("=")
        root, _, opt = rest.partition(":")
        if opt not in ("", "shard"):
            raise SystemExit(f"unknown option {opt!r} in {arg!r}")
        rows.append(one_run(label + (":shard" if opt else ""),
                            os.path.abspath(root), opt == "shard", blocks))
        print(json.dumps(rows[-1]), flush=True)
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
