#!/usr/bin/env python3
"""Cold and warm start of the torch port's CLI on one card.

    python3 scripts/cold_start.py LABEL=ROOT[:no-zero-key-wopbs] ...

Each argument is one run, in the order given, of the checkout at ROOT (a
directory that holds ``tfhe_aes_tpu_torch/``): pass two commits in turns
(A, B, B, A) to compare them on one card.  A run copies the package into
a temporary directory without its ``_build/`` and with an empty key cache
(``TFHE_AES_TPU_CACHE``), then

  1. builds both kernels with nvcc one after the other in a fresh
     process, each timed (what a checkout without the warm-up pays inside
     its first WoPBS);
  2. on a fresh copy, runs ``python -m tfhe_aes_tpu_torch.cli --params
     tpu --seed 0 --number-of-outputs 2 --iv IV --key KEY`` twice: cold
     (nvcc, device keygen, the key-cache save) and warm (the built
     libraries, the saved keys), each timed from the start of its process,
     and from the line that names the parameters (after the imports), to
     the line that reports the verified blocks, with the first key
     expansion of each.

``:no-zero-key-wopbs`` runs the checkout with its warm-up's execution step
(utils/warmup._zero_key_wopbs) replaced by nothing: the builds and the
tiles alone.  Prints every child's output, a line a run, the table, and
the median of each number by label.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF
CLI_ARGS = ["--params", "tpu", "--seed", "0", "--number-of-outputs", "2",
            "--iv", hex(IV), "--key", hex(KEY)]

# Runs a module of the copied package as `python -m` does, optionally with
# the warm-up's execution step taken out.
RUNNER = """
import runpy, sys
module, no_exec = sys.argv[1], sys.argv[2] == "1"
if no_exec:
    from tfhe_aes_tpu_torch.utils import warmup
    warmup._zero_key_wopbs = lambda params, device: None
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""

BUILDS = """
import json, time
from tfhe_aes_tpu_torch.ops import cuda_build
out = {}
for name in ("blind_rotate", "vertical_packing"):
    t0 = time.perf_counter()
    cuda_build.load(name)
    out[name] = round(time.perf_counter() - t0, 2)
print(json.dumps(out))
"""


def _copy(root: str, into: str) -> str:
    shutil.copytree(os.path.join(root, "tfhe_aes_tpu_torch"),
                    os.path.join(into, "tfhe_aes_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return into


def _env(pkg_dir: str, cache: str) -> dict:
    return dict(os.environ, PYTHONPATH=pkg_dir, TFHE_AES_TPU_CACHE=cache,
                PYTHONUNBUFFERED="1")


def _child(label: str, cmd: list, cwd: str, env: dict, marks: tuple,
           timeout: float) -> tuple[str, list]:
    """Run cmd; echo its lines; (its output, for each of `marks` the
    seconds from its start to the first line containing it, None if none
    did).  Raises unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, at = [], [None] * len(marks)
    try:
        for line in proc.stdout:
            for i, mark in enumerate(marks):
                if at[i] is None and mark in line:
                    at[i] = time.perf_counter() - t0
            lines.append(line)
            print(f"  {label}: {line.rstrip()}", flush=True)
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: {' '.join(cmd[:4])} exited "
                           f"{proc.returncode}")
    return "".join(lines), at


def _number(pattern: str, text: str) -> float | None:
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


def one_run(label: str, root: str, no_exec: bool) -> dict:
    row = {"run": label, "zero_key_wopbs": not no_exec}
    work = tempfile.mkdtemp(prefix="tfhe_aes_cold_")
    try:
        builds = _copy(root, os.path.join(work, "builds"))
        out, _ = _child(f"{label} nvcc", [sys.executable, "-c", BUILDS],
                        builds, _env(builds, os.path.join(work, "c0")),
                        (), 900)
        row["nvcc_serial_s"] = json.loads(out.strip().splitlines()[-1])
        pkg = _copy(root, os.path.join(work, "pkg"))
        env = _env(pkg, os.path.join(work, "cache"))
        runner = [sys.executable, "-c", RUNNER]
        flag = "1" if no_exec else "0"
        for kind in ("cold", "warm"):
            out, (started, verified) = _child(
                f"{label} cli {kind}",
                runner + ["tfhe_aes_tpu_torch.cli", flag] + CLI_ARGS, pkg,
                env, ("[client] parameters", "[client] verified"), 900)
            row[f"{kind}_first_verified_s"] = verified
            # Without the interpreter's start and the imports, which vary
            # by seconds from one process to the next on a shared host.
            row[f"{kind}_params_to_verified_s"] = verified - started
            row[f"{kind}_keys_s"] = _number(
                r"\[client\] (?:device keygen \+ packing took|loaded cached "
                r"keys .* in) ([0-9.]+)s", out)
            row[f"{kind}_key_expansion_s"] = _number(
                r"AES key expansion took: ([0-9.]+)s", out)
            m = re.search(r"warm-up \(overlapped\): (\{.*\})", out)
            row[f"{kind}_warmup"] = m.group(1) if m else None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return row


def main(argv: list[str]) -> int:
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
        if opt not in ("", "no-zero-key-wopbs"):
            raise SystemExit(f"unknown option {opt!r} in {arg!r}")
        rows.append(one_run(label, os.path.abspath(root),
                            opt == "no-zero-key-wopbs"))
        print(json.dumps(rows[-1]), flush=True)
    print(f"# {smi}")
    for row in rows:
        print(json.dumps(row))
    for label in dict.fromkeys(row["run"] for row in rows):
        mine = [row for row in rows if row["run"] == label]
        medians = {key: statistics.median(row[key] for row in mine)
                   for key, value in mine[0].items()
                   if isinstance(value, float)
                   and all(row[key] is not None for row in mine)}
        print(f"# median of {len(mine)} {label}: {json.dumps(medians)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
