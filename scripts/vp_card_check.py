#!/usr/bin/env python3
"""The CUDA vertical-packing kernel alone on one NVIDIA card: build report,
words against the plain version, time a call, time by launch.

    python3 scripts/vp_card_check.py [--no-plain-at-size]

Random accumulators and random balanced GGSW residues stand in for a
circuit bootstrap (chip_smoke.py phase 2 runs the real one), so only the
plans' constant leaves are needed and the script takes under a minute:
  1. nvcc -Xptxas -v on csrc/vertical_packing.cu: registers, spills and
     static shared memory of every kernel;
  2. kernel == vp_rotations_plain, word for word, at two toy sets (k+1 = 3
     and 5, ragged groups and tiles) and at PARAM_TPU shapes of the AES
     paths, each timed with CUDA events (the mean of --reps calls after a
     warm-up) beside the plain version;
  3. torch.profiler over one call at 512 bytes x 24 outputs x 8 bits: the
     device time of each of the three launches a bit.
Exits non-zero on any difference.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tfhe_aes_tpu_torch.ops import (cuda_build, cuda_vp, keys, ntt,
                                    vertical_packing)
from tfhe_aes_tpu_torch.params import PARAM_TOY, PARAM_TPU
from tfhe_aes_tpu_torch.utils import torus

TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP", cbs_level=1,
                             cbs_base_log=15)
TOY_VP_K4 = dataclasses.replace(TOY_VP, name="PARAM_TOY_VP_K4",
                                glwe_dimension=4)


def constant_keys(params, dev):
    """A key set with the plans' constant leaves only."""
    plan = ntt.make_plan(params.polynomial_size)
    rplan = keys.make_rotate_plan(params)
    none = torch.zeros(1, dtype=torch.int8)
    return keys._keys_from_arrays(params, plan, rplan, dict(
        bsk_limbs=none, ksk_limbs=none, pfpksk_limbs=none)).to(dev)


def random_inputs(k, n_bytes, n_luts, nbits, dev):
    p = k.params
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    rng = np.random.default_rng(n_bytes * n_luts + nbits)
    acc = torus.from_u64(rng.integers(
        0, 1 << 64, (n_bytes, n_luts, kp1, n), dtype=np.uint64), dev)
    ggsw = torch.stack([torch.from_numpy(rng.integers(
        -(q - 1) // 2, (q - 1) // 2 + 1, (nbits, n_bytes, kp1, kp1, n)
    ).astype(np.int32)) for q in k.plan.primes], dim=1).to(dev)
    return acc, ggsw


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-plain-at-size", action="store_true",
                    help="compare with the plain version at the toy sets "
                         "and the smallest PARAM_TPU shape only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vp_card_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", f"{tmp}/vp.so", str(cuda_build.CSRC / "vertical_packing.cu")],
            capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr)
        return 1
    name = ""
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name[:48]}: {line.split(':')[-1].strip()}")
        elif "warning" in line.lower() or "wgmma" in line:
            print(f"nvcc: {line.strip()}")

    cases = [(TOY_VP, 7, 9, 7), (TOY_VP_K4, 5, 9, 7), (TOY_VP_K4, 3, 24, 7),
             (PARAM_TPU, 4, 8, 8), (PARAM_TPU, 16, 16, 8),
             (PARAM_TPU, 32, 9, 9), (PARAM_TPU, 64, 32, 8),
             (PARAM_TPU, 512, 8, 8), (PARAM_TPU, 512, 24, 8)]
    keysets = {}
    for params, n_bytes, n_luts, nbits in cases:
        if params.name not in keysets:
            keysets[params.name] = constant_keys(params, dev)
        k = keysets[params.name]
        acc, ggsw = random_inputs(k, n_bytes, n_luts, nbits, dev)
        ms = event_ms(lambda: cuda_vp.vp_rotations_cuda(k, acc, ggsw),
                      args.reps)
        line = (f"{params.name} {n_bytes} B x {n_luts} outputs x {nbits} "
                f"bits: kernel {ms:.3f} ms")
        if not args.no_plain_at_size or n_bytes * n_luts <= 64:
            got = cuda_vp.vp_rotations_cuda(k, acc, ggsw)
            want = vertical_packing.vp_rotations_plain(k, acc, ggsw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()
                print(f"{line}: DIFFERS from the plain version at "
                      f"{bad.shape[0]} words, first {bad[0].tolist()}")
                return 1
            line += ", == plain"
        print(line)

    from torch.profiler import ProfilerActivity, profile
    k = keysets[PARAM_TPU.name]
    acc, ggsw = random_inputs(k, 512, 24, 8, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_vp.vp_rotations_cuda(k, acc, ggsw)
        torch.cuda.synchronize()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    for e in sorted(prof.key_averages(), key=dev_ms, reverse=True)[:6]:
        print(f"profile 512 B x 24 x 8 bits: {dev_ms(e):8.3f} ms "
              f"x{e.count:<3} {e.key[:60]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
