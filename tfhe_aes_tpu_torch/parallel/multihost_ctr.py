"""Multi-process FHE-AES CTR over a device mesh, one device a process.

    python -m tfhe_aes_tpu_torch.parallel.multihost_ctr --procs N --blocks B
        [--params {dryrun,toy,toy512,prod,tpu}] [--mp M] [--seed S]
        [--shard-keys] [--scaling] [--pin-cores] [--timeout T]
        [--device {cuda,cpu}]
    torchrun --nproc-per-node N -m tfhe_aes_tpu_torch.parallel.multihost_ctr \\
        --blocks B ...

Counterpart of scripts/multihost_ctr.py.  Every rank owns a slice of the
global CTR batch (parallel/mesh.py, 'dp'), builds the global LUT stacks
and slices its own, gets rank 0's evaluation keys by broadcast (each rank
first makes them from the shared seed, or loads the key cache for prod
and tpu), optionally keeps only its 'mp' share of the keyswitch keys'
contraction rows (--shard-keys), and decrypt-verifies ITS OWN blocks
against plaintext AES.

Launcher mode (no RANK in the environment): spawns --procs workers on
127.0.0.1, echoes their JSON lines, prints
"# procs=N: X blocks/min, k/B blocks verified" (X: the B blocks over the
slowest rank's timed run), and with --scaling also
runs 1 process and prints the scaling JSON.  Under torchrun this module
is the worker.  On the card each rank takes cuda:LOCAL_RANK, over NCCL,
which refuses two ranks on one card: --procs must not exceed the cards.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import torch

# The directory that holds the package: the workers' working directory.
ROOT = pathlib.Path(__file__).resolve().parents[2]
IV = 0x99


def tiny_params():
    """PARAM_DRYRUN: the smallest set the whole CTR path runs at."""
    from ..params import ParamSet
    return ParamSet(
        name="PARAM_DRYRUN", lwe_dimension=8, glwe_dimension=1,
        polynomial_size=64, lwe_noise_std=2.0 ** -30,
        glwe_noise_std=2.0 ** -40, pbs_base_log=8, pbs_level=4,
        ks_base_log=4, ks_level=2, pfks_base_log=12, pfks_level=2,
        cbs_base_log=10, cbs_level=1)


def _params(name: str):
    from ..cli import PARAMS
    from ..params import PARAM_TOY_N512
    return {**PARAMS, "toy512": PARAM_TOY_N512}.get(name) or tiny_params()


def _launch_counts() -> dict:
    """The CUDA kernels' launch counters (see ops/cuda_*.py)."""
    from ..ops import cuda_blind_rotate, cuda_vp
    return {"blind_rotate": cuda_blind_rotate.blind_rotate_cuda,
            "vertical_packing": cuda_vp.vp_rotations_cuda}


def worker(args) -> None:
    import torch.distributed as dist

    from ..bench import device_record
    from ..cli import NIST_KEY as KEY
    from ..client.client import Client
    from ..models import aes_plain, fhe_aes
    from ..utils import profiling, serialization, torus
    from . import mesh as mesh_mod

    params = _params(args.params)
    m = mesh_mod.make_mesh(n_mp=args.mp, device=args.device)
    rank = dist.get_rank()
    client = Client(params, seed=args.seed)
    cache = serialization.cache_path(params, args.seed)
    if args.params in ("prod", "tpu") and cache.exists():
        client.sk, raw = serialization.load_keys(cache)
    else:
        raw = client.make_device_keys(device=m.device)
    dkeys = mesh_mod.shard_keys(m, raw, shard_contractions=args.shard_keys)
    del raw

    rks_plain = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    rks = torus.from_u64(
        [[client.encrypt_byte(b) for b in rk] for rk in rks_plain], m.device)
    enc_iv = torus.from_u64(client.encrypt_u128(IV), m.device)
    B = args.blocks
    lut_lsb, luts_rest = (torus.from_u64(x) for x in fhe_aes.add_scalar_luts(
        params, fhe_aes.counter_bytes(B)))
    fn = mesh_mod.sharded_ctr_fn(m, dkeys, B)

    print(f"# proc {rank}: keys staged", file=sys.stderr, flush=True)
    profiling.device_fence(fn(rks, enc_iv, lut_lsb, luts_rest)[0])   # warm
    dist.barrier()
    counters = _launch_counts() if m.device.type == "cuda" else {}
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    out, first = fn(rks, enc_iv, lut_lsb, luts_rest)
    profiling.device_fence(out)
    dt = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}

    # Every rank verifies the blocks it holds, on the host.
    client.fetch_and_verify_ctr(out, KEY, IV, offset=first)
    verified = list(range(first, first + out.shape[0]))
    record = {
        "process": rank, "procs": dist.get_world_size(), "blocks": B,
        "verified_local": verified, "seconds": round(dt, 3),
        "blocks_per_min": round(B / dt * 60.0, 2),
        "shard_keys": bool(args.shard_keys),
        "device": device_record(m.device)}
    if launches:
        record["launches"] = launches
    print(json.dumps(record), flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for MASTER_PORT)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_argv(args) -> list[str]:
    argv = ["--blocks", str(args.blocks), "--params", args.params,
            "--mp", str(args.mp), "--seed", str(args.seed),
            "--device", args.device]
    return argv + (["--shard-keys"] if args.shard_keys else [])


def _run_procs(args, procs: int, n_cores: int) -> list[dict]:
    """Run `procs` workers to their end; their JSON records."""
    port = free_port()
    children = []
    try:
        for rank in range(procs):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(procs),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(procs),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            cmd = [sys.executable, "-m", __spec__.name] + _worker_argv(args)
            if args.pin_cores:
                # One core per worker: the 1-process baseline then cannot
                # use every core, and the N-process efficiency measures the
                # per-process overhead at fixed hardware.
                cmd = ["taskset", "-c", str(rank % n_cores)] + cmd
            children.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, text=True, cwd=ROOT))
        deadline = time.monotonic() + args.timeout
        records = []
        for c in children:
            out, _ = c.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if c.returncode != 0:
                print(out, flush=True)
                raise RuntimeError(f"worker exited with {c.returncode}")
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            for ln in lines:
                print(ln, flush=True)
            records.extend(json.loads(ln) for ln in lines)
        return records
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()


def launch(args) -> int:
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass --device "
                               "cpu to run on the CPU")
        if args.procs > torch.cuda.device_count():
            raise ValueError(f"--procs {args.procs} exceeds the "
                             f"{torch.cuda.device_count()} card(s): NCCL "
                             f"refuses two ranks on one card")
    n_cores = os.cpu_count() or 1
    # The hardware parallelism the N-process run really gets: with more
    # pinned workers than cores, the ideal speedup is n_cores, not N.
    hw_par = min(args.procs, n_cores) if args.pin_cores else args.procs
    results = {}
    for procs in ([1, args.procs] if args.scaling else [args.procs]):
        records = _run_procs(args, procs, n_cores)
        verified = set()
        for r in records:
            verified.update(r["verified_local"])
        if verified != set(range(args.blocks)):
            raise AssertionError(f"verified {sorted(verified)} of "
                                 f"{args.blocks} blocks")
        # Each rank times its own slice: the slowest one sets the wall time.
        results[procs] = round(
            args.blocks / max(r["seconds"] for r in records) * 60.0, 2)
        print(f"# procs={procs}: {results[procs]:.2f} blocks/min, "
              f"{len(verified)}/{args.blocks} blocks verified", flush=True)
    if args.scaling:
        eff = results[args.procs] / (results[1] * hw_par)
        print(json.dumps({
            "metric": "multihost_scaling_efficiency",
            "procs": args.procs, "blocks": args.blocks,
            "hw_parallelism": hw_par,
            "blocks_per_min_1proc": results[1],
            "blocks_per_min_nproc": results[args.procs],
            "efficiency": round(eff, 3),
        }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tfhe_aes_tpu_torch.parallel.multihost_ctr",
        description="FHE AES-128 CTR over several processes")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--params",
                    choices=["dryrun", "toy", "toy512", "prod", "tpu"],
                    default="dryrun")
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-keys", action="store_true",
                    help="shard the KSK/PFPKSK contraction rows over 'mp' "
                         "(partial products all-reduced)")
    ap.add_argument("--scaling", action="store_true",
                    help="also run 1 process and report scaling efficiency")
    ap.add_argument("--pin-cores", action="store_true",
                    help="pin each worker to its own CPU core")
    ap.add_argument("--timeout", type=int, default=2400,
                    help="seconds the launcher waits for its workers")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: one card a rank over NCCL (fails without "
                         "one); cpu: gloo")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        worker(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
