"""A cell across ranks: one process a card, through the port's multi-rank
path (tfhe_aes_tpu_torch/parallel/mesh.py), composed as
parallel/multihost_ctr.worker composes it.

A configuration with ``"mesh": {"dp": D, "mp": M, "shard_keys": bool}``
runs on D x M ranks.  The process the benchmark started is rank 0: its
program is ``MeshPort``, which harness.run_cell drives as it drives Port.
Rank 0 starts the others,

    python -m benchmark.ranks --root <checkout> --workload <cell>
        --seed <n> --trace <0|1> --device <cuda|cpu>
        --program <module:class> [--override <json>]

with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set, and
copies their output to its stderr, each line behind its rank.  Every rank
draws the run's inputs from the seed and makes device keys: rank 0 from
the benchmark's secret keys, the others from secret keys of their own,
drawn from the seed and the rank, so that only the keys rank 0 broadcasts
(mesh.shard_keys) decrypt under the judge's key.  Every rank runs the
session's key schedule (Server.aes_key_expansion); the ranks' schedules
are compared word for word.  Rank 0 owns the clock: before each
step it tells the others what to run over a gloo group on the host, so
nothing is added to the card's stream.  A request builds the global
counter LUTs on every rank, runs mesh.sharded_ctr_fn (captured at its
first call, replayed after) and mesh.gather_blocks; rank 0 returns the
gathered blocks.  In a traced run every rank profiles the window's first
requests, its profiler started once set-up's request is done.  After the
window every rank reports its memory peak, the device seconds of its
window's CTR calls (CUDA events around each), its traced busy seconds and
the JAX modules it holds, and the ranks above 0 exit.

A rank that exits before it is told to, or a step that outlasts its
limit, ends the run: rank 0 kills every rank and exits non-zero with no
result line.  A rank whose rank 0 is gone exits.  A mesh cell streams one
session: its traffic has ``key_per_session`` false.
"""

from __future__ import annotations

import argparse
import atexit
import functools
import importlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from . import generator, harness, reduce
from .reference import lwe

STOP, KEYEXP, KEYSTREAM = 0, 1, 2
SETUP_LIMIT_S = 1100     # set-up, a checkout's first build included
STEP_LIMIT_S = 300       # each later step; a request takes ~11 s
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
       "MASTER_ADDR", "MASTER_PORT")


class MeshPort(harness.Port):
    """The program on one rank of the cell's mesh, cuda:<rank> on the
    card.  Rank 0 also starts, watches and stops the others."""

    def __init__(self, config: dict, device, override: dict | None = None,
                 *, cell: harness.Cell, seed: int, trace: bool,
                 rank: int = 0):
        super().__init__(config, device, override)
        self.layout = config["mesh"]
        self.world = self.layout["dp"] * self.layout["mp"]
        self.cell, self.seed, self.trace, self.rank = cell, seed, trace, rank
        self.override = override
        if self.device.type == "cuda":
            # The card mesh.make_mesh takes: cuda:LOCAL_RANK.
            self.device = torch.device("cuda", rank)
            torch.cuda.set_device(self.device)
        self.children = {}        # rank -> Popen (rank 0)
        self.calls = []           # (start, end) of each CTR call
        self.traced = None        # (busy s, window s) of a traced request
        self.schedule_words = None
        self._stopped = False
        self._closing = threading.Event()
        self._threads = []
        self._deadline = time.monotonic() + SETUP_LIMIT_S
        self._env = {}

    # -- set-up ----------------------------------------------------------

    def start(self, inputs: generator.Inputs, traffic: dict, log) -> None:
        """Start the other ranks (rank 0), then on every rank, as
        multihost_ctr.worker composes it: device keys on this rank's card
        (the benchmark's secret keys on rank 0, a rank's own elsewhere),
        the mesh, rank 0's keys staged, the mesh function.  Rank 0 runs
        utils/warmup.precompile beside its keygen; the others do not: its
        threads run on the thread's default card, cuda:0, whatever the
        rank's."""
        from tfhe_aes_tpu_torch.backend.numpy_backend import SecretKeys
        from tfhe_aes_tpu_torch.client.client import Client
        from tfhe_aes_tpu_torch.parallel import mesh as mesh_mod
        from tfhe_aes_tpu_torch.server import Server
        from tfhe_aes_tpu_torch.utils import warmup
        if traffic["key_per_session"]:
            raise ValueError("a mesh cell streams one session: its traffic "
                             "needs key_per_session false")
        self.log, self.inputs = log, inputs
        self.blocks = traffic["blocks_per_request"]
        self.trace_requests = traffic["trace_requests"]
        t0 = time.perf_counter()
        warm = None
        if self.rank == 0:
            self._spawn(log)
            warm = warmup.precompile(self.params, self.blocks,
                                     device=self.device)
            lwe_key, glwe_key = inputs.lwe_key, inputs.glwe_key
        else:
            p = self.params
            lwe_key, glwe_key = lwe.draw_secret_keys(
                np.random.default_rng([self.seed % (1 << 128), self.rank]),
                p.lwe_dimension, p.glwe_dimension, p.polynomial_size)
        client = Client(self.params, seed=inputs.keygen_seed)
        client.sk = SecretKeys(self.params, lwe_key, glwe_key)
        raw = client.make_device_keys(device=self.device)
        self.fence()
        t_keys = time.perf_counter() - t0
        report = warm.join() if warm is not None else "none"
        log(f"# rank {self.rank}: keys on the device in {t_keys:.3f} s; "
            f"warm-up {report}")
        t0 = time.perf_counter()
        self.mesh = mesh_mod.make_mesh(n_dp=self.layout["dp"],
                                       n_mp=self.layout["mp"],
                                       device=self.device.type)
        if self.mesh.device != self.device:
            raise RuntimeError(f"rank {self.rank}: the mesh put it on "
                               f"{self.mesh.device}, not {self.device}")
        self.ctrl = dist.new_group(backend="gloo")
        keys = self._stage(raw)
        del raw
        self.server = Server(keys)
        self.fn = self._ctr_fn(keys)
        self.fence()
        log(f"# rank {self.rank}: a {self.mesh.shape} mesh, rank 0's keys "
            f"staged in {time.perf_counter() - t0:.3f} s")

    def _stage(self, raw):
        """This rank's keys as the mesh stages them: rank 0's broadcast."""
        from tfhe_aes_tpu_torch.parallel import mesh as mesh_mod
        return mesh_mod.shard_keys(
            self.mesh, raw, shard_contractions=self.layout["shard_keys"])

    def _ctr_fn(self, keys):
        from tfhe_aes_tpu_torch.parallel import mesh as mesh_mod
        return mesh_mod.sharded_ctr_fn(self.mesh, keys, self.blocks)

    def _spawn(self, log) -> None:
        from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port
        import tfhe_aes_tpu_torch
        env = {"WORLD_SIZE": str(self.world),
               "LOCAL_WORLD_SIZE": str(self.world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        port_root = pathlib.Path(tfhe_aes_tpu_torch.__file__).resolve()
        path = [str(port_root.parents[1])] + [
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p]
        program = type(self)
        argv = ["--root", str(self.cell.root), "--workload", self.cell.name,
                "--seed", str(self.seed), "--trace", str(int(self.trace)),
                "--device", self.device.type,
                "--program", f"{program.__module__}:{program.__qualname__}"]
        if self.override:
            argv += ["--override", json.dumps(self.override)]
        atexit.register(self._kill)
        for r in range(1, self.world):
            child_env = dict(os.environ, **env, RANK=str(r),
                             LOCAL_RANK=str(r),
                             PYTHONPATH=os.pathsep.join(path))
            proc = subprocess.Popen(
                [sys.executable, "-m", "benchmark.ranks"] + argv,
                env=child_env, cwd=harness.ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, bufsize=1)
            self.children[r] = proc
            self._thread(self._echo, r, proc, log)
        self._env = {k: os.environ.get(k) for k in ENV}
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        self._thread(self._watch, log)

    def _thread(self, target, *args) -> None:
        th = threading.Thread(target=target, args=args, daemon=True)
        th.start()
        self._threads.append(th)

    @staticmethod
    def _echo(rank: int, proc, log) -> None:
        for line in proc.stdout:
            log(f"[rank {rank}] {line.rstrip()}")

    def _watch(self, log) -> None:
        """Rank 0: end the run when a rank exits early or a step hangs."""
        while not self._closing.wait(0.5):
            for r, proc in self.children.items():
                if proc.poll() is not None and not self._stopped:
                    self._fail(log, f"rank {r} exited with code "
                               f"{proc.returncode} before the run ended")
            if time.monotonic() > self._deadline:
                self._fail(log, "a step outlasted its limit: a rank hangs")

    def _fail(self, log, why: str) -> None:
        self._kill()
        for th in self._threads:
            if th is not threading.current_thread():
                th.join(timeout=2.0)
        log(f"# {why}: every rank ended, no result")
        os._exit(3)

    def _kill(self) -> None:
        for proc in self.children.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    # -- the steps -------------------------------------------------------

    def _tell(self, op: int, offset: int = 0) -> None:
        """Rank 0: the other ranks' next step, over the host group."""
        self._deadline = time.monotonic() + STEP_LIMIT_S
        self._stopped = op == STOP
        dist.broadcast(torch.tensor([op, offset]), src=0, group=self.ctrl)

    def _heard(self) -> tuple[int, int]:
        msg = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self.ctrl)
        op, offset = msg.tolist()
        return op, offset

    def key_expansion(self, enc_key: torch.Tensor) -> torch.Tensor:
        self._tell(KEYEXP)
        return self._schedule(enc_key)

    def _schedule(self, enc_key: torch.Tensor) -> torch.Tensor:
        """The session's schedule on this rank, held against rank 0's."""
        rks = super().key_expansion(enc_key)
        self._compare(rks)
        return rks

    def _compare(self, rks: torch.Tensor) -> None:
        """Every rank's round keys gathered on rank 0, which counts the
        words of the other ranks' that differ from its own."""
        mine = rks.cpu()
        parts = ([torch.empty_like(mine) for _ in range(self.world)]
                 if self.rank == 0 else None)
        dist.gather(mine, parts, dst=0, group=self.ctrl)
        if self.rank == 0:
            self.schedule_words = sum(int((p != mine).sum())
                                      for p in parts[1:])

    def keystream(self, rks, enc_iv, blocks: int, offset: int):
        self._tell(KEYSTREAM, offset)
        out = self._step(rks, enc_iv, blocks, offset)
        if self.trace and len(self.calls) == 1:
            # Set-up's request: wait here, not in the traced window, for
            # the other ranks' profilers to start (serve).
            dist.barrier(group=self.ctrl)
        return out

    def _step(self, rks, enc_iv, blocks: int, offset: int):
        """One request on this rank: the global LUTs, this rank's slice
        of the CTR batch, every rank's blocks gathered."""
        from tfhe_aes_tpu_torch.models import fhe_aes
        from tfhe_aes_tpu_torch.utils import torus
        if blocks != self.blocks:
            raise ValueError(f"the mesh function is built for {self.blocks} "
                             f"blocks, not {blocks}")
        with _span("luts"):
            lut_lsb, luts_rest = (torus.from_u64(x) for x in
                                  fhe_aes.add_scalar_luts(
                                      self.params,
                                      fhe_aes.counter_bytes(blocks, offset)))
        start = self._mark()
        with _span("ctr"):
            local, _ = self.fn(rks, enc_iv, lut_lsb, luts_rest)
        self.calls.append((start, self._mark()))
        with _span("gather"):
            return self._gather(local)

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        from tfhe_aes_tpu_torch.parallel import mesh as mesh_mod
        return mesh_mod.gather_blocks(self.mesh, local)

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _call_seconds(self) -> list:
        """The device seconds of each CTR call but the first (set-up's
        warm request): host seconds on the CPU, which runs eagerly."""
        self.fence()
        if self.device.type != "cuda":
            return [b - a for a, b in self.calls[1:]]
        return [a.elapsed_time(b) * 1e-3 for a, b in self.calls[1:]]

    def serve(self) -> None:
        """A rank above 0: run what rank 0 tells, until it says stop.  In
        a traced run its profiler starts once set-up's request is done,
        and rank 0 waits for it there (its start-up, seconds long, would
        otherwise hold up the window's first request); it stops after the
        window's first trace_requests, as rank 0's does."""
        enc_iv = self.upload(self.inputs.warm.enc_iv)
        rks, prof, done = None, None, 0
        while True:
            op, offset = self._heard()
            if op == STOP:
                break
            if op == KEYEXP:
                rks = self._schedule(self.upload(self.inputs.warm.enc_key))
                continue
            with _span("request"):
                self._step(rks, enc_iv, self.blocks, offset)
                self.fence()
            done += 1
            if prof is not None and done == 1 + self.trace_requests:
                events, _ = harness._stop(prof, self, self.counters())
                tr = reduce.from_profile(events, {}, [])
                self.traced, prof = (tr.busy_s(), tr.window_s), None
            if self.trace and done == 1:
                prof = torch.profiler.profile(
                    activities=harness._activities(self))
                prof.__enter__()
                dist.barrier(group=self.ctrl)

    def collect(self) -> dict:
        """After the window, on every rank: stop the others (rank 0),
        then each rank's report gathered on rank 0; raises where a rank
        holds a JAX module.  Rank 0 gets what the harness reads: each
        rank's CTR call seconds, the other ranks' traced (busy, window)
        seconds and the check of their schedules."""
        t0 = time.perf_counter()
        if self.rank == 0:
            self._tell(STOP)
        mine = {"rank": self.rank, "peak": super().memory_peak(),
                "call_s": self._call_seconds(), "traced": self.traced,
                "jax": harness.forbidden_modules()}
        reports = [None] * self.world if self.rank == 0 else None
        dist.gather_object(mine, reports, dst=0, group=self.ctrl)
        if self.rank != 0:
            return {}
        self.log(f"# the ranks reported in {time.perf_counter() - t0:.3f} s")
        leaked = {r["rank"]: r["jax"] for r in reports if r["jax"]}
        if leaked:
            raise RuntimeError(f"ranks loaded JAX modules: {leaked}")
        self.peaks = [r["peak"] for r in reports]
        return {"call_s": [r["call_s"] for r in reports],
                "traced": [r["traced"] for r in reports[1:] if r["traced"]],
                "checks": {"rank_schedule_words": {
                    "value": self.schedule_words, "limit": 0}}}

    def memory_peak(self) -> int:
        """The fullest rank's, once collect() has run."""
        return max(self.peaks)

    def close(self) -> None:
        """Rank 0: free the program, wait for the other ranks to exit,
        leave the process group and restore the environment."""
        t0 = time.perf_counter()
        self.fn = None
        super().close()
        for proc in self.children.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        self._kill()
        t1 = time.perf_counter()
        self._closing.set()
        for th in self._threads:
            th.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()
        self.log(f"# closed: the ranks gone in {t1 - t0:.3f} s, the process "
                 f"group left in {time.perf_counter() - t1:.3f} s")
        for k, v in self._env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if self.children:
            atexit.unregister(self._kill)


def _span(name: str):
    return torch.profiler.record_function(reduce.SPAN_PREFIX + name)


def _exit_with(parent: int) -> None:
    """End this process once its parent, rank 0, is gone."""
    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m benchmark.ranks")
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--program", required=True, help="module:class")
    ap.add_argument("--override", default=None, help="JSON")
    args = ap.parse_args(argv)
    _exit_with(os.getppid())
    module, _, name = args.program.partition(":")
    program = functools.reduce(getattr, name.split("."),
                               importlib.import_module(module))
    cell = harness.load_cell(args.workload, pathlib.Path(args.root))
    rank = int(os.environ["RANK"])
    inputs = generator.make_inputs(cell.config["params"], cell.traffic,
                                   args.seed)
    override = json.loads(args.override) if args.override else None
    port = program(cell.config, args.device, override, cell=cell,
                   seed=args.seed, trace=bool(args.trace), rank=rank)
    port.start(inputs, cell.traffic, log)
    port.serve()
    port.collect()
    # Reported: nothing of this rank is read again.  Leaving without
    # tearing down its communicators keeps rank 0 from waiting on them.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
