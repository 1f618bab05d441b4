"""One run of one cell: set-up, the measured window, the reference's
verdict, and the metrics of the cell.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in benchmark/configs/<config>.json, its traffic in
benchmark/traffic/<traffic>.json (read by generator.py), each per-layer
metric in benchmark/metrics/<metric>.py (a ``read(trace)`` that returns a
number, or None where the trace holds nothing for it).  An end-to-end
metric is one of the quantities run_cell measures (blocks_per_min,
session_s, peak_reserved_gib, setup_s), named as it is or as
"<quantity>.<suffix>", so that a cell can report the same quantity under
a bound of its own.

The program under test is the port's client (device key generation from
the benchmark's secret keys, and its public key where the traffic's
"rcon" is "pk") and server facade (``Server.aes_key_expansion``, with
``pk_rcon`` for "pk"; ``Server.ctr_keystream`` for a request of "op"
"ctr", ``Server.aes_decrypt`` for "decrypt"), behind ``Port``; a
configuration with a "mesh" runs the port's multi-rank path on one
process a card instead, behind ``ranks.MeshPort``, which drives trivial
RCON and CTR alone.  A traffic value the harness does not drive is
refused when the cell is loaded.  A request's answer is fetched to the
host, as a server returns it; the window ends when the request that was
running at ``seconds`` completes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import generator, reduce, rooflines
from .reference import judge as judge_mod

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tfhe_aes_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list         # BENCHMARK.json entries this cell reports
    per_layer: list
    root: pathlib.Path


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    here = root / "benchmark"
    config = _json(here / "configs" / f"{w['config']}.json")
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    refuse(config, traffic)
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer, root)


def refuse(config: dict, traffic: dict) -> None:
    """Raise where the harness would not drive the traffic as its file
    says: a value the generator does not draw, or on a mesh (ranks.
    MeshPort) anything but one session's trivial-RCON CTR stream."""
    generator.check(traffic)
    if "mesh" in config and (traffic["rcon"] != "trivial"
                             or generator.op(traffic) != "ctr"
                             or traffic["key_per_session"]):
        raise ValueError(
            f"a mesh runs one session's CTR keystream with trivial RCON, "
            f"not rcon {traffic['rcon']!r}, op {generator.op(traffic)!r}, "
            f"key_per_session {traffic['key_per_session']}")


def metric_reader(cell: Cell, name: str):
    """benchmark/metrics/<name>.py's read()."""
    path = cell.root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """The JAX modules and the JAX package this process holds, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Port:
    """The program under test, tfhe_aes_tpu_torch, on `device`."""

    def __init__(self, config: dict, device, override: dict | None = None):
        from tfhe_aes_tpu_torch.params import ParamSet
        self.params = ParamSet(name=config["program_set"],
                               **{**config["params"], **(override or {})})
        self.device = torch.device(device)
        self.server = None
        self.pk_rcon = False

    def start(self, inputs: generator.Inputs, traffic: dict, log) -> None:
        """The program's warm-up beside device key generation from the
        benchmark's secret keys, and for pk RCON the client's public key,
        which the server holds with randomness of its own, as a deployment
        starts."""
        from tfhe_aes_tpu_torch.backend.numpy_backend import SecretKeys
        from tfhe_aes_tpu_torch.client.client import Client
        from tfhe_aes_tpu_torch.server import Server
        from tfhe_aes_tpu_torch.utils import warmup
        t0 = time.perf_counter()
        warm = warmup.precompile(self.params, traffic["blocks_per_request"],
                                 device=self.device)
        client = Client(self.params, seed=inputs.keygen_seed)
        client.sk = SecretKeys(self.params, inputs.lwe_key, inputs.glwe_key)
        dkeys = client.make_device_keys(device=self.device)
        self.pk_rcon = traffic["rcon"] == "pk"
        self.server = (Server(dkeys, client.make_public_key(),
                              inputs.server_rng)
                       if self.pk_rcon else Server(dkeys))
        self.fence()
        t_keys = time.perf_counter() - t0
        report = warm.join()
        log(f"# keys on the device in {t_keys:.3f} s; warm-up {report}")

    def upload(self, cts: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(cts.view(np.int64)).to(self.device)

    def key_expansion(self, enc_key: torch.Tensor) -> torch.Tensor:
        return self.server.aes_key_expansion(enc_key, pk_rcon=self.pk_rcon)

    def keystream(self, rks, enc_iv, blocks: int, offset: int):
        return self.server.ctr_keystream(rks, enc_iv, blocks, offset)

    def decrypt(self, rks, blocks: torch.Tensor) -> torch.Tensor:
        return self.server.aes_decrypt(rks, blocks)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().view(np.uint64)

    def fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> dict:
        from tfhe_aes_tpu_torch.ops import cuda_blind_rotate, cuda_vp, graphs
        return {"rotate_calls": cuda_blind_rotate.blind_rotate_cuda.launches,
                "vp_calls": cuda_vp.vp_rotations_cuda.launches,
                "captures": graphs.GRAPHS.captures}

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_reserved(self.device)

    def close(self) -> None:
        self.server = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    name = torch.cuda.get_device_name()
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return {"name": name, "power_limit": limit}


class _Run:
    """The state of one run: its program, its inputs, its judge and what
    the window recorded."""

    def __init__(self, cell, seed, program, device, override, log):
        self.traffic = cell.traffic
        self.per_session = self.traffic["key_per_session"]
        self.decrypt = generator.op(self.traffic) == "decrypt"
        t0 = time.perf_counter()
        self.inputs = generator.make_inputs(cell.config["params"],
                                            self.traffic, seed)
        log(f"# inputs drawn in {time.perf_counter() - t0:.3f} s")
        self.port = program(cell.config, device, override)
        self.judge = judge_mod.Judge(self.inputs.big_key,
                                     cell.config["guarantees"]["p_fail"])
        self.kept = []            # (round keys on the device, AES key)
        self.keyexp_s = []
        self.fence_keyexp = False
        self.bulk = None          # (enc_iv, round keys) of a bulk session

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(reduce.SPAN_PREFIX + name):
            yield

    def _schedule(self, session: generator.Session):
        """(enc_iv on the device, None for decrypt; round keys)."""
        with self.span("upload"):
            enc_key = self.port.upload(session.enc_key)
            enc_iv = None if self.decrypt else \
                self.port.upload(session.enc_iv)
        t0 = time.perf_counter()
        with self.span("keyexp"):
            rks = self.port.key_expansion(enc_key)
            if self.fence_keyexp:
                self.port.fence()
                self.keyexp_s.append(time.perf_counter() - t0)
        return enc_iv, rks

    def lift(self, req: generator.Request,
             session: generator.Session) -> np.ndarray | None:
        """A decrypt request's ciphertexts, made before its clock starts."""
        return generator.ciphertexts(session, req) if self.decrypt else None

    def request(self, req: generator.Request, session: generator.Session,
                check_schedule: bool,
                cts: np.ndarray | None = None) -> np.ndarray:
        """One request, its answer fetched; judged after the window.  cts:
        a decrypt request's ciphertexts (lift)."""
        with self.span("request"):
            if self.per_session:
                enc_iv, rks = self._schedule(session)
                if check_schedule:
                    self.kept.append((rks, session.key))
            else:
                if self.bulk is None:
                    self.bulk = self._schedule(session)
                    self.kept.append((self.bulk[1], session.key))
                enc_iv, rks = self.bulk
            if self.decrypt:
                with self.span("upload"):
                    blocks = self.port.upload(cts)
                with self.span("decrypt"):
                    ans = self.port.decrypt(rks, blocks)
            else:
                with self.span("keystream"):
                    ans = self.port.keystream(rks, enc_iv, req.blocks,
                                              req.offset)
            with self.span("fetch"):
                out = self.port.fetch(ans)
        if self.decrypt:
            self.judge.decrypt(out, req.plain)
        else:
            self.judge.keystream(out, session.key, session.iv, req.offset)
        return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: float | None = None, program=None,
             override: dict | None = None, log=None) -> dict:
    """One run: the result line's object, its checks last.  program:
    Port, or ranks.MeshPort where the configuration has a "mesh" (the
    tests' stand-ins take its place)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if "mesh" in cell.config:
        from . import ranks
        program = functools.partial(program or ranks.MeshPort, cell=cell,
                                    seed=seed, trace=trace)
    program = program or Port
    log(f"# harness loaded at {time.perf_counter() - t0:.3f} s")
    run = _Run(cell, seed, program, device, override, log)
    port, traffic = run.port, run.traffic
    port.start(run.inputs, traffic, log)
    log(f"# program started at {time.perf_counter() - t0:.3f} s")

    # Set-up ends with the cell's one request shape run once.
    ta = time.perf_counter()
    req = run.inputs.warm_request
    run.request(req, run.inputs.warm, check_schedule=run.per_session,
                cts=run.lift(req, run.inputs.warm))
    log(f"# warm-up request ({req.blocks} blocks): "
        f"{time.perf_counter() - ta:.3f} s")
    port.fence()
    run.fence_keyexp = trace
    t_start = time.perf_counter()
    setup_s = t_start - t0
    log(f"# set-up {setup_s:.3f} s")

    n_traced = traffic["trace_requests"] if trace else 0
    prof, events, traced = None, None, []
    times = []
    drawn = 0.0     # seconds of the window spent drawing further sessions
                    # and decrypt requests' ciphertexts
    for j, req in enumerate(generator.requests(traffic, run.inputs)):
        if j and time.perf_counter() - t_start - drawn >= seconds:
            break
        if req.session >= len(run.inputs.sessions):
            td = time.perf_counter()
            run.inputs.draw(traffic["sessions"])
            drawn += time.perf_counter() - td
        session = run.inputs.sessions[req.session]
        cts = None
        if run.decrypt:
            td = time.perf_counter()
            cts = run.lift(req, session)
            drawn += time.perf_counter() - td
        if j == 0 and n_traced:
            prof = torch.profiler.profile(activities=_activities(port))
            prof.__enter__()
            before = port.counters()
        ta = time.perf_counter()
        run.request(req, session,
                    check_schedule=req.session in run.inputs.checked, cts=cts)
        tb = time.perf_counter()
        times.append((req, ta, tb))
        if prof is not None and j < n_traced:
            traced.append(req)
            if j + 1 == n_traced:
                events, counted = _stop(prof, port, before)
                prof = None
    if prof is not None:
        events, counted = _stop(prof, port, before)
    t_end = times[-1][2]
    span = t_end - t_start - drawn
    blocks = sum(req.blocks for req, _, _ in times)
    per_req = [tb - ta for _, ta, tb in times]
    log(f"# window: {len(times)} requests, {blocks} blocks in {span:.4f} s; "
        f"a request median {statistics.median(per_req):.4f} s, max "
        f"{max(per_req):.4f} s; {drawn:.4f} s drawing inputs left out")

    # What the other ranks of a mesh report (ranks.MeshPort.collect).
    others = port.collect() if "mesh" in cell.config else {}
    peak = port.memory_peak()
    for rks, key in run.kept:
        run.judge.schedule(port.fetch(rks), key)
    run.kept.clear()
    run.bulk = None
    port.close()
    checks, failed = run.judge.verdict()
    checks.update(others.get("checks", {}))
    failed = failed[1:]     # the window's: the warm request's is first

    values = {"blocks_per_min": blocks / span * 60.0,
              "session_s": span / len(times) if run.per_session else None,
              "peak_reserved_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    result = {"correct": judge_mod.passed(checks) and not any(failed),
              "attempted": len(times), "failed": int(sum(failed))}
    dev = _device_record(port, cell, peak)
    if trace:
        work = _traced_work(cell, traced)
        tr = reduce.from_profile(events, work, run.keyexp_s,
                                 others.get("call_s", []))
        _log_records(log, tr, counted, work)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        # Averaged over the ranks where others traced their request too.
        busy = [(tr.busy_s(), tr.window_s)] + others.get("traced", [])
        dev.update(busy_s=statistics.fmean(b for b, _ in busy),
                   window_s=statistics.fmean(w for _, w in busy))
        result.update(metrics=metrics, device=dev,
                      breakdown=reduce.breakdown(tr))
    else:
        metrics = {}
        for m in cell.end_to_end:
            # "<quantity>.<suffix>" reads <quantity>: a cell whose spread
            # wants a bound of its own names a metric of its own.
            value = values.get(m["name"].split(".")[0])
            if value is None:
                raise ValueError(f"{cell.name} does not report {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=dev)
    result["checks"] = checks
    return result


def _activities(port) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if port.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _stop(prof, port, before: dict):
    """Close the profile: its events (name, on the device, start s, end
    s), and the counters' growth."""
    port.fence()
    prof.__exit__(None, None, None)
    after = port.counters()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.device_type == cuda, e.time_range.start * 1e-6,
               e.time_range.end * 1e-6) for e in prof.events()]
    return events, {k: after[k] - before[k] for k in after}


def _traced_work(cell: Cell, traced: list) -> dict:
    """The traced requests' work on this process's card: its 'dp' share
    of each batch on a mesh."""
    share = cell.config.get("mesh", {}).get("dp", 1)
    step = (rooflines.decrypt_wopbs
            if generator.op(cell.traffic) == "decrypt"
            else rooflines.ctr_step_wopbs)
    wopbs = []
    for req in traced:
        if cell.traffic["key_per_session"]:
            wopbs += rooflines.key_expansion_wopbs(cell.traffic["rcon"])
        wopbs += step(req.blocks // share)
    return rooflines.work(cell.config["params"], wopbs)


def _log_records(log, tr, counted: dict, work: dict) -> None:
    """How much of the traced work the profile and the counters saw."""
    log(f"# traced: {tr.window_s:.4f} s, busy {tr.busy_s():.4f} s, "
        f"{len(tr.ops)} device records; rotate calls counted "
        f"{counted['rotate_calls']} of {work['rotate_calls']} in the work, "
        f"VP calls {counted['vp_calls']}, captures {counted['captures']}")
    for kernel, (found, want) in reduce.records_found(tr).items():
        share = found / want if want else float("nan")
        log(f"# traced records of {kernel}: {found} of {want} launches "
            f"({100 * share:.2f}%)")


def _device_record(port, cell: Cell, peak: int) -> dict:
    if port.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": cell.chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": peak}
