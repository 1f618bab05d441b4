"""Captured CUDA graphs of the port's dispatch units: its counterpart of
``jax.jit`` for them.

The JAX package compiles a WoPBS once per (key shapes, batch, LUT stack)
and replays the compiled program across AES rounds, key-expansion words
and CTR ripple steps (tfhe_aes_tpu/ops/wopbs.many_wopbs_jit).  PyTorch's
counterpart of a compiled program that is replayed is a captured CUDA
graph: the host issues one graph launch where an eager WoPBS issues the
1,339 launches of each rotate, the VP launches and every torch op of its
staging, one by one.

A ``GraphCache`` holds graphs by owner (a key set, weakly held: a graph
reads the key leaves by address, so its entries go when the keys die),
then by the function, its static arguments and the shape, dtype and
device of every tensor argument:

  * the first call of a key captures one run into a ``torch.cuda.
    CUDAGraph`` on a side stream of its device, reading static input
    buffers, and then goes on as a later call.  Before the capture it runs
    a warm-up call eagerly on that stream (by default the call itself; the
    WoPBS gives one byte of it): what a capture cannot do happens there,
    at a fraction of the call's memory: the kernel libraries and tiles are
    built (ops/cuda_build) and cuBLAS makes its handles;
  * a later call copies its inputs into the static buffers, replays the
    graph on the current stream and returns a clone of the static output
    (a caller may hold an output across calls);
  * every graph of a device allocates from one memory pool
    (``torch.cuda.graph_pool_handle``): the graphs replay one after
    another on one stream, so the intermediates of two never live at
    once, and each output is cloned before another graph replays.  No
    eager run allocates from the pool: what it keeps (its result, a tile)
    could lie in another graph's intermediates;
  * a failed capture raises; nothing retries eagerly.  On CPU tensors the
    function runs eagerly: there is nothing to capture;
  * the counts of utils/profiling.py (the kernels' calls, the WoPBS runs,
    the marks) keep counting executions: the warm-up call counts itself,
    a capture records what its graph holds (``Graph.record``, the counts
    and the marks' labels by name) and adds nothing, and each replay, the
    first call's too, adds the record.  Each unit's warm-up calls,
    captures and replays are counted there by its name; the warm-up,
    capture, static-buffer copies, replay and clone are its host spans.
    ``kernel_nodes`` reads the kernel nodes a graph really holds, to check
    those numbers on the card.

A unit may be a whole function that runs many WoPBS (models/fhe_aes's
``ctr_step_jit``, ``aes_encrypt_jit`` ...).  While a unit's warm-up call or
its capture runs, the cache marks this thread as inside a unit
(``inside``): a ``wopbs.many_wopbs_jit`` there runs its WoPBS inline, in
the unit's warm-up or graph, and a graphed call there raises.  CUDA cannot
nest captures, and a replay recorded into a capture would read another
graph's static buffers.  The unit's graph then holds the launches of every
WoPBS it ran, and each replay adds them all.

A graph may hold collectives: those of a mesh's keys (ops/keys.
ContractionShard) and of its byte split (models/fhe_aes.ctr_step_jit),
when their process group is NCCL's (``capturable``): NCCL enqueues its
work on the capturing stream.  Every rank of the group then issues the
same warm-up call, capture and replays, in step; nothing in them reads a
value on the host (the WoPBS caps are agreed before the warm-up).  Over
gloo, which runs on the host, the callers stay eager.

One caller at a time per owner: the calls of one key share its static
buffers.  Captures run with capture_error_mode="thread_local", so a thread
of the cold-start warm-up (utils/warmup.py) that is still running is not
barred from its own CUDA calls meanwhile.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import threading
import weakref
from typing import Callable

import torch
import torch.distributed as dist

from ..utils import profiling


def capturable(group) -> bool:
    """Whether a capture can hold the collectives of `group`: an NCCL
    process group (its tensors on the card, its work enqueued on the
    capturing stream).  gloo runs its collectives on the host, and a
    group that is not a process group is not one."""
    return (isinstance(group, dist.ProcessGroup)
            and dist.get_backend(group) == "nccl")


class CudaCapture:
    """Captures on the card: one side stream and one graph memory pool a
    device.

    A pool lives as long as a graph captured into it: once every one has
    died (their key sets with them), PyTorch releases it and refuses its
    handle, so the next capture on that device opens a new pool.
    keep: keep each graph's CUDA graph for a DOT dump (kernel_nodes)."""

    def __init__(self):
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._pools: dict[torch.device, tuple] = {}
        self._live: dict[torch.device, int] = {}
        self.keep = False

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _pool(self, device: torch.device) -> tuple:
        if not self._live.get(device):
            self._pools[device] = torch.cuda.graph_pool_handle()
            self._live[device] = 0
        return self._pools[device]

    def _died(self, device: torch.device) -> None:
        self._live[device] -= 1

    def capture(self, device: torch.device, warm: Callable,
                fn: Callable):
        """(the graph, its static output): warm() run eagerly, then fn()
        captured into the device's pool, both on the side stream, ordered
        after the current stream's work and before its later work.

        Unlike ``torch.cuda.graph`` this does not synchronise the device
        first, so the capture's host work overlaps the warm-up still on
        the card."""
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            side = self._stream(device)
            side.wait_stream(cur)
            graph = torch.cuda.CUDAGraph(keep_graph=self.keep)
            with torch.cuda.stream(side):
                warm()
                graph.capture_begin(pool=self._pool(device),
                                    capture_error_mode="thread_local")
                try:
                    output = fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()      # invalidated: fn's error
                    raise                        # says why
                graph.capture_end()
            if self.keep:
                graph.instantiate()
            cur.wait_stream(side)
        self._live[device] += 1
        weakref.finalize(graph, self._died, device)
        return graph, output


_KERNEL_NODE = re.compile(r"\{KERNEL\s*\|\s*\{ID \|[^|]*\|\s*([^\s\\|}]+)")
_MEMCPY_NODE = re.compile(r"\{\s*MEMCPY\s*\|.*?\{kind \| ([^}]*)\}.*?"
                          r"\{Width \| (\d+)\}", re.S)


def _dot(graph: "Graph", path) -> str:
    """A captured graph's DOT dump (cudaGraphDebugDotPrint), written to
    `path`.  The graph must have been captured under CudaCapture.keep."""
    graph.graph.debug_dump(str(path))
    with open(path) as f:
        return f.read()


def kernel_nodes(graph: "Graph", path) -> collections.Counter:
    """The kernel nodes a captured graph holds, by function name (as
    compiled, mangled), from its DOT dump written to `path`."""
    return collections.Counter(_KERNEL_NODE.findall(_dot(graph, path)))


def memcpy_nodes(graph: "Graph", path) -> collections.Counter:
    """The copy nodes a captured graph holds, by (kind, bytes), from its
    DOT dump written to `path`.  A one-rank NCCL collective that is not in
    place lowers to one copy of kind "default" (cudaMemcpyDefault); the
    copies torch makes are "DtoD"."""
    return collections.Counter(
        (kind.strip(), int(width))
        for kind, width in _MEMCPY_NODE.findall(_dot(graph, path)))


@dataclasses.dataclass
class Graph:
    """One captured call: its static buffers, the graph (``replay()``),
    what its capture recorded (utils/profiling.Record: the counts each
    replay adds, by key, and the labels of the device marks it holds in
    order), and the name of its unit."""
    graph: object
    inputs: tuple
    output: torch.Tensor
    record: profiling.Record
    name: str = ""


class GraphCache:
    """Captured graphs by owner, then by (function, static arguments,
    tensor shapes / dtypes / devices).

    capture: an object with ``capture(device, warm, fn) -> (graph, output
    of fn() in the graph)`` that calls warm() first (CudaCapture.capture);
    None takes ``self.cuda`` for CUDA tensors and runs CPU tensors eagerly
    (a test gives a stub, which then serves CPU tensors too).
    """

    def __init__(self, capture=None):
        self.capture = capture
        self.cuda = CudaCapture()
        self._owners: dict[int, tuple[weakref.ref, dict]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def captures(self) -> int:
        """Captures of every unit (utils/profiling's counts)."""
        return _units("captures")

    @property
    def replays(self) -> int:
        """Replays of every unit (utils/profiling's counts)."""
        return _units("replays")

    def inside(self) -> bool:
        """Whether this thread is running a unit's warm-up call or capture
        (set by the cache itself, around both)."""
        return getattr(self._local, "inside", False)

    @contextlib.contextmanager
    def unit(self):
        """Mark this thread as inside a unit while the block runs: the
        cache's own capture does, around the warm-up call and the
        capture (a stub capture's replay, which runs the function again,
        does too)."""
        was = self.inside()
        self._local.inside = True
        try:
            yield
        finally:
            self._local.inside = was

    def _table(self, owner) -> dict:
        key = id(owner)
        with self._lock:
            hit = self._owners.get(key)
            if hit is None or hit[0]() is not owner:
                ref = weakref.ref(owner,
                                  lambda _: self._owners.pop(key, None))
                hit = self._owners[key] = (ref, {})
        return hit[1]

    def graphs(self, owner) -> dict:
        """The owner's graphs by key."""
        with self._lock:
            hit = self._owners.get(id(owner))
        if hit is None or hit[0]() is not owner:
            return {}
        return {k: g for k, g in hit[1].items() if isinstance(g, Graph)}

    def __len__(self) -> int:
        """Owners with an entry."""
        return len(self._owners)

    def clear(self) -> None:
        """Drop every graph and memo (the next call of each key captures
        again)."""
        with self._lock:
            self._owners.clear()

    def memo(self, owner, key, make: Callable):
        """make(), once per owner and key, held as long as the owner: a
        static argument decided at the first call (the WoPBS chunk cap)."""
        table = self._table(owner)
        if key not in table:
            table[key] = make()
        return table[key]

    def __call__(self, fn: Callable, owner, tensors: tuple, static=(), *,
                 warm: Callable | None = None,
                 before: Callable | None = None,
                 after: Callable | None = None,
                 name: str | None = None):
        """fn(owner, *tensors, *static) -> a tensor, graphed.
        warm(owner, *tensors, *static), run eagerly before a capture,
        prepares what the capture cannot (default: fn).  before(*inputs)
        runs on the inputs the call computes on (the static buffers of a
        graph) and after(output) on what it returns, once each a call,
        outside any capture.  name: the unit's, for its counts
        (utils/profiling; default fn's)."""
        capture = self.capture or (self.cuda if tensors[0].is_cuda
                                   else None)
        if capture is not None and self.inside():
            raise RuntimeError("a graphed call inside a unit's warm-up or "
                               "capture: a nested call must run inline")
        held_owner = weakref.ref(owner)     # a graph may keep `run`

        def run(*ts):
            return fn(held_owner(), *ts, *static)

        if capture is None:
            if before is not None:
                before(*tensors)
            out = run(*tensors)
        else:
            key = (fn, static, tuple((tuple(t.shape), t.dtype, t.device)
                                     for t in tensors))
            table = self._table(owner)
            graph = table.get(key)
            if graph is None:
                graph = table[key] = self._capture(
                    capture, run, lambda: (warm or fn)(owner, *tensors,
                                                       *static), tensors,
                    name or fn.__name__)
            with profiling.span("copy_in"):
                for buf, t in zip(graph.inputs, tensors):
                    buf.copy_(t)
            if before is not None:
                before(*graph.inputs)
            with profiling.span("replay"):
                graph.graph.replay()
                profiling.count(("unit", graph.name, "replays"))
                profiling.replayed(graph.output.device, graph.record)
            with profiling.span("clone"):
                out = graph.output.clone()
        if after is not None:
            after(out)
        return out

    def _capture(self, capture, run: Callable, warm: Callable,
                 tensors: tuple, name: str) -> Graph:
        """The graph of run on static buffers shaped as `tensors`."""
        inputs = tuple(torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in tensors)
        recorded = []
        profiling.prepare(tensors[0].device)

        def warm_up():
            with profiling.span("warm_up"):
                profiling.count(("unit", name, "warm_ups"))
                return warm()

        def recorded_run():
            """run(*inputs) under capture: its counts and marks are
            recorded as the graph's, not counted."""
            with profiling.span("capture"), profiling.recording() as rec:
                recorded[:] = [rec]
                return run(*inputs)

        with self.unit():
            graph, output = capture.capture(tensors[0].device, warm_up,
                                            recorded_run)
        profiling.count(("unit", name, "captures"))
        return Graph(graph, inputs, output,
                     recorded[0] if recorded else profiling.Record(), name)


def _units(what: str) -> int:
    """The units' count of `what` ("captures", "replays") together."""
    return sum(n for (_, _, w), n in profiling.tagged("unit").items()
               if w == what)


GRAPHS = GraphCache()
