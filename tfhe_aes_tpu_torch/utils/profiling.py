"""Timing and tracing of the port: a device fence, host spans, device
marks, counters, and the report that joins them.

Counterpart of tfhe_aes_tpu/utils/profiling.py (a fence), grown into the
port's one tracing system:

  * host spans (``span(name)``): a no-op unless tracing is on, which it is
    after ``enable()`` and while a ``torch.profiler`` is recording.  A span
    is then a profiler range named ``tfhe:<name>``, on the clock of the
    profile's device records, and an in-memory record: its name, start and
    end (``time.perf_counter_ns``), its parent and the top-level span (one
    request: one Server call) it belongs to.  The range is a function-scope
    record (``_RecordFunctionFast``): a user-scope ``record_function`` range
    is also mirrored on the device's timeline, where a reader that sums the
    device records would count it as work;
  * device marks (``mark(like, close=, open=)``): one-thread kernels
    (csrc/marks.cu) that stamp (mark id, %globaltimer) into a ring of
    RING_SLOTS entries a device, a global of the kernel's module (no
    allocator holds it), loaded before any capture.  A mark is
    launched on the current stream, so a CUDA graph captured there holds
    it and every replay stamps again: marks are always launched, and
    reading them is what tracing gates.  The host counts the marks that
    run on each device (eager launches, and each replay's recorded marks),
    so it knows the ring's head without a device read.  A mark closes
    spans and opens others: one mark is the boundary where one stage ends
    as the next begins.  While tracing is on, each eager mark and each
    replay logs its slots and labels; ``report()`` reads those slots back.
    On CPU tensors a mark is a host stamp when tracing is on, and nothing
    otherwise;
  * counters, always on: one store of counts by key (``count(key, n)``,
    ``COUNTS``): the kernels' calls ("rotate_calls", "rotate_split_calls",
    "rotate_persistent_calls", "vp_calls", "mark_launches"), each WoPBS run
    by shape (("wopbs", bytes, LUT outputs, bits)) and each graphed unit's
    warm-up calls, captures and replays (("unit", name, what)).  Under a
    capture a count goes to the capture's Record, and each replay of the
    graph adds the Record's counts (``replayed``);
  * ``report()`` / ``dump(path)``: the host spans, the device spans
    decoded from the ring, the counters, and each layer's self time (its
    duration less what its children cover).

Every mark is also a kernel record named MARK_KERNEL in a profile: the
k-th such record of a traced window is the k-th logged mark.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import json
import threading
import time

import numpy as np
import torch

SPAN_PREFIX = "tfhe:"
MARK_KERNEL = "tfhe_mark"
RING_SLOTS = 1 << 16            # 16 bytes an entry: 1 MiB a device

_lock = threading.RLock()
_local = threading.local()      # .stack: open host spans; .rec: a capture's
_ids = itertools.count(1)
_enabled = False
_spans: list = []               # closed host spans
_log: list = []                 # logged marks: _Logged
_labels: dict = {}              # label -> mark id (1, 2, ...)
_heads: dict = {}               # device -> marks run there (the ring's head)
_loaded: set = set()            # devices the marks' module is loaded on
COUNTS: collections.Counter = collections.Counter()  # key -> count


def device_fence(x: torch.Tensor) -> torch.Tensor:
    """Wait until the work producing `x` is done (a CUDA sync on its
    device; nothing to wait for on the CPU).  Returns `x`."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


# -- switches -----------------------------------------------------------------

def enable() -> None:
    """Turn tracing on until disable(), profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing() -> bool:
    """Whether spans and marks are recorded: after enable(), and while a
    torch.profiler records."""
    return _enabled or torch._C._autograd._profiler_enabled()


def reset() -> None:
    """Forget every record and count (not the rings' heads)."""
    with _lock:
        _spans.clear()
        _log.clear()
        COUNTS.clear()


# -- host spans ---------------------------------------------------------------

def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def span(name: str):
    """A host span around the block while tracing is on; nothing
    otherwise."""
    if not tracing():
        yield
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    rec = {"id": next(_ids), "name": name,
           "parent": parent["id"] if parent else None,
           "request": parent["request"] if parent else None,
           "start_ns": 0, "end_ns": 0}
    if parent is None:
        rec["request"] = rec["id"]
    stack.append(rec)
    try:
        with torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name):
            rec["start_ns"] = time.perf_counter_ns()
            try:
                yield
            finally:
                rec["end_ns"] = time.perf_counter_ns()
    finally:
        stack.pop()
        with _lock:
            _spans.append(rec)


def _open_span():
    stack = _stack()
    return stack[-1]["id"] if stack else None


# -- counts and capture records -----------------------------------------------

class Record:
    """What a capture recorded: its marks' labels in order, and its counts
    by key."""

    def __init__(self):
        self.labels: list = []
        self.counts: collections.Counter = collections.Counter()


@contextlib.contextmanager
def recording():
    """Inside the block this thread records marks and counts into the
    Record it yields instead of logging them or adding them to the store:
    the body of a capture, which runs nothing on the card."""
    was = getattr(_local, "rec", None)
    rec = _local.rec = Record()
    try:
        yield rec
    finally:
        _local.rec = was


def _recording():
    return getattr(_local, "rec", None)


def count(key, n: int = 1) -> None:
    """Add n to the count of `key` (under a capture, to its Record's)."""
    rec = _recording()
    if rec is not None:
        rec.counts[key] += n
        return
    with _lock:
        COUNTS[key] += n


def tagged(tag: str, counts=None) -> dict:
    """The counts (of the store, or of `counts`) whose key is a tuple that
    starts with `tag`, by key."""
    if counts is None:
        with _lock:
            counts = dict(COUNTS)
    return {k: n for k, n in counts.items()
            if isinstance(k, tuple) and k[0] == tag}


def counted(key: str):
    """Decorator: the function counts `key` each time it returns; its
    read-only ``launches`` reads that count from the store."""
    return functools.partial(_Counted, key=key)


class _Counted:
    """A function counted by counted(key)."""

    def __init__(self, fn, key: str):
        functools.update_wrapper(self, fn)
        self._fn, self.key = fn, key

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        count(self.key)
        return out

    @property
    def launches(self) -> int:
        return COUNTS[self.key]


class _Logged:
    """Marks logged while tracing: on a card the ring slots from `first`,
    on the CPU host stamps; `host` is the host span open at the launch."""
    __slots__ = ("device", "first", "labels", "host", "stamps")

    def __init__(self, device, first, labels, host, stamps):
        self.device, self.first, self.labels = device, first, labels
        self.host, self.stamps = host, stamps


def replayed(device: torch.device, record: Record) -> None:
    """A graph's replay ran what its capture recorded on `device`: its
    counts are added to the store, its marks ran."""
    labels = record.labels
    with _lock:
        COUNTS.update(record.counts)
        if device.type != "cuda" or not labels:
            return
        first = _heads.get(device, 0)
        _heads[device] = first + len(labels)
        if tracing():
            _log.append(_Logged(device, first, tuple(labels), _open_span(),
                                None))


# -- device marks -------------------------------------------------------------

def _label_id(label: str) -> int:
    with _lock:
        if label not in _labels:
            _labels[label] = len(_labels) + 1
        return _labels[label]


@functools.cache
def _lib():
    """csrc/marks.cu's library, built and loaded (ops/cuda_build)."""
    from ..ops import cuda_build
    lib = cuda_build.load("marks")
    lib.tfhe_mark_launch.argtypes = [ctypes.c_uint64, ctypes.c_void_p]
    lib.tfhe_marks_read.argtypes = [ctypes.c_void_p]
    if lib.tfhe_marks_slots() != RING_SLOTS:
        raise RuntimeError("csrc/marks.cu's ring is not RING_SLOTS long")
    return lib


def prepare(device: torch.device) -> None:
    """Before a capture on `device`: the marks' module, its ring and head,
    loaded there (neither a build nor a load can happen in a capture)."""
    if device.type != "cuda" or device in _loaded:
        return
    from ..ops import cuda_build
    lib = _lib()
    with _lock:
        if device not in _loaded:
            with torch.cuda.device(device):
                cuda_build.check(lib.tfhe_marks_load(), "marks' module")
            _loaded.add(device)


def mark_cuda(device: torch.device, label_id: int) -> None:
    """One MARK_KERNEL launch on the device's current stream, counted as
    "mark_launches"."""
    from ..ops import cuda_build
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().tfhe_mark_launch(label_id, stream)
    count("mark_launches")
    cuda_build.check(rc, "mark kernel")


def _label(close=(), open=()) -> str:
    """A mark's label: the spans it closes, innermost first, then those it
    opens, outermost first."""
    return ",".join(close) + "|" + ",".join(open)


def mark(like: torch.Tensor, close=(), open=()) -> None:
    """A mark on like's device that closes the spans `close` and opens the
    spans `open`: on a card always launched (recorded under a capture);
    on the CPU a host stamp while tracing."""
    text = _label(close, open)
    rec = _recording()
    if like.is_cuda:
        ident = _label_id(text)
        if rec is not None:
            rec.labels.append(text)
            mark_cuda(like.device, ident)
            return
        prepare(like.device)
        with _lock:         # slots in the order of the launches
            first = _heads.get(like.device, 0)
            _heads[like.device] = first + 1
            if tracing():
                _log.append(_Logged(like.device, first, (text,),
                                    _open_span(), None))
            mark_cuda(like.device, ident)
    elif rec is not None:
        rec.labels.append(text)
    elif tracing():
        with _lock:
            _log.append(_Logged(like.device, None, (text,), _open_span(),
                                [time.perf_counter_ns()]))


# -- the report ---------------------------------------------------------------

def _read_rings(log: list) -> dict:
    """Each card's ring as (ids, stamps) numpy arrays and its head, for the
    devices the log names, once their work is done."""
    from ..ops import cuda_build
    out = {}
    for device in {e.device for e in log if e.first is not None}:
        words = np.empty((RING_SLOTS, 2), dtype=np.uint64)
        with torch.cuda.device(device):
            cuda_build.check(_lib().tfhe_marks_read(words.ctypes.data),
                             "reading the marks' ring")
        out[device] = (words[:, 0], words[:, 1], _heads.get(device, 0))
    return out


def _marks(log: list) -> tuple:
    """The logged marks in order, (label, ns or None, device, host span),
    and why any stamps are lost."""
    rings, marks, lost = _read_rings(log), [], []
    for e in log:
        for i, text in enumerate(e.labels):
            if e.first is None:
                marks.append((text, e.stamps[i], e.device, e.host))
                continue
            ids, stamps, head = rings[e.device]
            slot = e.first + i
            t = None
            if head - slot > RING_SLOTS:
                lost.append(f"slot {slot} on {e.device}: the ring has "
                            f"wrapped past it (head {head})")
            elif ids[slot % RING_SLOTS] != _labels[text]:
                lost.append(f"slot {slot} on {e.device}: another mark ran "
                            f"there than {text!r}")
            else:
                t = int(stamps[slot % RING_SLOTS])
            marks.append((text, t, e.device, e.host))
    return marks, lost


def _device_spans(marks: list, host_request: dict) -> tuple:
    """The spans the marks open and close, as one stack a device."""
    spans, stacks, errors = [], {}, []
    for text, t, device, host in marks:
        close, _, opened = text.partition("|")
        stack = stacks.setdefault(device, [])
        for name in filter(None, close.split(",")):
            if not stack or spans[stack[-1]]["name"] != name:
                errors.append(f"a mark closes {name!r}, which is not open")
                continue
            spans[stack.pop()]["end_ns"] = t
        for name in filter(None, opened.split(",")):
            parent = stack[-1] if stack else None
            host_span = spans[parent]["host"] if parent is not None else host
            stack.append(len(spans))
            spans.append({"id": len(spans), "name": name, "start_ns": t,
                          "end_ns": None, "parent": parent, "host": host_span,
                          "request": host_request.get(host_span),
                          "device": str(device)})
    return spans, errors


def _seconds(s: dict):
    if s["start_ns"] is None or s["end_ns"] is None:
        return None
    return (s["end_ns"] - s["start_ns"]) * 1e-9


def _layers(spans: list, parent_of) -> dict:
    """By name: how many spans, their seconds, and their self seconds (less
    what their children cover); spans with a lost stamp are left out."""
    children = collections.defaultdict(float)
    for s in spans:
        p, d = parent_of(s), _seconds(s)
        if p is not None and d is not None:
            children[p] += d
    out = {}
    for s in spans:
        d = _seconds(s)
        if d is None:
            continue
        row = out.setdefault(s["name"], {"count": 0, "s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["s"] += d
        row["self_s"] += d - children[s["id"]]
    return out


def report() -> dict:
    """What tracing recorded: ``host_spans`` (closed ones, in the order
    they closed), ``marks`` (the logged marks in order: label, stamp in
    ns, device), ``device_spans`` (decoded from them: a span whose stamp
    is lost has None for it, and ``lost`` says why),
    ``marks_logged`` (the logged marks a card ran: as many MARK_KERNEL
    records as a profile of the same window holds), ``counters`` (units'
    warm-ups, captures and replays, WoPBS runs by shape, mark launches, and
    the rotate calls and those of them whose K2 ran split and whose K1 ran
    persistently) and ``layers`` (by host and device span name: count,
    seconds, self seconds).  Reads the rings of the cards with logged
    marks."""
    with _lock:
        host = [dict(s) for s in _spans]
        log = list(_log)
        counts = collections.Counter(COUNTS)
    units = {}
    for (_, name, what), n in tagged("unit", counts).items():
        units.setdefault(name, dict.fromkeys(
            ("warm_ups", "captures", "replays"), 0))[what] = n
    marks, lost = _marks(log)
    request = {s["id"]: s["request"] for s in host}
    device, errors = _device_spans(marks, request)
    by_id = {s["id"]: s for s in host}
    return {
        "host_spans": host,
        "device_spans": device,
        "marks": [{"label": text, "ns": t, "device": str(dev)}
                  for text, t, dev, _ in marks],
        "marks_logged": sum(e.first is not None for e in log
                            for _ in e.labels),
        "lost": lost + errors,
        "counters": {
            "units": units,
            "wopbs": [{"bytes": b, "luts": luts, "bits": bits, "runs": n}
                      for (_, b, luts, bits), n in sorted(
                          tagged("wopbs", counts).items())],
            **{key: counts[key] for key in (
                "mark_launches", "rotate_calls", "rotate_split_calls",
                "rotate_persistent_calls")}},
        "layers": {
            "host": _layers(host, lambda s: s["parent"]
                            if s["parent"] in by_id else None),
            "device": _layers(device, lambda s: s["parent"])}}


def dump(path) -> None:
    """report() as JSON at `path`."""
    with open(path, "w") as f:
        json.dump(report(), f, indent=1)


# -- what the benchmark's readers take from a report --------------------------

def device_seconds(rep: dict, name: str) -> list:
    """The seconds of each device span named `name` whose stamps remain."""
    return [d for s in rep["device_spans"] if s["name"] == name
            for d in [_seconds(s)] if d is not None]


def device_share(rep: dict, part: str, whole: str):
    """% of the device seconds of the spans `whole` that the spans `part`
    take; None where there are none."""
    total = sum(device_seconds(rep, whole))
    return 100.0 * sum(device_seconds(rep, part)) / total if total else None


def request_seconds(rep: dict, request: str, names) -> list:
    """For each top-level host span named `request`, the seconds of the
    spans under it named in `names`."""
    tops = {s["id"]: 0.0 for s in rep["host_spans"]
            if s["name"] == request and s["parent"] is None}
    for s in rep["host_spans"]:
        if s["request"] in tops and s["name"] in names:
            tops[s["request"]] += (s["end_ns"] - s["start_ns"]) * 1e-9
    return list(tops.values())
