"""The reduction of a traced span to what the per-layer metrics read.

The profiler's device records (kernels, copies, fills) and the harness's
own spans (``bench:<phase>``, host annotations) share one clock.  The
traced window runs from the first traced request's issue to the last
one's completion; a device second is busy when some record covers it.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import statistics

from . import rooflines

SPAN_PREFIX = "bench:"


@dataclasses.dataclass
class Trace:
    """What a traced run gives its metric readers.

    ops: device records (name, start s, end s) inside the window; spans:
    the harness's (phase, start s, end s); work: rooflines.work of the
    traced requests; keyexp_s: the host seconds of each session's key
    schedule over the whole traced run (a device fence after it);
    rank_call_s: on a mesh, each rank's device seconds of each of the
    window's CTR calls (CUDA events around it), rank 0's first; launched:
    the count of every device record of the profile by name, those the
    window's edges cut off too (None: ops are all the records)."""
    ops: list
    spans: list
    window: tuple
    work: dict
    keyexp_s: list
    rank_call_s: list = dataclasses.field(default_factory=list)
    launched: dict | None = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some device record runs."""
        return sum(end - start for start, end in self._busy())

    def _busy(self) -> list:
        merged = []
        for _, start, end in sorted(self.ops, key=lambda op: op[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def seconds(self, kernels=None) -> float:
        """Device seconds of the records whose name holds one of
        `kernels` (all records: None)."""
        return sum(end - start for name, start, end in self.ops
                   if kernels is None or any(k in name for k in kernels))

    def count(self, kernel: str) -> int:
        """The profile's records whose name holds `kernel`, those that the
        window's edges cut off too: the device's clock, as the profile
        maps it onto the host's, can put the last records of the traced
        span a few milliseconds past the host's end of it."""
        launched = self.launched
        if launched is None:
            launched = collections.Counter(name for name, _, _ in self.ops)
        return sum(n for name, n in launched.items() if kernel in name)

    def gaps(self) -> list:
        """The idle gaps, each (what the host was doing, seconds): the
        innermost harness span around the gap's middle, else "harness"."""
        out, last = [], self.window[0]
        for start, end in self._busy() + [[self.window[1]] * 2]:
            if start > last:
                mid = (start + last) / 2
                inside = [s for s in self.spans if s[1] <= mid <= s[2]]
                name = (max(inside, key=lambda s: s[1])[0] if inside
                        else "harness")
                out.append((name, start - last))
            last = max(last, end)
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def from_profile(events, work: dict, keyexp_s: list,
                 rank_call_s=()) -> Trace:
    """A Trace from the profile's events of the traced span, each (name,
    on the device, start s, end s).  A device record named as a harness
    span is the span's mirror on the device's timeline, not work."""
    spans, ops = [], []
    for name, on_device, start, end in events:
        if not name.startswith(SPAN_PREFIX):
            if on_device:
                ops.append((name, start, end))
        elif not on_device:
            spans.append((name[len(SPAN_PREFIX):], start, end))
    requests = [s for s in spans if s[0] == "request"]
    if not requests:
        raise RuntimeError("the profile holds no traced request")
    window = (min(s[1] for s in requests), max(s[2] for s in requests))
    launched = collections.Counter(name for name, _, _ in ops)
    ops = [(name, max(start, window[0]), min(end, window[1]))
           for name, start, end in ops
           if end > window[0] and start < window[1]]
    return Trace(ops, spans, window, work, keyexp_s, list(rank_call_s),
                 dict(launched))


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    by_name = {}
    for name, start, end in trace.ops:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": [list(kv) for kv in top],
            "idle_gaps": [list(g) for g in gaps]}


def records_found(trace: Trace) -> dict:
    """Each counted kernel's records in the trace against the launches the
    traced work takes: a share under 1 means the profiler dropped some."""
    want = {"br_forward_mac_kernel": trace.work["rotate_steps"],
            "br_inverse_crt_kernel": trace.work["rotate_steps"],
            "vp_forward_mac_kernel": trace.work["vp_bits"]}
    return {k: (trace.count(k), n) for k, n in want.items()}


# -- what the metric files call ---------------------------------------------

def roofline(trace: Trace, what: str):
    """% of the traced device time of the rotate ("rotate") or vertical
    packing ("vp") kernels that their bound for the traced work is; None
    where the trace holds none of them."""
    kernels = {"rotate": rooflines.ROTATE_KERNELS,
               "vp": rooflines.VP_KERNELS}[what]
    spent = trace.seconds(kernels)
    if spent <= 0:
        return None
    return 100.0 * trace.work[f"{what}_s"] / spent


def outside_kernels_share(trace: Trace):
    """% of the traced device time outside the rotate and VP kernels."""
    total = trace.seconds()
    if total <= 0:
        return None
    inside = trace.seconds(rooflines.ROTATE_KERNELS + rooflines.VP_KERNELS)
    return 100.0 * (total - inside) / total


def idle_share(trace: Trace):
    """% of the traced window in which no device record runs."""
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def median_keyexp_s(trace: Trace):
    return statistics.median(trace.keyexp_s) if trace.keyexp_s else None


def collective_share(trace: Trace, span: str):
    """% of the traced device time in NCCL records (a name holding
    "nccl"), None where the trace holds none or no harness span `span`:
    the collectives that span launches, where no other code of the traced
    request launches one."""
    total = trace.seconds()
    nccl = sum(end - start for name, start, end in trace.ops
               if "nccl" in name.lower())
    if total <= 0 or nccl <= 0 \
            or not any(s[0] == span for s in trace.spans):
        return None
    return 100.0 * nccl / total


def rank_skew(trace: Trace):
    """% by which the slowest rank's median CTR call outlasts the
    fastest's, over the window's calls; None with under two ranks or
    without device records (a CPU run's calls are host seconds)."""
    medians = [statistics.median(s) for s in trace.rank_call_s if s]
    if not trace.ops or len(medians) < 2:
        return None
    return 100.0 * (max(medians) - min(medians)) / min(medians)
