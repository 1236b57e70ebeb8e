"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
idle gaps and the device time of kernels by name.

Events are read from the profiler's raw (Kineto) results, whose host and
device timestamps share one clock.  A trace of host and device activity is
bounded by two zero-length host markers (``WINDOW_START`` and
``WINDOW_END``) that the traced run records; a trace of device activity
alone, which holds no host events, by its first device operation's start
and its last one's end.
"""

from __future__ import annotations

import dataclasses
import re

WINDOW_START = "bench.window.start"
WINDOW_END = "bench.window.end"


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    n_ops: int  # device operations that started in the window
    by_name: dict  # device op name -> [count, seconds]
    gaps: list  # [(host label, seconds)] of idle time, summed by label, largest first

    def kernel_seconds(self, names) -> tuple[float, int]:
        """Device seconds and launches of the ops whose name contains one of
        `names` as a whole word."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        secs = count = 0
        for name, (n, s) in self.by_name.items():
            if pat.search(name):
                secs += s
                count += n
        return secs, count


def reduce(events, device_types=("CUDA",), marked: bool = True) -> Trace:
    """A `Trace` of Kineto events (``prof.profiler.kineto_results.events()``),
    over the window between the markers or, not `marked`, over the device's
    first to last operation."""
    dev, host = [], []
    marks = {WINDOW_START: [], WINDOW_END: []}
    for e in events:
        name = e.name()
        t0 = _ns(e, "start")
        kind = str(e.device_type()).split(".")[-1]
        if kind in device_types:
            dev.append((t0, t0 + _ns(e, "duration"), name))
        elif name in marks:
            marks[name].append(t0)
        else:
            host.append((t0, t0 + _ns(e, "duration"), name))
    if not marked:
        if not dev:
            raise RuntimeError("the trace holds no device operation")
        w0, w1 = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    elif not marks[WINDOW_START] or not marks[WINDOW_END]:
        raise RuntimeError("the trace lacks the window's markers")
    else:
        w0, w1 = min(marks[WINDOW_START]), max(marks[WINDOW_END])
    return reduce_intervals(dev, host, w0, w1)


def reduce_intervals(dev, host, w0: int, w1: int) -> Trace:
    """A `Trace` of device intervals `dev` and host intervals `host`, each
    [(start_ns, end_ns, name)], over the window [w0, w1]."""
    by_name: dict = {}
    spans = []
    n_ops = 0
    for t0, t1, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if w0 <= t0 < w1:
            n_ops += 1
        if b <= a:
            continue
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-9
        spans.append((a, b))
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, n_ops=n_ops,
                 by_name=by_name, gaps=_label_gaps(gaps, host))


def _label_gaps(gaps, host) -> list:
    """Idle seconds summed by what the host was doing at each gap's middle:
    the innermost host event that spans it (the latest-starting one of the
    nested events open there), or ``host (no op)``."""
    totals: dict = {}
    points = sorted(((a + b) // 2, b - a) for a, b in gaps)
    events = sorted(host, key=lambda e: (e[0], -e[1]))  # outer events first
    stack: list = []  # open (end, name), innermost last
    i = 0
    for mid, length in points:
        while i < len(events) and events[i][0] <= mid:
            while stack and stack[-1][0] < events[i][0]:
                stack.pop()
            stack.append((events[i][1], events[i][2]))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else "host (no op)"
        totals[label] = totals.get(label, 0.0) + length * 1e-9
    return sorted(totals.items(), key=lambda kv: -kv[1])


def breakdown(device: Trace, labelled: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time in
    the `device` trace and the idle time by what the host was doing in the
    `labelled` one, each [[name, seconds], ...]."""
    ops = sorted(device.by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name, secs] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in labelled.gaps[:top]]}
