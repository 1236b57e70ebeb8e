"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
idle gaps, the device time of kernels by name and, where the trace records
the host, the device time of program spans.

Events are read from the profiler's raw (Kineto) results, whose host and
device timestamps share one clock.  A trace of host and device activity is
bounded by two zero-length host markers (``WINDOW_START`` and
``WINDOW_END``) that the traced run records; a trace of device activity
alone, which holds no host events, by its first device operation's start
and its last one's end.

A span is a host range recorded with ``torch.profiler.record_function(name)``.
A device operation belongs to it when the CUDA runtime or driver call that
launched it lies inside one of the span's ranges: Kineto gives the launch
(``cudaLaunchKernel``, ``cudaGraphLaunch``, a copy's or a fill's call) and
the operations it started one ``correlation_id``, so every kernel a CUDA
graph replays counts under the span that holds its ``cudaGraphLaunch``.
Host ops and user ranges number their own ``correlation_id`` from the same
small integers, so a launch is known by its name (``cuda...``, ``cu...``)
as well.  The device-side copies of user ranges that Kineto adds are no
device operations and are left out.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

WINDOW_START = "bench.window.start"
WINDOW_END = "bench.window.end"
# A CUDA runtime or driver call: the host events that launch device work.
LAUNCH = re.compile(r"cu(da)?[A-Z]")


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
    spans: Spans | None = None  # where the trace records the host

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

    def span_seconds(self, name: str) -> tuple[float, int, int]:
        """(device seconds, device operations, span instances) of the host
        span `name`; see ``Spans``."""
        if self.spans is None:
            raise ValueError("a trace of device activity alone holds no spans")
        return self.spans.seconds(name)


@dataclasses.dataclass
class Spans:
    """Device time by the host range that launched it.  Counted: the
    device operations whose launch lies in the window and inside a range of
    the span (once, where ranges of one name nest), with their time inside
    the window, and the span's ranges that start in the window.  An
    operation whose launch the trace lacks, or whose launch lies outside
    the window, counts under no span."""
    launch_ns: list  # launch instant of each attributed operation, ascending
    cum_s: list  # device seconds of the operations before each, and of all
    ranges: dict  # host event name -> [(start_ns, end_ns)] of ranges that start in the window

    def seconds(self, name: str) -> tuple[float, int, int]:
        ranges = sorted(self.ranges.get(name, []))
        merged: list = []
        for a, b in ranges:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        secs, ops = 0.0, 0
        for a, b in merged:
            i = bisect.bisect_left(self.launch_ns, a)
            j = bisect.bisect_right(self.launch_ns, b)
            secs += self.cum_s[j] - self.cum_s[i]
            ops += j - i
        return secs, ops, len(ranges)


def reduce(events, device_types=("CUDA",), marked: bool = True) -> Trace:
    """A `Trace` of Kineto events (``prof.profiler.kineto_results.events()``),
    over the window between the markers or, not `marked`, over the device's
    first to last operation.  A marked trace records the host: its `Trace`
    reads spans."""
    dev, host = [], []
    launches: dict = {}
    marks = {WINDOW_START: [], WINDOW_END: []}
    for e in events:
        name = e.name()
        t0 = _ns(e, "start")
        kind = str(e.device_type()).split(".")[-1]
        if kind in device_types:
            if e.is_user_annotation():
                continue
            dev.append((t0, t0 + _ns(e, "duration"), name, e.correlation_id()))
        elif name in marks:
            marks[name].append(t0)
        else:
            host.append((t0, t0 + _ns(e, "duration"), name))
            if LAUNCH.match(name) and not e.is_user_annotation():
                launches[e.correlation_id()] = t0
    if not marked:
        if not dev:
            raise RuntimeError("the trace holds no device operation")
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    elif not marks[WINDOW_START] or not marks[WINDOW_END]:
        raise RuntimeError("the trace lacks the window's markers")
    else:
        w0, w1 = min(marks[WINDOW_START]), max(marks[WINDOW_END])
    return reduce_intervals(dev, host, w0, w1, launches if marked else None)


def reduce_intervals(dev, host, w0: int, w1: int, launches: dict | None = None) -> Trace:
    """A `Trace` of device intervals `dev`, [(start_ns, end_ns, name,
    correlation id)], and host intervals `host`, [(start_ns, end_ns, name)],
    over the window [w0, w1].  With `launches` ({correlation id: launch
    instant in ns} of the host's launching calls) it reads spans."""
    by_name: dict = {}
    busy = []
    attributed = []
    n_ops = 0
    for t0, t1, name, *corr in dev:
        a, b = max(t0, w0), min(t1, w1)
        if w0 <= t0 < w1:
            n_ops += 1
        if launches is not None and corr:
            t_launch = launches.get(corr[0])
            if t_launch is not None and w0 <= t_launch <= w1:
                attributed.append((t_launch, max(b - a, 0) * 1e-9))
        if b <= a:
            continue
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-9
        busy.append((a, b))
    busy.sort()
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = None
    if launches is not None:
        attributed.sort()
        cum = [0.0]
        for _, secs in attributed:
            cum.append(cum[-1] + secs)
        ranges: dict = {}
        for t0, t1, name in host:
            if w0 <= t0 < w1:
                ranges.setdefault(name, []).append((t0, t1))
        spans = Spans(launch_ns=[t for t, _ in attributed], cum_s=cum, ranges=ranges)
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, n_ops=n_ops,
                 by_name=by_name, gaps=_label_gaps(gaps, host), spans=spans)


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
