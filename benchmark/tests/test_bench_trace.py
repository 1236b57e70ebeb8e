"""The trace reduction: busy and idle time, ops, kernel time by name, the
idle gaps labelled by the host and device time by program span, from
synthetic intervals."""

import pytest

from harness import spec, trace

MS = 1_000_000  # ns


def synthetic():
    dev = [(1 * MS, 3 * MS, "void gn_kernel<false>(float*)"),
           (2 * MS, 4 * MS, "splat_votes_kernel"),  # overlaps the first
           (6 * MS, 7 * MS, "splat_tiles_kernel"),
           (9 * MS, 12 * MS, "Memcpy DtoH")]  # runs past the window's end
    host = [(4 * MS, 6 * MS, "aten::item"), (4 * MS, 9 * MS, "python step"),
            (7 * MS, 9 * MS, "aten::index_put_")]
    return trace.reduce_intervals(dev, host, 0, 10 * MS)


def test_busy_idle_and_ops():
    t = synthetic()
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.003 + 0.001 + 0.001)
    assert t.n_ops == 4
    assert t.kernel_seconds(["gn_kernel"]) == (pytest.approx(0.002), 1)
    assert t.kernel_seconds(["splat_votes_kernel", "splat_tiles_kernel"]) == (
        pytest.approx(0.003), 2)


def test_gaps_by_host_activity():
    gaps = dict(synthetic().gaps)
    # Gaps: [0,1) no host op, [4,6) aten::item (innermost), [7,9) index_put_.
    assert gaps["host (no op)"] == pytest.approx(0.001)
    assert gaps["aten::item"] == pytest.approx(0.002)
    assert gaps["aten::index_put_"] == pytest.approx(0.002)
    assert sum(gaps.values()) == pytest.approx(0.010 - 0.005)
    b = trace.breakdown(synthetic(), synthetic())
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) == 3


class Event:
    """A Kineto event as ``reduce`` reads it."""

    def __init__(self, name, start_ns, end_ns, kind, corr=0, user=False):
        self._n, self._s, self._d, self._k = name, start_ns, end_ns - start_ns, kind
        self._c, self._u = corr, user

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._u

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._k}"


def test_device_only_trace_is_bounded_by_its_operations():
    events = [Event("gn_kernel", 2 * MS, 3 * MS, "CUDA"),
              Event("cudaLaunchKernel", 1 * MS, 2 * MS, "CPU"),
              Event("splat_tiles_kernel", 5 * MS, 6 * MS, "CUDA")]
    t = trace.reduce(events, marked=False)
    assert t.window_s == pytest.approx(0.004)
    assert t.busy_s == pytest.approx(0.002)
    with pytest.raises(RuntimeError):
        trace.reduce(events)  # a marked trace needs its markers
    marked = events + [Event(trace.WINDOW_START, 0, 0, "CPU"),
                       Event(trace.WINDOW_END, 10 * MS, 10 * MS, "CPU")]
    assert trace.reduce(marked).window_s == pytest.approx(0.010)


def test_idle_share_metric_reads_the_trace():
    """Busy seconds a frame from the trace against the untraced head's
    seconds a frame."""
    mod = spec.load_metric("device_idle_share")

    class Run:
        trace = synthetic()  # 5 ms busy
        traced_frames = 5  # 1 ms busy a frame
        head_frames, head_s = 20, 0.04  # 2 ms a frame untraced

    assert mod.read(Run) == pytest.approx(50.0)
    Run.head_frames = 0
    assert mod.read(Run) is None
    Run.trace = None
    assert mod.read(Run) is None


def spans_trace():
    """Launches (host instant, correlation id) and what they ran, in a
    window [0, 20] ms:

    - ``outer`` [1, 9] holds ``inner`` [2, 4] and a second ``inner`` [3, 5]
      nested in it; ``outer`` opens again at [15, 16];
    - launch 1 at 2.5 (in both inners), 2 at 6 (outer alone), 3 at 10 (no
      span), 4 at 15.5 a graph of three kernels (outer's second range);
    - launch 5 at -1, before the window, inside an ``outer`` range that
      opened before it; op 6 has no launch in the trace."""
    dev = [(3 * MS, 4 * MS, "k1", 1), (7 * MS, 8 * MS, "k2", 2),
           (11 * MS, 12 * MS, "k3", 3),
           (16 * MS, 17 * MS, "g_a", 4), (17 * MS, 18 * MS, "g_b", 4),
           (18 * MS, 19 * MS, "g_c", 4),
           (0, 1 * MS, "early", 5), (5 * MS, 6 * MS, "orphan", 6)]
    host = [(1 * MS, 9 * MS, "outer"), (2 * MS, 4 * MS, "inner"), (3 * MS, 5 * MS, "inner"),
            (15 * MS, 16 * MS, "outer"), (-2 * MS, 0, "outer")]
    launches = {1: 2.5 * MS, 2: 6 * MS, 3: 10 * MS, 4: 15.5 * MS, 5: -1 * MS}
    return trace.reduce_intervals(dev, host, 0, 20 * MS, launches)


def test_span_holds_the_work_launched_in_it():
    t = spans_trace()
    # Nested spans: inner's two ranges hold launch 1 once; outer holds 1
    # and 2 and, in its second range, the graph's three kernels.
    assert t.span_seconds("inner") == (pytest.approx(0.001), 1, 2)
    assert t.span_seconds("outer") == (pytest.approx(0.005), 5, 2)


def test_work_outside_every_span_counts_under_none():
    t = spans_trace()
    # Of the window's eight ops, k3 (launched outside any span), "early"
    # (launched before the window, in a range that opened before it) and
    # the orphan (its launch not in the trace) count under no span.
    assert t.n_ops == 8
    assert t.span_seconds("outer")[1] + t.span_seconds("inner")[1] == 5 + 1
    assert t.span_seconds("absent") == (0.0, 0, 0)


def test_a_graph_launch_counts_its_kernels_under_its_span():
    dev = [(2 * MS, 3 * MS, "g_a", 7), (3 * MS, 5 * MS, "g_b", 7)]
    t = trace.reduce_intervals(dev, [(1 * MS, 2 * MS, "replay")], 0, 10 * MS,
                               {7: 1.5 * MS})
    assert t.span_seconds("replay") == (pytest.approx(0.003), 2, 1)


def test_device_only_trace_has_no_spans():
    with pytest.raises(ValueError):
        synthetic().span_seconds("outer")


def test_reduce_knows_a_launch_by_its_name():
    """Host ops and user ranges number their correlation ids as launches do:
    only a CUDA call launches, and the device's copy of a user range is no
    device operation."""
    events = [Event(trace.WINDOW_START, 0, 0, "CPU", corr=1, user=True),
              Event("span", 1 * MS, 5 * MS, "CPU", corr=2, user=True),
              Event("aten::mm", 2 * MS, 3 * MS, "CPU", corr=3),
              Event("cudaLaunchKernel", 2 * MS, 3 * MS, "CPU", corr=9),
              Event("gemm", 4 * MS, 6 * MS, "CUDA", corr=9),
              Event("span", 4 * MS, 6 * MS, "CUDA", corr=2, user=True),
              Event("aten::add", 7 * MS, 8 * MS, "CPU", corr=9),
              Event("cuLaunchKernel", 7 * MS, 8 * MS, "CPU", corr=4),
              Event("add", 8 * MS, 9 * MS, "CUDA", corr=4),
              Event(trace.WINDOW_END, 10 * MS, 10 * MS, "CPU", corr=5, user=True)]
    t = trace.reduce(events)
    assert t.n_ops == 2 and t.busy_s == pytest.approx(0.003)
    assert t.span_seconds("span") == (pytest.approx(0.002), 1, 1)
    assert t.span_seconds("aten::add") == (pytest.approx(0.001), 1, 1)
