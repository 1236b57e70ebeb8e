"""The trace reduction: busy and idle time, ops, kernel time by name and the
idle gaps labelled by the host, from synthetic intervals."""

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

    def __init__(self, name, start_ns, end_ns, kind):
        self._n, self._s, self._d, self._k = name, start_ns, end_ns - start_ns, kind

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
