"""K3's share of its roofline: the least time of the traced frames' Gauss-Newton
launches (each the larger of its bytes at 3.35 TB/s and its operations at
67 TFLOP/s, ``harness/work.gn``), over the device time of ``gn_kernel``."""

from harness import work

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "fps"
UNIT = "%"
KERNELS = ("gn_kernel",)


def read(run):
    recs = run.work[run.traced_first:run.traced_first + run.traced_frames]
    if run.trace is None or not recs:
        return None
    secs, launches = run.trace.kernel_seconds(KERNELS)
    if secs <= 0 or launches == 0:
        return None
    return 100.0 * sum(work.gn_least_seconds(run.engine, r) for r in recs) / secs
