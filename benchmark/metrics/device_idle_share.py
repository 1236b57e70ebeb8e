"""Share of a frame's time in which no operation ran on the device: the
device's busy seconds a frame, from the trace of device activity alone,
against the host seconds a frame of the traced run's untraced head (the
window's first frames, before any profiler ran).  The profiler slows the
host's launches but not the device's operations, so the busy time comes
from the trace and the frame's length from frames that ran without it."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "fps"
UNIT = "%"


def read(run):
    if run.trace is None or run.traced_frames == 0 or not run.head_frames or run.head_s <= 0:
        return None
    busy = run.trace.busy_s / run.traced_frames
    return 100.0 * (1.0 - busy / (run.head_s / run.head_frames))
