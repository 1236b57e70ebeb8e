"""Device operations (kernels, copies, fills) launched a frame in the traced
window: the step's launch count, which a CUDA graph or fused stages cut."""

LAYER = "engine step"
SOURCE = "device_trace"
MOVES = "fps"
UNIT = "ops/frame"


def read(run):
    if run.trace is None or run.traced_frames == 0 or run.trace.n_ops == 0:
        return None
    return run.trace.n_ops / run.traced_frames
