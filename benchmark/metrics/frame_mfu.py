"""The whole frame's share of the card's peak: the least time of the counted
work (the larger of its bytes at 3.35 TB/s and its fp32 operations at 67
TFLOP/s; ``harness/work.py``) of the traced run's untraced head (the
window's first frames, before any profiler ran), over the head's seconds on
the host's clock, from the first release to their completion.  The work is
counted from the frames' data, so the number bounds a claim however a later
change implements a stage."""

from harness import work

LAYER = "whole frame"
SOURCE = "host_clock"
MOVES = "fps"
UNIT = "%"


def read(run):
    recs = run.work[:run.head_frames or 0]
    if not recs or run.head_s <= 0:
        return None
    n_bytes = n_flops = 0.0
    for rec in recs:
        for b, f in work.frame_stages(run.engine, rec).values():
            n_bytes += b
            n_flops += f
    return 100.0 * work.least_seconds(n_bytes, n_flops) / run.head_s
