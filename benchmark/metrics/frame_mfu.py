"""The whole frame's share of the card's peak: the least time of the counted
work of the traced run's untraced head (the window's first frames, before
any profiler ran), over the head's seconds on the host's clock, from the
first release to their completion.  Each judge that counts work
(``counted_work``; the SLAM judge's from ``harness/work.py``) gives its
bytes and fp32 operations of the head; their least time is the larger of
the bytes at 3.35 TB/s and the operations at 67 TFLOP/s, and the judges'
least times add, since a frame runs their work one after the other.  The
work is counted from the frames' data, so the number bounds a claim
however a later change implements a stage."""

from harness import work

LAYER = "whole frame"
SOURCE = "host_clock"
MOVES = "fps"
UNIT = "%"


def read(run):
    frames = run.head_frames or 0
    if frames == 0 or run.head_s <= 0:
        return None
    least = 0.0
    for name, mod in run.judges.items():
        counted = getattr(mod, "counted_work", None)
        if counted is not None and run.records.get(name):
            least += work.least_seconds(*counted(run.engine, run.records[name], frames))
    return 100.0 * least / run.head_s if least > 0 else None
