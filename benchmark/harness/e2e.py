"""End-to-end metrics of one window, from the host's clock.

- ``fps``: frames whose result completed, over the whole window, from the
  first frame's release to the last frame's completion.
- ``setup_s``: process start to the first frame's release.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    t_process: float  # process start
    t_first: float  # first frame's release
    t_end: float  # last frame's completion (the pipeline's final sync)
    n_frames: int


def fps(w: Window) -> float:
    return w.n_frames / (w.t_end - w.t_first)


def setup_s(w: Window) -> float:
    return w.t_first - w.t_process


METRICS = {"fps": fps, "setup_s": setup_s}
