"""Camera traffic as the program takes it: an iterable of device-resident
frames, replayed as fast as the pipeline asks (closed loop).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from harness import scene


class Frame(NamedTuple):
    depth: torch.Tensor  # f32[H, W] meters, 0 = no depth
    color: torch.Tensor  # f32[H, W, 3] in [0, 1]
    index: int  # frame number in the window


class FrameSource:
    """The window's frames: loop frame k % L for window frame k, turned from
    the log's integers into the program's floats as it is handed over.

    ``mode`` "replay": the next frame goes in when the pipeline asks for it,
    until `seconds` have passed since the first frame's release.  Before
    frame k is handed over, ``on_frame(k)`` runs, if given (the traced
    run's profiler phases); ``on_end()`` runs once the last frame is out.
    """

    def __init__(self, depth, color, mode: str, seconds: float, on_frame=None, on_end=None,
                 clock=time.perf_counter):
        if mode != "replay":
            raise ValueError(f"unknown traffic mode {mode!r}")
        self.depth, self.color = depth, color
        self.seconds = seconds
        self.on_frame, self.on_end = on_frame, on_end
        self.clock = clock
        self.t0 = None
        self.release: list[float] = []
        self.order: list[int] = []

    def __iter__(self):
        n_loop = self.depth.shape[0]
        k = 0
        while True:
            if self.on_frame is not None:
                self.on_frame(k)
            now = self.clock()
            if k == 0:
                self.t0 = now
            elif now - self.t0 >= self.seconds:
                break
            c = k % n_loop
            self.release.append(now)
            self.order.append(c)
            yield Frame(*scene.frame(self.depth, self.color, c), k)
            k += 1
        if self.on_end is not None:
            self.on_end()
