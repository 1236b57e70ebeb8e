"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``): the
harness's modules import from ``benchmark/``, the program from the root."""

import copy
import dataclasses
import functools
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell, scale: int = 8):
    """`cell` at a size a CPU test holds: the frames cut by `scale`, a 128^3
    map of 4 cm voxels, a camera 12 times as fast (a short loop), short
    warm-up and traces."""
    cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config),
                               traffic=copy.deepcopy(cell.traffic))
    e = cell.config["engine"]
    i = e["intrinsics"]
    e["intrinsics"] = dict(fx=i["fx"] / scale, fy=i["fy"] / scale,
                           cx=(i["cx"] + 0.5) / scale - 0.5, cy=(i["cy"] + 0.5) / scale - 0.5,
                           width=i["width"] // scale, height=i["height"] // scale)
    e["tsdf"].update(voxel_size=0.04, trunc=0.16, grid_size=128, table_capacity=4096,
                     touched_capacity=1024)
    cell.config["assumed"]["speed_m_s"] = 3.0
    cell.traffic.update(warmup_frames=9, trace_after_s=0.5, trace_frames=6, label_frames=3,
                        pose_samples=4)
    return cell


def cell_of(config: str, traffic: str):
    """A cell of a configuration and a traffic mix from their files, whether
    or not BENCHMARK.json lists it."""
    from harness import spec

    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{config}.json")
    return spec.Cell(name=f"{config}.{traffic}", config=cfg,
                     traffic=spec.load_json(spec.BENCH_DIR / "traffic" / f"{traffic}.json"),
                     chips=1, end_to_end=[], per_layer=[], metric_modules={},
                     judge_modules={j: spec.load_judge(j) for j in cfg["judges"]})


@pytest.fixture
def tiny():
    """A cell at test size: BENCHMARK.json's, or one built from its files."""
    from harness import spec

    def make(workload: str):
        try:
            return shrink(spec.load_cell(workload))
        except KeyError:
            return shrink(cell_of(*workload.split(".")))

    return make


class FrameClock:
    """A clock that moves `dt` a frame: the window's frame source advances it
    as it releases a frame, the traced run's phases read it.  A window of
    `seconds` then holds seconds / dt frames and the untraced head
    trace_after_s / dt, however loaded the host is."""

    def __init__(self, dt: float):
        self.dt, self.ticks = dt, 0

    def tick(self) -> float:
        self.ticks += 1
        return self.ticks * self.dt

    def read(self) -> float:
        return self.ticks * self.dt


@pytest.fixture
def frame_clock(monkeypatch):
    """Runs of ``harness.cell.run_cell`` counted in frames: 0.05 s a frame."""
    from harness import cell as _cell
    from harness import traffic

    clock = FrameClock(0.05)
    monkeypatch.setattr(traffic, "FrameSource",
                        functools.partial(traffic.FrameSource, clock=clock.tick))
    monkeypatch.setattr(_cell, "Tracer", functools.partial(_cell.Tracer, clock=clock.read))
    return clock
