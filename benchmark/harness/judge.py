"""The comparison that decides ``correct``, made by the judges that the
configuration names (``"judges"`` in ``configs/<config>.json``; each a
module ``judges/<name>.py``), in that order.

A judge module holds a class ``Judge(cell, seed, dev, count_work)``.  The
replay's methods are required, the others optional:

- ``run_kw(window)``: a dict of arguments to ``engine.pipeline.run``, for
  the warm-up (`window` false) and for the measured window; a keyword that
  two judges, or a judge and the harness, both give is an error;
- ``keep(res, counters)``: what it keeps of the window's ``PipelineResult``
  and of the program's counters (``{"list_fill": ...}``), before the run
  lets them go;
- ``pred_frames(n)``: the window frames at which it needs the prediction
  of the judge before it;
- ``start(ctx)``, ``frame(ctx)`` once a window frame after the judges named
  before it, ``finish(ctx)`` -> (numbers, records).

The replay runs every frame of the window, in order, teacher-forced at the
poses the program served, on the program's device after the window, with
TF32 off, taking nothing the program made but its outputs.  Its context
(`Context`) carries the frame and what earlier judges left there.  The
module may also give ``counted_work(engine, records, frames)`` -> (bytes,
fp32 operations) of its work in the window's first `frames` frames, which
``metrics/frame_mfu.py`` sums over the judges.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from harness import scene
from harness import spec as _spec


def reference_config(engine: dict):
    from reference import config as rc

    return _spec.build(rc.EngineConfig, engine)


@dataclasses.dataclass
class Context:
    """The replay's state, shared by its judges.  Per frame: `k`, the raw
    depth and color `d_k` and `c_k`; the SLAM judge adds the served pose
    `T`, the filtered depth `d0`, the reference map after the frame
    `volume` and the prediction `pred` (None where none was made)."""
    cfg: object  # reference EngineConfig
    engine: dict
    dev: torch.device
    n: int
    pred_frames: set  # frames at which a judge needs the prediction
    k: int = -1
    d_k: torch.Tensor | None = None
    c_k: torch.Tensor | None = None
    T: torch.Tensor | None = None
    d0: torch.Tensor | None = None
    volume: object = None
    pred: object = None


def make(cell, seed: int, dev, count_work: bool) -> dict:
    """{name: Judge} of the cell's judges, in the configuration's order."""
    return {name: mod.Judge(cell, seed, dev, count_work)
            for name, mod in cell.judge_modules.items()}


def run_kw(judges: dict, base: dict, window: bool) -> dict:
    """`base` with every judge's arguments to ``pipeline.run``."""
    out = dict(base)
    for name, j in judges.items():
        if not hasattr(j, "run_kw"):
            continue
        for key, value in j.run_kw(window).items():
            if key in out:
                raise ValueError(f"judge {name!r} gives pipeline.run's {key!r} a second time")
            out[key] = value
    return out


def keep(judges: dict, res, counters: dict) -> None:
    for j in judges.values():
        if hasattr(j, "keep"):
            j.keep(res, counters)


def replay(judges: dict, engine: dict, depth: torch.Tensor, color: torch.Tensor,
           order) -> tuple[dict, dict]:
    """Teacher-forced replay of the window: returns (numbers of every judge,
    {judge: records}).  `depth` and `color` are the loop as the log holds
    it; frame k of the window is loop frame ``order[k]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = len(order)
    ctx = Context(cfg=reference_config(engine), engine=engine, dev=depth.device, n=n,
                  pred_frames=set())
    for j in judges.values():
        if hasattr(j, "pred_frames"):
            ctx.pred_frames.update(j.pred_frames(n))
    for j in judges.values():
        j.start(ctx)
    for k in range(n):
        ctx.k = k
        ctx.d_k, ctx.c_k = scene.frame(depth, color, int(order[k]))
        ctx.T = ctx.d0 = ctx.volume = ctx.pred = None
        for j in judges.values():
            j.frame(ctx)
    numbers, records = {}, {}
    for name, j in judges.items():
        nums, records[name] = j.finish(ctx)
        clash = set(nums) & set(numbers)
        if clash:
            raise ValueError(f"judge {name!r} gives {sorted(clash)} a second time")
        numbers.update(nums)
    return numbers, records


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) of the numbers that have a limit:
    correct when each is finite and within its limit."""
    checked = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checked[name] = [value, limit]
    return ok, checked
