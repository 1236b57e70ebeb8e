"""The one-card engine step replayed from CUDA graphs: ``pipeline.run``'s
main path on the card.

A frame of ``slam.step`` is some 650 launches of small kernels, each behind
its Python; on the block map with splat prediction the card waits for the
host through most of a frame.  ``GraphedStep`` runs the first
``LEAD_FRAMES`` steps eagerly (the kernels' one-time set-up: the libraries'
load, K3's grid, the K3/K6 workspace, K1's taps), then captures the step
once in a CUDA graph and replays it: one launch a frame.

The graph reads and writes fixed tensors: the step's state leaves (the
fields ``STATE_FIELDS`` names) and the frame's depth and color.  The
captured region ends by copying the step's new leaves into those tensors,
so one replay advances the state in place; the map's payload (sdf, weight,
color) is updated in place by K4 and needs no copy.  Before a replay, each
leaf that the caller has rebound since the last frame (a relocalization, a
local loop, ``clean``, streaming) is copied in, found by identity.  The
state returned holds the fixed tensors, and the next replay overwrites
them; its ``StepInfo`` lies in the graph's memory and holds until then.

The color cadence is decided on the host (``slam._splat_map_update``), so
the color frames and the others replay graphs of their own.
"""

from __future__ import annotations

import torch

from instancefusion_tpu_torch.config import EngineConfig
from instancefusion_tpu_torch.engine import slam

# Eager steps of a run before its first capture.
LEAD_FRAMES = 2

# The SlamState fields the step reads and rebinds.  votes and table (the
# instance path's) are left as they come; frame_count is the host's.
STATE_FIELDS = ("T_wc", "volume", "pred", "pred_T_wc", "frame_idx", "lost_frames",
                "T_prev_wc", "stamp", "prev_coarse", "drift_ewma")


def engages(cfg: EngineConfig, device, gt_odometry: bool = False) -> bool:
    """Whether ``pipeline.run`` replays the step from a graph: on a CUDA
    device, on one card (a shard group's gloo collectives cannot be
    captured), on the block map with splat prediction (the path the card
    tests hold in a graph), with tracking (no ``gt_odometry``)."""
    return (torch.device(device).type == "cuda" and cfg.num_shards <= 1
            and cfg.map_kind == "blocks" and cfg.raycast.use_splat and not gt_odometry)


def _parts(x) -> tuple:
    return () if x is None else tuple(x) if isinstance(x, tuple) else (x,)


def leaves(state) -> list:
    """The tensors of `state`'s ``STATE_FIELDS``, in order."""
    return [t for name in STATE_FIELDS for t in _parts(getattr(state, name))]


def with_leaves(state, tensors):
    """`state` with the tensors of its ``STATE_FIELDS`` taken from `tensors`,
    in the order ``leaves`` gives them."""
    it = iter(tensors)
    fields = {}
    for name in STATE_FIELDS:
        x = getattr(state, name)
        if isinstance(x, tuple):
            vals = [next(it) for _ in x]
            fields[name] = x._make(vals) if hasattr(x, "_make") else tuple(vals)
        elif x is not None:
            fields[name] = next(it)
    return state._replace(**fields)


def _memory(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _distinct(tensors) -> list:
    """The tensors, each cloned where it shares memory with an earlier one
    (a step gives one pose tensor to T_wc and pred_T_wc)."""
    seen, out = set(), []
    for t in tensors:
        if t.numel() and _memory(t) in seen:
            t = t.clone()
        seen.add(_memory(t))
        out.append(t)
    return out


def _copy(dst, src) -> None:
    """dst[i] <- src[i] wherever they are two tensors, one multi-tensor copy
    a dtype.  A source sharing memory with a destination is cloned before
    any copy, so that no copy reads what another wrote."""
    pairs = [(d, s) for d, s in zip(dst, src) if s is not d and d.numel()]
    written = {_memory(d) for d, _ in pairs}
    groups: dict = {}
    for d, s in pairs:
        if _memory(s) in written:
            s = s.clone()
        ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class GraphedStep:
    """``slam.step`` on one card, called as it is: eager for the first
    ``LEAD_FRAMES`` calls, then replayed from a CUDA graph, one for the
    color frames and one for the others.  ``replays`` counts the frames
    that ran as a replay.  Made by one run and dropped with it, so no graph
    outlives the run."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.eager = 0
        self.replays = 0
        self.static = None  # the state leaves the graphs read and write
        self.inputs = None  # the frame's depth and color
        self.graphs: dict = {}  # color frame or not -> its graph's replay

    def __call__(self, state, depth, color):
        if self.eager < LEAD_FRAMES:
            self.eager += 1
            return slam.step(self.cfg, state, depth, color)
        frame = slam._inputs(state, depth, color)
        if self.static is None:
            self.static = _distinct(leaves(state))
            self.inputs = [x.clone() for x in frame]
        else:
            _copy(self.static, leaves(state))
            _copy(self.inputs, frame)
        fixed = with_leaves(state, self.static)
        color_frame = state.frame_count % max(self.cfg.color_every, 1) == 0
        if color_frame not in self.graphs:
            self.graphs[color_frame] = self._capture(fixed)
        info = self.graphs[color_frame]()
        self.replays += 1
        return fixed._replace(frame_count=state.frame_count + 1), info

    def _step_in_place(self, state):
        """One step from `state`, whose leaves are the fixed tensors, on the
        fixed inputs, its new leaves copied into the fixed tensors; returns
        its ``StepInfo``."""
        new, info = slam.step(self.cfg, state, *self.inputs)
        _copy(self.static, leaves(new))
        return info

    def _capture(self, state):
        """``_step_in_place(state)`` captured in a CUDA graph, which runs
        nothing yet; returns the replay: a function that launches the graph
        and returns the ``StepInfo`` it rewrites."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            info = self._step_in_place(state)

        def replay():
            graph.replay()
            return info

        return replay
