"""The engine step replayed from CUDA graphs (``engine/step_graph.py``)
against the eager step.

The tests marked ``cuda`` run ``pipeline.run`` on the card at config2's
shapes, where the step runs as a graph replay, against a loop of eager
``slam.step`` and hold them equal bit for bit; they skip without a card.
The rest run on the CPU: the rule that engages the graph, ``LIST_FILL``'s
in-place counts, ``pipeline.run``'s eager path, and ``GraphedStep``'s
bookkeeping (fixed tensors, rebound leaves, the color cadence's two graphs)
with each replay run as the eager step it records.  The file imports
neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pipeline_graph.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from instancefusion_tpu_torch import config
from instancefusion_tpu_torch.config import (
    EngineConfig, IcpConfig, RaycastConfig, TsdfConfig,
)
from instancefusion_tpu_torch.datasets import synthetic
from instancefusion_tpu_torch.engine import pipeline, slam, step_graph
from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.ops import blocks

# tests/test_torch_kernels.py's test-scale block map with splat prediction.
SMALL = EngineConfig(
    intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120),
    tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                    origin=(-1.92, -1.92, -0.4), block_size=8,
                    table_capacity=1728, touched_capacity=512),
    icp=IcpConfig(iters=(10, 7, 7), min_valid=60),
    raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                          screen_space_normals=True, use_splat=True, splat_rmax=3),
    map_kind="blocks",
)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_states_equal(a, b):
    la, lb = step_graph.leaves(a), step_graph.leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(_bits(x), _bits(y)), f"leaf {i} differs"
    assert a.frame_count == b.frame_count


def _frames(cfg, n, device):
    poses = synthetic.orbit_trajectory(n, device=device)
    return poses, [synthetic.render_frame(poses[i], cfg.intrinsics, device=device)
                   for i in range(n)]


def _clean(cfg, state):
    return pipeline._Engine(cfg).clean(state)


def _eager_run(cfg, frames, T0, clean_every=0):
    """``pipeline.run``'s frame loop with loops off, by eager steps: the
    poses it returns (world from map is the identity) and the state."""
    state = slam.init_state(cfg, T0, T0.device)
    eye = torch.eye(4, dtype=torch.float32, device=T0.device)
    est = []
    for i, f in enumerate(frames):
        state, _ = slam.step(cfg, state, f.depth, f.color)
        if clean_every and (i + 1) % clean_every == 0:
            state = _clean(cfg, state)
        est.append(eye @ state.T_wc)
    return torch.stack(est).cpu().numpy(), state


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("case, device, gt, expect", [
    ("config2", "cuda", False, True),
    ("config2", "cpu", False, False),
    ("config2", "cuda", True, False),
    ("config4", "cuda", False, False),  # sharded
    ("march", "cuda", False, False),
    ("config1", "cuda", False, False),  # dense
])
def test_engagement_rule(case, device, gt, expect):
    """The graph engages on a CUDA device for one card's block map with
    splat prediction and tracking, and nowhere else: a pure function of
    the configuration, the device and ``gt_odometry``."""
    if case == "march":
        cfg = config.config2_tum_fr3_long_office()
        cfg = dataclasses.replace(cfg, raycast=dataclasses.replace(cfg.raycast,
                                                                   use_splat=False))
    else:
        cfg = config.PRESETS[case]()
    assert step_graph.engages(cfg, device, gt) is expect
    assert step_graph.engages(cfg, torch.device(device), gt) is expect


# ---------------------------------------------------------- LIST_FILL


def test_list_fill_accumulates_in_place():
    """Notes add to the same two tensors (a graph captured around a note
    adds at every replay); reset zeroes them without rebinding."""
    fill = blocks.ListFill()
    assert fill.read() == {"largest": 0, "dropped": 0, "length": 0}
    mask = torch.zeros(50, dtype=torch.bool)
    mask[:30] = True
    fill.note(mask, 20)
    largest, dropped = fill.largest, fill.dropped
    mask[:45] = True
    fill.note(mask, 20)
    fill.note(mask[:10], 20)
    assert fill.largest is largest and fill.dropped is dropped
    assert fill.read() == {"largest": 45, "dropped": 10 + 25, "length": 20}
    fill.reset()
    assert fill.largest is largest and fill.dropped is dropped
    assert fill.read() == {"largest": 0, "dropped": 0, "length": 0}
    fill.note(mask[:12], 8)
    assert fill.largest is largest
    assert fill.read() == {"largest": 12, "dropped": 4, "length": 8}


# ------------------------------------------------------------ on the CPU


def test_pipeline_on_cpu_reports_no_replays():
    """On the CPU ``pipeline.run`` steps eagerly, as before: no replay, and
    the poses and state of a loop of ``slam.step``, bit for bit."""
    poses, frames = _frames(SMALL, 5, "cpu")
    res = pipeline.run(SMALL, frames, T_init_wc=poses[0], enable_loops=False, device="cpu")
    want, state = _eager_run(SMALL, frames, poses[0])
    assert res.graph_replays == 0
    assert np.array_equal(res.poses, want)
    _assert_states_equal(res.state, state)


class _EagerReplays(step_graph.GraphedStep):
    """``GraphedStep`` with each replay run as the eager step its capture
    records, on the same fixed tensors: its bookkeeping on the CPU."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.captures = 0

    def _capture(self, state):
        self.captures += 1
        return lambda: self._step_in_place(state)


@pytest.mark.parametrize("color_every", [1, 3])
def test_graphed_step_bookkeeping_on_cpu(color_every):
    """Through the fixed tensors, with leaves rebound between frames (a
    ``clean`` on frame 5, a re-seat on frame 7 that puts one new pose in
    three fields and the old pose in a fourth), the graphed step gives the
    eager step's states bit for bit, with one graph a color branch."""
    cfg = dataclasses.replace(SMALL, color_every=color_every)
    poses, frames = _frames(cfg, 10, "cpu")
    graphed = _EagerReplays(cfg)
    a = slam.init_state(cfg, poses[0], "cpu")
    b = slam.init_state(cfg, poses[0], "cpu")
    for i, f in enumerate(frames):
        a, info_a = graphed(a, f.depth, f.color)
        b, info_b = slam.step(cfg, b, f.depth, f.color)
        _assert_states_equal(a, b)
        assert bool(info_a.track_ok) == bool(info_b.track_ok)
        if i == 5:
            a, b = _clean(cfg, a), _clean(cfg, b)
        if i == 7:
            def reseat(s):
                T = s.T_wc.clone()
                T[:3, 3] += 0.002
                return s._replace(T_wc=T, pred_T_wc=T, T_prev_wc=s.T_wc,
                                  lost_frames=torch.zeros_like(s.lost_frames))
            a, b = reseat(a), reseat(b)
    assert graphed.replays == len(frames) - step_graph.LEAD_FRAMES
    assert graphed.captures == (2 if color_every > 1 else 1)


# ------------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("color_every, clean_every, rgb", [
    (1, 0, False), (3, 0, False), (1, 10, False), (1, 0, True)])
def test_graphed_run_equals_eager_steps(card, color_every, clean_every, rgb):
    """40 frames at config2's shapes through ``pipeline.run``, the step
    replayed from its graphs (two with ``color_every`` 3; with
    ``clean_every`` 10 the map's leaves are rebound and copied in; with
    `rgb` the photometric term, the drift sentinel and the stamps, whose
    leaves the graph carries too), against a loop of eager ``slam.step``:
    poses, map, prediction bit for bit, and every frame after the lead
    frames a replay."""
    cfg = dataclasses.replace(config.config2_tum_fr3_long_office(), color_every=color_every)
    if rgb:
        cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, rgb_weight=0.1),
                                  consistency_check=True, track_stamps=True)
    poses, frames = _frames(cfg, 40, card)
    res = pipeline.run(cfg, frames, T_init_wc=poses[0], enable_loops=False,
                       clean_every=clean_every)
    want, state = _eager_run(cfg, frames, poses[0], clean_every)
    assert res.graph_replays == len(frames) - step_graph.LEAD_FRAMES
    assert np.array_equal(res.poses, want)
    _assert_states_equal(res.state, state)
    assert int(state.volume.n_active) > 1000 and int(state.pred.valid.sum()) > 50000
