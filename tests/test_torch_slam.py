"""The slice as a whole: the port's `slam.step` and `slam.step_seg` against
the reference's on the CPU, a state carried across mid-sequence, and the
port's own accuracy (the photometric term, the drift sentinel and the
stamps: tests/test_torch_slam_rgb.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from instancefusion_tpu.config import InstanceConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import slam as jslam
from instancefusion_tpu.models.segmentation import Segmentation as JSeg
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.datasets import synthetic as psyn
from instancefusion_tpu_torch.engine import slam as pslam
from instancefusion_tpu_torch.models.segmentation import Segmentation as PSeg
from instancefusion_tpu_torch.utils.ate import ate_rmse
from tests.helpers import SMALL_INTR
from tests.torch_helpers import (
    blocks_cfg, gt_segmentation, n, pose_error, reference_state_arrays, t, to_port,
)

# Color every 2nd frame: the 4-frame comparison covers both cadence branches.
JCFG = dataclasses.replace(blocks_cfg(), color_every=2)
PCFG = to_port(JCFG)
N_REF = 4
POSE_TOL = 5e-4  # m of translation, rad of rotation


@pytest.fixture(scope="module")
def reference():
    """Frames from the reference renderer and 4 reference steps: poses and
    the states after the 3rd and 4th step."""
    poses = jsyn.orbit_trajectory(12)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in range(12)]
    state = jslam.init_state(JCFG, poses[0])
    est, states = [], []
    for f in frames[:N_REF]:
        state, _ = jslam.step(JCFG, state, f.depth, f.color)
        est.append(np.asarray(state.T_wc))
        states.append(reference_state_arrays(state))
    frames_np = [(np.array(f.depth), np.array(f.color)) for f in frames]
    return dict(poses=np.array(poses), frames=frames_np, est=est, states=states)


def test_steps_match_reference(reference):
    state = pslam.init_state(PCFG, reference["poses"][0], device="cpu")
    for i, (d, c) in enumerate(reference["frames"][:N_REF]):
        state, info = pslam.step(PCFG, state, d, c)
        assert bool(info.track_ok)
        dt, dr = pose_error(n(state.T_wc), reference["est"][i])
        assert dt < POSE_TOL and dr < POSE_TOL, (i, dt, dr)


def test_state_carried_across(reference):
    """The reference state after 3 steps, converted, takes the 4th step in
    the port: same pose, same map."""
    arrays = reference["states"][2]
    state = convert.state_from_numpy(arrays, PCFG, device="cpu")
    assert state.frame_count == 3
    state, info = pslam.step(PCFG, state, *reference["frames"][3])
    assert bool(info.track_ok)
    dt, dr = pose_error(n(state.T_wc), reference["est"][3])
    assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    ref = reference["states"][3]
    out = convert.state_to_numpy(state)
    for name in ("volume.directory", "volume.block_coords", "volume.n_active"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name, tol in (("sdf", 5e-4), ("weight", 1e-5), ("color", 5e-3)):
        share = (np.abs(out[f"volume.{name}"] - ref[f"volume.{name}"]) <= tol).mean()
        assert share >= 0.999, (name, share)


def test_state_round_trip(reference):
    arrays = reference["states"][1]
    back = convert.state_to_numpy(convert.state_from_numpy(arrays, PCFG, device="cpu"))
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k


def test_port_alone_tracks_twelve_frames():
    """12 frames of the port's own renderer and engine: every frame tracks
    and ATE < voxel size, mirroring tests/test_splat.py."""
    poses = psyn.orbit_trajectory(12, device="cpu")
    frames = [psyn.render_frame(poses[i], PCFG.intrinsics) for i in range(12)]
    est, state_ok = [], []
    state = pslam.init_state(PCFG, poses[0], device="cpu")
    for f in frames:
        state, info = pslam.step(PCFG, state, f.depth, f.color)
        est.append(n(state.T_wc))
        state_ok.append(bool(info.track_ok))
    assert all(state_ok)
    assert ate_rmse(np.stack(est), n(poses)) < PCFG.tsdf.voxel_size
    assert int(state.pred.valid.sum()) > 5000


def test_run_chunk_equals_steps(reference):
    frames = reference["frames"][:3]
    a = pslam.init_state(PCFG, reference["poses"][0], device="cpu")
    b = pslam.init_state(PCFG, reference["poses"][0], device="cpu")
    for d, c in frames:
        a, _ = pslam.step(PCFG, a, d, c)
    b, infos = pslam.run_chunk(PCFG, b, torch.tensor(np.stack([f[0] for f in frames])),
                               torch.tensor(np.stack([f[1] for f in frames])))
    assert torch.equal(a.T_wc, b.T_wc)
    assert torch.equal(a.volume.sdf, b.volume.sdf)
    assert infos.track_ok.shape == (3,) and bool(infos.track_ok.all())
    assert b.frame_count == 3 and int(b.frame_idx) == 3


def test_step_gt_color_cadence_unbiased(reference):
    """Color every 4th frame at gain 4 keeps colors unbiased against
    every-frame fusion (the reference's tests/test_splat.py check)."""
    poses, frames = reference["poses"], reference["frames"]

    def run(cfg):
        state = pslam.init_state(cfg, poses[0], device="cpu")
        for (d, c), T in zip(frames, poses):
            state, _ = pslam.step_gt(cfg, state, d, c, T)
        return state.volume

    bm1 = run(dataclasses.replace(PCFG, color_every=1))
    bm4 = run(dataclasses.replace(PCFG, color_every=4))
    torch.testing.assert_close(bm4.weight, bm1.weight, atol=1e-4, rtol=0)
    both = ((bm1.weight > 4.0) & (bm4.weight > 4.0)).repeat(1, 3)
    lit = both & (bm1.color > 0.05)
    assert int(lit.sum()) > 1000
    c1, c4 = bm1.color[lit], bm4.color[lit]
    assert float((c4 - c1).abs().median()) < 0.03
    assert 0.9 < float(c4.mean() / c1.mean()) < 1.1


# config3's structure at test scale: GT masks on every frame.
JCFG_SEG = dataclasses.replace(
    blocks_cfg(), use_instances=True,
    instances=InstanceConfig(max_instances=16, num_classes=8, min_mask_pixels=50))
PCFG_SEG = to_port(JCFG_SEG)
N_SEG = 5


@pytest.fixture(scope="module")
def reference_seg():
    """5 reference `step_seg` frames on GT masks: poses and final state."""
    poses = jsyn.orbit_trajectory(12)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in range(N_SEG)]
    state = jslam.init_state(JCFG_SEG, poses[0])
    est = []
    segs = [gt_segmentation(np.asarray(f.instance), JCFG_SEG.instances.max_instances)
            for f in frames]
    for f, seg in zip(frames, segs):
        state, _ = jslam.step_seg(JCFG_SEG, state, f.depth, f.color,
                                  JSeg(*(jax.numpy.asarray(x) for x in seg)))
        est.append(np.asarray(state.T_wc))
    return dict(poses=np.array(poses), segs=segs, est=est, state=reference_state_arrays(state),
                frames=[(np.array(f.depth), np.array(f.color)) for f in frames])


def test_step_seg_matches_reference(reference_seg):
    """Poses within the `step` tolerance, the instance table equal, votes
    equal on >= 99.9% of the voxels that either side voted."""
    ref = reference_seg
    state = pslam.init_state(PCFG_SEG, ref["poses"][0], device="cpu")
    for i, ((d, c), seg) in enumerate(zip(ref["frames"], ref["segs"])):
        state, info = pslam.step_seg(PCFG_SEG, state, d, c, PSeg(*(t(x) for x in seg)))
        assert bool(info.track_ok)
        dt, dr = pose_error(n(state.T_wc), ref["est"][i])
        assert dt < POSE_TOL and dr < POSE_TOL, (i, dt, dr)
    out = convert.state_to_numpy(state)
    for name in ("active", "cls", "score", "age", "matches", "overflow"):
        np.testing.assert_array_equal(out[f"table.{name}"], ref["state"][f"table.{name}"],
                                      err_msg=name)
    assert out["table.active"].sum() >= 3 and out["table.matches"].sum() > 0
    # Votes start at label -1, count 0: a voxel either side changed was voted.
    voted = np.zeros_like(out["votes.count"], bool)
    for votes in (out, ref["state"]):
        voted |= (votes["votes.label"] != -1) | (votes["votes.count"] != 0)
    assert voted.sum() > 5000
    for name in ("label", "count"):
        share = (out[f"votes.{name}"] == ref["state"][f"votes.{name}"])[voted].mean()
        assert share >= 0.999, (name, share)


def test_state_round_trip_with_instances(reference_seg):
    """votes.* and table.* come across and back unchanged."""
    arrays = reference_seg["state"]
    state = convert.state_from_numpy(arrays, PCFG_SEG, device="cpu")
    assert state.votes is not None and state.table is not None
    back = convert.state_to_numpy(state)
    assert back.keys() == arrays.keys()
    assert any(k.startswith("votes.") for k in back) and "table.overflow" in back
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k

