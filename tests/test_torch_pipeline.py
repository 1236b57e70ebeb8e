"""Port pipeline against the reference's, on tests/test_pipeline.py's CFG
(the dense SMALL_CFG with keyframes every 4th frame).

The port's backend carries the reference's fern coder (the
``reference_coder`` fixture), so keyframe, loop and relocalization
decisions compare frame by frame.  Poses agree within 5e-4 m: the dense
engine's ICP is ill-conditioned on the orbit (a 1e-7 change of its normal
equations moves a pose ~6e-5 m, tests/test_torch_slam_dense.py), and the
port's fp32 sums round in another order than XLA's.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from instancefusion_tpu.engine import pipeline as jpipe
from instancefusion_tpu_torch.engine import pipeline as ppipe
from instancefusion_tpu_torch.engine import posegraph as ppg
from instancefusion_tpu_torch.engine import slam as pslam
from instancefusion_tpu_torch.utils import checkpoint as pckpt
from instancefusion_tpu_torch.utils.ate import ate_rmse
from tests.test_pipeline import CFG, _frames
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    ListWriter, one_thread, port_frames, reference_coder, to_port,
)

POSE_TOL = 5e-4
DECISIONS = ("keyframe", "loop_closed", "relocalized")


def _run_both(n, **kw):
    frames, poses = _frames(n)
    rw, pw = ListWriter(), ListWriter()
    ref = jpipe.run(CFG, frames, T_init_wc=poses[0], metrics=rw, **kw)
    out = ppipe.run(to_port(CFG), port_frames(frames), T_init_wc=np.array(poses[0]),
                    metrics=pw, device="cpu", **kw)
    return ref, out, rw.rows, pw.rows, np.asarray(poses)


def test_pipeline_matches_reference_with_keyframes_and_metrics(reference_coder):
    ref, out, rrows, prows, poses = _run_both(9)
    assert out.poses.shape == (9, 4, 4)
    for r, p in zip(rrows, prows):
        assert {k: p[k] for k in DECISIONS} == {k: r[k] for k in DECISIONS}, r["frame"]
        assert set(p) == set(r)  # the same metric fields, t_*_ms among them
    assert (out.n_keyframes, out.n_loops) == (ref.n_keyframes, ref.n_loops) == (3, 0)
    np.testing.assert_allclose(out.poses, ref.poses, atol=POSE_TOL)
    assert ate_rmse(out.poses, poses) < CFG.tsdf.voxel_size
    np.testing.assert_array_equal(ppg.decimated_min_valid(100, 4), 12)


def test_gt_odometry_matches_reference(reference_coder):
    frames, poses = _frames(5)
    gt = np.asarray(poses)
    ref = jpipe.run(CFG, frames, T_init_wc=poses[0], enable_loops=False, gt_odometry=gt)
    out = ppipe.run(to_port(CFG), port_frames(frames), T_init_wc=gt[0], enable_loops=False,
                    gt_odometry=gt, device="cpu")
    np.testing.assert_allclose(out.poses, gt, atol=1e-6)
    np.testing.assert_allclose(out.poses, ref.poses, atol=1e-6)
    assert int(out.state.pred.valid.sum()) > 1000  # the map was fused


def test_checkpoint_resume_reproduces_run(tmp_path):
    frames, poses = _frames(6)
    pf = port_frames(frames)
    cfg = to_port(CFG)
    cdir = str(tmp_path / "ckpt")
    kw = dict(T_init_wc=np.array(poses[0]), checkpoint_dir=cdir, device="cpu")
    res1 = ppipe.run(cfg, pf, checkpoint_every=3, **kw)
    assert pckpt.latest_step(cdir) == 6
    for name in os.listdir(cdir):
        if "step_6" in name:
            path = os.path.join(cdir, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    res2 = ppipe.run(cfg, pf, checkpoint_every=100, resume=True, **kw)
    # Frames 3-5 re-run from the restored state (keyframe 0 and its fern
    # code among it; frame 4 adds keyframe 1): the same poses as the
    # uninterrupted run.
    np.testing.assert_allclose(res2.poses[-1], res1.poses[-1], atol=1e-5)
    assert res2.n_keyframes == res1.n_keyframes == 2


def test_checkpoint_config_mismatch_rejected(tmp_path):
    frames, poses = _frames(2)
    cfg = to_port(CFG)
    cdir = str(tmp_path / "ckpt")
    ppipe.run(cfg, port_frames(frames), T_init_wc=np.array(poses[0]), checkpoint_dir=cdir,
              checkpoint_every=2, enable_loops=False, device="cpu")
    other = dataclasses.replace(cfg, use_color=False)
    ex = (pslam.init_state(other, np.array(poses[0]), device="cpu"),
          ppg.allocate(other, device="cpu"))
    with pytest.raises(ValueError, match="config mismatch"):
        pckpt.restore(cdir, ex, other)


def test_unported_paths_raise():
    cfg = to_port(CFG)
    # The sharded map runs on every rank of a shard group
    # (tests/test_torch_pipeline_sharded.py): on this dense map it raises the
    # reference's ValueError, and a block map outside any group raises.
    with pytest.raises(ValueError, match="map_kind='blocks'"):
        ppipe.run(dataclasses.replace(cfg, num_shards=2), [], device="cpu")
    with pytest.raises(RuntimeError, match="shard group"):
        ppipe.run(dataclasses.replace(cfg, num_shards=2, map_kind="blocks"), [], device="cpu")
    # Streaming is ported (tests/test_torch_streaming.py): it runs.
    assert ppipe.run(cfg, [], stream_every=3, device="cpu").poses.shape == (0, 4, 4)
