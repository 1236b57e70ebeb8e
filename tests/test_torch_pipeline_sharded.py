"""The sharded pipeline and sequence runner on gloo ranks on the CPU:
``pipeline.run`` with ``num_shards`` 2 against the reference's one-device
``pipeline.run`` on the same frames and options (and against the port's
one-device pipeline), hygiene, streaming and resharding on the way, a
checkpoint and resume on the same shard count, the sharded store's round
trip across a reshard, and ``cli.main run --shards 2``.  At
tests/test_shard.py's small block map (96^3 of 4 cm, table 1728, 160x120).
The ranks carry the reference's fern coder, so keyframe, loop and
relocalization decisions compare frame by frame."""

import dataclasses
import os

import numpy as np
import pytest

from instancefusion_tpu.config import PoseGraphConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import pipeline as jpipe
from instancefusion_tpu.engine import posegraph as jpg
from instancefusion_tpu_torch import cli
from instancefusion_tpu_torch.engine import pipeline as ppipe
from instancefusion_tpu_torch.parallel import mesh
from tests import torch_shard_workers as W
from tests.helpers import SMALL_INTR
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    ListWriter, blocks_cfg, one_thread, port_frames, reference_backend_arrays,
    reference_coder, to_port,
)

S = 2
N = 10
JCFG = dataclasses.replace(blocks_cfg(), posegraph=PoseGraphConfig(keyframe_every=3,
                                                                   max_landmarks=256))
PCFG = to_port(dataclasses.replace(JCFG, num_shards=S))
VOXEL = JCFG.tsdf.voxel_size
RUN = dict(enable_loops=True, clean_every=4, stream_every=3, stream_radius=3.0)


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(S, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(N)
    fr = [jsyn.render_frame(poses[i], SMALL_INTR) for i in range(N)]
    return np.asarray(poses), [tuple(np.asarray(x) for x in f) for f in fr], fr


@pytest.fixture(scope="module")
def sharded_run(pool, frames):
    poses, fr, _ = frames
    coder = reference_backend_arrays(jpg.allocate(JCFG))
    return pool.run(W.pipeline_run, PCFG, fr, poses[0],
                    dict(RUN, reshard_every=2, reshard_skew=1.0), coder)


def test_pipeline_matches_reference(frames, sharded_run):
    """Two ranks against the reference's one-device ``pipeline.run`` on the
    same frames and options (tests/test_shard.py's bounds): the same
    keyframe, loop and relocalization decisions every frame, the same
    keyframe and loop counts, and poses within half a voxel."""
    poses, _, fr = frames
    rows = ListWriter()
    ref = jpipe.run(JCFG, fr, T_init_wc=poses[0], metrics=rows, **RUN)
    got, nkf, loops, _, _, decisions = sharded_run[0]
    assert decisions == [tuple(r[k] for k in W.DECISIONS) for r in rows.rows]
    assert (nkf, loops) == (ref.n_keyframes, ref.n_loops) and nkf >= 3
    assert np.abs(got - np.asarray(ref.poses)).max() < 0.5 * VOXEL


def test_pipeline_matches_one_device(frames, sharded_run, reference_coder):
    """Two ranks through keyframes, loop queries, clean, streaming and
    reshards: every frame a pose, the same keyframes as the port's
    one-device pipeline, poses within half a voxel of it, the ranks' poses
    equal, and at least one reshard that moved rows."""
    poses, _, fr = frames
    one = ppipe.run(dataclasses.replace(PCFG, num_shards=1), port_frames(fr),
                    T_init_wc=poses[0], device="cpu", **RUN)
    got, nkf, _, arrays, migrated, _ = sharded_run[0]
    assert got.shape == (N, 4, 4) and np.isfinite(got).all()
    assert nkf == one.n_keyframes >= 3
    assert np.abs(got - one.poses).max() < 0.5 * VOXEL
    np.testing.assert_array_equal(sharded_run[1][0], got)
    assert sum(migrated) > 0
    nb = JCFG.tsdf.grid_size // JCFG.tsdf.block_size
    cl = JCFG.tsdf.table_capacity // S
    owner = np.searchsorted(arrays["cuts"], arrays["block_coords"][:, 0], side="right")
    live = np.concatenate([np.arange(cl) < arrays["n_active"][s] for s in range(S)])
    np.testing.assert_array_equal(owner[live], np.repeat(np.arange(S), cl)[live])
    flat = arrays["block_coords"] @ np.asarray([nb * nb, nb, 1])
    slots = np.nonzero(live)[0]
    np.testing.assert_array_equal(arrays["directory"].reshape(-1)[flat[live]], slots)
    assert (arrays["directory"] >= 0).sum() == live.sum()


def test_checkpoint_resume_same_shards(pool, frames, tmp_path):
    """A run checkpointed at frame 6 and resumed on 2 ranks gives the
    uninterrupted run's poses exactly; resuming on another shard count
    refuses (the shard count is part of the configuration's digest)."""
    poses, fr, _ = frames
    ck = str(tmp_path / "ck")
    kw = dict(RUN, checkpoint_dir=ck, checkpoint_every=6)
    full = pool.run(W.pipeline_run, PCFG, fr, poses[0], dict(RUN))[0][0]
    pool.run(W.pipeline_run, PCFG, fr[:6], poses[0], kw)
    assert sorted(f for f in os.listdir(ck) if f.startswith("step_6")) == [
        "step_6.meta.json", "step_6.pt", "step_6.rank0.pt", "step_6.rank1.pt",
        "step_6.streamer.npz"]
    resumed = pool.run(W.pipeline_run, PCFG, fr, poses[0], dict(kw, resume=True))[0][0]
    np.testing.assert_array_equal(resumed, full[6:])
    with pytest.raises(ValueError, match="config mismatch"):
        ppipe.run(dataclasses.replace(PCFG, num_shards=1), port_frames(fr), device="cpu",
                  resume=True, checkpoint_dir=ck)


def test_store_round_trip_across_reshard(pool, sharded_run):
    """Every block evicted to the replicated store, the cuts moved and the
    rows resharded, then the window admitted: every block back once, its
    rows bit for bit, and the store empty."""
    arrays = sharded_run[0][3]
    cfg = PCFG.tsdf
    nb = cfg.grid_size // cfg.block_size
    before, evicted, after, stored, left = pool.run(
        W.stream_roundtrip, arrays, cfg, 3.0, np.asarray([30.0, 30.0, 30.0]),
        np.asarray([0.0, -0.5, 1.2]), np.asarray([nb // 3], np.int32))[0]
    n0 = int(before["n_active"].sum())
    assert stored == n0 and evicted["n_active"].sum() == 0
    assert left == 0 and int(after["n_active"].sum()) == n0
    d0, d1 = before["directory"].reshape(-1), after["directory"].reshape(-1)
    np.testing.assert_array_equal(d1 >= 0, d0 >= 0)
    sel = np.nonzero(d0 >= 0)[0]
    for k in ("block_coords", "sdf", "weight", "color"):
        np.testing.assert_array_equal(after[k][d1[sel]], before[k][d0[sel]], err_msg=k)
    assert len(set(d1[sel].tolist())) == len(sel)  # no block twice


def test_cli_shards(pool, tmp_path):
    """``run --shards 2`` through ``cli.main`` inside the rank group (the
    torchrun way: the ranks are in a group already), on the small map with
    instance fusion (the marched sharded path: K8, the halo raycast, votes),
    writes rank 0's trajectory and mesh; a dense map refuses as in the
    reference; and a launch from outside any group starts its own ranks."""
    traj, ply = str(tmp_path / "traj.txt"), str(tmp_path / "mesh.ply")
    argv = ["run", "--small", "--frames", "4", "--device", "cpu", "--quiet", "--instances",
            "--seg-head", "gt", "--shards", "2", "--export-traj", traj]
    assert pool.run(W.cli_main, argv + ["--export-mesh", ply]) == [0, 0]
    assert np.loadtxt(traj).shape == (4, 8) and os.path.getsize(ply) > 1000
    with pytest.raises(ValueError, match="map_kind='blocks'"):
        cli.main(["run", "--small", "--frames", "2", "--device", "cpu", "--shards", "2"])
    os.remove(traj)
    assert cli.main(argv[:2] + ["--frames", "2"] + argv[4:]) == 0
    assert np.loadtxt(traj).shape == (2, 8)
