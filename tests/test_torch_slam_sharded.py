"""The port's sharded engine (``engine/slam_sharded.py``) on 4 gloo ranks on
the CPU, against the reference's one-device engine, at
tests/test_shard.py's small configuration (96^3 grid of 4 cm, table 1728,
160x120, splat prediction).

The reference's sharded step needs ``shard_map`` over a mesh (minutes of
partitioning on the CPU), so, as tests/test_shard.py's own
``test_sharded_splat_fast_path_matches_single`` does, the port is held to
the reference's one-device engine with that test's bounds.  The instance
path is held, on the sharded map gathered, to the reference's one-device
instance fusion: ``slam.fuse_segmentation`` for the port's
``fuse_segmentation`` (merges run), and the body of the reference's
``make_step_seg`` (no merges) with the one-device ``labels.sample_nearest``
and ``labels.fuse`` in the place of the ``pmax`` composite and the sharded
vote, for ``step_seg``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.config import InstanceConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import instances as jinst
from instancefusion_tpu.engine import slam as jslam
from instancefusion_tpu.models.segmentation import Segmentation as JSeg
from instancefusion_tpu.ops import blocks as jblocks
from instancefusion_tpu.ops import labels as jlabels
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import slam as pslam
from instancefusion_tpu_torch.models.segmentation import Segmentation as PSeg
from instancefusion_tpu_torch.ops.raycast import RaycastMaps
from instancefusion_tpu_torch.parallel import mesh
from tests import torch_shard_workers as W
from tests.helpers import SMALL_INTR
from tests.torch_helpers import blocks_cfg, gt_segmentation, one_thread, t, to_port  # noqa: F401

S = 4
N = 6
JCFG = blocks_cfg()
PCFG = to_port(dataclasses.replace(JCFG, num_shards=S))
VOXEL = JCFG.tsdf.voxel_size
JCFG_SEG = dataclasses.replace(
    JCFG, use_instances=True,
    instances=InstanceConfig(max_instances=16, num_classes=8, min_mask_pixels=50))
PCFG_SEG = to_port(dataclasses.replace(JCFG_SEG, num_shards=S))


def _reference_state(state, arrays, pred, T):
    """The reference's one-device `state` with the gathered sharded map,
    prediction and pose in place (rows in global slot order, so the
    directory's global slots address them)."""
    vol = jblocks.BlockMap(
        directory=jnp.asarray(arrays["directory"]),
        block_coords=jnp.asarray(arrays["block_coords"]),
        n_active=jnp.asarray(arrays["n_active"].sum(), jnp.int32),
        overflow=jnp.asarray(arrays["overflow"].sum(), jnp.int32),
        sdf=jnp.asarray(arrays["sdf"]), weight=jnp.asarray(arrays["weight"]),
        color=jnp.asarray(arrays["color"]))
    return state._replace(volume=vol, T_wc=jnp.asarray(T),
                          pred=state.pred._replace(**{k: jnp.asarray(v)
                                                      for k, v in pred.items()}))


@functools.partial(jax.jit, static_argnums=(0,))
def _reference_step_seg_vote(cfg, state, seg, depth, track_ok):
    """The body of the reference's ``make_step_seg`` after its ``step`` (no
    merges), on one device: ``sample_nearest`` over the whole map is the
    ``pmax`` composite of ``shard.sample_labels``, and ``labels.fuse`` the
    union of every shard's ``fuse_labels``."""
    seg = seg._replace(mask_id=jlabels.refine_mask_edges(seg.mask_id, depth,
                                                         intr=cfg.intrinsics))
    pred_gid = jlabels.sample_nearest(state.votes, state.volume, state.pred.vertex_w,
                                      state.pred.valid, cfg.tsdf)
    gid_image, table = jinst.associate(state.table, seg, pred_gid, cfg.instances)
    depth = jnp.where(track_ok, depth, jnp.zeros_like(depth))
    votes = jlabels.fuse(state.votes, state.volume, gid_image, depth, state.T_wc,
                         cfg.intrinsics, cfg.tsdf)
    return state._replace(votes=votes, table=table)


def _assert_instances_equal(table, lab, cnt, ref):
    """The instance table and the directory-addressed votes exactly."""
    for k, v in table.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.table, k)), err_msg=k)
    np.testing.assert_array_equal(lab, np.asarray(ref.votes.label))
    np.testing.assert_array_equal(cnt, np.asarray(ref.votes.count))
    assert table["active"].sum() >= 2 and (cnt > 0).sum() > 1000


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(S, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(N)
    fr = [jsyn.render_frame(poses[i], SMALL_INTR) for i in range(N)]
    return np.asarray(poses), fr


@pytest.fixture(scope="module")
def sharded(pool, frames):
    poses, fr = frames
    return pool.run(W.slam_steps, PCFG, [(np.asarray(f.depth), np.asarray(f.color))
                                         for f in fr], poses[0])


def test_six_steps_match_reference_engine(frames, sharded):
    """Six sharded steps track every frame and stay with the reference's
    one-device engine: poses within half a voxel, allocation sets equal
    within 2% + 2 blocks, valid coverage within 10%, at least 2 shards
    holding rows (tests/test_shard.py's bounds)."""
    poses, fr = frames
    state = jslam.init_state(JCFG, poses[0])
    for f in fr:
        state, _ = jslam.step(JCFG, state, f.depth, f.color)
    steps = sharded[0][0]
    assert all(ok for _, ok in steps)
    last = steps[-1][0]
    assert np.abs(last["T_wc"] - np.asarray(state.T_wc)).max() < 0.5 * VOXEL
    d1 = np.asarray(state.volume.directory) >= 0
    d2 = last["directory"] >= 0
    assert (d1 != d2).sum() <= 0.02 * d1.sum() + 2, (d1.sum(), d2.sum())
    v1, v2 = int(state.pred.valid.sum()), last["valid"]
    assert abs(v1 - v2) < 0.1 * max(v1, v2), (v1, v2)
    assert (last["n_active"] > 0).sum() >= 2, last["n_active"]


def test_ranks_identical_every_frame(sharded):
    """Every rank holds rank 0's pose, directory, counts and prediction bit
    for bit, every frame."""
    for r in sharded[1:]:
        for (mine, _), (lead, _) in zip(r[0], sharded[0][0]):
            for k in lead:
                np.testing.assert_array_equal(mine[k], lead[k], err_msg=k)


def test_run_chunk_equals_stepping(sharded):
    """run_chunk over the six frames gives the stepped state exactly, on
    every rank (replicated fields and own rows)."""
    for steps, rows, chunk, chunk_rows, ok in sharded:
        assert ok.all()
        for k, v in steps[-1][0].items():
            np.testing.assert_array_equal(chunk[k], v, err_msg=k)
        for k, v in rows.items():
            np.testing.assert_array_equal(chunk_rows[k], v, err_msg=k)


@pytest.fixture(scope="module")
def seg_fused(pool, frames):
    """Four sharded steps, then two ``fuse_segmentation`` calls (the ground
    truth masks of frames 2 and 3) at frame 3's depth and pose."""
    poses, fr = frames
    segs = [gt_segmentation(np.asarray(f.instance), 16) for f in fr[2:4]]
    res = pool.run(W.seg_fuse, PCFG_SEG, [(np.asarray(f.depth), np.asarray(f.color))
                                          for f in fr[:4]], poses[0], segs)
    return segs, res[0]


def test_fuse_segmentation_matches_reference(frames, seg_fused):
    """The sharded ``fuse_segmentation`` (merges, the pmax composite of the
    predicted ids, association, K7 on own rows) on the map of 4 sharded
    steps equals the reference's one-device ``slam.fuse_segmentation`` on
    the same map gathered: the instance table and the votes, exactly."""
    poses, fr = frames
    segs, (arrays, pred, T, lab, cnt, table) = seg_fused
    state = _reference_state(jslam.init_state(JCFG_SEG, poses[0]), arrays, pred, T)
    for seg in segs:
        state = jslam.fuse_segmentation(JCFG_SEG, state, JSeg(*(jnp.asarray(x) for x in seg)),
                                        jnp.asarray(fr[3].depth), state.T_wc)
    _assert_instances_equal(table, lab, cnt, state)


def test_step_seg_matches_reference(pool, frames):
    """``step_seg`` on frames 2 and 3 after two sharded steps: after each
    frame's ``step``, the reference's no-merge vote of ``make_step_seg``
    (one device, on that step's map gathered) gives the same instance
    table and votes, exactly, at the end."""
    poses, fr = frames
    segs = [gt_segmentation(np.asarray(f.instance), 16) for f in fr[2:4]]
    after_step, lab, cnt, table = pool.run(
        W.seg_steps, PCFG_SEG, [(np.asarray(f.depth), np.asarray(f.color)) for f in fr[:4]],
        poses[0], segs)[0]
    state = jslam.init_state(JCFG_SEG, poses[0])
    for (arrays, pred, T, ok), seg, f in zip(after_step, segs, fr[2:4]):
        assert ok
        state = _reference_state(state, arrays, pred, T)
        state = _reference_step_seg_vote(JCFG_SEG, state, JSeg(*(jnp.asarray(x) for x in seg)),
                                         jnp.asarray(f.depth), jnp.asarray(ok))
    _assert_instances_equal(table, lab, cnt, state)


def test_fuse_segmentation_matches_one_device(frames, seg_fused):
    """The sharded ``fuse_segmentation`` equals the port's one-device
    ``fuse_segmentation`` on the same map gathered, exactly (as the
    reference test above, against the port)."""
    poses, fr = frames
    segs, (arrays, pred, T, lab, cnt, table) = seg_fused
    one = dataclasses.replace(PCFG_SEG, num_shards=1)
    state = pslam.init_state(one, poses[0], device="cpu")
    state = state._replace(volume=convert.block_map_from_global(arrays, "cpu"),
                           pred=RaycastMaps(**{k: t(v) for k, v in pred.items()}),
                           T_wc=t(T))
    for seg in segs:
        state = pslam.fuse_segmentation(one, state, PSeg(*(t(x) for x in seg)),
                                        t(np.asarray(fr[3].depth)), state.T_wc)
    for k, v in table.items():
        np.testing.assert_array_equal(v, state.table._asdict()[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(lab, state.votes.label.numpy())
    np.testing.assert_array_equal(cnt, state.votes.count.numpy())
