"""The sharded SLAM engine: one frame's track -> fuse -> predict on every
rank of a shard group (port of ``engine/slam_sharded.py``; configs 4/5).

The frame and the tracking are replicated: every rank preprocesses (K1)
and tracks (K2, K3) against the composited prediction, so every rank holds
the same pose.  The map work goes through ``parallel/shard.py``: with
splat prediction ``fused_step_map`` (allocation by the replicated band
plan, K4 and K5 on the rank's own rows, one ``psum`` of the splat
planes), else the marched ``integrate`` (K8) and the halo ``raycast``.
The drift sentinel (``consistency_check``) is replicated tracking work
and runs as in ``engine/slam.py``; observation stamps are a single-shard
feature.

The state is ``engine/slam.SlamState`` with a ``parallel/shard``
``ShardedBlockMap`` as its volume and, with instances, this rank's vote
rows; every other field is replicated.  Each function below is called on
every rank with the same arguments, as the reference's one program runs
over the mesh; ``step`` updates the map's rows in place (rebind the
state).
"""

from __future__ import annotations

import functools

import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.config import EngineConfig
from instancefusion_tpu_torch.engine import instances as inst
from instancefusion_tpu_torch.engine import slam
from instancefusion_tpu_torch.engine.slam import SlamState, StepInfo
from instancefusion_tpu_torch.models.segmentation import Segmentation
from instancefusion_tpu_torch.ops import labels
from instancefusion_tpu_torch.ops.raycast import RaycastMaps
from instancefusion_tpu_torch.parallel import shard
from instancefusion_tpu_torch.parallel.mesh import ShardGroup

def check_config(cfg: EngineConfig, group: ShardGroup) -> None:
    if cfg.map_kind != "blocks":
        raise ValueError("num_shards > 1 requires map_kind='blocks'")
    if cfg.track_stamps:
        raise ValueError("active/inactive local loops are a single-shard feature")
    if cfg.num_shards != group.size:
        raise ValueError(f"cfg.num_shards={cfg.num_shards} on a group of {group.size}")


def init_state(cfg: EngineConfig, group: ShardGroup, T_init_wc=None) -> SlamState:
    """Empty sharded map and invalid prediction at `T_init_wc`, on the
    group's device."""
    check_config(cfg, group)
    _device.resolve(group.device)
    votes = shard.allocate_votes(cfg.tsdf, group) if cfg.use_instances else None
    return slam.empty_state(cfg, T_init_wc,
                            shard.allocate(cfg.tsdf, group, with_color=cfg.use_color), votes)


def _map_update(cfg: EngineConfig, group: ShardGroup, state: SlamState, depth_eff,
                color, T_new):
    """Fuse + predict through the sharded map: the splat path or the
    marched path, as ``engine/slam.py`` picks them."""
    intr = cfg.intrinsics
    frame_color = color if cfg.use_color else None
    pred_color = cfg.use_color and (cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0)
    if cfg.raycast.use_splat:
        prior = torch.where(depth_eff > 0.0, depth_eff, state.pred.depth)
        # Color cadence as engine/slam._splat_map_update.
        gain = 1.0
        if frame_color is not None and cfg.color_every > 1:
            on = state.frame_count % cfg.color_every == 0
            frame_color, gain = (frame_color, float(cfg.color_every)) if on else (None, 1.0)
        return shard.fused_step_map(state.volume, depth_eff, frame_color, prior, T_new,
                                    group, intr, cfg.tsdf, cfg.raycast,
                                    pred_color=pred_color, color_gain=gain)
    volume = shard.integrate(state.volume, depth_eff, frame_color, T_new, group, intr,
                             cfg.tsdf)
    pred = shard.raycast(volume, T_new, group, intr, cfg.tsdf, cfg.raycast,
                         with_color=pred_color)
    return volume, pred


def _fuse(group: ShardGroup, cfg: EngineConfig, state: SlamState, d0, color, T_new,
          fuse_ok):
    """The map update of `slam.track_and_fuse` on the sharded map (no
    stamps)."""
    depth_masked = torch.where(fuse_ok, d0, torch.zeros_like(d0))
    volume, pred = _map_update(cfg, group, state, depth_masked, color, T_new)
    return volume, pred, None


def step(cfg: EngineConfig, group: ShardGroup, state: SlamState, depth, color):
    """Track -> fuse -> predict for one frame on this rank; returns (state,
    info), both the same on every rank apart from the map's own rows."""
    return slam.track_and_fuse(cfg, state, depth, color, functools.partial(_fuse, group))


def run_chunk(cfg: EngineConfig, group: ShardGroup, state: SlamState, depths, colors):
    """`step` over K frames; StepInfo leaves come back stacked (K,)."""
    infos = []
    for d, c in zip(depths, colors):
        state, info = step(cfg, group, state, d, c)
        infos.append(info)
    return state, StepInfo(*(None if x[0] is None else torch.stack(x)
                             for x in zip(*infos)))


def step_gt(cfg: EngineConfig, group: ShardGroup, state: SlamState, depth, color, T_gt_wc):
    """Fuse -> predict at a given pose (tracking bypassed)."""
    return slam.fuse_at(cfg, state, depth, color, T_gt_wc, functools.partial(_fuse, group))


def step_seg(cfg: EngineConfig, group: ShardGroup, state: SlamState, depth, color,
             seg: Segmentation):
    """`step`, then the frame's segmentation into the sharded votes.

    As the reference's ``make_step_seg``: predicted ids by the ``pmax``
    composite, association and table update (replicated), votes into own
    rows (K7); the duplicate-row merges are not run here (they are in
    ``fuse_segmentation``).
    """
    if not cfg.use_instances:
        raise ValueError("step_seg requires cfg.use_instances")
    new_state, info = step(cfg, group, state, depth, color)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=new_state.T_wc.device)
    seg = seg._replace(mask_id=labels.refine_mask_edges(seg.mask_id, depth,
                                                         intr=cfg.intrinsics))
    pred_gid = shard.sample_labels(new_state.votes, new_state.volume,
                                   new_state.pred.vertex_w, new_state.pred.valid, group,
                                   cfg.tsdf)
    gid_image, table = inst.associate(new_state.table, seg, pred_gid, cfg.instances)
    depth_gated = torch.where(info.track_ok, depth, torch.zeros_like(depth))
    votes = shard.fuse_labels(new_state.votes, new_state.volume, gid_image, depth_gated,
                              new_state.T_wc, group, cfg.intrinsics, cfg.tsdf)
    return new_state._replace(votes=votes, table=table), info


def fuse_segmentation(cfg: EngineConfig, group: ShardGroup, state: SlamState,
                      seg: Segmentation, depth, T_mc) -> SlamState:
    """The arrival half of instance fusion on the sharded map (the
    reference's ``make_fuse_segmentation``): mask refinement, predicted ids
    by the ``pmax`` composite, duplicate-row merges (the relabel is
    elementwise, so it runs on own rows), association, votes (K7)."""
    if not cfg.use_instances:
        raise ValueError("fuse_segmentation requires cfg.use_instances")
    depth = torch.as_tensor(depth, dtype=torch.float32, device=state.T_wc.device)
    seg = seg._replace(mask_id=labels.refine_mask_edges(seg.mask_id, depth,
                                                         intr=cfg.intrinsics))
    pred_gid = shard.sample_labels(state.votes, state.volume, state.pred.vertex_w,
                                   state.pred.valid, group, cfg.tsdf)
    src, dst, mok = inst.find_merges(state.table, seg, pred_gid, cfg.instances)
    table = inst.apply_merges(state.table, src, dst, mok)
    merged = labels.merge_table(src, dst, mok, cfg.instances.max_instances)
    votes = labels.relabel_votes(state.votes, merged)
    pred_gid = labels.apply_table(merged, pred_gid)
    gid_image, table = inst.associate(table, seg, pred_gid, cfg.instances)
    votes = shard.fuse_labels(votes, state.volume, gid_image, depth, T_mc, group,
                              cfg.intrinsics, cfg.tsdf)
    return state._replace(votes=votes, table=table)


def rerender(cfg: EngineConfig, group: ShardGroup, volume, T_wc) -> RaycastMaps:
    """The marched halo raycast of the map at `T_wc` (relocalization and
    loop re-seats)."""
    return shard.raycast(volume, T_wc, group, cfg.intrinsics, cfg.tsdf, cfg.raycast,
                         with_color=cfg.use_color)
