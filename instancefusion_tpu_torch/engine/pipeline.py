"""Host-side orchestration: the full SLAM pipeline over a sequence (port of
``engine/pipeline.py``).

Per frame it runs the engine step and, at the configured cadences,
relocalizes after lost tracking, fuses a segmentation dispatched one frame
earlier, closes local (active/inactive) loops, inserts keyframes, queries
the fern database for loop candidates, verifies them by ICP, corrects the
keyframe graph (pose-graph Gauss-Newton or landmark Schur BA), keeps the
map clean, writes metrics and checkpoints.  The host only sequences calls;
it reads a device value back only where the reference does (the tracking
gate, the lost-frame count, a fern dissimilarity, a verification's
verdict, the keyframe count), and those reads are the frame's only syncs.

On one card, on the block map with splat prediction and with tracking (no
``gt_odometry``), the engine step runs as a CUDA-graph replay after the
run's first frames (``engine/step_graph.py``): the graph is captured once a
run and dropped with it.  The state's step tensors are then fixed tensors
that every replay overwrites: a caller may rebind them between frames (the
next replay copies the new ones in), and keeps one past the next frame
only as a clone; the ``StepInfo`` holds until the next frame.  Every other
path (sharded, march, dense, ``gt_odometry``) runs the eager step.

Map consistency after a correction: the TSDF stays where it was fused;
loop closures move the world-from-map anchor ``T_wm`` (the world pose of
frame k is T_wm T_mc(k)), so the engine pose never jumps against the fused
geometry.

With ``stream_every > 0`` on the block map, a ``BlockStreamer``
(``engine/streaming.py``) keeps only the blocks within ``stream_radius`` of
the camera on the device: it ticks every ``stream_every`` frames and
before the re-render of a relocalization, and its host store is saved
beside each checkpoint and restored on resume.

With ``num_shards > 1`` the map is sharded over a group of ranks
(``parallel/``): ``run`` is called on every rank of the group with the same
arguments, the engine is ``engine/slam_sharded.py``, loop-closure BA sums
its landmark slices across the ranks (``shard.sharded_paired_terms``),
re-renders use the halo raycast, hygiene and streaming run their sharded
forms, and ``reshard_every`` polls the per-shard occupancy and, when it
is skewed by more than ``reshard_skew``, moves the slab cuts to balance
it and migrates the rows.  Every rank runs the whole host orchestration:
its inputs are replicated, so every rank takes the same decisions.  Only
rank 0 writes the metrics (the caller passes ``metrics`` there alone), the
replicated part of a checkpoint and the streamer's store.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.config import EngineConfig
from instancefusion_tpu_torch.engine import instances as inst
from instancefusion_tpu_torch.engine import localloop as ll
from instancefusion_tpu_torch.engine import posegraph as pg
from instancefusion_tpu_torch.engine import slam, slam_sharded, step_graph
from instancefusion_tpu_torch.engine.streaming import BlockStreamer, ShardedBlockStreamer
from instancefusion_tpu_torch.geometry.se3 import se3_inverse
from instancefusion_tpu_torch.ops import blocks, preprocess
from instancefusion_tpu_torch.parallel import mesh, shard
from instancefusion_tpu_torch.utils import checkpoint as ckpt
from instancefusion_tpu_torch.utils.metrics import MetricsWriter, Timer, sync_fetch


@dataclasses.dataclass
class PipelineResult:
    poses: np.ndarray  # (N,4,4) estimated trajectory
    n_keyframes: int
    n_loops: int
    fps: float
    state: Any
    backend: Any
    graph_replays: int = 0  # frames whose step ran as a CUDA-graph replay


def _optimize_after_loop(backend, cfg: EngineConfig, kf_a, kf_b, T_rel, ba_terms_fn=None):
    """Graph correction after a verified loop (kf_a, kf_b, T_rel): with
    ``use_landmark_ba`` (the default) sample the pair's landmarks into the
    bank and run the joint Schur solve (its terms from `ba_terms_fn`, the
    sharded reducer on a group), else pose-graph GN alone."""
    pgc = cfg.posegraph
    if pgc.use_landmark_ba:
        pts, obs = pg.build_loop_landmarks(backend, kf_a, kf_b, T_rel, cfg.intrinsics, cfg)
        backend = pg.add_loop_landmarks(backend, pts, obs)
        return pg.optimize_landmark(backend, pgc, ba_terms_fn)
    return pg.optimize(backend, pgc)


def _level0(cfg: EngineConfig, depth):
    """The frame's level-0 maps (K1 on its clamped depth)."""
    d = preprocess.clamp_depth(depth, cfg.preprocess)
    return preprocess.build_frame_pyramid(d, cfg.intrinsics, cfg.preprocess, 1)[0]


def _anchor_correction(backend, kf_cur, T_before, T_wm):
    """Move the world-from-map anchor by the correction the optimizer gave
    keyframe `kf_cur` (T_after T_before^-1)."""
    corr = pg._pick(backend.kf.poses, kf_cur) @ se3_inverse(T_before)
    return corr @ T_wm


def check_sharded(cfg: EngineConfig, local_loops: bool = False) -> None:
    """The reference's refusals of a sharded run."""
    if cfg.map_kind != "blocks":
        raise ValueError("num_shards > 1 requires map_kind='blocks'")
    if local_loops or cfg.track_stamps:
        raise ValueError("active/inactive local loops are a single-shard feature")
    if cfg.posegraph.max_landmarks % cfg.num_shards:
        raise ValueError("max_landmarks must divide num_shards")


class _Engine:
    """The engine calls of a run: the one-device engine, its step replayed
    from CUDA graphs where `graphed` (``step_graph.engages``), or the
    sharded engine on `group`."""

    def __init__(self, cfg: EngineConfig, group=None, graphed: bool = False):
        self.cfg, self.group = cfg, group
        self.graphed = step_graph.GraphedStep(cfg) if graphed else None

    def step(self, state, depth, color):
        if self.graphed is not None:
            return self.graphed(state, depth, color)
        if self.group is None:
            return slam.step(self.cfg, state, depth, color)
        return slam_sharded.step(self.cfg, self.group, state, depth, color)

    def step_gt(self, state, depth, color, T):
        if self.group is None:
            return slam.step_gt(self.cfg, state, depth, color, T)
        return slam_sharded.step_gt(self.cfg, self.group, state, depth, color, T)

    def fuse_segmentation(self, state, seg, depth, T):
        if self.group is None:
            return slam.fuse_segmentation(self.cfg, state, seg, depth, T)
        return slam_sharded.fuse_segmentation(self.cfg, self.group, state, seg, depth, T)

    def rerender(self, volume, T):
        cfg = self.cfg
        if self.group is None:
            return slam._map_ops(cfg).raycast(volume, T, cfg.intrinsics, cfg.tsdf,
                                              cfg.raycast, with_color=cfg.use_color)
        return slam_sharded.rerender(cfg, self.group, volume, T)

    def clean(self, state):
        cfg = self.cfg
        if self.group is None:
            out = blocks.clean(state.volume, cfg.tsdf, min_weight=1.0, votes=state.votes,
                               stamp=state.stamp)
            state = state._replace(volume=out[0], votes=out[1])
            return state._replace(stamp=out[2]) if state.stamp is not None else state
        volume, votes = shard.clean(state.volume, self.group, cfg.tsdf, min_weight=1.0,
                                    votes=state.votes)
        return state._replace(volume=volume, votes=votes)

    def reshard(self, state, skew: float) -> tuple:
        """Rebalance the slab cuts when the per-shard occupancy is skewed
        beyond `skew` (max over mean) and migrate the rows; returns (state,
        rows migrated)."""
        counts = state.volume.n_active.cpu().numpy()
        if counts.max() <= skew * max(counts.mean(), 1.0):
            return state, 0
        cfg = self.cfg
        vol = state.volume._replace(
            cuts=shard.balanced_cuts(state.volume.directory, cfg.tsdf, cfg.num_shards))
        votes, moved = state.votes, 0
        for _ in range(8):
            vol, votes, migrated, leftover = shard.reshard(vol, self.group, cfg.tsdf,
                                                           votes=votes)
            moved += int(migrated.sum())
            if int(leftover.sum()) == 0:
                break
        return state._replace(volume=vol, votes=votes), moved


def _stream(streamer: BlockStreamer, state, T_wc):
    """One streaming tick at pose `T_wc`: the state with its map, votes and
    stamps updated, and the tick's stats."""
    volume, votes, stamp, stats = streamer.tick(state.volume, state.votes, T_wc, state.stamp)
    return state._replace(volume=volume, votes=votes, stamp=stamp), stats


def run(
    cfg: EngineConfig,
    frames: Iterable,
    T_init_wc=None,
    segment_fn: Callable | None = None,
    metrics: MetricsWriter | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 200,
    enable_loops: bool = True,
    resume: bool = False,
    relocalize_after: int = 5,
    clean_every: int = 0,
    retire_every: int = 0,
    stream_every: int = 0,
    stream_radius: float = 4.0,
    gt_odometry=None,
    local_loops: bool = False,
    local_every: int = 3,
    local_min_blocks: int = 24,
    reshard_every: int = 0,
    reshard_skew: float = 1.5,
    device=None,
) -> PipelineResult:
    """Run the full pipeline over `frames` (an iterable of Frames: depth,
    color, ... on the run's device).

    Runs on ``cuda`` unless ``device`` says otherwise.  ``segment_fn(frame)
    -> Segmentation | None`` supplies instance masks at the
    ``cfg.instances.seg_every`` cadence; its result is fused one frame
    later against its own frame's depth and pose, so the head's device
    work overlaps the next step.  With ``cfg.num_shards > 1`` it runs on
    every rank of the current shard group, on the group's device;
    ``reshard_every`` and ``reshard_skew`` apply to that path alone.

    On one CUDA card, on the block map with splat prediction and without
    ``gt_odometry``, the step is replayed from a CUDA graph after
    ``step_graph.LEAD_FRAMES`` eager frames (``graph_replays`` counts the
    replays).  Each replay overwrites the state's step tensors, so a tensor
    kept past its frame is cloned (the pose a dispatched segmentation is
    fused at).  No graph outlives the call.
    """
    group = ba_terms_fn = None
    if cfg.num_shards > 1:
        check_sharded(cfg, local_loops)
        group = mesh.group_for(cfg.num_shards)
        dev = group.device
        state = slam_sharded.init_state(cfg, group, T_init_wc)
        ba_terms_fn = shard.sharded_paired_terms(group)
    else:
        dev = _device.resolve(device)
        state = slam.init_state(cfg, T_init_wc, dev)
    engine = _Engine(cfg, group,
                     graphed=step_graph.engages(cfg, dev, gt_odometry is not None))
    rerender = engine.rerender

    backend = pg.allocate(cfg, device=dev)
    # Map anchor: world-from-map.  Loop corrections move only this one
    # transform; the voxels and the engine pose stay put.
    T_wm = torch.eye(4, dtype=torch.float32, device=dev)
    start_frame = 0
    if resume and checkpoint_dir:
        try:
            (state, backend, T_wm), start_frame = ckpt.restore(
                checkpoint_dir, (state, backend, T_wm), cfg, group=group)
        except FileNotFoundError:
            pass

    streamer = None
    if stream_every and cfg.map_kind == "blocks":
        if group is not None:
            streamer = ShardedBlockStreamer(cfg.tsdf, group, radius=stream_radius,
                                            with_color=cfg.use_color,
                                            with_votes=cfg.use_instances)
        else:
            streamer = BlockStreamer(cfg.tsdf, radius=stream_radius,
                                     with_color=cfg.use_color,
                                     with_votes=cfg.use_instances,
                                     with_stamps=cfg.track_stamps)
        if resume and checkpoint_dir and start_frame:
            # Evicted blocks live only in the host store: restore it with
            # the device state or they are gone.
            spath = os.path.join(checkpoint_dir, f"step_{start_frame}.streamer.npz")
            if os.path.exists(spath):
                streamer.load(spath)

    pgc = cfg.posegraph
    est: list[torch.Tensor] = []
    timer = Timer()
    n_loops = 0
    local_fails = 0
    # Sentinel streak (cfg.consistency_check): a persistent alarm forces
    # out-of-cadence keyframe and loop-closure attempts (force_kf below).
    drift_streak = 0
    # In-flight segmentation: (seg, depth, T_mc) of the frame it was
    # dispatched on.
    pending_seg = None
    t0 = time.perf_counter()

    for i, frame in enumerate(frames):
        if i < start_frame:
            continue
        # Recovery: after `relocalize_after` lost frames, query the ferns
        # with the raw frame, verify against the retrieved keyframe by ICP
        # and re-seat the pose there.
        relocalized = False
        if (
            enable_loops
            and relocalize_after > 0
            and int(state.lost_frames) >= relocalize_after
            and int(backend.kf.count) > 0
        ):
            with timer.phase("relocalize"):
                lvl0 = _level0(cfg, frame.depth)
                cand, diss = pg.detect_loop(backend, frame.color, frame.depth, min_gap=0)
                if float(diss) < 2 * pgc.loop_dist_thresh:
                    T_cand = pg._pick(backend.kf.poses, cand)
                    T_rel, _, ok = pg.verify_loop(
                        backend, cand, lvl0["vmap"], lvl0["nmap"], cfg.intrinsics, cfg,
                        T_cur_wc=T_cand)
                    if bool(ok):
                        # Keyframe poses are world-frame; the engine's are
                        # map-frame.  No map-based polish: the ICP against
                        # the keyframe's raw geometry is the better estimate.
                        T_new = se3_inverse(T_wm) @ (T_cand @ T_rel)
                        if streamer is not None:
                            # The re-seated view may cover streamed-out
                            # geometry: admit the window there first.
                            state, _ = _stream(streamer, state, T_new)
                        # The stale prediction views the wrong part of the
                        # map: re-render it from the re-seated pose.  The
                        # step never writes a pose in place, so T_new may
                        # stand in three fields.
                        state = state._replace(
                            T_wc=T_new, pred=rerender(state.volume, T_new),
                            pred_T_wc=T_new, T_prev_wc=T_new,  # zero the velocity
                            lost_frames=torch.zeros_like(state.lost_frames))
                        if state.drift_ewma is not None:
                            state = state._replace(drift_ewma=torch.zeros_like(state.drift_ewma))
                        drift_streak = 0
                        relocalized = True

        # Fuse the segmentation dispatched on an earlier frame, against that
        # frame's own depth and pose.
        if pending_seg is not None:
            with timer.phase("seg_fuse"):
                state = engine.fuse_segmentation(state, *pending_seg)
                pending_seg = None
        with timer.phase("step"):
            if gt_odometry is not None:
                # Tracking bypass: fuse at the dataset pose.
                T_gt = torch.as_tensor(gt_odometry[i], dtype=torch.float32, device=dev)
                state, info = engine.step_gt(state, frame.depth, frame.color,
                                             se3_inverse(T_wm) @ T_gt)
            else:
                state, info = engine.step(state, frame.depth, frame.color)
        if relocalized:
            # The first solve after a re-seat is itself a correction:
            # extrapolated as velocity it would walk a static view away.
            state = state._replace(T_prev_wc=state.T_wc)
        if info.drift_alarm is not None:
            drift_streak = drift_streak + 1 if bool(info.drift_alarm) else 0
        # Dispatch the segmentation head at its cadence without reading it.
        seg_dispatched = False
        if (
            segment_fn is not None
            and cfg.use_instances
            and i % max(cfg.instances.seg_every, 1) == 0
            and bool(info.track_ok)
        ):
            with timer.phase("seg_dispatch"):
                seg = segment_fn(frame)
            if seg is not None:
                # A clone: the next frame's replay overwrites the pose.
                pending_seg = (seg, frame.depth, state.T_wc.clone())
                seg_dispatched = True

        # Local (active/inactive) loop closure (engine/localloop.py).
        local_closed = False
        n_evidence = 0
        if (
            local_loops
            and cfg.track_stamps
            and cfg.map_kind == "blocks"
            and (i + 1) % local_every == 0
            and bool(info.track_ok)
        ):
            n_evidence = int(ll.evidence_count(cfg, state))
            if n_evidence >= local_min_blocks:
                with timer.phase("localloop"):
                    lvl0 = _level0(cfg, frame.depth)
                    res = ll.attempt(cfg, state, lvl0["vmap"], lvl0["nmap"], lvl0["valid"])
                    if bool(res.ok):
                        T_corr = res.T_corr_wc
                        T_world_corr = T_wm @ T_corr
                        # Pose-graph constraint: a loop edge from the nearest
                        # old keyframe to a keyframe at the corrected pose.
                        nkf = int(backend.kf.count)
                        if nkf > 2:
                            poses_np = backend.kf.poses[:nkf].cpu().numpy()
                            dists = np.linalg.norm(
                                poses_np[: nkf - 2, :3, 3] - T_world_corr[:3, 3].cpu().numpy(),
                                axis=-1)
                            anchor = int(np.argmin(dists))
                            backend = pg.add_keyframe(backend, T_world_corr, frame.color,
                                                      frame.depth, lvl0["vmap"], lvl0["nmap"])
                            kf_cur = backend.kf.count - 1
                            T_rel = se3_inverse(backend.kf.poses[anchor]) @ T_world_corr
                            backend = pg.add_loop_edge(backend, anchor, kf_cur, T_rel)
                            T_before = pg._pick(backend.kf.poses, kf_cur)
                            backend, _ = _optimize_after_loop(backend, cfg, anchor, kf_cur,
                                                              T_rel, ba_terms_fn)
                            T_wm = _anchor_correction(backend, kf_cur, T_before, T_wm)
                        # Re-seat the engine on the old geometry.
                        state = state._replace(
                            T_wc=T_corr, pred=rerender(state.volume, T_corr),
                            pred_T_wc=T_corr, T_prev_wc=T_corr,
                            stamp=ll.reset_gaps(state.stamp, pgc.local_window))
                        n_loops += 1
                        local_closed = True
                        local_fails = 0
                    else:
                        local_fails += 1
                        if local_fails >= 5:
                            # Evidence that keeps failing to register is
                            # consumed and re-armed.
                            state = state._replace(
                                stamp=ll.reset_gaps(state.stamp, pgc.local_window))
                            local_fails = 0

        # Keyframes only from frames that tracked.  A persistent sentinel
        # alarm forces an out-of-cadence keyframe and loop attempt: loop
        # closure is what arrests map-feedback drift; hard relocalization
        # stays reserved for lost tracking.
        force_kf = drift_streak >= max(3 * relocalize_after, 15)
        is_kf = (
            enable_loops
            and (i % pgc.keyframe_every == 0 or force_kf)
            and bool(info.track_ok)
        )
        closed = False
        if is_kf:
            with timer.phase("keyframe"):
                lvl0 = _level0(cfg, frame.depth)
                T_world = T_wm @ state.T_wc
                backend = pg.add_keyframe(backend, T_world, frame.color, frame.depth,
                                          lvl0["vmap"], lvl0["nmap"])
                cand, diss = pg.detect_loop(backend, frame.color, frame.depth)
                if float(diss) < pgc.loop_dist_thresh:
                    T_rel, _, ok = pg.verify_loop(backend, cand, lvl0["vmap"], lvl0["nmap"],
                                                  cfg.intrinsics, cfg, T_cur_wc=T_world)
                    if bool(ok):
                        kf_cur = backend.kf.count - 1
                        backend = pg.add_loop_edge(backend, cand, kf_cur, T_rel)
                        T_before = pg._pick(backend.kf.poses, kf_cur)
                        backend, _ = _optimize_after_loop(backend, cfg, cand, kf_cur, T_rel,
                                                          ba_terms_fn)
                        # Re-anchor the map; the engine state is untouched.
                        T_wm = _anchor_correction(backend, kf_cur, T_before, T_wm)
                        n_loops += 1
                        closed = True
            if force_kf:
                drift_streak = 0  # the next forced attempt needs a fresh streak

        # Map hygiene: confidence culling with slot compaction, instance
        # retirement.
        if clean_every and cfg.map_kind == "blocks" and (i + 1) % clean_every == 0:
            state = engine.clean(state)
        if retire_every and cfg.use_instances and (i + 1) % retire_every == 0:
            state = state._replace(table=inst.retire_stale(state.table, cfg.instances))
        stream_stats = {}
        if streamer is not None and (i + 1) % stream_every == 0:
            with timer.phase("stream"):
                state, stream_stats = _stream(streamer, state, state.T_wc)

        # Occupancy rebalance of the slab cuts; also right after a loop
        # closure or a relocalization (the camera fuses next where the
        # trajectory was re-anchored).
        reshard_migrated = 0
        if group is not None and reshard_every and (
                (i + 1) % reshard_every == 0 or closed or relocalized):
            with timer.phase("reshard"):
                state, reshard_migrated = engine.reshard(state, reshard_skew)

        est.append(T_wm @ state.T_wc)
        if metrics is not None:
            drift = {}
            if info.drift_alarm is not None:
                drift = {"drift_ewma_mm": round(float(info.drift_ewma) * 1000, 3),
                         "drift_alarm": bool(info.drift_alarm)}
            metrics.write({
                "frame": i,
                "inliers": float(info.inliers),
                "residual_m": float(info.residual),
                "track_ok": bool(info.track_ok),
                "keyframe": bool(is_kf),
                "loop_closed": closed,
                "local_loop_closed": local_closed,
                "local_evidence": n_evidence,
                "relocalized": relocalized,
                "seg_dispatched": seg_dispatched,
                "lost_frames": int(state.lost_frames),
                "reshard_migrated": reshard_migrated,
                **drift,
                **stream_stats,
                **{f"t_{k}_ms": round(v, 2) for k, v in timer.times_ms.items()},
            })
            timer.times_ms.clear()

        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            sync_fetch((state, backend, T_wm))
            ckpt.save(checkpoint_dir, (state, backend, T_wm), cfg, i + 1, group=group)
            if streamer is not None:
                streamer.save(os.path.join(checkpoint_dir, f"step_{i + 1}.streamer.npz"))

    # Flush the last in-flight segmentation so its votes are not lost.
    if pending_seg is not None:
        state = engine.fuse_segmentation(state, *pending_seg)
    sync_fetch(state.T_wc)
    elapsed = time.perf_counter() - t0
    return PipelineResult(
        poses=torch.stack(est).cpu().numpy() if est else np.zeros((0, 4, 4)),
        n_keyframes=int(backend.kf.count),
        n_loops=n_loops,
        fps=len(est) / max(elapsed, 1e-9),
        state=state,
        backend=backend,
        graph_replays=engine.graphed.replays if engine.graphed is not None else 0,
    )
