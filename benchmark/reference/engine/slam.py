"""SLAM engine: track -> fuse -> predict (port of ``engine/slam.py``).

One frame runs: preprocess (kernel K1), 3-level ICP (K2 and K3), then the
map update, by map kind (``EngineConfig.map_kind``):

- the block map with splat prediction (``RaycastConfig.use_splat``, the
  configuration ``bench.py`` times): ``blocks.discover_allocate``, the
  in-frustum slot list, TSDF integrate (K4) and splat prediction (K5);
- the block map without it: the touched-block ``blocks.integrate`` (K8)
  and the marched ``blocks.raycast`` (with the depth prior and
  screen-space normals when the configuration asks for them);
- the dense volume (config1): ``ops/tsdf.integrate`` and the dense
  ``ops/raycast.raycast``, plain PyTorch as in the reference.

The last two fuse the frame color on every frame (no cadence), as the
reference does.  Instance fusion (``use_instances``) is left out of this
copy: no cell of the benchmark runs it.  With ``rgb_weight > 0`` and
``use_color`` the ICP adds the photometric term against the predicted
color's intensity; ``track_stamps`` (block map only) keeps per-slot
observation stamps for ``engine/localloop.py``; ``consistency_check`` runs
the drift sentinel, a coarse frame-to-frame ICP beside the frame-to-model
one.  This engine keeps the whole map on one device whatever
``num_shards`` says, as the reference's does; the sharded map runs in
``engine/slam_sharded.py``.

The state is a ``NamedTuple`` of tensors on one device, as in the
reference.  ``step`` keeps everything on the device (no host read per
frame); on the block map it updates the map's payload in place: the state
passed in must not be used after the call; rebind it, as with the
reference's donated step.  The color cadence needs the frame number on the
host, so the state carries it as a plain int (``frame_count``) beside the
device counter ``frame_idx``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from reference import device as _device
from reference.config import EngineConfig
from reference.geometry.se3 import se3_exp, se3_inverse, se3_log
from reference.ops import blocks, icp, preprocess, tsdf
from reference.ops import raycast as rc
from reference.ops.raycast import RaycastMaps


class _DenseOps:
    """Dense-volume map interface (config1)."""

    allocate = staticmethod(tsdf.allocate)
    integrate = staticmethod(tsdf.integrate)
    raycast = staticmethod(rc.raycast)


def _map_ops(cfg: EngineConfig):
    """Map-kind dispatch: the dense volume (config1) or the block map."""
    return blocks if cfg.map_kind == "blocks" else _DenseOps


class SlamState(NamedTuple):
    T_wc: torch.Tensor  # (4,4) current camera-to-world pose
    volume: tsdf.TsdfVolume | blocks.BlockMap
    pred: RaycastMaps  # model prediction rendered at pred_T_wc
    pred_T_wc: torch.Tensor  # (4,4) pose the prediction was rendered from
    frame_idx: torch.Tensor  # () i32
    lost_frames: torch.Tensor  # () i32 consecutive tracking failures
    T_prev_wc: torch.Tensor  # previous frame's pose (motion-model seed)
    # Instance subsystem of the program; always None here.
    votes: object | None = None
    table: object | None = None
    frame_count: int = 0  # host copy of frame_idx (color cadence)
    # Per-slot observation stamps i32[capacity, 2] = (last fused frame,
    # 1-based; unseen gap before the current update streak), None unless
    # cfg.track_stamps: the revisit evidence of engine/localloop.py.
    stamp: torch.Tensor | None = None
    # Drift sentinel (cfg.consistency_check): the previous frame's
    # coarse-level (vmap, nmap, valid) and the world-frame EWMA f32[3] of
    # the frame-to-frame vs frame-to-model translation disagreement.
    prev_coarse: tuple | None = None
    drift_ewma: torch.Tensor | None = None


class StepInfo(NamedTuple):
    inliers: torch.Tensor
    residual: torch.Tensor
    track_ok: torch.Tensor
    fused_voxels: torch.Tensor  # valid depth pixels fused this frame
    # Drift sentinel (cfg.consistency_check): |EWMA| (m) and whether it
    # crossed cfg.consistency_thresh this frame.
    drift_ewma: torch.Tensor | None = None
    drift_alarm: torch.Tensor | None = None


def init_state(cfg: EngineConfig, T_init_wc=None, device=None) -> SlamState:
    """Empty map and invalid prediction at pose `T_init_wc` (default identity).

    Runs on ``cuda`` unless ``device`` says otherwise; raises with no card.
    """
    dev = _device.resolve(device)
    votes = stamp = None
    if cfg.use_instances:
        raise ValueError("this reference leaves instance fusion out")
    if cfg.track_stamps:
        if cfg.map_kind != "blocks":
            raise ValueError("track_stamps requires map_kind='blocks'")
        stamp = torch.zeros((cfg.tsdf.table_capacity, 2), dtype=torch.int32, device=dev)
    volume = _map_ops(cfg).allocate(cfg.tsdf, dev, with_color=cfg.use_color)
    return empty_state(cfg, T_init_wc, volume, votes, stamp)


def empty_state(cfg: EngineConfig, T_init_wc, volume, votes=None, stamp=None) -> SlamState:
    """A state around the given empty map (and vote planes and stamps, when
    the configuration keeps them) on the map's device: the pose
    `T_init_wc` (default identity), an invalid prediction, the instance
    table and the sentinel's state where the configuration asks for them."""
    dev = volume.sdf.device
    h, w = cfg.intrinsics.height, cfg.intrinsics.width
    f32 = dict(dtype=torch.float32, device=dev)
    T0 = (torch.eye(4, **f32) if T_init_wc is None
          else torch.as_tensor(T_init_wc, **f32).clone())
    pred = RaycastMaps(
        vertex_w=torch.zeros((h, w, 3), **f32),
        normal_w=torch.zeros((h, w, 3), **f32),
        depth=torch.zeros((h, w), **f32),
        color=torch.zeros((h, w, 3), **f32),
        valid=torch.zeros((h, w), dtype=torch.bool, device=dev),
    )
    table = None
    prev_coarse = drift_ewma = None
    if cfg.consistency_check:
        s = 1 << max(cfg.icp.levels - 2, 0)
        hc, wc = h // s, w // s
        prev_coarse = (torch.zeros((hc, wc, 3), **f32), torch.zeros((hc, wc, 3), **f32),
                       torch.zeros((hc, wc), dtype=torch.bool, device=dev))
        drift_ewma = torch.zeros((3,), **f32)
    return SlamState(
        T_wc=T0,
        volume=volume,
        pred=pred,
        pred_T_wc=T0.clone(),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        lost_frames=torch.zeros((), dtype=torch.int32, device=dev),
        T_prev_wc=T0.clone(),
        votes=votes,
        table=table,
        stamp=stamp,
        prev_coarse=prev_coarse,
        drift_ewma=drift_ewma,
    )


def _splat_map_update(cfg: EngineConfig, volume, pred_prev_depth, depth_eff,
                      frame_color, T_new, frame_count: int):
    """Allocate, integrate and splat-predict from one in-frustum slot list."""
    intr = cfg.intrinsics
    pred_color = cfg.use_color and (
        cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
    )
    prior = torch.where(depth_eff > 0.0, depth_eff, pred_prev_depth)
    volume = blocks.discover_allocate(volume, depth_eff, T_new, intr, cfg.tsdf)
    k = min(cfg.tsdf.touched_capacity, blocks.num_blocks_per_axis(cfg.tsdf) ** 3)
    slots, slot_valid = blocks.frustum_slots(
        volume, T_new, intr, cfg.tsdf, cfg.raycast.near, cfg.raycast.far, k,
    )
    # Color cadence: fuse color every color_every-th frame at gain
    # color_every, so the color average keeps its every-frame time constant.
    col, gain = frame_color, 1.0
    if frame_color is not None and cfg.color_every > 1:
        on = frame_count % cfg.color_every == 0
        col, gain = (frame_color, float(cfg.color_every)) if on else (None, 1.0)
    volume = blocks.integrate_slots(
        volume, slots, slot_valid, depth_eff, col, T_new, intr, cfg.tsdf,
        color_gain=gain,
    )
    pred = blocks.raycast_splat(
        volume, T_new, intr, cfg.tsdf, slots, slot_valid,
        with_color=pred_color, depth_prior=prior, rmax=cfg.raycast.splat_rmax,
    )
    return volume, pred


def _motion_seed(T_wc, T_prev_wc, vel: float, cap_t: float = 0.25,
                 cap_r: float = 0.25):
    """ICP seed from a damped constant-velocity model.

    Replays `vel` x the previous camera-frame twist; a twist beyond
    cap_t m / cap_r rad is an outlier (a re-seat or a solver correction,
    not motion) and falls back to the previous-pose seed.
    """
    if vel == 0.0:
        return T_wc
    xi = vel * se3_log(se3_inverse(T_prev_wc) @ T_wc)
    plausible = (torch.linalg.norm(xi[:3]) <= cap_t) & (torch.linalg.norm(xi[3:]) <= cap_r)
    T_seed = T_wc @ se3_exp(plausible.float() * xi)
    return torch.where(torch.all(torch.isfinite(T_seed)), T_seed, T_wc)


def tsdf_integrate_count(depth: torch.Tensor) -> torch.Tensor:
    """Proxy metric: valid depth pixels fused this frame."""
    return torch.sum((depth > 0).float())


def _march_map_update(cfg: EngineConfig, volume, pred_prev_depth, depth_eff,
                      frame_color, T_new):
    """Integrate through the map kind's own ``integrate`` and predict with its
    marched raycast (the block map without splat prediction, or the dense
    volume); the frame color is fused on every frame."""
    ops = _map_ops(cfg)
    pred_color = cfg.use_color and (
        cfg.raycast.predict_color or cfg.icp.rgb_weight > 0.0
    )
    volume = ops.integrate(volume, depth_eff, frame_color, T_new, cfg.intrinsics, cfg.tsdf)
    rc_kwargs = {}
    if cfg.map_kind == "blocks":
        if cfg.raycast.use_depth_prior:
            # This frame's fused depth; holes (and lost frames, which fused
            # nothing) fall back to the previous prediction.
            rc_kwargs["depth_prior"] = torch.where(depth_eff > 0.0, depth_eff,
                                                   pred_prev_depth)
        rc_kwargs["screen_space_normals"] = cfg.raycast.screen_space_normals
    pred = ops.raycast(volume, T_new, cfg.intrinsics, cfg.tsdf, cfg.raycast,
                       with_color=pred_color, **rc_kwargs)
    return volume, pred


def _fuse_and_predict(cfg, state, d0, color, T_new, fuse_ok):
    """Fuse the gated depth, predict, and update the stamps when kept;
    returns (volume, pred, stamp)."""
    depth_masked = torch.where(fuse_ok, d0, torch.zeros_like(d0))
    frame_color = color if cfg.use_color else None
    if cfg.map_kind == "blocks" and cfg.raycast.use_splat:
        volume, pred = _splat_map_update(
            cfg, state.volume, state.pred.depth, depth_masked, frame_color, T_new,
            state.frame_count,
        )
    else:
        volume, pred = _march_map_update(cfg, state.volume, state.pred.depth,
                                         depth_masked, frame_color, T_new)
    stamp = state.stamp
    if stamp is not None:
        # Allocation made a new n_active; the incoming one is the slot
        # count before this frame (integration updates only the payload).
        stamp = _update_stamps(cfg, stamp, volume, state.volume.n_active, T_new,
                               fuse_ok, state.frame_idx)
    return volume, pred, stamp


def _inputs(state: SlamState, depth, color):
    dev = state.T_wc.device
    return (torch.as_tensor(depth, dtype=torch.float32, device=dev),
            torch.as_tensor(color, dtype=torch.float32, device=dev))


def _update_stamps(cfg: EngineConfig, stamp, volume, n_before, T_new, fuse_ok,
                   frame_idx):
    """Per-slot (last_fused, gap) update for this frame's in-view blocks.

    Stamps are 1-based frame numbers (0 = never fused).  A block updated
    after going unseen for more than 2 frames records that gap, sticky
    until ``localloop.reset_gaps``: the revisit evidence for local loop
    closure.  Slots allocated this frame (from ``n_before``, the slot count
    before its allocation, to ``volume.n_active``) are new geometry, not
    revisits: their gap stays 0.
    """
    f = frame_idx + 1
    inview = blocks.frustum_mask(volume, T_new, cfg.intrinsics, cfg.tsdf,
                                 cfg.raycast.near, cfg.raycast.far) & fuse_ok
    last, gap = stamp[:, 0], stamp[:, 1]
    gap_new = torch.where(inview & (f - last > 2) & (last > 0), f - last, gap)
    last_new = torch.where(inview, f, last)
    slot_ids = torch.arange(stamp.shape[0], dtype=torch.int32, device=stamp.device)
    fresh = (slot_ids >= n_before) & (slot_ids < volume.n_active)
    last_new = torch.where(fresh, f, last_new)
    gap_new = torch.where(fresh, torch.zeros_like(gap_new), gap_new)
    return torch.stack([last_new, gap_new], dim=-1)


def _consistency_update(cfg: EngineConfig, state: SlamState, pyr, result, T_new):
    """Drift sentinel: a coarse frame-to-frame ICP beside frame-to-model.

    Slow map-feedback drift keeps inliers high, so the health gate cannot
    see it.  One level above the coarsest, the frame is registered against
    the previous frame's maps (no map in the loop), seeded at the
    frame-to-model increment; the translation disagreement, rotated into
    the world frame, feeds a vector EWMA: per-frame ICP noise averages out,
    a dragging map's bias does not.  Returns (this frame's coarse maps, the
    EWMA, its norm, the alarm), or four Nones when the check is off; every
    value stays on the device.
    """
    if not cfg.consistency_check:
        return None, None, None, None
    lvl = max(cfg.icp.levels - 2, 0)
    coarse = pyr[lvl]
    cur = (coarse["vmap"], coarse["nmap"], coarse["valid"])
    pv, pn, pval = state.prev_coarse
    T_rel_f2m = se3_inverse(state.T_wc) @ T_new  # previous camera -> this one
    icp_cfg = dataclasses.replace(
        cfg.icp, levels=1, iters=(6,), rgb_weight=0.0,
        min_valid=max(cfg.icp.min_valid // 8, 20), assoc_every=2,
    )
    eye = torch.eye(4, dtype=torch.float32, device=T_new.device)
    f2f = icp.track([coarse], pv, pn, pval, T_rel_f2m, eye,
                    cfg.intrinsics.level(lvl), icp_cfg)
    delta = se3_inverse(f2f.T_wc) @ T_rel_f2m
    d_w = state.T_wc[:3, :3] @ delta[:3, 3]
    ok = result.valid & f2f.valid & (state.frame_idx > 0)
    a = cfg.consistency_alpha
    ewma = torch.where(ok, (1 - a) * state.drift_ewma + a * d_w, state.drift_ewma)
    mag = torch.linalg.norm(ewma)
    # The alarm is held down while the map settles (the first ~10 frames
    # fuse into a near-empty model; their disagreement is honest).
    return cur, ewma, mag, (mag > cfg.consistency_thresh) & (state.frame_idx > 10)


def step(cfg: EngineConfig, state: SlamState, depth, color):
    """Track -> fuse -> predict for one RGB-D frame; returns (state, info)."""
    return track_and_fuse(cfg, state, depth, color, _fuse_and_predict)


def track_and_fuse(cfg: EngineConfig, state: SlamState, depth, color, fuse):
    """`step` with the map update `fuse(cfg, state, d0, color, T_new,
    fuse_ok) -> (volume, pred, stamp)`: this engine's, or the sharded
    engine's (``engine/slam_sharded.py``)."""
    _device.resolve(state.T_wc.device)
    depth, color = _inputs(state, depth, color)
    intr = cfg.intrinsics
    # The intensities feed only the photometric term: made only when it runs.
    use_rgb = cfg.use_color and cfg.icp.rgb_weight > 0.0
    intensity = preprocess.rgb_to_intensity(color) if use_rgb else None
    pyr = preprocess.build_frame_pyramid(depth, intr, cfg.preprocess, cfg.icp.levels,
                                         intensity)
    pred_intensity = preprocess.rgb_to_intensity(state.pred.color) if use_rgb else None
    T_seed = _motion_seed(state.T_wc, state.T_prev_wc, cfg.icp.vel_seed)
    result = icp.track(
        pyr, state.pred.vertex_w, state.pred.normal_w, state.pred.valid,
        T_seed, state.pred_T_wc, intr, cfg.icp, pred_intensity=pred_intensity,
    )
    # Health gate: on failure fuse nothing and keep the pose; frame 0 fails
    # by construction (empty prediction) but must fuse.
    first = state.frame_idx == 0
    fuse_ok = result.valid | first
    T_new = torch.where(result.valid, result.T_wc, state.T_wc)
    d0 = pyr[0]["depth"]
    fused = torch.where(fuse_ok, tsdf_integrate_count(d0), torch.zeros((), device=d0.device))
    volume, pred, stamp = fuse(cfg, state, d0, color, T_new, fuse_ok)
    prev_coarse, drift_ewma, drift_mag, drift_alarm = _consistency_update(
        cfg, state, pyr, result, T_new)
    new_state = state._replace(
        T_wc=T_new,
        volume=volume,
        pred=pred,
        pred_T_wc=T_new,
        frame_idx=state.frame_idx + 1,
        lost_frames=torch.where(
            fuse_ok, torch.zeros_like(state.lost_frames), state.lost_frames + 1
        ),
        # On failure T_new == T_wc, so prev := T_new keeps the velocity zero.
        T_prev_wc=torch.where(result.valid, state.T_wc, T_new),
        frame_count=state.frame_count + 1,
        stamp=stamp,
        prev_coarse=prev_coarse,
        drift_ewma=drift_ewma,
    )
    info = StepInfo(inliers=result.inliers, residual=result.residual,
                    track_ok=fuse_ok, fused_voxels=fused,
                    drift_ewma=drift_mag, drift_alarm=drift_alarm)
    return new_state, info


def step_gt(cfg: EngineConfig, state: SlamState, depth, color, T_gt_wc):
    """Fuse -> predict at a given pose (tracking bypassed)."""
    return fuse_at(cfg, state, depth, color, T_gt_wc, _fuse_and_predict)


def fuse_at(cfg: EngineConfig, state: SlamState, depth, color, T_gt_wc, fuse):
    """`step_gt` with the map update `fuse` (as in `track_and_fuse`)."""
    _device.resolve(state.T_wc.device)
    depth, color = _inputs(state, depth, color)
    T_new = torch.as_tensor(T_gt_wc, dtype=torch.float32, device=depth.device)
    pyr = preprocess.build_frame_pyramid(depth, cfg.intrinsics, cfg.preprocess, 1)
    d0 = pyr[0]["depth"]
    fuse_ok = torch.ones((), dtype=torch.bool, device=d0.device)
    volume, pred, stamp = fuse(cfg, state, d0, color, T_new, fuse_ok)
    new_state = state._replace(
        T_wc=T_new, volume=volume, pred=pred, pred_T_wc=T_new,
        frame_idx=state.frame_idx + 1,
        lost_frames=torch.zeros_like(state.lost_frames),
        T_prev_wc=state.T_wc,
        frame_count=state.frame_count + 1,
        stamp=stamp,
    )
    zero = torch.zeros((), device=d0.device)
    info = StepInfo(inliers=zero, residual=zero, track_ok=fuse_ok,
                    fused_voxels=tsdf_integrate_count(d0))
    return new_state, info


def run_chunk(cfg: EngineConfig, state: SlamState, depths, colors):
    """`step` over K frames; StepInfo leaves come back stacked (K,)."""
    infos = []
    for d, c in zip(depths, colors):
        state, info = step(cfg, state, d, c)
        infos.append(info)
    return state, StepInfo(*(None if x[0] is None else torch.stack(x)
                             for x in zip(*infos)))


def run_sequence(cfg: EngineConfig, frames, T_init_wc=None, device=None):
    """Run `step` over an iterable of (depth, color) frames.

    Returns (poses [numpy 4x4 per frame], infos [StepInfo per frame], state).
    """
    state = init_state(cfg, T_init_wc, device)
    poses, infos = [], []
    for depth, color in frames:
        state, info = step(cfg, state, depth, color)
        poses.append(state.T_wc.cpu().numpy())
        infos.append(info)
    return poses, infos, state
