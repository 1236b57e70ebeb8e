"""Active/inactive local loop closure over the block map (port of
``engine/localloop.py``).

``slam.step`` keeps per-slot observation stamps (``SlamState.stamp``:
last fused frame and the unseen gap before the current update streak) when
``EngineConfig.track_stamps`` is on.  A block whose update streak began
after more than ``PoseGraphConfig.local_window`` unseen frames is revisit
evidence: the camera fuses geometry it has not seen for a long time, where
accumulated drift becomes measurable.

- ``evidence_count``: the in-frustum revisit-evidence blocks, a cheap poll.
- ``attempt``: splat a prediction of only the old (inactive) blocks, the
  same kernel K5 as the tracking prediction with a different slot list, and
  register the current frame against it by the full coarse-to-fine ICP
  with widened gates.  Success gives the drift-corrected pose.
- ``reset_gaps``: consume the evidence after a loop is processed.

The old geometry wins: it was fused while the trajectory was younger and
less drifted.  Everything stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instancefusion_tpu_torch.config import EngineConfig
from instancefusion_tpu_torch.ops import blocks, icp
from instancefusion_tpu_torch.ops.common import decimate


class LocalLoopResult(NamedTuple):
    ok: torch.Tensor  # () bool converged and the gates passed
    T_corr_wc: torch.Tensor  # (4,4) drift-corrected camera pose (map frame)
    inliers: torch.Tensor  # () f32
    pred_pixels: torch.Tensor  # () f32 inactive-view coverage used


def _inactive_slot_mask(cfg: EngineConfig, state) -> torch.Tensor:
    """Slots forming the inactive (revisited) model view: bool[capacity].

    Union of in-view blocks whose current update streak began after a gap
    longer than the window (the revisited old geometry) and in-view blocks
    still unseen for longer than the window (old geometry the camera
    approaches but has not re-fused yet).
    """
    window = cfg.posegraph.local_window
    f = state.frame_idx + 1
    last, gap = state.stamp[:, 0], state.stamp[:, 1]
    inview = blocks.frustum_mask(state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf,
                                 cfg.raycast.near, cfg.raycast.far)
    revisited = gap > window
    stale = (last > 0) & (f - last > window)
    return inview & (revisited | stale)


def evidence_count(cfg: EngineConfig, state) -> torch.Tensor:
    """Number of in-frustum revisit-evidence blocks: () i32 on the device."""
    inview = blocks.frustum_mask(state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf,
                                 cfg.raycast.near, cfg.raycast.far)
    return torch.sum(inview & (state.stamp[:, 1] > cfg.posegraph.local_window),
                     dtype=torch.int32)


def _pyramid_from_maps(vmap_c, nmap_c, valid, levels: int):
    """Nearest-subsampled source pyramid (fine -> coarse) for ``icp.track``."""
    return [{"vmap": decimate(vmap_c, 1 << lvl), "nmap": decimate(nmap_c, 1 << lvl),
             "valid": decimate(valid, 1 << lvl)} for lvl in range(levels)]


def attempt(cfg: EngineConfig, state, vmap_c: torch.Tensor, nmap_c: torch.Tensor,
            valid: torch.Tensor) -> LocalLoopResult:
    """Register the current frame's level-0 maps (camera frame) against the
    inactive model view rendered at ``state.T_wc``."""
    pg = cfg.posegraph
    sel = _inactive_slot_mask(cfg, state)
    k = min(cfg.tsdf.touched_capacity, state.volume.sdf.shape[0])
    slots, slot_valid = blocks.compact_mask_indices(sel, k)
    pred = blocks.raycast_splat(state.volume, state.T_wc, cfg.intrinsics, cfg.tsdf,
                                slots, slot_valid, with_color=False,
                                rmax=cfg.raycast.splat_rmax)
    n_pred = torch.sum(pred.valid.float())
    # Full coarse-to-fine ICP with widened gates (drift can exceed the
    # tracking association gate) and the configuration's other defaults.
    icp_cfg = type(cfg.icp)(
        iters=cfg.icp.iters, levels=cfg.icp.levels,
        dist_thresh=cfg.icp.dist_thresh * 2.0, angle_thresh=cfg.icp.angle_thresh,
        rgb_weight=0.0, damping=cfg.icp.damping, huber_delta=cfg.icp.huber_delta,
        min_valid=pg.local_min_pixels // 4, use_pallas=cfg.icp.use_pallas,
    )
    pyr = _pyramid_from_maps(vmap_c, nmap_c, valid, cfg.icp.levels)
    result = icp.track(pyr, pred.vertex_w, pred.normal_w, pred.valid,
                       state.T_wc, state.T_wc, cfg.intrinsics, icp_cfg)
    ok = (result.valid & (n_pred >= pg.local_min_pixels)
          & (result.inliers >= pg.local_min_inlier_frac * pg.local_min_pixels)
          & (result.residual < cfg.tsdf.voxel_size))
    return LocalLoopResult(ok=ok, T_corr_wc=torch.where(ok, result.T_wc, state.T_wc),
                           inliers=result.inliers, pred_pixels=n_pred)


def reset_gaps(stamp: torch.Tensor, window: int) -> torch.Tensor:
    """Consume revisit evidence after a processed (or rejected) loop."""
    gap = torch.where(stamp[:, 1] > window, torch.zeros_like(stamp[:, 1]), stamp[:, 1])
    return torch.stack([stamp[:, 0], gap], dim=-1)
