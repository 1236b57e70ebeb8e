"""Predicted model maps and the dense-volume raycaster (port of
``ops/raycast.py``).

``raycast`` marches every pixel's ray through the dense TSDF volume at a
fixed step, finds the first +/- zero crossing and refines it by secant
steps; normals come from the SDF gradient.  It is plain PyTorch, as in the
reference (no kernel serves the dense map).  The block map marches with
``ops/blocks.raycast`` or predicts by splatting (``ops/blocks.raycast_splat``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.config import RaycastConfig, TsdfConfig
from reference.geometry.camera import Intrinsics, ray_directions
from reference.ops import tsdf


class RaycastMaps(NamedTuple):
    vertex_w: torch.Tensor  # f32[H,W,3] world-frame surface points
    normal_w: torch.Tensor  # f32[H,W,3] world-frame surface normals
    depth: torch.Tensor  # f32[H,W] z-depth in the camera frame (0 = miss)
    color: torch.Tensor  # f32[H,W,3]
    valid: torch.Tensor  # bool[H,W]


def world_rays(intr: Intrinsics, T_wc: torch.Tensor):
    """Unit world-frame ray directions (H, W, 3) of every pixel and the
    length of each unit-z camera ray (H, W)."""
    rays_c = ray_directions(intr, T_wc.device)
    ray_norm = torch.linalg.norm(rays_c, dim=-1)
    dirs_w = (rays_c.reshape(-1, 3) @ T_wc[:3, :3].T).reshape(rays_c.shape)
    return dirs_w / torch.clamp(ray_norm[..., None], min=1e-12), ray_norm


def secant_start(t_lo, t_hi, s_lo, s_hi):
    """Secant estimate of the crossing between the bracketing samples."""
    denom = torch.clamp(s_lo - s_hi, min=1e-12)
    return t_lo + (t_hi - t_lo) * s_lo / denom


def raycast(
    volume: tsdf.TsdfVolume,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    cfg: RaycastConfig,
    with_color: bool = True,
) -> RaycastMaps:
    """March all pixels' rays; find the first +/- zero crossing.

    ``ceil((far - near) / step) + 1`` fixed steps of ``step_scale * trunc``
    from ``near`` (the same distance on every ray), then ``refine_steps``
    secant refinements with fresh trilinear samples.  Nothing is read back
    to the host.
    """
    dirs_w, ray_norm = world_rays(intr, T_wc)
    origin_w = T_wc[:3, 3]
    step = cfg.step_scale * tsdf_cfg.trunc
    num_steps = math.ceil((cfg.far - cfg.near) / step) + 1
    # t_i = near + i * step in float32, as the reference computes it.
    ts = cfg.near + torch.arange(num_steps, dtype=torch.float32, device=T_wc.device) * step

    def sample_at(t):
        return tsdf.sample_trilinear(volume, origin_w + t[..., None] * dirs_w, tsdf_cfg)

    shape = ray_norm.shape
    zeros = torch.zeros(shape, device=T_wc.device)
    prev_sdf, prev_valid = zeros, torch.zeros(shape, dtype=torch.bool, device=T_wc.device)
    t_lo, t_hi, s_lo, s_hi, found = zeros, zeros, zeros, zeros, prev_valid
    for i in range(num_steps):
        t = ts[i]
        s, v = sample_at(t.expand(shape))
        crossing = prev_valid & v & (prev_sdf > 0.0) & (s <= 0.0) & ~found
        t_lo = torch.where(crossing, t - step, t_lo)
        t_hi = torch.where(crossing, t, t_hi)
        s_lo = torch.where(crossing, prev_sdf, s_lo)
        s_hi = torch.where(crossing, s, s_hi)
        found = found | crossing
        prev_sdf, prev_valid = s, v

    t_star = secant_start(t_lo, t_hi, s_lo, s_hi)
    for _ in range(cfg.refine_steps):
        s, v = sample_at(t_star)
        # The stored sdf is normalized by trunc.
        t_star = torch.clamp(t_star + torch.where(v, s * tsdf_cfg.trunc, zeros),
                             t_lo, t_hi)

    p_hit = origin_w + t_star[..., None] * dirs_w
    normal_w, nvalid = tsdf.sdf_gradient(volume, p_hit, tsdf_cfg)
    valid = found & nvalid
    depth = torch.where(valid, t_star / ray_norm, zeros)
    zero3 = torch.zeros_like(p_hit)
    if with_color and volume.color.numel():
        color = torch.where(valid[..., None],
                            tsdf.sample_color_trilinear(volume, p_hit, tsdf_cfg), zero3)
    else:
        color = zero3
    return RaycastMaps(
        vertex_w=torch.where(valid[..., None], p_hit, zero3),
        normal_w=torch.where(valid[..., None], normal_w, zero3),
        depth=depth,
        color=color,
        valid=valid,
    )
