"""Dense TSDF volume (config1): allocation, projective integration,
trilinear sampling (port of ``ops/tsdf.py``).

Layout as in the reference: ``sdf`` and ``weight`` are ``f32[N, N, N]``
indexed ``[ix, iy, iz]``, ``color`` ``f32[N, N, N, 3]`` (``[0, 0, 0, 3]``
without color); a voxel's center lies at ``origin + (idx + 0.5) *
voxel_size``; stored sdf is the signed distance over the truncation band,
clamped to [-1, 1].  The reference runs no kernel for the dense map, and
neither does the port: every function here is plain PyTorch.  Integration
is functional (a new volume comes back), as in the reference.

The trilinear stencil helpers (``stencil``, ``corner_sum``) are shared with
the block map's samplers (``ops/blocks.py``): the eight corners are gathered
at once and summed in the reference's corner order, so each sample keeps
the reference's rounding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from reference.config import TsdfConfig
from reference.geometry.camera import Intrinsics, nearest_pixel, project
from reference.geometry.se3 import se3_inverse, transform_points


class TsdfVolume(NamedTuple):
    sdf: torch.Tensor  # f32[N,N,N], normalized to [-1, 1]
    weight: torch.Tensor  # f32[N,N,N]
    color: torch.Tensor  # f32[N,N,N,3], or [0,0,0,3] without color


def allocate(cfg: TsdfConfig, device, with_color: bool = True) -> TsdfVolume:
    n = cfg.grid_size
    f32 = dict(dtype=torch.float32, device=device)
    return TsdfVolume(
        sdf=torch.ones((n, n, n), **f32),
        weight=torch.zeros((n, n, n), **f32),
        color=torch.zeros((n, n, n, 3) if with_color else (0, 0, 0, 3), **f32),
    )


@functools.lru_cache(maxsize=32)
def vec3(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant f32[3] on `device`, made by fills (no copy from the host)."""
    return torch.stack([torch.full((), float(x), dtype=torch.float32, device=device)
                        for x in values])


def voxel_world_coords(cfg: TsdfConfig, device) -> torch.Tensor:
    """World position of every voxel center: f32[N,N,N,3]."""
    idx = torch.arange(cfg.grid_size, dtype=torch.float32, device=device)
    grid = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1)
    return vec3(cfg.origin, torch.device(device)) + (grid + 0.5) * cfg.voxel_size


def integrate(
    volume: TsdfVolume,
    depth: torch.Tensor,
    color: torch.Tensor | None,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    cfg: TsdfConfig,
) -> TsdfVolume:
    """Fuse one depth (+color) frame into the volume.

    Each voxel projects into the frame (round half to even) and reads the
    depth there; weighted running average.  Unlike the block map there is
    no sentinel: a voxel that was never observed becomes 0 / 1e-6 = 0, and
    color has no cadence gain.
    """
    p_w = voxel_world_coords(cfg, depth.device)
    p_c = transform_points(se3_inverse(T_wc), p_w.reshape(-1, 3)).reshape(p_w.shape)
    u, v, z = project(intr, p_c)
    in_img, pix = nearest_pixel(intr, u, v)
    d = depth.reshape(-1)[pix]
    sdf_obs = d - z  # positive in front of the surface
    valid = in_img & (z > 0.0) & (d > 0.0) & (sdf_obs > -cfg.trunc)
    psi = torch.clamp(sdf_obs / cfg.trunc, -1.0, 1.0)
    w_obs = valid.float()
    w_new = volume.weight + w_obs
    denom = torch.clamp(w_new, min=1e-6)
    sdf_new = (volume.sdf * volume.weight + psi * w_obs) / denom
    new_color = volume.color
    if color is not None and volume.color.numel():
        c = color.reshape(-1, 3)[pix]
        new_color = (volume.color * volume.weight[..., None]
                     + c * w_obs[..., None]) / denom[..., None]
    return TsdfVolume(sdf=sdf_new, weight=torch.clamp(w_new, max=cfg.max_weight),
                      color=new_color)


@functools.lru_cache(maxsize=8)
def _corner_offsets(device: torch.device) -> torch.Tensor:
    """i64[8, 3]: the stencil corners (di, dj, dk) in the reference's loop
    order, row c = the bits of c."""
    return torch.arange(8, device=device)[:, None].bitwise_right_shift(
        torch.arange(2, -1, -1, device=device)[None, :]) & 1  # i64[8, 3]


def stencil(p_w: torch.Tensor, cfg: TsdfConfig):
    """Trilinear stencil of world points (..., 3): (in bounds, the eight
    corners' voxel indices i64[..., 8, 3] clamped into the grid, their
    weights f32[..., 8]).  Weights are (x-term * y-term) * z-term, as the
    reference multiplies them."""
    n = cfg.grid_size
    g = (p_w - vec3(cfg.origin, p_w.device)) / cfg.voxel_size - 0.5
    g0 = torch.floor(g)
    frac = g - g0
    # Compared as floats (the floored values are whole), then clamped
    # before the cast, so out-of-range points never reach the integer cast.
    inb = torch.all((g0 >= 0) & (g0 < n - 1), dim=-1)
    g0c = torch.nan_to_num(g0).clamp(0, n - 2).long()
    corners = g0c[..., None, :] + _corner_offsets(p_w.device)
    wk = torch.stack([1.0 - frac, frac], dim=-1)  # (..., 3, 2)
    tw = (wk[..., 0, :, None, None] * wk[..., 1, None, :, None]) * wk[..., 2, None, None, :]
    return inb, corners, tw.reshape(tw.shape[:-3] + (8,))


def corner_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (the 8 corners) in the reference's order, one
    corner after another."""
    val = terms[..., 0]
    for i in range(1, 8):
        val = val + terms[..., i]
    return val


def _flat(corners: torch.Tensor, n: int) -> torch.Tensor:
    return (corners[..., 0] * n + corners[..., 1]) * n + corners[..., 2]


def sample_trilinear(volume: TsdfVolume, p_w: torch.Tensor, cfg: TsdfConfig):
    """Trilinear SDF sample at world points (..., 3): (sdf, valid); valid
    requires the stencil in bounds and all 8 corners observed (weight > 0)."""
    inb, corners, tw = stencil(p_w, cfg)
    flat = _flat(corners, cfg.grid_size)
    s = volume.sdf.reshape(-1)[flat]
    w = volume.weight.reshape(-1)[flat]
    val = corner_sum(tw * s)
    return val, inb & (torch.amin(w, dim=-1) > 0.0)


def sample_color_trilinear(volume: TsdfVolume, p_w: torch.Tensor, cfg: TsdfConfig):
    """Trilinear color sample at world points (..., 3) -> (..., 3)."""
    _, corners, tw = stencil(p_w, cfg)
    c = volume.color.reshape(-1, 3)[_flat(corners, cfg.grid_size)]  # (..., 8, 3)
    return corner_sum((tw[..., None] * c).transpose(-1, -2))


def gradient_points(p_w: torch.Tensor, h: float) -> torch.Tensor:
    """The six central-difference points of (..., 3): (6, ..., 3), in the
    order +x, -x, +y, -y, +z, -z."""
    pts = p_w[None].repeat((6,) + (1,) * p_w.dim())
    for axis in range(3):
        pts[2 * axis, ..., axis] += h
        pts[2 * axis + 1, ..., axis] -= h
    return pts


def gradient_from_samples(s: torch.Tensor, v: torch.Tensor):
    """Unit gradient and validity from `gradient_points`' six samples."""
    g = torch.stack([s[0] - s[1], s[2] - s[3], s[4] - s[5]], dim=-1)
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    return g / torch.clamp(norm, min=1e-12), torch.all(v, dim=0) & (norm[..., 0] > 1e-12)


def sdf_gradient(volume: TsdfVolume, p_w: torch.Tensor, cfg: TsdfConfig):
    """Central-difference SDF gradient at world points (surface normals):
    (unit normal (..., 3), valid)."""
    s, v = sample_trilinear(volume, gradient_points(p_w, cfg.voxel_size), cfg)
    return gradient_from_samples(s, v)
