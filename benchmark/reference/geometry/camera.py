"""Pinhole camera model (port of ``geometry/camera.py``).

A pixel (u, v) integer index samples the center of that pixel; projection
gives continuous coordinates with (0, 0) at the center of the top-left
pixel, as TUM RGB-D calibrations are used.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def level(self, lvl: int) -> "Intrinsics":
        """Intrinsics of pyramid level `lvl` (each level halves resolution),
        rescaled about pixel centers: cx_l = (cx + 0.5) * s - 0.5."""
        if lvl == 0:
            return self
        s = 0.5**lvl
        return Intrinsics(
            fx=self.fx * s,
            fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5,
            cy=(self.cy + 0.5) * s - 0.5,
            width=self.width >> lvl,
            height=self.height >> lvl,
        )


# TUM RGB-D freiburg1 / freiburg3 calibrations (published values).
TUM_FR1 = Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
TUM_FR3 = Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)


def project(intr: Intrinsics, p_cam: torch.Tensor):
    """Camera-frame points (..., 3) -> (u, v, z); callers mask on z and bounds."""
    z = p_cam[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    u = intr.fx * p_cam[..., 0] / zsafe + intr.cx
    v = intr.fy * p_cam[..., 1] / zsafe + intr.cy
    return u, v, z


def nearest_pixel(intr: Intrinsics, u: torch.Tensor, v: torch.Tensor):
    """Nearest pixel of projections (u, v), rounding half to even: (whether
    it lies in the image, its flat index clamped into the image, i64)."""
    ui, vi = torch.round(u), torch.round(v)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    pix = (torch.nan_to_num(vi).clamp(0, intr.height - 1).long() * intr.width
           + torch.nan_to_num(ui).clamp(0, intr.width - 1).long())
    return in_img, pix


def _pixel_grid(h: int, w: int, dtype, device):
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return vv, uu


def backproject(intr: Intrinsics, depth: torch.Tensor) -> torch.Tensor:
    """Depth map (H, W) -> camera-frame vertex map (H, W, 3); 0 depth -> 0."""
    h, w = depth.shape
    vv, uu = _pixel_grid(h, w, depth.dtype, depth.device)
    x = (uu - intr.cx) / intr.fx * depth
    y = (vv - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def ray_directions(intr: Intrinsics, device, dtype=torch.float32) -> torch.Tensor:
    """Unit-z ray directions (H, W, 3) in the camera frame: (x/z, y/z, 1)."""
    vv, uu = _pixel_grid(intr.height, intr.width, dtype, device)
    x = (uu - intr.cx) / intr.fx
    y = (vv - intr.cy) / intr.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)
