"""Offline views: raycast the map to shaded and instance-colored PNGs (port
of ``utils/render.py``).

The view comes from the marched raycasters (``ops/blocks.raycast`` for a
block map, ``ops/raycast.raycast`` for a dense volume), the labels from
``ops/labels.sample_nearest`` and ``engine/instances.instance_color``.
Shading runs in torch on the map's device; only the uint8 images go to the
host.  PNGs are written by the port's encoder (``datasets/png.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from instancefusion_tpu_torch.datasets import png
from instancefusion_tpu_torch.engine.instances import instance_color
from instancefusion_tpu_torch.ops import blocks as blk
from instancefusion_tpu_torch.ops import labels as lbl
from instancefusion_tpu_torch.ops import raycast as rc

_LIGHT = (0.4, -0.3, -0.85)


def _u8(img: torch.Tensor) -> np.ndarray:
    """[0, 1] floats -> uint8 (x 255, truncated), on the host."""
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()


@torch.no_grad()
def render_view(volume, T_wc, intr, tsdf_cfg, rc_cfg, votes=None):
    """Raycast and shade one view from pose `T_wc`.

    Returns a dict of uint8 images: 'shaded' (H,W,3), 'depth' (H,W),
    'color' (H,W,3), and 'instances' (H,W,3) when `votes` is given.
    """
    is_blocks = hasattr(volume, "directory")
    dev = volume.sdf.device
    if not isinstance(T_wc, torch.Tensor):
        T_wc = torch.tensor(np.asarray(T_wc, np.float32))
    T_wc = T_wc.to(dev, torch.float32)
    caster = blk.raycast if is_blocks else rc.raycast
    maps = caster(volume, T_wc, intr, tsdf_cfg, rc_cfg)

    n, valid = maps.normal_w, maps.valid
    light = torch.tensor(_LIGHT, dtype=torch.float64, device=dev)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(-torch.sum(n.double() * light, dim=-1), 0.0, 1.0)
    shade = (0.25 + 0.75 * lam)[..., None]
    base = maps.color
    has_color = base.numel() > 0 and bool(base.max() > 0)
    lit = (base.double() if has_color else torch.full_like(n, 0.8, dtype=torch.float64)) * shade
    zero = torch.zeros_like(lit)
    out = {
        "shaded": _u8(torch.where(valid[..., None], lit, zero)),
        "depth": _u8(maps.depth / max(rc_cfg.far, 1e-6)),
        "color": _u8(base) if has_color else np.zeros(tuple(n.shape), np.uint8),
    }
    if votes is not None and is_blocks:
        gids = lbl.sample_nearest(votes, volume, maps.vertex_w, maps.valid, tsdf_cfg)
        inst = torch.where((gids >= 0)[..., None], instance_color(gids).double(), lit * 0.5)
        out["instances"] = _u8(torch.where(valid[..., None], inst, zero))
    return out


def save_png(path: str, image: np.ndarray) -> None:
    png.write(path, image)


def render_sequence(volume, poses, intr, tsdf_cfg, rc_cfg, out_dir, votes=None,
                    prefix="view"):
    """Render a pose list to numbered PNGs (offline flythrough)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, T in enumerate(poses):
        imgs = render_view(volume, T, intr, tsdf_cfg, rc_cfg, votes)
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        save_png(p, imgs["shaded"])
        paths.append(p)
    return paths
