"""Frame preprocessing: bilateral filter, vertex/normal maps, pyramids.

Port of ``ops/preprocess.py``.  Level 0 of the pyramid (clamp, bilateral,
vertex and normal maps) runs as one CUDA kernel, K1
(``ops/kernels/preprocess.py``), for a CUDA tensor and as the plain code
below for a CPU tensor; coarser levels are plain, as in the reference.
``PreprocessConfig.use_pallas`` is carried for parity and not read.

Invalid depth is encoded as 0 (TUM convention); every op propagates it.
"""

from __future__ import annotations

import torch

from reference.config import PreprocessConfig
from reference.geometry.camera import Intrinsics, backproject
from reference.ops.common import interior
from reference.ops.kernels import preprocess as k1


def clamp_depth(depth: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Zero out depth outside [depth_min, depth_max] (0 = invalid)."""
    valid = (depth >= cfg.depth_min) & (depth <= cfg.depth_max)
    return torch.where(valid, depth, torch.zeros_like(depth))


def bilateral_filter(depth: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window.

    Weights: spatial Gaussian x depth-difference Gaussian; invalid (0)
    neighbours contribute nothing and an invalid center stays invalid.
    """
    r = cfg.bilateral_radius
    inv2ss = 0.5 / (cfg.bilateral_sigma_space**2)
    inv2sd = 0.5 / (cfg.bilateral_sigma_depth**2)
    h, w = depth.shape
    valid_c = depth > 0.0
    vv = torch.arange(h, device=depth.device)[:, None]
    uu = torch.arange(w, device=depth.device)[None, :]
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = torch.roll(depth, shifts=(dy, dx), dims=(0, 1))
            inb = (vv - dy >= 0) & (vv - dy < h) & (uu - dx >= 0) & (uu - dx < w)
            valid = (shifted > 0.0) & inb & valid_c
            wgt = torch.exp(
                -(dy * dy + dx * dx) * inv2ss - (shifted - depth) ** 2 * inv2sd
            )
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            acc = acc + wgt * shifted
            wacc = wacc + wgt
    out = torch.where(
        wacc > 1e-8, acc / torch.clamp(wacc, min=1e-8), torch.zeros_like(acc)
    )
    return torch.where(valid_c, out, torch.zeros_like(out))


def pyr_down_depth(depth: torch.Tensor) -> torch.Tensor:
    """Halve resolution, averaging only valid pixels in each 2x2 block."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0.0).to(depth.dtype)
    num = torch.sum(d * valid, dim=(1, 3))
    den = torch.sum(valid, dim=(1, 3))
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.zeros_like(num))


def pyr_down_intensity(img: torch.Tensor) -> torch.Tensor:
    """Plain 2x2 mean for intensity images."""
    h, w = img.shape
    d = img[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    return torch.mean(d, dim=(1, 3))


def compute_normals(vmap: torch.Tensor):
    """Normal map from central differences of the vertex map.

    Returns (nmap, valid); normals face the camera (-z half-space).
    """
    valid_v = vmap[..., 2] > 0.0
    dx = torch.roll(vmap, -1, dims=1) - torch.roll(vmap, 1, dims=1)
    dy = torch.roll(vmap, -1, dims=0) - torch.roll(vmap, 1, dims=0)
    vx = torch.roll(valid_v, -1, dims=1) & torch.roll(valid_v, 1, dims=1)
    vy = torch.roll(valid_v, -1, dims=0) & torch.roll(valid_v, 1, dims=0)
    n = torch.linalg.cross(dx, dy)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    n = torch.where(n[..., 2:3] > 0.0, -n, n)
    # Border pixels use wrapped neighbours: invalid.
    valid = (valid_v & vx & vy & (norm[..., 0] > 1e-12)
             & interior(*valid_v.shape, valid_v.device))
    n = torch.where(valid[..., None], n, torch.zeros_like(n))
    return n, valid


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0,1] -> luma (H, W)."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def build_frame_pyramid(
    depth: torch.Tensor,
    intr: Intrinsics,
    cfg: PreprocessConfig,
    levels: int,
    intensity: torch.Tensor | None = None,
):
    """Clamp -> bilateral -> per-level vertex/normal maps (level 0 by K1).

    Returns a list over levels (fine -> coarse) of dicts with keys
    'depth', 'vmap', 'nmap', 'valid', and 'intensity' when given.
    """
    d, vmap, nmap, valid = k1.fused_preprocess(depth, intr, cfg)
    i = intensity
    out = []
    for lvl in range(levels):
        if lvl > 0:
            vmap = backproject(intr.level(lvl), d)
            nmap, nvalid = compute_normals(vmap)
            valid = (d > 0.0) & nvalid
        entry = {"depth": d, "vmap": vmap, "nmap": nmap, "valid": valid}
        if i is not None:
            entry["intensity"] = i
        out.append(entry)
        if lvl + 1 < levels:
            d = pyr_down_depth(d)
            if i is not None:
                i = pyr_down_intensity(i)
    return out
