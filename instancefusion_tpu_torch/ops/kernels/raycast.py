"""Splat-raycast kernel K5 (``csrc/raycast.cu``) and its plain version.

The listed blocks are rasterized into accumulator planes (num, dens, denr
and, with color, r, g, b): each near-surface voxel votes for the surface
depth through a separable tent footprint, softmin-composited so nearer
surfaces win (see ``csrc/raycast.cu``).  ``finish_splat_images`` turns the
planes into a depth/validity/color prediction.  CUDA tensors launch the
kernel; CPU tensors run ``splat_planes_ref``.  ``splat_planes.launches``
counts kernel launches, ``splat_planes.launches_color`` those with color:
eager calls and CUDA-graph captures, not a graph's replays.

The kernel sums with no float atomics: a first pass writes each listed
block's votes, in voxel order, and the box of pixels their taps reach
(``footprint_boxes``); a second pass gives each 16x16 screen tile
(``TILE``) one CUDA block that walks the blocks whose box meets it in list
order (``tile_counts``), so a run repeats bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.geometry.se3 import cam_row, se3_inverse
from instancefusion_tpu_torch.ops.kernels import _build
from instancefusion_tpu_torch.ops.kernels.tsdf import voxel_centers

# Softmin sharpness (1/m) and reference depth (m) of the compositing weight
# exp(_LAM (_ZREF - d)); vote mass a pixel needs to count as a surface hit.
_LAM = 20.0
_ZREF = 2.0
_DEN_TAU = 0.05
# Tent radius (px) of a block at depth z: clip(_TENT * fx * voxel / z, 1, rmax).
_TENT = 0.7
# Edge (px) of the kernel's screen tiles: one CUDA block per tile.
TILE = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_splat": [_P, _P, _I] + [_P] * 5 + [_I] * 4 + [_F] * 11 + [_P] * 4,
}


def _lib():
    return _build.load("raycast", _SIGNATURES)


class SplatImages(NamedTuple):
    depth: torch.Tensor  # f32[H, W] composited z-depth (0 where invalid)
    valid: torch.Tensor  # bool[H, W]
    color: torch.Tensor  # f32[H, W, 3]


def _vote_terms(coords, sdf, weight, color, T_cw, intr: Intrinsics, cfg,
                with_color: bool):
    """Per-voxel vote quantities (u, v, w, sm, d_abs, colors), each (K, B^3)."""
    p_w = voxel_centers(coords, cfg)
    x, y, z = (cam_row(p_w, T_cw, i) for i in range(3))
    vis = z > 0.05
    zs = torch.where(vis, z, torch.ones_like(z))
    u = intr.fx * x / zs + intr.cx
    v = intr.fy * y / zs + intr.cy
    w = torch.clamp(1.0 - torch.abs(sdf), min=0.0)
    conf = torch.clamp(weight * 0.25, max=1.0)
    w = w * w * conf * vis.float()
    d_abs = torch.clamp(z + sdf * cfg.trunc, 0.05, 8.0)
    sm = torch.exp(_LAM * (_ZREF - d_abs))
    b3 = sdf.shape[1]
    cols = [color[:, c * b3:(c + 1) * b3] for c in range(3)] if with_color else []
    return u, v, w, sm, d_abs, cols


def _tent_k(intr: Intrinsics, cfg) -> float:
    return _TENT * intr.fx * cfg.voxel_size


def _block_terms(coords, T_cw, intr: Intrinsics, cfg, rmax: int):
    """Per block (straddles-the-camera-plane, tent radius) from its corners'
    depths and its center depth."""
    bsz = cfg.block_size * cfg.voxel_size

    def world(offsets):  # block-grid offsets (..., 3) -> world points
        pts = (coords[:, None, :].float() + offsets) * bsz
        return torch.stack([pts[..., i] + cfg.origin[i] for i in range(3)], -1)

    bits = torch.arange(8, device=coords.device)
    corner = world(torch.stack([bits // 4, (bits // 2) % 2, bits % 2], -1).float())
    zc8 = cam_row(corner, T_cw, 2)
    zc = cam_row(world(torch.full((1, 3), 0.5, device=coords.device)), T_cw, 2)[:, 0]
    # A number over a tensor is its reciprocal times the number in PyTorch.
    r_t = torch.clamp(torch.reciprocal(torch.clamp(zc, min=0.3)) * _tent_k(intr, cfg),
                      1.0, float(rmax))
    return torch.amin(zc8, dim=1) <= 1e-3, r_t


def footprint_boxes(slots, slot_valid, block_coords, sdf, weight, T_wc,
                    intr: Intrinsics, cfg, rmax: int):
    """K5's box of each listed block, as its first pass computes it: the box
    of the rounded pixel centers of the block's votes, widened by the tap
    radius min(ceil(r_t) + 1, rmax) and clipped to the image.  Returns (box
    i64[K, 4] as x0, y0, x1, y1 inclusive, kept bool[K]: valid and not
    straddling the camera plane); a block with no vote on the image has
    x0 > x1."""
    rows = torch.where(slot_valid, slots, torch.zeros_like(slots)).long()
    coords = block_coords[rows]
    T_cw = se3_inverse(T_wc)
    straddle, r_t = _block_terms(coords, T_cw, intr, cfg, rmax)
    kept = slot_valid & ~straddle
    u, v, w, *_ = _vote_terms(coords, sdf[rows], weight[rows], None, T_cw, intr, cfg,
                              False)
    vote = (w > 0.0) & kept[:, None]
    reach = torch.clamp(torch.ceil(r_t) + 1.0, max=float(rmax))
    inf = torch.full_like(u, float("inf"))
    ui, vi = torch.round(u), torch.round(v)
    lo = torch.stack([torch.where(vote, ui, inf).amin(1), torch.where(vote, vi, inf).amin(1)],
                     -1) - reach[:, None]
    hi = torch.stack([torch.where(vote, ui, -inf).amax(1),
                      torch.where(vote, vi, -inf).amax(1)], -1) + reach[:, None]
    lo = torch.clamp(lo, min=0.0)
    hi = torch.stack([torch.clamp(hi[:, 0], max=intr.width - 1.0),
                      torch.clamp(hi[:, 1], max=intr.height - 1.0)], -1)
    box = torch.cat([lo, hi], 1)
    empty = ~vote.any(1) | (box[:, 0] > box[:, 2]) | (box[:, 1] > box[:, 3])
    box = torch.where(empty[:, None], torch.tensor([1.0, 1.0, 0.0, 0.0], device=box.device),
                      box)
    return box.long(), kept


def tile_counts(box, intr: Intrinsics) -> torch.Tensor:
    """How many of the boxes (``footprint_boxes``) meet each ``TILE`` x
    ``TILE`` screen tile: i64[tiles_y, tiles_x], the blocks the kernel's
    second pass walks there."""
    ty = torch.arange(0, intr.height, TILE, device=box.device)
    tx = torch.arange(0, intr.width, TILE, device=box.device)
    some = ((box[:, 0] <= box[:, 2]) & (box[:, 1] <= box[:, 3]))[:, None]
    meets_y = (box[:, 1, None] <= ty + TILE - 1) & (box[:, 3, None] >= ty) & some
    meets_x = (box[:, 0, None] <= tx + TILE - 1) & (box[:, 2, None] >= tx)
    return (meets_y[:, :, None] & meets_x[:, None, :]).sum(0)


def splat_taps_ref(slots, slot_valid, block_coords, sdf, weight, color,
                   T_wc, intr: Intrinsics, cfg, with_color: bool, rmax: int):
    """The scatter-adds of the plain splat, one tent row at a time.

    Yields (flat pixel index i64[m], contributions f32[C, m]) per row
    offset dy; summed into planes f32[C, H*W] they give the splat.
    Blocks straddling the camera plane are dropped whole.
    """
    h, w_img = intr.height, intr.width
    rows = torch.where(slot_valid, slots, torch.zeros_like(slots)).long()
    coords = block_coords[rows]
    T_cw = se3_inverse(T_wc)
    straddle, r_t = _block_terms(coords, T_cw, intr, cfg, rmax)
    keep = slot_valid & ~straddle
    u, v, w, sm, d_abs, cols = _vote_terms(
        coords, sdf[rows], weight[rows], color[rows] if with_color else None,
        T_cw, intr, cfg, with_color,
    )
    w = w * keep[:, None].float()
    inv_r = (1.0 / r_t)[:, None].expand_as(u)
    wsm = w * sm
    chans = [wsm * d_abs, wsm, w] + [wsm * c for c in cols]
    # Only voxels with a non-zero vote add anything.
    live = w > 0.0
    u, v, inv_r = u[live], v[live], inv_r[live]
    vals = torch.stack([c[live] for c in chans])  # (C, n)
    ui, vi = torch.round(u), torch.round(v)
    offs = torch.arange(-rmax, rmax + 1, device=sdf.device, dtype=torch.float32)
    px = ui[:, None] + offs[None, :]  # (n, 2 rmax + 1)
    tu = torch.clamp(1.0 - torch.abs(u[:, None] - px) * inv_r[:, None], min=0.0)
    for dy in range(-rmax, rmax + 1):
        py = vi + dy
        tv = torch.clamp(1.0 - torch.abs(v - py) * inv_r, min=0.0)
        t2 = tv[:, None] * tu
        ok = (py[:, None] >= 0) & (py[:, None] < h) & (px >= 0) & (px < w_img) & (t2 > 0.0)
        yield (py[:, None] * w_img + px)[ok].long(), (vals[:, :, None] * t2[None])[:, ok]


def splat_planes_ref(slots, slot_valid, block_coords, sdf, weight, color,
                     T_wc, intr: Intrinsics, cfg, with_color: bool, rmax: int):
    """Plain K5: the reference's ``splat_depth_ref`` scatter-add (raw planes).

    Returns f32[6 or 3, H, W]: num, dens, denr (+ r, g, b with color).
    """
    nch = 6 if with_color else 3
    acc = torch.zeros((nch, intr.height * intr.width), dtype=torch.float32,
                      device=sdf.device)
    for flat, contrib in splat_taps_ref(slots, slot_valid, block_coords, sdf,
                                        weight, color, T_wc, intr, cfg,
                                        with_color, rmax):
        acc.index_add_(1, flat, contrib)
    return acc.reshape(nch, intr.height, intr.width)


def finish_splat_images(planes, intr: Intrinsics, cfg, with_color: bool,
                        depth_prior: torch.Tensor | None = None) -> SplatImages:
    """Normalize summed splat planes into composited images.

    Valid where the raw vote mass exceeds _DEN_TAU and the depth is beyond
    5 cm; with ``depth_prior`` also only within 1.5 trunc of the prior.
    """
    num, dens, denr = planes[0], planes[1], planes[2]
    valid = (denr > _DEN_TAU) & (dens > 1e-30)
    dsafe = torch.clamp(dens, min=1e-30)
    zero = torch.zeros_like(num)
    depth = torch.where(valid, num / dsafe, zero)
    valid = valid & (depth > 0.05)
    if depth_prior is not None:
        valid = valid & (depth_prior > 0.0) & (
            torch.abs(depth - depth_prior) <= 1.5 * cfg.trunc
        )
    depth = torch.where(valid, depth, zero)
    if with_color:
        col = torch.stack([planes[3 + c] / dsafe for c in range(3)], dim=-1)
        col = torch.where(valid[..., None], col, torch.zeros_like(col))
    else:
        col = torch.zeros((intr.height, intr.width, 3), dtype=num.dtype, device=num.device)
    return SplatImages(depth=depth, valid=valid, color=col)


def splat_depth_ref(slots, slot_valid, block_coords, sdf, weight, color, T_wc,
                    intr: Intrinsics, cfg, with_color: bool = True,
                    depth_prior=None, rmax: int = 8) -> SplatImages:
    """Plain splat prediction: ``splat_planes_ref`` then the finish step."""
    with_color = with_color and color.numel() > 0
    planes = splat_planes_ref(slots, slot_valid, block_coords, sdf, weight,
                              color, T_wc, intr, cfg, with_color, rmax)
    return finish_splat_images(planes, intr, cfg, with_color, depth_prior)


def splat_planes(slots, slot_valid, block_coords, sdf, weight, color, T_wc,
                 intr: Intrinsics, cfg, with_color: bool, rmax: int):
    """Splat the listed blocks into accumulator planes f32[6 or 3, H, W].

    slots i32[K] with slot_valid bool[K]; block_coords i32[C, 3]; sdf,
    weight f32[C, B^3]; color f32[C, 3 B^3] packed (read only with color).
    """
    if sdf.device.type == "cpu":
        return splat_planes_ref(slots, slot_valid, block_coords, sdf, weight,
                                color, T_wc, intr, cfg, with_color, rmax)
    dev = sdf.device
    tensors = dict(slots=slots, slot_valid=slot_valid, block_coords=block_coords,
                   sdf=sdf, weight=weight)
    if with_color:
        tensors["color"] = color
    _build.check_tensors(tensors, dev)
    if slots.dtype != torch.int32 or block_coords.dtype != torch.int32:
        raise ValueError("slots and block_coords must be int32")
    nch = 6 if with_color else 3
    k, b3 = slots.shape[0], cfg.block_size**3
    T_cw = se3_inverse(T_wc).contiguous()
    votes = torch.empty((k, (2 + nch) * b3), dtype=torch.float32, device=dev)
    meta = torch.empty((k, 8), dtype=torch.int32, device=dev)
    acc = torch.empty((nch, intr.height, intr.width), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _lib().ifl_splat(
        p(slots), p(slot_valid), k, p(block_coords), p(sdf),
        p(weight), p(color) if with_color else None, p(T_cw),
        intr.width, intr.height, cfg.block_size, rmax,
        intr.fx, intr.fy, intr.cx, intr.cy, cfg.voxel_size, cfg.trunc,
        *cfg.origin, cfg.block_size * cfg.voxel_size, _tent_k(intr, cfg),
        p(votes), p(meta), p(acc), _build.stream_handle(),
    )
    _build.check(err, "splat_planes")
    splat_planes.launches += 1
    splat_planes.launches_color += int(with_color)
    return acc


splat_planes.launches = 0
splat_planes.launches_color = 0


def splat_depth(slots, slot_valid, block_coords, sdf, weight, color, T_wc,
                intr: Intrinsics, cfg, with_color: bool = True,
                depth_prior=None, rmax: int = 8) -> SplatImages:
    """Rasterize the listed blocks into a composited depth/color prediction.

    ``depth_prior`` (the just-fused depth) invalidates votes more than
    1.5 trunc away from it: silhouette bleed of a foreground block's tent.
    """
    with_color = with_color and color.numel() > 0
    planes = splat_planes(slots, slot_valid, block_coords, sdf, weight, color,
                          T_wc, intr, cfg, with_color, rmax)
    return finish_splat_images(planes, intr, cfg, with_color, depth_prior)
