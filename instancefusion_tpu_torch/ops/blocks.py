"""Sparse voxel-block TSDF map, main-path subset (port of ``ops/blocks.py``).

A dense block directory ``i32[Nb, Nb, Nb]`` maps block coordinates to
payload slots; payload rows hold a block's voxels (``f32[C, B^3]`` sdf and
weight, packed ``[r | g | b]`` color ``f32[C, 3 B^3]``).  Unobserved voxels
keep the out-of-band sdf sentinel ``UNOBSERVED``.  New blocks get slots by
prefix sum, in list form (``discover_allocate``), and each frame's work is
one compacted list of in-frustum slots (``frustum_slots``) that feeds both
integration (kernel K4) and splat prediction (kernel K5).

Everything stays on the device with static shapes.  Where the reference
scatters with ``mode="drop"``, this module scatters into one spill element
past the end and slices it off; no boolean-mask indexing, ``nonzero`` or
host read happens on the per-frame path.  Integration updates the map's
payload tensors in place (the map passed in is the map returned).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instancefusion_tpu_torch.config import TsdfConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics, ray_directions
from instancefusion_tpu_torch.geometry.se3 import se3_inverse, transform_points
from instancefusion_tpu_torch.ops.common import decimate, interior
from instancefusion_tpu_torch.ops.kernels import raycast as splat_kernels
from instancefusion_tpu_torch.ops.kernels import tsdf as tsdf_kernels
from instancefusion_tpu_torch.ops.raycast import RaycastMaps

# Unobserved-voxel SDF sentinel (stored sdf is in [-1, 1] once fused).
UNOBSERVED = 2.0
# Payload slots never allocated (the reference's pad target for its group
# kernels); kept so both packages fill the table identically.
RESERVED_SLOTS = 8


class BlockMap(NamedTuple):
    directory: torch.Tensor  # i32[Nb,Nb,Nb] block coord -> slot, -1 = empty
    block_coords: torch.Tensor  # i32[C,3] slot -> block coord (-1 = free)
    n_active: torch.Tensor  # () i32 number of live slots
    overflow: torch.Tensor  # () i32 blocks dropped for lack of capacity
    sdf: torch.Tensor  # f32[C, B^3] normalized to [-1, 1]
    weight: torch.Tensor  # f32[C, B^3]
    color: torch.Tensor  # f32[C, 3*B^3] packed [r | g | b], or [C, 0]


def num_blocks_per_axis(cfg: TsdfConfig) -> int:
    if cfg.grid_size % cfg.block_size:
        raise ValueError("grid_size must be a multiple of block_size")
    return cfg.grid_size // cfg.block_size


def allocate(cfg: TsdfConfig, device, with_color: bool = True) -> BlockMap:
    nb = num_blocks_per_axis(cfg)
    c = cfg.table_capacity
    b3 = cfg.block_size**3
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return BlockMap(
        directory=torch.full((nb, nb, nb), -1, **i32),
        block_coords=torch.full((c, 3), -1, **i32),
        n_active=torch.zeros((), **i32),
        overflow=torch.zeros((), **i32),
        sdf=torch.full((c, b3), UNOBSERVED, **f32),
        weight=torch.zeros((c, b3), **f32),
        color=torch.zeros((c, 3 * b3 if with_color else 0), **f32),
    )


def pack_color(c3: torch.Tensor) -> torch.Tensor:
    """Interleaved (..., B^3, 3) color -> packed (..., 3*B^3) rows."""
    return torch.cat([c3[..., c] for c in range(3)], dim=-1)


def unpack_color(packed: torch.Tensor) -> torch.Tensor:
    """Packed (..., 3*B^3) color rows -> interleaved (..., B^3, 3)."""
    b3 = packed.shape[-1] // 3
    return torch.stack([packed[..., c * b3:(c + 1) * b3] for c in range(3)], dim=-1)


def _set_with_spill(dst: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``dst.at[idx].set(values, mode="drop")`` along dim 0, for indices in
    [0, len(dst)]: index len(dst) lands in a spill row that is cut off."""
    spill = torch.empty((1,) + dst.shape[1:], dtype=dst.dtype, device=dst.device)
    ext = torch.cat([dst, spill])
    ext[idx.long()] = values
    return ext[:-1]


def discover_allocate(
    bm: BlockMap,
    depth: torch.Tensor,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    cfg: TsdfConfig,
    samples: int = 3,
    stride: int = 4,
    alloc_cap: int = 4096,
) -> BlockMap:
    """Allocate this frame's new band blocks by list, not by directory scan.

    Samples the measurement band of every `stride`-th pixel at `samples`
    depths, sorts and dedups the block ids, keeps the largest `alloc_cap`
    distinct ones (``topk``, descending like ``lax.top_k``), drops those
    already allocated and gives the rest consecutive slots.
    """
    nb = num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    c = cfg.table_capacity
    rays = decimate(ray_directions(intr, depth.device), stride)
    depth = decimate(depth, stride)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    dirs_w = rays.reshape(-1, 3) @ R.T
    d = depth.reshape(-1)
    valid = d > 0.0
    band = cfg.trunc + cfg.voxel_size
    offs = torch.linspace(-band, band, samples, device=depth.device)
    bsz = cfg.block_size * cfg.voxel_size

    ids = []
    for i in range(samples):
        p = o[None, :] + dirs_w * (d + offs[i])[:, None]
        g = torch.stack(
            [torch.floor((p[:, a] - cfg.origin[a]) / bsz) for a in range(3)], -1
        ).to(torch.int32)
        inb = torch.all((g >= 0) & (g < nb), dim=-1) & valid
        flat = (g[:, 0] * nb + g[:, 1]) * nb + g[:, 2]
        ids.append(torch.where(inb, flat, torch.full_like(flat, -1)))
    srt, _ = torch.sort(torch.cat(ids))
    prev = torch.cat([torch.full((1,), -2, dtype=srt.dtype, device=srt.device), srt[:-1]])
    first = (srt >= 0) & (srt != prev)
    alloc_cap = min(alloc_cap, srt.shape[0])
    top, _ = torch.topk(torch.where(first, srt, torch.full_like(srt, -1)), alloc_cap)
    have = bm.directory.reshape(-1)[torch.clamp(top, min=0).long()] >= 0
    uniq = (top >= 0) & ~have
    order = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = bm.n_active + order
    fits = uniq & (new_slot < c - RESERVED_SLOTS)
    n_new = torch.sum(fits, dtype=torch.int32)
    n_drop = torch.sum(uniq, dtype=torch.int32) - n_new

    directory = _set_with_spill(
        bm.directory.reshape(-1), torch.where(fits, top, torch.full_like(top, nb3)),
        new_slot,
    )
    coords = torch.stack([top // (nb * nb), (top // nb) % nb, top % nb], -1)
    block_coords = _set_with_spill(
        bm.block_coords, torch.where(fits, new_slot, torch.full_like(new_slot, c)),
        coords.to(torch.int32),
    )
    return bm._replace(
        directory=directory.reshape(bm.directory.shape),
        block_coords=block_coords,
        n_active=bm.n_active + n_new,
        overflow=bm.overflow + n_drop,
    )


def compact_mask_indices(mask: torch.Tensor, k: int, fill: int = 0):
    """Indices of set bits of `mask` (ascending), compacted to length k.

    Prefix sum + bounded scatter.  Returns (idx i32[k], valid bool[k]);
    set bits beyond k are dropped.
    """
    n = mask.shape[0]
    order = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.where(mask & (order < k), order, torch.full_like(order, k))
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    idx = torch.full((k + 1,), fill, dtype=torch.int32, device=mask.device)
    idx = idx.scatter(0, pos.long(), src)[:k]
    count = torch.clamp(order[-1] + 1, max=k)
    return idx, torch.arange(k, device=mask.device) < count


def touched_blocks_mask(depth: torch.Tensor, T_wc: torch.Tensor, intr: Intrinsics,
                        cfg: TsdfConfig, samples: int = 5, stride: int = 1) -> torch.Tensor:
    """Blocks intersected by this frame's truncation band: bool[Nb^3].

    Samples every `stride`-th pixel's ray at `samples` depths spanning
    [-trunc-voxel, +trunc+voxel] around the measurement and marks the
    containing blocks, by a scatter of ones (out-of-grid samples land in a
    spill element that is cut off).
    """
    nb = num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    rays = decimate(ray_directions(intr, depth.device), stride)
    depth = decimate(depth, stride)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    dirs_w = rays.reshape(-1, 3) @ R.T
    d = depth.reshape(-1)
    valid = d > 0.0
    band = cfg.trunc + cfg.voxel_size
    offs = torch.linspace(-band, band, samples, device=depth.device)
    bsz = cfg.block_size * cfg.voxel_size
    flats = []
    for i in range(samples):
        p = o[None, :] + dirs_w * (d + offs[i])[:, None]
        g = torch.stack(
            [torch.floor((p[:, a] - cfg.origin[a]) / bsz) for a in range(3)], -1
        ).to(torch.int32)
        inb = torch.all((g >= 0) & (g < nb), dim=-1) & valid
        flat = (g[:, 0] * nb + g[:, 1]) * nb + g[:, 2]
        flats.append(torch.where(inb, flat, torch.full_like(flat, nb3)))
    flat = torch.cat(flats).long()
    mask = torch.zeros(nb3 + 1, dtype=torch.bool, device=depth.device)
    mask.scatter_(0, flat, torch.ones_like(flat, dtype=torch.bool))
    return mask[:nb3]


def compact_touched_slots(bm: BlockMap, touched: torch.Tensor, cfg: TsdfConfig, k: int):
    """Static-size list of the payload slots of touched, allocated blocks.

    Returns (slots i32[k], valid bool[k]); touched blocks beyond k, and
    touched blocks without a slot, are skipped (invalid entries hold 0).
    """
    idx, tvalid = compact_mask_indices(touched, k)
    slots = bm.directory.reshape(-1)[idx.long()]
    valid = tvalid & (slots >= 0)
    return torch.where(valid, slots, torch.zeros_like(slots)), valid


def frustum_mask(bm: BlockMap, T_wc, intr: Intrinsics, cfg: TsdfConfig,
                 near: float, far: float) -> torch.Tensor:
    """Allocated blocks whose center is inside the view frustum: bool[C]."""
    c = bm.block_coords.shape[0]
    bsz = cfg.block_size * cfg.voxel_size
    slot_ids = torch.arange(c, dtype=torch.int32, device=T_wc.device)
    allocated = (slot_ids < bm.n_active) & (bm.block_coords[:, 0] >= 0)
    half = (bm.block_coords.float() + 0.5) * bsz
    centers = torch.stack([half[:, a] + cfg.origin[a] for a in range(3)], -1)
    p_c = transform_points(se3_inverse(T_wc), centers)
    z = p_c[:, 2]
    zs = torch.clamp(z, min=1e-3)
    u = intr.fx * p_c[:, 0] / zs + intr.cx
    v = intr.fy * p_c[:, 1] / zs + intr.cy
    m = intr.fx * bsz / zs
    return (
        allocated & (z > near - bsz) & (z < far)
        & (u > -m) & (u < intr.width - 1 + m)
        & (v > -m) & (v < intr.height - 1 + m)
    )


def frustum_slots(bm: BlockMap, T_wc, intr: Intrinsics, cfg: TsdfConfig,
                  near: float, far: float, k: int):
    """Compacted list of allocated in-frustum payload slots: (i32[k], bool[k])."""
    return compact_mask_indices(frustum_mask(bm, T_wc, intr, cfg, near, far), k)


def integrate_slots(
    bm: BlockMap,
    slots: torch.Tensor,  # i32[K] payload rows to update
    valid: torch.Tensor,  # bool[K]
    depth: torch.Tensor,
    color: torch.Tensor | None,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    cfg: TsdfConfig,
    color_gain: float = 1.0,
) -> BlockMap:
    """Fuse one frame into the listed blocks, in place (kernel K4).

    ``color`` None (or a map without color) fuses depth only.
    """
    frame_color = color if (color is not None and bm.color.numel()) else None
    tsdf_kernels.integrate(
        bm.block_coords, bm.sdf, bm.weight, bm.color, slots, valid,
        depth.contiguous(), None if frame_color is None else frame_color.contiguous(),
        T_wc, intr, cfg, color_gain,
    )
    return bm


def _image_space_normals(p_hit, found, dirs_w):
    """World normals from image-space central differences of hit points,
    flipped to face the camera; borders (wrapped neighbours) invalid."""
    dx = torch.roll(p_hit, -1, 1) - torch.roll(p_hit, 1, 1)
    dy = torch.roll(p_hit, -1, 0) - torch.roll(p_hit, 1, 0)
    vx = torch.roll(found, -1, 1) & torch.roll(found, 1, 1)
    vy = torch.roll(found, -1, 0) & torch.roll(found, 1, 0)
    n = torch.linalg.cross(dx, dy)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * dirs_w, dim=-1, keepdim=True) > 0.0
    n = torch.where(flip, -n, n)
    valid = found & vx & vy & (norm[..., 0] > 1e-12) & interior(*found.shape, found.device)
    return n, valid


def raycast_splat(
    bm: BlockMap,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    slots: torch.Tensor,
    slot_valid: torch.Tensor,
    with_color: bool = True,
    depth_prior: torch.Tensor | None = None,
    rmax: int = 8,
) -> RaycastMaps:
    """Predicted maps by splatting the listed blocks (kernel K5), then
    vertex and normal maps by image math."""
    imgs = splat_kernels.splat_depth(
        slots, slot_valid, bm.block_coords, bm.sdf, bm.weight, bm.color,
        T_wc, intr, tsdf_cfg, with_color=with_color,
        depth_prior=depth_prior, rmax=rmax,
    )
    rays_c = ray_directions(intr, T_wc.device)
    dirs_z = (rays_c.reshape(-1, 3) @ T_wc[:3, :3].T).reshape(rays_c.shape)
    p_hit = T_wc[:3, 3] + imgs.depth[..., None] * dirs_z
    dirs_unit = dirs_z / torch.clamp(
        torch.linalg.norm(dirs_z, dim=-1, keepdim=True), min=1e-12
    )
    normal_w, nvalid = _image_space_normals(p_hit, imgs.valid, dirs_unit)
    valid = imgs.valid & nvalid
    zero3 = torch.zeros_like(p_hit)
    return RaycastMaps(
        vertex_w=torch.where(valid[..., None], p_hit, zero3),
        normal_w=torch.where(valid[..., None], normal_w, zero3),
        depth=torch.where(valid, imgs.depth, torch.zeros_like(imgs.depth)),
        color=torch.where(valid[..., None], imgs.color, zero3),
        valid=valid,
    )
