"""Sparse voxel-block TSDF map (port of ``ops/blocks.py``).

A dense block directory ``i32[Nb, Nb, Nb]`` maps block coordinates to
payload slots; payload rows hold a block's voxels (``f32[C, B^3]`` sdf and
weight, packed ``[r | g | b]`` color ``f32[C, 3 B^3]``).  Unobserved voxels
keep the out-of-band sdf sentinel ``UNOBSERVED``.

Two update paths, as in the reference:

- splat prediction: new blocks get slots by prefix sum, in list form
  (``discover_allocate``), and each frame's work is one compacted list of
  in-frustum slots (``frustum_slots``) that feeds both integration (kernel
  K4, ``integrate_slots``) and splat prediction (kernel K5);
- the marched raycast: ``integrate`` marks the blocks the frame's
  truncation band touches, allocates them over the directory
  (``allocate_touched``), computes each listed voxel's observation in
  PyTorch (``touched_observations``) and runs the running average in one
  pass (kernel K8); ``raycast`` then marches the rays with empty-space
  skipping over the directory and trilinear samples (``sample_trilinear``,
  ``sample_color_trilinear``, ``sdf_gradient``).

``clean`` culls weak and empty blocks and compacts the slot space.

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
from instancefusion_tpu_torch.config import RaycastConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics, ray_directions
from instancefusion_tpu_torch.geometry.se3 import se3_inverse, transform_points
from instancefusion_tpu_torch.ops import tsdf as dense
from instancefusion_tpu_torch.ops.common import decimate, interior
from instancefusion_tpu_torch.ops.kernels import raycast as splat_kernels
from instancefusion_tpu_torch.ops.kernels import tsdf as tsdf_kernels
from instancefusion_tpu_torch.ops.raycast import RaycastMaps, secant_start, world_rays

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


def band_candidates(depth: torch.Tensor, T_wc: torch.Tensor, intr: Intrinsics,
                    cfg: TsdfConfig, samples: int = 3, stride: int = 4,
                    alloc_cap: int = 4096) -> torch.Tensor:
    """This frame's band blocks as a list: i32[min(alloc_cap, n)] distinct
    flat block ids in descending order, -1 padded.

    Samples the measurement band of every `stride`-th pixel at `samples`
    depths, sorts and dedups the block ids and keeps the largest
    `alloc_cap` distinct ones (``topk``, descending like ``lax.top_k``).
    """
    nb = num_blocks_per_axis(cfg)
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
    return top


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

    Takes the frame's ``band_candidates``, drops those already allocated
    and gives the rest consecutive slots.
    """
    nb = num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    c = cfg.table_capacity
    top = band_candidates(depth, T_wc, intr, cfg, samples, stride, alloc_cap)
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


def allocate_touched(bm: BlockMap, touched: torch.Tensor, cfg: TsdfConfig) -> BlockMap:
    """Give payload slots to touched blocks that have none (prefix sum over
    the directory); blocks beyond capacity are dropped and counted in
    ``overflow``."""
    nb = num_blocks_per_axis(cfg)
    c = cfg.table_capacity
    dir_flat = bm.directory.reshape(-1)
    need = touched & (dir_flat < 0)
    order = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = bm.n_active + order
    fits = need & (new_slot < c - RESERVED_SLOTS)
    n_new = torch.sum(fits, dtype=torch.int32)
    n_drop = torch.sum(need, dtype=torch.int32) - n_new
    idx = torch.arange(nb * nb * nb, dtype=torch.int32, device=dir_flat.device)
    coords = torch.stack([idx // (nb * nb), (idx // nb) % nb, idx % nb], -1)
    block_coords = _set_with_spill(
        bm.block_coords, torch.where(fits, new_slot, torch.full_like(new_slot, c)), coords)
    return bm._replace(
        directory=torch.where(fits, new_slot, dir_flat).reshape(bm.directory.shape),
        block_coords=block_coords,
        n_active=bm.n_active + n_new,
        overflow=bm.overflow + n_drop,
    )


def compact_touched_slots(bm: BlockMap, touched: torch.Tensor, cfg: TsdfConfig, k: int):
    """Static-size list of the payload slots of touched, allocated blocks.

    Returns (slots i32[k], valid bool[k]); touched blocks beyond k, and
    touched blocks without a slot, are skipped (invalid entries hold 0).
    """
    idx, tvalid = compact_mask_indices(touched, k)
    slots = bm.directory.reshape(-1)[idx.long()]
    valid = tvalid & (slots >= 0)
    return torch.where(valid, slots, torch.zeros_like(slots)), valid


def touched_observations(bm: BlockMap, slots, valid, depth, color, T_wc,
                         intr: Intrinsics, cfg: TsdfConfig):
    """Each listed voxel's observation, the reference's projective
    association (its jnp ``integrate_slots``): psi and w_obs f32[K, B^3],
    and the frame's color at each voxel's pixel as packed rows f32[K, 3 B^3]
    (None without color).

    Voxels project with round half to even; a voxel observes where it lies
    in the image in front of the camera, the depth there is positive and
    not more than one truncation band in front of it, and its list entry
    is valid.
    """
    z, pix, seen = tsdf_kernels.project_voxels(bm.block_coords, slots, T_wc, intr, cfg)
    d = depth.reshape(-1)[pix]
    sdf_obs = d - z
    ok = seen & (d > 0.0) & (sdf_obs > -cfg.trunc) & valid[:, None]
    psi = torch.clamp(sdf_obs / cfg.trunc, -1.0, 1.0)
    obs = None
    if color is not None and bm.color.numel():
        obs = pack_color(color.reshape(-1, 3)[pix])
    return psi, ok.float(), obs


def integrate(bm: BlockMap, depth: torch.Tensor, color: torch.Tensor | None,
              T_wc: torch.Tensor, intr: Intrinsics, cfg: TsdfConfig,
              max_touched: int | None = None) -> BlockMap:
    """Fuse one frame: allocate the blocks its truncation band touches and
    update only those (the running average is kernel K8), in place.

    The same arithmetic as the dense ``tsdf.integrate`` on observed voxels,
    over ``max_touched * B^3`` voxels (default ``touched_capacity``) instead
    of the whole grid; touched blocks beyond the list are skipped this
    frame.  ``color`` None (or a map without color) fuses depth only.

    The observations are made in PyTorch and materialized (K x B^3 x 5
    floats) before K8 reads them, as the reference splits the work; the
    splat path's ``integrate_slots`` (K4) does both in one kernel.
    """
    if max_touched is None:
        max_touched = cfg.touched_capacity
    touched = touched_blocks_mask(depth, T_wc, intr, cfg)
    bm = allocate_touched(bm, touched, cfg)
    k = min(max_touched, num_blocks_per_axis(cfg) ** 3)
    slots, valid = compact_touched_slots(bm, touched, cfg, k)
    psi, w_obs, obs = touched_observations(bm, slots, valid, depth, color, T_wc, intr, cfg)
    tsdf_kernels.tsdf_update(bm.sdf, bm.weight, bm.color, slots, valid, psi, w_obs,
                             obs, cfg.max_weight)
    return bm


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


class ListFill:
    """How full the in-frustum slot lists ran, kept on the device until
    read: the most in-frustum rows of one list and the rows dropped past a
    list's length, summed over lists (``compact_mask_indices`` keeps the
    first k).  ``LIST_FILL`` notes every list of the splat path, on one
    card (``frustum_slots``) and on each rank (``shard.fused_step_map``).

    The two counts live in tensors made at the first note on a device and
    then updated in place, so that a CUDA graph captured around a note
    (``engine/step_graph.py``) adds to them at every replay."""

    def __init__(self):
        self.largest = self.dropped = None
        self.length = 0

    def reset(self) -> None:
        """Zero the counts in place."""
        if self.largest is not None:
            self.largest.zero_()
            self.dropped.zero_()
        self.length = 0

    def note(self, mask: torch.Tensor, k: int) -> None:
        n = mask.sum()
        if self.largest is None or self.largest.device != n.device:
            self.largest, self.dropped = torch.zeros_like(n), torch.zeros_like(n)
        torch.maximum(self.largest, n, out=self.largest)
        self.dropped.add_(torch.clamp(n - k, min=0))
        self.length = k

    def read(self) -> dict:
        """{"largest", "dropped", "length"} as ints (one sync)."""
        if self.largest is None:
            return {"largest": 0, "dropped": 0, "length": self.length}
        return {"largest": int(self.largest), "dropped": int(self.dropped),
                "length": self.length}


LIST_FILL = ListFill()


def frustum_slots(bm: BlockMap, T_wc, intr: Intrinsics, cfg: TsdfConfig,
                  near: float, far: float, k: int):
    """Compacted list of allocated in-frustum payload slots: (i32[k], bool[k])."""
    mask = frustum_mask(bm, T_wc, intr, cfg, near, far)
    LIST_FILL.note(mask, k)
    return compact_mask_indices(mask, k)


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
    return maps_from_splat(imgs, T_wc, intr)


def maps_from_splat(imgs, T_wc: torch.Tensor, intr: Intrinsics) -> RaycastMaps:
    """Vertex and normal maps of a splat prediction (``SplatImages``) by
    image math: hit points along the pixel rays, image-space normals."""
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


def _corner_rows(bm: BlockMap, corners: torch.Tensor, cfg: TsdfConfig):
    """Per stencil corner (voxel indices i64[..., 8, 3] inside the grid):
    whether its block is allocated, and its flat voxel index into the
    payload rows (slot * B^3 + voxel; slot 0 where unallocated)."""
    b = cfg.block_size
    nb = num_blocks_per_axis(cfg)
    blk = corners // b
    loc = corners - blk * b
    slot = bm.directory.reshape(-1)[(blk[..., 0] * nb + blk[..., 1]) * nb + blk[..., 2]]
    lflat = (loc[..., 0] * b + loc[..., 1]) * b + loc[..., 2]
    return slot >= 0, torch.clamp(slot, min=0).long() * (b * b * b) + lflat


def sample_trilinear(bm: BlockMap, p_w: torch.Tensor, cfg: TsdfConfig):
    """Trilinear SDF sample at world points (..., 3) across block borders:
    (sdf, valid).

    No weight is gathered: an unallocated or never-fused corner reads as
    the UNOBSERVED sentinel, so valid = stencil in bounds and every corner
    below 1.5.
    """
    inb, corners, tw = dense.stencil(p_w, cfg)
    have, vidx = _corner_rows(bm, corners, cfg)
    s = torch.where(have, bm.sdf.reshape(-1)[vidx], UNOBSERVED)
    val = dense.corner_sum(tw * s)
    return val, inb & (torch.amax(s, dim=-1) < 1.5)


def sample_color_trilinear(bm: BlockMap, p_w: torch.Tensor, cfg: TsdfConfig):
    """Trilinear color sample at world points (..., 3) -> (..., 3); corners
    in unallocated blocks add nothing."""
    _, corners, tw = dense.stencil(p_w, cfg)
    have, vidx = _corner_rows(bm, corners, cfg)
    b3 = cfg.block_size ** 3
    # Packed rows: slot * 3 B^3 + channel * B^3 + voxel.
    base = vidx + (vidx // b3) * (2 * b3)
    chan = torch.arange(3, device=p_w.device) * b3
    c = bm.color.reshape(-1)[base[..., None] + chan]  # (..., 8, 3)
    return dense.corner_sum(((tw * have)[..., None] * c).transpose(-1, -2))


def occupancy_at(bm: BlockMap, p_w: torch.Tensor, cfg: TsdfConfig) -> torch.Tensor:
    """Is the block containing each point allocated?  bool(...)."""
    nb = num_blocks_per_axis(cfg)
    bsz = cfg.block_size * cfg.voxel_size
    g = torch.floor((p_w - dense.vec3(cfg.origin, p_w.device)) / bsz)
    inb = torch.all((g >= 0) & (g < nb), dim=-1)
    gc = torch.nan_to_num(g).clamp(0, nb - 1).long()
    flat = (gc[..., 0] * nb + gc[..., 1]) * nb + gc[..., 2]
    return inb & (bm.directory.reshape(-1)[flat] >= 0)


def sdf_gradient(bm: BlockMap, p_w: torch.Tensor, cfg: TsdfConfig):
    """Central-difference SDF gradient over the block map (surface
    normals): (unit normal (..., 3), valid)."""
    s, v = sample_trilinear(bm, dense.gradient_points(p_w, cfg.voxel_size), cfg)
    return dense.gradient_from_samples(s, v)


def raycast(
    bm: BlockMap,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    cfg: RaycastConfig,
    with_color: bool = True,
    depth_prior: torch.Tensor | None = None,
    screen_space_normals: bool = False,
) -> RaycastMaps:
    """Two-speed ray march with empty-space skipping over the directory.

    Each step checks the directory at the current point: an unallocated
    block is skipped to its exit face (DDA), an allocated one is marched at
    the fine step (``step_scale * trunc``) with a trilinear sample and a
    zero-crossing test; then ``refine_steps`` secant refinements.  The step
    count is fixed: ``int((far - near) / fine) + 1``, or with
    ``depth_prior`` (this frame's fused depth) ``int(2 * band / fine) + 3``
    over the band of 1.5 trunc around the prior, where rays without a prior
    miss.  ``screen_space_normals`` takes normals from image-space
    differences of the hit points instead of the SDF gradient.  Nothing is
    read back to the host.
    """
    dirs_w, ray_norm = world_rays(intr, T_wc)
    origin_w = T_wc[:3, 3]
    dev = T_wc.device
    fine = cfg.step_scale * tsdf_cfg.trunc
    bsz = tsdf_cfg.block_size * tsdf_cfg.voxel_size
    map_origin = dense.vec3(tsdf_cfg.origin, dev)
    max_steps = int((cfg.far - cfg.near) / fine) + 1
    shape = ray_norm.shape
    band = 1.5 * tsdf_cfg.trunc
    if depth_prior is not None:
        has_prior = depth_prior > 0.0
        far = torch.full(shape, cfg.far, device=dev)
        t_start = torch.where(
            has_prior, torch.clamp((depth_prior - band) * ray_norm, min=cfg.near), far)
        t_end = torch.where(has_prior, (depth_prior + band) * ray_norm, far)
        max_steps = int(2.0 * band / fine) + 3
    else:
        t_start = torch.full(shape, cfg.near, device=dev)
        t_end = torch.full(shape, cfg.far, device=dev)

    def point_at(t):
        return origin_w + t[..., None] * dirs_w

    # Boundary-step constants: which face each ray leaves a block by, and
    # the axes it does not move along (never the nearest face).
    step_dir = (dirs_w >= 0.0).float()
    moving = torch.abs(dirs_w) > 1e-9
    safe_dir = torch.where(moving, dirs_w, 1e-9)

    def boundary_step(p):
        """Distance to just past the next block face, at least 0.1 voxel:
        a skip always lands at an occupied block's entry face, never inside
        it."""
        g = (p - map_origin) / bsz
        nxt = (torch.floor(g) + step_dir) * bsz + map_origin
        dt_axis = torch.where(moving, (nxt - p) / safe_dir, torch.inf)
        t_bound = torch.amin(torch.clamp(dt_axis, min=0.0), dim=-1)
        return torch.clamp(t_bound + 0.05 * tsdf_cfg.voxel_size,
                           min=0.1 * tsdf_cfg.voxel_size)

    zeros = torch.zeros(shape, device=dev)
    no = torch.zeros(shape, dtype=torch.bool, device=dev)
    t, prev_sdf, prev_valid = t_start, zeros, no
    t_lo, t_hi, s_lo, s_hi, found = zeros, zeros, zeros, zeros, no
    for _ in range(max_steps):
        p = point_at(t)
        occ = occupancy_at(bm, p, tsdf_cfg)
        s, v = sample_trilinear(bm, p, tsdf_cfg)
        crossing = prev_valid & v & (prev_sdf > 0.0) & (s <= 0.0) & occ & ~found
        t_lo = torch.where(crossing, t - fine, t_lo)
        t_hi = torch.where(crossing, t, t_hi)
        s_lo = torch.where(crossing, prev_sdf, s_lo)
        s_hi = torch.where(crossing, s, s_hi)
        found = found | crossing
        dt = torch.where(found, zeros, torch.where(occ, fine, boundary_step(p)))
        t = torch.minimum(t + dt, t_end)
        prev_sdf, prev_valid = s, v & occ

    t_star = secant_start(t_lo, t_hi, s_lo, s_hi)
    for _ in range(cfg.refine_steps):
        s, v = sample_trilinear(bm, point_at(t_star), tsdf_cfg)
        t_star = torch.clamp(t_star + torch.where(v, s * tsdf_cfg.trunc, zeros),
                             t_lo, t_hi)

    p_hit = point_at(t_star)
    if screen_space_normals:
        normal_w, nvalid = _image_space_normals(p_hit, found, dirs_w)
    else:
        normal_w, nvalid = sdf_gradient(bm, p_hit, tsdf_cfg)
    valid = found & nvalid
    zero3 = torch.zeros_like(p_hit)
    if with_color and bm.color.numel():
        color = torch.where(valid[..., None],
                            sample_color_trilinear(bm, p_hit, tsdf_cfg), zero3)
    else:
        color = zero3
    return RaycastMaps(
        vertex_w=torch.where(valid[..., None], p_hit, zero3),
        normal_w=torch.where(valid[..., None], normal_w, zero3),
        depth=torch.where(valid, t_star / ray_norm, zeros),
        color=color,
        valid=valid,
    )


def clean(bm: BlockMap, cfg: TsdfConfig, min_weight: float = 1.0, votes=None,
          stamp: torch.Tensor | None = None):
    """Cull low-confidence and empty blocks and compact the slot space.

    A live block is allocated, reached ``min_weight`` at some voxel, and
    holds an observed voxel at or below sdf 0.98 (a block with none holds no
    surface).  Live rows move to the front in their old order (a stable
    partition), freed rows take the empty fills (sdf UNOBSERVED, weight 0,
    color 0, coords -1) and the directory is remapped.  Returns (bm, votes),
    or (bm, votes, stamp) when ``stamp`` is given; ``votes`` (label -1,
    count 0) and ``stamp`` (0) are compacted the same way when given.
    """
    c = bm.sdf.shape[0]
    slot_ids = torch.arange(c, dtype=torch.int32, device=bm.sdf.device)
    allocated = slot_ids < bm.n_active
    best_w = torch.amax(bm.weight, dim=1)
    observed = torch.where(bm.weight > 0.0, bm.sdf, UNOBSERVED)
    empty = torch.amin(observed, dim=1) > 0.98
    bm_new, votes_new, stamp_new = _compact(bm, allocated & (best_w >= min_weight) & ~empty,
                                            votes, stamp)
    if stamp is not None:
        return bm_new, votes_new, stamp_new
    return bm_new, votes_new


def _compact(bm: BlockMap, live: torch.Tensor, votes=None, stamp=None):
    """Keep the `live` slots (bool[C]): they move to the front in their old
    order (a stable partition), freed rows take the empty fills (sdf
    UNOBSERVED, weight 0, color 0, coords -1; votes label -1, count 0;
    stamp 0) and the directory is remapped.  Returns (bm, votes, stamp),
    votes and stamp None when not given."""
    c = bm.sdf.shape[0]
    slot_ids = torch.arange(c, dtype=torch.int32, device=bm.sdf.device)
    n_live = torch.sum(live, dtype=torch.int32)
    perm = torch.argsort((~live).to(torch.int32), stable=True)
    order = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1  # old -> new
    keep = slot_ids < n_live

    def take(arr, fill):
        out = arr[perm]
        return torch.where(keep.reshape((c,) + (1,) * (out.dim() - 1)), out,
                           torch.full_like(out, fill))

    dir_flat = bm.directory.reshape(-1)
    src = torch.clamp(dir_flat, 0, c - 1).long()
    dir_new = torch.where((dir_flat >= 0) & live[src], order[src], -1)
    bm_new = BlockMap(
        directory=dir_new.to(torch.int32).reshape(bm.directory.shape),
        block_coords=take(bm.block_coords, -1),
        n_active=n_live,
        overflow=bm.overflow,
        sdf=take(bm.sdf, UNOBSERVED),
        weight=take(bm.weight, 0.0),
        color=take(bm.color, 0.0) if bm.color.numel() else bm.color,
    )
    votes_new = None
    if votes is not None:
        votes_new = type(votes)(label=take(votes.label, -1), count=take(votes.count, 0.0))
    return bm_new, votes_new, None if stamp is None else take(stamp, 0)


def frustum_allocated_mask(bm: BlockMap, T_wc: torch.Tensor, intr: Intrinsics,
                           cfg: TsdfConfig, near: float, far: float) -> torch.Tensor:
    """Allocated blocks whose center is in the view frustum, as bool[Nb^3]
    over the directory (``frustum_mask``'s slots scattered to their block
    ids)."""
    nb = num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    bc = bm.block_coords
    inview = frustum_mask(bm, T_wc, intr, cfg, near, far)
    flat = torch.where(inview, (bc[:, 0] * nb + bc[:, 1]) * nb + bc[:, 2],
                       torch.full_like(bc[:, 0], nb3))
    mask = torch.zeros(nb3 + 1, dtype=torch.bool, device=bc.device)
    mask[flat.long()] = True
    return mask[:nb3]


def partition_window(bm: BlockMap, cfg: TsdfConfig, center_w: torch.Tensor, radius: float,
                     evict_cap: int, votes=None, stamp: torch.Tensor | None = None):
    """Split the live blocks into an active window (kept) and cold rows
    (evicted), for block streaming (``engine/streaming.py``).

    Blocks whose center is farther than `radius` from `center_w` (3,) are
    cold; the first `evict_cap` of them in slot order are copied into a
    bounded eviction buffer and dropped, the rest stay live for a later
    call.  The survivors are compacted as ``clean`` compacts them, with the
    per-slot `votes` and `stamp` (i32[C, 2]) moving with their rows.

    Returns (bm, votes, evicted) or, with `stamp`, (bm, votes, evicted,
    stamp); ``evicted`` holds coords i32[E,3] (-1 where invalid), sdf,
    weight (0 where invalid) and color payload rows, valid bool[E], label
    and count rows with `votes`, and stamp rows (0 where invalid) with
    `stamp`.
    """
    c = bm.sdf.shape[0]
    slot_ids = torch.arange(c, dtype=torch.int32, device=bm.sdf.device)
    allocated = (slot_ids < bm.n_active) & (bm.block_coords[:, 0] >= 0)
    bsz = cfg.block_size * cfg.voxel_size
    half = (bm.block_coords.float() + 0.5) * bsz
    centers = torch.stack([half[:, a] + cfg.origin[a] for a in range(3)], -1)
    dist = torch.linalg.norm(centers - center_w[None, :], dim=-1)
    cold = allocated & (dist > radius)

    eidx, evalid = compact_mask_indices(cold, evict_cap)
    rows = eidx.long()
    evicted = {
        "coords": torch.where(evalid[:, None], bm.block_coords[rows], -1),
        "sdf": bm.sdf[rows],
        "weight": torch.where(evalid[:, None], bm.weight[rows], 0.0),
        "valid": evalid,
    }
    if bm.color.numel():
        evicted["color"] = bm.color[rows]
    if votes is not None:
        evicted["label"] = votes.label[rows]
        evicted["count"] = votes.count[rows]
    if stamp is not None:
        evicted["stamp"] = torch.where(evalid[:, None], stamp[rows], 0)

    sel = torch.zeros(c + 1, dtype=torch.bool, device=bm.sdf.device)
    sel[torch.where(evalid, eidx, c).long()] = True
    bm_new, votes_new, stamp_new = _compact(bm, allocated & ~sel[:c], votes, stamp)
    if stamp is not None:
        return bm_new, votes_new, evicted, stamp_new
    return bm_new, votes_new, evicted


def admit_rows(bm: BlockMap, cfg: TsdfConfig, coords: torch.Tensor, sdf: torch.Tensor,
               weight: torch.Tensor, color: torch.Tensor | None, valid: torch.Tensor,
               votes=None, label: torch.Tensor | None = None,
               count: torch.Tensor | None = None, stamp: torch.Tensor | None = None,
               row_stamp: torch.Tensor | None = None):
    """Re-insert streamed-out payload rows (i32[E,3] `coords`, their sdf,
    weight and color rows, bool[E] `valid`) by prefix-sum slot assignment.

    Rows whose block is allocated already are skipped (the live copy wins);
    rows beyond capacity (the last ``RESERVED_SLOTS`` stay free) are dropped
    and counted in ``overflow``.  `label` and `count` rows go into `votes`,
    `row_stamp` (default 0) into the per-slot `stamp`.

    Returns (bm, votes, fits bool[E]) or, with `stamp`, (bm, votes, fits,
    stamp); ``fits`` marks the rows admitted.
    """
    nb = num_blocks_per_axis(cfg)
    c = bm.sdf.shape[0]
    inb = valid & torch.all((coords >= 0) & (coords < nb), dim=-1)
    flat = (coords[:, 0] * nb + coords[:, 1]) * nb + coords[:, 2]
    flat_c = torch.where(inb, flat, torch.zeros_like(flat))
    already = bm.directory.reshape(-1)[flat_c.long()] >= 0
    need = inb & ~already
    order = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = bm.n_active + order
    fits = need & (new_slot < c - RESERVED_SLOTS)
    n_new = torch.sum(fits, dtype=torch.int32)
    n_drop = torch.sum(need, dtype=torch.int32) - n_new

    directory = _set_with_spill(
        bm.directory.reshape(-1), torch.where(fits, flat, torch.full_like(flat, nb ** 3)),
        new_slot)
    out = torch.where(fits, new_slot, torch.full_like(new_slot, c))
    bm_new = bm._replace(
        directory=directory.reshape(bm.directory.shape),
        block_coords=_set_with_spill(bm.block_coords, out, coords),
        n_active=bm.n_active + n_new,
        overflow=bm.overflow + n_drop,
        sdf=_set_with_spill(bm.sdf, out, sdf),
        weight=_set_with_spill(bm.weight, out, weight),
    )
    if color is not None and bm.color.numel():
        bm_new = bm_new._replace(color=_set_with_spill(bm.color, out, color))
    votes_new = votes
    if votes is not None and label is not None:
        votes_new = type(votes)(label=_set_with_spill(votes.label, out, label),
                                count=_set_with_spill(votes.count, out, count))
    if stamp is not None:
        if row_stamp is None:
            row_stamp = torch.zeros((coords.shape[0],) + stamp.shape[1:], dtype=stamp.dtype,
                                    device=stamp.device)
        return bm_new, votes_new, fits, _set_with_spill(stamp, out, row_stamp)
    return bm_new, votes_new, fits
