"""The slab-sharded block map and its distributed ops (port of
``parallel/shard.py``).

Rank s of an S-rank group (``parallel/mesh.py``) owns the blocks whose x
block-coordinate lies in slab s: ``[cuts[s-1], cuts[s])`` with implicit
ends 0 and Nb.  Slots are global (``slot = s * Cl + local``, Cl =
``table_capacity // S``), so the replicated directory stays meaningful on
every rank while a payload row lives only on its owner, at its local index.

Per rank, a ``ShardedBlockMap`` holds the replicated directory, ``cuts``
and per-shard ``n_active``/``overflow`` vectors i32[S], and its own rows
(``block_coords``, ``sdf``, ``weight``, ``color``, Cl each).  Every op
below runs on every rank with the same replicated inputs; the collectives
are explicit calls on the group:

- ``fused_step_map`` (the splat path, configs 4/5): the replicated band
  allocation (``_alloc_from_band``, no collective), K4 over the rank's
  own in-frustum rows, K5 into raw accumulator planes, one ``psum`` of
  the planes and the replicated finish.  Shards own disjoint rows, so the
  summed planes are the unsharded planes up to the order of the sum.
- ``integrate`` and ``raycast`` (the marched path): allocation by a
  ``pmax`` merge of disjoint proposals, the touched-block update (K8) on
  own rows; a halo exchange of slab-boundary rows (two ``ppermute``s),
  the marched raycast over own and halo rows, a ``pmin`` depth composite
  and a masked ``psum`` blend of the winners.
- ``clean``, ``reshard`` (rows to their new slab owner by one
  ``all_to_all``), ``partition_window`` and ``admit_rows`` (streaming):
  row compaction is local, the directory is rebuilt by a ``pmax``.
- ``fuse_labels`` (K7 on own touched rows) and ``sample_labels`` (a
  ``pmax`` composite of the instance-id image).
- ``sharded_ba_partials``, ``sharded_paired_terms`` and
  ``sharded_pose_graph_normal_eqs``: each rank sums its slice of the
  (replicated) observations, landmarks or edges; one ``psum``.

Where the reference loops over shards inside a shard body (the band
allocation's plan, the reshard's send buckets), this module computes the
same answer with one-hot prefix sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from instancefusion_tpu_torch.config import RaycastConfig, TsdfConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.ops import ba
from instancefusion_tpu_torch.ops import blocks as blk
from instancefusion_tpu_torch.ops.kernels import labels as k7
from instancefusion_tpu_torch.ops.kernels import raycast as splat_kernels
from instancefusion_tpu_torch.ops.kernels import tsdf as tsdf_kernels
from instancefusion_tpu_torch.ops.labels import LabelVotes
from instancefusion_tpu_torch.ops.raycast import RaycastMaps
from instancefusion_tpu_torch.parallel.mesh import ShardGroup

_I32 = torch.int32


class ShardedBlockMap(NamedTuple):
    """One rank's view of the sharded map."""

    directory: torch.Tensor  # i32[Nb,Nb,Nb] replicated; global slots
    block_coords: torch.Tensor  # i32[Cl, 3] own rows
    n_active: torch.Tensor  # i32[S] replicated live-slot count of every shard
    overflow: torch.Tensor  # i32[S] replicated
    sdf: torch.Tensor  # f32[Cl, B^3] own rows
    weight: torch.Tensor  # f32[Cl, B^3]
    color: torch.Tensor  # f32[Cl, 3 B^3] packed [r | g | b], or [Cl, 0]
    cuts: torch.Tensor  # i32[S-1] replicated slab cuts on the x block-axis


def local_capacity(cfg: TsdfConfig, num_shards: int) -> int:
    return cfg.table_capacity // num_shards


def uniform_cuts(cfg: TsdfConfig, num_shards: int, device=None) -> torch.Tensor:
    nb = blk.num_blocks_per_axis(cfg)
    return ((torch.arange(1, num_shards, dtype=_I32, device=device) * nb)
            // num_shards).to(_I32)


def balanced_cuts(directory: torch.Tensor, cfg: TsdfConfig, num_shards: int) -> torch.Tensor:
    """Occupancy-balanced slab cuts from the (replicated) directory: the
    first x layer whose occupancy prefix crosses each s/S quantile (host
    numpy; the same on every rank)."""
    nb = blk.num_blocks_per_axis(cfg)
    occ = directory.reshape(nb, -1).cpu().numpy()
    csum = np.cumsum((occ >= 0).sum(axis=1).astype(np.int64))
    targets = (np.arange(1, num_shards) * int(csum[-1])) // num_shards
    cuts = np.clip(np.searchsorted(csum, targets, side="left") + 1, 1, nb - 1)
    cuts = np.maximum.accumulate(cuts)
    return torch.as_tensor(cuts, dtype=_I32, device=directory.device)


def allocate(cfg: TsdfConfig, group: ShardGroup, with_color: bool = True) -> ShardedBlockMap:
    """An empty sharded map: this rank's rows and the replicated parts."""
    nb = blk.num_blocks_per_axis(cfg)
    s, dev = group.size, group.device
    cl = local_capacity(cfg, s)
    b3 = cfg.block_size**3
    return ShardedBlockMap(
        directory=torch.full((nb, nb, nb), -1, dtype=_I32, device=dev),
        block_coords=torch.full((cl, 3), -1, dtype=_I32, device=dev),
        n_active=torch.zeros((s,), dtype=_I32, device=dev),
        overflow=torch.zeros((s,), dtype=_I32, device=dev),
        sdf=torch.full((cl, b3), blk.UNOBSERVED, dtype=torch.float32, device=dev),
        weight=torch.zeros((cl, b3), dtype=torch.float32, device=dev),
        color=torch.zeros((cl, 3 * b3 if with_color else 0), dtype=torch.float32,
                          device=dev),
        cuts=uniform_cuts(cfg, s, dev),
    )


def allocate_votes(cfg: TsdfConfig, group: ShardGroup) -> LabelVotes:
    """Per-voxel instance votes of this rank's rows."""
    cl = local_capacity(cfg, group.size)
    b3 = cfg.block_size**3
    return LabelVotes(
        label=torch.full((cl, b3), -1, dtype=_I32, device=group.device),
        count=torch.zeros((cl, b3), dtype=torch.float32, device=group.device),
    )


def _slab_of(bx: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Owner shard of block x-coords `bx`: the number of cuts at or below."""
    if cuts.shape[0] == 0:
        return torch.zeros_like(bx)
    return torch.sum((bx[..., None] >= cuts).to(_I32), dim=-1, dtype=_I32)


def _local_map(bm: ShardedBlockMap, group: ShardGroup, directory=None) -> blk.BlockMap:
    """This rank's rows as a plain BlockMap (for the ``blocks`` ops that
    address rows by local slot)."""
    sid = group.rank
    return blk.BlockMap(
        directory=bm.directory if directory is None else directory,
        block_coords=bm.block_coords, n_active=bm.n_active[sid],
        overflow=bm.overflow[sid], sdf=bm.sdf, weight=bm.weight, color=bm.color,
    )


def _per_shard(group: ShardGroup, *counts: torch.Tensor) -> list[torch.Tensor]:
    """Each rank's scalars as replicated i32[S] vectors (one all_gather)."""
    g = group.all_gather(torch.stack([c.to(_I32) for c in counts]))
    return [g[:, i].contiguous() for i in range(len(counts))]


def _block_ids(nb: int, device) -> torch.Tensor:
    return torch.arange(nb * nb * nb, dtype=_I32, device=device)


def _coords_of(flat: torch.Tensor, nb: int) -> torch.Tensor:
    return torch.stack([flat // (nb * nb), (flat // nb) % nb, flat % nb], -1).to(_I32)


# ---------------------------------------------------------------------------
# The splat path: replicated band allocation, K4 and K5 on own rows, psum
# ---------------------------------------------------------------------------


def _alloc_from_band(bm: ShardedBlockMap, depth, T_wc, group: ShardGroup,
                     intr: Intrinsics, cfg: TsdfConfig, samples: int = 3,
                     stride: int = 4, alloc_cap: int = 4096) -> ShardedBlockMap:
    """Replicated list-based allocation of this frame's band blocks.

    The candidate list, its dedup and every shard's prefix-sum slots are
    functions of replicated inputs, so every rank computes the same plan
    and directory without a collective and writes only its own coords
    rows.  A shard's last ``RESERVED_SLOTS`` rows stay free.  The shards'
    plans come from one one-hot prefix sum over (candidate, shard).
    """
    nb = blk.num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    s, sid = group.size, group.rank
    cl = bm.block_coords.shape[0]
    top = blk.band_candidates(depth, T_wc, intr, cfg, samples, stride, alloc_cap)
    dir_flat = bm.directory.reshape(-1)
    have = dir_flat[torch.clamp(top, min=0).long()] >= 0
    uniq = (top >= 0) & ~have
    owner = _slab_of(top // (nb * nb), bm.cuts).long()
    shards = torch.arange(s, device=top.device)
    onehot = uniq[:, None] & (owner[:, None] == shards[None, :])  # (K, S)
    order = torch.cumsum(onehot.to(_I32), 0, dtype=_I32) - 1
    order = torch.gather(order, 1, owner[:, None])[:, 0]
    lslot = bm.n_active[owner] + order
    fits = uniq & (lslot < cl - blk.RESERVED_SLOTS)
    gslot = owner.to(_I32) * cl + lslot
    directory = blk._set_with_spill(
        dir_flat, torch.where(fits, top, torch.full_like(top, nb3)), gslot)
    n_new = torch.sum(onehot & fits[:, None], 0, dtype=_I32)
    n_need = torch.sum(onehot, 0, dtype=_I32)
    row = torch.where(fits & (owner == sid), lslot, torch.full_like(lslot, cl))
    coords = blk._set_with_spill(bm.block_coords, row, _coords_of(top, nb))
    return bm._replace(
        directory=directory.reshape(bm.directory.shape), block_coords=coords,
        n_active=bm.n_active + n_new, overflow=bm.overflow + (n_need - n_new),
    )


def fused_step_map(bm: ShardedBlockMap, depth, color, prior, T_wc, group: ShardGroup,
                   intr: Intrinsics, cfg: TsdfConfig, rc_cfg: RaycastConfig,
                   pred_color: bool = True, k_local: int | None = None,
                   alloc_cap: int = 4096, color_gain: float = 1.0):
    """The sharded splat-path map update of one frame: allocate, integrate
    own rows (K4), splat own rows into raw planes (K5), psum, finish.

    `color` None fuses depth only; `prior` is the depth prior of the
    finish.  `k_local` (the reference's default, max(256, touched_capacity
    // S)) is the length of the rank's in-frustum list: rows past it are
    neither integrated nor splatted this frame (``blocks.LIST_FILL``
    counts them).  Returns (map, RaycastMaps), the maps the same on every
    rank.
    """
    if k_local is None:
        k_local = max(256, cfg.touched_capacity // group.size)
    bm = _alloc_from_band(bm, depth, T_wc, group, intr, cfg, alloc_cap=alloc_cap)
    local = _local_map(bm, group)
    inview = blk.frustum_mask(local, T_wc, intr, cfg, rc_cfg.near, rc_cfg.far)
    blk.LIST_FILL.note(inview, k_local)
    slots, valid = blk.compact_mask_indices(inview, k_local)
    blk.integrate_slots(local, slots, valid, depth, color, T_wc, intr, cfg,
                        color_gain=color_gain)
    want_color = pred_color and bm.color.numel() > 0
    raw = splat_kernels.splat_planes(
        slots, valid, bm.block_coords, bm.sdf, bm.weight, bm.color, T_wc, intr, cfg,
        want_color, rc_cfg.splat_rmax)
    planes = group.psum(raw)
    imgs = splat_kernels.finish_splat_images(planes, intr, cfg, want_color, prior)
    return bm, blk.maps_from_splat(imgs, T_wc, intr)


# ---------------------------------------------------------------------------
# The marched path: pmax-merged allocation + K8, halo raycast
# ---------------------------------------------------------------------------


def integrate(bm: ShardedBlockMap, depth, color, T_wc, group: ShardGroup,
              intr: Intrinsics, cfg: TsdfConfig, max_touched: int = 8192) -> ShardedBlockMap:
    """Fuse one frame into the touched blocks of this rank's slab.

    Each rank allocates its slab's touched blocks into its own slot range;
    the disjoint proposals merge by one ``pmax``.  The update of the own
    touched rows is ``blocks.touched_observations`` then K8.  Updates the
    payload rows in place.
    """
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    cl = bm.block_coords.shape[0]
    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)
    dir_flat = bm.directory.reshape(-1)
    idx = _block_ids(nb, depth.device)
    mine = _slab_of(idx // (nb * nb), bm.cuts) == sid
    need = touched & (dir_flat < 0) & mine
    order = torch.cumsum(need.to(_I32), 0, dtype=_I32) - 1
    local_slot = bm.n_active[sid] + order
    fits = need & (local_slot < cl)
    proposal = torch.where(fits, sid * cl + local_slot, torch.full_like(local_slot, -1))
    merged = group.pmax(proposal)
    dir_new = torch.where((dir_flat < 0) & (merged >= 0), merged, dir_flat)
    n_new, n_drop = _per_shard(group, torch.sum(fits, dtype=_I32),
                               torch.sum(need & ~fits, dtype=_I32))
    coords = blk._set_with_spill(
        bm.block_coords, torch.where(fits, local_slot, torch.full_like(local_slot, cl)),
        _coords_of(idx, nb))
    bm = bm._replace(directory=dir_new.reshape(bm.directory.shape), block_coords=coords,
                     n_active=bm.n_active + n_new, overflow=bm.overflow + n_drop)

    tidx, tvalid = blk.compact_mask_indices(touched & mine & (dir_new >= 0),
                                            min(max_touched, nb**3))
    lslots = dir_new[tidx.long()] - sid * cl
    valid = tvalid & (lslots >= 0) & (lslots < cl)
    lslots = torch.where(valid, lslots, torch.zeros_like(lslots))
    local = _local_map(bm, group)
    psi, w_obs, obs = blk.touched_observations(local, lslots, valid, depth, color, T_wc,
                                               intr, cfg)
    tsdf_kernels.tsdf_update(bm.sdf, bm.weight, bm.color, lslots, valid, psi, w_obs, obs,
                             cfg.max_weight)
    return bm


def _pack(parts) -> torch.Tensor:
    """Rows of several fields as one float32 tensor (int32 fields by bits)."""
    return torch.cat([p.view(torch.float32) if p.dtype == _I32 else p for p in parts], 1)


def _unpack(packed: torch.Tensor, likes) -> list[torch.Tensor]:
    """``_pack``'s inverse: one column range per example tensor in `likes`."""
    out, at = [], 0
    for like in likes:
        w = like.shape[1]
        col = packed[:, at:at + w].contiguous()
        out.append(col.view(_I32) if like.dtype == _I32 else col)
        at += w
    return out


def _halo_exchange(bm: ShardedBlockMap, group: ShardGroup, cfg: TsdfConfig, halo_cap: int):
    """Send this rank's first slab layer left and its last layer right.

    Returns (halo_dir i32[Nb^3] block -> halo row or -1, halo sdf, weight,
    color rows [2 halo_cap, ...], (rows from the left, rows from the
    right)).  The ring's wrap is not sent; the ends receive no halo.
    """
    s, sid = group.size, group.rank
    nb = blk.num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    cl = bm.block_coords.shape[0]
    dev = bm.sdf.device
    dir_flat = bm.directory.reshape(-1)
    idx = _block_ids(nb, dev)
    bx = idx // (nb * nb)
    owner = _slab_of(bx, bm.cuts)
    ends = torch.cat([torch.zeros(1, dtype=_I32, device=dev), bm.cuts,
                      torch.full((1,), nb, dtype=_I32, device=dev)])
    lo, hi = ends[sid], ends[sid + 1]

    def boundary_rows(layer):
        sel = (bx == layer) & (owner == sid) & (dir_flat >= 0)
        tidx, ok = blk.compact_mask_indices(sel, halo_cap)
        lslot = torch.clamp(dir_flat[tidx.long()] - sid * cl, 0, cl - 1).long()
        okc = ok[:, None]
        block_id = torch.where(ok, tidx, torch.full_like(tidx, -1))[:, None]
        return _pack([block_id,
                      torch.where(okc, bm.sdf[lslot], blk.UNOBSERVED),
                      torch.where(okc, bm.weight[lslot], 0.0),
                      torch.where(okc, bm.color[lslot], 0.0)])

    right = group.ppermute(boundary_rows(hi - 1), [(i, i + 1) for i in range(s - 1)])
    left = group.ppermute(boundary_rows(lo), [(i, i - 1) for i in range(1, s)])
    likes = (bm.block_coords[:1, :1], bm.sdf[:1], bm.weight[:1], bm.color[:1])
    bid_l, sdf_l, w_l, col_l = _unpack(right, likes)
    bid_r, sdf_r, w_r, col_r = _unpack(left, likes)
    # A rank with no neighbor on a side received zeros there.
    bid_l = bid_l[:, 0] if sid > 0 else torch.full_like(bid_l[:, 0], -1)
    bid_r = bid_r[:, 0] if sid < s - 1 else torch.full_like(bid_r[:, 0], -1)
    rows = torch.arange(halo_cap, dtype=_I32, device=dev)
    halo_dir = torch.full((nb3,), -1, dtype=_I32, device=dev)
    halo_dir = blk._set_with_spill(halo_dir, torch.where(bid_l >= 0, bid_l, nb3), rows)
    halo_dir = blk._set_with_spill(halo_dir, torch.where(bid_r >= 0, bid_r, nb3),
                                   rows + halo_cap)
    counts = (torch.sum(bid_l >= 0, dtype=_I32), torch.sum(bid_r >= 0, dtype=_I32))
    return (halo_dir, torch.cat([sdf_l, sdf_r]), torch.cat([w_l, w_r]),
            torch.cat([col_l, col_r]), counts)


def raycast(bm: ShardedBlockMap, T_wc, group: ShardGroup, intr: Intrinsics,
            tsdf_cfg: TsdfConfig, rc_cfg: RaycastConfig, halo_cap: int = 1024,
            with_color: bool = True, return_halo: bool = False):
    """Marched raycast of the sharded map: each rank marches every pixel
    through its own rows and the halo rows of its neighbors' boundary
    layers; the nearest valid hit wins each pixel (``pmin``) and the
    winners' maps are blended by one masked ``psum``.

    Returns RaycastMaps (the same on every rank), and with `return_halo`
    also (halo rows received from the left, from the right) on this rank.
    """
    sid = group.rank
    nb = blk.num_blocks_per_axis(tsdf_cfg)
    cl = bm.block_coords.shape[0]
    halo_cap = min(halo_cap, nb * nb)
    halo_dir, h_sdf, h_w, h_col, counts = _halo_exchange(bm, group, tsdf_cfg, halo_cap)
    dir_flat = bm.directory.reshape(-1)
    owner = _slab_of(_block_ids(nb, dir_flat.device) // (nb * nb), bm.cuts)
    ldir = torch.where(
        (owner == sid) & (dir_flat >= 0), dir_flat - sid * cl,
        torch.where(halo_dir >= 0, cl + halo_dir, torch.full_like(halo_dir, -1)))
    local = blk.BlockMap(
        directory=ldir.reshape(nb, nb, nb), block_coords=bm.block_coords,
        n_active=torch.zeros((), dtype=_I32, device=dir_flat.device),
        overflow=torch.zeros((), dtype=_I32, device=dir_flat.device),
        sdf=torch.cat([bm.sdf, h_sdf]), weight=torch.cat([bm.weight, h_w]),
        color=torch.cat([bm.color, h_col]) if bm.color.numel() else bm.color,
    )
    maps = blk.raycast(local, T_wc, intr, tsdf_cfg, rc_cfg, with_color=with_color)
    far = torch.full_like(maps.depth, 3.4e38)
    mine = torch.where(maps.valid, maps.depth, far)
    win = maps.valid & (mine <= group.pmin(mine))
    m = win.float()[..., None]
    blend = group.psum(torch.cat([maps.vertex_w * m, maps.normal_w * m,
                                  maps.depth[..., None] * m, maps.color * m, m], -1))
    nwin = blend[..., 10]
    div = torch.clamp(nwin, min=1.0)[..., None]
    out = RaycastMaps(vertex_w=blend[..., 0:3] / div, normal_w=blend[..., 3:6] / div,
                      depth=blend[..., 6] / div[..., 0], color=blend[..., 7:10] / div,
                      valid=nwin > 0)
    return (out, counts) if return_halo else out


# ---------------------------------------------------------------------------
# Row compaction, directory rebuild: clean, reshard, streaming
# ---------------------------------------------------------------------------


def _rebuild_directory(coords: torch.Tensor, n_live, group: ShardGroup, nb: int,
                       shape) -> torch.Tensor:
    """The replicated directory from every rank's live rows: each rank
    scatters its global slots, one ``pmax`` merges them."""
    cl = coords.shape[0]
    slot_ids = torch.arange(cl, dtype=_I32, device=coords.device)
    live = (slot_ids < n_live) & (coords[:, 0] >= 0)
    nb3 = nb * nb * nb
    flat = (coords[:, 0] * nb + coords[:, 1]) * nb + coords[:, 2]
    prop = torch.full((nb3,), -1, dtype=_I32, device=coords.device)
    prop = blk._set_with_spill(prop, torch.where(live, flat, torch.full_like(flat, nb3)),
                               group.rank * cl + slot_ids)
    return group.pmax(prop).reshape(shape)


def _take(live: torch.Tensor, arrays_and_fills):
    """Stable partition of rows: `live` rows to the front in their order,
    the rest filled.  Returns (n_live, [taken arrays])."""
    cl = live.shape[0]
    n_live = torch.sum(live, dtype=_I32)
    perm = torch.argsort((~live).to(_I32), stable=True)
    keep = torch.arange(cl, device=live.device) < n_live
    out = []
    for arr, fill in arrays_and_fills:
        if arr is None or arr.numel() == 0:
            out.append(arr)
            continue
        t = arr[perm]
        out.append(torch.where(keep.reshape((cl,) + (1,) * (t.dim() - 1)), t,
                               torch.full_like(t, fill)))
    return n_live, out


def _row_fields(bm: ShardedBlockMap, votes):
    fields = [(bm.block_coords, -1), (bm.sdf, blk.UNOBSERVED), (bm.weight, 0.0),
              (bm.color, 0.0)]
    if votes is not None:
        fields += [(votes.label, -1), (votes.count, 0.0)]
    return fields


def _with_rows(bm: ShardedBlockMap, votes, rows):
    bm = bm._replace(block_coords=rows[0], sdf=rows[1], weight=rows[2], color=rows[3])
    return bm, (LabelVotes(label=rows[4], count=rows[5]) if votes is not None else None)


def _allocated(bm: ShardedBlockMap, sid: int) -> torch.Tensor:
    cl = bm.block_coords.shape[0]
    slot_ids = torch.arange(cl, dtype=_I32, device=bm.sdf.device)
    return (slot_ids < bm.n_active[sid]) & (bm.block_coords[:, 0] >= 0)


def clean(bm: ShardedBlockMap, group: ShardGroup, cfg: TsdfConfig,
          min_weight: float = 1.0, votes=None):
    """``blocks.clean`` per rank: cull low-confidence and empty own rows,
    compact them, rebuild the directory.  Returns (map, votes)."""
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    best_w = torch.amax(bm.weight, dim=1)
    observed = torch.where(bm.weight > 0.0, bm.sdf, blk.UNOBSERVED)
    empty = torch.amin(observed, dim=1) > 0.98
    live = _allocated(bm, sid) & (best_w >= min_weight) & ~empty
    n_live, rows = _take(live, _row_fields(bm, votes))
    bm, votes = _with_rows(bm, votes, rows)
    (n_active,) = _per_shard(group, n_live)
    directory = _rebuild_directory(bm.block_coords, n_live, group, nb, bm.directory.shape)
    return bm._replace(directory=directory, n_active=n_active), votes


def reshard(bm: ShardedBlockMap, group: ShardGroup, cfg: TsdfConfig, votes=None,
            migrate_cap: int = 256):
    """Move every row to its slab owner under ``bm.cuts`` (one all_to_all).

    Each rank sends up to `migrate_cap` rows to each other rank (in slot
    order); the rest stay and are counted, for another call.  Receivers
    append after their compacted keepers (the last ``RESERVED_SLOTS`` stay
    free); votes travel with their rows.  Returns (map, votes, migrated
    i32[S] rows each rank sent, leftover i32[S] rows still misplaced).
    """
    s, sid = group.size, group.rank
    nb = blk.num_blocks_per_axis(cfg)
    cl = bm.block_coords.shape[0]
    q = migrate_cap
    allocated = _allocated(bm, sid)
    owner = _slab_of(bm.block_coords[:, 0], bm.cuts).long()
    away = allocated & (owner != sid)
    shards = torch.arange(s, device=owner.device)
    onehot = away[:, None] & (owner[:, None] == shards[None, :])
    order = torch.gather(torch.cumsum(onehot.to(_I32), 0, dtype=_I32) - 1, 1,
                         owner[:, None])[:, 0]
    sent = away & (order < q)
    fields = _row_fields(bm, votes)
    packed = _pack([torch.where(sent.reshape(-1, 1), a, torch.full_like(a, f))
                    for a, f in fields] + [sent.float()[:, None]])
    bucket = torch.where(sent, owner * q + order, torch.full_like(owner, s * q))
    send = blk._set_with_spill(
        torch.zeros((s * q, packed.shape[1]), dtype=torch.float32, device=packed.device),
        bucket, packed)
    recv = group.all_to_all(send)
    got = _unpack(recv, [a[:1] for a, _ in fields] + [recv[:1, -1:]])
    rc_valid = got[-1][:, 0] > 0.5

    leftover = away & ~sent
    keep = (allocated & (owner == sid)) | leftover
    n_keep, rows = _take(keep, fields)
    order_in = torch.cumsum(rc_valid.to(_I32), 0, dtype=_I32) - 1
    slot = n_keep + order_in
    fits = rc_valid & (slot < cl - blk.RESERVED_SLOTS)
    out = torch.where(fits, slot, torch.full_like(slot, cl))
    rows = [r if r is None or r.numel() == 0 else blk._set_with_spill(r, out, g)
            for r, g in zip(rows, got[:-1])]
    n_new = torch.sum(fits, dtype=_I32)
    n_drop = torch.sum(rc_valid, dtype=_I32) - n_new
    n_act = n_keep + n_new
    bm, votes = _with_rows(bm, votes, rows)
    n_active, drops, migrated, left = _per_shard(
        group, n_act, n_drop, torch.sum(sent, dtype=_I32), torch.sum(leftover, dtype=_I32))
    directory = _rebuild_directory(bm.block_coords, n_act, group, nb, bm.directory.shape)
    bm = bm._replace(directory=directory, n_active=n_active, overflow=bm.overflow + drops)
    return bm, votes, migrated, left


def partition_window(bm: ShardedBlockMap, group: ShardGroup, cfg: TsdfConfig,
                     center_w: torch.Tensor, radius: float, evict_cap: int, votes=None):
    """``blocks.partition_window`` per rank: copy up to `evict_cap` of this
    rank's cold rows (block center beyond `radius` of `center_w`) out,
    compact the rest, rebuild the directory.

    Returns (map, votes, evicted): this rank's eviction buffer, coords
    i32[E, 3] (-1 where invalid), sdf, weight (0 where invalid), color,
    label and count rows, valid bool[E].
    """
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    cl = bm.block_coords.shape[0]
    evict_cap = min(evict_cap, cl)
    allocated = _allocated(bm, sid)
    bsz = cfg.block_size * cfg.voxel_size
    half = (bm.block_coords.float() + 0.5) * bsz
    centers = torch.stack([half[:, a] + cfg.origin[a] for a in range(3)], -1)
    cold = allocated & (torch.linalg.norm(centers - center_w[None, :], dim=-1) > radius)
    eidx, evalid = blk.compact_mask_indices(cold, evict_cap)
    r = eidx.long()
    ev = {"coords": torch.where(evalid[:, None], bm.block_coords[r], -1),
          "sdf": bm.sdf[r], "weight": torch.where(evalid[:, None], bm.weight[r], 0.0),
          "valid": evalid}
    if bm.color.numel():
        ev["color"] = bm.color[r]
    if votes is not None:
        ev["label"] = votes.label[r]
        ev["count"] = votes.count[r]
    sel = torch.zeros(cl + 1, dtype=torch.bool, device=bm.sdf.device)
    sel[torch.where(evalid, eidx, cl).long()] = True
    n_live, rows = _take(allocated & ~sel[:cl], _row_fields(bm, votes))
    bm, votes = _with_rows(bm, votes, rows)
    (n_active,) = _per_shard(group, n_live)
    directory = _rebuild_directory(bm.block_coords, n_live, group, nb, bm.directory.shape)
    return bm._replace(directory=directory, n_active=n_active), votes, ev


def admit_rows(bm: ShardedBlockMap, group: ShardGroup, cfg: TsdfConfig, coords, sdf,
               weight, color, valid, votes=None, label=None, count=None):
    """``blocks.admit_rows`` on the sharded map: the (replicated) batch of
    streamed-out rows returns to their slab owners; each rank appends the
    rows it owns whose block is not allocated.  Returns (map, votes,
    admitted bool[E], the same on every rank)."""
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    nb3 = nb * nb * nb
    cl = bm.block_coords.shape[0]
    inb = valid & torch.all((coords >= 0) & (coords < nb), dim=-1)
    flat = (coords[:, 0] * nb + coords[:, 1]) * nb + coords[:, 2]
    dir_flat = bm.directory.reshape(-1)
    already = dir_flat[torch.where(inb, flat, torch.zeros_like(flat)).long()] >= 0
    need = inb & ~already & (_slab_of(coords[:, 0], bm.cuts) == sid)
    order = torch.cumsum(need.to(_I32), 0, dtype=_I32) - 1
    new_slot = bm.n_active[sid] + order
    fits = need & (new_slot < cl - blk.RESERVED_SLOTS)
    prop = blk._set_with_spill(torch.full((nb3,), -1, dtype=_I32, device=flat.device),
                               torch.where(fits, flat, torch.full_like(flat, nb3)),
                               sid * cl + new_slot)
    merged = group.pmax(prop)
    directory = torch.where((dir_flat < 0) & (merged >= 0), merged, dir_flat)
    out = torch.where(fits, new_slot, torch.full_like(new_slot, cl))
    bm = bm._replace(
        directory=directory.reshape(bm.directory.shape),
        block_coords=blk._set_with_spill(bm.block_coords, out, coords),
        sdf=blk._set_with_spill(bm.sdf, out, sdf),
        weight=blk._set_with_spill(bm.weight, out, weight),
    )
    if color is not None and bm.color.numel():
        bm = bm._replace(color=blk._set_with_spill(bm.color, out, color))
    if votes is not None and label is not None:
        votes = LabelVotes(label=blk._set_with_spill(votes.label, out, label),
                           count=blk._set_with_spill(votes.count, out, count))
    n_new = torch.sum(fits, dtype=_I32)
    n_add, n_drop = _per_shard(group, n_new, torch.sum(need, dtype=_I32) - n_new)
    bm = bm._replace(n_active=bm.n_active + n_add, overflow=bm.overflow + n_drop)
    return bm, votes, group.psum(fits) > 0


# ---------------------------------------------------------------------------
# Instance votes
# ---------------------------------------------------------------------------


def fuse_labels(votes: LabelVotes, bm: ShardedBlockMap, gid_image, depth, T_wc,
                group: ShardGroup, intr: Intrinsics, cfg: TsdfConfig,
                max_touched: int = 8192) -> LabelVotes:
    """Vote the frame's instance ids into the band voxels of this rank's
    touched rows (K7), in place; no collective."""
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    cl = bm.block_coords.shape[0]
    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)
    dir_flat = bm.directory.reshape(-1)
    mine = _slab_of(_block_ids(nb, depth.device) // (nb * nb), bm.cuts) == sid
    tidx, tvalid = blk.compact_mask_indices(touched & mine & (dir_flat >= 0),
                                            min(max_touched, nb**3))
    lslots = dir_flat[tidx.long()] - sid * cl
    valid = tvalid & (lslots >= 0) & (lslots < cl)
    lslots = torch.where(valid, lslots, torch.zeros_like(lslots))
    k7.label_vote(bm.block_coords, votes.label, votes.count, lslots, valid,
                  depth.contiguous(), gid_image.to(_I32).contiguous(), T_wc, intr, cfg)
    return votes


def sample_labels(votes: LabelVotes, bm: ShardedBlockMap, p_w, valid_in,
                  group: ShardGroup, cfg: TsdfConfig) -> torch.Tensor:
    """Nearest-voxel instance id at world points: each rank reads the
    points in its own rows (-1 elsewhere), one ``pmax`` composites."""
    sid = group.rank
    nb = blk.num_blocks_per_axis(cfg)
    b = cfg.block_size
    cl = bm.block_coords.shape[0]
    n = cfg.grid_size
    g = torch.round(torch.stack(
        [(p_w[..., a] - cfg.origin[a]) / cfg.voxel_size - 0.5 for a in range(3)], -1
    )).to(_I32)
    inb = torch.all((g >= 0) & (g < n), dim=-1) & valid_in
    gc = g.clamp(0, n - 1)
    blkc = gc // b
    loc = gc - blkc * b
    bflat = (blkc[..., 0] * nb + blkc[..., 1]) * nb + blkc[..., 2]
    lslot = bm.directory.reshape(-1)[bflat.long()] - sid * cl
    have = inb & (lslot >= 0) & (lslot < cl)
    vidx = (torch.clamp(lslot, 0, cl - 1).long() * b**3
            + ((loc[..., 0] * b + loc[..., 1]) * b + loc[..., 2]).long())
    lab = votes.label.reshape(-1)[vidx]
    cnt = votes.count.reshape(-1)[vidx]
    return group.pmax(torch.where(have & (cnt > 0.0), lab, torch.full_like(lab, -1)))


# ---------------------------------------------------------------------------
# Collective BA: each rank sums its slice, one psum
# ---------------------------------------------------------------------------


def _rank_slice(n: int, group: ShardGroup) -> slice:
    if n % group.size:
        raise ValueError(f"{n} rows do not split over {group.size} shards")
    per = n // group.size
    return slice(group.rank * per, (group.rank + 1) * per)


def _rows(nt, sl: slice):
    return type(nt)(*(x[sl] for x in nt))


def sharded_ba_partials(group: ShardGroup):
    """A ``partials_fn`` for ``ops/ba.optimize_ba``: this rank's share of
    the observations' normal-equation partials, psum'd."""

    def partials(poses, points, obs: ba.BAObservations):
        parts = ba.ba_partials(poses, points, _rows(obs, _rank_slice(obs.k.shape[0], group)))
        return tuple(group.psum(x) for x in parts)

    return partials


def sharded_paired_terms(group: ShardGroup, damping: float = 1e-4):
    """A ``terms_fn`` for ``ops/ba.optimize_hybrid_paired``: each rank
    reduces its landmark slice (a landmark's 3x3 block lives on one rank,
    so its damped inverse is exact); S, rhs and the cost are psum'd, the
    landmark-aligned terms all-gathered for the replicated
    back-substitution."""

    def terms(poses, points, obs: ba.PairedObs):
        sl = _rank_slice(points.shape[0], group)
        S, rhs, Hll_inv, Wa, Wb, bl, cost = ba.paired_terms(
            poses, points[sl], _rows(obs, sl), damping)

        def gather(x):
            return group.all_gather(x).reshape((-1,) + x.shape[1:])

        return (group.psum(S), group.psum(rhs), gather(Hll_inv), gather(Wa), gather(Wb),
                gather(bl), group.psum(cost))

    return terms


def sharded_pose_graph_normal_eqs(group: ShardGroup, poses, g: ba.PoseGraph):
    """Pose-graph normal equations over this rank's edge slice, psum'd."""
    H, b, cost = ba.pose_graph_normal_eqs(poses, _rows(g, _rank_slice(g.i.shape[0], group)))
    return group.psum(H), group.psum(b), group.psum(cost)
