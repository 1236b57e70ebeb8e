"""Per-voxel instance-label fusion over the block map (port of ``ops/labels.py``).

Each voxel keeps a streaming majority vote ``(label, count)``, updated
Boyer-Moore style (kernel K7, ``ops/kernels/labels.py``):

    count <= 0        -> adopt the observed label, count = 1
    label == observed -> count += 1
    label != observed -> count -= 1

The vote planes are parallel to the block map's payload rows.  Everything
here stays on the device without host reads; ``fuse`` and
``relabel_votes`` update the vote planes in place (the votes passed in are
the votes returned).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instancefusion_tpu_torch.config import TsdfConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics, backproject
from instancefusion_tpu_torch.ops import blocks as blk
from instancefusion_tpu_torch.ops.kernels import labels as k7
from instancefusion_tpu_torch.ops.preprocess import compute_normals


class LabelVotes(NamedTuple):
    """Per-voxel instance vote state, parallel to the BlockMap payload slots."""

    label: torch.Tensor  # i32[C, B^3] global instance id, -1 = unlabeled
    count: torch.Tensor  # f32[C, B^3] majority-vote counter


def allocate(cfg: TsdfConfig, device) -> LabelVotes:
    c, b3 = cfg.table_capacity, cfg.block_size**3
    return LabelVotes(
        label=torch.full((c, b3), -1, dtype=torch.int32, device=device),
        count=torch.zeros((c, b3), dtype=torch.float32, device=device),
    )


def merge_table(src: torch.Tensor, dst: torch.Tensor, ok: torch.Tensor,
                num_ids: int) -> torch.Tensor:
    """The id map of the merges ``src[i] -> dst[i]`` (where ``ok[i]``),
    applied in order i = 0, 1, ..., as i32[num_ids + 1]: entry ``x + 1``
    is the id that ``x`` ends as, and entry 0 keeps -1 at -1.

    Each merge rule acts on the id value alone, so composing the K rules
    on the identity table and applying the table with one gather is the
    same map as the K elementwise passes of the reference.
    """
    dev = src.device
    table = torch.arange(-1, num_ids, dtype=torch.int32, device=dev)
    # A rule that is not ok maps src to itself.
    to = torch.where(ok, dst, src).to(torch.int32)
    src = src.to(torch.int32)
    for i in range(src.shape[0]):
        table = torch.where(table == src[i], to[i], table)
    return table


def apply_table(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``merge_table``'s map applied to ids in [-1, num_ids)."""
    return torch.index_select(table, 0, (ids + 1).reshape(-1)).reshape(ids.shape)


def relabel_votes(votes: LabelVotes, table: torch.Tensor) -> LabelVotes:
    """Rewrite per-voxel votes after instance merges, in place.

    ``table`` is the merges' ``merge_table``; counts are kept, so the merged
    object's evidence keeps its weight.
    """
    votes.label.copy_(apply_table(table, votes.label))
    return votes


def fuse(
    votes: LabelVotes,
    bm: blk.BlockMap,
    gid_image: torch.Tensor,  # i32[H,W] per-pixel global instance id, -1 = none
    depth: torch.Tensor,
    T_wc: torch.Tensor,
    intr: Intrinsics,
    cfg: TsdfConfig,
    max_touched: int = 8192,
) -> LabelVotes:
    """Vote the frame's instance ids into band voxels of touched blocks (K7).

    The blocks the frame's truncation band touches are listed (up to
    `max_touched`); each voxel of a listed, allocated block projects into
    the frame, and voxels within the band of the measured surface receive
    the pixel's instance id.
    """
    touched = blk.touched_blocks_mask(depth, T_wc, intr, cfg)
    nb3 = blk.num_blocks_per_axis(cfg) ** 3
    slots, valid = blk.compact_touched_slots(bm, touched, cfg, min(max_touched, nb3))
    k7.label_vote(bm.block_coords, votes.label, votes.count, slots, valid,
                  depth.contiguous(), gid_image.to(torch.int32).contiguous(), T_wc,
                  intr, cfg)
    return votes


def sample_nearest(
    votes: LabelVotes,
    bm: blk.BlockMap,
    p_w: torch.Tensor,  # (..., 3) world points (e.g. prediction hits)
    valid_in: torch.Tensor,  # (...) bool
    cfg: TsdfConfig,
) -> torch.Tensor:
    """Nearest-voxel instance label at world points -> i32[...], -1 = none."""
    nb = blk.num_blocks_per_axis(cfg)
    b = cfg.block_size
    b3 = b * b * b
    n = cfg.grid_size
    g = torch.round(torch.stack(
        [(p_w[..., a] - cfg.origin[a]) / cfg.voxel_size - 0.5 for a in range(3)], -1
    )).to(torch.int32)
    inb = torch.all((g >= 0) & (g < n), dim=-1) & valid_in
    gc = g.clamp(0, n - 1)
    blkc = gc // b
    loc = gc - blkc * b
    bflat = (blkc[..., 0] * nb + blkc[..., 1]) * nb + blkc[..., 2]
    slot = bm.directory.reshape(-1)[bflat.long()]
    have = inb & (slot >= 0)
    vidx = (slot.clamp(min=0).long() * b3
            + ((loc[..., 0] * b + loc[..., 1]) * b + loc[..., 2]).long())
    lab = votes.label.reshape(-1)[vidx]
    cnt = votes.count.reshape(-1)[vidx]
    return torch.where(have & (cnt > 0.0), lab, torch.full_like(lab, -1))


def refine_mask_edges(
    mask_id: torch.Tensor,  # i32[H,W]
    depth: torch.Tensor,  # f32[H,W]
    edge_thresh: float = 0.05,
    intr: Intrinsics | None = None,
    normal_dot: float = 0.6,
) -> torch.Tensor:
    """Invalidate mask labels on depth and normal discontinuities.

    Depth edges: a pixel whose 4-neighbourhood depth range exceeds
    `edge_thresh`, or that touches invalid depth, is dropped.  Normal
    edges (with `intr`): a pixel whose valid neighbours' normals disagree
    with its own (dot < `normal_dot`) is dropped, which stops labels
    bleeding across creases that have no depth jump.
    """
    shifts = ((1, 0), (-1, 0), (1, 1), (-1, 1))
    neigh = [torch.roll(depth, s, a) for s, a in shifts]
    dmin = torch.minimum(torch.minimum(neigh[0], neigh[1]), torch.minimum(neigh[2], neigh[3]))
    dmax = torch.maximum(torch.maximum(neigh[0], neigh[1]), torch.maximum(neigh[2], neigh[3]))
    edge = (dmax - dmin > edge_thresh) | (dmin <= 0.0) | (depth <= 0.0)
    if intr is not None:
        nmap, nvalid = compute_normals(backproject(intr, depth))
        dots = []
        for s, a in shifts:
            nn = torch.roll(nmap, s, a)
            nv = torch.roll(nvalid, s, a)
            dot = torch.sum(nmap * nn, dim=-1)
            dots.append(torch.where(nvalid & nv, dot, torch.ones_like(dot)))
        min_dot = torch.minimum(torch.minimum(dots[0], dots[1]),
                                torch.minimum(dots[2], dots[3]))
        edge = edge | (min_dot < normal_dot)
    return torch.where(edge, torch.full_like(mask_id, -1), mask_id)
