"""Instance table and 2D-3D association (port of ``engine/instances.py``).

The table is a fixed-capacity struct of arrays (active / class / score /
age / matches per global instance id).  A frame's K masks are matched to
the N table instances visible in the predicted-id image by IoU with a
class gate, greedily one to one; unmatched masks that are big enough get
free rows by prefix sum.  Everything stays on the device with static
shapes and no host read: the overlap counts are one scatter-add over
pixels (exact integer counts, as the reference's one-hot matmul), the
greedy matching is K rounds of small device ops, and "drop" scatters land
in a spill element past the end.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instancefusion_tpu_torch.config import InstanceConfig
from instancefusion_tpu_torch.models.segmentation import Segmentation


class InstanceTable(NamedTuple):
    active: torch.Tensor  # bool[N]
    cls: torch.Tensor  # i32[N] semantic class (0 = unset)
    score: torch.Tensor  # f32[N] accumulated confidence
    age: torch.Tensor  # i32[N] frames since creation
    matches: torch.Tensor  # i32[N] times re-observed
    overflow: torch.Tensor  # () i32 masks dropped for lack of free rows


def allocate(cfg: InstanceConfig, device) -> InstanceTable:
    n = cfg.max_instances
    i32 = dict(dtype=torch.int32, device=device)
    return InstanceTable(
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        cls=torch.zeros((n,), **i32),
        score=torch.zeros((n,), dtype=torch.float32, device=device),
        age=torch.zeros((n,), **i32),
        matches=torch.zeros((n,), **i32),
        overflow=torch.zeros((), **i32),
    )


def instance_color(gid: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-random color per global id (...,) -> (..., 3).

    The low 8 bits of a golden-ratio-style product per channel; in int64
    they equal those of the reference's uint32 products.
    """
    g = gid.long()
    col = torch.stack([(g * m) & 0xFF for m in (2654435761, 2246822519, 3266489917)],
                      dim=-1).float() / 255.0
    return torch.where(gid[..., None] >= 0, 0.25 + 0.75 * col, torch.zeros_like(col))


def _spill(x: torch.Tensor) -> torch.Tensor:
    """`x` with one extra trailing element along dim 0 (a scatter target for
    dropped rows)."""
    return torch.cat([x, x[:1]])


def _overlap(seg: Segmentation, pred_gid: torch.Tensor, n: int):
    """IoU (K, N) of the frame's masks against the predicted instances, and
    each mask's pixel count (K,)."""
    k = seg.classes.shape[0]
    mask = seg.mask_id.reshape(-1).long()
    pred = pred_gid.reshape(-1).long()
    idx = (torch.where(mask >= 0, mask, torch.full_like(mask, k)) * (n + 1)
           + torch.where(pred >= 0, pred, torch.full_like(pred, n)))
    # A float scatter-add of ones: exact below 2^24 pixels, and unlike
    # torch.bincount it does not read the index range back to the host.
    counts = torch.zeros((k + 1) * (n + 1), dtype=torch.float32, device=mask.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    counts = counts.reshape(k + 1, n + 1)
    overlap = counts[:k, :n]
    mask_px = counts[:k].sum(1)
    pred_px = counts[:, :n].sum(0)
    union = mask_px[:, None] + pred_px[None, :] - overlap
    return overlap / torch.clamp(union, min=1.0), mask_px


def _class_gate(table: InstanceTable, seg: Segmentation) -> torch.Tensor:
    """(K, N): table row active and class agreeing with the mask (or unset)."""
    cls_ok = (table.cls[None, :] == seg.classes[:, None]) | (table.cls[None, :] == 0)
    return table.active[None, :] & cls_ok


def associate(table: InstanceTable, seg: Segmentation, pred_gid: torch.Tensor,
              cfg: InstanceConfig):
    """Match frame masks to table instances; returns (gid_image, table').

    gid_image gives every segmented pixel its global instance id (the
    matched row, or a freshly allocated one; -1 for none).
    """
    n = cfg.max_instances
    k = seg.classes.shape[0]
    dev = seg.mask_id.device
    iou, mask_px = _overlap(seg, pred_gid, n)
    gate = _class_gate(table, seg) & (iou >= cfg.iou_match_thresh)
    iou_cur = torch.where(gate, iou, torch.full_like(iou, -1.0))

    # Greedy one-to-one matching, K rounds: take the best pair, retire its
    # row and column.  Ties take the first index in row-major order, as
    # argmax does in both packages.
    rows_k = torch.arange(k, device=dev)
    cols_n = torch.arange(n, device=dev)
    matched = torch.full((k,), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(k):
        flat = torch.argmax(iou_cur).reshape(1)
        ok = iou_cur.reshape(-1).gather(0, flat) > 0.0
        ki, ni = flat // n, flat % n
        row = (rows_k == ki) & ok
        col = (cols_n == ni) & ok
        matched = torch.where(row, ni.to(torch.int32), matched)
        taken = taken | col
        iou_cur = iou_cur.masked_fill(row[:, None] | col[None, :], -1.0)

    # New rows for unmatched, valid, big-enough masks, by rank.
    is_new = seg.valid & (matched < 0) & (mask_px >= float(cfg.min_mask_pixels))
    free = ~table.active & ~taken
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    new_rank = torch.cumsum(is_new.to(torch.int32), 0) - 1
    n_free = free.sum()
    fits = is_new & (new_rank < n_free)
    rank_oh = (free_rank[None, :] == new_rank[:, None]) & free[None, :] & fits[:, None]
    row_ids = torch.argmax(rank_oh.to(torch.int32), dim=1).to(torch.int32)
    new_gid = torch.where(fits, row_ids, torch.full_like(row_ids, -1))
    gid_of_mask = torch.where(matched >= 0, matched, new_gid)

    # Table update; rows are unique (matched rows are active, new rows free).
    upd = torch.where(gid_of_mask >= 0, gid_of_mask, torch.full_like(gid_of_mask, n)).long()
    cur_cls = table.cls[upd.clamp(max=n - 1)]
    active = _spill(table.active).index_put_((upd,), torch.ones_like(upd, dtype=torch.bool))
    cls = _spill(table.cls).index_put_(
        (upd,), torch.where(cur_cls == 0, seg.classes.to(torch.int32), cur_cls))
    # Float sums into rows that may repeat: index_put_ with accumulate adds
    # in a fixed order on every device (index_add_ uses atomics on CUDA).
    score = _spill(table.score).index_put_((upd,), seg.scores.float(), accumulate=True)
    matches = _spill(table.matches).index_add_(0, upd, (matched >= 0).to(torch.int32))
    new_table = InstanceTable(
        active=active[:n], cls=cls[:n], score=score[:n],
        age=torch.where(table.active, table.age + 1, table.age),
        matches=matches[:n],
        overflow=table.overflow + (is_new & ~fits).sum(dtype=torch.int32),
    )
    lut = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), gid_of_mask])
    mask = seg.mask_id.to(torch.int32)
    gid_image = torch.index_select(lut, 0, (torch.where(mask >= 0, mask, -1) + 1).reshape(-1))
    return gid_image.reshape(mask.shape), new_table


def find_merges(table: InstanceTable, seg: Segmentation, pred_gid: torch.Tensor,
                cfg: InstanceConfig):
    """Table rows that are one object: (src i32[K], dst i32[K], ok bool[K]).

    A mask whose best and second-best IoU against active, class-compatible
    rows both clear their thresholds shows that the runner-up (src) is the
    same object as the winner (dst).
    """
    k = seg.classes.shape[0]
    iou, mask_px = _overlap(seg, pred_gid, cfg.max_instances)
    iou_g = torch.where(_class_gate(table, seg), iou, torch.full_like(iou, -1.0))
    best, dst = torch.max(iou_g, dim=1)
    rows = torch.arange(k, device=iou.device)
    iou_2 = iou_g.index_put((rows, dst), torch.full_like(best, -1.0))
    second, src = torch.max(iou_2, dim=1)
    ok = (seg.valid & (mask_px >= float(cfg.min_mask_pixels))
          & (best >= cfg.iou_match_thresh) & (second >= cfg.merge_iou_thresh))
    return src.to(torch.int32), dst.to(torch.int32), ok


def apply_merges(table: InstanceTable, src: torch.Tensor, dst: torch.Tensor,
                 ok: torch.Tensor) -> InstanceTable:
    """Fold each src row into its dst row and free the src slot."""
    n = table.active.shape[0]
    srows = torch.where(ok, src, torch.full_like(src, n)).long()
    drows = torch.where(ok, dst, torch.full_like(dst, n)).long()
    src_c = src.clamp(0, n - 1).long()
    score = _spill(table.score).index_put_(
        (drows,), torch.where(ok, table.score[src_c], torch.zeros_like(table.score[src_c])),
        accumulate=True)
    matches = _spill(table.matches).index_add_(
        0, drows, torch.where(ok, table.matches[src_c], torch.zeros_like(table.matches[src_c])))

    def cleared(x):  # src rows set to zero (False), after the folding above
        return x.index_put_((srows,), torch.zeros_like(srows, dtype=x.dtype))[:n]

    return table._replace(
        active=cleared(_spill(table.active)), cls=cleared(_spill(table.cls)),
        score=cleared(score), matches=cleared(matches),
        age=cleared(_spill(table.age)),
    )


def retire_stale(table: InstanceTable, cfg: InstanceConfig, min_matches: int = 2,
                 probation_age: int = 30) -> InstanceTable:
    """Free rows older than `probation_age` frames with fewer than
    `min_matches` re-observations (spurious masks)."""
    stale = table.active & (table.age > probation_age) & (table.matches < min_matches)
    keep = table.active & ~stale

    def kept(x):
        return torch.where(keep, x, torch.zeros_like(x))

    return table._replace(active=keep, cls=kept(table.cls), score=kept(table.score),
                          age=kept(table.age), matches=kept(table.matches))
