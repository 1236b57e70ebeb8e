"""The SLAM judgement: the plain reference (``reference/``) fuses every frame
of the window into its own map at the pose the program served, re-tracks
frames drawn from the seed, and compares poses, map and prediction.

The program serves a pose a frame and leaves a map and a prediction.  As a
served model's tokens are judged by running the reference over the prompt
with those tokens, the reference fuses every frame of the window into its
own map at the served pose (teacher forcing).  At frames drawn from the
seed it tracks the frame itself, from the served previous poses, against
its own prediction, and compares its pose with the served one.  After the
last frame it compares its map with the program's, block by block, and its
prediction with the program's.  Every frame of the window is fused.  The
reference's prediction, which only frames near a sampled one need, starts
``PRIOR_FRAMES`` frames before it, so the depth prior of a prediction (the
previous prediction where the frame has no depth) reaches back that far and
no further.  Where a later judge names frames at which it needs the
prediction, the reference predicts every frame up to the last of them, so
that their depth prior is carried from the window's start as the program
carries it.

Per frame it leaves in the replay's context the served pose ``T``, the
filtered depth ``d0``, the reference map after the frame ``volume`` and
the prediction ``pred`` where one was made (else None).  On the card its
map update of a frame is replayed from a CUDA graph after ``LEAD_FRAMES``
eager frames: the same plain operations on the same tensors, without the
host's launches.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from harness import work as _work

PRIOR_FRAMES = 10
LEAD_FRAMES = 2
# The map's fields that the update rebinds (the payload is updated in place).
VOLUME_FIELDS = ("directory", "block_coords", "n_active", "overflow")


@dataclasses.dataclass
class Served:
    """What the program produced in the window."""
    poses: torch.Tensor  # (N, 4, 4) served pose of each frame
    volume: object  # final block map: directory, sdf, weight, color
    pred: object  # final prediction: vertex_w, normal_w, depth, color, valid


def _pose_gap(T_a: torch.Tensor, T_b: torch.Tensor) -> tuple[float, float]:
    """Translation (m) and rotation (rad, the Frobenius gap of the rotation
    blocks over sqrt 2, the angle for small gaps) between two poses."""
    dt = float(torch.linalg.norm(T_a[:3, 3].double() - T_b[:3, 3].double()))
    dr = float(torch.linalg.norm(T_a[:3, :3].double() - T_b[:3, :3].double())) / math.sqrt(2.0)
    return dt, dr


def _quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile of a 1-D tensor of any length (nearest rank)."""
    if x.numel() == 0:
        return 0.0
    k = min(x.numel(), max(1, int(math.ceil(q * x.numel()))))
    return float(torch.kthvalue(x.float().cpu(), k).values)


def sample_frames(n: int, seed: int, count: int) -> list[int]:
    """The frames whose pose the reference re-tracks: `count` drawn from the
    seed after the first PRIOR_FRAMES + 1, and the last."""
    first = PRIOR_FRAMES + 1
    if n <= first:
        return []
    rng = np.random.default_rng(seed % (1 << 63))
    pool = np.arange(first, n - 1)
    picked = rng.choice(pool, size=min(count, pool.size), replace=False) if pool.size else []
    return sorted({int(k) for k in picked} | {n - 1})


class MapUpdate:
    """The reference's map update of one frame at a given pose, as the
    program's splat step makes it (``engine/slam._splat_map_update`` without
    the prediction): the filtered depth, new blocks, the in-frustum list,
    and the integration (K4's plain version).  With `count_work` it also
    builds the frame's pyramid and counts its valid pixels, the listed
    blocks and the fused voxels.

    Returns (filtered depth, slots, slot validity, counts or None); on the
    card after ``LEAD_FRAMES`` frames these lie in a CUDA graph's memory and
    hold until the next call.  ``volume`` is the map after the last call."""

    def __init__(self, cfg, volume, count_work: bool):
        from reference.ops import blocks as rblocks

        self.cfg, self.volume, self.count_work = cfg, volume, count_work
        tcfg = cfg.tsdf
        self.k_list = min(tcfg.touched_capacity, rblocks.num_blocks_per_axis(tcfg) ** 3)
        self.graphed = volume.sdf.device.type == "cuda"
        self.eager = 0
        self.inputs = None
        self.graphs: dict = {}

    def _update(self, vol, d_k, c_k, T, col_gain):
        from reference.ops import blocks as rblocks
        from reference.ops import preprocess as rpre
        from reference.ops.kernels import tsdf as rktsdf

        cfg = self.cfg
        intr, tcfg = cfg.intrinsics, cfg.tsdf
        if self.count_work:
            pyr = rpre.build_frame_pyramid(d_k, intr, cfg.preprocess, cfg.icp.levels)
            d0 = pyr[0]["depth"]
        else:  # the map update reads the filtered depth alone
            d0 = rpre.bilateral_filter(rpre.clamp_depth(d_k, cfg.preprocess), cfg.preprocess)
        vol = rblocks.discover_allocate(vol, d0, T, intr, tcfg)
        slots, slot_valid = rblocks.frustum_slots(vol, T, intr, tcfg, cfg.raycast.near,
                                                  cfg.raycast.far, self.k_list)
        counts = None
        if self.count_work:
            z, pix, seen = rktsdf.project_voxels(vol.block_coords, slots, T, intr, tcfg)
            dpx = d0.reshape(-1)[pix]
            fused = (seen & (dpx > 0.0) & (dpx - z > -tcfg.trunc) & slot_valid[:, None]).sum()
            counts = torch.stack([p["valid"].sum() for p in pyr] + [slot_valid.sum(), fused])
        color, gain = col_gain
        vol = rblocks.integrate_slots(vol, slots, slot_valid, d0,
                                      c_k if color and cfg.use_color else None, T, intr, tcfg,
                                      color_gain=gain)
        return vol, (d0, slots, slot_valid, counts)

    def __call__(self, d_k, c_k, T, color: bool, gain: float):
        col_gain = (color, gain)
        if not self.graphed or self.eager < LEAD_FRAMES:
            self.eager += 1
            self.volume, out = self._update(self.volume, d_k, c_k, T, col_gain)
            return out
        if self.inputs is None:
            self.inputs = [d_k.clone(), c_k.clone(), T.clone()]
        else:
            for dst, src in zip(self.inputs, (d_k, c_k, T)):
                dst.copy_(src)
        if col_gain not in self.graphs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                new, out = self._update(self.volume, *self.inputs, col_gain)
                for name in VOLUME_FIELDS:
                    dst, src = getattr(self.volume, name), getattr(new, name)
                    if src is not dst:
                        dst.copy_(src)
            self.graphs[col_gain] = (graph, out)
        graph, out = self.graphs[col_gain]
        graph.replay()
        return out


class Judge:
    """Teacher-forced replay of the window at the served poses: numbers
    ``pose_mm``, ``pose_mrad``, ``track_fail``, the maps' and the
    predictions' gaps; with `count_work`, one work record a window frame
    (``harness/work.frame_stages``)."""

    def __init__(self, cell, seed: int, dev, count_work: bool):
        self.seed, self.samples = seed, cell.traffic["pose_samples"]
        self.count_work = count_work
        self.served = None

    def keep(self, res, counters) -> None:
        self.served = Served(poses=torch.as_tensor(res.poses, dtype=torch.float32),
                             volume=res.state.volume, pred=res.state.pred)

    def start(self, ctx) -> None:
        from reference.ops import blocks as rblocks

        cfg = ctx.cfg
        self.P = self.served.poses.to(ctx.dev, torch.float32)
        n = self.P.shape[0]
        self.pred_color = cfg.use_color and (cfg.raycast.predict_color or
                                             cfg.icp.rgb_weight > 0.0)
        self.picked = set(sample_frames(n, self.seed, self.samples))
        self.need_pred = set()
        for k in sorted(self.picked) + [n]:
            self.need_pred.update(range(max(0, k - PRIOR_FRAMES), k))
        if ctx.pred_frames:
            self.need_pred.update(range(max(ctx.pred_frames) + 1))
        self.mapper = MapUpdate(cfg, rblocks.allocate(cfg.tsdf, ctx.dev,
                                                      with_color=cfg.use_color),
                                self.count_work)
        self.pred = None
        self.gaps_t, self.gaps_r, self.ref_ok = [], [], []
        self.counts = []

    def frame(self, ctx) -> None:
        from reference.engine import slam as rslam
        from reference.ops import blocks as rblocks
        from reference.ops import icp as ricp
        from reference.ops import preprocess as rpre

        cfg, k, P = ctx.cfg, ctx.k, self.P
        intr, tcfg = cfg.intrinsics, cfg.tsdf
        d_k, c_k, pred = ctx.d_k, ctx.c_k, self.pred
        if k in self.picked:
            pyr = rpre.build_frame_pyramid(d_k, intr, cfg.preprocess, cfg.icp.levels)
            seed_T = rslam._motion_seed(P[k - 1], P[k - 2], cfg.icp.vel_seed)
            res = ricp.track(pyr, pred.vertex_w, pred.normal_w, pred.valid, seed_T, P[k - 1],
                             intr, cfg.icp)
            # As the step: a frame that fails the health gate keeps the pose.
            dt, dr = _pose_gap(P[k], torch.where(res.valid, res.T_wc, P[k - 1]))
            self.gaps_t.append(dt)
            self.gaps_r.append(dr)
            self.ref_ok.append(bool(res.valid))
        # The step's map update (engine/slam._splat_map_update) at the served pose.
        T = P[k]
        is_color, gain = cfg.use_color, 1.0
        if cfg.use_color and cfg.color_every > 1:
            is_color = k % cfg.color_every == 0
            gain = float(cfg.color_every) if is_color else 1.0
        d0, slots, slot_valid, frame_counts = self.mapper(d_k, c_k, T, is_color, gain)
        if self.count_work:
            self.counts.append((frame_counts.clone(), bool(is_color)))
        if k in self.need_pred:
            prior = torch.where(d0 > 0.0, d0,
                                pred.depth if pred is not None else torch.zeros_like(d0))
            # Color planes change no depth or validity: only the last
            # prediction, which is compared, carries them.
            pred = rblocks.raycast_splat(self.mapper.volume, T, intr, tcfg, slots, slot_valid,
                                         with_color=self.pred_color and k == ctx.n - 1,
                                         depth_prior=prior, rmax=cfg.raycast.splat_rmax)
        else:
            pred = None
        self.pred = pred
        ctx.T, ctx.d0, ctx.volume, ctx.pred = T, d0, self.mapper.volume, pred

    def finish(self, ctx) -> tuple[dict, list]:
        cfg = ctx.cfg
        intr = cfg.intrinsics
        work = []
        if self.count_work:
            pixels = [intr.level(lvl).width * intr.level(lvl).height
                      for lvl in range(cfg.icp.levels)]
            rows = torch.stack([c for c, _ in self.counts]).cpu().tolist()
            for (_, is_color), row in zip(self.counts, rows):
                work.append({"pixels": pixels, "valid": [int(x) for x in row[:-2]],
                             "k": self.mapper.k_list, "listed": int(row[-2]),
                             "fused": int(row[-1]), "color": is_color,
                             "pred_color": bool(self.pred_color)})
        numbers = {
            "pose_mm": 1e3 * max(self.gaps_t, default=0.0),
            "pose_mrad": 1e3 * max(self.gaps_r, default=0.0),
            "track_fail": float(sum(not ok for ok in self.ref_ok)),
        }
        numbers.update(compare_maps(self.served.volume, self.mapper.volume))
        numbers.update(compare_preds(self.served.pred, self.pred))
        return numbers, work


def counted_work(engine: dict, records: list, frames: int) -> tuple[float, float]:
    """(bytes, fp32 operations) of the counted work of the window's first
    `frames` frames (``harness/work.frame_stages``)."""
    n_bytes = n_flops = 0.0
    for rec in records[:frames]:
        for b, f in _work.frame_stages(engine, rec).values():
            n_bytes += b
            n_flops += f
    return n_bytes, n_flops


def _rows(plane: torch.Tensor, slots: torch.Tensor, fill: float) -> torch.Tensor:
    """Rows `slots` of a payload plane, `fill` where a slot is -1 (no block)."""
    rows = plane[slots.clamp(min=0).long()]
    return torch.where((slots >= 0)[:, None], rows, torch.full_like(rows, fill))


def compare_maps(prog, ref) -> dict:
    """Two block maps compared as functions of the voxel, over every block
    either holds: a block one map lacks reads as unobserved there (sdf 2,
    weight 0)."""
    dp, dr = prog.directory.reshape(-1), ref.directory.reshape(-1)
    ip, ir = dp >= 0, dr >= 0
    either = torch.nonzero(ip | ir)[:, 0]
    sp, sr = _rows(prog.sdf, dp[either], 2.0), _rows(ref.sdf, dr[either], 2.0)
    wp, wr = _rows(prog.weight, dp[either], 0.0), _rows(ref.weight, dr[either], 0.0)
    seen = (wp > 0) | (wr > 0)
    ds = (sp - sr).abs()[seen]
    dw = (wp - wr).abs()
    out = {
        "map_blocks_xor": float((ip ^ ir).sum()),
        "map_blocks": float(ir.sum()),
        "sdf_max": float(ds.max()) if ds.numel() else 0.0,
        "sdf_share_1e-3": float((ds > 1e-3).float().mean()) if ds.numel() else 0.0,
        "weight_max": float(dw.max()) if dw.numel() else 0.0,
    }
    if prog.color.numel() and ref.color.numel():
        b3 = sp.shape[1]
        cp = _rows(prog.color, dp[either], 0.0).reshape(-1, 3, b3)
        cr = _rows(ref.color, dr[either], 0.0).reshape(-1, 3, b3)
        dc = (cp - cr).abs().amax(1)[seen]
        out["color_max"] = float(dc.max()) if dc.numel() else 0.0
    return out


def compare_preds(prog, ref) -> dict:
    """Validity, vertices, normals and colors of two predictions."""
    vp, vr = prog.valid, ref.valid
    both = vp & vr
    dv = torch.linalg.norm(prog.vertex_w - ref.vertex_w, dim=-1)[both] * 1e3
    dn = torch.linalg.norm(prog.normal_w - ref.normal_w, dim=-1)[both]
    dc = (prog.color - ref.color).abs().amax(-1)[both]
    return {
        "pred_xor_pct": 100.0 * float((vp ^ vr).sum()) / max(float(vr.sum()), 1.0),
        "pred_vertex_p50_mm": _quantile(dv, 0.5),
        "pred_vertex_p99_mm": _quantile(dv, 0.99),
        "pred_vertex_max_mm": float(dv.max()) if dv.numel() else 0.0,
        "pred_normal_p99": _quantile(dn, 0.99),
        "pred_color_p99": _quantile(dc, 0.99),
    }
