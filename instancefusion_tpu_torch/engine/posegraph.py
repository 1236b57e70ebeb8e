"""Keyframe store, fern loop detection, ICP verification and graph
correction (port of ``engine/posegraph.py``).

The loop backend: keyframes keep a fern code and their decimated
camera-frame vertex and normal maps; a loop candidate comes from fern
retrieval, is verified by the tracking ICP (kernels K2 and K3) between the
current frame and the candidate's stored maps, and becomes a weighted edge
of the keyframe pose graph.  Corrections run pose-graph Gauss-Newton or
the joint pose-graph + landmark Schur BA of ``ops/ba.py``.

All state is fixed-capacity tensors on one device; the host driver
(``engine/pipeline.py``) decides when each piece runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.config import EngineConfig, PoseGraphConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.geometry.se3 import (
    rotate_vectors,
    se3_inverse,
    transform_points,
)
from instancefusion_tpu_torch.ops import ba, ferns, icp
from instancefusion_tpu_torch.ops.blocks import _set_with_spill, compact_mask_indices
from instancefusion_tpu_torch.ops.common import decimate


class KeyframeStore(NamedTuple):
    poses: torch.Tensor  # f32[M,4,4] T_wc at insertion (updated by BA)
    codes: torch.Tensor  # u8[M,F] fern codes
    vertex_c: torch.Tensor  # f32[M,h,w,3] decimated camera-frame vertices
    normal_c: torch.Tensor  # f32[M,h,w,3]
    valid: torch.Tensor  # bool[M,h,w]
    frame_idx: torch.Tensor  # i32[M]
    count: torch.Tensor  # () i32


class BackendState(NamedTuple):
    kf: KeyframeStore
    graph: ba.PoseGraph
    n_edges: torch.Tensor  # () i32
    coder: ferns.FernCoder
    n_loops: torch.Tensor  # () i32
    # Landmark bank for loop-closure BA (PoseGraphConfig.use_landmark_ba):
    # paired observations and world points appended per verified loop.
    points: torch.Tensor = None  # f32[Lcap, 3]
    lm: ba.PairedObs = None
    n_points: torch.Tensor = None  # () i32
    lm_dropped: torch.Tensor = None  # () i32 landmarks beyond capacity


def allocate(cfg: EngineConfig, decim: int = 4, seed: int = 0, device=None) -> BackendState:
    """An empty backend; the fern coder is drawn from a ``torch.Generator``
    seeded with `seed` on the backend's device (``cuda`` unless ``device``
    says otherwise)."""
    dev = _device.resolve(device)
    pg = cfg.posegraph
    intr = cfg.intrinsics
    h, w = intr.height // decim, intr.width // decim
    m = pg.max_keyframes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    zeros = dict(dtype=torch.float32, device=dev)
    return BackendState(
        kf=KeyframeStore(
            poses=torch.eye(4, **zeros).repeat(m, 1, 1),
            codes=torch.zeros((m, pg.fern_count), dtype=torch.uint8, device=dev),
            vertex_c=torch.zeros((m, h, w, 3), **zeros),
            normal_c=torch.zeros((m, h, w, 3), **zeros),
            valid=torch.zeros((m, h, w), dtype=torch.bool, device=dev),
            frame_idx=torch.zeros((m,), dtype=torch.int32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
        ),
        graph=ba.empty_graph(pg.max_edges, dev),
        n_edges=torch.zeros((), dtype=torch.int32, device=dev),
        coder=ferns.make_coder(gen, intr.height, intr.width, pg.fern_count),
        n_loops=torch.zeros((), dtype=torch.int32, device=dev),
        points=torch.zeros((pg.max_landmarks, 3), **zeros),
        lm=ba.empty_paired_obs(pg.max_landmarks, dev),
        n_points=torch.zeros((), dtype=torch.int32, device=dev),
        lm_dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _pick(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a device index `i` (a 0-dim tensor or an int), without a
    host read."""
    idx = torch.as_tensor(i, device=x.device).reshape(1).long()
    return x.index_select(0, idx)[0]


def add_keyframe(bs: BackendState, T_wc: torch.Tensor, color: torch.Tensor,
                 depth: torch.Tensor, vertex_c: torch.Tensor, normal_c: torch.Tensor,
                 decim: int = 4) -> BackendState:
    """Insert a keyframe: fern code, decimated geometry and the odometry
    edge from the previous keyframe (weight 1; verified loop edges weigh
    more).  At capacity the last slot is overwritten.

    The keyframe store is written in place (its maps are the backend's
    bulk): rebind the result and do not use `bs`'s store after the call.
    """
    kf = bs.kf
    code = ferns.encode(bs.coder, color, depth)
    v = decimate(vertex_c, decim)
    n = decimate(normal_c, decim)
    val = (decimate(depth, decim) > 0.0) & (torch.linalg.norm(n, dim=-1) > 1e-6)
    i = torch.clamp(kf.count, max=kf.poses.shape[0] - 1)
    slot = i.reshape(1).long()
    for store, row in ((kf.poses, T_wc), (kf.codes, code), (kf.vertex_c, v),
                       (kf.normal_c, n), (kf.valid, val), (kf.frame_idx, kf.count)):
        store.index_copy_(0, slot, row.reshape((1,) + store.shape[1:]).to(store.dtype))
    kf = kf._replace(count=torch.clamp(kf.count + 1, max=kf.poses.shape[0]))
    # Odometry edge (i-1 -> i) from the tracked poses.
    prev = torch.clamp(i - 1, min=0)
    T_rel = se3_inverse(_pick(kf.poses, prev)) @ T_wc
    graph, n_edges = ba.add_edge(bs.graph, bs.n_edges, prev, i, T_rel, 1.0)
    has_prev = i > 0
    graph = ba.PoseGraph(*(torch.where(has_prev, new, old)
                           for new, old in zip(graph, bs.graph)))
    n_edges = torch.where(has_prev, n_edges, bs.n_edges)
    return bs._replace(kf=kf, graph=graph, n_edges=n_edges)


def detect_loop(bs: BackendState, color: torch.Tensor, depth: torch.Tensor,
                min_gap: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Fern retrieval for the current frame: (best keyframe index,
    dissimilarity), excluding the `min_gap` most recent keyframes."""
    code = ferns.encode(bs.coder, color, depth)
    m = bs.kf.codes.shape[0]
    used = torch.arange(m, device=code.device) < bs.kf.count
    return ferns.find_best(code, bs.kf.codes, used, bs.kf.count - min_gap)


def decimated_min_valid(min_valid: int, decim: int) -> int:
    """The tracking-health pixel gate at a decimated resolution: twice the
    proportional count (min_valid / decim^2), because a loop edge feeds the
    pose graph at 10x odometry weight and a marginal verification costs far
    more than a rejected loop."""
    return max(1, min_valid // max(decim * decim // 2, 1))


def _decimated_intrinsics(intr: Intrinsics, decim: int) -> Intrinsics:
    return Intrinsics(
        fx=intr.fx / decim, fy=intr.fy / decim,
        cx=(intr.cx + 0.5) / decim - 0.5, cy=(intr.cy + 0.5) / decim - 0.5,
        width=intr.width // decim, height=intr.height // decim,
    )


def verify_loop(bs: BackendState, cand, vertex_c: torch.Tensor, normal_c: torch.Tensor,
                intr: Intrinsics, cfg: EngineConfig, T_cur_wc: torch.Tensor | None = None):
    """ICP of the current frame against the candidate keyframe's stored maps.

    Returns (T_rel (4,4) = T_kf^-1 T_cur, inliers, ok).  One pyramid level
    at the keyframes' decimated resolution, ``ba_iters`` Gauss-Newton steps
    with association before each (K2, then K3 with ``inner_n`` 1), from
    `T_cur_wc` (default the keyframe's pose).
    """
    decim = vertex_c.shape[0] // bs.kf.vertex_c.shape[1]
    kf_pose = _pick(bs.kf.poses, cand)
    kv, kn = _pick(bs.kf.vertex_c, cand), _pick(bs.kf.normal_c, cand)
    tv = transform_points(kf_pose, kv.reshape(-1, 3)).reshape(kv.shape)
    tn = rotate_vectors(kf_pose, kn.reshape(-1, 3)).reshape(kv.shape)
    tval = _pick(bs.kf.valid, cand)
    intr_d = _decimated_intrinsics(intr, decim)
    src_v = decimate(vertex_c, decim)
    src_n = decimate(normal_c, decim)
    src_val = (src_v[..., 2] > 0.0) & (torch.linalg.norm(src_n, dim=-1) > 1e-6)
    T0 = kf_pose if T_cur_wc is None else T_cur_wc
    icp_cfg = type(cfg.icp)(
        iters=(cfg.posegraph.ba_iters,), levels=1,
        dist_thresh=cfg.icp.dist_thresh * 2.0, angle_thresh=cfg.icp.angle_thresh,
        rgb_weight=0.0, damping=cfg.icp.damping,
        min_valid=decimated_min_valid(cfg.icp.min_valid, decim),
    )
    result = icp.track([{"vmap": src_v, "nmap": src_n, "valid": src_val}], tv, tn, tval,
                       T0, kf_pose, intr_d, icp_cfg)
    T_rel = se3_inverse(kf_pose) @ result.T_wc
    min_inl = intr_d.width * intr_d.height * 0.2
    ok = result.valid & (result.inliers > min_inl) & (result.residual < cfg.tsdf.voxel_size)
    return T_rel, result.inliers, ok


def add_loop_edge(bs: BackendState, kf_i, kf_j, T_rel: torch.Tensor,
                  weight: float = 10.0) -> BackendState:
    graph, n_edges = ba.add_edge(bs.graph, bs.n_edges, kf_i, kf_j, T_rel, weight)
    return bs._replace(graph=graph, n_edges=n_edges, n_loops=bs.n_loops + 1)


def build_loop_landmarks(bs: BackendState, kf_i, kf_j, T_rel: torch.Tensor,
                         intr: Intrinsics, cfg: EngineConfig):
    """Sample paired landmark observations across a verified loop pair.

    Up to ``landmarks_per_loop`` pixels spread evenly over keyframe i's
    valid decimated pixels (every (hw/L)-th of them in scan order) are
    lifted to world points at i's pose and associated into keyframe j's
    stored maps through the verified relative pose.  Measurements are the
    raw camera-frame vertices; a pair is valid where it projects into j's
    image onto a valid pixel within ``icp.dist_thresh`` in 3D with agreeing
    normals.  Returns (points (L,3) world, PairedObs).
    """
    pgc = cfg.posegraph
    L = pgc.landmarks_per_loop
    v_i, n_i = _pick(bs.kf.vertex_c, kf_i), _pick(bs.kf.normal_c, kf_i)
    val_i = _pick(bs.kf.valid, kf_i)
    v_j, n_j = _pick(bs.kf.vertex_c, kf_j), _pick(bs.kf.normal_c, kf_j)
    val_j = _pick(bs.kf.valid, kf_j)
    h, w = val_i.shape
    intr_d = _decimated_intrinsics(intr, intr.height // h)

    per = max(1, (h * w) // max(L, 1))
    cidx, cok = compact_mask_indices(val_i.reshape(-1), per * L)
    pix = cidx.reshape(L, per)[:, 0].long()
    ok = cok.reshape(L, per)[:, 0]

    za = v_i.reshape(-1, 3).index_select(0, pix)  # measured in i's camera frame
    na = n_i.reshape(-1, 3).index_select(0, pix)
    T_ji = se3_inverse(T_rel)  # j <- i
    p_cj = transform_points(T_ji, za)
    nb_in_j = rotate_vectors(T_ji, na)
    z = torch.clamp(p_cj[:, 2], min=1e-6)
    u = intr_d.fx * p_cj[:, 0] / z + intr_d.cx
    v = intr_d.fy * p_cj[:, 1] / z + intr_d.cy
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    in_img = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (p_cj[:, 2] > 0)
    flat = (torch.clamp(vi, 0, h - 1) * w + torch.clamp(ui, 0, w - 1)).long()
    zb = v_j.reshape(-1, 3).index_select(0, flat)  # measured in j's camera frame
    nb = n_j.reshape(-1, 3).index_select(0, flat)
    dist_ok = torch.linalg.norm(p_cj - zb, dim=-1) < cfg.icp.dist_thresh
    norm_ok = torch.sum(nb_in_j * nb, dim=-1) > 0.6
    valid = ok & in_img & val_j.reshape(-1).index_select(0, flat) & dist_ok & norm_ok

    points = transform_points(_pick(bs.kf.poses, kf_i), za)  # world, at i's pose
    dev = za.device

    def full_index(k):
        return torch.as_tensor(k, dtype=torch.int32, device=dev).reshape(1).expand(L)

    obs = ba.PairedObs(
        ka=full_index(kf_i), kb=full_index(kf_j), za=za, zb=zb,
        weight=torch.full((L,), pgc.landmark_weight, device=dev), valid=valid,
    )
    return points, obs


def add_loop_landmarks(bs: BackendState, points: torch.Tensor,
                       obs: ba.PairedObs) -> BackendState:
    """Append a loop's valid landmarks, compacted, to the fixed-capacity
    bank; those beyond ``max_landmarks`` are dropped and counted in
    ``lm_dropped``."""
    cap = bs.points.shape[0]
    order = torch.cumsum(obs.valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = bs.n_points + order
    fits = obs.valid & (slot < cap)
    out = torch.where(fits, slot, torch.full_like(slot, cap))  # cap = the spill row
    n_new = torch.sum(fits, dtype=torch.int32)
    n_drop = torch.sum(obs.valid, dtype=torch.int32) - n_new
    lm = ba.PairedObs(*(_set_with_spill(old, out, new) for old, new in
                        zip(bs.lm, (*obs[:5], torch.ones_like(obs.valid)))))
    return bs._replace(points=_set_with_spill(bs.points, out, points), lm=lm,
                       n_points=bs.n_points + n_new, lm_dropped=bs.lm_dropped + n_drop)


def _keep_unused(bs: BackendState, poses: torch.Tensor) -> torch.Tensor:
    """Rows at or beyond the keyframe count keep their old poses."""
    used = torch.arange(poses.shape[0], device=poses.device) < bs.kf.count
    return torch.where(used[:, None, None], poses, bs.kf.poses)


def optimize(bs: BackendState, cfg: PoseGraphConfig):
    """Gauss-Newton over all keyframe poses; returns (state, final cost)."""
    poses, cost = ba.optimize_pose_graph(bs.kf.poses, bs.graph, iters=cfg.ba_iters)
    return bs._replace(kf=bs.kf._replace(poses=_keep_unused(bs, poses))), cost


def optimize_landmark(bs: BackendState, cfg: PoseGraphConfig, terms_fn=None):
    """Joint pose-graph + landmark Schur BA over the whole backend: the edges
    anchor the odometry chain, the bank's paired observations re-estimate
    the loop pairs' geometry.  With an empty bank this is ``optimize``.
    Returns (state, final cost)."""
    poses, points, cost = ba.optimize_hybrid_paired(
        bs.kf.poses, bs.graph, bs.points, bs.lm, iters=cfg.ba_iters, terms_fn=terms_fn)
    return bs._replace(kf=bs.kf._replace(poses=_keep_unused(bs, poses)),
                       points=points), cost
