"""Frame-to-model tracking: projective point-to-plane ICP (port of ``ops/icp.py``).

New-frame pixels are moved by the current pose estimate, projected into
the predicted model view and associated with the predicted vertex and
normal there, all in one launch of kernel K2 per association round, and
the pose is refined by Gauss-Newton steps on those fixed correspondences
(kernel K3), coarse to fine.  Association re-runs
every ``IcpConfig.assoc_every`` steps.  Everything stays on the device: the
health gate and the pose choice are ``torch.where``, never a host branch.

With ``rgb_weight > 0`` and a predicted intensity, the photometric term
(the reference's rgbStep) joins: K2 also gathers the predicted intensity
and its gradients, and K3 adds the photometric system at the trust
fraction ``rgb_weight``.  ``reduce_equations`` and
``build_normal_equations``, the one-linearization entry points, reach
kernel K6; no per-frame path calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.config import IcpConfig
from reference.geometry.camera import Intrinsics
from reference.geometry.se3 import (
    rotate_vectors,
    se3_inverse,
    transform_points,
)
from reference.ops.common import decimate, interior
from reference.ops.kernels.icp import (  # noqa: F401 (association_inputs)
    associate_gather,
    association_inputs,
    gn_iterations,
    normal_equations,
    rgb_normal_equations_ref,
    solve_increment as _solve,
)


class TrackResult(NamedTuple):
    T_wc: torch.Tensor  # (4,4) tracked pose
    inliers: torch.Tensor  # () f32 associated pixel count at the finest level
    residual: torch.Tensor  # () f32 mean |point-to-plane residual| (m)
    valid: torch.Tensor  # () bool tracking-health gate passed


def associate(
    vmap_src_c: torch.Tensor,  # (H,W,3) new-frame vertices, camera frame
    valid_src: torch.Tensor,  # (H,W)
    tgt_vertex_w: torch.Tensor,  # (Ht,Wt,3) predicted vertices, world frame
    tgt_normal_w: torch.Tensor,  # (Ht,Wt,3) predicted normals, world frame
    tgt_valid: torch.Tensor,  # (Ht,Wt)
    T_est_wc: torch.Tensor,  # (4,4) current estimate for the new frame
    T_tgt_cw: torch.Tensor,  # (4,4) world->camera of the prediction view
    intr: Intrinsics,
    tgt_rgb=None,  # optional (intensity, gx, gy) target planes (Ht,Wt)
):
    """Projective data association (kernel K2); returns (q_w (HW,3),
    n_t (HW,3), ok (HW,)).

    The target pixel is the nearest one, rounding half up (ceil(x - 0.5)).
    With ``tgt_rgb`` the photometric targets ride the same launch and the
    return gains (i_t, gx_t, gy_t, ok), each (HW,).
    """
    a = associate_gather(
        vmap_src_c.reshape(-1, 3).contiguous(), valid_src.reshape(-1).contiguous(),
        T_est_wc.contiguous(), T_tgt_cw.contiguous(), intr, tgt_vertex_w.contiguous(),
        tgt_normal_w.contiguous(), tgt_valid.contiguous(), 1,
        None if tgt_rgb is None else tuple(p.contiguous() for p in tgt_rgb),
    )
    if tgt_rgb is None:
        return a.q_w, a.n_t, a.ok
    return a.q_w, a.n_t, a.ok, (*a.rgb, a.ok)


def reduce_equations(vmap_src_c, nmap_src_c, valid_src, q_w, n_t, assoc_valid,
                     T_est_wc, cfg: IcpConfig):
    """One Gauss-Newton linearization on fixed correspondences (kernel K6).

    Returns (H 6x6, b 6, inliers, sum |r| w); J = [n, p_w x n].
    """
    p_w = transform_points(T_est_wc, vmap_src_c.reshape(-1, 3))
    n_w = rotate_vectors(T_est_wc, nmap_src_c.reshape(-1, 3))
    dist = torch.linalg.norm(p_w - q_w, dim=-1)
    n_dot = torch.sum(n_w * n_t, dim=-1)
    mask = (valid_src.reshape(-1) & assoc_valid & (dist < cfg.dist_thresh)
            & (n_dot > cfg.angle_thresh))
    return normal_equations(p_w.contiguous(), n_t.contiguous(), q_w.contiguous(),
                            mask.float(), cfg.huber_delta)


def build_normal_equations(vmap_src_c, nmap_src_c, valid_src, tgt_vertex_w,
                           tgt_normal_w, tgt_valid, T_est_wc, T_tgt_cw,
                           intr: Intrinsics, cfg: IcpConfig):
    """One ICP linearization with fresh association (associate + reduce)."""
    q_w, n_t, assoc_valid = associate(
        vmap_src_c, valid_src, tgt_vertex_w, tgt_normal_w, tgt_valid,
        T_est_wc, T_tgt_cw, intr,
    )
    return reduce_equations(vmap_src_c, nmap_src_c, valid_src, q_w, n_t,
                            assoc_valid, T_est_wc, cfg)


def intensity_gradients(tgt_intensity: torch.Tensor):
    """Central-difference image gradients of the predicted intensity.

    Border rows and columns are zeroed: a zero gradient makes a border
    correspondence contribute nothing to the photometric system.
    """
    h, w = tgt_intensity.shape
    gx = 0.5 * (torch.roll(tgt_intensity, -1, 1) - torch.roll(tgt_intensity, 1, 1))
    gy = 0.5 * (torch.roll(tgt_intensity, -1, 0) - torch.roll(tgt_intensity, 1, 0))
    inside = interior(h, w, tgt_intensity.device)
    zero = torch.zeros_like(gx)
    return torch.where(inside, gx, zero), torch.where(inside, gy, zero)


def reduce_rgb_equations(vmap_src_c, intensity_src, i_t, gx_t, gy_t, rgb_valid,
                         T_est_wc, T_tgt_cw, intr: Intrinsics):
    """Photometric GN system on fixed gathered targets: r = I_t - I_src.

    Returns (H 6x6, b 6, gated pixels, sum |r| over them).
    """
    p_w = transform_points(T_est_wc, vmap_src_c.reshape(-1, 3))
    return rgb_normal_equations_ref(p_w, T_tgt_cw, intr.fx, intr.fy,
                                    intensity_src.reshape(-1), i_t, gx_t, gy_t,
                                    rgb_valid.float())


def solve_increment(H6, b6, cfg: IcpConfig):
    """Damped 6x6 solve; returns xi (6,), zero when not finite."""
    return _solve(H6, b6, cfg.damping)


def level_schedule(cfg: IcpConfig, lvl: int) -> tuple[int, int]:
    """(inner_n, outer_n) at pyramid level `lvl`: GN steps per association
    and association rounds."""
    idx = max(0, min(cfg.levels - 1 - lvl, len(cfg.iters) - 1))
    n_it = cfg.iters[idx]
    ae = cfg.assoc_every
    if isinstance(ae, tuple):
        ae = ae[min(idx, len(ae) - 1)]
    inner_n = max(1, min(ae, n_it))
    return inner_n, -(-n_it // inner_n)


def track(
    src_pyramid,  # list over levels (fine->coarse) of preprocess dicts
    pred_vertex_w: torch.Tensor,  # full-res prediction maps (world frame)
    pred_normal_w: torch.Tensor,
    pred_valid: torch.Tensor,
    T_init_wc: torch.Tensor,
    T_pred_wc: torch.Tensor,  # pose the prediction was rendered from
    intr: Intrinsics,
    cfg: IcpConfig,
    pred_intensity: torch.Tensor | None = None,  # full-res predicted intensity
) -> TrackResult:
    """Coarse-to-fine projective ICP against the predicted model view.

    The photometric term joins when ``cfg.rgb_weight > 0`` and a predicted
    intensity is given; the source pyramid then carries 'intensity'.
    """
    T_pred_cw = se3_inverse(T_pred_wc)
    use_rgb = cfg.rgb_weight > 0.0 and pred_intensity is not None
    # K2 reads the full-resolution prediction at each level's stride.
    tgt = [x.contiguous() for x in (pred_vertex_w, pred_normal_w, pred_valid)]
    T = T_init_wc.contiguous()
    inliers = res_mean = None
    for lvl in range(cfg.levels - 1, -1, -1):  # coarse -> fine
        src = src_pyramid[lvl]
        intr_l = intr.level(lvl)
        src_v = src["vmap"].reshape(-1, 3).contiguous()
        src_n = src["nmap"].reshape(-1, 3).contiguous()
        src_ok = src["valid"].reshape(-1).contiguous()
        tgt_rgb = None
        if use_rgb:
            ti = decimate(pred_intensity, 1 << lvl).contiguous()
            tgt_rgb = (ti, *intensity_gradients(ti))
            i_src = src["intensity"].reshape(-1).contiguous()
        inner_n, outer_n = level_schedule(cfg, lvl)
        for _ in range(outer_n):
            a = associate_gather(src_v, src_ok, T, T_pred_cw, intr_l, *tgt, 1 << lvl,
                                 tgt_rgb)
            rgb_kw = {}
            if use_rgb:
                rgb_kw = dict(rgb=(i_src, *a.rgb, a.gate), T_pred_cw=T_pred_cw,
                              rgb_intr=(intr_l.fx, intr_l.fy), rgb_weight=cfg.rgb_weight)
            T, inliers, res_sum = gn_iterations(
                src_v, src_n, a.q_w, a.n_t, a.gate, T,
                inner_n=inner_n, dist_thresh=cfg.dist_thresh,
                angle_thresh=cfg.angle_thresh, huber_delta=cfg.huber_delta,
                damping=cfg.damping, min_valid=cfg.min_valid, **rgb_kw,
            )
        res_mean = res_sum / torch.clamp(inliers, min=1.0)
    ok = (inliers >= cfg.min_valid) & torch.all(torch.isfinite(T))
    return TrackResult(
        T_wc=torch.where(ok, T, T_init_wc), inliers=inliers,
        residual=res_mean, valid=ok,
    )
