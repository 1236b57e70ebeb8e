"""ICP kernels K2 (the projective association of one pyramid level), K3
(Gauss-Newton iterations) and K6 (the normal equations of one
linearization).

Each wrapper runs its CUDA kernel (``csrc/icp.cu``) for CUDA tensors and its
plain PyTorch version, the ``*_ref`` function beside it, for CPU tensors; it
never falls back from one to the other.  A plain version stays plain: it
launches no kernel whatever its tensors' device, so the kernel can be held
against it on the card.  ``launches`` on each wrapper counts the calls that
launched its kernel; ``launches_rgb`` on K2 and K3 counts those among them
that carried the photometric planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.geometry.camera import Intrinsics, project
from reference.geometry.se3 import cam_row, se3_exp


# --------------------------------------------------------------------- K2


class Association(NamedTuple):
    q_w: torch.Tensor  # f32[N, 3] associated target vertex (world frame)
    n_t: torch.Tensor  # f32[N, 3] associated target normal
    ok: torch.Tensor  # bool[N] source pixel associated with a valid target
    gate: torch.Tensor  # f32[N] ``ok`` as 0/1: the gate K3 reads
    rgb: tuple | None  # (i_t, gx_t, gy_t), each f32[N], with the photometric planes


def association_inputs(vmap_src_c, valid_src, T_est_wc, T_tgt_cw, intr: Intrinsics):
    """Projected target coordinates (u, v) and the pixels worth gathering
    (valid source, in the target image, in front of its camera).

    Both transforms run component-wise (``cam_row``), one rounding per
    operation, as K2 computes them: the target pixel is the nearest one,
    and a different rounding of the projection would pick the neighbour
    at a .5 boundary.
    """
    p_c = vmap_src_c.reshape(-1, 3)
    p_w = torch.stack([cam_row(p_c, T_est_wc, i) for i in range(3)], -1)
    u, v, z = project(intr, torch.stack([cam_row(p_w, T_tgt_cw, i) for i in range(3)], -1))
    uf, vf = torch.ceil(u - 0.5), torch.ceil(v - 0.5)
    in_img = (uf >= 0) & (uf < intr.width) & (vf >= 0) & (vf < intr.height)
    return u, v, valid_src.reshape(-1) & in_img & (z > 0.0)


def gather_target_maps_ref(u, v, sel, tgt_vertex, tgt_normal, tgt_valid,
                           tgt_rgb=None):
    """The gather of plain K2 on given target maps: nearest target pixel,
    rounding half up, clamped into the map.

    Gathers at (ceil(v - 0.5), ceil(u - 0.5)); valid = target valid & sel.
    With ``tgt_rgb`` = (intensity, gx, gy) planes it also gathers those at
    the same pixel.  Equal, bit for bit, to the direct-gather branch of the
    reference's ``ops/icp.associate``.
    """
    ht, wt = tgt_valid.shape

    def index(x, n):
        return torch.nan_to_num(torch.ceil(x - 0.5)).clamp(0, n - 1).long()

    flat = index(v, ht) * wt + index(u, wt)
    q = tgt_vertex.reshape(-1, 3)[flat]
    n_t = tgt_normal.reshape(-1, 3)[flat]
    ok = tgt_valid.reshape(-1)[flat] & sel
    if tgt_rgb is None:
        return q, n_t, ok
    return q, n_t, ok, tuple(p.reshape(-1)[flat] for p in tgt_rgb)


def associate_gather_ref(src_v, src_valid, T_est_wc, T_tgt_cw, intr: Intrinsics,
                         tgt_vertex, tgt_normal, tgt_valid, stride: int = 1,
                         tgt_rgb=None) -> Association:
    """Plain K2: ``association_inputs``, then the nearest-pixel gather from
    the full-resolution target maps at the level's stride: target pixel
    (vi s, ui s) with (vi, ui) clamped into the decimated map
    (``ops/common.decimate``'s floor shapes).  The photometric planes are
    the level's own, indexed at (vi, ui).
    """
    u, v, sel = association_inputs(src_v, src_valid, T_est_wc, T_tgt_cw, intr)
    ht, wt = tgt_valid.shape
    hl, wl = ht // stride, wt // stride

    def index(x, n):
        return torch.nan_to_num(torch.ceil(x - 0.5)).clamp(0, n - 1).long()

    vi, ui = index(v, hl), index(u, wl)
    flat = vi * stride * wt + ui * stride
    ok = tgt_valid.reshape(-1)[flat] & sel
    rgb = None
    if tgt_rgb is not None:
        rgb = tuple(p.reshape(-1)[vi * wl + ui] for p in tgt_rgb)
    return Association(tgt_vertex.reshape(-1, 3)[flat], tgt_normal.reshape(-1, 3)[flat],
                       ok, ok.float(), rgb)


# ------------------------------------------------------------------ K6, K3


def normal_equations_ref(p_w, n_t, q_w, mask, huber_delta: float):
    """Plain K6: the 29 point-to-plane sums as (H 6x6, b 6, inliers, sum |r| w).

    p_w: transformed source points, q_w/n_t: associated target points and
    normals, mask: f32 gate.  J = [n, p x n], left world-frame increment,
    w = mask x Huber weight.
    """
    diff = p_w - q_w
    r = torch.sum(n_t * diff, dim=-1)
    J = torch.cat([n_t, torch.linalg.cross(p_w, n_t)], dim=-1)
    if huber_delta > 0.0:
        w = mask * torch.clamp(huber_delta / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
    else:
        w = mask
    Jm = J * torch.sqrt(w)[:, None]
    H6 = Jm.T @ Jm
    b6 = -(J.T @ (r * w)[:, None])[:, 0]
    return H6, b6, torch.sum(mask), torch.sum(torch.abs(r) * w)


def rgb_normal_equations_ref(p_w, T_pred_cw, fx: float, fy: float, i_src, i_t,
                             gx_t, gy_t, gate):
    """Plain photometric sums at world points p_w (N, 3), the photometric
    half of K3: residual I_t - I_src against targets gathered at
    association time, J = [g, p_w x g] with g = dI/dp_w through the
    projection of the prediction view (T_pred_cw, fx, fy of the level),
    gated by ``gate`` (f32 0/1) and a positive prediction-camera depth.

    Returns (H 6x6, b 6, sum of the gate, sum |r| over it).
    """
    p_c = p_w @ T_pred_cw[:3, :3].T + T_pred_cw[:3, 3]
    zs = torch.clamp(p_c[:, 2], min=1e-6)
    gpx = gx_t * fx / zs
    gpy = gy_t * fy / zs
    gpz = -(gpx * p_c[:, 0] + gpy * p_c[:, 1]) / zs
    gw = torch.stack([gpx, gpy, gpz], dim=-1) @ T_pred_cw[:3, :3]
    J = torch.cat([gw, torch.linalg.cross(p_w, gw)], dim=-1)
    r = i_t - i_src
    m = gate * (p_c[:, 2] > 0.0).float()
    Jm = J * m[:, None]
    H6 = Jm.T @ Jm
    b6 = -(Jm.T @ (r * m)[:, None])[:, 0]
    return H6, b6, torch.sum(m), torch.sum(torch.abs(r) * m)


def _gn_steps_ref(src_v, src_n, q_w, n_t, gate, T_init, *, inner_n, dist_thresh,
                  angle_thresh, huber_delta, damping, min_valid, rgb=None,
                  T_pred_cw=None, rgb_intr=None, rgb_weight=0.0):
    """Plain K3 steps; returns (T, inliers, sum |r| w, wr) of the last step,
    wr the photometric trust-fraction weight (0 without ``rgb``)."""
    T = T_init
    wr = torch.zeros((), dtype=torch.float32, device=src_v.device)
    for _ in range(inner_n):
        R, t = T[:3, :3], T[:3, 3]
        p_w = src_v @ R.T + t
        n_w = src_n @ R.T
        dist = torch.linalg.norm(p_w - q_w, dim=-1)
        n_dot = torch.sum(n_w * n_t, dim=-1)
        mask = gate * ((dist < dist_thresh) & (n_dot > angle_thresh)).float()
        H6, b6, nin, rsum = normal_equations_ref(p_w, n_t, q_w, mask, huber_delta)
        if rgb is not None:
            Hr, br, _, _ = rgb_normal_equations_ref(p_w, T_pred_cw, *rgb_intr, *rgb)
            # Trust-fraction combine: the photometric JtJ scales with fx^2,
            # so it joins at the share rgb_weight of the joint information.
            wr = rgb_weight * torch.trace(H6) / torch.clamp(torch.trace(Hr), min=1e-20)
            H6 = H6 + wr * Hr
            b6 = b6 + wr * br
        xi = solve_increment(H6, b6, damping)
        xi = torch.where(nin >= min_valid, xi, torch.zeros_like(xi))
        T = se3_exp(xi) @ T
    return T, nin, rsum, wr


def solve_increment(H6, b6, damping: float):
    """Damped 6x6 solve; a non-finite solution becomes the zero twist."""
    damp = damping * torch.clamp(torch.diagonal(H6), min=1.0)
    xi, _ = torch.linalg.solve_ex(H6 + torch.diag(damp), b6)
    return torch.where(torch.all(torch.isfinite(xi)), xi, torch.zeros_like(xi))


def gn_iterations_ref(src_v, src_n, q_w, n_t, gate, T_init, *, inner_n,
                      dist_thresh, angle_thresh, huber_delta, damping,
                      min_valid, rgb=None, T_pred_cw=None, rgb_intr=None,
                      rgb_weight=0.0):
    """Plain K3: ``inner_n`` GN steps on fixed correspondences.

    The reference's ``ops/icp.track`` inner_body: gate by distance and
    normal angle, reduce (``normal_equations_ref``), join the photometric
    system at the trust fraction when ``rgb`` is given, damped solve, zero
    the step unless inliers >= min_valid, and update the pose on the left
    by exp(xi).  Returns (T, inliers, sum |r| w) of the last step.
    """
    return _gn_steps_ref(
        src_v, src_n, q_w, n_t, gate, T_init, inner_n=inner_n,
        dist_thresh=dist_thresh, angle_thresh=angle_thresh,
        huber_delta=huber_delta, damping=damping, min_valid=min_valid, rgb=rgb,
        T_pred_cw=T_pred_cw, rgb_intr=rgb_intr, rgb_weight=rgb_weight,
    )[:3]


# The kernels' entry points, bound to their plain versions.
associate_gather = associate_gather_ref
normal_equations = normal_equations_ref
gn_iterations = gn_iterations_ref
