"""SE(3)/SO(3) pose algebra on fp32 tensors (port of ``geometry/se3.py``).

Conventions as in the reference: poses are 4x4 matrices ``T`` with
``p_dst = T @ [p_src, 1]``, camera poses are camera-to-world ``T_wc``, and
twists are ``xi = [v, w]`` (translation first).  Every function takes a
leading batch shape.  Small-angle branches are blended with ``torch.where``
as in the reference, so no value ever leaves the device.

The functions that ``ops/ba.py`` differentiates (``se3_exp``, ``se3_log``,
``so3_log``, ``se3_inverse``, ``transform_points``) run under
``torch.func.vmap(torch.func.jacfwd(...))``: they build results out of
place, and every per-angle quantity keeps a trailing axis of size 1.  Under
forward-mode AD a Python scalar combined with a 0-dim tensor promotes the
tangent to float64 (the scalar loses its wrapped-number status), and a
per-example angle under ``vmap`` is 0-dim.
"""

from __future__ import annotations

import functools
import math

import torch

_EPS = 1e-8


def _skew(w: torch.Tensor) -> torch.Tensor:
    """[w]_x such that [w]_x @ p = w x p.  w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coeffs(theta2: torch.Tensor):
    """sin(t)/t, (1-cos t)/t^2 and their Taylor blends near t = 0."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    half_sin = torch.sin(0.5 * theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, 2.0 * half_sin * half_sin / theta2)
    return small, a, b


@functools.lru_cache(maxsize=None)
def _unit_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[[0, 0, 0, 1]] on `device`, made once by device fills (a tensor
    copied from the host would wait for the device)."""
    row = torch.zeros((1, 4), dtype=dtype, device=device)
    row[:, 3:].fill_(1.0)
    return row


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[R, t], [0, 1]]: (..., 3, 3), (..., 3) -> (..., 4, 4), out of place."""
    top = torch.cat([R, t[..., None]], dim=-1)
    row = _unit_row(top.dtype, top.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, row], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula. w: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    _, a, b = _exp_coeffs(theta2)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of Rodrigues' formula. R: (..., 3, 3) -> (..., 3) axis-angle.

    Three regimes as in the reference: series near 0, the closed form in
    the middle, and the axis from the largest column of (R + I)/2 near pi.
    """
    trace = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]  # (..., 1)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = cos_t > 1.0 - 5e-5
    near_pi = cos_t < -1.0 + 1e-4
    mid = ~(small | near_pi)

    safe_cos = torch.where(mid, cos_t, torch.zeros_like(cos_t))
    theta_mid = torch.arccos(safe_cos)
    scale_big = theta_mid / (2.0 * torch.sin(theta_mid) + _EPS)
    scale_small = 0.5 + (1.0 - cos_t) / 6.0
    w_regular = torch.where(small, scale_small, scale_big) * vee

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    B = 0.5 * (R + eye)
    diag_b = torch.diagonal(B, dim1=-2, dim2=-1)
    kbest = torch.argmax(diag_b, dim=-1)
    col = torch.gather(
        B, -1, kbest[..., None, None].expand(*B.shape[:-1], 1)
    )[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sgn = torch.sign(torch.sum(vee * axis, dim=-1, keepdim=True))
    axis = torch.where(sgn < 0.0, -axis, axis)
    sin_t = torch.sqrt(torch.sum(vee * vee, dim=-1, keepdim=True) + _EPS * _EPS) * 0.5
    theta_pi = math.pi - torch.arcsin(torch.clamp(sin_t, 0.0, 1.0 - 1e-6))
    w_pi = theta_pi * axis
    return torch.where(near_pi, w_pi, w_regular)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [v, w] (..., 6) -> (..., 4, 4) rigid transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small, a, b = _exp_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    K = _skew(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None] * K + b[..., None] * K2
    V = eye + b[..., None] * K + c[..., None] * K2
    t = (V @ v[..., None])[..., 0]
    return _rigid(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [v, w]. Inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small, a, b = _exp_coeffs(theta2)
    K = _skew(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    vinv_c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / torch.clamp(theta2, min=_EPS),
    )
    Vinv = eye - 0.5 * K + vinv_c[..., None] * K2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _rigid(Rt, -(Rt @ t[..., None])[..., 0])


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation part back onto SO(3) (Gram-Schmidt); the
    translation column and the bottom row stay T's own.

    Long products of exp-updates drift off the manifold in fp32, and a
    drifted rotation pushes trace(R) past 3, across ``so3_log``'s branch
    boundaries (pose-graph Gauss-Newton iterates through exactly that).
    """
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / torch.clamp(torch.linalg.norm(c0, dim=-1, keepdim=True), min=_EPS)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.clamp(torch.linalg.norm(c1, dim=-1, keepdim=True), min=_EPS)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    top = torch.cat([torch.stack([c0, c1, c2], dim=-1), T[..., :3, 3:]], dim=-1)
    return torch.cat([top, T[..., 3:, :]], dim=-2)


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (4,4) T to points (..., 3)."""
    return p @ T[:3, :3].T + T[:3, 3]


def cam_row(p: torch.Tensor, T: torch.Tensor, i: int) -> torch.Tensor:
    """Coordinate i of (4,4) T applied to points (..., 3), summed left to
    right one rounding at a time: ((x r0 + y r1) + z r2) + t.

    ``csrc/common.cuh``'s ``cam_row`` does the same without fused
    multiply-adds, so a kernel and its plain version place a point on the
    same pixel: at a .5 boundary or a tent edge a 1-ulp difference picks
    another pixel.
    """
    return ((p[..., 0] * T[i, 0] + p[..., 1] * T[i, 1]) + p[..., 2] * T[i, 2]) + T[i, 3]


def se3_inverse_rows(T: torch.Tensor) -> torch.Tensor:
    """``se3_inverse`` rounded in a fixed order: [R^T, t'] with coordinate
    j of t' = -(((R[0,j] t0) + R[1,j] t1) + R[2,j] t2), one rounding per
    operation; the bottom row is T's own ([0, 0, 0, 1] for a rigid T).

    ``csrc/common.cuh``'s ``se3_inverse_entry`` forms the same entries
    without fused multiply-adds, so a kernel that inverts the pose itself
    and a plain version that calls this one place every voxel on the same
    pixel (``se3_inverse``'s matrix product sums in no fixed order).
    """
    R, t = T[..., :3, :3], T[..., :3, 3:]
    t_inv = -((R[..., 0, :] * t[..., 0, :] + R[..., 1, :] * t[..., 1, :])
              + R[..., 2, :] * t[..., 2, :])
    top = torch.cat([R.transpose(-1, -2), t_inv[..., None]], dim=-1)
    return torch.cat([top, T[..., 3:, :]], dim=-2)


def cam_rows(p: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(4,4) T applied to points (..., 3): ``cam_row`` for all three
    coordinates at once, one broadcast operation per step."""
    return ((p[..., 0:1] * T[:3, 0] + p[..., 1:2] * T[:3, 1]) + p[..., 2:3] * T[:3, 2]) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of (4,4) T to vectors (..., 3)."""
    return n @ T[:3, :3].T
