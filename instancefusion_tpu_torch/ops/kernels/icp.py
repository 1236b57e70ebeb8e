"""ICP kernels K2 (the projective association of one pyramid level), K3
(Gauss-Newton iterations) and K6 (the normal equations of one
linearization).

Each wrapper runs its CUDA kernel (``csrc/icp.cu``) for CUDA tensors and its
plain PyTorch version, the ``*_ref`` function beside it, for CPU tensors; it
never falls back from one to the other.  A plain version stays plain: it
launches no kernel whatever its tensors' device, so the kernel can be held
against it on the card.  ``launches`` on each wrapper counts the calls that
launched its kernel; ``launches_rgb`` on K2 and K3 counts those among them
that carried the photometric planes.  A count grows when a wrapper is
called, eagerly or inside a CUDA-graph capture; a replay of the graph
launches the kernel again without a call and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from instancefusion_tpu_torch.geometry.camera import Intrinsics, project
from instancefusion_tpu_torch.geometry.se3 import cam_row, se3_exp
from instancefusion_tpu_torch.ops.kernels import _build

_ROW = 64  # partials row stride (floats): 29 geometric + 27 photometric sums
_NE_OUT = 44  # K6 output: H 36, b 6, inliers, sum |r| w
_GN_OUT = 19  # K3 output: T 16, then the last step's inliers, sum |r| w, wr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_associate": [_P, _P, _I, _P, _P] + [_F] * 4 + [_I] * 2 + [_P] * 6
                     + [_I] * 4 + [_P, _P],
    "ifl_gn_grid": [_P],
    "ifl_gn_iterations": [_P] * 11 + [_I, _P, _P, _I, _P, _I] + [_F] * 8 + [_P],
    "ifl_normal_equations": [_P] * 4 + [_I, _F, _P, _P, _I, _P, _P],
}


def _lib():
    return _build.load("icp", _SIGNATURES)


_THREADS = 256  # threads a block of K3 and K6 (csrc/icp.cu kReduceThreads)
_NE_BLOCKS_PER_SM = 2  # K6's grid at most, in blocks an SM


class _Workspace(NamedTuple):
    gn_grid: int  # K3's grid: the blocks the card holds at once (ifl_gn_grid)
    ne_grid: int  # K6's grid at most: _NE_BLOCKS_PER_SM blocks an SM
    partials: torch.Tensor  # f32[rows, _ROW]: K3's step-parity double buffer, K6's rows
    ticket: torch.Tensor  # i32[1]: K6's last-block counter, 0 between launches


_WORKSPACE: dict = {}


def _workspace(dev) -> _Workspace:
    """K3's and K6's grids on ``dev``, the partials workspace that K3 and
    K6 share there (2 x K3's grid rows of ``_ROW`` floats; K3's grid is at
    least one block an SM, so K6's fits) and K6's ticket counter, which
    never lies in the partials.  Made once a device (the counter zeroed
    then); the kernels use them in stream order."""
    ws = _WORKSPACE.get(dev)
    if ws is None:
        grid = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check(_lib().ifl_gn_grid(ctypes.byref(grid)), "gn_grid")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ws = _WORKSPACE[dev] = _Workspace(
            grid.value, _NE_BLOCKS_PER_SM * sms,
            torch.empty((2 * grid.value, _ROW), dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return ws


def _check_f32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")


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


def associate_gather(src_v, src_valid, T_est_wc, T_tgt_cw, intr: Intrinsics,
                     tgt_vertex, tgt_normal, tgt_valid, stride: int = 1,
                     tgt_rgb=None) -> Association:
    """K2: projective association of one pyramid level, in one launch.

    src_v: f32[N, 3] source vertices (camera frame) and src_valid: bool[N]
    of the level; T_est_wc, T_tgt_cw: f32[4, 4] on the device, read there
    by the kernel; ``intr`` the level's intrinsics; tgt_vertex, tgt_normal:
    f32[Ht, Wt, 3] and tgt_valid: bool[Ht, Wt], the full-resolution
    prediction, read at the level's decimation ``stride``; tgt_rgb:
    optional (intensity, gx, gy) planes of the level, each f32[Ht // stride,
    Wt // stride].  The outputs are views of one allocation.
    """
    if src_v.device.type == "cpu":
        return associate_gather_ref(src_v, src_valid, T_est_wc, T_tgt_cw, intr,
                                    tgt_vertex, tgt_normal, tgt_valid, stride, tgt_rgb)
    dev = src_v.device
    n = src_valid.numel()
    ht, wt = tgt_valid.shape
    hl, wl = ht // stride, wt // stride
    f32 = torch.float32
    checks = [("src_v", src_v, f32, (n, 3)), ("src_valid", src_valid, torch.bool, None),
              ("T_est_wc", T_est_wc, f32, (4, 4)), ("T_tgt_cw", T_tgt_cw, f32, (4, 4)),
              ("tgt_vertex", tgt_vertex, f32, (ht, wt, 3)),
              ("tgt_normal", tgt_normal, f32, (ht, wt, 3)),
              ("tgt_valid", tgt_valid, torch.bool, None)]
    planes = () if tgt_rgb is None else tuple(tgt_rgb)
    checks += [(name, x, f32, (hl, wl)) for name, x in zip(("intensity", "gx", "gy"), planes)]
    for name, x, dtype, shape in checks:
        if (x.dtype != dtype or x.device != dev or not x.is_contiguous()
                or (shape is not None and tuple(x.shape) != shape)):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}"
                             + (f" of shape {shape}" if shape else ""))
    nf = 7 + len(planes)  # floats a pixel: q 3, n_t 3, gate, the planes
    buf = torch.empty(n * (4 * nf + 1), dtype=torch.uint8, device=dev)
    q, n_t, gate, *rgb = buf[:4 * nf * n].view(f32).split([3 * n, 3 * n] + [n] * (nf - 6))
    p = _build.ptr
    plane_ptrs = [p(x) for x in planes] if planes else [None] * 3
    err = _lib().ifl_associate(
        p(src_v), p(src_valid), n, p(T_est_wc), p(T_tgt_cw), intr.fx, intr.fy,
        intr.cx, intr.cy, intr.width, intr.height, p(tgt_vertex), p(tgt_normal),
        p(tgt_valid), *plane_ptrs, wt, hl, wl, stride, p(buf), _build.stream_handle(),
    )
    _build.check(err, "associate_gather")
    associate_gather.launches += 1
    if planes:
        associate_gather.launches_rgb += 1
    return Association(q.view(n, 3), n_t.view(n, 3), buf[4 * nf * n:].view(torch.bool),
                       gate, tuple(rgb) if planes else None)


associate_gather.launches = 0
associate_gather.launches_rgb = 0


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


def normal_equations(p_w, n_t, q_w, mask, huber_delta: float):
    """K6: the normal equations of one linearization on fixed correspondences.

    p_w, n_t, q_w: f32[N, 3]; mask: f32[N].  Returns (H f32[6, 6], b f32[6],
    inliers f32[], sum |r| w f32[]), on the device of the inputs: on the
    card one launch, the same bits from run to run, views of one
    allocation.
    """
    if p_w.device.type == "cpu":
        return normal_equations_ref(p_w, n_t, q_w, mask, huber_delta)
    _check_f32(p_w=p_w, n_t=n_t, q_w=q_w, mask=mask)
    _build.check_tensors(dict(p_w=p_w, n_t=n_t, q_w=q_w, mask=mask), p_w.device)
    dev = p_w.device
    n = p_w.shape[0]
    if n_t.shape != (n, 3) or q_w.shape != (n, 3) or mask.shape != (n,):
        raise ValueError("normal_equations takes p_w, n_t, q_w (N, 3) and mask (N,)")
    ws = _workspace(dev)
    grid = max(1, min(ws.ne_grid, -(-n // _THREADS)))
    out = torch.empty((_NE_OUT,), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _lib().ifl_normal_equations(
        p(p_w), p(n_t), p(q_w), p(mask), n, huber_delta, p(ws.partials),
        p(ws.ticket), grid, p(out), _build.stream_handle(),
    )
    _build.check(err, "normal_equations")
    normal_equations.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


normal_equations.launches = 0


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


def gn_iterations(src_v, src_n, q_w, n_t, gate, T_init, *, inner_n,
                  dist_thresh, angle_thresh, huber_delta, damping, min_valid,
                  rgb=None, T_pred_cw=None, rgb_intr=None, rgb_weight=0.0):
    """``inner_n`` fixed-correspondence Gauss-Newton steps, in one launch.

    src_v, src_n: f32[N, 3] source vertices/normals (camera frame);
    q_w, n_t: f32[N, 3] associated targets (world); gate: f32[N] 0/1;
    T_init: f32[4, 4].  The photometric term joins with ``rgb`` = (i_src,
    i_t, gx_t, gy_t, rgb_gate), each f32[N], ``T_pred_cw`` f32[4, 4],
    ``rgb_intr`` = (fx, fy) of the level and ``rgb_weight``; its
    trust-fraction weight of the last step is left in
    ``gn_iterations.last_wr`` (a device scalar).  Returns (T f32[4, 4],
    inliers f32[], res_sum f32[]), all on the device: on CUDA the pose
    stays in device memory throughout, and the pose, the stats and
    ``last_wr`` are views of the call's one allocation.
    """
    if inner_n < 1:
        raise ValueError(f"inner_n must be at least 1, not {inner_n}")
    kw = dict(inner_n=inner_n, dist_thresh=dist_thresh,
              angle_thresh=angle_thresh, huber_delta=huber_delta,
              damping=damping, min_valid=min_valid)
    rgb_kw = dict(rgb=rgb, T_pred_cw=T_pred_cw, rgb_intr=rgb_intr,
                  rgb_weight=rgb_weight)
    if src_v.device.type == "cpu":
        T, nin, rsum, wr = _gn_steps_ref(src_v, src_n, q_w, n_t, gate, T_init,
                                         **kw, **rgb_kw)
        if rgb is not None:
            gn_iterations.last_wr = wr
        return T, nin, rsum
    dev = src_v.device
    T_init = T_init.to(torch.float32).contiguous()
    tensors = dict(src_v=src_v, src_n=src_n, q_w=q_w, n_t=n_t, gate=gate, T_init=T_init)
    if rgb is not None:
        T_pred_cw = T_pred_cw.to(torch.float32).contiguous()
        planes = dict(zip(("i_src", "i_t", "gx_t", "gy_t", "rgb_gate"), rgb))
        planes["T_pred_cw"] = T_pred_cw
        tensors.update(planes)
    _check_f32(**tensors)
    _build.check_tensors(tensors, dev)
    ws = _workspace(dev)
    out = torch.empty((_GN_OUT,), dtype=torch.float32, device=dev)
    p = _build.ptr
    rgb_ptrs = [p(x) for x in rgb] + [p(T_pred_cw)] if rgb is not None else [None] * 6
    fx, fy = rgb_intr if rgb is not None else (0.0, 0.0)
    err = _lib().ifl_gn_iterations(
        p(src_v), p(src_n), p(q_w), p(n_t), p(gate), *rgb_ptrs, src_v.shape[0],
        p(T_init), p(ws.partials), ws.gn_grid, p(out), inner_n, dist_thresh,
        angle_thresh, huber_delta, damping, float(min_valid), fx, fy,
        rgb_weight if rgb is not None else 0.0, _build.stream_handle(),
    )
    _build.check(err, "gn_iterations")
    gn_iterations.launches += 1
    if rgb is not None:
        gn_iterations.launches_rgb += 1
        gn_iterations.last_wr = out[18]
    return out[:16].view(4, 4), out[16], out[17]


gn_iterations.launches = 0
gn_iterations.launches_rgb = 0
gn_iterations.last_wr = None
