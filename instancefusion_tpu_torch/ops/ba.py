"""Pose-graph optimization and Schur-complement bundle adjustment (port of
``ops/ba.py``).

- Pose graph: keyframe poses T_wc[i] linked by relative-pose edges
  (odometry and verified loops); Gauss-Newton over all poses with the
  anchor pose gauge-fixed by a huge prior.
- Landmark BA: 3D point-to-point observations (what an RGB-D rig
  measures); landmarks are eliminated analytically (Hll is 3x3
  block-diagonal), leaving the reduced camera system
  S = Hpp - Hpl Hll^-1 Hlp, solved densely over the (6M, 6M) pose block.
- The paired layout (``PairedObs``): each landmark is seen by exactly its
  two loop keyframes, which keeps the Schur product O(L) index-adds; it is
  the layout the pipeline runs.  The generic layout (``BAObservations``,
  the dense (M, L, 6, 3) Hpl) stays as the golden.

Per-edge and per-observation Jacobians come from ``torch.func.jacfwd``
under ``torch.func.vmap`` over the edge (observation) axis, exactly as the
reference differentiates with ``jax.jacfwd``.  Scatter-adds are
``index_put_(..., accumulate=True)``; a non-finite solve step is replaced
by zero on the device (``torch.where``), never by a host branch.

Conventions: pose i is T_wc[i] (camera -> world); perturbations are
right-multiplied, T <- T @ exp(xi).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.geometry.se3 import (
    orthonormalize,
    se3_exp,
    se3_inverse,
    se3_log,
)
from instancefusion_tpu_torch.ops.blocks import _set_with_spill


class PoseGraph(NamedTuple):
    """Fixed-capacity relative-pose constraint set."""

    i: torch.Tensor  # i32[E] source keyframe index
    j: torch.Tensor  # i32[E] target keyframe index
    T_ij: torch.Tensor  # f32[E,4,4] measured T_i^-1 T_j (odometry / loop ICP)
    weight: torch.Tensor  # f32[E]
    valid: torch.Tensor  # bool[E]


def empty_graph(capacity: int, device=None) -> PoseGraph:
    dev = _device.resolve(device)
    return PoseGraph(
        i=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        j=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        T_ij=torch.eye(4, device=dev).repeat(capacity, 1, 1),
        weight=torch.zeros((capacity,), device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def _row(x, like: torch.Tensor) -> torch.Tensor:
    """`x` (a number or a tensor) as one row of `like`'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).reshape(
        (1,) + like.shape[1:])


def add_edge(g: PoseGraph, n_edges, i, j, T_ij, weight=1.0) -> tuple[PoseGraph, torch.Tensor]:
    """Append an edge at slot `n_edges` (dropped if at capacity)."""
    cap = g.i.shape[0]
    n_edges = torch.as_tensor(n_edges, dtype=torch.int32, device=g.i.device)
    slot = torch.clamp(n_edges, max=cap).reshape(1)  # cap = the spill row
    g = PoseGraph(*(_set_with_spill(old, slot, _row(new, old)) for old, new in
                    zip(g, (i, j, T_ij, weight, True))))
    return g, torch.clamp(n_edges + 1, max=cap)


def _edge_residual(xi_i, xi_j, T_i, T_j, T_meas):
    """r = log(T_meas^-1 (T_i e^xi_i)^-1 (T_j e^xi_j)): (6,)."""
    Ti = T_i @ se3_exp(xi_i)
    Tj = T_j @ se3_exp(xi_j)
    return se3_log(se3_inverse(T_meas) @ (se3_inverse(Ti) @ Tj))


def _with_value(f):
    """`f` returning (value, value): jacfwd's aux then carries the value."""
    def g(*args):
        r = f(*args)
        return r, r
    return g


def pose_graph_residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """Every edge's residual at the current poses: (E, 6)."""
    zero = torch.zeros((6,), dtype=poses.dtype, device=poses.device)
    Ti = poses.index_select(0, g.i.long())
    Tj = poses.index_select(0, g.j.long())
    return vmap(_edge_residual, in_dims=(None, None, 0, 0, 0))(zero, zero, Ti, Tj, g.T_ij)


def _edge_terms(poses: torch.Tensor, g: PoseGraph):
    """Weighted residuals and Jacobians of every edge: r (E,6), Ji, Jj (E,6,6);
    invalid edges weigh 0."""
    zero = torch.zeros((6,), dtype=poses.dtype, device=poses.device)
    Ti = poses.index_select(0, g.i.long())
    Tj = poses.index_select(0, g.j.long())
    jac = jacfwd(_with_value(_edge_residual), argnums=(0, 1), has_aux=True)
    (Ji, Jj), r = vmap(jac, in_dims=(None, None, 0, 0, 0))(zero, zero, Ti, Tj, g.T_ij)
    w = torch.where(g.valid, g.weight, torch.zeros_like(g.weight))
    return r * w[:, None], Ji * w[:, None, None], Jj * w[:, None, None]


def _add_blocks(H: torch.Tensor, rows, cols, blocks: torch.Tensor) -> None:
    H.index_put_((rows.long(), cols.long()), blocks, accumulate=True)


def _add_rows(b: torch.Tensor, rows, vals: torch.Tensor) -> None:
    b.index_put_((rows.long(),), vals, accumulate=True)


def _flatten_blocks(H4: torch.Tensor) -> torch.Tensor:
    """(M, M, 6, 6) blocks -> the (6M, 6M) matrix."""
    m = H4.shape[0]
    return H4.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)


def pose_graph_normal_eqs(poses: torch.Tensor, g: PoseGraph):
    """Assemble H (6M,6M), b (6M,) and the weighted residual norm.

    A plain sum over edges: with the edge set split, the partial H and b
    add up (the distributed reduction of the reference).
    """
    m = poses.shape[0]
    r, Ji, Jj = _edge_terms(poses, g)
    H = torch.zeros((m, m, 6, 6), dtype=poses.dtype, device=poses.device)
    b = torch.zeros((m, 6), dtype=poses.dtype, device=poses.device)
    JiTJj = torch.einsum("eab,eac->ebc", Ji, Jj)
    _add_blocks(H, g.i, g.i, torch.einsum("eab,eac->ebc", Ji, Ji))
    _add_blocks(H, g.j, g.j, torch.einsum("eab,eac->ebc", Jj, Jj))
    _add_blocks(H, g.i, g.j, JiTJj)
    _add_blocks(H, g.j, g.i, JiTJj.transpose(-1, -2))
    _add_rows(b, g.i, -torch.einsum("eab,ea->eb", Ji, r))
    _add_rows(b, g.j, -torch.einsum("eab,ea->eb", Jj, r))
    return _flatten_blocks(H), b.reshape(-1), torch.sum(r * r)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.all(torch.isfinite(x)), x, torch.zeros_like(x))


def _solve_reduced(S: torch.Tensor, rhs: torch.Tensor, m: int, damping: float,
                   anchor: int) -> torch.Tensor:
    """Damped solve of the (6M, 6M) system with the anchor pose's 6 dofs
    pinned by a 1e12 prior (shapes stay static); xi (M, 6), zero when not
    finite.  ``solve_ex`` leaves a singular system to the finiteness test
    instead of raising (which would read the status back to the host)."""
    idx = torch.arange(6 * m, device=S.device)
    anchor_mask = (idx >= 6 * anchor) & (idx < 6 * (anchor + 1))
    diag = damping * torch.clamp(torch.diagonal(S), min=1.0) + torch.where(
        anchor_mask, 1e12, 0.0)
    xi = torch.linalg.solve_ex(S + torch.diag(diag), rhs[:, None])[0][:, 0]
    return _finite_or_zero(xi.reshape(m, 6))


def _retract(poses: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return orthonormalize(poses @ se3_exp(xi))


def solve_and_update(poses: torch.Tensor, H: torch.Tensor, b: torch.Tensor,
                     damping: float = 1e-6, anchor: int = 0) -> torch.Tensor:
    """One damped GN step with the anchor pose gauge-fixed."""
    return _retract(poses, _solve_reduced(H, b, poses.shape[0], damping, anchor))


def optimize_pose_graph(poses: torch.Tensor, g: PoseGraph, iters: int = 8,
                        damping: float = 1e-6, anchor: int = 0):
    """Gauss-Newton over the pose graph; returns (poses, final cost)."""
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(iters):
        H, b, cost = pose_graph_normal_eqs(poses, g)
        poses = solve_and_update(poses, H, b, damping, anchor)
    return poses, cost


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment (poses + landmarks)
# ---------------------------------------------------------------------------


class BAObservations(NamedTuple):
    """Landmark l observed from keyframe k at camera-frame position z."""

    k: torch.Tensor  # i32[O] keyframe index
    l: torch.Tensor  # i32[O] landmark index
    z: torch.Tensor  # f32[O,3] measured camera-frame position
    weight: torch.Tensor  # f32[O]
    valid: torch.Tensor  # bool[O]


def _obs_residual(xi, p_l, T_k, z):
    """r = (T_k e^xi)^-1 p_l - z: camera-frame point residual (3,)."""
    Ti = se3_inverse(T_k @ se3_exp(xi))
    return Ti[:3, :3] @ p_l + Ti[:3, 3] - z


def _obs_terms(poses_k: torch.Tensor, points: torch.Tensor, z: torch.Tensor,
               w: torch.Tensor):
    """Weighted residuals and Jacobians of observations at poses `poses_k`
    (O,4,4) of points (O,3): r (O,3), Jp (O,3,6), Jl (O,3,3)."""
    zero = torch.zeros((6,), dtype=points.dtype, device=points.device)
    jac = jacfwd(_with_value(_obs_residual), argnums=(0, 1), has_aux=True)
    (Jp, Jl), r = vmap(jac, in_dims=(None, 0, 0, 0))(zero, points, poses_k, z)
    return r * w[:, None], Jp * w[:, None, None], Jl * w[:, None, None]


def ba_partials(poses: torch.Tensor, points: torch.Tensor, obs: BAObservations):
    """BA blocks (Hpp (M,6,6), bp (M,6), Hll (L,3,3), bl (L,3),
    Hpl (M,L,6,3), cost): each a plain sum over observations."""
    m, L = poses.shape[0], points.shape[0]
    kw = dict(dtype=poses.dtype, device=poses.device)
    w = torch.where(obs.valid, obs.weight, torch.zeros_like(obs.weight))
    r, Jp, Jl = _obs_terms(poses.index_select(0, obs.k.long()),
                           points.index_select(0, obs.l.long()), obs.z, w)
    Hpp = torch.zeros((m, 6, 6), **kw)
    Hll = torch.zeros((L, 3, 3), **kw)
    Hpl = torch.zeros((m, L, 6, 3), **kw)
    bp = torch.zeros((m, 6), **kw)
    bl = torch.zeros((L, 3), **kw)
    _add_rows(Hpp, obs.k, torch.einsum("oab,oac->obc", Jp, Jp))
    _add_rows(Hll, obs.l, torch.einsum("oab,oac->obc", Jl, Jl))
    _add_blocks(Hpl, obs.k, obs.l, torch.einsum("oab,oac->obc", Jp, Jl))
    _add_rows(bp, obs.k, -torch.einsum("oab,oa->ob", Jp, r))
    _add_rows(bl, obs.l, -torch.einsum("oab,oa->ob", Jl, r))
    return Hpp, bp, Hll, bl, Hpl, torch.sum(r * r)


def _damped_inverse(Hll: torch.Tensor, damping: float) -> torch.Tensor:
    """Batched inverse of Hll + damping max(diag, 1) I; ``inv_ex`` for the
    same reason as ``solve_ex`` in ``_solve_reduced``."""
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    d = damping * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1.0)
    return torch.linalg.inv_ex(Hll + d[..., None] * eye3)[0]


def schur_reduce(Hpp, bp, Hll, bl, Hpl, damping: float = 1e-4):
    """Eliminate the landmark block: returns (S (6M,6M), rhs (6M,),
    Hll_inv (L,3,3)) with S = Hpp - Hpl Hll^-1 Hlp."""
    m = Hpp.shape[0]
    Hll_inv = _damped_inverse(Hll, damping)
    HplW = torch.einsum("mlab,lbc->mlac", Hpl, Hll_inv)  # (M,L,6,3)
    S = -torch.einsum("mlac,nlbc->mnab", HplW, Hpl)  # (M,M,6,6)
    diag = torch.arange(m, device=Hpp.device)
    _add_blocks(S, diag, diag, Hpp)
    rhs = bp - torch.einsum("mlac,lc->ma", HplW, bl)
    return _flatten_blocks(S), rhs.reshape(-1), Hll_inv


def _backsub_landmarks(Hll_inv, bl, Hpl, xi):
    """dl = Hll^-1 (bl - Hlp xi)."""
    Hlp_xi = torch.einsum("mlab,ma->lb", Hpl, xi)
    return _finite_or_zero(torch.einsum("lab,lb->la", Hll_inv, bl - Hlp_xi))


def schur_solve(Hpp, bp, Hll, bl, Hpl, damping: float = 1e-4, anchor: int = 0):
    """Eliminate landmarks, solve the reduced pose system, back-substitute.
    Returns (xi_poses (M,6), delta_points (L,3))."""
    m = Hpp.shape[0]
    S, rhs, Hll_inv = schur_reduce(Hpp, bp, Hll, bl, Hpl, damping)
    xi = _solve_reduced(S, rhs, m, damping, anchor)
    return xi, _backsub_landmarks(Hll_inv, bl, Hpl, xi)


def optimize_ba(poses: torch.Tensor, points: torch.Tensor, obs: BAObservations,
                iters: int = 5, damping: float = 1e-4, anchor: int = 0,
                partials_fn=ba_partials):
    """Full Schur BA loop; returns (poses, points, final cost)."""
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(iters):
        Hpp, bp, Hll, bl, Hpl, cost = partials_fn(poses, points, obs)
        xi, dl = schur_solve(Hpp, bp, Hll, bl, Hpl, damping, anchor)
        poses, points = _retract(poses, xi), points + dl
    return poses, points, cost


def optimize_hybrid(poses: torch.Tensor, g: PoseGraph, points: torch.Tensor,
                    obs: BAObservations, iters: int = 5, damping: float = 1e-4,
                    anchor: int = 0, partials_fn=ba_partials, pg_weight: float = 1.0):
    """Joint pose-graph + landmark Schur BA on the generic layout.

    One GN system per iteration: the pose-graph normal equations (which
    anchor the trajectory) plus the landmarks' Schur complement (which
    re-measures the loop-pair geometry).  With no valid observation this is
    ``optimize_pose_graph``.  Returns (poses, points, pg_cost + ba_cost).
    """
    m = poses.shape[0]
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(iters):
        Hpp, bp, Hll, bl, Hpl, ba_cost = partials_fn(poses, points, obs)
        S, rhs, Hll_inv = schur_reduce(Hpp, bp, Hll, bl, Hpl, damping)
        H_pg, b_pg, pg_cost = pose_graph_normal_eqs(poses, g)
        xi = _solve_reduced(S + pg_weight * H_pg, rhs + pg_weight * b_pg, m, damping,
                            anchor)
        dl = _backsub_landmarks(Hll_inv, bl, Hpl, xi)
        poses, points = _retract(poses, xi), points + dl
        cost = pg_weight * pg_cost + ba_cost
    return poses, points, cost


# ---------------------------------------------------------------------------
# Paired-landmark layout: the pipeline's loop-closure path
# ---------------------------------------------------------------------------


class PairedObs(NamedTuple):
    """Landmark l observed by exactly two keyframes (its loop pair), both
    rows aligned on the landmark axis."""

    ka: torch.Tensor  # i32[L] first observing keyframe
    kb: torch.Tensor  # i32[L] second observing keyframe
    za: torch.Tensor  # f32[L,3] measured camera-frame position in ka
    zb: torch.Tensor  # f32[L,3] measured camera-frame position in kb
    weight: torch.Tensor  # f32[L]
    valid: torch.Tensor  # bool[L]


def empty_paired_obs(capacity: int, device=None) -> PairedObs:
    dev = _device.resolve(device)
    return PairedObs(
        ka=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        kb=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        za=torch.zeros((capacity, 3), device=dev),
        zb=torch.zeros((capacity, 3), device=dev),
        weight=torch.zeros((capacity,), device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def paired_to_generic(obs: PairedObs) -> BAObservations:
    """Flatten a paired set to the generic layout (for goldens and tests)."""
    lidx = torch.arange(obs.ka.shape[0], dtype=torch.int32, device=obs.ka.device)
    return BAObservations(
        k=torch.cat([obs.ka, obs.kb]), l=torch.cat([lidx, lidx]),
        z=torch.cat([obs.za, obs.zb]), weight=torch.cat([obs.weight, obs.weight]),
        valid=torch.cat([obs.valid, obs.valid]),
    )


def paired_terms(poses: torch.Tensor, points: torch.Tensor, obs: PairedObs,
                 damping: float = 1e-4):
    """Schur-reduced camera terms from paired observations.

    Returns (S (M,M,6,6), rhs (M,6), Hll_inv (L,3,3), Wa, Wb (L,6,3),
    bl (L,3), cost).  S, rhs and cost are plain sums over landmarks;
    Hll_inv, Wa, Wb and bl stay landmark-aligned for the back-substitution.
    """
    m = poses.shape[0]
    w = torch.where(obs.valid, obs.weight, torch.zeros_like(obs.weight))
    ra, Jpa, Jla = _obs_terms(poses.index_select(0, obs.ka.long()), points, obs.za, w)
    rb, Jpb, Jlb = _obs_terms(poses.index_select(0, obs.kb.long()), points, obs.zb, w)

    ein = torch.einsum
    Hll = ein("lab,lac->lbc", Jla, Jla) + ein("lab,lac->lbc", Jlb, Jlb)
    Hll_inv = _damped_inverse(Hll, damping)
    Wa = ein("lab,lac->lbc", Jpa, Jla)  # (L,6,3) = Jpa^T Jla
    Wb = ein("lab,lac->lbc", Jpb, Jlb)
    bl = -(ein("lab,la->lb", Jla, ra) + ein("lab,la->lb", Jlb, rb))
    WaH = ein("lab,lbc->lac", Wa, Hll_inv)  # (L,6,3)
    WbH = ein("lab,lbc->lac", Wb, Hll_inv)

    S = torch.zeros((m, m, 6, 6), dtype=poses.dtype, device=poses.device)
    _add_blocks(S, obs.ka, obs.ka, ein("lab,lac->lbc", Jpa, Jpa) - ein("lac,lbc->lab", WaH, Wa))
    _add_blocks(S, obs.kb, obs.kb, ein("lab,lac->lbc", Jpb, Jpb) - ein("lac,lbc->lab", WbH, Wb))
    off = ein("lac,lbc->lab", WaH, Wb)  # (L,6,6) = Wa Hll_inv Wb^T
    _add_blocks(S, obs.ka, obs.kb, -off)
    _add_blocks(S, obs.kb, obs.ka, -off.transpose(-1, -2))

    rhs = torch.zeros((m, 6), dtype=poses.dtype, device=poses.device)
    _add_rows(rhs, obs.ka, -ein("lab,la->lb", Jpa, ra))
    _add_rows(rhs, obs.kb, -ein("lab,la->lb", Jpb, rb))
    _add_rows(rhs, obs.ka, -ein("lac,lc->la", WaH, bl))
    _add_rows(rhs, obs.kb, -ein("lac,lc->la", WbH, bl))
    return S, rhs, Hll_inv, Wa, Wb, bl, torch.sum(ra * ra) + torch.sum(rb * rb)


def optimize_hybrid_paired(poses: torch.Tensor, g: PoseGraph, points: torch.Tensor,
                           obs: PairedObs, iters: int = 5, damping: float = 1e-4,
                           anchor: int = 0, terms_fn=None, pg_weight: float = 1.0):
    """Joint pose-graph + paired-landmark Schur BA: the live solver.

    ``optimize_hybrid`` restricted to the paired layout, at O(L) Schur
    cost; `terms_fn` replaces ``paired_terms`` (a sharded reducer in the
    reference).  With no valid observation this is ``optimize_pose_graph``.
    """
    if terms_fn is None:
        terms_fn = functools.partial(paired_terms, damping=damping)
    m = poses.shape[0]
    cost = torch.full((), float("inf"), device=poses.device)
    for _ in range(iters):
        S, rhs, Hll_inv, Wa, Wb, bl, ba_cost = terms_fn(poses, points, obs)
        H_pg, b_pg, pg_cost = pose_graph_normal_eqs(poses, g)
        xi = _solve_reduced(_flatten_blocks(S) + pg_weight * H_pg,
                            rhs.reshape(-1) + pg_weight * b_pg, m, damping, anchor)
        # Back-substitute: dl = Hll^-1 (bl - Wa^T xi_ka - Wb^T xi_kb).
        resid = (bl - torch.einsum("lab,la->lb", Wa, xi.index_select(0, obs.ka.long()))
                 - torch.einsum("lab,la->lb", Wb, xi.index_select(0, obs.kb.long())))
        dl = _finite_or_zero(torch.einsum("lab,lb->la", Hll_inv, resid))
        poses, points = _retract(poses, xi), points + dl
        cost = pg_weight * pg_cost + ba_cost
    return poses, points, cost
