"""Port pose-graph / Schur BA and ferns against the reference, on the graphs
of tests/test_ba.py.

Tolerances: so3_exp and orthonormalize 1e-6; the edge and observation
Jacobians 1e-5 against ``jax.jacfwd``; the normal equations rtol 1e-4 /
atol 1e-5 (H and S hold sums of up to ~40 products of entries of order 1;
fp32 summation order differs); optimized poses and points 1e-4; fern codes
and retrieval exact, given the reference's coder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.geometry import se3 as jse3
from instancefusion_tpu.ops import ba as jba
from instancefusion_tpu.ops import ferns as jferns
from instancefusion_tpu_torch.geometry import se3 as pse3
from instancefusion_tpu_torch.ops import ba as pba
from instancefusion_tpu_torch.ops import ferns as pferns
from tests import test_ba
from tests.torch_helpers import n, one_thread, t  # noqa: F401 (autouse fixture)

NE = dict(rtol=1e-4, atol=1e-5)
OPT = 1e-4


# The reference's problems, built once (each takes seconds of eager JAX), and
# its solvers jitted (eager vmap(jacfwd) takes 15-30 s a call on the CPU).
_chain_with_loop = functools.lru_cache(test_ba._chain_with_loop)
_paired_problem = functools.lru_cache(test_ba._paired_problem)
_ba_problem = functools.lru_cache(test_ba._ba_problem)
_ITERS = ("iters",)
ref_normal_eqs = jax.jit(jba.pose_graph_normal_eqs)
ref_paired_terms = jax.jit(jba.paired_terms)
ref_ba_partials = jax.jit(jba.ba_partials)
ref_optimize_pose_graph = jax.jit(jba.optimize_pose_graph, static_argnames=_ITERS)
ref_optimize_ba = jax.jit(jba.optimize_ba, static_argnames=_ITERS)
ref_optimize_hybrid_paired = jax.jit(jba.optimize_hybrid_paired, static_argnames=_ITERS)


def _graph(g):
    return pba.PoseGraph(*(t(x) for x in g))


def _paired(o):
    return pba.PairedObs(*(t(x) for x in o))


def _generic(o):
    return pba.BAObservations(*(t(x) for x in o))


def _poses(seed, k=16, scale=0.5):
    xi = np.random.default_rng(seed).normal(scale=scale, size=(k, 6)).astype(np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("scale", [1e-3, 0.3, 2.0])
def test_so3_exp(scale):
    w = np.random.default_rng(1).normal(scale=scale, size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(n(pse3.so3_exp(t(w))), np.asarray(jse3.so3_exp(jnp.asarray(w))),
                               atol=1e-6)


def test_orthonormalize():
    T = _poses(2)
    T[:, :3, :3] += np.random.default_rng(3).normal(scale=1e-3, size=(16, 3, 3)).astype(np.float32)
    T[:, :3, 3] += 0.1
    out = n(pse3.orthonormalize(t(T)))
    np.testing.assert_allclose(out, np.asarray(jse3.orthonormalize(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_array_equal(out[:, :, 3], T[:, :, 3])  # translation and bottom row kept


def test_edge_residual_jacobians_match_jacfwd():
    Ti, Tj, Tm = _poses(4), _poses(5), _poses(6, scale=0.1)
    xi = np.random.default_rng(7).normal(scale=0.05, size=(16, 2, 6)).astype(np.float32)
    args = (xi[:, 0], xi[:, 1], Ti, Tj, Tm)
    ref = jax.jit(jax.vmap(jax.jacfwd(jba._edge_residual, argnums=(0, 1))))(
        *map(jnp.asarray, args))
    out = torch.func.vmap(torch.func.jacfwd(pba._edge_residual, argnums=(0, 1)))(*map(t, args))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)


def test_obs_residual_jacobians_match_jacfwd():
    rng = np.random.default_rng(8)
    xi = rng.normal(scale=0.05, size=(16, 6)).astype(np.float32)
    p = rng.uniform(-1, 1, (16, 3)).astype(np.float32) + [0, 0, 3]
    z = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    args = (xi, p.astype(np.float32), _poses(9), z)
    ref = jax.jit(jax.vmap(jax.jacfwd(jba._obs_residual, argnums=(0, 1))))(
        *map(jnp.asarray, args))
    out = torch.func.vmap(torch.func.jacfwd(pba._obs_residual, argnums=(0, 1)))(*map(t, args))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)


def test_pose_graph_normal_eqs_match():
    _, est, g = _chain_with_loop()
    ref = ref_normal_eqs(jnp.asarray(est), g)
    out = pba.pose_graph_normal_eqs(t(est), _graph(g))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), **NE)


def test_paired_terms_match():
    _, _, noisy, npts, pobs, _ = _paired_problem()
    ref = ref_paired_terms(jnp.asarray(noisy), jnp.asarray(npts), pobs)
    out = pba.paired_terms(t(noisy), t(npts), _paired(pobs))
    for i in (0, 1, 6):  # S, rhs, cost
        np.testing.assert_allclose(n(out[i]), np.asarray(ref[i]), **NE)


def test_ba_partials_match():
    _, _, noisy, npts, obs = _ba_problem(m=4, L=10)
    ref = ref_ba_partials(jnp.asarray(noisy), jnp.asarray(npts), obs)
    out = pba.ba_partials(t(noisy), t(npts), _generic(obs))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), **NE)


def test_add_edge_drops_at_capacity():
    g = pba.empty_graph(2, device="cpu")
    ne = torch.zeros((), dtype=torch.int32)
    for k in range(3):
        g, ne = pba.add_edge(g, ne, k, k + 1, torch.eye(4) * (k + 1), 2.0)
    assert int(ne) == 2
    np.testing.assert_array_equal(n(g.i), [0, 1])
    np.testing.assert_array_equal(n(g.T_ij[:, 0, 0]), [1.0, 2.0])
    assert n(g.valid).all() and (n(g.weight) == 2.0).all()


def test_optimize_pose_graph_matches():
    gt, est, g = _chain_with_loop()
    ref, cref = ref_optimize_pose_graph(jnp.asarray(est), g, iters=10)
    out, cost = pba.optimize_pose_graph(t(est), _graph(g), iters=10)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=OPT)
    np.testing.assert_allclose(float(cost), float(cref), rtol=1e-3, atol=1e-6)


def test_optimize_ba_matches():
    _, _, noisy, npts, obs = _ba_problem()
    rp, rx, _ = ref_optimize_ba(jnp.asarray(noisy), jnp.asarray(npts), obs, iters=8)
    op, ox, _ = pba.optimize_ba(t(noisy), t(npts), _generic(obs), iters=8)
    np.testing.assert_allclose(n(op), np.asarray(rp), atol=OPT)
    np.testing.assert_allclose(n(ox), np.asarray(rx), atol=OPT)


def test_optimize_hybrid_paired_matches():
    _, _, noisy, npts, pobs, g = _paired_problem()
    rp, rx, _ = ref_optimize_hybrid_paired(jnp.asarray(noisy), g, jnp.asarray(npts), pobs,
                                            iters=8)
    op, ox, _ = pba.optimize_hybrid_paired(t(noisy), _graph(g), t(npts), _paired(pobs),
                                            iters=8)
    np.testing.assert_allclose(n(op), np.asarray(rp), atol=OPT)
    np.testing.assert_allclose(n(ox), np.asarray(rx), atol=OPT)


def test_paired_matches_generic_hybrid():
    """The O(L) paired path against the dense-Hpl golden, as test_ba.py
    holds the reference's."""
    _, _, noisy, npts, pobs, g = _paired_problem()
    po = _paired(pobs)
    p1, x1, c1 = pba.optimize_hybrid(t(noisy), _graph(g), t(npts), pba.paired_to_generic(po),
                                     iters=8)
    p2, x2, c2 = pba.optimize_hybrid_paired(t(noisy), _graph(g), t(npts), po, iters=8)
    np.testing.assert_allclose(n(p1), n(p2), atol=2e-5)
    np.testing.assert_allclose(n(x1), n(x2), atol=2e-5)
    np.testing.assert_allclose(float(c1), float(c2), rtol=1e-4)


def test_hybrid_empty_bank_degrades_to_pose_graph():
    _, est, g = _chain_with_loop()
    ph, _, _ = pba.optimize_hybrid_paired(t(est), _graph(g), torch.zeros((64, 3)),
                                          pba.empty_paired_obs(64, device="cpu"), iters=6)
    p_pg, _ = pba.optimize_pose_graph(t(est), _graph(g), iters=6)
    np.testing.assert_allclose(n(ph), n(p_pg), atol=1e-5)


def _fern_frames():
    h, w = 24, 32
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    return [(np.asarray(jax.random.uniform(k, (h, w, 3))),
             np.asarray(jax.random.uniform(k, (h, w)) * 4.0)) for k in keys]


def test_ferns_encode_and_find_best_equal():
    """Given the reference's coder, codes, dissimilarities and the retrieved
    index are equal; ties go to the first minimum in both."""
    coder = jferns.make_coder(jax.random.PRNGKey(0), 24, 32, 128)
    pcoder = pferns.FernCoder(*(t(x) for x in coder))
    frames = _fern_frames()
    ref = np.stack([np.asarray(jferns.encode(coder, jnp.asarray(c), jnp.asarray(d)))
                    for c, d in frames])
    out = torch.stack([pferns.encode(pcoder, t(c), t(d)) for c, d in frames])
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(n(out), ref)
    db = np.concatenate([ref, ref[2:4]])  # rows 8, 9 tie rows 2, 3
    for q in range(4):
        for valid, excl in ((np.ones(10, bool), 10), (np.arange(10) != 2, 10),
                            (np.ones(10, bool), 3), (np.zeros(10, bool), 10)):
            rb, rd = jferns.find_best(jnp.asarray(ref[q]), jnp.asarray(db), jnp.asarray(valid),
                                      jnp.int32(excl))
            ob, od = pferns.find_best(t(ref[q]), t(db), t(valid), excl)
            assert int(ob) == int(rb) and float(od) == float(rd), (q, excl)


def test_ferns_make_coder_ranges():
    gen = torch.Generator().manual_seed(0)
    c = pferns.make_coder(gen, 24, 32, 256)
    assert c.uv.dtype == torch.int32 and c.thresh.shape == (256, 4)
    assert 0 <= int(c.uv[:, 0].min()) and int(c.uv[:, 0].max()) < 24
    assert 0 <= int(c.uv[:, 1].min()) and int(c.uv[:, 1].max()) < 32
    assert float(c.thresh[:, 3].max()) <= 5.0
