"""The port's collective BA reducers (``parallel/shard.py``) against the
reference's, at tests/test_shard.py's problems.

The port runs as 4 gloo ranks on the CPU (one ``RankPool`` for the
module); the reference's per-slice terms are psum'd under
``jax.vmap(body, axis_name=SHARD_AXIS)``.  Both get the same numpy inputs.
(Kept apart from tests/test_torch_shard.py so each file runs in well under
a minute on one worker.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.ops import ba as jba
from instancefusion_tpu.parallel.mesh import SHARD_AXIS
from instancefusion_tpu_torch.parallel import mesh
from tests import torch_shard_workers as W
from tests.torch_helpers import one_thread  # noqa: F401 (autouse fixture)

S = 4


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(S, device="cpu") as p:
        yield p


def _stack(x):
    return jnp.asarray(x).reshape((S, -1) + tuple(np.shape(x)[1:]))


def test_ba_reducers_match_reference(pool):
    """The three collective BA reducers on 4 ranks against the reference's
    per-slice terms psum'd under vmap: paired Schur terms, pose-graph
    normal equations and the generic partials to 1e-5, the
    landmark-aligned terms exactly in landmark order, and the hybrid solve
    through the sharded terms within 1e-4 of the reference's unsharded
    solve (tests/test_shard.py's bounds)."""
    from tests.test_ba import _ba_problem, _chain_with_loop, _paired_problem

    _, _, noisy, npts, pobs, g = _paired_problem(m=5, L=32)
    poses, points = jnp.asarray(noisy), jnp.asarray(npts)
    paired = jax.jit(jax.vmap(
        lambda pt, o: [jax.lax.psum(x, SHARD_AXIS) if i in (0, 1, 6) else x
                       for i, x in enumerate(jba.paired_terms(poses, pt, o))],
        axis_name=SHARD_AXIS))(_stack(points), jax.tree_util.tree_map(_stack, pobs))
    _, est, edges = _chain_with_loop()
    H0, b0, c0 = jax.jit(jba.pose_graph_normal_eqs)(jnp.asarray(est), edges)
    _, _, bnoisy, bpts, obs = _ba_problem(m=4, L=8)
    pad = (-obs.k.shape[0]) % S
    obs = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)), obs)
    part0 = jax.jit(jba.ba_partials)(jnp.asarray(bnoisy), jnp.asarray(bpts), obs)
    sol0 = jax.jit(functools.partial(jba.optimize_hybrid_paired, iters=6))(
        poses, g, points, pobs)

    def nps(nt):
        return [np.asarray(x) for x in nt]

    res = pool.run(W.ba_terms, (np.asarray(noisy), np.asarray(npts), nps(pobs), nps(g)),
                   (np.asarray(est), nps(edges)),
                   (np.asarray(bnoisy), np.asarray(bpts), nps(obs)))
    for got_paired, got_solve, (H1, b1, c1), got_part in res:
        for i in (0, 1, 6):
            np.testing.assert_allclose(got_paired[i], np.asarray(paired[i])[0], rtol=1e-5,
                                       atol=1e-5)
        for i in (2, 3, 4, 5):
            np.testing.assert_allclose(
                got_paired[i], np.asarray(paired[i]).reshape(got_paired[i].shape),
                rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_solve[0], np.asarray(sol0[0]), atol=1e-4)
        np.testing.assert_allclose(got_solve[1], np.asarray(sol0[1]), atol=1e-4)
        np.testing.assert_allclose(H1, np.asarray(H0), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b1, np.asarray(b0), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)
        for a, b in zip(got_part, part0):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
