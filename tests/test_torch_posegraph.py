"""Port loop backend against the reference, on the out-and-back rig of
tests/test_posegraph.py (13 keyframes with drifted odometry, a revisit of
the start).

The port's backend carries the reference's fern coder.  Tolerances: the
keyframe store bit-equal; retrieval the same index and dissimilarity;
``verify_loop`` the same verdict and T_rel within 1e-4 m; landmarks the
same valid mask and points within 1e-5 m; optimized poses within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.engine import posegraph as jpg
from instancefusion_tpu.geometry.se3 import se3_exp, se3_inverse
from instancefusion_tpu.ops import preprocess as jpre
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import posegraph as ppg
from tests.test_posegraph import CFG, _out_and_back_poses
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    n, one_thread, reference_backend_arrays, t, to_port,
)

PCFG = to_port(CFG)
DRIFT = np.array([0.004, -0.003, 0.002, 0.002, -0.001, 0.003], np.float32)


@functools.lru_cache(maxsize=None)
def _rig():
    """Ground truth, drifted keyframe poses, the reference frames and their
    level-0 maps (reference preprocessing, fed to both packages)."""
    gt = _out_and_back_poses(14)
    est = [gt[0]]
    for i in range(1, len(gt)):
        T_rel = np.asarray(se3_inverse(jnp.asarray(gt[i - 1]))) @ gt[i]
        est.append(est[-1] @ T_rel @ np.asarray(se3_exp(jnp.asarray(DRIFT))))
    frames = [synthetic.render_frame(jnp.asarray(g), CFG.intrinsics) for g in gt]
    maps = []
    for f in frames:
        d = jpre.clamp_depth(f.depth, CFG.preprocess)
        lvl = jpre.build_frame_pyramid(d, CFG.intrinsics, CFG.preprocess, 1)[0]
        maps.append((np.asarray(lvl["vmap"]), np.asarray(lvl["nmap"])))
    return gt, np.stack(est).astype(np.float32), frames, maps


@functools.lru_cache(maxsize=None)
def _backends():
    """Both backends after inserting every keyframe; the port's starts from
    the reference's empty backend (its fern coder)."""
    _, est, frames, maps = _rig()
    bs = jpg.allocate(CFG)
    pbs = convert.backend_from_numpy(reference_backend_arrays(bs), device="cpu")
    add = jax.jit(jpg.add_keyframe)
    for e, f, (v, nm) in zip(est, frames, maps):
        bs = add(bs, jnp.asarray(e), f.color, f.depth, jnp.asarray(v), jnp.asarray(nm))
        pbs = ppg.add_keyframe(pbs, t(e), t(f.color), t(f.depth), t(v), t(nm))
    return bs, pbs


def test_keyframe_store_bit_equal():
    bs, pbs = _backends()
    ref = reference_backend_arrays(bs)
    out = convert.backend_to_numpy(pbs)
    assert set(out) == set(ref)
    for k in ref:
        if k.startswith(("kf.", "coder.")) or k in ("n_edges",):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # The odometry edges: relative poses of the stored poses (one matrix
    # product and an inverse each; fp32 rounding differs by a few ulps).
    for k in ("graph.i", "graph.j", "graph.weight", "graph.valid"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_allclose(out["graph.T_ij"], ref["graph.T_ij"], atol=1e-6)
    assert int(pbs.kf.count) == 13 and int(pbs.n_edges) == 12  # 7 out, 6 back


def test_detect_loop_same_index_and_dissimilarity():
    bs, pbs = _backends()
    _, _, frames, _ = _rig()
    for q, gap in ((12, 5), (11, 3), (6, 0)):
        f = frames[q]
        c_ref, d_ref = jpg.detect_loop(bs, f.color, f.depth, min_gap=gap)
        c, d = ppg.detect_loop(pbs, t(f.color), t(f.depth), min_gap=gap)
        assert (int(c), float(d)) == (int(c_ref), float(d_ref)), (q, gap)


def _verify(cand, q, T_cur):
    bs, pbs = _backends()
    _, _, _, maps = _rig()
    v, nm = maps[q]
    ref = jpg.verify_loop(bs, jnp.int32(cand), jnp.asarray(v), jnp.asarray(nm),
                          CFG.intrinsics, CFG, T_cur_wc=jnp.asarray(T_cur))
    out = ppg.verify_loop(pbs, torch.tensor(cand, dtype=torch.int32), t(v), t(nm),
                          PCFG.intrinsics, PCFG, T_cur_wc=t(T_cur))
    return ref, out


def test_verify_loop_same_verdict_and_relative_pose():
    _, est, _, _ = _rig()
    for cand, q in ((0, 12), (1, 11), (0, 6)):
        (r_T, r_inl, r_ok), (p_T, p_inl, p_ok) = _verify(cand, q, est[cand])
        assert bool(p_ok) == bool(r_ok), (cand, q, float(r_inl), float(p_inl))
        np.testing.assert_allclose(n(p_T)[:3, 3], np.asarray(r_T)[:3, 3], atol=1e-4)
        np.testing.assert_allclose(n(p_T)[:3, :3], np.asarray(r_T)[:3, :3], atol=1e-4)
    assert bool(_verify(0, 12, est[0])[1][2])  # the revisit verifies


def _loop_pair():
    gt, _, _, _ = _rig()
    T_rel = np.asarray(se3_inverse(jnp.asarray(gt[0]))) @ gt[-1]
    noise = np.asarray(se3_exp(jnp.asarray(
        np.array([0.025, -0.02, 0.03, 0.012, -0.008, 0.01], np.float32))))
    return (T_rel @ noise).astype(np.float32)


def test_build_loop_landmarks_match():
    bs, pbs = _backends()
    T_rel = _loop_pair()
    pts_r, obs_r = jpg.build_loop_landmarks(bs, jnp.int32(0), jnp.int32(12),
                                            jnp.asarray(T_rel), CFG.intrinsics, CFG)
    pts, obs = ppg.build_loop_landmarks(pbs, torch.tensor(0), torch.tensor(12), t(T_rel),
                                        PCFG.intrinsics, PCFG)
    np.testing.assert_array_equal(n(obs.valid), np.asarray(obs_r.valid))
    assert int(obs.valid.sum()) > 40
    np.testing.assert_allclose(n(pts), np.asarray(pts_r), atol=1e-5)
    for a, b in zip(obs[:5], obs_r[:5]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)


def test_optimize_and_optimize_landmark_match():
    bs, pbs = _backends()
    T_rel = _loop_pair()
    bs = jpg.add_loop_edge(bs, jnp.int32(0), jnp.int32(12), jnp.asarray(T_rel))
    pbs = ppg.add_loop_edge(pbs, 0, 12, t(T_rel))
    assert int(pbs.n_loops) == 1
    r_pg, _ = jpg.optimize(bs, CFG.posegraph)
    p_pg, _ = ppg.optimize(pbs, PCFG.posegraph)
    np.testing.assert_allclose(n(p_pg.kf.poses), np.asarray(r_pg.kf.poses), atol=1e-4)

    pts_r, obs_r = jpg.build_loop_landmarks(bs, jnp.int32(0), jnp.int32(12),
                                            jnp.asarray(T_rel), CFG.intrinsics, CFG)
    pts, obs = ppg.build_loop_landmarks(pbs, 0, 12, t(T_rel), PCFG.intrinsics, PCFG)
    bs = jpg.add_loop_landmarks(bs, pts_r, obs_r)
    pbs = ppg.add_loop_landmarks(pbs, pts, obs)
    assert int(pbs.n_points) == int(bs.n_points) == int(obs.valid.sum())
    assert int(pbs.lm_dropped) == 0
    r_lm, _ = jpg.optimize_landmark(bs, CFG.posegraph)
    p_lm, _ = ppg.optimize_landmark(pbs, PCFG.posegraph)
    np.testing.assert_allclose(n(p_lm.kf.poses), np.asarray(r_lm.kf.poses), atol=1e-4)
    np.testing.assert_allclose(n(p_lm.points), np.asarray(r_lm.points), atol=1e-4)


def test_add_loop_landmarks_drops_beyond_capacity():
    _, pbs = _backends()
    cap = pbs.points.shape[0]
    L = cap  # three quarters valid: the second call overflows
    valid = torch.ones(L, dtype=torch.bool)
    valid[::4] = False
    obs = ppg.ba.PairedObs(
        ka=torch.zeros(L, dtype=torch.int32), kb=torch.ones(L, dtype=torch.int32),
        za=torch.arange(3 * L, dtype=torch.float32).reshape(L, 3), zb=torch.zeros(L, 3),
        weight=torch.ones(L), valid=valid)
    pts = torch.arange(3 * L, dtype=torch.float32).reshape(L, 3)
    b1 = ppg.add_loop_landmarks(pbs, pts, obs)
    b2 = ppg.add_loop_landmarks(b1, pts, obs)
    n_valid = int(valid.sum())
    assert int(b2.n_points) == cap and int(b2.lm_dropped) == 2 * n_valid - cap
    np.testing.assert_array_equal(n(b1.points[:n_valid]), n(pts[valid]))
    assert bool(b2.lm.valid.all())
