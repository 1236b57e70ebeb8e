"""Local loop closure (engine/localloop.py) in the port against the
reference on the CPU: the two engine tests of tests/test_localloop.py
(stamps and gaps; `attempt` recovers injected drift) on the splat block map
of `torch_helpers.blocks_cfg()`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import localloop as jll
from instancefusion_tpu.engine import slam as jslam
from instancefusion_tpu.geometry.se3 import se3_exp
from instancefusion_tpu.ops import preprocess as jpp
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import localloop as pll
from instancefusion_tpu_torch.engine import slam as pslam
from tests.helpers import SMALL_INTR
from tests.torch_helpers import blocks_cfg, n, pose_error, reference_state_arrays, t, to_port

JCFG = dataclasses.replace(blocks_cfg(), track_stamps=True)
PCFG = to_port(JCFG)
N = 6
POSE_TOL = 5e-4  # m of translation, rad of rotation (tests/test_torch_slam.py)


@pytest.fixture(scope="module")
def runs():
    """6 frames of `step_gt` along the orbit in both packages."""
    poses = np.array(jsyn.orbit_trajectory(N))
    frames = [jsyn.render_frame(p, SMALL_INTR) for p in poses]
    frames_np = [(np.array(f.depth), np.array(f.color)) for f in frames]
    jstate = jslam.init_state(JCFG, poses[0])
    pstate = pslam.init_state(PCFG, poses[0], device="cpu")
    for (d, c), T in zip(frames_np, poses):
        jstate, _ = jslam.step_gt(JCFG, jstate, d, c, T)
        pstate, _ = pslam.step_gt(PCFG, pstate, d, c, T)
    return dict(poses=poses, frames=frames_np, jstate=jstate, pstate=pstate)


def test_stamps_and_gaps_match_reference(runs):
    """Stamps equal after 6 frames and after a revisit following a long
    look-away; the revisit records its gap and the evidence counts agree."""
    jstate, pstate = runs["jstate"], runs["pstate"]
    np.testing.assert_array_equal(n(pstate.stamp), np.asarray(jstate.stamp))
    assert int(pstate.volume.n_active) > 20
    assert int(pstate.stamp[:, 0].max()) == int(pstate.frame_idx) == N
    assert int(pstate.stamp[:, 1].max()) <= 6
    # Age every stamp, then fuse frame 0 again at frame 401.
    jaged = jstate._replace(
        stamp=jstate.stamp.at[:, 0].set(jnp.where(jstate.stamp[:, 0] > 0, 1, 0)),
        frame_idx=jnp.asarray(400, jnp.int32))
    last = torch.where(pstate.stamp[:, 0] > 0, 1, 0).to(torch.int32)
    paged = pstate._replace(stamp=torch.stack([last, pstate.stamp[:, 1]], -1),
                            frame_idx=torch.tensor(400, dtype=torch.int32))
    (d, c), T = runs["frames"][0], runs["poses"][0]
    jaged, _ = jslam.step_gt(JCFG, jaged, d, c, T)
    paged, _ = pslam.step_gt(PCFG, paged, d, c, T)
    np.testing.assert_array_equal(n(paged.stamp), np.asarray(jaged.stamp))
    assert int(paged.stamp[:, 1].max()) >= 390
    count = int(pll.evidence_count(PCFG, paged))
    assert count == int(jll.evidence_count(JCFG, jaged)) and count > 10


def test_attempt_matches_reference(runs):
    """On the same aged, drifted state: both recover the injected drift, the
    corrected poses agree within POSE_TOL, and consuming the evidence agrees."""
    cfg_j = dataclasses.replace(JCFG, posegraph=dataclasses.replace(
        JCFG.posegraph, local_window=50, local_min_pixels=1500))
    cfg_p = to_port(cfg_j)
    xi = jnp.asarray([0.02, -0.015, 0.01, 0.008, -0.006, 0.01], jnp.float32)
    T_true = jnp.asarray(runs["poses"][5])
    T_drift = se3_exp(xi) @ T_true
    js = runs["jstate"]
    jstate = js._replace(
        stamp=js.stamp.at[:, 1].set(jnp.where(js.stamp[:, 0] > 0, 200, 0)),
        frame_idx=jnp.asarray(300, jnp.int32), T_wc=T_drift)
    pstate = convert.state_from_numpy(reference_state_arrays(jstate), cfg_p, device="cpu")
    lvl = jpp.build_frame_pyramid(runs["frames"][5][0], SMALL_INTR, cfg_j.preprocess, 1)[0]
    maps = (lvl["vmap"], lvl["nmap"], lvl["valid"])
    ref = jll.attempt(cfg_j, jstate, *maps)
    out = pll.attempt(cfg_p, pstate, *(t(x) for x in maps))
    assert bool(ref.ok) and bool(out.ok)
    assert float(out.pred_pixels) >= 1500
    assert abs(float(out.pred_pixels) - float(ref.pred_pixels)) <= 0.01 * float(ref.pred_pixels)
    dt, dr = pose_error(n(out.T_corr_wc), ref.T_corr_wc)
    assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    T_true = np.asarray(T_true)
    err_t = np.linalg.norm(n(out.T_corr_wc)[:3, 3] - T_true[:3, 3])
    drift_t = np.linalg.norm(np.asarray(T_drift)[:3, 3] - T_true[:3, 3])
    assert err_t < 0.25 * drift_t
    assert pose_error(n(out.T_corr_wc), T_true)[1] < 0.01
    j_reset = jll.reset_gaps(jstate.stamp, 50)
    p_reset = pll.reset_gaps(pstate.stamp, 50)
    np.testing.assert_array_equal(n(p_reset), np.asarray(j_reset))
    count = int(pll.evidence_count(cfg_p, pstate._replace(stamp=p_reset)))
    assert count == int(jll.evidence_count(cfg_j, jstate._replace(stamp=j_reset))) == 0
    assert int(pll.evidence_count(cfg_p, pstate)) > 0
