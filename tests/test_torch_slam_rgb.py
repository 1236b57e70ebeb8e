"""The photometric term, the drift sentinel and the observation stamps in the
port's `slam.step`, against the reference's on the CPU (textured frames of
the block-map splat configuration)."""

import dataclasses

import numpy as np
import pytest

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import slam as jslam
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import slam as pslam
from instancefusion_tpu_torch.ops.kernels import icp as kicp
from tests.helpers import SMALL_INTR
from tests.torch_helpers import (
    blocks_cfg, n, pose_error, reference_state_arrays, to_port,
)

N_REF = 4
POSE_TOL = 5e-4  # m of translation, rad of rotation (tests/test_torch_slam.py)

JCFG_RGB = dataclasses.replace(
    blocks_cfg(), icp=dataclasses.replace(blocks_cfg().icp, rgb_weight=0.1),
    consistency_check=True, track_stamps=True)
PCFG_RGB = to_port(JCFG_RGB)


@pytest.fixture(scope="module")
def reference_rgb():
    """4 reference `step`s on textured frames: poses, stamps and sentinel
    outputs per step, and the final state."""
    poses = jsyn.orbit_trajectory(12)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR, texture=True) for i in range(N_REF)]
    state = jslam.init_state(JCFG_RGB, poses[0])
    steps = []
    for f in frames:
        state, info = jslam.step(JCFG_RGB, state, f.depth, f.color)
        steps.append(dict(T=np.asarray(state.T_wc), stamp=np.asarray(state.stamp),
                          ewma=float(info.drift_ewma), alarm=bool(info.drift_alarm)))
    return dict(poses=np.array(poses), steps=steps, state=reference_state_arrays(state),
                frames=[(np.array(f.depth), np.array(f.color)) for f in frames])


def test_rgb_sentinel_stamps_match_reference(reference_rgb):
    """Poses within POSE_TOL, stamps equal, the sentinel's alarm equal and
    its EWMA within 1e-4 m, every step."""
    ref = reference_rgb
    state = pslam.init_state(PCFG_RGB, ref["poses"][0], device="cpu")
    for i, (d, c) in enumerate(ref["frames"]):
        state, info = pslam.step(PCFG_RGB, state, d, c)
        r = ref["steps"][i]
        assert bool(info.track_ok)
        dt, dr = pose_error(n(state.T_wc), r["T"])
        assert dt < POSE_TOL and dr < POSE_TOL, (i, dt, dr)
        np.testing.assert_array_equal(n(state.stamp), r["stamp"], err_msg=str(i))
        assert bool(info.drift_alarm) == r["alarm"]
        assert abs(float(info.drift_ewma) - r["ewma"]) < 1e-4, (i, float(info.drift_ewma))
    assert int(state.stamp[:, 0].max()) == N_REF
    assert float(info.drift_ewma) > 0.0  # the sentinel measured something
    assert float(kicp.gn_iterations.last_wr) > 0.0  # the photometric term ran


def test_state_round_trip_with_sentinel(reference_rgb):
    """stamp, prev_coarse.* and drift_ewma come across and back unchanged."""
    arrays = reference_rgb["state"]
    state = convert.state_from_numpy(arrays, PCFG_RGB, device="cpu")
    assert state.stamp is not None and len(state.prev_coarse) == 3
    back = convert.state_to_numpy(state)
    assert back.keys() == arrays.keys() and "prev_coarse.2" in back
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
