"""The slice as a whole on the two map kinds without splat prediction: the
dense volume (config1's engine at test scale) and the block map with the
touched-block integrate (K8) and the marched raycast.  The port's
``slam.step``, ``step_gt`` and ``run_chunk`` against the reference's on the
CPU, a dense state carried across, and the dense map's refusals."""

import dataclasses

import numpy as np
import pytest
import torch
from instancefusion_tpu.config import RaycastConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import slam as jslam
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import slam as pslam
from instancefusion_tpu_torch.ops import blocks as pblk
from instancefusion_tpu_torch.ops import tsdf as ptsdf
from tests.helpers import SMALL_CFG, SMALL_INTR
from tests.torch_helpers import (  # noqa: F401 (one_thread: an autouse fixture)
    blocks_cfg, n, one_thread, pose_error, reference_state_arrays, to_port,
)

MARCH = dataclasses.replace(
    blocks_cfg(), raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                                        screen_space_normals=True, use_splat=False))
CFGS = {"dense": SMALL_CFG, "march": MARCH}
# Held as tests/test_pallas.py:127-157 holds the TPU path against jnp.
POSE_ATOL, INLIER_TOL = 1e-4, 50
# The dense engine's ICP is ill-conditioned on the orbit's 3rd frame: a
# 1e-7 change in its normal equations moves the pose by ~6e-5.  PyTorch's
# multi-threaded CPU sums change their order with the thread count, while
# one thread sums in the reference's order; so the port runs on one thread
# here (`torch_helpers.one_thread`), and then agrees with the reference to
# ~1e-6 over every frame compared.
N_STEPS = 4
N_GT = 3


@pytest.fixture(scope="module", params=["dense", "march"])
def reference(request):
    """Frames, N_STEPS reference `step`s (poses, inliers, states) and 3 `step_gt`s
    (final state) for one map kind."""
    kind = request.param
    cfg = CFGS[kind]
    poses = jsyn.orbit_trajectory(12)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in range(N_STEPS)]
    state = jslam.init_state(cfg, poses[0])
    est, inliers, states = [], [], []
    for f in frames:
        state, info = jslam.step(cfg, state, f.depth, f.color)
        est.append(np.asarray(state.T_wc))
        inliers.append(float(info.inliers))
        states.append(reference_state_arrays(state))
    gt = jslam.init_state(cfg, poses[0])
    for i, f in enumerate(frames[:N_GT]):
        gt, _ = jslam.step_gt(cfg, gt, f.depth, f.color, poses[i])
    return dict(kind=kind, pcfg=to_port(cfg), poses=np.array(poses), est=est,
                inliers=inliers, states=states, gt=reference_state_arrays(gt),
                frames=[(np.array(f.depth), np.array(f.color)) for f in frames])


def test_steps_match_reference(reference):
    """Every frame tracks; poses within 1e-4 m / rad and inliers within 50
    of the reference's, frame by frame; then `run_chunk` over the same
    frames gives the same state as the steps."""
    pcfg, kind = reference["pcfg"], reference["kind"]
    frames = reference["frames"][:N_STEPS]
    depths = torch.tensor(np.stack([f[0] for f in frames]))
    colors = torch.tensor(np.stack([f[1] for f in frames]))
    state = pslam.init_state(pcfg, reference["poses"][0], device="cpu")
    for i, (d, c) in enumerate(zip(depths, colors)):
        state, info = pslam.step(pcfg, state, d, c)
        assert bool(info.track_ok)
        dt, dr = pose_error(n(state.T_wc), reference["est"][i])
        assert dt < POSE_ATOL and dr < POSE_ATOL, (i, dt, dr)
        assert abs(float(info.inliers) - reference["inliers"][i]) <= INLIER_TOL
    assert isinstance(state.volume, ptsdf.TsdfVolume if kind == "dense" else pblk.BlockMap)
    chunk = pslam.init_state(pcfg, reference["poses"][0], device="cpu")
    chunk, infos = pslam.run_chunk(pcfg, chunk, depths, colors)
    assert torch.equal(chunk.T_wc, state.T_wc)
    assert torch.equal(chunk.volume.sdf, state.volume.sdf)
    assert torch.equal(chunk.pred.valid, state.pred.valid)
    assert infos.track_ok.shape == (len(frames),) and bool(infos.track_ok.all())
    assert chunk.frame_count == len(frames) and int(chunk.frame_idx) == len(frames)


def test_fourth_step_from_reference_state(reference):
    """The reference's state after 3 steps, converted, takes the 4th step in
    the port: pose within 1e-4 and inliers within 50 of the reference's."""
    pcfg = reference["pcfg"]
    state = convert.state_from_numpy(reference["states"][2], pcfg, device="cpu")
    state, info = pslam.step(pcfg, state, *reference["frames"][3])
    assert bool(info.track_ok)
    dt, dr = pose_error(n(state.T_wc), reference["est"][3])
    assert dt < POSE_ATOL and dr < POSE_ATOL, (dt, dr)
    assert abs(float(info.inliers) - reference["inliers"][3]) <= INLIER_TOL


def test_step_gt_matches_reference(reference):
    """3 frames at the reference's poses: the map (weight exact on the
    dense volume and sdf within 1e-5; on the block map the directory and
    counts equal and the payload on >= 99.9% of voxels within the K4 test's
    bounds) and the prediction (valid sets within 0.5% of the rays, depth
    within 1e-4 m where both are valid: the maps differ by up to 1e-5 of the
    band, which a grazing ray turns into tens of microns)."""
    pcfg, kind, ref = reference["pcfg"], reference["kind"], reference["gt"]
    state = pslam.init_state(pcfg, reference["poses"][0], device="cpu")
    for i, (d, c) in enumerate(reference["frames"][:N_GT]):
        state, info = pslam.step_gt(pcfg, state, d, c, reference["poses"][i])
        assert bool(info.track_ok)
    out = convert.state_to_numpy(state)
    if kind == "dense":
        np.testing.assert_array_equal(out["volume.weight"], ref["volume.weight"])
        np.testing.assert_allclose(out["volume.sdf"], ref["volume.sdf"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["volume.color"], ref["volume.color"], rtol=0,
                                   atol=1e-5)
    else:
        for name in ("directory", "block_coords", "n_active", "overflow"):
            np.testing.assert_array_equal(out[f"volume.{name}"], ref[f"volume.{name}"])
        for name, tol in (("sdf", 5e-4), ("weight", 1e-5), ("color", 5e-3)):
            share = (np.abs(out[f"volume.{name}"] - ref[f"volume.{name}"]) <= tol).mean()
            assert share >= 0.999, (name, share)
    vr, vo = ref["pred.valid"], out["pred.valid"]
    assert vr.sum() > 5000 and (vr ^ vo).sum() <= 0.005 * vr.sum()
    both = vr & vo
    assert np.abs(out["pred.depth"] - ref["pred.depth"])[both].max() < 1e-4


def test_state_round_trip(reference):
    """The state, the dense volume or the block map under ``volume.*``,
    comes across and back unchanged; the other map kind refuses it."""
    kind = reference["kind"]
    arrays = reference["states"][1]
    assert ("volume.directory" in arrays) == (kind == "march")
    state = convert.state_from_numpy(arrays, reference["pcfg"], device="cpu")
    assert isinstance(state.volume, ptsdf.TsdfVolume if kind == "dense" else pblk.BlockMap)
    back = convert.state_to_numpy(state)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    other = to_port(MARCH if kind == "dense" else SMALL_CFG)
    with pytest.raises(ValueError):
        convert.state_from_numpy(arrays, other, device="cpu")


def test_dense_refusals(monkeypatch):
    """Instances and stamps need the block map (the reference's
    ValueErrors); with no card and no device the entry point raises."""
    pcfg = to_port(SMALL_CFG)
    for change in (dict(use_instances=True), dict(track_stamps=True)):
        with pytest.raises(ValueError, match="map_kind='blocks'"):
            pslam.init_state(dataclasses.replace(pcfg, **change), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pslam.init_state(pcfg)
