"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py).

The same inputs, made with numpy or by the JAX reference on the CPU, go
through the reference and through the port with ``device="cpu"``, where
each kernel wrapper runs its plain PyTorch version.  The CUDA kernels
themselves are held against those plain versions by
``tests/test_torch_kernels.py`` (skipped without a card) and by
``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.config import RaycastConfig
from instancefusion_tpu_torch import config as port_config
from tests.helpers import SMALL_CFG, SMALL_TSDF

# The block-map splat configuration at test scale (tests/test_splat.py).
BLOCKS_TSDF = dataclasses.replace(
    SMALL_TSDF, block_size=8, table_capacity=1728, touched_capacity=512
)
RMAX = 3


def blocks_cfg():
    """SMALL_CFG on the block map with splat prediction (reference classes)."""
    return dataclasses.replace(
        SMALL_CFG,
        map_kind="blocks",
        tsdf=BLOCKS_TSDF,
        raycast=RaycastConfig(
            near=0.2, far=4.0, use_depth_prior=True,
            screen_space_normals=True, use_splat=True, splat_rmax=RMAX,
        ),
    )


def gt_segmentation(instance: np.ndarray, k: int):
    """Ground-truth masks as the numpy fields of a ``Segmentation``, made by
    the reference's own construction (tests/test_instances.py): class =
    id + 1, ids 0..3.  The port's ``synthetic.gt_segmentation`` is held to
    it by tests/test_torch_instances.py."""
    from tests.test_instances import gt_segmentation as reference_gt

    seg = reference_gt(SimpleNamespace(instance=jnp.asarray(instance)), k)
    return tuple(np.asarray(x) for x in seg)


def to_port(obj):
    """A reference config dataclass -> the port's class of the same name."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(port_config, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def t(x) -> torch.Tensor:
    """A reference array (or numpy array) as a CPU tensor."""
    return torch.as_tensor(np.array(x))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reference_state_arrays(state) -> dict:
    """A reference SlamState as field-path numpy arrays (the keys of the
    port's ``convert.state_to_numpy``)."""
    state = jax.device_get(state)
    out = {k: np.asarray(getattr(state, k))
           for k in ("T_wc", "pred_T_wc", "frame_idx", "lost_frames", "T_prev_wc")}
    for prefix in ("volume", "pred", "votes", "table"):
        if getattr(state, prefix) is not None:
            for name, v in getattr(state, prefix)._asdict().items():
                out[f"{prefix}.{name}"] = np.asarray(v)
    for name in ("stamp", "drift_ewma"):
        if getattr(state, name) is not None:
            out[name] = np.asarray(getattr(state, name))
    if state.prev_coarse is not None:
        for i, v in enumerate(state.prev_coarse):
            out[f"prev_coarse.{i}"] = np.asarray(v)
    return out


def pose_error(a, b):
    """(largest translation difference in m, rotation angle in rad) between
    two 4x4 poses.  The angle comes from the chord ||R_a - R_b||_F =
    2 sqrt(2) sin(theta / 2), which keeps its precision near 0, where
    arccos((trace - 1) / 2) turns fp32 rounding of ~1e-7 into ~5e-4 rad."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return np.abs(a[:3, 3] - b[:3, 3]).max(), 2.0 * np.arcsin(min(chord, 1.0))


def sample_points(seed: int, near: np.ndarray, m: int = 4000) -> np.ndarray:
    """Points within a voxel of the given observed points `near` (N, 3),
    anywhere inside the volume, and outside it (the volume spans
    [-1.92, 1.92]^2 x [-0.4, 3.44])."""
    rng = np.random.default_rng(seed)
    pick = near[rng.integers(0, len(near), m)]
    return np.concatenate([
        pick + rng.uniform(-0.04, 0.04, (m, 3)),
        rng.uniform([-1.9, -1.9, -0.38], [1.9, 1.9, 3.4], (m, 3)),
        rng.uniform(-4.0, 5.0, (m // 4, 3)),
    ]).astype(np.float32)


def observed_points(weight: np.ndarray, origin, voxel: float) -> np.ndarray:
    """World centers of the voxels with weight > 0."""
    return np.argwhere(weight > 0) * voxel + np.asarray(origin) + 0.5 * voxel


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run a module's port code on one CPU thread, restoring the count
    after: the reference's (XLA's) threads and the test workers already
    share the cores, and one thread sums in the reference's order (the
    dense engine's ICP amplifies a reordered sum: test_torch_slam_dense.py).
    Autouse in every module that imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_frames(frames):
    """Reference synthetic Frames (jax arrays) as the port's Frames on the
    CPU, the same values."""
    from instancefusion_tpu_torch.datasets.synthetic import Frame

    return [Frame(*(t(x) for x in f)) for f in frames]


def reference_backend_arrays(bs) -> dict:
    """A reference BackendState as field-path numpy arrays (the keys of the
    port's ``convert.backend_to_numpy``)."""
    from instancefusion_tpu_torch import convert

    return {k: np.asarray(v) for k, v in convert.flatten(jax.device_get(bs)).items()
            if v is not None}


class ListWriter:
    """A MetricsWriter that keeps the records in a list."""

    def __init__(self):
        self.rows = []

    def write(self, record):
        self.rows.append(record)

    def close(self):
        pass


@pytest.fixture
def reference_coder(monkeypatch):
    """Make the port's ``posegraph.allocate`` carry in the reference's fern
    coder (``jax.random`` cannot be replayed in torch): the reference's own
    empty backend for the configuration the port is given, through
    ``convert.backend_from_numpy``.  Retrieval decisions then compare."""
    from instancefusion_tpu.config import EngineConfig as RefConfig
    from instancefusion_tpu.engine import posegraph as jpg
    from instancefusion_tpu_torch import convert
    from instancefusion_tpu_torch.engine import posegraph as ppg

    def to_reference(obj):
        import instancefusion_tpu.config as rc
        import instancefusion_tpu.geometry.camera as rcam

        if dataclasses.is_dataclass(obj):
            cls = getattr(rc, type(obj).__name__, None) or getattr(rcam, type(obj).__name__)
            return cls(**{f.name: to_reference(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})
        return obj

    def allocate(cfg, decim=4, seed=0, device=None):
        ref_cfg = to_reference(cfg)
        assert isinstance(ref_cfg, RefConfig)
        arrays = reference_backend_arrays(jpg.allocate(ref_cfg, decim, seed))
        return convert.backend_from_numpy(arrays, device=device)

    monkeypatch.setattr(ppg, "allocate", allocate)


def drift_reference() -> None:
    """The JAX reference on the sustained-drift rig, on the CPU:

        python -m tests.torch_helpers          # N=120 SEED=0; ~17 min on 4 cores

    ``_check_drift_pipeline.py``'s rig and configuration with the semantics
    of its TPU run (splat prediction, the jnp path of every kernel): the
    bare engine (``slam.step_donated``), then ``pipeline.run`` on the same
    frames; prints each one's mean and largest translation error, the
    sentinel's EWMA, the keyframes, loops, alarms and relocalizations.
    ``chip_smoke.py``'s drift-pipeline phase prints the port's run beside
    these numbers.  Env: N (120), SEED (noise key, 0).
    """
    import os
    import time

    from instancefusion_tpu.config import (
        EngineConfig, IcpConfig, PoseGraphConfig, PreprocessConfig, TsdfConfig,
    )
    from instancefusion_tpu.datasets import synthetic
    from instancefusion_tpu.engine import pipeline, slam
    from instancefusion_tpu.geometry.camera import TUM_FR1
    from instancefusion_tpu.utils.ate import ate_rmse

    jax.config.update("jax_platforms", "cpu")
    n, seed = int(os.environ.get("N", "120")), int(os.environ.get("SEED", "0"))
    grid = 512
    extent = grid * 0.0075
    cfg = EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
                        grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
                        block_size=8, table_capacity=65536, touched_capacity=2048),
        icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0, assoc_every=(2, 2, 4), vel_seed=0.8),
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True, use_splat=True, predict_color=False),
        preprocess=PreprocessConfig(),
        posegraph=PoseGraphConfig(keyframe_every=8, loop_dist_thresh=0.12),
        map_kind="blocks", use_color=True, consistency_check=True, consistency_thresh=0.0012,
    )
    poses = synthetic.handheld_trajectory(n, sweep=1.6, shake_rot=0.02, shake_trans=0.008)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    frames = [synthetic.add_sensor_noise(synthetic.render_frame(poses[i], cfg.intrinsics),
                                         keys[i]) for i in range(n)]
    gt = np.asarray(poses)
    t0 = time.time()
    state = slam.init_state(cfg, poses[0])
    est, ewma = [], []
    for f in frames:
        state, info = slam.step_donated(cfg, state, f.depth, f.color)
        est.append(np.asarray(state.T_wc))
        ewma.append(float(info.drift_ewma) * 1e3)
    err = np.linalg.norm(np.stack(est)[:, :3, 3] - gt[:, :3, 3], axis=-1) * 1e3
    print(f"bare: mean {err.mean():.2f} mm, max {err.max():.2f} mm ({time.time() - t0:.0f} s)")
    print("  error every 4th frame (mm):", np.round(err[::4], 1).tolist())
    print("  sentinel EWMA every 4th frame (mm):", np.round(ewma[::4], 2).tolist())
    rows = ListWriter()
    t0 = time.time()
    res = pipeline.run(cfg, frames, T_init_wc=gt[0], metrics=rows, enable_loops=True,
                       relocalize_after=5)
    err = np.linalg.norm(res.poses[:, :3, 3] - gt[:, :3, 3], axis=-1) * 1e3
    print(f"pipeline: mean {err.mean():.2f} mm, max {err.max():.2f} mm, ATE "
          f"{ate_rmse(res.poses, gt) * 1e3:.2f} mm, {res.n_keyframes} keyframes, "
          f"{res.n_loops} loops, alarms on "
          f"{sum(bool(r.get('drift_alarm', False)) for r in rows.rows)} frames, "
          f"{sum(r['relocalized'] for r in rows.rows)} relocalizations "
          f"({time.time() - t0:.0f} s)")
    print("  error every 4th frame (mm):", np.round(err[::4], 1).tolist())
    print("  keyframes:", [r["frame"] for r in rows.rows if r["keyframe"]],
          "loops:", [r["frame"] for r in rows.rows if r["loop_closed"]])


if __name__ == "__main__":
    drift_reference()
