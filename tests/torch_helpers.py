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
