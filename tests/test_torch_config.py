"""Port scaffolding: configuration mirror, import isolation, device choice."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import instancefusion_tpu.config as jcfg
from instancefusion_tpu.geometry import camera as jcam
from instancefusion_tpu.utils import ate as jate
from instancefusion_tpu_torch import config as pcfg
from instancefusion_tpu_torch.engine import slam
from instancefusion_tpu_torch.geometry import camera as pcam
from instancefusion_tpu_torch.ops import icp
from instancefusion_tpu_torch.utils import ate as pate
from tests.torch_helpers import blocks_cfg, to_port

REPO = Path(__file__).resolve().parents[1]
CLASSES = ["IcpConfig", "TsdfConfig", "RaycastConfig", "PreprocessConfig",
           "InstanceConfig", "PoseGraphConfig", "EngineConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_mirrors_reference(name):
    """Same fields, in the same order, with the same defaults."""
    jc, pc = getattr(jcfg, name), getattr(pcfg, name)
    assert ([f.name for f in dataclasses.fields(pc)]
            == [f.name for f in dataclasses.fields(jc)])
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


def test_intrinsics_mirror_reference():
    assert ([f.name for f in dataclasses.fields(pcam.Intrinsics)]
            == [f.name for f in dataclasses.fields(jcam.Intrinsics)])
    for name in ("TUM_FR1", "TUM_FR3"):
        assert dataclasses.asdict(getattr(pcam, name)) == dataclasses.asdict(
            getattr(jcam, name))
    for lvl in range(4):
        assert (dataclasses.asdict(pcam.TUM_FR1.level(lvl))
                == dataclasses.asdict(jcam.TUM_FR1.level(lvl)))


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_presets_mirror_reference(preset):
    port, ref = pcfg.PRESETS[preset](), jcfg.PRESETS[preset]()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert to_port(ref) == port


def test_package_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the
    reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import instancefusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'instancefusion_tpu' or m.startswith('instancefusion_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('instancefusion_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "instancefusion_tpu." not in src.replace("instancefusion_tpu_torch", "")


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_refuse_silent_cpu(monkeypatch):
    """With no card, an entry point without device='cpu' raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = to_port(jcfg.config2_tum_fr3_long_office())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.init_state(cfg)
    from instancefusion_tpu_torch.datasets import synthetic

    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.orbit_trajectory(3)


def test_unported_options_raise():
    """The sharded engine (``engine/slam_sharded.py``) refuses what the
    reference refuses (a dense map, stamps) and a group of another size
    than ``num_shards``.  The dense map and the
    block map without splat prediction start (test_torch_slam_dense.py);
    instances and stamps on the dense map raise the reference's ValueError.
    The photometric term, the stamps and the sentinel run
    (test_torch_slam.py)."""
    from instancefusion_tpu_torch.engine import slam_sharded
    from instancefusion_tpu_torch.parallel.mesh import ShardGroup

    cfg = to_port(jcfg.config2_tum_fr3_long_office())
    group = ShardGroup(0, 2, torch.device("cpu"))
    for change, why in ((dict(num_shards=4), "group of 2"),
                        (dict(num_shards=2, track_stamps=True), "single-shard"),
                        (dict(map_kind="dense", num_shards=2), "map_kind='blocks'")):
        with pytest.raises(ValueError, match=why):
            slam_sharded.init_state(dataclasses.replace(cfg, **change), group)
    for change in (dict(use_instances=True), dict(track_stamps=True)):
        with pytest.raises(ValueError, match="map_kind='blocks'"):
            slam.init_state(dataclasses.replace(to_port(jcfg.config1_tum_fr1_desk()),
                                                **change), device="cpu")
    small = to_port(blocks_cfg())
    ported = dataclasses.replace(small, track_stamps=True, consistency_check=True,
                                 icp=dataclasses.replace(small.icp, rgb_weight=0.1))
    state = slam.init_state(ported, device="cpu")
    assert state.stamp.shape == (small.tsdf.table_capacity, 2)
    assert state.drift_ewma.shape == (3,) and len(state.prev_coarse) == 3
    dense = slam.init_state(dataclasses.replace(small, map_kind="dense"), device="cpu")
    assert dense.volume.sdf.shape == (small.tsdf.grid_size,) * 3


def test_association_rounds_per_frame():
    """The bench ICP schedule runs 9 association rounds (K2 and K3 calls)
    per frame: 5 + 3 + 1 over the three levels."""
    cfg = pcfg.IcpConfig(iters=(10, 5, 4), assoc_every=(2, 2, 4))
    rounds = [icp.level_schedule(cfg, lvl) for lvl in (2, 1, 0)]
    assert rounds == [(2, 5), (2, 3), (4, 1)]


def test_ate_copy_matches_reference():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3))
    est = gt.copy()
    est[:, :3, 3] += 0.01 * rng.normal(size=(20, 3))
    assert pate.ate_rmse(est, gt) == jate.ate_rmse(est, gt)
    assert pate.rpe_rmse(est, gt) == jate.rpe_rmse(est, gt)
