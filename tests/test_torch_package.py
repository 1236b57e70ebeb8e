"""The port's public surface: ``import instancefusion_tpu_torch`` in a fresh
process loads neither JAX nor a kernel build, and exposes the reference's
top-level names, its lazy subpackages and the re-exports of its
``geometry``, ``engine`` and ``ops`` packages."""

import json
import subprocess
import sys
from pathlib import Path

import instancefusion_tpu as ref
import instancefusion_tpu.engine as ref_engine
import instancefusion_tpu.geometry as ref_geometry
import instancefusion_tpu.ops as ref_ops

REPO = Path(__file__).resolve().parents[1]
TOP = ["EngineConfig", "IcpConfig", "InstanceConfig", "PoseGraphConfig", "PreprocessConfig",
       "PRESETS", "RaycastConfig", "TsdfConfig", "Intrinsics"]
SUBPACKAGES = ["engine", "ops", "models", "parallel", "datasets", "utils", "geometry"]

PROBE = r"""
import json, sys, types
import instancefusion_tpu_torch as pkg
after_import = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
kernel_modules = sorted(m for m in sys.modules if ".ops.kernels" in m)
top = {n: hasattr(pkg, n) for n in %(top)s}
presets = sorted(pkg.PRESETS)
subs = {n: isinstance(getattr(pkg, n), types.ModuleType) for n in %(subs)s}
geometry = sorted(pkg.geometry.__all__)
engine = sorted(n for n in pkg.engine.__all__ if isinstance(getattr(pkg.engine, n), types.ModuleType))
ops = sorted(n for n in pkg.ops.__all__ if isinstance(getattr(pkg.ops, n), types.ModuleType))
from instancefusion_tpu_torch.ops.kernels import _build
print(json.dumps(dict(
    jax_after_import=after_import, kernel_modules=kernel_modules, top=top, presets=presets,
    subs=subs, geometry=geometry, engine=engine, ops=ops,
    jax_after_subpackages=sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    built=sorted(_build._loaded))))
"""


def test_import_is_light_and_exposes_the_reference_names():
    code = PROBE % {"top": TOP, "subs": SUBPACKAGES}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax_after_import"] == [] and got["kernel_modules"] == []
    assert got["jax_after_subpackages"] == [] and got["built"] == []
    assert all(hasattr(ref, n) for n in TOP) and all(got["top"].values()), got["top"]
    assert got["presets"] == sorted(ref.PRESETS)
    assert all(got["subs"].values()), got["subs"]
    assert got["geometry"] == sorted(ref_geometry.__all__)
    want_engine = {"instances", "pipeline", "posegraph", "slam", "slam_sharded"}
    want_ops = {"ba", "blocks", "ferns", "icp", "labels", "preprocess", "raycast", "tsdf"}
    assert want_engine <= {n for n in vars(ref_engine)} and set(got["engine"]) == want_engine
    assert want_ops <= {n for n in vars(ref_ops)} and set(got["ops"]) == want_ops
