"""PyTorch/CUDA port of ``instancefusion_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it stays the reference.  This package imports
neither JAX nor any module of the reference: it keeps its own copies of the
configuration, geometry and numpy-only helpers.  Its hot kernels are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at
first use (``ops/kernels/_build.py``); each has a plain PyTorch version
beside it, which the wrapper runs for tensors on the CPU.

Entry points (``engine.slam.init_state``, ``datasets.synthetic``,
``convert.state_from_numpy``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that argument they raise.

The package re-exports the configuration classes, ``PRESETS`` and
``Intrinsics``, and loads its subpackages (``engine``, ``ops``, ``models``,
``parallel``, ``datasets``, ``utils``, ``geometry``) on first access, as
the reference does; importing it builds no kernel.
"""

__version__ = "0.1.0"

# Public API: the stable entry points a user of the package needs.
from instancefusion_tpu_torch.config import (  # noqa: E402,F401
    PRESETS,
    EngineConfig,
    IcpConfig,
    InstanceConfig,
    PoseGraphConfig,
    PreprocessConfig,
    RaycastConfig,
    TsdfConfig,
)
from instancefusion_tpu_torch.geometry.camera import Intrinsics  # noqa: E402,F401

_SUBPACKAGES = {"engine", "ops", "models", "parallel", "datasets", "utils", "geometry"}


def __getattr__(name):
    """Lazy subpackage access (keeps ``import instancefusion_tpu_torch`` light)."""
    import importlib

    if name in _SUBPACKAGES:
        return importlib.import_module(f"instancefusion_tpu_torch.{name}")
    raise AttributeError(f"module 'instancefusion_tpu_torch' has no attribute {name!r}")
