"""Per-frame operations of the SLAM pipeline; the CUDA kernels and their
plain versions are under ``ops.kernels``.

``ba``, ``blocks``, ``ferns``, ``icp``, ``labels``, ``preprocess``,
``raycast`` and ``tsdf`` (the reference's re-exports) load on first access,
so importing one op does not import them all.
"""

import importlib

__all__ = ["ba", "blocks", "ferns", "icp", "labels", "preprocess", "raycast", "tsdf"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
