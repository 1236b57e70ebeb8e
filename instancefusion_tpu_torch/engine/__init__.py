"""Per-frame SLAM engine, backend and pipeline.

``instances``, ``pipeline``, ``posegraph``, ``slam`` and ``slam_sharded``
(the reference's re-exports) load on first access: importing them here
would close an import cycle through ``convert`` and ``utils/checkpoint``.
"""

import importlib

__all__ = ["instances", "pipeline", "posegraph", "slam", "slam_sharded"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
