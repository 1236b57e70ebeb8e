"""Pose algebra and the pinhole camera."""

from instancefusion_tpu_torch.geometry.camera import Intrinsics, backproject, project
from instancefusion_tpu_torch.geometry.se3 import (
    se3_exp,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
    transform_points,
)

__all__ = [
    "se3_exp",
    "se3_log",
    "so3_exp",
    "so3_log",
    "se3_inverse",
    "transform_points",
    "Intrinsics",
    "project",
    "backproject",
]
