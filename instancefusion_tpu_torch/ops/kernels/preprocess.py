"""Fused preprocess kernel K1 (``csrc/preprocess.cu``) and its plain version.

``fused_preprocess`` turns a raw depth image into pyramid level 0: clamped
and bilateral-filtered depth, vertex map, normal map and valid mask, in one
kernel for a CUDA tensor; a CPU tensor runs ``fused_preprocess_ref``, the
port's plain level-0 code.  ``fused_preprocess.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from instancefusion_tpu_torch.config import PreprocessConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics, backproject
from instancefusion_tpu_torch.ops.kernels import _build

MAX_RADIUS = 4  # csrc/preprocess.cu MAX_R

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_preprocess": [_P] * 5 + [_I] * 3 + [_P] + [_F] * 7 + [_P],
}


def _lib():
    return _build.load("preprocess", _SIGNATURES)


def fused_preprocess_ref(depth: torch.Tensor, intr: Intrinsics, cfg: PreprocessConfig):
    """Plain K1: clamp -> bilateral -> vertex map -> normals, level 0.

    Returns (df f32[H, W], vmap f32[H, W, 3], nmap f32[H, W, 3], valid
    bool[H, W]) with valid = (df > 0) & normal valid.
    """
    from instancefusion_tpu_torch.ops import preprocess as pp

    df = pp.bilateral_filter(pp.clamp_depth(depth, cfg), cfg)
    vmap = backproject(intr, df)
    nmap, nvalid = pp.compute_normals(vmap)
    return df, vmap, nmap, (df > 0.0) & nvalid


def _spatial_taps(cfg: PreprocessConfig) -> np.ndarray:
    """The bilateral's spatial exponent per tap, dy-major, as the fp32
    constant the plain version rounds it to."""
    r = cfg.bilateral_radius
    inv2ss = 0.5 / (cfg.bilateral_sigma_space**2)
    return np.array([-(dy * dy + dx * dx) * inv2ss
                     for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
                    dtype=np.float32)


def fused_preprocess(depth: torch.Tensor, intr: Intrinsics, cfg: PreprocessConfig):
    """Level 0 of the frame pyramid from raw depth f32[H, W] (0 = invalid).

    Returns (df, vmap, nmap, valid) as ``fused_preprocess_ref``; vmap and
    nmap are interleaved (H, W, 3).
    """
    if depth.device.type == "cpu":
        return fused_preprocess_ref(depth, intr, cfg)
    _build.check_tensors({"depth": depth}, depth.device)
    if depth.dtype != torch.float32 or depth.shape != (intr.height, intr.width):
        raise ValueError(f"depth must be f32[{intr.height}, {intr.width}]")
    if not 0 <= cfg.bilateral_radius <= MAX_RADIUS:
        raise ValueError(f"the preprocess kernel takes a bilateral radius of at "
                         f"most {MAX_RADIUS}, not {cfg.bilateral_radius}")
    h, w = depth.shape
    df = torch.empty_like(depth)
    vmap = torch.empty((h, w, 3), dtype=torch.float32, device=depth.device)
    nmap = torch.empty_like(vmap)
    valid = torch.empty((h, w), dtype=torch.bool, device=depth.device)
    taps = _spatial_taps(cfg)
    p = _build.ptr
    err = _lib().ifl_preprocess(
        p(depth), p(df), p(vmap), p(nmap), p(valid), w, h, cfg.bilateral_radius,
        taps.ctypes.data_as(ctypes.c_void_p),
        0.5 / (cfg.bilateral_sigma_depth**2), cfg.depth_min, cfg.depth_max,
        intr.fx, intr.fy, intr.cx, intr.cy, _build.stream_handle(),
    )
    _build.check(err, "fused_preprocess")
    fused_preprocess.launches += 1
    return df, vmap, nmap, valid


fused_preprocess.launches = 0
