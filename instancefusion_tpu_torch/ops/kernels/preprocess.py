"""Fused preprocess kernel K1 (``csrc/preprocess.cu``) and its plain version.

``fused_preprocess`` turns a raw depth image into pyramid level 0: clamped
and bilateral-filtered depth, vertex map, normal map and valid mask, in one
kernel for a CUDA tensor, at any bilateral radius whose tile fits the
card's shared memory (``tile_plan``); a CPU tensor runs
``fused_preprocess_ref``, the port's plain level-0 code.
``fused_preprocess.launches`` counts kernel launches: eager calls and
CUDA-graph captures, not a graph's replays.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from instancefusion_tpu_torch.config import PreprocessConfig
from instancefusion_tpu_torch.geometry.camera import Intrinsics, backproject
from instancefusion_tpu_torch.ops.kernels import _build

# csrc/preprocess.cu: tile width, the compile-time radii and their tile
# height, and the shared memory a block may opt into on an H100.
TILE_W, STATIC_RADII, STATIC_TILE_H = 32, (1, 2, 3, 4), 16
SMEM_DEFAULT, SMEM_OPTIN = 48 * 1024, 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_preprocess": [_P] * 5 + [_I] * 4 + [_P] + [_F] * 7 + [_P],
}
# Device tables of the spatial exponents for the runtime-radius instance,
# by (device, radius, sigma_space).
_DEVICE_TAPS: dict = {}


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


def smem_bytes(radius: int, tile_rows: int) -> int:
    """Shared memory of one block (csrc/preprocess.cu ``smem_bytes``): the
    raw tile with its halo of radius + 1, and the filtered ring."""
    h = radius + 1
    return 4 * ((TILE_W + 2 * h) * (tile_rows + 2 * h) + (TILE_W + 2) * (tile_rows + 2))


def tile_plan(radius: int) -> int:
    """The output rows of the kernel's tile at ``radius``.  Radii 1-4 take
    16 rows; every other radius 16 rows while the block fits the default 48
    KB of shared memory, else 8 (the kernel opts into more).  Raises
    ``ValueError`` where even 8 rows would exceed the 227 KB a block can
    have (radius 110 and above)."""
    if radius < 0:
        raise ValueError(f"the bilateral radius must be >= 0, not {radius}")
    if radius in STATIC_RADII or smem_bytes(radius, STATIC_TILE_H) <= SMEM_DEFAULT:
        return STATIC_TILE_H
    if smem_bytes(radius, 8) > SMEM_OPTIN:
        raise ValueError(
            f"the preprocess kernel's tile at bilateral radius {radius} needs "
            f"{smem_bytes(radius, 8)} bytes of shared memory, above the "
            f"{SMEM_OPTIN} a block can have on an H100")
    return 8


@functools.lru_cache(maxsize=None)
def _spatial_taps(radius: int, sigma_space: float) -> np.ndarray:
    """The bilateral's spatial exponent per tap, dy-major, as the fp32
    constant the plain version rounds it to (read-only: it is cached)."""
    inv2ss = 0.5 / (sigma_space**2)
    taps = np.array([-(dy * dy + dx * dx) * inv2ss
                     for dy in range(-radius, radius + 1)
                     for dx in range(-radius, radius + 1)], dtype=np.float32)
    taps.setflags(write=False)
    return taps


def _taps_arg(radius: int, sigma_space: float, device):
    """The kernel's ``spatial`` argument: host memory for the compile-time
    radii (copied into the launch's parameters), else a device table made
    once per device, radius and sigma."""
    taps = _spatial_taps(radius, sigma_space)
    if radius in STATIC_RADII:
        return taps.ctypes.data_as(ctypes.c_void_p)
    key = (device, radius, sigma_space)
    if key not in _DEVICE_TAPS:
        _DEVICE_TAPS[key] = torch.tensor(taps, device=device)
    return _build.ptr(_DEVICE_TAPS[key])


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
    r = cfg.bilateral_radius
    tile_rows = tile_plan(r)
    h, w = depth.shape
    df = torch.empty_like(depth)
    vmap = torch.empty((h, w, 3), dtype=torch.float32, device=depth.device)
    nmap = torch.empty_like(vmap)
    valid = torch.empty((h, w), dtype=torch.bool, device=depth.device)
    p = _build.ptr
    err = _lib().ifl_preprocess(
        p(depth), p(df), p(vmap), p(nmap), p(valid), w, h, r, tile_rows,
        _taps_arg(r, cfg.bilateral_sigma_space, depth.device),
        0.5 / (cfg.bilateral_sigma_depth**2), cfg.depth_min, cfg.depth_max,
        intr.fx, intr.fy, intr.cx, intr.cy, _build.stream_handle(),
    )
    _build.check(err, "fused_preprocess")
    fused_preprocess.launches += 1
    return df, vmap, nmap, valid


fused_preprocess.launches = 0
