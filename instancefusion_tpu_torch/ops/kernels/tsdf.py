"""TSDF kernels K4 and K8 (``csrc/tsdf.cu``) and their plain versions.

``integrate`` (K4) fuses one depth frame (and, on color frames, its colors)
into the listed payload rows of a block map, in place: the map's ``sdf``,
``weight`` and ``color`` tensors are updated and no copy of the payload is
made.  ``tsdf_update`` (K8) is the running-average half alone: it takes
per-voxel observations computed outside the kernel (the touched-block
integrate of ``ops/blocks.py``) and updates the listed rows in place.
CUDA tensors launch the kernels, CPU tensors run ``integrate_ref`` and
``tsdf_update_ref``.  Each wrapper's ``launches`` counts its launches,
``integrate.launches_color`` those that fuse color: eager calls and
CUDA-graph captures, not a graph's replays.
"""

from __future__ import annotations

import ctypes

import torch

from instancefusion_tpu_torch.geometry.camera import Intrinsics, nearest_pixel, project
from instancefusion_tpu_torch.geometry.se3 import cam_rows, se3_inverse_rows
from instancefusion_tpu_torch.ops.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_integrate_grid": [_P],
    "ifl_integrate": [_P, _P, _I, _I] + [_P] * 7 + [_I] * 3 + [_F] * 11 + [_P],
    "ifl_tsdf_update_grid": [_P],
    "ifl_tsdf_update": [_P, _P, _I, _I, _I] + [_P] * 6 + [_F, _F, _P],
}


def _lib():
    return _build.load("tsdf", _SIGNATURES)


def voxel_centers(coords: torch.Tensor, cfg) -> torch.Tensor:
    """World centers (K, B^3, 3) of the voxels of blocks ``coords`` (K, 3);
    voxels are ordered x-major within a block."""
    b = cfg.block_size
    idx = torch.arange(b * b * b, device=coords.device)
    local = torch.stack([idx // (b * b), (idx // b) % b, idx % b], dim=-1)
    vox = coords[:, None, :] * b + local[None]
    p = (vox.float() + 0.5) * cfg.voxel_size
    return torch.stack([p[..., i] + cfg.origin[i] for i in range(3)], dim=-1)


def project_voxels(block_coords, slots, T_wc, intr: Intrinsics, cfg):
    """Per voxel of the listed rows, (K, B^3) each: its camera depth z, the
    flat index of the pixel it projects to (rounded half to even, clamped
    into the image) and whether that pixel is in the image with z > 0.

    One rounding per operation in a fixed order (``se3_inverse_rows``,
    ``cam_rows``, ``project``), as K4 and K7 compute it: both kernels place
    every voxel on this pixel.
    """
    p_w = voxel_centers(block_coords[slots.long()], cfg)
    u, v, z = project(intr, cam_rows(p_w, se3_inverse_rows(T_wc)))
    in_img, pix = nearest_pixel(intr, u, v)
    return z, pix, in_img & (z > 0.0)


def integrate_ref(block_coords, sdf, weight, color, slots, valid, depth,
                  frame_color, T_wc, intr: Intrinsics, cfg, color_gain=1.0):
    """Plain K4: the reference's jnp ``integrate_slots`` update, in place.

    Per voxel of each valid listed slot: project (round half to even),
    read depth, psi = clip((d - z) / trunc, -1, 1) where z > 0, d > 0 and
    d - z > -trunc; weighted running average with the UNOBSERVED sentinel
    kept where nothing was ever fused, weight capped at max_weight; color
    averaged with weight ``color_gain`` when ``frame_color`` is given.
    """
    slots = slots[valid].long()  # valid slots are unique
    z, pix, seen = project_voxels(block_coords, slots, T_wc, intr, cfg)
    d = depth.reshape(-1)[pix]
    sdf_obs = d - z
    ok = seen & (d > 0.0) & (sdf_obs > -cfg.trunc)
    # A tensor divisor: CUDA divides by a Python scalar as a product by its
    # reciprocal, the kernel and the CPU divide.
    psi = torch.clamp(sdf_obs / sdf_obs.new_full((), cfg.trunc), -1.0, 1.0)
    w_obs = ok.float()

    s_old, w_old = sdf[slots], weight[slots]
    w_new = w_old + w_obs
    sdf[slots] = torch.where(
        w_new > 0.0, (s_old * w_old + psi * w_obs) / torch.clamp(w_new, min=1e-6), s_old
    )
    weight[slots] = torch.clamp(w_new, max=cfg.max_weight)
    if frame_color is not None:
        b3 = w_old.shape[1]
        c_obs = frame_color.reshape(-1, 3)[pix]  # (K, B^3, 3)
        c_old = color[slots]
        wc = color_gain * w_obs
        den = torch.clamp(w_old + wc, min=1e-6)
        for c in range(3):
            seg = slice(c * b3, (c + 1) * b3)
            c_old[:, seg] = (c_old[:, seg] * w_old + c_obs[..., c] * wc) / den
        color[slots] = c_old


def integrate(block_coords, sdf, weight, color, slots, valid, depth,
              frame_color, T_wc, intr: Intrinsics, cfg, color_gain=1.0):
    """Fuse one frame into the listed payload rows, in place.

    block_coords i32[C, 3]; sdf, weight f32[C, B^3]; color f32[C, 3 B^3]
    (packed [r | g | b]); slots i32[K] with valid bool[K] (valid slots
    unique); depth f32[H, W]; frame_color f32[H, W, 3] or None (no color
    fusion this frame); T_wc f32[4, 4].  On the card one launch and no
    other device op: the kernel inverts the pose itself.
    """
    if sdf.device.type == "cpu":
        integrate_ref(block_coords, sdf, weight, color, slots, valid, depth,
                      frame_color, T_wc, intr, cfg, color_gain)
        return
    dev = sdf.device
    tensors = dict(block_coords=block_coords, sdf=sdf, weight=weight,
                   slots=slots, valid=valid, depth=depth, T_wc=T_wc)
    if frame_color is not None:
        tensors.update(color=color, frame_color=frame_color)
    _build.check_tensors(tensors, dev)
    if (slots.dtype != torch.int32 or block_coords.dtype != torch.int32
            or valid.dtype != torch.bool):
        raise ValueError("slots and block_coords must be int32 and valid bool")
    if any(t.dtype != torch.float32 for n, t in tensors.items()
           if n not in ("block_coords", "slots", "valid")):
        raise ValueError("integrate takes float32 payload, images and pose")
    _build.check_quads(cfg.block_size, sdf, weight, *([color] if frame_color is not None else []))
    p = _build.ptr
    fc = p(frame_color) if frame_color is not None else None
    col = p(color) if frame_color is not None else None
    k = slots.shape[0]
    grid = _build.resident_grid(_lib(), "ifl_integrate_grid", dev)
    err = _lib().ifl_integrate(
        p(slots), p(valid), k, min(grid, k), p(block_coords), p(sdf),
        p(weight), col, p(depth), fc, p(T_wc), intr.width, intr.height,
        cfg.block_size, intr.fx, intr.fy, intr.cx, intr.cy, cfg.voxel_size,
        cfg.trunc, *cfg.origin, cfg.max_weight, color_gain,
        _build.stream_handle(),
    )
    _build.check(err, "integrate")
    integrate.launches += 1
    integrate.launches_color += int(frame_color is not None)


integrate.launches = 0
integrate.launches_color = 0


def tsdf_update_ref(sdf, weight, color, slots, valid, psi, w_obs, obs,
                    max_weight, color_gain=1.0):
    """Plain K8: the reference's ``_update_kernel`` on the valid listed rows,
    in place; rows of invalid entries are not touched.

    Per voxel: w_new = w_old + w_obs; sdf = (sdf w_old + psi w_obs) /
    max(w_new, 1e-6) where w_new > 0 (the UNOBSERVED sentinel stays where
    nothing was ever fused); weight = min(w_new, max_weight); with ``obs``,
    each packed color segment = (c w_old + obs color_gain w_obs) /
    max(w_old + color_gain w_obs, 1e-6), all as products by the reciprocal.
    Every voxel of a valid row is rewritten, also where w_obs is 0: there
    sdf becomes (sdf w_old) (1 / w_old), which is not always sdf.  Each
    operation is one eager op, rounded once: K8 repeats them bit for bit.
    """
    rows = slots[valid].long()  # valid slots are unique
    w_old, wo = weight[rows], w_obs[valid]
    w_new = w_old + wo
    inv = 1.0 / torch.clamp(w_new, min=1e-6)
    s_old = sdf[rows]
    sdf[rows] = torch.where(w_new > 0.0, (s_old * w_old + psi[valid] * wo) * inv, s_old)
    weight[rows] = torch.clamp(w_new, max=max_weight)
    if obs is not None:
        b3 = w_old.shape[1]
        wc = color_gain * wo
        inv_c = 1.0 / torch.clamp(w_old + wc, min=1e-6)
        c_old, o = color[rows], obs[valid]
        for c in range(3):
            seg = slice(c * b3, (c + 1) * b3)
            c_old[:, seg] = (c_old[:, seg] * w_old + o[:, seg] * wc) * inv_c
        color[rows] = c_old


def tsdf_update(sdf, weight, color, slots, valid, psi, w_obs, obs,
                max_weight, color_gain=1.0):
    """Running-average update of the listed payload rows, in place.

    sdf, weight f32[C, B^3]; color f32[C, 3 B^3] (packed [r | g | b]);
    slots i32[K] with valid bool[K] (valid slots unique; invalid entries are
    never written); psi, w_obs f32[K, B^3] and obs f32[K, 3 B^3] or None
    (depth only: color is left as it is).  On the card one launch and no
    other device op; B^3 must be a multiple of 4 and every row 16-byte
    aligned.
    """
    if sdf.device.type == "cpu":
        tsdf_update_ref(sdf, weight, color, slots, valid, psi, w_obs, obs,
                        max_weight, color_gain)
        return
    dev = sdf.device
    tensors = dict(sdf=sdf, weight=weight, slots=slots, valid=valid, psi=psi,
                   w_obs=w_obs)
    if obs is not None:
        tensors.update(color=color, obs=obs)
    _build.check_tensors(tensors, dev)
    k, b3 = psi.shape
    if slots.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("slots must be int32 and valid bool")
    if any(t.dtype != torch.float32 for n, t in tensors.items() if n not in ("slots", "valid")):
        raise ValueError("tsdf_update takes float32 payload and observations")
    if sdf.shape[1] != b3 or w_obs.shape != psi.shape or slots.shape != (k,):
        raise ValueError("tsdf_update: observation and payload shapes disagree")
    if obs is not None and (obs.shape != (k, 3 * b3) or color.shape[1] != 3 * b3):
        raise ValueError("tsdf_update: color rows must be (., 3 B^3)")
    _build.check_quads(b3, *(t for n, t in tensors.items() if n not in ("slots", "valid")))
    p = _build.ptr
    grid = _build.resident_grid(_lib(), "ifl_tsdf_update_grid", dev)
    err = _lib().ifl_tsdf_update(
        p(slots), p(valid), k, min(grid, k), b3, p(sdf), p(weight),
        p(color) if obs is not None else None, p(psi), p(w_obs),
        p(obs) if obs is not None else None, max_weight, color_gain,
        _build.stream_handle(),
    )
    _build.check(err, "tsdf_update")
    tsdf_update.launches += 1


tsdf_update.launches = 0
