"""TSDF kernels K4 and K8 (``csrc/tsdf.cu``) and their plain versions.

``integrate`` (K4) fuses one depth frame (and, on color frames, its colors)
into the listed payload rows of a block map, in place: the map's ``sdf``,
``weight`` and ``color`` tensors are updated and no copy of the payload is
made.  ``tsdf_update`` (K8) is the running-average half alone: it takes
per-voxel observations computed outside the kernel (the touched-block
integrate of ``ops/blocks.py``) and updates the listed rows in place.
CUDA tensors launch the kernels, CPU tensors run ``integrate_ref`` and
``tsdf_update_ref``.  Each wrapper's ``launches`` counts its launches,
``integrate.launches_color`` those that fuse color.
"""

from __future__ import annotations


import torch

from reference.geometry.camera import Intrinsics, nearest_pixel, project
from reference.geometry.se3 import cam_rows, se3_inverse_rows


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
    slots = slots.long()
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
    s_new = torch.where(
        w_new > 0.0, (s_old * w_old + psi * w_obs) / torch.clamp(w_new, min=1e-6), s_old
    )
    _write_rows(sdf, slots, valid, s_new, s_old)
    _write_rows(weight, slots, valid, torch.clamp(w_new, max=cfg.max_weight), w_old)
    if frame_color is not None:
        b3 = w_old.shape[1]
        c_obs = frame_color.reshape(-1, 3)[pix]  # (K, B^3, 3)
        c_old = color[slots]
        c_new = c_old.clone()
        wc = color_gain * w_obs
        den = torch.clamp(w_old + wc, min=1e-6)
        for c in range(3):
            seg = slice(c * b3, (c + 1) * b3)
            c_new[:, seg] = (c_old[:, seg] * w_old + c_obs[..., c] * wc) / den
        _write_rows(color, slots, valid, c_new, c_old)


def _write_rows(plane, slots, valid, new, old):
    """plane[slots[i]] = new[i] for the valid entries (unique slots), with no
    host read: an invalid entry writes again what the first valid entry
    writes (or, with none valid, its own old row back), so every write to
    a row carries the same values."""
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    new = torch.where(valid[:, None], new, old)
    rows = torch.where(valid, slots, slots.index_select(0, first))
    plane[rows] = torch.where(valid[:, None], new, new.index_select(0, first))


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


# The kernels' entry points, bound to their plain versions.
integrate = integrate_ref
tsdf_update = tsdf_update_ref
