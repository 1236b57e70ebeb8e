"""Instance-label vote kernel K7 (``csrc/labels.cu``) and its plain version.

``label_vote`` votes one frame's per-pixel instance ids into the band
voxels of the listed payload rows, in place: the vote planes ``label`` and
``count`` are updated and no copy of them is made.  The kernel also does
the projective association that the reference runs around its Pallas vote
(``ops/labels.py:fuse``).  CUDA tensors launch the kernel, CPU tensors run
``label_vote_ref``.  ``label_vote.launches`` counts kernel launches: eager
calls and CUDA-graph captures, not a graph's replays.
"""

from __future__ import annotations

import ctypes

import torch

from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.ops.kernels import _build
from instancefusion_tpu_torch.ops.kernels.tsdf import project_voxels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ifl_label_vote_grid": [_P],
    "ifl_label_vote": [_P, _P, _I, _I] + [_P] * 6 + [_I] * 3 + [_F] * 9 + [_P],
}


def _lib():
    return _build.load("labels", _SIGNATURES)


def label_vote_ref(block_coords, label, count, slots, valid, depth, gid_image,
                   T_wc, intr: Intrinsics, cfg):
    """Plain K7: the reference's jnp ``labels.fuse`` update, in place.

    Gathers the listed rows (invalid entries read slot 0 and are not
    written back); per voxel: project (round half to even), read depth and
    id, observe where in the image, z > 0, d > 0, |d - z| < trunc and
    id >= 0; Boyer-Moore vote: count <= 0 adopts the id with count 1, the
    same id adds 1, another id subtracts 1.
    """
    slots = slots.long()
    z, pix, seen = project_voxels(block_coords, slots, T_wc, intr, cfg)
    d = depth.reshape(-1)[pix]
    gid = gid_image.reshape(-1)[pix]
    obs = (seen & (d > 0.0) & (torch.abs(d - z) < cfg.trunc)
           & (gid >= 0) & valid[:, None])
    lab, cnt = label[slots], count[slots]
    adopt = obs & (cnt <= 0.0)
    same = obs & (lab == gid) & ~adopt
    other = obs & ~adopt & ~same
    lab_new = torch.where(adopt, gid, lab)
    cnt_new = torch.where(adopt, torch.ones_like(cnt), torch.where(
        same, cnt + 1.0, torch.where(other, cnt - 1.0, cnt)))
    rows = torch.where(valid, slots, torch.full_like(slots, label.shape[0]))
    for plane, new in ((label, lab_new), (count, cnt_new)):
        ext = torch.cat([plane, plane[:1]])
        ext[rows] = new
        plane.copy_(ext[:-1])


def label_vote(block_coords, label, count, slots, valid, depth, gid_image,
               T_wc, intr: Intrinsics, cfg):
    """Vote one frame's instance ids into the listed payload rows, in place.

    block_coords i32[C, 3]; label i32[C, B^3]; count f32[C, B^3]; slots
    i32[K] with valid bool[K] (valid slots unique); depth f32[H, W];
    gid_image i32[H, W] (-1 = no instance); T_wc f32[4, 4].  On the card
    one launch and no other device op: the kernel inverts the pose itself.
    """
    if label.device.type == "cpu":
        label_vote_ref(block_coords, label, count, slots, valid, depth, gid_image,
                       T_wc, intr, cfg)
        return
    dev = label.device
    _build.check_tensors(dict(block_coords=block_coords, label=label, count=count,
                              slots=slots, valid=valid, depth=depth,
                              gid_image=gid_image, T_wc=T_wc), dev)
    if (slots.dtype != torch.int32 or block_coords.dtype != torch.int32
            or label.dtype != torch.int32 or gid_image.dtype != torch.int32):
        raise ValueError("slots, block_coords, label and gid_image must be int32")
    if (count.dtype != torch.float32 or depth.dtype != torch.float32
            or T_wc.dtype != torch.float32 or valid.dtype != torch.bool):
        raise ValueError("count, depth and T_wc must be float32 and valid bool")
    _build.check_quads(cfg.block_size, label, count)
    p = _build.ptr
    k = slots.shape[0]
    grid = _build.resident_grid(_lib(), "ifl_label_vote_grid", dev)
    err = _lib().ifl_label_vote(
        p(slots), p(valid), k, min(grid, k), p(block_coords), p(label), p(count),
        p(depth), p(gid_image), p(T_wc), intr.width, intr.height, cfg.block_size,
        intr.fx, intr.fy, intr.cx, intr.cy, cfg.voxel_size, cfg.trunc,
        *cfg.origin, _build.stream_handle(),
    )
    _build.check(err, "label_vote")
    label_vote.launches += 1


label_vote.launches = 0
