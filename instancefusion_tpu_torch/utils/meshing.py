"""Mesh extraction (surface nets) and PLY export (port of ``utils/meshing.py``).

One vertex per sign-change cell, at the mean of its zero-crossing edge
points; quads (two triangles each) across the cell edges whose four
neighbouring cells all cross.  Vertices and triangles come out in the
reference's order: cells in C order, then the faces of axis 0, 1 and 2.

The extraction runs as torch ops on the map's device; only ``save_ply``
works on the host.  A block map is never expanded to its whole grid: the
box of its allocated blocks, grown by one voxel and clamped to the grid,
is expanded alone.  A crossing cell needs all eight corners observed, and
observed voxels lie in allocated blocks, so every crossing cell lies in
that box and the result equals the whole grid's.  The corner values are
reduced eight shifted views at a time (no (n-1)^3 x 8 corner stack) and
gathered only for the crossing cells; the box's working set is a few
arrays of its own size.
"""

from __future__ import annotations

import numpy as np
import torch

# Corner offsets (x fastest), and the cube's 12 edges as corner pairs.
_CORNERS = tuple((a, b, c) for c in (0, 1) for b in (0, 1) for a in (0, 1))
_EDGES = (
    (0, 1), (2, 3), (4, 5), (6, 7),  # x edges
    (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
    (0, 4), (1, 5), (2, 6), (3, 7),  # z edges
)


def _is_block_map(volume) -> bool:
    return hasattr(volume, "directory")


def _local_offsets(b: int, device) -> torch.Tensor:
    """A block's voxel offsets (B^3, 3), in payload row order (z fastest)."""
    idx = torch.arange(b ** 3, device=device)
    return torch.stack([idx // (b * b), (idx // b) % b, idx % b], -1)


def block_box(bm, cfg):
    """The region of a block map to mesh: (sdf f32[X,Y,Z], weight f32[X,Y,Z],
    lo (3,) voxel index of its first voxel), or None with no allocated block.
    Voxels of unallocated blocks read sdf 1, weight 0."""
    b, n = cfg.block_size, cfg.grid_size
    nb = n // b
    dev = bm.sdf.device
    dir_flat = bm.directory.reshape(-1)
    ids = torch.nonzero(dir_flat >= 0).squeeze(1)
    if ids.numel() == 0:
        return None
    slots = dir_flat[ids].long()
    coords = torch.stack([ids // (nb * nb), (ids // nb) % nb, ids % nb], -1)
    lo = (coords.amin(0) * b - 1).clamp(min=0).tolist()
    hi = ((coords.amax(0) + 1) * b + 1).clamp(max=n).tolist()
    shape = [h - l for l, h in zip(lo, hi)]
    first = coords * b - torch.tensor(lo, device=dev)
    base = (first[:, 0] * shape[1] + first[:, 1]) * shape[2] + first[:, 2]
    loc = _local_offsets(b, dev)
    off = (loc[:, 0] * shape[1] + loc[:, 1]) * shape[2] + loc[:, 2]
    flat = (base[:, None] + off[None, :]).reshape(-1)
    sdf = torch.ones(shape, dtype=torch.float32, device=dev)
    weight = torch.zeros(shape, dtype=torch.float32, device=dev)
    sdf.view(-1)[flat] = bm.sdf[slots].reshape(-1)
    weight.view(-1)[flat] = bm.weight[slots].reshape(-1)
    return sdf, weight, lo


def _corner_view(arr: torch.Tensor, a: int, b: int, c: int) -> torch.Tensor:
    x, y, z = arr.shape
    return arr[a:x - 1 + a, b:y - 1 + b, c:z - 1 + c]


def _cell_vertices(sdf, weight, lo, origin, voxel_size):
    """Vertex per sign-change cell: (verts f32[M,3], cell index map i64 of
    the cells' shape, -1 where a cell does not cross)."""
    dev = sdf.device
    obs = weight > 0
    allobs = smin = smax = None
    for a, b, c in _CORNERS:
        o, s = _corner_view(obs, a, b, c), _corner_view(sdf, a, b, c)
        if allobs is None:
            allobs, smin, smax = o.clone(), s.clone(), s.clone()
        else:
            allobs &= o
            torch.minimum(smin, s, out=smin)
            torch.maximum(smax, s, out=smax)
    cross = allobs & (smin <= 0) & (smax > 0)
    del allobs, smin, smax
    cells = torch.nonzero(cross)  # (M, 3), C order
    idx = torch.full(cross.shape, -1, dtype=torch.int64, device=dev)
    idx[cross] = torch.arange(cells.shape[0], device=dev)

    _, sy, sz = sdf.shape
    base = (cells[:, 0] * sy + cells[:, 1]) * sz + cells[:, 2]
    flat_sdf = sdf.reshape(-1)
    cvals = torch.stack([flat_sdf[base + (a * sy + b) * sz + c] for a, b, c in _CORNERS], -1)
    corner_off = torch.tensor(_CORNERS, dtype=torch.float32, device=dev)
    acc = torch.zeros((cells.shape[0], 3), dtype=torch.float64, device=dev)
    cnt = torch.zeros((cells.shape[0],), dtype=torch.float64, device=dev)
    for a, b in _EDGES:
        va, vb = cvals[:, a], cvals[:, b]
        hit = (va <= 0) != (vb <= 0)
        den = va - vb
        t = torch.where(hit, va / torch.where(den == 0, torch.ones_like(den), den),
                        torch.zeros_like(va))
        p = corner_off[a][None, :] + t[:, None] * (corner_off[b] - corner_off[a])[None, :]
        acc += torch.where(hit[:, None], p, torch.zeros_like(p)).double()
        cnt += hit.double()
    centers = acc / torch.clamp(cnt[:, None], min=1.0)
    cell_w = (cells + torch.tensor(lo, device=dev)).double()
    origin64 = torch.tensor(origin, dtype=torch.float64, device=dev)
    verts = (cell_w + 0.5 + centers) * voxel_size + origin64
    return verts.float(), idx


def _dual_faces(idx: torch.Tensor) -> torch.Tensor:
    """Quads of the dual grid: for each voxel edge with 4 adjacent crossing
    cells, connect their vertices; emitted as two triangles."""
    tris = []
    for axis in range(3):
        ax2, ax3 = [x for x in range(3) if x != axis]

        def shift(arr, d2, d3):
            sl = [slice(None)] * 3
            sl[ax2] = slice(d2, arr.shape[ax2] - 1 + d2)
            sl[ax3] = slice(d3, arr.shape[ax3] - 1 + d3)
            return arr[tuple(sl)]

        v00, v10 = shift(idx, 0, 0), shift(idx, 1, 0)
        v01, v11 = shift(idx, 0, 1), shift(idx, 1, 1)
        ok = (v00 >= 0) & (v10 >= 0) & (v01 >= 0) & (v11 >= 0)
        a, b, c, d = v00[ok], v10[ok], v11[ok], v01[ok]
        if a.numel():
            tris.append(torch.stack([a, b, c], -1))
            tris.append(torch.stack([a, c, d], -1))
    if not tris:
        return torch.zeros((0, 3), dtype=torch.int64, device=idx.device)
    return torch.cat(tris, 0)


def surface_nets(sdf: torch.Tensor, weight: torch.Tensor, origin, voxel_size, lo=(0, 0, 0)):
    """(vertices f32[M,3], triangles i64[T,3]) of a dense TSDF region whose
    first voxel has grid index `lo`."""
    verts, idx = _cell_vertices(sdf, weight, lo, origin, voxel_size)
    return verts, _dual_faces(idx)


def _vertex_voxels(verts: torch.Tensor, cfg) -> torch.Tensor:
    """Nearest voxel-center index per vertex (M, 3) i64, clipped to the grid."""
    origin64 = torch.tensor(cfg.origin, dtype=torch.float64, device=verts.device)
    idx = torch.round((verts.double() - origin64) / cfg.voxel_size - 0.5)
    return idx.clamp(0, cfg.grid_size - 1).long()


def _block_rows(bm, vi: torch.Tensor, cfg):
    """Per voxel index (M, 3): its block's slot (-1 if unallocated) and its
    flat offset in the block's payload row."""
    b = cfg.block_size
    nb = cfg.grid_size // b
    blk = vi // b
    loc = vi - blk * b
    slot = bm.directory.reshape(-1)[(blk[:, 0] * nb + blk[:, 1]) * nb + blk[:, 2]]
    return slot.long(), (loc[:, 0] * b + loc[:, 1]) * b + loc[:, 2]


def extract_mesh(volume, cfg, votes=None, with_color=False):
    """Mesh of a ``TsdfVolume`` or a ``BlockMap``, on its device.

    Returns (verts f32[M,3], tris i64[T,3]) and, when asked, per-vertex
    labels (i32[M], from ``votes``; -1 where the nearest voxel's block is
    unallocated) and colors (f32[M,3], needs a map with color planes),
    each read at the vertex's nearest voxel.
    """
    dev = volume.sdf.device
    if _is_block_map(volume):
        box = block_box(volume, cfg)
        if box is None:
            verts = torch.zeros((0, 3), dtype=torch.float32, device=dev)
            tris = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        else:
            verts, tris = surface_nets(box[0], box[1], cfg.origin, cfg.voxel_size, box[2])
    else:
        verts, tris = surface_nets(volume.sdf, volume.weight, cfg.origin, cfg.voxel_size)
    if votes is None and not with_color:
        return verts, tris
    out = [verts, tris]
    vi = _vertex_voxels(verts, cfg)
    if _is_block_map(volume):
        slot, loc = _block_rows(volume, vi, cfg)
        have = slot >= 0
        row = slot.clamp(min=0)
    if votes is not None:
        if not _is_block_map(volume):
            raise ValueError("label votes need a block map")
        lab = votes.label[row, loc]
        out.append(torch.where(have, lab, torch.full_like(lab, -1)))
    if with_color:
        if volume.color.shape[1] == 0:
            raise ValueError("map was built without color planes")
        if _is_block_map(volume):
            b3 = cfg.block_size ** 3
            col = torch.stack([volume.color[row, ch * b3 + loc] for ch in range(3)], -1)
            out.append(torch.where(have[:, None], col, torch.zeros_like(col)))
        else:
            out.append(volume.color[vi[:, 0], vi[:, 1], vi[:, 2]])
    return tuple(out)


def extract_instance_meshes(volume, votes, cfg, min_verts: int = 8):
    """Per-instance models: one extraction, split by per-vertex label.

    A face belongs to instance ``i`` when at least two of its corners carry
    label ``i``.  Returns ``{instance_id: (verts (Mi,3), tris (Ti,3))}``
    on the map's device; unlabeled faces are left out, and so are instances
    with fewer than ``min_verts`` vertices (speckle from boundary votes).
    """
    verts, tris, vlab = extract_mesh(volume, cfg, votes=votes)
    if tris.shape[0] == 0:
        return {}
    fl = vlab[tris]  # (T, 3) labels at face corners
    none = torch.full_like(fl[:, 0], -1)
    # Majority of 3: a pair agreeing wins, else unlabeled (-1).
    face_lab = torch.where(
        fl[:, 0] == fl[:, 1], fl[:, 0],
        torch.where(fl[:, 0] == fl[:, 2], fl[:, 0],
                    torch.where(fl[:, 1] == fl[:, 2], fl[:, 1], none)))
    out = {}
    for gid in torch.unique(face_lab).tolist():
        if gid < 0:
            continue
        f = tris[face_lab == gid]
        used = torch.unique(f)
        if used.numel() < min_verts:
            continue
        remap = torch.full((verts.shape[0],), -1, dtype=torch.int64, device=verts.device)
        remap[used] = torch.arange(used.numel(), device=verts.device)
        out[int(gid)] = (verts[used], remap[f])
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(path: str, verts, tris=None, colors=None) -> None:
    """ASCII PLY export, the reference's text byte for byte (tensors or
    arrays)."""
    v = _host(verts).astype(np.float32, copy=False)
    head = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
            "property float x", "property float y", "property float z"]
    if colors is not None:
        head += ["property uchar red", "property uchar green", "property uchar blue"]
        c = (np.clip(_host(colors).astype(np.float32, copy=False), 0, 1) * 255).astype(int)
        body = ["%.5f %.5f %.5f %d %d %d" % (*p, *q) for p, q in zip(v.tolist(), c.tolist())]
    else:
        body = ["%.5f %.5f %.5f" % tuple(p) for p in v.tolist()]
    nf = 0 if tris is None else len(tris)
    head += [f"element face {nf}", "property list uchar int vertex_indices", "end_header"]
    if tris is not None:
        body += ["3 %d %d %d" % tuple(t) for t in _host(tris).tolist()]
    with open(path, "w") as f:
        f.write("\n".join(head + body) + "\n")
