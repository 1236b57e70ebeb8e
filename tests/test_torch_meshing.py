"""Mesh extraction, PLY export and offline rendering of the port
(``utils/meshing.py``, ``utils/render.py``) against the reference's, on maps
the reference fused (tests/test_export.py's dense volume and block map with
label votes), carried across as numpy arrays.

Tolerances: vertices and colors 1e-6 (the same float32/float64 operations
in the same order; measured 0 here), triangles, labels and instance keys
equal, PLY text byte-equal; rendered uint8 images within 1 on >= 99.9% of
pixels (measured: every pixel within 1, equal on >= 99.99%; the block
map's marched raycast rounds differently in the last float bits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import blocks as jblocks
from instancefusion_tpu.ops import labels as jlabels
from instancefusion_tpu.utils import meshing as jmesh
from instancefusion_tpu.utils import render as jrender
from instancefusion_tpu_torch.ops import blocks as pblocks
from instancefusion_tpu_torch.ops import labels as plabels
from instancefusion_tpu_torch.ops import tsdf as ptsdf
from instancefusion_tpu_torch.utils import meshing, render
from tests.helpers import SMALL_CFG, SMALL_INTR, SMALL_TSDF
from tests.test_export import _fused_dense
from tests.torch_helpers import n, one_thread, t, to_port  # noqa: F401 (autouse fixture)

BCFG = dataclasses.replace(SMALL_TSDF, block_size=8, table_capacity=1728)


@pytest.fixture(scope="module")
def dense():
    vol, poses = _fused_dense()
    return vol, np.asarray(poses)


@pytest.fixture(scope="module")
def block_map():
    """tests/test_export.py::test_per_instance_mesh_extraction's map: three
    frames fused with their ground-truth instance ids voted in."""
    poses = jsyn.orbit_trajectory(3)
    bm, votes = jblocks.allocate(BCFG), jlabels.allocate(BCFG)
    for i in range(3):
        f = jsyn.render_frame(poses[i], SMALL_INTR)
        bm = jblocks.integrate(bm, f.depth, f.color, f.T_wc, SMALL_INTR, BCFG)
        votes = jlabels.fuse(votes, bm, f.instance, f.depth, f.T_wc, SMALL_INTR, BCFG)
    return bm, votes, np.asarray(poses)


def _pdense(vol):
    return ptsdf.TsdfVolume(*(t(x) for x in vol))


def _pmap(bm):
    return pblocks.BlockMap(*(t(x) for x in bm))


def _pvotes(votes):
    return plabels.LabelVotes(*(t(x) for x in votes))


def _same_mesh(out, ref):
    assert len(out) == len(ref)
    np.testing.assert_allclose(n(out[0]), ref[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(out[1]), ref[1])
    for a, b in zip(out[2:], ref[2:]):
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(n(a), b)
        else:
            np.testing.assert_allclose(n(a), b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["dense", "dense+color", "blocks", "blocks+color+labels"])
def test_extract_mesh_equals_reference(case, dense, block_map):
    color = "color" in case
    if case.startswith("dense"):
        vol = dense[0]
        ref = jmesh.extract_mesh(vol, SMALL_TSDF, with_color=color)
        out = meshing.extract_mesh(_pdense(vol), to_port(SMALL_TSDF), with_color=color)
    else:
        bm, votes, _ = block_map
        v = votes if "labels" in case else None
        ref = jmesh.extract_mesh(bm, BCFG, votes=v, with_color=color)
        out = meshing.extract_mesh(_pmap(bm), to_port(BCFG),
                                   votes=None if v is None else _pvotes(v), with_color=color)
    if not isinstance(ref, tuple):
        ref = (ref,)
    assert len(ref[0]) > 2000
    _same_mesh(out, ref)


def test_block_box_equals_whole_grid(block_map):
    """The bounding-box route gives the mesh of the whole expanded grid."""
    bm = _pmap(block_map[0])
    cfg = to_port(BCFG)
    b, g = cfg.block_size, cfg.grid_size
    sdf = torch.ones((g, g, g))
    weight = torch.zeros((g, g, g))
    dir_np = n(bm.directory)
    for bi, bj, bk in np.argwhere(dir_np >= 0):
        s = int(dir_np[bi, bj, bk])
        sl = np.s_[bi * b:(bi + 1) * b, bj * b:(bj + 1) * b, bk * b:(bk + 1) * b]
        sdf[sl] = bm.sdf[s].reshape(b, b, b)
        weight[sl] = bm.weight[s].reshape(b, b, b)
    whole = meshing.surface_nets(sdf, weight, cfg.origin, cfg.voxel_size)
    box = meshing.block_box(bm, cfg)
    assert max(box[0].shape) < g  # the box is smaller than the grid
    boxed = meshing.extract_mesh(bm, cfg)
    np.testing.assert_array_equal(n(boxed[0]), n(whole[0]))
    np.testing.assert_array_equal(n(boxed[1]), n(whole[1]))


def test_instance_meshes_equal_reference(block_map):
    bm, votes, _ = block_map
    ref = jmesh.extract_instance_meshes(bm, votes, BCFG)
    out = meshing.extract_instance_meshes(_pmap(bm), _pvotes(votes), to_port(BCFG))
    assert set(out) == set(ref) and set(ref) & {1, 2, 3}
    for gid in ref:
        np.testing.assert_allclose(n(out[gid][0]), ref[gid][0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(n(out[gid][1]), ref[gid][1])


@pytest.mark.parametrize("with_color", [False, True])
def test_save_ply_byte_equal(with_color, block_map, tmp_path):
    bm = block_map[0]
    ref = jmesh.extract_mesh(bm, BCFG, with_color=with_color)
    out = meshing.extract_mesh(_pmap(bm), to_port(BCFG), with_color=with_color)
    jmesh.save_ply(str(tmp_path / "ref.ply"), *ref[:2],
                   colors=ref[2] if with_color else None)
    meshing.save_ply(str(tmp_path / "port.ply"), *out[:2],
                     colors=out[2] if with_color else None)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    jmesh.save_ply(str(tmp_path / "ref_pts.ply"), ref[0])
    meshing.save_ply(str(tmp_path / "port_pts.ply"), out[0])
    assert (tmp_path / "port_pts.ply").read_bytes() == (tmp_path / "ref_pts.ply").read_bytes()


def _close_images(out: dict, ref: dict):
    assert set(out) == set(ref)
    for key in ref:
        a, b = out[key].astype(int), np.asarray(ref[key]).astype(int)
        assert a.shape == b.shape and out[key].dtype == np.uint8
        share = np.mean(np.abs(a - b) <= 1)
        assert share >= 0.999, (key, share)


@pytest.mark.parametrize("case", ["dense", "blocks+votes"])
def test_render_view_equals_reference(case, dense, block_map):
    rc = SMALL_CFG.raycast
    if case == "dense":
        vol, poses = dense
        ref = jrender.render_view(vol, jnp.asarray(poses[0]), SMALL_INTR, SMALL_TSDF, rc)
        out = render.render_view(_pdense(vol), t(poses[0]), to_port(SMALL_INTR),
                                 to_port(SMALL_TSDF), to_port(rc))
    else:
        bm, votes, poses = block_map
        ref = jrender.render_view(bm, jnp.asarray(poses[1]), SMALL_INTR, BCFG, rc, votes)
        out = render.render_view(_pmap(bm), t(poses[1]), to_port(SMALL_INTR), to_port(BCFG),
                                 to_port(rc), _pvotes(votes))
        assert (out["instances"] > 0).any()
    assert out["shaded"].shape == (120, 160, 3) and out["shaded"].max() > 50
    _close_images(out, ref)


def test_render_sequence_writes_pngs(dense, tmp_path):
    """Numbered shaded views, written by the port's encoder, read in PIL as
    the reference's own test reads them."""
    from PIL import Image

    vol, poses = dense
    paths = render.render_sequence(_pdense(vol), [poses[0], poses[1]], to_port(SMALL_INTR),
                                   to_port(SMALL_TSDF), to_port(SMALL_CFG.raycast),
                                   str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in paths] == ["view_0000.png", "view_0001.png"]
    for p in paths:
        with Image.open(p) as im:
            assert im.size == (160, 120) and np.asarray(im).max() > 50
