"""Port samplers and marched raycasts against the reference's on the CPU:
the block map's ``sample_trilinear``, ``sample_color_trilinear``,
``occupancy_at``, ``sdf_gradient`` and ``raycast`` (with and without a depth
prior, with either normal kind), and the dense volume's ``raycast``."""

import jax
import numpy as np
import pytest
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import blocks as jblk
from instancefusion_tpu.ops import raycast as jrc
from instancefusion_tpu.ops import tsdf as jtsdf
from instancefusion_tpu_torch.ops import blocks as pblk
from instancefusion_tpu_torch.ops import raycast as prc
from instancefusion_tpu_torch.ops import tsdf as ptsdf
from tests.helpers import SMALL_CFG, SMALL_INTR, SMALL_TSDF
from tests.torch_helpers import (  # noqa: F401 (one_thread: an autouse fixture)
    BLOCKS_TSDF, n, one_thread, sample_points, t, to_port,
)

RAYCAST = SMALL_CFG.raycast
PRAY, PINTR = to_port(RAYCAST), to_port(SMALL_INTR)
PBLK, PDENSE = to_port(BLOCKS_TSDF), to_port(SMALL_TSDF)
# At most this share of rays may change validity: a crossing whose samples
# tie to 1 ulp flips between the two (XLA fuses multiply-adds).
FLIP_SHARE = 0.005


@pytest.fixture(scope="module")
def maps():
    """Block map and dense volume fused by the reference from 3 frames,
    and the pose and depth of the last."""
    poses = jsyn.orbit_trajectory(20)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in (0, 2, 4)]
    bint = jax.jit(jblk.integrate, static_argnums=(4, 5))
    dint = jax.jit(jtsdf.integrate, static_argnums=(4, 5))
    bm, vol = jblk.allocate(BLOCKS_TSDF), jtsdf.allocate(SMALL_TSDF)
    for f in frames:
        bm = bint(bm, f.depth, f.color, f.T_wc, SMALL_INTR, BLOCKS_TSDF)
        vol = dint(vol, f.depth, f.color, f.T_wc, SMALL_INTR, SMALL_TSDF)
    f = frames[-1]
    return bm, vol, np.asarray(f.T_wc), np.asarray(f.depth)


def _observed(bm) -> np.ndarray:
    """World centers of the observed voxels of a reference block map."""
    b = BLOCKS_TSDF.block_size
    slot, v = np.nonzero(np.asarray(bm.weight) > 0)
    local = np.stack([v // (b * b), (v // b) % b, v % b], -1)
    vox = np.asarray(bm.block_coords)[slot] * b + local
    return (vox + 0.5) * BLOCKS_TSDF.voxel_size + np.asarray(BLOCKS_TSDF.origin)


def test_block_samplers_match_reference(maps):
    """sdf within 1e-6 with validity equal, color within 1e-6, occupancy
    equal, normals within 1e-4 where valid with validity equal, at points
    near the surface, anywhere in the grid and outside it."""
    bm, _, _, _ = maps
    pm = pblk.BlockMap(*(t(x) for x in bm))
    p = sample_points(1, _observed(bm))
    s_r, v_r = jblk.sample_trilinear(bm, p, BLOCKS_TSDF)
    s_p, v_p = pblk.sample_trilinear(pm, t(p), PBLK)
    np.testing.assert_array_equal(n(v_p), np.asarray(v_r))
    assert 1000 < np.asarray(v_r).sum() < len(p) - 1000
    np.testing.assert_allclose(n(s_p), np.asarray(s_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(pblk.sample_color_trilinear(pm, t(p), PBLK)),
                               np.asarray(jblk.sample_color_trilinear(bm, p, BLOCKS_TSDF)),
                               rtol=0, atol=1e-6)
    occ = np.asarray(jblk.occupancy_at(bm, p, BLOCKS_TSDF))
    np.testing.assert_array_equal(n(pblk.occupancy_at(pm, t(p), PBLK)), occ)
    assert 1000 < occ.sum() < len(p) - 1000
    g_r, gv_r = jblk.sdf_gradient(bm, p, BLOCKS_TSDF)
    g_p, gv_p = pblk.sdf_gradient(pm, t(p), PBLK)
    gv = np.asarray(gv_r)
    np.testing.assert_array_equal(n(gv_p), gv)
    assert gv.sum() > 500
    np.testing.assert_allclose(n(g_p)[gv], np.asarray(g_r)[gv], rtol=0, atol=1e-4)


def _hold(out, ref, atol_normal=1e-4):
    """Valid sets within FLIP_SHARE of the reference's valid rays; depth and
    vertices within 2e-5 m, normals within atol_normal and color within 1e-4
    on rays valid in both; zeros where the port's rays miss."""
    vr, vo = np.asarray(ref.valid), n(out.valid)
    assert vr.sum() > 3000
    assert (vr ^ vo).sum() <= FLIP_SHARE * vr.sum(), (vr ^ vo).sum()
    both = vr & vo
    for name, tol in (("depth", 2e-5), ("vertex_w", 2e-5),
                      ("normal_w", atol_normal), ("color", 1e-4)):
        err = np.abs(n(getattr(out, name)) - np.asarray(getattr(ref, name)))[both].max()
        assert err <= tol, (name, err)
    for name in ("depth", "vertex_w", "normal_w", "color"):
        assert (n(getattr(out, name))[~vo] == 0).all(), name


def test_dense_raycast_matches_reference(maps):
    _, vol, T, _ = maps
    ref = jax.jit(jrc.raycast, static_argnums=(2, 3, 4, 5))(
        vol, T, SMALL_INTR, SMALL_TSDF, RAYCAST, True)
    out = prc.raycast(ptsdf.TsdfVolume(*(t(x) for x in vol)), t(T), PINTR, PDENSE, PRAY,
                      with_color=True)
    _hold(out, ref)
    assert np.abs(np.asarray(ref.color)).max() > 0.1


@pytest.mark.parametrize("prior,screen", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_block_raycast_matches_reference(maps, prior, screen):
    """Both normal kinds, with and without the depth prior (rays without
    a prior miss); color sampled.  Screen-space normals are held to 2e-3:
    they are cross products of differences of hit points a pixel apart
    (~1-2 cm here), each within 2e-5 m."""
    bm, _, T, depth = maps
    kw = dict(depth_prior=depth if prior else None, screen_space_normals=screen)
    ref = jax.jit(jblk.raycast, static_argnums=(2, 3, 4, 5, 7))(
        bm, T, SMALL_INTR, BLOCKS_TSDF, RAYCAST, True, kw["depth_prior"], screen)
    out = pblk.raycast(pblk.BlockMap(*(t(x) for x in bm)), t(T), PINTR, PBLK, PRAY,
                       with_color=True, depth_prior=None if not prior else t(depth),
                       screen_space_normals=screen)
    _hold(out, ref, atol_normal=2e-3 if screen else 1e-4)
    if prior:
        assert not n(out.valid)[depth <= 0].any()


def test_block_raycast_without_color(maps):
    """A map without color, or with_color off, predicts zero color."""
    bm, _, T, depth = maps
    out = pblk.raycast(pblk.BlockMap(*(t(x) for x in bm)), t(T), PINTR, PBLK, PRAY,
                       with_color=False, depth_prior=t(depth), screen_space_normals=True)
    assert n(out.valid).sum() > 3000 and (n(out.color) == 0).all()
