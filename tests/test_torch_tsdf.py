"""Port K8 (``tsdf_update_ref``, the plain version of the touched-block
running average) against the reference's Pallas kernel in interpret mode,
and the port's dense volume (``ops/tsdf.py``: integrate and the samplers)
against the reference's on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import tsdf as jtsdf
from instancefusion_tpu.ops.pallas import tsdf as tsdf_pl
from instancefusion_tpu_torch.ops import tsdf as ptsdf
from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf
from tests.helpers import SMALL_INTR, SMALL_TSDF
from tests.torch_helpers import (  # noqa: F401 (one_thread: an autouse fixture)
    n, observed_points, one_thread, sample_points, t, to_port,
)

PCFG, PINTR = to_port(SMALL_TSDF), to_port(SMALL_INTR)
B3 = 512


def _update_inputs(seed: int, k: int = 70, c: int = 96):
    """A payload of c rows and a list of k entries: the valid ones point at
    distinct rows, the invalid ones at slot 0 (a real row, as
    ``compact_touched_slots`` leaves them).  Rows cover w_old = 0 with
    w_obs = 0 (the sentinel must stay), weights near the clamp, and
    partial observations."""
    rng = np.random.default_rng(seed)
    sdf = rng.uniform(-1, 1, (c, B3)).astype(np.float32)
    weight = rng.integers(0, 4, (c, B3)).astype(np.float32)
    weight[:10] = 0.0
    sdf[:10] = 2.0  # never fused: the UNOBSERVED sentinel
    weight[10:20] = 63.5  # the max_weight clamp
    color = rng.uniform(0, 1, (c, 3 * B3)).astype(np.float32)
    valid = rng.random(k) < 0.8
    valid[:3] = False
    slots = np.zeros(k, np.int32)
    # Distinct rows, slot 0 never among them; rows 1-5 hold the sentinel.
    listed = np.concatenate([np.arange(1, 6), rng.permutation(np.arange(6, c))])
    slots[valid] = listed[: valid.sum()]
    psi = rng.uniform(-1, 1, (k, B3)).astype(np.float32)
    w_obs = (rng.random((k, B3)) < 0.6).astype(np.float32)
    obs = rng.uniform(0, 1, (k, 3 * B3)).astype(np.float32)
    return sdf, weight, color, slots, valid, psi, w_obs, obs


@pytest.mark.parametrize("color_gain", [1.0, 4.0])
@pytest.mark.parametrize("with_color", [True, False])
def test_tsdf_update_ref_matches_pallas_kernel(color_gain, with_color):
    """The listed valid rows as the interpret-mode kernel writes them (sdf
    and color rtol 1e-5, atol 1e-6; weight rtol 1e-6, the bounds of
    tests/test_pallas.py:95-104); every other row, slot 0 included where
    only invalid entries point at it, bit-identical to before."""
    sdf, weight, color, slots, valid, psi, w_obs, obs = _update_inputs(int(color_gain))
    rows = slots[valid]
    s2, w2, c2 = tsdf_pl.fused_tsdf_update(
        jnp.asarray(sdf[slots]), jnp.asarray(weight[slots]), jnp.asarray(color[slots]),
        jnp.asarray(psi), jnp.asarray(w_obs), jnp.asarray(obs), 64.0, True, color_gain)
    exp_s, exp_w, exp_c = sdf.copy(), weight.copy(), color.copy()
    exp_s[rows] = np.asarray(s2)[valid]
    exp_w[rows] = np.asarray(w2)[valid]
    exp_c[rows] = np.asarray(c2)[valid]
    out = [t(sdf).clone(), t(weight).clone(), t(color).clone()]
    ktsdf.tsdf_update(*out, t(slots), t(valid), t(psi), t(w_obs),
                      t(obs) if with_color else None, 64.0, color_gain)
    np.testing.assert_allclose(n(out[0]), exp_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(out[1]), exp_w, rtol=1e-6)
    if with_color:
        np.testing.assert_allclose(n(out[2]), exp_c, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(n(out[2]), color)
    untouched = np.setdiff1d(np.arange(sdf.shape[0]), rows)
    assert 0 in untouched  # invalid entries point at slot 0, which is not listed
    for a, before in zip(out, (sdf, weight, color)):
        np.testing.assert_array_equal(n(a)[untouched], before[untouched])
    # Where nothing was ever fused the sdf stays, the sentinel rows 1-5
    # included; the clamp holds.
    never = (weight[rows] == 0) & (w_obs[valid] == 0)
    assert never[:5].any() and (sdf[rows][:5][never[:5]] == 2.0).all()
    np.testing.assert_array_equal(n(out[0])[rows][never], sdf[rows][never])
    assert n(out[1]).max() == 64.0


def _rewritten(x, w):
    """(x w) (1 / w) in float32, one rounding per operation: what the
    running average leaves of x where w_obs is 0."""
    return (x * w) * (np.float32(1.0) / w)


def _changing(rng, lo, hi, w):
    """Per entry of w, a float32 value in [lo, hi) that (x w) (1 / w)
    changes: the first of 64 candidates that it does."""
    cand = rng.uniform(lo, hi, w.shape + (64,)).astype(np.float32)
    moved = _rewritten(cand, w[..., None]) != cand
    assert moved.any(-1).all()
    return np.take_along_axis(cand, moved.argmax(-1)[..., None], -1)[..., 0]


def test_tsdf_update_ref_rewrites_unobserved_voxels():
    """w_obs = 0 on every listed voxel, w_old in {3, 5, 7}, sdf and color
    chosen where (x w) (1 / w) != x: the plain K8 rewrites every such voxel
    as float32 numpy computes (x w) (1 / w), bit for bit, and keeps its
    weight, so K8 must read every valid voxel, not only the observed ones.
    Slot 0, a fused block that only invalid entries name, stays as it was.
    The interpret-mode Pallas kernel agrees within tests/test_pallas.py's
    bounds (XLA may fuse the multiply-adds)."""
    rng = np.random.default_rng(7)
    c, k = 12, 16
    w = rng.choice(np.float32([3.0, 5.0, 7.0]), (c, B3))
    w3 = np.tile(w, 3)  # the weight of each packed color segment's voxel
    sdf, color = _changing(rng, -1.0, 1.0, w), _changing(rng, 0.0, 1.0, w3)
    valid = np.zeros(k, bool)
    valid[rng.permutation(k)[: c - 1]] = True
    slots = np.zeros(k, np.int32)  # invalid entries name slot 0
    slots[valid] = rng.permutation(np.arange(1, c))
    psi = rng.uniform(-1, 1, (k, B3)).astype(np.float32)
    w_obs = np.zeros((k, B3), np.float32)
    obs = rng.uniform(0, 1, (k, 3 * B3)).astype(np.float32)
    out = [t(sdf).clone(), t(w).clone(), t(color).clone()]
    ktsdf.tsdf_update(*out, t(slots), t(valid), t(psi), t(w_obs), t(obs), 64.0)
    rows = slots[valid]
    exp_s, exp_c = sdf.copy(), color.copy()
    exp_s[rows] = _rewritten(sdf[rows], w[rows])
    exp_c[rows] = _rewritten(color[rows], w3[rows])
    assert (exp_s[rows] != sdf[rows]).all() and (exp_c[rows] != color[rows]).all()
    for got, exp in zip(out, (exp_s, w, exp_c)):
        np.testing.assert_array_equal(n(got).view(np.int32), exp.view(np.int32))
    assert 0 not in rows and (w[0] > 0).all()  # slot 0: fused, never listed
    s2, w2, c2 = tsdf_pl.fused_tsdf_update(
        jnp.asarray(sdf[slots]), jnp.asarray(w[slots]), jnp.asarray(color[slots]),
        jnp.asarray(psi), jnp.asarray(w_obs), jnp.asarray(obs), 64.0, True)
    np.testing.assert_allclose(np.asarray(s2)[valid], exp_s[rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(w2)[valid], w[rows], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(c2)[valid], exp_c[rows], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(20)
    return [jsyn.render_frame(poses[i], SMALL_INTR) for i in (0, 3)]


@pytest.fixture(scope="module")
def volumes(frames):
    """The reference volume after 2 frames, with and without color."""
    fuse = jax.jit(jtsdf.integrate, static_argnums=(4, 5))
    out = {}
    for with_color in (True, False):
        vol = jtsdf.allocate(SMALL_TSDF, with_color=with_color)
        for f in frames:
            vol = fuse(vol, f.depth, f.color if with_color else None, f.T_wc,
                       SMALL_INTR, SMALL_TSDF)
        out[with_color] = vol
    return out


@pytest.mark.parametrize("with_color", [True, False])
def test_dense_integrate_matches_reference(frames, volumes, with_color):
    """weight exact; sdf within 1e-5 and color within 1e-5: the reference's
    XLA turns the division by trunc into a product by its reciprocal and
    forms fused multiply-adds, the port does neither on the CPU.  Voxels
    never observed hold 0 (no sentinel), as in the reference."""
    vol = ptsdf.allocate(PCFG, "cpu", with_color=with_color)
    assert vol.color.shape == ((96,) * 3 + (3,) if with_color else (0, 0, 0, 3))
    for f in frames:
        vol = ptsdf.integrate(vol, t(f.depth), t(f.color) if with_color else None,
                              t(f.T_wc), PINTR, PCFG)
    ref = volumes[with_color]
    np.testing.assert_array_equal(n(vol.weight), np.asarray(ref.weight))
    np.testing.assert_allclose(n(vol.sdf), np.asarray(ref.sdf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(vol.color), np.asarray(ref.color), rtol=0, atol=1e-5)
    w = n(vol.weight)
    assert (w > 0).mean() > 0.02 and (n(vol.sdf)[w == 0] == 0.0).all()


def test_dense_samplers_match_reference(volumes):
    """sdf samples within 1e-6 and validity equal; color within 1e-6;
    normals within 1e-4 where valid (a unit vector from differences of
    samples), validity equal."""
    ref = volumes[True]
    vol = ptsdf.TsdfVolume(*(t(x) for x in ref))
    p = sample_points(0, observed_points(np.asarray(ref.weight), SMALL_TSDF.origin,
                                   SMALL_TSDF.voxel_size))
    s_r, v_r = jtsdf.sample_trilinear(ref, p, SMALL_TSDF)
    s_p, v_p = ptsdf.sample_trilinear(vol, t(p), PCFG)
    np.testing.assert_array_equal(n(v_p), np.asarray(v_r))
    assert 1000 < np.asarray(v_r).sum() < len(p) - 1000
    np.testing.assert_allclose(n(s_p), np.asarray(s_r), rtol=0, atol=1e-6)
    c_r = jtsdf.sample_color_trilinear(ref, p, SMALL_TSDF)
    np.testing.assert_allclose(n(ptsdf.sample_color_trilinear(vol, t(p), PCFG)),
                               np.asarray(c_r), rtol=0, atol=1e-6)
    g_r, gv_r = jtsdf.sdf_gradient(ref, p, SMALL_TSDF)
    g_p, gv_p = ptsdf.sdf_gradient(vol, t(p), PCFG)
    np.testing.assert_array_equal(n(gv_p), np.asarray(gv_r))
    gv = np.asarray(gv_r)
    assert gv.sum() > 500
    np.testing.assert_allclose(n(g_p)[gv], np.asarray(g_r)[gv], rtol=0, atol=1e-4)


def test_dense_voxel_coords_match_reference():
    """Voxel centers within 1 ulp at 2 m (the reference's XLA fuses the
    multiply-add)."""
    ref = jax.jit(jtsdf.voxel_world_coords, static_argnums=0)(SMALL_TSDF)
    np.testing.assert_allclose(n(ptsdf.voxel_world_coords(PCFG, "cpu")), np.asarray(ref),
                               rtol=0, atol=2.5e-7)
    assert torch.equal(ptsdf.vec3((1.0, -2.0, 0.5), torch.device("cpu")),
                       torch.tensor([1.0, -2.0, 0.5]))
