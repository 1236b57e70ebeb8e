"""Port preprocessing against the reference's jnp path (tolerance 1e-5, as
tests/test_pallas.py holds the fused kernel to it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.config import PreprocessConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import common as jcommon
from instancefusion_tpu.ops import preprocess as jpp
from instancefusion_tpu.ops.pallas import preprocess as jpp_pl
from instancefusion_tpu_torch.ops import common as pcommon
from instancefusion_tpu_torch.ops import preprocess as ppp
from tests.helpers import SMALL_INTR
from tests.torch_helpers import n, t, to_port

TOL = 1e-5


@pytest.fixture(scope="module")
def noisy_depth():
    """A rendered frame with seeded depth noise and dropouts (numpy)."""
    f = jsyn.render_frame(jsyn.orbit_trajectory(3)[1], SMALL_INTR)
    rng = np.random.default_rng(0)
    d = np.asarray(f.depth).copy()
    d += rng.normal(scale=0.004, size=d.shape).astype(np.float32) * (d > 0)
    d[rng.random(d.shape) < 0.02] = 0.0
    d[:4, :10] = 7.0  # beyond depth_max: clamped away
    return d, np.asarray(f.color)


def test_build_frame_pyramid_matches_reference(noisy_depth):
    depth, color = noisy_depth
    cfg = PreprocessConfig()
    intensity = np.asarray(jpp.rgb_to_intensity(color))
    ref = jax.jit(lambda d, i: jpp.build_frame_pyramid(d, SMALL_INTR, cfg, 3, i))(
        depth, intensity)
    out = ppp.build_frame_pyramid(t(depth), to_port(SMALL_INTR), to_port(cfg), 3,
                                  ppp.rgb_to_intensity(t(color)))
    for lvl, (a, b) in enumerate(zip(out, ref)):
        for key in ("depth", "vmap", "intensity"):
            np.testing.assert_allclose(n(a[key]), np.asarray(b[key]),
                                       rtol=TOL, atol=TOL, err_msg=f"{key} {lvl}")
        np.testing.assert_array_equal(n(a["valid"]), np.asarray(b["valid"]))
        # Normals are cross products of central differences of the vertex
        # map: the cancellation magnifies 1e-7 vertex rounding ~100x.
        # tests/test_pallas.py holds the fused kernel's normals to 1e-3.
        v = np.asarray(b["valid"])
        np.testing.assert_allclose(n(a["nmap"])[v], np.asarray(b["nmap"])[v],
                                   atol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_decimate_matches_reference(s):
    x = np.random.default_rng(1).normal(size=(121, 161, 3)).astype(np.float32)
    np.testing.assert_array_equal(n(pcommon.decimate(t(x), s)),
                                  np.asarray(jcommon.decimate(jnp.asarray(x), s)))


def _assert_level0_matches_pallas(depth, cfg):
    """Level 0 of the port's pyramid with ``cfg`` (K1's wrapper, its plain
    version here) against the reference's fused Pallas kernel in interpret
    mode, at tests/test_pallas.py's tolerances."""
    df, vmap, nmap, valid = jpp_pl.fused_preprocess(jnp.asarray(depth), SMALL_INTR, cfg,
                                                    interpret=True)
    out = ppp.build_frame_pyramid(t(depth), to_port(SMALL_INTR), to_port(cfg), 1)[0]
    np.testing.assert_allclose(n(out["depth"]), np.asarray(df), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(n(out["vmap"]), np.asarray(vmap), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(n(out["valid"]), np.asarray(valid))
    v = np.asarray(valid)
    assert v.sum() > 5000
    np.testing.assert_allclose(n(out["nmap"])[v], np.asarray(nmap)[v], atol=1e-3)


def test_fused_preprocess_flag_matches_pallas_interpret(noisy_depth):
    """With use_pallas set (bench.py's setting) level 0 comes from K1's
    wrapper, here its plain version, held to the reference's fused Pallas
    kernel in interpret mode at tests/test_pallas.py's tolerances."""
    depth, _ = noisy_depth
    _assert_level0_matches_pallas(depth, dataclasses.replace(PreprocessConfig(),
                                                             use_pallas=True))


@pytest.mark.parametrize("radius", [1, 5])
def test_fused_preprocess_radius_matches_pallas_interpret(noisy_depth, radius):
    """The same at other bilateral radii: K1's compile-time radii end at 4,
    and radius 5 takes its runtime-radius instance on the card."""
    depth, _ = noisy_depth
    _assert_level0_matches_pallas(depth, dataclasses.replace(
        PreprocessConfig(), use_pallas=True, bilateral_radius=radius))


def test_preprocess_tile_plan():
    """K1's tile on the card: 16 output rows at the compile-time radii and
    while the runtime-radius tile fits 48 KB, then 8 rows up to the 227 KB a
    block can have; past that a ValueError that names the limit.  No radius
    goes to the plain version on the card."""
    from instancefusion_tpu_torch.ops.kernels import preprocess as kpre

    assert kpre.tile_plan(2) == 16 and kpre.smem_bytes(2, 16) == 4 * (38 * 22 + 34 * 18)
    for r in (0, 1, 4, 5, 8, 30):
        assert kpre.tile_plan(r) == 16 and kpre.smem_bytes(r, 16) <= kpre.SMEM_DEFAULT
    for r in (60, 109):
        assert kpre.tile_plan(r) == 8
        assert kpre.SMEM_DEFAULT < kpre.smem_bytes(r, 8) <= kpre.SMEM_OPTIN
    with pytest.raises(ValueError, match=str(kpre.SMEM_OPTIN)):
        kpre.tile_plan(110)
    with pytest.raises(ValueError):
        kpre.tile_plan(-1)
