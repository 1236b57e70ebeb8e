"""Port synthetic renderer against the reference's."""

import numpy as np

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu_torch.datasets import synthetic as psyn
from tests.helpers import SMALL_INTR
from tests.torch_helpers import n, t, to_port


def test_orbit_trajectory_matches_reference():
    np.testing.assert_allclose(n(psyn.orbit_trajectory(9, device="cpu")),
                               np.asarray(jsyn.orbit_trajectory(9)), atol=1e-5)


def test_handheld_trajectory_matches_reference():
    """The deterministic shaken arc: equal to the reference's to fp32."""
    out = n(psyn.handheld_trajectory(25, device="cpu"))
    ref = np.asarray(jsyn.handheld_trajectory(25))
    np.testing.assert_allclose(out, ref, atol=2e-6)
    # It moves faster than the orbit: > 1 cm between some neighbouring poses.
    assert np.linalg.norm(np.diff(out[:, :3, 3], axis=0), axis=-1).max() > 0.01


def test_scene_sdf_matches_reference():
    p = np.random.default_rng(0).uniform(-1.3, 2.5, (500, 3)).astype(np.float32)
    s_ref, id_ref = jsyn.scene_sdf(p)
    s, ids = psyn.scene_sdf(t(p))
    np.testing.assert_allclose(n(s), np.asarray(s_ref), atol=1e-5)
    np.testing.assert_array_equal(n(ids), np.asarray(id_ref))


def test_render_frame_matches_reference():
    """Sphere tracing amplifies last-bit differences only at silhouettes:
    >= 99% of pixels agree to 1e-4 in depth and color, >= 99.5% in id."""
    T = jsyn.orbit_trajectory(5)[2]
    ref = jsyn.render_frame(T, SMALL_INTR)
    out = psyn.render_frame(t(T), to_port(SMALL_INTR))
    assert n(out.T_wc).shape == (4, 4)
    assert (np.abs(n(out.depth) - np.asarray(ref.depth)) <= 1e-4).mean() >= 0.99
    assert (np.abs(n(out.color) - np.asarray(ref.color)) <= 1e-4).all(-1).mean() >= 0.99
    assert (n(out.instance) == np.asarray(ref.instance)).mean() >= 0.995
    assert (np.asarray(ref.depth) > 0).mean() > 0.95
