"""Port synthetic renderer against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_random_scene_equal(seed):
    """numpy draws in both packages: the same scene, bit for bit."""
    ref = jsyn.random_scene(seed)
    out = psyn.random_scene(seed, device="cpu")
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_scene_sdf_with_matches_reference():
    scene = jsyn.random_scene(1234)
    p = np.random.default_rng(1).uniform(-1.3, 2.5, (500, 3)).astype(np.float32)
    s_ref, id_ref = jsyn.scene_sdf_with(jnp.asarray(p), scene)
    s, ids = psyn.scene_sdf_with(t(p), psyn.random_scene(1234, device="cpu"))
    np.testing.assert_allclose(n(s), np.asarray(s_ref), atol=1e-5)
    np.testing.assert_array_equal(n(ids), np.asarray(id_ref))


def test_render_frame_scene_matches_reference():
    """As test_render_frame_matches_reference, on a seeded scene."""
    T = jsyn.orbit_trajectory(5)[2]
    ref = jsyn.render_frame_scene(T, SMALL_INTR, jsyn.random_scene(1234), texture=True)
    out = psyn.render_frame_scene(t(T), to_port(SMALL_INTR),
                                  psyn.random_scene(1234, device="cpu"), texture=True)
    assert (np.abs(n(out.depth) - np.asarray(ref.depth)) <= 1e-4).mean() >= 0.99
    assert (np.abs(n(out.color) - np.asarray(ref.color)) <= 1e-4).all(-1).mean() >= 0.99
    assert (n(out.instance) == np.asarray(ref.instance)).mean() >= 0.995
    assert len(np.unique(np.asarray(ref.instance))) >= 4  # walls and objects in view


def test_sensor_noise_from_reference_draws_equals_reference():
    """The noise model given the reference's own jax.random draws (its
    split of the key) equals the reference's add_sensor_noise exactly."""
    T = jsyn.orbit_trajectory(5)[2]
    frame = jsyn.render_frame(T, SMALL_INTR)
    key = jax.random.PRNGKey(3)
    ref = jsyn.add_sensor_noise(frame, key)
    k1, k2, k3 = jax.random.split(key, 3)
    shape = frame.depth.shape
    draws = (jax.random.normal(k1, shape, jnp.float32), jax.random.uniform(k2, shape),
             jax.random.uniform(k3, shape))
    pframe = psyn.Frame(*(t(x) for x in frame))
    out = psyn._apply_sensor_noise(pframe, *(t(d) for d in draws))
    np.testing.assert_array_equal(n(out.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(n(out.color), np.asarray(ref.color))
    assert (n(out.depth) == 0).mean() > (np.asarray(frame.depth) == 0).mean()  # dropouts


def test_noisy_sequence_from_generator():
    """make_noisy_sequence draws from one seeded torch.Generator: the same
    seed gives the same frames, another seed other noise; exact poses."""
    intr = to_port(SMALL_INTR)
    a = list(psyn.make_noisy_sequence(2, intr, seed=0, device="cpu"))
    b = list(psyn.make_noisy_sequence(2, intr, seed=0, device="cpu"))
    c = list(psyn.make_noisy_sequence(2, intr, seed=1, device="cpu"))
    assert all(torch.equal(x.depth, y.depth) for x, y in zip(a, b))
    assert not torch.equal(a[1].depth, c[1].depth)
    np.testing.assert_allclose(n(torch.stack([f.T_wc for f in a])),
                               np.asarray(jsyn.handheld_trajectory(2)), atol=2e-6)
    clean = list(psyn.make_sequence(2, intr, device="cpu"))
    np.testing.assert_array_equal(n(clean[1].T_wc),
                                  n(psyn.orbit_trajectory(2, device="cpu")[1]))
    d = clean[1].depth
    # No axial noise, every edge pixel drops, no salt: only the occlusion
    # edges go, and the rest is the depth quantized to 0.2 mm.
    edges = psyn._apply_sensor_noise(clean[1], torch.zeros_like(d), torch.zeros_like(d),
                                     torch.ones_like(d))
    kept = n(edges.depth) > 0
    assert 0 < (n(d) > 0).sum() - kept.sum() < 0.1 * (n(d) > 0).sum()
    assert np.abs(n(edges.depth) - n(d))[kept].max() <= 1e-4 + 1e-6
    both = (n(a[1].depth) > 0) & (n(c[1].depth) > 0)
    err = np.abs(n(a[1].depth) - n(c[1].depth))[both]
    assert 1e-4 < err.mean() < 0.01  # mm-scale axial noise
