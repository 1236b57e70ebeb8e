"""Port ICP (association K2, Gauss-Newton K3, track) against the reference's
jnp path on the CPU (the CUDA kernels: tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.config import IcpConfig, PreprocessConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.geometry import se3 as jse3
from instancefusion_tpu.ops import icp as jicp
from instancefusion_tpu.ops import preprocess as jpp
from instancefusion_tpu_torch.geometry import se3 as pse3
from instancefusion_tpu_torch.ops import icp as picp
from instancefusion_tpu_torch.ops.kernels import icp as kicp
from tests.helpers import SMALL_INTR
from tests.torch_helpers import n, t, to_port

ICP1 = IcpConfig(iters=(6,), levels=1, assoc_every=2, min_valid=60)


@pytest.fixture(scope="module")
def scene():
    """Target maps from the frame at pose 0 (world frame), source pyramid
    level 0 of the frame at pose 1 (~2 deg, ~1.5 cm away), both from the
    reference renderer."""
    poses = jsyn.orbit_trajectory(30)
    cfg = PreprocessConfig()
    tgt = jpp.build_frame_pyramid(jsyn.render_frame(poses[0], SMALL_INTR).depth,
                                  SMALL_INTR, cfg, 1)[0]
    T0 = poses[0]
    tv = jse3.transform_points(T0, tgt["vmap"])
    tn = jse3.rotate_vectors(T0, tgt["nmap"])
    src = jpp.build_frame_pyramid(jsyn.render_frame(poses[1], SMALL_INTR).depth,
                                  SMALL_INTR, cfg, 1)[0]
    return {k: np.asarray(v) for k, v in dict(
        tv=tv, tn=tn, tval=tgt["valid"], sv=src["vmap"], sn=src["nmap"],
        sval=src["valid"], T0=T0, T1=poses[1]).items()}


def _perturbed(T, seed=0):
    xi = np.random.default_rng(seed).normal(scale=(0.01,) * 3 + (0.005,) * 3)
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)) @ T)


def test_associate_matches_reference(scene):
    s = scene
    T_est = _perturbed(s["T0"])
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    q_r, n_r, ok_r = jicp.associate(s["sv"], s["sval"], s["tv"], s["tn"], s["tval"],
                                    T_est, T_cw, SMALL_INTR, IcpConfig())
    q, n_t, ok = picp.associate(t(s["sv"]), t(s["sval"]), t(s["tv"]), t(s["tn"]),
                                t(s["tval"]), t(T_est), t(T_cw), to_port(SMALL_INTR))
    ok_r, ok = np.asarray(ok_r), n(ok)
    assert ok_r.sum() > 5000
    # Same pixels, same values, but for projections onto a .5 boundary,
    # where a different FMA order in the transform rounds the other way and
    # picks (or drops) the neighbouring target pixel: at most 0.1%.
    both = ok & ok_r
    moved = (ok != ok_r) | (both & ((n(q) != np.asarray(q_r)).any(-1)
                                    | (n(n_t) != np.asarray(n_r)).any(-1)))
    assert moved.sum() <= 1e-3 * ok_r.size, moved.sum()


def test_reduce_and_solve_match_reference(scene):
    s = scene
    T_est = _perturbed(s["T0"], seed=1)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    q, n_t, ok = jicp.associate(s["sv"], s["sval"], s["tv"], s["tn"], s["tval"],
                                T_est, T_cw, SMALL_INTR, IcpConfig())
    cfg = IcpConfig(huber_delta=0.02)
    ref = jicp.reduce_equations(s["sv"], s["sn"], s["sval"], q, n_t, ok, T_est, cfg)
    out = picp.reduce_equations(t(s["sv"]), t(s["sn"]), t(s["sval"]), t(q), t(n_t),
                                t(ok), t(T_est), to_port(cfg))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=2e-4, atol=1e-3)
    xi_r = jicp.solve_increment(*ref[:2], cfg)
    xi = picp.solve_increment(t(ref[0]), t(ref[1]), to_port(cfg))
    # The system is ill-conditioned (diagonal spans ~4 decades), so two
    # LU solves of the same fp32 system differ by ~1e-5 in the twist.
    np.testing.assert_allclose(n(xi), np.asarray(xi_r), rtol=1e-4, atol=2e-5)


def test_track_one_level_matches_reference(scene):
    """Pose atol 5e-5, as tests/test_pallas.py holds the fused GN kernel."""
    s = scene
    ref = jicp.track([dict(vmap=s["sv"], nmap=s["sn"], valid=s["sval"])],
                     s["tv"], s["tn"], s["tval"], s["T0"], s["T0"], SMALL_INTR, ICP1)
    out = picp.track([dict(vmap=t(s["sv"]), nmap=t(s["sn"]), valid=t(s["sval"]))],
                     t(s["tv"]), t(s["tn"]), t(s["tval"]), t(s["T0"]), t(s["T0"]),
                     to_port(SMALL_INTR), to_port(ICP1))
    assert bool(ref.valid) and bool(out.valid)
    np.testing.assert_allclose(n(out.T_wc), np.asarray(ref.T_wc), atol=5e-5)
    np.testing.assert_allclose(float(out.inliers), float(ref.inliers), rtol=1e-3)
    # And the track converged near the true pose (a few mm).
    assert np.abs(n(out.T_wc)[:3, 3] - s["T1"][:3, 3]).max() < 0.005


def test_track_gate_keeps_seed_without_target():
    """No valid prediction: tracking fails closed and returns the seed."""
    intr = to_port(SMALL_INTR)
    h, w = intr.height, intr.width
    z3, z = torch.zeros(h, w, 3), torch.zeros(h, w, dtype=torch.bool)
    vmap = torch.ones(h, w, 3)
    seed = pse3.se3_exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.05, 0.0]))
    out = picp.track([dict(vmap=vmap, nmap=z3, valid=~z)], z3, z3, z, seed,
                     torch.eye(4), intr, to_port(ICP1))
    assert not bool(out.valid)
    assert torch.equal(out.T_wc, seed)


def _gn_inputs(scene):
    s = scene
    T_est = _perturbed(s["T0"], seed=2)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    q, n_t, ok = jicp.associate(s["sv"], s["sval"], s["tv"], s["tn"], s["tval"],
                                T_est, T_cw, SMALL_INTR, IcpConfig())
    gate = (np.asarray(ok) & s["sval"].reshape(-1)).astype(np.float32)

    def d(x):
        return t(x).float().reshape(-1, 3).contiguous()

    return d(s["sv"]), d(s["sn"]), d(q), d(n_t), t(gate), t(T_est)


GN_KW = dict(inner_n=4, dist_thresh=0.1, angle_thresh=0.34, huber_delta=0.0,
             damping=1e-6, min_valid=60)


def test_gn_plain_runs_on_cpu(scene):
    """The wrapper takes the plain version for CPU tensors and counts no
    launch."""
    args = _gn_inputs(scene)
    before = kicp.gn_iterations.launches
    T, nin, _ = kicp.gn_iterations(*args, **GN_KW)
    assert kicp.gn_iterations.launches == before
    assert float(nin) >= 60 and torch.isfinite(T).all()


# ------------------------------------------------------ the photometric term

ICP1_RGB = IcpConfig(iters=(6,), levels=1, assoc_every=2, min_valid=60, rgb_weight=0.1)


@pytest.fixture(scope="module")
def rgb_scene():
    """The scene of `scene` rendered with texture: target maps and
    intensity (with its gradients) of pose 0, source level 0 with its
    intensity at pose 1."""
    poses = jsyn.orbit_trajectory(30)
    cfg = PreprocessConfig()
    out = {"T0": np.asarray(poses[0])}
    for key, i in (("t", 0), ("s", 1)):
        f = jsyn.render_frame(poses[i], SMALL_INTR, texture=True)
        lvl = jpp.build_frame_pyramid(f.depth, SMALL_INTR, cfg, 1)[0]
        out.update({f"{key}v": lvl["vmap"], f"{key}n": lvl["nmap"],
                    f"{key}val": lvl["valid"], f"{key}i": jpp.rgb_to_intensity(f.color)})
    out["tv"] = jse3.transform_points(poses[0], out["tv"])
    out["tn"] = jse3.rotate_vectors(poses[0], out["tn"])
    out["tgx"], out["tgy"] = jicp.intensity_gradients(out["ti"])
    return {k: np.asarray(v) for k, v in out.items()}


def test_intensity_gradients_match_reference():
    img = np.random.default_rng(3).uniform(0, 1, (37, 53)).astype(np.float32)
    ref = jicp.intensity_gradients(jnp.asarray(img))
    out = picp.intensity_gradients(t(img))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert (n(out[0])[0] == 0).all() and (n(out[1])[:, -1] == 0).all()


def test_associate_rgb_matches_jnp_branch(rgb_scene):
    """The rgb planes are gathered at the geometric target pixel: equal to
    the jnp branch wherever both pick the same target pixel (all but the
    <= 0.1% projections onto a .5 boundary of test_associate_matches_reference)."""
    s = rgb_scene
    T_est = _perturbed(s["T0"], seed=4)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    planes = (s["ti"], s["tgx"], s["tgy"])
    ref = jicp.associate(s["sv"], s["sval"], s["tv"], s["tn"], s["tval"], T_est, T_cw,
                         SMALL_INTR, IcpConfig(), tgt_rgb=planes)
    out = picp.associate(t(s["sv"]), t(s["sval"]), t(s["tv"]), t(s["tn"]), t(s["tval"]),
                         t(T_est), t(T_cw), to_port(SMALL_INTR),
                         tgt_rgb=tuple(t(p) for p in planes))
    assert len(out) == 4 and len(out[3]) == 4
    ok_r, ok = np.asarray(ref[2]), n(out[2])
    np.testing.assert_array_equal(n(out[3][3]), ok)
    same = (ok & ok_r & (n(out[0]) == np.asarray(ref[0])).all(-1)
            & (n(out[1]) == np.asarray(ref[1])).all(-1))
    assert same.sum() > 5000 and (ok != ok_r).sum() <= 1e-3 * ok.size
    for a, b in zip(out[3][:3], ref[3][:3]):
        np.testing.assert_array_equal(n(a)[same], np.asarray(b)[same])
    # The plain gather returns the target planes at exactly its own pixels.
    u, v, sel = picp.association_inputs(t(s["sv"]), t(s["sval"]), t(T_est), t(T_cw),
                                        to_port(SMALL_INTR))
    *_, rgb = kicp.gather_target_maps_ref(u, v, sel, t(s["tv"]), t(s["tn"]),
                                          t(s["tval"]), tuple(t(p) for p in planes))
    h, w = s["ti"].shape
    flat = (np.clip(np.ceil(n(v) - 0.5), 0, h - 1) * w
            + np.clip(np.ceil(n(u) - 0.5), 0, w - 1)).astype(np.int64)
    for a, p in zip(rgb, planes):
        np.testing.assert_array_equal(n(a), p.reshape(-1)[flat])


def test_reduce_rgb_matches_reference(rgb_scene):
    s = rgb_scene
    T_est = _perturbed(s["T0"], seed=5)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    *_, (i_t, gx_t, gy_t, ok) = jicp.associate(
        s["sv"], s["sval"], s["tv"], s["tn"], s["tval"], T_est, T_cw, SMALL_INTR,
        IcpConfig(), tgt_rgb=(s["ti"], s["tgx"], s["tgy"]))
    ref = jicp.reduce_rgb_equations(s["sv"], s["si"], i_t, gx_t, gy_t, ok, T_est, T_cw,
                                    SMALL_INTR)
    out = picp.reduce_rgb_equations(t(s["sv"]), t(s["si"]), t(i_t), t(gx_t), t(gy_t),
                                    t(ok), t(T_est), t(T_cw), to_port(SMALL_INTR))
    assert float(ref[2]) > 5000 and float(np.abs(np.asarray(ref[1])).max()) > 1.0
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=2e-4, atol=1e-3)


def test_gn_rgb_plain_matches_pallas():
    """Plain K3 with the photometric term against the reference's fused GN
    kernel in interpret mode, on tests/test_pallas.py's construction (made
    with numpy here): pose atol 5e-5, as that test holds the kernel."""
    from instancefusion_tpu.ops.pallas.icp import gn_iterations as pallas_gn

    rng = np.random.default_rng(4)
    n_pts = 4096
    q = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    q[:, 2] += 3.0
    nrm = q / np.linalg.norm(q, axis=-1, keepdims=True)
    T_true = np.asarray(jse3.se3_exp(jnp.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.015])))
    R, tt = T_true[:3, :3], T_true[:3, 3]
    v = ((q - tt) @ R).astype(np.float32)
    nm = (nrm @ R).astype(np.float32)
    T_pred_cw = np.asarray(jse3.se3_exp(jnp.array([0.05, 0.02, -0.04, 0.03, 0.01, -0.02])))
    i_src = rng.uniform(0, 1, n_pts).astype(np.float32)
    rgb = (i_src, (i_src + 0.05 * rng.normal(size=n_pts)).astype(np.float32),
           (0.1 * rng.normal(size=n_pts)).astype(np.float32),
           (0.1 * rng.normal(size=n_pts)).astype(np.float32), np.ones(n_pts, np.float32))
    cfg = IcpConfig(huber_delta=0.02, rgb_weight=0.3)
    kw = dict(inner_n=3, dist_thresh=cfg.dist_thresh, angle_thresh=cfg.angle_thresh,
              huber_delta=cfg.huber_delta, damping=cfg.damping, min_valid=cfg.min_valid)
    gate, eye = np.ones(n_pts, np.float32), np.eye(4, dtype=np.float32)
    T_ref, nin_ref, _ = pallas_gn(v, nm, q, nrm, gate, eye, **kw, rgb=rgb,
                                  T_pred_cw=T_pred_cw, rgb_intr=(200.0, 210.0),
                                  rgb_weight=cfg.rgb_weight, interpret=True)
    args = [t(x) for x in (v, nm, q, nrm, gate, eye)]
    rgb_kw = dict(rgb=tuple(t(x) for x in rgb), T_pred_cw=t(T_pred_cw),
                  rgb_intr=(200.0, 210.0), rgb_weight=cfg.rgb_weight)
    T, nin, _ = kicp.gn_iterations_ref(*args, **kw, **rgb_kw)
    np.testing.assert_allclose(n(T), np.asarray(T_ref), atol=5e-5)
    assert abs(float(nin) - float(nin_ref)) < 1
    # The wrapper runs the same plain steps on the CPU and leaves the
    # trust-fraction weight, which is non-zero.
    T_w, _, _ = kicp.gn_iterations(*args, **kw, **rgb_kw)
    assert torch.equal(T_w, T) and float(kicp.gn_iterations.last_wr) > 0.0
    # Without the term the pose is a different one.
    T_geo, _, _ = kicp.gn_iterations_ref(*args, **kw)
    assert np.abs(n(T_geo) - n(T)).max() > 1e-4


@pytest.mark.parametrize("inner_n", [1, 2, 4])
def test_gn_plain_matches_pallas(inner_n):
    """Plain K3 without the photometric planes against the reference's
    fused GN kernel in interpret mode: pose atol 5e-5 and inliers within 1,
    for 1, 2 and 4 steps (one launch of the card's
    kernel each).  The points are those of test_gn_rgb_plain_matches_pallas;
    the normals are random unit vectors facing the camera, not the radial
    ones there: with n parallel to p the rotation block of J = [n, p x n]
    vanishes, and on such a system the reference's own jnp loop and its
    kernel differ by up to 6e-5 after one step."""
    from instancefusion_tpu.ops.pallas.icp import gn_iterations as pallas_gn

    rng = np.random.default_rng(5)
    n_pts = 4096
    q = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    q[:, 2] += 3.0
    nrm = rng.normal(size=(n_pts, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[nrm[:, 2] > 0] *= -1
    T_true = np.asarray(jse3.se3_exp(jnp.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.015])))
    R, tt = T_true[:3, :3], T_true[:3, 3]
    v = ((q - tt) @ R).astype(np.float32)
    nm = (nrm @ R).astype(np.float32)
    cfg = IcpConfig(huber_delta=0.02)
    kw = dict(inner_n=inner_n, dist_thresh=cfg.dist_thresh, angle_thresh=cfg.angle_thresh,
              huber_delta=cfg.huber_delta, damping=cfg.damping, min_valid=cfg.min_valid)
    gate, eye = np.ones(n_pts, np.float32), np.eye(4, dtype=np.float32)
    T_ref, nin_ref, _ = pallas_gn(v, nm, q, nrm, gate, eye, **kw, interpret=True)
    args = [t(x) for x in (v, nm, q, nrm, gate, eye)]
    T, nin, _ = kicp.gn_iterations_ref(*args, **kw)
    np.testing.assert_allclose(n(T), np.asarray(T_ref), atol=5e-5)
    assert abs(float(nin) - float(nin_ref)) < 1
    # The wrapper runs the same plain steps on the CPU and counts no launch.
    before = kicp.gn_iterations.launches
    T_w, _, _ = kicp.gn_iterations(*args, **kw)
    assert torch.equal(T_w, T) and kicp.gn_iterations.launches == before
    # Each step moves the pose towards the truth.
    assert np.abs(n(T) - T_true).max() < np.abs(eye - T_true).max()


@pytest.mark.parametrize("huber_delta", [0.0, 0.005])
def test_normal_equations_plain_matches_pallas(huber_delta):
    """Plain K6 against the reference's reduction kernel in interpret mode on
    tests/test_pallas.py's inputs: rtol/atol 2e-3 (the sums are taken in
    another order), inliers within 1, residual sum rtol 1e-3."""
    from instancefusion_tpu.ops.pallas.icp import reduce_normal_equations

    rng = np.random.default_rng(0)
    n_pts = 10_000
    p = rng.normal(0, 1, (n_pts, 3)).astype(np.float32)
    nt = rng.normal(0, 1, (n_pts, 3)).astype(np.float32)
    nt = nt / np.linalg.norm(nt, axis=-1, keepdims=True)
    q = p + rng.normal(0, 0.01, (n_pts, 3)).astype(np.float32)
    m = (rng.random(n_pts) > 0.3).astype(np.float32)
    ref = reduce_normal_equations(p, nt, q, m, huber_delta, True)
    before = kicp.normal_equations.launches
    out = kicp.normal_equations(t(p), t(nt), t(q), t(m), huber_delta)
    assert kicp.normal_equations.launches == before  # plain on the CPU
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=2e-3, atol=2e-3)
    assert abs(float(out[2]) - float(ref[2])) < 1.0
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-3)


def test_build_normal_equations_matches_reference(scene):
    """Associate + reduce in one call.  The association moves <= 0.1% of
    the pixels (a .5 boundary rounded the other way, see
    test_associate_matches_reference), so the sums are held at K6's own
    tolerance, rtol/atol 2e-3, and the inliers within 0.1%."""
    s = scene
    T_est = _perturbed(s["T0"], seed=6)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    cfg = IcpConfig(huber_delta=0.02)
    ref = jicp.build_normal_equations(s["sv"], s["sn"], s["sval"], s["tv"], s["tn"],
                                      s["tval"], T_est, T_cw, SMALL_INTR, cfg)
    out = picp.build_normal_equations(t(s["sv"]), t(s["sn"]), t(s["sval"]), t(s["tv"]),
                                      t(s["tn"]), t(s["tval"]), t(T_est), t(T_cw),
                                      to_port(SMALL_INTR), to_port(cfg))
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=2e-3, atol=2e-3)
    assert abs(float(out[2]) - float(ref[2])) <= 1e-3 * float(ref[2])
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=2e-3)


def test_track_rgb_one_level_matches_reference(rgb_scene):
    """`track` with rgb_weight 0.1 on textured frames: pose atol 5e-5, as
    the geometric track."""
    s = rgb_scene
    src = dict(vmap=s["sv"], nmap=s["sn"], valid=s["sval"], intensity=s["si"])
    ref = jicp.track([src], s["tv"], s["tn"], s["tval"], s["T0"], s["T0"], SMALL_INTR,
                     ICP1_RGB, pred_intensity=s["ti"])
    out = picp.track([{k: t(x) for k, x in src.items()}], t(s["tv"]), t(s["tn"]),
                     t(s["tval"]), t(s["T0"]), t(s["T0"]), to_port(SMALL_INTR),
                     to_port(ICP1_RGB), pred_intensity=t(s["ti"]))
    assert bool(ref.valid) and bool(out.valid)
    np.testing.assert_allclose(n(out.T_wc), np.asarray(ref.T_wc), atol=5e-5)
    np.testing.assert_allclose(float(out.inliers), float(ref.inliers), rtol=1e-3)
    assert float(kicp.gn_iterations.last_wr) > 0.0


# ------------------------------------------ K2: the association of one level


@pytest.fixture(scope="module")
def level_scene():
    """Full-resolution target maps and intensity of pose 0 (textured,
    world frame), and a 3-level source pyramid with intensity at pose 1."""
    poses = jsyn.orbit_trajectory(30)
    cfg = PreprocessConfig()
    tf = jsyn.render_frame(poses[0], SMALL_INTR, texture=True)
    sf = jsyn.render_frame(poses[1], SMALL_INTR, texture=True)
    tgt = jpp.build_frame_pyramid(tf.depth, SMALL_INTR, cfg, 1)[0]
    src = jpp.build_frame_pyramid(sf.depth, SMALL_INTR, cfg, 3,
                                  jpp.rgb_to_intensity(sf.color))
    out = dict(tv=jse3.transform_points(poses[0], tgt["vmap"]),
               tn=jse3.rotate_vectors(poses[0], tgt["nmap"]), tval=tgt["valid"],
               ti=jpp.rgb_to_intensity(tf.color), T0=poses[0])
    out = {k: np.asarray(v) for k, v in out.items()}
    out["src"] = [{k: np.asarray(v) for k, v in lvl.items()} for lvl in src]
    return out


def _level_inputs(s, lvl, with_rgb, seed):
    """The level's source maps, the pose pair, the decimated targets and
    (with_rgb) the level's photometric planes, as numpy arrays."""
    st = 1 << lvl
    T_est = _perturbed(s["T0"], seed=seed)
    T_cw = np.asarray(jse3.se3_inverse(s["T0"]))
    h, w = s["tval"].shape
    dec = [x[:h // st * st:st, :w // st * st:st] for x in (s["tv"], s["tn"], s["tval"])]
    planes = None
    if with_rgb:
        ti = s["ti"][:h // st * st:st, :w // st * st:st]
        planes = (ti, *(np.asarray(g) for g in jicp.intensity_gradients(jnp.asarray(ti))))
    return s["src"][lvl], T_est, T_cw, dec, planes


@pytest.mark.parametrize("with_rgb", [False, True])
@pytest.mark.parametrize("lvl", [1, 2])
def test_associate_gather_matches_reference(level_scene, lvl, with_rgb):
    """Plain K2 at a level's stride (full-resolution targets) against the
    reference's associate on the decimated targets: the same pixels and
    values but for projections onto a .5 boundary, at most 0.1% (the rule
    of test_associate_matches_reference); the planes equal wherever both
    pick the same pixel."""
    s = level_scene
    src, T_est, T_cw, dec, planes = _level_inputs(s, lvl, with_rgb, seed=7 + lvl)
    intr_l = SMALL_INTR.level(lvl)
    ref = jicp.associate(src["vmap"], src["valid"], *dec, T_est, T_cw, intr_l, IcpConfig(),
                         tgt_rgb=planes)
    before = kicp.associate_gather.launches
    a = kicp.associate_gather(
        t(src["vmap"]).reshape(-1, 3), t(src["valid"]).reshape(-1), t(T_est), t(T_cw),
        to_port(intr_l), t(s["tv"]), t(s["tn"]), t(s["tval"]), 1 << lvl,
        None if planes is None else tuple(t(p) for p in planes))
    assert kicp.associate_gather.launches == before  # plain on the CPU
    ok_r, ok = np.asarray(ref[2]), n(a.ok)
    assert ok_r.sum() > 0.3 * ok_r.size
    np.testing.assert_array_equal(n(a.gate), ok.astype(np.float32))
    same = (ok & ok_r & (n(a.q_w) == np.asarray(ref[0])).all(-1)
            & (n(a.n_t) == np.asarray(ref[1])).all(-1))
    moved = (ok != ok_r) | (ok & ok_r & ~same)
    assert moved.sum() <= 1e-3 * ok_r.size, moved.sum()
    if with_rgb:
        for x, y in zip(a.rgb, ref[3][:3]):
            np.testing.assert_array_equal(n(x)[same], np.asarray(y)[same])
    else:
        assert a.rgb is None


@pytest.mark.parametrize("with_rgb", [False, True])
@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_associate_gather_equals_split_path(level_scene, lvl, with_rgb):
    """Plain K2 is, bit for bit, ``association_inputs``, the decimated
    targets (``ops/common.decimate``) and ``gather_target_maps_ref``: the
    strided read of the full-resolution maps picks the same pixels."""
    from instancefusion_tpu_torch.ops.common import decimate

    s = level_scene
    src, T_est, T_cw, _, planes = _level_inputs(s, lvl, with_rgb, seed=11 + lvl)
    st, intr_l = 1 << lvl, to_port(SMALL_INTR.level(lvl))
    sv, sval = t(src["vmap"]).reshape(-1, 3), t(src["valid"]).reshape(-1)
    tg = (t(s["tv"]), t(s["tn"]), t(s["tval"]))
    pl = None if planes is None else tuple(t(p) for p in planes)
    a = kicp.associate_gather_ref(sv, sval, t(T_est), t(T_cw), intr_l, *tg, st, pl)
    u, v, sel = kicp.association_inputs(sv, sval, t(T_est), t(T_cw), intr_l)
    ref = kicp.gather_target_maps_ref(u, v, sel, *(decimate(x, st) for x in tg), pl)
    assert int(a.ok.sum()) > 0.3 * a.ok.numel()
    for x, y in zip(a[:3], ref[:3]):
        assert torch.equal(x, y)
    assert torch.equal(a.gate, ref[2].float())
    if with_rgb:
        for x, y in zip(a.rgb, ref[3]):
            assert torch.equal(x, y)
