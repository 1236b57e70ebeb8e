"""The traffic generator: a seed gives the same frames, noise is drawn anew
for every frame, the loop is one continuous path at the configured speed,
and the ray caster puts surfaces where the scene has them."""

import math

import torch

from harness import scene

SMALL = dict(fx=535.4 / 8, fy=539.2 / 8, cx=(320.1 + 0.5) / 8 - 0.5,
             cy=(247.6 + 0.5) / 8 - 0.5, width=80, height=60)
STEP = 0.249 / 30


def test_same_seed_same_frames_other_seed_other_noise():
    poses = scene.loop_poses(21.455, STEP, "cpu")[:3]
    a = scene.render_loop(poses, SMALL, 2**31 + 11, min_range_m=0.5, max_range_m=5.0)
    b = scene.render_loop(poses, SMALL, 2**31 + 11, min_range_m=0.5, max_range_m=5.0)
    c = scene.render_loop(poses, SMALL, 2**31 + 12, min_range_m=0.5, max_range_m=5.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert torch.equal(a[1], c[1])  # the noise is the depth's alone
    assert a[0].dtype == torch.int16 and a[1].dtype == torch.uint8


def test_noise_is_drawn_for_every_frame():
    pose = scene.loop_poses(21.455, STEP, "cpu")[:1]
    d, _ = scene.render_loop(pose.repeat(2, 1, 1), SMALL, 2**31 + 5)
    clean, _ = scene.render_loop(pose, SMALL, 0, noise=False)
    assert not torch.equal(d[0], d[1])
    assert float((d[0].float() - clean[0].float()).abs().mean()) > 0.0


def test_loop_is_continuous_across_its_wrap():
    poses = scene.loop_poses(21.455, STEP, "cpu")
    assert poses.shape[0] == round(21.455 / STEP)
    t = poses[:, :3, 3]
    steps = torch.linalg.norm(torch.roll(t, -1, 0) - t, dim=-1)
    # Every step, the one from the last frame back to the first included,
    # is the configured one.
    assert float(steps.max()) < 1.01 * STEP and float(steps.min()) > 0.99 * STEP
    speed, turn = scene.path_speed(poses, 30.0)
    assert abs(speed - 0.249) < 0.01 * 0.249
    assert 5.0 < turn < 15.0
    r = torch.linalg.norm(t[:, :2], dim=-1)
    assert float(r.min()) > 1.45 and float(r.max()) < 1.95  # round the desks


def test_surfaces_where_the_scene_has_them():
    """Planes facing the camera read their exact distance along the optical
    axis: the desks' divider from 1.7 m in front, the +x wall above the shelf."""
    def at(eye, look):
        T = scene.look_pose(torch.tensor([eye]), torch.tensor([look]))
        d, _ = scene.render(T, SMALL)
        return d[0, 28:32, 38:42]

    z = scene.FLOOR + 1.0
    assert torch.allclose(at((0.0, -1.7, z), (0.0, 0.0, z)), torch.tensor(1.7 - 0.015),
                          atol=1e-4)
    z = scene.FLOOR + 2.2
    assert torch.allclose(at((0.0, 0.0, z), (1.0, 0.0, z)), torch.tensor(2.4), atol=1e-4)


def test_log_format_round_trip():
    depth = torch.tensor([[[1.2346, 0.0]]])
    color = torch.tensor([[[[0.2, 0.5, 1.0], [0.0, 0.0, 0.0]]]])
    d16 = torch.round(depth * scene.DEPTH_SCALE).to(torch.int16)
    c8 = torch.round(color * 255.0).to(torch.uint8)
    d, c = scene.frame(d16, c8, 0)
    assert d.dtype == torch.float32 and math.isclose(float(d[0, 0]), 1.2346, abs_tol=1e-6)
    assert float(d[0, 1]) == 0.0 and float(c[0, 0, 2]) == 1.0
