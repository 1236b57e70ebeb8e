"""Synthetic RGB-D frames: analytic SDF scenes + sphere tracing.

Port of ``datasets/synthetic.py``: the fixed scene (``scene_sdf``,
``render_frame``), the interior of a 2.4 m room box holding a sphere, a
box and a cylinder (instance ids 1..3, walls 0); the seeded parametric
scenes (``random_scene``, ``scene_sdf_with``, ``render_frame_scene``); the
orbit and the fr1-class handheld trajectories; and the Kinect-class depth
noise (``add_sensor_noise``, ``make_noisy_sequence``).  Depth is exact
before noise and the poses are exact ground truth.  Frames are rendered on
the device, so a run on the card needs neither JAX nor any dataset.

``jax.random`` streams cannot be replayed in torch: the noise draws come
from a ``torch.Generator``, and ``_apply_sensor_noise`` takes the draws as
arguments, so a test can feed it the reference's own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.geometry.camera import Intrinsics, ray_directions
from instancefusion_tpu_torch.geometry.se3 import se3_exp
from instancefusion_tpu_torch.models.segmentation import Segmentation


class Frame(NamedTuple):
    depth: torch.Tensor  # f32[H,W] meters, 0 = invalid
    color: torch.Tensor  # f32[H,W,3] in [0,1]
    instance: torch.Tensor  # i32[H,W] ground-truth object id (-1 = none)
    T_wc: torch.Tensor  # f32[4,4] ground-truth camera-to-world pose


_COLORS = ((0.7, 0.7, 0.7), (0.9, 0.3, 0.2), (0.2, 0.7, 0.3), (0.2, 0.4, 0.9))


@functools.lru_cache(maxsize=None)
def _scene(device: torch.device):
    """The scene's constant vectors on `device`, made once."""
    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return {
        "room": (vec(0.0, 0.0, 1.2), vec(1.2, 1.2, 1.2)),
        "sphere": (vec(0.45, 0.10, 1.05), 0.30),
        "box": (vec(-0.50, 0.35, 1.55), vec(0.25, 0.22, 0.25)),
        "cylinder": (vec(-0.15, -0.55, 0.85), 0.18, 0.35),
        "palette": torch.tensor(_COLORS, dtype=torch.float32, device=device),
        "light": vec(0.4, -0.3, -0.85),
    }


def _sd_sphere(p, center, r):
    return torch.linalg.norm(p - center, dim=-1) - r


def _sd_box(p, center, half):
    q = torch.abs(p - center) - half
    return torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0
    )


def _sd_cylinder(p, center, r, h):
    d = p - center
    dxy = torch.linalg.norm(d[..., :2], dim=-1) - r
    dz = torch.abs(d[..., 2]) - h
    outside = torch.linalg.norm(torch.clamp(torch.stack([dxy, dz], -1), min=0.0), dim=-1)
    return outside + torch.clamp(torch.maximum(dxy, dz), max=0.0)


def scene_sdf(p: torch.Tensor):
    """Analytic scene SDF. p: (..., 3) world -> (sdf, object_id)."""
    sc = _scene(p.device)
    walls = -_sd_box(p, *sc["room"])  # positive inside the room
    ds = torch.stack(
        [walls, _sd_sphere(p, *sc["sphere"]), _sd_box(p, *sc["box"]),
         _sd_cylinder(p, *sc["cylinder"])], dim=-1,
    )
    return torch.amin(ds, dim=-1), torch.argmin(ds, dim=-1).to(torch.int32)


def _trace(T_wc: torch.Tensor, intr: Intrinsics, sdf, palette: torch.Tensor,
           texture: bool) -> Frame:
    """Sphere-trace the scene whose SDF is `sdf` (p -> (sdf, object id)),
    coloring object id i with `palette[i]` flat-shaded."""
    dev = T_wc.device
    rays_c = ray_directions(intr, dev)
    ray_norm = torch.linalg.norm(rays_c, dim=-1)
    dirs = (rays_c.reshape(-1, 3) @ T_wc[:3, :3].T).reshape(rays_c.shape)
    dirs = dirs / ray_norm[..., None]
    o = T_wc[:3, 3]
    t = torch.full(rays_c.shape[:2], 0.05, device=dev)
    for _ in range(96):
        s, _ = sdf(o + t[..., None] * dirs)
        t = t + torch.clamp(s, -0.05, 0.5) * 0.9
    p = o + t[..., None] * dirs
    s, obj = sdf(p)
    hit = (torch.abs(s) < 5e-3) & (t > 0.05) & (t < 8.0)
    depth = torch.where(hit, t / ray_norm, torch.zeros_like(t))

    eps = 1e-3
    grads = []
    for ax in range(3):
        e = torch.zeros(3, device=dev)
        e[ax] = eps
        grads.append(sdf(p + e)[0] - sdf(p - e)[0])
    n = torch.stack(grads, -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    light = _scene(dev)["light"]
    light = light / torch.linalg.norm(light)
    shade = 0.55 + 0.45 * torch.clamp(-torch.sum(n * light, dim=-1), 0.0, 1.0)
    base = palette[obj.long()]
    if texture:
        tex = (0.80 + 0.12 * torch.sin(17.0 * p[..., 0] + 5.0 * p[..., 2])
               + 0.08 * torch.sin(23.0 * p[..., 1] - 7.0 * p[..., 0]))
        base = base * tex[..., None]
    color = torch.where(hit[..., None], base * shade[..., None], torch.zeros_like(base))
    instance = torch.where(hit, obj, torch.full_like(obj, -1))
    return Frame(depth=depth, color=color, instance=instance, T_wc=T_wc)


@torch.no_grad()
def render_frame(T_wc, intr: Intrinsics, texture: bool = False, device=None) -> Frame:
    """Sphere-trace the analytic scene to exact depth + flat-shaded color.

    Runs on the device of `T_wc` when it is a tensor, else on ``device``
    (default ``cuda``).
    """
    dev = T_wc.device if isinstance(T_wc, torch.Tensor) else _device.resolve(device)
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
    return _trace(T_wc, intr, scene_sdf, _scene(dev)["palette"], texture)


def make_sequence(num_frames: int, intr: Intrinsics, device=None):
    """Generator of Frames along the orbit trajectory."""
    poses = orbit_trajectory(num_frames, device=device)
    for i in range(num_frames):
        yield render_frame(poses[i], intr)


# ---------------------------------------------------------------------------
# Seeded parametric scenes
# ---------------------------------------------------------------------------

MAX_SCENE_OBJECTS = 6
# Base color per object kind (1 sphere, 2 box, 3 cylinder), the fixed
# scene's palette; random_scene jitters around these.
_KIND_COLORS = ((0.0, 0.0, 0.0), (0.9, 0.3, 0.2), (0.2, 0.7, 0.3), (0.2, 0.4, 0.9))


class Scene(NamedTuple):
    """A parametric room scene of MAX_SCENE_OBJECTS slots (kind 0 = empty).

    sizes packs per-kind parameters: sphere (r, -, -), box (half extents),
    cylinder (r, h, -).
    """

    centers: torch.Tensor  # f32[K, 3]
    sizes: torch.Tensor  # f32[K, 3]
    kinds: torch.Tensor  # i32[K] 1 sphere, 2 box, 3 cylinder, 0 empty
    colors: torch.Tensor  # f32[K, 3]


def random_scene(seed: int, n_min: int = 3, n_max: int = MAX_SCENE_OBJECTS,
                 device=None) -> Scene:
    """A seeded room scene: object count, kind, pose, size and color vary by
    seed (rejection-placed to avoid heavy overlap).  Drawn with numpy
    exactly as the reference draws it, so a seed gives the same scene in
    both packages."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    k = MAX_SCENE_OBJECTS
    n = int(rng.integers(n_min, n_max + 1))
    kinds = np.zeros(k, np.int32)
    kinds[:n] = rng.integers(1, 4, n)
    centers = np.zeros((k, 3), np.float32)
    placed: list = []
    for i in range(n):
        c = None
        for _ in range(64):
            c = np.array([
                rng.uniform(-0.7, 0.7),
                rng.uniform(-0.55, 0.7),  # keep clear of the orbit eyes
                rng.uniform(0.7, 1.7),
            ])
            if all(np.linalg.norm(c - q) > 0.55 for q in placed):
                break
        placed.append(c)
        centers[i] = c
    sizes = np.zeros((k, 3), np.float32)
    for i in range(n):
        if kinds[i] == 1:
            sizes[i, 0] = rng.uniform(0.16, 0.32)
        elif kinds[i] == 2:
            sizes[i] = rng.uniform(0.14, 0.27, 3)
        else:
            sizes[i, 0] = rng.uniform(0.12, 0.22)
            sizes[i, 1] = rng.uniform(0.22, 0.38)
    base = np.asarray(_KIND_COLORS, np.float32)
    colors = np.zeros((k, 3), np.float32)
    for i in range(n):
        colors[i] = np.clip(base[kinds[i]] + rng.uniform(-0.18, 0.18, 3), 0.05, 1.0)
    return Scene(*(torch.as_tensor(x, device=dev) for x in (centers, sizes, kinds, colors)))


def scene_sdf_with(p: torch.Tensor, scene: Scene):
    """Parametric-scene SDF. p: (..., 3) world -> (sdf, object_id), id 0 the
    walls and i + 1 object slot i (as ``scene_sdf``)."""
    room_center, room_half = _scene(p.device)["room"]
    walls = -_sd_box(p, room_center, room_half)
    d = p[..., None, :] - scene.centers  # (..., K, 3)
    sph = torch.linalg.norm(d, dim=-1) - scene.sizes[:, 0]
    q = torch.abs(d) - scene.sizes
    box = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0)
    dxy = torch.linalg.norm(d[..., :2], dim=-1) - scene.sizes[:, 0]
    dz = torch.abs(d[..., 2]) - scene.sizes[:, 1]
    cyl = torch.linalg.norm(torch.clamp(torch.stack([dxy, dz], -1), min=0.0), dim=-1) \
        + torch.clamp(torch.maximum(dxy, dz), max=0.0)
    ds = torch.where(scene.kinds == 1, sph, torch.where(scene.kinds == 2, box, cyl))
    ds = torch.where(scene.kinds > 0, ds, torch.full_like(ds, 1e9))  # empty slots never win
    all_ds = torch.cat([walls[..., None], ds], dim=-1)
    return torch.amin(all_ds, dim=-1), torch.argmin(all_ds, dim=-1).to(torch.int32)


@torch.no_grad()
def render_frame_scene(T_wc, intr: Intrinsics, scene: Scene, texture: bool = False) -> Frame:
    """Sphere-trace a parametric Scene (``random_scene``) on its device, as
    ``render_frame`` traces the fixed scene."""
    dev = scene.centers.device
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
    wall = torch.tensor([[0.7, 0.7, 0.7]], dtype=torch.float32, device=dev)
    return _trace(T_wc, intr, lambda p: scene_sdf_with(p, scene),
                  torch.cat([wall, scene.colors]), texture)


def gt_segmentation(inst: torch.Tensor, k: int) -> Segmentation:
    """A frame's ground-truth instance image (``Frame.instance``) as a K-slot
    ``Segmentation``.

    Object ids 0..3 (walls, sphere, box, cylinder) are the masks, with
    class id + 1 and score 1 where present; slot 0 also counts as present
    wherever a pixel has no id, as in the reference's tests.
    """
    dev = inst.device
    ids = inst.clamp(0, k - 1).reshape(-1).long()
    present = torch.zeros(k, dtype=torch.bool, device=dev).scatter_(
        0, ids, torch.ones_like(ids, dtype=torch.bool))
    slot = torch.arange(k, device=dev)
    present = present & (slot < 4)
    return Segmentation(
        mask_id=torch.where(inst >= 0, inst, torch.full_like(inst, -1)).to(torch.int32),
        classes=torch.where(present, slot + 1, torch.zeros_like(slot)).to(torch.int32),
        scores=present.float(),
        valid=present,
    )


def orbit_trajectory(num_frames: int, radius: float = 0.45, center=None,
                     sweep: float = 1.2, device=None) -> torch.Tensor:
    """Smooth camera arc inside the room looking at the scene: (N, 4, 4).

    Adjacent poses differ by a few mm / fractions of a degree, like a
    handheld 30 Hz sweep.
    """
    dev = _device.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    look_at = torch.tensor((0.0, 0.0, 1.2) if center is None else center, **f32)
    ts = torch.linspace(0.0, 1.0, num_frames, **f32)
    ang = (ts - 0.5) * sweep
    eyes = torch.stack(
        [radius * torch.sin(ang), -0.95 + 0.06 * torch.sin(ts * 5.0),
         1.1 + 0.08 * torch.cos(ts * 3.0)], dim=-1,
    )
    fwd = look_at - eyes
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    up_hint = torch.tensor((0.0, 0.0, -1.0), **f32).expand_as(fwd)
    right = torch.linalg.cross(fwd, up_hint)
    right = right / torch.clamp(torch.linalg.norm(right, dim=-1, keepdim=True), min=1e-9)
    down = torch.linalg.cross(fwd, right)  # camera +y points "down" in world
    T = torch.eye(4, **f32).repeat(num_frames, 1, 1)
    T[:, :3, :3] = torch.stack([right, down, fwd], dim=-1)
    T[:, :3, 3] = eyes
    return T


def handheld_trajectory(num_frames: int, radius: float = 0.45, sweep: float = 1.6,
                        shake_rot: float = 0.02, shake_trans: float = 0.012,
                        device=None) -> torch.Tensor:
    """fr1-class handheld motion: a fast arc with rotational shake, (N, 4, 4).

    The orbit's arc swept faster, with a smooth multi-sine SE(3) shake on
    the right of each pose (deterministic; peak ~shake_rot rad and
    ~shake_trans m frame-to-frame deltas).
    """
    base = orbit_trajectory(num_frames, radius=radius, sweep=sweep, device=device)
    t = torch.linspace(0.0, 1.0, num_frames, dtype=torch.float32, device=base.device)
    xi = torch.stack([
        shake_trans * torch.sin(t * 37.0),
        shake_trans * torch.sin(t * 29.0 + 1.3),
        shake_trans * 0.6 * torch.sin(t * 43.0 + 0.4),
        shake_rot * torch.sin(t * 31.0 + 2.1),
        shake_rot * torch.sin(t * 41.0 + 0.9),
        shake_rot * 0.5 * torch.sin(t * 23.0 + 1.7),
    ], dim=-1)
    return base @ se3_exp(xi)


# ---------------------------------------------------------------------------
# Sensor noise (the fr1-class stress rig)
# ---------------------------------------------------------------------------


def _apply_sensor_noise(frame: Frame, normal: torch.Tensor, u_edge: torch.Tensor,
                       u_speckle: torch.Tensor, sigma_base: float = 0.0012,
                       sigma_z2: float = 0.0019, edge_dropout: float = 0.6,
                       speckle_dropout: float = 0.002) -> Frame:
    """Kinect-class depth corruption from given draws, each shaped as the
    depth: a standard normal and two uniforms in [0, 1).

    - axial Gaussian noise with sigma 0.0012 + 0.0019 (z - 0.4)^2 m
      (Khoshelham and Elberink's Kinect fit);
    - quantization to the TUM 16-bit depth scale (1/5000 m steps);
    - edge dropout: pixels whose 3x3 depth neighborhood jumps more than
      4 cm (occlusion boundaries) drop with probability `edge_dropout`;
    - salt dropout with probability `speckle_dropout`.
    """
    d = frame.depth
    valid = d > 0.0
    z = torch.clamp(d - 0.4, min=0.0)
    sigma = sigma_base + sigma_z2 * z * z
    # 0.2 mm steps, scaled back by the reciprocal as the reference's
    # compiled division does (XLA rewrites x / c as x * (1 / c)).
    noisy = torch.round((d + sigma * normal) * 5000.0) * (1.0 / 5000.0)
    h, w = d.shape
    pad = F.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    jump = torch.zeros_like(d)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            jump = torch.maximum(jump, torch.abs(nb - d))
    drop_e = (jump > 0.04) & (u_edge < edge_dropout)
    drop_s = u_speckle < speckle_dropout
    keep = valid & ~drop_e & ~drop_s
    return frame._replace(depth=torch.where(keep, torch.clamp(noisy, min=0.0),
                                            torch.zeros_like(d)))


def add_sensor_noise(frame: Frame, generator: torch.Generator, **noise_kw) -> Frame:
    """``_apply_sensor_noise`` with its draws from `generator` (on the
    frame's device): the normal, then the edge and the salt uniforms."""
    shape, dev = frame.depth.shape, frame.depth.device
    normal = torch.randn(shape, generator=generator, device=dev)
    u_edge = torch.rand(shape, generator=generator, device=dev)
    u_speckle = torch.rand(shape, generator=generator, device=dev)
    return _apply_sensor_noise(frame, normal, u_edge, u_speckle, **noise_kw)


def make_noisy_sequence(num_frames: int, intr: Intrinsics, seed: int = 0,
                        aggressive: bool = True, device=None, **noise_kw):
    """Generator of noise-corrupted Frames along the handheld trajectory
    (the orbit unless `aggressive`), with exact poses and clean colors; the
    noise draws come from one ``torch.Generator`` seeded with `seed`."""
    poses = (handheld_trajectory(num_frames, device=device) if aggressive
             else orbit_trajectory(num_frames, device=device))
    gen = torch.Generator(device=poses.device)
    gen.manual_seed(seed)
    for i in range(num_frames):
        yield add_sensor_noise(render_frame(poses[i], intr), gen, **noise_kw)
