"""Synthetic RGB-D frames: analytic SDF scene + sphere tracing.

Port of the fixed scene of ``datasets/synthetic.py`` (``scene_sdf``,
``render_frame``, ``orbit_trajectory``, ``handheld_trajectory``): the
interior of a 2.4 m room box holding a sphere, a box and a cylinder
(instance ids 1..3, walls 0), with exact depth and exact ground-truth
poses.  Frames are rendered on the
device, so a run on the card needs neither JAX nor any dataset.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

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


@torch.no_grad()
def render_frame(T_wc, intr: Intrinsics, texture: bool = False, device=None) -> Frame:
    """Sphere-trace the analytic scene to exact depth + flat-shaded color.

    Runs on the device of `T_wc` when it is a tensor, else on ``device``
    (default ``cuda``).
    """
    dev = T_wc.device if isinstance(T_wc, torch.Tensor) else _device.resolve(device)
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=dev)
    rays_c = ray_directions(intr, dev)
    ray_norm = torch.linalg.norm(rays_c, dim=-1)
    dirs = (rays_c.reshape(-1, 3) @ T_wc[:3, :3].T).reshape(rays_c.shape)
    dirs = dirs / ray_norm[..., None]
    o = T_wc[:3, 3]
    t = torch.full(rays_c.shape[:2], 0.05, device=dev)
    for _ in range(96):
        s, _ = scene_sdf(o + t[..., None] * dirs)
        t = t + torch.clamp(s, -0.05, 0.5) * 0.9
    p = o + t[..., None] * dirs
    s, obj = scene_sdf(p)
    hit = (torch.abs(s) < 5e-3) & (t > 0.05) & (t < 8.0)
    depth = torch.where(hit, t / ray_norm, torch.zeros_like(t))

    eps = 1e-3
    grads = []
    for ax in range(3):
        e = torch.zeros(3, device=dev)
        e[ax] = eps
        grads.append(scene_sdf(p + e)[0] - scene_sdf(p - e)[0])
    n = torch.stack(grads, -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    light = _scene(dev)["light"]
    light = light / torch.linalg.norm(light)
    shade = 0.55 + 0.45 * torch.clamp(-torch.sum(n * light, dim=-1), 0.0, 1.0)
    base = _scene(dev)["palette"][obj.long()]
    if texture:
        tex = (0.80 + 0.12 * torch.sin(17.0 * p[..., 0] + 5.0 * p[..., 2])
               + 0.08 * torch.sin(23.0 * p[..., 1] - 7.0 * p[..., 0]))
        base = base * tex[..., None]
    color = torch.where(hit[..., None], base * shade[..., None], torch.zeros_like(base))
    instance = torch.where(hit, obj, torch.full_like(obj, -1))
    return Frame(depth=depth, color=color, instance=instance, T_wc=T_wc)


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
