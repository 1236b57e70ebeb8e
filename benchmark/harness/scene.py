"""Frozen synthetic camera traffic: an office of the recorded sequence's
extent, a closed camera loop of the sequence's length at its mean speed,
and Kinect-class depth noise drawn for every frame.

The office is a 4.8 m x 4.8 m room, 2.6 m high, with two desks back to back
in its middle (monitors, books, a lamp, a mug, chairs tucked in) and
furniture along its walls (shelf, cabinets, sofa, whiteboard, plant, bin):
axis-aligned boxes, spheres and upright cylinders, ray-cast in closed form.
The camera circles the desks twice at 1.5-1.9 m from their centre, looking
at them, as the sequence's camera goes round its desks; the loop closes, so
any number of loops is one continuous path.  World z is up; the floor lies
at z = FLOOR.

A loop is rendered once, on the card and in batches, and kept as a recorded
log keeps it: depth as 16-bit integers of 1/5000 m (the TUM format), color
as 8-bit.  `frame` turns frame c into the floats the program takes.  The
depth noise (``apply_sensor_noise``) is a frozen copy of the port's
``datasets/synthetic._apply_sensor_noise``; the program receives only the
frames, so later changes to it cannot move this yardstick.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FLOOR = 0.3
DEPTH_SCALE = 5000.0  # TUM: 16-bit value / 5000 = meters

# Interior of the room: (center, half extents); its six faces are colored
# by FACE_COLORS in the order -x, +x, -y, +y, floor, ceiling.
ROOM = ((0.0, 0.0, FLOOR + 1.3), (2.4, 2.4, 1.3))
FACE_COLORS = ((0.80, 0.78, 0.70), (0.72, 0.76, 0.80), (0.85, 0.82, 0.74),
               (0.70, 0.74, 0.68), (0.45, 0.40, 0.36), (0.92, 0.92, 0.90))
# Solid boxes: (center, half extents, color).
BOXES = (
    # the desks back to back: top, two pedestals, the divider
    ((0.0, 0.0, FLOOR + 0.73), (0.75, 0.60, 0.02), (0.62, 0.48, 0.32)),
    ((-0.55, 0.0, FLOOR + 0.355), (0.17, 0.55, 0.355), (0.50, 0.50, 0.52)),
    ((0.55, 0.0, FLOOR + 0.355), (0.17, 0.55, 0.355), (0.50, 0.50, 0.52)),
    ((0.0, 0.0, FLOOR + 0.95), (0.70, 0.015, 0.20), (0.30, 0.35, 0.45)),
    # monitors and their stands
    ((-0.35, 0.22, FLOOR + 1.00), (0.27, 0.02, 0.17), (0.08, 0.08, 0.10)),
    ((-0.35, 0.26, FLOOR + 0.79), (0.05, 0.04, 0.04), (0.15, 0.15, 0.15)),
    ((0.35, -0.22, FLOOR + 1.00), (0.27, 0.02, 0.17), (0.08, 0.08, 0.10)),
    ((0.35, -0.26, FLOOR + 0.79), (0.05, 0.04, 0.04), (0.15, 0.15, 0.15)),
    ((0.55, 0.32, FLOOR + 0.92), (0.02, 0.18, 0.13), (0.10, 0.10, 0.12)),
    # keyboards, books, a box file
    ((-0.35, 0.40, FLOOR + 0.76), (0.22, 0.07, 0.01), (0.85, 0.85, 0.85)),
    ((0.35, -0.40, FLOOR + 0.76), (0.22, 0.07, 0.01), (0.20, 0.20, 0.20)),
    ((-0.58, -0.35, FLOOR + 0.79), (0.11, 0.08, 0.04), (0.75, 0.20, 0.15)),
    ((-0.58, -0.35, FLOOR + 0.86), (0.09, 0.07, 0.03), (0.15, 0.35, 0.70)),
    ((0.62, 0.10, FLOOR + 0.87), (0.05, 0.14, 0.12), (0.90, 0.75, 0.20)),
    # chairs tucked in: seats and backs
    ((-0.35, 0.78, FLOOR + 0.46), (0.20, 0.19, 0.04), (0.20, 0.25, 0.55)),
    ((-0.35, 0.96, FLOOR + 0.72), (0.20, 0.025, 0.22), (0.20, 0.25, 0.55)),
    ((0.35, -0.78, FLOOR + 0.46), (0.20, 0.19, 0.04), (0.55, 0.20, 0.20)),
    ((0.35, -0.96, FLOOR + 0.72), (0.20, 0.025, 0.22), (0.55, 0.20, 0.20)),
    # along the walls: a shelf with a row of files, cabinets, a sofa, a whiteboard
    ((2.22, 0.0, FLOOR + 0.95), (0.18, 0.90, 0.95), (0.55, 0.40, 0.28)),
    ((2.02, -0.30, FLOOR + 1.25), (0.03, 0.45, 0.14), (0.20, 0.55, 0.30)),
    ((-0.80, -2.15, FLOOR + 0.40), (0.90, 0.25, 0.40), (0.75, 0.75, 0.78)),
    ((1.10, -2.20, FLOOR + 0.60), (0.40, 0.20, 0.60), (0.40, 0.45, 0.55)),
    ((0.30, 2.05, FLOOR + 0.22), (0.90, 0.35, 0.22), (0.35, 0.30, 0.50)),
    ((0.30, 2.30, FLOOR + 0.60), (0.90, 0.10, 0.38), (0.35, 0.30, 0.50)),
    ((-2.38, 0.30, FLOOR + 1.30), (0.02, 0.90, 0.50), (0.96, 0.96, 0.96)),
    ((-2.05, -1.95, FLOOR + 0.35), (0.25, 0.25, 0.35), (0.60, 0.45, 0.30)),
)
# Spheres: (center, radius, color).
SPHERES = (
    ((-0.10, 0.42, FLOOR + 0.86), 0.10, (0.60, 0.40, 0.20)),  # a teddy's head
    ((0.68, 0.48, FLOOR + 1.00), 0.06, (0.95, 0.90, 0.60)),  # the lamp's shade
    ((-2.00, 2.00, FLOOR + 0.75), 0.35, (0.20, 0.55, 0.20)),  # the plant's leaves
    ((1.55, 1.80, FLOOR + 0.12), 0.12, (0.85, 0.30, 0.30)),  # a ball on the floor
)
# Upright cylinders: (center, radius, half height, color).
CYLINDERS = (
    ((0.10, -0.45, FLOOR + 0.79), 0.04, 0.05, (0.90, 0.90, 0.95)),  # a mug
    ((0.68, 0.48, FLOOR + 0.85), 0.015, 0.10, (0.30, 0.30, 0.30)),  # the lamp's stem
    ((-2.00, 2.00, FLOOR + 0.20), 0.18, 0.20, (0.55, 0.30, 0.20)),  # the plant's pot
    ((1.90, -1.50, FLOOR + 0.20), 0.15, 0.20, (0.35, 0.35, 0.35)),  # a bin
    ((-0.35, 0.78, FLOOR + 0.21), 0.03, 0.21, (0.25, 0.25, 0.25)),  # chair posts
    ((0.35, -0.78, FLOOR + 0.21), 0.03, 0.21, (0.25, 0.25, 0.25)),
)
LIGHT = (0.3, -0.4, -0.85)
NEAR_HIT = 1e-4


def _vec(x, dev):
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _primitives(dev):
    """Centers (P, 3) and colors (P, 3) of every primitive in the order
    `cast` numbers them: the room, the boxes, the spheres, the cylinders."""
    prims = [ROOM] + list(BOXES) + list(SPHERES) + list(CYLINDERS)
    centers = _vec([p[0] for p in prims], dev)
    colors = _vec([(0.0, 0.0, 0.0)] + [p[-1] for p in prims[1:]], dev)
    return centers, colors


# What `cast` notes of the nearest hit besides its primitive: a box face's
# axis (0-2), a cylinder's side or caps, a sphere.
CYL_SIDE, CYL_CAP, SPHERE_HIT = 3, 4, 5


def cast(o: torch.Tensor, d: torch.Tensor):
    """The nearest surface along unit rays `d` (B, H, W, 3) from the cameras
    at `o` (B, 3): (t, normal facing the ray, color), t = inf where none.
    Each primitive is intersected in closed form; only the nearest hit's
    primitive and kind are kept, and its normal and color are made once."""
    dev = o.device
    o4 = o[:, None, None, :]
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    # The room from inside: the face the ray leaves through.
    c, h = _vec(ROOM[0], dev), _vec(ROOM[1], dev)
    tfar = torch.maximum((c - h - o4) * inv, (c + h - o4) * inv)
    best_t, kind = torch.min(tfar, dim=-1)
    best_t = torch.where(best_t > NEAR_HIT, best_t, torch.full_like(best_t, math.inf))
    best_id = torch.zeros_like(kind)
    pid = 1

    def keep(t, k):
        nonlocal best_t, best_id, kind
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_id = best_id.masked_fill(take, pid)
        kind = torch.where(take, k, kind)

    for center, half, _ in BOXES:
        c, h = _vec(center, dev), _vec(half, dev)
        t1, t2 = (c - h - o4) * inv, (c + h - o4) * inv
        t0, axis = torch.max(torch.minimum(t1, t2), dim=-1)
        t1 = torch.amin(torch.maximum(t1, t2), dim=-1)
        keep(torch.where((t1 >= t0) & (t0 > NEAR_HIT), t0, math.inf), axis)
        pid += 1
    for center, r, _ in SPHERES:
        oc = o4 - _vec(center, dev)
        b = torch.sum(oc * d, dim=-1)
        disc = b * b - (torch.sum(oc * oc, dim=-1) - r * r)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        keep(torch.where((disc >= 0.0) & (t > NEAR_HIT), t, math.inf), SPHERE_HIT)
        pid += 1
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    for center, r, hh, _ in CYLINDERS:
        oc = o4 - _vec(center, dev)
        b = oc[..., 0] * d[..., 0] + oc[..., 1] * d[..., 1]
        disc = b * b - a * (oc[..., 0] ** 2 + oc[..., 1] ** 2 - r * r)
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(a, min=1e-12)
        z = oc[..., 2] + t * d[..., 2]
        keep(torch.where((disc >= 0.0) & (a > 1e-12) & (t > NEAR_HIT) & (z.abs() <= hh),
                         t, math.inf), CYL_SIDE)
        for cap in (-hh, hh):
            t = (cap - oc[..., 2]) * inv[..., 2]
            x = oc[..., 0] + t * d[..., 0]
            y = oc[..., 1] + t * d[..., 1]
            keep(torch.where((x * x + y * y <= r * r) & (t > NEAR_HIT), t, math.inf), CYL_CAP)
        pid += 1
    centers, colors = _primitives(dev)
    hit = torch.isfinite(best_t)
    p = o4 + torch.where(hit, best_t, torch.zeros_like(best_t))[..., None] * d
    rel = p - centers[best_id]
    axis = F.one_hot(kind.clamp(max=2), 3).to(d.dtype)
    n = torch.where((kind == SPHERE_HIT)[..., None], rel, axis)
    n = torch.where((kind == CYL_SIDE)[..., None], rel * _vec((1.0, 1.0, 0.0), dev), n)
    n = torch.where((kind == CYL_CAP)[..., None], _vec((0.0, 0.0, 1.0), dev).expand_as(n), n)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    n = -n * torch.sign(torch.sum(n * d, dim=-1, keepdim=True))  # face the ray
    face = 2 * kind.clamp(max=2) + (torch.gather(d, -1, kind.clamp(max=2)[..., None])[..., 0]
                                    > 0).long()
    col = torch.where((best_id == 0)[..., None], _vec(FACE_COLORS, dev)[face], colors[best_id])
    return best_t, n, col


def ray_directions(intr: dict, dev) -> torch.Tensor:
    """Unit-z camera rays (H, W, 3) of pinhole intrinsics."""
    vv, uu = torch.meshgrid(torch.arange(intr["height"], dtype=torch.float32, device=dev),
                            torch.arange(intr["width"], dtype=torch.float32, device=dev),
                            indexing="ij")
    x = (uu - intr["cx"]) / intr["fx"]
    y = (vv - intr["cy"]) / intr["fy"]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


@torch.no_grad()
def render(T_wc: torch.Tensor, intr: dict):
    """Ray-cast the office from poses (B, 4, 4): exact depth (B, H, W) in
    meters along the optical axis (0 = no hit) and diffusely shaded color
    (B, H, W, 3) in [0, 1]."""
    dev = T_wc.device
    rays = ray_directions(intr, dev)
    norm = torch.linalg.norm(rays, dim=-1)
    R = T_wc[:, :3, :3]
    # Rotation written out element by element: the frames do not depend on
    # the matrix-product precision of the card.
    dirs = sum(rays[None, ..., j, None] * R[:, None, None, :, j] for j in range(3))
    dirs = dirs / norm[None, ..., None]
    t, n, base = cast(T_wc[:, :3, 3], dirs)
    hit = torch.isfinite(t)
    depth = torch.where(hit, t / norm, torch.zeros_like(t))
    light = _vec(LIGHT, dev)
    light = light / torch.linalg.norm(light)
    shade = 0.55 + 0.45 * torch.clamp(-torch.sum(n * light, dim=-1), 0.0, 1.0)
    color = torch.where(hit[..., None], base * shade[..., None], torch.zeros_like(base))
    return depth, color


def loop_eye(theta: torch.Tensor, radius: float = 1.7, swing: float = 0.2):
    """Camera centre and the point it looks at, at loop parameters theta in
    [0, 4 pi): two laps round the desks whose distance from their centre
    swings by `swing`, with the height and the gaze wandering; every term
    has period 4 pi, so the loop closes."""
    r = radius + swing * torch.cos(0.5 * theta)
    eye = torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                       FLOOR + 1.10 + 0.12 * torch.sin(1.5 * theta)], dim=-1)
    look = torch.stack([0.35 * torch.cos(2.5 * theta + 1.0), 0.30 * torch.sin(1.5 * theta),
                        FLOOR + 0.80 + 0.15 * torch.cos(3.5 * theta)], dim=-1)
    return eye, look


def look_pose(eye: torch.Tensor, look: torch.Tensor) -> torch.Tensor:
    """Camera-to-world poses (N, 4, 4) at `eye` looking at `look`, image x
    to the right and image y down (world z up)."""
    fwd = look - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    up = torch.zeros_like(fwd)
    up[:, 2] = 1.0
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    T = torch.eye(4, dtype=fwd.dtype, device=fwd.device).repeat(fwd.shape[0], 1, 1)
    T[:, :3, :3] = torch.stack([right, down, fwd], dim=-1)
    T[:, :3, 3] = eye
    return T


def loop_poses(length_m: float, step_m: float, dev, samples: int = 1 << 16) -> torch.Tensor:
    """One loop of poses (L, 4, 4), a camera translation of `step_m` a frame,
    on `loop_eye` scaled so that the loop is `length_m` long.  Frame L would
    be frame 0 again."""
    theta = torch.linspace(0.0, 4.0 * math.pi, samples + 1, dtype=torch.float64)
    eye, _ = loop_eye(theta)
    s = torch.cat([torch.zeros(1, dtype=torch.float64),
                   torch.cumsum(torch.linalg.norm(eye[1:] - eye[:-1], dim=-1), 0)])
    # The loop's radius scaled until its length is the sequence's.
    radius = 1.7 * length_m / float(s[-1])
    eye, _ = loop_eye(theta, radius=radius)
    s = torch.cat([torch.zeros(1, dtype=torch.float64),
                   torch.cumsum(torch.linalg.norm(eye[1:] - eye[:-1], dim=-1), 0)])
    n = max(1, round(float(s[-1]) / step_m))
    targets = torch.arange(n, dtype=torch.float64) * (float(s[-1]) / n)
    idx = torch.clamp(torch.searchsorted(s, targets, right=True), 1, samples)
    frac = (targets - s[idx - 1]) / (s[idx] - s[idx - 1])
    th = theta[idx - 1] + frac * (theta[idx] - theta[idx - 1])
    eye, look = loop_eye(th, radius=radius)
    return look_pose(eye, look).float().to(dev)


def path_speed(poses: torch.Tensor, rate_hz: float) -> tuple[float, float]:
    """Mean translation (m/s) and rotation (deg/s) of a loop run at
    `rate_hz`, the wrap from its last frame to its first included."""
    nxt = torch.roll(poses, -1, 0)
    dt = torch.linalg.norm(nxt[:, :3, 3] - poses[:, :3, 3], dim=-1)
    rel = poses[:, :3, :3].transpose(1, 2) @ nxt[:, :3, :3]
    cos = torch.clamp((rel.diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0, -1.0, 1.0)
    return (float(dt.mean()) * rate_hz,
            math.degrees(float(torch.arccos(cos).mean())) * rate_hz)


def apply_sensor_noise(depth: torch.Tensor, normal: torch.Tensor, u_edge: torch.Tensor,
                       u_speckle: torch.Tensor, sigma_base: float = 0.0012,
                       sigma_z2: float = 0.0019, edge_dropout: float = 0.6,
                       speckle_dropout: float = 0.002) -> torch.Tensor:
    """Kinect-class corruption of depth (B, H, W) from given draws, as
    ``_apply_sensor_noise``: axial noise 0.0012 + 0.0019 (z - 0.4)^2 m
    (Khoshelham and Elberink), 1/5000 m quantization, dropout at 4 cm jumps
    and salt dropout."""
    valid = depth > 0.0
    z = torch.clamp(depth - 0.4, min=0.0)
    sigma = sigma_base + sigma_z2 * z * z
    noisy = torch.round((depth + sigma * normal) * 5000.0) * (1.0 / 5000.0)
    h, w = depth.shape[-2:]
    pad = F.pad(depth[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    jump = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            jump = torch.maximum(jump, torch.abs(nb - depth))
    keep = valid & ~((jump > 0.04) & (u_edge < edge_dropout)) & ~(u_speckle < speckle_dropout)
    return torch.where(keep, torch.clamp(noisy, min=0.0), torch.zeros_like(depth))


def render_loop(poses: torch.Tensor, intr: dict, seed: int, noise: bool = True,
                min_range_m: float = 0.0, max_range_m: float = math.inf, batch: int = 32):
    """The loop's frames as a recorded log holds them: depth (L, H, W) int16
    in 1/5000 m (0 = none) and color (L, H, W, 3) uint8, rendered on the
    poses' device in batches.  Surfaces outside [`min_range_m`,
    `max_range_m`] return no depth, as outside a sensor's operating range;
    the depth noise of every frame is drawn from one generator seeded with
    `seed` on that device."""
    gen = torch.Generator(device=poses.device)
    gen.manual_seed(seed % (1 << 63))
    depths, colors = [], []
    for i in range(0, poses.shape[0], batch):
        d, c = render(poses[i:i + batch], intr)
        d = torch.where((d >= min_range_m) & (d <= max_range_m), d, torch.zeros_like(d))
        if noise:
            d = apply_sensor_noise(d, torch.randn(d.shape, generator=gen, device=d.device),
                                   torch.rand(d.shape, generator=gen, device=d.device),
                                   torch.rand(d.shape, generator=gen, device=d.device))
        depths.append(torch.round(d * DEPTH_SCALE).to(torch.int16))
        colors.append(torch.round(c * 255.0).to(torch.uint8))
    return torch.cat(depths), torch.cat(colors)


def frame(depth: torch.Tensor, color: torch.Tensor, c: int):
    """Frame c of a loop as the program takes it: depth f32 (H, W) in meters
    and color f32 (H, W, 3) in [0, 1]."""
    return (depth[c].float() * (1.0 / DEPTH_SCALE), color[c].float() * (1.0 / 255.0))
