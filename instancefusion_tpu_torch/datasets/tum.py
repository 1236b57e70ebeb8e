"""TUM RGB-D sequence reader (port of ``datasets/tum.py``).

Reads the standard extracted TUM RGB-D layout::

    sequence_dir/
      rgb.txt          # "timestamp filename"
      depth.txt        # "timestamp filename" (16-bit PNG, depth = px / 5000)
      groundtruth.txt  # "timestamp tx ty tz qx qy qz qw" (optional)
      rgb/*.png  depth/*.png

Depth and color frames are associated by the TUM ``associate.py``
protocol (greedy nearest timestamps within a window), ground truth by the
same protocol against the depth timestamps.  Frames come out as tensors on
the sequence's device (``cuda`` unless asked otherwise): decoded on the
host into pinned buffers and copied without blocking.

Two decoders: the native prefetching loader (``datasets/native_loader.py``)
when it builds here and agrees with this reader's association, else the
port's own PNG decoder (``datasets/png.py``).  The choice is made when
``frames()`` is called, before any frame is produced, and kept in
``seq.decoder``; once native decoding has begun it finishes or raises.
Each native frame pairs with the ground truth of the index the loader
returned, so a frame it skips shifts nothing after it.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.datasets import native_loader, png

DEPTH_SCALE = 5000.0  # TUM: 16-bit PNG value / 5000 = meters


class TumFrame(NamedTuple):
    depth: torch.Tensor  # f32[H,W] meters
    color: torch.Tensor  # f32[H,W,3] in [0,1]
    timestamp: float
    T_wc: torch.Tensor | None  # f32[4,4] ground truth if available


def _read_list(path: str) -> list[tuple[float, list[str]]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: list[tuple[float, list[str]]],
    b: list[tuple[float, list[str]]],
    max_dt: float = 0.02,
) -> list[tuple[int, int]]:
    """TUM associate.py: greedy nearest-timestamp matching within max_dt."""
    pairs = sorted(
        (abs(ta - tb), i, j)
        for i, (ta, _) in enumerate(a)
        for j, (tb, _) in enumerate(b)
        if abs(ta - tb) < max_dt
    )
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out


def quat_to_mat(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ],
        dtype=np.float32,
    )


def rgb8(image: np.ndarray, name: str) -> np.ndarray:
    """An 8-bit gray, gray+alpha, RGB or RGBA image as u8[H,W,3], as PIL's
    ``convert("RGB")`` makes it: gray replicated, alpha dropped."""
    if image.dtype != np.uint8:
        raise ValueError(f"{name}: color must be 8-bit, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] < 3:
        image = np.repeat(image[..., :1], 3, axis=-1)
    return image[..., :3]


def scaled(arr: np.ndarray, scale: float, device: torch.device) -> torch.Tensor:
    """``arr.astype(float32) / scale`` (bit for bit) as a tensor on `device`:
    computed straight into a host buffer, pinned on a CUDA device, and
    copied without blocking."""
    host = torch.empty(arr.shape, dtype=torch.float32, pin_memory=device.type == "cuda")
    np.divide(arr, np.float32(scale), out=host.numpy(), dtype=np.float32)
    return host.to(device, non_blocking=True)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`, through pinned memory on a CUDA
    device."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


class TumSequence:
    def __init__(self, root: str, intrinsics=None, max_dt: float = 0.02, device=None):
        self.root = root
        self.intrinsics = intrinsics
        self.device = _device.resolve(device)
        self.decoder: str | None = None  # "native" or "png", set by frames()
        depth_list = _read_list(os.path.join(root, "depth.txt"))
        rgb_list = _read_list(os.path.join(root, "rgb.txt"))
        pairs = associate(depth_list, rgb_list, max_dt)
        self.items = [
            (depth_list[i][0], depth_list[i][1][0], rgb_list[j][1][0])
            for i, j in pairs
        ]
        gt_path = os.path.join(root, "groundtruth.txt")
        self._gt = None
        if os.path.exists(gt_path):
            gt_ts = _read_list(gt_path)
            # Associate gt to depth timestamps.
            gpairs = associate([(t, [d, r]) for t, d, r in self.items], gt_ts, max_dt=0.05)
            gt_map = {}
            for i, j in gpairs:
                tx, ty, tz, qx, qy, qz, qw = map(float, gt_ts[j][1][:7])
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = quat_to_mat(qx, qy, qz, qw)
                T[:3, 3] = (tx, ty, tz)
                gt_map[i] = T
            self._gt = gt_map

    def __len__(self) -> int:
        return len(self.items)

    def decode(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Item `idx`'s PNGs by the port's decoder: (depth u16[H,W] in
        1/5000 m, color u8[H,W,3])."""
        _, dpath, rpath = self.items[idx]
        return (png.read(os.path.join(self.root, dpath)),
                rgb8(png.read(os.path.join(self.root, rpath)), rpath))

    def _frame(self, depth: np.ndarray, scale: float, rgb: np.ndarray, idx: int) -> TumFrame:
        T = self._gt.get(idx) if self._gt else None
        return TumFrame(
            depth=scaled(depth, scale, self.device),
            color=scaled(rgb, 255.0, self.device),
            timestamp=self.items[idx][0],
            T_wc=None if T is None else upload(T, self.device),
        )

    def frames(self, limit: int | None = None, prefer_native: bool = True) -> Iterator[TumFrame]:
        """Iterate the first `limit` items (all by default) as ``TumFrame``s.

        Chooses the decoder now and records it in ``self.decoder``: the
        native loader when `prefer_native`, it is available, and its
        association has as many frames as this reader's; else the PNG
        decoder.
        """
        n = len(self.items) if limit is None else min(limit, len(self.items))
        native = None
        if prefer_native and n and native_loader.available():
            w, h = png.read_header(os.path.join(self.root, self.items[0][1]))
            native = native_loader.NativeSequence(self.root, w, h)
            if len(native) != len(self.items):
                native.close()
                native = None
        self.decoder = "png" if native is None else "native"
        return self._png_frames(n) if native is None else self._native_frames(native, n)

    def _png_frames(self, n: int) -> Iterator[TumFrame]:
        for i in range(n):
            depth, rgb = self.decode(i)
            yield self._frame(depth, DEPTH_SCALE, rgb, i)

    def _native_frames(self, native: native_loader.NativeSequence, n: int) -> Iterator[TumFrame]:
        with native:
            for f in native:
                if f.index >= n:
                    return
                yield self._frame(f.depth, 1.0, f.rgb, f.index)  # depth in meters

    def gt_poses(self, limit: int | None = None) -> np.ndarray | None:
        if not self._gt:
            return None
        n = len(self.items) if limit is None else min(limit, len(self.items))
        if any(i not in self._gt for i in range(n)):
            return None
        return np.stack([self._gt[i] for i in range(n)])


def save_trajectory_tum(path: str, timestamps, poses) -> None:
    """Write poses in TUM `timestamp tx ty tz qx qy qz qw` format for the
    standard evaluation tooling."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            T = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T)
            R = T[:3, :3]
            t = T[:3, 3]
            # Rotation matrix -> quaternion (w last), Shepperd's method.
            tr = np.trace(R)
            if tr > 0:
                s = np.sqrt(tr + 1.0) * 2
                qw = 0.25 * s
                qx = (R[2, 1] - R[1, 2]) / s
                qy = (R[0, 2] - R[2, 0]) / s
                qz = (R[1, 0] - R[0, 1]) / s
            else:
                i = int(np.argmax(np.diag(R)))
                j, k = (i + 1) % 3, (i + 2) % 3
                s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
                q = [0.0, 0.0, 0.0, 0.0]
                q[i] = 0.25 * s
                q[3] = (R[k, j] - R[j, k]) / s
                q[j] = (R[j, i] + R[i, j]) / s
                q[k] = (R[k, i] + R[i, k]) / s
                qx, qy, qz, qw = q[0], q[1], q[2], q[3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )
