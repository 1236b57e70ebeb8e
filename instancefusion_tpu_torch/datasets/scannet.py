"""ScanNet (extracted) sequence reader (port of ``datasets/scannet.py``).

Reads the layout the official SensReader writes::

    scene_dir/
      color/<i>.jpg          # 8-bit RGB
      depth/<i>.png          # 16-bit depth, millimeters
      pose/<i>.txt           # 4x4 camera-to-world (row major), may be inf
      intrinsic/intrinsic_depth.txt  # 4x4 K (fx 0 cx / 0 fy cy)
      (optional) instance/<i>.png    # 16-bit instance ids (for eval)

Frames are ordered by index and come out as tensors on the sequence's
device (``cuda`` unless asked otherwise), like ``datasets/tum.py``'s.
Depth and instance PNGs go through the port's decoder (``datasets/png.py``);
JPEG color goes through PIL, which the port does not need elsewhere: with
no PIL a JPEG frame raises ``ImportError`` naming its file.  Color is
resampled to the depth's size by nearest index; invalid poses (inf or nan,
the capture's tracking failures) come out as None; timestamps are the frame
index at 30 Hz.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.datasets import png
from instancefusion_tpu_torch.datasets.tum import rgb8, scaled, upload
from instancefusion_tpu_torch.geometry.camera import Intrinsics

DEPTH_SCALE = 1000.0  # ScanNet: 16-bit PNG value / 1000 = meters


class ScanNetFrame(NamedTuple):
    depth: torch.Tensor  # f32[H,W] meters
    color: torch.Tensor  # f32[H,W,3] in [0,1]
    timestamp: float  # frame index / 30 Hz
    T_wc: torch.Tensor | None  # f32[4,4] capture pose if finite
    instance: torch.Tensor | None  # i32[H,W] instance ids if exported


def _first_depth(scene_dir: str) -> str:
    ddir = os.path.join(scene_dir, "depth")
    names = [f for f in os.listdir(ddir) if f.endswith(".png")]
    return os.path.join(ddir, min(names, key=lambda s: int(os.path.splitext(s)[0])))


def read_intrinsics(scene_dir: str) -> Intrinsics | None:
    path = os.path.join(scene_dir, "intrinsic", "intrinsic_depth.txt")
    if not os.path.exists(path):
        return None
    k = np.loadtxt(path)
    w, h = png.read_header(_first_depth(scene_dir))
    return Intrinsics(
        fx=float(k[0, 0]), fy=float(k[1, 1]),
        cx=float(k[0, 2]), cy=float(k[1, 2]),
        width=w, height=h,
    )


def _read_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding {path} needs PIL (JPEG color), which is not "
                          "installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _pose(path: str) -> np.ndarray | None:
    if not os.path.exists(path):
        return None
    T = np.loadtxt(path).astype(np.float32)
    return T if np.isfinite(T).all() else None


class ScanNetSequence:
    def __init__(self, scene_dir: str, intrinsics: Intrinsics | None = None, device=None):
        self.root = scene_dir
        self.intrinsics = intrinsics or read_intrinsics(scene_dir)
        self.device = _device.resolve(device)
        ddir = os.path.join(scene_dir, "depth")
        self.indices = sorted(
            int(os.path.splitext(f)[0]) for f in os.listdir(ddir) if f.endswith(".png")
        )
        self.has_instances = os.path.isdir(os.path.join(scene_dir, "instance"))

    def __len__(self) -> int:
        return len(self.indices)

    def decode(self, i: int):
        """Frame `i` on the host: (depth u16[H,W] in mm, color u8[H,W,3] at
        the depth's size, pose or None, instance ids i32[H,W] or None)."""
        idx = self.indices[i]
        d = png.read(os.path.join(self.root, "depth", f"{idx}.png"))
        cpath = os.path.join(self.root, "color", f"{idx}.jpg")
        if os.path.exists(cpath):
            c = rgb8(_read_jpeg(cpath), cpath)
        else:
            cpath = os.path.join(self.root, "color", f"{idx}.png")
            c = rgb8(png.read(cpath), cpath)
        if c.shape[:2] != d.shape:
            ch, cw = c.shape[:2]
            dh, dw = d.shape
            ys = (np.arange(dh) * ch // dh).astype(int)
            xs = (np.arange(dw) * cw // dw).astype(int)
            c = c[ys][:, xs]
        inst = None
        ipath = os.path.join(self.root, "instance", f"{idx}.png")
        if self.has_instances and os.path.exists(ipath):
            inst = png.read(ipath).astype(np.int32)
        return d, c, _pose(os.path.join(self.root, "pose", f"{idx}.txt")), inst

    def _load(self, i: int) -> ScanNetFrame:
        d, c, T, inst = self.decode(i)
        return ScanNetFrame(
            depth=scaled(d, DEPTH_SCALE, self.device), color=scaled(c, 255.0, self.device),
            timestamp=self.indices[i] / 30.0,
            T_wc=None if T is None else upload(T, self.device),
            instance=None if inst is None else upload(inst, self.device),
        )

    def frames(self, limit: int | None = None) -> Iterator[ScanNetFrame]:
        n = len(self.indices) if limit is None else min(limit, len(self.indices))
        for i in range(n):
            yield self._load(i)

    def gt_poses(self, limit: int | None = None) -> np.ndarray | None:
        """The capture poses (N, 4, 4), or None if any is missing or
        invalid; reads the pose files only."""
        n = len(self.indices) if limit is None else min(limit, len(self.indices))
        poses = []
        for i in range(n):
            T = _pose(os.path.join(self.root, "pose", f"{self.indices[i]}.txt"))
            if T is None:
                return None
            poses.append(T)
        return np.stack(poses)
