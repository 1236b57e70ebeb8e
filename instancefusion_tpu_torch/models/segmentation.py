"""Instance-segmentation head (port of ``models/segmentation.py``, inference).

A Panoptic-DeepLab-style encoder/decoder (strided 3x3 convolutions,
GroupNorm, GELU, skip connections) predicts per-pixel semantic logits, an
instance-center heatmap and center offsets; ``extract_instances`` groups
them into K instance masks with static shapes: max-pool NMS, the k best
peaks as centers, one (HW, K) nearest-center assignment, a class histogram per
instance and a class-consistency gate.

The public functions keep the reference's layouts: images are (H, W, 3)
(or (B, H, W, 3)) and the head returns sem (H, W, C), center (H, W) and
offset (H, W, 2).  The packaged weights are the reference's flax
checkpoint, carried across by ``convert.seghead_from_flax``.  Three details
keep the two packages equal: flax's ``SAME`` padding (asymmetric for
stride 2 on even sizes), its GroupNorm epsilon (1e-6) and its tanh GELU.
Training is a later slice.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instancefusion_tpu_torch import device as _device


class Segmentation(NamedTuple):
    """Per-frame instance segmentation in network/table-agnostic form."""

    mask_id: torch.Tensor  # i32[H,W] per-pixel instance index in [0,K), -1 = none
    classes: torch.Tensor  # i32[K] semantic class per instance (0 = background)
    scores: torch.Tensor  # f32[K] center confidence
    valid: torch.Tensor  # bool[K] instance slot populated


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA ``SAME`` padding (low, high) of one spatial axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _group_norm(x, norm: nn.GroupNorm):
    """``norm`` applied to x (N, C, H, W) with the variance taken about the
    mean (``var_mean``), not as E[x^2] - E[x]^2: some groups of the trained
    head are nearly constant over the image, and the one-pass form of
    ``F.group_norm`` on the CPU then loses their deviation (2e-3 on the
    logits at 640x480)."""
    n, c = x.shape[:2]
    xg = x.reshape(n, norm.num_groups, -1)
    var, mean = torch.var_mean(xg, dim=-1, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    return y * norm.weight[:, None, None] + norm.bias[:, None, None]


class _ConvBlock(nn.Module):
    """3x3 conv (flax SAME padding) -> GroupNorm(min(8, ch), eps 1e-6) -> GELU."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, ch, 3, stride=stride, padding=0)
        self.norm = nn.GroupNorm(min(8, ch), ch, eps=1e-6)

    def forward(self, x):
        (t, b), (l, r) = (_same_pad(s, 3, self.stride) for s in x.shape[-2:])
        x = self.conv(F.pad(x, (l, r, t, b)))
        return F.gelu(_group_norm(x, self.norm), approximate="tanh")


class PanopticHead(nn.Module):
    """Encoder/decoder with semantic + center + offset outputs."""

    def __init__(self, num_classes: int = 41, width: int = 32):
        super().__init__()
        self.num_classes, self.width = num_classes, width
        w = width
        self.blocks = nn.ModuleList([
            _ConvBlock(3, w),  # e1, H
            _ConvBlock(w, 2 * w, 2),  # e2, H/2
            _ConvBlock(2 * w, 4 * w, 2),  # e3, H/4
            _ConvBlock(4 * w, 8 * w, 2),  # e4, H/8
            _ConvBlock(8 * w, 8 * w),  # m
            _ConvBlock(8 * w + 4 * w, 4 * w),  # d3
            _ConvBlock(4 * w + 2 * w, 2 * w),  # d2
            _ConvBlock(2 * w + w, w),  # d1
        ])
        self.sem = nn.Conv2d(w, num_classes, 1)
        self.center = nn.Conv2d(w, 1, 1)
        self.offset = nn.Conv2d(w, 2, 1)

    def forward(self, rgb):  # f32[H,W,3] in [0,1] (or [B,H,W,3])
        batched = rgb.dim() == 4
        x = (rgb if batched else rgb[None]).permute(0, 3, 1, 2)
        e1 = self.blocks[0](x)
        e2 = self.blocks[1](e1)
        e3 = self.blocks[2](e2)
        e4 = self.blocks[3](e3)
        m = self.blocks[4](e4)

        def up(x, skip, block):
            x = F.interpolate(x, size=skip.shape[-2:], mode="bilinear",
                              align_corners=False)
            return block(torch.cat([x, skip], dim=1))

        d3 = up(m, e3, self.blocks[5])
        d2 = up(d3, e2, self.blocks[6])
        d1 = up(d2, e1, self.blocks[7])
        sem = self.sem(d1).permute(0, 2, 3, 1)
        center = self.center(d1)[:, 0]
        offset = self.offset(d1).permute(0, 2, 3, 1)
        if not batched:
            sem, center, offset = sem[0], center[0], offset[0]
        return sem, center, offset


def extract_instances(
    sem_logits: torch.Tensor,  # f32[H,W,C]
    center_heat: torch.Tensor,  # f32[H,W] (pre-sigmoid)
    offsets: torch.Tensor,  # f32[H,W,2] (dy, dx) to the center, in image widths
    max_instances: int,
    center_thresh: float = 0.0,
    nms_window: int = 7,
    max_assign_dist: float = 0.45,
) -> Segmentation:
    """Static-shaped grouping of dense predictions into K instance masks.

    Peaks of the heatmap (equal to their window maximum, above the
    threshold) are the centers, best first; every foreground pixel goes to
    the center nearest its predicted center, unless that is farther than
    `max_assign_dist` image widths or the center's majority class differs
    from the pixel's own.  Background pixels (class 0) get mask_id -1.
    """
    h, w = center_heat.shape
    k = max_instances
    dev = center_heat.device
    pooled = F.max_pool2d(center_heat[None, None], nms_window, stride=1,
                          padding=nms_window // 2)[0, 0]
    is_peak = (center_heat >= pooled) & (center_heat > center_thresh)
    peak_score = torch.where(is_peak, center_heat,
                             torch.full_like(center_heat, -math.inf)).reshape(-1)
    # Best k peaks, ties by the lower pixel index as in lax.top_k: a stable
    # sort, because the heatmap can hold plateaus of equal peak scores and
    # topk orders ties differently on the CPU and on the card.
    scores, peak_idx = torch.sort(peak_score, descending=True, stable=True)
    scores, peak_idx = scores[:k], peak_idx[:k]
    valid = torch.isfinite(scores)
    cy = (peak_idx // w).float()
    cx = (peak_idx % w).float()

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    py = (yy + offsets[..., 0] * w).reshape(-1)
    px = (xx + offsets[..., 1] * w).reshape(-1)
    d2 = (py[:, None] - cy[None, :]) ** 2 + (px[:, None] - cx[None, :]) ** 2
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, math.inf))
    dmin, assign = torch.min(d2, dim=-1)
    near_ok = dmin <= (max_assign_dist * w) ** 2

    sem_cls = torch.argmax(sem_logits, dim=-1)
    fg = (sem_cls > 0).reshape(-1) & valid.any() & near_ok

    # Class histogram per instance: one scatter-add of pixel counts.
    c = sem_logits.shape[-1]
    idx = torch.where(fg, assign, torch.full_like(assign, k)) * c + sem_cls.reshape(-1)
    hist = torch.zeros((k + 1) * c, dtype=torch.float32, device=dev)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    hist = hist.reshape(k + 1, c)[:k, 1:]
    classes = torch.argmax(hist, dim=-1) + 1
    valid = valid & (hist.sum(-1) > 0)
    classes = torch.where(valid, classes, torch.zeros_like(classes))
    keep = fg & (classes[assign] == sem_cls.reshape(-1))
    mask_id = torch.where(keep, assign, torch.full_like(assign, -1)).reshape(h, w)
    return Segmentation(
        mask_id=mask_id.to(torch.int32),
        classes=classes.to(torch.int32),
        scores=torch.where(valid, scores, torch.zeros_like(scores)),
        valid=valid,
    )


@torch.no_grad()
def segment(model: PanopticHead, rgb: torch.Tensor, max_instances: int,
            center_thresh: float = -2.0) -> Segmentation:
    """Head forward + grouping for one frame f32[H, W, 3] on the model's device.

    `center_thresh` is on the pre-sigmoid heatmap (-2.0 is p ~ 0.12):
    a low threshold splits an object now and then, which the IoU
    association can merge; a high one merges distinct objects for good.
    """
    sem, center, offset = model(rgb)
    return extract_instances(sem, center, offset, max_instances,
                             center_thresh=center_thresh)


# The packaged checkpoint: the reference's head trained on the synthetic
# scenes, a byte-identical copy of its npz (flax key paths, fp16).
PRETRAINED_SYNTHETIC = {
    "file": "weights/seghead_synthetic_w16.npz",
    "num_classes": 5,
    "width": 16,
}


def load_pretrained(path: str | None = None, device=None) -> PanopticHead:
    """The head with a checkpoint saved by the reference's ``save_pretrained``
    (default: the packaged synthetic-scene weights), in eval mode on
    ``device`` (``cuda`` unless asked otherwise)."""
    from instancefusion_tpu_torch.convert import seghead_from_flax

    dev = _device.resolve(device)
    meta = PRETRAINED_SYNTHETIC
    path = Path(path) if path is not None else Path(__file__).parent / meta["file"]
    with np.load(path) as data:
        arrays = {key: data[key] for key in data.files}
    model = PanopticHead(meta["num_classes"], meta["width"])
    model.load_state_dict(seghead_from_flax(arrays))
    return model.to(dev).eval()
