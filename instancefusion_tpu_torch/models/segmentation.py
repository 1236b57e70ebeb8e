"""Instance-segmentation head (port of ``models/segmentation.py``).

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

Training: ``init_params`` (flax's initializers from a ``torch.Generator``),
``targets_from_instances`` (Panoptic-DeepLab targets from instance ids),
``loss_fn``, ``train_step`` (one ``torch.optim`` update), ``cosine_decay``
(optax's schedule) and ``save_pretrained``, which writes the reference's
checkpoint format so that either package loads it.  The trainer is
``models/train_seghead.py``.
"""

from __future__ import annotations

import contextlib
import functools
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


@contextlib.contextmanager
def _without_cudnn():
    """A context in which convolutions on the card run as im2col and
    cuBLAS products instead of through cuDNN.  cuDNN picks a convolution's
    algorithm at a shape's first call by the memory then free, so two
    processes (ranks sharing a card, a second run) can round the same
    convolution differently, and some of its backward algorithms add with
    atomics; cuBLAS gives the same bits for the same shapes in every
    process.  The head's forward and ``train_step``'s backward run in it."""
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = was


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """(n_out, n_in) weights of ``F.interpolate``'s bilinear resize along one
    axis (``align_corners=False``: source (i + 0.5) n_in / n_out - 0.5,
    clamped at 0)."""
    src = np.maximum((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    a = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    np.add.at(a, (rows, i0), 1.0 - frac)
    np.add.at(a, (rows, np.minimum(i0 + 1, n_in - 1)), frac)
    return torch.as_tensor(a, dtype=dtype, device=device)


class _Upsample(torch.autograd.Function):
    """``F.interpolate`` bilinear (``align_corners=False``) to `size`, whose
    backward is the two products of the resize's matrices: the library's
    backward adds with atomics on CUDA, in no fixed order."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_size = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (ih, iw), (oh, ow) = ctx.in_size, g.shape[-2:]
        ah = _bilinear_matrix(ih, oh, g.dtype, g.device)
        aw = _bilinear_matrix(iw, ow, g.dtype, g.device)
        return ah.t() @ g @ aw, None


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

        def up(x, skip, block):
            x = _Upsample.apply(x, tuple(skip.shape[-2:]))
            return block(torch.cat([x, skip], dim=1))

        with _without_cudnn():
            e1 = self.blocks[0](x)
            e2 = self.blocks[1](e1)
            e3 = self.blocks[2](e2)
            e4 = self.blocks[3](e3)
            m = self.blocks[4](e4)
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


def save_pretrained(path, model: PanopticHead) -> None:
    """The head's parameters as the reference's ``save_pretrained`` writes
    them: flax key paths (``jax.tree_util.keystr``), HWIO kernels, float16,
    ``np.savez_compressed``; the reference's ``load_pretrained`` reads it."""
    from instancefusion_tpu_torch.convert import seghead_to_flax

    arrays = seghead_to_flax(model.state_dict())
    np.savez_compressed(path, **{k: v.astype(np.float16) for k, v in arrays.items()})


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that its variance is 1 / fan_in (the truncation's std is 0.8796...).
_TRUNC_STD = 0.87962566103423978


def init_params(height: int, width_px: int, num_classes: int, width: int = 32,
                generator: torch.Generator | None = None, device=None) -> PanopticHead:
    """A fresh head with flax's initializers: conv kernels ``lecun_normal``
    (truncated normal, stddev sqrt(1 / fan_in) / 0.8796, cut at +-2 stddev),
    conv biases 0, GroupNorm scale 1 and bias 0.  Draws come from
    `generator` (a CPU ``torch.Generator``) layer by layer; the head is
    then moved to `device` (``cuda`` unless asked otherwise).  `height` and
    `width_px` are the reference's dummy input size: the head's parameters
    do not depend on them."""
    del height, width_px
    dev = _device.resolve(device)
    model = PanopticHead(num_classes, width)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.GroupNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
    return model.to(dev)


def targets_from_instances(instance_img: torch.Tensor, class_of_instance: torch.Tensor,
                           sigma: float = 4.0):
    """Panoptic-DeepLab training targets from instance-id ground truth.

    instance_img i32[H, W] (-1 none), class_of_instance i32[K] (0 is
    background).  Returns (sem i64[H, W], center f32[H, W], offset
    f32[H, W, 2]): the class of each pixel, a Gaussian bump of `sigma` px at
    each instance's centroid, and each pixel's vector to its instance's
    centroid in units of the IMAGE WIDTH (so one head serves several input
    sizes).  Centroids are summed in float64."""
    h, w = instance_img.shape
    k = class_of_instance.shape[0]
    dev = instance_img.device
    inst = instance_img.long()
    valid = inst >= 0
    ids = inst.clamp(0, k - 1)
    sem = torch.where(valid, class_of_instance.long()[ids], torch.zeros_like(ids))

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    onehot = F.one_hot(torch.where(valid, inst, torch.full_like(inst, k)), k + 1)[..., :k]
    oh64 = onehot.double()
    count = oh64.sum((0, 1))
    denom = count.clamp(min=1.0)
    cy = ((oh64 * yy.double()[..., None]).sum((0, 1)) / denom).float()
    cx = ((oh64 * xx.double()[..., None]).sum((0, 1)) / denom).float()

    d2 = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2
    bump = torch.exp(-d2 / (2.0 * sigma * sigma))
    bump = torch.where(count[None, None, :] > 0, bump, torch.zeros_like(bump))
    center = bump.amax(-1) if k > 0 else torch.zeros((h, w), device=dev)

    ohf = onehot.float()
    off_y = ((ohf * cy).sum(-1) - yy) / w
    off_x = ((ohf * cx).sum(-1) - xx) / w
    offset = torch.where(valid[..., None], torch.stack([off_y, off_x], -1),
                         torch.zeros((h, w, 2), device=dev))
    return sem, center, offset


def loss_fn(model: PanopticHead, rgb, sem_t, center_t, offset_t,
            center_weight: float = 10.0, offset_weight: float = 30.0):
    """Semantic cross-entropy + center MSE (on the sigmoid) + offset L1 over
    the foreground.  Returns (total, {"ce", "center", "offset"})."""
    sem, center, offset = model(rgb)
    ce = -torch.gather(F.log_softmax(sem, dim=-1), -1, sem_t.long()[..., None]).mean()
    cm = ((torch.sigmoid(center) - center_t) ** 2).mean()
    fg = (sem_t > 0).float()[..., None]
    ol = (torch.abs(offset - offset_t) * fg).sum() / fg.sum().clamp(min=1.0)
    total = ce + center_weight * cm + offset_weight * ol
    return total, {"ce": ce, "center": cm, "offset": ol}


def train_step(model: PanopticHead, optimizer: torch.optim.Optimizer, rgb, targets):
    """One update of `optimizer` on one frame (or a batch) and its targets
    (sem, center, offset).  Returns the loss and its parts, detached."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    total, aux = loss_fn(model, rgb, *targets)
    with _without_cudnn():
        total.backward()
    optimizer.step()
    return total.detach(), {k: v.detach() for k, v in aux.items()}


def cosine_decay(lr: float, steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` as a function of the
    update count: lr ((1 - alpha) (1 + cos(pi min(t, steps) / steps)) / 2
    + alpha).  As a ``LambdaLR`` factor it gives these rates exactly on an
    optimizer whose ``lr`` is 1."""
    def rate(t: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
        return lr * ((1.0 - alpha) * decay + alpha)

    return rate
