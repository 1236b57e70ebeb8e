"""Data- and tensor-parallel segmentation over a shard group (port of
``models/parallel.py``).

The reference lays the head out over a device mesh and lets GSPMD insert
the collectives.  Here every rank of a ``parallel/mesh.ShardGroup`` runs
the same program and the collectives are explicit:

- **DP** (``dp_segment_fn``): the frames of a batch split over the ranks;
  each rank segments its own and the four fields are all-gathered, so
  every rank holds the whole batch's result.
- **TP** (``tp_segment_fn``): each rank keeps the output-channel slice of
  every conv that splits (``tp_param_shardings``, the reference's rule),
  computes those channels, and all-gathers them along the channel axis
  before the GroupNorm; the rest of the head runs replicated, so every
  rank holds the same result.  At the packaged head's width (16) TP buys
  nothing; it is the layout a wider backbone would use.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from instancefusion_tpu_torch.models import segmentation as seg


def dp_segment_fn(group, max_instances: int, center_thresh: float = -2.0):
    """Batched segmentation with the batch split over the ranks.

    Returns ``fn(model, rgb f32[B, H, W, 3]) -> Segmentation`` with a leading
    batch axis on every field, on every rank.  B must be divisible by the
    group's size; rank r segments frames [r B/S, (r+1) B/S), one at a time,
    as ``segmentation.segment`` does.
    """
    def fn(model: seg.PanopticHead, rgb: torch.Tensor) -> seg.Segmentation:
        b, s = rgb.shape[0], group.size
        if b % s:
            raise ValueError(f"a batch of {b} frames does not split over {s} ranks: "
                             "B must be divisible by the group's size")
        per = b // s
        mine = [seg.segment(model, x, max_instances, center_thresh)
                for x in rgb[group.rank * per:(group.rank + 1) * per]]
        local = [torch.stack(field) for field in zip(*mine)]
        return seg.Segmentation(*(group.all_gather(x).reshape((b,) + x.shape[1:])
                                  for x in local))

    return fn


def tp_param_shardings(model: seg.PanopticHead, group) -> dict[str, int | None]:
    """Which parameters split over the ranks: {name: 0 (split on the output
    channels) or None (replicated)}.  A conv weight (Cout, Cin, kh, kw)
    splits when Cout is a multiple of the group's size and at least it;
    everything else (biases, norm scales, the narrow output convs)
    replicates."""
    n = group.size
    return {name: 0 if p.dim() == 4 and p.shape[0] % n == 0 and p.shape[0] >= n else None
            for name, p in model.named_parameters()}


class ColumnParallelConv(nn.Module):
    """This rank's output-channel slice of a conv (weight and bias); its
    forward computes the slice and all-gathers the channels of every rank,
    in rank order."""

    def __init__(self, conv: nn.Conv2d, group):
        super().__init__()
        c = conv.out_channels // group.size
        rows = slice(group.rank * c, (group.rank + 1) * c)
        self.weight = nn.Parameter(conv.weight.detach()[rows].clone(), requires_grad=False)
        self.bias = nn.Parameter(conv.bias.detach()[rows].clone(), requires_grad=False)
        self.stride, self.padding = conv.stride, conv.padding
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        parts = self.group.all_gather(y)  # (S, N, C/S, H, W)
        return parts.transpose(0, 1).reshape(y.shape[0], -1, *y.shape[2:])


def tp_segment_fn(group, max_instances: int, center_thresh: float = -2.0):
    """Single-frame segmentation with tensor-parallel parameters.

    Returns (shard_params, fn): ``head = shard_params(model)`` once, a copy
    of the head whose split convs (``tp_param_shardings``) hold only this
    rank's channels; then ``fn(head, rgb f32[H, W, 3])`` runs the forward
    with the channel all-gathers and returns the same ``Segmentation`` on
    every rank.
    """
    def shard_params(model: seg.PanopticHead) -> seg.PanopticHead:
        split = tp_param_shardings(model, group)
        head = copy.deepcopy(model)
        for name, module in list(head.named_modules()):
            if isinstance(module, nn.Conv2d) and split[f"{name}.weight"] == 0:
                parent, _, leaf = name.rpartition(".")
                setattr(head.get_submodule(parent) if parent else head, leaf,
                        ColumnParallelConv(module, group))
        return head

    def fn(head: seg.PanopticHead, rgb: torch.Tensor) -> seg.Segmentation:
        return seg.segment(head, rgb, max_instances, center_thresh)

    return shard_params, fn
