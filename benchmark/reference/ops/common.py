"""Small shared op helpers."""

from __future__ import annotations

import torch


def decimate(arr: torch.Tensor, s: int) -> torch.Tensor:
    """`arr[::s, ::s]` over the two leading axes, cropped to full windows.

    Trailing rows/cols that do not fill a whole stride window are dropped
    (floor-division shapes), as in the reference.  The reference runs this
    as one-hot matmuls on the TPU; a strided view is the plain form.
    """
    if s == 1:
        return arr
    hs, ws = arr.shape[0] // s, arr.shape[1] // s
    return arr[: hs * s : s, : ws * s : s]


def interior(h: int, w: int, device) -> torch.Tensor:
    """bool[h, w], False on the one-pixel image border.

    Built from comparisons rather than by writing False into the border:
    writing a Python scalar into a CUDA tensor copies it from the host.
    """
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    return (((rows > 0) & (rows < h - 1))[:, None]
            & ((cols > 0) & (cols < w - 1))[None, :])
