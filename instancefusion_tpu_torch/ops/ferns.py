"""Randomized-fern keyframe codes for global loop retrieval (port of
``ops/ferns.py``).

A frame is encoded by F random binary tests: one pixel per fern, its r, g,
b and depth each compared with the fern's threshold, the four bits packed
into a u8 code.  Retrieval compares one code against every stored code and
takes the keyframe with the smallest fraction of differing ferns.
Encoding is one gather at the F fern pixels, retrieval one broadcast
compare; both stay on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class FernCoder(NamedTuple):
    """Fern test parameters, drawn once and shared by all frames."""

    uv: torch.Tensor  # i32[F, 2] (v, u) pixel per fern
    thresh: torch.Tensor  # f32[F, 4] thresholds for (r, g, b, depth)


def make_coder(generator: torch.Generator, height: int, width: int, num_ferns: int,
               depth_max: float = 5.0) -> FernCoder:
    """Draw a coder from `generator`, on the generator's device: rows, then
    columns, then the color and the depth thresholds."""
    dev = generator.device
    v = torch.randint(0, height, (num_ferns, 1), generator=generator, device=dev)
    u = torch.randint(0, width, (num_ferns, 1), generator=generator, device=dev)
    rgb_t = torch.rand((num_ferns, 3), generator=generator, device=dev)
    d_t = torch.rand((num_ferns, 1), generator=generator, device=dev) * depth_max
    return FernCoder(uv=torch.cat([v, u], -1).to(torch.int32),
                     thresh=torch.cat([rgb_t, d_t], -1).to(torch.float32))


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    """[1, 2, 4, 8] as u8 on `device`, made once on the device."""
    return torch.pow(2, torch.arange(4, device=device)).to(torch.uint8)


def encode(coder: FernCoder, color: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Frame -> fern code u8[F] (bits r, g, b, d of the threshold tests)."""
    v, u = coder.uv[:, 0].long(), coder.uv[:, 1].long()
    vals = torch.cat([color[v, u], depth[v, u][:, None]], -1)  # (F, 4)
    bits = (vals > coder.thresh).to(torch.uint8)
    # The sum promotes to int64; the code is 4 bits, so the cast is exact.
    return torch.sum(bits * _bit_weights(bits.device), dim=-1).to(torch.uint8)


def dissimilarity(code: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Fraction of differing fern codes against every row of db: (M,) in [0, 1]."""
    return torch.mean((db != code[None, :]).float(), dim=-1)


def find_best(code: torch.Tensor, db: torch.Tensor, db_valid: torch.Tensor,
              exclude_after) -> tuple[torch.Tensor, torch.Tensor]:
    """Best loop candidate among the valid rows below `exclude_after`:
    (index () i32, dissimilarity () f32), the first of tied minima (as
    ``jnp.argmin``); inf dissimilarity when no row qualifies."""
    m = db.shape[0]
    diss = dissimilarity(code, db)
    idx = torch.arange(m, device=db.device)
    ok = db_valid & (idx < exclude_after)
    diss = torch.where(ok, diss, torch.full_like(diss, float("inf")))
    best = torch.argmin(diss)
    return best.to(torch.int32), torch.index_select(diss, 0, best.reshape(1))[0]
