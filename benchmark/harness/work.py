"""Counted work of a frame: the bytes and fp32 operations each stage must
move and compute, from the frame's data (pixels, pyramid levels, GN steps,
listed blocks, fused voxels), never from how the program implements a
stage.  The per-pixel and per-voxel constants are
frozen copies of ``chip_smoke.py``'s; a stage without a count here adds
nothing (``PERF.md`` lists them).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores

# fp32 operations of one Gauss-Newton step on a gated pixel (pose transform
# 33, residual and gates 20, Jacobian 9, 27 sums x 2).
GN_FLOPS_PER_PIXEL = 116
# fp32 operations of level-0 preprocessing a pixel: 25 bilateral taps of ~8
# and ~60 for the vertex, the differences, the cross product, the norm.
PREPROCESS_FLOPS_PER_PIXEL = 260


def least_seconds(n_bytes: float, n_flops: float) -> float:
    """The least time of the work on one card: the larger of its bytes at the
    memory rate and its operations at the fp32 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_PER_S)


def icp_schedule(icp: dict) -> list[tuple[int, int, int]]:
    """(level, inner_n, outer_n) of each pyramid level, coarse to fine: GN steps
    a launch and association rounds (``ops/icp.level_schedule``)."""
    out = []
    levels, iters, ae = icp["levels"], list(icp["iters"]), icp["assoc_every"]
    for lvl in range(levels - 1, -1, -1):
        idx = max(0, min(levels - 1 - lvl, len(iters) - 1))
        n_it = iters[idx]
        a = ae[min(idx, len(ae) - 1)] if isinstance(ae, (list, tuple)) else ae
        inner = max(1, min(a, n_it))
        out.append((lvl, inner, -(-n_it // inner)))
    return out


def preprocess(hw: int) -> tuple[float, float]:
    """K1: raw depth read; filtered depth, vertex, normal and valid written."""
    return hw * (4 + 4 + 12 + 12 + 1), PREPROCESS_FLOPS_PER_PIXEL * hw


def pyramid_level(n_prev: int, n: int) -> tuple[float, float]:
    """A coarser level: the finer depth read; depth, vertex, normal, valid written."""
    return 4 * n_prev + n * (4 + 12 + 12 + 1), 0.0


def association(n: int, n_valid: int) -> tuple[float, float]:
    """K2 at a level of n pixels, n_valid of them valid: source vertex and
    validity and the poses read, each valid pixel's target vertex, normal and
    validity read, q, n_t, gate and ok written."""
    return n * 13 + 128 + n_valid * 25 + n * 29, 0.0


def gn(n: int, n_valid: int, inner_n: int) -> tuple[float, float]:
    """K3 on a level of n pixels: source, targets and gate read, the pose
    and stats written; inner_n steps over at most the n_valid valid pixels."""
    return n * (4 * 12 + 4) + 64 + 72, GN_FLOPS_PER_PIXEL * n_valid * inner_n


def integrate(k: int, n_listed: int, b3: int, n_fused: int, hw: int,
              color: bool) -> tuple[float, float]:
    """K4: the list and the listed rows' coordinates; every listed voxel's
    payload read (sdf, weight, and color on a color frame); the fused voxels'
    payload written; the depth (and color) image read."""
    floats = 5 if color else 2
    return (k * 5 + n_listed * 12 + 64 + n_listed * b3 * 4 * floats + n_fused * 4 * floats
            + hw * (4 + (12 if color else 0))), 0.0


def splat(k: int, n_listed: int, b3: int, hw: int, color: bool) -> tuple[float, float]:
    """K5: the list, the listed rows' coordinates, sdf and weight (and color)
    read; the accumulator planes written."""
    nch = 6 if color else 3
    return (k * 5 + n_listed * 12 + n_listed * b3 * 4 * (2 + (3 if color else 0))
            + nch * hw * 4), 0.0


def frame_stages(cfg: dict, rec: dict) -> dict:
    """{stage: (bytes, flops)} of one frame's counted work.

    ``rec`` holds the frame's counts: ``pixels`` and ``valid`` per pyramid
    level (fine to coarse), ``k`` (list length), ``listed``, ``fused``,
    ``color`` (a color frame) and ``pred_color``."""
    intr, tsdf = cfg["intrinsics"], cfg["tsdf"]
    hw = intr["width"] * intr["height"]
    b3 = tsdf["block_size"] ** 3
    px, val = rec["pixels"], rec["valid"]
    out = {"preprocess": preprocess(hw)}
    for lvl in range(1, len(px)):
        out[f"pyramid{lvl}"] = pyramid_level(px[lvl - 1], px[lvl])
    for lvl, inner, outer in icp_schedule(cfg["icp"]):
        a, g = association(px[lvl], val[lvl]), gn(px[lvl], val[lvl], inner)
        out[f"associate{lvl}"] = (a[0] * outer, a[1] * outer)
        out[f"gn{lvl}"] = (g[0] * outer, g[1] * outer)
    out["integrate"] = integrate(rec["k"], rec["listed"], b3, rec["fused"], hw, rec["color"])
    out["splat"] = splat(rec["k"], rec["listed"], b3, hw, rec["pred_color"])
    return out


def gn_least_seconds(cfg: dict, rec: dict) -> float:
    """The least time of one frame's K3 launches, launch by launch."""
    px, val = rec["pixels"], rec["valid"]
    return sum(outer * least_seconds(*gn(px[lvl], val[lvl], inner))
               for lvl, inner, outer in icp_schedule(cfg["icp"]))
