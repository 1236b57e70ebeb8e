"""Per-frame metrics, phase timers and roofline accounting (port of
``utils/metrics.py``).

- ``MetricsWriter``: one flat dict per frame, written as JSON lines.
- ``Timer``: wall-clock phase timers.  CUDA work is asynchronous, so a
  phase's time means the host's time in it unless something in the phase
  waits for the device; ``sync_fetch`` waits for the device and fetches one
  scalar.
- ``roofline``: a kernel's or a phase's time against its least time at the
  card's peak rates (H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the
  tensor cores).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import IO, Any

import torch


def _leaves(tree: Any):
    """The tensors of a nest of tuples (NamedTuples among them), lists and
    dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def sync_fetch(tree: Any) -> float:
    """Wait until everything queued on the devices of `tree`'s tensors has
    run, then fetch one scalar of the last tensor (0.0 without tensors)."""
    leaves = list(_leaves(tree))
    if not leaves:
        return 0.0
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return float(torch.sum(leaves[-1].reshape(-1)[:1].float()) * 0.0)


class Timer:
    """Named phase timers (per-frame scope)."""

    def __init__(self) -> None:
        self.times_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree: Any = None):
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            sync_fetch(sync_tree)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            (time.perf_counter() - t0) * 1000.0)


class MetricsWriter:
    """JSONL metrics stream (a file and/or stdout)."""

    def __init__(self, path: str | None = None, echo: bool = False) -> None:
        self._f: IO[str] | None = open(path, "w") if path else None
        self._echo = echo

    def write(self, record: dict) -> None:
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self._echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()


PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOP_PER_S = 67e12  # H100 SXM fp32, CUDA cores


def roofline(bytes_moved: float, flops: float, elapsed_s: float) -> dict:
    """Fraction of the least possible time achieved by one kernel or phase."""
    t_mem = bytes_moved / PEAK_BYTES_PER_S
    t_flop = flops / PEAK_FLOP_PER_S
    sol = max(t_mem, t_flop)
    return {
        "elapsed_ms": elapsed_s * 1e3,
        "sol_ms": sol * 1e3,
        "sol_frac": sol / max(elapsed_s, 1e-12),
        "bound": "memory" if t_mem >= t_flop else "compute",
    }


def integrate_traffic_bytes(blocks_touched: int, voxels_per_block: int,
                            with_color: bool) -> float:
    """Device-memory bytes of one block-map integrate (sdf, weight and
    color read and written)."""
    per_voxel = (4 + 4 + (12 if with_color else 0)) * 2
    return float(blocks_touched * voxels_per_block * per_voxel)
