"""Rank groups and collectives for the sharded map (port of
``parallel/mesh.py``).

The reference runs S shard bodies under one controller (``shard_map`` over
a device mesh).  The port runs one process per shard on a
``torch.distributed`` process group: every rank executes the same program
on its own shard-local tensors, and the named-axis collectives of the
reference become explicit calls on a ``ShardGroup``: ``psum``, ``pmax``,
``pmin``, ``ppermute``, ``all_gather`` and ``axis_index``.

Backend rule (``backend_for``): NCCL when every rank has a CUDA device of
its own (``size <= torch.cuda.device_count()``), gloo otherwise, that is
when ranks share a card or run on the CPU.  Rank r uses
``cuda:{r % device_count}``.  Under gloo a collective on CUDA tensors goes
through host copies made here, so ``send``/``recv`` (which gloo takes only
on the CPU) work as well; the kernels still run on the card.

Each group counts what its collectives move (``stats``: calls, payload
bytes this rank put in, host seconds spent in the calls).  With
``timing`` set the device is synchronized before each call, so the
seconds are the collectives' own and not the kernels queued before them.

``launch(fn, S, ...)`` starts S ranks (``RankPool``) and returns rank 0's
result, or calls ``fn`` directly on a rank that is already in a group of
that size (a run under ``torchrun``: ``initialize_multihost``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

# Collectives wait this long for the other ranks before they raise.
TIMEOUT_S = 600.0

_current: "ShardGroup | None" = None


@dataclasses.dataclass
class CollectiveStats:
    calls: int = 0
    bytes: int = 0  # payload bytes this rank put into collectives
    seconds: float = 0.0  # host time inside collective calls

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


def backend_for(size: int, device: torch.device) -> str:
    """NCCL iff every rank has a CUDA device of its own, else gloo."""
    if device.type == "cuda" and size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class ShardGroup:
    """One rank's view of the shard group: its index, the group size, its
    device and the collectives over the group.  A group of size 1 has no
    process group and its collectives return their input."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str | None = None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.stats = CollectiveStats()
        self.timing = False

    def axis_index(self) -> int:
        return self.rank

    # -- transport --------------------------------------------------------
    def _through_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _begin(self, nbytes: int) -> float:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.calls += 1
        self.stats.bytes += int(nbytes)
        return time.perf_counter()

    def _end(self, t0: float) -> None:
        if self.timing and self.device.type == "cuda" and self.backend == "nccl":
            torch.cuda.synchronize(self.device)
        self.stats.seconds += time.perf_counter() - t0

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        dtype = x.dtype
        work = x.to(torch.uint8) if dtype == torch.bool else x
        t0 = self._begin(work.numel() * work.element_size())
        buf = work.cpu() if self._through_host(work) else work.clone()
        dist.all_reduce(buf, op=op)
        out = buf.to(x.device, non_blocking=False)
        self._end(t0)
        return out.to(dtype) if dtype == torch.bool else out

    # -- collectives ------------------------------------------------------
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (bool sums as int32)."""
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x`, stacked in rank order: (size, *x.shape)."""
        if self.size == 1:
            return x[None]
        dtype = x.dtype
        work = x.to(torch.uint8) if dtype == torch.bool else x.contiguous()
        t0 = self._begin(work.numel() * work.element_size())
        src = work.cpu() if self._through_host(work) else work
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.stack(parts).to(x.device)
        self._end(t0)
        return out.to(dtype) if dtype == torch.bool else out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Split `x` (float32, leading dim a multiple of the size) into
        `size` equal chunks; chunk j goes to rank j, and the result holds,
        in rank order, the chunk each rank sent here."""
        if self.size == 1:
            return x.clone()
        t0 = self._begin(x.numel() * x.element_size())
        src = x.cpu() if self._through_host(x) else x.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        out = out.to(x.device)
        self._end(t0)
        return out

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Send `x` along the (source, destination) pairs of `perm`; a rank
        that receives nothing gets zeros (``lax.ppermute``)."""
        if self.size == 1:
            return x.clone() if (0, 0) in perm else torch.zeros_like(x)
        dtype = x.dtype
        work = x.to(torch.uint8) if dtype == torch.bool else x.contiguous()
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        t0 = self._begin(work.numel() * work.element_size() * len(dst))
        host = self._through_host(work)
        payload = work.cpu() if host else work
        recv = torch.zeros_like(payload)
        ops = [dist.isend(payload, d) for d in dst if d != self.rank]
        ops += [dist.irecv(recv, s) for s in src if s != self.rank]
        for op in ops:
            op.wait()
        if self.rank in src and self.rank in dst:
            recv = payload.clone()
        out = recv.to(x.device)
        self._end(t0)
        return out.to(dtype) if dtype == torch.bool else out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def current() -> ShardGroup | None:
    """The group this process joined (``init_group``), or None."""
    return _current


def group_for(num_shards: int, device=None) -> ShardGroup:
    """The current group, checked to have `num_shards` ranks; for one shard
    outside any group, a group of size 1 on `device`."""
    g = _current
    if g is None:
        if num_shards == 1:
            from instancefusion_tpu_torch import device as _device

            return ShardGroup(0, 1, _device.resolve(device))
        raise RuntimeError(
            f"num_shards={num_shards} runs on every rank of a shard group: start "
            "the ranks with parallel.mesh.launch (or torchrun and "
            "initialize_multihost) and call this on each")
    if g.size != num_shards:
        raise ValueError(f"the current group has {g.size} ranks, not {num_shards}")
    return g


def rank_device(rank: int, device=None) -> torch.device:
    """Rank r's device: ``cuda:{r % device_count}`` unless ``device`` says
    otherwise (a CUDA device is asked for, and raises without a card)."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "the shard group on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(num_shards: int, rank: int, device=None,
               init_method: str | None = None) -> ShardGroup:
    """Join the shard group as `rank` of `num_shards` and make it current.

    `init_method` defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``);
    the backend follows ``backend_for``.
    """
    global _current
    if _current is not None:
        raise RuntimeError("this process is already in a shard group")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = None
    if num_shards > 1:
        backend = backend_for(num_shards, dev)
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=num_shards,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _current = ShardGroup(rank, num_shards, dev, backend)
    return _current


def initialize_multihost(device=None) -> ShardGroup:
    """Join the group a launcher describes (``torchrun``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    return init_group(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device)


def destroy() -> None:
    global _current
    if _current is not None and _current.size > 1:
        dist.destroy_process_group()
    _current = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(obj):
    """Results cross the process boundary as CPU tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _worker(rank, size, device, init_method, tasks, results) -> None:
    # The repository root, for tasks defined in modules beside the package.
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        init_group(size, rank, device, init_method)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, _to_host(fn(*args, **kwargs))))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    destroy()


class RankPool:
    """S rank processes joined in one shard group, kept for many tasks.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` and its
    arguments must pickle; a task finds its group with ``mesh.current()``)
    and returns the ranks' results in rank order, tensors moved to the CPU.
    A task that raises on any rank raises here, with its traceback, and
    shuts the pool down.
    """

    def __init__(self, num_shards: int, device=None):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.size = num_shards
        init = f"tcp://127.0.0.1:{_free_port()}"
        self._tasks = [ctx.Queue() for _ in range(num_shards)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, args=(r, num_shards, device, init,
                                              self._tasks[r], self._results),
                        daemon=True)
            for r in range(num_shards)
        ]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self) -> list:
        import queue

        out: dict[int, object] = {}
        errors = []
        deadline = time.monotonic() + TIMEOUT_S
        while len(out) + len(errors) < self.size:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or time.monotonic() > deadline or (errors and time.monotonic()
                                                           > errors[0][0] + 10.0):
                    self.close(force=True)
                    why = "\n".join(e[2] for e in errors) or (
                        f"ranks {dead} exited" if dead else "timed out")
                    raise RuntimeError(f"shard group failed: {why}")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append((time.monotonic(), rank, f"rank {rank}:\n{value}"))
        if errors:
            self.close(force=True)
            raise RuntimeError("shard group failed:\n" + "\n".join(e[2] for e in errors))
        return [out[r] for r in range(self.size)]

    def run(self, fn, *args, **kwargs) -> list:
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect()

    def close(self, force: bool = False) -> None:
        if not force:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=60)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def launch(fn, num_shards: int, *args, device=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` on every rank of a shard group of
    `num_shards` and return rank 0's result.

    On a rank already in a group of that size (``torchrun``, or a task of a
    ``RankPool``) this calls ``fn`` directly; otherwise it starts the ranks
    (``RankPool``) and stops them when ``fn`` returns.
    """
    g = _current
    if g is not None:
        if g.size != num_shards:
            raise ValueError(f"already in a group of {g.size} ranks, not {num_shards}")
        return fn(*args, **kwargs)
    if num_shards == 1:
        return fn(*args, **kwargs)
    with RankPool(num_shards, device) as pool:
        return pool.run(fn, *args, **kwargs)[0]
