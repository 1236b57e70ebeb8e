"""Active-window block streaming: device memory <-> host DRAM (port of
``engine/streaming.py``, the single-device ``BlockStreamer``).

The device holds only the active window of voxel blocks around the camera;
blocks that leave it move to a host store and come back when the camera
returns, so the table capacity bounds the local scene, not the whole one.

- Device side (``ops/blocks.partition_window``, ``admit_rows``): the slot
  bookkeeping, with a bounded eviction buffer.  Every per-slot tensor of
  the engine state (the map's payload, the label ``votes``, the ``stamp``
  rows) moves with its row.
- Host side (this module): a store from flat block id to numpy rows, the
  policy (radius, caps), and ``save``/``load`` in the reference's npz
  format, so a store written by either package loads in the other.
  ``ShardedBlockStreamer`` keeps one such store, replicated, for the
  sharded map.

Transfers: an eviction is one device call, one copy of the bounded
``evict_cap`` rows into a pinned host buffer and one wait; an admission
stacks its rows into a pinned buffer, makes one host-to-device copy and
runs ``admit_rows``, then reads back which rows fitted.

Admission removes a block from the store and eviction inserts it; a
re-admitted row is bit-identical to the evicted one.  As in the reference,
a stored block that the camera sees again from beyond the radius is
allocated afresh on the device: admission then skips its stored copy (the
live block wins) and the next eviction replaces it, so the radius should
exceed the sensor's range.
"""

from __future__ import annotations

import numpy as np
import torch

from instancefusion_tpu_torch.config import TsdfConfig
from instancefusion_tpu_torch.ops import blocks as blk


class BlockStreamer:
    """Host-DRAM block store and streaming policy.

    Call ``tick(volume, votes, T_wc, stamp)`` at a low cadence (the pipeline
    wires ``stream_every``): it admits stored blocks that re-entered the
    window, then evicts live blocks that left it, and returns the updated
    (volume, votes, stamp) and a stats dict for the metrics.
    """

    def __init__(
        self,
        cfg: TsdfConfig,
        radius: float,
        evict_cap: int = 1024,
        admit_cap: int = 1024,
        with_color: bool = True,
        with_votes: bool = False,
        with_stamps: bool = False,
    ):
        self.cfg = cfg
        self.radius = float(radius)
        self.evict_cap = int(evict_cap)
        self.admit_cap = int(admit_cap)
        self.with_color = with_color
        self.with_votes = with_votes
        self.with_stamps = with_stamps
        # flat block id -> dict of numpy rows
        self.store: dict[int, dict[str, np.ndarray]] = {}
        b3 = cfg.block_size**3
        self._zero = {
            "coords": np.full((3,), -1, np.int32),
            "sdf": np.full((b3,), blk.UNOBSERVED, np.float32),
            "weight": np.zeros((b3,), np.float32),
        }
        if with_color:
            # Packed [r | g | b] channel-segmented rows (blocks.BlockMap).
            self._zero["color"] = np.zeros((3 * b3,), np.float32)
        if with_votes:
            self._zero["label"] = np.full((b3,), -1, np.int32)
            self._zero["count"] = np.zeros((b3,), np.float32)
        if with_stamps:
            self._zero["stamp"] = np.zeros((2,), np.int32)
        # Column range of each field in a packed transfer row: every field
        # is 4 bytes an element, so one float32 row holds them all and the
        # int32 fields travel bit for bit as reinterpreted floats.
        self._cols, at = {}, 0
        for key, zero in self._zero.items():
            self._cols[key] = (at, at + zero.size)
            at += zero.size
        self._width = at
        self._pinned: dict[tuple, torch.Tensor] = {}

    def _host_buffer(self, rows: int, device: torch.device) -> torch.Tensor:
        """A reusable float32 host buffer of `rows` packed rows plus a
        validity column, pinned when `device` is a CUDA device."""
        key = (rows, device.type)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty((rows, self._width + 1), dtype=torch.float32,
                              pin_memory=device.type == "cuda")
            self._pinned[key] = buf
        return buf

    def _centers(self, flat_ids: np.ndarray) -> np.ndarray:
        nb = blk.num_blocks_per_axis(self.cfg)
        bsz = self.cfg.block_size * self.cfg.voxel_size
        coords = np.stack(
            [flat_ids // (nb * nb), (flat_ids // nb) % nb, flat_ids % nb], axis=-1
        )
        return np.asarray(self.cfg.origin) + (coords + 0.5) * bsz

    def admit(self, volume, votes, center_w: np.ndarray, stamp=None):
        """Move stored blocks whose center is inside the window to the
        device.  Returns (volume, votes, stamp, blocks admitted)."""
        if not self.store:
            return volume, votes, stamp, 0
        ids = np.fromiter(self.store.keys(), dtype=np.int64)
        dist = np.linalg.norm(self._centers(ids) - center_w[None, :], axis=-1)
        hot = ids[dist <= self.radius][: self.admit_cap]
        if hot.size == 0:
            return volume, votes, stamp, 0
        rows = [self.store.pop(int(i)) for i in hot]
        n = self.admit_cap
        dev = volume.sdf.device
        host = self._host_buffer(n, dev)
        packed = host.numpy()
        for key, (a, b) in self._cols.items():
            view = packed[:, a:b].view(self._zero[key].dtype)
            view[: len(rows)] = np.stack([r[key] for r in rows])
            view[len(rows):] = self._zero[key]
        packed[:, -1] = np.arange(n) < len(rows)
        batch = host.to(dev, non_blocking=True)

        def field(key):
            a, b = self._cols[key]
            col = batch[:, a:b]
            return col.view(torch.int32) if self._zero[key].dtype == np.int32 else col

        volume, votes, fits, stamp = self._admit_call(volume, votes, field,
                                                      batch[:, -1] > 0.5, stamp)
        # Blocks that did not fit (capacity) go back to the store.
        fits_np = fits.cpu().numpy()[: len(rows)]
        for i, r in enumerate(rows):
            if not fits_np[i]:
                self.store[int(hot[i])] = r
        return volume, votes, stamp, int(fits_np.sum())

    def evict(self, volume, votes, center_w: np.ndarray, stamp=None):
        """Move live blocks outside the window to the host store.  Returns
        (volume, votes, stamp, blocks evicted)."""
        dev = volume.sdf.device
        center = torch.tensor(np.asarray(center_w, np.float32), device=dev)
        volume, votes_new, ev, stamp = self._evict_call(volume, votes, center, stamp)
        cols = [ev[key].view(torch.float32) if ev[key].dtype == torch.int32 else ev[key]
                for key in self._zero if key in ev]
        packed = self._gather(torch.cat(cols + [ev["valid"].float()[:, None]], dim=1))
        host = self._host_buffer(packed.shape[0], dev)
        if packed.shape != host.shape:
            raise ValueError(f"evicted rows {tuple(packed.shape)} do not match the "
                             f"store's fields {tuple(host.shape)}")
        host.copy_(packed, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        rows = host.numpy()
        nb = blk.num_blocks_per_axis(self.cfg)
        n_out = 0
        for i in np.flatnonzero(rows[:, -1] > 0.5):
            row = {key: rows[i, a:b].view(self._zero[key].dtype).copy()
                   for key, (a, b) in self._cols.items()}
            cx, cy, cz = (int(x) for x in row["coords"])
            self.store[(cx * nb + cy) * nb + cz] = row
            n_out += 1
        return volume, (votes_new if votes is not None else votes), stamp, n_out

    def _admit_call(self, volume, votes, field, valid, stamp):
        """The device half of an admission: (volume, votes, fits, stamp)."""
        out = blk.admit_rows(
            volume, self.cfg, field("coords"), field("sdf"), field("weight"),
            field("color") if self.with_color else None, valid, votes,
            field("label") if self.with_votes else None,
            field("count") if self.with_votes else None,
            stamp, field("stamp") if (stamp is not None and self.with_stamps) else None,
        )
        return out if stamp is not None else (*out, None)

    def _evict_call(self, volume, votes, center, stamp):
        """The device half of an eviction: (volume, votes, evicted, stamp)."""
        out = blk.partition_window(volume, self.cfg, center, self.radius, self.evict_cap,
                                   votes, stamp)
        return out if stamp is not None else (*out, None)

    def _gather(self, packed: torch.Tensor) -> torch.Tensor:
        """The evicted rows that enter the store (all of them, here)."""
        return packed

    def save(self, path: str) -> None:
        """Persist the host store beside a device checkpoint: evicted blocks
        exist only here, so a resume without it loses them."""
        ids = np.fromiter(self.store.keys(), np.int64, count=len(self.store))
        payload = {"ids": ids}
        for key, zero in self._zero.items():
            if len(ids):
                payload[key] = np.stack([self.store[int(i)][key] for i in ids])
            else:
                payload[key] = np.zeros((0,) + zero.shape, zero.dtype)
        np.savez_compressed(path, **payload)

    def load(self, path: str) -> None:
        """Restore a store written by ``save`` (replaces the current one)."""
        with np.load(path) as data:
            ids = data["ids"]
            fields = {key: data[key] for key in self._zero}
        self.store = {
            int(ids[i]): {key: fields[key][i] for key in self._zero}
            for i in range(len(ids))
        }

    def tick(self, volume, votes, T_wc, stamp=None):
        """One streaming step: admit re-entering blocks, evict cold ones."""
        center = T_wc[:3, 3].detach().cpu().numpy().astype(np.float64)
        volume, votes, stamp, n_in = self.admit(volume, votes, center, stamp)
        volume, votes, stamp, n_out = self.evict(volume, votes, center, stamp)
        return volume, votes, stamp, {
            "stream_in": n_in,
            "stream_out": n_out,
            "stored_blocks": len(self.store),
        }


class ShardedBlockStreamer(BlockStreamer):
    """Block streaming for the sharded map (``parallel/shard.py``).

    The same policy, store format and ``tick`` as ``BlockStreamer``; the
    device halves change.  Eviction runs ``shard.partition_window`` on
    every rank (each evicts its own cold rows) and one ``all_gather`` of
    the packed eviction buffers brings every evicted row to every rank.
    Admission hands the same rows to ``shard.admit_rows`` on every rank
    (each appends the rows of its own slab) and reads back the replicated
    admitted mask.  So the store is replicated: every rank holds every
    stored block, keyed by block id, and a reshard, which moves rows
    between ranks but never in or out of the store, cannot lose or
    duplicate a stored block.  Rank 0 saves it.  Stamps are a
    single-shard feature.
    """

    def __init__(self, cfg: TsdfConfig, group, radius: float, evict_cap: int = 1024,
                 admit_cap: int = 1024, with_color: bool = True, with_votes: bool = False):
        super().__init__(cfg, radius, evict_cap=evict_cap, admit_cap=admit_cap,
                         with_color=with_color, with_votes=with_votes, with_stamps=False)
        self.group = group

    def _admit_call(self, volume, votes, field, valid, stamp):
        from instancefusion_tpu_torch.parallel import shard

        volume, votes, fits = shard.admit_rows(
            volume, self.group, self.cfg, field("coords"), field("sdf"), field("weight"),
            field("color") if self.with_color else None, valid, votes,
            field("label") if self.with_votes else None,
            field("count") if self.with_votes else None)
        return volume, votes, fits, stamp

    def _evict_call(self, volume, votes, center, stamp):
        from instancefusion_tpu_torch.parallel import shard

        volume, votes, ev = shard.partition_window(volume, self.group, self.cfg, center,
                                                   self.radius, self.evict_cap, votes)
        return volume, votes, ev, stamp

    def _gather(self, packed: torch.Tensor) -> torch.Tensor:
        return self.group.all_gather(packed).reshape(-1, packed.shape[1])

    def save(self, path: str) -> None:
        if self.group.rank == 0:
            super().save(path)
