"""Checkpoint and resume of the whole engine state (port of
``utils/checkpoint.py``).

A state is a nest of NamedTuples of tensors (``SlamState``, the loop
``BackendState``, the map anchor), so a checkpoint is one ``torch.save``
of its leaves keyed by field path (``convert.flatten``: ``"0.volume.sdf"``,
``"1.kf.poses"``, ...) at ``<path>/step_<N>.pt``, beside
``step_<N>.meta.json`` with the step and the configuration's digest.
Resume refuses a checkpoint of another configuration.

A sharded state (``engine/slam_sharded.py``) is saved by every rank of its
group: each rank writes its own payload and vote rows to
``step_<N>.rank<r>.pt``, rank 0 the replicated rest to ``step_<N>.pt`` and,
once every rank has written, the meta file, which records the shard count.
Resume runs on the same number of shards.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import torch

from instancefusion_tpu_torch import convert


def config_digest(cfg: Any) -> str:
    """Stable digest of the frozen config (resume refuses a mismatch)."""
    d = dataclasses.asdict(cfg)
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


# Leaves that hold a rank's own rows in a sharded state.
_ROW_LEAVES = {f"volume.{f}" for f in convert.SHARDED_ROW_FIELDS} | {
    "votes.label", "votes.count"}


def _is_row_leaf(key: str) -> bool:
    return ".".join(key.split(".")[-2:]) in _ROW_LEAVES


def save(path: str, state: Any, cfg: Any, step: int, group=None) -> None:
    """Save a state nest and the config digest as `path`/step_<step>; with
    a shard `group` of more than one rank, call it on every rank."""
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in convert.flatten(state).items()}
    shards = 1 if group is None else group.size
    if shards > 1:
        torch.save({k: v for k, v in flat.items() if _is_row_leaf(k)},
                   os.path.join(path, f"step_{step}.rank{group.rank}.pt"))
        flat = {k: v for k, v in flat.items() if not _is_row_leaf(k)}
    if group is None or group.rank == 0:
        torch.save(flat, os.path.join(path, f"step_{step}.pt"))
    if shards > 1:
        group.barrier()
    if group is None or group.rank == 0:
        with open(os.path.join(path, f"step_{step}.meta.json"), "w") as f:
            json.dump({"step": step, "config": config_digest(cfg), "shards": shards}, f)
    if shards > 1:
        group.barrier()


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(name[len("step_"):-len(".meta.json")]) for name in os.listdir(path)
             if name.startswith("step_") and name.endswith(".meta.json")]
    return max(steps) if steps else None


def restore(path: str, example_state: Any, cfg: Any, step: int | None = None,
            group=None):
    """Restore the state saved by `save`; returns (state, step).

    `example_state` (a fresh state of the same configuration) gives the
    structure, the shapes and the devices; a sharded state restores this
    rank's rows (`group`).  Raises ``ValueError`` on a config digest or
    shard count mismatch, ``FileNotFoundError`` without a checkpoint.
    """
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    with open(os.path.join(path, f"step_{step}.meta.json")) as f:
        meta = json.load(f)
    if meta["config"] != config_digest(cfg):
        raise ValueError(f"checkpoint config mismatch: {meta['config']} != "
                         f"{config_digest(cfg)}")
    shards = 1 if group is None else group.size
    if meta.get("shards", 1) != shards:
        raise ValueError(f"checkpoint of {meta.get('shards', 1)} shards, resumed on {shards}")
    flat = torch.load(os.path.join(path, f"step_{step}.pt"), weights_only=True)
    if shards > 1:
        flat.update(torch.load(os.path.join(path, f"step_{step}.rank{group.rank}.pt"),
                               weights_only=True))
    return convert.unflatten(example_state, flat), step
