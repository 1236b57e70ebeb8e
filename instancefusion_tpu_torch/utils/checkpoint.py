"""Checkpoint and resume of the whole engine state (port of
``utils/checkpoint.py``).

A state is a nest of NamedTuples of tensors (``SlamState``, the loop
``BackendState``, the map anchor), so a checkpoint is one ``torch.save``
of its leaves keyed by field path (``convert.flatten``: ``"0.volume.sdf"``,
``"1.kf.poses"``, ...) at ``<path>/step_<N>.pt``, beside
``step_<N>.meta.json`` with the step and the configuration's digest.
Resume refuses a checkpoint of another configuration.
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


def save(path: str, state: Any, cfg: Any, step: int) -> None:
    """Save a state nest and the config digest as `path`/step_<step>."""
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in convert.flatten(state).items()}
    torch.save(flat, os.path.join(path, f"step_{step}.pt"))
    with open(os.path.join(path, f"step_{step}.meta.json"), "w") as f:
        json.dump({"step": step, "config": config_digest(cfg)}, f)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(name[len("step_"):-len(".meta.json")]) for name in os.listdir(path)
             if name.startswith("step_") and name.endswith(".meta.json")]
    return max(steps) if steps else None


def restore(path: str, example_state: Any, cfg: Any, step: int | None = None):
    """Restore the state saved by `save`; returns (state, step).

    `example_state` (a fresh state of the same configuration) gives the
    structure, the shapes and the devices.  Raises ``ValueError`` on a
    config digest mismatch, ``FileNotFoundError`` without a checkpoint.
    """
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    with open(os.path.join(path, f"step_{step}.meta.json")) as f:
        meta = json.load(f)
    if meta["config"] != config_digest(cfg):
        raise ValueError(f"checkpoint config mismatch: {meta['config']} != "
                         f"{config_digest(cfg)}")
    flat = torch.load(os.path.join(path, f"step_{step}.pt"), weights_only=True)
    return convert.unflatten(example_state, flat), step
