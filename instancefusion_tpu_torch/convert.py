"""Engine state and head weights to and from numpy arrays.

State arrays are keyed by the state's field path, e.g. ``"T_wc"``,
``"volume.sdf"`` (a block map's or the dense volume's, by
``EngineConfig.map_kind``), ``"pred.depth"``, ``"votes.label"``, ``"table.cls"``,
``"stamp"``, ``"prev_coarse.0"`` (vmap; ``.1`` nmap, ``.2`` valid), the
same names for this package's ``SlamState`` and the reference's, so a run
of either engine can be carried into the other mid-sequence.  The loop
backend (``engine/posegraph.BackendState``: the keyframe store, the pose
graph, the fern coder and the landmark bank) is keyed the same way, e.g.
``"kf.vertex_c"``, ``"graph.T_ij"``, ``"coder.uv"``, ``"lm.za"``
(``backend_to_numpy``, ``backend_from_numpy``); ``flatten`` and
``unflatten`` give any nest of these states those names
(``utils/checkpoint.py`` stores by them).  The segmentation head's weights
come across from the reference's flax checkpoint by ``seghead_from_flax``.
A rank's share of the sharded map comes from the reference's global arrays
by ``sharded_map_from_global``; ``sharded_map_to_global`` gathers them
back on rank 0, and ``block_map_from_global`` makes them a one-device
``BlockMap``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.config import EngineConfig
from instancefusion_tpu_torch.engine.instances import InstanceTable
from instancefusion_tpu_torch.engine.posegraph import BackendState, KeyframeStore
from instancefusion_tpu_torch.engine.slam import SlamState
from instancefusion_tpu_torch.ops.ba import PairedObs, PoseGraph
from instancefusion_tpu_torch.ops.blocks import BlockMap
from instancefusion_tpu_torch.ops.ferns import FernCoder
from instancefusion_tpu_torch.ops.labels import LabelVotes
from instancefusion_tpu_torch.ops.raycast import RaycastMaps
from instancefusion_tpu_torch.ops.tsdf import TsdfVolume

_TOP = ("T_wc", "pred_T_wc", "frame_idx", "lost_frames", "T_prev_wc")
# The volume's class is picked by the configuration's map kind.
_GROUPS = (("volume", None), ("pred", RaycastMaps), ("votes", LabelVotes),
           ("table", InstanceTable))
# Fields that are None unless the configuration asks for them.
_OPTIONAL = ("stamp", "drift_ewma")


def state_to_numpy(state: SlamState) -> dict[str, np.ndarray]:
    """Every tensor of the state as a numpy array, keyed by field path;
    ``votes.*``, ``table.*``, ``stamp``, ``prev_coarse.*`` and
    ``drift_ewma`` only where the state carries them."""
    out = {name: getattr(state, name).cpu().numpy() for name in _TOP}
    for prefix, _ in _GROUPS:
        group = getattr(state, prefix)
        if group is not None:
            for name, t in group._asdict().items():
                out[f"{prefix}.{name}"] = t.cpu().numpy()
    for name in _OPTIONAL:
        if getattr(state, name) is not None:
            out[name] = getattr(state, name).cpu().numpy()
    if state.prev_coarse is not None:
        for i, t in enumerate(state.prev_coarse):
            out[f"prev_coarse.{i}"] = t.cpu().numpy()
    return out


def state_from_numpy(arrays: dict, cfg: EngineConfig, device=None) -> SlamState:
    """A ``SlamState`` on ``device`` (default ``cuda``) from field-path arrays."""
    dev = _device.resolve(device)

    def get(name):
        return torch.as_tensor(np.array(arrays[name]), device=dev)

    groups = {}
    for prefix, cls in _GROUPS:
        if cls is None:
            cls = BlockMap if cfg.map_kind == "blocks" else TsdfVolume
        if f"{prefix}.{cls._fields[0]}" in arrays:
            groups[prefix] = cls(**{f: get(f"{prefix}.{f}") for f in cls._fields})
    if "volume" not in groups:
        raise ValueError(f"no {cfg.map_kind} volume among the arrays")
    vol = groups["volume"]
    if cfg.map_kind == "blocks":
        nb = cfg.tsdf.grid_size // cfg.tsdf.block_size
        what, shape, want = "directory", tuple(vol.directory.shape), (nb, nb, nb)
    else:
        what, shape, want = "sdf", tuple(vol.sdf.shape), (cfg.tsdf.grid_size,) * 3
    if shape != want:
        raise ValueError(f"{what} shape {shape} does not match the configuration's {want}")
    optional = {name: get(name) for name in _OPTIONAL if name in arrays}
    if "prev_coarse.0" in arrays:
        optional["prev_coarse"] = tuple(get(f"prev_coarse.{i}") for i in range(3))
    return SlamState(**{name: get(name) for name in _TOP}, **groups, **optional,
                     frame_count=int(arrays["frame_idx"]))


def flatten(tree, prefix: str = "") -> dict:
    """The leaves of a nest of NamedTuples and tuples keyed by field path
    (tuple positions by index): ``{"T_wc": ..., "volume.sdf": ...,
    "prev_coarse.0": ...}``.  Leaves that are not tuples (tensors, ints,
    None) are kept as they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}.{key}" if prefix else key))
    return out


def unflatten(example, flat: dict, prefix: str = ""):
    """``flatten``'s inverse: `example`'s structure with every leaf taken
    from `flat`, tensors moved to the example leaf's device; a tensor of
    another shape than the example's raises ``ValueError``."""
    if isinstance(example, tuple):
        def key(k):
            return f"{prefix}.{k}" if prefix else str(k)
        if hasattr(example, "_fields"):
            return type(example)(*(unflatten(v, flat, key(k))
                                   for k, v in zip(example._fields, example)))
        return tuple(unflatten(v, flat, key(i)) for i, v in enumerate(example))
    value = flat[prefix]
    if isinstance(example, torch.Tensor):
        value = torch.as_tensor(value).to(example.device)
        if value.shape != example.shape:
            raise ValueError(f"{prefix}: shape {tuple(value.shape)} != "
                             f"{tuple(example.shape)}")
    return value


def backend_to_numpy(bs: BackendState) -> dict[str, np.ndarray]:
    """Every tensor of the loop backend as a numpy array, keyed by field path."""
    return {k: v.cpu().numpy() for k, v in flatten(bs).items() if v is not None}


_BACKEND_GROUPS = {"kf": KeyframeStore, "graph": PoseGraph, "coder": FernCoder,
                   "lm": PairedObs}


def backend_from_numpy(arrays: dict, device=None) -> BackendState:
    """A ``BackendState`` on ``device`` (default ``cuda``) from field-path
    arrays (``backend_to_numpy``'s keys, the same for the reference)."""
    dev = _device.resolve(device)

    def get(name):
        return torch.as_tensor(np.array(arrays[name]), device=dev)

    fields = {}
    for name in BackendState._fields:
        cls = _BACKEND_GROUPS.get(name)
        if cls is not None:
            fields[name] = cls(**{f: get(f"{name}.{f}") for f in cls._fields})
        elif name in arrays:
            fields[name] = get(name)
    return BackendState(**fields)


# flax ``_ConvBlock_<i>`` -> ``blocks.<i>``; the three 1x1 output convs.
_HEAD_OUT = {"Conv_0": "sem", "Conv_1": "center", "Conv_2": "offset"}


def seghead_from_flax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A ``PanopticHead`` state dict from the reference's flax parameters.

    ``arrays`` maps flax key paths as ``save_pretrained`` writes them, e.g.
    ``"['params']['_ConvBlock_3']['Conv_0']['kernel']"`` (HWIO, fp16), to
    arrays; the result holds fp32 tensors under the port's names
    (``blocks.3.conv.weight``, OIHW).
    """
    out = {}
    for key, value in arrays.items():
        path = re.findall(r"\['([^']+)'\]", key)
        if path[0] == "params":
            path = path[1:]
        if path[0].startswith("_ConvBlock_"):
            i = int(path[0].rsplit("_", 1)[1])
            layer = {"Conv_0": "conv", "GroupNorm_0": "norm"}[path[1]]
            prefix = f"blocks.{i}.{layer}"
        else:
            prefix = _HEAD_OUT[path[0]]
        leaf = path[-1]
        x = torch.from_numpy(np.asarray(value, dtype=np.float32))
        if leaf == "kernel":  # HWIO -> OIHW
            out[f"{prefix}.weight"] = x.permute(3, 2, 0, 1).contiguous()
        elif leaf == "scale":
            out[f"{prefix}.weight"] = x
        elif leaf == "bias":
            out[f"{prefix}.bias"] = x
        else:
            raise ValueError(f"unexpected flax parameter {key}")
    return out


def seghead_to_flax(state_dict: dict) -> dict[str, np.ndarray]:
    """The reference's flax parameters (as ``save_pretrained`` keys them,
    fp32 numpy, HWIO kernels) from a ``PanopticHead`` state dict: the
    inverse of ``seghead_from_flax``."""
    outputs = {v: k for k, v in _HEAD_OUT.items()}
    out = {}
    for name, value in state_dict.items():
        *prefix, leaf = name.split(".")
        if prefix[0] == "blocks":
            layer = {"conv": "Conv_0", "norm": "GroupNorm_0"}[prefix[2]]
            path = [f"_ConvBlock_{int(prefix[1])}", layer]
        else:
            layer = "Conv_0"
            path = [outputs[prefix[0]]]
        x = value.detach().float().cpu()
        if leaf == "bias":
            key = "bias"
        elif layer == "GroupNorm_0":
            key = "scale"
        else:  # OIHW -> HWIO
            key, x = "kernel", x.permute(2, 3, 1, 0)
        out["['params']" + "".join(f"['{p}']" for p in path + [key])] = x.contiguous().numpy()
    return out


# The sharded map (``parallel/shard.py``): the reference holds it as global
# arrays with the payload rows of shard s at [s Cl, (s+1) Cl); a rank of the
# port holds its own rows and the replicated rest.
SHARDED_ROW_FIELDS = ("block_coords", "sdf", "weight", "color")


def sharded_map_from_global(arrays: dict, rank: int, num_shards: int, device=None):
    """Rank `rank`'s ``ShardedBlockMap`` from the reference's global arrays
    (``directory``, ``block_coords``, ``n_active``, ``overflow``, ``sdf``,
    ``weight``, ``color``, ``cuts``; numpy or tensors)."""
    from instancefusion_tpu_torch.parallel.shard import ShardedBlockMap

    dev = _device.resolve(device)
    return ShardedBlockMap(**{
        name: sharded_rows_from_global(arrays[name], rank, num_shards, dev)
        if name in SHARDED_ROW_FIELDS else torch.as_tensor(np.array(arrays[name]), device=dev)
        for name in ShardedBlockMap._fields})


def sharded_rows_from_global(x, rank: int, num_shards: int, device=None) -> torch.Tensor:
    """Rank `rank`'s rows of a row-sharded global array (e.g. vote planes)."""
    x = torch.as_tensor(np.array(x), device=_device.resolve(device))
    cl = x.shape[0] // num_shards
    return x[rank * cl:(rank + 1) * cl].clone()


def gather_rows(x: torch.Tensor, group):
    """Every rank's rows of `x` concatenated in rank order on rank 0 (numpy),
    None on the other ranks."""
    g = group.all_gather(x)
    return g.reshape((-1,) + tuple(x.shape[1:])).cpu().numpy() if group.rank == 0 else None


def sharded_map_to_global(bm, group) -> dict | None:
    """The sharded map as the reference's global arrays, on rank 0 (numpy;
    None on the other ranks)."""
    out = {}
    for name, x in bm._asdict().items():
        out[name] = gather_rows(x, group) if name in SHARDED_ROW_FIELDS else x.cpu().numpy()
    return out if group.rank == 0 else None


def block_map_from_global(arrays: dict, device=None) -> BlockMap:
    """A one-device ``BlockMap`` of a gathered sharded map: its rows in
    global slot order, so the directory's global slots address them."""
    dev = _device.resolve(device)

    def get(name):
        return torch.as_tensor(np.array(arrays[name]), device=dev)

    return BlockMap(directory=get("directory"), block_coords=get("block_coords"),
                    n_active=get("n_active").sum().to(torch.int32),
                    overflow=get("overflow").sum().to(torch.int32), sdf=get("sdf"),
                    weight=get("weight"), color=get("color"))
