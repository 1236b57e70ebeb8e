"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<name>.py`` beside this package.  A new configuration, traffic
mix or per-layer metric is a new file and a new entry; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list  # entries of its per_layer this cell reports
    metric_modules: dict  # per-layer name -> loaded module


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The per-layer metric module ``metrics/<name>.py`` (names may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` of ``BENCHMARK.json`` with its configuration,
    traffic and metrics."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload)]
    return Cell(
        name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=per_layer,
        metric_modules={m["name"]: load_metric(m["name"], bench_dir) for m in per_layer},
    )


def build(cls, values: dict):
    """A frozen dataclass `cls` from a JSON object: nested dataclasses by
    their fields' default types, lists as tuples."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        default = f.default if f.default is not dataclasses.MISSING else None
        if isinstance(v, dict) and dataclasses.is_dataclass(default):
            v = build(type(default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    unknown = set(values) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kw)
