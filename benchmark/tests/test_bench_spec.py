"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric are files found by name, and BENCHMARK.json agrees with
them."""

import dataclasses
import json
import shutil

import pytest

from harness import cell as _cell
from harness import spec


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path, tiny):
    """A checkout with a configuration, a traffic mix and a metric the harness
    has never seen runs a traced cell from BENCHMARK.json alone."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    base = tiny("config2.replay")
    cfg = dict(base.config, name="dummycfg")
    (bench / "configs" / "dummycfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummytraffic.json").write_text(json.dumps(base.traffic))
    (bench / "metrics" / "dummy.frames.py").write_text(
        'LAYER = "engine step"\nSOURCE = "program_counter"\nMOVES = "fps"\nUNIT = "frames"\n\n'
        "def read(run):\n    return float(run.traced_frames)\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "dummycfg", "file": "benchmark/configs/dummycfg.json"}],
        "workloads": [{"name": "dummycfg.dummytraffic", "config": "dummycfg",
                       "traffic": "dummytraffic", "chips": 1}],
        "end_to_end": [{"name": "fps", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "dummy.frames", "unit": "frames"},
                      {"name": "device_idle_share", "unit": "%", "workloads": ["other"]}],
    }))
    shutil.copy(spec.BENCH_DIR / "metrics" / "device_idle_share.py", bench / "metrics")
    c = spec.load_cell("dummycfg.dummytraffic", root=tmp_path, bench_dir=bench)
    assert [m["name"] for m in c.per_layer] == ["dummy.frames"]
    out = _cell.run_cell(c, 5, 4.0, True, "cpu", 0.0)
    assert out["metrics"]["dummy.frames"]["value"] == 6.0
    assert out["correct"] is True


def test_benchmark_json_agrees_with_the_metric_files():
    b = spec.load_json(spec.ROOT / "BENCHMARK.json")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        mod = spec.load_metric(m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"]), m["name"]
        assert mod.MOVES in e2e
        for w in m["workloads"]:
            moved = next(x for x in b["end_to_end"] if x["name"] == mod.MOVES)
            assert w in moved.get("workloads", [w]), (m["name"], w)
    for w in b["workloads"]:
        c = spec.load_cell(w["name"])
        assert c.traffic and c.config["name"] == w["config"]
        assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer


@pytest.mark.parametrize("name,preset", [("config2", "config2_tum_fr3_long_office")])
def test_config_file_is_the_preset_as_run(name, preset):
    from instancefusion_tpu_torch import config as pconfig
    from reference import config as rconfig

    engine = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")["engine"]
    want = getattr(pconfig, preset)()
    assert spec.build(pconfig.EngineConfig, engine) == want
    assert dataclasses.asdict(spec.build(rconfig.EngineConfig, engine)) == \
        dataclasses.asdict(want)
