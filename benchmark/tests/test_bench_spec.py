"""The harness is driven by data: a configuration, a traffic mix, a
per-layer metric and a judge are files found by name, and BENCHMARK.json
agrees with them."""

import dataclasses
import json
import shutil

import pytest
import torch

from harness import cell as _cell
from harness import spec


def checkout(tmp_path):
    """An empty checkout's benchmark folder, with the SLAM judge that every
    configuration of the block map names."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "judges"):
        (bench / sub).mkdir(parents=True)
    shutil.copy(spec.BENCH_DIR / "judges" / "slam.py", bench / "judges")
    return bench


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path, tiny, frame_clock):
    """A checkout with a configuration, a traffic mix and a metric the harness
    has never seen runs a traced cell from BENCHMARK.json alone."""
    bench = checkout(tmp_path)
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
    out = _cell.run_cell(c, 5, 0.99, True, "cpu", 0.0)
    assert out["attempted"] == 20  # 0.99 s at 0.05 s a frame
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


# A model a configuration brings as new files: its judge hands the program a
# segmentation function, keeps the program's votes, and counts the votes the
# reference map says each dispatched segmentation makes.
TOY_JUDGE = '''"""A toy segmentation model: one instance over every pixel with depth
that the program's mask refinement keeps (none on a depth edge or a crease)."""

import torch

from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.models.segmentation import Segmentation
from instancefusion_tpu_torch.ops.labels import refine_mask_edges
from reference.ops.kernels import tsdf as rktsdf

SPAN = "toy.head"


class Judge:
    def __init__(self, cell, seed, dev, count_work):
        self.intr = Intrinsics(**cell.config["engine"]["intrinsics"])
        self.calls = {}  # window frame -> the mask handed to the program

    def segment(self, frame):
        with torch.profiler.record_function(SPAN):
            mask = torch.where(frame.depth > 0.0, 0, -1).to(torch.int32)
            mask = refine_mask_edges(mask, frame.depth, intr=self.intr)
            one = torch.ones(1, device=mask.device)
        return Segmentation(mask_id=mask, classes=one.int(), scores=one, valid=one > 0)

    def run_kw(self, window):
        def recorded(frame):
            seg = self.segment(frame)
            self.calls[frame.index] = seg.mask_id
            return seg

        return {"segment_fn": recorded if window else self.segment}

    def keep(self, res, counters):
        self.directory, self.count = res.state.volume.directory, res.state.votes.count

    def pred_frames(self, n):
        return set(self.calls)

    def start(self, ctx):
        tcfg = ctx.cfg.tsdf
        self.votes = torch.zeros(tcfg.table_capacity, tcfg.block_size ** 3, device=ctx.dev)
        self.records = []

    def frame(self, ctx):
        # The program fuses frame k's segmentation before frame k + 1, into
        # the map after frame k, at frame k's raw depth and served pose.
        mask = self.calls.get(ctx.k)
        if mask is None:
            return
        vol, tcfg = ctx.volume, ctx.cfg.tsdf
        slots = torch.arange(int(vol.n_active), device=ctx.dev)
        z, pix, seen = rktsdf.project_voxels(vol.block_coords, slots, ctx.T,
                                             ctx.cfg.intrinsics, tcfg)
        d = ctx.d_k.reshape(-1)[pix]
        obs = seen & (d > 0.0) & ((d - z).abs() < tcfg.trunc) & (mask.reshape(-1)[pix] >= 0)
        self.votes[slots] += obs
        self.records.append({"frame": ctx.k, "votes": int(obs.sum()),
                             "pred_valid": int(ctx.pred.valid.sum())})

    def finish(self, ctx):
        dp, dr = self.directory.reshape(-1), ctx.volume.directory.reshape(-1)
        either = torch.nonzero((dp >= 0) | (dr >= 0))[:, 0]

        def rows(plane, slots):
            r = plane[slots.clamp(min=0).long()]
            return torch.where((slots >= 0)[:, None], r, torch.zeros_like(r))

        prog, ref = rows(self.count, dp[either]), rows(self.votes, dr[either])
        total = max(float(ref.sum()), 1.0)
        return {"toy.votes_short": float((ref - prog).clamp(min=0).sum()) / total,
                "toy.votes_over": float((prog - ref).clamp(min=0).sum()) / total}, self.records
'''

TOY_METRICS = {
    "toy.segs": "float(len(run.records['toy']))",
    "toy.head_spans": "float(run.labelled.span_seconds('toy.head')[2])",
}


def toy_checkout(tmp_path, tiny):
    """A checkout whose configuration runs the instance path with the toy
    model segmenting every second frame, judged by the SLAM judge and the
    toy's, with two metrics of the toy's records and spans."""
    bench = checkout(tmp_path)
    base = tiny("config2.replay")
    cfg = json.loads(json.dumps(base.config))
    cfg.update(name="toycfg", judges=["slam", "toy"])
    cfg["engine"].update(use_instances=True)
    cfg["engine"]["instances"].update(seg_every=2)
    cfg["check"].update({"toy.votes_short": 0.2, "toy.votes_over": 0.01})
    (bench / "configs" / "toycfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "replay.json").write_text(json.dumps(base.traffic))
    (bench / "judges" / "toy.py").write_text(TOY_JUDGE)
    for name, expr in TOY_METRICS.items():
        (bench / "metrics" / f"{name}.py").write_text(
            f'LAYER = "toy"\nSOURCE = "program_span"\nMOVES = "fps"\nUNIT = "1"\n\n'
            f"def read(run):\n    return {expr}\n")
    shutil.copy(spec.BENCH_DIR / "metrics" / "frame_mfu.py", bench / "metrics")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toycfg", "file": "benchmark/configs/toycfg.json"}],
        "workloads": [{"name": "toycfg.replay", "config": "toycfg", "traffic": "replay",
                       "chips": 1}],
        "end_to_end": [{"name": "fps", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": n, "unit": "1"} for n in TOY_METRICS]
        + [{"name": "frame_mfu", "unit": "%"}],
    }))
    return spec.load_cell("toycfg.replay", root=tmp_path, bench_dir=bench)


@pytest.mark.parametrize("fault", [None, "altered"])
def test_a_model_needs_only_new_files(tmp_path, tiny, frame_clock, monkeypatch, fault):
    """A configuration with a model, its judge and its metrics runs a traced
    cell from new files alone and is correct; with every second
    segmentation emptied where the program takes it, it is not."""
    from instancefusion_tpu_torch.engine import slam

    if fault == "altered":
        real, fused = slam.fuse_segmentation, []

        def fuse(cfg, state, seg, depth, T):
            fused.append(1)
            if len(fused) % 2 == 0:
                seg = seg._replace(mask_id=torch.full_like(seg.mask_id, -1))
            return real(cfg, state, seg, depth, T)

        monkeypatch.setattr(slam, "fuse_segmentation", fuse)
    c = toy_checkout(tmp_path, tiny)
    assert list(c.judge_modules) == ["slam", "toy"]
    out = _cell.run_cell(c, 2**31 + 21, 1.49, True, "cpu", 0.0)
    assert out["attempted"] == 30  # 1.49 s at 0.05 s a frame
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["toy.segs"] == 15.0  # frames 0, 2, ..., 28
    assert m["toy.head_spans"] == 2.0  # frames 16 and 18 of the labelled trace
    assert m["frame_mfu"] > 0.0
    assert set(out["check"]) == {"pose_mm", "sdf_max", "weight_max", "color_max",
                                 "toy.votes_short", "toy.votes_over"}
    assert out["correct"] is (fault is None), json.dumps(out["check"])


def test_a_judge_without_its_file_is_an_error(tmp_path, tiny):
    bench = checkout(tmp_path)
    cfg = dict(tiny("config2.replay").config, judges=["slam", "absent"])
    (bench / "configs" / "c.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "t.json").write_text("{}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "c", "file": "benchmark/configs/c.json"}],
        "workloads": [{"name": "c.t", "config": "c", "traffic": "t", "chips": 1}],
        "end_to_end": [], "per_layer": []}))
    with pytest.raises(FileNotFoundError, match="absent"):
        spec.load_cell("c.t", root=tmp_path, bench_dir=bench)
