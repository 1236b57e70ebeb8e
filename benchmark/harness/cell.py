"""One run of one cell: set-up, the measured window through the program's
``engine.pipeline.run``, the traced reading, and the comparison with the
plain reference.  ``run.py`` is the command; tests call ``run_cell`` on the
CPU at a small size.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import sys
import time

import numpy as np
import torch

from harness import e2e, judge, scene, spec, traffic
from harness import trace as _trace

PACKAGE = "instancefusion_tpu_torch"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class LayerRun:
    """What a per-layer metric reads (``metrics/<name>.py``)."""
    engine: dict  # the configuration's engine settings
    trace: object  # harness.trace.Trace of the frames traced for the device alone
    traced_first: int  # the first of those frames
    traced_frames: int  # their number
    work: list  # counted work records of every frame of the window (harness.work)
    head_frames: int  # the window's first frames, run before any profiler
    head_s: float  # their host seconds: the first release to their completion


class Tracer:
    """The traced run's phases.  The window's first ``head_s`` seconds run
    untraced, before any profiler has run in the process: the frame's
    length that the per-layer metrics read.  Then, once the device has
    drained, ``device_frames`` frames run under a trace of device activity
    alone, which the metrics read, and ``label_frames`` under a trace of
    host and device activity, read only for the labels of the idle gaps;
    the rest of the window runs untraced and is read by nothing.  Each
    trace ends on a sync, so it holds its frames' whole device work."""

    def __init__(self, dev, head_s: float, device_frames: int, label_frames: int,
                 clock=time.perf_counter):
        self.dev, self.clock = dev, clock
        self.head_limit = head_s
        self.device_frames, self.label_frames = device_frames, label_frames
        self.prof = None
        self.phase = "head"
        self.t0 = None
        self.seen = 0
        self.head_frames = self.head_s = None
        self.first = None  # the first traced frame
        self.device = self.labelled = None  # harness.trace.Trace of each phase

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _start(self, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.dev.type == "cuda" else []
        if host or not acts:
            acts = [ProfilerActivity.CPU] + acts
        self.prof = profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function(_trace.WINDOW_START):
            pass

    def _stop(self, host: bool):
        """The phase's trace, reduced at once and its events let go.  A
        device-only trace on the card is bounded by its operations,
        elsewhere by the markers."""
        self._sync()
        with torch.profiler.record_function(_trace.WINDOW_END):
            pass
        self.prof.stop()
        marked = host or self.dev.type != "cuda"
        tr = _trace.reduce(self.prof.profiler.kineto_results.events(), marked=marked)
        self.prof = None
        gc.collect()
        return tr

    def _end_head(self, k: int) -> None:
        self._sync()
        self.head_frames, self.head_s = k, self.clock() - self.t0

    def on_frame(self, k: int) -> None:
        self.seen = k
        if k == 0:
            self.t0 = self.clock()
        if self.phase == "head" and self.clock() - self.t0 >= self.head_limit:
            self._end_head(k)
            self.first = k
            self._start(host=False)
            self.phase = "device"
        elif self.phase == "device" and k == self.first + self.device_frames:
            self.device = self._stop(host=False)
            self._start(host=True)
            self.phase = "labelled"
        elif self.phase == "labelled" and k == self.first + self.device_frames + \
                self.label_frames:
            self.labelled = self._stop(host=True)
            self.phase = "done"

    def on_end(self) -> None:
        if self.phase == "head":
            self._end_head(self.seen)
        elif self.phase == "device":
            self.device = self._stop(host=False)
        elif self.phase == "labelled":
            self.labelled = self._stop(host=True)


def host_state() -> dict:
    """What the host was doing: this process's CPU seconds and garbage
    collections, the machine's load, the cores' mean clock (where the system
    shows it)."""
    mhz = []
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except OSError:
        pass
    return {"cpu_s": time.process_time(), "gc": sum(g["collections"] for g in gc.get_stats()),
            "load1": os.getloadavg()[0], "mhz": sum(mhz) / len(mhz) if mhz else None}


def render_traffic(cell: spec.Cell, seed: int, dev):
    """The loop of the cell's traffic: (poses, depth int16, color uint8)."""
    t, assumed = cell.traffic, cell.config["assumed"]
    poses = scene.loop_poses(assumed["path_length_m"], assumed["speed_m_s"] / t["sensor_hz"],
                             dev)
    noise = t["noise"]
    depth, color = scene.render_loop(poses, cell.config["engine"]["intrinsics"], seed,
                                     noise=noise["model"] == "kinect",
                                     min_range_m=noise["min_range_m"],
                                     max_range_m=noise["max_range_m"])
    return poses, depth, color


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float) -> dict:
    """One run; returns the result line's object (``correct`` decided)."""
    pipeline = importlib.import_module(f"{PACKAGE}.engine.pipeline")
    pconfig = importlib.import_module(f"{PACKAGE}.config")
    pblocks = importlib.import_module(f"{PACKAGE}.ops.blocks")

    dev = torch.device(device)
    cfg = spec.build(pconfig.EngineConfig, cell.config["engine"])
    t = cell.traffic
    t_render = time.perf_counter()
    poses, depth, color = render_traffic(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_warm = time.perf_counter()
    run_kw = dict(T_init_wc=poses[0], enable_loops=bool(t["loops"]), device=dev)

    # Warm-up: every shape the window uses, outside the timed call.
    warm = [traffic.Frame(*scene.frame(depth, color, i), i) for i in range(t["warmup_frames"])]
    pipeline.run(cfg, warm, **run_kw)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pblocks.LIST_FILL.reset()
    log(f"set-up: {t_render - t_process!r} s to the render (imports, the kernels' build or "
        f"load), the loop's {depth.shape[0]} frames rendered in {t_warm - t_render!r} s, "
        f"the warm-up in {time.perf_counter() - t_warm!r} s")

    tracer = (Tracer(dev, t["trace_after_s"], t["trace_frames"], t["label_frames"])
              if trace else None)
    source = traffic.FrameSource(depth, color, t["mode"], seconds,
                                 on_frame=tracer.on_frame if tracer else None,
                                 on_end=tracer.on_end if tracer else None)
    host0 = host_state()
    res = pipeline.run(cfg, source, **run_kw)
    t_end = time.perf_counter()
    host1 = host_state()
    n = len(source.order)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = e2e.Window(t_process=t_process, t_first=source.t0, t_end=t_end, n_frames=n)
    fill = pblocks.LIST_FILL.read()
    vol = res.state.volume
    log(f"window: {n} frames in {t_end - source.t0!r} s, {res.n_keyframes} keyframes, "
        f"{res.n_loops} loops, {int(res.state.lost_frames)} frames lost, "
        f"{res.graph_replays} steps replayed from a CUDA graph")
    log(f"map: {int(vol.n_active)} of {cfg.tsdf.table_capacity} blocks allocated, "
        f"{int(vol.overflow)} dropped for lack of room; in-frustum lists of "
        f"{fill['length']}: the largest {fill['largest']} rows, {fill['dropped']} rows "
        f"dropped over the window ({fill['dropped'] / max(n, 1)!r} a frame)")
    log(f"memory: peak {mem_peak} bytes, of which the loop's frames "
        f"{depth.numel() * depth.element_size() + color.numel() * color.element_size()}")
    log(f"host over the window: {host1['cpu_s'] - host0['cpu_s']!r} CPU s of this process "
        f"in {t_end - source.t0!r} s, {host1['gc'] - host0['gc']} garbage collections, "
        f"load {host0['load1']!r} -> {host1['load1']!r}, {os.cpu_count()} cores at a mean "
        f"{host0['mhz']!r} -> {host1['mhz']!r} MHz")
    if n:
        edges = np.arange(0.0, seconds + 2.0, 2.0)
        counts = np.histogram(np.asarray(source.release) - source.t0, bins=edges)[0]
        log("frames released in each 2 s of the window: " + " ".join(map(str, counts)))

    served_poses = torch.as_tensor(res.poses, dtype=torch.float32, device=dev)
    if n:
        err = torch.linalg.norm(served_poses[:, :3, 3] - poses[source.order][:, :3, 3], dim=-1)
        log(f"trajectory against the loop's own poses: largest gap {float(err.max()) * 1e3!r} "
            f"mm (frame {int(err.argmax())}), at the last frame {float(err[-1]) * 1e3!r} mm")

    layer = None
    if trace:
        dtrace, labelled = tracer.device, tracer.labelled or tracer.device
        traced = 0 if dtrace is None else min(t["trace_frames"], n - tracer.first)
        log(f"untraced head: {tracer.head_frames} frames in {tracer.head_s!r} s "
            f"({tracer.head_frames / max(tracer.head_s, 1e-9)!r} frames/s); traced: {traced} "
            f"frames from frame {tracer.first} in "
            f"{dtrace.window_s if dtrace else 0.0!r} s of device activity alone")
        layer = LayerRun(engine=cell.config["engine"], trace=dtrace,
                         traced_first=tracer.first or 0, traced_frames=traced, work=[],
                         head_frames=tracer.head_frames, head_s=tracer.head_s)

    served = judge.Served(poses=served_poses, volume=vol, pred=res.state.pred)
    failed = int(res.state.lost_frames)
    del res, vol
    t_ref = time.perf_counter()
    numbers, work_recs = judge.replay(cell.config["engine"], depth, color, source.order, served,
                                      seed, t["pose_samples"], count_work=trace)
    log(f"reference: {time.perf_counter() - t_ref!r} s")
    correct, checked = judge.verdict(numbers, cell.config["check"])

    if trace:
        layer.work = work_recs
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_modules[m["name"]].read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e.METRICS[m["name"]](window), "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": bool(correct), "attempted": n, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if trace and dtrace is not None:
        out["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        out["breakdown"] = _trace.breakdown(dtrace, labelled)
    others = {k: v for k, v in numbers.items() if k not in checked}
    log("readings without a limit: " + " ".join(f"{k} {v!r}" for k, v in others.items()))
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checked.items()}
    return out
