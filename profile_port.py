"""Where a frame's time goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_port.py [--frames N]

Runs the main path at the configuration chip_smoke.py uses (``bench.py``'s)
on the synthetic orbit, after 3 warm-up frames:

0. end to end: N frames of ``slam.step``, untraced, synchronized once at
   the end (wall ms per frame);
1. per layer: each stage of ``slam.step`` (preprocess, with K1 also timed
   alone, ICP, block allocation, slot list, integrate, splat prediction)
   called in turn through the port's public functions, with a
   device synchronize after each, so every stage's wall time is its own;
2. per kernel: ``torch.profiler`` over N more frames run by ``slam.step``
   unsynchronized, giving device time by kernel name (per frame and per
   launch), the number of device ops (kernel launches) per frame and the
   device's busy share of the window;
3. the instance path (chip_smoke.py's instance configuration, ground-truth
   masks on every frame): N frames of ``slam.step_seg`` untraced, then the
   stages of a segmented frame synchronized one by one (the packaged head
   at 640x480, the step, and ``fuse_segmentation`` split into mask
   refinement, predicted-id sampling, merges, association and the label
   vote: touched list + K7), then part 2 for ``slam.step_seg``, and the
   head alone (forward, forward with float64 GroupNorm statistics for
   comparison, grouping, the whole ``segment`` call);
4. the photometric path (chip_smoke.py's: ``rgb_weight`` 0.1, the drift
   sentinel and the stamps, on textured frames): N frames of ``slam.step``
   untraced, the stages of part 1 (the intensities inside preprocess, the
   photometric ICP, the splat with color) plus the stamps and the sentinel
   as stages of their own, and part 2;
5. the march path (chip_smoke.py's: the bench configuration without splat
   prediction): parts 0-2 with the map stages touched mask,
   ``allocate_touched``, touched list, association, K8 and the marched
   raycast;
6. the dense path (config1): parts 0-2 with the map stages integrate and
   raycast;
7. the pipeline (``pipeline.run``) on the sustained-drift rig
   (``check_accuracy_port.py`` PIPELINE=1's defaults, 120 frames) with
   every ``Timer`` phase synchronized at both ends, after one unmeasured
   run: per phase the median ms over the frames that ran it and the count,
   and the frames with a loop closure apart; then 12 frames of the
   instance path with ground-truth masks every 2nd frame for the
   segmentation phases.  ``--pipeline`` runs
   this part alone.

Prints a table per part, the card's name and power limit, and as its last
line one JSON object with every number.  To compare two trees, run each
tree's own copy in turns on one machine (parent, change, change, parent):
ms/frame varies widely from one machine and run to the next.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from chip_smoke import (bench_config, card_line, dense_config, instance_config,
                        march_config, rgb_config)
from instancefusion_tpu_torch.utils.metrics import Timer


def stages(cfg, state, frame):
    """One frame through slam.step's stages, timed one by one (ms); returns
    (times, the state after the frame).  With the photometric term the
    intensities are made in the preprocess stage and the prediction has
    color; with stamps or the sentinel each is a stage of its own.  The map
    stages follow the map kind (``splat_stages``, ``march_stages``)."""
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.ops import icp, preprocess
    from instancefusion_tpu_torch.ops.kernels import preprocess as kpre

    intr, out = cfg.intrinsics, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return result

    rgb = cfg.use_color and cfg.icp.rgb_weight > 0.0
    # K1 alone first; the preprocess stage (the whole pyramid) runs it again.
    timed("k1", lambda: kpre.fused_preprocess(frame.depth, intr, cfg.preprocess))

    def prep():
        i = preprocess.rgb_to_intensity(frame.color) if rgb else None
        pred_i = preprocess.rgb_to_intensity(state.pred.color) if rgb else None
        return preprocess.build_frame_pyramid(frame.depth, intr, cfg.preprocess,
                                              cfg.icp.levels, i), pred_i

    pyr, pred_i = timed("preprocess", prep)
    res = timed("icp", lambda: icp.track(
        pyr, state.pred.vertex_w, state.pred.normal_w, state.pred.valid,
        slam._motion_seed(state.T_wc, state.T_prev_wc, cfg.icp.vel_seed),
        state.pred_T_wc, intr, cfg.icp, pred_intensity=pred_i))
    T = res.T_wc
    d0 = pyr[0]["depth"]
    if cfg.map_kind == "blocks" and cfg.raycast.use_splat:
        vol, pred = splat_stages(cfg, state, frame, T, d0, rgb, timed)
    else:
        vol, pred = march_stages(cfg, state, frame, T, d0, rgb, timed)
    extra = {}
    if cfg.track_stamps:
        extra["stamp"] = timed("stamps", lambda: slam._update_stamps(
            cfg, state.stamp, vol, state.volume.n_active, T, res.valid, state.frame_idx))
    if cfg.consistency_check:
        cur, ewma, _, _ = timed("sentinel", lambda: slam._consistency_update(
            cfg, state, pyr, res, T))
        extra.update(prev_coarse=cur, drift_ewma=ewma)
    return out, state._replace(
        T_wc=T, volume=vol, pred=pred, pred_T_wc=T, T_prev_wc=state.T_wc,
        frame_idx=state.frame_idx + 1, frame_count=state.frame_count + 1, **extra)


def splat_stages(cfg, state, frame, T, d0, rgb, timed):
    """The splat path's map stages: allocation, slot list, K4, K5."""
    from instancefusion_tpu_torch.ops import blocks

    intr = cfg.intrinsics
    vol = timed("allocate", lambda: blocks.discover_allocate(
        state.volume, d0, T, intr, cfg.tsdf))
    k = min(cfg.tsdf.touched_capacity, blocks.num_blocks_per_axis(cfg.tsdf) ** 3)
    slots, valid = timed("slot_list", lambda: blocks.frustum_slots(
        vol, T, intr, cfg.tsdf, cfg.raycast.near, cfg.raycast.far, k))
    on = state.frame_count % cfg.color_every == 0
    vol = timed("integrate", lambda: blocks.integrate_slots(
        vol, slots, valid, d0, frame.color if on else None, T, intr, cfg.tsdf,
        color_gain=float(cfg.color_every) if on else 1.0))
    pred = timed("splat_predict", lambda: blocks.raycast_splat(
        vol, T, intr, cfg.tsdf, slots, valid, with_color=rgb or cfg.raycast.predict_color,
        depth_prior=d0, rmax=cfg.raycast.splat_rmax))
    return vol, pred


def march_stages(cfg, state, frame, T, d0, rgb, timed):
    """The map stages without splat prediction.  The block map: touched
    mask, ``allocate_touched``, the touched list, the association, K8, the
    marched raycast; the dense volume: integrate, raycast."""
    from instancefusion_tpu_torch.ops import blocks, raycast, tsdf
    from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf

    intr, tcfg = cfg.intrinsics, cfg.tsdf
    with_color = rgb or cfg.raycast.predict_color
    if cfg.map_kind != "blocks":
        vol = timed("integrate", lambda: tsdf.integrate(state.volume, d0, frame.color, T,
                                                        intr, tcfg))
        pred = timed("raycast", lambda: raycast.raycast(vol, T, intr, tcfg, cfg.raycast,
                                                        with_color=with_color))
        return vol, pred
    touched = timed("touched", lambda: blocks.touched_blocks_mask(d0, T, intr, tcfg))
    vol = timed("allocate_touched", lambda: blocks.allocate_touched(state.volume, touched,
                                                                    tcfg))
    k = min(tcfg.touched_capacity, blocks.num_blocks_per_axis(tcfg) ** 3)
    slots, valid = timed("slot_list", lambda: blocks.compact_touched_slots(vol, touched,
                                                                           tcfg, k))
    psi, w_obs, obs = timed("association", lambda: blocks.touched_observations(
        vol, slots, valid, d0, frame.color, T, intr, tcfg))
    timed("k8", lambda: ktsdf.tsdf_update(vol.sdf, vol.weight, vol.color, slots, valid,
                                          psi, w_obs, obs, tcfg.max_weight))
    prior = torch.where(d0 > 0.0, d0, state.pred.depth)
    pred = timed("march_raycast", lambda: blocks.raycast(
        vol, T, intr, tcfg, cfg.raycast, with_color=with_color,
        depth_prior=prior if cfg.raycast.use_depth_prior else None,
        screen_space_normals=cfg.raycast.screen_space_normals))
    return vol, pred


def instance_stages(cfg, state, frame, head):
    """One segmented frame's instance stages, timed one by one (ms); returns
    (times, the state after the frame)."""
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import instances as inst
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.models import segmentation as segm
    from instancefusion_tpu_torch.ops import labels

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return result

    k = cfg.instances.max_instances
    timed("head", lambda: segm.segment(head, frame.color, k))
    state, info = timed("step", lambda: slam.step(cfg, state, frame.depth, frame.color))
    depth = torch.where(info.track_ok, frame.depth, torch.zeros_like(frame.depth))
    seg = synthetic.gt_segmentation(frame.instance, k)
    seg = timed("refine", lambda: seg._replace(mask_id=labels.refine_mask_edges(
        seg.mask_id, depth, intr=cfg.intrinsics)))
    pred_gid = timed("sample", lambda: labels.sample_nearest(
        state.votes, state.volume, state.pred.vertex_w, state.pred.valid, cfg.tsdf))

    def merges():
        src, dst, ok = inst.find_merges(state.table, seg, pred_gid, cfg.instances)
        table = inst.apply_merges(state.table, src, dst, ok)
        merged = labels.merge_table(src, dst, ok, k)
        labels.relabel_votes(state.votes, merged)
        return table, labels.apply_table(merged, pred_gid)

    table, pred_gid = timed("merges", merges)
    gid, table = timed("associate", lambda: inst.associate(table, seg, pred_gid,
                                                           cfg.instances))
    votes = timed("label_vote", lambda: labels.fuse(
        state.votes, state.volume, gid, depth, state.T_wc, cfg.intrinsics, cfg.tsdf))
    return out, state._replace(votes=votes, table=table)


def head_times(head, rgb, k):
    """The head's ms per call, mean stream time by CUDA events: forward,
    forward with its GroupNorm statistics in float64 instead (for
    comparison), ``extract_instances`` alone, and ``segment``."""
    from unittest import mock

    import torch.nn.functional as F

    from chip_smoke import time_ms
    from instancefusion_tpu_torch.models import segmentation as segm

    def group_norm_float64(x, norm):
        return F.group_norm(x.double(), norm.num_groups, norm.weight.double(),
                            norm.bias.double(), norm.eps).to(x.dtype)

    with torch.no_grad():
        outs = head(rgb)
        out = {"forward": time_ms(lambda: head(rgb), 20)}
        with mock.patch.object(segm, "_group_norm", group_norm_float64):
            out["forward_gn_float64"] = time_ms(lambda: head(rgb), 20)
        out["extract_instances"] = time_ms(
            lambda: segm.extract_instances(*outs, k, center_thresh=-2.0), 20)
        out["segment"] = time_ms(lambda: segm.segment(head, rgb, k), 20)
    return out


def device_profile(step_fn, state, frames):
    """``torch.profiler`` over ``state = step_fn(state, frame)`` on `frames`,
    unsynchronized; returns the state and the window's device time by
    kernel name, busy share and device ops per frame."""
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            state = step_fn(state, f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (dev_us / 1e3 / n, ev.count / n)
    busy_ms = sum(ms for ms, _ in kernels.values()) * n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    return state, {
        "window_ms_per_frame": wall_ms / n, "device_busy_share": busy_ms / wall_ms,
        "device_ops_per_frame": sum(c for _, c in kernels.values()),
        "kernels": {k: {"ms_per_frame": v[0], "per_frame": v[1]} for k, v in top},
    }


def path_profile(cfg, T0, frames, warm, n):
    """Parts 0-2 for one configuration of ``slam.step`` over `frames` (warm
    + 3n): untraced ms/frame, median stage ms, and the device profile."""
    from instancefusion_tpu_torch.engine import slam

    state = slam.init_state(cfg, T0)
    for f in frames[:warm]:
        state, _ = slam.step(cfg, state, f.depth, f.color)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[warm:warm + n]:
        state, _ = slam.step(cfg, state, f.depth, f.color)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    per_stage = []
    for f in frames[warm + n:warm + 2 * n]:
        times, state = stages(cfg, state, f)
        per_stage.append(times)
    stage_ms = {k: sorted(s[k] for s in per_stage)[n // 2] for k in per_stage[0]}
    _, dev = device_profile(lambda st, f: slam.step(cfg, st, f.depth, f.color)[0], state,
                            frames[warm + 2 * n:])
    return step_ms, stage_ms, dev


def report_profile(name, prof, n):
    print(f"traced {name}: {n} frames at {prof['window_ms_per_frame']!r} ms/frame, "
          f"device busy {prof['device_busy_share']!r} of the window, "
          f"{prof['device_ops_per_frame']!r} device ops per frame")
    for kname, v in prof["kernels"].items():
        print(f"  {v['ms_per_frame']:10.4f} ms/frame  {v['per_frame']:7.1f}/frame  "
              f"{1e3 * v['ms_per_frame'] / v['per_frame']:9.2f} us/launch  {kname[:100]}")


class SyncedTimer:
    """``utils.metrics.Timer`` with a device synchronize at both ends of a
    phase, so a phase's ms is its own device work too."""

    def __init__(self) -> None:
        self.times_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def phase_medians(rows) -> dict:
    """Per ``t_<phase>_ms`` field: median ms over the frames that ran the
    phase and their count; keyframe frames with a loop closure apart."""
    out = {}
    for key in sorted({k for r in rows for k in r if k.startswith("t_")}):
        groups = {key: [r for r in rows if key in r]}
        if key == "t_keyframe_ms":
            groups = {"t_keyframe_ms (no loop)": [r for r in groups[key] if not r["loop_closed"]],
                      "t_keyframe_ms (loop closed)": [r for r in groups[key] if r["loop_closed"]]}
        for name, sel in groups.items():
            vals = sorted(r[key] for r in sel)
            if vals:
                out[name] = {"median_ms": vals[len(vals) // 2], "frames": len(vals)}
    return out


def pipeline_profile(card) -> dict:
    """Part 7: Timer's phases of ``pipeline.run`` on the drift rig and on 12
    instance frames, each phase synchronized."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.models.segmentation import PRETRAINED_SYNTHETIC

    out = {}
    pipeline.Timer = SyncedTimer
    try:
        cfg = cap.pipeline_config()
        poses, frames = cap.rig_frames(cfg, 120, True, 1.6, 0.02, seed=0)
        # A first run builds the kernels and meets every first call (the
        # solver's, torch.func's); the second is the one measured.
        cap.run_pipeline(cfg, frames, poses)
        res, rows, errs, fps = cap.run_pipeline(cfg, frames, poses)
        out["drift"] = {"phases": phase_medians(rows), "frames_per_s": fps,
                        "keyframes": res.n_keyframes, "loops": res.n_loops}
        icfg = instance_config(PRETRAINED_SYNTHETIC["num_classes"])
        icfg = dataclasses.replace(icfg, instances=dataclasses.replace(icfg.instances,
                                                                        seg_every=2))
        k = icfg.instances.max_instances
        ipos = synthetic.orbit_trajectory(12)
        iframes = [synthetic.render_frame(ipos[i], icfg.intrinsics) for i in range(12)]
        _, irows, _, ifps = cap.run_pipeline(
            icfg, iframes, ipos, segment_fn=lambda f: synthetic.gt_segmentation(f.instance, k))
        out["instance"] = {"phases": phase_medians(irows), "frames_per_s": ifps}
    finally:
        pipeline.Timer = Timer
    for name, part in out.items():
        print(f"pipeline, {name}: {part['frames_per_s']!r} frames/s with every phase "
              f"synchronized; phase medians: " + ", ".join(
                  f"{k} {v['median_ms']!r} ms ({v['frames']} frames)"
                  for k, v in part["phases"].items()) + f" [{card}]")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--pipeline", action="store_true", help="run part 7 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port.py needs an NVIDIA GPU")
    if args.pipeline:
        card = card_line()
        prof = pipeline_profile(card)
        print(card)
        print(json.dumps({"card": card, "pipeline": prof}))
        return
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import slam

    card = card_line()
    cfg = bench_config()
    warm, n = 3, args.frames
    poses = synthetic.orbit_trajectory(warm + 3 * n)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics)
              for i in range(warm + 3 * n)]
    # 0-2. untraced steps, stages, device profile.
    step_ms, stage_ms, main_dev = path_profile(cfg, poses[0], frames, warm, n)
    print(f"untraced slam.step: {step_ms!r} ms/frame over {n} frames")
    print(f"stages (median of {n} frames, each synchronized, ms): "
          + ", ".join(f"{k} {v!r}" for k, v in stage_ms.items())
          + f"; sum without k1 (inside preprocess) "
          f"{sum(v for k, v in stage_ms.items() if k != 'k1')!r}")
    report_profile("slam.step", main_dev, n)
    # 3. the instance path.
    from instancefusion_tpu_torch.datasets.synthetic import gt_segmentation
    from instancefusion_tpu_torch.models import segmentation as segm

    head = segm.load_pretrained()
    icfg = instance_config(head.num_classes)
    k = icfg.instances.max_instances
    istate = slam.init_state(icfg, poses[0])
    for f in frames[:warm]:
        istate, _ = slam.step_seg(icfg, istate, f.depth, f.color,
                                  gt_segmentation(f.instance, k))
    segs = [gt_segmentation(f.instance, k) for f in frames[warm:warm + n]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f, seg in zip(frames[warm:warm + n], segs):
        istate, _ = slam.step_seg(icfg, istate, f.depth, f.color, seg)
    torch.cuda.synchronize()
    seg_step_ms = (time.perf_counter() - t0) * 1e3 / n
    per_inst = []
    for f in frames[warm + n:warm + 2 * n]:
        times, istate = instance_stages(icfg, istate, f, head)
        per_inst.append(times)
    inst_ms = {k: sorted(s[k] for s in per_inst)[n // 2] for k in per_inst[0]}
    istate, inst_dev = device_profile(
        lambda st, f: slam.step_seg(icfg, st, f.depth, f.color,
                                    gt_segmentation(f.instance, k))[0],
        istate, frames[warm + 2 * n:])
    head_ms = head_times(head, frames[warm].color, k)
    print(f"untraced slam.step_seg (every frame segmented, GT masks): {seg_step_ms!r} "
          f"ms/frame over {n} frames")
    print(f"instance stages (median of {n} frames, each synchronized, ms): "
          + ", ".join(f"{k} {v!r}" for k, v in inst_ms.items()))
    print("head at 640x480 (ms per call, CUDA events over 20 calls): "
          + ", ".join(f"{k} {v!r}" for k, v in head_ms.items()))
    report_profile("slam.step_seg", inst_dev, n)
    # 4. the photometric path, with the sentinel and the stamps.
    rcfg = rgb_config()
    tex = [synthetic.render_frame(poses[i], cfg.intrinsics, texture=True)
           for i in range(warm + 3 * n)]
    rgb_step_ms, rgb_stage_ms, rgb_dev = path_profile(rcfg, poses[0], tex, warm, n)
    print(f"untraced slam.step, photometric path (rgb_weight {rcfg.icp.rgb_weight}, "
          f"sentinel, stamps): {rgb_step_ms!r} ms/frame over {n} frames")
    print(f"photometric stages (median of {n} frames, each synchronized, ms): "
          + ", ".join(f"{k} {v!r}" for k, v in rgb_stage_ms.items())
          + f"; sum without k1 {sum(v for k, v in rgb_stage_ms.items() if k != 'k1')!r}")
    report_profile("slam.step (photometric)", rgb_dev, n)
    # 5-6. the march path and the dense path.
    extra = {}
    for name, pcfg in (("march", march_config()), ("dense", dense_config())):
        p_step_ms, p_stage_ms, p_dev = path_profile(pcfg, poses[0], frames, warm, n)
        print(f"untraced slam.step, {name} path: {p_step_ms!r} ms/frame over {n} frames")
        print(f"{name} stages (median of {n} frames, each synchronized, ms): "
              + ", ".join(f"{k} {v!r}" for k, v in p_stage_ms.items())
              + f"; sum without k1 {sum(v for k, v in p_stage_ms.items() if k != 'k1')!r}")
        report_profile(f"slam.step ({name})", p_dev, n)
        extra.update({f"{name}_step_ms": p_step_ms, f"{name}_stage_ms": p_stage_ms,
                      f"{name}_step_profile": p_dev})
    # 7. the pipeline's phases.
    pipe = pipeline_profile(card)
    print(card)
    print(json.dumps({
        "card": card, "frames": n, "step_ms": step_ms, "stage_ms": stage_ms,
        "step_seg_ms": seg_step_ms, "instance_stage_ms": inst_ms, "head_ms": head_ms,
        "step_profile": main_dev, "step_seg_profile": inst_dev,
        "rgb_step_ms": rgb_step_ms, "rgb_stage_ms": rgb_stage_ms, "rgb_step_profile": rgb_dev,
        **extra, "pipeline": pipe,
    }))


if __name__ == "__main__":
    main()
