"""Check that the PyTorch/CUDA port builds, runs and is right on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA Hopper
card and the CUDA toolkit.  It imports nothing of JAX or of
``instancefusion_tpu``.  Phases:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of every kernel under ``instancefusion_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. the main path at the configuration ``bench.py`` times (TUM fr1 640x480,
   512^3 block map, table 65536, 2048 listed blocks, ICP (10,5,4) with
   association every (2,2,4), color every 4th frame, splat prediction
   without color, the fused preprocess): 3 warm-up frames and 30 timed
   frames in chunks of 6 on the synthetic orbit.  Every frame must track,
   the ATE must stay below the voxel size, and each kernel's launch count
   must rise by its expected count per frame;
4. the instance path (config3's instance fusion on that geometry, 96
   instance slots, the packaged head's 5 classes) over the same 33 frames,
   every 2nd frame through ``slam.step_seg`` with the frame's ground-truth
   masks: tracking, ATE and launch counts as above, K7 once per segmented
   frame, a populated instance table, and the fused labels read back at
   the final prediction must cover and agree with the ground truth;
5. the photometric path: the bench configuration with ``rgb_weight`` 0.1,
   the drift sentinel (``consistency_check``) and the observation stamps
   (``track_stamps``) over the same 33 poses rendered with texture:
   tracking, ATE and launch counts as above (K2 and K3 12 a frame, 9 of
   them with the photometric planes; K5 with color), no sentinel alarm, a
   non-zero photometric weight, and stamps that end at the last frame with
   no revisit evidence;
6. the march path: the bench configuration without splat prediction (the
   touched-block integrate with K8, then the marched raycast with the depth
   prior and screen-space normals) over the same 33 frames: tracking, ATE
   below the voxel size and launch counts (K8 once a frame, K4 and K5
   never), and the touched-block count of each frame against the list
   length K;
7. the dense path: config1 (TUM fr1 640x480, 128^3 dense volume of 25 mm
   voxels) over the same 33 frames: tracking, ATE below the voxel size and
   launch counts (K1 once and K2 and K3 19 times a frame, no other kernel),
   with its peak memory;
8. the local loop: the photometric path's final state aged (every fused
   slot seen 200 frames ago, frame 300) and its pose drifted by a fixed
   twist; the last frame's ``localloop.attempt`` must pull the pose back to
   the tracked one, and ``reset_gaps`` must consume the evidence;
9. each kernel against its plain PyTorch version, on inputs taken from the
   port's own state at those configurations, with times of the kernel (its
   call time by CUDA events and its device time by ``torch.profiler``), the
   plain version and, where one PyTorch call does the same work, that call
   (K2, the whole association of a level, exactly at levels 0-2 with and
   without the photometric planes, beside the parent's split association;
   K1 also at bilateral radii 5 and 8; K3, with and without the photometric
   planes, timed at 1, 2 and the level's steps, each call one device
   launch; K4 on a depth-only and a color frame and K7, each bit-equal to
   its plain version on every voxel of the valid rows with every other row
   untouched, each call one device launch and no other device op; K5 with
   color, its screen-tile walk and a bit-identical second call, K6 (one
   device launch a call and a bit-identical second call), and K8 (bit-equal to its plain version with and
   without color, timed with the L2 flushed before each call, its bound
   counted from the bytes the plain run must move) on the march path's last
   state and the next frame's association, among them; no kernel may launch
   while a plain version is timed);
10. the packaged segmentation head at 640x480 on the card, held against the
   same head on the CPU: outputs, the grouping of the same outputs, and the
   whole segmentation on frames whose grouping does not hinge on tied
   heatmap peaks; then one ``step_seg`` on a head segmentation;
11. the accuracy bar (``check_accuracy_port.py``'s bare engine at the bench
   geometry): the clean 512^3 orbit and the noisy fr1-mean rig (sweep 0.8,
   shake 0.012/0.008, Kinect noise from a ``torch.Generator`` seeded 0),
   40 frames each, held to ``_check_ate512.py``'s assert (largest
   translation error below 20 mm clean, 30 mm noisy), the means printed
   beside the JAX package's on a TPU v5e (6.3 and 9.3 mm);
12. ``pipeline.run`` on the sustained-drift rig (120 frames, sweep 1.6,
   shake 0.02, noise seed 0, keyframes every 8, the sentinel on, the
   posegraph defaults), after the bare engine on the same frames: every
   frame a pose, at least one verified loop, no relocalization, and launch
   counts (K1 on every frame and keyframe, K2 and K3 12 a frame and 8 a
   loop verification); the forced keyframes and both mean errors are
   printed beside the JAX package's own run on the CPU
   (``python -m tests.torch_helpers``); then the forced path alone: the same
   configuration at alarm threshold 0 with keyframes every 100th frame
   over the main path's 33 frames must force keyframes and never
   relocalize (tests/test_pipeline.py:298's run);
13. ``pipeline.run`` over 12 frames of the instance path with
   ground-truth masks every 2nd frame: each segmentation fused on the next
   frame (the last after the loop), K7 once per fused segmentation, a
   populated table; then K2 and K3 at the loop-verification shape (the
   first verified loop's keyframe maps, 160x120, and the current frame
   decimated by 4), K2 bit-identical to its plain version and K3 (one step
   a call) within its pose tolerance, timed like the others;
14. the sequence runner: ``cli.main`` on a TUM-format fixture written by the
   port's PNG encoder (the synthetic orbit at config2's intrinsics, 20 poses
   out and the same 20 back, 16-bit depth at 1/5000 m, rgb 5 ms after the
   depth at 30 Hz, the ground truth) at config2's full width (TUM fr3
   640x480, 512^3 block map of 1 cm voxels, table 65536, splat prediction)
   with loops and active-window streaming every 4th frame (the radius
   chosen from the fixture's block-centre distances, printed): every frame
   tracked, ATE below the voxel, blocks streamed out and back in, K1-K5 at
   least their count a frame; again without streaming (ATE below the
   voxel); every block of that final map with distinct votes and stamps
   out to the host store and back, bit for bit, ``n_active`` and
   ``overflow`` unchanged; the exported mesh (>= 95% of its vertices within
   a voxel of the scene), a rendered view read back by the port's decoder
   (> 50% shaded), the trajectory read back within 1e-6; and ``cli.main``
   with ``--instances --seg-head gt`` on 12 synthetic frames (K7 launched,
   >= 3 instance PLYs).  It prints the decoder used, the frames/s with
   decode, the stream phase's ms, the mesh and render ms and the PNG decode
   ms a frame;
15. the sharded map: 8 ranks on the card over gloo (one ``RankPool``; the
   kernels are built before the ranks start).  (a) config4 at full width
   (TUM fr3 640x480, 512^3 grid of 2 cm voxels, table 65536 = 8 x 8192
   rows, splat prediction) through ``slam_sharded.step`` over 3 + 30 frames
   of the orbit, against the one-card engine with ``num_shards=1`` on the
   same frames: every frame tracked, ATE below the voxel, the final pose
   within half a voxel, allocation sets equal within 2% + 2 blocks,
   coverage within 10%, rows on at least 2 shards (test_shard_engine.py's
   bounds), every rank's pose, directory and n_active equal to rank 0's on
   every frame, and each rank's launches (K1 1, K2 and K3 9, K4 and K5 1 a
   frame, all with color); (b) the marched halo raycast of that map against
   the one-card marched raycast of the same map gathered; (c) the drift rig
   of phase 12 through ``pipeline.run`` with 8 shards: a finite pose every
   frame, a verified loop, the ranks' poses equal, and the sharded Schur
   terms equal to the unsharded ``paired_terms`` within 1e-5 relative (in
   fp64; the fp32 rounding of both is printed); (d) ``cli.main run --preset
   config4 --shards 8`` on phase 14's fixture with loops, streaming, a
   reshard poll every 4th frame (each reshard checked to keep the block set
   and one directory entry per live row), exports from rank 0, a checkpoint
   at frame 20 and a resume from it.  It prints ms a frame against the
   one-card run, the collectives' calls, bytes and ms a frame, peak memory
   per rank, the backend, the halo rows per seam and each rank's decode ms;
   the runs of (d) must repeat bit for bit and the resumed run must equal
   the uninterrupted one bit for bit;
16. whether the card repeats itself, the segmentation head's training and
   its parallel forms.  (a) Each op twice on the same inputs, compared bit
   for bit (``repeat_phase``): K5 with and without color on the main
   path's list, ``optimize_hybrid_paired`` on phase 12's first loop
   problem, ``engine/instances``' merges and ``associate`` and the whole
   ``fuse_segmentation`` on phase 4's state, and ``cli.main run --preset
   config2`` on phase 14's fixture; all must agree.  (b)
   ``models/train_seghead.train`` on the card, 300 steps at the packaged
   head's width on the reference trainer's data: the loss must fall below
   half its first value, the first 3 steps must equal the CPU's from the
   same weights within 1e-4, a second run must repeat the first bit for
   bit, the checkpoint must reload to the fp16-rounded head, the packaged
   weights must stay unchanged; steps/s at each size, peak memory and the
   held-out accuracy are printed.  (c) ``models/parallel``'s DP and TP over
   8 ranks (phase 15's pool) with the packaged head at 640x480 on 8 of
   phase 10's stable frames, against the main process's one-rank
   ``segment``: the head's outputs on every rank bit-identical to the main
   process's, DP equal, TP's mask_id and classes equal and its scores
   within 1e-4; ms a call and the collectives' calls, bytes and ms.  (d) The record of (a) beside the
   same measurement on the parent tree (REPEAT_BEFORE);
17. config5 (1024^3 of 2 cm voxels, table 131072 = 8 x 16384 rows,
   instances), on phase 15's pool: ``cli.main run --preset config5 --shards
   8 --instances --seg-head trained`` on phase 14's fixture with loops and
   streaming: every frame tracked, ATE below the voxel, every rank's poses,
   segmentations and instance table equal to rank 0's, K7 launched on
   every rank, trajectory, mesh and
   instance models exported; peak memory per rank printed.

``python3 chip_smoke.py --repeat`` runs the card, the build and phase 16
(a) alone on inputs it makes itself, and prints what differs.

Any failed check exits non-zero.  The second-to-last line is the card's
name and power limit, the line before it a JSON record per kernel (with
``sharded_launches_per_rank``, its launches on a rank in phase 15 (a)),
and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# Per-pixel fp32 operations of one Gauss-Newton step on a gated pixel
# (pose transform 33, residual and gates 20, Jacobian 9, 27 sums x 2).
GN_FLOPS_PER_PIXEL = 116
# Per-pixel fp32 operations of K1: 25 bilateral taps of ~8 (difference,
# two products, exponent, weighted sums) and ~60 for the vertex, the
# central differences, the cross product and its normalization.
PREPROCESS_FLOPS_PER_PIXEL = 260
# Per-pixel fp32 operations of the photometric half of a GN step: the
# prediction-camera transform 18, projection gradient 8, rotation back 15,
# residual 1, cross product 9, 27 sums x 3.
RGB_FLOPS_PER_PIXEL = 132
# Per-pixel fp32 operations of K6 on a masked pixel: residual 8, Huber
# weight 4, Jacobian 9, 27 sums x 3, the mask and |r| w sums 3.
NE_FLOPS_PER_PIXEL = 105
# Per-voxel fp32 operations of K7: center 6, transform 18, projection 8,
# rounding and gates ~8.
VOTE_FLOPS_PER_VOXEL = 40
# Per-voxel fp32 operations of K8's running average: weights 4, sdf blend 5,
# clamp 1, color denominator 3, three color blends of 4.
TSDF_UPDATE_FLOPS_PER_VOXEL = 25
# K8's bytes as the earlier bound counted them, printed beside the count of
# what it must move: psi and w_obs of every listed voxel (8); where w_obs >
# 0, sdf and weight read and written (16) and three color floats read and
# written and three observations read (36).  It missed the valid voxels
# that w_obs = 0 rewrites (tsdf_update_record counts them from the plain run).
TSDF_UPDATE_OBSERVED_ONLY_BYTES = (8, 52)
WARMUP, TIMED, CHUNK = 3, 30, 6
PER_FRAME = {"K1": 1, "K2": 9, "K3": 9, "K4": 1, "K5": 1}
# The photometric path: 9 association rounds with the rgb planes and 3
# geometric ones of the sentinel a frame; the splat predicts color.
RGB_PER_FRAME = {"K1": 1, "K2": 12, "K3": 12, "K4": 1, "K5": 1,
                 "K2rgb": 9, "K3rgb": 9, "K5color": 1}
# The march path: the touched-block integrate (K8) and the marched raycast.
MARCH_PER_FRAME = {"K1": 1, "K2": 9, "K3": 9, "K8": 1}
# The dense path (config1): ICP iters (10, 5, 4) with association every
# step, 19 association rounds a frame; the dense map runs no kernel.
DENSE_PER_FRAME = {"K1": 1, "K2": 19, "K3": 19}
# The drift injected before the local loop, on the left of the tracked pose.
DRIFT_XI = (0.02, -0.015, 0.01, 0.008, -0.006, 0.01)
HEAD_FRAMES = 3
# The accuracy bar's runs (_check_ate512.py's N), the drift rig's
# (_check_drift_pipeline.py's N) and the instance pipeline's.
ACCURACY_FRAMES, DRIFT_FRAMES, INSTANCE_PIPELINE_FRAMES = 40, 120, 12
# The sequence runner's fixture: the orbit's poses out, then back; the
# streaming cadence and the candidate radii (m) of its active window.
SEQ_POSES, STREAM_EVERY = 20, 4
STREAM_RADII = (2.2, 2.3, 2.4, 2.5, 2.6, 2.7, 2.8)
# Blocks the replayed policy must bring back at the chosen radius.
STREAM_MIN_IN = 20
# A frame's head segmentation is held end to end against the CPU's where it
# survives HEAD_TRIALS perturbations of the outputs by up to HEAD_EPS, above
# the card's largest difference from the CPU (1.4e-5, on the logits).
HEAD_EPS, HEAD_TRIALS = 2e-5, 3
REPLACES = {
    "K1": "instancefusion_tpu/ops/pallas/preprocess.py:123 fused_preprocess",
    "K2": "instancefusion_tpu/ops/pallas/icp.py:218 gather_target_maps (with the jnp "
          "association around it, instancefusion_tpu/ops/icp.py:48 associate)",
    "K3": "instancefusion_tpu/ops/pallas/icp.py:565 gn_iterations",
    "K4": "instancefusion_tpu/ops/pallas/tsdf.py:356 fused_integrate_groups "
          "(and :252 fused_integrate)",
    "K4color": "instancefusion_tpu/ops/pallas/tsdf.py:356 fused_integrate_groups "
               "(and :252 fused_integrate), with_color",
    "K5": "instancefusion_tpu/ops/pallas/raycast.py:319 splat_depth_groups "
          "(and :581 splat_depth)",
    "K7": "instancefusion_tpu/ops/pallas/tsdf.py:478 fused_label_vote",
    "K2rgb": "instancefusion_tpu/ops/pallas/icp.py:218 gather_target_maps "
             "(tgt_rgb planes, :137-151, :187-196; with the jnp association, "
             "instancefusion_tpu/ops/icp.py:48 associate)",
    "K3rgb": "instancefusion_tpu/ops/pallas/icp.py:565 gn_iterations "
             "(rgb sums and trust-fraction combine, :388-434, :449-466)",
    "K6": "instancefusion_tpu/ops/pallas/icp.py:652 reduce_normal_equations",
    "K5color": "instancefusion_tpu/ops/pallas/raycast.py:319 splat_depth_groups "
               "(and :581 splat_depth), with_color",
    "K8": "instancefusion_tpu/ops/pallas/tsdf.py:61 fused_tsdf_update",
    "K2loop": "instancefusion_tpu/ops/pallas/icp.py:218 gather_target_maps (with the jnp "
              "association, instancefusion_tpu/ops/icp.py:48 associate), as "
              "instancefusion_tpu/engine/posegraph.py:182-212 verify_loop runs it",
    "K3loop": "instancefusion_tpu/ops/pallas/icp.py:565 gn_iterations, as "
              "instancefusion_tpu/engine/posegraph.py:182-212 verify_loop runs it",
}
SOURCES = {"K1": "instancefusion_tpu_torch/csrc/preprocess.cu",
           "K2": "instancefusion_tpu_torch/csrc/icp.cu",
           "K3": "instancefusion_tpu_torch/csrc/icp.cu",
           "K4": "instancefusion_tpu_torch/csrc/tsdf.cu",
           "K4color": "instancefusion_tpu_torch/csrc/tsdf.cu",
           "K5": "instancefusion_tpu_torch/csrc/raycast.cu",
           "K7": "instancefusion_tpu_torch/csrc/labels.cu",
           "K2rgb": "instancefusion_tpu_torch/csrc/icp.cu",
           "K3rgb": "instancefusion_tpu_torch/csrc/icp.cu",
           "K6": "instancefusion_tpu_torch/csrc/icp.cu",
           "K5color": "instancefusion_tpu_torch/csrc/raycast.cu",
           "K8": "instancefusion_tpu_torch/csrc/tsdf.cu",
           "K2loop": "instancefusion_tpu_torch/csrc/icp.cu",
           "K3loop": "instancefusion_tpu_torch/csrc/icp.cu"}
# The __global__ functions of each kernel, whose device time the profiler
# sums for the kernel's device_ms.
DEVICE_KERNELS = {"K1": ("preprocess_kernel",), "K2": ("associate_kernel",),
                  "K2rgb": ("associate_kernel",), "K3": ("gn_kernel",),
                  "K3rgb": ("gn_kernel",),
                  "K4": ("integrate_kernel",), "K4color": ("integrate_kernel",),
                  "K5": ("splat_votes_kernel", "splat_tiles_kernel"),
                  "K5color": ("splat_votes_kernel", "splat_tiles_kernel"),
                  "K6": ("ne_kernel",),
                  "K7": ("label_vote_kernel",), "K8": ("tsdf_update_kernel",),
                  "K2loop": ("associate_kernel",), "K3loop": ("gn_kernel",)}
NAMES = {"K1": "fused_preprocess", "K2": "associate_gather",
         "K3": "gn_iterations", "K4": "integrate", "K4color": "integrate[color]",
         "K5": "splat_planes",
         "K7": "label_vote", "K2rgb": "associate_gather[rgb]",
         "K3rgb": "gn_iterations[rgb]", "K6": "normal_equations",
         "K5color": "splat_planes[color]", "K8": "tsdf_update",
         "K2loop": "associate_gather[loop 160x120]", "K3loop": "gn_iterations[loop 160x120]"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, between=None) -> float:
    """Mean stream time of one call, by CUDA events over `reps` calls; with
    `between` (e.g. an L2 flush), that runs before each call, outside the
    events around it."""
    fn()
    torch.cuda.synchronize()
    if between is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    pairs = []
    for _ in range(reps):
        between()
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def l2_flush():
    """A function that evicts the card's 50 MB L2: it writes 256 MB."""
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def bench_config():
    from instancefusion_tpu_torch.config import (
        EngineConfig, IcpConfig, PreprocessConfig, RaycastConfig, TsdfConfig,
    )
    from instancefusion_tpu_torch.geometry.camera import TUM_FR1

    grid = 512
    extent = grid * 0.0075
    return EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(
            voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
            grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
            block_size=8, table_capacity=65536, touched_capacity=2048,
            use_pallas=True,
        ),
        icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0, use_pallas=True,
                      assoc_every=(2, 2, 4)),
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True, use_splat=True,
                              predict_color=False),
        preprocess=PreprocessConfig(use_pallas=True),
        map_kind="blocks", use_color=True, color_every=4,
    )


def march_config():
    """The bench configuration without splat prediction: the touched-block
    integrate (K8) and the marched raycast, with the bench's depth prior and
    screen-space normals."""
    cfg = bench_config()
    return dataclasses.replace(cfg, raycast=dataclasses.replace(cfg.raycast, use_splat=False))


def dense_config():
    """config1: TUM fr1 640x480, a 128^3 dense volume of 25 mm voxels."""
    from instancefusion_tpu_torch.config import config1_tum_fr1_desk

    return config1_tum_fr1_desk()


def instance_config(num_classes: int):
    """The bench geometry with config3's instance fusion (96 slots)."""
    from instancefusion_tpu_torch.config import InstanceConfig

    return dataclasses.replace(bench_config(), use_instances=True,
                               instances=InstanceConfig(num_classes=num_classes))


def rgb_config():
    """The bench configuration with the photometric term at weight 0.1 (the
    weight the TPU's photometric bench ran), the drift sentinel and the
    observation stamps."""
    cfg = bench_config()
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, rgb_weight=0.1),
                               consistency_check=True, track_stamps=True)


def step(cfg, state, frame, seg=None):
    """One ``slam.step`` (``slam.step_seg`` with a segmentation), failing if
    anything in it waits for the device."""
    from instancefusion_tpu_torch.engine import slam

    torch.cuda.set_sync_debug_mode("error")
    try:
        if seg is None:
            return slam.step(cfg, state, frame.depth, frame.color)
        return slam.step_seg(cfg, state, frame.depth, frame.color, seg)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def stepped_frames(res, n: int) -> int:
    """Frames of an n-frame ``pipeline.run`` whose step called the kernel
    wrappers: the eager frames and the capture of the step's one CUDA graph
    (``color_every`` 1); a replay launches the kernels without a call, and
    the wrappers do not count it."""
    return n - res.graph_replays + int(res.graph_replays > 0)


def launch_counts() -> dict:
    """Each kernel's launch count, and those of the photometric variants of
    K2 and K3 and the color variants of K4 and K5."""
    from instancefusion_tpu_torch.ops import kernels

    fns = kernels.wrappers()
    out = {k: fn.launches for k, fn in fns.items()}
    out.update(K2rgb=fns["K2"].launches_rgb, K3rgb=fns["K3"].launches_rgb,
               K4color=fns["K4"].launches_color, K5color=fns["K5"].launches_color)
    return out


def run_path(cfg, frames, poses, card, name, seg_every=0, per_frame=PER_FRAME):
    """Drive one path over `frames` with every check; every `seg_every`-th
    frame (from frame 0) goes through ``slam.step_seg`` with its ground-truth
    masks when `seg_every` is set.  Each kernel (and variant) must launch
    `per_frame` times a frame (K7 once a segmented frame, K4color once a
    color frame of a path that runs K4, K6 and unlisted variants never).
    Returns the final state, the launch counts of the run, the per-frame
    ``StepInfo``s and, with the photometric term, each frame's trust-
    fraction weight of its last photometric K3 launch."""
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.ops import kernels
    from instancefusion_tpu_torch.ops.kernels import icp as kicp
    from instancefusion_tpu_torch.utils.ate import ate_rmse

    n = WARMUP + TIMED
    segs = [synthetic.gt_segmentation(f.instance, cfg.instances.max_instances)
            if seg_every and i % seg_every == 0 else None for i, f in enumerate(frames)]
    n_seg = sum(seg is not None for seg in segs)
    rgb = cfg.icp.rgb_weight > 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state = slam.init_state(cfg, poses[0])
    infos, est, wr = [], [], []

    def run(i0, i1):
        nonlocal state
        for f, seg in zip(frames[i0:i1], segs[i0:i1]):
            state, info = step(cfg, state, f, seg)
            infos.append(info)
            est.append(state.T_wc)
            if rgb:
                wr.append(kicp.gn_iterations.last_wr)

    t0 = time.perf_counter()
    run(0, WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunk_ms = []
    t_all = time.perf_counter()
    for i in range(WARMUP, n, CHUNK):
        t0 = time.perf_counter()
        run(i, i + CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / len(frames[i:i + CHUNK]))
    timed_s = time.perf_counter() - t_all
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    ok = torch.stack([info.track_ok for info in infos]).cpu().numpy()
    ate = ate_rmse(torch.stack(est).cpu().numpy(), poses[:n].cpu().numpy())
    fps = TIMED / timed_s
    print(f"{name}: {n} frames ({n_seg} segmented; {WARMUP} warm-up in {warm_s!r} s), "
          f"{fps!r} frames/s, {1e3 / fps!r} ms/frame (per chunk of {CHUNK}: "
          f"{chunk_ms!r}), peak memory {peak_gib!r} GiB, ATE {ate * 1e3!r} mm, "
          f"launches {launches} [{card}]", flush=True)
    check(ok.all(), f"{name}: tracking failed on frames {np.flatnonzero(~ok).tolist()}")
    check(ate < cfg.tsdf.voxel_size, f"{name}: ATE {ate} >= voxel {cfg.tsdf.voxel_size}")
    # Color fuses on every color_every-th frame, from frame 0 (slam.py).
    n_color = sum(i % max(cfg.color_every, 1) == 0 for i in range(n)) if cfg.use_color else 0
    expect = {k: 0 for k in launches}
    expect.update({k: per * n for k, per in per_frame.items()}, K7=n_seg,
                  K4color=n_color if "K4" in per_frame else 0)
    for k, count in expect.items():
        check(launches[k] == count,
              f"{name}: {k} launched {launches[k]} times, expected {count}")
    return state, launches, infos, wr


def photometric_checks(cfg, state, infos, wr):
    """No sentinel alarm on any frame of the clean run, a non-zero median
    photometric weight, and stamps that end at the last frame with no
    revisit evidence in view."""
    from instancefusion_tpu_torch.engine import localloop

    alarms = torch.stack([info.drift_alarm for info in infos]).cpu().numpy()
    ewma = torch.stack([info.drift_ewma for info in infos]).cpu().numpy()
    wr = torch.stack(wr).cpu().numpy()
    last_max, frame_idx = int(state.stamp[:, 0].max()), int(state.frame_idx)
    evidence = int(localloop.evidence_count(cfg, state))
    print(f"photometric path: sentinel EWMA max {float(ewma.max())!r} m (threshold "
          f"{cfg.consistency_thresh}), alarms on {int(alarms.sum())} frames; trust-"
          f"fraction weight wr median {float(np.median(wr))!r} (min {float(wr.min())!r}, "
          f"max {float(wr.max())!r}); stamps: largest last {last_max}, frame_idx "
          f"{frame_idx}, {int((state.stamp[:, 0] > 0).sum())} stamped slots, "
          f"evidence_count {evidence}", flush=True)
    check(not alarms.any(), f"sentinel alarm on frames {np.flatnonzero(alarms).tolist()}")
    check(float(np.median(wr)) > 0.0, "the photometric term had weight 0")
    check(last_max == frame_idx, f"largest stamp {last_max} != frame_idx {frame_idx}")
    check(evidence == 0, f"revisit evidence {evidence} on a clean run")


def local_loop_phase(cfg, state, frame, card):
    """Age the state (every fused slot last seen 200 frames ago, frame 300),
    drift its pose by DRIFT_XI on the left of the tracked pose of `frame`,
    and register `frame` (K1 on its depth, level 0) against the inactive
    view: ``attempt`` must succeed, recover the translation to within 0.25x
    the drift and the rotation to 0.01 rad of the tracked pose, and
    ``reset_gaps`` must leave no evidence."""
    from instancefusion_tpu_torch.engine import localloop
    from instancefusion_tpu_torch.geometry.se3 import se3_exp
    from instancefusion_tpu_torch.ops import preprocess

    T_track = state.T_wc.clone()
    xi = torch.tensor(DRIFT_XI, dtype=torch.float32, device=T_track.device)
    T_drift = se3_exp(xi) @ T_track
    gap = torch.where(state.stamp[:, 0] > 0, 200, 0).to(torch.int32)
    aged = state._replace(stamp=torch.stack([state.stamp[:, 0], gap], -1),
                          frame_idx=torch.full_like(state.frame_idx, 300), T_wc=T_drift)
    lvl = preprocess.build_frame_pyramid(frame.depth, cfg.intrinsics, cfg.preprocess, 1)[0]
    before = int(localloop.evidence_count(cfg, aged))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = localloop.attempt(cfg, aged, lvl["vmap"], lvl["nmap"], lvl["valid"])
    ok = bool(res.ok)
    ms = (time.perf_counter() - t0) * 1e3
    T = res.T_corr_wc.double()
    err_t = float(torch.linalg.norm(T[:3, 3] - T_track[:3, 3].double()))
    drift_t = float(torch.linalg.norm(T_drift[:3, 3] - T_track[:3, 3]))
    chord = float(torch.linalg.norm(T[:3, :3] - T_track[:3, :3].double())) / (2 * 2 ** 0.5)
    err_r = 2.0 * float(np.arcsin(min(chord, 1.0)))
    after = int(localloop.evidence_count(
        cfg, aged._replace(stamp=localloop.reset_gaps(aged.stamp, cfg.posegraph.local_window))))
    print(f"local loop: ok {ok}, inactive view {float(res.pred_pixels)!r} px, inliers "
          f"{float(res.inliers)!r}; injected drift {drift_t * 1e3!r} mm, after the loop "
          f"{err_t * 1e3!r} mm and {err_r!r} rad from the tracked pose; evidence "
          f"{before} before reset_gaps, {after} after; attempt {ms!r} ms [{card}]",
          flush=True)
    check(ok, "localloop.attempt failed")
    check(err_t < 0.25 * drift_t, f"local loop left {err_t} m of a {drift_t} m drift")
    check(err_r < 0.01, f"local loop left {err_r} rad")
    check(before > 0 and after == 0, f"evidence {before} before, {after} after reset_gaps")


def instance_checks(cfg, state, frame):
    """The instance table is populated and the labels fused into the map,
    read back at the final prediction, cover more than 30% of the view and
    agree with the ground truth above 0.9 under the majority id mapping."""
    from instancefusion_tpu_torch.ops import labels

    table = state.table
    n_active, n_match = int(table.active.sum()), int(table.matches.sum())
    overflow = int(table.overflow)
    pred_gid = labels.sample_nearest(state.votes, state.volume, state.pred.vertex_w,
                                     state.pred.valid, cfg.tsdf).cpu().numpy()
    gt = frame.instance.cpu().numpy()
    ok = (pred_gid >= 0) & (gt >= 0) & state.pred.valid.cpu().numpy()
    agree = 0
    for g in np.unique(pred_gid[ok]):
        agree += np.unique(gt[ok & (pred_gid == g)], return_counts=True)[1].max()
    coverage, accuracy = float(ok.mean()), float(agree / max(ok.sum(), 1))
    print(f"instance table: {n_active} active rows, {n_match} matches, overflow "
          f"{overflow}; fused labels at the final prediction: coverage {coverage!r}, "
          f"accuracy {accuracy!r} (majority mapping)", flush=True)
    check(n_active >= 3, f"only {n_active} active instance rows")
    check(n_match > 0, "no mask matched an instance")
    check(overflow == 0, f"instance table overflowed by {overflow}")
    check(coverage > 0.3, f"labels cover only {coverage} of the view")
    check(accuracy > 0.9, f"labels agree with the ground truth on only {accuracy}")


def grouping_stable(outs, k, seg) -> bool:
    """Whether the grouping `seg` of the head outputs `outs` survives
    HEAD_TRIALS seeded uniform perturbations of the outputs by up to
    HEAD_EPS: mask_id equal on >= 99.9% of pixels, classes and validity
    equal.  Where the heatmap holds plateaus of tied peak scores it does
    not: which peaks are kept, and in what order, then hinges on
    differences below the card's rounding."""
    from instancefusion_tpu_torch.models import segmentation as segm

    gen = torch.Generator(device=outs[0].device)
    for trial in range(HEAD_TRIALS):
        gen.manual_seed(trial)
        noisy = [x + HEAD_EPS * (2 * torch.rand(x.shape, generator=gen, device=x.device) - 1)
                 for x in outs]
        alt = segm.extract_instances(*noisy, k, center_thresh=-2.0)
        if not (float((alt.mask_id == seg.mask_id).float().mean()) >= 0.999
                and torch.equal(alt.classes, seg.classes)
                and torch.equal(alt.valid, seg.valid)):
            return False
    return True


def head_phase(cfg, state, frames, next_frame, card):
    """The packaged head on the card against the same head on the CPU, then
    one ``step_seg`` on a head segmentation of `next_frame`; returns the
    head's ms per call and the frames whose grouping is stable.

    The card's outputs must be within 1e-3 of the CPU's, and the grouping of
    the same outputs must agree on both, on every frame compared.  The card's
    segmentation must equal the CPU head's own (mask_id on >= 99.5% of
    pixels, classes and validity) on HEAD_FRAMES frames whose grouping is
    stable (``grouping_stable``); on the first unstable frame the same
    comparison is printed, not held."""
    from instancefusion_tpu_torch.models import segmentation as segm

    k = cfg.instances.max_instances
    head = segm.load_pretrained()
    head_cpu = segm.load_pretrained(device="cpu")
    stable = []
    with torch.no_grad():
        for i, f in enumerate(frames):
            outs = head(f.color)
            if grouping_stable(outs, k, segm.extract_instances(*outs, k, center_thresh=-2.0)):
                stable.append(i)
    print(f"head: grouping stable under output perturbations of up to {HEAD_EPS} on "
          f"{len(stable)} of {len(frames)} frames: {stable}", flush=True)
    check(len(stable) >= HEAD_FRAMES, f"head grouping stable on only {len(stable)} frames")
    picks = [stable[j] for j in np.linspace(0, len(stable) - 1, HEAD_FRAMES).round().astype(int)]
    unstable = [i for i in range(len(frames)) if i not in stable]
    for i in picks + unstable[:1]:
        rgb = frames[i].color
        with torch.no_grad():
            outs = head(rgb)
            refs = head_cpu(rgb.cpu())
        errs = [(a.cpu() - b).abs().max().item() for a, b in zip(outs, refs)]
        # Grouping held on identical head outputs: on the card and on the CPU.
        seg = segm.extract_instances(*outs, k, center_thresh=-2.0)
        ref = segm.extract_instances(*(x.cpu() for x in outs), k, center_thresh=-2.0)
        same = float((seg.mask_id.cpu() == ref.mask_id).float().mean())
        # End to end: the CPU head's own segmentation.
        own = segm.segment(head_cpu, rgb.cpu(), k)
        same_e2e = float((seg.mask_id.cpu() == own.mask_id).float().mean())
        cls_e2e = torch.equal(seg.classes.cpu(), own.classes)
        valid_e2e = torch.equal(seg.valid.cpu(), own.valid)
        gated = i in picks
        print(f"head on frame {i} ({'stable, held' if gated else 'unstable, printed'}): "
              f"sem/center/offset max abs err vs CPU {errs}; grouping of the same "
              f"outputs on the CPU: mask_id equal on {same!r}, {int(ref.valid.sum())} "
              f"instances; CPU head end to end: mask_id equal on {same_e2e!r}, classes "
              f"equal {cls_e2e}, valid equal {valid_e2e}, {int(seg.valid.sum())} vs "
              f"{int(own.valid.sum())} instances", flush=True)
        check(max(errs) <= 1e-3, f"head outputs differ from the CPU head by {errs}")
        check(same >= 0.995, f"grouping mask_id equal on only {same} of pixels")
        check(torch.equal(seg.classes.cpu(), ref.classes)
              and torch.equal(seg.valid.cpu(), ref.valid),
              "grouping classes or validity differ from the CPU")
        if gated:
            check(same_e2e >= 0.995 and cls_e2e and valid_e2e,
                  f"frame {i}: the card's segmentation differs from the CPU head's "
                  f"(mask_id equal on {same_e2e}, classes {cls_e2e}, valid {valid_e2e})")
    rgb = next_frame.color
    head_ms = time_ms(lambda: segm.segment(head, rgb, k), 10)
    print(f"head: {head_ms!r} ms per segment call at {tuple(rgb.shape[:2])} "
          f"(forward + extract_instances, K={k}) [{card}]", flush=True)
    seg = segm.segment(head, rgb, k)
    state, info = step(cfg, state, next_frame, seg)
    check(bool(info.track_ok), "step_seg on a head segmentation failed to track")
    check(bool(torch.isfinite(state.table.score).all()), "non-finite instance scores")
    print(f"step_seg on a head segmentation: tracked, {int(seg.valid.sum())} masks, "
          f"{int(state.table.active.sum())} active rows", flush=True)
    return head_ms, stable


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: the larger of bytes over the memory rate and
    fp32 operations over the fp32 peak; returns (ms, what bounds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def band_reads(coords, slots, valid, depth, T_wc, intr, tcfg):
    """Per voxel of the valid listed rows: camera depth z, pixel index,
    whether the pixel is in view, and the depth there (the projective
    association that K4 and K7 make)."""
    from instancefusion_tpu_torch.ops.kernels.tsdf import project_voxels

    z, pix, seen = project_voxels(coords, slots[valid], T_wc, intr, tcfg)
    return z, pix, seen, depth.reshape(-1)[pix]


def n_distinct(pix, mask) -> int:
    return int(torch.unique(pix[mask]).numel())


def kernel_times(k, fn, reps: int, between=None):
    """A kernel's call time (``time_ms``: stream time per call, host gaps
    included), its device time per call (``torch.profiler``'s device time of
    the kernel's ``__global__`` functions, DEVICE_KERNELS, over `reps` more
    calls) and its device launches per call (the profiler's count of those
    functions), and all its device ops per call (kernels, copies and fills
    of any name).  The difference of the two times is the host's share of
    a call."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(fn, reps, between)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    pattern = re.compile(r"\b(" + "|".join(DEVICE_KERNELS[k]) + r")\b")
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA and pattern.search(ev.key)]
    dev_us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in events)
    check(dev_us > 0.0, f"{k}: the profiler saw no device time of {DEVICE_KERNELS[k]}")
    ops = sum(ev.count for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA)
    return ms, dev_us / 1e3 / reps, sum(ev.count for ev in events) / reps, ops / reps


def check_one_op(k, times) -> None:
    """Fail unless each call of `k` was one launch of its kernel and no
    other device op (``kernel_times``' counts).  The profiler may miss an
    event at its window's edge, never add one."""
    launches, ops = times[2], times[3]
    check(round(launches) == 1 and launches <= 1.0 and ops <= 1.0,
          f"{k}: {launches} launches and {ops} device ops a call, expected 1 and 1")


def record(k, launches, err, times, plain_ms, n_bytes, n_flops, library_ms, note):
    """A kernel's record; `times` is ``kernel_times``' (call ms, device ms,
    device launches per call)."""
    ms, dev_ms, dev_launches = times[:3]
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    rec = {"name": NAMES[k], "route": "cuda", "source": SOURCES[k],
           "replaces": REPLACES[k], "launches": launches[k],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
           "device_ms": dev_ms, "device_launches_per_call": dev_launches}
    print(f"{k} {NAMES[k]}: kernel_ms {ms!r} device_ms {dev_ms!r} ({dev_launches!r} device "
          f"launches a call) plain_ms {plain_ms!r} "
          f"library_ms {library_ms!r} bound_ms {b_ms!r} ({b_by}) max_abs_err {err!r}; "
          f"{note}", flush=True)
    return rec


def plain_time_ms(fn, reps: int) -> float:
    """`time_ms` of a plain version, failing if any kernel launched in it (K6
    among them while the plain K3 runs)."""
    before = launch_counts()
    ms = time_ms(fn, reps)
    check(launch_counts() == before, "a plain version launched a kernel")
    return ms


def splat_record(k, cfg, slots, valid, coords, maps, T, d0, with_color, launches):
    """K5 against its plain version on the listed blocks of `maps` (sdf,
    weight, color) at pose T, with or without color."""
    from instancefusion_tpu_torch.ops.kernels import raycast as kray

    intr, rmax = cfg.intrinsics, cfg.raycast.splat_rmax
    hw, b3 = intr.height * intr.width, cfg.tsdf.block_size ** 3
    sargs = (slots, valid, coords, *maps, T, intr, cfg.tsdf, with_color, rmax)
    planes_k = kray.splat_planes(*sargs)
    planes_r = kray.splat_planes_ref(*sargs)
    img_k = kray.finish_splat_images(planes_k, intr, cfg.tsdf, with_color, d0)
    img_r = kray.finish_splat_images(planes_r, intr, cfg.tsdf, with_color, d0)
    xor = int((img_k.valid ^ img_r.valid).sum())
    n_vr = int(img_r.valid.sum())
    both = img_k.valid & img_r.valid
    err = (img_k.depth - img_r.depth)[both].abs().max().item()
    rel = ((planes_k - planes_r).abs().amax((1, 2))
           / planes_r.abs().amax((1, 2)).clamp(min=1e-30)).tolist()
    check(xor < 0.01 * max(n_vr, 1), f"{k} valid sets differ on {xor} of {n_vr}")
    check(err < 1e-3, f"{k} depth differs by {err} (>= 1e-3)")
    note = ""
    if with_color:
        col_err = (img_k.color - img_r.color)[both].abs().max().item()
        check(col_err < 5e-3, f"{k} color differs by {col_err} (>= 5e-3)")
        note = f"color max err {col_err!r} where both valid (tolerance 5e-3); "
    taps = list(kray.splat_taps_ref(*sargs))
    flat_all = torch.cat([t[0] for t in taps])
    contrib_all = torch.cat([t[1] for t in taps], 1)
    n_taps = int(flat_all.shape[0])
    nch = planes_k.shape[0]
    acc = torch.zeros((nch, hw), device=planes_k.device)
    del taps
    n_valid = int(valid.sum())
    box, kept = kray.footprint_boxes(slots, valid, coords, maps[0], maps[1], T, intr,
                                     cfg.tsdf, rmax)
    tiles = kray.tile_counts(box, intr).flatten()
    again = kray.splat_planes(*sargs)
    check(torch.equal(again, planes_k), f"{k}: a second call on the same inputs differs")
    print(f"{k} tiles: {int((valid & ~kept).sum())} of the {n_valid} valid listed blocks "
          f"dropped (straddling the camera plane); (tile, block) pairs walked "
          f"{int(tiles.sum())} over {tiles.numel()} tiles of {kray.TILE}x{kray.TILE}, "
          f"most on a tile {int(tiles.max())}, median {float(tiles.float().median())!r}; "
          f"a second call bit-identical", flush=True)
    walk = {"dropped": int((valid & ~kept).sum()), "pairs": int(tiles.sum()),
              "most_on_a_tile": int(tiles.max())}
    return record(
        k, launches, err,
        kernel_times(k, lambda: kray.splat_planes(*sargs), 50),
        plain_time_ms(lambda: kray.splat_planes_ref(*sargs), 5),
        slots.shape[0] * 5 + n_valid * 12 + n_valid * b3 * 4 * (2 + (3 if with_color else 0))
        + nch * hw * 4,
        n_taps * (2.0 * nch + 8.0),
        time_ms(lambda: acc.index_add_(1, flat_all, contrib_all), 20),
        f"K={slots.shape[0]} listed, {n_valid} valid slots (tiles {walk}), rmax={rmax}, "
        f"{n_taps} tent taps, {nch} planes; valid XOR {xor} of {n_vr}, plane max rel err "
        f"{rel}; {note}"
        f"tolerance: valid XOR < 1%, depth < 1e-3 m where both valid; library = one "
        f"index_add_ of the precomputed taps",
    )


def bit_equal_rows(out_k, out_r, before, rows) -> tuple[int, int]:
    """How many elements of the valid `rows` differ bit for bit between a
    kernel's output and its plain version's, and how many elements of the
    other rows either of them changed."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    other = torch.ones(before.shape[0], dtype=torch.bool, device=before.device)
    other[rows] = False
    diff = int((bits(out_k[rows]) != bits(out_r[rows])).sum())
    moved = int(((bits(out_k[other]) != bits(before[other]))
                 | (bits(out_r[other]) != bits(before[other]))).sum())
    return diff, moved


def integrate_record(k, cfg, vol, slots, valid, d0, frame_color, T, gain, launches):
    """K4 (or K4color) against its plain version on the listed blocks of
    `vol`: sdf, weight and color bit-equal on every voxel of the valid
    rows, every other row untouched, and one device op a call.  Returns
    the record and the kernel's updated (sdf, weight, color)."""
    from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf

    intr, tcfg = cfg.intrinsics, cfg.tsdf
    before = [vol.sdf, vol.weight, vol.color]
    maps_k = [x.clone() for x in before]
    maps_r = [x.clone() for x in before]
    integ = (slots, valid, d0, frame_color, T, intr, tcfg, gain)
    ktsdf.integrate(vol.block_coords, *maps_k, *integ)
    ktsdf.integrate_ref(vol.block_coords, *maps_r, *integ)
    rows = slots[valid].long()
    n_valid = int(rows.shape[0])
    check(int(torch.unique(rows).numel()) == n_valid, f"{k}: valid slots repeat")
    diffs = [bit_equal_rows(a, b, x, rows) for a, b, x in zip(maps_k, maps_r, before)]
    err = max((a[rows] - b[rows]).abs().max().item() for a, b in zip(maps_k, maps_r))
    check(all(d == (0, 0) for d in diffs),
          f"{k}: (differing voxels, changed voxels of other rows) of sdf/weight/color "
          f"{diffs}, expected all 0")
    b3 = tcfg.block_size ** 3
    planes = 3 if frame_color is not None else 2  # tensors: sdf, weight (, color)
    floats = 5 if frame_color is not None else 2  # payload floats a voxel
    # Bytes this frame needs: the list, the valid rows' coordinates and the
    # pose; every valid row's sdf and weight (and color) read, since an
    # unobserved voxel's sdf is rewritten as (s w) / w; the voxels whose
    # value changes written; depth at the pixels the voxels project to,
    # color at the pixels where they fuse.
    changed = sum(int((a[rows].view(torch.int32) != x[rows].view(torch.int32)).sum())
                  for a, x in zip(maps_r[:planes], before[:planes]))
    z, pix, seen, dz = band_reads(vol.block_coords, slots, valid, d0, T, intr, tcfg)
    fused = seen & (dz > 0.0) & (dz - z > -tcfg.trunc)
    n_fused = int(fused.sum())
    col_px = n_distinct(pix, fused) * 12 if frame_color is not None else 0
    n_bytes = (slots.shape[0] * 5 + n_valid * 12 + 64 + n_valid * b3 * 4 * floats
               + changed * 4 + n_distinct(pix, seen) * 4 + col_px)
    # The payload read and written at the voxels that fuse only, as this
    # bound was counted before K4 was held bit for bit.
    fused_bytes = (slots.shape[0] * 5 + n_valid * 12 + 64 + n_fused * 4 * 2 * floats
                   + n_distinct(pix, seen) * 4 + col_px)
    bench_maps = [m.clone() for m in maps_k]
    times = kernel_times(k, lambda: ktsdf.integrate(vol.block_coords, *bench_maps, *integ),
                         100)
    check_one_op(k, times)
    rec = record(
        k, launches, err, times,
        plain_time_ms(lambda: ktsdf.integrate_ref(vol.block_coords, *bench_maps, *integ), 10),
        n_bytes, 40.0 * n_valid * b3, None,
        f"K={slots.shape[0]} listed, {n_valid} valid slots x {b3} voxels, {n_fused} fuse, "
        f"{changed} elements of sdf/weight{'/color' if planes == 3 else ''} change, "
        f"{'color' if frame_color is not None else 'depth-only'} frame (gain {gain}); "
        f"bit-equal to the plain version on every voxel of the valid rows, other rows "
        f"untouched (tolerance: exact); {times[3]!r} device ops a call; bound counting "
        f"the fused voxels' payload only {bound_ms(fused_bytes, 0.0)[0]!r} ms; library: none",
    )
    return rec, maps_k


def gn_times(k, args, kw):
    """``kernel_times`` of K3 (or K3rgb) at 1, 2 and the call's own
    ``inner_n`` steps, by step count; fails unless every call is one device
    launch (gn_kernel runs all its steps in one cooperative launch)."""
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    out = {}
    for m in sorted({1, 2, kw["inner_n"]}):
        mkw = dict(kw, inner_n=m)
        out[m] = kernel_times(k, lambda: kicp.gn_iterations(*args, **mkw), 200)
        # The profiler may miss a launch at its window's edge (it saw 199 of
        # 200 once), never add one: one launch a call rounds to 1, at most 1.
        check(round(out[m][2]) == 1 and out[m][2] <= 1.0,
              f"{k} at inner_n={m}: {out[m][2]} device launches a call, expected 1")
    return out


def ne_times(call):
    """``kernel_times`` of K6; fails unless every call is one device launch
    and no other device op, and a second call gives the same bits as the
    first."""
    first, second = call(), call()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "K6: a second call differs from the first")
    out = kernel_times("K6", call, 200)
    check_one_op("K6", out)
    return out


def gn_steps_note(times) -> str:
    return "call/device ms by inner_n: " + ", ".join(
        f"{m}: {t[0]!r}/{t[1]!r}" for m, t in times.items()) + " (one device launch a call)"


def association_levels(cfg, state, pyr, rgb: bool):
    """K2's arguments at each level of the source pyramid `pyr` against the
    state's prediction: the level's source maps, the state's pose and
    prediction view, the level's intrinsics, the full-resolution
    prediction, the stride and, with `rgb`, the level's photometric planes
    (the prediction's intensity decimated, with its gradients)."""
    from instancefusion_tpu_torch.geometry.se3 import se3_inverse
    from instancefusion_tpu_torch.ops import icp, preprocess
    from instancefusion_tpu_torch.ops.common import decimate

    pred = state.pred
    T_cw = se3_inverse(state.pred_T_wc)
    tgt = [x.contiguous() for x in (pred.vertex_w, pred.normal_w, pred.valid)]
    out = []
    for lvl, src in enumerate(pyr):
        planes = None
        if rgb:
            ti = decimate(preprocess.rgb_to_intensity(pred.color), 1 << lvl).contiguous()
            planes = (ti, *icp.intensity_gradients(ti))
        out.append((src["vmap"].reshape(-1, 3).contiguous(),
                    src["valid"].reshape(-1).contiguous(), state.T_wc.contiguous(), T_cw,
                    cfg.intrinsics.level(lvl), *tgt, 1 << lvl, planes))
    return out


def split_association(src_v, src_ok, T_wc, T_cw, intr, tv, tn, tval, stride, planes):
    """One association as the parent tree ran it, device op by device op:
    the two ``transform_points`` products, the projection, the rounding and
    the in-image test, the decimated target copies, the gather and the K3
    gate.  The gather is the plain one here (its CUDA route is gone)."""
    from instancefusion_tpu_torch.geometry.camera import project
    from instancefusion_tpu_torch.geometry.se3 import transform_points
    from instancefusion_tpu_torch.ops.common import decimate
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    u, v, z = project(intr, transform_points(T_cw, transform_points(T_wc, src_v)))
    uf, vf = torch.ceil(u - 0.5), torch.ceil(v - 0.5)
    sel = src_ok & (uf >= 0) & (uf < intr.width) & (vf >= 0) & (vf < intr.height) & (z > 0.0)
    tgt = [decimate(x, stride).contiguous() for x in (tv, tn, tval)]
    out = kicp.gather_target_maps_ref(u.contiguous(), v.contiguous(), sel, *tgt, planes)
    return out, (src_ok & out[2]).float()


def association_record(k, levels, launches):
    """K2 (fused association) against its plain version at every level of
    `levels` (``association_levels``): every output equal, bit for bit.
    Timed at level 0 with its library yardstick (the gather alone, by
    precomputed flat indices into a (HW, 7 or 10) table, as in PRs 1-4);
    each level's call time beside the parent's split association there."""
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    per_level = []
    for lvl, args in enumerate(levels):
        out, ref = kicp.associate_gather(*args), kicp.associate_gather_ref(*args)
        pairs = list(zip(out[:4], ref[:4])) + (list(zip(out.rgb, ref.rgb)) if out.rgb else [])
        n_diff = sum(int((a != b).sum()) for a, b in pairs)
        check(n_diff == 0, f"{k} level {lvl}: {n_diff} values differ from the plain version "
                           f"({int((out.ok != ref.ok).sum())} ok)")
        per_level.append((lvl, int(out.ok.numel()), int(out.ok.sum()),
                          time_ms(lambda: kicp.associate_gather(*args), 200),
                          plain_time_ms(lambda: split_association(*args), 50)))
    args = levels[0]
    src_v, _, _, _, intr, tv, tn, tval, _, planes = args
    out = kicp.associate_gather(*args)
    n, hw = src_v.shape[0], intr.height * intr.width
    u, v, _ = kicp.association_inputs(src_v, args[1], args[2], args[3], intr)
    flat = (torch.ceil(v - 0.5).clamp(0, intr.height - 1).long() * intr.width
            + torch.ceil(u - 0.5).clamp(0, intr.width - 1).long())
    nplanes = 0 if planes is None else 3
    table = torch.cat([tv.reshape(-1, 3), tn.reshape(-1, 3), tval.reshape(-1, 1).float()]
                      + ([] if planes is None else [p.reshape(-1, 1) for p in planes]), 1)
    # Bytes: source vertex and validity, the two poses, each distinct target
    # pixel's vertex, normal and validity (and planes), the outputs q, n_t,
    # gate, ok (and the gathered planes).
    n_bytes = n * 13 + 128 + n_distinct(flat, flat >= 0) * (25 + 4 * nplanes) \
        + n * (29 + 4 * nplanes)
    levels_note = "; ".join(
        f"level {lvl}: N={npx}, {nok} associated, kernel {ms!r} ms, parent's split path "
        f"{split!r} ms" for lvl, npx, nok, ms, split in per_level)
    return record(
        k, launches, 0.0,
        kernel_times(k, lambda: kicp.associate_gather(*args), 200),
        plain_time_ms(lambda: kicp.associate_gather_ref(*args), 50),
        n_bytes, 0.0, time_ms(lambda: table[flat], 200),
        f"target {intr.height}x{intr.width}{', 3 photometric planes' if planes else ''}; "
        f"levels 0-{len(levels) - 1} bit-identical to the plain version (0 differing "
        f"values, 0 differing ok); {levels_note}; split path = transform_points x2, "
        f"projection, in-image test, decimated .contiguous() copies, plain gather, gate "
        f"(the parent's association with the gather plain); library = advanced indexing "
        f"of a (HW, {7 + nplanes}) target table by precomputed flat indices",
    )


def kernel_phase(cfg, state, frame, launches):
    """Each kernel against its plain version on inputs from the port's state
    after the main path and one more frame; returns the kernel records."""
    from instancefusion_tpu_torch.ops import blocks, icp, preprocess
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    intr = cfg.intrinsics
    pyr = preprocess.build_frame_pyramid(frame.depth, intr, cfg.preprocess, cfg.icp.levels)
    src = pyr[0]
    recs = []

    # K2 at levels 0-2 from the last pose against the last prediction,
    # timed at level 0 (640x480).
    levels = association_levels(cfg, state, pyr, rgb=False)
    recs.append(association_record("K2", levels, launches))
    a = kicp.associate_gather(*levels[0])
    q_k, n_k, ok_k = a.q_w, a.n_t, a.ok

    # K3 at level 0 on those correspondences.
    inner_n, _ = icp.level_schedule(cfg.icp, 0)
    gate = (src["valid"].reshape(-1) & ok_k).float()
    src_v = src["vmap"].reshape(-1, 3).contiguous()
    src_n = src["nmap"].reshape(-1, 3).contiguous()
    n = src_v.shape[0]
    kw = dict(inner_n=inner_n, dist_thresh=cfg.icp.dist_thresh,
              angle_thresh=cfg.icp.angle_thresh, huber_delta=cfg.icp.huber_delta,
              damping=cfg.icp.damping, min_valid=cfg.icp.min_valid)
    args = (src_v, src_n, q_k, n_k, gate, state.T_wc)
    T_k, nin_k, rs_k = kicp.gn_iterations(*args, **kw)
    T_r, nin_r, rs_r = kicp.gn_iterations_ref(*args, **kw)
    err = (T_k - T_r).abs().max().item()
    nin_k, nin_r = float(nin_k), float(nin_r)
    check(err < 5e-5, f"K3 pose differs from its plain version by {err} (> 5e-5)")
    check(abs(nin_k - nin_r) <= 1e-3 * max(nin_r, 1.0),
          f"K3 inliers {nin_k} vs plain {nin_r}")
    n_gate = float(gate.sum())
    times = gn_times("K3", args, kw)
    recs.append(record(
        "K3", launches, err, times[inner_n],
        plain_time_ms(lambda: kicp.gn_iterations_ref(*args, **kw), 50),
        n * (4 * 12 + 4) + 64 + 72, GN_FLOPS_PER_PIXEL * n_gate * inner_n, None,
        f"N={n}, {n_gate} gated, inner_n={inner_n}, inliers {nin_k} vs {nin_r}, "
        f"res {float(rs_k)!r} vs {float(rs_r)!r}; {gn_steps_note(times)}; tolerance: "
        f"pose 5e-5",
    ))

    # K4 on the frame's band blocks, at the frame's own pose: a depth-only
    # frame (three in four on the main path) and a color frame.
    T = frame.T_wc
    d0 = src["depth"]
    vol = blocks.discover_allocate(state.volume, d0, T, intr, cfg.tsdf)
    k = min(cfg.tsdf.touched_capacity, blocks.num_blocks_per_axis(cfg.tsdf) ** 3)
    slots, valid = blocks.frustum_slots(vol, T, intr, cfg.tsdf,
                                        cfg.raycast.near, cfg.raycast.far, k)
    recs.append(integrate_record("K4", cfg, vol, slots, valid, d0, None, T, 1.0,
                                 launches)[0])
    rec, maps_k = integrate_record("K4color", cfg, vol, slots, valid, d0, frame.color, T,
                                   float(cfg.color_every), launches)
    recs.append(rec)

    # K5 on the integrated map, as the main path runs it (no color).
    recs.append(splat_record("K5", cfg, slots, valid, vol.block_coords, maps_k, T, d0,
                             cfg.use_color and cfg.raycast.predict_color, launches))
    return recs


def rgb_kernel_phase(cfg, state, frame, last, launches):
    """K2 and K3 with the photometric planes and K6 at level 0 of `frame`
    against the photometric path's final state and prediction, and K5 with
    color on that state's in-view blocks at its pose with `last` (the
    path's last frame) as the depth prior; returns the kernel records."""
    from instancefusion_tpu_torch.geometry.se3 import se3_inverse
    from instancefusion_tpu_torch.ops import blocks, icp, preprocess
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    intr, icfg = cfg.intrinsics, cfg.icp
    pyr = preprocess.build_frame_pyramid(frame.depth, intr, cfg.preprocess, icfg.levels,
                                         preprocess.rgb_to_intensity(frame.color))
    src = pyr[0]
    T_cw = se3_inverse(state.pred_T_wc)
    recs = []

    # K2 with the photometric planes, levels 0-2, timed at level 0.
    levels = association_levels(cfg, state, pyr, rgb=True)
    recs.append(association_record("K2rgb", levels, launches))
    out_k = kicp.associate_gather(*levels[0])

    # K3 with the photometric term, on those correspondences.
    q_k, n_k, ok_k, _, (i_t, gx_t, gy_t) = out_k
    inner_n, _ = icp.level_schedule(icfg, 0)
    gate = (src["valid"].reshape(-1) & ok_k).float()
    rgb_gate = ok_k.float()
    src_v = src["vmap"].reshape(-1, 3).contiguous()
    src_n = src["nmap"].reshape(-1, 3).contiguous()
    n = src_v.shape[0]
    kw = dict(inner_n=inner_n, dist_thresh=icfg.dist_thresh,
              angle_thresh=icfg.angle_thresh, huber_delta=icfg.huber_delta,
              damping=icfg.damping, min_valid=icfg.min_valid,
              rgb=(src["intensity"].reshape(-1).contiguous(), i_t, gx_t, gy_t, rgb_gate),
              T_pred_cw=T_cw, rgb_intr=(intr.fx, intr.fy), rgb_weight=icfg.rgb_weight)
    args = (src_v, src_n, q_k, n_k, gate, state.T_wc)
    T_k, nin_k, rs_k = kicp.gn_iterations(*args, **kw)
    wr_k = float(kicp.gn_iterations.last_wr)
    T_r, nin_r, rs_r = kicp.gn_iterations_ref(*args, **kw)
    err = (T_k - T_r).abs().max().item()
    nin_k, nin_r = float(nin_k), float(nin_r)
    check(err < 5e-5, f"K3rgb pose differs from its plain version by {err} (> 5e-5)")
    check(abs(nin_k - nin_r) <= 1e-3 * max(nin_r, 1.0),
          f"K3rgb inliers {nin_k} vs plain {nin_r}")
    check(wr_k > 0.0, f"K3rgb trust-fraction weight {wr_k}")
    n_gate, n_rgb = float(gate.sum()), float(rgb_gate.sum())
    times = gn_times("K3rgb", args, kw)
    recs.append(record(
        "K3rgb", launches, err, times[inner_n],
        plain_time_ms(lambda: kicp.gn_iterations_ref(*args, **kw), 50),
        n * 18 * 4 + 3 * 64 + 12,
        (GN_FLOPS_PER_PIXEL * n_gate + RGB_FLOPS_PER_PIXEL * n_rgb) * inner_n, None,
        f"N={n}, {n_gate} gated, {n_rgb} photometric, inner_n={inner_n}, inliers "
        f"{nin_k} vs {nin_r}, res {float(rs_k)!r} vs {float(rs_r)!r}, wr {wr_k!r}; 18 "
        f"floats a pixel read once; {gn_steps_note(times)}; tolerance: pose 5e-5, "
        f"inliers 1e-3 relative; library: none",
    ))

    # K6: the normal equations of one linearization at that pose.
    R, t = state.T_wc[:3, :3], state.T_wc[:3, 3]
    p_w = (src_v @ R.T + t).contiguous()
    n_w = src_n @ R.T
    dist = torch.linalg.norm(p_w - q_k, dim=-1)
    mask = (gate.bool() & (dist < icfg.dist_thresh)
            & (torch.sum(n_w * n_k, dim=-1) > icfg.angle_thresh)).float()
    delta = icfg.huber_delta
    ne_k = kicp.normal_equations(p_w, n_k, q_k, mask, delta)
    ne_r = kicp.normal_equations_ref(p_w, n_k, q_k, mask, delta)
    errs = [(a - b).abs().max().item() for a, b in zip(ne_k, ne_r)]
    check(all(torch.allclose(a, b, rtol=2e-3, atol=2e-3) for a, b in zip(ne_k[:2], ne_r[:2])),
          f"K6 H/b differ from the plain version by {errs[:2]} (rtol/atol 2e-3)")
    check(float(ne_k[2]) == float(ne_r[2]), f"K6 inliers {float(ne_k[2])} vs {float(ne_r[2])}")
    check(abs(float(ne_k[3]) - float(ne_r[3])) <= 1e-3 * abs(float(ne_r[3])),
          f"K6 residual sum {float(ne_k[3])} vs {float(ne_r[3])}")
    # The library yardstick: one product of [J sqrt(w), -r sqrt(w)] with itself
    # gives the 21 + 6 sums of H and b (not the inlier and residual sums).
    r = torch.sum(n_k * (p_w - q_k), dim=-1)
    w = mask if delta <= 0 else mask * torch.clamp(delta / r.abs().clamp(min=1e-9), max=1.0)
    sw = torch.sqrt(w)[:, None]
    A = torch.cat([torch.cat([n_k, torch.linalg.cross(p_w, n_k)], 1) * sw,
                   -r[:, None] * sw], 1).contiguous()
    n_mask = float(mask.sum())
    recs.append(record(
        "K6", launches, max(errs),
        ne_times(lambda: kicp.normal_equations(p_w, n_k, q_k, mask, delta)),
        plain_time_ms(lambda: kicp.normal_equations_ref(p_w, n_k, q_k, mask, delta), 50),
        n * 40 + 44 * 4, NE_FLOPS_PER_PIXEL * n_mask,
        time_ms(lambda: torch.mm(A.T, A), 200),
        f"N={n}, {n_mask} masked, huber {delta}; H/b/inliers/res max err {errs}; "
        f"tolerance: H and b rtol/atol 2e-3 (another summation order), inliers exact, "
        f"residual sum rtol 1e-3; one device launch a call and a second call "
        f"bit-identical; library = one torch.mm of the precomputed (N, 7) "
        f"[J sqrt(w), -r sqrt(w)] by itself (27 of the 29 sums); 0 launches a frame: "
        f"no per-frame path runs it",
    ))

    # K5 with color on the state's in-view blocks, at its pose.
    d0 = preprocess.build_frame_pyramid(last.depth, intr, cfg.preprocess, 1)[0]["depth"]
    k = min(cfg.tsdf.touched_capacity, blocks.num_blocks_per_axis(cfg.tsdf) ** 3)
    vol = state.volume
    slots, valid = blocks.frustum_slots(vol, state.T_wc, intr, cfg.tsdf,
                                        cfg.raycast.near, cfg.raycast.far, k)
    recs.append(splat_record("K5color", cfg, slots, valid, vol.block_coords,
                             (vol.sdf, vol.weight, vol.color), state.T_wc, d0, True,
                             launches))
    return recs


def touched_counts(cfg, frames, states_T):
    """Per frame of the march path: blocks its truncation band touches, to
    set against the list length K (touched blocks beyond K skip a frame)."""
    from instancefusion_tpu_torch.ops import blocks, preprocess

    out = []
    for f, T in zip(frames, states_T):
        d0 = preprocess.build_frame_pyramid(f.depth, cfg.intrinsics, cfg.preprocess, 1)[0]
        out.append(int(blocks.touched_blocks_mask(d0["depth"], T, cfg.intrinsics,
                                                  cfg.tsdf).sum()))
    return out


def tsdf_update_record(cfg, state, frame, launches):
    """K8 against its plain version on the march path's last state and the
    next frame's association (touched blocks, allocated, listed), on cloned
    planes, with color and depth only: bit for bit on the listed rows, every
    other row unchanged.  The bound counts what the plain run with color
    must move: psi, w_obs, sdf, weight and color of every valid voxel, the
    observations of the observed ones, and the floats it changed."""
    from instancefusion_tpu_torch.ops import blocks, preprocess
    from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf

    intr, tcfg = cfg.intrinsics, cfg.tsdf
    d0 = preprocess.build_frame_pyramid(frame.depth, intr, cfg.preprocess, 1)[0]["depth"]
    T = frame.T_wc
    touched = blocks.touched_blocks_mask(d0, T, intr, tcfg)
    vol = blocks.allocate_touched(state.volume, touched, tcfg)
    k = min(tcfg.touched_capacity, blocks.num_blocks_per_axis(tcfg) ** 3)
    slots, valid = blocks.compact_touched_slots(vol, touched, tcfg, k)
    rows = torch.zeros(vol.sdf.shape[0], dtype=torch.bool, device=d0.device)
    rows[slots[valid].long()] = True
    n_valid, b3 = int(valid.sum()), tcfg.block_size ** 3
    before = (vol.sdf.clone(), vol.weight.clone(), vol.color.clone())
    bits = [x.view(torch.int32) for x in before]
    errs, notes = [], []
    for with_color in (True, False):
        psi, w_obs, obs = blocks.touched_observations(
            vol, slots, valid, d0, frame.color if with_color else None, T, intr, tcfg)
        args = (slots, valid, psi, w_obs, obs, tcfg.max_weight)
        maps_k = [x.clone() for x in before]
        maps_r = [x.clone() for x in before]
        ktsdf.tsdf_update(*maps_k, *args)
        ktsdf.tsdf_update_ref(*maps_r, *args)
        for name, a, b in zip(("sdf", "weight", "color"), maps_k, maps_r):
            errs.append((a[rows] - b[rows]).abs().max().item())
            n_diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            check(n_diff == 0, f"K8 {name} (color {with_color}) differs from its plain "
                  f"version on {n_diff} floats (max abs {errs[-1]}): not bit for bit")
        for name, a, b in zip(("sdf", "weight", "color"), maps_k, before):
            check(torch.equal(a[~rows], b[~rows]),
                  f"K8 (color {with_color}) changed {name} rows it was not given")
        if not with_color:
            check(torch.equal(maps_k[2], before[2]), "K8 without color changed color")
        fused = int((w_obs[valid] > 0).sum())
        changed = [int((r.view(torch.int32)[rows] != b[rows]).sum())
                   for r, b in zip(maps_r, bits)]
        notes.append(f"color {with_color}: {fused} voxels observed, sdf/weight/color "
                     f"floats changed {changed}, bit-equal to the plain version")
        if with_color:
            bench = [x.clone() for x in before]
            warm = kernel_times("K8", lambda: ktsdf.tsdf_update(*bench, *args), 200)
            times = kernel_times("K8", lambda: ktsdf.tsdf_update(*bench, *args), 200,
                                 between=l2_flush())
            plain_ms = plain_time_ms(lambda: ktsdf.tsdf_update_ref(*bench, *args), 20)
            n_obs, n_changed = fused, sum(changed)
    n_touched, n_vox = int(touched.sum()), n_valid * b3
    # Floats read: psi, w_obs, sdf, weight and 3 color of every valid voxel,
    # 3 observations of each observed one; written: those that changed.
    must_bytes = 4 * (7 * n_vox + 3 * n_obs + n_changed)
    per_vox, per_obs = TSDF_UPDATE_OBSERVED_ONLY_BYTES
    earlier_bytes = per_vox * n_vox + per_obs * n_obs
    return record(
        "K8", launches, max(errs), times, plain_ms, must_bytes,
        TSDF_UPDATE_FLOPS_PER_VOXEL * n_vox, None,
        f"K={k} listed, {n_touched} blocks touched, {n_valid} valid rows x {b3} voxels; "
        f"{'; '.join(notes)}; tolerance: bit for bit on the listed rows, rows not "
        f"listed unchanged; timed with color and the L2 flushed before each call (warm, "
        f"the same buffers back to back: call {warm[0]!r} ms, device {warm[1]!r} ms); "
        f"bound: {must_bytes} bytes that the function must move (7 floats of each of "
        f"{n_vox} valid voxels read, 3 observations of the {n_obs} observed, "
        f"{n_changed} floats written); the earlier count, the payload of the observed "
        f"voxels only: {earlier_bytes} bytes, {bound_ms(earlier_bytes, 0)[0]!r} ms; "
        f"library: none (no single PyTorch call)",
    )


def preprocess_record(cfg, frame, launches):
    """K1 against its plain version on the frame's raw depth, at the
    configuration's radius and at radii 5 and 8 (the runtime-radius
    instance)."""
    from instancefusion_tpu_torch.ops.kernels import preprocess as kpre

    intr, pcfg = cfg.intrinsics, cfg.preprocess
    out = kpre.fused_preprocess(frame.depth, intr, pcfg)
    ref = kpre.fused_preprocess_ref(frame.depth, intr, pcfg)
    v = ref[3]
    errs = [(out[i] - ref[i]).abs().max().item() for i in (0, 1)]
    n_err = (out[2] - ref[2])[v].abs().max().item()
    mism = int((out[3] != ref[3]).sum())
    check(max(errs) <= 1e-5, f"K1 df/vmap differ from the plain version by {errs}")
    check(mism == 0, f"K1 valid differs from the plain version on {mism} pixels")
    check(n_err <= 1e-3, f"K1 nmap differs from the plain version by {n_err}")
    hw = intr.height * intr.width
    radii = []
    for r in (5, 8):  # the runtime-radius instance
        rcfg = dataclasses.replace(pcfg, bilateral_radius=r)
        out_r = kpre.fused_preprocess(frame.depth, intr, rcfg)
        ref_r = kpre.fused_preprocess_ref(frame.depth, intr, rcfg)
        e = [(out_r[i] - ref_r[i]).abs().max().item() for i in (0, 1)]
        e_n = (out_r[2] - ref_r[2])[ref_r[3]].abs().max().item()
        m = int((out_r[3] != ref_r[3]).sum())
        check(max(e) <= 1e-5 and m == 0 and e_n <= 1e-3,
              f"K1 at radius {r}: df/vmap err {e}, nmap err {e_n}, valid mismatches {m}")
        t = kernel_times("K1", lambda: kpre.fused_preprocess(frame.depth, intr, rcfg), 50)
        radii.append(f"radius {r}: call {t[0]!r} ms, device {t[1]!r} ms, df/vmap max err "
                     f"{e}, nmap {e_n!r}, valid mismatches {m}")
    return record(
        "K1", launches, max(errs + [n_err]),
        kernel_times("K1", lambda: kpre.fused_preprocess(frame.depth, intr, pcfg), 200),
        time_ms(lambda: kpre.fused_preprocess_ref(frame.depth, intr, pcfg), 20),
        hw * (4 + 4 + 12 + 12 + 1), PREPROCESS_FLOPS_PER_PIXEL * hw, None,
        f"{intr.height}x{intr.width}, radius {pcfg.bilateral_radius}, "
        f"{int(v.sum())} valid pixels; df/vmap max err {errs}, nmap max err "
        f"{n_err!r} on valid pixels, valid mismatches {mism}; tolerance: df and "
        f"vmap 1e-5, valid equal, nmap 1e-3 on valid pixels; {'; '.join(radii)}; "
        f"library: none (a bilateral filter is no single PyTorch call)",
    )


def label_vote_record(cfg, state, frame, launches):
    """K7 against its plain version on the frame's touched blocks, with the
    id image the instance path would vote (refined GT masks associated
    against the map's labels)."""
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import instances as inst
    from instancefusion_tpu_torch.ops import blocks, labels
    from instancefusion_tpu_torch.ops.kernels import labels as klab

    intr, tcfg = cfg.intrinsics, cfg.tsdf
    seg = synthetic.gt_segmentation(frame.instance, cfg.instances.max_instances)
    seg = seg._replace(mask_id=labels.refine_mask_edges(seg.mask_id, frame.depth, intr=intr))
    pred_gid = labels.sample_nearest(state.votes, state.volume, state.pred.vertex_w,
                                     state.pred.valid, tcfg)
    gid, _ = inst.associate(state.table, seg, pred_gid, cfg.instances)
    touched = blocks.touched_blocks_mask(frame.depth, frame.T_wc, intr, tcfg)
    k = min(8192, blocks.num_blocks_per_axis(tcfg) ** 3)
    slots, valid = blocks.compact_touched_slots(state.volume, touched, tcfg, k)
    coords = state.volume.block_coords
    args = (slots, valid, frame.depth, gid, frame.T_wc, intr, tcfg)
    planes_k = [state.votes.label.clone(), state.votes.count.clone()]
    planes_r = [x.clone() for x in planes_k]
    klab.label_vote(coords, *planes_k, *args)
    klab.label_vote_ref(coords, *planes_r, *args)
    rows = slots[valid].long()
    n_valid = int(rows.shape[0])
    check(int(torch.unique(rows).numel()) == n_valid, "K7: valid slots repeat")
    before = [state.votes.label, state.votes.count]
    diffs = [bit_equal_rows(a, b, x, rows) for a, b, x in zip(planes_k, planes_r, before)]
    voted = int((planes_r[1][rows] != state.votes.count[rows]).sum())
    err = (planes_k[1][rows] - planes_r[1][rows]).abs().max().item()
    check(all(d == (0, 0) for d in diffs),
          f"K7: (differing voxels, changed voxels of other rows) of label/count {diffs}, "
          f"expected all 0")
    b3 = tcfg.block_size**3
    # Bytes this frame needs: the list, the valid rows' coordinates, label
    # and count read and written at the observed voxels, depth at the pixels
    # the voxels project to, ids where the depth lies within the band.
    z, pix, seen, dz = band_reads(coords, slots, valid, frame.depth, frame.T_wc, intr, tcfg)
    band = seen & (dz > 0.0) & ((dz - z).abs() < tcfg.trunc)
    n_obs = int((band & (gid.reshape(-1)[pix] >= 0)).sum())
    n_bytes = (k * 5 + n_valid * 12 + 64 + n_obs * 4 * 2 * 2
               + n_distinct(pix, seen) * 4 + n_distinct(pix, band) * 4)
    bench = [x.clone() for x in planes_k]
    times = kernel_times("K7", lambda: klab.label_vote(coords, *bench, *args), 100)
    check_one_op("K7", times)
    return record(
        "K7", launches, err, times,
        plain_time_ms(lambda: klab.label_vote_ref(coords, *bench, *args), 10),
        n_bytes, VOTE_FLOPS_PER_VOXEL * n_valid * b3, None,
        f"K={k} listed, {n_valid} valid slots x {b3} voxels, {n_obs} observed, "
        f"{voted} voted; label/count bit-equal to the plain version on every voxel of "
        f"the valid rows, other rows untouched (tolerance: exact); {times[3]!r} device "
        f"ops a call; library: none (no single PyTorch call)",
    )


def accuracy_phase(card):
    """The North star's accuracy bar: ``check_accuracy_port``'s bare engine
    on the clean 512^3 orbit and on the noisy fr1-mean rig (40 frames each),
    held to ``_check_ate512.py``'s own assert (largest translation error
    below 20 mm clean, 30 mm noisy), the means printed beside the JAX
    package's on a TPU v5e (6.3 and 9.3 mm)."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.ops import kernels

    for noisy, bar, tpu_mm in ((False, 0.02, 6.3), (True, 0.03, 9.3)):
        cfg = cap.bare_config(noisy)
        poses, frames = cap.rig_frames(cfg, ACCURACY_FRAMES, noisy)
        kernels.reset_launches()
        r = cap.run_bare(cfg, frames, poses)
        launches = launch_counts()
        errs = r["errs"]
        name = "noisy fr1-mean rig (sweep 0.8, shake 0.012/0.008, Kinect noise seed 0)" \
            if noisy else "clean 512^3 orbit"
        print(f"accuracy, {name}: {ACCURACY_FRAMES} frames, translation error mean "
              f"{errs.mean() * 1e3!r} mm, max {errs.max() * 1e3!r} mm (bar: max < "
              f"{bar * 1e3:.0f} mm); the JAX package's mean on a TPU v5e: {tpu_mm} mm "
              f"(README.md); {int(r['track_ok'].sum())}/{len(errs)} frames tracked, "
              f"{r['fps']!r} frames/s, launches {launches} [{card}]", flush=True)
        check(errs.max() < bar, f"accuracy {name}: max error {errs.max()} m >= {bar} m")
        check(launches["K2"] == 9 * ACCURACY_FRAMES and launches["K5"] == ACCURACY_FRAMES,
              f"accuracy {name}: launches {launches}")


class LoopRecorder:
    """Wraps ``posegraph.verify_loop``: keeps the inputs of the first
    verified loop (the candidate keyframe's pose and stored maps, the
    current frame's level-0 maps, the seed pose, cloned) and the K2 and K3
    launches made inside verification calls."""

    def __init__(self):
        from instancefusion_tpu_torch.engine import posegraph

        self.pg, self.orig = posegraph, posegraph.verify_loop
        self.first, self.calls, self.k2, self.k3 = None, 0, 0, 0

    def __enter__(self):
        self.pg.verify_loop = self
        return self

    def __exit__(self, *exc):
        self.pg.verify_loop = self.orig

    def __call__(self, bs, cand, vertex_c, normal_c, intr, cfg, T_cur_wc=None):
        from instancefusion_tpu_torch.ops import kernels

        fns = kernels.wrappers()
        k2, k3 = fns["K2"].launches, fns["K3"].launches
        out = self.orig(bs, cand, vertex_c, normal_c, intr, cfg, T_cur_wc)
        self.calls += 1
        self.k2 += fns["K2"].launches - k2
        self.k3 += fns["K3"].launches - k3
        if self.first is None and bool(out[2]):
            i = int(cand)
            self.first = dict(
                cand=i, kf_pose=bs.kf.poses[i].clone(), kv=bs.kf.vertex_c[i].clone(),
                kn=bs.kf.normal_c[i].clone(), kval=bs.kf.valid[i].clone(),
                vertex_c=vertex_c.clone(), normal_c=normal_c.clone(),
                T0=(bs.kf.poses[i] if T_cur_wc is None else T_cur_wc).clone(), cfg=cfg,
                intr=intr)
        return out


def drift_pipeline_phase(card):
    """``pipeline.run`` on the sustained-drift rig (``check_accuracy_port``
    with PIPELINE=1's defaults: 120 frames, sweep 1.6, shake 0.02, noise seed
    0, keyframes every 8, the sentinel on), after the bare engine on the same
    frames.  Holds every frame's pose, at least one verified loop and no
    relocalization; prints the keyframes beyond the cadence (the sentinel's
    forced path) and both mean errors.  Returns the first verified loop's
    inputs, the K2/K3 launches of verification and the first loop closure's
    BA problem (``BaRecorder``)."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.engine import step_graph
    from instancefusion_tpu_torch.ops import blocks, kernels

    cfg = cap.pipeline_config()
    poses, frames = cap.rig_frames(cfg, DRIFT_FRAMES, True, 1.6, 0.02, seed=0)
    kernels.reset_launches()
    bare = cap.run_bare(cfg, frames, poses)
    bare_launches = launch_counts()
    with LoopRecorder() as rec, BaRecorder() as barec:
        kernels.reset_launches()
        blocks.LIST_FILL.reset()
        res, rows, errs, fps = cap.run_pipeline(cfg, frames, poses)
        launches = launch_counts()
        fill = blocks.LIST_FILL.read()
    s = cap.pipeline_summary(res, rows, errs, poses)
    cadence = len(range(0, DRIFT_FRAMES, cfg.posegraph.keyframe_every))
    forced = s["keyframes"] - cadence
    phases = {k: round(v, 3) for k, v in s["phase_ms"].items()}
    print(f"drift pipeline: {s['frames']} frames, {s['keyframes']} keyframes ({cadence} by "
          f"cadence, {forced} forced by the sentinel), {s['loops']} verified loops of "
          f"{rec.calls} verifications, {s['relocalizations']} relocalizations, alarms on "
          f"{s['alarm_frames']} frames (first {s['first_alarm']}, EWMA max "
          f"{s['ewma_max_mm']!r} mm); translation error mean {s['mean_mm']!r} mm, max "
          f"{s['max_mm']!r} mm, final {s['final_mm']!r} mm, ATE {s['ate_mm']!r} mm; the "
          f"bare engine on the same frames: mean {bare['errs'].mean() * 1e3!r} mm, max "
          f"{bare['errs'].max() * 1e3!r} mm ({bare['fps']!r} frames/s, launches "
          f"{bare_launches}); pipeline {fps!r} frames/s, phase sums (ms) {phases}, "
          f"launches {launches}; verification made {rec.k2} K2 and {rec.k3} K3 launches; "
          f"in-frustum list (most rows of a frame, rows dropped past the list over the "
          f"frames, list length) {fill} [{card}]", flush=True)
    print(f"drift pipeline: the JAX package on a TPU v5e reported 17.2 mm mean and 6 "
          f"loops on this rig (_check_drift_pipeline.py); on the CPU the same package "
          f"gives the bare engine 79.72 mm and the pipeline 80.30 mm mean, 15 keyframes "
          f"(none forced), 3 loops, 0 relocalizations (python -m tests.torch_helpers, noise "
          f"seed 0), which these runs are held beside, not to", flush=True)
    check(len(res.poses) == DRIFT_FRAMES and np.isfinite(res.poses).all(),
          "drift pipeline: a frame has no finite pose")
    check(s["loops"] >= 1 and rec.first is not None, "drift pipeline: no verified loop")
    check(s["relocalizations"] == 0, "drift pipeline: relocalized while tracking was healthy")
    check(bool(bare["track_ok"].all()), "drift pipeline: the bare engine lost track")
    # Through the kernels: K1 on every frame and keyframe; K2 and K3 9 rounds
    # a frame (ICP), 3 (the sentinel) and 8 a verification; the step's
    # launches counted on the frames that called it.
    n = stepped_frames(res, DRIFT_FRAMES)
    check(res.graph_replays == DRIFT_FRAMES - step_graph.LEAD_FRAMES,
          f"drift pipeline: {res.graph_replays} graph replays of {DRIFT_FRAMES} frames")
    expect = {"K1": n + s["keyframes"], "K2": 12 * n + 8 * rec.calls,
              "K3": 12 * n + 8 * rec.calls, "K4": n, "K5": n}
    for k, count in expect.items():
        check(launches[k] == count, f"drift pipeline: {k} launched {launches[k]} times, "
                                    f"expected {count}")
    check(rec.k2 == rec.k3 == 8 * rec.calls, f"drift pipeline: verification launches "
                                             f"{rec.k2}/{rec.k3} for {rec.calls} calls")
    rec.mean_mm = s["mean_mm"]
    rec.fill = fill
    rec.ba = barec.first
    return rec


def forced_keyframe_phase(frames, poses, card):
    """The sentinel's forced keyframes on the card, as
    tests/test_pipeline.py:298 holds them on the CPU: the drift rig's
    configuration with the alarm threshold at 0 (every frame past the
    sentinel's warm-up alarms) and keyframes every 100th frame, over the
    main path's clean orbit: the streak must force keyframes the cadence
    would not give, and no relocalization."""
    import check_accuracy_port as cap

    cfg = cap.pipeline_config()
    cfg = dataclasses.replace(
        cfg, consistency_thresh=0.0,
        posegraph=dataclasses.replace(cfg.posegraph, keyframe_every=100))
    res, rows, errs, _ = cap.run_pipeline(cfg, frames, poses)
    kfs = [r["frame"] for r in rows if r["keyframe"]]
    relocs = sum(bool(r["relocalized"]) for r in rows)
    alarms = sum(bool(r.get("drift_alarm", False)) for r in rows)
    print(f"forced keyframes: {len(frames)} frames of the orbit at alarm threshold 0, "
          f"keyframes every 100th: alarms on {alarms} frames, keyframes at {kfs}, "
          f"{relocs} relocalizations, translation error mean {errs.mean() * 1e3!r} mm "
          f"[{card}]", flush=True)
    check(len(kfs) >= 2, f"forced keyframes: only {kfs} (the cadence gives [0])")
    check(relocs == 0, "forced keyframes: relocalized while tracking was healthy")


def loop_kernel_records(rec):
    """K2 and K3 at the loop-verification shape, on the first verified
    loop's inputs: the candidate keyframe's stored 160x120 maps as the
    target and the current frame decimated by 4 as the source, at the
    verification's seed pose (K2 bit-identical to its plain version, K3
    with ``inner_n`` 1 within the pose tolerance of its main-path check)."""
    from instancefusion_tpu_torch.engine import posegraph as pg
    from instancefusion_tpu_torch.geometry.se3 import rotate_vectors, se3_inverse
    from instancefusion_tpu_torch.geometry.se3 import transform_points
    from instancefusion_tpu_torch.ops.common import decimate
    from instancefusion_tpu_torch.ops.kernels import icp as kicp

    f, cfg = rec.first, rec.first["cfg"]
    decim = f["vertex_c"].shape[0] // f["kv"].shape[0]
    intr_d = pg._decimated_intrinsics(f["intr"], decim)
    tv = transform_points(f["kf_pose"], f["kv"].reshape(-1, 3)).reshape(f["kv"].shape)
    tn = rotate_vectors(f["kf_pose"], f["kn"].reshape(-1, 3)).reshape(f["kv"].shape)
    src_v = decimate(f["vertex_c"], decim)
    src_n = decimate(f["normal_c"], decim)
    src_ok = (src_v[..., 2] > 0.0) & (torch.linalg.norm(src_n, dim=-1) > 1e-6)
    src_v = src_v.reshape(-1, 3).contiguous()
    src_n = src_n.reshape(-1, 3).contiguous()
    src_ok = src_ok.reshape(-1).contiguous()
    T0 = f["T0"].contiguous()
    level = (src_v, src_ok, T0, se3_inverse(f["kf_pose"]), intr_d, tv.contiguous(),
             tn.contiguous(), f["kval"].contiguous(), 1, None)
    per_call = {"K2loop": rec.k2 // max(rec.calls, 1), "K3loop": rec.k3 // max(rec.calls, 1)}
    launches = {"K2loop": rec.k2, "K3loop": rec.k3}
    recs = [association_record("K2loop", [level], launches)]
    a = kicp.associate_gather(*level)
    gate = (src_ok & a.ok).float()
    n = src_v.shape[0]
    kw = dict(inner_n=1, dist_thresh=cfg.icp.dist_thresh * 2.0,
              angle_thresh=cfg.icp.angle_thresh, huber_delta=0.0, damping=cfg.icp.damping,
              min_valid=pg.decimated_min_valid(cfg.icp.min_valid, decim))
    args = (src_v, src_n, a.q_w, a.n_t, gate, T0)
    T_k, nin_k, rs_k = kicp.gn_iterations(*args, **kw)
    T_r, nin_r, rs_r = kicp.gn_iterations_ref(*args, **kw)
    err = (T_k - T_r).abs().max().item()
    nin_k, nin_r = float(nin_k), float(nin_r)
    check(err < 5e-5, f"K3loop pose differs from its plain version by {err} (> 5e-5)")
    check(abs(nin_k - nin_r) <= 1e-3 * max(nin_r, 1.0), f"K3loop inliers {nin_k} vs {nin_r}")
    n_gate = float(gate.sum())
    times = gn_times("K3loop", args, kw)
    recs.append(record(
        "K3loop", launches, err, times[1],
        plain_time_ms(lambda: kicp.gn_iterations_ref(*args, **kw), 50),
        n * (4 * 12 + 4) + 64 + 72, GN_FLOPS_PER_PIXEL * n_gate, None,
        f"loop verification of keyframe {f['cand']}: {intr_d.height}x{intr_d.width}, N={n}, "
        f"{n_gate} gated, inner_n=1, inliers {nin_k} vs {nin_r}, res {float(rs_k)!r} vs "
        f"{float(rs_r)!r}; {gn_steps_note(times)}; {per_call['K3loop']} launches a "
        f"verification ({rec.calls} verifications); tolerance: pose 5e-5; library: none",
    ))
    print(f"K2loop/K3loop: {per_call} launches a verification over {rec.calls} "
          f"verifications", flush=True)
    return recs


def instance_pipeline_phase(cfg, frames, poses, card):
    """``pipeline.run`` over the instance configuration's first
    INSTANCE_PIPELINE_FRAMES frames with ``segment_fn`` giving the frame's
    ground-truth masks every 2nd frame (``seg_every`` 2): each dispatched
    segmentation is fused on the next frame (the last one after the loop),
    K7 launches once per fused segmentation, and the table is populated."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.ops import kernels

    cfg = dataclasses.replace(cfg, instances=dataclasses.replace(cfg.instances, seg_every=2))
    k = cfg.instances.max_instances
    n = INSTANCE_PIPELINE_FRAMES

    kernels.reset_launches()
    res, rows, _, _ = cap.run_pipeline(
        cfg, frames[:n], poses[:n], segment_fn=lambda f: synthetic.gt_segmentation(f.instance, k))
    launches = launch_counts()
    dispatched = [r["frame"] for r in rows if r["seg_dispatched"]]
    fused_next = [r["frame"] for r in rows if "t_seg_fuse_ms" in r]
    n_active = int(res.state.table.active.sum())
    print(f"instance pipeline: {n} frames, segmentations dispatched on {dispatched}, fused "
          f"on {fused_next} and the last after the loop; K7 launched {launches['K7']} "
          f"times; {n_active} active instance rows; launches {launches} [{card}]",
          flush=True)
    check(dispatched == list(range(0, n, 2)), f"instance pipeline: dispatched on {dispatched}")
    check(fused_next == [i + 1 for i in dispatched if i + 1 < n],
          f"instance pipeline: fused on {fused_next}")
    check(launches["K7"] == len(dispatched),
          f"instance pipeline: K7 launched {launches['K7']} times for {len(dispatched)} "
          f"segmentations")
    check(n_active >= 3, f"instance pipeline: only {n_active} active instance rows")


class RunRecorder:
    """Wraps ``pipeline.run``: keeps the result of each run the CLI makes, the
    device's peak allocation when each run returned (before the CLI's
    exports), and every segmentation its ``segment_fn`` returned."""

    def __init__(self):
        from instancefusion_tpu_torch.engine import pipeline

        self.mod, self.orig, self.results, self.peaks = pipeline, pipeline.run, [], []
        self.segs = []

    def __enter__(self):
        self.mod.run = self
        return self

    def __exit__(self, *exc):
        self.mod.run = self.orig

    def __call__(self, *args, **kw):
        fn = kw.get("segment_fn")
        if fn is not None:
            def recorded(frame):
                seg = fn(frame)
                self.segs.append(seg)
                return seg

            kw["segment_fn"] = recorded
        res = self.orig(*args, **kw)
        self.results.append(res)
        self.peaks.append(torch.cuda.max_memory_allocated())
        return res


def write_tum_fixture(root: str, cfg):
    """The sequence runner's TUM-format fixture, written by the port's PNG
    encoder: the synthetic orbit at the configuration's intrinsics, out over
    SEQ_POSES poses and back over the same poses reversed; 16-bit depth at
    1/5000 m, 8-bit color, rgb stamps 5 ms after the depth's at 30 Hz, and
    the ground truth.  Returns the 2 x SEQ_POSES poses (cuda) and the
    frames of the SEQ_POSES poses."""
    import os

    from instancefusion_tpu_torch.datasets import png, synthetic
    from instancefusion_tpu_torch.utils.ate import rotmat_to_quat

    poses = synthetic.orbit_trajectory(SEQ_POSES)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(SEQ_POSES)]
    os.makedirs(os.path.join(root, "depth"))
    os.makedirs(os.path.join(root, "rgb"))
    for j, f in enumerate(frames):
        png.write(os.path.join(root, "depth", f"{j}.png"),
                  torch.round(f.depth * 5000.0).to(torch.int32).cpu().numpy().astype(np.uint16))
        png.write(os.path.join(root, "rgb", f"{j}.png"),
                  torch.round(f.color * 255.0).to(torch.uint8).cpu().numpy())
    order = list(range(SEQ_POSES)) + list(range(SEQ_POSES))[::-1]
    host = poses.cpu().numpy().astype(np.float64)
    lines = {"depth.txt": [], "rgb.txt": [], "groundtruth.txt": []}
    for k, j in enumerate(order):
        ts = 1000.0 + k / 30.0
        lines["depth.txt"].append(f"{ts:.6f} depth/{j}.png")
        lines["rgb.txt"].append(f"{ts + 0.005:.6f} rgb/{j}.png")
        vals = (*host[j, :3, 3], *rotmat_to_quat(host[j, :3, :3]))
        lines["groundtruth.txt"].append(f"{ts:.6f} " + " ".join(f"{x:.9f}" for x in vals))
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write("# timestamp data\n" + "\n".join(rows) + "\n")
    return poses[order], frames


def paeth_decode_ms(intr) -> float:
    """Host ms of ``png.decode`` on one RGB image at the camera's size whose
    rows all use filter 4 (Paeth): the decoder's per-byte slow path."""
    import struct
    import zlib

    from instancefusion_tpu_torch.datasets import png

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    rows = np.random.default_rng(0).integers(
        0, 256, (intr.height, 1 + 3 * intr.width), dtype=np.uint8)
    rows[:, 0] = 4
    data = (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", intr.width, intr.height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
    t0 = time.perf_counter()
    png.decode(data)
    return (time.perf_counter() - t0) * 1e3


def choose_stream_radius(cfg, frames, poses, card, required: bool = True) -> float:
    """The active-window radius of the streamed run, from the block-centre
    distances of the fixture: each frame's measurement band is sampled as
    ``blocks.discover_allocate`` samples it (3 depths, every 4th pixel), and
    the streaming policy (a tick every STREAM_EVERY frames: admit stored
    blocks within the radius that are not on the device, evict those
    beyond it) is replayed on those block sets at each candidate radius.
    The largest radius the replay brings STREAM_MIN_IN blocks back at is
    chosen: blocks leave the window before the turn and come back after
    it, and as few as may are seen again from beyond the radius (then they
    are allocated afresh while their stored copy waits).  Unless `required`,
    a fixture where no candidate qualifies gets the candidate that brings
    the most blocks back."""
    from instancefusion_tpu_torch.geometry.camera import ray_directions

    ts = cfg.tsdf
    bsz = ts.block_size * ts.voxel_size
    band = ts.trunc + ts.voxel_size
    origin = torch.tensor(ts.origin, device=poses.device)
    rays = ray_directions(cfg.intrinsics, poses.device)[::4, ::4].reshape(-1, 3)
    order = list(range(SEQ_POSES)) + list(range(SEQ_POSES))[::-1]
    seen = []
    for j in range(SEQ_POSES):
        d = frames[j].depth[::4, ::4].reshape(-1)
        T = poses[order.index(j)]
        dirs = rays @ T[:3, :3].T
        g = torch.cat([torch.floor((T[:3, 3] + dirs * (d + off)[:, None] - origin) / bsz)[d > 0]
                       for off in (-band, 0.0, band)])
        seen.append(torch.unique(g.long(), dim=0).cpu().numpy())
    eyes = poses[:, :3, 3].cpu().numpy()
    centre = {}

    def dist(b, e):
        c = centre.get(b)
        if c is None:
            c = centre[b] = np.asarray(ts.origin) + (np.array(b) + 0.5) * bsz
        return float(np.linalg.norm(c - e))

    inview = [max(dist(tuple(b), eyes[k]) for b in seen[j].tolist())
              for k, j in enumerate(order[:SEQ_POSES])]

    def replay(radius):
        dev, store, n_in, n_out, again = set(), set(), 0, 0, 0
        for k, j in enumerate(order):
            ids = set(map(tuple, seen[j].tolist()))
            again += len((ids - dev) & store)
            dev |= ids
            if (k + 1) % STREAM_EVERY == 0:
                adm = {b for b in store if b not in dev and dist(b, eyes[k]) <= radius}
                ev = {b for b in dev | adm if dist(b, eyes[k]) > radius}
                n_in, n_out = n_in + len(adm), n_out + len(ev)
                store, dev = (store - adm) | ev, (dev | adm) - ev
        return n_in, n_out, again

    table = {r: replay(r) for r in STREAM_RADII}
    radius = max((r for r, (n_in, n_out, _) in table.items() if n_in >= STREAM_MIN_IN and n_out > 0),
                 default=None)
    print(f"sequence runner: block-centre distances of each frame's band blocks on the way "
          f"out, the largest in view (m): {[round(x, 3) for x in inview]}; replayed policy "
          f"(stream_in, stream_out, blocks seen again while stored) by radius: {table}; "
          f"chosen radius {radius} m [{card}]", flush=True)
    if radius is None and not required:
        radius = max(table, key=lambda r: (table[r][0], -r))
    check(radius is not None, "sequence runner: no candidate radius streams blocks out and in")
    return radius


def run_cli(argv):
    """``cli.main(argv)`` with its standard output and error captured; the
    pipeline results it made, its summary, its stderr and its wall time."""
    import contextlib
    import io

    from instancefusion_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with RunRecorder() as rec, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv}: exit {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])["summary"]
    return rec.results, summary, err.getvalue(), wall


def streaming_roundtrip(cfg, state, card):
    """Every block of a full-width map out to the host store and back: ticks
    at radius 0 evict evict_cap rows each until the device holds none, then
    ticks at radius 1e9 admit admit_cap rows each until the store is empty.
    Each block's sdf, weight, color, votes and stamp must come back bit for
    bit, keyed by its block coordinates; n_active and overflow unchanged."""
    from instancefusion_tpu_torch.engine.streaming import BlockStreamer
    from instancefusion_tpu_torch.ops import blocks, labels

    vol = state.volume
    c, b3 = vol.sdf.shape
    nb = blocks.num_blocks_per_axis(cfg.tsdf)
    slot = torch.arange(c, device=vol.sdf.device, dtype=torch.int32)
    # Distinct votes and stamps per slot and voxel, made on the device.
    vox = torch.arange(b3, device=slot.device, dtype=torch.int32)
    votes = labels.LabelVotes(label=(slot[:, None] * 7 + vox[None, :]) % 97 - 1,
                              count=((slot[:, None] + vox[None, :]) % 13).float() * 0.5)
    stamp = torch.stack([slot + 1, torch.full_like(slot, 33)], -1)

    def by_block(v, vt, st):
        n = int(v.n_active)
        bc = v.block_coords[:n].long()
        order = torch.argsort((bc[:, 0] * nb + bc[:, 1]) * nb + bc[:, 2])
        return [x[:n][order] for x in (v.block_coords, v.sdf, v.weight, v.color,
                                       vt.label, vt.count, st)]

    golden = by_block(vol, votes, stamp)
    n0, over0 = int(vol.n_active), int(vol.overflow)
    streamer = BlockStreamer(cfg.tsdf, radius=0.0, evict_cap=1024, admit_cap=1024,
                             with_color=True, with_votes=True, with_stamps=True)
    T = state.T_wc
    ticks = {"stream_out": [], "stream_in": []}
    for key, done in (("stream_out", lambda: int(vol.n_active) == 0),
                      ("stream_in", lambda: not streamer.store)):
        while not done():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vol, votes, stamp, stats = streamer.tick(vol, votes, T, stamp)
            torch.cuda.synchronize()
            ticks[key].append((stats[key], (time.perf_counter() - t0) * 1e3))
            check(stats[key] > 0 and len(ticks[key]) <= n0 // 1024 + 2,
                  f"round trip: {key} stalled at tick {len(ticks[key])} ({stats})")
        if key == "stream_out":
            check(len(streamer.store) == n0, f"round trip: {len(streamer.store)} stored of {n0}")
            streamer.radius = 1e9
    back = by_block(vol, votes, stamp)
    names = ("coords", "sdf", "weight", "color", "label", "count", "stamp")
    bad = [name for name, a, b in zip(names, golden, back) if not torch.equal(a, b)]
    print(f"streaming round trip at full width: {n0} blocks out and back, (blocks, ms) of "
          f"each tick {ticks}; n_active {int(vol.n_active)} (was {n0}), overflow "
          f"{int(vol.overflow)} (was {over0}); fields that differ: {bad} [{card}]", flush=True)
    check(not bad, f"round trip: {bad} differ after the round trip")
    check(int(vol.n_active) == n0 and int(vol.overflow) == over0,
          "round trip: n_active or overflow changed")


def sequence_runner_phase(card):
    """Phase 14: ``cli.main`` on a TUM-format fixture at config2's full width
    (640x480, 512^3 block map of 1 cm voxels, table 65536, splat
    prediction), with loops and active-window streaming, then without
    streaming; the streaming round trip of the final map at full width; the
    mesh, render, trajectory and instance exports."""
    import os
    import tempfile

    from instancefusion_tpu_torch.config import config2_tum_fr3_long_office
    from instancefusion_tpu_torch.datasets import png, synthetic, tum
    from instancefusion_tpu_torch.ops import kernels
    from instancefusion_tpu_torch.utils import meshing, render
    from instancefusion_tpu_torch.utils.ate import rotmat_to_quat

    cfg = config2_tum_fr3_long_office()
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = os.path.join(tmp, "seq")
        poses, frames = write_tum_fixture(seq_dir, cfg)
        radius = choose_stream_radius(cfg, frames, poses, card)
        del frames
        decode = tum.TumSequence(seq_dir, cfg.intrinsics)
        t0 = time.perf_counter()
        for i in range(4):
            decode.decode(i)
        png_ms = (time.perf_counter() - t0) * 1e3 / 4
        paeth_ms = paeth_decode_ms(cfg.intrinsics)

        paths = {k: os.path.join(tmp, k) for k in ("traj.txt", "mesh.ply", "m.jsonl",
                                                   "m0.jsonl", "inst", "view.png")}
        base = ["run", "--preset", "config2", "--dataset", seq_dir, "--frames",
                str(2 * SEQ_POSES), "--loops", "--quiet"]
        kernels.reset_launches()
        (res,), s, err, wall = run_cli(base + [
            "--stream-every", str(STREAM_EVERY), "--stream-radius", str(radius),
            "--export-traj", paths["traj.txt"], "--export-mesh", paths["mesh.ply"],
            "--metrics-out", paths["m.jsonl"]])
        launches = launch_counts()
        decoder = [ln.split(": ", 1)[1] for ln in err.splitlines() if ln.startswith("decoder: ")]
        rows = [json.loads(ln) for ln in open(paths["m.jsonl"])]
        ticks = [r for r in rows if "stream_out" in r]
        s_in, s_out = sum(r["stream_in"] for r in ticks), sum(r["stream_out"] for r in ticks)
        stream_ms = [r["t_stream_ms"] for r in ticks]
        print(f"sequence runner, streamed: decoder {decoder}, {s['frames']} frames, "
              f"{s['fps']!r} frames/s end to end with decode ({wall!r} s for cli.main), "
              f"ATE {s.get('ate_rmse_m', float('nan')) * 1e3!r} mm, {s['keyframes']} "
              f"keyframes, {s['loop_closures']} loops; stream_in {s_in}, stream_out {s_out} "
              f"over {len(ticks)} ticks ({[(r['frame'], r['stream_in'], r['stream_out']) for r in ticks]}), "
              f"stored at the end {ticks[-1]['stored_blocks'] if ticks else None}; stream phase "
              f"ms {stream_ms}; PNG decode {png_ms!r} ms a frame (depth and color, filter 0, "
              f"host; one RGB image of Paeth rows: {paeth_ms!r} ms); "
              f"launches {launches} [{card}]", flush=True)
        check(decoder in (["native"], ["png"]), f"sequence runner: decoder line {decoder}")
        check(s["frames"] == 2 * SEQ_POSES and all(r["track_ok"] for r in rows),
              f"sequence runner: frames {s['frames']}, tracking failed on "
              f"{[r['frame'] for r in rows if not r['track_ok']]}")
        check(s.get("ate_rmse_m", 1.0) < cfg.tsdf.voxel_size,
              f"sequence runner: streamed ATE {s.get('ate_rmse_m')} >= {cfg.tsdf.voxel_size}")
        check(s_out > 0 and s_in > 0, f"sequence runner: stream_in {s_in}, stream_out {s_out}")
        stepped = stepped_frames(res, 2 * SEQ_POSES)
        for k, per in PER_FRAME.items():
            check(launches[k] >= per * stepped,
                  f"sequence runner: {k} launched {launches[k]} < {per * stepped}")

        # The trajectory reads back within 1e-6 of the run's poses.
        traj = np.loadtxt(paths["traj.txt"])
        want = np.array([[i / 30.0, *T[:3, 3], *rotmat_to_quat(T[:3, :3])]
                         for i, T in enumerate(res.poses)])
        traj_err = float(np.abs(traj - want).max())
        check(traj.shape == want.shape and traj_err <= 1e-6,
              f"sequence runner: trajectory reads back {traj_err} off")

        # The mesh: within one voxel of the scene's surface.
        with open(paths["mesh.ply"]) as fh:
            head = [fh.readline().strip()]
            while head[-1] != "end_header":
                head.append(fh.readline().strip())
        n_v = int(head[2].split()[2])
        near = 0.0
        if n_v:
            verts = np.loadtxt(paths["mesh.ply"], skiprows=len(head), max_rows=n_v,
                               usecols=(0, 1, 2), ndmin=2)
            sdf, _ = synthetic.scene_sdf(torch.tensor(verts, dtype=torch.float32,
                                                      device=poses.device))
            near = float((sdf.abs() < cfg.tsdf.voxel_size).float().mean())

        kernels.reset_launches()
        (res0,), s0, _, wall0 = run_cli(base + ["--metrics-out", paths["m0.jsonl"]])
        rows0 = [json.loads(ln) for ln in open(paths["m0.jsonl"])]
        check(all(r["track_ok"] for r in rows0) and s0.get("ate_rmse_m", 1.0) < cfg.tsdf.voxel_size,
              f"sequence runner: unstreamed ATE {s0.get('ate_rmse_m')}")
        vol0 = res0.state.volume
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verts0, tris0, _ = meshing.extract_mesh(vol0, cfg.tsdf, with_color=True)
        torch.cuda.synchronize()
        mesh_ms = (time.perf_counter() - t0) * 1e3
        box = meshing.block_box(vol0, cfg.tsdf)[0].shape
        t0 = time.perf_counter()
        imgs = render.render_view(vol0, res0.state.T_wc, cfg.intrinsics, cfg.tsdf, cfg.raycast)
        render_ms = (time.perf_counter() - t0) * 1e3
        render.save_png(paths["view.png"], imgs["shaded"])
        back = png.read(paths["view.png"])
        shaded_share = float((back.max(axis=-1) > 0).mean())
        print(f"sequence runner, unstreamed: ATE {s0['ate_rmse_m'] * 1e3!r} mm (streamed "
              f"{s['ate_rmse_m'] * 1e3!r} mm), {s0['fps']!r} frames/s end to end ({wall0!r} "
              f"s), {s0['keyframes']} keyframes, {s0['loop_closures']} loops; exported mesh "
              f"{n_v} vertices, {near!r} within one voxel of the scene; mesh of the unstreamed "
              f"map {verts0.shape[0]} vertices, {tris0.shape[0]} triangles in {mesh_ms!r} ms "
              f"(box {tuple(box)} of the {cfg.tsdf.grid_size}^3 grid); render {render_ms!r} "
              f"ms, shaded share {shaded_share!r}; trajectory read back within {traj_err!r} "
              f"[{card}]", flush=True)
        check(n_v > 0 and near >= 0.95, f"sequence runner: mesh {n_v} vertices, {near} near")
        check(shaded_share > 0.5, f"sequence runner: render shaded share {shaded_share}")
        del res, imgs
        streaming_roundtrip(cfg, res0.state, card)
        del res0, vol0

        kernels.reset_launches()
        _, si, erri, _ = run_cli(["run", "--preset", "config2", "--dataset", "synthetic",
                                  "--frames", str(INSTANCE_PIPELINE_FRAMES), "--instances",
                                  "--seg-head", "gt", "--export-instances", paths["inst"]])
        launches = launch_counts()
        plys = sorted(os.listdir(paths["inst"])) if os.path.isdir(paths["inst"]) else []
        print(f"sequence runner, instances: {si['frames']} synthetic frames, K7 launched "
              f"{launches['K7']} times, instance models {plys} [{card}]", flush=True)
        check(launches["K7"] > 0, "sequence runner: K7 never launched with --instances")
        check(len(plys) >= 3, f"sequence runner: only {len(plys)} instance PLYs")


# ---------------------------------------------------------------------------
# Phase 15: the sharded map, SHARDS ranks on the card.  The functions named
# rank_* run on every rank of one RankPool (a process each); what a rank
# keeps between them lives in _RANK.
# ---------------------------------------------------------------------------

SHARDS = 8
_RANK: dict = {}


def _sha(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()


def _collectives(group, frames: int) -> dict:
    st = group.stats
    return {"calls": st.calls / frames, "bytes": st.bytes / frames,
            "ms": st.seconds * 1e3 / frames}


def rank_engine(n: int) -> dict:
    """(a): config4 through ``slam_sharded.step`` over the orbit, WARMUP
    frames then TIMED; per frame the pose, counts, a digest of the
    directory and the prediction's coverage; the launches of the run, the
    ms a frame, the collectives a frame and the peak memory."""
    from instancefusion_tpu_torch.config import config4_posegraph_sharded
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import slam_sharded
    from instancefusion_tpu_torch.ops import blocks as blk
    from instancefusion_tpu_torch.ops import kernels
    from instancefusion_tpu_torch.parallel import mesh

    g = mesh.current()
    cfg = config4_posegraph_sharded()
    poses = synthetic.orbit_trajectory(n, device=g.device)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    blk.LIST_FILL.reset()
    g.timing = True
    st = slam_sharded.init_state(cfg, g, poses[0])
    keep = []
    for i, f in enumerate(frames):
        if i == WARMUP:
            torch.cuda.synchronize()
            g.stats.reset()
            t0 = time.perf_counter()
        st, info = slam_sharded.step(cfg, g, st, f.depth, f.color)
        keep.append((st.T_wc, st.volume.n_active.clone(), st.volume.directory.clone(),
                     st.pred.valid.sum(), info.track_ok))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n - WARMUP)
    coll = _collectives(g, n - WARMUP)
    g.timing = False
    launches = launch_counts()
    fill = blk.LIST_FILL.read()
    _RANK.update(cfg=cfg, state=st)
    return {
        "T_wc": [k[0].cpu().numpy() for k in keep],
        "n_active": [k[1].cpu().numpy() for k in keep],
        "directory": [_sha(k[2]) for k in keep],
        "valid": [int(k[3]) for k in keep],
        "track_ok": [bool(k[4]) for k in keep],
        "final_directory": (st.volume.directory >= 0).cpu().numpy(),
        "gt": poses.cpu().numpy(), "ms": ms, "collectives": coll, "launches": launches,
        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
        "backend": g.backend, "fill": fill,
    }


def rank_halo() -> dict:
    """(b): the marched sharded raycast of (a)'s final map at its final
    pose, and, on rank 0, the one-card marched raycast of the same map
    gathered, held to tests/test_shard_raycast.py's tolerances."""
    from instancefusion_tpu_torch import convert
    from instancefusion_tpu_torch.ops import blocks as blk
    from instancefusion_tpu_torch.parallel import mesh, shard

    g = mesh.current()
    cfg, st = _RANK["cfg"], _RANK["state"]
    g.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps, halo = shard.raycast(st.volume, st.T_wc, g, cfg.intrinsics, cfg.tsdf, cfg.raycast,
                               return_halo=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"halo": [int(x) for x in halo], "ms": ms, "collectives": _collectives(g, 1),
           "sha": _sha(maps.depth)}
    arrays = convert.sharded_map_to_global(st.volume, g)
    if g.rank == 0:
        one = convert.block_map_from_global(arrays, g.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = blk.raycast(one, st.T_wc, cfg.intrinsics, cfg.tsdf, cfg.raycast)
        torch.cuda.synchronize()
        out["one_ms"] = (time.perf_counter() - t0) * 1e3
        vs, vh = ref.valid, maps.valid
        both = vs & vh
        out["kept"] = float(both.sum()) / max(float(vs.sum()), 1.0)
        out["valid"] = (int(vs.sum()), int(vh.sum()))
        err = (maps.depth - ref.depth)[both].abs()
        out["depth_err"] = float(err.max())
        out["over"] = (int((err > 2e-3).sum()), int(both.sum()))
        out["normal_cos"] = float(torch.median((maps.normal_w * ref.normal_w).sum(-1)[both]))
    return out


def rank_drift(list_scale: int = 1) -> dict:
    """(c): the drift rig through ``pipeline.run`` with num_shards SHARDS;
    then the sharded Schur terms on the final keyframes against the
    unsharded ``paired_terms``.  `list_scale` multiplies touched_capacity,
    and so each rank's in-frustum list length (``shard.fused_step_map``'s
    k_local); it changes nothing else on this path."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.ops import ba, blocks, kernels
    from instancefusion_tpu_torch.parallel import mesh, shard

    g = mesh.current()
    cfg = dataclasses.replace(cap.pipeline_config(), num_shards=g.size)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, touched_capacity=cfg.tsdf.touched_capacity * list_scale))
    poses, frames = cap.rig_frames(cfg, DRIFT_FRAMES, True, 1.6, 0.02, seed=0,
                                   device=g.device)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g.stats.reset()
    with LoopRecorder() as rec, BaRecorder() as barec:
        kernels.reset_launches()
        blocks.LIST_FILL.reset()
        res, rows, errs, fps = cap.run_pipeline(cfg, frames, poses)
        launches = launch_counts()
        fill = blocks.LIST_FILL.read()
    s = cap.pipeline_summary(res, rows, errs, poses)
    bs = res.backend
    # The terms at the final keyframes moved off the BA's optimum by a fixed
    # twist (at the optimum the gradient is ~0 and a relative measure of it
    # is noise).
    from instancefusion_tpu_torch.geometry.se3 import se3_exp

    nudge = se3_exp(torch.tensor([0.01, -0.01, 0.005, 0.002, -0.003, 0.001],
                                 device=g.device))
    kf = bs.kf.poses @ nudge

    def terms(dtype, sharded):
        lm = bs.lm._replace(za=bs.lm.za.to(dtype), zb=bs.lm.zb.to(dtype),
                            weight=bs.lm.weight.to(dtype))
        fn = shard.sharded_paired_terms(g) if sharded else ba.paired_terms
        S, r, *_, cst = fn(kf.to(dtype), bs.points.to(dtype), lm)
        return S, r, cst

    def rel(a, b):
        return tuple(float((x.double() - y.double()).abs().max()
                           / torch.clamp(y.double().abs().max(), min=1e-30))
                     for x, y in zip(a, b))

    # The reducer in fp64 (sums in another order only), and the rounding of
    # each fp32 form against the fp64 terms.
    t64 = terms(torch.float64, False)
    ba_rel = rel(terms(torch.float64, True), t64)
    ba32 = (rel(terms(torch.float32, True), t64), rel(terms(torch.float32, False), t64))

    return {"summary": {k: s[k] for k in ("frames", "keyframes", "loops", "relocalizations",
                                          "mean_mm", "max_mm", "ate_mm")},
            "poses_sha": _sha(torch.as_tensor(res.poses)), "finite": bool(np.isfinite(res.poses).all()),
            "fps": fps, "launches": launches, "verify": (rec.calls, rec.k2, rec.k3),
            "fill": fill,
            "ba_rel": ba_rel, "ba32": ba32,
            "landmarks": int(bs.lm.valid.sum()), "collectives": _collectives(g, DRIFT_FRAMES),
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def rank_cli(seq_dir: str, radius: float, tmp: str) -> dict:
    """(d): ``cli.main run --preset config4 --shards SHARDS`` on the TUM
    fixture on every rank (the ranks are a group already, as under
    torchrun): streaming, reshards (each checked to keep the block set and
    one directory entry per live row), exports from rank 0, a checkpoint at
    frame SEQ_POSES; the same run again (the spread of two uninterrupted
    runs on the card); then the run resumed from the first one's
    checkpoint.  Also each rank's decode ms a frame with every rank
    decoding at once, and how full its in-frustum lists ran in the first
    run."""
    import contextlib
    import io
    import os

    from instancefusion_tpu_torch import cli, convert
    from instancefusion_tpu_torch.config import config4_posegraph_sharded
    from instancefusion_tpu_torch.datasets import tum
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.ops import blocks
    from instancefusion_tpu_torch.parallel import mesh

    g = mesh.current()
    seq = tum.TumSequence(seq_dir, config4_posegraph_sharded().intrinsics)
    g.barrier()
    t0 = time.perf_counter()
    for i in range(4):
        seq.decode(i)
    decode_ms = (time.perf_counter() - t0) * 1e3 / 4
    reshards = []
    orig = pipeline._Engine.reshard

    def checked(self, state, skew):
        before = (state.volume.directory >= 0).clone()
        out, moved = orig(self, state, skew)
        after = out.volume.directory >= 0
        reshards.append((moved, bool(torch.equal(before, after)),
                         int(out.volume.n_active.sum()) == int(after.sum()),
                         out.volume.cuts.tolist()))
        return out, moved

    paths = {k: os.path.join(tmp, k)
             for k in ("a.txt", "b.txt", "c.txt", "mesh.ply", "m.jsonl", "ck", "ck_b")}
    base = ["run", "--preset", "config4", "--dataset", seq_dir, "--frames", str(2 * SEQ_POSES),
            "--shards", str(g.size), "--loops", "--quiet", "--stream-every", str(STREAM_EVERY),
            "--stream-radius", str(radius), "--reshard-every", str(STREAM_EVERY),
            "--checkpoint-every", str(SEQ_POSES)]
    out = {"decode_ms": decode_ms}
    restored = []
    orig_restore = pipeline.ckpt.restore

    def checked_restore(path, example, cfg, step=None, group=None):
        """The restore, held bit for bit to the files this rank reads."""
        out, at = orig_restore(path, example, cfg, step, group)
        saved = torch.load(os.path.join(path, f"step_{at}.pt"), weights_only=True)
        saved.update(torch.load(os.path.join(path, f"step_{at}.rank{g.rank}.pt"),
                                weights_only=True))
        got = convert.flatten(out)
        restored.append((at, got.keys() == saved.keys() and all(
            torch.equal(v.cpu(), saved[k]) if isinstance(v, torch.Tensor) else v == saved[k]
            for k, v in got.items())))
        return out, at

    pipeline._Engine.reshard = checked
    pipeline.ckpt.restore = checked_restore
    try:
        for name, extra in (("a", ["--checkpoint-dir", paths["ck"], "--export-traj",
                                   paths["a.txt"], "--export-mesh", paths["mesh.ply"],
                                   "--metrics-out", paths["m.jsonl"]]),
                            ("b", ["--checkpoint-dir", paths["ck_b"], "--export-traj",
                                   paths["b.txt"]]),
                            ("c", ["--checkpoint-dir", paths["ck"], "--export-traj",
                                   paths["c.txt"], "--resume"])):
            blocks.LIST_FILL.reset()
            buf = io.StringIO()
            with RunRecorder() as runs, contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                t0 = time.perf_counter()
                rc = cli.main(base + extra)
                torch.cuda.synchronize()
            out[name] = {"rc": rc, "wall": time.perf_counter() - t0,
                         "poses": runs.results[0].poses, "fill": blocks.LIST_FILL.read()}
            if g.rank == 0:
                out[name]["summary"] = json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]
            if name == "a":
                # Resume from the checkpoint at SEQ_POSES, not the last one.
                if g.rank == 0:
                    for f in os.listdir(paths["ck"]):
                        if f.startswith(f"step_{2 * SEQ_POSES}."):
                            os.remove(os.path.join(paths["ck"], f))
                g.barrier()
    finally:
        pipeline._Engine.reshard = orig
        pipeline.ckpt.restore = orig_restore
    out["reshards"] = reshards
    out["restored"] = restored
    if g.rank == 0:
        rows = [json.loads(ln) for ln in open(paths["m.jsonl"])]
        out["rows"] = [{k: r.get(k) for k in ("frame", "track_ok", "stream_in", "stream_out",
                                              "stored_blocks", "reshard_migrated")}
                       for r in rows]
        out["traj"] = tuple(open(paths[k]).read().splitlines()
                            for k in ("a.txt", "b.txt", "c.txt"))
        out["mesh_bytes"] = os.path.getsize(paths["mesh.ply"])
    return out


def unsharded_run(cfg, frames, poses) -> dict:
    """The one-card engine over the same frames: poses, ms a frame over the
    timed frames, the final allocation mask and coverage, peak memory."""
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.ops import blocks

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    blocks.LIST_FILL.reset()
    st = slam.init_state(cfg, poses[0])
    est = []
    for i, f in enumerate(frames):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        st, _ = slam.step(cfg, st, f.depth, f.color)
        est.append(st.T_wc)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - WARMUP)
    return {"T_wc": torch.stack(est).cpu().numpy(), "ms": ms,
            "directory": (st.volume.directory >= 0).cpu().numpy(),
            "valid": int(st.pred.valid.sum()), "fill": blocks.LIST_FILL.read(),
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def sharded_phase(card, drift_mean_mm: float, drift_fill: dict, par: dict) -> dict:
    """Phase 15, with the config5 phase and phase 16 (c) on the same ranks:
    the sharded map as SHARDS ranks on the card (one launch: the ranks start
    and load the kernels once).  `par` holds phase 16 (c)'s frames and
    one-rank segmentations.  Returns rank 0's launch counts of (a) for the
    kernel records."""
    import os
    import tempfile

    from instancefusion_tpu_torch.config import config4_posegraph_sharded
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.ops import kernels
    from instancefusion_tpu_torch.parallel import mesh
    from instancefusion_tpu_torch.utils.ate import ate_rmse

    cfg = config4_posegraph_sharded()
    voxel = cfg.tsdf.voxel_size
    n = WARMUP + TIMED
    poses = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n)]
    kernels.reset_launches()
    one = unsharded_run(dataclasses.replace(cfg, num_shards=1), frames, poses)
    del frames
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = os.path.join(tmp, "seq")
        seq_poses, seq_frames = write_tum_fixture(seq_dir, cfg)
        radius = choose_stream_radius(cfg, seq_frames, seq_poses, card, required=False)
        del seq_frames
        t0 = time.perf_counter()
        with mesh.RankPool(SHARDS) as pool:
            start_s = time.perf_counter() - t0
            a = pool.run(rank_engine, n)
            b = pool.run(rank_halo)
            c = pool.run(rank_drift)
            # The same rig with each rank's in-frustum list as long as the
            # one card's (k_local 2048): what the per-rank cap does to it.
            cw = pool.run(rank_drift, SHARDS)
            d = pool.run(rank_cli, seq_dir, radius, tmp)
            e = pool.run(rank_config5, seq_dir, radius, tmp)
            pr = pool.run(rank_parallel, par["rgb"], par["k"], 5)
    r0 = a[0]

    # (a) config4 at full width.
    ate = ate_rmse(np.stack(r0["T_wc"]), r0["gt"])
    ate_one = ate_rmse(one["T_wc"], r0["gt"])
    pose_diff = float(np.abs(np.stack(r0["T_wc"]) - one["T_wc"]).max())
    final_diff = float(np.abs(r0["T_wc"][-1] - one["T_wc"][-1]).max())
    alloc_diff = int((one["directory"] != r0["final_directory"]).sum())
    n_alloc = int(one["directory"].sum())
    counts = r0["n_active"][-1]
    peaks = [r["peak_gib"] for r in a]
    print(f"sharded (a): config4 on {SHARDS} ranks ({r0['backend']} over the one card; ranks up "
          f"in {start_s!r} s): {n} frames, {r0['ms']!r} ms a frame (rank 0; ranks "
          f"{[round(r['ms'], 3) for r in a]}) against the one-card engine's {one['ms']!r} ms; "
          f"collectives a frame (rank 0) {r0['collectives']}; peak memory per rank above what "
          f"the process held before the run (GiB) {peaks} against one card "
          f"{one['peak_gib']!r}; ATE {ate * 1e3!r} mm (one card "
          f"{ate_one * 1e3!r} mm); pose difference to the one-card run: final {final_diff!r} "
          f"m, largest over the frames {pose_diff!r} m; allocation sets differ in "
          f"{alloc_diff} of {n_alloc} blocks; coverage {r0['valid'][-1]} vs {one['valid']} "
          f"pixels; rows per shard {counts.tolist()}; in-frustum lists per rank (most rows of "
          f"a frame, rows dropped past the list, list length) "
          f"{[tuple(r['fill'].values()) for r in a]}, one card {tuple(one['fill'].values())}; "
          f"launches per rank "
          f"{[r['launches'] for r in a]} [{card}]", flush=True)
    check(all(r0["track_ok"]), f"sharded (a): tracking failed on {r0['track_ok']}")
    check(ate < voxel, f"sharded (a): ATE {ate} >= voxel {voxel}")
    check(final_diff < 0.5 * voxel, f"sharded (a): final pose {final_diff} m from the one-card run")
    check(alloc_diff <= 0.02 * n_alloc + 2, f"sharded (a): allocation sets differ in {alloc_diff}")
    check(abs(r0["valid"][-1] - one["valid"]) < 0.1 * max(r0["valid"][-1], one["valid"]),
          f"sharded (a): coverage {r0['valid'][-1]} vs {one['valid']}")
    check((counts > 0).sum() >= 2, f"sharded (a): rows on {(counts > 0).sum()} shards")
    for r in a[1:]:
        same = (all(np.array_equal(x, y) for x, y in zip(r["T_wc"], r0["T_wc"]))
                and r["directory"] == r0["directory"]
                and all(np.array_equal(x, y) for x, y in zip(r["n_active"], r0["n_active"])))
        check(same, "sharded (a): a rank's pose, directory or n_active left rank 0's")
    per = {"K1": 1, "K2": 9, "K3": 9, "K4": 1, "K5": 1}
    for r in a:
        for k, v in r["launches"].items():
            want = per.get(k, 0) * n
            if k in ("K4color", "K5color"):
                want = n
            check(v == want, f"sharded (a): {k} launched {v} times on a rank, expected {want}")

    # (b) the halo raycast.
    h0 = b[0]
    print(f"sharded (b): halo raycast of (a)'s final map: halo rows received per rank (from the "
          f"left, from the right) {[r['halo'] for r in b]}; {h0['ms']!r} ms (rank 0; "
          f"collectives {h0['collectives']}) against the one-card marched raycast's "
          f"{h0['one_ms']!r} ms; valid pixels one card / sharded {h0['valid']}, one-card hits "
          f"kept {h0['kept']!r}, largest depth difference {h0['depth_err']!r} m (common hits "
          f"beyond 2 mm: {h0['over']}), median normal "
          f"cosine {h0['normal_cos']!r} [{card}]", flush=True)
    check(all(r["sha"] == h0["sha"] for r in b), "sharded (b): ranks composited other maps")
    # test_shard_raycast.py's bounds: > 97% of the one-card hits kept, depth
    # within 2 mm on every common hit and median normal cosine above 0.999.
    check(h0["kept"] > 0.97 and h0["over"][0] == 0 and h0["normal_cos"] > 0.999,
          f"sharded (b): halo raycast against the one-card raycast {h0}")
    check(sum(x for r in b for x in r["halo"]) > 0, "sharded (b): no halo row crossed a seam")

    # (c) the drift rig's pipeline.
    c0 = c[0]
    s = c0["summary"]
    print(f"sharded (c): drift rig pipeline on {SHARDS} ranks: {s}, {c0['fps']!r} frames/s, "
          f"verifications (calls, K2, K3) {c0['verify']}, collectives a frame (rank 0) "
          f"{c0['collectives']}, peak memory per rank above the frames (GiB) "
          f"{[r['peak_gib'] for r in c]}; "
          f"sharded Schur terms against the unsharded paired_terms on {c0['landmarks']} "
          f"landmarks (final keyframes nudged off the optimum), in fp64: relative "
          f"differences (S, rhs, cost) {c0['ba_rel']}; in fp32 against the fp64 terms, "
          f"sharded {c0['ba32'][0]}, unsharded {c0['ba32'][1]}; mean error "
          f"{s['mean_mm']!r} mm against the one-card pipeline's {drift_mean_mm!r} mm (phase 12 "
          f"of this run); in-frustum lists per rank (most rows of a frame, rows dropped past "
          f"the list over the frames, list length) {[tuple(r['fill'].values()) for r in c]}, "
          f"one card {tuple(drift_fill.values())} [{card}]", flush=True)
    w0 = cw[0]
    print(f"sharded (c'): the same rig with each rank's list as long as the one card's: "
          f"{w0['summary']}, {w0['fps']!r} frames/s; in-frustum lists per rank "
          f"{[tuple(r['fill'].values()) for r in cw]}; mean error {w0['summary']['mean_mm']!r} "
          f"mm against {s['mean_mm']!r} (lists of {c0['fill']['length']}) and the one card's "
          f"{drift_mean_mm!r} [{card}]", flush=True)
    check(c0["finite"] and s["frames"] == DRIFT_FRAMES, "sharded (c): a frame has no finite pose")
    check(s["loops"] >= 1, "sharded (c): no verified loop")
    check(all(r["poses_sha"] == c0["poses_sha"] for r in c), "sharded (c): ranks' poses differ")
    check(c0["landmarks"] > 0 and max(c0["ba_rel"]) <= 1e-5,
          f"sharded (c): BA terms {c0['ba_rel']} on {c0['landmarks']} landmarks")
    check(w0["finite"] and all(r["poses_sha"] == w0["poses_sha"] for r in cw),
          "sharded (c'): a pose is not finite or the ranks' poses differ")

    # (d) the sequence runner.
    d0 = d[0]
    sa, sc = d0["a"]["summary"], d0["c"]["summary"]
    rows = d0["rows"]
    s_in = sum(r["stream_in"] or 0 for r in rows)
    s_out = sum(r["stream_out"] or 0 for r in rows)
    moved = [x for r in d for x in r["reshards"] if x[0] > 0]
    ta, tb, tc = d0["traj"]

    def second_half(lines):
        return np.array([[float(x) for x in ln.split()[1:]] for ln in lines[-SEQ_POSES:]])

    pa, pb, pc = second_half(ta), second_half(tb), second_half(tc)
    spread = float(np.abs(pa - pb).max()) if len(tb) == len(ta) else float("inf")
    resume_diff = float(np.abs(pa - pc).max()) if pa.shape == pc.shape else float("inf")
    # Bit for bit: the poses the runs computed, not their printed trajectories.
    runs_equal = np.array_equal(d0["a"]["poses"], d0["b"]["poses"])
    resume_equal = np.array_equal(np.asarray(d0["a"]["poses"])[SEQ_POSES:],
                                  np.asarray(d0["c"]["poses"]))
    ate_c = ate_rmse(d0["c"]["poses"], seq_poses[SEQ_POSES:].cpu().numpy())
    print(f"sharded (d): cli run --preset config4 --shards {SHARDS} on the TUM fixture: "
          f"{sa['frames']} frames, {sa['fps']!r} frames/s with decode ({d0['a']['wall']!r} s), "
          f"ATE {sa['ate_rmse_m'] * 1e3!r} mm, {sa['keyframes']} keyframes, "
          f"{sa['loop_closures']} loops; stream_in {s_in}, stream_out {s_out} (radius {radius} "
          f"m); reshards (rows moved, block set kept, one entry per live row, cuts) on rank 0 "
          f"{d0['reshards']}; mesh {d0['mesh_bytes']} bytes; resumed at frame {SEQ_POSES}: "
          f"{sc['frames']} frames, the restored state equal to the checkpoint bit for bit on "
          f"every rank: {[r['restored'] for r in d]}, ATE {ate_c * 1e3!r} mm, "
          f"largest difference of the trajectory's entries (frames {SEQ_POSES} on) from the "
          f"uninterrupted run's {resume_diff!r}, poses bit-identical {resume_equal}; two "
          f"uninterrupted runs {spread!r} apart, poses bit-identical {runs_equal}; in-frustum "
          f"lists of the first run per rank "
          f"{[tuple(r['a']['fill'].values()) for r in d]}; decode "
          f"{[round(r['decode_ms'], 3) for r in d]} ms a frame per rank with every rank "
          f"decoding at once [{card}]", flush=True)
    check(all(r[k]["rc"] == 0 for r in d for k in "abc"), "sharded (d): cli exit code")
    check(all(r["track_ok"] for r in rows), "sharded (d): tracking failed")
    check(sa["ate_rmse_m"] < voxel, f"sharded (d): ATE {sa['ate_rmse_m']} >= {voxel}")
    check(s_in > 0 and s_out > 0, f"sharded (d): stream_in {s_in}, stream_out {s_out}")
    check(len(moved) > 0, "sharded (d): no reshard migrated rows")
    check(all(x[1] and x[2] for r in d for x in r["reshards"]),
          "sharded (d): a reshard lost or duplicated a block")
    # Every sum on the card runs in a fixed order (K5 without atomics, the
    # gloo all-reduce in its fixed ring), so two runs repeat bit for bit and
    # a resumed run equals the uninterrupted one, as the CPU test
    # (tests/test_torch_pipeline_sharded.py) holds it.
    check(len(tc) == SEQ_POSES and all(r["restored"] == [(SEQ_POSES, True)] for r in d),
          f"sharded (d): the restore left the checkpoint: {[r['restored'] for r in d]}")
    check(runs_equal, f"sharded (d): two uninterrupted runs differ by {spread}")
    check(resume_equal, f"sharded (d): the resumed run differs from the uninterrupted one "
                        f"by {resume_diff}")
    check(ate_c < voxel, f"sharded (d): resumed ATE {ate_c}")
    check(d0["mesh_bytes"] > 1000, "sharded (d): no mesh exported")

    config5_checks(card, e)
    parallel_checks(card, pr, par)
    return r0["launches"]


# ---------------------------------------------------------------------------
# Phase 16: whether the card's runs repeat; the segmentation head's training,
# its data- and tensor-parallel forward.

def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x


def _leaves(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, np.ndarray):
        yield path, torch.from_numpy(np.ascontiguousarray(x))
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}.{k}")


def differences(a, b) -> dict:
    """The tensor leaves of `a` and `b` that differ bit for bit, each with
    the largest absolute difference of its elements (inf where the shapes
    differ)."""
    out = {}
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if x.shape != y.shape:
            out[path] = float("inf")
            continue
        if x.is_floating_point():
            same = torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        else:
            same = torch.equal(x, y)
        if not same:
            out[path] = float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
    return out


def digest(tree) -> str:
    """sha1 of the bytes of every tensor leaf of `tree`, in order."""
    import hashlib

    h = hashlib.sha1()
    for _, x in _leaves(tree):
        h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class BaRecorder:
    """Wraps ``ba.optimize_hybrid_paired``: keeps the inputs of its first
    call (cloned), the loop problem of the first closure."""

    def __init__(self):
        from instancefusion_tpu_torch.ops import ba

        self.mod, self.orig, self.first = ba, ba.optimize_hybrid_paired, None

    def __enter__(self):
        self.mod.optimize_hybrid_paired = self
        return self

    def __exit__(self, *exc):
        self.mod.optimize_hybrid_paired = self.orig

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = (_clone_tree(args), _clone_tree(kw))
        return self.orig(*args, **kw)


def splat_inputs(cfg, state, frame):
    """K5's inputs as the main path makes them: the frustum list of `state`'s
    map at `frame`'s pose."""
    from instancefusion_tpu_torch.ops import blocks

    vol, T = state.volume, frame.T_wc
    k = min(cfg.tsdf.touched_capacity, blocks.num_blocks_per_axis(cfg.tsdf) ** 3)
    slots, valid = blocks.frustum_slots(vol, T, cfg.intrinsics, cfg.tsdf,
                                        cfg.raycast.near, cfg.raycast.far, k)
    return (slots, valid, vol.block_coords, vol.sdf, vol.weight, vol.color, T,
            cfg.intrinsics, cfg.tsdf)


def repeat_phase(card, main_in, inst_in, ba_in) -> dict:
    """Phase 16 (a): does the card repeat itself?  Each op runs twice on the
    same inputs and the results are compared bit for bit: K5 with and
    without color on the main path's frustum list (`main_in`: config,
    state, next frame); ``optimize_hybrid_paired`` on the first loop
    problem of the drift rig (`ba_in`: its recorded arguments);
    ``engine/instances``' merges and ``associate`` (and ``apply_merges``
    folding every row into one), and the whole
    ``fuse_segmentation`` (K7 included) on copies of the instance path's
    state (`inst_in`: config, state, frame); then ``cli.main run --preset
    config2`` on phase 14's fixture twice (loops, no streaming), trajectories
    compared bit for bit.  Returns each item's differing fields with their
    largest difference (empty where the two runs agree)."""
    import os
    import tempfile

    from instancefusion_tpu_torch.config import config2_tum_fr3_long_office
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import instances as inst
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.ops import ba, labels
    from instancefusion_tpu_torch.ops.kernels import raycast as kray

    out = {}
    cfg, state, frame = main_in
    sin = splat_inputs(cfg, state, frame)
    for with_color in (False, True):
        args = (*sin, with_color, cfg.raycast.splat_rmax)
        first = kray.splat_planes(*args)
        out["K5 color" if with_color else "K5"] = differences(first, kray.splat_planes(*args))

    args, kw = ba_in
    out["ba.optimize_hybrid_paired"] = differences(ba.optimize_hybrid_paired(*args, **kw),
                                                   ba.optimize_hybrid_paired(*args, **kw))

    icfg, istate, iframe = inst_in
    seg = synthetic.gt_segmentation(iframe.instance, icfg.instances.max_instances)

    def associate():
        pred_gid = labels.sample_nearest(istate.votes, istate.volume, istate.pred.vertex_w,
                                         istate.pred.valid, icfg.tsdf)
        src, dst, ok = inst.find_merges(istate.table, seg, pred_gid, icfg.instances)
        table = inst.apply_merges(istate.table, src, dst, ok)
        pred_gid = labels.apply_table(labels.merge_table(src, dst, ok,
                                                         icfg.instances.max_instances),
                                      pred_gid)
        return inst.associate(table, seg, pred_gid, icfg.instances)

    out["instances.associate"] = differences(associate(), associate())

    # Several rows folded into one in one call: float sums into one row.
    n_rows = istate.table.active.shape[0]
    gen = torch.Generator(device=istate.table.score.device).manual_seed(0)
    table = istate.table._replace(
        active=torch.ones_like(istate.table.active),
        score=torch.rand(n_rows, generator=gen, device=gen.device) * 10.0)
    src = torch.arange(1, n_rows, dtype=torch.int32, device=gen.device)
    dst = torch.zeros_like(src)
    ok = torch.ones_like(src, dtype=torch.bool)
    out["instances.apply_merges, rows into one"] = differences(
        inst.apply_merges(table, src, dst, ok), inst.apply_merges(table, src, dst, ok))

    def fuse():
        st = istate._replace(votes=_clone_tree(istate.votes))
        st = slam.fuse_segmentation(icfg, st, seg, iframe.depth, istate.T_wc)
        return st.votes, st.table

    out["slam.fuse_segmentation"] = differences(fuse(), fuse())

    ccfg = config2_tum_fr3_long_office()
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = os.path.join(tmp, "seq")
        write_tum_fixture(seq_dir, ccfg)
        base = ["run", "--preset", "config2", "--dataset", seq_dir, "--frames",
                str(2 * SEQ_POSES), "--loops", "--quiet"]
        runs = [run_cli(base) for _ in range(2)]
    (ra,), sa = runs[0][:2]
    (rb,), _ = runs[1][:2]
    out["cli run --preset config2"] = differences(np.asarray(ra.poses), np.asarray(rb.poses))
    for name, diff in out.items():
        print(f"repeat (a): {name} twice on the same inputs: "
              f"{'bit-identical' if not diff else 'differs: ' + repr(diff)} [{card}]",
              flush=True)
    print(f"repeat (a): the two config2 runs: ATE {sa['ate_rmse_m'] * 1e3!r} mm, "
          f"{sa['frames']} frames, {sa['loop_closures']} loops", flush=True)
    return out


# The record of phase 16 (a) before K5 summed in a fixed order: ``python3
# chip_smoke.py --repeat`` on the tree with the atomic K5 (PERF.md, the
# order-fixed K5; NVIDIA H100 80GB HBM3, 700.00 W).
REPEAT_BEFORE = {"K5": "differs (planes up to 3.36e7 apart, of sums up to e^39)",
                 "K5 color": "differs (planes up to 6.71e7 apart)",
                 "ba.optimize_hybrid_paired": "bit-identical",
                 "instances.associate": "bit-identical",
                 "slam.fuse_segmentation": "bit-identical",
                 "cli run --preset config2": "differs (poses up to 2.619e-4 apart)"}


def repeat_record(card, after: dict) -> None:
    """Phase 16 (d): (a)'s record beside the same measurement with the atomic K5."""
    for name, diff in after.items():
        print(f"repeat (d): {name}: before {REPEAT_BEFORE.get(name, 'not measured')}; "
              f"after {'bit-identical' if not diff else 'differs: ' + repr(diff)} [{card}]",
              flush=True)


TRAIN_STEPS, TRAIN_CPU_STEPS = 300, 3


def _sha_file(path) -> str:
    import hashlib

    return hashlib.sha1(open(path, "rb").read()).hexdigest()


def trainer_phase(card) -> None:
    """Phase 16 (b): ``models/train_seghead.train`` on the card, TRAIN_STEPS
    steps of its schedule at the packaged head's width on the reference
    trainer's data.  The mean loss of the last 50 steps must fall below
    half the first step's; the first TRAIN_CPU_STEPS steps must equal the
    same steps on the CPU from the same initial weights and frames within
    1e-4 relative; a second run of the same steps must give the same losses
    and parameters bit for bit; the checkpoint, written to a temporary
    directory, must reload through ``load_pretrained`` to the head's
    parameters rounded to fp16, with outputs equal to those of the rounded
    head; the packaged weights must be unchanged.  Prints steps/s at each size, peak memory
    and the accuracy report (printed, not limited: 300 of 4000 steps)."""
    import copy
    import os
    import tempfile
    from pathlib import Path

    from instancefusion_tpu_torch.models import segmentation as segm
    from instancefusion_tpu_torch.models import train_seghead as ts

    packaged = Path(segm.__file__).parent / segm.PRETRAINED_SYNTHETIC["file"]
    sha = _sha_file(packaged)
    t0 = time.perf_counter()
    data = ts.make_dataset()
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, hist, _ = ts.train(TRAIN_STEPS, data=data, log=lambda line: None)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    loss = hist["loss"]
    again, again_hist, _ = ts.train(TRAIN_STEPS, data=data, log=lambda line: None)
    steps_differ = [i for i, (a, b) in enumerate(zip(loss, again_hist["loss"])) if a != b]
    params_differ = differences(model.state_dict(), again.state_dict())
    heights = np.asarray(hist["height"])
    secs = np.asarray(hist["seconds"])
    rate = {f"{int(h) * 4 // 3}x{int(h)}": float((heights == h).sum() / secs[heights == h].sum())
            for h in sorted(set(hist["height"]))}
    cpu_data = [(type(f)(*(x.cpu() for x in f)), c.cpu()) for f, c in data]
    _, cpu_hist, _ = ts.train(TRAIN_STEPS, device="cpu", data=cpu_data, stop=TRAIN_CPU_STEPS,
                              log=lambda line: None)
    first = loss[:TRAIN_CPU_STEPS]
    cpu_rel = np.abs(np.subtract(first, cpu_hist["loss"])) / np.abs(cpu_hist["loss"])
    acc = ts.report(model, data, log=lambda line: None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.npz")
        segm.save_pretrained(path, model)
        loaded = segm.load_pretrained(path)
    rounded = copy.deepcopy(model)
    with torch.no_grad():
        for q in rounded.parameters():
            q.copy_(q.half().float())
    same_params = all(torch.equal(a, b) for a, b in
                      zip(loaded.state_dict().values(), rounded.state_dict().values()))
    rgb = data[0][0].color
    with torch.no_grad():
        out_err = max(float((a - b).abs().max()) for a, b in zip(loaded(rgb), rounded(rgb)))
    late = float(np.mean(loss[-50:]))
    print(f"trainer (b): {TRAIN_STEPS} steps of the {ts.STEPS}-step recipe's data ({len(data)} "
          f"frames rendered in {data_s!r} s) at width {ts.WIDTH}: loss first {loss[0]!r}, mean "
          f"of the last 50 {late!r} (every 50th: {loss[::50]}); steps/s {rate}; peak "
          f"memory {peak_gib!r} GiB; first {TRAIN_CPU_STEPS} losses {first} against "
          f"the CPU's {cpu_hist['loss']} (relative {cpu_rel.tolist()}); accuracy {acc}; "
          f"checkpoint reloaded: parameters equal to the fp16-rounded head {same_params}, "
          f"outputs within {out_err!r}; a second run of the {TRAIN_STEPS} steps: losses that "
          f"differ at steps {steps_differ[:5]} ({len(steps_differ)} in all), parameters that "
          f"differ {params_differ} [{card}]", flush=True)
    check(late < 0.5 * loss[0], f"trainer: loss {late} did not fall below half of {loss[0]}")
    check(not steps_differ and not params_differ,
          f"trainer: a second run differs at steps {steps_differ[:5]}, parameters "
          f"{params_differ}")
    check(bool((cpu_rel <= 1e-4).all()), f"trainer: card vs CPU losses {cpu_rel}")
    check(same_params and out_err <= 1e-6,
          f"trainer: reloaded head params equal {same_params}, outputs {out_err}")
    check(_sha_file(packaged) == sha, "trainer: the packaged weights changed")


def rank_parallel(rgb: torch.Tensor, k: int, reps: int) -> dict:
    """Phase 16 (c) on a rank: the digest of the packaged head's outputs on
    every frame of `rgb`, ``dp_segment_fn`` on the batch and
    ``tp_segment_fn`` on its first frame, then ms per call and the
    collectives' calls, bytes and ms a call."""
    from instancefusion_tpu_torch.models import parallel
    from instancefusion_tpu_torch.models import segmentation as segm
    from instancefusion_tpu_torch.parallel import mesh

    g = mesh.current()
    torch.cuda.empty_cache()
    head = segm.load_pretrained(device=g.device)
    x = rgb.to(g.device)
    dp = parallel.dp_segment_fn(g, k)
    shard_params, tp = parallel.tp_segment_fn(g, k)
    thead = shard_params(head)
    with torch.no_grad():
        heads = [digest(head(f)) for f in x]
    out = {"head_digests": heads, "dp": dp(head, x), "tp": tp(thead, x[0]),
           "split": [n for n, d in parallel.tp_param_shardings(head, g).items() if d == 0]}
    for name, fn in (("dp", lambda: dp(head, x)), ("tp", lambda: tp(thead, x[0])),
                     ("one", lambda: segm.segment(head, x[0], k))):
        g.barrier()
        torch.cuda.synchronize()
        g.stats.reset()
        g.timing = True
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        g.timing = False
        out[f"{name}_collectives"] = {"calls": g.stats.calls / reps,
                                      "bytes": g.stats.bytes / reps,
                                      "ms": g.stats.seconds * 1e3 / reps}
    return out


def parallel_inputs(cfg, frames, stable, card) -> dict:
    """Phase 16 (c)'s frames (SHARDS of phase 10's frames whose grouping
    survives output perturbations), the main process's one-rank ``segment``
    of each, with its ms per call, and the digest of the head's outputs on
    each."""
    from instancefusion_tpu_torch.models import segmentation as segm

    check(len(stable) >= SHARDS, f"only {len(stable)} stable frames for DP over {SHARDS}")
    k = cfg.instances.max_instances
    picks = stable[:SHARDS]
    rgb = torch.stack([frames[i].color for i in picks])
    head = segm.load_pretrained()
    single = [segm.segment(head, x, k) for x in rgb]
    with torch.no_grad():
        heads = [digest(head(x)) for x in rgb]
    ms = time_ms(lambda: segm.segment(head, rgb[0], k), 10)
    return {"rgb": rgb.cpu(), "single": [segm.Segmentation(*(f.cpu() for f in s))
                                         for s in single],
            "head_digests": heads, "ms": ms, "k": k, "frames": picks}


def parallel_checks(card, p, par) -> None:
    """Phase 16 (c): DP and TP over SHARDS ranks against the main process's
    one-rank ``segment`` of the same frames.  On every rank: the head's
    outputs on each frame bit-identical to the main process's; DP's frame
    i with mask_id, classes and scores equal to the one-rank segment of
    frame i; TP's frame with mask_id and classes equal and scores within
    1e-4 (tests/test_shard_engine.py's bounds)."""
    r0 = p[0]
    single = par["single"]

    def agree(a, b):
        return (float((a.mask_id == b.mask_id).float().mean()), torch.equal(a.classes, b.classes),
                float((a.scores - b.scores).abs().max()))

    heads = [sum(a == b for a, b in zip(r["head_digests"], par["head_digests"])) for r in p]
    dp = [[agree(seg_at(r["dp"], i), single[i]) for i in range(len(single))] for r in p]
    tp = [agree(r["tp"], single[0]) for r in p]
    print(f"parallel (c): the packaged head at {tuple(par['rgb'].shape[1:3])} on {SHARDS} ranks "
          f"(gloo over the one card), frames {par['frames']}: DP {r0['dp_ms']!r} ms a batch of "
          f"{len(single)} (collectives a call {r0['dp_collectives']}), TP {r0['tp_ms']!r} ms a "
          f"frame (collectives a call {r0['tp_collectives']}; split {len(r0['split'])} conv "
          f"weights: {r0['split']}), one rank {r0['one_ms']!r} ms a frame with the other ranks "
          f"idle (the main process alone: {par['ms']!r}); frames whose head outputs equal the "
          f"main process's bit for bit, a rank {heads} of {len(single)}; against the main "
          f"process's one-rank segment (mask_id equal share, classes equal, largest score "
          f"difference): DP on rank 0 {dp[0]}, TP on each rank {tp} [{card}]", flush=True)
    check(all(h == len(single) for h in heads),
          f"parallel (c): the head's outputs differ from the main process's: {heads}")
    check(all(x == (1.0, True, 0.0) for row in dp for x in row),
          f"parallel (c): DP differs from the one-rank segment: {dp}")
    check(all(x[:2] == (1.0, True) and x[2] <= 1e-4 for x in tp),
          f"parallel (c): TP differs from the one-rank segment: {tp}")
    check(r0["split"] == [f"blocks.{i}.conv.weight" for i in range(8)],
          f"parallel (c): split weights {r0['split']}")


def seg_at(seg, i: int):
    """Frame i of a batched ``Segmentation``."""
    return type(seg)(*(x[i] for x in seg))


def rank_config5(seq_dir: str, radius: float, tmp: str) -> dict:
    """The config5 phase on a rank: ``cli.main run --preset config5 --shards
    SHARDS --instances --seg-head trained`` on phase 14's fixture with loops
    and streaming, exports from rank 0; peak memory above what the rank
    held before (and where the running peak grew: after which of the
    pipeline's Timer phases, on which frame, by more than 0.1 GiB),
    launches, poses, and digests of each segmentation the head gave and of
    the final instance table."""
    import contextlib
    import io
    import os

    from instancefusion_tpu_torch import cli
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.ops import blocks, kernels
    from instancefusion_tpu_torch.parallel import mesh
    from instancefusion_tpu_torch.utils.metrics import Timer

    growth, steps = [], [0]

    class PeakTimer(Timer):
        """The pipeline's phase timer, noting the running peak after each
        phase where it grew by more than 0.1 GiB, with the frame (the
        steps so far)."""

        @contextlib.contextmanager
        def phase(self, name, sync_tree=None):
            with Timer.phase(self, name, sync_tree):
                yield
            steps[0] += name == "step"
            peak = torch.cuda.max_memory_allocated()
            if peak - (growth[-1][2] if growth else base) > 0.1 * 2**30:
                growth.append((name, steps[0], peak))

    g = mesh.current()
    torch.cuda.empty_cache()  # what the earlier tasks left cached, for the other ranks
    paths = {k: os.path.join(tmp, f"c5_{k}") for k in ("traj.txt", "mesh.ply", "inst",
                                                       "m.jsonl")}
    argv = ["run", "--preset", "config5", "--dataset", seq_dir, "--frames", str(2 * SEQ_POSES),
            "--shards", str(g.size), "--instances", "--seg-head", "trained", "--loops",
            "--quiet", "--stream-every", str(STREAM_EVERY), "--stream-radius", str(radius),
            "--export-traj", paths["traj.txt"], "--export-mesh", paths["mesh.ply"],
            "--export-instances", paths["inst"], "--metrics-out", paths["m.jsonl"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    blocks.LIST_FILL.reset()
    buf = io.StringIO()
    pipeline.Timer = PeakTimer
    try:
        with RunRecorder() as runs, contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
    finally:
        pipeline.Timer = Timer
    out = {"rc": rc, "wall": time.perf_counter() - t0, "poses": runs.results[0].poses,
           "segs": [digest(sg) for sg in runs.segs],
           "table": digest(runs.results[0].state.table),
           "launches": launch_counts(), "fill": blocks.LIST_FILL.read(),
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "run_peak_gib": (runs.peaks[0] - base) / 2**30,
           "growth": [(name, k, round((peak - base) / 2**30, 4)) for name, k, peak in growth]}
    if g.rank == 0:
        out["summary"] = json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]
        out["rows"] = [json.loads(ln) for ln in open(paths["m.jsonl"])]
        out["traj"] = open(paths["traj.txt"]).read().splitlines()
        out["mesh_bytes"] = os.path.getsize(paths["mesh.ply"])
        out["plys"] = sorted(os.listdir(paths["inst"])) if os.path.isdir(paths["inst"]) else []
    return out


def config5_checks(card, e) -> None:
    """The config5 phase: every frame tracked, ATE below the 2 cm voxel,
    every rank's poses, segmentations (every rank runs the head on the same
    frame) and instance table equal to rank 0's bit for bit, K7 launched on
    every rank, the trajectory, mesh and instance models exported.  The
    votes are each rank's own rows; what they are fused from (poses,
    segmentations, table) is held equal."""
    from instancefusion_tpu_torch.config import config5_multihost

    cfg = config5_multihost()
    e0 = e[0]
    s = e0["summary"]
    rows = e0["rows"]
    s_in = sum(r.get("stream_in") or 0 for r in rows)
    s_out = sum(r.get("stream_out") or 0 for r in rows)
    print(f"config5: cli run --preset config5 --shards {SHARDS} --instances --seg-head trained "
          f"on the TUM fixture ({cfg.tsdf.grid_size}^3 of {cfg.tsdf.voxel_size} m voxels, "
          f"table {cfg.tsdf.table_capacity} = {SHARDS} x {cfg.tsdf.table_capacity // SHARDS} "
          f"rows): {s['frames']} frames, {s['fps']!r} frames/s with decode ({e0['wall']!r} s), "
          f"ATE {s['ate_rmse_m'] * 1e3!r} mm, {s['keyframes']} keyframes, {s['loop_closures']} "
          f"loops; stream_in {s_in}, stream_out {s_out}; peak memory per rank above what it "
          f"held before (GiB): until pipeline.run returned "
          f"{[round(r['run_peak_gib'], 4) for r in e]}, with the exports (the map gathered "
          f"to every rank) {[round(r['peak_gib'], 4) for r in e]}; on rank 0 the running peak "
          f"grew (after the phase, steps so far, GiB) {e0['growth'][:12]}; launches "
          f"on rank 0 "
          f"{e0['launches']}; in-frustum lists per rank {[tuple(r['fill'].values()) for r in e]}; "
          f"{len(e0['plys'])} instance models, mesh {e0['mesh_bytes']} bytes; ranks whose "
          f"{len(e0['segs'])} segmentations and instance table equal rank 0's "
          f"{[r['segs'] == e0['segs'] for r in e]}, {[r['table'] == e0['table'] for r in e]} "
          f"[{card}]", flush=True)
    check(all(r["rc"] == 0 for r in e), "config5: cli exit code")
    check(s["frames"] == 2 * SEQ_POSES and all(r["track_ok"] for r in rows),
          "config5: a frame failed to track")
    check(s["ate_rmse_m"] < cfg.tsdf.voxel_size,
          f"config5: ATE {s['ate_rmse_m']} >= {cfg.tsdf.voxel_size}")
    check(all(np.array_equal(r["poses"], e0["poses"]) for r in e),
          "config5: a rank's poses left rank 0's")
    check(e0["segs"] and all(r["segs"] == e0["segs"] for r in e),
          "config5: a rank's segmentations left rank 0's")
    check(all(r["table"] == e0["table"] for r in e), "config5: a rank's instance table left rank 0's")
    check(all(r["launches"]["K7"] > 0 for r in e), "config5: K7 never launched on a rank")
    check(len(e0["traj"]) == 2 * SEQ_POSES and e0["mesh_bytes"] > 1000 and e0["plys"],
          "config5: exports missing")


def repeat_main() -> None:
    """``python3 chip_smoke.py --repeat``: the card, the build and phase 16
    (a) alone, on inputs it makes itself (the main and instance paths over
    WARMUP + CHUNK frames, the drift rig's pipeline for its first loop
    problem).  Prints what differs and exits 0 either way."""
    import check_accuracy_port as cap
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.engine import slam
    from instancefusion_tpu_torch.models.segmentation import PRETRAINED_SYNTHETIC
    from instancefusion_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _build.build()
    cfg = bench_config()
    icfg = instance_config(PRETRAINED_SYNTHETIC["num_classes"])
    n = WARMUP + CHUNK
    poses = synthetic.orbit_trajectory(n + 1)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n + 1)]
    states = []
    for c in (cfg, icfg):
        st = slam.init_state(c, poses[0])
        for i, f in enumerate(frames[:n]):
            if c.use_instances and i % 2 == 0:
                seg = synthetic.gt_segmentation(f.instance, c.instances.max_instances)
                st, _ = slam.step_seg(c, st, f.depth, f.color, seg)
            else:
                st, _ = slam.step(c, st, f.depth, f.color)
        states.append(st)
    pcfg = cap.pipeline_config()
    dposes, dframes = cap.rig_frames(pcfg, DRIFT_FRAMES, True, 1.6, 0.02, seed=0)
    with BaRecorder() as barec:
        cap.run_pipeline(pcfg, dframes, dposes)
    check(barec.first is not None, "repeat: the drift rig closed no loop")
    repeat_phase(card, (cfg, states[0], frames[n]), (icfg, states[1], frames[n - 1]),
                 barec.first)
    print(card, flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    from instancefusion_tpu_torch.datasets import synthetic
    from instancefusion_tpu_torch.models.segmentation import PRETRAINED_SYNTHETIC
    from instancefusion_tpu_torch.ops.kernels import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0!r} s", flush=True)
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    cfg = bench_config()
    n = WARMUP + TIMED
    poses = synthetic.orbit_trajectory(n + 1)
    frames = [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n + 1)]
    torch.cuda.synchronize()

    state, launches, _, _ = run_path(cfg, frames[:n], poses[:n], card, "main path")
    icfg = instance_config(PRETRAINED_SYNTHETIC["num_classes"])
    istate, ilaunches, _, _ = run_path(icfg, frames[:n], poses[:n], card,
                                       "instance path", seg_every=2)
    instance_checks(icfg, istate, frames[n - 1])
    inst_in = (icfg, _clone_tree(istate), frames[n - 1])
    rcfg = rgb_config()
    tex = [synthetic.render_frame(poses[i], cfg.intrinsics, texture=True)
           for i in range(n + 1)]
    rstate, rlaunches, rinfos, wr = run_path(rcfg, tex[:n], poses[:n], card,
                                             "photometric path", per_frame=RGB_PER_FRAME)
    photometric_checks(rcfg, rstate, rinfos, wr)
    mcfg = march_config()
    mstate, mlaunches, minfos, _ = run_path(mcfg, frames[:n], poses[:n], card, "march path",
                                            per_frame=MARCH_PER_FRAME)
    k = mcfg.tsdf.touched_capacity
    touched = touched_counts(mcfg, frames[:n], poses[:n])
    print(f"march path: blocks touched per frame (list length K={k}): min {min(touched)}, "
          f"max {max(touched)}, frames over K: {sum(c > k for c in touched)}; {touched}",
          flush=True)
    dcfg = dense_config()
    run_path(dcfg, frames[:n], poses[:n], card, "dense path", per_frame=DENSE_PER_FRAME)
    recs = [preprocess_record(cfg, frames[n], launches)]
    recs += kernel_phase(cfg, state, frames[n], launches)
    recs.append(label_vote_record(icfg, istate, frames[n], ilaunches))
    recs += rgb_kernel_phase(rcfg, rstate, tex[n], tex[n - 1], rlaunches)
    recs.append(tsdf_update_record(mcfg, mstate, frames[n], mlaunches))
    # Last: the local loop drifts and ages a copy of the state's stamps and pose.
    local_loop_phase(rcfg, rstate, tex[n - 1], card)
    _, stable = head_phase(icfg, istate, frames[:n], frames[n], card)
    accuracy_phase(card)
    rec = drift_pipeline_phase(card)
    forced_keyframe_phase(frames[:n], poses[:n], card)
    instance_pipeline_phase(icfg, frames, poses, card)
    recs += loop_kernel_records(rec)
    sequence_runner_phase(card)
    after = repeat_phase(card, (cfg, state, frames[n]), inst_in, rec.ba)
    check(not any(after.values()), f"repeat (a): ops differ run to run: {after}")
    trainer_phase(card)
    par = parallel_inputs(icfg, frames[:n], stable, card)
    # Nine processes share the card from here on: let go of this one's states.
    del state, istate, rstate, mstate, inst_in
    torch.cuda.empty_cache()
    sharded = sharded_phase(card, rec.mean_mm, rec.fill, par)
    repeat_record(card, after)
    ids = {name: k for k, name in NAMES.items()}
    for r in recs:
        # Launches a rank made on phase 15's sharded main path.
        r["sharded_launches_per_rank"] = sharded.get(ids[r["name"]], 0)
    print(json.dumps({"kernels": recs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--repeat"]:
        repeat_main()
    else:
        main()
