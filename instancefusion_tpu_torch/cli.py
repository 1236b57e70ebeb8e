"""Command-line entry point of the PyTorch port (port of ``cli.py``).

    python -m instancefusion_tpu_torch.cli run --preset config2 \\
        --dataset /path/to/rgbd_dataset_freiburg3_long_office_household \\
        --loops --export-traj traj.txt --export-mesh mesh.ply

Runs a sequence (synthetic, a TUM-format directory, or an extracted
ScanNet scene) through ``engine/pipeline.run``, streams per-frame JSONL
metrics, exports the trajectory, the mesh and per-instance models, and
prints a final ``{"summary": ...}`` line with the reference's keys.  It runs
on the card unless ``--device`` says otherwise, and never falls back to
the CPU on its own.

``--shards S`` above 1 (config4 and config5 default to 8) shards the map
over S ranks: the command starts them itself (``parallel.mesh.launch``),
or, started by ``torchrun --nproc-per-node S``, joins the group torchrun
describes.  The backend is NCCL when every rank has a card of its own and
gloo otherwise (ranks that share a card, or ``--device cpu``).  Every rank
reads and decodes the sequence itself; rank 0 alone writes the metrics,
the exports and the summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="config1", help="config1..config5")
    p.add_argument(
        "--dataset",
        default="synthetic",
        help="'synthetic', a TUM-format sequence directory, or a ScanNet scene",
    )
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--small", action="store_true", help="use the small test camera/volume")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--metrics-out", default=None, help="write JSONL metrics here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--loops", action="store_true", help="enable keyframes + loop closure")
    p.add_argument("--instances", action="store_true",
                   help="enable instance fusion (trained seg head by "
                        "default; see --seg-head)")
    p.add_argument("--seg-head", default="trained", choices=["trained", "gt"],
                   help="'trained' runs the packaged network "
                        "(models/weights); 'gt' feeds ground-truth masks "
                        "(synthetic only)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export-traj", default=None,
                   help="write the trajectory in TUM format here")
    p.add_argument("--export-mesh", default=None,
                   help="write the reconstructed mesh (PLY) here")
    p.add_argument("--export-instances", default=None,
                   help="directory for per-instance model PLYs "
                        "(instance_<id>.ply; needs --instances)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) to this dir")
    p.add_argument("--stream-every", type=int, default=0,
                   help="active-window block streaming cadence (0 = off)")
    p.add_argument("--stream-radius", type=float, default=4.0,
                   help="active-window radius in meters (blocks beyond "
                        "stream to host DRAM)")
    p.add_argument("--clean-every", type=int, default=0,
                   help="map hygiene cadence (confidence culling, 0 = off)")
    p.add_argument("--gt-odometry", action="store_true",
                   help="bypass tracking: fuse at the dataset's ground-truth "
                        "poses (isolates the mapping pipeline)")
    p.add_argument("--local-loops", action="store_true",
                   help="active/inactive local loop closure (per-block "
                        "observation stamps; blocks map only)")
    p.add_argument("--local-every", type=int, default=3,
                   help="local-loop evidence poll cadence in frames")
    p.add_argument("--shards", type=int, default=0,
                   help="override the preset's map shard count (0 = preset "
                        "default); above 1 runs that many ranks")
    p.add_argument("--reshard-every", type=int, default=0,
                   help="occupancy-rebalance poll cadence for the sharded map")
    p.add_argument("--reshard-skew", type=float, default=1.5,
                   help="max/mean blocks-per-shard ratio that triggers a rebalance")
    p.add_argument("--sentinel", action="store_true",
                   help="enable the map-consistency drift sentinel (EWMA of "
                        "frame-to-frame vs frame-to-model disagreement; a "
                        "persistent alarm forces out-of-cadence loop-closure "
                        "keyframes)")
    p.add_argument("--sentinel-thresh", type=float, default=0.0012,
                   help="sentinel alarm threshold in meters")


def _config(args):
    from instancefusion_tpu_torch.config import (
        PRESETS, EngineConfig, IcpConfig, RaycastConfig, TsdfConfig,
    )
    from instancefusion_tpu_torch.geometry.camera import Intrinsics

    if args.small:
        cfg = EngineConfig(
            intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120),
            tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                            origin=(-1.92, -1.92, -0.4)),
            icp=IcpConfig(iters=(10, 7, 7), min_valid=60, rgb_weight=0.0),
            raycast=RaycastConfig(near=0.2, far=4.0),
        )
    else:
        cfg = PRESETS[args.preset]()
    if args.shards:
        cfg = dataclasses.replace(cfg, num_shards=args.shards)
    if args.sentinel:
        cfg = dataclasses.replace(cfg, consistency_check=True,
                                  consistency_thresh=args.sentinel_thresh)
    if args.instances and not cfg.use_instances:
        cfg = dataclasses.replace(cfg, map_kind="blocks", use_instances=True)
    if args.local_loops:
        cfg = dataclasses.replace(cfg, map_kind="blocks", track_stamps=True)
    return cfg


def _sequence(args, cfg, dev):
    """(frame iterator, ground-truth poses (N,4,4) or None, first pose or
    None, the configuration with the dataset's intrinsics)."""
    import numpy as np

    if args.dataset == "synthetic":
        from instancefusion_tpu_torch.datasets import synthetic

        poses = synthetic.orbit_trajectory(args.frames, device=dev)
        frames = (synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(args.frames))
        gt = poses.cpu().numpy()
        return frames, gt, gt[0], cfg
    if os.path.isdir(os.path.join(args.dataset, "intrinsic")):
        from instancefusion_tpu_torch.datasets import scannet

        seq = scannet.ScanNetSequence(args.dataset, device=dev)
        if seq.intrinsics is not None:
            cfg = dataclasses.replace(cfg, intrinsics=seq.intrinsics)
        frames = seq.frames(limit=args.frames or None)
        decoder = "png (depth), PIL (JPEG color)"
    else:
        from instancefusion_tpu_torch.datasets import tum

        seq = tum.TumSequence(args.dataset, cfg.intrinsics, device=dev)
        frames = seq.frames(limit=args.frames or None)
        decoder = seq.decoder
    print(f"decoder: {decoder}", file=sys.stderr, flush=True)
    gt = seq.gt_poses(limit=args.frames or None)
    return frames, gt, None if gt is None else np.asarray(gt)[0], cfg


def _segment_fn(args, cfg, dev):
    if not args.instances:
        return None
    k = cfg.instances.max_instances
    if args.seg_head == "trained":
        from instancefusion_tpu_torch.models import segmentation as segm

        model = segm.load_pretrained(device=dev)
        return lambda frame: segm.segment(model, frame.color, k)
    if args.dataset == "synthetic":
        from instancefusion_tpu_torch.datasets import synthetic

        return lambda frame: synthetic.gt_segmentation(frame.instance, k)
    return None


def _profiler(out_dir: str | None, dev):
    """A ``torch.profiler`` session for ``--profile`` (CPU, and CUDA on the
    card), else a no-op context."""
    if not out_dir:
        return contextlib.nullcontext()
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _gathered(args, cfg, state, group):
    """The final map (and votes) of a sharded run as a one-device BlockMap
    on rank 0's device, for the exports; None on the other ranks.  A
    collective: every rank calls it."""
    import torch

    from instancefusion_tpu_torch import convert
    from instancefusion_tpu_torch.ops.labels import LabelVotes

    arrays = convert.sharded_map_to_global(state.volume, group)
    votes = None
    if state.votes is not None:
        lab = convert.gather_rows(state.votes.label, group)
        cnt = convert.gather_rows(state.votes.count, group)
        if group.rank == 0:
            votes = LabelVotes(label=torch.as_tensor(lab, device=group.device),
                               count=torch.as_tensor(cnt, device=group.device))
    if group.rank != 0:
        return None
    return state._replace(volume=convert.block_map_from_global(arrays, group.device),
                          votes=votes)


def _export(args, cfg, res, state=None) -> None:
    from instancefusion_tpu_torch.utils import meshing
    from instancefusion_tpu_torch.utils.ate import rotmat_to_quat

    state = res.state if state is None else state
    volume = state.volume
    if args.export_mesh:
        if volume.color.numel() > 0:
            verts, tris, cols = meshing.extract_mesh(volume, cfg.tsdf, with_color=True)
            meshing.save_ply(args.export_mesh, verts, tris, colors=cols)
        else:
            verts, tris = meshing.extract_mesh(volume, cfg.tsdf)
            meshing.save_ply(args.export_mesh, verts, tris)
    if args.export_instances:
        if state.votes is None:
            print("--export-instances needs --instances", file=sys.stderr)
        else:
            os.makedirs(args.export_instances, exist_ok=True)
            parts = meshing.extract_instance_meshes(volume, state.votes, cfg.tsdf)
            for gid, (v, t) in parts.items():
                meshing.save_ply(
                    os.path.join(args.export_instances, f"instance_{gid}.ply"), v, t)
            if not args.quiet:
                print(f"exported {len(parts)} instance models", file=sys.stderr)
    if args.export_traj:
        with open(args.export_traj, "w") as f:
            for i, T in enumerate(res.poses):
                # TUM format: t tx ty tz qx qy qz qw
                q = rotmat_to_quat(T[:3, :3])
                t = T[:3, 3]
                f.write(f"{i / 30.0:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def cmd_run(args: argparse.Namespace) -> int:
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.parallel import mesh

    cfg = _config(args)
    shards = cfg.num_shards
    if shards > 1:
        pipeline.check_sharded(cfg, args.local_loops)
    if shards > 1 and mesh.current() is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            mesh.initialize_multihost(args.device)
        else:
            return mesh.launch(_run, shards, args, device=args.device)
    return _run(args)


def _run(args: argparse.Namespace) -> int:
    """One rank's run (the only one without sharding)."""
    import numpy as np

    from instancefusion_tpu_torch import device as _device
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.parallel import mesh
    from instancefusion_tpu_torch.utils.ate import ate_rmse
    from instancefusion_tpu_torch.utils.metrics import MetricsWriter

    cfg = _config(args)
    group = mesh.group_for(cfg.num_shards, args.device) if cfg.num_shards > 1 else None
    lead = group is None or group.rank == 0
    dev = group.device if group is not None else _device.resolve(args.device)
    frames, gt, T0, cfg = _sequence(args, cfg, dev)
    segment_fn = _segment_fn(args, cfg, dev)

    metrics = (MetricsWriter(args.metrics_out, echo=not args.quiet) if lead
               else None)
    prof = _profiler(args.profile, dev)
    with prof:
        res = pipeline.run(
            cfg,
            frames,
            T_init_wc=T0,
            segment_fn=segment_fn,
            metrics=metrics,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            enable_loops=args.loops,
            resume=args.resume,
            clean_every=args.clean_every,
            stream_every=args.stream_every,
            stream_radius=args.stream_radius,
            gt_odometry=gt if (args.gt_odometry and gt is not None) else None,
            local_loops=args.local_loops,
            local_every=args.local_every,
            reshard_every=args.reshard_every,
            reshard_skew=args.reshard_skew,
            device=dev,
        )
    if metrics is not None:
        metrics.close()
    if args.profile and lead:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    state = None
    if group is not None and (args.export_mesh or args.export_instances):
        state = _gathered(args, cfg, res.state, group)
    if not lead:
        return 0
    _export(args, cfg, res, state)

    summary = {
        "frames": int(res.poses.shape[0]),
        "fps": res.fps,
        "keyframes": res.n_keyframes,
        "loop_closures": res.n_loops,
    }
    if gt is not None and len(res.poses) == len(gt):
        summary["ate_rmse_m"] = ate_rmse(res.poses, np.asarray(gt))
    print(json.dumps({"summary": summary}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ifusion-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run SLAM over a sequence")
    _add_run_args(runp)
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    parser.error(f"unknown command {args.cmd}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
