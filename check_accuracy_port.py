"""Pose accuracy of the PyTorch/CUDA port on the synthetic rigs.

    python3 check_accuracy_port.py              # bare engine, clean orbit
    NOISY=1 python3 check_accuracy_port.py      # bare engine, noisy fr1-mean rig
    PIPELINE=1 python3 check_accuracy_port.py   # full pipeline, sustained-drift rig

The port's twin of ``_check_ate512.py`` (bare engine) and of
``_check_drift_pipeline.py`` (``PIPELINE=1``), with their configurations
and environment knobs.  Runs on the card; imports nothing of JAX.

Bare engine (``slam.step`` per frame) at the bench geometry (TUM fr1
640x480, 512^3 block map of 8^3 blocks, table 65536, 2048 listed blocks,
ICP (10,5,4) with association every (2,2,4), splat prediction without
color): ``N`` frames (40) of the clean orbit, or with ``NOISY=1`` of the
handheld rig (``SWEEP`` 0.8, ``SHAKE`` 0.012, translation shake 0.008)
with Kinect noise drawn from a ``torch.Generator`` seeded 0.  ``ASSOC``
(association every k steps at all levels), ``VEL`` (velocity seed, 0.8),
``RGB`` (photometric weight, 0), ``TEXTURE`` (textured renders) apply to
the noisy rig, ``CONSISTENCY=1`` runs the drift sentinel.  Fails unless the
largest translation error is below 20 mm clean, 30 mm noisy
(``NO_ATE_GATE=1`` skips the gate), as ``_check_ate512.py``.

Pipeline (``pipeline.run``): ``N`` frames (120) of the handheld rig at
``SWEEP`` 1.6, ``SHAKE`` 0.02 with Kinect noise, keyframes every
``KF_EVERY`` (8), the sentinel (``SENTINEL`` 1, threshold ``SENT_THRESH``
0.0012), loop threshold ``LOOP_THRESH`` (0.12), ``PoseGraphConfig``'s other
defaults (512 keyframes, 2048 edges, 512 ferns, 192 landmarks a loop, a
bank of 2048); ``GRID`` (512) sizes the map.  Prints keyframes, loops,
relocalizations, the sentinel's alarms, the translation errors and the ATE.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def bare_config(noisy: bool):
    """``_check_ate512.py``'s configuration (and its noisy-rig knobs)."""
    from instancefusion_tpu_torch.config import (
        EngineConfig, IcpConfig, PreprocessConfig, RaycastConfig, TsdfConfig,
    )
    from instancefusion_tpu_torch.geometry.camera import TUM_FR1

    grid = 512
    extent = grid * 0.0075
    icp = IcpConfig(iters=(10, 5, 4), rgb_weight=0.0, use_pallas=True, assoc_every=(2, 2, 4))
    if noisy:
        ae = int(_env("ASSOC", "0"))
        icp = IcpConfig(iters=(10, 5, 4), rgb_weight=float(_env("RGB", "0.0")), use_pallas=True,
                        assoc_every=(ae, ae, ae) if ae else (2, 2, 4),
                        vel_seed=float(_env("VEL", "0.8")))
    return EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(
            voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
            grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
            block_size=8, table_capacity=65536, touched_capacity=2048, use_pallas=True,
        ),
        icp=icp,
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True, use_splat=True,
                              predict_color=False),
        preprocess=PreprocessConfig(use_pallas=True),
        map_kind="blocks", use_color=True,
        consistency_check=_env("CONSISTENCY", "0") == "1",
    )


def pipeline_config():
    """``_check_drift_pipeline.py``'s configuration at the card's settings
    (the fused kernels and splat prediction, as it runs on a TPU)."""
    from instancefusion_tpu_torch.config import (
        EngineConfig, IcpConfig, PoseGraphConfig, PreprocessConfig, RaycastConfig,
        TsdfConfig,
    )
    from instancefusion_tpu_torch.geometry.camera import TUM_FR1

    grid = int(_env("GRID", "512"))
    extent = grid * 0.0075
    return EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(
            voxel_size=extent / grid * 2, trunc=6 * extent / grid * 2,
            grid_size=grid, origin=(-extent, -extent, 1.2 - extent),
            block_size=8, table_capacity=65536, touched_capacity=2048, use_pallas=True,
        ),
        icp=IcpConfig(iters=(10, 5, 4), rgb_weight=0.0, use_pallas=True,
                      assoc_every=(2, 2, 4), vel_seed=0.8),
        raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                              screen_space_normals=True, use_splat=True,
                              predict_color=False),
        preprocess=PreprocessConfig(use_pallas=True),
        posegraph=PoseGraphConfig(
            keyframe_every=int(_env("KF_EVERY", "8")),
            loop_dist_thresh=float(_env("LOOP_THRESH", "0.12")),
        ),
        map_kind="blocks", use_color=True,
        consistency_check=_env("SENTINEL", "1") == "1",
        consistency_thresh=float(_env("SENT_THRESH", "0.0012")),
    )


def rig_frames(cfg, n: int, noisy: bool, sweep: float = 0.8, shake: float = 0.012,
               texture: bool = False, seed: int = 0, device=None):
    """(poses (n,4,4), frames): the clean orbit, or the handheld rig
    (translation shake 0.008) with Kinect noise from one ``torch.Generator``
    seeded `seed`, drawn frame after frame."""
    from instancefusion_tpu_torch.datasets import synthetic

    if not noisy:
        poses = synthetic.orbit_trajectory(n, device=device)
        return poses, [synthetic.render_frame(poses[i], cfg.intrinsics) for i in range(n)]
    poses = synthetic.handheld_trajectory(n, sweep=sweep, shake_rot=shake, shake_trans=0.008,
                                          device=device)
    gen = torch.Generator(device=poses.device)
    gen.manual_seed(seed)
    frames = [synthetic.add_sensor_noise(
        synthetic.render_frame(poses[i], cfg.intrinsics, texture=texture), gen)
        for i in range(n)]
    return poses, frames


def translation_errors(est: np.ndarray, poses) -> np.ndarray:
    """Per-frame translation error (m) of the estimated (n,4,4) poses."""
    gt = poses.cpu().numpy() if isinstance(poses, torch.Tensor) else np.asarray(poses)
    return np.linalg.norm(est[:, :3, 3] - gt[: len(est), :3, 3], axis=-1)


def run_bare(cfg, frames, poses) -> dict:
    """``slam.step`` over `frames` from the first pose; returns the per-frame
    errors (m), the sentinel's EWMA (mm) and alarms where it runs, the map's
    active and overflowed blocks, and the frames/s of the run."""
    from instancefusion_tpu_torch.engine import slam

    state = slam.init_state(cfg, poses[0])
    est, infos = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        state, info = slam.step(cfg, state, f.depth, f.color)
        est.append(state.T_wc)
        infos.append(info)
    torch.cuda.synchronize()
    fps = len(frames) / (time.perf_counter() - t0)
    out = {"errs": translation_errors(torch.stack(est).cpu().numpy(), poses),
           "n_active": int(state.volume.n_active), "overflow": int(state.volume.overflow),
           "fps": fps, "track_ok": torch.stack([i.track_ok for i in infos]).cpu().numpy()}
    if infos and infos[0].drift_alarm is not None:
        out["ewma_mm"] = torch.stack([i.drift_ewma for i in infos]).cpu().numpy() * 1000
        out["alarms"] = torch.stack([i.drift_alarm for i in infos]).cpu().numpy()
    return out


def run_pipeline(cfg, frames, poses, **kw):
    """``pipeline.run`` over `frames` from the first pose; returns the
    result, its metrics rows, the per-frame errors (m) and the frames/s."""
    from instancefusion_tpu_torch.engine import pipeline

    class Rows:
        def __init__(self):
            self.rows = []

        def write(self, record):
            self.rows.append(record)

    rows = Rows()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.run(cfg, frames, T_init_wc=poses[0], metrics=rows, enable_loops=True,
                       relocalize_after=5, **kw)
    torch.cuda.synchronize()
    fps = len(frames) / (time.perf_counter() - t0)
    return res, rows.rows, translation_errors(res.poses, poses), fps


def pipeline_summary(res, rows, errs, poses) -> dict:
    """The drift rig's numbers: keyframes, loops, relocalizations, the
    sentinel's alarms, errors (mm), ATE (mm) and each phase's summed ms."""
    from instancefusion_tpu_torch.utils.ate import ate_rmse

    alarms = [bool(r.get("drift_alarm", False)) for r in rows]
    phases = {}
    for r in rows:
        for k, v in r.items():
            if k.startswith("t_") and k.endswith("_ms"):
                phases[k] = phases.get(k, 0.0) + v
    gt = poses.cpu().numpy()
    return {
        "frames": len(res.poses), "keyframes": res.n_keyframes, "loops": res.n_loops,
        "loops_closed": sum(bool(r["loop_closed"]) for r in rows),
        "relocalizations": sum(bool(r["relocalized"]) for r in rows),
        "alarm_frames": sum(alarms), "first_alarm": alarms.index(True) if any(alarms) else -1,
        "ewma_max_mm": max((r.get("drift_ewma_mm", 0.0) for r in rows), default=0.0),
        "mean_mm": float(errs.mean() * 1e3), "max_mm": float(errs.max() * 1e3),
        "final_mm": float(errs[-1] * 1e3),
        "ate_mm": float(ate_rmse(res.poses, gt[: len(res.poses)]) * 1e3),
        "phase_ms": phases,
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("check_accuracy_port.py needs an NVIDIA GPU")
    card = torch.cuda.get_device_name(0)
    n_default = "120" if _env("PIPELINE", "0") == "1" else "40"
    n = int(_env("N", n_default))
    if _env("PIPELINE", "0") == "1":
        cfg = pipeline_config()
        poses, frames = rig_frames(cfg, n, True, float(_env("SWEEP", "1.6")),
                                   float(_env("SHAKE", "0.02")))
        res, rows, errs, fps = run_pipeline(cfg, frames, poses)
        s = pipeline_summary(res, rows, errs, poses)
        print(f"frames {s['frames']}  keyframes {s['keyframes']}  loops {s['loops']}  "
              f"relocalizations {s['relocalizations']}")
        if s["ewma_max_mm"] > 0:
            print(f"sentinel: ewma max {s['ewma_max_mm']:.3f} mm  alarm_frames "
                  f"{s['alarm_frames']}/{s['frames']}  first_alarm {s['first_alarm']}")
        print(f"trans err: mean {s['mean_mm']:.1f} mm  max {s['max_mm']:.1f} mm  "
              f"final {s['final_mm']:.1f} mm")
        print(f"ate_rmse {s['ate_mm']:.1f} mm  ({fps:.2f} frames/s on {card})")
        return
    noisy = _env("NOISY", "0") == "1"
    cfg = bare_config(noisy)
    poses, frames = rig_frames(cfg, n, noisy, float(_env("SWEEP", "0.8")),
                               float(_env("SHAKE", "0.012")), _env("TEXTURE", "0") == "1")
    r = run_bare(cfg, frames, poses)
    errs = r["errs"]
    print(f"noisy={noisy} trans err: mean {errs.mean() * 1000:.2f} mm  max "
          f"{errs.max() * 1000:.2f} mm  n_active {r['n_active']} overflow {r['overflow']}"
          f"  ({r['fps']:.2f} frames/s on {card})")
    if "alarms" in r:
        alarms = r["alarms"]
        first = int(np.argmax(alarms)) if alarms.any() else -1
        print(f"sentinel: ewma mean {r['ewma_mm'].mean():.3f} mm  max "
              f"{r['ewma_mm'].max():.3f} mm  alarm_frames {int(alarms.sum())}/{len(alarms)}"
              f"  first_alarm {first}")
    if _env("NO_ATE_GATE", "0") != "1":
        assert errs.max() < (0.03 if noisy else 0.02), "tracking drifted"
    print("OK")


if __name__ == "__main__":
    main()
