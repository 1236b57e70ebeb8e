"""Frozen engine configuration: the reference package's dataclasses and presets.

Field for field the same as ``instancefusion_tpu/config.py`` (a test holds
the two equal), so one set of numbers describes a run of either package.
Knobs that change results keep their meaning.  Knobs that pick a TPU
implementation do not apply here: the port picks its implementation by the
device the tensors live on (the hand-written CUDA kernels on a CUDA tensor,
their plain PyTorch versions on a CPU tensor), so ``IcpConfig.use_pallas``,
``TsdfConfig.use_pallas``, ``TsdfConfig.bin_groups``,
``TsdfConfig.group_capacity`` and ``PreprocessConfig.use_pallas`` are
carried for parity and not read.
"""

from __future__ import annotations

import dataclasses

from reference.geometry.camera import Intrinsics, TUM_FR1, TUM_FR3


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    # Gauss-Newton iterations per pyramid level, coarse -> fine.
    iters: tuple[int, ...] = (10, 5, 4)
    levels: int = 3
    dist_thresh: float = 0.10  # m, association gate
    angle_thresh: float = 0.34  # normal agreement gate (dot product)
    # Share of the joint system's information carried by the photometric
    # term (0 disables it).
    rgb_weight: float = 0.0
    damping: float = 1e-6  # diagonal damping of the 6x6 solve
    huber_delta: float = 0.0  # m; 0 = hard gating only
    # Re-associate every k Gauss-Newton steps; a tuple is per level,
    # coarse -> fine like `iters`.
    assoc_every: int | tuple[int, ...] = 1
    # Share of the previous frame's twist replayed as the ICP seed.
    vel_seed: float = 0.8
    min_valid: int = 100  # tracking-health gate: min associated pixels
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    voxel_size: float = 0.02  # m
    trunc: float = 0.08  # m, truncation band
    max_weight: float = 64.0
    grid_size: int = 128  # voxels per axis of the (virtual) volume
    origin: tuple[float, float, float] = (-1.28, -1.28, 0.0)
    block_size: int = 8  # voxels per block edge
    table_capacity: int = 16384  # payload slots of the block map
    # Per-frame block list length for integrate + splat prediction.
    touched_capacity: int = 4096
    group_capacity: int = 1024
    use_pallas: bool = False
    bin_groups: bool = False


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    step_scale: float = 0.75
    refine_steps: int = 6
    near: float = 0.1  # m
    far: float = 5.0  # m
    use_depth_prior: bool = False
    screen_space_normals: bool = False
    use_splat: bool = False  # predict by splatting the listed blocks
    splat_rmax: int = 8  # max tent radius (px)
    predict_color: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    bilateral_radius: int = 2
    bilateral_sigma_space: float = 1.7
    bilateral_sigma_depth: float = 0.04  # m
    depth_min: float = 0.1  # m
    depth_max: float = 5.0  # m
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class InstanceConfig:
    max_instances: int = 96
    num_classes: int = 41
    seg_every: int = 8
    iou_match_thresh: float = 0.3
    merge_iou_thresh: float = 0.25
    min_mask_pixels: int = 200


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    keyframe_every: int = 20
    max_keyframes: int = 512
    max_edges: int = 2048
    fern_count: int = 512
    loop_dist_thresh: float = 0.08
    ba_iters: int = 8
    huber_delta: float = 0.05
    use_landmark_ba: bool = True
    landmarks_per_loop: int = 192
    max_landmarks: int = 2048
    landmark_weight: float = 5.0
    local_window: int = 150
    local_min_pixels: int = 3000
    local_min_inlier_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    intrinsics: Intrinsics = TUM_FR1
    icp: IcpConfig = IcpConfig()
    tsdf: TsdfConfig = TsdfConfig()
    raycast: RaycastConfig = RaycastConfig()
    preprocess: PreprocessConfig = PreprocessConfig()
    instances: InstanceConfig = InstanceConfig()
    posegraph: PoseGraphConfig = PoseGraphConfig()
    use_color: bool = True
    # Fuse frame color every k-th frame, scaled by k on those frames.
    color_every: int = 1
    use_instances: bool = False
    track_stamps: bool = False
    map_kind: str = "dense"  # 'dense' or 'blocks'
    num_shards: int = 1
    consistency_check: bool = False
    consistency_alpha: float = 0.05
    consistency_thresh: float = 0.0012


def config1_tum_fr1_desk() -> EngineConfig:
    """TUM fr1_desk 640x480, 128^3 dense TSDF."""
    return EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(voxel_size=0.025, trunc=0.1, grid_size=128,
                        origin=(-1.6, -1.6, 0.0)),
        map_kind="dense",
        use_instances=False,
    )


def config2_tum_fr3_long_office() -> EngineConfig:
    """TUM fr3_long_office, 512^3 block map with splat prediction."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.01, trunc=0.04, grid_size=512,
                        origin=(-2.56, -2.56, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=False,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True,
                              use_splat=True),
    )


def config3_scannet_instances() -> EngineConfig:
    """ScanNet scene with instance fusion on the 512^3 block map."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.01, trunc=0.04, grid_size=512,
                        origin=(-2.56, -2.56, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=True,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True,
                              use_splat=True),
    )


def config4_posegraph_sharded() -> EngineConfig:
    """Multi-room pose graph + loop-closure BA, map sharded on one host."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.02, trunc=0.08, grid_size=512,
                        origin=(-5.12, -5.12, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=False,
        num_shards=8,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True,
                              use_splat=True),
    )


def config5_multihost() -> EngineConfig:
    """Large run sharded across hosts."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.02, trunc=0.08, grid_size=1024,
                        origin=(-10.24, -10.24, 0.0), block_size=8,
                        table_capacity=131072),
        map_kind="blocks",
        use_instances=True,
        num_shards=8,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True,
                              use_splat=True),
    )


PRESETS = {
    "config1": config1_tum_fr1_desk,
    "config2": config2_tum_fr3_long_office,
    "config3": config3_scannet_instances,
    "config4": config4_posegraph_sharded,
    "config5": config5_multihost,
}
