"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

K1 ``preprocess.fused_preprocess``, K2 ``icp.associate_gather``, K3
``icp.gn_iterations``, K4 ``tsdf.integrate``, K5 ``raycast.splat_planes``,
K6 ``icp.normal_equations``, K7 ``labels.label_vote`` and K8
``tsdf.tsdf_update``.  Each wrapper launches its kernel for CUDA tensors
and runs its plain version for CPU tensors.
"""

from instancefusion_tpu_torch.ops.kernels import icp, labels, preprocess, raycast, tsdf


def wrappers():
    """The kernel wrappers by kernel id; each carries a ``launches`` count
    (K2 and K3 also ``launches_rgb``, their launches with the photometric
    planes; K4 and K5 ``launches_color``, their launches with color).  The
    counts grow at each call, eager or inside a CUDA-graph capture; a
    replay of a captured graph is not counted."""
    return {
        "K1": preprocess.fused_preprocess,
        "K2": icp.associate_gather,
        "K3": icp.gn_iterations,
        "K4": tsdf.integrate,
        "K5": raycast.splat_planes,
        "K6": icp.normal_equations,
        "K7": labels.label_vote,
        "K8": tsdf.tsdf_update,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for variant in ("launches_rgb", "launches_color"):
            if hasattr(fn, variant):
                setattr(fn, variant, 0)
