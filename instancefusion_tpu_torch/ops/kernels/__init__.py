"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

K1 ``preprocess.fused_preprocess``, K2 ``icp.gather_target_maps``, K3
``icp.gn_iterations``, K4 ``tsdf.integrate``, K5 ``raycast.splat_planes``
and K7 ``labels.label_vote``.  Each wrapper launches its kernel for CUDA
tensors and runs its plain version for CPU tensors.
"""

from instancefusion_tpu_torch.ops.kernels import icp, labels, preprocess, raycast, tsdf


def wrappers():
    """The kernel wrappers by kernel id; each carries a ``launches`` count."""
    return {
        "K1": preprocess.fused_preprocess,
        "K2": icp.gather_target_maps,
        "K3": icp.gn_iterations,
        "K4": tsdf.integrate,
        "K5": raycast.splat_planes,
        "K7": labels.label_vote,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
