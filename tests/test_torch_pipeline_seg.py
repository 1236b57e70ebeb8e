"""Port pipeline against the reference on the asynchronous segmentation
(tests/test_pipeline.py:135's run): masks dispatched every 2nd frame are
fused one frame later against their own frame's depth and pose.

The block map at 4 cm voxels amplifies rounding in the tracking: from a
common state one port step agrees with the reference's to < 7e-7 m, but
over these 7 frames the two runs move up to 1.8e-3 m apart (measured), so
poses are held within 2.5e-3 m and the votes on >= 99% of voxels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from instancefusion_tpu.config import InstanceConfig
from instancefusion_tpu.engine import pipeline as jpipe
from instancefusion_tpu.models.segmentation import Segmentation as RefSegmentation
from instancefusion_tpu_torch.datasets.synthetic import Frame
from instancefusion_tpu_torch.engine import pipeline as ppipe
from instancefusion_tpu_torch.models.segmentation import Segmentation
from instancefusion_tpu_torch.utils.ate import ate_rmse
from tests.helpers import SMALL_TSDF
from tests.test_pipeline import CFG, _frames
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    ListWriter, n, one_thread, port_frames, reference_coder, to_port,
)

POSE_TOL = 2.5e-3


def test_async_segmentation_matches_reference(reference_coder):
    """tests/test_pipeline.py:135's run: the head's masks (the frame's
    ground truth) dispatched every 2nd frame and fused one frame later,
    the last one flushed after the loop; the same votes, table and poses."""
    cfg = dataclasses.replace(
        CFG, map_kind="blocks", use_instances=True,
        tsdf=dataclasses.replace(SMALL_TSDF, table_capacity=4096),
        instances=InstanceConfig(max_instances=16, min_mask_pixels=4, seg_every=2))
    frames, poses = _frames(7)
    k = cfg.instances.max_instances
    ref_calls, port_calls = [], []

    def ref_segment(frame):
        ref_calls.append(1)
        present = jnp.arange(k) < 4
        return RefSegmentation(
            mask_id=frame.instance,
            classes=jnp.where(present, jnp.arange(k, dtype=jnp.int32) + 1, 0),
            scores=jnp.where(present, 1.0, 0.0), valid=present)

    def port_segment(frame: Frame):
        port_calls.append(1)
        present = torch.arange(k) < 4
        return Segmentation(
            mask_id=frame.instance,
            classes=torch.where(present, torch.arange(k, dtype=torch.int32) + 1, 0).int(),
            scores=present.float(), valid=present)

    rw, pw = ListWriter(), ListWriter()
    ref = jpipe.run(cfg, frames, T_init_wc=poses[0], segment_fn=ref_segment, metrics=rw,
                    enable_loops=False)
    out = ppipe.run(to_port(cfg), port_frames(frames), T_init_wc=np.array(poses[0]),
                    segment_fn=port_segment, metrics=pw, enable_loops=False, device="cpu")
    assert len(port_calls) == len(ref_calls) == 4  # frames 0, 2, 4, 6
    assert [r["seg_dispatched"] for r in pw.rows] == [r["seg_dispatched"] for r in rw.rows]
    np.testing.assert_allclose(out.poses, ref.poses, atol=POSE_TOL)
    assert ate_rmse(out.poses, np.asarray(poses)) < cfg.tsdf.voxel_size
    count, ref_count = n(out.state.votes.count), np.asarray(ref.state.votes.count)
    assert int((count > 0).sum()) > 500
    # Votes land on the same voxels with the same labels, but for voxels
    # at band edges that the poses' difference moves.
    same = (count > 0) == (ref_count > 0)
    assert same.mean() > 0.99
    both = (count > 0) & (ref_count > 0)
    assert (n(out.state.votes.label)[both] == np.asarray(ref.state.votes.label)[both]).mean() > 0.99
    np.testing.assert_array_equal(n(out.state.table.active), np.asarray(ref.state.table.active))
