"""Port pipeline against the reference on the sentinel's forced keyframes
(tests/test_pipeline.py:298's run).

The port's backend carries the reference's fern coder (``reference_coder``).
"""

import dataclasses

import numpy as np

from instancefusion_tpu.engine import pipeline as jpipe
from instancefusion_tpu_torch.engine import pipeline as ppipe
from tests.test_pipeline import CFG, _frames
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    ListWriter, one_thread, port_frames, reference_coder, to_port,
)


def _decisions(rows, keys):
    return [{k: r[k] for k in keys} for r in rows]


def test_forced_keyframes_match_reference(reference_coder):
    """tests/test_pipeline.py:298's run: threshold 0 makes the sentinel
    alarm on every frame past its warm-up; the streak forces keyframes the
    cadence (every 100th) would not give, and never a relocalization."""
    frames, poses = _frames(32)
    cfg = dataclasses.replace(
        CFG, posegraph=dataclasses.replace(CFG.posegraph, keyframe_every=100),
        consistency_check=True, consistency_thresh=0.0)
    rw, pw = ListWriter(), ListWriter()
    ref = jpipe.run(cfg, frames, T_init_wc=poses[0], metrics=rw)
    out = ppipe.run(to_port(cfg), port_frames(frames), T_init_wc=np.array(poses[0]),
                    metrics=pw, device="cpu")
    keys = ("keyframe", "loop_closed", "relocalized", "drift_alarm")
    assert _decisions(pw.rows, keys) == _decisions(rw.rows, keys)
    assert out.n_keyframes == ref.n_keyframes >= 2
    assert not any(r["relocalized"] for r in pw.rows)
    # The sentinel's EWMA within 0.05 mm: the poses' 5e-4 m agreement moves
    # it by up to 0.03 mm here.
    np.testing.assert_allclose([r["drift_ewma_mm"] for r in pw.rows],
                               [r["drift_ewma_mm"] for r in rw.rows], atol=0.05)
    # 32 frames of the dense engine: its ill-conditioned ICP moves the poses
    # apart by up to 6.1e-4 m (measured; 2.7e-4 m after 9 frames).
    np.testing.assert_allclose(out.poses, ref.poses, atol=1e-3)
