"""Port pipeline against the reference on relocalization after a blackout
(tests/test_export.py:110's sequence).

The port's backend carries the reference's fern coder (``reference_coder``),
so retrieval decisions compare.  The test holds the reference's behavior,
not tests/test_export.py's 50 mm bound, which the reference itself misses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from instancefusion_tpu.config import PoseGraphConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.engine import pipeline as jpipe
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.engine import pipeline as ppipe
from instancefusion_tpu_torch.utils import checkpoint as pckpt
from tests.helpers import SMALL_CFG, SMALL_INTR
from tests.torch_helpers import (  # noqa: F401 (autouse fixture)
    ListWriter, one_thread, port_frames, reference_backend_arrays, reference_coder,
    reference_state_arrays, to_port,
)

POSE_TOL = 5e-4


def _decisions(rows, keys=("keyframe", "loop_closed", "relocalized")):
    return [{k: r[k] for k in keys} for r in rows]


def test_blackout_relocalization_matches_reference(reference_coder, tmp_path):
    """tests/test_export.py:110's sequence: 10 good frames, 3 blank ones,
    then frame 0's view twice.  The port resumes at frame 10 from the
    reference's own state (engine, keyframes, fern codes) and must take the
    reference's decisions on the blackout and the revisit: the same
    relocalization frame, and every later pose, the final one among them,
    within 5e-4 m of the reference's.

    The first 10 frames are not compared: this 2.5 rad sweep at 160x120
    drifts 150 mm in the reference itself, and there its ICP amplifies
    rounding (from a common state one step agrees to < 4e-6 m; after 5
    frames the two runs are 6.5 mm apart and frame 6 loses track in one).
    """
    cfg = dataclasses.replace(SMALL_CFG, posegraph=PoseGraphConfig(
        keyframe_every=2, max_keyframes=16, max_edges=64, fern_count=256,
        loop_dist_thresh=0.3, ba_iters=4))
    poses = synthetic.orbit_trajectory(16, sweep=2.5)
    frames = [synthetic.render_frame(poses[i], SMALL_INTR) for i in range(16)]
    blank = frames[0]._replace(depth=jnp.zeros_like(frames[0].depth),
                               color=jnp.zeros_like(frames[0].color))
    seq = frames[:10] + [blank] * 3 + [frames[0]] * 2
    rw, pw = ListWriter(), ListWriter()
    ref = jpipe.run(cfg, seq, T_init_wc=poses[0], metrics=rw, relocalize_after=3)
    head = jpipe.run(cfg, seq[:10], T_init_wc=poses[0], relocalize_after=3)
    assert head.n_loops == 0  # the map anchor is still the identity
    np.testing.assert_array_equal(head.poses, ref.poses[:10])
    pcfg = to_port(cfg)
    cdir = str(tmp_path / "ckpt")
    state = convert.state_from_numpy(reference_state_arrays(head.state), pcfg, device="cpu")
    backend = convert.backend_from_numpy(reference_backend_arrays(head.backend), device="cpu")
    pckpt.save(cdir, (state, backend, torch.eye(4)), pcfg, 10)
    out = ppipe.run(pcfg, port_frames(seq), T_init_wc=np.array(poses[0]), metrics=pw,
                    relocalize_after=3, checkpoint_dir=cdir, checkpoint_every=100,
                    resume=True, device="cpu")
    reloc = [r["frame"] for r in rw.rows if r["relocalized"]]
    assert reloc == [13]
    assert [r["frame"] for r in pw.rows if r["relocalized"]] == reloc
    assert _decisions(pw.rows) == _decisions(rw.rows[10:])
    assert out.n_keyframes == ref.n_keyframes
    np.testing.assert_allclose(out.poses[-1], ref.poses[-1], atol=POSE_TOL)
    np.testing.assert_allclose(out.poses, ref.poses[10:], atol=POSE_TOL)
