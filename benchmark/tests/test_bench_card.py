"""On the card (these skip elsewhere): the reference's map update replayed
from a CUDA graph, bit for bit against its eager run.

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py -q
"""

import pytest
import torch

from harness import judge, scene, spec

# A stretch of the office loop.
FIRST, FRAMES = 2000, 20


def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs run on a card only")
    return torch.device("cuda")


def frames_of(cell, dev, seed):
    intr = cell.config["engine"]["intrinsics"]
    a = cell.config["assumed"]
    poses = scene.loop_poses(a["path_length_m"], a["speed_m_s"] / cell.traffic["sensor_hz"],
                             dev)[FIRST:FIRST + FRAMES]
    depth, color = scene.render_loop(poses, intr, seed)
    return poses, depth, color


@pytest.mark.parametrize("count_work", [False, True])
def test_reference_map_update_graph_is_eager_bit_for_bit(count_work):
    from reference.ops import blocks as rblocks

    dev = card()
    cell = spec.load_cell("config2.replay")
    cfg = judge.reference_config(cell.config["engine"])
    poses, depth, color = frames_of(cell, dev, 2**31 + 43)
    updates = [judge.MapUpdate(cfg, rblocks.allocate(cfg.tsdf, dev), count_work)
               for _ in range(2)]
    updates[1].graphed = False
    for k in range(FRAMES):
        d, c = scene.frame(depth, color, k)
        outs = [u(d, c, poses[k], True, 1.0) for u in updates]
        for a, b in zip(*outs):
            assert (a is None and b is None) or torch.equal(a, b), k
    assert len(updates[0].graphs) == 1
    for name in updates[0].volume._fields:
        a, b = getattr(updates[0].volume, name), getattr(updates[1].volume, name)
        assert torch.equal(a, b), name
