"""On the card (these skip elsewhere): the reference's map update replayed
from a CUDA graph, bit for bit against its eager run; device time read by
program span.

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py -q
"""

import pytest
import torch

from harness import judge, scene, spec
from harness import trace as _trace

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
    slam = cell.judge_modules["slam"]
    updates = [slam.MapUpdate(cfg, rblocks.allocate(cfg.tsdf, dev), count_work)
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


def test_span_counts_the_device_work_launched_inside_it():
    """Two products inside a span, one outside; a CUDA graph of one product
    replayed inside a second span and once outside: each span counts its
    own launches' device operations, those of the graph's replay with them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = card()
    a, b = torch.randn(1024, 1024, device=dev), torch.randn(1024, 1024, device=dev)
    for _ in range(3):
        a @ b
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a @ b
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        a @ b
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with record_function(_trace.WINDOW_START):
        pass
    with record_function("bench.test.span"):
        a @ b
        a @ b
    a @ b
    with record_function("bench.test.graph"):
        graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    with record_function(_trace.WINDOW_END):
        pass
    prof.stop()
    tr = _trace.reduce(prof.profiler.kineto_results.events())
    per = tr.n_ops // 5  # five identical products, each as many operations
    assert tr.n_ops == 5 * per and per >= 1
    secs, ops, instances = tr.span_seconds("bench.test.span")
    assert (ops, instances) == (2 * per, 1)
    assert 0.3 * tr.busy_s < secs < 0.5 * tr.busy_s
    g_secs, g_ops, g_instances = tr.span_seconds("bench.test.graph")
    assert (g_ops, g_instances) == (per, 1)
    assert 0.15 * tr.busy_s < g_secs < 0.25 * tr.busy_s
    assert tr.span_seconds("absent") == (0.0, 0, 0)
