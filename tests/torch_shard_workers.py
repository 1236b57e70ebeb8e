"""Rank-side tasks of the sharded-map tests (tests/test_torch_*sharded*.py,
tests/test_torch_shard.py).

Each function runs on every rank of a ``parallel.mesh.RankPool`` on the
CPU: it takes numpy arrays and the port's config objects, finds its group
with ``mesh.current()``, and returns numpy arrays.  This module imports
no JAX, so the rank processes start without it.
"""

from __future__ import annotations

import numpy as np
import torch

from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.ops import ba
from instancefusion_tpu_torch.ops.labels import LabelVotes
from instancefusion_tpu_torch.parallel import mesh, shard


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _map(arrays):
    g = mesh.current()
    return convert.sharded_map_from_global(arrays, g.rank, g.size, "cpu")


def fused_step(arrays, depth, color, prior, T_wc, intr, cfg, rc_cfg, k_local):
    """The splat-path map update; also how full the rank's in-frustum list
    ran (``blocks.LIST_FILL``)."""
    from instancefusion_tpu_torch.ops import blocks

    g = mesh.current()
    blocks.LIST_FILL.reset()
    bm, maps = shard.fused_step_map(_map(arrays), _t(depth), _t(color), _t(prior),
                                    _t(T_wc), g, intr, cfg, rc_cfg, k_local=k_local)
    return _np(bm), _np(maps), blocks.LIST_FILL.read()


def integrate(arrays, depth, color, T_wc, intr, cfg, max_touched):
    g = mesh.current()
    bm = shard.integrate(_map(arrays), _t(depth), _t(color), _t(T_wc), g, intr, cfg,
                         max_touched=max_touched)
    return _np(bm)


def raycast(arrays, T_wc, intr, cfg, rc_cfg, halo_cap):
    g = mesh.current()
    maps, halo = shard.raycast(_map(arrays), _t(T_wc), g, intr, cfg, rc_cfg,
                               halo_cap=halo_cap, return_halo=True)
    return _np(maps), [int(x) for x in halo]


def gather_map(arrays):
    g = mesh.current()
    return convert.sharded_map_to_global(_map(arrays), g)


def labels(arrays, label, count, gid, depth, T_wc, p_w, valid, intr, cfg):
    g = mesh.current()
    bm = _map(arrays)
    votes = LabelVotes(label=convert.sharded_rows_from_global(label, g.rank, g.size, "cpu"),
                       count=convert.sharded_rows_from_global(count, g.rank, g.size, "cpu"))
    votes = shard.fuse_labels(votes, bm, _t(gid), _t(depth), _t(T_wc), g, intr, cfg)
    ids = shard.sample_labels(votes, bm, _t(p_w), _t(valid), g, cfg)
    return _np(votes), _np(ids)


def clean(arrays, cfg, min_weight):
    g = mesh.current()
    bm, _ = shard.clean(_map(arrays), g, cfg, min_weight=min_weight)
    return _np(bm)


def reshard(arrays, label, count, cfg, cuts, migrate_cap):
    """Rows to their owners under `cuts` (rounds until none is left);
    returns (map, votes, rows migrated, rounds)."""
    g = mesh.current()
    bm = _map(arrays)._replace(cuts=_t(cuts))
    votes = LabelVotes(label=convert.sharded_rows_from_global(label, g.rank, g.size, "cpu"),
                       count=convert.sharded_rows_from_global(count, g.rank, g.size, "cpu"))
    moved, rounds = 0, 0
    while True:
        bm, votes, migrated, left = shard.reshard(bm, g, cfg, votes=votes,
                                                  migrate_cap=migrate_cap)
        moved += int(migrated.sum())
        rounds += 1
        if int(left.sum()) == 0 or rounds > 32:
            break
    return _np(bm), _np(votes), moved, rounds


def ba_terms(paired_in, graph_in, partials_in):
    """The three sharded reducers on this rank's slices: paired Schur terms
    and the hybrid solve through them on (poses, points, paired obs, pose
    graph); pose-graph normal equations on (poses, graph); generic
    partials on (poses, points, observations)."""
    g = mesh.current()
    poses, points, pobs, edges = paired_in
    poses, points = _t(poses), _t(points)
    pobs = ba.PairedObs(*(_t(x) for x in pobs))
    edges = ba.PoseGraph(*(_t(x) for x in edges))
    paired = shard.sharded_paired_terms(g)(poses, points, pobs)
    solve = ba.optimize_hybrid_paired(poses, edges, points, pobs, iters=6,
                                      terms_fn=shard.sharded_paired_terms(g))
    pg_poses, pg_edges = graph_in
    pg = shard.sharded_pose_graph_normal_eqs(g, _t(pg_poses),
                                             ba.PoseGraph(*(_t(x) for x in pg_edges)))
    b_poses, b_points, obs = partials_in
    partials = shard.sharded_ba_partials(g)(_t(b_poses), _t(b_points),
                                            ba.BAObservations(*(_t(x) for x in obs)))
    return _np(paired), _np(solve), _np(pg), _np(partials)


def stream_roundtrip(arrays, cfg, radius, center_far, center_home, cuts):
    """Evict everything beyond `radius` of `center_far`, move the cuts and
    reshard, admit the window at `center_home`; returns the map before, after
    the eviction and after the round trip (gathered on rank 0), and the
    store's size after the eviction and at the end."""
    from instancefusion_tpu_torch.engine.streaming import ShardedBlockStreamer

    g = mesh.current()
    bm = _map(arrays)
    before = convert.sharded_map_to_global(bm, g)
    st = ShardedBlockStreamer(cfg, g, radius=radius, evict_cap=shard.local_capacity(cfg, g.size))
    bm, _, _, _ = st.evict(bm, None, np.asarray(center_far, np.float64))
    evicted = convert.sharded_map_to_global(bm, g)
    stored = len(st.store)
    bm = bm._replace(cuts=_t(cuts))
    bm, _, _, _ = shard.reshard(bm, g, cfg, migrate_cap=shard.local_capacity(cfg, g.size))
    bm, _, _, _ = st.admit(bm, None, np.asarray(center_home, np.float64))
    after = convert.sharded_map_to_global(bm, g)
    return before, evicted, after, stored, len(st.store)


def _frames_t(frames):
    return [(_t(d), _t(c)) for d, c in frames]


def _digest(st):
    return {"T_wc": _np(st.T_wc), "directory": _np(st.volume.directory),
            "n_active": _np(st.volume.n_active), "valid": int(st.pred.valid.sum()),
            "pred_depth": _np(st.pred.depth)}


def slam_steps(cfg, frames, T0):
    """Step the sharded engine over `frames`; per frame the replicated
    digest and track_ok, then the same frames through run_chunk."""
    from instancefusion_tpu_torch.engine import slam_sharded

    g = mesh.current()
    frames = _frames_t(frames)
    st = slam_sharded.init_state(cfg, g, _t(T0))
    out = []
    for d, c in frames:
        st, info = slam_sharded.step(cfg, g, st, d, c)
        out.append((_digest(st), bool(info.track_ok)))
    rows = _np(st.volume)
    st2 = slam_sharded.init_state(cfg, g, _t(T0))
    st2, infos = slam_sharded.run_chunk(cfg, g, st2, [d for d, _ in frames],
                                        [c for _, c in frames])
    return out, rows, _digest(st2), _np(st2.volume), _np(infos.track_ok)


def seg_fuse(cfg, frames, T0, segs):
    """Step the sharded engine over `frames`, then fuse each segmentation
    (``fuse_segmentation``, merges included) at the last frame; returns the
    gathered map, votes and table on rank 0."""
    from instancefusion_tpu_torch.engine import slam_sharded
    from instancefusion_tpu_torch.models.segmentation import Segmentation

    g = mesh.current()
    frames = _frames_t(frames)
    st = slam_sharded.init_state(cfg, g, _t(T0))
    for d, c in frames:
        st, _ = slam_sharded.step(cfg, g, st, d, c)
    arrays = convert.sharded_map_to_global(st.volume, g)
    pred, T = _np(st.pred), _np(st.T_wc)
    for seg in segs:
        st = slam_sharded.fuse_segmentation(cfg, g, st, Segmentation(*(_t(x) for x in seg)),
                                            frames[-1][0], st.T_wc)
    lab = convert.gather_rows(st.votes.label, g)
    cnt = convert.gather_rows(st.votes.count, g)
    return arrays, pred, T, lab, cnt, _np(st.table)


DECISIONS = ("keyframe", "loop_closed", "relocalized")


def seg_steps(cfg, frames, T0, segs):
    """Step the sharded engine over `frames`; the last len(segs) of them go
    through ``step_seg`` with those segmentations.  Returns, on rank 0, each
    step_seg frame's map after its ``step`` (gathered map, prediction, pose,
    track_ok) and the gathered votes and table at the end."""
    from instancefusion_tpu_torch.engine import slam_sharded
    from instancefusion_tpu_torch.models.segmentation import Segmentation

    g = mesh.current()
    frames = _frames_t(frames)
    st = slam_sharded.init_state(cfg, g, _t(T0))
    first = len(frames) - len(segs)
    for d, c in frames[:first]:
        st, _ = slam_sharded.step(cfg, g, st, d, c)
    after_step = []
    step = slam_sharded.step

    def spy(cfg, group, state, depth, color):
        state, info = step(cfg, group, state, depth, color)
        after_step.append((convert.sharded_map_to_global(state.volume, group),
                           _np(state.pred), _np(state.T_wc), bool(info.track_ok)))
        return state, info

    slam_sharded.step = spy
    try:
        for (d, c), seg in zip(frames[first:], segs):
            st, _ = slam_sharded.step_seg(cfg, g, st, d, c,
                                          Segmentation(*(_t(x) for x in seg)))
    finally:
        slam_sharded.step = step
    lab = convert.gather_rows(st.votes.label, g)
    cnt = convert.gather_rows(st.votes.count, g)
    return after_step, lab, cnt, _np(st.table)


def pipeline_run(cfg, frames, T0, kwargs, backend=None):
    """``pipeline.run`` over `frames` (numpy (depth, color, instance, T_wc));
    returns (poses, keyframes, loops, the gathered final map on rank 0,
    per-frame reshard migrations, per-frame DECISIONS).  `backend`, numpy
    arrays of an empty backend (``convert.backend_to_numpy``'s keys), takes
    the place of ``posegraph.allocate``'s, fern coder included."""
    from instancefusion_tpu_torch.datasets.synthetic import Frame
    from instancefusion_tpu_torch.engine import pipeline
    from instancefusion_tpu_torch.utils.metrics import MetricsWriter

    g = mesh.current()
    allocate = pipeline.pg.allocate
    if backend is not None:
        pipeline.pg.allocate = lambda cfg, device=None: convert.backend_from_numpy(
            backend, device=device)

    class Rows(MetricsWriter):
        def __init__(self):
            self.rows = []

        def write(self, row):
            self.rows.append(row)

    rows = Rows()
    try:
        res = pipeline.run(cfg, [Frame(*(_t(x) for x in f)) for f in frames], T_init_wc=T0,
                           metrics=rows, device="cpu", **kwargs)
    finally:
        pipeline.pg.allocate = allocate
    return (res.poses, res.n_keyframes, res.n_loops,
            convert.sharded_map_to_global(res.state.volume, g),
            [r.get("reshard_migrated", 0) for r in rows.rows],
            [tuple(r[k] for k in DECISIONS) for r in rows.rows])


def cli_main(argv):
    from instancefusion_tpu_torch import cli

    return cli.main(argv)


def _head(state, num_classes, width):
    from instancefusion_tpu_torch.models.segmentation import PanopticHead

    model = PanopticHead(num_classes, width)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    return model.eval()


def dp_segment(state, num_classes, width, rgb, k):
    """``models.parallel.dp_segment_fn`` on the batch `rgb` (B, H, W, 3)."""
    from instancefusion_tpu_torch.models import parallel

    fn = parallel.dp_segment_fn(mesh.current(), k)
    return _np(fn(_head(state, num_classes, width), _t(rgb)))


def tp_segment(state, num_classes, width, rgb, k):
    """``models.parallel.tp_segment_fn`` on one frame; also which parameters
    split and the shapes this rank keeps of them."""
    from instancefusion_tpu_torch.models import parallel

    g = mesh.current()
    model = _head(state, num_classes, width)
    shard_params, fn = parallel.tp_segment_fn(g, k)
    head = shard_params(model)
    kept = {name: tuple(p.shape) for name, p in head.named_parameters()}
    return _np(fn(head, _t(rgb))), parallel.tp_param_shardings(model, g), kept
