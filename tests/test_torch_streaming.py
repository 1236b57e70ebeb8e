"""Active-window block streaming: the port's ``blocks.partition_window``,
``admit_rows`` and ``frustum_allocated_mask`` against the reference's on one
fused map carried across as numpy arrays (bit-equal, with and without votes
and stamps);
twins of tests/test_streaming.py's five tests on the port's
``BlockStreamer``; and a store saved by the reference's streamer loaded by
the port's."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.engine.streaming import BlockStreamer as JStreamer
from instancefusion_tpu.ops import blocks as jblocks
from instancefusion_tpu.ops import labels as jlabels
from instancefusion_tpu_torch.datasets import synthetic as psyn
from instancefusion_tpu_torch.engine import pipeline as ppipe
from instancefusion_tpu_torch.engine.streaming import BlockStreamer
from instancefusion_tpu_torch.ops import blocks as pblocks
from instancefusion_tpu_torch.ops import labels as plabels
from instancefusion_tpu_torch.utils import checkpoint as pckpt
from tests.helpers import SMALL_CFG, SMALL_INTR, SMALL_TSDF
from tests.torch_helpers import n, one_thread, t, to_port  # noqa: F401 (autouse fixture)

CFG = to_port(SMALL_TSDF)
INTR = to_port(SMALL_INTR)
RC = to_port(SMALL_CFG.raycast)
B3 = SMALL_TSDF.block_size ** 3


@pytest.fixture(scope="module")
def fused():
    """tests/test_streaming.py's map (4 orbit frames through the touched-block
    integrate, fused by the port), its poses, and distinct per-slot votes
    and stamps, all as reference (jnp) arrays."""
    poses = psyn.orbit_trajectory(4, device="cpu")
    pbm = pblocks.allocate(CFG, "cpu")
    for i in range(4):
        f = psyn.render_frame(poses[i], INTR)
        pbm = pblocks.integrate(pbm, f.depth, f.color, f.T_wc, INTR, CFG)
    bm = jblocks.BlockMap(*(jnp.asarray(n(x)) for x in pbm))
    c = bm.sdf.shape[0]
    rng = np.random.default_rng(0)
    votes = jlabels.LabelVotes(
        label=jnp.asarray(rng.integers(-1, 9, (c, B3)), jnp.int32),
        count=jnp.asarray(rng.uniform(0, 5, (c, B3)), jnp.float32))
    stamp = jnp.stack([jnp.arange(c, dtype=jnp.int32) + 1,
                       jnp.full((c,), 33, jnp.int32)], axis=-1)
    return bm, n(poses), votes, stamp


def _pmap(bm):
    return pblocks.BlockMap(*(t(x) for x in bm))


def _pvotes(votes):
    return None if votes is None else plabels.LabelVotes(*(t(x) for x in votes))


def _equal(port, ref):
    """Every tensor of a nest of NamedTuples / dicts / tuples equals the
    reference's bit for bit."""
    if port is None or ref is None:
        assert port is None and ref is None
    elif isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _equal(port[k], ref[k])
    elif isinstance(port, tuple):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _equal(a, b)
    else:
        np.testing.assert_array_equal(n(port), np.asarray(ref))


EXTRAS = ["plain", "votes+stamps"]
# The reference's functions compiled as its streamer compiles them
# (engine/streaming.py's _partition_jit and _admit_jit).
_partition = jax.jit(jblocks.partition_window, static_argnums=(1, 3, 4))
_admit = jax.jit(jblocks.admit_rows, static_argnums=(1,))


def _extras(fused, extra):
    _, _, votes, stamp = fused
    return (votes if "votes" in extra else None), (stamp if "stamps" in extra else None)


@pytest.mark.parametrize("extra", EXTRAS)
def test_partition_and_admit_equal_reference(fused, extra):
    bm, poses, _, _ = fused
    votes, stamp = _extras(fused, extra)
    pv, ps = _pvotes(votes), None if stamp is None else t(stamp)
    center = poses[1][:3, 3]
    # evict_cap below the cold count: the buffer is bounded, the rest stay.
    ref = _partition(bm, SMALL_TSDF, jnp.asarray(center), 1.2, 32, votes, stamp)
    out = pblocks.partition_window(_pmap(bm), CFG, t(center), 1.2, 32, pv, ps)
    _equal(out, ref)
    assert int(ref[2]["valid"].sum()) == 32
    assert int(ref[0].n_active) == int(bm.n_active) - 32

    ev = ref[2]
    args = (ev["coords"], ev["sdf"], ev["weight"], ev["color"], ev["valid"])
    kw = dict(label=ev.get("label"), count=ev.get("count"), row_stamp=ev.get("stamp"))
    pkw = {k: None if v is None else t(v) for k, v in kw.items()}
    # Into the partitioned map every row comes back; into the original map
    # every row's block is allocated already and none is admitted.
    for target, tv, tstamp in ((ref[0], ref[1], ref[3] if stamp is not None else None),
                               (bm, votes, stamp)):
        radm = _admit(target, SMALL_TSDF, *args, votes=tv, stamp=tstamp, **kw)
        padm = pblocks.admit_rows(_pmap(target), CFG, *(t(a) for a in args), votes=_pvotes(tv),
                                  stamp=None if tstamp is None else t(tstamp), **pkw)
        _equal(padm, radm)
    assert int(padm[2].sum()) == 0


def test_frustum_allocated_mask_equals_reference(fused):
    bm, poses, _, _ = fused
    for i in (0, 3):
        ref = jblocks.frustum_allocated_mask(bm, jnp.asarray(poses[i]), SMALL_INTR, SMALL_TSDF,
                                             0.2, 4.0)
        out = pblocks.frustum_allocated_mask(_pmap(bm), t(poses[i]), INTR, CFG, 0.2, 4.0)
        np.testing.assert_array_equal(n(out), np.asarray(ref))
        assert 0 < int(out.sum()) < int(bm.n_active)


def _rows_by_coord(bm, *planes):
    coords = n(bm.block_coords)
    return {tuple(coords[i]): tuple(n(p[i]) for p in planes) for i in range(int(bm.n_active))}


def test_evict_admit_roundtrip_bit_exact(fused):
    bm = _pmap(fused[0])
    n0 = int(bm.n_active)
    golden = _rows_by_coord(bm, bm.sdf, bm.weight, bm.color)
    streamer = BlockStreamer(CFG, radius=0.4, evict_cap=512, admit_cap=512)
    vol, _, _, n_out = streamer.evict(bm, None, np.array([50.0, 50.0, 50.0], np.float32))
    assert n_out == n0 and int(vol.n_active) == 0 and len(streamer.store) == n0
    assert int((vol.directory >= 0).sum()) == 0
    streamer.radius = 1e9
    vol, _, _, n_in = streamer.admit(vol, None, np.zeros(3, np.float32))
    assert n_in == n0 and len(streamer.store) == 0 and int(vol.n_active) == n0
    got = _rows_by_coord(vol, vol.sdf, vol.weight, vol.color)
    assert set(got) == set(golden)
    for k in golden:
        for a, b in zip(golden[k], got[k]):
            np.testing.assert_array_equal(a, b)


def test_partial_window_keeps_near_blocks_and_raycast(fused):
    bm, poses = _pmap(fused[0]), fused[1]
    cam = poses[0][:3, 3]
    streamer = BlockStreamer(CFG, radius=1.2, evict_cap=4096)
    pre = pblocks.raycast(bm, t(poses[0]), INTR, CFG, RC)
    vol, _, _, n_out = streamer.evict(bm, None, cam)
    assert 0 < n_out < int(bm.n_active)
    post = pblocks.raycast(vol, t(poses[0]), INTR, CFG, RC)
    bsz = CFG.block_size * CFG.voxel_size
    near = pre.valid & (pre.depth < (1.2 - 2 * bsz))
    np.testing.assert_allclose(n(torch.where(near, post.depth, 0.0)),
                               n(torch.where(near, pre.depth, 0.0)), atol=1e-5)
    assert bool(torch.all(post.valid >= (near & pre.valid)))
    streamer.radius = 1e9
    vol, _, _, n_in = streamer.admit(vol, None, cam)
    assert n_in == n_out
    back = pblocks.raycast(vol, t(poses[0]), INTR, CFG, RC)
    np.testing.assert_allclose(n(back.depth), n(pre.depth), atol=1e-6)


def test_streaming_with_votes_roundtrip(fused):
    bm, votes = _pmap(fused[0]), _pvotes(fused[2])
    labelled = (votes.count > 0) & (votes.label >= 0)
    slots = torch.arange(bm.sdf.shape[0]) < bm.n_active
    n_lab0 = int((labelled & slots[:, None]).sum())
    streamer = BlockStreamer(CFG, radius=0.1, evict_cap=4096, with_votes=True)
    far = np.array([99.0, 0.0, 0.0], np.float32)
    vol, votes2, _, n_out = streamer.evict(bm, votes, far)
    assert n_out == int(bm.n_active) and int((votes2.count > 0).sum()) == 0
    streamer.radius = 1e9
    vol, votes3, _, n_in = streamer.admit(vol, votes2, far)
    assert n_in == n_out
    assert int(((votes3.count > 0) & (votes3.label >= 0)).sum()) == n_lab0
    a = _rows_by_coord(bm, votes.label, votes.count)
    b = _rows_by_coord(vol, votes3.label, votes3.count)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


def test_streaming_with_stamps_roundtrip(fused):
    bm, stamp = _pmap(fused[0]), t(fused[3])
    golden = _rows_by_coord(bm, stamp)
    streamer = BlockStreamer(CFG, radius=0.1, evict_cap=4096, with_stamps=True)
    far = np.array([99.0, 0.0, 0.0], np.float32)
    vol, _, stamp2, n_out = streamer.evict(bm, None, far, stamp)
    assert n_out == int(bm.n_active)
    streamer.radius = 1e9
    vol, _, stamp3, n_in = streamer.admit(vol, None, far, stamp2)
    assert n_in == n_out
    got = _rows_by_coord(vol, stamp3)
    assert set(golden) == set(got)
    for k in golden:
        np.testing.assert_array_equal(golden[k][0], got[k][0])


def test_reference_store_loads(fused, tmp_path):
    """A store saved by the reference's streamer (with votes and stamps)
    loads in the port's, and its rows admit as the reference admits them."""
    bm, _, votes, stamp = fused
    far = np.array([99.0, 0.0, 0.0], np.float32)
    kw = dict(radius=0.1, evict_cap=4096, with_votes=True, with_stamps=True)
    jst = JStreamer(SMALL_TSDF, **kw)
    vol, votes2, _, _ = jst.evict(bm, votes, far, stamp)
    path = str(tmp_path / "store.npz")
    jst.save(path)
    pst = BlockStreamer(CFG, **kw)
    pst.load(path)
    assert set(pst.store) == set(jst.store)
    for k, row in jst.store.items():
        for key, v in row.items():
            assert pst.store[k][key].dtype == v.dtype
            np.testing.assert_array_equal(pst.store[k][key], v)
    stamp2 = jnp.zeros_like(stamp)
    jst.radius = pst.radius = 1e9
    ref = jst.admit(vol, votes2, far, stamp2)
    out = pst.admit(_pmap(vol), _pvotes(votes2), far, t(stamp2))
    assert out[3] == ref[3] == int(bm.n_active)
    _equal(out[:3], ref[:3])


def test_checkpoint_preserves_streamer_store(tmp_path):
    """Blocks evicted to the host store survive a checkpoint and resume of
    ``pipeline.run(stream_every=2)``: device blocks and store together cover
    what the uninterrupted run's do, and the final poses agree."""
    cfg = dataclasses.replace(to_port(SMALL_CFG), map_kind="blocks",
                              tsdf=dataclasses.replace(CFG, table_capacity=4096))
    nf = 6
    poses = psyn.orbit_trajectory(nf, device="cpu")
    frames = [psyn.render_frame(poses[i], INTR) for i in range(nf)]
    cdir = str(tmp_path / "ckpt")
    kw = dict(T_init_wc=poses[0], enable_loops=False, stream_every=2, stream_radius=1.0,
              checkpoint_dir=cdir, checkpoint_every=3, device="cpu")
    res1 = ppipe.run(cfg, frames, **kw)
    assert pckpt.latest_step(cdir) == 6
    stored3 = np.load(os.path.join(cdir, "step_3.streamer.npz"))["ids"]
    assert stored3.size > 0, "test premise: eviction before the checkpoint"
    final1 = set(int(x) for x in np.load(os.path.join(cdir, "step_6.streamer.npz"))["ids"])
    for name in os.listdir(cdir):
        if "step_6" in name:
            p = os.path.join(cdir, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    res2 = ppipe.run(cfg, frames, resume=True, **kw)
    final2 = set(int(x) for x in np.load(os.path.join(cdir, "step_6.streamer.npz"))["ids"])

    def device_ids(res):
        nb = pblocks.num_blocks_per_axis(cfg.tsdf)
        c = n(res.state.volume.block_coords)[: int(res.state.volume.n_active)]
        return set(((c[:, 0] * nb + c[:, 1]) * nb + c[:, 2]).tolist())

    assert device_ids(res1) | final1 == device_ids(res2) | final2
    np.testing.assert_allclose(res2.poses[-1], res1.poses[-1], atol=1e-4)
