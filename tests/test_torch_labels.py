"""Port label fusion (ops/labels.py, the plain K7) against the reference's
ops/labels.py on the CPU (the CUDA kernel: tests/test_torch_kernels.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import blocks as jblk
from instancefusion_tpu.ops import labels as jlab
from instancefusion_tpu_torch.ops import blocks as pblk
from instancefusion_tpu_torch.ops import labels as plab
from tests.helpers import SMALL_INTR
from tests.torch_helpers import BLOCKS_TSDF, n, t, to_port

K = 512
N_IDS = 16
PCFG, PINTR = to_port(BLOCKS_TSDF), to_port(SMALL_INTR)


@pytest.fixture(scope="module")
def scene():
    """A reference map fused from frames 0 and 2, frame 4's depth, pose and
    GT instance image (ids 0..3), and seeded random votes over every slot."""
    poses = jsyn.orbit_trajectory(20)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in (0, 2, 4)]

    @jax.jit
    def fuse(bm, depth, color, T):
        bm = jblk.discover_allocate(bm, depth, T, SMALL_INTR, BLOCKS_TSDF)
        slots, valid = jblk.frustum_slots(bm, T, SMALL_INTR, BLOCKS_TSDF, 0.2, 4.0, K)
        return jblk.integrate_slots(bm, slots, valid, depth, color, T,
                                    SMALL_INTR, BLOCKS_TSDF)

    bm = jblk.allocate(BLOCKS_TSDF)
    for f in frames:
        bm = fuse(bm, f.depth, f.color, f.T_wc)
    rng = np.random.default_rng(7)
    shape = (BLOCKS_TSDF.table_capacity, BLOCKS_TSDF.block_size**3)
    votes = jlab.LabelVotes(
        label=jnp.asarray(rng.integers(-1, 5, shape).astype(np.int32)),
        count=jnp.asarray(rng.integers(0, 4, shape).astype(np.float32)),
    )
    f = frames[2]
    return bm, votes, np.asarray(f.depth), np.asarray(f.T_wc), np.asarray(f.instance)


def _port(bm, votes):
    return pblk.BlockMap(*(t(x) for x in bm)), plab.LabelVotes(*(t(x) for x in votes))


def test_touched_blocks_and_slots_match_reference(scene):
    bm, _, depth, T, _ = scene
    ref = jblk.touched_blocks_mask(jnp.asarray(depth), jnp.asarray(T), SMALL_INTR, BLOCKS_TSDF)
    out = pblk.touched_blocks_mask(t(depth), t(T), PINTR, PCFG)
    np.testing.assert_array_equal(n(out), np.asarray(ref))
    assert np.asarray(ref).sum() > 80
    k = 60  # fewer than the touched blocks: the list is cut
    rs, rv = jblk.compact_touched_slots(bm, ref, BLOCKS_TSDF, k)
    ps, pv = pblk.compact_touched_slots(_port(bm, scene[1])[0], out, PCFG, k)
    np.testing.assert_array_equal(n(ps), np.asarray(rs))
    np.testing.assert_array_equal(n(pv), np.asarray(rv))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fuse_matches_reference(scene, use_pallas):
    """Labels and counts equal on >= 99.9% of the voxels that either side
    voted, against the jnp vote and against the Pallas vote in interpret
    mode: the rest project onto a .5 pixel boundary that the two round
    apart."""
    bm, votes, depth, T, inst = scene
    jcfg = dataclasses.replace(BLOCKS_TSDF, use_pallas=use_pallas)
    ref = jax.jit(jlab.fuse, static_argnums=(5, 6))(
        votes, bm, jnp.asarray(inst), jnp.asarray(depth), jnp.asarray(T), SMALL_INTR, jcfg)
    pbm, pvotes = _port(bm, votes)
    out = plab.fuse(pvotes, pbm, t(inst), t(depth), t(T), PINTR, PCFG)
    assert out.label is pvotes.label  # updated in place
    before, ref, out = (tuple(n(x) for x in v) for v in (votes, ref, out))
    voted = np.zeros_like(before[1], bool)
    for after in (ref, out):
        voted |= (after[0] != before[0]) | (after[1] != before[1])
    assert voted.sum() > 4000
    for name, a, b in zip(("label", "count"), out, ref):
        share = (a == b)[voted].mean()
        assert share >= 0.999, (name, share)


def test_sample_nearest_matches_reference(scene):
    """At the frame's own surface points (world), equal."""
    bm, votes, depth, T, _ = scene
    from instancefusion_tpu.geometry.camera import backproject

    p_c = np.asarray(backproject(SMALL_INTR, jnp.asarray(depth)))
    p_w = (p_c @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    valid = depth > 0
    ref = jlab.sample_nearest(votes, bm, jnp.asarray(p_w), jnp.asarray(valid), BLOCKS_TSDF)
    pbm, pvotes = _port(bm, votes)
    out = plab.sample_nearest(pvotes, pbm, t(p_w), t(valid), PCFG)
    np.testing.assert_array_equal(n(out), np.asarray(ref))
    assert (np.asarray(ref) >= 0).sum() > 5000


@pytest.mark.parametrize("with_intr", [False, True])
def test_refine_mask_edges_matches_reference(scene, with_intr):
    _, _, depth, _, inst = scene
    rng = np.random.default_rng(3)
    noisy = (depth + rng.normal(scale=0.003, size=depth.shape) * (depth > 0)).astype(np.float32)
    ref = jlab.refine_mask_edges(jnp.asarray(inst), jnp.asarray(noisy),
                                 intr=SMALL_INTR if with_intr else None)
    out = plab.refine_mask_edges(t(inst), t(noisy), intr=PINTR if with_intr else None)
    np.testing.assert_array_equal(n(out), np.asarray(ref))
    assert ((np.asarray(ref) == -1) & (inst >= 0)).sum() > 100  # edges dropped


def test_relabel_votes_chained_merges_match_reference():
    """Merges applied in order, chains included (2 -> 5, then 5 -> 7, then
    7 -> 1), some rules not ok; the port composes them into one table
    (merge_table) and applies it with one gather."""
    rng = np.random.default_rng(11)
    shape = (40, 512)
    votes = jlab.LabelVotes(
        label=jnp.asarray(rng.integers(-1, N_IDS, shape).astype(np.int32)),
        count=jnp.asarray(rng.integers(0, 4, shape).astype(np.float32)),
    )
    src = np.array([2, 5, 9, 7, 3, 11, 4, 0], np.int32)
    dst = np.array([5, 7, 3, 1, 12, 2, 6, 15], np.int32)
    ok = np.array([True, True, True, True, False, True, True, False])
    ref = jlab.relabel_votes(votes, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok))
    table = plab.merge_table(t(src), t(dst), t(ok), N_IDS)
    out = plab.relabel_votes(plab.LabelVotes(*(t(x) for x in votes)), table)
    np.testing.assert_array_equal(n(out.label), np.asarray(ref.label))
    np.testing.assert_array_equal(n(out.count), np.asarray(ref.count))
    assert (np.asarray(ref.label) == 1).sum() > (np.asarray(votes.label) == 1).sum()
