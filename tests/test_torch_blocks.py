"""Port block map (allocation, slot lists, integrate K4, splat K5, the
touched-block integrate with K8, clean) against the reference's jnp path
on the CPU (the CUDA kernels: tests/test_torch_kernels.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.ops import blocks as jblk
from instancefusion_tpu.ops import labels as jlab
from instancefusion_tpu_torch.ops import blocks as pblk
from instancefusion_tpu_torch.ops import labels as plab
from tests.helpers import SMALL_INTR
from tests.torch_helpers import BLOCKS_TSDF, RMAX, n, t, to_port

K = 512
PCFG, PINTR = to_port(BLOCKS_TSDF), to_port(SMALL_INTR)


def _port_map(bm) -> pblk.BlockMap:
    return pblk.BlockMap(*(t(x) for x in bm))


@pytest.fixture(scope="module")
def fused():
    """A reference map fused from 2 frames by the slot path, and frame 2."""
    poses = jsyn.orbit_trajectory(20)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in (0, 2, 4)]

    @jax.jit
    def fuse(bm, depth, color, T):
        bm = jblk.discover_allocate(bm, depth, T, SMALL_INTR, BLOCKS_TSDF)
        slots, valid = jblk.frustum_slots(bm, T, SMALL_INTR, BLOCKS_TSDF, 0.2, 4.0, K)
        return jblk.integrate_slots(bm, slots, valid, depth, color, T,
                                    SMALL_INTR, BLOCKS_TSDF)

    bm = jblk.allocate(BLOCKS_TSDF)
    for f in frames[:2]:
        bm = fuse(bm, f.depth, f.color, f.T_wc)
    f = frames[2]
    return bm, (np.asarray(f.depth), np.asarray(f.color), np.asarray(f.T_wc))


@pytest.fixture(scope="module")
def allocated(fused):
    """The map after frame 2's allocation and its slot list, both packages."""
    bm, (depth, color, T) = fused
    ref = jblk.discover_allocate(bm, depth, T, SMALL_INTR, BLOCKS_TSDF)
    out = pblk.discover_allocate(_port_map(bm), t(depth), t(T), PINTR, PCFG)
    ref_slots = jblk.frustum_slots(ref, T, SMALL_INTR, BLOCKS_TSDF, 0.2, 4.0, K)
    slots = pblk.frustum_slots(out, t(T), PINTR, PCFG, 0.2, 4.0, K)
    return ref, out, ref_slots, slots


def test_discover_allocate_matches_reference(fused, allocated):
    bm = fused[0]
    ref, out, _, _ = allocated
    assert int(ref.n_active) > int(bm.n_active)  # the frame allocated blocks
    for name in ("directory", "block_coords", "n_active", "overflow"):
        np.testing.assert_array_equal(n(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_frustum_slots_match_reference(allocated):
    _, _, (rs, rv), (ps, pv) = allocated
    np.testing.assert_array_equal(n(ps), np.asarray(rs))
    np.testing.assert_array_equal(n(pv), np.asarray(rv))
    assert int(np.asarray(rv).sum()) > 50


def _voxel_share(a, b, tol):
    return float((np.abs(a - b) <= tol).mean())


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_slots_matches_reference(fused, allocated, with_color):
    """sdf 5e-4, weight 1e-5, color 5e-3 (tests/test_pallas.py:218-223) on
    >= 99.9% of voxels: the rest are voxels whose projection lies on a .5
    boundary that the two frameworks round apart."""
    _, (depth, color, T) = fused
    ref, out, (rs, rv), (ps, pv) = allocated
    col = color if with_color else None
    ref2 = jax.jit(jblk.integrate_slots, static_argnums=(6, 7))(
        ref, rs, rv, depth, col, T, SMALL_INTR, BLOCKS_TSDF, 4.0)
    out = pblk.BlockMap(*(x.clone() for x in out))
    out2 = pblk.integrate_slots(out, ps, pv, t(depth), None if col is None else t(col),
                                t(T), PINTR, PCFG, color_gain=4.0)
    assert out2.sdf is out.sdf  # updated in place
    for name, tol in (("sdf", 5e-4), ("weight", 1e-5), ("color", 5e-3)):
        share = _voxel_share(n(getattr(out2, name)), np.asarray(getattr(ref2, name)), tol)
        assert share >= 0.999, (name, share)
    assert (np.asarray(ref2.weight) != np.asarray(ref.weight)).sum() > 10000


def test_raycast_splat_matches_reference(fused, allocated):
    """valid XOR < 1%, depth within 1e-3 m where both are valid."""
    _, (depth, color, T) = fused
    ref, out, (rs, rv), (ps, pv) = allocated
    pr = jblk.raycast_splat(ref, T, SMALL_INTR, BLOCKS_TSDF, rs, rv, with_color=True,
                            interpret=True, depth_prior=depth, rmax=RMAX)
    po = pblk.raycast_splat(out, t(T), PINTR, PCFG, ps, pv, with_color=True,
                            depth_prior=t(depth), rmax=RMAX)
    vr, vo = np.asarray(pr.valid), n(po.valid)
    assert vr.sum() > 5000
    assert (vr ^ vo).sum() < 0.01 * vr.sum()
    both = vr & vo
    assert np.abs(n(po.depth) - np.asarray(pr.depth))[both].max() < 1e-3
    assert np.abs(n(po.vertex_w) - np.asarray(pr.vertex_w))[both].max() < 2e-3
    assert np.median(np.abs(n(po.color) - np.asarray(pr.color))[both]) < 1e-4


@pytest.mark.parametrize("k", [7, 64, 300])
def test_compact_mask_indices_matches_reference(k):
    mask = np.random.default_rng(k).random(257) < 0.2
    ri, rv = jblk.compact_mask_indices(jnp.asarray(mask), k)
    pi, pv = pblk.compact_mask_indices(t(mask), k)
    np.testing.assert_array_equal(n(pi), np.asarray(ri))
    np.testing.assert_array_equal(n(pv), np.asarray(rv))


def test_pack_unpack_color_match_reference():
    c3 = np.random.default_rng(0).random((5, 512, 3)).astype(np.float32)
    packed = pblk.pack_color(t(c3))
    np.testing.assert_array_equal(n(packed), np.asarray(jblk.pack_color(c3)))
    np.testing.assert_array_equal(n(pblk.unpack_color(packed)), c3)


@pytest.fixture(scope="module")
def touched_runs():
    """Two frames through the touched-block ``integrate``: the reference's
    jnp branch, its K8 branch (``use_pallas``, interpret mode on the CPU),
    and the port (plain K8), each from an empty map; and the frames."""
    poses = jsyn.orbit_trajectory(20)
    frames = [jsyn.render_frame(poses[i], SMALL_INTR) for i in (0, 3)]
    k8_cfg = dataclasses.replace(BLOCKS_TSDF, use_pallas=True)
    refs = {}
    for name, cfg in (("jnp", BLOCKS_TSDF), ("k8", k8_cfg)):
        fuse = jax.jit(jblk.integrate, static_argnums=(4, 5))
        bm = jblk.allocate(BLOCKS_TSDF)
        for f in frames:
            bm = fuse(bm, f.depth, f.color, f.T_wc, SMALL_INTR, cfg)
        refs[name] = bm
    out = pblk.allocate(PCFG, "cpu")
    for f in frames:
        out = pblk.integrate(out, t(f.depth), t(f.color), t(f.T_wc), PINTR, PCFG)
    frames = [(np.asarray(f.depth), np.asarray(f.color), np.asarray(f.T_wc)) for f in frames]
    return refs, out, frames


@pytest.mark.parametrize("branch", ["jnp", "k8"])
def test_touched_integrate_matches_reference(touched_runs, branch):
    """Directory, coordinates, n_active and overflow equal; sdf within 5e-4,
    weight within 1e-5 and color within 5e-3 (tests/test_pallas.py:218-223)
    on >= 99.9% of voxels (the XLA-fused voxel centers can round a
    projection on a .5 pixel boundary apart)."""
    refs, out, _ = touched_runs
    ref = refs[branch]
    for name in ("directory", "block_coords", "n_active", "overflow"):
        np.testing.assert_array_equal(n(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert int(ref.n_active) > 100
    for name, tol in (("sdf", 5e-4), ("weight", 1e-5), ("color", 5e-3)):
        share = _voxel_share(n(getattr(out, name)), np.asarray(getattr(ref, name)), tol)
        assert share >= 0.999, (name, share)
    w = n(out.weight)
    assert (w > 0).sum() > 10000
    # Never-fused voxels of allocated blocks keep the sentinel.
    live = np.arange(w.shape[0]) < int(out.n_active)
    assert (n(out.sdf)[live][w[live] == 0] == pblk.UNOBSERVED).all()


def test_touched_integrate_matches_k4_on_the_same_rows(touched_runs):
    """The association in PyTorch plus K8 against K4 (plain), which does
    both in one pass, on the same touched list of the second frame: sdf,
    weight and color within 1e-6 (K8 multiplies by the reciprocal of the
    weight, K4 divides by it); allocation as ``allocate_touched``."""
    _, _, frames = touched_runs
    (d0, c0, T0), (d1, c1, T1) = frames
    first = pblk.integrate(pblk.allocate(PCFG, "cpu"), t(d0), t(c0), t(T0), PINTR, PCFG)
    touched = pblk.touched_blocks_mask(t(d1), t(T1), PINTR, PCFG)
    bm = pblk.allocate_touched(first, touched, PCFG)
    slots, valid = pblk.compact_touched_slots(bm, touched, PCFG, PCFG.touched_capacity)
    assert int(valid.sum()) > 50 and bool((slots[~valid] == 0).all())
    k4 = pblk.BlockMap(*(x.clone() for x in bm))
    pblk.integrate_slots(k4, slots, valid, t(d1), t(c1), t(T1), PINTR, PCFG)
    k8 = pblk.integrate(pblk.BlockMap(*(x.clone() for x in first)), t(d1), t(c1), t(T1),
                        PINTR, PCFG)
    for name in ("directory", "block_coords", "n_active", "overflow"):
        assert torch.equal(getattr(k8, name), getattr(bm, name)), name
    for name in ("sdf", "weight", "color"):
        np.testing.assert_allclose(n(getattr(k8, name)), n(getattr(k4, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_allocate_touched_matches_reference(touched_runs):
    """On a map that already holds blocks, with a capacity that drops some:
    directory, coordinates, n_active and overflow equal."""
    refs, _, frames = touched_runs
    depth, _, T = frames[1]
    cap = int(refs["jnp"].n_active) + 40
    small = dataclasses.replace(BLOCKS_TSDF, table_capacity=cap)
    # The map cut to that capacity: its rows past n_active are all free.
    ref_bm = refs["jnp"]._replace(**{name: getattr(refs["jnp"], name)[:cap] for name in
                                     ("block_coords", "sdf", "weight", "color")})
    # Move the frame so that it touches new blocks.
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (0.3, 0.0, 0.2)
    touched = jblk.touched_blocks_mask(depth, shift @ T, SMALL_INTR, BLOCKS_TSDF)
    ref = jblk.allocate_touched(ref_bm, touched, small)
    out = pblk.allocate_touched(_port_map(ref_bm), t(touched), to_port(small))
    assert int(ref.overflow) > int(ref_bm.overflow)  # some blocks were dropped
    for name in ("directory", "block_coords", "n_active", "overflow"):
        np.testing.assert_array_equal(n(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_clean_matches_reference(touched_runs):
    """Culled and compacted map, votes and stamps equal (exact): live rows
    first in their old order, the fills behind them, the directory
    remapped."""
    refs, _, _ = touched_runs
    bm = refs["jnp"]
    rng = np.random.default_rng(5)
    c = BLOCKS_TSDF.table_capacity
    votes = (rng.integers(-1, 6, (c, 512)).astype(np.int32),
             rng.uniform(0, 4, (c, 512)).astype(np.float32))
    stamp = rng.integers(0, 9, (c, 2)).astype(np.int32)
    ref_bm, ref_votes, ref_stamp = jblk.clean(bm, BLOCKS_TSDF, 2.0,
                                              jlab.LabelVotes(*votes), stamp)
    out_bm, out_votes, out_stamp = pblk.clean(_port_map(bm), PCFG, 2.0,
                                              plab.LabelVotes(*(t(x) for x in votes)),
                                              t(stamp))
    assert 0 < int(ref_bm.n_active) < int(bm.n_active)  # some blocks were culled
    for a, b in zip(out_bm, ref_bm):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    for a, b in zip(out_votes, ref_votes):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    np.testing.assert_array_equal(n(out_stamp), np.asarray(ref_stamp))
    out2, none = pblk.clean(_port_map(bm), PCFG)
    assert none is None and int(out2.n_active) >= int(out_bm.n_active)


def _look_at(eye, center, rng, jitter):
    """Camera-to-world pose at `eye` looking at `center`, then turned by a
    random rotation of up to `jitter` rad (so blocks also fall partly or
    wholly off the image)."""
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], -1)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    ang = rng.uniform(0.0, jitter)
    T = np.eye(4)
    T[:3, :3] = (np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K) @ R
    T[:3, 3] = eye
    return T.astype(np.float32)


def test_splat_taps_lie_in_footprint_box():
    """For random blocks and poses, every tap that the plain splat yields
    for a block lies inside the box that K5's first pass computes for it
    (``footprint_boxes``: its votes' rounded centers widened by the tap
    radius), at rmax = 8; straddling blocks yield no tap.  The box decides
    which screen tiles walk the block (``tile_counts``), so a tap outside
    it would be lost."""
    from instancefusion_tpu_torch.ops.kernels import raycast as kray

    rng = np.random.default_rng(0)
    b3, nb = PCFG.block_size ** 3, PCFG.grid_size // PCFG.block_size
    n_blocks = 20
    coords = t(rng.integers(0, nb, (n_blocks, 3)).astype(np.int32))
    sdf = t(rng.uniform(-1.0, 1.0, (n_blocks, b3)).astype(np.float32))
    weight = t(rng.uniform(0.5, 6.0, (n_blocks, b3)).astype(np.float32))
    color = t(rng.uniform(0.0, 1.0, (n_blocks, 3 * b3)).astype(np.float32))
    bsz = PCFG.block_size * PCFG.voxel_size
    centers = (n(coords) + 0.5) * bsz + np.asarray(PCFG.origin)
    slots = torch.arange(n_blocks, dtype=torch.int32)
    ones = torch.ones(n_blocks, dtype=torch.bool)
    checked, kept_n, dropped_n, spans = 0, 0, 0, []
    for trial in range(5):
        target = centers[rng.integers(n_blocks)]
        direction = rng.normal(size=3)
        eye = target + rng.uniform(0.3, 3.0) * direction / np.linalg.norm(direction)
        T_wc = t(_look_at(eye, target, rng, 0.4))
        box, kept = kray.footprint_boxes(slots, ones, coords, sdf, weight, T_wc, PINTR,
                                         PCFG, 8)
        counts = kray.tile_counts(box, PINTR)
        kept_n += int(kept.sum())
        dropped_n += int((~kept).sum())
        for i in range(n_blocks):
            flat = torch.cat([f for f, _ in kray.splat_taps_ref(
                slots[i:i + 1], torch.ones(1, dtype=torch.bool), coords, sdf, weight,
                color, T_wc, PINTR, PCFG, True, 8)])
            if not bool(kept[i]):
                assert flat.numel() == 0
                continue
            py, px = flat // PINTR.width, flat % PINTR.width
            x0, y0, x1, y1 = n(box[i]).tolist()
            assert bool(((px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)).all()), (trial, i)
            checked += flat.numel()
            if flat.numel():
                # The tiles that meet the box.
                spans.append((x1 // kray.TILE - x0 // kray.TILE + 1)
                             * (y1 // kray.TILE - y0 // kray.TILE + 1))
        assert int(counts.sum()) == sum(
            (int(b[2]) // kray.TILE - int(b[0]) // kray.TILE + 1)
            * (int(b[3]) // kray.TILE - int(b[1]) // kray.TILE + 1)
            for b in box if int(b[0]) <= int(b[2]))
    assert checked > 20000
    assert kept_n > 0 and dropped_n > 0, (kept_n, dropped_n)
    assert min(spans) >= 1 and max(spans) > 4, spans
