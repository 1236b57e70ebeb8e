"""The fixed-order pose inverse and voxel projection that K4 and K7 compute
bit for bit (``se3.se3_inverse_rows``, ``ops/kernels/tsdf.project_voxels``)
against the reference on the CPU, and the plain K4 and K7 on slot lists
with holes (the CUDA kernels: tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.geometry import camera as jcam
from instancefusion_tpu.geometry import se3 as jse3
from instancefusion_tpu_torch.geometry import se3 as pse3
from instancefusion_tpu_torch.ops import blocks as pblk
from instancefusion_tpu_torch.ops.kernels import labels as klab
from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf
from tests.helpers import SMALL_INTR
from tests.torch_helpers import BLOCKS_TSDF, n, t, to_port

PCFG, PINTR = to_port(BLOCKS_TSDF), to_port(SMALL_INTR)


def _poses(kind):
    """Eight seeded poses: of the synthetic orbit, or random twists."""
    if kind == "orbit":
        return np.asarray(jsyn.orbit_trajectory(40))[::5]
    xi = np.random.default_rng(3).normal(scale=0.6, size=(8, 6)).astype(np.float32)
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("kind", ["orbit", "twists"])
def test_se3_inverse_rows_matches_inverse(kind):
    """Within 1e-6 of the port's and the reference's ``se3_inverse``, with
    R^T exact and t' summed column by column, one rounding per operation."""
    T = _poses(kind)
    out = n(pse3.se3_inverse_rows(t(T)))
    np.testing.assert_allclose(out, n(pse3.se3_inverse(t(T))), atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jse3.se3_inverse(jnp.asarray(T))), atol=1e-6)
    R, tr = T[:, :3, :3], T[:, :3, 3:]
    np.testing.assert_array_equal(out[:, :3, :3], np.swapaxes(R, 1, 2))
    # numpy's float32 ufuncs round each operation: the fixed order itself.
    t_inv = -((R[:, 0, :] * tr[:, 0] + R[:, 1, :] * tr[:, 1]) + R[:, 2, :] * tr[:, 2])
    np.testing.assert_array_equal(out[:, :3, 3], t_inv)
    np.testing.assert_array_equal(out[:, 3], np.tile([0, 0, 0, 1], (len(T), 1)))


def _scene(frame_idx=4):
    """A frame of the synthetic orbit and the blocks its truncation band
    touches (the port's mask), each given a payload slot."""
    pose = np.asarray(jsyn.orbit_trajectory(20))[frame_idx]
    f = jsyn.render_frame(jnp.asarray(pose), SMALL_INTR)
    depth, T = t(f.depth), t(pose)
    touched = torch.nonzero(pblk.touched_blocks_mask(depth, T, PINTR, PCFG))[:, 0]
    nb = pblk.num_blocks_per_axis(PCFG)
    coords = torch.stack([touched // (nb * nb), (touched // nb) % nb, touched % nb], -1)
    return f, depth, T, coords.to(torch.int32)


def test_project_voxels_matches_reference_pixel():
    """The fixed-order projection picks the reference's pixel (its jnp
    ``integrate_slots`` association: ``se3_inverse``, ``transform_points``,
    ``project``, round half to even) and its in-view test on >= 99.9% of
    voxels; the rest lie on a .5 boundary that the two orders round apart."""
    f, depth, T, coords = _scene()
    slots = torch.arange(coords.shape[0], dtype=torch.int32)
    z, pix, seen = ktsdf.project_voxels(coords, slots, T, PINTR, PCFG)

    b = BLOCKS_TSDF.block_size
    idx = jnp.arange(b ** 3)
    local = jnp.stack([idx // (b * b), (idx // b) % b, idx % b], -1)
    vox = jnp.asarray(n(coords))[:, None, :] * b + local[None]
    p_w = jnp.asarray(BLOCKS_TSDF.origin, jnp.float32) + (
        vox.astype(jnp.float32) + 0.5) * BLOCKS_TSDF.voxel_size
    p_c = jse3.transform_points(jse3.se3_inverse(jnp.asarray(n(T))), p_w.reshape(-1, 3))
    u, v, rz = jcam.project(SMALL_INTR, p_c.reshape(p_w.shape))
    ui, vi = jnp.round(u).astype(jnp.int32), jnp.round(v).astype(jnp.int32)
    ref_seen = np.asarray((ui >= 0) & (ui < SMALL_INTR.width) & (vi >= 0)
                          & (vi < SMALL_INTR.height) & (rz > 0.0))
    ref_pix = np.asarray(jnp.clip(vi, 0, SMALL_INTR.height - 1) * SMALL_INTR.width
                         + jnp.clip(ui, 0, SMALL_INTR.width - 1))
    assert ref_seen.sum() > 20000
    agree = (n(pix) == ref_pix) & (n(seen) == ref_seen)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(n(z), np.asarray(rz), atol=1e-5)


def _holes(c, n_valid, seed):
    """A list of 3 c entries whose valid entries, at seeded places, name
    slots 0..n_valid-1 once each; the holes name every slot, valid or not."""
    rng = np.random.default_rng(seed)
    length = 3 * c
    slots = rng.integers(0, c, length).astype(np.int32)
    valid = np.zeros(length, bool)
    at = rng.choice(length, n_valid, replace=False)
    slots[at] = rng.permutation(n_valid)
    valid[at] = True
    return torch.as_tensor(slots), torch.as_tensor(valid)


def _assert_rows(out, before, rows, prefix_out):
    """Rows outside `rows` bit-for-bit as before; the listed rows as a
    prefix list of the same slots leaves them."""
    other = torch.ones(before.shape[0], dtype=torch.bool)
    other[rows] = False
    bits = (lambda x: x.view(torch.int32)) if before.dtype == torch.float32 else (lambda x: x)
    assert torch.equal(bits(out[other]), bits(before[other]))
    assert torch.equal(bits(out), bits(prefix_out))


@pytest.mark.parametrize("with_color", [True, False])
def test_plain_integrate_on_list_with_holes(with_color):
    """The plain K4 on a list with holes updates only its valid rows, as a
    prefix list of the same slots does, and fuses something there."""
    f, depth, T, coords = _scene()
    c = coords.shape[0]
    g = np.random.default_rng(0)
    before = [torch.as_tensor(g.uniform(-1, 1, (c, 512)).astype(np.float32)),
              torch.as_tensor(g.integers(0, 5, (c, 512)).astype(np.float32)),
              torch.as_tensor(g.uniform(0, 1, (c, 1536)).astype(np.float32))]
    slots, valid = _holes(c, c // 2, 1)
    rows = slots[valid].long()
    prefix = (torch.sort(rows).values.to(torch.int32), torch.ones(rows.numel(), dtype=torch.bool))
    color = t(f.color) if with_color else None
    outs = []
    for sl, va in ((slots, valid), prefix):
        maps = [x.clone() for x in before]
        ktsdf.integrate(coords, *maps, sl, va, depth, color, T, PINTR, PCFG, 4.0)
        outs.append(maps)
    for out, b, ref in zip(outs[0], before, outs[1]):
        _assert_rows(out, b, rows, ref)
    assert not torch.equal(outs[0][1], before[1])


def test_plain_label_vote_on_list_with_holes():
    """The plain K7 on a list with holes votes only into its valid rows, as
    a prefix list of the same slots does, and votes something there."""
    f, depth, T, coords = _scene()
    c = coords.shape[0]
    g = np.random.default_rng(2)
    before = [torch.as_tensor(g.integers(-1, 5, (c, 512)).astype(np.int32)),
              torch.as_tensor(g.integers(0, 4, (c, 512)).astype(np.float32))]
    gid = t(np.asarray(f.instance).astype(np.int32))
    slots, valid = _holes(c, c // 2, 3)
    rows = slots[valid].long()
    prefix = (torch.sort(rows).values.to(torch.int32), torch.ones(rows.numel(), dtype=torch.bool))
    outs = []
    for sl, va in ((slots, valid), prefix):
        planes = [x.clone() for x in before]
        klab.label_vote(coords, *planes, sl, va, depth, gid, T, PINTR, PCFG)
        outs.append(planes)
    for out, b, ref in zip(outs[0], before, outs[1]):
        _assert_rows(out, b, rows, ref)
    assert not torch.equal(outs[0][1], before[1])
