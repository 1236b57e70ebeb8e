"""The port's sharded map (``instancefusion_tpu_torch/parallel``) against the
reference's shard bodies, at tests/test_shard.py's small configuration.

The port runs as 4 gloo ranks on the CPU (one ``RankPool`` for the module);
the reference runs its own shard body (``parallel/shard.py``) under
``jax.vmap(body, axis_name=SHARD_AXIS)`` over the stacked shards, which
gives ``psum``/``pmax``/``pmin``/``ppermute``/``axis_index`` their meaning
without ``shard_map``'s partitioning.  Both get the same numpy inputs.
Where the reference's body uses an ``all_to_all`` (the reshard), the port
is held to the reference's own invariants (tests/test_shard.py).
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.config import RaycastConfig, TsdfConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.geometry.camera import Intrinsics
from instancefusion_tpu.ops import blocks as jblocks
from instancefusion_tpu.ops import labels as jlabels
from instancefusion_tpu.parallel import shard as jshard
from instancefusion_tpu.parallel.mesh import SHARD_AXIS
from instancefusion_tpu_torch.parallel import mesh, shard
from tests import torch_shard_workers as W
from tests.helpers import SMALL_INTR
from tests.torch_helpers import one_thread, to_port  # noqa: F401 (autouse fixture)

S = 4
CFG = TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96, origin=(-1.92, -1.92, -0.4),
                 block_size=8, table_capacity=1728, touched_capacity=512)
CL = CFG.table_capacity // S
RC_SPLAT = RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                         screen_space_normals=True, use_splat=True, splat_rmax=3)
RC_MARCH = RaycastConfig(near=0.2, far=4.0)
TINY = Intrinsics(fx=64.6, fy=64.5, cx=39.5, cy=29.5, width=80, height=60)
ROWS = ("block_coords", "sdf", "weight", "color")


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(S, device="cpu") as p:
        yield p


def _frames(n, intr=SMALL_INTR):
    poses = synthetic.orbit_trajectory(6)
    return [synthetic.render_frame(poses[i], intr) for i in range(n)]


def _global(bm) -> dict:
    return {k: np.asarray(v) for k, v in bm._asdict().items()}


def _j(g: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in g.items()}


def _stack(x):
    return jnp.asarray(x).reshape((S, -1) + tuple(np.shape(x)[1:]))


def _ported(results):
    """The ranks' returned maps as global arrays (rows in rank order)."""
    out = dict(results[0])
    for k in ROWS:
        out[k] = np.concatenate([r[k] for r in results])
    return out


@functools.lru_cache(maxsize=None)
def _fused_fn(k_local):
    body = functools.partial(
        jshard._fused_step_shard, intr=SMALL_INTR, cfg=CFG, rc_cfg=RC_SPLAT, num_shards=S,
        k_local=k_local, alloc_cap=4096, with_color=True, pred_color=True, color_gain=1.0)
    return jax.jit(jax.vmap(body, in_axes=(None, 0, None, None, 0, 0, 0, None, None, None,
                                           None, None), axis_name=SHARD_AXIS))


@functools.lru_cache(maxsize=None)
def _integrate_fn(intr):
    body = functools.partial(jshard._integrate_shard, intr=intr, cfg=CFG, num_shards=S,
                             max_touched=8192)
    return jax.jit(jax.vmap(body, in_axes=(None, 0, 0, 0, 0, 0, 0, None, None, None, None),
                            axis_name=SHARD_AXIS))


def _jax_fused(g, f, prior, k_local):
    g = _j(g)
    out = _fused_fn(k_local)(
        g["directory"], _stack(g["block_coords"]), g["n_active"], g["overflow"],
        _stack(g["sdf"]), _stack(g["weight"]), _stack(g["color"]), g["cuts"], f.depth,
        f.color, prior, f.T_wc)
    out = [np.asarray(x) for x in out]
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    bm = dict(directory=out[0][0], block_coords=flat(out[1]), n_active=out[2][0],
              overflow=out[3][0], sdf=flat(out[4]), weight=flat(out[5]), color=flat(out[6]),
              cuts=g["cuts"])
    bm = {k: np.asarray(v) for k, v in bm.items()}
    maps = dict(vertex_w=out[7][0], normal_w=out[8][0], depth=out[9][0], color=out[10][0],
                valid=out[11][0])
    return bm, maps


def _jax_integrate(g, f, intr):
    g = _j(g)
    n_act = jnp.asarray(g["n_active"]).reshape(S, 1)
    ovf = jnp.asarray(g["overflow"]).reshape(S, 1)
    out = _integrate_fn(intr)(
        g["directory"], _stack(g["block_coords"]), n_act, ovf, _stack(g["sdf"]),
        _stack(g["weight"]), _stack(g["color"]), g["cuts"], f.depth, f.color, f.T_wc)
    out = [np.asarray(x) for x in out]
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    return dict(directory=out[0][0], block_coords=flat(out[1]), n_active=out[2][:, 0],
                overflow=out[3][:, 0], sdf=flat(out[4]), weight=flat(out[5]),
                color=flat(out[6]), cuts=np.asarray(g["cuts"]))


def _assert_map_equal(got, want, atol_sdf, atol_color):
    for k in ("directory", "block_coords", "n_active", "overflow", "cuts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["weight"], want["weight"])
    np.testing.assert_allclose(got["sdf"], want["sdf"], atol=atol_sdf)
    np.testing.assert_allclose(got["color"], want["color"], atol=atol_color)


@pytest.fixture(scope="module")
def marched():
    """The reference's marched sharded integrate of two frames (SMALL_INTR),
    from an empty map: (global arrays after frame 0, after frame 1)."""
    g = _global(jshard.allocate(CFG, S))
    out = []
    for f in _frames(2):
        g = _jax_integrate(g, f, SMALL_INTR)
        out.append(g)
    return out


def test_cuts_and_slab_of(marched):
    """uniform_cuts, balanced_cuts and _slab_of equal the reference exactly."""
    np.testing.assert_array_equal(shard.uniform_cuts(to_port(CFG), S).numpy(),
                                  np.asarray(jshard.uniform_cuts(CFG, S)))
    directory = marched[1]["directory"]
    np.testing.assert_array_equal(
        shard.balanced_cuts(torch.as_tensor(directory), to_port(CFG), S).numpy(),
        np.asarray(jshard.balanced_cuts(directory, CFG, S)))
    rng = np.random.default_rng(0)
    bx = rng.integers(-2, 14, (64,)).astype(np.int32)
    for cuts in ([3, 6, 9], [1, 1, 11], [5, 5, 5]):
        cuts = np.asarray(cuts, np.int32)
        np.testing.assert_array_equal(
            shard._slab_of(torch.as_tensor(bx), torch.as_tensor(cuts)).numpy(),
            np.asarray(jshard._slab_of(jnp.asarray(bx), jnp.asarray(cuts))))


@pytest.mark.parametrize("cuts", [None, (2, 5, 6)])
def test_alloc_from_band_every_sid(marched, cuts):
    """The replicated band allocation: directory, coords rows, n_active and
    overflow of every shard equal the reference's loop exactly (on a map
    holding frame 0, with uniform and skewed cuts)."""
    g = dict(marched[0])
    if cuts is not None:
        g["cuts"] = np.asarray(cuts, np.int32)
    f = _frames(2)[1]
    pcfg = to_port(CFG)
    for sid in range(S):
        want = jshard._alloc_from_band(
            jnp.asarray(g["directory"]), _stack(g["block_coords"])[sid],
            jnp.asarray(g["n_active"]), jnp.asarray(g["overflow"]), jnp.asarray(g["cuts"]),
            f.depth, f.T_wc, sid, intr=SMALL_INTR, cfg=CFG, num_shards=S)
        bm = W.convert.sharded_map_from_global(g, sid, S, "cpu")
        got = shard._alloc_from_band(bm, torch.as_tensor(np.asarray(f.depth)),
                                     torch.as_tensor(np.asarray(f.T_wc)),
                                     mesh.ShardGroup(sid, S, torch.device("cpu")),
                                     to_port(SMALL_INTR), pcfg)
        for a, b in zip((got.directory, got.block_coords, got.n_active, got.overflow),
                        want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_step_shard_matches_reference(pool):
    """Two frames of the splat-path map update on 4 ranks against the
    reference's ``_fused_step_shard`` under vmap, from the same map: the
    allocation exactly, the payload rows to 1e-5 (K4's plain version
    against the jnp update), and the composited prediction (the planes sum
    in another order) on >= 99.5% of the pixels, depth to 1e-4 m where
    both are valid."""
    g = _global(jshard.allocate(CFG, S))
    k_local = max(256, CFG.touched_capacity // S)
    pi, pc, prc = to_port(SMALL_INTR), to_port(CFG), to_port(RC_SPLAT)
    for f in _frames(2):
        prior = np.asarray(f.depth)
        want_bm, want_maps = _jax_fused(g, f, prior, k_local)
        res = pool.run(W.fused_step, g, np.asarray(f.depth), np.asarray(f.color), prior,
                       np.asarray(f.T_wc), pi, pc, prc, k_local)
        got_bm = _ported([r[0] for r in res])
        _assert_map_equal(got_bm, want_bm, atol_sdf=1e-5, atol_color=1e-4)
        # Each rank noted its in-frustum list; none ran past k_local here.
        fills = [r[2] for r in res]
        assert all(x["length"] == k_local and x["dropped"] == 0 for x in fills), fills
        assert 0 < max(x["largest"] for x in fills) <= k_local, fills
        for r in res[1:]:  # replicated maps: the same on every rank
            for k, v in r[1].items():
                np.testing.assert_array_equal(v, res[0][1][k])
        got = res[0][1]
        agree = np.mean(got["valid"] == want_maps["valid"])
        assert agree >= 0.995, agree
        both = got["valid"] & want_maps["valid"]
        assert both.sum() > 3000
        np.testing.assert_allclose(got["depth"][both], want_maps["depth"][both], atol=1e-4)
        g = want_bm
    assert (g["n_active"] > 0).sum() >= 2


def test_list_fill_counts_rows_past_the_list():
    """``blocks.ListFill``: the most in-frustum rows of one list and the
    rows dropped past the list's length, summed over lists."""
    from instancefusion_tpu_torch.ops import blocks

    fill = blocks.ListFill()
    assert fill.read() == {"largest": 0, "dropped": 0, "length": 0}
    for n in (3, 7, 5):
        fill.note(torch.arange(10) < n, 4)
    assert fill.read() == {"largest": 7, "dropped": 3 + 1, "length": 4}
    fill.reset()
    assert fill.read()["largest"] == 0


def test_marched_integrate_matches_reference(pool, marched):
    """The marched sharded integrate (pmax-merged allocation, then
    touched_observations and K8 on own rows) against the reference's
    ``_integrate_shard`` under vmap: allocation and weights exact, sdf to
    1e-5 and color to 1e-4, as the fused path (K8 multiplies by a
    reciprocal where the inline update divides, and the port projects
    the voxels one rounding per operation)."""
    g = _global(jshard.allocate(CFG, S))
    for f, want in zip(_frames(2), marched):
        res = pool.run(W.integrate, g, np.asarray(f.depth), np.asarray(f.color),
                       np.asarray(f.T_wc), to_port(SMALL_INTR), to_port(CFG), 8192)
        _assert_map_equal(_ported(res), want, atol_sdf=1e-5, atol_color=1e-4)
        g = want


def test_halo_raycast_matches_reference(pool, marched):
    """The halo raycast against the reference's ``_raycast_shard`` under
    vmap (two ppermutes, pmin composite, masked psum blend) at 80x60: the
    same valid pixels to 99.5%, depth to 2e-3 m and normals (median
    cosine) above 0.999 where both hit; halo rows cross the seams."""
    g = marched[1]
    f = _frames(1, TINY)[0]
    body = functools.partial(jshard._raycast_shard, intr=TINY, tsdf_cfg=CFG, rc_cfg=RC_MARCH,
                             num_shards=S, halo_cap=144, with_color=True)
    want = jax.jit(jax.vmap(body, in_axes=(None, 0, 0, 0, 0, None, None),
                            axis_name=SHARD_AXIS))(
        jnp.asarray(g["directory"]), _stack(g["block_coords"]), _stack(g["sdf"]), _stack(g["weight"]),
        _stack(g["color"]), jnp.asarray(g["cuts"]), f.T_wc)
    want = {k: np.asarray(v)[0] for k, v in want._asdict().items()}
    res = pool.run(W.raycast, g, np.asarray(f.T_wc), to_port(TINY), to_port(CFG),
                   to_port(RC_MARCH), 144)
    got = res[0][0]
    assert np.mean(got["valid"] == want["valid"]) >= 0.995
    both = got["valid"] & want["valid"]
    assert both.sum() > 500
    np.testing.assert_allclose(got["depth"][both], want["depth"][both], atol=2e-3)
    cos = np.sum(got["normal_w"][both] * want["normal_w"][both], -1)
    assert np.median(cos) > 0.999
    halo = np.asarray([r[1] for r in res])  # (rank, from left / from right)
    assert halo[0, 0] == 0 and halo[-1, 1] == 0
    assert halo.sum() > 0


def test_labels_match_reference(pool, marched):
    """Sharded votes (K7 on own touched rows) equal the reference's inline
    vote in ``_fuse_labels_shard`` under vmap exactly, and the pmax
    composite of the instance-id image equals the reference's one-device
    ``sample_nearest`` on the gathered map exactly."""
    g = marched[1]
    f = _frames(2)[1]
    half = jnp.arange(SMALL_INTR.width)[None, :] < SMALL_INTR.width // 2
    gid = jnp.where(f.depth > 0, jnp.where(half, 3, 11), -1).astype(jnp.int32)
    votes = jshard.allocate_votes(CFG, S)
    body = functools.partial(jshard._fuse_labels_shard, intr=SMALL_INTR, cfg=CFG,
                             num_shards=S, max_touched=8192)
    lab, cnt = jax.jit(jax.vmap(body, in_axes=(None, 0, 0, 0, None, None, None, None),
                                axis_name=SHARD_AXIS))(
        jnp.asarray(g["directory"]), _stack(g["block_coords"]), _stack(votes.label),
        _stack(votes.count), jnp.asarray(g["cuts"]), gid, f.depth, f.T_wc)
    lab, cnt = np.asarray(lab).reshape(-1, 512), np.asarray(cnt).reshape(-1, 512)
    single = jblocks.BlockMap(directory=jnp.asarray(g["directory"]),
                              block_coords=jnp.asarray(g["block_coords"]),
                              n_active=jnp.asarray(g["n_active"].sum()),
                              overflow=jnp.zeros((), jnp.int32), sdf=jnp.asarray(g["sdf"]),
                              weight=jnp.asarray(g["weight"]), color=jnp.asarray(g["color"]))
    maps = jax.jit(lambda m, T: jblocks.raycast(m, T, SMALL_INTR, CFG, RC_MARCH))(
        single, f.T_wc)
    want_ids = jlabels.sample_nearest(jlabels.LabelVotes(label=jnp.asarray(lab),
                                                         count=jnp.asarray(cnt)),
                                      single, maps.vertex_w, maps.valid, CFG)
    res = pool.run(W.labels, g, np.asarray(votes.label), np.asarray(votes.count),
                   np.asarray(gid), np.asarray(f.depth), np.asarray(f.T_wc),
                   np.asarray(maps.vertex_w), np.asarray(maps.valid), to_port(SMALL_INTR),
                   to_port(CFG))
    got_lab = np.concatenate([r[0]["label"] for r in res])
    got_cnt = np.concatenate([r[0]["count"] for r in res])
    assert (cnt > 0).sum() > 500
    np.testing.assert_array_equal(got_lab, lab)
    np.testing.assert_array_equal(got_cnt, cnt)
    for r in res:
        np.testing.assert_array_equal(r[1], np.asarray(want_ids))


def test_clean_matches_reference(pool, marched):
    """Sharded clean against the reference's ``_clean_shard`` under vmap:
    the same surviving rows, directory and counts, exactly."""
    g = marched[1]
    body = functools.partial(jshard._clean_shard, cfg=CFG, min_weight=1.5, with_votes=False)
    c = CFG.table_capacity
    out = jax.jit(jax.vmap(body, in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0),
                           axis_name=SHARD_AXIS))(
        jnp.asarray(g["directory"]), _stack(g["block_coords"]), jnp.asarray(g["n_active"]).reshape(S, 1),
        jnp.asarray(g["overflow"]).reshape(S, 1), _stack(g["sdf"]), _stack(g["weight"]),
        _stack(g["color"]), _stack(np.zeros((c, 1), np.int32)),
        _stack(np.zeros((c, 1), np.float32)))
    out = [np.asarray(x) for x in out]
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    want = dict(directory=out[0][0], block_coords=flat(out[1]), n_active=out[2][:, 0],
                overflow=out[3][:, 0], sdf=flat(out[4]), weight=flat(out[5]),
                color=flat(out[6]), cuts=g["cuts"])
    got = _ported(pool.run(W.clean, g, to_port(CFG), 1.5))
    assert got["n_active"].sum() < g["n_active"].sum()
    _assert_map_equal(got, want, atol_sdf=0.0, atol_color=0.0)


@pytest.mark.parametrize("migrate_cap", [CL, 32])
def test_reshard_moves_rows_to_owners(pool, migrate_cap):
    """A map whose rows all sit on shard 0 (a one-device map loaded onto 4
    shards, tests/test_shard.py's case) moves every row to its slab owner,
    in one round or, with a small cap, in several; the directory-addressed
    contents and the votes that travel with the rows are unchanged."""
    f = _frames(1, TINY)[0]
    single = jax.jit(lambda m, d, c, T: jblocks.integrate(m, d, c, T, TINY, CFG))(
        jblocks.allocate(CFG), f.depth, f.color, f.T_wc)
    n0 = int(single.n_active)
    assert 0 < n0 <= CL
    g = _global(single)
    g.update(n_active=np.asarray([n0, 0, 0, 0], np.int32), overflow=np.zeros(S, np.int32),
             cuts=np.asarray(jshard.uniform_cuts(CFG, S)))
    rng = np.random.default_rng(1)
    label = rng.integers(-1, 9, g["sdf"].shape).astype(np.int32)
    count = rng.uniform(0, 5, g["sdf"].shape).astype(np.float32)
    res = pool.run(W.reshard, g, label, count, to_port(CFG), g["cuts"], migrate_cap)
    got = _ported([r[0] for r in res])
    moved, rounds = res[0][2], res[0][3]
    assert moved == n0 - int(got["n_active"][0]) and rounds >= (1 if migrate_cap == CL else 2)
    assert got["n_active"].sum() == n0 and got["overflow"].sum() == 0
    nb = CFG.grid_size // CFG.block_size
    for s in range(S):
        rows = got["block_coords"][s * CL:s * CL + got["n_active"][s]]
        assert (np.clip(rows[:, 0] // (nb // S), 0, S - 1) == s).all()
    sdir = g["directory"].reshape(-1)
    hdir = got["directory"].reshape(-1)
    np.testing.assert_array_equal(hdir >= 0, sdir >= 0)
    sel = np.nonzero(sdir >= 0)[0]
    for k in ("sdf", "weight", "color", "block_coords"):
        np.testing.assert_array_equal(got[k][hdir[sel]], g[k][sdir[sel]])
    got_lab = np.concatenate([r[1]["label"] for r in res])
    got_cnt = np.concatenate([r[1]["count"] for r in res])
    np.testing.assert_array_equal(got_lab[hdir[sel]], label[sdir[sel]])
    np.testing.assert_array_equal(got_cnt[hdir[sel]], count[sdir[sel]])


STUB = "int ifl_stub(void) { return 42; }\n"
FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
echo run >> "$COUNT_FILE"
sleep 1
exec gcc -shared -fPIC -x c "$src" -o "$out"
"""
BUILD_SCRIPT = """
import ctypes, sys
from pathlib import Path
from instancefusion_tpu_torch.ops.kernels import _build
root = Path(sys.argv[1])
_build.CSRC = root / "csrc"
_build.BUILD_DIR = root / "build"
lib = ctypes.CDLL(str(_build.build(["stub"])["stub"]))
print(lib.ifl_stub())
"""


def test_build_lock_two_processes(tmp_path):
    """Two processes that build at once: one compiles (a stub source and a
    stand-in compiler here), the other waits on the lock, and both load a
    complete library."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text(STUB)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               COUNT_FILE=str(tmp_path / "count"), PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(BUILD_SCRIPT), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o[0].strip() for o in outs] == ["42", "42"]
    assert (tmp_path / "count").read_text().count("run") == 1
