"""Port instance table and association (engine/instances.py) against the
reference's engine/instances.py on the CPU, on ground-truth segmentations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancefusion_tpu.config import InstanceConfig
from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.engine import instances as jinst
from instancefusion_tpu.models.segmentation import Segmentation as JSeg
from instancefusion_tpu_torch.datasets import synthetic as psyn
from instancefusion_tpu_torch.engine import instances as pinst
from instancefusion_tpu_torch.models.segmentation import Segmentation as PSeg
from tests.helpers import SMALL_INTR
from tests.torch_helpers import gt_segmentation, n, t, to_port

ICFG = InstanceConfig(max_instances=16, num_classes=8, min_mask_pixels=50)


def _both_segs(fields):
    return JSeg(*(jnp.asarray(x) for x in fields)), PSeg(*(t(x) for x in fields))


def _port_table(table):
    return pinst.InstanceTable(*(t(x) for x in table))


def assert_tables_equal(out, ref):
    for name, a, b in zip(ref._fields, out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(8)
    return [np.asarray(jsyn.render_frame(poses[i], SMALL_INTR).instance) for i in (1, 6)]


@pytest.mark.parametrize("k", [16, 3])
def test_gt_segmentation_matches_reference(frames, k):
    """The port's synthetic.gt_segmentation against the reference tests'
    construction, fields and dtypes; k = 3 clips id 3 into slot 2."""
    for inst in frames:
        out = psyn.gt_segmentation(t(inst), k)
        for name, a, b in zip(PSeg._fields, out, gt_segmentation(inst, k)):
            np.testing.assert_array_equal(n(a), b, err_msg=name)
            assert n(a).dtype == b.dtype, name
        assert int(out.valid.sum()) >= 3


def test_associate_creates_then_matches(frames):
    jseg, pseg = _both_segs(gt_segmentation(frames[0], ICFG.max_instances))
    none = np.full(frames[0].shape, -1, np.int32)
    # Frame 1: nothing predicted -> each big-enough mask creates a row.
    rg1, rt1 = jinst.associate(jinst.allocate(ICFG), jseg, jnp.asarray(none), ICFG)
    pg1, pt1 = pinst.associate(pinst.allocate(to_port(ICFG), "cpu"), pseg, t(none),
                               to_port(ICFG))
    np.testing.assert_array_equal(n(pg1), np.asarray(rg1))
    assert_tables_equal(pt1, rt1)
    assert int(np.asarray(rt1.active).sum()) >= 3
    # A later frame against the first assignment: matches, no growth.
    jseg2, pseg2 = _both_segs(gt_segmentation(frames[1], ICFG.max_instances))
    rg2, rt2 = jinst.associate(rt1, jseg2, rg1, ICFG)
    pg2, pt2 = pinst.associate(pt1, pseg2, pg1, to_port(ICFG))
    np.testing.assert_array_equal(n(pg2), np.asarray(rg2))
    assert_tables_equal(pt2, rt2)
    assert int(np.asarray(rt2.matches).sum()) >= 3


def test_associate_overflows_like_reference(frames):
    """A table with one free row: the second new mask overflows."""
    cfg = InstanceConfig(max_instances=4, num_classes=8, min_mask_pixels=50)
    jseg, pseg = _both_segs(gt_segmentation(frames[0], cfg.max_instances))
    table = jinst.allocate(cfg)
    table = table._replace(active=table.active.at[:3].set(True),
                           cls=table.cls.at[:3].set(7))
    none = jnp.full(frames[0].shape, -1, jnp.int32)
    rg, rt = jinst.associate(table, jseg, none, cfg)
    pg, pt = pinst.associate(_port_table(table), pseg, t(none), to_port(cfg))
    np.testing.assert_array_equal(n(pg), np.asarray(rg))
    assert_tables_equal(pt, rt)
    assert int(rt.overflow) >= 1


def test_find_and_apply_merges_on_double_overlap():
    """The double-overlap case of tests/test_instances.py: rows 2 and 5 are
    one object; the mask spanning both merges them."""
    cfg = InstanceConfig(max_instances=8, min_mask_pixels=10,
                         iou_match_thresh=0.3, merge_iou_thresh=0.2)
    table = jinst.allocate(cfg)
    table = table._replace(
        active=table.active.at[2].set(True).at[5].set(True),
        cls=table.cls.at[2].set(7).at[5].set(7),
        score=table.score.at[2].set(3.0).at[5].set(1.5),
        matches=table.matches.at[2].set(4).at[5].set(2),
    )
    h, w, k = 32, 64, cfg.max_instances
    pred = np.full((h, w), -1, np.int32)
    pred[:, 8:28], pred[:, 36:56] = 2, 5
    mask = np.full((h, w), -1, np.int32)
    mask[:, 8:56] = 0
    classes = np.zeros(k, np.int32)
    classes[0] = 7
    scores = np.zeros(k, np.float32)
    scores[0] = 1.0
    jseg, pseg = _both_segs((mask, classes, scores, np.arange(k) == 0))
    rsrc, rdst, rok = jinst.find_merges(table, jseg, jnp.asarray(pred), cfg)
    psrc, pdst, pok = pinst.find_merges(_port_table(table), pseg, t(pred), to_port(cfg))
    for a, b in ((psrc, rsrc), (pdst, rdst), (pok, rok)):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert bool(rok[0]) and {int(rsrc[0]), int(rdst[0])} == {2, 5}
    rt = jinst.apply_merges(table, rsrc, rdst, rok)
    pt = pinst.apply_merges(_port_table(table), psrc, pdst, pok)
    assert_tables_equal(pt, rt)
    assert float(rt.score[int(rdst[0])]) == 4.5


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_merges_into_one_row_matches_reference(seed):
    """Several rows folded into one destination in one call (the sums that
    ``_add_rows`` orders on CUDA) and a dropped entry: the table equals the
    reference's bit for bit on the CPU."""
    cfg = InstanceConfig(max_instances=8)
    n_rows = jinst.allocate(cfg).active.shape[0]
    rng = np.random.default_rng(seed)
    table = jinst.allocate(cfg)._replace(
        active=jnp.asarray(np.ones(n_rows, bool)),
        cls=jnp.asarray(rng.integers(1, 5, n_rows).astype(np.int32)),
        score=jnp.asarray(rng.uniform(0.1, 10.0, n_rows).astype(np.float32)),
        matches=jnp.asarray(rng.integers(1, 9, n_rows).astype(np.int32)),
        age=jnp.asarray(rng.integers(0, 50, n_rows).astype(np.int32)))
    k = cfg.max_instances
    src = np.array([1, 2, 3, 4, 6, 0, 0, 0], np.int32)[:k]
    dst = np.array([0, 0, 0, 5, 5, 0, 0, 0], np.int32)[:k]
    ok = np.array([True, True, True, True, False, False, False, False])[:k]
    rt = jinst.apply_merges(table, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok))
    pt = pinst.apply_merges(_port_table(table), t(src), t(dst), t(ok))
    assert_tables_equal(pt, rt)


def test_retire_stale_matches_reference(frames):
    jseg, pseg = _both_segs(gt_segmentation(frames[0], ICFG.max_instances))
    _, table = jinst.associate(jinst.allocate(ICFG), jseg,
                               jnp.full(frames[0].shape, -1, jnp.int32), ICFG)
    table = table._replace(age=jnp.arange(ICFG.max_instances, dtype=jnp.int32) * 10,
                           matches=jnp.arange(ICFG.max_instances, dtype=jnp.int32) % 3)
    ref = jinst.retire_stale(table, ICFG, min_matches=2, probation_age=15)
    out = pinst.retire_stale(_port_table(table), to_port(ICFG), min_matches=2,
                             probation_age=15)
    assert_tables_equal(out, ref)
    assert int(ref.active.sum()) < int(table.active.sum())


def test_instance_color_matches_reference():
    gids = np.arange(-1, 40, dtype=np.int32)
    np.testing.assert_array_equal(n(pinst.instance_color(torch.tensor(gids))),
                                  np.asarray(jinst.instance_color(jnp.asarray(gids))))
