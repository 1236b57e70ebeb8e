"""The port's segmentation head against the reference's flax head on the CPU:
weights carried across by convert.seghead_from_flax, the forward pass,
bilinear upsampling, instance extraction and the whole segment call."""

import filecmp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.models import segmentation as jseg
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.models import segmentation as pseg
from tests.helpers import SMALL_INTR
from tests.torch_helpers import n, t

REPO = Path(__file__).resolve().parents[1]
K = 16


@pytest.fixture(scope="module")
def heads():
    """(flax params, num_classes, width) of the packaged checkpoint and the
    port's head loaded from its own copy of it."""
    return jseg.load_pretrained(), pseg.load_pretrained(device="cpu")


@pytest.fixture(scope="module")
def frame_rgb():
    """A rendered 120x160 frame's color, and the same at 60x80 (2x2 mean)."""
    f = jsyn.render_frame(jsyn.orbit_trajectory(5)[2], SMALL_INTR)
    rgb = np.asarray(f.color, np.float32)
    half = rgb.reshape(60, 2, 80, 2, 3).mean(axis=(1, 3)).astype(np.float32)
    return {(120, 160): rgb, (60, 80): half}


def test_packaged_weights_are_the_reference_file():
    assert filecmp.cmp(
        REPO / "instancefusion_tpu/models/weights/seghead_synthetic_w16.npz",
        REPO / "instancefusion_tpu_torch/models/weights/seghead_synthetic_w16.npz",
        shallow=False)


def test_seghead_from_flax_carries_every_array(heads):
    (params, _, _), model = heads
    with np.load(REPO / "instancefusion_tpu/models/weights/seghead_synthetic_w16.npz") as d:
        arrays = {k: d[k] for k in d.files}
    state = convert.seghead_from_flax(arrays)
    assert len(state) == len(arrays) == 38
    assert state.keys() == model.state_dict().keys()
    k = np.asarray(params["params"]["_ConvBlock_3"]["Conv_0"]["kernel"])  # HWIO
    np.testing.assert_array_equal(n(state["blocks.3.conv.weight"]), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        n(state["blocks.7.norm.weight"]),
        np.asarray(params["params"]["_ConvBlock_7"]["GroupNorm_0"]["scale"]))


@pytest.mark.parametrize("shape", [(60, 80), (120, 160)])
def test_head_forward_matches_flax(heads, frame_rgb, shape):
    """sem, center and offset within 1e-4 absolute plus 1e-4 relative; 60x80
    runs the odd 15 -> 8 stride-2 step and the 8 -> 15 upsampling.

    The relative term is the reference's fp32 rounding: against a float64
    evaluation of the same weights the flax head is off by ~1e-4 at 120x160
    (logits up to ~5), the port, whose GroupNorm takes the variance about
    the mean, by ~1e-5.
    """
    (params, num_classes, width), model = heads
    rgb = frame_rgb[shape]
    ref = jseg.PanopticHead(num_classes=num_classes, width=width).apply(params, rgb)
    with torch.no_grad():
        out = model(t(rgb))
    for a, b, name in zip(out, ref, ("sem", "center", "offset")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("src,dst", [((8, 10), (15, 20)), ((15, 20), (30, 40)),
                                     ((30, 40), (60, 80))])
def test_bilinear_upsampling_matches_jax_resize(src, dst):
    x = np.random.default_rng(src[0]).normal(size=(1, *src, 6)).astype(np.float32)
    ref = jax.image.resize(x, (1, *dst, 6), "bilinear")
    out = F.interpolate(t(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-6, rtol=0)


def test_extract_instances_matches_reference():
    """The constructed two-blob case of tests/test_instances.py, equal."""
    h, w, k = 64, 64, 4
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    in_a = (np.abs(yy - 16) < 8) & (np.abs(xx - 16) < 8)
    in_b = (np.abs(yy - 48) < 8) & (np.abs(xx - 40) < 8)
    fg = in_a | in_b
    sem = np.zeros((h, w, 3), np.float32)
    sem[..., 1] = np.where(fg, 5.0, -5.0)
    sem[..., 0] = np.where(fg, -5.0, 5.0)
    heat = np.full((h, w), -10.0, np.float32)
    heat[16, 16] = heat[48, 40] = 5.0
    offset = (np.stack([np.where(in_a, 16.0, 48.0) - yy, np.where(in_a, 16.0, 40.0) - xx],
                       -1) / w).astype(np.float32)
    ref = jseg.extract_instances(jnp.asarray(sem), jnp.asarray(heat), jnp.asarray(offset), k)
    out = pseg.extract_instances(t(sem), t(heat), t(offset), k)
    assert int(out.valid.sum()) == 2
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_extract_instances_breaks_ties_like_reference():
    """A plateau of equal peak scores (more peaks than slots): the k peaks
    kept, and their order, are lax.top_k's (lower pixel index first)."""
    h, w, k = 24, 32, 6
    rng = np.random.default_rng(5)
    heat = np.full((h, w), -10.0, np.float32)
    heat[4:9, 6:12] = 3.0  # 30 tied peaks
    heat[15, 20] = 4.0
    sem = rng.normal(size=(h, w, 3)).astype(np.float32)
    sem[..., 1] += 4.0
    offset = (0.05 * rng.normal(size=(h, w, 2))).astype(np.float32)
    ref = jseg.extract_instances(jnp.asarray(sem), jnp.asarray(heat), jnp.asarray(offset), k)
    out = pseg.extract_instances(t(sem), t(heat), t(offset), k)
    assert int(np.asarray(ref.valid).sum()) >= 4
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_segment_matches_reference(heads, frame_rgb):
    """mask_id equal on >= 99.9% of pixels, classes and validity equal."""
    (params, num_classes, width), model = heads
    rgb = frame_rgb[(120, 160)]
    ref = jseg.segment(params, jnp.asarray(rgb), num_classes, K, width)
    out = pseg.segment(model, t(rgb), K)
    assert int(np.asarray(ref.valid).sum()) >= 2
    assert (n(out.mask_id) == np.asarray(ref.mask_id)).mean() >= 0.999
    np.testing.assert_array_equal(n(out.classes), np.asarray(ref.classes))
    np.testing.assert_array_equal(n(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(n(out.scores), np.asarray(ref.scores), atol=1e-4)
