"""The port's sequence readers (``datasets/tum.py``, ``scannet.py``,
``native_loader.py``) against the reference's, on the fixtures of
tests/test_tum.py, test_scannet.py and test_native_loader.py.

Association, depth, color, ground truth, ScanNet's intrinsics, instances
and invalid poses are held bit-equal to the reference's PIL path
(``prefer_native=False``); the port's own build of the native loader is
held bit-equal to the reference's build of the same source.  Two faults of
the reference's native path are held fixed: a native failure mid-sequence
raises instead of restarting from frame 0, and a frame the loader skips
does not shift the ground truth of the frames after it.
"""

import struct
import zlib

import numpy as np
import pytest

from instancefusion_tpu.datasets import native_loader as jnative
from instancefusion_tpu.datasets import scannet as jscannet
from instancefusion_tpu.datasets import tum as jtum
from instancefusion_tpu_torch.datasets import native_loader, png, scannet, tum
from tests.test_native_loader import H, W, _make_tum
from tests.test_scannet import _make_scene
from tests.test_tum import tum_fixture  # noqa: F401 (fixture)
from tests.torch_helpers import n


def _needs_native():
    if not native_loader.available():
        pytest.skip(f"the port's native loader cannot be built here: {native_loader.LOG.read_text()}")
    if not jnative.available():
        pytest.skip("the reference's native/libifl_dataloader.so does not load here")


def test_associate_equals_reference():
    rng = np.random.default_rng(0)
    a = [(float(t), ["a"]) for t in np.sort(rng.uniform(0, 2, 60))]
    b = [(float(t), ["b"]) for t in np.sort(rng.uniform(0, 2, 50))]
    for dt in (0.005, 0.02, 0.05):
        assert tum.associate(a, b, dt) == jtum.associate(a, b, dt)
    np.testing.assert_array_equal(tum.quat_to_mat(0.1, -0.2, 0.3, 0.9),
                                  jtum.quat_to_mat(0.1, -0.2, 0.3, 0.9))


def test_tum_frames_equal_reference(tum_fixture):  # noqa: F811
    ref = jtum.TumSequence(tum_fixture)
    seq = tum.TumSequence(tum_fixture, device="cpu")
    assert seq.items == ref.items
    frames = list(seq.frames(prefer_native=False))
    assert seq.decoder == "png"
    rframes = list(ref.frames(prefer_native=False))
    assert len(frames) == len(rframes) == 4
    for f, r in zip(frames, rframes):
        np.testing.assert_array_equal(n(f.depth), r.depth)
        np.testing.assert_array_equal(n(f.color), r.color)
        np.testing.assert_array_equal(n(f.T_wc), r.T_wc)
        assert f.timestamp == r.timestamp
    np.testing.assert_array_equal(seq.gt_poses(), ref.gt_poses())
    np.testing.assert_array_equal(seq.gt_poses(limit=2), ref.gt_poses(limit=2))
    assert len(list(seq.frames(limit=3, prefer_native=False))) == 3


def test_save_trajectory_roundtrip(tmp_path, tum_fixture):  # noqa: F811
    seq = tum.TumSequence(tum_fixture, device="cpu")
    rng = np.random.default_rng(1)
    poses = seq.gt_poses()
    # Rotations of every Shepperd branch (trace > 0 and each diagonal max).
    for k, axis in enumerate(([0, 0, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1])):
        ang = 0.3 if k == 0 else 2.9
        w = np.asarray(axis, float) * ang
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / ang
        poses[k, :3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        poses[k, :3, 3] = rng.uniform(-1, 1, 3)
    ts = [100.0 + 0.033 * i for i in range(len(poses))]
    tum.save_trajectory_tum(str(tmp_path / "port.txt"), ts, poses)
    jtum.save_trajectory_tum(str(tmp_path / "ref.txt"), ts, poses)
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "ref.txt").read_text()
    rows = np.array([[float(x) for x in line.split()] for line in text.splitlines()])
    np.testing.assert_allclose(rows[:, 0], ts, atol=1e-6)
    np.testing.assert_allclose(rows[:, 1:4], poses[:, :3, 3], atol=1e-6)
    back = np.stack([tum.quat_to_mat(*r[4:8]) for r in rows])
    np.testing.assert_allclose(back, poses[:, :3, :3], atol=1e-5)


def test_scannet_equals_reference(tmp_path):
    _make_scene(tmp_path)
    ref = jscannet.ScanNetSequence(str(tmp_path))
    seq = scannet.ScanNetSequence(str(tmp_path), device="cpu")
    assert seq.intrinsics.__dict__ == ref.intrinsics.__dict__
    assert seq.indices == ref.indices
    frames, rframes = list(seq.frames()), list(ref.frames())
    assert len(frames) == len(rframes) == 4
    for f, r in zip(frames, rframes):
        np.testing.assert_array_equal(n(f.depth), r.depth)
        np.testing.assert_array_equal(n(f.color), r.color)
        np.testing.assert_array_equal(n(f.instance), r.instance)
        assert f.timestamp == r.timestamp
        if r.T_wc is None:
            assert f.T_wc is None
        else:
            np.testing.assert_array_equal(n(f.T_wc), r.T_wc)
    assert frames[-1].T_wc is None
    assert seq.gt_poses() is None and ref.gt_poses() is None
    np.testing.assert_array_equal(seq.gt_poses(limit=3), ref.gt_poses(limit=3))


def test_scannet_resamples_png_color(tmp_path):
    """A PNG color frame at another size than the depth is read by the port's
    decoder and resampled by nearest index, as the reference does."""
    _make_scene(tmp_path, n=1)
    (tmp_path / "color" / "0.jpg").unlink()
    c = np.random.default_rng(2).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    png.write(str(tmp_path / "color" / "0.png"), c)
    f = next(scannet.ScanNetSequence(str(tmp_path), device="cpu").frames())
    r = next(jscannet.ScanNetSequence(str(tmp_path)).frames())
    assert f.color.shape == (48, 64, 3)
    np.testing.assert_array_equal(n(f.color), r.color)


def _klg(path):
    import io

    from PIL import Image

    rng = np.random.default_rng(1)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 3))
        for i in range(3):
            d = rng.integers(0, 5000, (H, W)).astype(np.uint16)
            buf = io.BytesIO()
            Image.fromarray(np.full((H, W, 3), 40 * i + 20, np.uint8)).save(
                buf, format="JPEG", quality=95)
            dz, jp = zlib.compress(d.tobytes()), buf.getvalue()
            f.write(struct.pack("<qii", 1_000_000 * i, len(dz), len(jp)))
            f.write(dz)
            f.write(jp)


@pytest.mark.parametrize("source", ["tum", "klg"])
def test_native_loader_equals_reference_build(source, tmp_path):
    _needs_native()
    if source == "tum":
        _make_tum(tmp_path)
        path = str(tmp_path)
    else:
        path = str(tmp_path / "log.klg")
        _klg(path)
    assert native_loader.library_path().parent == native_loader.BUILD_DIR
    with native_loader.NativeSequence(path, W, H) as seq:
        frames = list(seq)
    ref = list(jnative.NativeSequence(path, W, H))
    assert len(frames) == len(ref) == (5 if source == "tum" else 3)
    for i, (f, (d, rgb, ts)) in enumerate(zip(frames, ref)):
        np.testing.assert_array_equal(f.depth, d)
        np.testing.assert_array_equal(f.rgb, rgb)
        assert f.timestamp == ts and f.index == i


def _gt_fixture(tmp_path, n_frames=5):
    """tests/test_native_loader.py's TUM directory with a ground truth of one
    x translation a frame; returns those translations."""
    _make_tum(tmp_path)
    xs = 0.1 * np.arange(n_frames)
    lines = [f"{100.0 + i * 0.033 + 0.002:.6f} {xs[i]:.3f} 0 0 0 0 0 1" for i in range(n_frames)]
    (tmp_path / "groundtruth.txt").write_text("\n".join(lines) + "\n")
    return xs


def test_native_tum_sequence_equals_reference(tmp_path):
    _needs_native()
    _gt_fixture(tmp_path)
    seq = tum.TumSequence(str(tmp_path), device="cpu")
    frames = list(seq.frames())
    assert seq.decoder == "native"
    ref = list(jtum.TumSequence(str(tmp_path)).frames())
    assert len(frames) == len(ref) == 5
    for f, r in zip(frames, ref):
        np.testing.assert_array_equal(n(f.depth), r.depth)
        np.testing.assert_array_equal(n(f.color), r.color)
        np.testing.assert_array_equal(n(f.T_wc), r.T_wc)


def test_native_skip_keeps_ground_truth_paired(tmp_path):
    """Frame 1's depth is corrupt: the native loader skips it, and frames 2-4
    keep their own ground truth (the reference's enumerate index would give
    frame 2 the pose of frame 1)."""
    _needs_native()
    xs = _gt_fixture(tmp_path)
    dfile = sorted((tmp_path / "depth").iterdir())[1]
    dfile.write_bytes(dfile.read_bytes()[:60])
    seq = tum.TumSequence(str(tmp_path), device="cpu")
    frames = list(seq.frames())
    assert seq.decoder == "native"
    assert [round(f.timestamp, 3) for f in frames] == [100.0, 100.066, 100.099, 100.132]
    np.testing.assert_allclose([float(f.T_wc[0, 3]) for f in frames], xs[[0, 2, 3, 4]],
                               atol=1e-6)


def test_native_failure_mid_sequence_raises(tmp_path, monkeypatch):
    """A native failure after frames were produced raises; the reference
    swallows it and decodes again from frame 0, repeating frames."""
    _make_tum(tmp_path)

    class Failing:
        def __init__(self, path, width, height):
            pass

        def __len__(self):
            return 5

        def __iter__(self):
            for i in range(2):
                yield native_loader.NativeFrame(
                    np.zeros((H, W), np.float32), np.zeros((H, W, 3), np.uint8),
                    100.0 + i * 0.033, i)
            raise OSError("decoder thread died")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(native_loader, "available", lambda: True)
    monkeypatch.setattr(native_loader, "NativeSequence", Failing)
    seq = tum.TumSequence(str(tmp_path), device="cpu")
    got = []
    with pytest.raises(OSError, match="decoder thread died"):
        for f in seq.frames():
            got.append(f.timestamp)
    assert seq.decoder == "native"
    assert got == [100.0, 100.033]
