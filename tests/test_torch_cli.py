"""The port's command line (``instancefusion_tpu_torch.cli``) against the
reference's, and on a TUM-format sequence written by the port's PNG
encoder, with and without active-window streaming.

Tolerance of the CLI comparison: the exported trajectories agree within
2e-5 m and 2e-5 in each quaternion component over 6 frames of the small
dense configuration (measured 2e-6 m and 1e-6, the files' last printed
digit, on one thread; the ATEs differ by 5e-8 m): the dense ICP is
ill-conditioned on the orbit (tests/test_torch_slam_dense.py) and the
port's fp32 sums round in another order than XLA's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from instancefusion_tpu import cli as jcli
from instancefusion_tpu_torch import cli
from instancefusion_tpu_torch.datasets import png
from instancefusion_tpu_torch.datasets import synthetic as psyn
from tests.torch_helpers import one_thread, to_port  # noqa: F401 (autouse fixture)

TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])["summary"]


def _traj(path) -> np.ndarray:
    return np.loadtxt(path)


def test_cli_equals_reference(tmp_path, capsys):
    common = ["run", "--small", "--frames", "6", "--quiet"]
    assert jcli.main(common + ["--platform", "cpu", "--export-traj",
                               str(tmp_path / "ref.txt")]) == 0
    ref = _summary(capsys.readouterr().out)
    assert cli.main(common + ["--device", "cpu", "--export-traj",
                              str(tmp_path / "port.txt")]) == 0
    out = _summary(capsys.readouterr().out)
    assert set(out) == set(ref) == {"frames", "fps", "keyframes", "loop_closures", "ate_rmse_m"}
    assert (out["frames"], out["keyframes"], out["loop_closures"]) == \
        (ref["frames"], ref["keyframes"], ref["loop_closures"]) == (6, 0, 0)
    assert abs(out["ate_rmse_m"] - ref["ate_rmse_m"]) < TOL
    a, b = _traj(tmp_path / "port.txt"), _traj(tmp_path / "ref.txt")
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=TOL, rtol=0)


def _tum_fixture(root, n_frames: int, intr) -> np.ndarray:
    """A TUM directory of the synthetic orbit written by the port's PNG
    encoder: 16-bit depth at 1/5000 m, 8-bit color, rgb stamps 5 ms after
    the depth's at 30 Hz, and the ground truth.  Returns the poses."""
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    poses = psyn.orbit_trajectory(n_frames, device="cpu")
    lines = {"rgb": [], "depth": [], "gt": []}
    for i in range(n_frames):
        f = psyn.render_frame(poses[i], intr)
        ts = 1000.0 + i / 30.0
        png.write(str(root / "depth" / f"{ts:.6f}.png"),
                  np.round(f.depth.numpy() * 5000.0).astype(np.uint16))
        png.write(str(root / "rgb" / f"{ts:.6f}.png"),
                  np.round(f.color.numpy() * 255.0).astype(np.uint8))
        lines["depth"].append(f"{ts:.6f} depth/{ts:.6f}.png")
        lines["rgb"].append(f"{ts + 0.005:.6f} rgb/{ts:.6f}.png")
        T = poses[i].numpy().astype(np.float64)
        from instancefusion_tpu_torch.utils.ate import rotmat_to_quat

        q = rotmat_to_quat(T[:3, :3])
        lines["gt"].append(f"{ts:.6f} " + " ".join(f"{x:.9f}" for x in (*T[:3, 3], *q)))
    for name, rows in (("rgb.txt", lines["rgb"]), ("depth.txt", lines["depth"]),
                       ("groundtruth.txt", lines["gt"])):
        (root / name).write_text("# timestamp data\n" + "\n".join(rows) + "\n")
    return poses.numpy()


@pytest.mark.parametrize("stream", [False, True])
def test_cli_runs_tum_sequence(stream, tmp_path, capsys):
    from tests.helpers import SMALL_INTR

    _tum_fixture(tmp_path / "seq", 6, to_port(SMALL_INTR))
    argv = ["run", "--small", "--dataset", str(tmp_path / "seq"), "--frames", "6",
            "--device", "cpu", "--quiet", "--metrics-out", str(tmp_path / "m.jsonl"),
            "--export-traj", str(tmp_path / "traj.txt")]
    if stream:
        # Streaming needs the block map: the local-loop option selects it.
        argv += ["--local-loops", "--stream-every", "2", "--stream-radius", "1.0"]
    assert cli.main(argv) == 0
    io = capsys.readouterr()
    assert "decoder: " in io.err
    s = _summary(io.out)
    assert s["frames"] == 6 and s["ate_rmse_m"] < 0.04  # below the 4 cm voxel
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert len(rows) == 6 and all(r["track_ok"] for r in rows)
    if stream:
        ticks = [r for r in rows if "stream_out" in r]
        assert [r["frame"] for r in ticks] == [1, 3, 5]
        assert sum(r["stream_out"] for r in ticks) > 0
        assert all("t_stream_ms" in r for r in ticks)
    assert _traj(tmp_path / "traj.txt").shape == (6, 8)


def test_shards_raise():
    """``--shards`` above 1 runs the sharded map (tests/test_torch_pipeline_sharded.py);
    on the small dense map it raises the reference's ValueError before any
    rank starts."""
    with pytest.raises(ValueError, match="map_kind='blocks'"):
        cli.main(["run", "--small", "--frames", "2", "--device", "cpu", "--quiet",
                  "--shards", "2"])


def test_cli_imports_no_jax():
    code = (
        "import sys\n"
        "from instancefusion_tpu_torch import cli\n"
        "assert cli.main(['run', '--small', '--frames', '2', '--device', 'cpu', '--quiet']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'instancefusion_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
