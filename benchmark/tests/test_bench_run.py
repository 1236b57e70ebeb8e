"""The command fails, and prints no result, where it cannot measure: without a
card, and in a checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from harness import spec


def run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "config2.replay",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    out = run(spec.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_result_line_shape(tiny):
    """A CPU run of the harness at a small size: the keys the result line
    carries, the numbers compared last."""
    from harness import cell as _cell

    out = _cell.run_cell(tiny("config2.replay"), 2**31 + 99, 1.0, False, "cpu", 0.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert out["correct"] is True and out["attempted"] > 0
    json.dumps(out)
