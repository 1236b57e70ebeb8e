"""The benchmark of the PyTorch/CUDA port (``instancefusion_tpu_torch``).

One run of one cell of ``BENCHMARK.json``, from the root of a checkout:

    python3 benchmark/run.py --workload config2.replay --seed 7 --seconds 51 --trace 0

It renders the cell's camera traffic from the seed, warms the program up,
drives ``instancefusion_tpu_torch.engine.pipeline.run`` for the measured
window, compares what the window produced with the plain reference
(``benchmark/reference/``), and prints the numbers compared beside their
limits as its last lines on standard error and one JSON result as the last
line of standard output: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``.  It exits non-zero, and prints no
result, without a CUDA card, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness import cell as _cell
    from harness import guard, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = _cell.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = guard.forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
