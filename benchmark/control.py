"""The control of the comparison that decides ``correct``: the plain reference
put in the program's place and computed one precision below the one the
configuration states (TF32 matrix products, where the configuration runs
float32 with TF32 off), then judged by the same comparison as a run.  It
has to come out as not correct; its readings set the upper end of each
limit (``PERF.md``).  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload config2.replay --seeds 1 2 3 --frames 2400

prints one JSON line a seed: the comparison's numbers and the verdict.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def control_run(cell, seed: int, frames: int, device: str, tf32: bool = True):
    """The reference's own SLAM over the cell's first `frames` frames, as the
    program's window would run them (loops off), judged by the cell's
    judges as a run's result; returns (numbers, correct, checked)."""
    import types

    import torch

    from harness import cell as _cell
    from harness import judge, scene
    from reference.engine import slam as rslam

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    poses, depth, color = _cell.render_traffic(cell, seed, dev)
    cfg = judge.reference_config(cell.config["engine"])
    state = rslam.init_state(cfg, poses[0], dev)
    served_poses = []
    order = [k % depth.shape[0] for k in range(frames)]
    for c in order:
        state, _ = rslam.step(cfg, state, *scene.frame(depth, color, c))
        served_poses.append(state.T_wc)
    judges = judge.make(cell, seed, dev, count_work=False)
    judge.keep(judges, types.SimpleNamespace(poses=torch.stack(served_poses), state=state), {})
    numbers, _ = judge.replay(judges, cell.config["engine"], depth, color, order)
    correct, checked = judge.verdict(numbers, cell.config["check"])
    return numbers, correct, checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2400,
                    help="frames of the run: about as many as a window of the cell")
    ap.add_argument("--tf32", type=int, choices=(0, 1), default=1,
                    help="1: the control; 0: the reference against itself")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(BENCH_DIR.parent))
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        numbers, correct, checked = control_run(cell, seed, args.frames, "cuda",
                                                tf32=bool(args.tf32))
        print(json.dumps({"workload": args.workload, "seed": seed, "tf32": args.tf32,
                          "frames": args.frames, "correct": correct, "checked": checked,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
