"""Train the segmentation head on randomized synthetic scenes (port of the
root ``_train_seghead.py``).

    python -m instancefusion_tpu_torch.models.train_seghead --out head.npz
    python -m instancefusion_tpu_torch.models.train_seghead --steps 50 \\
        --device cpu --out /tmp/head.npz

The data are the reference trainer's: the fixed legacy scene at 8 poses and
randomized scenes ``TRAIN_SEEDS`` (1-12) at 12 poses each, rendered
alternately at 320x240 and 160x120, with the walls as background and each
object's kind (1 sphere, 2 box, 3 cylinder) as its class.  Training is
Adam with a cosine decay from 1e-3 to 5% of it, one frame a step drawn by
``np.random.default_rng(0)``, from flax's initializers seeded 0.  It
prints the loss every 50 steps, writes the checkpoint in the reference's
format (``segmentation.save_pretrained``; the packaged
``models/weights/seghead_synthetic_w16.npz`` is written only when its path
is passed), then the pixel class accuracy on training frame 0 and on the
held-out scene ``HELD_OUT`` at both sizes.  It runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from instancefusion_tpu_torch import device as _device
from instancefusion_tpu_torch.datasets import synthetic
from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.models import segmentation as seg

INTR_160 = Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120)
INTR_320 = Intrinsics(fx=258.6, fy=258.2, cx=159.5, cy=119.5, width=320, height=240)
NUM_CLASSES = 5  # background, sphere, box, cylinder, one spare
WIDTH = 16
STEPS = 4000
LR, ALPHA = 1e-3, 0.05
TRAIN_SEEDS = tuple(range(1, 13))
HELD_OUT = 1234
# Instances extracted for the accuracy report.
REPORT_INSTANCES = 8


def poses(n: int, device) -> torch.Tensor:
    """n // 2 orbit poses (sweep 1.6), then handheld ones (sweep 1.8)."""
    return torch.cat([synthetic.orbit_trajectory(n // 2, sweep=1.6, device=device),
                      synthetic.handheld_trajectory(n - n // 2, sweep=1.8, device=device)])


def _kinds(scene, device) -> torch.Tensor:
    """Class of instance id i: 0 for the walls (id 0), then the kinds."""
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                      scene.kinds.to(torch.int32)])


def make_dataset(device=None) -> list:
    """(frame, class_of_instance) pairs over the scenes and both sizes."""
    dev = _device.resolve(device)
    assert HELD_OUT not in TRAIN_SEEDS
    data = []
    fixed = torch.arange(NUM_CLASSES, dtype=torch.int32, device=dev)  # ids 1-3 are kinds
    for i, p in enumerate(poses(8, dev)):
        data.append((synthetic.render_frame(p, INTR_320 if i % 2 == 0 else INTR_160,
                                            device=dev), fixed))
    for s in TRAIN_SEEDS:
        scene = synthetic.random_scene(s, device=dev)
        cls = _kinds(scene, dev)
        for i, p in enumerate(poses(12, dev)):
            intr = INTR_320 if i % 2 == 0 else INTR_160
            data.append((synthetic.render_frame_scene(p, intr, scene), cls))
    return data


def targets(frame, class_of):
    """The frame's training targets; the walls (instance 0) are background."""
    inst = torch.where(frame.instance == 0, torch.full_like(frame.instance, -1),
                       frame.instance)
    return seg.targets_from_instances(inst, class_of)


def pixel_accuracy(model, frame, class_of) -> float:
    """Share of pixels whose segmented class (0 off every mask) equals the
    ground truth's (0 for the walls and off the objects)."""
    s = seg.segment(model, frame.color, REPORT_INSTANCES)
    gt_inst = frame.instance.long()
    gt = torch.where(gt_inst > 0, class_of.long()[gt_inst.clamp(min=0)],
                     torch.zeros_like(gt_inst))
    mask = s.mask_id.long()
    pred = torch.where(mask >= 0, s.classes.long()[mask.clamp(min=0)], torch.zeros_like(mask))
    return float((pred == gt).float().mean())


def train(steps: int = STEPS, device=None, data=None, stop: int | None = None,
          log=print):
    """Train a fresh head over a `steps`-step schedule (the first `stop`
    steps of it when given) on `data` (``make_dataset``'s, made here when
    None).  Returns (model, history, data); history holds each step's loss,
    frame height and seconds (one device read a step, for the loss)."""
    dev = _device.resolve(device)
    data = make_dataset(dev) if data is None else data
    tgts = [targets(f, c) for f, c in data]
    model = seg.init_params(INTR_320.height, INTR_320.width, NUM_CLASSES, WIDTH,
                            torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, seg.cosine_decay(LR, steps, ALPHA))
    rng = np.random.default_rng(0)
    history = {"loss": [], "height": [], "seconds": []}
    for it in range(steps if stop is None else stop):
        i = int(rng.integers(len(data)))
        t0 = time.perf_counter()
        loss, aux = seg.train_step(model, opt, data[i][0].color, tgts[i])
        sched.step()
        history["loss"].append(float(loss))
        history["seconds"].append(time.perf_counter() - t0)
        history["height"].append(int(data[i][0].color.shape[0]))
        if it % 50 == 0 or it == steps - 1:
            log(f"step {it}: loss {history['loss'][-1]:.4f} ce {float(aux['ce']):.4f} "
                f"center {float(aux['center']):.5f} offset {float(aux['offset']):.3f}")
    return model.eval(), history, data


def report(model, data, log=print) -> dict:
    """Pixel class accuracy on training frame 0 and on the held-out scene at
    320x240 and 160x120 (the reference trainer's report)."""
    dev = next(model.parameters()).device
    out = {"train frame 0": pixel_accuracy(model, *data[0])}
    scene = synthetic.random_scene(HELD_OUT, device=dev)
    cls = _kinds(scene, dev)
    for intr, tag in ((INTR_320, "320"), (INTR_160, "160")):
        frame = synthetic.render_frame_scene(poses(8, dev)[3], intr, scene)
        out[f"held-out seed {HELD_OUT} @{tag}"] = pixel_accuracy(model, frame, cls)
    for name, acc in out.items():
        log(f"{name}: pixel class acc {acc:.3f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default="seghead_synthetic_w16.npz",
                    help="checkpoint path (default: in the current directory)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    model, _, data = train(args.steps, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    seg.save_pretrained(args.out, model)
    print(f"saved {args.out} {os.path.getsize(args.out) / 1e6:.2f} MB "
          f"({time.perf_counter() - t0:.1f} s)")
    report(model, data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
