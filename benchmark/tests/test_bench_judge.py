"""The judge protocol (``harness/judge.py``): arguments to the program merged
from every judge, a prediction carried for a later judge as the program
carries it, and ``frame_mfu`` summed over the judges' counted work."""

import types

import pytest
import torch

from harness import cell as _cell
from harness import judge, scene, spec, work

FRAMES = 18
ASKED = (5, 17)


class Probe:
    """A judge that asks for the prediction at `ASKED` and keeps it."""

    def pred_frames(self, n):
        return set(ASKED)

    def start(self, ctx):
        self.preds = {}

    def frame(self, ctx):
        if ctx.k in ASKED:
            self.preds[ctx.k] = ctx.pred

    def finish(self, ctx):
        return {}, []


def test_a_prediction_asked_for_carries_its_prior_from_the_start(tiny):
    """The reference's own SLAM predicts every frame, each from the previous
    prediction's depth where the frame has none, as the program does; the
    SLAM judge's prediction at a frame a later judge asks for is the same,
    bit for bit."""
    from reference.engine import slam as rslam

    cell = tiny("config2.replay")
    dev = torch.device("cpu")
    poses, depth, color = _cell.render_traffic(cell, 2**31 + 29, dev)
    cfg = judge.reference_config(cell.config["engine"])
    state = rslam.init_state(cfg, poses[0], dev)
    served, own = [], {}
    order = list(range(FRAMES))
    for k in order:
        state, _ = rslam.step(cfg, state, *scene.frame(depth, color, k))
        served.append(state.T_wc)
        if k in ASKED:
            own[k] = state.pred
    judges = judge.make(cell, 2**31 + 29, dev, count_work=False)
    judges["probe"] = probe = Probe()
    judge.keep(judges, types.SimpleNamespace(poses=torch.stack(served), state=state), {})
    judge.replay(judges, cell.config["engine"], depth, color, order)
    for k in ASKED:
        for field in ("depth", "valid", "vertex_w", "normal_w"):
            assert torch.equal(getattr(probe.preds[k], field), getattr(own[k], field)), (k, field)


def test_a_keyword_given_twice_is_an_error():
    class Head:
        def run_kw(self, window):
            return {"segment_fn": print}

    base = {"device": "cpu"}
    assert judge.run_kw({"a": Head(), "b": object()}, base, True) == {
        "device": "cpu", "segment_fn": print}
    with pytest.raises(ValueError, match="segment_fn"):
        judge.run_kw({"a": Head(), "b": Head()}, base, True)
    with pytest.raises(ValueError, match="device"):
        judge.run_kw({"a": types.SimpleNamespace(run_kw=lambda w: {"device": "x"})}, base, True)


def test_frame_mfu_sums_the_judges_counted_work():
    """Each judge's least time over the head's frames, added; a judge that
    counts nothing adds nothing."""
    mod = spec.load_metric("frame_mfu")
    head = types.SimpleNamespace(counted_work=lambda e, recs, n: (3.35e9 * sum(recs[:n]), 0.0))
    model = types.SimpleNamespace(counted_work=lambda e, recs, n: (0.0, 67e9 * len(recs)))
    run = types.SimpleNamespace(engine={}, head_frames=2, head_s=0.1,
                                judges={"a": head, "b": model, "c": object()},
                                records={"a": [1.0, 2.0, 4.0], "b": [None], "c": [1]})
    # a: 3 GB at 3.35 TB/s = 3 ms; b: 67 GFLOP at 67 TFLOP/s = 1 ms.
    assert mod.read(run) == pytest.approx(100.0 * 0.004 / 0.1)
    run.records = {}
    assert mod.read(run) is None
    assert work.least_seconds(3.35e9, 0.0) == pytest.approx(0.001)
