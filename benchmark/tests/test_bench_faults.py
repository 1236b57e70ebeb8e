"""The comparison that decides ``correct`` fails a broken timed path: a run of
the harness at a small size on the CPU, the look for a card skipped, with
the program's step broken underneath."""

import pytest
import torch

from harness import cell as _cell


def _broken(monkeypatch, fault):
    from instancefusion_tpu_torch.engine import slam

    real = slam.step

    def step(cfg, state, depth, color):
        if fault == "unchanged":
            one = torch.ones((), device=state.T_wc.device)
            return state, slam.StepInfo(inliers=one * 1000, residual=one * 0,
                                        track_ok=one > 0, fused_voxels=one)
        new, info = real(cfg, state, depth, color)
        T = new.T_wc.clone()
        T[0, 3] += 0.05  # the served pose altered where it is produced
        return new._replace(T_wc=T), info

    monkeypatch.setattr(slam, "step", step)


def test_sound_run_is_correct(tiny):
    out = _cell.run_cell(tiny("config2.replay"), 2**31 + 17, 1.0, False, "cpu", 0.0)
    assert out["correct"] is True, out["check"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_step_is_not_correct(tiny, monkeypatch, fault):
    _broken(monkeypatch, fault)
    # A short window: a step that does nothing runs many frames a second.
    out = _cell.run_cell(tiny("config2.replay"), 2**31 + 17, 0.25, False, "cpu", 0.0)
    assert out["correct"] is False, out["check"]
