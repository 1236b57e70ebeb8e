"""The end-to-end arithmetic: a rate over the whole window, set-up up to the
first frame, and a stall inside the window moving the rate."""

import pytest

from harness import e2e


def test_fps_is_over_the_whole_window():
    w = e2e.Window(t_process=0.0, t_first=1.0, t_end=3.0, n_frames=100)
    assert e2e.fps(w) == 50.0
    assert e2e.setup_s(w) == 1.0


def test_a_stall_moves_fps():
    base = [10.0] * 300  # ms a frame, closed loop
    stalled = list(base)
    stalled[100] = 1000.0  # one frame stalls a second
    replay = e2e.Window(0.0, 0.0, sum(base) / 1e3, 300)
    replay_stalled = e2e.Window(0.0, 0.0, sum(stalled) / 1e3, 300)
    assert e2e.fps(replay) == pytest.approx(100.0)
    assert e2e.fps(replay_stalled) < 0.8 * e2e.fps(replay)
