"""The ranks of a cell end the window after the same batch."""

import numpy as np

from benchmark import harness


def test_ranks_end_after_the_same_batch(tmp_path):
    path = tmp_path / "window"
    np.full(2, -1, np.int64).tofile(path)
    lead, follow = harness.Agreement(0, path), harness.Agreement(1, path)
    part = harness.Agreement.WINDOW
    # the follower finishes batch 3 before rank 0 sees its time is up
    assert not follow.ends_after(part, 3, True)
    assert not lead.ends_after(part, 3, True)  # the next batch is the last
    assert not lead.ends_after(part, 3, False)
    assert lead.ends_after(part, 4, False)
    assert follow.ends_after(part, 4, False)
    # the profiled part is agreed apart
    assert not follow.ends_after(harness.Agreement.PROFILED, 4, True)


def test_one_rank_runs_one_batch_past_its_time():
    a = harness.Agreement(0)
    assert not a.ends_after(a.WINDOW, 0, False)
    assert not a.ends_after(a.WINDOW, 1, True)
    assert a.ends_after(a.WINDOW, 2, False)
