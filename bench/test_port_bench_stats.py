"""Tails and rates over a window: censored TTFT, gaps across a stall, the
window's edges."""
import numpy as np
import pytest

import benchtest  # noqa: F401  (import paths)
from pbench import stats
from pbench.traffic import Planned


def _req(due, stamps, finished=None):
    return Planned(due=due, prompt=np.zeros(4, np.int64), max_new_tokens=len(stamps) or 1,
                   stamps=list(stamps), finished_at=finished)


@pytest.mark.parametrize("p", [0, 50, 95, 99, 100])
def test_percentile_matches_numpy(p):
    xs = np.random.default_rng(0).exponential(size=37)
    assert stats.percentile(xs, p) == pytest.approx(np.percentile(xs, p), rel=1e-12)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_ttft_censored_and_window_edges():
    reqs = [_req(0.5, [0.7]),          # due before the window: not counted
            _req(1.0, [1.25, 1.3]),    # 0.25
            _req(2.0, []),             # no token by the end: 3.0 - 2.0
            _req(2.5, [3.5]),          # first token after the end: censored at 0.5
            _req(3.0, [3.1])]          # due at the end: outside [1, 3)
    assert sorted(stats.ttft_samples(reqs, 1.0, 3.0)) == pytest.approx([0.25, 0.5, 1.0])


def test_itl_gaps_across_a_stall():
    stall = [1.0, 1.05, 1.10, 1.90, 1.95]  # a 0.8 s stall in front of a step
    reqs = [_req(0.9, stall, finished=1.95),
            _req(0.9, [1.0, 1.0, 1.5]),     # two tokens of one step: a gap of 0
            _req(0.0, [0.2, 0.3], finished=0.3)]  # all before the window
    xs = sorted(stats.itl_samples(reqs, 1.0, 2.0))
    # the open gap of the unfinished request at the window's end: 2.0 - 1.5
    assert xs == pytest.approx(sorted([0.05, 0.05, 0.8, 0.05, 0.0, 0.5, 0.5]))
    assert max(xs) == pytest.approx(0.8)


def test_gap_closing_after_the_window_counts_open():
    r = _req(0.0, [0.9, 2.5], finished=2.5)
    assert stats.itl_samples([r], 1.0, 2.0) == pytest.approx([1.1])


def test_tokens_in_counts_the_window_only():
    reqs = [_req(0.0, [0.5, 1.0, 1.5, 2.0]), _req(0.0, [1.99])]
    assert stats.tokens_in(reqs, 1.0, 2.0) == 3
