"""The traffic generator: deterministic from the seed, the same sizes for
every seed, lengths within their bounds and on their grid."""
import collections
import json

import numpy as np
import pytest

import benchtest  # noqa: F401  (import paths)
from pbench import traffic

CHAT = json.loads((benchtest.BENCH / "traffic" / "chat.json").read_text())
DOCS = json.loads((benchtest.BENCH / "traffic" / "docs.json").read_text())
BIG_SEED = 2**31 + 12345


def _plan(mix, seed, n=300, rate=3.0):
    """A backlog of n, or Poisson arrivals over a 20 s lead-in and a
    window holding n requests."""
    return traffic.plan(mix, rate_rps=rate, spans=(20.0, n / rate), backlog=n, seed=seed,
                        vocab=92544)


def test_same_seed_same_plan():
    a, b = _plan(CHAT, BIG_SEED), _plan(CHAT, BIG_SEED)
    assert [p.due for p in a] == [p.due for p in b]
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(a, b))


@pytest.mark.parametrize("mix", [CHAT, DOCS], ids=["chat", "docs"])
def test_other_seed_same_sizes_other_order(mix):
    a, b = _plan(mix, 1), _plan(mix, BIG_SEED)
    for key in (lambda p: p.prompt_len, lambda p: p.max_new_tokens):
        assert collections.Counter(map(key, a)) == collections.Counter(map(key, b))
    assert [p.prompt_len for p in a] != [p.prompt_len for p in b]
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b) if
                   x.prompt_len == y.prompt_len)


def test_poisson_gaps_are_a_fixed_set():
    a, b = _plan(CHAT, 7), _plan(CHAT, 8)
    ga, gb = np.diff([p.due for p in a] + [120.0]), np.diff([p.due for p in b] + [120.0])
    np.testing.assert_allclose(sorted(ga), sorted(gb), rtol=0, atol=1e-9)
    assert abs(np.mean(ga) - 1 / 3.0) < 1e-9  # the rate, exactly


def test_the_window_holds_the_same_requests_sizes_for_every_seed():
    def window(seed):
        return [p for p in _plan(CHAT, seed, n=150) if 20.0 <= p.due < 70.0]

    a, b = window(1), window(BIG_SEED)
    assert len(a) == len(b) == 150
    for key in (lambda p: p.prompt_len, lambda p: p.max_new_tokens):
        assert sorted(map(key, a)) == sorted(map(key, b))
    assert a[0].due == 20.0 and a[-1].due < 70.0


def test_lengths_within_bounds_and_grid():
    for mix in (CHAT, DOCS):
        for key in ("prompt", "output"):
            spec = mix[key]
            ls = traffic.lengths(spec, 1000)
            assert ls.min() >= spec["min"] and ls.max() <= spec["max"]
            if spec.get("grid", 1) > 1:
                assert np.all(ls % spec["grid"] == 0)
    ls = traffic.lengths(CHAT["prompt"], 4000)
    assert abs(np.median(ls) - CHAT["prompt"]["median"]) <= CHAT["prompt"]["grid"]


def test_backlog_is_due_at_once_and_tokens_in_vocab():
    plan = _plan(DOCS, 5, n=50)
    assert all(p.due == 0.0 for p in plan)
    assert all(p.prompt.min() >= 0 and p.prompt.max() < 92544 for p in plan)



@pytest.mark.parametrize("seed", [1, 7, BIG_SEED])
def test_poisson_gaps_come_in_a_plain_order(seed):
    """No band order on the gaps: runs of 8 arrivals hold any number of the
    shortest octile's gaps, and some hold three or more (a burst), as a
    Poisson stream's do."""
    plan = [p for p in _plan(CHAT, seed) if p.due >= 20.0]
    gaps = np.diff([p.due for p in plan])
    short = gaps <= np.quantile(gaps, 1 / 8)
    per_run = [int(short[i:i + 8].sum()) for i in range(0, len(short) - 7, 8)]
    assert set(per_run) != {1}
    assert max(int(short[i:i + 8].sum()) for i in range(len(short) - 7)) >= 3


@pytest.mark.parametrize("n,k", [(64, 8), (70, 8), (5, 8), (100, 1)])
def test_stratified_order_keeps_the_values_and_spreads_the_bands(n, k):
    values = np.arange(n)
    got = traffic.order(values, np.random.default_rng(3), k)
    assert sorted(got) == list(values)
    runs = n // k if k > 1 and n >= k else 0
    for r in range(runs):
        assert sorted(got[r * k:(r + 1) * k] // runs) == list(range(k))
