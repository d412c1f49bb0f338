"""Tails, rates and spreads over a window, from the harness's own stamps.

Every time here is seconds on one host clock (``time.perf_counter``): a
request's due time on the open-loop schedule, and the stamp taken at the
end of the scheduler step that produced each of its tokens.
"""
from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """The p-th percentile with linear interpolation between order
    statistics (numpy's default). Raises on an empty sample: a tail of
    nothing is no number."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_samples(requests, t0: float, t1: float) -> list:
    """Time to first token, in seconds, of every request due in [t0, t1):
    from its due time to the stamp of its first token; a request with no
    first token by t1 counts the wait it has had so far (t1 - due)."""
    out = []
    for r in requests:
        if t0 <= r.due < t1:
            first = r.stamps[0] if r.stamps else None
            out.append((first if first is not None and first <= t1 else t1) - r.due)
    return out


def itl_samples(requests, t0: float, t1: float) -> list:
    """Every gap between consecutive output tokens whose later token was
    stamped in [t0, t1), over every request; a request still generating at
    t1 adds the gap it has had open since its last token before t1. Two
    tokens stamped at one step end are a gap of 0."""
    out = []
    for r in requests:
        s = r.stamps
        for a, b in zip(s, s[1:]):
            if t0 <= b < t1:
                out.append(b - a)
        before = [t for t in s if t < t1]
        if before and not r.done_by(t1):
            out.append(t1 - before[-1])
    return out


def tokens_in(requests, t0: float, t1: float) -> int:
    """Output tokens stamped in [t0, t1)."""
    return sum(1 for r in requests for t in r.stamps if t0 <= t < t1)
