"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``bench/traffic/<name>.json``) gives the arrival process and the
distributions of prompt and output lengths; the cell gives the rate. The
sizes do not depend on the seed: N requests take the N quantiles
(i + 1/2) / N of each length distribution and of the inter-arrival gaps,
and the seed only orders them and draws the token ids. Every seed
therefore does the same work in another order, so runs differ by what
order does to the queue and not by how much there was to do. That fixed
set is a departure from a trace's own draws, made against the spread of a
tail; the order is not shaped. The Poisson process is the arithmetic of
the JAX package's ``serve/load.py::make_requests`` (exponential gaps at
1 / rate, summed), its gaps taken as quantiles in a plain seeded order:
runs of short gaps (bursts) come as often as in a Poisson stream that
holds the same count.

Mix keys:
  ``arrivals``  "poisson" (open loop at the cell's ``rate_rps``) or
                "backlog" (every request queued at the start);
  ``prompt``, ``output``  {"dist": "lognormal", "median", "sigma"} or
                {"dist": "uniform"}, each with "min", "max" and an optional
                "grid" (lengths rounded up to a multiple of it);
  ``strata``    optional k: each run of k requests holds one prompt length
                and one output length of each of k quantile bands
                (``order``). It never orders the gaps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclass(eq=False)
class Planned:
    """One request of the plan and what the harness stamps on it."""

    due: float  # seconds from the schedule's start
    prompt: np.ndarray
    max_new_tokens: int
    stamps: list = field(default_factory=list)  # host time a token reached the host
    finished_at: Optional[float] = None
    handle: object = None  # the program's request object, once submitted

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def done_by(self, t: float) -> bool:
        return self.finished_at is not None and self.finished_at <= t


def _quantiles(n: int):
    return [(i + 0.5) / n for i in range(n)]


def lengths(spec: dict, n: int) -> np.ndarray:
    """The n lengths of a length distribution, at its (i + 1/2)/n
    quantiles, clipped to [min, max] and rounded up to ``grid``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = NormalDist()
        vals = [spec["median"] * math.exp(spec["sigma"] * z.inv_cdf(q)) for q in _quantiles(n)]
    elif spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo + 1) - 0.5 for q in _quantiles(n)]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    out = np.clip(np.rint(vals), lo, hi).astype(np.int64)
    grid = int(spec.get("grid", 1))
    if grid > 1:
        out = np.minimum(-(-out // grid) * grid, hi)
    return out


def order(values, rng, strata: int = 1) -> np.ndarray:
    """``values`` (ascending) in a seeded order. With ``strata`` k > 1 the
    order is stratified: the values fall into k bands of consecutive
    quantiles, and each run of k consecutive places takes one value of
    every band, in random order within the run and within each band. Every
    seed still gets the same values; clusters of the largest (or smallest)
    then come no more often than the bands allow, which steadies a tail
    read from a few hundred requests."""
    values = np.asarray(values)
    n, k = len(values), max(1, int(strata))
    if k == 1 or n < k:
        return rng.permutation(values)
    runs = n // k
    bands = [rng.permutation(values[b * runs:(b + 1) * runs]) for b in range(k)]
    body = np.stack(bands, axis=1)  # [runs, k]: run r takes one of each band
    body = np.take_along_axis(body, rng.permuted(np.tile(np.arange(k), (runs, 1)), axis=1), 1)
    return np.concatenate([body.reshape(-1), rng.permutation(values[runs * k:])])


def plan(mix: dict, *, rate_rps: Optional[float], spans=(), backlog: Optional[int] = None,
         seed: int, vocab: int) -> list:
    """The seeded plan, in due order. A backlog is ``backlog`` requests due
    at 0. Poisson arrivals come in segments, one a duration of ``spans``
    (the lead-in, then the window), each of round(rate x span) requests
    with sizes and gaps of its own quantiles, the gaps scaled to fill the
    span exactly: every seed puts the same sizes, and as many requests,
    into the window."""
    rng = np.random.default_rng(int(seed))
    k = int(mix.get("strata", 1))
    if mix["arrivals"] == "backlog":
        n = int(backlog)
        p = order(lengths(mix["prompt"], n), rng, k)
        o = order(lengths(mix["output"], n), rng, k)
        due = np.zeros(n)
    elif mix["arrivals"] == "poisson":
        parts, start = [], 0.0
        for span in spans:
            n = max(1, round(rate_rps * span))
            ps = order(lengths(mix["prompt"], n), rng, k)
            os_ = order(lengths(mix["output"], n), rng, k)
            gaps = rng.permutation([-math.log1p(-q) for q in _quantiles(n)])
            gaps *= span / gaps.sum()
            parts.append((ps, os_, start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])))
            start += span
        p, o, due = (np.concatenate(x) for x in zip(*parts))
    else:
        raise ValueError(f"unknown arrival process {mix['arrivals']!r}")
    toks = rng.integers(0, vocab, size=int(p.sum()), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(p)])
    return [Planned(due=float(due[i]), prompt=toks[offs[i]:offs[i + 1]],
                    max_new_tokens=int(o[i])) for i in range(len(p))]
