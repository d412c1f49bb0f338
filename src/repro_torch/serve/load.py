"""Open-loop load generation for the serving core.

Port of the JAX package's ``serve/load.py``: Poisson arrivals
(exponential inter-arrival gaps) with randomized prompt lengths, token
budgets and priorities, and the drifting-draftability workload an online
controller is measured on. Drawn from a numpy ``Generator``, so the same
seed gives the same workload to both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.request import Request


def make_requests(
    n: int,
    rate_rps: float,
    *,
    vocab: int,
    max_new_tokens: int,
    prompt_lens=(4, 8, 12, 16),
    rng: np.random.Generator,
):
    """n Poisson-arrival requests at ``rate_rps``, each with a random
    prompt length from ``prompt_lens`` and a random budget in
    [min(2, max_new_tokens), max_new_tokens]."""
    lo = min(2, max_new_tokens)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    reqs = []
    for i in range(n):
        s0 = int(rng.choice(prompt_lens))
        prompt = rng.integers(0, vocab, size=(s0,)).astype(np.int32)
        reqs.append(
            Request(
                prompt=prompt,
                max_new_tokens=int(rng.integers(lo, max_new_tokens + 1)),
                arrival_time=float(arrivals[i]),
            )
        )
    return reqs


def make_slo_requests(
    n: int,
    rate_rps: float,
    *,
    vocab: int,
    max_new_tokens: int,
    short_lens=(8, 16),
    long_len: int = 96,
    long_every: int = 4,
    short_priority: int = 1,
    long_priority: int = 0,
    rng: np.random.Generator,
):
    """The SLO workload: Poisson arrivals where every ``long_every``-th
    request is a long, low-priority prompt and the rest are short,
    high-priority interactive requests. The long prompts are the
    monolithic-prefill stalls and, under pool pressure, the preemption
    victims."""
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    reqs = []
    for i in range(n):
        long = long_every > 0 and i % long_every == long_every - 1
        s0 = int(long_len) if long else int(rng.choice(short_lens))
        prompt = rng.integers(0, vocab, size=(s0,)).astype(np.int32)
        reqs.append(
            Request(
                prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                arrival_time=float(arrivals[i]),
                priority=int(long_priority if long else short_priority),
            )
        )
    return reqs


def make_drift_requests(
    phase_n=(6, 8, 6),
    rate_rps: float = 60.0,
    *,
    vocab: int,
    rep_tokens: int = 24,
    churn_tokens: int = 3,
    rep_prompt_len: int = 8,
    churn_prompt_lens=(8, 12, 16),
    prefix_len: int = 16,
    suffix_len: int = 6,
    phase_gap_s: float = 0.1,
    rng: np.random.Generator,
    prefix=None,
):
    """The drifting-draftability workload: three phases
    whose speculation profitability flips, so every static K loses
    somewhere and only a controller tracks the per-phase best arm.

    1. ``repetitive`` — short random prompts with long token budgets:
       tiny greedy models settle into repeating cycles, so the n-gram
       prompt-lookup drafter hits high acceptance and K>0 wins;
    2. ``churn`` — random prompts with tiny budgets (mostly admission/
       ramp-up, almost no self-history to mine): acceptance collapses
       and every drafted token is pure overhead — K=0 wins;
    3. ``shared-prefix`` — one common header plus random suffixes and
       long budgets again: high acceptance returns (plus prefix-cache
       hits on the paged layout).

    Arrivals are one continuous Poisson schedule across the phases with
    a ``phase_gap_s`` lull between them (the drain lets the next
    phase's window reflect its own traffic). Returns ``(reqs, spans)``
    where ``spans`` is ``[(name, start, end), ...]`` index ranges into
    ``reqs`` — index-based so identically-drawn workloads for different
    engines group the same way (rids are process-global)."""
    n1, n2, n3 = (int(n) for n in phase_n)
    if prefix is None:
        prefix = rng.integers(0, vocab, size=(prefix_len,)).astype(np.int32)
    assert len(prefix) == prefix_len
    reqs, spans, t = [], [], 0.0

    def _arrive():
        nonlocal t
        t += float(rng.exponential(1.0 / rate_rps))
        return t

    start = len(reqs)
    for _ in range(n1):
        prompt = rng.integers(0, vocab, size=(rep_prompt_len,)).astype(np.int32)
        reqs.append(
            Request(prompt=prompt, max_new_tokens=int(rep_tokens),
                    arrival_time=_arrive())
        )
    spans.append(("repetitive", start, len(reqs)))
    t += float(phase_gap_s)
    start = len(reqs)
    for _ in range(n2):
        s0 = int(rng.choice(churn_prompt_lens))
        prompt = rng.integers(0, vocab, size=(s0,)).astype(np.int32)
        reqs.append(
            Request(prompt=prompt, max_new_tokens=int(churn_tokens),
                    arrival_time=_arrive())
        )
    spans.append(("churn", start, len(reqs)))
    t += float(phase_gap_s)
    start = len(reqs)
    for _ in range(n3):
        suffix = rng.integers(0, vocab, size=(suffix_len,)).astype(np.int32)
        reqs.append(
            Request(prompt=np.concatenate([prefix, suffix]),
                    max_new_tokens=int(rep_tokens), arrival_time=_arrive())
        )
    spans.append(("shared-prefix", start, len(reqs)))
    return reqs, spans


def make_shared_prefix_requests(
    n: int,
    rate_rps: float,
    *,
    vocab: int,
    prefix_len: int,
    suffix_len: int,
    max_new_tokens: int,
    rng: np.random.Generator,
    prefix=None,
):
    """n Poisson-arrival requests whose prompts share one ``prefix_len``-
    token prefix (a system prompt, the workload the prefix cache targets)
    followed by a per-request random ``suffix_len``-token tail."""
    if prefix is None:
        prefix = rng.integers(0, vocab, size=(prefix_len,)).astype(np.int32)
    assert len(prefix) == prefix_len
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    reqs = []
    for i in range(n):
        suffix = rng.integers(0, vocab, size=(suffix_len,)).astype(np.int32)
        reqs.append(
            Request(
                prompt=np.concatenate([prefix, suffix]),
                max_new_tokens=max_new_tokens,
                arrival_time=float(arrivals[i]),
            )
        )
    return reqs
