"""Request lifecycle for the continuous-batching serving core.

Port of the JAX package's ``serve/request.py``. States move queued →
prefill → decode → finished, with a preempted detour (decode → preempted
→ prefill) when a higher-priority arrival needs the row; the scheduler
owns every transition.
Latency accounting is per request — TTFT (arrival to first token,
queueing included), queue wait (arrival to first admission), TPOT
(decode time per later token) and end-to-end — aggregated across a run
by ``ServeStats``. All times are seconds on the scheduler's run clock
(0 = run start), so ``arrival_time`` doubles as the open-loop load
generator's injection schedule.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.serve.telemetry import MetricsRegistry, quantile

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
PREEMPTED = "preempted"
FINISHED = "finished"

_RID = itertools.count()


@dataclass(eq=False)  # identity semantics: requests are mutable and unique
class Request:
    """One generation request: a prompt, a token budget, an arrival time."""

    prompt: Any  # [S0] int token ids
    max_new_tokens: int
    arrival_time: float = 0.0  # seconds from run start (open-loop schedule)
    eos_id: Optional[int] = None  # early finish on this token
    patch_embeds: Any = None  # [P, D] VLM frontend embeddings
    priority: int = 0  # higher = more important (strict-priority admission)
    rid: int = field(default_factory=lambda: next(_RID))

    # lifecycle — owned by the scheduler
    state: str = QUEUED
    slot: Optional[int] = None  # slot index (slotted) / decode row (paged)
    prefix_hit: int = 0  # prompt tokens served from the prefix cache
    prefill_tokens: int = 0  # prompt positions its prefills computed (resumes too)
    prefill_pad: int = 0  # pad positions those prefills computed past them
    tokens: list = field(default_factory=list)
    t_admit: Optional[float] = None  # prefill started (slot allocated)
    t_first: Optional[float] = None  # first token available
    t_finish: Optional[float] = None
    # preempt/resume — owned by the scheduler
    preemptions: int = 0  # times this request was evicted mid-decode
    sample_state: Any = None  # its row sampler's state, saved across preemption
    t_first_admit: Optional[float] = None  # first admission (queue wait ends)

    @property
    def finished(self) -> bool:
        return self.state == FINISHED

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    # ------------------------------------------------------------------
    # latency accounting
    @property
    def ttft_ms(self) -> Optional[float]:
        """Arrival → first token, queueing included."""
        if self.t_first is None:
            return None
        return (self.t_first - self.arrival_time) * 1e3

    @property
    def queue_wait_ms(self) -> Optional[float]:
        """Arrival → first admission: the scheduler-owned slice of TTFT."""
        if self.t_first_admit is None:
            return None
        return (self.t_first_admit - self.arrival_time) * 1e3

    @property
    def service_ttft_ms(self) -> Optional[float]:
        """First admission → first token: TTFT with queueing split out."""
        if self.t_first is None or self.t_first_admit is None:
            return None
        return (self.t_first - self.t_first_admit) * 1e3

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return (self.t_finish - self.arrival_time) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Decode time per token after the first (None with <2 tokens)."""
        if self.t_finish is None or len(self.tokens) < 2:
            return None
        return (self.t_finish - self.t_first) / (len(self.tokens) - 1) * 1e3


class ServeStats:
    """Per-run latency aggregates on a ``MetricsRegistry``: step
    wall-clock plus the per-request TTFT/TPOT/e2e series recorded as
    requests retire, the draft/verify split of each speculation round, and
    the counters behind the prefix hit rate, preemption and the
    acceptance rate. ``serving_summary()`` has the JAX package's schema;
    its ``controller`` section is there only when a controller served."""

    _SERIES = {
        "step_ms": "serve.step_ms",
        "ttft_ms": "serve.ttft_ms",
        "tpot_ms": "serve.tpot_ms",
        "e2e_ms": "serve.e2e_ms",
        "queue_wait_ms": "serve.queue_wait_ms",
        "service_ttft_ms": "serve.service_ttft_ms",
        # speculative-decode per-round latency split (draft vs verify)
        "draft_ms": "serve.draft_ms",
        "verify_ms": "serve.verify_ms",
    }
    _COUNTERS = {
        "prompt_tokens": "serve.prompt_tokens",
        "prefix_hit_tokens": "serve.prefix_hit_tokens",
        "n_prefix_hits": "serve.n_prefix_hits",
        # preemption accounting (priority scheduling under pool pressure)
        "n_preemptions": "serve.preemptions",
        "recomputed_tokens": "serve.recomputed_tokens",
        "rejected_submissions": "serve.rejected_submissions",
        # speculative-decode proposed/accepted behind the acceptance rate
        "spec_k": "serve.spec_k",
        "spec_steps": "serve.spec_steps",
        "spec_proposed": "serve.spec_proposed",
        "spec_accepted": "serve.spec_accepted",
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        for attr, metric in self._SERIES.items():
            setattr(self, attr, self.registry.series(metric))
        self._counters = {
            attr: self.registry.counter(metric)
            for attr, metric in self._COUNTERS.items()
        }
        # the online controller's state, set by the scheduler at each
        # decision; None when no controller ran
        self.controller_info: Optional[dict] = None

    def reset(self) -> None:
        """Start a run from clean series — percentiles never mix runs."""
        self.registry.reset()
        self.controller_info = None

    def record(self, req: Request) -> None:
        """Fold a finished request's latencies into the run series."""
        for attr in ("ttft_ms", "queue_wait_ms", "service_ttft_ms", "tpot_ms", "e2e_ms"):
            v = getattr(req, attr)
            if v is not None:
                getattr(self, attr).append(v)
        self.prompt_tokens += int(np.asarray(req.prompt).shape[0])
        self.prefix_hit_tokens += req.prefix_hit
        self.n_prefix_hits += bool(req.prefix_hit)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the prefix cache."""
        return self.prefix_hit_tokens / self.prompt_tokens if self.prompt_tokens else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verify accepted."""
        return self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0

    def percentile(self, p, series: str = "step_ms") -> float:
        """Linear-interpolated percentile (``numpy.percentile``'s default)."""
        vals = getattr(self, series)
        return quantile(vals, p) if vals else 0.0

    def summary(self) -> str:
        """One line: steps and their p50/p99, and with finished requests
        their count and TTFT p50/p99 (the JAX package's format)."""
        s = (f"steps={len(self.step_ms)} p50={self.percentile(50):.2f}ms "
             f"p99={self.percentile(99):.2f}ms")
        if self.ttft_ms:
            s += (f" | requests={len(self.ttft_ms)}"
                  f" ttft_p50={self.percentile(50, 'ttft_ms'):.2f}ms"
                  f" ttft_p99={self.percentile(99, 'ttft_ms'):.2f}ms")
        return s

    def serving_summary(self) -> dict:
        """Machine-readable serving latencies. A run where zero requests
        finished returns an explicit empty summary (``empty=True``, None
        latencies) rather than 0 ms."""
        out = {
            "n_requests": len(self.ttft_ms),
            "n_steps": len(self.step_ms),
            "empty": not self.ttft_ms,
            "p50_step_ms": self.percentile(50) if self.step_ms else None,
            "p99_step_ms": self.percentile(99) if self.step_ms else None,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": self.prefix_hit_rate,
            "n_prefix_hits": self.n_prefix_hits,
            "preemptions": self.n_preemptions,
            "recomputed_tokens": self.recomputed_tokens,
            "rejected_submissions": self.rejected_submissions,
        }
        per_request = {
            "ttft_ms": "ttft", "queue_wait_ms": "queue_wait",
            "service_ttft_ms": "service_ttft", "tpot_ms": "tpot", "e2e_ms": "e2e",
        }
        for series, name in per_request.items():
            have = bool(self.ttft_ms) and bool(getattr(self, series))
            for p in (50, 99):
                out[f"p{p}_{name}_ms"] = self.percentile(p, series) if have else None
        if self.spec_steps:
            out["speculative"] = {
                "k": self.spec_k,
                "acceptance_rate": self.acceptance_rate,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "spec_steps": self.spec_steps,
                "p50_draft_ms": self.percentile(50, "draft_ms"),
                "p50_verify_ms": self.percentile(50, "verify_ms"),
            }
        if self.controller_info:
            out["controller"] = dict(self.controller_info)
        return out


def _counter_property(attr: str) -> property:
    # int get / set pair over the backing registry Counter, so
    # `stats.prompt_tokens += n` call sites work
    def fget(self):
        return int(self._counters[attr].value)

    def fset(self, v):
        self._counters[attr].set(float(v))

    return property(fget, fset)


for _attr in ServeStats._COUNTERS:
    setattr(ServeStats, _attr, _counter_property(_attr))
del _attr
