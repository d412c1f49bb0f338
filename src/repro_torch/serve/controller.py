"""Online adaptive adviser: the offline pricing gates, closed into a
live control loop.

Port of the JAX package's ``serve/controller.py``. The paper's adviser
prices alternatives with connected tools and commits only on a predicted
win; ``SpeculationAdvisorTool`` and ``KernelAdvisorTool`` are that as
one-shot offline gates over measured costs. ``OnlineAdviser`` is the same
price-then-decide loop run *during* serving: every ``decision_interval``
scheduler steps it reads the windowed sensor vector
(``MetricsRegistry.window_summary(n)`` — observed acceptance rate p̂,
measured draft/verify/step costs, pool pressure), substitutes those live
estimates for the offline measurements, re-runs the *same* pure pricing
(``core.tools.price_speculation`` / ``price_backends``), and emits a
``Decision(k, backend, admit_budget)`` for the scheduler to apply.

Applying a decision moves no state: K is the width of the next verify
(``[max_batch, K+1]`` tokens through the same step functions, the paged
kernel's plan independent of it) and a backend is a name each step
passes to the attention layer, so ``engine.prime()`` measures the
K × backend grid the controller prices and every mid-serve switch runs
shapes it has run before. The only stateful transition is a drafter with
its own KV cache re-syncing on a 0→K switch (``Scheduler._set_live_k``
re-runs ``on_admit`` over the active rows).

Stability comes from hysteresis, not from trusting any one window:

* **dwell** — after a switch, the controller holds the new arm for
  ``dwell`` further decisions before it may switch again;
* **improvement threshold** — a switch must be priced at better than
  ``threshold`` relative gain *versus the currently serving arm* (the
  online baseline is the status quo, where the offline gate's baseline
  is K=0 / "reference");
* **probing** — at K=0 the acceptance rate is unobservable (nothing is
  proposed), so after ``probe_every`` consecutive decisions without a
  speculation observation the controller runs the smallest positive K
  for one interval to refresh p̂; a probe is not a committed switch and
  does not reset the dwell clock.

Every decision — applied or held — is appended to ``self.decisions``
and recorded by the scheduler on the telemetry adviser lane with its
priced inputs, the paper's audit trail, live.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.tools import SpecMeasurement, price_backends, price_speculation

__all__ = ["Decision", "OnlineAdviser", "PinnedController"]


@dataclass
class Decision:
    """One controller verdict: the arm to serve with until the next
    decision, plus the audit-trail fields the telemetry lane records."""

    step: int  # scheduler step the decision was made on
    k: int  # speculation depth to serve with (0 = plain decode)
    backend: str  # attention backend to serve with
    admit_budget: Optional[int] = None  # max admissions/step (None = unlimited)
    switched: bool = False  # did this decision change the committed arm?
    probe: bool = False  # temporary K>0 excursion to refresh p̂, not a commit
    predicted_gain: float = 0.0  # priced relative gain of the chosen arm
    reason: str = ""  # human-readable why
    inputs: dict = field(default_factory=dict)  # the priced sensor values

    def to_json(self) -> dict:
        return {
            "step": self.step,
            "k": self.k,
            "backend": self.backend,
            "admit_budget": self.admit_budget,
            "switched": self.switched,
            "probe": self.probe,
            "predicted_gain": round(float(self.predicted_gain), 4),
            "reason": self.reason,
            "inputs": {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.inputs.items()
            },
        }


class PinnedController:
    """A controller that always answers the same arm — the degenerate
    closed loop used by the token-identity contract (a pinned
    controller must serve bitwise-identically to the static
    configuration) and as the minimal duck-type reference: a controller
    needs only ``ks``, ``decision_interval``, ``window``, ``backends``,
    ``initial_k``, ``decisions``, ``n_switches``, ``dwell_remaining``,
    and ``decide()``."""

    def __init__(self, k: int, backend: Optional[str] = None,
                 admit_budget: Optional[int] = None, decision_interval: int = 4,
                 window: int = 16):
        self.ks = (0, int(k)) if k else (0,)
        self.backends = (backend,) if backend else None
        self.decision_interval = int(decision_interval)
        self.window = int(window)
        self.initial_k = int(k)
        self.admit_budget = admit_budget
        self.decisions: list[Decision] = []
        self.n_switches = 0
        self.dwell_remaining = 0

    def decide(self, summary: dict, *, k_live: int, backend_live: str,
               step: int) -> Decision:
        d = Decision(
            step=step, k=self.initial_k, backend=backend_live,
            admit_budget=self.admit_budget, reason="pinned",
            inputs={"acceptance_rate": summary.get("acceptance_rate", 0.0)},
        )
        self.decisions.append(d)
        return d


class OnlineAdviser:
    """Closed-loop K / backend / admission controller (module doc).

    Parameters
    ----------
    ks : candidate speculation depths (must include 0; the scheduler's
        ``SpecConfig.k`` must cover ``max(ks)`` so the admission margin
        and drafter are sized for the deepest arm).
    backends : candidate attention backends; ``None`` means "only the
        scheduler's current backend" (no backend arm).  Names are
        resolved against the ops registry by the scheduler (the port's
        are ``"reference"`` and ``"kernel"``).
    decision_interval : scheduler steps between decisions.
    window : ``window_summary(n)`` width the sensors are read over.
    dwell : decisions the controller must hold an arm after a switch.
    threshold : minimum priced relative gain vs the live arm to switch.
    probe_every : consecutive decisions without a speculation
        observation before a K=0 controller probes the smallest
        positive K for one interval (0 disables probing).
    ewma : smoothing factor for the live estimates (1.0 = trust the
        latest window entirely).
    occupancy_high / throttle_budget : when the window saw preemptions
        and mean pool occupancy is above ``occupancy_high``, the
        decision carries ``admit_budget=throttle_budget`` (admissions
        per step) to shed admission pressure; otherwise unlimited.
    initial_k : arm the scheduler starts serving with (before the first
        decision).  Defaults to 0 — start plain, let pricing raise it.
    """

    def __init__(
        self,
        *,
        ks=(0, 2, 4, 8),
        backends=None,
        decision_interval: int = 8,
        window: int = 16,
        dwell: int = 2,
        threshold: float = 0.05,
        probe_every: int = 3,
        ewma: float = 0.5,
        occupancy_high: float = 0.9,
        throttle_budget: int = 1,
        initial_k: int = 0,
    ):
        self.ks = tuple(sorted({int(k) for k in ks} | {0}))
        if any(k < 0 for k in self.ks):
            raise ValueError(f"candidate depths must be >= 0, got {ks}")
        self.backends = tuple(backends) if backends else None
        self.decision_interval = int(decision_interval)
        self.window = int(window)
        self.dwell = int(dwell)
        self.threshold = float(threshold)
        self.probe_every = int(probe_every)
        self.ewma = float(ewma)
        self.occupancy_high = float(occupancy_high)
        self.throttle_budget = int(throttle_budget)
        self.initial_k = int(initial_k)
        if self.initial_k not in self.ks:
            raise ValueError(f"initial_k={initial_k} not in ks={self.ks}")
        self.probe_k = min((k for k in self.ks if k > 0), default=0)
        self._committed_k = self.initial_k  # last non-probe depth
        # live estimates (None = no observation yet)
        self._cells: dict[tuple[str, int], float] = {}  # (backend, k) → ms/step
        self._draft: Optional[float] = None  # ms per drafted token
        self._p: Optional[float] = None  # EWMA acceptance rate p̂
        self._stale = 0  # decisions since the last speculation observation
        self.dwell_remaining = 0
        self.decisions: list[Decision] = []
        self.n_switches = 0

    # -- seeding -------------------------------------------------------
    def seed_costs(self, cells, draft_ms_per_token: Optional[float] = None) -> None:
        """Prime the cost cells from ``engine.prime()``'s measured
        K × backend grid (accepts the prime() result dict or a raw
        ``{backend: {k: ms}}`` mapping), so the very first decision
        prices real numbers instead of flying blind."""
        if isinstance(cells, dict) and "cells" in cells:
            cells = cells["cells"]
        for backend, by_k in cells.items():
            for k, ms in by_k.items():
                self._cells[(str(backend), int(k))] = float(ms)
        if draft_ms_per_token is not None:
            self._draft = float(draft_ms_per_token)

    # -- sensing -------------------------------------------------------
    def _ewma_in(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1.0 - self.ewma) * old + self.ewma * new

    def _observe(self, summary: dict, k_live: int, backend_live: str) -> None:
        proposed = summary.get("proposed", 0.0)
        if proposed > 0:
            self._stale = 0
            self._p = self._ewma_in(self._p, float(summary["acceptance_rate"]))
            if k_live > 0:
                draft = summary.get("p50_draft_ms", 0.0)
                if draft > 0:
                    self._draft = self._ewma_in(self._draft, draft / k_live)
                verify = summary.get("p50_verify_ms", 0.0)
                if verify > 0:
                    key = (backend_live, k_live)
                    self._cells[key] = self._ewma_in(self._cells.get(key), verify)
        else:
            self._stale += 1
            # plain decode: the step cost IS the K=0 cell for this backend
            step = summary.get("step_cost_ms", 0.0)
            if k_live == 0 and step > 0:
                key = (backend_live, 0)
                self._cells[key] = self._ewma_in(self._cells.get(key), step)

    def _verify_cells(self, backend: str) -> dict[int, float]:
        return {
            k: ms for (b, k), ms in self._cells.items()
            if b == backend and (k == 0 or k in self.ks)
        }

    # -- deciding ------------------------------------------------------
    def decide(self, summary: dict, *, k_live: int, backend_live: str,
               step: int) -> Decision:
        """Price the candidate arms against the live window estimates
        and return the arm to serve with (possibly unchanged).  Always
        returns a Decision — held decisions are part of the audit trail."""
        self._observe(summary, k_live, backend_live)
        dwell_ok = self.dwell_remaining <= 0
        if self.dwell_remaining > 0:
            self.dwell_remaining -= 1
        new_k, new_backend, probe = k_live, backend_live, False
        gain, reasons = 0.0, []

        # speculation arm — the SpeculationAdvisorTool pricing with live
        # estimates, gained against the *currently serving* depth
        cells = self._verify_cells(backend_live)
        spec_ks = [k for k in self.ks if k > 0]
        if spec_ks and 0 in cells:
            m = SpecMeasurement(
                draft_ms_per_token=self._draft if self._draft is not None else 0.0,
                verify_ms=cells,
                acceptance_rate=self._p if self._p is not None else 0.0,
            )
            k_target, _cost, _g0, costs = price_speculation(m, self.ks, threshold=0.0)
            # hysteresis baseline: the committed arm, not a transient
            # probe — a probe must clear the gain gate to stick
            ref = self._committed_k
            cur = costs.get(ref, m.verify_cost(ref))
            tgt = costs[k_target]
            k_gain = (cur / tgt - 1.0) if tgt > 0 else 0.0
            observed = self._p is not None and self._stale < max(1, self.probe_every)
            if k_target != ref and dwell_ok and k_gain > self.threshold and (
                observed or k_target == 0
            ):
                new_k, gain = k_target, k_gain
                reasons.append(f"k {ref}→{k_target} ({k_gain:+.1%})")
            elif k_live != ref:
                # probe interval over without a priced win: revert
                new_k = ref
                reasons.append(f"probe over, k→{ref}")
        if (
            new_k == k_live
            and k_live == 0
            and self.probe_k > 0
            and self.probe_every > 0
            and (self._p is None or self._stale >= self.probe_every)
        ):
            # acceptance is unobservable at K=0: run the smallest
            # positive depth for one interval to refresh p̂
            new_k, probe = self.probe_k, True
            reasons.append(f"probe k={self.probe_k} (p̂ stale)")

        # backend arm — KernelAdvisorTool pricing over this depth's
        # measured cells, baselined on the live backend
        if self.backends and len(self.backends) > 1 and not probe and dwell_ok:
            by_backend = {
                b: self._cells[(b, new_k)]
                for b in self.backends
                if (b, new_k) in self._cells
            }
            if backend_live in by_backend and len(by_backend) > 1:
                b_target, _ms, b_gain = price_backends(
                    by_backend, self.threshold, baseline=backend_live
                )
                if b_target != backend_live:
                    new_backend = b_target
                    gain = max(gain, b_gain)
                    reasons.append(
                        f"backend {backend_live}→{b_target} ({b_gain:+.1%})"
                    )

        # a probe is an excursion, not a commit: switches are counted
        # against the last *committed* depth, so a probe that pricing
        # confirms (the arm stays at probe_k) still registers as one
        switched = not probe and (
            new_k != self._committed_k or new_backend != backend_live
        )
        if not probe:
            self._committed_k = new_k
        if switched:
            self.dwell_remaining = self.dwell
            self.n_switches += 1

        d = Decision(
            step=step,
            k=new_k,
            backend=new_backend,
            admit_budget=self._admission(summary),
            switched=switched,
            probe=probe,
            predicted_gain=float(gain),
            reason="; ".join(reasons) or "hold",
            inputs={
                "acceptance_rate": float(summary.get("acceptance_rate", 0.0)),
                "p_hat": float(self._p) if self._p is not None else None,
                "draft_ms_per_token": (
                    float(self._draft) if self._draft is not None else None
                ),
                "step_cost_ms": float(summary.get("step_cost_ms", 0.0)),
                "pool_occupancy": float(summary.get("pool_occupancy", 0.0)),
                "queue_depth": float(summary.get("queue_depth", 0.0)),
                "preemptions": float(summary.get("preemptions", 0.0)),
                "window": summary.get("window", 0),
            },
        )
        self.decisions.append(d)
        return d

    def _admission(self, summary: dict) -> Optional[int]:
        if (
            summary.get("preemptions", 0.0) > 0
            and summary.get("pool_occupancy", 0.0) >= self.occupancy_high
        ):
            return max(1, self.throttle_budget)
        return None

    # -- exposition ----------------------------------------------------
    def audit_trail(self) -> list[dict]:
        """The full decision history, JSON-ready (the schema of the
        entries of the repo's ``drift_decisions.json``)."""
        return [d.to_json() for d in self.decisions]

    def summary(self) -> dict[str, Any]:
        last = self.decisions[-1] if self.decisions else None
        return {
            "decisions": len(self.decisions),
            "switches": self.n_switches,
            "probes": sum(d.probe for d in self.decisions),
            "k": last.k if last else self.initial_k,
            "backend": last.backend if last else None,
            "dwell_remaining": self.dwell_remaining,
            "p_hat": self._p,
            "draft_ms_per_token": self._draft,
        }
