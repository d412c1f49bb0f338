"""The Aira tool surface: discrete adviser tools + the pipeline executor.

Port of the JAX package's ``core/tools.py`` (its compute-region half).
The paper's agent drives five MCP tools — profiler, static dependence
(BOLT), dynamic dependence (DynamoRIO), SMT-aware simulator (Sniper),
and the Relic restructurer — and an LLM decides, stage by stage, whether
to continue:

* ``AdviserTool``   — uniform tool interface: ``run(region, ctx) ->
                      StageResult``. Tools never reject; they report.
* ``ToolPipeline``  — the executor. Owns the stage log, early reject,
                      and the ``force=`` override.
* ``AdviserPolicy`` — the decision seat. ``SpecPolicy`` implements the
                      deterministic spec rules (core/spec.py);
                      ``RecordingPolicy``/``ReplayPolicy`` capture and
                      replay decision streams for tests, and are the
                      seam where an actual LLM policy would plug in.

The pipeline produces ``RegionDecision``s; accepted regions carry a
cached ``RegionPlan`` (core/plan.py). The serving-layer tools
(``SpeculationAdvisorTool``, ``KernelAdvisorTool``) ride in
``DEFAULT_TOOLS`` but report only for regions that carry a serving
measurement; their pricing functions (``price_speculation``,
``price_backends``) are shared with the online controller
(``serve/controller.py``).
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable

from torch.utils import _pytree as pytree

from repro_torch.core import deps as deps_mod
from repro_torch.core.overlap_model import HwModel, Microtask, OverlapModel, gate
from repro_torch.core.relic import RelicSchedule, choose_schedule


def _flight():
    """``(telemetry, adviser_tid)`` when the serving flight recorder is
    armed, else ``(None, 0)``. A ``sys.modules`` lookup, never an import:
    arming the recorder imports its module, so an absent module means the
    recorder is off, and ``core/`` stays free of any ``serve`` dependency."""
    mod = sys.modules.get("repro_torch.serve.telemetry")
    if mod is None:
        return None, 0
    tel = mod.get_telemetry()
    if not tel.enabled:
        return None, 0
    return tel, mod.TID_ADVISER


# stage verdicts a tool can report
PASS = "pass"
REJECT = "reject"
SKIP = "skip"

# actions a policy can take on a verdict
CONTINUE = "continue"
STOP = "stop"


@dataclass
class StageResult:
    """One tool invocation's report: a verdict plus a log line.

    ``payload`` carries tool-specific artifacts (the static report, the
    chosen schedule, …) for later stages via ``ToolContext.artifacts``.
    """

    stage: str
    verdict: str  # PASS | REJECT | SKIP
    log: Optional[str] = None  # None → no stage-log line
    payload: Any = None


@dataclass
class ToolContext:
    """Cross-stage state for one region's advisory run."""

    hw: HwModel
    model: OverlapModel
    gate_threshold: float = 0.02
    n_items: int = 0
    artifacts: dict = field(default_factory=dict)


@runtime_checkable
class AdviserTool(Protocol):
    """One MCP-analogue tool. ``name`` doubles as the stage-log prefix."""

    name: str

    def run(self, region, ctx: ToolContext) -> StageResult: ...


# ---------------------------------------------------------------------------
# the five tools


class ProfileTool:
    """perf+LBR analogue: package the region's napkin/profile-derived
    per-item cost as a Microtask for the simulator."""

    name = "profile"

    def run(self, region, ctx: ToolContext) -> StageResult:
        task = Microtask(
            flops=region.task_flops,
            bytes=region.task_bytes,
            chain=region.task_chain,
            vector=region.vector,
        )
        ctx.artifacts["microtask"] = task
        unit = "VPU" if region.vector else "MXU"
        log = (
            f"{ctx.n_items} items × ({region.task_flops:.0f} flop, "
            f"{region.task_bytes:.0f} B, chain={region.task_chain}) [{unit}]"
        )
        return StageResult(self.name, PASS, log, payload=task)


class StaticDepsTool:
    """BOLT analogue: aten-graph def-use walk over one sample item."""

    name = "static"

    def run(self, region, ctx: ToolContext) -> StageResult:
        sample = pytree.tree_map(lambda a: a[0], region.items)
        srep = deps_mod.static_deps(region.fn, sample)
        ctx.artifacts["static"] = srep
        return StageResult(self.name, PASS, srep.summary(), payload=srep)


class DynamicDepsTool:
    """DynamoRIO analogue: replay the recorded access trace under the
    proposed partition; without a trace, a non-trivially-parallel region
    (shared writes in the static report) cannot be cleared."""

    name = "dynamic"

    def run(self, region, ctx: ToolContext) -> StageResult:
        if region.trace is not None:
            conflict, why = deps_mod.check_conflicts(region.trace, n_tasks=2)
            return StageResult(self.name, REJECT if conflict else PASS, why)
        srep = ctx.artifacts.get("static")
        if srep is not None and not srep.trivially_parallel:
            return StageResult(
                self.name, REJECT, "no trace supplied for non-trivial region → reject"
            )
        return StageResult(self.name, SKIP)  # trivially parallel: no trace needed


class OverlapSimTool:
    """Sniper analogue: price serial vs smt2 vs smp2 over the granularity
    sweep and apply the profitability gate."""

    name = "simulate"

    def run(self, region, ctx: ToolContext) -> StageResult:
        task = ctx.artifacts["microtask"]
        schedule = choose_schedule(
            ctx.model,
            task.flops,
            task.bytes,
            ctx.n_items,
            chain=task.chain,
            vector=task.vector,
        )
        pred = schedule.prediction
        ok, why = gate(pred, ctx.gate_threshold)
        ctx.artifacts["schedule"] = schedule
        ctx.artifacts["prediction"] = pred
        log = (
            f"{why} (serial {pred.serial*1e6:.1f}µs, "
            f"smt2 {pred.smt2*1e6:.1f}µs, smp2 {pred.smp2*1e6:.1f}µs)"
        )
        verdict = PASS if (ok and schedule.strategy != "serial") else REJECT
        return StageResult(self.name, verdict, log, payload=schedule)


class RelicRestructureTool:
    """Relic analogue: rewrite the accepted region onto the Relic API at
    the simulator's granularity, through the cached plan layer."""

    name = "restructure"

    def run(self, region, ctx: ToolContext) -> StageResult:
        from repro_torch.core.plan import plan_for_region  # avoid import cycle

        schedule = ctx.artifacts.get("schedule")
        pred = ctx.artifacts.get("prediction")
        if region.force and schedule is not None and schedule.strategy == "serial":
            # gate bypassed on a serial-best region: impose the paper's
            # forced smt2 schedule (1-Hop/BVH scenario)
            schedule = RelicSchedule(
                granularity=max(1, ctx.n_items // 2),
                n_streams=2,
                strategy="smt2",
                prediction=pred,
            )
            ctx.artifacts["schedule"] = schedule

        if region.restructure is not None:
            ctx.artifacts["parallel_fn"] = region.restructure
            return StageResult(self.name, PASS, "custom Relic implementation")

        plan = plan_for_region(region, schedule, ctx.hw)
        ctx.artifacts["plan"] = plan
        ctx.artifacts["parallel_fn"] = plan.thunk(region.items)
        return StageResult(
            self.name,
            PASS,
            f"relic_pfor(gran={schedule.granularity}) [plan {plan.cache_state}]",
        )


# ---------------------------------------------------------------------------
# serving-layer speculation advice (the OverlapSimTool analogue one
# level up: price a helper stream before committing to it)


@dataclass
class SpecMeasurement:
    """Measured speculative-serving profile — what the advisory gate
    prices, as ``ProfileTool`` packages a region's cost as a Microtask.

    ``draft_ms_per_token`` is the draft stream's marginal cost;
    ``verify_ms`` maps speculation depth K to one verify-step
    wall-clock (K=0 being the plain decode step); ``acceptance_rate``
    is the measured per-draft-token greedy acceptance probability."""

    draft_ms_per_token: float
    verify_ms: dict
    acceptance_rate: float

    def verify_cost(self, k: int) -> float:
        """Verify-step cost at depth ``k``, linearly interpolated (and
        clamped) between the measured depths."""
        ks = sorted(self.verify_ms)
        if k in self.verify_ms:
            return float(self.verify_ms[k])
        lo = max((x for x in ks if x < k), default=ks[0])
        hi = min((x for x in ks if x > k), default=ks[-1])
        if hi == lo:
            return float(self.verify_ms[lo])
        w = (k - lo) / (hi - lo)
        return float((1 - w) * self.verify_ms[lo] + w * self.verify_ms[hi])


def expected_tokens_per_round(p: float, k: int) -> float:
    """E[tokens committed per verify round] at depth ``k`` under i.i.d.
    per-token acceptance probability ``p``: 1 + p + p² + … + p^k (the
    round always commits at least the corrected token)."""
    return float(sum(p**i for i in range(k + 1)))


def price_speculation(m: SpecMeasurement, ks, threshold: float = 0.02):
    """The speculation pricing analytic, as a pure function: expected
    per-output-token latency at each candidate depth in ``ks`` from a
    measured (or live-estimated) draft cost, verify cost, and
    acceptance rate, gated on ``threshold`` predicted gain.

    Shared verbatim by the offline gate (``SpeculationAdvisorTool``,
    whose golden decisions pin these numbers) and the online controller
    (``serve.controller.OnlineAdviser``, which substitutes windowed
    live estimates for the offline probe). Returns ``(best_k,
    best_cost_ms_per_token, gain_vs_k0, costs)`` where ``costs`` maps
    every priced depth (including 0) to its expected ms/output-token.
    """
    base = m.verify_cost(0)
    costs = {0: base}
    best_k, best_cost = 0, base
    for k in ks:
        if k <= 0:
            continue
        cost = (k * m.draft_ms_per_token + m.verify_cost(k)) / (
            expected_tokens_per_round(m.acceptance_rate, k)
        )
        costs[int(k)] = cost
        if cost < best_cost:
            best_k, best_cost = k, cost
    gain = (base / best_cost - 1.0) if best_cost > 0 else 0.0
    if gain <= threshold:
        best_k, best_cost, gain = 0, base, 0.0
    return best_k, best_cost, gain, costs


def price_backends(step_ms: dict, threshold: float = 0.02, baseline: str = "reference"):
    """The backend pricing analytic, as a pure function: pick the
    cheapest measured backend, committing away from ``baseline`` only
    when the predicted gain clears ``threshold`` — the same
    commit-only-on-predicted-win rule as ``price_speculation``.

    Shared verbatim by the offline gate (``KernelAdvisorTool``, whose
    baseline is always ``"reference"``) and the online controller
    (whose baseline is the *currently serving* backend, so hysteresis
    is priced against the status quo). Returns ``(best_backend,
    best_ms, gain_vs_baseline)``."""
    base = float(step_ms[baseline])
    best, best_ms = baseline, base
    for backend, ms in sorted(step_ms.items()):
        if backend != baseline and float(ms) < best_ms:
            best, best_ms = backend, float(ms)
    gain = (base / best_ms - 1.0) if best_ms > 0 else 0.0
    if gain <= threshold:
        best, best_ms, gain = baseline, base, 0.0
    return best, best_ms, gain


class SpeculationAdvisorTool:
    """Sniper-gate analogue for speculative serving: price expected
    per-output-token latency at each candidate depth from a measured
    draft cost + acceptance rate, and pick K ∈ ``ks`` — K=0 (don't
    speculate) unless the predicted gain clears the threshold, the same
    commit-only-on-predicted-win rule as ``OverlapSimTool``.

    As a pipeline stage it reports only for regions carrying a
    ``spec_measurement`` (compute regions silently SKIP, so the
    advisory stage log — and the golden decisions — are unchanged for
    non-serving workloads); ``serve/speculative.advise_depth`` is the
    measuring front end and ``engine.serve(spec=...)`` honors the
    decision."""

    name = "speculate"

    def __init__(self, ks=(0, 2, 4, 8)):
        self.ks = tuple(ks)

    def choose(self, m: SpecMeasurement, threshold: float = 0.02):
        """(chosen K, predicted gain, log line) for measurement ``m``."""
        best_k, best_cost, gain, _costs = price_speculation(m, self.ks, threshold)
        base = m.verify_cost(0)
        log = (
            f"accept={m.acceptance_rate:.2f} "
            f"draft={m.draft_ms_per_token:.3f}ms/tok "
            f"base={base:.2f}ms/tok → K={best_k} "
            f"({best_cost:.2f}ms/tok, {gain:+.1%})"
        )
        tel, tid = _flight()
        if tel is not None:
            # audit trail: the decision WITH its priced inputs, so an
            # exported trace shows why this K was chosen
            tel.count("adviser.decisions")
            tel.tracer.instant(
                "speculation-decision", "adviser", tid=tid,
                args={
                    "k": best_k,
                    "gain": round(gain, 4),
                    "acceptance_rate": round(m.acceptance_rate, 4),
                    "draft_ms_per_token": round(m.draft_ms_per_token, 4),
                    "base_ms_per_token": round(base, 4),
                    "chosen_ms_per_token": round(best_cost, 4),
                    "candidates": list(self.ks),
                },
            )
        return best_k, gain, log

    def run(self, region, ctx: ToolContext) -> StageResult:
        m = ctx.artifacts.get(
            "spec_measurement", getattr(region, "spec_measurement", None)
        )
        if m is None:
            return StageResult(self.name, SKIP)
        k, gain, log = self.choose(m, ctx.gate_threshold)
        ctx.artifacts["spec_k"] = k
        return StageResult(self.name, PASS, log, payload=k)


@dataclass(frozen=True)
class KernelMeasurement:
    """Measured attention-step cost for one serving cell — what the
    kernel-backend gate prices, as ``SpecMeasurement`` is to the
    speculation gate.

    ``family``/``layout``/``k`` name the cell (model family, KV layout
    ``"slot" | "paged"``, speculation depth with 0 = plain decode);
    ``step_ms`` maps backend name → measured per-step wall-clock for
    that cell. A ``"reference"`` entry is required — it is the baseline
    the predicted gain is quoted against."""

    family: str
    layout: str
    k: int
    step_ms: tuple  # ((backend, ms), ...) — hashable, dict-constructed

    @staticmethod
    def make(family: str, layout: str, k: int, step_ms: dict) -> "KernelMeasurement":
        if "reference" not in step_ms:
            raise ValueError("KernelMeasurement needs a 'reference' baseline timing")
        return KernelMeasurement(family, layout, int(k), tuple(sorted(step_ms.items())))

    @property
    def timings(self) -> dict:
        return dict(self.step_ms)


class KernelAdvisorTool:
    """Backend gate for the decode/verify attention step: pick the
    attention backend per (family, layout, K) cell from *measured*
    per-step cost, the same commit-only-on-predicted-win rule as
    ``OverlapSimTool`` — ``"reference"`` (don't switch) unless a kernel
    backend's measured gain clears the threshold. Measured, not
    assumed: the CUDA kernel has to *show* its savings over the plain
    PyTorch version on the card to be chosen.

    As a pipeline stage it reports only for regions carrying a
    ``kernel_measurement`` (compute regions silently SKIP, so the
    advisory stage log — and the golden decisions — are unchanged);
    ``ServingEngine.prime`` measures the cells and
    ``engine.serve(attention_backend=...)`` honors the decision."""

    name = "kernel"

    def choose(self, m: KernelMeasurement, threshold: float = 0.02):
        """(chosen backend, predicted gain, log line) for cell ``m``."""
        t = m.timings
        best, best_ms, gain = price_backends(t, threshold, baseline="reference")
        timings = " ".join(f"{b}={float(ms):.2f}ms" for b, ms in sorted(t.items()))
        log = (
            f"{m.family}/{m.layout}/K={m.k}: {timings} → {best} "
            f"({best_ms:.2f}ms/step, {gain:+.1%})"
        )
        tel, tid = _flight()
        if tel is not None:
            tel.count("adviser.decisions")
            tel.tracer.instant(
                "kernel-backend-decision", "adviser", tid=tid,
                args={
                    "backend": best,
                    "gain": round(gain, 4),
                    "cell": f"{m.family}/{m.layout}/K={m.k}",
                    "step_ms": {b: round(float(ms), 4) for b, ms in sorted(t.items())},
                },
            )
        return best, gain, log

    def run(self, region, ctx: ToolContext) -> StageResult:
        m = ctx.artifacts.get(
            "kernel_measurement", getattr(region, "kernel_measurement", None)
        )
        if m is None:
            return StageResult(self.name, SKIP)
        backend, gain, log = self.choose(m, ctx.gate_threshold)
        ctx.artifacts["attention_backend"] = backend
        return StageResult(self.name, PASS, log, payload=backend)


DEFAULT_TOOLS: tuple = (
    ProfileTool(),
    StaticDepsTool(),
    DynamicDepsTool(),
    OverlapSimTool(),
    RelicRestructureTool(),
    SpeculationAdvisorTool(),
    KernelAdvisorTool(),
)


# ---------------------------------------------------------------------------
# policies


@runtime_checkable
class AdviserPolicy(Protocol):
    """The decision seat between stages: maps a StageResult to CONTINUE
    or STOP. The paper puts an LLM here; SpecPolicy puts the spec's
    deterministic rules here."""

    def decide(self, result: StageResult, region, ctx: ToolContext) -> str: ...


class SpecPolicy:
    """Deterministic spec rules: stop on any tool reject."""

    def decide(self, result: StageResult, region, ctx: ToolContext) -> str:
        return STOP if result.verdict == REJECT else CONTINUE


@dataclass
class RecordingPolicy:
    """Wraps a policy and records every (region, stage, verdict, action)
    so a decision stream can be replayed (or asserted on) in tests."""

    inner: AdviserPolicy
    record: list = field(default_factory=list)

    def decide(self, result: StageResult, region, ctx: ToolContext) -> str:
        action = self.inner.decide(result, region, ctx)
        self.record.append((region.name, result.stage, result.verdict, action))
        return action


@dataclass
class ReplayPolicy:
    """Replays a RecordingPolicy's decision stream verbatim, ignoring
    tool verdicts — deterministic adviser behaviour in tests without
    re-running the underlying analyses."""

    record: list
    _pos: int = 0

    def decide(self, result: StageResult, region, ctx: ToolContext) -> str:
        if self._pos >= len(self.record):
            raise IndexError("ReplayPolicy: decision stream exhausted")
        name, stage, _verdict, action = self.record[self._pos]
        if (name, stage) != (region.name, result.stage):
            raise ValueError(
                f"ReplayPolicy: recorded ({name}, {stage}) but pipeline is at "
                f"({region.name}, {result.stage})"
            )
        self._pos += 1
        return action


# ---------------------------------------------------------------------------
# the executor


class ToolPipeline:
    """Runs the tool sequence over one region.

    Owns three behaviours: the stage log (one ``"stage: …"`` line per tool
    report), early reject (a STOP from the policy ends the run), and the
    ``force=`` override (a forced region logs the bypass and keeps going —
    the paper's 1-Hop/BVH scenario).
    """

    def __init__(self, tools=DEFAULT_TOOLS, policy: AdviserPolicy | None = None):
        self.tools = tuple(tools)
        self.policy = policy or SpecPolicy()

    def run(self, region, ctx: ToolContext):
        from repro_torch.core.adviser import RegionDecision  # one-way at runtime

        log: list[str] = []
        ctx.n_items = pytree.tree_leaves(region.items)[0].shape[0]
        tel, tid = _flight()

        for tool in self.tools:
            t0 = time.perf_counter() if tel is not None else 0.0
            result = tool.run(region, ctx)
            if tel is not None and result.verdict != SKIP:
                tr = tel.tracer
                a = tr.to_us(t0)
                args = {"region": region.name, "verdict": result.verdict}
                if result.log:
                    args["log"] = result.log
                tr.complete(
                    f"tool:{result.stage}", "adviser", a, tr.now_us() - a,
                    tid=tid, args=args,
                )
            if result.log:
                log.append(f"{result.stage}: {result.log}")
            action = self.policy.decide(result, region, ctx)
            if action == STOP:
                if region.force:
                    log.append(
                        f"force=True: {result.stage} reject bypassed "
                        "(paper's 1-Hop/BVH scenario)"
                    )
                    continue
                schedule = ctx.artifacts.get("schedule")
                pred = ctx.artifacts.get("prediction")
                return RegionDecision(
                    region=region.name,
                    stage_log=log,
                    accepted=False,
                    schedule=schedule,
                    predicted_gain=pred.gain("smt2") if pred is not None else 0.0,
                    parallel_fn=None,
                    plan=None,
                )

        schedule = ctx.artifacts["schedule"]
        pred = ctx.artifacts["prediction"]
        return RegionDecision(
            region=region.name,
            stage_log=log,
            accepted=True,
            schedule=schedule,
            predicted_gain=pred.gain(schedule.strategy),
            parallel_fn=ctx.artifacts["parallel_fn"],
            plan=ctx.artifacts.get("plan"),
        )
