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
(``SpeculationAdvisorTool``, ``KernelAdvisorTool`` and their pricing
functions) wait for ROADMAP §1 item 8, with the flight recorder.
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
    armed, else ``(None, 0)``. A ``sys.modules`` lookup, never an import,
    so ``core/`` stays free of any ``serve`` dependency. The port's
    ``serve/telemetry.py`` holds the metrics half only; until ROADMAP §1
    item 8 brings its tracer (``get_telemetry``) this is always
    ``(None, 0)``."""
    mod = sys.modules.get("repro_torch.serve.telemetry")
    get = getattr(mod, "get_telemetry", None)
    if get is None:
        return None, 0
    tel = get()
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


DEFAULT_TOOLS: tuple = (
    ProfileTool(),
    StaticDepsTool(),
    DynamicDepsTool(),
    OverlapSimTool(),
    RelicRestructureTool(),
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
