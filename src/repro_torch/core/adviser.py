"""Aira: the end-to-end parallelization adviser (paper §V).

Port of the JAX package's ``core/adviser.py``. ``Aira.advise(workload)``
executes the specification stages (core/spec.py) over a workload's
annotated regions:

  profile → annotate → static deps → dynamic deps → simulate (gate)
  → restructure with the Relic analogue

The paper drives these stages with a general-purpose LLM through MCP
tools; the tool surface here is the same — five discrete
``AdviserTool``s (core/tools.py) run by a ``ToolPipeline`` whose decision
seat is an ``AdviserPolicy``. The default ``SpecPolicy`` is the spec's
deterministic rules; a recording/replay policy (or an actual LLM) plugs
in without touching the tools.

Accepted regions carry a cached ``RegionPlan`` (core/plan.py): the
schedule plus its executor, reusable across benchmarks, figures and the
serving engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.core import deps as deps_mod
from repro_torch.core.overlap_model import HwModel, OverlapModel
from repro_torch.core.relic import RelicSchedule
from repro_torch.core.spec import AIRA_SPEC, PROMPT
from repro_torch.core.tools import (
    DEFAULT_TOOLS,
    AdviserPolicy,
    SpecPolicy,
    ToolContext,
    ToolPipeline,
)


@dataclass
class Region:
    """An annotated candidate region inside a hotspot function."""

    name: str
    fn: Callable  # per-item function
    items: Any  # pytree of tensors, leading axis = work items
    task_flops: float  # per-item FLOPs (napkin/profile derived)
    task_bytes: float  # per-item bytes moved
    task_chain: int = 0  # dependent accesses per item (tree/list hops)
    vector: bool = True  # pointer-chasing/gather regions are scalar-bound
    trace: Optional[deps_mod.MemoryTrace] = None
    restructure: Optional[Callable] = None  # custom parallel impl
    force: bool = False  # bypass the gate (paper's 1-Hop/BVH case)
    combine: str = "stack"  # how the plan combines per-item results


@dataclass
class Workload:
    name: str
    serial_fn: Callable  # () -> result (the latency-critical step)
    regions: list[Region] = field(default_factory=list)


@dataclass
class RegionDecision:
    region: str
    stage_log: list[str]
    accepted: bool
    schedule: Optional[RelicSchedule]
    predicted_gain: float
    parallel_fn: Optional[Callable] = None
    plan: Optional[Any] = None  # RegionPlan when accepted via the plan layer

    def summary(self) -> str:
        s = "ACCEPT" if self.accepted else "reject"
        sched = self.schedule.describe() if self.schedule else "-"
        return f"[{s}] {self.region:20s} {sched:40s} | " + " ; ".join(self.stage_log)


@dataclass
class AdviceReport:
    workload: str
    decisions: list[RegionDecision]

    @property
    def accepted(self):
        return [d for d in self.decisions if d.accepted]

    def render(self) -> str:
        lines = [f"Aira report — {self.workload!r} (prompt: {PROMPT!r})"]
        lines += [d.summary() for d in self.decisions]
        return "\n".join(lines)


class Aira:
    """The adviser: a tool pipeline plus a policy, per the spec. ``hw``
    defaults to ``HwModel()``, the paper's i7-12700 core."""

    def __init__(
        self,
        hw: HwModel | None = None,
        gate_threshold: float = 0.02,
        policy: AdviserPolicy | None = None,
        tools=DEFAULT_TOOLS,
    ):
        self.hw = hw or HwModel()
        self.model = OverlapModel(self.hw)
        self.gate_threshold = gate_threshold
        self.spec = AIRA_SPEC
        self.pipeline = ToolPipeline(tools=tools, policy=policy or SpecPolicy())

    # ------------------------------------------------------------------
    def advise(self, workload: Workload) -> AdviceReport:
        decisions = [self._advise_region(r) for r in workload.regions]
        return AdviceReport(workload=workload.name, decisions=decisions)

    def _advise_region(self, region: Region) -> RegionDecision:
        ctx = ToolContext(
            hw=self.hw, model=self.model, gate_threshold=self.gate_threshold
        )
        return self.pipeline.run(region, ctx)
