"""Aira core: the paper's contribution (the adviser, its tools, Relic's
``relic_pfor`` and the plan layer), ported to PyTorch. The JAX package's
``profiler`` (HLO cost analysis) waits for ROADMAP §1 item 11b."""
from repro_torch.core.adviser import AdviceReport, Aira, Region, RegionDecision, Workload  # noqa: F401
from repro_torch.core.overlap_model import (  # noqa: F401
    CPU_HW,
    HwModel,
    Microtask,
    OverlapModel,
    SchedulePrediction,
    gate,
)
from repro_torch.core.plan import (  # noqa: F401
    RegionPlan,
    SuiteEntry,
    advise_suite,
    clear_plan_cache,
    plan_cache_stats,
    plan_for,
    plan_for_region,
)
from repro_torch.core.relic import RelicSchedule, choose_schedule, relic_pfor  # noqa: F401
from repro_torch.core.tools import (  # noqa: F401
    DEFAULT_TOOLS,
    AdviserPolicy,
    AdviserTool,
    RecordingPolicy,
    ReplayPolicy,
    SpecPolicy,
    StageResult,
    ToolContext,
    ToolPipeline,
)
