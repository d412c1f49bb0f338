"""Aira core: the paper's contribution (the adviser, its tools, Relic's
``relic_pfor``, the plan layer and the profiler), ported to PyTorch. The
profiler counts aten ops (``op_cost``, ``op_analysis``) where the JAX
package's walks compiled HLO (``hlo_cost``, ``hlo_analysis``)."""
from repro_torch.core.adviser import AdviceReport, Aira, Region, RegionDecision, Workload  # noqa: F401
from repro_torch.core.overlap_model import (  # noqa: F401
    CPU_HW,
    H100_HW,
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
from repro_torch.core.profiler import ProfiledStep, RooflineTerms, profile_step  # noqa: F401
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
