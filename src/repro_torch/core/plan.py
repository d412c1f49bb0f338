"""The execution-plan layer: cached, reusable results of an advisory run.

Port of the JAX package's ``core/plan.py``. ``RegionPlan`` makes the
accepted schedule and its executor a first-class, cached artifact:

* Plans are cached by ``PlanKey`` = (region signature, granularity,
  n_streams, combine, HwModel). The region signature is the region's
  *name* plus the item pytree's (shape, dtype) structure — the paper's
  region→source mapping — so re-advising the same region returns the
  same plan object.
* ``advise_suite()`` batch-advises every registered benchmark through
  the tool pipeline and returns per-benchmark plans; the serving engine
  accepts a plan for its decode step the same way.

PyTorch runs eagerly, so a plan compiles nothing: it holds its executor,
``relic_pfor`` over the plan's per-item function at its granularity.

Caveat that follows from keying on the signature rather than on the
function object: keys include a head/tail content fingerprint of the
items, but two *different* programs advised under one region name,
item signature, and identical item boundary values still collide. Use
distinct region names (as the paper's region→source mapping does) or
``clear_plan_cache()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.overlap_model import HwModel
from repro_torch.core.relic import RelicSchedule, relic_pfor


@dataclass(frozen=True)
class PlanKey:
    region: str
    items_sig: tuple  # (treespec repr, ((shape, dtype), ...))
    granularity: int
    n_streams: int
    combine: str
    hw: HwModel


def items_signature(items) -> tuple:
    """Structural signature of a region's work items: treespec + per-leaf
    (shape, dtype). Two item pytrees with equal signatures run the same
    program under the region's fn."""
    leaves, spec = pytree.tree_flatten(items)
    return (
        str(spec),
        tuple((tuple(l.shape), str(getattr(l, "dtype", type(l).__name__))) for l in leaves),
    )


@dataclass
class RegionPlan:
    """An accepted schedule plus its executor.

    ``execute(items)`` runs the restructured region: ``relic_pfor`` over
    the per-item function captured at plan build, at the plan's
    granularity, stream count and combine.
    """

    key: PlanKey
    schedule: RelicSchedule
    fn: Callable  # per-item function captured at plan build
    cache_state: str = "miss"  # "miss" on build, "hit" when served from cache

    def execute(self, items):
        """Run the restructured region on `items`."""
        k = self.key
        return relic_pfor(self.fn, items, granularity=k.granularity, n_streams=k.n_streams,
                          combine=k.combine)

    def execute_masked(self, items, valid):
        """Masked fixed-shape execution over a *padded active set*: `items`
        span every slot of a fixed pool, `valid` marks the live ones. The
        mask is data, not shape, so continuous-batching serving runs the
        same shapes as requests come and go. Invalid rows are zeroed
        ("stack") or excluded from the reduction ("sum")."""
        k = self.key
        return relic_pfor(self.fn, items, granularity=k.granularity, n_streams=k.n_streams,
                          combine=k.combine, valid=valid)

    def thunk(self, items) -> Callable:
        """A zero-arg executor bound to `items` (the classic
        ``RegionDecision.parallel_fn`` shape)."""
        return lambda: self.execute(items)

    def describe(self) -> str:
        return f"{self.key.region}: {self.schedule.describe()} combine={self.key.combine}"


# ---------------------------------------------------------------------------
# the cache

_PLAN_CACHE: dict[PlanKey, RegionPlan] = {}
_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> dict:
    return dict(_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _STATS.update(hits=0, misses=0)


def _get_or_build(key: PlanKey, schedule: RelicSchedule, fn: Callable) -> RegionPlan:
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _STATS["hits"] += 1
        plan.cache_state = "hit"
        return plan
    _STATS["misses"] += 1
    plan = _PLAN_CACHE[key] = RegionPlan(key=key, schedule=schedule, fn=fn)
    return plan


def plan_for_region(region, schedule: RelicSchedule, hw: HwModel) -> RegionPlan:
    """The plan for (region signature, schedule, hw) — cached. The item
    *content* fingerprint is part of the signature so two same-named,
    same-shaped regions over different data (e.g. two serving engines
    with different params, whose prefilled caches are the items) do not
    alias to one plan."""
    key = PlanKey(
        region=region.name,
        items_sig=items_signature(region.items) + data_fingerprint(region.items),
        granularity=schedule.granularity,
        n_streams=schedule.n_streams,
        combine=getattr(region, "combine", "stack"),
        hw=hw,
    )
    return _get_or_build(key, schedule, region.fn)


def _host(x) -> np.ndarray:
    """A flat slice's bytes as numpy (a tensor's raw bytes, bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().view(torch.uint8).numpy()
    return np.asarray(x)


def data_fingerprint(tree) -> tuple:
    """Cheap content fingerprint of the tensors a region closes over, so
    same-signature-but-different-data calls do not share a plan. Samples
    head/tail elements only — collisions are possible but require
    identical shapes, dtypes, and boundary values."""
    fp = []
    for leaf in pytree.tree_leaves(tree):
        if hasattr(leaf, "dtype") and hasattr(leaf, "reshape"):
            flat = leaf.reshape(-1)
            head = _host(flat[:8]).tobytes()
            tail = _host(flat[-8:]).tobytes()
            fp.append((str(leaf.dtype), int(flat.shape[0]), hash(head + tail)))
        else:
            fp.append(repr(leaf)[:64])
    return tuple(fp)


def plan_for(
    name: str,
    fn: Callable,
    items,
    *,
    granularity: int,
    n_streams: int = 2,
    combine: str = "stack",
    hw: HwModel | None = None,
    schedule: RelicSchedule | None = None,
    salt: tuple = (),
) -> RegionPlan:
    """Manual plan construction (no advisory run) — the path benchmarks
    use for fixed-granularity restructured execution. ``salt`` extends
    the cache key (e.g. a ``data_fingerprint`` of closed-over state)."""
    hw = hw or HwModel()
    schedule = schedule or RelicSchedule(
        granularity=granularity, n_streams=n_streams, strategy="smt2"
    )
    key = PlanKey(
        region=name,
        items_sig=items_signature(items) + tuple(salt),
        granularity=granularity,
        n_streams=n_streams,
        combine=combine,
        hw=hw,
    )
    return _get_or_build(key, schedule, fn)


# ---------------------------------------------------------------------------
# suite-level advisory


@dataclass
class SuiteEntry:
    """One benchmark's advisory outcome: the decision, the plan (None if
    rejected), and the built data the region was advised over."""

    benchmark: str
    decision: Any  # RegionDecision
    plan: Optional[RegionPlan]
    data: Any

    @property
    def accepted(self) -> bool:
        return self.decision.accepted


def advise_suite(
    hw: HwModel | None = None,
    *,
    benchmarks: dict | None = None,
    gate_threshold: float = 0.02,
    device=None,
) -> dict[str, SuiteEntry]:
    """Batch-advise every registered benchmark through the tool pipeline,
    its data built on ``device`` (CUDA unless the caller asks for the CPU).

    Returns name → SuiteEntry. Repeating the call re-uses cached plans
    (same region signatures): the same plan objects come back.
    """
    from repro_torch.bench_suite import BENCHMARKS
    from repro_torch.core.adviser import Aira

    aira = Aira(hw=hw, gate_threshold=gate_threshold)
    out: dict[str, SuiteEntry] = {}
    for name, b in (benchmarks if benchmarks is not None else BENCHMARKS).items():
        data = b.build(device=device)
        report = aira.advise(b.workload(data))
        d = report.decisions[0]
        out[name] = SuiteEntry(benchmark=name, decision=d, plan=d.plan, data=data)
    return out
