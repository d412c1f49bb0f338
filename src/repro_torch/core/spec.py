"""The Aira specification file (§V.2 of the paper), machine-readable.

Port of the JAX package's ``core/spec.py``. The paper ships a Markdown
spec that an MCP tool loads into the LLM's context; it describes the
end-to-end flow ("Parallelize this program with Aira") and embeds 20
worked examples of the Relic API so a general-purpose model can
restructure code onto a custom framework. Here the spec is a dataclass
the (deterministic) adviser executes stage by stage, and the 20 examples
are *runnable* — the tests assert each one restructures correctly under
``relic_pfor`` (it matches ``torch.func.vmap(fn)``). Each example's
``items(device=None)`` draws its inputs from a numpy seed onto the device
(CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device

PROMPT = "Parallelize this program with Aira"


@dataclass(frozen=True)
class Stage:
    name: str
    tool: str
    description: str
    reject_on: Optional[str] = None


AIRA_SPEC = (
    Stage(
        "profile",
        "core.profiler.profile_step",
        "Collect a sampled profile (perf+LBR analogue: aten-op cost "
        "count); emit hot functions ranked by modeled time.",
    ),
    Stage(
        "annotate",
        "core.adviser.Aira.annotate",
        "Mark promising regions inside hotspot functions; record the "
        "region→source mapping.",
    ),
    Stage(
        "static_deps",
        "core.deps.static_deps",
        "BOLT analogue: aten-graph def-use walk; writes into shared "
        "(argument-derived) storage inside a region demand a dynamic check.",
        reject_on="irreducible loop-carried dependence",
    ),
    Stage(
        "dynamic_deps",
        "core.deps.check_conflicts",
        "DynamoRIO analogue: replay recorded gather/scatter index traces "
        "under the proposed task partition.",
        reject_on="cross-task write conflict",
    ),
    Stage(
        "simulate",
        "core.overlap_model.OverlapModel.predict",
        "Sniper analogue: price serial vs smt2 (co-scheduled pair on one "
        "core) vs smp2 (two cores).",
        reject_on="predicted smt2 gain ≤ 2%",
    ),
    Stage(
        "restructure",
        "core.relic.relic_pfor",
        "Rewrite accepted regions onto the Relic API with the granularity "
        "and stream count the simulator chose.",
    ),
)


# ---------------------------------------------------------------------------
# The serving-layer speculation flow: the same advisory shape as
# AIRA_SPEC — run a cheap helper stream, verify, commit only what
# survives, and gate the whole mechanism on a predicted win — one level
# up, at the decode step. Not part of AIRA_SPEC (the compute-region
# pipeline is pinned by its golden decisions); the ``speculate`` stage
# rides in DEFAULT_TOOLS but reports only for regions carrying a
# speculation measurement.

SERVING_SPEC = (
    Stage(
        "draft",
        "serve.speculative.DraftSource.propose",
        "Run the helper stream: K proposed tokens per live row, from the "
        "n-gram prompt-lookup drafter or a small draft model sharing the "
        "tokenizer space.",
    ),
    Stage(
        "verify",
        "models.model.Model.verify_step",
        "One fixed-K target forward over [pending token, K drafts]; "
        "greedy-equivalence acceptance compares each draft to the "
        "previous position's argmax.",
        reject_on="draft token != target argmax (suffix rejected)",
    ),
    Stage(
        "rollback",
        "serve.kv_cache.PagedKVCache.truncate_row",
        "Rewind rejected entries (SlotKVCache.truncate_row likewise): "
        "committed lengths drop, claimed tail blocks release back to "
        "their reservation; shared prefix blocks are never touched.",
    ),
    Stage(
        "speculate",
        "core.tools.SpeculationAdvisorTool",
        "Price expected per-output-token latency from measured draft "
        "cost + acceptance rate; pick K in {0, 2, 4, 8} per workload.",
        reject_on="predicted gain <= threshold → K=0",
    ),
)


# ---------------------------------------------------------------------------
# The 20 Relic usage examples (paper §V.3). Each is (per-item fn, item
# maker) — restructured with relic_pfor and asserted equal to vmap(fn).


def _items(shape, seed=0, device=None):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        resolve_device(device))


def _ints(shape, high, seed, device=None):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.int64)).to(
        resolve_device(device))


def _fixed_iter(x):
    v = x
    for _ in range(4):
        v = 0.5 * (v + x / torch.clamp(v, min=1e-3))
    return v


def _window_mean(x):
    w = torch.full((1, 1, 3), 1.0 / 3.0, dtype=x.dtype, device=x.device)
    return torch.nn.functional.conv1d(x[None, None], w, padding=1)[0, 0]


RELIC_EXAMPLES: list[dict] = [
    dict(name="scale", fn=lambda x: 2.0 * x, items=lambda device=None: _items((64, 8), device=device)),
    dict(name="saxpy", fn=lambda ab: ab[0] * 1.5 + ab[1],
         items=lambda device=None: (_items((64, 8), device=device),
                                    _items((64, 8), seed=1, device=device))),
    dict(name="dot", fn=lambda xy: torch.dot(xy[0], xy[1]),
         items=lambda device=None: (_items((32, 16), device=device),
                                    _items((32, 16), seed=1, device=device))),
    dict(name="norm", fn=lambda x: x / (torch.linalg.norm(x) + 1e-6),
         items=lambda device=None: _items((48, 12), device=device)),
    dict(name="relu_mlp",
         fn=lambda x: torch.relu(x @ torch.ones((8, 4), dtype=x.dtype, device=x.device)),
         items=lambda device=None: _items((64, 8), device=device)),
    dict(name="softmax_row", fn=lambda x: torch.softmax(x, -1),
         items=lambda device=None: _items((40, 10), device=device)),
    dict(name="cumsum_row", fn=lambda x: torch.cumsum(x, 0),
         items=lambda device=None: _items((40, 10), device=device)),
    dict(name="sort_row", fn=lambda x: torch.sort(x).values,
         items=lambda device=None: _items((32, 16), device=device)),
    dict(name="topk_row", fn=lambda x: torch.topk(x, 4).values,
         items=lambda device=None: _items((32, 16), device=device)),
    dict(name="gather_reduce", fn=lambda xi: xi[0][xi[1]].sum(),
         items=lambda device=None: (_items((32, 64), device=device),
                                    _ints((32, 8), 64, 2, device=device))),
    dict(name="stencil3",
         fn=lambda x: x - 0.5 * (torch.roll(x, 1) + torch.roll(x, -1)),
         items=lambda device=None: _items((48, 16), device=device)),
    dict(name="poly_eval", fn=lambda x: ((x * 0.5 + 1.0) * x - 2.0) * x + 3.0,
         items=lambda device=None: _items((64, 8), device=device)),
    dict(name="masked_sum", fn=lambda x: torch.where(x > 0, x, 0.0).sum(),
         items=lambda device=None: _items((64, 8), device=device)),
    dict(name="argmin_dist",
         fn=lambda q: torch.argmin(
             ((q[None, :] - torch.eye(8, dtype=q.dtype, device=q.device)) ** 2).sum(-1)),
         items=lambda device=None: _items((40, 8), device=device)),
    dict(name="fixed_iter", fn=_fixed_iter,
         items=lambda device=None: _items((64, 8), device=device).abs() + 1.0),
    dict(name="bincount8",
         fn=lambda i: (i[:, None] == torch.arange(8, device=i.device)).float().sum(0),
         items=lambda device=None: _ints((32, 16), 8, 3, device=device)),
    dict(name="logsumexp_row", fn=lambda x: torch.logsumexp(x, -1),
         items=lambda device=None: _items((40, 10), device=device)),
    dict(name="l2_pair", fn=lambda xy: ((xy[0] - xy[1]) ** 2).sum(),
         items=lambda device=None: (_items((48, 12), device=device),
                                    _items((48, 12), seed=4, device=device))),
    dict(name="clip_quant",
         fn=lambda x: torch.round(torch.clamp(x, -1, 1) * 127).to(torch.int8),
         items=lambda device=None: _items((64, 8), device=device)),
    dict(name="window_mean", fn=_window_mean, items=lambda device=None: _items((32, 16), device=device)),
]
if len(RELIC_EXAMPLES) != 20:
    raise RuntimeError("the spec embeds the paper's 20 Relic examples")
