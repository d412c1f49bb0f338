"""Continuous-batching scheduler over a slotted or block-paged pool.

Port of the JAX package's ``serve/scheduler.py``. Each ``step()``:

  1. admits arrived queued requests in strict priority order (higher
     ``priority`` first, then arrival, then rid): slotted admission
     prefills a wave of same-bucket prompts as one batched call
     (same-length prompts for the SSM family, whose state would integrate
     pads, and the MoE, whose capacity counts them; a VLM's of one patch
     shape, its patch rows ahead of its tokens) and writes each row into
     its slot; paged admission charges
     blocks one request at a time and, on a prefix-cache hit, prefills
     only the un-cached suffix. The first token is sampled from the
     prefill logits (that instant is the TTFT). When the pool is dry and
     the queue head outranks a live row, the lowest-priority row is
     *preempted*: its tokens and sampler state stay on the request, the
     paged layout parks its committed full blocks in the prefix trie, and
     the resume re-prefills only what the trie does not hold;
  2. with ``chunk_size`` set, admission only reserves, and at most
     ``chunk_size`` prompt tokens of prefill run a step, one
     ``prefill_chunk`` call per slice of an in-flight prompt (highest
     priority first), each padded to its pow2 width: a long prompt never
     stalls the decode stream for more than a chunk;
  3. runs ONE batched decode over the full fixed-size row pool — dead
     rows flow through and their outputs are ignored — or, with
     ``spec=SpecConfig(k>0)``, one draft → verify round: the drafter
     proposes K tokens a row, one ``verify_step`` forward over K+1 tokens
     prices them, greedy-equivalence acceptance commits the matched
     prefix plus the corrected token, and the pools (and a model
     drafter's cache) rewind the rejected tail;
  4. samples the next token per live row and retires requests that hit
     their budget or EOS, freeing their slot or blocks.

``step_ms`` times the whole step and is taken after a device
synchronise, so it measures the work and not just its launch. Driving is
open-loop: ``run()`` injects requests at their ``arrival_time``. With a
decode plan set (``set_decode_plan``; slot layout only) the decode runs
through the plan's masked executor over the whole pool, the live rows as
its mask, compiled as one family a (plan key, pool size) (``_plan_decode``).

Every model step runs through a compiled step family
(``Model.jit_step``: a CUDA graph a step shape on the card), the engine's
when the engine made this scheduler, else a scheduler-local one. The step
shapes form a closed family: ``widths`` counts the prompt widths of the
monolithic prefills, the chunk widths and the verify widths this scheduler
ran; after ``prime()`` every chunk width lies in ``primed_widths`` (the
pow2 widths up to ``chunk_size``) and every verify width is K+1 for a K the
scheduler served with. With telemetry on, the retrace watch samples the
families' compile counts at every step boundary and ticks
``engine.retraces`` by their growth, as the reference's does.

With ``telemetry`` enabled, each working step records a tree of spans into
the flight recorder (``serve/telemetry.py``: ``StepTrace``): the step, and
the phases that tile it — ``admit`` (holding a ``prefill`` span a
monolithic or prefix-suffix prefill call, which covers its first token's
sampling), ``prefill_chunk`` (with ``chunk_size``), ``decode`` (tiled by
``decode.prep``, the inputs' uploads; ``decode.launch``, the step
function's call; ``decode.wait``, the synchronise) or ``draft`` and
``verify``, then ``sample`` (the readback) and ``commit`` (appends and
retirements). The step span carries its host time (its duration less its
device waits), the waits, the launches and its device time (CUDA events
on the card). Each request records its lifecycle events; the step sets the queue and pool
gauges and ticks the metrics registry. Every request counts the prompt
positions its prefills computed and the pads among them
(``Request.prefill_tokens`` / ``prefill_pad``), recorder on or off. With a
``controller`` attached (``serve/controller.py``), every
``decision_interval`` working steps the scheduler reads
``window_summary``, lets the controller price its arms and applies the
decision: the live speculation depth K (within ``spec.k``, which sizes
the admission margin and the drafter), the attention backend and an
admission budget a step.

On a serving mesh (``mesh=``, from the engine) every rank runs this
scheduler, and each must decide the same schedule: the paged pool is
allocated as this rank's shard, each step takes rank 0's clock (its
``now``, broadcast), a controller's decision is rank 0's (broadcast), and
before every decode or verify the block tables, lengths and tokens are
hashed across the ranks (``collectives.check_replicated``), which raises
on every rank when one has diverged. The logits every rank samples from
are the same on every rank (the collectives give each rank the same
values), so the rest follows.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import (
    CHUNKED_PREFILL_FAMILIES,
    PAD_PREFILL_FAMILIES,
    SPEC_FAMILIES,
    prefill_bucket,
)
from repro_torch.models.step_graph import GraphFamily, cache_size, in_place
from repro_torch.parallel import collectives
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache, StateStorage
from repro_torch.serve.request import (
    DECODE,
    FINISHED,
    PREEMPTED,
    PREFILL,
    QUEUED,
    Request,
    ServeStats,
)
from repro_torch.serve.telemetry import TID_ADVISER, StepTrace, Telemetry, get_telemetry


def sorted_cache(tree):
    """A nested cache dict with its keys sorted at every level, as JAX's
    tree flattening orders them: the decode plan's per-request function
    and the pool it runs over then flatten to the same leaf order, however
    each cache was built (a prefill and ``init_cache`` insert keys in
    different orders)."""
    if isinstance(tree, dict):
        return {k: sorted_cache(tree[k]) for k in sorted(tree)}
    return tree


def _plan_step(model, plan):
    """(cache, tok, mask) → (logits, new cache): the per-request items
    (token, cache leaves with their batch axis first), the plan's masked
    executor over them, the new leaves put back in the cache's layout. It
    holds no scheduler: an engine's plan steps outlive the schedulers."""

    def step(cache, tok, mask):
        cache = sorted_cache(cache)
        leaves, spec = pytree.tree_flatten(cache)
        axes = tuple(pytree.tree_leaves(model.cache_batch_axes(cache)))
        items = (tok, [leaf.movedim(ax, 0) for leaf, ax in zip(leaves, axes)])
        logits, new_leaves = plan.execute_masked(items, mask)
        return logits, pytree.tree_unflatten(
            [leaf.movedim(0, ax) for leaf, ax in zip(new_leaves, axes)], spec)

    return step


@dataclass
class _ChunkState:
    """An in-flight chunked prefill: a batch-1 dense staging cache from
    the state storage's free list (seeded from a prefix hit when there was
    one) and the cursor into the request's effective prompt. Installed into
    the pool when ``pos`` reaches the end, and the staging cache goes back."""

    req: Request
    cache: Any  # batch-1 dense cache; len counts the committed chunk rows
    prompt: np.ndarray  # effective prompt (prompt + committed tokens on resume)
    pos: int  # next prompt position to prefill (starts at the prefix hit)
    skip_blocks: int  # leading prefix-hit blocks write_prefill must not touch


class Scheduler:
    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int,
        max_seq: int,
        temperature: float = 0.0,
        stats: Optional[ServeStats] = None,
        seed: int = 0,
        kv_layout: str = "slot",
        block_size: int = 8,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        attention_backend: Optional[str] = None,
        decode_plan=None,
        spec=None,
        chunk_size: Optional[int] = None,
        telemetry=None,
        controller=None,
        step_fns=None,
        storage=None,
        mesh=None,
        plan_step_cache: Optional[dict] = None,
    ):
        self.model = model
        self._mesh = mesh
        self.params = params
        self.device = model.device
        self.max_seq = int(max_seq)
        self.temperature = float(temperature)
        self.seed = int(seed)
        # flight recorder: explicit, or the module-global default
        # (disabled). `_ton` is the hard off switch every instrumentation
        # site below checks. A controller senses through the windowed
        # metric rings, so a controller-driven scheduler records into a
        # private live Telemetry when the caller left the recorder off.
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.controller = controller
        if controller is not None and not self.tel.enabled:
            self.tel = Telemetry(enabled=True, capacity=8192)
        self._ton = bool(self.tel.enabled)
        self.stats = stats if stats is not None else ServeStats()
        if self._ton:
            reg = self.stats.registry
            self._g_queue = reg.gauge("sched.queue_depth")
            self._g_active = reg.gauge("sched.active")
            self._g_occ = reg.gauge("pool.occupancy")
            self._g_free_blocks = reg.gauge("pool.free_blocks")
            self._c_admitted = reg.counter("sched.admitted")
            self._c_retraces = reg.counter("engine.retraces")
            self._s_chunk_util = reg.series("sched.chunk_util")
        self._step_seq = 0
        self._st: Optional[StepTrace] = None  # the step being recorded
        # the device time's timing pair, reused a step; none with the recorder off
        self._step_events = None
        if self._ton and self.device.type == "cuda":
            self._step_events = (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        self.kv_layout = kv_layout
        # the state the compiled steps bind: the engine's, or this
        # scheduler's own when standalone
        self._storage = storage if storage is not None else StateStorage()
        if kv_layout == "paged":
            if decode_plan is not None:
                raise ValueError(
                    "decode plans route through the slotted layout; "
                    "use kv_layout='slot' to serve through a RegionPlan"
                )
            self.kv = PagedKVCache(
                model, max_batch, max_seq, block_size=block_size,
                num_blocks=num_blocks, prefix_cache=prefix_cache,
                metrics=self.stats.registry if self._ton else None, storage=self._storage,
                mesh=mesh,
            )
        else:
            if mesh is not None:
                raise ValueError("a serving mesh shards the paged block pool; use "
                                 "kv_layout='paged'")
            self.kv = SlotKVCache(model, max_batch, max_seq, storage=self._storage)
        self.attention_backend = kernel_ops.resolve_attention_backend(
            attention_backend, self.device
        )
        # pow2 prompt-shape bucketing (pad + mask) only where pads cannot
        # change tokens; other families group prompts by exact length
        self._bucket = model.cfg.family in PAD_PREFILL_FAMILIES
        if chunk_size is not None:
            chunk_size = int(chunk_size)
            if chunk_size < 1 or chunk_size & (chunk_size - 1):
                raise ValueError(
                    f"chunk_size must be a power of two >= 1, got {chunk_size} "
                    "(chunks pad to pow2 widths; a cap off a power of two would "
                    "add a width of its own for every partial chunk)"
                )
            if model.cfg.family not in CHUNKED_PREFILL_FAMILIES:
                raise ValueError(
                    f"chunked prefill needs a {CHUNKED_PREFILL_FAMILIES} family "
                    f"(length-addressed KV cache), got {model.cfg.family!r}"
                )
        self.chunk_size = chunk_size
        # speculative decode: a draft stream and the fused verify step
        self.spec = spec if (spec is not None and spec.k > 0) else None
        self._drafter = None
        if self.spec is not None:
            if model.cfg.family not in SPEC_FAMILIES:
                raise ValueError(
                    f"speculative decode needs a {SPEC_FAMILIES} family "
                    f"(rewindable KV cache), got {model.cfg.family!r}"
                )
            if self.temperature > 0.0:
                raise ValueError(
                    "speculative decode is greedy-equivalence only; serve with temperature=0"
                )
            if decode_plan is not None:
                raise ValueError(
                    "speculation and decode plans both rewrite the decode step — "
                    "set one or the other"
                )
        # the compiled steps: the engine's families (``step_fns``: backend →
        # family) when the engine made this scheduler, else a local cache
        self._fn_resolver = step_fns
        self._local_fns: dict[str, dict] = {}
        self._prefill_buf = None  # the monolithic prefills' staging cache
        fns = self._resolve_fns(self.attention_backend)
        self._install(fns)
        if self.spec is not None:
            from repro_torch.serve.speculative import ModelDraftSource

            self._drafter = self.spec.make_drafter(attention_backend=self.attention_backend)
            if isinstance(self._drafter, ModelDraftSource):
                # a model drafter serves on the family's draft steps and the
                # storage's draft cache
                self._drafter.bind(max_batch, max_seq, storage=self._storage,
                                   steps=fns["draft"](self._drafter.model))
            else:
                self._drafter.bind(max_batch, max_seq)
        self._queue: list[Request] = []  # sorted by _queue_key
        self._active: dict[int, Request] = {}  # row → request
        self._chunking: dict[int, _ChunkState] = {}  # row → in-flight chunked prefill
        self._n_admitted = 0  # per-run admission ordinal (seeds sampling)
        self._ordinals: dict[int, int] = {}  # rid → ordinal, admission → first sample
        self._tok = np.zeros((max_batch,), np.int64)  # pending token per row
        self._gens: dict[int, Optional[torch.Generator]] = {}  # row → sampler
        self.widths = {"prefill": Counter(), "chunk": Counter(), "verify": Counter()}
        self.primed_widths: set = set()
        # the live speculation depth: SpecConfig.k is the *maximum* (it
        # sizes the admission margin and the drafter); a controller
        # re-decides the serving depth within [0, spec.k] mid-run
        self._live_k = self.spec.k if self.spec is not None else 0
        self._ctl_steps = 0
        self._admit_budget: Optional[int] = None
        if controller is not None:
            self._wire_controller(controller)
        self._t0: Optional[float] = None
        # the compiled plan steps, (plan key, pool size) → family: the
        # engine's when the engine made this scheduler
        self._plan_steps = plan_step_cache if plan_step_cache is not None else {}
        self._decode_plan = None
        if decode_plan is not None:
            self.set_decode_plan(decode_plan)
        if self._ton:
            # the retrace watch: the families' compile counts, sampled at
            # step boundaries; the baseline is taken now, so what an engine
            # compiled before (prime(), earlier serves) is no retrace
            self._rebuild_trace_watch()

    # ------------------------------------------------------------------
    # the compiled step families
    def _resolve_fns(self, backend: str) -> dict:
        """The step family of ``backend``: the engine's shared one when the
        engine made this scheduler, else a local cache (retrace-free
        switching holds for the engine's families that ``prime()`` warmed)."""
        if self._fn_resolver is not None:
            return self._fn_resolver(backend)
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        fns = self._local_fns.get(backend)
        if fns is None:
            jit = self.model.jit_step
            drafts: dict = {}
            fns = {"backend": backend, "prefill": jit("prefill", backend),
                   "decode": jit("decode_step", backend),
                   "draft": lambda m: drafts.setdefault(m, {
                       "decode": m.jit_step("decode_step", backend),
                       "prefill": m.jit_step("prefill", backend)})}
            mesh = self._mesh

            def paged(name):
                return (jit(name, backend) if mesh is None
                        else self.model.sharded_paged_step(name, mesh, backend))

            if self.kv_layout == "paged":
                fns["decode_paged"] = paged("decode_step_paged")
                fns["prefill_prefix"] = jit("prefill_with_prefix", backend)
            if self.spec is not None:
                fns["verify"] = jit("verify_step", backend)
                if self.kv_layout == "paged":
                    fns["verify_paged"] = paged("verify_step_paged")
            if self.chunk_size is not None:
                fns["prefill_chunk"] = jit("prefill_chunk", backend)
            self._local_fns[backend] = fns
        return fns

    def _install(self, fns: dict, prefill: bool = True) -> None:
        """Take a family's steps; a live switch (``prefill=False``) keeps
        the monolithic and prefix prefills, as the reference's does."""
        self.attention_backend = fns["backend"]
        if prefill:
            self._prefill, self._prefill_prefix = fns["prefill"], fns.get("prefill_prefix")
        self._decode, self._decode_paged = fns["decode"], fns.get("decode_paged")
        self._verify, self._verify_paged = fns.get("verify"), fns.get("verify_paged")
        self._prefill_chunk = fns.get("prefill_chunk")

    def _staging_rows(self, n: int):
        """The first ``n`` rows of the staging cache a monolithic prefill
        writes its new cache into (the storage's, taken at first use: one
        row a slot on the slot layout, one on the paged layout, whose
        admission prefills a request at a time); admission copies the rows
        into the pool at once."""
        if self._prefill_buf is None:
            rows = self.kv.max_batch if self.kv_layout == "slot" else 1
            self._prefill_buf = self._storage.take(
                ("prefill", rows, self.max_seq), self,
                lambda: self.model.init_cache(rows, self.max_seq))
        return self.model.read_cache_slot(self._prefill_buf, 0, n)

    def _rebuild_trace_watch(self) -> None:
        """(Re)collect the step families under retrace watch and take their
        compile counts as the baseline: at construction and after a live
        backend switch installs another family."""
        self._traced_fns = [self._prefill, self._decode, self._decode_paged,
                            self._prefill_prefix, self._prefill_chunk, self._verify,
                            self._verify_paged]
        self._cache_size_seen = cache_size(self._traced_fns)

    # ------------------------------------------------------------------
    # the online adviser: observe → decide → apply
    def _wire_controller(self, controller) -> None:
        """Check the controller's candidate arms against this scheduler's
        capacity and apply its initial arm. The deepest candidate must fit
        inside ``spec.k`` (the admission margin and the drafter's overhang
        were sized for it); backend names resolve once, so the
        controller's arms and the scheduler's state agree."""
        ks = tuple(getattr(controller, "ks", (0,)))
        kmax = max(ks) if ks else 0
        if kmax > 0:
            if self.spec is None:
                raise ValueError(
                    f"controller ks={ks} include positive depths but the "
                    "scheduler has no speculation configured — build it with "
                    "spec=SpecConfig(k=max(ks)) so the margin/drafter cover "
                    "the deepest arm"
                )
            if kmax > self.spec.k:
                raise ValueError(
                    f"controller kmax={kmax} exceeds spec.k={self.spec.k} — "
                    "the admission margin and drafter overhang are sized by "
                    "spec.k, so the deepest candidate must fit inside it"
                )
        backends = getattr(controller, "backends", None)
        if backends is None:
            controller.backends = (self.attention_backend,)
        else:
            controller.backends = tuple(dict.fromkeys(
                kernel_ops.resolve_attention_backend(b, self.device) for b in backends))
        init_k = getattr(controller, "initial_k", None)
        if init_k is not None and int(init_k) != self._live_k:
            self._set_live_k(int(init_k))

    def _set_backend(self, backend: str) -> None:
        """Swap the attention backend live: install that backend's decode,
        verify and chunk steps (the prefills keep the backend the scheduler
        was built with, as the reference's do). The pool state (KV, block
        tables, lengths) does not depend on it, so nothing else moves; the
        trace watch re-baselines, so the switch itself is no retrace (a
        family never warmed still counts its first compiles). The drafter
        keeps the backend it was built with, as the reference's does."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        if backend == self.attention_backend:
            return
        self._install(self._resolve_fns(backend), prefill=False)
        if self._ton:
            self._rebuild_trace_watch()

    def _set_live_k(self, k: int) -> None:
        """Re-decide the speculation depth live: the next verify is K+1
        wide. The stateful drafter's catch-up: rows that decoded plainly
        while K was 0 advanced the target cache without the draft cache
        seeing their tokens, so a 0→K transition re-syncs every active row
        through ``on_admit`` (re-prefilling the committed history). Moves
        between positive depths need no sync: rollback leaves the draft
        cache on the committed stream."""
        k = int(k)
        if k == self._live_k:
            return
        if k < 0 or (k > 0 and (self.spec is None or k > self.spec.k)):
            cap = self.spec.k if self.spec is not None else 0
            raise ValueError(f"live k={k} outside [0, {cap}]")
        was, self._live_k = self._live_k, k
        if self._drafter is not None and k > 0:
            if hasattr(self._drafter, "set_k"):
                self._drafter.set_k(k)
            if was == 0:
                for row, req in self._active.items():
                    self._drafter.on_admit(row, req)

    def _controller_tick(self) -> None:
        """One observe → decide → apply round every ``decision_interval``
        working steps: read the windowed sensor vector, let the controller
        price the arms, apply the verdict, and record the decision on the
        adviser lane and in the controller gauges (live K and backend,
        switches, dwell) — the paper's audit trail, live."""
        c = self.controller
        self._ctl_steps += 1
        if self._ctl_steps % max(1, int(getattr(c, "decision_interval", 8))):
            return
        if self._mesh is None or self._mesh.get_rank() == self._root:
            summary = self.stats.registry.window_summary(int(getattr(c, "window", 16)))
            d = c.decide(summary, k_live=self._live_k, backend_live=self.attention_backend,
                         step=self._ctl_steps)
        else:
            d = None
        if self._mesh is not None:
            # rank 0 decides for every rank: its measured windows (and a
            # prime() it was seeded with) are its own
            d = collectives.broadcast_object(d, self._mesh)
        self._apply_decision(d)
        reg = self.stats.registry
        reg.counter("controller.decisions").inc()
        if d.switched:
            reg.counter("controller.switches").inc()
        reg.gauge("controller.k").set(float(self._live_k))
        backends = getattr(c, "backends", None) or ()
        reg.gauge("controller.backend_index").set(
            float(backends.index(self.attention_backend))
            if self.attention_backend in backends else -1.0)
        reg.gauge("controller.dwell_remaining").set(float(getattr(c, "dwell_remaining", 0)))
        self.stats.controller_info = {
            "decisions": len(getattr(c, "decisions", ())) or self._ctl_steps,
            "switches": int(getattr(c, "n_switches", 0)),
            "k": self._live_k,
            "backend": self.attention_backend,
            "admit_budget": self._admit_budget,
            "dwell_remaining": int(getattr(c, "dwell_remaining", 0)),
        }
        self.tel.tracer.instant("online-decision", "adviser", tid=TID_ADVISER, args=d.to_json())

    def _apply_decision(self, d) -> None:
        """Apply one ``Decision``: backend, then depth, then the admission
        budget."""
        if d.backend is not None:
            self._set_backend(d.backend)
        if d.k is not None:
            self._set_live_k(d.k)
        self._admit_budget = max(1, int(d.admit_budget)) if d.admit_budget is not None else None

    # ------------------------------------------------------------------
    # plan routing (over the active-slot view)
    def set_decode_plan(self, plan) -> None:
        """Route the pool decode through an accepted ``RegionPlan`` (as
        produced by advising ``decode_region`` — stack combine only,
        since request order is externally visible)."""
        if plan is not None and self.kv_layout == "paged":
            raise ValueError("decode plans are not supported on the paged layout")
        if plan is not None and self.spec is not None:
            raise ValueError(
                "speculation and decode plans both rewrite the decode step "
                "— set one or the other"
            )
        if plan is not None and plan.key.combine != "stack":
            raise ValueError(
                "decode plan must preserve per-request order (combine='stack')"
            )
        self._decode_plan = plan

    def _plan_decode(self, cache, tok, mask):
        """One pool decode through the plan, as a compiled family a (plan
        key, pool size), as the reference jits it: a CUDA graph on the card,
        the record of its key on the CPU. ``tok`` and ``mask`` are its
        inputs; the slot cache's leaves, ``len`` included, are its state,
        written back in place (dead rows zeroed, as the JAX package's
        masked plan leaves them), so the cache stays the storage's. The
        masked executor keeps the shapes whatever the live count: one
        entry a key."""
        key = (self._decode_plan.key, self.kv.max_batch)
        step = self._plan_steps.get(key)
        if step is None:
            step = self._plan_steps[key] = GraphFamily(
                in_place(_plan_step(self.model, self._decode_plan), {1: 0}), self.device,
                self.model.graph_pool, inputs=(1, 2), name=f"plan_decode[{key[0].region}]")
        return step(cache, tok, mask)

    # ------------------------------------------------------------------
    def _clock(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    @property
    def _root(self) -> int:
        """The global rank of mesh coordinate (0, …, 0)."""
        return int(self._mesh.mesh.reshape(-1)[0])

    def _check_schedule(self, tok) -> None:
        """On a mesh: the replicated step inputs must be alike on every
        rank (raises on every rank when one differs)."""
        if self._mesh is not None:
            collectives.check_replicated(self._mesh, self.kv.block_tables, self.kv.cache_len,
                                         tok, what="schedule (block tables, lengths, tokens)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _spec_margin(self) -> int:
        """Row capacity a verify can overhang: the last verify before a
        request retires may write K rejected rows past its final length."""
        return self.spec.k if self.spec is not None else 0

    @staticmethod
    def _queue_key(req: Request):
        """Strict priority (higher first), then arrival, then rid."""
        return (-req.priority, req.arrival_time, req.rid)

    @staticmethod
    def _n_patches(req: Request) -> int:
        """The cache rows a VLM request's patch embeddings fill ahead of its
        tokens (0 without them)."""
        return 0 if req.patch_embeds is None else int(np.shape(req.patch_embeds)[0])

    def submit(self, req: Request) -> None:
        need = (int(np.asarray(req.prompt).shape[0]) + self._n_patches(req)
                + req.max_new_tokens + self._spec_margin)
        if self.chunk_size is not None and req.patch_embeds is not None:
            self.stats.rejected_submissions += 1
            raise ValueError(
                f"request {req.rid}: chunked prefill cannot split patch embeddings "
                "(not token-addressable) — serve VLM requests with chunk_size=None"
            )
        if need > self.max_seq:
            # past max_seq a cache write would land out of the row
            self.stats.rejected_submissions += 1
            margin = (f" (incl. speculative margin K={self._spec_margin})"
                      if self._spec_margin else "")
            raise ValueError(
                f"request {req.rid}: prompt + max_new_tokens = {need}{margin} exceeds "
                f"the row capacity max_seq={self.max_seq}"
            )
        if self.kv_layout == "paged" and self.kv.blocks_for(need) > self.kv.num_blocks:
            # it would sit at the queue head forever (admission is head-of-line)
            self.stats.rejected_submissions += 1
            raise ValueError(
                f"request {req.rid}: needs {self.kv.blocks_for(need)} KV blocks but "
                f"the pool holds {self.kv.num_blocks} — it can never be admitted"
            )
        req.state = QUEUED
        self._queue.append(req)
        self._queue.sort(key=self._queue_key)
        if self._ton:
            self.tel.tracer.async_begin(
                "request", req.rid, "request",
                args={"prompt_len": int(np.asarray(req.prompt).shape[0]),
                      "max_new_tokens": req.max_new_tokens, "priority": req.priority},
            )

    # ------------------------------------------------------------------
    # sampling
    def _sample_row(self, logits_row, gen) -> int:
        if self.temperature <= 0.0:
            return int(torch.argmax(logits_row))
        probs = torch.softmax(logits_row.float() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _generator(self, ordinal: int) -> Optional[torch.Generator]:
        """Per-request sampler seeded from (seed, admission ordinal), so a
        seeded run reproduces its tokens. Its stream differs from the JAX
        package's ``jax.random`` stream; greedy decoding needs none."""
        if self.temperature <= 0.0:
            return None
        s = int(np.random.SeedSequence([self.seed, ordinal]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(s)

    # ------------------------------------------------------------------
    # lifecycle
    def _note_admitted(self, req: Request, now: float) -> None:
        """Queue wait ends at the first admission (a re-admission after
        preemption does not reset it); the sampling ordinal is assigned
        once — a resumed request continues its saved sampler instead."""
        if req.t_first_admit is None:
            req.t_first_admit = now
        if self._ton:
            self._c_admitted.inc()
            self.tel.tracer.async_instant("resume" if req.tokens else "admit", req.rid, "request")
        if not req.tokens:
            self._ordinals[req.rid] = self._n_admitted
            self._n_admitted += 1
        req.state, req.t_admit = PREFILL, now

    @staticmethod
    def _effective_prompt(req: Request) -> np.ndarray:
        """The tokens a (re-)prefill commits: the prompt plus, on resume,
        every generated token but the pending last one (it is fed to the
        next decode, never written ahead)."""
        prompt = np.asarray(req.prompt)
        if len(req.tokens) <= 1:
            return prompt
        return np.concatenate([prompt, np.asarray(req.tokens[:-1], prompt.dtype)])

    def _start_decode(self, req: Request, row: int, logits_row) -> None:
        """Sample the first token from the prefill logits (TTFT is this
        instant) and arm the decode row."""
        gen = self._generator(self._ordinals.pop(req.rid))
        st = self._st
        t = time.perf_counter() if st is not None else 0.0
        tok0 = self._sample_row(logits_row, gen)
        if st is not None:
            st.waited(t)
        req.t_first = self._clock()
        if self._ton:
            self.tel.tracer.async_instant("first_token", req.rid, "request")
        req.tokens.append(tok0)
        req.state = DECODE
        self._tok[row] = tok0
        self._gens[row] = gen
        self._active[row] = req
        if len(req.tokens) >= req.max_new_tokens or tok0 == req.eos_id:
            self._retire(req, self._clock())

    def _resume_decode(self, req: Request, row: int) -> None:
        """Re-arm a preempted request mid-stream: its pending token and
        its sampler's saved state come back, so the continued stream is
        the uninterrupted one token for token."""
        req.state = DECODE
        self._tok[row] = int(req.tokens[-1])
        gen = None
        if req.sample_state is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(req.sample_state)
        self._gens[row] = gen
        self._active[row] = req

    def _arm(self, req: Request, row: int, logits_row) -> None:
        """The admission tail shared by every path: first token or resume,
        then the drafter catches up on the row's history."""
        if req.tokens:
            self._resume_decode(req, row)
        else:
            self._start_decode(req, row, logits_row)
        if self._drafter is not None and self._live_k > 0 and not req.finished:
            self._drafter.on_admit(row, req)

    def _padded(self, prompts, W: int):
        mat = np.zeros((len(prompts), W), np.int64)
        for i, p in enumerate(prompts):
            mat[i, : len(p)] = p
        lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32)
        return torch.from_numpy(mat).to(self.device), lens

    def _width(self, S: int, n_lead: int = 0) -> int:
        """A prompt's prefill width: its pow2 bucket where pads cannot
        change tokens and the bucket's rows (after ``n_lead`` patch rows)
        fit the row, else its length."""
        W = prefill_bucket(S) if self._bucket else S
        return S if n_lead + W > self.max_seq else W

    def _launch(self, fn, *args, **kw):
        """A step function's call, timed as a launch of the step being
        recorded."""
        st = self._st
        return fn(*args, **kw) if st is None else st.launch(fn, *args, **kw)

    def _count_prefill(self, req: Request, real: int, width: int) -> None:
        """A prefill call computed ``real`` of the request's prompt
        positions at ``width``: the rest are pads, counted on the request."""
        req.prefill_tokens += real
        req.prefill_pad += width - real

    def _admit(self, reqs: list, now: float) -> None:
        """Slotted admission of a wave: effective prompts of one pow2
        bucket (of one length, without bucketing) and one patch shape
        prefill as ONE batched call, each row then written into its own
        slot. Resumed requests re-prefill prompt + committed tokens and
        continue their stream."""
        for req in reqs:
            self._note_admitted(req, now)
        groups: dict[tuple, list] = {}
        for req in reqs:
            eff = self._effective_prompt(req)
            pe = None if req.patch_embeds is None else tuple(np.shape(req.patch_embeds))
            W = self._width(len(eff), self._n_patches(req))
            groups.setdefault((W, pe), []).append((req, eff))
        st = self._st
        for (W, pe), group in groups.items():
            if st is not None:
                st.open("prefill", rid=[r.rid for r, _ in group],
                        tokens=sum(len(eff) for _, eff in group), W=W, hit=0)
            toks, lens = self._padded([eff for _, eff in group], W)
            kw = {}
            if pe is not None:
                kw["patch_embeds"] = torch.stack(
                    [torch.as_tensor(np.asarray(r.patch_embeds)) for r, _ in group])
            self.widths["prefill"][W] += 1
            logits, cache = self._launch(
                self._prefill, self.params, toks, self.max_seq,
                prompt_len=lens if self._bucket else None,
                into=self._staging_rows(len(group)), **kw)
            for i, (req, eff) in enumerate(group):
                self._count_prefill(req, len(eff), W)
                slot = self.kv.alloc(req.rid)
                req.slot = slot
                self.kv.write(slot, self.model.read_cache_slot(cache, i))
                if req.tokens:
                    self.stats.recomputed_tokens += len(eff)
                self._arm(req, slot, logits[i])
            if st is not None:
                st.close()

    def _start_chunk_slot(self, req: Request, now: float) -> None:
        """Slotted chunked admission: claim the slot now, prefill later in
        ``chunk_size`` slices. The slot's pool row holds junk until the
        install (the row is not active, so its decode outputs are ignored,
        and ``kv.write`` replaces every leaf)."""
        self._note_admitted(req, now)
        slot = self.kv.alloc(req.rid)
        req.slot = slot
        eff = self._effective_prompt(req)
        if req.tokens:
            self.stats.recomputed_tokens += len(eff)
        self._chunking[slot] = _ChunkState(
            req=req, cache=self._storage.staging(self.model, self.max_seq), prompt=eff,
            pos=0, skip_blocks=0,
        )

    def _try_admit_paged(self, req: Request, now: float) -> bool:
        """Paged admission of one request: prefix-match the effective
        prompt, charge the block budget, prefill only the un-cached suffix
        on a hit (a resumed request's committed blocks were parked at
        preemption, so its resume is usually one partial block of
        recompute). False when the row/block budget does not fit yet.
        With chunking on, admission only reserves: the prompt runs through
        ``_prefill_phase`` and the trie registration waits until its
        blocks hold KV."""
        resume = bool(req.tokens)
        eff = self._effective_prompt(req)
        # patch rows fill cache rows ahead of the tokens and are not
        # token-addressable: no prefix matching for them
        n_lead = self._n_patches(req)
        tokens = () if n_lead else tuple(int(t) for t in eff)
        # the budget carries the speculative margin (a verify's rejected
        # tail occupies blocks past the final length for a moment); a
        # resume charges only the remaining budget, +1 for the pending
        # token, so len(eff) + budget is the fresh admission's worst case
        budget = req.max_new_tokens + self._spec_margin
        if resume:
            budget -= len(req.tokens) - 1
        got = self.kv.try_admit(req.rid, tokens, budget, n_tokens=n_lead + len(eff),
                                register=self.chunk_size is None)
        if got is None:
            return False
        row, hit_ids = got
        self._note_admitted(req, now)
        req.slot = row
        hit = len(hit_ids) * self.kv.block_size
        if resume:
            self.stats.recomputed_tokens += n_lead + len(eff) - hit
        else:
            # the first admission's hit feeds the prompt-token hit rate
            req.prefix_hit = hit
        if self.chunk_size is not None:
            cache = self._storage.staging(self.model, self.max_seq)
            if hit:
                pk, pv = self.kv.gather_prefix(hit_ids)
                cache = self.model.seed_cache_with_prefix(pk, pv, self.max_seq, into=cache)
            self._chunking[row] = _ChunkState(
                req=req, cache=cache, prompt=eff, pos=hit, skip_blocks=len(hit_ids))
            return True
        # a hit leaves no patch rows (they take no prefix matching)
        suffix = eff[hit:]
        W = self._width(len(suffix), hit + n_lead)
        st = self._st
        if st is not None:
            st.open("prefill", rid=req.rid, tokens=len(suffix), W=W, hit=hit)
        toks, lens = self._padded([suffix], W)
        if hit:
            pk, pv = self.kv.gather_prefix(hit_ids)
            logits, cache = self._launch(
                self._prefill_prefix, self.params, toks, pk, pv, self.max_seq,
                suffix_len=lens, into=self._staging_rows(1))
        else:
            kw = {}
            if n_lead:
                kw["patch_embeds"] = torch.as_tensor(np.asarray(req.patch_embeds))[None]
            logits, cache = self._launch(
                self._prefill, self.params, toks, self.max_seq,
                prompt_len=lens if self._bucket else None, into=self._staging_rows(1), **kw)
        self.widths["prefill"][W] += 1
        self._count_prefill(req, len(suffix), W)
        self.kv.write_prefill(row, cache, skip_blocks=len(hit_ids))
        self._arm(req, row, logits[0])
        if st is not None:
            st.close()
        return True

    # ------------------------------------------------------------------
    # priority preemption
    def _maybe_preempt(self, head: Request) -> bool:
        """Evict the lowest-priority live row to make room for ``head`` —
        only when ``head`` strictly outranks it (equal priorities never
        preempt each other: two requests would trade one row forever).
        Ties go to the most recently admitted victim (least work lost).
        True when a row was freed."""
        victims = [
            (req.priority, -(req.t_admit or 0.0), -req.rid, row)
            for row, req in self._active.items()
            if req.priority < head.priority
        ]
        if not victims:
            return False
        self._preempt(min(victims)[3])
        return True

    def _preempt(self, row: int) -> None:
        """Evict a live decode row, keeping its stream resumable: the
        generated tokens and the sampler's state stay on the request; the
        paged layout parks its committed full blocks in the trie."""
        req = self._active.pop(row)
        gen = self._gens.pop(row, None)
        req.sample_state = None if gen is None else gen.get_state()
        committed = None
        if self.kv_layout == "paged" and req.patch_embeds is None:
            committed = tuple(int(t) for t in self._effective_prompt(req))
        self.kv.preempt_row(row, committed)
        req.state = PREEMPTED
        req.slot = None
        req.preemptions += 1
        self.stats.n_preemptions += 1
        if self._ton:
            self.tel.tracer.async_instant("preempt", req.rid, "request",
                                          args={"committed_tokens": len(req.tokens)})
        self._queue.append(req)
        self._queue.sort(key=self._queue_key)

    def _retire(self, req: Request, now: float) -> None:
        req.state, req.t_finish = FINISHED, now
        self.stats.record(req)
        if self._ton:
            self.tel.tracer.async_end(
                "request", req.rid, "request",
                args={"tokens": len(req.tokens), "preemptions": req.preemptions,
                      "prefix_hit": req.prefix_hit},
            )
        if self.kv_layout == "paged":
            self.kv.free_row(req.slot)
        else:
            self.kv.free(req.slot)
        del self._active[req.slot]
        self._gens.pop(req.slot, None)

    # ------------------------------------------------------------------
    def _decode_pool(self):
        """One batched decode over the full row pool; returns the logits.
        Recorded, its span is tiled by ``decode.prep`` (the tail blocks,
        the schedule check, the inputs' uploads), ``decode.launch`` and
        ``decode.wait``."""
        st = self._st
        if st is not None:
            st.open("decode.prep", st.lap("decode"))
        tok = torch.from_numpy(self._tok[:, None].copy()).to(self.device)
        if self.kv_layout == "paged":
            for row in self._active:
                self.kv.ensure_tail(row)
            self._check_schedule(self._tok)
            fn, args = self._decode_paged, (self.params, *self.kv.kernel_inputs(), tok)
        elif self._decode_plan is not None:
            mask = torch.zeros((self.kv.max_batch,), dtype=torch.bool)
            mask[list(self._active)] = True
            fn, args = self._plan_decode, (self.kv.cache, tok[:, 0], mask)
        else:
            fn, args = self._decode, (self.params, self.kv.cache, tok)
        if st is not None:
            st.lap("decode.launch", kind="launch")
        logits, state = fn(*args)
        if self.kv_layout == "paged":
            self.kv.pool = state
        elif self._decode_plan is None:
            self.kv.cache = state
        if st is not None:
            st.lap("decode.wait", kind="wait")
        self._sync()
        if st is not None:
            st.close(st.close())  # decode.wait, then the decode at the same instant
        return logits

    def _spec_step(self) -> None:
        """One draft → verify round over the full pool. The drafter
        proposes K tokens a row; ONE verify forward over [max_batch, K+1]
        gives each position's target logits; greedy-equivalence acceptance
        commits each row's matched draft prefix plus the corrected argmax
        token, so the stream is the plain greedy one token for token. Then
        the pools rewind the rejected tail (slot lengths in one update,
        paged rows releasing their unneeded tail blocks) and a stateful
        drafter rolls back by the same per-row vector. K is the live depth
        (``spec.k`` is its ceiling)."""
        K = self._live_k
        st = self._st
        t_start = time.perf_counter()
        if st is not None:
            st.lap("draft", t_start, k=K)
        drafts = self._drafter.propose(self._active, self._tok)
        t_draft = time.perf_counter()
        if st is not None:
            st.lap("verify", t_draft, k=K)
        self.stats.draft_ms.append((t_draft - t_start) * 1e3)
        host_in = np.concatenate([self._tok[:, None], np.asarray(drafts, np.int64)], axis=1)
        tokens_in = torch.from_numpy(host_in).to(self.device)
        self.widths["verify"][K + 1] += 1
        if self.kv_layout == "paged":
            for row in self._active:
                self.kv.ensure_tail_n(row, K + 1)
            self._check_schedule(host_in)
            logits, self.kv.pool = self._launch(
                self._verify_paged, self.params, *self.kv.kernel_inputs(), tokens_in)
        else:
            logits, self.kv.cache = self._launch(
                self._verify, self.params, self.kv.cache, tokens_in)
        t = time.perf_counter()
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()  # [max_batch, K+1]
        now = time.perf_counter()
        self.stats.verify_ms.append((now - t_draft) * 1e3)
        if st is not None:
            st.waited(t)
            st.lap("commit", now)
        self.stats.spec_k = K
        self.stats.spec_steps += 1

        # acceptance: commit the matched prefix and the corrected token
        rej = np.full((self.kv.max_batch,), K + 1, np.int32)
        for row, req in list(self._active.items()):
            d, g = drafts[row], greedy[row]
            a = 0
            while a < K and d[a] == g[a]:
                a += 1
            self.stats.spec_proposed += K
            self.stats.spec_accepted += a
            done = False
            for t in [int(t) for t in d[:a]] + [int(g[a])]:
                req.tokens.append(t)
                if len(req.tokens) >= req.max_new_tokens or t == req.eos_id:
                    done = True
                    break
            if done:
                # budget or EOS mid-stream: the row retires, its junk tail
                # (and, paged, all its blocks) goes with it
                self._retire(req, self._clock())
            else:
                self._tok[row] = req.tokens[-1]
                # valid new rows: the pending token and a accepted drafts
                # (the corrected token is pending, not cached)
                rej[row] = K - a
                if self.kv_layout == "paged":
                    self.kv.advance_n(row, K + 1)
                    self.kv.truncate_row(row, K - a)
        if self.kv_layout != "paged":
            # dead and retired rows rewind the whole verify width, so their
            # lengths return to the value before the verify
            self.kv.truncate_rows(rej)
        self._drafter.rollback(rej)

    def _admit_phase(self, now: float) -> bool:
        """Admit arrived requests, highest priority first, preempting a
        strictly lower-priority live row when the pool is dry. It ends:
        each admission takes capacity, and each preemption strictly raises
        the live set's priorities. A controller-set ``_admit_budget`` caps
        the admissions a step (back-pressure under preemption churn);
        ``None`` is unlimited."""
        admitted = False
        n_admitted = 0
        budget = self._admit_budget
        while True:
            if budget is not None and n_admitted >= budget:
                return admitted
            arrived = [r for r in self._queue if r.arrival_time <= now]
            if not arrived:
                return admitted
            head = arrived[0]
            if self.kv_layout == "paged":
                if self._try_admit_paged(head, now):
                    self._queue.remove(head)
                    admitted = True
                    n_admitted += 1
                    continue
            else:
                wave = arrived[: self.kv.n_free]
                if budget is not None:
                    wave = wave[: budget - n_admitted]
                if wave:
                    for r in wave:
                        self._queue.remove(r)
                    if self.chunk_size is not None:
                        for r in wave:
                            self._start_chunk_slot(r, now)
                    else:
                        self._admit(wave, now)
                    admitted = True
                    n_admitted += len(wave)
                    continue
            if not self._maybe_preempt(head):
                return admitted

    def _prefill_phase(self) -> bool:
        """Spend at most ``chunk_size`` prompt tokens of chunked prefill,
        highest-priority request first: each slice is one
        ``prefill_chunk`` call padded to its pow2 width (≤ chunk_size),
        halved while it would overrun the row. A prompt that completes
        installs into the pool and samples its first token this step."""
        if not self._chunking:
            return False
        budget = self.chunk_size
        while budget > 0 and self._chunking:
            row, st = min(self._chunking.items(), key=lambda it: self._queue_key(it[1].req))
            n = min(budget, len(st.prompt) - st.pos)
            W = prefill_bucket(n, self.chunk_size)
            while st.pos + W > self.max_seq:  # the pad rows would overrun the row
                W //= 2
            n = min(n, W)
            toks = np.zeros((1, W), np.int64)
            toks[0, :n] = st.prompt[st.pos : st.pos + n]
            self.widths["chunk"][W] += 1
            logits, st.cache = self._launch(
                self._prefill_chunk, self.params, st.cache,
                torch.from_numpy(toks).to(self.device), [n])
            self._count_prefill(st.req, n, W)
            st.pos += n
            budget -= n
            if self._ton:
                self.tel.tracer.async_instant("prefill-chunk", st.req.rid, "request",
                                              args={"n": n, "pos": st.pos, "of": len(st.prompt)})
            if st.pos == len(st.prompt):
                del self._chunking[row]
                self._install_chunked(st, row, logits[0, n - 1])
        if self._ton:
            # the share of the step's token budget spent: sustained < 1
            # with a queue means admission, not chunk work, is the limit
            self._s_chunk_util.append((self.chunk_size - budget) / self.chunk_size)
        return True

    def _install_chunked(self, st: _ChunkState, row: int, logits_row) -> None:
        """A fully chunked prompt lands in the pool: paged rows write their
        fresh blocks (prefix-hit blocks are shared and stay) and register
        the prompt in the trie now that its blocks hold KV; slotted rows
        install the whole dense cache."""
        if self.kv_layout == "paged":
            self.kv.write_prefill(row, st.cache, skip_blocks=st.skip_blocks)
            self.kv.register_prompt(row, tuple(int(t) for t in st.prompt))
        else:
            self.kv.write(row, st.cache)
        self._storage.give_back(self.model, self.max_seq, st.cache)
        self._arm(st.req, row, logits_row)

    def prime(self) -> None:
        """Compile the chunked-prefill family: one chunk at each pow2 width
        W ≤ ``chunk_size`` on each of ``max_batch`` staging caches (as many
        as can be in flight: one a row), so a primed scheduler captures no
        chunk step mid-run. The family is closed: every slice
        ``_prefill_phase`` can emit pads to one of these widths
        (``primed_widths``). The staging caches go back to the free list;
        on an engine's storage this warms every later scheduler of the
        engine too. No-op without chunking."""
        if self.chunk_size is None:
            return
        caches = [self._storage.staging(self.model, self.max_seq)
                  for _ in range(self.kv.max_batch)]
        W = 1
        while W <= self.chunk_size:
            toks = torch.zeros((1, W), dtype=torch.long, device=self.device)
            for cache in caches:
                self._prefill_chunk(self.params, cache, toks, [W])
            self.primed_widths.add(W)
            W *= 2
        for cache in caches:
            self._storage.give_back(self.model, self.max_seq, cache)
        self._sync()

    def _finish_step(self, st: StepTrace) -> None:
        """Telemetry's step boundary (reached only with the recorder on):
        the step's spans into the tracer, the queue and pool gauges, the
        retrace watch (the step families' compile counts: growth is a
        retrace), and one registry tick so every counter lands in its
        window ring. Host bookkeeping only, no device synchronise beyond the
        step's own."""
        self._st = None
        self._step_seq += 1
        st.end(active=len(self._active), queued=len(self._queue))
        self._g_queue.set(len(self._queue))
        self._g_active.set(len(self._active))
        self._g_occ.set(self.kv.occupancy)
        if self.kv_layout == "paged":
            self._g_free_blocks.set(self.kv.n_free_blocks)
        size = cache_size(self._traced_fns)
        if size > self._cache_size_seen:
            self._c_retraces.inc(size - self._cache_size_seen)
            self.tel.tracer.instant("retrace", "sched", args={"new": size - self._cache_size_seen})
        self._cache_size_seen = size
        self.stats.registry.tick()

    def step(self, now: Optional[float] = None) -> bool:
        """Admit arrived requests, spend the chunked-prefill budget, then
        run one batched decode (or one speculation round) over the live
        set. Returns False when there was nothing to do. ``step_ms``
        covers the whole step, so prefill stalls show in the tail they
        cause. With a controller attached, every working step also
        advances the observe → decide → apply loop (after the telemetry
        tick, so the decision prices a window that holds this step)."""
        try:
            did = self._step_inner(now)
        finally:
            if self._st is not None:  # a step that did nothing, or raised
                self._st.discard()
                self._st = None
        if did and self.controller is not None:
            self._controller_tick()
        return did

    def _step_inner(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = self._clock()
        if self._mesh is not None:
            # one clock for the whole mesh: admission reads it
            now = collectives.mesh_broadcast_value(now, self._mesh)
        st = None
        if self._ton:
            st = self._st = StepTrace(self.tel.tracer, self._step_seq + 1,
                                      ranges=self.tel.profiler_annotations,
                                      events=self._step_events)
            t0 = st.open("admit", st.t)
        else:
            t0 = time.perf_counter()
        admitted = self._admit_phase(now)
        if st is not None and self.chunk_size is not None:
            st.lap("prefill_chunk")
        chunked = self._prefill_phase()
        if not self._active:
            if admitted or chunked:
                t = time.perf_counter()
                self._sync()
                if st is not None:
                    st.waited(t)
                self.stats.step_ms.append((time.perf_counter() - t0) * 1e3)
                if st is not None:
                    self._finish_step(st)
                return True
            return False
        if self.spec is not None and self._live_k > 0:
            self._spec_step()
            self.stats.step_ms.append((time.perf_counter() - t0) * 1e3)
            if st is not None:
                self._finish_step(st)
            return True
        logits = self._decode_pool()
        self.stats.step_ms.append((time.perf_counter() - t0) * 1e3)
        if st is not None:
            st.open("sample", st.t, kind="wait")
        if self.temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            nxt = {row: self._sample_row(logits[row], self._gens[row]) for row in self._active}
        if st is not None:
            st.lap("commit")
        if self.kv_layout == "paged":
            for row in self._active:
                self.kv.advance(row)
        for row, req in list(self._active.items()):
            tok = int(nxt[row])
            req.tokens.append(tok)
            self._tok[row] = tok
            if len(req.tokens) >= req.max_new_tokens or tok == req.eos_id:
                self._retire(req, self._clock())
        if st is not None:
            self._finish_step(st)
        return True

    def run(self, requests=None, *, reset_stats: bool = True) -> dict:
        """Open-loop drive to completion: submit ``requests``, admit each
        at its ``arrival_time``, decode until everything finishes. Returns
        rid → generated tokens (np.int32)."""
        if reset_stats:
            self.stats.reset()
        self._t0 = time.perf_counter()
        requests = list(requests or [])
        for r in requests:
            self.submit(r)
        while self._queue or self._active or self._chunking:
            if not self._active and not self._chunking:
                # the earliest arrival, not the queue head: the queue is in
                # priority order
                wait = min(r.arrival_time for r in self._queue) - self._clock()
                if wait > 0:
                    time.sleep(wait)
            self.step()
        return {r.rid: r.output() for r in requests}
