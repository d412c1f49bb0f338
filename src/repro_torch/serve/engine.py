"""Continuous-batching serving engine: the facade over the serving core.

Port of the JAX package's ``serve/engine.py``: ``serve()`` is the
open-loop entry, ``generate()`` the fixed-batch wrapper, both driving a
``Scheduler`` over a slotted or block-paged pool; ``decode_region()`` and
``set_decode_plan()`` make the decode step an Aira region whose accepted
``RegionPlan`` the slot layout's decode then runs through (``relic_pfor``
over the requests, the paged kernel folded across them by its vmap
rule). ``spec=SpecConfig(...)`` speculates K draft tokens a verify and
``chunk_size`` chunks prefill (``0`` forces monolithic for one call),
both as engine defaults or per call; requests carry priorities, and a
higher-priority arrival preempts. ``telemetry=Telemetry(enabled=True)``
records the flight recorder's trace and ticks the windowed metrics;
``controller=OnlineAdviser(...)`` (or ``PinnedController``) re-decides
the speculation depth, the attention backend and admission live, priced
on those windows, after ``prime()`` has measured the K × backend grid.
The engine runs on the model's device, CUDA unless the caller asks for
the CPU.

``mesh=`` (a ``DeviceMesh`` from ``launch/mesh.py``; on the constructor,
or on a first ``serve()``) serves on the paged layout sharded over the
mesh: every rank of the mesh builds the same engine and makes the same
calls. Each rank holds the whole parameters and its shard of the block
pool (kv heads over ``"model"``, blocks over ``"seq"``), runs the same
unsharded prefill and writes its shard of the new KV, and runs the decode
and verify steps through ``Model.sharded_paged_step``. The schedule is
replicated: each step, rank 0's clock is broadcast (and, with a
controller, rank 0's decision), and the block tables, lengths and tokens
are hashed across the ranks, which raises on divergence. A mesh whose
``"model"`` axis does not divide the heads falls back to replicated
serving, warned once (``mesh_fallbacks``); the slot layout is refused.

As in the reference, the engine owns its compiled step families, built
lazily per backend through ``Model.jit_step`` and shared by every
scheduler it makes (``_step_fns``, ``_paged_fns``, ``_spec_fns``): on the
card each step shape is a CUDA graph captured once and replayed, and
``prime()`` times its grid through the same families, so after it the
serving shapes are captured. The graphs bind the addresses of the state
they run on, so the engine also owns that state (``StateStorage``): every
``serve()`` and ``prime()`` reuses the same pools, slot caches, staging
caches and draft caches.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel.sharding import ShardingRules, mesh_shape
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache, StateStorage
from repro_torch.serve.request import Request, ServeStats  # noqa: F401 (re-export)
from repro_torch.serve.scheduler import Scheduler, sorted_cache
from repro_torch.serve.telemetry import TID_BACKEND, get_telemetry

log = logging.getLogger("repro_torch.serve")


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_seq: int,
        temperature: float = 0.0,
        max_batch: Optional[int] = None,
        kv_layout: str = "slot",
        block_size: int = 8,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        attention_backend: Optional[str] = None,
        device=None,
        decode_plan=None,
        spec=None,
        chunk_size=None,
        mesh=None,
        telemetry=None,
    ):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(
                f"engine device {self.device} differs from the model's {model.device}"
            )
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self.max_batch = max_batch  # default pool size for serve()
        self.kv_layout = kv_layout  # default layout for serve()/scheduler()
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefix_cache = prefix_cache
        self.spec = spec  # default SpecConfig for serve()/scheduler()
        self.chunk_size = chunk_size  # default chunked-prefill token budget
        # flight recorder and windowed metrics, shared by every scheduler
        # this engine makes; the default is the module global, disabled
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self.stats = ServeStats()
        # the serving mesh, or None after the warned GQA fallback (once per
        # (cfg, mesh); repeated serve(mesh=) calls keep one record)
        self._mesh_warned: set = set()
        self.mesh_fallbacks: list[str] = []
        self.mesh = self._check_mesh(mesh)
        self.attention_backend = kernel_ops.resolve_attention_backend(
            attention_backend, self.device, mesh=self.mesh
        )
        # the compiled step families, per backend, shared by every
        # scheduler this engine makes, and the state storage they bind
        self._steps: dict[str, dict] = {}
        self._drafts: dict = {}  # (draft model, backend) → its decode and prefill
        self._storage = StateStorage()
        self._plan_steps: dict = {}  # (plan key, pool size) → compiled plan step
        self._prefill = self._step_fns(self.attention_backend)["prefill"]
        self._decode_plan = None
        if decode_plan is not None:
            self.set_decode_plan(decode_plan)

    def _check_mesh(self, mesh):
        """The engine's serving mesh, or None after the loud GQA fallback:
        head counts the ``"model"`` axis does not divide make
        ``ShardingRules`` drop the head mapping, and the engine serves
        replicated — warned, never silent, never wrong tokens. A pure
        ``"seq"`` mesh always passes (it splits blocks, not heads). The
        record is kept once on ``mesh_fallbacks`` and warned once per
        (cfg, mesh)."""
        if mesh is None or mesh_shape(mesh).get("model", 1) == 1:
            return mesh
        cfg = self.model.cfg
        rules = ShardingRules(mesh, cfg)
        tp = mesh_shape(mesh)["model"]
        if rules.table["kv_heads"] is None or cfg.n_heads % tp:
            record = (f"kv_heads:{cfg.n_kv_heads}/heads:{cfg.n_heads} ∤ mesh "
                      f"model({tp}); serving replicated")
            if record not in self.mesh_fallbacks:
                self.mesh_fallbacks.append(record)
                if self.telemetry.enabled:
                    self.telemetry.count("serve.mesh_fallbacks", registry=self.stats.registry)
                    self.telemetry.tracer.instant("mesh-fallback", "backend", tid=TID_BACKEND,
                                                  args={"record": record})
            rules.fallbacks.append(record)
            key = (id(cfg), tuple(sorted(mesh_shape(mesh).items())))
            if key not in self._mesh_warned:
                self._mesh_warned.add(key)
                log.warning(
                    "serving mesh dropped: n_kv_heads=%d/n_heads=%d do not divide mesh axis "
                    "'model' (size %d) — serving replicated (ShardingRules fallbacks: %s)",
                    cfg.n_kv_heads, cfg.n_heads, tp, rules.fallbacks)
            return None
        return mesh

    # ------------------------------------------------------------------
    # the compiled step families
    def _paged_step(self, name: str, backend: str):
        """A paged step of ``backend``: this rank's shard of it on a mesh."""
        if self.mesh is not None:
            return self.model.sharded_paged_step(name, self.mesh, backend)
        return self.model.jit_step(name, backend)

    def _step_fns(self, backend: str) -> dict:
        """The step family of ``backend``, built lazily (only attention
        families page, only SPEC_FAMILIES verify) and kept per backend."""
        fns = self._steps.setdefault(backend, {})
        if "decode" not in fns:
            fns["decode"] = self.model.jit_step("decode_step", backend)
            fns["prefill"] = self.model.jit_step("prefill", backend)
        return fns

    def _paged_fns(self, backend: str):
        """(paged decode, prefix prefill) of ``backend``."""
        fns = self._step_fns(backend)
        if "decode_paged" not in fns:
            fns["decode_paged"] = self._paged_step("decode_step_paged", backend)
            fns["prefill_prefix"] = self.model.jit_step("prefill_with_prefix", backend)
        return fns["decode_paged"], fns["prefill_prefix"]

    def _spec_fns(self, layout: str, backend: str):
        """(slot verify, paged verify or None) of ``backend``."""
        fns = self._step_fns(backend)
        if "verify" not in fns:
            fns["verify"] = self.model.jit_step("verify_step", backend)
        if layout == "paged" and "verify_paged" not in fns:
            fns["verify_paged"] = self._paged_step("verify_step_paged", backend)
        return fns["verify"], fns.get("verify_paged")

    def _chunk_fn(self, backend: str):
        fns = self._step_fns(backend)
        if "prefill_chunk" not in fns:
            fns["prefill_chunk"] = self.model.jit_step("prefill_chunk", backend)
        return fns["prefill_chunk"]

    def _draft_fns(self, model, backend: str) -> dict:
        """A model drafter's compiled decode and prefill, kept per (draft
        model, backend) so that every serve replays the same draft steps."""
        fns = self._drafts.get((model, backend))
        if fns is None:
            fns = self._drafts[(model, backend)] = {
                "decode": model.jit_step("decode_step", backend),
                "prefill": model.jit_step("prefill", backend)}
        return fns

    def _family(self, backend: str, layout: str, spec, chunk) -> dict:
        """What a scheduler serving ``layout`` (with ``spec`` and
        ``chunk``) runs on ``backend``: its resolver, so that a live backend
        switch lands in this engine's families, which ``prime()`` warms."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device, mesh=self.mesh)
        fns = self._step_fns(backend)
        out = {"backend": backend, "prefill": fns["prefill"], "decode": fns["decode"],
               "draft": lambda model: self._draft_fns(model, backend)}
        if layout == "paged":
            out["decode_paged"], out["prefill_prefix"] = self._paged_fns(backend)
        if spec is not None and spec.k > 0:
            out["verify"], out["verify_paged"] = self._spec_fns(layout, backend)
        if chunk:
            out["prefill_chunk"] = self._chunk_fn(backend)
        return out

    def scheduler(
        self,
        max_batch: int,
        *,
        seed: int = 0,
        kv_layout: Optional[str] = None,
        attention_backend: Optional[str] = None,
        spec=None,
        chunk_size=None,
        telemetry=None,
        controller=None,
    ) -> Scheduler:
        """A fresh scheduler over ``max_batch`` rows sharing this
        engine's stats; ``kv_layout``, ``attention_backend``, ``spec``
        (``SpecConfig(k=0)`` disables), ``chunk_size`` (``0`` disables)
        and ``telemetry`` override the engine defaults for it. The
        scheduler runs this engine's compiled step families of its backend
        and serves on this engine's state storage (its own, while another
        live scheduler holds that). ``controller`` attaches an online
        adviser that re-decides K, the backend and admission from the windowed
        telemetry mid-run; when it carries positive depths and no
        ``spec`` covers them, an n-gram ``SpecConfig(k=max(ks))`` (or the
        given spec at that depth) sizes the margin and the drafter for
        the deepest arm."""
        spec = spec if spec is not None else self.spec
        chunk = chunk_size if chunk_size is not None else self.chunk_size
        if controller is not None:
            ctl_ks = tuple(getattr(controller, "ks", (0,)))
            kmax = max(ctl_ks) if ctl_ks else 0
            if kmax > 0 and (spec is None or spec.k < kmax):
                from repro_torch.serve.speculative import SpecConfig

                spec = (SpecConfig(k=kmax, drafter="ngram") if spec is None
                        else dataclasses.replace(spec, k=kmax))
        layout = kv_layout or self.kv_layout
        if self.mesh is not None and layout != "paged":
            raise ValueError(
                "a serving mesh shards the paged block pool; the slotted layout has no "
                "head-partitioned storage — use kv_layout='paged' (or build the engine "
                "without mesh=)"
            )
        chunk = int(chunk) if chunk else None
        return Scheduler(
            self.model,
            self.params,
            max_batch=max_batch,
            max_seq=self.max_seq,
            temperature=self.temperature,
            stats=self.stats,
            seed=seed,
            kv_layout=layout,
            block_size=self.block_size,
            num_blocks=self.num_blocks,
            prefix_cache=self.prefix_cache,
            attention_backend=attention_backend or self.attention_backend,
            decode_plan=self._decode_plan,
            spec=spec,
            chunk_size=chunk,
            telemetry=telemetry if telemetry is not None else self.telemetry,
            controller=controller,
            step_fns=lambda b: self._family(b, layout, spec, chunk),
            storage=self._storage,
            mesh=self.mesh,
            plan_step_cache=self._plan_steps,
        )

    def serve(
        self,
        requests,
        *,
        max_batch: Optional[int] = None,
        seed: int = 0,
        kv_layout: Optional[str] = None,
        attention_backend: Optional[str] = None,
        spec=None,
        chunk_size=None,
        mesh=None,
        telemetry=None,
        controller=None,
    ) -> dict:
        """Continuous-batching entry: drive ``requests`` (each with its
        own arrival time, prompt, budget and priority) to completion,
        optionally speculating (``spec``), chunking prefill
        (``chunk_size``; ``0`` forces monolithic), recording a trace
        (``telemetry``) and closed-loop controlled (``controller``; see
        ``scheduler()``, and run ``prime()`` first so the first decision
        prices measured cells). ``mesh`` must be the engine's serving mesh;
        on an engine without one it adopts it, provided no paged step was
        built yet (a mesh the GQA fallback drops adopts nothing, and warns
        once). Returns rid → generated tokens."""
        if mesh is not None and mesh is not self.mesh:
            if self.mesh is not None:
                raise ValueError(
                    "serve(mesh=) differs from the engine's mesh — the sharded step family "
                    "is built against the constructor mesh; create one engine per mesh"
                )
            checked = self._check_mesh(mesh)
            if checked is not None:
                if any("decode_paged" in f or "verify_paged" in f for f in self._steps.values()):
                    raise ValueError(
                        "serve(mesh=) after paged steps were built without a mesh — pass "
                        "mesh= to the ServingEngine constructor instead"
                    )
                self.mesh = checked
                self.attention_backend = kernel_ops.resolve_attention_backend(
                    self.attention_backend, self.device, mesh=self.mesh)
        backend = kernel_ops.resolve_attention_backend(
            attention_backend or self.attention_backend, self.device)
        if self._decode_plan is not None and backend != self.attention_backend:
            # the plan's per-request fn captured the engine backend when the
            # region was advised; honouring another per-call backend here
            # would silently run (and mislabel) the old one
            raise ValueError(
                f"attention_backend={backend!r} cannot override a decode plan advised "
                f"under {self.attention_backend!r} — re-advise decode_region() on an "
                "engine built with that backend"
            )
        requests = list(requests)
        mb = max_batch or self.max_batch or max(1, min(8, len(requests)))
        return self.scheduler(
            mb, seed=seed, kv_layout=kv_layout, attention_backend=attention_backend,
            spec=spec, chunk_size=chunk_size, telemetry=telemetry, controller=controller,
        ).run(requests)

    def prime(
        self,
        max_batch: Optional[int] = None,
        *,
        ks=(0, 2, 4, 8),
        backends=None,
        kv_layout: Optional[str] = None,
        reps: int = 2,
    ) -> dict:
        """Compile and measure the K × backend grid an online controller
        switches across: for each backend, the plain decode (K = 0) and the
        verify at each positive K (``[max_batch, K+1]`` tokens), through
        this engine's step families, so after it every switch replays a
        captured graph. Each cell is the mean of ``reps`` calls after one
        untimed first call (the warm-up and the capture), over the engine's
        own pool for ``max_batch`` rows with every row dead (writes land in
        the null block or junk rows; the next scheduler on that pool takes
        it zeroed). Each call is followed by a device synchronise, so a
        cell is the work and not its launch.
        ``max_batch`` should match the pool size later serves use. Depths
        clamp to ``(0,)`` for families without a rewindable cache.
        Returns ``{"cells": {backend: {k: ms}}, "ks", "backends",
        "max_batch", "layout"}`` — feed it to
        ``OnlineAdviser.seed_costs`` so the first decision prices measured
        numbers."""
        from repro_torch.models.model import SPEC_FAMILIES

        mb = int(max_batch or self.max_batch or 4)
        layout = kv_layout or self.kv_layout
        if self.model.cfg.family not in SPEC_FAMILIES:
            ks = (0,)
        ks = tuple(sorted({int(k) for k in ks}))
        names = tuple(dict.fromkeys(
            kernel_ops.resolve_attention_backend(b, self.device)
            for b in (backends or (self.attention_backend,))))
        tok = torch.zeros((mb, 1), dtype=torch.long, device=self.device)

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def _time(fn) -> float:
            fn()  # the warm-up and the capture (not timed)
            sync()
            t0 = time.perf_counter()
            for _ in range(max(1, reps)):
                fn()
                sync()
            return (time.perf_counter() - t0) / max(1, reps) * 1e3

        cells: dict[str, dict[int, float]] = {}
        if layout == "paged":
            kv = PagedKVCache(self.model, mb, self.max_seq, block_size=self.block_size,
                              num_blocks=self.num_blocks, prefix_cache=False,
                              storage=self._storage, mesh=self.mesh)
            pool, tables, lens = kv.kernel_inputs()
        else:
            kv = SlotKVCache(self.model, mb, self.max_seq, storage=self._storage)
        for backend in names:
            per_k: dict[int, float] = {}
            if layout == "paged":
                decode, _ = self._paged_fns(backend)
                verify = self._spec_fns("paged", backend)[1] if max(ks) > 0 else None
            else:
                decode = self._step_fns(backend)["decode"]
                verify = self._spec_fns("slot", backend)[0] if max(ks) > 0 else None
            for k in ks:
                blk = tok if k == 0 else torch.zeros((mb, k + 1), dtype=torch.long,
                                                      device=self.device)
                step = decode if k == 0 else verify
                if layout == "paged":
                    per_k[k] = _time(lambda step=step, blk=blk: step(
                        self.params, pool, tables, lens, blk))
                else:
                    per_k[k] = _time(lambda step=step, blk=blk: step(self.params, kv.cache, blk))
            cells[backend] = per_k
        return {"cells": cells, "ks": ks, "backends": names, "max_batch": mb,
                "layout": layout}

    def generate(self, prompts, n_steps: int, *, seed: int = 0, patch_embeds=None) -> torch.Tensor:
        """prompts [B, S0] → generated tokens [B, n_steps] (int32, CPU):
        B requests all arriving at t=0 into a B-row pool; a VLM's
        ``patch_embeds`` [B, P, D] go with them, row i to request i."""
        prompts = np.asarray(prompts.cpu() if torch.is_tensor(prompts) else prompts)
        B = int(prompts.shape[0])
        if n_steps <= 0:
            self.stats.reset()
            return torch.zeros((B, 0), dtype=torch.int32)
        reqs = [Request(prompt=prompts[i], max_new_tokens=n_steps,
                        patch_embeds=None if patch_embeds is None else patch_embeds[i])
                for i in range(B)]
        out = self.scheduler(B, seed=seed).run(reqs)
        return torch.stack([torch.from_numpy(out[r.rid]) for r in reqs])

    # ------------------------------------------------------------------
    # the decode step as an advisable region (requests = work items)

    def _decode_cache_spec(self, cache):
        """(treespec, per-leaf batch-axis index) of the decode cache, its
        keys sorted (``sorted_cache``)."""
        cache = sorted_cache(cache)
        leaves, spec = pytree.tree_flatten(cache)
        axes = tuple(pytree.tree_leaves(self.model.cache_batch_axes(cache)))
        if len(axes) != len(leaves):
            raise ValueError("cache_batch_axes does not match the cache's leaves")
        return spec, axes

    def _per_request_decode(self, spec, axes):
        """Per-item fn over (token, batchless cache leaves): one request's
        decode step — what relic_pfor co-schedules across requests. It
        decodes through the engine's attention backend, and returns the
        new cache leaves, as the JAX package's does (the port's decode
        writes its cache in place; under vmap that cache is the item's)."""
        model, params, backend = self.model, self.params, self.attention_backend

        def fn(item):
            tok, leaves = item
            cache = pytree.tree_unflatten(
                [leaf.unsqueeze(ax) for leaf, ax in zip(leaves, axes)], spec)
            logits, new_cache = model.decode_step(
                params, cache, tok.reshape(1, 1), backend=backend)
            new_leaves = [leaf.movedim(ax, 0)[0]
                          for leaf, ax in zip(pytree.tree_leaves(new_cache), axes)]
            return logits[0], new_leaves

        return fn

    def _decode_items(self, cache, tok, axes):
        leaves = pytree.tree_leaves(sorted_cache(cache))
        return (tok, [leaf.movedim(ax, 0) for leaf, ax in zip(leaves, axes)])

    def _sample(self, logits, seed: int):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def decode_region(
        self,
        prompts,
        *,
        name: str = "serve-decode",
        seed: int = 0,
        task_flops: Optional[float] = None,
        task_bytes: Optional[float] = None,
        task_chain: int = 0,
        force: bool = False,
    ):
        """Expose one decode step as an Aira ``Region``.

        Items are the batch of concurrent requests, each a (token, its
        cache leaves) pair after prefilling ``prompts`` [B, S]. The attached
        dynamic trace records each request touching only its own cache
        slice (disjoint by construction), so the dependence stages clear
        and the overlap gate decides. ``seed`` seeds the sampled first
        token when the engine samples (temperature > 0). Default napkin
        cost: weight-streaming decode — 2·n_params FLOPs and n_params·4
        bytes per request-token (batched decode is bandwidth-bound, which
        is why the gate usually says no and latency-critical deployments
        ``force``).
        """
        from repro_torch.core.adviser import Region
        from repro_torch.core.deps import MemoryTrace

        prompts = torch.as_tensor(np.asarray(prompts.cpu() if torch.is_tensor(prompts)
                                             else prompts), device=self.device)
        logits, cache = self.model.prefill(
            self.params, prompts, self.max_seq, backend=self.attention_backend)
        tok = self._sample(logits, seed)
        spec, axes = self._decode_cache_spec(cache)
        items = self._decode_items(cache, tok, axes)
        n_params = sum(p.numel() for p in pytree.tree_leaves(self.params))
        batch = int(tok.shape[0])
        trace = MemoryTrace(
            reads=[[i] for i in range(batch)], writes=[[i] for i in range(batch)]
        )
        return Region(
            name=name,
            fn=self._per_request_decode(spec, axes),
            items=items,
            task_flops=2.0 * n_params if task_flops is None else task_flops,
            task_bytes=4.0 * n_params if task_bytes is None else task_bytes,
            task_chain=task_chain,
            vector=False,
            trace=trace,
            force=force,
        )

    def set_decode_plan(self, plan) -> None:
        """Route the decode step through an accepted ``RegionPlan`` (as
        produced by advising ``decode_region`` — stack combine). Applies
        to schedulers created from here on (masked execution over the
        active-slot view)."""
        if plan is not None and plan.key.combine != "stack":
            raise ValueError("decode plan must preserve per-request order (combine='stack')")
        self._decode_plan = plan
