"""Continuous-batching scheduler over a slotted or block-paged pool.

Port of the core of the JAX package's ``serve/scheduler.py``. Each
``step()``:

  1. admits arrived queued requests: slotted admission prefills a wave of
     same-bucket prompts as one batched call (same-length prompts for the
     SSM family, whose state would integrate pads) and writes each row
     into its slot; paged admission charges blocks one request at a time and, on a
     prefix-cache hit, prefills only the un-cached suffix. The first token
     is sampled from the prefill logits (that instant is the TTFT);
  2. runs ONE batched decode over the full fixed-size row pool — dead
     rows flow through and their outputs are ignored;
  3. samples the next token per live row and retires requests that hit
     their budget or EOS, freeing their slot or blocks.

``step_ms`` times the whole step and is taken after a device
synchronise, so it measures the work and not just its launch. Driving is
open-loop: ``run()`` injects requests at their ``arrival_time``. With a
decode plan set (``set_decode_plan``; slot layout only) the decode runs
through the plan's masked executor over the whole pool, the live rows as
its mask. Chunked prefill, speculation and preemption wait for ROADMAP §1
item 6.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import PAD_PREFILL_FAMILIES, prefill_bucket
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache
from repro_torch.serve.request import DECODE, FINISHED, PREFILL, QUEUED, Request, ServeStats


def sorted_cache(tree):
    """A nested cache dict with its keys sorted at every level, as JAX's
    tree flattening orders them: the decode plan's per-request function
    and the pool it runs over then flatten to the same leaf order, however
    each cache was built (a prefill and ``init_cache`` insert keys in
    different orders)."""
    if isinstance(tree, dict):
        return {k: sorted_cache(tree[k]) for k in sorted(tree)}
    return tree


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
    ):
        self.model = model
        self.params = params
        self.device = model.device
        self.max_seq = int(max_seq)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.stats = stats if stats is not None else ServeStats()
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            if decode_plan is not None:
                raise ValueError(
                    "decode plans route through the slotted layout; "
                    "use kv_layout='slot' to serve through a RegionPlan"
                )
            self.kv = PagedKVCache(
                model, max_batch, max_seq, block_size=block_size,
                num_blocks=num_blocks, prefix_cache=prefix_cache,
            )
        else:
            self.kv = SlotKVCache(model, max_batch, max_seq)
        self.attention_backend = kernel_ops.resolve_attention_backend(
            attention_backend, self.device
        )
        # pow2 prompt-shape bucketing (pad + mask) only where pads cannot
        # change tokens; other families group prompts by exact length
        self._bucket = model.cfg.family in PAD_PREFILL_FAMILIES
        self._queue: list[Request] = []  # sorted by (arrival_time, rid)
        self._active: dict[int, Request] = {}  # row → request
        self._n_admitted = 0  # per-run admission ordinal (seeds sampling)
        self._tok = np.zeros((max_batch,), np.int64)  # pending token per row
        self._gens: dict[int, torch.Generator] = {}  # row → sampler (temperature > 0)
        self._t0: Optional[float] = None
        self._decode_plan = None
        if decode_plan is not None:
            self.set_decode_plan(decode_plan)

    # ------------------------------------------------------------------
    # plan routing (over the active-slot view)
    def set_decode_plan(self, plan) -> None:
        """Route the pool decode through an accepted ``RegionPlan`` (as
        produced by advising ``decode_region`` — stack combine only,
        since request order is externally visible). Speculation, which a
        plan excludes in the JAX package, is not ported (the engine
        refuses ``spec=``)."""
        if plan is not None and self.kv_layout == "paged":
            raise ValueError("decode plans are not supported on the paged layout")
        if plan is not None and plan.key.combine != "stack":
            raise ValueError(
                "decode plan must preserve per-request order (combine='stack')"
            )
        self._decode_plan = plan

    def _plan_decode(self, cache, tok, mask):
        """One pool decode through the plan: the per-request items (token,
        cache leaves with their batch axis first), the plan's masked
        executor over them, the new leaves put back in the cache's layout
        (dead rows zeroed, as the JAX package's masked plan leaves them)."""
        cache = sorted_cache(cache)
        leaves, spec = pytree.tree_flatten(cache)
        axes = tuple(pytree.tree_leaves(self.model.cache_batch_axes(cache)))
        items = (tok, [leaf.movedim(ax, 0) for leaf, ax in zip(leaves, axes)])
        logits, new_leaves = self._decode_plan.execute_masked(items, mask)
        new_cache = pytree.tree_unflatten(
            [leaf.movedim(0, ax).contiguous() for leaf, ax in zip(new_leaves, axes)], spec)
        return logits, new_cache

    # ------------------------------------------------------------------
    def _clock(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request) -> None:
        if req.priority != 0:
            raise NotImplementedError(
                "request priorities need preemption, which is not ported yet "
                "(ROADMAP §1 item 6)"
            )
        need = int(np.asarray(req.prompt).shape[0]) + req.max_new_tokens
        if need > self.max_seq:
            # past max_seq a cache write would land out of the row
            self.stats.rejected_submissions += 1
            raise ValueError(
                f"request {req.rid}: prompt + max_new_tokens = {need} exceeds "
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
        self._queue.sort(key=lambda r: (r.arrival_time, r.rid))

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
    def _note_admitted(self, req: Request, now: float) -> int:
        if req.t_first_admit is None:
            req.t_first_admit = now
        req.state, req.t_admit = PREFILL, now
        self._n_admitted += 1
        return self._n_admitted - 1

    def _start_decode(self, req: Request, row: int, logits_row, ordinal: int) -> None:
        """Sample the first token from the prefill logits (TTFT is this
        instant) and arm the decode row."""
        gen = self._generator(ordinal)
        tok0 = self._sample_row(logits_row, gen)
        req.t_first = self._clock()
        req.tokens.append(tok0)
        req.state = DECODE
        self._tok[row] = tok0
        self._gens[row] = gen
        self._active[row] = req
        if len(req.tokens) >= req.max_new_tokens or tok0 == req.eos_id:
            self._retire(req, self._clock())

    def _padded(self, prompts, W: int):
        mat = np.zeros((len(prompts), W), np.int64)
        for i, p in enumerate(prompts):
            mat[i, : len(p)] = p
        lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32)
        return torch.from_numpy(mat).to(self.device), lens

    def _admit(self, reqs: list, now: float) -> None:
        """Slotted admission of a wave: prompts of one pow2 bucket (of one
        length, without bucketing) prefill as ONE batched call, each row
        then written into its own slot."""
        ordinals = {r.rid: self._note_admitted(r, now) for r in reqs}
        groups: dict[int, list] = {}
        for req in reqs:
            S = int(np.asarray(req.prompt).shape[0])
            W = prefill_bucket(S) if self._bucket else S
            groups.setdefault(S if W > self.max_seq else W, []).append(req)
        for W, group in groups.items():
            toks, lens = self._padded([np.asarray(r.prompt) for r in group], W)
            logits, cache = self.model.prefill(
                self.params, toks, self.max_seq, prompt_len=lens if self._bucket else None,
                backend=self.attention_backend,
            )
            for i, req in enumerate(group):
                slot = self.kv.alloc(req.rid)
                req.slot = slot
                self.kv.write(slot, self.model.read_cache_slot(cache, i))
                self._start_decode(req, slot, logits[i], ordinals[req.rid])

    def _try_admit_paged(self, req: Request, now: float) -> bool:
        """Paged admission of one request: prefix-match the prompt, charge
        the block budget, prefill only the un-cached suffix on a hit.
        False when the row/block budget does not fit yet."""
        prompt = np.asarray(req.prompt)
        got = self.kv.try_admit(req.rid, tuple(int(t) for t in prompt), req.max_new_tokens)
        if got is None:
            return False
        row, hit_ids = got
        ordinal = self._note_admitted(req, now)
        req.slot = row
        hit = len(hit_ids) * self.kv.block_size
        req.prefix_hit = hit
        be = self.attention_backend
        if hit:
            suffix = prompt[hit:]
            W = prefill_bucket(len(suffix))
            toks, lens = self._padded([suffix], len(suffix) if hit + W > self.max_seq else W)
            pk, pv = self.kv.gather_prefix(hit_ids)
            logits, cache = self.model.prefill_with_prefix(
                self.params, toks, pk, pv, self.max_seq, suffix_len=lens, backend=be
            )
        else:
            W = prefill_bucket(len(prompt))
            toks, lens = self._padded([prompt], len(prompt) if W > self.max_seq else W)
            logits, cache = self.model.prefill(
                self.params, toks, self.max_seq, prompt_len=lens, backend=be
            )
        self.kv.write_prefill(row, cache, skip_blocks=len(hit_ids))
        self._start_decode(req, row, logits[0], ordinal)
        return True

    def _retire(self, req: Request, now: float) -> None:
        req.state, req.t_finish = FINISHED, now
        self.stats.record(req)
        if self.kv_layout == "paged":
            self.kv.free_row(req.slot)
        else:
            self.kv.free(req.slot)
        del self._active[req.slot]
        self._gens.pop(req.slot, None)

    # ------------------------------------------------------------------
    def _decode_pool(self):
        """One batched decode over the full row pool; returns the logits."""
        tok = torch.from_numpy(self._tok[:, None].copy()).to(self.device)
        if self.kv_layout == "paged":
            for row in self._active:
                self.kv.ensure_tail(row)
            pool, tables, lens = self.kv.kernel_inputs()
            logits, self.kv.pool = self.model.decode_step_paged(
                self.params, pool, tables, lens, tok, backend=self.attention_backend
            )
        elif self._decode_plan is not None:
            mask = torch.zeros((self.kv.max_batch,), dtype=torch.bool)
            mask[list(self._active)] = True
            logits, self.kv.cache = self._plan_decode(
                self.kv.cache, tok[:, 0], mask.to(self.device))
        else:
            logits, self.kv.cache = self.model.decode_step(
                self.params, self.kv.cache, tok, backend=self.attention_backend
            )
        self._sync()
        return logits

    def _admit_phase(self, now: float) -> bool:
        """Admit arrived requests in arrival order while capacity lasts."""
        admitted = False
        while True:
            arrived = [r for r in self._queue if r.arrival_time <= now]
            if not arrived:
                return admitted
            if self.kv_layout == "paged":
                if not self._try_admit_paged(arrived[0], now):
                    return admitted
                self._queue.remove(arrived[0])
            else:
                wave = arrived[: self.kv.n_free]
                if not wave:
                    return admitted
                for r in wave:
                    self._queue.remove(r)
                self._admit(wave, now)
            admitted = True

    def step(self, now: Optional[float] = None) -> bool:
        """Admit arrived requests, then run one batched decode over the
        live set. Returns False when there was nothing to do."""
        if now is None:
            now = self._clock()
        t0 = time.perf_counter()
        admitted = self._admit_phase(now)
        if not self._active:
            if admitted:
                self._sync()
                self.stats.step_ms.append((time.perf_counter() - t0) * 1e3)
            return admitted
        logits = self._decode_pool()
        self.stats.step_ms.append((time.perf_counter() - t0) * 1e3)
        if self.kv_layout == "paged":
            for row in self._active:
                self.kv.advance(row)
        if self.temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            nxt = {row: self._sample_row(logits[row], self._gens[row]) for row in self._active}
        for row, req in list(self._active.items()):
            tok = int(nxt[row])
            req.tokens.append(tok)
            self._tok[row] = tok
            if len(req.tokens) >= req.max_new_tokens or tok == req.eos_id:
                self._retire(req, self._clock())
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
        while self._queue or self._active:
            if not self._active:
                wait = min(r.arrival_time for r in self._queue) - self._clock()
                if wait > 0:
                    time.sleep(wait)
            self.step()
        return {r.rid: r.output() for r in requests}
