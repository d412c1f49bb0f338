"""Speculative decoding: draft streams and the speculation policy.

Port of the JAX package's ``serve/speculative.py``. A cheap *draft*
stream runs ahead of the target model (``DraftSource``); one
``Model.verify_step`` forward over K+1 tokens a row accepts or rejects
its proposals under greedy equivalence; the KV pools rewind the rejected
tail (``truncate_row``). Two drafters ship:

* ``NGramDraftSource`` — prompt-lookup decoding: propose the
  continuation of the most recent earlier occurrence of the history's
  tail n-gram (prompt + generated). No second model, no device state.
* ``ModelDraftSource`` — a small draft model sharing the target's
  tokenizer space, with its own slot cache aligned row for row with the
  scheduler's pool; it decodes through the scheduler's attention
  backend (the paged kernel over the slot cache's identity-table view
  on the card).

Both are pool-shaped: ``propose`` returns ``[max_batch, K]`` over the
whole row pool (dead rows carry junk the verify routes to scratch), and
both re-depth live (``set_k``) when an online controller moves K. The
depth adviser (``advise_depth``) probe-measures a workload and lets
``core.tools.SpeculationAdvisorTool`` pick K.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DraftSource(Protocol):
    """One draft stream. All hooks are pool-shaped (see module doc)."""

    def bind(self, max_batch: int, max_seq: int) -> None:
        """Size internal state to the scheduler's row pool (called once
        per scheduler, before any propose)."""
        ...

    def on_admit(self, row: int, req) -> None:
        """A request entered decode on ``row`` (catch up on its prompt)."""
        ...

    def propose(self, active: dict, tok: np.ndarray) -> np.ndarray:
        """K draft tokens per row following ``tok`` [max_batch] (the
        pending last-committed token). Returns [max_batch, K] int32;
        rows not in ``active`` may carry anything."""
        ...

    def rollback(self, n_rejected: np.ndarray) -> None:
        """Per-row rejected-entry counts from the verify (the vector the
        KV pools truncate by); stateful drafters rewind."""
        ...


@dataclass
class SpecConfig:
    """One speculation policy: depth K plus which draft stream runs.

    ``k=0`` disables speculation (the scheduler decodes plainly);
    ``drafter`` is ``"ngram"``, ``"model"`` (needs ``draft_model`` /
    ``draft_params``) or a ``DraftSource`` instance."""

    k: int = 4
    drafter: Any = "ngram"
    ngram: tuple = (3, 2, 1)  # tail n-gram sizes tried, longest first
    draft_model: Any = None  # repro_torch.models.model.Model (drafter="model")
    draft_params: Any = None

    def make_drafter(self, attention_backend=None):
        """Build the draft stream; a model drafter decodes through
        ``attention_backend`` (the scheduler's, so that draft and target
        run the same kernel path)."""
        if self.k <= 0:
            return None
        if self.drafter == "ngram":
            return NGramDraftSource(self.k, self.ngram)
        if self.drafter == "model":
            if self.draft_model is None:
                raise ValueError("drafter='model' needs draft_model/draft_params")
            return ModelDraftSource(
                self.draft_model, self.draft_params, self.k,
                attention_backend=attention_backend,
            )
        return self.drafter


class NGramDraftSource:
    """Prompt-lookup drafter: for each live row, find the most recent
    earlier occurrence of the history's tail n-gram (longest ``ngram``
    size first) and propose the K tokens that followed it, cycle-extended
    when the match sits near the end. With no match the proposal repeats
    the last token."""

    def __init__(self, k: int, ngram=(3, 2, 1)):
        self.k = int(k)
        self.ngrams = tuple(int(n) for n in ngram)
        self._max_batch = 0

    def bind(self, max_batch: int, max_seq: int) -> None:
        self._max_batch = int(max_batch)

    def on_admit(self, row: int, req) -> None:
        pass  # the request's history is the state

    def set_k(self, k: int) -> None:
        """Re-depth the proposal window live (an online controller's K
        re-decision): the lookup is stateless, so this only resizes the
        proposals of later rounds."""
        self.k = int(k)

    def propose(self, active: dict, tok: np.ndarray) -> np.ndarray:
        out = np.zeros((self._max_batch, self.k), np.int32)
        for row, req in active.items():
            hist = np.concatenate(
                [np.asarray(req.prompt, np.int32), np.asarray(req.tokens, np.int32)]
            )
            out[row] = self._lookup(hist)
        return out

    def rollback(self, n_rejected: np.ndarray) -> None:
        pass

    def _lookup(self, hist: np.ndarray) -> np.ndarray:
        cont = None
        for n in self.ngrams:
            if len(hist) <= n:
                continue
            tail = hist[-n:]
            for j in range(len(hist) - n - 1, -1, -1):
                if np.array_equal(hist[j : j + n], tail):
                    cont = hist[j + n : j + n + self.k]
                    break
            if cont is not None and len(cont):
                break
            cont = None
        if cont is None or not len(cont):
            cont = hist[-1:]
        return np.array([cont[i % len(cont)] for i in range(self.k)], np.int32)


class ModelDraftSource:
    """K-token greedy drafter backed by a small draft model sharing the
    target's tokenizer space.

    Owns a slot decode cache aligned row for row with the scheduler's
    pool, ``max_seq + K + 1`` long for the construction depth K (the rows
    carry K+1 tokens of speculative overhang). The prompt is prefilled on admission; each
    round runs K greedy decode steps plus one catch-up step (processing
    the K-th draft, so a fully accepted round leaves no hole), and
    ``rollback`` truncates by the target pool's vector, after which the
    draft cache holds exactly the committed stream. Its decode and its
    prefill are the draft model's compiled steps (``Model.jit_step``):
    its own, or the ones ``bind(steps=)`` hands it (an engine's, kept per
    draft model), and ``bind(storage=)`` takes the cache from an engine's
    state storage, so every serve replays the same captured draft steps."""

    def __init__(self, model, params, k: int, attention_backend=None):
        from repro_torch.models.model import SPEC_FAMILIES

        if model.cfg.family not in SPEC_FAMILIES:
            raise ValueError(
                f"draft model must be a {SPEC_FAMILIES} family (rewindable "
                f"cache), got {model.cfg.family!r}"
            )
        self.model = model
        self.params = params
        self.k = int(k)
        self._k_max = int(k)  # the construction depth sizes the cache overhang
        self._decode = model.jit_step("decode_step", attention_backend)
        self._prefill = model.jit_step("prefill", attention_backend)
        self.cache = None

    def set_k(self, k: int) -> None:
        """Re-depth the draft loop live (an online controller's K
        re-decision). The cache overhang was sized for the construction
        depth, so the live depth moves within it."""
        if not 0 < int(k) <= self._k_max:
            raise ValueError(
                f"live k={k} outside (0, {self._k_max}] — the draft cache "
                f"overhang was bound for k={self._k_max}"
            )
        self.k = int(k)

    def bind(self, max_batch: int, max_seq: int, storage=None, steps=None) -> None:
        self._max_seq = int(max_seq) + self._k_max + 1  # speculative overhang
        if steps is not None:
            self._decode, self._prefill = steps["decode"], steps["prefill"]

        def make(rows):
            return lambda: self.model.init_cache(rows, self._max_seq)

        def take(key, rows):
            return make(rows)() if storage is None else storage.take(key, self, make(rows))

        self.cache = take(("draft", self.model, int(max_batch), self._max_seq), int(max_batch))
        # the catch-up prefill writes a row here before it goes into the cache
        self._stage = take(("draft-prefill", self.model, self._max_seq), 1)

    def on_admit(self, row: int, req) -> None:
        """Catch up on the request's committed history: the prompt and,
        on a resume after preemption, every generated token but the
        pending last one. Padded to its pow2 bucket (SPEC_FAMILIES are
        pad-safe)."""
        from repro_torch.models.model import prefill_bucket

        hist = np.asarray(req.prompt, np.int64)
        if len(req.tokens) > 1:
            hist = np.concatenate([hist, np.asarray(req.tokens[:-1], np.int64)])
        S = len(hist)
        W = prefill_bucket(S, self._max_seq)
        padded = np.zeros((1, W), np.int64)
        padded[0, :S] = hist
        _, cache1 = self._prefill(
            self.params, torch.from_numpy(padded).to(self.model.device), self._max_seq,
            prompt_len=torch.tensor([S], dtype=torch.int32), into=self._stage,
        )
        self.model.write_cache_slot(self.cache, cache1, row)

    def propose(self, active: dict, tok: np.ndarray) -> np.ndarray:
        from repro_torch.serve.telemetry import get_telemetry

        dev = self.model.device
        cur = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
        cache = self.cache
        out = []
        with get_telemetry().annotate("serve.draft_model"):
            for _ in range(self.k):
                logits, cache = self._decode(self.params, cache, cur[:, None])
                cur = torch.argmax(logits, dim=-1)
                out.append(cur)
            # catch-up: process the K-th draft so that a fully accepted round
            # leaves the draft cache one for one with the target's
            _, cache = self._decode(self.params, cache, cur[:, None])
        self.cache = cache
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    def rollback(self, n_rejected: np.ndarray) -> None:
        lens = self.cache["len"]
        vec = torch.as_tensor(np.asarray(n_rejected, np.int32), device=lens.device)
        self.cache["len"] = torch.clamp(lens - vec, min=0)


# ---------------------------------------------------------------------------
# depth advice (the serving analogue of advise-then-execute)


def advise_depth(
    engine,
    workload_fn,
    *,
    drafter: Any = "ngram",
    ks=(0, 2, 4, 8),
    max_batch: int = 4,
    threshold: float = 0.02,
    draft_model=None,
    draft_params=None,
    seed: int = 0,
):
    """Probe-measure this workload, then let ``SpeculationAdvisorTool``
    pick the speculation depth.

    Runs ``workload_fn()`` (a fresh request list per call — requests are
    stateful) twice through ``engine``: once plain (the K=0 decode cost)
    and once at ``max(ks)`` (draft cost, verify cost, acceptance rate),
    reading ``engine.stats``. The tool prices the expected latency per
    output token at every candidate K from those measurements —
    interpolating the verify cost between the probed depths — and gates
    on ``threshold`` predicted gain. Returns ``(SpecConfig,
    SpecMeasurement, log_line)``; ``engine.serve(spec=...)`` honours the
    decision.
    """
    from repro_torch.core.tools import SpecMeasurement, SpeculationAdvisorTool

    kmax = max(ks)
    if kmax <= 0:
        raise ValueError("ks needs at least one positive candidate depth")
    spec_kw = dict(drafter=drafter, draft_model=draft_model, draft_params=draft_params)
    engine.serve(workload_fn(), max_batch=max_batch, seed=seed, spec=SpecConfig(k=0))
    decode_ms = engine.stats.percentile(50)
    engine.serve(
        workload_fn(), max_batch=max_batch, seed=seed,
        spec=SpecConfig(k=kmax, **spec_kw),
    )
    s = engine.stats
    n_drafted = max(1, kmax * s.spec_steps)
    meas = SpecMeasurement(
        draft_ms_per_token=float(np.sum(s.draft_ms)) / n_drafted,
        verify_ms={0: decode_ms, kmax: s.percentile(50, "verify_ms")},
        acceptance_rate=s.acceptance_rate,
    )
    tool = SpeculationAdvisorTool(ks=tuple(ks))
    k, _gain, log = tool.choose(meas, threshold=threshold)
    return SpecConfig(k=k, **spec_kw), meas, log
