"""Relic runtime analogue: fine-grained microtask partitioning + paired
stream co-scheduling, expressed in PyTorch.

Port of the JAX package's ``core/relic.py``. The original Relic [Los &
Petushkov 2024] is a task-parallel runtime whose dispatch is cheap enough
(~100 ns) to pay off at microsecond-kernel granularity on the two
hardware threads of one SMT core. Re-expressed here:

  relic_pfor     — split an item-parallel region into `n_streams`
                   interleaved chunk streams; chunk size = the task
                   granularity. Run as ``torch.func.vmap`` over streams ×
                   a Python loop over a stream's chunks × ``vmap(fn)``
                   over a chunk's items: the same compute restructured so
                   the streams run as one batched computation. A kernel
                   the per-item function reaches must be one ``vmap`` can
                   see through (a ``torch.library`` custom op with a vmap
                   rule, as the paged decode kernel is).
  RelicSchedule  — the chosen (granularity, n_streams, strategy) + the
                   overlap model's prediction; attached to restructured
                   regions so reports can show *why* a kernel was accepted.

The 20 usage examples the paper feeds its LLM live in core/spec.py
(RELIC_EXAMPLES) and are exercised by the test suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.overlap_model import Microtask, OverlapModel, SchedulePrediction


@dataclass
class RelicSchedule:
    granularity: int
    n_streams: int
    strategy: str  # "smt2" | "smp2" | "serial"
    prediction: Optional[SchedulePrediction] = None

    def describe(self) -> str:
        p = self.prediction
        gain = f" predicted {p.gain(self.strategy)*100:+.1f}%" if p and self.strategy != "serial" else ""
        return f"{self.strategy}(gran={self.granularity}, streams={self.n_streams}){gain}"


def _masked(y, keep):
    """``y`` with the rows where ``keep`` is False zeroed (keep [n])."""
    return torch.where(keep.reshape((-1,) + (1,) * (y.dim() - 1)), y, torch.zeros_like(y))


def sum_over_items(y):
    """Sum over the item axis in y's own type, as ``jnp.sum`` keeps it
    (torch would widen an int32 sum to int64); booleans count in int32."""
    if y.dtype == torch.bool:
        return y.sum(0, dtype=torch.int32)
    return y.sum(0, dtype=y.dtype)


def relic_pfor(
    fn: Callable,
    xs,
    *,
    granularity: int,
    n_streams: int = 2,
    combine: str = "stack",
    valid=None,
):
    """Item-parallel region → co-scheduled chunk streams.

    fn: per-item function (vmap-able). xs: pytree of tensors whose leading
    axis is the items. Items are grouped into chunks of `granularity`;
    chunks are dealt round-robin to `n_streams` streams (the SMT thread
    pair); each stream processes its chunks in order (a Python loop = the
    Relic task queue), streams are batched (``torch.func.vmap`` =
    co-scheduled). Items past a multiple of streams × granularity are
    padding: copies of the last item.

    combine="stack": results in the original item order (the default).
    combine="sum": the sum of per-item results over the item axis — each
    stream accumulates its chunk partials (the Relic reduction-variable
    idiom), then partials are summed across streams; padding items are
    masked out of the sum.

    valid: optional [n_items] boolean mask for fixed-shape execution over
    a *padded active set* (a serving slot pool where only some slots hold
    live requests). Invalid items still flow through ``fn`` — the shapes
    stay fixed whatever the live count — but their rows are zeroed in
    "stack" results and excluded from "sum" reductions.
    """
    if combine not in ("stack", "sum"):
        raise ValueError(f"combine must be 'stack' or 'sum', got {combine!r}")
    leaves, spec = pytree.tree_flatten(xs)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).reshape((n,)).bool()
    g = max(1, min(granularity, n))
    n_chunks = n // g
    n_padded = n
    if n_chunks % n_streams or n % g:
        # pad items to a streams × granularity boundary with the last item
        target = ((n + g * n_streams - 1) // (g * n_streams)) * g * n_streams
        pad = target - n
        leaves = [torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]) for a in leaves]
        if valid is not None:
            valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
        n_chunks = target // g
        n_padded = target

    per_stream = n_chunks // n_streams

    def deal(a):  # [n_items, ...] → [n_streams, per_stream, g, ...] (round-robin)
        a = a.reshape((per_stream, n_streams, g) + tuple(a.shape[1:]))
        return a.transpose(0, 1)

    xs_dealt = pytree.tree_unflatten([deal(a) for a in leaves], spec)
    item_fn = torch.func.vmap(fn)

    def chunk_of(stream_chunks, p):
        return pytree.tree_map(lambda a: a[p], stream_chunks)

    if combine == "sum":
        keep = torch.arange(n_padded, device=dev) < n
        if valid is not None:
            keep = keep & valid

        def stream_sum(stream_chunks, stream_keep):
            acc = None
            for p in range(per_stream):
                ys = item_fn(chunk_of(stream_chunks, p))
                part = pytree.tree_map(lambda y: sum_over_items(_masked(y, stream_keep[p])), ys)
                if acc is None:
                    acc = pytree.tree_map(torch.zeros_like, part)
                acc = pytree.tree_map(torch.add, acc, part)
            return acc

        partials = torch.func.vmap(stream_sum)(xs_dealt, deal(keep))  # co-scheduled streams
        return pytree.tree_map(sum_over_items, partials)

    def stream_fn(stream_chunks):  # the sequential task queue of one stream
        ys = [item_fn(chunk_of(stream_chunks, p)) for p in range(per_stream)]
        return pytree.tree_map(lambda *y: torch.stack(y), *ys)

    ys = torch.func.vmap(stream_fn)(xs_dealt)  # co-scheduled streams

    def undeal(a):  # [streams, per_stream, g, ...] → [n_items, ...]
        a = a.transpose(0, 1).reshape((n_chunks * g,) + tuple(a.shape[3:]))
        return a[:n]

    ys = pytree.tree_map(undeal, ys)
    if valid is not None:
        live = valid[:n]
        ys = pytree.tree_map(lambda y: _masked(y, live), ys)
    return ys


def choose_schedule(
    model: OverlapModel,
    task_flops: float,
    task_bytes: float,
    n_items: int,
    *,
    chain: int = 0,
    vector: bool = False,
    granularities=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    strategies=("smt2",),
) -> RelicSchedule:
    """Pick the best (granularity, strategy) under the overlap model —
    what the paper's LLM does with the Sniper tool output. The default
    strategy set is smt2 only: the paper's premise is that the heavy
    threads of a latency-critical app own the physical cores, so only
    the sibling hardware thread is available (pass smp2 to widen).
    Granularity is capped at n/4 so at least two tasks per stream exist
    to pipeline."""
    best = None
    for g in granularities:
        if g > max(1, n_items // 4):
            break
        t = Microtask(task_flops * g, task_bytes * g, chain=chain * g, vector=vector)
        p = model.predict(t, max(1, n_items // g))
        for strat in strategies:
            tt = getattr(p, strat)
            if best is None or tt < best[0]:
                best = (tt, g, strat, p)
    tt, g, strat, p = best
    if p.serial <= tt:
        return RelicSchedule(granularity=n_items, n_streams=1, strategy="serial", prediction=p)
    return RelicSchedule(granularity=g, n_streams=2, strategy=strat, prediction=p)
