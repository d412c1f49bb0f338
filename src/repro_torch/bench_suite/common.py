"""Shared benchmark scaffolding + array-encoded linked data structures.

Port of the JAX package's ``bench_suite/common.py``. Each paper benchmark
provides:
  build(seed, device) → data dict (index-array encoded linked structures),
                        built by the JAX package's numpy code from the
                        same seed and put on ``device`` (CUDA unless the
                        caller asks for the CPU)
  items(data)         → leading-axis work items of one iteration
  item_fn(data)       → per-item function (the annotated region)
  cost(data)          → per-item Microtask parameters (flops, bytes, chain)
  trace(data)         → MemoryTrace of dynamic accesses (DynamoRIO analogue)
  realized_* fields   → the Relic-API granularity floor + locality penalty
                        used when a region is force-parallelized below its
                        band (paper's 1-Hop/BVH outcome)

Linked structures are index arrays; a traversal is a fixed-length Python
loop of masked steps (the JAX package's bounded ``lax.scan``), so
``vmap`` sees no data-dependent control flow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.core.relic import sum_over_items

BENCHMARKS: dict[str, "Benchmark"] = {}


def to_device(tree, device=None):
    """numpy arrays and scalars of ``tree`` → tensors on ``device``, in the
    32-bit types the JAX package's ``jnp.asarray`` gives them (float64 →
    float32, int64 → int32, wrapping as it does); other leaves stay."""
    dev = resolve_device(device)

    def leaf(x):
        if not isinstance(x, (np.ndarray, np.generic)):
            return x
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype in (np.int64, np.uint32, np.uint64):
            a = a.astype(np.int32)
        return torch.from_numpy(np.array(a)).to(dev)

    return pytree.tree_map(leaf, tree)


def gather(arr, *idx):
    """``arr[idx...]`` for integer tensor indices of any shape, a 0-dim
    one included, as one ``aten.index``: Python indexing reads a 0-dim
    index tensor as an int, which neither ``make_fx`` nor a traversal
    that must stay on the device can take."""
    return torch.ops.aten.index.Tensor(arr, list(idx))


@dataclass
class Benchmark:
    name: str
    domain: str
    build: Callable
    items: Callable
    item_fn: Callable
    cost: Callable  # data -> dict(flops, bytes, chain, vector)
    trace: Optional[Callable] = None
    combine: str = "sum"
    # paper §VII outcome modeling:
    force: bool = False  # 1-Hop/BVH: applied despite the band
    realized_granularity: int = 0  # Relic API floor when forced (0 = free)
    locality_penalty: float = 0.0  # chain/bytes inflation when forced

    def region(self, data, combine: str | None = None):
        """The benchmark's annotated region, ready for the tool pipeline.
        combine=None → the benchmark's declared combine mode."""
        from repro_torch.core.adviser import Region

        c = self.cost(data)
        return Region(
            name=self.name,
            fn=self.item_fn(data),
            items=self.items(data),
            task_flops=c["flops"],
            task_bytes=c["bytes"],
            task_chain=c["chain"],
            vector=c.get("vector", True),
            trace=self.trace(data) if self.trace else None,
            force=self.force,
            combine=self.combine if combine is None else combine,
        )

    def workload(self, data, combine: str | None = None):
        from repro_torch.core.adviser import Workload

        return Workload(
            name=self.name,
            serial_fn=lambda: self.serial_value(data, combine=combine),
            regions=[self.region(data, combine=combine)],
        )

    def serial_value(self, data, combine: str | None = None, limit: int | None = None):
        """One measurement iteration, serial semantics: the per-item
        function on one item after another (the first ``limit`` items
        only, where given). combine="sum" reduces per-item results the way
        the declared region does."""
        fn = self.item_fn(data)
        its = self.items(data)
        n = pytree.tree_leaves(its)[0].shape[0]
        n = n if limit is None else min(n, limit)
        outs = [fn(pytree.tree_map(lambda a: a[i], its)) for i in range(n)]
        out = pytree.tree_map(lambda *ys: torch.stack(ys), *outs)
        if combine == "sum":
            return pytree.tree_map(sum_over_items, out)
        return out

    def parallel_value(self, data, granularity=8, combine: str | None = None):
        """The restructured iteration, through the cached plan layer.

        combine=None → "stack" (item order preserved, elementwise-
        comparable to serial_value)."""
        from repro_torch.core import plan as plan_mod

        plan = plan_mod.plan_for(
            self.name,
            self.item_fn(data),
            self.items(data),
            granularity=granularity,
            combine=combine or "stack",
            salt=plan_mod.data_fingerprint(data),
        )
        return plan.execute(self.items(data))


def register(b: Benchmark) -> Benchmark:
    BENCHMARKS[b.name] = b
    return b


# ---------------------------------------------------------------------------
# array-encoded structures (numpy build side, copied)


def build_kdtree(points: np.ndarray):
    """Balanced KD-tree as arrays: returns dict(point, left, right, axis)."""
    n = len(points)
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    axis = np.zeros(n, np.int32)
    pts = np.asarray(points)
    order = np.empty(n, np.int32)  # tree-node id -> point id
    slot = [0]

    def rec(idx, depth):
        if len(idx) == 0:
            return -1
        ax = depth % pts.shape[1]
        idx = idx[np.argsort(pts[idx, ax], kind="stable")]
        mid = len(idx) // 2
        me = slot[0]
        slot[0] += 1
        order[me] = idx[mid]
        axis[me] = ax
        l = rec(idx[:mid], depth + 1)
        r = rec(idx[mid + 1 :], depth + 1)
        left[me], right[me] = l, r
        return me

    root = rec(np.arange(n, dtype=np.int64), 0)
    return {
        "point": pts[order],
        "left": left,
        "right": right,
        "axis": axis,
        "root": np.int32(root),
        "perm": order,
    }


def build_bst(keys: np.ndarray, values: np.ndarray):
    """Balanced BST over sorted keys (arrays left/right/key/value)."""
    order = np.argsort(keys)
    keys, values = np.asarray(keys)[order], np.asarray(values)[order]
    n = len(keys)
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    okey = np.empty_like(keys)
    oval = np.empty_like(values)
    slot = [0]

    def rec(lo, hi):
        if lo >= hi:
            return -1
        mid = (lo + hi) // 2
        me = slot[0]
        slot[0] += 1
        okey[me], oval[me] = keys[mid], values[mid]
        left[me] = rec(lo, mid)
        right[me] = rec(mid + 1, hi)
        return me

    root = rec(0, n)
    return {"key": okey, "value": oval, "left": left, "right": right, "root": np.int32(root)}


def build_linked_lists(rng, n_lists: int, min_len: int, max_len: int):
    """Pool of singly linked lists: head[i] → chain via nxt, payload val."""
    lens = rng.integers(min_len, max_len + 1, n_lists)
    total = int(lens.sum())
    nxt = np.full(total, -1, np.int32)
    val = rng.normal(size=total).astype(np.float32)
    head = np.zeros(n_lists, np.int32)
    pos = 0
    perm = rng.permutation(total).astype(np.int32)  # scatter nodes (cache-hostile)
    for i, L in enumerate(lens):
        ids = perm[pos : pos + L]
        head[i] = ids[0]
        for a, b in zip(ids[:-1], ids[1:]):
            nxt[a] = b
        pos += L
    return {"head": head, "nxt": nxt, "val": val, "len": lens.astype(np.int32)}


# ---------------------------------------------------------------------------
# traversals (torch side): fixed-length loops of masked steps


def bst_lookup(bst, key, depth: int):
    """Fixed-depth BST search: the node id holding ``key``, or -1."""
    node, found = bst["root"], None
    for _ in range(depth):
        nv = torch.clamp(node, min=0)
        k = gather(bst["key"], nv)
        nxt = torch.where(key < k, gather(bst["left"], nv), gather(bst["right"], nv))
        keep = torch.where((node >= 0) & (k == key), node, -1)
        found = keep if found is None else torch.maximum(found, keep)
        node = torch.where(node < 0, node, nxt)
    return found


def list_sum(lists, head, max_hops: int):
    """Traverse one linked list, summing payloads (dependent loads)."""
    node = head
    acc = torch.zeros((), dtype=lists["val"].dtype, device=lists["val"].device)
    for _ in range(max_hops):
        nv = torch.clamp(node, min=0)
        live = node >= 0
        v = torch.where(live, gather(lists["val"], nv), 0.0)
        node = torch.where(live, gather(lists["nxt"], nv), -1)
        acc = acc + v
    return acc
