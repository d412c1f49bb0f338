"""A. Geo-Spatial Database System (paper §VI.A).

Port of the JAX package's ``bench_suite/geospatial.py``. KD-tree range
queries (iterative, stack-budgeted) → BST metadata lookup per hit →
per-object linked-list metric aggregation. 2048 objects in a 1000×1000
space, 15 concurrent 50×50 range queries per iteration, ≤32 hits per
query.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite import common
from repro_torch.bench_suite.common import Benchmark, gather, register, to_device
from repro_torch.core.deps import MemoryTrace

N_OBJECTS = 2048
N_QUERIES = 15
RANGE = 50.0
MAX_HITS = 32
VISIT_BUDGET = 96
BST_DEPTH = 12
LIST_HOPS = 12


def build(seed=0, device=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1000, (N_OBJECTS, 2)).astype(np.float32)
    kd = common.build_kdtree(pts)
    meta = common.build_bst(
        keys=np.arange(N_OBJECTS, dtype=np.int32),
        values=rng.integers(0, N_OBJECTS, N_OBJECTS).astype(np.int32),
    )
    lists = common.build_linked_lists(rng, N_OBJECTS, 4, LIST_HOPS - 2)
    lo = rng.uniform(0, 1000 - RANGE, (N_QUERIES, 2)).astype(np.float32)
    queries = np.concatenate([lo, lo + RANGE], axis=1)  # [Q, 4]
    data = to_device({"kd": kd, "bst": meta, "lists": lists, "queries": queries}, device)
    data["_np"] = {"kd": kd, "queries": queries}
    return data


def _range_query(kd, rect, budget=VISIT_BUDGET):
    """Stack-budgeted KD range search → (hit ids [MAX_HITS], n_hits)."""
    lo, hi = rect[:2], rect[2:]
    dev = rect.device
    stack = torch.zeros((64,), dtype=torch.int32, device=dev)
    stack = stack.index_put((torch.zeros((), dtype=torch.int64, device=dev),), kd["root"])
    sp = torch.ones((), dtype=torch.int32, device=dev)
    hits = torch.full((MAX_HITS,), -1, dtype=torch.int32, device=dev)
    nh = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(budget):
        has = sp > 0
        node = torch.where(has, gather(stack, torch.clamp(sp - 1, min=0)), -1)
        sp = torch.where(has, sp - 1, sp)
        nv = torch.clamp(node, min=0)
        pt = gather(kd["point"], nv)
        ax = gather(kd["axis"], nv)
        inside = (pt >= lo).all() & (pt <= hi).all() & (node >= 0)
        hits = torch.where(inside & (nh < MAX_HITS), hits.index_put((nh % MAX_HITS,), nv), hits)
        nh = nh + inside.to(torch.int32)
        # push children whose half-space intersects the rect
        p_ax = gather(pt, ax)
        go_l = (node >= 0) & (gather(lo, ax) <= p_ax)
        go_r = (node >= 0) & (gather(hi, ax) >= p_ax)
        l, r = gather(kd["left"], nv), gather(kd["right"], nv)
        push_l = go_l & (l >= 0)
        stack = torch.where(push_l, stack.index_put((sp,), l), stack)
        sp = sp + push_l.to(torch.int32)
        push_r = go_r & (r >= 0)
        stack = torch.where(push_r, stack.index_put((sp,), r), stack)
        sp = sp + push_r.to(torch.int32)
    return hits, torch.clamp(nh, max=MAX_HITS)


def item_fn(data):
    kd, bst, lists = data["kd"], data["bst"], data["lists"]

    def per_hit(o, v):
        node = common.bst_lookup(bst, o, BST_DEPTH)
        mv = torch.where(node >= 0, gather(bst["value"], torch.clamp(node, min=0)), 0)
        s = common.list_sum(lists, gather(lists["head"], torch.clamp(mv, max=N_OBJECTS - 1)), LIST_HOPS)
        return torch.where(v, s, 0.0)

    def fn(rect):
        hits, _ = _range_query(kd, rect)
        valid = hits >= 0
        obj = torch.where(valid, gather(kd["perm"], torch.clamp(hits, min=0)), 0)
        return torch.func.vmap(per_hit)(obj, valid).sum()

    return fn


def items(data):
    return data["queries"]


def cost(data):
    # per query: ~96 tree visits + ≤32·(12 BST + 12 list) dependent hops
    chain = VISIT_BUDGET + MAX_HITS * (BST_DEPTH + LIST_HOPS) // 2
    return dict(flops=400.0, bytes=chain * 64.0, chain=chain, vector=True)


def trace(data) -> MemoryTrace:
    """Numpy mirror of the KD walk: records visited node ids per query
    (the DynamoRIO load-trace analogue). Queries only read → no writes."""
    kd = data["_np"]["kd"]
    reads, writes = [], []
    for rect in data["_np"]["queries"]:
        lo, hi = rect[:2], rect[2:]
        stack, visited = [int(kd["root"])], []
        while stack and len(visited) < VISIT_BUDGET:
            n = stack.pop()
            visited.append(n)
            pt, ax = kd["point"][n], int(kd["axis"][n])
            if lo[ax] <= pt[ax] and kd["left"][n] >= 0:
                stack.append(int(kd["left"][n]))
            if hi[ax] >= pt[ax] and kd["right"][n] >= 0:
                stack.append(int(kd["right"][n]))
        reads.append(np.asarray(visited))
        writes.append(np.asarray([], np.int64))
    return MemoryTrace(reads=reads, writes=writes)


register(
    Benchmark(
        name="GeoSpatial",
        domain="geo-spatial database",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        trace=trace,
    )
)
