"""B. Volume-Weighted Average Price Engine (paper §VI.B).

Port of the JAX package's ``bench_suite/vwap.py``. Skip-list price-level
search (4 levels) → linked-list volume aggregation → sliding-window VWAP
over a 32-tick ring buffer. 100 price levels ($100.00–$100.99, 1¢ ticks),
30 trade messages per iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite import common
from repro_torch.bench_suite.common import Benchmark, gather, register, to_device
from repro_torch.core.deps import MemoryTrace

N_LEVELS = 100
SKIP_LEVELS = 4
N_MSGS = 30
WINDOW = 32
VOL_HOPS = 10
HOPS_PER_LEVEL = 6


def build(seed=1, device=None):
    rng = np.random.default_rng(seed)
    # skip list: level k links over sorted price levels with stride ~2^k
    nxt = np.zeros((SKIP_LEVELS, N_LEVELS), np.int32)
    for k in range(SKIP_LEVELS):
        stride = 2**k
        for i in range(N_LEVELS):
            nxt[k, i] = i + stride if i + stride < N_LEVELS else -1
    vol_lists = common.build_linked_lists(rng, N_LEVELS, 3, VOL_HOPS - 2)
    ring = rng.uniform(100.0, 101.0, (WINDOW,)).astype(np.float32)
    ring_vol = rng.uniform(1, 100, (WINDOW,)).astype(np.float32)
    msgs = rng.integers(0, 100, (N_MSGS,)).astype(np.int32)  # price ticks
    data = to_device({"nxt": nxt, "lists": vol_lists, "ring": ring, "ring_vol": ring_vol,
                      "msgs": msgs, "slots": np.arange(N_MSGS, dtype=np.int32)}, device)
    data["_np"] = {"nxt": nxt, "msgs": msgs}
    return data


def _skip_search(nxt, target):
    """Top-down skip-list search for `target` level (dependent hops)."""
    node = torch.zeros((), dtype=torch.int32, device=nxt.device)
    for k in reversed(range(SKIP_LEVELS)):
        for _ in range(HOPS_PER_LEVEL):
            nx = gather(nxt[k], torch.clamp(node, min=0))
            node = torch.where((nx >= 0) & (nx <= target), nx, node)
    return node


def item_fn(data):
    nxt, lists = data["nxt"], data["lists"]
    ring, ring_vol = data["ring"], data["ring_vol"]

    def fn(args):
        price_tick, slot = args
        level = _skip_search(nxt, price_tick)
        vol = common.list_sum(lists, gather(lists["head"], level), VOL_HOPS)
        # sliding-window VWAP: each message appends at its own ring slot
        w = ring_vol.index_put((slot % WINDOW,), vol, accumulate=True)
        return torch.sum(ring * w) / torch.clamp(torch.sum(w), min=1e-6)

    return fn


def items(data):
    return (data["msgs"], data["slots"])


def cost(data):
    chain = SKIP_LEVELS * HOPS_PER_LEVEL + VOL_HOPS
    return dict(
        flops=3.0 * WINDOW + 20.0, bytes=chain * 64.0 + WINDOW * 8.0,
        chain=chain, vector=True,
    )


def trace(data) -> MemoryTrace:
    nxt, msgs = data["_np"]["nxt"], data["_np"]["msgs"]
    reads, writes = [], []
    for i, t in enumerate(msgs):
        node, visited = 0, [0]
        for k in reversed(range(SKIP_LEVELS)):
            for _ in range(HOPS_PER_LEVEL):
                nx = nxt[k, node]
                if 0 <= nx <= t:
                    node = int(nx)
                    visited.append(node)
        reads.append(np.asarray(visited))
        # ring slots live in their own address range (disjoint across a
        # round-robin 2-task split)
        writes.append(np.asarray([10_000_000 + i % WINDOW]))
    return MemoryTrace(reads=reads, writes=writes)


register(
    Benchmark(
        name="VWAP",
        domain="high-frequency trading",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        trace=trace,
    )
)
