"""I. Fraud Detection (paper §VI.I).

Port of the JAX package's ``bench_suite/fraud.py``. 5-vertex fan-in motif
detection: for each tested edge (u→v), scan v's in-neighbour list for ≥4
distinct sources within a recency window. 10⁵ vertices, 3·10⁵ background
edges, 1000 tested edges per iteration.

This is the benchmark the paper's Sniper gate REJECTS: the per-edge scan
streams the adjacency list (bandwidth-bound, negligible dependent-chain
and compute), so co-scheduling cannot hide anything — predicted gain
≤ gate threshold → Relic is not applied, performance unchanged (§VII).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device
from repro_torch.core.deps import MemoryTrace

N_VERTS = 100_000
N_EDGES = 300_000
N_TESTS = 1000
MAX_IN = 64  # padded in-neighbour window scanned per test


def build(seed=8, device=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_VERTS, N_EDGES).astype(np.int32)
    dst = rng.integers(0, N_VERTS, N_EDGES).astype(np.int32)
    ts = rng.uniform(0, 1, N_EDGES).astype(np.float32)
    # CSR of in-edges, padded per-vertex window
    order = np.argsort(dst, kind="stable")
    dst_s, src_s, ts_s = dst[order], src[order], ts[order]
    starts = np.searchsorted(dst_s, np.arange(N_VERTS))
    counts = np.diff(np.append(starts, N_EDGES))
    window_src = np.full((N_VERTS, MAX_IN), -1, np.int32)
    window_ts = np.zeros((N_VERTS, MAX_IN), np.float32)
    for v in np.unique(dst_s):
        c = min(int(counts[v]), MAX_IN)
        window_src[v, :c] = src_s[starts[v] : starts[v] + c]
        window_ts[v, :c] = ts_s[starts[v] : starts[v] + c]
    tests = rng.integers(0, N_EDGES, N_TESTS).astype(np.int32)
    data = to_device({"win_src": window_src, "win_ts": window_ts, "src": src, "dst": dst,
                      "ts": ts, "tests": tests}, device)
    data["_np"] = {"dst": dst, "tests": tests}
    return data


def item_fn(data):
    def fn(e):
        v = gather(data["dst"], e)
        t0 = gather(data["ts"], e)
        srcs = gather(data["win_src"], v)  # streamed scan (bandwidth-bound)
        tss = gather(data["win_ts"], v)
        recent = (srcs >= 0) & (torch.abs(tss - t0) < 0.1)
        distinct = recent & (srcs != gather(data["src"], e))
        return (distinct.sum() >= 4).to(torch.float32)

    return fn


def items(data):
    return data["tests"]


def cost(data):
    # stream 64 in-edges, each on its own cold cache line (8B useful per
    # 64B line): pure bandwidth, negligible compute, no dependent chain
    return dict(flops=float(MAX_IN), bytes=MAX_IN * 64.0, chain=0, vector=True)


def trace(data) -> MemoryTrace:
    dst, tests = data["_np"]["dst"], data["_np"]["tests"]
    reads = [np.arange(int(dst[e]) * MAX_IN, int(dst[e]) * MAX_IN + MAX_IN) for e in tests]
    writes = [np.asarray([], np.int64) for _ in tests]
    return MemoryTrace(reads=reads, writes=writes)


register(
    Benchmark(
        name="Fraud",
        domain="fraud detection",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        trace=trace,
    )
)
