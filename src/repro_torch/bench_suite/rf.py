"""E. Random Forest (paper §VI.E).

Port of the JAX package's ``bench_suite/rf.py``. 256 binary decision
trees of depth 5 as linked node structures; 32-feature input vector;
ensemble average.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device

N_TREES = 256
DEPTH = 5
N_FEAT = 32
N_NODES = 2 ** (DEPTH + 1) - 1  # full binary tree, 63 nodes


def build(seed=4, device=None):
    rng = np.random.default_rng(seed)
    feat = rng.integers(0, N_FEAT, (N_TREES, N_NODES)).astype(np.int32)
    thr = rng.normal(size=(N_TREES, N_NODES)).astype(np.float32)
    leaf = rng.normal(size=(N_TREES, N_NODES)).astype(np.float32)
    # children laid out randomly (pointer-style, not implicit heap order)
    left = np.zeros((N_TREES, N_NODES), np.int32)
    right = np.zeros((N_TREES, N_NODES), np.int32)
    root = np.zeros((N_TREES,), np.int32)
    for t in range(N_TREES):
        perm = rng.permutation(N_NODES).astype(np.int32)
        heap_l = np.where(2 * np.arange(N_NODES) + 1 < N_NODES, 2 * np.arange(N_NODES) + 1, 0)
        heap_r = np.where(2 * np.arange(N_NODES) + 2 < N_NODES, 2 * np.arange(N_NODES) + 2, 0)
        left[t][perm] = perm[heap_l]
        right[t][perm] = perm[heap_r]
        root[t] = perm[0]
    x = rng.normal(size=(N_FEAT,)).astype(np.float32)
    return to_device({
        "feat": feat, "thr": thr, "leaf": leaf, "left": left, "right": right,
        "root": root, "x": x, "tree_ids": np.arange(N_TREES, dtype=np.int32),
    }, device)


def item_fn(data):
    x = data["x"]

    def fn(t):
        node = gather(data["root"], t)
        for _ in range(DEPTH):
            go_left = gather(x, gather(data["feat"], t, node)) < gather(data["thr"], t, node)
            node = torch.where(go_left, gather(data["left"], t, node), gather(data["right"], t, node))
        return gather(data["leaf"], t, node)

    return fn


def items(data):
    return data["tree_ids"]


def cost(data):
    return dict(flops=DEPTH * 4.0, bytes=DEPTH * 128.0, chain=DEPTH, vector=True)


register(
    Benchmark(
        name="RF",
        domain="recommendation / ML serving",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
    )
)
