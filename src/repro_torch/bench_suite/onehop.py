"""F. Graph Neural Network 1-Hop Embedding (paper §VI.F).

Port of the JAX package's ``bench_suite/onehop.py``. 1-hop neighbour
aggregation for node 0: 200 000 nodes, average degree 256, 64 features
per node. Per-neighbour work is a single feature-row gather + MAC — far
below the Relic granularity floor, which is why the paper measures a −9%
regression when it is force-parallelized (§VII).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device

N_NODES = 200_000
DEGREE = 256
N_FEAT = 64


def build(seed=5, device=None):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N_NODES, N_FEAT)).astype(np.float32)
    neigh = rng.choice(N_NODES, size=DEGREE, replace=False).astype(np.int32)
    w = rng.normal(size=(N_FEAT,)).astype(np.float32) / np.sqrt(N_FEAT)
    return to_device({"feats": feats, "neigh": neigh, "w": w}, device)


def item_fn(data):
    feats, w = data["feats"], data["w"]

    def fn(n):
        return torch.dot(gather(feats, n), w)  # gather one row + 64-MAC

    return fn


def items(data):
    return data["neigh"]


def cost(data):
    return dict(flops=2.0 * N_FEAT, bytes=N_FEAT * 4.0 + 8.0, chain=1, vector=True)


register(
    Benchmark(
        name="1-Hop",
        domain="GNN inference",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        force=True,  # paper: not flagged by the simulator, but below the
        realized_granularity=8,  # Relic API floor when applied
        locality_penalty=0.3,
    )
)
