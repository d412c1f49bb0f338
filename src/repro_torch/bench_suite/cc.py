"""CC benchmark (paper Fig. 2): the memory-bound sweep kernel.

Port of the JAX package's ``bench_suite/cc.py``. Fine-grained graph
processing from the Relic paper [4]: one label-propagation step of
connected components — per vertex, gather the labels of its neighbours
(dependent random loads) and take the min. This is the kernel whose
SMT-Relic band the paper highlights: a range of granularities where
co-scheduling on one core beats both serial and SMP while OpenMP loses to
its own dispatch overhead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import gather, to_device
from repro_torch.core.overlap_model import Microtask

DEGREE = 8


def build(n_vertices=4096, seed=11, device=None):
    rng = np.random.default_rng(seed)
    neigh = rng.integers(0, n_vertices, (n_vertices, DEGREE)).astype(np.int32)
    labels = np.arange(n_vertices, dtype=np.int32)
    return to_device({"neigh": neigh, "labels": labels,
                      "verts": np.arange(n_vertices, dtype=np.int32)}, device)


def item_fn(data):
    labels, neigh = data["labels"], data["neigh"]

    def fn(v):
        ls = labels[gather(neigh, v)]  # DEGREE dependent random loads
        return torch.minimum(torch.min(ls), gather(labels, v))

    return fn


def items(data):
    return data["verts"]


def microtask() -> Microtask:
    # per vertex: DEGREE random label loads behind one adjacency load
    return Microtask(flops=3.0 * DEGREE, bytes=DEGREE * 68.0, chain=3, vector=True)
