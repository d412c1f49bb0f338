"""J. 3D Collision Detection (paper §VI.J).

Port of the JAX package's ``bench_suite/bvh.py``. BVH descent per
trajectory point over an obstacle point cloud in a 1 km cube. Paper
scale: 2·10⁵ obstacles, 10⁴ trajectory points (65 536 / 2048 here, as in
the JAX package; structure unchanged).

Per-point descent alternates one AABB overlap test (compute) with one
child fetch (dependent load) — the paper reports a −61% regression when
this kernel is force-parallelized below the Relic granularity floor
(§VII, Fig. 4): the microtasks are too fine and the split breaks the
descent's cache locality. The descent is LIDAR's branch-and-bound walk
(``lidar.nn_search``) at its own budget.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite import common
from repro_torch.bench_suite.common import Benchmark, register, to_device
from repro_torch.bench_suite.lidar import nn_search

N_OBST = 65_536
N_TRAJ = 2048
VISIT_BUDGET = 40


def build(seed=9, device=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1000, (N_OBST, 3)).astype(np.float32)
    kd = common.build_kdtree(pts)  # KD doubles as a BVH with point AABBs
    traj = rng.uniform(200, 800, (N_TRAJ, 3)).astype(np.float32)
    return to_device({"kd": kd, "traj": traj}, device)


def item_fn(data):
    kd = data["kd"]

    def fn(p):
        return torch.sqrt(nn_search(kd, p, VISIT_BUDGET))

    return fn


def items(data):
    return data["traj"]


def cost(data):
    return dict(
        flops=VISIT_BUDGET * 10.0, bytes=VISIT_BUDGET * 64.0,
        chain=VISIT_BUDGET, vector=True,
    )


register(
    Benchmark(
        name="BVH",
        domain="aerospace / robotics",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        force=True,  # paper: passed the gate but below the Relic floor
        realized_granularity=1,
        locality_penalty=2.5,
    )
)
