"""C. Obstacle Detection System (paper §VI.C).

Port of the JAX package's ``bench_suite/lidar.py``. 3D KD-tree
nearest-neighbour queries along a planned trajectory. 1000 obstacles in a
60³ m volume, 100 waypoints at 0.2 m resolution.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite import common
from repro_torch.bench_suite.common import Benchmark, gather, register, to_device

N_OBST = 1000
N_WAY = 100
VISIT_BUDGET = 64


def build(seed=2, device=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 60, (N_OBST, 3)).astype(np.float32)
    kd = common.build_kdtree(pts)
    start = rng.uniform(10, 50, (3,))
    heading = rng.normal(size=3)
    heading /= np.linalg.norm(heading)
    way = (start[None] + 0.2 * np.arange(N_WAY)[:, None] * heading[None]).astype(np.float32)
    return to_device({"kd": kd, "way": way}, device)


def nn_search(kd, q, budget: int, stack_size: int = 48):
    """Stack-budgeted branch-and-bound NN: the min squared distance from
    q to a point of the tree (LIDAR's query; BVH's descent)."""
    dev = q.device
    stack = torch.zeros((stack_size,), dtype=torch.int32, device=dev)
    stack = stack.index_put((torch.zeros((), dtype=torch.int64, device=dev),), kd["root"])
    sp = torch.ones((), dtype=torch.int32, device=dev)
    best = torch.full((), 1e9, dtype=torch.float32, device=dev)
    for _ in range(budget):
        has = sp > 0
        node = torch.where(has, gather(stack, torch.clamp(sp - 1, min=0)), -1)
        sp = torch.where(has, sp - 1, sp)
        nv = torch.clamp(node, min=0)
        pt = gather(kd["point"], nv)
        ax = gather(kd["axis"], nv)
        d2 = torch.sum((pt - q) ** 2)
        live = node >= 0
        best = torch.where(live & (d2 < best), d2, best)
        diff = gather(q, ax) - gather(pt, ax)
        left, right = gather(kd["left"], nv), gather(kd["right"], nv)
        near = torch.where(diff < 0, left, right)
        far = torch.where(diff < 0, right, left)
        # push far child only if its half-space can beat `best`
        push_far = live & (far >= 0) & (diff * diff < best)
        stack = torch.where(push_far, stack.index_put((sp,), far), stack)
        sp = sp + push_far.to(torch.int32)
        push_near = live & (near >= 0)
        stack = torch.where(push_near, stack.index_put((sp,), near), stack)
        sp = sp + push_near.to(torch.int32)
    return best


def item_fn(data):
    kd = data["kd"]

    def fn(waypoint):
        return torch.sqrt(nn_search(kd, waypoint, VISIT_BUDGET))

    return fn


def items(data):
    return data["way"]


def cost(data):
    return dict(flops=VISIT_BUDGET * 12.0, bytes=VISIT_BUDGET * 64.0,
                chain=VISIT_BUDGET, vector=True)


register(
    Benchmark(
        name="LIDAR",
        domain="autonomous vehicles",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
    )
)
