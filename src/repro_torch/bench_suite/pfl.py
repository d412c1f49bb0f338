"""PFL motion update (paper Fig. 1): the compute-bound sweep kernel.

Port of the JAX package's ``bench_suite/pfl.py``. Per-particle pose
update from RTRBench's Particle Filter Localization: trig-heavy
floating-point work, no dependent loads — the kernel where the paper
measures only +5.1% (Relic-SMT) / +2.7% (OMP-SMT) at 1000 particles
because one thread already keeps the FP ports mostly busy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import to_device
from repro_torch.core.overlap_model import Microtask


def build(n_particles=1000, seed=10, device=None):
    rng = np.random.default_rng(seed)
    pose = rng.normal(size=(n_particles, 3)).astype(np.float32)  # x, y, θ
    noise = rng.normal(size=(n_particles, 3)).astype(np.float32)
    return to_device({"pose": pose, "noise": noise, "v": np.float32(1.2),
                      "w": np.float32(0.3), "dt": np.float32(0.05)}, device)


def item_fn(data):
    v, w, dt = data["v"], data["w"], data["dt"]

    def fn(args):
        pose, eps = args
        x, y, th = pose[0], pose[1], pose[2]
        v_n = v + 0.1 * eps[0]
        w_n = w + 0.05 * eps[1]
        r = v_n / torch.clamp(torch.abs(w_n), min=1e-4)
        x2 = x - r * torch.sin(th) + r * torch.sin(th + w_n * dt)
        y2 = y + r * torch.cos(th) - r * torch.cos(th + w_n * dt)
        th2 = th + w_n * dt + 0.02 * eps[2] * dt
        return torch.stack([x2, y2, th2])

    return fn


def items(data):
    return (data["pose"], data["noise"])


def microtask() -> Microtask:
    # ~200 scalar FP ops (4 trig ≈ 40 ops each + arithmetic), 24B in/out
    return Microtask(flops=200.0, bytes=48.0, chain=0, vector=True)
