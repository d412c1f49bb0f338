"""AdamW with global-norm clipping and a warm-up + cosine schedule.

Port of the JAX package's ``train/optimizer.py``, as plain functions on
tensors (``torch.optim.AdamW`` decays and clips otherwise). The moments are
float32 whatever the parameters' dtype, in the parameters' tree; the step
count is an int32 scalar tensor, so a checkpoint of the state restores it
exactly. Every scalar of the schedule and the bias correction is a float32
tensor, computed in the JAX package's order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import flatten, map_tree, unflatten


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Any  # first moment (float32, the parameters' tree)
    nu: Any  # second moment (float32, the parameters' tree)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    # ------------------------------------------------------------------
    def init(self, params) -> OptState:
        leaves = flatten(params)[0]
        dev = leaves[0].device if leaves else None
        zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                        nu=map_tree(torch.zeros_like, zeros))

    def schedule(self, step):
        """The learning rate at ``step`` (an int or an int tensor): linear
        warm-up to ``lr`` over ``warmup_steps``, then a cosine to
        ``min_lr_frac`` · lr at ``total_steps``; a float32 tensor."""
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((s + 1) / max(1, self.warmup_steps), max=1.0)
        prog = torch.clamp(
            (s - self.warmup_steps) / max(1, self.total_steps - self.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    @torch.no_grad()
    def update(self, grads, state: OptState, params, *, mesh=None, norm_axes=None):
        """(new params, new state, {"grad_norm", "lr"}). The gradients are
        clipped to a global norm of ``clip_norm``; the rate is
        ``schedule(state.step)`` (the step before this update); weight decay
        applies to leaves of two or more dimensions only (norms and biases
        are exempt); each parameter is updated in float32 and cast back to
        its dtype.

        Sharded leaves (a step split over ``mesh``): ``norm_axes`` lists, in
        the leaves' order, the mesh axes that split each leaf; each leaf's
        sum of squares is summed over them (leaves that share them in one
        all-reduce), so the norm is the whole gradient's and a replicated
        leaf counts once."""
        flat_p, spec = flatten(params)
        flat_g, flat_m, flat_v = (flatten(t)[0] for t in (grads, state.mu, state.nu))
        sq = [torch.sum(torch.square(g.float())) for g in flat_g]
        if norm_axes is None:
            gnorm = torch.sqrt(sum(sq))
        else:
            by_axes: dict = {}
            for q, axes in zip(sq, norm_axes, strict=True):
                by_axes[axes] = by_axes.get(axes, 0) + q
            gnorm = torch.sqrt(sum(col.all_reduce_axes(v, mesh, axes) if axes else v
                                   for axes, v in by_axes.items()))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(state.step)
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * torch.square(g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if p.dim() >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return (
            unflatten(spec, new_p),
            OptState(step=step, mu=unflatten(spec, new_m), nu=unflatten(spec, new_v)),
            {"grad_norm": gnorm, "lr": lr},
        )
