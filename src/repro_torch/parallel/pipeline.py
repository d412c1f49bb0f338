"""A 2-stage GPipe over the 'pod' axis (inter-pod pipeline parallelism).

Port of the JAX package's ``parallel/pipeline.py``, forward only as there.
Pipeline parallelism moves one activation handoff per microbatch through
the slow pod↔pod link, where data parallelism would move a whole gradient
all-reduce. Every rank of the axis runs this function (one process a
rank); rank 0 is stage 0, rank 1 stage 1.

Schedule (2 stages, M microbatches, M + 1 ticks):

  tick t: stage 0 runs microbatch min(t, M − 1); stage 1 runs the
          activation stage 0 handed it at tick t − 1 (zeros at t = 0);
          one ring hop (``collectives.ring_shift``) hands stage 0's output
          forward (stage 1's, which the hop brings to stage 0, is dropped).

Stage 1's outputs of ticks 1…M are the finished microbatches; a last hop
brings them to stage 0, so both stages return the whole result. Bubble
fraction 1/(M + 1).
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import map_tree


def pipelined_apply(layer_fn, stage_params, x, *, mesh, n_micro: int, axis: str = "pod"):
    """layer_fn(stage 1's params, layer_fn(stage 0's params, x)) over a
    2-stage pipeline along ``axis``. ``stage_params``: leaves stacked
    [n_stages, …] (stage i's sub-stack at index i; each rank takes its
    own); ``x`` [B, …], the same on every rank, split along B into
    ``n_micro`` microbatches."""
    n_stages = col.group_size(mesh, axis)
    if n_stages != 2:
        raise ValueError(f"the pipeline is 2-stage: axis {axis!r} has {n_stages} ranks")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    stage = col.axis_index(mesh, axis)
    params_stage = map_tree(lambda p: p[stage], stage_params)
    micro = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    inflight = torch.zeros((mb,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(n_micro + 1):
        x_in = micro[min(t, n_micro - 1)] if stage == 0 else inflight
        y = layer_fn(params_stage, x_in)
        inflight = col.ring_shift(y, mesh, axis)
        ys.append(y)
    # on stage 1, ticks 1…M are the finished microbatches: hand them back
    outs = torch.cat(ys[1:], dim=0)
    outs_from_1 = col.ring_shift(outs, mesh, axis)
    return outs if stage == 1 else outs_from_1
