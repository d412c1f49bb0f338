"""The train step: loss → gradients (``torch.autograd``) → optional
accumulation → AdamW.

Port of the JAX package's ``train/train_step.py``. Accumulation loops over
the microbatches of a batch whose leaves lead with [accum, …] (the JAX
package's ``lax.scan``): the gradients are summed in the parameters' dtype
and scaled by 1/accum, the loss is averaged and the last microbatch's
metrics are kept.

On a mesh (a ``DeviceMesh`` over the ranks, ``launch/mesh.py``) the step
is data-parallel: each rank runs forward and backward on its shard of the
batch over the mesh's "pod" and "data" axes, with the single-device layer
code (no sharding rules inside the step), and the gradients are averaged
over those axes with ``parallel/collectives.all_reduce_axes``; the
parameters and the optimizer state stay replicated. This is the JAX step
under GSPMD's batch split, whose cross-entropy is one masked mean over the
global batch: each microbatch's mask sums are all-reduced first, and rank r
differentiates w_r · ce_r + 0.01 · aux_r with w_r = n · cnt_r / Σ cnt (n
ranks), so the mean of the ranks' objectives is the global masked mean of
the cross-entropy plus 0.01 × the ranks' mean of the MoE aux loss (the JAX
package's ``pmean`` of it), and so are their gradients' mean; the reported
``ce`` is weighted the same way. The compressed variant (``compress_pod_grads``)
averages over "data" exactly and re-reduces the pod axis in int8 with
error feedback (``parallel/compression.py``), as the JAX package's
``step_compressed`` shows the slow inter-pod hop compressed.

Not ported: ``zero2_axes`` (the gather-once FSDP path only the JAX
package's dry run reaches) and training split over 'model' or over
experts — ``torch.distributed`` collectives carry no autograd.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.step_graph import GraphFamily, in_place
from repro_torch.parallel import collectives as col
from repro_torch.parallel.compression import compressed_grad_tree
from repro_torch.train.optimizer import AdamW, OptState
from repro_torch.tree import flatten, map_tree, unflatten

BATCH_AXES = ("pod", "data")


def make_train_step(model, opt: AdamW, *, accum_steps: int = 1,
                    compress_pod_grads: bool = False, mesh=None):
    """Returns step(params, opt_state, batch) → (params, opt_state,
    metrics), or with ``compress_pod_grads`` step(params, opt_state, batch,
    err) → (params, opt_state, metrics, err), ``err`` the float32
    error-feedback tree (zeros at first). Batch leaves lead with [accum,
    micro, …] when ``accum_steps`` > 1. ``mesh``: the data-parallel mesh
    (needed for ``compress_pod_grads``, whose mesh has a "pod" axis); every
    rank calls the step with the same (global) batch and parameters."""
    if compress_pod_grads and (mesh is None or col.group_size(mesh, "pod") == 1):
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' axis")
    # the single-device layer code: a model holding a mesh's rules would
    # take its expert-parallel paths, whose collectives carry no gradient
    local = model if model.rules is None else type(model)(model.cfg, device=model.device)
    split_axes = col.present_axes(mesh, BATCH_AXES) if mesh is not None else ()
    exact_axes = tuple(a for a in split_axes if not (compress_pod_grads and a == "pod"))

    def shard(batch):
        if not split_axes:
            return batch
        n = math.prod(col.group_size(mesh, a) for a in split_axes)
        i = col.shard_index(mesh, split_axes)
        dim = 1 if accum_steps > 1 else 0

        def take(x):
            b = x.shape[dim]
            if b % n:
                raise ValueError(f"a batch of {b} rows does not split over {n} ranks")
            return x.narrow(dim, i * (b // n), b // n)

        return {k: take(v) for k, v in batch.items()}

    def weight(batch):
        """This rank's share of the global mask sum, n · cnt_r / Σ cnt (None
        on one device)."""
        if not split_axes:
            return None
        n = math.prod(col.group_size(mesh, a) for a in split_axes)
        cnt = torch.as_tensor(batch["mask"], device=local.device).float().sum()
        total = col.all_reduce_axes(cnt, mesh, split_axes)
        return n * cnt / torch.clamp(total, min=1.0)

    def grad_of(params, batch):
        w = weight(batch)
        leaves, spec = flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, metrics = local.loss(unflatten(spec, leaves), batch)
            if w is not None:
                metrics = dict(metrics, ce=w * metrics["ce"])
                loss = metrics["ce"] + 0.01 * metrics["aux"]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), map_tree(torch.Tensor.detach, metrics), unflatten(spec, grads)

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grad_of(params, batch)
        acc_loss = torch.zeros((), dtype=torch.float32, device=local.device)
        acc = map_tree(torch.zeros_like, params)
        for i in range(accum_steps):
            loss, metrics, grads = grad_of(params, {k: v[i] for k, v in batch.items()})
            acc = map_tree(torch.add, acc, grads)
            acc_loss = acc_loss + loss
        inv = 1.0 / accum_steps
        return acc_loss * inv, metrics, map_tree(lambda g: g * inv, acc)

    def mean_over(t, axes):
        n = math.prod(col.group_size(mesh, a) for a in axes)
        return col.all_reduce_axes(t, mesh, axes) / n

    def data_parallel(params, batch):
        loss, metrics, grads = compute_grads(params, shard(batch))
        if split_axes:
            grads = map_tree(lambda g: mean_over(g, exact_axes), grads) if exact_axes else grads
            metrics = {k: (col.all_reduce_axes(v, mesh, split_axes) if k == "tokens"
                           else mean_over(v, split_axes)) for k, v in metrics.items()}
            loss = mean_over(loss, split_axes)
        return loss, metrics, grads

    def step(params, opt_state: OptState, batch):
        loss, metrics, grads = data_parallel(params, batch)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    def step_compressed(params, opt_state: OptState, batch, err):
        """The pod axis's share of the gradient reduction in int8 with
        error feedback: each pod's gradients (averaged over its "data"
        ranks exactly) go through ``compressed_psum`` over "pod"."""
        loss, metrics, grads = data_parallel(params, batch)
        grads, err = compressed_grad_tree(grads, mesh, "pod", err)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics), err

    return step_compressed if compress_pod_grads else step


def compiled_train_step(model, opt: AdamW, *, accum_steps: int = 1) -> GraphFamily:
    """``make_train_step(model, opt, accum_steps=…)`` as a compiled family
    (``models/step_graph.py``; the reference's ``jax.jit`` of the step): the
    forward, backward, accumulation and AdamW as one CUDA graph a batch
    shape on the card, the record of the key on the CPU. The batch leaves
    are its inputs; the parameters and the ``OptState`` (step, moments) are
    its state, captured by address and updated in place (``in_place``):
    step(params, opt_state, batch) returns the caller's own ``params`` and
    ``opt_state`` trees, stepped, and the metrics. One device only: the
    mesh step's gloo collectives cannot be captured."""
    return GraphFamily(in_place(make_train_step(model, opt, accum_steps=accum_steps),
                                {0: 0, 1: 1}),
                       model.device, model.graph_pool, inputs=(2,), name="train_step")
