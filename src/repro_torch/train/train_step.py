"""The train step: loss → gradients (``torch.autograd``) → optional
accumulation → AdamW.

Port of the JAX package's ``train/train_step.py``. Accumulation loops over
the microbatches of a batch whose leaves lead with [accum, …] (the JAX
package's ``lax.scan``): the gradients are summed in the parameters' dtype
and scaled by 1/accum, the loss is averaged and the last microbatch's
metrics are kept.

On a mesh (a ``DeviceMesh`` over the ranks, ``launch/mesh.py``) a model
that holds no rules trains data-parallel: each rank runs forward and
backward on its shard of the batch over the mesh's "pod" and "data" axes,
with the single-device layer code, and the gradients are averaged over
those axes with ``parallel/collectives.all_reduce_axes``; the parameters
and the optimizer state stay replicated. This is the JAX step under
GSPMD's batch split, whose cross-entropy is one masked mean over the global
batch: each microbatch's mask sums are all-reduced first, and rank r
differentiates w_r · ce_r + 0.01 · aux_r with w_r = n · cnt_r / Σ cnt (n
ranks), so the mean of the ranks' objectives is the global masked mean of
the cross-entropy plus 0.01 × the ranks' mean of the MoE aux loss (the JAX
package's ``pmean`` of it), and so are their gradients' mean; the reported
``ce`` is weighted the same way. The compressed variant
(``compress_pod_grads``) averages over "data" exactly and re-reduces the
pod axis in int8 with error feedback (``parallel/compression.py``), as the
JAX package's ``step_compressed`` shows the slow inter-pod hop compressed.

A model built on a mesh (``Model(cfg, mesh=mesh)``) trains split, as the
JAX package's ``Model(cfg, mesh=mesh)`` does under its ``ShardingRules``:
each rank holds only its shard of every parameter and moment
(``Model.shard_params``), runs the forward and backward of its shard
(``Model.loss``: the batch split over "pod"/"data" as above, each layer
split over "model", collectives that carry gradients), and each leaf's
gradient is summed over the axes where it is partial
(``TrainSplit.grad_axes``: the batch axes that do not split it, and
"model" for a replicated leaf read inside a split region) and averaged
over the batch axes; ``AdamW.update`` sums each leaf's squares over the
axes that split it, so ``grad_norm`` is the whole gradient's. An FSDP leaf
(``param_sharding="fsdp"``: "embed" over "data") is gathered at each use,
its gradient reduce-scattered by the gather's backward, as GSPMD does
without ``zero2``; ``zero2_axes`` gathers the stored shards once a step
into the ``tp_view()`` layout, differentiates every microbatch against
them and reduce-scatters the summed gradients once (ZeRO-2). A
microbatch's backward runs right after its forward, so nothing of it is
held into the next one, and no checkpoint around it is needed (the JAX
package checkpoints each microbatch, ``nothing_saveable``, because it
differentiates the whole accumulation scan at once). The split step runs
eagerly: a gloo collective cannot be captured.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.step_graph import GraphFamily, in_place
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding
from repro_torch.parallel.compression import compressed_grad_tree
from repro_torch.train.optimizer import AdamW, OptState
from repro_torch.tree import flatten, map_tree, unflatten

BATCH_AXES = ("pod", "data")


def make_train_step(model, opt: AdamW, *, accum_steps: int = 1,
                    compress_pod_grads: bool = False, mesh=None, zero2_axes=None,
                    local_batch: bool = False):
    """Returns step(params, opt_state, batch) → (params, opt_state,
    metrics), or with ``compress_pod_grads`` step(params, opt_state, batch,
    err) → (params, opt_state, metrics, err), ``err`` the float32
    error-feedback tree (zeros at first). Batch leaves lead with [accum,
    micro, …] when ``accum_steps`` > 1. ``mesh``: the data-parallel mesh
    for a model that holds no rules (needed for ``compress_pod_grads``,
    whose mesh has a "pod" axis); every rank calls the step with the same
    (global) batch. A model built on a mesh (``Model(cfg, mesh=mesh)``)
    trains split on its own mesh: ``params`` and ``opt_state`` are then
    this rank's shards (``model.shard_params``), and so is what the step
    returns. ``zero2_axes`` (the parameters' logical-axes tree,
    ``model.param_axes()``; only a split step reads it): gather the FSDP
    shards once a step and reduce-scatter the gradients once. The step's
    ``gradients(params, batch)`` → (loss, metrics, gradients) is the step
    without the optimizer, its gradients reduced as the optimizer takes
    them, and its ``update(grads, opt_state, params)`` the optimizer's
    update as the step makes it. ``local_batch``: the batch is this rank's
    shard of it already (a dry-run cell's arguments: the rows the rules
    give the rank, all of them where the batch does not divide the batch
    axes), and the step takes it as it is."""
    sp = model.train_split
    if sp is not None:
        mesh = model.mesh
    if compress_pod_grads and (mesh is None or col.group_size(mesh, "pod") == 1):
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' axis")
    split_axes = col.present_axes(mesh, BATCH_AXES) if mesh is not None else ()
    exact_axes = tuple(a for a in split_axes if not (compress_pod_grads and a == "pod"))
    zero2 = sp is not None and zero2_axes is not None
    norm_axes = None
    if sp is not None:
        specs = flatten(sp.storage, is_leaf=sharding.is_spec)[0]
        norm_axes = [sharding.used_axes(s) for s in specs]

    def shard(batch):
        if not split_axes or local_batch:
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
        cnt = torch.as_tensor(batch["mask"], device=model.device).float().sum()
        total = col.all_reduce_axes(cnt, mesh, split_axes)
        return n * cnt / torch.clamp(total, min=1.0)

    def grad_of(params, batch):
        w = weight(batch)
        leaves, spec = flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            kw = {"gathered": True} if zero2 else {}
            loss, metrics = model.loss(unflatten(spec, leaves), batch, **kw)
            if w is not None:
                metrics = dict(metrics, ce=w * metrics["ce"])
                loss = metrics["ce"] + 0.01 * metrics["aux"]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), map_tree(torch.Tensor.detach, metrics), unflatten(spec, grads)

    def compute_grads(params, batch):
        if zero2:
            # ZeRO-2: the stored FSDP shards gathered once, every microbatch
            # differentiated against the gathered leaves, the sum
            # reduce-scattered once
            with torch.no_grad():
                params = model.fsdp_gather(params)
        if accum_steps == 1:
            loss, metrics, grads = grad_of(params, batch)
        else:
            acc_loss = torch.zeros((), dtype=torch.float32, device=model.device)
            acc = map_tree(torch.zeros_like, params)
            for i in range(accum_steps):
                loss, metrics, grads = grad_of(params, {k: v[i] for k, v in batch.items()})
                for a, g in zip(flatten(acc)[0], flatten(grads)[0]):
                    a.add_(g)  # in place: one gradient tree at a time besides the sum
                del grads
                acc_loss = acc_loss + loss
            inv = 1.0 / accum_steps
            loss, grads = acc_loss * inv, map_tree(lambda g: g * inv, acc)
        if zero2:
            grads = model.fsdp_scatter(grads)
        return loss, metrics, grads

    def mean_over(t, axes):
        n = math.prod(col.group_size(mesh, a) for a in axes)
        return col.all_reduce_axes(t, mesh, axes) / n

    def reduce_grads(grads):
        """Each leaf's gradient summed over the axes where it is partial and
        averaged over the batch axes (an FSDP leaf's "data" sum was its
        gather's reduce-scatter); the pod axis is left to the compressed
        reduction when there is one."""
        if sp is None:
            return map_tree(lambda g: mean_over(g, exact_axes), grads) if exact_axes else grads
        n = math.prod(col.group_size(mesh, a) for a in exact_axes)

        def one(g, axes):
            axes = tuple(a for a in axes if a in exact_axes or a == "model")
            return col.all_reduce_axes(g, mesh, axes) / n

        return sharding.map_dicts(one, grads, sp.grad_axes)

    def gradients(params, batch):
        loss, metrics, grads = compute_grads(params, shard(batch))
        if split_axes:
            grads = reduce_grads(grads)
            metrics = {k: (col.all_reduce_axes(v, mesh, split_axes) if k == "tokens"
                           else mean_over(v, split_axes)) for k, v in metrics.items()}
            loss = mean_over(loss, split_axes)
        elif sp is not None:
            grads = reduce_grads(grads)
        return loss, metrics, grads

    def update(grads, opt_state, params):
        return opt.update(grads, opt_state, params, mesh=mesh, norm_axes=norm_axes)

    def step(params, opt_state: OptState, batch):
        loss, metrics, grads = gradients(params, batch)
        params, opt_state, opt_metrics = update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    def step_compressed(params, opt_state: OptState, batch, err):
        """The pod axis's share of the gradient reduction in int8 with
        error feedback: each pod's gradients (averaged over its "data"
        ranks exactly) go through ``compressed_psum`` over "pod"."""
        loss, metrics, grads = gradients(params, batch)
        grads, err = compressed_grad_tree(grads, mesh, "pod", err)
        params, opt_state, opt_metrics = update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics), err

    fn = step_compressed if compress_pod_grads else step
    fn.gradients, fn.update = gradients, update
    return fn


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
