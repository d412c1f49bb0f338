"""The decoder families: init, forward, prefill and the decode steps.

Port of the JAX package's ``models/model.py`` for every family it
registers: the dense decoder, the MoE (``"moe"``: each layer's MLP a
top-k routed expert MLP, ``models/moe.py``), the VLM (``"vlm"``: projected
patch embeddings prepended to the token embeddings, ``patch_proj``), the
audio decoder (``"audio"``: a dense decoder over codec tokens), the SSM
stack and the hybrid. Parameters are a plain dict of tensors in the JAX
package's layouts, layer-stacked along a leading [L] axis (``wq
[L,D,H,hd]``, ``wo [L,H,hd,D]``, ``w1 [L,D,F]``, ``moe/we1 [L,E,D,F]``,
``ssm/wx [L,D,Di]``, …); the hybrid's one shared attention block
(``params["shared"]``) has no layer axis. ``params_from_reference`` turns
the JAX package's parameter pytree, given as numpy arrays, into them. The
layer stack is a Python loop (PyTorch runs eagerly: there is no trace to
keep compact). The SSM family and the hybrid serve on the slot layout
only: their decode cache holds a recurrent state per layer
(``ssm_state``), with no sequence axis to page. The hybrid (Zamba2) runs
G = L / ``attn_every`` groups of ``attn_every`` SSM layers, each group
followed by the shared attention block and its SwiGLU MLP with a KV cache
of its own (one per site). A VLM prompt's patch rows lead its tokens in
the cache: its length counts them. ``kv_quant`` stores the KV cache (slot
cache or paged pool) in int8 with bfloat16 per-vector scales.
``verify_step`` and ``verify_step_paged`` run a speculative verify (T =
K+1 tokens a row, one forward); ``prefill_chunk`` is a verify over a
batch-1 dense cache that commits only a chunk's real tokens, and
``seed_cache_with_prefix`` starts such a cache from a prefix-cache hit.
The family sets below say which family each of them serves, as the
reference's do. ``jit_step`` compiles a step with its backend bound
(``step_graph.StepGraph``: a CUDA graph a key on the card, where the
reference has ``jax.jit``). Serving drops the MoE's aux loss, as the
reference's serving steps do. ``loss`` is the training objective (the
reference route, remat a layer at a time, the MoE aux loss kept), with
``param_axes`` and ``abstract_params`` beside ``init``; on a mesh it runs
split over "model" (heads or ``seq_sp`` for attention, the hidden dim for
SwiGLU, experts for a MoE, SSM heads for Mamba2, the vocabulary for the
embedding and the loss), its FSDP leaves gathered over "data" at each use,
and so do ``prefill`` and the slot layout's ``decode_step``, on the rank's
shard of the cache (its kv heads, or its range of positions where the kv
heads do not divide, its SSM heads).
"""
from __future__ import annotations

from typing import Any, Optional

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import step_graph
from repro_torch.models.layers import (chunked_softmax_xent, chunked_softmax_xent_split,
                                      embed_tokens, embed_tokens_split, rms_norm, swiglu,
                                      swiglu_split)
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sharding_mod
from repro_torch.parallel.sharding import ShardingRules, mesh_shape

# Families whose decode cache is addressed by position (the JAX package's
# ``ATTN_FAMILIES``): only they can page it.
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")

# Families whose suffix prefill over a cached prefix equals a cold
# prefill, so the paged layout may alias prompt blocks (the JAX package's
# ``PREFIX_FAMILIES``: MoE routing depends on tokens a call, VLM patch rows
# are not token-addressable).
PREFIX_FAMILIES = ("dense", "audio")

# Families the speculative verify serves: the KV cache must rewind
# (truncating ``len`` un-commits rejected drafts). SSM and hybrid state
# cannot rewind; MoE routing depends on tokens a call.
SPEC_FAMILIES = ("dense", "audio", "vlm")

# Families whose prefill may be right-padded to a bucketed shape without
# changing tokens: pad keys sit after every real query, so causal masking
# hides them. SSM is out: recurrent state integrates every position, pads
# included.
PAD_PREFILL_FAMILIES = ("dense", "audio", "vlm")

# Families the chunked prefill serves: PREFIX_FAMILIES, for the same
# reasons (a later chunk attends over cached earlier chunks as a suffix
# attends over a prefix hit; VLM patch rows do not chunk).
CHUNKED_PREFILL_FAMILIES = ("dense", "audio")

# leaves kept float32 whatever the model dtype, as the JAX package keeps them
FLOAT32_PARAMS = ssm_mod.FLOAT32_PARAMS + moe_mod.FLOAT32_PARAMS

# the baseline switch (``launch/dryrun.py --legacy``): the slot decode of the
# attention families and of the hybrid's shared site copies each layer's
# cache slice out and writes the whole slice back, where the default writes
# one token into the stack in place (the JAX package's pre-optimisation
# decode scan, whose xs/ys slice the cache a layer)
LEGACY_CACHE_SCAN = False


def _cache_site(cache, li, legacy):
    """(k_all, v_all, k_scale, v_scale, li) for the attention site ``li`` of
    a slot cache, and the function to call after it: the stacks themselves
    (nothing to do after), or under ``legacy`` a copy of the site's slice
    of each ([1, ...], index 0), written back whole after."""
    stacks = [cache.get(n) for n in ("k", "v", "k_scale", "v_scale")]
    if not legacy:
        return tuple(stacks) + (li,), lambda: None
    copies = [None if t is None else t[li:li + 1].clone() for t in stacks]

    def write_back():
        for t, c in zip(stacks, copies):
            if t is not None:
                t[li:li + 1].copy_(c)

    return tuple(copies) + (0,), write_back


def prefill_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two ≥ ``n`` (≥ 1), clamped to ``cap``: prompts
    pad to these widths, as the reference pads them."""
    w = 1 << max(0, int(n) - 1).bit_length()
    return min(w, cap) if cap is not None else w


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> list:
    """Per-layer dicts of a layer-stacked dict of tensors, each leaf an
    ``unbind`` view (its backward stacks the layers' gradients once)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


# remat "dots": products without a batch dimension are saved. ``einsum``
# lowers a projection (``bsd,dhk->bshk``) to a bmm of batch 1, and x @ w
# to mm; attention's score and value products are bmms over batch × heads
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS or (op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_SAVED = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _as_is(tree, *path):
    return tree


@dataclasses.dataclass(frozen=True)
class TrainSplit:
    """How a rank runs its share of a training step on a mesh: which
    regions the "model" axis splits (a region whose dims it does not divide
    runs whole on every rank), and the specs of the parameters as stored
    (``rules``) and as computed with (``rules.tp_view()``: the FSDP "data"
    axes gathered). ``attn``: "heads" (the q heads split), "seq" (the
    sequence-parallel fallback ``seq_sp``) or "" (no split)."""

    attn: str
    mlp: bool
    moe: bool
    ssm: bool
    vocab: bool
    storage: dict
    compute: dict
    grad_axes: dict  # each leaf's ``sharding.grad_sum_axes``


def _fsdp(t, stored, computed, mesh, how: str):
    """``t`` (a stored shard, or its gradient) between the stored and the
    compute layout: ``how`` "use" gathers the FSDP axes with the
    reduce-scatter backward, "gather" gathers them without a gradient,
    "scatter" reduce-scatters a compute-layout gradient back. Specs align
    from the right, so a per-layer view of a stacked leaf takes its
    stacked leaf's specs."""
    off = len(stored) - t.dim()
    for i in range(t.dim()):
        keep = sharding_mod.spec_axes(computed[off + i])
        # an axis of one rank holds the whole dim: nothing to gather
        axes = tuple(a for a in sharding_mod.spec_axes(stored[off + i])
                     if a not in keep and col.group_size(mesh, a) > 1)
        if not axes:
            continue
        if how == "use":
            t = col.gather(t, mesh, axes, dim=i, backward="reduce_scatter")
        elif how == "gather":
            t = col.all_gather_axes(t, mesh, axes, dim=i)
        else:
            t = col.reduce_scatter_axes(t, mesh, axes, dim=i)
    return t


def _map_paths(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching leaves of rest)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def _map_leaves(fn, tree, *rest, name=None):
    """``fn(key, leaf, *matching leaves of rest)`` over a nested dict,
    keeping its structure; ``key`` is the leaf's own dict key."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest), name=k) for k, v in tree.items()}
    return fn(name, tree, *rest)


class Model:
    """Stateless model wrapper: methods take the parameters explicitly.
    ``device`` defaults to CUDA and raises when none is present.

    ``mesh``: a ``DeviceMesh`` (``launch/mesh.py``) whose ``ShardingRules``
    the layers read: ``loss``, ``prefill`` and ``decode_step`` are then this
    rank's share of the step split over the mesh, on its shards of the
    parameters (``shard_params``, ``train_split``), and a paged step's MoE
    layer runs its expert-parallel paths.
    ``tp_axis`` / ``seq_axis`` make this model a rank's local view inside
    ``sharded_paged_step``: its cfg carries the rank's head counts, its
    paged attention gathers the head shards over ``tp_axis`` before the
    output projection and combines kv-sequence partials over ``seq_axis``,
    and ``mesh`` then only names the groups (a local view has no rules, as
    the JAX package's has none)."""

    def __init__(self, cfg: ModelConfig, device=None, *, mesh=None, tp_axis=None, seq_axis=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.mesh = mesh
        local_view = tp_axis is not None or seq_axis is not None
        self.rules = ShardingRules(mesh, cfg) if mesh is not None and not local_view else None
        self.tp_axis = tp_axis
        self.seq_axis = seq_axis
        # a head split's unsharded kv heads, for the paged kernel's plan
        # (set on the local view by sharded_paged_step)
        self.plan_kv_heads = None
        self._views = None  # (params, per-layer views) of the last params seen
        # the TrainSplit of a model holding rules, made here: a step counted
        # on meta tensors must not count the abstract init it reads
        self._split = self._make_split() if self.rules is not None else None
        self._graph_pool = None  # (memory pool, side stream) of the captured steps

    # ------------------------------------------------------------------
    # parameters
    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters, drawn on the model's device from a
        ``torch.Generator`` with the JAX package's scales (its stream
        differs from ``jax.random``'s)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        # a meta model (``abstract_params``) draws nothing
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(int(seed))
        L, D, H, KV, hd = cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        F, V = cfg.d_ff, cfg.padded_vocab

        def normal(shape, scale):
            # scaled in place: one float32 copy of a leaf at a time (a 20B
            # model's largest leaf is 19 GB in float32)
            x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            return x.mul_(scale).to(dt)

        def ones(*shape):
            return torch.ones(shape, device=dev, dtype=dt)

        params: dict[str, Any] = {
            "embed": normal((V, D), D**-0.5),
            "final_norm": ones(D),
        }

        def attn_block(lead, moe=False):
            """An attention layer and its SwiGLU MLP (``moe``: its routed
            expert MLP), each leaf with the leading dims ``lead`` (``(L,)``
            stacked, ``()`` shared)."""
            # attn_flat_tp: the flat layout, q/kv dims flattened (h·hd)
            q, kv = ((H * hd,), (KV * hd,)) if cfg.attn_flat_tp else ((H, hd), (KV, hd))
            block = {
                "attn": {
                    "wq": normal(lead + (D,) + q, D**-0.5),
                    "wk": normal(lead + (D,) + kv, D**-0.5),
                    "wv": normal(lead + (D,) + kv, D**-0.5),
                    "wo": normal(lead + q + (D,), (H * hd) ** -0.5),
                },
                "attn_norm": ones(*lead, D),
                "mlp_norm": ones(*lead, D),
            }
            if moe:
                block["moe"] = moe_mod.init_moe(cfg, dt, gen, lead=lead, device=dev)
            else:
                block["mlp"] = {
                    "w1": normal(lead + (D, F), D**-0.5),
                    "w3": normal(lead + (D, F), D**-0.5),
                    "w2": normal(lead + (F, D), F**-0.5),
                }
            return block

        if cfg.family in ("ssm", "hybrid"):
            params["layers"] = {
                "ssm": ssm_mod.init_ssm(cfg, dt, gen, lead=(L,), device=dev),
                "norm": ones(L, D),
            }
        else:
            params["layers"] = attn_block((L,), moe=cfg.family == "moe")
        if cfg.family == "hybrid":
            params["shared"] = attn_block(())
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((D, V), D**-0.5)
        if cfg.family == "vlm":
            params["patch_proj"] = normal((D, D), D**-0.5)
        return params

    def params_from_reference(self, tree) -> dict:
        """The JAX package's parameter pytree (nested dicts of numpy
        arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's
        parameters: same keys and layouts, on this model's device, in its
        dtype except the SSM scalars and the MoE router
        (``FLOAT32_PARAMS``), which stay float32 as the JAX package keeps
        them."""

        def leaf(name, arr):
            dt = torch.float32 if name in FLOAT32_PARAMS else self.dtype
            arr = np.array(arr, dtype=np.float32)  # a writable copy
            return torch.from_numpy(arr).to(device=self.device, dtype=dt)

        return _map_leaves(leaf, tree)

    def _layer_params(self, params):
        """Per-layer views of the stacked parameters, cached for the last
        ``params`` dict seen (views share storage with it)."""
        if self._views is None or self._views[0] is not params:
            layers = params["layers"]
            self._views = (params, [_index(layers, i) for i in range(self.cfg.num_layers)])
        return self._views[1]

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, device=self.device)

    def _lengths(self, n):
        """A length vector (a tensor, numpy array or list) as int32 on the
        device: a tensor converts on the device, so a captured step takes
        it from its static buffer."""
        if isinstance(n, torch.Tensor):
            return n.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(n), dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    # layer stack
    def _dense_layer(self, x, lp, backend, path="dispatch", want_aux=False, **kw):
        """An attention layer and its MLP → (x, new_kv, aux). ``path``: the
        MoE path a mesh's rules take ("dispatch" for prefill, "dense" for
        the decode steps, as the reference's callers pass it). ``aux``: a
        MoE layer's Switch aux loss where ``want_aux`` (training), else None
        (serving drops it, as the reference's serving steps do)."""
        cfg = self.cfg
        h, new_kv = attn.attention_block(
            lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
            cfg=cfg, backend=backend, mesh=self.mesh, tp_axis=self.tp_axis,
            seq_axis=self.seq_axis, plan_kv_heads=self.plan_kv_heads, **kw,
        )
        x = x + h
        hin = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        aux = None
        if "moe" in lp and (self.rules is not None or want_aux):
            h, aux = moe_mod.moe_block(hin, lp["moe"], cfg, self.rules, path=path)
        elif "moe" in lp:
            h = moe_mod.moe_mlp(hin, lp["moe"], cfg)
        else:
            h = swiglu(hin, lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"])
        return x + h, new_kv, aux

    def _ssm_layer(self, x, lp, backend, state=None, want_state=False):
        cfg = self.cfg
        h, new_state = ssm_mod.ssm_block(
            lp["ssm"], rms_norm(x, lp["norm"], cfg.norm_eps), cfg,
            state=state, want_state=want_state, backend=backend,
        )
        return x + h, new_state

    def _hybrid_groups(self, params):
        """The hybrid's layer stack as G = L / ``attn_every`` groups of
        (layer index, per-layer views): each group's SSM layers run before
        one application of the shared block."""
        per = self.cfg.attn_every
        views = self._layer_params(params)
        G = self.cfg.num_layers // per
        return [[(i, views[i]) for i in range(gi * per, (gi + 1) * per)] for gi in range(G)]

    def _embed_inputs(self, params, tokens, patch_embeds, lookup=embed_tokens, use=_as_is):
        """Token embeddings [B,S,D]; a VLM's projected ``patch_embeds``
        [B,P,D] lead them: [B,P+S,D]. ``lookup`` / ``use``: a split training
        step's table lookup and its FSDP gather of a leaf before its use."""
        x = lookup(use(params["embed"], "embed"), self._tokens(tokens))
        if self.cfg.family == "vlm":
            if patch_embeds is None:
                raise ValueError("a vlm prompt needs its patch_embeds [B, P, d_model]")
            pe = torch.as_tensor(patch_embeds, device=self.device).to(x.dtype)
            x = torch.cat([pe @ use(params["patch_proj"], "patch_proj"), x], dim=1)
        return x

    def forward(self, params, tokens, *, patch_embeds=None, backend=None):
        """tokens [B,S] → (final-normed hidden [B,S',D], cache entries):
        per layer (k, v) [B,S',KV,hd] for the attention families and the
        final state dict for the SSM family; for the hybrid, the pair
        (per-site (k, v) of the shared block, per-layer states). The VLM
        takes ``patch_embeds`` [B,P,D], projected by ``patch_proj`` and
        prepended to the token embeddings: S' = P + S. Prefill attention
        runs on the unquantized k/v; only a cache stores them in int8."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        x = self._embed_inputs(params, tokens, patch_embeds)
        caches = []
        if self.cfg.family == "hybrid":
            kvs = []
            for group in self._hybrid_groups(params):
                for _, lp in group:
                    x, entry = self._ssm_layer(x, lp, backend, want_state=True)
                    caches.append(entry)
                x, kv, _ = self._dense_layer(x, params["shared"], backend)
                kvs.append(kv)
            caches = (kvs, caches)
        else:
            for lp in self._layer_params(params):
                if self.cfg.family == "ssm":
                    x, entry = self._ssm_layer(x, lp, backend, want_state=True)
                else:
                    x, entry, _ = self._dense_layer(x, lp, backend)
                caches.append(entry)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps), caches

    # ------------------------------------------------------------------
    # training
    def loss(self, params, batch, *, gathered: bool = False):
        """The JAX package's ``Model.loss``: ``batch`` tokens [B,S], labels
        [B,S] and mask [B,S] (+ ``patch_embeds`` [B,P,D] for a VLM) →
        (loss, {"ce", "aux", "tokens"}). The forward runs on the reference
        route (no kernel has a backward), a layer at a time under
        ``cfg.remat``; a VLM's patch rows predict nothing; the head is
        ``embed.T`` when tied; loss = ce + 0.01 · aux, aux the MoE layers'
        Switch losses summed (0 for the other families).

        On a mesh (a model holding ``rules``) ``params`` are this rank's
        shards (``shard_params``) and the forward is the rank's share of the
        split step (``_forward_train``); the loss comes out replicated over
        "model". An FSDP leaf is gathered over "data" at each use (in each
        remat unit, so again in its recompute), unless ``gathered``: then
        ``params`` are already in the compute layout (``fsdp_gather``)."""
        cfg = self.cfg
        x, aux = self._forward_train(params, batch["tokens"], batch.get("patch_embeds"),
                                     gathered=gathered)
        if cfg.family == "vlm":
            x = x[:, cfg.n_frontend_tokens:, :]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        mask = torch.as_tensor(batch["mask"], device=self.device)
        sp = self.train_split
        if sp is None:
            ce, cnt = chunked_softmax_xent(x, self._head(params), labels, mask)
        else:
            use = _as_is if gathered else self._use
            head = (use(params["embed"], "embed").T if cfg.tie_embeddings
                    else use(params["lm_head"], "lm_head"))
            ce, cnt = (chunked_softmax_xent_split(x, head, labels, mask, self.mesh)
                       if sp.vocab else chunked_softmax_xent(x, head, labels, mask))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": cnt}

    def _forward_train(self, params, tokens, patch_embeds=None, gathered=False):
        """The training forward: (final-normed hidden [B,S',D], aux loss),
        with no cache. A layer — for the hybrid, a group of ``attn_every``
        SSM layers and the shared block after it — is one unit of
        ``_maybe_remat``, as a scan body is in the JAX package. The layers
        are ``unbind`` views of the stacked leaves, whose backward stacks
        the layers' gradients once. On a mesh each layer runs as the rank's
        share of it (``_split_block``, ``ssm_block_split``), its FSDP leaves
        gathered inside the unit."""
        cfg = self.cfg
        sp = self.train_split
        use = self._use if sp is not None and not gathered else _as_is
        lookup = embed_tokens
        if sp is not None and sp.vocab:
            lookup = functools.partial(embed_tokens_split, mesh=self.mesh)
        x = self._embed_inputs(params, tokens, patch_embeds, lookup, use)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        layers = _unstack(params["layers"])

        def ssm(x, lp):
            lp = use(lp, "layers")
            if sp is not None and sp.ssm:
                h = rms_norm(x, lp["norm"], cfg.norm_eps)
                return x + ssm_mod.ssm_block_split(lp["ssm"], h, cfg, self.mesh)[0]
            return self._ssm_layer(x, lp, "reference")[0]

        def block(x, lp, path):
            lp = use(lp, path)
            if sp is None:
                x, _, a = self._dense_layer(x, lp, "reference", want_aux=True)
                return x, a
            return self._split_block(x, lp, sp)

        def group(x, shared, lps):
            for lp in lps:
                x = ssm(x, lp)
            return block(x, shared, "shared")[0]

        if cfg.family == "ssm":
            body = self._maybe_remat(ssm)
            for lp in layers:
                x = body(x, lp)
        elif cfg.family == "hybrid":
            body, per = self._maybe_remat(group), cfg.attn_every
            for g in range(0, cfg.num_layers, per):
                x = body(x, params["shared"], layers[g:g + per])
        else:
            body = self._maybe_remat(functools.partial(block, path="layers"))
            for lp in layers:
                x, a = body(x, lp)
                if a is not None:
                    aux = aux + a
        return rms_norm(x, use(params["final_norm"], "final_norm"), cfg.norm_eps), aux

    def _split_block(self, x, lp, sp):
        """An attention layer and its MLP (or MoE) as this rank's share of
        the split over "model" → (x, aux or None); a region the axis does not
        split (its dims do not divide) runs whole on every rank."""
        cfg, mesh = self.cfg, self.mesh
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if sp.attn:
            h = attn.attention_train_split(lp["attn"], h, cfg=cfg, mesh=mesh)
        else:
            h = attn.attention_block(lp["attn"], h, cfg=cfg, backend="reference")[0]
        x = x + h
        hin = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        aux = None
        if "moe" in lp:
            if sp.moe:
                h, aux = moe_mod.moe_train_split(hin, lp["moe"], cfg, mesh)
            else:
                h, aux = moe_mod.moe_block(hin, lp["moe"], cfg)
        else:
            mlp = (lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"])
            h = swiglu_split(hin, *mlp, mesh) if sp.mlp else swiglu(hin, *mlp)
        return x + h, aux

    def _maybe_remat(self, fn):
        """``fn`` under ``cfg.remat``: "none" as it is, "full" under a
        non-reentrant checkpoint (its inputs saved, everything recomputed:
        JAX's ``nothing_saveable``), "dots" under a selective one that saves
        the products with no batch dimension and recomputes the rest
        (``_dots_policy``: JAX's ``dots_with_no_batch_dims_saveable``).
        Outside grad mode there is nothing to save, and ``fn`` runs as it
        is. The loss route draws no random number, so the checkpoints keep
        no generator state (``preserve_rng_state=False``): reading and
        setting the CUDA generator's state has no place in a captured train
        step."""
        remat = self.cfg.remat
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
        if remat == "none" or not torch.is_grad_enabled():
            return fn
        kw = {"context_fn": _DOTS_SAVED} if remat == "dots" else {}
        return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                                 **kw)

    def param_axes(self) -> dict:
        """The logical axes of every parameter, in the structure of
        ``init``'s tree: the axes tree the JAX package's ``init`` returns
        beside its parameters (a stacked layer leaf leads with
        "layers")."""
        cfg = self.cfg

        def attn_block(moe):
            if cfg.attn_flat_tp:
                attn_axes = {"wq": ("embed", "qdim"), "wk": ("embed", "qdim"),
                             "wv": ("embed", "qdim"), "wo": ("qdim", "embed")}
            else:
                attn_axes = {"wq": ("embed", "heads", "head_dim"),
                             "wk": ("embed", "kv_heads", "head_dim"),
                             "wv": ("embed", "kv_heads", "head_dim"),
                             "wo": ("heads", "head_dim", "embed")}
            block = {
                "attn": attn_axes,
                "attn_norm": ("embed",),
                "mlp_norm": ("embed",),
            }
            if moe:
                block["moe"] = dict(moe_mod.MOE_AXES)
            else:
                block["mlp"] = {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
                                "w2": ("mlp", "embed")}
            return block

        axes: dict[str, Any] = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        if cfg.family == "vlm":
            axes["patch_proj"] = (None, "embed")
        if cfg.family in ("ssm", "hybrid"):
            layer = {"ssm": dict(ssm_mod.SSM_AXES), "norm": ("embed",)}
        else:
            layer = attn_block(cfg.family == "moe")
        axes["layers"] = _map_leaves(lambda _, ax: ("layers",) + ax, layer)
        if cfg.family == "hybrid":
            axes["shared"] = attn_block(False)
        return axes

    def abstract_params(self):
        """(parameters as meta tensors, ``param_axes()``): ``init``'s shapes
        and dtypes with no storage allocated (the JAX package's
        ``eval_shape`` of ``init``)."""
        return Model(self.cfg, device="meta").init(), self.param_axes()

    # ------------------------------------------------------------------
    # training split over a mesh
    @property
    def train_split(self) -> Optional[TrainSplit]:
        """This model's ``TrainSplit`` on its mesh (None without rules)."""
        return self._split

    def _make_split(self) -> TrainSplit:
        cfg, rules = self.cfg, self.rules
        shapes, axes = self.abstract_params()
        storage = sharding_mod.tree_specs(shapes, axes, rules)
        compute = sharding_mod.tree_specs(shapes, axes, rules.tp_view())
        split = mesh_shape(self.mesh).get("model", 1) > 1
        layer = compute["layers"]

        def splits(spec, dim):
            return split and "model" in sharding_mod.spec_axes(spec[dim])

        attn_on = split and cfg.family != "ssm"
        w1 = (compute.get("shared") or layer).get("mlp", {}).get("w1")
        flags = dict(
            attn=("heads" if rules.table["heads"] == "model" else "seq") if attn_on else "",
            mlp=w1 is not None and splits(w1, -1),  # (…, "embed", "mlp")
            moe=split and cfg.family == "moe",
            ssm="ssm" in layer and splits(layer["ssm"]["wdt"], -1),  # (…, "ssm_heads")
            vocab=splits(compute["embed"], 0),  # ("vocab", "embed")
        )
        region = {"attn": bool(flags["attn"]), "mlp": flags["mlp"], "moe": flags["moe"],
                  "ssm": flags["ssm"]}

        def sum_axes(path, spec):
            # rule B: a leaf replicated over "model" inside a split region
            # (the block's own sub-dict names its region)
            inside = path[0] in ("layers", "shared") and region.get(path[1], False)
            return sharding_mod.grad_sum_axes(spec, self.mesh, rules.table["batch"], inside)

        return TrainSplit(storage=storage, compute=compute,
                          grad_axes=_map_paths(sum_axes, storage), **flags)

    def _use(self, tree, *path):
        """``tree`` (stored shards under ``path`` of the parameters) in the
        compute layout: its FSDP leaves gathered over "data" here, at their
        use, the gradient reduce-scattered back."""
        return self._fsdp_map("use", tree, path)

    def _fsdp_map(self, how, tree, path=()):
        """``_fsdp(leaf, …, how)`` over ``tree``, the parameters' sub-tree
        under ``path``."""
        st, ct = self.train_split.storage, self.train_split.compute
        for k in path:
            st, ct = st[k], ct[k]
        return _map_leaves(lambda _, t, s_, c_: _fsdp(t, s_, c_, self.mesh, how), tree, st, ct)

    def shard_params(self, params) -> dict:
        """This rank's shard of every leaf of the whole ``params`` (or of an
        optimizer moment tree in their structure), as ``rules`` places it."""
        return sharding_mod.shard_tree(params, self.param_axes(), self.rules, self.mesh)

    def gather_params(self, shards) -> dict:
        """``shard_params``'s inverse: the whole leaves, on every rank."""
        return sharding_mod.gather_tree(shards, self.train_split.storage, self.mesh)

    def fsdp_gather(self, shards) -> dict:
        """The stored shards in the compute layout (``rules.tp_view()``):
        the FSDP "data" axes gathered, with no gradient (ZeRO-2's gather
        once a step)."""
        return self._fsdp_map("gather", shards)

    def fsdp_scatter(self, grads) -> dict:
        """Gradients in the compute layout reduce-scattered back to the
        stored shards (``fsdp_gather``'s transpose)."""
        return self._fsdp_map("scatter", grads)

    # ------------------------------------------------------------------
    # caches
    @property
    def kv_names(self) -> tuple:
        """The KV leaves of a decode cache."""
        return ("k", "v", "k_scale", "v_scale") if self.cfg.kv_quant else ("k", "v")

    def init_cache(self, batch, max_seq, dtype=None, kv_heads=None):
        """Decode cache with ``len`` [B] int32. Dense: k/v
        [L,B,max_seq,KV,hd]. SSM: ``ssm_state`` leaves stacked over layers,
        ``ssm`` [L,B,H,hd,N] float32 and ``conv_x``/``conv_B``/``conv_C``
        [L,B,K-1,C] in the model dtype. Hybrid: ``ssm_state`` over all L
        layers and k/v over the G attention sites. ``kv_quant``: k/v int8
        and ``k_scale``/``v_scale`` [n,B,max_seq,KV] bfloat16. ``dtype``
        overrides the model dtype of the k/v and conv leaves, as the
        reference's does (an int8 cache stays int8); ``kv_heads`` the kv
        heads of the k/v leaves (a rank's shard of them on a mesh)."""
        cfg, L = self.cfg, self.cfg.num_layers
        dt = dtype or self.dtype
        cache: dict[str, Any] = {
            "len": torch.zeros((batch,), dtype=torch.int32, device=self.device)
        }
        if cfg.family in ("ssm", "hybrid"):
            st = ssm_mod.init_ssm_state(cfg, batch, dt, self.device)
            cache["ssm_state"] = {k: v.new_zeros((L,) + tuple(v.shape)) for k, v in st.items()}
        if cfg.family == "ssm":
            return cache
        n = L // cfg.attn_every if cfg.family == "hybrid" else L
        shape = (n, batch, max_seq, kv_heads or cfg.n_kv_heads, cfg.head_dim)
        kv_dtype = torch.int8 if cfg.kv_quant else dt
        for name in self.kv_names:
            if name.endswith("_scale"):
                cache[name] = torch.zeros(shape[:4], dtype=torch.bfloat16, device=self.device)
            else:
                cache[name] = torch.zeros(shape, dtype=kv_dtype, device=self.device)
        return cache

    def init_paged_cache(self, num_blocks, block_size, dtype=None, kv_heads=None):
        """Physical block pool: k/v [L, num_blocks, block_size, KV, hd], in
        ``dtype`` (the model's by default); ``kv_quant``: int8 k/v with
        bfloat16 ``k_scale``/``v_scale`` [L, num_blocks, block_size, KV].
        ``kv_heads``: KV, where a rank holds its shard of the heads.
        Attention families only: SSM state has no sequence axis to page."""
        if self.cfg.family not in ATTN_FAMILIES:
            raise ValueError(
                f"paged KV cache needs an attention family, got {self.cfg.family!r}"
            )
        pool = self.init_cache(num_blocks, block_size, dtype=dtype, kv_heads=kv_heads)
        pool.pop("len")
        return pool

    def cache_axes(self, cache):
        """Logical axes of every cache leaf, in its structure (the JAX
        package's ``cache_axes``, for the sharding rules)."""

        def leaf_axes(name, leaf):
            if name in ("k_scale", "v_scale"):
                return (None, "batch", "kv_seq", "kv_heads")
            if name in ("k", "v"):
                return (None, "batch", "kv_seq", "kv_heads", None)
            if name == "ssm":
                return (None, "batch", "ssm_heads", None, None)
            if name == "conv_x":
                return (None, "batch", None, "ssm_inner")
            if name in ("conv_B", "conv_C"):
                return (None, "batch", None, None)
            if name == "len":
                return (None,)
            return (None,) * leaf.dim()

        return _map_leaves(leaf_axes, cache)

    def paged_pool_specs(self, axis="model", seq_axis=None):
        """Specs of the block-pool leaves on a serving mesh: the kv-head
        dim over ``axis`` (the head split) and the block dim over
        ``seq_axis`` (the kv-sequence split); tables and lengths are data,
        replicated (``parallel.sharding.paged_pool_specs``)."""
        return sharding_mod.paged_pool_specs(axis, seq_axis, quantized=bool(self.cfg.kv_quant))

    def cache_batch_axes(self, cache):
        """Per-leaf batch-axis index of a decode cache, in its structure:
        ``len`` is batch-leading, every other leaf has its batch on axis
        1, after the layer axis (the JAX package's ``cache_batch_axes``).
        The decode Region slices per-request views through it."""
        return _map_leaves(lambda name, t: 0 if name == "len" else 1, cache)

    def read_cache_slot(self, pool, slot, n: int = 1):
        """Batch slot ``slot`` of a pooled decode cache as a batch=1 cache
        (views into the pool), or the ``n`` slots from it as a batch=n one.
        Every leaf but ``len`` has its batch on axis 1, after the layer
        axis."""
        return _map_leaves(
            lambda name, t: t[slot : slot + n] if name == "len" else t[:, slot : slot + n],
            pool,
        )

    def write_cache_slot(self, pool, slot_cache, slot):
        """Write a batch=1 cache into slot ``slot`` of ``pool``, in place
        (the reference returns an updated copy). Every state leaf of the
        slot is replaced whole, so a reused slot keeps nothing of its last
        owner; KV rows (and their scales) may be shorter than the pool's
        ``max_seq``. Returns ``pool``."""

        def put(name, leaf, src):
            if name == "len":
                leaf[slot] = src[0]
                return
            ok = src.shape[:2] == (leaf.shape[0], 1) and src.shape[3:] == leaf.shape[3:]
            ok = ok and (src.shape[2] <= leaf.shape[2] if name in self.kv_names
                         else src.shape[2] == leaf.shape[2])
            if not ok:
                raise ValueError(
                    f"cache leaf {name!r}: slot write of shape {tuple(src.shape)} "
                    f"into a pool of shape {tuple(leaf.shape)}"
                )
            leaf[:, slot, : src.shape[2]] = src[:, 0].to(leaf.dtype)

        _map_leaves(put, pool, slot_cache)
        return pool

    def _fill_cache(self, B, max_seq, kvs, lengths, into=None):
        """A decode cache holding the (k, v) rows of each layer (or site),
        quantized for ``kv_quant``, with ``len`` = ``lengths``: a new one,
        or ``into`` (a cache of B rows and ``max_seq``, a caller's staging
        storage) zeroed and filled in place."""
        if into is None:
            cache = self.init_cache(B, max_seq)
        else:
            cache = into
            for name in self.kv_names:
                if name in cache:
                    cache[name].zero_()
        for li, (k, v) in enumerate(kvs):
            vals = {"k": k, "v": v}
            if self.cfg.kv_quant:
                (vals["k"], vals["k_scale"]), (vals["v"], vals["v_scale"]) = (
                    attn.quantize_kv(k), attn.quantize_kv(v))
            for name, val in vals.items():
                cache[name][li, :, : val.shape[1]] = val
        cache["len"] = self._lengths(lengths)
        return cache

    # ------------------------------------------------------------------
    # prefill
    def prefill(self, params, tokens, max_seq, prompt_len=None, *, patch_embeds=None,
                backend=None, into=None, batch_size=None):
        """Run the prompt: (next-token logits [B,V], filled cache).
        ``prompt_len`` [B] marks real lengths when ``tokens`` is
        right-padded to a ``prefill_bucket``: logits come from each row's
        last real token and ``len`` is the real length (pad keys sit after
        every real query, so causal masking hides them). A VLM's
        ``patch_embeds`` [B,P,D] lead the tokens: the P patch rows offset
        the logits index and count in ``len``. The SSM family
        takes no ``prompt_len``: its state would integrate the pads; its
        cache holds each layer's final state, and so does the hybrid's,
        beside its per-site KV. ``into``: a cache of B rows and ``max_seq``
        to write the new cache into (zeroed first) instead of a new one: a
        compiled prefill then keeps no cache of its own.

        A model that holds rules (``Model(cfg, mesh=mesh)``) runs this
        rank's share of the prefill on its shards of the parameters
        (``_prefill_split``): ``tokens`` (and ``patch_embeds``) are the whole
        batch, or with ``batch_size`` (the whole batch's rows) this rank's
        rows of it; the logits come back whole, the cache as this rank's
        shard."""
        cfg = self.cfg
        if self.rules is not None:
            if prompt_len is not None or into is not None:
                raise ValueError("a split prefill takes no prompt_len and no into= cache")
            return self._prefill_split(params, tokens, max_seq, patch_embeds, backend,
                                       batch_size)
        if prompt_len is not None and cfg.family not in PAD_PREFILL_FAMILIES:
            raise ValueError(
                f"padded prefill is only token-identical for "
                f"{PAD_PREFILL_FAMILIES}, got {cfg.family!r} (recurrent state "
                "integrates pad positions; MoE capacity depends on tokens-per-call)"
            )
        tokens = self._tokens(tokens)
        x, caches = self.forward(params, tokens, patch_embeds=patch_embeds, backend=backend)
        B, S = x.shape[0], x.shape[1]
        if prompt_len is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            n_lead = S - tokens.shape[1]  # VLM patch rows lead the tokens
            lengths = self._lengths(prompt_len) + n_lead
        idx = lengths.long() - 1
        x_last = x[torch.arange(B, device=self.device), idx]
        logits = x_last @ self._head(params)
        if cfg.family in ATTN_FAMILIES:
            return logits, self._fill_cache(B, max_seq, caches, lengths, into)
        if cfg.family == "ssm":
            cache = {"len": lengths} if into is None else {**into, "len": lengths}
        else:
            kvs, caches = caches
            cache = self._fill_cache(B, max_seq, kvs, lengths, into)
        if into is None:
            cache["ssm_state"] = {k: torch.stack([st[k] for st in caches]) for k in caches[0]}
        else:
            for li, st in enumerate(caches):
                for k, v in st.items():
                    into["ssm_state"][k][li].copy_(v)
            cache["ssm_state"] = into["ssm_state"]
        return logits, cache

    def prefill_with_prefix(
        self, params, tokens, prefix_k, prefix_v, max_seq, suffix_len=None, *, backend=None,
        into=None,
    ):
        """Suffix prefill over a cached prompt prefix. ``tokens`` [B,Ssuf]
        follow the prefix; ``prefix_k``/``prefix_v`` [L,B,h,KV,hd] are its
        post-RoPE KV rows. The suffix attends over prefix + suffix at
        ``q_offset = h``. Returns (logits [B,V], dense cache with the full
        prefix + suffix KV, len = h + Ssuf or h + ``suffix_len``), written
        ``into`` a caller's cache as ``prefill`` does. ``PREFIX_FAMILIES``
        only: a MoE suffix routes with another capacity than the cold
        prompt, and VLM patch rows are not token-addressable."""
        cfg = self.cfg
        if cfg.family not in PREFIX_FAMILIES:
            raise ValueError(
                f"prefix prefill is only token-identical for {PREFIX_FAMILIES}, "
                f"got {cfg.family!r} (MoE capacity routing / VLM patch rows diverge)"
            )
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        B, Ssuf = tokens.shape
        h = prefix_k.shape[2]
        x = embed_tokens(params["embed"], tokens)
        positions = (h + torch.arange(Ssuf, device=self.device))[None, :]
        kvs = []
        for li, lp in enumerate(self._layer_params(params)):
            x, kv, _ = self._dense_layer(
                x, lp, backend, positions=positions,
                prefix_kv=(prefix_k[li], prefix_v[li]),
            )
            kvs.append(kv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if suffix_len is None:
            n = torch.full((B,), Ssuf, dtype=torch.int32, device=self.device)
        else:
            n = self._lengths(suffix_len)
        x_last = x[torch.arange(B, device=self.device), n.long() - 1]
        return x_last @ self._head(params), self._fill_cache(B, max_seq, kvs, h + n, into)

    # ------------------------------------------------------------------
    # compiled steps
    def jit_step(self, name: str, backend=None):
        """One serving step (``decode_step``, ``verify_step``,
        ``decode_step_paged``, ``verify_step_paged``, ``prefill``,
        ``prefill_with_prefix`` or ``prefill_chunk``) compiled once per
        input signature, with the attention backend resolved once and bound
        (``step_graph.StepGraph``; the reference's ``jax.jit``). Each call
        makes a new callable with entries of its own, as each ``jax.jit``
        does: the engine keeps its families, so its schedulers share them."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        return step_graph.StepGraph(self, name, backend)

    def sharded_paged_step(self, name: str, mesh, backend=None, axis="model", seq_axis="seq"):
        """``jit_step``'s counterpart for paged serving on a mesh, for
        ``decode_step_paged`` and ``verify_step_paged``: this rank's shard
        of the step (``ShardedStep``). Everything but the pool (params,
        block tables, lengths, tokens, logits) is replicated; every rank of
        ``mesh`` calls it with the same arguments.

        Head split (``axis``): rank r slices its contiguous head block out
        of ``wq``/``wk``/``wv`` (q heads [r·H/P, (r+1)·H/P) and their kv
        groups: a GQA group never straddles ranks) and runs the unsharded
        step body through a local-view model whose cfg carries the rank's
        head counts; the head shards are gathered back before the whole
        ``wo``. The paged kernel splits each row as the single-device launch
        does (``plan_kv_heads``), so each head's attention is bitwise the
        single-device one given the same q/k/v.

        Sequence split (``seq_axis``): each rank owns a contiguous range of
        pool slots; attention localises the tables (``local_table_view``),
        runs the paged kernel's partials mode over its owned positions and
        combines the partials with ``collectives.distributed_softmax``: a
        cross-rank float reduction, equal to the single-device logits to
        rounding. Both compose on a 2D mesh. A 1×1 mesh is ``jit_step``."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device, mesh=mesh)
        cfg, shape = self.cfg, mesh_shape(mesh)
        tp = shape.get(axis, 1) if axis else 1
        sp = shape.get(seq_axis, 1) if seq_axis else 1
        if tp == 1 and sp == 1:
            return self.jit_step(name, backend)
        if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
            raise ValueError(
                f"n_kv_heads={cfg.n_kv_heads}/n_heads={cfg.n_heads} do not divide mesh axis "
                f"{axis!r} (size {tp}); ShardingRules dropped the head mapping — serve "
                "replicated instead"
            )
        local = Model(
            dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp),
            mesh=mesh, tp_axis=axis if tp > 1 else None,
            seq_axis=seq_axis if sp > 1 else None, device=self.device,
        )
        if tp > 1:
            local.plan_kv_heads = cfg.n_kv_heads
        return step_graph.ShardedStep(local, name, backend, self, mesh, axis, tp)

    def graph_pool(self):
        """(memory pool, side stream) that every captured step of this
        model shares: the graphs' memory, and the stream a step's first
        call and its capture run on."""
        if self._graph_pool is None:
            self._graph_pool = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device))
        return self._graph_pool

    # ------------------------------------------------------------------
    # decode
    def decode_step(self, params, cache, tokens, *, backend=None):
        """Slot layout: tokens [B,1] → (logits [B,V], cache with each
        row's token written at its own length and ``len`` + 1; for the SSM
        family and the hybrid, each layer's state advanced one step). The
        cache tensors are updated in place. With ``LEGACY_CACHE_SCAN`` an
        attention layer (or the hybrid's shared site) works on a copy of its
        cache slice and writes the whole slice back: the same values, more
        bytes moved (the baseline the dry run's ``--legacy`` counts). A model
        that holds rules runs this rank's share (``_decode_split``): its
        shards of the parameters and of the cache, ``len`` whole, the tokens
        whole or this rank's rows; the logits come back whole."""
        if self.rules is not None:
            return self._decode_split(params, cache, tokens, backend, LEGACY_CACHE_SCAN)
        logits = self._step_slot(params, cache, tokens, backend, LEGACY_CACHE_SCAN)
        return logits[:, 0], {**cache, "len": cache["len"] + 1}

    def _step_slot(self, params, cache, tokens, backend, legacy=False):
        """The slot layout's layer loop: tokens [B,T] at positions
        ``len + arange(T)`` → logits [B,T,V], the cache written in place
        (T = 1 for the SSM family and the hybrid); ``legacy``: each
        attention site on a copy of its slice (``_cache_site``)."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        x = embed_tokens(params["embed"], tokens)
        cache_len = cache["len"]
        T = tokens.shape[1]
        positions = cache_len[:, None].long() + torch.arange(T, device=self.device)[None, :]
        family = self.cfg.family

        def ssm_step(x, li, lp):
            st = {k: v[li] for k, v in cache["ssm_state"].items()}
            x, new_st = self._ssm_layer(x, lp, backend, state=st)
            for k, v in new_st.items():
                st[k].copy_(v)
            return x

        def attn_step(x, li, lp):
            kv, write_back = _cache_site(cache, li, legacy)
            x, _, _ = self._dense_layer(
                x, lp, backend, path="dense", positions=positions, cache=kv,
                cache_len=cache_len,
            )
            write_back()
            return x

        if family == "hybrid":
            for gi, group in enumerate(self._hybrid_groups(params)):
                for li, lp in group:
                    x = ssm_step(x, li, lp)
                x = attn_step(x, gi, params["shared"])
        else:
            step = ssm_step if family == "ssm" else attn_step
            for li, lp in enumerate(self._layer_params(params)):
                x = step(x, li, lp)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self._head(params)

    # ------------------------------------------------------------------
    # prefill and slot decode split over the mesh
    def _note(self, axes, shape) -> tuple:
        """The rules' spec of an activation of the whole ``shape``: what the
        JAX package's ``constrain`` asks at the same point of its forward,
        and records as it does when a mapping does not divide."""
        return self.rules.spec(axes, shape)

    def _batch_split(self, B):
        """(mesh axes, shards, this rank's shard) of a batch of ``B`` rows as
        the rules place it (replicated, and recorded, where it does not
        divide)."""
        axes = sharding_mod.spec_axes(self._note(("batch",), (B,))[0])
        return axes, sharding_mod.axis_size(self.mesh, axes), col.shard_index(self.mesh, axes)

    def _my_rows(self, t, B, n, i):
        """This rank's rows of a batch-leading ``t``: ``t`` holds all ``B``
        rows, or already this rank's ``B / n``."""
        t = torch.as_tensor(t, device=self.device)
        if t.shape[0] == B // n:
            return t
        if t.shape[0] != B:
            raise ValueError(f"{t.shape[0]} rows: neither the batch of {B} nor a shard of it")
        return t.narrow(0, i * (B // n), B // n)

    def _compute(self, tree, *path, keep=()):
        """``tree`` (stored shards under ``path`` of the parameters) in the
        compute layout, its FSDP "data" axes gathered, without a gradient;
        the sub-dicts named in ``keep`` stay as stored."""
        if keep and isinstance(tree, dict):
            return {k: v if k in keep else self._fsdp_map("gather", v, path + (k,))
                    for k, v in tree.items()}
        return self._fsdp_map("gather", tree, path)

    def _attn_split(self) -> dict:
        """How attention splits over "model": the q heads (``heads``), the
        kv heads with them (``kv_heads``: the cache's kv heads too), or the
        cache along its positions (``kv_seq``: the kv heads do not divide)."""
        heads = self.train_split.attn == "heads"
        return dict(heads=heads, kv_heads=heads and self.rules.kv_heads_ok,
                    kv_seq=bool(self.train_split.attn) and self.rules.table["kv_seq"] == "model")

    def _serve_block(self, x, lp, ppath, backend, path, B, **kw):
        """An attention layer and its MLP as this rank's share (x [B_l, S, D]
        of a batch of ``B`` rows) → (x, new kv of prefill or None). ``path``:
        the MoE path ("dispatch" for prefill, "dense" for decode, as the
        reference's callers pass it); the dense path keeps its expert F
        shards, every other FSDP leaf is gathered here."""
        cfg, mesh, sp = self.cfg, self.mesh, self.train_split
        lp = self._compute(lp, *ppath, keep=("moe",) if path == "dense" else ())
        if path == "dense" and "moe" in lp:  # the router whole, the experts' F as stored
            lp["moe"] = dict(lp["moe"], router=self._compute(lp["moe"]["router"], *ppath, "moe",
                                                             "router"))
        S = x.shape[1]
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qspec = self._note(("batch", "seq_sp", "heads", None), (B, S, H, hd))
        self._note(("batch", None, "kv_heads", None), (B, S, KV, hd))
        rows = sp.attn == "seq" and "model" in sharding_mod.spec_axes(qspec[1])
        h, kv = attn.attention_split(lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
                                     cfg=cfg, mesh=mesh, rows=rows, backend=backend,
                                     **self._attn_split(), **kw)
        self._note(("batch", "seq_sp", None), (B, S, cfg.d_model))
        x = x + h
        hin = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if "moe" in lp:
            if sp.moe:
                st = sp.storage[ppath[0]]["moe"]["we1"][-1]  # F of (…, "experts", None, "expert_mlp")
                f_axes = sharding_mod.spec_axes(st) if path == "dense" else ()
                baxes = sharding_mod.spec_axes(self._note(("batch",), (B,))[0])
                h = moe_mod.moe_serve_split(hin, lp["moe"], cfg, mesh, path, baxes, f_axes)
            else:
                h = moe_mod.moe_mlp(hin, lp["moe"], cfg)
        else:
            self._note((None, None, "mlp"), (B, S, cfg.d_ff))
            mlp = (lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"])
            h = swiglu_split(hin, *mlp, mesh) if sp.mlp else swiglu(hin, *mlp)
        return x + h, kv

    def _serve_ssm(self, x, lp, backend, B, state=None, want_state=False):
        """A Mamba2 layer as this rank's share → (x, its state or None)."""
        cfg = self.cfg
        lp = self._compute(lp, "layers")
        S = x.shape[1]
        self._note(("batch", "seq", "ssm_inner"), (B, S, cfg.ssm_d_inner))
        self._note(("batch", "seq", "ssm_heads", None), (B, S, cfg.ssm_heads, cfg.ssm_head_dim))
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        if self.train_split.ssm:
            y, st = ssm_mod.ssm_block_split(lp["ssm"], h, cfg, self.mesh, state=state,
                                            want_state=want_state, backend=backend)
        else:
            y, st = ssm_mod.ssm_block(lp["ssm"], h, cfg, state=state, want_state=want_state,
                                      backend=backend)
        return x + y, st

    def _logits_split(self, params, x, baxes, B):
        """x [B_l, D] (final-normed) → the whole logits [B, V] on every rank:
        the rank's vocabulary columns gathered over "model", its rows over
        the batch axes."""
        cfg = self.cfg
        head = (self._compute(params["embed"], "embed").T if cfg.tie_embeddings
                else self._compute(params["lm_head"], "lm_head"))
        logits = x @ head
        self._note(("batch", "vocab"), (B, cfg.padded_vocab))
        if self.train_split.vocab:
            logits = col.all_gather(logits, self.mesh, "model", dim=1)
        return col.all_gather_axes(logits, self.mesh, baxes, dim=0)

    def _embed_split(self, params, tokens, patch_embeds, B, prompt=True):
        """The rank's rows embedded (the vocabulary split where the rules
        split it); a prompt (``prompt``) leads with a VLM's patch rows."""
        lookup = embed_tokens
        if self.train_split.vocab:
            lookup = functools.partial(embed_tokens_split, mesh=self.mesh)
        if prompt:
            x = self._embed_inputs(params, tokens, patch_embeds, lookup, self._compute)
        else:
            x = lookup(self._compute(params["embed"], "embed"), tokens)
        self._note(("batch", "seq", None), (B, x.shape[1], self.cfg.d_model))
        return x

    def _prefill_split(self, params, tokens, max_seq, patch_embeds, backend, batch_size):
        """``prefill`` as this rank's share of a model split over its mesh:
        each layer as ``_serve_block`` / ``_serve_ssm`` splits it, on the
        rank's shards of the parameters (``shard_params``) → (the whole
        logits [B, V], this rank's shard of the cache as ``cache_axes`` and
        the rules lay it out: its batch rows, its kv heads or its range of
        positions, its SSM heads; ``len`` whole)."""
        cfg, mesh = self.cfg, self.mesh
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        B = batch_size or tokens.shape[0]
        baxes, nb, bi = self._batch_split(B)
        tokens = self._my_rows(tokens, B, nb, bi)
        if patch_embeds is not None:
            patch_embeds = self._my_rows(patch_embeds, B, nb, bi)
        x = self._embed_split(params, tokens, patch_embeds, B)
        S = x.shape[1]
        P = col.group_size(mesh, "model")
        r = col.axis_index(mesh, "model") if P > 1 else 0
        split = self._attn_split()
        if split["kv_seq"] and max_seq % P:
            raise ValueError(f"max_seq {max_seq} does not split over the 'model' axis ({P}): "
                             "the cache's positions are split there")
        kvs, states = [], []
        if cfg.family == "hybrid":
            for group in self._hybrid_groups(params):
                for _, lp in group:
                    x, st = self._serve_ssm(x, lp, backend, B, want_state=True)
                    states.append(st)
                x, kv = self._serve_block(x, params["shared"], ("shared",), backend, "dispatch",
                                          B)
                kvs.append(kv)
        else:
            for lp in self._layer_params(params):
                if cfg.family == "ssm":
                    x, st = self._serve_ssm(x, lp, backend, B, want_state=True)
                    states.append(st)
                else:
                    x, kv = self._serve_block(x, lp, ("layers",), backend, "dispatch", B)
                    kvs.append(kv)
        x = rms_norm(x, self._compute(params["final_norm"], "final_norm"), cfg.norm_eps)
        logits = self._logits_split(params, x[:, -1], baxes, B)
        cache = {"len": torch.full((B,), S, dtype=torch.int32, device=self.device)}
        if kvs:
            S_l = max_seq // P if split["kv_seq"] else max_seq
            lo = r * S_l if split["kv_seq"] else 0
            k0 = kvs[0][0]
            shape = (len(kvs), k0.shape[0], S_l, k0.shape[2], cfg.head_dim)
            for name in self.kv_names:
                dt = torch.bfloat16 if name.endswith("_scale") else (
                    torch.int8 if cfg.kv_quant else k0.dtype)
                cache[name] = torch.zeros(shape[:4] if name.endswith("_scale") else shape,
                                          dtype=dt, device=self.device)
            for li, (k, v) in enumerate(kvs):
                vals = {"k": k[:, lo:lo + S_l], "v": v[:, lo:lo + S_l]}
                if cfg.kv_quant:
                    (vals["k"], vals["k_scale"]), (vals["v"], vals["v_scale"]) = (
                        attn.quantize_kv(vals["k"]), attn.quantize_kv(vals["v"]))
                for name, val in vals.items():
                    cache[name][li, :, :val.shape[1]] = val
        if states:
            cache["ssm_state"] = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        return logits, cache

    def _decode_split(self, params, cache, tokens, backend, legacy):
        """``decode_step`` as this rank's share of a model split over its
        mesh, on its shards of the parameters and of the cache (written in
        place; ``len`` whole): the whole logits [B, V] and the cache with
        ``len`` + 1."""
        cfg = self.cfg
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        B = cache["len"].shape[0]
        baxes, nb, bi = self._batch_split(B)
        tokens = self._my_rows(self._tokens(tokens), B, nb, bi)
        cache_len = self._my_rows(cache["len"], B, nb, bi) if nb > 1 else cache["len"]
        x = self._embed_split(params, tokens, None, B, prompt=False)
        positions = cache_len[:, None].long()

        def ssm_step(x, li, lp):
            st = {k: v[li] for k, v in cache["ssm_state"].items()}
            x, new_st = self._serve_ssm(x, lp, backend, B, state=st)
            for k, v in new_st.items():
                st[k].copy_(v)
            return x

        def attn_step(x, li, lp, ppath):
            kv, write_back = _cache_site(cache, li, legacy)
            x, _ = self._serve_block(x, lp, ppath, backend, "dense", B, positions=positions,
                                     cache=kv, cache_len=cache_len)
            write_back()
            return x

        if cfg.family == "hybrid":
            for gi, group in enumerate(self._hybrid_groups(params)):
                for li, lp in group:
                    x = ssm_step(x, li, lp)
                x = attn_step(x, gi, params["shared"], ("shared",))
        else:
            for li, lp in enumerate(self._layer_params(params)):
                x = (ssm_step(x, li, lp) if cfg.family == "ssm"
                     else attn_step(x, li, lp, ("layers",)))
        x = rms_norm(x, self._compute(params["final_norm"], "final_norm"), cfg.norm_eps)
        logits = self._logits_split(params, x[:, 0], baxes, B)
        return logits, {**cache, "len": cache["len"] + 1}

    # ------------------------------------------------------------------
    # speculative verify and chunked prefill
    def _require_spec(self):
        if self.cfg.family not in SPEC_FAMILIES:
            raise ValueError(
                f"verify_step is only greedy-equivalent for {SPEC_FAMILIES}, "
                f"got {self.cfg.family!r} (SSM state cannot rewind; MoE capacity "
                "routing depends on tokens-per-call)"
            )

    def verify_step(self, params, cache, tokens, *, backend=None):
        """Slot layout: tokens [B,T] (the pending token and T-1 drafts) →
        (logits [B,T,V], cache with the T rows written and ``len`` + T).
        Position t's logits predict the token after ``tokens[:, t]``; the
        caller rewinds the rejected tail afterwards (``truncate_rows``):
        stale rows past ``len`` are masked off and overwritten later. The
        cache tensors are updated in place; dense and int8 caches."""
        self._require_spec()
        logits = self._step_slot(params, cache, tokens, backend)
        return logits, {**cache, "len": cache["len"] + tokens.shape[1]}

    def paged_view(self, pool, block_tables):
        """Dense [L, B, MB·BS, ...] per-row caches gathered from the block
        pool through ``block_tables`` [B, MB] (copies)."""
        return {name: attn.gather_block_rows(leaf, block_tables) for name, leaf in pool.items()}

    def verify_step_paged(self, params, pool, block_tables, cache_len, tokens, *, backend=None):
        """Speculative verify over the block pool: tokens [B,T] →
        (logits [B,T,V], pool with the T rows written). The kernel backend
        runs ``decode_step_paged``'s layer loop with T queries (the T
        positions may cross a block boundary: the scheduler claims every
        tail block first). The reference backend is the JAX package's
        differential route: gather each row's dense view, run
        ``verify_step`` on it, scatter the T new rows back through the
        tables (``scatter_block_tokens``; dead rows' writes land in the
        null block)."""
        self._require_spec()
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        # a kv-sequence split's rank runs the layer loop on either backend:
        # the dense route gathers through the global tables, which cannot
        # address its pool shard
        if backend != "reference" or self.seq_axis is not None:
            return self._step_paged_kernel(params, pool, block_tables, cache_len, tokens, backend)
        bs = pool["k"].shape[2]
        T = tokens.shape[1]
        dense = self.paged_view(pool, block_tables)
        logits, new_dense = self.verify_step(
            params, dict(dense, len=cache_len), tokens, backend="reference"
        )
        bid, off = attn.block_write_positions(block_tables, cache_len, T, bs)
        pos = cache_len.long()[:, None] + torch.arange(T, device=self.device)[None, :]
        rows = torch.arange(pos.shape[0], device=self.device)[:, None]
        for name, leaf in pool.items():
            attn.scatter_block_tokens(leaf, new_dense[name][:, rows, pos], bid, off)
        return logits, pool

    def prefill_chunk(self, params, cache, tokens, n_valid, *, backend=None):
        """One chunk of an incremental prefill: ``tokens`` [B,W] (right-
        padded to the chunk's pow2 width W) against a partly filled dense
        cache, committing ``n_valid`` [B] rows. It is ``verify_step`` with
        the length advanced by ``n_valid`` instead of W, so pad rows never
        commit (they land past the new ``len``, overwritten by the next
        chunk). Returns (logits [B,W,V], cache); ``logits[b,
        n_valid[b]-1]`` predicts the token after the chunk's last real
        token."""
        if self.cfg.family not in CHUNKED_PREFILL_FAMILIES:
            raise ValueError(
                f"chunked prefill is only token-identical for "
                f"{CHUNKED_PREFILL_FAMILIES}, got {self.cfg.family!r}"
            )
        logits, new_cache = self.verify_step(params, cache, tokens, backend=backend)
        new_cache["len"] = cache["len"] + self._lengths(n_valid)
        return logits, new_cache

    def seed_cache_with_prefix(self, prefix_k, prefix_v, max_seq, into=None):
        """A dense batch-1 cache holding a prefix-cache hit's KV rows
        ``prefix_k``/``prefix_v`` [L,1,h,KV,hd] (quantized for
        ``kv_quant``), with ``len = h``: where ``prefill_chunk`` goes on.
        ``into``: a batch-1 cache of ``max_seq`` to fill in place (a
        scheduler's staging cache) instead of a new one."""
        if self.cfg.family not in PREFIX_FAMILIES:
            raise ValueError(
                f"prefix seeding is only token-identical for {PREFIX_FAMILIES}, "
                f"got {self.cfg.family!r}"
            )
        h = prefix_k.shape[2]
        lengths = torch.full((prefix_k.shape[1],), h, dtype=torch.int32, device=self.device)
        kvs = [(prefix_k[li], prefix_v[li]) for li in range(prefix_k.shape[0])]
        return self._fill_cache(prefix_k.shape[1], max_seq, kvs, lengths, into=into)

    def decode_step_paged(self, params, pool, block_tables, cache_len, tokens, *, backend=None):
        """Paged layout: one decode token per row over the block pool
        (tables [B,MB] int32, committed lengths [B] int32) → (logits
        [B,V], pool). Both backends run the layer loop over the pool; the
        reference gathers each row's dense view per layer, the kernel
        walks the tables."""
        logits, pool = self._step_paged_kernel(
            params, pool, block_tables, cache_len, tokens, backend
        )
        return logits[:, 0], pool

    def _step_paged_kernel(self, params, pool, block_tables, cache_len, tokens, backend):
        """The decode layer loop over the block pool itself: tokens [B,T]
        → (logits [B,T,V], pool updated in place)."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        T = tokens.shape[1]
        x = embed_tokens(params["embed"], tokens)
        positions = cache_len.long()[:, None] + torch.arange(T, device=self.device)[None, :]
        for li, lp in enumerate(self._layer_params(params)):
            cache = {name: pool[name] for name in self.kv_names}
            cache.update(tables=block_tables, li=li)
            # a MoE layer routes the dead rows' tokens beside the live ones
            # and they take capacity ahead of them: their attention must be
            # the reference route's, not the null block's colliding writes
            x, _, _ = self._dense_layer(
                x, lp, backend, path="dense", positions=positions, cache=cache,
                cache_len=cache_len, dead_rows_own_view=self.cfg.family == "moe",
            )
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self._head(params), pool
