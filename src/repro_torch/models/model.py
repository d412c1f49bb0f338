"""The dense decoder: init, forward, prefill and the decode steps.

Port of the JAX package's ``models/model.py`` for family ``"dense"``.
Parameters are a plain dict of tensors in the JAX package's layouts,
layer-stacked along a leading [L] axis (``wq [L,D,H,hd]``, ``wo
[L,H,hd,D]``, ``w1 [L,D,F]``, …); ``params_from_reference`` turns the
JAX package's parameter pytree, given as numpy arrays, into them. The
layer stack is a Python loop (PyTorch runs eagerly: there is no trace to
keep compact). Speculative verify and chunked prefill wait for ROADMAP
§1 item 6; the other families for item 10.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed_tokens, rms_norm, swiglu


def prefill_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two ≥ ``n`` (≥ 1), clamped to ``cap``: prompts
    pad to these widths, as the reference pads them."""
    w = 1 << max(0, int(n) - 1).bit_length()
    return min(w, cap) if cap is not None else w


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Stateless model wrapper: methods take the parameters explicitly.
    ``device`` defaults to CUDA and raises when none is present."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP §1 item 10); "
                "the port serves the dense family"
            )
        if cfg.kv_quant:
            raise NotImplementedError(
                "int8 KV (kv_quant) is not ported yet (ROADMAP §1 item 3, §2 item 1)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self._views = None  # (params, per-layer views) of the last params seen

    # ------------------------------------------------------------------
    # parameters
    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters, drawn on the model's device from a
        ``torch.Generator`` with the JAX package's scales (its stream
        differs from ``jax.random``'s)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        L, D, H, KV, hd = cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        F, V = cfg.d_ff, cfg.padded_vocab

        def normal(shape, scale):
            x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            return (x * scale).to(dt)

        def ones(*shape):
            return torch.ones(shape, device=dev, dtype=dt)

        params: dict[str, Any] = {
            "embed": normal((V, D), D**-0.5),
            "final_norm": ones(D),
            "layers": {
                "attn": {
                    "wq": normal((L, D, H, hd), D**-0.5),
                    "wk": normal((L, D, KV, hd), D**-0.5),
                    "wv": normal((L, D, KV, hd), D**-0.5),
                    "wo": normal((L, H, hd, D), (H * hd) ** -0.5),
                },
                "attn_norm": ones(L, D),
                "mlp_norm": ones(L, D),
                "mlp": {
                    "w1": normal((L, D, F), D**-0.5),
                    "w3": normal((L, D, F), D**-0.5),
                    "w2": normal((L, F, D), F**-0.5),
                },
            },
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((D, V), D**-0.5)
        return params

    def params_from_reference(self, tree) -> dict:
        """The JAX package's parameter pytree (nested dicts of numpy
        arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's
        parameters: same keys and layouts, on this model's device and
        dtype."""
        if isinstance(tree, dict):
            return {k: self.params_from_reference(v) for k, v in tree.items()}
        arr = np.array(tree, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=self.device, dtype=self.dtype)

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

    # ------------------------------------------------------------------
    # layer stack
    def _dense_layer(self, x, lp, backend, **kw):
        cfg = self.cfg
        h, new_kv = attn.attention_block(
            lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
            cfg=cfg, backend=backend, **kw,
        )
        x = x + h
        hin = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(hin, lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"])
        return x, new_kv

    def forward(self, params, tokens, *, backend=None):
        """tokens [B,S] → (final-normed hidden [B,S,D], per-layer (k, v)
        [B,S,KV,hd] for the cache)."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        x = embed_tokens(params["embed"], self._tokens(tokens))
        caches = []
        for lp in self._layer_params(params):
            x, kv = self._dense_layer(x, lp, backend)
            caches.append(kv)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps), caches

    # ------------------------------------------------------------------
    # caches
    def init_cache(self, batch, max_seq):
        """Dense decode cache: k/v [L,B,max_seq,KV,hd] and ``len`` [B] int32."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=self.device),
        }

    def init_paged_cache(self, num_blocks, block_size):
        """Physical block pool: k/v [L, num_blocks, block_size, KV, hd]."""
        pool = self.init_cache(num_blocks, block_size)
        pool.pop("len")
        return pool

    def read_cache_slot(self, pool, slot):
        """Batch slot ``slot`` of a pooled decode cache as a batch=1 cache
        (views into the pool)."""
        return {
            "k": pool["k"][:, slot : slot + 1],
            "v": pool["v"][:, slot : slot + 1],
            "len": pool["len"][slot : slot + 1],
        }

    def write_cache_slot(self, pool, slot_cache, slot):
        """Write a batch=1 cache into slot ``slot`` of ``pool``, in place
        (the reference returns an updated copy). Returns ``pool``."""
        S = slot_cache["k"].shape[2]
        pool["k"][:, slot, :S] = slot_cache["k"][:, 0].to(pool["k"].dtype)
        pool["v"][:, slot, :S] = slot_cache["v"][:, 0].to(pool["v"].dtype)
        pool["len"][slot] = slot_cache["len"][0]
        return pool

    def _fill_cache(self, B, max_seq, kvs, lengths):
        cache = self.init_cache(B, max_seq)
        for li, (k, v) in enumerate(kvs):
            cache["k"][li, :, : k.shape[1]] = k
            cache["v"][li, :, : v.shape[1]] = v
        cache["len"] = lengths.to(device=self.device, dtype=torch.int32)
        return cache

    # ------------------------------------------------------------------
    # prefill
    def prefill(self, params, tokens, max_seq, prompt_len=None, *, backend=None):
        """Run the prompt: (next-token logits [B,V], filled cache).
        ``prompt_len`` [B] marks real lengths when ``tokens`` is
        right-padded to a ``prefill_bucket``: logits come from each row's
        last real token and ``len`` is the real length (pad keys sit after
        every real query, so causal masking hides them)."""
        tokens = self._tokens(tokens)
        x, kvs = self.forward(params, tokens, backend=backend)
        B, S = tokens.shape
        if prompt_len is None:
            lengths = torch.full((B,), S, dtype=torch.int32)
        else:
            lengths = torch.as_tensor(np.asarray(prompt_len), dtype=torch.int32)
        idx = lengths.to(self.device).long() - 1
        x_last = x[torch.arange(B, device=self.device), idx]
        return x_last @ self._head(params), self._fill_cache(B, max_seq, kvs, lengths)

    def prefill_with_prefix(
        self, params, tokens, prefix_k, prefix_v, max_seq, suffix_len=None, *, backend=None
    ):
        """Suffix prefill over a cached prompt prefix. ``tokens`` [B,Ssuf]
        follow the prefix; ``prefix_k``/``prefix_v`` [L,B,h,KV,hd] are its
        post-RoPE KV rows. The suffix attends over prefix + suffix at
        ``q_offset = h``. Returns (logits [B,V], dense cache with the full
        prefix + suffix KV, len = h + Ssuf or h + ``suffix_len``)."""
        cfg = self.cfg
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        B, Ssuf = tokens.shape
        h = prefix_k.shape[2]
        x = embed_tokens(params["embed"], tokens)
        positions = (h + torch.arange(Ssuf, device=self.device))[None, :]
        kvs = []
        for li, lp in enumerate(self._layer_params(params)):
            x, kv = self._dense_layer(
                x, lp, backend, positions=positions,
                prefix_kv=(prefix_k[li], prefix_v[li]),
            )
            kvs.append(kv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if suffix_len is None:
            n = torch.full((B,), Ssuf, dtype=torch.int32)
        else:
            n = torch.as_tensor(np.asarray(suffix_len), dtype=torch.int32)
        x_last = x[torch.arange(B, device=self.device), n.to(self.device).long() - 1]
        return x_last @ self._head(params), self._fill_cache(B, max_seq, kvs, h + n)

    # ------------------------------------------------------------------
    # decode
    def decode_step(self, params, cache, tokens, *, backend=None):
        """Slot layout: tokens [B,1] → (logits [B,V], cache with each
        row's token written at its own length and ``len`` + 1). The k/v
        tensors are updated in place."""
        backend = kernel_ops.resolve_attention_backend(backend, self.device)
        tokens = self._tokens(tokens)
        x = embed_tokens(params["embed"], tokens)
        cache_len = cache["len"]
        positions = cache_len[:, None].long()
        for li, lp in enumerate(self._layer_params(params)):
            x, _ = self._dense_layer(
                x, lp, backend, positions=positions,
                cache=(cache["k"], cache["v"], li), cache_len=cache_len,
            )
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = (x @ self._head(params))[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}

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
            cache = {"k": pool["k"], "v": pool["v"], "tables": block_tables, "li": li}
            x, _ = self._dense_layer(
                x, lp, backend, positions=positions, cache=cache, cache_len=cache_len
            )
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self._head(params), pool
