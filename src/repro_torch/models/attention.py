"""GQA attention for prefill and decode: the serving subset.

Port of the JAX package's ``models/attention.py``. Prefill runs
``gqa_attention`` — the chunked running-max reference, or the causal
flash kernel on the ``"kernel"`` backend. Decode, speculative verify
(``verify_attention``: T = K+1 queries) and chunked prefill (T = the
chunk's width over a batch-1 dense cache) run through the block-paged
decode kernel on both KV layouts: the paged pool directly, the slot
cache viewed as a pool with an identity block table. The
``"reference"`` backend keeps the JAX package's jnp numerics (dense
gather + masked softmax), the differential oracle. Under a transform or
a tracer the kernel is called as the operator
``repro_torch::paged_decode_attention``, whose vmap rule lets a decode
plan's per-request decode launch it once for all requests
(``paged_decode_call``).
An int8 cache (``kv_quant``), slot or paged, stores each new key and value
vector quantized (``quantize_kv``) beside its bfloat16 scale; the kernel
dequantizes in place, the reference dequantizes the layer's cache to q's
dtype first.

KV writes update the cache tensors in place (``index_put_``), where the
reference returns new arrays (``.at[].set``): an eager port would
otherwise copy a whole layer stack per token.

On a serving mesh ``attention_block`` runs a rank's shard of a paged step
(``Model.sharded_paged_step``): over a kv-sequence split it localises the
tables, runs the partials mode over the blocks this rank holds and
combines the partials across ``seq_axis`` (``distributed_softmax``); over a
head split it gathers the head shards across ``tp_axis`` before the whole
output projection.

``attention_train_split`` is a rank's share of the training attention on a
mesh (the reference route): its q heads when the heads divide the "model"
axis, else its rows of queries (``seq_sp``, the sequence-parallel
fallback); see its docstring. ``attention_split`` is a rank's share of the
serving attention of a model split over a mesh (its prefill and slot
decode, on either backend), over the same splits and the cache's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels.ref import _masked_partials, paged_partials_ref
import torch.nn.functional as F

from repro_torch.models.layers import apply_rope, rope_tables
from repro_torch.parallel import collectives

NEG = -1e30


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


# ---------------------------------------------------------------------------
# prefill


def _attn_chunk_step(q, kc, vc, k_pos, q_pos, m, l, acc, scale):
    """One flash step: q [B,Sq,H,hd] against one KV chunk [B,Ck,H,hd]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
    mask = q_pos[None, None, :, None] >= k_pos[None, None, None, :]
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype), vc)
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv.float()
    return m_new, l_new, acc_new


def gqa_attention(q, k, v, *, q_offset=0, chunk: int = 512, backend=None):
    """Causal GQA attention. q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (RoPE'd).
    ``q_offset`` is the absolute position of q[0] (Sq may be a suffix of
    Skv). The ``"kernel"`` backend runs the causal flash kernel; the
    reference scans KV chunks with a running max, as the JAX package's
    ``masked`` blocking does."""
    if kernel_ops.resolve_attention_backend(backend, q.device) == "kernel":
        kernel_ops.require_cuda(q, "gqa_attention")
        return _flash.flash_call(
            q.contiguous(), k.contiguous(), v.contiguous(), int(q_offset)
        )
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    n_rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Skv)
    while Skv % chunk:
        chunk -= 1
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=dev)
    for start in range(0, Skv, chunk):
        kc = _repeat_kv(k[:, start : start + chunk], n_rep)
        vc = _repeat_kv(v[:, start : start + chunk], n_rep)
        k_pos = start + torch.arange(chunk, device=dev)
        m, l, acc = _attn_chunk_step(q, kc, vc, k_pos, q_pos, m, l, acc, scale)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# block-paged pool helpers


def gather_block_rows(pool_leaf, block_tables):
    """Dense per-row view of a block-paged pool leaf: ``pool_leaf`` [L,
    NB, BS, ...], ``block_tables`` [B, MB] → [L, B, MB·BS, ...]. The
    reference path of the paged layout; the kernel walks the tables."""
    mb = block_tables.shape[1]
    t = pool_leaf[:, block_tables.long()]  # [L, B, MB, BS, ...]
    return t.reshape(t.shape[:2] + (mb * pool_leaf.shape[2],) + t.shape[4:])


def scatter_block_token(pool_leaf, token_rows, block_ids, offsets):
    """Write token rows into their blocks, in place. ``pool_leaf`` [NB,
    BS, ...] (one layer); ``block_ids``/``offsets`` [B] or [B, T] and
    ``token_rows`` of matching leading shape. Live rows write blocks they
    own exclusively (shared prefix blocks are never a write target); dead
    rows' writes land in the null block. Several dead rows at T > 1 write
    the same null-block positions: on CUDA which of them lands is not
    determined, which is harmless only because that block is scratch that
    no live row's window ever reads."""
    pool_leaf[block_ids.long(), offsets.long()] = token_rows.to(pool_leaf.dtype)


def scatter_block_tokens(pool_leaf, token_rows, block_ids, offsets):
    """Write T token rows per decode row into their tail blocks, in place,
    for every layer at once: ``pool_leaf`` [L, NB, BS, ...];
    ``token_rows`` [L, B, T, ...] (a verify's KV rows);
    ``block_ids``/``offsets`` [B, T] (the T positions may span a block
    boundary: the scheduler claims every tail block a verify can reach
    first, ``ensure_tail_n``). Dead rows' entries all point at the null
    block, so their colliding writes land in scratch, as in
    ``scatter_block_token``."""
    pool_leaf[:, block_ids.long(), offsets.long()] = token_rows.to(pool_leaf.dtype)


def block_write_positions(block_tables, cache_len, t, block_size):
    """Per-row (physical block id, in-block offset), each [B, t], of the
    ``t`` write positions starting at each row's committed length."""
    pos = cache_len.long()[:, None] + torch.arange(t, device=cache_len.device)[None, :]
    bid = torch.gather(block_tables.long(), 1, pos // block_size)
    return bid, pos % block_size


def _dense_as_pool(leaf, bs):
    """A dense per-row cache leaf [B, Smax, ...] viewed as a block pool
    [B·(Smax/bs), bs, ...] — a view of a contiguous leaf, no data
    movement (a reshape, so that a vmapped per-request leaf takes it too)."""
    B, Smax = leaf.shape[0], leaf.shape[1]
    return leaf.reshape((B * (Smax // bs), bs) + tuple(leaf.shape[2:]))


def _dense_block_size(smax, bs=256):
    """Largest divisor of ``smax`` that is ≤ ``bs``: the identity-table
    pool view must tile the dense cache exactly."""
    bs = min(bs, smax)
    while smax % bs:
        bs -= 1
    return bs


def _kernel_cached_attention(q, k_cache, v_cache, cache_len, k_scale=None, v_scale=None,
                             plan_kv_heads=None):
    """Dense-cache decode/verify through the block-paged kernel's wrapper
    with an identity block table; an int8 cache's scales [B,Smax,KV] take
    the same pool view. ``cache_len`` is the committed length — query
    t attends positions < cache_len + t + 1. Unlike the reference, which
    falls back to its jnp numerics when ``max_seq`` has no divisor ≥ 8,
    the kernel runs at whatever block size divides, down to 1: a
    fallback here would hide the kernel. ``plan_kv_heads``: a head split's
    unsharded kv heads (the kernel's plan)."""
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    bs = _dense_block_size(Smax)
    tables = torch.arange(
        B * (Smax // bs), dtype=torch.int32, device=q.device
    ).view(B, Smax // bs)
    scales = [None if s is None else _dense_as_pool(s, bs) for s in (k_scale, v_scale)]
    return _paged.paged_decode_call(
        q, _dense_as_pool(k_cache, bs), _dense_as_pool(v_cache, bs), tables,
        cache_len.to(torch.int32), *scales, plan_kv_heads,
    )


# ---------------------------------------------------------------------------
# decode


def decode_attention(q, k_cache, v_cache, cache_len):
    """Reference cached attention: q [B,T,H,hd]; caches [B,Smax,KV,hd];
    query t attends positions < cache_len + t (for T = 1, ``cache_len``
    is the valid length, as in the JAX package's ``decode_attention``;
    T > 1 is its ``verify_attention``)."""
    B, T, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, KV, g, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k_cache).float() * scale
    lim = cache_len.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    valid = torch.arange(Smax, device=q.device)[None, None, :] < lim[:, :, None]
    valid = valid[:, None, None]  # [B, 1, 1, T, Smax]
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bkgts,bskd->btkgd", (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype), v_cache
    )
    return out.reshape(B, T, H, hd)


def verify_attention(q, k_cache, v_cache, cache_len, *, backend=None):
    """Multi-token attention over a dense decode cache: q [B,T,H,hd] are T
    tokens at positions ``cache_len + arange(T)`` whose KV rows are
    already written; query t attends positions < cache_len + t + 1 (a
    speculative verify at T = K+1, a prefill chunk at T = its width). The
    kernel backend runs the paged kernel over the identity-table view,
    whose plan does not depend on T, so each query equals the sequential
    decode's bitwise; the reference is ``decode_attention``'s masked
    softmax with the extra query axis."""
    return _cached_attention(q, k_cache, v_cache, cache_len, backend=backend)


def _cached_attention(
    q, k_cache, v_cache, cache_len, *, k_scale=None, v_scale=None, backend=None,
    plan_kv_heads=None,
):
    """Dense decode-cache attention (``cache_len`` committed): the
    ``"kernel"`` backend views the cache as an identity-table block pool
    and runs the paged kernel (int8 caches dequantize in it); the
    reference keeps the jnp numerics, dequantizing an int8 cache to q's
    dtype first."""
    if kernel_ops.resolve_attention_backend(backend, q.device) == "kernel":
        kernel_ops.require_cuda(q, "_cached_attention")
        return _kernel_cached_attention(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                        plan_kv_heads)
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    return decode_attention(q, k_cache, v_cache, cache_len + 1)


def paged_attention(
    q, k_pool, v_pool, block_tables, cache_len, *, k_scale=None, v_scale=None, backend=None,
    plan_kv_heads=None,
):
    """Paged decode/verify attention for one layer: q [B,T,H,hd]; pools
    [NB,BS,KV,hd], int8 with ``k_scale``/``v_scale`` [NB,BS,KV] bfloat16;
    ``cache_len`` [B] committed lengths (the new token rows are already
    written). The kernel walks the tables (an int8 pool dequantizes in
    it); the reference gathers each row's dense view first, dequantized to
    q's dtype. ``plan_kv_heads``: a head split's unsharded kv heads (the
    kernel's plan)."""
    if kernel_ops.resolve_attention_backend(backend, q.device) == "kernel":
        kernel_ops.require_cuda(q, "paged_attention")
        return _paged.paged_decode_call(
            q, k_pool, v_pool, block_tables, cache_len.to(torch.int32), k_scale, v_scale,
            plan_kv_heads,
        )
    kd = gather_block_rows(k_pool[None], block_tables)[0]  # [B, MB·BS, KV, hd]
    vd = gather_block_rows(v_pool[None], block_tables)[0]
    if k_scale is not None:
        kd = dequantize_kv(kd, gather_block_rows(k_scale[None], block_tables)[0], q.dtype)
        vd = dequantize_kv(vd, gather_block_rows(v_scale[None], block_tables)[0], q.dtype)
    return decode_attention(q, kd, vd, cache_len + 1)


def paged_flash_partials(
    q, k_pool, v_pool, block_tables, cache_len, owned, *, k_scale=None, v_scale=None,
    backend=None, plan_kv_heads=None,
):
    """Per-rank flash partials for kv-sequence-split serving: the inputs of
    ``paged_attention`` on this rank's pool shard (tables localised, unowned
    entries pointing at a scratch block) plus ``owned`` [B,MB] marking the
    entries this rank holds → float32 ``m``, ``l`` [B,T,H] and ``acc``
    [B,T,H,hd] over owned positions only, unnormalised; a query with none
    reports (-1e30, 0, 0), which the cross-rank combine scales to 0. The
    kernel backend runs the paged kernel's partials mode, the reference the
    dense-gather partials oracle."""
    if kernel_ops.resolve_attention_backend(backend, q.device) == "kernel":
        return kernel_ops.paged_attention_partials(
            q, k_pool, v_pool, block_tables, cache_len, owned, k_scale, v_scale, mode="kernel",
            plan_kv_heads=plan_kv_heads,
        )
    return paged_partials_ref(
        q, k_pool, v_pool, block_tables, cache_len, owned, k_scale, v_scale
    )


# ---------------------------------------------------------------------------
# int8 KV-cache quantization


def quantize_kv(x):
    """x [..., hd] → (int8 values, bfloat16 per-vector scale [...]): the
    scale is max |x| over hd (at least 1e-6) and values round half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6)
    q = torch.round(xf / scale * 127.0).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def dequantize_kv(q, scale, dtype):
    return (q.float() * (scale.float() / 127.0)[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# full block


def _slot_writes(k_all, v_all, ks_all, vs_all, k, v):
    """The (stack, new rows) pairs of a slot-cache write: k and v, or for an
    int8 cache (``ks_all`` given) their codes and bfloat16 scales."""
    if ks_all is None:
        return ((k_all, k), (v_all, v))
    (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
    return ((k_all, kq), (ks_all, ksc), (v_all, vq), (vs_all, vsc))


def _dead_rows_own_view(out, q, k, v, cache_len, codes):
    """A paged step's dead rows (length 0, every table entry the null
    block) attending only the T tokens they write, as each row's private
    dense view does on the JAX package's reference route (its
    ``decode_step_paged`` gathers one a row): over the pool their writes
    collide in the null block, and which lands is not determined.
    ``codes``: an int8 pool's (k, k_scale, v, v_scale) of the new rows,
    which the view reads dequantized as the pool holds them. At T = 1 the
    view's one key takes softmax weight exactly 1, so its answer is v
    itself (bitwise the plain attention's)."""
    if codes is not None:
        kq, ks, vq, vs = codes
        k, v = dequantize_kv(kq, ks, q.dtype), dequantize_kv(vq, vs, q.dtype)
    if q.shape[1] == 1:
        own = _repeat_kv(v, q.shape[2] // v.shape[2]).to(q.dtype)
    else:
        own = gqa_attention(q, k, v, backend="reference")
    return torch.where((cache_len == 0)[:, None, None, None], own, out)


def attention_block(
    params, x, *, cfg, positions=None, cache=None, cache_len=None,
    prefix_kv=None, backend=None, dead_rows_own_view=False, mesh=None, tp_axis=None,
    seq_axis=None, plan_kv_heads=None,
):
    """Pre-norm'd GQA attention. Returns (out, new_kv).

    Prefill: cache is None → causal self-attention; the (k, v) it made
    are returned for the caller's cache. Suffix prefill: ``prefix_kv`` =
    (k, v) [B,h,KV,hd] of a cached prompt prefix; x is the suffix and
    attends over prefix + suffix at ``q_offset = h``. Slot decode: cache
    = (k_all, v_all, k_scale, v_scale, li): layer-stacked [L,B,Smax,KV,hd]
    tensors, their bfloat16 scales [L,B,Smax,KV] for an int8 cache (None
    for a float one) and the layer index; each row's new token is written
    (quantized, for int8) at its own length.
    Paged decode: cache = {k, v, tables, li} with pool leaves
    [L,NB,BS,KV,hd] (and ``k_scale``/``v_scale`` [L,NB,BS,KV] for an int8
    pool); new tokens go to each row's tail block (quantized, for int8)
    and attention walks the tables; ``new_kv`` is the leaves written.
    ``dead_rows_own_view``: dead rows (length 0) answer from their own new
    tokens alone (``_dead_rows_own_view``), for a caller whose next layer
    reads their output. A flat layout (``wq`` [D, H·hd], ``wo`` [H·hd, D])
    runs as the reference's ``attn_flat_tp`` does.

    On a mesh (a rank's local view, ``cfg`` with its head counts):
    ``seq_axis`` localises the paged tables to this rank's pool shard and
    combines the partials of the blocks it holds across that axis;
    ``tp_axis`` gathers the head shards across that axis before the whole
    ``wo``. ``plan_kv_heads`` goes to the paged kernel's plan."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if params["wq"].dim() == 2:  # flat layout
        q = (x @ params["wq"]).reshape(B, S, H, hd)
        k = (x @ params["wk"]).reshape(B, S, KV, hd)
        v = (x @ params["wv"]).reshape(B, S, KV, hd)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None and prefix_kv is not None:
        pk, pv = prefix_kv
        k_full = torch.cat([pk.to(k.dtype), k], dim=1)
        v_full = torch.cat([pv.to(v.dtype), v], dim=1)
        out = gqa_attention(
            q, k_full, v_full, q_offset=pk.shape[1], chunk=cfg.attn_chunk,
            backend=backend,
        )
        new_kv = (k_full, v_full)
    elif cache is None:
        out = gqa_attention(q, k, v, chunk=cfg.attn_chunk, backend=backend)
        new_kv = (k, v)
    elif isinstance(cache, dict):
        tables, li = cache["tables"], cache["li"]
        bs = cache["k"].shape[2]
        owned = None
        if seq_axis is not None:
            # this rank's pool shard: owned entries become local slots, the
            # others its scratch slot, so writes land on the owner only
            from repro_torch.serve.kv_cache import local_table_view

            tables, owned = local_table_view(
                tables, cache["k"].shape[1], collectives.axis_index(mesh, seq_axis))
        bid, off = block_write_positions(tables, cache_len, k.shape[1], bs)
        quant = "k_scale" in cache
        codes = None
        if quant:
            codes = quantize_kv(k) + quantize_kv(v)
            writes = tuple(zip(("k", "k_scale", "v", "v_scale"), codes))
        else:
            writes = (("k", k), ("v", v))
        for name, val in writes:
            scatter_block_token(cache[name][li], val, bid, off)
        scales = dict(k_scale=cache["k_scale"][li] if quant else None,
                      v_scale=cache["v_scale"][li] if quant else None)
        if owned is None:
            out = paged_attention(
                q, cache["k"][li], cache["v"][li], tables, cache_len, **scales,
                backend=backend, plan_kv_heads=plan_kv_heads,
            )
        else:
            # each rank attends over the positions it holds; the combine
            # (with the empty-shard guard) completes every row's softmax
            m_p, l_p, acc_p = paged_flash_partials(
                q, cache["k"][li], cache["v"][li], tables, cache_len, owned, **scales,
                backend=backend, plan_kv_heads=plan_kv_heads,
            )
            out = collectives.distributed_softmax(m_p, l_p, acc_p, mesh, seq_axis).to(q.dtype)
        if dead_rows_own_view:
            out = _dead_rows_own_view(out, q, k, v, cache_len, codes)
        new_kv = tuple(cache[name] for name, _ in writes)
    else:
        k_all, v_all, ks_all, vs_all, li = cache
        T = k.shape[1]
        rows = torch.arange(B, device=x.device)[:, None]
        # dead slots keep decoding and their lengths keep growing; clamp the
        # write start of every leaf to Smax - T the way the reference's
        # dynamic_update_slice does (T = K+1 for a verify, the chunk's
        # width for a prefill chunk)
        start = cache_len.long().clamp(max=k_all.shape[2] - T)
        pos = start[:, None] + torch.arange(T, device=x.device)[None, :]
        for stack, val in _slot_writes(k_all, v_all, ks_all, vs_all, k, v):
            stack[li][rows, pos] = val.to(stack.dtype)
        ks = None if ks_all is None else ks_all[li]
        vs = None if vs_all is None else vs_all[li]
        out = _cached_attention(
            q, k_all[li], v_all[li], cache_len, k_scale=ks, v_scale=vs, backend=backend
        )
        new_kv = (k_all, v_all, ks_all, vs_all)

    if tp_axis is not None:
        # softmax is per head, so the shards are final: gather them in head
        # order and run the whole wo, whose contraction is then the
        # single-device one
        out = collectives.all_gather(out, mesh, tp_axis, dim=2)
    if params["wo"].dim() == 2:  # flat layout
        o2 = out.to(x.dtype).reshape(B, out.shape[1], out.shape[2] * hd)
        return o2 @ params["wo"], new_kv
    out = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
    return out, new_kv


# ---------------------------------------------------------------------------
# training split over a mesh axis


def seq_rows(S: int, P: int, r: int) -> tuple:
    """Rank r's rows [lo, hi) of S split over P ranks (equal when P | S)."""
    return S * r // P, S * (r + 1) // P


def rows_to_all(y, lo: int, S: int, mesh, axis, *, split_consumer: bool):
    """Each rank's rows [lo, hi) of y [B, S, ...] → the whole [B, S, ...] on
    every rank: a gather when the rows split evenly, else the rows placed
    in zeros and summed. ``split_consumer``: each rank reads only part of
    the result, so its gradient is summed back (else it is replicated)."""
    P = collectives.group_size(mesh, axis)
    if S % P == 0:
        return collectives.gather(y, mesh, axis, dim=1,
                                  backward="reduce_scatter" if split_consumer else "slice")
    pad = [0, 0] * (y.dim() - 2) + [lo, S - lo - y.shape[1]]
    full = F.pad(y, pad)
    return (collectives.psum if split_consumer else collectives.leave)(full, mesh, axis)


def attention_train_split(params, x, *, cfg, mesh, axis="model"):
    """The training attention (causal, the reference route) as a rank's
    share of a split over ``axis``: x [B, S, D] replicated over the axis in,
    [B, S, D] replicated out.

    - Head split (``n_heads`` divides the axis): the rank holds its q heads
      [r·H/P, (r+1)·H/P) of ``wq`` and ``wo``, and its kv heads when
      ``n_kv_heads`` divides too; otherwise ``wk``/``wv`` are whole, the
      rank projects the kv heads its q heads read, and their gradients are
      partial over the axis. The partial output projections are summed.
    - ``seq_sp`` (the heads do not divide): every weight is whole; the
      rank's queries are its rows of the sequence, attending over every
      key before them (``q_offset``); the rows are gathered back.
    - The flat layout (``wq`` [D, H·hd], ``wo`` [H·hd, D], ``attn_flat_tp``):
      a weight whose flat columns split into whole heads is used as the
      head split's; one split elsewhere (or read by ``seq_sp``) projects
      its columns, and they are gathered into whole heads, the gradient
      summed back.

    Everything inside is entered through ``enter``, so each rank's share of
    x's gradient is summed over the axis."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rep = H // KV
    P = collectives.group_size(mesh, axis)
    r = collectives.axis_index(mesh, axis)
    heads = H % P == 0
    x = collectives.enter(x, mesh, axis)
    cos, sin = rope_tables(torch.arange(S, device=x.device)[None, :], hd, cfg.rope_theta)
    lo, hi = (0, S) if heads else seq_rows(S, P, r)

    def project(w, n, rows):
        """(the heads this rank holds of x[:, rows] @ w as [B, S', n', hd],
        the first one's index)."""
        if w.dim() == 3:
            y = torch.einsum("bsd,dhk->bshk", x[:, rows], w)
            return y, (r * w.shape[1] if w.shape[1] < n else 0)
        cols = w.shape[1]
        if cols == n * hd:
            return (x[:, rows] @ w).reshape(B, -1, n, hd), 0
        if heads and cols % hd == 0:
            return (x[:, rows] @ w).reshape(B, -1, cols // hd, hd), r * (cols // hd)
        y = collectives.gather(x @ w, mesh, axis, dim=2, backward="reduce_scatter")
        return y.reshape(B, S, n, hd)[:, rows], 0

    q_rows = slice(lo, hi)
    q, q0 = project(params["wq"], H, q_rows)
    k, k0 = project(params["wk"], KV, slice(None))
    v, _ = project(params["wv"], KV, slice(None))
    if heads:
        h_l = H // P
        q = q[:, :, r * h_l - q0:(r + 1) * h_l - q0]
        # the kv head of each of this rank's q heads, among those it holds
        need = torch.arange(r * h_l, (r + 1) * h_l, device=x.device) // n_rep - k0
        if not (h_l % n_rep == 0 and k.shape[2] == h_l // n_rep
                and k0 == r * h_l // n_rep):
            k, v = k.index_select(2, need), v.index_select(2, need)
    q = apply_rope(q, cos[:, lo:hi], sin[:, lo:hi])
    k = apply_rope(k, cos, sin)
    out = gqa_attention(q, k, v, q_offset=lo, chunk=cfg.attn_chunk, backend="reference")
    out = out.to(x.dtype)
    wo = params["wo"]
    if heads:
        if wo.dim() == 2:
            y = out.reshape(B, S, -1) @ wo
        else:
            y = torch.einsum("bshk,hkd->bsd", out, wo)
        return collectives.leave(y, mesh, axis)
    if wo.dim() == 3:
        return rows_to_all(torch.einsum("bshk,hkd->bsd", out, wo), lo, S, mesh, axis,
                           split_consumer=False)
    o2 = out.reshape(B, hi - lo, H * hd)
    if wo.shape[0] == H * hd:
        return rows_to_all(o2 @ wo, lo, S, mesh, axis, split_consumer=False)
    # wo's rows split over the axis: every row of the output, this rank's
    # columns of it, and the partial products summed
    o_all = rows_to_all(o2, lo, S, mesh, axis, split_consumer=True)
    c = wo.shape[0]
    return collectives.leave(o_all[..., r * c:(r + 1) * c] @ wo, mesh, axis)


# ---------------------------------------------------------------------------
# serving split over a mesh axis (prefill and the slot decode)


def _heads_of(w, n, hd, mesh, axis, *, out: bool, local: bool):
    """A projection weight as [D, n', hd] (``out``: ``wo`` as [n', hd, D])
    holding the heads this rank reads: its contiguous block of the ``n``
    heads (``local``) or all of them. ``w`` is as the rank holds it: with
    its heads (all, or its block) or flat ([D, n'·hd], [n'·hd, D]); a flat
    shard that is no whole block of heads is gathered first."""
    P = collectives.group_size(mesh, axis)
    hdim = 0 if out else 1
    if w.dim() == 2:
        cols = w.shape[hdim]
        if cols != n * hd and (cols % hd or (cols // hd) * P != n):
            w = collectives.all_gather(w, mesh, axis, dim=hdim)
            cols = w.shape[hdim]
        w = w.reshape((cols // hd, hd, w.shape[1]) if out else (w.shape[0], cols // hd, hd))
    held = w.shape[hdim]
    if local and held == n and P > 1:
        w = w.narrow(hdim, collectives.axis_index(mesh, axis) * (n // P), n // P)
    elif not local and held < n:
        w = collectives.all_gather(w, mesh, axis, dim=hdim)
    return w


def _local_partials(q, k, v, cache_len, base, k_scale=None, v_scale=None):
    """Flash partials of q [B,T,H,hd] over a cache shard k, v [B,S_l,KV,hd]
    holding the positions [base, base + S_l) (int8 with its scales):
    query t attends the positions < cache_len + t + 1 among them → float32
    m, l [B,T,H] and acc [B,T,H,hd], unnormalised; a query with none gives
    (NEG, 0, 0). The reference route of the kv-sequence split's decode: its
    work is the shard's, not the whole cache's."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    B, T, H, hd = q.shape
    S_l, KV = k.shape[1], k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, KV, H // KV, hd), k).float()
    s = s * (1.0 / math.sqrt(hd))
    pos = base + torch.arange(S_l, device=q.device)
    lim = cache_len.long()[:, None] + torch.arange(T, device=q.device)[None, :] + 1
    valid = (pos[None, None, :] < lim[:, :, None])[:, None, None]  # [B, 1, 1, T, S_l]
    m, l, p = _masked_partials(s, valid)
    acc = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v).float()
    return (m.permute(0, 3, 1, 2).reshape(B, T, H), l.permute(0, 3, 1, 2).reshape(B, T, H),
            acc.reshape(B, T, H, hd))


def seq_shard_view(k, v, rank, P, k_scale=None, v_scale=None):
    """Rank ``rank``'s shard (of P) of a dense cache split along its
    positions, k, v [B, S_l, KV, hd] (and an int8 cache's scales), as the
    paged kernel's partials mode reads it → (k pool, v pool, tables [B,
    MB], owned [B, MB], k_scale pool, v_scale pool): the shard viewed as a
    pool of S_l / bs blocks a row, through tables as wide as the whole
    cache whose entries outside the shard are not owned (and point at a
    block of the row's own, never read)."""
    B, S_l = k.shape[0], k.shape[1]
    bs = _dense_block_size(S_l)
    mb = S_l // bs
    j = torch.arange(mb * P, device=k.device)
    entry = (j - rank * mb).clamp(0, mb - 1)
    tables = (torch.arange(B, device=k.device)[:, None] * mb + entry[None, :]).to(torch.int32)
    owned = (j // mb == rank)[None, :].expand(B, mb * P).contiguous()
    pools = [None if t is None else _dense_as_pool(t, bs) for t in (k, v, k_scale, v_scale)]
    return pools[0], pools[1], tables, owned, pools[2], pools[3]


def _seq_shard_partials(q, k, v, cache_len, rank, P, k_scale=None, v_scale=None, backend=None):
    """Partials of q over rank ``rank``'s shard (of P) of a dense cache
    split along its positions: the kernel route runs the paged kernel's
    partials mode over ``seq_shard_view``."""
    if kernel_ops.resolve_attention_backend(backend, q.device) != "kernel":
        return _local_partials(q, k, v, cache_len, rank * k.shape[1], k_scale, v_scale)
    kernel_ops.require_cuda(q, "attention_split")
    kp, vp, tables, owned, ks, vs = seq_shard_view(k, v, rank, P, k_scale, v_scale)
    return paged_flash_partials(q, kp, vp, tables, cache_len, owned, k_scale=ks, v_scale=vs,
                                backend="kernel")


def attention_split(params, x, *, cfg, mesh, heads: bool, kv_heads: bool, kv_seq: bool,
                    rows: bool, positions=None, cache=None, cache_len=None, backend=None,
                    axis="model"):
    """A rank's share of ``attention_block`` in a model split over ``axis``
    (``Model(cfg, mesh=mesh)``'s prefill and slot decode): x [B, S, D]
    replicated over the axis in, [B, S, D] replicated out → (out, new_kv).

    - ``heads``: ``wq`` / ``wo`` hold the rank's block of q heads; the rank
      attends with them and the partial output projections are summed.
      ``kv_heads``: ``wk`` / ``wv`` and the cache hold its kv heads too
      (the groups of its q heads); else they are whole and the rank reads
      the kv heads its q heads need.
    - ``rows`` (prefill, ``seq_sp``): every weight is whole; the rank's
      queries are its rows of the sequence, attending every key before
      them (``q_offset``); the rows are gathered back.
    - ``kv_seq`` (decode): the cache holds the rank's contiguous range of
      the positions, every kv head. Every rank computes every head's query
      (gathered from the heads' ranks under ``heads``), attends over its
      positions (``_seq_shard_partials``: the paged kernel's partials mode
      on the kernel route) and ``distributed_softmax`` combines the
      partials; only the rank that holds a row's new position writes it.
    - Neither: the whole attention on every rank.

    Prefill: cache None → ``new_kv`` the (k, v) [B, S, KV', hd] of the kv
    heads the rank computed, every position (the caller keeps its cache
    shard of them). Decode: ``cache`` = (k_all, v_all, k_scale, v_scale,
    li), the rank's shards of the stacked cache, written in place; the
    kernel route over a head split runs the paged kernel with the
    unsharded plan (``plan_kv_heads``), as ``Model.sharded_paged_step``."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P = collectives.group_size(mesh, axis)
    r = collectives.axis_index(mesh, axis) if P > 1 else 0
    h_l, n_rep = H // P, H // KV
    wq = _heads_of(params["wq"], H, hd, mesh, axis, out=False, local=heads)
    wk = _heads_of(params["wk"], KV, hd, mesh, axis, out=False, local=kv_heads)
    wv = _heads_of(params["wv"], KV, hd, mesh, axis, out=False, local=kv_heads)
    lo, hi = seq_rows(S, P, r) if rows else (0, S)
    q = torch.einsum("bsd,dhk->bshk", x[:, lo:hi], wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, lo:hi], sin[:, lo:hi])
    k = apply_rope(k, cos, sin)

    new_kv = None
    if cache is None:
        kq, vq = k, v
        if heads and not kv_heads:
            if h_l % n_rep == 0:  # whole groups: their kv heads
                g0 = r * h_l // n_rep
                kq, vq = k[:, :, g0:g0 + h_l // n_rep], v[:, :, g0:g0 + h_l // n_rep]
            else:  # the kv head of each q head
                need = torch.arange(r * h_l, (r + 1) * h_l, device=x.device) // n_rep
                kq, vq = k.index_select(2, need), v.index_select(2, need)
        out = gqa_attention(q, kq, vq, q_offset=lo, chunk=cfg.attn_chunk, backend=backend)
        new_kv = (k, v)
    else:
        k_all, v_all, ks_all, vs_all, li = cache
        S_l = k_all.shape[2]
        smax = S_l * P if kv_seq else S_l
        start = cache_len.long().clamp(max=smax - S)
        pos = start[:, None] + torch.arange(S, device=x.device)[None, :]
        rws = torch.arange(B, device=x.device)[:, None]
        loc = (pos - r * S_l).clamp(0, S_l - 1) if kv_seq else pos
        for stack, val in _slot_writes(k_all, v_all, ks_all, vs_all, k, v):
            tgt = stack[li]
            val = val.to(tgt.dtype)
            if kv_seq:  # the row's position lies on one rank: the others keep theirs
                mine = (pos // S_l == r).view(B, S, *(1,) * (val.dim() - 2))
                val = torch.where(mine, val, tgt[rws, loc])
            tgt[rws, loc] = val
        ks = None if ks_all is None else ks_all[li]
        vs = None if vs_all is None else vs_all[li]
        if kv_seq:
            qa = collectives.all_gather(q, mesh, axis, dim=2) if heads else q
            m_p, l_p, acc_p = _seq_shard_partials(qa, k_all[li], v_all[li], cache_len, r, P,
                                                  ks, vs, backend)
            out = collectives.distributed_softmax(m_p, l_p, acc_p, mesh, axis).to(q.dtype)
            if heads:
                out = out[:, :, r * h_l:(r + 1) * h_l]
        else:
            out = _cached_attention(q, k_all[li], v_all[li], cache_len, k_scale=ks, v_scale=vs,
                                    backend=backend, plan_kv_heads=KV if kv_heads else None)

    wo = _heads_of(params["wo"], H, hd, mesh, axis, out=True, local=heads)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), wo)
    if heads:
        return collectives.leave(y, mesh, axis), new_kv
    if rows:
        return rows_to_all(y, lo, S, mesh, axis, split_consumer=False), new_kv
    return y, new_kv
