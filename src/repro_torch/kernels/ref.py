"""Plain PyTorch oracles for the kernels (the allclose targets).

Torch copies of the JAX package's ``kernels/ref.py`` ``matmul_ref``,
``attention_ref`` (with an explicit ``q_offset``), ``decode_attention_ref``,
``paged_attention_ref`` (int8 pools with their scales too) and ``ssd_ref``,
and ``paged_partials_ref``, the reference half of the JAX package's
``models/attention.py::paged_flash_partials``. Each computes in float32
and casts the result to the input dtype (the partials stay float32).

``decode_attention_ref`` stands for the Pallas kernel, not for the JAX
oracle, where they differ: a row with ``cache_len`` 0 gives zeros (the
kernel's ``acc / max(l, 1e-30)``), where the JAX oracle's softmax over no
key gives NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30  # the JAX package's mask value: a row that attends no key keeps it as m


def matmul_ref(x, w):
    """x [M,K] @ w [K,N] summed in float32, rounded once to x's type."""
    return (x.float() @ w.float()).to(x.dtype)


def _masked_partials(s, valid):
    """Scores ``s`` [..., S] under the mask ``valid`` (broadcast to ``s``)
    → (m, l, p): m the max of the valid scores (``NEG`` where none is),
    p = exp(s − m) where valid and 0 elsewhere, l = Σ p. The caller
    contracts p with the values into acc."""
    s = s.masked_fill(~valid, NEG)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), p


def attention_ref(q, k, v, causal: bool = True, q_offset: Optional[int] = None):
    """Naive full-softmax GQA attention. q [B,Sq,H,hd], k/v [B,Skv,KV,hd].
    Query i sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``: the queries are the last Sq keys) and attends keys
    j ≤ that position when ``causal``."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        off = Skv - Sq if q_offset is None else int(q_offset)
        q_pos = torch.arange(Sq, device=q.device) + off
        mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len):
    """Single-query decode over a dense cache: q [B,H,hd]; caches
    [B,Smax,KV,hd]; head h attends positions < ``cache_len`` of kv head
    h // g. A row with ``cache_len`` 0 gives zeros."""
    B, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.float().reshape(B, KV, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(Smax, device=q.device)[None, :] < cache_len.long()[:, None]
    _, l, p = _masked_partials(s, valid[:, None, None, :])
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _gather_pool(k_pool, v_pool, block_tables, k_scale, v_scale):
    """Each row's blocks gathered densely, [B, MB·BS, KV, hd] float32, an
    int8 pool dequantized as ``int8 · (scale / 127)``."""
    B, MB = block_tables.shape
    BS, KV, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    tables = block_tables.long()
    kd = k_pool[tables].reshape(B, MB * BS, KV, hd).float()
    vd = v_pool[tables].reshape(B, MB * BS, KV, hd).float()
    if k_scale is not None:
        ks = k_scale[tables].reshape(B, MB * BS, KV).float()
        vs = v_scale[tables].reshape(B, MB * BS, KV).float()
        kd = kd * (ks / 127.0)[..., None]
        vd = vd * (vs / 127.0)[..., None]
    return kd, vd


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, k_scale=None, v_scale=None):
    """Dense-gather oracle for the block-paged decode/verify kernel.

    q [B,T,H,hd]; pools [NB,BS,KV,hd]; tables [B,MB] block ids; lengths
    [B] committed lengths (query t attends positions < lengths + t + 1).
    int8 pools pass per-vector scales [NB,BS,KV] and dequantize as
    ``int8 · (scale / 127)`` in float32."""
    B, T, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    g = H // KV
    kd, vd = _gather_pool(k_pool, v_pool, block_tables, k_scale, v_scale)
    kd = kd.repeat_interleave(g, dim=2)
    vd = vd.repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bths", q.float(), kd) / math.sqrt(hd)
    pos = torch.arange(MB * BS, device=q.device)[None, None, :]
    lim = lengths.long()[:, None] + torch.arange(T, device=q.device)[None, :] + 1
    valid = pos < lim[:, :, None]  # [B, T, S]
    s = s.masked_fill(~valid[:, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bths,bshd->bthd", p, vd).to(q.dtype)


def paged_partials_ref(q, k_pool, v_pool, block_tables, lengths, owned, k_scale=None,
                       v_scale=None):
    """The paged kernel's partials mode for the kv-sequence split: inputs
    as ``paged_attention_ref`` plus ``owned`` [B,MB] (nonzero: this rank
    holds the table entry's block). Query t attends the positions < lengths
    + t + 1 of owned blocks. Returns float32 ``m``, ``l`` [B,T,H] and
    ``acc`` [B,T,H,hd], unnormalised; a query with no such position gives
    exactly (``NEG``, 0, 0)."""
    B, T, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    g = H // KV
    kd, vd = _gather_pool(k_pool, v_pool, block_tables, k_scale, v_scale)
    qg = q.float().reshape(B, T, KV, g, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, kd) / math.sqrt(hd)
    pos = torch.arange(MB * BS, device=q.device)
    lim = lengths.long()[:, None] + torch.arange(T, device=q.device)[None, :] + 1
    own = (owned != 0).repeat_interleave(BS, dim=1)  # [B, MB·BS]
    valid = (pos[None, None, :] < lim[:, :, None]) & own[:, None, :]  # [B, T, S]
    m, l, p = _masked_partials(s, valid[:, None, None])
    acc = torch.einsum("bkgts,bskd->btkgd", p, vd)
    return (m.permute(0, 3, 1, 2).reshape(B, T, H), l.permute(0, 3, 1, 2).reshape(B, T, H),
            acc.reshape(B, T, H, hd))


def ssd_ref(xh, a, b, c, dt):
    """Sequential (unchunked) SSD recurrence, the ground truth.

    xh [B,S,H,hd]; a [B,S,H] (decay = exp(dt·A)); b,c [B,S,N]; dt [B,S,H].
    h_t = a_t·h_{t-1} + dt_t·(b_t ⊗ x_t);  y_t = c_t·h_t
    """
    B, S, H, hd = xh.shape
    N = b.shape[-1]
    state = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xh.device)
    xf, bf, cf = xh.float(), b.float(), c.float()
    ys = []
    for t in range(S):
        state = state * a[:, t, :, None, None] + torch.einsum(
            "bhd,bn,bh->bhdn", xf[:, t], bf[:, t], dt[:, t]
        )
        ys.append(torch.einsum("bn,bhdn->bhd", cf[:, t], state))
    return torch.stack(ys, dim=1).to(xh.dtype)  # [B,S,H,hd]
