"""Plain PyTorch oracles for the kernels (the allclose targets).

Torch copies of the JAX package's ``kernels/ref.py`` ``attention_ref``
(with an explicit ``q_offset``), ``paged_attention_ref`` (int8 pools with
their scales too) and ``ssd_ref``.
Each computes in float32 and casts the result to the input dtype. The
other oracles (matmul, dense decode) arrive with their kernels
(ROADMAP §2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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
    tables = block_tables.long()
    kd = k_pool[tables].reshape(B, MB * BS, KV, hd).float()
    vd = v_pool[tables].reshape(B, MB * BS, KV, hd).float()
    if k_scale is not None:
        ks = k_scale[tables].reshape(B, MB * BS, KV).float()
        vs = v_scale[tables].reshape(B, MB * BS, KV).float()
        kd = kd * (ks / 127.0)[..., None]
        vd = vd * (vs / 127.0)[..., None]
    kd = kd.repeat_interleave(g, dim=2)
    vd = vd.repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bths", q.float(), kd) / math.sqrt(hd)
    pos = torch.arange(MB * BS, device=q.device)[None, None, :]
    lim = lengths.long()[:, None] + torch.arange(T, device=q.device)[None, :] + 1
    valid = pos < lim[:, :, None]  # [B, T, S]
    s = s.masked_fill(~valid[:, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bths,bshd->bthd", p, vd).to(q.dtype)


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
