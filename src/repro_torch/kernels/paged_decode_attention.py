"""Block-paged flash decode/verify attention (kernel 1 of the port).

Replaces the JAX package's Pallas TPU kernel
``kernels/paged_decode_attention.py::paged_decode_attention`` for T ≥ 1
queries over float32 or bfloat16 pools; the CUDA source is
``csrc/paged_decode_attention.cu`` (its header says what bounds it on the
H100 and what the design does about it). The int8-dequant and partials
modes wait for ROADMAP §2 item 1.

``paged_decode_attention`` dispatches on the tensors' device: CPU tensors
take the plain PyTorch version (``plain_paged_decode_attention``, the
dense-gather oracle), CUDA tensors the kernel — or it raises. Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref as plain_paged_decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """q [B,T,H,hd]; pools [NB,BS,KV,hd]; ``block_tables`` [B,MB] int32
    block ids (< NB); ``lengths`` [B] int32 committed lengths (query t
    attends positions < lengths + t + 1) → [B,T,H,hd] in q's dtype."""
    if q.device.type == "cpu":
        return plain_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths)
    B, T, H, hd = q.shape
    NB, BS, KV, hd_k = k_pool.shape
    MB = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lengths must be int32")
    if (v_pool.shape != k_pool.shape or hd_k != hd or H % KV
            or block_tables.shape != (B, MB) or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)} "
            f"v{tuple(v_pool.shape)} tables{tuple(block_tables.shape)} "
            f"lengths{tuple(lengths.shape)}"
        )
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    err = _build.library().paged_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, H, KV, hd, BS, MB, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
