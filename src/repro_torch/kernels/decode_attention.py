"""Single-query flash decode over a dense KV cache.

Replaces the JAX package's Pallas TPU kernel
``kernels/decode_attention.py::decode_attention``; the CUDA source is
``csrc/decode_attention.cu`` (its header says what bounds it on the H100
and what the design does about it). The cache is read in place, in its
``[B,Smax,KV,hd]`` layout.

``decode_attention`` keeps the JAX function's contract that ``Smax`` is a
multiple of ``min(bk, Smax)`` (the kernel's own 64-key tile does not depend
on ``bk``), then dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``plain_decode_attention``), CUDA tensors the
kernel — or it raises. A row with ``cache_len`` 0 gives zeros in both.
Its ``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref as plain_decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_TILE = 64  # keys per tile in csrc/decode_attention.cu


def decode_splits(B: int, KV: int, Smax: int) -> int:
    """Thread blocks that share one (row, kv head)'s key tiles: enough for
    ``_build.TARGET_BLOCKS`` blocks in all, at most one per tile."""
    tiles = -(-Smax // DECODE_TILE)
    want = min(tiles, max(1, -(-_build.TARGET_BLOCKS // max(1, B * KV))))
    per = -(-tiles // want)
    return -(-tiles // per)


def decode_attention(q, k_cache, v_cache, cache_len, *, bk: int = 512):
    """q [B,H,hd]; caches [B,Smax,KV,hd] in q's type (float32 or
    bfloat16); ``cache_len`` [B] int32 → [B,H,hd] in q's type. Head h
    attends the positions < ``cache_len`` of kv head h // (H // KV)."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: bad shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
            f"v{tuple(v_cache.shape)}"
        )
    B, H, hd = q.shape
    Bk, Smax, KV, hd_k = k_cache.shape
    if Bk != B or hd_k != hd or KV < 1 or H % KV or cache_len.shape != (B,):
        raise ValueError(
            f"decode_attention: bad shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
            f"cache_len{tuple(cache_len.shape)}"
        )
    blk = min(bk, Smax)
    if blk < 1 or Smax % blk:
        raise ValueError(
            f"decode_attention: Smax={Smax} is not a multiple of bk=min({bk}, {Smax}) "
            "(the JAX function's block contract)"
        )
    tensors = (("k_cache", k_cache), ("v_cache", v_cache), ("cache_len", cache_len))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
    if q.device.type == "cpu":
        return plain_decode_attention(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
        )
    if cache_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: cache_len must be int32, got {cache_len.dtype}")
    for name, t in (("q", q),) + tensors:
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    splits = decode_splits(B, KV, Smax)
    ws = [None, None, None]
    if splits > 1:
        ws = [torch.empty((splits, B, H), dtype=torch.float32, device=q.device),
              torch.empty((splits, B, H), dtype=torch.float32, device=q.device),
              torch.empty((splits, B, H, hd), dtype=torch.float32, device=q.device)]
    err = _build.library().decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), *(None if t is None else t.data_ptr() for t in ws),
        B, Smax, H, KV, hd, splits, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
