"""The work of each kernel: the FLOPs it must do and the bytes it must move.

One function per kernel of the port, each returning ``Work(flops,
bytes)`` for one call on the given inputs: each input read once and each
output written once, and the operations the kernel's arithmetic needs
(4 hd a query head and attended key for attention: the q·k and p·v
products; 2 M N K for a matrix product). ``chip_smoke.py`` bounds each
kernel's time with them (the larger of bytes over the card's memory rate
and FLOPs over its peak), and the op counter (``core/op_cost.py``) charges
every ``repro_torch::*`` operator with them, so a step's count holds the
same work whichever route computes it.

Where the work depends on the data (the lengths a row attends, the blocks
a rank owns), the functions count what these inputs need: they read the
lengths from the tensors, on the host. On meta tensors, which hold no
data, every row counts at its table's reach less T (so that each row's
last query attends the full reach, as a full cache does) and a partials
call owns every block: the most the shapes allow, the capacity a step is
built for.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Work(NamedTuple):
    flops: float
    bytes: float


def _lengths(lengths, reach: int, T: int) -> torch.Tensor:
    """[B] int64 committed lengths on the host: a meta tensor's rows at
    ``reach - T``."""
    if lengths.device.type == "meta":
        return torch.full(tuple(lengths.shape), max(reach - T, 0), dtype=torch.long)
    return lengths.detach().cpu().long()


def paged(q, k_pool, block_tables, lengths) -> Work:
    """The paged kernel (decode or verify, float or int8 pools). Bytes: q
    and out, the attended keys and values (lengths + T a row, at most the
    table's reach; int8 pools: one byte an element plus a 2-byte bf16
    scale a vector), tables, lengths. Operations: 4 hd per (query head,
    attended key); query t of a row attends lengths + t + 1 keys."""
    B, T, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    reach = block_tables.shape[1] * BS
    vec = hd * k_pool.element_size() + (2 if k_pool.dtype == torch.int8 else 0)
    lens = _lengths(lengths, reach, T)
    keys = int(torch.clamp(lens + T, max=reach).sum())
    nbytes = 2 * q.numel() * q.element_size() + keys * KV * vec * 2 + 4 * (block_tables.numel() + B)
    pairs = int(lens.sum()) * T + B * (T * (T + 1) // 2)
    return Work(float(4 * hd * H * pairs), float(nbytes))


def partials(q, k_pool, block_tables, lengths, owned) -> Work:
    """The paged kernel's partials mode. Bytes: q, the float32 outputs (m,
    l, acc), the attended keys and values of owned blocks (int8: plus a
    2-byte scale a vector), tables, ownership, lengths. Operations: 4 hd
    per (query head, attended key of an owned block)."""
    B, T, H, hd = q.shape
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    reach = block_tables.shape[1] * BS
    vec = hd * k_pool.element_size() + (2 if k_pool.dtype == torch.int8 else 0)
    if owned.device.type == "meta":
        own = torch.ones(tuple(owned.shape), dtype=torch.bool)
    else:
        own = owned.detach().cpu().bool()
    own = own.repeat_interleave(BS, dim=1)  # [B, MB·BS]
    pos = torch.arange(own.shape[1])
    lens = _lengths(lengths, reach, T)
    keys = int(((pos[None] < (lens + T)[:, None]) & own).sum())
    lim = lens[:, None] + torch.arange(T)[None] + 1
    pairs = int(((pos[None, None] < lim[..., None]) & own[:, None]).sum())
    nbytes = (q.numel() * q.element_size() + B * T * H * (hd + 2) * 4 + keys * KV * vec * 2
              + 4 * (2 * block_tables.numel() + B))
    return Work(float(4 * hd * H * pairs), float(nbytes))


def flash(q, k, q_offset: int = 0, causal: bool = True) -> Work:
    """Flash attention. Bytes: q and out, k and v. Operations: 4 hd per
    (query head, attended key): causal query i attends min(Skv, q_offset +
    i + 1) keys, a non-causal one all Skv."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if causal:
        # Σ_i min(Skv, off + i + 1) over i < Sq: a ramp, then a flat run at Skv
        ramp = max(0, min(Sq, Skv - q_offset))
        pairs = ramp * (q_offset + 1) + ramp * (ramp - 1) // 2 + (Sq - ramp) * Skv
    else:
        pairs = Sq * Skv
    return Work(float(4 * hd * H * B * pairs), float(nbytes))


def matmul(x, w) -> Work:
    """``relic_matmul`` and ``relic_gemv``: x [M,K] @ w [K,N]. Bytes: x, w
    and out once; operations 2 M N K."""
    (M, K), N = x.shape, w.shape[1]
    return Work(float(2 * M * N * K), float((M * K + K * N + M * N) * x.element_size()))


def decode(q, k_cache, cache_len) -> Work:
    """The dense decode kernel. Bytes: q and out, the attended keys and
    values (``cache_len`` a row, at most Smax), cache_len. Operations: 4 hd
    per (query head, attended key)."""
    B, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    it = q.element_size()
    keys = int(_lengths(cache_len, Smax, 0).clamp(0, Smax).sum())
    nbytes = 2 * q.numel() * it + keys * KV * hd * it * 2 + 4 * B
    return Work(float(4 * hd * H * keys), float(nbytes))


def ssd(x, b, chunk: int = 128) -> Work:
    """The SSD scan. Bytes: x and y, a and dt, b and c, the final state,
    once each. Operations per (batch row, head, chunk of q positions), as
    the Pallas kernel does them: 2 q² N (c·b, per head) + 2 q² hd (att·x)
    + 4 q N hd (the state's read into y and its update)."""
    B, S, H, hd = x.shape
    N = b.shape[-1]
    it = x.element_size()
    nbytes = 2 * x.numel() * it + 2 * B * S * H * 4 + 2 * b.numel() * it + B * H * hd * N * 4
    qs = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    flops = B * H * sum(2 * q * q * N + 2 * q * q * hd + 4 * q * N * hd for q in qs)
    return Work(float(flops), float(nbytes))
