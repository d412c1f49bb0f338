"""The yardstick's arithmetic: peaks of the card, the work of a kernel call
and the model FLOPs of a step, counted from shapes and lengths alone.

Frozen copies, so that a change to the program cannot change what measures
it: the peaks are NVIDIA's data sheet for the H100 SXM (dense rates, the
700 W part), the kernel counts follow the port's ``kernels/work.py`` (each
input read once, each output written once; 4 hd operations a query head and
attended key), and the model FLOPs follow the configuration's shapes, not
what the program happens to compute (padded expert slots, materialised
intermediates and pads do not count).
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, dense (no sparsity)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


class Work(NamedTuple):
    flops: float
    bytes: float

    def bound_s(self) -> float:
        """The least time the card could take: the larger of operations
        over the bf16 peak and bytes over the memory rate."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


def paged_decode(lengths, *, n_heads: int, n_kv_heads: int, head_dim: int, elem: int = 2,
                 table_entries: int = 0, T: int = 1) -> Work:
    """One paged-attention call over rows of committed ``lengths`` (live
    rows only: a dead row attends nothing the user asked for), T queries a
    row. Bytes: q and out, each attended key and value once, the tables
    and lengths. Operations: 4 hd per (query head, attended key); query t
    of a row attends length + t + 1 keys."""
    B = len(lengths)
    keys = sum(int(n) + T for n in lengths)
    q_bytes = B * T * n_heads * head_dim * elem
    nbytes = 2 * q_bytes + keys * n_kv_heads * head_dim * elem * 2 + 4 * (table_entries + B)
    pairs = sum(int(n) for n in lengths) * T + B * (T * (T + 1) // 2)
    return Work(float(4 * head_dim * n_heads * pairs), float(nbytes))


def flash_prefill(seq_len: int, *, n_heads: int, n_kv_heads: int, head_dim: int,
                  elem: int = 2) -> Work:
    """One causal flash call over a prompt of ``seq_len`` real tokens (pads
    do not count). Bytes: q and out, k and v once. Operations: 4 hd per
    (query head, attended key), query i attending i + 1 keys."""
    S = int(seq_len)
    nbytes = (2 * S * n_heads + 2 * S * n_kv_heads) * head_dim * elem
    pairs = S * (S + 1) // 2
    return Work(float(4 * head_dim * n_heads * pairs), float(nbytes))


def matmul_params_per_token(m: dict) -> int:
    """Weights a token multiplies through in one forward pass: the
    attention projections, the MLP (a MoE's top-k experts and its router
    only) and the LM head. The embedding lookup is no product."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    if m.get("n_experts"):
        mlp = m["top_k"] * 3 * d * m["d_ff"] + d * m["n_experts"]
    else:
        mlp = 3 * d * m["d_ff"]
    return m["num_layers"] * (attn + mlp) + d * m["vocab_size"]


def attention_flops(m: dict, context: int, queries: int = 1) -> float:
    """Score and value products of ``queries`` tokens that follow
    ``context`` earlier ones (each attends itself too): 4 hd a head and
    attended key, in every layer."""
    pairs = queries * context + queries * (queries + 1) // 2
    return float(4 * m["head_dim"] * m["n_heads"] * pairs * m["num_layers"])


def forward_flops(m: dict, new_tokens: int, context: int = 0) -> float:
    """Model FLOPs of a forward pass over ``new_tokens`` that follow
    ``context`` cached ones: 2 a weight a token, plus attention."""
    return 2.0 * matmul_params_per_token(m) * new_tokens + attention_flops(m, context, new_tokens)
