"""The plain reference of the MoE decoder: the dense reference with each
MLP a top-k routed expert MLP, in float32 with TF32 off.

Routing: router logits x @ router [D, E], softmax over the experts, the
top k, gates renormalised over the k. Every token gets all k of its
experts (no capacity and no drop, as the published model computes), each
expert a SwiGLU (``moe/we1``, ``moe/we3`` [L, E, D, F], ``moe/we2`` [L, E,
F, D]), the outputs summed with their gates. It imports nothing of the
program. ``quant="fp8"`` rounds the expert products' operands as the dense
reference's control does; the router stays float32.
"""
from __future__ import annotations

import torch

from reference import dense


def moe_mlp(x, lp, quant, top_k):
    p = lp["moe"]
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(p["router"].shape[-1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        w1, w3, w2 = (p[n][e].float() for n in ("we1", "we3", "we2"))
        y = dense.mm(torch.nn.functional.silu(dense.mm(xe, w1, quant)) * dense.mm(xe, w3, quant),
                     w2, quant)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward_logits(params, m: dict, seqs, *, quant=None):
    return dense.forward_logits(
        params, m, seqs, quant=quant,
        mlp=lambda x, lp, q: moe_mlp(x, lp, q, int(m["top_k"])))
