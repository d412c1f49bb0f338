"""Top-k routed expert MLP: the single-device path.

Port of the JAX package's ``models/moe.py`` without its mesh: the
expert-parallel paths (``_moe_dispatch_sharded``, ``_moe_dense_sharded``
and the legacy dense one) wait for sharded serving (ROADMAP §1 item 9),
and every call here is the reference's local ``_moe_reference``: route,
capacity-based dispatch, expert FFN, weighted combine, in the reference's
order and dtypes.

- Routing runs in float32 (the router weight is float32 in every model
  dtype; ``FLOAT32_PARAMS``): softmax over the experts, top-k, gates
  renormalised over the k choices. The Switch load-balance aux loss is
  ``moe_block``'s alone: serving calls ``moe_mlp``, which skips it.
- Dispatch ranks each (token, choice) in its expert by a cumsum in flat
  ``t*k + j`` order; ranks past the capacity ``moe_capacity(T)`` drop.
  Kept assignments go to unique rows of an ``[E*C + 1, D]`` buffer by
  ``index_copy``, dropped ones to its last row, which nothing reads: every
  kept row receives exactly one token, so the result does not depend on the
  order the writes land in (a CUDA graph replay is bitwise repeatable).
- The expert products are batched matmuls over the experts (the reference
  computes them in ``einsum`` outside any kernel).
- The capacity depends on shapes only, so a step holding a MoE layer makes
  no host synchronisation and captures as one CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# leaves kept float32 whatever the model dtype
FLOAT32_PARAMS = ("router",)


def init_moe(cfg, dtype, gen: torch.Generator, lead: tuple = ()) -> dict:
    """Seeded random MoE parameters at the JAX package's scales, each with
    the leading dims ``lead`` (``(L,)`` for a layer stack): ``router``
    [D, E] float32, ``we1``/``we3`` [E, D, F] and ``we2`` [E, F, D] in
    ``dtype``. Each leaf is scaled in place: one float32 copy of a leaf at a
    time."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device

    def normal(shape, scale, dt):
        x = torch.randn(lead + shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dt)

    return {
        "router": normal((d, e), d**-0.5, torch.float32),
        "we1": normal((e, d, f), d**-0.5, dtype),
        "we3": normal((e, d, f), d**-0.5, dtype),
        "we2": normal((e, f, d), f**-0.5, dtype),
    }


def _route(x, router_w, top_k):
    """x [T, D] → (gates [T, k] float32, idx [T, k] int64, probs [T, E]
    float32): float32 router logits, softmax, top-k, gates renormalised.
    The JAX package's ``_route`` returns the aux loss beside the gates;
    here ``switch_aux`` computes it from ``probs`` and ``idx``, only where
    it is read (a captured serving step cannot drop work it does not read)."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def switch_aux(probs, idx):
    """The Switch load-balance loss E · Σ_e f_e · p_e of one routing
    (``_route``'s probs [T, E] and idx [T, k])."""
    e = probs.shape[1]
    me = probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add(0, idx.reshape(-1), torch.ones(idx.numel(), device=probs.device)) / idx.numel()
    return e * torch.sum(me * ce)


def _expert_ffn(xe, we1, we3, we2):
    """xe [E, C, D] × per-expert weights [E, D, F] → [E, C, D]."""
    h = F.silu(torch.bmm(xe, we1)) * torch.bmm(xe, we3)
    return torch.bmm(h, we2)


def _dispatch_local(x, gates, idx, n_experts, capacity):
    """Capacity-based dispatch. Returns (buf [E, C, D], lin [T*k], gate
    [T*k]): ``lin[t*k + j]`` addresses ``buf.reshape(E*C, D)``, or is E*C
    for an assignment dropped past its expert's capacity."""
    T, D = x.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)  # [T*k]
    # [E, T*k]: the scan runs along the inner axis (an outer-axis cumsum over
    # E columns is a sequential scan a column on CUDA)
    onehot = (torch.arange(n_experts, device=x.device)[:, None] == flat_e[None, :]).long()
    pos_in_e = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(0)  # rank in its expert
    keep = pos_in_e < capacity
    ec = n_experts * capacity
    lin = torch.where(keep, flat_e * capacity + pos_in_e, torch.full_like(flat_e, ec))
    tok = torch.arange(T * k, device=x.device) // k
    # kept rows unique; every drop lands in row E*C (out of place: a decode
    # plan's per-request step runs under vmap)
    buf = torch.zeros((ec + 1, D), dtype=x.dtype, device=x.device).index_copy(0, lin, x[tok])
    return buf[:ec].reshape(n_experts, capacity, D), lin, gates.reshape(-1)


def _combine_local(y_buf, lin, gate_flat, T, k):
    """Inverse of dispatch: each token's k expert outputs, gate-weighted
    and summed (a dropped assignment contributes 0)."""
    D = y_buf.shape[-1]
    flat = y_buf.reshape(-1, D)
    res = flat[torch.clamp(lin, max=flat.shape[0] - 1)]
    res = res.masked_fill((lin >= flat.shape[0])[:, None], 0)
    return (gate_flat[:, None].to(res.dtype) * res).reshape(T, k, D).sum(1)


def moe_capacity(tokens_local: int, cfg) -> int:
    """Slots an expert takes a call: ⌈T·k/E·capacity_factor⌉ rounded up to
    a multiple of 4, at least 4. Shapes only."""
    c = math.ceil(tokens_local * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, int(math.ceil(c / 4) * 4))


def _moe_local(x2d, params, cfg):
    """x [T, D] → (y [T, D], probs, idx): the single-device path."""
    T = x2d.shape[0]
    gates, idx, probs = _route(x2d, params["router"], cfg.top_k)
    C = moe_capacity(T, cfg)
    buf, lin, gf = _dispatch_local(x2d, gates, idx, cfg.n_experts, C)
    y = _expert_ffn(buf, params["we1"], params["we3"], params["we2"])
    return _combine_local(y, lin, gf, T, cfg.top_k), probs, idx


def _moe_reference(x2d, params, cfg):
    """x [T, D] → (y [T, D], aux)."""
    y, probs, idx = _moe_local(x2d, params, cfg)
    return y, switch_aux(probs, idx)


def moe_mlp(x, params, cfg):
    """x [B, S, D] → y [B, S, D] in x's dtype, without the aux loss (the
    serving steps', which drop it as the reference's do). The B·S tokens
    route together: the capacity is that of one call of B·S tokens."""
    B, S, D = x.shape
    y, _, _ = _moe_local(x.reshape(B * S, D), params, cfg)
    return y.reshape(B, S, D).to(x.dtype)


def moe_block(x, params, cfg):
    """x [B, S, D] → (y [B, S, D] in x's dtype, aux loss), as the JAX
    package's ``moe_block``."""
    B, S, D = x.shape
    y, aux = _moe_reference(x.reshape(B * S, D), params, cfg)
    return y.reshape(B, S, D).to(x.dtype), aux
