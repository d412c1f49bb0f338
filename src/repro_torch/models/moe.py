"""Top-k routed expert MLP, with expert parallelism over the 'model' axis.

Port of the JAX package's ``models/moe.py``. Without a mesh every call is
the reference's local ``_moe_reference``: route, capacity-based dispatch,
expert FFN, weighted combine, in the reference's order and dtypes.

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

On a mesh (``moe_block(x, params, cfg, rules, path)``) the reference's
``shard_map`` bodies run as each rank's own code over
``parallel/collectives.py``; the arguments and the result are the global
arrays, as ``shard_map`` takes and gives them, and each rank takes its
shards of them:

- ``"dispatch"`` (train and prefill, ``_moe_dispatch_sharded``): the
  tokens split over the batch axes and 'model', each rank routes its own,
  an all-to-all over 'model' carries each expert's slots to the rank that
  holds it (E/ep experts a rank), the expert FFN, the all-to-all back, the
  combine; the token shards are gathered back;
- ``"dense"`` (decode, ``_moe_dense_sharded``): the few tokens are gathered
  to the experts' shards, each rank computes its experts' masked share of
  every token (over its F shard, FSDP), and a sum over 'model' (and 'data')
  completes it: tokens move to the weights, the weights never move;
- ``LEGACY_DENSE`` swaps in ``_moe_dense_legacy``, the baseline that needs
  each expert's whole F on its rank.

``moe_train_split`` is the dispatch path inside a training step split over
a mesh, with gradients: the arguments and the result are the rank's own
(its batch shard's tokens, its E/ep experts), and every collective carries
its transpose (``parallel/collectives.py``). ``moe_serve_split`` is the
serving layer of a model split over a mesh on the same shards: dispatch
for prefill, the dense path for decode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_shape

# leaves kept float32 whatever the model dtype
FLOAT32_PARAMS = ("router",)


# the logical axes of ``init_moe``'s leaves (the JAX package's ``init_moe``
# returns them beside the parameters)
MOE_AXES = {
    "router": ("embed", None),
    "we1": ("experts", None, "expert_mlp"),
    "we3": ("experts", None, "expert_mlp"),
    "we2": ("experts", "expert_mlp", None),
}


def init_moe(cfg, dtype, gen: torch.Generator, lead: tuple = (),
             device=None) -> dict:
    """Seeded random MoE parameters at the JAX package's scales, each with
    the leading dims ``lead`` (``(L,)`` for a layer stack): ``router``
    [D, E] float32, ``we1``/``we3`` [E, D, F] and ``we2`` [E, F, D] in
    ``dtype``. Each leaf is scaled in place: one float32 copy of a leaf at a
    time. ``gen`` None draws nothing: meta tensors on ``device``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device if gen is not None else device

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


# ---------------------------------------------------------------------------
# the expert-parallel paths (one rank's share; global arrays in and out)


def _axes_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in col.present_axes(mesh, axes))


def _local_experts(mesh, cfg):
    """(ep, this rank's expert ids as a slice)."""
    ep = mesh_shape(mesh)["model"]
    assert cfg.n_experts % ep == 0, (cfg.n_experts, ep)
    el = cfg.n_experts // ep
    m = col.axis_index(mesh, "model")
    return ep, slice(m * el, (m + 1) * el)


def _masked_ffn(x_all, router, we1, we3, we2, cfg, experts: slice):
    """Every token's gate-weighted output of the experts ``experts`` (the
    rank's), each expert run on every token: [T, D]. ``we*`` are the
    rank's slices; with F split, a partial sum over the F shards."""
    gates, idx, probs = _route(x_all, router, cfg.top_k)
    my = torch.arange(experts.start, experts.stop, device=x_all.device)
    g_local = ((idx[:, :, None] == my[None, None, :]) * gates[:, :, None]).sum(1)  # [T, el]
    xe = x_all.unsqueeze(0).expand(we1.shape[0], -1, -1)  # [el, T, D]
    h = F.silu(torch.bmm(xe, we1)) * torch.bmm(xe, we3)
    y = torch.bmm(h, we2)  # [el, T, D]
    return torch.einsum("etd,te->td", y, g_local.to(y.dtype)), probs, idx


def _mean_aux(probs, idx, mesh, axes):
    """The aux loss of this rank's tokens, averaged over ``axes`` (pmean)."""
    aux = switch_aux(probs, idx)
    return col.all_reduce_axes(aux, mesh, axes) / _axes_size(mesh, axes)


def _moe_dispatch_sharded(x2d, params, cfg, rules):
    """The expert-parallel all-to-all path: x [T, D] → (y [T, D], aux):
    each batch shard's tokens through ``_dispatch_split`` on the rank's
    experts, the aux loss the token shards' mean, the shards gathered
    back."""
    mesh = rules.mesh
    _, mine = _local_experts(mesh, cfg)
    batch_axes = rules.table["batch"]
    local = {"router": params["router"], **{k: params[k][mine] for k in ("we1", "we3", "we2")}}
    y, aux = _dispatch_split(_batch_rows(x2d, mesh, batch_axes)[None], local, cfg, mesh, "model",
                             want_aux=True)
    aux = col.all_reduce_axes(aux, mesh, batch_axes) / _axes_size(mesh, batch_axes)
    return col.all_gather_axes(y[0], mesh, batch_axes, dim=0), aux


def _dense_experts(x_rows, router, we1, we3, we2, cfg, mesh, batch_axes, f_axes):
    """The decode path's expert products on this rank: x_rows [T_l, D] its
    rows of the batch (split over ``batch_axes``), ``we*`` its experts'
    slices (their F split over ``f_axes``) → (every token's output [T, D],
    probs, idx): the few tokens gathered to the experts' shards, each
    rank's (experts × F shard) share of every token, summed over "model"
    and ``f_axes``; the weights never move."""
    _, mine = _local_experts(mesh, cfg)
    x_all = col.all_gather_axes(x_rows, mesh, batch_axes, dim=0)
    out, probs, idx = _masked_ffn(x_all, router, we1, we3, we2, cfg, mine)
    return col.all_reduce_axes(out, mesh, ("model",) + tuple(f_axes)), probs, idx


def _legacy_experts(x_rows, router, we1, we3, we2, cfg, mesh):
    """The baseline's: this rank's rows over its experts' whole F, summed
    over "model" → (out [T_l, D], probs, idx)."""
    _, mine = _local_experts(mesh, cfg)
    out, probs, idx = _masked_ffn(x_rows, router, we1, we3, we2, cfg, mine)
    return col.all_reduce(out, mesh, "model"), probs, idx


def _batch_rows(x2d, mesh, batch_axes):
    """This rank's rows of the global tokens x2d [T, D] over ``batch_axes``."""
    T_l = x2d.shape[0] // _axes_size(mesh, batch_axes)
    i = col.shard_index(mesh, batch_axes)
    return x2d[i * T_l:(i + 1) * T_l]


# the baseline switch: the pre-optimisation dense path needs each expert's
# whole F on its rank (FSDP shards all-gathered every step in the reference)
LEGACY_DENSE = False


def _moe_dense_legacy(x2d, params, cfg, rules):
    """The baseline decode path: x [T, D] → (y [T, D], aux); each rank
    routes its batch shard and runs its experts over their whole F."""
    mesh = rules.mesh
    _, mine = _local_experts(mesh, cfg)
    batch_axes = rules.table["batch"]
    out, probs, idx = _legacy_experts(_batch_rows(x2d, mesh, batch_axes), params["router"],
                                      params["we1"][mine], params["we3"][mine],
                                      params["we2"][mine], cfg, mesh)
    aux = _mean_aux(probs, idx, mesh, batch_axes)
    return col.all_gather_axes(out, mesh, batch_axes, dim=0), aux


def _moe_dense_sharded(x2d, params, cfg, rules):
    """The decode path: x [T, D] → (y [T, D], aux) (``_dense_experts``);
    every rank holds every token's output after the sum: the reference
    slices its own token shard back out and shard_map gathers them, which
    gives this."""
    mesh = rules.mesh
    _, mine = _local_experts(mesh, cfg)
    batch_axes = rules.table["batch"]
    fsdp = rules.cfg.param_sharding == "fsdp" and "data" in mesh_shape(mesh)
    f = slice(None)
    if fsdp:
        nd, di = mesh_shape(mesh)["data"], col.axis_index(mesh, "data")
        f_l = params["we1"].shape[-1] // nd
        f = slice(di * f_l, (di + 1) * f_l)
    out, probs, idx = _dense_experts(
        _batch_rows(x2d, mesh, batch_axes), params["router"], params["we1"][mine][:, :, f],
        params["we3"][mine][:, :, f], params["we2"][mine][:, f], cfg, mesh, batch_axes,
        ("data",) if fsdp else ())
    return out, _mean_aux(probs, idx, mesh, batch_axes)


def moe_block(x, params, cfg, rules=None, path: str = "dispatch"):
    """x [B, S, D] → (y [B, S, D] in x's dtype, aux loss), as the JAX
    package's ``moe_block``: the local reference without a mesh, else the
    expert-parallel ``path`` ("dispatch", or "dense" for decode)."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    if rules is None or rules.mesh is None:
        y, aux = _moe_reference(x2d, params, cfg)
    elif path == "dense":
        impl = _moe_dense_legacy if LEGACY_DENSE else _moe_dense_sharded
        y, aux = impl(x2d, params, cfg, rules)
    else:
        y, aux = _moe_dispatch_sharded(x2d, params, cfg, rules)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_train_split(x, params, cfg, mesh, axis="model"):
    """The expert-parallel dispatch path of a training step split over
    ``axis``, with gradients: x [B, S, D] (this rank's batch shard,
    replicated over ``axis``) → (y [B, S, D], aux). ``params`` holds the
    rank's E/ep experts (``we*`` [E/ep, D, F]) and the whole router.

    The B·S tokens split over ``axis``: rank m routes its T_l = B·S/ep of
    them (capacity ``moe_capacity(T_l)``; inside a step whose batch is
    split over "data", T_l is the JAX package's T / (data · model)), an
    all-to-all carries each expert's slots to its rank and back, and the
    tokens' outputs are gathered. The router is read by every rank for its
    own tokens, so its gradient is partial over ``axis``. The aux loss is
    the mean of the ranks' (``pmean``); the step averages it over "data"."""
    return _dispatch_split(x, params, cfg, mesh, axis, want_aux=True)


def _dispatch_split(x, params, cfg, mesh, axis, want_aux):
    B, S, D = x.shape
    ep = col.group_size(mesh, axis)
    E = cfg.n_experts
    if E % ep or (B * S) % ep:
        raise ValueError(f"moe dispatch split: {E} experts and {B * S} tokens over {ep} ranks")
    el, T_l = E // ep, B * S // ep
    m = col.axis_index(mesh, axis)
    x2d = col.enter(x.reshape(B * S, D), mesh, axis)
    x_loc = x2d[m * T_l:(m + 1) * T_l]
    gates, idx, probs = _route(x_loc, params["router"], cfg.top_k)
    C = moe_capacity(T_l, cfg)
    buf, lin, gf = _dispatch_local(x_loc, gates, idx, E, C)
    recv = col.all_to_all_grad(buf.reshape(ep, el, C, D), mesh, axis)  # [ep, el, C, D]
    xe = recv.transpose(0, 1).reshape(el, ep * C, D)  # the rank's experts, every source
    y = _expert_ffn(xe, params["we1"], params["we3"], params["we2"])
    back = col.all_to_all_grad(y.reshape(el, ep, C, D).transpose(0, 1).contiguous(), mesh, axis)
    out = _combine_local(back.reshape(E, C, D), lin, gf, T_l, cfg.top_k)
    aux = col.leave(switch_aux(probs, idx), mesh, axis) / ep if want_aux else None
    y = col.gather(out, mesh, axis, dim=0, backward="slice")
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_serve_split(x, params, cfg, mesh, path: str, batch_axes=(), f_axes=()):
    """The serving MoE layer as a rank's share of a model split over the
    mesh (``Model(cfg, mesh=mesh)``'s prefill and slot decode): x [B_l, S,
    D] this rank's rows of the batch (split over ``batch_axes``),
    replicated over "model" → y [B_l, S, D]; ``params`` the rank's stored
    shards: ``we*`` its E/ep experts, their F over ``f_axes`` where the
    FSDP layout keeps them split. The aux loss is dropped, as serving
    drops it.

    - ``"dispatch"`` (prefill): ``_moe_dispatch_sharded``'s all-to-all path
      over the rank's rows (its F gathered by the caller);
    - ``"dense"`` (decode): ``_moe_dense_sharded``: the tokens gathered over
      ``batch_axes``, each rank's (experts × F shard) share of every token
      summed over "model" and ``f_axes``, the rank's rows kept; with
      ``LEGACY_DENSE``, ``_moe_dense_legacy``'s: the rank's own rows over its
      experts' whole F (gathered here), summed over "model"."""
    if path != "dense":
        return _dispatch_split(x, params, cfg, mesh, "model", want_aux=False)[0]
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    we = [params["we1"], params["we3"], params["we2"]]
    if LEGACY_DENSE:
        we = [col.all_gather_axes(w, mesh, f_axes, dim=2 if i < 2 else 1)
              for i, w in enumerate(we)]
        out = _legacy_experts(x2d, params["router"], *we, cfg, mesh)[0]
    else:
        out = _dense_experts(x2d, params["router"], *we, cfg, mesh, batch_axes, f_axes)[0]
        out = _batch_rows(out, mesh, batch_axes)
    return out.reshape(B, S, D).to(x.dtype)
