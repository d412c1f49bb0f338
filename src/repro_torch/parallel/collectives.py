"""Collectives over a serving mesh, and the schedules built from them.

Port of the JAX package's ``parallel/collectives.py``. There, each function
is a ``shard_map`` body and a rank is a device of one program; in the port
every rank is a process running the same code (``torchrun``'s model), so a
``shard_map`` body becomes the rank's own code:

- ``lax.axis_index(axis)`` is ``axis_index(mesh, axis)``
  (``DeviceMesh.get_local_rank``);
- ``psum`` / ``pmax`` are ``all_reduce`` over ``mesh.get_group(axis)``;
- ``all_gather``, ``all_to_all``, ``psum_scatter`` (``reduce_scatter``)
  and ``ppermute`` (``ring_shift``) map to their ``torch.distributed``
  namesakes.

Every collective of the port goes through this module, so the backend
question is answered here once. Gloo runs a collective on CPU tensors; for
a CUDA tensor over a gloo group, an op in ``GLOO_CUDA_NATIVE`` is handed to
gloo as it is, and every other op is staged through host memory explicitly
(copy out, collective, copy back), logged once an op. Nothing switches
backend silently. ``STATS`` counts the calls, the seconds spent inside them
and the bytes staged, and each op's calls, seconds and result bytes under
its JAX name (``STATS["ops"]``), for the caller to read (``reset_stats``);
each call also reports its op, under the JAX package's HLO name, and its
result's bytes on this rank to every callable in ``OBSERVERS`` (the op
counter of ``core/op_cost.py`` while it counts).

A training step split over a mesh differentiates through its collectives:
``enter`` / ``leave`` / ``psum`` / ``gather`` / ``all_to_all_grad`` carry
each one's transpose (the section below says which is which).

``distributed_softmax`` combines per-rank flash partials (the kv-sequence
split); ``ring_allgather_matmul``, ``matmul_reducescatter`` and
``sp_swiglu`` are the ring schedules that overlap one hop with one partial
matmul. ``mesh_broadcast_value`` / ``broadcast_object`` hand rank (0, …, 0)'s
value to every rank of a mesh, and ``check_replicated`` raises on every
rank when a replicated host value differs between ranks.
"""
from __future__ import annotations

import logging
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel.sharding import mesh_shape

log = logging.getLogger("repro_torch.parallel")

# collectives gloo runs on CUDA tensors itself (each probed on an H100,
# chip_smoke.py phase 13: torch 2.11's gloo took all_reduce, all_gather,
# all_to_all_single and broadcast on CUDA tensors); every other one a gloo
# group is asked to run on a CUDA tensor (the ring's send/recv) is staged
# through host memory here
GLOO_CUDA_NATIVE: frozenset = frozenset({"all_reduce", "all_gather", "all_to_all"})

# "ops": the JAX package's name of each op (psum, pmax, all_gather,
# psum_scatter, all_to_all, ppermute, broadcast) → its calls, seconds and
# result bytes on this rank
STATS = {"calls": 0, "seconds": 0.0, "staged_calls": 0, "staged_bytes": 0, "ops": {}}
_STAGED_LOGGED: set = set()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# callables told (op, result bytes on this rank) of each collective call;
# ops under the JAX package's HLO names: all-reduce, all-gather,
# reduce-scatter, all-to-all, and a ring shift as collective-permute
OBSERVERS: list = []


def _op_stats(name: str) -> dict:
    return STATS["ops"].setdefault(name, {"calls": 0, "seconds": 0.0, "bytes": 0})


def _report(op: str, result: torch.Tensor, name: str) -> None:
    n = result.numel() * result.element_size()
    _op_stats(name)["bytes"] += n
    for observe in OBSERVERS:
        observe(op, n)


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = {} if k == "ops" else 0.0 if k == "seconds" else 0


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def group_size(mesh, axis: str) -> int:
    """The ranks along ``axis`` (1 for an axis the mesh does not define)."""
    return mesh_shape(mesh).get(axis, 1)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through host memory: a
    CUDA tensor over gloo, for an op gloo does not run on CUDA itself."""
    if t.device.type != "cuda" or dist.get_backend(group) != "gloo" or op in GLOO_CUDA_NATIVE:
        return False
    if op not in _STAGED_LOGGED:
        _STAGED_LOGGED.add(op)
        log.info("gloo %s on CUDA tensors: staged through host memory", op)
    STATS["staged_calls"] += 1
    STATS["staged_bytes"] += t.numel() * t.element_size()
    return True


class _Timed:
    """Counts a call of the op ``name`` and the seconds spent inside it."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        STATS["calls"] += 1
        _op_stats(self.name)["calls"] += 1

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        STATS["seconds"] += dt
        _op_stats(self.name)["seconds"] += dt


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``psum`` (``op="sum"``) or ``pmax`` (``"max"``) of ``t`` over
    ``axis``; ``t`` itself is left as it was."""
    group = _group(mesh, axis)
    with _Timed("psum" if op == "sum" else "pmax"):
        staged = _staged("all_reduce", t, group)
        x = (t.detach().cpu() if staged else t.detach()).clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=_OPS[op], group=group)
        _report("all-reduce", x, "psum" if op == "sum" else "pmax")
        return x.to(t.device) if staged else x


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in rank
    order (``all_gather(..., tiled=True)``)."""
    group = _group(mesh, axis)
    with _Timed("all_gather"):
        staged = _staged("all_gather", t, group)
        x = (t.detach().cpu() if staged else t.detach()).contiguous()
        outs = [torch.empty_like(x) for _ in range(group.size())]
        dist.all_gather(outs, x, group=group)
        out = torch.cat(outs, dim=dim)
        _report("all-gather", out, "all_gather")
        return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum of the ranks' ``t`` along ``axis``, of which this rank keeps
    its chunk along ``dim`` in rank order (``psum_scatter(...,
    scatter_dimension=dim, tiled=True)``): the transpose of ``all_gather``."""
    group = _group(mesh, axis)
    p = group.size()
    if t.shape[dim] % p:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} over {p} ranks")
    with _Timed("psum_scatter"):
        staged = _staged("reduce_scatter", t, group)
        x = (t.detach().cpu() if staged else t.detach()).movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // p,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        out = out.movedim(0, dim).contiguous()
        _report("reduce-scatter", out, "psum_scatter")
        return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` [P, ...] with chunk j sent to rank j of ``axis``; returns [P,
    ...] whose chunk j came from rank j (``all_to_all(split_axis=0,
    concat_axis=0)``)."""
    group = _group(mesh, axis)
    with _Timed("all_to_all"):
        staged = _staged("all_to_all", t, group)
        x = (t.detach().cpu() if staged else t.detach()).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        _report("all-to-all", out, "all_to_all")
        return out.to(t.device) if staged else out


class _Shift:
    """An in-flight ring hop; ``wait()`` returns what arrived."""

    def __init__(self, reqs, recv, device, staged):
        self.reqs, self.recv, self.device, self.staged = reqs, recv, device, staged

    def wait(self) -> torch.Tensor:
        with _Timed("ppermute"):
            for r in self.reqs:
                r.wait()
        return self.recv.to(self.device) if self.staged else self.recv


def ring_shift_start(t: torch.Tensor, mesh, axis: str) -> _Shift:
    """Start one ring hop (``ppermute`` with ``j → j+1``): this rank sends
    ``t`` to the next rank along ``axis`` and receives the previous rank's;
    the matmul the caller runs meanwhile overlaps it."""
    group = _group(mesh, axis)
    p, idx = group.size(), axis_index(mesh, axis)
    with _Timed("ppermute"):
        staged = _staged("ring_shift", t, group)
        x = (t.detach().cpu() if staged else t.detach()).contiguous()
        recv = torch.empty_like(x)
        nxt = dist.get_global_rank(group, (idx + 1) % p)
        prv = dist.get_global_rank(group, (idx - 1) % p)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt, group),
                                       dist.P2POp(dist.irecv, recv, prv, group)])
        _report("collective-permute", recv, "ppermute")
    return _Shift(reqs, recv, t.device, staged)


def ring_shift(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return ring_shift_start(t, mesh, axis).wait()


# ---------------------------------------------------------------------------
# several axes, and the whole mesh


def present_axes(mesh, axes) -> tuple:
    """``axes`` (a name or a tuple) less the ones the mesh does not define."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if a in shape)


def shard_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` (the shard of a dimension
    a spec maps to that tuple of axes)."""
    shape, i = mesh_shape(mesh), 0
    for a in present_axes(mesh, axes):
        i = i * shape[a] + axis_index(mesh, a)
    return i


def all_gather_axes(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``all_gather`` over several axes, in the row-major order of
    ``shard_index``."""
    for a in reversed(present_axes(mesh, axes)):
        t = all_gather(t, mesh, a, dim)
    return t


def all_reduce_axes(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    for a in present_axes(mesh, axes):
        t = all_reduce(t, mesh, a, op)
    return t


def reduce_scatter_axes(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``reduce_scatter`` over several axes: the transpose of
    ``all_gather_axes`` (this rank keeps chunk ``shard_index(axes)``)."""
    for a in present_axes(mesh, axes):
        t = reduce_scatter(t, mesh, a, dim)
    return t


def mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` got here (a broadcast along each
    axis in turn)."""
    mesh_broadcast_value(0.0, mesh)


def _host(group, values, dtype) -> torch.Tensor:
    dev = "cpu" if dist.get_backend(group) == "gloo" else "cuda"
    return torch.tensor(values, dtype=dtype, device=dev)


def mesh_broadcast_value(value: float, mesh) -> float:
    """Rank (0, …, 0)'s ``value`` on every rank of ``mesh``: a broadcast
    from local rank 0 along each axis in turn."""
    names = mesh.mesh_dim_names
    x = _host(_group(mesh, names[0]), [float(value)], torch.float64)
    with _Timed("broadcast"):
        for a in names:
            group = _group(mesh, a)
            dist.broadcast(x, dist.get_global_rank(group, 0), group=group)
    return float(x.item())


def broadcast_object(obj, mesh):
    """Rank (0, …, 0)'s picklable ``obj`` on every rank of ``mesh``."""
    box = [obj]
    with _Timed("broadcast"):
        for a in mesh.mesh_dim_names:
            group = _group(mesh, a)
            dist.broadcast_object_list(box, dist.get_global_rank(group, 0), group=group)
    return box[0]


def check_replicated(mesh, *arrays, what: str = "schedule") -> None:
    """Raise on every rank when the host arrays (block tables, lengths,
    tokens: data every rank must hold the same) differ between the ranks
    of ``mesh``: one all-reduce of (h, -h), h a CRC-32 of their bytes."""
    h = 0
    for a in arrays:
        h = zlib.crc32(np.ascontiguousarray(a).tobytes(), h)
    names = mesh.mesh_dim_names
    x = _host(_group(mesh, names[0]), [h, -h], torch.int64)
    with _Timed("pmax"):
        for a in names:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(mesh, a))
    hi, lo = int(x[0]), -int(x[1])
    if hi != lo:
        raise RuntimeError(
            f"ranks diverged: the {what} differs across the mesh (CRC-32 {lo:#x} .. {hi:#x}); "
            "every rank must run the same schedule on the same inputs"
        )


# ---------------------------------------------------------------------------
# collectives that carry gradients (a training step split over a mesh)
#
# ``torch.distributed`` collectives are outside autograd; these functions
# give each one the transpose it has under JAX's autodiff. Megatron's pair
# brackets every region a rank computes a share of: ``enter`` (identity
# forward, the gradients' sum backward: each rank's share of the input's
# gradient) and ``leave`` (the sum forward, identity backward: the result is
# replicated, and so is its gradient). ``psum`` sums both ways, for a sum
# whose consumers are split too (the gated norm's sum of squares). A gather
# says what its consumer is: replicated (``backward="slice"``: every rank
# holds the whole gradient, and keeps its chunk) or split
# (``"reduce_scatter"``: each rank holds its share of it, as the FSDP
# gather's consumer does). An axis of size 1 (or that the mesh does not
# define) makes each of them the identity.


def _live_axes(mesh, axes) -> tuple:
    return tuple(a for a in present_axes(mesh, axes) if group_size(mesh, a) > 1)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g, ctx.mesh, ctx.axes), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce_axes(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_axes(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, split_consumer):
        ctx.mesh, ctx.axes, ctx.dim, ctx.split = mesh, axes, dim, split_consumer
        ctx.n = t.shape[dim]
        return all_gather_axes(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            return reduce_scatter_axes(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None
        i = shard_index(ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # chunk j went to rank j, and its gradient comes back from there
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


def enter(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Enter a split region (Megatron's f): identity forward, the
    gradients summed over ``axes`` backward."""
    axes = _live_axes(mesh, axes)
    return _Enter.apply(t, mesh, axes) if axes else t


def leave(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Leave a split region (Megatron's g): the ranks' shares summed over
    ``axes`` forward, identity backward."""
    axes = _live_axes(mesh, axes)
    return _Leave.apply(t, mesh, axes) if axes else t


def psum(t: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The sum over ``axes`` forward and backward (JAX's ``psum``, whose
    transpose is itself)."""
    axes = _live_axes(mesh, axes)
    return _Psum.apply(t, mesh, axes) if axes else t


def gather(t: torch.Tensor, mesh, axes, dim: int = 0, *, backward: str) -> torch.Tensor:
    """``all_gather_axes`` with a gradient: ``backward="slice"`` when what
    reads the result is replicated over ``axes`` (each rank keeps its chunk
    of the gradient), ``"reduce_scatter"`` when it is split (each rank's
    share of the gradient summed, and its chunk kept)."""
    if backward not in ("slice", "reduce_scatter"):
        raise ValueError(f"gather: backward must be 'slice' or 'reduce_scatter', not {backward!r}")
    axes = _live_axes(mesh, axes)
    return _Gather.apply(t, mesh, axes, dim, backward == "reduce_scatter") if axes else t


def all_to_all_grad(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``all_to_all`` with a gradient (the same exchange backward)."""
    if not _live_axes(mesh, axis):
        return t
    return _AllToAll.apply(t, mesh, axis)


# ---------------------------------------------------------------------------
# the kv-sequence split's combine


def distributed_softmax(m_loc, l_loc, acc_loc, mesh, axis: str):
    """Combine per-rank flash-decode partials over ``axis``. Each rank
    holds, for the same queries and heads, the running form over its slice
    of the KV sequence: ``m_loc`` [...] the local max of the logits,
    ``l_loc`` [...] Σ exp(logit − m_loc), ``acc_loc`` [..., d]
    Σ exp(logit − m_loc) · v. With m = max_r m_r, l = Σ_r l_r·exp(m_r − m),
    acc = Σ_r acc_r·exp(m_r − m), the result is acc / l [..., d].

    Empty shards: a rank with no valid key reports m_loc ≤ -1e30 (the mask
    sentinel, or -inf) and l_loc = 0; its scale is forced to exactly 0, so
    it never poisons the sum with exp(-inf − -inf) = NaN, and when every
    rank is empty the result is exact zeros (0 over the clamped
    denominator). The l and acc sums travel as one all-reduce."""
    empty = m_loc <= -1e30
    m = all_reduce(m_loc, mesh, axis, "max")
    scale = torch.where(empty, torch.zeros_like(m_loc), torch.exp(m_loc - m))
    both = torch.cat([acc_loc * scale[..., None], (l_loc * scale)[..., None]], dim=-1)
    both = all_reduce(both, mesh, axis, "sum")
    acc, l = both[..., :-1], both[..., -1]
    return acc / torch.clamp(l, min=torch.finfo(acc.dtype).tiny)[..., None]


# ---------------------------------------------------------------------------
# ring-overlapped tensor-parallel matmuls (local views)


def ring_allgather_matmul(x_loc, w_loc, mesh, axis: str):
    """y = all_gather(x, axis) @ w_loc, one ring hop a chunk: x_loc [T_l,
    D] (sequence-sharded), w_loc [D, F_l] → [P·T_l, F_l]. Each step
    multiplies the chunk it holds while the next one is in flight; after i
    hops rank idx holds chunk (idx − i) mod P."""
    group = _group(mesh, axis)
    p, idx = group.size(), axis_index(mesh, axis)
    t_l = x_loc.shape[0]
    acc = torch.zeros((p * t_l, w_loc.shape[1]), dtype=x_loc.dtype, device=x_loc.device)
    x_cur = x_loc
    for i in range(p):
        hop = ring_shift_start(x_cur, mesh, axis) if i != p - 1 else None
        src = (idx - i) % p
        acc[src * t_l:(src + 1) * t_l] = (x_cur @ w_loc).to(acc.dtype)
        if hop is not None:
            x_cur = hop.wait()
    return acc


def matmul_reducescatter(h_loc, w_loc, mesh, axis: str):
    """y_loc = reduce_scatter(h @ w_loc) over ``axis``: h_loc [T, F_l] (the
    full sequence, hidden-sharded), w_loc [F_l, D] → [T/P, D]. Each step
    adds this rank's partial for the chunk that lands on its owner after
    the remaining hops, and passes the float32 accumulator on."""
    group = _group(mesh, axis)
    p, idx = group.size(), axis_index(mesh, axis)
    t_l = h_loc.shape[0] // p
    acc = torch.zeros((t_l, w_loc.shape[1]), dtype=torch.float32, device=h_loc.device)
    for i in range(p):
        src = (idx + p - 1 - i) % p
        acc = acc + (h_loc[src * t_l:(src + 1) * t_l] @ w_loc).float()
        if i != p - 1:
            acc = ring_shift(acc, mesh, axis)
    return acc.to(h_loc.dtype)


def sp_swiglu(x, w1, w3, w2, rules):
    """Sequence-parallel SwiGLU with ring-overlapped collectives: x [B, S,
    D] with S sharded over 'model' (B over the batch axes), w1/w3 [D, F]
    and w2 [F, D] with F sharded over 'model'. The arguments and the result
    are the global arrays, as the JAX package's ``shard_map`` takes and
    gives them: each rank slices its shards, runs the ring body and the
    result is gathered back, equal to ``swiglu(x, w1, w3, w2)``."""
    mesh = rules.mesh
    batch_axes = rules.table["batch"]
    p, r = group_size(mesh, "model"), axis_index(mesh, "model")
    nb = 1
    for a in present_axes(mesh, batch_axes):
        nb *= mesh_shape(mesh)[a]
    bi = shard_index(mesh, batch_axes)
    B, S, D = x.shape
    b_l, s_l, f_l = B // nb, S // p, w1.shape[1] // p
    x_loc = x[bi * b_l:(bi + 1) * b_l, r * s_l:(r + 1) * s_l]
    cols = slice(r * f_l, (r + 1) * f_l)
    x2 = x_loc.reshape(b_l * s_l, D)
    h1 = ring_allgather_matmul(x2, w1[:, cols], mesh, "model")  # [B_l·S, F_l]
    h3 = ring_allgather_matmul(x2, w3[:, cols], mesh, "model")
    h = F.silu(h1) * h3
    y = matmul_reducescatter(h, w2[cols], mesh, "model").reshape(b_l, s_l, D)
    y = all_gather(y, mesh, "model", dim=1)
    return all_gather_axes(y, mesh, batch_axes, dim=0)
