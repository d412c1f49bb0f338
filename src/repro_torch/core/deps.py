"""Dependence analysis: static (aten graph) + dynamic (recorded access traces).

Port of the JAX package's ``core/deps.py``. The paper checks every
annotated region twice before parallelizing: BOLT-based *static*
dependence analysis over the binary, and *dynamic* memory-access conflict
detection over DynamoRIO load/store traces. Here:

static  — trace the region's per-item function on one sample item with
          ``make_fx(tracing_mode="real")`` and walk the aten graph with
          *provenance tracking*: a write (``index_put``, ``scatter*``,
          ``index_add*``, ``slice_scatter``, ``select_scatter``, or
          ``copy_``, or any other in-place op) into an alias of a
          placeholder or of a closed-over constant is the analogue of a
          shared-memory write (it demands a dynamic trace); a write into a locally made tensor is a private
          stack write (safe). Views, indexing and the results of writes
          into shared storage stay aliases. PyTorch runs Python loops as
          they are, so the graph holds them unrolled: ``loops`` and
          ``loop_carried`` read 0 where the JAX report counts its scans.
dynamic — replay the region's recorded gather/scatter index sets under
          the proposed task partition and reject on any cross-task
          write↔read/write overlap (``check_conflicts``, numpy, copied).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

# aten ops (name without overload or trailing "_") that write into their
# first operand, in place or as an updated copy
SCATTER_OPS = {
    "index_put", "scatter", "scatter_add", "scatter_reduce", "index_add", "index_copy",
    "index_fill", "masked_scatter", "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "copy",
}
GATHER_OPS = {"index", "gather", "index_select", "take", "take_along_dim"}
# ops whose result aliases operand 0's storage (a view, or the write's
# target); everything else makes a new tensor
_ALIAS_OP0 = {
    "view", "reshape", "_unsafe_view", "select", "slice", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "alias", "as_strided", "narrow", "diagonal", "unfold",
    "unbind", "split", "split_with_sizes", "chunk", "detach", "view_as", "expand_as",
    "movedim", "flatten", "unflatten",
} | GATHER_OPS | SCATTER_OPS
_ALIAS_ANY = {"where"}  # jnp.where's select_n: shared if any operand is


@dataclass
class StaticReport:
    n_eqns: int = 0
    gathers: int = 0
    scatters: int = 0
    shared_scatters: int = 0  # writes into argument-derived tensors
    loops: int = 0  # 0: the traced graph holds Python loops unrolled
    loop_carried: int = 0
    prims: dict = field(default_factory=dict)

    @property
    def trivially_parallel(self) -> bool:
        """No writes into shared (argument-derived) state → the region can
        be partitioned across items without a dynamic trace."""
        return self.shared_scatters == 0

    def summary(self) -> str:
        return (
            f"eqns={self.n_eqns} gathers={self.gathers} "
            f"scatters={self.scatters} shared_writes={self.shared_scatters} "
            f"loops={self.loops} carried={self.loop_carried} "
            f"parallel={'yes' if self.trivially_parallel else 'needs-trace'}"
        )


def _op_name(target) -> tuple[str, bool]:
    """(name, in place): ``aten.index_put_.default`` → ("index_put",
    True); a custom op keeps its qualified name
    (``repro_torch::paged_decode_attention``)."""
    packet = getattr(target, "_overloadpacket", None)
    name = (getattr(packet, "__name__", None) or getattr(target, "__name__", str(target)))
    name = name.split(".")[0]
    ns = getattr(target, "namespace", "aten")
    if ns not in ("aten", "prims"):
        return f"{ns}::{name}", False
    return name.rstrip("_"), name.endswith("_") and not name.startswith("_")


def _walk(graph, rep: StaticReport) -> None:
    """Placeholders and closed-over constants (``get_attr``) are shared
    storage; an op in ``_ALIAS_OP0`` passes operand 0's status on to its
    result, ``where`` passes any operand's."""
    shared = set()

    def is_shared(a) -> bool:
        return isinstance(a, torch.fx.Node) and a in shared

    for node in graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            shared.add(node)
            continue
        if node.op != "call_function":
            continue
        rep.n_eqns += 1
        name, inplace = _op_name(node.target)
        rep.prims[name] = rep.prims.get(name, 0) + 1
        args = list(node.args)
        if name in GATHER_OPS:
            rep.gathers += 1
        if name in SCATTER_OPS or inplace:  # an in-place op writes operand 0
            rep.scatters += 1
            if args and is_shared(args[0]):
                rep.shared_scatters += 1
        if name == "getitem":  # an element of a multi-output op
            if args and is_shared(args[0]):
                shared.add(node)
        elif (name in _ALIAS_OP0 or inplace) and args and is_shared(args[0]):
            shared.add(node)
        elif name in _ALIAS_ANY and any(is_shared(a) for a in args):
            shared.add(node)


def static_deps(fn, *sample_args) -> StaticReport:
    """The static report of ``fn`` on one sample item: its aten graph from
    ``make_fx`` with real tensors, walked with the provenance rule."""
    gm = make_fx(fn, tracing_mode="real")(*sample_args)
    rep = StaticReport()
    _walk(gm.graph, rep)
    return rep


# ---------------------------------------------------------------------------
# dynamic traces


@dataclass
class MemoryTrace:
    """Recorded dynamic accesses of one region execution (per work item).

    reads/writes: list over work items of integer index arrays — the
    DynamoRIO load/store trace analogue, in element-index space.
    """

    reads: list
    writes: list

    @property
    def n_items(self) -> int:
        return len(self.reads)


def check_conflicts(trace: MemoryTrace, n_tasks: int) -> tuple[bool, str]:
    """Partition work items round-robin into n_tasks; conflict iff some
    task writes an index another task reads or writes."""
    n = trace.n_items
    writes_by_task = [set() for _ in range(n_tasks)]
    reads_by_task = [set() for _ in range(n_tasks)]
    for i in range(n):
        t = i % n_tasks
        writes_by_task[t].update(np.asarray(trace.writes[i]).ravel().tolist())
        reads_by_task[t].update(np.asarray(trace.reads[i]).ravel().tolist())
    for t in range(n_tasks):
        for u in range(n_tasks):
            if t == u:
                continue
            inter = writes_by_task[t] & (reads_by_task[u] | writes_by_task[u])
            if inter:
                return True, f"W/R conflict tasks {t}↔{u} on {len(inter)} addresses"
    return False, "no cross-task conflicts"
