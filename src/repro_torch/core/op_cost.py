"""Aten-op cost counter: the FLOPs, bytes and collective bytes of one step.

The port's counterpart of the JAX package's ``core/hlo_cost.py``, which
walks a compiled program's HLO text. The port has no compiled program, so
``OpCounter`` (a ``TorchDispatchMode``) sees each op as it runs, on meta
tensors (shapes only: nothing is allocated or run) or on real ones:

- **FLOPs:** each aten op as ``torch.utils.flop_counter`` counts it (its
  formula registry, and an op it has none for decomposed as
  ``FlopCounterMode`` decomposes it), so a train step's forward and
  backward both count. Each ``repro_torch::*`` kernel operator is charged
  its work from ``kernels/work.py`` (FLOPs and bytes), the same work its
  plain route would do, so a step counts alike on either backend.
- **Bytes:** every op that computes charges the bytes of its tensor
  inputs as viewed (a stride-0 axis of an ``expand`` counted once) plus
  its outputs. In-place ops charge the region they write (a view's bytes;
  for an indexed write such as ``index_put_``, the values written, not
  the whole target); an indexed read (``index``, ``index_select``,
  ``gather``) charges the rows it reads, no more than
  its output. View and metadata ops (``view``, ``select``, ``slice``,
  ``expand``, ``permute``, ``t``, ``as_strided``, ``_unsafe_view``,
  ``detach``, ``alias``: every op whose outputs alias its inputs) and
  allocations (``empty*``) charge nothing. This is what eager ops, and
  the CUDA graphs that replay them, move through device memory op by op.
  The JAX walker models the TPU's fused program instead (elementwise
  fusions are left out, ``hlo_cost.py``), so bytes differ from JAX's by
  design; FLOPs agree.
- **Collectives:** ``parallel/collectives.py`` reports each call's op
  (JAX's names: ``all-reduce``, ``all-gather``, ``all-to-all``, a ring
  shift as ``collective-permute``) and per-device payload to every
  counter that is counting (``core/op_analysis.CollectiveStats``).
- **Loops:** the port unrolls its loops, so there is no trip count to
  recover: L layers count L times one layer's ops.
- **No silent zeros:** a CUDA graph replay launches kernels no dispatch
  mode sees, so a replay under the counter raises (``CUDAGraph.replay``
  is guarded while a counter counts) and ``analyze`` runs its function
  under ``step_graph.disabled()``, where every compiled step runs
  eagerly.

Beside the totals the counter keeps ``OpStats`` by op class (``aten::mm``,
``repro_torch::paged_decode_attention``) and a memory estimate: the
argument, output and aliased bytes, and the peak of live intermediate
bytes it saw (the outputs of ops, freed when their tensors die).
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.op_analysis import CollectiveStats, OpStats
from repro_torch.kernels import work
from repro_torch.models import step_graph
from repro_torch.parallel import collectives

aten = torch.ops.aten

# a view whose schema does not say so (``func.is_view`` covers the rest)
_VIEWS = frozenset({aten._unsafe_view})
# allocations: no byte moves until something writes the storage
_ALLOCS = frozenset({aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
                     aten.new_empty_strided})
# in-place writes that read nothing of the target
_OVERWRITES = frozenset({aten.copy_, aten.fill_, aten.zero_})
# indexed reads: the table (``self``) charges at most the output's bytes
_GATHERS = frozenset({aten.index, aten.index_select, aten.gather})

# each kernel operator's work, from its arguments as the operator takes them
_KERNELS = {
    "repro_torch::paged_decode_attention": lambda a: work.paged(a[0], a[1], a[3], a[4]),
    "repro_torch::paged_decode_partials": lambda a: work.partials(a[0], a[1], a[3], a[4], a[5]),
    "repro_torch::flash_attention": lambda a: work.flash(a[0], a[1], a[3], a[4]),
    "repro_torch::relic_matmul": lambda a: work.matmul(a[0], a[1]),
    "repro_torch::relic_gemv": lambda a: work.matmul(a[0], a[1]),
    "repro_torch::decode_attention": lambda a: work.decode(a[0], a[1], a[3]),
    "repro_torch::ssd_scan": lambda a: work.ssd(a[0], a[2], a[5]),
}


def view_bytes(t: torch.Tensor) -> int:
    """The bytes a view addresses: its elements, an axis of stride 0
    (``expand``) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclass
class MemoryStats:
    """The JAX package's ``compiled.memory_analysis()`` fields, from the
    tensors of one counted run: arguments, outputs, the outputs that alias
    an argument's storage (a step that updates its state in place), and
    the peak of live intermediate bytes (tensors ops made that are no
    output, live between the op that made them and their last use)."""

    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0


@dataclass
class OpCost:
    """``HloCost``'s fields (``flops``, ``bytes``, ``collective_bytes``,
    ``collective_by_op``, ``collective_counts``), with the op classes and
    the memory estimate beside them."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    ops: OpStats = field(default_factory=OpStats)
    memory: MemoryStats = field(default_factory=MemoryStats)

    @property
    def collective_bytes(self) -> float:
        return self.collectives.bytes_total

    @property
    def collective_by_op(self) -> dict:
        return self.collectives.bytes_by_op

    @property
    def collective_counts(self) -> dict:
        return self.collectives.counts


_guard = threading.Lock()
_counting = 0
_replay = torch.cuda.CUDAGraph.replay


def _refuse_replay(graph, *args, **kwargs):
    raise RuntimeError(
        "a CUDA graph replay under the op counter: it launches kernels no dispatch mode sees, "
        "so the step would count nothing; run it eagerly (models.step_graph.disabled(), as "
        "core.op_cost.analyze does)")


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, op classes and collectives of what runs inside
    it (module docstring); ``cost`` holds the totals."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._depth = 0  # entries: a decomposition re-enters the mode
        self._serial = 0
        self._live: dict = {}  # id(tensor) → serial, while the tensor lives
        self._events: list = []  # (serial, ±bytes) as tensors are made and die
        self._finalizers: list = []

    # ---- collectives (parallel/collectives.py) and graph replays
    def _collective(self, op: str, payload: float) -> None:
        self.cost.collectives.add(op, payload)

    def __enter__(self):
        global _counting
        if not self._depth:
            with _guard:
                _counting += 1
                torch.cuda.CUDAGraph.replay = _refuse_replay
            collectives.OBSERVERS.append(self._collective)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _counting
        self._depth -= 1
        if not self._depth:
            collectives.OBSERVERS.remove(self._collective)
            for f in self._finalizers:  # what dies after the run is not the run's
                f.detach()
            self._finalizers.clear()
            with _guard:
                _counting -= 1
                if not _counting:
                    torch.cuda.CUDAGraph.replay = _replay
        return super().__exit__(*exc)

    # ---- live intermediates
    def _track(self, t: torch.Tensor) -> None:
        self._serial += 1
        serial, n = self._serial, t.numel() * t.element_size()
        self._live[id(t)] = serial
        self._events.append((serial, n))
        self._finalizers.append(weakref.finalize(t, self._died, id(t), serial, n))

    def _died(self, key, serial, n) -> None:
        if self._live.get(key) == serial:
            del self._live[key]
        self._events.append((serial, -n))

    def temp_bytes(self, outputs) -> int:
        """Peak of the live bytes of tensors ops made, ``outputs`` left out."""
        skip = {self._live[id(t)] for t in outputs if id(t) in self._live}
        live = peak = 0
        for serial, n in list(self._events):
            if serial not in skip:
                live += n
                peak = max(peak, live)
        return peak

    # ---- the ops
    def _charge(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.cost.ops.add(name, flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not isinstance(func, torch._ops.OpOverload):
            return func(*args, **kwargs)
        name = func._schema.name
        ns = name.split("::")[0]
        packet = func._overloadpacket
        if name in _KERNELS:
            out = func(*args, **kwargs)
            w = _KERNELS[name](args)
            self._charge(name, w.flops, w.bytes)
            for t in _tensors(out):
                self._track(t)
            return out
        if ns == "c10d" or func.is_view or packet in _VIEWS or packet in _ALLOCS:
            # collectives report themselves; views and allocations move nothing
            return func(*args, **kwargs)
        if packet not in flop_registry:
            # as FlopCounterMode: an op with a decomposition counts its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:  # a metadata query: nothing computed
            return out
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        self._charge(name, float(flops), float(self._bytes(func, packet, args, kwargs, out)))
        fresh = [r.alias_info is None for r in func._schema.returns]
        if all(fresh):
            for t in outs:
                self._track(t)
        return out

    def _bytes(self, func, packet, args, kwargs, out) -> int:
        """Reads of the tensor inputs as viewed plus writes (module
        docstring)."""
        schema = func._schema
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        out_b = sum(view_bytes(t) for t in _tensors(out))
        if packet is aten.index_put_:
            # a KV write: the region written is the values'; the target unread
            skip, out_b = {"self"}, view_bytes(named["values"])
        elif packet in _OVERWRITES:
            skip = {"self"}
        else:
            skip = {a.name for a in schema.arguments if a.is_out}
        reads = 0
        for k, v in named.items():
            if k not in skip:
                for t in _tensors(v):
                    b = view_bytes(t)
                    reads += min(b, out_b) if packet in _GATHERS and k == "self" else b
        return reads + out_b


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` with every
    compiled step eager (``step_graph.disabled()``) and return its
    ``OpCost``: on meta tensors the shapes' cost with nothing allocated or
    run, on real ones this run's (the kernels charged by the lengths these
    inputs hold; on a mesh this rank's share, on real tensors or, under a
    fake process group, on meta ones)."""
    with step_graph.disabled(), OpCounter() as counter:
        out = fn(*args, **kwargs)
    cost = counter.cost
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    arg_storages = {_storage(t) for t in ins}
    mem = cost.memory
    mem.argument_size_in_bytes = sum(t.numel() * t.element_size() for t in _unique(ins))
    mem.output_size_in_bytes = sum(t.numel() * t.element_size() for t in _unique(outs))
    mem.alias_size_in_bytes = sum(t.numel() * t.element_size() for t in _unique(outs)
                                  if _storage(t) in arg_storages)
    mem.temp_size_in_bytes = counter.temp_bytes(outs)
    return cost


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _unique(ts) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out
