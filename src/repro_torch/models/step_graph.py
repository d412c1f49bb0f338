"""Compiled step families: the port's counterpart of ``jax.jit``.

The JAX package compiles each serving step once per input signature
(``Model.jit_step`` is ``jax.jit`` of the step with its attention backend
bound), and its scheduler counts every later compile as a retrace.
``StepGraph`` stands where ``jax.jit`` stands. It keeps one entry per key:
the step's name, its backend, the shapes and dtypes of the tensor
arguments and the values of the others (``max_seq``). ``_cache_size()``
counts what has been compiled, as a jitted function's does.

On a CUDA device an entry holds a captured ``torch.cuda.CUDAGraph``:

- the first call of a key runs eagerly and returns its results. It is the
  warm-up: the kernel library's build and load, the kernels' shared-memory
  attributes, cuBLAS's handle and workspace, the allocator. The graph is
  captured after it, on a side stream; a capture runs nothing, so no
  step's effect (a KV write, an SSM state advanced in place) happens twice;
- later calls copy the small inputs (the top-level tensor arguments and a
  cache's ``len``: tokens, lengths, block tables, ``prompt_len``,
  ``n_valid``, a prefix hit's rows) into the entry's static buffers, and
  replay;
- every other tensor (the parameters, the KV cache or pool, the SSM state)
  is state: captured by address and updated in place, never copied. A
  capture records the addresses of the state it ran on; a call on other
  storage captures again, and that capture counts in ``_cache_size()`` as
  a retrace, so a leak of fresh storage shows in the counter;
- outputs that are state come back as the caller's own tensors; logits and
  ``len`` come back as clones, so a caller may keep them past the next
  replay; the cache a prefill makes is the graph's own buffers, valid until
  the entry's next replay (callers copy it into a pool at once).

Every graph of one model shares one memory pool. A capture or a replay
that fails raises: nothing falls back to eager.

On the CPU an entry is the record of its key and the call runs eagerly, so
``_cache_size()`` (and the scheduler's retrace count) means there what it
means in JAX. So does ``ShardedStep``, a rank's shard of a paged step on a
serving mesh, on the card too: its collectives run over gloo, which a CUDA
graph cannot capture.

The kernels count their launches in Python. A capture counts the launches
of the call it records, keeps them as the graph's launch vector and takes
them back off; each replay adds the vector, so launch counts read as they
would eagerly.

``disabled()`` is ``jax.disable_jit()``'s counterpart: inside it every step
runs eagerly, on the card too, and no entry is made. Tests and
``chip_smoke.py`` compare the two paths through it; it is no engine option.

``GraphFamily`` is the same machinery over any callable, for the steps that
are no ``Model`` step: a decode plan's pool step (the scheduler's
``_plan_decode``) and the train step (``train/trainer.py``). Its caller
names the arguments whose tensors are inputs (copied into static buffers,
whatever their depth: a batch dict's leaves); every other tensor argument
is state. Every output that is no state tensor comes back as a clone. A
step that returns new tensors for its state goes through ``in_place``
first, so that its graph ends by copying them into the caller's state.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import relic_matmul as _rm
from repro_torch.kernels import ssd_scan as _ssd

# the steps ``Model.jit_step`` compiles
STEPS = ("decode_step", "verify_step", "decode_step_paged", "verify_step_paged", "prefill",
         "prefill_with_prefix", "prefill_chunk")

# (wrapper, attribute) of every kernel launch counter
LAUNCH_COUNTERS = (
    (_pda.paged_decode_attention, "launches"),
    (_pda.paged_decode_attention, "launches_int8"),
    (_pda.paged_decode_attention, "launches_partials"),
    (_fa.flash_attention, "launches"),
    (_fa.flash_attention, "launches_noncausal"),
    (_ssd.ssd_scan, "launches"),
    (_rm.relic_matmul, "launches"),
    (_rm.relic_gemv, "launches"),
    (_da.decode_attention, "launches"),
)

_disabled = 0


@contextlib.contextmanager
def disabled():
    """Run every step eagerly inside the block, as ``jax.disable_jit()``
    does, and make no entry."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def _launches() -> list:
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _set_launches(values) -> None:
    for (fn, attr), v in zip(LAUNCH_COUNTERS, values):
        setattr(fn, attr, v)


def _flatten(tree, path=()):
    """(path, leaf) pairs of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, items):
    """A tuple or list of ``tree``'s type over ``items`` (a NamedTuple, such
    as an ``OptState``, from its fields)."""
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _replace(tree, repl: dict, path=()):
    """``tree`` with the leaves at the paths of ``repl`` replaced; a
    container none of whose leaves changed is returned as it is."""
    if path in repl:
        return repl[path]
    if isinstance(tree, dict):
        out = {k: _replace(v, repl, path + (k,)) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    if isinstance(tree, (list, tuple)):
        out = [_replace(v, repl, path + (i,)) for i, v in enumerate(tree)]
        return tree if all(a is b for a, b in zip(out, tree)) else _rebuild(tree, out)
    return tree


class _Slot:
    """A leaf's place in an output skeleton."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _skeleton(tree, leaves: list, path=()):
    """``tree`` with each leaf replaced by a ``_Slot``; the (path, leaf)
    pairs go to ``leaves``."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (_skeleton(v, leaves, path + (i,)) for i, v in enumerate(tree)))
    leaves.append((path, tree))
    return _Slot(len(leaves) - 1)


def _fill(skeleton, values):
    if isinstance(skeleton, dict):
        return {k: _fill(v, values) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return _rebuild(skeleton, (_fill(v, values) for v in skeleton))
    return values[skeleton.i]


class _Capture:
    """One captured graph: its static input buffers, its output plan and
    its launch vector."""

    def __init__(self, graph, inputs, static, skeleton, plan, launches):
        self.graph, self.inputs, self.static = graph, inputs, static
        self.skeleton, self.plan, self.launches = skeleton, plan, launches


def in_place(fn, writes: dict):
    """``fn`` with its new state written into the caller's: ``writes`` maps
    an output position to the argument position whose tree it replaces.
    Each tensor of that output is copied into the argument's tensor at the
    same path, and the call returns the argument in the output's place, so
    a ``GraphFamily`` over it captures the copies at the end of its graph
    and hands the caller its own state back. The two trees must hold the
    same paths."""

    def step(*args):
        out = list(fn(*args))
        with torch.no_grad():
            for o, a in writes.items():
                dst = dict(_flatten(args[a]))
                new = dict(_flatten(out[o]))
                if new.keys() != dst.keys():
                    raise ValueError(f"in_place: output {o} and argument {a} hold other paths: "
                                     f"{sorted(map(str, new.keys() ^ dst.keys()))[:4]}")
                for path, t in new.items():
                    if t is not dst[path]:
                        dst[path].copy_(t)
                out[o] = args[a]
        return tuple(out)

    return step


class GraphFamily:
    """``fn`` compiled once per key (see the module docstring): a captured
    CUDA graph an entry on the card, the record of the key on the CPU.
    ``inputs``: the positions (and keyword names) of the arguments whose
    tensors are inputs; every other tensor argument is state. ``pool``:
    a callable giving the (memory pool, side stream) the entries share."""

    def __init__(self, fn, device, pool, *, inputs=(), name: str = "step"):
        self.fn, self.name, self.pool = fn, name, pool
        self.inputs = frozenset(inputs)
        self.device = torch.device(device)
        self.eager = self.device.type != "cuda"  # record keys, run eagerly
        self._entries: dict = {}  # key → {state addresses: _Capture} (eager: None)
        self._size = 0

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r}, entries={self._size})"

    def _cache_size(self) -> int:
        """Keys compiled, plus every recapture on other state storage."""
        return self._size

    def _is_input(self, path) -> bool:
        """The leaf at ``path`` (("a", position, …) or ("k", name, …)) is an
        input: it lies under an argument named in ``inputs``."""
        return path[1] in self.inputs

    def _keep_own(self, path) -> bool:
        """An output leaf at ``path`` that is no state may come back as the
        graph's own buffer, not a clone."""
        return False

    def _eager(self, args, kwargs):
        return self.fn(*args, **kwargs)

    def _host(self, x):
        """A host-side input as a device tensor (the n_valid list, a numpy
        length vector, a CPU mask); tensors move to the device."""
        if isinstance(x, (np.ndarray, list, tuple)):
            return torch.as_tensor(np.asarray(x)).to(self.device)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            return x.to(self.device)
        return x

    def __call__(self, *args, **kwargs):
        if _disabled:
            return self._eager(args, kwargs)
        args = tuple(self._host(a) if self._is_input(("a", i)) else a for i, a in enumerate(args))
        kwargs = {k: self._host(v) if self._is_input(("k", k)) else v for k, v in kwargs.items()}
        leaves = list(_flatten(args, ("a",))) + list(_flatten(kwargs, ("k",)))
        key = tuple((p, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else (p, v)
                    for p, v in leaves)
        if self.eager:
            if key not in self._entries:
                self._entries[key] = None
                self._size += 1
            return self._eager(args, kwargs)
        entry = self._entries.get(key)
        state = tuple((v.data_ptr(), v.stride()) for p, v in leaves
                      if isinstance(v, torch.Tensor) and not self._is_input(p))
        if entry is None:
            out = self._warm(args, kwargs)
            self._entries[key] = {state: self._capture(args, kwargs, leaves)}
            self._size += 1
            return out
        cap = entry.get(state)
        if cap is None:
            cap = entry[state] = self._capture(args, kwargs, leaves)
            self._size += 1
        return self._replay(cap, leaves)

    def _warm(self, args, kwargs):
        """The first call of a key, eager, on the side stream the capture
        will use (the documented warm-up for a capture); the current stream
        waits for it."""
        cur, side = torch.cuda.current_stream(self.device), self.pool()[1]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._eager(args, kwargs)
        cur.wait_stream(side)
        return out

    def _capture(self, args, kwargs, leaves) -> _Capture:
        inputs = [i for i, (p, v) in enumerate(leaves)
                  if isinstance(v, torch.Tensor) and self._is_input(p)]
        static = [leaves[i][1].detach().clone() for i in inputs]
        repl = {leaves[i][0]: buf for i, buf in zip(inputs, static)}
        a_repl = {p[1:]: v for p, v in repl.items() if p[0] == "a"}
        k_repl = {p[1:]: v for p, v in repl.items() if p[0] == "k"}
        c_args, c_kwargs = _replace(args, a_repl), _replace(kwargs, k_repl)
        before = _launches()
        graph = torch.cuda.CUDAGraph()
        pool, side = self.pool()
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.graph(graph, pool=pool, stream=side):
            out = self._eager(c_args, c_kwargs)
        cur.wait_stream(side)
        launches = [a - b for a, b in zip(_launches(), before)]
        _set_launches(before)
        # each output leaf: the caller's state tensor it is, a clone of a
        # graph output (logits, len, metrics), or the graph's own buffer (a
        # new cache)
        state_of = {id(v): i for i, (p, v) in enumerate(leaves)
                    if isinstance(v, torch.Tensor) and not self._is_input(p)}
        buffers = {id(b) for b in static}
        out_leaves: list = []
        skeleton = _skeleton(out, out_leaves)
        plan = []
        for path, v in out_leaves:
            if not isinstance(v, torch.Tensor):
                plan.append(("const", v))
            elif id(v) in state_of:
                plan.append(("state", state_of[id(v)]))
            elif id(v) in buffers or not self._keep_own(path):
                plan.append(("clone", v))
            else:
                plan.append(("own", v))
        return _Capture(graph, inputs, static, skeleton, plan, launches)

    def _replay(self, cap: _Capture, leaves):
        for i, buf in zip(cap.inputs, cap.static):
            buf.copy_(leaves[i][1], non_blocking=True)
        cap.graph.replay()
        if any(cap.launches):
            _set_launches([a + d for a, d in zip(_launches(), cap.launches)])
        values = []
        for kind, v in cap.plan:
            if kind == "state":
                values.append(leaves[v][1])
            elif kind == "clone":
                values.append(v.clone())
            else:
                values.append(v)
        return _fill(cap.skeleton, values)


class StepGraph(GraphFamily):
    """A model step with its backend bound, compiled once per key (see the
    module docstring). ``model`` owns the graph memory pool; the step is
    looked up on it at each call. The inputs are the top-level tensor
    arguments and a cache's ``len``; a new cache the step returns comes
    back as the graph's own buffers."""

    def __init__(self, model, name: str, backend: str):
        if name not in STEPS:
            raise ValueError(f"jit_step: unknown step {name!r}; steps are {STEPS}")
        super().__init__(None, model.device, model.graph_pool, name=name)
        self.model, self.backend = model, backend

    def __repr__(self) -> str:
        return f"StepGraph({self.name!r}, backend={self.backend!r}, entries={self._size})"

    def _is_input(self, path) -> bool:
        return len(path) == 2 or path[-1] == "len"

    def _keep_own(self, path) -> bool:
        return not (len(path) == 1 or path[-1] == "len")

    def _eager(self, args, kwargs):
        return getattr(self.model, self.name)(*args, backend=self.backend, **kwargs)


class ShardedStep(StepGraph):
    """This rank's shard of ``decode_step_paged`` / ``verify_step_paged`` on
    a serving mesh (``Model.sharded_paged_step``; the JAX package's
    ``jit(shard_map(...))``). ``model`` is the local view; ``full`` the
    model whose parameters the caller passes. On a head split (``tp`` > 1
    ranks along ``axis``) the rank's columns of ``wq``/``wk``/``wv`` are
    sliced once per parameter dict (flat [L, D, H·hd] or [L, D, H, hd]
    layouts) and ``wo`` stays whole. The step's collectives run over gloo,
    which a CUDA graph cannot capture, so the family keeps the per-key
    record and runs eagerly, as a ``StepGraph`` does on the CPU."""

    def __init__(self, model, name: str, backend: str, full, mesh, axis, tp: int):
        if name not in ("decode_step_paged", "verify_step_paged"):
            raise ValueError(f"sharded_paged_step: {name!r} is not a paged step")
        super().__init__(model, name, backend)
        self.eager = True
        self.full, self.mesh, self.axis, self.tp = full, mesh, axis, tp
        self._src = self._local = None

    def __repr__(self) -> str:
        return (f"ShardedStep({self.name!r}, backend={self.backend!r}, "
                f"mesh={dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}, "
                f"entries={self._size})")

    def local_params(self, params) -> dict:
        """``params`` with this rank's head columns of the q/k/v
        projections (copies, made once per parameter dict)."""
        if self._src is not params:
            self._src, self._local = params, self._slice(params)
        return self._local

    def _slice(self, params) -> dict:
        if self.tp == 1:
            return params
        cfg = self.model.cfg
        r, hd = self.mesh.get_local_rank(self.axis), cfg.head_dim

        def sl(w, n_loc):
            if w.dim() == 3:  # flat [L, D, H·hd]: a head block is a column range
                return w[:, :, r * n_loc * hd:(r + 1) * n_loc * hd].contiguous()
            return w[:, :, r * n_loc:(r + 1) * n_loc].contiguous()

        attn = params["layers"]["attn"]
        attn = dict(attn, wq=sl(attn["wq"], cfg.n_heads), wk=sl(attn["wk"], cfg.n_kv_heads),
                    wv=sl(attn["wv"], cfg.n_kv_heads))
        return dict(params, layers=dict(params["layers"], attn=attn))

    def _eager(self, args, kwargs):
        params, *rest = args
        return getattr(self.model, self.name)(self.local_params(params), *rest,
                                              backend=self.backend, **kwargs)


def cache_size(fns) -> int:
    """The compiled entries of a set of step families (each counted once)."""
    seen = {id(f): f for f in fns if f is not None and hasattr(f, "_cache_size")}
    return sum(f._cache_size() for f in seen.values())

