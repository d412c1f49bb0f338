"""Logical-axis sharding rules with divisibility fallback.

Port of the JAX package's ``parallel/sharding.py``. Every parameter and
activation carries a tuple of *logical* axis names; ``ShardingRules`` maps
them onto mesh axes, dropping any mapping whose dimension the mesh axis
does not divide, and records each drop (``fallbacks``) under the dropped
dimension's logical name. A spec is a plain tuple with one entry a
dimension: ``None``, a mesh axis name, or a tuple of names — the entries of
the JAX package's ``PartitionSpec``, so that a test compares the two with
``tuple(jax_spec) == port_spec``.

The rules read only the mesh's axis sizes (``mesh_shape``): a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names`` and
``shape``) or any object whose ``shape`` is a name → size dict. PyTorch has
no GSPMD partitioner to hint, so ``constrain`` is the identity: in the port
each rank runs its shard's code itself (``Model.sharded_paged_step``,
``models/moe.py``), and a spec says which shard that is.

``shard_tree`` is the counterpart of ``tree_shardings`` plus
``device_put``: each leaf of a whole tree becomes this rank's slice of it,
by its spec; ``gather_tree`` puts the whole leaves back together on every
rank; ``grad_sum_axes`` says over which mesh axes a leaf's gradient is a
partial sum in a split training step.
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]


def mesh_shape(mesh) -> dict:
    """Axis name → size of ``mesh`` ({} for no mesh)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_size(mesh, axes: MeshAxes) -> int:
    """The product of the sizes of ``axes`` (1 for ``None``); an axis the
    mesh does not define counts 1."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in axes)


class ShardingRules:
    """cfg + mesh → specs for logical-axis-annotated arrays."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.cfg = cfg
        self.fallbacks: list[str] = []
        shape = mesh_shape(mesh)
        self._shape = shape
        has_pod = "pod" in shape
        batch_axes: MeshAxes = ("pod", "data") if has_pod else ("data",)
        fsdp = cfg.param_sharding == "fsdp"

        model = shape.get("model", 1)
        heads_ok = cfg.n_heads and cfg.n_heads % model == 0
        kv_ok = cfg.n_kv_heads and cfg.n_kv_heads % model == 0
        self.kv_heads_ok = bool(kv_ok)

        self.table: dict[str, MeshAxes] = {
            # parameter axes
            "layers": None,
            "groups": None,
            "embed": ("data",) if fsdp else None,
            "mlp": "model",
            "heads": "model" if heads_ok else None,
            "kv_heads": "model" if kv_ok else None,
            # q heads within a kv group travel with their group's kv head
            "q_heads_per_group": None,
            "head_dim": None,
            "qdim": "model",  # flattened h·hd projection dim (attn_flat_tp)
            "vocab": "model",
            "experts": "model",
            "expert_mlp": ("data",) if fsdp else None,  # FSDP axis on expert F
            "ssm_heads": "model",
            "ssm_inner": "model",
            "state": None,
            "conv": None,
            # activation axes
            "batch": batch_axes,
            "seq": None,
            # sequence-parallel fallback: queries over 'model' when heads
            # cannot shard
            "seq_sp": "model" if not heads_ok else None,
            # decode KV-cache sequence axis: over 'model' when the kv-head
            # axis cannot shard
            "kv_seq": None if kv_ok else "model",
            # paged-pool block dim over the serving 'seq' mesh axis (the
            # kv-sequence split, combined by collectives.distributed_softmax)
            "kv_blocks": "seq",
            "tokens_ep": batch_axes + ("model",),
        }

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        """The spec of an array with the given logical axes and shape. A
        mapping that does not divide its dimension evenly is dropped and
        recorded in ``fallbacks``; so is a mesh axis an earlier dimension
        already used (a mesh axis shards at most one dimension), recorded
        under the later dimension's name. Mesh axes the mesh does not define
        are no candidates at all, and skipping them is no fallback."""
        assert len(axes) == len(shape), (axes, shape)
        used: set[str] = set()
        out = []
        for name, dim in zip(axes, shape):
            mesh_axes = self.table.get(name) if name else None
            if mesh_axes is None:
                out.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            keep = []
            for a in mesh_axes:
                if a not in self._shape:
                    continue
                if a in used:
                    self.fallbacks.append(
                        f"{name}:{dim} mesh axis {a} already used by an earlier dim; dropped {a}"
                    )
                    continue
                keep.append(a)
            cand = tuple(keep)
            while cand and dim % math.prod(self._shape[a] for a in cand) != 0:
                dropped = cand[-1]
                cand = cand[:-1]
                self.fallbacks.append(f"{name}:{dim} ∤ mesh{dropped}; dropped {dropped}")
            if not cand:
                out.append(None)
                continue
            used.update(cand)
            out.append(cand[0] if len(cand) == 1 else cand)
        return tuple(out)

    def constrain(self, x, axes: Sequence[Optional[str]]):
        """The identity: there is no partitioner to hint (each rank runs
        its shard itself); kept so that code written against the JAX
        package's rules reads the same."""
        del axes
        return x

    def tp_view(self) -> "ShardingRules":
        """Rules with the FSDP ('data') parameter axes dropped: the
        compute-time layout of ZeRO-2 (storage FSDP-sharded, gathered once
        a step). The fallback record is shared with ``self``."""
        clone = copy.copy(self)
        clone.table = dict(self.table)
        for k in ("embed", "expert_mlp"):
            clone.table[k] = None
        clone.fallbacks = self.fallbacks
        return clone


def paged_pool_specs(axis: Optional[str] = "model", seq_axis: Optional[str] = None, *,
                     quantized: bool = False) -> dict:
    """Specs of the paged KV pool leaves ``[L, NB, BS, KV, hd]``: the
    kv-head dim (3) over ``axis`` (the head split: each rank holds its
    contiguous head block) and the block dim (1) over ``seq_axis`` (the
    kv-sequence split: each rank a contiguous range of physical blocks).
    Either may be ``None``; an int8 pool's scale leaves ``[L, NB, BS, KV]``
    shard the same way, without the head_dim axis."""
    kv = (None, seq_axis, None, axis, None)
    specs = {"k": kv, "v": kv}
    if quantized:
        sc = (None, seq_axis, None, axis)
        specs["k_scale"] = sc
        specs["v_scale"] = sc
    return specs


# ---------------------------------------------------------------------------
# trees of shards


def is_spec(node) -> bool:
    """Whether ``node`` is a spec (a plain tuple), the leaf of a spec tree."""
    return isinstance(node, tuple) and not hasattr(node, "_fields")


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def used_axes(spec) -> tuple:
    """Every mesh axis a spec splits some dimension over."""
    return tuple(a for entry in spec for a in spec_axes(entry))


def map_dicts(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over nested dicts (anything
    else is a leaf, a spec tuple too)."""
    if isinstance(tree, dict):
        return {k: map_dicts(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(tree, axes, rules) -> dict:
    """The spec of each leaf of a whole tree (nested dicts of tensors, or of
    anything with a ``shape``), by its logical axes in ``axes``."""
    return map_dicts(lambda t, ax: rules.spec(ax, tuple(t.shape)), tree, axes)


def shard_slices(spec, shape, mesh) -> tuple:
    """This rank's slice of each dimension of a whole array of ``shape``."""
    from repro_torch.parallel import collectives as col

    out = []
    for entry, dim in zip(spec, shape):
        axes = spec_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        n = axis_size(mesh, axes)
        i = col.shard_index(mesh, axes)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def shard_leaf(t, spec, mesh):
    """This rank's shard of the whole ``t`` (a copy: the whole leaf can go)."""
    if not used_axes(spec):
        return t
    return t[shard_slices(spec, t.shape, mesh)].clone(memory_format=torch.contiguous_format)


def shard_tree(tree, axes, rules, mesh) -> dict:
    """Each leaf of the whole ``tree`` as this rank's shard of ``mesh`` by
    ``rules.spec(axes, shape)``."""
    return map_dicts(lambda t, ax: shard_leaf(t, rules.spec(ax, tuple(t.shape)), mesh),
                     tree, axes)


def gather_leaf(t, spec, mesh):
    """The whole leaf back from this rank's shard ``t`` (every rank of the
    mesh calls it), without a gradient."""
    from repro_torch.parallel import collectives as col

    for dim, entry in enumerate(spec):
        if spec_axes(entry):
            t = col.all_gather_axes(t, mesh, spec_axes(entry), dim)
    return t


def gather_tree(tree, specs, mesh) -> dict:
    """``shard_tree``'s inverse: the whole leaves on every rank."""
    return map_dicts(lambda t, sp: gather_leaf(t, sp, mesh), tree, specs)


def grad_sum_axes(spec, mesh, batch_axes, partial_model: bool) -> tuple:
    """The mesh axes over which a leaf's gradient is a partial sum in a
    step split over ``mesh``: each batch axis that does not split the leaf
    (each rank differentiated its own batch shard; an FSDP shard's
    gradient was already summed over its axis by the gather's
    reduce-scatter), and "model" where ``partial_model`` (a leaf
    replicated over "model" but read inside a region split over it)."""
    held = set(used_axes(spec))
    axes = tuple(a for a in batch_axes if a in mesh_shape(mesh) and a not in held)
    if partial_model and "model" in mesh_shape(mesh) and "model" not in held:
        axes += ("model",)
    return axes
