"""The port's sharding rules and collectives against the JAX package, on the
CPU: ``ShardingRules`` specs and fallback records over
``tests/test_sharding_rules.py``'s random (cfg, mesh) cases, the paged pool
specs, ``cache_axes``, the kv-sequence split's slot layout and table view;
then, in one group of 8 gloo rank processes (``run_ranks``; bodies in
``tests/_torch_mesh_ranks.py``), ``distributed_softmax`` (one empty rank,
every rank empty → exact zeros), the ring matmuls and ``sp_swiglu`` on 2
and 4 ranks against their unsplit versions, and the three expert-parallel
MoE paths of reduced granite on the JAX test's ("data", "model") = (2, 4)
mesh against JAX's ``moe_block`` and its dense-mixture oracle, on the same
numpy parameters, with ``tests/test_sharded.py``'s tolerance (2e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    from _hypothesis_stub import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models.moe import _route as jroute
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_block as jmoe_block
from repro.parallel.sharding import ShardingRules as JRules
from repro.parallel.sharding import paged_pool_specs as jpool_specs
from repro.serve.kv_cache import PagedKVCache as JPaged
from repro.serve.kv_cache import local_table_view as jlocal_view
from repro_torch.configs import get_config as tget
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import Model as TModel
from repro_torch.parallel.sharding import ShardingRules, paged_pool_specs
from repro_torch.serve.kv_cache import PagedKVCache, local_table_view

import _torch_mesh_ranks as ranks

MOE_ATOL = 2e-4  # tests/test_sharded.py's
COL_ATOL = 1e-5


class _FakeMesh:
    """Shape-only mesh (``spec()`` reads nothing else), as the JAX test's."""

    def __init__(self, shape):
        self.shape = dict(shape)


class _RankMesh:
    """A DeviceMesh stand-in for one rank: axis names, sizes and this
    rank's coordinates (what ``PagedKVCache`` reads)."""

    def __init__(self, shape: dict, coords: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


def _cfgs(n_heads, n_kv):
    return (dataclasses.replace(jget("smollm-135m").reduced(), n_heads=n_heads,
                                n_kv_heads=n_kv),
            dataclasses.replace(tget("smollm-135m").reduced(), n_heads=n_heads,
                                n_kv_heads=n_kv))


def _same_spec(jspec, tspec):
    assert tuple(jspec) == tspec, (tuple(jspec), tspec)


@settings(max_examples=40, deadline=None)
@given(
    n_heads=st.integers(1, 16),
    n_kv=st.integers(1, 8),
    model=st.sampled_from([1, 2, 3, 4, 8]),
    data=st.sampled_from([1, 2, 4]),
    mult=st.integers(1, 3),
)
def test_specs_and_fallbacks_match_jax_random(n_heads, n_kv, model, data, mult):
    """Over the JAX property test's random (cfg, mesh) cases, every spec and
    every fallback record equal the JAX package's."""
    jcfg, tcfg = _cfgs(n_heads, n_kv)
    mesh = _FakeMesh({"data": data, "model": model})
    annotations = [
        (("embed", "heads", "head_dim"), (tcfg.d_model, n_heads, 16)),
        (("embed", "kv_heads", "head_dim"), (tcfg.d_model, n_kv, 16)),
        ((None, "batch", "kv_seq", "kv_heads", None), (2, 4, 32, n_kv, 16)),
        (("batch", "seq_sp", "heads", None), (data * 2, model * mult, n_heads, 16)),
        (("mlp", "vocab"), (model * mult, model * mult)),
        (("experts", None, "expert_mlp"), (model * mult, 8, data * mult)),
    ]
    for axes, shape in annotations:
        jr, tr = JRules(mesh, jcfg), ShardingRules(mesh, tcfg)
        _same_spec(jr.spec(axes, shape), tr.spec(axes, shape))
        assert jr.fallbacks == tr.fallbacks, (jr.fallbacks, tr.fallbacks)
        assert jr.table == tr.table
        assert jr.kv_heads_ok == tr.kv_heads_ok


@pytest.mark.parametrize("model,mult", [(2, 1), (3, 2), (4, 3), (8, 1)])
def test_drop_records_match_jax(model, mult):
    """Both drop paths — an axis an earlier dimension used, a dimension the
    axis does not divide — leave the JAX package's records; a mesh without
    'data' is no fallback; ``tp_view`` drops the FSDP axes and shares the
    record; ``constrain`` is the identity."""
    jcfg, tcfg = _cfgs(4, 2)
    mesh = _FakeMesh({"data": 2, "model": model})
    jr, tr = JRules(mesh, jcfg), ShardingRules(mesh, tcfg)
    dim = model * mult
    _same_spec(jr.spec(("mlp", "vocab"), (dim, dim)), tr.spec(("mlp", "vocab"), (dim, dim)))
    _same_spec(jr.spec(("mlp",), (dim + 1,)), tr.spec(("mlp",), (dim + 1,)))
    assert jr.fallbacks == tr.fallbacks and tr.fallbacks
    serving = _FakeMesh({"model": model})
    jr, tr = JRules(serving, jcfg), ShardingRules(serving, tcfg)
    _same_spec(jr.spec(("batch", "seq", None), (8, 16, 32)),
               tr.spec(("batch", "seq", None), (8, 16, 32)))
    assert tr.fallbacks == [] == jr.fallbacks
    fsdp = dataclasses.replace(tcfg, param_sharding="fsdp")
    jfsdp = dataclasses.replace(jcfg, param_sharding="fsdp")
    jv, tv = JRules(mesh, jfsdp).tp_view(), ShardingRules(mesh, fsdp).tp_view()
    assert jv.table == tv.table and tv.table["embed"] is None
    x = torch.ones(2, 3)
    assert tv.constrain(x, ("batch", None)) is x


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("axis,seq_axis", [("model", None), (None, "seq"), ("model", "seq"),
                                           (None, None)])
def test_paged_pool_specs_match_jax(axis, seq_axis, quantized):
    want = jpool_specs(axis, seq_axis, quantized=quantized)
    got = paged_pool_specs(axis, seq_axis, quantized=quantized)
    assert set(want) == set(got)
    for name in want:
        _same_spec(want[name], got[name])
    jcfg, tcfg = _cfgs(8, 4)
    jm = JModel(dataclasses.replace(jcfg, kv_quant=quantized))
    tm = TModel(dataclasses.replace(tcfg, kv_quant=quantized), device="cpu")
    jm_specs, tm_specs = jm.paged_pool_specs(axis, seq_axis), tm.paged_pool_specs(axis, seq_axis)
    assert {k: tuple(v) for k, v in jm_specs.items()} == tm_specs


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b", "stablelm-3b"])
def test_cache_axes_match_jax(arch):
    jm = JModel(jget(arch).reduced())
    tm = TModel(tget(arch).reduced(), device="cpu")
    want = jm.cache_axes(jm.init_cache(2, 16))
    got = tm.cache_axes(tm.init_cache(2, 16))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], prefix + (k,))
        else:
            yield prefix, tuple(tree)

    assert dict(flat(want)) == dict(flat(got))


def _jax_paged(jm, monkeypatch, **kw):
    """The JAX package's PagedKVCache on a shape-only mesh: its device
    placement (a NamedSharding over real devices) made a no-op, the slot
    layout and the host tables as they are."""
    monkeypatch.setattr(jax, "device_put", lambda x, *a, **k: x)
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda *a, **k: None)
    return JPaged(jm, **kw)


@pytest.mark.parametrize("sp,tp,num_blocks", [(2, 1, None), (2, 2, 23), (4, 1, 13), (1, 2, None)])
def test_slot_layout_matches_jax(sp, tp, num_blocks, monkeypatch):
    """The kv-sequence split's slot layout (one scratch slot ending each
    shard), the null block and the block tables through admissions, tail
    claims, rewinds and frees equal the JAX package's; this rank's pool is
    its shard (``total_blocks / sp`` slots, ``KV / tp`` heads)."""
    jcfg, tcfg = _cfgs(8, 4)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    shape = {"model": tp, "seq": sp}
    kw = dict(max_batch=4, max_seq=64, block_size=8, num_blocks=num_blocks, prefix_cache=False)
    jkv = _jax_paged(jm, monkeypatch, mesh=_FakeMesh(shape), **kw)
    tkv = PagedKVCache(tm, mesh=_RankMesh(shape, {"model": tp - 1, "seq": sp - 1}), **kw)
    np.testing.assert_array_equal(jkv._slot, tkv._slot)
    assert (jkv.total_blocks, jkv.null_block) == (tkv.total_blocks, tkv.null_block)
    assert tuple(tkv.pool["k"].shape) == (2, tkv.total_blocks // sp, 8, 4 // tp, tcfg.head_dim)
    for kv in (jkv, tkv):
        for rid, n in enumerate((9, 3, 17)):
            assert kv.try_admit(rid, tuple(range(n)), budget=12) is not None
        kv.ensure_tail_n(0, 5)
        kv.advance_n(0, 5)
        kv.truncate_row(0, 3)
        kv.free_row(1)
        kv.ensure_tail(2)
        kv.check_invariants()
    np.testing.assert_array_equal(jkv.block_tables, tkv.block_tables)
    np.testing.assert_array_equal(jkv.cache_len, tkv.cache_len)


@pytest.mark.parametrize("nb_loc,rank", [(5, 0), (5, 1), (9, 2), (4, 3)])
def test_local_table_view_matches_jax(nb_loc, rank):
    tables = np.random.default_rng(nb_loc * 7 + rank).integers(0, 4 * nb_loc, (6, 9), np.int32)
    jl, jo = jlocal_view(jnp.asarray(tables), nb_loc, rank)
    tl, to = local_table_view(torch.from_numpy(tables), nb_loc, rank)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert tl.dtype == torch.int32 and to.dtype == torch.bool


# ---------------------------------------------------------------------------
# collectives and the MoE paths, in rank processes


def _moe_inputs():
    cfg = jget("granite-moe-1b-a400m").reduced()
    params, _ = jinit_moe(jax.random.key(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (2, 16, cfg.d_model))
    xd = jax.random.normal(jax.random.key(1), (8, 1, cfg.d_model))
    return cfg, params, x, xd


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The collectives on 2 and 4 ranks and the MoE paths on 8, in one group
    of 8 gloo ranks: name → what rank 0 found, or {"error": traceback}."""
    _, params, x, xd = _moe_inputs()
    np_params = {k: np.asarray(v) for k, v in params.items()}
    todo = [("col2", "collectives_vs_dense", (2,)), ("col4", "collectives_vs_dense", (4,)),
            ("moe", "moe_paths", (np_params, np.asarray(x), np.asarray(xd)))]
    out = tmp_path_factory.mktemp("mesh")
    run_ranks(ranks.run_cases, 8, todo, str(out), store=str(out / "store"),
              timeout_s=120.0)
    return ranks.load(str(out), 0)


def _case(cases, name):
    found = cases[name]
    assert "error" not in found, found.get("error")
    return found


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_softmax_combine(world, cases):
    """Per-rank partials combine to the unsplit softmax (every rank holding
    keys, and only rank 0: the others' empty shards scaled to 0, no NaN);
    every rank empty gives exact zeros (checked in the rank)."""
    found = _case(cases, f"col{world}")
    assert found["all"] <= COL_ATOL and found["first_only"] <= COL_ATOL, found


@pytest.mark.parametrize("world", [2, 4])
def test_ring_collectives_match_dense(world, cases):
    """``ring_allgather_matmul``, ``matmul_reducescatter`` and
    ``sp_swiglu`` against their dense products."""
    found = _case(cases, f"col{world}")
    for name in ("allgather_matmul", "matmul_reducescatter", "sp_swiglu"):
        assert found[name] <= COL_ATOL * 10, (name, found[name])


def test_moe_dispatch_matches_jax(cases):
    """The all-to-all path on (data, model) = (2, 4) == JAX's single-device
    ``moe_block``; the port's local path too."""
    cfg, params, x, _ = _moe_inputs()
    want, _ = jmoe_block(x, params, cfg, None)
    found = _case(cases, "moe")
    np.testing.assert_allclose(found["dispatch"], np.asarray(want), atol=MOE_ATOL, rtol=MOE_ATOL)
    np.testing.assert_allclose(found["local"], np.asarray(want), atol=MOE_ATOL, rtol=MOE_ATOL)


@pytest.mark.parametrize("path", ["dense", "legacy"])
def test_moe_dense_paths_match_mixture_oracle(path, cases):
    """The decode paths compute every expert's masked share of every token:
    JAX's dense-mixture oracle."""
    cfg, params, _, xd = _moe_inputs()
    x2 = xd.reshape(-1, cfg.d_model)
    gates, idx, _ = jroute(x2, params["router"], cfg.top_k)
    h = jax.nn.silu(jnp.einsum("td,edf->etf", x2, params["we1"]))
    h = h * jnp.einsum("td,edf->etf", x2, params["we3"])
    ye = jnp.einsum("etf,efd->etd", h, params["we2"])
    gmat = jnp.zeros((x2.shape[0], cfg.n_experts)).at[
        jnp.arange(x2.shape[0])[:, None], idx].add(gates)
    want = jnp.einsum("etd,te->td", ye, gmat).reshape(xd.shape)
    found = _case(cases, "moe")
    np.testing.assert_allclose(found[path], np.asarray(want), atol=MOE_ATOL, rtol=MOE_ATOL)
