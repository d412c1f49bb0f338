"""The port's serving core against the JAX package's on the CPU, in
float32: greedy token streams of ``serve()`` (slot and paged layouts, an
open-loop workload and a shared-prefix workload) and of ``generate()``
must be identical; the summary schema and the prefix hit rate must
agree; a decode plan advised over ``decode_region()`` serves reduced
smollm-135m and zamba2-2.7b (int8 KV cache) token-identically to the JAX
engine's plan path and to the port's no-plan path, an odd batch
included; the paged kernel's operator gives the plain version's result
under ``vmap``; the options of later slices must refuse loudly; and no entry
point may fall back to the CPU on its own."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import ServingEngine as JEngine
from repro.serve import make_requests as j_requests
from repro.serve import make_shared_prefix_requests as j_prefix_requests
from repro.serve.differential import assert_streams_equal
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve import make_requests as t_requests
from repro_torch.serve import make_shared_prefix_requests as t_prefix_requests

KW = dict(max_seq=64, block_size=8)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def _open_loop(make, cfg):
    return make(10, 200.0, vocab=cfg.vocab_size, max_new_tokens=8,
                rng=np.random.default_rng(1))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_serve_streams_match_jax(pair, layout):
    cfg, jm, jp, tm, tp = pair
    je = JEngine(jm, jp, kv_layout=layout, **KW)
    te = ServingEngine(tm, tp, kv_layout=layout, device="cpu", **KW)
    want = je.serve(_open_loop(j_requests, cfg), max_batch=4)
    sched = te.scheduler(4)
    got = sched.run(_open_loop(t_requests, cfg))
    assert_streams_equal(want, got, label=layout)
    sched.kv.check_invariants()  # every slot / block returned to the pool
    js, ts = je.stats.serving_summary(), te.stats.serving_summary()
    assert sorted(ts) == sorted(js)  # the schema the JAX package has on this tree
    assert ts["n_requests"] == js["n_requests"] == 10


def test_prefix_reuse_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair

    def work(make):
        return make(6, 100.0, vocab=cfg.vocab_size, prefix_len=24, suffix_len=5,
                    max_new_tokens=6, rng=np.random.default_rng(2))

    je = JEngine(jm, jp, kv_layout="paged", **KW)
    te = ServingEngine(tm, tp, kv_layout="paged", device="cpu", **KW)
    want = je.serve(work(j_prefix_requests), max_batch=3)
    sched = te.scheduler(3)
    got = sched.run(work(t_prefix_requests))
    assert_streams_equal(want, got, label="shared-prefix")
    rate = te.stats.serving_summary()["prefix_hit_rate"]
    assert rate > 0 and rate == je.stats.serving_summary()["prefix_hit_rate"]
    sched.kv.check_invariants()


def test_generate_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    want = JEngine(jm, jp, **KW).generate(jax.numpy.asarray(prompts), 6)
    got = ServingEngine(tm, tp, device="cpu", **KW).generate(prompts, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded(pair):
    cfg, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", temperature=1.0, **KW)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = eng.generate(prompts, 6, seed=3)
    assert torch.equal(a, eng.generate(prompts, 6, seed=3))


class _SeqMesh:
    """A one-axis ("seq", 2) mesh as the engine reads one before serving
    (axis names and sizes): enough for the refusals, which come first."""

    mesh_dim_names, shape = ("seq",), (2,)


def test_out_of_slice_options_refuse(pair):
    """No option of the engine refuses as not ported any more: sharded
    serving (ROADMAP §1 item 9) is ported, and a mesh refuses what the
    reference's refuses — the slot layout, and a ``serve(mesh=)`` other
    than the engine's (its sharded serving against the JAX engine is in
    tests/test_torch_sharded_serving.py); every family builds and serves
    (a MoE model here: its tokens against the JAX engine's are in
    tests/test_torch_families.py); speculation, chunked prefill,
    priorities and the online controller serve
    (tests/test_torch_speculative.py, tests/test_torch_controller.py and
    the chunked and preemption files hold them to the JAX engine)."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.serve import PinnedController

    cfg, _, _, tm, tp = pair
    assert not hasattr(engine_mod, "_NOT_PORTED") and not hasattr(engine_mod, "_refuse")
    mesh = _SeqMesh()
    sharded = ServingEngine(tm, tp, device="cpu", mesh=mesh, **KW)
    assert sharded.mesh is mesh
    with pytest.raises(ValueError, match="slotted layout has no head-partitioned storage"):
        sharded.scheduler(2, kv_layout="slot")
    with pytest.raises(ValueError, match="differs from the engine's mesh"):
        sharded.serve([], mesh=_SeqMesh())
    eng = ServingEngine(tm, tp, device="cpu", **KW)
    assert eng.scheduler(2, controller=PinnedController(0)).controller is not None
    out = eng.serve([Request(prompt=np.arange(4), max_new_tokens=2, priority=1)], chunk_size=4)
    assert [len(t) for t in out.values()] == [2]
    base = tget("smollm-135m").reduced()
    moe = TModel(tget("granite-moe-1b-a400m").reduced(), device="cpu")
    out = ServingEngine(moe, moe.init(0), max_seq=32, max_batch=2, device="cpu").serve(
        [Request(prompt=np.arange(5), max_new_tokens=3)])
    assert [len(t) for t in out.values()] == [3]
    # int8 KV serves on both layouts: the paged pool has the JAX pool's leaves
    jpool = JModel(dataclasses.replace(jget("smollm-135m").reduced(), kv_quant=True)).init_paged_cache(4, 8)
    tpool = TModel(dataclasses.replace(base, kv_quant=True), device="cpu").init_paged_cache(4, 8)
    assert sorted(tpool) == sorted(jpool) == ["k", "k_scale", "v", "v_scale"]
    for name, leaf in tpool.items():
        assert tuple(leaf.shape) == tuple(jpool[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(jpool[name].dtype), name


def test_no_silent_cpu_fallback(pair):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    _, _, _, tm, tp = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm, tp, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(tget("smollm-135m").reduced())


# ---------------------------------------------------------------------------
# the decode step as an Aira region, served through its plan


@pytest.fixture(scope="module")
def hybrid_pair():
    jcfg = jget("zamba2-2.7b").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("zamba2-2.7b").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def Workload_of(region):
    from repro_torch.core import Workload

    return Workload("serve", lambda: None, [region])


@pytest.mark.parametrize("arch,batch", [("smollm-135m", 3), ("smollm-135m", 4),
                                        ("zamba2-2.7b", 5)])
def test_decode_plan_serves_like_jax_plan_and_plain(pair, hybrid_pair, arch, batch):
    """decode_region + set_decode_plan: the port's plan path generates the
    JAX engine's plan-path tokens and its own no-plan tokens (an odd
    batch pads relic_pfor's last chunk); the static report agrees with the
    JAX one (the per-request decode writes its cache: not trivially
    parallel, cleared by the disjoint trace)."""
    from repro.core import Aira as JAira
    from repro.core import Workload as JWorkload
    from repro.core.overlap_model import CPU_HW as J_CPU_HW
    from repro_torch.core import CPU_HW, Aira

    cfg, jm, jp, tm, tp = pair if arch == "smollm-135m" else hybrid_pair
    prompts = np.random.default_rng(batch).integers(0, cfg.vocab_size, (batch, 8)).astype(np.int32)
    je = JEngine(jm, jp, max_seq=64)
    jd = JAira(hw=J_CPU_HW).advise(JWorkload("serve", lambda: None, [
        je.decode_region(jax.numpy.asarray(prompts), force=True)])).decisions[0]
    je.set_decode_plan(jd.plan)
    want = np.asarray(je.generate(jax.numpy.asarray(prompts), 5))
    te = ServingEngine(tm, tp, max_seq=64, device="cpu")
    d = Aira(hw=CPU_HW).advise(Workload_of(te.decode_region(prompts, force=True))).decisions[0]
    assert d.accepted and d.plan is not None
    assert (d.schedule.granularity, d.schedule.strategy) == (
        jd.schedule.granularity, jd.schedule.strategy)
    static = [s for s in d.stage_log if s.startswith("static:")][0]
    j_static = [s for s in jd.stage_log if s.startswith("static:")][0]
    assert static.endswith("parallel=needs-trace") and j_static.endswith("parallel=needs-trace")
    te.set_decode_plan(d.plan)
    got = te.generate(prompts, 5).numpy()
    plain = ServingEngine(tm, tp, max_seq=64, device="cpu").generate(prompts, 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_masked_plan_decode_matches_plain_partial_batch(pair):
    """Requests arriving apart through a 4-row pool: the plan decodes the
    whole pool, dead rows masked, token for token like the plain path."""
    from repro_torch.core import CPU_HW, Aira

    cfg, _, _, tm, tp = pair
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    d = Aira(hw=CPU_HW).advise(Workload_of(eng.decode_region(prompts, force=True, seed=3)))
    d = d.decisions[0]

    def staggered():
        return [Request(prompt=prompts[i], max_new_tokens=3 + i, arrival_time=0.01 * i)
                for i in range(2)]

    plain_reqs, plan_reqs = staggered(), staggered()
    plain = ServingEngine(tm, tp, max_seq=64, device="cpu").serve(plain_reqs, max_batch=4)
    planned = ServingEngine(tm, tp, max_seq=64, device="cpu", decode_plan=d.plan).serve(
        plan_reqs, max_batch=4)
    for rp, rq in zip(plain_reqs, plan_reqs):
        np.testing.assert_array_equal(plain[rp.rid], planned[rq.rid])


def test_decode_plan_refusals(pair):
    """A plan must keep request order (stack), routes through the slot
    layout only, and binds the backend it was advised under."""
    from repro_torch.core import CPU_HW, Aira, plan_for

    cfg, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    bad = plan_for("bad-sum", lambda x: x, torch.arange(4.0), granularity=1, combine="sum")
    with pytest.raises(ValueError, match="stack"):
        eng.set_decode_plan(bad)
    with pytest.raises(ValueError, match="stack"):
        eng.scheduler(2).set_decode_plan(bad)
    prompts = np.ones((2, 8), np.int32)
    d = Aira(hw=CPU_HW).advise(Workload_of(eng.decode_region(prompts, force=True))).decisions[0]
    eng.set_decode_plan(d.plan)
    with pytest.raises(ValueError, match="slotted layout"):
        eng.scheduler(2, kv_layout="paged")
    paged = ServingEngine(tm, tp, max_seq=64, device="cpu").scheduler(2, kv_layout="paged")
    with pytest.raises(ValueError, match="paged layout"):
        paged.set_decode_plan(d.plan)
    with pytest.raises(ValueError, match="cannot override"):
        eng.serve([], attention_backend="kernel")


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_paged_operator_vmap_rule_gives_the_plain_result(int8):
    """The paged kernel as ``repro_torch::paged_decode_attention`` under
    two levels of vmap (relic_pfor's streams and items) on CPU tensors:
    mapped pools fold into one call with the tables moved item by item,
    unmapped pools stay; each item's result equals the plain version's
    on that item alone, exactly; under make_fx the operator is one node."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import paged_decode_attention as pda

    op = torch.ops.repro_torch.paged_decode_attention
    rng = np.random.default_rng(11)
    S, G, B, T, H, KV, hd, NB, BS, MB = 2, 3, 2, 1, 4, 2, 16, 9, 8, 4
    q = torch.from_numpy(rng.normal(size=(S, G, B, T, H, hd)).astype(np.float32))
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, (S, G, NB, BS, KV, hd)).astype(np.int8))
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.5, 2, (S, G, NB, BS, KV)).astype(np.float32)
                                   ).to(torch.bfloat16) for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.normal(size=(S, G, NB, BS, KV, hd)).astype(np.float32))
                  for _ in range(2))
        ks = vs = None
    tables = torch.from_numpy(rng.integers(0, NB, (B, MB)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(0, MB * BS - T, (S, G, B)).astype(np.int32))
    sd = None if ks is None else 0
    inner = torch.func.vmap(op, in_dims=(0, 0, 0, None, 0, sd, sd))
    got = torch.func.vmap(inner, in_dims=(0, 0, 0, None, 0, sd, sd))(q, kp, vp, tables, lens, ks, vs)
    for i in range(S):
        for j in range(G):
            sc = (None, None) if ks is None else (ks[i, j], vs[i, j])
            want = pda.plain_paged_decode_attention(q[i, j], kp[i, j], vp[i, j], tables, lens[i, j],
                                                    *sc)
            assert torch.equal(got[i, j], want)
    shared = torch.func.vmap(op, in_dims=(0, None, None, None, 0, None, None))(
        q[0], kp[0, 0], vp[0, 0], tables, lens[0], *((None, None) if ks is None else
                                                    (ks[0, 0], vs[0, 0])))
    for j in range(G):
        sc = (None, None) if ks is None else (ks[0, 0], vs[0, 0])
        want = pda.plain_paged_decode_attention(q[0, j], kp[0, 0], vp[0, 0], tables, lens[0, j], *sc)
        assert torch.equal(shared[j], want)
    args = (q[0, 0], kp[0, 0], vp[0, 0], tables, lens[0, 0]) + (
        () if ks is None else (ks[0, 0], vs[0, 0]))
    gm = make_fx(lambda *a: op(*a), tracing_mode="real")(*args)
    calls = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert calls == [torch.ops.repro_torch.paged_decode_attention.default]


def test_paged_decode_call_takes_the_operator_only_under_a_transform(monkeypatch):
    """The models' call (``paged_decode_call``) goes straight to the
    wrapper in eager code and through the operator under vmap and make_fx;
    each path gives the plain version's result exactly."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import paged_decode_attention as pda

    rng = np.random.default_rng(12)
    G, B, T, H, KV, hd, NB, BS, MB = 3, 2, 1, 4, 2, 16, 9, 8, 4
    q = torch.from_numpy(rng.normal(size=(G, B, T, H, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(NB, BS, KV, hd)).astype(np.float32))
              for _ in range(2))
    tables = torch.from_numpy(rng.integers(0, NB, (B, MB)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(0, MB * BS - T, (G, B)).astype(np.int32))
    through_op = []
    op = pda.paged_attention_op
    monkeypatch.setattr(pda, "paged_attention_op", lambda *a: through_op.append(1) or op(*a))
    got = pda.paged_decode_call(q[0], kp, vp, tables, lens[0])
    assert through_op == []
    assert torch.equal(got, pda.plain_paged_decode_attention(q[0], kp, vp, tables, lens[0]))
    mapped = torch.func.vmap(pda.paged_decode_call, in_dims=(0, None, None, None, 0))(
        q, kp, vp, tables, lens)
    assert through_op == [1]
    for j in range(G):
        assert torch.equal(mapped[j],
                           pda.plain_paged_decode_attention(q[j], kp, vp, tables, lens[j]))
    gm = make_fx(lambda *a: pda.paged_decode_call(*a), tracing_mode="real")(
        q[0], kp, vp, tables, lens[0])
    assert through_op == [1, 1]
    calls = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert calls == [torch.ops.repro_torch.paged_decode_attention.default]
