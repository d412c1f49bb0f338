"""The MoE, vlm and audio families against the JAX package on the CPU,
float32 at ``.reduced()`` size with JAX parameters carried over
(``granite-moe-1b-a400m`` and ``dbrx-132b``: moe; ``internvl2-2b``: vlm;
``musicgen-large``: audio with an int8 KV pool): the four configs field
for field and the registry; ``moe_block``'s routing, dispatch and combine
against ``_moe_reference`` on the same inputs (expert indices and
kept/dropped slots bitwise, gates, outputs and the aux loss within 1e-5),
with and without drops; the reference's model tests mirrored on the port;
the VLM prefill with patch embeddings (logits within 1e-4, ``len`` equal);
serving token-identical to the JAX engine on every layout and feature the
reference gives each family, with the same ``engine.retraces``; and the
guards that keep MoE and VLM prompts out of the prefix cache, speculation
and chunking, as the reference's. Workloads run on a step clock
(``drive``), so that admission does not depend on either package's
speed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve import Telemetry as JTelemetry
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine, SpecConfig, Telemetry

ATOL = 1e-4  # float32 logits, JAX against the port
MOE_ATOL = 1e-5  # float32 gates, expert outputs and aux loss of one MoE layer

NEW_ARCHS = ["granite-moe-1b-a400m", "dbrx-132b", "internvl2-2b", "musicgen-large"]


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(dataclasses.replace(tget(arch).reduced(), **over), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-moe-1b-a400m at capacity factor 0.5: E = 4, k = 2,
    so an 8-row decode has 4 slots an expert for 16 assignments and drops."""
    return _pair("granite-moe-1b-a400m", capacity_factor=0.5)


@pytest.fixture(scope="module")
def vlm():
    return _pair("internvl2-2b")


@pytest.fixture(scope="module")
def audio():
    return _pair("musicgen-large")


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=atol)


def drive(sched, reqs, dt=0.005):
    """Run ``reqs`` to completion on a step clock (step i at i * dt)."""
    clock = [0.0]
    sched._clock = lambda: clock[0]
    sched.stats.reset()
    for r in reqs:
        sched.submit(r)
    i = 0
    while sched._queue or sched._active or sched._chunking:
        clock[0] = i * dt
        sched.step(now=clock[0])
        i += 1
    return [r.output() for r in reqs]


def assert_same(a, b, label=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{label} stream #{i} diverged")


def _patches(cfg, i):
    return np.random.default_rng(500 + i).standard_normal(
        (cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _workload(R, cfg, lens=(13, 5, 29, 8, 17), tokens=(6, 3, 9, 2, 5), header=0,
              patches=False, arrival=0.005):
    """Staggered arrivals (``arrival`` apart) and finishes; ``header`` > 0
    starts every prompt with the same ``header`` tokens; ``patches`` gives
    each request seeded patch embeddings."""
    head = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(header,))
    out = []
    for i, (s0, n) in enumerate(zip(lens, tokens)):
        tail = np.random.default_rng(100 + i).integers(0, cfg.vocab_size, size=(s0,))
        out.append(R(prompt=np.concatenate([head, tail]).astype(np.int32), max_new_tokens=n,
                     arrival_time=arrival * i, patch_embeds=_patches(cfg, i) if patches else None))
    return out


def _pressure(R):
    """Two long low-priority requests admitted first, then a high-priority
    arrival that needs their row (as ``tests/test_torch_preemption.py``)."""
    low = [R(prompt=np.arange(20, dtype=np.int32) + i, max_new_tokens=10, arrival_time=0.0,
             priority=0) for i in range(2)]
    return low + [R(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, arrival_time=0.02,
                    priority=5)]


def _serve_both(pair, rows, workload, **kw):
    """The same workload through the JAX engine and the port's, each on a
    step clock; ``spec``: a K for both packages' n-gram SpecConfig."""
    _, jm, jp, tm, tp = pair
    k = kw.pop("spec", None)
    sched_kw = {key: kw.pop(key) for key in ("chunk_size",) if key in kw}
    je, te = JEngine(jm, jp, **kw), ServingEngine(tm, tp, device="cpu", **kw)
    js = je.scheduler(rows, spec=JSpec(k=k) if k else None, **sched_kw)
    ts = te.scheduler(rows, spec=SpecConfig(k=k) if k else None, **sched_kw)
    jreqs, treqs = workload(JRequest), workload(Request)
    return drive(js, jreqs), drive(ts, treqs), js, ts, jreqs, treqs


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_jax(arch):
    """Each copied config equals the JAX package's field for field, full
    size and ``.reduced()``; ``Model`` builds for it (no family refusal)."""
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(tget(arch).reduced()) == dataclasses.asdict(jget(arch).reduced())
    assert TModel(tget(arch).reduced(), device="cpu").cfg.family == jget(arch).family


def test_all_archs_match_jax():
    """``ALL_ARCHS`` is the reference's registry, and every architecture in
    it builds a port model."""
    assert ALL_ARCHS == J_ALL_ARCHS and len(ALL_ARCHS) == 10
    assert {tget(a).family for a in ALL_ARCHS} == {"dense", "moe", "vlm", "audio", "ssm", "hybrid"}
    for arch in ALL_ARCHS:
        TModel(tget(arch), device="cpu")


# ---------------------------------------------------------------------------
# the MoE layer against the reference's


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25], ids=["drops", "drop-free"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_block_matches_reference(arch, capacity_factor):
    """``moe_block`` against the JAX ``_moe_reference`` on the same numpy
    inputs and parameters: the top-k expert indices and every assignment's
    slot (kept rank or dropped) bitwise, gates, the layer's output and the
    aux loss within 1e-5 (the port's aux from ``switch_aux``; ``moe_mlp``,
    serving's aux-free call, bitwise ``moe_block``'s output). At capacity
    factor 0.5 assignments drop (asserted), at 1.25 none do."""
    jcfg = dataclasses.replace(jget(arch).reduced(), capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tget(arch).reduced(), capacity_factor=capacity_factor)
    jp, _ = jmoe.init_moe(jax.random.key(1), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jax.tree.map(np.asarray, jp).items()}
    x = np.random.default_rng(0).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    x2d, tx2d = jnp.asarray(x.reshape(24, -1)), torch.from_numpy(x.reshape(24, -1))
    gates, idx, aux = jmoe._route(x2d, jp["router"], jcfg.top_k)
    tgates, tidx, tprobs = tmoe._route(tx2d, tp["router"], tcfg.top_k)
    taux = tmoe.switch_aux(tprobs, tidx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    close(tgates, gates, MOE_ATOL)
    close(taux, aux, MOE_ATOL)
    C = jmoe.moe_capacity(24, jcfg)
    assert tmoe.moe_capacity(24, tcfg) == C
    _, lin, _ = jmoe._dispatch_local(x2d, gates, idx, jcfg.n_experts, C)
    _, tlin, _ = tmoe._dispatch_local(tx2d, tgates, tidx, tcfg.n_experts, C)
    np.testing.assert_array_equal(tlin.numpy(), np.asarray(lin))
    dropped = int((tlin == tcfg.n_experts * C).sum())
    assert (dropped > 0) == (capacity_factor < 1)
    y, aux = jmoe.moe_block(jnp.asarray(x), jp, jcfg)
    ty, taux = tmoe.moe_block(torch.from_numpy(x), tp, tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    close(ty, y, MOE_ATOL)
    close(taux, aux, MOE_ATOL)
    assert torch.equal(tmoe.moe_mlp(torch.from_numpy(x), tp, tcfg), ty)


def test_decode_matches_prefill_moe():
    """``tests/test_models.py::test_decode_matches_prefill[granite-moe-1b-a400m]``
    on the port: in the drop-free regime (capacity factor E / k), a decode
    step after a prefill of S-1 tokens equals the full forward's last
    logits, with the reference's tolerance (2e-2)."""
    cfg = tget("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    m = TModel(cfg, device="cpu")
    params = m.init(seed=1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    x, _ = m.forward(params, toks)
    want = x[:, -1] @ params["embed"].T
    _, cache = m.prefill(params, toks[:, :-1], 32)
    got, _ = m.decode_step(params, cache, toks[:, -1:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2, rtol=2e-2)


def test_moe_reference_routing_properties():
    """``tests/test_models.py::test_moe_reference_routing_properties`` on
    the port: the output keeps the input's shape, is finite, and the
    load-balance loss is positive."""
    cfg = tget("granite-moe-1b-a400m").reduced()
    params = tmoe.init_moe(cfg, torch.float32, torch.Generator().manual_seed(0))
    assert params["router"].dtype == torch.float32
    x = torch.randn((64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y, aux = tmoe._moe_reference(x, params, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_and_vlm_leaves(dtype):
    """``Model.init`` gives a moe model ``moe`` leaves in place of ``mlp``
    (the router float32 in every dtype) and a vlm model ``patch_proj``, in
    the JAX package's shapes; ``params_from_reference`` keeps the router
    float32 too."""
    for arch in ("granite-moe-1b-a400m", "internvl2-2b"):
        cfg = dataclasses.replace(tget(arch).reduced(), dtype=dtype)
        jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype)
        tparams = TModel(cfg, device="cpu").init(seed=0)
        jparams = JModel(jcfg).abstract_params()[0]
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype)) for p, a in jleaves}
        got = {}

        def walk(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{path}['{k}']")
                else:
                    got[f"{path}['{k}']"] = (tuple(v.shape), str(v.dtype).split(".")[-1])

        walk(tparams)
        assert got == want
        carried = TModel(cfg, device="cpu").params_from_reference(
            jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams))
        if cfg.family == "moe":
            assert carried["layers"]["moe"]["router"].dtype == torch.float32
            assert carried["layers"]["moe"]["we1"].dtype == getattr(torch, dtype)


# ---------------------------------------------------------------------------
# the VLM prefill


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "prompt_len"])
def test_vlm_prefill_matches_jax(vlm, padded):
    """``prefill`` with patch embeddings [B, P, D]: the patch rows are
    projected and lead the tokens; with ``prompt_len`` (tokens right-padded)
    they offset the logits index and ``len``. Logits within 1e-4, ``len``
    equal, the cache's patch and token rows within 1e-4."""
    cfg, jm, jp, tm, tp = vlm
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    pe = np.stack([_patches(cfg, i) for i in range(2)])
    kw, tkw = {}, {}
    if padded:
        toks[1, 5:] = 0
        kw["prompt_len"], tkw["prompt_len"] = jnp.asarray([8, 5]), torch.tensor([8, 5])
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 32, patch_embeds=jnp.asarray(pe), **kw)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), 32, patch_embeds=torch.from_numpy(pe), **tkw)
    close(tl, jl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == ([12, 9] if padded else [12, 12])
    close(tc["k"][:, :, :12], np.asarray(jc["k"])[:, :, :12])
    with pytest.raises(ValueError, match="patch_embeds"):
        tm.prefill(tp, torch.from_numpy(toks), 32)


# ---------------------------------------------------------------------------
# serving, token-identical to the JAX engine


# twelve requests on 16 rows, all arriving at once: the first eight (rows
# 0-7) finish after 2-3 tokens, the last four (rows 8-11) decode on behind
# eight dead rows; three prompt lengths (same-length prompts prefill as
# one call on the slot layout, their capacity that of all their tokens)
MOE_LENS = (13, 5, 21, 13, 5, 21, 13, 5, 21, 13, 5, 21)
MOE_TOKENS = (2, 3, 2, 3, 2, 3, 2, 3, 10, 9, 10, 8)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_moe_serving_matches_jax(granite, layout):
    """Reduced granite (capacity factor 0.5: decode and prefill drop
    assignments) on 16 rows: twelve requests, the first eight finishing
    early, so the last four decode behind eight dead rows. A dead row
    routes beside the live ones and takes capacity ahead of them, so what
    it holds (its pending token, and what it attends over: its stale slot,
    or on the paged layout its own token alone) must be the JAX engine's.
    Streams token-identical; no prefix hits."""
    want, got, _, _, _, treqs = _serve_both(
        granite, 16, lambda R: _workload(R, granite[0], MOE_LENS, MOE_TOKENS, header=8,
                                           arrival=0.0),
        max_seq=64, kv_layout=layout, block_size=8)
    assert_same(want, got, f"granite {layout}")
    assert all(r.prefix_hit == 0 for r in treqs)


def test_dbrx_paged_serving_matches_jax():
    """Reduced dbrx-132b (16 experts → 4, top 2, an untied head) on the
    paged layout: streams token-identical to the JAX engine."""
    pair = _pair("dbrx-132b")
    want, got, *_ = _serve_both(pair, 4, lambda R: _workload(R, pair[0]), max_seq=64,
                                kv_layout="paged", block_size=8)
    assert_same(want, got, "dbrx paged")


@pytest.mark.parametrize("spec", [None, 4], ids=["plain", "K4"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_vlm_serving_matches_jax(vlm, layout, spec):
    """Reduced internvl2-2b with seeded patch embeddings on both layouts,
    plain and with K = 4 n-gram speculation: the patch rows count in each
    request's row budget and cache length, prompts group by (bucket, patch
    shape), and no prefix matching happens. Streams token-identical."""
    want, got, js, ts, _, treqs = _serve_both(
        vlm, 4, lambda R: _workload(R, vlm[0], header=8, patches=True), max_seq=64,
        kv_layout=layout, block_size=8, spec=spec)
    assert_same(want, got, f"internvl2 {layout} K={spec}")
    assert all(r.prefix_hit == 0 for r in treqs)
    assert js.stats.serving_summary()["n_requests"] == ts.stats.serving_summary()["n_requests"]


@pytest.mark.parametrize("mode", ["prefix", "chunk8+K4", "preempt"])
def test_audio_int8_paged_serving_matches_jax(audio, mode):
    """Reduced musicgen-large (audio, ``kv_quant``: the int8 pool) on the
    paged layout with the dense family's features: a prefix hit (asserted),
    8-token chunks with K = 4 speculation, and a preempting run (asserted).
    Streams, prefix hits and preemptions equal the JAX engine's."""
    cfg = audio[0]
    if mode == "preempt":
        want, got, js, ts, jreqs, treqs = _serve_both(
            audio, 2, _pressure, max_seq=128, kv_layout="paged", block_size=8, num_blocks=10)
        assert ts.stats.n_preemptions == js.stats.n_preemptions > 0
    else:
        kw = {"spec": 4, "chunk_size": 8} if mode == "chunk8+K4" else {}
        want, got, js, ts, jreqs, treqs = _serve_both(
            audio, 4, lambda R: _workload(R, cfg, header=16), max_seq=64, kv_layout="paged",
            block_size=8, **kw)
        assert any(r.prefix_hit > 0 for r in treqs)
    assert_same(want, got, f"musicgen {mode}")
    assert [r.prefix_hit for r in treqs] == [r.prefix_hit for r in jreqs]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_retraces_match_jax(arch, granite, vlm):
    """A fresh engine, telemetry on: the first run compiles every step
    shape it meets (moe: one prefill per prompt length, no bucketing; vlm:
    buckets with the patch shape in the key) and counts each as a retrace,
    as the JAX engine does; the same run again counts none."""
    cfg, jm, jp, tm, tp = granite if arch.startswith("granite") else vlm
    patches = cfg.family == "vlm"
    kw = dict(max_seq=64, kv_layout="paged", block_size=8)
    je, te = JEngine(jm, jp, **kw), ServingEngine(tm, tp, device="cpu", **kw)
    counts = []
    for _ in range(2):
        js = je.scheduler(4, telemetry=JTelemetry(enabled=True))
        ts = te.scheduler(4, telemetry=Telemetry(enabled=True))
        assert_same(drive(js, _workload(JRequest, cfg, patches=patches)),
                    drive(ts, _workload(Request, cfg, patches=patches)))
        counts.append((je.stats.registry.counter("engine.retraces").value,
                       te.stats.registry.counter("engine.retraces").value))
    (j1, t1), second = counts
    assert j1 == t1 > 0
    assert second == (0.0, 0.0)


def test_moe_decode_plan_matches_jax(granite):
    """A decode plan advised over a MoE engine's ``decode_region()`` (each
    request's decode a work item of ``relic_pfor``, the MoE layer under
    vmap: its dispatch writes out of place) serves the JAX engine's
    plan-path tokens."""
    from repro.core import Aira as JAira
    from repro.core import Workload as JWorkload
    from repro.core.overlap_model import CPU_HW as J_CPU_HW
    from repro_torch.core import CPU_HW, Aira, Workload

    cfg, jm, jp, tm, tp = granite
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    je = JEngine(jm, jp, max_seq=64)
    jd = JAira(hw=J_CPU_HW).advise(JWorkload("serve", lambda: None, [
        je.decode_region(jnp.asarray(prompts), force=True)])).decisions[0]
    je.set_decode_plan(jd.plan)
    te = ServingEngine(tm, tp, max_seq=64, device="cpu")
    d = Aira(hw=CPU_HW).advise(Workload("serve", lambda: None, [
        te.decode_region(prompts, force=True)])).decisions[0]
    assert d.accepted and d.plan is not None
    te.set_decode_plan(d.plan)
    np.testing.assert_array_equal(te.generate(prompts, 5).numpy(),
                                  np.asarray(je.generate(jnp.asarray(prompts), 5)))


def test_vlm_patch_embeds_are_step_inputs(vlm):
    """A compiled prefill takes ``patch_embeds`` as an input (its shape in
    the key, its values copied in), not as bound state: new values of one
    shape make no new entry, and the result is the eager call's."""
    cfg, _, _, tm, tp = vlm
    fn = tm.jit_step("prefill")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    for i in range(3):
        pe = torch.from_numpy(_patches(cfg, i))[None]
        got, _ = fn(tp, toks, 32, patch_embeds=pe)
        want, _ = tm.prefill(tp, toks, 32, patch_embeds=pe)
        assert torch.equal(got, want)
    assert fn._cache_size() == 1
    fn(tp, toks, 32, patch_embeds=torch.from_numpy(_patches(cfg, 0)[:2])[None])
    assert fn._cache_size() == 2


def test_generate_with_patch_embeds(vlm):
    """``generate(..., patch_embeds=)`` gives row i's patches to request i,
    as the JAX engine's does: the same tokens."""
    cfg, jm, jp, tm, tp = vlm
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    pe = np.stack([_patches(cfg, i) for i in range(3)])
    want = JEngine(jm, jp, max_seq=32).generate(jnp.asarray(prompts), 4,
                                                patch_embeds=jnp.asarray(pe))
    got = ServingEngine(tm, tp, max_seq=32, device="cpu").generate(prompts, 4, patch_embeds=pe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the guards: prefix cache, speculation, chunking


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b"])
def test_prefix_cache_refused_for_moe_and_vlm(arch):
    """A paged moe or vlm scheduler built with ``prefix_cache=True`` has no
    prefix cache (a MoE suffix routes with another capacity than its cold
    prompt; patch rows are not token-addressable), as the reference's; and
    ``prefill_with_prefix`` raises the reference's ``ValueError``
    (``tests/test_paged_cache.py::test_prefill_with_prefix_rejects_token_divergent_families``)."""
    m = TModel(tget(arch).reduced(), device="cpu")
    eng = ServingEngine(m, m.init(0), max_seq=32, kv_layout="paged", block_size=8,
                        prefix_cache=True, device="cpu")
    assert eng.scheduler(2).kv.prefix is None
    with pytest.raises(ValueError, match="token-identical"):
        m.prefill_with_prefix(None, None, None, None, 16)
    dense = TModel(tget("musicgen-large").reduced(), device="cpu")
    eng = ServingEngine(dense, dense.init(0), max_seq=32, kv_layout="paged", block_size=8,
                        device="cpu")
    assert eng.scheduler(2).kv.prefix is not None


def test_moe_does_not_speculate():
    """``tests/test_speculative.py::test_verify_step_rejects_unrewindable_families``
    on the port: a MoE model refuses ``verify_step``, and its engine refuses
    speculation and chunking; ``prime()`` clamps its depths to 0."""
    moe = TModel(tget("granite-moe-1b-a400m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="greedy-equivalent"):
        moe.verify_step(None, None, None)
    eng = ServingEngine(moe, moe.init(0), max_seq=32, kv_layout="paged", block_size=8,
                        device="cpu")
    with pytest.raises(ValueError, match="speculative decode"):
        eng.scheduler(2, spec=SpecConfig(k=2))
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.scheduler(2, chunk_size=8)
    assert eng.prime(2, ks=(0, 2))["ks"] == (0,)


def test_chunked_rejects_patch_embeds(audio):
    """``tests/test_chunked_prefill.py::test_chunked_rejects_patch_embeds``
    on the port: patch embeddings ride the monolithic path only, so a
    chunked scheduler refuses (and counts) a request carrying them."""
    cfg, _, _, tm, tp = audio
    eng = ServingEngine(tm, tp, max_seq=64, max_batch=2, device="cpu")
    sched = eng.scheduler(2, chunk_size=8)
    with pytest.raises(ValueError, match="chunk"):
        sched.submit(Request(prompt=np.arange(4), max_new_tokens=2,
                             patch_embeds=np.zeros((2, cfg.d_model), np.float32)))
    assert eng.stats.rejected_submissions == 1


def test_vlm_row_budget_counts_patches(vlm):
    """``submit`` counts a request's patch rows in its row budget, as the
    reference's does: a prompt that fits alone overflows with them."""
    cfg, _, _, tm, tp = vlm
    sched = ServingEngine(tm, tp, max_seq=16, device="cpu").scheduler(2)
    sched.submit(Request(prompt=np.arange(8), max_new_tokens=4))  # 12 rows
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(Request(prompt=np.arange(8), max_new_tokens=5,
                             patch_embeds=_patches(cfg, 0)))  # 4 + 8 + 5 = 17 rows


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_moe_paged_decode_dead_rows_match_jax(granite, backend, monkeypatch):
    """A paged MoE decode over 16 rows of which 12 are dead (length 0, all
    null block): on both of the port's backends every row's logits, dead
    ones included, are the JAX reference route's, where each dead row
    attends only its own token in a private view. Over the pool the dead
    rows' writes collide in the null block; a MoE layer routes their tokens
    beside the live ones, so the collision must not reach them."""
    cfg, jm, jp, tm, tp = granite
    if backend == "kernel":
        monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    NB, BS, MB, B = 20, 8, 8, 16
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, NB + 1, BS, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    tables = np.full((B, MB), NB, np.int32)
    lens = np.zeros(B, np.int32)
    for r in range(8, 12):  # the live rows sit behind eight dead ones
        tables[r, :2] = [2 * (r - 8), 2 * (r - 8) + 1]
        lens[r] = 10
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, _ = jm.decode_step_paged(jp, {n: jnp.asarray(a) for n, a in pool.items()},
                                 jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(tok),
                                 backend="reference")
    tl, _ = tm.decode_step_paged(tp, {n: torch.from_numpy(a.copy()) for n, a in pool.items()},
                                 torch.from_numpy(tables), torch.from_numpy(lens),
                                 torch.from_numpy(tok), backend=backend)
    close(tl, jl)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dead_rows_own_view_is_plain_attention(dtype, T, quant):
    """``_dead_rows_own_view``: a dead row (length 0) gets the plain
    attention over its own T new tokens (dequantized from the int8 codes
    it is given), bitwise; at T = 1 that is its value taken straight,
    without the attention. A live row keeps what it had."""
    g = torch.Generator().manual_seed(T)
    B, H, KV, hd = 4, 8, 2, 16
    q, out = (torch.randn((B, T, H, hd), generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, T, KV, hd), generator=g).to(dtype) for _ in range(2))
    lens = torch.tensor([0, 5, 0, 9], dtype=torch.int32)
    codes = tattn.quantize_kv(k) + tattn.quantize_kv(v) if quant else None
    got = tattn._dead_rows_own_view(out, q, k, v, lens, codes)
    if quant:
        k = tattn.dequantize_kv(codes[0], codes[1], dtype)
        v = tattn.dequantize_kv(codes[2], codes[3], dtype)
    own = tattn.gqa_attention(q, k, v, backend="reference")
    assert got.dtype == dtype
    assert torch.equal(got[[0, 2]], own[[0, 2]])
    assert torch.equal(got[[1, 3]], out[[1, 3]])
