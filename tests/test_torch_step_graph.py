"""The port's compiled step families against the JAX package's jitted ones
on the CPU, float32, reduced configs (JAX parameters carried over).

``Model.jit_step`` stands where the reference's ``jax.jit`` stands
(``models/step_graph.py``: a CUDA graph a key on the card, the record of
the key on the CPU), so ``_cache_size()`` and ``engine.retraces`` mean
here what they mean in JAX: a chunk keeps one entry across its positions,
a bucketed prefill one a pow2 bucket; after ``prime()`` live switching of
K and backend compiles nothing; an unprimed run counts the JAX engine's
retraces; two serves reuse the engine's state storage; a step's first
call runs once (the SSM and hybrid states advance once);
``step_graph.disabled()`` serves the same streams; and a decode plan's
pool step keeps one family a (plan key, pool size), as the JAX engine's
jitted plan steps, writing the slot cache in place. Serves run on a step
clock (``drive``), so admission does not depend on either package's
speed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models.model import prefill_bucket as j_bucket
from repro.serve import Decision as JDecision
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve.telemetry import Telemetry as JTelemetry
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import step_graph
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import prefill_bucket
from repro_torch.serve import Decision, Request, ServingEngine, SpecConfig, Telemetry

ATOL = 1e-4


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(dataclasses.replace(tget(arch).reduced(), **over), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair("smollm-135m")


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


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


def _workload(R, vocab, lens=(13, 5, 29, 8, 17), tokens=6, arrival=0.005):
    return [R(prompt=np.random.default_rng(100 + i).integers(0, vocab, size=(s,)).astype(np.int32),
              max_new_tokens=tokens, arrival_time=arrival * i) for i, s in enumerate(lens)]


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"stream #{i}")


def _families(eng) -> list:
    """Every compiled step the engine holds (its families and draft steps)."""
    fns = [f for fam in eng._steps.values() for f in fam.values()]
    return fns + [f for fam in eng._drafts.values() for f in fam.values()]


def _jax_families(eng) -> list:
    fns = [eng._prefill, eng._prefill_prefix]
    return fns + [f for fam in eng._steps.values() for f in fam.values()]


# ---------------------------------------------------------------------------
# (a) one entry per shape: chunk positions and pow2 buckets are data


def test_prefill_chunk_keeps_one_entry_across_positions(pair):
    """Five 8-wide chunks at five offsets of a 40-token prompt: one entry
    in both packages, the same logits (within 1e-4) and lengths."""
    cfg, jm, jp, tm, tp = pair
    jfn, tfn = jm.jit_step("prefill_chunk", "reference"), tm.jit_step("prefill_chunk")
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(40,))
    pos = 0
    while pos < len(prompt):
        n = min(8, len(prompt) - pos)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[pos : pos + n]
        jlog, jc = jfn(jp, jc, jnp.asarray(toks), jnp.asarray([n], jnp.int32))
        tlog, tc = tfn(tp, tc, torch.from_numpy(toks), [n])
        close(tlog[:, :n], np.asarray(jlog)[:, :n])
        pos += n
    assert jfn._cache_size() == tfn._cache_size() == 1
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [len(prompt)]


def test_bucketed_prefill_keeps_one_entry_a_bucket(pair):
    """Prompt lengths 9-16 share the W = 16 entry; W = 32 adds one, as the
    JAX jit's trace cache does."""
    cfg, jm, jp, tm, tp = pair
    jfn = jax.jit(lambda p, toks, n: jm.prefill(p, toks, 64, prompt_len=n))
    tfn = tm.jit_step("prefill")
    for s0 in (9, 11, 14, 16):
        W = prefill_bucket(s0)
        assert W == j_bucket(s0) == 16
        toks = np.zeros((1, W), np.int32)
        toks[0, :s0] = np.arange(s0) % cfg.vocab_size
        jlog, jcache = jfn(jp, jnp.asarray(toks), jnp.asarray([s0], jnp.int32))
        tlog, tcache = tfn(tp, torch.from_numpy(toks), 64, prompt_len=np.asarray([s0], np.int32))
        close(tlog, jlog)
        assert int(tcache["len"][0]) == int(jcache["len"][0]) == s0
    assert jfn._cache_size() == tfn._cache_size() == 1
    jfn(jp, jnp.zeros((1, 32), jnp.int32), jnp.asarray([20], jnp.int32))
    tfn(tp, torch.zeros((1, 32), dtype=torch.int32), 64, prompt_len=[20])
    assert jfn._cache_size() == tfn._cache_size() == 2


def test_jit_step_binds_its_backend_and_checks_the_step(pair):
    _, _, _, tm, _ = pair
    fn = tm.jit_step("decode_step")
    assert (fn.name, fn.backend, fn._cache_size()) == ("decode_step", "reference", 0)
    assert tm.jit_step("decode_step") is not fn  # a new entry table, as each jax.jit
    with pytest.raises(ValueError, match="unknown step"):
        tm.jit_step("loss")


# ---------------------------------------------------------------------------
# (b) after prime(): live switching of K and backend compiles nothing


class Scripted:
    """A controller replaying (k, backend) decisions, one a decision."""

    def __init__(self, make, script, backends):
        self.make, self.script, self.ks, self.backends = make, list(script), (0, 2, 4), backends
        self.decision_interval, self.window, self.initial_k = 2, 8, 0
        self.decisions, self.n_switches, self.dwell_remaining = [], 0, 0

    def decide(self, summary, *, k_live, backend_live, step):
        k, backend = self.script[len(self.decisions) % len(self.script)]
        d = self.make(step=step, k=k, backend=backend, switched=k != k_live, reason="scripted")
        self.n_switches += int(d.switched)
        self.decisions.append(d)
        return d


@pytest.fixture(scope="module")
def primed(pair):
    """Both packages' paged engines primed over ks (0, 2, 4) and two
    backends each: JAX's reference and Pallas interpret mode, the port's
    reference and kernel (whose wrappers run their plain versions on CPU
    tensors once the kernel backend's CUDA check is lifted)."""
    cfg, jm, jp, tm, tp = pair
    kw = dict(max_seq=64, kv_layout="paged", block_size=8)
    je = JEngine(jm, jp, **kw)
    je.prime(2, ks=(0, 2, 4), backends=("reference", "interpret"))
    te = ServingEngine(tm, tp, device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "require_cuda", lambda t, what: None)
        te.prime(2, ks=(0, 2, 4), backends=("reference", "kernel"))
    return je, te


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primed_switching_compiles_nothing(pair, primed, seed, monkeypatch):
    """A random script over K ∈ {0, 2, 4} and both backends serves the
    static run's streams in both packages, with ``engine.retraces`` 0 and
    every family's compile count unchanged."""
    cfg, _, _, _, _ = pair
    je, te = primed
    monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    rng = np.random.default_rng(seed)
    picks = [(int(rng.choice([0, 2, 4])), int(rng.integers(2))) for _ in range(8)]
    jscript = [(k, ("reference", "interpret")[b]) for k, b in picks]
    tscript = [(k, ("reference", "kernel")[b]) for k, b in picks]
    lens = (8, 12, 8, 16)

    def work(R):
        return _workload(R, cfg.vocab_size, lens, arrival=0.0)

    jbase = drive(je.scheduler(2, spec=JSpec(k=4)), work(JRequest))
    tbase = drive(te.scheduler(2, spec=SpecConfig(k=4)), work(Request))
    jsize0, tsize0 = step_graph.cache_size(_jax_families(je)), step_graph.cache_size(_families(te))
    jctl = Scripted(JDecision, jscript, ("reference", "interpret"))
    tctl = Scripted(Decision, tscript, ("reference", "kernel"))
    jout = drive(je.scheduler(2, spec=JSpec(k=4), controller=jctl), work(JRequest))
    tout = drive(te.scheduler(2, spec=SpecConfig(k=4), controller=tctl), work(Request))
    _same(jbase, tbase)
    _same(jout, jbase)
    _same(tout, tbase)
    assert step_graph.cache_size(_jax_families(je)) == jsize0
    assert step_graph.cache_size(_families(te)) == tsize0
    assert je.stats.registry.counter("engine.retraces").value == 0.0
    assert te.stats.registry.counter("engine.retraces").value == 0.0
    assert [d.step for d in tctl.decisions] == [d.step for d in jctl.decisions]


# ---------------------------------------------------------------------------
# (c) an unprimed run counts the JAX engine's retraces


@pytest.mark.parametrize("layout", ["paged", "slot"])
@pytest.mark.parametrize("mode", ["chunk+spec", "plain", "spec"])
def test_retraces_match_jax(pair, layout, mode):
    """A fresh engine, telemetry on: the first run compiles every width it
    meets (chunk widths 8/4/2/1, a verify at T = 3, prefill buckets, the
    decode) and counts each as a retrace, as the JAX engine does; the same
    run again counts none. ``window_summary()["retraces"]`` agrees."""
    cfg, jm, jp, tm, tp = pair
    kw = dict(max_seq=64, kv_layout=layout, block_size=8)
    je, te = JEngine(jm, jp, **kw), ServingEngine(tm, tp, device="cpu", **kw)
    chunk = 8 if mode == "chunk+spec" else None
    jspec, tspec = (JSpec(k=2), SpecConfig(k=2)) if "spec" in mode else (None, None)
    counts = []
    for _ in range(2):
        js = je.scheduler(2, chunk_size=chunk, spec=jspec, telemetry=JTelemetry(enabled=True))
        ts = te.scheduler(2, chunk_size=chunk, spec=tspec, telemetry=Telemetry(enabled=True))
        _same(drive(js, _workload(JRequest, cfg.vocab_size)),
              drive(ts, _workload(Request, cfg.vocab_size)))
        del js, ts
        counts.append(tuple(x for reg in (je.stats.registry, te.stats.registry)
                            for x in (reg.counter("engine.retraces").value,
                                      reg.window_summary(10_000)["retraces"])))
    (j1, jw1, t1, tw1), second = counts
    assert j1 == jw1 == t1 == tw1 > 0
    assert second == (0.0, 0.0, 0.0, 0.0)


def test_switch_to_an_unrun_family_counts_its_compiles(pair, monkeypatch):
    """A live switch re-baselines the watch (the reference's
    ``_rebuild_trace_watch``): the switch itself is no retrace, the first
    compiles of a family never run are, as many as JAX counts."""
    cfg, jm, jp, tm, tp = pair
    monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    kw = dict(max_seq=64, kv_layout="paged", block_size=8)
    je, te = JEngine(jm, jp, **kw), ServingEngine(tm, tp, device="cpu", **kw)
    drive(je.scheduler(2), _workload(JRequest, cfg.vocab_size))
    drive(te.scheduler(2), _workload(Request, cfg.vocab_size))
    js = je.scheduler(2, telemetry=JTelemetry(enabled=True))
    ts = te.scheduler(2, telemetry=Telemetry(enabled=True))
    js._set_backend("interpret")
    ts._set_backend("kernel")
    assert ts._decode_paged is te._steps["kernel"]["decode_paged"]
    _same(drive(js, _workload(JRequest, cfg.vocab_size)),
          drive(ts, _workload(Request, cfg.vocab_size)))
    got = (je.stats.registry.counter("engine.retraces").value,
           te.stats.registry.counter("engine.retraces").value)
    assert got[0] == got[1] > 0
    again = te.scheduler(2, telemetry=Telemetry(enabled=True))
    again._set_backend("kernel")  # the engine's kernel family is compiled now
    drive(again, _workload(Request, cfg.vocab_size))
    assert te.stats.registry.counter("engine.retraces").value == 0.0


# ---------------------------------------------------------------------------
# (d) two serves on one engine reuse its state storage


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_serves_reuse_the_engine_storage(pair, layout):
    """Two schedulers one after the other take the same pool (same
    addresses, zeroed) and serve the same streams; a scheduler made while
    another is live takes storage of its own."""
    cfg, jm, jp, tm, tp = pair
    kw = dict(max_seq=64, kv_layout=layout, block_size=8)
    te = ServingEngine(tm, tp, device="cpu", **kw)
    want = drive(JEngine(jm, jp, **kw).scheduler(2, spec=JSpec(k=2), chunk_size=8),
                 _workload(JRequest, cfg.vocab_size))

    def leaf(s):
        return (s.kv.pool if layout == "paged" else s.kv.cache)["k"]

    ptrs = []
    for _ in range(2):
        sched = te.scheduler(2, spec=SpecConfig(k=2), chunk_size=8)
        _same(drive(sched, _workload(Request, cfg.vocab_size)), want)
        ptrs.append(leaf(sched).data_ptr())
        del sched
    assert ptrs[0] == ptrs[1]
    first, second = te.scheduler(2), te.scheduler(2)
    assert leaf(first).data_ptr() == ptrs[0] and leaf(second).data_ptr() != ptrs[0]
    assert not leaf(first).any()  # taken zeroed
    assert 1 <= len(te._storage._free[(tm, 64)]) <= 2  # staging caches: one a row at most


def test_model_drafter_reuses_its_steps_and_cache(pair):
    """The model drafter takes the engine's draft steps and draft cache:
    a second serve compiles no draft step and drafts on the same cache."""
    cfg, jm, jp, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=64, kv_layout="paged", block_size=8, device="cpu")
    spec = SpecConfig(k=2, drafter="model", draft_model=tm, draft_params=tp)
    je = JEngine(jm, jp, max_seq=64, kv_layout="paged", block_size=8)
    want = drive(je.scheduler(2, spec=JSpec(k=2, drafter="model", draft_model=jm, draft_params=jp)),
                 _workload(JRequest, cfg.vocab_size))
    out, ptrs, sizes = [], [], []
    for _ in range(2):
        sched = te.scheduler(2, spec=spec)
        out.append(drive(sched, _workload(Request, cfg.vocab_size)))
        ptrs.append(sched._drafter.cache["k"].data_ptr())
        assert sched._drafter._decode is te._drafts[(tm, "reference")]["decode"]
        sizes.append(step_graph.cache_size(te._drafts[(tm, "reference")].values()))
        del sched
    _same(out[0], want)
    _same(out[1], want)
    assert ptrs[0] == ptrs[1] and sizes[0] == sizes[1] > 0


# ---------------------------------------------------------------------------
# (e) a step's first call runs once: recurrent state advances once


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_first_call_advances_state_once(arch):
    """One compiled decode on a fresh key advances each SSM state one step
    (as one eager call does), and the engine's streams equal JAX's."""
    over = {"num_layers": 4} if arch == "zamba2-2.7b" else {}
    cfg, jm, jp, tm, tp = _pair(arch, **over)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache = tm.prefill(tp, torch.from_numpy(prompts), 32)
    twin = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}
    tok = torch.from_numpy(prompts[:, -1:].astype(np.int64))
    fn = tm.jit_step("decode_step")
    glog, gcache = fn(tp, cache, tok)
    elog, ecache = tm.decode_step(tp, twin, tok)
    assert fn._cache_size() == 1
    torch.testing.assert_close(glog, elog, rtol=0, atol=0)
    for k in ecache["ssm_state"]:
        torch.testing.assert_close(gcache["ssm_state"][k], ecache["ssm_state"][k], rtol=0, atol=0)
    reqs = [(s, t) for s, t in ((7, 5), (13, 6), (16, 4))]

    def work(R):
        rng = np.random.default_rng(2)
        return [R(prompt=rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32),
                  max_new_tokens=t, arrival_time=0.005 * i) for i, (s, t) in enumerate(reqs)]

    want = drive(JEngine(jm, jp, max_seq=48).scheduler(2), work(JRequest))
    te = ServingEngine(tm, tp, max_seq=48, device="cpu")
    _same(drive(te.scheduler(2), work(Request)), want)
    _same(drive(te.scheduler(2), work(Request)), want)


# ---------------------------------------------------------------------------
# (f) disabled() runs the eager path: same streams, nothing compiled


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_disabled_serves_the_same_streams(pair, layout):
    cfg, jm, jp, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=64, kv_layout=layout, block_size=8, device="cpu")
    got = drive(te.scheduler(2, spec=SpecConfig(k=2), chunk_size=8),
                _workload(Request, cfg.vocab_size))
    size = step_graph.cache_size(_families(te))
    with step_graph.disabled():
        eager = drive(te.scheduler(2, spec=SpecConfig(k=2), chunk_size=8),
                      _workload(Request, cfg.vocab_size))
        fresh = tm.jit_step("decode_step")
        fresh(tp, tm.init_cache(2, 64), torch.zeros((2, 1), dtype=torch.long))
        assert fresh._cache_size() == 0
    assert step_graph.cache_size(_families(te)) == size
    _same(eager, got)


# ---------------------------------------------------------------------------
# (e) the decode plan's pool step: one compiled family a (plan key, pool size)


def _advised(jm, jp, tm, tp, prompts):
    """A JAX engine and the port's, each with the decode plan its own
    adviser accepted over ``decode_region(prompts, force=True)``."""
    from repro.core import Aira as JAira
    from repro.core import Workload as JWorkload
    from repro.core.overlap_model import CPU_HW as J_CPU_HW
    from repro_torch.core import CPU_HW, Aira, Workload

    je = JEngine(jm, jp, max_seq=64)
    jd = JAira(hw=J_CPU_HW).advise(JWorkload("serve", lambda: None, [
        je.decode_region(jnp.asarray(prompts), force=True)])).decisions[0]
    je.set_decode_plan(jd.plan)
    te = ServingEngine(tm, tp, max_seq=64, device="cpu")
    d = Aira(hw=CPU_HW).advise(Workload("serve", lambda: None, [
        te.decode_region(prompts, force=True)])).decisions[0]
    assert d.accepted and jd.accepted
    te.set_decode_plan(d.plan)
    return je, te


def _leaf_ptrs(cache) -> dict:
    return {path: t.data_ptr() for path, t in step_graph._flatten(cache)}


def test_plan_family_keeps_one_entry_like_jax(pair):
    """Two serves through one engine's decode plan, requests arriving apart
    through a 4-row pool (the live count changes mid-serve): the port's
    plan families (``engine._plan_steps``), each family's ``_cache_size()``
    and ``engine.retraces`` equal the JAX engine's jitted plan steps'; the
    streams equal the JAX engine's; the slot cache the plan decodes is the
    engine's storage (the same addresses, ``len`` included) before and
    after every serve."""
    cfg, jm, jp, tm, tp = pair
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    je, te = _advised(jm, jp, tm, tp, prompts)
    ptrs = None
    for _ in range(2):
        js = je.scheduler(4, telemetry=JTelemetry(enabled=True))
        ts = te.scheduler(4, telemetry=Telemetry(enabled=True))
        before = _leaf_ptrs(ts.kv.cache)
        ptrs = ptrs or before
        _same(drive(js, _workload(JRequest, cfg.vocab_size)),
              drive(ts, _workload(Request, cfg.vocab_size)))
        assert _leaf_ptrs(ts.kv.cache) == before == ptrs
        del js, ts
        assert (te.stats.registry.counter("engine.retraces").value
                == je.stats.registry.counter("engine.retraces").value)
    assert len(te._plan_steps) == len(je._plan_steps) == 1
    assert ([f._cache_size() for f in te._plan_steps.values()]
            == [f._cache_size() for f in je._plan_steps.values()] == [1])


def test_plan_decode_writes_the_storage_in_place(pair):
    """One plan decode over a 4-row pool with 2 live rows: the family takes
    ``tok`` and ``mask`` as inputs and writes the new cache into the
    caller's leaves, which it returns; the dead rows come back zeroed, as
    the eager plan step leaves them, and the logits equal its own."""
    from repro_torch.serve.scheduler import _plan_step

    cfg, jm, jp, tm, tp = pair
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    _, te = _advised(jm, jp, tm, tp, prompts)
    _, cache = tm.prefill(tp, torch.as_tensor(prompts), 64)
    tok = torch.as_tensor(prompts[:, -1]).long()
    mask = torch.tensor([True, False, True, False])
    want_logits, want = _plan_step(tm, te._decode_plan)(
        {k: v.clone() for k, v in cache.items()}, tok, mask)
    sched = te.scheduler(4)
    ptrs = _leaf_ptrs(cache)
    logits, got = sched._plan_decode(cache, tok, mask)
    assert got is cache and _leaf_ptrs(got) == ptrs
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for path, t in step_graph._flatten(want):
        torch.testing.assert_close(dict(step_graph._flatten(got))[path], t, rtol=0, atol=0)
    assert not got["len"][1] and int(got["len"][0]) == 9
