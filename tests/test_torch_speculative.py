"""The port's speculative decoding against the JAX package's on the CPU, in
float32 at reduced smollm-135m (JAX parameters carried over): the verify
steps' logits (slot layout, dense and int8 caches; paged layout through
the reference backend's gather route and through the kernel layer loop,
whose paged kernel runs its plain version on CPU tensors) within 1e-4 of
the JAX functions', the rollback methods of both pools step for step
against the JAX pools, and speculative serves (n-gram and model drafters,
both layouts, K in {2, 4, 8}) whose streams and acceptance counts equal
the JAX engine's on the same workload and whose tokens equal plain greedy
decoding. Workloads are driven on a step clock (``drive``): each step
``i`` runs at ``now = i * dt`` on both packages, so that admission does
not depend on how fast either one runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.serve import NGramDraftSource as JNGram
from repro.serve import PagedKVCache as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SlotKVCache as JSlot
from repro.serve import SpecConfig as JSpec
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model as TModel
from repro_torch.serve import (
    NGramDraftSource,
    PagedKVCache,
    Request,
    ServingEngine,
    SlotKVCache,
    SpecConfig,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def drafts(pair):
    """A one-layer draft model sharing the target's tokenizer space, in
    both packages."""
    jcfg, _, _, _, _ = pair
    dm = JModel(dataclasses.replace(jcfg, num_layers=1, name="draft-smoke"))
    dp, _ = dm.init(jax.random.key(7))
    tdm = TModel(dataclasses.replace(tget("smollm-135m").reduced(), num_layers=1), device="cpu")
    return dm, dp, tdm, tdm.params_from_reference(jax.tree.map(np.asarray, dp))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


def drive(sched, reqs, dt=0.01):
    """Run ``reqs`` to completion on a step clock: step i admits what has
    arrived by i * dt, and every request time is read from that clock."""
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


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# verify steps against the JAX functions


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_verify_step_matches_jax(pair, int8):
    """verify_step over a slot cache whose rows sit at different lengths:
    logits within 1e-4 of JAX's, lengths + T, the T new rows written
    where JAX writes them (int8: values within one rounding step)."""
    jcfg, jm, jp, tm, tp = pair
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_quant=True)
        jm = JModel(jcfg)
        tm = TModel(dataclasses.replace(tget("smollm-135m").reduced(), kv_quant=True),
                    device="cpu")
    padded = np.zeros((2, 16), np.int32)
    padded[0, :13], padded[1, :6] = _prompts(jcfg, (13,), 1), _prompts(jcfg, (6,), 2)
    plen = np.array([13, 6], np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(padded), 32, prompt_len=jnp.asarray(plen))
    _, tc = tm.prefill(tp, torch.from_numpy(padded), 32, prompt_len=plen)
    toks = _prompts(jcfg, (2, 5), 3)
    jlog, jc2 = jm.verify_step(jp, jc, jnp.asarray(toks))
    tlog, tc2 = tm.verify_step(tp, tc, torch.from_numpy(toks))
    assert tlog.shape == (2, 5, jcfg.padded_vocab)
    close(tlog, jlog)
    assert tc2["len"].tolist() == np.asarray(jc2["len"]).tolist() == [18, 11]
    for name in tm.kv_names:
        want = np.asarray(jc2[name]).astype(np.float32)
        got = tc2[name].float().numpy()
        close(got[:, 0, 13:18], want[:, 0, 13:18], 1.01 if name in ("k", "v") and int8 else ATOL)


def test_verify_step_reproduces_sequential_decode(pair):
    """One verify over the greedy stream's first four tokens predicts the
    next four, as the sequential decode does."""
    jcfg, _, _, tm, tp = pair
    prompts = torch.from_numpy(_prompts(jcfg, (2, 8), 4))
    logits0, cache = tm.prefill(tp, prompts, 32)
    dcache = {k: v.clone() for k, v in cache.items()}
    toks = [torch.argmax(logits0, -1)]
    for _ in range(4):
        lg, dcache = tm.decode_step(tp, dcache, toks[-1][:, None])
        toks.append(torch.argmax(lg, -1))
    stream = torch.stack(toks, 1)
    vlogits, vcache = tm.verify_step(tp, cache, stream[:, :4])
    assert torch.equal(torch.argmax(vlogits, -1), stream[:, 1:5])
    assert vcache["len"].tolist() == [12, 12]


def _paged_inputs(cfg, seed=6):
    rng = np.random.default_rng(seed)
    NB, BS, MB = 12, 4, 5
    shape = (cfg.num_layers, NB + 1, BS, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    tables = np.full((3, MB), NB, np.int32)  # row 2 is dead: all null block
    tables[0, :4] = [4, 1, 7, 10]
    tables[1, :3] = [0, 9, 3]
    lens = np.array([9, 6, 0], np.int32)  # row 1's 5 rows cross a block boundary
    return pool, tables, lens, NB


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_verify_step_paged_matches_jax(pair, backend, monkeypatch):
    """verify_step_paged at T = 5 over a block pool: the reference
    backend's gather → verify_step → scatter_block_tokens route against
    JAX's reference, and the kernel layer loop (the paged kernel's wrapper
    taking its plain version on CPU tensors) against JAX's Pallas kernel in
    interpret mode: logits within 1e-4, the new rows where JAX put them."""
    jcfg, jm, jp, tm, tp = pair
    if backend == "kernel":
        # the kernel path's guard wants CUDA tensors; here the wrapper's
        # plain version stands in for the kernel
        from repro_torch.kernels import ops as tops

        monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    pool, tables, lens, NB = _paged_inputs(jcfg)
    tok = _prompts(jcfg, (3, 5), 7)
    jback = "reference" if backend == "reference" else "interpret"
    jlog, jpool = jm.verify_step_paged(
        jp, {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(tok), backend=jback,
    )
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tlog, tpool = tm.verify_step_paged(
        tp, tpool, torch.from_numpy(tables), torch.from_numpy(lens), torch.from_numpy(tok),
        backend=backend,
    )
    close(tlog, jlog)
    for n in ("k", "v"):  # the null block (index NB) takes colliding dead-row writes
        close(tpool[n][:, :NB], np.asarray(jpool[n])[:, :NB])


@pytest.mark.parametrize("smax", [32, 37], ids=["smax32", "prime37"])
@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_verify_attention_matches_jax(backend, smax, monkeypatch):
    """verify_attention (T = 5 queries over a dense cache, rows at their
    own lengths) against JAX's: the reference, and the identity-table view
    through the paged kernel's wrapper (its plain version on CPU tensors)
    against JAX's Pallas kernel in interpret mode. At a prime Smax the JAX
    package takes its reference numerics (no block size ≥ 8 divides it);
    the port runs the kernel over one-key blocks, and agrees."""
    if backend == "kernel":
        from repro_torch.kernels import ops as tops

        monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    rng = np.random.default_rng(smax)
    B, T, H, KV, hd = 3, 5, 4, 2, 16
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, smax, KV, hd)).astype(np.float32) for _ in range(2))
    lens = np.array([0, 9, smax - T], np.int32)
    want = jattn.verify_attention(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                  backend="reference" if backend == "reference" else "interpret")
    got = tattn.verify_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)), backend=backend)
    close(got, want, 1e-5)


def test_verify_rejects_unrewindable_families():
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        m = TModel(tget(arch).reduced(), device="cpu")
        with pytest.raises(ValueError, match="greedy-equivalent"):
            m.verify_step(None, None, None)
        with pytest.raises(ValueError, match="greedy-equivalent"):
            m.verify_step_paged(None, None, None, None, None)


def test_scatter_and_write_positions_match_jax():
    rng = np.random.default_rng(3)
    L, NB, BS, KV, hd, B, T = 2, 7, 4, 2, 8, 3, 5
    pool = rng.normal(size=(L, NB, BS, KV, hd)).astype(np.float32)
    tables = np.array([[1, 3, 5], [0, 2, 4], [6, 6, 6]], np.int32)
    lens = np.array([2, 7, 0], np.int32)
    rows = rng.normal(size=(L, B, T, KV, hd)).astype(np.float32)
    jb, jo = jattn.block_write_positions(jnp.asarray(tables), jnp.asarray(lens), T, BS)
    tb, to = tattn.block_write_positions(torch.from_numpy(tables), torch.from_numpy(lens), T, BS)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    live = np.asarray(jb)[:2]  # rows 0-1 own their blocks; row 2 collides in block 6
    want = np.asarray(jattn.scatter_block_tokens(jnp.asarray(pool), jnp.asarray(rows), jb, jo))
    got = torch.from_numpy(pool.copy())
    tattn.scatter_block_tokens(got, torch.from_numpy(rows), tb, to)
    for b in np.unique(live):
        np.testing.assert_array_equal(got[:, b].numpy(), want[:, b])


# ---------------------------------------------------------------------------
# rollback, step for step against the JAX pools


def test_slot_truncate_matches_jax(pair):
    _, jm, _, tm, _ = pair
    jkv, tkv = JSlot(jm, max_batch=2, max_seq=16), SlotKVCache(tm, max_batch=2, max_seq=16)
    js, ts = jkv.alloc(0), tkv.alloc(0)
    assert js == ts
    jkv.cache["len"] = jkv.cache["len"].at[js].set(9)
    tkv.cache["len"][ts] = 9
    jkv.truncate_row(js, 3)
    tkv.truncate_row(ts, 3)
    assert tkv.cache["len"].tolist() == np.asarray(jkv.cache["len"]).tolist() == [6, 0]
    jkv.truncate_rows(np.array([2, 5]))
    tkv.truncate_rows(np.array([2, 5]))  # the dead row stays at zero
    assert tkv.cache["len"].tolist() == np.asarray(jkv.cache["len"]).tolist() == [4, 0]
    tkv.check_invariants()
    tkv.free(ts)
    with pytest.raises(RuntimeError, match="truncate of free slot"):
        tkv.truncate_row(ts, 1)
    tkv.alloc(1)
    tkv.preempt_row(0, (1, 2, 3))  # frees: the slot layout keeps no trie
    assert tkv.n_free == 2
    tkv.check_invariants()


def test_paged_cache_methods_match_jax(pair):
    """Every new paged-cache method, called in the same order on the JAX
    pool and the port's: free blocks, reservations, tables and lengths
    equal after each call, and ``check_invariants`` holds."""
    _, jm, _, tm, _ = pair
    jkv = JPaged(jm, max_batch=3, max_seq=32, block_size=4, num_blocks=20)
    tkv = PagedKVCache(tm, max_batch=3, max_seq=32, block_size=4, num_blocks=20)
    prompt = tuple(range(8))

    def both(name, *args, **kw):
        out = (getattr(jkv, name)(*args, **kw), getattr(tkv, name)(*args, **kw))
        tkv.check_invariants()
        jkv.check_invariants()
        n_avail = tkv.allocator.n_available - tkv._outstanding_total
        assert n_avail == jkv.n_free_blocks, name
        assert (tkv.allocator.n_free, tkv.allocator.n_parked) == (
            jkv.allocator.n_free, jkv.allocator.n_parked), name
        assert tkv.block_tables.tolist() == jkv.block_tables.tolist(), name
        assert tkv.cache_len.tolist() == jkv.cache_len.tolist(), name
        assert tkv._row_outstanding == jkv._row_outstanding, name
        return out

    (jr, jh), (tr, th) = both("try_admit", 0, prompt, 12)
    assert (jr, jh) == (tr, th) == (0, [])
    both("ensure_tail_n", 0, 5)  # positions 8..12: two tail blocks
    both("advance_n", 0, 5)
    both("truncate_row", 0, 4)  # keep 1 of 5: one tail block released
    assert tkv.cache_len[0] == 9
    (_, jh), (row2, th) = both("try_admit", 1, prompt + (99,), 4)
    assert th == jh and len(th) == 2  # the prompt's full blocks alias
    both("ensure_tail_n", row2, 3)
    both("advance_n", row2, 3)
    both("truncate_row", row2, 3)
    assert all(tkv.allocator.refcount[b] == 2 for b in th)  # shared blocks stay
    # deferred registration (chunked admission), then the register
    (_, jh), (row3, th) = both("try_admit", 2, tuple(range(50, 62)), 2, register=False)
    assert tkv.lookup(tuple(range(50, 62))) == [] and th == []
    both("register_prompt", row3, tuple(range(50, 62)))
    assert tkv.lookup(tuple(range(50, 62))) == jkv.lookup(tuple(range(50, 62))) != []
    # preemption parks the committed full blocks; the resume hits them
    committed = prompt + (5, 6)
    both("preempt_row", 0, committed)
    assert tkv.lookup(committed) == jkv.lookup(committed) != []
    both("free_row", row2)
    both("free_row", row3)
    n_j, n_t = both("drop_cached")
    assert n_t == n_j > 0 and tkv.allocator.n_parked == 0
    assert tkv.lookup(committed) == []  # the cold path again
    with pytest.raises(RuntimeError, match="truncate of free row"):
        tkv.truncate_row(0, 1)
    with pytest.raises(RuntimeError, match="preempt of free row"):
        tkv.preempt_row(0)


# ---------------------------------------------------------------------------
# speculative serves against the JAX engine's


def _trace(R, prompts, lens, budgets, eos=None, eos_req=None):
    return [
        R(prompt=np.asarray(prompts[i, : lens[i]]), max_new_tokens=int(budgets[i]),
          arrival_time=0.01 * i, eos_id=eos if i == eos_req else None)
        for i in range(len(lens))
    ]


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculative_serve_matches_jax_and_greedy(pair, drafts, kv_layout, drafter):
    """Both drafters x both layouts x K in {2, 4, 8} on a staggered trace
    with one EOS early finish: streams and acceptance counts equal the
    JAX engine's, tokens equal plain greedy decoding, the pool returns
    every slot and block."""
    jcfg, jm, jp, tm, tp = pair
    dm, dp, tdm, tdp = drafts
    prompts = _prompts(jcfg, (4, 16), 1)
    rng = np.random.default_rng(1)
    lens, budgets = rng.integers(3, 16, size=4), rng.integers(2, 8, size=4)
    plain = ServingEngine(tm, tp, max_seq=64, device="cpu")
    bases = [plain.generate(prompts[i : i + 1, : lens[i]], int(budgets[i])).numpy()[0]
             for i in range(4)]
    eos = int(bases[0][min(1, int(budgets[0]) - 1)])
    cut = int(np.argmax(bases[0] == eos))
    expected = [b if i else b[: cut + 1] for i, b in enumerate(bases)]
    je = JEngine(jm, jp, max_seq=64, kv_layout=kv_layout, block_size=4)
    te = ServingEngine(tm, tp, max_seq=64, kv_layout=kv_layout, block_size=4, device="cpu")
    for k in (2, 4, 8):
        if drafter == "ngram":
            jspec, tspec = JSpec(k=k), SpecConfig(k=k)
        else:
            jspec = JSpec(k=k, drafter="model", draft_model=dm, draft_params=dp)
            tspec = SpecConfig(k=k, drafter="model", draft_model=tdm, draft_params=tdp)
        want = drive(je.scheduler(3, spec=jspec), _trace(JRequest, prompts, lens, budgets, eos, 0))
        sched = te.scheduler(3, spec=tspec)
        reqs = _trace(Request, prompts, lens, budgets, eos, 0)
        got = drive(sched, reqs)
        sched.kv.check_invariants()
        assert all(r.finished for r in reqs)
        assert_same(got, want, f"K={k} vs JAX")
        assert_same(got, expected, f"K={k} vs greedy")
        s = te.stats.serving_summary()["speculative"]
        assert s == {**s, "k": k, "proposed": je.stats.spec_proposed,
                     "accepted": je.stats.spec_accepted, "spec_steps": je.stats.spec_steps}
        assert set(sched.widths["verify"]) == {k + 1}


def test_speculative_paged_eviction_under_pressure(pair):
    """Speculation on a block-starved paged pool (margin reservations,
    lazy tail claims, rollback releases and LRU eviction interleave):
    streams equal the JAX engine's and the plain ones."""
    jcfg, jm, jp, tm, tp = pair
    prompts = _prompts(jcfg, (3, 16), 1)
    lens, budgets = (12, 8, 14), (4, 6, 3)
    plain = ServingEngine(tm, tp, max_seq=64, device="cpu")
    bases = [plain.generate(prompts[i : i + 1, : lens[i]], budgets[i]).numpy()[0]
             for i in range(3)]
    kw = dict(max_seq=64, kv_layout="paged", block_size=4, num_blocks=8)
    want = drive(JEngine(jm, jp, **kw).scheduler(2, spec=JSpec(k=4)),
                 _trace(JRequest, prompts, lens, budgets))
    sched = ServingEngine(tm, tp, device="cpu", **kw).scheduler(2, spec=SpecConfig(k=4))
    got = drive(sched, _trace(Request, prompts, lens, budgets))
    sched.kv.check_invariants()
    assert_same(got, want, "vs JAX")
    assert_same(got, bases, "vs greedy")


def test_self_draft_reaches_full_acceptance(pair):
    """Draft model == target model: every proposal survives the verify
    (acceptance 1.0) and the stream is the greedy one, as in JAX."""
    jcfg, jm, jp, tm, tp = pair
    prompts = _prompts(jcfg, (2, 8), 1)
    base = ServingEngine(tm, tp, max_seq=64, device="cpu").generate(prompts, 6).numpy()
    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    reqs = [Request(prompt=prompts[i], max_new_tokens=6) for i in range(2)]
    out = eng.serve(reqs, max_batch=2,
                    spec=SpecConfig(k=4, drafter="model", draft_model=tm, draft_params=tp))
    assert eng.stats.acceptance_rate == 1.0
    je = JEngine(jm, jp, max_seq=64)
    jout = je.serve([JRequest(prompt=prompts[i], max_new_tokens=6) for i in range(2)],
                    max_batch=2,
                    spec=JSpec(k=4, drafter="model", draft_model=jm, draft_params=jp))
    assert je.stats.acceptance_rate == 1.0
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(out[r.rid], base[i])
    assert_same([out[r.rid] for r in reqs], [v for _, v in sorted(jout.items())])


# ---------------------------------------------------------------------------
# guards and drafters


def test_spec_guards(pair):
    jcfg, _, _, tm, tp = pair
    with pytest.raises(ValueError, match="temperature"):
        ServingEngine(tm, tp, max_seq=32, temperature=0.7, device="cpu").scheduler(
            2, spec=SpecConfig(k=4))
    ssm = TModel(tget("mamba2-370m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="rewindable"):
        ServingEngine(ssm, ssm.init(0), max_seq=32, device="cpu").scheduler(
            2, spec=SpecConfig(k=4))
    with pytest.raises(ValueError, match="draft_model"):
        SpecConfig(k=4, drafter="model").make_drafter()
    assert SpecConfig(k=0).make_drafter() is None
    from repro_torch.core.plan import plan_for

    plan = plan_for("spec-no-plan", lambda x: x, torch.arange(4.0), granularity=1)
    eng = ServingEngine(tm, tp, max_seq=32, device="cpu")
    eng.set_decode_plan(plan)
    with pytest.raises(ValueError, match="decode plans"):
        eng.scheduler(2, spec=SpecConfig(k=4))
    sched = ServingEngine(tm, tp, max_seq=32, device="cpu").scheduler(2, spec=SpecConfig(k=4))
    with pytest.raises(ValueError, match="decode plans"):
        sched.set_decode_plan(plan)


def test_submit_enforces_speculative_margin(pair):
    """prompt + budget + K must fit the row: the last verify's rejected
    tail occupies K rows past the final length."""
    _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="speculative margin"):
        eng.serve([Request(prompt=np.ones(8, np.int32), max_new_tokens=6)], max_batch=1,
                  spec=SpecConfig(k=4))
    assert eng.stats.rejected_submissions == 1
    out = eng.serve([Request(prompt=np.ones(8, np.int32), max_new_tokens=6)], max_batch=1)
    assert len(next(iter(out.values()))) == 6


def test_ngram_lookup_matches_jax():
    d, jd = NGramDraftSource(k=4, ngram=(3, 2, 1)), JNGram(k=4, ngram=(3, 2, 1))
    d.bind(max_batch=1, max_seq=64)
    for hist, want in (([9, 1, 2, 3, 4, 5, 1, 2], [3, 4, 5, 1]),  # continuation
                       ([5, 7, 8, 7, 8], [7, 8, 7, 8]),  # a loop cycle-extends
                       ([3, 1, 4], [4, 4, 4, 4])):  # no match: repeat the last
        hist = np.array(hist, np.int32)
        np.testing.assert_array_equal(d._lookup(hist), want)
        np.testing.assert_array_equal(d._lookup(hist), jd._lookup(hist))


def test_serving_spec_stages_resolve():
    """Every SERVING_SPEC stage's tool path names a real symbol of the
    port, speculate's (the depth adviser's tool) included."""
    import importlib

    from repro_torch.core.spec import SERVING_SPEC

    assert [s.name for s in SERVING_SPEC] == ["draft", "verify", "rollback", "speculate"]
    for stage in SERVING_SPEC:
        parts = stage.tool.split(".")
        obj, i = None, len(parts)
        while i > 0:
            try:
                obj = importlib.import_module("repro_torch." + ".".join(parts[:i]))
                break
            except ImportError:
                i -= 1
        assert obj is not None, stage.tool
        for attr in parts[i:]:
            obj = getattr(obj, attr)
    from repro_torch.core import tools

    assert obj is tools.SpeculationAdvisorTool


def test_stats_spec_accounting_resets(pair):
    jcfg, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    eng.serve([Request(prompt=_prompts(jcfg, (8,), 2), max_new_tokens=5)], max_batch=1,
              spec=SpecConfig(k=2))
    assert eng.stats.spec_steps > 0 and eng.stats.spec_proposed > 0
    assert len(eng.stats.draft_ms) == len(eng.stats.verify_ms) == eng.stats.spec_steps
    assert 0.0 <= eng.stats.acceptance_rate <= 1.0
    eng.stats.reset()
    assert eng.stats.spec_steps == 0 and eng.stats.spec_proposed == 0
    assert not eng.stats.draft_ms and not eng.stats.verify_ms
    assert "speculative" not in eng.stats.serving_summary()
