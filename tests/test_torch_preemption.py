"""The port's priority scheduling and preemption against the JAX package's
on the CPU, in float32 at reduced smollm-135m (JAX parameters carried
over): preempt → resume streams (both layouts, with speculation, with
chunked prefill, sampled at temperature 1 too) equal the uninterrupted
run's, with ``n_preemptions`` and ``recomputed_tokens`` equal to the JAX
engine's on the same workload; first service follows strict priority;
random mixed-priority load on a tight pool starves nobody and matches the
JAX engine's streams; the paged layout's re-registered blocks make the
resume a suffix-only recompute; and the counters add up. Workloads run on
a step clock (``drive``), so that when a request arrives relative to the
others' progress does not depend on either package's speed."""
import jax
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    from _hypothesis_stub import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine, SpecConfig, make_slo_requests

_STATE: dict = {}


def _pair():
    """Lazy module singleton (the hypothesis stub calls property tests
    with drawn arguments only, so they cannot take fixtures)."""
    if not _STATE:
        jcfg = jget("smollm-135m").reduced()
        jm = JModel(jcfg)
        jp, _ = jm.init(jax.random.key(0))
        tm = TModel(tget("smollm-135m").reduced(), device="cpu")
        tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
        _STATE["v"] = (jcfg, jm, jp, tm, tp)
    return _STATE["v"]


@pytest.fixture(scope="module")
def pair():
    return _pair()


def drive(sched, reqs, dt=0.01):
    """Run ``reqs`` to completion on a step clock (step i at i * dt; every
    request time is read from that clock)."""
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


def _pressure(R):
    """Two long low-priority requests admitted first, then a
    high-priority arrival that needs their row."""
    low = [R(prompt=np.arange(20, dtype=np.int32) + i, max_new_tokens=10, arrival_time=0.0,
             priority=0) for i in range(2)]
    return low + [R(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, arrival_time=0.02,
                    priority=5)]


def _engines(E, m, p, layout, tight, **kw):
    """(pressured, roomy): the first sized so that the high-priority
    arrival must evict, the second so that nothing ever waits."""
    extra = dict(block_size=8, num_blocks=10) if tight else dict(block_size=8)
    pressured = E(m, p, max_seq=128, kv_layout=layout, max_batch=2, **extra, **kw)
    roomy = E(m, p, max_seq=128, kv_layout=layout, max_batch=4, block_size=8, **kw)
    return pressured, roomy


def _run_both(pair, layout, tight=None, **serve_kw):
    """The pressure workload on the port's pressured and roomy engines and
    on the JAX pressured one; returns (port pressured, port roomy, JAX
    pressured) streams and the two pressured engines."""
    _, jm, jp, tm, tp = pair
    tight = layout == "paged" if tight is None else tight
    temp = serve_kw.pop("temperature", 0.0)
    pe, re_ = _engines(ServingEngine, tm, tp, layout, tight, device="cpu", temperature=temp)
    jpe, _ = _engines(JEngine, jm, jp, layout, tight, temperature=temp)
    tkw = {k: v for k, v in serve_kw.items() if k != "jspec"}
    jkw = {k: v for k, v in serve_kw.items() if k not in ("jspec", "spec")}
    if "spec" in serve_kw:
        jkw["spec"] = serve_kw["jspec"]
    reqs = _pressure(Request)
    got = drive(pe.scheduler(2, **tkw), reqs)
    roomy = drive(re_.scheduler(4, chunk_size=0), _pressure(Request))
    want = drive(jpe.scheduler(2, **jkw), _pressure(JRequest))
    assert all(r.finished for r in reqs)
    return got, roomy, want, pe, jpe, reqs


# ---------------------------------------------------------------------------
# preempt → resume


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_preempt_resume_matches_jax(pair, layout):
    """An evicted and resumed request decodes what it would have decoded
    uninterrupted; the evictions and the recompute they cost equal the
    JAX engine's."""
    got, roomy, want, pe, jpe, reqs = _run_both(pair, layout)
    assert pe.stats.n_preemptions == jpe.stats.n_preemptions > 0
    assert pe.stats.recomputed_tokens == jpe.stats.recomputed_tokens > 0
    assert any(r.preemptions > 0 for r in reqs)
    assert_same(got, roomy, "vs uninterrupted")
    assert_same(got, want, "vs JAX")


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_preempt_resume_with_speculation_matches_jax(pair, layout):
    """Preemption with n-gram speculation: the resumed stream is the plain
    uninterrupted one; evictions, recompute and acceptance equal JAX's."""
    got, roomy, want, pe, jpe, _ = _run_both(
        pair, layout, spec=SpecConfig(k=4), jspec=JSpec(k=4))
    assert pe.stats.n_preemptions == jpe.stats.n_preemptions > 0
    assert pe.stats.recomputed_tokens == jpe.stats.recomputed_tokens
    assert pe.stats.spec_accepted == jpe.stats.spec_accepted
    assert_same(got, roomy, "vs uninterrupted")
    assert_same(got, want, "vs JAX")


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_preempt_resume_chunked_matches_jax(pair, layout):
    """The resume recompute walks the chunk path and lands on the same
    stream, with JAX's counters."""
    got, roomy, want, pe, jpe, _ = _run_both(pair, layout, chunk_size=8)
    assert pe.stats.n_preemptions == jpe.stats.n_preemptions > 0
    assert pe.stats.recomputed_tokens == jpe.stats.recomputed_tokens
    assert_same(got, roomy, "vs uninterrupted")
    assert_same(got, want, "vs JAX")


def test_preempt_resume_keeps_the_sampled_stream(pair):
    """At temperature 1 the JAX scheduler keeps a request's sampled stream
    across preemption (its row key is saved and restored); the port saves
    and restores the row generator's state, so its pressured run samples
    what its uninterrupted run samples (the two packages' generators
    differ, so their tokens do not)."""
    got, roomy, want, pe, jpe, _ = _run_both(pair, "slot", temperature=1.0)
    assert pe.stats.n_preemptions == jpe.stats.n_preemptions > 0
    assert_same(got, roomy, "sampled, vs uninterrupted")
    _, jroomy = _engines(JEngine, *pair[1:3], "slot", False, temperature=1.0)
    assert_same(want, drive(jroomy.scheduler(4), _pressure(JRequest)), "JAX sampled")


# ---------------------------------------------------------------------------
# priority order and starvation


def test_priority_order_first_service(pair):
    """With one row and simultaneous arrivals, first admission follows
    (-priority, arrival, rid), as in JAX."""
    _, jm, jp, tm, tp = pair

    def reqs(R):
        return [R(prompt=np.arange(4, dtype=np.int32) + i, max_new_tokens=2, arrival_time=0.0,
                  priority=p) for i, p in enumerate([0, 3, 1, 3])]

    treqs, jreqs = reqs(Request), reqs(JRequest)
    got = drive(ServingEngine(tm, tp, max_seq=64, max_batch=1, device="cpu").scheduler(1), treqs)
    want = drive(JEngine(jm, jp, max_seq=64, max_batch=1).scheduler(1), jreqs)
    order = [treqs.index(r) for r in sorted(treqs, key=lambda r: r.t_first_admit)]
    assert order == [jreqs.index(r) for r in sorted(jreqs, key=lambda r: r.t_first_admit)]
    assert order == [1, 3, 2, 0]
    assert_same(got, want, "vs JAX")


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_no_starvation_random_mixed_priorities(seed):
    """Random arrivals, lengths, budgets and priorities on a tight paged
    pool: every request finishes with its full budget, the pool's
    invariants hold, and streams and evictions equal the JAX engine's."""
    _, jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 7))
    spec = [(rng.integers(0, 100, size=(int(rng.integers(2, 24)),)).astype(np.int32),
             int(rng.integers(1, 8)), float(rng.uniform(0, 0.05)), int(rng.integers(0, 3)))
            for _ in range(n)]

    def reqs(R):
        return [R(prompt=p, max_new_tokens=b, arrival_time=a, priority=pr)
                for p, b, a, pr in spec]

    kw = dict(max_seq=96, kv_layout="paged", max_batch=2, block_size=8, num_blocks=12)
    te = ServingEngine(tm, tp, device="cpu", **kw)
    sched = te.scheduler(2)
    treqs = reqs(Request)
    got = drive(sched, treqs)
    assert all(r.finished for r in treqs)
    for r, out in zip(treqs, got):
        assert len(out) == r.max_new_tokens  # no eos: the full budget
    sched.kv.check_invariants()
    je = JEngine(jm, jp, **kw)
    want = drive(je.scheduler(2), reqs(JRequest))
    assert_same(got, want, "vs JAX")
    assert te.stats.n_preemptions == je.stats.n_preemptions
    assert te.stats.recomputed_tokens == je.stats.recomputed_tokens


# ---------------------------------------------------------------------------
# re-registration, stats, the SLO workload


def test_paged_preempt_reregisters_committed_blocks(pair):
    """Eviction parks the victim's committed full blocks in the trie, so
    its resume prefix-matches its own history: the recompute is smaller
    than recomputing from scratch."""
    _, _, _, tm, tp = pair
    eng, _ = _engines(ServingEngine, tm, tp, "paged", True, device="cpu")
    reqs = _pressure(Request)
    drive(eng.scheduler(2), reqs)
    assert eng.stats.n_preemptions > 0
    victim = next(r for r in reqs if r.preemptions > 0)
    assert 0 < eng.stats.recomputed_tokens < (
        eng.stats.n_preemptions * (len(victim.prompt) + victim.max_new_tokens))


def test_preemption_stats_and_queue_wait_split(pair):
    _, _, _, tm, tp = pair
    eng, _ = _engines(ServingEngine, tm, tp, "paged", True, device="cpu")
    reqs = _pressure(Request)
    drive(eng.scheduler(2), reqs)
    s = eng.stats.serving_summary()
    assert s["preemptions"] == eng.stats.n_preemptions > 0
    assert s["recomputed_tokens"] == eng.stats.recomputed_tokens > 0
    assert s["rejected_submissions"] == 0
    for key in ("p50_queue_wait_ms", "p99_queue_wait_ms",
                "p50_service_ttft_ms", "p99_service_ttft_ms"):
        assert s[key] is not None
    for r in reqs:  # queue wait + service = TTFT, each leg nonnegative
        assert 0 <= r.queue_wait_ms <= r.ttft_ms + 1e-9
        assert abs(r.queue_wait_ms + r.service_ttft_ms - r.ttft_ms) < 1e-6


def test_rejected_submission_counted(pair):
    _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=16, max_batch=1, device="cpu")
    sched = eng.scheduler(1)
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(Request(prompt=np.arange(20, dtype=np.int32), max_new_tokens=4))
    assert eng.stats.rejected_submissions == 1
    sched.submit(Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=4))
    assert eng.stats.rejected_submissions == 1


def test_slo_workload_matches_jax(pair):
    """``make_slo_requests`` draws the JAX package's workload from the same
    seed; served on a tight paged pool it preempts its long low-priority
    prompts, with the JAX engine's streams and counters."""
    from repro.serve import make_slo_requests as j_slo

    cfg, jm, jp, tm, tp = pair
    kw = dict(vocab=cfg.vocab_size, max_new_tokens=8, long_len=40)
    treqs = make_slo_requests(8, 200.0, rng=np.random.default_rng(4), **kw)
    jreqs = j_slo(8, 200.0, rng=np.random.default_rng(4), **kw)
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.arrival_time, a.priority, a.max_new_tokens) == (
            b.arrival_time, b.priority, b.max_new_tokens)
    ekw = dict(max_seq=64, kv_layout="paged", block_size=8, num_blocks=10, max_batch=3)
    te, je = ServingEngine(tm, tp, device="cpu", **ekw), JEngine(jm, jp, **ekw)
    got = drive(te.scheduler(3), treqs, dt=0.002)
    want = drive(je.scheduler(3), jreqs, dt=0.002)
    assert_same(got, want, "slo vs JAX")
    assert te.stats.n_preemptions == je.stats.n_preemptions > 0
    assert te.stats.recomputed_tokens == je.stats.recomputed_tokens
