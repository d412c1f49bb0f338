"""The port's online adviser against the JAX package's on the CPU, at
reduced smollm-135m (JAX parameters carried over), paged layout,
``max_seq`` 64: the shared pricing functions and the two serving advisor
tools equal the JAX ones on the same inputs; ``OnlineAdviser`` fed the same
scripted ``window_summary`` dicts gives the JAX controller's audit trail
exactly (switch up, dwell, threshold, probe and revert, probe commit,
admission throttle); a pinned controller serves the static configuration's
streams bitwise; a scripted controller switching K over (0, 2, 4) takes
its decisions at the JAX engine's steps and serves the JAX engine's
streams, which equal plain decoding; the model drafter's 0→K catch-up, an
``OnlineAdviser`` seeded from ``prime()``, the admission budget, the
controller's gauges and summary section, the cold-start sensor vector,
``advise_depth`` and the drift workload. Serves run on a step clock
(``drive``), so decisions and admissions do not depend on either
package's speed."""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import tools as jtools
from repro.models import Model as JModel
from repro.serve import Decision as JDecision
from repro.serve import OnlineAdviser as JOnline
from repro.serve import PinnedController as JPinned
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve import make_drift_requests as j_drift
from repro.serve.telemetry import MetricsRegistry as JRegistry
from repro_torch.configs import get_config as tget
from repro_torch.core import tools as ttools
from repro_torch.models.model import Model as TModel
from repro_torch.serve import (
    Decision,
    MetricsRegistry,
    OnlineAdviser,
    PinnedController,
    Request,
    ServingEngine,
    SpecConfig,
    advise_depth,
    make_drift_requests,
)

KW = dict(max_seq=64, kv_layout="paged", block_size=8)


@pytest.fixture(scope="module")
def pair():
    """Both packages' reduced smollm-135m on the same weights, a paged
    engine each; the JAX engine primed once over ks (0, 2, 4) on its
    reference backend."""
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    je = JEngine(jm, jp, **KW)
    je.prime(2, ks=(0, 2, 4), backends=("reference",))
    te = ServingEngine(tm, tp, device="cpu", **KW)
    return jcfg, jm, jp, je, tm, tp, te


def _workload(R, vocab, specs=((8, 6), (12, 8), (8, 5), (16, 4)), arrival=0.01, seed=7):
    rng = np.random.default_rng(seed)
    return [R(prompt=rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=t,
              arrival_time=arrival * i) for i, (n, t) in enumerate(specs)]


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


# ---------------------------------------------------------------------------
# the pricing functions and the serving advisor tools


def test_price_speculation_matches_jax():
    tool, jtool = ttools.SpeculationAdvisorTool(ks=(0, 2, 4, 8)), jtools.SpeculationAdvisorTool(
        ks=(0, 2, 4, 8))
    for p in (0.0, 0.3, 0.6, 0.9, 1.0):
        for draft in (0.01, 0.1, 1.0):
            for v8 in (2.2, 4.0, 9.0):
                m = ttools.SpecMeasurement(draft, {0: 2.0, 8: v8}, p)
                jm = jtools.SpecMeasurement(draft, {0: 2.0, 8: v8}, p)
                got = ttools.price_speculation(m, (0, 2, 4, 8))
                assert got == jtools.price_speculation(jm, (0, 2, 4, 8)), (p, draft, v8)
                assert tool.choose(m) == jtool.choose(jm)
                k, cost, gain, costs = got
                assert k == tool.choose(m)[0] and costs[0] == pytest.approx(m.verify_cost(0))
                if k:
                    assert cost == pytest.approx(costs[k])
    m = ttools.SpecMeasurement(0.05, {0: 2.0, 8: 2.2}, 0.05)  # a marginal win at best
    k, cost, gain, _ = ttools.price_speculation(m, (0, 2, 4, 8), threshold=0.5)
    assert k == 0 and gain == 0.0 and cost == pytest.approx(m.verify_cost(0))


def test_price_backends_matches_jax():
    tool, jtool = ttools.KernelAdvisorTool(), jtools.KernelAdvisorTool()
    for cells in ({"reference": 2.0, "kernel": 1.0}, {"reference": 1.0, "kernel": 2.0},
                  {"reference": 1.0, "kernel": 0.99}):  # the last under the 2% gate
        got = tool.choose(ttools.KernelMeasurement.make("llama", "paged", 2, dict(cells)))
        assert got == jtool.choose(jtools.KernelMeasurement.make("llama", "paged", 2, dict(cells)))
        b, ms, gain = ttools.price_backends(dict(cells))
        assert (b, ms, gain) == jtools.price_backends(dict(cells))
        assert b == got[0] and gain == pytest.approx(got[1]) and ms == pytest.approx(cells[b])
    # the online baseline: priced against the live arm, not "reference"
    b, _, gain = ttools.price_backends({"reference": 1.0, "kernel": 1.5}, baseline="kernel")
    assert b == "reference" and gain == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# OnlineAdviser on scripted sensor windows, against the JAX controller


def _summary(**kw):
    base = dict(
        window=8, ticks=8, acceptance_rate=0.0, proposed=0.0, accepted=0.0,
        spec_steps=0.0, p50_draft_ms=0.0, p50_verify_ms=0.0, queue_depth=0.0,
        active=2.0, pool_occupancy=0.5, pool_free_blocks=10.0,
        step_cost_ms=0.0, p99_step_ms=0.0, admitted=0.0, preemptions=0.0,
        rejected=0.0, prefix_hit_rate=0.0, chunk_utilization=0.0,
        alloc_rate=0.0, evict_rate=0.0, park_rate=0.0, retraces=0.0,
    )
    base.update(kw)
    return base


def _seeded(cls, cells=None, draft=0.05, **kw):
    args = dict(ks=(0, 2, 4), decision_interval=1, window=8, dwell=2, threshold=0.05,
                probe_every=2)
    args.update(kw)
    ctl = cls(**args)
    # K=0 decode 2 ms; verify widths barely above it: a high p̂ pays off
    ctl.seed_costs({"reference": cells or {0: 2.0, 2: 2.3, 4: 2.6}}, draft_ms_per_token=draft)
    return ctl


# each scenario: (controller kwargs, seed cells, draft cost, [(k_live, summary), ...])
SPEC_WIN = dict(acceptance_rate=0.9, proposed=8.0, accepted=7.2, p50_draft_ms=0.1,
                p50_verify_ms=2.3)
FLIP_BACK = dict(acceptance_rate=0.0, proposed=8.0, p50_verify_ms=9.0)
SCENARIOS = {
    "switch_up": ({}, None, 0.05, [(2, SPEC_WIN)]),
    "dwell": ({}, None, 0.05, [(2, SPEC_WIN), (4, FLIP_BACK), (4, FLIP_BACK), (4, FLIP_BACK)]),
    "threshold": ({"threshold": 10.0, "initial_k": 2}, None, 0.05, [(2, SPEC_WIN)]),
    "probe_revert": ({"dwell": 0}, {0: 2.0, 2: 4.0, 4: 8.0}, None, [
        (0, dict(step_cost_ms=2.0)),
        (2, dict(acceptance_rate=0.1, proposed=4.0, accepted=0.4, p50_draft_ms=0.2,
                 p50_verify_ms=4.0)),
        (0, dict(step_cost_ms=2.0)), (0, dict(step_cost_ms=2.0))]),
    "probe_commit": ({"dwell": 0}, None, 0.05, [
        (0, dict(step_cost_ms=2.0)),
        (2, dict(acceptance_rate=0.95, proposed=4.0, accepted=3.8, p50_draft_ms=0.1,
                 p50_verify_ms=2.3))]),
    "throttle": ({}, None, 0.05, [
        (0, dict(preemptions=2.0, pool_occupancy=0.95, step_cost_ms=2.0)),
        (0, dict(preemptions=0.0, pool_occupancy=0.95, step_cost_ms=2.0))]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_online_adviser_trail_matches_jax(name):
    """The same sequence of sensor windows into both packages' controllers
    gives the same audit trail and summary, and the JAX test suite's
    behaviour for each scenario."""
    kw, cells, draft, seq = SCENARIOS[name]
    ctl, jctl = (_seeded(cls, cells, draft, **kw) for cls in (OnlineAdviser, JOnline))
    ds = []
    for step, (k_live, window) in enumerate(seq, 1):
        ds.append(ctl.decide(_summary(**window), k_live=k_live, backend_live="reference",
                             step=step))
        jctl.decide(_summary(**window), k_live=k_live, backend_live="reference", step=step)
    assert ctl.audit_trail() == jctl.audit_trail()
    assert ctl.summary() == jctl.summary()
    if name == "switch_up":
        assert ds[0].k == 4 and ds[0].switched and ds[0].predicted_gain > 0.05
        assert ctl.n_switches == 1 and ctl.dwell_remaining == 2
    elif name == "dwell":  # the dwell holds the arm twice, then the flip back lands
        assert [(d.k, d.switched) for d in ds] == [(4, True), (4, False), (4, False), (0, True)]
    elif name == "threshold":
        assert ds[0].k == 2 and not ds[0].switched and ctl.n_switches == 0
    elif name == "probe_revert":
        assert ds[0].probe and ds[0].k == 2 and not ds[0].switched
        assert ds[1].k == 0 and not ds[1].probe and "probe over" in ds[1].reason
        assert not ds[2].probe and ds[3].probe
    elif name == "probe_commit":
        assert ds[0].probe and ds[1].k == 4 and ds[1].switched and ctl.n_switches == 1
    else:
        assert [d.admit_budget for d in ds] == [1, None]


def test_construction_guards_and_json_trail():
    with pytest.raises(ValueError, match="initial_k"):
        OnlineAdviser(ks=(0, 2), initial_k=3)
    with pytest.raises(ValueError, match=">= 0"):
        OnlineAdviser(ks=(-1, 2))
    ctl = _seeded(OnlineAdviser)
    ctl.decide(_summary(acceptance_rate=0.9, proposed=8.0, p50_verify_ms=2.3),
               k_live=2, backend_live="reference", step=1)
    trail = ctl.audit_trail()
    assert len(trail) == 1 and trail[0]["k"] == 4
    json.dumps(trail)
    json.dumps(ctl.summary())
    d = Decision(step=3, k=2, backend="kernel", predicted_gain=0.123456,
                 inputs={"a": 0.123456, "b": 2})
    jd = JDecision(step=3, k=2, backend="kernel", predicted_gain=0.123456,
                   inputs={"a": 0.123456, "b": 2})
    assert d.to_json() == jd.to_json()


# ---------------------------------------------------------------------------
# controlled serving against the JAX engine


class Scripted:
    """A duck-typed controller replaying a fixed (k, backend) script (the
    switching harness of the JAX tests: arbitrary mid-serve decisions,
    none of them priced); ``make`` is the package's ``Decision``."""

    def __init__(self, make, script, ks=(0, 2, 4), interval=2):
        self.make, self.script = make, list(script)
        self.ks, self.backends = tuple(ks), None
        self.decision_interval, self.window, self.initial_k = int(interval), 8, 0
        self.decisions, self.n_switches, self.dwell_remaining, self._i = [], 0, 0, 0

    def decide(self, summary, *, k_live, backend_live, step):
        k, backend = self.script[self._i % len(self.script)]
        self._i += 1
        d = self.make(step=step, k=k, backend=backend or backend_live,
                      switched=(k != k_live), reason="scripted")
        self.n_switches += int(d.switched)
        self.decisions.append(d)
        return d


def test_pinned_controller_matches_static_and_jax(pair):
    jcfg, _, _, je, _, _, te = pair
    V = jcfg.vocab_size
    static = drive(te.scheduler(2, spec=SpecConfig(k=2)), _workload(Request, V))
    ctl = PinnedController(2, decision_interval=2)
    pinned = drive(te.scheduler(2, spec=SpecConfig(k=2), controller=ctl), _workload(Request, V))
    assert_same(pinned, static, "pinned vs static")
    s = te.stats.serving_summary()
    assert s["controller"]["k"] == 2 and s["controller"]["decisions"] > 0
    jctl = JPinned(2, decision_interval=2)
    want = drive(je.scheduler(2, spec=JSpec(k=2), controller=jctl), _workload(JRequest, V))
    assert_same(pinned, want, "pinned vs JAX")
    assert [d.to_json() for d in ctl.decisions] == [d.to_json() for d in jctl.decisions]
    assert s["controller"] == je.stats.serving_summary()["controller"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_switching_matches_jax(pair, seed):
    """Random live K decisions over (0, 2, 4): the decisions land at the
    JAX engine's steps, the streams are the JAX engine's and plain
    decoding's, and every verify ran at a width K+1 of a decided K."""
    jcfg, _, _, je, _, _, te = pair
    V = jcfg.vocab_size
    rng = np.random.default_rng(seed)
    script = [(int(rng.choice([0, 2, 4])), None) for _ in range(8)]
    plain = drive(te.scheduler(2, spec=SpecConfig(k=0)), _workload(Request, V, seed=seed))
    ctl = Scripted(Decision, script)
    sched = te.scheduler(2, spec=SpecConfig(k=4), controller=ctl)
    got = drive(sched, _workload(Request, V, seed=seed))
    jctl = Scripted(JDecision, script)
    want = drive(je.scheduler(2, spec=JSpec(k=4), controller=jctl),
                 _workload(JRequest, V, seed=seed))
    assert_same(got, want, "scripted vs JAX")
    assert_same(got, plain, "scripted vs plain")
    assert ctl.decisions and [d.step for d in ctl.decisions] == [d.step for d in jctl.decisions]
    assert set(sched.widths["verify"]) <= {3, 5}
    assert sum(sched.widths["verify"].values()) == je.stats.spec_steps
    assert te.stats.spec_proposed == je.stats.spec_proposed
    assert te.stats.spec_accepted == je.stats.spec_accepted


def test_model_drafter_zero_to_k_catchup(pair):
    """0 → 2 → 0 → 2 flips with the model drafter, slot layout: a 0→K
    switch re-syncs the draft cache from each live row's committed
    history, so tokens equal plain decoding bitwise."""
    jcfg, _, _, _, tm, tp, _ = pair
    V = jcfg.vocab_size
    eng = ServingEngine(tm, tp, max_seq=64, kv_layout="slot", device="cpu")
    spec = SpecConfig(k=2, drafter="model", draft_model=tm, draft_params=tp)
    base = drive(eng.scheduler(2, spec=SpecConfig(k=0)), _workload(Request, V))
    ctl = Scripted(Decision, [(0, None), (2, None)] * 4, ks=(0, 2), interval=2)
    sched = eng.scheduler(2, spec=spec, controller=ctl)
    assert sched._drafter._max_seq == 64 + 2 + 1  # max_seq + K + 1
    out = drive(sched, _workload(Request, V))
    assert_same(out, base, "catch-up vs plain")
    assert any(d.k == 2 for d in ctl.decisions) and any(d.k == 0 for d in ctl.decisions)
    assert eng.stats.spec_proposed > 0


def test_online_adviser_end_to_end_with_seeded_costs(pair):
    jcfg, _, _, _, _, _, te = pair
    V = jcfg.vocab_size
    primed = te.prime(2, ks=(0, 2, 4))
    assert set(primed["cells"]) == {"reference"} and primed["ks"] == (0, 2, 4)
    assert all(ms > 0 for ms in primed["cells"]["reference"].values())
    ctl = OnlineAdviser(ks=(0, 2, 4), decision_interval=2, window=6, dwell=1,
                        threshold=0.05, probe_every=2)
    ctl.seed_costs(primed)
    specs = ((6, 16), (8, 16), (6, 12))  # long budgets on short prompts: draftable
    base = drive(te.scheduler(2, spec=SpecConfig(k=0)), _workload(Request, V, specs))
    # no spec given: the engine installs an n-gram SpecConfig(k=max(ks))
    sched = te.scheduler(2, controller=ctl)
    assert sched.spec.k == 4 and sched.spec.drafter == "ngram"
    out = drive(sched, _workload(Request, V, specs))
    assert_same(out, base, "online vs plain")
    trail = ctl.audit_trail()
    assert trail and all(d["k"] in (0, 2, 4) and d["inputs"]["window"] >= 0 for d in trail)
    assert set(sched.widths["verify"]) <= {3, 5}


def test_prime_slot_layout_and_kernel_refusal(pair):
    """prime() times the slot layout's grid too; the kernel backend on CPU
    tensors raises (it never degrades to its plain version silently)."""
    _, _, _, _, tm, tp, _ = pair
    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    out = eng.prime(2, ks=(0, 8), kv_layout="slot", reps=1)
    assert out["layout"] == "slot" and set(out["cells"]["reference"]) == {0, 8}
    with pytest.raises(ValueError, match="CUDA"):
        eng.prime(2, ks=(0,), backends=("kernel",))


def test_controller_guards(pair):
    from repro_torch.serve import Scheduler

    _, _, _, _, _, _, te = pair
    with pytest.raises(ValueError, match="exceeds spec.k"):
        Scheduler(te.model, te.params, max_batch=2, max_seq=64, spec=SpecConfig(k=2),
                  controller=OnlineAdviser(ks=(0, 4)))
    with pytest.raises(ValueError, match="no speculation"):
        Scheduler(te.model, te.params, max_batch=2, max_seq=64, controller=OnlineAdviser())
    sched = te.scheduler(2, spec=SpecConfig(k=2))
    with pytest.raises(ValueError, match="outside"):
        sched._set_live_k(3)
    # a spec shallower than the controller's deepest arm is deepened to it
    assert te.scheduler(2, spec=SpecConfig(k=2), controller=OnlineAdviser(ks=(0, 4))).spec.k == 4


def test_admit_budget_applied(pair):
    jcfg, _, _, _, _, _, te = pair
    V = jcfg.vocab_size

    class Throttler(PinnedController):
        def decide(self, summary, *, k_live, backend_live, step):
            d = super().decide(summary, k_live=k_live, backend_live=backend_live, step=step)
            d.admit_budget = 1
            return d

    base = drive(te.scheduler(2, spec=SpecConfig(k=0)), _workload(Request, V, arrival=0.0))
    sched = te.scheduler(2, spec=SpecConfig(k=0), controller=Throttler(0, decision_interval=1))
    out = drive(sched, _workload(Request, V, arrival=0.0))
    assert_same(out, base, "throttled vs plain")
    assert te.stats.serving_summary()["controller"]["admit_budget"] == 1
    # with the budget set, a step admits at most one of the waiting requests
    sched._admit_budget = 1
    reqs = _workload(Request, V, arrival=0.0)
    for r in reqs:
        sched.submit(r)
    sched.step(now=0.0)
    assert len(sched._active) + sum(r.finished for r in reqs) == 1


def test_controller_metrics_in_prometheus_and_snapshot(pair):
    jcfg, _, _, _, _, _, te = pair
    V = jcfg.vocab_size
    te.serve(_workload(Request, V), max_batch=2, seed=0, spec=SpecConfig(k=2),
             controller=PinnedController(2, decision_interval=2))
    reg = te.stats.registry
    assert reg.counter("controller.decisions").value > 0
    snap = reg.snapshot()
    for g in ("controller.k", "controller.dwell_remaining", "controller.backend_index",
              "sched.queue_depth", "sched.active", "pool.occupancy", "pool.free_blocks"):
        assert g in snap["gauges"], g
    text = reg.prometheus_text()
    assert "# TYPE controller_decisions counter" in text and "controller_k" in text
    assert reg.ticks > 0 and reg.window_summary(8)["admitted"] > 0
    assert te.stats.serving_summary()["controller"]["backend"] == "reference"
    # a controller-less serve carries no controller section
    te.serve(_workload(Request, V), max_batch=2, seed=0, spec=SpecConfig(k=0))
    assert "controller" not in te.stats.serving_summary()


def test_window_summary_cold_start_matches_jax():
    """Every sensor is finite from tick zero, and the port's vector equals
    the JAX registry's over the same ticks."""
    reg, jreg = MetricsRegistry(), JRegistry()
    for n in (1, 4, 64):
        s = reg.window_summary(n)
        assert s == jreg.window_summary(n)
        for key, v in s.items():
            assert v is not None and (not isinstance(v, float) or math.isfinite(v)), key
        assert s["acceptance_rate"] == 0.0 and s["window"] == 0 and s["retraces"] == 0.0
    for r in (reg, jreg):
        r.counter("serve.spec_proposed")
        r.counter("serve.spec_accepted")
        r.tick()
    s = reg.window_summary(4)
    assert s == jreg.window_summary(4) and s["window"] == 1 and s["acceptance_rate"] == 0.0
    for r in (reg, jreg):
        r.series("serve.step_ms").append(2.0)
        r.counter("serve.spec_proposed").inc(4)
        r.counter("serve.spec_accepted").inc(3)
        r.gauge("pool.occupancy").set(0.5)
        r.tick()
    s = reg.window_summary(64)
    assert s == jreg.window_summary(64)
    assert s["window"] == 2 and s["step_cost_ms"] == pytest.approx(2.0)
    assert s["acceptance_rate"] == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# the speculation and kernel advisor tools (the JAX tests, on the port)


def test_expected_tokens_per_round():
    assert ttools.expected_tokens_per_round(0.0, 4) == 1.0
    assert ttools.expected_tokens_per_round(1.0, 4) == 5.0
    assert ttools.expected_tokens_per_round(0.5, 2) == pytest.approx(1.75)
    for p in (0.0, 0.37, 1.0):
        assert ttools.expected_tokens_per_round(p, 8) == jtools.expected_tokens_per_round(p, 8)


def test_advisor_picks_depth_by_expected_latency():
    tool, M = ttools.SpeculationAdvisorTool(), ttools.SpecMeasurement
    k, gain, log = tool.choose(M(0.0, {0: 10.0, 8: 12.0}, 0.9))  # free drafts, high acceptance
    assert k == 8 and gain > 1.0 and "K=8" in log
    assert tool.choose(M(0.0, {0: 10.0, 8: 12.0}, 0.0))[0] == 0  # nothing accepted
    assert tool.choose(M(10.0, {0: 10.0, 8: 12.0}, 0.6))[0] == 0  # drafts cost the target
    m = M(0.5, {0: 10.0, 8: 11.0}, 0.5)  # moderate acceptance: shallow beats deep
    k, gain, _ = tool.choose(m)
    assert k in (2, 4) and gain > 0.02
    assert m.verify_cost(4) == pytest.approx(10.5) and m.verify_cost(0) == 10.0


def _compute_region(name):
    from repro_torch.core.adviser import Region

    # a chain-heavy scalar microtask, comfortably inside the smt2 band
    return Region(name, lambda x: x * 2.0, torch.arange(1024, dtype=torch.float32),
                  task_flops=100.0, task_bytes=512.0, task_chain=16)


def test_advisor_tool_is_silent_for_compute_regions():
    """As a pipeline stage the speculation tool SKIPs (no stage-log line)
    unless a region carries a measurement."""
    from repro_torch.core import Aira, Workload
    from repro_torch.core.overlap_model import CPU_HW

    d = Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [_compute_region("plain")])).decisions[0]
    assert d.accepted and not any("speculate" in line for line in d.stage_log)
    r2 = _compute_region("spec")
    r2.spec_measurement = ttools.SpecMeasurement(0.0, {0: 10.0, 8: 12.0}, 0.9)
    d2 = Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [r2])).decisions[0]
    assert any(line.startswith("speculate:") and "K=8" in line for line in d2.stage_log)


def test_kernel_advisor_prices_measured_cost():
    tool, KM = ttools.KernelAdvisorTool(), ttools.KernelMeasurement
    backend, gain, log = tool.choose(KM.make("dense", "paged", 0, {"reference": 2.0, "kernel": 1.0}))
    assert backend == "kernel" and gain == pytest.approx(1.0)
    assert "paged" in log and "kernel" in log
    assert tool.choose(KM.make("dense", "slot", 0, {"reference": 1.0, "kernel": 0.99}))[0] == "reference"
    backend, gain, _ = tool.choose(KM.make("dense", "slot", 4, {"reference": 1.0, "kernel": 3.0}))
    assert backend == "reference" and gain == 0.0
    with pytest.raises(ValueError, match="reference"):
        KM.make("dense", "slot", 0, {"kernel": 1.0})


def test_kernel_advisor_is_silent_for_compute_regions():
    from repro_torch.core import Aira, Workload
    from repro_torch.core.overlap_model import CPU_HW

    d = Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [_compute_region("plain")])).decisions[0]
    assert d.accepted and not any("kernel" in line for line in d.stage_log)
    r2 = _compute_region("measured")
    r2.kernel_measurement = ttools.KernelMeasurement.make(
        "dense", "paged", 0, {"reference": 2.0, "kernel": 0.8})
    d2 = Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [r2])).decisions[0]
    assert any(line.startswith("kernel:") and "→ kernel" in line for line in d2.stage_log)


def test_advise_depth_end_to_end(pair):
    """Probe-measure a self-repetitive workload and honour the decision:
    a SpecConfig from the candidates, served with the greedy stream
    unchanged."""
    jcfg, _, _, _, tm, tp, _ = pair
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)

    def workload():
        return [Request(prompt=prompts[i], max_new_tokens=10) for i in range(2)]

    eng = ServingEngine(tm, tp, max_seq=64, device="cpu")
    base = eng.serve(workload(), max_batch=2)
    spec, meas, log = advise_depth(eng, workload, ks=(0, 2, 4), max_batch=2)
    assert spec.k in (0, 2, 4) and 0.0 <= meas.acceptance_rate <= 1.0 and "K=" in log
    assert set(meas.verify_ms) == {0, 4}
    out = eng.serve(workload(), max_batch=2, spec=spec)
    assert_same([v for _, v in sorted(out.items())], [v for _, v in sorted(base.items())])


# ---------------------------------------------------------------------------
# the drifting workload


def test_drift_requests_match_jax():
    reqs, spans = make_drift_requests(vocab=500, rng=np.random.default_rng(5))
    jreqs, jspans = j_drift(vocab=500, rng=np.random.default_rng(5))
    assert spans == jspans == [("repetitive", 0, 6), ("churn", 6, 14), ("shared-prefix", 14, 20)]
    for r, j in zip(reqs, jreqs):
        np.testing.assert_array_equal(np.asarray(r.prompt), np.asarray(j.prompt))
        assert (r.max_new_tokens, r.arrival_time) == (j.max_new_tokens, j.arrival_time)
    prefix = np.asarray(reqs[14].prompt[:16])
    assert all(np.array_equal(np.asarray(r.prompt[:16]), prefix) for r in reqs[14:])
