"""The port's adviser core (``repro_torch.core``) against the JAX
package's ``repro.core`` on the CPU: the overlap model and the schedule
choice to 1e-12, ``relic_pfor`` (dealing, padding, ``stack``/``sum``,
``valid``), the static report's ``trivially_parallel`` and the dynamic
conflict check on every benchmark region, the pipeline's decisions under
``SpecPolicy`` against ``tests/golden_aira_decisions.json``, and the
policy seam (a recorded decision stream replays).

Data comes from the same numpy seeds on both sides (the benchmarks'
``build`` functions; ``np.random.default_rng`` items here). Tolerances: the model's
arithmetic is the same float64 Python on both sides, held to 1e-12
relative; ``relic_pfor`` over float32 items to 1e-6 (the per-item
arithmetic is the same, sums run in another order), integer and boolean
results exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench_suite import BENCHMARKS as J_BENCH
from repro.core import Aira as JAira
from repro.core import deps as jdeps
from repro.core.overlap_model import CPU_HW as J_CPU_HW
from repro.core.overlap_model import HwModel as JHwModel
from repro.core.overlap_model import Microtask as JMicrotask
from repro.core.overlap_model import OverlapModel as JOverlapModel
from repro.core.relic import choose_schedule as j_choose
from repro.core.relic import relic_pfor as j_pfor
from repro_torch.bench_suite import BENCHMARKS as T_BENCH
from repro_torch.core import (
    CPU_HW,
    Aira,
    HwModel,
    Microtask,
    OverlapModel,
    RecordingPolicy,
    Region,
    ReplayPolicy,
    SpecPolicy,
    Workload,
    advise_suite,
    choose_schedule,
    clear_plan_cache,
    plan_cache_stats,
    relic_pfor,
)
from repro_torch.core import deps as tdeps
from repro_torch.core.spec import AIRA_SPEC, RELIC_EXAMPLES
from repro_torch.core.tools import DEFAULT_TOOLS

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_aira_decisions.json")
NAMES = list(J_BENCH)


@pytest.fixture(scope="module")
def suite():
    """The port's advisory run over the ten benchmarks, data on the CPU."""
    clear_plan_cache()
    return advise_suite(hw=CPU_HW, device="cpu")


@pytest.fixture(scope="module")
def regions(suite):
    """name → (JAX region, port region), each built from the same seed."""
    out = {}
    for name in NAMES:
        jb = J_BENCH[name]
        out[name] = (jb.region(jb.build()), T_BENCH[name].region(suite[name].data))
    return out


# ---------------------------------------------------------------------------
# the overlap model


def test_default_hw_model_is_the_papers_core():
    """The port's HwModel() defaults are CPU_HW's values: the JAX package's
    default (a TPU preset) is not carried across."""
    assert HwModel() == CPU_HW
    for f in JHwModel.__dataclass_fields__:
        assert getattr(CPU_HW, f) == getattr(J_CPU_HW, f), f


def _grid():
    for flops in (0.0, 24.0, 640.0, 4e3):
        for nbytes in (0.0, 48.0, 4096.0):
            for chain in (0, 1, 34, 3000):
                for vector in (True, False):
                    yield flops, nbytes, chain, vector


@pytest.mark.parametrize("hw", ["cpu", "jax_default"])
def test_overlap_model_and_schedule_match_jax(hw):
    """predict's three schedules and choose_schedule's pick over a grid of
    microtasks and item counts, priced for the paper's core and for the
    JAX package's default HwModel (its fields passed explicitly)."""
    j_hw = J_CPU_HW if hw == "cpu" else JHwModel()
    t_hw = HwModel(**{f: getattr(j_hw, f) for f in JHwModel.__dataclass_fields__})
    jm, tm = JOverlapModel(j_hw), OverlapModel(t_hw)
    for flops, nbytes, chain, vector in _grid():
        for n in (1, 15, 256, 8192):
            jp = jm.predict(JMicrotask(flops, nbytes, chain, vector), n)
            tp = tm.predict(Microtask(flops, nbytes, chain, vector), n)
            for s in ("serial", "smt2", "smp2"):
                assert getattr(tp, s) == pytest.approx(getattr(jp, s), rel=1e-12, abs=1e-300)
            js = j_choose(jm, flops, nbytes, n, chain=chain, vector=vector)
            ts = choose_schedule(tm, flops, nbytes, n, chain=chain, vector=vector)
            assert (ts.granularity, ts.n_streams, ts.strategy) == (
                js.granularity, js.n_streams, js.strategy)
            assert ts.describe() == js.describe()


# ---------------------------------------------------------------------------
# relic_pfor


def _items(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    k = rng.integers(0, 7, size=(n,)).astype(np.int32)
    return x, k


def _j_fn(item):
    x, k = item
    return {"y": jnp.sin(x) * k, "hit": (k > 3).astype(jnp.int32), "k": k * 2}


def _t_fn(item):
    x, k = item
    return {"y": torch.sin(x) * k, "hit": (k > 3).to(torch.int32), "k": k * 2}


@pytest.mark.parametrize("combine", ["stack", "sum"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("n,g,streams", [
    (13, 3, 2),     # n not a multiple of streams x granularity: padded by the last item
    (16, 4, 2),     # whole chunks
    (5, 8, 2),      # granularity above n
    (21, 2, 3),     # three streams
    (1, 1, 2),
])
def test_relic_pfor_matches_jax(n, g, streams, combine, masked):
    x, k = _items(n, seed=n * 10 + g)
    valid = np.random.default_rng(n).integers(0, 2, size=(n,)).astype(bool) if masked else None
    want = j_pfor(_j_fn, (jnp.asarray(x), jnp.asarray(k)), granularity=g, n_streams=streams,
                  combine=combine, valid=valid)
    got = relic_pfor(_t_fn, (torch.from_numpy(x), torch.from_numpy(k)), granularity=g,
                     n_streams=streams, combine=combine,
                     valid=None if valid is None else torch.from_numpy(valid))
    assert set(got) == set(want)
    for key in want:
        w, t = np.asarray(want[key]), got[key].numpy()
        assert t.shape == w.shape, key
        if key == "y":
            np.testing.assert_allclose(t, w, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            assert t.dtype == w.dtype, key  # int32 sums stay int32, as jnp.sum keeps them
            np.testing.assert_array_equal(t, w, err_msg=key)


def test_relic_pfor_refuses_unknown_combine():
    with pytest.raises(ValueError, match="combine"):
        relic_pfor(lambda x: x, torch.zeros(4), granularity=1, combine="max")


@pytest.mark.parametrize("ex", RELIC_EXAMPLES, ids=[e["name"] for e in RELIC_EXAMPLES])
def test_relic_examples_restructure_like_vmap(ex):
    """The spec's 20 Relic examples: relic_pfor at granularity 3 (padded)
    gives vmap(fn)'s result exactly (the same per-item arithmetic)."""
    items = ex["items"](device="cpu")
    want = torch.func.vmap(ex["fn"])(items)
    got = relic_pfor(ex["fn"], items, granularity=3)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_spec_stages_and_tools():
    assert [s.name for s in AIRA_SPEC] == [
        "profile", "annotate", "static_deps", "dynamic_deps", "simulate", "restructure"]
    assert [t.name for t in DEFAULT_TOOLS] == [
        "profile", "static", "dynamic", "simulate", "restructure", "speculate", "kernel"]


# ---------------------------------------------------------------------------
# dependences


@pytest.mark.parametrize("name", NAMES)
def test_static_report_agrees_with_jax(regions, name):
    """The aten-graph walk's verdict equals the jaxpr walk's on each
    benchmark region; the port's graph holds loops unrolled (0 loops)."""
    jr, tr = regions[name]
    jrep = jdeps.static_deps(jr.fn, jax.tree.map(lambda a: a[0], jr.items))
    trep = tdeps.static_deps(tr.fn, torch.utils._pytree.tree_map(lambda a: a[0], tr.items))
    assert trep.trivially_parallel == jrep.trivially_parallel
    assert (trep.shared_scatters > 0) == (jrep.shared_scatters > 0)
    assert trep.loops == trep.loop_carried == 0


@pytest.mark.parametrize("name", [n for n in NAMES if J_BENCH[n].trace is not None])
def test_dynamic_traces_and_conflicts_match_jax(regions, name):
    jr, tr = regions[name]
    assert len(tr.trace.reads) == len(jr.trace.reads)
    for a, b in zip(tr.trace.reads + tr.trace.writes, jr.trace.reads + jr.trace.writes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for tasks in (2, 3):
        assert tdeps.check_conflicts(tr.trace, tasks) == jdeps.check_conflicts(jr.trace, tasks)


def test_static_report_sees_writes_into_shared_storage():
    """A write into an argument or a closed-over tensor is shared (in place
    or as an updated copy); one into a tensor the function made is not."""
    ring = torch.zeros(8)

    def closure_write(i):
        return ring.index_put((i % 8,), torch.tensor(1.0), accumulate=True).sum()

    def arg_write(x):
        x[0] = 1.0
        return x

    def local_write(i):
        return torch.zeros(8).index_put((i % 8,), torch.tensor(1.0)).sum()

    i = torch.tensor(3)
    assert not tdeps.static_deps(closure_write, i).trivially_parallel
    assert not tdeps.static_deps(arg_write, torch.zeros(4)).trivially_parallel
    rep = tdeps.static_deps(local_write, i)
    assert rep.trivially_parallel and rep.scatters == 1


# ---------------------------------------------------------------------------
# the pipeline


def test_golden_suite_decisions(suite):
    """Every benchmark's decision — accepted, strategy, granularity,
    predicted gain to 6 places — equals the checked-in golden file, and
    accepted decisions carry a plan."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert set(suite) == set(golden)
    for name, want in golden.items():
        d = suite[name].decision
        got = {"accepted": d.accepted, "granularity": d.schedule.granularity,
               "predicted_gain": round(d.predicted_gain, 6), "strategy": d.schedule.strategy}
        assert got == want, (name, d.stage_log)
        assert (suite[name].plan is not None) == want["accepted"], name


def test_stage_logs_match_jax(suite, regions):
    """The stage logs equal the JAX pipeline's line for line, except the
    static report's summary (its graph is another framework's)."""
    aira = JAira(hw=J_CPU_HW)
    for name in NAMES:
        jd = aira.advise(Workload(name, lambda: None, [regions[name][0]])).decisions[0]
        got = [s for s in suite[name].decision.stage_log if not s.startswith("static:")]
        want = [s.replace("[plan hit]", "[plan miss]") for s in jd.stage_log
                if not s.startswith("static:")]
        got = [s.replace("[plan hit]", "[plan miss]") for s in got]
        assert got == want, name


def test_suite_advise_twice_hits_plan_cache(suite):
    before = plan_cache_stats()
    again = advise_suite(hw=CPU_HW, device="cpu")
    after = plan_cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] >= before["hits"] + sum(e.plan is not None for e in again.values())
    for name in suite:
        if suite[name].plan is not None:
            assert again[name].plan is suite[name].plan, name


def _accepted_region(fn, items, name):
    # chain-heavy scalar microtask: comfortably inside the smt2 band
    return Region(name, fn, items, task_flops=100.0, task_bytes=512.0, task_chain=16)


def test_recording_then_replay_policy():
    items = torch.arange(1024, dtype=torch.float32)
    region = _accepted_region(lambda x: x * 2.0, items, "rec")
    rec = RecordingPolicy(SpecPolicy())
    d1 = Aira(hw=CPU_HW, policy=rec).advise(Workload("w", lambda: None, [region])).decisions[0]
    assert d1.accepted
    # "speculate" and "kernel" ride in DEFAULT_TOOLS but skip (silently) for
    # compute regions; they still pass through the policy seat, as in JAX
    assert [stage for (_, stage, _, _) in rec.record] == [
        "profile", "static", "dynamic", "simulate", "restructure", "speculate", "kernel"]
    d2 = Aira(hw=CPU_HW, policy=ReplayPolicy(list(rec.record))).advise(
        Workload("w", lambda: None, [region])).decisions[0]
    assert d2.accepted == d1.accepted and d2.schedule.granularity == d1.schedule.granularity
    with pytest.raises(IndexError, match="exhausted"):
        Aira(hw=CPU_HW, policy=ReplayPolicy([])).advise(Workload("w", lambda: None, [region]))


def test_early_reject_and_force(suite, regions):
    """Fraud stops at the gate with no plan; forced, the same region logs
    the bypass, takes the forced smt2 schedule (half the items a chunk) as
    the JAX pipeline does, and carries a plan that executes like vmap."""
    fraud = suite["Fraud"].decision
    assert not fraud.accepted and fraud.plan is None and fraud.parallel_fn is None
    assert fraud.stage_log[-1].startswith("simulate: rejected")
    jr, tr = regions["Fraud"]
    jr.force = tr.force = True
    try:
        jd = JAira(hw=J_CPU_HW).advise(Workload("f", lambda: None, [jr])).decisions[0]
        d = Aira(hw=CPU_HW).advise(Workload("f", lambda: None, [tr])).decisions[0]
    finally:
        jr.force = tr.force = False
    assert d.accepted and any("force=True" in s for s in d.stage_log)
    assert (d.schedule.granularity, d.schedule.strategy) == (
        jd.schedule.granularity, jd.schedule.strategy) == (500, "smt2")
    want = torch.func.vmap(tr.fn)(tr.items).sum()  # the region's "sum" combine
    assert torch.equal(d.parallel_fn(), want)


def test_plan_executes_masked_and_on_fresh_items():
    clear_plan_cache()
    items = torch.arange(256, dtype=torch.float32).reshape(64, 4)
    d = Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [
        _accepted_region(lambda x: (x * 3.0).sum(), items, "fresh")])).decisions[0]
    assert d.accepted
    fresh = items + 7.0
    torch.testing.assert_close(d.plan.execute(fresh), (fresh * 3.0).sum(1))
    mask = torch.arange(64) % 3 == 0
    got = d.plan.execute_masked(fresh, mask)
    torch.testing.assert_close(got, torch.where(mask, (fresh * 3.0).sum(1), 0.0))
