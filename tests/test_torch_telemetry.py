"""The port's flight recorder against the JAX package's on the CPU, at
reduced smollm-135m (JAX parameters carried over), paged layout,
``max_seq`` 64: the tracer's ring bound and Chrome export (the same events
render to the same JSON in both packages), the validator's rejections, the
hard off switch (telemetry on == off token streams, no events and no ticks
when disabled), profiler ranges around the serving phases, the trace well
formed under random open-loop traffic (one begin and one end per request,
step and phase spans nested), preemption events, the adviser's pipeline
stage spans and decisions and the backend resolutions on the adviser and
backend lanes, and ``serving_summary()`` / the registry's metric names
equal to what the JAX engine produces for the same workload on a step
clock."""
import collections
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import PinnedController as JPinned
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve import telemetry as jtel
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import (
    PinnedController,
    Request,
    ServingEngine,
    SpecConfig,
    Telemetry,
    Tracer,
    validate_chrome_trace,
)
from repro_torch.serve import telemetry as ttel

KW = dict(max_seq=64, kv_layout="paged", block_size=8)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    te = ServingEngine(tm, tp, device="cpu", **KW)
    return jcfg, jm, jp, tm, tp, te


def _workload(R, vocab, specs=((8, 4), (12, 6), (8, 5), (16, 3)), arrival=0.0):
    rng = np.random.default_rng(7)
    return [R(prompt=rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=t,
              arrival_time=arrival * i) for i, (n, t) in enumerate(specs)]


def drive(sched, reqs, dt=0.01):
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


# ---------------------------------------------------------------------------
# tracer: ring bound, export, validator


def test_tracer_ring_bound_never_exceeded():
    tr = Tracer(capacity=16)
    for i in range(200):
        tr.complete(f"e{i}", "t", float(i), 1.0)
    assert len(tr) == 16
    # the oldest go first: the survivors are the newest 16
    assert tr.events[0][1] == "e184" and tr.events[-1][1] == "e199"
    assert validate_chrome_trace(tr.to_chrome_trace())["spans"] == 16


def test_chrome_export_matches_jax():
    """The same recorded events render to the same Chrome JSON in both
    packages, but for the process's name."""
    tr, jtr = Tracer(), jtel.Tracer()
    for t in (tr, jtr):
        t.complete("step", "sched", 10.0, 5.25, args={"seq": 1})
        t.instant("online-decision", "adviser", tid=ttel.TID_ADVISER, args={"k": 2}, ts_us=12.0)
        t.async_begin("request", 3, "request", ts_us=1.0)
        t.async_instant("admit", 3, "request", ts_us=2.0)
        t.async_end("request", 3, "request", args={"tokens": 4}, ts_us=20.0)
    got, want = tr.to_chrome_trace(), jtr.to_chrome_trace()
    assert got["traceEvents"][0]["args"]["name"] == "repro_torch.serve"
    got["traceEvents"][0]["args"]["name"] = want["traceEvents"][0]["args"]["name"]
    assert got == want
    assert validate_chrome_trace(got) == jtel.validate_chrome_trace(want)
    assert (ttel.TID_STEP, ttel.TID_REQUEST, ttel.TID_ADVISER, ttel.TID_BACKEND) == (
        jtel.TID_STEP, jtel.TID_REQUEST, jtel.TID_ADVISER, jtel.TID_BACKEND)


BAD_TRACES = {
    "traceEvents": {"nope": 1},
    "bad ph": [{"name": "x", "ph": "Z", "ts": 0, "pid": 1, "tid": 0}],
    "dur": [{"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 0}],
    "async end": [{"name": "x", "ph": "e", "ts": 0, "pid": 1, "tid": 0, "id": 3, "cat": "r"}],
    "negative ts": [{"name": "x", "ph": "i", "ts": -1, "pid": 1, "tid": 0}],
    "pid/tid": [{"name": "x", "ph": "i", "ts": 0}],
    "without id": [{"name": "x", "ph": "b", "ts": 0, "pid": 1, "tid": 0}],
}


@pytest.mark.parametrize("match", list(BAD_TRACES))
def test_validator_rejects_malformed(match):
    with pytest.raises(ValueError, match=match):
        validate_chrome_trace(BAD_TRACES[match])
    with pytest.raises(ValueError, match=match):
        jtel.validate_chrome_trace(BAD_TRACES[match])


def test_export_round_trips_through_json(tmp_path):
    tr = Tracer()
    tr.async_begin("request", 1, "request")
    tr.instant("mark", "sched")
    tr.async_end("request", 1, "request")
    path = tmp_path / "trace.json"
    tr.export(str(path))
    loaded = json.loads(path.read_text())
    counts = validate_chrome_trace(loaded)
    assert counts["async_spans"] == 1 and counts["instants"] == 1
    assert loaded["displayTimeUnit"] == "ms"


# ---------------------------------------------------------------------------
# the hard off switch, and profiler ranges


def test_off_switch_token_identity_and_no_events(pair):
    cfg, _, _, _, _, te = pair
    spec = SpecConfig(k=2)
    off, on = Telemetry(enabled=False), Telemetry(enabled=True)
    out_off = te.serve(_workload(Request, cfg.vocab_size), max_batch=2, spec=spec, telemetry=off)
    assert len(off.tracer) == 0
    assert te.stats.registry.ticks == 0  # disabled: no tick a step
    assert "sched.active" not in te.stats.registry.snapshot()["gauges"] or \
        te.stats.registry.snapshot()["gauges"]["sched.active"] is None
    out_on = te.serve(_workload(Request, cfg.vocab_size), max_batch=2, spec=spec, telemetry=on)
    assert len(on.tracer) > 0 and te.stats.registry.ticks > 0
    for a, b in zip(out_off.values(), out_on.values()):
        np.testing.assert_array_equal(a, b)
    window = te.stats.registry.window_summary(8)
    assert window["admitted"] > 0 and window["step_cost_ms"] > 0
    assert 0.0 <= window["acceptance_rate"] <= 1.0 and window["pool_occupancy"] >= 0.0


def test_profiler_annotations_wrap_the_serving_phases(pair):
    """With ``profiler_annotations`` the prefill, decode, draft and verify
    phases appear as ``torch.profiler`` ranges; the tokens do not change;
    a disabled or unannotated recorder shares one no-op context."""
    cfg, _, _, _, _, te = pair
    base = te.serve(_workload(Request, cfg.vocab_size), max_batch=2, spec=SpecConfig(k=2))
    tel = Telemetry(enabled=True, profiler_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = te.serve(_workload(Request, cfg.vocab_size), max_batch=2, spec=SpecConfig(k=2),
                       telemetry=tel)
    for a, b in zip(base.values(), out.values()):
        np.testing.assert_array_equal(a, b)
    names = {e.key for e in prof.key_averages()}
    assert {"serve.prefill", "serve.draft", "serve.verify"} <= names
    off = Telemetry(enabled=False, profiler_annotations=True)
    assert off.annotate("x") is off.annotate("y") is Telemetry(enabled=True).annotate("z")


# ---------------------------------------------------------------------------
# the step as a tree of spans, the padding counters, the shared clock


STEP_PHASES = {"admit", "prefill_chunk", "decode", "draft", "verify", "sample", "commit"}
DECODE_PARTS = {"decode.prep", "decode.launch", "decode.wait"}
SERVE_KW = {"plain": {}, "spec": {"spec": SpecConfig(k=2)}, "chunk": {"chunk_size": 8}}


def _spans(tel):
    """seq → [(name, ts, end, args)] of the step lane's spans."""
    out = collections.defaultdict(list)
    for ph, name, _, ts, dur, tid, _, args in tel.tracer.events:
        if ph == "X" and tid == ttel.TID_STEP:
            out[args["seq"]].append((name, ts, ts + dur, args))
    return out


def _tile(parts, a, b, tol=1.0):
    """``parts`` (sorted by start) abut and cover [a, b] within ``tol`` µs."""
    parts = sorted(parts, key=lambda p: p[1])
    assert parts and abs(parts[0][1] - a) <= tol and abs(parts[-1][2] - b) <= tol
    for p, q in zip(parts, parts[1:]):
        assert abs(p[2] - q[1]) <= tol, (p[0], q[0])


@pytest.mark.parametrize("mode", list(SERVE_KW))
def test_phase_spans_tile_each_step(pair, mode):
    """Each step's phases tile its span (a decode's parts tile the decode,
    each prefill lies inside admission), every span carries the step's
    seq, and host_ms is the step's duration less its waits: the decode's
    wait, the readbacks and each first token's sampling. On the CPU the
    device time is the launches' host time."""
    cfg, _, _, _, _, te = pair
    tel = Telemetry(enabled=True)
    drive(te.scheduler(2, telemetry=tel, **SERVE_KW[mode]), _workload(Request, cfg.vocab_size))
    steps = _spans(tel)
    assert steps and sorted(steps) == list(range(1, len(steps) + 1))
    seen = set()
    for seq, spans in steps.items():
        (step,) = [s for s in spans if s[0] == "step"]
        _, a, b, args = step
        phases = [s for s in spans if s[0] in STEP_PHASES]
        _tile(phases, a, b)
        seen |= {s[0] for s in spans}
        for dec in (s for s in spans if s[0] == "decode"):
            _tile([s for s in spans if s[0] in DECODE_PARTS], dec[1], dec[2])
        (admit,) = [s for s in phases if s[0] == "admit"]
        pre = [s for s in spans if s[0] == "prefill"]
        assert all(admit[1] <= p[1] and p[2] <= admit[2] for p in pre)
        # trace µs are Unix time: a quarter of a µs apart at today's dates
        if pre:
            assert admit[3]["self_ms"] == pytest.approx(
                (admit[2] - admit[1] - sum(p[2] - p[1] for p in pre)) / 1e3, abs=2e-3)
        assert args["host_ms"] == pytest.approx((b - a) / 1e3 - args["wait_ms"], abs=2e-3)
        waits = sum(s[2] - s[1] for s in spans if s[0] in ("decode.wait", "sample")) / 1e3
        assert args["wait_ms"] >= waits - 2e-3
        assert args["device_ms"] == args["launch_ms"] > 0
        launch = sum(s[2] - s[1] for s in spans if s[0] == "decode.launch") / 1e3
        assert args["launch_ms"] >= launch - 2e-3
    want = {"plain": {"decode", "sample", "commit", "prefill"} | DECODE_PARTS,
            "spec": {"draft", "verify", "commit", "prefill"},
            "chunk": {"prefill_chunk", "decode", "sample"}}[mode]
    assert want <= seen


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 250, size=n).astype(np.int32)


@pytest.mark.parametrize("mode,lengths,pads", [
    ("plain", (9, 12, 16, 5), (7, 4, 0, 3)),  # each prompt to its pow2 width
    ("chunk", (9, 13), (0, 3)),  # chunks of 8: 8 + 1 at widths 8 and 1; 8 + 5 at 8 and 8
])
def test_prefill_pad_counters_exact(pair, mode, lengths, pads):
    """Pads = width less real tokens at every padded call, counted on the
    request, recorder on or off; a recorded monolithic prefill's span gives
    its real tokens and width."""
    _, _, _, _, _, te = pair
    kw = {"chunk_size": 8} if mode == "chunk" else {}
    for on in (False, True):
        reqs = [Request(prompt=_prompt(n, i), max_new_tokens=3, arrival_time=0.05 * i)
                for i, n in enumerate(lengths)]
        tel = Telemetry(enabled=on)
        drive(te.scheduler(2, telemetry=tel, **kw), reqs)
        assert [r.prefill_tokens for r in reqs] == list(lengths)
        assert [r.prefill_pad for r in reqs] == list(pads)
    pre = [s[3] for spans in _spans(tel).values() for s in spans if s[0] == "prefill"]
    if mode == "plain":
        assert sum(a["tokens"] for a in pre) == sum(lengths)
        assert sum(a["W"] * len(np.atleast_1d(a["rid"])) - a["tokens"] for a in pre) == sum(pads)


def test_prefix_suffix_prefill_counts_its_suffix(pair):
    """A prefix hit prefills only the suffix, padded to its own width: 8
    cached tokens and 3 more run at width 4, one pad."""
    _, _, _, _, _, te = pair
    first = _prompt(12, 0)
    reqs = [Request(prompt=first, max_new_tokens=2),
            Request(prompt=np.concatenate([first[:8], _prompt(3, 1)]), max_new_tokens=2,
                    arrival_time=0.2)]
    tel = Telemetry(enabled=True)
    drive(te.scheduler(2, telemetry=tel), reqs)
    assert reqs[1].prefix_hit == 8
    assert (reqs[1].prefill_tokens, reqs[1].prefill_pad) == (3, 1)
    (pre,) = [s for spans in _spans(tel).values() for s in spans
              if s[0] == "prefill" and s[3]["rid"] == reqs[1].rid]
    assert (pre[3]["tokens"], pre[3]["W"], pre[3]["hit"]) == (3, 4, 8)


def test_spans_and_profiler_ranges_share_a_clock(pair):
    """With ``profiler_annotations`` every span but the decode's launch is
    also a ``serve.<name>`` range (the launch's kernels lie in
    ``serve.decode``); exported span and range of the same phase agree
    within 100 µs on the profiler's clock (the median over a phase's spans,
    so that a worker descheduled between a range's start and the span's
    clock reading does not decide it)."""
    cfg, _, _, _, _, te = pair
    tel = Telemetry(enabled=True, profiler_annotations=True)
    sched = te.scheduler(2, telemetry=tel)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drive(sched, _workload(Request, cfg.vocab_size))
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("serve."):
            ranges[e.name()[len("serve."):]].append((e.start_ns() / 1e3, e.end_ns() / 1e3))
    spans = collections.defaultdict(list)
    for e in tel.tracer.to_chrome_trace()["traceEvents"]:
        if e["ph"] == "X":
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    assert set(spans) == set(ranges) | {"decode.launch"}
    assert set(ranges) >= {"step", "admit", "prefill", "sample", "commit", "decode",
                           "decode.prep", "decode.wait"}
    for name, want in ranges.items():
        got, want = sorted(spans[name]), sorted(want)
        assert len(got) == len(want), name
        starts = [abs(a - c) for (a, _), (c, _) in zip(got, want)]
        ends = [abs(b - d) for (_, b), (_, d) in zip(got, want)]
        assert np.median(starts) < 100 and np.median(ends) < 100, (name, starts, ends)


def test_recorder_off_records_nothing(pair, monkeypatch):
    """Off, a step creates no span, no trace event and no CUDA event, and
    the tokens are those of a recorded run."""
    cfg, _, _, _, _, te = pair
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    monkeypatch.setattr(ttel.StepTrace, "__init__",
                        lambda *a, **k: pytest.fail("a step was recorded"))
    off = Telemetry(enabled=False, profiler_annotations=True)
    sched = te.scheduler(2, telemetry=off)
    got = drive(sched, _workload(Request, cfg.vocab_size))
    assert len(off.tracer) == 0 and not made
    assert sched._st is None and sched._step_events is None
    monkeypatch.undo()
    on = drive(te.scheduler(2, telemetry=Telemetry(enabled=True)),
               _workload(Request, cfg.vocab_size))
    for a, b in zip(got, on):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the same workload, both packages: summary schema and metric names


# the registry's counters and the step lane's spans against the JAX
# engine's: three of its counters that nothing read are gone from the port,
# which records the phases of a step that the JAX trace leaves in one span
# (a prefill inside admission, the decode's parts, the commit after
# sampling) and an admit span on every working step; the spans whose
# meaning both share are held one for one
REMOVED_COUNTERS = {"prefix.lookups", "prefix.hit_blocks", "pool.share"}
PORT_SPANS = {"prefill", "decode.prep", "decode.launch", "decode.wait", "commit"}
SHARED_SPANS = {"step", "decode", "sample", "draft", "verify"}


def test_golden_serving_summary_schema(pair):
    """The port's serving_summary() has the keys, the speculative section
    and the deterministic counts the JAX engine gives the same workload on
    this tree (a step clock for both); the registry holds the same metric
    names but ``REMOVED_COUNTERS``; the trace holds the same request and
    instant events and ``SHARED_SPANS`` by name and count, and the other
    spans by name with ``PORT_SPANS``."""
    cfg, jm, jp, tm, tp, _ = pair
    te, je = ServingEngine(tm, tp, device="cpu", **KW), JEngine(jm, jp, **KW)  # fresh registries
    V = cfg.vocab_size
    for telemetry in (False, True):
        t, jt = Telemetry(enabled=telemetry), jtel.Telemetry(enabled=telemetry)
        drive(te.scheduler(2, spec=SpecConfig(k=2), telemetry=t), _workload(Request, V))
        drive(je.scheduler(2, spec=JSpec(k=2), telemetry=jt), _workload(JRequest, V))
        s, js = te.stats.serving_summary(), je.stats.serving_summary()
        assert sorted(s) == sorted(js)
        assert sorted(s["speculative"]) == sorted(js["speculative"])
        for key in ("n_requests", "n_steps", "empty", "prompt_tokens", "prefix_hit_tokens",
                    "prefix_hit_rate", "n_prefix_hits", "preemptions", "recomputed_tokens",
                    "rejected_submissions"):
            assert s[key] == js[key], key
        for key in ("k", "acceptance_rate", "proposed", "accepted", "spec_steps"):
            assert s["speculative"][key] == js["speculative"][key], key
        for key in s:
            if key.startswith(("p50_", "p99_")):
                assert s[key] is None or isinstance(s[key], float), key
        snap, jsnap = te.stats.registry.snapshot(), je.stats.registry.snapshot()
        want = {"counters": set(jsnap["counters"]), "gauges": set(jsnap["gauges"]),
                "series": set(jsnap["series"])}
        if telemetry:
            want["counters"] -= REMOVED_COUNTERS
        for part in ("counters", "gauges", "series"):
            assert set(snap[part]) == want[part], part
        assert snap["ticks"] == jsnap["ticks"]
        if telemetry:
            # the lifecycle and instant events and the shared spans one for
            # one (the speculative run, then a plain decode run, whose new
            # step family the port's retrace watch counts), the other spans
            # by name
            def counts(events, skip=("retrace",)):
                return collections.Counter((e[0], e[1]) for e in events if e[1] not in skip
                                           and (e[0] != "X" or e[1] in SHARED_SPANS))

            assert counts(t.tracer.events, ()) == counts(jt.tracer.events)
            n, jn = len(t.tracer), len(jt.tracer)
            drive(te.scheduler(2, telemetry=t), _workload(Request, V))
            drive(je.scheduler(2, telemetry=jt), _workload(JRequest, V))
            plain, jplain = list(t.tracer.events)[n:], list(jt.tracer.events)[jn:]
            assert counts(plain) == counts(jplain)
            assert {e[1] for e in t.tracer.events} >= SHARED_SPANS
            spans = {e[1] for e in t.tracer.events if e[0] == "X"}
            jspans = {e[1] for e in jt.tracer.events if e[0] == "X"}
            assert spans == jspans | PORT_SPANS
    # a controller adds its section, with the JAX engine's keys
    drive(te.scheduler(2, spec=SpecConfig(k=2), controller=PinnedController(2)),
          _workload(Request, V))
    drive(je.scheduler(2, spec=JSpec(k=2), controller=JPinned(2)), _workload(JRequest, V))
    s, js = te.stats.serving_summary(), je.stats.serving_summary()
    assert sorted(s) == sorted(js) and s["controller"] == js["controller"]


# ---------------------------------------------------------------------------
# trace well-formedness over random open-loop traffic


def _span_nesting_ok(spans):
    """Spans on one lane nest or are disjoint."""
    stack = []
    for ts, dur in sorted(spans, key=lambda s: (s[0], -s[1])):
        end = ts + dur
        while stack and ts >= stack[-1] - 1e-6:
            stack.pop()
        if stack and end > stack[-1] + 1e-6:
            return False
        stack.append(end)
    return True


@pytest.mark.parametrize("seed,n_requests,gap_ms", [(0, 3, 0.0), (1, 5, 5.0), (2, 6, 0.0),
                                                    (3, 4, 5.0)])
def test_trace_wellformed_random_traffic(pair, seed, n_requests, gap_ms):
    cfg, _, _, _, _, te = pair
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=int(rng.choice([8, 12])))
                    .astype(np.int32), max_new_tokens=int(rng.integers(2, 6)),
                    arrival_time=gap_ms * 1e-3 * i, priority=int(rng.integers(0, 2)))
            for i in range(n_requests)]
    tel = Telemetry(enabled=True)
    te.serve(reqs, max_batch=2, seed=seed, spec=SpecConfig(k=2), telemetry=tel)
    events = tel.tracer.events
    rids = {r.rid for r in reqs}
    begins = [e for e in events if e[0] == "b" and e[1] == "request"]
    ends = [e for e in events if e[0] == "e" and e[1] == "request"]
    assert {e[6] for e in begins} == rids
    assert sorted(e[6] for e in ends) == sorted(rids)  # one terminal event a request
    spans = [(e[3], e[4]) for e in events if e[0] == "X" and e[5] == ttel.TID_STEP]
    assert spans and _span_nesting_ok(spans)
    assert validate_chrome_trace(tel.tracer.to_chrome_trace())["async_spans"] == len(rids)
    # the ring bound holds under the same load
    tiny = Telemetry(enabled=True, capacity=24)
    te.serve([Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                      arrival_time=r.arrival_time, priority=r.priority) for r in reqs],
             max_batch=2, seed=seed, spec=SpecConfig(k=2), telemetry=tiny)
    assert len(tiny.tracer) <= 24


def test_preemption_events_in_trace(pair):
    """Block pressure: preempt and resume instants, and a terminal event
    for every request, the preempted ones too."""
    _, _, _, tm, tp, _ = pair
    eng = ServingEngine(tm, tp, max_seq=128, kv_layout="paged", max_batch=2, block_size=8,
                        num_blocks=10, device="cpu")
    low = [Request(prompt=np.arange(20, dtype=np.int32) + i, max_new_tokens=10, priority=0)
           for i in range(2)]
    high = [Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, arrival_time=0.02,
                    priority=5)]
    tel = Telemetry(enabled=True)
    drive(eng.scheduler(2, telemetry=tel), low + high)
    assert eng.stats.n_preemptions > 0, "the pressure scenario did not evict"
    names = [e[1] for e in tel.tracer.events]
    assert "preempt" in names and "resume" in names
    ends = [e for e in tel.tracer.events if e[0] == "e"]
    assert sorted(e[6] for e in ends) == sorted(r.rid for r in low + high)
    validate_chrome_trace(tel.tracer.to_chrome_trace())


# ---------------------------------------------------------------------------
# the adviser's audit trail and the backend lane


def test_advisor_decisions_annotated(monkeypatch):
    from repro_torch.core.tools import (
        KernelAdvisorTool,
        KernelMeasurement,
        SpecMeasurement,
        SpeculationAdvisorTool,
    )

    tel = Telemetry(enabled=True)
    monkeypatch.setattr(ttel, "GLOBAL", tel)
    before = ttel.global_registry().counter("adviser.decisions").value
    k, _, _ = SpeculationAdvisorTool().choose(SpecMeasurement(0.05, {0: 2.0, 8: 3.0}, 0.7))
    backend, _, _ = KernelAdvisorTool().choose(
        KernelMeasurement.make("llama", "paged", 2, {"reference": 2.0, "kernel": 1.0}))
    by_name = {e[1]: e for e in tel.tracer.events}
    spec_ev = by_name["speculation-decision"]
    assert spec_ev[5] == ttel.TID_ADVISER and spec_ev[7]["k"] == k
    assert spec_ev[7]["acceptance_rate"] == pytest.approx(0.7)
    assert spec_ev[7]["draft_ms_per_token"] == pytest.approx(0.05)
    kern_ev = by_name["kernel-backend-decision"]
    assert kern_ev[7]["backend"] == backend == "kernel"
    assert kern_ev[7]["step_ms"]["reference"] == pytest.approx(2.0)
    assert ttel.global_registry().counter("adviser.decisions").value == before + 2


def test_pipeline_stage_spans(monkeypatch):
    from repro_torch.core import Aira, Region, Workload
    from repro_torch.core.overlap_model import CPU_HW

    def region(name):
        return Region(name, lambda x: 2.0 * x + 1.0, torch.arange(4096, dtype=torch.float32),
                      task_flops=100.0, task_bytes=512.0, task_chain=16)

    tel = Telemetry(enabled=True)
    monkeypatch.setattr(ttel, "GLOBAL", tel)
    Aira(hw=CPU_HW).advise(Workload("w", lambda: None, [region("audit")]))
    stage_events = [e for e in tel.tracer.events
                    if e[0] == "X" and e[5] == ttel.TID_ADVISER and e[1].startswith("tool:")]
    stages = [e[1] for e in stage_events]
    assert "tool:profile" in stages and "tool:simulate" in stages
    assert "tool:speculate" not in stages  # a compute region: the serving tools skip
    for e in stage_events:
        assert e[7]["region"] == "audit" and e[7]["verdict"] in ("pass", "reject")
    silent = Telemetry(enabled=False)
    monkeypatch.setattr(ttel, "GLOBAL", silent)
    Aira(hw=CPU_HW).advise(Workload("w2", lambda: None, [region("silent")]))
    assert len(silent.tracer) == 0


def test_backend_resolution_annotated(monkeypatch):
    import repro_torch.kernels.ops as ops

    tel = Telemetry(enabled=True)
    monkeypatch.setattr(ttel, "GLOBAL", tel)
    monkeypatch.setattr(ops, "_KERNEL_MODE", None)  # force fresh resolutions
    monkeypatch.setattr(ops, "_ATTN_BACKEND", None)
    before = ttel.global_registry().counter("backend.resolutions").value
    ops.default_kernel_mode()
    ops.resolve_attention_backend(None, torch.device("cpu"))
    events = [e for e in tel.tracer.events if e[5] == ttel.TID_BACKEND]
    assert [e[1] for e in events] == ["kernel-mode-resolved", "attention-backend-resolved"]
    assert events[1][7]["resolved"] in ("auto", "reference", "kernel")
    assert ttel.global_registry().counter("backend.resolutions").value == before + 2
    # a resolution with the recorder off leaves nothing
    monkeypatch.setattr(ttel, "GLOBAL", Telemetry(enabled=False))
    monkeypatch.setattr(ops, "_KERNEL_MODE", None)
    ops.default_kernel_mode()
    assert ttel.global_registry().counter("backend.resolutions").value == before + 2
