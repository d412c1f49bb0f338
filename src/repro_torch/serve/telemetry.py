"""Serving flight recorder: structured tracing and windowed metrics.

Port of the JAX package's ``serve/telemetry.py``, copied so the port
imports nothing of that package:

``Tracer``
    A bounded ring-buffer flight recorder of trace events with monotonic
    (``time.perf_counter``) microsecond timestamps, appended as plain
    tuples into a ``deque(maxlen=capacity)``: recording launches nothing
    on the device and never synchronises, and the oldest events fall off
    the back under sustained load. ``export()`` writes Chrome/Perfetto
    trace-event JSON: per-step phase spans on the scheduler lane, each
    request's lifecycle as async ``"b"``/``"n"``/``"e"`` events keyed by
    its rid, the adviser's pipeline stages and decisions with their priced
    inputs, and backend resolutions as instant events. Its timestamps lie
    on ``torch.profiler``'s timeline (Unix-time µs), so an export lays over
    a device trace.

``StepTrace``
    One scheduler step as a tree of spans (the step, its phases, the
    prefills inside admission, the decode's prep, launch and wait), made
    only with the recorder on: it splits the step's time into host work,
    device waits and launches, and times its device work with two CUDA
    events that the step's own synchronise completes.

``MetricsRegistry``
    Counters, gauges and sample series shared with ``ServeStats``. The
    scheduler calls ``tick()`` once per working step when telemetry is on;
    each tick snapshots every counter and gauge into a bounded ring, so
    ``window_summary(n)`` answers "over the last n steps" — the signal
    vector ``serve.controller.OnlineAdviser`` prices.

``Telemetry``
    A tracer (and, optionally, ``torch.profiler.record_function`` ranges
    around each device-launching phase) behind one ``enabled`` flag, the
    hard off switch: disabled (the default), every instrumentation site
    on the serving hot path is one attribute check — no events, no ticks,
    no ranges. A module-global default (``get_telemetry``) serves call
    sites with no engine handle (the backend registry, the adviser tools);
    engines and schedulers take an explicit ``telemetry=``.

Standard library only (``torch.profiler`` is imported where a range
is opened), so ``core/`` and ``kernels/`` can reach it without an
import cycle through the serving package.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Series",
    "MetricsRegistry",
    "Tracer",
    "StepTrace",
    "Telemetry",
    "get_telemetry",
    "configure",
    "quantile",
    "validate_chrome_trace",
    "TID_STEP",
    "TID_REQUEST",
    "TID_ADVISER",
    "TID_BACKEND",
    "global_registry",
]

# One synthetic process, one thread lane per subsystem — fixed ids so
# Perfetto groups tracks deterministically across exports.
TRACE_PID = 1
TID_STEP = 0  # scheduler step + phase spans
TID_REQUEST = 1  # request lifecycle (async spans keyed by rid)
TID_ADVISER = 2  # ToolPipeline stages + advisor decisions
TID_BACKEND = 3  # kernel backend resolutions / mesh fallbacks

_THREAD_NAMES = {
    TID_STEP: "scheduler.step",
    TID_REQUEST: "requests",
    TID_ADVISER: "adviser",
    TID_BACKEND: "backend",
}

_NULL_CM = nullcontext()


def quantile(vals, p: float) -> float:
    """Linear-interpolated percentile (``p`` in [0, 100]) matching
    ``numpy.percentile``'s default method: rank ``(n-1)·p/100`` is
    interpolated between the two bracketing order statistics, so p99
    over a short series does NOT collapse to the max the way a
    nearest-rank estimator does.  Pure python on a sorted copy — used
    by both ``ServeStats.percentile`` and the registry windows."""
    vals = sorted(vals)
    n = len(vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(vals[0])
    rank = (n - 1) * (float(p) / 100.0)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


class Counter:
    """Monotonic (but resettable) cumulative value with a per-tick ring."""

    __slots__ = ("name", "value", "ring")

    def __init__(self, name: str, window: int):
        self.name = name
        self.value = 0.0
        self.ring: deque = deque(maxlen=window)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0
        self.ring.clear()


class Gauge:
    """Last-set value with a per-tick ring of samples."""

    __slots__ = ("name", "value", "ring")

    def __init__(self, name: str, window: int):
        self.name = name
        self.value: float | None = None
        self.ring: deque = deque(maxlen=window)

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = None
        self.ring.clear()


class Series(list):
    """Unbounded sample list (a real ``list`` so existing
    ``stats.step_ms.append(...)`` call sites keep working verbatim)
    with rolling-quantile helpers over its tail."""

    def __init__(self, name: str, iterable: Iterable[float] = ()):  # noqa: D107
        super().__init__(iterable)
        self.name = name

    def quantile(self, p: float, window: int | None = None) -> float:
        tail = self if window is None else self[-window:]
        return quantile(tail, p)


class MetricsRegistry:
    """Name → metric registry with per-step windows.

    Counters and gauges are cumulative/instantaneous; ``tick()`` (one
    call per scheduler step when telemetry is on) snapshots each into a
    bounded ring so windowed deltas/means need no timestamps.  Series
    are unbounded sample lists (ServeStats latency series) with
    rolling-quantile reads.  Metric objects are stable across
    ``reset()`` so hot-path call sites can cache them."""

    def __init__(self, window: int = 512):
        self.window = int(window)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._series: dict[str, Series] = {}
        self._ticks = 0

    # -- registration ------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, self.window)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self.window)
        return g

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(name)
        return s

    # -- windows -----------------------------------------------------
    @property
    def ticks(self) -> int:
        return self._ticks

    def tick(self) -> None:
        """Snapshot every counter/gauge into its ring (one scheduler
        step boundary).  O(#metrics) python appends, no device work."""
        self._ticks += 1
        for c in self._counters.values():
            c.ring.append(c.value)
        for g in self._gauges.values():
            if g.value is not None:
                g.ring.append(g.value)

    def window_delta(self, name: str, n: int) -> float:
        """Increase of counter ``name`` over the last ``n`` ticks."""
        ring = self._counters[name].ring if name in self._counters else None
        if not ring:
            return 0.0
        base = ring[-n - 1] if len(ring) > n else 0.0
        return float(ring[-1] - base)

    def window_mean(self, name: str, n: int) -> float:
        """Mean of gauge ``name`` over its last ``n`` tick samples."""
        ring = self._gauges[name].ring if name in self._gauges else None
        if not ring:
            return 0.0
        tail = list(ring)[-n:]
        return float(sum(tail) / len(tail))

    def series_quantile(self, name: str, p: float, n: int | None = None) -> float:
        s = self._series.get(name)
        return s.quantile(p, n) if s else 0.0

    def window_summary(self, n: int = 32) -> dict[str, Any]:
        """The online-adviser signal vector over the last ``n`` steps
        (``serve.controller.OnlineAdviser`` consumes this every
        decision interval): windowed speculation acceptance, the
        draft/verify cost split, queue depth, pool occupancy/pressure,
        and step cost, plus the admission/preemption/eviction rates
        that price a re-decision.  Purely a read — token streams are
        unaffected.

        Cold-start contract: every value is a well-defined finite float
        (or int) even with zero ticks, a window shorter than ``n``, or
        all-zero denominators — the controller reads this vector on
        step 1, before any speculation/prefill has happened, and 0.0
        means "no signal yet", never NaN/None."""
        proposed = self.window_delta("serve.spec_proposed", n)
        accepted = self.window_delta("serve.spec_accepted", n)
        prompt = self.window_delta("serve.prompt_tokens", n)
        hits = self.window_delta("serve.prefix_hit_tokens", n)
        eff = max(1, min(n, self._ticks))
        summary = {
            "window": min(n, self._ticks),
            "ticks": self._ticks,
            "acceptance_rate": accepted / proposed if proposed else 0.0,
            "proposed": proposed,
            "accepted": accepted,
            "spec_steps": self.window_delta("serve.spec_steps", n),
            "queue_depth": self.window_mean("sched.queue_depth", n),
            "active": self.window_mean("sched.active", n),
            "pool_occupancy": self.window_mean("pool.occupancy", n),
            "pool_free_blocks": self.window_mean("pool.free_blocks", n),
            "step_cost_ms": self.series_quantile("serve.step_ms", 50.0, n),
            "p99_step_ms": self.series_quantile("serve.step_ms", 99.0, n),
            "p50_draft_ms": self.series_quantile("serve.draft_ms", 50.0, n),
            "p50_verify_ms": self.series_quantile("serve.verify_ms", 50.0, n),
            "admitted": self.window_delta("sched.admitted", n),
            "preemptions": self.window_delta("serve.preemptions", n),
            "rejected": self.window_delta("serve.rejected_submissions", n),
            "prefix_hit_rate": hits / prompt if prompt else 0.0,
            "chunk_utilization": self.series_quantile("sched.chunk_util", 50.0, n),
            "alloc_rate": self.window_delta("pool.alloc", n) / eff,
            "evict_rate": self.window_delta("pool.evict", n) / eff,
            "park_rate": self.window_delta("pool.park", n) / eff,
            "retraces": self.window_delta("engine.retraces", n),
        }
        return {
            k: (v if isinstance(v, int) else (float(v) if math.isfinite(v) else 0.0))
            for k, v in summary.items()
        }

    # -- exposition --------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """JSON-ready dump of every metric's current state."""
        return {
            "ticks": self._ticks,
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "series": {
                n: {
                    "count": len(s),
                    "p50": s.quantile(50.0),
                    "p99": s.quantile(99.0),
                }
                for n, s in sorted(self._series.items())
            },
        }

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``.`` → ``_`` in names; series
        exported as summary quantiles + count)."""
        lines: list[str] = []
        for name, c in sorted(self._counters.items()):
            pname = name.replace(".", "_")
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {c.value:g}")
        for name, g in sorted(self._gauges.items()):
            if g.value is None:
                continue
            pname = name.replace(".", "_")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {g.value:g}")
        for name, s in sorted(self._series.items()):
            pname = name.replace(".", "_")
            lines.append(f"# TYPE {pname} summary")
            lines.append(f'{pname}{{quantile="0.5"}} {s.quantile(50.0):g}')
            lines.append(f'{pname}{{quantile="0.99"}} {s.quantile(99.0):g}')
            lines.append(f"{pname}_count {len(s)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero counters, clear gauges/series/rings IN PLACE — metric
        objects cached by hot-path call sites stay valid."""
        self._ticks = 0
        for c in self._counters.values():
            c.reset()
        for g in self._gauges.values():
            g.reset()
        for s in self._series.values():
            s.clear()


class Tracer:
    """Bounded ring-buffer flight recorder of Chrome trace events.

    Events are stored as tuples ``(ph, name, cat, ts_us, dur_us, tid,
    id, args)`` in a ``deque(maxlen=capacity)`` — appending is O(1) and
    the buffer can never exceed its bound (oldest events are dropped
    first, like a flight recorder).  Timestamps are microseconds on
    ``torch.profiler``'s clock, Unix time: ``perf_counter`` readings
    are carried over by one pairing of the two clocks, taken when the
    tracer starts and again at every ``clear()``, so a span and a
    ``record_function`` range of the same phase line up in one view."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._anchor()

    def _anchor(self) -> None:
        """Pair a ``perf_counter`` reading with the Unix clock: the
        midpoint of two counter readings around one ``time_ns()``."""
        a = time.perf_counter()
        unix_ns = time.time_ns()
        b = time.perf_counter()
        self._t0 = (a + b) / 2
        self._epoch_us = unix_ns / 1e3

    # -- recording ---------------------------------------------------
    def now_us(self) -> float:
        return self.to_us(time.perf_counter())

    def to_us(self, t: float) -> float:
        """Convert a raw ``time.perf_counter()`` reading to trace µs."""
        return self._epoch_us + (t - self._t0) * 1e6

    def complete(self, name, cat, ts_us, dur_us, tid=TID_STEP, args=None) -> None:
        self._events.append(("X", name, cat, ts_us, max(0.0, dur_us), tid, None, args))

    def instant(self, name, cat, tid=TID_STEP, args=None, ts_us=None) -> None:
        ts = self.now_us() if ts_us is None else ts_us
        self._events.append(("i", name, cat, ts, None, tid, None, args))

    def async_begin(self, name, id_, cat, args=None, ts_us=None) -> None:
        ts = self.now_us() if ts_us is None else ts_us
        self._events.append(("b", name, cat, ts, None, TID_REQUEST, id_, args))

    def async_instant(self, name, id_, cat, args=None, ts_us=None) -> None:
        ts = self.now_us() if ts_us is None else ts_us
        self._events.append(("n", name, cat, ts, None, TID_REQUEST, id_, args))

    def async_end(self, name, id_, cat, args=None, ts_us=None) -> None:
        ts = self.now_us() if ts_us is None else ts_us
        self._events.append(("e", name, cat, ts, None, TID_REQUEST, id_, args))

    # -- reading -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> list[tuple]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._anchor()

    def chrome_events(self) -> list[dict[str, Any]]:
        """Render the ring to Chrome trace-event dicts, prefixed by
        process/thread metadata so Perfetto labels the tracks."""
        out: list[dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": TRACE_PID,
                "tid": 0,
                "args": {"name": "repro_torch.serve"},
            }
        ]
        for tid, tname in _THREAD_NAMES.items():
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": TRACE_PID,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        for ph, name, cat, ts, dur, tid, id_, args in self._events:
            ev: dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": round(ts, 3),
                "pid": TRACE_PID,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur, 3)
            if ph == "i":
                ev["s"] = "t"
            if id_ is not None:
                ev["id"] = id_
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def to_chrome_trace(self) -> dict[str, Any]:
        return {"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> dict[str, Any]:
        """Write Perfetto-loadable JSON to ``path``; returns the dict."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f, default=str)
        return trace


class StepTrace:
    """One scheduler step as a tree of spans, made only with the recorder on.

    The step span is the root. ``open`` nests a span in the open one and
    ``close`` ends the innermost; ``lap`` ends it and opens the next at one
    clock reading, so a step's phases tile the step and the decode's parts
    tile the decode. A span of kind ``"wait"`` is a device wait, one of kind
    ``"launch"`` a step function's call; ``launch(fn, ...)`` and
    ``waited(t)`` count the same inside another span (a prefill's call, its
    first token's readback). With ``ranges`` every span but a launch is
    also a ``torch.profiler.record_function`` range ``serve.<name>``: the
    profiler puts a kernel on the device under the innermost range it was
    launched in, so a launch opens none and its kernels lie in their
    phase's range (``serve.decode``, ``serve.verify``).

    ``end()`` writes the spans into the tracer, each with the step's
    ``seq`` (one that held others also with its ``self_ms``), and gives the
    step span ``host_ms`` (its duration less the waits), ``wait_ms``,
    ``launch_ms`` and ``device_ms``: with ``events`` (a reusable pair of
    timing CUDA events) the stream's time from the start of the step's first
    launch to the end of its last (the first event recorded before the
    first launch, the second again after each), read once the step's own
    synchronise has completed them (None where they have not); without,
    ``launch_ms`` (eager work on the CPU is synchronous)."""

    __slots__ = ("tracer", "seq", "ranges", "events", "marked", "stack", "spans", "t",
                 "wait_s", "launch_s")

    def __init__(self, tracer: Tracer, seq: int, ranges: bool = False, events=None):
        self.tracer, self.seq, self.ranges, self.events = tracer, seq, ranges, events
        self.marked = False
        self.wait_s = self.launch_s = 0.0
        self.stack: list = []  # open: [name, start, kind, range, args, children's seconds]
        self.spans: list = []  # closed: (name, start, end, args)
        self.t = self.open("step")  # the last clock reading taken

    def _range(self, name: str):
        if not self.ranges:
            return None
        from torch.profiler import record_function  # lazy: keep the module stdlib-only

        rf = record_function("serve." + name)
        rf.__enter__()
        return rf

    def open(self, name: str, t: float | None = None, kind: str | None = None, **args) -> float:
        # entered before the clock is read, left before it is read
        rf = None if kind == "launch" else self._range(name)
        t = time.perf_counter() if t is None else t
        if kind == "launch":
            self._mark()
        self.stack.append([name, t, kind, rf, args, 0.0])
        self.t = t
        return t

    def close(self, t: float | None = None) -> float:
        name, a, kind, rf, args, inner = self.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        t = time.perf_counter() if t is None else t
        if kind == "wait":
            self.wait_s += t - a
        elif kind == "launch":
            self._launched(t - a)
        if inner:
            args["self_ms"] = (t - a - inner) * 1e3
        if self.stack:
            self.stack[-1][5] += t - a
        self.spans.append((name, a, t, args))
        self.t = t
        return t

    def lap(self, name: str, t: float | None = None, kind: str | None = None, **args) -> float:
        """End the innermost span and open ``name`` at the same instant: the
        clock is read between the old range's end and the new one's start,
        so a range's own cost splits between the two."""
        return self.open(name, self.close(t), kind, **args)

    def _mark(self) -> None:
        if not self.marked and self.events is not None:
            self.events[0].record()
        self.marked = True

    def _launched(self, seconds: float) -> None:
        self.launch_s += seconds
        if self.events is not None:
            self.events[1].record()

    def launch(self, fn, *args, **kw):
        """``fn(*args, **kw)``, timed as a launch."""
        self._mark()
        t = time.perf_counter()
        out = fn(*args, **kw)
        self._launched(time.perf_counter() - t)
        return out

    def waited(self, t0: float) -> None:
        """Count the time since ``t0`` as a device wait."""
        self.wait_s += time.perf_counter() - t0

    def end(self, t: float | None = None, **args) -> None:
        """Close every open span, the step's last, and write them all."""
        self.stack[0][4].update(args)
        while self.stack:
            t = self.close(t)
        _, a, b, step = self.spans[-1]
        ev = self.events
        device_ms = self.launch_s * 1e3 if ev is None else None
        if ev is not None and self.marked and ev[1].query():
            device_ms = ev[0].elapsed_time(ev[1])
        step.update(host_ms=(b - a - self.wait_s) * 1e3, wait_ms=self.wait_s * 1e3,
                    launch_ms=self.launch_s * 1e3, device_ms=device_ms)
        tr, seq = self.tracer, self.seq
        for name, a, b, args in self.spans:
            ts = tr.to_us(a)
            tr.complete(name, "sched", ts, tr.to_us(b) - ts, args={"seq": seq, **args})

    def discard(self) -> None:
        """Drop the step (it did nothing, or raised): end its open ranges."""
        while self.stack:
            rf = self.stack.pop()[3]
            if rf is not None:
                rf.__exit__(None, None, None)


class Telemetry:
    """Tracer (and optional profiler ranges) behind one hard off switch.

    ``enabled=False`` (the default, and the module global's state) leaves
    the serving hot path as it is: every instrumentation site guards on
    ``tel.enabled`` (or on a cached metric handle that exists only when
    enabled). ``profiler_annotations=True`` also makes each of the
    scheduler's spans but a launch a ``torch.profiler.record_function`` range
    ``serve.<span>`` (and ``annotate`` a range elsewhere), so a
    ``torch.profiler`` trace names the phase around its kernels and the
    device's idle gaps — off by default even when tracing, since it adds a
    profiler range a span. It is read at every step, so it may be set
    mid-run, when a profiler starts."""

    def __init__(
        self,
        enabled: bool = False,
        capacity: int = 65536,
        profiler_annotations: bool = False,
    ):
        self.enabled = bool(enabled)
        self.profiler_annotations = bool(profiler_annotations)
        self.tracer = Tracer(capacity)

    def annotate(self, name: str):
        """Context manager for a device-launching phase: a
        ``torch.profiler.record_function`` range when enabled AND
        ``profiler_annotations`` is set, else a shared no-op context."""
        if not (self.enabled and self.profiler_annotations):
            return _NULL_CM
        from torch.profiler import record_function  # lazy: keep the module stdlib-only

        return record_function(name)

    def count(self, name: str, n: float = 1.0, registry: MetricsRegistry | None = None) -> None:
        """For rare call sites with no engine (the backend registry): bump
        a counter on ``registry`` (or the global one) iff enabled."""
        if not self.enabled:
            return
        (registry or _GLOBAL_REGISTRY).counter(name).inc(n)


# Module-global default: disabled. `configure()` arms it; tests build
# their own `Telemetry()` and pass it to the engine.
GLOBAL = Telemetry(enabled=False)
_GLOBAL_REGISTRY = MetricsRegistry()


def get_telemetry() -> Telemetry:
    return GLOBAL


def global_registry() -> MetricsRegistry:
    """Registry behind the engine-less counters recorded through
    ``Telemetry.count`` (backend resolutions, adviser decisions)."""
    return _GLOBAL_REGISTRY


def configure(
    enabled: bool = True,
    capacity: int = 65536,
    profiler_annotations: bool = False,
) -> Telemetry:
    """(Re)arm the module-global telemetry: a fresh tracer, the same
    object, so call sites that took ``get_telemetry()`` see it."""
    GLOBAL.enabled = bool(enabled)
    GLOBAL.profiler_annotations = bool(profiler_annotations)
    GLOBAL.tracer = Tracer(capacity)
    return GLOBAL


_VALID_PH = {"X", "B", "E", "i", "I", "b", "n", "e", "M", "C", "s", "t", "f"}


def validate_chrome_trace(trace: Any) -> dict[str, int]:
    """Validate Chrome trace-event JSON structure; raises ``ValueError``
    on the first violation, returns event counts on success.

    Checks the schema chrome://tracing and Perfetto actually require:
    a ``traceEvents`` list (or bare list) of dicts, each with a string
    ``name``, known ``ph``, numeric ``ts`` (metadata exempt) and
    ``pid``/``tid``; ``X`` events carry a non-negative ``dur``; async
    ``b``/``n``/``e`` events carry an ``id`` and every ``e`` closes a
    previously opened ``b`` of the same (cat, id)."""
    events = trace.get("traceEvents") if isinstance(trace, dict) else trace
    if not isinstance(events, list):
        raise ValueError("trace must be a list or have a 'traceEvents' list")
    counts = {"events": 0, "spans": 0, "async_spans": 0, "instants": 0}
    open_async: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not a dict")
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            raise ValueError(f"event {i}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"event {i}: missing name")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: missing ts")
            if ev["ts"] < 0:
                raise ValueError(f"event {i}: negative ts")
        if "pid" not in ev or "tid" not in ev:
            raise ValueError(f"event {i}: missing pid/tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X without non-negative dur")
            counts["spans"] += 1
        if ph in ("i", "I"):
            counts["instants"] += 1
        if ph in ("b", "n", "e"):
            if "id" not in ev:
                raise ValueError(f"event {i}: async {ph!r} without id")
            key = (ev.get("cat"), ev["id"])
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
                counts["async_spans"] += 1
            elif ph == "e":
                if open_async.get(key, 0) < 1:
                    # the ring may have evicted the matching "b"; only a
                    # strict violation when the buffer never wrapped
                    raise ValueError(f"event {i}: async end without begin {key}")
                open_async[key] -= 1
        counts["events"] += 1
    return counts
