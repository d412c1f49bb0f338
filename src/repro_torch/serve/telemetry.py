"""Serving metrics: ``quantile`` and the windowed ``MetricsRegistry``.

The metrics half of the JAX package's ``serve/telemetry.py``, copied so
the port imports nothing of that package. ``ServeStats`` sits on the
registry. The trace recorder (``Tracer``/``Telemetry``) waits for
ROADMAP §1 item 8.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Iterable

__all__ = ["Counter", "Gauge", "Series", "MetricsRegistry", "quantile"]


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
