"""A traced slice of the window: ``torch.profiler`` over a few steady
seconds, reduced to device intervals by name and the host activity in the
gaps between them.

Device events are every CUDA activity (kernels, copies, sets). Busy time
is the union of their intervals inside the slice; idle time the rest. An
idle gap is named after the innermost host event (an op, a runtime call or
one of the harness's ``bench.*`` ranges) that covers its midpoint.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile


def _ns(e, what: str) -> int:
    fn = getattr(e, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, what + "_us")() * 1000)


def _annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else e.name().startswith("bench.")


@dataclass
class Slice:
    t0_ns: int = 0
    t1_ns: int = 0
    device: list = field(default_factory=list)  # (start_ns, end_ns, name)
    host: list = field(default_factory=list)  # (start_ns, end_ns, name)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the slice."""
        out = []
        for a, b, _ in sorted(self.device):
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns) -> float:
        """Device seconds of the events whose name holds any of ``patterns``."""
        return sum(min(b, self.t1_ns) - max(a, self.t0_ns) for a, b, n in self.device
                   if any(p in n for p in patterns) and b > self.t0_ns and a < self.t1_ns) / 1e9

    def top_ops(self, k: int = 10) -> list:
        tot: dict = defaultdict(int)
        for a, b, n in self.device:
            tot[n] += b - a
        return [[n[:160], v / 1e9] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps with no device activity, by the host activity
        at their midpoints: [[name, seconds], ...], summed by name."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host)
        starts = [h[0] for h in host]
        named: dict = defaultdict(int)
        for a, b in gaps[:200]:
            mid = (a + b) // 2
            best = None
            # the latest-starting host event that covers the midpoint is the
            # innermost of the nested ranges there
            i = bisect.bisect_right(starts, mid)
            for h in reversed(host[max(0, i - 4096):i]):
                if h[1] >= mid:
                    best = h
                    break
            named[best[2][:160] if best else "no host event"] += b - a
        return [[n, v / 1e9] for n, v in sorted(named.items(), key=lambda x: -x[1])[:k]]


class Tracer:
    """Start and stop a profiler between two steps of the harness's loop."""

    def __init__(self, device):
        self.prof = None
        self.cuda = device.type == "cuda"

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._sync()

    def stop(self) -> Slice:
        self._sync()
        self.prof.stop()
        s = Slice()
        host_ns = []
        for e in self.prof.profiler.kineto_results.events():
            a = _ns(e, "start")
            b = a + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a host range's projection onto the device timeline is no work
                if not _annotation(e):
                    s.device.append((a, b, e.name()))
            else:
                s.host.append((a, b, e.name()))
                host_ns.append(a)
                host_ns.append(b)
        # the slice runs from the first device activity to the last: the
        # profiler's own start (its first synchronise can take ~0.2 s with
        # the device idle) is not the program's idle time
        if s.device:
            s.t0_ns, s.t1_ns = min(d[0] for d in s.device), max(d[1] for d in s.device)
        elif s.host:
            s.t0_ns, s.t1_ns = min(host_ns), max(host_ns)
        self.prof = None
        return s
