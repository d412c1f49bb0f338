"""SMT-aware dual-stream performance simulator (the Sniper analogue).

Port of the JAX package's ``core/overlap_model.py``: pure arithmetic,
copied. The paper extends Sniper to predict whether co-scheduling a pair
of fine-grained task streams onto one SMT core is profitable, and gates
parallelization on that prediction (§V — the Fraud benchmark is rejected
here). The resource physics that drive the paper's observations:

* A single thread of a latency-critical kernel leaves resources idle in
  two ways: **dependent-access stalls** (pointer chasing — the chain of
  ``chain`` serialized memory latencies per task) and **ILP slack**
  (``ilp_eff`` < 1: one thread cannot fill all issue ports).
* Co-scheduling a second stream hides chain stalls and fills ports, but
  *shared* resources (FU throughput, memory bandwidth) are not
  duplicated, and the pair contends (``contention``).

Per-schedule wall-time for n microtasks (c = FLOP time at full issue,
c_s = c/ilp_eff single-thread, m_lat = chain·mem_latency, m_bw =
bytes/bandwidth):

  serial : n·(c_s + m_lat + m_bw)
  smt2   : max( (n/2)·(c_s+m_lat+m_bw)·(1+φ),   ← per-stream chain
                n·c·(1+φ),                       ← shared issue ports
                n·m_bw )                         ← shared bandwidth
           + n·o_task + o_region
  smp2   : max( (n/2)·(c_s+m_lat+m_bw), n·m_bw )
           + n·o_task·xcore_penalty + o_region_smp

The granularity band of the paper's Figs. 1–2 falls out of the o-terms
(below the band dispatch dominates) and of φ (above it two full cores
beat one contended core).

``HwModel()``'s defaults are the paper's evaluation machine (one
i7-12700 P-core with DDR5, ``CPU_HW``), whose numbers price every
decision of the benchmark suite. The JAX package's default is a TPU
preset; the port carries no TPU number. ``H100_HW`` is the card the port
runs on: the profiler (``core/profiler.py``) prices a step's roofline
terms with it.

Runtime presets: Relic's dispatch is ~100 ns (the paper's enabling
observation); an OpenMP-style runtime pays ~5× that per task plus a
microsecond-scale region fork/join.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class HwModel:
    """One SMT core's resources; the defaults are the paper's i7-12700
    P-core (``CPU_HW``)."""

    peak_flops: float = 50e9  # one P-core, AVX2 FMA
    vpu_flops: float = 6e9  # scalar/branchy pointer-chasing code
    hbm_bw: float = 30e9  # single-core DRAM streaming, bytes/s
    ici_bw: float = 0.0  # no inter-chip link on one core
    mem_latency: float = 80e-9  # DDR5 dependent random access
    ilp_eff: float = 0.88  # single-stream issue-port utilization
    contention: float = 0.08  # residual overhead on shared-resource floors
    pair_contention: float = 0.55  # per-stream slowdown when co-scheduled
    bw_contention: float = 0.15  # interleaved-stream bandwidth loss
    mlp_eff: float = 0.40  # extra memory-level parallelism the 2nd stream
    # can actually extract (latency floor = m_lat/(1+mlp_eff))
    xcore_penalty: float = 3.0  # cross-core task handoff vs same-core
    smp_setup: float = 1.5e-6  # waking/pinning the second physical core
    fill_depth: int = 2  # pipeline fill (double buffering)


@dataclass(frozen=True)
class RuntimeModel:
    name: str
    o_task: float  # per-microtask dispatch
    o_region: float  # parallel-region entry/exit (fork/join)


RELIC = RuntimeModel("relic", o_task=100e-9, o_region=50e-9)
OPENMP = RuntimeModel("openmp", o_task=500e-9, o_region=800e-9)

# The paper's evaluation machine (i7-12700 P-core, DDR5): the bench_suite
# figure reproduction prices with it; it is also HwModel()'s default.
CPU_HW = HwModel()

# One NVIDIA H100 SXM5 80GB, from NVIDIA's "H100 Tensor Core GPU" data sheet
# (https://www.nvidia.com/en-us/data-center/h100/), dense rates without
# sparsity at the 700 W power limit. It prices roofline terms only
# (``profile_step``: FLOPs over ``peak_flops``, bytes over ``hbm_bw``,
# collective bytes over ``ici_bw``); it never prices an ``OverlapModel``
# microtask pair, so the SMT-core fields (latency, ILP, contention) keep
# ``CPU_HW``'s values.
H100_HW = HwModel(
    peak_flops=989e12,  # data sheet: BF16 Tensor Core, 1,979 TFLOPS with sparsity / 2
    vpu_flops=67e12,  # data sheet: FP32, 67 TFLOPS (outside the tensor cores)
    hbm_bw=3.35e12,  # data sheet: GPU memory bandwidth, 3.35 TB/s (HBM3)
    ici_bw=450e9,  # data sheet: NVLink 900 GB/s, each way 450 GB/s
)


@dataclass(frozen=True)
class Microtask:
    """One fine-grained task: FLOPs, streamed bytes, dependent-access chain."""

    flops: float
    bytes: float
    chain: int = 0  # serialized dependent memory accesses (tree hops)
    vector: bool = False  # scalar/gather-bound (vpu_flops) vs peak_flops


@dataclass
class SchedulePrediction:
    serial: float
    smt2: float
    smp2: float

    @property
    def best(self) -> str:
        t = {"serial": self.serial, "smt2": self.smt2, "smp2": self.smp2}
        return min(t, key=t.get)

    def gain(self, schedule: str) -> float:
        """Relative speedup of `schedule` over serial (paper Figs. 1–4)."""
        t = {"smt2": self.smt2, "smp2": self.smp2, "serial": self.serial}[schedule]
        return self.serial / t - 1.0


class OverlapModel:
    def __init__(self, hw: HwModel | None = None, runtime: RuntimeModel = RELIC):
        self.hw = hw or HwModel()
        self.runtime = runtime

    # ------------------------------------------------------------------
    def _components(self, task: Microtask):
        hw = self.hw
        c = task.flops / (hw.vpu_flops if task.vector else hw.peak_flops)
        c_s = c / hw.ilp_eff
        m_lat = task.chain * hw.mem_latency
        m_bw = task.bytes / hw.hbm_bw
        return c, c_s, m_lat, m_bw

    def predict(
        self, task: Microtask, n_tasks: int, runtime: RuntimeModel | None = None
    ) -> SchedulePrediction:
        """Wall time of each schedule = max over binding resource bounds
        (per-stream chain, shared issue ports, shared bandwidth, finite
        memory-level parallelism) + dispatch overheads (docstring above)."""
        hw, rt = self.hw, runtime or self.runtime
        n = n_tasks
        c, c_s, m_lat, m_bw = self._components(task)
        per = c_s + m_lat + m_bw

        serial = n * per

        fill = hw.fill_depth * min(c_s, m_lat + m_bw)  # pipeline warmup
        smt2 = (
            max(
                (n / 2) * per * (1 + hw.pair_contention),  # per-stream chain
                n * c * (1 + hw.contention),  # shared issue ports
                n * m_bw * (1 + hw.bw_contention),  # shared bandwidth
                n * m_lat / (1 + hw.mlp_eff) * (1 + hw.contention),  # MLP cap
            )
            + n * rt.o_task
            + rt.o_region
            + fill
        )
        smp2 = (
            max(math.ceil(n / 2) * per, n * m_bw)
            + n * rt.o_task * hw.xcore_penalty
            + rt.o_region * hw.xcore_penalty
            + hw.smp_setup
        )
        return SchedulePrediction(serial=serial, smt2=smt2, smp2=smp2)

    # ------------------------------------------------------------------
    def granularity_sweep(self, base: Microtask, total_items: int, grans, runtime=None):
        """Speedup-vs-granularity curves (paper Figs. 1–2).

        granularity g groups g items into one microtask: n = total/g tasks
        each g× the base cost. (Grouping amortizes dispatch but does not
        change resource totals — exactly the paper's sweep.)
        """
        rows = []
        for g in grans:
            task = Microtask(
                flops=base.flops * g,
                bytes=base.bytes * g,
                chain=base.chain * g,
                vector=base.vector,
            )
            n = max(1, total_items // g)
            p = self.predict(task, n, runtime)
            rows.append(
                {
                    "granularity": g,
                    "smt_gain": p.gain("smt2"),
                    "smp_gain": p.gain("smp2"),
                    "serial_us": p.serial * 1e6,
                }
            )
        return rows

    def profitable_band(self, base: Microtask, total_items: int):
        """Granularity range where smt2 beats BOTH serial and smp2 —
        the paper's primary target (§IV)."""
        lo, hi = None, None
        g = 1
        while g <= total_items:
            task = Microtask(base.flops * g, base.bytes * g, base.chain * g, base.vector)
            p = self.predict(task, max(1, total_items // g))
            if p.smt2 < p.serial and p.smt2 <= p.smp2:
                lo = g if lo is None else lo
                hi = g
            g *= 2
        return lo, hi


def gate(prediction: SchedulePrediction, threshold: float = 0.02) -> tuple[bool, str]:
    """The Sniper gate: accept only if predicted smt2 gain > threshold."""
    g = prediction.gain("smt2")
    if g > threshold:
        return True, f"accepted: predicted +{g*100:.1f}%"
    return False, f"rejected: predicted {g*100:+.1f}% ≤ {threshold*100:.0f}% gate"
