"""Kind "serve": the port's serving engine under seeded traffic.

Set-up builds the model from the configuration file, draws its weights
from the seed on the device, builds a ``ServingEngine`` on the paged pool
of the cell and one scheduler, and warms every shape the cell's traffic
uses through that scheduler: one request a prefill width (the program's
own bucketing rule decides the widths), which also captures the decode step
at ``max_batch``. The lead-in traffic then runs for the cell's
``lead_in_s`` and the window follows without a break: the harness submits
each request when it is due on the plan and calls ``step()``, and stamps
every token at the end of the step that produced it.

After the window: the peak of device memory is read, the program's state
freed, and a sample of the requests finished in the window (drawn from
the seed, the one with the most served tokens always in it) is checked
against the plain reference.
"""
from __future__ import annotations

import gc
import json
import random
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from pbench import stats, traffic, weights
from pbench.trace import Tracer


@dataclass
class StepRec:
    t0: float
    t1: float
    prefill: list = field(default_factory=list)  # prompt lengths prefilled
    decode: list = field(default_factory=list)  # committed lengths of the rows decoded


@dataclass
class ServeRun:
    """What a serving run leaves for the metric readers."""

    model: dict
    requests: list
    steps: list
    w0: float
    w1: float
    setup_s: float = 0.0
    captures: int = 0  # step graphs captured inside the window
    slice: object = None  # the traced slice, with --trace 1
    slice_t: tuple = (0.0, 0.0)  # its bounds on the harness clock
    t_clean: float = 0.0  # the end of the window's untraced part

    def steps_in(self, t0: float, t1: float) -> list:
        return [s for s in self.steps if s.t0 >= t0 and s.t1 <= t1]

    def clean_steps(self) -> list:
        """The steps of the window before the traced slice (all of it
        without one): what host-clock layer metrics read, so that the
        profiler's own cost does not enter them."""
        return self.steps_in(self.w0, self.t_clean)

    def slice_steps(self) -> list:
        return self.steps_in(*self.slice_t)


def warm_lengths(lengths, family: str, max_seq: int) -> list:
    """One prompt length for each prefill width the program will run the
    traffic's lengths at: the longest that maps to it."""
    from repro_torch.models.model import PAD_PREFILL_FAMILIES, prefill_bucket

    by_width: dict = {}
    for n in lengths:
        w = prefill_bucket(n) if family in PAD_PREFILL_FAMILIES else n
        w = n if w > max_seq else w
        by_width[w] = max(by_width.get(w, 0), n)
    return sorted(by_width.values())


class Loop:
    """The harness's client and clock over one scheduler. With ``align``
    the scheduler's run clock, which stamps ``Request.t_first_admit``, is
    set to the harness's, so that the program's queue wait runs from the
    due time on the plan."""

    def __init__(self, sched, t_zero: float, align: bool = False):
        self.sched = sched
        self.t_zero = t_zero
        self.inflight: list = []
        self.steps: list = []
        self.pool_peak = {"held": 0, "data": 0.0}  # blocks live rows hold or reserve; data share
        if align:
            if not hasattr(sched, "_t0"):
                raise RuntimeError("the scheduler keeps no run clock `_t0` to align")
            sched._t0 = t_zero

    def now(self) -> float:
        return time.perf_counter() - self.t_zero

    def submit(self, p, request_cls) -> None:
        p.handle = request_cls(prompt=p.prompt, max_new_tokens=p.max_new_tokens,
                               arrival_time=p.due)
        self.sched.submit(p.handle)
        self.inflight.append(p)

    def step(self) -> bool:
        t0 = self.now()
        with record_function("bench.step"):
            did = self.sched.step()
        t1 = self.now()
        if not did:
            return False
        rec = StepRec(t0, t1)
        with record_function("bench.stamp"):
            keep = []
            for p in self.inflight:
                h = p.handle
                n = len(h.tokens)
                new = n - len(p.stamps)
                if new > 0:
                    if not p.stamps:
                        rec.prefill.append(p.prompt_len)
                    if n >= 2:
                        rec.decode.append(p.prompt_len + n - 2)
                    p.stamps.extend([t1] * new)
                if h.finished:
                    p.finished_at = t1
                else:
                    keep.append(p)
            self.inflight = keep
            kv = self.sched.kv
            if hasattr(kv, "n_free_blocks"):
                held = kv.num_blocks - kv.n_free_blocks
                self.pool_peak["held"] = max(self.pool_peak["held"], held)
                self.pool_peak["data"] = max(self.pool_peak["data"], kv.occupancy)
        self.steps.append(rec)
        return True

    def check_clock(self, requests) -> None:
        """The scheduler's clock against the harness's, from what both
        stamp: each admission lies between the request's due time and the
        end of the step that gave its first token. Raises where it does not,
        so that the program's queue wait is never read on another clock."""
        for p in requests:
            h = p.handle
            if h is None or h.t_first_admit is None or not p.stamps:
                continue
            if not p.due - 1e-6 <= h.t_first_admit <= p.stamps[0] + 1e-6:
                raise RuntimeError(
                    f"the scheduler's clock disagrees with the harness's: admitted at "
                    f"{h.t_first_admit:.6f}, due {p.due:.6f}, first token {p.stamps[0]:.6f}")

    def drive(self, plan, t_end: float, request_cls, on_boundary=None) -> None:
        """Submit each planned request when due and step until ``t_end``
        (a step that starts before it may end after it)."""
        i = 0
        while True:
            now = self.now()
            if on_boundary is not None:
                on_boundary(now)
            if now >= t_end:
                return
            with record_function("bench.submit"):
                while i < len(plan) and plan[i].due <= now:
                    self.submit(plan[i], request_cls)
                    i += 1
            if not self.step():
                nxt = plan[i].due if i < len(plan) else t_end
                time.sleep(max(0.0, min(nxt, t_end) - self.now()))


def build(ctx):
    """(params, model, engine): the weights drawn from the seed and the
    program's engine over them."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServingEngine

    m, eng, device = ctx.model, ctx.cell["engine"], ctx.device
    if device.type == "cuda":
        from repro_torch.kernels import _build

        t = time.perf_counter()
        _build.library()  # built once a checkout, under build/kernels/
        ctx.split("kernel_library", time.perf_counter() - t)
    t = time.perf_counter()
    model = Model(ModelConfig(**m), device=device)
    params = weights.make(model.abstract_params()[0], m, ctx.config["init"], ctx.seed, device)
    engine = ServingEngine(
        model, params, max_seq=eng["max_seq"], max_batch=eng["max_batch"], kv_layout="paged",
        block_size=eng["block_size"], num_blocks=eng.get("num_blocks"),
        prefix_cache=eng["prefix_cache"], device=device)
    ctx.split("weights", time.perf_counter() - t)
    return params, model, engine


def warm_up(ctx, sched, plan) -> None:
    """One request a prefill width of the plan's prompts, two tokens each
    (so the decode step at ``max_batch`` runs too), served to the end."""
    from repro_torch.serve.request import Request

    t = time.perf_counter()
    m = ctx.model
    gen = torch.Generator().manual_seed(ctx.seed)
    warm = Loop(sched, time.perf_counter())
    lengths = warm_lengths({p.prompt_len for p in plan}, m["family"],
                           ctx.cell["engine"]["max_seq"])
    for L in lengths:
        prompt = torch.randint(0, m["vocab_size"], (L,), generator=gen).numpy()
        warm.submit(traffic.Planned(0.0, prompt, 2), Request)
    while warm.inflight:
        warm.step()
    ctx.split("warm_up", time.perf_counter() - t, f"{len(lengths)} prefill widths")


def run(ctx) -> dict:
    from repro_torch.models.step_graph import cache_size
    from repro_torch.serve.request import Request

    cell, m, device = ctx.cell, ctx.model, ctx.device
    params, model, engine = build(ctx)
    sched = engine.scheduler(cell["engine"]["max_batch"], seed=ctx.seed)
    lead_in = float(cell["lead_in_s"])
    plan = traffic.plan(ctx.mix, rate_rps=cell.get("rate_rps"), spans=(lead_in, ctx.seconds),
                        backlog=cell.get("backlog"), seed=ctx.seed, vocab=m["vocab_size"])
    ctx.note(f"plan: {len(plan)} requests")
    warm_up(ctx, sched, plan)

    # lead-in and window, one schedule
    loop = Loop(sched, time.perf_counter(), align=True)
    w0, w1 = lead_in, lead_in + ctx.seconds
    tracer, state = Tracer(device) if ctx.trace else None, {}
    # the traced slice closes the window, after the untraced part
    slice_t = (max(w0, w1 - cell["trace_slice_s"]), w1)

    def boundary(now):
        if "window" not in state and now >= w0:
            state["window"] = now
            state["setup_s"] = time.perf_counter() - ctx.t_start
            state["graphs"] = cache_size(engine_steps(engine))
            ctx.split("lead_in", now)
        if tracer is not None:
            if "slice0" not in state and now >= slice_t[0]:
                state["slice0"] = loop.now()
                tracer.start()
            elif "slice0" in state and "slice1" not in state and now >= slice_t[1]:
                state["slice1"] = loop.now()
                state["slice"] = tracer.stop()

    loop.drive(plan, w1, Request, boundary)
    if "slice0" in state and "slice" not in state:
        state["slice1"] = loop.now()
        state["slice"] = tracer.stop()
    captures = cache_size(engine_steps(engine)) - state["graphs"]
    loop.check_clock(plan)
    note_pool(ctx, loop)
    peak = int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0
    run = ServeRun(model=m, requests=plan, steps=loop.steps, w0=w0, w1=w1,
                   setup_s=state["setup_s"], captures=captures, slice=state.get("slice"),
                   slice_t=(state.get("slice0", 0.0), state.get("slice1", 0.0)),
                   t_clean=state.get("slice0", w1))
    # in the system during the window: due by its end, not finished before it
    due = [p for p in plan if p.handle is not None and p.due < w1
           and (p.finished_at is None or p.finished_at >= w0)]
    done = [p for p in plan if p.finished_at is not None and w0 <= p.finished_at <= w1]
    ctx.note(f"window: {len(due)} attempted, {len(done)} finished, "
             f"{len(run.steps_in(w0, w1))} steps, captures {captures}")

    # the program's state goes before the reference runs
    del sched, engine, model, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, params, m, done, cell["check"])
    return {"run": run, "attempted": len(due), "failed": 0, "peak": peak, "checks": checks}


def note_pool(ctx, loop) -> None:
    """The paged pool's peak use over the run, on standard error."""
    n = getattr(loop.sched.kv, "num_blocks", None)
    if n:
        held = loop.pool_peak["held"]
        ctx.note(f"pool: live rows held or reserved at most {held} of {n} blocks "
                 f"({100 * held / n:.1f}%); blocks holding data, parked prefixes "
                 f"included, at most {100 * loop.pool_peak['data']:.1f}%")


def sweep(ctx, rates, lead_in: float, seconds: float) -> list:
    """The offered rates of ``rates`` one after another on one engine, each
    on a fresh scheduler over the engine's storage (no recapture) with its
    own lead-in and window: a row a rate of what the window sustained."""
    from repro_torch.serve.request import Request

    _, _, engine = build(ctx)
    rows = []
    for i, rate in enumerate(rates):
        sched = engine.scheduler(ctx.cell["engine"]["max_batch"], seed=ctx.seed)
        plan = traffic.plan(ctx.mix, rate_rps=rate, spans=(lead_in, seconds),
                            seed=ctx.seed + i, vocab=ctx.model["vocab_size"])
        if i == 0:
            warm_up(ctx, sched, plan)
        loop = Loop(sched, time.perf_counter(), align=True)
        w0, w1 = lead_in, lead_in + seconds
        waiting = []

        def boundary(now, loop=loop, waiting=waiting):
            if now >= w0:
                waiting.append((now, sum(1 for p in loop.inflight if not p.stamps)))

        loop.drive(plan, w1, Request, boundary)
        q = max(1, len(waiting) // 5)
        row = {"rate": rate,
               "arrived_per_s": sum(1 for p in plan if w0 <= p.due < w1) / seconds,
               "finished_per_s": sum(1 for p in plan if p.finished_at is not None
                                     and w0 <= p.finished_at < w1) / seconds,
               "out_tokens_per_s": stats.tokens_in(plan, w0, w1) / seconds,
               "offered_out_tokens_per_s": sum(p.max_new_tokens for p in plan
                                               if w0 <= p.due < w1) / seconds,
               "waiting_first_fifth": sum(w for _, w in waiting[:q]) / q,
               "waiting_last_fifth": sum(w for _, w in waiting[-q:]) / q,
               "ttft_p50_ms": stats.percentile(stats.ttft_samples(plan, w0, w1), 50) * 1e3,
               "ttft_p95_ms": stats.percentile(stats.ttft_samples(plan, w0, w1), 95) * 1e3,
               "itl_p95_ms": stats.percentile(stats.itl_samples(plan, w0, w1), 95) * 1e3}
        ctx.note("sweep " + json.dumps(row))
        rows.append(row)
        # the next scheduler takes this one's pools only once it is gone
        del sched, loop, boundary
        gc.collect()
    return rows


def engine_steps(engine) -> list:
    """Every compiled step family the engine holds (its ``_steps``, by
    backend). Raises where it finds none, so that a renamed store reads as
    a fault and not as 0 captures."""
    fns = [fn for fam in getattr(engine, "_steps", {}).values() for fn in fam.values()]
    if not fns:
        raise RuntimeError("no compiled step family found on the engine (`_steps`)")
    return fns


def check(ctx, params, m, done, spec) -> dict:
    """The widest logit gap over a seeded sample of the requests finished in
    the window: the one with the most served tokens, then others in a
    seeded order until the sample holds ``requests`` requests and
    ``tokens`` served tokens. With the control on, the control's gaps take
    the program's place against the limits."""
    from reference.check import widest_gap

    if not done:
        return {"finished_requests": {"value": 0, "limit": 1, "ok": False}}
    longest = max(done, key=lambda p: len(p.stamps))
    rest = [p for p in done if p is not longest]
    random.Random(ctx.seed).shuffle(rest)
    sample, tokens = [longest], len(longest.stamps)
    for p in rest:
        if tokens >= spec["tokens"] and len(sample) >= spec["requests"]:
            break
        sample.append(p)
        tokens += len(p.stamps)
    served = [(p.prompt.tolist(), list(p.handle.tokens)) for p in sample]
    t = time.perf_counter()
    got = widest_gap(params, m, served, quant="fp8" if ctx.control else None)
    ctx.note(f"reference: {len(sample)} requests, {got['tokens']} served tokens, "
             f"{time.perf_counter() - t:.3f} s")
    if ctx.control:  # the control in the program's place, held to the same limits
        ctx.note("program: " + json.dumps({k: got[k] for k in ("max_logit_gap", "mean_logit_gap")}))
        got = {**got, "max_logit_gap": got["control_max_logit_gap"],
               "mean_logit_gap": got["control_mean_logit_gap"]}
        ctx.note("control: " + json.dumps({k: got[k] for k in ("max_logit_gap", "mean_logit_gap")}))
    out = {name: {"value": got[name], "limit": spec[name], "ok": got[name] <= spec[name]}
           for name in ("max_logit_gap", "mean_logit_gap") if name in spec}
    return {
        **out,
        "requests_checked": {"value": len(sample), "limit": spec["requests"],
                             "ok": len(sample) >= spec["requests"]},
        "served_tokens_checked": {"value": got["tokens"], "limit": spec["tokens"],
                                  "ok": got["tokens"] >= spec["tokens"]},
    }
