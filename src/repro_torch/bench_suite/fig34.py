"""Figs. 3–4 + §VII: end-to-end Aira over the 10 latency-critical
benchmarks — gate decisions, per-benchmark gains, geomeans.

Port of ``benchmarks/fig34_aira.py``'s ``realized_gain``,
``flag_regressions`` and ``run``. The gains are the overlap model's,
priced for the paper's i7-12700 core (``CPU_HW``): they do not depend on
the device. Expected pattern (paper §VII):
  * 7/10 parallelized with positive predicted gain,
  * Fraud rejected by the overlap-simulator gate (no change),
  * 1-Hop and BVH pass the gate but sit below the Relic granularity
    floor; force-applying them realizes a regression (Fig. 4),
  * geomean over all 10 with non-applied = 1.0.

The wall columns time the serial per-item loop and each cached plan's
``execute`` on the device the data lives on (CUDA unless the caller asks
for the CPU): device vectorisation, not SMT. It writes no file.

    PYTHONPATH=src python -c "from repro_torch.bench_suite import fig34; fig34.run(device='cpu')"
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.bench_suite import BENCHMARKS
from repro_torch.core.overlap_model import CPU_HW, Microtask, OverlapModel
from repro_torch.core.plan import advise_suite


def realized_gain(b, data, decision) -> float:
    """Measured-outcome model: accepted → predicted gain; rejected → 0;
    forced below the Relic floor → granularity-1 schedule with locality
    break (paper Fig. 4)."""
    if not decision.accepted:
        return 0.0
    if not b.force:
        return decision.predicted_gain
    model = OverlapModel(CPU_HW)
    c = b.cost(data)
    pen = 1.0 + b.locality_penalty
    n = int(pytree.tree_leaves(b.items(data))[0].shape[0])
    g = max(1, b.realized_granularity)
    base = Microtask(c["flops"], c["bytes"], max(0, c["chain"]), c.get("vector", True))
    task = Microtask(
        flops=c["flops"] * g,
        bytes=c["bytes"] * g * pen,
        chain=max(1, int(round(c["chain"] * g * pen))),
        vector=c.get("vector", True),
    )
    p = model.predict(task, max(1, n // g))
    # realized gain compares the DEGRADED schedule to the ORIGINAL serial
    serial_orig = model.predict(base, n).serial
    return serial_orig / p.smt2 - 1.0


def flag_regressions(rows) -> list:
    """Predicted-vs-realized sign gate (in place, returned for chaining):
    a row the gate ACCEPTED on a positive predicted gain whose realized
    model says it got *slower* is flagged ``regressed: True``; the
    ``accepted`` bit is kept (the forced rows reproduce Fig. 4)."""
    for r in rows:
        r["regressed"] = bool(r["accepted"] and r["predicted"] > 0 and r["realized"] < 0)
    return rows


def geomeans(rows) -> tuple[float, float]:
    """(geomean over the positive realized gains, geomean over all rows
    with a non-positive gain counted as 0): the paper's two headlines."""
    pos = [r["realized"] for r in rows if r["realized"] > 0]
    gm_pos = float(np.exp(np.mean(np.log1p(pos)))) - 1 if pos else 0.0
    gm_all = float(np.exp(np.mean(np.log1p([max(r["realized"], 0.0) for r in rows])))) - 1
    return gm_pos, gm_all


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(thunk, device, reps: int = 3) -> float:
    """Host wall time of ``thunk`` after one warm call, ending in a device
    synchronise, averaged over ``reps``."""
    thunk()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        thunk()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def run(print_fn=print, timing: bool = True, device=None):
    """Advise the suite (``CPU_HW``), print the Figs. 3–4 table and return
    (rows, geomean over positives, geomean over all)."""
    suite = advise_suite(hw=CPU_HW, device=device)
    rows = []
    for name, entry in suite.items():
        b, data, d = BENCHMARKS[name], entry.data, entry.decision
        dev = pytree.tree_leaves(b.items(data))[0].device
        wall_serial = wall_par = float("nan")
        if timing:
            wall_serial = wall_ms(lambda: b.serial_value(data, combine=b.combine), dev, reps=1)
            if entry.plan is not None:
                items = b.items(data)
                wall_par = wall_ms(lambda: entry.plan.execute(items), dev)
            else:  # rejected: time the would-be restructuring anyway
                wall_par = wall_ms(lambda: b.parallel_value(data, granularity=8, combine=b.combine),
                                   dev)
        rows.append(dict(
            name=name,
            accepted=d.accepted,
            schedule=d.schedule.describe() if d.schedule else "-",
            granularity=d.schedule.granularity if d.schedule else None,
            strategy=d.schedule.strategy if d.schedule else None,
            predicted=d.predicted_gain,
            realized=realized_gain(b, data, d),
            wall_serial_ms=wall_serial,
            wall_restructured_ms=wall_par,
            log=d.stage_log,
        ))

    flag_regressions(rows)
    print_fn("# Fig.3/4 — Aira end-to-end on 10 latency-critical benchmarks "
             "(gains: the overlap model for CPU_HW; walls: device vectorisation, not SMT)")
    print_fn("benchmark,decision,predicted,realized_model,wall_serial_ms,wall_restruct_ms")
    for r in rows:
        dec = "accept" if r["accepted"] else "reject(gate)"
        if r["regressed"]:
            dec = "accept(forced,regressed)"
        print_fn(
            f"{r['name']},{dec},{r['predicted']*100:+.1f}%,{r['realized']*100:+.1f}%,"
            f"{r['wall_serial_ms']:.2f},{r['wall_restructured_ms']:.2f}"
        )
    gm_pos, gm_all = geomeans(rows)
    n_ok = sum(r["realized"] > 0 for r in rows)
    print_fn(
        f"successfully parallelized {n_ok}/10 (paper: 7/10); "
        f"geomean(positive)={gm_pos*100:.1f}% (paper: 25.2%); "
        f"geomean(all, negatives discarded)={gm_all*100:.1f}% (paper: 17%)"
    )
    return rows, gm_pos, gm_all
