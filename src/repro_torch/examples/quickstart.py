"""Quickstart: the Aira pipeline end to end on one latency-critical
benchmark — profile → annotate → dependence check → SMT-overlap gate →
Relic restructuring — then the granularity band of Figs. 1–2. The
counterpart of the JAX package's ``examples/quickstart.py``: the same
report, decision and band, with the benchmark's data and the restructured
plan on the device.

  python -m repro_torch.examples.quickstart [--device cpu]

Runs on CUDA unless ``--device cpu``; without a card and without
``--device cpu`` it exits non-zero. The band is the overlap model's
arithmetic, priced for the paper's SMT core (``CPU_HW``), so it prints the
JAX script's numbers on any device.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.examples import add_device_flag, device_or_exit

BAND_SIZES = (10, 50, 200, 1000)


def band(model) -> list[tuple[int, float, float]]:
    """(n, smt2 gain, smp2 gain) of the CC kernel at each problem size:
    ``max(4, n // 4)`` vertices a microtask, at least two microtasks."""
    from repro_torch.bench_suite import cc
    from repro_torch.core.overlap_model import Microtask

    rows = []
    for n in BAND_SIZES:
        g = max(4, n // 4)
        t0 = cc.microtask()
        t = Microtask(t0.flops * g, t0.bytes * g, t0.chain * g, True)
        p = model.predict(t, max(2, n // g))
        rows.append((n, p.gain("smt2"), p.gain("smp2")))
    return rows


def main(argv=None, *, device=None) -> dict:
    """Advise GeoSpatial on the device, check the restructured plan
    against the serial loop, print the band; returns them as data."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_or_exit(device if device is not None else args.device)
    from repro_torch.bench_suite import BENCHMARKS
    from repro_torch.core import Aira
    from repro_torch.core.overlap_model import CPU_HW, OverlapModel

    # 1) advise one benchmark ("Parallelize this program with Aira")
    b = BENCHMARKS["GeoSpatial"]
    data = b.build(device=dev)
    report = Aira(hw=CPU_HW).advise(b.workload(data))
    print(report.render())
    d = report.decisions[0]
    record = {"accepted": d.accepted, "report": report.render()}
    if d.accepted:
        # the benchmark declares combine="sum"; the plan honors it
        got = np.asarray(d.parallel_fn().cpu())
        want = np.asarray(b.serial_value(data, combine=b.combine).cpu())
        record["equal"] = bool(np.allclose(got, want, atol=1e-3))
        record["schedule"] = d.schedule.describe()
        print(f"\nrestructured == serial: {record['equal']}")
        print(f"chosen schedule: {record['schedule']}")

    # 2) the granularity band (paper Figs. 1–2)
    print("\nCC kernel, speedup vs problem size (Relic on one SMT core):")
    record["band"] = band(OverlapModel(CPU_HW))
    for n, smt2, smp2 in record["band"]:
        print(f"  n={n:5d}: smt2 {smt2*100:+6.1f}%   smp2 {smp2*100:+6.1f}%")
    return record


if __name__ == "__main__":
    main()
