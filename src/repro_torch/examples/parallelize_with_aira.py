"""Apply Aira to YOUR OWN kernel — the paper's "Parallelize this program
with Aira" flow on a user-supplied region; the counterpart of the JAX
package's ``examples/parallelize_with_aira.py``.

The advisory run flows through the tool pipeline (profiler → deps →
simulator → restructurer), and an accepted region comes back with a
cached ``RegionPlan``: re-advising or re-executing the same region
signature reuses the plan instead of building it again.

  python -m repro_torch.examples.parallelize_with_aira [--device cpu]

Runs on CUDA unless ``--device cpu``; without a card and without
``--device cpu`` it exits non-zero. The centroids and queries are a
seeded torch draw (``jax.random``'s streams have no torch counterpart);
``main``'s hooks take other arrays, e.g. the JAX script's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.examples import add_device_flag, device_or_exit

N_CENTROIDS, N_QUERIES, DIM = 512, 2048, 32


def _draw(seed: int, shape, dev) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev)


def main(argv=None, *, device=None, centroids=None, queries=None, more_queries=None) -> dict:
    """Advise the nearest-centroid region, check the plan against
    ``torch.vmap`` exactly, run it on fresh items and re-advise (a plan
    cache hit); returns the outputs, the schedule and the cache stats.
    Hooks: ``centroids`` [512, 32], ``queries`` and ``more_queries``
    [2048, 32] (float32 arrays or tensors)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.parallelize_with_aira")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_or_exit(device if device is not None else args.device)
    from repro_torch.core import Aira, Region, Workload
    from repro_torch.core.overlap_model import CPU_HW
    from repro_torch.core.plan import plan_cache_stats

    def given(x, seed, shape):
        if x is None:
            return _draw(seed, shape, dev)
        return torch.as_tensor(np.array(x), dtype=torch.float32, device=dev)

    # a latency-critical kernel: per-query nearest centroid (gather-heavy)
    centroids = given(centroids, 0, (N_CENTROIDS, DIM))

    def nearest(q):  # per-item region
        d = torch.sum((centroids - q[None, :]) ** 2, dim=1)
        return torch.argmin(d)

    queries = given(queries, 1, (N_QUERIES, DIM))
    region = Region(
        name="nearest-centroid",
        fn=nearest,
        items=queries,
        task_flops=512 * 3 * 32,  # napkin: 512 dists × 3 ops × 32 dims
        task_bytes=512 * 32 * 4,  # streams the centroid table
        task_chain=1,
        vector=True,
    )
    report = Aira(hw=CPU_HW).advise(
        Workload("user-kernel", lambda: torch.vmap(nearest)(queries), [region]))
    print(report.render())
    d = report.decisions[0]
    record = {"accepted": d.accepted, "report": report.render()}
    if not d.accepted:
        print("\nregion not profitable — left serial (the gate did its job)")
        return record

    got = d.parallel_fn().cpu().numpy()
    want = torch.vmap(nearest)(queries).cpu().numpy()
    assert (got == want).all()
    record.update(indices=got, schedule=d.schedule.describe())
    print(f"\nrestructured output verified on {len(want)} items; "
          f"schedule: {record['schedule']}")

    # the plan is a cached, reusable artifact: execute on fresh items of
    # the same signature, and re-advising hits the plan cache
    more_queries = given(more_queries, 2, (N_QUERIES, DIM))
    got2 = d.plan.execute(more_queries).cpu().numpy()
    want2 = torch.vmap(nearest)(more_queries).cpu().numpy()
    assert (got2 == want2).all()
    report2 = Aira(hw=CPU_HW).advise(
        Workload("user-kernel", lambda: torch.vmap(nearest)(queries), [region]))
    assert report2.decisions[0].plan is d.plan
    record.update(more_indices=got2, reused=True, cache=plan_cache_stats())
    print(f"plan reused on new items; cache: {record['cache']}")
    return record


if __name__ == "__main__":
    main()
