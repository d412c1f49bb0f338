"""Multi-node dry run: count every (arch × shape) cell one rank at a time on
the Hopper production meshes and record memory / cost / collective
analysis.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch

Port of the JAX package's ``launch/dryrun.py``, which lowers and compiles
each cell for 512 placeholder CPU devices. Here one process poses as rank
(0, …, 0) of a fake process group of 256 or 512 ranks
(``launch.mesh.fake_ranks``) over ``make_production_mesh``, builds the
cell on meta tensors (``launch/cells.py``: that rank's shards, nothing
allocated) and counts one run of its step with ``core/profiler.py``'s
``profile_step`` (the aten-op counter, ``core/op_cost.py``): FLOPs, bytes
and collective bytes a rank, priced on ``H100_HW`` (the H100 SXM data
sheet). Nothing needs a card. Every count is a rank's share, as every
device of the JAX program counts its own; the record keeps the JAX
package's keys, with ``count_s`` (the seconds the count took) for its
``lower_s`` / ``compile_s`` and ``aten_flops_per_device`` (the FLOPs of
``torch.utils.flop_counter``'s formulas alone, no kernel operator's work)
for its ``xla_flops_per_device``. A cell that raises is recorded as
``FAILED`` and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ALL_ARCHS, SHAPES
from repro_torch.core.overlap_model import H100_HW
from repro_torch.core.profiler import profile_step
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_ranks, make_production_mesh

HW = H100_HW


def mesh_name(multi_pod: bool) -> str:
    return "x".join(str(n) for n in PRODUCTION_SHAPES[bool(multi_pod)][0])


def chips(multi_pod: bool) -> int:
    n = 1
    for d in PRODUCTION_SHAPES[bool(multi_pod)][0]:
        n *= d
    return n


def run_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool,
    verbose: bool = True,
    legacy: bool = False,
    overrides: dict | None = None,
) -> dict:
    """Count one cell as rank (0, …, 0) of the production mesh; returns its
    record. ``legacy``: the baseline implementation (the slot decode's
    per-layer cache slices, ``models.model.LEGACY_CACHE_SCAN``, and the MoE
    decode's whole-F experts, ``models.moe.LEGACY_DENSE``), for this cell
    only."""
    import repro_torch.models.model as model_mod
    import repro_torch.models.moe as moe_mod

    n_chips = chips(multi_pod)
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name(multi_pod),
        "chips": n_chips,
        "legacy": legacy,
        "overrides": overrides or {},
    }
    saved = model_mod.LEGACY_CACHE_SCAN, moe_mod.LEGACY_DENSE
    model_mod.LEGACY_CACHE_SCAN = moe_mod.LEGACY_DENSE = legacy
    try:
        with fake_ranks(n_chips, 0):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            cell = build_cell(arch, shape, mesh, overrides=overrides)
            if not cell.runnable:
                rec["status"] = "skipped"
                rec["reason"] = cell.skip_reason
                if verbose:
                    print(f"[dryrun] {arch} × {shape} × {rec['mesh']}: SKIP ({cell.skip_reason})")
                return rec
            t0 = time.perf_counter()
            ps = profile_step(cell.fn, *cell.args, name=f"{arch}/{shape}", mesh=mesh, hw=HW)
            t_count = time.perf_counter() - t0
    finally:
        model_mod.LEGACY_CACHE_SCAN, moe_mod.LEGACY_DENSE = saved

    mem = ps.memory_stats
    terms = {"compute_s": ps.terms.compute_s, "memory_s": ps.terms.memory_s,
             "collective_s": ps.terms.collective_s}
    flops_global = ps.flops * n_chips
    rec.update(
        status="ok",
        count_s=round(t_count, 1),
        flops_per_device=ps.flops,
        bytes_per_device=ps.bytes_accessed,
        aten_flops_per_device=sum(f for op, f in ps.ops.flops_by_op.items()
                                  if not op.startswith("repro_torch::")),
        collective_bytes_per_device=ps.collectives.bytes_total,
        collectives={k: int(v) for k, v in ps.collectives.counts.items()},
        collective_bytes_by_op={k: float(v) for k, v in ps.collectives.bytes_by_op.items()},
        memory=dict(
            argument_bytes=mem.argument_size_in_bytes,
            output_bytes=mem.output_size_in_bytes,
            temp_bytes=mem.temp_size_in_bytes,
            alias_bytes=mem.alias_size_in_bytes,
            peak_estimate_bytes=mem.argument_size_in_bytes
            + mem.output_size_in_bytes
            + mem.temp_size_in_bytes
            - mem.alias_size_in_bytes,
        ),
        roofline=dict(terms, dominant=ps.terms.dominant, bound_s=ps.terms.bound_s),
        model_flops=cell.model_flops,
        useful_flops_ratio=(cell.model_flops / flops_global) if flops_global else 0.0,
        sharding_fallbacks=sorted(set(cell.rules_fallbacks)),
    )
    if verbose:
        mem_gib = rec["memory"]["peak_estimate_bytes"] / 2**30
        print(
            f"[dryrun] {arch} × {shape} × {rec['mesh']}: OK "
            f"count={t_count:.1f}s mem≈{mem_gib:.2f}GiB/rank "
            f"dominant={rec['roofline']['dominant']} "
            f"bound={ps.terms.bound_s * 1e3:.3f}ms "
            f"useful={rec['useful_flops_ratio']*100:.0f}% "
            f"colls={rec['collectives']}",
            flush=True,
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--legacy", action="store_true",
                    help="the baseline implementation (per-layer cache slices, whole-F experts)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override, e.g. --set param_sharding=tp")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.isdigit() else v

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    rec = run_cell(
                        arch, shape, multi_pod=multi,
                        legacy=args.legacy, overrides=overrides or None,
                    )
                except Exception as e:  # a failure here is a fault of the port
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi),
                           "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=float)
    print(f"\n[dryrun] done; {len(failures)} failures: {failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
