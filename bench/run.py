"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It runs ``repro_torch`` (under ``src/``)
on one CUDA device, measures the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics (``--trace 1``, with a ``torch.profiler`` slice of
the window), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output, with each
number compared beside its limit as the last lines of standard error.
``--control 1`` puts the control (the reference in float8) in the
program's place in that comparison, so that a sound run reads ``correct``
false, and prints the program's own numbers on standard error; the
benchmark's own runs leave it off.

Without CUDA, or with fewer devices than the cell asks for, or without the
program beside it, it prints no result and exits with a code other than 0;
so it does if JAX or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Context:
    """What a kind of run receives: the cell's files, the run's arguments
    and the device."""

    def __init__(self, args, manifest, device, t_start):
        w = manifest.workload(args.workload)
        self.name = args.workload
        self.workload = w
        self.config = manifest.config(w["config"])
        self.model = self.config["model"]
        self.cell = manifest.cell(args.workload)
        self.mix = manifest.mix(w["traffic"])
        self.seed, self.seconds = int(args.seed), float(args.seconds)
        self.trace, self.control = bool(args.trace), bool(args.control)
        self.device = device
        self.t_start = t_start
        self.note = note
        self.split("imports", time.perf_counter() - t_start)

    def split(self, part: str, seconds: float, extra: str = "") -> None:
        """One part of the set-up, on standard error (not in the result)."""
        note(f"setup {part}: {seconds:.3f} s {extra}".rstrip())


def measure(ctx, manifest) -> dict:
    """Run the cell's kind, then read its metrics: the end-to-end ones, or
    with --trace 1 the per-layer ones (a reader that finds nothing to read
    leaves its metric out)."""
    out = manifest.kind(ctx.cell["kind"]).run(ctx)
    run = out["run"]
    metrics = {}
    wanted = manifest.per_layer(ctx.name) if ctx.trace else manifest.end_to_end(ctx.name)
    for m in wanted:
        v = manifest.reader(m["name"])(run)
        if v is None and not ctx.trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    return out


def device_info(out, ctx, torch) -> dict:
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
           "count": int(ctx.workload.get("chips", 1)),
           "memory_peak_bytes": out["peak"]}
    s = out["run"].slice
    if ctx.trace and s is not None:
        dev["busy_s"] = s.busy_s()
        dev["window_s"] = s.window_s
    return dev


def result(out, ctx, torch) -> dict:
    checks = out["checks"]
    res = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": out["attempted"], "failed": out["failed"],
           "metrics": out["metrics"], "device": device_info(out, ctx, torch)}
    s = out["run"].slice
    if ctx.trace and s is not None:
        res["breakdown"] = {"device_ops": s.top_ops(), "idle_gaps": s.idle_gaps()}
    res["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return res


def execute(args, device=None, manifest=None) -> dict:
    """One run of ``args.workload`` on ``device``: the result's dict."""
    import torch

    from pbench.manifest import Manifest

    manifest = manifest or Manifest()
    ctx = Context(args, manifest, torch.device(device or "cuda"), T_START)
    out = measure(ctx, manifest)
    return result(out, ctx, torch)


def setup_environment() -> None:
    """Import paths, and every build and kernel cache of the program at a
    fixed place inside the checkout."""
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT / "src"))
    cache = ROOT / "build" / "bench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        note(f"the program is not beside the benchmark: no {ROOT / 'src' / 'repro_torch'}")
        return 2
    setup_environment()
    import torch

    from pbench.manifest import Manifest

    manifest = Manifest()
    chips = int(manifest.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = execute(args, "cuda", manifest)
    bad = forbidden_modules()
    if bad:
        note(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
