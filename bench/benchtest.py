"""Helpers of the benchmark's CPU tests: a temporary checkout of the
benchmark with a tiny configuration, mix and cells added as new files and
manifest entries, and a run of one of its cells on the CPU."""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {
    "dense": {"name": "tiny-dense", "family": "dense", "num_layers": 2, "d_model": 64,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 250,
              "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32",
              "tie_embeddings": False},
    "moe": {"name": "tiny-moe", "family": "moe", "num_layers": 2, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 250, "n_experts": 8,
            "top_k": 2, "capacity_factor": 4.0, "rope_theta": 10000.0, "norm_eps": 1e-6,
            "dtype": "float32", "tie_embeddings": True},
}
TINY_MIX = {"arrivals": "poisson",
            "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 64,
                       "grid": 8},
            "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 16}}


def tiny_checkout(tmp: Path, family: str = "dense") -> Path:
    """A copy of the benchmark under ``tmp`` with a tiny configuration
    (``tiny-<family>``), a tiny mix and one cell ``tiny-chat`` that reports
    every chat metric, all added as new files and manifest entries. Returns
    the copy's ``BENCHMARK.json``."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    real_cfg = next(c for c in real["configs"] if c["name"].startswith(
        "granite" if family == "moe" else "internlm2"))
    cfg = json.loads((ROOT / real_cfg["file"]).read_text())
    cfg["model"] = dict(TINY_MODEL[family])
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    chat = json.loads((bench / "cells" / "internlm2-chat.json").read_text())
    chat.update(engine={"max_batch": 4, "max_seq": 128, "block_size": 16, "num_blocks": 40,
                        "prefix_cache": True},
                rate_rps=25.0, lead_in_s=0.3, trace_slice_s=0.5)
    chat["check"].update(tokens=30, requests=3)
    (bench / "cells" / "tiny-chat.json").write_text(json.dumps(chat))
    real["configs"].append({"name": "tiny", "source": "a tiny test configuration",
                            "file": "bench/configs/tiny.json", "reduced": [], "why": "tests"})
    real["workloads"].append({"name": "tiny-chat", "config": "tiny", "traffic": "tiny",
                              "chips": 1, "why": "tests"})
    for m in real["end_to_end"] + real["per_layer"]:
        if {"internlm2-chat", "granite-moe-chat"} & set(m.get("workloads", ())):
            m["workloads"].append("tiny-chat")
    (tmp / "BENCHMARK.json").write_text(json.dumps(real))
    return tmp / "BENCHMARK.json"


def run_cpu(manifest_path: Path, workload: str = "tiny-chat", seed: int = 12345,
            seconds: float = 1.0, trace: int = 0, control: int = 0) -> dict:
    """One run of ``workload`` of the checkout at ``manifest_path`` on the
    CPU: the harness's whole run but its look for a card."""
    import torch

    import run
    from pbench.manifest import Manifest

    torch.set_num_threads(1)  # test workers share the host's cores

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                              control=control)
    return run.execute(args, "cpu", Manifest(manifest_path, bench=manifest_path.parent / "bench"))
