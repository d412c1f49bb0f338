"""The port's dry run (``launch/cells.py``, ``launch/dryrun.py``,
``launch/mesh.py::make_production_mesh``) against the JAX package's.

The cells are counted on the JAX tests' ("data", "model") = (2, 4) mesh:
the JAX package's ``build_cell`` is lowered and compiled for 8 host devices
in one subprocess (started first, so that it runs while the port counts),
and the port's ``build_cell`` is counted as rank 0 of a fake group of 8
(``launch.mesh.fake_ranks``) with ``profile_step``. Each case is a reduced
config (``.reduced()``'s fields as overrides) whose split over "model" is
the full config's:

- smollm-135m with 3 heads and 1 kv head: ``seq_sp`` prefill, the cache
  along ``kv_seq``;
- phi3-medium-14b: the q heads split, the cache along ``kv_seq``;
- granite-moe-1b-a400m with 4 kv heads and 8 experts: heads and kv heads
  split, two experts a rank (with one, the port's remat "dots" policy would
  save the expert products as the projections' batch-1 products, where
  JAX's recomputes them), at capacity factor 4;
- mamba2-370m: SSM heads; zamba2-2.7b with 4 kv heads: SSM heads and the
  shared block's heads.

Every case takes attention chunks of 4096 keys, SSD chunks of 256 and 2
accumulation microbatches on both sides, so that the port's counted loops
stay short; the shapes are the production ones. Held for each cell: the
argument bytes and ``model_flops`` equal, the sharding fallbacks equal as
sets, the skip status and reason equal, and the FLOPs a device within
``FLOPS_RTOL`` (no cell is held otherwise)."""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.profiler import profile_step
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import fake_ranks, make_production_mesh, make_test_mesh
from repro_torch.models import model as model_mod

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLOPS_RTOL = 0.05

REDUCED = ("num_layers d_model n_heads n_kv_heads head_dim d_ff vocab_size n_experts top_k "
           "ssm_state ssm_head_dim ssm_chunk attn_every n_frontend_tokens attn_chunk "
           "dtype").split()
SHORT = dict(attn_chunk=4096, ssm_chunk=256, train_accum=2)
CASES = {
    "smollm-135m": dict(n_heads=3, n_kv_heads=1),
    "phi3-medium-14b": {},
    "granite-moe-1b-a400m": dict(n_kv_heads=4, n_experts=8, capacity_factor=4.0),
    "mamba2-370m": {},
    "zamba2-2.7b": dict(n_kv_heads=4),
}
CELLS = [(a, s) for a in CASES for s in ("train_4k", "prefill_32k", "decode_32k")]
CELLS.append(("smollm-135m", "long_500k"))


def overrides(arch) -> dict:
    red = get_config(arch).reduced()
    return {**{k: getattr(red, k) for k in REDUCED}, **CASES[arch], **SHORT}


JAX_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.core.hlo_cost import analyze
from repro.launch.cells import build_cell
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch, shape, over in json.loads(sys.argv[1]):
    cell = build_cell(arch, shape, mesh, overrides=over)
    if not cell.runnable:
        out[arch + "/" + shape] = {"skip": cell.skip_reason}
        continue
    with mesh:
        c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    donate_argnums=cell.donate).lower(*cell.args).compile()
    out[arch + "/" + shape] = {
        "argument_bytes": c.memory_analysis().argument_size_in_bytes,
        "flops": analyze(c.as_text()).flops, "model_flops": cell.model_flops,
        "fallbacks": sorted(set(cell.rules_fallbacks))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """(JAX's records, the port's records) of every cell in ``CELLS``."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    jobs = json.dumps([(a, s, overrides(a)) for a, s in CELLS])
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, jobs], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        with fake_ranks(8, 0):
            mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
            for arch, shape in CELLS:
                cell = build_cell(arch, shape, mesh, overrides=overrides(arch))
                if not cell.runnable:
                    port[arch + "/" + shape] = {"skip": cell.skip_reason}
                    continue
                ps = profile_step(cell.fn, *cell.args, mesh=mesh)
                port[arch + "/" + shape] = {
                    "argument_bytes": ps.memory_stats.argument_size_in_bytes,
                    "flops": ps.flops, "model_flops": cell.model_flops,
                    "fallbacks": sorted(set(cell.rules_fallbacks))}
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1]), port


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_counts_match_jax(records, arch, shape):
    want, got = (r[arch + "/" + shape] for r in records)
    if "skip" in want:
        assert got == want
        return
    assert "skip" not in got
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["model_flops"] == want["model_flops"]
    assert set(got["fallbacks"]) == set(want["fallbacks"])
    assert abs(got["flops"] / want["flops"] - 1) <= FLOPS_RTOL, (got["flops"], want["flops"])


@pytest.mark.parametrize("multi,shape,axes,rank,coord", [
    (False, (32, 8), ("data", "model"), 37, (4, 5)),
    (True, (2, 32, 8), ("pod", "data", "model"), 300, (1, 5, 4)),
])
def test_production_mesh(multi, shape, axes, rank, coord):
    """256 GPUs as 32 nodes of 8 ("data", "model"), 512 as two such pods;
    the fake group opens nothing else and is gone after."""
    with fake_ranks(256 * (1 + multi), rank):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        assert tuple(mesh.get_coordinate()) == coord
        with pytest.raises(RuntimeError, match="already open"):
            with fake_ranks(8, 0):
                pass
    assert not dist.is_initialized()


def test_legacy_decode_moves_more_bytes():
    """``LEGACY_CACHE_SCAN`` copies each layer's cache slice out and back:
    more bytes, the same FLOPs."""
    counts = {}
    with fake_ranks(8, 0):
        mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
        for legacy in (False, True):
            model_mod.LEGACY_CACHE_SCAN = legacy
            try:
                cell = build_cell("smollm-135m", "decode_32k", mesh,
                                  overrides=overrides("smollm-135m"))
                counts[legacy] = profile_step(cell.fn, *cell.args, mesh=mesh)
            finally:
                model_mod.LEGACY_CACHE_SCAN = False
    assert counts[True].bytes_accessed > counts[False].bytes_accessed
    assert counts[True].flops == counts[False].flops


def test_cli_writes_records_and_fails_loudly(tmp_path):
    """One cell through the command line writes a record with the JAX
    package's keys and exits 0, a second run skips it as written, and a cell
    that raises is written as FAILED with exit code 1."""
    env = dict(os.environ, PYTHONPATH="src")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
           "--shape", "decode_32k", "--out", str(tmp_path)]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "32x8" and rec["chips"] == 256
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "collectives", "collective_bytes_by_op", "memory", "roofline", "model_flops",
                "useful_flops_ratio", "sharding_fallbacks", "count_s", "aten_flops_per_device",
                "legacy", "overrides"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    again = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0 and "cached" in again.stdout
    bad = subprocess.run(cmd[:-2] + ["--out", str(tmp_path / "bad"), "--set", "num_layers=x"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1
    rec = json.loads((tmp_path / "bad" / "smollm-135m_decode_32k_single.json").read_text())
    assert rec["status"] == "FAILED" and rec["error"]
