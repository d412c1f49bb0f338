"""The port's prefill and slot decode split over "model" (``Model(cfg,
mesh=mesh)``'s ``prefill`` and ``decode_step`` on a rank's shards of the
parameters and of the cache) against the port's single-device model and the
JAX package's, on the CPU, in one group of 8 gloo rank processes
(``run_ranks``; bodies in ``tests/_torch_split_forward_ranks.py``) on the
("data", "model") = (2, 4) mesh of the JAX tests, float32.

Five reduced configs, each with its full config's split: smollm-135m with 3
heads and 1 kv head (``seq_sp`` prefill, the cache along ``kv_seq``),
phi3-medium-14b (the q heads split, the cache along ``kv_seq``),
granite-moe-1b-a400m with 4 kv heads at capacity factor 4 (heads and kv
heads split; the dispatch path in prefill and the dense path in decode,
nothing dropped), mamba2-370m (SSM heads) and zamba2-2.7b with 4 kv heads
(SSM heads and the shared block's heads, its int8 cache). Each runs a
prefill of 4 rows of 16 tokens (``max_seq`` 24: the decodes write positions
16-19, across two ranks' ranges on a ``kv_seq`` split) and 4 decode steps
of fixed tokens from the JAX package's initial parameters:

- every rank's logits within ``SPLIT_RTOL`` (relative to the largest) of
  the port's single-device logits, and its cache shard within it of its
  slice of the single-device cache (the rules' spec of ``cache_axes``);
- the logits within ``JAX_RTOL`` of the JAX single-device model's;
- an int8 cache (zamba2's) is summed in another order on the split, so a
  value a float32 ulp from a rounding tie can take the next code: its codes
  are held within one of the single-device codes (at fewer than
  ``INT8_TIE_SHARE`` of them), its bf16 scales within one bf16 ulp, and
  where any code or scale differs the logits within ``INT8_TIE_RTOL``
  (the bodies' constants); against the JAX package, whose sums run in yet
  another order, its logits are held to ``INT8_TIE_RTOL``;
- with ``LEGACY_CACHE_SCAN`` the decodes bitwise equal to the default ones
  (both models), and the JAX package's legacy decode equal to its default
  one on the float caches (its legacy scan carries no int8 scales).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

import repro.models.model as jmodel_mod
from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro_torch.launch.mesh import run_ranks

import _torch_split_forward_ranks as ranks

JAX_RTOL = 1e-4
SPLIT_RTOL = ranks.RTOL
MAX_SEQ = 24
CASES = {
    "smollm-135m": dict(n_heads=3, n_kv_heads=1),
    "phi3-medium-14b": {},
    "granite-moe-1b-a400m": dict(n_kv_heads=4, capacity_factor=4.0),
    "mamba2-370m": {},
    "zamba2-2.7b": dict(n_kv_heads=4),
}
KV_LAYOUT = {  # [n, B/data, positions, kv heads, hd] of a rank's k
    "smollm-135m": (2, 2, 6, 1, 16),
    "phi3-medium-14b": (2, 2, 6, 2, 16),
    "granite-moe-1b-a400m": (2, 2, 24, 1, 16),
    "zamba2-2.7b": (1, 2, 24, 1, 16),
}


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_run(cfg, params, tokens, steps, legacy=False):
    model = JModel(cfg)
    logits, cache = model.prefill(params, tokens, MAX_SEQ)
    out = [np.asarray(logits)]
    jmodel_mod.LEGACY_CACHE_SCAN = legacy
    try:
        for i in range(steps.shape[1]):
            logits, cache = model.decode_step(params, cache, steps[:, i:i + 1])
            out.append(np.asarray(logits))
    finally:
        jmodel_mod.LEGACY_CACHE_SCAN = False
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the JAX logits a case, with the legacy decode's where it has one;
    what rank 0 found a case)."""
    out = str(tmp_path_factory.mktemp("split"))
    rng = np.random.default_rng(0)
    cases, jax_out = [], {}
    for arch, over in CASES.items():
        cfg = dataclasses.replace(jget(arch).reduced(), **over)
        params, _ = JModel(cfg).init(jax.random.key(0))
        tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        steps = rng.integers(0, cfg.vocab_size, (4, 4)).astype(np.int32)
        jax_out[arch] = (cfg, params, tokens, steps)
        cases.append((arch, "split_forward", (arch, over, jax.tree.map(np.asarray, params),
                                              tokens, steps, MAX_SEQ)))
    found = {}

    def spawn():
        run_ranks(ranks.run_cases, 8, cases, out, store=os.path.join(out, "store"))
        found.update(ranks.load(out, 0))

    import threading
    t = threading.Thread(target=spawn)
    t.start()
    want = {}
    for arch, (cfg, params, tokens, steps) in jax_out.items():
        want[arch] = {"default": _jax_run(cfg, params, tokens, steps)}
        if cfg.kv_quant:
            want[arch]["kv_quant"] = True
        else:
            want[arch]["legacy"] = _jax_run(cfg, params, tokens, steps, legacy=True)
    t.join()
    return want, found


@pytest.mark.parametrize("arch", list(CASES))
def test_split_forward_matches_single_device_and_jax(results, arch):
    want, found = results
    got = found[arch]
    assert "error" not in got, got.get("error")
    errs = got["errs"]
    assert max(e["cache"] for e in errs) <= SPLIT_RTOL
    assert max(e["logits"] for e in errs) <= (ranks.INT8_TIE_RTOL if got["ties"] else SPLIT_RTOL)
    # an int8 cache rounds ties apart from the JAX package's too
    tol = ranks.INT8_TIE_RTOL if "kv_quant" in want[arch] else JAX_RTOL
    for g, w in zip(got["got"], want[arch]["default"]):
        assert rel(g, w) <= tol
    for g, w in zip(got["want"], want[arch]["default"]):
        assert rel(g, w) <= tol
    if arch in KV_LAYOUT:
        assert got["kv"]["k"] == KV_LAYOUT[arch]
    assert got["fallbacks"] == (["seq_sp:1 ∤ meshmodel; dropped model"]
                                if arch == "smollm-135m" else [])


@pytest.mark.parametrize("arch", [a for a in CASES if a != "zamba2-2.7b"])
def test_jax_legacy_decode_gives_the_same_logits(results, arch):
    """The JAX package's pre-optimisation decode scan equals its default
    decode, as the port's legacy decode equals its own (the rank bodies
    hold that bitwise)."""
    want, _ = results
    for a, b in zip(want[arch]["default"], want[arch]["legacy"]):
        np.testing.assert_array_equal(a, b)
