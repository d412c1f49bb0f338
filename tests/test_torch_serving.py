"""The port's serving core against the JAX package's on the CPU, in
float32: greedy token streams of ``serve()`` (slot and paged layouts, an
open-loop workload and a shared-prefix workload) and of ``generate()``
must be identical; the summary schema and the prefix hit rate must
agree; out-of-slice options must refuse loudly; and no entry point may
fall back to the CPU on its own."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import ServingEngine as JEngine
from repro.serve import make_requests as j_requests
from repro.serve import make_shared_prefix_requests as j_prefix_requests
from repro.serve.differential import assert_streams_equal
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve import make_requests as t_requests
from repro_torch.serve import make_shared_prefix_requests as t_prefix_requests

KW = dict(max_seq=64, block_size=8)


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def _open_loop(make, cfg):
    return make(10, 200.0, vocab=cfg.vocab_size, max_new_tokens=8,
                rng=np.random.default_rng(1))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_serve_streams_match_jax(pair, layout):
    cfg, jm, jp, tm, tp = pair
    je = JEngine(jm, jp, kv_layout=layout, **KW)
    te = ServingEngine(tm, tp, kv_layout=layout, device="cpu", **KW)
    want = je.serve(_open_loop(j_requests, cfg), max_batch=4)
    sched = te.scheduler(4)
    got = sched.run(_open_loop(t_requests, cfg))
    assert_streams_equal(want, got, label=layout)
    sched.kv.check_invariants()  # every slot / block returned to the pool
    js, ts = je.stats.serving_summary(), te.stats.serving_summary()
    assert sorted(ts) == sorted(js)  # the schema the JAX package has on this tree
    assert ts["n_requests"] == js["n_requests"] == 10


def test_prefix_reuse_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair

    def work(make):
        return make(6, 100.0, vocab=cfg.vocab_size, prefix_len=24, suffix_len=5,
                    max_new_tokens=6, rng=np.random.default_rng(2))

    je = JEngine(jm, jp, kv_layout="paged", **KW)
    te = ServingEngine(tm, tp, kv_layout="paged", device="cpu", **KW)
    want = je.serve(work(j_prefix_requests), max_batch=3)
    sched = te.scheduler(3)
    got = sched.run(work(t_prefix_requests))
    assert_streams_equal(want, got, label="shared-prefix")
    rate = te.stats.serving_summary()["prefix_hit_rate"]
    assert rate > 0 and rate == je.stats.serving_summary()["prefix_hit_rate"]
    sched.kv.check_invariants()


def test_generate_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    want = JEngine(jm, jp, **KW).generate(jax.numpy.asarray(prompts), 6)
    got = ServingEngine(tm, tp, device="cpu", **KW).generate(prompts, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded(pair):
    cfg, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", temperature=1.0, **KW)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = eng.generate(prompts, 6, seed=3)
    assert torch.equal(a, eng.generate(prompts, 6, seed=3))


def test_out_of_slice_options_refuse(pair):
    cfg, _, _, tm, tp = pair
    for opt in ("spec", "chunk_size", "decode_plan", "mesh"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tm, tp, device="cpu", **{opt: 4}, **KW)
    eng = ServingEngine(tm, tp, device="cpu", **KW)
    for opt in ("spec", "chunk_size", "controller", "mesh"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.serve([], **{opt: 4})
    with pytest.raises(NotImplementedError, match="preemption"):
        eng.serve([Request(prompt=np.arange(4), max_new_tokens=2, priority=1)])
    base = tget("smollm-135m").reduced()
    with pytest.raises(NotImplementedError, match="family"):
        TModel(dataclasses.replace(base, family="moe"), device="cpu")
    # int8 KV serves on the slot layout; its paged pool is not ported yet
    with pytest.raises(NotImplementedError, match="kv_quant"):
        TModel(dataclasses.replace(base, kv_quant=True), device="cpu").init_paged_cache(4, 8)


def test_no_silent_cpu_fallback(pair):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    _, _, _, tm, tp = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm, tp, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(tget("smollm-135m").reduced())
