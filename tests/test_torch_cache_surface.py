"""The caches' and the stats' public surface against the JAX package's on
the CPU, float32, reduced configs: ``SlotKVCache.owner`` / ``live_mask`` /
``live_slots`` / ``read``, ``PagedKVCache.owner`` / ``live_mask`` /
``live_rows``, ``ServeStats.summary()`` and the ``dtype=`` override of
``Model.init_cache`` / ``init_paged_cache`` and of both caches. Each test
makes the reference tests' calls (``tests/test_serving_core.py``,
``tests/test_paged_cache.py``) on both packages with the same inputs."""
import dataclasses
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import PagedKVCache as JPaged
from repro.serve import ServingEngine as JEngine
from repro.serve import SlotKVCache as JSlot
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ServingEngine
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache

ATOL = 1e-4


def _pair(arch):
    jcfg = jget(arch).reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget(arch).reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return _pair("smollm-135m")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_slot_owner_and_live_mask_match_jax(pair):
    """300 random admits and finishes on both packages' slot pools: the
    same slot each time, the same owner, live mask and live slots, and a
    double free raises in both."""
    _, jm, _, tm, _ = pair
    jkv, tkv = JSlot(jm, max_batch=4, max_seq=16), SlotKVCache(tm, max_batch=4, max_seq=16)
    rng = random.Random(0)
    live: dict[int, int] = {}
    rid = 0
    for _ in range(300):
        if jkv.n_free and (not live or rng.random() < 0.5):
            slot = jkv.alloc(rid)
            assert tkv.alloc(rid) == slot == min(set(range(4)) - set(live))
            assert tkv.owner(slot) == jkv.owner(slot) == rid
            live[slot] = rid
            rid += 1
        else:
            slot = rng.choice(sorted(live))
            jkv.free(slot)
            tkv.free(slot)
            del live[slot]
            assert tkv.owner(slot) is None and jkv.owner(slot) is None
        tkv.check_invariants()
        np.testing.assert_array_equal(tkv.live_mask(), jkv.live_mask())
        np.testing.assert_array_equal(tkv.live_mask(), [s in live for s in range(4)])
        assert tkv.live_slots() == jkv.live_slots() == sorted(live)
    slot = sorted(live)[0] if live else tkv.alloc(rid)
    tkv.free(slot)
    with pytest.raises(RuntimeError, match="double free"):
        tkv.free(slot)


def test_slot_exhaustion_and_write_guard(pair):
    """An exhausted pool refuses an alloc and a write into a freed slot is
    refused, the reference's calls on both packages."""
    _, jm, _, tm, _ = pair
    for kv in (JSlot(jm, max_batch=2, max_seq=16), SlotKVCache(tm, max_batch=2, max_seq=16)):
        kv.alloc(0), kv.alloc(1)
        with pytest.raises(RuntimeError, match="free cache slot"):
            kv.alloc(2)
        kv.free(0)
        with pytest.raises(RuntimeError, match="free slot"):
            kv.write(0, kv.read(1))  # slot 0 no longer live


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_slot_write_read_roundtrip_matches_jax(arch):
    """A request's prefill cache written into a slot reads back intact, and
    each leaf equals the JAX slot's read (within 1e-4)."""
    cfg, jm, jp, tm, tp = _pair(arch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(prompt), 16)
    _, tc = tm.prefill(tp, torch.from_numpy(prompt), 16)
    jkv, tkv = JSlot(jm, max_batch=3, max_seq=16), SlotKVCache(tm, max_batch=3, max_seq=16)
    slot = jkv.alloc(7)
    assert tkv.alloc(7) == slot
    jkv.write(slot, jc)
    tkv.write(slot, tc)
    back, jback = tkv.read(slot), jkv.read(slot)
    for (path, got), (_, want) in zip(_leaves(back), _leaves(tc)):
        torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0, msg=str(path))
    for (path, got), (jpath, want) in zip(_leaves(back), _leaves(jback)):
        assert path == jpath and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=ATOL, rtol=ATOL, err_msg=str(path))


def test_paged_owner_and_live_rows_match_jax(pair):
    """200 steps of random admission, decode and finish traffic on both
    packages' paged pools: the same rows, owners, live mask and live rows."""
    _, jm, _, tm, _ = pair
    kw = dict(max_batch=3, max_seq=16, block_size=4, num_blocks=9)
    jkv, tkv = JPaged(jm, **kw), PagedKVCache(tm, **kw)
    rng = random.Random(0)
    live: dict[int, int] = {}
    rid = 0
    for _ in range(200):
        if rng.random() < 0.4:
            S, budget = rng.randint(1, 8), rng.randint(1, 4)
            tokens = tuple(rng.randrange(7) for _ in range(S))
            got, jgot = tkv.try_admit(rid, tokens, budget), jkv.try_admit(rid, tokens, budget)
            assert (got is None) == (jgot is None)
            if got is not None:
                assert got[0] == jgot[0] and list(got[1]) == list(jgot[1])
                assert tkv.owner(got[0]) == jkv.owner(got[0]) == rid
                live[got[0]] = budget
                rid += 1
        elif live:
            row = rng.choice(sorted(live))
            if rng.random() < 0.5 and live[row] > 0:
                for kv in (tkv, jkv):
                    kv.ensure_tail(row)
                    kv.advance(row)
                live[row] -= 1
            else:
                tkv.free_row(row)
                jkv.free_row(row)
                del live[row]
        tkv.check_invariants()
        np.testing.assert_array_equal(tkv.live_mask(), jkv.live_mask())
        assert tkv.live_rows() == jkv.live_rows() == sorted(live)
        assert all(tkv.owner(r) == jkv.owner(r) for r in range(3))


def test_serve_stats_summary_matches_jax(pair):
    """``ServeStats.summary()``: the JAX package's line, its numbers aside,
    per run and after a reset."""
    cfg, jm, jp, tm, tp = pair
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    je, te = JEngine(jm, jp, max_seq=64), ServingEngine(tm, tp, max_seq=64, device="cpu")
    lines = []
    for eng, ps in ((je, jnp.asarray(prompts[:2])), (te, prompts[:2])):
        eng.generate(ps, n_steps=3)
        eng.generate(ps, n_steps=3)
        assert len(eng.stats.step_ms) == 2 and len(eng.stats.ttft_ms) == 2
        s = eng.stats.summary()
        assert s.startswith("steps=2 p50=") and "| requests=2 ttft_p50=" in s
        lines.append(re.sub(r"\d+\.\d+", "x", s))
        eng.stats.reset()
        assert eng.stats.summary() == "steps=0 p50=0.00ms p99=0.00ms"
    assert lines[0] == lines[1]


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cache_dtype_override_matches_jax(arch, dtype):
    """``init_cache(dtype=)`` and ``SlotKVCache(dtype=)`` give every leaf
    the JAX package's shape and type (an int8 cache stays int8 with
    bfloat16 scales; the SSM state stays float32); ``init_paged_cache`` and
    ``PagedKVCache`` take the override too, and an int8 pool has the JAX
    pool's leaves: int8 k/v beside bfloat16 scales, whatever the override."""
    cfg, jm, _, tm, _ = _pair(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pairs = ((jm.init_cache(2, 16, dtype=jdt), tm.init_cache(2, 16, dtype=tdt)),
             (JSlot(jm, 2, 16, dtype=jdt).cache, SlotKVCache(tm, 2, 16, dtype=tdt).cache))
    for jtree, ttree in pairs:
        j, t = list(_leaves(jtree)), list(_leaves(ttree))
        assert [p for p, _ in t] == [p for p, _ in j]
        for (path, tl), (_, jl) in zip(t, j):
            assert tuple(tl.shape) == tuple(jl.shape), path
            assert str(tl.dtype).split(".")[-1] == str(jl.dtype), path
    if cfg.family != "dense":
        return
    jpool, tpool = jm.init_paged_cache(5, 4, dtype=jdt), tm.init_paged_cache(5, 4, dtype=tdt)
    for (path, tl), (_, jl) in zip(_leaves(tpool), _leaves(jpool)):
        assert tuple(tl.shape) == tuple(jl.shape) and tl.dtype == tdt, path
    pkv = PagedKVCache(tm, max_batch=2, max_seq=16, block_size=4, dtype=tdt)
    assert all(v.dtype == tdt for v in pkv.pool.values())
    qcfg = dataclasses.replace(tget(arch).reduced(), kv_quant=True)
    quant = TModel(qcfg, device="cpu")
    jquant = JModel(dataclasses.replace(jget(arch).reduced(), kv_quant=True))
    j, t = (list(_leaves(p)) for p in (jquant.init_paged_cache(5, 4, dtype=jdt),
                                       quant.init_paged_cache(5, 4, dtype=tdt)))
    assert [p for p, _ in t] == [p for p, _ in j] == [("k",), ("k_scale",), ("v",), ("v_scale",)]
    for (path, tl), (_, jl) in zip(t, j):
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert str(tl.dtype).split(".")[-1] == str(jl.dtype), path
    assert {str(v.dtype) for v in PagedKVCache(quant, 2, 16, block_size=4, dtype=tdt).pool.values()} == {
        "torch.int8", "torch.bfloat16"}
