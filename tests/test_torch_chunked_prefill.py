"""The port's chunked prefill against the JAX package's on the CPU, in
float32 at reduced smollm-135m (JAX parameters carried over):
``prefill_chunk`` and ``seed_cache_with_prefix`` against the JAX
functions (logits within 1e-4), chunked serves (both layouts, with and
without speculation, with prefix reuse) whose streams equal the JAX
engine's and the port's monolithic ones, and the closed family of step
widths that stands in for the reference's one jit trace per shape: after
``prime()`` every chunk width a scheduler emits is a primed pow2 width,
and bucketed monolithic prefills share one width per pow2 bucket.
Workloads run on a step clock (``drive``), so that admission does not
depend on either package's speed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro_torch.configs import get_config as tget
from repro_torch.models.model import CHUNKED_PREFILL_FAMILIES, prefill_bucket
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine, SpecConfig

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = jget("smollm-135m").reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget("smollm-135m").reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


def drive(sched, reqs, dt=0.005):
    """Run ``reqs`` to completion on a step clock (step i at i * dt)."""
    clock = [0.0]
    sched._clock = lambda: clock[0]
    sched.stats.reset()
    for r in reqs:
        sched.submit(r)
    i = 0
    while sched._queue or sched._active or sched._chunking:
        clock[0] = i * dt
        sched.step(now=clock[0])
        i += 1
    return [r.output() for r in reqs]


def assert_same(a, b, label=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{label} stream #{i} diverged")


def _workload(R, cfg, lens=(13, 5, 29, 8, 17), priorities=(0, 1, 0, 1, 1), tokens=6):
    out = []
    for i, (s0, pr) in enumerate(zip(lens, priorities)):
        prompt = np.random.default_rng(100 + i).integers(0, cfg.vocab_size, size=(s0,))
        out.append(R(prompt=prompt.astype(np.int32), max_new_tokens=tokens,
                     arrival_time=0.005 * i, priority=pr))
    return out


# ---------------------------------------------------------------------------
# the model functions against JAX's


def test_prefill_bucket():
    assert [prefill_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 16, 17)] == [
        1, 2, 4, 4, 8, 8, 16, 16, 32,
    ]
    assert prefill_bucket(9, cap=8) == 8  # chunk slices never exceed the budget
    assert prefill_bucket(3, cap=8) == 4


def test_prefill_chunk_matches_jax(pair):
    """A 37-token prompt walked in 8-wide chunks (the last one 0-padded
    past its real rows): every chunk's logits within 1e-4 of JAX's, the
    committed length advancing by the real rows only, and the final cache
    equal to a monolithic prefill's rows."""
    cfg, jm, jp, tm, tp = pair
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(37,))
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64)
    pos = 0
    while pos < len(prompt):
        n = min(8, len(prompt) - pos)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[pos : pos + n]
        jlog, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray([n], jnp.int32))
        tlog, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks), [n])
        close(tlog[:, :n], np.asarray(jlog)[:, :n])
        pos += n
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [pos]
    mono_logits, mono = tm.prefill(tp, torch.from_numpy(prompt[None]), 64)
    close(tlog[0, n - 1], mono_logits[0])
    close(tc["k"][:, :, :37], mono["k"][:, :, :37])


def test_seed_cache_with_prefix_matches_jax(pair):
    """A prefix hit's KV rows seed a batch-1 cache at len = h, and the
    chunk continuing from it gives JAX's logits."""
    cfg, jm, jp, tm, tp = pair
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    _, jfull = jm.prefill(jp, jnp.asarray(prompt), 64)
    pk, pv = np.array(jfull["k"])[:, :, :16], np.array(jfull["v"])[:, :, :16]
    jc = jm.seed_cache_with_prefix(pk, pv, 64)
    tc = tm.seed_cache_with_prefix(torch.from_numpy(pk), torch.from_numpy(pv), 64)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [16]
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    toks = np.zeros((1, 8), np.int32)
    toks[0] = prompt[0, 16:]
    jlog, _ = jm.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray([8], jnp.int32))
    tlog, _ = tm.prefill_chunk(tp, tc, torch.from_numpy(toks), [8])
    close(tlog, jlog)
    with pytest.raises(ValueError, match="prefix seeding"):
        TModel(tget("mamba2-370m").reduced(), device="cpu").seed_cache_with_prefix(
            torch.from_numpy(pk), torch.from_numpy(pv), 64)


def test_bucketed_prefill_matches_jax(pair):
    """Padded+masked prefill next to the exact-shape one, each held to
    what the JAX package produces on this tree: logits within 1e-4 of
    JAX's exact and padded logits (JAX's two agree to rounding, not
    bitwise), the same next token, the same committed KV rows and
    length."""
    cfg, jm, jp, tm, tp = pair
    s0 = 11
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, s0))
    padded = np.zeros((1, prefill_bucket(s0)), np.int64)
    padded[:, :s0] = prompt
    j_exact, jc_exact = jm.prefill(jp, jnp.asarray(prompt), 64)
    j_pad, jc_pad = jm.prefill(jp, jnp.asarray(padded), 64, prompt_len=jnp.asarray([s0]))
    t_exact, tc_exact = tm.prefill(tp, torch.from_numpy(prompt), 64)
    t_pad, tc_pad = tm.prefill(tp, torch.from_numpy(padded), 64, prompt_len=[s0])
    close(t_exact, j_exact)
    close(t_pad, j_pad)
    close(t_pad, t_exact)
    assert int(torch.argmax(t_pad)) == int(torch.argmax(t_exact)) == int(jnp.argmax(j_pad))
    assert tc_pad["len"].tolist() == tc_exact["len"].tolist() == [s0]
    close(tc_pad["k"][:, :, :s0], np.asarray(jc_pad["k"])[:, :, :s0])
    close(tc_pad["k"][:, :, :s0], tc_exact["k"][:, :, :s0])


# ---------------------------------------------------------------------------
# chunked serves against the JAX engine's and the monolithic ones


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_chunked_equals_monolithic_and_jax(pair, layout):
    """A staggered mixed-priority workload decodes the same tokens
    whether prompts prefill monolithically or in 8-token chunks, and the
    chunked streams equal the JAX engine's."""
    cfg, jm, jp, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=128, kv_layout=layout, max_batch=3, device="cpu")
    mono = drive(te.scheduler(3, chunk_size=0), _workload(Request, cfg))
    sched = te.scheduler(3, chunk_size=8)
    reqs = _workload(Request, cfg)
    chunked = drive(sched, reqs)
    assert all(r.finished for r in reqs)
    sched.kv.check_invariants()
    je = JEngine(jm, jp, max_seq=128, kv_layout=layout, max_batch=3)
    want = drive(je.scheduler(3, chunk_size=8), _workload(JRequest, cfg))
    assert_same(chunked, mono, "chunked vs monolithic")
    assert_same(chunked, want, "vs JAX")
    assert set(sched.widths["chunk"]) <= {1, 2, 4, 8} and not sched.widths["prefill"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_chunked_with_speculation_matches_jax(pair, layout):
    """Chunked prefill with n-gram speculation: the streams equal the
    plain monolithic ones and the JAX engine's, acceptance counts too."""
    cfg, jm, jp, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=128, kv_layout=layout, max_batch=3, device="cpu")
    mono = drive(te.scheduler(3, chunk_size=0, spec=SpecConfig(k=0)), _workload(Request, cfg))
    spec = drive(te.scheduler(3, chunk_size=8, spec=SpecConfig(k=4)), _workload(Request, cfg))
    je = JEngine(jm, jp, max_seq=128, kv_layout=layout, max_batch=3)
    want = drive(je.scheduler(3, chunk_size=8, spec=JSpec(k=4)), _workload(JRequest, cfg))
    assert_same(spec, mono, "spec+chunked vs monolithic")
    assert_same(spec, want, "vs JAX")
    assert te.stats.spec_accepted == je.stats.spec_accepted
    assert te.stats.spec_proposed == je.stats.spec_proposed


def test_chunked_prefix_reuse_matches_jax(pair):
    """Shared-prefix prompts through the chunked path: later requests seed
    their chunk cache from the trie hit, hit as often as JAX's, and decode
    what the monolithic engine and the JAX engine decode."""
    cfg, jm, jp, tm, tp = pair
    header = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(24,))

    def reqs(R):
        out = []
        for i in range(3):
            tail = np.random.default_rng(50 + i).integers(0, cfg.vocab_size, size=(6,))
            out.append(R(prompt=np.concatenate([header, tail]).astype(np.int32),
                         max_new_tokens=4, arrival_time=0.05 * i))
        return out

    kw = dict(max_seq=96, kv_layout="paged", block_size=8, max_batch=2)
    te = ServingEngine(tm, tp, device="cpu", **kw)
    mono = drive(te.scheduler(2, chunk_size=0), reqs(Request))
    treqs = reqs(Request)
    chunked = drive(te.scheduler(2, chunk_size=8), treqs)
    jreqs = reqs(JRequest)
    want = drive(JEngine(jm, jp, **kw).scheduler(2, chunk_size=8), jreqs)
    assert_same(chunked, mono, "chunked vs monolithic")
    assert_same(chunked, want, "vs JAX")
    assert [r.prefix_hit for r in treqs] == [r.prefix_hit for r in jreqs]
    assert any(r.prefix_hit > 0 for r in treqs[1:])


# ---------------------------------------------------------------------------
# the closed family of step widths


def test_primed_scheduler_emits_only_primed_chunk_widths(pair):
    """``prime()`` runs one chunk at each pow2 width ≤ chunk_size; a
    workload of every prompt length 1-40 (full chunks, partial tails,
    slices of a budget shared between prompts) then emits chunk widths from that
    family only, each chunk position reusing its width."""
    cfg, _, _, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=48, kv_layout="paged", block_size=8, device="cpu")
    sched = te.scheduler(4, chunk_size=8)
    sched.prime()
    assert sched.primed_widths == {1, 2, 4, 8}
    assert not sched.widths["chunk"]  # priming is not serving
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32),
                    max_new_tokens=2, arrival_time=0.001 * s) for s in range(1, 41)]
    drive(sched, reqs)
    assert set(sched.widths["chunk"]) <= sched.primed_widths
    # a 40-token prompt walks five 8-wide chunks at five offsets: one width
    assert sched.widths["chunk"][8] >= 5
    assert all(r.finished for r in reqs)


def test_bucketed_monolithic_prefill_widths(pair):
    """Prompt lengths inside one pow2 bucket share one prefill width;
    crossing the boundary adds exactly one more."""
    cfg, _, _, tm, tp = pair
    te = ServingEngine(tm, tp, max_seq=64, device="cpu")
    sched = te.scheduler(1)
    reqs = [Request(prompt=(np.arange(s) % cfg.vocab_size).astype(np.int32), max_new_tokens=1,
                    arrival_time=0.001 * i) for i, s in enumerate((9, 11, 14, 16))]
    drive(sched, reqs)
    assert dict(sched.widths["prefill"]) == {16: 4}
    drive(sched, [Request(prompt=np.arange(20, dtype=np.int32), max_new_tokens=1)])
    assert dict(sched.widths["prefill"]) == {16: 4, 32: 1}


# ---------------------------------------------------------------------------
# config gates


def test_chunk_size_must_be_pow2(pair):
    _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=64, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        eng.serve([Request(prompt=np.arange(4), max_new_tokens=2)], chunk_size=6)


def test_chunked_rejects_unsupported_family(pair):
    cfg, _, _, tm, tp = pair
    ssm_cfg = dataclasses.replace(tget("smollm-135m").reduced(), family="ssm")
    assert ssm_cfg.family not in CHUNKED_PREFILL_FAMILIES
    with pytest.raises(ValueError, match="chunked prefill"):
        TModel(ssm_cfg, device="cpu").prefill_chunk(
            tp, tm.init_cache(1, 16), torch.zeros((1, 4), dtype=torch.long), [4])
    ssm = TModel(tget("mamba2-370m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(ssm, ssm.init(0), max_seq=32, device="cpu").scheduler(2, chunk_size=8)


def test_chunked_patch_embeds_not_reachable(pair):
    """VLM patch embeddings ride the monolithic path only, as in the JAX
    scheduler: a chunked scheduler refuses (and counts) a ``Request``
    carrying them with the reference's ``ValueError``, and a vlm model
    refuses chunking outright."""
    cfg, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, max_seq=64, max_batch=2, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill cannot split patch embeddings"):
        eng.scheduler(2, chunk_size=8).submit(
            Request(prompt=np.arange(4), max_new_tokens=2,
                    patch_embeds=np.zeros((2, cfg.d_model), np.float32)))
    assert eng.stats.rejected_submissions == 1
    vlm = TModel(tget("internvl2-2b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(vlm, vlm.init(0), max_seq=32, device="cpu").scheduler(2, chunk_size=8)
