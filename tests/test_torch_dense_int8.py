"""The int8 paged KV pool and the three dense configs the port serves beside
smollm-135m (``stablelm-3b`` with ``kv_quant``, ``phi3-medium-14b`` and
``internlm2-20b``, both GQA with an untied head) against the JAX package on
the CPU, float32 at ``.reduced()`` size with JAX parameters carried over:
the configs field for field; the int8 pool's leaves; the paged decode and
verify steps on an int8 pool through both backends (logits within 1e-4,
written int8 entries within 1, the recorded rounding-tie difference,
scales within 1e-2 relative); ``gather_prefix`` dequantizing a hit chain
as the reference does; ``write_prefill`` writing the scales; int8 paged
serving (plain, prefix reuse, K = 4 n-gram speculation, 8-token chunks,
preemption, the kernel backend) token-identical to the JAX engine; the two
GQA configs served token-identically on the paged layout; and
``Model.init`` drawing, after its in-place scaling, bitwise what it drew
before. Workloads run on a step clock (``drive``), so that admission does
not depend on either package's speed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import PagedKVCache as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models.model import Model as TModel
from repro_torch.serve import PagedKVCache, Request, ServingEngine, SpecConfig

ATOL = 1e-4  # float32 logits, JAX against the port
INT8_ATOL = 1.01  # an int8 entry may differ by one where XLA and torch round a tie apart
SCALE_RTOL = 1e-2  # a bfloat16 scale: one rounding step of its 8-bit mantissa

NEW_ARCHS = ["stablelm-3b", "phi3-medium-14b", "internlm2-20b"]


def _pair(arch):
    jcfg = jget(arch).reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget(arch).reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def int8():
    """Reduced stablelm-3b: dense, MHA, ``kv_quant`` (its int8 pool)."""
    return _pair("stablelm-3b")


def close(a, b, atol=ATOL, rtol=None):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=atol if rtol is None else rtol)


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


def _workload(R, cfg, lens=(13, 5, 29, 8, 17), priorities=(0, 1, 0, 1, 1), tokens=6,
              header=0):
    """Staggered requests; ``header`` > 0 starts every prompt with the same
    ``header`` tokens, so later ones hit the prefix trie."""
    head = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(header,))
    out = []
    for i, (s0, pr) in enumerate(zip(lens, priorities)):
        tail = np.random.default_rng(100 + i).integers(0, cfg.vocab_size, size=(s0,))
        out.append(R(prompt=np.concatenate([head, tail]).astype(np.int32),
                     max_new_tokens=tokens, arrival_time=0.005 * i, priority=pr))
    return out


def _pressure(R):
    """Two long low-priority requests admitted first, then a high-priority
    arrival that needs their row (as ``tests/test_torch_preemption.py``)."""
    low = [R(prompt=np.arange(20, dtype=np.int32) + i, max_new_tokens=10, arrival_time=0.0,
             priority=0) for i in range(2)]
    return low + [R(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4, arrival_time=0.02,
                    priority=5)]


# ---------------------------------------------------------------------------
# configs and pool layout


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_jax(arch):
    """Each copied config equals the JAX package's field for field, full
    size and ``.reduced()``."""
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(tget(arch).reduced()) == dataclasses.asdict(jget(arch).reduced())
    assert tget(arch).kv_quant == (arch == "stablelm-3b")


def test_init_paged_cache_int8_matches_jax(int8):
    """A ``kv_quant`` model's pool: int8 k/v [L,NB,BS,KV,hd] beside bfloat16
    scales [L,NB,BS,KV], the JAX pool's leaves, shapes and dtypes."""
    _, jm, _, tm, _ = int8
    jpool, tpool = jm.init_paged_cache(9, 4), tm.init_paged_cache(9, 4)
    assert sorted(tpool) == sorted(jpool) == ["k", "k_scale", "v", "v_scale"]
    for name, leaf in tpool.items():
        assert tuple(leaf.shape) == tuple(jpool[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(jpool[name].dtype), name
    assert tpool["k"].dtype == torch.int8 and tpool["k_scale"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the paged steps on an int8 pool


def _int8_pool(cfg, seed=6):
    """A random int8 pool with bfloat16-exact scales, three rows' tables
    (row 2 dead: all null block) and their lengths."""
    rng = np.random.default_rng(seed)
    NB, BS, MB = 12, 4, 5
    shape = (cfg.num_layers, NB + 1, BS, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.integers(-127, 128, size=shape).astype(np.int8) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        s = rng.uniform(0.5, 2.0, size=shape[:4]).astype(np.float32)
        pool[n] = torch.from_numpy(s).to(torch.bfloat16).float().numpy()  # exact in bf16
    tables = np.full((3, MB), NB, np.int32)
    tables[0, :4] = [4, 1, 7, 10]
    tables[1, :3] = [0, 9, 3]
    lens = np.array([9, 6, 0], np.int32)  # row 1's 5 verify rows cross a block boundary
    return pool, tables, lens, NB


def _jax_pool(pool):
    return {n: jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_scale") else jnp.asarray(a)
            for n, a in pool.items()}


def _torch_pool(pool):
    return {n: torch.from_numpy(a.copy()).to(torch.bfloat16) if n.endswith("_scale")
            else torch.from_numpy(a.copy()) for n, a in pool.items()}


@pytest.mark.parametrize("T", [1, 5], ids=["decode", "verify5"])
@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_paged_step_int8_matches_jax(int8, backend, T, monkeypatch):
    """``decode_step_paged`` (T = 1) and ``verify_step_paged`` (T = 5) over
    an int8 pool: the reference backend against JAX's reference, the
    kernel layer loop (the paged kernel's wrapper taking its plain version
    on CPU tensors) against JAX's Pallas kernel in interpret mode. Logits
    within 1e-4; the rows written (quantized, beside their scales) where
    JAX writes them, int8 within 1 and scales within 1e-2 relative."""
    jcfg, jm, jp, tm, tp = int8
    if backend == "kernel":
        monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    pool, tables, lens, NB = _int8_pool(jcfg)
    tok = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, T)).astype(np.int32)
    jback = "reference" if backend == "reference" else "interpret"
    args = (jnp.asarray(tables), jnp.asarray(lens))
    targs = (torch.from_numpy(tables), torch.from_numpy(lens))
    if T == 1:
        jlog, jpool = jm.decode_step_paged(jp, _jax_pool(pool), *args, jnp.asarray(tok),
                                           backend=jback)
        tlog, tpool = tm.decode_step_paged(tp, _torch_pool(pool), *targs,
                                           torch.from_numpy(tok), backend=backend)
    else:
        jlog, jpool = jm.verify_step_paged(jp, _jax_pool(pool), *args, jnp.asarray(tok),
                                           backend=jback)
        tlog, tpool = tm.verify_step_paged(tp, _torch_pool(pool), *targs,
                                           torch.from_numpy(tok), backend=backend)
    close(tlog, jlog)
    assert tpool["k"].dtype == torch.int8 and tpool["k_scale"].dtype == torch.bfloat16
    for n in ("k", "v"):  # the null block (index NB) takes colliding dead-row writes
        close(tpool[n][:, :NB].float(), np.asarray(jpool[n])[:, :NB], INT8_ATOL, 0)
        sc = n + "_scale"
        close(tpool[sc][:, :NB].float(), np.asarray(jpool[sc].astype(jnp.float32))[:, :NB],
              0, SCALE_RTOL)
        assert not np.array_equal(tpool[sc][:, :NB].float().numpy(), pool[sc][:, :NB])


# ---------------------------------------------------------------------------
# the pool's prefill install and prefix gather


def _admitted(int8, prompt):
    """Both packages' paged caches with ``prompt`` admitted into row 0 and
    its prefill written (block size 4); returns (jkv, tkv, row, hits)."""
    _, jm, jp, tm, tp = int8
    jkv = JPaged(jm, max_batch=2, max_seq=32, block_size=4)
    tkv = PagedKVCache(tm, max_batch=2, max_seq=32, block_size=4)
    (jrow, jhit), (trow, thit) = jkv.try_admit(1, prompt, 4), tkv.try_admit(1, prompt, 4)
    assert (jrow, jhit) == (trow, thit) == (0, [])
    _, jc = jm.prefill(jp, jnp.asarray(prompt[None]), 32)
    _, tc = tm.prefill(tp, torch.from_numpy(prompt[None]), 32)
    jkv.write_prefill(0, jc)
    tkv.write_prefill(0, tc)
    return jkv, tkv


def test_write_prefill_writes_scales(int8):
    """``write_prefill`` loops over every pool leaf: the scales land in the
    prompt's blocks beside the int8 values, where JAX puts them."""
    jcfg = int8[0]
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (10,)).astype(np.int32)
    jkv, tkv = _admitted(int8, prompt)
    blocks = list(range(3))  # ceil(10 / 4) prompt blocks, ids 0-2
    for n in ("k_scale", "v_scale"):
        got = tkv.pool[n][:, blocks].float().numpy()
        L, KV = got.shape[0], got.shape[-1]
        assert np.count_nonzero(got.reshape(L, 12, KV)[:, :10]) == L * 10 * KV  # each prompt row
        close(got, np.asarray(jkv.pool[n].astype(jnp.float32))[:, blocks], 0, SCALE_RTOL)
    for n in ("k", "v"):
        close(tkv.pool[n][:, blocks].float(), np.asarray(jkv.pool[n])[:, blocks], INT8_ATOL, 0)
    assert not tkv.pool["k_scale"][:, 3:].any()  # nothing past the prompt's blocks


def test_gather_prefix_int8_dequantizes_like_jax(int8):
    """An int8 hit chain comes back dequantized to the model's dtype with
    the chain's scales, as the reference's ``gather_prefix`` does (before,
    the port returned the raw int8 codes): on the same pool the two agree
    to float32 rounding, and the rows are the prefill's k/v within one
    quantization step (half a step of rounding, and the bfloat16 scale's
    own rounding)."""
    jcfg, _, _, tm, tp = int8
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (12,)).astype(np.int32)
    jkv, tkv = _admitted(int8, prompt)
    for n, leaf in jkv.pool.items():  # the same codes and scales in both pools
        tkv.pool[n].copy_(torch.tensor(np.asarray(leaf.astype(jnp.float32))))
    hits = [0, 1]
    jk, jv = jkv.gather_prefix(hits)
    tk, tv = tkv.gather_prefix(hits)
    assert tk.dtype == tv.dtype == tm.dtype and tuple(tk.shape) == jk.shape
    assert jk.shape == (jcfg.num_layers, 1, 8, jcfg.n_kv_heads, jcfg.head_dim)
    close(tk, jk, 1e-6)
    close(tv, jv, 1e-6)
    _, kvs = tm.forward(tp, torch.from_numpy(prompt[None]))
    k_true = torch.stack([k for k, _ in kvs])[:, :, :8]
    step = k_true.abs().amax(-1, keepdim=True) / 127
    assert ((tk - k_true).abs() <= step).all()


# ---------------------------------------------------------------------------
# serving on the int8 pool


def test_paged_int8_matches_slotted_and_jax(int8):
    """The int8 pool pages bit-identically: two distinct prompts served on
    the paged layout decode what the slot layout's ``generate`` decodes, and
    what the JAX engine's paged serve decodes (the reference's
    ``test_paged_matches_slotted_with_int8_kv``)."""
    jcfg, jm, jp, tm, tp = int8
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    base = ServingEngine(tm, tp, max_seq=32, device="cpu").generate(prompts, 4).numpy()
    te = ServingEngine(tm, tp, max_seq=32, kv_layout="paged", block_size=8, device="cpu")
    je = JEngine(jm, jp, max_seq=32, kv_layout="paged", block_size=8)

    def reqs(R):
        return [R(prompt=prompts[i], max_new_tokens=4, arrival_time=0.01 * i) for i in range(2)]

    treqs = reqs(Request)
    got = drive(te.scheduler(2), treqs)
    assert all(r.prefix_hit == 0 for r in treqs)
    assert_same(got, list(base), "paged vs slot")
    assert_same(got, drive(je.scheduler(2), reqs(JRequest)), "vs JAX")


def test_int8_prefix_reuse_matches_cold_prefill(int8):
    """Shared-prefix reuse on the int8 pool: the hit blocks dequantize into
    the suffix prefill. The second prompt hits 12 tokens, and its greedy
    tokens equal a cold reuse-off run's and the JAX engine's (the
    reference's ``test_int8_prefix_reuse_matches_cold_prefill``)."""
    jcfg, jm, jp, tm, tp = int8
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, jcfg.vocab_size, (16,)).astype(np.int32)
    p2 = np.concatenate([p1[:12], rng.integers(0, jcfg.vocab_size, (4,))]).astype(np.int32)
    kw = dict(max_seq=64, kv_layout="paged", block_size=4)
    cold = ServingEngine(tm, tp, prefix_cache=False, device="cpu", **kw)
    colds = []
    for p in (p1, p2):
        r = Request(prompt=p, max_new_tokens=4)
        colds.append(cold.serve([r], max_batch=2)[r.rid])
    te = ServingEngine(tm, tp, device="cpu", **kw)
    sched = te.scheduler(2)
    r1, r2 = Request(prompt=p1, max_new_tokens=4), Request(prompt=p2, max_new_tokens=4)
    out = sched.run([r1, r2])
    sched.kv.check_invariants()
    assert r1.prefix_hit == 0 and r2.prefix_hit == 12
    np.testing.assert_array_equal(out[r1.rid], colds[0])
    np.testing.assert_array_equal(out[r2.rid], colds[1])
    jsched = JEngine(jm, jp, **kw).scheduler(2)
    j1, j2 = JRequest(prompt=p1, max_new_tokens=4), JRequest(prompt=p2, max_new_tokens=4)
    jout = jsched.run([j1, j2])
    np.testing.assert_array_equal(out[r2.rid], jout[j2.rid])
    assert j2.prefix_hit == 12


def test_int8_paged_kernel_backend_token_identical(int8, monkeypatch):
    """A staggered shared-prefix trace through the kernel backend (the
    paged kernel's int8 mode and flash, their plain versions on CPU
    tensors) decodes what the reference backend and the JAX engine's
    Pallas interpret mode decode (the reference's
    ``test_serve_kernel_backend_token_identical_int8[paged]``)."""
    jcfg, jm, jp, tm, tp = int8
    monkeypatch.setattr(tops, "require_cuda", lambda t, what: None)
    kw = dict(max_seq=64, kv_layout="paged", block_size=4)
    te = ServingEngine(tm, tp, device="cpu", **kw)
    outs = {b: drive(te.scheduler(3, attention_backend=b), _workload(Request, jcfg, header=8))
            for b in ("reference", "kernel")}
    want = drive(JEngine(jm, jp, **kw).scheduler(3, attention_backend="interpret"),
                 _workload(JRequest, jcfg, header=8))
    assert_same(outs["kernel"], outs["reference"], "kernel vs reference")
    assert_same(outs["kernel"], want, "vs JAX")


@pytest.mark.parametrize("mode", ["spec4", "chunk8", "chunk8+spec4"])
def test_int8_paged_serving_modes_match_jax(int8, mode):
    """K = 4 n-gram speculation (verify at T = 5 over the int8 pool, the
    rejected tail rewound), 8-token chunked prefill (each chunk over the
    staging cache's int8 identity view, a trie hit seeding it) and both
    together, on a shared-prefix trace: streams equal the JAX engine's,
    acceptance counts too, and the pool returns every block."""
    jcfg, jm, jp, tm, tp = int8
    kw = dict(max_seq=128, kv_layout="paged", block_size=8, max_batch=3)
    spec, chunk = "spec4" in mode, 8 if "chunk8" in mode else 0
    te, je = ServingEngine(tm, tp, device="cpu", **kw), JEngine(jm, jp, **kw)
    sched = te.scheduler(3, chunk_size=chunk, spec=SpecConfig(k=4) if spec else None)
    treqs = _workload(Request, jcfg, header=16)
    got = drive(sched, treqs)
    sched.kv.check_invariants()
    assert all(r.finished for r in treqs)
    jreqs = _workload(JRequest, jcfg, header=16)
    want = drive(je.scheduler(3, chunk_size=chunk, spec=JSpec(k=4) if spec else None), jreqs)
    assert_same(got, want, f"{mode} vs JAX")
    assert [r.prefix_hit for r in treqs] == [r.prefix_hit for r in jreqs]
    assert any(r.prefix_hit > 0 for r in treqs)
    if spec:
        assert te.stats.spec_accepted == je.stats.spec_accepted
        assert te.stats.spec_proposed == je.stats.spec_proposed > 0
    if chunk:
        assert sched.widths["chunk"] and not sched.widths["prefill"]


def test_int8_paged_preemption_matches_jax(int8):
    """A high-priority arrival evicts a low-priority row of a tight int8
    pool; the evicted row's committed blocks park in the trie and its
    resume dequantizes them as a prefix hit. Streams, evictions and
    recomputed tokens equal the JAX engine's, and the resumed stream
    equals an uninterrupted run's."""
    _, jm, jp, tm, tp = int8
    kw = dict(max_seq=128, kv_layout="paged", block_size=8)
    te = ServingEngine(tm, tp, max_batch=2, num_blocks=10, device="cpu", **kw)
    je = JEngine(jm, jp, max_batch=2, num_blocks=10, **kw)
    roomy = ServingEngine(tm, tp, max_batch=4, device="cpu", **kw)
    treqs = _pressure(Request)
    got = drive(te.scheduler(2), treqs)
    want = drive(je.scheduler(2), _pressure(JRequest))
    assert te.stats.n_preemptions == je.stats.n_preemptions > 0
    assert te.stats.recomputed_tokens == je.stats.recomputed_tokens
    assert any(r.preemptions > 0 for r in treqs)
    assert_same(got, want, "vs JAX")
    assert_same(got, drive(roomy.scheduler(4, chunk_size=0), _pressure(Request)),
                "vs uninterrupted")


# ---------------------------------------------------------------------------
# the GQA configs at hd 128 (reduced): untied head, bf16 pool


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "internlm2-20b"])
def test_gqa_config_serves_like_jax(arch):
    """Reduced phi3-medium-14b and internlm2-20b (GQA, untied LM head, a
    float pool) served on the paged layout with a shared-prefix trace:
    token-identical to the JAX engine, prefix hits included."""
    jcfg, jm, jp, tm, tp = _pair(arch)
    assert "lm_head" in tp and not tm.cfg.kv_quant
    kw = dict(max_seq=64, kv_layout="paged", block_size=4)
    treqs = _workload(Request, jcfg, header=8)
    got = drive(ServingEngine(tm, tp, device="cpu", **kw).scheduler(3), treqs)
    jreqs = _workload(JRequest, jcfg, header=8)
    assert_same(got, drive(JEngine(jm, jp, **kw).scheduler(3), jreqs), "vs JAX")
    assert [r.prefix_hit for r in treqs] == [r.prefix_hit for r in jreqs]


# ---------------------------------------------------------------------------
# Model.init: scaled in place, the same values


def _init_before(cfg, seed):
    """The dense family's parameters as ``Model.init`` drew them before it
    scaled in place: each leaf a float32 draw, times its scale into a new
    tensor, then cast; the same leaves in the same order."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    L, D, H, KV, hd = cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, V = cfg.d_ff, cfg.padded_vocab

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (x * scale).to(dt)

    out = {"embed": normal((V, D), D**-0.5)}
    out["wq"] = normal((L, D, H, hd), D**-0.5)
    out["wk"] = normal((L, D, KV, hd), D**-0.5)
    out["wv"] = normal((L, D, KV, hd), D**-0.5)
    out["wo"] = normal((L, H, hd, D), (H * hd) ** -0.5)
    out["w1"] = normal((L, D, F), D**-0.5)
    out["w3"] = normal((L, D, F), D**-0.5)
    out["w2"] = normal((L, F, D), F**-0.5)
    if not cfg.tie_embeddings:
        out["lm_head"] = normal((D, V), D**-0.5)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m"] + NEW_ARCHS)
def test_init_in_place_scaling_is_bitwise_the_same(arch, dtype):
    """``Model.init`` scales each float32 draw in place (one float32 copy of
    a leaf at a time, which a 20B model's 19 GB ``w2`` needs): the reduced
    dense configs' parameters are bitwise what the copy-then-scale draw
    gave, from the same random stream, in float32 and bfloat16."""
    cfg = dataclasses.replace(tget(arch).reduced(), dtype=dtype)
    params = TModel(cfg, device="cpu").init(seed=3)
    want = _init_before(cfg, 3)
    layers = params["layers"]
    got = {"embed": params["embed"], **layers["attn"], **layers["mlp"]}
    if "lm_head" in params:
        got["lm_head"] = params["lm_head"]
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].dtype == leaf.dtype and torch.equal(got[name], leaf), name
