"""The port's hybrid family (zamba2-2.7b) and its int8 KV cache against the
JAX package on the CPU, in float32.

- ``quantize_kv``/``dequantize_kv``: int8 values equal and scales bitwise.
- The paged kernel's plain version over int8 pools against the JAX oracle
  and the Pallas kernel in interpret mode, at g = 1 and g = 2: tolerance
  1e-5 (float32 softmaxes summed in different orders).
- The hybrid at the reduced zamba2 config with 4 layers (2 attention
  sites, g = 2) and a g = 1 variant, through the weight bridge: prefill
  logits, caches and SSM states, 6 decode steps, ``serve()`` and
  ``generate()``. Logits and states within 1e-4 (float32 products and
  scans in other summation orders; observed ~5e-6). int8 caches: XLA and
  torch may compute k a rounding apart, which can put ``x / scale · 127``
  on the other side of a .5 tie, so the int8 leaves may differ by 1 on at
  most 0.1% of entries, and their scales by one bfloat16 rounding (2^-8
  relative). Decode logits read those caches: where a tie did flip an
  entry, they are held within 1e-2 (one int8 step, scale / 127, in one
  key or value moves a logit by ~2e-3), else within 1e-4; greedy tokens
  must be identical.
- Dense ``kv_quant`` on the slot layout (reduced smollm-135m), as
  ``tests/test_models.py::test_int8_kv_cache_decode_accuracy`` holds the
  JAX package: against JAX, and within 5% of the float cache's logits;
  its paged pool has the JAX pool's leaves and serves the same streams.

Inputs come from numpy seeds and are handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.serve import ServingEngine as JEngine
from repro.serve import make_requests as j_requests
from repro.serve.differential import assert_streams_equal
from repro_torch.configs import get_config as tget
from repro_torch.kernels import _build
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve import make_requests as t_requests

ATOL = 1e-4
TIE_ATOL = 1e-2  # decode logits after a .5 tie flipped an int8 cache entry
KERNEL_ATOL = 1e-5
ARCH = "zamba2-2.7b"
VARIANTS = {"g2": {}, "g1": {"n_kv_heads": 4}}  # reduced: 4 heads over 2 or 4 kv heads


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(dataclasses.replace(tget(arch).reduced(), **over), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return _pair(ARCH, num_layers=4, **VARIANTS[request.param])


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# quantization and the int8 kernel's plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 2, 16)) * rng.uniform(0.01, 4.0, size=(3, 7, 2, 1)))
    x[0, 0, 0] = 0.0  # an all-zero vector takes the 1e-6 floor
    # max |x| = 127 makes x / scale · 127 = x: exact .5 ties, which round
    # half to even (0.5 → 0, 1.5 → 2, 2.5 → 2)
    x[1, 2, 1] = 0.0
    x[1, 2, 1, :7] = [127.0, 0.5, -0.5, 1.5, 2.5, -2.5, 3.5]
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jattn.quantize_kv(jx)
    tq, ts = tattn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tq[1, 2, 1, :7].tolist() == [127, 0, 0, 2, 2, -2, 4]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))  # bitwise
    for out in ("float32", "bfloat16"):
        jd = jattn.dequantize_kv(jq, js, getattr(jnp, out))
        td = tattn.dequantize_kv(tq, ts, getattr(torch, out))
        assert td.dtype == getattr(torch, out)
        np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd, np.float32))


def _int8_paged_inputs(g, t, seed):
    """int8 pools and bf16 scales quantized from float pools, tables with
    a dead row, block-boundary lengths and a null block in a live window."""
    B, KV, hd, NB, BS, MB = 4, 2, 16, 12, 8, 4
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, KV * g, hd)).astype(np.float32)
    kq, ks = jattn.quantize_kv(jnp.asarray(rng.normal(size=(NB + 1, BS, KV, hd)), jnp.float32))
    vq, vs = jattn.quantize_kv(jnp.asarray(rng.normal(size=(NB + 1, BS, KV, hd)), jnp.float32))
    tbl = rng.integers(0, NB, size=(B, MB)).astype(np.int32)
    lens = np.array([0, BS, 2 * BS, 3 * BS - t - 1], np.int32)
    for b in range(B):
        tbl[b, -(-(lens[b] + t) // BS):] = NB
    tbl[3, 1] = NB
    return q, kq, vq, tbl, lens, ks, vs


def _torch(*arrays):
    """numpy or JAX arrays as torch tensors of the same dtype (bf16 too)."""
    return [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("g", [1, 2])
def test_int8_paged_plain_matches_pallas_and_oracle(g, t):
    arrays = _int8_paged_inputs(g, t, seed=10 * g + t)
    q, kq, vq, tbl, lens, ks, vs = _torch(*arrays)
    assert ks.dtype == torch.bfloat16 and kq.dtype == torch.int8
    pda.paged_decode_attention.launches = pda.paged_decode_attention.launches_int8 = 0
    got = pda.paged_decode_attention(q, kq, vq, tbl, lens, ks, vs)
    assert pda.paged_decode_attention.launches_int8 == 0 and _build._lib is None
    j = [jnp.asarray(a) for a in arrays]
    pallas = jops.paged_attention(*j[:5], j[5], j[6], mode="interpret")
    oracle = jref.paged_attention_ref(*j[:5], k_scale=j[5], v_scale=j[6])
    close(got, pallas, KERNEL_ATOL)
    close(got, oracle, KERNEL_ATOL)
    close(tref.paged_attention_ref(q, kq, vq, tbl, lens, ks, vs), oracle, KERNEL_ATOL)
    assert torch.isfinite(got).all()


def test_int8_wrapper_refuses_bad_scale_combinations():
    q, kq, vq, tbl, lens, ks, vs = _torch(*_int8_paged_inputs(1, 1, seed=0))
    kf = kq.float()
    with pytest.raises(ValueError, match="need k_scale and v_scale"):
        pda.paged_decode_attention(q, kq, vq, tbl, lens, ks, None)
    with pytest.raises(ValueError, match="int8 pools only"):
        pda.paged_decode_attention(q, kf, vq.float(), tbl, lens, ks, vs)
    with pytest.raises(ValueError, match="bfloat16 of shape"):
        pda.paged_decode_attention(q, kq, vq, tbl, lens, ks.float(), vs)
    with pytest.raises(ValueError, match="bfloat16 of shape"):
        pda.paged_decode_attention(q, kq, vq, tbl, lens, ks, vs[:, :4])
    with pytest.raises(TypeError, match="differ"):
        pda.paged_decode_attention(q, kq, vq.float(), tbl, lens, ks, vs)
    with pytest.raises(TypeError, match="share q's type"):
        pda.paged_decode_attention(q, kf.bfloat16(), vq.bfloat16(), tbl, lens)
    # int8 pools the kernel cannot copy 16 bytes at a time (a head dim off
    # a multiple of 16, storage off a 16-byte boundary) take its element
    # loads on the card, and the plain version here
    narrow = [t[..., :8].contiguous() for t in (q, kq, vq)]
    B, T, H, hd = narrow[0].shape
    NB, BS, KV, _ = kq.shape
    plan = pda.paged_plan(q.dtype, torch.int8, B, T, H, KV, hd, BS, tbl.shape[1])
    assert plan["path"] == "direct"
    close(pda.paged_decode_attention(*narrow, tbl, lens, ks, vs),
          tref.paged_attention_ref(*narrow, tbl, lens, ks, vs), KERNEL_ATOL)
    shifted = torch.empty(kq.numel() + 1, dtype=torch.int8)[1:].view(kq.shape)  # 1-byte offset
    shifted.copy_(kq)
    aligned = pda._build.aligned16(shifted, vq)
    assert not aligned
    plan = pda.paged_plan(q.dtype, torch.int8, *q.shape[:3], KV, q.shape[3], BS, tbl.shape[1],
                          aligned)
    assert plan["path"] == "direct"
    assert torch.equal(pda.paged_decode_attention(q, shifted, vq, tbl, lens, ks, vs),
                       pda.paged_decode_attention(q, kq, vq, tbl, lens, ks, vs))
    with pytest.raises(ValueError, match="k_scale on meta"):
        pda.paged_decode_attention(q, kq, vq, tbl, lens, ks.to("meta"), vs)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pda.paged_decode_attention(*(t.to("meta") for t in (q, kq, vq, tbl, lens, ks, vs)))


@pytest.mark.parametrize("smax", [24, 13])
def test_int8_identity_table_view_matches_dequantized_reference(smax):
    """The slot layout's int8 route into the kernel wrapper (the cache and
    its scales viewed as an identity-table pool; the plain version on CPU
    tensors) against the reference branch, which dequantizes the cache to
    q's dtype first, and against the JAX package's reference branch."""
    rng = np.random.default_rng(smax)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, smax, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, smax, 2, 16)).astype(np.float32)
    clen = np.array([3, smax - 1], np.int32)
    (kq, ks), (vq, vs) = tattn.quantize_kv(torch.from_numpy(k)), tattn.quantize_kv(torch.from_numpy(v))
    tq, tlen = torch.from_numpy(q), torch.from_numpy(clen)
    got = tattn._kernel_cached_attention(tq, kq, vq, tlen, ks, vs)
    ref = tattn._cached_attention(tq, kq, vq, tlen, k_scale=ks, v_scale=vs, backend="reference")
    jq = [jnp.asarray(a) for a in (q, k, v)]
    (jkq, jks), (jvq, jvs) = jattn.quantize_kv(jq[1]), jattn.quantize_kv(jq[2])
    want = jattn._cached_attention(jq[0], jkq, jvq, jnp.asarray(clen), k_scale=jks,
                                   v_scale=jvs, backend="reference")
    close(got, ref, KERNEL_ATOL)
    close(ref, want, KERNEL_ATOL)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn._cached_attention(tq, kq, vq, tlen, k_scale=ks, v_scale=vs, backend="kernel")


# ---------------------------------------------------------------------------
# the hybrid model


def _close_int8(t, j):
    """int8 leaves: equal but for |Δ| ≤ 1 on at most 0.1% of entries."""
    d = t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32)
    assert np.abs(d).max() <= 1 and (d != 0).mean() <= 1e-3, (np.abs(d).max(), (d != 0).mean())


def _close_decode_logits(tlog, jlog, tc, jc):
    flipped = any((tc[n].numpy() != np.asarray(jc[n])).any() for n in ("k", "v"))
    close(tlog, jlog, TIE_ATOL if flipped else ATOL)


def _close_caches(tc, jc):
    assert sorted(tc) == sorted(jc)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8 and tuple(tc[name].shape) == jc[name].shape
        _close_int8(tc[name], jc[name])
    for name in ("k_scale", "v_scale"):
        assert tc[name].dtype == torch.bfloat16 and tuple(tc[name].shape) == jc[name].shape
        close(tc[name], jc[name], 2.0**-8)
    for k, v in jc.get("ssm_state", {}).items():
        assert tuple(tc["ssm_state"][k].shape) == v.shape
        close(tc["ssm_state"][k], v)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("s", [16, 21])
def test_hybrid_prefill_and_decode_match_jax(pair, s):
    cfg, jm, jp, tm, tp = pair
    G = cfg.num_layers // cfg.attn_every
    toks = _prompts(cfg, (2, s), s)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks), 48)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), 48)
    assert G == 2 and tuple(tc["k"].shape) == (G, 2, 48, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(tc["ssm_state"]["ssm"].shape[:2]) == (cfg.num_layers, 2)
    close(tlog, jlog)
    _close_caches(tc, jc)
    tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for _ in range(6):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_decode_logits(tlog, jlog, tc, jc)
        nxt = np.asarray(jnp.argmax(jlog, -1))
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), nxt)
        tok = nxt[:, None].astype(np.int32)
    _close_caches(tc, jc)


def test_hybrid_serve_and_generate_streams_match_jax(pair):
    cfg, jm, jp, tm, tp = pair

    def reqs(make):
        return make(4, 1e4, vocab=cfg.vocab_size, max_new_tokens=6, prompt_lens=(7, 13, 16),
                    rng=np.random.default_rng(2))

    je = JEngine(jm, jp, max_seq=48)
    te = ServingEngine(tm, tp, max_seq=48, device="cpu")
    jreq, treq = reqs(j_requests), reqs(t_requests)
    assert [len(r.prompt) for r in treq] == [len(r.prompt) for r in jreq]
    want = je.serve(jreq, max_batch=2)
    sched = te.scheduler(2)
    got = sched.run(treq)
    assert_streams_equal(want, got, label="hybrid slot")
    sched.kv.check_invariants()
    prompts = _prompts(cfg, (2, 13), 9)
    jg = np.asarray(je.generate(jnp.asarray(prompts), 5))
    np.testing.assert_array_equal(te.generate(prompts, 5).numpy(), jg)


def test_hybrid_wave_groups_by_exact_length_unpadded(pair, monkeypatch):
    """Hybrid prompts take the SSM family's route: one prefill call per
    exact length, no ``prompt_len``."""
    cfg, _, _, tm, tp = pair
    calls = []
    real = tm.prefill

    def spy(params, tokens, max_seq, prompt_len=None, **kw):
        calls.append((tuple(tokens.shape), prompt_len))
        return real(params, tokens, max_seq, prompt_len=prompt_len, **kw)

    monkeypatch.setattr(tm, "prefill", spy)
    reqs = [Request(prompt=_prompts(cfg, (n,), i), max_new_tokens=2)
            for i, n in enumerate((5, 9, 5))]
    ServingEngine(tm, tp, max_seq=48, device="cpu").serve(reqs, max_batch=3)
    assert sorted(calls) == [((1, 9), None), ((2, 5), None)]


def test_hybrid_slot_write_replaces_state_and_kv(pair):
    """A slot write installs every leaf of the slot (int8 KV, scales and
    states); KV rows and their scales may be shorter than the pool, other
    mismatches are refused."""
    cfg, _, _, tm, tp = pair
    pool = tm.init_cache(3, 32)
    for leaf in [pool["k"], pool["v"]] + list(pool["ssm_state"].values()):
        leaf.fill_(7)
    _, c = tm.prefill(tp, torch.from_numpy(_prompts(cfg, (1, 9), 8)), 16)
    tm.write_cache_slot(pool, c, 1)
    got = tm.read_cache_slot(pool, 1)
    for name in ("k", "k_scale", "v", "v_scale"):
        assert torch.equal(got[name][:, :, :16], c[name])
    for k, v in c["ssm_state"].items():
        assert torch.equal(got["ssm_state"][k], v)
        assert (pool["ssm_state"][k][:, [0, 2]] == 7).all()
    assert (pool["k"][:, [0, 2]] == 7).all() and got["len"].tolist() == [9]
    bad = dict(c, k_scale=c["k_scale"][..., :1])
    with pytest.raises(ValueError, match="slot write"):
        tm.write_cache_slot(pool, bad, 0)


def test_hybrid_paged_layout_and_prompt_len_raise_as_in_jax(pair):
    cfg, jm, jp, tm, tp = pair
    with pytest.raises(ValueError, match="attention family"):
        jm.init_paged_cache(4, 8)
    with pytest.raises(ValueError, match="attention family"):
        tm.init_paged_cache(4, 8)
    te = ServingEngine(tm, tp, max_seq=48, kv_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="attention family"):
        te.serve(t_requests(1, 1e4, vocab=cfg.vocab_size, max_new_tokens=2,
                            rng=np.random.default_rng(0)))
    toks = _prompts(cfg, (1, 8), 11)
    with pytest.raises(ValueError, match="padded prefill"):
        tm.prefill(tp, torch.from_numpy(toks), 16, prompt_len=np.array([5], np.int32))


def test_hybrid_kernel_backend_on_cpu_raises(pair):
    cfg, _, _, tm, tp = pair
    cache = tm.init_cache(1, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tm.decode_step(tp, cache, torch.zeros((1, 1), dtype=torch.int32), backend="kernel")


def test_hybrid_weight_bridge_and_native_init():
    """The shared block has no layer axis, in the bridge and in the torch
    init; the bridged tree has the JAX tree's keys, shapes and values."""
    cfg, _, jp, tm, tp = _pair(ARCH, num_layers=4)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    D, H, hd, F = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    native = TModel(dataclasses.replace(tm.cfg, dtype="bfloat16"), device="cpu").init(seed=0)
    assert sorted(native) == sorted(tp)
    sh = native["shared"]
    assert tuple(sh["attn"]["wq"].shape) == (D, H, hd) and tuple(sh["mlp"]["w2"].shape) == (F, D)
    assert tuple(sh["attn_norm"].shape) == (D,) and sh["attn"]["wo"].dtype == torch.bfloat16
    assert abs(float(sh["mlp"]["w1"].float().std()) - D**-0.5) < 0.1 * D**-0.5
    assert tuple(native["layers"]["ssm"]["wx"].shape) == (cfg.num_layers, D, cfg.ssm_d_inner)
    assert len(tm._layer_params(tp)) == cfg.num_layers
    assert [[i for i, _ in grp] for grp in tm._hybrid_groups(tp)] == [[0, 1], [2, 3]]


def test_full_width_config_copies_jax():
    t, j = tget(ARCH), jget(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.ssm_heads, t.ssm_head_dim, t.num_layers // t.attn_every) == (80, 80, 64, 9)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


# ---------------------------------------------------------------------------
# dense kv_quant on the slot layout


@pytest.fixture(scope="module")
def dense_q():
    return _pair("smollm-135m", kv_quant=True)


def test_dense_int8_prefill_and_decode_match_jax(dense_q):
    cfg, jm, jp, tm, tp = dense_q
    toks = _prompts(cfg, (2, 12), 2)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :-1]), 32)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :-1]), 32)
    close(tlog, jlog)
    _close_caches(tc, jc)
    jlog, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, -1:]))
    tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, -1:]))
    _close_decode_logits(tlog, jlog, tc, jc)
    _close_caches(tc, jc)
    # the int8 cache against the float cache, as the JAX package bounds it
    tf = TModel(dataclasses.replace(tm.cfg, kv_quant=False), device="cpu")
    _, fc = tf.prefill(tp, torch.from_numpy(toks[:, :-1]), 32)
    flog, _ = tf.decode_step(tp, fc, torch.from_numpy(toks[:, -1:]))
    rel = float((flog - tlog).abs().max()) / (float(flog.abs().max()) + 1e-9)
    assert rel < 0.05, rel


def test_int8_dead_slot_write_clamps_as_in_jax(dense_q):
    """A dead slot's length runs past max_seq: its quantized token and
    scales land at the last position, as the JAX package's
    dynamic_update_slice clamps them. Both sides decode from the JAX
    package's prefill cache, so the step's writes are compared alone
    (this prompt's own prefill puts one k value on a .5 tie)."""
    cfg, jm, jp, tm, tp = dense_q
    toks = _prompts(cfg, (2, 8), 3)
    _, jc = jm.prefill(jp, jnp.asarray(toks), 16)
    jc["len"] = jnp.asarray([19, 8], jnp.int32)
    tc = {name: t.clone() for name, t in zip(jc, _torch(*jc.values()))}
    jlog, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, :1]))
    tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1]))
    close(tlog, jlog)
    _close_caches(tc, jc)
    assert tc["k_scale"][:, 0, 15].ne(0).all() and tc["len"].tolist() == [20, 9]


def test_dense_int8_slot_serving_matches_jax_and_paged_refuses(dense_q):
    cfg, jm, jp, tm, tp = dense_q

    def reqs(make):
        return make(4, 1e4, vocab=cfg.vocab_size, max_new_tokens=6, prompt_lens=(5, 9, 12),
                    rng=np.random.default_rng(4))

    want = JEngine(jm, jp, max_seq=48).serve(reqs(j_requests), max_batch=2)
    got = ServingEngine(tm, tp, max_seq=48, device="cpu").serve(reqs(t_requests), max_batch=2)
    assert_streams_equal(want, got, label="dense int8 slot")
    # the int8 paged pool no longer refuses: it has the JAX pool's leaves and
    # serves the same streams (tests/test_torch_dense_int8.py holds the rest)
    jpool, tpool = jm.init_paged_cache(4, 8), tm.init_paged_cache(4, 8)
    assert sorted(tpool) == sorted(jpool) == ["k", "k_scale", "v", "v_scale"]
    for name, leaf in tpool.items():
        assert tuple(leaf.shape) == tuple(jpool[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(jpool[name].dtype), name
    paged = ServingEngine(tm, tp, max_seq=48, kv_layout="paged", block_size=8, device="cpu")
    assert_streams_equal(want, paged.serve(reqs(t_requests), max_batch=2), label="dense int8 paged")
