"""The port's dense model against the JAX package on the CPU, in float32:
layers op by op, the weight bridge, and the logits of prefill (exact and
bucketed), prefix prefill, slot decode and paged decode. Parameters come
from the JAX init through numpy; token inputs from a numpy seed. Logit
tolerance 1e-4: both sides run float32 products and softmaxes whose
summation order differs (observed gaps are ~1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.models import layers as jl
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tl
from repro_torch.models.model import Model as TModel

ATOL = 1e-4
G3 = dict(n_heads=9, n_kv_heads=3, head_dim=16, d_model=144)  # smollm's g = 3


@pytest.fixture(scope="module", params=["reduced", "g3"])
def pair(request):
    jcfg = jget("smollm-135m").reduced()
    tcfg = tget("smollm-135m").reduced()
    if request.param == "g3":
        jcfg, tcfg = dataclasses.replace(jcfg, **G3), dataclasses.replace(tcfg, **G3)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tcfg, device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
          jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    pos = np.array([[0, 3, 7, 100, 2047]], np.int32)
    tc, ts = tl.rope_tables(torch.from_numpy(pos), 16, 10_000.0)
    jc, js = jl.rope_tables(jnp.asarray(pos), 16, 10_000.0)
    close(tc, jc, 1e-5)
    close(ts, js, 1e-5)
    close(tl.apply_rope(torch.from_numpy(x[:1]), tc, ts),
          jl.apply_rope(jnp.asarray(x[:1]), jc, js), 1e-5)
    h = rng.normal(size=(2, 5, 8)).astype(np.float32)
    w1, w3 = (rng.normal(size=(8, 12)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(size=(12, 8)).astype(np.float32)
    close(tl.swiglu(*(torch.from_numpy(a) for a in (h, w1, w3, w2))),
          jl.swiglu(*(jnp.asarray(a) for a in (h, w1, w3, w2))), 1e-5)
    emb = rng.normal(size=(10, 4)).astype(np.float32)
    ids = np.array([[1, 9, 0]], np.int32)
    close(tl.embed_tokens(torch.from_numpy(emb), torch.from_numpy(ids)),
          jl.embed_tokens(jnp.asarray(emb), jnp.asarray(ids)), 0)


def test_weight_bridge_round_trips(pair):
    _, _, jp, _, tp = pair
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_torch_native_init_scales():
    cfg = tget("smollm-135m").reduced()
    p = TModel(cfg, device="cpu").init(seed=0)
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    assert abs(float(p["embed"].std()) - D**-0.5) < 0.1 * D**-0.5
    assert abs(float(p["layers"]["attn"]["wo"].std()) - (H * hd) ** -0.5) < 0.1 * (H * hd) ** -0.5
    again = TModel(cfg, device="cpu").init(seed=0)
    assert torch.equal(p["layers"]["mlp"]["w2"], again["layers"]["mlp"]["w2"])


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_prefill_exact_and_bucketed(pair):
    cfg, jm, jp, tm, tp = pair
    toks = _prompts(cfg, (2, 11), 1)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks), 32)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), 32)
    close(tlog, jlog)
    close(tc["k"], jc["k"])
    assert tc["len"].tolist() == [11, 11]
    padded = np.zeros((2, 16), np.int32)
    padded[0, :11], padded[1, :7] = toks[0], toks[1, :7]
    plen = np.array([11, 7], np.int32)
    jlog, jc = jm.prefill(jp, jnp.asarray(padded), 32, prompt_len=jnp.asarray(plen))
    tlog, tc = tm.prefill(tp, torch.from_numpy(padded), 32, prompt_len=plen)
    close(tlog, jlog)
    close(tc["v"], jc["v"])
    assert tc["len"].tolist() == [11, 7]


def test_prefill_with_prefix(pair):
    cfg, jm, jp, tm, tp = pair
    full = _prompts(cfg, (1, 21), 2)
    h = 16
    _, jc = jm.prefill(jp, jnp.asarray(full[:, :h]), 32)
    pk, pv = np.array(jc["k"])[:, :, :h], np.array(jc["v"])[:, :, :h]
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = full[0, h:]
    slen = np.array([5], np.int32)
    jlog, jcache = jm.prefill_with_prefix(
        jp, jnp.asarray(suffix), jnp.asarray(pk), jnp.asarray(pv), 32,
        suffix_len=jnp.asarray(slen),
    )
    tlog, tcache = tm.prefill_with_prefix(
        tp, torch.from_numpy(suffix), torch.from_numpy(pk), torch.from_numpy(pv), 32,
        suffix_len=slen,
    )
    close(tlog, jlog)
    close(tcache["k"][:, :, : h + 5], np.asarray(jcache["k"])[:, :, : h + 5])
    assert tcache["len"].tolist() == [h + 5]
    # and the suffix prefill equals a cold prefill of the whole prompt
    cold, _ = tm.prefill(tp, torch.from_numpy(full), 32)
    close(tlog, cold)


def test_decode_step_slot(pair):
    cfg, jm, jp, tm, tp = pair
    padded = np.zeros((2, 16), np.int32)
    padded[0, :13] = _prompts(cfg, (13,), 3)
    padded[1, :6] = _prompts(cfg, (6,), 4)
    plen = np.array([13, 6], np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(padded), 24, prompt_len=jnp.asarray(plen))
    _, tc = tm.prefill(tp, torch.from_numpy(padded), 24, prompt_len=plen)
    tok = _prompts(cfg, (2, 1), 5)
    for _ in range(3):  # rows decode at their own, different lengths
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


def test_decode_step_paged(pair):
    cfg, jm, jp, tm, tp = pair
    rng = np.random.default_rng(6)
    NB, BS, MB = 10, 4, 4
    shape = (cfg.num_layers, NB + 1, BS, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    tables = np.full((3, MB), NB, np.int32)  # row 2 is dead: all null block
    tables[0, :3] = [4, 1, 7]
    tables[1, :2] = [0, 9]
    lens = np.array([9, 4, 0], np.int32)  # row 1 writes at a block boundary
    tok = _prompts(cfg, (3, 1), 7)
    jlog, jpool = jm.decode_step_paged(
        jp, {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(tok),
    )
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tlog, tpool = tm.decode_step_paged(
        tp, tpool, torch.from_numpy(tables), torch.from_numpy(lens), torch.from_numpy(tok)
    )
    close(tlog, jlog)
    for n in ("k", "v"):  # the new rows landed where the reference put them
        close(tpool[n][:, :NB], np.asarray(jpool[n])[:, :NB])
