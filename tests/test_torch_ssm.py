"""The port's SSM family against the JAX package on the CPU, in float32
at the reduced mamba2-370m config: the gated norm and the causal conv,
the chunked SSD scan (the kernel's plain version) against the JAX model
path, the Pallas kernel in interpret mode and the sequential oracle, the
Mamba2 block, the model's prefill and decode through the weight bridge,
and the greedy streams of ``serve()`` and ``generate()``. Inputs come from
a numpy seed and are handed to both packages. Tolerance 1e-4: both sides
run the same float32 products and cumsums, summed in different orders
(observed gaps are ~1e-6)."""
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
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.serve import ServingEngine as JEngine
from repro.serve import make_requests as j_requests
from repro.serve.differential import assert_streams_equal
from repro_torch.configs import get_config as tget
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve import make_requests as t_requests

ATOL = 1e-4
ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).reduced()
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(tget(ARCH).reduced(), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _ssd_inputs(b, s, h, hd, n, seed):
    """Scan inputs built as the model builds them: dt = softplus(.), a =
    exp(-dt * 0.7) (A < 0, so a <= 1)."""
    rng = np.random.default_rng(seed)
    xh = (rng.normal(size=(b, s, h, hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = np.exp(-dt * 0.7).astype(np.float32)
    bb = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cc = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    return xh, a, bb, cc, dt


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, z = (rng.normal(size=(2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = rng.normal(size=(32,)).astype(np.float32)
    close(tl.gated_rms_norm(*_t(x, z, scale), 1e-5), jl.gated_rms_norm(*_j(x, z, scale), 1e-5), 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7 if not with_state else 1, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    ty, ts = tssm._causal_conv(*_t(x, w), None if st is None else torch.from_numpy(st))
    jy, js = jssm._causal_conv(*_j(x, w), None if st is None else jnp.asarray(st))
    close(ty, jy, 1e-6)
    close(ts, js, 0)


@pytest.mark.parametrize("s", [32, 24, 13], ids=["multiple", "non-multiple", "prime"])
def test_chunk_scan_matches_jax_model_path(s):
    """Chunk 16 over S = 32 (two chunks), 24 (Q shrinks to 12) and 13
    (prime: Q = 1), y and final state."""
    args = _ssd_inputs(2, s, 4, 16, 8, seed=s)
    ty, ts = tssm._ssd_chunk_scan(*_t(*args), 16)
    jy, js = jssm._ssd_chunk_scan(*_j(*args), 16)
    close(ty, jy)
    close(ts, js)


@pytest.mark.parametrize("b,s,h,hd,n,chunk", [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 8, 32),
])
def test_plain_ssd_scan_matches_pallas_and_oracle(b, s, h, hd, n, chunk):
    """The kernel's plain version against the Pallas kernel (interpret
    mode) and the sequential oracle, at the JAX kernel tests' shapes; the
    port's own sequential oracle too."""
    args = _ssd_inputs(b, s, h, hd, n, seed=s + h)
    y, state = tssd.plain_ssd_scan(*_t(*args), chunk)
    pallas = jops.ssd(*_j(*args), chunk=chunk, mode="interpret")
    oracle = jref.ssd_ref(*_j(*args))
    close(y, pallas)
    close(y, oracle)
    close(tref.ssd_ref(*_t(*args)), oracle)
    _, jstate = jssm._ssd_chunk_scan(*_j(*args), chunk)
    close(state, jstate)


def test_ssd_wrapper_dispatch():
    """CPU tensors take the plain version without building or launching;
    other devices, and mixed devices, raise."""
    args = _t(*_ssd_inputs(1, 20, 2, 16, 8, seed=3))
    tssd.ssd_scan.launches = 0
    y, state = tssd.ssd_scan(*args, 16)
    want_y, want_state = tssd.plain_ssd_scan(*args, 16)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert tssd.ssd_scan.launches == 0 and _build._lib is None
    meta = tuple(t.to("meta") for t in args)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tssd.ssd_scan(*meta)
    with pytest.raises(ValueError, match="b on meta"):
        tssd.ssd_scan(args[0], args[1], meta[2], args[3], args[4])


def test_kernel_backend_on_cpu_tensors_raises(pair):
    cfg, _, _, tm, tp = pair
    x = torch.zeros(1, 4, cfg.d_model)
    lp = tm._layer_params(tp)[0]["ssm"]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tssm.ssm_block(lp, x, tm.cfg, want_state=True, backend="kernel")


def test_ssm_block_prefill_and_decode_match_jax(pair):
    cfg, jm, jp, tm, tp = pair
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 11, cfg.d_model)) * 0.5).astype(np.float32)
    jlp = jax.tree.map(lambda t: t[0], jp["layers"]["ssm"])
    tlp = tm._layer_params(tp)[0]["ssm"]
    jy, jst = jssm.ssm_block(jlp, jnp.asarray(x), cfg, want_state=True)
    ty, tst = tssm.ssm_block(tlp, torch.from_numpy(x), tm.cfg, want_state=True)
    close(ty, jy)
    for k in jst:
        close(tst[k], jst[k])
    x1 = (rng.normal(size=(2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jy, jst = jssm.ssm_block(jlp, jnp.asarray(x1), cfg, state=jst)
    ty, tst = tssm.ssm_block(tlp, torch.from_numpy(x1), tm.cfg, state=tst)
    close(ty, jy)
    for k in jst:
        close(tst[k], jst[k])


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close_states(tc, jc):
    assert sorted(tc["ssm_state"]) == sorted(jc["ssm_state"])
    for k, v in jc["ssm_state"].items():
        assert tuple(tc["ssm_state"][k].shape) == v.shape
        close(tc["ssm_state"][k], v)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("s", [16, 21])
def test_prefill_and_decode_match_jax(pair, s):
    cfg, jm, jp, tm, tp = pair
    toks = _prompts(cfg, (2, s), s)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks), 48)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks), 48)
    close(tlog, jlog)
    _close_states(tc, jc)
    tok = _prompts(cfg, (2, 1), 5)
    for _ in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    _close_states(tc, jc)


def test_slot_write_replaces_the_whole_state(pair):
    """A reused slot keeps nothing of its last owner: every state leaf of
    the slot is overwritten, and a mismatched slot cache is refused."""
    cfg, _, _, tm, tp = pair
    pool = tm.init_cache(3, 32)
    for leaf in pool["ssm_state"].values():
        leaf.fill_(7.0)
    _, c = tm.prefill(tp, torch.from_numpy(_prompts(cfg, (1, 9), 8)), 32)
    tm.write_cache_slot(pool, c, 1)
    got = tm.read_cache_slot(pool, 1)
    for k, v in c["ssm_state"].items():
        assert torch.equal(got["ssm_state"][k], v)
        assert (pool["ssm_state"][k][:, [0, 2]] == 7.0).all()
    assert got["len"].tolist() == [9]
    bad = {"ssm_state": {k: v[:, :, :1] for k, v in c["ssm_state"].items()}, "len": c["len"]}
    with pytest.raises(ValueError, match="slot write"):
        tm.write_cache_slot(pool, bad, 0)


def test_serve_and_generate_streams_match_jax(pair):
    cfg, jm, jp, tm, tp = pair

    def reqs(make):
        return make(3, 1e4, vocab=cfg.vocab_size, max_new_tokens=6, prompt_lens=(7, 13, 16),
                    rng=np.random.default_rng(2))

    je = JEngine(jm, jp, max_seq=48)
    te = ServingEngine(tm, tp, max_seq=48, device="cpu")
    jreq, treq = reqs(j_requests), reqs(t_requests)
    assert sorted(len(r.prompt) for r in treq) == sorted(len(r.prompt) for r in jreq)
    want = je.serve(jreq, max_batch=2)
    sched = te.scheduler(2)
    got = sched.run(treq)
    assert_streams_equal(want, got, label="ssm slot")
    sched.kv.check_invariants()
    prompts = _prompts(cfg, (2, 13), 9)
    jg = np.asarray(je.generate(jnp.asarray(prompts), 5))
    tg = te.generate(prompts, 5)
    np.testing.assert_array_equal(tg.numpy(), jg)


def test_wave_groups_by_exact_length_unpadded(pair, monkeypatch):
    """The SSM family prefills a wave in groups of one exact length and
    passes no ``prompt_len``: recurrent state would integrate pads."""
    cfg, _, _, tm, tp = pair
    calls = []
    real = tm.prefill

    def spy(params, tokens, max_seq, prompt_len=None, **kw):
        calls.append((tuple(tokens.shape), prompt_len))
        return real(params, tokens, max_seq, prompt_len=prompt_len, **kw)

    monkeypatch.setattr(tm, "prefill", spy)
    te = ServingEngine(tm, tp, max_seq=48, device="cpu")
    reqs = [Request(prompt=_prompts(cfg, (n,), i), max_new_tokens=2)
            for i, n in enumerate((5, 9, 5))]
    te.serve(reqs, max_batch=3)
    assert sorted(calls) == [((1, 9), None), ((2, 5), None)]


def test_paged_layout_and_prompt_len_raise_as_in_jax(pair):
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
    plen = np.array([5], np.int32)
    with pytest.raises(ValueError, match="padded prefill"):
        jm.prefill(jp, jnp.asarray(toks), 16, prompt_len=jnp.asarray(plen))
    with pytest.raises(ValueError, match="padded prefill"):
        tm.prefill(tp, torch.from_numpy(toks), 16, prompt_len=plen)


def test_weight_bridge_keeps_float32_scalars_in_bf16():
    """In a bf16 model the bridge casts every leaf to bf16 except A_log,
    dt_bias and D, which stay float32 as the JAX package keeps them."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), dtype="bfloat16")
    jp, _ = JModel(jcfg).init(jax.random.key(1))
    tm = TModel(dataclasses.replace(tget(ARCH).reduced(), dtype="bfloat16"), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        name = path[-1].key
        want = torch.float32 if name in ("A_log", "dt_bias", "D") else torch.bfloat16
        assert t.dtype == want, name
        assert str(leaf.dtype) == str(want).split(".")[-1], name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))


def test_torch_native_init_scales():
    cfg = dataclasses.replace(tget(ARCH).reduced(), dtype="bfloat16")
    p = TModel(cfg, device="cpu").init(seed=0)
    s = p["layers"]["ssm"]
    L, D, Di, cw = cfg.num_layers, cfg.d_model, cfg.ssm_d_inner, cfg.ssm_conv
    assert tuple(s["wx"].shape) == (L, D, Di) and s["wx"].dtype == torch.bfloat16
    assert abs(float(s["wx"].float().std()) - D**-0.5) < 0.1 * D**-0.5
    assert abs(float(s["out"].float().std()) - Di**-0.5) < 0.1 * Di**-0.5
    assert abs(float(s["conv_x"].float().std()) - cw**-0.5) < 0.1 * cw**-0.5
    for name, value in (("A_log", 0.0), ("dt_bias", -2.0), ("D", 1.0)):
        assert s[name].dtype == torch.float32 and (s[name] == value).all()
    again = TModel(cfg, device="cpu").init(seed=0)
    assert torch.equal(s["wB"], again["layers"]["ssm"]["wB"])
