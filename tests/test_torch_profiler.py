"""The port's profiler (``repro_torch.core.profiler``, ``core/op_cost.py``,
``core/op_analysis.py``, ``kernels/work.py``) against the JAX package's
``profile_step`` and ``hlo_cost.analyze`` on the CPU, float32.

The JAX cases of ``tests/test_hlo_cost.py`` count scan trip counts; the
port unrolls its loops, so each is held here as L unrolled layers counting
L times one layer. FLOPs equal JAX's; bytes differ by design (the port
counts what eager ops move, JAX's walker the TPU's fused program). The
kernel operators are charged their ``kernels/work.py`` work on meta
tensors (at their tables' reach) and on real ones (at these lengths)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget
from repro.core.profiler import profile_step as jprofile_step
from repro.core.spec import AIRA_SPEC as J_SPEC
from repro.models import Model as JModel
from repro.train import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget
from repro_torch.core import CPU_HW, H100_HW, HwModel, profile_step
from repro_torch.core.op_analysis import _RING_FACTOR
from repro_torch.core.op_cost import OpCounter, analyze
from repro_torch.core.spec import AIRA_SPEC
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import relic_matmul as trm
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import work
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import Model as TModel
from repro_torch.train import AdamW, make_train_step

import _torch_profile_ranks as ranks

META = torch.device("meta")
B, S, MAX_SEQ = 2, 64, 128


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


# ---------------------------------------------------------------------------
# test_system.py::test_profile_step_roofline_terms, ported


def test_profile_step_roofline_terms():
    ps = profile_step(lambda x, w: torch.tanh(x @ w), meta(512, 512), meta(512, 512), name="mm")
    jps = jprofile_step(lambda x, w: jnp.tanh(x @ w), sds(512, 512), sds(512, 512), name="mm")
    assert ps.flops > 2 * 512**3 * 0.99
    assert ps.flops == jps.flops
    assert ps.terms.dominant in ("compute", "memory")
    rep, jrep = ps.report(), jps.report()
    assert rep.keys() == jrep.keys()
    assert rep["roofline"].keys() == jrep["roofline"].keys()
    assert rep["hotspots"][0].keys() == jrep["hotspots"][0].keys()
    # the terms are H100_HW's unless another model is given
    assert ps.terms.compute_s == ps.flops / H100_HW.peak_flops
    assert ps.terms.memory_s == ps.bytes_accessed / H100_HW.hbm_bw
    cpu = profile_step(lambda x, w: torch.tanh(x @ w), meta(512, 512), meta(512, 512), hw=CPU_HW)
    assert cpu.terms.compute_s == cpu.flops / CPU_HW.peak_flops
    assert '"roofline"' in ps.to_json()


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py's five cases, ported to unrolled loops


def _layer(c, w):
    return torch.tanh(c @ w)


def test_loop_flops_and_bytes_are_L_times_one_layer():
    """12 unrolled layers count 12 × 2·128³ FLOPs (JAX's scan and unrolled
    scan both do) and exactly 12 × one layer's FLOPs and bytes."""
    def stack(x, ws):
        for w in ws.unbind(0):
            x = _layer(x, w)
        return x

    x, ws = meta(128, 128), meta(12, 128, 128)
    whole = analyze(stack, x, ws)
    one = analyze(_layer, x, ws[0])
    assert whole.flops == 12 * 2 * 128**3
    assert whole.flops == 12 * one.flops
    assert whole.bytes == 12 * one.bytes
    jtext = jax.jit(lambda x, ws: jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]
                    ).lower(sds(128, 128), sds(12, 128, 128)).compile().as_text()
    from repro.core.hlo_cost import analyze as janalyze
    assert janalyze(jtext).flops == whole.flops


def test_nested_loop_counts():
    def f(x, ws):
        for w in ws.unbind(0):
            for _ in range(5):
                x = _layer(x, w)
        return x

    c = analyze(f, meta(64, 64), meta(7, 64, 64))
    assert c.flops == 7 * 5 * 2 * 64**3


def test_dot_general_contracted_dims():
    c = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b), meta(4, 32, 64), meta(4, 64, 16))
    assert c.flops == 2 * 4 * 32 * 64 * 16


def test_stacked_param_slicing_not_overcounted():
    """Each layer reads its own slice of the stacked weights: the loop
    charges about one pass over the stack, not L × the stack."""
    L, D = 16, 64

    def f(x, ws):
        for i in range(L):
            x = x @ ws[i]
        return x

    c = analyze(f, meta(8, D), meta(L, D, D))
    full_stack = L * D * D * 4
    assert c.bytes < 4 * full_stack
    assert c.bytes == L * (8 * D + D * D + 8 * D) * 4


@pytest.fixture(scope="module")
def mesh_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile_mesh")
    run_ranks(ranks.collectives_per_layer, 8, str(out), 10, store=str(out / "store"),
              timeout_s=120.0)
    return [ranks.load(str(out), r) for r in range(8)]


def test_collectives_counted_per_layer(mesh_counts):
    """8 gloo ranks on a (2, 4) ("data", "model") mesh: 10 layers, each
    calling one ``parallel/collectives.py`` function over "model"; every
    rank counts ≥ 10 calls of the op under JAX's name, with bytes 10 ×
    the result payload × the op's ring factor."""
    for found in mesh_counts:
        assert "error" not in found, found.get("error")
        for op, (counts, nbytes, total, payload) in found.items():
            assert counts[op] >= 10, (op, counts)
            assert nbytes[op] == 10 * payload * _RING_FACTOR[op]
            assert total == nbytes[op]


# ---------------------------------------------------------------------------
# differentials against JAX's profile_step on reduced smollm-135m


@pytest.fixture(scope="module")
def models():
    tcfg, jcfg = tget("smollm-135m").reduced(), jget("smollm-135m").reduced()
    tm, jm = TModel(tcfg, device=META), JModel(jcfg)
    return tm, tm.init(), jm, jm.abstract_params()[0]


def test_prefill_flops_equal_jax(models):
    tm, tp, jm, jp = models
    tok = meta(B, S, dtype=torch.int32)
    ps = profile_step(lambda p, t: tm.prefill(p, t, MAX_SEQ, backend="reference"), tp, tok)
    jps = jprofile_step(lambda p, t: jm.prefill(p, t, MAX_SEQ), jp, sds(B, S, dtype=jnp.int32))
    assert ps.flops == jps.flops == 23_134_208


def test_decode_step_flops_equal_jax(models):
    tm, tp, jm, jp = models
    cache = tm.init_cache(B, S)
    ps = profile_step(lambda p, c, t: tm.decode_step(p, c, t, backend="reference"), tp, cache,
                      meta(B, 1, dtype=torch.int32))
    jcache = jax.eval_shape(lambda: jm.init_cache(B, S))
    jps = jprofile_step(lambda p, c, t: jm.decode_step(p, c, t, backend="reference"), jp, jcache,
                        sds(B, 1, dtype=jnp.int32))
    assert ps.flops == jps.flops == 425_984


def _paged_args(tm, MB=8, BS=16):
    pool = tm.init_paged_cache(B * MB + 1, BS)
    return (pool, meta(B, MB, dtype=torch.int32), meta(B, dtype=torch.int32),
            meta(B, 1, dtype=torch.int32))


def test_paged_decode_step_flops_equal_jax(models):
    tm, tp, jm, jp = models
    MB, BS = 8, 16
    ps = profile_step(lambda p, *a: tm.decode_step_paged(p, *a, backend="reference"), tp,
                      *_paged_args(tm, MB, BS))
    jpool = jax.eval_shape(lambda: jm.init_paged_cache(B * MB + 1, BS))
    jps = jprofile_step(lambda p, *a: jm.decode_step_paged(p, *a, backend="reference"), jp,
                        jpool, sds(B, MB, dtype=jnp.int32), sds(B, dtype=jnp.int32),
                        sds(B, 1, dtype=jnp.int32))
    assert ps.flops == jps.flops


def test_paged_kernel_route_traces_on_meta(models):
    """``decode_step_paged`` on the kernel backend traces on meta tensors:
    the paged operator's fake, once a layer, charged its work at the
    tables' reach, which is the reference route's count."""
    tm, tp, _, _ = models
    args = _paged_args(tm)
    ref = profile_step(lambda p, *a: tm.decode_step_paged(p, *a, backend="reference"), tp, *args)
    ker = profile_step(lambda p, *a: tm.decode_step_paged(p, *a, backend="kernel"), tp, *args)
    assert ker.flops == ref.flops
    name = "repro_torch::paged_decode_attention"
    assert ker.ops.calls_by_op[name] == tm.cfg.num_layers
    assert ker.ops.bytes_by_op[name] > 0
    pool, tables, lens, tok = args
    q = meta(B, 1, tm.cfg.n_heads, tm.cfg.head_dim)
    want = work.paged(q, pool["k"][0], tables, lens)
    assert ker.ops.flops_by_op[name] == tm.cfg.num_layers * want.flops
    # CPU tensors still refuse the kernel backend
    cpu = TModel(tm.cfg, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cpu.decode_step_paged(cpu.init(), cpu.init_paged_cache(B * 8 + 1, 16),
                              torch.zeros(B, 8, dtype=torch.int32),
                              torch.zeros(B, dtype=torch.int32),
                              torch.zeros(B, 1, dtype=torch.int32), backend="kernel")


def test_prefill_kernel_route_charges_flash(models):
    """The kernel route of a prefill: one flash operator a layer on meta,
    charged its causal work (half the reference's masked chunks)."""
    tm, tp, _, _ = models
    tok = meta(B, S, dtype=torch.int32)
    ker = profile_step(lambda p, t: tm.prefill(p, t, MAX_SEQ, backend="kernel"), tp, tok)
    name = "repro_torch::flash_attention"
    assert ker.ops.calls_by_op[name] == tm.cfg.num_layers
    cfg = tm.cfg
    one = work.flash(meta(B, S, cfg.n_heads, cfg.head_dim), meta(B, S, cfg.n_kv_heads,
                                                                 cfg.head_dim))
    assert ker.ops.flops_by_op[name] == cfg.num_layers * one.flops


def test_train_step_flops_equal_jax(models):
    """The train step (value_and_grad, AdamW) counts JAX's FLOPs exactly,
    accumulation included. The tolerance is 0 because both steps keep the
    loss's value: ``jax.grad`` alone would drop the forward's head product
    (``x @ lm_head`` in the cross-entropy's chunk, ``aten::mm`` here) as dead
    code, since its checkpoint recomputes the logits for the backward, so a
    port gradient counts 2·N·D·V more than ``jax.grad`` (checked below)."""
    tm, tp, jm, jp = models
    cfg = tm.cfg
    accum, micro = 2, B
    opt, jopt = AdamW(lr=1e-3), JAdamW(lr=1e-3)
    batch = {k: meta(accum, micro, S, dtype=torch.float32 if k == "mask" else torch.int32)
             for k in ("tokens", "labels", "mask")}
    jbatch = {k: sds(accum, micro, S, dtype=jnp.float32 if k == "mask" else jnp.int32)
              for k in ("tokens", "labels", "mask")}
    ps = profile_step(make_train_step(tm, opt, accum_steps=accum), tp, opt.init(tp), batch)
    jps = jprofile_step(jmake_train_step(jm, jopt, accum_steps=accum), jp,
                        jax.eval_shape(jopt.init, jp), jbatch)
    assert ps.flops == jps.flops
    # jax.grad alone: the head product of the loss's forward is dead code there
    from repro_torch.tree import flatten, unflatten

    def grads(p, b):
        leaves, spec = flatten(p)
        leaves = [x.requires_grad_() for x in leaves]
        loss, _ = tm.loss(unflatten(spec, leaves), b)
        return torch.autograd.grad(loss, leaves)

    one = {k: v[0] for k, v in batch.items()}
    g = profile_step(grads, tp, one)
    jg = jprofile_step(jax.grad(lambda p, b: jm.loss(p, b)[0]), jp,
                       {k: v for k, v in zip(jbatch, (sds(micro, S, dtype=jnp.int32),) * 2
                                             + (sds(micro, S),))})
    assert g.flops - jg.flops == 2 * micro * S * cfg.d_model * cfg.vocab_size


# ---------------------------------------------------------------------------
# the kernel operators


def _kernel_cases():
    """(name, inputs on the CPU, the operator call, its work, the plain
    route at full lengths) for each kernel operator."""
    rng = np.random.default_rng(5)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(dtype))

    Bk, T, H, KV, hd, NB, BS, MB = 2, 1, 4, 2, 16, 9, 8, 4
    q, kp, vp = t(Bk, T, H, hd), t(NB, BS, KV, hd), t(NB, BS, KV, hd)
    tables = torch.from_numpy(rng.integers(0, NB, (Bk, MB)).astype(np.int32))
    full = torch.full((Bk,), MB * BS - T, dtype=torch.int32)
    own = torch.ones((Bk, MB), dtype=torch.int32)
    x, w = t(16, 32), t(32, 64)
    xg = t(4, 32)
    dq, dk, dv = t(Bk, H, hd), t(Bk, 32, KV, hd), t(Bk, 32, KV, hd)
    dlen = torch.full((Bk,), 32, dtype=torch.int32)
    fq, fk, fv = t(Bk, 8, H, hd), t(Bk, 12, KV, hd), t(Bk, 12, KV, hd)
    sx = t(1, 16, 2, 8)
    sa = torch.exp(-torch.nn.functional.softplus(t(1, 16, 2)))
    sb, sc, sdt = t(1, 16, 4), t(1, 16, 4), torch.nn.functional.softplus(t(1, 16, 2))
    return [
        ("repro_torch::paged_decode_attention", (q, kp, vp, tables, full),
         lambda a: pda.paged_attention_op(*a), lambda a: work.paged(a[0], a[1], a[3], a[4]),
         lambda a: pda.plain_paged_decode_attention(*a)),
        ("repro_torch::paged_decode_partials", (q, kp, vp, tables, full, own),
         lambda a: pda.paged_partials_op(*a),
         lambda a: work.partials(a[0], a[1], a[3], a[4], a[5]),
         lambda a: pda.plain_paged_decode_attention(*a[:5], owned=a[5], partials=True)),
        ("repro_torch::flash_attention", (fq, fk, fv),
         lambda a: tfa.flash_attention_op(*a, 0, False), lambda a: work.flash(a[0], a[1], 0, False),
         lambda a: tfa.plain_flash_attention(*a, 0, False)),
        ("repro_torch::relic_matmul", (x, w), lambda a: trm.relic_matmul_op(*a, 256, 512, 256),
         lambda a: work.matmul(*a), lambda a: trm.plain_relic_matmul(*a)),
        ("repro_torch::relic_gemv", (xg, w), lambda a: trm.relic_gemv_op(*a, 1024, 512),
         lambda a: work.matmul(*a), lambda a: trm.plain_relic_gemv(*a)),
        ("repro_torch::decode_attention", (dq, dk, dv, dlen),
         lambda a: tda.decode_attention_op(*a, 512), lambda a: work.decode(a[0], a[1], a[3]),
         lambda a: tda.plain_decode_attention(*a)),
        ("repro_torch::ssd_scan", (sx, sa, sb, sc, sdt), lambda a: tssd.ssd_scan_op(*a, 8),
         lambda a: work.ssd(a[0], a[2], 8), None),
    ]


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0].split("::")[1])
def test_kernel_operator_charged_by_its_work(case):
    """Each kernel operator, counted on meta tensors (its fake) and on CPU
    tensors (its plain version, the lengths read from the tensors), is
    charged exactly its ``kernels/work.py`` work and nothing else. At full
    lengths, non-causal, that work is the FLOPs the plain route's aten ops
    count; the SSD scan's is not: its work counts c·b once a head, as the
    Pallas kernel does, where the plain scan shares it between heads."""
    name, args, call, want, plain = case
    on_meta = tuple(a.to(META) for a in args)
    for inputs in (on_meta, args):
        cost = analyze(call, inputs)
        w = want(inputs)
        assert cost.ops.calls_by_op == {name: 1}
        assert cost.flops == w.flops and cost.bytes == w.bytes
    assert want(on_meta) == want(args)  # full lengths: the meta charge is these inputs'
    if plain is not None:
        with FlopCounterMode(display=False) as fc:
            plain(args)
        assert fc.get_total_flops() == want(args).flops


def test_flash_call_takes_the_operator_under_vmap():
    """``flash_call`` under vmap goes through the operator (its loop rule),
    giving each item's plain result."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 1, 5, 4, 8)).astype(np.float32))
               for _ in range(3))
    got = torch.func.vmap(lambda a, b, c: tfa.flash_call(a, b, c, 0, True))(q, k, v)
    for i in range(3):
        assert torch.equal(got[i], tfa.plain_flash_attention(q[i], k[i], v[i]))
    with OpCounter() as counter:
        torch.func.vmap(lambda a, b, c: tfa.flash_call(a, b, c, 0, True))(q, k, v)
    assert counter.cost.ops.calls_by_op["repro_torch::flash_attention"] == 3


@pytest.mark.parametrize("case", [c for c in _kernel_cases() if c[0] in (
    "repro_torch::flash_attention", "repro_torch::ssd_scan", "repro_torch::paged_decode_partials")],
    ids=lambda c: c[0].split("::")[1])
def test_kernel_operator_vmap_loops_items(case):
    """Under ``torch.func.vmap`` a kernel call takes its operator
    (``_build.through_operator``), whose rule calls it once a mapped item:
    each item (tensor or tuple outputs) equals the call on that item."""
    name, args, call, _, _ = case
    mapped = tuple(torch.stack([a, a * 0.5 if a.is_floating_point() else a]) for a in args)
    got = torch.func.vmap(lambda *a: call(a))(*mapped)
    for i in range(2):
        want = call(tuple(m[i] for m in mapped))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g[i], w)


def test_kernel_charge_reads_the_lengths():
    """On real tensors the paged charge follows the lengths the rows hold;
    on meta every row counts at its table's reach less T."""
    Bk, T, H, KV, hd, NB, BS, MB = 3, 2, 4, 2, 8, 13, 8, 4
    q = torch.zeros(Bk, T, H, hd)
    kp = torch.zeros(NB, BS, KV, hd)
    tables = torch.zeros(Bk, MB, dtype=torch.int32)
    lens = torch.tensor([0, 5, 30], dtype=torch.int32)
    got = work.paged(q, kp, tables, lens)
    pairs = sum(int(n) * T + T * (T + 1) // 2 for n in lens)
    assert got.flops == 4 * hd * H * pairs
    full = work.paged(q.to(META), kp.to(META), tables.to(META), lens.to(META))
    reach = MB * BS
    assert full.flops == 4 * hd * H * Bk * ((reach - T) * T + T * (T + 1) // 2)
    # flash's closed form equals the per-query sum
    for off, Sq, Skv in ((0, 7, 7), (3, 5, 9), (9, 4, 9), (0, 6, 3)):
        f = work.flash(torch.zeros(1, Sq, 1, 1), torch.zeros(1, Skv, 1, 1), off)
        assert f.flops == 4 * sum(min(Skv, off + i + 1) for i in range(Sq))


def test_graph_replay_under_the_counter_raises():
    """A replay launches kernels no dispatch mode sees: under the counter
    it raises instead of counting zero, and the guard goes with the
    counter."""
    replay = torch.cuda.CUDAGraph.replay
    with pytest.raises(RuntimeError, match="CUDA graph replay under the op counter"):
        analyze(lambda: torch.cuda.CUDAGraph.replay(None))
    with OpCounter():
        with OpCounter():
            pass
        with pytest.raises(RuntimeError, match="op counter"):
            torch.cuda.CUDAGraph.replay(None)
    assert torch.cuda.CUDAGraph.replay is replay


def test_profile_step_with_a_mesh_needs_real_tensors():
    with pytest.raises(ValueError, match="need real tensors"):
        profile_step(lambda x: x + 1, meta(4), mesh=object())


def test_memory_stats():
    """Arguments, outputs, an in-place output's alias and the peak of live
    intermediates (two [64, 64] float32 temporaries live at once)."""
    def f(x, state):
        a = x * 2
        b = x + 1
        state.add_(1)
        return (a @ b).sum(), state

    ps = profile_step(f, meta(64, 64), meta(64, 64))
    m = ps.memory_stats
    assert m.argument_size_in_bytes == 2 * 64 * 64 * 4
    assert m.output_size_in_bytes == 4 + 64 * 64 * 4
    assert m.alias_size_in_bytes == 64 * 64 * 4
    assert m.temp_size_in_bytes >= 3 * 64 * 64 * 4  # a, b and a @ b


# ---------------------------------------------------------------------------
# the H100 preset and the spec


def test_h100_preset_and_default():
    assert (H100_HW.peak_flops, H100_HW.vpu_flops, H100_HW.hbm_bw, H100_HW.ici_bw) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert HwModel() == CPU_HW
    # the SMT-core fields are CPU_HW's: the preset prices roofline terms only
    assert H100_HW.mem_latency == CPU_HW.mem_latency and H100_HW.ilp_eff == CPU_HW.ilp_eff


def test_spec_profile_stage_names_profile_step():
    assert AIRA_SPEC[0].name == J_SPEC[0].name == "profile"
    assert AIRA_SPEC[0].tool == J_SPEC[0].tool == "core.profiler.profile_step"
