"""The port's training path against the JAX package on the CPU, float32 at
``.reduced()`` size with the JAX parameters and batches carried over
through numpy: ``chunked_softmax_xent`` (values and input gradients),
``AdamW.update`` on identical gradients and its schedule, ``Model.loss``
and its gradients for one config of each family (dense, ssm, hybrid, moe
with its aux loss, vlm, audio), one whole ``make_train_step`` call and
the accumulation step, the three remat modes (bitwise equal to each
other), ``param_axes`` against the JAX ``init``'s axes tree and
``abstract_params``, the compiled step's in-place write-back against the
functional step and the remat checkpoints' untouched generators; then the JAX package's training tests mirrored on the
port (AdamW on a quadratic, the smoke step, train then serve) and the
kernels' refusal to be differentiated."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import SyntheticLMData as JData
from repro.models import Model as JModel
from repro.models.layers import chunked_softmax_xent as jxent
from repro.train import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import OptState as JOptState
from repro_torch.configs import get_config as tget
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_decode_attention as tpaged
from repro_torch.kernels import relic_matmul as tmatmul
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ServingEngine
from repro_torch.train import AdamW, compiled_train_step, make_train_step
from repro_torch.train.optimizer import OptState
from repro_torch.tree import flatten, map_tree, unflatten

# one config of each family
FAMILIES = ["smollm-135m", "mamba2-370m", "zamba2-2.7b", "granite-moe-1b-a400m",
            "internvl2-2b", "musicgen-large"]
LOSS_RTOL = 1e-5  # float32 loss, JAX against the port
GRAD_RTOL = 1e-4  # relative L2 of each gradient leaf
PARAM_ATOL = 5e-2  # tests/test_sharded.py's bound on a step's parameters
AUX_ATOL = 1e-5


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tm = TModel(dataclasses.replace(tget(arch).reduced(), **over), device="cpu")
    tp = tm.params_from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tm, tp


def _batches(jcfg, B=2, S=32, step=0):
    """The JAX package's batch for ``step`` and the same arrays as tensors."""
    jb = JData(jcfg, batch=B, seq=S).batch_at(step)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _leaves(tree):
    """A tree's leaves (torch or JAX) as float32 numpy arrays, dicts in
    sorted-key order: JAX's order and ``repro_torch.tree``'s alike."""
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in flatten(tree)[0]]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _grads(model, params, batch):
    leaves, spec = flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = model.loss(unflatten(spec, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), map_tree(torch.Tensor.detach, metrics), [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# the cross-entropy and the optimizer


@pytest.mark.parametrize("S", [256, 300, 37])
def test_chunked_softmax_xent_matches_jax(S):
    """S = 256 (one chunk), 300 (chunks of 150: the chunk lowered until it
    divides), 37 (a prime: one chunk of 37)."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 64)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 64, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.8).astype(np.float32)

    def jloss(x, h):
        return jxent(x, h, jnp.asarray(labels), jnp.asarray(mask))[0]

    (jv, (jgx, jgh)) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = torch.tensor(x, requires_grad=True), torch.tensor(head, requires_grad=True)
    tv, cnt = chunked_softmax_xent(tx, th, torch.from_numpy(labels), torch.from_numpy(mask))
    tgx, tgh = torch.autograd.grad(tv, (tx, th))
    tv = tv.detach()
    assert abs(float(tv) - float(jv)) <= 1e-6 * abs(float(jv)), (float(tv), float(jv))
    assert float(cnt) == float(mask.sum())
    assert _rel_l2(tgx.numpy(), np.asarray(jgx)) <= 1e-6
    assert _rel_l2(tgh.numpy(), np.asarray(jgh)) <= 1e-6


def _opt_case(seed=0, big=False):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": {"a": (3, 4, 2), "norm": (7,)}, "b": (5,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * (10 if big else 0.05))
                         .astype(np.float32), params)
    mu = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32), params)
    nu = jax.tree.map(lambda p: (rng.random(p.shape) * 1e-3).astype(np.float32), params)
    return params, grads, mu, nu


@pytest.mark.parametrize("big", [False, True], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(big):
    """One update from the same params, grads and state (step 3): params,
    mu and nu within 1e-6, lr and grad_norm within 1e-7 relative."""
    params, grads, mu, nu = _opt_case(big=big)
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=50)
    jp, js, jm = JAdamW(**kw).update(
        jax.tree.map(jnp.asarray, grads),
        JOptState(step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
                  nu=jax.tree.map(jnp.asarray, nu)),
        jax.tree.map(jnp.asarray, params))
    t = lambda tree: map_tree(lambda a: torch.from_numpy(np.array(a)), tree)  # noqa: E731
    tp, ts, tm = AdamW(**kw).update(
        t(grads), OptState(step=torch.tensor(3, dtype=torch.int32), mu=t(mu), nu=t(nu)),
        t(params))
    assert (float(jm["grad_norm"]) > 1.0) == big
    for name in ("lr", "grad_norm"):
        assert abs(float(tm[name]) - float(jm[name])) <= 1e-7 * abs(float(jm[name])), name
    assert int(ts.step) == int(js.step) == 4
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for g, w in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_adamw_schedule_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(JAdamW(**kw).schedule(jnp.asarray(step, jnp.int32)))
        got = float(AdamW(**kw).schedule(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * want, (step, got, want)
    assert float(AdamW(**kw).schedule(9)) == pytest.approx(3e-4, rel=1e-6)  # end of warm-up
    assert float(AdamW(**kw).schedule(100)) == pytest.approx(3e-5, rel=1e-6)  # min_lr_frac


# ---------------------------------------------------------------------------
# the loss, its gradients and the step


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``Model.loss`` and every gradient leaf on the JAX parameters and
    batch (a vlm's patch rows included; granite's Switch aux loss)."""
    jcfg, jm, jp, tm, tp = _pair(arch)
    jb, tb = _batches(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True))(jp)
    tl, tmet, tg = _grads(tm, tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), (float(tl), float(jl))
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= AUX_ATOL
    if jcfg.family == "moe":
        assert float(jmet["aux"]) > 0
    jleaves = _leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (g, w) in enumerate(zip(tg, jleaves)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert _rel_l2(g, w) <= GRAD_RTOL, (arch, i, _rel_l2(g, w))


def _jstep_inputs(jcfg, jm, jp, B=4, S=32, accum=1, step=0):
    jb = JData(jcfg, batch=B, seq=S).batch_at(step)
    if accum > 1:
        jb = jax.tree.map(lambda x: x.reshape((accum, B // accum) + x.shape[1:]), jb)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One whole step of reduced smollm-135m (``accum`` = 2: the JAX
    package's accumulation scan over [2, 2, …] microbatches): the loss
    within 1e-5 relative, the parameters within ``tests/test_sharded.py``'s
    5e-2 (Adam's first step moves each weight by ±lr, so an entry whose
    gradient is round-off noise may take the other sign in either
    package; the gradient and optimizer tests above are the tight ones)."""
    jcfg, jm, jp, tm, tp = _pair("smollm-135m")
    jopt, topt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=10), AdamW(
        lr=1e-3, warmup_steps=2, total_steps=10)
    jb, tb = _jstep_inputs(jcfg, jm, jp, accum=accum)
    jp2, js2, jmet = jax.jit(jmake_train_step(jm, jopt, accum_steps=accum))(
        jp, jopt.init(jp), jb)
    tp2, ts2, tmet = make_train_step(tm, topt, accum_steps=accum)(tp, topt.init(tp), tb)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_RTOL * float(jmet["loss"])
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-4 * float(
        jmet["grad_norm"])
    d = max(float(np.abs(g - w).max()) for g, w in zip(_leaves(tp2), _leaves(jp2)))
    assert d < PARAM_ATOL, d
    assert int(ts2.step) == 1


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b", "granite-moe-1b-a400m"])
def test_remat_modes_bitwise_equal(arch):
    """remat "none", "dots" and "full" give the same loss and gradients bit
    for bit on the CPU (the recomputation repeats the same arithmetic)."""
    jcfg = jget(arch).reduced()
    _, tb = _batches(jcfg)
    runs = []
    for remat in ("none", "dots", "full"):
        tm = TModel(dataclasses.replace(tget(arch).reduced(), remat=remat), device="cpu")
        runs.append(_grads(tm, tm.init(0), tb))
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for g, w in zip(grads, runs[0][2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("accum", [1, 2])
def test_compiled_step_writes_back_like_the_functional_step(accum):
    """Three steps through ``compiled_train_step`` (the trainer's family:
    on the CPU it records its key and runs eagerly, its new state copied
    into the caller's by ``in_place``) equal three steps of the functional
    ``make_train_step`` bit for bit; each call returns the caller's own
    parameter and optimizer-state tensors, and the family keeps one
    entry, as the reference's ``jax.jit`` of the step does."""
    jcfg, _, _, tm, tp = _pair("smollm-135m")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    fn = make_train_step(tm, opt, accum_steps=accum)
    family = compiled_train_step(tm, opt, accum_steps=accum)
    params, ostate = map_tree(torch.clone, tp), opt.init(tp)
    ptrs = [t.data_ptr() for t in flatten((params, ostate))[0]]
    want_p, want_s = tp, opt.init(tp)
    for step in range(3):
        _, tb = _jstep_inputs(jcfg, None, None, accum=accum, step=step)
        want_p, want_s, want_m = fn(want_p, want_s, tb)
        got_p, got_s, got_m = family(params, ostate, tb)
        assert got_p is params and got_s is ostate
        assert [t.data_ptr() for t in flatten((got_p, got_s))[0]] == ptrs
        for a, b in zip(flatten((got_p, got_s, got_m))[0], flatten((want_p, want_s, want_m))[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(ostate.step) == 3 and family._cache_size() == 1


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_leaves_the_generators_alone(remat, monkeypatch):
    """A train step under remat draws no random number and keeps no
    generator state: the CPU generator's state is the same after the step,
    and the checkpoints never read it (``preserve_rng_state=False``; a
    captured step on the card cannot read or set the CUDA generator's)."""
    cfg = dataclasses.replace(tget("smollm-135m").reduced(), remat=remat)
    m = TModel(cfg, device="cpu")
    params = m.init(0)
    batch = SyntheticLMData(cfg, batch=2, seq=32, device="cpu").batch_at(0)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    reads = []
    real = torch.get_rng_state
    monkeypatch.setattr(torch, "get_rng_state", lambda: reads.append(1) or real())
    torch.manual_seed(11)
    before = real()
    make_train_step(m, opt)(params, opt.init(params), batch)
    assert torch.equal(real(), before)
    assert not reads


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_axes_match_jax_init(arch):
    _, axes = JModel(jget(arch).reduced()).init(jax.random.key(0))
    tm = TModel(tget(arch).reduced(), device="cpu")
    assert tm.param_axes() == axes
    # one axes tuple a parameter, in the parameters' structure
    n_axes = len(jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple)))
    assert len(flatten(tm.init(0))[0]) == n_axes


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_params_allocate_nothing(arch):
    tm = TModel(tget(arch).reduced(), device="cpu")
    shapes, axes = tm.abstract_params()
    assert axes == tm.param_axes()
    real = flatten(tm.init(0))[0]
    meta = flatten(shapes)[0]
    assert len(real) == len(meta)
    for r, m in zip(real, meta):
        assert m.is_meta and m.shape == r.shape and m.dtype == r.dtype


# ---------------------------------------------------------------------------
# the JAX package's training tests, on the port


@pytest.mark.parametrize("seed", range(4))
def test_adamw_descends_quadratic(seed):
    """``tests/test_properties.py::test_adamw_descends_quadratic``."""
    target = torch.randn(8, generator=torch.Generator().manual_seed(seed))
    params = {"w": torch.zeros(8)}
    opt = AdamW(lr=0.05, warmup_steps=1, total_steps=100, weight_decay=0.0)
    state = opt.init(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), (w,))
        params, state, _ = opt.update({"w": g}, state, params)
    assert float(loss(params)) < 0.2 * l0


@pytest.mark.parametrize("arch", FAMILIES + ["dbrx-132b"])
def test_smoke_loss_and_step(arch):
    """``tests/test_models.py::test_smoke_loss_and_step``: a finite loss
    below 3·ln V, and the parameters moved (dbrx-132b too, at the reduced
    config: it does not train on one card at full width)."""
    cfg = tget(arch).reduced()
    m = TModel(cfg, device="cpu")
    params = m.init(0)
    batch = SyntheticLMData(cfg, batch=2, seq=32, device="cpu").batch_at(0)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    params2, _, metrics = make_train_step(m, opt)(params, opt.init(params), batch)
    assert np.isfinite(float(metrics["loss"])), arch
    assert float(metrics["loss"]) < 3 * np.log(cfg.padded_vocab)
    moved = max(float((a - b).abs().max()) for a, b in zip(flatten(params)[0],
                                                           flatten(params2)[0]))
    assert moved > 0


def test_train_then_serve_roundtrip():
    """``tests/test_system.py::test_train_then_serve_roundtrip``: 8 steps,
    the loss falls, then the engine serves the trained parameters."""
    cfg = tget("smollm-135m").reduced()
    m = TModel(cfg, device="cpu")
    params = m.init(0)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    state = opt.init(params)
    data = SyntheticLMData(cfg, batch=4, seq=32, device="cpu")
    step = make_train_step(m, opt)
    losses = []
    for i in range(8):
        params, state, metrics = step(params, state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    eng = ServingEngine(m, params, max_seq=64, device="cpu")
    out = eng.generate(torch.ones((2, 8), dtype=torch.int32), n_steps=4)
    assert out.shape == (2, 4)
    assert eng.stats.percentile(50) > 0


# ---------------------------------------------------------------------------
# the kernels refuse to be differentiated


def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    tables = torch.arange(4, dtype=torch.int32).view(2, 2)
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    return {
        "flash_attention": (tflash.flash_attention, (r(1, 8, 4, 16), r(1, 8, 2, 16),
                                                    r(1, 8, 2, 16))),
        "ssd_scan": (tssd.ssd_scan, (r(1, 16, 2, 8), torch.rand(1, 16, 2, generator=g),
                                     r(1, 16, 4), r(1, 16, 4), torch.rand(1, 16, 2, generator=g))),
        "paged_decode_attention": (tpaged.paged_decode_attention,
                                   (r(2, 1, 4, 16), r(4, 8, 2, 16), r(4, 8, 2, 16), tables,
                                    lengths)),
        "decode_attention": (tdecode.decode_attention, (r(2, 4, 16), r(2, 16, 2, 16),
                                                        r(2, 16, 2, 16), lengths)),
        "relic_matmul": (tmatmul.relic_matmul, (r(16, 32), r(32, 8))),
        "relic_gemv": (tmatmul.relic_gemv, (r(2, 32), r(32, 8))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan", "paged_decode_attention",
                                  "decode_attention", "relic_matmul", "relic_gemv"])
def test_kernel_wrapper_refuses_autograd(name):
    """Each wrapper raises, naming its kernel, when an input requires grad
    in grad mode (the check runs before any device dispatch, so the CPU
    sees it); under ``torch.no_grad()`` the same call runs."""
    fn, args = _kernel_calls()[name]
    for i, a in enumerate(args):
        if not a.is_floating_point():
            continue
        args_g = tuple(x.clone().requires_grad_() if j == i else x for j, x in enumerate(args))
        with pytest.raises(RuntimeError, match=name):
            fn(*args_g)
        with torch.no_grad():
            fn(*args_g)
    fn(*args)  # no input requires grad
