"""The port's training split over "model" (tensor, sequence and expert
parallel), its gather-once FSDP path and its elastic sharded checkpoints,
against the JAX package and the port's single-device step on the CPU, in
one group of 8 gloo rank processes (``run_ranks``; bodies in
``tests/_torch_train_tp_ranks.py``) on the JAX test's ("data", "model") =
(2, 4) mesh (``tests/test_sharded.py``), reduced configs, float32.

Each case is one split step of ``make_train_step(Model(cfg, mesh=mesh),
…)`` on the JAX test's batch of 4 rows of 32 tokens (8 rows in 2
microbatches for phi3), from the JAX package's initial parameters:

- its loss within 5e-3 of the JAX single-device step and its stepped
  parameters within 5e-2 of it (``tests/test_sharded.py``'s bounds);
- its loss and ``grad_norm`` within 1e-5 (relative) of the port's
  single-device step, and each gradient leaf gathered within 1e-4 of that
  leaf's largest magnitude. A MoE's split step routes each of the 8 token
  shards with its own capacity and averages their aux losses (the JAX
  package's ``pmean``), so its single-device step here is the one with
  those semantics (``_ShardedAux``), and its ``ce`` is held to the plain
  single-device ``ce`` too (at a capacity factor where nothing drops);
- each stored parameter and moment leaf shaped as its ``rules.spec``
  shard, with the specs equal to the JAX package's ``ShardingRules``.

Then: each collective's gradient on the mesh, ZeRO-2 against the plain
FSDP step (fewer all-gathers a step, the same numbers), the split step
with the pod axis's int8 gradient reduction on ("pod", "data", "model") =
(2, 2, 2), a checkpoint
saved on (2, 4) restored onto a (1, 2) mesh and onto one device bitwise,
and a split ``Trainer`` resumed after a failure bitwise equal to an
uninterrupted run."""
import dataclasses
import gc
import math
import threading
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import SyntheticLMData as JData
from repro.models import Model as JModel
from repro.parallel.sharding import ShardingRules as JRules
from repro.train import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import Model as TModel
from repro_torch.parallel.sharding import ShardingRules as TRules
from repro_torch.tree import flatten, unflatten

import _torch_train_tp_ranks as ranks

LOSS_ATOL = 5e-3  # tests/test_sharded.py's
PARAM_ATOL = 5e-2  # tests/test_sharded.py's
RTOL = 1e-5  # loss and grad_norm against the port's single-device step
GRAD_TOL = 1e-4  # of each gradient leaf's largest magnitude
MESH = (2, 4)
# at E / k every expert could take all of a shard's tokens: nothing drops
MOE = {"capacity_factor": 2.0}

# name → (arch, replaced fields, microbatches); a zero2 config runs the
# plain FSDP step and the ZeRO-2 one
CASES = {
    # 4 q heads split over 4, the 2 kv heads whole: their gradients partial
    "smollm": ("smollm-135m", {}, 1),
    # 9 heads on 4: the sequence-parallel fallback (seq_sp)
    "smollm_seq_sp": ("smollm-135m", {"n_heads": 9, "n_kv_heads": 3}, 1),
    # the flat layout under seq_sp: the projections' flat columns split
    "smollm_flat": ("smollm-135m", {"n_heads": 9, "n_kv_heads": 3, "attn_flat_tp": True}, 1),
    "granite": ("granite-moe-1b-a400m", MOE, 1),
    # FSDP over "data" and 1 expert a rank
    "dbrx": ("dbrx-132b", dict(MOE, zero2=1), 1),
    # FSDP, an untied head, 2 microbatches
    "phi3": ("phi3-medium-14b", {"zero2": 1}, 2),
    "mamba2": ("mamba2-370m", {}, 1),
    "zamba2": ("zamba2-2.7b", {}, 1),
    "internvl2": ("internvl2-2b", {}, 1),
    "musicgen": ("musicgen-large", {}, 1),
}
RUNS = [(c, "mesh") for c in CASES] + [(c, "zero2") for c, (_, o, _) in CASES.items()
                                       if o.get("zero2")]
ELASTIC = ("smollm-135m", {})


class _ShapeMesh:
    """Axis sizes only: what ``spec()`` reads, in either package."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_inputs(arch, over, accum):
    """The JAX test's inputs for a case: its config, model, initial
    parameters (``jax.random.key(0)``), axes and batch."""
    cfg = dataclasses.replace(jget(arch).reduced(), **over)
    model = JModel(cfg)
    params, axes = model.init(jax.random.key(0))
    batch = JData(cfg, batch=4 * accum, seq=32).batch_at(0)
    if accum > 1:
        batch = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
    return {"cfg": cfg, "model": model, "jparams": params, "jbatch": batch,
            "params": jax.tree.map(np.asarray, params),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "shapes": [tuple(x.shape) for x in jax.tree.leaves(params)],
            "axes": jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))}


def _jax_step(ref, accum):
    """The JAX single-device step on a case's inputs: its loss and stepped
    leaves."""
    opt = JAdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    params = ref.pop("jparams")
    p1, _, met = jax.jit(jmake_train_step(ref.pop("model"), opt, accum_steps=accum))(
        params, opt.init(params), ref.pop("jbatch"))
    ref["loss"] = float(met["loss"])
    ref["stepped"] = [np.asarray(x, np.float32) for x in jax.tree.leaves(p1)]


@pytest.fixture(scope="module")
def reference():
    return {name: _jax_inputs(*case) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory, reference):
    """The rank group's results; the JAX steps run in this process while
    the ranks run (``reference`` gets their losses and stepped leaves)."""
    out = tmp_path_factory.mktemp("train_tp")
    todo = [(name, "split_step", (arch, over, MESH, accum, reference[name]["params"],
                                  reference[name]["batch"]))
            for name, (arch, over, accum) in CASES.items()]
    todo.append(("collectives", "collectives_grads", ()))
    sm = reference["smollm"]
    todo.append(("compressed", "split_compressed", CASES["smollm"][:2] + (sm["params"],
                                                                          sm["batch"])))
    el = reference["smollm"]
    todo.append(("elastic", "checkpoint_elastic", ELASTIC + (el["params"], el["batch"],
                                                            str(out / "ckpt"))))
    todo.append(("trainer", "trainer_resume", ELASTIC + (MESH, str(out / "trainer"))))
    failed = []

    def group():
        try:
            run_ranks(ranks.run_cases, 8, todo, str(out), store=str(out / "store"),
                      timeout_s=120.0)
        except BaseException as e:  # raised below, in the test process
            failed.append(e)

    thread = threading.Thread(target=group)
    thread.start()
    try:
        for name, (_, _, accum) in CASES.items():
            _jax_step(reference[name], accum)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return ranks.load(str(out), 0)


def _case(cases, name):
    found = cases[name]
    assert "error" not in found, found.get("error")
    return found


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("name,run", RUNS, ids=[f"{c}-{r}" for c, r in RUNS])
def test_split_step_matches_single_device(cases, reference, name, run):
    """One split step against the JAX single-device step and the port's
    own single-device step (see the module docstring for the bounds)."""
    found = _case(cases, name)
    got, single, ref = found[run], found["single"], reference[name]
    assert abs(got["loss"] - ref["loss"]) < LOSS_ATOL, (got["loss"], ref["loss"])
    assert abs(got["loss"] - single["loss"]) <= RTOL * abs(single["loss"]), (
        got["loss"], single["loss"])
    assert abs(got["grad_loss"] - single["grad_loss"]) <= RTOL * abs(single["grad_loss"])
    assert abs(got["grad_norm"] - single["grad_norm"]) <= RTOL * single["grad_norm"], (
        got["grad_norm"], single["grad_norm"])
    for i, (g, want) in enumerate(zip(got["grads"], single["grads"], strict=True)):
        err = float(np.abs(g - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (i, err, float(np.abs(want).max()))
    assert _max_diff(got["params"], ref["stepped"]) < PARAM_ATOL
    if "ce_plain" in found:  # a MoE: ce does not depend on the aux semantics
        assert abs(got["ce"] - found["ce_plain"]) <= RTOL * found["ce_plain"]
    cfg = ref["cfg"]
    want_attn = "" if cfg.family == "ssm" else "heads" if cfg.n_heads % MESH[1] == 0 else "seq"
    assert found["split"]["attn"] == want_attn
    assert found["split"]["vocab"] and found["split"]["moe"] == (cfg.family == "moe")


@pytest.mark.parametrize("name", list(CASES))
def test_stored_shards_follow_the_specs(cases, reference, name):
    """Every parameter and both moments of it, as stored on a rank after
    the step, has the shape of its ``rules.spec`` shard, and the port's
    specs are the JAX package's ``ShardingRules``' for the same leaves."""
    found, ref = _case(cases, name), reference[name]
    arch, over, _ = CASES[name]
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    taxes = flatten(TModel(tcfg, device="meta").param_axes(),
                    is_leaf=lambda x: isinstance(x, tuple))[0]
    assert taxes == ref["axes"]
    jrules, trules = JRules(_ShapeMesh(dict(zip(ranks.AXES, MESH))), ref["cfg"]), TRules(
        _ShapeMesh(dict(zip(ranks.AXES, MESH))), tcfg)
    sizes = dict(zip(ranks.AXES, MESH))
    want = []
    for ax, shape in zip(ref["axes"], ref["shapes"], strict=True):
        spec = trules.spec(ax, shape)
        assert spec == tuple(jrules.spec(ax, shape)), (ax, shape)
        want.append(tuple(
            d // math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e or ()))
            for d, e in zip(shape, spec)))
    assert any(w != s for w, s in zip(want, ref["shapes"]))  # something is split
    for run in [r for c, r in RUNS if c == name]:
        for leaves in found[run]["stored"].values():
            assert leaves == want


def test_collectives_carry_gradients(cases):
    """Each collective with a gradient on the 4 "model" ranks (rank r's
    input scaled by r + 1), as rank 0 sees it: enter sums the gradients,
    leave the values, psum both; a gather keeps its slice of a replicated
    gradient or reduce-scatters split ones; the all-to-all sends each
    chunk's gradient back; reduce_scatter is counted as psum_scatter."""
    found = _case(cases, "collectives")
    x = np.arange(8, dtype=np.float32)
    expect = {
        "enter": (x, np.full(8, 10.0)),
        "leave": (10 * x, 20 * x),
        "psum": (10 * x, np.full(8, 10.0)),
        "gather_slice": (np.array([0, 1, 4, 6, 12, 15, 24, 28.0]),
                         np.array([0, 1, 0, 0, 0, 0, 0, 0.0])),
        "gather_rs": (x, np.array([10, 10, 0, 0, 0, 0, 0, 0.0])),
        "all_to_all": (np.array([[0, 1], [0, 2], [0, 3], [0, 4.0]]),
                       np.array([0, 0, 10, 10, 20, 20, 30, 30.0])),
    }
    for op, (y, g) in expect.items():
        np.testing.assert_array_equal(found[op][0], y, err_msg=op)
        np.testing.assert_array_equal(found[op][1], g, err_msg=op)
    stats = found["stats"]["psum_scatter"]
    assert stats["calls"] == 1 and stats["bytes"] == 2 * 4


@pytest.mark.parametrize("name", [c for c, (_, o, _) in CASES.items() if o.get("zero2")])
def test_zero2_gathers_once_a_step(cases, name):
    """ZeRO-2 gathers each FSDP shard once a step, where the plain FSDP
    step gathers it at each use (each microbatch, each remat recompute);
    both give the same step."""
    found = _case(cases, name)
    plain, zero2 = found["mesh"], found["zero2"]
    assert 0 < zero2["all_gathers"] < plain["all_gathers"], (zero2["all_gathers"],
                                                             plain["all_gathers"])
    assert abs(zero2["loss"] - plain["loss"]) <= RTOL * abs(plain["loss"])
    assert _max_diff(zero2["grads"], plain["grads"]) <= GRAD_TOL * max(
        float(np.abs(g).max()) for g in plain["grads"])


def test_split_step_composes_with_compressed_pod_grads(cases):
    """A split step on ("pod", "data", "model") = (2, 2, 2) with the pod
    share of the gradient reduction in int8 (``compress_pod_grads``): the
    loss equals the exact split step's, the parameters within 5e-2 (as
    ``tests/test_torch_train_mesh.py`` holds the data-parallel one), and
    the error feedback is kept per shard."""
    found = _case(cases, "compressed")
    assert abs(found["loss"] - found["loss_exact"]) <= RTOL * found["loss_exact"]
    assert _max_diff(found["params"], found["params_exact"]) < PARAM_ATOL
    assert found["err_max"] > 0 and found["err_shapes"] == found["shapes"]


def test_checkpoint_restores_onto_another_mesh(cases):
    """A step's parameters and first moment saved on (2, 4) restore onto a
    (1, 2) mesh over two ranks (each stored as that mesh's shard) and onto
    one device, gathered bitwise equal to what was saved."""
    found = _case(cases, "elastic")
    for key in ("sub", "one"):
        for a, b in zip(found[key], found["saved"], strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(found[key + "_mu"], found["saved_mu"], strict=True):
            np.testing.assert_array_equal(a, b)
    assert found["sub_step"] == 1
    assert found["stored"] != found["sub_stored"]  # (2, 4)'s shards are not (1, 2)'s


def test_split_trainer_resume_is_bitwise(cases):
    """A split ``Trainer`` failing at step 1 and resumed from its
    checkpoint ends bitwise equal to the uninterrupted run."""
    found = _case(cases, "trainer")
    straight, resumed = found["straight"], found["resumed"]
    assert straight["step"] == resumed["step"] == 2
    assert any("restored step 1" in e for e in resumed["events"]), resumed["events"]
    assert straight["stored"] == resumed["stored"]
    for key in ("params", "mu"):
        for a, b in zip(straight[key], resumed[key], strict=True):
            np.testing.assert_array_equal(a, b)
    assert straight["loss"] == resumed["loss"]


def test_flatten_and_unflatten_hold_no_tree_past_their_return():
    """A tree's leaves are freed by reference counting alone once the
    caller drops them: ``flatten`` / ``unflatten`` leave no reference cycle
    (a recursive closure is one) that would keep every flattened tree, a
    split step's gradients among them, alive until a garbage collection."""
    t = torch.ones(4)
    alive = weakref.ref(t)
    gc.disable()
    try:
        leaves, spec = flatten({"a": {"b": t}, "c": [t, (t,)]})
        out = unflatten(spec, leaves)
        assert out["c"][1][0] is t
        del leaves, out, t
        assert alive() is None
    finally:
        gc.enable()
