"""Sharded paged serving of the port against the JAX package, on the CPU:
every case of ``tests/test_sharded_serving.py``, on its 2-layer config (8
heads over 4, hd 8), all in one group of 4 gloo rank processes
(``repro_torch.launch.mesh.run_ranks``; the rank bodies are in
``tests/_torch_mesh_ranks.py``, a mesh of fewer ranks runs on the group's
first ones). The JAX parameters are carried over, and
the JAX single-device paged engine gives the reference streams.

- head splits (``tp`` 2 and 4), float and int8 pools, plain / K = 2 /
  chunk 4: token-identical to the port's single-device paged engine and to
  the JAX engine, with one paged call a layer a step on each rank (the
  kernel path: each wrapper's plain version, as the JAX tests run Pallas in
  interpret mode);
- model2 / seq2 / model2×seq2 through ``assert_streams_equal``, the seq
  ranks with one partials call a layer a step; seq2 on the reference
  backend; the one-step logits with an empty shard within 1e-4;
- the GQA fallback warning once; preemption and resume equal to a roomy
  unsharded serve; the schedule's guards (rank 0's clock, the divergence
  check); the paged kernel's plan on a head split's rank."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro_torch.kernels.paged_decode_attention import paged_plan
from repro_torch.launch.mesh import run_ranks

import _torch_mesh_ranks as ranks

_JAX = {}  # (cfg overrides, mode) → JAX streams, shared by the tests
_PARAMS = {}  # cfg overrides → _jax_params


def _jcfg(**over):
    return dataclasses.replace(jget("smollm-135m").reduced(), **{**ranks.SMALL, **over})


def _jax_params(**over):
    """(JAX model, its params, the params as numpy), made once a config."""
    key = tuple(sorted(over.items()))
    if key not in _PARAMS:
        jm = JModel(_jcfg(**over))
        jp, _ = jm.init(jax.random.key(0))
        _PARAMS[key] = (jm, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[key]


def _jreqs(cfg, n=4, plen=6, new=8):
    return [JRequest(prompt=(np.arange(plen, dtype=np.int32) * (i + 1)) % cfg.vocab_size,
                     max_new_tokens=new) for i in range(n)]


def _jax_streams(over, mode):
    key = (tuple(sorted(over.items())), mode)
    if key not in _JAX:
        jm, jp, _ = _jax_params(**over)
        eng = JEngine(jm, jp, max_seq=64, kv_layout="paged", attention_backend="reference")
        kw = {"plain": {}, "spec2": {"spec": JSpec(k=2)}, "chunk4": {"chunk_size": 4}}[mode]
        rkw = {"plen": 12} if mode == "chunk4" else {}
        out = eng.serve(_jreqs(jm.cfg, **rkw), max_batch=4, **kw)
        _JAX[key] = [np.asarray(v) for _, v in sorted(out.items())]
    return _JAX[key]


MODES = ("plain", "spec2", "chunk4")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case, run in one group of 4 gloo ranks (a group start costs
    seconds): name → what rank 0 found, or {"error": traceback}."""
    _, _, f32 = _jax_params()
    _, _, q8 = _jax_params(kv_quant=True)
    _, _, gqa3 = _jax_params(n_heads=6, n_kv_heads=3)
    serve = "serve_modes"
    todo = [
        ("tp2", serve, ((2,), ("model",), {}, f32, "kernel", MODES)),
        ("tp4", serve, ((4,), ("model",), {}, f32, "kernel", MODES)),
        ("tp2_int8", serve, ((2,), ("model",), {"kv_quant": True}, q8, "kernel", MODES)),
        ("tp4_int8", serve, ((4,), ("model",), {"kv_quant": True}, q8, "kernel", MODES)),
        ("seq2", serve, ((2,), ("seq",), {}, f32, "kernel", MODES)),
        ("model2xseq2", serve, ((2, 2), ("model", "seq"), {}, f32, "kernel", MODES)),
        ("seq2_reference", serve, ((2,), ("seq",), {}, f32, "reference", ("plain", "spec2"))),
        ("one_step", "seq_one_step", (f32,)),
        ("fallback", "fallback_warns_once", (gqa3,)),
        ("preempt_tp2", "preempt_resume", ((2,), ("model",), f32)),
        ("preempt_tp4", "preempt_resume", ((4,), ("model",), f32)),
        ("preempt_seq2", "preempt_resume", ((2,), ("seq",), f32)),
        ("preempt_model2xseq2", "preempt_resume", ((2, 2), ("model", "seq"), f32)),
        ("guards", "divergence_guard", (f32,)),
        ("controlled", "controlled", (f32,)),
    ]
    out = tmp_path_factory.mktemp("mesh")
    run_ranks(ranks.run_cases, 4, todo, str(out), store=str(out / "store"),
              timeout_s=120.0)
    return ranks.load(str(out), 0)


def _case(cases, name):
    found = cases[name]
    assert "error" not in found, found.get("error")
    return found


def _same(a, b, label):
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{label} stream #{i} diverged")


def _check_modes(found, over, modes, layers=2):
    for mode in modes:
        want, got = found["runs"][mode]
        _same(got, want, f"{mode}: sharded vs the port's single-device engine")
        _same(got, _jax_streams(over, mode), f"{mode}: sharded vs the JAX engine")


def _check_calls(found, modes, kind, layers=2):
    """One ``kind`` call (paged or partials) a layer a sharded step, and
    none of the other kind; a chunked run's prefill chunks (unsharded, over
    their dense staging cache) add paged calls of their own."""
    other = "partials" if kind == "paged" else "paged"
    for mode in modes:
        c = found["calls"][mode]
        assert c["steps"] > 0, (mode, c)
        if mode == "chunk4":
            assert c["partials"] == (layers * c["steps"] if kind == "partials" else 0), c
            assert c["paged"] > (0 if kind == "partials" else layers * c["steps"]), c
            continue
        assert c[kind] == layers * c["steps"], (mode, c)
        assert c[other] == 0, (mode, c)


@pytest.mark.parametrize("tp", [2, 4])
def test_head_split_token_identity_modes(tp, cases):
    """plain / K = 2 / chunk 4 over a tp-way head-split pool == the
    single-device paged engine's streams and the JAX engine's, each rank
    holding its kv heads, one paged call a layer a step."""
    found = _case(cases, f"tp{tp}")
    assert found["pool_k"][3] == 4 // tp, found["pool_k"]
    _check_modes(found, {}, MODES)
    _check_calls(found, MODES, "paged")


@pytest.mark.parametrize("tp", [2, 4])
def test_head_split_token_identity_int8(tp, cases):
    """An int8 pool (values and scales both head-split) serves plain, K = 2
    and chunk 4 token-identically to the single-device int8 engines."""
    over = {"kv_quant": True}
    found = _case(cases, f"tp{tp}_int8")
    assert found["pool_k"][3] == 4 // tp, found["pool_k"]
    _check_modes(found, over, MODES)
    _check_calls(found, MODES, "paged")


@pytest.mark.parametrize(
    "shape,names",
    [((2,), ("model",)), ((2,), ("seq",)), ((2, 2), ("model", "seq"))],
    ids=["model2", "seq2", "model2xseq2"],
)
def test_mesh_shapes_token_identity(shape, names, cases):
    """Every mesh family: head-only, kv-sequence split and the 2D
    composition, plain / K = 2 / chunk 4, through ``assert_streams_equal``
    (in the rank) against the single-device engine and against the JAX
    engine; the pool is partitioned on each axis of size > 1, and a seq
    rank runs the partials mode, one call a layer a step. (model2 is the
    tp2 case's serve.)"""
    sizes = dict(zip(names, shape))
    found = _case(cases, "tp2" if names == ("model",) else "x".join(f"{n}{k}" for n, k in
                                                                    sizes.items()))
    assert found["pool_k"][3] == 4 // sizes.get("model", 1)
    if "seq" in sizes:
        assert found["local_blocks"] * 2 == found["total_blocks"]
        assert found["pool_k"][1] == found["local_blocks"]
        # both seq shards held blocks of the run in every mode
        assert all(min(n) > 0 for n in found["blocks_by_shard"].values()), found

    _check_modes(found, {}, MODES)
    _check_calls(found, MODES, "partials" if "seq" in sizes else "paged")


def test_seq_split_reference_backend(cases):
    """The reference backend on a seq split goes through the partials
    route too (the dense route's global tables cannot address a shard)."""
    found = _case(cases, "seq2_reference")
    _check_modes(found, {}, ("plain", "spec2"))


def test_seq_split_logit_tolerance_empty_shards(cases):
    """Rows short enough that rank 1's shard holds none of their blocks
    decode NaN-free, argmax-identical and within 1e-4 of the single-device
    step, on both backends' code paths; and the single-device step is the
    JAX one's within 1e-4."""
    import jax.numpy as jnp

    from repro.serve.kv_cache import PagedKVCache as JPaged

    jm, jp, _ = _jax_params()
    found = _case(cases, "one_step")
    prompts = [(np.arange(3, dtype=np.int32) * (i + 1)) % jm.cfg.vocab_size for i in range(4)]
    kv = JPaged(jm, max_batch=4, max_seq=32, block_size=8, prefix_cache=False)
    for i, p in enumerate(prompts):
        assert kv.try_admit(i, p, budget=8) is not None
        _, dense = jm.prefill(jp, jnp.asarray(p)[None], 32)
        kv.write_prefill(i, dense)
    pool, tables, lens = kv.kernel_inputs()
    tok = jnp.asarray([[int(p[-1])] for p in prompts], jnp.int32)
    want, _ = jm.jit_step("decode_step_paged", backend="reference")(jp, pool, tables, lens, tok)
    for backend in ("reference", "kernel"):
        base, got, gap = found[backend]
        assert gap <= 1e-4
        np.testing.assert_allclose(base, np.asarray(want), atol=1e-4, rtol=1e-4)
        assert not np.isnan(got).any()


def test_mesh_fallback_warns_once(cases):
    """3 kv heads over 'model' = 2: three serves warn once, keep one
    record, adopt no mesh and give the single-device streams."""
    found = _case(cases, "fallback")
    assert found["warnings"] == 1, found["warnings"]
    assert len(found["records"]) == 1, found["records"]
    assert found["mesh"] is None
    for got in found["outs"]:
        _same(got, found["want"], "fallback")


@pytest.mark.parametrize("mesh", ["tp2", "tp4", "seq2", "model2xseq2"])
def test_sharded_preempt_resume_identity(mesh, cases):
    """Block-pressure preemption and suffix resume on a sharded pool (the
    resume's prefix hit gathered from the head shards, summed over the seq
    shards): the evicted-and-resumed streams equal a roomy unsharded
    serve's."""
    found = _case(cases, f"preempt_{mesh}")
    assert found["gathers"] and min(found["gathers"]) > 0, found["gathers"]
    assert found["preemptions"] > 0, "the pressure scenario did not evict"
    assert found["roomy_preemptions"] == 0
    _same(found["got"], found["want"], "preempted")


def test_schedule_guards(cases):
    """Rank 0's clock rules a mesh's admissions (rank 1's runs 100 s ahead,
    and the streams are the single device's), and a rank whose block table
    diverges makes every rank raise at the next step."""
    found = _case(cases, "guards")
    _same(found["got"], found["want"], "skewed clock")
    assert found["raised"] is not None and "diverged" in found["raised"], found["raised"]


def test_controller_on_a_mesh(cases):
    """An ``OnlineAdviser`` over K in (0, 2) on a head split: rank 0's
    decisions (broadcast) steer every rank, and the streams are plain
    decoding's."""
    found = _case(cases, "controlled")
    assert found["decisions"] > 0 and found["info"]["decisions"] > 0, found["info"]
    _same(found["got"], found["want"], "controlled")


@pytest.mark.parametrize("B,KV,tp", [(1, 3, 3), (4, 8, 2), (4, 8, 4), (8, 32, 2), (2, 4, 4)])
def test_plan_repair_splits(B, KV, tp):
    """A head split's rank launches over KV/tp heads; with the unsharded
    head count its plan splits every row as the single-device plan does,
    whatever T (and only the splits needed the count)."""
    import torch

    for T in (1, 3, 5):
        full = paged_plan(torch.float32, torch.float32, B, T, 6 * KV, KV, 64, 16, 128)
        loc = paged_plan(torch.float32, torch.float32, B, T, 6 * KV // tp, KV // tp, 64, 16, 128,
                         plan_kv=KV)
        assert loc["splits"] == full["splits"], (T, loc, full)
        assert {k: loc[k] for k in ("rows", "tile", "stages", "n_tiles")} == {
            k: full[k] for k in ("rows", "tile", "stages", "n_tiles")}


class _FakeMesh:
    """Axis names, sizes and this rank's coordinates: what building a
    sharded step reads (it runs no collective until it is called)."""

    def __init__(self, shape: dict, coords: dict):
        self.mesh_dim_names, self.shape = tuple(shape), tuple(shape.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


def test_sharded_step_local_view():
    """``sharded_paged_step``: a 1×1 mesh is ``jit_step``; heads the
    'model' axis does not divide raise the reference's ValueError; a head
    split's local view carries the rank's head counts, the unsharded kv
    heads for the kernel's plan, the rank's columns of wq/wk/wv and the
    whole wo."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.step_graph import ShardedStep, StepGraph

    cfg = ranks.small_cfg()
    m = Model(cfg, device="cpu")
    params = m.init(seed=0)
    one = m.sharded_paged_step("decode_step_paged", _FakeMesh({"model": 1, "seq": 1}, {}))
    assert isinstance(one, StepGraph) and not isinstance(one, ShardedStep)
    with pytest.raises(ValueError, match="do not divide mesh axis 'model'"):
        m.sharded_paged_step("decode_step_paged", _FakeMesh({"model": 3}, {"model": 0}))
    step = m.sharded_paged_step("verify_step_paged",
                                _FakeMesh({"model": 2, "seq": 2}, {"model": 1, "seq": 0}))
    local = step.model
    assert (local.cfg.n_heads, local.cfg.n_kv_heads, local.plan_kv_heads) == (4, 2, 4)
    assert (local.tp_axis, local.seq_axis, local.rules) == ("model", "seq", None)
    lp = step.local_params(params)
    assert lp is step.local_params(params)  # sliced once per parameter dict
    attn, full = lp["layers"]["attn"], params["layers"]["attn"]
    assert torch.equal(attn["wq"], full["wq"][:, :, 4:8])
    assert torch.equal(attn["wk"], full["wk"][:, :, 2:4])
    assert attn["wo"] is full["wo"]
    assert step.eager and step._cache_size() == 0
    # the flat layout (attn_flat_tp: wq [L, D, H·hd], wo [L, H·hd, D]): a
    # head block is a column range, and the model runs it as the 3-D one
    L, D = cfg.num_layers, cfg.d_model
    flat_attn = {k: v.reshape(L, D, -1) for k, v in full.items() if k != "wo"}
    flat_attn["wo"] = full["wo"].reshape(L, -1, D)
    flat = dict(params, layers=dict(params["layers"], attn=flat_attn))
    flat_step = m.sharded_paged_step("decode_step_paged",
                                     _FakeMesh({"model": 2}, {"model": 1}))
    np.testing.assert_array_equal(flat_step.local_params(flat)["layers"]["attn"]["wq"].numpy(),
                                  attn["wq"].reshape(L, D, -1).numpy())
    tok = torch.arange(6).reshape(1, 6)
    want, _ = m.forward(params, tok)
    got, _ = m.forward(flat, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
