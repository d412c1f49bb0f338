"""Rank bodies of the port's mesh tests (``tests/test_torch_sharding.py``,
``tests/test_torch_sharded_serving.py``). ``run_cases`` runs in every
process of one gloo group that ``repro_torch.launch.mesh.run_ranks``
spawns (a group start costs seconds, so a test file starts one) and runs
the cases in turn: each builds its mesh over the group's first ranks
(the others skip it), imports torch and the port only, and returns what it
found; rank 0 saves them (``save``) for the test process to compare with
the JAX package, and a case that raises is saved as its traceback, so that
only its own test fails. Every rank of a mesh runs the same body, as every
rank of a serving mesh runs the same code."""
import dataclasses
import logging
import os
import pickle
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.launch.mesh import in_mesh, make_test_mesh
from repro_torch.models.model import Model
from repro_torch.models.step_graph import ShardedStep
from repro_torch.parallel import collectives as col
from repro_torch.serve.differential import assert_logits_close, assert_streams_equal
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.request import Request
from repro_torch.serve.speculative import SpecConfig

# 4 kv heads so that 2- and 4-way meshes divide them; g = 2 groups
SMALL = dict(num_layers=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=8)


def small_cfg(**over):
    return dataclasses.replace(get_config("smollm-135m").reduced(), **{**SMALL, **over})


def save(out: str, rank: int, obj) -> None:
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out: str, rank: int):
    with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def run_cases(rank, world, cases, out):
    """Run ``cases`` [(name, body name, args)] in turn; rank 0 saves name →
    what the body returned (or {"error": traceback})."""
    found = {}
    for name, body, args in cases:
        try:
            found[name] = globals()[body](rank, world, *args)
        except Exception:
            found[name] = {"error": traceback.format_exc()}
    if rank == 0:
        save(out, rank, found)


def _mesh(shape, names):
    """A mesh over the group's first ranks; None on a rank outside it."""
    mesh = make_test_mesh(shape, names, device="cpu")
    return mesh if in_mesh(mesh) else None


def reqs(cfg, n=4, plen=6, new=8):
    """The JAX test's workload: prompt i is arange(plen)·(i+1) mod V."""
    return [Request(prompt=(np.arange(plen, dtype=np.int32) * (i + 1)) % cfg.vocab_size,
                    max_new_tokens=new) for i in range(n)]


def streams(out: dict) -> list:
    """``serve()``'s rid → tokens, in admission order."""
    return [np.asarray(v) for _, v in sorted(out.items())]


def drive(sched, rs, dt=0.005):
    """Run ``rs`` on a step clock (step i at i·dt), as the port's
    preemption tests do: admission then does not depend on speed."""
    clock = [0.0]
    sched._clock = lambda: clock[0]
    sched.stats.reset()
    for r in rs:
        sched.submit(r)
    i = 0
    while sched._queue or sched._active or sched._chunking:
        clock[0] = i * dt
        sched.step(now=clock[0])
        i += 1
    return [np.asarray(r.output()) for r in rs]


class KernelPath:
    """The ``"kernel"`` backend on CPU tensors: ``require_cuda`` made a
    no-op, so each wrapper runs its plain version (the JAX tests' Pallas
    interpret mode), and the paged wrapper's plain calls counted by mode."""

    def __init__(self):
        self.calls = {"paged": 0, "partials": 0}
        tops.require_cuda = lambda t, what: None
        plain = pda.plain_paged_decode_attention

        def counted(*a, **kw):
            self.calls["partials" if kw.get("partials") or (len(a) > 8 and a[8]) else "paged"] += 1
            return plain(*a, **kw)

        pda.plain_paged_decode_attention = counted


def _steps_run(engine, backend) -> int:
    """Calls of the engine's paged step family of ``backend`` so far (each
    step's eager call is counted from the first time it is seen here)."""
    total = 0
    for key in ("decode_paged", "verify_paged"):
        step = engine._steps[backend].get(key)
        if step is None:
            continue
        if not hasattr(step, "n_calls"):
            inner, step.n_calls = step._eager, 0

            def eager(args, kwargs, inner=inner, step=step):
                step.n_calls += 1
                return inner(args, kwargs)

            step._eager = eager
        total += step.n_calls
    return total


# ---------------------------------------------------------------------------
# serving


MODES = {
    "plain": (dict(), dict()),
    "spec2": (dict(spec=SpecConfig(k=2)), dict()),
    "chunk4": (dict(chunk_size=4), dict(plen=12)),
}
# a mode's pool holds just the blocks its 4 requests reserve, so that the
# allocator's ids reach the upper shards of a seq split (with room to
# spare every block would sit on the first shard)
POOL_BLOCKS = {"plain": 8, "spec2": 8, "chunk4": 12}


def serve_modes(rank, world, shape, names, over, params_np, backend, modes):
    """Serve ``modes`` through a single-device paged engine and a sharded
    one; rank 0 saves both streams, the pool's shard shapes and, on the
    kernel path, the paged and partials calls a step."""
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    kp = KernelPath() if backend == "kernel" else None
    cfg = small_cfg(**over)
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    base = ServingEngine(m, params, max_seq=64, kv_layout="paged",
                         attention_backend=backend, device="cpu")
    sharded = ServingEngine(m, params, max_seq=64, kv_layout="paged",
                            attention_backend=backend, device="cpu", mesh=mesh)
    assert sharded.mesh is mesh and sharded.attention_backend == backend
    sched = sharded.scheduler(4)
    kv = sched.kv
    found = {"pool_k": tuple(kv.pool["k"].shape), "total_blocks": kv.total_blocks,
             "local_blocks": kv.local_blocks, "runs": {}, "calls": {}, "blocks_by_shard": {}}
    del sched
    for mode in modes:
        kw, rkw = MODES[mode]
        base.num_blocks = sharded.num_blocks = POOL_BLOCKS[mode]
        want = streams(base.serve(reqs(cfg, **rkw), max_batch=4, **kw))
        backend_fns = sharded._family(backend, "paged", kw.get("spec"), kw.get("chunk_size"))
        assert isinstance(backend_fns["decode_paged"], ShardedStep)
        n0 = _steps_run(sharded, backend)
        before = dict(kp.calls) if kp else {}
        claimed, pools = [], []  # the allocator ids the run's blocks took; its pool
        serve_sched = sharded.scheduler

        def watched(*a, **k):
            sched = serve_sched(*a, **k)
            alloc = sched.kv.allocator.alloc
            sched.kv.allocator.alloc = lambda: claimed.append(alloc()) or claimed[-1]
            pools.append(sched.kv)
            return sched

        sharded.scheduler = watched
        got = streams(sharded.serve(reqs(cfg, **rkw), max_batch=4, **kw))
        del sharded.scheduler
        if kp:
            found["calls"][mode] = {k: kp.calls[k] - before[k] for k in kp.calls}
            found["calls"][mode]["steps"] = _steps_run(sharded, backend) - n0
        # the shard each claimed block lies on (the pool's slot layout)
        run_kv = pools[0]
        shard = run_kv._slot[np.asarray(claimed, np.int64)] // run_kv.local_blocks
        found["blocks_by_shard"][mode] = np.bincount(shard, minlength=run_kv.seq_shards).tolist()
        assert_streams_equal(dict(enumerate(want)), dict(enumerate(got)), label=mode)
        found["runs"][mode] = (want, got)
    return found


def seq_one_step(rank, world, params_np):
    """One decode step over a seq-2 pool where every row's one block sits on
    rank 0 (rank 1's shard is empty): the logits of the sharded step
    against ``jit_step``'s, on both backends' code paths."""
    mesh = _mesh((2,), ("seq",))
    if mesh is None:
        return None
    KernelPath()
    cfg = small_cfg()
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    prompts = [(np.arange(3, dtype=np.int32) * (i + 1)) % cfg.vocab_size for i in range(4)]
    found = {}
    for backend in ("reference", "kernel"):
        logits = {}
        for use_mesh in (False, True):
            kv = PagedKVCache(m, max_batch=4, max_seq=32, block_size=8,
                              mesh=mesh if use_mesh else None, prefix_cache=False)
            for i, p in enumerate(prompts):
                assert kv.try_admit(i, p, budget=8) is not None
                _, dense = m.prefill(params, torch.as_tensor(p)[None].long(), 32)
                kv.write_prefill(i, dense)
            step = (m.sharded_paged_step("decode_step_paged", mesh, backend=backend)
                    if use_mesh else m.jit_step("decode_step_paged", backend=backend))
            pool, tables, lens = kv.kernel_inputs()
            if use_mesh:
                # every row's one block lies on rank 0's shard
                assert (tables[:, 0].numpy() // kv.local_blocks == 0).all()
            tok = torch.as_tensor([[int(p[-1])] for p in prompts]).long()
            logits[use_mesh], _ = step(params, pool, tables, lens, tok)
        gap = assert_logits_close(logits[False].numpy(), logits[True].numpy(), atol=1e-4,
                                  label=f"seq2 one-step {backend}")
        found[backend] = (logits[False].numpy(), logits[True].numpy(), gap)
    return found


class _Count(logging.Handler):
    def __init__(self):
        super().__init__()
        self.n = 0

    def emit(self, record):
        self.n += 1


def fallback_warns_once(rank, world, params_np):
    """3 kv heads over a 'model' axis of 2: the engine warns once over three
    serves, keeps one record, adopts no mesh and serves replicated."""
    mesh = _mesh((2,), ("model",))
    if mesh is None:
        return None
    cfg = small_cfg(n_heads=6, n_kv_heads=3)
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    eng = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu")
    base = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu")
    h = _Count()
    logging.getLogger("repro_torch.serve").addHandler(h)
    outs = [streams(eng.serve(reqs(cfg), max_batch=4, mesh=mesh)) for _ in range(3)]
    logging.getLogger("repro_torch.serve").removeHandler(h)
    want = streams(base.serve(reqs(cfg), max_batch=4))
    return {"warnings": h.n, "records": list(eng.mesh_fallbacks), "mesh": eng.mesh,
            "want": want, "outs": outs}


def _pressure_workload():
    low = [Request(prompt=np.arange(20, dtype=np.int32) + i, max_new_tokens=10,
                   arrival_time=0.0, priority=0) for i in range(2)]
    high = [Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4,
                    arrival_time=0.02, priority=5)]
    return low + high


def preempt_resume(rank, world, shape, names, params_np):
    """Block-pressure preemption and its resume (a prefix hit on the parked
    blocks, gathered from their shards) on a sharded pool, on a step clock:
    the streams of a roomy unsharded serve."""
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    cfg = small_cfg()
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    pressured = ServingEngine(m, params, max_seq=128, kv_layout="paged", max_batch=2,
                              block_size=8, num_blocks=10, device="cpu", mesh=mesh)
    roomy = ServingEngine(m, params, max_seq=128, kv_layout="paged", max_batch=4,
                          block_size=8, device="cpu")
    sched = pressured.scheduler(2)
    gathers, gather = [], sched.kv.gather_prefix
    sched.kv.gather_prefix = lambda ids: gathers.append(len(ids)) or gather(ids)
    got = drive(sched, _pressure_workload())
    n_pre = sched.stats.n_preemptions
    rsched = roomy.scheduler(4)
    want = drive(rsched, _pressure_workload())
    return {"got": got, "want": want, "preemptions": n_pre, "gathers": gathers,
            "roomy_preemptions": rsched.stats.n_preemptions,
            "recomputed": sched.stats.recomputed_tokens}


def divergence_guard(rank, world, params_np):
    """The schedule's guards on a head split: rank 1's clock runs 100 s
    ahead and the streams stay those of a single device (rank 0's clock
    rules); then one entry of rank 1's block table is changed mid-run, and
    every rank raises at the next step."""
    mesh = _mesh((2,), ("model",))
    if mesh is None:
        return None
    cfg = small_cfg()
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    eng = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu", mesh=mesh)
    base = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu")
    sched = eng.scheduler(4)
    if rank == 1:
        clock = sched._clock
        sched._clock = lambda: clock() + 100.0
    rs = [Request(prompt=r.prompt, max_new_tokens=8, arrival_time=0.01 * i)
          for i, r in enumerate(reqs(cfg))]
    got = [np.asarray(v) for _, v in sorted(sched.run(rs).items())]
    want = streams(base.serve(reqs(cfg), max_batch=4))
    sched = eng.scheduler(4)
    for r in reqs(cfg):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    if rank == 1:
        sched.kv.block_tables[0, -1] += 1  # one table entry differs on rank 1
    raised = None
    try:
        sched.step()
    except RuntimeError as e:
        raised = str(e)
    assert rank == 0 or raised is not None
    return {"got": got, "want": want, "raised": raised}


def controlled(rank, world, params_np):
    """An online adviser steering K over (0, 2) on a head split, seeded from
    the mesh engine's ``prime()``: rank 0 decides (its measured windows),
    every rank applies the broadcast decision, and the streams are plain
    decoding's."""
    from repro_torch.serve.controller import OnlineAdviser

    mesh = _mesh((2,), ("model",))
    if mesh is None:
        return None
    cfg = small_cfg()
    m = Model(cfg, device="cpu")
    params = m.params_from_reference(params_np)
    eng = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu", mesh=mesh)
    base = ServingEngine(m, params, max_seq=64, kv_layout="paged", device="cpu")
    ctl = OnlineAdviser(ks=(0, 2), decision_interval=2, dwell=1, probe_every=1)
    ctl.seed_costs(eng.prime(4, ks=(0, 2)))
    got = streams(eng.serve(reqs(cfg, new=24), max_batch=4, controller=ctl))
    want = streams(base.serve(reqs(cfg, new=24), max_batch=4))
    info = eng.stats.controller_info
    return {"got": got, "want": want, "decisions": len(ctl.decisions), "info": info}


# ---------------------------------------------------------------------------
# collectives and the MoE paths


def collectives_vs_dense(rank, world, n):
    """distributed_softmax (random partials, one empty rank, all empty),
    ring_allgather_matmul, matmul_reducescatter and sp_swiglu over a
    'model' axis of ``world`` ranks, each against its unsplit version."""
    from repro_torch.models.layers import swiglu
    from repro_torch.parallel.sharding import ShardingRules

    mesh = _mesh((n,), ("model",))
    if mesh is None:
        return None
    world = n
    g = torch.Generator().manual_seed(0)
    B, H, S, d = 2, 3, 8 * world, 8
    logits = torch.randn((B, H, S), generator=g) * 4.0
    v = torch.randn((B, H, S, d), generator=g)
    sh = S // world
    mine = slice(rank * sh, (rank + 1) * sh)

    def combine(keep):
        lg = torch.where(keep[mine], logits[..., mine], torch.tensor(-1e30))
        m = lg.amax(-1)
        p = torch.where(keep[mine], torch.exp(lg - m[..., None]), torch.tensor(0.0))
        acc = torch.einsum("bhs,bhsd->bhd", p, v[:, :, mine])
        return col.distributed_softmax(m, p.sum(-1), acc, mesh, "model")

    def unsplit(keep):
        lg = torch.where(keep, logits, torch.tensor(float("-inf")))
        return torch.einsum("bhs,bhsd->bhd", torch.softmax(lg, -1), v)

    errs = {}
    for label, keep in (("all", torch.ones(S, dtype=torch.bool)),
                        ("first_only", torch.arange(S) < sh)):
        got = combine(keep)
        assert not torch.isnan(got).any(), label
        errs[label] = float((got - unsplit(keep)).abs().max())
    zeros = combine(torch.zeros(S, dtype=torch.bool))
    assert torch.equal(zeros, torch.zeros_like(zeros)), "all-empty combine must be exact zeros"

    T, D, F = 8 * world, 16, 8 * world
    x, w1 = torch.randn((T, D), generator=g), torch.randn((D, F), generator=g)
    w2, h = torch.randn((F, D), generator=g), torch.randn((T, F), generator=g)
    t_l, f_l = T // world, F // world
    agm = col.ring_allgather_matmul(x[rank * t_l:(rank + 1) * t_l],
                                    w1[:, rank * f_l:(rank + 1) * f_l], mesh, "model")
    errs["allgather_matmul"] = float((agm - (x @ w1)[:, rank * f_l:(rank + 1) * f_l]).abs().max())
    rsm = col.matmul_reducescatter(h[:, rank * f_l:(rank + 1) * f_l],
                                   w2[rank * f_l:(rank + 1) * f_l], mesh, "model")
    errs["matmul_reducescatter"] = float((rsm - (h @ w2)[rank * t_l:(rank + 1) * t_l]).abs().max())
    cfg = small_cfg()
    xs = torch.randn((2, 4 * world, D), generator=g)
    w3 = torch.randn((D, F), generator=g)
    y = col.sp_swiglu(xs, w1, w3, w2, ShardingRules(mesh, cfg))
    errs["sp_swiglu"] = float((y - swiglu(xs, w1, w3, w2)).abs().max())
    return errs


def moe_paths(rank, world, params_np, x_np, xd_np):
    """The three expert-parallel MoE paths of reduced granite on a
    ("data", "model") = (2, 4) mesh of 8 ranks: dispatch on ``x``, dense and
    the legacy dense on the decode batch ``xd``; rank 0 saves the outputs."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ShardingRules

    mesh = _mesh((2, 4), ("data", "model"))
    if mesh is None:
        return None
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params_np.items()}
    rules = ShardingRules(mesh, cfg)
    x, xd = torch.from_numpy(x_np), torch.from_numpy(xd_np)
    found = {"dispatch": moe.moe_block(x, params, cfg, rules, path="dispatch")[0].numpy(),
             "dense": moe.moe_block(xd, params, cfg, rules, path="dense")[0].numpy(),
             "local": moe.moe_block(x, params, cfg)[0].numpy()}
    moe.LEGACY_DENSE = True
    try:
        found["legacy"] = moe.moe_block(xd, params, cfg, rules, path="dense")[0].numpy()
    finally:
        moe.LEGACY_DENSE = False
    return found
