"""Latency-critical serving on the port's continuous-batching core: the
counterpart of the JAX package's ``examples/serve_decode.py``, with its
flags, defaults, exclusions and report lines.

Two modes:

* fixed batch (default): ``generate()`` decodes a full batch through the
  scheduler and prints per-step latency percentiles;
* open loop (``--open-loop N``): N requests with Poisson arrivals
  (``--rate`` req/s), random prompt lengths and random token budgets are
  admitted into a ``--batch``-row pool as rows free up, and per-request
  TTFT is reported.

Either mode optionally runs with the int8 KV cache (``--int8-kv``), the
block-paged pool with prefix reuse (``--paged``), n-gram speculation
(``--spec K``; greedy streams are unchanged, the acceptance rate is
printed), a decode plan advised by Aira (``--aira``: the decode step as a
Region, advised, and decoding routed through the accepted RegionPlan), the
closed-loop ``OnlineAdviser`` (``--online``: ``engine.prime()`` measures
the K × backend grid, the controller re-decides K every few steps, the
audit trail is printed), chunked prefill (``--chunk N``), the flight
recorder (``--trace PATH``: Chrome/Perfetto trace-event JSON) and a serving
mesh (``--mesh N``: the paged pool's kv heads over an N-way ``("model",)``
mesh; requires ``--paged`` and ``--open-loop``; an arch whose kv heads N
does not divide serves replicated, with the engine's warning).

Where it differs from the JAX script:

* ``--device`` picks the torch device: CUDA by default, ``cpu`` for the
  plain PyTorch path. Without a card and without ``--device cpu`` it
  exits non-zero.
* ``--backend`` is ``auto`` (the kernels on the card, the plain path on
  the CPU), ``reference`` or ``kernel`` (the hand-written CUDA kernels:
  paged decode, flash prefill, SSD scan). ``interpret`` is refused: the
  Pallas kernels' interpret mode has no Hopper counterpart.
* The weights (``Model.init(seed=0)``) and the fixed batch's prompts (a
  numpy draw from seed 1) are not JAX's: ``jax.random``'s streams have no
  torch counterpart. The open-loop requests are the same (both packages
  draw them with numpy from seed 0).
* ``--mesh N`` spawns N rank processes joined into one gloo group
  (``launch/mesh.py::run_ranks``), every rank serving the same requests on
  its shard (on one card, all ranks share it); rank 0 prints, and the
  streams are checked equal across the ranks.
* ``--record PATH`` writes what the run printed, as JSON: the streams (in
  request order), ``serving_summary()``, the per-request latencies, the
  kernel launches, the decisions and the trace counts.
* On the card a ``kernels:`` line reports the launches of the paged,
  flash and SSD kernels during the run.

  python -m repro_torch.examples.serve_decode [--arch zamba2-2.7b]
      [--int8-kv] [--paged] [--spec 4] [--tokens 32] [--batch 4]
      [--aira] [--open-loop 8] [--rate 20] [--backend kernel]
      [--chunk 16] [--mesh 2] [--online] [--trace serve_trace.json]
      [--device cpu] [--record run.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import tempfile

import numpy as np
import torch

from repro_torch.examples import add_device_flag, device_or_exit, write_record

MAX_SEQ = 256
PROMPT_LEN = 16
INTERPRET_REFUSED = (
    "--backend interpret: the port has no interpret backend (the Pallas kernels' "
    "interpret mode has no Hopper counterpart); use --backend kernel for the CUDA "
    "kernels or --backend reference for the plain PyTorch path")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_decode")
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch size / open-loop slot-pool size")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache with shared-prefix reuse")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative decoding: K n-gram draft tokens per verify "
                         "(0 = off; token streams stay exactly greedy)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "reference", "kernel", "interpret"),
                    help="decode/verify attention backend: the CUDA kernels ('kernel'), "
                         "the plain PyTorch path ('reference'), or by device ('auto'); "
                         "'interpret' is refused (no Hopper counterpart)")
    ap.add_argument("--aira", action="store_true",
                    help="advise the decode step and serve through its RegionPlan")
    ap.add_argument("--open-loop", type=int, default=0, metavar="N",
                    help="serve N Poisson-arrival requests instead of one fixed batch")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="open-loop arrival rate (requests/second)")
    ap.add_argument("--chunk", type=int, default=0, metavar="N",
                    help="chunked prefill: admit at most N prompt tokens of prefill "
                         "per decode step (pow2; 0 = monolithic)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="serve over an N-way ('model',) mesh of rank processes: the "
                         "paged pool's kv heads split over the ranks (requires --paged "
                         "and --open-loop; token streams stay those of one device)")
    ap.add_argument("--online", action="store_true",
                    help="closed-loop serving: prime the K × backend grid, attach the "
                         "OnlineAdviser and print the decision audit trail (requires "
                         "--open-loop)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="arm the serving flight recorder and export Chrome/Perfetto "
                         "trace-event JSON to PATH")
    add_device_flag(ap)
    ap.add_argument("--record", metavar="PATH", default=None,
                    help="write what the run printed (streams, summary, launches) as JSON")
    return ap


def check_flags(args) -> None:
    """The JAX script's exclusions, with its messages; then the backend
    the port does not have."""
    if args.spec and args.aira:
        raise SystemExit("--spec and --aira both rewrite the decode step; pick one")
    if args.online and args.aira:
        raise SystemExit("--online and --aira both re-decide the decode step; pick one")
    if args.online and not args.open_loop:
        raise SystemExit("--online rides the serve() path; add --open-loop N")
    if args.mesh > 1:
        if not args.paged:
            raise SystemExit("--mesh shards the paged pool; add --paged")
        if not args.open_loop:
            raise SystemExit("--mesh rides the serve() path; add --open-loop N")
    if args.backend == "interpret":
        raise SystemExit(INTERPRET_REFUSED)


def model_config(args, cfg=None):
    """The served config: ``cfg`` (default ``--arch``'s, ``.reduced()``),
    with the int8 KV cache under ``--int8-kv``."""
    from repro_torch.configs import get_config

    cfg = get_config(args.arch).reduced() if cfg is None else cfg
    return dataclasses.replace(cfg, kv_quant=True) if args.int8_kv else cfg


def make_prompts(cfg, batch: int) -> np.ndarray:
    """The fixed batch's prompts [batch, 16] int32: a numpy draw from seed 1."""
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (batch, PROMPT_LEN)).astype(np.int32)


def open_loop_requests(args, cfg):
    """``--open-loop``'s requests, drawn as the JAX script draws them."""
    from repro_torch.serve.load import make_requests

    return make_requests(args.open_loop, args.rate, vocab=cfg.vocab_size,
                         max_new_tokens=args.tokens, rng=np.random.default_rng(0))


def kernel_launches() -> dict:
    """The launch counts of the kernels serving runs: the paged decode
    kernel over float pools, over int8 pools and in its partials mode, the
    causal flash prefill and the SSD scan."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ssd_scan as ssd

    p = pda.paged_decode_attention
    return {"paged": p.launches, "paged_int8": p.launches_int8,
            "partials": p.launches_partials, "flash": fa.flash_attention.launches,
            "ssd": ssd.ssd_scan.launches}


def main(argv=None, *, device=None, cfg=None, model=None, params=None, prompts=None) -> dict:
    """Parse ``argv`` (the command line when None), serve, print the
    report, and return it as data. Hooks: ``cfg`` (the config to serve in
    place of ``--arch``'s reduced one), ``model`` (a built model, whose
    config is then served), ``params`` (weights in place of
    ``Model.init(seed=0)``, e.g. the JAX package's through
    ``Model.params_from_reference``) and ``prompts`` (the fixed batch, or
    ``--aira``'s region batch, [B, S] ints). Under ``--mesh`` every rank
    builds the model from ``cfg`` and takes ``params`` through host
    memory."""
    args = build_parser().parse_args(argv)
    check_flags(args)
    dev = device_or_exit(device if device is not None else args.device)
    if args.mesh > 1:
        if model is not None:
            raise ValueError("--mesh: each rank builds its own model; pass cfg= and params=")
        return _serve_mesh(args, dev, cfg, params, prompts)
    record = serve(args, dev, cfg=cfg, model=model, params=params, prompts=prompts)
    write_record(args.record, record)
    return record


def serve(args, dev, *, cfg=None, model=None, params=None, prompts=None, mesh=None,
          rank: int = 0) -> dict:
    """One process's run (a rank's on a mesh: rank 0 prints and traces)."""
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, SpecConfig
    from repro_torch.serve.telemetry import configure, get_telemetry, validate_chrome_trace
    from repro_torch.tree import map_tree

    lines = []

    def say(*parts):
        line = " ".join(str(p) for p in parts)
        lines.append(line)
        if rank == 0:
            print(line, flush=True)

    if args.trace:
        # arm the module-global recorder before the engine is built, so the
        # scheduler's metric handles are live for the run
        configure(enabled=True)
    try:
        if model is None:
            model = Model(model_config(args, cfg), dev)
        cfg = model.cfg
        params = (model.init(seed=0) if params is None
                  else map_tree(lambda t: t.to(dev), params))
        engine = ServingEngine(
            model, params, max_seq=MAX_SEQ, kv_layout="paged" if args.paged else "slot",
            spec=SpecConfig(k=args.spec, drafter="ngram") if args.spec else None,
            attention_backend=args.backend, device=dev, mesh=mesh)
        prompts = make_prompts(cfg, args.batch) if prompts is None else np.array(prompts)
        record = {"arch": args.arch, "backend": engine.attention_backend,
                  "mesh_fallbacks": engine.mesh_fallbacks}
        before = kernel_launches()

        if args.aira:
            from repro_torch.core import Aira, Workload

            region = engine.decode_region(prompts, force=True)
            report = Aira().advise(Workload("serve-decode", lambda: None, [region]))
            say(report.render())
            d = report.decisions[0]
            record["aira"] = {"accepted": d.accepted, "summary": d.summary(),
                              "plan": d.plan.describe() if d.accepted else None}
            if d.accepted:
                engine.set_decode_plan(d.plan)
                say("decode routed through RegionPlan:", d.plan.describe())

        say(f"arch={args.arch} int8_kv={args.int8_kv} paged={args.paged} "
            f"spec_k={args.spec} aira={args.aira} backend={engine.attention_backend}"
            + (f" mesh={args.mesh}" if mesh is not None else ""))
        if args.open_loop > 0:
            _open_loop(args, cfg, engine, say, record)
        else:
            out = engine.generate(prompts, args.tokens)
            say(f"generated {tuple(out.shape)} tokens; first row: {out[0][:12].tolist()}")
            say(f"decode latency: {engine.stats.summary()}")
            record["streams"] = [np.asarray(row) for row in out.numpy()]
        summary = engine.stats.serving_summary()
        record["summary"] = summary
        if args.spec:
            # absent when no verify round ever ran
            s = summary.get("speculative")
            if s is not None:
                say(f"speculative: K={s['k']} acceptance={s['acceptance_rate']:.2f} "
                    f"({s['accepted']}/{s['proposed']} draft tokens; "
                    f"draft p50={s['p50_draft_ms']:.2f}ms verify p50={s['p50_verify_ms']:.2f}ms)")
        after = kernel_launches()
        record["launches"] = {k: after[k] - before[k] for k in after}
        if dev.type == "cuda":
            n = record["launches"]
            say(f"kernels: paged_decode_attention {n['paged']} (int8 {n['paged_int8']}, "
                f"partials {n['partials']}), flash_attention {n['flash']}, "
                f"ssd_scan {n['ssd']} launches")
        if args.trace and rank == 0:
            counts = validate_chrome_trace(get_telemetry().tracer.export(args.trace))
            record["trace"] = counts
            say(f"trace: {counts['events']} events ({counts['spans']} spans, "
                f"{counts['async_spans']} request spans) → {args.trace}")
    finally:
        if args.trace:
            configure(enabled=False)
    record["lines"] = lines
    return record


def _open_loop(args, cfg, engine, say, record) -> None:
    reqs = open_loop_requests(args, cfg)
    controller = None
    if args.online:
        from repro_torch.serve import OnlineAdviser

        # capture and price the candidate grid: every live switch the
        # controller makes replays a captured step
        ks = (0, args.spec) if args.spec else (0, 2, 4)
        primed = engine.prime(args.batch, ks=ks)
        controller = OnlineAdviser(ks=primed["ks"], decision_interval=4, window=8, dwell=1)
        controller.seed_costs(primed)
        cells = primed["cells"][engine.attention_backend]
        record["primed"] = cells
        say("primed: " + " ".join(f"K={k}:{ms:.2f}ms" for k, ms in sorted(cells.items())))
    outputs = engine.serve(reqs, max_batch=args.batch, chunk_size=args.chunk,
                           controller=controller)
    for r in reqs:
        say(f"  req {r.rid}: arrive={r.arrival_time*1e3:7.1f}ms "
            f"prompt={len(np.asarray(r.prompt)):2d} tokens={len(r.tokens):2d} "
            f"ttft={r.ttft_ms:7.1f}ms e2e={r.e2e_ms:7.1f}ms")
    assert all(len(outputs[r.rid]) == len(r.tokens) for r in reqs)
    say(f"open-loop serving: {engine.stats.summary()}")
    record["streams"] = [np.asarray(outputs[r.rid]) for r in reqs]
    record["requests"] = [{"rid": r.rid, "arrival_ms": r.arrival_time * 1e3,
                           "prompt": len(np.asarray(r.prompt)), "tokens": len(r.tokens),
                           "ttft_ms": r.ttft_ms, "e2e_ms": r.e2e_ms} for r in reqs]
    if controller is not None:
        info = engine.stats.serving_summary().get("controller", {})
        say(f"online adviser: {info.get('decisions', 0)} decisions, "
            f"{info.get('switches', 0)} switches, final K={info.get('k')} "
            f"backend={info.get('backend')}")
        record["audit"] = controller.audit_trail()
        for d in record["audit"]:
            say(f"  step {d['step']:>3}: k={d['k']}" + (" [probe]" if d["probe"] else "")
                + f" — {d['reason']}")


def _serve_mesh(args, dev, cfg, params, prompts) -> dict:
    """``--mesh N``: N gloo rank processes, each serving the same requests
    on its shard; rank 0's record, once every rank's streams equal its."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.tree import map_tree

    if params is not None:  # the ranks take the weights through host memory
        params = map_tree(lambda t: t.detach().cpu(), params)
    with tempfile.TemporaryDirectory(prefix="serve_decode_mesh_") as out:
        run_ranks(_mesh_rank, args.mesh, args, str(dev), cfg, params, prompts, out,
                  store=os.path.join(out, "store"))
        records = []
        for r in range(args.mesh):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                records.append(pickle.load(f))
    first = records[0]
    for r, rec in enumerate(records[1:], 1):
        if (len(rec["streams"]) != len(first["streams"])
                or any(not np.array_equal(a, b) for a, b in zip(first["streams"], rec["streams"]))):
            raise SystemExit(f"--mesh {args.mesh}: rank {r}'s streams differ from rank 0's")
    first["rank_launches"] = [rec["launches"] for rec in records]
    write_record(args.record, first)
    return first


def _mesh_rank(rank, world, args, device, cfg, params, prompts, out):
    from repro_torch.launch.mesh import make_test_mesh

    dev = torch.device(device)
    mesh = make_test_mesh((world,), ("model",), device=dev)
    record = serve(args, dev, cfg=cfg, params=params, prompts=prompts, mesh=mesh, rank=rank)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(record, f)


if __name__ == "__main__":
    main()
