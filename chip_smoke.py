#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. environment — card name and power limit, torch / CUDA / nvcc versions;
2. build — the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
   ``build/``), with the build time;
3. kernels — each kernel against its plain PyTorch version on the card,
   float32 and bfloat16: the attention kernels at full-width smollm-135m
   shapes (the paged kernel at both layouts' shapes: the paged pool, and
   the slot cache's identity-table view), with the paged kernel's
   verify-equals-decode contract checked bitwise; the SSD scan kernel at
   full-width mamba2-370m shapes (H=32, hd=64, N=128), y and final state,
   at S = 1024, 1000 and 1021 (B=1: a multiple of the chunk, a length the
   plain version chunks by 125, a prime it chunks by 1) and S = 256 (B=4);
   the paged kernel's int8 mode (int8 pools, bf16 scales) at zamba2-2.7b's
   slot shape (H=KV=32, hd=80, 256-key identity-table blocks) and on a
   paged pool at g = 1 and g = 3, at hd 72 and on pools one byte off a
   16-byte boundary (the kernel's element loads, each launching it once);
   each paged and SSD line prints its launch plan; the flash kernel at smollm's serving
   prefill (B=1, S=1024, H=9); the flash and SSD kernels at zamba2's
   prefill shapes (hd=80, g=1; H=80, hd=64, N=64); kernel, plain and
   library times (each two ways: the median of single synchronised calls,
   and device time a call over back-to-back calls) beside the least time
   the card could take, and the path each flash call took (bf16 hd 64/80:
   wgmma, checked and timed beside the CUDA-core kernel too; else CUDA
   cores); bf16 flash is held to TOL and, per query, to 2e-2 of the
   query's largest output; then the bf16 inputs the tensor-core paths
   cannot take, on the CUDA-core kernels: flash at head sizes 40 and 72
   (causal with a q_offset, and non-causal) and on q/k/v 2 bytes off a
   16-byte boundary, relic_matmul at K or N off a multiple of 8 and on
   misaligned operands, each launching its kernel once and printing its
   path; 3b: the input ranges the kernels took no longer before — the
   dense decode and paged kernels at hd 1024 (float32 and bf16; the paged
   kernel's verify equal to its decode bitwise there), the paged kernel's
   int8 mode at hd 2560, the SSD scan at N = 256, hd = 72 and chunk = 256
   on S = 1024 — each launching its kernel once and held to its plain
   version with its phase's tolerance, timed beside its bound;
4. entry points — every entry point of ``repro_torch.kernels.ops`` called
   once with mode "auto" on bf16 CUDA tensors at full-width shapes, from
   launch counts of 0: each must launch its own kernel once and agree with
   its plain mode; then the kernels and modes that arrive with the entry
   points against their plain versions, float32 and bf16: relic_matmul at
   smollm-135m's (M=1024 and 1000, K=576, N=1536) and zamba2-2.7b's
   (K=2560, N=10240) prefill projections, relic_gemv at 1 and 8 rows over
   (K, N) = (576, 1536), (576, 49152), (2560, 10240), (10240, 2560),
   decode_attention over smollm's and zamba2's slot caches with cache_len
   0, 1, 2047, 2048 and random, and at head size 256 (32- or 64-key tiles)
   held to TOL (each GEMV, decode and paged line prints its launch plan),
   the paged kernel's partials mode (smollm's
   pool at T = 1 and 4, zamba2's int8 slot view; an unowned row exactly
   (-1e30, 0, 0); complementary ownerships combine to the unsplit
   kernel), the flash kernel's non-causal mode at B=2, S=512; with times,
   each matmul's path, and the bf16 matmul at both tile widths;
5. serving — every model step runs through the engine's compiled step
   families (``Model.jit_step``: a CUDA graph captured per step shape and
   replayed; the launch counts below read the same under replay, a replay
   adding its graph's launches). smollm-135m at full width (bf16, seeded
   random weights) served through ``ServingEngine.serve()``: an open-loop
   workload and a
   shared-prefix workload on the paged layout, a small one on the slot
   layout; every decode step must launch the paged kernel once per layer
   and every prefill the flash kernel once per layer; then mamba2-370m at
   full width on the slot layout, every prefill launching the SSD kernel
   once per layer; then zamba2-2.7b at full width on the slot layout
   (int8 KV cache), every prefill launching the SSD kernel once per layer
   and the flash kernel once per attention site, every decode step the
   int8 paged kernel once per site and no float-pool paged kernel; all
   logits must be finite and every request must finish with tokens; no
   serving run may launch a kernel or mode of phase 4's that serving does
   not use;
6. parity — float32 workloads of the three models served through the
   kernels and through the plain reference backend must give the same
   greedy tokens (a difference counts as a tie only where the reference's
   top-2 logit margin is below the stated tolerance); then smollm-135m and
   zamba2-2.7b in bf16 at full width, whose prefill runs the wgmma flash
   kernel: the prefill's and the first decode step's logits through the
   kernels, each row no further from the float32 plain path's (same
   weights, upcast) than ``E2E_BF16_RATIO`` times the bf16 plain path's;
7. the adviser (in a process of its own, started after phase 6 and
   joined after phase 12: host-bound work) — ``advise_suite(hw=CPU_HW)`` over the ten benchmarks with
   their data on the card: decisions equal to
   ``tests/golden_aira_decisions.json`` and geomeans equal to
   ``BENCH_aira.json``'s within 1e-6; each accepted plan's ``execute``
   against the serial per-item loop on the first 64 items and against
   ``vmap`` of the per-item function on all (exact for integers, 1e-5
   relative for float sums), the loop and the plan timed (device
   vectorisation, not SMT: the gains are the overlap model's for the
   paper's i7-12700 core); then
   smollm-135m at full width on the slot layout served through a decode
   plan (``decode_region`` + ``Aira`` + ``set_decode_plan``), float32 at 7
   rows (a padded last chunk) and bf16 at 8: float32 tokens equal to the
   no-plan path's (or ties), the paged
   kernel launched exactly layers x chunks per stream x decode steps,
   served through the captured plan family (one entry, no capture after
   the first serve), then eagerly (``step_graph.disabled()``): the plan
   walls, graphed and eager, beside the no-plan path's;
   bf16 logits of one plan step within ``E2E_BF16_RATIO`` of the plain
   path's distance from float32;
8. speculation, chunked prefill, preemption — full-width smollm-135m in
   float32, ``max_seq`` 2048, 4 rows: K = 4 with the n-gram drafter and
   with a one-layer full-width draft model on both layouts (tokens equal
   to plain decoding's, ties aside; every verify exactly 30 paged
   launches at T = 5, every draft decode one at T = 1 over the draft's
   2053-long slot view, nothing else launched), the target drafting for
   itself (acceptance 1.0, or every rejection at a tie); ``chunk_size``
   256 over 128-1024-token prompts on both layouts after ``prime()``
   (tokens equal to monolithic prefill's, ties aside; every chunk and
   decode 30 paged launches, no flash launch, every chunk width a primed
   one, no step graph captured after ``prime()``); ``make_slo_requests``
   on a 4-row pool of 100 blocks driven on a
   step clock (preemptions > 0, streams equal to an 8-row pool's that
   preempts nothing, ties aside); then in bf16 one n-gram run and one
   chunked run (finite logits, every request finished); the host/device
   split of a spec round's verify and draft halves and of a 256-token
   chunk; and the paged kernel against its plain version at the verify
   shape (T = 5: paged pool, and slot view bitwise equal to five decodes),
   the chunk shape (T = 256 over 256-key identity blocks, at 0, 768 and
   1792) and the draft view (BS = 1, MB = 2053), each printing its plan.
9. the online adviser and the flight recorder — the paged kernel at the
   widths a live K gives it, held to its plain version: verify at T = 3
   and T = 9 on the smollm paged pool (each query bitwise equal to a
   decode) and a K = 8 model drafter's 2057-long slot view (187-key
   blocks, 11 a row); full-width smollm-135m in float32 on the paged
   layout, 8 rows, ``max_seq`` 2048: the plain K = 0 stream, then a seeded
   scripted controller over ks (0, 2, 4, 8) (n-gram), the scripted 0↔4
   flips with a one-layer model drafter built for K = 8 (the catch-up),
   static K = 4, ``PinnedController(4)`` (bitwise the static run) and an
   ``OnlineAdviser`` seeded from ``engine.prime()``, every stream equal to
   the plain one but for ties and every run's launches exact (30 paged a
   decode or verify step at T = 1, 3, 5 or 9, one a draft decode; 30
   flash a prefill, one a draft prefill), and every run after the prime
   capturing nothing (``engine.retraces`` 0); in bf16, ``engine.prime()``
   over K ∈ {0, 2, 4, 8} and both backends (the plain one labelled),
   ``make_drift_requests`` once to capture its shapes, then under
   telemetry at each static K and under an ``OnlineAdviser``, each with
   ``engine.retraces`` 0 (TPOT p50 by phase, decisions, switches, probes, the
   first decisions; the decisions' keys those of ``drift_decisions.json``),
   its trace exported to ``build/phase9_drift_trace.json`` and validated,
   step p50 with telemetry off and on, and one ``torch.profiler`` step of
   each kind whose ``serve.decode`` / ``serve.verify`` device range holds
   the step's 30 paged kernel launches (one graph replay on the host).
10. the compiled step families against eager — float32 at full width:
   each step family's replay (smollm's monolithic, prefix and chunk
   prefills, slot and paged decode and verify; mamba2's and zamba2's
   prefill and decode) against its eager call on the same state, max
   |Δlogit| held to the float32 kernel tolerance, then a step-clock serve
   of each model eager (``step_graph.disabled()``) and graphed: the same
   streams token for token; bf16 at full width: ``make_requests`` (8
   open-loop requests, 128-1024-token prompts, 32 new tokens, 8 rows) on
   smollm-135m paged with K = 4 speculation and ``chunk_size`` 256,
   mamba2-370m and zamba2-2.7b on slots, served once to capture its
   shapes, then eager and graphed: TTFT, TPOT and step p50/p99 side by
   side, the captures and the graph pool's bytes (the primed smollm run
   capturing nothing); the host time of one eager smollm decode step by
   op (CPU-side ``torch.profiler``); each model's decode step at 8 rows
   and 1024-token prefill, eager and graphed: wall, device busy and the
   device's idle share.
11. the int8 paged pool and the three dense configs — the paged kernel's
   int8 mode on stablelm-3b's pool (H = KV = 32, hd 80, BS 16) at T = 1,
   T = 5 (each query bitwise a decode) and a 256-query chunk over a
   256-key identity view, the float modes at phi3-medium-14b's (40 heads
   over 10) and internlm2-20b's (48 over 8) hd-128 pools at T = 1 and 5
   (bitwise), causal flash at each config's serving prefill (B = 1, S =
   1024; bf16 at hd 128 on wgmma, beside the CUDA-core kernel and SDPA)
   and non-causal flash at hd 128 (B = 2, S = 512, once through
   ``kernels.ops`` first), float32 and bf16, each held to its plain
   version and timed beside its bound; float32 at full width, full depth
   for stablelm and depth 4 for the 14B and 20B models (whose float32
   plain path would not fit the card at full depth), served through the
   kernels and the plain backend on the paged layout with a shared-prefix
   pair (stablelm's int8 hit dequantized), graphed: the same greedy
   tokens, ties aside; bf16 prefill and first-decode logits within
   ``E2E_BF16_RATIO`` of the plain path's distance from float32, at the
   same depths; then
   each config in bf16 at full width and ``SERVE_DEPTH`` (8) layers on the
   paged layout (8
   rows, ``max_seq`` 2048, 12 open-loop requests of 128-1024 tokens, at
   most 32 new), plain and with K = 4 n-gram speculation (stablelm's with
   ``chunk_size`` 256 over a shared 512-token prefix), served once to
   capture and then primed: no capture (``engine.retraces`` 0), every
   decode or verify step the paged kernel once a layer (int8 mode only,
   for stablelm), every prefill flash once a layer, every chunk the paged
   kernel once a layer and no flash; TTFT, TPOT and step p50/p99, the
   peak memory after ``init`` and after serving, and a decode step at 8
   rows and a 1024-token prefill eager and graphed (wall, device busy,
   idle share).
12. the MoE, vlm and audio families — the paged kernel's float modes at
   g = 2 on granite-moe-1b-a400m's (16 heads over 8, hd 64, T = 1) and
   internvl2-2b's (hd 128, T = 1 and 5, bitwise) pools, its int8 mode on
   musicgen-large's (H = KV = 32, hd 64: T = 1, 5 and a 256-query chunk),
   causal flash at each config's serving prefill (internvl2's S = 256
   patch rows + 768 tokens), float32 and bf16, each held to its plain
   version and timed beside its bound; ``moe_block`` at granite's and
   dbrx-132b's widths, T = 8 and 1024: bf16 against float32 (the same
   routing) within ``E2E_BF16_RATIO`` of the plain version's distance,
   capacity, dropped share and device time by part; float32 kernel-versus-
   plain token parity on a step clock (granite on both layouts, internvl2
   with seeded patch embeddings plain and with K = 4, musicgen chunked at
   256 over a shared-prefix pair, dbrx at depth 2), graphed, ties read
   from the reference run's own margins, musicgen's int8 runs also
   teacher-forced onto the reference's tokens, the kernel run's logit
   distance held to ``INT8_WITNESS_RATIO`` times that of a plain run with
   every ``wo`` one ulp up; bf16 against float32 (a MoE against
   float32 on each path's own routing); each config served in bf16 at full
   width and ``SERVE_DEPTH`` layers (dbrx at depth 4: 14.3 B parameters),
   plain and, where the family
   speculates, with K = 4 (musicgen's chunked over a shared 512-token
   prefix), captured then primed: no capture, exact launches, the peak
   memory, and the decode step and prefill eager and graphed. Each phase
   prints the time it ended at.
13. sharded paged serving — first, in this process, the paged kernel on a
   head split's rank: smollm-135m's (9 heads over 3, tp = 3) and
   internlm2-20b's (48 over 8, tp = 4) pools at B = 8 and 32, T = 1 and 5,
   float32 and bf16, every rank's launch over its local heads bitwise
   equal to those heads of the single-device launch (the plan repair:
   ``plan_kv_heads``), the local launch and the partials mode at
   internlm2's seq-2 shard timed beside their bounds; then 6 gloo rank
   processes (``launch/mesh.py::run_ranks``, a file store under
   ``build/phase13``) share the card: which collectives gloo runs on CUDA
   tensors; smollm-135m in float32 at full depth on tp = 3, seq = 2 and
   (3, 2), internlm2-20b in float32 at depth 2 on tp = 2, tp = 4, seq = 2
   and (2, 2) — one-step decode and verify logits against the single-device
   kernel path (max |dlogit|, bitwise where it is; seq splits within 1e-4),
   served streams equal but for ties (``count_ties``), the sharded decode
   step's p50 wall against the graphed single-device one and its time
   inside collectives; internlm2-20b in bf16 at depth 4 (plain and K = 4)
   and stablelm-3b's int8 pool at full depth (K = 4, chunk 256 over a
   shared 512-token prefix) on their meshes, each sharded decode within
   ``E2E_BF16_RATIO`` of the bf16 plain path's distance from float32;
   every serve's launches exact (a sharded decode or verify step one paged
   launch a layer on a head split, one partials launch a layer on a seq
   split; a chunk one paged launch a layer); granite-moe-1b-a400m's
   ``moe_block`` on ("data", "model") = (2, 2), its three paths against
   their references; each rank's peak memory, collective calls, time and
   host staging. Phases 5–12 never call the partials mode.
14. training (``repro_torch.train``, ``ckpt``, ``data``,
   ``parallel/compression.py``, ``parallel/pipeline.py``) — 14a:
   smollm-135m at full depth and width in bf16 through ``Trainer``, 20
   steps of B = 8, S = 1024, accum 2, remat "dots", a checkpoint every 5
   steps, an induced failure at step 7 and the resume from step 5 held
   bitwise to an uninterrupted run (the two runs in two processes at
   once, each step a replay of the trainer's captured step after the
   first, one capture in all) under deterministic algorithms
   (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts; an op without a
   deterministic implementation is named and the max |Δ| printed instead);
   the loss falls; step wall p50/p99, tokens/s, peak memory, graph pool
   bytes and the checkpoint's save time; then, alone on the card, the
   captured step under each remat mode (its first call, with the capture,
   and replays) and a profiled replay's device busy time and idle share;
   14b: one float32 step at full width and depth 2 on CUDA and on the CPU
   (loss, grad_norm, every gradient leaf, the stepped parameters); 14c: two
   bf16 steps of mamba2, zamba2 (one attention group), granite, internvl2
   and musicgen at full width (depth 2) through the captured step (the
   first eager, the second a replay), the second step's parameters equal
   to two eager steps'; no kernel launches in 14a-14c
   (training runs the reference route; the kernels refuse autograd); 14d:
   the trained weights served (4 requests, paged, graphed) with exact
   paged and flash launch counts, their prefill and first-decode logits
   held to the plain route by ``E2E_BF16_RATIO``; 14e: 2 gloo ranks on the
   card, the data-parallel step against the single-device one,
   ``compressed_psum`` and the 2-stage pipeline.
15. the profiler (``repro_torch.core.profile_step``) — smollm-135m at
   full width in bf16: the paged decode step (kernel backend, 8 rows,
   block size 16, ``max_seq`` 2048), a 1024-token prefill (kernel
   backend) and phase 14a's train step (B = 8, S = 1024, accum 2, remat
   "dots") counted on meta arguments (nothing allocated or run; the
   kernels charged at their tables' reach) and then once eagerly on real
   tensors under the counter (the kernels charged by these lengths):
   FLOPs, bytes, collective bytes, the three roofline terms on
   ``H100_HW``, the dominant one, the top five op classes and the memory
   estimate of each, beside the eager call's peak allocation; the aten
   FLOPs equal on both, the paged operator 30 times a decode step and the
   flash operator 30 times a prefill, each with bytes; then each step
   graphed (the step families, the trainer's captured step): wall and
   device busy beside the counted bound (the roofline share), the train
   step's top op classes beside the profiler's top device ops; a CUDA
   graph replay under the counter raises.
16. training split over "model" (``Model(cfg, mesh=mesh)``, PR 28) — 4
   gloo rank processes on the card (``p16_rank``, started beside phases 14
   and 15), each case at full width, depth 2 (phi3-medium-14b depth 1: its
   float32 single-device step peaks at 41.5 GB), B = 4, S = 256:
   smollm-135m on ("data", "model") = (1, 3) over ranks 0-2 (every dim
   divides) and (2, 2) (9 heads on 2: ``seq_sp``, the kv heads whole),
   granite-moe-1b-a400m on (2, 2) (16 of 32 experts a rank, capacity
   factor 4: nothing drops), mamba2-370m on (2, 2) (16 of 32 SSM heads a
   rank), phi3-medium-14b on (2, 2) (FSDP, accum 2) plain and under
   ZeRO-2; each float32 split step against the single-device one (run one
   rank at a time, each keeping its shards of the result; a MoE's with the
   split's per-shard semantics, its ``ce`` against the plain one): loss
   and ``grad_norm`` within 1e-5 relative, every gradient leaf within
   1e-4 of its largest magnitude, the stepped parameters within 5e-2,
   every stored parameter and moment shaped as its spec's shard, fewer
   bytes held a rank than a data-parallel rank's; peak memory a rank, the
   float32 and bf16 split steps' walls, collective calls / ms / bytes by
   op; ZeRO-2 fewer all-gathers a step than the plain FSDP step; 16e: a
   smollm-135m step on (2, 2) saved, restored bitwise onto (1, 3) and onto
   one device, the next step against the uninterrupted one.

17. prefill and slot decode split over "model" (``Model(cfg, mesh=mesh)``'s
   ``prefill`` and ``decode_step`` on a rank's shards, PR 29) and the dry
   run. 17a: 4 gloo rank processes on the card (``p17_rank``, started
   after phase 14, beside 15 and 16's last cases), each case at full
   width: smollm-135m on ("data", "model") = (1, 4)
   (``seq_sp`` prefill, the cache along ``kv_seq``), phi3-medium-14b at
   depth 1 on (1, 4) (the q heads split, the cache along ``kv_seq``),
   stablelm-3b at depth 2 on (1, 4) (heads and kv heads, the int8 cache),
   mamba2-370m at depth 2 on (1, 4) (SSM heads) and granite-moe-1b-a400m
   at depth 2 on (2, 2) (capacity factor 4: nothing drops); a prefill of B
   = 2, S = 512 (``max_seq`` 1024) and 8 decodes of fixed tokens: in
   float32 on the kernel route every rank's logits within 1e-5 (relative
   to the largest) of one device's kernel run and its cache shard within
   1e-5 of its slice (an int8 code one apart at a rounding tie, at fewer
   than 1e-3 of the codes, with the logits then within 1e-3); in bf16 the
   split's kernel route no further from float32 on the same weights than
   ``E2E_BF16_RATIO`` x one device's plain route (the root mean square of
   the rows' relative L2 distances over the 9 calls; a MoE's float32 runs
   routing on each bf16 run's own choices); exact launches:
   flash once an attention site a prefill, the SSD scan once an SSM layer,
   the paged kernel once a site a decode (its partials mode on a
   ``kv_seq`` split). 17b: ``launch/dryrun.py``'s ``run_cell`` at (32, 8)
   under a fake group of 256 in a process of its own (no card; started
   with the run) for smollm-135m x every shape, phi3-medium-14b x
   train_4k, dbrx-132b x decode_32k, zamba2-2.7b x long_500k and the
   legacy smollm decode (more bytes than without): a line a cell. 17c:
   rank 0 of (32, 8) on the card with real bf16 tensors under the fake
   group, smollm-135m x decode_32k and x train_4k: the collective calls
   counted on them (beside 17a's ranks) equal 17b's meta count; alone on
   the card, ``max_memory_allocated`` beside the dry run's peak estimate
   and device busy beside its bound. Then each kernel at the split path's
   shapes against its plain version, timed (``p17_*`` rows). Rehearse
   17a-b on the CPU from a guarded script: ``p17 =
   chip_smoke.Phase17("cpu", reduced=True); p17.start_ranks();
   p17.dry_records(); p17.finish("cpu")`` (``.reduced()`` configs keeping
   each split, ``P17_REHEARSAL``; the plain kernels counted as launches).
18. the entry points (``repro_torch.examples``), started after phase 4,
   beside phases 5-17 (phases 11-13 and 18b's zamba2-2.7b take turns on
   the card), and checked after phase 17. 18a: ``python -m
   repro_torch.examples.serve_decode`` as a user types it, in processes of
   its own (``P18_WORKERS`` at a time): ci.yml's invocations (``--backend
   interpret`` as ``kernel``), ``--int8-kv --paged`` and ``--mesh 2
   --paged --open-loop 4`` (2 gloo ranks sharing the card); each one's
   reference run (``--backend reference``, one device) in 18b's process:
   exit 0, streams equal the reference run's but for ties (``count_ties``
   on the rebuilt model), the paged (or int8 paged), flash (not in a
   chunked run) and (zamba2) SSD kernels launched in each kernel run,
   none in a reference run. 18b: ``serve_decode.main(argv, cfg=...)`` at full
   width in a process of its own (``p18_full``): smollm-135m fixed batch,
   ``--open-loop 8 --paged --spec 4 --chunk 256``, ``--aira``, ``--online
   --paged --open-loop 8`` and ``--mesh 3 --paged --open-loop 4`` (9 heads
   over 3), and zamba2-2.7b's fixed batch (under ``card_lock``): a float32
   copy against the plain route (ties only), launches exact where the
   formula is known (paged = layers x decode, verify and chunk steps,
   flash = attention sites x prefills, SSD = layers x prefills), then bf16
   with TTFT / TPOT / step p50 and p99. 18c: ``train_smollm --full`` (300
   steps, B = 8, S = 128) uninterrupted, and a second run killed once a
   checkpoint at step 150 or later is published, run again over the same
   ``--ckpt``: it resumes at the newest checkpoint and ends on the
   uninterrupted run's losses bit for bit; the loss falls; step p50 and
   tokens/s. 18d: ``quickstart`` prints ``restructured == serial: True``
   and the band the overlap model gives on the CPU;
   ``parallelize_with_aira`` its exact check and plan reuse. Rehearse on
   the CPU from a guarded script: ``chip_smoke.phase18("cpu",
   device="cpu", reduced=True)`` (~3.5 min: ``.reduced()`` configs,
   training 150 steps of B = 2, S = 16 killed past step 50).

``--phases 3,12`` runs the build and the listed phases only, for a short
development call (5 runs phases 5 and 6 together); with no argument every
phase runs. To rehearse phase 13 on the CPU at ``.reduced()`` width (the
kernel wrappers' plain versions counted as launches, head counts from
``P13_REHEARSAL``; ~40 s on 6 processes), from a script guarded by
``if __name__ == "__main__"``: ``chip_smoke.phase13("cpu", device="cpu",
reduced=True)``.

The two lines before the last are the JSON kernel table and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shlex
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.overlap_model import H100_HW  # noqa: E402  (the H100 SXM data sheet)
from repro_torch.kernels import work  # noqa: E402

HBM_BYTES_PER_S = H100_HW.hbm_bw
PEAK_FLOPS = {torch.bfloat16: H100_HW.peak_flops, torch.float32: H100_HW.vpu_flops}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # max |kernel - plain|
# SSD scan: max |kernel - plain| <= rel * max |plain| + abs, for y and the
# final state. float32: the kernel chunks by 128 with a ragged last chunk
# where the plain version shrinks the chunk to a divisor of S, so the sums
# round differently (exact arithmetic agrees); bfloat16: one rounding of y
# to bf16 (2^-8 relative) on either side, plus the float32 difference.
SSD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 0.0)}
# int8 mode: max |kernel - plain| over each batch row <= rel * max |plain|
# of that row + abs. float32: as TOL; bfloat16: 1e-2 plus one bf16 ulp
# (2^-7) of the row's largest output, since the rows over 1-2k random keys
# average to outputs of ~0.03, too small for TOL's absolute 2e-2.
INT8_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (1e-2 + 2**-7, 0.0)}
SPIN_CYCLES = 50_000_000  # ~30 ms at the H100's clock: covers enqueueing a timed run
LOGIT_TIE_TOL = 1e-3  # top-2 margin under which a float32 argmax flip is a tie
# an int8 cache's float32 kernel run, forced onto the plain run's tokens, may
# lie this many times further from the plain logits than the plain path with
# its wo one ulp up does (parity_serve_f32)
INT8_WITNESS_RATIO = 4.0
# bf16 end to end: each bf16 path's distance from the float32 plain path on
# the same (upcast) weights, ||logits - logits_f32|| / ||logits_f32|| per
# row. The kernel path (its attention and SSD kernels in place of their
# plain versions) must come no further from it than the bf16 plain path
# does, up to a quarter: both carry the same bf16 roundings of every
# other op, and a kernel that computed less accurately than its plain
# version would add its own error on top. (A fixed bound on the two bf16
# paths' difference measures the model instead: random-weight zamba2-2.7b
# amplifies bf16 rounding to ~10% of its logits on either path.)
E2E_BF16_RATIO = 1.25
# relic_matmul / relic_gemv: max |kernel - plain| <= rel * max |plain|.
# float32: the same float32 products summed in another order (~1e-6 of
# the largest output at K = 10240); bf16: both round the float32 sum to
# bf16 once, so they are at most one bf16 ulp apart, <= 2^-7 of |output|.
MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}
# partials mode: m within 1e-4 (scores of a few units, maxima of the same
# float32 scores), l and acc within 1e-4 of their largest value (float32
# sums in another order; the partials are float32 whatever q's type)
PARTIALS_TOL = 1e-4
PAGED_SRC = "src/repro_torch/kernels/csrc/paged_decode_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
MATMUL_SRC = "src/repro_torch/kernels/csrc/relic_matmul.cu"
DECODE_SRC = "src/repro_torch/kernels/csrc/decode_attention.cu"
PAGED_TPU = "src/repro/kernels/paged_decode_attention.py:214"
PAGED_INT8_TPU = "src/repro/kernels/paged_decode_attention.py:84"  # the int8 dequant
FLASH_TPU = "src/repro/kernels/flash_attention.py:103"
SSD_TPU = "src/repro/kernels/ssd_scan.py:86"
MATMUL_TPU = "src/repro/kernels/relic_matmul.py:61"
GEMV_TPU = "src/repro/kernels/relic_matmul.py:106"
DECODE_TPU = "src/repro/kernels/decode_attention.py:90"
PARTIALS_TPU = "src/repro/kernels/paged_decode_attention.py:111"  # the partials flush
NONCAUSAL_TPU = "src/repro/kernels/flash_attention.py:38"  # causal=False
# the kernels and modes that only the entry points run (never serving); the
# partials mode serves on a kv-sequence split only (phase 13), so no phase
# of one device launches it either (``SINGLE_DEVICE_IDLE``)
ENTRY_ONLY = ("relic_matmul", "relic_gemv", "decode", "flash_noncausal")
SINGLE_DEVICE_IDLE = ENTRY_ONLY + ("partials",)
# the input ranges phase 3b holds (no model of the repo reaches them)
WIDE = ("decode_wide", "paged_wide", "paged_int8_wide", "ssd_wide")
# phase 8's kernel rows → its launch counts at their shapes
PHASE8 = {"paged_verify": "verify", "paged_chunk": "chunk", "paged_draft": "draft"}
PHASE9 = {"paged_verify3": "verify3", "paged_verify9": "verify9", "paged_draft2057": "draft"}


def require(ok, msg: str) -> None:
    """A failed check ends the run (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# the memory-heavy work of the processes that share the card: the phi3
# cases of phases 16 and 17 (a rank group's float32 steps at 10-15 GiB a
# rank) and phase 14's remat and family steps (up to 23 GiB) take turns, so
# their peaks never meet (they did once, when the host ran slower, and the
# card ran out of memory)
HEAVY = ("phi3-medium-14b",)


@contextlib.contextmanager
def card_lock(what: str, rank: int = 0, barrier=None):
    """Hold the card's lock (an exclusive ``flock`` on ``build/card.lock``)
    for ``what``: taken by ``rank`` 0 only, the group's ``barrier`` (each
    rank's ``torch.distributed.barrier``) before and after, so that a rank
    group holds it as one; logs a wait longer than a second."""
    import fcntl

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    f = open(os.path.join(ROOT, "build", "card.lock"), "a+") if rank == 0 else None
    try:
        if f is not None:
            t0 = time.perf_counter()
            fcntl.flock(f, fcntl.LOCK_EX)
            if time.perf_counter() - t0 > 1.0:
                log(f"{what}: waited {time.perf_counter() - t0:.1f} s for the card")
        if barrier is not None:
            barrier()
        yield
        if barrier is not None:
            barrier()
    finally:
        if f is not None:
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> tuple[float, float]:
    """(per-call ms, device ms) of one call of ``fn``. Per call: the median
    of CUDA-event pairs around single calls, each synchronised, so it
    carries the host's launch gap (tens of microseconds a call from
    Python). Device: events around ``iters`` calls launched back to back,
    over ``iters``, behind a spin kernel that keeps the card busy while the
    host enqueues them, so the gaps do not enter it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return float(np.median(times)), a.elapsed_time(b) / iters


def fmt_ms(t) -> str:
    """A ``cuda_ms`` pair as "per-call (device device)"."""
    return "not timed" if t is None else f"{t[0]:.4f} (device {t[1]:.4f})"


def kernel_row(err, ms, plain, bms, by, lib=None) -> dict:
    """A kernel's entry of the JSON table: ``ms``, ``plain_ms`` and
    ``library_ms`` per call, with their device times beside them."""
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by)
    for key, t in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
        row[key] = None if t is None else t[0]
        row[key.replace("ms", "device_ms")] = None if t is None else t[1]
    return row


def bound(w, dtype):
    """(least ms the card could take, "bytes" or "operations") for the
    ``kernels/work.py`` work ``w``: each input read once and each output
    written once at the memory rate, against the operations at the peak
    rate for the type."""
    t_bytes, t_ops = w.bytes / HBM_BYTES_PER_S, w.flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def int8_pools(kp, vp):
    """Float pools quantized as the model's int8 cache stores them:
    (k int8, v int8, k_scale bf16, v_scale bf16)."""
    from repro_torch.models.attention import quantize_kv

    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    return kq, vq, ks, vs


def paged_case(dtype, T, seed=0, B=8, H=9, KV=3, hd=64, BS=16, MB=128, int8=False):
    """Inputs of the paged kernel: q, k/v pools, tables, lengths, then
    (k_scale, v_scale) for int8 pools or (None, None)."""
    g = torch.Generator().manual_seed(seed)
    NB = B * MB + 1  # the last block is the null block
    null = NB - 1
    lengths = torch.tensor([0, 15, 16, 2032] + torch.randint(1, 2040, (B - 4,), generator=g).tolist())
    lengths = lengths.clamp(max=MB * BS - T).to(torch.int32)
    tables = torch.full((B, MB), null, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g).to(torch.int32)
    used = 0
    for b in range(B):
        n = min(MB, -(-(int(lengths[b]) + T) // BS))
        tables[b, :n] = perm[used : used + n]
        used += n
    tables[1, 0] = null  # a null block inside a live row's window
    q = torch.randn(B, T, H, hd, generator=g)
    kp = torch.randn(NB, BS, KV, hd, generator=g)
    vp = torch.randn(NB, BS, KV, hd, generator=g)
    dev = torch.device("cuda")
    q, kp, vp = (t.to(dev, dtype) for t in (q, kp, vp))
    scales = (None, None)
    if int8:
        kp, vp, *scales = int8_pools(kp.float(), vp.float())
    return (q, kp, vp, tables.to(dev), lengths.to(dev)) + tuple(scales)


def slot_case(dtype, seed=0, B=4, Smax=2048, H=9, KV=3, hd=64, lengths=None, int8=False, T=1):
    """The slot layout's input to the paged kernel (T queries a row),
    built as the model builds it: a dense cache [B, Smax, KV, hd] (and,
    for an int8 cache, its scales [B, Smax, KV]) viewed as a pool of
    ``_dense_block_size(Smax)``-key blocks (256 at Smax = 2048, MB = 8; 1
    at the draft model's prime 2053) with an identity table."""
    from repro_torch.models.attention import _dense_as_pool, _dense_block_size

    g = torch.Generator().manual_seed(seed)
    bs = _dense_block_size(Smax)
    dev = torch.device("cuda")
    q = torch.randn(B, T, H, hd, generator=g).to(dev, dtype)
    kc = torch.randn(B, Smax, KV, hd, generator=g).to(dev, dtype)
    vc = torch.randn(B, Smax, KV, hd, generator=g).to(dev, dtype)
    scales = (None, None)
    if int8:
        kc, vc, *scales = int8_pools(kc.float(), vc.float())
        scales = tuple(_dense_as_pool(s, bs) for s in scales)
    tables = torch.arange(B * (Smax // bs), dtype=torch.int32, device=dev).view(B, Smax // bs)
    if lengths is None:
        lengths = [0, bs - 1, Smax - 2, Smax - 1]
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, _dense_as_pool(kc, bs), _dense_as_pool(vc, bs), tables, lengths) + scales


def paged_plan_of(q, kp, tables):
    """The paged kernel's launch plan for these inputs, as its wrapper
    takes it (the fields a log line shows)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode_attention as pda

    B, T, H, hd = q.shape
    plan = pda.paged_plan(q.dtype, kp.dtype, B, T, H, kp.shape[2], hd, kp.shape[1],
                          tables.shape[1], _build.aligned16(kp))
    return {f: plan[f] for f in ("path", "rows", "splits", "tile", "stages", "grid")}


def ssd_plan_of(x, b, chunk=128):
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    B, S, H, hd = x.shape
    plan = ssd.ssd_plan(x.dtype, B, S, H, hd, b.shape[-1], chunk, _build.aligned16(x, b))
    return {f: plan[f] for f in ("path", "tensor_cores", "cluster", "chunks_per_block", "slice",
                                 "grid")}


def flash_case(dtype, Sq, Skv, seed=0, B=2, H=9, KV=3, hd=64):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g)
    k = torch.randn(B, Skv, KV, hd, generator=g)
    v = torch.randn(B, Skv, KV, hd, generator=g)
    return tuple(t.to("cuda", dtype) for t in (q, k, v))


def sdpa_ms(q, k, v, off, causal=True):
    """One PyTorch call computing the same function (the yardstick only)."""
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if causal:
        mask = (torch.arange(Sq, device="cuda")[:, None] + off) >= torch.arange(Skv, device="cuda")[None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))


def flash_check(out, ref, dtype, what):
    """Hold a flash output to its plain version: max |out - ref| <= TOL,
    and for bf16 also each query's output vector (batch row, position,
    head) within 2e-2 of that vector's largest |ref|, as phase 4 holds its
    bf16 rows: late queries average ~1000 keys to outputs of ~0.04, where
    TOL's absolute 2e-2 is half a value. Returns (max error, its log
    text)."""
    err = (out.float() - ref.float()).abs().max().item()
    require(err <= TOL[dtype] and torch.isfinite(out).all(),
            f"{what} disagrees with its plain version: {err}")
    text = f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}"
    if dtype == torch.bfloat16:
        _, worst = row_check(out.flatten(0, 2), ref.flatten(0, 2), 2e-2, 1e-6)
        require(worst <= 1.0, f"{what}: a query's output is {worst:.3f}x its per-query limit")
        text += f"; per query <= 2e-2*max|plain|: worst err/tol {worst:.3f}"
    return err, text + ")"


def cuda_core_flash(q, k, v, off, causal, path):
    """Where a call took the wgmma path: the same call on the CUDA-core
    kernel (the bf16 flash kernel before the wgmma one, still built for
    other head sizes), held to the same checks and timed alike, as a log
    suffix."""
    from repro_torch.kernels import flash_attention as fa

    if path != "wgmma":
        return ""
    B, Sq, H, hd = q.shape
    plan = dict(fa.flash_plan(q.dtype, B, Sq, H, k.shape[2], hd), path="cuda_cores")
    got = fa._launch_flash(q, k, v, off, causal, plan)
    torch.cuda.synchronize()
    ref = fa.plain_flash_attention(q, k, v, off, causal)
    _, text = flash_check(got, ref, q.dtype, "the CUDA-core flash kernel")
    t = cuda_ms(lambda: fa._launch_flash(q, k, v, off, causal, plan))
    return f" | cuda_cores: {text} ms={fmt_ms(t)}"


def check_kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        outs = {}
        for key, label, case in (
            ("decode", "paged layout B=8 T=1 H=9 KV=3 hd=64 BS=16 MB=128", lambda: paged_case(dtype, 1)),
            ("verify", "paged layout B=8 T=4 H=9 KV=3 hd=64 BS=16 MB=128", lambda: paged_case(dtype, 4)),
            ("slot", "slot view B=4 T=1 H=9 KV=3 hd=64 BS=256 MB=8", lambda: slot_case(dtype)),
        ):
            q, kp, vp, tables, lengths, _, _ = case()
            out = pda.paged_decode_attention(q, kp, vp, tables, lengths)
            torch.cuda.synchronize()
            ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths))
            plain = cuda_ms(lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lengths), iters=5)
            bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
            log(f"paged_decode_attention {dn} {label} lengths={lengths[:4].tolist()} "
                f"plan={paged_plan_of(q, kp, tables)}: "
                f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
                f"bound_ms={bms:.5f} ({by}) library_ms=null")
            require(err <= TOL[dtype], f"paged kernel ({label}) disagrees with its plain version: {err}")
            require(torch.isfinite(out).all(), f"paged kernel ({label}) output not finite")
            outs[key] = (q, kp, vp, tables, lengths, out)
            if key == "decode":
                rows[("paged", dtype)] = kernel_row(err, ms, plain, bms, by)
        # verify (T=4) equals decode (T=1) bitwise, query by query
        q, kp, vp, tables, lengths, out = outs["verify"]
        for t in range(4):
            dec = pda.paged_decode_attention(q[:, t : t + 1].contiguous(), kp, vp, tables, lengths + t)
            require(torch.equal(dec[:, 0], out[:, t]), f"verify != decode at query {t} ({dn})")
        log(f"paged_decode_attention {dn}: verify (T=4) equals decode bitwise")

        flash_shapes = [(2, Sq, Skv, off, 9, 3, 64) for Sq, Skv, off in (
            (1, 1, 0), (37, 37, 0), (512, 512, 0), (2048, 2048, 0), (64, 576, 512))]
        flash_shapes.append((1, 1024, 1024, 0, 9, 3, 64))  # smollm-135m's serving prefill
        flash_shapes.append((1, 1024, 1024, 0, 32, 32, 80))  # zamba2-2.7b's prefill
        for B, Sq, Skv, off, H, KV, hd in flash_shapes:
            q, k, v = flash_case(dtype, Sq, Skv, B=B, H=H, KV=KV, hd=hd)
            out = fa.flash_attention(q, k, v, off)
            torch.cuda.synchronize()
            ref = fa.plain_flash_attention(q, k, v, off)
            label = f"flash_attention {dn} B={B} Sq={Sq} Skv={Skv} q_offset={off} H={H} KV={KV} hd={hd}"
            err, text = flash_check(out, ref, dtype, label)
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, off))
            plain = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, off), iters=5)
            bms, by = bound(work.flash(q, k, off), dtype)
            lib = sdpa_ms(q, k, v, off)
            path = fa.flash_plan(dtype, B, Sq, H, KV, hd)["path"]
            log(f"{label} path={path}: {text} ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
                f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}"
                + cuda_core_flash(q, k, v, off, True, path))
            if (Sq, Skv, off) == (512, 512, 0):
                rows[("flash", dtype)] = kernel_row(err, ms, plain, bms, by, lib)
    return rows


def check_int8():
    """The paged kernel's int8 mode (int8 pools, bf16 per-vector scales)
    against its plain version, q in float32 and bf16: at zamba2-2.7b's
    slot shape (8 rows, max_seq 2048 as 256-key identity-table blocks,
    H = KV = 32, hd = 80) and on a paged pool (B=8, BS=16, MB=128, random
    tables) at g = 1 and g = 3, at hd 72 and on pools one byte off a
    16-byte boundary (element loads); each call must launch the kernel
    once."""
    from repro_torch.kernels import paged_decode_attention as pda

    g = torch.Generator().manual_seed(5)
    lens = [0, 255, 1024, 2047] + torch.randint(1, 2047, (4,), generator=g).tolist()
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for key, label, case in (
            ("slot", "zamba2 slot view B=8 T=1 H=32 KV=32 hd=80 BS=256 MB=8",
             lambda: slot_case(dtype, B=8, H=32, KV=32, hd=80, lengths=lens, int8=True)),
            ("g1", "paged layout B=8 T=1 H=32 KV=32 hd=80 BS=16 MB=128",
             lambda: paged_case(dtype, 1, H=32, KV=32, hd=80, int8=True)),
            ("g3", "paged layout B=8 T=1 H=9 KV=3 hd=64 BS=16 MB=128",
             lambda: paged_case(dtype, 1, int8=True)),
            ("hd72", "paged layout B=8 T=1 H=9 KV=3 hd=72 BS=16 MB=128 (element loads)",
             lambda: paged_case(dtype, 1, hd=72, int8=True)),
            ("skew", "paged layout B=8 T=1 H=9 KV=3 hd=64 BS=16 MB=128, pools 1 byte off 16",
             lambda: skewed_pools(paged_case(dtype, 1, int8=True))),
        ):
            args = case()
            q, kp, _, tables, lengths, _, _ = args
            before = pda.paged_decode_attention.launches_int8
            out = pda.paged_decode_attention(*args)
            torch.cuda.synchronize()
            require(pda.paged_decode_attention.launches_int8 == before + 1,
                    f"int8 paged kernel ({label}) did not launch once")
            plan = paged_plan_of(q, kp, tables)
            if key in ("hd72", "skew"):
                require(plan["path"] == "direct", f"int8 paged kernel ({label}): path {plan['path']}")
            ref = pda.plain_paged_decode_attention(*args)
            row_err = (out.float() - ref.float()).abs().flatten(1).amax(1)
            rel, absol = INT8_TOL[dtype]
            row_tol = rel * ref.float().abs().flatten(1).amax(1) + absol
            err = row_err.max().item()
            ms = cuda_ms(lambda: pda.paged_decode_attention(*args))
            plain = cuda_ms(lambda: pda.plain_paged_decode_attention(*args), iters=5)
            bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
            log(f"paged_decode_attention[int8] {dn} {label} lengths={lengths.tolist()} plan={plan}: "
                f"max_abs_err={err:.3e} (per row <= {rel:.3g}*max|plain|+{absol:.0e}; "
                f"worst err/tol {(row_err / row_tol).max().item():.3e}) ms={fmt_ms(ms)} "
                f"plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
            require(bool((row_err <= row_tol).all()),
                    f"int8 paged kernel ({label}, {dn}) disagrees with its plain version: "
                    f"per-row errors {row_err.tolist()} over limits {row_tol.tolist()}")
            require(torch.isfinite(out).all(), f"int8 paged kernel ({label}) output not finite")
            if key == "slot":
                rows[("paged_int8", dtype)] = kernel_row(err, ms, plain, bms, by)
    return rows


def skewed_pools(args):
    """Paged-kernel inputs whose pools (int8: one byte) start off a
    16-byte boundary: the kernel stages them by element loads."""
    q, kp, vp, *rest = args
    return (q, misaligned(kp), misaligned(vp), *rest)


def ssd_case(dtype, B, S, seed=0, H=32, hd=64, N=128):
    """SSD scan inputs built the way the model builds them: dt =
    softplus(. + dt_bias) with the init's dt_bias = -2, a = exp(dt * A)
    with the init's A = -1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, hd, generator=g)
    b = torch.randn(B, S, N, generator=g)
    c = torch.randn(B, S, N, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g) - 2.0)
    dev = torch.device("cuda")
    return (x.to(dev, dtype), torch.exp(-dt).to(dev), b.to(dev, dtype), c.to(dev, dtype),
            dt.to(dev))


def check_ssd():
    from repro_torch.kernels import ssd_scan as ssd

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        rel, absol = SSD_TOL[dtype]
        # mamba2-370m's shapes, then zamba2-2.7b's prefill (H=80, N=64)
        for B, S, H, N in ((1, 1024, 32, 128), (1, 1000, 32, 128), (1, 1021, 32, 128),
                           (4, 256, 32, 128), (1, 1024, 80, 64)):
            x, a, b, c, dt = ssd_case(dtype, B, S, H=H, N=N)
            y, st = ssd.ssd_scan(x, a, b, c, dt, 128)
            torch.cuda.synchronize()
            y_ref, st_ref = ssd.plain_ssd_scan(x, a, b, c, dt, 128)
            errs, max_err = [], {}
            for name, got, want in (("y", y, y_ref), ("state", st, st_ref)):
                err = (got.float() - want.float()).abs().max().item()
                tol = rel * want.float().abs().max().item() + absol
                require(torch.isfinite(got).all(), f"SSD kernel {name} not finite (B={B} S={S} H={H} {dn})")
                require(err <= tol, f"SSD kernel {name} disagrees with its plain version "
                                    f"(B={B} S={S} H={H} {dn}): {err} > {tol}")
                errs.append(f"{name} max_abs_err={err:.3e} (tol {tol:.2e})")
                max_err[name] = err
            ms = cuda_ms(lambda: ssd.ssd_scan(x, a, b, c, dt, 128))
            # the plain version of a prime S runs 1021 one-position chunks
            plain = cuda_ms(lambda: ssd.plain_ssd_scan(x, a, b, c, dt, 128), iters=5) if S != 1021 else None
            bms, by = bound(work.ssd(x, b), dtype)
            log(f"ssd_scan {dn} B={B} S={S} H={H} hd=64 N={N} chunk=128 plan={ssd_plan_of(x, b)}: "
                f"{', '.join(errs)} "
                f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
            if (B, S, H) == (1, 1024, 32):
                rows[("ssd", dtype)] = kernel_row(max_err["y"], ms, plain, bms, by)
    return rows


def misaligned(t):
    """A copy of ``t`` whose data starts one element (2 bytes in bf16) past
    a 16-byte boundary: TMA and 16-byte copies cannot take it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_repaired():
    """The bf16 inputs that the tensor-core paths cannot take, on the
    CUDA-core kernels, against their plain versions: flash at head sizes
    40 and 72 (causal with a q_offset, non-causal) and at hd 64 on q/k/v
    off a 16-byte boundary; relic_matmul with K or N off a multiple of 8,
    at M = K = N = 100, and on misaligned x and w. Each call must launch
    its kernel once, and each line prints the path its plan took."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import relic_matmul as rm

    bf = torch.bfloat16
    for hd, Sq, Skv, off, causal, skew in ((40, 64, 576, 512, True, False),
                                           (40, 512, 512, 0, False, False),
                                           (72, 64, 576, 512, True, False),
                                           (72, 512, 512, 0, False, False),
                                           (64, 512, 512, 0, True, True)):
        q, k, v = flash_case(bf, Sq, Skv, hd=hd)
        if skew:
            q, k, v = (misaligned(t) for t in (q, k, v))
        key = "launches" if causal else "launches_noncausal"
        before = getattr(fa.flash_attention, key)
        out = fa.flash_attention(q, k, v, off, causal)
        torch.cuda.synchronize()
        require(getattr(fa.flash_attention, key) == before + 1, "flash did not launch its kernel once")
        ref = fa.plain_flash_attention(q, k, v, off, causal)
        path = fa.flash_plan(bf, 2, Sq, 9, 3, hd, _build.aligned16(q, k, v))["path"]
        label = (f"flash_attention bf16 B=2 Sq={Sq} Skv={Skv} q_offset={off} H=9 KV=3 hd={hd} "
                 f"{'causal' if causal else 'non-causal'}{' misaligned' if skew else ''}")
        require(path == "cuda_cores", f"{label}: path {path}, not the CUDA-core kernel")
        err, text = flash_check(out, ref, bf, label)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, off, causal))
        plain = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, off, causal), iters=5)
        bms, by = bound(work.flash(q, k, off, causal), bf)
        log(f"{label} path={path}: {text} ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
            f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(sdpa_ms(q, k, v, off, causal))}")
    for M, K, N, blocks, skew in ((1024, 572, 1536, dict(bk=572), False),
                                  (1024, 576, 1532, dict(bk=576, bn=1532), False),
                                  (100, 100, 100, {}, False),
                                  (1024, 576, 1536, dict(bk=576), True)):
        x, w = matmul_case(bf, M, K, N)
        if skew:
            x, w = misaligned(x), misaligned(w)
        before = rm.relic_matmul.launches
        out = rm.relic_matmul(x, w, **blocks)
        torch.cuda.synchronize()
        require(rm.relic_matmul.launches == before + 1, "relic_matmul did not launch its kernel once")
        ref = rm.plain_relic_matmul(x, w)
        err = (out.float() - ref.float()).abs().max().item()
        lim = MATMUL_TOL[bf] * ref.float().abs().max().item()
        plan = rm.matmul_plan(bf, M, K, N, _build.aligned16(x, w))
        label = f"relic_matmul bf16 M={M} K={K} N={N} {blocks}{' misaligned' if skew else ''}"
        require(plan["path"] == "cuda_cores", f"{label}: path {plan['path']}, not the CUDA cores")
        require(err <= lim and torch.isfinite(out).all(),
                f"{label} disagrees with its plain version: {err} > {lim}")
        ms = cuda_ms(lambda: rm.relic_matmul(x, w, **blocks), iters=10)
        plain = cuda_ms(lambda: rm.plain_relic_matmul(x, w), iters=10)
        lib = cuda_ms(lambda: torch.matmul(x, w), iters=10)
        bms, by = bound(work.matmul(x, w), bf)
        log(f"{label} path={plan['path']} tile={plan['tile']}: max_abs_err={err:.3e} (tol {lim:.2e}) "
            f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}")


def check_wide():
    """The input ranges the kernels refused before (phase 3b): the dense
    decode kernel and the paged kernel at hd 1024 (float32: 256 16-byte
    chunks a row, more than a block's 128 threads, P.V loops them; bf16:
    128), the paged kernel's int8 mode at hd 2560 (160 chunks), and the SSD
    scan at N = 256, hd = 72 (a padded last column slice) and chunk = 256
    on S = 1024 (sub-chunks of at most 128, smaller where b and c of the
    wide state need it). Each is driven once from launch counts of 0 and
    must launch its own kernel once (the row's ``launches``, read from its
    counter); then it is
    held to its plain version with its phase's tolerance and timed beside
    its bound. The paged kernel's verify (T = 4) equals its decode bitwise
    at hd 1024."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ssd_scan as ssd

    launched = {}

    def once(key, call):
        torch.cuda.synchronize()
        reset_launches()
        out = call()
        torch.cuda.synchronize()
        n = read_launches()
        moved = {k: v for k, v in n.items() if v}
        require(moved == {key: 1}, f"{key}: launched {moved}, not its kernel once")
        launched[key] = n[key]
        return out

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # dense decode at hd 1024
        dq, dk, dv, dl = decode_case(dtype, hd=1024)
        out = once("decode", lambda: da.decode_attention(dq, dk, dv, dl))
        ref = da.plain_decode_attention(dq, dk, dv, dl)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: da.decode_attention(dq, dk, dv, dl))
        plain = cuda_ms(lambda: da.plain_decode_attention(dq, dk, dv, dl), iters=5)
        bms, by = bound(work.decode(dq, dk, dl), dtype)
        lib = sdpa_decode_ms(dq, dk, dv, dl)
        plan = da.decode_plan(dtype, 8, 9, 3, 2048, 1024)
        log(f"decode_attention {dn} B=8 Smax=2048 H=9 KV=3 hd=1024 plan="
            f"{ {f: plan[f] for f in ('path', 'rows', 'splits', 'tile', 'stages', 'grid')} }: "
            f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
            f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}")
        require(err <= TOL[dtype] and torch.isfinite(out).all(),
                f"decode kernel at hd 1024 ({dn}) disagrees with its plain version: {err}")
        rows[("decode_wide", dtype)] = {"launches": launched["decode"],
                                   **kernel_row(err, ms, plain, bms, by, lib)}
        # the paged kernel over float pools at hd 1024, decode then verify
        q, kp, vp, tables, lengths, _, _ = paged_case(dtype, 1, hd=1024)
        out = once("paged", lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths))
        ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths))
        plain = cuda_ms(lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lengths), iters=5)
        bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
        log(f"paged_decode_attention {dn} paged layout B=8 T=1 H=9 KV=3 hd=1024 BS=16 MB=128 "
            f"plan={paged_plan_of(q, kp, tables)}: max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) "
            f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
        require(err <= TOL[dtype] and torch.isfinite(out).all(),
                f"paged kernel at hd 1024 ({dn}) disagrees with its plain version: {err}")
        rows[("paged_wide", dtype)] = {"launches": launched["paged"],
                                   **kernel_row(err, ms, plain, bms, by)}
        q, kp, vp, tables, lengths, _, _ = paged_case(dtype, 4, hd=1024)
        out = pda.paged_decode_attention(q, kp, vp, tables, lengths)
        ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
        err = (out.float() - ref.float()).abs().max().item()
        require(err <= TOL[dtype], f"paged verify at hd 1024 ({dn}) disagrees: {err}")
        for t in range(4):
            dec = pda.paged_decode_attention(q[:, t : t + 1].contiguous(), kp, vp, tables, lengths + t)
            require(torch.equal(dec[:, 0], out[:, t]), f"verify != decode at hd 1024, query {t} ({dn})")
        log(f"paged_decode_attention {dn} hd=1024: verify (T=4, max_abs_err={err:.3e}) equals "
            f"decode bitwise")
        # the int8 mode at hd 2560
        args = paged_case(dtype, 1, hd=2560, int8=True)
        q, kp, _, tables, lengths, _, _ = args
        out = once("paged_int8", lambda: pda.paged_decode_attention(*args))
        ref = pda.plain_paged_decode_attention(*args)
        row_err = (out.float() - ref.float()).abs().flatten(1).amax(1)
        rel, absol = INT8_TOL[dtype]
        row_tol = rel * ref.float().abs().flatten(1).amax(1) + absol
        err = row_err.max().item()
        ms = cuda_ms(lambda: pda.paged_decode_attention(*args))
        plain = cuda_ms(lambda: pda.plain_paged_decode_attention(*args), iters=5)
        bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
        log(f"paged_decode_attention[int8] {dn} paged layout B=8 T=1 H=9 KV=3 hd=2560 BS=16 MB=128 "
            f"plan={paged_plan_of(q, kp, tables)}: max_abs_err={err:.3e} (per row <= "
            f"{rel:.3g}*max|plain|+{absol:.0e}; worst err/tol {(row_err / row_tol).max().item():.3e}) "
            f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
        require(bool((row_err <= row_tol).all()) and torch.isfinite(out).all(),
                f"int8 paged kernel at hd 2560 ({dn}) disagrees with its plain version")
        rows[("paged_int8_wide", dtype)] = {"launches": launched["paged_int8"],
                                   **kernel_row(err, ms, plain, bms, by)}
        # the SSD scan at N = 256, hd = 72, chunk = 256
        x, a, b, c, dt = ssd_case(dtype, 1, 1024, H=32, hd=72, N=256)
        y, st = once("ssd", lambda: ssd.ssd_scan(x, a, b, c, dt, 256))
        y_ref, st_ref = ssd.plain_ssd_scan(x, a, b, c, dt, 256)
        rel, absol = SSD_TOL[dtype]
        errs = {}
        for name, got, want in (("y", y, y_ref), ("state", st, st_ref)):
            errs[name] = (got.float() - want.float()).abs().max().item()
            tol = rel * want.float().abs().max().item() + absol
            require(torch.isfinite(got).all() and errs[name] <= tol,
                    f"SSD kernel {name} at N=256 hd=72 chunk=256 ({dn}) disagrees: {errs[name]} > {tol}")
        ms = cuda_ms(lambda: ssd.ssd_scan(x, a, b, c, dt, 256))
        plain = cuda_ms(lambda: ssd.plain_ssd_scan(x, a, b, c, dt, 256), iters=5)
        splan = ssd.ssd_plan(dtype, 1, 1024, 32, 72, 256, 256)
        bms, by = bound(work.ssd(x, b, splan["chunk"]), dtype)
        log(f"ssd_scan {dn} B=1 S=1024 H=32 hd=72 N=256 chunk=256 plan="
            f"{ {f: splan[f] for f in ('path', 'chunk', 'cluster', 'chunks_per_block', 'slice', 'grid')} }: "
            f"y max_abs_err={errs['y']:.3e}, state max_abs_err={errs['state']:.3e} "
            f"(<= {rel:g}*max|plain|+{absol:g}) ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
            f"bound_ms={bms:.5f} ({by}) library_ms=null")
        rows[("ssd_wide", dtype)] = {"launches": launched["ssd"],
                                     **kernel_row(errs["y"], ms, plain, bms, by)}
        del dk, dv, kp, vp, args, x
        torch.cuda.empty_cache()
    return rows


def op_host_us(card):
    """Host time of one paged kernel call at the slot view's decode shape
    (bf16 B=4 T=1 H=9 KV=3 hd=64 BS=256 MB=8, as smollm-135m's decode
    calls it): through the wrapper, as the models' eager decode calls it
    (``paged_decode_call``), and through the operator
    ``repro_torch::paged_decode_attention``, as a decode plan's vmap does.
    Each is the median over 7 runs of 200 back-to-back calls, timed on the
    host with no synchronisation inside a run."""
    from repro_torch.kernels import paged_decode_attention as pda

    args = slot_case(torch.bfloat16)[:5]
    us = {}
    for name, fn in (("wrapper", pda.paged_decode_attention), ("operator", pda.paged_attention_op)):
        require(torch.equal(fn(*args), pda.paged_decode_attention(*args)),
                f"paged kernel through the {name} differs")
        runs = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(*args)
            runs.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        us[name] = sorted(runs)[3]
    log(f"paged_decode_attention host us a call on {card} (bf16 slot view B=4 T=1 H=9 KV=3 "
        f"hd=64 BS=256 MB=8; median of 7 runs of 200 unsynchronised calls): wrapper "
        f"{us['wrapper']:.2f}, operator {us['operator']:.2f} (the dispatcher's "
        f"{us['operator'] - us['wrapper']:+.2f}; eager decode takes the wrapper)")


# ---------------------------------------------------------------------------
# phase 4: the kernel library's entry points


def row_check(out, ref, rel, absol):
    """(worst error, worst error over its limit): max |out - ref| over each
    leading-axis row against rel * max |ref| of the row + absol."""
    err = (out.float() - ref.float()).abs().flatten(1).amax(1)
    lim = rel * ref.float().abs().flatten(1).amax(1) + absol
    return err.max().item(), (err / lim.clamp(min=1e-30)).max().item()  # a zero row: 0 / 0 -> 0


def matmul_case(dtype, M, K, N, seed=0):
    """x [M,K] ~ N(0, 1) and w [K,N] ~ N(0, 1/K), as a projection's scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(K, N, generator=g) / K**0.5
    return x.to("cuda", dtype), w.to("cuda", dtype)


def decode_case(dtype, B=8, Smax=2048, H=9, KV=3, hd=64, seed=0):
    """A dense slot cache [B,Smax,KV,hd] with cache_len 0, 1, Smax - 1,
    Smax and B - 4 random lengths."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g)
    k = torch.randn(B, Smax, KV, hd, generator=g)
    v = torch.randn(B, Smax, KV, hd, generator=g)
    lens = [0, 1, Smax - 1, Smax] + torch.randint(2, Smax - 1, (B - 4,), generator=g).tolist()
    return (*(t.to("cuda", dtype) for t in (q, k, v)),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def sdpa_decode_ms(q, k, v, lens):
    """SDPA over the dense cache with a boolean length mask (the yardstick
    only; a row with no key gives NaN there)."""
    qt = q[:, :, None]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(k.shape[1], device="cuda")[None, :] < lens[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))


def sdpa_cached_ms(q, kp, vp, lengths):
    """SDPA over an identity-table view's contiguous cache (the slot cache
    or a batch-1 staging cache the pool view reshapes): T queries a row,
    query t attending keys < lengths + t + 1 through a boolean mask,
    ``enable_gqa`` (the yardstick only). Returns (its ``cuda_ms``, its max
    |difference| from the paged kernel's plain version)."""
    from repro_torch.kernels import paged_decode_attention as pda

    B, T = q.shape[:2]
    kc, vc = (t.reshape(B, -1, *t.shape[2:]) for t in (kp, vp))
    Smax = kc.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    lim = lengths.long()[:, None] + torch.arange(1, T + 1, device="cuda")[None, :]
    mask = (torch.arange(Smax, device="cuda")[None, None, :] < lim[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    tables = torch.arange(kp.shape[0], dtype=torch.int32, device="cuda").view(B, -1)
    ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
    diff = (call().transpose(1, 2).float() - ref.float()).abs().max().item()
    return cuda_ms(call), diff


def ownership(tables, seed, empty_row=2):
    """A random block ownership [B,MB] int32 in which one row owns nothing."""
    g = torch.Generator().manual_seed(seed)
    own = torch.randint(0, 2, tuple(tables.shape), generator=g, dtype=torch.int32)
    own[empty_row] = 0
    return own.to(tables.device)


def combine(parts):
    """Per-rank (m, l, acc) combined as the JAX package's
    ``distributed_softmax`` combines them: a rank whose m is the -1e30
    sentinel (no key) is scaled by 0."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = acc = 0.0
    for pm, pl, pacc in parts:
        sc = torch.where(pm <= -1e30, 0.0, torch.exp(pm - m))
        l, acc = l + pl * sc, acc + pacc * sc[..., None]
    return acc / torch.clamp(l, min=torch.finfo(torch.float32).tiny)[..., None]


def partials_err(got, want):
    """(max |dm| where the plain m is a real max, max |dl| / max l,
    max |dacc| / max |acc|); the sentinel rows must agree exactly."""
    (m, l, acc), (wm, wl, wacc) = got, want
    real = wm > -1e30
    require(torch.equal(m[~real], wm[~real]) and torch.equal(l[~real], wl[~real])
            and torch.equal(acc[~real], wacc[~real]), "partials: sentinel rows differ")
    dm = (m - wm)[real].abs().max().item() if real.any() else 0.0
    dl = ((l - wl).abs().max() / wl.abs().max().clamp(min=1e-30)).item()
    da = ((acc - wacc).abs().max() / wacc.abs().max().clamp(min=1e-30)).item()
    return dm, dl, da


def drive_entry_points():
    """This slice's main path: each entry point of ``repro_torch.kernels.ops``
    called once with mode "auto" on bf16 CUDA tensors at full-width shapes,
    with every launch count set to 0 just before and read just after. Each
    call must launch its own kernel once and nothing else; each output must
    be finite, of the entry point's shape, and agree with the same entry
    point's plain mode (or, for the kernel-only partials, the wrapper's
    plain version) on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ssd_scan as ssd

    bf = torch.bfloat16
    x, w = matmul_case(bf, 1024, 576, 1536)
    xd, _ = matmul_case(bf, 8, 576, 1536, seed=1)
    q, k, v = flash_case(bf, 512, 512)
    dq, dk, dv, dl = decode_case(bf)
    sx, sa, sb, sc, sdt = ssd_case(bf, 1, 1024)
    pq, pk, pv, pt, pl, _, _ = paged_case(bf, 1)
    own = ownership(pt, 1)
    calls = (  # (launch counter key, label, call in mode "auto", its plain version)
        ("relic_matmul", "matmul M=1024 K=576 N=1536 bk=576",
         lambda: ops.matmul(x, w, bk=576), lambda: ops.matmul(x, w, mode="ref")),
        ("relic_gemv", "gemv B=8 K=576 N=1536",
         lambda: ops.gemv(xd, w), lambda: ops.gemv(xd, w, mode="ref")),
        ("flash", "flash_attention causal B=2 S=512 H=9 KV=3 hd=64",
         lambda: ops.flash_attention(q, k, v), lambda: ops.flash_attention(q, k, v, mode="ref")),
        ("flash_noncausal", "flash_attention non-causal B=2 S=512 H=9 KV=3 hd=64",
         lambda: ops.flash_attention(q, k, v, causal=False),
         lambda: ops.flash_attention(q, k, v, causal=False, mode="ref")),
        ("decode", "decode_attention B=8 Smax=2048 H=9 KV=3 hd=64",
         lambda: ops.decode_attention(dq, dk, dv, dl),
         lambda: ops.decode_attention(dq, dk, dv, dl, mode="ref")),
        ("ssd", "ssd B=1 S=1024 H=32 hd=64 N=128",
         lambda: ops.ssd(sx, sa, sb, sc, sdt), lambda: ssd.plain_ssd_scan(sx, sa, sb, sc, sdt)[0]),
        ("paged", "paged_attention B=8 T=1 H=9 KV=3 hd=64 BS=16 MB=128",
         lambda: ops.paged_attention(pq, pk, pv, pt, pl),
         lambda: ops.paged_attention(pq, pk, pv, pt, pl, mode="ref")),
        ("partials", "paged_attention_partials, same pool, random ownership",
         lambda: ops.paged_attention_partials(pq, pk, pv, pt, pl, own),
         lambda: pda.plain_paged_decode_attention(pq, pk, pv, pt, pl, owned=own, partials=True)),
    )
    torch.cuda.synchronize()
    reset_launches()
    outs = {}
    for key, label, call, _ in calls:
        before = read_launches()
        outs[key] = call()
        after = read_launches()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(moved == {key: 1}, f"ops {label} (mode auto) launched {moved}, not its kernel once")
    torch.cuda.synchronize()
    n = read_launches()
    for key, label, _, plain in calls:
        got, want = outs[key], plain()
        if key == "partials":
            dm, dl, da = partials_err(got, want)
            ok = max(dm, dl, da) <= PARTIALS_TOL and all(torch.isfinite(t).all() for t in got)
            log(f"entry[{label}]: |dm| {dm:.2e}, |dl|/max l {dl:.2e}, |dacc|/max|acc| {da:.2e} "
                f"(tol {PARTIALS_TOL:g}); launches {n[key]}")
            require(ok, f"ops {label} disagrees with its plain version")
            continue
        # bf16 outputs: one bf16 rounding of each side apart (the SSD: the
        # float32 state difference of SSD_TOL besides)
        err, worst = row_check(got, want, 2e-2, 1e-6)
        log(f"entry[{label}]: out {tuple(got.shape)} {got.dtype}, max_abs_err={err:.3e} "
            f"(per row <= 2e-2*max|plain|; worst err/tol {worst:.3f}); launches {n[key]}")
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"ops {label}: {tuple(got.shape)} {got.dtype}, plain {tuple(want.shape)} {want.dtype}")
        require(torch.isfinite(got).all() and worst <= 1.0, f"ops {label} disagrees with its plain version")
    return n


def check_entry_kernels():
    """The kernels and modes that arrive with the entry points, against
    their plain versions on the card, float32 and bf16, at full width:
    relic_matmul at smollm-135m's and zamba2-2.7b's prefill projections;
    relic_gemv at 1 and 8 decode rows over smollm's MLP and LM head and
    zamba2's MLP weights; decode_attention over smollm's and zamba2's slot
    caches (cache_len 0, 1, 2047, 2048 and random); the paged kernel's
    partials mode on smollm's paged pool at T = 1 and 4 and zamba2's int8
    slot view, with an unowned row exactly (-1e30, 0, 0) and two
    complementary ownerships combining to the unsplit kernel's output;
    and the flash kernel's non-causal mode at B=2, S=512."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import relic_matmul as rm

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        tol = MATMUL_TOL[dtype]
        for M, K, N, blocks in ((1024, 576, 1536, dict(bk=576)), (1000, 576, 1536, dict(bm=8, bk=576)),
                                (1024, 2560, 10240, {})):
            x, w = matmul_case(dtype, M, K, N)
            out = rm.relic_matmul(x, w, **blocks)
            torch.cuda.synchronize()
            ref = rm.plain_relic_matmul(x, w)
            err = (out.float() - ref.float()).abs().max().item()
            lim = tol * ref.float().abs().max().item()
            ms = cuda_ms(lambda: rm.relic_matmul(x, w, **blocks), iters=10)
            plain = cuda_ms(lambda: rm.plain_relic_matmul(x, w), iters=10)
            lib = cuda_ms(lambda: torch.matmul(x, w), iters=10)
            bms, by = bound(work.matmul(x, w), dtype)
            plan = rm.matmul_plan(dtype, M, K, N)
            log(f"relic_matmul {dn} M={M} K={K} N={N} {blocks} path={plan['path']} "
                f"tile={plan['tile']}: max_abs_err={err:.3e} (tol {lim:.2e}) ms={fmt_ms(ms)} "
                f"plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}")
            require(err <= lim and torch.isfinite(out).all(),
                    f"relic_matmul disagrees with its plain version (M={M} K={K} N={N} {dn}): {err} > {lim}")
            if plan["path"] == "wgmma":  # both tile widths, each held to the same limit
                for tn in (64, 128):
                    p = dict(plan, tile=(128, tn, 64), grid=(-(-M // 128), -(-N // tn)), w_boxes=tn // 64)
                    got = rm._launch_matmul(x, w, p)
                    torch.cuda.synchronize()
                    e = (got.float() - ref.float()).abs().max().item()
                    t = cuda_ms(lambda: rm._launch_matmul(x, w, p), iters=10)
                    log(f"relic_matmul {dn} M={M} K={K} N={N} tile={p['tile']} grid={p['grid']}: "
                        f"max_abs_err={e:.3e} (tol {lim:.2e}) ms={fmt_ms(t)}")
                    require(e <= lim, f"relic_matmul tile width {tn} disagrees (M={M} K={K} N={N}): {e}")
            if (M, K, N) == (1024, 576, 1536):
                rows[("relic_matmul", dtype)] = kernel_row(err, ms, plain, bms, by, lib)
        for K, N, bk in ((576, 1536, 576), (576, 49152, 576), (2560, 10240, 512), (10240, 2560, 512)):
            for B in (1, 8):
                x, w = matmul_case(dtype, B, K, N, seed=B)
                out = rm.relic_gemv(x, w, bk=bk)
                torch.cuda.synchronize()
                ref = rm.plain_relic_gemv(x, w)
                err = (out.float() - ref.float()).abs().max().item()
                lim = tol * ref.float().abs().max().item()
                ms = cuda_ms(lambda: rm.relic_gemv(x, w, bk=bk))
                plain = cuda_ms(lambda: rm.plain_relic_gemv(x, w))
                lib = cuda_ms(lambda: torch.matmul(x, w))
                bms, by = bound(work.matmul(x, w), dtype)
                plan = rm.gemv_plan(dtype, B, K, N)
                plan = {f: plan[f] for f in ("path", "rows", "splits", "k_per_split", "stage_rows",
                                             "stages", "grid")}
                log(f"relic_gemv {dn} B={B} K={K} N={N} bk={bk} plan={plan}: "
                    f"max_abs_err={err:.3e} (tol {lim:.2e}) ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
                    f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}")
                require(err <= lim and torch.isfinite(out).all(),
                        f"relic_gemv disagrees with its plain version (B={B} K={K} N={N} {dn}): {err} > {lim}")
                if (B, K, N) == (8, 576, 49152):
                    rows[("relic_gemv", dtype)] = kernel_row(err, ms, plain, bms, by, lib)

        rel, absol = INT8_TOL[dtype]  # rows of ~0.03 outputs, as for the int8 mode
        for label, case in (("smollm slot cache B=8 Smax=2048 H=9 KV=3 hd=64", dict()),
                            ("zamba2 slot cache B=8 Smax=2048 H=KV=32 hd=80", dict(H=32, KV=32, hd=80))):
            q, k, v, lens = decode_case(dtype, **case)
            out = da.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = da.plain_decode_attention(q, k, v, lens)
            err, worst = row_check(out, ref, rel, absol)
            ms = cuda_ms(lambda: da.decode_attention(q, k, v, lens))
            plain = cuda_ms(lambda: da.plain_decode_attention(q, k, v, lens), iters=5)
            lib = sdpa_decode_ms(q, k, v, lens)
            bms, by = bound(work.decode(q, k, lens), dtype)
            plan = da.decode_plan(dtype, q.shape[0], q.shape[1], k.shape[2], k.shape[1], q.shape[2])
            plan = {f: plan[f] for f in ("path", "rows", "splits", "tile", "stages", "grid")}
            log(f"decode_attention {dn} {label} lengths={lens.tolist()} "
                f"plan={plan}: max_abs_err={err:.3e} "
                f"(per row <= {rel:.3g}*max|plain|+{absol:.0e}; worst err/tol {worst:.3e}) ms={fmt_ms(ms)} "
                f"plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}")
            require(worst <= 1.0 and torch.isfinite(out).all(),
                    f"decode_attention disagrees with its plain version ({label}, {dn})")
            require(not out[0].any(), "decode_attention: the cache_len 0 row is not zeros")
            if "smollm" in label:
                rows[("decode", dtype)] = kernel_row(err, ms, plain, bms, by, lib)
        # a head wider than a ring of 64-key tiles fits: 32-key tiles in float32
        q, k, v, lens = decode_case(dtype, hd=256)
        before = da.decode_attention.launches
        out = da.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        require(da.decode_attention.launches == before + 1, "decode_attention hd 256 did not launch once")
        ref = da.plain_decode_attention(q, k, v, lens)
        err = (out.float() - ref.float()).abs().max().item()
        plan = da.decode_plan(dtype, 8, 9, 3, 2048, 256)
        plan = {f: plan[f] for f in ("path", "rows", "splits", "tile", "stages", "grid")}
        ms = cuda_ms(lambda: da.decode_attention(q, k, v, lens))
        bms, by = bound(work.decode(q, k, lens), dtype)
        log(f"decode_attention {dn} smollm slot cache at hd=256 B=8 Smax=2048 H=9 KV=3 "
            f"lengths={lens.tolist()} plan={plan}: max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) "
            f"ms={fmt_ms(ms)} plain_ms={fmt_ms(cuda_ms(lambda: da.plain_decode_attention(q, k, v, lens), iters=5))} "
            f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(sdpa_decode_ms(q, k, v, lens))}")
        require(err <= TOL[dtype] and torch.isfinite(out).all() and not out[0].any(),
                f"decode_attention at hd 256 disagrees with its plain version ({dn}): {err}")

        g = torch.Generator().manual_seed(5)
        slot_lens = [0, 255, 1024, 2047] + torch.randint(1, 2047, (4,), generator=g).tolist()
        for label, case in (
            ("paged layout B=8 T=1 H=9 KV=3 hd=64 BS=16 MB=128", lambda: paged_case(dtype, 1)),
            ("paged layout B=8 T=4 H=9 KV=3 hd=64 BS=16 MB=128", lambda: paged_case(dtype, 4)),
            ("zamba2 int8 slot view B=8 T=1 H=KV=32 hd=80 BS=256 MB=8",
             lambda: slot_case(dtype, B=8, H=32, KV=32, hd=80, lengths=slot_lens, int8=True)),
        ):
            args = case()
            q, kp, _, tables, lengths, _, _ = args
            own = ownership(tables, 2)
            got = pda.paged_decode_attention(*args, owned=own, partials=True)
            torch.cuda.synchronize()
            want = pda.plain_paged_decode_attention(*args, owned=own, partials=True)
            dm, dl, dacc = partials_err(got, want)
            empty = tuple(t[2] for t in got)
            require(bool((empty[0] == -1e30).all()) and not empty[1].any() and not empty[2].any(),
                    f"partials ({label}, {dn}): the row that owns nothing is not (-1e30, 0, 0)")
            require(max(dm, dl, dacc) <= PARTIALS_TOL and all(torch.isfinite(t).all() for t in got),
                    f"partials ({label}, {dn}) disagree with the plain version: {dm} {dl} {dacc}")
            # two ranks with complementary ownership combine to the unsplit kernel
            other = pda.paged_decode_attention(*args, owned=1 - own, partials=True)
            full = pda.paged_decode_attention(*args)
            c_err, c_worst = row_check(combine([got, other]).to(dtype), full, *(
                INT8_TOL[dtype] if dtype == torch.bfloat16 else (0.0, TOL[dtype])))
            require(c_worst <= 1.0, f"partials ({label}, {dn}): the combine differs from the kernel")
            ms = cuda_ms(lambda: pda.paged_decode_attention(*args, owned=own, partials=True))
            plain = cuda_ms(lambda: pda.plain_paged_decode_attention(*args, owned=own, partials=True),
                            iters=5)
            bms, by = bound(work.partials(q, kp, tables, lengths, own), dtype)
            log(f"paged_decode_attention[partials] {dn} {label} plan={paged_plan_of(q, kp, tables)}: "
                f"|dm| {dm:.2e}, |dl|/max l {dl:.2e}, "
                f"|dacc|/max|acc| {dacc:.2e} (tol {PARTIALS_TOL:g}); unowned row (-1e30, 0, 0); "
                f"complementary combine vs kernel max_abs_err={c_err:.3e} (worst err/tol {c_worst:.3f}) "
                f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
            if "T=1 H=9" in label:
                rows[("partials", dtype)] = kernel_row(max(dm, dl, dacc), ms, plain, bms, by)

        q, k, v = flash_case(dtype, 512, 512)
        out = fa.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        ref = fa.plain_flash_attention(q, k, v, causal=False)
        label = f"flash_attention[non-causal] {dn} B=2 Sq=Skv=512 H=9 KV=3 hd=64"
        err, text = flash_check(out, ref, dtype, label)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False))
        plain = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, causal=False), iters=5)
        lib = sdpa_ms(q, k, v, 0, causal=False)
        bms, by = bound(work.flash(q, k, causal=False), dtype)
        path = fa.flash_plan(dtype, 2, 512, 9, 3, 64)["path"]
        log(f"{label} path={path}: {text} ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
            f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}"
            + cuda_core_flash(q, k, v, 0, False, path))
        rows[("flash_noncausal", dtype)] = kernel_row(err, ms, plain, bms, by, lib)
    return rows


# ---------------------------------------------------------------------------
# phase 5/6: serving


# the position of the token argument in each step function's call
TOKEN_ARG = {"prefill": 1, "prefill_with_prefix": 1, "decode_step": 2, "decode_step_paged": 4,
             "verify_step": 2, "verify_step_paged": 4, "prefill_chunk": 2}


class StepLog:
    """Records each call of a model's compiled steps (every callable its
    ``jit_step`` makes from here on: create the log before the engine):
    (name, token width T, paged launches inside it, flash launches inside
    it, int8 paged launches inside it), read from the wrappers' counts,
    which a replay advances by its
    graph's launch vector; keeps the last call's logits and a device-side
    flag of non-finite ones (no host sync in the loop)."""

    def __init__(self, model):
        self.calls = []
        self.last = None
        self.bad = torch.zeros((), dtype=torch.bool, device=model.device)
        jit = model.jit_step
        model.jit_step = lambda name, backend=None: _Logged(self, name, jit(name, backend))

    def of(self, *names):
        return [c for c in self.calls if c[0] in names]

    def n(self, *names):
        return len(self.of(*names))


class _Logged:
    """A compiled step whose calls go to a ``StepLog``."""

    def __init__(self, log, name, fn):
        self.log, self.name, self.fn = log, name, fn

    def _cache_size(self):
        return self.fn._cache_size()

    def __call__(self, *a, **kw):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import paged_decode_attention as pda

        p0, f0 = pda.paged_decode_attention.launches, fa.flash_attention.launches
        i0 = pda.paged_decode_attention.launches_int8
        logits, out = self.fn(*a, **kw)
        log = self.log
        log.calls.append((self.name, int(a[TOKEN_ARG[self.name]].shape[1]),
                          pda.paged_decode_attention.launches - p0,
                          fa.flash_attention.launches - f0,
                          pda.paged_decode_attention.launches_int8 - i0))
        log.last = logits
        log.bad |= ~torch.isfinite(logits).all()
        return logits, out


def headline(label, stats, card):
    s = stats.serving_summary()
    keys = ("n_requests", "n_steps", "p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms",
            "p99_tpot_ms", "p50_step_ms", "p99_step_ms", "prefix_hit_rate")
    log(f"serve[{label}] on {card}: " + json.dumps({k: s[k] for k in keys}))
    return s


def _launch_counters():
    """kernel row key → (wrapper, name of its launch counter)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import relic_matmul as rm
    from repro_torch.kernels import ssd_scan as ssd

    return {"paged": (pda.paged_decode_attention, "launches"),
            "paged_int8": (pda.paged_decode_attention, "launches_int8"),
            "partials": (pda.paged_decode_attention, "launches_partials"),
            "flash": (fa.flash_attention, "launches"),
            "flash_noncausal": (fa.flash_attention, "launches_noncausal"),
            "ssd": (ssd.ssd_scan, "launches"), "relic_matmul": (rm.relic_matmul, "launches"),
            "relic_gemv": (rm.relic_gemv, "launches"), "decode": (da.decode_attention, "launches")}


def reset_launches():
    for fn, attr in _launch_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {key: getattr(fn, attr) for key, (fn, attr) in _launch_counters().items()}


def compiled(engine):
    """Entries the engine's step families hold (``_cache_size``: keys
    captured, plus recaptures on other state storage)."""
    from repro_torch.models.step_graph import cache_size

    return cache_size([f for fam in engine._steps.values() for f in fam.values()])


def retraces(engine):
    return engine.stats.registry.counter("engine.retraces").value


def serve_full_width(card):
    """smollm-135m on both layouts; each run's launch counts are read from
    zero, and its decode steps and prefills must account for all of them."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests, make_shared_prefix_requests

    cfg = get_config("smollm-135m")
    model = Model(cfg)
    params = model.init(seed=0)
    L = cfg.num_layers
    watch = StepLog(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="paged", block_size=16, max_batch=8)
    runs = (
        ("paged open-loop", "paged", 8,
         lambda rng: make_requests(16, 20.0, vocab=cfg.vocab_size, max_new_tokens=64,
                                   prompt_lens=tuple(range(128, 1025)), rng=rng)),
        ("paged shared-prefix", "paged", 8,
         lambda rng: make_shared_prefix_requests(8, 20.0, vocab=cfg.vocab_size, prefix_len=512,
                                                 suffix_len=64, max_new_tokens=64, rng=rng)),
        ("slot", "slot", 4,
         lambda rng: make_requests(4, 20.0, vocab=cfg.vocab_size, max_new_tokens=32,
                                   prompt_lens=tuple(range(128, 513)), rng=rng)),
    )
    # warm the path (allocator, library load, the first captures) outside
    # the measured runs
    engine.serve(make_requests(2, 1e3, vocab=cfg.vocab_size, max_new_tokens=4,
                               prompt_lens=(128,), rng=np.random.default_rng(9)))
    totals = {"paged": 0, "flash": 0}
    for label, layout, mb, make in runs:
        watch.calls.clear()
        reset_launches()
        out = engine.serve(make(np.random.default_rng(1)), kv_layout=layout, max_batch=mb)
        n = read_launches()
        decodes = watch.n("decode_step", "decode_step_paged")
        prefills = watch.n("prefill", "prefill_with_prefix")
        s = headline(label, engine.stats, card)
        log(f"serve[{label}]: {decodes} decode steps -> {n['paged']} paged launches; "
            f"{prefills} prefill calls -> {n['flash']} flash launches")
        require(decodes > 0 and n["paged"] == L * decodes, "decode did not run through the paged kernel")
        require(prefills > 0 and n["flash"] == L * prefills, "prefill did not run through the flash kernel")
        require(n["ssd"] == 0 and n["paged_int8"] == 0,
                "a dense model with a float cache launched the SSD or int8 paged kernel")
        require(not any(n[k] for k in SINGLE_DEVICE_IDLE),
                "serving launched an entry-point-only kernel or the partials mode")
        require(not bool(watch.bad), "non-finite logits")
        require(s["n_requests"] == len(out) and all(len(t) > 0 for t in out.values()),
                "not every request finished with tokens")
        if "prefix" in label:
            require(watch.n("prefill_with_prefix") > 0 and s["prefix_hit_rate"] > 0, "no prefix hits")
        totals["paged"] += n["paged"]
        totals["flash"] += n["flash"]
    return totals, params


def serve_mamba2(card):
    """mamba2-370m at full width on the slot layout: 12 open-loop requests
    on 8 rows; every prefill call must launch the SSD kernel once per
    layer, and nothing may launch an attention kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests

    cfg = get_config("mamba2-370m")
    model = Model(cfg)
    params = model.init(seed=0)
    L = cfg.num_layers
    watch = StepLog(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="slot", max_batch=8)
    engine.serve(make_requests(2, 1e3, vocab=cfg.vocab_size, max_new_tokens=4,
                               prompt_lens=(128,), rng=np.random.default_rng(9)))
    watch.calls.clear()
    reset_launches()
    out = engine.serve(make_requests(12, 20.0, vocab=cfg.vocab_size, max_new_tokens=64,
                                     prompt_lens=tuple(range(128, 1025)),
                                     rng=np.random.default_rng(1)))
    n = read_launches()
    decodes, prefills = watch.n("decode_step"), watch.n("prefill")
    s = headline("mamba2 slot", engine.stats, card)
    log(f"serve[mamba2 slot]: {decodes} decode steps, {prefills} prefill calls -> "
        f"{n['ssd']} SSD launches ({L} layers)")
    require(prefills > 0 and n["ssd"] == L * prefills, "prefill did not run through the SSD kernel")
    require(decodes > 0, "no decode step ran")
    require(n["paged"] == n["paged_int8"] == n["flash"] == 0,
            "the SSM model launched an attention kernel")
    require(not any(n[k] for k in SINGLE_DEVICE_IDLE),
            "serving launched an entry-point-only kernel or the partials mode")
    require(not bool(watch.bad), "non-finite logits")
    require(s["n_requests"] == len(out) == 12 and all(len(t) > 0 for t in out.values()),
            "not every request finished with tokens")
    return n["ssd"], params


def serve_zamba2(card):
    """zamba2-2.7b at full width on the slot layout (int8 KV cache): 12
    open-loop requests on 8 rows. Every prefill call must launch the SSD
    kernel once per layer (54) and the flash kernel once per attention
    site (9); every decode step the int8 paged kernel once per site, and
    no float-pool paged kernel may run."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests

    cfg = get_config("zamba2-2.7b")
    model = Model(cfg)
    params = model.init(seed=0)
    L, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    watch = StepLog(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="slot", max_batch=8)
    engine.serve(make_requests(2, 1e3, vocab=cfg.vocab_size, max_new_tokens=4,
                               prompt_lens=(128,), rng=np.random.default_rng(9)))
    watch.calls.clear()
    reset_launches()
    out = engine.serve(make_requests(12, 20.0, vocab=cfg.vocab_size, max_new_tokens=64,
                                     prompt_lens=tuple(range(128, 1025)),
                                     rng=np.random.default_rng(1)))
    n = read_launches()
    decodes, prefills = watch.n("decode_step"), watch.n("prefill")
    s = headline("zamba2 slot", engine.stats, card)
    log(f"serve[zamba2 slot]: {decodes} decode steps -> {n['paged_int8']} int8 paged launches "
        f"({G} sites); {prefills} prefill calls -> {n['ssd']} SSD ({L} layers) and "
        f"{n['flash']} flash launches")
    require(prefills > 0 and n["ssd"] == L * prefills, "prefill did not run through the SSD kernel")
    require(n["flash"] == G * prefills, "prefill did not run through the flash kernel")
    require(decodes > 0 and n["paged_int8"] == G * decodes,
            "decode did not run through the int8 paged kernel")
    require(n["paged"] == 0, "the int8 cache launched a float-pool paged kernel")
    require(not any(n[k] for k in SINGLE_DEVICE_IDLE),
            "serving launched an entry-point-only kernel or the partials mode")
    require(not bool(watch.bad), "non-finite logits")
    require(s["n_requests"] == len(out) == 12 and all(len(t) > 0 for t in out.values()),
            "not every request finished with tokens")
    return n, params


def profile_split(label, fn, kernels, card):
    """Host wall clock of ``fn`` (synchronised) against the device time the
    profiler sums over the kernels of the same work (one stream, so
    kernels never overlap and the difference is device idle time), and
    the share of it in kernels whose name holds each of ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    # device-side events only (kernels, copies): the CPU side's op events,
    # thousands a step, cost seconds to collect and would repeat the device
    # time of the kernels they launched
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_all = sum(e.time_range.elapsed_us() for e in gpu) / 3e3
    shares = ", ".join(
        f"{k} {sum(e.time_range.elapsed_us() for e in gpu if k in e.name) / 3e3:.2f} ms"
        for k in kernels)
    launches = len(gpu) / 3
    busy = f"{dev_all:.2f} ms ({dev_all / wall:.0%} of wall)" if gpu else "not measured"
    log(f"time[{label}] on {card}: wall {wall:.2f} ms, device busy {busy}, "
        f"{shares}, {launches:.0f} device operations")
    return wall, dev_all


def split_pair(label, eager, graphed, kernels, card):
    """``profile_split`` of the same work run eagerly and as a replayed
    CUDA graph, then the two side by side: wall ratio and the device's
    idle share (1 - busy / wall) of each."""
    ew, eb = profile_split(f"{label}, eager", eager, kernels, card)
    gw, gb = profile_split(f"{label}, graphed", graphed, kernels, card)
    log(f"time[{label}] on {card}: wall eager {ew:.2f} ms, graphed {gw:.2f} ms ({ew / gw:.2f}x); "
        f"device busy {eb:.2f} -> {gb:.2f} ms; idle share {1 - eb / ew:.0%} -> {1 - gb / gw:.0%}")


def time_split(params, card, arch="smollm-135m", cfg=None):
    """Where a full-width ``arch`` decode step (8 paged rows) and a
    1024-token prefill spend their time, eager and graphed (``cfg``: its
    config, when cut in depth). A VLM's prompts carry seeded patch rows,
    which count in the 1024 and in each row's length."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.kv_cache import PagedKVCache

    cfg = cfg or get_config(arch)
    model = Model(cfg)  # a fresh model object: no StepLog wrappers
    kv = PagedKVCache(model, 8, 2048, block_size=16)
    rng = np.random.default_rng(0)
    n_lead = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    kw = {}
    if n_lead:
        pe = torch.from_numpy(patch_embeds(cfg, 1, 23)[0])[None]
        kw["patch_embeds"] = pe.to(device="cuda", dtype=model.dtype)
    for r in range(8):
        toks = tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                  int(rng.integers(128, 1025 - n_lead))))
        row, _ = kv.try_admit(r, toks, 64, n_tokens=n_lead + len(toks))
        _, cache = model.prefill(params, torch.tensor([toks], device="cuda"), 2048, **kw)
        kv.write_prefill(row, cache)
    tok = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1024 - n_lead))).cuda()

    def decode(step):
        for r in range(8):
            kv.ensure_tail(r)
        pool, tables, lens = kv.kernel_inputs()
        step(params, pool, tables, lens, tok)
        for r in range(8):
            kv.advance(r)

    graphed, prefill = model.jit_step("decode_step_paged"), model.jit_step("prefill")
    name = "" if arch == "smollm-135m" else f"{arch} "
    split_pair(f"{name}decode step, 8 paged rows", lambda: decode(model.decode_step_paged),
               lambda: decode(graphed), ("paged_decode_kernel",), card)
    split_pair(f"{name}prefill, 1024 {'rows' if n_lead else 'tokens'}",
               lambda: model.prefill(params, prompt, 2048, **kw),
               lambda: prefill(params, prompt, 2048, **kw), ("flash_kernel",), card)
    return model, kv, decode


def time_split_slots(arch, params, card, kernels):
    """The same split for a full-width model on the slot layout, eager and
    graphed: a decode step over 8 slot rows holding the caches of
    128-1024-token prompts, and a 1024-token prefill. A mamba2 decode runs
    no kernel of the port (the one-step recurrence is plain PyTorch), so
    its SSD share is 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    model = Model(cfg)
    cache = model.init_cache(8, 2048)
    rng = np.random.default_rng(0)
    for r in range(8):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, int(rng.integers(128, 1025)))))
        _, slot_cache = model.prefill(params, toks.cuda(), 2048)
        model.write_cache_slot(cache, slot_cache, r)
    tok = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1024))).cuda()
    name = arch.split("-")[0]
    decode, prefill = model.jit_step("decode_step"), model.jit_step("prefill")
    split_pair(f"{name} decode step, 8 slot rows", lambda: model.decode_step(params, cache, tok),
               lambda: decode(params, cache, tok), kernels, card)
    split_pair(f"{name} prefill, 1024 tokens", lambda: model.prefill(params, prompt, 2048),
               lambda: prefill(params, prompt, 2048), kernels, card)


def count_ties(model, params, prompts, want, got, label, margins=None):
    """How many pairs of greedy streams differ, each first difference
    held to be a tie: the plain reference backend's top-2 logit margin on
    ``want``'s context there must be under ``LOGIT_TIE_TOL``. ``margins``
    (one dict a stream, token index → margin: a ``MarginLog`` of the run
    that made ``want``) gives the margin its run saw; without it the
    context is prefilled once. ``model`` must not be wrapped by a
    ``StepLog`` (its prefill would be logged)."""
    ties = 0
    for i, (prompt, a, b) in enumerate(zip(prompts, want, got)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        p = int(np.argmax(a != b)) if len(a) == len(b) else min(len(a), len(b))
        if margins is not None:
            margin = margins[i][p]
        else:
            ctx = np.concatenate([np.asarray(prompt), a[:p]]).astype(np.int64)[None]
            logits, _ = model.prefill(params, ctx, ctx.shape[1], backend="reference")
            top2 = torch.topk(logits[0].float(), 2).values
            margin = float(top2[0] - top2[1])
        require(margin < LOGIT_TIE_TOL, f"{label}: tokens differ at {p} of stream {i} "
                f"(margin {margin:.2e})")
        ties += 1
    return ties


class MarginLog:
    """The top-2 logit margin of every token a greedy scheduler samples,
    recorded from the logits its own run sampled it from (the prefill or
    last chunk's, a decode step's, a verify's): ``of(req)`` maps the
    request's token index to the margin. A replay of the context would
    compute another function where the run's result depends on what else
    the call held (a MoE's capacity) or on its int8 cache's codes (a
    chunked prefill attends its own quantized rows, a monolithic one does
    not). ``keep``: also keep each token's logits (``logits_of``).
    ``force`` (rid → tokens): teacher forcing; each listed request samples
    the given token at each index the list covers (its logits are kept as
    computed, the sampler is handed a row whose argmax is that token), so
    two runs forced onto one stream make the same calls in the same
    order."""

    def __init__(self, sched, keep=False, force=None):
        self.m, self.rows, self.keep, self.force = {}, {}, keep or force is not None, force or {}
        start, pool = sched._start_decode, sched._decode_pool

        def take(req, i, row):
            """Record ``row`` [V], the logits of req's token i; return the
            row to sample from."""
            t = torch.topk(row.float(), 2).values
            self.m[(req.rid, i)] = float(t[0] - t[1])
            if self.keep:
                self.rows[(req.rid, i)] = row.float().cpu()
            want = self.force.get(req.rid)
            if want is None or i >= len(want):
                return row
            hot = torch.zeros_like(row)
            hot[int(want[i])] = 1
            return hot

        def start_decode(req, row, logits_row):
            return start(req, row, take(req, len(req.tokens), logits_row))

        def decode_pool():
            logits = pool()
            out = logits.clone() if self.force else logits
            for row, req in sched._active.items():
                got = take(req, len(req.tokens), logits[row])
                if self.force:
                    out[row] = got
            return out

        def verified(step):
            def call(*args):
                logits, state = step(*args)  # [rows, K+1, V]
                out = logits.clone() if self.force else logits
                for row, req in sched._active.items():
                    for j in range(logits.shape[1]):
                        got = take(req, len(req.tokens) + j, logits[row, j])
                        if self.force:
                            out[row, j] = got
                return out, state
            return call

        sched._start_decode, sched._decode_pool = start_decode, decode_pool
        for name in ("_verify", "_verify_paged"):
            if getattr(sched, name) is not None:
                setattr(sched, name, verified(getattr(sched, name)))

    def of(self, req):
        return {i: m for (rid, i), m in self.m.items() if rid == req.rid}

    def logits_of(self, req):
        return {i: row for (rid, i), row in self.rows.items() if rid == req.rid}


def parity_f32(arch, layouts, prompt_lens):
    """A float32 ``arch`` served through the kernels and through the plain
    reference backend, on each layout: the same greedy tokens, or a tie."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(seed=1)
    for layout in layouts:
        engine = ServingEngine(model, params, max_seq=512, kv_layout=layout, block_size=16, max_batch=4)
        streams = {}
        for backend in ("kernel", "reference"):
            reqs = make_requests(4, 50.0, vocab=cfg.vocab_size, max_new_tokens=16,
                                 prompt_lens=prompt_lens, rng=np.random.default_rng(3))
            out = engine.serve(reqs, attention_backend=backend)
            streams[backend] = [out[r.rid] for r in reqs]
        prompts = [np.asarray(r.prompt) for r in reqs]
        ties = count_ties(model, params, prompts, streams["reference"], streams["kernel"],
                          f"{arch} {layout}: kernel and reference")
        log(f"parity[{arch} {layout}] float32 kernel vs reference: "
            f"{len(prompts) - ties} streams identical, {ties} ties "
            f"(top-2 margin < {LOGIT_TIE_TOL:g})")


def _upcast(tree):
    """A parameter tree with every floating tensor in float32."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_upcast(v) for v in tree)
    return tree.float() if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


@contextlib.contextmanager
def moe_routes(record=None, replay=None):
    """Inside the block, every MoE layer call appends its expert choices
    [T, k] to ``record``, or (``replay``) routes on the next choices of
    that list, with gates renormalised from its own float32 router
    probabilities at them."""
    from repro_torch.models import moe

    orig = moe._route

    def route(x, router_w, top_k):
        gates, idx, probs = orig(x, router_w, top_k)
        if record is not None:
            record.append(idx.clone())
        if replay is not None:
            idx = replay.pop(0)
            gates = probs.gather(1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, idx, probs

    moe._route = route
    try:
        yield
    finally:
        moe._route = orig


def parity_bf16(arch, B=2, S=512, layers=None, params=None):
    """bf16 ``arch`` at full width (seeded random weights): a B x S prompt
    prefilled, then one decode step on the greedy token of the plain
    path, through the kernels and through the plain reference backend,
    and through the plain backend in float32 on the same weights upcast.
    Each row of the kernel path's prefill and decode logits must lie no
    further from the float32 logits than ``E2E_BF16_RATIO`` times the bf16
    plain path's (relative L2 norm); the two bf16 paths' own difference is
    printed beside. The kernel prefill must take the wgmma flash kernel
    (head size 64, 80 or 128) once per attention layer and the decode step
    the paged kernel (int8 for an int8 cache) once per attention layer; the
    plain paths launch nothing. ``layers`` cuts the depth (the float32 copy
    of a 14B or 20B model would not fit the card beside its bf16 one);
    ``params``: bf16 parameters to hold (phase 14d: trained ones) in place
    of the seeded draw. A
    VLM's prompt carries seeded patch embeddings ahead of its tokens. A
    MoE's top-k choice is a discontinuity: a rounding that moves a token
    across an expert boundary changes its layer output by an expert's
    worth, so a row's distance from float32 counts such crossings more
    than arithmetic. Each bf16 path of a MoE is therefore held to a float32
    run that routes every layer call on that path's own expert choices
    (``moe_routes``; gates from float32); the distances from the float32
    run's own routing and the share of token-layers routed apart are
    printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        arch = f"{arch} (depth {layers})"
    model = Model(cfg)
    if params is None:
        params = model.init(seed=2)
    sites = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers
    path = fa.flash_plan(torch.bfloat16, B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)["path"]
    require(path == "wgmma", f"{arch}: the bf16 prefill's flash path is {path}, not wgmma")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))).cuda()
    pe = None
    if cfg.family == "vlm":
        pe = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)).cuda().bfloat16()
    moe = cfg.family == "moe"
    f32 = Model(dataclasses.replace(cfg, dtype="float32"))
    out, tok, routes = {}, None, {"plain": [], "kernel": [], "float32": []}
    runs = [("plain", model, params, "reference"), ("kernel", model, params, "kernel"),
            ("float32", f32, None, "reference")]
    if moe:
        runs += [("float32|plain", f32, None, "reference"),
                 ("float32|kernel", f32, None, "reference")]
    for name, m, p, backend in runs:
        if p is None:
            p = _upcast(params)
        reset_launches()
        kw = {} if pe is None else {"patch_embeds": pe.to(m.dtype)}
        if "|" in name:
            routing = moe_routes(replay=list(routes[name.split("|")[1]]))
        else:
            routing = moe_routes(record=routes[name]) if moe else contextlib.nullcontext()
        with routing:
            logits, cache = m.prefill(p, prompt, 2 * S + cfg.n_frontend_tokens, backend=backend,
                                      **kw)
            if tok is None:
                tok = logits.float().argmax(-1, keepdim=True)
            step, _ = m.decode_step(p, cache, tok, backend=backend)
        torch.cuda.synchronize()
        out[name] = (logits.float(), step.float(), read_launches())
        del p, cache
    n = out["kernel"][2]
    decode_key = "paged_int8" if cfg.kv_quant else "paged"
    require(not any(v for name, o in out.items() if name != "kernel" for v in o[2].values()),
            f"{arch}: a plain path launched a kernel")
    require(n["flash"] == sites and n[decode_key] == sites,
            f"{arch}: bf16 prefill + decode launched {n}, not flash and {decode_key} {sites} times each")

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    def fmt(v):
        return "[" + ", ".join(f"{x:.3e}" for x in v) + "]"

    def apart(name):
        """Share of token-layers whose expert set differs from float32's."""
        n_apart = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                      for a, b in zip(routes[name], routes["float32"]))
        return n_apart / sum(a.shape[0] for a in routes[name])

    for i, what in ((0, "prefill"), (1, "decode")):
        got, plain, ref = out["kernel"][i], out["plain"][i], out["float32"][i]
        ref_k, ref_p = ((out["float32|kernel"][i], out["float32|plain"][i]) if moe
                        else (ref, ref))
        require(torch.isfinite(got).all(), f"{arch}: bf16 {what} logits not finite")
        d_k, d_p, d_kp = rel(got, ref_k), rel(plain, ref_p), rel(got, plain)
        against = "float32 on each path's routing" if moe else "float32"
        extra = ""
        if moe:
            extra = (f"; from float32's own routing: kernels {fmt(rel(got, ref))}, plain "
                     f"{fmt(rel(plain, ref))}; token-layers routed apart from float32: kernels "
                     f"{apart('kernel'):.4f}, plain {apart('plain'):.4f}")
        log(f"parity[{arch} bf16] {what} logits per row, ||. - ref||/||ref|| against {against}: "
            f"kernels (flash path {path}) {fmt(d_k)}, plain {fmt(d_p)} (kernels <= "
            f"{E2E_BF16_RATIO:g} x plain; worst ratio "
            f"{max(a / b for a, b in zip(d_k, d_p)):.3f}); kernels vs bf16 plain {fmt(d_kp)}"
            + extra)
        require(all(a <= E2E_BF16_RATIO * b for a, b in zip(d_k, d_p)),
                f"{arch}: the bf16 kernel path's {what} logits are further from {against} than "
                f"{E2E_BF16_RATIO:g} x the plain path's: {d_k} against {d_p}")


# ---------------------------------------------------------------------------
# phase 7: the adviser on the card

# a float sum combine adds the items in another order than the serial loop
ADVISER_SUM_RTOL = 1e-5
# items the serial per-item loop runs on the card: a loop launches every op
# of every item on its own (~40 us a launch), ~1 min for GeoIP's 8192
# lookups or BVH's 2048 descents
ADVISER_SERIAL_ITEMS = 64


def adviser_suite(card):
    """The ten benchmarks advised (``advise_suite(hw=CPU_HW)``, data built
    on the card): the decisions must equal ``tests/golden_aira_decisions.json``
    and the two geomeans ``BENCH_aira.json``'s within 1e-6; then each
    accepted plan's ``execute`` runs on the card over the first
    ``ADVISER_SERIAL_ITEMS`` items and must give the serial per-item loop's
    value on them, and over all the items the value of ``vmap`` of the
    per-item function (exactly for integer results, within
    ``ADVISER_SUM_RTOL`` for float sums); the serial loop over those items
    and that run of the plan over all items are timed, once each. The times are device vectorisation,
    not SMT: the gains are the overlap model's, priced for the paper's
    i7-12700 core."""
    from repro_torch.bench_suite import BENCHMARKS, fig34
    from repro_torch.core import CPU_HW, advise_suite

    with open(os.path.join(ROOT, "tests", "golden_aira_decisions.json")) as f:
        golden = json.load(f)
    with open(os.path.join(ROOT, "BENCH_aira.json")) as f:
        bench = json.load(f)
    t0 = time.perf_counter()
    suite = advise_suite(hw=CPU_HW)
    log(f"adviser: advise_suite over {len(suite)} benchmarks (data on "
        f"{torch.cuda.get_device_name(0)}) in {time.perf_counter() - t0:.1f} s")
    require(set(suite) == set(golden), f"adviser: benchmarks {sorted(suite)}")
    rows = []
    for name, entry in suite.items():
        d, b, data = entry.decision, BENCHMARKS[name], entry.data
        got = {"accepted": d.accepted, "granularity": d.schedule.granularity,
               "predicted_gain": round(d.predicted_gain, 6), "strategy": d.schedule.strategy}
        require(got == golden[name], f"adviser: {name} decided {got}, golden {golden[name]}")
        require((entry.plan is not None) == d.accepted, f"adviser: {name} plan / decision mismatch")
        rows.append(dict(name=name, accepted=d.accepted, predicted=d.predicted_gain,
                         realized=fig34.realized_gain(b, data, d)))
    fig34.flag_regressions(rows)
    gm_pos, gm_all = fig34.geomeans(rows)
    require(abs(gm_pos - bench["geomean_positive"]) <= 1e-6
            and abs(gm_all - bench["geomean_all_discard_negative"]) <= 1e-6,
            f"adviser: geomeans {gm_pos!r}, {gm_all!r} against BENCH_aira.json's")
    log(f"adviser: decisions equal tests/golden_aira_decisions.json; geomean(positive) {gm_pos!r}, "
        f"geomean(all) {gm_all!r} (BENCH_aira.json: {bench['geomean_positive']!r}, "
        f"{bench['geomean_all_discard_negative']!r}; model gains priced for CPU_HW)")
    for r in rows:
        name = r["name"]
        entry, b = suite[name], BENCHMARKS[name]
        if entry.plan is None:
            log(f"adviser[{name}]: rejected by the gate ({r['predicted'] * 100:+.1f}%), no plan")
            continue
        items = b.items(entry.data)
        n = torch.utils._pytree.tree_leaves(items)[0].shape[0]
        k = min(n, ADVISER_SERIAL_ITEMS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = b.serial_value(entry.data, combine=b.combine, limit=k)
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t0) * 1e3
        head = entry.plan.execute(torch.utils._pytree.tree_map(lambda a: a[:k], items))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = entry.plan.execute(items)
        torch.cuda.synchronize()
        par_ms = (time.perf_counter() - t0) * 1e3
        mapped = torch.func.vmap(b.item_fn(entry.data))(items).sum(0, dtype=whole.dtype)
        checks = []
        for what, got, want in ((f"serial loop, first {k}", head, serial),
                                (f"vmap, all {n}", whole, mapped)):
            if got.dtype.is_floating_point:
                err = (got - want).abs().item()
                ok = err <= ADVISER_SUM_RTOL * max(want.abs().item(), 1e-30)
                checks.append(f"|plan - {what}| {err:.3e}")
            else:
                ok = torch.equal(got, want)
                checks.append(f"plan == {what} exactly")
            require(ok and got.device.type == "cuda",
                    f"adviser[{name}]: plan {got} against {what} {want}")
        log(f"adviser[{name}] on {card}: {entry.plan.describe()}; {'; '.join(checks)} (float: <= "
            f"{ADVISER_SUM_RTOL:g} x |value|); wall ms: serial loop over {k} items {serial_ms:.2f}, "
            f"restructured over all {n} {par_ms:.2f} (device vectorisation, not SMT; model "
            f"gain {r['predicted'] * 100:+.1f}% predicted, {r['realized'] * 100:+.1f}% realized"
            f"{', regressed' if r['regressed'] else ''})")


P7_SCRIPT = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "chip_smoke.phase7(sys.argv[2])\n"
)


def phase7(card):
    """Phase 7 (the adviser suite and serving through a decode plan), in a
    process of its own beside phases 8-13 (``Phase7``): host-bound work
    that needs little of the card. As in phases 5-12, no call may reach the
    partials mode's entry point."""
    from repro_torch.kernels import ops as kernel_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry, calls = kernel_ops.paged_attention_partials, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return entry(*a, **kw)

    kernel_ops.paged_attention_partials = counted
    t0 = time.perf_counter()
    adviser_suite(card)
    serve_decode_plan(card)
    require(calls[0] == 0, f"phase 7 called the partials mode {calls[0]} times")
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s (its own process)")


class Phase7:
    """``phase7`` in a process of its own, started after phase 6 (its lines
    go to this run's output as they come); ``finish`` waits for it."""

    def __init__(self, card):
        self.proc = subprocess.Popen([sys.executable, "-c", P7_SCRIPT, ROOT, card], cwd=ROOT)

    def finish(self):
        rc = self.proc.wait()
        require(rc == 0, f"phase 7 exited {rc}")


def _plan_schedule(plan, n):
    """(granularity, chunks per stream) of ``plan`` over n items, as
    relic_pfor deals them (the last chunk padded by repeating an item)."""
    g = max(1, min(plan.key.granularity, n))
    ns = plan.key.n_streams
    target = -(-n // (g * ns)) * g * ns
    return g, target // (g * ns)


# the rows each dtype's decode plan serves
P7_PLAN_ROWS = (("float32", (7,)), ("bfloat16", (8,)))


def plan_serves(engine, prompts, steps, label, L, per_stream, card):
    """``engine.generate(prompts, steps)`` through its decode plan three
    times: graphed (the first serve makes the plan family's one entry: an
    eager first call, then the capture), graphed again (replays only: no
    capture) and eager (``step_graph.disabled()``). Each serve must launch
    the paged kernel exactly L x chunks a stream x decode steps and flash
    L times (the one batched prefill), and give the first serve's tokens.
    Then one more graphed serve under the profiler: its device busy time
    against the graphed wall. Returns ({"first", "graphed", "eager": wall
    ms, "tokens"}, the last launch counts, [(plan key, _cache_size())])."""
    from repro_torch.models import step_graph

    walls, first = {}, None
    for mode in ("first", "graphed", "eager"):
        torch.cuda.synchronize()
        reset_launches()
        with step_graph.disabled() if mode == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            got = engine.generate(prompts, steps).numpy()
            walls[mode] = (time.perf_counter() - t0) * 1e3
        n = read_launches()
        decodes = len(engine.stats.step_ms)
        require(decodes == steps - 1, f"{label} {mode}: {decodes} decode steps, not {steps - 1}")
        expect = L * per_stream * decodes
        others = {k: v for k, v in n.items() if k not in ("paged", "flash") and v}
        require(n["paged"] == expect and n["flash"] == L and not others,
                f"{label} {mode}: launches {n}, expected paged {expect} = {L} layers x "
                f"{per_stream} chunk(s) x {decodes} steps, flash {L} (the one batched prefill) "
                "and nothing else")
        entries = [(k[0].region, f._cache_size()) for k, f in engine._plan_steps.items()]
        require(len(entries) == 1 and entries[0][1] == 1,
                f"{label} {mode}: plan families {entries}, expected one entry of one capture")
        first = got if first is None else first
        require(np.array_equal(got, first), f"{label} {mode}: tokens differ from the first serve's")
    walls["tokens"] = first
    profile_busy(f"{label} graphed serve of {steps} tokens", lambda: engine.generate(prompts, steps),
                 walls["graphed"], card)
    return walls, n, entries


def serve_decode_plan(card):
    """smollm-135m at full width on the slot layout, served through a
    decode plan: ``decode_region(prompts, force=True)`` advised by
    ``Aira(hw=CPU_HW)``, then ``set_decode_plan``; float32 at 7 rows (the
    last chunk padded), bf16 at 8 (``P7_PLAN_ROWS``: each advice costs
    10-30 s of host time). float32: the plan path's greedy tokens equal the
    no-plan path's (or tie, as phase 6 counts ties), and the paged kernel
    launches exactly layers x chunks per stream x decode steps on the plan
    path (the kernel ran under vmap once a chunk, nothing on the plain
    version), through the captured plan family (one entry, captured in the
    first serve), and again eagerly (``plan_serves``), with the walls of
    the three serves and of the no-plan path; bf16: one decode step's
    logits through the plan no further
    from the float32 plain path than ``E2E_BF16_RATIO`` x the bf16 plain
    path's."""
    from repro_torch.configs import get_config
    from repro_torch.core import CPU_HW, Aira, Workload
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine

    base = get_config("smollm-135m")
    L, S, steps, max_seq = base.num_layers, 128, 8, 256
    for dtype, rows in P7_PLAN_ROWS:
        cfg = dataclasses.replace(base, dtype=dtype)
        model = Model(cfg)
        params = model.init(seed=3)
        for B in rows:
            prompts = np.random.default_rng(B).integers(0, cfg.vocab_size, (B, S))
            engine = ServingEngine(model, params, max_seq=max_seq)
            region = engine.decode_region(prompts, force=True)
            d = Aira(hw=CPU_HW).advise(Workload("serve", lambda: None, [region])).decisions[0]
            require(d.accepted and d.plan is not None, f"decode plan ({dtype}, B={B}) not accepted")
            g, per_stream = _plan_schedule(d.plan, B)
            label = f"smollm-135m {dtype} slot B={B}: {d.plan.describe()} ({per_stream} chunk(s) a stream)"
            if dtype == "float32":
                plain = ServingEngine(model, params, max_seq=max_seq)
                plain_ms = []
                for _ in range(2):  # the first serve captures the no-plan steps
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    want = plain.generate(prompts, steps).numpy()
                    plain_ms.append((time.perf_counter() - t0) * 1e3)
                profile_busy(f"{label} no-plan graphed serve of {steps} tokens",
                             lambda: plain.generate(prompts, steps), plain_ms[1], card)
                engine.set_decode_plan(d.plan)
                walls, n, entries = plan_serves(engine, prompts, steps, label, L, per_stream, card)
                got = walls.pop("tokens")
                ties = count_ties(model, params, prompts, want, got,
                                  f"{label}: plan and no-plan")
                log(f"decode plan[{label}] on {card}: {B - ties} of {B} greedy streams identical to "
                    f"the no-plan path, {ties} ties; paged launches {n['paged']} = {L} x {per_stream} x "
                    f"{steps - 1} a serve, graphed and eager; plan families {entries}; wall ms for "
                    f"{steps} tokens: plan graphed {walls['graphed']:.1f} (first serve, with its "
                    f"capture, {walls['first']:.1f}), plan eager {walls['eager']:.1f}, no plan "
                    f"graphed {plain_ms[1]:.1f} (first serve {plain_ms[0]:.1f})")
                continue
            tok = region.items[0]
            reset_launches()
            logits_plan, _ = d.plan.execute(region.items)
            torch.cuda.synchronize()
            n = read_launches()
            require(n["paged"] == L * per_stream and not any(v for k, v in n.items() if k != "paged"),
                    f"{label}: one plan step launched {n}, expected paged {L * per_stream}")
            ptoks = torch.as_tensor(prompts, device=model.device)
            out = {"plan": logits_plan.float()}
            for name, m, p in (("plain", model, params),
                               ("float32", Model(dataclasses.replace(cfg, dtype="float32")),
                                _upcast(params))):
                _, cache = m.prefill(p, ptoks, max_seq, backend="reference")
                step, _ = m.decode_step(p, cache, tok[:, None], backend="reference")
                out[name] = step.float()
                del cache
            got, plain, ref = out["plan"], out["plain"], out["float32"]
            d_k = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
            d_p = ((plain - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
            require(torch.isfinite(got).all() and all(a <= E2E_BF16_RATIO * b for a, b in zip(d_k, d_p)),
                    f"{label}: plan logits further from float32 than {E2E_BF16_RATIO:g} x the "
                    f"bf16 plain path's: {d_k} against {d_p}")
            log(f"decode plan[{label}] on {card}: one step's logits ||. - float32||/||float32|| worst "
                f"{max(d_k):.3e} (plain bf16 worst {max(d_p):.3e}; worst ratio "
                f"{max(a / b for a, b in zip(d_k, d_p)):.3f} <= {E2E_BF16_RATIO:g}); paged launches "
                f"{n['paged']} = {L} x {per_stream}")
        del params, model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: speculation, chunked prefill, preemption

SPEC_K = 4  # draft tokens a verify: T = K + 1 = 5
CHUNK = 256  # chunked prefill's token budget a step: widths 1, 2, ..., 256
class TieCheckedDraft:
    """A draft stream that proposes through ``inner`` and, at each
    rollback, holds every rejection to be a tie: the rejected draft
    token's logit in the verify (``log.last``) within ``LOGIT_TIE_TOL`` of
    the verify's top logit at that position."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log
        self.rejections = 0

    def bind(self, max_batch, max_seq):
        self.inner.bind(max_batch, max_seq)

    def on_admit(self, row, req):
        self.inner.on_admit(row, req)

    def propose(self, active, tok):
        self.rows = list(active)
        self.drafts = self.inner.propose(active, tok)
        return self.drafts

    def rollback(self, n_rejected):
        logits = self.log.last.float()
        for row in self.rows:
            d = torch.as_tensor(self.drafts[row], device=logits.device).long()
            g = torch.argmax(logits[row], dim=-1)
            miss = (d != g[: len(d)]).nonzero()
            if len(miss):
                a = int(miss[0])
                margin = float(logits[row, a].max() - logits[row, a, d[a]])
                require(margin < LOGIT_TIE_TOL,
                        f"self-draft: row {row} rejected its draft at {a} (margin {margin:.2e})")
                self.rejections += 1
        self.inner.rollback(n_rejected)


def drive(sched, reqs, dt):
    """Run ``reqs`` to completion on a step clock: step i admits what has
    arrived by i * dt and every request time is read from that clock, so
    when a request arrives against the others' progress does not depend on
    the card's speed."""
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
    return {r.rid: r.output() for r in reqs}


def check_launches(n, expect, label):
    """Every count of ``n`` equals ``expect``'s entry (0 where it has none)."""
    want = {k: expect.get(k, 0) for k in n}
    require(n == want, f"{label}: launches {n}, expected {want}")


def phase8_serving(card, cfg, device="cuda"):
    """Phase 8 (a)-(c) on ``cfg`` (full-width float32 smollm-135m on the
    card), ``max_seq`` 2048, and (d) when ``cfg`` is bf16. Returns the
    launches at the three phase-8 kernel shapes: verify (T = K+1), chunk
    (T = 256) and the draft view (BS = 1)."""
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, SpecConfig, make_requests, make_slo_requests

    L, K = cfg.num_layers, SPEC_K
    f32 = cfg.dtype == "float32"
    target, ref = Model(cfg, device), Model(cfg, device)
    params = target.init(seed=2)
    draft = Model(dataclasses.replace(cfg, num_layers=1), device)
    dparams = draft.init(seed=3)
    tlog, dlog = StepLog(target), StepLog(draft)
    shape_launches = {"verify": 0, "chunk": 0, "draft": 0}
    name = f"smollm-135m {cfg.dtype}"

    def work(seed, lens, n=4, tokens=24):
        return make_requests(n, 50.0, vocab=cfg.vocab_size, max_new_tokens=tokens,
                             prompt_lens=tuple(lens), rng=np.random.default_rng(seed))

    def finished(out, reqs, label):
        require(not bool(tlog.bad) and not bool(dlog.bad), f"{label}: non-finite logits")
        require(all(r.finished and len(out[r.rid]) == r.max_new_tokens for r in reqs),
                f"{label}: not every request finished its budget")

    # (a) speculation, K = 4: n-gram and a one-layer draft, both layouts;
    # (d) in bf16: one n-gram run on the paged layout
    for layout in ("slot", "paged") if f32 else ("paged",):
        engine = ServingEngine(target, params, max_seq=2048, kv_layout=layout, block_size=16,
                               max_batch=4, device=device)
        base_reqs = work(11, range(128, 513))
        plain = engine.serve(base_reqs)
        prompts = [np.asarray(r.prompt) for r in base_reqs]
        for drafter in ("ngram", "model") if f32 else ("ngram",):
            spec = (SpecConfig(k=K) if drafter == "ngram" else
                    SpecConfig(k=K, drafter="model", draft_model=draft, draft_params=dparams))
            label = f"spec[{name} {layout} {drafter} K={K}]"
            reqs = work(11, range(128, 513))
            tlog.calls.clear()
            dlog.calls.clear()
            reset_launches()
            out = engine.serve(reqs, spec=spec)
            n = read_launches()
            verifies = tlog.of("verify_step", "verify_step_paged")
            prefills = tlog.of("prefill", "prefill_with_prefix")
            drafts = dlog.of("decode_step")
            dprefills = dlog.of("prefill")
            require(verifies and all(c[1] == K + 1 and c[2] == L and not c[3] for c in verifies),
                    f"{label}: a verify was not {L} paged launches at T = {K + 1}")
            require(all(c[1] == 1 and c[2] == 1 and not c[3] for c in drafts)
                    and len(drafts) == (K + 1) * len(verifies if drafter == "model" else []),
                    f"{label}: the draft model did not decode K + 1 = {K + 1} steps a round, "
                    "one paged launch each")
            require(len(tlog.calls) == len(verifies) + len(prefills), f"{label}: a plain decode ran")
            check_launches(n, {"paged": L * len(verifies) + len(drafts),
                               "flash": L * len(prefills) + len(dprefills)}, label)
            finished(out, reqs, label)
            s = engine.stats.serving_summary()
            shape_launches["verify"] += L * len(verifies)
            shape_launches["draft"] += len(drafts)
            ties = (count_ties(ref, params, prompts, [plain[r.rid] for r in base_reqs],
                               [out[r.rid] for r in reqs], label) if f32 else None)
            log(f"{label} on {card}: {len(verifies)} verifies x {L} paged launches at T = {K + 1}, "
                f"{len(drafts)} draft decodes x 1 (BS=1 view), {len(prefills)} + {len(dprefills)} "
                f"prefills; acceptance {s['speculative']['acceptance_rate']:.3f}, "
                f"p50 draft {s['speculative']['p50_draft_ms']:.2f} ms, "
                f"p50 verify {s['speculative']['p50_verify_ms']:.2f} ms, "
                f"p50 step {s['p50_step_ms']:.2f} ms; "
                + (f"{len(reqs) - ties} streams equal to plain decoding, {ties} ties"
                   if f32 else "logits finite, every request finished"))
    if f32:
        # the target drafting for itself: a model object of its own, the same weights
        own = Model(cfg, device)
        engine = ServingEngine(target, params, max_seq=2048, max_batch=4, device=device)
        checked = TieCheckedDraft(
            SpecConfig(k=K, drafter="model", draft_model=own, draft_params=params)
            .make_drafter(engine.attention_backend), tlog)
        reqs = work(12, range(128, 513), tokens=16)
        out = engine.serve(reqs, spec=SpecConfig(k=K, drafter=checked))
        finished(out, reqs, "self-draft")
        rate = engine.stats.acceptance_rate
        require(rate == 1.0 or checked.rejections > 0, "self-draft: acceptance below 1 unexplained")
        log(f"spec[{name} slot self-draft K={K}] on {card}: acceptance {rate:.4f}, "
            f"{checked.rejections} rejections, each at a tie (margin < {LOGIT_TIE_TOL:g})")

    # (b) chunked prefill, chunk_size 256, 128-1024-token prompts; (d) in
    # bf16: one run on the slot layout
    for layout in ("slot", "paged") if f32 else ("slot",):
        label = f"chunked[{name} {layout} chunk_size={CHUNK}]"
        engine = ServingEngine(target, params, max_seq=2048, kv_layout=layout, block_size=16,
                               max_batch=4, device=device)
        mono_reqs = work(13, range(128, 1025), tokens=16)
        mono = engine.serve(mono_reqs, chunk_size=0)
        sched = engine.scheduler(4, chunk_size=CHUNK)
        sched.prime()
        reqs = work(13, range(128, 1025), tokens=16)
        tlog.calls.clear()
        c0 = compiled(engine)
        reset_launches()
        out = sched.run(reqs)
        n = read_launches()
        require(compiled(engine) == c0,
                f"{label}: the primed run captured {compiled(engine) - c0} new step graphs")
        chunks = tlog.of("prefill_chunk")
        decodes = tlog.of("decode_step", "decode_step_paged")
        require(len(tlog.calls) == len(chunks) + len(decodes), f"{label}: a monolithic prefill ran")
        require(all(c[2] == L and not c[3] for c in chunks + decodes),
                f"{label}: a chunk or decode was not {L} paged launches (and no flash)")
        require(set(sched.widths["chunk"]) <= sched.primed_widths
                and sum(sched.widths["chunk"].values()) == len(chunks),
                f"{label}: widths {dict(sched.widths['chunk'])} outside the primed "
                f"{sorted(sched.primed_widths)}")
        check_launches(n, {"paged": L * (len(chunks) + len(decodes))}, label)
        finished(out, reqs, label)
        shape_launches["chunk"] += L * sched.widths["chunk"][CHUNK]
        ties = (count_ties(ref, params, [np.asarray(r.prompt) for r in mono_reqs],
                           [mono[r.rid] for r in mono_reqs], [out[r.rid] for r in reqs], label)
                if f32 else None)
        log(f"{label} on {card}: {len(chunks)} chunks {dict(sorted(sched.widths['chunk'].items()))} "
            f"in the primed widths {sorted(sched.primed_widths)} (0 captures after prime), "
            f"{len(decodes)} decodes, "
            f"paged launches {n['paged']} = {L} x {len(chunks) + len(decodes)}, flash 0; "
            f"p50 step {engine.stats.percentile(50):.2f} ms, p99 {engine.stats.percentile(99):.2f} ms; "
            + (f"{len(reqs) - ties} streams equal to monolithic prefill, {ties} ties"
               if f32 else "logits finite, every request finished"))
    if not f32:
        return shape_launches, (target, params, draft, dparams)

    # (c) preemption: make_slo_requests on a 4-row pool of 100 blocks
    def slo():
        return make_slo_requests(8, 100.0, vocab=cfg.vocab_size, max_new_tokens=16,
                                 short_lens=(64, 128), long_len=1024,
                                 rng=np.random.default_rng(14))

    kw = dict(max_seq=2048, kv_layout="paged", block_size=16, device=device)
    tight = ServingEngine(target, params, max_batch=4, num_blocks=100, **kw)
    ample = ServingEngine(target, params, max_batch=8, **kw)
    reqs = slo()
    got = drive(tight.scheduler(4), reqs, 0.01)
    ample_reqs = slo()
    want = drive(ample.scheduler(8), ample_reqs, 0.01)
    ts, as_ = tight.stats, ample.stats
    require(ts.n_preemptions > 0 and as_.n_preemptions == 0,
            f"preemption: {ts.n_preemptions} on the tight pool, {as_.n_preemptions} on the ample")
    require(all(r.finished for r in reqs), "preemption: not every request finished")
    ties = count_ties(ref, params, [np.asarray(r.prompt) for r in reqs],
                      [want[r.rid] for r in ample_reqs], [got[r.rid] for r in reqs],
                      "preemption: tight and ample pools")
    log(f"preempt[{name} paged slo, 4 rows x 100 blocks of 16] on {card}: "
        f"{ts.n_preemptions} preemptions, {ts.recomputed_tokens} recomputed tokens; "
        f"{len(reqs) - ties} streams equal to the ample pool's (8 rows), {ties} ties")
    return shape_launches, None


def phase8_kernels(card):
    """Phase 8 (e): the paged kernel against its plain version at the
    shapes phase 8's serving gives it: a verify (T = 5) on the paged pool
    and the slot view (bitwise equal to five decodes there), a chunk (T =
    256, B = 1, 256-key identity blocks) and the draft model's 2053-long
    slot view (BS = 1, MB = 2053). Returns the JSON rows (bf16) keyed by
    shape."""
    from repro_torch.kernels import paged_decode_attention as pda

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for key, label, case in (
                ("paged_verify", "verify, paged layout B=4 T=5 H=9 KV=3 hd=64 BS=16 MB=128",
                 lambda: paged_case(dtype, SPEC_K + 1, B=4)),
                ("slot_verify", "verify, slot view B=4 T=5 BS=256 MB=8",
                 lambda: slot_case(dtype, T=SPEC_K + 1, lengths=[0, 255, 1500, 2043])),
                ("paged_chunk", "chunk, slot view B=1 T=256 BS=256 MB=8 (lengths 768; 0; 1792)",
                 lambda: slot_case(dtype, B=1, T=CHUNK, lengths=[768])),
                ("paged_draft", "draft view B=4 T=1 Smax=2053 BS=1 MB=2053",
                 lambda: slot_case(dtype, Smax=2048 + SPEC_K + 1, lengths=[0, 1, 1027, 2052]))):
            q, kp, vp, tables, lengths, _, _ = case()
            out = pda.paged_decode_attention(q, kp, vp, tables, lengths)
            torch.cuda.synchronize()
            ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
            err = (out.float() - ref.float()).abs().max().item()
            if key == "paged_chunk":  # the chunk at the row's start and at its end too
                for start in (0, 2048 - CHUNK):
                    at = torch.full_like(lengths, start)
                    e = (pda.paged_decode_attention(q, kp, vp, tables, at).float()
                         - pda.plain_paged_decode_attention(q, kp, vp, tables, at).float())
                    err = max(err, e.abs().max().item())
            require(err <= TOL[dtype] and torch.isfinite(out).all(),
                    f"paged kernel ({label}, {dn}) disagrees with its plain version: {err}")
            extra = ""
            if key == "slot_verify":
                for t in range(SPEC_K + 1):
                    dec = pda.paged_decode_attention(q[:, t : t + 1].contiguous(), kp, vp, tables,
                                                     lengths + t)
                    require(torch.equal(dec[:, 0], out[:, t]), f"verify != decode at {t} ({dn})")
                extra = "; verify (T=5) equals decode bitwise"
            ms = cuda_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths))
            plain = cuda_ms(lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lengths),
                            iters=5)
            bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
            lib, lib_text = None, "null"
            if key in ("slot_verify", "paged_chunk"):  # a contiguous identity view: one SDPA call
                lib, diff = sdpa_cached_ms(q, kp, vp, lengths)
                lib_text = f"{fmt_ms(lib)} (SDPA, boolean mask, enable_gqa; |SDPA - plain| {diff:.2e})"
            log(f"paged_decode_attention {dn} {label} lengths={lengths.tolist()} "
                f"plan={paged_plan_of(q, kp, tables)}: max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) "
                f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) "
                f"library_ms={lib_text}{extra}")
            if key != "slot_verify":
                rows[(key, dtype)] = kernel_row(err, ms, plain, bms, by, lib)
    return rows


def phase8_split(card, models):
    """Host wall against device time (``split_pair``: eager and graphed) of
    one spec round's two halves at full width in bf16 — the verify over 4
    paged rows holding 128-1024-token contexts (T = 5), the one-layer
    draft's K+1 decodes over its 2053-long slot cache — and of one
    256-token chunk at position 768."""
    from repro_torch.serve.kv_cache import PagedKVCache

    target, params, draft, dparams = models
    cfg = target.cfg
    kv = PagedKVCache(target, 4, 2048, block_size=16)
    rng = np.random.default_rng(0)
    for r in range(4):
        toks = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, int(rng.integers(128, 1025))))
        row, _ = kv.try_admit(r, toks, 64)
        _, cache = target.prefill(params, torch.tensor([toks], device="cuda"), 2048)
        kv.write_prefill(row, cache)
        kv.ensure_tail_n(row, SPEC_K + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, SPEC_K + 1))).cuda()
    pool, tables, lens = kv.kernel_inputs()
    dcache = draft.init_cache(4, 2048 + SPEC_K + 1)
    dcache["len"] = lens.clone()
    chunk_cache = target.init_cache(1, 2048)
    chunk_cache["len"].fill_(768)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CHUNK))).cuda()

    def drafts(step):
        for _ in range(SPEC_K + 1):
            step(dparams, dcache, tokens[:, :1])

    verify, chunk_step = target.jit_step("verify_step_paged"), target.jit_step("prefill_chunk")
    draft_step = draft.jit_step("decode_step")
    split_pair("spec round: verify, 4 paged rows, T=5",
               lambda: target.verify_step_paged(params, pool, tables, lens, tokens),
               lambda: verify(params, pool, tables, lens, tokens), ("paged_decode_kernel",), card)
    split_pair("spec round: draft, one-layer model, K+1=5 decodes, BS=1 view",
               lambda: drafts(draft.decode_step), lambda: drafts(draft_step),
               ("paged_decode_kernel",), card)
    split_pair("prefill chunk, 256 tokens at 768",
               lambda: target.prefill_chunk(params, chunk_cache, chunk, [CHUNK]),
               lambda: chunk_step(params, chunk_cache, chunk, [CHUNK]),
               ("paged_decode_kernel",), card)


def phase8(card):
    """Phase 8: speculation, chunked prefill and preemption on full-width
    smollm-135m (float32, then bf16), the paged kernel at their shapes,
    and the host/device split of a spec round and a chunk."""
    from repro_torch.configs import get_config

    base = get_config("smollm-135m")
    launches, _ = phase8_serving(card, dataclasses.replace(base, dtype="float32"))
    torch.cuda.empty_cache()
    more, models = phase8_serving(card, base)
    launches = {k: launches[k] + more[k] for k in launches}
    phase8_split(card, models)
    del models
    torch.cuda.empty_cache()
    return launches, phase8_kernels(card)


# ---------------------------------------------------------------------------
# phase 9: the online adviser and the flight recorder

CTL_KS = (0, 2, 4, 8)  # the controller's depths: verify widths 3, 5 and 9
DRAFT_K = 8  # the model drafter's depth: a 2048 + 9 = 2057-long cache (187-key blocks)


class Scripted:
    """A duck-typed controller replaying a fixed list of depths, one a
    decision (none of them priced)."""

    def __init__(self, script, ks, interval=2):
        from repro_torch.serve import Decision

        self.make, self.script, self.ks, self.backends = Decision, list(script), tuple(ks), None
        self.decision_interval, self.window, self.initial_k = int(interval), 8, 0
        self.decisions, self.n_switches, self.dwell_remaining = [], 0, 0

    def decide(self, summary, *, k_live, backend_live, step):
        k = self.script[len(self.decisions) % len(self.script)]
        d = self.make(step=step, k=k, backend=backend_live, switched=k != k_live,
                      reason="scripted")
        self.n_switches += int(d.switched)
        self.decisions.append(d)
        return d


def phase9_kernels(card):
    """The paged kernel against its plain version at the widths a live K
    gives it: verify at T = 3 and T = 9 on the smollm paged pool (each
    query bitwise equal to a decode at its own length) and the K = 8 model
    drafter's 2057-long slot view (187-key blocks, 11 a row). Returns the
    JSON rows (bf16) keyed by shape."""
    from repro_torch.kernels import paged_decode_attention as pda

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for key, label, T, case in (
                ("paged_verify3", "verify, paged layout B=8 T=3 H=9 KV=3 hd=64 BS=16 MB=128", 3,
                 lambda: paged_case(dtype, 3)),
                ("paged_verify9", "verify, paged layout B=8 T=9 H=9 KV=3 hd=64 BS=16 MB=128", 9,
                 lambda: paged_case(dtype, 9)),
                ("paged_draft2057", "draft view B=8 T=1 Smax=2057 BS=187 MB=11", 1,
                 lambda: slot_case(dtype, B=8, Smax=2048 + DRAFT_K + 1,
                                   lengths=[0, 1, 186, 187, 1027, 2000, 2055, 2056]))):
            q, kp, vp, tables, lengths, _, _ = case()
            out = pda.paged_decode_attention(q, kp, vp, tables, lengths)
            torch.cuda.synchronize()
            ref = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths)
            err = (out.float() - ref.float()).abs().max().item()
            require(err <= TOL[dtype] and torch.isfinite(out).all(),
                    f"paged kernel ({label}, {dn}) disagrees with its plain version: {err}")
            for t in range(T if T > 1 else 0):
                dec = pda.paged_decode_attention(q[:, t : t + 1].contiguous(), kp, vp, tables,
                                                 lengths + t)
                require(torch.equal(dec[:, 0], out[:, t]), f"verify T={T} != decode at {t} ({dn})")
            ms = cuda_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths))
            plain = cuda_ms(lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lengths),
                            iters=5)
            bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
            log(f"paged_decode_attention {dn} {label} lengths={lengths.tolist()} "
                f"plan={paged_plan_of(q, kp, tables)}: max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) "
                f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) "
                f"library_ms=null" + (f"; verify (T={T}) equals {T} decodes bitwise" if T > 1 else ""))
            if dtype == torch.bfloat16:
                rows[(key, dtype)] = kernel_row(err, ms, plain, bms, by)
    return rows


def log_prime(label, primed, card):
    for backend, cells in primed["cells"].items():
        tag = " (the plain PyTorch version)" if backend == "reference" else " (the CUDA kernels)"
        log(f"prime[{label}, backend {backend}{tag}, {primed['max_batch']} rows, "
            f"{primed['layout']}] on {card}: "
            + ", ".join(f"K={k} {ms:.2f} ms" for k, ms in sorted(cells.items())))


class ControlledRuns:
    """Serves workloads through ``engine.scheduler(...).run`` with a
    ``StepLog`` on the target (and on the model drafter) and holds each
    run's launches exact: the paged kernel 30 times a decode or verify
    step (verify widths 3, 5, 9 only, each width's count the scheduler's)
    plus once a draft decode, flash 30 times a target prefill plus once a
    draft prefill, nothing else. Sums the launches at the phase's kernel
    shapes."""

    def __init__(self, target, draft=None):
        self.L = target.cfg.num_layers
        self.tlog, self.dlog = StepLog(target), StepLog(draft) if draft is not None else None
        self.launches = {"verify3": 0, "verify9": 0, "draft": 0}
        self.widths = collections.Counter()

    def run(self, label, engine, reqs, primed=True, **kw):
        """A ``primed`` run must compile nothing: the engine's families
        keep their compile counts, and ``engine.retraces`` reads 0 where
        telemetry is on."""
        tlog, dlog, L = self.tlog, self.dlog, self.L
        tlog.calls.clear()
        if dlog is not None:
            dlog.calls.clear()
        sched = engine.scheduler(8, **kw)
        c0 = compiled(engine)
        reset_launches()
        out = sched.run(reqs)
        n = read_launches()
        new = compiled(engine) - c0
        traced, widths = sched._ton, sched.widths["verify"]
        draft_seq = getattr(sched._drafter, "_max_seq", None)
        del sched  # the engine's storage goes back for the next run
        if primed:
            require(new == 0 and (not traced or retraces(engine) == 0),
                    f"{label}: a primed run captured {new} step graphs "
                    f"(engine.retraces {retraces(engine) if traced else 'off'})")
        verifies = tlog.of("verify_step_paged")
        decodes = tlog.of("decode_step_paged")
        prefills = tlog.of("prefill", "prefill_with_prefix")
        drafts = dlog.of("decode_step") if dlog is not None else []
        dprefills = dlog.of("prefill") if dlog is not None else []
        require(len(tlog.calls) == len(verifies) + len(decodes) + len(prefills),
                f"{label}: a step outside prefill/decode/verify ran")
        require(all(c[2] == L and not c[3] for c in verifies + decodes)
                and all(c[1] == 1 for c in decodes),
                f"{label}: a decode or verify step was not {L} paged launches")
        require(set(widths) <= {3, 5, 9}
                and collections.Counter(c[1] for c in verifies) == widths,
                f"{label}: verify widths {dict(widths)} outside 3, 5, 9 or not the steps run")
        require(all(c[1] == 1 and c[2] == 1 and not c[3] for c in drafts),
                f"{label}: a draft decode was not one paged launch")
        check_launches(n, {"paged": L * (len(verifies) + len(decodes)) + len(drafts),
                           "flash": L * len(prefills) + len(dprefills)}, label)
        require(not bool(tlog.bad) and (dlog is None or not bool(dlog.bad)),
                f"{label}: non-finite logits")
        require(all(r.finished and len(out[r.rid]) == r.max_new_tokens for r in reqs),
                f"{label}: not every request finished its budget")
        self.launches["verify3"] += L * widths[3]
        self.launches["verify9"] += L * widths[9]
        self.launches["draft"] += len(drafts)
        self.widths.update(widths)
        return out, {"decodes": len(decodes), "verifies": len(verifies),
                     "widths": dict(sorted(widths.items())), "drafts": len(drafts),
                     "paged": n["paged"], "flash": n["flash"], "captures": new,
                     "retraces": retraces(engine) if traced else None, "draft_seq": draft_seq}


def phase9_tokens(card, cfg, device="cuda"):
    """``cfg``: float32 full-width smollm-135m on the card; paged layout, 8 rows, ``max_seq``
    2048: the plain K = 0 stream, then a seeded scripted controller over
    ks (0, 2, 4, 8) (n-gram), the scripted 0↔4 flip with a one-layer model
    drafter built for K = 8 (its 2057-long slot cache; the catch-up
    re-prefills each live row at 0→4), static K = 4, PinnedController(4)
    (bitwise the static run) and OnlineAdviser(ks=(0, 2, 4, 8)) seeded
    from this engine's own prime; every stream equal to the plain one but
    for ties (``count_ties``), launches exact."""
    from repro_torch.models.model import Model
    from repro_torch.serve import (OnlineAdviser, PinnedController, ServingEngine, SpecConfig,
                                   make_requests)

    target, ref = Model(cfg, device), Model(cfg, device)
    params = target.init(seed=4)
    draft = Model(dataclasses.replace(cfg, num_layers=1), device)
    dparams = draft.init(seed=5)
    runs = ControlledRuns(target, draft)
    engine = ServingEngine(target, params, max_seq=2048, kv_layout="paged", block_size=16,
                           max_batch=8, device=device)
    name = f"smollm-135m {cfg.dtype} paged 8 rows"

    def work():
        return make_requests(8, 50.0, vocab=cfg.vocab_size, max_new_tokens=24,
                             prompt_lens=tuple(range(128, 513)), rng=np.random.default_rng(21))

    base_reqs = work()
    plain, info = runs.run(f"plain[{name}]", engine, base_reqs, primed=False, spec=SpecConfig(k=0))
    prompts = [np.asarray(r.prompt) for r in base_reqs]
    want = [plain[r.rid] for r in base_reqs]
    log(f"plain[{name} K=0] on {card}: {info}; p50 step {engine.stats.percentile(50):.2f} ms")
    primed = engine.prime(8, ks=CTL_KS)
    log_prime(name, primed, card)
    online = OnlineAdviser(ks=CTL_KS, backends=("kernel",), decision_interval=4, window=8)
    online.seed_costs(primed)
    script = [int(k) for k in np.random.default_rng(9).permutation(list(CTL_KS) * 2)]
    model_spec = SpecConfig(k=DRAFT_K, drafter="model", draft_model=draft, draft_params=dparams)
    static = None
    for label, spec, ctl in (
            (f"scripted n-gram {script}", SpecConfig(k=8), Scripted(script, CTL_KS)),
            ("scripted model drafter 0<->4 (cache 2057)", model_spec, Scripted([0, 4], (0, 4))),
            ("static K=4", SpecConfig(k=4), None),
            ("PinnedController(4)", SpecConfig(k=4), PinnedController(4)),
            ("OnlineAdviser(ks=(0, 2, 4, 8)) seeded from prime", None, online)):
        label = f"controlled[{name} {label}]"
        reqs = work()
        out, info = runs.run(label, engine, reqs, spec=spec, controller=ctl)
        got = [out[r.rid] for r in reqs]
        if ctl is None:
            static = got
        elif isinstance(ctl, PinnedController):
            require(all(np.array_equal(a, b) for a, b in zip(got, static)),
                    f"{label}: streams differ from the static K = 4 run")
        if ctl is not None:
            require(ctl.decisions and all(d.k in ctl.ks for d in ctl.decisions),
                    f"{label}: no decision, or a depth outside the controller's")
        if spec is not None and spec.drafter == "model":
            require(info["draft_seq"] == 2048 + DRAFT_K + 1 and info["drafts"] > 0,
                    f"{label}: the drafter's cache is not 2057 long or never drafted")
        ties = count_ties(ref, params, prompts, want, got, label)
        s = engine.stats.serving_summary()
        spec_s = s.get("speculative", {})
        log(f"{label} on {card}: {info}; decisions "
            f"{[(d.step, d.k) for d in ctl.decisions] if ctl is not None else None}; "
            f"acceptance {spec_s.get('acceptance_rate', 0.0):.3f}, p50 step "
            f"{s['p50_step_ms']:.2f} ms; {len(reqs) - ties} streams equal to plain decoding, "
            f"{ties} ties")
    require(set(runs.widths) == {3, 5, 9}, f"verify widths served {dict(runs.widths)}, not 3, 5, 9")
    return runs.launches


def phase_tpot(reqs, spans):
    """p50 TPOT (ms) of each drift phase's requests."""
    return {name: round(float(np.median([r.tpot_ms for r in reqs[a:b] if r.tpot_ms is not None]
                                         or [float("nan")])), 3)
            for name, a, b in spans}


def phase9_drift(card, cfg, device="cuda"):
    """``cfg``: bf16 full-width smollm-135m on the card; paged, 8 rows: the
    K × backend prime (both backends timed; serving keeps the kernel), the
    drifting workload under telemetry at each static K and under an
    OnlineAdviser seeded from the prime (decisions checked against
    ``drift_decisions.json``'s schema, no winner asserted), the controller
    run's trace exported under ``build/`` and validated, and step p50 with
    telemetry off and on. Returns the launches at phase 9's shapes and the
    engine."""
    from repro_torch.models.model import Model
    from repro_torch.serve import (OnlineAdviser, ServingEngine, SpecConfig, Telemetry,
                                   make_drift_requests, validate_chrome_trace)

    model = Model(cfg, device)
    params = model.init(seed=6)
    runs = ControlledRuns(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="paged", block_size=16,
                           max_batch=8, device=device)
    name = f"smollm-135m {cfg.dtype} paged 8 rows"
    primed = engine.prime(8, ks=CTL_KS, backends=("kernel", "reference"))
    log_prime(name, primed, card)

    def drift():
        return make_drift_requests(vocab=cfg.vocab_size, rng=np.random.default_rng(7))

    # warm outside the measured runs: the workload's prefill shapes
    engine.serve(drift()[0], spec=SpecConfig(k=8))
    for k in CTL_KS:
        reqs, spans = drift()
        _, info = runs.run(f"drift[{name} K={k}]", engine, reqs, spec=SpecConfig(k=k),
                           telemetry=Telemetry(enabled=True))
        s = engine.stats.serving_summary()
        log(f"drift[{name} static K={k}] on {card}: TPOT p50 by phase {phase_tpot(reqs, spans)}; "
            f"p50 step {s['p50_step_ms']:.2f} ms, acceptance "
            f"{s.get('speculative', {}).get('acceptance_rate', 0.0):.3f}; engine.retraces "
            f"{info['retraces']:g}")
    ctl = OnlineAdviser(ks=CTL_KS, backends=("kernel",))
    ctl.seed_costs(primed)
    reqs, spans = drift()
    tel = Telemetry(enabled=True)
    _, info = runs.run(f"drift[{name} OnlineAdviser]", engine, reqs, telemetry=tel, controller=ctl)
    trail = ctl.audit_trail()
    golden = json.load(open(os.path.join(ROOT, "drift_decisions.json")))["decisions"][0]
    require(trail and all(d["k"] in CTL_KS for d in trail),
            "drift: no decision, or a depth outside ks")
    require(all(set(d) == set(golden) and set(d["inputs"]) == set(golden["inputs"]) for d in trail),
            "drift: a decision's keys differ from drift_decisions.json's")
    summ = ctl.summary()
    log(f"drift[{name} OnlineAdviser] on {card}: TPOT p50 by phase {phase_tpot(reqs, spans)}; "
        f"p50 step {engine.stats.percentile(50):.2f} ms; engine.retraces {info['retraces']:g}; "
        f"{summ['decisions']} decisions, "
        f"{summ['switches']} switches, {summ['probes']} probes; first decisions "
        + json.dumps([{k: d[k] for k in ("step", "k", "switched", "probe", "reason")}
                      for d in trail[:6]], ensure_ascii=False))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "phase9_drift_trace.json")
    counts = validate_chrome_trace(tel.tracer.export(path))
    by_name = collections.defaultdict(list)
    for e in tel.tracer.events:
        if e[0] == "X":
            by_name[e[1]].append(e[4])
    log(f"trace[{name} OnlineAdviser] {os.path.relpath(path, ROOT)}: {counts}; spans "
        + ", ".join(f"{n} x{len(d)} p50 {np.median(d) / 1e3:.3f} ms" for n, d in sorted(by_name.items())))
    require(counts["async_spans"] == len(reqs) and "online-decision" in
            {e[1] for e in tel.tracer.events}, "trace: a request span or the decisions are missing")

    # telemetry off and on over the same workload: figures only
    p50 = {}
    for on in (False, True, True, False):
        engine.serve(drift()[0], spec=SpecConfig(k=4), telemetry=Telemetry(enabled=on))
        p50.setdefault("on" if on else "off", []).append(round(engine.stats.percentile(50), 3))
    log(f"telemetry[{name} drift K=4] on {card}: p50 step ms off {p50['off']}, on {p50['on']} "
        "(order off, on, on, off)")
    return runs.launches, engine


def phase9_profile(card, engine):
    """One profiled decode step and one verify step (T = 9) with
    ``profiler_annotations``: the ``serve.decode`` / ``serve.verify`` range
    must hold the step's 30 paged kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import SpecConfig, Telemetry, make_requests

    cfg, L = engine.model.cfg, engine.model.cfg.num_layers
    name = f"smollm-135m {cfg.dtype} paged 8 rows"
    for label, spec, rng_name in (("decode", SpecConfig(k=0), "serve.decode"),
                                  ("verify T=9", SpecConfig(k=8), "serve.verify")):
        sched = engine.scheduler(8, spec=spec,
                                 telemetry=Telemetry(enabled=True, profiler_annotations=True))
        for r in make_requests(8, 1e3, vocab=cfg.vocab_size, max_new_tokens=64, prompt_lens=(256,),
                               rng=np.random.default_rng(3)):
            sched.submit(r)
        sched.step(now=1.0)
        sched.step(now=1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sched.step(now=1.0)
            torch.cuda.synchronize()
        evs = prof.events()
        cuda_dev, cpu_dev = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        # the range twice: on the host, and as the device-side annotation
        # spanning the kernels launched inside it
        host = [e for e in evs if e.name == rng_name and e.device_type == cpu_dev]
        dev = [e.time_range for e in evs if e.name == rng_name and e.device_type == cuda_dev]
        paged = [e.time_range for e in evs if e.device_type == cuda_dev
                 and "paged_decode_kernel" in e.name]
        held = [t for t in paged if any(r.start <= t.start and t.end <= r.end for r in dev)]
        launches = [e for e in evs if e.device_type == cpu_dev
                    and ("LaunchKernel" in e.name or "GraphLaunch" in e.name)
                    and any(h.time_range.start <= e.time_range.start
                            and e.time_range.end <= h.time_range.end for h in host)]
        require(len(host) == 1 and len(dev) == 1 and len(paged) == L and len(held) == L,
                f"profile[{label}]: {len(host)} host and {len(dev)} device {rng_name} ranges, "
                f"{len(paged)} paged kernels, {len(held)} inside the device range")
        log(f"profile[{name} one {label} step] on {card}: {rng_name} {host[0].time_range.elapsed_us() / 1e3:.2f} "
            f"ms on the host ({len(launches)} launches inside: "
            f"{sum('GraphLaunch' in e.name for e in launches)} graph replays), "
            f"{dev[0].elapsed_us() / 1e3:.2f} ms on the device holding all {len(held)} paged kernel "
            f"launches ({sum(t.elapsed_us() for t in held) / 1e3:.3f} ms of them)")


def phase9(card):
    """Phase 9: the paged kernel at the live widths, the controlled float32
    streams, the bf16 prime, drift runs and the flight recorder."""
    from repro_torch.configs import get_config

    base = get_config("smollm-135m")
    rows = phase9_kernels(card)
    launches = phase9_tokens(card, dataclasses.replace(base, dtype="float32"))
    torch.cuda.empty_cache()
    more, engine = phase9_drift(card, base)
    phase9_profile(card, engine)
    del engine
    torch.cuda.empty_cache()
    launches = {k: launches[k] + more[k] for k in launches}
    require(all(launches.values()), f"phase 9: a kernel shape was never launched: {launches}")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 10: the compiled step families against eager serving

# model, layout, serving options: smollm-135m with K = 4 speculation and
# 256-token chunks on the paged layout; the SSM and the hybrid on slots
P10 = (("smollm-135m", "paged", {"spec": SPEC_K, "chunk_size": CHUNK}),
       ("mamba2-370m", "slot", {}), ("zamba2-2.7b", "slot", {}))


def _serve_kw(opts):
    from repro_torch.serve import SpecConfig

    kw = dict(opts)
    if "spec" in kw:
        kw["spec"] = SpecConfig(k=kw["spec"])
    return kw


def graph_pool_bytes(model):
    """Bytes of the allocator segments in the model's graph memory pool."""
    if model._graph_pool is None:
        return 0
    pool = tuple(model._graph_pool[0])
    segs = torch.cuda.memory._snapshot()["segments"]
    return sum(s["total_size"] for s in segs if tuple(s.get("segment_pool_id", ())) == pool)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def replay_delta(model, name, *args, **kwargs):
    """(max |logits| difference between a compiled step's replay and its
    eager call on the same inputs and state, the first call's ms (the eager
    warm-up and the capture), an eager call's ms): the state (every tensor
    of a cache, pool or ``into`` argument) is restored in place before each
    call."""
    fn = model.jit_step(name)
    state = [t for a in list(args[1:]) + list(kwargs.values()) if isinstance(a, dict)
             for t in _tensors(a)]
    snap = [t.clone() for t in state]

    def restore():
        for t, c in zip(state, snap):
            t.copy_(c)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    fn(*args, **kwargs)  # the warm-up and the capture
    restore()
    first = (time.perf_counter() - t0) * 1e3
    got = fn(*args, **kwargs)[0]  # a replay
    restore()
    t0 = time.perf_counter()
    want = getattr(model, name)(*args, **kwargs)[0]
    restore()
    eager = (time.perf_counter() - t0) * 1e3
    return (got.float() - want.float()).abs().max().item(), first, eager


def phase10_parity(card):
    """float32, full width: every step family's replay against its eager
    call (max |Δlogit|, held to the float32 kernel tolerance), then a
    step-clock serve of each model eagerly and graphed: the same streams
    token for token."""
    from repro_torch.configs import get_config
    from repro_torch.models import step_graph
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests
    from repro_torch.serve.kv_cache import PagedKVCache

    for arch, layout, opts in P10:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        model = Model(cfg)
        params = model.init(seed=11)
        rng = np.random.default_rng(0)
        V = cfg.vocab_size
        prompt = torch.from_numpy(rng.integers(0, V, (2, 256))).cuda()
        tok = torch.from_numpy(rng.integers(0, V, (2, 1))).cuda()
        _, cache = model.prefill(params, prompt, 512)
        d = {"prefill": replay_delta(model, "prefill", params, prompt, 512,
                                     into=model.init_cache(2, 512)),
             "decode_step": replay_delta(model, "decode_step", params, cache, tok)}
        if cfg.family == "dense":
            toks = torch.from_numpy(rng.integers(0, V, (2, SPEC_K + 1))).cuda()
            d["verify_step"] = replay_delta(model, "verify_step", params, cache, toks)
            one = model.init_cache(1, 512)
            one["len"].fill_(128)
            d["prefill_chunk"] = replay_delta(model, "prefill_chunk", params, one, toks[:1], [3])
            pk, pv = cache["k"][:, :1, :128].contiguous(), cache["v"][:, :1, :128].contiguous()
            d["prefill_with_prefix"] = replay_delta(model, "prefill_with_prefix", params,
                                                    toks[:1], pk, pv, 512, suffix_len=[4],
                                                    into=model.init_cache(1, 512))
            kv = PagedKVCache(model, 2, 512, block_size=16)
            for r in range(2):
                row, _ = kv.try_admit(r, tuple(int(t) for t in prompt[r].tolist()), 16)
                kv.write_prefill(row, model.read_cache_slot(cache, r))
                kv.ensure_tail_n(row, SPEC_K + 1)
            pool, tables, lens = kv.kernel_inputs()
            d["decode_step_paged"] = replay_delta(model, "decode_step_paged", params, pool, tables,
                                                  lens, tok)
            d["verify_step_paged"] = replay_delta(model, "verify_step_paged", params, pool, tables,
                                                  lens, toks)
        log(f"replay[{arch} float32] on {card}: max |replay - eager| logits (first call ms: "
            "the warm-up and the capture; eager call ms) "
            + ", ".join(f"{k} {v:.3e} ({a:.1f}; {b:.1f})" for k, (v, a, b) in d.items()))
        require(all(v <= TOL[torch.float32] for v, _, _ in d.values()),
                f"{arch}: a replayed step's logits differ from eager: {d}")
        kw = _serve_kw(opts)
        engine = ServingEngine(model, params, max_seq=2048, kv_layout=layout, block_size=16,
                               max_batch=8)

        def reqs():
            return make_requests(6, 50.0, vocab=V, max_new_tokens=16,
                                 prompt_lens=tuple(range(128, 513)), rng=np.random.default_rng(12))

        drive(engine.scheduler(8, **kw), reqs(), 0.01)  # the captures
        with step_graph.disabled():
            eager_reqs = reqs()
            eager = drive(engine.scheduler(8, **kw), eager_reqs, 0.01)
        graphed_reqs = reqs()
        graphed = drive(engine.scheduler(8, **kw), graphed_reqs, 0.01)
        same = sum(np.array_equal(eager[a.rid], graphed[b.rid])
                   for a, b in zip(eager_reqs, graphed_reqs))
        require(same == len(eager_reqs), f"{arch}: graphed streams differ from eager ones")
        log(f"parity[{arch} float32 {layout} {opts}] on {card}: {same} of {len(eager_reqs)} graphed "
            "streams equal to eager ones token for token")
        del engine, cache, params, model
        torch.cuda.empty_cache()


def host_split(card):
    """The host time of one eager full-width smollm-135m decode step (bf16,
    8 paged rows) by op, from the CPU-side ``torch.profiler``: each op's
    own time, most first, and what lies outside every op (Python, the
    kernels' ctypes calls)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config("smollm-135m")
    model, _, decode = time_split(Model(cfg).init(seed=0), card)
    for _ in range(3):
        decode(model.decode_step_paged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        decode(model.decode_step_paged)
        host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    avgs = [a for a in prof.key_averages() if a.self_cpu_time_total > 0]
    ops = sum(a.self_cpu_time_total for a in avgs) / 1e3
    top = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)[:12]
    log(f"host[smollm-135m bf16 one eager decode step, 8 paged rows] on {card}: {host:.2f} ms on "
        f"the host, {ops:.2f} ms inside {sum(a.count for a in avgs)} profiled ops, "
        f"{host - ops:.2f} ms outside them; by op: "
        + ", ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.2f} ms x{a.count}" for a in top))


# phase 10's serving workload, small enough that the whole script, training
# included, fits its time limit on a slow host
P10_REQUESTS, P10_NEW = 8, 32


def phase10_serving(card):
    """bf16, full width: each model of ``P10`` serves ``make_requests``
    (``P10_REQUESTS`` open-loop requests, 128-1024-token prompts,
    ``P10_NEW`` new tokens, 8 rows)
    once to capture its shapes, then eagerly (``step_graph.disabled()``)
    and graphed on the same requests: TTFT, TPOT and step p50/p99 side by
    side, the captures, the graph pool's bytes; then each model's decode
    step and 1024-token prefill, eager and graphed (wall, device busy,
    idle share)."""
    from repro_torch.configs import get_config
    from repro_torch.models import step_graph
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests

    keys = ("p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms", "p99_tpot_ms", "p50_step_ms",
            "p99_step_ms")
    for arch, layout, opts in P10:
        cfg = get_config(arch)
        model = Model(cfg)
        params = model.init(seed=10)
        kw = _serve_kw(opts)
        engine = ServingEngine(model, params, max_seq=2048, kv_layout=layout, block_size=16,
                               max_batch=8)

        def reqs():
            return make_requests(P10_REQUESTS, 20.0, vocab=cfg.vocab_size,
                                 max_new_tokens=P10_NEW, prompt_lens=tuple(range(128, 1025)),
                                 rng=np.random.default_rng(10))

        t0 = time.perf_counter()
        if "chunk_size" in kw:
            engine.scheduler(8, **kw).prime()
        engine.serve(reqs(), **kw)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        caps = compiled(engine)
        pool = graph_pool_bytes(model)
        rows = {}
        for mode in ("eager", "graphed"):
            c0 = compiled(engine)
            with step_graph.disabled() if mode == "eager" else contextlib.nullcontext():
                out = engine.serve(reqs(), **kw)
            s = engine.stats.serving_summary()
            require(s["n_requests"] == len(out) == P10_REQUESTS,
                    f"{arch} {mode}: not every request finished")
            rows[mode] = {k: round(s[k], 3) for k in keys}
            rows[mode]["captures"] = compiled(engine) - c0
        label = f"{arch} bf16 {layout} {opts}, 8 rows"
        log(f"serve[{label}] on {card}: eager {json.dumps(rows['eager'])}")
        log(f"serve[{label}] on {card}: graphed {json.dumps(rows['graphed'])}")
        log(f"serve[{label}] on {card}: eager/graphed p50 step "
            f"{rows['eager']['p50_step_ms'] / rows['graphed']['p50_step_ms']:.2f}x, p50 TPOT "
            f"{rows['eager']['p50_tpot_ms'] / rows['graphed']['p50_tpot_ms']:.2f}x, p50 TTFT "
            f"{rows['eager']['p50_ttft_ms'] / rows['graphed']['p50_ttft_ms']:.2f}x; the capture "
            f"run {warm:.1f} s made {caps} graphs; graph pool {pool / 2**20:.0f} MiB")
        if "chunk_size" in kw:  # no prefill shape depends on arrival timing
            require(rows["graphed"]["captures"] == 0,
                    f"{arch}: the primed graphed run captured {rows['graphed']['captures']} graphs")
        del engine, params, model
        torch.cuda.empty_cache()
    host_split(card)
    for arch, kernels in (("mamba2-370m", ("ssd_scan_kernel",)),
                          ("zamba2-2.7b", ("ssd_scan_kernel", "flash_kernel", "paged_decode_kernel"))):
        time_split_slots(arch, Model(get_config(arch)).init(seed=0), card, kernels)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the int8 paged pool and the three dense configs at full width

# arch, depth of the float32 parity and bf16-against-float32 runs (None:
# full depth): the float32 plain path of a full-depth 14B or 20B model would
# not fit the card beside the kernels'
P11 = (("stablelm-3b", None), ("phi3-medium-14b", 4), ("internlm2-20b", 4))
# phases 11-12 serve each config in bf16 at this depth, to keep the script
# within its time limit (a layer's shapes, and so the kernels' launches at
# each shape, do not depend on it)
SERVE_DEPTH = 8
P11_PREFIX = 512  # stablelm's shared prefix in the speculative, chunked run


def paged_row(key, label, T, args, dtype, rows):
    """One paged-kernel case against its plain version: an int8 pool held
    per row (``INT8_TOL``; a 256-query chunk also at the row's start and
    its end), a float pool to ``TOL``; at T = 5 each query bitwise a decode;
    timed beside its bound. Its bf16 row goes to ``rows[(key, dtype)]``."""
    from repro_torch.kernels import paged_decode_attention as pda

    dn = str(dtype).split(".")[-1]
    q, kp, vp, tables, lengths = args[:5]
    int8 = kp.dtype == torch.int8
    out = pda.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pda.plain_paged_decode_attention(*args)
    if int8:
        rel, absol = INT8_TOL[dtype]
        err, worst = row_check(out, ref, rel, absol)
        if T == 256:  # the chunk at the row's start and at its end too
            for start in (0, 2048 - 256):
                at = torch.full_like(lengths, start)
                e, w = row_check(pda.paged_decode_attention(q, kp, vp, tables, at, *args[5:]),
                                 pda.plain_paged_decode_attention(q, kp, vp, tables, at,
                                                                  *args[5:]), rel, absol)
                err, worst = max(err, e), max(worst, w)
        tol_text = f"per row <= {rel:.3g}*max|plain|+{absol:.0e}; worst err/tol {worst:.3e}"
        ok = worst <= 1.0
    else:
        err = (out.float() - ref.float()).abs().max().item()
        tol_text, ok = f"tol {TOL[dtype]:.0e}", err <= TOL[dtype]
    require(ok and torch.isfinite(out).all(),
            f"paged kernel ({label}, {dn}) disagrees with its plain version: {err}")
    extra = ""
    if T == 5:
        for t in range(T):
            dec = pda.paged_decode_attention(q[:, t : t + 1].contiguous(), kp, vp, tables,
                                             lengths + t, *args[5:])
            require(torch.equal(dec[:, 0], out[:, t]),
                    f"{label}: verify != decode at query {t} ({dn})")
        extra = "; verify (T=5) equals 5 decodes bitwise"
    ms = cuda_ms(lambda: pda.paged_decode_attention(*args))
    plain = cuda_ms(lambda: pda.plain_paged_decode_attention(*args), iters=5)
    bms, by = bound(work.paged(q, kp, tables, lengths), dtype)
    log(f"paged_decode_attention{'[int8]' if int8 else ''} {dn} {label} "
        f"lengths={lengths.tolist()} plan={paged_plan_of(q, kp, tables)}: "
        f"max_abs_err={err:.3e} ({tol_text}) ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
        f"bound_ms={bms:.5f} ({by}) library_ms=null{extra}")
    if dtype == torch.bfloat16:
        rows[(key, dtype)] = kernel_row(err, ms, plain, bms, by)


def flash_prefill_row(key, arch, H, KV, hd, dtype, rows, B=1, S=1024):
    """Causal flash at a config's serving prefill against its plain
    version (bf16 on ``wgmma``, checked and timed beside the CUDA-core
    kernel and SDPA). Its bf16 row goes to ``rows[(key, dtype)]``."""
    from repro_torch.kernels import flash_attention as fa

    dn = str(dtype).split(".")[-1]
    q, k, v = flash_case(dtype, S, S, B=B, H=H, KV=KV, hd=hd)
    out = fa.flash_attention(q, k, v, 0)
    torch.cuda.synchronize()
    ref = fa.plain_flash_attention(q, k, v, 0)
    label = f"flash_attention {dn} {arch} prefill B={B} S={S} H={H} KV={KV} hd={hd}"
    err, text = flash_check(out, ref, dtype, label)
    plan = fa.flash_plan(dtype, B, S, H, KV, hd)
    if dtype == torch.bfloat16:
        require(plan["path"] == "wgmma", f"{label}: path {plan['path']}, not wgmma")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, 0))
    plain = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, 0), iters=5)
    bms, by = bound(work.flash(q, k, 0), dtype)
    lib = sdpa_ms(q, k, v, 0)
    log(f"{label} plan={plan}: {text} ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
        f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}"
        + cuda_core_flash(q, k, v, 0, True, plan["path"]))
    if dtype == torch.bfloat16:
        rows[(key, dtype)] = kernel_row(err, ms, plain, bms, by, lib)


def phase11_kernels(card):
    """The paged kernel and flash at the shapes the three configs give
    them, float32 and bf16, each against its plain version: the int8 mode
    on stablelm-3b's pool (H = KV = 32, hd 80, BS 16) at T = 1, T = 5 (each
    query bitwise a decode) and a 256-query chunk over a 256-key identity
    view (at 768, 0 and 1792); float pools at phi3-medium-14b's (H 40, KV
    10) and internlm2-20b's (H 48, KV 8) hd-128 heads at T = 1 and T = 5
    (bitwise); causal flash at each config's serving prefill (B = 1, S =
    1024; bf16 at hd 128 on wgmma, timed beside the CUDA-core kernel and
    SDPA) and non-causal at hd 128 (B = 2, S = 512, phi3's heads), the
    latter driven once through ``kernels.ops.flash_attention`` first.
    Returns the JSON rows (bf16) and the non-causal entry launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops

    rows = {}
    heads = {"stablelm": (32, 32, 80), "phi3": (40, 10, 128), "internlm2": (48, 8, 128)}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        cases = [("p11_int8", "stablelm-3b int8 pool B=8 T=1 H=32 KV=32 hd=80 BS=16 MB=128", 1,
                  lambda: paged_case(dtype, 1, H=32, KV=32, hd=80, int8=True)),
                 ("p11_int8_verify", "stablelm-3b int8 pool B=8 T=5 H=32 KV=32 hd=80 BS=16 MB=128",
                  5, lambda: paged_case(dtype, 5, H=32, KV=32, hd=80, int8=True)),
                 ("p11_int8_chunk", "stablelm-3b int8 chunk view B=1 T=256 H=32 KV=32 hd=80 BS=256 "
                  "MB=8 (lengths 768; 0; 1792)", 256,
                  lambda: slot_case(dtype, B=1, T=256, H=32, KV=32, hd=80, lengths=[768],
                                    int8=True))]
        for arch in ("phi3", "internlm2"):
            H, KV, hd = heads[arch]
            for T in (1, 5):
                cases.append((f"p11_{arch}" + ("_verify" if T > 1 else ""),
                              f"{arch} pool B=8 T={T} H={H} KV={KV} hd={hd} BS=16 MB=128", T,
                              lambda H=H, KV=KV, hd=hd, T=T: paged_case(dtype, T, H=H, KV=KV,
                                                                       hd=hd)))
        for key, label, T, case in cases:
            paged_row(key, label, T, case(), dtype, rows)
        for arch, (H, KV, hd) in heads.items():
            flash_prefill_row(f"p11_flash_{arch}", arch, H, KV, hd, dtype, rows)

        # non-causal at hd 128: the entry point first (bf16), then the checks
        H, KV, hd = heads["phi3"]
        q, k, v = flash_case(dtype, 512, 512, B=2, H=H, KV=KV, hd=hd)
        entry = 0
        if dtype == torch.bfloat16:
            torch.cuda.synchronize()
            reset_launches()
            got = kernel_ops.flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            n = read_launches()
            require({kk: vv for kk, vv in n.items() if vv} == {"flash_noncausal": 1},
                    f"ops.flash_attention(causal=False) at hd 128 launched {n}")
            entry = n["flash_noncausal"]
            del got
        out = fa.flash_attention(q, k, v, 0, causal=False)
        torch.cuda.synchronize()
        ref = fa.plain_flash_attention(q, k, v, 0, causal=False)
        label = f"flash_attention[non-causal] {dn} B=2 S=512 H={H} KV={KV} hd={hd}"
        err, text = flash_check(out, ref, dtype, label)
        plan = fa.flash_plan(dtype, 2, 512, H, KV, hd)
        if dtype == torch.bfloat16:
            require(plan["path"] == "wgmma", f"{label}: path {plan['path']}, not wgmma")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, 0, causal=False))
        plain = cuda_ms(lambda: fa.plain_flash_attention(q, k, v, 0, causal=False), iters=5)
        bms, by = bound(work.flash(q, k, causal=False), dtype)
        lib = sdpa_ms(q, k, v, 0, causal=False)
        log(f"{label} plan={plan}: {text} ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} "
            f"bound_ms={bms:.5f} ({by}) library_ms={fmt_ms(lib)}"
            + cuda_core_flash(q, k, v, 0, False, plan["path"]))
        if dtype == torch.bfloat16:
            rows[("p11_flash_noncausal", dtype)] = kernel_row(err, ms, plain, bms, by, lib)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return rows, entry


def patch_embeds(cfg, n, seed):
    """``n`` seeded VLM patch embeddings [P, D] (numpy float32)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
            for _ in range(n)]


def serving_requests(cfg, shared):
    """Phases 11-12's bf16 workload: 12 open-loop requests (20 a second)
    with 128-1024-token prompts and at most 32 new tokens (a VLM's
    128-768 tokens after its 256 seeded patch rows); ``shared``: each
    prompt a 128-512-token tail after one 512-token prefix."""
    from repro_torch.serve import Request, make_requests

    rng = np.random.default_rng(21)
    vlm = cfg.family == "vlm"
    lens = range(128, 513) if shared else range(128, 1025 - cfg.n_frontend_tokens)
    reqs = make_requests(12, 20.0, vocab=cfg.vocab_size, max_new_tokens=32,
                         prompt_lens=tuple(lens), rng=rng)
    if vlm:
        for r, pe in zip(reqs, patch_embeds(cfg, len(reqs), 22)):
            r.patch_embeds = pe
    if not shared:
        return reqs
    prefix = rng.integers(0, cfg.vocab_size, size=(P11_PREFIX,)).astype(np.int32)
    return [Request(prompt=np.concatenate([prefix, r.prompt]), max_new_tokens=r.max_new_tokens,
                    arrival_time=r.arrival_time) for r in reqs]


def _wo_ulp(params, up):
    """Every attention output projection (``wo``) one float32 ulp up, or
    back down (``up`` False): bitwise the weights it started from."""
    wo = params["layers"]["attn"]["wo"]
    wo.copy_(torch.nextafter(wo, torch.full_like(wo, math.inf if up else -math.inf)))


def _first_parts(want, got):
    """Per stream pair, the first token index where they differ (None if
    equal)."""
    out = []
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            out.append(None)
        else:
            out.append(int(np.argmax(a != b)) if len(a) == len(b) else min(len(a), len(b)))
    return out


def parity_serve_f32(card, arch, layers=None, layouts=("paged",), runs=(("plain", {}),),
                     shared=True, cfg=None, device="cuda"):
    """float32 at full width (``layers``: depth cut): served through the
    plain reference backend and through the kernels on each layout, on a
    step clock (``drive``: both runs admit and batch alike), graphed, 4
    open-loop requests (a VLM's with seeded patch embeddings) and, with
    ``shared``, a pair sharing a 128-token prefix (a prefix hit: an int8
    pool dequantizes the chain), once for each of ``runs`` (label, serve
    options): the same greedy tokens, or a tie (the reference run's own
    top-2 margin under ``LOGIT_TIE_TOL``, ``MarginLog``).

    An int8 cache rounds each new row to codes: where two paths' values
    differ by float32 ulps, some round a code apart, and later layers carry
    that to the logits. So an int8 config is also served teacher-forced
    onto the reference run's tokens, through the kernels and through a
    witness: the reference backend with every ``wo`` one float32 ulp up
    (``_wo_ulp``), the same plain path a rounding apart. Each run keeps its
    own codes. Token by token, the kernel run's largest |logit - reference
    logit| must stay within ``INT8_WITNESS_RATIO`` of the witness's, and
    every stream where the free kernel run parts from the reference must
    part where the reference's top-2 margin is under twice the forced
    kernel run's distance there (the distance explains the swap). Where
    the witness served freely parts from the reference is printed beside.
    ``cfg`` and ``device`` replace the config and the card for a rehearsal
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests, make_shared_prefix_requests

    cfg = dataclasses.replace(cfg or get_config(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device)
    params = model.init(seed=1)
    pes = patch_embeds(cfg, 4, 9) if cfg.family == "vlm" else None
    quant = cfg.kv_quant

    def workload():
        reqs = make_requests(4, 50.0, vocab=cfg.vocab_size, max_new_tokens=16,
                             prompt_lens=tuple(range(64, 257)), rng=np.random.default_rng(3))
        for r, pe in zip(reqs, pes or ()):
            r.patch_embeds = pe
        if shared:
            pair = make_shared_prefix_requests(2, 50.0, vocab=cfg.vocab_size, prefix_len=128,
                                               suffix_len=40, max_new_tokens=16,
                                               rng=np.random.default_rng(4))
            for r in pair:
                r.arrival_time += 0.1  # after the open-loop ones, one after the other
            reqs += pair
        return reqs

    def serve(engine, kw, backend, force=None):
        """One run: (requests, streams, the run's ``MarginLog``)."""
        reqs = workload()
        sched = engine.scheduler(4, attention_backend=backend, spec=kw.get("spec"),
                                 chunk_size=kw.get("chunk_size"))
        tl = MarginLog(sched, keep=quant,
                       force=None if force is None else {r.rid: f for r, f in zip(reqs, force)})
        out = drive(sched, reqs, 0.005)
        return reqs, [out[r.rid] for r in reqs], tl

    depth = f" depth {layers}" if layers else ""
    for layout in layouts:
        engine = ServingEngine(model, params, max_seq=768 if pes else 512,
                               kv_layout=layout, block_size=16, max_batch=4, device=device)
        for label, opts in runs:
            kw = _serve_kw(opts)
            reqs, want, ref = serve(engine, kw, "reference")
            kreqs, got, _ = serve(engine, kw, "kernel")
            hits = [r.prefix_hit for r in kreqs]
            if shared:
                require(hits[-1] >= 128, f"{arch}: the shared-prefix pair did not hit ({hits})")
            name = f"{arch}{depth} {layout}{' int8' if quant else ''} {label}"
            margins = [ref.of(r) for r in reqs]
            if not quant:
                prompts = [np.asarray(r.prompt) for r in reqs]
                ties = count_ties(model, params, prompts, want, got,
                                  f"{arch} {layout} {label}: kernel and reference", margins=margins)
                log(f"parity[{name}] float32 kernel vs reference on {card}: "
                    f"{len(prompts) - ties} streams identical, {ties} ties (top-2 margin < "
                    f"{LOGIT_TIE_TOL:g}); prefix hits {hits} tokens")
                continue
            _wo_ulp(params, True)
            try:
                _, wfree, _ = serve(engine, kw, "reference")
                wreqs, _, wit = serve(engine, kw, "reference", force=want)
            finally:
                _wo_ulp(params, False)
            freqs, _, forced = serve(engine, kw, "kernel", force=want)
            dist = {}
            for tag, rs, tl in (("kernel", freqs, forced), ("witness", wreqs, wit)):
                d = []
                for r, q in zip(reqs, rs):
                    a, b = ref.logits_of(r), tl.logits_of(q)
                    require(a.keys() == b.keys(), f"{name}: the {tag} run, forced onto the "
                            "reference's tokens, sampled other positions")
                    d.append({i: float((b[i] - a[i]).abs().max()) for i in a})
                dist[tag] = d
            dk = max(max(d.values()) for d in dist["kernel"])
            dw = max(max(d.values()) for d in dist["witness"])
            require(dk <= INT8_WITNESS_RATIO * dw,
                    f"{name}: the forced kernel run's logits lie {dk:.3e} from the reference's, "
                    f"more than {INT8_WITNESS_RATIO:g} x the ulp witness's {dw:.3e}")
            parts, wparts, ties = _first_parts(want, got), _first_parts(want, wfree), 0
            notes = []
            for i, p in enumerate(parts):
                if p is None:
                    continue
                m, d = margins[i][p], dist["kernel"][i][p]
                require(m < max(LOGIT_TIE_TOL, 2 * d),
                        f"{name}: tokens differ at {p} of stream {i} (margin {m:.2e}), more than "
                        f"twice the forced kernel run's distance there ({d:.2e})")
                ties += m < LOGIT_TIE_TOL
                notes.append(f"stream {i} at token {p} (reference margin {m:.2e}, forced kernel "
                             f"distance {d:.2e}, witness {dist['witness'][i][p]:.2e}; the free "
                             f"witness parts there: {wparts[i] == p})")
            log(f"parity[{name}] float32 kernel vs reference on {card}: "
                f"{parts.count(None)} streams identical, {ties} ties (top-2 margin < "
                f"{LOGIT_TIE_TOL:g}), {len(notes)} parted: {'; '.join(notes) or 'none'}; "
                f"forced onto the reference's tokens, max |dlogit| kernel {dk:.3e}, ulp witness "
                f"{dw:.3e} (ratio {dk / dw:.3f}, limit {INT8_WITNESS_RATIO:g}); the free witness "
                f"parts in {len(wparts) - wparts.count(None)} streams at {wparts}; prefix hits "
                f"{hits} tokens")
        del engine
    del params, model


def phase11_parity(card, arch, layers, cfg=None, device="cuda"):
    """float32 at full width (``layers``: depth cut): served through the
    kernels and through the plain reference backend on the paged layout,
    4 open-loop requests and a pair sharing a 128-token prefix (a prefix
    hit: an int8 pool dequantizes the chain): the same greedy tokens, or a
    tie. ``cfg`` and ``device`` replace the config and the card for a
    rehearsal on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests, make_shared_prefix_requests

    cfg = dataclasses.replace(cfg or get_config(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device)
    params = model.init(seed=1)
    engine = ServingEngine(model, params, max_seq=512, kv_layout="paged", block_size=16,
                           max_batch=4, device=device)
    streams, hits = {}, {}
    for backend in ("kernel", "reference"):
        reqs = (make_requests(4, 50.0, vocab=cfg.vocab_size, max_new_tokens=16,
                              prompt_lens=tuple(range(64, 257)), rng=np.random.default_rng(3))
                + make_shared_prefix_requests(2, 50.0, vocab=cfg.vocab_size, prefix_len=128,
                                              suffix_len=40, max_new_tokens=16,
                                              rng=np.random.default_rng(4)))
        for r in reqs[4:]:
            r.arrival_time += 0.1  # after the open-loop ones, one after the other
        out = engine.serve(reqs, attention_backend=backend)
        streams[backend] = [out[r.rid] for r in reqs]
        hits[backend] = [r.prefix_hit for r in reqs]
    require(hits["kernel"][-1] >= 128, f"{arch}: the shared-prefix pair did not hit ({hits})")
    prompts = [np.asarray(r.prompt) for r in reqs]
    ties = count_ties(model, params, prompts, streams["reference"], streams["kernel"],
                      f"{arch} paged: kernel and reference")
    depth = f" depth {layers}" if layers else ""
    log(f"parity[{arch}{depth} paged{' int8' if cfg.kv_quant else ''}] float32 kernel vs "
        f"reference on {card}: {len(prompts) - ties} streams identical, {ties} ties (top-2 margin "
        f"< {LOGIT_TIE_TOL:g}); prefix hits {hits['kernel']} tokens")
    del engine, params, model


def serve_bf16(card, arch, layers=None, cfg=None, device="cuda"):
    """bf16 at full width (``layers``: depth cut): ``arch`` served on the
    paged layout (8 rows, ``max_seq`` 2048) through
    ``ServingEngine.serve()`` (``serving_requests``), plain and, for the
    families that speculate, with K = 4 n-gram speculation (an int8 pool's
    with ``chunk_size`` 256 and a shared 512-token prefix), each served
    once to capture, then primed under telemetry (which arms the
    scheduler's count of captures): the primed run captures nothing
    (``engine.retraces`` 0) and its launches are exact: a decode or verify
    step the paged kernel once a layer (int8 mode for an int8 pool, no
    float-pool launch), a prefill flash once a layer, a chunk the paged
    kernel once a layer and no flash. Then the decode-step and prefill
    walls against device time, and the peak memory after ``init`` and
    after serving. Returns the launches at the phase kernel shapes.
    ``cfg`` and ``device`` replace the config and the card for a rehearsal
    on the CPU (no timing, no memory)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import SPEC_FAMILIES, Model
    from repro_torch.serve import ServingEngine, SpecConfig, Telemetry

    cfg = cfg or get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        arch = f"{arch} (depth {layers})"
    L, quant = cfg.num_layers, cfg.kv_quant
    gib = 2.0**30
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in _tensors(params))
    if on_card:
        torch.cuda.synchronize()
        log(f"memory[{arch} bf16] on {card}: init {time.perf_counter() - t0:.1f} s, "
            f"{n_params / 1e9:.2f} B parameters, max_memory_allocated after init "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (allocated "
            f"{torch.cuda.memory_allocated() / gib:.2f} GiB)")
        torch.cuda.reset_peak_memory_stats()  # the serving peak from here
    watch = StepLog(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="paged", block_size=16,
                           max_batch=8, device=device)
    spec_kw = {"spec": SpecConfig(k=SPEC_K)}
    if quant:
        spec_kw["chunk_size"] = CHUNK
    modes = (("plain", {}, False), (f"K={SPEC_K}" + (f" chunk {CHUNK} shared prefix" if quant
                                                      else ""), spec_kw, quant))
    if cfg.family not in SPEC_FAMILIES:
        modes = modes[:1]
    shape = {"decode": 0, "verify": 0, "chunk": 0, "flash": 0}
    key_paged = "paged_int8" if quant else "paged"
    for label, kw, shared in modes:
        t0 = time.perf_counter()
        if "chunk_size" in kw:
            engine.scheduler(8, **kw).prime()
        engine.serve(serving_requests(cfg, shared), **kw)  # the captures
        if on_card:
            torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        caps = compiled(engine)
        watch.calls.clear()
        reset_launches()
        reqs = serving_requests(cfg, shared)
        out = engine.serve(reqs, telemetry=Telemetry(enabled=True), **kw)
        n = read_launches()
        tag = f"{arch} bf16 paged {label}, 8 rows"
        s = headline(tag, engine.stats, card)
        require(compiled(engine) == caps and retraces(engine) == 0,
                f"{tag}: the primed run captured {compiled(engine) - caps} graphs "
                f"(engine.retraces {retraces(engine)})")
        steps = watch.of("decode_step_paged", "verify_step_paged")
        prefills = watch.of("prefill", "prefill_with_prefix")
        chunks = watch.of("prefill_chunk")
        step_paged = [c[4] if quant else c[2] for c in steps + chunks]
        other_paged = [c[2] if quant else c[4] for c in steps + chunks]
        require(steps and all(p == L for p in step_paged) and not any(other_paged)
                and not any(c[3] for c in steps + chunks),
                f"{tag}: a decode, verify or chunk step was not {L} {key_paged} launches "
                "(and nothing else)")
        require(all(c[3] == L and not c[2] and not c[4] for c in prefills),
                f"{tag}: a prefill was not {L} flash launches")
        require(len(watch.calls) == len(steps) + len(prefills) + len(chunks),
                f"{tag}: an unexpected step ran")
        check_launches(n, {key_paged: L * (len(steps) + len(chunks)), "flash": L * len(prefills)},
                       tag)
        require(not bool(watch.bad), f"{tag}: non-finite logits")
        require(s["n_requests"] == len(out) == 12 and all(len(t) > 0 for t in out.values()),
                f"{tag}: not every request finished with tokens")
        widths = collections.Counter(c[1] for c in steps)
        if shared:
            require(any(r.prefix_hit >= P11_PREFIX for r in reqs) and chunks and not prefills,
                    f"{tag}: no prefix hit, or a monolithic prefill ran")
        shape["decode"] += L * widths[1]
        shape["verify"] += L * widths[SPEC_K + 1]
        shape["chunk"] += L * sum(1 for c in chunks if c[1] == CHUNK)
        shape["flash"] += L * len(prefills)
        log(f"serve[{tag}] on {card}: the capture run {warm:.1f} s made {caps} graphs in all; "
            f"primed run: 0 captures, engine.retraces 0; {len(steps)} steps at T "
            f"{dict(sorted(widths.items()))}, {len(chunks)} chunks, {len(prefills)} prefills; "
            f"launches {key_paged} {n[key_paged]} = {L} x {len(steps) + len(chunks)}, flash "
            f"{n['flash']} = {L} x {len(prefills)}; prefix hits "
            f"{sum(r.prefix_hit > 0 for r in reqs)} of {len(reqs)}"
            + (f"; acceptance {s['speculative']['acceptance_rate']:.3f}" if "spec" in kw else ""))
    if not on_card:
        return shape
    log(f"memory[{arch} bf16] on {card}: max_memory_allocated while serving (from after init) "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (allocated "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB); graph pool "
        f"{graph_pool_bytes(model) / 2**20:.0f} MiB")
    del engine, watch, model
    gc.collect()
    torch.cuda.empty_cache()
    split_model, kv, decode = time_split(params, card, arch, cfg)
    del split_model, kv, decode, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory[{arch}] freed: memory_allocated {torch.cuda.memory_allocated() / gib:.2f} GiB")
    return shape


def phase11(card):
    """Phase 11: the paged kernel's int8 mode and flash at hd 128 at the
    three dense configs' shapes; float32 kernel-against-plain parity and
    bf16 against float32 (depth 4 for the 14B and 20B models); each config
    served in bf16 at full width, ``SERVE_DEPTH`` layers."""
    rows, entry = phase11_kernels(card)
    for arch, layers in P11:
        phase11_parity(card, arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        parity_bf16(arch, layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {}
    for arch, _ in P11:
        shape = serve_bf16(card, arch, SERVE_DEPTH)
        name = arch.split("-")[0]
        if arch == "stablelm-3b":
            launches.update(p11_int8=shape["decode"], p11_int8_verify=shape["verify"],
                            p11_int8_chunk=shape["chunk"])
        else:
            launches.update({f"p11_{name}": shape["decode"], f"p11_{name}_verify": shape["verify"]})
        launches[f"p11_flash_{name}"] = shape["flash"]
    require(all(launches.values()), f"phase 11: a kernel shape was never launched: {launches}")
    return rows, launches, entry


# ---------------------------------------------------------------------------
# phase 12: the MoE, vlm and audio families

# (arch, depth cut, layouts, runs, shared-prefix pair) of the float32 parity;
# dbrx-132b at depth 2: its float32 copy is ~526 GB at full depth
P12_PARITY = (("granite-moe-1b-a400m", None, ("slot", "paged"), (("plain", {}),), False),
              ("internvl2-2b", None, ("paged",), (("plain", {}), (f"K={SPEC_K}", {"spec": SPEC_K})),
               False),
              ("musicgen-large", None, ("paged",), ((f"chunk {CHUNK}", {"chunk_size": CHUNK}),),
               True),
              ("dbrx-132b", 2, ("paged",), (("plain", {}),), False))
# (arch, depth cut) of the bf16 serving; dbrx-132b (131.6 B parameters, 263
# GB in bf16) at depth 4: 14.3 B, 28.6 GB
P12_SERVE = (("granite-moe-1b-a400m", SERVE_DEPTH), ("internvl2-2b", SERVE_DEPTH),
             ("musicgen-large", SERVE_DEPTH), ("dbrx-132b", 4))


def phase12_kernels(card):
    """The paged kernel and flash at the shapes the four configs give
    them, float32 and bf16, each against its plain version: float pools
    at g = 2 (granite-moe-1b-a400m's H 16 over KV 8 at hd 64, T = 1;
    internvl2-2b's at hd 128, T = 1 and T = 5, each verify query bitwise a
    decode); the int8 mode on musicgen-large's pool (H = KV = 32, hd 64,
    BS 16) at T = 1, T = 5 (bitwise) and a 256-query chunk over a 256-key
    identity view (at 768, 0 and 1792); causal flash at each config's
    serving prefill (B = 1, S = 1024: internvl2's 256 patch rows and 768
    tokens). dbrx-132b's heads (48 over 8, hd 128) are internlm2-20b's,
    phase 11's rows. Returns the JSON rows (bf16)."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [
            ("p12_granite", "granite-moe-1b-a400m pool B=8 T=1 H=16 KV=8 hd=64 BS=16 MB=128", 1,
             lambda: paged_case(dtype, 1, H=16, KV=8, hd=64)),
            ("p12_internvl2", "internvl2-2b pool B=8 T=1 H=16 KV=8 hd=128 BS=16 MB=128", 1,
             lambda: paged_case(dtype, 1, H=16, KV=8, hd=128)),
            ("p12_internvl2_verify", "internvl2-2b pool B=8 T=5 H=16 KV=8 hd=128 BS=16 MB=128", 5,
             lambda: paged_case(dtype, 5, H=16, KV=8, hd=128)),
            ("p12_int8", "musicgen-large int8 pool B=8 T=1 H=32 KV=32 hd=64 BS=16 MB=128", 1,
             lambda: paged_case(dtype, 1, H=32, KV=32, hd=64, int8=True)),
            ("p12_int8_verify", "musicgen-large int8 pool B=8 T=5 H=32 KV=32 hd=64 BS=16 MB=128",
             5, lambda: paged_case(dtype, 5, H=32, KV=32, hd=64, int8=True)),
            ("p12_int8_chunk", "musicgen-large int8 chunk view B=1 T=256 H=32 KV=32 hd=64 "
             "BS=256 MB=8 (lengths 768; 0; 1792)", 256,
             lambda: slot_case(dtype, B=1, T=256, H=32, KV=32, hd=64, lengths=[768], int8=True))]
        for key, label, T, case in cases:
            paged_row(key, label, T, case(), dtype, rows)
        for name, arch, (H, KV, hd) in (("granite", "granite-moe-1b-a400m", (16, 8, 64)),
                                        ("musicgen", "musicgen-large", (32, 32, 64)),
                                        ("internvl2", "internvl2-2b", (16, 8, 128))):
            flash_prefill_row(f"p12_flash_{name}", arch, H, KV, hd, dtype, rows)
        torch.cuda.empty_cache()
    return rows


def moe_plain(x, params, gates, idx, keep):
    """The MoE layer without its dispatch buffers: every expert's FFN on
    every token, then each token's kept choices gate-weighted (``keep``
    [T*k]: the dispatch's kept assignments)."""
    import torch.nn.functional as F

    T, k = idx.shape
    E = params["we1"].shape[0]
    xe = x[None].expand(E, T, x.shape[1])
    y = torch.bmm(F.silu(torch.bmm(xe, params["we1"])) * torch.bmm(xe, params["we3"]),
                  params["we2"])  # [E, T, D]
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w.scatter_(1, idx, gates * keep.view(T, k))
    return torch.einsum("etd,te->td", y, w.to(y.dtype))


def phase12_moe(card):
    """``moe_block`` on the card at granite-moe-1b-a400m's and dbrx-132b's
    widths (seeded random layer, seeded inputs), T = 8 (a decode step of 8
    rows) and T = 1024 (a prefill): the bf16 layer's output no further from
    the float32 layer's (same weights and inputs, upcast; the same routing,
    required) than ``E2E_BF16_RATIO`` times the bf16 plain version's
    (``moe_plain``), then its capacity, dropped share and device time by
    part (route, dispatch, expert products, combine) beside the whole
    layer, the plain version and the bound (the kept assignments' FFN and
    the used experts' weights)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    for arch in ("granite-moe-1b-a400m", "dbrx-132b"):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(7)
        p = moe.init_moe(cfg, torch.bfloat16, gen)
        p32 = {name: leaf.float() for name, leaf in p.items()}
        E, k, D, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
        for T in (8, 1024):
            x = torch.randn((T, D), generator=gen, device="cuda").bfloat16()
            C = moe.moe_capacity(T, cfg)
            y = moe.moe_block(x[None], p, cfg)[0][0]
            y32 = moe.moe_block(x.float()[None], p32, cfg)[0][0]
            gates, idx, _ = moe._route(x, p["router"], k)
            require(torch.equal(idx, moe._route(x.float(), p32["router"], k)[1]),
                    f"{arch} T={T}: bf16 and float32 layers routed apart")
            buf, lin, gf = moe._dispatch_local(x, gates, idx, E, C)
            keep = lin < E * C
            plain = moe_plain(x, p, gates, idx, keep)
            d_k, d_p = ((a.float() - y32).norm().item() / y32.norm().item() for a in (y, plain))
            require(torch.isfinite(y).all() and d_k <= E2E_BF16_RATIO * d_p,
                    f"{arch} T={T}: bf16 moe_block {d_k:.3e} from float32, the plain version "
                    f"{d_p:.3e} (limit {E2E_BF16_RATIO:g}x)")
            ye = moe._expert_ffn(buf, p["we1"], p["we3"], p["we2"])
            parts = {
                "route": cuda_ms(lambda: moe._route(x, p["router"], k)),
                "dispatch": cuda_ms(lambda: moe._dispatch_local(x, gates, idx, E, C)),
                "expert products": cuda_ms(lambda: moe._expert_ffn(buf, p["we1"], p["we3"],
                                                                   p["we2"])),
                "combine": cuda_ms(lambda: moe._combine_local(ye, lin, gf, T, k)),
            }
            whole = cuda_ms(lambda: moe.moe_block(x[None], p, cfg))
            plain_ms = cuda_ms(lambda: moe_plain(x, p, gates, idx, keep), iters=5)
            n_kept = int(keep.sum())
            used = int(torch.unique(idx.reshape(-1)[keep]).numel())
            nbytes = used * 3 * D * F * 2 + D * E * 4 + 2 * T * D * 2
            bms, by = bound(work.Work(2 * n_kept * 3 * D * F + 2 * T * D * E, nbytes),
                            torch.bfloat16)
            log(f"moe[{arch} T={T}] bf16 on {card}: capacity {C} slots an expert ({E} experts, top "
                f"{k}), dropped share {1 - n_kept / keep.numel():.4f} ({keep.numel() - n_kept} "
                f"of {keep.numel()}), {used} experts used; ||y - float32|| / ||float32|| "
                f"{d_k:.3e}, plain {d_p:.3e} (<= {E2E_BF16_RATIO:g}x); device ms by part: "
                + ", ".join(f"{name} {fmt_ms(t)}" for name, t in parts.items())
                + f"; moe_block {fmt_ms(whole)}, plain {fmt_ms(plain_ms)}, bound {bms:.5f} "
                f"({by})")
            del x, y, y32, buf, ye, plain
        del p, p32
        torch.cuda.empty_cache()


def phase12(card):
    """Phase 12: the paged kernel and flash at the four configs' shapes;
    the MoE layer at granite's and dbrx's widths; float32 kernel-against-
    plain parity and bf16 against float32 (dbrx at depth 2); each config
    served in bf16 at full width, ``SERVE_DEPTH`` layers (dbrx 4)."""
    rows = phase12_kernels(card)
    phase12_moe(card)
    for arch, layers, layouts, runs, shared in P12_PARITY:
        parity_serve_f32(card, arch, layers, layouts, runs, shared)
        gc.collect()
        torch.cuda.empty_cache()
        parity_bf16(arch, layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {}
    for arch, layers in P12_SERVE:
        shape = serve_bf16(card, arch, layers)
        name = arch.split("-")[0]
        if arch == "musicgen-large":
            launches.update(p12_int8=shape["decode"], p12_int8_verify=shape["verify"],
                            p12_int8_chunk=shape["chunk"])
        elif arch == "internvl2-2b":
            launches.update(p12_internvl2=shape["decode"], p12_internvl2_verify=shape["verify"])
        elif arch == "granite-moe-1b-a400m":
            launches["p12_granite"] = shape["decode"]
        if arch != "dbrx-132b":
            launches[f"p12_flash_{name}"] = shape["flash"]
    require(all(launches.values()), f"phase 12: a kernel shape was never launched: {launches}")
    return rows, launches


# ---------------------------------------------------------------------------
# phase 13: sharded paged serving over gloo ranks on one card

P13_WORLD = 6  # the largest mesh: smollm's (model, seq) = (3, 2)
P13_SMOLLM = (((3,), ("model",)), ((2,), ("seq",)), ((3, 2), ("model", "seq")))
P13_INTERNLM2 = (((2,), ("model",)), ((4,), ("model",)), ((2,), ("seq",)),
                 ((2, 2), ("model", "seq")))
P13_STABLELM = (((2,), ("model",)), ((2,), ("seq",)))
P13_MAX_SEQ = 1024
P13_BS = 16  # block size of the sharded pools
# each config's pool: a little over the blocks its 4 requests reserve, so
# the allocator's ids reach every seq shard (a roomy pool's first shard
# would hold every block)
P13_POOL = {"smollm-135m": 80, "internlm2-20b": 160, "stablelm-3b": 224}
P13_SEQ_ATOL = 1e-4  # a seq split's one-step float32 logits (assert_logits_close)
# CPU rehearsal: head counts that divide the meshes at .reduced() width
P13_REHEARSAL = {"smollm-135m": dict(n_heads=6, n_kv_heads=3),
                 "internlm2-20b": dict(n_heads=8, n_kv_heads=4),
                 "stablelm-3b": dict(n_heads=4, n_kv_heads=4)}
_P13_STEPS = collections.Counter()  # sharded step calls by step name


def _mesh_name(shape, names):
    return "x".join(f"{n}{k}" for n, k in zip(names, shape))


def p13_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p13_barrier(mesh):
    """Every rank of ``mesh`` waits for the others (a barrier along each
    axis in turn)."""
    import torch.distributed as dist

    for a in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(a))


def p13_count_steps(sched):
    """Count the scheduler's sharded step calls in ``_P13_STEPS``."""
    for step in (sched._decode_paged, sched._verify_paged):
        if step is None or getattr(step, "_p13", False):
            continue
        inner = step._eager

        def eager(args, kwargs, inner=inner, name=step.name):
            _P13_STEPS[name] += 1
            return inner(args, kwargs)

        step._eager, step._p13 = eager, True


def p13_requests(cfg, n, lens, new, seed, prefix=0):
    """``n`` seeded requests arriving at once, prompt lengths from ``lens``
    (after a shared ``prefix`` of that many tokens)."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, size=(prefix,)).astype(np.int32)
    return [Request(prompt=np.concatenate([head, rng.integers(0, cfg.vocab_size, size=(
        int(rng.choice(lens)),)).astype(np.int32)]), max_new_tokens=new) for _ in range(n)]


def p13_one_step(model, params, mesh, prompts, T, backend=None, max_seq=P13_MAX_SEQ):
    """Logits [B, T, V] (float32, on the CPU) of one paged step at T
    queries a row after the prompts' prefills: ``decode_step_paged`` (T = 1)
    or ``verify_step_paged``, sharded over ``mesh`` (or single-device for
    None), the prefills through ``backend``'s prefill (unsharded), each
    rank writing its shard. The step's tokens are the prompts' last T."""
    from repro_torch.serve.kv_cache import PagedKVCache

    need = sum(-(-(len(p) + T + 1) // P13_BS) for p in prompts)  # just the blocks it takes
    kv = PagedKVCache(model, len(prompts), max_seq, block_size=P13_BS, num_blocks=need,
                      mesh=mesh, prefix_cache=False)
    for i, p in enumerate(prompts):
        require(kv.try_admit(i, p, budget=T + 1) is not None, "one-step: admission failed")
        _, dense = model.prefill(params, torch.as_tensor(p[None]).long(), max_seq, backend=backend)
        kv.write_prefill(i, dense)
        kv.ensure_tail_n(i, T)
    name = "decode_step_paged" if T == 1 else "verify_step_paged"
    step = (model.jit_step(name, backend) if mesh is None
            else model.sharded_paged_step(name, mesh, backend))
    tok = torch.as_tensor(np.stack([p[-T:] for p in prompts])).long()
    pool, tables, lens = kv.kernel_inputs()
    logits, _ = step(params, pool, tables, lens, tok)
    p13_sync(model.device)
    used = kv.block_tables[np.arange(kv.blocks_per_row)[None] * P13_BS
                           < (kv.cache_len + T)[:, None]]
    by_shard = np.bincount(used // kv.local_blocks, minlength=kv.seq_shards).tolist()
    return logits.float().reshape(len(prompts), T, -1).cpu(), (step, (params, pool, tables, lens,
                                                                     tok), by_shard)


def p13_wall(fn, dev, n=10):
    """Median host wall (ms) of ``n`` synchronised calls."""
    times = []
    for _ in range(n):
        p13_sync(dev)
        t0 = time.perf_counter()
        fn()
        p13_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def p13_serve(eng, reqs, mb, *, spec=None, chunk=None, quant=False, sharded=True):
    """One serve through ``eng.scheduler``; for a sharded engine, the
    launches of the run checked against its step calls exactly: every
    sharded decode or verify step one paged launch a layer on a head split
    (the int8 mode for an int8 pool) or one partials launch a layer on a
    seq split, every prefill chunk (unsharded) one paged launch a layer.
    Returns (streams in admission order, launches, steps, chunks)."""
    sched = eng.scheduler(mb, spec=spec, chunk_size=chunk)
    if sharded:
        p13_count_steps(sched)
    _P13_STEPS.clear()
    reset_launches()
    out = sched.run(reqs)
    p13_sync(eng.device)
    n = read_launches()
    streams = [np.asarray(out[r.rid]) for r in reqs]
    require(all(len(s) == r.max_new_tokens for s, r in zip(streams, reqs)),
            "a request did not finish with its tokens")
    steps = sum(_P13_STEPS.values())
    chunks = sum(sched.widths["chunk"].values())
    if sharded:
        L = eng.model.cfg.num_layers
        seq = eng.mesh is not None and "seq" in eng.mesh.mesh_dim_names
        key = "paged_int8" if quant else "paged"
        want = {key: L * chunks + (0 if seq else L * steps), "partials": L * steps if seq else 0}
        got = {k: n[k] for k in ("paged", "paged_int8", "partials")}
        want = {k: want.get(k, 0) for k in got}
        require(steps > 0 and got == want, f"sharded serve launched {got}, expected {want} "
                f"({steps} sharded steps, {chunks} chunks, {L} layers)")
    return streams, n, steps, chunks


def p13_float32_parity(rank, arch, meshes, cfg, params, base_streams, reqs_fn, mb, label, dev):
    """Float32 on each mesh: the one-step decode (T = 1) and verify (T = 5)
    logits against the single-device kernel path's (max |dlogit| printed,
    and whether bitwise; a seq split's held to 1e-4), the served streams
    against the single-device ones (ties aside: ``count_ties``), the
    launches exact, the sharded decode step's p50 wall against the
    single-device one and the time inside collectives. Returns this rank's
    partials launches a serve."""
    from repro_torch.launch.mesh import in_mesh, make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import collectives
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.differential import assert_logits_close

    partials = {}
    if params is not None:  # this rank serves on some mesh of the run
        model = Model(cfg, device=dev)
        prompts = [np.asarray(r.prompt) for r in reqs_fn()][:4]
    if rank == 0:
        single = {T: p13_one_step(model, params, None, prompts, T) for T in (1, 5)}
        t_single = p13_wall(lambda: single[1][1][0](*single[1][1][1]), dev)
    pool_blocks = P13_POOL[arch]
    for shape, names in meshes:
        mesh = make_test_mesh(shape, names, device=dev)  # every rank makes the groups
        if params is None or not in_mesh(mesh):
            continue
        mname = _mesh_name(shape, names)
        gaps = {}
        for T in (1, 5):
            got, (step, args, by_shard) = p13_one_step(model, params, mesh, prompts, T)
            require("seq" not in names or min(by_shard) > 0,
                    f"{label} {mname}: a seq shard holds none of the rows' blocks: {by_shard}")
            if rank == 0:
                want = single[T][0]
                gap = float((got - want).abs().max())
                gaps[T] = f"{gap:.3e}" + (" (bitwise)" if torch.equal(got, want) else "")
                if "seq" in names:
                    assert_logits_close(want.numpy(), got.numpy(), atol=P13_SEQ_ATOL,
                                        label=f"{label} {mname} T={T}")
            if T == 1:
                collectives.reset_stats()
                t_sh = p13_wall(lambda: step(*args), dev)
                coll = collectives.STATS["seconds"] * 1e3 / 10
                staged = collectives.STATS["staged_calls"] / 10
        eng = ServingEngine(model, params, max_seq=P13_MAX_SEQ, kv_layout="paged",
                            block_size=P13_BS, num_blocks=pool_blocks, mesh=mesh, device=dev)
        streams, n, steps, _ = p13_serve(eng, reqs_fn(), mb)
        partials[mname] = n["partials"]
        if rank == 0:
            ties = count_ties(model, params, [r.prompt for r in reqs_fn()], base_streams, streams,
                              f"{label} {mname}")
            log(f"p13[{label} {mname}] float32: one-step max|dlogit| against the single-device "
                f"kernel path (blocks by seq shard {by_shard}): decode {gaps[1]}, verify T=5 "
                f"{gaps[5]}; streams equal but "
                f"{ties} ties over {len(streams)} ({steps} sharded steps, launches {n['paged']} "
                f"paged, {n['partials']} partials a rank); decode step p50 wall {t_sh:.2f} ms "
                f"against {t_single:.2f} single-device (graphed), inside collectives "
                f"{coll:.2f} ms a step ({staged:.0f} staged calls)")
        del eng
        p13_barrier(mesh)
    return partials


def p13_bf16_ref(model, params, prompts, dev):
    """The bf16 plain path's and the float32 plain path's (same weights,
    upcast) one-step decode logits, single-device, and the greedy tokens
    the step fed: rank 0's yardstick for ``E2E_BF16_RATIO``."""
    import dataclasses as dc

    from repro_torch.models.model import Model

    plain, _ = p13_one_step(model, params, None, prompts, 1, backend="reference")
    f32 = Model(dc.replace(model.cfg, dtype="float32"), device=dev)
    p32 = _upcast(params)
    ref, _ = p13_one_step(f32, p32, None, prompts, 1, backend="reference")
    del p32, f32
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return plain, ref


def p13_bf16(rank, arch, meshes, cfg, params, reqs_fn, mb, runs, label, dev, refs):
    """bf16 on each mesh: the one-step decode logits through the sharded
    kernel path no further from the float32 plain path than
    ``E2E_BF16_RATIO`` times the bf16 plain path (per row, relative L2),
    then ``runs`` served (launches exact, every request finished), the
    streams' agreement with the single-device kernel path's printed.
    Returns this rank's launches by (mesh, run)."""
    from repro_torch.launch.mesh import in_mesh, make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine

    out = {}
    if params is not None:
        model = Model(cfg, device=dev)
        prompts = [np.asarray(r.prompt) for r in reqs_fn()][:4]
    if rank == 0:
        base = ServingEngine(model, params, max_seq=P13_MAX_SEQ, kv_layout="paged",
                             block_size=P13_BS, num_blocks=P13_POOL[arch], device=dev)
        base_streams = {name: p13_serve(base, reqs_fn(), mb, sharded=False, **kw)[0]
                        for name, kw in runs}
        del base
    for shape, names in meshes:
        mesh = make_test_mesh(shape, names, device=dev)  # every rank makes the groups
        if params is None or not in_mesh(mesh):
            continue
        mname = _mesh_name(shape, names)
        got, (_, _, by_shard) = p13_one_step(model, params, mesh, prompts, 1)
        require("seq" not in names or min(by_shard) > 0,
                f"{label} {mname}: a seq shard holds none of the rows' blocks: {by_shard}")
        if rank == 0:
            plain, ref = refs
            d_k = ((got[:, 0] - ref[:, 0]).norm(dim=-1) / ref[:, 0].norm(dim=-1)).tolist()
            d_p = ((plain[:, 0] - ref[:, 0]).norm(dim=-1) / ref[:, 0].norm(dim=-1)).tolist()
            # held on the card; a CPU rehearsal at .reduced() width only
            # prints it (a 64-wide model's rows are too few for the ratio)
            require(torch.isfinite(got).all() and (dev.type != "cuda" or all(
                a <= E2E_BF16_RATIO * b for a, b in zip(d_k, d_p))),
                f"{label} {mname}: bf16 sharded decode logits {d_k} from float32, the plain "
                f"path {d_p} (limit {E2E_BF16_RATIO:g}x)")
        eng = ServingEngine(model, params, max_seq=P13_MAX_SEQ, kv_layout="paged",
                            block_size=P13_BS, num_blocks=P13_POOL[arch], mesh=mesh, device=dev)
        for name, kw in runs:
            streams, n, steps, chunks = p13_serve(eng, reqs_fn(), mb, quant=cfg.kv_quant, **kw)
            out[(mname, name)] = n
            if rank == 0:
                same = sum(np.array_equal(a, b) for a, b in zip(streams, base_streams[name]))
                log(f"p13[{label} {mname} {name}] bf16 (blocks by seq shard {by_shard}): decode "
                    f"logits per row from float32 "
                    f"{', '.join(f'{x:.3e}' for x in d_k)} (plain {', '.join(f'{x:.3e}' for x in d_p)}"
                    f"; <= {E2E_BF16_RATIO:g}x); {len(streams)} requests finished, {same} streams "
                    f"equal to the single-device kernel path's; {steps} sharded steps, {chunks} "
                    f"chunks, launches a rank: paged {n['paged']}, int8 {n['paged_int8']}, "
                    f"partials {n['partials']}, flash {n['flash']}")
        del eng
        p13_barrier(mesh)
    return out


def p13_moe(rank, dev, card):
    """granite-moe-1b-a400m's ``moe_block`` at full width on a ("data",
    "model") = (2, 2) mesh, float32: the dispatch path (T = 1024) against
    ``_moe_reference`` on each token shard (the capacity a shard's tokens
    get), the dense path and the legacy one (T = 8) against the dense
    mixture, all within 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import in_mesh, make_test_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ShardingRules

    mesh = make_test_mesh((2, 2), ("data", "model"), device=dev)
    if not in_mesh(mesh):
        return
    cfg = get_config("granite-moe-1b-a400m")
    gen = torch.Generator(device=dev).manual_seed(7)
    p = moe.init_moe(cfg, torch.float32, gen)
    rules = ShardingRules(mesh, cfg)
    errs = {}
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device=dev)
    y, _ = moe.moe_block(x, p, cfg, rules, path="dispatch")
    want = torch.cat([moe._moe_reference(s, p, cfg)[0] for s in x[0].chunk(4)])
    errs["dispatch"] = float((y[0] - want).abs().max())
    xd = torch.randn((8, 1, cfg.d_model), generator=gen, device=dev)
    gates, idx, _ = moe._route(xd[:, 0], p["router"], cfg.top_k)
    gmat = torch.zeros((8, cfg.n_experts), device=dev).scatter_add(1, idx, gates)
    h = torch.nn.functional.silu(torch.einsum("td,edf->etf", xd[:, 0], p["we1"]))
    h = h * torch.einsum("td,edf->etf", xd[:, 0], p["we3"])
    mix = torch.einsum("etd,te->td", torch.einsum("etf,efd->etd", h, p["we2"]), gmat)
    errs["dense"] = float((moe.moe_block(xd, p, cfg, rules, path="dense")[0][:, 0] - mix).abs().max())
    moe.LEGACY_DENSE = True
    try:
        errs["legacy"] = float((moe.moe_block(xd, p, cfg, rules, path="dense")[0][:, 0]
                                - mix).abs().max())
    finally:
        moe.LEGACY_DENSE = False
    scale = {"dispatch": float(want.abs().max()), "dense": float(mix.abs().max())}
    scale["legacy"] = scale["dense"]
    for k, e in errs.items():
        require(e <= 2e-4 * (1 + scale[k]), f"moe[{k}] on (data, model) = (2, 2): max err {e}")
    if rank == 0:
        log(f"p13[granite-moe-1b-a400m moe_block (data, model) = (2, 2)] float32 on {card}: "
            f"max |err| dispatch {errs['dispatch']:.3e} (T=1024, against _moe_reference a token "
            f"shard), dense {errs['dense']:.3e} and legacy {errs['legacy']:.3e} (T=8, against "
            f"the dense mixture); within 2e-4 (1 + max|ref|)")
    p13_barrier(mesh)


def p13_probe(rank, dev):
    """Which collectives gloo runs on CUDA tensors itself (on a 2-rank
    mesh): each op called on CUDA tensors, its result checked."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import in_mesh, make_test_mesh

    mesh = make_test_mesh((2,), ("model",), device=dev)
    if not in_mesh(mesh) or dev.type != "cuda":
        return {}
    g = mesh.get_group("model")
    x = torch.full((4,), float(rank + 1), device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=g),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=g),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                                              group=g),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x, group=g),
    }
    found = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            found[name] = "native"
        except Exception as e:  # noqa: BLE001 - the probe reports what gloo refuses
            found[name] = f"refused: {str(e).splitlines()[0][:120]}"
        p13_barrier(mesh)
    return found


def p13_rank(rank, world, card, out, device="cuda", reduced=False):
    """One rank of phase 13 (every rank runs it; a run whose mesh leaves a
    rank out skips it there). ``device="cpu"`` with ``reduced`` rehearses
    it at ``.reduced()`` width on the CPU: the kernel wrappers' plain
    versions stand in, counted as launches."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.parallel import collectives
    from repro_torch.serve import SpecConfig

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build

        _build.library()  # the parent's build, loaded
    else:
        p13_rehearsal_patches()
    t0 = time.perf_counter()
    found = {"probe": p13_probe(rank, dev), "launches": {}, "peak_gb": None}
    if rank == 0 and found["probe"]:
        log(f"p13 gloo on CUDA tensors ({card}): " + json.dumps(found["probe"]) + "; the port "
            f"hands gloo {sorted(collectives.GLOO_CUDA_NATIVE)} on CUDA tensors and stages the "
            "others through host memory (collectives.GLOO_CUDA_NATIVE)")

    def config(arch, **kw):
        cfg = get_config(arch)
        if reduced:
            cfg = dc.replace(cfg.reduced(), **P13_REHEARSAL[arch])
        return dc.replace(cfg, **kw)

    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine

    def free(section):
        """Drop a section's tensors, print this rank's memory, and line the
        ranks up (a rank no mesh of the next section holds waits here)."""
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            log(f"p13 rank {rank} after {section}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                f"allocated, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        dist.barrier()

    def weights(cfg, meshes):
        """The seeded weights on the ranks some mesh of the run holds."""
        need = max(int(np.prod(shape)) for shape, _ in meshes)
        return Model(cfg, device=dev).init(seed=2) if rank < need else None

    def base_streams(arch, cfg, params, reqs):
        """Rank 0's single-device kernel-path streams (graphed)."""
        if rank != 0:
            return None
        eng = ServingEngine(Model(cfg, device=dev), params, max_seq=P13_MAX_SEQ,
                            kv_layout="paged", block_size=P13_BS, num_blocks=P13_POOL[arch],
                            device=dev)
        return p13_serve(eng, reqs, 4, sharded=False)[0]

    # smollm-135m, float32, full depth: tp = 3, seq = 2, (3, 2)
    cfg = config("smollm-135m", dtype="float32")
    params = weights(cfg, P13_SMOLLM)

    def smollm_reqs():
        return p13_requests(cfg, 4, range(64, 257), 16, seed=31)

    found["launches"]["smollm"] = p13_float32_parity(
        rank, "smollm-135m", P13_SMOLLM, cfg, params, base_streams("smollm-135m", cfg, params, smollm_reqs()),
        smollm_reqs, 4, "smollm-135m", dev)
    del params
    free("smollm-135m")
    if rank == 0:
        log(f"p13 smollm-135m done at {time.perf_counter() - t0:.1f} s")

    # internlm2-20b: float32 at depth 2, then bf16 at depth 4
    f32 = config("internlm2-20b", dtype="float32", num_layers=2)
    params = weights(f32, P13_INTERNLM2)

    def internlm2_reqs(c=f32):
        return p13_requests(c, 4, range(128, 513), 16, seed=32)

    found["launches"]["internlm2_f32"] = p13_float32_parity(
        rank, "internlm2-20b", P13_INTERNLM2, f32, params,
        base_streams("internlm2-20b", f32, params, internlm2_reqs()), internlm2_reqs, 4,
        "internlm2-20b (depth 2)", dev)
    del params
    free("internlm2-20b float32")
    cfg = config("internlm2-20b", num_layers=4, dtype="bfloat16")
    params = weights(cfg, P13_INTERNLM2)
    refs = None
    if rank == 0:
        prompts = [np.asarray(r.prompt) for r in internlm2_reqs(cfg)][:4]
        refs = p13_bf16_ref(Model(cfg, device=dev), params, prompts, dev)
    found["launches"]["internlm2"] = p13_bf16(
        rank, "internlm2-20b", P13_INTERNLM2, cfg, params, lambda: internlm2_reqs(cfg), 4,
        (("plain", {}), ("K=4", {"spec": SpecConfig(k=4)})), "internlm2-20b (depth 4)", dev, refs)
    del params, refs
    free("internlm2-20b bf16")
    if rank == 0:
        log(f"p13 internlm2-20b done at {time.perf_counter() - t0:.1f} s")

    # stablelm-3b, bf16, int8 pool, full depth: K = 4 and chunk 256 over a
    # shared 512-token prefix (prefix hits gathered from the shards)
    cfg = config("stablelm-3b", dtype="bfloat16")
    params = weights(cfg, P13_STABLELM)

    def stablelm_reqs():
        return p13_requests(cfg, 4, range(64, 257), 16, seed=33, prefix=P11_PREFIX)

    refs = None
    if rank == 0:
        prompts = [np.asarray(r.prompt) for r in stablelm_reqs()][:4]
        refs = p13_bf16_ref(Model(cfg, device=dev), params, prompts, dev)
    found["launches"]["stablelm"] = p13_bf16(
        rank, "stablelm-3b", P13_STABLELM, cfg, params, stablelm_reqs, 4,
        (("K=4 chunk 256", {"spec": SpecConfig(k=4), "chunk": 256}),), "stablelm-3b", dev, refs)
    del params, refs
    free("stablelm-3b")
    if rank == 0:
        log(f"p13 stablelm-3b done at {time.perf_counter() - t0:.1f} s")

    if not reduced:
        p13_moe(rank, dev, card)
    if dev.type == "cuda":
        found["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    found["seconds"] = time.perf_counter() - t0
    found["collectives"] = dict(collectives.STATS)
    import pickle

    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(found, f)


def p13_rehearsal_patches():
    """The CPU rehearsal's stand-ins (phases 13 and 17): ``require_cuda`` a
    no-op and the kernel backend the default, so each kernel wrapper runs
    its plain version on CPU tensors, counted as the wrapper counts a
    launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm  # noqa: F401  (its reference scan stays the plain one)

    kernel_ops.require_cuda = lambda t, what: None
    kernel_ops.set_attention_backend("kernel")
    plain_paged, plain_flash = pda.plain_paged_decode_attention, fa.plain_flash_attention
    plain_ssd = ssd.plain_ssd_scan

    def paged(q, k_pool, *a, **kw):
        part = kw.get("partials") or (len(a) > 6 and a[6])
        w = pda.paged_decode_attention
        attr = "launches_partials" if part else (
            "launches_int8" if k_pool.dtype == torch.int8 else "launches")
        setattr(w, attr, getattr(w, attr) + 1)
        return plain_paged(q, k_pool, *a, **kw)

    def flash(*a, **kw):
        fa.flash_attention.launches += 1
        return plain_flash(*a, **kw)

    def scan(*a, **kw):
        ssd.ssd_scan.launches += 1
        return plain_ssd(*a, **kw)

    pda.plain_paged_decode_attention, fa.plain_flash_attention = paged, flash
    ssd.plain_ssd_scan = scan


def p13_kernels(card):
    """The paged kernel on a head split's rank, on the card: at smollm-135m's
    (9 heads over 3, tp = 3: 3 over 1) and internlm2-20b's (48 over 8, tp =
    4: 12 over 2) pools, T = 1 and 5, float32 and bf16, each rank's launch
    over its local heads (``plan_kv_heads``) bitwise equal to those heads of
    the single-device launch at B = 8 and 32 (the plan repair; without it
    a B = 32 rank's plan splits each row otherwise, printed); the local
    launch at B = 8, T = 1 timed beside its plain version and its bound. Then the partials mode at internlm2's seq-2
    shard (the blocks of the lower half of the pool owned), held to its
    plain version, the two halves combined to the unsplit kernel, timed
    beside its bound. Returns the bf16 rows."""
    from repro_torch.kernels import paged_decode_attention as pda

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for arch, H, KV, hd, tp in (("smollm-135m", 9, 3, 64, 3), ("internlm2-20b", 48, 8, 128, 4)):
            h, kv = H // tp, KV // tp
            for B, T in ((8, 1), (8, 5), (32, 1), (32, 5)):
                q, kp, vp, tables, lengths = paged_case(dtype, T, B=B, H=H, KV=KV, hd=hd)[:5]
                full = pda.paged_decode_attention(q, kp, vp, tables, lengths)
                shards = []
                for r in range(tp):
                    args = (q[:, :, r * h:(r + 1) * h].contiguous(),
                            kp[:, :, r * kv:(r + 1) * kv].contiguous(),
                            vp[:, :, r * kv:(r + 1) * kv].contiguous(), tables, lengths)
                    out = pda.paged_decode_attention(*args, plan_kv_heads=KV)
                    require(torch.equal(out, full[:, :, r * h:(r + 1) * h]),
                            f"{arch} tp={tp} rank {r} T={T} {dn}: local heads differ from the "
                            "single-device launch's")
                    shards.append(args)
                args = shards[0]
                unrepaired = pda.paged_decode_attention(*args)
                plan_local = paged_plan_of(*args[:2], tables)
                plan_full = paged_plan_of(q, kp, tables)
                line = (f"p13 paged_decode_attention {dn} {arch} tp={tp} rank-local B={B} T={T} "
                        f"H={h} KV={kv} hd={hd}: every rank's launch bitwise equal to its heads of "
                        f"the single-device launch (splits {plan_full['splits']}); without "
                        f"plan_kv_heads the local plan's splits are "
                        f"{pda.paged_plan(dtype, dtype, B, T, h, kv, hd, 16, 128)['splits']} and "
                        f"its output {'is' if torch.equal(unrepaired, full[:, :, :h]) else 'is not'}"
                        f" bitwise the same")
                if B == 8 and T == 1:
                    ref = pda.plain_paged_decode_attention(*args)
                    err = (full[:, :, :h].float() - ref.float()).abs().max().item()
                    require(err <= TOL[dtype], f"{arch} local heads: {err} from the plain version")
                    ms = cuda_ms(lambda: pda.paged_decode_attention(*args, plan_kv_heads=KV))
                    plain = cuda_ms(lambda: pda.plain_paged_decode_attention(*args), iters=5)
                    bms, by = bound(work.paged(args[0], args[1], tables, lengths), dtype)
                    line += (f"; local launch plan={plan_local} ms={fmt_ms(ms)} plain_ms="
                             f"{fmt_ms(plain)} bound_ms={bms:.5f} ({by}) library_ms=null")
                    if dtype == torch.bfloat16 and arch == "internlm2-20b":
                        rows[("p13_internlm2_tp4", dtype)] = kernel_row(err, ms, plain, bms, by)
                log(line)
                del q, kp, vp, full, shards, args
        # the partials mode at internlm2's seq-2 shard
        q, kp, vp, tables, lengths = paged_case(dtype, 1, H=48, KV=8, hd=128)[:5]
        half = kp.shape[0] // 2
        owned = (tables < half).to(torch.int32)
        parts = [pda.paged_decode_attention(q, kp, vp, tables, lengths, owned=o, partials=True)
                 for o in (owned, 1 - owned)]
        want = pda.plain_paged_decode_attention(q, kp, vp, tables, lengths, owned=owned,
                                                partials=True)
        dm, dl, da = partials_err(parts[0], want)
        require(max(dm, dl, da) <= PARTIALS_TOL, f"partials at internlm2's seq shard ({dn}): "
                f"{dm}, {dl}, {da}")
        whole = pda.paged_decode_attention(q, kp, vp, tables, lengths)
        comb = (combine(parts) - whole.float()).abs().max().item()
        require(comb <= TOL[dtype], f"partials halves combine {comb} from the unsplit kernel")
        ms = cuda_ms(lambda: pda.paged_decode_attention(q, kp, vp, tables, lengths, owned=owned,
                                                        partials=True))
        plain = cuda_ms(lambda: pda.plain_paged_decode_attention(
            q, kp, vp, tables, lengths, owned=owned, partials=True), iters=5)
        bms, by = bound(work.partials(q, kp, tables, lengths, owned), dtype)
        log(f"p13 paged_decode_attention[partials] {dn} internlm2-20b seq=2 shard B=8 T=1 H=48 "
            f"KV=8 hd=128 (blocks < {half} owned): max_abs_err m {dm:.3e}, l {dl:.3e}, acc "
            f"{da:.3e} (tol {PARTIALS_TOL:g}); halves combined to the unsplit kernel within "
            f"{comb:.3e}; ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} ({by}) "
            f"library_ms=null")
        if dtype == torch.bfloat16:
            rows[("partials", dtype)] = kernel_row(max(dm, dl, da), ms, plain, bms, by)
        del q, kp, vp, parts, whole
        torch.cuda.empty_cache()
    return rows


def phase13(card, device="cuda", reduced=False):
    """Phase 13: the kernel at a rank's shapes (``p13_kernels``, on the
    card), then the sharded serving runs in ``P13_WORLD`` gloo rank
    processes sharing the card (``p13_rank``; a failure in any rank fails
    the phase). Prints each rank's peak memory, the time inside collectives
    and the host staging. Returns (rows, launches): the partials launches
    and the internlm2 tp = 4 paged launches summed over the ranks' serves."""
    import pickle

    from repro_torch.launch.mesh import run_ranks

    rows = p13_kernels(card) if device == "cuda" else {}
    if device == "cuda":
        torch.cuda.empty_cache()
    out = os.path.join(ROOT, "build", "phase13")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    run_ranks(p13_rank, P13_WORLD, card, out, device, reduced, store=os.path.join(out, "store"),
              timeout_s=600.0)
    found = []
    for r in range(P13_WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            found.append(pickle.load(f))
    partials = sum(v for f in found for runs in f["launches"].values()
                   for key, n in runs.items()
                   for v in ([n] if isinstance(n, int) else [n["partials"]]))
    tp4 = sum(n["paged"] for f in found for (mname, _), n in f["launches"].get("internlm2", {}).items()
              if mname == "model4")
    require(partials > 0 and (tp4 > 0 or device != "cuda"),
            f"phase 13: partials {partials}, internlm2 tp=4 paged {tp4} launches")
    log(f"p13 ranks ({P13_WORLD} gloo processes on one {card}): wall {time.perf_counter() - t0:.1f} "
        f"s; per rank: " + "; ".join(
            f"rank {r} peak {f['peak_gb'] if f['peak_gb'] is None else round(f['peak_gb'], 2)} GiB, "
            f"{f['seconds']:.1f} s, collectives {f['collectives']['calls']} calls "
            f"{f['collectives']['seconds']:.2f} s, staged {f['collectives']['staged_calls']} "
            f"calls {f['collectives']['staged_bytes'] / 2**20:.1f} MiB"
            for r, f in enumerate(found))
        + "; every sharded step runs eagerly (gloo collectives cannot be captured in a CUDA "
        "graph: the family keeps StepGraph's per-key record)")
    return rows, {"partials": partials, "p13_internlm2_tp4": tp4}


# ---------------------------------------------------------------------------
# phase 14: training

P14_STEPS, P14_FAIL_AT, P14_CKPT_EVERY = 20, 7, 5
P14_BATCH, P14_SEQ = 8, 1024  # smollm-135m's trainer: accum 2 (its train_accum)
P14_REPLAYS = 5  # timed replays of 14a's captured step, a remat mode
P14_PARITY = dict(layers=2, batch=2, seq=256)  # 14b: float32, CUDA against CPU
P14_LOSS_RTOL = 1e-5  # float32 loss, CUDA against CPU
P14_GNORM_RTOL = P14_GRAD_RTOL = 1e-4  # grad_norm; relative L2 of each gradient leaf
P14_PARAM_ATOL = 5e-2  # tests/test_sharded.py's bound on a step's parameters
P14_MESH_LOSS_ATOL = 5e-3  # tests/test_sharded.py's bound on the sharded step's loss
P14_PIPE_ATOL = 1e-5  # tests/test_sharded.py's bound on the pipeline
# 14c: one step of each other family at full width; depth 2, zamba2 one
# attention group (6 SSM layers and the shared block)
P14_OTHERS = ("mamba2-370m", "zamba2-2.7b", "granite-moe-1b-a400m", "internvl2-2b",
              "musicgen-large")
P14_DIR = os.path.join(ROOT, "build", "phase14")


def p14_grads(model, params, batch):
    """(loss, gradient leaves in ``tree.flatten`` order) of ``Model.loss``."""
    from repro_torch.tree import flatten, unflatten

    leaves, spec = flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss(unflatten(spec, leaves), batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def profile_busy(label, fn, wall_ms, card):
    """Device busy ms of one call of ``fn`` (warm), from a CUDA-only
    ``torch.profiler`` trace (a step's ~27k kernels: the CPU side's events
    would cost more to collect than the step), against ``wall_ms``, the
    synchronised wall of the same work unprofiled, and against the
    profiled call's own wall (tracing stretches kernels a little and an
    eager call's host side more); the top kernel names by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        own_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in gpu) / 1e3
    by_name = collections.Counter()
    for e in gpu:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    top = ", ".join(f"{k} {v:.1f}" for k, v in by_name.most_common(5))
    if not gpu:
        log(f"time[{label}] on {card}: wall p50 {wall_ms:.2f} ms; device busy not measured (the "
            f"profiler saw no device operation)")
        return None
    log(f"time[{label}] on {card}: wall p50 {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
        f"share {1 - busy / wall_ms:.0%}; the profiled call's own wall {own_ms:.2f} ms, idle "
        f"share against it {1 - busy / own_ms:.0%}; {len(gpu)} device operations; top ms: {top}")
    return busy


def _p14_accum(batch, a):
    return {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:])) for k, v in batch.items()}


def _p14a_setup(device="cuda", reduced=False):
    """smollm-135m (remat "dots"), its data and optimizer for 14a
    (``reduced``: the CPU rehearsal's ``.reduced()`` bf16 config, B = 4,
    S = 64)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW

    cfg = get_config("smollm-135m")
    cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16") if reduced else cfg
    cfg = dataclasses.replace(cfg, remat="dots")
    batch, seq = (4, 64) if reduced else (P14_BATCH, P14_SEQ)
    data = SyntheticLMData(cfg, batch=batch, seq=seq, seed=0, device=device)
    return (cfg, Model(cfg, device=device), data,
            AdamW(lr=1e-3, warmup_steps=5, total_steps=P14_STEPS))


def p14a_run(i, out, device="cuda", reduced=False):
    """One of 14a's two runs, each in a process of its own (they share the
    card, which either leaves mostly idle): 0 the run with the induced
    failure at step 7 and its resume, 1 the uninterrupted run, which also
    times its steps, its peak memory and one more checkpoint save. Both run
    under deterministic algorithms (warn-only: an op without a
    deterministic implementation is recorded) and save their final state
    and findings to ``out``."""
    import warnings

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import flatten

    name = "ab"[i]
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, data, opt = _p14a_setup(device, reduced)
    tc = TrainerConfig(total_steps=P14_STEPS, ckpt_every=P14_CKPT_EVERY,
                       ckpt_dir=os.path.join(out, name), accum_steps=cfg.train_accum,
                       log_every=5)
    tr = Trainer(model, opt, data, tc, fail_at_step=P14_FAIL_AT if name == "a" else None,
                 log_fn=lambda m: log(f"p14a[{name}] {m}"))
    losses, inner = [], tr.step_fn

    def step(*args):
        res = inner(*args)
        losses.append(res[2]["loss"])
        return res

    tr.step_fn = step
    found = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            if name == "a":
                try:
                    tr.run()
                    require(False, "p14a: the induced failure did not fire")
                except RuntimeError as e:
                    require("induced node failure" in str(e), f"p14a: {e}")
            elif cuda:
                torch.cuda.reset_peak_memory_stats()
            state, _ = tr.run()
            found["wall_s"] = time.perf_counter() - t0
            found["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
            found["pool_gb"] = graph_pool_bytes(model) / 2**30 if cuda else 0.0
        finally:
            torch.use_deterministic_algorithms(False)
    # one capture in all: the failure and the resume reuse the trainer's
    # storage, so the resumed steps replay the first run's graph
    found["captures"] = inner._cache_size()
    require(found["captures"] == 1, f"p14a[{name}]: step_fn._cache_size() "
                                    f"{found['captures']}, not 1")
    tree = {"params": state.params, "opt": state.opt_state}
    if name == "b":
        # the save of the trained state, timed: the host copy, then the write
        mgr = CheckpointManager(os.path.join(out, "timed"), keep=1)
        t1 = time.perf_counter()
        mgr.save(P14_STEPS, tree)
        found["ckpt_host_s"] = time.perf_counter() - t1
        mgr.wait()
        found["ckpt_save_s"] = time.perf_counter() - t1
        found["ckpt_bytes"] = sum(t.numel() * t.element_size() for t in flatten(tree)[0])
    found.update(step=state.step, events=tr.events, step_times=tr.step_times,
                 losses=[float(x) for x in losses],
                 nondet=sorted({str(w.message).splitlines()[0] for w in caught
                                if "deterministic" in str(w.message)}))
    torch.save({"tree": tree, "found": found}, os.path.join(out, f"{name}.pt"))


def phase14_train(card, device="cuda", reduced=False):
    """14a: smollm-135m at full depth and width in bf16 through ``Trainer``:
    20 steps of B = 8, S = 1024, accum 2, remat "dots", a checkpoint every 5
    steps; an induced failure at step 7 and the resume from step 5, held
    bitwise to an uninterrupted run under deterministic algorithms (an op
    that has none is named, and the max |Δ| printed instead). The two runs
    go in two processes at once (``p14a_run``): each leaves the card mostly
    idle. Returns the trained parameters."""
    import shutil

    from repro_torch.data import SyntheticLMData
    from repro_torch.models import step_graph
    from repro_torch.models.model import Model
    from repro_torch.train import compiled_train_step
    from repro_torch.tree import flatten, map_tree

    cfg, model, data, opt = _p14a_setup(device, reduced)
    host = SyntheticLMData(cfg, batch=data.batch, seq=data.seq, seed=0, device="cpu")
    for step in (0, 13):
        a, b = data.batch_at(step), host.batch_at(step)
        require(all(torch.equal(a[k].cpu(), b[k]) for k in a),
                f"p14a: the batch of step {step} differs between CUDA and the CPU")
    out = os.path.join(P14_DIR, "train")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(p14a_run, args=(out, device, reduced), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    runs = {n: torch.load(os.path.join(out, f"{n}.pt"), map_location=device, weights_only=False)
            for n in "ab"}
    shutil.rmtree(out, ignore_errors=True)
    fa, fb = runs["a"]["found"], runs["b"]["found"]
    require(any(f"restored step {P14_CKPT_EVERY}" in e for e in fa["events"]),
            f"p14a: the resume did not restore step {P14_CKPT_EVERY}: {fa['events']}")
    require(fa["step"] == fb["step"] == P14_STEPS, "p14a: a run stopped short")
    nondet = sorted(set(fa["nondet"]) | set(fb["nondet"]))
    la, lb = flatten(runs["a"]["tree"])[0], flatten(runs["b"]["tree"])[0]
    differ = sum(not torch.equal(x, y) for x, y in zip(la, lb))
    dmax = max(float((x.float() - y.float()).abs().max()) for x, y in zip(la, lb))
    if nondet:
        log(f"p14a resume: ops without a deterministic implementation: {nondet}; {differ} of "
            f"{len(la)} leaves differ from the uninterrupted run, max |delta| {dmax:.3e}")
    else:
        require(differ == 0, f"p14a: the resumed run differs from the uninterrupted one in "
                             f"{differ} of {len(la)} leaves (max |delta| {dmax:.3e})")
        log(f"p14a resume from step {P14_CKPT_EVERY} after the failure at step {P14_FAIL_AT}: "
            f"params and optimizer state bitwise equal to the uninterrupted run "
            f"({len(la)} leaves; deterministic algorithms, no op warned)")
    losses = fb["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"p14a: the loss did not fall: {losses}")
    steps = np.array(fb["step_times"][1:]) * 1e3
    p50, p99 = float(np.percentile(steps, 50)), float(np.percentile(steps, 99))
    log(f"p14a train[smollm-135m bf16, B={data.batch} S={data.seq} accum {cfg.train_accum} remat "
        f"dots, captured step] on {card}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps; step wall (synchronised, beside the other run) p50 {p50:.2f} ms "
        f"p99 {p99:.2f} ms (first step, eager, then the capture: "
        f"{fb['step_times'][0] * 1e3:.1f} ms, not counted); "
        f"{data.batch * data.seq / p50 * 1e3:.0f} tokens/s at p50; peak memory "
        f"{fb['peak_gb']:.2f} GiB, graph pool {fb['pool_gb']:.2f} GiB; captures "
        f"{fa['captures']} (the failing run and its resume), {fb['captures']}; events "
        f"{fa['events']}; "
        f"checkpoint of {fb['ckpt_bytes'] / 2**30:.3f} GiB: host copy "
        f"{fb['ckpt_host_s'] * 1e3:.1f} ms, published after {fb['ckpt_save_s'] * 1e3:.1f} ms; "
        f"the runs {fa['wall_s']:.1f} s and {fb['wall_s']:.1f} s at once, {wall:.1f} s with "
        f"their processes' start")
    trained = runs["b"]["tree"]["params"]
    ostate = runs["b"]["tree"]["opt"]
    del runs, la, lb
    # the captured step alone on the card, under each remat mode, on a copy
    # of the trained state (it steps its state in place): its first call
    # (eager, then the capture) with the peak memory and the graph pool it
    # leaves, then P14_REPLAYS replays' synchronised walls; then where the
    # "dots" replay's time goes, one replay's device time (the profiler's
    # kernels and copies) against its wall alone
    batches = [_p14_accum(data.batch_at(i), cfg.train_accum) for i in range(2)]
    walls = {}
    with card_lock("p14a remat"):
        for remat in ("none", "full", "dots"):
            m = Model(dataclasses.replace(cfg, remat=remat), device=device)
            fn = compiled_train_step(m, opt, accum_steps=cfg.train_accum)
            p, o = map_tree(torch.clone, trained), map_tree(torch.clone, ostate)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn(p, o, batches[0])
            torch.cuda.synchronize()
            first = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            reps = []
            for i in range(P14_REPLAYS):
                t1 = time.perf_counter()
                fn(p, o, batches[i % 2])
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t1) * 1e3)
            require(fn._cache_size() == 1, f"p14a remat {remat}: {fn._cache_size()} captures")
            walls[remat] = (float(np.percentile(reps, 50)), first, peak, graph_pool_bytes(m) / 2**30)
            if remat == "dots":
                profile_busy("p14a train step replay, smollm-135m bf16 B=8 S=1024 accum 2 remat dots",
                            lambda: fn(p, o, batches[0]), walls[remat][0], card)
                # the same step eager, in this call, for the comparison
                eager = []
                with step_graph.disabled():
                    for i in range(2):
                        t1 = time.perf_counter()
                        fn(p, o, batches[i])
                        torch.cuda.synchronize()
                        eager.append((time.perf_counter() - t1) * 1e3)
                    profile_busy("p14a train step eager, smollm-135m bf16 B=8 S=1024 accum 2 remat "
                                "dots", lambda: fn(p, o, batches[0]), eager[1], card)
            del m, fn, p, o
            gc.collect()
            torch.cuda.empty_cache()
    log(f"p14a remat on {card}: the captured step alone, replay wall p50 of {P14_REPLAYS}, its "
        f"first call (eager + capture), peak GiB over the first call (with what earlier phases "
        f"still hold) and graph pool GiB: " + ", ".join(
            f"{k} {w:.1f} ms (first {f:.1f} ms) peak {m:.2f} GiB pool {g:.2f} GiB"
            for k, (w, f, m, g) in walls.items()))
    del ostate
    gc.collect()
    torch.cuda.empty_cache()
    return trained


def phase14_parity(card):
    """14b: one float32 train step of smollm-135m at full width and depth 2
    (B = 2, S = 256) on CUDA and on the CPU, from the same parameters and
    batch: loss, grad_norm, every gradient leaf and the stepped
    parameters."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import flatten, map_tree

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=P14_PARITY["layers"],
                              dtype="float32")
    gm, cm = Model(cfg), Model(cfg, device="cpu")
    params = gm.init(seed=3)
    cparams = map_tree(lambda p: p.cpu(), params)
    batch = SyntheticLMData(cfg, P14_PARITY["batch"], P14_PARITY["seq"], seed=1,
                            device="cpu").batch_at(0)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    gl, gg = p14_grads(gm, params, gbatch)
    cl, cg = p14_grads(cm, cparams, batch)
    rel = [float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(gg, cg)]
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    gp, _, gmet = make_train_step(gm, opt)(params, opt.init(params), gbatch)
    cp, _, cmet = make_train_step(cm, opt)(cparams, opt.init(cparams), batch)
    d_loss = abs(float(gl) - float(cl)) / abs(float(cl))
    d_gn = abs(float(gmet["grad_norm"]) - float(cmet["grad_norm"])) / float(cmet["grad_norm"])
    d_p = max(float((a.cpu() - b).abs().max()) for a, b in zip(flatten(gp)[0], flatten(cp)[0]))
    log(f"p14b parity[smollm-135m float32 depth 2, B=2 S=256] CUDA against CPU on {card} "
        f"({time.perf_counter() - t0:.1f} s): loss "
        f"{float(gl):.6f} vs {float(cl):.6f} (rel {d_loss:.2e} <= {P14_LOSS_RTOL:g}); grad_norm "
        f"rel {d_gn:.2e} (<= {P14_GNORM_RTOL:g}); gradient leaves rel L2 max {max(rel):.2e} "
        f"(<= {P14_GRAD_RTOL:g}, {len(rel)} leaves); stepped params max |delta| {d_p:.2e} "
        f"(< {P14_PARAM_ATOL:g})")
    require(d_loss <= P14_LOSS_RTOL, f"p14b: loss rel {d_loss}")
    require(d_gn <= P14_GNORM_RTOL, f"p14b: grad_norm rel {d_gn}")
    require(max(rel) <= P14_GRAD_RTOL, f"p14b: gradient rel L2 {rel}")
    require(d_p < P14_PARAM_ATOL, f"p14b: params {d_p}")
    del gp, cp, params, cparams, gg, cg
    torch.cuda.empty_cache()


def phase14_families(card):
    """14c: two bf16 train steps of each other family at full width (depth
    2; zamba2 one attention group) through the captured step
    (``compiled_train_step``: the first call eager, the second a replay),
    beside two eager steps of the functional ``make_train_step`` from the
    same state on the next batches, under deterministic algorithms: the
    second step's parameters equal the eager ones bit for bit, or the ops
    without a deterministic implementation are named and the max |Δ|
    printed; a finite loss, the parameters moved, the peak memory and the
    graph pool. dbrx-132b is left out: at depth 1 it still holds ~4.5 B
    parameters, whose float32 moments (36 GB), bf16 weights and gradients
    (18 GB) and float32 temporaries of its 1.06 B-element expert leaves in
    the update leave no margin on one 80 GB card."""
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW, compiled_train_step, make_train_step
    from repro_torch.tree import flatten, map_tree

    for arch in P14_OTHERS:
        cfg = get_config(arch)
        depth = cfg.attn_every if cfg.family == "hybrid" else 2
        cfg = dataclasses.replace(cfg, num_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg)
        params = model.init(seed=4)
        seq = 512 + cfg.n_frontend_tokens
        data = SyntheticLMData(cfg, batch=4, seq=seq, seed=2)
        batches = [data.batch_at(i) for i in range(2)]
        opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
        step, family = make_train_step(model, opt), compiled_train_step(model, opt)
        gp, go = map_tree(torch.clone, params), opt.init(params)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p1, o1, met = step(params, opt.init(params), batches[0])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                p2, _, _ = step(p1, o1, batches[1])
                t0 = time.perf_counter()
                family(gp, go, batches[0])  # eager, then the capture
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                _, _, gmet = family(gp, go, batches[1])  # a replay
                torch.cuda.synchronize()
                replay = time.perf_counter() - t0
            finally:
                torch.use_deterministic_algorithms(False)
        nondet = sorted({str(w.message).splitlines()[0] for w in caught
                         if "deterministic" in str(w.message)})
        pairs = list(zip(flatten(gp)[0], flatten(p2)[0]))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
        dmax = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
        loss = float(met["loss"])
        moved = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(flatten(params)[0], flatten(p1)[0]))
        n = sum(p.numel() for p in flatten(params)[0])
        log(f"p14c train[{arch} bf16 depth {depth}, B=4 S={seq}, remat {cfg.remat}] on {card}: "
            f"{n / 1e9:.3f} B parameters, loss {loss:.4f} (ce {float(met['ce']):.4f}, aux "
            f"{float(met['aux']):.4f}), grad_norm {float(met['grad_norm']):.3f}, params moved "
            f"max {moved:.3e}, first step {dt * 1e3:.1f} ms eager; captured step: first call "
            f"(eager + capture) {first * 1e3:.1f} ms, replay {replay * 1e3:.1f} ms, second "
            f"step's params against two eager steps: {differ} of {len(pairs)} leaves differ, max "
            f"|delta| {dmax:.3e}" + (f" (ops without a deterministic implementation: {nondet})"
                                     if nondet else "") +
            f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, graph pool "
            f"{graph_pool_bytes(model) / 2**30:.2f} GiB")
        require(math.isfinite(loss) and moved > 0, f"p14c {arch}: loss {loss}, moved {moved}")
        require(math.isfinite(float(gmet["loss"])), f"p14c {arch}: replayed loss {gmet['loss']}")
        require(nondet or differ == 0,
                f"p14c {arch}: the replayed second step differs from the eager one in {differ} "
                f"of {len(pairs)} leaves (max |delta| {dmax:.3e}) with no op warned")
        require(family._cache_size() == 1, f"p14c {arch}: {family._cache_size()} captures")
        del model, params, p1, o1, p2, gp, go, batches, met, gmet, step, family
        gc.collect()
        torch.cuda.empty_cache()


def phase14_serve(card, params):
    """14d: the trained parameters serve 4 requests through the engine on
    the kernel backend, graphed, with exact launch counts; the prefill and
    first-decode logits held to the plain route by ``E2E_BF16_RATIO``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine, make_requests

    parity_bf16("smollm-135m", params=params)
    cfg = get_config("smollm-135m")
    model = Model(cfg)
    watch = StepLog(model)
    engine = ServingEngine(model, params, max_seq=2048, kv_layout="paged", block_size=16,
                           max_batch=4)
    reqs = make_requests(4, 1e3, vocab=cfg.vocab_size, max_new_tokens=16,
                         prompt_lens=tuple(range(64, 513)), rng=np.random.default_rng(14))
    reset_launches()
    out = engine.serve(reqs)
    n = read_launches()
    L = cfg.num_layers
    decodes = watch.n("decode_step_paged")
    prefills = watch.n("prefill", "prefill_with_prefix")
    s = headline("p14d trained smollm-135m, paged, graphed", engine.stats, card)
    log(f"p14d serve: {decodes} decode steps -> {n['paged']} paged launches (= {L} x {decodes}); "
        f"{prefills} prefills -> {n['flash']} flash launches (= {L} x {prefills}); "
        f"{compiled(engine)} captured step entries")
    require(decodes > 0 and n["paged"] == L * decodes, f"p14d: paged launches {n}")
    require(prefills > 0 and n["flash"] == L * prefills, f"p14d: flash launches {n}")
    require(compiled(engine) > 0, "p14d: no step was captured")
    require(not bool(watch.bad), "p14d: non-finite logits")
    require(s["n_requests"] == len(out) == 4 and all(len(t) > 0 for t in out.values()),
            "p14d: not every request finished with tokens")
    return n


def _p14_tanh_stack(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


def p14_rank(rank, world, out, device="cuda", reduced=False):
    """One of 14e's 2 gloo ranks on the card: the data-parallel smollm-135m
    step (float32, full width, depth 2, B = 4 split over "data") against
    the single-device step, then ``compressed_psum`` and the 2-stage
    pipeline over "pod". Rank 0 saves what it found. ``device="cpu"`` with
    ``reduced`` rehearses it at ``.reduced()`` width on the CPU."""
    import pickle

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.parallel.pipeline import pipelined_apply
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import flatten

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = {}
    mesh = make_test_mesh((2,), ("data",), device=dev)
    cfg = get_config("smollm-135m")
    # remat "none": the mesh is under test here, and a fresh process's
    # first step under "dots" pays the selective checkpoint's setup
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg, num_layers=2, dtype="float32",
                              remat="none")
    model = Model(cfg, device=dev)
    params = model.init(seed=5)
    batch = SyntheticLMData(cfg, batch=4, seq=256, seed=3, device=dev).batch_at(0)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    col.reset_stats()
    t0 = time.perf_counter()
    p2, _, met = make_train_step(model, opt, mesh=mesh)(params, opt.init(params), batch)
    if cuda:
        torch.cuda.synchronize()
    found["dp_wall_ms"] = (time.perf_counter() - t0) * 1e3
    found["collectives"] = dict(col.STATS)
    p1, _, met1 = make_train_step(model, opt)(params, opt.init(params), batch)
    col.check_replicated(mesh, *[p.cpu().numpy() for p in flatten(p2)[0]], what="parameters")
    found["loss"], found["loss_single"] = float(met["loss"]), float(met1["loss"])
    found["params_diff"] = max(float((a - b).abs().max())
                               for a, b in zip(flatten(p2)[0], flatten(p1)[0]))
    pod = make_test_mesh((2,), ("pod",), device=dev)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
    mean, err = compressed_psum(g, pod, "pod", torch.zeros_like(g))
    found["compress"] = {"recon": float((mean + err - g).abs().max()),
                         "err_max": float(err.abs().max()), "g_max": float(g.abs().max())}
    # rank r holds g·(1 + r): one scale, 2·max|g| / 127, and the int8 sum
    mean_r, _ = compressed_psum(g * (1 + rank), pod, "pod", torch.zeros_like(g))
    scale = (2 * g).abs().max() / 127.0
    q = [torch.clamp(torch.round(g * (1 + r) / scale), -127, 127) for r in (0, 1)]
    found["compress"]["shared_scale"] = float((mean_r - (q[0] + q[1]) * scale / 2).abs().max())
    ws = torch.from_numpy((rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).to(dev)
    got = pipelined_apply(_p14_tanh_stack, ws.reshape(2, 2, 8, 8), x, mesh=pod, n_micro=4)
    want = _p14_tanh_stack(ws[2:], _p14_tanh_stack(ws[:2], x))
    found["pipeline"] = float((got - want).abs().max())
    found["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if rank == 0:
        with open(os.path.join(out, "rank0.pkl"), "wb") as f:
            pickle.dump(found, f)


class _P14Mesh:
    """14e's 2 gloo rank processes (``p14_rank``), started on a thread of
    their own so that they share the card with 14a's runs, which leave it
    mostly idle; ``finish`` joins them and re-raises what they raised."""

    def __init__(self, device="cuda", reduced=False):
        import threading

        from repro_torch.launch.mesh import run_ranks

        self.out = os.path.join(P14_DIR, "mesh")
        os.makedirs(self.out, exist_ok=True)
        self.t0, self.error = time.perf_counter(), None

        def ranks():
            try:
                run_ranks(p14_rank, 2, self.out, device, reduced,
                          store=os.path.join(self.out, "store"), timeout_s=600.0)
            except BaseException as e:  # raised again by finish()
                self.error = e

        self.thread = threading.Thread(target=ranks, daemon=True)
        self.thread.start()

    def finish(self, card):
        self.thread.join()
        if self.error is not None:
            raise self.error
        phase14_mesh_check(card, self.out, time.perf_counter() - self.t0)


def phase14_mesh_check(card, out, wall):
    """14e's checks and line, from what rank 0 saved under ``out``."""
    import pickle

    with open(os.path.join(out, "rank0.pkl"), "rb") as f:
        found = pickle.load(f)
    c = found["compress"]
    log(f"p14e mesh (2 gloo ranks on one {card}, {wall:.1f} s, beside 14a's runs): "
        f"data-parallel smollm-135m float32 depth 2 step loss {found['loss']:.6f} vs "
        f"single-device {found['loss_single']:.6f} (|delta| "
        f"{abs(found['loss'] - found['loss_single']):.2e} < {P14_MESH_LOSS_ATOL:g}), params max "
        f"|delta| {found['params_diff']:.2e} (< {P14_PARAM_ATOL:g}); the step "
        f"{found['dp_wall_ms']:.1f} ms wall, collectives {found['collectives']['calls']} calls "
        f"{found['collectives']['seconds'] * 1e3:.1f} ms; compressed_psum: mean + err - g "
        f"{c['recon']:.2e}, max |err| {c['err_max']:.3e} < max |g| / 64 = {c['g_max'] / 64:.3e}, "
        f"shared-scale sum {c['shared_scale']:.2e}; pipeline max |delta| {found['pipeline']:.2e} "
        f"(<= {P14_PIPE_ATOL:g}); rank 0 peak {found['peak_gb']:.2f} GiB")
    require(abs(found["loss"] - found["loss_single"]) < P14_MESH_LOSS_ATOL, "p14e: loss")
    require(found["params_diff"] < P14_PARAM_ATOL, "p14e: params")
    require(c["recon"] <= 1e-6 and c["err_max"] < c["g_max"] / 64 and c["shared_scale"] <= 1e-6,
            f"p14e: compressed_psum {c}")
    require(found["pipeline"] <= P14_PIPE_ATOL, f"p14e: pipeline {found['pipeline']}")


def phase14(card):
    """Phase 14: 14a-14d in order, 14e's ranks beside them from the start;
    no kernel may launch in 14a-14c (the training forward runs the
    reference route). Returns 14d's launches."""
    t0 = time.perf_counter()
    reset_launches()
    mesh = _P14Mesh()  # 14e's ranks run beside 14a's
    trained = phase14_train(card)
    log(f"p14a done at {time.perf_counter() - t0:.1f} s")
    phase14_parity(card)
    log(f"p14b done at {time.perf_counter() - t0:.1f} s")
    with card_lock("p14c"):
        phase14_families(card)
    log(f"p14c done at {time.perf_counter() - t0:.1f} s")
    n = read_launches()
    require(not any(n.values()), f"phase 14a-c launched kernels: {n}")
    log(f"p14a-c kernel launches: 0 ({sorted(n)}); {time.perf_counter() - t0:.1f} s")
    served = phase14_serve(card, trained)
    log(f"p14d done at {time.perf_counter() - t0:.1f} s")
    del trained
    torch.cuda.empty_cache()
    mesh.finish(card)
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return served


# ---------------------------------------------------------------------------
# phase 15: the profiler (core/profiler.py) on smollm-135m at full width

P15_ROWS, P15_BLOCK, P15_MAX_SEQ, P15_PREFILL = 8, 16, 2048, 1024
P15_REPLAYS, P15_TOP = 5, 5
P15_PAGED, P15_FLASH = "repro_torch::paged_decode_attention", "repro_torch::flash_attention"


def _aten_flops(ps) -> float:
    """A profiled step's FLOPs less its kernel operators' charges."""
    return ps.flops - sum(v for k, v in ps.ops.flops_by_op.items() if k.startswith("repro_torch::"))


def _mib(n) -> str:
    return f"{n / 2**20:.1f} MiB"


def p15_log(label, ps, card):
    """One profiled step's count on one line: FLOPs, bytes, collective
    bytes, the three terms on ``H100_HW``, the dominant one, the top op
    classes by modeled time and the memory estimate."""
    t, m = ps.terms, ps.memory_stats
    hot = ", ".join(f"{op} {s * 1e3:.4f}" for op, s in ps.hotspots(top=P15_TOP))
    log(f"p15 profile[{label}] (H100_HW terms; {card}): {ps.flops:.6e} FLOPs ({_aten_flops(ps):.6e} "
        f"aten), {ps.bytes_accessed:.6e} bytes, {ps.collectives.bytes_total:.0f} collective bytes; "
        f"compute {t.compute_s * 1e3:.4f} ms, memory {t.memory_s * 1e3:.4f} ms, collective "
        f"{t.collective_s * 1e3:.4f} ms: {t.dominant}-bound, bound {t.bound_s * 1e3:.4f} ms; top "
        f"{P15_TOP} ms: {hot}; memory: arguments {_mib(m.argument_size_in_bytes)}, outputs "
        f"{_mib(m.output_size_in_bytes)} ({_mib(m.alias_size_in_bytes)} aliased), temp "
        f"{_mib(m.temp_size_in_bytes)}")


def _p15_inputs(model, params, device, reduced):
    """Real inputs of the three steps: 8 paged rows holding the caches of
    128-1024-token prompts (prefilled eagerly), a 1024-token prompt, and
    phase 14a's first batch split for accumulation (reduced: 16-64-token
    prompts, a 64-token prompt, B = 4, S = 64)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.serve.kv_cache import PagedKVCache

    cfg = model.cfg
    rng = np.random.default_rng(15)
    lo, hi, n_prompt, B, S = (16, 65, 64, 4, 64) if reduced else (128, 1025, P15_PREFILL, P14_BATCH,
                                                                  P14_SEQ)
    max_seq = 128 if reduced else P15_MAX_SEQ
    kv = PagedKVCache(model, P15_ROWS, max_seq, block_size=P15_BLOCK)
    for r in range(P15_ROWS):
        toks = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi))))
        row, _ = kv.try_admit(r, toks, 64)
        _, cache = model.prefill(params, torch.tensor([toks], device=device), max_seq)
        kv.write_prefill(row, cache)
    for r in range(P15_ROWS):
        kv.ensure_tail(r)
    pool, tables, lens = kv.kernel_inputs()
    tok = torch.zeros((P15_ROWS, 1), dtype=torch.long, device=device)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n_prompt))).to(device)
    data = SyntheticLMData(cfg, batch=B, seq=S, seed=0, device=device)
    batch = _p14_accum(data.batch_at(0), cfg.train_accum)
    return {"decode": (pool, tables, lens, tok), "prefill": (prompt,), "train": batch}, max_seq


def phase15_counts(card, device="cuda", reduced=False):
    """15a-b: the three steps counted by ``profile_step``, first on meta
    arguments (nothing allocated or run; the kernels charged at the
    tables' reach), then run once eagerly on real tensors under the
    counter (the kernels charged by these lengths): the aten FLOPs must
    agree, every decode step show the paged operator and every prefill
    the flash operator once a layer; each real run's peak allocation
    beside the counter's estimate. Returns the model, its parameters, the
    real inputs and the real counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import profile_step
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import map_tree

    cfg = get_config("smollm-135m")
    cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16") if reduced else cfg
    cfg = dataclasses.replace(cfg, remat="dots")
    L, accum = cfg.num_layers, cfg.train_accum
    opt = AdamW(lr=1e-3, warmup_steps=5, total_steps=P14_STEPS)
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    inputs, max_seq = _p15_inputs(model, params, device, reduced)
    mm = Model(cfg, device="meta")

    def steps(m):
        return {"decode": lambda p, *a: m.decode_step_paged(p, *a, backend="kernel"),
                "prefill": lambda p, t: m.prefill(p, t, max_seq, backend="kernel"),
                "train": lambda p, o, b: make_train_step(m, opt, accum_steps=accum)(p, o, b)}

    def to_meta(tree):
        return map_tree(lambda t: torch.empty_like(t, device="meta"), tree)

    labels = {"decode": f"decode_step_paged kernel, {P15_ROWS} rows BS={P15_BLOCK} max_seq {max_seq}",
              "prefill": f"prefill kernel, B=1 S={inputs['prefill'][0].shape[1]}",
              "train": f"train step B={inputs['train']['tokens'].shape[1] * accum} "
                       f"S={inputs['train']['tokens'].shape[2]} accum {accum} remat dots"}
    name = f"smollm-135m{' reduced' if reduced else ''} bf16"
    mp = mm.init()
    args = {"decode": (mp,) + to_meta(inputs["decode"]), "prefill": (mp,) + to_meta(inputs["prefill"]),
            "train": (mp, opt.init(mp), to_meta(inputs["train"]))}
    counts = {}
    for key in ("decode", "prefill", "train"):
        t0 = time.perf_counter()
        ps = profile_step(steps(mm)[key], *args[key], name=key)
        p15_log(f"{name} {labels[key]}, meta, counted in {time.perf_counter() - t0:.1f} s", ps, card)
        counts[key] = {"meta": ps}
    del args, mp
    for key in ("decode", "prefill", "train"):
        real = (params,) + tuple(inputs[key]) if key != "train" else (
            params, opt.init(params), inputs["train"])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ps = profile_step(steps(model)[key], *real, name=key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        m = ps.memory_stats
        est = m.temp_size_in_bytes + m.output_size_in_bytes - m.alias_size_in_bytes
        p15_log(f"{name} {labels[key]}, real tensors, counted in {wall:.1f} s", ps, card)
        log(f"p15 memory[{name} {key}] on {card}: the eager counted call's peak above what was "
            f"allocated before it {_mib(peak)} (torch.cuda.max_memory_allocated {_mib(base + peak)}); "
            f"the counter's estimate, temp + outputs - aliased: {_mib(est)}")
        counts[key]["real"] = ps
        del real
    for key, c in counts.items():
        a, b = _aten_flops(c["meta"]), _aten_flops(c["real"])
        require(a == b, f"p15 {key}: aten FLOPs {a:.6e} on meta, {b:.6e} on real tensors")
    for key, op in (("decode", P15_PAGED), ("prefill", P15_FLASH)):
        for kind, ps in counts[key].items():
            n, nb = ps.ops.calls_by_op.get(op, 0), ps.ops.bytes_by_op.get(op, 0.0)
            require(n == L and nb > 0, f"p15 {key} ({kind}): {op} {n} times, {nb} bytes")
    require(not any(k.startswith("repro_torch::") for ps in counts["train"].values()
                    for k in ps.ops.calls_by_op), "p15 train: a kernel operator in the train step")
    log(f"p15 check[{name}]: aten FLOPs equal on meta and real tensors for all three steps; "
        f"{P15_PAGED} {L} times a decode step, {P15_FLASH} {L} times a prefill, both with bytes; "
        f"the kernels' charges meta -> real: decode "
        f"{counts['decode']['meta'].ops.flops_by_op[P15_PAGED]:.6e} -> "
        f"{counts['decode']['real'].ops.flops_by_op[P15_PAGED]:.6e} FLOPs, prefill "
        f"{counts['prefill']['meta'].ops.flops_by_op[P15_FLASH]:.6e} -> "
        f"{counts['prefill']['real'].ops.flops_by_op[P15_FLASH]:.6e}")
    return model, params, opt, inputs, {k: c["real"] for k, c in counts.items()}


def phase15_timing(card, model, params, opt, inputs, counted):
    """15c: each step graphed (the decode and prefill step families, the
    trainer's captured step): synchronised wall and the profiler's device
    busy time, against the counted ``bound_s`` (the real tensors' count):
    the roofline share; for the train step the counter's top op classes
    beside the profiler's top device ops. Then a CUDA graph replay under
    the counter, which must raise."""
    from repro_torch.core.op_cost import OpCounter
    from repro_torch.models.model import Model
    from repro_torch.train import compiled_train_step
    from repro_torch.tree import map_tree

    def share(key, wall, busy):
        b = counted[key].terms.bound_s * 1e3
        busy_txt = "not measured" if busy is None else f"{busy:.3f} ms, roofline share {b / busy:.1%}"
        log(f"p15 roofline[smollm-135m bf16 {key}] on {card}: bound {b:.4f} ms "
            f"({counted[key].terms.dominant}); graphed wall {wall:.3f} ms, share {b / wall:.1%}; "
            f"device busy {busy_txt}")

    decode = model.jit_step("decode_step_paged")
    wall, busy = profile_split("p15 decode step, 8 paged rows, graphed",
                               lambda: decode(params, *inputs["decode"]), ("paged_decode_kernel",),
                               card)
    share("decode", wall, busy)
    prefill = model.jit_step("prefill")
    wall, busy = profile_split("p15 prefill, 1024 tokens, graphed",
                               lambda: prefill(params, *inputs["prefill"], P15_MAX_SEQ),
                               ("flash_kernel",), card)
    share("prefill", wall, busy)
    fn = compiled_train_step(Model(model.cfg), opt, accum_steps=model.cfg.train_accum)
    p, o = map_tree(torch.clone, params), opt.init(params)
    batch = inputs["train"]
    fn(p, o, batch)  # eager, then the capture
    reps = []
    for _ in range(P15_REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(p, o, batch)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.percentile(reps, 50))
    busy = profile_busy("p15 train step replay, smollm-135m bf16 B=8 S=1024 accum 2 remat dots",
                        lambda: fn(p, o, batch), wall, card)
    share("train", wall, busy)
    hot = ", ".join(f"{op} {s * 1e3:.2f}" for op, s in counted["train"].hotspots(top=P15_TOP))
    log(f"p15 hotspots[smollm-135m bf16 train step] on {card}: the counter's top {P15_TOP} op "
        f"classes by modeled ms on H100_HW: {hot} (the profiler's top device ops: the line above)")
    del fn, p, o
    # no silent zeros: a replay under the counter raises
    x = torch.zeros(4, device="cuda")
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.mul_(2)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        x.mul_(2)
    try:
        with OpCounter():
            graph.replay()
    except RuntimeError as e:
        require("op counter" in str(e), f"p15: the replay raised something else: {e}")
        log("p15 replay under the counter: raised (a replay launches nothing a dispatch mode sees)")
    else:
        require(False, "p15: a CUDA graph replay under the op counter did not raise")
    graph.replay()  # the guard goes with the counter
    torch.cuda.synchronize()


def phase15(card):
    """Phase 15: the profiler on smollm-135m at full width in bf16."""
    t0 = time.perf_counter()
    model, params, opt, inputs, counted = phase15_counts(card)
    log(f"p15 counts done at {time.perf_counter() - t0:.1f} s")
    phase15_timing(card, model, params, opt, inputs, counted)
    del model, params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: training split over "model" (tensor, sequence and expert
# parallel), the gather-once FSDP path, elastic sharded checkpoints

P16_WORLD = 4
P16_LAYERS, P16_BATCH, P16_SEQ = 2, 4, 256
# name → (arch, replaced fields, mesh shape, ranks (None: the first),
# microbatches, depth); granite at a capacity factor of E / k: an expert
# could take every token of its shard, so nothing drops. In this order.
P16_CASES = {
    # FSDP: the plain step and ZeRO-2; depth 1 (its float32 single-device
    # step peaks at 41.5 GB; first, so that beside phase 14 it meets 14a's
    # runs and not 14c's larger steps)
    "16d phi3-medium-14b (2, 2)": ("phi3-medium-14b", {"zero2": 1}, (2, 2), None, 2, 1),
    "16a smollm-135m (1, 3)": ("smollm-135m", {}, (1, 3), (0, 1, 2), 1, P16_LAYERS),
    "16a smollm-135m (2, 2)": ("smollm-135m", {}, (2, 2), None, 1, P16_LAYERS),
    "16b granite-moe-1b-a400m (2, 2)": ("granite-moe-1b-a400m", {"capacity_factor": 4.0},
                                        (2, 2), None, 1, P16_LAYERS),
    "16c mamba2-370m (2, 2)": ("mamba2-370m", {}, (2, 2), None, 1, P16_LAYERS),
}
P16_RTOL = 1e-5  # loss and grad_norm against the single-device step
P16_GRAD_TOL = 1e-4  # of each gradient leaf's largest magnitude
P16_PARAM_ATOL = 5e-2  # tests/test_sharded.py's bound on a step's parameters
P16_DIR = os.path.join(ROOT, "build", "phase16")


class _P16ShardedAux:
    """The single-device MoE with the split step's semantics: the B·S
    tokens in ``n`` contiguous shards (the split's token order), each
    routed with its own capacity, the aux loss the shards' mean (the JAX
    package's ``pmean``); swaps ``moe._moe_reference`` while entered."""

    def __init__(self, n):
        self.n = n

    def _ref(self, x2d, params, cfg):
        from repro_torch.models import moe

        ys, auxs = [], []
        for c in x2d.chunk(self.n):
            y, probs, idx = moe._moe_local(c, params, cfg)
            ys.append(y)
            auxs.append(moe.switch_aux(probs, idx))
        return torch.cat(ys), torch.stack(auxs).mean()

    def __enter__(self):
        from repro_torch.models import moe

        self.saved, moe._moe_reference = moe._moe_reference, self._ref

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._moe_reference = self.saved


def _p16_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p16_batch(cfg, accum, dev, step=0):
    from repro_torch.data import SyntheticLMData

    b = SyntheticLMData(cfg, batch=P16_BATCH * accum, seq=P16_SEQ, seed=3,
                        device=dev).batch_at(step)
    if accum > 1:
        b = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:])) for k, v in b.items()}
    return b


def _p16_stats():
    from repro_torch.parallel import collectives as col

    return {k: dict(v) for k, v in col.STATS["ops"].items()}


def _p16_bytes(tree):
    from repro_torch.tree import flatten

    return sum(t.numel() * t.element_size() for t in flatten(tree)[0])


def _p16_max(t, mesh):
    """The largest of ``t`` (a scalar) over every rank of ``mesh``."""
    from repro_torch.parallel import collectives as col

    return float(col.all_reduce_axes(t.float().reshape(1), mesh, ("data", "model"), "max"))


def _p16_bf16(tree, keep):
    """A stored parameter tree in bf16, the leaves named in ``keep`` (the
    model's float32 leaves) as they are."""
    return {k: (_p16_bf16(v, keep) if isinstance(v, dict)
                else v if k in keep else v.to(torch.bfloat16)) for k, v in tree.items()}


def _p16_step(step, opt, shards, batch, dev):
    """One split step through ``gradients`` and ``update`` (the step's own
    two halves): (loss, metrics, gradients, (params, opt state, opt
    metrics), wall ms, collectives by op of the gradients' half)."""
    from repro_torch.parallel import collectives as col

    col.reset_stats()
    _p16_sync(dev)
    t0 = time.perf_counter()
    loss, met, grads = step.gradients(shards, batch)
    ops = _p16_stats()
    new = step.update(grads, opt.init(shards), shards)
    _p16_sync(dev)
    return loss, met, grads, new, (time.perf_counter() - t0) * 1e3, ops


def p16_case(rank, world, dev, arch, over, shape, ranks, accum, layers, reduced):
    """One phase-16 case on every rank of the group: the single-device
    float32 step (one rank at a time: the card holds one whole model beside
    the ranks' shards), each rank keeping its shards of its result; the
    split float32 step (and ZeRO-2's, for a zero2 config) against it; then
    a bf16 split step's wall. What this rank found
    (None outside the case's mesh)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import in_mesh, make_test_mesh
    from repro_torch.models.model import FLOAT32_PARAMS, Model
    from repro_torch.parallel import sharding
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import flatten, map_tree

    mesh = make_test_mesh(shape, ("data", "model"), device=dev, ranks=ranks)
    inside = in_mesh(mesh)
    base = get_config(arch)
    cfg = dataclasses.replace(base.reduced() if reduced else base, num_layers=layers,
                              dtype="float32", **over)
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the card's memory is the single-device step's in turn
    batch = _p16_batch(cfg, accum, dev)
    split = Model(cfg, device=dev, mesh=mesh) if inside else None
    ref = shards = None
    for turn in range(world):
        if turn == rank and inside:
            single = Model(cfg, device=dev)
            whole = single.init(seed=5)
            step = make_train_step(single, opt, accum_steps=accum)
            with (_P16ShardedAux(math.prod(shape)) if cfg.family == "moe"
                  else contextlib.nullcontext()):
                loss, met, grads, (p1, _, om), wall, _ = _p16_step(step, opt, whole, batch, dev)
            n = sum(t.numel() for t in flatten(whole)[0])
            # this rank's shards of the results wait in host memory, so that
            # the next rank's turn has the card to itself
            ref = {"loss": float(loss), "grad_norm": float(om["grad_norm"]),
                   "ce": float(met["ce"]), "wall_ms": wall,
                   # a data-parallel rank's: the whole parameters and both moments
                   "dp_bytes": _p16_bytes(whole) + 2 * 4 * n,
                   "grads": map_tree(torch.Tensor.cpu, split.shard_params(grads)),
                   "params": map_tree(torch.Tensor.cpu, split.shard_params(p1))}
            del grads, p1, om
            if cfg.family == "moe":  # ce does not depend on the aux semantics
                ref["ce_plain"] = float(step.gradients(whole, batch)[1]["ce"])
            shards = map_tree(torch.Tensor.cpu, split.shard_params(whole))
            del whole, step, single, loss, met
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    if not inside:
        return None
    if rank == 0:
        log(f"p16 {arch} {shape}: the single-device steps done")
    shards = map_tree(lambda t: t.to(dev), shards)  # the reference's stay on the host
    specs = flatten(split.train_split.storage, is_leaf=sharding.is_spec)[0]
    wholes = [tuple(t.shape) for t in flatten(split.abstract_params()[0])[0]]
    want_shapes = [tuple(d // sharding.axis_size(mesh, sharding.spec_axes(e))
                         for d, e in zip(w, sp)) for w, sp in zip(wholes, specs)]
    found = {"single": {k: v for k, v in ref.items() if k not in ("grads", "params")},
             "split": {k: getattr(split.train_split, k)
                       for k in ("attn", "mlp", "moe", "ssm", "vocab")}}
    runs = {"plain": {}}
    if cfg.zero2:
        runs["zero2"] = {"zero2_axes": split.param_axes()}
    for name, kw in runs.items():
        # ZeRO-2's gathered leaves are a heavy case's peak (14.9 GiB a rank
        # for phi3): it takes its turn on the card with phase 14's
        heavy = name == "zero2" and arch in HEAVY and dev.type == "cuda"
        with card_lock(f"p16 {arch} zero2", rank, dist.barrier) if heavy else \
                contextlib.nullcontext():
            _p16_run(found, name, kw, split, opt, accum, shards, batch, dev, mesh, ref,
                     want_shapes, cfg)
    return found


def _p16_run(found, name, kw, split, opt, accum, shards, batch, dev, mesh, ref, want_shapes,
             cfg):
    """One of ``p16_case``'s split runs (``name``: plain or zero2): the
    float32 step against the single-device one's results ``ref``, then a
    bf16 step's wall."""
    from repro_torch.models.model import FLOAT32_PARAMS, Model
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten

    step = make_train_step(split, opt, accum_steps=accum, **kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loss, met, grads, (p2, o2, om), wall, ops = _p16_step(step, opt, shards, batch, dev)
    rel = g_err = 0.0
    for g, want in zip(flatten(grads)[0], flatten(ref["grads"])[0], strict=True):
        err = _p16_max((g.cpu() - want).abs().max(), mesh)
        top = _p16_max(want.abs().max(), mesh)
        if err / max(top, 1e-30) >= rel:
            rel, g_err = err / max(top, 1e-30), err
    p_err = max(_p16_max((a.cpu() - b).abs().max(), mesh)
                for a, b in zip(flatten(p2)[0], flatten(ref["params"])[0], strict=True))
    found[name] = {
        "loss": float(loss), "grad_norm": float(om["grad_norm"]), "ce": float(met["ce"]),
        "grad_rel": rel, "grad_err": g_err, "param_err": p_err, "wall_ms": wall, "ops": ops,
        "held_bytes": _p16_bytes(p2) + _p16_bytes(o2.mu) + _p16_bytes(o2.nu),
        "shapes_ok": [tuple(t.shape) for t in flatten(p2)[0]] == want_shapes == [
            tuple(t.shape) for t in flatten(o2.mu)[0]],
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0}
    del grads, p2, o2
    # bf16: one split step's wall (the float32 step ran the same shapes)
    bsplit = Model(dataclasses.replace(cfg, dtype="bfloat16"), device=dev, mesh=mesh)
    bkw = {"zero2_axes": bsplit.param_axes()} if kw else {}
    bstep = make_train_step(bsplit, opt, accum_steps=accum, **bkw)
    bparams = _p16_bf16(shards, FLOAT32_PARAMS)
    _, _, _, _, bwall, bops = _p16_step(bstep, opt, bparams, batch, dev)
    found[name]["bf16_wall_ms"], found[name]["bf16_ops"] = bwall, bops
    del bparams, bsplit, bstep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p16_elastic(rank, world, dev, reduced):
    """16e: smollm-135m (depth 2, float32) stepped once on (2, 2) and
    saved; the uninterrupted second step on (2, 2) against the checkpoint
    restored onto (1, 3) (ranks 0-2) and onto one device (rank 0), each
    stepping once more. What this rank found."""
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import in_mesh, make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW, OptState, make_train_step
    from repro_torch.tree import flatten

    base = get_config("smollm-135m")
    cfg = dataclasses.replace(base.reduced() if reduced else base, num_layers=P16_LAYERS,
                              dtype="float32")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    b0, b1 = (_p16_batch(cfg, 1, dev, step) for step in (0, 1))
    ckdir = os.path.join(P16_DIR, "ckpt")
    found = {}

    def tree_specs(model):
        sp = model.train_split.storage
        return {"params": sp, "opt": OptState(step=(), mu=sp, nu=sp)}

    mesh22 = make_test_mesh((2, 2), ("data", "model"), device=dev)
    m22 = Model(cfg, device=dev, mesh=mesh22)
    whole = Model(cfg, device=dev).init(seed=5)
    shards = m22.shard_params(whole)
    del whole
    step = make_train_step(m22, opt)
    p1, o1, _ = step(shards, opt.init(shards), b0)
    ckpt = CheckpointManager(ckdir, keep=1)
    t0 = time.perf_counter()
    ckpt.save(1, {"params": p1, "opt": o1}, mesh=mesh22, specs=tree_specs(m22), blocking=True)
    found["save_ms"] = (time.perf_counter() - t0) * 1e3
    saved = [t.cpu() for t in flatten(m22.gather_params(p1))[0]]
    p2, _, met = step(p1, o1, b1)
    want = [t.cpu() for t in flatten(m22.gather_params(p2))[0]]
    found["uninterrupted"] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    del p1, o1, p2, shards
    dist.barrier()
    mesh13 = make_test_mesh((1, 3), ("data", "model"), device=dev, ranks=(0, 1, 2))
    if in_mesh(mesh13):
        m13 = Model(cfg, device=dev, mesh=mesh13)
        like = m13.shard_params(Model(cfg, device=dev).init(seed=9))
        got, meta = ckpt.restore({"params": like, "opt": opt.init(like)}, mesh=mesh13,
                                 specs=tree_specs(m13))
        back = [t.cpu() for t in flatten(m13.gather_params(got["params"]))[0]]
        p2, _, met = make_train_step(m13, opt)(got["params"], got["opt"], b1)
        again = [t.cpu() for t in flatten(m13.gather_params(p2))[0]]
        found["(1, 3)"] = {
            "restored_bitwise": all(torch.equal(a, b) for a, b in zip(back, saved, strict=True)),
            "step": meta["step"], "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "param_err": max(float((a - b).abs().max()) for a, b in zip(again, want))}
        del got, p2, like
    dist.barrier()
    if rank == 0:
        one = Model(cfg, device=dev)
        like = one.init(seed=9)
        got, meta = ckpt.restore({"params": like, "opt": opt.init(like)})
        back = [t.cpu() for t in flatten(got["params"])[0]]
        p2, _, met = make_train_step(one, opt)(got["params"], got["opt"], b1)
        found["one device"] = {
            "restored_bitwise": all(torch.equal(a, b) for a, b in zip(back, saved, strict=True)),
            "step": meta["step"], "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "param_err": max(float((a.cpu() - b).abs().max())
                             for a, b in zip(flatten(p2)[0], want))}
        del got, p2, like, one
    dist.barrier()
    return found


def p16_rank(rank, world, out, device="cuda", reduced=False):
    """One of phase 16's ``P16_WORLD`` gloo ranks on the card: every case
    of ``P16_CASES``, then 16e; saves what it found (every rank: its peak
    memory is its own). ``device="cpu"`` with ``reduced`` rehearses it at
    ``.reduced()`` width on the CPU."""
    import pickle

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    found, t0 = {}, time.perf_counter()
    for label, (arch, over, shape, ranks, accum, layers) in P16_CASES.items():
        t = time.perf_counter()
        found[label] = p16_case(rank, world, dev, arch, over, shape, ranks, accum, layers, reduced)
        if found[label] is not None:
            found[label]["case_s"] = time.perf_counter() - t
        if rank == 0:
            log(f"p16 {label} done at {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    found["16e"] = p16_elastic(rank, world, dev, reduced)
    found["16e"]["case_s"] = time.perf_counter() - t
    found["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(found, f)


def _p16_ops(ops) -> str:
    return ", ".join(f"{op} {v['calls']} calls {v['seconds'] * 1e3:.1f} ms "
                     f"{v['bytes'] / 2**20:.1f} MiB" for op, v in sorted(ops.items()))


def phase16_check(card, out, wall):
    """Phase 16's lines and limits, from what the ranks saved under
    ``out``."""
    import pickle

    found = []
    for r in range(P16_WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            found.append(pickle.load(f))
    for label, (arch, over, shape, ranks, accum, layers) in P16_CASES.items():
        mine = [f[label] for f in found if f[label] is not None]
        f0, single = mine[0], mine[0]["single"]
        sp = f0["split"]
        for name in [k for k in ("plain", "zero2") if k in f0]:
            got = f0[name]
            dl = abs(got["loss"] - single["loss"]) / abs(single["loss"])
            dg = abs(got["grad_norm"] - single["grad_norm"]) / single["grad_norm"]
            log(f"p16[{label}{' zero2' if name == 'zero2' else ''}] float32 depth {layers}, "
                f"B={P16_BATCH * accum} S={P16_SEQ} accum {accum}, split attn={sp['attn'] or '-'} "
                f"mlp={sp['mlp']} vocab={sp['vocab']} experts={sp['moe']} ssm={sp['ssm']} on "
                f"{card}: loss {got['loss']:.6f} vs single-device {single['loss']:.6f} (rel "
                f"{dl:.2e}), grad_norm {got['grad_norm']:.6f} vs {single['grad_norm']:.6f} (rel "
                f"{dg:.2e}); largest leaf gradient |delta| {got['grad_err']:.3e} = "
                f"{got['grad_rel']:.2e} of its leaf's max; stepped params max |delta| "
                f"{got['param_err']:.2e}; params + moments a rank "
                f"{got['held_bytes'] / 2**20:.1f} MiB vs data-parallel "
                f"{single['dp_bytes'] / 2**20:.1f} MiB; peak per rank "
                + "/".join(f"{m[name]['peak_gb']:.2f}" for m in mine)
                + f" GiB; float32 step {got['wall_ms']:.1f} ms (single-device "
                f"{single['wall_ms']:.1f} ms), bf16 step {got['bf16_wall_ms']:.1f} ms; "
                f"collectives a step (gradients, rank 0): {_p16_ops(got['ops'])}; bf16: "
                f"{_p16_ops(got['bf16_ops'])}")
            require(dl <= P16_RTOL and dg <= P16_RTOL, f"p16 {label} {name}: loss/grad_norm")
            require(got["grad_rel"] <= P16_GRAD_TOL, f"p16 {label} {name}: gradients")
            require(got["param_err"] < P16_PARAM_ATOL, f"p16 {label} {name}: params")
            require(all(m[name]["shapes_ok"] for m in mine), f"p16 {label} {name}: shard shapes")
            # every leaf a split region holds is split (the rehearsal's reduced
            # widths may split none)
            require(got["held_bytes"] < single["dp_bytes"]
                    or not any(sp[k] for k in ("mlp", "moe", "ssm", "vocab")),
                    f"p16 {label} {name}: bytes held")
            if "ce_plain" in single:
                require(abs(got["ce"] - single["ce_plain"]) <= P16_RTOL * single["ce_plain"],
                        f"p16 {label}: ce {got['ce']} vs plain {single['ce_plain']}")
        if "zero2" in f0:
            pg, zg = (f0[k]["ops"].get("all_gather", {}) for k in ("plain", "zero2"))
            log(f"p16[{label}] all-gathers a step (rank 0, float32): plain "
                f"{pg.get('calls', 0)} calls {pg.get('bytes', 0) / 2**20:.1f} MiB, zero2 "
                f"{zg.get('calls', 0)} calls {zg.get('bytes', 0) / 2**20:.1f} MiB")
            require(0 < zg.get("calls", 0) < pg.get("calls", 0), "p16: zero2 gathers fewer")
    e = found[0]["16e"]
    u = e["uninterrupted"]
    for where in ("(1, 3)", "one device"):
        got = e[where]
        dl = abs(got["loss"] - u["loss"]) / abs(u["loss"])
        log(f"p16[16e smollm-135m elastic] saved on (2, 2) at step {got['step']} "
            f"({e['save_ms']:.1f} ms, gathered whole, rank 0 writing), restored onto {where}: "
            f"bitwise {got['restored_bitwise']}; the next step's loss {got['loss']:.6f} vs "
            f"uninterrupted {u['loss']:.6f} (rel {dl:.2e}), params max |delta| "
            f"{got['param_err']:.2e}")
        require(got["restored_bitwise"] and got["step"] == 1, f"p16 16e {where}: restore")
        require(dl <= P16_RTOL and got["param_err"] < P16_PARAM_ATOL, f"p16 16e {where}: step")
    log(f"p16 ranks ({P16_WORLD} gloo processes on one {card}): wall {wall:.1f} s; per case "
        + ", ".join(f"{k} {found[0][k]['case_s']:.1f} s" for k in list(P16_CASES) + ["16e"]
                    if found[0][k] is not None))


class Phase16:
    """Phase 16's ``P16_WORLD`` gloo rank processes (``p16_rank``), started
    on a thread of their own: beside phases 14 and 15 in the whole run, as
    14e's ranks run beside 14a. ``finish`` joins them, re-raises what they
    raised (a failure in any rank fails the phase) and makes the checks."""

    def __init__(self, device="cuda", reduced=False):
        import threading

        from repro_torch.launch.mesh import run_ranks

        os.makedirs(P16_DIR, exist_ok=True)
        self.t0, self.error = time.perf_counter(), None

        def ranks():
            try:
                run_ranks(p16_rank, P16_WORLD, P16_DIR, device, reduced,
                          store=os.path.join(P16_DIR, "store"), timeout_s=600.0)
            except BaseException as e:  # raised again by finish()
                self.error = e

        self.thread = threading.Thread(target=ranks, daemon=True)
        self.thread.start()

    def finish(self, card):
        self.thread.join()
        if self.error is not None:
            raise self.error
        phase16_check(card, P16_DIR, time.perf_counter() - self.t0)


def phase16(card, device="cuda", reduced=False):
    """Phase 16 alone (the CPU rehearsal's entry): its ranks, then the
    checks."""
    Phase16(device, reduced).finish(card)


# ---------------------------------------------------------------------------
# phase 17: prefill and slot decode split over "model", and the dry run

P17_WORLD = 4
# label → (arch, overrides, ("data", "model") mesh): full width, depth cut
P17_CASES = {
    "smollm-135m": ("smollm-135m", {}, (1, 4)),  # 9 heads on 4: seq_sp, kv_seq
    "phi3-medium-14b": ("phi3-medium-14b", {"num_layers": 1}, (1, 4)),  # heads, kv_seq
    "stablelm-3b": ("stablelm-3b", {"num_layers": 2}, (1, 4)),  # heads and kv heads, int8
    "mamba2-370m": ("mamba2-370m", {"num_layers": 2}, (1, 4)),  # SSM heads
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {"num_layers": 2, "capacity_factor": 4.0},
                             (2, 2)),  # heads, kv heads, experts; nothing drops
}
# the CPU rehearsal's reduced configs keep each case's split
P17_REHEARSAL = {"smollm-135m": {"n_heads": 3, "n_kv_heads": 1}, "stablelm-3b": {"n_kv_heads": 4}}
P17_B, P17_S, P17_MAX_SEQ, P17_STEPS = 2, 512, 1024, 8
P17_RTOL = 1e-5  # the split's float32 logits and cache against one device's
# an int8 cache: the split sums in another order, so a value a float32 ulp
# from a rounding tie may take the next code (at most one apart, at fewer
# than P17_TIE_SHARE of the codes; its bf16 scale one bf16 ulp); where a
# code differs, the logits are held to P17_TIE_RTOL
P17_TIE_SHARE = 1e-3
P17_TIE_RTOL = 1e-3
P17_DIR = os.path.join(ROOT, "build", "phase17")
# 17b: dry-run cells at (32, 8), counted in a process of their own
P17B_CELLS = [("smollm-135m", s, False) for s in ("train_4k", "prefill_32k", "decode_32k",
                                                    "long_500k")] + [
    ("phi3-medium-14b", "train_4k", False), ("dbrx-132b", "decode_32k", False),
    ("zamba2-2.7b", "long_500k", False), ("smollm-135m", "decode_32k", True)]
P17B_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.dryrun import run_cell
for arch, shape, legacy in json.loads(sys.argv[2]):
    rec = run_cell(arch, shape, multi_pod=False, legacy=legacy, verbose=False)
    print("P17B " + json.dumps(rec), flush=True)
"""
# 17c: rank 0 of (32, 8) on the card with real bf16 tensors
P17C_CELLS = (("smollm-135m", "decode_32k"), ("smollm-135m", "train_4k"))
P17C_LEN = 32000  # the decode cell's committed lengths (its cache holds 32768 positions)


def _p17_cfg(arch, over, reduced, dtype):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), **P17_REHEARSAL.get(arch, {}))
        over = {k: v for k, v in over.items() if k != "num_layers"}
    return dataclasses.replace(cfg, dtype=dtype, **over)


def _p17_round(tree, keep):
    """``tree``'s float32 leaves rounded to bf16 in place, the leaves named
    in ``keep`` as they are; returns ``tree``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _p17_round(v, keep)
        elif k not in keep:
            v.copy_(v.to(torch.bfloat16))
    return tree


def _p17_clone(tree):
    return {k: _p17_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _p17_run(model, params, prompt, steps, backend, routes=None, replay=None):
    """A prefill (``max_seq`` P17_MAX_SEQ) and a decode of each column of
    ``steps`` on ``backend`` → (float32 logits of each call, the cache
    after the prefill and after the last decode, the launches); ``routes``
    records a MoE's expert choices, ``replay`` routes on them."""
    routing = (moe_routes(record=routes, replay=replay)
               if routes is not None or replay is not None else contextlib.nullcontext())
    reset_launches()
    with torch.no_grad(), routing:
        logits, cache = model.prefill(params, prompt, P17_MAX_SEQ, backend=backend)
        outs, caches = [logits.float()], [_p17_clone(cache)]
        for i in range(steps.shape[1]):
            logits, cache = model.decode_step(params, cache, steps[:, i:i + 1], backend=backend)
            outs.append(logits.float())
        caches.append(cache)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return outs, caches, read_launches()


def _p17_rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _p17_cache_errs(got, want, model, split):
    """The split's caches against this rank's slices of one device's
    (``cache_axes`` and the rules' spec): the float leaves' largest
    relative error, the int8 codes apart (at most one each) and the bf16
    scales' largest error in bf16 ulps."""
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten

    e = {"cache": 0.0, "codes_off": 0, "codes": 0, "scale_ulps": 0.0}
    for gt, wt in zip(got, want):
        specs = flatten(sharding.tree_specs(wt, model.cache_axes(wt), split.rules),
                        is_leaf=sharding.is_spec)[0]
        for g, w, sp in zip(flatten(gt)[0], flatten(wt)[0], specs):
            mine = w[sharding.shard_slices(sp, w.shape, split.mesh)]
            require(g.shape == mine.shape,
                    f"p17: a cache shard {tuple(g.shape)}, its slice {tuple(mine.shape)}")
            if g.dtype == torch.int8:
                off = (g.int() - mine.int()).abs()
                require(int(off.max()) <= 1, "p17: an int8 code more than one apart")
                e["codes_off"] += int((off > 0).sum())
                e["codes"] += off.numel()
            elif g.dtype == torch.bfloat16:  # an int8 cache's scales
                d = (g.float() - mine.float()).abs() / mine.float().abs().clamp(min=1e-30)
                e["scale_ulps"] = max(e["scale_ulps"], float(d.max()) / 2.0 ** -7)
            elif g.is_floating_point():
                e["cache"] = max(e["cache"], _p17_rel(g.float(), mine.float()))
            else:
                require(torch.equal(g, mine), "p17: the cache lengths differ")
    return e


def _p17_expected(cfg, kind):
    """Launches of one prefill and P17_STEPS decodes on the kernel route:
    flash once an attention site in the prefill, the SSD scan once an SSM
    layer, and the paged kernel once a site a decode step: its partials
    mode where the cache is split along its positions, its int8 mode on an
    int8 cache."""
    sites = (0 if cfg.family == "ssm" else
             cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers)
    want = {k: 0 for k in read_launches()}
    want.update(flash=sites, ssd=cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0)
    paged = "partials" if kind == "kv_seq" else "paged_int8" if cfg.kv_quant else "paged"
    want[paged] += sites * P17_STEPS
    return want


def p17_case(rank, world, dev, label, reduced):
    """One case of 17a on this rank: float32 on the kernel route, one
    device's run and the split's (held together), then bf16, the split on
    the kernel route and one device's plain route, each against float32 on
    the same weights."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import FLOAT32_PARAMS, Model
    from repro_torch.parallel import collectives as col

    arch, over, shape = P17_CASES[label]
    mesh = make_test_mesh(shape, ("data", "model"), device=dev.type)
    cfg = _p17_cfg(arch, over, reduced, "float32")
    single, split = Model(cfg, device=dev), Model(cfg, device=dev, mesh=mesh)
    params = single.init(seed=17)
    kind = "" if cfg.family == "ssm" else "kv_seq" if split._attn_split()["kv_seq"] else "heads"
    rng = np.random.default_rng(17)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (P17_B, P17_S))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (P17_B, P17_STEPS))).to(dev)
    found = {"kind": kind, "mesh": shape, "layers": cfg.num_layers,
             "expected": _p17_expected(cfg, kind)}
    want, want_c, _ = _p17_run(single, params, prompt, steps, "kernel")
    shards = split.shard_params(params)
    col.reset_stats()
    t0 = time.perf_counter()
    got, got_c, found["f32_launches"] = _p17_run(split, shards, prompt, steps, "kernel")
    found["f32_wall_s"] = time.perf_counter() - t0
    found["collectives"] = {k: dict(v) for k, v in col.STATS["ops"].items()}
    found["f32"] = _p17_cache_errs(got_c, want_c, single, split)
    found["f32"]["logits"] = max(_p17_rel(g, w) for g, w in zip(got, want))
    del want, want_c, got, got_c, shards
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    # the weights rounded to bf16 in place: float32 on them is the bf16
    # runs' reference (one float32 copy a rank)
    up = _p17_round(params, FLOAT32_PARAMS)
    p16 = _p16_bf16(up, FLOAT32_PARAMS)
    moe = cfg.family == "moe"
    r_k, r_p = ([], []) if moe else (None, None)
    single16, split16 = Model(cfg16, device=dev), Model(cfg16, device=dev, mesh=mesh)
    plain, _, found["plain_launches"] = _p17_run(single16, p16, prompt, steps, "reference",
                                                  routes=r_p)
    s16 = split16.shard_params(p16)
    t0 = time.perf_counter()
    kern, _, found["bf16_launches"] = _p17_run(split16, s16, prompt, steps, "kernel", routes=r_k)
    found["bf16_wall_s"] = time.perf_counter() - t0
    ref_p, _, _ = _p17_run(single, up, prompt, steps, "reference", replay=r_p)
    ref_k = ref_p
    if moe:  # the split routes on its own shards: its float32 run replays them
        ref_k, _, _ = _p17_run(split, split.shard_params(up), prompt, steps, "reference",
                               replay=r_k)

    def rows(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    found["d_kernel"] = [rows(a, b) for a, b in zip(kern, ref_k)]
    found["d_plain"] = [rows(a, b) for a, b in zip(plain, ref_p)]
    found["finite"] = all(bool(torch.isfinite(t).all()) for t in kern)
    if dev.type == "cuda":
        found["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    return found


def p17_rank(rank, world, out, device="cuda", reduced=False):
    """One of 17a's ``P17_WORLD`` gloo ranks: every case of ``P17_CASES``;
    saves what it found. ``device="cpu"`` with ``reduced`` rehearses it at
    ``.reduced()`` width on the CPU (the plain kernels counted as
    launches)."""
    import pickle

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        p13_rehearsal_patches()
    found, t0 = {"entered": time.time()}, time.perf_counter()
    import torch.distributed as dist

    for label in P17_CASES:
        t = time.perf_counter()
        with (card_lock(f"p17 {label}", rank, dist.barrier)
              if P17_CASES[label][0] in HEAVY and dev.type == "cuda" else contextlib.nullcontext()):
            found[label] = p17_case(rank, world, dev, label, reduced)
        found[label]["case_s"] = time.perf_counter() - t
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    found["seconds"] = time.perf_counter() - t0
    found["left"] = time.time()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(found, f)


def phase17a_check(card, out, wall, started):
    """17a's lines and limits, from what the ranks saved under ``out``;
    returns the bf16 split runs' launches summed over the ranks, by case."""
    import pickle

    found = []
    for r in range(P17_WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            found.append(pickle.load(f))
    launches = {}
    for label, (arch, over, shape) in P17_CASES.items():
        mine = [f[label] for f in found]
        f0 = mine[0]
        errs = [m["f32"] for m in mine]
        ties = any(e["codes_off"] or e["scale_ulps"] for e in errs)
        lim = P17_TIE_RTOL if ties else P17_RTOL
        worst = max(e["logits"] for e in errs)
        codes = sum(e["codes"] for e in errs)
        off = sum(e["codes_off"] for e in errs)
        int8 = (f"; int8 codes one apart {off} of {codes}, scales at most "
                f"{max(e['scale_ulps'] for e in errs):.1f} bf16 ulp" if codes else "")
        log(f"p17[{label}] float32 kernel route, depth {f0['layers']} on (data, model) = "
            f"{shape}, split {f0['kind'] or 'ssm heads'}, B={P17_B} S={P17_S} max_seq "
            f"{P17_MAX_SEQ} + {P17_STEPS} decodes on {card}: logits max rel err {worst:.2e} "
            f"(limit {lim:g}), cache shards max rel err "
            f"{max(e['cache'] for e in errs):.2e}{int8}; split wall {f0['f32_wall_s']:.2f} s; "
            f"collectives (rank 0): " + _p16_ops(f0["collectives"]))
        require(worst <= lim and max(e["cache"] for e in errs) <= P17_RTOL,
                f"p17 {label}: float32 split against one device: {errs}")
        require(off <= P17_TIE_SHARE * max(codes, 1) and all(e["scale_ulps"] <= 1.0 for e in errs),
                f"p17 {label}: int8 codes {off} of {codes} apart")
        for name in ("f32_launches", "bf16_launches"):
            for r, m in enumerate(mine):
                require(m[name] == m["expected"],
                        f"p17 {label} rank {r} {name}: {m[name]} launched, {m['expected']} expected")
        require(not any(any(m["plain_launches"].values()) for m in mine),
                f"p17 {label}: the plain route launched a kernel")
        d_k = [x for call in f0["d_kernel"] for x in call]
        d_p = [x for call in f0["d_plain"] for x in call]
        rms_k, rms_p = (float(np.sqrt(np.mean(np.square(d)))) for d in (d_k, d_p))
        log(f"p17[{label} bf16] the split's kernel route vs one device's plain route, each "
            f"||. - float32||/||float32|| per row over the prefill and {P17_STEPS} decodes "
            f"({len(d_k)} rows): root mean square kernels {rms_k:.3e}, plain {rms_p:.3e}, ratio "
            f"{rms_k / rms_p:.3f} (limit {E2E_BF16_RATIO:g}); per row worst kernels "
            f"{max(d_k):.3e}, plain {max(d_p):.3e}, worst row ratio "
            f"{max(a / b for a, b in zip(d_k, d_p)):.3f}; launches a rank "
            f"{f0['bf16_launches']}; split wall "
            f"{f0['bf16_wall_s']:.2f} s; peak per rank "
            + "/".join(f"{m.get('peak_gb', 0.0):.2f}" for m in mine) + " GiB")
        require(all(m["finite"] for m in mine), f"p17 {label}: bf16 logits not finite")
        require(rms_k <= E2E_BF16_RATIO * rms_p,
                f"p17 {label}: bf16 kernel split {d_k} against plain {d_p}")
        launches[label] = {k: sum(m["bf16_launches"][k] for m in mine) for k in f0["expected"]}
    log(f"p17a ranks ({P17_WORLD} gloo processes on one {card}): wall {wall:.1f} s; the ranks "
        f"entered their cases {min(f['entered'] for f in found) - started:.1f}-"
        f"{max(f['entered'] for f in found) - started:.1f} s after the spawn and left them "
        f"{min(f['left'] for f in found) - started:.1f}-{max(f['left'] for f in found) - started:.1f}"
        f" s after it; per case (rank 0) "
        + ", ".join(f"{k} {found[0][k]['case_s']:.1f} s" for k in P17_CASES))
    return launches


class Phase17:
    """Phase 17's work that runs beside other phases: 17b's dry-run cells in
    a process of their own (no card: meta tensors under a fake group),
    started with the run, and 17a's ``P17_WORLD`` gloo rank processes on a
    thread, started by ``start_ranks``. ``finish`` joins both, re-raises
    what they raised and makes the checks."""

    def __init__(self, device="cuda", reduced=False):
        self.device, self.reduced = device, reduced
        self.error, self.thread = None, None
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        cells = P17B_CELLS if not reduced else P17B_CELLS[2:4] + P17B_CELLS[-1:]
        self.t_b = time.perf_counter()
        # at the lowest priority: it takes the host's idle cores only
        self.dry = subprocess.Popen(
            [sys.executable, "-c", P17B_SCRIPT, os.path.join(ROOT, "src"), json.dumps(cells)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
            preexec_fn=lambda: os.nice(19))

    def start_ranks(self):
        import threading

        from repro_torch.launch.mesh import run_ranks

        os.makedirs(P17_DIR, exist_ok=True)
        self.t0, self.started = time.perf_counter(), time.time()

        def ranks():
            try:
                run_ranks(p17_rank, P17_WORLD, P17_DIR, self.device, self.reduced,
                          store=os.path.join(P17_DIR, "store"), timeout_s=600.0)
            except BaseException as e:  # raised again by finish()
                self.error = e

        self.thread = threading.Thread(target=ranks, daemon=True)
        self.thread.start()

    def dry_records(self):
        """17b's records (its process joined) and its checks."""
        out, err = self.dry.communicate(timeout=900)
        wall_b = time.perf_counter() - self.t_b
        require(self.dry.returncode == 0, f"p17b dry run failed:\n{err[-4000:]}")
        recs = [json.loads(line[5:]) for line in out.splitlines() if line.startswith("P17B ")]
        return phase17b_check(recs, wall_b)

    def finish(self, card):
        """17a's ranks joined and checked → the launches of their bf16
        split runs by case, summed over the ranks."""
        self.thread.join()
        if self.error is not None:
            raise self.error
        return phase17a_check(card, P17_DIR, time.perf_counter() - self.t0, self.started)


def phase17b_check(recs, wall):
    """17b's lines: a line a cell, priced on H100_HW (the H100 SXM data
    sheet: counted, not measured)."""
    out = {}
    for rec in recs:
        tag = f"{rec['arch']} x {rec['shape']}{' --legacy' if rec['legacy'] else ''}"
        out[(rec["arch"], rec["shape"], rec["legacy"])] = rec
        if rec["status"] != "ok":
            log(f"p17b dry run [{tag}] on {rec['mesh']}: {rec['status']} ({rec.get('reason')})")
            require(rec["status"] == "skipped", f"p17b {tag}: {rec['status']}")
            continue
        rf = rec["roofline"]
        log(f"p17b dry run [{tag}] rank 0 of {rec['mesh']} ({rec['chips']} GPUs), counted on "
            f"H100_HW: ok, {rec['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB a rank, "
            f"dominant {rf['dominant']}, bound {rf['bound_s'] * 1e3:.3f} ms (compute "
            f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}, collective "
            f"{rf['collective_s'] * 1e3:.3f}), useful {rec['useful_flops_ratio']:.3f}, "
            f"{rec['flops_per_device']:.4g} FLOPs, {rec['bytes_per_device']:.4g} B, "
            f"collectives {rec['collectives']}, fallbacks {rec['sharding_fallbacks'] or 'none'}; "
            f"counted in {rec['count_s']} s")
    legacy, plain = (out.get(("smollm-135m", "decode_32k", flag)) for flag in (True, False))
    require(legacy is not None and plain is not None, "p17b: the legacy pair is missing")
    log(f"p17b --legacy smollm-135m decode_32k: {legacy['bytes_per_device']:.4g} B a rank against "
        f"{plain['bytes_per_device']:.4g} without (each layer's cache slice copied out and "
        f"back); the cells' process took {wall:.1f} s")
    require(legacy["bytes_per_device"] > plain["bytes_per_device"],
            "p17b: the legacy decode moves no more bytes")
    return out


def _p17c_args(cell, shape, gen):
    """Real tensors on the card for the meta arguments of ``cell``: floats
    normal at scale 0.02 (the decode cache's keys and values at 1), token
    ids in [0, 1000), the decode cache's committed lengths ``P17C_LEN``,
    the train batch's mask ones and its optimizer step 0."""
    from repro_torch.tree import flatten, unflatten

    leaves, spec = flatten(cell.args)
    real = []
    for t in leaves:
        if t.is_floating_point():
            real.append((torch.randn(t.shape, generator=gen, device="cuda") * 0.02).to(t.dtype))
        else:
            real.append(torch.randint(0, 1000, t.shape, generator=gen, device="cuda",
                                      dtype=t.dtype))
    args = list(unflatten(spec, real))
    if shape.startswith("decode"):
        args[1]["len"].fill_(P17C_LEN)
        for name in ("k", "v"):
            args[1][name].normal_(generator=gen)
    else:
        args[1] = args[1]._replace(step=torch.zeros((), dtype=torch.int32, device="cuda"))
        args[2]["mask"].fill_(1.0)
    return args


def phase17c_count(card, dry):
    """17c's first half, beside 17a's ranks: rank 0 of (32, 8) with real
    bf16 tensors on the card under a fake group of 256, for each of
    ``P17C_CELLS``, counted once (``profile_step`` on real tensors): its
    collective calls must equal 17b's meta count of the same cell. Dense
    cells only: under a fake group no index may come from a collective's
    result (uninitialised memory). Returns what 17c's second half times."""
    from repro_torch.core.profiler import profile_step
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import fake_ranks, make_production_mesh

    gen = torch.Generator(device="cuda").manual_seed(17)
    group = contextlib.ExitStack()  # closed by phase17c_time
    group.enter_context(fake_ranks(256, 0))
    mesh = make_production_mesh()
    cells = []
    for arch, shape in P17C_CELLS:
        rec = dry[(arch, shape, False)]
        cell = build_cell(arch, shape, mesh, device="cuda")
        args = _p17c_args(cell, shape, gen)
        real = dict(profile_step(cell.fn, *args, mesh=mesh).collectives.counts)
        require(real == rec["collectives"], f"p17c {arch} {shape}: collectives {real} on "
                f"real tensors, {rec['collectives']} on meta")
        cells.append((arch, shape, cell, args, real, rec))
    return group, cells


def phase17c_time(card, counted):
    """17c's second half, alone on the card: each cell's step once more
    (synchronised wall, ``max_memory_allocated``) and once under the
    profiler (device busy), beside the dry run's peak estimate and bound;
    then the fake group closes."""
    group, cells = counted
    with group:
        for arch, shape, cell, args, real, rec in cells:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cell.fn(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            busy = profile_busy(f"p17c {arch} {shape} rank 0 of (32, 8) bf16",
                                lambda: cell.fn(*args), wall, card)
            est, bnd = rec["memory"]["peak_estimate_bytes"], rec["roofline"]["bound_s"]
            log(f"p17c [{arch} x {shape}] rank 0 of (32, 8) under a fake group of 256, real bf16 "
                f"tensors on {card}: collective calls {real} == 17b's meta count; "
                f"max_memory_allocated {peak / 2**30:.3f} GiB (the dry run's peak estimate "
                f"{est / 2**30:.3f} GiB); one call's wall {wall:.2f} ms, device busy "
                f"{'not measured' if busy is None else f'{busy:.2f} ms'} (the dry run's bound "
                f"{bnd * 1e3:.3f} ms, counted on H100_HW: the reference route on meta)")
    cells.clear()
    torch.cuda.empty_cache()


def _p17_row(rows, counts, key, line, fn, plain_fn, check, w, lib=None):
    """One kernel row of phase 17: ``check(out, plain out)`` → (error, text)
    holds the kernel to its plain version, then both are timed beside the
    bound of the work ``w``."""
    dt = torch.bfloat16
    out = fn()
    torch.cuda.synchronize()
    err, text = check(out, plain_fn())
    ms, plain = cuda_ms(fn), cuda_ms(plain_fn, iters=5)
    bms, by = bound(w, dt)
    rows[(key, dt)] = kernel_row(err, ms, plain, bms, by, lib)
    log(f"p17 {line}: {text}; ms={fmt_ms(ms)} plain_ms={fmt_ms(plain)} bound_ms={bms:.5f} "
        f"({by}) library_ms={fmt_ms(lib) if lib else 'null'}; launches in 17a's bf16 split "
        f"runs {counts.get(key)}")


def p17_kernels(card, launches):
    """The kernels at the shapes phase 17's split path gives them (a rank's
    inputs, seeded), each held to its plain version and timed beside its
    bound → (the bf16 rows, each row's launches in 17a's bf16 split runs
    summed over the ranks)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import attention as attn

    dt, rows, P = torch.bfloat16, {}, 4
    B, S, S_l = P17_B, P17_S, P17_MAX_SEQ // P
    g = torch.Generator(device="cuda").manual_seed(170)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    def n(label, kind):
        return launches.get(label, {}).get(kind)

    counts = {"p17_flash_smollm": n("smollm-135m", "flash"),
              "p17_flash_phi3": n("phi3-medium-14b", "flash"),
              "p17_flash_stablelm": n("stablelm-3b", "flash"),
              "p17_flash_granite": n("granite-moe-1b-a400m", "flash"),
              "p17_partials_smollm": n("smollm-135m", "partials"),
              "p17_partials_phi3": n("phi3-medium-14b", "partials"),
              "p17_paged_int8_stablelm": n("stablelm-3b", "paged_int8"),
              "p17_paged_granite": n("granite-moe-1b-a400m", "paged"),
              "p17_ssd_mamba2": n("mamba2-370m", "ssd")}

    def flash_row(key, what, Bq, Sq, off, H, KV, hd):
        q, k, v = rnd(Bq, Sq, H, hd), rnd(Bq, S, KV, hd), rnd(Bq, S, KV, hd)
        _p17_row(rows, counts, key, f"flash_attention bf16 {what} B={Bq} Sq={Sq} Skv={S} "
                 f"q_offset={off} H={H} KV={KV} hd={hd}",
                 lambda: fa.flash_attention(q, k, v, off),
                 lambda: fa.plain_flash_attention(q, k, v, off),
                 lambda o, r: flash_check(o, r, dt, key), work.flash(q, k, off),
                 sdpa_ms(q, k, v, off))

    flash_row("p17_flash_smollm", "smollm-135m seq_sp rank 1's rows", B, S // P, S // P, 9, 3, 64)
    flash_row("p17_flash_phi3", "phi3-medium-14b a rank's 10 q heads, their kv heads one a q head",
              B, S, 0, 10, 10, 128)
    flash_row("p17_flash_stablelm", "stablelm-3b a rank's heads", B, S, 0, 8, 8, 80)
    flash_row("p17_flash_granite", "granite-moe-1b-a400m a (2, 2) rank's heads", 1, S, 0, 8, 4, 64)

    def partials_check(o, r):
        dm, dl, da = partials_err(o, r)
        require(max(dm, dl, da) <= PARTIALS_TOL, f"p17 partials: {dm}, {dl}, {da}")
        return max(dm, dl, da), f"max_abs_err m {dm:.3e}, l {dl:.3e}, acc {da:.3e}"

    for key, name, H, KV, hd in (("p17_partials_smollm", "smollm-135m", 9, 3, 64),
                                 ("p17_partials_phi3", "phi3-medium-14b", 40, 10, 128)):
        q, kc, vc = rnd(B, 1, H, hd), rnd(B, S_l, KV, hd), rnd(B, S_l, KV, hd)
        lens = torch.full((B,), S + 3, dtype=torch.int32, device="cuda")
        kp, vp, tables, owned, _, _ = attn.seq_shard_view(kc, vc, 1, P)
        owned = owned.to(torch.int32)
        _p17_row(rows, counts, key, f"paged_decode_attention[partials] bf16 {name} rank 1 of a "
                 f"kv_seq split of a {P17_MAX_SEQ}-position slot cache (its {S_l} positions as "
                 f"{tables.shape[1]} table entries, H={H} KV={KV} hd={hd}, len {S + 3})",
                 lambda: pda.paged_decode_attention(q, kp, vp, tables, lens, owned=owned,
                                                    partials=True),
                 lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lens, owned=owned,
                                                          partials=True),
                 partials_check, work.partials(q, kp, tables, lens, owned))

    def paged_check(o, r):
        err = (o.float() - r.float()).abs().max().item()
        require(err <= TOL[dt], f"p17 paged: {err}")
        return err, f"max_abs_err={err:.3e} (tol {TOL[dt]:.0e})"

    for key, name, Bq, H, KV, hd, int8, kv_all in (
            ("p17_paged_int8_stablelm", "stablelm-3b", B, 8, 8, 80, True, 32),
            ("p17_paged_granite", "granite-moe-1b-a400m", 1, 8, 4, 64, False, 8)):
        q, kc, vc = rnd(Bq, 1, H, hd), rnd(Bq, P17_MAX_SEQ, KV, hd), rnd(Bq, P17_MAX_SEQ, KV, hd)
        ks = vs = None
        if int8:
            (kc, ks), (vc, vs) = attn.quantize_kv(kc), attn.quantize_kv(vc)
        bs = attn._dense_block_size(P17_MAX_SEQ)
        kp, vp = attn._dense_as_pool(kc, bs), attn._dense_as_pool(vc, bs)
        ksp, vsp = ((attn._dense_as_pool(ks, bs), attn._dense_as_pool(vs, bs)) if int8
                    else (None, None))
        tables = torch.arange(Bq * (P17_MAX_SEQ // bs), dtype=torch.int32,
                              device="cuda").view(Bq, -1)
        lens = torch.full((Bq,), S + 3, dtype=torch.int32, device="cuda")
        _p17_row(rows, counts, key, f"paged_decode_attention{'[int8]' if int8 else ''} bf16 "
                 f"{name} a rank's heads of its slot cache's identity view (B={Bq} H={H} KV={KV} "
                 f"hd={hd}, {P17_MAX_SEQ} positions, len {S + 3}, plan_kv_heads={kv_all})",
                 lambda: pda.paged_decode_attention(q, kp, vp, tables, lens, ksp, vsp,
                                                    plan_kv_heads=kv_all),
                 lambda: pda.plain_paged_decode_attention(q, kp, vp, tables, lens, ksp, vsp),
                 paged_check, work.paged(q, kp, tables, lens))

    x, a, b, c, dtt = ssd_case(dt, B, S, H=8, hd=64, N=128)

    def ssd_check(o, r):
        err = (o[0].float() - r[0].float()).abs().max().item()
        rel, absol = SSD_TOL[dt]
        tol = rel * r[0].float().abs().max().item() + absol
        require(err <= tol and torch.isfinite(o[0]).all(), f"p17 ssd: {err} > {tol}")
        return err, f"y max_abs_err={err:.3e} (tol {tol:.2e})"

    _p17_row(rows, counts, "p17_ssd_mamba2", f"ssd_scan bf16 mamba2-370m a rank's 8 of 32 heads "
             f"B={B} S={S} hd=64 N=128 chunk=128",
             lambda: ssd.ssd_scan(x, a, b, c, dtt, 128),
             lambda: ssd.plain_ssd_scan(x, a, b, c, dtt, 128), ssd_check, work.ssd(x, b))
    return rows, counts


# ---------------------------------------------------------------------------
# phase 18: the system's entry points (``repro_torch.examples``), as a user
# runs them

P18_DIR = os.path.join(ROOT, "build", "phase18")
# 18a: ci.yml's serve_decode invocations (its "--backend interpret" as
# "kernel"), then the int8 paged pool and a 2-rank mesh; each is also run
# with "--backend reference", and its streams must equal that run's
P18_CLI = (
    "--tokens 8",
    "--arch smollm-135m --tokens 8 --open-loop 6 --aira",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged",
    "--arch smollm-135m --tokens 16 --open-loop 4 --spec 4",
    "--arch smollm-135m --tokens 16 --open-loop 4 --spec 4 --paged",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged --chunk 16",
    "--arch smollm-135m --tokens 8 --open-loop 4 --paged --backend kernel",
    "--arch smollm-135m --tokens 8 --open-loop 4 --spec 4 --backend kernel",
    "--arch smollm-135m --tokens 8 --open-loop 4 --paged --spec 2 --trace TRACE",
    "--arch smollm-135m --tokens 8 --open-loop 6 --paged --online",
    "--arch smollm-135m --tokens 8 --open-loop 6 --int8-kv --paged",
    "--arch smollm-135m --tokens 8 --open-loop 4 --paged --mesh 2",
)
# 18b: (label, argv) at full width through ``serve_decode.main(cfg=...)``:
# float32 against the plain route, then bf16 with its latencies (the mesh
# in float32, against one device's plain route; smollm's 9 heads over 3)
P18_FULL = (
    ("smollm fixed", "--arch smollm-135m"),
    ("smollm paged spec chunk", "--arch smollm-135m --open-loop 8 --paged --spec 4 --chunk 256"),
    ("smollm aira", "--arch smollm-135m --aira"),
    ("smollm online", "--arch smollm-135m --online --paged --open-loop 8"),
    ("smollm mesh 3", "--arch smollm-135m --mesh 3 --paged --open-loop 4"),
    ("zamba2 fixed", ""),
)
# 18c: full-width smollm-135m training (300 steps, B = 8, S = 128), one run
# uninterrupted, one killed once its step-150 checkpoint is published and
# run again over the same directory
P18_TRAIN = {False: (["--full"], 150),
             True: (["--steps", "150", "--batch", "2", "--seq", "16"], 50)}
P18_WORKERS = 2  # entry-point processes at a time, beside phases 5-17


def _p18_env():
    """The environment a user's command gets (``PYTHONPATH=src``), with one
    intra-op thread: the processes share the host's cores with phases
    5-17."""
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path else ""),
                OMP_NUM_THREADS="1")


# phase 18's processes, each the leader of its own process group (a mesh's
# ranks join their parent's): the ones still running when the script exits
# are killed with their groups
_P18_LIVE = []


def _p18_popen(cmd, **kw):
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_p18_env(), start_new_session=True, **kw)
    _P18_LIVE.append(proc)
    return proc


def _p18_kill(proc):
    import signal

    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _p18_reap():
    for proc in _P18_LIVE:
        _p18_kill(proc)


def _p18_run(module, argv, device, timeout=900):
    """``python -m repro_torch.examples.<module> argv`` as a user types it
    (``--device cpu`` added in the CPU rehearsal): its exit code, output
    and wall."""
    cmd = [sys.executable, "-m", f"repro_torch.examples.{module}", *argv]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = _p18_popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        _p18_kill(proc)
    return {"cmd": " ".join(["python", "-m", f"repro_torch.examples.{module}", *argv]),
            "rc": proc.returncode, "out": out, "err": err, "wall": time.perf_counter() - t0}


def _p18_cli_argv(i, backend, device):
    """18a's invocation ``i``, on the kernel route, or its reference run
    (``--backend reference`` on one device, without the trace: a mesh's
    streams are one device's), writing its record (and trace) under
    ``P18_DIR``."""
    line = P18_CLI[i].replace("TRACE", os.path.join(P18_DIR, f"trace{i}.json"))
    argv = shlex.split(line)
    drop = ("--backend",) + (("--mesh", "--trace") if backend == "reference" else ())
    for flag in drop:
        if flag in argv:
            del argv[argv.index(flag):argv.index(flag) + 2]
    if backend == "reference" or device == "cpu":
        # the CPU rehearsal has no kernel route: both runs take the plain one
        argv += ["--backend", "reference"]
    return argv + ["--record", os.path.join(P18_DIR, f"cli{i}_{backend}.json")]


def _p18_train(reduced, device):
    """18c: the uninterrupted run, and the run killed once its checkpoint
    at the kill step is published, then run again over its directory."""
    argv, kill_at = P18_TRAIN[reduced]
    a_dir, b_dir = os.path.join(P18_DIR, "ckpt_a"), os.path.join(P18_DIR, "ckpt_b")
    rec = {k: os.path.join(P18_DIR, f"train_{k}.json") for k in ("a", "b")}
    cmd = [sys.executable, "-m", "repro_torch.examples.train_smollm", *argv]
    dev = ["--device", "cpu"] if device == "cpu" else []
    out = {}
    logs = {k: open(os.path.join(P18_DIR, f"train_{k}.log"), "w+") for k in ("a", "b")}
    uninterrupted = _p18_popen(cmd + ["--ckpt", a_dir, "--record", rec["a"]] + dev,
                               stdout=logs["a"], stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    killed = _p18_popen(cmd + ["--ckpt", b_dir] + dev, stdout=logs["b"],
                        stderr=subprocess.STDOUT)

    def published():
        names = os.listdir(b_dir) if os.path.isdir(b_dir) else ()
        return sorted(int(n[5:]) for n in names if re.fullmatch(r"step_\d+", n))

    # killed once a checkpoint at the kill step or later is published (the
    # straggler watchdog's own checkpoints may already have retired it)
    while max(published(), default=-1) < kill_at and killed.poll() is None:
        time.sleep(0.02)
    _p18_kill(killed)
    out["killed"] = {"rc": killed.returncode, "wall": time.perf_counter() - t0,
                     "published": published()}
    out["resumed"] = _p18_run("train_smollm", argv + ["--ckpt", b_dir, "--record", rec["b"]],
                              device)
    try:
        uninterrupted.wait(timeout=900)
    finally:
        _p18_kill(uninterrupted)
    out["a"] = {"rc": uninterrupted.returncode, "wall": time.perf_counter() - t0}
    for k, f in logs.items():
        f.seek(0)
        out[f"log_{k}"] = f.read()
        f.close()
    out["records"] = rec
    return out


def p18_full(out, device="cuda", reduced=False):
    """18b, in a process of its own beside phases 5-17: first the reference
    run of each 18a command, in process (``--backend reference`` on one
    device: the command's weights, prompts and requests are seeded, so
    they are the command's own), then each ``P18_FULL`` case through
    ``serve_decode.main`` at full width (``reduced``: the CPU rehearsal's
    ``.reduced()`` configs, the kernels' plain versions counted as
    launches); the runs' own report lines go to ``out``/full.log, the
    findings to ``out``/full.json."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.examples import serve_decode as sd

    if device == "cpu":
        p13_rehearsal_patches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line() if device == "cuda" else "cpu"
    start = time.perf_counter()
    report = open(os.path.join(out, "full.log"), "w")
    for i in range(len(P18_CLI)):
        clear_plan_cache()
        with contextlib.redirect_stdout(report):
            sd.main(_p18_cli_argv(i, "reference", device), device=device)
    found = {}
    for label, line in P18_FULL:
        if reduced:  # the reduced smollm's 2 kv heads split over 2
            line = line.replace("--mesh 3", "--mesh 2")
        argv = shlex.split(line)
        args = sd.build_parser().parse_args(argv)
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if reduced else cfg
        heavy = contextlib.nullcontext() if args.arch != "zamba2-2.7b" else card_lock(
            f"p18b {label}")
        t0 = time.perf_counter()
        with heavy:
            found[label] = _p18_case(label, argv, args, cfg, device, card, reduced, report)
        found[label]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    report.close()
    with open(os.path.join(out, "full.json"), "w") as f:
        json.dump(found, f)
    log(f"p18b took {time.perf_counter() - start:.1f} s (its own process)")


def _p18_serve(report, *args, **kw):
    """``serve_decode.main``, its report lines to ``report``."""
    from repro_torch.examples import serve_decode as sd

    with contextlib.redirect_stdout(report):
        return sd.main(*args, **kw)


def _p18_prompts(sd, args, cfg):
    if args.open_loop:
        return [r.prompt for r in sd.open_loop_requests(args, cfg)]
    return list(sd.make_prompts(cfg, args.batch))


def _p18_case(label, argv, args, cfg, device, card, reduced, report):
    """One 18b case: the float32 copy of ``cfg`` on the kernel route, its
    launches exact where the formula is known (non-zero else) and its
    streams equal to the plain route's but for ties; then ``cfg`` itself
    (bf16) with its latencies from ``serving_summary()``."""
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.examples import serve_decode as sd
    from repro_torch.models.model import Model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = torch.device(device)
    L = cfg.num_layers
    res = {}
    if args.mesh > 1:  # each rank counts its own launches
        rec = _p18_serve(report, argv, device=device, cfg=cfg32)
        model = Model(cfg32, dev)
        params = model.init(seed=0)
        i = argv.index("--mesh")
        ref = _p18_serve(report, argv[:i] + argv[i + 2:] + ["--backend", "reference"],
                         device=device, model=model, params=params)
        ties = count_ties(model, params, _p18_prompts(sd, args, cfg32), ref["streams"],
                          rec["streams"], f"p18b[{label}]")
        ranks = rec["rank_launches"]
        require(not rec["mesh_fallbacks"], f"p18b[{label}]: fell back: {rec['mesh_fallbacks']}")
        require(reduced or all(r["paged"] > 0 and r["flash"] > 0 and r["partials"] == 0
                               for r in ranks),
                f"p18b[{label}]: a rank missed the paged or flash kernel: {ranks}")
        log(f"p18b[{label} float32]: {args.mesh} ranks, streams == one device's plain route "
            f"({ties} ties), launches a rank {ranks}")
        return {"ties": ties, "rank_launches": ranks}
    model = Model(cfg32, dev)
    params = model.init(seed=0)
    watch = StepLog(model)
    reset_launches()
    rec = _p18_serve(report, argv, device=device, model=model, params=params)
    n = read_launches()
    decodes = watch.n("decode_step", "decode_step_paged", "verify_step", "verify_step_paged",
                      "prefill_chunk")
    prefills = watch.n("prefill", "prefill_with_prefix")
    require(all(rec["launches"][k] == n[k] for k in rec["launches"]),
            f"p18b[{label}]: main's launches {rec['launches']} against the wrappers' {n}")
    if cfg.family == "hybrid":
        G = L // cfg.attn_every
        expect = {"paged_int8" if cfg.kv_quant else "paged": G * decodes, "flash": G * prefills,
                  "ssd": L * prefills}
    elif args.aira:
        # the region's prefill runs outside the step families, and the plan's
        # decodes too (30 launches a chunk of requests, phase 7): counted > 0
        expect = {"paged": n["paged"], "flash": L * (prefills + 1)}
        require(n["paged"] > 0, f"p18b[{label}]: the decode plan launched no paged kernel")
    else:
        expect = {"paged_int8" if cfg.kv_quant else "paged": L * decodes, "flash": L * prefills}
    check_launches(n, expect, f"p18b[{label}]")
    # a chunked run prefills through the paged kernel (``prefill_chunk``), a
    # decode plan decodes outside the step families
    require((decodes > 0 or args.aira) and (prefills > 0 or args.chunk) and not bool(watch.bad),
            f"p18b[{label}]: {decodes} decodes, {prefills} prefills, non-finite logits "
            f"{bool(watch.bad)}")
    reset_launches()
    # the plan cache keys a region by its name and items, not by the engine
    # that built its function: with equal items the reference run would
    # take the kernel run's plan (the JAX package's cache does the same)
    clear_plan_cache()
    ref = _p18_serve(report, argv + ["--backend", "reference"], device=device, model=model,
                     params=params)
    require(not any(read_launches().values()), f"p18b[{label}]: the plain route launched")
    ties = count_ties(model, params, _p18_prompts(sd, args, cfg32), ref["streams"],
                      rec["streams"], f"p18b[{label}]")
    log(f"p18b[{label} float32]: {decodes} decode/verify/chunk steps, {prefills} prefills -> "
        f"launches {rec['launches']}; streams == plain route ({ties} ties)")
    res.update(ties=ties, launches=rec["launches"], decodes=decodes, prefills=prefills)
    del model, params, watch, rec, ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = _p18_serve(report, argv, device=device, cfg=cfg)
    wall = time.perf_counter() - t0
    s = rec["summary"]
    keys = ("p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms", "p99_tpot_ms", "p50_step_ms",
            "p99_step_ms")
    log(f"p18b[{label} {cfg.dtype}] on {card}: wall {wall:.2f} s, "
        + json.dumps({k: s[k] for k in ("n_requests", "n_steps") + keys})
        + (f", acceptance {s['speculative']['acceptance_rate']:.3f}" if "speculative" in s
           else ""))
    res.update(bf16={k: s[k] for k in keys}, bf16_wall_s=wall, bf16_launches=rec["launches"])
    return res


P18_FULL_SCRIPT = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "chip_smoke.p18_full(sys.argv[2], sys.argv[3], sys.argv[4] == '1')\n"
)


class Phase18:
    """Phase 18's processes, started beside phases 5-17: 18a's commands,
    18c's training runs and 18d's adviser commands, ``P18_WORKERS`` at a
    time on a thread, and 18b's full-width cases in a process of its own.
    ``finish`` joins them and makes the checks."""

    def __init__(self, device="cuda", reduced=False):
        import atexit
        import shutil
        import threading
        from concurrent.futures import ThreadPoolExecutor

        shutil.rmtree(P18_DIR, ignore_errors=True)
        os.makedirs(P18_DIR)
        atexit.register(_p18_reap)
        self.device, self.reduced = device, reduced
        self.t0, self.results, self.error = time.perf_counter(), {}, None
        self.full = _p18_popen([sys.executable, "-c", P18_FULL_SCRIPT, ROOT, P18_DIR, device,
                                "1" if reduced else "0"])

        jobs = [("train", lambda: _p18_train(reduced, device))]
        jobs += [(("cli", i), lambda i=i: _p18_run(
            "serve_decode", _p18_cli_argv(i, "kernel", device), device))
            for i in range(len(P18_CLI))]
        jobs += [(name, lambda name=name: _p18_run(name, [], device))
                 for name in ("quickstart", "parallelize_with_aira")]

        def run():
            try:
                with ThreadPoolExecutor(P18_WORKERS) as pool:
                    futures = [(key, pool.submit(fn)) for key, fn in jobs]
                    for key, fut in futures:
                        self.results[key] = fut.result()
            except BaseException as e:  # raised again by finish()
                self.error = e
            self.wall = time.perf_counter() - self.t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def finish(self, card):
        """Join, check each part, and return the launches of 18a's kernel
        runs and 18b's float32 kernel runs, summed."""
        self.thread.join()
        rc = self.full.wait()
        if self.error is not None:
            raise self.error
        require(rc == 0, f"p18b exited {rc}")
        log(f"p18: entry-point processes {self.wall:.1f} s from the phase's start")
        totals, failed = collections.Counter(), []

        def check(fn, *args):
            # every part is checked and logged; the phase fails after them
            try:
                return fn(*args)
            except SystemExit as e:
                log(str(e))
                failed.append(str(e))

        for i, line in enumerate(P18_CLI):
            totals.update(check(self._check_cli, i, line) or {})
        with open(os.path.join(P18_DIR, "full.json")) as f:
            full = json.load(f)
        for label, found in full.items():
            totals.update(found.get("launches", {}))
            for r in found.get("rank_launches", ()):
                totals.update(r)
        check(self._check_train)
        check(self._check_adviser)
        require(not failed, f"phase 18: {len(failed)} check(s) failed")
        return dict(totals)

    def _check_cli(self, i, line):
        from repro_torch.examples import serve_decode as sd

        run = self.results[("cli", i)]
        require(run["rc"] == 0, f"p18a `{run['cmd']}` exited {run['rc']}:\n{run['err'][-3000:]}")
        recs = {}
        for b in ("kernel", "reference"):
            with open(os.path.join(P18_DIR, f"cli{i}_{b}.json")) as f:
                recs[b] = json.load(f)
        args = sd.build_parser().parse_args(shlex.split(line.replace("TRACE", "t.json")))
        kernel, ref = recs["kernel"], recs["reference"]
        want = [np.asarray(s) for s in ref["streams"]]
        got = [np.asarray(s) for s in kernel["streams"]]
        ties = 0
        if any(len(a) != len(b) or not np.array_equal(a, b) for a, b in zip(want, got)):
            from repro_torch.models.model import Model

            cfg = sd.model_config(args)
            model = Model(cfg, torch.device(self.device))
            ties = count_ties(model, model.init(seed=0), _p18_prompts(sd, args, cfg), want, got,
                              f"p18a[{i}]")
        ranks = kernel.get("rank_launches", [kernel["launches"]])
        ref_ranks = ref.get("rank_launches", [ref["launches"]])
        require(not any(v for r in ref_ranks for v in r.values()),
                f"p18a[{i}]: the plain route launched a kernel: {ref_ranks}")
        if self.device == "cuda":
            cfg = sd.model_config(args)
            # a chunked prefill runs through the paged kernel, not flash
            need = (("paged_int8" if cfg.kv_quant else "paged",)
                    + (() if args.chunk else ("flash",))
                    + (("ssd",) if cfg.family == "hybrid" else ()))
            require(all(r[k] > 0 for r in ranks for k in need) and
                    all(r["partials"] == 0 for r in ranks),
                    f"p18a[{i}]: launches {ranks}, each of {need} expected > 0")
            require("backend=kernel" in run["out"], f"p18a[{i}]: not on the kernels")
            require("kernels: paged_decode_attention" in run["out"], f"p18a[{i}]: no launch line")
        if args.trace:
            require(kernel["trace"]["spans"] > 0 and kernel["trace"]["async_spans"] > 0,
                    f"p18a[{i}]: trace {kernel['trace']}")
        if args.online:
            require(kernel["audit"] and kernel["summary"]["controller"]["decisions"] > 0,
                    f"p18a[{i}]: no controller decisions")
        if args.spec:
            require("speculative" in kernel["summary"], f"p18a[{i}]: no verify round ran")
        if args.aira:
            require(kernel["aira"]["accepted"], f"p18a[{i}]: the decode plan was not accepted")
        s = kernel["summary"]
        cmd = run["cmd"][:run["cmd"].index(" --record")]
        log(f"p18a[{i}] `{cmd}`: exit 0 in {run['wall']:.1f} s; streams == the reference "
            f"run's ({ties} ties); "
            f"launches {ranks if len(ranks) > 1 else ranks[0]}; step p50/p99 "
            f"{s['p50_step_ms']:.2f}/{s['p99_step_ms']:.2f} ms")
        return collections.Counter() if len(ranks) > 1 else collections.Counter(ranks[0])

    def _check_train(self):
        found = self.results["train"]
        a, resumed, killed = found["a"], found["resumed"], found["killed"]
        require(a["rc"] == 0,
                f"p18c uninterrupted run exited {a['rc']}:\n{found['log_a'][-3000:]}")
        require(resumed["rc"] == 0, f"p18c resumed run exited {resumed['rc']}:\n"
                                    f"{resumed['err'][-3000:]}")
        with open(found["records"]["a"]) as f:
            ra = json.load(f)
        with open(found["records"]["b"]) as f:
            rb = json.load(f)
        kill_at = P18_TRAIN[self.reduced][1]
        first = rb["first_step"]
        require(killed["published"] and first == killed["published"][-1] >= kill_at,
                f"p18c: resumed at {first}, published {killed['published']}")
        require(first < ra["step"], f"p18c: killed after the last step ({killed})")
        require(rb["events"] == [f"restored step {first}"], f"p18c: events {rb['events']}")
        require(rb["losses"] == ra["losses"][first:] and rb["loss"] == ra["loss"],
                f"p18c: the resumed run's losses differ from the uninterrupted run's "
                f"(final {rb['loss']!r} against {ra['loss']!r})")
        head, tail = np.mean(ra["losses"][:20]), np.mean(ra["losses"][-20:])
        require(tail < head, f"p18c: the loss did not fall ({head:.4f} -> {tail:.4f})")
        log(f"p18c train_smollm {' '.join(P18_TRAIN[self.reduced][0])}: {ra['step']} steps in "
            f"{a['wall']:.1f} s, loss {ra['losses'][0]:.4f} -> {ra['loss']:.4f} (mean of the "
            f"first 20 {head:.4f}, last 20 {tail:.4f}); step p50 {ra['step_ms_p50']:.2f} ms, "
            f"{ra['tokens_per_s']:.0f} tokens/s; killed at published steps "
            f"{killed['published']} ({killed['wall']:.1f} s in), resumed at {first}, final loss "
            f"{rb['loss']!r} == {ra['loss']!r} bitwise; ops without a deterministic "
            f"implementation: {ra['nondeterministic'] or 'none'}")

    def _check_adviser(self):
        from repro_torch.core.overlap_model import CPU_HW, OverlapModel
        from repro_torch.examples import quickstart

        q, p = self.results["quickstart"], self.results["parallelize_with_aira"]
        for r in (q, p):
            require(r["rc"] == 0, f"p18d `{r['cmd']}` exited {r['rc']}:\n{r['err'][-3000:]}")
        band = [f"  n={n:5d}: smt2 {a*100:+6.1f}%   smp2 {b*100:+6.1f}%"
                for n, a, b in quickstart.band(OverlapModel(CPU_HW))]
        lines = q["out"].splitlines()
        require("restructured == serial: True" in lines, "p18d quickstart: plan != serial")
        require([x for x in lines if x.startswith("  n=")] == band, "p18d quickstart: band")
        schedule = [x for x in lines if x.startswith("chosen schedule")]
        require("restructured output verified on 2048 items" in p["out"] and
                "plan reused on new items; cache: {'hits': 1, 'misses': 1, 'size': 1}"
                in p["out"], "p18d parallelize_with_aira: no exact output or no plan reuse")
        log(f"p18d quickstart: exit 0 in {q['wall']:.1f} s, restructured == serial: True, "
            f"{schedule[0] if schedule else 'no schedule'}, band {band}")
        log(f"p18d parallelize_with_aira: exit 0 in {p['wall']:.1f} s; "
            + p["out"].splitlines()[-1])


def phase18(card, device="cuda", reduced=False):
    """Phase 18 alone (the CPU rehearsal's entry, from a guarded script)."""
    return Phase18(device, reduced).finish(card)


def main(argv=()) -> int:
    """Every phase with no arguments (the smoke run); ``--phases 3,11``
    runs the build and the listed phases only (3: kernels, 4: entry
    points, 5-6: serving and parity, 7: adviser, 8, 9, 10, 11, 12, 13, 14:
    training, 15: the profiler, 16: training split over "model", 17: prefill
    and slot decode split over "model" and the dry run, 18: the entry
    points), for a short development call, and prints the rows those phases
    made."""
    phases = set(range(3, 19))
    if len(argv) == 2 and argv[0] == "--phases":
        phases = {int(p) for p in argv[1].split(",")}
    elif argv:
        print("usage: chip_smoke.py [--phases 3,11]", file=sys.stderr)
        return 2
    if 14 in phases:
        # cuBLAS reads it when it makes its first handle: phase 14a's
        # deterministic algorithms need a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run(["bash", "-lc", "nvcc --version || /usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    log(f"card: {card} | torch.cuda: {kind} x{torch.cuda.device_count()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc[-1] if nvcc else 'missing'}")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 parity needs full float32 products
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build and load: {time.perf_counter() - t0:.1f} s")

    start = time.perf_counter()
    # 17b's dry-run cells need no card: their process runs beside every phase
    p17 = Phase17() if 17 in phases else None

    def phase_done(name):
        log(f"phase {name} done at {time.perf_counter() - start:.1f} s")

    rows, entry, launches = {}, {}, {}
    phase8_launches = phase9_launches = p11_launches = p12_launches = {}
    p11_entry = 0
    if 3 in phases:
        rows.update(check_kernels())
        rows.update(check_int8())
        rows.update(check_ssd())
        rows.update(check_wide())
        check_repaired()
        op_host_us(card)
        phase_done("3")
    if 4 in phases:
        entry = drive_entry_points()
        rows.update(check_entry_kernels())
        phase_done("4")
    # no phase of one device may launch the partials mode: every call of
    # its entry point from here to phase 13 is counted
    from repro_torch.kernels import ops as kernel_ops

    partials_entry, single_device_partials = kernel_ops.paged_attention_partials, [0]

    def counted_partials(*a, **kw):
        single_device_partials[0] += 1
        return partials_entry(*a, **kw)

    kernel_ops.paged_attention_partials = counted_partials
    # phase 18's entry-point processes run beside phases 5-17 (their launches
    # are counted in their own processes); the heavy models of phases 11-13
    # and 18b's zamba2-2.7b take turns on the card (``card_lock``)
    p18 = Phase18() if 18 in phases else None
    if 5 in phases:
        launches, params = serve_full_width(card)
        launches["ssd"], params = serve_mamba2(card)
        del params
        n, params = serve_zamba2(card)
        del params
        torch.cuda.empty_cache()  # the bf16 model goes before the float32 ones
        launches["paged_int8"] = n["paged_int8"]
        launches["flash"] += n["flash"]
        launches["ssd"] += n["ssd"]
        phase_done("5")
        parity_f32("smollm-135m", ("paged", "slot"), tuple(range(64, 257)))
        # lengths the plain scan chunks by 16 or more (a prime would run
        # one-position chunks)
        parity_f32("mamba2-370m", ("slot",), tuple(range(64, 257, 16)))
        parity_f32("zamba2-2.7b", ("slot",), tuple(range(64, 257, 16)))
        parity_bf16("smollm-135m")
        parity_bf16("zamba2-2.7b")
        torch.cuda.empty_cache()
        phase_done("6")
    # phase 7 is host-bound: it runs in a process of its own beside 8-13
    p7 = Phase7(card) if 7 in phases else None
    if 8 in phases:
        phase8_launches, phase8_rows = phase8(card)
        rows.update(phase8_rows)
        phase_done("8")
    if 9 in phases:
        phase9_launches, phase9_rows = phase9(card)
        rows.update(phase9_rows)
        phase_done("9")
    if 10 in phases:
        phase10_parity(card)
        phase10_serving(card)
        phase_done("10")
    if 11 in phases:
        with card_lock("phase 11"):
            p11_rows, p11_launches, p11_entry = phase11(card)
        rows.update(p11_rows)
        phase_done("11")
    if 12 in phases:
        with card_lock("phase 12"):
            p12_rows, p12_launches = phase12(card)
        rows.update(p12_rows)
        phase_done("12")
    kernel_ops.paged_attention_partials = partials_entry
    if p7 is not None:
        p7.finish()
        phase_done("7")
    require(single_device_partials[0] == 0,
            f"phases 5-12 called the partials mode {single_device_partials[0]} times")
    log(f"partials mode calls in phases {sorted(phases & set(range(5, 13)))}: 0")
    p13_launches = {}
    if 13 in phases:
        with card_lock("phase 13"):
            p13_rows, p13_launches = phase13(card)
        rows.update(p13_rows)
        phase_done("13")
    # phase 16's ranks (their own processes) run beside phases 14 and 15,
    # 17a's beside 15 and 16's last cases; the phi3 cases take turns on the
    # card with phase 14's heavy steps (``card_lock``)
    p16 = Phase16() if 16 in phases else None
    if 14 in phases:
        phase14(card)
        phase_done("14")
    if p17 is not None:
        p17.start_ranks()
    if 15 in phases:
        phase15(card)
        phase_done("15")
    p17_counts = {}
    if p17 is not None:
        # 17c's counting (host-bound) beside 17a's ranks and 16's last cases
        dry = p17.dry_records()
        p17c = phase17c_count(card, dry)
    if p16 is not None:
        p16.finish(card)
        phase_done("16")
    if p17 is not None:
        # then 17c's timings and the kernel rows alone on the card
        p17_launches = p17.finish(card)
        phase17c_time(card, p17c)
        p17_rows, p17_counts = p17_kernels(card, p17_launches)
        rows.update(p17_rows)
        phase_done("17")
    p18_launches = {}
    if p18 is not None:
        p18_launches = p18.finish(card)
        phase_done("18")

    bf16, f32 = torch.bfloat16, torch.float32
    table = []
    for key, dtype, name, src, tpu in (
            ("paged", bf16, "paged_decode_attention", PAGED_SRC, PAGED_TPU),
            ("paged_int8", bf16, "paged_decode_attention[int8]", PAGED_SRC, PAGED_INT8_TPU),
            ("flash", bf16, "flash_attention", FLASH_SRC, FLASH_TPU),
            ("ssd", bf16, "ssd_scan", SSD_SRC, SSD_TPU),
            ("relic_matmul", bf16, "relic_matmul", MATMUL_SRC, MATMUL_TPU),
            ("relic_gemv", bf16, "relic_gemv", MATMUL_SRC, GEMV_TPU),
            ("decode", bf16, "decode_attention", DECODE_SRC, DECODE_TPU),
            ("partials", bf16, "paged_decode_attention[partials]", PAGED_SRC, PARTIALS_TPU),
            ("flash_noncausal", bf16, "flash_attention[non-causal]", FLASH_SRC, NONCAUSAL_TPU),
            # float32 at hd 1024 is 256 16-byte chunks a row: the wide path;
            # bf16 at hd 1024 is 128, the register path
            ("decode_wide", f32, "decode_attention[float32 hd=1024]", DECODE_SRC, DECODE_TPU),
            ("decode_wide", bf16, "decode_attention[bf16 hd=1024]", DECODE_SRC, DECODE_TPU),
            ("paged_wide", f32, "paged_decode_attention[float32 hd=1024]", PAGED_SRC, PAGED_TPU),
            ("paged_wide", bf16, "paged_decode_attention[bf16 hd=1024]", PAGED_SRC, PAGED_TPU),
            ("paged_int8_wide", bf16, "paged_decode_attention[int8 hd=2560]", PAGED_SRC,
             PAGED_INT8_TPU),
            ("ssd_wide", bf16, "ssd_scan[N=256 hd=72 chunk=256]", SSD_SRC, SSD_TPU),
            # phase 8's shapes: launches from its serving runs at each shape
            ("paged_verify", bf16, "paged_decode_attention[verify T=5]", PAGED_SRC, PAGED_TPU),
            ("paged_chunk", bf16, "paged_decode_attention[chunk T=256]", PAGED_SRC, PAGED_TPU),
            ("paged_draft", bf16, "paged_decode_attention[draft view BS=1 MB=2053]", PAGED_SRC,
             PAGED_TPU),
            # phase 9's live widths: launches from its controlled and drift runs
            ("paged_verify3", bf16, "paged_decode_attention[verify T=3]", PAGED_SRC, PAGED_TPU),
            ("paged_verify9", bf16, "paged_decode_attention[verify T=9]", PAGED_SRC, PAGED_TPU),
            ("paged_draft2057", bf16, "paged_decode_attention[draft view BS=187 MB=11]", PAGED_SRC,
             PAGED_TPU),
            # phase 11's shapes: launches from its bf16 serving runs at each shape
            ("p11_int8", bf16, "paged_decode_attention[int8 stablelm-3b pool T=1]", PAGED_SRC,
             PAGED_INT8_TPU),
            ("p11_int8_verify", bf16, "paged_decode_attention[int8 stablelm-3b pool verify T=5]",
             PAGED_SRC, PAGED_INT8_TPU),
            ("p11_int8_chunk", bf16, "paged_decode_attention[int8 stablelm-3b chunk T=256]",
             PAGED_SRC, PAGED_INT8_TPU),
            ("p11_phi3", bf16, "paged_decode_attention[phi3-medium-14b pool T=1 g=4 hd=128]",
             PAGED_SRC, PAGED_TPU),
            ("p11_phi3_verify", bf16,
             "paged_decode_attention[phi3-medium-14b pool verify T=5 g=4 hd=128]", PAGED_SRC,
             PAGED_TPU),
            ("p11_internlm2", bf16, "paged_decode_attention[internlm2-20b pool T=1 g=6 hd=128]",
             PAGED_SRC, PAGED_TPU),
            ("p11_internlm2_verify", bf16,
             "paged_decode_attention[internlm2-20b pool verify T=5 g=6 hd=128]", PAGED_SRC,
             PAGED_TPU),
            ("p11_flash_stablelm", bf16, "flash_attention[stablelm-3b prefill S=1024 hd=80]",
             FLASH_SRC, FLASH_TPU),
            ("p11_flash_phi3", bf16, "flash_attention[phi3-medium-14b prefill S=1024 hd=128]",
             FLASH_SRC, FLASH_TPU),
            ("p11_flash_internlm2", bf16, "flash_attention[internlm2-20b prefill S=1024 hd=128]",
             FLASH_SRC, FLASH_TPU),
            ("p11_flash_noncausal", bf16, "flash_attention[non-causal B=2 S=512 hd=128]",
             FLASH_SRC, NONCAUSAL_TPU),
            # phase 12's shapes: launches from its bf16 serving runs at each shape
            ("p12_granite", bf16, "paged_decode_attention[granite-moe-1b-a400m pool T=1 g=2 hd=64]",
             PAGED_SRC, PAGED_TPU),
            ("p12_internvl2", bf16, "paged_decode_attention[internvl2-2b pool T=1 g=2 hd=128]",
             PAGED_SRC, PAGED_TPU),
            ("p12_internvl2_verify", bf16,
             "paged_decode_attention[internvl2-2b pool verify T=5 g=2 hd=128]", PAGED_SRC,
             PAGED_TPU),
            ("p12_int8", bf16, "paged_decode_attention[int8 musicgen-large pool T=1 hd=64]",
             PAGED_SRC, PAGED_INT8_TPU),
            ("p12_int8_verify", bf16,
             "paged_decode_attention[int8 musicgen-large pool verify T=5 hd=64]", PAGED_SRC,
             PAGED_INT8_TPU),
            ("p12_int8_chunk", bf16, "paged_decode_attention[int8 musicgen-large chunk T=256]",
             PAGED_SRC, PAGED_INT8_TPU),
            ("p12_flash_granite", bf16,
             "flash_attention[granite-moe-1b-a400m prefill S=1024 g=2 hd=64]", FLASH_SRC,
             FLASH_TPU),
            ("p12_flash_musicgen", bf16, "flash_attention[musicgen-large prefill S=1024 hd=64]",
             FLASH_SRC, FLASH_TPU),
            ("p12_flash_internvl2", bf16,
             "flash_attention[internvl2-2b prefill S=256+768 g=2 hd=128]", FLASH_SRC, FLASH_TPU),
            # phase 13: a head split's rank (launches from its internlm2 tp = 4 serves)
            ("p13_internlm2_tp4", bf16,
             "paged_decode_attention[internlm2-20b tp=4 rank-local T=1 H=12 KV=2 hd=128]",
             PAGED_SRC, PAGED_TPU),
            # phase 17: the split prefill and slot decode (launches from 17a's
            # bf16 kernel runs, summed over the ranks)
            ("p17_flash_smollm", bf16,
             "flash_attention[smollm-135m seq_sp rank rows Sq=128 Skv=512 q_offset=128]",
             FLASH_SRC, FLASH_TPU),
            ("p17_flash_phi3", bf16, "flash_attention[phi3-medium-14b rank heads H=10 KV=10 "
             "hd=128 S=512]", FLASH_SRC, FLASH_TPU),
            ("p17_flash_stablelm", bf16, "flash_attention[stablelm-3b rank heads H=8 KV=8 hd=80 "
             "S=512]", FLASH_SRC, FLASH_TPU),
            ("p17_flash_granite", bf16, "flash_attention[granite-moe-1b-a400m rank heads H=8 "
             "KV=4 hd=64 S=512]", FLASH_SRC, FLASH_TPU),
            ("p17_partials_smollm", bf16, "paged_decode_attention[partials smollm-135m kv_seq "
             "rank shard of a 1024 slot cache]", PAGED_SRC, PARTIALS_TPU),
            ("p17_partials_phi3", bf16, "paged_decode_attention[partials phi3-medium-14b kv_seq "
             "rank shard of a 1024 slot cache]", PAGED_SRC, PARTIALS_TPU),
            ("p17_paged_int8_stablelm", bf16, "paged_decode_attention[int8 stablelm-3b rank heads "
             "H=8 KV=8 hd=80 slot view]", PAGED_SRC, PAGED_INT8_TPU),
            ("p17_paged_granite", bf16, "paged_decode_attention[granite-moe-1b-a400m rank heads "
             "H=8 KV=4 hd=64 slot view]", PAGED_SRC, PAGED_TPU),
            ("p17_ssd_mamba2", bf16, "ssd_scan[mamba2-370m rank heads H=8 S=512]", SSD_SRC,
             SSD_TPU)):
        everything = phases == set(range(3, 19))
        if (key, dtype) not in rows:
            require(not everything, f"no row for {key}")
            continue
        r = rows[(key, dtype)]
        # the entry points are the path of the kernels that serving never
        # runs (every serving run requires their counts to stay 0); the
        # wide shapes' path is phase 3b's one driving call each, whose
        # count is in the row
        if key in ENTRY_ONLY:
            count = {"launches": entry.get(key), "serving_launches": 0}
        elif key in ("partials", "p13_internlm2_tp4"):
            # phase 13's serving runs, summed over the ranks; the partials
            # row's numbers are its seq shard's (phase 4's if 13 did not run)
            count = {"launches": p13_launches.get(key)}
            if key == "partials":
                count["entry_launches"] = entry.get(key)
        elif key in WIDE:
            count = {}
        elif key in PHASE8:
            count = {"launches": phase8_launches.get(PHASE8[key])}
        elif key in PHASE9:
            count = {"launches": phase9_launches.get(PHASE9[key])}
        elif key == "p11_flash_noncausal":
            count = {"launches": p11_entry, "serving_launches": 0}
        elif key.startswith("p11_"):
            count = {"launches": p11_launches.get(key)}
        elif key.startswith("p12_"):
            count = {"launches": p12_launches.get(key)}
        elif key.startswith("p17_"):
            count = {"launches": p17_counts.get(key)}
        else:
            count = {"launches": launches.get(key)}
        require(not everything or count.get("launches", r.get("launches")) is not None,
                f"no launch count for {key}")
        if key in ("paged", "paged_int8", "flash", "ssd") and 18 in phases:
            # phase 18: the entry points' kernel runs (18a's commands on one
            # device and 18b's float32 runs, each counted from 0 in its process)
            count["entry_point_launches"] = p18_launches.get(key, 0)
            require(count["entry_point_launches"] > 0, f"phase 18 launched no {key} kernel")
        table.append({"name": name, "route": "cuda", "source": src, "replaces": tpu, **count, **r})
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s after the build, "
        f"{time.perf_counter() - t0:.1f} s with it")
    log(json.dumps({"kernels": table}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
