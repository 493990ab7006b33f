#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths on the pubmed-sized synthetic graph at the
paper's full widths (500 features, hidden 16, 3 classes, 2 layers): GCN
inference (``forward``), full-batch GCN training (``train``) with four
fixed plans, the paper's default ``("block_diag", "bell")``, its fused
twin ``("block_diag_fused", "bell_fused")`` and the column-condensed
``("block_diag", "tcgnn_tile")`` and ``("block_diag_fused",
"tcgnn_tile_fused")``, and the main path: ``train`` with the default
config, whose feedback selector times every registry candidate of every
subgraph at both layer widths on the card and commits the fastest; then
the same for GraphSAGE (``GNNConfig(model="sage")``): two fixed plans and
its feedback main path; then GIN as the paper's Fig. 8 trains it
(``GNNConfig(model="gin", reorder="louvain")``, the port's own Louvain):
two fixed plans and its feedback main path, GIN's two layer structures on
proteins_full's 29 features, and the O1 baseline of Fig. 11; GAT's main
path (``GNNConfig(model="gat")``), the mean and max aggregators, bucket
autotuning and GCN trained over four inter buckets; mini-batch training
(``GNNConfig(sampler="cluster" | "neighbor")``: GCN, GIN and SAGE through
the PlanCache on budget-capped payloads), its asynchronous pipeline,
checkpoint/resume, retries and deterministic fault injection
(``FaultPlan``); then the LM stack's serving
paths at full
published widths: InternLM2-1.8B (flash prefill, cache prefill, greedy
decode), RWKV6-7B (the rwkv6_chunked kernel in the prefill step,
sequential cache prefill, greedy decode) and one period of Jamba-v0.1
(the mamba_scan kernel in the prefill step and the cache prefill, flash
attention in the prefill step, the MoE rule's sparse path in prefills and
its dense path in decode); and LM training: InternLM2-1.8B at full width
through launch/train.py (the flash kernel in each step's forward and in
the backward's recompute) and the families' reduced configs on the
card against the CPU (mamba_scan through mamba_scan_trainable); and the
DeepSeek family: DeepSeekMoE-16B served whole and DeepSeek-V3 at its
published widths cut to 4 layers (MLA through the flash kernel's CUDA-core
path in the prefill step and the cache prefill, the MTP block, shared and
routed experts); and the last two families whole at full width:
Qwen2-VL-7B (M-RoPE over an image's three position streams, the flash
kernel at GQA 28/4) and Whisper-large-v3 (its 1500-frame encoder, and the
flash kernel in its decoder's self-attention).  It goes
through the twelve hand-written CUDA
kernels and checks every result.  ``acc`` (the threaded accumulator, and
SAGE's dual-weight kernel) takes its default, on for CUDA tensors, except
where a phase names it.
Run it from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build: every kernel source compiles with nvcc for sm_90a, in parallel;
   prints the build time and ptxas register/spill lines;
2. kernels: each kernel against its plain PyTorch version on the card,
   float32 and bfloat16, with and without y_in, on the main path's
   payloads (B = 16) and on synthetic ones with B in {8, 32, 64}:
   block_diag_spmm (y_in also as one bias row repeated, strides (0, 1)),
   bell_spmm and tcgnn_spmm at F in {3, 16, 500}; the
   transposed read of block_diag_spmm, block_diag_spmm_fused (both reads),
   bell_spmm_fused, tcgnn_spmm_fused, bell_spmm_dw (over the transpose
   payload, and over the diagonal blocks with K = 1) and tcgnn_spmm_dw
   (over the transpose payload) at (Fi, Fo) in {(500, 16), (16, 3),
   (3, 16)}; tolerances are the reference's (tests/test_fused.py):
   float32 atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1; dW
   (float32 on both sides, from unit-scale cotangents) within 1e-5 of
   max|dW|, and the same bits on a second run;
3. forward: prepare -> init_model -> forward with acc=False and acc=True;
   launch counts are reset just before and read just after, and each
   forward kernel must have launched twice per forward; the logits must be
   finite, of shape (n_pad, 3), and agree (float32 1e-4) with the same
   forward on the CPU (plain versions) and with an independent edge-list
   GCN on the CPU;
4. gradients: one loss.backward per fixed plan on the card against the
   same on the CPU, from the same parameters, every gradient within
   float32 1e-4;
5. training: gnn.train for TRAIN_STEPS steps per fixed plan from one
   parameter set, launch counts reset just before and read just after;
   the counts must equal TRAIN_STEPS times the per-step counts plus one
   forward's; each loss curve must fall and agree (atol 5e-3, rtol 1e-2,
   the reference's own for this comparison in tests/test_fused.py) with
   the same training on the CPU (CPU_STEPS steps), with an independent
   edge-list GCN trained with autograd and the same Adam, and with the
   other plans' curves;
6. feedback (the main path): gnn.train with the default GNNConfig
   (selector "feedback", warmup_iters 2) for TRAIN_STEPS steps, launch
   counts reset just before and read just after; they must equal 2 widths
   x 3 probe calls of each forward kernel (tcgnn_spmm and tcgnn_spmm_fused
   included) plus what the committed plan launches in TRAIN_STEPS steps
   and one forward (plan_launches); prints the probe
   table (subgraph, kernel, widths, median ms, and the H100 cost model's
   estimate), the committed plan and the cost model's plan; the curve must
   agree with the same plan trained on the CPU and with the edge-list GCN
   (whose self-loops follow the committed intra kernel: the block formats
   store a self-loop that add_self_loops duplicated once, the edge lists
   twice, as in the reference);
7. SAGE: block_diag_spmm_dual against its plain version is in phase 2
   (pubmed's SAGE diagonal blocks and B in {8, 32, 64}, the SAGE layers'
   widths, float32 and bfloat16, y_in off and on, and the dual Function's
   backward: dX at the kernel tolerance, dW and dW_self within 1e-5 of
   max|dW|, the same bits twice).  Here: the logits of the fixed plans
   ("block_diag_fused", "tcgnn_tile_fused") (the dual kernel at both
   layers) and ("block_diag", "bell") (the seed path, no dual launch)
   against an independent edge-list SAGE on the CPU (float32 1e-4); 20
   training steps of each with launches per step asserted (2 dual
   launches per step on the first); then gnn.train(graph,
   GNNConfig(model="sage")) with feedback, its launches equal to the probe
   calls plus what the committed plan implies; every curve must fall and
   match the CPU run of the same plan and the edge-list SAGE trained with
   autograd (atol 5e-3, rtol 1e-2);
7a. GIN (no self-loops, unit values) on pubmed reordered by Louvain, 2
   layers, hidden 16 (Fig. 8's configuration): the Louvain reorder alone
   and ``prepare`` are timed, the permutation must be prepare's, and
   decomposition_quality (Louvain against bfs) is printed, Louvain keeping
   more edges on the diagonal.  Each of GIN_PLANS: logits on the card
   against the CPU and against an independent edge-list GIN (index_add_,
   unit values) within float32 atol 1e-4 / rtol 1e-5, then TRAIN_STEPS
   steps with the launch counts set to 0 just before and read just after,
   equal to plan_launches(model="gin"), the curve falling and matching the
   CPU's and the edge-list GIN's trained with autograd; then the main
   path, gnn.train(graph, GNNConfig(model="gin", reorder="louvain")) with
   the feedback selector, its launches the probe calls plus what the
   committed plan implies, its curve against the same plan on the CPU and
   the edge-list GIN.  [gin_structure]: proteins_full at scale 1.0 (29
   features, rows off 16-byte boundaries), GIN hidden 64, bfs; layer 1
   forced to each structure through the plan's epilogues and under the
   structure layer_plan_inputs prices on the card, for four plans: each
   forward's launches equal plan_launches(steps=0), its logits agree with
   the edge-list GIN and the two structures' with each other (atol 1e-4,
   rtol 1e-5); aggregate-first sends block_diag_spmm, bell_spmm and
   tcgnn_spmm through F = 29, the fused kernels run 29 -> 64.  [o1]: on
   the Louvain decomposition at F = 32, aggregate_full_static with each
   kernel that applies to every tier against the CPU and an edge-list
   index_add_ (float32 1e-4), and the O1 / O2 ("ell", "coo") / O3 (probed)
   times, CUDA events after a sync, as Fig. 11 times them (printed lines,
   not a benchmark);
7a'. [gat]: gnn.train(graph, GNNConfig(model="gat")) (single-head GAT, 2
   layers, hidden 16, bfs, no self-loops, unit values) with the feedback
   selector for TRAIN_STEPS steps, the launch counts set to 0 just before
   and read just after: 3 probe calls at each of the two widths of each
   unfused forward kernel, and none in the steps (GAT runs torch ops over
   the edges and reads no plan, as in the reference); the logits of its
   initial parameters on the card against the CPU and against an
   edge-list GAT (a softmax over each node's in-edges on the whole edge
   list, knowing nothing of the decomposition), float32 atol 1e-4 / rtol
   1e-5, and its curve against the CPU's and the edge-list GAT's trained
   with autograd (atol 5e-3, rtol 1e-2).  [mean_max]: on that
   decomposition at F = 16 and 500, aggregate_mean through the hand
   kernels under ("block_diag", "bell") and ("block_diag", "tcgnn_tile")
   (one launch per tier asserted) against an edge-list mean (float32
   1e-4); aggregate_max and its gradient against an edge-list max
   (scatter_reduce "amax"; values exact, gradient 1e-4), and on
   integer-valued features (tied maxima) against the CPU.  [autotune]:
   prepare(GNNConfig(inter_buckets=0)) prices k in {1, 2, 4} under
   H100_HW (totals and the committed k printed); an empty bucket's
   payloads through bell_spmm, tcgnn_spmm, the fused kernels and their
   dW (zeros, y_in, zero gradients); then GCN on a fixed 4-bucket
   decomposition under ("block_diag", "bell") and ("block_diag_fused",
   "tcgnn_tile_fused"): logits against the edge-list GCN (float32 1e-4),
   TRAIN_STEPS steps of gnn.train with the launches of plan_launches (one
   inter kernel per bucket where k = 1 runs one), each curve against the
   same plan's at k = 1 (atol 5e-3, rtol 1e-2);
7a''. [minibatch]: first each kernel over the budget-capped payloads the
   runs meet (capped bell and bell_t with n_valid < K on padded rows, capped
   tcgnn tc and tc_t, the diagonal blocks, SAGE's dual kernel, an inter
   tier with no edge under an edge budget) against its plain version as in
   phase 2, and the registry's capped dispatch (the spill's torch ops
   beside the kernels) against the CPU, values and gradients; then
   gnn.train(graph, GNNConfig(sampler=...)) for MB_STEPS steps per run of
   MB_RUNS (GCN, GIN and SAGE at 16 and 256 clusters of 16 with the
   feedback selector through the PlanCache, GCN on the neighbor sampler,
   one run with adapt_budget_k, one with probe_every=2), the launch counts
   set to 0 just before and read just after each run and equal to what its
   committed plans imply (a spill adds no launch; the probe's timed
   candidates are read from the selector audit), n_traces == len(plans);
   MB_FIXED's plans at 256 clusters (between them every GNN kernel) on the
   card and on the CPU from one parameter set: the same plans, hits and
   cache counters and losses within atol 5e-3, rtol 1e-2; telemetry on and off (deterministic algorithms on
   for both) with identical losses, plans and hits.  Per run: step ms and
   each prepare stage's ms (host clock), the device-busy us of its first
   batch's step (kernel events checked), hit rate, spill fractions, plans;
7a'''. [pipeline]: the same runs through the asynchronous batch pipeline
   (prefetch_depth=3, pipeline_workers=2: GCN, GIN and SAGE at 256
   clusters and GCN on the neighbor sampler), each against its
   [minibatch] run (the same batches, plans, hits, cache counters,
   n_traces and launches, losses within atol 5e-3, rtol 1e-2) and, both
   again under deterministic algorithms, losses bit for bit; the GCN run
   crashed at batch 20 with a checkpoint every 5 batches, sync and async,
   and resumed: the uninterrupted run exactly, no worker thread left; one
   async run probing every 2nd miss on the workers.  Per model: sync and
   async step and iteration ms, efficiency_pct, the pipeline's waits and
   ready mean, the device-busy us of a step over a staged batch, and the
   checkpoint write seconds;
7a''''. [faults]: the GCN run at 256 clusters under deterministic
   algorithms with FAULT_RETRY (retry_max=3, 1 ms base delay) and
   FaultPlan(worker_faults=FAULT_WORKER), sync and async, after the same
   settings with an empty FaultPlan (timed beside it): the fault-free
   [pipeline] run of the same side's losses bit for bit, plans, hits,
   cache counters, n_traces and launches, 3 retries counted and injected;
   FaultPlan(fatal_at={FAULT_FATAL_AT}) with retry_max=5 and a 10 s base
   delay (checkpoint every batch), sync and async: ValueError within 5 s,
   no pipeline-* or ckpt-writer thread left; FaultPlan(nonfinite_at=
   {FAULT_NONFINITE_AT}), sync: one skip, the losses before it the
   fault-free run's, NaN there, finite after; FaultPlan(crash_at=
   PIPE_CRASH_AT) with a checkpoint every PIPE_CKPT_EVERY batches, sync
   and async: SimulatedCrash, then the resumed run equals the
   uninterrupted run exactly; and one kernel of the committed plan whose
   wrapper (patched for that run only) raises RuntimeError at its first
   call, async with retry_max=3: that error, 0 retries, the wrapper
   called once, no launch beyond the first batch's step.  Per run: wall
   ms beside the fault-free run's, retries and the backoff seconds paid
   (the tracer's retry.backoff spans);
7a'''''. [serve]: the GNN inference server (repro_torch.serve) on the
   card: launch.serve.build_server trains GCN 30 steps on pubmed's
   neighbor sampler (128 seeds, fanouts (8, 4): rungs (8, 4), (4, 2),
   (2, 1)) and serves over its PlanCache; warmup, then SERVE_REQUESTS
   requests in step() mode with the launch counts set to 0 just before
   and read just after: every request ok, n_traces unchanged, the
   launches what the committed plans imply for each batch; the same
   requests through a CPU server from the same
   params and the same PlanCache snapshot (H100_HW prices it): equal
   preds, logits within atol 5e-3, rtol 1e-2 ([minibatch]'s card-vs-CPU
   tolerance); a fresh card server warm-started from that snapshot: the
   same plans, no new record, logits within 1e-6 (the reference's
   warm-start test); FaultPlan(worker_faults=SERVE_WORKER) retried on the
   request path (3 retries, no error, the same preds); FaultPlan(
   kernel_faults=...) raising NotImplementedError; an open-loop burst on
   the background thread at twice the rate max_batch / est_service_s
   (from step() mode) implies: every future terminal, no error, no
   quarantine or recovery, the ladder down at least once, launches as the
   plans imply; MB_FIXED's mb_fixed_unfused and mb_fixed_tcgnn_fused
   params served the same way through PlanCaches that commit their fixed
   plans (serve.server.plan_cache_for(fixed_kernels=)), each against a
   CPU server over the same params and plan: equal plans and preds,
   logits within SERVE_FIXED_TOL (float32 atol = rtol = 1e-4, the port's
   kernel tests' tolerance); block_diag_spmm,
   bell_spmm, block_diag_spmm_fused and tcgnn_spmm_fused must each have
   launched on the request paths (the cost-model plans of the main path
   may launch no hand kernel).  A "serving loop error" log record fails
   the phase.  Prints
   p50/p99 latency, service ms, shed %, rung and degrades, the device-busy
   us of one batch's infer (kernel events checked) and the phase's
   seconds;
7b. LM serving, InternLM2-1.8B (24 layers, d_model 2048, 16/8 heads of
   128, d_ff 8192, vocab 92544): flash_attention against its plain
   version is in phase 2 (the reference test's shapes, InternLM2's
   (4, 16, 8, 1024, 128), d = 192 with dv = 128, Sq = 64 with Skv = 256
   non-causal; float32 atol 2e-5 / rtol 1e-4, bfloat16 atol = rtol =
   5e-2, tests/test_kernels_flash.py, and also atol 4e-3 / rtol 2e-2 and,
   per output row, rms(err) <= 1e-2 rms(plain)).  Here, with launch
   counts set to 0 just before each path and read just after: the flash
   prefill step at 2 layers in float32 on the card against the CPU (plain
   versions, logits within 1e-3); all 24 layers in float32: the flash
   prefill step against the softmax core (batch 2 x 512), and prefill of
   384 tokens plus teacher-forced decode_step to 512 against the forward
   (1e-3, the reference's own invariant); in bfloat16: serve_lm (batch 4,
   prompt 1024, 32 greedy tokens, every token in [0, vocab)) and the flash
   prefill step on its prompts and parameters against the softmax core
   (|diff| <= 0.2, RMS ratio <= 0.04, and no further from the float32
   softmax core than 1.25 times the bfloat16 softmax core is) with the
   argmax agreement printed.  flash_attention must launch exactly 24 times
   per prefill-step call (2 at 2 layers) and never in the softmax core,
   prefill or decode; then the bfloat16 prefill step (flash and softmax
   core) and decode step are timed and profiled;
7c. LM serving, RWKV6-7B (32 layers, d_model 4096, 64 heads of 64, d_ff
   14336, vocab 65536, rwkv_chunk 128) under the reference's serving
   profile (wkv_core="pallas", the rwkv6_chunked kernel): rwkv6_chunked
   against its plain version (the sequential oracle) is in phase 2 (the
   reference test's shapes, RWKV6-7B's (4, 64, 1024, 64) at chunk 128 and
   (1, 64, 4096, 64); decay rates random, all at the floor log w = -1.5
   and all at w ~ 1; float32 against the plain version in float64 at atol
   5e-4 / rtol 1e-3, bfloat16 at 5e-2 / 5e-2, tests/test_kernels_rwkv6.py,
   and per output row rms(err) <= 1e-2 rms(plain); finite everywhere).
   Here, with launch counts set to 0 just before each path and read just
   after: the prefill step at 2 layers in float32 on the card against the
   CPU (batch 2 x 256, logits within 1e-3); 4 layers in float32: the
   kernel core against the plain chunked form at chunk 32, and prefill of
   256 tokens plus teacher-forced decode_step to 384 against the forward
   (1e-3); in bfloat16 at all 32 layers: serve_lm (batch 4, prompt 1024,
   32 greedy tokens, every token in [0, vocab)) and the prefill step on its
   prompts and parameters with the kernel core and the chunked form at
   chunk 32: finite logits; the same step in float32 (on the same
   bf16-valued parameters) with the kernel core against the chunked form
   at chunk 32, RMS ratio <= 0.25; the bf16 kernel core no further from
   that float32 chunked step than 1.25 times the bf16 chunked core is
   (this random-init model amplifies a perturbation about 1.3x per layer,
   so bf16 logits of two right paths differ at O(1) after 32 layers; the
   float32 sensitivity per layer is printed); argmax agreement printed;
   and at every layer, on that layer's bf16 activations, the kernel
   against its plain version at phase 2's criteria.  rwkv6_chunked must
   launch once per layer per prefill-step call and never in prefill,
   decode or the chunked core;
   then the bf16 prefill step (both cores), the cache-producing prefill
   and the decode step are timed and profiled;
7d. LM serving, Jamba-v0.1 (d_model 4096, 32/8 heads of 128, d_ff 14336,
   16 experts top-2 of d_ff 14336, Mamba d_state 16, d_inner 8192, vocab
   65536) at one 8-layer period (13.3 B parameters, 26.6 GB in bf16; the
   32 published layers do not fit one card), under the reference's
   serving profile (mamba_core="pallas", attn_core="flash"): mamba_scan
   against its plain version (the sequential oracle in float64) is in
   phase 2 (the reference test's shapes, Jamba's (4, 1024, 8192, 16) and
   (1, 4096, 8192, 16), dt ~ |N(0, 1)| * 0.1 and * 2; float32 atol = rtol
   = 1e-4, tests/test_kernels_mamba.py; a bfloat16 x at atol 1e-3 / rtol
   8e-3).  Here, with launch counts set to 0 just before each path and
   read just after: the REDUCED config (8 layers, every kind) in float32,
   prefill step, prefill and decode on the card against the CPU within
   1e-3; at full width in float32 one Mamba layer, kernel core against
   the plain scan core (1e-3), its return_state h against the float64
   oracle's final state (1e-3) and the kernel on the layer's own inputs
   (phase 2's criterion), one MoE layer at 4096 tokens, sparse without
   drops against dense (1e-3), and the drops at capacity factor 1.25; in
   bfloat16 serve_lm (batch 4, prompt 1024, 32 greedy tokens, every token
   in [0, vocab)), the prefill step with the kernel core and the plain
   core (logits compared, not gated), and the kernel at each Mamba layer
   on its own inputs (phase 2's criterion).  mamba_scan must launch 7
   times and flash_attention once per prefill-step call, mamba_scan 7
   times in serve_lm (its prefill) and nothing else there; then the bf16
   prefill step (both cores), the cache prefill, the decode step and the
   MoE layer's dense and sparse paths at 4096 and 4 tokens are timed and
   the steps profiled.  [moe_dense_bf16]: layer 1's experts in bf16 at
   4096 tokens, moe_apply_dense against a float32-sum reference (each
   expert's down product in float32, one expert at a time): within the
   bf16 gate (atol 2e-1, rtol 3e-1) and at least 98 % of the outputs
   equal to the reference rounded to bf16; the path that rounded each
   expert's output to bf16 first (the port before this repair) is read
   and timed beside it, in turns;
7e. LM training ([lm_train]): mamba_scan_trainable at Jamba's published
   Mamba widths (MAMBA_TRAIN_SHAPE, float32): one launch in the forward,
   none in the backward, output and all six input gradients against
   autograd through the plain form on the card (float32 atol = rtol =
   1e-4), forward and backward timed; each family's REDUCED config in
   float32 (InternLM2 flash core, Jamba mamba_core "pallas" and flash,
   RWKV-6 the "xla" chunked core: its kernel is forward only), 2 steps of
   make_train_step (lr 1e-3) on the card against the CPU in lockstep (the
   first from one numpy parameter tree, the second from the CPU's state),
   metrics, gradients and params at float32 atol 1e-5 / rtol 1e-4
   (params plus what each element's Adam direction differs by between
   the two runs' own moments: adam_slack_check), the launches a step
   (LM_TRAIN_REDUCED) asserted;
   then InternLM2-1.8B FULL in bf16 (flash core, remat "dots") through
   launch/train.py: 4 steps at sequence 4096, the global batch cut to 2
   sequences in 2 micro-batches, launch counts set to 0 just before and
   read just after (48 flash launches a micro-step: each layer's forward
   and its recompute; nothing else), finite losses; from its params, one
   step under the softmax core and one with accum_steps 1 against the
   flash step (loss and grad norm at the reference's bf16 atol 2e-1 /
   rtol 3e-1), 4 steps on one repeated batch whose loss must fall, step ms
   (CUDA events), tokens/s, peak memory and the device-busy share of a
   step, and compress(topk_ef) on an embedding-sized gradient timed; the
   DeepSeek, Qwen2.5, CodeQwen and Mistral-Large reduced configs join the
   2-step loop;
7f. the DeepSeek family ([deepseek]): at the published widths in float32
   (1 x 128 tokens) DeepSeekMoE-16B's first two layers through the prefill
   step and DeepSeek-V3's first MLA layer through layer_apply, card (2
   and 1 flash launches) against the CPU within 1e-3, and on the card the
   cache prefill of 120 tokens and teacher-forced decode to 128 (MLA
   absorbed) against those forwards within 1e-3; both DeepSeek REDUCED
   configs in float32, prefill step, cache prefill and decode card against
   CPU and decode against the forward (1e-3), launches asserted; then in
   bf16 DeepSeekMoE-16B FULL (28 layers) and DeepSeek-V3 cut to 4 layers
   (DEEPSEEK_CUT), one at a time and freed: serve_lm (batch 4, prompt
   1024, 32 tokens), init_params' parameter count and peak memory, the
   flash prefill step (28 launches; V3 5: 4 layers and the MTP block), the
   softmax-core step (0), the cache prefill (0; V3 4) and decode (0), the
   flash kernel at every call of the step against its plain version on
   its own operands (phase 2's criteria); the bf16 logits read, not gated
   (flash against softmax core, against the softmax core with layer 1's
   attention output moved by 2^-8, decode against a forward over the
   prompt and the decoded tokens: the random-init MoE models turn one
   bf16 rounding step into O(1) logits); the MoE rule's paths and the
   assignments its capacity drops; prefill-step ms (both cores, in
   turns), tokens/s, decode ms a token beside the time to read the
   routed experts once, device-busy shares and top device ops;
7g. the last two families ([qwen2_vl], [whisper]): both REDUCED configs
   under the serving profile, batch 2 x 128 (an image's distinct M-RoPE
   streams; 32 encoder frames), the prefill step card against CPU in
   float32 (1e-3) and bfloat16 (the LM bf16 gates), one flash launch a
   layer (3; Whisper's 2 decoder layers), and 3 train steps card against
   CPU in lockstep (train_lockstep at the LM train step's LM_TRAIN_TOL,
   6 and 4 launches a step); then, one at a time and freed, Qwen2-VL-7B
   FULL in bf16 (28 layers, 7.62 B params) at batch 4 x 1024 with one 24 x 32
   patch grid per prompt (QWEN_IMAGE): the flash prefill step (28
   launches, every call against its plain version on its own operands),
   the softmax-core step (0), flash against softmax at LM_BF16_TOL /
   LM_BF16_RMS and against a float32 step no further than LM_BF16_SPREAD
   times the softmax core, lm.prefill and 32 make_serve_step decodes (0);
   then in float32 (30.5 GB) with text positions, batch 2 x 512, the flash
   step against the softmax core and prefill of 480 + decode to 512
   against the flash step within F32_TOL; and Whisper-large-v3 FULL in
   bf16 (32 + 32 layers, 1.54 B params) at batch 8 x 1500 frames x 384
   tokens through the same phase_full_model: the flash prefill step (32
   launches, every one at the decoder's shape and against its plain
   version: none from the encoder or the cross-attention), the
   softmax-core step (0), the same bf16 gates, 32 decode steps from
   init_cache (0); in float32 the flash step against the softmax core
   (0 launches) within F32_TOL.  For each: prefill ms and tokens/s,
   decode ms a token, device-busy shares (kernel events checked) and peak
   memory, beside the card's name and power limit;
7h. the mesh tools ([mesh]): while MESH_WORKERS spawned processes run
   launch/dryrun.py's grid (every (arch x shape) cell on the abstract
   16 x 16 mesh, on meta tensors: FLOPs, bytes, fallback notes; any
   FAILED cell fails the run) and count InternLM2-1.8B FULL's train step
   at [lm_train]'s shape, the spec trees of the ten FULL configs resolve
   on 16 x 16 and 2 x 16 x 16; launch/train.py on host_local_mesh("cuda")
   (InternLM2 REDUCED, flash core, 2 x 128) equals the run without a mesh
   bit for bit with 6 flash launches a step; a mesh run crashed and
   resumed through the elastic protocol (plan_rescale, make_mesh,
   restore(shardings=)) equals the uninterrupted run bit for bit; a mesh
   larger than the card count and placing on an abstract mesh raise; the
   [lm_train] step's dry-run FLOPs over its median ms, as TFLOP/s and a
   share of the dense bf16 peak, beside the card's name and power limit;
8. timing: median forward times (acc off and on) and training-step times
   (CUDA events, host launch included; GCN's unfused and feedback plans
   also with acc off, the SAGE, GIN, GAT and 4-bucket GCN plans), each
   kernel's time at
   the main path's shapes beside its plain version, one PyTorch library
   call (or composite) computing the same function and its bound
   (bell_spmm also over the transpose payload, the backward's dX passes;
   block_diag_spmm also with the transposed read and seeded by a bias
   row; flash_attention also at Qwen2-VL-7B's and Whisper's shapes
   (FLASH_TIMED, bound by bytes and by operations printed) and at MLA's
   shape MLA_TIMED beside every scaled_dot_product_attention backend that
   takes dv != d), and
   torch.profiler tables with the device-busy share of a forward and of a
   training step per plan.

Float32 products run in full float32 (TF32 off for matmul and cuDNN), and
bfloat16 products sum in float32 (no reduced-precision reductions).
The last two lines are the kernels JSON and the device JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-1, rtol=3e-1)
# bell_spmm_dw: max|got - want| / max|want|.  dW is float32 for either input
# dtype and both sides sum the same operand values in float32, so only the
# order of the sums differs; a dropped block row or split moves dW by far
# more.  At unit-scale cotangents |dW| reaches 1e4 on the pubmed payload,
# where an absolute 1e-4 would ask for more than float32 holds.
DW_REL_TOL = 1e-5
# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
L2_FLUSH_BYTES = 128 << 20   # > the 50 MB L2: a launch after it finds L2 cold

KERNELS = {
    "block_diag_spmm": dict(
        source="src/repro_torch/kernels/csrc/block_diag_spmm.cu",
        replaces="src/repro/kernels/block_diag_spmm.py:35"),
    "bell_spmm": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm.cu",
        replaces="src/repro/kernels/bell_spmm.py:69"),
    "block_diag_spmm_fused": dict(      # bell_spmm_fused's kernel, K = 1
        source="src/repro_torch/kernels/csrc/bell_spmm_fused.cu",
        replaces="src/repro/kernels/block_diag_spmm_fused.py:54"),
    "bell_spmm_fused": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm_fused.cu",
        replaces="src/repro/kernels/bell_spmm_fused.py:71"),
    "bell_spmm_dw": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm_dw.cu",
        replaces="src/repro/kernels/bell_spmm_fused.py:145"),
    "tcgnn_spmm": dict(
        source="src/repro_torch/kernels/csrc/tcgnn_spmm.cu",
        replaces="src/repro/kernels/tcgnn_tile.py:295"),
    "tcgnn_spmm_fused": dict(
        source="src/repro_torch/kernels/csrc/tcgnn_spmm_fused.cu",
        replaces="src/repro/kernels/tcgnn_tile.py:371"),
    "tcgnn_spmm_dw": dict(
        source="src/repro_torch/kernels/csrc/tcgnn_spmm_dw.cu",
        replaces="src/repro/kernels/tcgnn_tile.py:442"),
    "block_diag_spmm_dual": dict(
        source="src/repro_torch/kernels/csrc/block_diag_spmm_dual.cu",
        replaces="src/repro/kernels/block_diag_spmm_fused.py:118"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:74"),
    "rwkv6_chunked": dict(
        source="src/repro_torch/kernels/csrc/rwkv6_chunked.cu",
        replaces="src/repro/kernels/rwkv6_chunked.py:127"),
    "mamba_scan": dict(
        source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:59"),
}
FORWARD_KERNELS = ("block_diag_spmm", "bell_spmm")
# the CUDA kernels each registry spec launches in a training step
SPEC_KERNELS = {
    "block_diag": ("block_diag_spmm",),
    "bell": ("bell_spmm",),
    "block_diag_fused": ("block_diag_spmm_fused", "bell_spmm_dw"),
    "bell_fused": ("bell_spmm_fused", "bell_spmm_dw"),
    "tcgnn_tile": ("tcgnn_spmm",),
    "tcgnn_tile_fused": ("tcgnn_spmm_fused", "tcgnn_spmm_dw"),
}

# a part of the device-function names each GNN kernel launches, as the
# profiler's events name them (kernels that share a source share its
# functions, and both dW kernels end in the reduction of dw_reduce.cuh)
DEVICE_FNS = {
    "block_diag_spmm": ("block_diag_kernel",),
    "bell_spmm": ("bell_kernel",),
    "block_diag_spmm_fused": ("bell_fused_",),
    "bell_spmm_fused": ("bell_fused_",),
    "bell_spmm_dw": ("bell_dw_partial_kernel", "dw_reduce_kernel"),
    "tcgnn_spmm": ("tcgnn_spmm_",),
    "tcgnn_spmm_fused": ("tcgnn_fused_",),
    "tcgnn_spmm_dw": ("tcgnn_dw_partial_kernel", "dw_reduce_kernel"),
    "block_diag_spmm_dual": ("block_diag_dual_",),
}


def device_events(per_call: dict) -> dict:
    """The device events per call that ``per_call`` (kernel -> launches,
    as PER_STEP spells them) implies, keyed by DEVICE_FNS's names: each
    launch is one event of each of its kernel's device functions."""
    out = {}
    for kernel, n in per_call.items():
        for fn in DEVICE_FNS[kernel] if n else ():
            out[fn] = out.get(fn, 0) + n
    return out


TRAIN_STEPS = 20
CURVE_TOL = dict(atol=5e-3, rtol=1e-2)    # tests/test_fused.py:136
PLANS = {"unfused": ("block_diag", "bell"),
         "fused": ("block_diag_fused", "bell_fused"),
         "tcgnn_unfused": ("block_diag", "tcgnn_tile"),
         "tcgnn_fused": ("block_diag_fused", "tcgnn_tile_fused")}
# steps of each plan's CPU comparison run (the plain versions on the CPU)
CPU_STEPS = {"unfused": 20, "fused": 20, "tcgnn_unfused": 5,
             "tcgnn_fused": 5}
# kernel launches per training step and per forward of each plan (2
# layers).  Unfused: per layer one launch of each forward kernel, and one
# more in the backward (layer 1's too: dW = X^T dH needs dH).  Fused: per
# layer one launch of each fused kernel and one dW launch per tier; the dX
# pass over the transpose runs for layer 2 only (layer 1's input is the
# raw features, which need no gradient).
PER_STEP = {"unfused": {"block_diag_spmm": 4, "bell_spmm": 4},
            "fused": {"block_diag_spmm_fused": 3, "bell_spmm_fused": 3,
                      "bell_spmm_dw": 4},
            "tcgnn_unfused": {"block_diag_spmm": 4, "tcgnn_spmm": 4},
            "tcgnn_fused": {"block_diag_spmm_fused": 3,
                            "tcgnn_spmm_fused": 3, "tcgnn_spmm_dw": 2,
                            "bell_spmm_dw": 2}}
PER_FORWARD = {"unfused": {"block_diag_spmm": 2, "bell_spmm": 2},
               "fused": {"block_diag_spmm_fused": 2, "bell_spmm_fused": 2},
               "tcgnn_unfused": {"block_diag_spmm": 2, "tcgnn_spmm": 2},
               "tcgnn_fused": {"block_diag_spmm_fused": 2,
                               "tcgnn_spmm_fused": 2}}
# SAGE (no self-loops, mean norm baked into the edge values) with acc on,
# the default on the card.  The dual plan's diagonal tier is one dual
# launch per layer forward, the transposed fused kernel for layer 2's dX and
# the diagonal dW kernel per layer; the seed plan runs as GCN's unfused one.
SAGE_PLANS = {"sage_dual": ("block_diag_fused", "tcgnn_tile_fused"),
              "sage_unfused": ("block_diag", "bell")}
SAGE_PER_STEP = {"sage_dual": {"block_diag_spmm_dual": 2,
                               "block_diag_spmm_fused": 1, "bell_spmm_dw": 2,
                               "tcgnn_spmm_fused": 3, "tcgnn_spmm_dw": 2},
                 "sage_unfused": {"block_diag_spmm": 4, "bell_spmm": 4}}
SAGE_PER_FORWARD = {"sage_dual": {"block_diag_spmm_dual": 2,
                                  "tcgnn_spmm_fused": 2},
                    "sage_unfused": {"block_diag_spmm": 2, "bell_spmm": 2}}


# GIN (no self-loops, unit values, the Louvain reorder), 2 layers of hidden
# 16 as the paper's Fig. 8 trains it: pubmed's 500 features exceed the
# hidden width, so both layers are transform-first and aggregate at width
# 16, seeded by the full (n, 16) self term; a plan launches per step what
# the same plan does for GCN.
GIN_PLANS = {"gin_unfused": ("block_diag", "bell"),
             "gin_tcgnn_fused": ("block_diag_fused", "tcgnn_tile_fused")}
GIN_CPU_STEPS = {"gin_unfused": 20, "gin_tcgnn_fused": 5}
# [gin_structure]: proteins_full's 29 features (116-byte rows, off 16-byte
# boundaries) under GIN of hidden 64, layer 1 in each structure
GIN_STRUCT_HIDDEN = 64
GIN_STRUCT_PLANS = (("block_diag", "bell"), ("block_diag", "tcgnn_tile"),
                    ("block_diag_fused", "tcgnn_tile_fused"),
                    ("block_diag_fused", "bell_fused"))
GIN_TOL = dict(atol=1e-4, rtol=1e-5)
# [o1]: the paper's Fig. 11 feature width (benchmarks/ablation_o123.py)
O1_WIDTH = 32
# [gat]: single-head GAT, 2 layers of hidden 16 on the bfs pubmed (no
# self-loops, unit values); steps of its CPU comparison run
GAT_CPU_STEPS = 20
# [mean_max]: the hidden width and pubmed's raw width, and the mean's plans
MEAN_MAX_WIDTHS = (16, 500)
MEAN_PLANS = (("block_diag", "bell"), ("block_diag", "tcgnn_tile"))
# [moe_dense_bf16]: the share of bf16 dense-MoE outputs that must equal the
# float32-sum reference rounded to bf16.  cuBLAS sums each expert's 14336
# products in another order than the reference's float32 GEMM, and where
# the two experts' outputs (|y| ~ 1e4) cancel that moves a small output
# across a bf16 rounding boundary: 0.9915 on the H100 (PR 31); rounding
# each expert's output to bf16 first reads 0.65
MOE_BF16_EQUAL = 0.98
# [autotune]: GCN on a fixed decomposition of AUTOTUNE_K inter buckets,
# each plan held against the same plan (PLANS' name) at k = 1
AUTOTUNE_K = 4
AUTOTUNE_PLANS = {"gcn_k4_unfused": "unfused",
                  "gcn_k4_tcgnn_fused": "tcgnn_fused"}
# [minibatch]: steps per run, the two cluster counts (16 clusters of 16 =
# benchmarks/minibatch.py's 256 nodes; 256 clusters = 4096 nodes), the
# feedback runs (mb_cfg's changes) and the fixed plans held card vs CPU
MB_STEPS = 30
MB_CLUSTERS = (16, 256)
MB_RUNS = {
    "mb_gcn_c16": dict(),
    "mb_gin_c16": dict(model="gin"),
    "mb_sage_c16": dict(model="sage"),
    "mb_gcn_c256": dict(clusters_per_batch=MB_CLUSTERS[1]),
    "mb_gin_c256": dict(model="gin", clusters_per_batch=MB_CLUSTERS[1]),
    "mb_sage_c256": dict(model="sage", clusters_per_batch=MB_CLUSTERS[1]),
    "mb_gcn_neighbor": dict(sampler="neighbor"),
    "mb_gcn_adapt_k": dict(adapt_budget_k=True),
    "mb_gcn_probe2": dict(probe_every=2, telemetry=True),
}
MB_FIXED = {"mb_fixed_unfused": ("gcn", ("block_diag", "bell")),
            "mb_fixed_tcgnn_fused": ("gcn", ("block_diag_fused",
                                             "tcgnn_tile_fused")),
            # with these two, every GNN kernel runs on a mini-batch path
            "mb_fixed_tcgnn_unfused": ("gcn", ("block_diag", "tcgnn_tile")),
            "mb_fixed_sage_bell_fused": ("sage", ("block_diag_fused",
                                                  "bell_fused"))}


# [pipeline]: the asynchronous side of each timed pair (the [minibatch]
# run of the same name is the synchronous side), the crash-resume run
# (a sampler build that raises at PIPE_CRASH_AT, a checkpoint every
# PIPE_CKPT_EVERY batches) and the probing async run
PIPE_ASYNC = dict(prefetch_depth=3, pipeline_workers=2)
PIPE_RUNS = ("mb_gcn_c256", "mb_gin_c256", "mb_sage_c256", "mb_gcn_neighbor")
PIPE_CRASH_AT = 20
PIPE_CKPT_EVERY = 5
# what bounds the overlap: one worker (no worker-against-worker contention
# for the interpreter lock) and a 0.5 ms switch interval (Python's default
# is 5 ms), each on these runs, timed only
PIPE_PROBES = {"workers_1": dict(pipeline_workers=1),
               "switch_0.5ms": dict()}
PIPE_PROBE_RUNS = ("mb_gcn_c256", "mb_gcn_neighbor")
PIPE_SWITCH_S = 0.0005
# [faults]: the run it injects into (the [pipeline] phase's deterministic
# pair of that name is the fault-free side), the retry settings, the
# transient faults per batch, the fatal batch and the NaN batch; the
# kernel wrappers (names in kernels/ops.py and in the launch counts) one
# of which is made to fail
FAULT_RUN = "mb_gcn_c256"
FAULT_RETRY = dict(retry_max=3, retry_base_delay_s=0.001)
FAULT_WORKER = {3: 2, 11: 1}
FAULT_FATAL_AT = 2
FAULT_NONFINITE_AT = 17
FAULT_WRAPPERS = ("block_diag_spmm", "bell_spmm", "block_diag_spmm_fused",
                  "bell_spmm_fused", "bell_spmm_dw", "block_diag_spmm_dual")


# [serve]: requests in step() mode (the card, the CPU, the warm start and
# each fixed plan), the step() mode's ServeConfig (every request admitted
# and served), the burst's (the reference's defaults) and its length, and
# the transient build faults by ego stream index (warmup takes 0..2)
SERVE_REQUESTS = 256
SERVE_STEP = dict(deadline_s=60.0, queue_limit=SERVE_REQUESTS, max_batch=16,
                  max_wait_s=0.0)
SERVE_BURST = dict(deadline_s=0.25, queue_limit=64, max_batch=16)
SERVE_BURST_S = 2.0
SERVE_WORKER = {3: 1, 4: 2}
SERVE_FIXED = ("mb_fixed_unfused", "mb_fixed_tcgnn_fused")
SERVE_KERNELS = ("block_diag_spmm", "bell_spmm", "block_diag_spmm_fused",
                 "tcgnn_spmm_fused")
WARM_TOL = dict(atol=1e-6, rtol=1e-6)     # tests/test_serving.py:333
SERVE_FIXED_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/torch_parity.py F32_TOL


def plan_launches(layers, steps: int, model: str = "gcn",
                  structures=None) -> dict:
    """CUDA-kernel launches of ``steps`` training steps and one forward of
    a plan (one kernel-name tuple per layer), by the rules PER_STEP and
    SAGE_PER_STEP spell out: an unfused kernel runs once forward and once
    backward; a fused one once forward, once more for dX after the first
    layer, and its dW kernel once; SAGE's block_diag_fused on the diagonal
    tier is the dual kernel forward, with the fused kernel's dX and the dW
    kernel behind it.  A GIN layer runs as GCN's unless ``structures``
    makes it aggregate-first and no fused kernel overrides that: then its
    unfused kernels aggregate the layer's input, whose gradient the first
    layer (the raw features) does not need, so there they run forward
    only."""
    out = {k: 0 for k in KERNELS}
    for li, layer in enumerate(layers):
        agg_first = (model == "gin" and structures is not None
                     and structures[li] == "aggregate_first"
                     and not any(n.endswith("_fused") for n in layer))
        for si, name in enumerate(layer):
            if model == "sage" and si == 0 and name == "block_diag_fused":
                out["block_diag_spmm_dual"] += steps + 1
                out["block_diag_spmm_fused"] += steps if li else 0
                out["bell_spmm_dw"] += steps
                continue
            kernels = SPEC_KERNELS.get(name, ())
            if not kernels:
                continue                      # torch ops: no CUDA kernel
            if len(kernels) == 1:
                out[kernels[0]] += ((2 if li or not agg_first else 1) * steps
                                    + 1)
            else:
                out[kernels[0]] += (2 if li else 1) * steps + 1
                out[kernels[1]] += steps
    return out


# The LM slice: InternLM2-1.8B (src/repro_torch/configs/internlm2_1_8b.py)
LM_ARCH = "internlm2_1_8b"
# the reference's flash tests (tests/test_kernels_flash.py): (B, Hq, Hkv,
# S, d) and their tolerances
FLASH_TEST_SHAPES = ((1, 1, 1, 64, 32), (2, 4, 2, 128, 64),
                     (1, 8, 1, 128, 128), (2, 2, 2, 256, 64))
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# bfloat16 must also hold these: the reference's 5e-2 was set at S <= 256,
# and at S = 1024 it is as large as a typical output (|o| ~ sqrt(e / S) ~
# 0.05), so a kernel that dropped a KV tile or a rescale could pass it.
# Elementwise, and the RMS of each output row's error over the RMS of
# that row of the plain version (each row on its own scale).  On an H100
# the 13 bfloat16 cases read at most 0.58 of the elementwise limit and a
# row RMS ratio of 4.3e-3; a kernel that skips the rescale of acc, or one
# KV tile, reads 50-600 times the elementwise limit.
FLASH_BF16_TIGHT = dict(atol=4e-3, rtol=2e-2)
FLASH_BF16_ROW_RMS = 1e-2
# timed shapes (B, Hq, Hkv, S, d): InternLM2's serving prefill, one
# 4096-token sequence, Qwen2-VL-7B's prefill (GQA 28/4) and Whisper's
# decoder self-attention (batch 8 x 384)
FLASH_TIMED = ((4, 16, 8, 1024, 128), (1, 16, 8, 4096, 128),
               (4, 28, 4, 1024, 128), (8, 20, 20, 384, 64))
# logits: float32 as the reference's prefill/decode invariant
# (tests/test_models_smoke.py:121-123).  bfloat16, flash vs softmax core
# (batch 4 x 1024, 24 layers): the two cores round their attention output
# once each, and 24 layers carry a one-ulp difference on.  The limits are
# set from readings on an H100: max|diff| 0.086 (max|logit| 4.9) and an
# RMS ratio of 0.018, about what bfloat16 itself moves the logits (each
# core against the softmax core in float32 on the same parameters: RMS
# ratio 0.0165).  So: |diff| <= 0.2 everywhere, rms(diff) <= 0.04
# rms(logits), and the flash core no further from float32 than
# LM_BF16_SPREAD times the softmax core is.
LM_TOL = dict(atol=1e-3, rtol=1e-3)
LM_BF16_TOL = dict(atol=2e-1, rtol=0.0)
LM_BF16_RMS = 4e-2
LM_BF16_SPREAD = 1.25
SERVE = dict(batch=4, prompt_len=1024, gen=32)

# The RWKV-6 slice: RWKV6-7B (src/repro_torch/configs/rwkv6_7b.py)
RWKV_ARCH = "rwkv6_7b"
# rwkv6_chunked's checked shapes (B, H, T, dh, chunk): the reference test's
# (tests/test_kernels_rwkv6.py), RWKV6-7B's serving prefill at its published
# chunk, and one 4096-token sequence; decays: rates N(0, 1) clipped to the
# model's [-20, 0.405], all at the floor 0.405 (log w = -1.5, where the
# reference's chunked forms overflow at chunk 128), and all at -20 (w
# within 2e-9 of 1, the state's largest growth)
RWKV_SHAPES = ((1, 2, 64, 16, 16), (2, 2, 128, 64, 32),
               (4, 64, 1024, 64, 128), (1, 64, 4096, 64, 128))
RWKV_DECAYS = ("rand", "floor", "one")
# the reference's RWKV-6 tolerances (tests/test_kernels_rwkv6.py:41-42).
# Float32 is held against the plain version run in float64: at w near 1
# over 4096 steps |o| reaches ~3000, where atol 5e-4 asks for 1e-7 of |o|,
# and the float32 oracle's own rounding reads 2.8x that limit against
# float64 (a CPU model at 16 heads).  bfloat16 also per output row:
# rms(err) <= 1e-2 rms(plain), as for flash_attention.
RWKV_TOL = {"float32": dict(atol=5e-4, rtol=1e-3),
            "bfloat16": dict(atol=5e-2, rtol=5e-2)}
RWKV_BF16_ROW_RMS = 1e-2
RWKV_TIMED = ((4, 64, 1024, 64), (1, 64, 4096, 64))
# 32 layers (batch 4 x 1024).  The model with the reference's random init
# amplifies a perturbation about 1.3x per layer on average (the sensitivity
# reading of phase 7c, PERF.md section 6), so two right bf16 paths that
# round once differently end 32 layers apart at O(1) in the logits: on an
# H100 both cores read an RMS ratio of 0.72 against a float32 step, and 0.49
# against each other, and no bf16 logits gate can tell a right kernel from
# a wrong one.  The kernel's gates here are in float32, whose rounding is
# 2^16 times finer: the kernel-core step against the plain chunked
# core at chunk 32 (independent of the kernel), at RWKV_F32_LAYERS layers
# within 1e-3 and at all 32 layers by RMS ratio <= RWKV_F32_DEEP_RMS; and
# the kernel at every layer, on that layer's bf16 activations, against its
# plain version at phase 2's criteria.  In bf16 the kernel core must only
# be no further from the float32 chunked step than RWKV_BF16_SPREAD times
# the bf16 chunked core is (a coarse check: both sit near 0.72).
RWKV_BF16_SPREAD = 1.25
RWKV_F32_DEEP_RMS = 0.25
RWKV_XLA_CHUNK = 32     # the chunked form's largest safe chunk at the floor
RWKV_F32_LAYERS = 4     # depth of the float32 prefill/decode check

# The Jamba slice: Jamba-v0.1 (src/repro_torch/configs/jamba_v0_1_52b.py) at
# its published widths, depth cut to one period (8 layers: 7 Mamba, attention
# at layer 3, 4 dense and 4 MoE FFNs of 16 experts), the most one 80 GB card
# holds: the FULL 32 layers are 106 GB of bf16 weights
JAMBA_ARCH = "jamba_v0_1_52b"
JAMBA_LAYERS = 8
JAMBA_PARAMS = 13_295_235_072       # one period (26.59 GB in bf16)
# the reference's serving profile (src/repro/launch/profiles.py:58-62)
JAMBA_PROFILE = dict(mamba_core="pallas", attn_core="flash")
# mamba_scan's checked shapes (B, T, d_inner, d_state, chunk, d_tile,
# dt_scale): the reference test's (tests/test_kernels_mamba.py:23-26), Jamba's
# serving prefill and one 4096-token sequence, and the prefill with dt ~
# |N(0, 1)| * 2 (every exp(dt A) far below 1)
MAMBA_SHAPES = ((1, 16, 8, 2, 8, 8, 0.1), (2, 64, 32, 4, 16, 16, 0.1),
                (1, 128, 64, 8, 32, 32, 0.1), (2, 32, 16, 16, 32, 8, 0.1),
                (4, 1024, 8192, 16, 128, 512, 0.1),
                (1, 4096, 8192, 16, 128, 512, 0.1),
                (4, 1024, 8192, 16, 128, 512, 2.0))
# the reference's float32 tolerance (tests/test_kernels_mamba.py:37-38),
# against the plain version run in float64; a bfloat16 x gives a bfloat16
# y, one rounding (relative 2^-8) from the oracle: rtol 8e-3 is twice that
MAMBA_TOL = dict(atol=1e-4, rtol=1e-4)
MAMBA_BF16_TOL = dict(atol=1e-3, rtol=8e-3)
MAMBA_TIMED = ((4, 1024, 8192, 16), (1, 4096, 8192, 16))

# The LM training slice: InternLM2-1.8B FULL (24 layers, bf16) trained by
# launch/train.py at the train_4k shape's sequence (4096), the global batch
# cut from 256 to 2 sequences in 2 micro-batches, flash core, remat "dots"
LM_TRAIN = dict(steps=4, seq=4096, global_batch=2, accum=2)
LM_TRAIN_PROFILE = dict(attn_core="flash", remat="dots")
# flash launches in one micro-step: 24 layers' forwards, and again in the
# backward's recompute of each checkpointed layer ("dots" and "full"; the
# trainable wrapper's backward recomputes through plain ref.mha and
# launches nothing)
LM_TRAIN_FLASH_PER_MICRO = 2 * 24
# the reference's bfloat16 tolerance (tests/test_fused.py:48-49) for a
# step's loss and grad norm, flash against softmax core and accum 2 against
# accum 1
LM_TRAIN_BF16_TOL = dict(atol=2e-1, rtol=3e-1)
# card against CPU at the REDUCED configs, float32, 2 steps of lr 1e-3
# (warmup 1) in lockstep (batch 2 x 128): metrics, gradients and params at
# float32 atol 1e-5 / rtol 1e-4, params plus each element's Adam slack
# (adam_slack_check)
LM_TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
LM_TRAIN_REDUCED = {
    "internlm2_1_8b": (dict(attn_core="flash"),
                       dict(flash_attention=2 * 3)),
    "jamba_v0_1_52b": (dict(mamba_core="pallas", attn_core="flash"),
                       dict(flash_attention=2, mamba_scan=2 * 7)),
    "rwkv6_7b": (dict(wkv_core="xla"), {}),
    # the DeepSeek and dense families: 2 a layer, and DeepSeek-V3's MTP
    # block once (it is not checkpointed, as in the reference)
    "deepseek_moe_16b": (dict(attn_core="flash"),
                         dict(flash_attention=2 * 3)),
    "deepseek_v3_671b": (dict(attn_core="flash"),
                         dict(flash_attention=2 * 4 + 1)),
    "qwen2_5_14b": (dict(attn_core="flash"), dict(flash_attention=2 * 3)),
    "codeqwen1_5_7b": (dict(attn_core="flash"), dict(flash_attention=2 * 3)),
    "mistral_large_123b": (dict(attn_core="flash"),
                           dict(flash_attention=2 * 3))}
# mamba_scan_trainable at Jamba's published Mamba widths (B, T, d_inner,
# d_state), gradients of all six inputs against autograd through the plain
# form at the reference's float32 tolerance (tests/test_kernels_mamba.py)
MAMBA_TRAIN_SHAPE = (1, 256, 8192, 16)

# The DeepSeek slice: DeepSeekMoE-16B FULL (28 layers, 64 routed experts
# top-6 and 2 shared, the first layer dense) served whole, and DeepSeek-V3 at
# its published widths (MLA, 256 experts top-8 and 1 shared, MTP) with the
# depth cut from 61 to 4 layers (its 3 dense MLA layers and one MLA-MoE
# layer: 31.59 GB of bf16 weights; 61 layers would be 1.34 TB), both in
# bf16 under the serving profile (attn_core "flash")
DEEPSEEK_ARCHS = ("deepseek_moe_16b", "deepseek_v3_671b")
DEEPSEEK_CUT = {"deepseek_v3_671b": dict(n_layers=4)}
DEEPSEEK_PARAMS = {"deepseek_moe_16b": 16_375_728_128,
                   "deepseek_v3_671b": 15_797_352_448}
# flash launches a call: the prefill step's (one a layer, and V3's MTP
# block), the cache prefill's (MLA layers only: GQA attention there is plain
# ref.mha, as in the reference) and decode's (none); the device function
# each runs (DeepSeekMoE d = dv = 128: the wgmma path; MLA d 192 / dv 128:
# the CUDA-core path)
DEEPSEEK_FLASH = {
    "deepseek_moe_16b": dict(step=28, cache_prefill=0, fn="flash_wgmma_"),
    "deepseek_v3_671b": dict(step=4 + 1, cache_prefill=4, fn="flash_kernel")}
# generated positions whose decode logits are held against a forward over
# the prompt and those tokens
DEEPSEEK_DECODE_CHECK = 4
# the float32 full-width decode check: cache prefill of this many of 128
# tokens, then decode to 128
DEEPSEEK_F32_PREFILL = 120
# flash_attention at MLA's prefill shape (B, H, S, d, dv), bf16 causal
MLA_TIMED = (4, 128, 1024, 192, 128)

# The M-RoPE slice: Qwen2-VL-7B FULL (src/repro_torch/configs/qwen2_vl_7b.py:
# 28 layers, d 3584, GQA 28/4, d_ff 18944, vocab 152064; 15.23 GB of bf16
# weights, served whole), under the serving profile (flash core), fed
# precomputed patch and text embeddings (the reference's vision stub)
QWEN_ARCH = "qwen2_vl_7b"
QWEN_PARAMS = 7_615_616_512
# one image in each 1024-token prompt, Qwen2-VL's layout: 16 text tokens at
# t = h = w = 0..15, a 24 x 32 patch grid at t = 16, h = 16 + row, w = 16 +
# col, then 240 text tokens from 48 (the grid's largest position + 1) on
QWEN_IMAGE = dict(text=16, rows=24, cols=32, after=240)
# the float32 full-width decode check (text positions: the only ones where
# decode's scalar pos equals the forward's, ROADMAP section 3 fault 17):
# batch 2 x 512, cache prefill of 480 tokens, decode to 512
QWEN_F32 = dict(batch=2, seq=512, prefill=480)

# The encoder-decoder slice: Whisper-large-v3 FULL
# (src/repro_torch/configs/whisper_large_v3.py: 32 encoder + 32 decoder
# layers, d 1280, 20 heads of 64, d_ff 5120, vocab 51866; 3.07 GB of bf16
# weights), under the serving profile, fed precomputed frame embeddings (the
# reference's mel/conv stub): 8 clips of 1500 frames, 384 decoder tokens
# (the largest multiple of 128 within Whisper's 448 decoder positions: the
# flash kernel's precondition)
WHISPER_ARCH = "whisper_large_v3"
WHISPER_PARAMS = 1_535_308_800
WHISPER_SERVE = dict(batch=8, dec_len=384, gen=32)
# the decoder's positions: the length of init_cache's self-attention cache
WHISPER_DEC_POSITIONS = 448
# flash launches per prefill-step call, and the device function each runs
# (d = dv = 128 and 64 in bf16: the wgmma path).  Whisper's: the decoder's
# causal self-attention only; the encoder's 1500 non-causal frames and the
# cross-attention run plain ref.mha, as in the reference
# (src/repro/models/blocks.py:117-118)
MM_FLASH = {QWEN_ARCH: dict(step=28, fn="flash_wgmma_"),
            WHISPER_ARCH: dict(step=32, fn="flash_wgmma_")}
# the REDUCED configs' float32 train steps card vs CPU (train_lockstep),
# 3 steps on batch 2 x 128 (Whisper: over 32 encoder frames): 2 flash
# launches a layer with attention through the kernel (its forward and its
# recompute under remat "dots"), Qwen2-VL's 3 layers and Whisper's 2
# decoder layers
MM_TRAIN_REDUCED = {QWEN_ARCH: (dict(attn_core="flash"),
                                dict(flash_attention=2 * 3)),
                    WHISPER_ARCH: (dict(attn_core="flash"),
                                   dict(flash_attention=2 * 2))}

# The mesh tools ([mesh]): launch/train.py on a one-device mesh at
# InternLM2-1.8B REDUCED in float32 under the flash core, at
# [lm_train_reduced]'s batch and sequence (2 x 128, so the kernel runs),
# against the same run without use_mesh= and through the elastic protocol
# (a crash before step MESH_CRASH_AT, checkpointed at it); 2 flash launches
# a layer a step (forward and remat recompute), 3 layers
MESH_TRAIN = dict(steps=6, seq=128, global_batch=2)
MESH_CRASH_AT = 3
MESH_FLASH_PER_STEP = 2 * 3
# spawned processes for the dry-run grid (host work; the machine has 8
# cores and the main process trains beside them)
MESH_WORKERS = 6

# (Fi, Fo) of the main path's fused kernels: layer 1, layer 2, and layer
# 2's dX pass over the transpose with W^T
WIDTHS = ((500, 16), (16, 3), (3, 16))
# the width of each kernel's row in the kernels JSON line (else 500x16)
ROW_KEY = {"block_diag_spmm": 16, "bell_spmm": 16, "tcgnn_spmm": 16,
           "flash_attention": "4x16x8x1024x128",
           "rwkv6_chunked": "4x64x1024x64",
           "mamba_scan": "4x1024x8192x16"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max().item())


def real_slot_count(tiles) -> int:
    """Real slots of a tcgnn_tile payload: the (block row, slot) pairs whose
    (B,) tile column holds a non-zero."""
    return int((tiles != 0).any(dim=1).sum())


def tcgnn_spmm_bound(torch, p, n: int, F: int) -> tuple:
    """Bound of tcgnn_spmm over payload ``p`` at float32 width F: each tile
    and gather index read once, each source row that a real slot names read
    once and the (n, F) output written once; 2 nnz F flops."""
    nbr, B, C = p.tiles.shape
    real = (p.tiles != 0).any(dim=1)
    nnz = int((p.tiles != 0).sum())
    n_src = int(torch.unique(p.gather_idx[real]).numel())
    return bound(nbr * B * C * 4 + nbr * C * 4 + n_src * F * 4 + n * F * 4,
                 2.0 * nnz * F, "float32")


def tcgnn_fused_bound(torch, p, n: int, Fi: int, Fo: int) -> tuple:
    """Bound of tcgnn_spmm_fused over payload ``p`` at float32 widths
    (Fi, Fo): each tile and gather index read once, each source row that a
    real slot names, W and the (n, Fo) output moved once; 2 n_src Fi Fo +
    2 nnz Fo flops (each named source row transformed once)."""
    nbr, B, C = p.tiles.shape
    real = (p.tiles != 0).any(dim=1)
    nnz = int((p.tiles != 0).sum())
    n_src = int(torch.unique(p.gather_idx[real]).numel())
    return bound(nbr * B * C * 4 + nbr * C * 4 + n_src * Fi * 4
                 + Fi * Fo * 4 + n * Fo * 4,
                 2.0 * n_src * Fi * Fo + 2.0 * nnz * Fo, "float32")


def tcgnn_dw_bound(torch, p, n: int, Fi: int, Fo: int) -> tuple:
    """Bound of tcgnn_spmm_dw over transpose payload ``p`` at float32
    widths (Fi, Fo): each tile and gather index read once, the (n, Fi) x,
    each row of g that a real slot names and the (Fi, Fo) dW moved once;
    2 nnz Fo + 2 n Fi Fo flops."""
    nbr, B, C = p.tiles.shape
    real = (p.tiles != 0).any(dim=1)
    nnz = int((p.tiles != 0).sum())
    n_src = int(torch.unique(p.gather_idx[real]).numel())
    return bound(nbr * B * C * 4 + nbr * C * 4 + n * Fi * 4 + n_src * Fo * 4
                 + Fi * Fo * 4, 2.0 * nnz * Fo + 2.0 * n * Fi * Fo,
                 "float32")


def bell_spmm_bound(bell, F: int) -> tuple:
    """Bound of bell_spmm over payload ``bell`` at float32 width F: each
    real block, its column index and the row counts read once, x read and
    the (n_rows, F) output written once; 2 B^2 F flops a real block."""
    nv, B = int(bell.n_valid.sum()), bell.block_size
    return bound(nv * (B * B * 4 + 4) + bell.n_brow * 4
                 + bell.n_cols * F * 4 + bell.n_rows * F * 4,
                 2.0 * nv * B * B * F, "float32")


def dw_rel_err(got, want, what: str) -> float:
    """max|got - want| / max|want| of a dW; raises above DW_REL_TOL."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {got.dtype} {tuple(got.shape)}, "
                           f"expected {want.dtype} {tuple(want.shape)}")
    rel = max_err(got, want) / float(want.abs().max())
    if not rel <= DW_REL_TOL:
        raise RuntimeError(f"{what}: max|err| / max|dW| = {rel:.3g} "
                           f"> {DW_REL_TOL}")
    return rel


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, flush=None, inner: int = 10, reps: int = 15) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls captured in
    one CUDA graph (so host launch cost is not timed), replayed ``reps``
    times between CUDA events.  With ``flush``, every call is preceded by
    ``flush()`` and the flush's own time is subtracted."""
    def body():
        if flush is not None:
            flush()
        fn()

    def timed(f) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                f()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times)

    t = timed(body)
    if flush is not None:
        t -= timed(flush)
    return t


def eager_ms(torch, fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event times of ``fn()`` run eagerly (host
    launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def yardstick_ms(torch, fn, flush, what: str) -> tuple[float, str]:
    """A library yardstick's time as the kernels are timed (``graph_ms``,
    L2 flushed), and how it was taken.  Where the call cannot be captured
    in a CUDA graph it is timed eagerly (host launch included), and the
    reason is printed."""
    try:
        return graph_ms(torch, fn, flush), "CUDA graph, L2 flushed"
    except RuntimeError as exc:
        torch.cuda.synchronize()
        log("timing", f"{what}: no CUDA-graph capture ({type(exc).__name__}:"
            f" {str(exc).splitlines()[0] if str(exc) else ''}); timed "
            f"eagerly, host launch included")
        return eager_ms(torch, fn), "eager"


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    """Least time in ms for moving ``n_bytes`` and doing ``n_ops``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    log("build", f"{len(libs)} kernels in {dt:.2f} s ("
        + ", ".join(f"{n} nvcc {b.seconds:.2f} s" for n, b in libs.items())
        + ")")
    for name, b in libs.items():
        for line in b.ptxas:
            log("build", f"{name}: {line}")


def block_diag_bound(nb: int, B: int, F: int,
                     y_in: str = "none") -> tuple[float, str]:
    """Bound of one float32 block_diag_spmm call: the blocks, X and Y once
    each, and y_in ("none", "row": F values, "full": nb B F) once."""
    n = nb * B
    extra = {"none": 0, "row": F, "full": n * F}[y_in]
    return bound((nb * B * B + 2 * n * F + extra) * 4, 2.0 * nb * B * B * F,
                 "float32")


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def synthetic_bell(torch, gen, B: int, dev, nbr: int = 40, K: int = 5):
    """A random blocked-ELL payload honouring the format's contract:
    n_valid[i] leading slots hold blocks, the rest are zero blocks that
    point at block column 0."""
    nbc = nbr + 3
    n_valid = torch.randint(0, K + 1, (nbr,), generator=gen, device=dev,
                            dtype=torch.int32)
    slot = torch.arange(K, device=dev)[None, :]
    valid = slot < n_valid[:, None]
    col_idx = torch.randint(0, nbc, (nbr, K), generator=gen, device=dev,
                            dtype=torch.int32) * valid
    blocks = torch.randn((nbr, K, B, B), generator=gen, device=dev)
    blocks = blocks * valid[:, :, None, None]
    return blocks, col_idx.to(torch.int32), n_valid, nbc * B


def phase_kernels(torch, dec) -> dict:
    """Each kernel against its plain version on ``dec``'s device; returns the
    largest float32 and bfloat16 errors per kernel."""
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNELS}

    # the main path's payloads first (for bell_spmm the forward's and the
    # backward dX pass's transpose), then synthetic ones of other sizes
    bd_cases = [(bd.block_size, bd.blocks)] + [
        (B, torch.randn((40, B, B), generator=gen, device=dev))
        for B in (8, 16, 32, 64) if B != bd.block_size]
    bell_main = ("bell", "bell_t")
    bell_cases = [(p.block_size, (p.blocks, p.col_idx, p.n_valid, p.n_cols))
                  for p in (bell, bell_t)] + [
        (B, synthetic_bell(torch, gen, B, dev))
        for B in (8, 16, 32, 64) if B != bell.block_size]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for F in (3, 16, 500):
            for with_y in (False, True):
                for i, (B, blocks) in enumerate(bd_cases):
                    n = blocks.shape[0] * B
                    x = torch.randn((n, F), generator=gen, device=dev)
                    # y_in in full, and as the GCN bias seeds it: one row
                    # repeated (strides (0, 1)), read without a copy
                    y_ins = {False: None}
                    if with_y:
                        y_ins = {"full": torch.randn(
                                     (n, F), generator=gen,
                                     device=dev).to(dtype),
                                 "bias row": torch.randn(
                                     (F,), generator=gen,
                                     device=dev).to(dtype).expand(n, F)}
                    for label, y_in in y_ins.items():
                        args = (blocks.to(dtype), x.to(dtype), y_in)
                        got = bd_mod.block_diag_spmm(*args)
                        want = bd_mod.plain(*args)
                        sync(torch, dev)
                        torch.testing.assert_close(got.float(),
                                                   want.float(), **tol)
                        e = max_err(got, want)
                        errs["block_diag_spmm"][name] = max(
                            errs["block_diag_spmm"][name], e)
                        if i == 0:
                            log("kernel", f"block_diag_spmm {name} F={F} "
                                f"y_in={label}: max|err| {e:.3g}")
                        n_cases += 1
                for i, (B, (blocks, col_idx, n_valid, n_cols)) in enumerate(
                        bell_cases):
                    x = torch.randn((n_cols, F), generator=gen,
                                    device=dev).to(dtype)
                    n_rows = blocks.shape[0] * B
                    y_in = (torch.randn((n_rows, F), generator=gen,
                                        device=dev).to(dtype)
                            if with_y else None)
                    got = bell_mod.bell_spmm(blocks.to(dtype), col_idx, x,
                                             y_in, n_valid=n_valid)
                    want = bell_mod.plain(blocks.to(dtype), col_idx, x, y_in)
                    sync(torch, dev)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    if i < len(bell_main) and not torch.equal(
                            got, bell_mod.bell_spmm(blocks.to(dtype), col_idx,
                                                    x, y_in, n_valid=n_valid)):
                        raise RuntimeError(f"bell_spmm over {bell_main[i]} "
                                           "gave other bits on a second call")
                    e = max_err(got, want)
                    errs["bell_spmm"][name] = max(errs["bell_spmm"][name], e)
                    if i < len(bell_main):
                        log("kernel", f"bell_spmm {bell_main[i]} {name} F={F} "
                            f"y_in={with_y}: max|err| {e:.3g} (same bits "
                            "twice)")
                    n_cases += 1
    # every slot, without the count of real blocks (the TPU kernel's loop)
    x = torch.randn((bell.n_cols, 16), generator=gen, device=dev)
    got = bell_mod.bell_spmm(bell.blocks, bell.col_idx, x)
    want = bell_mod.plain(bell.blocks, bell.col_idx, x)
    sync(torch, dev)
    torch.testing.assert_close(got, want, **F32_TOL)
    errs["bell_spmm"]["float32"] = max(errs["bell_spmm"]["float32"],
                                       max_err(got, want))
    log("kernel", f"{n_cases + 1} cases within tolerance (main-path "
        f"payloads, bell_spmm's bell and bell_t, and B in 8, 16, 32, 64); "
        f"largest errors {errs}")
    return errs


def bsr_of(torch, bell):
    """The blocked-ELL payload's real blocks as a torch BSR tensor (the
    library yardstick for bell_spmm), or None where PyTorch cannot build
    or multiply one on this card."""
    nbc = bell.n_cols // bell.block_size
    valid = (torch.arange(bell.max_blocks, device=bell.blocks.device)[None, :]
             < bell.n_valid[:, None])
    brow = torch.arange(bell.n_brow, device=valid.device)[:, None].expand_as(
        valid)[valid]
    bcol = bell.col_idx[valid].long()
    order = torch.argsort(brow * nbc + bcol)
    crow = torch.zeros(bell.n_brow + 1, dtype=torch.int64,
                       device=valid.device)
    crow[1:] = torch.cumsum(bell.n_valid.long(), 0)
    try:
        bsr = torch.sparse_bsr_tensor(crow, bcol[order],
                                      bell.blocks[valid][order],
                                      size=(bell.n_rows, bell.n_cols),
                                      check_invariants=True)
        bsr @ torch.zeros((bell.n_cols, 16), device=valid.device)
    except (RuntimeError, NotImplementedError) as exc:
        log("timing", f"no torch BSR product for bell_spmm on this card "
            f"({type(exc).__name__}: {exc}); library_ms is null")
        return None
    return bsr


def edge_list(torch, graph, both_copies: bool = False):
    """The GCN's normalized edge list in original node order: (senders,
    receivers, values) with self-loops and the symmetric norm.

    ``add_self_loops`` duplicates the (v, v) edges a graph already has.  The
    reference's block formats (block_diag, bell, tcgnn_tile) store such an
    edge once (both copies carry the same norm value), so by default the
    edge list keeps the first copy too; its edge-list formats (coo, ell,
    csr, sell_cs) add both copies, which ``both_copies`` keeps."""
    import numpy as np
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.add_self_loops(graph)
    vals = graph_mod.gcn_norm_values(g.n, g.senders, g.receivers)
    if both_copies:
        keep = np.arange(len(vals))
    else:
        _, keep = np.unique(g.receivers.astype(np.int64) * g.n + g.senders,
                            return_index=True)
    return (torch.from_numpy(g.senders[keep]).long(),
            torch.from_numpy(g.receivers[keep]).long(),
            torch.from_numpy(vals[keep]))


def plan_edge_lists(torch, graph, layers) -> list:
    """One edge list per layer of a plan, keeping a duplicated self-loop
    as that layer's intra-tier kernel stores it (self-loops are all on the
    intra tier)."""
    blocks = ("block_diag", "block_diag_fused")
    return [edge_list(torch, graph, both_copies=layer[0] not in blocks)
            for layer in layers]


def edge_list_forward(torch, feats, edges, params):
    """GCN forward with ``index_add_`` over one edge list per layer."""
    h = feats
    for i, (layer, (snd, rcv, vals)) in enumerate(zip(params, edges)):
        hw = h @ layer["w"]
        y = torch.zeros((feats.shape[0], hw.shape[1])).index_add_(
            0, rcv, hw[snd] * vals[:, None])
        h = y + layer["b"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def edge_list_gcn(torch, graph, params) -> "torch.Tensor":
    """Independent CPU reference: the GCN forward on the original edge
    list (self-loops, symmetric norm, index_add_), in original node order."""
    return edge_list_forward(
        torch, torch.from_numpy(graph.features),
        [edge_list(torch, graph)] * len(params),
        [{k: v.cpu() for k, v in p.items()} for p in params])


def edge_list_train(torch, graph, params, steps: int, lr: float,
                    edges=None, forward=None) -> list:
    """Independent CPU reference for training: the edge-list GCN, the mean
    negative log-likelihood over every node, torch autograd, and Adam as
    the reference writes it (repro/core/gnn.py _adam_update) transcribed
    here.  ``edges`` holds one edge list per layer (default: each
    duplicated self-loop once); ``forward(feats, params)`` replaces the
    GCN (the edge-list SAGE).  Returns the loss of each step."""
    if edges is None:
        edges = [edge_list(torch, graph)] * len(params)
    if forward is None:
        forward = lambda f, q: edge_list_forward(torch, f, edges, q)  # noqa: E731
    feats = torch.from_numpy(graph.features)
    labels = torch.from_numpy(graph.labels).long()
    p = [{k: v.detach().cpu().clone() for k, v in q.items()} for q in params]
    m = [{k: torch.zeros_like(v) for k, v in q.items()} for q in p]
    v2 = [{k: torch.zeros_like(v) for k, v in q.items()} for q in p]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for t in range(1, steps + 1):
        leaves = [{k: v.clone().requires_grad_() for k, v in q.items()}
                  for q in p]
        loss = torch.nn.functional.cross_entropy(forward(feats, leaves),
                                                 labels)
        flat = [v for q in leaves for v in q.values()]
        grads = iter(torch.autograd.grad(loss, flat))
        losses.append(float(loss.detach()))
        for q, mq, vq in zip(p, m, v2):
            for k in q:
                gk = next(grads)
                mq[k] = b1 * mq[k] + (1 - b1) * gk
                vq[k] = b2 * vq[k] + (1 - b2) * gk * gk
                mh = mq[k] / (1 - b1 ** t)
                vh = vq[k] / (1 - b2 ** t)
                q[k] = q[k] - lr * mh / (torch.sqrt(vh) + eps)
    return losses


def sage_edge_list(torch, graph):
    """SAGE's edge list in original node order: (senders, receivers,
    1/deg(dst)), without self-loops.  Every format stores each edge once
    here: SAGE adds no self-loop that could be duplicated."""
    from repro_torch.graphs import graph as graph_mod
    vals = graph_mod.mean_norm_values(graph.n, graph.senders, graph.receivers)
    return (torch.from_numpy(graph.senders).long(),
            torch.from_numpy(graph.receivers).long(), torch.from_numpy(vals))


def edge_list_sage(torch, feats, edges, params):
    """Independent CPU reference: the GraphSAGE mean-aggregator forward,
    X W_self + mean over in-neighbours of X W_neigh + b, with
    ``index_add_`` over the edge list."""
    snd, rcv, vals = edges
    h = feats
    for i, layer in enumerate(params):
        hn = h @ layer["w_neigh"]
        agg = torch.zeros((feats.shape[0], hn.shape[1])).index_add_(
            0, rcv, hn[snd] * vals[:, None])
        h = h @ layer["w_self"] + agg + layer["b"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def phase_main(torch, graph, cfg, dec, counts: dict):
    """The forward path on ``dec``'s device: init_model, then forward with
    acc=False and acc=True, with the launch counts set to 0 just before and
    read just after.  Checks the logits against the same forward on the
    CPU and against :func:`edge_list_gcn`.  Returns (plan, params, x,
    launches)."""
    from repro_torch.core import adaptgear, gnn
    dev = dec.device
    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    plan, _ = gnn.select_plan(dec, cfg, [(in_dim, cfg.hidden),
                                         (cfg.hidden, n_classes)])
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, device=dev)
    feats = torch.from_numpy(graph.features)
    x = adaptgear.to_reordered(dec, feats.to(dev))
    for c in counts.values():
        c.reset()
    logits = {acc: gnn.forward(params, cfg, dec, x, plan, acc=acc)
              for acc in (False, True)}
    sync(torch, dev)
    launches = {k: c.value for k, c in counts.items()}
    log("main", f"plan {plan.layers}; launches over {len(logits)} forwards "
        f"{launches}")

    dec_cpu = dec.to("cpu")
    params_cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
    x_cpu = adaptgear.to_reordered(dec_cpu, feats)
    edge_ref = edge_list_gcn(torch, graph, params)
    ids = [0, 1, graph.n // 2, graph.n - 1]
    for acc, y in logits.items():
        if tuple(y.shape) != (dec.n_pad, n_classes):
            raise RuntimeError(f"logits shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite logits")
        y_cpu = gnn.forward(params_cpu, cfg, dec_cpu, x_cpu, plan, acc=acc)
        torch.testing.assert_close(y.cpu(), y_cpu, **F32_TOL)
        y_orig = adaptgear.from_reordered(dec_cpu, y.cpu())
        torch.testing.assert_close(y_orig, edge_ref, **F32_TOL)
        log("main", f"acc={acc}: logits at ids {ids} = "
            f"{y_orig[ids].tolist()}; max|{dev.type} - cpu| "
            f"{max_err(y.cpu(), y_cpu):.3g}, max|{dev.type} - edge-list GCN| "
            f"{max_err(y_orig, edge_ref):.3g}")
    return plan, params, x, launches


def phase_kernels_train(torch, dec, errs: dict) -> None:
    """The training path's kernels against their plain versions on
    ``dec``'s device, adding the largest errors to ``errs``: the transposed
    read of block_diag_spmm (its backward), block_diag_spmm_fused (both
    reads), bell_spmm_fused, and bell_spmm_dw over the transpose payload and
    over the diagonal blocks (K = 1, identity columns, transposed read).
    dW's cotangent is unit-scale and dW is held to DW_REL_TOL of its
    largest entry."""
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(2)
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    bd_cases = [bd.blocks] + [randn(40, B, B) for B in (8, 32, 64)]
    main_bell = [(bell.blocks, bell.col_idx, bell.n_valid, bell.n_cols)]
    main_bell_t = [(bell_t.blocks, bell_t.col_idx, bell_t.n_valid,
                    bell_t.n_cols)]
    synth = [synthetic_bell(torch, gen, B, dev) for B in (8, 32, 64)]
    n_cases = 0

    def check(name, got, want, dtype, label=None):
        nonlocal n_cases
        sync(torch, dev)
        key = str(dtype).removeprefix("torch.")
        if name == "bell_spmm_dw":
            rel = dw_rel_err(got, want, f"{name} {key} {label}")
            errs[name][f"{key}_rel"] = max(errs[name].get(f"{key}_rel", 0.0),
                                           rel)
            extra = f", / max|dW| {rel:.3g}"
        else:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), **tol)
            extra = ""
        e = max_err(got, want)
        errs[name][key] = max(errs[name][key], e)
        if label is not None:
            log("kernel", f"{name} {key} {label}: max|err| {e:.3g}{extra}")
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for Fi, Fo in WIDTHS:
            w = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
            for i, blocks in enumerate(bd_cases):
                blocks = blocks.to(dtype)
                n = blocks.shape[0] * blocks.shape[1]
                x = randn(n, Fi).to(dtype)
                g = randn(n, Fo).to(dtype)
                logged = i == 0
                check("bell_spmm_dw",
                      bellf_mod.bell_spmm_dw(blocks.unsqueeze(1), None, x, g,
                                             transpose=True),
                      bellf_mod.plain_dw(blocks.unsqueeze(1), None, x, g,
                                         transpose=True),
                      dtype, f"diag {Fi}x{Fo}" if logged else None)
                for with_y in (False, True):
                    y_in = randn(n, Fo).to(dtype) if with_y else None
                    yx = randn(n, Fi).to(dtype) if with_y else None
                    check("block_diag_spmm",
                          bd_mod.block_diag_spmm(blocks, x, yx,
                                                 transpose=True),
                          bd_mod.plain(blocks, x, yx, transpose=True), dtype,
                          f"transposed F={Fi} y_in={with_y}" if logged
                          else None)
                    for transpose in (False, True):
                        check("block_diag_spmm_fused",
                              bdf_mod.block_diag_spmm_fused(
                                  blocks, x, w, y_in, transpose=transpose),
                              bdf_mod.plain(blocks, x, w, y_in,
                                            transpose=transpose), dtype,
                              f"{Fi}x{Fo} y_in={with_y} "
                              f"transpose={transpose}" if logged else None)
            for i, (blocks, col_idx, n_valid, n_cols) in enumerate(
                    main_bell + synth):
                blocks = blocks.to(dtype)
                n_rows = blocks.shape[0] * blocks.shape[2]
                x = randn(n_cols, Fi).to(dtype)
                for with_y in (False, True):
                    y_in = randn(n_rows, Fo).to(dtype) if with_y else None
                    check("bell_spmm_fused",
                          bellf_mod.bell_spmm_fused(blocks, col_idx, x, w,
                                                    y_in, n_valid=n_valid),
                          bellf_mod.plain(blocks, col_idx, x, w, y_in),
                          dtype, f"{Fi}x{Fo} y_in={with_y}" if i == 0
                          else None)
            for i, (blocks, col_idx, n_valid, n_cols) in enumerate(
                    main_bell_t + synth):
                blocks = blocks.to(dtype)
                n_rows = blocks.shape[0] * blocks.shape[2]
                x = randn(n_rows, Fi).to(dtype)
                g = randn(n_cols, Fo).to(dtype)
                got = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g,
                                             n_valid=n_valid)
                if i == 0 and not torch.equal(got, bellf_mod.bell_spmm_dw(
                        blocks, col_idx, x, g, n_valid=n_valid)):
                    raise RuntimeError("bell_spmm_dw gave other bits on a "
                                       "second run")
                check("bell_spmm_dw", got,
                      bellf_mod.plain_dw(blocks, col_idx, x, g), dtype,
                      f"bell_t {Fi}x{Fo} (same bits twice)" if i == 0
                      else None)
    log("kernel", f"{n_cases} training-path cases within tolerance "
        f"(main-path payloads and B in 8, 16, 32, 64); largest errors "
        f"{errs}")


def synthetic_tcgnn(torch, gen, B: int, dev, nbr: int = 40, C: int = 256):
    """Random condensed tiles (about 30 % non-zero, float32) and gather
    rows for a synthetic payload of block size B."""
    tiles = torch.randn((nbr, B, C), generator=gen, device=dev)
    tiles = tiles * (torch.rand((nbr, B, C), generator=gen, device=dev) < 0.3)
    gi = torch.randint(0, nbr * B, (nbr, C), generator=gen, device=dev,
                       dtype=torch.int32)
    return tiles, gi


def phase_kernels_tcgnn(torch, dec, errs: dict) -> None:
    """The three tcgnn kernels against their plain versions on ``dec``'s
    device, adding the largest errors to ``errs``: tcgnn_spmm at F in
    {3, 16, 500} over the forward and the transpose payload,
    tcgnn_spmm_fused at WIDTHS (the last is the dX pass with W^T), and
    tcgnn_spmm_dw over the transpose payload, on pubmed's payloads and on
    synthetic ones with B in {8, 32, 64}, float32 and bfloat16, y_in on and
    off.  dW runs twice and must give the same bits."""
    from repro_torch.kernels import tcgnn_tile as tc_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(4)
    tc, tc_t = dec.sub("inter").formats["tcgnn_tile"]
    cases = [(tc.tiles, tc.gather_idx), (tc_t.tiles, tc_t.gather_idx)] + [
        synthetic_tcgnn(torch, gen, B, dev) for B in (8, 32, 64)]
    n_cases = 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check(name, got, want, dtype, label):
        nonlocal n_cases
        sync(torch, dev)
        key = str(dtype).removeprefix("torch.")
        extra = ""
        if name == "tcgnn_spmm_dw":
            rel = dw_rel_err(got, want, f"{name} {key} {label}")
            errs[name][f"{key}_rel"] = max(errs[name].get(f"{key}_rel", 0.0),
                                           rel)
            extra = f", / max|dW| {rel:.3g}"
        else:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), **tol)
        e = max_err(got, want)
        errs[name][key] = max(errs[name][key], e)
        if label is not None:
            log("kernel", f"{name} {key} {label}: max|err| {e:.3g}{extra}")
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for i, (tiles, gi) in enumerate(cases):
            n = tiles.shape[0] * tiles.shape[1]
            where = ("pubmed tc", "pubmed tc_t")[i] if i < 2 else None
            for F in (3, 16, 500):
                x = randn(n, F).to(dtype)
                for with_y in (False, True):
                    y_in = randn(n, F).to(dtype) if with_y else None
                    check("tcgnn_spmm", tc_mod.tcgnn_spmm(tiles, gi, x, y_in),
                          tc_mod.plain(tiles, gi, x, y_in), dtype,
                          f"{where} F={F} y_in={with_y}" if where else None)
            for Fi, Fo in WIDTHS:
                x = randn(n, Fi).to(dtype)
                w = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
                for with_y in (False, True):
                    y_in = randn(n, Fo).to(dtype) if with_y else None
                    check("tcgnn_spmm_fused",
                          tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in),
                          tc_mod.plain_fused(tiles, gi, x, w, y_in), dtype,
                          f"{where} {Fi}x{Fo} y_in={with_y}" if where
                          else None)
                if i == 0:
                    continue                 # dW runs over the transpose
                g = randn(n, Fo).to(dtype)
                got = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
                if not torch.equal(got, tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)):
                    raise RuntimeError("tcgnn_spmm_dw gave other bits on a "
                                       "second run")
                check("tcgnn_spmm_dw", got, tc_mod.plain_dw(tiles, gi, x, g),
                      dtype, f"{where} {Fi}x{Fo} (same bits twice)" if where
                      else None)
    log("kernel", f"{n_cases} tcgnn cases within tolerance (pubmed's tc and "
        f"tc_t, B in 8, 32, 64); largest errors "
        f"{ {k: errs[k] for k in KERNELS if k.startswith('tcgnn')} }")


def phase_grads(torch, graph, cfg, dec) -> None:
    """One loss.backward per plan on ``dec``'s device against the same on
    the CPU (plain versions), from the same parameters: every parameter's
    gradient within float32 1e-4."""
    from repro_torch.core import adaptgear, gnn
    dec_cpu = dec.to("cpu")
    feats = torch.from_numpy(graph.features)
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            feats.shape[1], graph.n_classes, device="cpu")
    for name, pair in PLANS.items():
        got = []
        for d in (dec, dec_cpu):
            x = adaptgear.to_reordered(d, feats.to(d.device))
            labels, mask = gnn.node_targets(graph, d)
            leaves = [{k: v.clone().to(d.device).requires_grad_()
                       for k, v in p.items()} for p in params]
            loss = gnn._loss(leaves, cfg, d, x, labels, mask, pair)
            loss.backward()
            got.append((float(loss.detach()), [
                {k: v.grad.cpu() for k, v in p.items()} for p in leaves]))
        (l_dev, g_dev), (l_cpu, g_cpu) = got
        worst, scale = 0.0, 0.0
        for i, (a, b) in enumerate(zip(g_dev, g_cpu)):
            for k in a:
                torch.testing.assert_close(a[k], b[k], **F32_TOL)
                worst = max(worst, max_err(a[k], b[k]))
                scale = max(scale, float(b[k].abs().max()))
        if abs(l_dev - l_cpu) > 1e-4 + 1e-4 * abs(l_cpu):
            raise RuntimeError(f"{name}: loss {l_dev} on the card, "
                               f"{l_cpu} on the CPU")
        log("grads", f"{name} {pair}: loss {l_dev:.6f} (cpu {l_cpu:.6f}); "
            f"max|grad diff| {worst:.3g} over 4 parameters, "
            f"largest |grad| {scale:.3g}")


def phase_train(torch, graph, cfg, counts: dict) -> dict:
    """gnn.train on the card for each fixed plan from one parameter set,
    with the launch counts set to 0 just before and read just after.
    Checks the counts against PER_STEP / PER_FORWARD and each curve against
    the CPU's, the edge-list GCN's and the unfused plan's."""
    import dataclasses
    import numpy as np
    from repro_torch.core import gnn
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            graph.features.shape[1], graph.n_classes,
                            device="cpu")
    results, used = {}, {}
    for name, pair in PLANS.items():       # the tables agree with the rules
        want = {k: TRAIN_STEPS * PER_STEP[name].get(k, 0)
                + PER_FORWARD[name].get(k, 0) for k in counts}
        if plan_launches((pair, pair), TRAIN_STEPS) != want:
            raise RuntimeError(f"{name}: PER_STEP disagrees with "
                               "plan_launches")
    for c in counts.values():
        c.reset()
    for name, pair in PLANS.items():
        before = {k: c.value for k, c in counts.items()}
        results[name] = gnn.train(
            graph, dataclasses.replace(cfg, fixed_kernels=pair),
            steps=TRAIN_STEPS, device="cuda", params=params)
        torch.cuda.synchronize()
        used[name] = {k: c.value - before[k] for k, c in counts.items()}
    launches = {k: c.value for k, c in counts.items()}
    log("train", f"launches over both runs {launches}")

    edge_losses = edge_list_train(torch, graph, params, TRAIN_STEPS, cfg.lr)
    for name, pair in PLANS.items():
        r = results[name]
        want = {k: TRAIN_STEPS * PER_STEP[name].get(k, 0)
                + PER_FORWARD[name].get(k, 0) for k in counts}
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want} ({TRAIN_STEPS} steps and one "
                               "forward)")
        losses = np.asarray(r.losses)
        if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
            raise RuntimeError(f"{name}: losses {r.losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: the loss did not fall: {r.losses}")
        n_cpu = CPU_STEPS[name]
        cpu = gnn.train(graph, dataclasses.replace(cfg, fixed_kernels=pair),
                        steps=n_cpu, device="cpu", params=params)
        np.testing.assert_allclose(losses[:n_cpu], cpu.losses, **CURVE_TOL)
        np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
        log("train", f"{name} {pair}: {TRAIN_STEPS} steps, launches "
            f"{used[name]} = {TRAIN_STEPS} x {PER_STEP[name]} + one forward; "
            f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
            f"{r.accuracy:.4f}, step {r.step_seconds * 1e3:.3f} ms (host "
            f"clock, loss read every step); max|card - cpu| over {n_cpu} "
            f"steps {np.abs(losses[:n_cpu] - cpu.losses).max():.3g}, "
            f"max|card - edge-list GCN| "
            f"{np.abs(losses - edge_losses).max():.3g}")
    for name in PLANS:
        np.testing.assert_allclose(results[name].losses,
                                   results["unfused"].losses, **CURVE_TOL)
    log("train", "every plan's curve agrees with the unfused one: max|diff| "
        + ", ".join(f"{n} {np.abs(np.subtract(r.losses, results['unfused'].losses)).max():.3g}"
                    for n, r in results.items()))
    return dict(results=results, launches=launches, used=used,
                params=params)


def phase_feedback(torch, graph, cfg, dec, counts: dict, params) -> dict:
    """The main path: gnn.train with the default GNNConfig (the feedback
    selector), launch counts set to 0 just before and read just after.
    Prints the probe table beside the H100 cost model's estimates, the
    committed plan and the cost model's plan, and checks the launches and
    the curve (against the same plan trained on the CPU and the edge-list
    GCN)."""
    import dataclasses
    import numpy as np
    from repro_torch.core import gnn
    from repro_torch.core import selector as sel_mod
    from repro_torch.kernels.registry import REGISTRY
    fb_cfg = gnn.GNNConfig()
    if dataclasses.replace(cfg, selector="feedback") != fb_cfg:
        raise RuntimeError(f"the default config {fb_cfg} is not this run's")
    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    res = gnn.train(graph, fb_cfg, steps=TRAIN_STEPS, device="cuda",
                    params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.value for k, c in counts.items()}
    plan = res.plan
    log("feedback", f"gnn.train(graph, GNNConfig()) {TRAIN_STEPS} steps in "
        f"{wall:.2f} s (selection included); committed plan {plan.layers}; "
        f"launches {launches}")

    # the probe times each forward kernel at 2 widths, 1 + warmup_iters
    # calls each; training adds what the committed plan launches
    n_probe = 2 * (1 + fb_cfg.warmup_iters)
    probed = ("block_diag_spmm", "bell_spmm", "block_diag_spmm_fused",
              "bell_spmm_fused", "tcgnn_spmm", "tcgnn_spmm_fused")
    trained = plan_launches(plan.layers, TRAIN_STEPS)
    want = {k: trained[k] + (n_probe if k in probed else 0) for k in counts}
    if launches != want:
        raise RuntimeError(f"feedback run launches {launches}, expected "
                           f"{want}: {n_probe} probe calls of each forward "
                           f"kernel and {trained} for {TRAIN_STEPS} steps "
                           "and one forward")
    log("feedback", f"launches = {n_probe} probe calls of each of {probed} "
        f"+ the committed plan's {trained}")

    # the probe table, beside the cost model's estimates under H100_HW
    hw = sel_mod.default_hw(dec.device)
    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    pairs, eps = gnn.layer_plan_inputs(fb_cfg, in_dim, n_classes)
    model_plan, agree, total = [], 0, 0
    for li, ((fin, fout), ep) in enumerate(zip(pairs, eps)):
        share = sel_mod._transform_share(dec, fout, torch.float32, hw, fin,
                                         ep)
        model_layer = sel_mod.select_by_cost_model(
            dec, fout, torch.float32, hw=hw, in_dim=fin, epilogue=ep)
        model_plan.append(model_layer)
        for si, sub in enumerate(dec.subgraphs):
            cands = REGISTRY.candidates_for(sub, include_fused=True)
            probe_ms = {s.name: res.probe_times[(sub.name, s.name, fout)]
                        * 1e3 for s in cands}
            order = sorted(probe_ms, key=probe_ms.get)
            for spec in cands:
                model_ms = sel_mod.candidate_cost(
                    sub, spec.name, fout, torch.float32, hw, fin, share) * 1e3
                log("probe", f"layer {li + 1} ({fin}, {fout}) {sub.name:6s} "
                    f"{spec.name:17s} {probe_ms[spec.name]:9.4f} ms "
                    f"(rank {order.index(spec.name) + 1}); H100_HW model "
                    f"{model_ms:8.4f} ms")
            total += 1
            agree += model_layer[si] == plan.layers[li][si]
            log("probe", f"layer {li + 1} {sub.name}: probe picks "
                f"{plan.layers[li][si]}, cost model picks {model_layer[si]} "
                f"(probe rank {order.index(model_layer[si]) + 1} of "
                f"{len(order)})")
    log("feedback", f"committed plan {plan.layers}; cost model (H100_HW) "
        f"plan {tuple(model_plan)}; the model picks the probe's winner in "
        f"{agree} of {total} (layer, subgraph) choices")

    # the curve
    losses = np.asarray(res.losses)
    if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
        raise RuntimeError(f"feedback: losses {res.losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"feedback: the loss did not fall: {res.losses}")
    cpu = gnn.train(graph, dataclasses.replace(
        cfg, selector="fixed", fixed_kernels=plan.layers),
        steps=TRAIN_STEPS, device="cpu", params=params)
    if cpu.kernels != res.kernels:
        raise RuntimeError(f"cpu plan {cpu.kernels} != {res.kernels}")
    edge_losses = edge_list_train(torch, graph, params, TRAIN_STEPS, cfg.lr,
                                  plan_edge_lists(torch, graph, plan.layers))
    np.testing.assert_allclose(losses, cpu.losses, **CURVE_TOL)
    np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
    log("feedback", f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
        f"{res.accuracy:.4f}, step {res.step_seconds * 1e3:.3f} ms (host "
        f"clock); max|card - cpu| {np.abs(losses - cpu.losses).max():.3g}, "
        f"max|card - edge-list GCN| {np.abs(losses - edge_losses).max():.3g}")
    return dict(result=res, launches=launches, plan=plan,
                model_plan=tuple(model_plan), agree=(agree, total))


def time_tcgnn_kernels(torch, dec, flush) -> dict:
    """The three tcgnn kernels on pubmed's payloads (L2 flushed) at both
    layers' widths, beside their plain versions, a library composite and
    their bounds.  The bound counts the function's own work: each tile
    and gather index read once, each source row the real slots name read
    once, the output written once; 2 nnz F flops (plus the transform of
    each named source row for the fused form).  The fused form's
    algo_bound_ms counts the flops of its per-slot transform instead, over
    the slots the kernel walks (tcgnn_tile.real_slots)."""
    from repro_torch.kernels import tcgnn_tile as tc_mod
    gen = torch.Generator(device="cuda").manual_seed(5)
    tc, tc_t = dec.sub("inter").formats["tcgnn_tile"]
    nbr, B, C = tc.tiles.shape
    n, be = dec.n_pad, 4
    gi, gi_t = tc.gather_idx.long(), tc_t.gather_idx.long()

    def named(p) -> tuple[int, int]:
        """(non-zero tile entries, distinct source rows of real slots)."""
        real = (p.tiles != 0).any(dim=1)               # (nbr, C)
        return (int((p.tiles != 0).sum()),
                int(torch.unique(p.gather_idx[real]).numel()))

    nnz, n_src = named(tc)
    nnz_t = named(tc_t)[0]
    walked = int(tc_mod.real_slots(tc.tiles).sum())
    meta = nbr * B * C * 4 + nbr * C * 4
    rows = {k: {} for k in ("tcgnn_spmm", "tcgnn_spmm_fused",
                            "tcgnn_spmm_dw")}
    shape = [[nbr, B, C], [nnz, "non-zero entries"], [n_src, "source rows"]]
    for F in (16, 3):
        x = torch.randn((n, F), generator=gen, device="cuda")
        lib = lambda: torch.bmm(tc.tiles, x[gi])  # noqa: E731
        torch.testing.assert_close(lib().view(n, F), tc_mod.plain(
            tc.tiles, tc.gather_idx, x), **F32_TOL)
        b_ms, b_by = tcgnn_spmm_bound(torch, tc, n, F)
        # the backward's dX pass runs the same kernel over the transpose
        xt = torch.randn((n, F), generator=gen, device="cuda")
        torch.testing.assert_close(tc_mod.tcgnn_spmm(
            tc_t.tiles, tc_t.gather_idx, xt), tc_mod.plain(
            tc_t.tiles, tc_t.gather_idx, xt), **F32_TOL)
        rows["tcgnn_spmm"][F] = dict(
            ms=graph_ms(torch, lambda: tc_mod.tcgnn_spmm(
                tc.tiles, tc.gather_idx, x), flush),
            ms_tc_t=graph_ms(torch, lambda: tc_mod.tcgnn_spmm(
                tc_t.tiles, tc_t.gather_idx, xt), flush),
            plain_ms=graph_ms(torch, lambda: tc_mod.plain(
                tc.tiles, tc.gather_idx, x), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="torch.bmm(tiles, x[gather_idx])",
            bound_ms=b_ms, bound_by=b_by, shape=shape + [[n, F]])
    for Fi, Fo in WIDTHS[:2]:
        key = f"{Fi}x{Fo}"
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        g = torch.randn((n, Fo), generator=gen, device="cuda")
        lib = lambda: torch.bmm(tc.tiles, (x @ w)[gi])  # noqa: E731
        torch.testing.assert_close(lib().view(n, Fo), tc_mod.plain_fused(
            tc.tiles, tc.gather_idx, x, w), **F32_TOL)
        io_bytes = meta + n_src * Fi * be + Fi * Fo * be + n * Fo * be
        b_ms, b_by = tcgnn_fused_bound(torch, tc, n, Fi, Fo)
        # the kernel transforms each slot up to its row's last non-zero
        # column once
        algo_ms, algo_by = bound(io_bytes, 2.0 * walked * Fi * Fo
                                 + 2.0 * B * walked * Fo, "float32")
        rows["tcgnn_spmm_fused"][key] = dict(
            ms=graph_ms(torch, lambda: tc_mod.tcgnn_spmm_fused(
                tc.tiles, tc.gather_idx, x, w), flush),
            plain_ms=graph_ms(torch, lambda: tc_mod.plain_fused(
                tc.tiles, tc.gather_idx, x, w), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="torch.bmm(tiles, (x @ w)[gather_idx])",
            bound_ms=b_ms, bound_by=b_by,
            algo_bound_ms=algo_ms, algo_bound_by=algo_by,
            shape=shape + [[n, Fi], [Fi, Fo]])
        lib = lambda: x.T @ torch.bmm(  # noqa: E731
            tc_t.tiles, g[gi_t]).view(n, Fo)
        dw_rel_err(lib(), tc_mod.plain_dw(tc_t.tiles, tc_t.gather_idx, x, g),
                   "x.T @ bmm(tiles_t, g[gather_idx_t])")
        b_ms, b_by = tcgnn_dw_bound(torch, tc_t, n, Fi, Fo)
        rows["tcgnn_spmm_dw"][key] = dict(
            ms=graph_ms(torch, lambda: tc_mod.tcgnn_spmm_dw(
                tc_t.tiles, tc_t.gather_idx, x, g), flush),
            plain_ms=graph_ms(torch, lambda: tc_mod.plain_dw(
                tc_t.tiles, tc_t.gather_idx, x, g), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="x.T @ torch.bmm(tiles_t, g[gather_idx_t])",
            bound_ms=b_ms, bound_by=b_by,
            shape=[[nbr, B, C], [nnz_t, "non-zero entries"], [n, Fi],
                   [n, Fo]])
    for k, by in rows.items():
        for kk, r in by.items():
            log("timing", f"{k} {kk}: {r['ms']:.4f} ms (L2 cold), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
                f"({r['library_call']}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})"
                + (f"; over tc_t {r['ms_tc_t']:.4f} ms" if "ms_tc_t" in r
                   else "") + (
                    f"; with the kernel's transform of each of the "
                    f"{walked} real slots "
                    f"{r['algo_bound_ms']:.4f} ms ({r['algo_bound_by']})"
                    if "algo_bound_ms" in r else ""))
    return rows


def time_train_kernels(torch, dec, flush, bsr, bsr_t) -> dict:
    """The training path's kernels at both layers' widths (L2 flushed),
    beside their plain versions, a library composite and their bounds."""
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    gen = torch.Generator(device="cuda").manual_seed(3)
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]
    nb, B = bd.blocks.shape[0], bd.block_size
    Bb = bell.block_size
    nv, nv_t = int(bell.n_valid.sum()), int(bell_t.n_valid.sum())
    valid = (torch.arange(bell.max_blocks, device="cuda")[None, :]
             < bell.n_valid[:, None])
    n_src = int(torch.unique(bell.col_idx[valid]).numel()) * Bb
    n, be = dec.n_pad, 4
    rows = {k: {} for k in ("block_diag_spmm_fused", "bell_spmm_fused",
                            "bell_spmm_dw")}
    for Fi, Fo in WIDTHS[:2]:
        key = f"{Fi}x{Fo}"
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        g = torch.randn((n, Fo), generator=gen, device="cuda")
        bt1 = bd.blocks.unsqueeze(1)

        # block_diag_spmm_fused: every row transformed once
        lib = lambda: torch.bmm(bd.blocks, (x @ w).view(nb, B, Fo))  # noqa: E731
        torch.testing.assert_close(lib().view(n, Fo), bdf_mod.plain(
            bd.blocks, x, w), **F32_TOL)
        b_ms, b_by = bound((nb * B * B + n * Fi + Fi * Fo + n * Fo) * be,
                           2.0 * n * Fi * Fo + 2.0 * nb * B * B * Fo,
                           "float32")
        rows["block_diag_spmm_fused"][key] = dict(
            ms=graph_ms(torch, lambda: bdf_mod.block_diag_spmm_fused(
                bd.blocks, x, w), flush),
            plain_ms=graph_ms(torch, lambda: bdf_mod.plain(bd.blocks, x, w),
                              flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="torch.bmm(blocks, (x @ w).view(nb, B, Fo))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bd.blocks.shape), [n, Fi], [Fi, Fo]])

        # bell_spmm_fused: the function reads each real block, each source
        # row of x and w once and writes y once, and transforms each source
        # row once (2 n_src Fi Fo flops); the kernel transforms a source
        # block once per stored block that names it (algo_bound_ms)
        io_bytes = (nv * (Bb * Bb * be + 4) + bell.n_brow * 4
                    + n_src * Fi * be + Fi * Fo * be + bell.n_rows * Fo * be)
        b_ms, b_by = bound(io_bytes, 2.0 * n_src * Fi * Fo
                           + 2.0 * nv * Bb * Bb * Fo, "float32")
        algo_ms, algo_by = bound(
            io_bytes, nv * (2.0 * Bb * Fi * Fo + 2.0 * Bb * Bb * Fo),
            "float32")
        lib_ms, lib_how = None, "none"
        if bsr is not None:
            torch.testing.assert_close(bsr @ (x @ w), bellf_mod.plain(
                bell.blocks, bell.col_idx, x, w), **F32_TOL)
            lib_ms, lib_how = yardstick_ms(torch, lambda: bsr @ (x @ w),
                                           flush, f"BSR @ (x @ w) {key}")
        rows["bell_spmm_fused"][key] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_fused(
                bell.blocks, bell.col_idx, x, w, n_valid=bell.n_valid), flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain(
                bell.blocks, bell.col_idx, x, w), flush),
            library_ms=lib_ms,
            library_call=f"torch BSR(real blocks) @ (x @ w), {lib_how}",
            bound_ms=b_ms, bound_by=b_by,
            algo_bound_ms=algo_ms, algo_bound_by=algo_by,
            shape=[list(bell.blocks.shape), [nv, "real blocks"],
                   [n_src, "source rows"], [n, Fi], [Fi, Fo]])

        # bell_spmm_dw over the transpose payload, and over the diagonal
        b_ms, b_by = bound(
            nv_t * (Bb * Bb * be + 4) + bell_t.n_brow * 4 + n * Fi * be
            + n * Fo * be + Fi * Fo * 4,
            nv_t * 2.0 * Bb * Bb * Fo + 2.0 * n * Fi * Fo, "float32")
        lib_ms, lib_how = None, "none"
        if bsr_t is not None:
            dw_rel_err(x.T @ (bsr_t @ g), bellf_mod.plain_dw(
                bell_t.blocks, bell_t.col_idx, x, g), "x.T @ (bsr_t @ g)")
            lib_ms, lib_how = yardstick_ms(torch, lambda: x.T @ (bsr_t @ g),
                                           flush, f"x.T @ (BSR_t @ g) {key}")
        rows["bell_spmm_dw"][key] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_dw(
                bell_t.blocks, bell_t.col_idx, x, g, n_valid=bell_t.n_valid),
                flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain_dw(
                bell_t.blocks, bell_t.col_idx, x, g), flush),
            library_ms=lib_ms,
            library_call=(f"x.T @ (torch BSR(bell_t real blocks) @ g), "
                          f"{lib_how}"),
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bell_t.blocks.shape), [nv_t, "real blocks"], [n, Fi],
                   [n, Fo]])
        lib = lambda: x.T @ torch.bmm(  # noqa: E731
            bd.blocks.transpose(1, 2), g.view(nb, B, Fo)).view(n, Fo)
        dw_rel_err(lib(), bellf_mod.plain_dw(bt1, None, x, g, transpose=True),
                   "x.T @ bmm(blocks^T, g)")
        b_ms, b_by = bound((nb * B * B + n * Fi + n * Fo) * be + Fi * Fo * 4,
                           2.0 * nb * B * B * Fo + 2.0 * n * Fi * Fo,
                           "float32")
        rows["bell_spmm_dw"][f"diag {key}"] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_dw(
                bt1, None, x, g, transpose=True), flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain_dw(
                bt1, None, x, g, transpose=True), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="x.T @ torch.bmm(blocks^T, g.view(nb, B, Fo))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[[nb, 1, B, B], [n, Fi], [n, Fo]])
        for k in rows:
            for kk in (key, f"diag {key}"):
                r = rows[k].get(kk)
                if r is None:
                    continue
                lib_s = (f"{r['library_ms']:.4f}" if r["library_ms"]
                         is not None else "null")
                log("timing", f"{k} {kk}: {r['ms']:.4f} ms (L2 cold), plain "
                    f"{r['plain_ms']:.4f} ms, library {lib_s} ms "
                    f"({r['library_call']}), bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']})" + (
                        f"; with the kernel's recompute "
                        f"{r['algo_bound_ms']:.4f} ms ({r['algo_bound_by']})"
                        if "algo_bound_ms" in r else ""))
    return rows


def phase_kernels_dual(torch, sdec, errs: dict) -> None:
    """block_diag_spmm_dual against its plain version on ``sdec``'s device
    (pubmed's SAGE diagonal blocks and synthetic ones with B in {8, 32,
    64}) at the SAGE layers' widths, float32 and bfloat16, y_in off and
    on; then the dual Function's backward against autograd through the
    plain version from unit-scale cotangents: dX at the kernel tolerance,
    float32 dW and dW_self within DW_REL_TOL of their largest entry
    (bfloat16 ones at the bfloat16 tolerance), the same bits on a second
    backward.  Adds the largest errors to ``errs``."""
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    from repro_torch.kernels import ops
    dev = sdec.device
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = [("pubmed", sdec.intra.formats["block_diag"].blocks)] + [
        (f"B={B}", randn(40, B, B)) for B in (8, 32, 64)]
    name, err, n_cases = "block_diag_spmm_dual", errs["block_diag_spmm_dual"], 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for where, blocks in cases:
            blocks = blocks.to(dtype)
            n = blocks.shape[0] * blocks.shape[1]
            logged = where == "pubmed"
            for Fi, Fo in WIDTHS[:2]:
                x = randn(n, Fi).to(dtype)
                w = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
                ws = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
                for with_y in (False, True):
                    y_in = randn(n, Fo).to(dtype) if with_y else None
                    got = bdf_mod.block_diag_spmm_dual(blocks, x, w, ws, y_in)
                    want = bdf_mod.plain_dual(blocks, x, w, ws, y_in)
                    sync(torch, dev)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    e = max_err(got, want)
                    err[key] = max(err[key], e)
                    n_cases += 1
                    if logged:
                        log("kernel", f"{name} {key} {where} {Fi}x{Fo} "
                            f"y_in={with_y}: max|err| {e:.3g}")
                cot = randn(n, Fo).to(dtype).float()
                grads = []
                for fn in (lambda *a: ops.block_diag_dual_matvec(blocks, *a),
                           lambda *a: ops.block_diag_dual_matvec(blocks, *a),
                           lambda *a: bdf_mod.plain_dual(blocks, *a)):
                    leaves = [a.clone().requires_grad_() for a in (x, w, ws)]
                    (fn(*leaves).float() * cot).sum().backward()
                    grads.append([a.grad for a in leaves])
                sync(torch, dev)
                (dx, dw, dws), again, (wdx, wdw, wdws) = grads
                torch.testing.assert_close(dx.float(), wdx.float(), **tol)
                if not all(torch.equal(a, b) for a, b in zip(grads[0],
                                                             again)):
                    raise RuntimeError(f"{name} backward gave other bits on "
                                       "a second run")
                if dtype == torch.float32:
                    rel = max(dw_rel_err(dw, wdw, f"{name} dW {where}"),
                              dw_rel_err(dws, wdws, f"{name} dW_self {where}"))
                else:
                    for a, b in ((dw, wdw), (dws, wdws)):
                        torch.testing.assert_close(a.float(), b.float(), **tol)
                    rel = max(max_err(dw, wdw) / float(wdw.abs().max()),
                              max_err(dws, wdws) / float(wdws.abs().max()))
                err[f"{key}_rel"] = max(err.get(f"{key}_rel", 0.0), rel)
                err[key] = max(err[key], max_err(dx, wdx))
                n_cases += 1
                if logged:
                    log("kernel", f"{name} backward {key} {where} {Fi}x{Fo}: "
                        f"max|dX err| {max_err(dx, wdx):.3g}, dW and dW_self "
                        f"/ max|dW| {rel:.3g} (same bits twice)")
    log("kernel", f"{n_cases} {name} cases within tolerance (pubmed's SAGE "
        f"blocks and B in 8, 32, 64); largest errors {err}")


def phase_sage_train(torch, graph, dec, counts: dict) -> dict:
    """SAGE on ``dec`` (its decomposition on the card): logits of each
    fixed plan against the edge-list SAGE, then gnn.train for each fixed
    plan from one parameter set, the launch counts set to 0 just before
    and read just after; checks the counts against SAGE_PER_STEP (2 dual
    launches per step on the dual plan) and each curve against the CPU's
    and the edge-list SAGE's."""
    import dataclasses
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    cfg = gnn.GNNConfig(model="sage", selector="fixed")
    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, device="cpu")
    for name, pair in SAGE_PLANS.items():
        want = {k: TRAIN_STEPS * SAGE_PER_STEP[name].get(k, 0)
                + SAGE_PER_FORWARD[name].get(k, 0) for k in counts}
        if plan_launches((pair, pair), TRAIN_STEPS, "sage") != want:
            raise RuntimeError(f"{name}: SAGE_PER_STEP disagrees with "
                               "plan_launches")
    edges = sage_edge_list(torch, graph)
    feats = torch.from_numpy(graph.features)
    edge_ref = edge_list_sage(torch, feats, edges, params)
    x = adaptgear.to_reordered(dec, feats.cuda())
    p_dev = [{k: v.cuda() for k, v in p.items()} for p in params]
    for name, pair in SAGE_PLANS.items():
        y = gnn.forward(p_dev, cfg, dec, x, pair)
        if tuple(y.shape) != (dec.n_pad, n_classes) or not bool(
                torch.isfinite(y).all()):
            raise RuntimeError(f"{name}: logits {tuple(y.shape)}, finite "
                               f"{bool(torch.isfinite(y).all())}")
        y_orig = adaptgear.from_reordered(dec, y).cpu()
        torch.testing.assert_close(y_orig, edge_ref, **F32_TOL)
        log("sage", f"{name} {pair}: logits max|card - edge-list SAGE| "
            f"{max_err(y_orig, edge_ref):.3g}")

    results, used = {}, {}
    for c in counts.values():
        c.reset()
    for name, pair in SAGE_PLANS.items():
        before = {k: c.value for k, c in counts.items()}
        results[name] = gnn.train(
            graph, dataclasses.replace(cfg, fixed_kernels=pair),
            steps=TRAIN_STEPS, device="cuda", params=params)
        torch.cuda.synchronize()
        used[name] = {k: c.value - before[k] for k, c in counts.items()}
    launches = {k: c.value for k, c in counts.items()}
    log("sage", f"launches over both runs {launches}")

    edge_losses = edge_list_train(
        torch, graph, params, TRAIN_STEPS, cfg.lr,
        forward=lambda f, q: edge_list_sage(torch, f, edges, q))
    for name, pair in SAGE_PLANS.items():
        r = results[name]
        want = {k: TRAIN_STEPS * SAGE_PER_STEP[name].get(k, 0)
                + SAGE_PER_FORWARD[name].get(k, 0) for k in counts}
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want} ({TRAIN_STEPS} steps and one "
                               "forward)")
        losses = np.asarray(r.losses)
        if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
            raise RuntimeError(f"{name}: losses {r.losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: the loss did not fall: {r.losses}")
        cpu = gnn.train(graph, dataclasses.replace(cfg, fixed_kernels=pair),
                        steps=TRAIN_STEPS, device="cpu", params=params)
        np.testing.assert_allclose(losses, cpu.losses, **CURVE_TOL)
        np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
        log("sage", f"{name} {pair}: {TRAIN_STEPS} steps, launches "
            f"{ {k: v for k, v in used[name].items() if v} } = "
            f"{TRAIN_STEPS} x {SAGE_PER_STEP[name]} + one forward; losses "
            f"{losses[0]:.6f} -> {losses[-1]:.6f}, accuracy {r.accuracy:.4f}, "
            f"step {r.step_seconds * 1e3:.3f} ms (host clock, loss read every "
            f"step); max|card - cpu| {np.abs(losses - cpu.losses).max():.3g}, "
            f"max|card - edge-list SAGE| "
            f"{np.abs(losses - edge_losses).max():.3g}")
    return dict(results=results, launches=launches, used=used,
                params=params, dec=dec, x=x, edge_losses=edge_losses)


def phase_sage_feedback(torch, graph, counts: dict, sage: dict) -> dict:
    """The SAGE main path: gnn.train(graph, GNNConfig(model="sage")) with
    the feedback selector, launch counts set to 0 just before and read just
    after; they must equal the probe calls plus what the committed plan
    implies (the dual kernel only where the plan committed
    block_diag_fused on the diagonal tier).  The curve must fall and match
    the same plan on the CPU and the edge-list SAGE."""
    import dataclasses
    import numpy as np
    from repro_torch.core import gnn
    fb_cfg = gnn.GNNConfig(model="sage")
    params = sage["params"]
    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    res = gnn.train(graph, fb_cfg, steps=TRAIN_STEPS, device="cuda",
                    params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.value for k, c in counts.items()}
    plan = res.plan
    n_probe = 2 * (1 + fb_cfg.warmup_iters)
    probed = ("block_diag_spmm", "bell_spmm", "block_diag_spmm_fused",
              "bell_spmm_fused", "tcgnn_spmm", "tcgnn_spmm_fused")
    trained = plan_launches(plan.layers, TRAIN_STEPS, "sage")
    want = {k: trained[k] + (n_probe if k in probed else 0) for k in counts}
    if launches != want:
        raise RuntimeError(f"SAGE feedback launches {launches}, expected "
                           f"{want}: {n_probe} probe calls of each forward "
                           f"kernel and {trained} for {TRAIN_STEPS} steps "
                           "and one forward")
    log("sage-feedback", f"gnn.train(graph, GNNConfig(model='sage')) "
        f"{TRAIN_STEPS} steps in {wall:.2f} s (selection included); "
        f"committed plan {plan.layers}; block_diag_spmm_dual launches "
        f"{launches['block_diag_spmm_dual']} (the plan implies "
        f"{trained['block_diag_spmm_dual']}); launches = {n_probe} probe "
        f"calls of each of {probed} + the committed plan's "
        f"{ {k: v for k, v in trained.items() if v} }")
    losses = np.asarray(res.losses)
    if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
        raise RuntimeError(f"SAGE feedback: losses {res.losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"SAGE feedback: the loss did not fall: "
                           f"{res.losses}")
    cpu = gnn.train(graph, dataclasses.replace(
        fb_cfg, selector="fixed", fixed_kernels=plan.layers),
        steps=TRAIN_STEPS, device="cpu", params=params)
    if cpu.kernels != res.kernels:
        raise RuntimeError(f"cpu plan {cpu.kernels} != {res.kernels}")
    np.testing.assert_allclose(losses, cpu.losses, **CURVE_TOL)
    np.testing.assert_allclose(losses, sage["edge_losses"], **CURVE_TOL)
    log("sage-feedback", f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
        f"accuracy {res.accuracy:.4f}, step {res.step_seconds * 1e3:.3f} ms "
        f"(host clock); max|card - cpu| "
        f"{np.abs(losses - cpu.losses).max():.3g}, max|card - edge-list "
        f"SAGE| {np.abs(losses - sage['edge_losses']).max():.3g}")
    return dict(result=res, launches=launches, plan=plan)


def gin_edge_list(torch, graph):
    """GIN's edge list in original node order: (senders, receivers), unit
    values, no self-loops added.  The synthetic graphs hold no duplicate
    edge, so every format stores each edge once."""
    return (torch.from_numpy(graph.senders).long(),
            torch.from_numpy(graph.receivers).long())


def edge_list_gin(torch, feats, edges, params):
    """Independent CPU reference: the GIN forward, MLP((1+eps) h + sum over
    in-neighbours of h) per layer with ``index_add_`` over the edge list,
    ReLU between layers (aggregate-first, as Xu et al. write it)."""
    snd, rcv = edges
    h = feats
    for i, layer in enumerate(params):
        agg = torch.zeros_like(h).index_add_(0, rcv, h[snd])
        z = (1 + layer["eps"]) * h + agg
        h = torch.relu(z @ layer["w1"] + layer["b1"]) @ layer["w2"] \
            + layer["b2"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def train_on(torch, graph, cfg, dec, plan, params, steps: int) -> dict:
    """``gnn.train``'s loop on a decomposition already prepared (its
    reorder is not run again): ``steps`` steps of make_train_step from
    ``params`` and one forward, on ``dec``'s device.  Returns the losses
    and the accuracy."""
    from repro_torch.core import adaptgear, gnn
    dev = dec.device
    x = adaptgear.to_reordered(dec, torch.from_numpy(graph.features).to(dev))
    labels, mask = gnn.node_targets(graph, dec)
    p = [{k: v.detach().to(dev).clone() for k, v in q.items()}
         for q in params]
    opt = gnn._adam_init(p)
    step = gnn.make_train_step(cfg, dec, plan)
    losses = []
    for _ in range(steps):
        p, opt, loss = step(p, opt, x, labels, mask)
        losses.append(float(loss))
    with torch.no_grad():
        pred = gnn.forward(p, cfg, dec, x, plan).argmax(-1)
    acc = float(((pred == labels) & mask).sum() / mask.sum())
    return dict(losses=losses, accuracy=acc)


def phase_gin(torch, graph, counts: dict) -> dict:
    """GIN on pubmed (Fig. 8's GIN: 2 layers, hidden 16) on the Louvain
    reordering: the Louvain reorder alone, then ``prepare`` (both timed),
    and decomposition_quality against bfs; each fixed plan's logits
    against the CPU and the edge-list GIN, and TRAIN_STEPS steps of each
    with the launch counts set to 0 just before and read just after,
    checked against plan_launches(model="gin"), the curve against the CPU
    and the edge-list GIN trained with autograd; then the main path,
    gnn.train(graph, GNNConfig(model="gin", reorder="louvain")) with the
    feedback selector, its launches the probe calls plus what the
    committed plan implies, its curve against the same plan on the CPU and
    the edge-list GIN."""
    import dataclasses
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    from repro_torch.core import decompose as dec_mod
    fb_cfg = gnn.GNNConfig(model="gin", reorder="louvain")
    cfg = dataclasses.replace(fb_cfg, selector="fixed")
    t0 = time.perf_counter()
    perm = dec_mod.louvain_reorder(graph.n, graph.senders, graph.receivers,
                                   cfg.comm_size)
    t_louvain = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = gnn.prepare(graph, cfg, device="cuda")
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    if not np.array_equal(dec.perm.cpu().numpy(), perm):
        raise RuntimeError("prepare's Louvain permutation differs from "
                           "louvain_reorder's")
    if dec.stats["effective_method"] != "louvain":
        raise RuntimeError(f"effective method {dec.stats['effective_method']}")
    bfs = dec_mod.decompose_skeleton(graph, cfg.comm_size, "bfs")
    quality = {"louvain": dec_mod.decomposition_quality(dec),
               "bfs": dec_mod.decomposition_quality(bfs)}
    log("gin", f"Louvain reorder alone {t_louvain:.2f} s (the port's copy of "
        f"networkx's method, {len(np.unique(perm))} nodes); prepare "
        f"{t_prepare:.2f} s with it (reorder, partition, payloads on the "
        f"card); nnz " + ", ".join(f"{s.name} {s.stats['nnz']}"
                                   for s in dec.subgraphs)
        + "; decomposition_quality " + ", ".join(
            f"{m}: " + ", ".join(f"{k} {v:.6g}" for k, v in q.items())
            for m, q in quality.items()))
    if not quality["louvain"]["intra_frac"] > quality["bfs"]["intra_frac"]:
        raise RuntimeError(f"Louvain keeps fewer edges on the diagonal than "
                           f"bfs: {quality}")

    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    pairs, eps = gnn.layer_plan_inputs(cfg, in_dim, n_classes, dec=dec)
    structures = [e.structure for e in eps]
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, device="cpu")
    dec_cpu = dec.to("cpu")
    edges = gin_edge_list(torch, graph)
    feats = torch.from_numpy(graph.features)
    edge_ref = edge_list_gin(torch, feats, edges, params)
    x = adaptgear.to_reordered(dec, feats.cuda())
    x_cpu = adaptgear.to_reordered(dec_cpu, feats)
    p_dev = [{k: v.cuda() for k, v in p.items()} for p in params]
    plans = {}
    for name, pair in GIN_PLANS.items():
        plan, _ = gnn.select_plan(dec, dataclasses.replace(
            cfg, fixed_kernels=pair), pairs, epilogues=eps)
        plans[name] = plan
        with torch.no_grad():
            y = gnn.forward(p_dev, cfg, dec, x, plan)
            y_cpu = gnn.forward(params, cfg, dec_cpu, x_cpu, plan)
        if tuple(y.shape) != (dec.n_pad, n_classes) or not bool(
                torch.isfinite(y).all()):
            raise RuntimeError(f"{name}: logits {tuple(y.shape)}")
        torch.testing.assert_close(y.cpu(), y_cpu, **GIN_TOL)
        y_orig = adaptgear.from_reordered(dec_cpu, y.cpu())
        torch.testing.assert_close(y_orig, edge_ref, **GIN_TOL)
        log("gin", f"{name} {pair} (structures {structures}): logits "
            f"max|card - cpu| {max_err(y.cpu(), y_cpu):.3g}, max|card - "
            f"edge-list GIN| {max_err(y_orig, edge_ref):.3g}, largest "
            f"|logit| {float(edge_ref.abs().max()):.3g}")

    edge_losses = edge_list_train(
        torch, graph, params, TRAIN_STEPS, cfg.lr,
        forward=lambda f, q: edge_list_gin(torch, f, edges, q))
    results, used = {}, {}
    for c in counts.values():
        c.reset()
    for name, plan in plans.items():
        before = {k: c.value for k, c in counts.items()}
        results[name] = train_on(torch, graph, cfg, dec, plan, params,
                                 TRAIN_STEPS)
        torch.cuda.synchronize()
        used[name] = {k: c.value - before[k] for k, c in counts.items()}
    launches = {k: c.value for k, c in counts.items()}
    for name, plan in plans.items():
        want = plan_launches(plan.layers, TRAIN_STEPS, "gin", structures)
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want} ({TRAIN_STEPS} steps and one "
                               "forward)")
        losses = np.asarray(results[name]["losses"])
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: losses {losses.tolist()}")
        n_cpu = GIN_CPU_STEPS[name]
        cpu = train_on(torch, graph, cfg, dec_cpu, plan, params, n_cpu)
        np.testing.assert_allclose(losses[:n_cpu], cpu["losses"],
                                   **CURVE_TOL)
        np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
        one, none = (plan_launches(plan.layers, n, "gin", structures)
                     for n in (1, 0))
        log("gin", f"{name} {plan.layers}: {TRAIN_STEPS} steps, launches "
            f"{ {k: v for k, v in used[name].items() if v} } = plan_launches"
            f"(model='gin'), per step "
            f"{ {k: one[k] - none[k] for k in one if one[k] - none[k]} }; "
            f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
            f"{results[name]['accuracy']:.4f}; max|card - cpu| over {n_cpu} "
            f"steps {np.abs(losses[:n_cpu] - cpu['losses']).max():.3g}, "
            f"max|card - edge-list GIN| "
            f"{np.abs(losses - edge_losses).max():.3g}")

    # the main path: feedback selection on the Louvain reordering
    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    res = gnn.train(graph, fb_cfg, steps=TRAIN_STEPS, device="cuda",
                    params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb_launches = {k: c.value for k, c in counts.items()}
    plan = res.plan
    if [e.structure for e in plan.epilogues] != structures:
        raise RuntimeError(f"feedback structures {plan.epilogues}")
    n_probe = len(set(pairs)) * (1 + fb_cfg.warmup_iters)
    probed = ("block_diag_spmm", "bell_spmm", "block_diag_spmm_fused",
              "bell_spmm_fused", "tcgnn_spmm", "tcgnn_spmm_fused")
    trained = plan_launches(plan.layers, TRAIN_STEPS, "gin", structures)
    want = {k: trained[k] + (n_probe if k in probed else 0) for k in counts}
    if fb_launches != want:
        raise RuntimeError(f"GIN feedback launches {fb_launches}, expected "
                           f"{want}: {n_probe} probe calls of each forward "
                           f"kernel and {trained} for {TRAIN_STEPS} steps "
                           "and one forward")
    losses = np.asarray(res.losses)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"GIN feedback: losses {res.losses}")
    cpu = train_on(torch, graph, cfg, dec_cpu, plan, params, TRAIN_STEPS)
    np.testing.assert_allclose(losses, cpu["losses"], **CURVE_TOL)
    np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
    one, none = (plan_launches(plan.layers, n, "gin", structures)
                 for n in (1, 0))
    log("gin-feedback", f"gnn.train(graph, GNNConfig(model='gin', "
        f"reorder='louvain')) {TRAIN_STEPS} steps in {wall:.2f} s (Louvain, "
        f"prepare and selection included; prepare "
        f"{res.preprocess_seconds:.2f} s); committed plan {plan.layers}, "
        f"structures {structures}, width pairs {pairs}; launches = "
        f"{n_probe} probe calls of each of {probed} + the committed plan's "
        f"{ {k: v for k, v in trained.items() if v} }, per step "
        f"{ {k: one[k] - none[k] for k in one if one[k] - none[k]} }; "
        f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
        f"{res.accuracy:.4f}, step {res.step_seconds * 1e3:.3f} ms (host "
        f"clock, loss read every step); max|card - cpu| "
        f"{np.abs(losses - cpu['losses']).max():.3g}, max|card - edge-list "
        f"GIN| {np.abs(losses - edge_losses).max():.3g}")
    plans["gin_feedback"] = plan
    return dict(dec=dec, x=x, params=params, cfg=cfg, plans=plans,
                structures=structures, launches=launches,
                fb_launches=fb_launches, result=res, results=results,
                t_louvain=t_louvain, t_prepare=t_prepare, quality=quality)


def phase_gin_structure(torch, counts: dict) -> dict:
    """GIN of hidden GIN_STRUCT_HIDDEN on proteins_full (29 features, bfs):
    layer 1 forced to each structure through the plan's epilogues, and
    under the structure layer_plan_inputs prices on the card, for each of
    GIN_STRUCT_PLANS.  Aggregate-first sends block_diag_spmm, bell_spmm
    and tcgnn_spmm through F = 29; the fused kernels run Fi = 29 -> Fo =
    64 (a fused plan runs transform-first whatever its epilogue says).
    Each forward's launches (counts set to 0 just before, read just after)
    must equal plan_launches(steps=0); its logits must agree with the
    edge-list GIN, and the two structures' with each other (float32 atol
    1e-4, rtol 1e-5)."""
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    from repro_torch.core import epilogue as ep_mod
    from repro_torch.core.plan import KernelPlan
    from repro_torch.graphs import graph as graph_mod
    pg = graph_mod.synth_dataset("proteins_full", scale=1.0, seed=0)
    cfg = gnn.GNNConfig(model="gin", hidden=GIN_STRUCT_HIDDEN, n_layers=2,
                        selector="fixed")
    in_dim, n_classes, hid = pg.features.shape[1], pg.n_classes, cfg.hidden
    t0 = time.perf_counter()
    dec = gnn.prepare(pg, cfg, device="cuda")
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    pairs, priced = gnn.layer_plan_inputs(cfg, in_dim, n_classes, dec=dec)
    params = gnn.init_model(torch.Generator().manual_seed(3), cfg, in_dim,
                            n_classes, device="cpu")
    params = [dict(p, eps=torch.tensor(0.1 * (i + 1)))
              for i, p in enumerate(params)]
    feats = torch.from_numpy(pg.features)
    x = adaptgear.to_reordered(dec, feats.cuda())
    p_dev = [{k: v.cuda() for k, v in p.items()} for p in params]
    edge_ref = edge_list_gin(torch, feats, gin_edge_list(torch, pg), params)
    last = ep_mod.gin_layer_spec(hid, hid, n_classes, "transform_first")
    variants = {st: (ep_mod.gin_layer_spec(in_dim, hid, hid, st), last)
                for st in ("transform_first", "aggregate_first")}
    variants["priced"] = priced
    log("gin_structure", f"{pg.name} n={pg.n} edges={pg.n_edges} features="
        f"{in_dim} classes={n_classes}, GIN hidden {hid}; prepare "
        f"{t_prep:.2f} s; n_pad={dec.n_pad}; layer_plan_inputs on the card "
        f"(H100_HW) prices layer 1 {priced[0].structure}, width pairs "
        f"{pairs}")
    launches = {k: 0 for k in counts}
    worst = {}
    for plan_pair in GIN_STRUCT_PLANS:
        got, per_fwd = {}, {}
        for name, eps in variants.items():
            plan = KernelPlan.make(dec, plan_pair, n_layers=2, epilogues=eps)
            for c in counts.values():
                c.reset()
            with torch.no_grad():
                y = gnn.forward(p_dev, cfg, dec, x, plan)
            torch.cuda.synchronize()
            used = {k: c.value for k, c in counts.items()}
            want = plan_launches(plan.layers, 0, "gin",
                                 [e.structure for e in eps])
            if used != want:
                raise RuntimeError(f"{plan_pair} {name}: launches {used}, "
                                   f"expected {want}")
            for k, v in used.items():
                launches[k] += v
            per_fwd[name] = {k: v for k, v in used.items() if v}
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"{plan_pair} {name}: non-finite logits")
            y_orig = adaptgear.from_reordered(dec, y).cpu()
            torch.testing.assert_close(y_orig, edge_ref, **GIN_TOL)
            got[name] = y.cpu()
            worst[(plan_pair, name)] = max_err(y_orig, edge_ref)
        torch.testing.assert_close(got["aggregate_first"],
                                   got["transform_first"], **GIN_TOL)
        log("gin_structure", f"{plan_pair}: launches per forward {per_fwd}"
            "; max|card - edge-list GIN| " + ", ".join(
                f"{n} {worst[(plan_pair, n)]:.3g}" for n in variants)
            + f"; max|aggregate-first - transform-first| "
            f"{max_err(got['aggregate_first'], got['transform_first']):.3g}")
    log("gin_structure", f"largest |logit| {float(edge_ref.abs().max()):.3g};"
        f" launches over all forwards {launches}")
    return dict(launches=launches, priced=priced[0].structure, worst=worst)


def phase_o1(torch, dec) -> dict:
    """The paper's Fig. 11 ablation on the Louvain pubmed decomposition
    (GIN's: unit values, no self-loops) at O1_WIDTH features: O1,
    aggregate_full_static with each kernel that applies to every tier,
    each checked against the same call on the CPU (plain torch ops) and
    an edge-list ``index_add_``; O2, the static per-subgraph ("ell",
    "coo"); O3, the kernels the feedback selector's probe picks.  Times
    are medians of CUDA events around eager calls after a sync, as
    Fig. 11 times them; printed, not a benchmark."""
    from repro_torch.core import adaptgear
    from repro_torch.core import selector as sel_mod
    from repro_torch.kernels.registry import DIAG, OFFDIAG, REGISTRY
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((dec.n_pad, O1_WIDTH), generator=gen, device="cuda")
    dec_cpu = dec.to("cpu")
    x_cpu = x.cpu()
    rows, cols, vals = [], [], []
    for sub in dec_cpu.subgraphs:
        coo = sub.formats["coo"]
        rows.append(coo.rows.long())
        cols.append(coo.cols.long())
        vals.append(coo.vals)
    rows, cols, vals = (torch.cat(t) for t in (rows, cols, vals))
    want = torch.zeros_like(x_cpu).index_add_(0, rows,
                                              x_cpu[cols] * vals[:, None])
    kernels = [s.name for s in REGISTRY.candidates(DIAG)
               if s.applies_to(OFFDIAG)]
    times, errs = {}, {}
    for k in kernels:
        y = adaptgear.aggregate_full_static(dec, x, k)
        y_cpu = adaptgear.aggregate_full_static(dec_cpu, x_cpu, k)
        torch.testing.assert_close(y.cpu(), y_cpu, **F32_TOL)
        torch.testing.assert_close(y.cpu(), want, **F32_TOL)
        errs[k] = max_err(y.cpu(), want)
        times[f"O1 {k}"] = eager_ms(
            torch, lambda k=k: adaptgear.aggregate_full_static(dec, x, k))
    o2 = ("ell", "coo")
    torch.testing.assert_close(adaptgear.aggregate(dec, x, o2).cpu(), want,
                               **F32_TOL)
    times[f"O2 {o2}"] = eager_ms(torch, lambda: adaptgear.aggregate(dec, x,
                                                                     o2))
    sel = sel_mod.AdaptiveSelector(dec, warmup_iters=1)
    choice = sel.probe(x, iters=1).choice
    torch.testing.assert_close(adaptgear.aggregate(dec, x, choice).cpu(),
                               want, **F32_TOL)
    times[f"O3 {choice}"] = eager_ms(
        torch, lambda: adaptgear.aggregate(dec, x, choice))
    log("o1", f"Fig. 11 on pubmed (Louvain, GIN's unit values) at F = "
        f"{O1_WIDTH}: each O1 kernel against the edge-list index_add_ "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + "; median ms (CUDA events, eager, host launch included): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return dict(times=times, choice=choice, errs=errs)


def edge_list_gat(torch, feats, edges, params, slope: float = 0.2):
    """Independent CPU reference: single-head GAT on the whole edge list
    in original node order, a softmax over each node's in-edges (a segment
    max, exp, index_add_), a node with no in-edge giving ``b``; ReLU
    between layers.  It knows nothing of the decomposition."""
    snd, rcv = edges
    n = feats.shape[0]
    h = feats
    for i, layer in enumerate(params):
        hw = h @ layer["w"]
        e = torch.nn.functional.leaky_relu(
            (hw @ layer["a_dst"])[rcv] + (hw @ layer["a_src"])[snd], slope)
        m = torch.full((n,), -torch.inf).scatter_reduce(0, rcv, e.detach(),
                                                        "amax")
        p = torch.exp(e - m[rcv])
        z = torch.zeros(n).index_add_(0, rcv, p)
        y = torch.zeros((n, hw.shape[1])).index_add_(0, rcv,
                                                      hw[snd] * p[:, None])
        h = y / torch.where(z > 0, z, 1.0)[:, None] + layer["b"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def phase_gat(torch, graph, counts: dict) -> dict:
    """GAT on pubmed (2 layers, hidden 16, bfs, no self-loops, unit
    values): the main path gnn.train(graph, GNNConfig(model="gat")) with
    the feedback selector for TRAIN_STEPS steps, the launch counts set to
    0 just before and read just after: the probe's calls of each unfused
    forward kernel and nothing else (GAT reads the edges, not the
    committed plan, as in the reference); the logits of its initial
    parameters on the card against the CPU and against the edge-list GAT
    (float32 atol 1e-4 / rtol 1e-5), and its curve against the same
    training on the CPU and the edge-list GAT trained with autograd (atol
    5e-3, rtol 1e-2)."""
    import dataclasses
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    fb_cfg = gnn.GNNConfig(model="gat")
    cfg = dataclasses.replace(fb_cfg, selector="fixed")
    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, device="cpu")
    edges = gin_edge_list(torch, graph)
    feats = torch.from_numpy(graph.features)

    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    res = gnn.train(graph, fb_cfg, steps=TRAIN_STEPS, device="cuda",
                    params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.value for k, c in counts.items()}
    pairs = gnn.agg_width_pairs(cfg, in_dim, n_classes)
    n_probe = len(set(pairs)) * (1 + fb_cfg.warmup_iters)
    probed = ("block_diag_spmm", "bell_spmm", "tcgnn_spmm")
    want = {k: n_probe if k in probed else 0 for k in counts}
    if launches != want:
        raise RuntimeError(f"GAT feedback launches {launches}, expected "
                           f"{want}: {n_probe} probe calls of each unfused "
                           "forward kernel and none in the steps")
    plan = res.plan
    if plan.epilogues != (None,) * cfg.n_layers:
        raise RuntimeError(f"GAT epilogues {plan.epilogues}")
    losses = np.asarray(res.losses)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"GAT feedback: losses {res.losses}")

    dec = gnn.prepare(graph, cfg, device="cuda")
    dec_cpu = dec.to("cpu")
    x = adaptgear.to_reordered(dec, feats.cuda())
    x_cpu = adaptgear.to_reordered(dec_cpu, feats)
    p_dev = [{k: v.cuda() for k, v in p.items()} for p in params]
    with torch.no_grad():
        y = gnn.forward(p_dev, cfg, dec, x, plan)
        y_cpu = gnn.forward(params, cfg, dec_cpu, x_cpu, plan)
    if tuple(y.shape) != (dec.n_pad, n_classes) or not bool(
            torch.isfinite(y).all()):
        raise RuntimeError(f"GAT logits {tuple(y.shape)}")
    torch.testing.assert_close(y.cpu(), y_cpu, **GIN_TOL)
    edge_ref = edge_list_gat(torch, feats, edges, params)
    y_orig = adaptgear.from_reordered(dec_cpu, y.cpu())
    torch.testing.assert_close(y_orig, edge_ref, **GIN_TOL)
    cpu = train_on(torch, graph, cfg, dec_cpu, plan, params, GAT_CPU_STEPS)
    edge_losses = edge_list_train(
        torch, graph, params, TRAIN_STEPS, cfg.lr,
        forward=lambda f, q: edge_list_gat(torch, f, edges, q))
    np.testing.assert_allclose(losses[:GAT_CPU_STEPS], cpu["losses"],
                               **CURVE_TOL)
    np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
    lonely = int(graph.n - np.unique(graph.receivers).size)
    log("gat", f"gnn.train(graph, GNNConfig(model='gat')) {TRAIN_STEPS} "
        f"steps in {wall:.2f} s (prepare and selection included); "
        f"committed plan {plan.layers} (probed, not read: GAT runs torch "
        f"ops over the edges), width pairs {pairs}; launches {launches} = "
        f"{n_probe} probe calls of each of {probed}; {lonely} nodes have no "
        f"in-edge; logits max|card - cpu| {max_err(y.cpu(), y_cpu):.3g}, "
        f"max|card - edge-list GAT| {max_err(y_orig, edge_ref):.3g}, "
        f"largest |logit| {float(edge_ref.abs().max()):.3g}; losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, accuracy {res.accuracy:.4f}, "
        f"step {res.step_seconds * 1e3:.3f} ms (host clock, loss read every "
        f"step); max|card - cpu| over {GAT_CPU_STEPS} steps "
        f"{np.abs(losses[:GAT_CPU_STEPS] - cpu['losses']).max():.3g}, "
        f"max|card - edge-list GAT| {np.abs(losses - edge_losses).max():.3g}")
    return dict(dec=dec, x=x, params=params, cfg=cfg, plan=plan, result=res,
                launches=launches)


def phase_mean_max(torch, graph, dec, counts: dict) -> dict:
    """aggregate_mean and aggregate_max on the GAT decomposition (bfs,
    unit values) at each of MEAN_MAX_WIDTHS.  The mean under each of
    MEAN_PLANS through the hand kernels, launches counted per call (one
    per tier), against an edge-list mean (index_add_ over the original
    edges, 1/deg); the max and its gradient on random features against an
    edge-list max (scatter_reduce "amax", 0 where a node has no in-edge)
    and its autograd gradient, and on integer-valued features (tied
    maxima) against the same on the CPU.  float32 1e-4; the max's values
    exactly."""
    from repro_torch.core import adaptgear
    snd, rcv = gin_edge_list(torch, graph)
    deg = torch.bincount(rcv, minlength=graph.n).float()
    inv_orig = 1.0 / deg.clamp(min=1.0)
    inv = torch.zeros(dec.n_pad)
    inv[dec.perm.long().cpu()] = inv_orig
    inv = inv.cuda()
    has = (deg > 0)[:, None]
    dec_cpu = dec.to("cpu")
    kernel_of = {"bell": "bell_spmm", "tcgnn_tile": "tcgnn_spmm"}
    gen = torch.Generator().manual_seed(13)
    launches = {k: 0 for k in counts}
    errs = {}
    for F in MEAN_MAX_WIDTHS:
        feats = torch.randn((graph.n, F), generator=gen)
        want = torch.zeros_like(feats).index_add_(0, rcv, feats[snd]) \
            * inv_orig[:, None]
        x = adaptgear.to_reordered(dec, feats.cuda())
        for plan in MEAN_PLANS:
            names = (plan[0],) + (plan[1],) * (len(dec.subgraphs) - 1)
            for c in counts.values():
                c.reset()
            y = adaptgear.aggregate_mean(dec, x, inv, names)
            torch.cuda.synchronize()
            used = {k: c.value for k, c in counts.items() if c.value}
            expect = {"block_diag_spmm": 1,
                      kernel_of[plan[1]]: len(dec.subgraphs) - 1}
            if used != expect:
                raise RuntimeError(f"aggregate_mean {plan} F={F}: launches "
                                   f"{used}, expected {expect}")
            for k, v in used.items():
                launches[k] += v
            got = adaptgear.from_reordered(dec, y).cpu()
            torch.testing.assert_close(got, want, **F32_TOL)
            errs[f"mean {plan[1]} F={F}"] = max_err(got, want)
        leaf = feats.cuda().detach().requires_grad_()
        y = adaptgear.aggregate_max(dec, adaptgear.to_reordered(dec, leaf))
        cot = torch.randn((dec.n_pad, F), generator=gen)
        (y * cot.cuda()).sum().backward()
        ref_leaf = feats.detach().clone().requires_grad_()
        m = torch.full((graph.n, F), -torch.inf).scatter_reduce(
            0, rcv[:, None].expand(-1, F), ref_leaf[snd], "amax")
        want_max = torch.where(has, m, 0.0)
        (want_max * adaptgear.from_reordered(dec_cpu, cot)).sum().backward()
        got = adaptgear.from_reordered(dec, y.detach()).cpu()
        torch.testing.assert_close(got, want_max, atol=0, rtol=0)
        torch.testing.assert_close(leaf.grad.cpu(), ref_leaf.grad,
                                   **F32_TOL)
        errs[f"max grad F={F}"] = max_err(leaf.grad.cpu(), ref_leaf.grad)
        xi = torch.randint(-3, 4, (dec.n_pad, F), generator=gen).float()
        out = {}
        for d in (dec, dec_cpu):
            leaf = xi.to(d.device).detach().requires_grad_()
            y = adaptgear.aggregate_max(d, leaf)
            (y * cot.to(d.device)).sum().backward()
            out[d.device.type] = (y.detach().cpu(), leaf.grad.cpu())
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=0,
                                   rtol=0)
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], **F32_TOL)
        errs[f"max ties grad card-cpu F={F}"] = max_err(out["cuda"][1],
                                                        out["cpu"][1])
    log("mean_max", f"aggregate_mean through the hand kernels at F = "
        f"{MEAN_MAX_WIDTHS} under {MEAN_PLANS} against the edge-list mean, "
        f"aggregate_max (values exact) and its gradient against the edge-"
        f"list max, and on tied integer features against the CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; launches {launches}")
    return dict(launches=launches, errs=errs)


def check_empty_bucket(torch, n_pad: int, B: int, counts: dict) -> None:
    """Each inter kernel over the payloads of a bucket with no edge (every
    block row without a real block: the smallest graphs can give one):
    zeros, y_in through the accumulating forms, and zero gradients through
    the fused kernels' backward; each kernel must have launched."""
    import numpy as np
    from repro_torch.core import adaptgear
    from repro_torch.core import decompose as dec_mod
    from repro_torch.kernels.registry import OFFDIAG, REGISTRY
    none = np.zeros(0, np.int32)
    sub = dec_mod.build_subgraph("empty", OFFDIAG, n_pad, B, none, none,
                                 np.zeros(0, np.float32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((n_pad, 16), generator=gen, device="cuda")
    y_in = torch.randn((n_pad, 16), generator=gen, device="cuda")
    for c in counts.values():
        c.reset()
    for name in ("bell", "tcgnn_tile"):
        spec = REGISTRY.get(name)
        if bool(adaptgear.aggregate_sub(sub, x, name).any()):
            raise RuntimeError(f"{name} over an empty bucket is not zero")
        got = spec.matvec_acc(sub.formats[spec.payload_key], x, y_in)
        if not torch.equal(got, y_in):
            raise RuntimeError(f"{name} over an empty bucket changed y_in")
    for name in ("bell_fused", "tcgnn_tile_fused"):
        xi = torch.randn((n_pad, 32), generator=gen,
                         device="cuda").requires_grad_()
        w = torch.randn((32, 16), generator=gen,
                        device="cuda").requires_grad_()
        y = adaptgear.aggregate_sub_fused(sub, xi, w, name)
        (y * y_in).sum().backward()
        if bool(y.any()) or bool(xi.grad.any()) or bool(w.grad.any()):
            raise RuntimeError(f"{name} over an empty bucket: nonzero output "
                               "or gradient")
    torch.cuda.synchronize()
    ran = {k: c.value for k, c in counts.items() if c.value}
    for k in ("bell_spmm", "tcgnn_spmm", "bell_spmm_fused",
              "tcgnn_spmm_fused", "bell_spmm_dw", "tcgnn_spmm_dw"):
        if not ran.get(k):
            raise RuntimeError(f"{k} did not launch over the empty bucket")
    log("autotune", f"an empty bucket (n_pad {n_pad}, B {B}; payloads "
        f"{sorted(sub.formats)}): bell and tcgnn_tile give zeros and y_in, "
        f"the fused kernels zeros and zero dX, dW; launches {ran}")


def phase_autotune(torch, graph, counts: dict, params, k1_results) -> dict:
    """Bucket autotuning on the card: prepare(GNNConfig(inter_buckets=0))
    prices k in {1, 2, 4} under H100_HW and commits the cheapest (printed);
    an empty bucket's payloads through every inter kernel
    (:func:`check_empty_bucket`); then GCN on a fixed AUTOTUNE_K-bucket
    decomposition under each of AUTOTUNE_PLANS: the logits of ``params``
    against the edge-list GCN (float32 1e-4), TRAIN_STEPS steps of
    gnn.train with the launch counts set to 0 just before and read just
    after, equal to plan_launches (one inter kernel per bucket where k = 1
    has one), and each curve against the same plan's at k = 1
    (``k1_results``, atol 5e-3, rtol 1e-2)."""
    import dataclasses
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    from repro_torch.core import selector as sel_mod
    cfg0 = gnn.GNNConfig(inter_buckets=0, selector="fixed")
    t0 = time.perf_counter()
    dec0 = gnn.prepare(graph, cfg0, device="cuda")
    torch.cuda.synchronize()
    t_tune = time.perf_counter() - t0
    if sel_mod.default_hw(dec0.device) != sel_mod.H100_HW:
        raise RuntimeError("the card does not price with H100_HW")
    totals = dec0.stats["bucket_autotune"]
    k_best = min(totals, key=totals.get)
    if dec0.stats["inter_buckets"] != len(dec0.subgraphs) - 1:
        raise RuntimeError(f"autotune stats {dec0.stats}")
    log("autotune", f"prepare(GNNConfig(inter_buckets=0)) on the card in "
        f"{t_tune:.2f} s: modelled totals under H100_HW "
        + ", ".join(f"k = {k}: {v:.4g} s" for k, v in totals.items())
        + f"; committed k = {k_best} ({len(dec0.subgraphs) - 1} inter tiers)")
    check_empty_bucket(torch, dec0.n_pad, dec0.block_size, counts)

    cfg = dataclasses.replace(cfg0, inter_buckets=AUTOTUNE_K)
    dec = gnn.prepare(graph, cfg, device="cuda")
    nnz = [s.stats["nnz"] for s in dec.subgraphs]
    if len(nnz) != 1 + AUTOTUNE_K or min(nnz) == 0:
        raise RuntimeError(f"k = {AUTOTUNE_K}: tiers {nnz}")
    feats = torch.from_numpy(graph.features)
    x = adaptgear.to_reordered(dec, feats.cuda())
    p_dev = [{k: v.cuda() for k, v in p.items()} for p in params]
    edge_ref = edge_list_gcn(torch, graph, params)
    results, used, per_step = {}, {}, {}
    plans = {}
    for name, k1 in AUTOTUNE_PLANS.items():
        pair = PLANS[k1]
        c = dataclasses.replace(cfg, fixed_kernels=pair)
        plan, _ = gnn.select_plan(dec, c, [(feats.shape[1], c.hidden),
                                           (c.hidden, graph.n_classes)])
        plans[name] = plan
        with torch.no_grad():
            y = gnn.forward(p_dev, c, dec, x, plan)
        y_orig = adaptgear.from_reordered(dec, y).cpu()
        torch.testing.assert_close(y_orig, edge_ref, **F32_TOL)
        for cnt in counts.values():
            cnt.reset()
        results[name] = gnn.train(graph, c, steps=TRAIN_STEPS, device="cuda",
                                  params=params)
        torch.cuda.synchronize()
        used[name] = {k: cnt.value for k, cnt in counts.items()}
        want = plan_launches(results[name].plan.layers, TRAIN_STEPS)
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want}")
        one, none = (plan_launches(plan.layers, n) for n in (1, 0))
        per_step[name] = {k: one[k] - none[k] for k in one
                          if one[k] - none[k]}
        k1_one, k1_none = (plan_launches((pair, pair), n) for n in (1, 0))
        inter = SPEC_KERNELS[pair[1]][0]
        if per_step[name][inter] != AUTOTUNE_K * (k1_one[inter]
                                                  - k1_none[inter]):
            raise RuntimeError(f"{name}: {inter} {per_step[name][inter]} a "
                               f"step, not {AUTOTUNE_K} x k = 1's")
        losses = np.asarray(results[name].losses)
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: losses {losses.tolist()}")
        np.testing.assert_allclose(losses, k1_results[k1].losses,
                                   **CURVE_TOL)
        log("autotune", f"{name} {pair} on {AUTOTUNE_K} inter buckets (nnz "
            f"{nnz}): logits max|card - edge-list GCN| "
            f"{max_err(y_orig, edge_ref):.3g}; {TRAIN_STEPS} steps, launches "
            f"{ {k: v for k, v in used[name].items() if v} } = plan_launches,"
            f" per step {per_step[name]}; losses {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}, step {results[name].step_seconds * 1e3:.3f} "
            f"ms (host clock); max|k = {AUTOTUNE_K} - k = 1| "
            f"{np.abs(losses - k1_results[k1].losses).max():.3g}")
    launches = {k: sum(u[k] for u in used.values()) for k in counts}
    return dict(totals=totals, k_best=k_best, dec=dec, x=x, plans=plans,
                results=results, launches=launches, per_step=per_step,
                nnz=nnz)


# ---------------------------------------------------------------------------
# [minibatch]: mini-batch training (cluster and neighbor samplers, the
# PlanCache, budget-capped payloads)
# ---------------------------------------------------------------------------

def mb_cfg(**changes):
    """A mini-batch GNNConfig on pubmed: GCN, 2 layers of hidden 16, bfs,
    16-node clusters, one inter tier, the feedback selector (the
    reference's default, which the mini-batch path resolves to cached
    cost-model selection under H100_HW), with ``changes``."""
    from repro_torch.core import gnn
    base = dict(model="gcn", hidden=16, n_layers=2, comm_size=16,
                reorder="bfs", inter_buckets=1, sampler="cluster",
                clusters_per_batch=MB_CLUSTERS[0], selector="feedback",
                seed=0)
    base.update(changes)
    return gnn.GNNConfig(**base)


def mb_launches(res, model: str, probe_events=(), probe_iters: int = 2
                ) -> tuple[dict, dict]:
    """The CUDA-kernel launches a mini-batch run implies, and those of its
    first batch's step: each training batch's step and each eval batch's
    forward under its committed plan (plan_launches), plus, for a run that
    probed, each timed candidate's 1 + ``probe_iters`` forward calls
    (``probe_events``, the selector audit's). A spill launches nothing."""
    out = {k: 0 for k in KERNELS}

    def add(layers, steps, fwd):
        one, none = (plan_launches(layers, n, model) for n in (1, 0))
        for k in out:
            out[k] += steps * (one[k] - none[k]) + fwd * none[k]
        return {k: one[k] - none[k] for k in out if one[k] - none[k]}

    first = None
    for layers in res.plan_history:
        step = add(layers, 1, 0)
        if first is None:
            first = step
    for layers in res.eval_plans:
        add(layers, 0, 1)
    for e in probe_events:
        kernels = SPEC_KERNELS.get(e["kernel"], ())
        if kernels:
            out[kernels[0]] += 1 + probe_iters
    return out, first


def mb_step_closure(torch, graph, cfg, res, staged: bool = False):
    """One training step of the run's first batch under its committed plan
    (fresh sampler of the same seed, the run's final params), for the
    profiler: ``fn()`` runs the step; the step's launches are the plan's.
    ``staged`` copies the batch as the pipeline's workers do (pinned host
    buffers, a stream of the stager's own, handed over to the consumer's
    stream)."""
    from repro_torch.core import gnn
    from repro_torch.core.plan import KernelPlan
    from repro_torch.sampling import plan_payload_keys
    from repro_torch.train import gnn_steps
    sampler = gnn_steps.make_sampler(graph, cfg)
    batch = sampler.sample()
    skel, inv = gnn_steps.prepare_skeleton(batch, cfg)
    eps = gnn.layer_epilogues(cfg, graph.features.shape[1], graph.n_classes)
    plan = KernelPlan(tuple(t.name for t in skel.tiers),
                      res.plan_history[0], eps)
    dec = skel.materialize(plan_payload_keys(plan), device=None)
    pad = sampler.edge_budget + (sampler.node_budget
                                 if cfg.model == "gcn" else 0)
    dev = torch.device("cuda")
    if staged:
        args, ready, tensors = gnn_steps._Stager(dev).stage(
            lambda copy: gnn_steps.step_args(batch, dec, inv, plan, pad, dev,
                                             copy=copy))
        gnn_steps._Stager.hand_over(ready, tensors)
    else:
        args = gnn_steps.step_args(batch, dec, inv, plan, pad, dev)
    step = gnn_steps.make_sampled_step(cfg, plan, dict(traces=0))
    params = res.params
    opt = gnn._adam_init(params)
    return lambda: step(params, opt, *args)


def check_mb_payloads(torch, label: str, dec, errs: dict,
                      tiers=None) -> int:
    """Each kernel over one mini-batch decomposition's payloads on the card
    (``dec``: every MB_KERNELS payload, unpadded) against its plain
    version, as phase_kernels_train holds them: float32 and bfloat16, y_in
    off and on, at WIDTHS (dW within DW_REL_TOL of max|dW|).  The diagonal
    tier: block_diag_spmm (both reads), block_diag_spmm_fused (both reads),
    block_diag_spmm_dual, bell_spmm_dw over its blocks.  Each capped inter
    tier: bell_spmm over bell and bell_t (n_valid < K on padded rows),
    bell_spmm_fused over bell and bell_t (the dX pass), bell_spmm_dw over
    bell_t; tcgnn_spmm over tc and tc_t, tcgnn_spmm_fused over both,
    tcgnn_spmm_dw over tc_t.  Then the registry's capped dispatch
    (kernels plus the spill's torch ops) for bell, bell_fused, tcgnn_tile
    and tcgnn_tile_fused, plain and accumulating, against the same on the
    CPU in float32 (the payloads' dtype; the backward's bf16 kernel calls
    are the ones above): values and the gradients of x, w and y_in.
    Returns the cases."""
    from repro_torch.core import formats
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    from repro_torch.kernels import tcgnn_tile as tc_mod
    from repro_torch.kernels.registry import REGISTRY
    gen = torch.Generator(device="cuda").manual_seed(23)
    n_cases = 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def check(name, got, want, dtype):
        nonlocal n_cases
        torch.cuda.synchronize()
        key = str(dtype).removeprefix("torch.")
        if name.endswith("_dw") and not bool(want.any()):
            if bool(got.any()):                # an empty tier's dW is 0
                raise RuntimeError(f"{label} {name} {key}: dW of an empty "
                                   "tier is not zero")
        elif name.endswith("_dw"):
            rel = dw_rel_err(got, want, f"{label} {name} {key}")
            errs[name][f"{key}_rel"] = max(errs[name].get(f"{key}_rel", 0.0),
                                           rel)
        else:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[name][key] = max(errs[name][key], max_err(got, want))
        n_cases += 1

    subs = dec.subgraphs if tiers is None else tiers
    for dtype in (torch.float32, torch.bfloat16):
        for Fi, Fo in WIDTHS:
            w = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
            for sub in subs:
                n = sub.n_rows
                x = randn(n, Fi).to(dtype)
                g = randn(n, Fo).to(dtype)
                ys = [None, randn(n, Fo).to(dtype)]
                yx = [None, randn(n, Fi).to(dtype)]
                if "block_diag" in sub.formats:
                    blk = sub.formats["block_diag"].blocks.to(dtype)
                    check("bell_spmm_dw",
                          bellf_mod.bell_spmm_dw(blk.unsqueeze(1), None, x,
                                                 g, transpose=True),
                          bellf_mod.plain_dw(blk.unsqueeze(1), None, x, g,
                                             transpose=True), dtype)
                    ws = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
                    for y, y1 in zip(ys, yx):
                        for t in (False, True):
                            check("block_diag_spmm",
                                  bd_mod.block_diag_spmm(blk, x, y1,
                                                         transpose=t),
                                  bd_mod.plain(blk, x, y1, transpose=t),
                                  dtype)
                            check("block_diag_spmm_fused",
                                  bdf_mod.block_diag_spmm_fused(
                                      blk, x, w, y, transpose=t),
                                  bdf_mod.plain(blk, x, w, y, transpose=t),
                                  dtype)
                        check("block_diag_spmm_dual",
                              bdf_mod.block_diag_spmm_dual(blk, x, w, ws, y),
                              bdf_mod.plain_dual(blk, x, w, ws, y), dtype)
                    continue
                bell, bell_t, _ = sub.formats["bell"]
                tc, tc_t, _ = sub.formats["tcgnn_tile"]
                for p in (bell, bell_t):
                    blk = p.blocks.to(dtype)
                    for y, y1 in zip(ys, yx):
                        check("bell_spmm",
                              bell_mod.bell_spmm(blk, p.col_idx, x, y1,
                                                 n_valid=p.n_valid),
                              bell_mod.plain(blk, p.col_idx, x, y1), dtype)
                        check("bell_spmm_fused",
                              bellf_mod.bell_spmm_fused(blk, p.col_idx, x, w,
                                                        y, n_valid=p.n_valid),
                              bellf_mod.plain(blk, p.col_idx, x, w, y), dtype)
                check("bell_spmm_dw",
                      bellf_mod.bell_spmm_dw(bell_t.blocks.to(dtype),
                                             bell_t.col_idx, x, g,
                                             n_valid=bell_t.n_valid),
                      bellf_mod.plain_dw(bell_t.blocks.to(dtype),
                                         bell_t.col_idx, x, g), dtype)
                for p in (tc, tc_t):
                    for y, y1 in zip(ys, yx):
                        check("tcgnn_spmm",
                              tc_mod.tcgnn_spmm(p.tiles, p.gather_idx, x, y1),
                              tc_mod.plain(p.tiles, p.gather_idx, x, y1),
                              dtype)
                        check("tcgnn_spmm_fused",
                              tc_mod.tcgnn_spmm_fused(p.tiles, p.gather_idx,
                                                      x, w, y),
                              tc_mod.plain_fused(p.tiles, p.gather_idx, x, w,
                                                 y), dtype)
                check("tcgnn_spmm_dw",
                      tc_mod.tcgnn_spmm_dw(tc_t.tiles, tc_t.gather_idx, x, g),
                      tc_mod.plain_dw(tc_t.tiles, tc_t.gather_idx, x, g),
                      dtype)

    # the capped dispatch with its spill, values and gradients, card vs CPU
    worst = 0.0
    for sub in subs:
        if "bell" not in sub.formats:
            continue
        n = sub.n_rows
        cpu = {k: formats.to_device(sub.formats[k], torch.device("cpu"))
               for k in ("bell", "tcgnn_tile")}
        for dtype in (torch.float32,):     # the payloads are float32
            tol = F32_TOL
            x0, w0 = randn(n, 16).to(dtype), (randn(16, 3) / 4).to(dtype)
            y0, cot = randn(n, 3).to(dtype), randn(n, 3)
            for key in ("bell", "tcgnn_tile"):
                spec, fspec = REGISTRY.get(key), REGISTRY.get(key + "_fused")
                forms = {
                    "matvec": lambda p, x, w, y: spec.matvec(p, x @ w),
                    "matvec_acc": lambda p, x, w, y: spec.matvec_acc(
                        p, x @ w, y),
                    "fused": lambda p, x, w, y: fspec.fused_matvec(p, x, w),
                    "fused_acc": lambda p, x, w, y: fspec.fused_matvec_acc(
                        p, x, w, y)}
                for form, fn in forms.items():
                    outs = []
                    for p, dev in ((sub.formats[key], "cuda"),
                                   (cpu[key], "cpu")):
                        leaves = [t.detach().to(dev).requires_grad_()
                                  for t in (x0, w0, y0)]
                        y = fn(p, *leaves)
                        (y.float() * cot.to(dev)).sum().backward()
                        outs.append([y.detach().cpu()] + [
                            (t.grad if t.grad is not None
                             else torch.zeros_like(t)).cpu()
                            for t in leaves])
                    for a, b in zip(*outs):
                        torch.testing.assert_close(a.float(), b.float(),
                                                   **tol)
                        if dtype == torch.float32:
                            worst = max(worst, max_err(a, b))
                    n_cases += 1
    log("minibatch", f"{label}: {n_cases} kernel cases within tolerance "
        f"(capped dispatch card vs CPU, float32 max|err| {worst:.3g})")
    return n_cases


def phase_minibatch(torch, graph, counts: dict, errs: dict) -> dict:
    """[minibatch]: gnn.train(graph, GNNConfig(sampler=...)) on the card for
    each of MB_RUNS (MB_STEPS steps each), the launch counts set to 0 just
    before and read just after each run and held equal to what its
    committed plans imply (:func:`mb_launches`; a spill adds none), and
    n_traces == len(plans) (the adaptive-K run: one more per slack step
    that changed a cap).  Before the runs, each kernel over the
    budget-capped payloads the runs meet (:func:`check_mb_payloads`): the
    first batch of the 16- and 256-cluster GCN runs and of the neighbor
    run, SAGE's diagonal blocks at 256 clusters, and an inter tier with no
    edge under an edge budget.  The MB_FIXED plans at 256 clusters
    (between them every GNN kernel) from one parameter set on the card and
    on the CPU: the same batch stream (plans, hits), cache counters and
    losses within CURVE_TOL.  Telemetry
    on against off (the 16-cluster GCN run twice, deterministic
    algorithms on for both): equal losses, plans and hit history.  Per
    run it prints step ms and each prepare stage's ms (host clock), the
    device-busy us of its first batch's step (profile_busy, kernel events
    checked), the hit rate, the capped tiers' spill fractions and the
    committed plans."""
    import numpy as np
    from repro_torch.core import decompose as dec_mod
    from repro_torch.core import gnn
    from repro_torch.kernels.registry import OFFDIAG
    from repro_torch.sampling import MB_KERNELS
    from repro_torch.train import gnn_steps
    t_phase = time.perf_counter()
    in_dim, n_classes = graph.features.shape[1], graph.n_classes

    # the kernels over the payloads the runs meet
    n_cases = 0
    for label, cfg in (("gcn c16", mb_cfg()),
                       ("gcn c256", mb_cfg(clusters_per_batch=MB_CLUSTERS[1])),
                       ("gcn neighbor", mb_cfg(sampler="neighbor"))):
        sampler = gnn_steps.make_sampler(graph, cfg)
        dec, _ = gnn_steps.prepare_batch(sampler.sample(), cfg, MB_KERNELS,
                                         device="cuda")
        shapes = {s.name: (tuple(s.formats["bell"][0].blocks.shape),
                           int(s.formats["bell"][0].n_valid.sum()),
                           tuple(s.formats["tcgnn_tile"][0].tiles.shape),
                           s.formats["bell"][2].nnz,
                           s.formats["tcgnn_tile"][2].nnz, s.stats["nnz"])
                  for s in dec.subgraphs[1:]}
        log("minibatch", f"{label} batch 0: n_pad {dec.n_pad}, budget "
            f"{sampler.edge_budget} (+ self-loops), inter (bell blocks, real "
            f"blocks, tcgnn tiles, bell spill, tcgnn spill, nnz) {shapes}")
        n_cases += check_mb_payloads(torch, label, dec, errs)
    scfg = mb_cfg(model="sage", clusters_per_batch=MB_CLUSTERS[1])
    sdec, _ = gnn_steps.prepare_batch(
        gnn_steps.make_sampler(graph, scfg).sample(), scfg, ("block_diag",),
        device="cuda")
    n_cases += check_mb_payloads(torch, "sage c256 diagonal", sdec, errs,
                                 tiers=sdec.subgraphs[:1])
    none = np.zeros(0, np.int32)
    empty = dec_mod.build_subgraph("empty", OFFDIAG, 256, 16, none, none,
                                   np.zeros(0, np.float32), edge_budget=4860,
                                   device="cuda")
    for key in ("bell", "tcgnn_tile"):
        if empty.formats[key][0].budgeted is not True:
            raise RuntimeError(f"empty bucket {key} is not budget-capped")
    n_cases += check_mb_payloads(torch, "empty pinned bucket", None, errs,
                                 tiers=(empty,))

    # the runs
    runs, used, per_step, info = {}, {}, {}, {}
    for name, changes in MB_RUNS.items():
        cfg = mb_cfg(**changes)
        for cnt in counts.values():
            cnt.reset()
        t0 = time.perf_counter()
        res = gnn.train(graph, cfg, steps=MB_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used[name] = {k: cnt.value for k, cnt in counts.items()}
        probes = ([e for e in res.plan_cache.tele.audit.events()
                   if e["event"] == "probe"] if cfg.probe_every else ())
        want, per_step[name] = mb_launches(res, cfg.model, probes,
                                           res.plan_cache.probe_iters)
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want}")
        losses = np.asarray(res.losses)
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{name}: losses {losses.tolist()}")
        caps = res.cache.get("slack_changes", 0)
        if not (res.n_traces == len(res.plans) or (
                cfg.adapt_budget_k
                and len(res.plans) <= res.n_traces <= len(res.plans) * (
                    1 + caps))):
            raise RuntimeError(f"{name}: n_traces {res.n_traces}, plans "
                               f"{len(res.plans)}, slack steps {caps}")
        runs[name] = res
        spill = {k: round(s / max(e, 1), 6) for k, (s, e) in
                 res.spill.items()}
        busy = profile_busy(torch, mb_step_closure(torch, graph, cfg, res),
                            5, res.step_seconds * 1e3, f"{name} step",
                            expect=device_events(per_step[name]))
        info[name] = dict(step_ms=res.step_seconds * 1e3,
                          iter_ms=res.iter_seconds * 1e3,
                          stage_ms={k: v * 1e3
                                    for k, v in res.stage_seconds.items()},
                          busy_us=busy and busy["busy_us"],
                          hit_rate=res.hit_rate(), spill=spill,
                          plans=res.plans, n_traces=res.n_traces,
                          cache=res.cache, wall_s=wall,
                          probes=len(probes))
        log("minibatch", f"{name} {changes}: {MB_STEPS} steps in {wall:.2f} "
            f"s; step {info[name]['step_ms']:.3f} ms, iteration "
            f"{info[name]['iter_ms']:.3f} ms (host clock); prepare ms "
            + ", ".join(f"{k} {v:.3f}"
                        for k, v in info[name]["stage_ms"].items())
            + f"; device busy {info[name]['busy_us']} us a step; hit rate "
            f"{res.hit_rate():.3f} (cache {res.cache}); spill fraction "
            f"{spill}; plans {res.plans}; n_traces {res.n_traces}; launches "
            f"{ {k: v for k, v in used[name].items() if v} } as the plans "
            f"imply (probe events {len(probes)}); per first step "
            f"{per_step[name]}; losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"accuracy {res.accuracy:.4f}; skeleton cache "
            f"{res.skeleton_hits}/{res.skeleton_misses}")

    # fixed plans, card against CPU from one parameter set per model
    params = {m: gnn.init_model(torch.Generator().manual_seed(0),
                                mb_cfg(model=m), in_dim, n_classes,
                                device="cpu") for m in ("gcn", "sage")}
    fixed = {}
    for name, (model, pair) in MB_FIXED.items():
        cfg = mb_cfg(model=model, clusters_per_batch=MB_CLUSTERS[1],
                     selector="fixed", fixed_kernels=pair)
        for cnt in counts.values():
            cnt.reset()
        card = gnn.train(graph, cfg, steps=MB_STEPS, device="cuda",
                         params=params[model])
        torch.cuda.synchronize()
        used[name] = {k: cnt.value for k, cnt in counts.items()}
        want, per_step[name] = mb_launches(card, cfg.model)
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want}")
        t0 = time.perf_counter()
        cpu = gnn.train(graph, cfg, steps=MB_STEPS, device="cpu",
                        params=params[model])
        t_cpu = time.perf_counter() - t0
        if (card.plan_history, card.hit_history, card.cache) != (
                cpu.plan_history, cpu.hit_history, cpu.cache):
            raise RuntimeError(f"{name}: the card's batch stream or cache "
                               "differs from the CPU's")
        if card.n_traces != len(card.plans):
            raise RuntimeError(f"{name}: n_traces {card.n_traces}")
        np.testing.assert_allclose(card.losses, cpu.losses, **CURVE_TOL)
        diff = float(np.abs(np.asarray(card.losses)
                            - np.asarray(cpu.losses)).max())
        fixed[name] = dict(max_loss_diff=diff, step_ms=card.step_seconds * 1e3,
                           spill={k: round(s / max(e, 1), 6)
                                  for k, (s, e) in card.spill.items()})
        runs[name] = card
        busy = profile_busy(torch, mb_step_closure(torch, graph, cfg, card),
                            5, card.step_seconds * 1e3, f"{name} step",
                            expect=device_events(per_step[name]))
        fixed[name]["busy_us"] = busy and busy["busy_us"]
        log("minibatch", f"{name} {model} {pair} at {MB_CLUSTERS[1]} "
            f"clusters: card "
            f"vs CPU ({t_cpu:.2f} s on the CPU): same plans, hits and cache "
            f"{card.cache}; max|loss diff| {diff:.3g} over {MB_STEPS} steps; "
            f"launches {used[name]} as the plan implies; step "
            f"{fixed[name]['step_ms']:.3f} ms (host clock), device busy "
            f"{fixed[name]['busy_us']} us a step; spill fraction "
            f"{fixed[name]['spill']}")

    # telemetry on against off, deterministic algorithms on for both
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tele = {on: gnn.train(graph, mb_cfg(telemetry=on), steps=MB_STEPS,
                              device="cuda") for on in (False, True)}
    finally:
        torch.use_deterministic_algorithms(False)
    off, on = tele[False], tele[True]
    if (on.losses, on.plans, on.hit_history, on.cache, on.n_traces) != (
            off.losses, off.plans, off.hit_history, off.cache, off.n_traces):
        raise RuntimeError("telemetry changed the run: losses "
                           f"{off.losses} / {on.losses}")
    log("minibatch", f"telemetry on vs off: identical losses, plans, hits, "
        f"cache and n_traces; {on.telemetry['n_span_events']} spans, "
        f"{on.telemetry['n_audit_events']} audit events")
    launches = {k: sum(u[k] for u in used.values()) for k in counts}
    log("minibatch", f"{n_cases} payload kernel cases; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(runs=runs, info=info, fixed=fixed, launches=launches,
                used=used, per_step=per_step, n_cases=n_cases)


class PipelineCrash(RuntimeError):
    """The [pipeline] phase's deliberate crash of a training run."""


def same_runs(a, b, what: str, exact: bool) -> None:
    """Raise unless two mini-batch runs have the same batch stream: plans
    (per batch and per eval batch), hits, cache counters and n_traces, and
    their losses bit for bit (``exact``) or within CURVE_TOL."""
    import numpy as np
    for k in ("plan_history", "eval_plans", "hit_history", "plans", "cache",
              "n_traces"):
        if getattr(a, k) != getattr(b, k):
            raise RuntimeError(f"{what}: {k} differ: {getattr(a, k)} / "
                               f"{getattr(b, k)}")
    if exact and a.losses != b.losses:
        raise RuntimeError(f"{what}: losses differ: {a.losses} / {b.losses}")
    np.testing.assert_allclose(a.losses, b.losses, **CURVE_TOL)


def phase_pipeline(torch, graph, counts: dict, mb: dict) -> dict:
    """[pipeline]: gnn.train(graph, GNNConfig(sampler=..., prefetch_depth=3,
    pipeline_workers=2)) for each of PIPE_RUNS (MB_STEPS steps; GCN, GIN
    and SAGE at MB_CLUSTERS[1] clusters and GCN on the neighbor sampler,
    feedback), the launch counts set to 0 just before and read just after
    each run: each async run against the [minibatch] run of its name (the
    same batch stream, cache counters, n_traces and launches, losses within
    CURVE_TOL), then both again under deterministic algorithms (losses bit
    for bit, the same launches).  Checkpoint/resume: the GCN run at
    MB_CLUSTERS[1] clusters with a checkpoint every PIPE_CKPT_EVERY batches,
    crashed by its sampler's build of batch PIPE_CRASH_AT, sync and async,
    then resumed from its directory, deterministic throughout: the
    uninterrupted run's losses, plans, hits and cache counters exactly,
    resumed_at == PIPE_CRASH_AT, and no pipeline-* or ckpt-writer thread
    alive after the crash.  One async run probes every 2nd miss on the
    workers (launches held to its plans and probes).  Prints per model the
    sync and async step and iteration ms (host clock), the pipeline's
    efficiency_pct, waits and ready mean, the device-busy us of one step
    over a staged batch, and the checkpoint write seconds."""
    import dataclasses
    import tempfile
    from repro_torch.core import gnn
    from repro_torch.train import gnn_steps
    t_phase = time.perf_counter()
    used, per_step, info, wall = {}, {}, {}, {}

    def run(name, cfg, det: bool = False):
        for cnt in counts.values():
            cnt.reset()
        if det:
            torch.use_deterministic_algorithms(True, warn_only=True)
        t0 = time.perf_counter()
        try:
            res = gnn.train(graph, cfg, steps=MB_STEPS, device="cuda")
            torch.cuda.synchronize()
        finally:
            wall[name] = time.perf_counter() - t0
            torch.use_deterministic_algorithms(False)
            used[name] = {k: cnt.value for k, cnt in counts.items()}
        return res

    det_ref = det_pair = None
    for name in PIPE_RUNS:
        changes = MB_RUNS[name]
        cfg = mb_cfg(**changes, **PIPE_ASYNC)
        sync = mb["runs"][name]
        asyn = run(f"{name}_async", cfg)
        want, per_step[f"{name}_async"] = mb_launches(asyn, cfg.model)
        if used[f"{name}_async"] != want or want != mb["used"][name]:
            raise RuntimeError(f"{name} async: launches "
                               f"{used[f'{name}_async']}, its plans imply "
                               f"{want}, the sync run's {mb['used'][name]}")
        same_runs(asyn, sync, f"{name} async vs sync", exact=False)
        dsync = run(f"{name}_det_sync", mb_cfg(**changes), det=True)
        dasyn = run(f"{name}_det_async", cfg, det=True)
        same_runs(dasyn, dsync, f"{name} async vs sync, deterministic",
                  exact=True)
        if used[f"{name}_det_async"] != used[f"{name}_det_sync"]:
            raise RuntimeError(f"{name}: deterministic launches differ: "
                               f"{used[f'{name}_det_async']} / "
                               f"{used[f'{name}_det_sync']}")
        if name == "mb_gcn_c256":
            det_ref = dsync
        if name == FAULT_RUN:
            det_pair = dict(sync=dsync, async_=dasyn)
        p = asyn.pipeline
        busy = profile_busy(
            torch, mb_step_closure(torch, graph, cfg, asyn, staged=True), 5,
            asyn.step_seconds * 1e3, f"{name} async step",
            expect=device_events(per_step[f"{name}_async"]))
        info[name] = dict(
            sync_step_ms=sync.step_seconds * 1e3,
            sync_iter_ms=sync.iter_seconds * 1e3,
            sync_step_share_pct=100 * sync.step_seconds
            / max(sync.iter_seconds, 1e-12),
            async_step_ms=asyn.step_seconds * 1e3,
            async_iter_ms=asyn.iter_seconds * 1e3,
            efficiency_pct=p["efficiency_pct"],
            wait_full_s=p["wait_full_s"], wait_empty_s=p["wait_empty_s"],
            ready_mean=p["ready_mean"], loop_s=p["loop_seconds"],
            async_stage_ms={k: round(v * 1e3, 3)
                            for k, v in asyn.stage_seconds.items()},
            busy_us=busy and busy["busy_us"],
            max_loss_diff=float(max(abs(a - b) for a, b in
                                    zip(asyn.losses, sync.losses))))
        i = info[name]
        log("pipeline", f"{name} {changes} {PIPE_ASYNC}: the sync run's "
            f"batches, plans, hits, cache, n_traces ({asyn.n_traces}) and "
            f"launches; max|loss diff| {i['max_loss_diff']:.3g}, "
            f"deterministic bit for bit; sync step {i['sync_step_ms']:.3f} "
            f"ms, iteration {i['sync_iter_ms']:.3f} ms (step "
            f"{i['sync_step_share_pct']:.1f} %); async step "
            f"{i['async_step_ms']:.3f} ms, iteration {i['async_iter_ms']:.3f}"
            f" ms, efficiency_pct {p['efficiency_pct']:.1f}, wait_full_s "
            f"{p['wait_full_s']:.4f}, wait_empty_s {p['wait_empty_s']:.4f}, "
            f"ready_mean {p['ready_mean']:.2f}, loop {p['loop_seconds']:.3f}"
            f" s (host clock); stage ms on the workers "
            f"{i['async_stage_ms']}; device busy {i['busy_us']} us a step "
            f"over a staged batch")

    # what bounds the overlap: the interpreter lock's contention
    for name in PIPE_PROBE_RUNS:
        for probe, extra in PIPE_PROBES.items():
            cfg = mb_cfg(**MB_RUNS[name], **dict(PIPE_ASYNC, **extra))
            old_switch = sys.getswitchinterval()
            if probe.startswith("switch"):
                sys.setswitchinterval(PIPE_SWITCH_S)
            try:
                res = run(f"{name}_{probe}", cfg)
            finally:
                sys.setswitchinterval(old_switch)
            if used[f"{name}_{probe}"] != mb["used"][name]:
                raise RuntimeError(f"{name} {probe}: launches differ")
            same_runs(res, mb["runs"][name], f"{name} {probe}", exact=False)
            info[name][probe] = dict(
                step_ms=res.step_seconds * 1e3,
                iter_ms=res.iter_seconds * 1e3,
                efficiency_pct=res.pipeline["efficiency_pct"],
                stage_ms={k: round(v * 1e3, 3)
                          for k, v in res.stage_seconds.items()})
            log("pipeline", f"{name} async, {probe} {extra or PIPE_SWITCH_S}:"
                f" the sync run's batch stream; step "
                f"{res.step_seconds * 1e3:.3f} ms, iteration "
                f"{res.iter_seconds * 1e3:.3f} ms, efficiency_pct "
                f"{res.pipeline['efficiency_pct']:.1f}, stage ms on the "
                f"workers {info[name][probe]['stage_ms']}")

    # crash at batch PIPE_CRASH_AT, then resume from the checkpoints
    real_make = gnn_steps.make_sampler

    def crashing_sampler(graph_, cfg_):
        sampler = real_make(graph_, cfg_)
        build = sampler.build

        def crash_build(ticket):
            if ticket.index == PIPE_CRASH_AT:
                raise PipelineCrash(f"crash at batch {PIPE_CRASH_AT}")
            return build(ticket)

        sampler.build = crash_build
        return sampler

    resume = {}
    for side, extra in (("sync", {}), ("async", PIPE_ASYNC)):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            cfg = mb_cfg(**MB_RUNS["mb_gcn_c256"], **extra, checkpoint_dir=d,
                         checkpoint_every=PIPE_CKPT_EVERY)
            gnn_steps.make_sampler = crashing_sampler
            try:
                run(f"crash_{side}", cfg, det=True)
            except PipelineCrash:
                pass
            else:
                raise RuntimeError(f"{side}: the crash hook did not fire")
            finally:
                gnn_steps.make_sampler = real_make
            alive = worker_threads()
            if alive:
                raise RuntimeError(f"{side}: threads alive after the crash: "
                                   f"{alive}")
            res = run(f"resumed_{side}",
                      dataclasses.replace(cfg, resume_from=d), det=True)
        # the last checkpoint the crashed run committed
        if res.faults["resumed_at"] != (PIPE_CRASH_AT // PIPE_CKPT_EVERY
                                        * PIPE_CKPT_EVERY):
            raise RuntimeError(f"{side}: resumed at "
                               f"{res.faults['resumed_at']}")
        for k in ("losses", "plan_history", "hit_history", "plans", "cache",
                  "eval_plans"):
            if getattr(res, k) != getattr(det_ref, k):
                raise RuntimeError(f"resumed {side} run: {k} differ from the "
                                   f"uninterrupted run's")
        write = res.telemetry["metrics"]["checkpoint.write_s"]
        resume[side] = dict(checkpoints=res.faults["checkpoints"],
                            write_s=write)
        log("pipeline", f"crash at batch {PIPE_CRASH_AT} ({side}, checkpoint"
            f" every {PIPE_CKPT_EVERY}), resumed at "
            f"{res.faults['resumed_at']}: the uninterrupted run's losses, "
            f"plans, hits and cache exactly; no worker thread left; "
            f"checkpoint write s {write} ({res.faults['checkpoints']} "
            f"saves after the resume)")

    # probing on the workers (the [minibatch] probing run's config, whose
    # misses probe)
    cfg = mb_cfg(**MB_RUNS["mb_gcn_probe2"], **PIPE_ASYNC)
    res = run("probe2_async", cfg)
    probes = [e for e in res.plan_cache.tele.audit.events()
              if e["event"] == "probe"]
    if not probes:
        raise RuntimeError("probe2 async: no candidate was probed")
    want, per_step["probe2_async"] = mb_launches(
        res, cfg.model, probes, res.plan_cache.probe_iters)
    if used["probe2_async"] != want:
        raise RuntimeError(f"probe2 async: launches {used['probe2_async']}, "
                           f"expected {want}")
    if res.n_traces != len(res.plans):
        raise RuntimeError(f"probe2 async: n_traces {res.n_traces}")
    info["probe2_async"] = dict(plans=res.plans, probes=len(probes),
                                cache=res.cache,
                                efficiency_pct=res.pipeline["efficiency_pct"],
                                step_ms=res.step_seconds * 1e3,
                                iter_ms=res.iter_seconds * 1e3)
    log("pipeline", f"probe every 2nd miss on the workers at "
        f"{cfg.clusters_per_batch} clusters: {len(probes)} probe events, "
        f"cache {res.cache}, plans "
        f"{res.plans}, launches as the plans and probes imply; step "
        f"{info['probe2_async']['step_ms']:.3f} ms, iteration "
        f"{info['probe2_async']['iter_ms']:.3f} ms, efficiency_pct "
        f"{res.pipeline['efficiency_pct']:.1f}")
    log("pipeline", f"phase {time.perf_counter() - t_phase:.1f} s")
    return dict(used=used, per_step=per_step, info=info, resume=resume,
                wall=wall, det=det_pair)


def worker_threads() -> list:
    """Names of the mini-batch loop's worker threads still alive."""
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("pipeline-", "ckpt-writer"))]


def phase_faults(torch, graph, counts: dict, pipe: dict) -> dict:
    """[faults]: retries and deterministic fault injection in mini-batch
    training on the card (the module docstring's 7a''''), FAULT_RUN's
    config under deterministic algorithms, each run through
    ``train_minibatch(..., fault_plan=...)`` with the launch counts set to
    0 just before and read just after it.  Raises on any failed check."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.distributed import FaultPlan, SimulatedCrash
    from repro_torch.kernels import ops
    from repro_torch.obs import Telemetry
    from repro_torch.train import gnn_steps
    t_phase = time.perf_counter()
    used, info = {}, {}

    def run(name, cfg, fp=None, expect=None):
        """One run with the tracer on; ``expect``: the exception class it
        must raise (then returned in place of the result)."""
        for cnt in counts.values():
            cnt.reset()
        tele = Telemetry(enabled=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        t0 = time.perf_counter()
        try:
            res = gnn_steps.train_minibatch(graph, cfg, steps=MB_STEPS,
                                            fault_plan=fp, telemetry=tele,
                                            device="cuda")
            torch.cuda.synchronize()
        except Exception as exc:
            if expect is None or not isinstance(exc, expect):
                raise
            res = exc
        else:
            if expect is not None:
                raise RuntimeError(f"{name}: no {expect.__name__} raised")
        finally:
            secs = time.perf_counter() - t0
            torch.use_deterministic_algorithms(False)
            used[name] = {k: cnt.value for k, cnt in counts.items()}
        m = tele.metrics
        info[name] = dict(
            ms=secs * 1e3, retries=m.counter("faults.retries").value,
            pipeline_retries=m.counter("pipeline.retries").value,
            backoff_s=sum(e[5] - e[4] for e in tele.tracer.events()
                          if e[0] == "retry.backoff"))
        return res, tele

    base = mb_cfg(**MB_RUNS[FAULT_RUN])
    for side, extra in (("sync", {}), ("async", PIPE_ASYNC)):
        ref = pipe["det"][side if side == "sync" else "async_"]
        ref_name = f"{FAULT_RUN}_det_{side}"
        ref_ms = pipe["wall"][ref_name] * 1e3

        # the same settings with no fault and the tracer on, then transient
        # worker faults absorbed by the retries
        retry_cfg = dataclasses.replace(base, **extra, **FAULT_RETRY)
        res, _ = run(f"clean_{side}", retry_cfg, FaultPlan())
        same_runs(res, ref, f"clean {side} vs fault-free", exact=True)
        name = f"retried_{side}"
        fp = FaultPlan(worker_faults=dict(FAULT_WORKER))
        res, _ = run(name, retry_cfg, fp)
        same_runs(res, ref, f"{name} vs fault-free", exact=True)
        want = sum(FAULT_WORKER.values())
        if (res.faults["retries"] != want or fp.injected_worker != want
                or (extra and res.pipeline["retries"] != want)):
            raise RuntimeError(f"{name}: retries {res.faults['retries']}, "
                               f"injected {fp.injected_worker}, want {want}")
        if used[name] != pipe["used"][ref_name]:
            raise RuntimeError(f"{name}: launches {used[name]}, the "
                               f"fault-free run's {pipe['used'][ref_name]}")
        i = info[name]
        log("faults", f"{FAULT_RUN} {side} {FAULT_RETRY}, worker faults "
            f"{FAULT_WORKER}: the fault-free run's losses bit for bit, "
            f"plans, hits, cache, n_traces and launches; {i['retries']} "
            f"retries, backoff paid {i['backoff_s'] * 1e3:.3f} ms; run "
            f"{i['ms']:.1f} ms against {info[f'clean_{side}']['ms']:.1f} ms "
            f"with no fault and the tracer on, {ref_ms:.1f} ms with "
            f"neither ([pipeline]; host clock, the whole call)")

        # a fatal fault fails fast through a retry budget of 5 x 10 s
        name = f"fatal_{side}"
        fp = FaultPlan(fatal_at={FAULT_FATAL_AT})
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            exc, _ = run(name, dataclasses.replace(
                base, **extra, retry_max=5, retry_base_delay_s=10.0,
                checkpoint_dir=d, checkpoint_every=1), fp, expect=ValueError)
            alive = worker_threads()
        i = info[name]
        if (i["ms"] > 5000.0 or fp.injected_fatal != 1 or i["retries"]
                or i["pipeline_retries"] or alive):
            raise RuntimeError(f"{name}: {i}, injected {fp.injected_fatal},"
                               f" threads alive {alive}")
        log("faults", f"{side} fatal_at={{{FAULT_FATAL_AT}}}, retry_max=5 "
            f"at 10 s: ValueError ({exc}) in {i['ms']:.1f} ms, 0 retries, "
            f"no worker thread left")

        # a non-finite batch, skipped by the guard
        if side == "sync":
            name, k = "nonfinite_sync", FAULT_NONFINITE_AT
            fp = FaultPlan(nonfinite_at={k})
            res, _ = run(name, base, fp)
            if (res.faults["nonfinite_skips"] != 1
                    or fp.injected_nonfinite != 1
                    or res.losses[:k] != ref.losses[:k]
                    or not math.isnan(res.losses[k])
                    or not all(map(math.isfinite, res.losses[k + 1:]))):
                raise RuntimeError(
                    f"{name}: skips {res.faults['nonfinite_skips']}, losses "
                    f"{res.losses} against {ref.losses}")
            log("faults", f"nonfinite_at={{{k}}}: 1 skip; losses 0-{k - 1} "
                f"the fault-free run's, loss {k} NaN, the rest finite; run "
                f"{info[name]['ms']:.1f} ms")

        # a crash after batch PIPE_CRASH_AT commits, then the resume
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            cfg = dataclasses.replace(base, **extra, checkpoint_dir=d,
                                      checkpoint_every=PIPE_CKPT_EVERY)
            run(f"crash_{side}", cfg, FaultPlan(crash_at=PIPE_CRASH_AT),
                expect=SimulatedCrash)
            alive = worker_threads()
            if alive:
                raise RuntimeError(f"crash {side}: threads alive {alive}")
            res, _ = run(f"resumed_{side}",
                         dataclasses.replace(cfg, resume_from=d))
        if res.faults["resumed_at"] != (PIPE_CRASH_AT // PIPE_CKPT_EVERY
                                        * PIPE_CKPT_EVERY):
            raise RuntimeError(f"resumed {side}: at "
                               f"{res.faults['resumed_at']}")
        for k in ("losses", "plan_history", "hit_history", "plans", "cache",
                  "eval_plans"):
            if getattr(res, k) != getattr(ref, k):
                raise RuntimeError(f"resumed {side} run: {k} differ from the "
                                   f"uninterrupted run's")
        log("faults", f"{side} FaultPlan(crash_at={PIPE_CRASH_AT}), "
            f"checkpoint every {PIPE_CKPT_EVERY}: SimulatedCrash, no worker "
            f"thread left, resumed at {res.faults['resumed_at']} to the "
            f"uninterrupted run exactly; crash run "
            f"{info[f'crash_{side}']['ms']:.1f} ms, resumed "
            f"{info[f'resumed_{side}']['ms']:.1f} ms")

    # a kernel launch that fails is fatal: no retry, no other plan
    ref = pipe["det"]["async_"]
    _, first = mb_launches(ref, base.model)
    target = next((k for k in FAULT_WRAPPERS if first.get(k)), None)
    if target is None:
        raise RuntimeError(f"no patchable kernel on the committed plan "
                           f"{ref.plan_history[0]} (launches {first})")
    real = getattr(ops, target)
    calls = []
    err = RuntimeError(f"{target} launch failed: injected by chip_smoke")

    def failing(*args, **kwargs):
        calls.append(1)
        raise err

    name = "kernel_failure_async"
    setattr(ops, target, failing)
    try:
        exc, tele = run(name, dataclasses.replace(
            base, **PIPE_ASYNC, retry_max=3, retry_base_delay_s=10.0),
            expect=RuntimeError)
    finally:
        setattr(ops, target, real)
    steps_run = sum(e[0] == "device_step" for e in tele.tracer.events())
    over = {k: v for k, v in used[name].items() if v > first.get(k, 0)}
    i = info[name]
    if (exc is not err or len(calls) != 1 or i["retries"]
            or i["pipeline_retries"] or steps_run != 1 or over
            or worker_threads()):
        raise RuntimeError(f"{name}: {exc!r}, wrapper calls {len(calls)}, "
                           f"{i}, steps {steps_run}, launches beyond the "
                           f"first step {over}")
    log("faults", f"{target} of the committed plan {ref.plan_history[0]} "
        f"raising at its first call (async, retry_max=3): that "
        f"RuntimeError, 0 retries, 1 call, one step begun, no launch of "
        f"another plan; {i['ms']:.1f} ms")
    log("faults", f"phase {time.perf_counter() - t_phase:.1f} s; "
        + json.dumps(info))
    return dict(used=used, info=info)


def serve_launches(plan_batches: dict) -> dict:
    """The CUDA-kernel launches of the batches a server served: one GCN
    forward per batch under its plan (plan_launches at 0 steps)."""
    out = {k: 0 for k in KERNELS}
    for layers, n in plan_batches.items():
        one = plan_launches(layers, 0)
        for k in out:
            out[k] += n * one[k]
    return out


def serve_threads() -> list:
    """Names of the inference server's loop threads still alive."""
    import threading
    return [t.name for t in threading.enumerate() if t.name == "serve-loop"]


def serve_requests(server, nodes) -> list:
    """``nodes`` submitted at once, then step() until every future lands
    (bounded): the (status, value) of each."""
    futs = [server.submit(int(v)) for v in nodes]
    for _ in range(4 * len(futs)):
        if all(f.done() for f in futs):
            break
        server.step()
    return [f.result(0) for f in futs]


def phase_serve(torch, counts: dict, mb: dict) -> dict:
    """[serve]: the GNN inference server on the card (the module
    docstring's 7a''''').  Raises on any failed check."""
    import dataclasses
    import logging
    import tempfile
    import numpy as np
    from repro_torch.core import selector as sel_mod
    from repro_torch.distributed import FaultPlan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import OK, SHED, TIMEOUT, InferenceServer
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.server import plan_cache_for
    t_phase = time.perf_counter()
    used, info = {}, {}

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.records = []

        def emit(self, record):
            self.records.append(record)

    loop_errors = Records()
    serve_log = logging.getLogger("repro_torch.serve")
    serve_log.addHandler(loop_errors)

    def drive(name, server, nodes) -> list:
        """step() mode with the launch counts set to 0 just before and
        read just after; every request ok, no new shape record, and the
        launches what the plans of the served batches imply."""
        traces, before = server.n_traces, dict(server.plan_batches)
        for cnt in counts.values():
            cnt.reset()
        t0 = time.perf_counter()
        out = serve_requests(server, nodes)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        used[name] = {k: cnt.value for k, cnt in counts.items()}
        bad = [s for s, _ in out if s != OK]
        if bad:
            raise RuntimeError(f"{name}: {len(bad)} requests not ok: "
                               f"{[v for s, v in out if s != OK][:3]}")
        if server.n_traces != traces:
            raise RuntimeError(f"{name}: n_traces {traces} -> "
                               f"{server.n_traces} in steady state")
        served = {k: v - before.get(k, 0)
                  for k, v in server.plan_batches.items()
                  if v != before.get(k, 0)}
        want = serve_launches(served)
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, the plans "
                               f"{served} imply {want}")
        st = server.stats()
        info[name] = dict(plans=sorted(served.items()), wall_s=secs,
                          batches=sum(served.values()),
                          n_traces=server.n_traces,
                          launches={k: v for k, v in used[name].items() if v},
                          service_ms=st["service"]["p50"] * 1e3,
                          est_service_ms=st["est_service_s"] * 1e3)
        return out

    def logits(out):
        return np.stack([v["logits"] for _, v in out])

    rng = np.random.default_rng(0)
    scfg = ServeConfig(**SERVE_STEP)
    snap_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    snap = f"{snap_dir.name}/plans.bin"
    try:
        # the main path: train through the user's entry point, then serve
        t0 = time.perf_counter()
        main = launch_serve.build_server(
            "pubmed", scale=1.0, train_steps=MB_STEPS, batch_nodes=128,
            fanouts=(8, 4), serve_cfg=scfg, device="cuda")
        t_build = time.perf_counter() - t0
        graph, cfg = main.ego.graph, main.cfg
        nodes = rng.integers(0, graph.n, size=SERVE_REQUESTS)
        t0 = time.perf_counter()
        warm = main.warmup()
        t_warm = time.perf_counter() - t0
        if not warm["new_traces"]:
            raise RuntimeError(f"main: warmup made no record ({warm})")
        trained_plans = sorted({p.layers for _, p, _ in
                                main.cache.state_dict()["entries"]})
        main.cache.save(snap)
        saved = {sig: (p, a) for sig, p, a in
                 main.cache.state_dict()["entries"]}
        card = drive("main", main, nodes)
        log("serve", f"build_server (pubmed neighbor, {MB_STEPS} steps) "
            f"{t_build:.2f} s; warmup {t_warm:.2f} s, {warm['new_traces']} "
            f"records over {warm['rungs']} rungs "
            f"{[s.fanouts for s in main.ego.samplers]}; cache plans "
            f"{trained_plans}; {SERVE_REQUESTS} requests in step() mode: "
            f"{info['main']}")

        # the CPU from the same params and the same snapshot
        budget = main.ego.pad_budget(0)
        cpu_cache = plan_cache_for(graph, cfg, budget, hw=sel_mod.H100_HW,
                                   device="cpu")
        cpu = InferenceServer(graph, cfg, main.params, serve_cfg=scfg,
                              plan_cache=cpu_cache, device="cpu")
        t0 = time.perf_counter()
        if not cpu.warmup(path=snap)["loaded"]:
            raise RuntimeError("cpu: the snapshot did not load")
        host = serve_requests(cpu, nodes)
        t_cpu = time.perf_counter() - t0
        if cpu.plan_batches != main.plan_batches:
            raise RuntimeError(f"cpu: plans {cpu.plan_batches}, the card's "
                               f"{main.plan_batches}")
        if [v["pred"] for _, v in host] != [v["pred"] for _, v in card]:
            raise RuntimeError("cpu: preds differ from the card's")
        np.testing.assert_allclose(logits(card), logits(host), **CURVE_TOL)
        info["cpu"] = dict(max_abs_diff=float(np.abs(
            logits(card) - logits(host)).max()), wall_s=t_cpu)

        # a warm start from the snapshot in a fresh card server
        fresh = InferenceServer(graph, cfg, main.params, serve_cfg=scfg,
                                device="cuda")
        if not fresh.warmup(path=snap)["loaded"]:
            raise RuntimeError("warm start: the snapshot did not load")
        got = {sig: (p, a) for sig, p, a in
               fresh.cache.state_dict()["entries"]}
        if got != saved:
            raise RuntimeError("warm start: plans differ from the snapshot")
        again = drive("warm_start", fresh, nodes)
        if [v["pred"] for _, v in again] != [v["pred"] for _, v in card]:
            raise RuntimeError("warm start: preds differ")
        np.testing.assert_allclose(logits(again), logits(card), **WARM_TOL)
        info["warm_start"]["max_abs_diff"] = float(np.abs(
            logits(again) - logits(card)).max())

        # transient build faults retried on the request path
        fp = FaultPlan(worker_faults=dict(SERVE_WORKER))
        retried = InferenceServer(
            graph, cfg, main.params, fault_plan=fp, device="cuda",
            serve_cfg=dataclasses.replace(scfg, retry_max=3,
                                          retry_base_delay_s=0.001))
        retried.warmup(path=snap)
        k = 2 * scfg.max_batch
        out = drive("retried", retried, nodes[:k])
        st = retried.stats()
        want = sum(SERVE_WORKER.values())
        if (st["retries"] != want or fp.injected_worker != want
                or st["errors"]
                or [v["pred"] for _, v in out]
                != [v["pred"] for _, v in card[:k]]):
            raise RuntimeError(f"retried: {st['retries']} retries, injected "
                               f"{fp.injected_worker}, errors "
                               f"{st['errors']}, or other preds")
        info["retried"]["retries"] = st["retries"]

        # injected kernel faults need quarantine, which is not ported
        try:
            InferenceServer(graph, cfg, main.params, device="cuda",
                            fault_plan=FaultPlan(kernel_faults={
                                "bell": "execute"}))
        except NotImplementedError as exc:
            if "item 7" not in str(exc):
                raise
        else:
            raise RuntimeError("kernel_faults did not raise")

        # an open-loop burst at twice the step() mode's rate
        est_s = main.stats()["est_service_s"]
        qps = 2.0 * SERVE_BURST["max_batch"] / est_s
        burst = InferenceServer(
            graph, cfg, main.params, device="cuda",
            serve_cfg=ServeConfig(est_service_s=est_s, **SERVE_BURST))
        burst.warmup(path=snap)
        before = dict(burst.plan_batches)
        for cnt in counts.values():
            cnt.reset()
        t0 = time.perf_counter()
        with burst:
            futs = launch_serve.open_loop_burst(burst, qps, SERVE_BURST_S)
            ends = [f.result(timeout=60) for f in futs]
        torch.cuda.synchronize()
        t_burst = time.perf_counter() - t0
        used["burst"] = {k: cnt.value for k, cnt in counts.items()}
        st = burst.stats()
        served = {k: v - before.get(k, 0)
                  for k, v in burst.plan_batches.items()
                  if v != before.get(k, 0)}
        if (any(s not in (OK, SHED, TIMEOUT) for s, _ in ends)
                or st["errors"] or st["quarantined"] or st["recoveries"]
                or st["degrades"] < 1 or serve_threads()
                or used["burst"] != serve_launches(served)):
            raise RuntimeError(f"burst: statuses "
                               f"{sorted({s for s, _ in ends})}, stats {st},"
                               f" launches {used['burst']} for {served}")
        info["burst"] = dict(
            qps=qps, seconds=t_burst, requests=len(futs),
            ok=sum(s == OK for s, _ in ends), shed=st["shed"],
            timeouts=st["timeouts"], shed_pct=st["shed_pct"],
            p50_ms=st["latency"]["p50"] * 1e3,
            p99_ms=st["latency"]["p99"] * 1e3,
            service_p50_ms=st["service"]["p50"] * 1e3,
            service_p99_ms=st["service"]["p99"] * 1e3,
            batch_size_p50=st["batch_size"]["p50"],
            degrades=st["degrades"], restores=st["restores"],
            rung=st["rung"], n_traces=st["n_traces"],
            plans=sorted(served.items()))
        log("serve", f"burst: {info['burst']}")

        # MB_FIXED's params served with their fixed plans (PlanCaches
        # that commit them), on the card and on the CPU: equal plans and
        # preds, logits within SERVE_FIXED_TOL
        for name in SERVE_FIXED:
            _, pair = MB_FIXED[name]
            fcfg = dataclasses.replace(cfg, selector="fixed",
                                       fixed_kernels=pair)
            fixed, fcpu = (InferenceServer(
                graph, fcfg, mb["runs"][name].params, serve_cfg=scfg,
                plan_cache=plan_cache_for(graph, fcfg, budget,
                                          fixed_kernels=pair, device=d),
                device=d) for d in ("cuda", "cpu"))
            fixed.warmup()
            got = drive(f"fixed_{name}", fixed, nodes)
            fcpu.warmup()
            want = serve_requests(fcpu, nodes)
            if fcpu.plan_batches != fixed.plan_batches:
                raise RuntimeError(f"{name}: CPU plans {fcpu.plan_batches},"
                                   f" the card's {fixed.plan_batches}")
            if [v["pred"] for _, v in got] != [v["pred"] for _, v in want]:
                raise RuntimeError(f"{name}: preds differ from the CPU's")
            err = float(np.abs(logits(got) - logits(want)).max())
            info[f"fixed_{name}"]["max_abs_diff_vs_cpu"] = err
            np.testing.assert_allclose(logits(got), logits(want),
                                       **SERVE_FIXED_TOL)
            info[f"fixed_{name}"]["trained_plans"] = mb["runs"][name].plans
            log("serve", f"{name}: trained plans "
                f"{mb['runs'][name].plans}; served {info[f'fixed_{name}']}")

        # the hand kernels the fixed plans must have launched on the
        # request path (the main path's cost-model plans may launch none)
        idle = [k for k in SERVE_KERNELS
                if not sum(u[k] for u in used.values())]
        if idle:
            raise RuntimeError(f"the request paths never launched {idle}")

        # one batch's infer on the card, profiled
        batch = main.ego.build(0, np.unique(nodes[:scfg.max_batch]),
                               main.ego.next_index())
        plan, run = main.infer_step(0, batch)
        infer_ms = eager_ms(torch, run)
        one = plan_launches(plan.layers, 0)
        busy = profile_busy(torch, run, 5, infer_ms, "serve infer",
                            expect=device_events(one))
        info["infer"] = dict(plan=plan.layers, ms=infer_ms,
                             busy_us=busy and busy["busy_us"])
    finally:
        serve_log.removeHandler(loop_errors)
        snap_dir.cleanup()
    if loop_errors.records:
        raise RuntimeError(f"{len(loop_errors.records)} serving loop error "
                           f"records: {loop_errors.records[0].getMessage()}")
    secs = time.perf_counter() - t_phase
    log("serve", f"phase {secs:.1f} s; " + json.dumps(info, default=str))
    return dict(used=used, info=info, seconds=secs, per_batch=one)


def time_dual_kernel(torch, sdec, flush) -> dict:
    """block_diag_spmm_dual on pubmed's SAGE diagonal blocks (L2 flushed)
    at both layers' widths, beside its plain version, the library
    composite bmm(A, X W) + X W_self and its bound: the blocks, x, both
    weights read once and y written once; 4 n Fi Fo + 2 nb B B Fo flops."""
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    gen = torch.Generator(device="cuda").manual_seed(7)
    blocks = sdec.intra.formats["block_diag"].blocks
    nb, B = blocks.shape[0], blocks.shape[1]
    n, be = sdec.n_pad, 4
    rows = {}
    for Fi, Fo in WIDTHS[:2]:
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        ws = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        lib = lambda: (torch.bmm(blocks, (x @ w).view(nb, B, Fo))  # noqa: E731
                       .view(n, Fo) + x @ ws)
        torch.testing.assert_close(lib(), bdf_mod.plain_dual(blocks, x, w,
                                                             ws), **F32_TOL)
        b_ms, b_by = bound((nb * B * B + n * Fi + 2 * Fi * Fo + n * Fo) * be,
                           4.0 * n * Fi * Fo + 2.0 * nb * B * B * Fo,
                           "float32")
        rows[f"{Fi}x{Fo}"] = r = dict(
            ms=graph_ms(torch, lambda: bdf_mod.block_diag_spmm_dual(
                blocks, x, w, ws), flush),
            plain_ms=graph_ms(torch, lambda: bdf_mod.plain_dual(
                blocks, x, w, ws), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="torch.bmm(blocks, (x @ w).view(nb, B, Fo)) "
                         "+ x @ w_self",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(blocks.shape), [n, Fi], [Fi, Fo]])
        log("timing", f"block_diag_spmm_dual {Fi}x{Fo}: {r['ms']:.4f} ms "
            f"(L2 cold), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms ({r['library_call']}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # what one launch costs, timed the same way: a PyTorch fill of one
    # float (the 16x3 call's bound is below it)
    one = torch.zeros(1, device="cuda")
    rows["16x3"]["launch_floor_ms"] = graph_ms(torch, one.zero_, flush)
    log("timing", f"one launch (fill of one float, L2 flushed): "
        f"{rows['16x3']['launch_floor_ms']:.4f} ms")
    return {"block_diag_spmm_dual": rows}


# ---------------------------------------------------------------------------
# the LM serving slice: InternLM2-1.8B through the flash kernel
# ---------------------------------------------------------------------------

def phase_kernels_flash(torch, errs: dict) -> None:
    """flash_attention against its plain version on the card: the reference
    test's shapes (B, Hq, Hkv, S, d), InternLM2's (4, 16, 8, 1024, 128),
    d = 192 with dv = 128 (MLA's), and Sq = 64 with Skv = 256 (non-causal:
    the kernel's causal mask is aligned top left, ref.mha's bottom right),
    causal on and off, float32 and bfloat16, at the reference's flash
    tolerances; Qwen2-VL-7B's (4, 28, 4, 1024, 128) and Whisper's decoder
    (8, 20, 20, 384, 64), causal."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = [((B, Hq, Hkv, S, S, d), d, causal)
             for B, Hq, Hkv, S, d in FLASH_TEST_SHAPES
             for causal in (True, False)]
    cases += [((4, 16, 8, 1024, 1024, 128), 128, c) for c in (True, False)]
    cases += [((2, 4, 2, 256, 256, 192), 128, c) for c in (True, False)]
    cases += [((1, 2, 2, 64, 256, 32), 32, False)]
    # Qwen2-VL-7B's prefill (GQA group 7) and Whisper's decoder
    cases += [((4, 28, 4, 1024, 1024, 128), 128, True),
              ((8, 20, 20, 384, 384, 64), 64, True)]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for (B, Hq, Hkv, Sq, Skv, d), dv, causal in cases:
            q = torch.randn((B, Hq, Sq, d), generator=gen, device="cuda")
            k = torch.randn((B, Hkv, Skv, d), generator=gen, device="cuda")
            v = torch.randn((B, Hkv, Skv, dv), generator=gen, device="cuda")
            args = [t.to(dtype) for t in (q, k, v)]
            blk = min(Sq, Skv, 128)
            got = fa.flash_attention(*args, causal=causal, blk_q=blk,
                                     blk_k=blk)
            want = fa.plain(*args, causal=causal)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dtype:
                raise RuntimeError(f"flash_attention {(B, Hq, Sq, dv)}: "
                                   f"{got.dtype} {tuple(got.shape)}")
            e = check_flash_close(
                torch, got, want, f"flash_attention {name} (B,Hq,Hkv,Sq,"
                f"Skv,d,dv)={(B, Hq, Hkv, Sq, Skv, d, dv)} causal={causal}")
            errs["flash_attention"][name] = max(
                errs["flash_attention"][name], e)
            n += 1
    log("kernel", f"flash_attention: {n} cases within tolerance "
        f"({FLASH_TOL}; bfloat16 also {FLASH_BF16_TIGHT} and row RMS "
        f"{FLASH_BF16_ROW_RMS}); largest errors {errs['flash_attention']}")


def check_flash_close(torch, got, want, what: str,
                      quiet: bool = False) -> float:
    """Holds a flash_attention output against its plain version: at
    FLASH_TOL; bfloat16 also at FLASH_BF16_TIGHT and, per output row,
    rms(err) <= FLASH_BF16_ROW_RMS * rms(want).  Logs the readings of
    every criterion (``quiet``: only on a failure), then raises if one
    fails; returns max|err|."""
    name = str(got.dtype).removeprefix("torch.")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    e = float(err.max())

    def worst(tol):   # the largest |err| / (atol + rtol |want|)
        return float((err / (tol["atol"] + tol["rtol"] * w.abs())).max())

    ratio = worst(FLASH_TOL[name])
    fails = [f"{FLASH_TOL[name]} (worst |err| / limit {ratio:.3g})"
             ] if not ratio <= 1 else []
    msg = f"{what}: max|err| {e:.3g}, worst |err| / limit {ratio:.3g}"
    if got.dtype == torch.bfloat16:
        tight = worst(FLASH_BF16_TIGHT)
        row = (err.square().mean(-1).sqrt()
               / w.square().mean(-1).sqrt().clamp_min(1e-30))
        row_max = float(row.max())
        rel = float(err.square().mean().sqrt() / w.square().mean().sqrt())
        msg += (f"; tight {tight:.3g}, row RMS ratio max {row_max:.3g} "
                f"(median {float(row.median()):.3g}), overall RMS ratio "
                f"{rel:.3g}")
        if not tight <= 1:
            fails.append(f"{FLASH_BF16_TIGHT} (worst {tight:.3g})")
        if not row_max <= FLASH_BF16_ROW_RMS:
            fails.append(f"row RMS {row_max:.3g} > {FLASH_BF16_ROW_RMS}")
    if fails or not quiet:
        log("kernel", msg)
    if fails:
        raise RuntimeError(f"{what} outside " + "; ".join(fails))
    return e


def lm_tokens(cfg, batch: int, length: int, seed: int):
    """Token ids made with numpy from ``seed``, as serve_lm makes prompts."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32)


def rms_ratio(got, want) -> float:
    """rms(got - want) / rms(want), over every element."""
    w = want.float()
    return float((got.float() - w).square().mean().sqrt()
                 / w.square().mean().sqrt())


def check_lm_close(torch, got, want, tol: dict, what: str,
                   rms: float | None = None) -> float:
    """Logits ``got`` against ``want`` at ``tol`` and, where given,
    rms(got - want) <= rms * rms(want); logs the readings first."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: {tuple(got.shape)} (expected "
                           f"{tuple(want.shape)}), finite "
                           f"{bool(torch.isfinite(got).all())}")
    e, r = max_err(got, want), rms_ratio(got, want)
    log("lm", f"{what}: max|diff| {e:.3g}, RMS ratio {r:.3g} (max|logit| "
        f"{float(want.float().abs().max()):.3g}; atol {tol['atol']}, rtol "
        f"{tol['rtol']}" + (f", RMS ratio <= {rms})" if rms else ")"))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if rms is not None and not r <= rms:
        raise RuntimeError(f"{what}: RMS ratio {r:.3g} > {rms}")
    return e


def phase_lm_two_layer(torch, counts: dict) -> dict:
    """The FULL InternLM2-1.8B widths at 2 layers, float32: one 256-token
    prompt through the flash prefill step on the card and on the CPU (the
    plain versions) from the same parameters."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), n_layers=2,
                              dtype="float32", attn_core="flash")
    params = lm.init_params(lm.make_generator(0, "cuda"), cfg)
    toks = torch.from_numpy(lm_tokens(cfg, 1, 256, seed=2))
    step = steps.make_prefill_step(cfg)
    for c in counts.values():
        c.reset()
    card = step(params, dict(tokens=toks.cuda()))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counts.items()}
    if launches["flash_attention"] != cfg.n_layers:
        raise RuntimeError(f"2-layer prefill step launched flash_attention "
                           f"{launches['flash_attention']} times")
    cpu_params = lm._tree_map(lambda a: a.cpu(), params)
    cpu = step(cpu_params, dict(tokens=toks))
    err = check_lm_close(torch, card.cpu(), cpu, LM_TOL,
                         "2 layers, float32, card (flash kernel) vs CPU "
                         "(plain versions)")
    return dict(launches=launches, err=err)


def phase_lm_f32(torch, counts: dict) -> dict:
    """All 24 layers, float32 on the card: the flash prefill step against
    the softmax core at batch 2 x 512, then prefill of 384 tokens and
    teacher-forced decode_step to 512 against the forward's logits (the
    reference's own invariant, tests/test_models_smoke.py)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), dtype="float32")
    params = lm.init_params(lm.make_generator(0, "cuda"), cfg)
    toks = torch.from_numpy(lm_tokens(cfg, 2, 512, seed=3)).cuda()
    P = 384
    for c in counts.values():
        c.reset()
    flash = steps.make_prefill_step(dataclasses.replace(
        cfg, attn_core="flash"))(params, dict(tokens=toks))
    torch.cuda.synchronize()
    step_launches = {k: c.value for k, c in counts.items()}
    for c in counts.values():
        c.reset()
    soft = steps.make_prefill_step(cfg)(params, dict(tokens=toks))
    logits_p, caches = lm.prefill(params, cfg, dict(tokens=toks[:, :P]),
                                  s_max=toks.shape[1])
    serve = steps.make_serve_step(cfg)
    dec = []
    for t in range(P, toks.shape[1]):
        _, lg, caches = serve(params, caches, toks[:, t:t + 1], t)
        dec.append(lg[:, 0])
    torch.cuda.synchronize()
    other = {k: c.value for k, c in counts.items()}
    if step_launches["flash_attention"] != cfg.n_layers:
        raise RuntimeError(f"24-layer prefill step launched flash_attention "
                           f"{step_launches['flash_attention']} times")
    if other["flash_attention"]:
        raise RuntimeError("the softmax core, prefill or decode launched "
                           f"flash_attention {other['flash_attention']} times")
    errs = dict(
        flash_vs_softmax=check_lm_close(
            torch, flash, soft, LM_TOL, "24 layers, float32, flash prefill "
            "step vs softmax core, batch 2 x 512"),
        prefill_vs_forward=check_lm_close(
            torch, logits_p, flash[:, :P], LM_TOL,
            f"prefill of {P} tokens vs the forward"),
        decode_vs_forward=check_lm_close(
            torch, torch.stack(dec, dim=1), flash[:, P:], LM_TOL,
            f"teacher-forced decode_step {P} -> {toks.shape[1]} vs the "
            "forward"))
    del params, caches
    return dict(launches=step_launches, other_launches=other, errs=errs)


def to_float32(tree):
    """A parameter tree (dicts and lists of tensors) cast to float32."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v) for v in tree]
    return tree.float()


def phase_lm_serve(torch, counts: dict) -> dict:
    """The FULL config in bfloat16, the published dtype: serve_lm (prefill,
    then greedy decode), and the prefill step under the flash profile and
    with the softmax core on serve_lm's prompts and parameters (both are
    made from the seed); then the timings of the serving path."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve_lm import serve_lm
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = configs.get_config(LM_ARCH)
    B, P, G, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], 0
    for c in counts.values():
        c.reset()
    out = serve_lm(LM_ARCH, reduced=False, batch=B, prompt_len=P, gen=G,
                   seed=seed, device="cuda", verbose=False)
    torch.cuda.synchronize()
    serve_launches = {k: c.value for k, c in counts.items()}
    if serve_launches["flash_attention"]:
        n = serve_launches["flash_attention"]
        raise RuntimeError(f"serve_lm (prefill and decode) launched "
                           f"flash_attention {n} times; the reference's "
                           "prefill and decode run neither")
    tokens = out["tokens"]
    if tokens.shape != (B, G) or not ((tokens >= 0) & (tokens < cfg.vocab)
                                      ).all():
        raise RuntimeError(f"serve_lm tokens {tokens.shape}: {tokens}")
    log("lm", f"serve_lm bf16 batch {B} prompt {P} gen {G}: "
        f"{out['seconds']:.2f} s ({out['tokens_per_s']:.1f} tok/s, first "
        f"calls included); tokens in [0, {cfg.vocab}); first row "
        f"{tokens[0].tolist()}")

    params = lm.init_params(lm.make_generator(seed, "cuda"), cfg)
    batch = dict(tokens=torch.from_numpy(lm_tokens(cfg, B, P, seed)).cuda())
    flash_step = steps.make_prefill_step(dataclasses.replace(
        cfg, attn_core="flash"))
    soft_step = steps.make_prefill_step(cfg)
    for c in counts.values():
        c.reset()
    flash = flash_step(params, batch)
    torch.cuda.synchronize()
    step_launches = {k: c.value for k, c in counts.items()}
    if step_launches["flash_attention"] != cfg.n_layers:
        raise RuntimeError(f"bf16 prefill step launched flash_attention "
                           f"{step_launches['flash_attention']} times")
    soft = soft_step(params, batch)
    # what bfloat16 itself moves: both cores against the softmax core in
    # float32 on the same (bfloat16-valued) parameters
    ref32 = steps.make_prefill_step(dataclasses.replace(
        cfg, dtype="float32"))(to_float32(params), batch)
    spread = dict(flash_vs_float32=rms_ratio(flash, ref32),
                  softmax_vs_float32=rms_ratio(soft, ref32),
                  flash_vs_float32_max=max_err(flash, ref32),
                  softmax_vs_float32_max=max_err(soft, ref32))
    del ref32
    log("lm", "bfloat16 against the float32 softmax core: RMS ratio flash "
        "{flash_vs_float32:.3g}, softmax {softmax_vs_float32:.3g}; max|diff| "
        "flash {flash_vs_float32_max:.3g}, softmax "
        "{softmax_vs_float32_max:.3g}".format(**spread))
    if not (spread["flash_vs_float32"]
            <= LM_BF16_SPREAD * spread["softmax_vs_float32"]):
        raise RuntimeError(f"bfloat16 flash core is further from float32 "
                           f"than {LM_BF16_SPREAD} x the softmax core's: "
                           f"{spread}")
    err = check_lm_close(torch, flash, soft, LM_BF16_TOL,
                         f"24 layers, bfloat16, flash prefill step vs softmax"
                         f" core, batch {B} x {P}", rms=LM_BF16_RMS)
    top_f = flash[:, -1, :cfg.vocab].argmax(-1).cpu()
    top_s = soft[:, -1, :cfg.vocab].argmax(-1).cpu()
    first = torch.from_numpy(tokens[:, 0]).long()
    agree = dict(last_argmax_flash_vs_softmax=int((top_f == top_s).sum()),
                 serve_first_token_vs_flash=int((first == top_f).sum()),
                 serve_first_token_vs_softmax=int((first == top_s).sum()),
                 of=B)
    log("lm", "last-position argmax agreement (of {of}): flash vs softmax "
        "core {last_argmax_flash_vs_softmax}; serve_lm's first greedy token "
        "vs the flash step's argmax {serve_first_token_vs_flash}, vs the "
        "softmax core's {serve_first_token_vs_softmax}".format(**agree))
    del flash, soft

    # timing (CUDA events, host launch included), flash and softmax in turns
    runs = {"flash": [], "softmax": []}
    fns = {"flash": lambda: flash_step(params, batch),
           "softmax": lambda: soft_step(params, batch)}
    for name in ("flash", "softmax", "softmax", "flash"):
        runs[name].append(eager_ms(torch, fns[name], iters=5))
    prefill_ms = {k: statistics.mean(v) for k, v in runs.items()}
    serve_step = steps.make_serve_step(cfg)
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, batch, s_max=P + G)
    nxt = batch["tokens"][:, -1:]
    decode_ms = eager_ms(torch, lambda: serve_step(params, caches, nxt, P),
                         iters=20)
    tok = B * P
    log("timing", f"bf16 prefill step, batch {B} x {P} (CUDA events, host "
        f"included, two runs each in turns): flash {runs['flash'][0]:.3f} / "
        f"{runs['flash'][1]:.3f} ms ({tok / prefill_ms['flash'] * 1e3:.0f} "
        f"tokens/s), softmax core {runs['softmax'][0]:.3f} / "
        f"{runs['softmax'][1]:.3f} ms ({tok / prefill_ms['softmax'] * 1e3:.0f}"
        f" tokens/s); decode step (batch {B}, cache {P + G}) "
        f"{decode_ms:.3f} ms per token")
    busy = dict(prefill=profile_busy(torch, fns["flash"], 2,
                                     prefill_ms["flash"], "prefill step"),
                decode=profile_busy(torch, lambda: serve_step(
                    params, caches, nxt, P), 5, decode_ms, "decode step"))
    del params, caches
    return dict(serve_launches=serve_launches, launches=step_launches,
                err=err, spread=spread, agree=agree, prefill_ms=prefill_ms,
                prefill_runs=runs, decode_ms=decode_ms, busy=busy,
                serve_seconds=out["seconds"])


def time_flash_kernel(torch, flush) -> dict:
    """flash_attention (L2 flushed, causal, bfloat16 and, at the first
    shape, float32) beside its plain version, the library call
    F.scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)
    (a yardstick, never on the port's path) and its bound: q, k, v read
    once and o written once over the HBM rate, or flash_flops (the causal
    half of 4 Sq Skv d per head) over the dtype's peak, the larger."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for i, (B, Hq, Hkv, S, d) in enumerate(FLASH_TIMED):
        for dtype in (torch.bfloat16, torch.float32)[:2 if i == 0 else 1]:
            name = str(dtype).removeprefix("torch.")
            q, k, v = (torch.randn((B, h, S, d), generator=gen,
                                   device="cuda").to(dtype)
                       for h in (Hq, Hkv, Hkv))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            torch.testing.assert_close(lib().float(), fa.plain(q, k, v)
                                       .float(), **FLASH_TOL[name])
            be = q.element_size()
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) * be
            n_ops = fa.flash_flops(B, Hq, S, S, d)
            b_ms, b_by = bound(n_bytes, n_ops, name)
            key = f"{B}x{Hq}x{Hkv}x{S}x{d}" + ("" if name == "bfloat16"
                                                else " float32")
            rows[key] = r = dict(
                ms=graph_ms(torch, lambda: fa.flash_attention(q, k, v),
                            flush, inner=5, reps=7),
                plain_ms=graph_ms(torch, lambda: fa.plain(q, k, v), flush,
                                  inner=2, reps=5),
                library_ms=graph_ms(torch, lib, flush, inner=5, reps=7),
                library_call="F.scaled_dot_product_attention(q, k, v, "
                             "is_causal=True, enable_gqa=True)",
                bound_ms=b_ms, bound_by=b_by, dtype=name,
                shape=[B, Hq, Hkv, S, S, d])
            log("timing", f"flash_attention {key} {name}: {r['ms']:.4f} ms "
                f"(L2 cold), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms ({r['library_call']}), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
                f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f}, operations "
                f"{n_ops / PEAK_OPS_PER_S[name] * 1e3:.4f})")
    return {"flash_attention": rows}


# ---------------------------------------------------------------------------
# the RWKV-6 slice: RWKV6-7B through the rwkv6_chunked kernel
# ---------------------------------------------------------------------------

def rwkv_inputs(torch, gen, B, H, T, dh, dtype, decay):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 from the RWKV_DECAYS rate
    ``decay``; u ~ N(0, 1) float32; all on the card."""
    r, k, v = (torch.randn((B, H, T, dh), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    if decay == "rand":
        rate = torch.randn((B, H, T, dh), generator=gen,
                           device="cuda").clamp(-20.0, 0.405)
    else:
        rate = torch.full((B, H, T, dh), 0.405 if decay == "floor" else -20.0,
                          device="cuda")
    u = torch.randn((H, dh), generator=gen, device="cuda")
    return r, k, v, torch.exp(-torch.exp(rate)), u


def check_rwkv_close(torch, got, args, what: str, quiet: bool = False
                     ) -> dict:
    """Holds an rwkv6_chunked output against its plain version: finite;
    float32 against the plain version in float64, bfloat16 against it in
    bfloat16 and per output row rms(err) <= RWKV_BF16_ROW_RMS rms(plain).
    Logs the readings (unless ``quiet`` and within tolerance), then raises
    if one fails; returns them: max|err|, worst |err| / limit and (bf16)
    the largest row RMS ratio."""
    from repro_torch.kernels import rwkv6_chunked as rk
    name = str(got.dtype).removeprefix("torch.")
    finite = bool(torch.isfinite(got).all())
    ref_args = [a.double() for a in args] if name == "float32" else args
    w = rk.plain(*ref_args).double()
    g = got.double()
    err = (g - w).abs()
    e = float(err.max())
    tol = RWKV_TOL[name]
    ratio = float((err / (tol["atol"] + tol["rtol"] * w.abs())).max())
    msg = (f"{what}: max|err| {e:.3g} (max|o| {float(w.abs().max()):.3g}), "
           f"worst |err| / limit {ratio:.3g}")
    readings = dict(err=e, ratio=ratio, row_rms=0.0)
    fails = [] if finite else ["non-finite output"]
    if not ratio <= 1:
        fails.append(f"{tol} (worst {ratio:.3g})")
    if name == "bfloat16":
        row = (err.square().mean(-1).sqrt()
               / w.square().mean(-1).sqrt().clamp_min(1e-30))
        row_max = float(row.max())
        readings["row_rms"] = row_max
        msg += f", row RMS ratio max {row_max:.3g}"
        if not row_max <= RWKV_BF16_ROW_RMS:
            fails.append(f"row RMS {row_max:.3g} > {RWKV_BF16_ROW_RMS}")
    if fails or not quiet:
        log("kernel", msg)
    if fails:
        raise RuntimeError(f"{what} outside " + "; ".join(fails))
    return readings


def phase_kernels_rwkv(torch, errs: dict) -> None:
    """rwkv6_chunked against its plain version (the sequential oracle) on
    the card at RWKV_SHAPES x RWKV_DECAYS, float32 and bfloat16; also logs
    how the plain chunked form (the "xla" core) fares at RWKV6-7B's shape
    and chunk at the decay floor (no gate: the reference's own form)."""
    from repro_torch.kernels import rwkv6_chunked as rk
    gen = torch.Generator(device="cuda").manual_seed(20)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, H, T, dh, chunk in RWKV_SHAPES:
            for decay in RWKV_DECAYS:
                args = rwkv_inputs(torch, gen, B, H, T, dh, dtype, decay)
                got = rk.rwkv6_chunked_kernel(*args, chunk=chunk)
                torch.cuda.synchronize()
                if got.shape != args[0].shape or got.dtype != dtype:
                    raise RuntimeError(f"rwkv6_chunked {(B, H, T, dh)}: "
                                       f"{got.dtype} {tuple(got.shape)}")
                e = check_rwkv_close(
                    torch, got, args, f"rwkv6_chunked {name} (B,H,T,dh)="
                    f"{(B, H, T, dh)} chunk {chunk} decay {decay}")["err"]
                errs["rwkv6_chunked"][name] = max(
                    errs["rwkv6_chunked"][name], e)
                n += 1
    args = rwkv_inputs(torch, gen, 4, 64, 1024, 64, torch.float32, "floor")
    o128, _ = rk.rwkv6_chunked(*args, chunk=128)
    o32, _ = rk.rwkv6_chunked(*args, chunk=RWKV_XLA_CHUNK)
    log("kernel", f"plain chunked form at (4, 64, 1024, 64), decay floor: "
        f"chunk 128 gives {int(torch.isnan(o128).sum())} NaN of "
        f"{o128.numel()}; chunk {RWKV_XLA_CHUNK} gives "
        f"{int((~torch.isfinite(o32)).sum())} non-finite")
    log("kernel", f"rwkv6_chunked: {n} cases within tolerance ({RWKV_TOL}, "
        f"float32 against the float64 plain version; bfloat16 also row RMS "
        f"{RWKV_BF16_ROW_RMS}); largest errors {errs['rwkv6_chunked']}")


def rwkv_cfg(**changes):
    """RWKV6-7B's FULL config with ``changes``."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(RWKV_ARCH), **changes)


def phase_rwkv_two_layer(torch, counts: dict) -> dict:
    """The FULL RWKV6-7B widths at 2 layers, float32, kernel core: batch
    2 x 256 through the prefill step on the card and on the CPU (the plain
    versions) from the same parameters."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = rwkv_cfg(n_layers=2, dtype="float32", wkv_core="pallas")
    params = lm.init_params(lm.make_generator(0, "cuda"), cfg)
    toks = torch.from_numpy(lm_tokens(cfg, 2, 256, seed=4))
    step = steps.make_prefill_step(cfg)
    for c in counts.values():
        c.reset()
    card = step(params, dict(tokens=toks.cuda()))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counts.items()}
    if launches["rwkv6_chunked"] != cfg.n_layers:
        raise RuntimeError(f"2-layer RWKV prefill step launched rwkv6_chunked "
                           f"{launches['rwkv6_chunked']} times")
    cpu_params = lm._tree_map(lambda a: a.cpu(), params)
    del params
    t0 = time.perf_counter()
    cpu = step(cpu_params, dict(tokens=toks))
    log("rwkv", f"CPU prefill step (2 layers, 2 x 256): "
        f"{time.perf_counter() - t0:.1f} s")
    err = check_lm_close(torch, card.cpu(), cpu, LM_TOL,
                         "RWKV6-7B 2 layers, float32, card (rwkv6_chunked "
                         "kernel) vs CPU (plain versions)")
    return dict(launches=launches, err=err)


def phase_rwkv_f32(torch, counts: dict) -> dict:
    """RWKV_F32_LAYERS layers at full width, float32 on the card: the
    kernel-core prefill step (batch 2 x 384) against the plain chunked
    form at chunk 32, then prefill of 256 tokens and teacher-forced
    decode_step to 384 against the forward's logits (the reference's own
    invariant, tests/test_models_smoke.py)."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = rwkv_cfg(n_layers=RWKV_F32_LAYERS, dtype="float32",
                   wkv_core="pallas")
    params = lm.init_params(lm.make_generator(1, "cuda"), cfg)
    toks = torch.from_numpy(lm_tokens(cfg, 2, 384, seed=5)).cuda()
    P = 256
    for c in counts.values():
        c.reset()
    fwd = steps.make_prefill_step(cfg)(params, dict(tokens=toks))
    torch.cuda.synchronize()
    step_launches = {k: c.value for k, c in counts.items()}
    for c in counts.values():
        c.reset()
    xla = steps.make_prefill_step(rwkv_cfg(
        n_layers=RWKV_F32_LAYERS, dtype="float32",
        rwkv_chunk=RWKV_XLA_CHUNK))(params, dict(tokens=toks))
    logits_p, caches = lm.prefill(params, cfg, dict(tokens=toks[:, :P]),
                                  s_max=toks.shape[1])
    serve = steps.make_serve_step(cfg)
    dec = []
    for t in range(P, toks.shape[1]):
        _, lg, caches = serve(params, caches, toks[:, t:t + 1], t)
        dec.append(lg[:, 0])
    torch.cuda.synchronize()
    other = {k: c.value for k, c in counts.items()}
    if step_launches["rwkv6_chunked"] != cfg.n_layers:
        raise RuntimeError(f"{cfg.n_layers}-layer RWKV prefill step launched "
                           f"rwkv6_chunked {step_launches['rwkv6_chunked']} "
                           "times")
    if other["rwkv6_chunked"]:
        raise RuntimeError("the chunked core, prefill or decode launched "
                           f"rwkv6_chunked {other['rwkv6_chunked']} times")
    errs = dict(
        kernel_vs_chunked=check_lm_close(
            torch, fwd, xla, LM_TOL, f"RWKV6-7B {cfg.n_layers} layers, "
            f"float32, kernel-core prefill step vs the chunked form at chunk "
            f"{RWKV_XLA_CHUNK}, batch 2 x 384"),
        prefill_vs_forward=check_lm_close(
            torch, logits_p, fwd[:, :P], LM_TOL,
            f"RWKV prefill of {P} tokens (sequential) vs the forward"),
        decode_vs_forward=check_lm_close(
            torch, torch.stack(dec, dim=1), fwd[:, P:], LM_TOL,
            f"RWKV teacher-forced decode_step {P} -> {toks.shape[1]} vs the "
            "forward"))
    del params, caches
    return dict(launches=step_launches, other_launches=other, errs=errs)


def rwkv_layers_against_plain(torch, params, cfg, batch) -> float:
    """Along the bfloat16 kernel-core forward of all cfg.n_layers layers,
    each layer's recurrence: the kernel on that layer's r, k, v, w and u
    against its plain version (phase 2's bfloat16 criteria).  Logs the
    worst readings and each layer's share of decay channels at the floor
    (log w <= -1.49); returns the largest max|err|.  Its launches are
    comparisons, outside every counted path."""
    from repro_torch.kernels import rwkv6_chunked as rk
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    rc = cfg.rwkv_cfg()
    worst, floor = dict(err=0.0, ratio=0.0, row_rms=0.0), []
    with torch.no_grad():
        x, positions = lm._embed_inputs(params, cfg, batch)
        for i, lp in enumerate(lm._layers(params["groups"][0], cfg)):
            h = lm._norm_apply(lp["norm1"], x, cfg.norm_eps)
            r, k, v, w, _ = blk._rwkv6_rkvwg(
                lp["tm"], rc, h, h.new_zeros((h.shape[0], 1, h.shape[2])))
            args = [a.contiguous() for a in (r, k, v, w)] + [lp["tm"]["u"]]
            got = rk.rwkv6_chunked_kernel(*args, chunk=rc.chunk)
            readings = check_rwkv_close(
                torch, got, args, f"RWKV6-7B bf16 layer {i} (B,H,T,dh)="
                f"{tuple(r.shape)}", quiet=True)
            worst = {k: max(v, readings[k]) for k, v in worst.items()}
            floor.append(float((torch.log(w) <= -1.49).float().mean()))
            x, _ = lm.layer_apply(lp, cfg, "rwkv", x, positions)
    log("rwkv", f"every layer's rwkv6_chunked output against its plain "
        f"version on the layer's bf16 activations ({len(floor)} layers): "
        f"within {RWKV_TOL['bfloat16']} and row RMS {RWKV_BF16_ROW_RMS}: "
        f"largest max|err| {worst['err']:.3g}, worst |err| / limit "
        f"{worst['ratio']:.3g}, row RMS ratio max {worst['row_rms']:.3g}; "
        f"decay channels at the floor per layer {min(floor):.3f}-"
        f"{max(floor):.3f}")
    return worst["err"]


def rwkv_sensitivity(torch, params, cfg, batch) -> list:
    """How a relative perturbation of 1e-6 in the embeddings grows through
    the layers of ``cfg`` (float32 here): rms(x' - x) / rms(x) of the
    residual stream after each layer."""
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda").manual_seed(7)
    growth = []
    with torch.no_grad():
        xa, positions = lm._embed_inputs(params, cfg, batch)
        xb = xa * (1 + 1e-6 * torch.randn(xa.shape, generator=gen,
                                          device="cuda"))
        for lp in lm._layers(params["groups"][0], cfg):
            xa, _ = lm.layer_apply(lp, cfg, "rwkv", xa, positions)
            xb, _ = lm.layer_apply(lp, cfg, "rwkv", xb, positions)
            growth.append(float((xb - xa).norm() / xa.norm()))
    log("rwkv", "float32 sensitivity, rms(x' - x) / rms(x) after each layer "
        "for a 1e-6 relative perturbation of the embeddings: "
        + ", ".join(f"{g:.2e}" for g in growth))
    return growth


def phase_rwkv_serve(torch, counts: dict) -> dict:
    """The FULL RWKV6-7B config in bfloat16, all 32 layers: serve_lm with
    the kernel core (the reference's serving profile), then the prefill
    step on its prompts and parameters with the kernel core and with the
    plain chunked form at chunk 32; the same two in float32 on the same
    (bfloat16-valued) parameters, held against each other; both bf16
    cores against the float32 chunked step; the kernel at every layer
    against its plain version, and the model's float32 sensitivity; then
    the timings of the serving path."""
    import dataclasses
    from repro_torch.launch.serve_lm import serve_lm
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = rwkv_cfg(wkv_core="pallas")
    B, P, G, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], 0
    for c in counts.values():
        c.reset()
    out = serve_lm(RWKV_ARCH, reduced=False, batch=B, prompt_len=P, gen=G,
                   seed=seed, device="cuda",
                   overrides=dict(wkv_core="pallas"), verbose=False)
    torch.cuda.synchronize()
    serve_launches = {k: c.value for k, c in counts.items()}
    if serve_launches["rwkv6_chunked"]:
        raise RuntimeError(f"serve_lm (prefill and decode) launched "
                           f"rwkv6_chunked {serve_launches['rwkv6_chunked']} "
                           "times; the reference's prefill and decode are "
                           "sequential under this core")
    tokens = out["tokens"]
    if tokens.shape != (B, G) or not ((tokens >= 0) & (tokens < cfg.vocab)
                                      ).all():
        raise RuntimeError(f"RWKV serve_lm tokens {tokens.shape}: {tokens}")
    log("rwkv", f"serve_lm bf16 RWKV6-7B batch {B} prompt {P} gen {G}: "
        f"{out['seconds']:.2f} s ({out['tokens_per_s']:.1f} tok/s, first "
        f"calls included); tokens in [0, {cfg.vocab}); first row "
        f"{tokens[0].tolist()}")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(lm.make_generator(seed, "cuda"), cfg)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in lm._leaves(params))
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log("rwkv", f"init_params: {n_params / 1e9:.3f} B parameters, "
        f"{sum(a.numel() * a.element_size() for a in lm._leaves(params)) / 1e9:.2f}"
        f" GB, {time.perf_counter() - t0:.1f} s; peak device memory above "
        f"the baseline {init_peak:.2f} GB")
    batch = dict(tokens=torch.from_numpy(lm_tokens(cfg, B, P, seed)).cuda())
    kern_step = steps.make_prefill_step(cfg)
    xla_step = steps.make_prefill_step(dataclasses.replace(
        cfg, wkv_core="xla", rwkv_chunk=RWKV_XLA_CHUNK))
    for c in counts.values():
        c.reset()
    kern = kern_step(params, batch)
    torch.cuda.synchronize()
    step_launches = {k: c.value for k, c in counts.items()}
    if step_launches["rwkv6_chunked"] != cfg.n_layers:
        raise RuntimeError(f"bf16 RWKV prefill step launched rwkv6_chunked "
                           f"{step_launches['rwkv6_chunked']} times")
    xla = xla_step(params, batch)
    torch.cuda.synchronize()
    if counts["rwkv6_chunked"].value != cfg.n_layers:
        raise RuntimeError("the chunked core launched rwkv6_chunked")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_float32(params)
    kern32 = steps.make_prefill_step(cfg32)(params32, batch)
    ref32 = steps.make_prefill_step(dataclasses.replace(
        cfg32, wkv_core="xla", rwkv_chunk=RWKV_XLA_CHUNK))(params32, batch)
    for name, t in (("kernel core", kern), ("chunked core", xla),
                    ("float32 kernel core", kern32),
                    ("float32 chunked core", ref32)):
        if t.shape != (B, P, cfg.padded_vocab) or not bool(
                torch.isfinite(t).all()):
            raise RuntimeError(f"RWKV6-7B {name} logits {tuple(t.shape)}, "
                               f"finite {bool(torch.isfinite(t).all())}")
    spread = dict(f32_kernel_vs_chunked=rms_ratio(kern32, ref32),
                  f32_kernel_vs_chunked_max=max_err(kern32, ref32),
                  kernel_vs_float32=rms_ratio(kern, ref32),
                  chunked_vs_float32=rms_ratio(xla, ref32),
                  kernel_vs_chunked=rms_ratio(kern, xla),
                  kernel_vs_float32_max=max_err(kern, ref32),
                  chunked_vs_float32_max=max_err(xla, ref32),
                  kernel_vs_chunked_max=max_err(kern, xla))
    del kern32, ref32
    log("rwkv", "float32 logits, batch {B} x {P}, 32 layers: kernel core "
        "against the chunked core (chunk {C}) RMS ratio "
        "{f32_kernel_vs_chunked:.3g} (limit {lim}), max|diff| "
        "{f32_kernel_vs_chunked_max:.3g}".format(
            B=B, P=P, C=RWKV_XLA_CHUNK, lim=RWKV_F32_DEEP_RMS, **spread))
    log("rwkv", "bfloat16 logits, batch {B} x {P}: RMS ratio against the "
        "float32 chunked-core step, kernel core {kernel_vs_float32:.3g}, "
        "chunked core {chunked_vs_float32:.3g} (max|diff| "
        "{kernel_vs_float32_max:.3g}, {chunked_vs_float32_max:.3g}); kernel "
        "core against chunked core {kernel_vs_chunked:.3g} (max|diff| "
        "{kernel_vs_chunked_max:.3g}; max|logit| {top:.3g})".format(
            B=B, P=P, top=float(xla.abs().max()), **spread))
    if not spread["f32_kernel_vs_chunked"] <= RWKV_F32_DEEP_RMS:
        raise RuntimeError(f"float32 kernel core against the chunked core at "
                           f"32 layers: RMS ratio outside "
                           f"{RWKV_F32_DEEP_RMS}: {spread}")
    if not (spread["kernel_vs_float32"]
            <= RWKV_BF16_SPREAD * spread["chunked_vs_float32"]):
        raise RuntimeError(f"bfloat16 kernel core is further from float32 "
                           f"than {RWKV_BF16_SPREAD} x the chunked core's: "
                           f"{spread}")
    err = rwkv_layers_against_plain(torch, params, cfg, batch)
    growth = rwkv_sensitivity(torch, params32, cfg32,
                              dict(tokens=batch["tokens"][:1]))
    del params32
    top_k = kern[:, -1, :cfg.vocab].argmax(-1).cpu()
    top_x = xla[:, -1, :cfg.vocab].argmax(-1).cpu()
    first = torch.from_numpy(tokens[:, 0]).long()
    agree = dict(last_argmax_kernel_vs_chunked=int((top_k == top_x).sum()),
                 serve_first_token_vs_kernel=int((first == top_k).sum()),
                 serve_first_token_vs_chunked=int((first == top_x).sum()),
                 of=B)
    log("rwkv", "last-position argmax agreement (of {of}): kernel vs chunked "
        "core {last_argmax_kernel_vs_chunked}; serve_lm's first greedy token "
        "vs the kernel step's argmax {serve_first_token_vs_kernel}, vs the "
        "chunked core's {serve_first_token_vs_chunked}".format(**agree))
    del kern, xla

    # timing (CUDA events, host launch included), the two cores in turns
    runs = {"kernel": [], "chunked": []}
    fns = {"kernel": lambda: kern_step(params, batch),
           "chunked": lambda: xla_step(params, batch)}
    for name in ("kernel", "chunked", "chunked", "kernel"):
        runs[name].append(eager_ms(torch, fns[name], iters=3))
    prefill_ms = {k: statistics.mean(v) for k, v in runs.items()}
    serve_step = steps.make_serve_step(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, batch, s_max=P + G)
    torch.cuda.synchronize()
    cache_prefill_s = time.perf_counter() - t0
    nxt = batch["tokens"][:, -1:]
    decode_ms = eager_ms(torch, lambda: serve_step(params, caches, nxt, P),
                         iters=10)
    tok = B * P
    log("timing", f"bf16 RWKV6-7B prefill step, batch {B} x {P} (CUDA events,"
        f" host included, two runs each in turns): kernel core "
        f"{runs['kernel'][0]:.3f} / {runs['kernel'][1]:.3f} ms "
        f"({tok / prefill_ms['kernel'] * 1e3:.0f} tokens/s), chunked core "
        f"(chunk {RWKV_XLA_CHUNK}) {runs['chunked'][0]:.3f} / "
        f"{runs['chunked'][1]:.3f} ms "
        f"({tok / prefill_ms['chunked'] * 1e3:.0f} tokens/s); cache-producing "
        f"prefill (sequential) {cache_prefill_s:.2f} s; decode step (batch "
        f"{B}) {decode_ms:.3f} ms per token")
    busy = dict(prefill=profile_busy(torch, fns["kernel"], 2,
                                     prefill_ms["kernel"],
                                     "RWKV prefill step",
                                     expect={"rwkv6_kernel": cfg.n_layers}),
                decode=profile_busy(torch, lambda: serve_step(
                    params, caches, nxt, P), 5, decode_ms,
                    "RWKV decode step"))
    del params, caches
    return dict(serve_launches=serve_launches, launches=step_launches,
                err=err, spread=spread, agree=agree, growth=growth,
                prefill_ms=prefill_ms, prefill_runs=runs,
                decode_ms=decode_ms, busy=busy,
                cache_prefill_s=cache_prefill_s, init_peak_gb=init_peak,
                serve_seconds=out["seconds"])


def time_rwkv_kernel(torch, flush) -> dict:
    """rwkv6_chunked (L2 flushed; bfloat16 and, at the first shape,
    float32) beside its plain version (the sequential oracle, eager: one
    launch per op per step), the plain chunked form at chunk 32 (cuBLAS
    batched products in float32, a composite yardstick: no single PyTorch
    call computes this function) and its bound: r, k, v read and o written
    once in their dtype and w, u read once in float32 over the HBM rate, or
    rwkv6_flops at the kernel's own chunk (rk.KERNEL_CHUNK steps) over the
    dtype's peak, the larger; beside it the same flops over the float32
    CUDA-core peak."""
    from repro_torch.kernels import rwkv6_chunked as rk
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = {}
    for i, (B, H, T, dh) in enumerate(RWKV_TIMED):
        for dtype in (torch.bfloat16, torch.float32)[:2 if i == 0 else 1]:
            name = str(dtype).removeprefix("torch.")
            args = rwkv_inputs(torch, gen, B, H, T, dh, dtype, "rand")
            r, k, v, w, u = args
            n_bytes = (4 * r.numel() * r.element_size() + w.numel() * 4
                       + u.numel() * 4)
            flops = rk.rwkv6_flops(B, H, T, dh, chunk=rk.KERNEL_CHUNK)
            b_ms, b_by = bound(n_bytes, flops, name)
            key = f"{B}x{H}x{T}x{dh}" + ("" if name == "bfloat16"
                                          else " float32")
            rows[key] = row = dict(
                ms=graph_ms(torch, lambda: rk.rwkv6_chunked_kernel(
                    *args, chunk=128), flush, inner=5, reps=7),
                plain_ms=eager_ms(torch, lambda: rk.plain(*args), iters=3),
                plain_timing="eager (host launch included)",
                library_ms=graph_ms(torch, lambda: rk.rwkv6_chunked(
                    *args, chunk=RWKV_XLA_CHUNK), flush, inner=2, reps=5),
                library_call=f"rwkv6_chunked(..., chunk={RWKV_XLA_CHUNK}) "
                             "(composite: cuBLAS batched products, float32)",
                bound_ms=b_ms, bound_by=b_by,
                algo_bound_ms=flops / PEAK_OPS_PER_S["float32"] * 1e3,
                dtype=name, shape=[B, H, T, dh])
            log("timing", f"rwkv6_chunked {key} {name}: {row['ms']:.4f} ms "
                f"(L2 cold), plain {row['plain_ms']:.4f} ms (eager), library "
                f"{row['library_ms']:.4f} ms ({row['library_call']}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}; float32 "
                f"CUDA-core floor of rwkv6_flops at chunk {rk.KERNEL_CHUNK} "
                f"{row['algo_bound_ms']:.4f} ms)")
    return {"rwkv6_chunked": rows}


# ---------------------------------------------------------------------------
# the Jamba slice: Jamba-v0.1, one period at full width, through mamba_scan
# ---------------------------------------------------------------------------

def mamba_inputs(torch, gen, B, T, di, ds, dt_scale):
    """tests/test_kernels_mamba.py's inputs on the card: x ~ N(0, 1),
    dt = |N(0, 1)| * dt_scale, Bc, Cc ~ N(0, 1), A = -(|N(0, 1)| + 0.1),
    D ~ N(0, 1), all float32 (the model path's types)."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (n(B, T, di), n(B, T, di).abs() * dt_scale, n(B, T, ds),
            n(B, T, ds), -(n(di, ds).abs() + 0.1), n(di))


def check_mamba_close(torch, got, args, what: str, quiet: bool = False,
                      want=None) -> dict:
    """Holds a mamba_scan output against its plain version run in float64
    (``want`` if given): finite, at MAMBA_TOL for a float32 x and
    MAMBA_BF16_TOL for a bfloat16 one.  Logs the readings (unless ``quiet``
    and within tolerance), then raises if one fails; returns max|err| and
    the worst |err| / limit."""
    from repro_torch.kernels import mamba_scan as ms
    name = str(got.dtype).removeprefix("torch.")
    if want is None:
        x, dt, Bc, Cc, A, D = (a.double() for a in args)
        want = ms.plain(x, dt, A, Bc, Cc, D)
    err = (got.double() - want).abs()
    tol = MAMBA_TOL if name == "float32" else MAMBA_BF16_TOL
    e = float(err.max())
    ratio = float((err / (tol["atol"] + tol["rtol"] * want.abs())).max())
    finite = bool(torch.isfinite(got).all())
    msg = (f"{what}: max|err| {e:.3g} (max|y| {float(want.abs().max()):.3g}),"
           f" worst |err| / limit {ratio:.3g}")
    if not (finite and ratio <= 1) or not quiet:
        log("kernel", msg)
    if not finite or not ratio <= 1:
        raise RuntimeError(f"{what} outside {tol} (finite {finite}): {msg}")
    return dict(err=e, ratio=ratio)


def phase_kernels_mamba(torch, errs: dict) -> None:
    """mamba_scan against its plain version (the sequential oracle) in
    float64 on the card at MAMBA_SHAPES, float32 x (the model path's) and
    bfloat16 x."""
    from repro_torch.kernels import mamba_scan as ms
    gen = torch.Generator(device="cuda").manual_seed(22)
    n = 0
    for B, T, di, ds, chunk, d_tile, dt_scale in MAMBA_SHAPES:
        args = mamba_inputs(torch, gen, B, T, di, ds, dt_scale)
        for x in (args[0], args[0].bfloat16()):
            name = str(x.dtype).removeprefix("torch.")
            got = ms.mamba_scan(x, *args[1:], chunk=chunk, d_tile=d_tile)
            torch.cuda.synchronize()
            if got.shape != x.shape or got.dtype != x.dtype:
                raise RuntimeError(f"mamba_scan {(B, T, di, ds)}: "
                                   f"{got.dtype} {tuple(got.shape)}")
            e = check_mamba_close(
                torch, got, (x, *args[1:]), f"mamba_scan {name} x "
                f"(B,T,di,ds)={(B, T, di, ds)} chunk {chunk} d_tile "
                f"{d_tile} dt scale {dt_scale}")["err"]
            errs["mamba_scan"][name] = max(errs["mamba_scan"][name], e)
            n += 1
        del args
    log("kernel", f"mamba_scan: {n} cases within tolerance (float32 "
        f"{MAMBA_TOL} against the float64 plain version, bfloat16 x "
        f"{MAMBA_BF16_TOL}); largest errors {errs['mamba_scan']}")


def jamba_cfg(reduced: bool = False, **changes):
    """Jamba-v0.1's config (FULL cut to one period, or REDUCED) under the
    serving profile, with ``changes``."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_config(JAMBA_ARCH, reduced=reduced)
    if not reduced:
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    return dataclasses.replace(cfg, **JAMBA_PROFILE, **changes)


def phase_jamba_reduced(torch, counts: dict) -> dict:
    """Jamba's REDUCED config (one period: 7 Mamba layers, attention at
    layer 3, 4 dense and 4 MoE FFNs) in float32 under the serving profile,
    on the card and on the CPU (plain versions) from the same parameters:
    the prefill step (batch 2 x 128, so both kernels run), prefill of 96
    tokens and teacher-forced decode_step to 128, logits within 1e-3; the
    launches of each path on the card."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = jamba_cfg(reduced=True)
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    card_params = lm._tree_map(lambda a: a.cuda(), params)
    toks = torch.from_numpy(lm_tokens(cfg, 2, 128, seed=6))
    P = 96

    def run(p, dev):
        out, launches = {}, {}
        t = toks.to(dev)
        for path in ("forward", "prefill", "decode"):
            for c in counts.values():
                c.reset()
            if path == "forward":
                out[path] = steps.make_prefill_step(cfg)(p, dict(tokens=t))
            elif path == "prefill":
                out[path], caches = lm.prefill(p, cfg, dict(tokens=t[:, :P]),
                                               s_max=t.shape[1])
            else:
                serve, dec = steps.make_serve_step(cfg), []
                for i in range(P, t.shape[1]):
                    _, lg, caches = serve(p, caches, t[:, i:i + 1], i)
                    dec.append(lg[:, 0])
                out[path] = torch.stack(dec, dim=1)
            if dev == "cuda":
                torch.cuda.synchronize()
            launches[path] = {k: c.value for k, c in counts.items()}
        return out, launches

    card, launches = run(card_params, "cuda")
    want = dict(forward=dict(mamba_scan=7, flash_attention=1),
                prefill=dict(mamba_scan=7), decode={})
    for path, w in want.items():
        got = {k: v for k, v in launches[path].items() if v}
        if got != w:
            raise RuntimeError(f"reduced Jamba {path} launched {got}, "
                               f"expected {w}")
    cpu, _ = run(params, "cpu")
    errs = {path: check_lm_close(
        torch, card[path].cpu(), cpu[path], LM_TOL, f"Jamba reduced, "
        f"float32, {path}, card (kernels) vs CPU (plain versions)")
        for path in card}
    errs["prefill_vs_forward"] = check_lm_close(
        torch, card["prefill"], card["forward"][:, :P], LM_TOL,
        "Jamba reduced prefill vs the forward, card")
    errs["decode_vs_forward"] = check_lm_close(
        torch, card["decode"], card["forward"][:, P:], LM_TOL,
        "Jamba reduced teacher-forced decode vs the forward, card")
    return dict(launches=launches, errs=errs)


def phase_jamba_layers(torch, counts: dict) -> dict:
    """Full-width layers of Jamba in float32 on the card: one Mamba layer
    (batch 4 x 1024) under the kernel core against the plain associative
    scan core (1e-3), its return_state h (from the plain scan) against the
    sequential oracle's final state in float64 (1e-3) and the kernel on
    the layer's own inputs against the oracle (phase 2's criterion); one
    MoE layer of 16 experts at 4096 tokens, the sparse path at a capacity
    that drops nothing against the dense path (1e-3), and the drops at the
    default capacity factor 1.25."""
    import dataclasses
    import math
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    cfg = jamba_cfg(dtype="float32")
    gen = lm.make_generator(1, "cuda")
    mc = cfg.mamba_cfg()
    p = blk.init_mamba(gen, mc, torch.float32)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen, device="cuda")
    for c in counts.values():
        c.reset()
    with torch.no_grad():
        kern, cache = blk.mamba_apply(p, mc, x, return_state=True)
        torch.cuda.synchronize()
        launches = {k: c.value for k, c in counts.items() if c.value}
        if launches != {"mamba_scan": 1}:
            raise RuntimeError(f"one Mamba layer launched {launches}")
        xla = blk.mamba_apply(p, dataclasses.replace(mc, scan_core="xla"), x)
        errs = dict(mamba_kernel_vs_xla=check_lm_close(
            torch, kern, xla, LM_TOL, "Jamba Mamba layer, float32, 4 x 1024,"
            " kernel core vs plain associative scan"))
        del xla
        xz = blk.einsum("btd,de->bte", x, p["in_proj"])
        xs, _, dt, Bc, Cc, _ = blk._mamba_inner(p, mc, xz)
        A = -torch.exp(p["A_log"])
        y64, h64 = ref.mamba_recurrence(xs.double(), dt.double(), A.double(),
                                        Bc.double(), Cc.double(),
                                        p["D"].double())
        errs["state_vs_oracle"] = check_lm_close(
            torch, cache["h"], h64.float(), LM_TOL, "Jamba Mamba layer "
            "return_state h (plain scan) vs the float64 oracle's final state")
        args = (xs.contiguous(), dt.contiguous(), Bc.contiguous(),
                Cc.contiguous(), A, p["D"])
        errs["kernel_on_layer_inputs"] = check_mamba_close(
            torch, ms.mamba_scan(*args), args, "mamba_scan on the Mamba "
            "layer's own inputs (4, 1024, 8192, 16)", want=y64)["err"]
        del p, xz, xs, dt, Bc, Cc, y64, h64, args, kern, cache

        moe = cfg.moe_cfg()
        pm = blk.init_moe(gen, moe, torch.float32)
        x2 = torch.randn((4096, cfg.d_model), generator=gen, device="cuda")
        if blk.choose_moe_path(moe, 4096) != "sparse":
            raise RuntimeError("the MoE rule does not pick sparse at 4096")
        wide = dataclasses.replace(moe, capacity_factor=moe.n_experts
                                   / moe.top_k)
        dense, aux_d = blk.moe_apply_dense(pm, moe, x2)
        sparse, aux_s = blk.moe_apply_sparse(pm, wide, x2)
        errs["moe_sparse_vs_dense"] = check_lm_close(
            torch, sparse, dense, LM_TOL, "Jamba MoE layer, float32, 4096 "
            "tokens, sparse (capacity factor 8, no drops) vs dense")
        if abs(float(aux_d) - float(aux_s)) > 1e-6:
            raise RuntimeError(f"MoE aux {float(aux_d)} vs {float(aux_s)}")
        _, idx, _ = blk._moe_gates(pm, moe, x2)
        load = torch.bincount(idx.reshape(-1), minlength=moe.n_experts)
        C = max(math.ceil(4096 * moe.top_k / moe.n_experts
                          * moe.capacity_factor), 1)
        dropped = int((load - C).clamp_min(0).sum())
        log("jamba", f"MoE at 4096 tokens, capacity factor "
            f"{moe.capacity_factor} (C = {C}): expert loads "
            f"{load.tolist()}, {dropped} of {4096 * moe.top_k} assignments "
            f"dropped")
        del pm, x2, dense, sparse
    return dict(errs=errs, launches=launches, moe_dropped=dropped)


def phase_jamba_serve(torch, counts: dict) -> dict:
    """One Jamba period at full width in bfloat16 under the serving
    profile: serve_lm (batch 4, prompt 1024, 32 greedy tokens); the prefill
    step on its prompts and parameters with the kernel core and with the
    plain associative-scan core (logits compared, not gated: both round
    once differently per layer in bf16); the kernel at every Mamba layer of
    the kernel-core step against its plain version on that layer's own
    inputs (phase 2's criterion); then the timings of the serving path and
    the MoE paths at a prefill's and a decode step's token counts."""
    import dataclasses
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch.serve_lm import serve_lm
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = jamba_cfg()
    B, P, G, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], 0
    for c in counts.values():
        c.reset()
    out = serve_lm(JAMBA_ARCH, reduced=False, batch=B, prompt_len=P, gen=G,
                   seed=seed, device="cuda",
                   overrides=dict(n_layers=JAMBA_LAYERS), verbose=False)
    torch.cuda.synchronize()
    serve_launches = {k: c.value for k, c in counts.items()}
    if {k: v for k, v in serve_launches.items() if v} != {"mamba_scan": 7}:
        raise RuntimeError(f"Jamba serve_lm launched {serve_launches}; "
                           "expected 7 mamba_scan (its prefill) and nothing "
                           "else")
    tokens = out["tokens"]
    if tokens.shape != (B, G) or not ((tokens >= 0) & (tokens < cfg.vocab)
                                      ).all():
        raise RuntimeError(f"Jamba serve_lm tokens {tokens.shape}: {tokens}")
    log("jamba", f"serve_lm bf16 Jamba-v0.1 (one period) batch {B} prompt "
        f"{P} gen {G}: {out['seconds']:.2f} s ({out['tokens_per_s']:.1f} "
        f"tok/s, first calls included); tokens in [0, {cfg.vocab}); first "
        f"row {tokens[0].tolist()}")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(lm.make_generator(seed, "cuda"), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in lm._leaves(params))
    n_bytes = sum(a.numel() * a.element_size() for a in lm._leaves(params))
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log("jamba", f"init_params: {n_params} parameters, {n_bytes / 1e9:.2f} "
        f"GB, {init_s:.1f} s; peak device memory above the baseline "
        f"{init_peak:.2f} GB")
    if n_params != JAMBA_PARAMS:
        raise RuntimeError(f"one Jamba period has {n_params} parameters, "
                           f"expected {JAMBA_PARAMS}")
    batch = dict(tokens=torch.from_numpy(lm_tokens(cfg, B, P, seed)).cuda())
    kern_step = steps.make_prefill_step(cfg)
    xla_step = steps.make_prefill_step(dataclasses.replace(
        cfg, mamba_core="xla"))
    for c in counts.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    kern = kern_step(params, batch)
    torch.cuda.synchronize()
    step_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    step_launches = {k: c.value for k, c in counts.items()}
    if ({k: v for k, v in step_launches.items() if v}
            != {"mamba_scan": 7, "flash_attention": 1}):
        raise RuntimeError(f"bf16 Jamba prefill step launched "
                           f"{step_launches}")
    for c in counts.values():
        c.reset()
    xla = xla_step(params, batch)
    torch.cuda.synchronize()
    xla_launches = {k: c.value for k, c in counts.items()}
    if {k: v for k, v in xla_launches.items() if v} != {"flash_attention": 1}:
        raise RuntimeError(f"the plain-core step launched {xla_launches}")
    for name, t in (("kernel core", kern), ("plain core", xla)):
        if t.shape != (B, P, cfg.padded_vocab) or not bool(
                torch.isfinite(t).all()):
            raise RuntimeError(f"Jamba {name} logits {tuple(t.shape)}, "
                               f"finite {bool(torch.isfinite(t).all())}")
    spread = dict(kernel_vs_plain_rms=rms_ratio(kern, xla),
                  kernel_vs_plain_max=max_err(kern, xla),
                  max_logit=float(xla.float().abs().max()))
    top_k = kern[:, -1, :cfg.vocab].argmax(-1).cpu()
    top_x = xla[:, -1, :cfg.vocab].argmax(-1).cpu()
    first = torch.from_numpy(tokens[:, 0]).long()
    agree = dict(last_argmax_kernel_vs_plain=int((top_k == top_x).sum()),
                 serve_first_token_vs_kernel=int((first == top_k).sum()),
                 of=B)
    log("jamba", "bf16 logits, batch {B} x {P}: kernel core against the "
        "plain-scan core RMS ratio {kernel_vs_plain_rms:.3g}, max|diff| "
        "{kernel_vs_plain_max:.3g} (max|logit| {max_logit:.3g}); not gated"
        .format(B=B, P=P, **spread))
    log("jamba", "last-position argmax agreement (of {of}): kernel vs plain "
        "core {last_argmax_kernel_vs_plain}; serve_lm's first greedy token "
        "vs the kernel step's argmax {serve_first_token_vs_kernel}"
        .format(**agree))
    del kern, xla

    # the kernel at every Mamba layer, on the inputs the model gives it
    orig, worst = ms.mamba_scan, dict(err=0.0, ratio=0.0, layers=0)

    def checked(*args, **kw):
        y = orig(*args, **kw)
        r = check_mamba_close(torch, y, args, f"Jamba bf16 Mamba layer "
                              f"{worst['layers']}", quiet=True)
        worst.update(err=max(worst["err"], r["err"]),
                     ratio=max(worst["ratio"], r["ratio"]),
                     layers=worst["layers"] + 1)
        return y

    ms.mamba_scan = checked
    try:
        kern_step(params, batch)
    finally:
        ms.mamba_scan = orig
    log("jamba", f"every Mamba layer's mamba_scan output against its plain "
        f"version in float64 on the layer's own inputs ({worst['layers']} "
        f"layers): largest max|err| {worst['err']:.3g}, worst |err| / limit "
        f"{worst['ratio']:.3g}")

    # timing (CUDA events, host launch included), the two cores in turns
    runs = {"kernel": [], "plain": []}
    fns = {"kernel": lambda: kern_step(params, batch),
           "plain": lambda: xla_step(params, batch)}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name].append(eager_ms(torch, fns[name], iters=3))
    prefill_ms = {k: statistics.mean(v) for k, v in runs.items()}
    serve_step = steps.make_serve_step(cfg)
    with torch.no_grad():
        lm.prefill(params, cfg, batch, s_max=P + G)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, caches = lm.prefill(params, cfg, batch, s_max=P + G)
        torch.cuda.synchronize()
    cache_prefill_ms = (time.perf_counter() - t0) * 1e3
    nxt = batch["tokens"][:, -1:]
    decode_ms = eager_ms(torch, lambda: serve_step(params, caches, nxt, P),
                         iters=10)
    tok = B * P
    log("timing", f"bf16 Jamba prefill step, batch {B} x {P} (CUDA events, "
        f"host included, two runs each in turns): kernel core "
        f"{runs['kernel'][0]:.3f} / {runs['kernel'][1]:.3f} ms "
        f"({tok / prefill_ms['kernel'] * 1e3:.0f} tokens/s), plain-scan core "
        f"{runs['plain'][0]:.3f} / {runs['plain'][1]:.3f} ms "
        f"({tok / prefill_ms['plain'] * 1e3:.0f} tokens/s); cache-producing "
        f"prefill {cache_prefill_ms:.3f} ms (host clock); decode step (batch "
        f"{B}) {decode_ms:.3f} ms per token; peak memory of the step "
        f"{step_peak:.2f} GB above the baseline")
    # the MoE rule's two paths on layer 1's experts, at a prefill's and a
    # decode step's token counts (the rule picks sparse and dense)
    moe = cfg.moe_cfg()
    ffn = lm._layers(params["groups"][0], cfg)[0]["l1"]["ffn"]
    gen = torch.Generator(device="cuda").manual_seed(23)
    moe_bf16 = phase_moe_dense_bf16(torch, ffn, moe, gen, B * P)
    moe_ms = {}
    with torch.no_grad():
        for n in (B * P, B):
            x2 = torch.randn((n, cfg.d_model), generator=gen,
                             device="cuda").bfloat16()
            moe_fns = {
                "dense": lambda: blk.moe_apply_dense(ffn, moe, x2),
                "dense rounded": lambda: moe_dense_rounded(torch, ffn, moe,
                                                           x2),
                "sparse": lambda: blk.moe_apply_sparse(ffn, moe, x2)}
            moe_runs = {k: [] for k in moe_fns}
            for k in list(moe_fns) + list(moe_fns)[::-1]:
                moe_runs[k].append(eager_ms(torch, moe_fns[k], iters=5))
            moe_ms[n] = dict(rule=blk.choose_moe_path(moe, n),
                             **{k: statistics.mean(v)
                                for k, v in moe_runs.items()})
            r = moe_runs
            log("timing", f"bf16 MoE layer (16 experts, top-2) at {n} "
                f"tokens (two runs each, in turns): dense (float32 expert "
                f"sums) {r['dense'][0]:.3f} / {r['dense'][1]:.3f} ms, dense "
                f"with the expert outputs rounded to bf16 (the path before "
                f"the repair) {r['dense rounded'][0]:.3f} / "
                f"{r['dense rounded'][1]:.3f} ms, sparse {r['sparse'][0]:.3f}"
                f" / {r['sparse'][1]:.3f} ms; the rule picks "
                f"{moe_ms[n]['rule']}")
    busy = dict(prefill=profile_busy(torch, fns["kernel"], 2,
                                     prefill_ms["kernel"],
                                     "Jamba prefill step",
                                     expect={"mamba_scan_kernel": 7}),
                decode=profile_busy(torch, lambda: serve_step(
                    params, caches, nxt, P), 5, decode_ms,
                    "Jamba decode step"))
    del params, caches
    return dict(serve_launches=serve_launches, launches=step_launches,
                xla_launches=xla_launches, layer_check=worst, spread=spread,
                agree=agree, prefill_ms=prefill_ms, prefill_runs=runs,
                cache_prefill_ms=cache_prefill_ms, decode_ms=decode_ms,
                moe_ms=moe_ms, moe_bf16=moe_bf16, busy=busy,
                init_peak_gb=init_peak,
                step_peak_gb=step_peak, serve_seconds=out["seconds"])


def moe_dense_rounded(torch, params, cfg, x2d):
    """The dense MoE path as the port ran it before its expert outputs kept
    their float32 sums: each expert's output rounded to bf16 (a bf16
    batched product) before the float32 combine.  Timed beside the
    repaired path, and read by the bf16 gate to show what it catches."""
    import torch.nn.functional as F
    from repro_torch.models import blocks as blk
    top_vals, top_idx, aux = blk._moe_gates(params, cfg, x2d)
    combine = torch.zeros((x2d.shape[0], cfg.n_experts), dtype=torch.float32,
                          device=x2d.device).scatter_add_(1, top_idx,
                                                          top_vals)
    gate = torch.matmul(x2d[None], params["w_gate"]).to(x2d.dtype)
    up = torch.matmul(x2d[None], params["w_up"]).to(x2d.dtype)
    y = torch.bmm(F.silu(gate) * up, params["w_down"])
    return blk.einsum("end,ne->nd", y.float(), combine).to(x2d.dtype), aux


def moe_dense_f32_reference(torch, params, cfg, x2d):
    """The bf16 dense MoE path's float32-sum reference: the gate and up
    products as the port forms them, then each expert's down product
    summed in float32 one expert at a time (float32 copies of one
    expert's bf16 weights: the products are exact) and combined in
    float32."""
    import torch.nn.functional as F
    from repro_torch.models import blocks as blk
    top_vals, top_idx, _ = blk._moe_gates(params, cfg, x2d)
    combine = torch.zeros((x2d.shape[0], cfg.n_experts), dtype=torch.float32,
                          device=x2d.device).scatter_add_(1, top_idx,
                                                          top_vals)
    gate = torch.matmul(x2d[None], params["w_gate"]).to(x2d.dtype)
    up = torch.matmul(x2d[None], params["w_up"]).to(x2d.dtype)
    h = F.silu(gate) * up
    del gate, up
    out = torch.zeros((x2d.shape[0], cfg.d_model), dtype=torch.float32,
                      device=x2d.device)
    for e in range(cfg.n_experts):
        out += (h[e].float() @ params["w_down"][e].float()) \
            * combine[:, e:e + 1]
    return out


def phase_moe_dense_bf16(torch, ffn, moe, gen, n: int) -> dict:
    """The bf16 gate of the dense MoE path (one Jamba MoE layer at full
    width, ``n`` tokens): moe_apply_dense against the float32-sum
    reference, within the bf16 gate (atol 2e-1, rtol 3e-1 of its
    float32 values) and with at least MOE_BF16_EQUAL of the bf16 outputs
    equal to the reference rounded to bf16; the path that rounds each
    expert's output to bf16 first is read the same way (printed, not
    gated)."""
    from repro_torch.models import blocks as blk
    with torch.no_grad():
        x2 = torch.randn((n, moe.d_model), generator=gen,
                         device="cuda").bfloat16()
        got, _ = blk.moe_apply_dense(ffn, moe, x2)
        want = moe_dense_f32_reference(torch, ffn, moe, x2)
        old, _ = moe_dense_rounded(torch, ffn, moe, x2)
        torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"bf16 dense MoE: {got.dtype}, finite "
                           f"{bool(torch.isfinite(got).all())}")
    scale = float(want.abs().max())
    out = {}
    for name, y in (("dense", got), ("dense rounded", old)):
        out[name] = dict(
            equal=float((y == want.bfloat16()).float().mean()),
            rel_max=float((y.float() - want).abs().max()) / scale,
            rel_rms=float(((y.float() - want).square().mean()
                           / want.square().mean()).sqrt()))
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    if out["dense"]["equal"] < MOE_BF16_EQUAL:
        raise RuntimeError(f"bf16 dense MoE: {out['dense']['equal']:.4f} of "
                           "the outputs equal the float32-sum reference "
                           f"rounded to bf16, under {MOE_BF16_EQUAL}")
    log("moe_dense_bf16", f"Jamba MoE layer, bf16, {n} tokens (largest "
        f"|out| {scale:.4g}): moe_apply_dense against the float32-sum "
        f"reference: {out['dense']['equal']:.4f} of the outputs equal it "
        f"rounded to bf16, max|err| / max|out| {out['dense']['rel_max']:.3g},"
        f" rms ratio {out['dense']['rel_rms']:.3g}; with the expert outputs "
        f"rounded to bf16 first: {out['dense rounded']['equal']:.4f}, "
        f"{out['dense rounded']['rel_max']:.3g}, "
        f"{out['dense rounded']['rel_rms']:.3g}")
    return out


def time_mamba_kernel(torch, flush) -> dict:
    """mamba_scan (L2 flushed, float32 as on the model path) beside its
    plain version (the sequential oracle, eager: a few launches per step),
    the plain associative scan of the "xla" core (torch ops: the port's
    yardstick, since no single PyTorch call computes a selective scan) and
    its bound: x, dt and y moved once in float32, B, C, A and D read once,
    over the HBM rate, or mamba_scan_flops over the float32 peak, the
    larger."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import blocks as blk
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = {}
    for B, T, di, ds in MAMBA_TIMED:
        args = mamba_inputs(torch, gen, B, T, di, ds, 0.1)
        x, dt, Bc, Cc, A, D = args
        n_bytes = sum(a.numel() * a.element_size() for a in args) \
            + x.numel() * x.element_size()
        b_ms, b_by = bound(n_bytes, ms.mamba_scan_flops(B, T, di, ds),
                           "float32")

        def scan():
            hs = blk._mamba_states(dt, x, Bc, A)
            return torch.einsum("btds,bts->btd", hs, Cc) + x * D

        key = f"{B}x{T}x{di}x{ds}"
        rows[key] = row = dict(
            ms=graph_ms(torch, lambda: ms.mamba_scan(*args), flush, inner=5,
                        reps=7),
            plain_ms=eager_ms(torch, lambda: ms.plain(x, dt, A, Bc, Cc, D),
                              iters=3),
            plain_timing="eager (host launch included)",
            library_ms=eager_ms(torch, scan, iters=3),
            library_call="the plain associative scan (Hillis-Steele, torch "
                         "ops, the \"xla\" core), eager",
            bound_ms=b_ms, bound_by=b_by, dtype="float32",
            shape=[B, T, di, ds])
        log("timing", f"mamba_scan {key} float32: {row['ms']:.4f} ms (L2 "
            f"cold), plain {row['plain_ms']:.4f} ms (eager), library "
            f"{row['library_ms']:.4f} ms ({row['library_call']}), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {n_bytes} bytes)")
        del args, x, dt, Bc, Cc, A, D
    return {"mamba_scan": rows}


# the spin kernel that opens each profiler window (torch.cuda._sleep), about
# 1 ms on an H100, and the part of its device events' key
def phase_mamba_trainable(torch) -> dict:
    """mamba_scan_trainable at Jamba's published Mamba widths
    (MAMBA_TRAIN_SHAPE, float32): one kernel launch in the forward and
    none in the backward, which recomputes through the plain sequential
    oracle; its output and the gradients of x, dt, Bc, Cc, A and D against
    autograd through the plain form on the card (MAMBA_TOL); the forward
    and backward timed (CUDA events, host launch included) after an
    untimed call of each."""
    from repro_torch.kernels import mamba_scan as ms
    B, T, di, ds = MAMBA_TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(39)
    args = mamba_inputs(torch, gen, B, T, di, ds, 0.1)
    cot = torch.randn((B, T, di), generator=gen, device="cuda")

    def plain(x, dt, Bc, Cc, A, D):
        return ms.plain(x, dt, A, Bc, Cc, D)

    out, ms_times = {}, {}
    for name, fn in (("trainable", ms.mamba_scan_trainable),
                     ("plain", plain)):
        # one untimed call first: the process's first backward of these
        # small ops pays their first use
        warm = [a.clone().requires_grad_() for a in args]
        torch.autograd.grad((fn(*warm) * cot).sum(), warm)
        del warm
        leaves = [a.clone().requires_grad_() for a in args]
        before = ms.launches.value
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        y = fn(*leaves)
        e[1].record()
        fwd = ms.launches.value - before
        grads = torch.autograd.grad((y * cot).sum(), leaves)
        e[2].record()
        torch.cuda.synchronize()
        out[name] = (y.detach(), grads, fwd, ms.launches.value - before)
        ms_times[name] = (e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
    (y, g, fwd, total), (want_y, want_g, _, plain_n) = (out["trainable"],
                                                         out["plain"])
    if (fwd, total, plain_n) != (1, 1, 0):
        raise RuntimeError(f"mamba_scan_trainable launched {fwd} in the "
                           f"forward and {total} in all, the plain form "
                           f"{plain_n}: expected 1, 1, 0")
    errs = {"y": max_err(y, want_y)}
    torch.testing.assert_close(y, want_y, **MAMBA_TOL)
    for name, a, b in zip(("x", "dt", "Bc", "Cc", "A", "D"), g, want_g):
        errs[name] = max_err(a, b)
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"mamba_scan_trainable d{name} not finite")
        torch.testing.assert_close(a, b, **MAMBA_TOL,
                                   msg=f"mamba_scan_trainable d{name}")
    log("lm_train", f"mamba_scan_trainable {MAMBA_TRAIN_SHAPE} float32: "
        f"output and the six input gradients within {MAMBA_TOL} of autograd "
        f"through the plain form (max|err| {errs}); forward / backward ms "
        f"(one call each after an untimed one, CUDA events, host included):"
        f" trainable "
        f"{ms_times['trainable'][0]:.3f} / {ms_times['trainable'][1]:.3f} "
        f"(kernel forward, backward recomputed through the sequential "
        f"oracle ref.mamba_ssm: {T} steps), plain {ms_times['plain'][0]:.3f}"
        f" / {ms_times['plain'][1]:.3f}")
    return dict(errs=errs, ms=ms_times)


def adam_slack_check(t: int, moments_a, moments_b, lr: float, want, got,
                     what: str) -> int:
    """Params ``got`` against ``want`` (lists of numpy leaves) after step
    ``t`` of two AdamW runs from equal params and state, at LM_TRAIN_TOL
    plus each element's Adam slack: lr |u_a - u_b|, u = m_hat / (sqrt(
    v_hat) + eps) computed in float64 from each run's own moments
    (``moments_*``: (m, v), lists of numpy leaves).  Adam's normalisation
    turns an element whose gradient is small beside the rounding of its
    sums into a step in another direction, up to 2 lr, while the
    gradients agree.  Raises naming each element outside with its |g| and
    slack; returns how many elements needed their slack."""
    import numpy as np
    c1, c2 = 1 - 0.9 ** t, 1 - 0.95 ** t
    used = 0
    for i, (ma, va, mb, vb, a, b) in enumerate(zip(*moments_a, *moments_b,
                                                   want, got)):
        ma, va, mb, vb, a, b = (np.asarray(x, np.float64)
                                for x in (ma, va, mb, vb, a, b))
        ua = (ma / c1) / (np.sqrt(va / c2) + 1e-8)
        ub = (mb / c1) / (np.sqrt(vb / c2) + 1e-8)
        slack = lr * np.abs(ua - ub)
        err = np.abs(b - a)
        tol = LM_TRAIN_TOL["atol"] + LM_TRAIN_TOL["rtol"] * np.abs(a)
        bad = err > tol + 1.01 * slack
        used += int((err > tol).sum())
        if bad.any():
            raise RuntimeError(
                f"{what}: leaf {i}: {int(bad.sum())} params outside "
                f"{LM_TRAIN_TOL} + their Adam slack: " + ", ".join(
                    f"{tuple(int(j) for j in k)} want {a[tuple(k)]:.7g} got "
                    f"{b[tuple(k)]:.7g} |m| {abs(ma[tuple(k)]):.3g} slack "
                    f"{slack[tuple(k)]:.3g}" for k in np.argwhere(bad)[:5]))
    return used


def train_lockstep(torch, counts: dict, what: str, cfg, batch: dict,
                   per_step: dict, n_steps: int = 2) -> tuple[dict, dict]:
    """make_train_step on ``cfg`` in float32 on the card and on the CPU
    (plain versions), ``n_steps`` steps of lr 1e-3 on ``batch`` (CPU
    tensors) under ``cfg.remat``, in lockstep: the first from one numpy
    parameter tree (lm_from_jax_params, as a reference run would carry
    them over), each later one from the CPU's state after the step before
    on both (RWKV-6's chunked form amplifies float32 rounding by e^|c| and
    a Jamba router's top-k can flip, so two free runs drift apart by more
    than the tolerance in a step or two).  Each step's metrics, first
    moments (0.1 g at the first step) and params within LM_TRAIN_TOL
    (params plus adam_slack_check's slack); the kernels' launches of each
    step on the card must be ``per_step``.  Returns the launches summed
    over the steps and the readings."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import lm_from_jax_params
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def host(tree):
        return [a.detach().cpu().numpy() for a in tree_leaves(tree)]

    step = steps.make_train_step(cfg, opt_cfg)
    tree = lm._tree_map(lambda a: a.numpy(), lm.init_params(
        lm.make_generator(0, "cpu"), cfg))
    p_cpu = lm_from_jax_params(tree, cfg, device="cpu")
    p_card = lm_from_jax_params(tree, cfg, device="cuda")
    o_cpu = adamw.init_state(p_cpu)
    o_card = adamw.init_state(p_card)
    losses, used, m_err, total = [], 0, 0.0, {k: 0 for k in counts}
    for t in range(1, n_steps + 1):
        if t > 1:
            p_card, o_card = (tree_map(lambda a: a.cuda(), x)
                              for x in (p_cpu, o_cpu))
        for c in counts.values():
            c.reset()
        p_card, o_card, m_card = step(p_card, o_card, {
            k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        got = {k: c.value for k, c in counts.items() if c.value}
        for k in got:
            total[k] += got[k]
        if got != per_step:
            raise RuntimeError(f"{what} train step {t} launched {got}, "
                               f"expected {per_step}")
        p_cpu, o_cpu, m_cpu = step(p_cpu, o_cpu, batch)
        a = {k: float(v) for k, v in m_cpu.items()}
        b = {k: float(v) for k, v in m_card.items()}
        for k in a:
            if not (abs(b[k] - a[k]) <= LM_TRAIN_TOL["atol"]
                    + LM_TRAIN_TOL["rtol"] * abs(a[k])):
                raise RuntimeError(f"{what} step {t} {k}: card {b[k]!r}, "
                                   f"CPU {a[k]!r}")
        mom_cpu = tuple(host(o_cpu[k]) for k in ("m", "v"))
        mom_card = tuple(host(o_card[k]) for k in ("m", "v"))
        for x, y in zip(mom_cpu[0], mom_card[0]):
            d = np.abs(y - x)
            m_err = max(m_err, float(d.max()))
            if (d > 0.1 * LM_TRAIN_TOL["atol"]
                    + LM_TRAIN_TOL["rtol"] * np.abs(x)).any():
                raise RuntimeError(f"{what} step {t}: first moments card "
                                   f"vs CPU differ by {float(d.max()):.3g}")
        used += adam_slack_check(t, mom_cpu, mom_card, a["lr"],
                                 host(p_cpu), host(p_card),
                                 f"{what} step {t}")
        losses.append((b["loss"], a["loss"]))
    info = dict(losses_card_cpu=losses, max_m_err=m_err,
                params_needing_slack=used)
    log("lm_train", f"{what}, float32, {n_steps} steps card vs CPU in "
        f"lockstep: (card, CPU) losses {losses}, metrics within "
        f"{LM_TRAIN_TOL}, first moments max|diff| {m_err:.3g}; params: "
        f"{used} outside the tolerance, each within its Adam slack; "
        f"launches a step {per_step}")
    return total, info


def phase_lm_train_reduced(torch, counts: dict) -> dict:
    """make_train_step at each family's REDUCED config (LM_TRAIN_REDUCED)
    in float32, 2 steps card against CPU in lockstep (train_lockstep) on
    batch 2 x 128 under remat "dots", the kernels' launches per step on
    the card asserted."""
    import dataclasses
    from repro_torch import configs
    launches, info = {}, {}
    for arch, (changes, per_step) in LM_TRAIN_REDUCED.items():
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  **changes)
        toks = lm_tokens(cfg, 2, 129, seed=8)
        batch = {k: torch.from_numpy(v) for k, v in dict(
            tokens=toks[:, :-1], labels=toks[:, 1:]).items()}
        launches[arch], info[arch] = train_lockstep(
            torch, counts, f"{arch} REDUCED {changes}", cfg, batch, per_step)
    return dict(launches=launches, info=info)


def phase_lm_train(torch, counts: dict, smi: str) -> dict:
    """InternLM2-1.8B FULL (bf16, 24 layers, flash core, remat "dots")
    trained by launch/train.py: LM_TRAIN["steps"] steps at sequence 4096,
    global batch 2 in 2 micro-batches, from parameters drawn on the card,
    launch counts reset just before and read just after (flash
    LM_TRAIN_FLASH_PER_MICRO a micro-step, nothing else).  Then from the
    trained params and a fresh optimizer state on one batch: the step
    under the softmax core and with accum_steps 1 against the flash step
    (loss and grad norm within LM_TRAIN_BF16_TOL); 4 steps on that batch
    repeated, after which its loss must be below the first step's; step ms
    (CUDA events), tokens/s, peak memory and the device-busy share
    (torch.profiler) of one step; topk_ef's threshold on an
    embedding-sized gradient timed."""
    import dataclasses
    import math
    from repro_torch import configs
    from repro_torch.data import pipeline as data_mod
    from repro_torch.distributed import compression
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves
    per_step = LM_TRAIN_FLASH_PER_MICRO * LM_TRAIN["accum"]
    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    res = train(LM_ARCH, reduced=False, device="cuda",
                overrides=LM_TRAIN_PROFILE, **LM_TRAIN)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {k: c.value for k, c in counts.items()}
    want = dict(flash_attention=per_step * LM_TRAIN["steps"])
    got = {k: v for k, v in train_launches.items() if v}
    if got != want:
        raise RuntimeError(f"launch/train.py on InternLM2 FULL launched "
                           f"{got}, expected {want} ({LM_TRAIN_FLASH_PER_MICRO}"
                           f" flash a micro-step: forward and recompute)")
    losses = res["losses"]
    if len(losses) != LM_TRAIN["steps"] or not all(map(math.isfinite,
                                                       losses)):
        raise RuntimeError(f"launch/train.py losses {losses}")
    log("lm_train", f"launch/train.py, InternLM2-1.8B FULL bf16 "
        f"{LM_TRAIN_PROFILE}, {LM_TRAIN}: losses {losses}, {train_s:.1f} s "
        f"in all (the kernels' first use included); flash launches "
        f"{train_launches['flash_attention']} = {LM_TRAIN['steps']} steps x "
        f"{LM_TRAIN['accum']} micro-steps x {LM_TRAIN_FLASH_PER_MICRO}")

    cfg = dataclasses.replace(configs.get_config(LM_ARCH), **LM_TRAIN_PROFILE)
    params = res.pop("params")
    del res
    opt0 = adamw.init_state(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    pipe = data_mod.TokenPipeline(cfg.vocab, LM_TRAIN["seq"],
                                  LM_TRAIN["global_batch"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch(0).items()}
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=max(
        LM_TRAIN["steps"] // 10, 1), total_steps=LM_TRAIN["steps"])
    flash_step = steps.make_train_step(cfg, opt_cfg,
                                       accum_steps=LM_TRAIN["accum"])

    def one(step, what: str, flash_launches: int):
        for c in counts.values():
            c.reset()
        p, o, m = step(params, opt0, batch)
        torch.cuda.synchronize()
        n = {k: c.value for k, c in counts.items() if c.value}
        w = {"flash_attention": flash_launches} if flash_launches else {}
        if n != w:
            raise RuntimeError(f"{what} launched {n}, expected {w}")
        return p, o, {k: float(v) for k, v in m.items()}, n

    gate_launches = {k: 0 for k in counts}
    soft = one(steps.make_train_step(dataclasses.replace(
        cfg, attn_core="softmax"), opt_cfg, accum_steps=LM_TRAIN["accum"]),
        "the softmax-core step", 0)[2]
    # one micro-step over both sequences
    acc1 = one(steps.make_train_step(cfg, opt_cfg, accum_steps=1),
               "the accum_steps=1 step", LM_TRAIN_FLASH_PER_MICRO)
    gate_launches["flash_attention"] += acc1[3]["flash_attention"]
    acc1 = acc1[2]
    params, opt, first, n = one(flash_step, "the flash step", per_step)
    gate_launches["flash_attention"] += n["flash_attention"]
    del opt0
    tol = LM_TRAIN_BF16_TOL
    for what, other in (("softmax core", soft), ("accum_steps 1", acc1)):
        for k in (("loss", "grad_norm") if what == "softmax core"
                  else ("loss",)):
            a, b = first[k], other[k]
            log("lm_train", f"{what} vs flash accum {LM_TRAIN['accum']}: "
                f"{k} {b!r} vs {a!r} (|diff| {abs(a - b):.3g}; atol "
                f"{tol['atol']}, rtol {tol['rtol']})")
            if not abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b):
                raise RuntimeError(f"{what}: {k} {b!r} vs the flash step's "
                                   f"{a!r}, outside {tol}")

    # the same batch again: steps 2-4 timed, peak memory over them
    rep_losses, step_ms = [first["loss"]], []
    torch.cuda.reset_peak_memory_stats()
    for c in counts.values():
        c.reset()
    for _ in range(LM_TRAIN["steps"] - 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, m = flash_step(params, opt, batch)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        rep_losses.append(float(m["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if counts["flash_attention"].value != per_step * len(step_ms):
        raise RuntimeError(f"{len(step_ms)} repeated steps launched flash "
                           f"{counts['flash_attention'].value} times")
    gate_launches["flash_attention"] += counts["flash_attention"].value
    with torch.no_grad():
        after, _ = lm.loss_fn(params, cfg, batch)
    after = float(after)
    if not all(map(math.isfinite, rep_losses + [after])) or not (
            after < rep_losses[0]):
        raise RuntimeError(f"repeated batch: losses {rep_losses}, after "
                           f"{LM_TRAIN['steps']} steps {after}: not below "
                           "the first")
    med = statistics.median(step_ms)
    tokens = LM_TRAIN["global_batch"] * LM_TRAIN["seq"]
    log("lm_train", f"{smi}: repeated batch, losses {rep_losses}, after "
        f"{LM_TRAIN['steps']} steps {after!r}; step ms (CUDA events, host "
        f"included) {step_ms} (median {med:.1f}, {tokens / med * 1e3:.0f} "
        f"tokens/s, {n_params} params); peak memory over the steps "
        f"{peak_gb:.2f} GB (max_memory_allocated)")
    busy = profile_busy(torch, lambda: flash_step(params, opt, batch), 1,
                        med, "InternLM2 train step",
                        expect={"flash_": per_step})

    # topk_ef's threshold on a gradient the size of the embedding
    g = torch.randn((cfg.padded_vocab, cfg.d_model), device="cuda",
                    dtype=torch.bfloat16)
    ef = torch.zeros(g.shape, device="cuda")
    compression.compress(dict(e=g), "topk_ef", dict(e=ef))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        compression.compress(dict(e=g), "topk_ef", dict(e=ef))
    e1.record()
    e1.synchronize()
    topk_ms = e0.elapsed_time(e1) / 3
    log("lm_train", f"{smi}: compress(topk_ef) of a {tuple(g.shape)} bf16 "
        f"gradient (torch.topk for the k-th largest |acc|, k = "
        f"{int(g.numel() * 0.01)}): {topk_ms:.2f} ms a call (CUDA events)")
    del params, opt, g, ef
    return dict(train_launches=train_launches, gate_launches=gate_launches,
                per_step={"flash_attention": per_step}, losses=losses,
                rep_losses=rep_losses, after=after, soft=soft, acc1=acc1,
                first=first, step_ms=step_ms, median_ms=med,
                tokens_per_s=tokens / med * 1e3, peak_gb=peak_gb,
                busy=busy, topk_ms=topk_ms, train_s=train_s,
                n_params=n_params)



# ---------------------------------------------------------------------------
# the DeepSeek slice: DeepSeekMoE-16B whole, DeepSeek-V3 at 4 layers
# ---------------------------------------------------------------------------

def deepseek_cfg(arch: str, reduced: bool = False, **changes):
    """The config (FULL, DeepSeek-V3 cut to DEEPSEEK_CUT's depth, or
    REDUCED) under the serving profile, with ``changes``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve_lm import serving_profile
    cfg = configs.get_config(arch, reduced=reduced)
    cut = {} if reduced else DEEPSEEK_CUT.get(arch, {})
    cfg = dataclasses.replace(cfg, **serving_profile(cfg), **cut)
    return dataclasses.replace(cfg, **changes)


def read_counts(counts: dict) -> dict:
    return {k: c.value for k, c in counts.items()}


def phase_deepseek_f32(torch, counts: dict) -> dict:
    """The published widths in float32, card (flash kernel) against CPU
    (plain versions), 1 x 128 tokens (S % 128 == 0: the flash branch):
    DeepSeekMoE-16B's first two layers (the dense layer and one MoE layer
    of 64 routed and 2 shared experts) through the prefill step, embedding
    and head included; DeepSeek-V3's first layer (MLA, d 192 / dv 128, and
    the dense FFN of 18432) through layer_apply on a random input.  Each
    within LM_TOL, with 2 and 1 flash launches.  Then on the card the
    cache prefill of the first DEEPSEEK_F32_PREFILL tokens and
    teacher-forced decode to 128 (MLA absorbed; the MoE's dense path, which
    drops nothing, at both token counts) against those forwards, within
    LM_TOL: the decode invariant at full width, where float32 rounds
    finely enough for it to hold (PERF.md section 6, DeepSeek)."""
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    from repro_torch.train import steps
    P = DEEPSEEK_F32_PREFILL
    errs, launches = {}, {k: 0 for k in counts}
    cfg = deepseek_cfg("deepseek_moe_16b", n_layers=2, dtype="float32")
    if {blk.choose_moe_path(cfg.moe_cfg(), n) for n in (1, P, 128)} != {
            "dense"}:
        raise RuntimeError("the MoE rule does not pick dense at 1 x 128")
    params = lm.init_params(lm.make_generator(0, "cuda"), cfg)
    toks = torch.from_numpy(lm_tokens(cfg, 1, 128, seed=11))
    step = steps.make_prefill_step(cfg)
    for c in counts.values():
        c.reset()
    card = step(params, dict(tokens=toks.cuda()))
    torch.cuda.synchronize()
    got = read_counts(counts)
    if {k: v for k, v in got.items() if v} != {"flash_attention": 2}:
        raise RuntimeError(f"DeepSeekMoE 2-layer prefill step launched {got}")
    launches = {k: launches[k] + got[k] for k in counts}
    with torch.no_grad():
        pre, caches = lm.prefill(params, cfg, dict(tokens=toks[:, :P].cuda()),
                                 s_max=128)
        serve, dec = steps.make_serve_step(cfg), []
        for t in range(P, 128):
            _, lg, caches = serve(params, caches, toks[:, t:t + 1].cuda(), t)
            dec.append(lg[:, 0])
    errs["moe_prefill_vs_forward"] = check_lm_close(
        torch, pre, card[:, :P], LM_TOL, f"DeepSeekMoE 2 layers float32: "
        f"cache prefill of {P} tokens vs the forward, card")
    errs["moe_decode_vs_forward"] = check_lm_close(
        torch, torch.stack(dec, dim=1), card[:, P:], LM_TOL, "DeepSeekMoE "
        f"2 layers float32: decode {P} -> 128 vs the forward, card")
    cpu_params = lm._tree_map(lambda a: a.cpu(), params)
    del params, caches
    errs["moe_2_layers"] = check_lm_close(
        torch, card.cpu(), step(cpu_params, dict(tokens=toks)), LM_TOL,
        "DeepSeekMoE-16B widths, 2 layers (dense, MoE), float32, 1 x 128, "
        "card (flash kernel) vs CPU (plain versions)")
    del cpu_params, card
    torch.cuda.empty_cache()

    cfg = deepseek_cfg("deepseek_v3_671b", dtype="float32")
    gen = lm.make_generator(1, "cuda")
    lp = lm.init_layer(gen, cfg, "mla_mlp")
    x = torch.randn((1, 128, cfg.d_model), generator=gen, device="cuda")
    pos = torch.arange(128, device="cuda")[None]
    for c in counts.values():
        c.reset()
    with torch.no_grad():
        card, _ = lm.layer_apply(lp, cfg, "mla_mlp", x, pos)
        torch.cuda.synchronize()
        got = read_counts(counts)
        if {k: v for k, v in got.items() if v} != {"flash_attention": 1}:
            raise RuntimeError(f"one V3 MLA layer launched {got}")
        launches = {k: launches[k] + got[k] for k in counts}
        pre, cache = lm.layer_prefill(lp, cfg, "mla_mlp", x[:, :P],
                                      pos[:, :P], 128)
        dec = []
        for t in range(P, 128):
            y, cache = lm.layer_decode(lp, cfg, "mla_mlp", x[:, t:t + 1],
                                       cache, t)
            dec.append(y)
        errs["v3_prefill_vs_forward"] = check_lm_close(
            torch, pre, card[:, :P], LM_TOL, f"DeepSeek-V3 layer 1 float32: "
            f"MLA cache prefill of {P} tokens vs the forward, card")
        errs["v3_decode_vs_forward"] = check_lm_close(
            torch, torch.cat(dec, dim=1), card[:, P:], LM_TOL, "DeepSeek-V3 "
            f"layer 1 float32: absorbed MLA decode {P} -> 128 vs the "
            "forward, card")
        cpu_lp = lm._tree_map(lambda a: a.cpu(), lp)
        del lp, cache
        cpu, _ = lm.layer_apply(cpu_lp, cfg, "mla_mlp", x.cpu(), pos.cpu())
    errs["v3_mla_layer"] = check_lm_close(
        torch, card.cpu(), cpu, LM_TOL, "DeepSeek-V3 layer 1 (MLA, dense "
        "FFN) at full width, float32, 1 x 128, card (flash kernel, d 192 / "
        "dv 128) vs CPU (plain versions)")
    del cpu_lp, card, cpu
    torch.cuda.empty_cache()
    return dict(errs=errs, launches=launches)


def phase_deepseek_reduced(torch, counts: dict) -> dict:
    """DeepSeekMoE and DeepSeek-V3 REDUCED in float32 under the serving
    profile, card (flash kernel) against CPU (plain versions) from the same
    parameters: the prefill step (batch 2 x 128), the cache prefill of the
    128 tokens and teacher-forced decode_step to 136, logits within 1e-3,
    and the decode against the card's forward over the 136 tokens; the
    launches of each path on the card."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    launches, errs = {}, {}
    for arch in DEEPSEEK_ARCHS:
        cfg = deepseek_cfg(arch, reduced=True)
        params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
        card_params = lm._tree_map(lambda a: a.cuda(), params)
        toks = torch.from_numpy(lm_tokens(cfg, 2, 136, seed=12))
        P = 128

        def run(p, dev):
            out, used = {}, {}
            t = toks.to(dev)
            for path in ("forward", "prefill", "decode", "forward_136"):
                for c in counts.values():
                    c.reset()
                if path == "forward":
                    out[path] = steps.make_prefill_step(cfg)(
                        p, dict(tokens=t[:, :P]))
                elif path == "forward_136":
                    out[path] = steps.make_prefill_step(cfg)(
                        p, dict(tokens=t))
                elif path == "prefill":
                    out[path], caches = lm.prefill(
                        p, cfg, dict(tokens=t[:, :P]), s_max=t.shape[1])
                else:
                    serve, dec = steps.make_serve_step(cfg), []
                    for i in range(P, t.shape[1]):
                        _, lg, caches = serve(p, caches, t[:, i:i + 1], i)
                        dec.append(lg[:, 0])
                    out[path] = torch.stack(dec, dim=1)
                if dev == "cuda":
                    torch.cuda.synchronize()
                used[path] = read_counts(counts)
            return out, used

        card, used = run(card_params, "cuda")
        n, mla = cfg.n_layers, cfg.attn_type == "mla"
        want = dict(forward=dict(flash_attention=n + int(cfg.mtp)),
                    prefill=dict(flash_attention=n) if mla else {},
                    decode={}, forward_136={})
        for path, w in want.items():
            got = {k: v for k, v in used[path].items() if v}
            if got != w:
                raise RuntimeError(f"{arch} reduced {path} launched {got}, "
                                   f"expected {w}")
        cpu, _ = run(params, "cpu")
        for path in card:
            errs[f"{arch}_{path}"] = check_lm_close(
                torch, card[path].cpu(), cpu[path], LM_TOL, f"{arch} reduced,"
                f" float32, {path}, card (flash kernel) vs CPU (plain "
                "versions)")
        errs[f"{arch}_decode_vs_forward"] = check_lm_close(
            torch, card["decode"], card["forward_136"][:, P:], LM_TOL,
            f"{arch} reduced teacher-forced decode vs the forward, card")
        launches.update({f"{arch}_{p}": u for p, u in used.items()})
    return dict(launches=launches, errs=errs)


def phase_deepseek_serve(torch, counts: dict, arch: str) -> dict:
    """``arch`` at full width in bfloat16 under the serving profile
    (DeepSeekMoE-16B whole, DeepSeek-V3 cut to DEEPSEEK_CUT): serve_lm
    (batch 4, prompt 1024, 32 greedy tokens), then from the same seed's
    parameters and prompts the prefill step under the flash core and the
    softmax core, the cache prefill, and DEEPSEEK_DECODE_CHECK decode steps
    fed serve_lm's tokens, with the flash launches of each call
    (DEEPSEEK_FLASH) asserted.  The kernel is gated at every one of its
    calls in the flash step, on that call's own operands, against its
    plain version (phase 2's criteria).  The bf16 logits are read, not
    gated: flash against softmax core, the softmax core against itself
    with layer 1's attention output moved by one bf16 rounding step (what
    the random-init model makes of that), and decode against a forward
    over the prompt and the decoded tokens (PERF.md section 6, DeepSeek;
    phase_deepseek_f32 gates those invariants in float32).  Then the MoE
    path the rule picks and the assignments its capacity drops, the
    timings, device-busy shares and peak memory of the serving path."""
    import dataclasses
    import math
    from repro_torch.kernels import ref
    from repro_torch.launch.serve_lm import serve_lm
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = deepseek_cfg(arch)
    want = DEEPSEEK_FLASH[arch]
    B, P, G, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for c in counts.values():
        c.reset()
    out = serve_lm(arch, reduced=False, batch=B, prompt_len=P, gen=G,
                   seed=seed, device="cuda", overrides=DEEPSEEK_CUT.get(arch),
                   verbose=False)
    torch.cuda.synchronize()
    serve_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    serve_launches = read_counts(counts)
    if serve_launches["flash_attention"] != want["cache_prefill"] or sum(
            serve_launches.values()) != want["cache_prefill"]:
        raise RuntimeError(f"{arch} serve_lm launched {serve_launches}, "
                           f"expected {want['cache_prefill']} flash (its "
                           "cache prefill) and nothing else")
    tokens = out["tokens"]
    if tokens.shape != (B, G) or not ((tokens >= 0) & (tokens < cfg.vocab)
                                      ).all():
        raise RuntimeError(f"{arch} serve_lm tokens {tokens.shape}: {tokens}")
    log("deepseek", f"serve_lm bf16 {cfg.name} ({cfg.n_layers} layers) batch "
        f"{B} prompt {P} gen {G}: {out['seconds']:.2f} s "
        f"({out['tokens_per_s']:.1f} tok/s, first calls included), peak "
        f"{serve_peak:.2f} GB; {serve_launches['flash_attention']} flash "
        f"launches; tokens in [0, {cfg.vocab}); first row "
        f"{tokens[0].tolist()}")

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(lm.make_generator(seed, "cuda"), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in lm._leaves(params))
    n_bytes = sum(a.numel() * a.element_size() for a in lm._leaves(params))
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log("deepseek", f"{cfg.name} init_params: {n_params} parameters, "
        f"{n_bytes / 1e9:.2f} GB, {init_s:.1f} s; peak {init_peak:.2f} GB")
    if n_params != DEEPSEEK_PARAMS[arch]:
        raise RuntimeError(f"{arch} has {n_params} parameters, expected "
                           f"{DEEPSEEK_PARAMS[arch]}")

    # the assignments the sparse path's capacity drops, call by call
    moe = cfg.moe_cfg()
    drops, orig_sparse = [], blk.moe_apply_sparse

    def counted(p, mcfg, x2d):
        _, idx, _ = blk._moe_gates(p, mcfg, x2d)
        C = max(math.ceil(x2d.shape[0] * mcfg.top_k / mcfg.n_experts
                          * mcfg.capacity_factor), 1)
        load = torch.bincount(idx.reshape(-1), minlength=mcfg.n_experts)
        drops.append(int((load - C).clamp_min(0).sum()))
        return orig_sparse(p, mcfg, x2d)

    batch = dict(tokens=torch.from_numpy(lm_tokens(cfg, B, P, seed)).cuda())
    flash_step = steps.make_prefill_step(cfg)
    soft_step = steps.make_prefill_step(dataclasses.replace(
        cfg, attn_core="softmax"))
    K = DEEPSEEK_DECODE_CHECK
    gen_toks = torch.from_numpy(tokens[:, :K].copy()).cuda()
    serve_step = steps.make_serve_step(cfg)
    blk.moe_apply_sparse = counted
    try:
        for c in counts.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        flash = flash_step(params, batch)
        torch.cuda.synchronize()
        step_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        step_launches = read_counts(counts)
        step_drops, drops[:] = list(drops), []
        for c in counts.values():
            c.reset()
        soft = soft_step(params, batch)
        torch.cuda.synchronize()
        soft_launches = read_counts(counts)
        drops[:] = []
        for c in counts.values():
            c.reset()
        with torch.no_grad():
            lg_p, caches = lm.prefill(params, cfg, batch, s_max=P + G)
        torch.cuda.synchronize()
        prefill_launches = read_counts(counts)
        prefill_drops, drops[:] = list(drops), []
        dec = []
        for i in range(K):
            _, lg, caches = serve_step(params, caches, gen_toks[:, i:i + 1],
                                       P + i)
            dec.append(lg[:, 0])
        torch.cuda.synchronize()
        decode_launches = {k: v - prefill_launches[k]
                           for k, v in read_counts(counts).items()}
        full = soft_step(params, dict(tokens=torch.cat(
            [batch["tokens"], gen_toks], dim=1)))
        torch.cuda.synchronize()
        full_drops = list(drops)
    finally:
        blk.moe_apply_sparse = orig_sparse
    paths = {n: blk.choose_moe_path(moe, n) for n in (B * P, B * (P + K),
                                                      B)}
    log("deepseek", f"{cfg.name}: the MoE rule picks {paths} (tokens -> "
        f"path); assignments dropped at capacity factor "
        f"{moe.capacity_factor}, per MoE layer: prefill step "
        f"{step_drops} (of {B * P * moe.top_k} each), cache prefill "
        f"{prefill_drops}, forward over {P + K} tokens {full_drops}")
    for name, got, n in (("prefill step", step_launches, want["step"]),
                         ("softmax-core step", soft_launches, 0),
                         ("cache prefill", prefill_launches,
                          want["cache_prefill"]),
                         ("decode", decode_launches, 0)):
        only_flash(got, n, f"{arch} {name}")
    for name, t in (("flash", flash), ("softmax", soft), ("forward", full)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{arch} {name} logits are not finite")
    if flash.shape != (B, P, cfg.padded_vocab) or soft.shape != flash.shape:
        raise RuntimeError(f"{arch} logits {tuple(flash.shape)}, "
                           f"{tuple(soft.shape)}")

    # the softmax core with layer 1's attention output moved by one bf16
    # rounding step (relative 2^-8): what two right bf16 paths may differ by
    orig_mha, hits = ref.mha, []

    def nudged(*a, **kw):
        o = orig_mha(*a, **kw)
        if not hits:
            o = o * (1 + 2 ** -8)
        hits.append(1)
        return o

    # the kernel at every call of the flash step, on its own operands
    seen = flash_calls_checked(torch, lambda: flash_step(params, batch),
                               f"{cfg.name} bf16")
    worst = dict(calls=seen["calls"], err=seen["err"])
    if worst["calls"] != want["step"]:
        raise RuntimeError(f"{arch}: {worst['calls']} checked flash calls")
    log("deepseek", f"{cfg.name}: every flash call of the bf16 prefill step "
        f"({worst['calls']}) within phase 2's criteria of its plain version "
        f"on its own operands; largest max|err| {worst['err']:.3g}")
    ref.mha = nudged
    try:
        nudge = soft_step(params, batch)
    finally:
        ref.mha = orig_mha
    spread = dict(flash_vs_softmax_rms=rms_ratio(flash, soft),
                  flash_vs_softmax_max=max_err(flash, soft),
                  nudged_vs_softmax_rms=rms_ratio(nudge, soft),
                  nudged_vs_softmax_max=max_err(nudge, soft),
                  prefill_vs_forward_rms=rms_ratio(lg_p[:, -1],
                                                   full[:, P - 1]),
                  decode_vs_forward_rms=rms_ratio(torch.stack(dec, dim=1),
                                                  full[:, P:P + K]),
                  decode_vs_forward_max=max_err(torch.stack(dec, dim=1),
                                                full[:, P:P + K]),
                  max_logit=float(soft.float().abs().max()))
    log("deepseek", "{name} bf16 logits, batch {B} x {P} (read, not gated): "
        "flash vs softmax core RMS ratio {flash_vs_softmax_rms:.3g}, "
        "max|diff| {flash_vs_softmax_max:.3g}; the softmax core with layer "
        "1's attention output moved by 2^-8 vs itself RMS ratio "
        "{nudged_vs_softmax_rms:.3g}, max|diff| {nudged_vs_softmax_max:.3g}"
        "; cache prefill's last logits vs the forward over {PK} tokens RMS "
        "ratio {prefill_vs_forward_rms:.3g}; decode of serve_lm's first {K} "
        "tokens vs that forward RMS ratio {decode_vs_forward_rms:.3g}, "
        "max|diff| {decode_vs_forward_max:.3g} (max|logit| {max_logit:.3g})"
        .format(name=cfg.name, B=B, P=P, PK=P + K, K=K, **spread))
    top_f = flash[:, -1, :cfg.vocab].argmax(-1).cpu()
    top_s = soft[:, -1, :cfg.vocab].argmax(-1).cpu()
    first = torch.from_numpy(tokens[:, 0]).long()
    agree = dict(last_argmax_flash_vs_softmax=int((top_f == top_s).sum()),
                 serve_first_token_vs_flash=int((first == top_f).sum()),
                 of=B)
    log("deepseek", "last-position argmax agreement (of {of}): flash vs "
        "softmax core {last_argmax_flash_vs_softmax}; serve_lm's first "
        "greedy token vs the flash step's argmax "
        "{serve_first_token_vs_flash}".format(**agree))
    del flash, soft, nudge, full, lg_p, dec

    # timing (CUDA events, host launch included), the two cores in turns
    runs = {"flash": [], "softmax": []}
    fns = {"flash": lambda: flash_step(params, batch),
           "softmax": lambda: soft_step(params, batch)}
    for name in ("flash", "softmax", "softmax", "flash"):
        runs[name].append(eager_ms(torch, fns[name], iters=3))
    prefill_ms = {k: statistics.mean(v) for k, v in runs.items()}
    nxt = gen_toks[:, -1:]
    decode_ms = eager_ms(torch, lambda: serve_step(params, caches, nxt,
                                                   P + K), iters=10)
    n_moe = sum(n for kind, n in cfg.layer_groups() if kind.endswith("moe"))
    expert_bytes = (n_moe * moe.n_experts * 3 * moe.d_model
                    * moe.d_ff_expert * 2)
    floor_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    tok = B * P
    log("timing", f"{cfg.name} bf16 prefill step, batch {B} x {P} (CUDA "
        f"events, host included, two runs each in turns): flash "
        f"{runs['flash'][0]:.3f} / {runs['flash'][1]:.3f} ms "
        f"({tok / prefill_ms['flash'] * 1e3:.0f} tokens/s), softmax core "
        f"{runs['softmax'][0]:.3f} / {runs['softmax'][1]:.3f} ms "
        f"({tok / prefill_ms['softmax'] * 1e3:.0f} tokens/s); decode step "
        f"(batch {B}, the rule's {paths[B]} path over all {moe.n_experts} "
        f"experts) {decode_ms:.3f} ms per token, against "
        f"{floor_ms:.3f} ms to read the {n_moe} MoE layers' routed expert "
        f"weights ({expert_bytes / 1e9:.2f} GB) once at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; peak memory of the step "
        f"{step_peak:.2f} GB above the baseline")
    busy = dict(prefill=profile_busy(torch, fns["flash"], 2,
                                     prefill_ms["flash"],
                                     f"{cfg.name} prefill step",
                                     expect={want["fn"]: want["step"]}),
                decode=profile_busy(torch, lambda: serve_step(
                    params, caches, nxt, P + K), 5, decode_ms,
                    f"{cfg.name} decode step"))
    del params, caches
    torch.cuda.empty_cache()
    return dict(serve_launches=serve_launches, launches=step_launches,
                soft_launches=soft_launches,
                prefill_launches=prefill_launches,
                decode_launches=decode_launches, kernel_check=worst,
                spread=spread, agree=agree, paths=paths,
                drops=dict(step=step_drops, prefill=prefill_drops,
                           forward=full_drops),
                prefill_ms=prefill_ms, prefill_runs=runs,
                decode_ms=decode_ms, decode_floor_ms=floor_ms, busy=busy,
                serve_seconds=out["seconds"], serve_peak_gb=serve_peak,
                init_peak_gb=init_peak, step_peak_gb=step_peak)


def time_mla_flash(torch, flush) -> dict:
    """flash_attention at MLA's prefill shape MLA_TIMED (d 192 / dv 128:
    the CUDA-core path), bfloat16, causal, L2 flushed, checked against its
    plain version first; beside the plain version, every
    F.scaled_dot_product_attention backend that takes dv != d (each
    checked, the fastest is the row's library time) and the bound: q, k, v
    read once and o written once over the HBM rate, or the causal half of
    2 S^2 (d + dv) operations per head over the bf16 tensor-core peak, the
    larger."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    B, H, S, d, dv = MLA_TIMED
    gen = torch.Generator(device="cuda").manual_seed(29)
    q, k = (torch.randn((B, H, S, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    v = torch.randn((B, H, S, dv), generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    want = fa.plain(q, k, v, causal=True, scale=scale)
    check_flash_close(torch, fa.flash_attention(q, k, v, scale=scale), want,
                      f"flash_attention at MLA's shape {MLA_TIMED}, bfloat16")
    libs = {}
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION):
        def lib(be=be):
            with sdpa_kernel(be):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      scale=scale)
        try:
            y = lib()
            torch.cuda.synchronize()
        except RuntimeError as e:      # the backend refuses dv != d
            log("timing", f"SDPA {be.name} at {MLA_TIMED}: refused "
                f"({str(e).splitlines()[0][:120]})")
            continue
        torch.testing.assert_close(y.float(), want.float(),
                                   **FLASH_TOL["bfloat16"])
        libs[be.name] = graph_ms(torch, lib, flush, inner=5, reps=7)
    n_bytes = (q.numel() + k.numel() + 2 * v.numel()) * 2   # o is v-sized
    b_ms, b_by = bound(n_bytes, 2.0 * B * H * S * S * (d + dv) / 2,
                       "bfloat16")
    best = min(libs, key=libs.get) if libs else None
    r = dict(ms=graph_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                           scale=scale),
                         flush, inner=2, reps=7),
             plain_ms=graph_ms(torch, lambda: fa.plain(q, k, v, scale=scale),
                               flush, inner=2, reps=5),
             library_ms=libs.get(best), library_call=(
                 f"F.scaled_dot_product_attention(q, k, v, is_causal=True, "
                 f"scale=d ** -0.5) under {best}" if best else "none takes "
                 "dv != d"), library_ms_by_backend=libs,
             bound_ms=b_ms, bound_by=b_by, dtype="bfloat16",
             shape=[B, H, H, S, S, d, dv])
    log("timing", f"flash_attention at MLA's shape {MLA_TIMED} bfloat16 "
        f"(CUDA-core path): {r['ms']:.4f} ms (L2 cold), plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms "
        f"({r['library_call']}; by backend {libs}), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return {"x".join(str(n) for n in (B, H, H, S, d, dv)): r}


# ---------------------------------------------------------------------------
# the last two LM families: Qwen2-VL-7B (M-RoPE) and Whisper-large-v3
# (encoder-decoder), each through the flash kernel
# ---------------------------------------------------------------------------

def mm_cfg(arch: str, reduced: bool = False, **changes):
    """The config (FULL or REDUCED) under the serving profile (flash core),
    with ``changes``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve_lm import serving_profile
    cfg = configs.get_config(arch, reduced=reduced)
    cfg = dataclasses.replace(cfg, **serving_profile(cfg))
    return dataclasses.replace(cfg, **changes)


def mm_batch(torch, cfg, B: int, S: int, seed: int, image: dict | None,
             dev: str = "cuda", labels: bool = False) -> dict:
    """data.pipeline.stub_batch (Qwen2-VL's stub embeddings with
    ``image``'s M-RoPE positions or text positions, or Whisper's stub
    frames and decoder tokens) on ``dev``, with its labels only where
    ``labels``."""
    from repro_torch.data.pipeline import stub_batch
    out = stub_batch(cfg, B, S, seed, image)
    if not labels:
        del out["labels"]
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def flash_calls_checked(torch, fn, what: str) -> dict:
    """Runs ``fn()`` with every flash_attention call held against its plain
    version on that call's own operands (phase 2's criteria,
    check_flash_close); returns the calls, the largest max|err| and each
    call's (B, Hq, Hkv, Sq, Skv, d, dv)."""
    from repro_torch.kernels import flash_attention as fa
    orig, seen = fa.flash_attention, dict(err=0.0, calls=0, shapes=[])

    def checked(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        seen["err"] = max(seen["err"], check_flash_close(
            torch, o, fa.plain(q, k, v, causal=kw.get("causal", True),
                               scale=kw.get("scale")),
            f"{what} flash call {seen['calls']} (B, H, S, d, dv) "
            f"{tuple(q.shape) + (v.shape[-1],)}", quiet=True))
        seen["calls"] += 1
        seen["shapes"].append((q.shape[0], q.shape[1], k.shape[1],
                               q.shape[2], k.shape[2], q.shape[3],
                               v.shape[3]))
        return o

    fa.flash_attention = checked
    try:
        fn()
    finally:
        fa.flash_attention = orig
    return seen


def only_flash(got: dict, n: int, what: str) -> None:
    """Raises unless ``got`` (launch counts) is ``n`` flash launches and
    nothing else."""
    if got["flash_attention"] != n or sum(got.values()) != n:
        raise RuntimeError(f"{what} launched {got}, expected {n} flash and "
                           "nothing else")


def phase_mm_reduced(torch, counts: dict) -> dict:
    """Qwen2-VL and Whisper REDUCED under the serving profile (flash core),
    batch 2 x 128 (Qwen2-VL with one image's three distinct position
    streams, Whisper over its 32 encoder frames): the prefill step on the
    card (flash kernel) against the CPU (plain versions) from the same
    parameters, float32 within LM_TOL and bfloat16 within LM_BF16_TOL and
    LM_BF16_RMS, one flash launch a layer with attention through the
    kernel (3; Whisper's 2 decoder layers); then MM_TRAIN_REDUCED's
    float32 train steps, 3 in lockstep card against CPU
    (train_lockstep)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import steps
    image = dict(text=16, rows=8, cols=12, after=16)
    launches, errs, info = {}, {}, {}
    for arch, (changes, per_step) in MM_TRAIN_REDUCED.items():
        n_flash = per_step["flash_attention"] // 2
        for dtype in ("float32", "bfloat16"):
            cfg = mm_cfg(arch, reduced=True, dtype=dtype)
            params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
            card_params = lm._tree_map(lambda a: a.cuda(), params)
            batch = mm_batch(torch, cfg, 2, 128, 13, image, dev="cpu")
            step = steps.make_prefill_step(cfg)
            for c in counts.values():
                c.reset()
            card = step(card_params, {k: v.cuda() for k, v in batch.items()})
            torch.cuda.synchronize()
            launches[f"{arch}_prefill_step_{dtype}"] = read_counts(counts)
            only_flash(read_counts(counts), n_flash,
                       f"{arch} reduced {dtype} prefill step")
            cpu = step(params, batch)
            tol, rms = ((LM_TOL, None) if dtype == "float32"
                        else (LM_BF16_TOL, LM_BF16_RMS))
            errs[f"{arch}_{dtype}"] = check_lm_close(
                torch, card.cpu(), cpu, tol, f"{arch} reduced, {dtype}, "
                "prefill step 2 x 128, card (flash kernel) vs CPU (plain "
                "versions)", rms=rms)
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  **changes)
        batch = mm_batch(torch, cfg, 2, 128, 14, image, dev="cpu",
                         labels=True)
        launches[f"{arch}_train"], info[arch] = train_lockstep(
            torch, counts, f"{arch} REDUCED {changes}", cfg, batch, per_step,
            n_steps=3)
    return dict(launches=launches, errs=errs, info=info)


def phase_full_model(torch, counts: dict, card: str, tag: str, arch: str,
                     n_params_want: int, B: int, S: int, G: int, batch_fn,
                     decode_fn, f32_batch_fn, f32_decode_fn=None) -> dict:
    """One of the last two families' models FULL in bfloat16 under the
    serving profile, whole, at batch ``B`` with ``S`` decoder tokens
    (``batch_fn(cfg)``: the batch and its description): init_params'
    parameter count (``n_params_want``) and peak memory; the prefill step
    under the flash core (MM_FLASH[arch] launches, each held against its
    plain version on its own operands, every one at the decoder's causal
    (B, Hq, Hkv, S, S, d, d)) and under the softmax core (0); flash
    against the softmax core at LM_BF16_TOL / LM_BF16_RMS and against a
    float32 softmax-core step on the same (bf16-valued) parameters no
    further than LM_BF16_SPREAD times the softmax core (InternLM2's
    [lm_serve] gates); ``G`` make_serve_step decodes from
    ``decode_fn(params, cfg, batch)`` (0 launches; it returns the caches,
    the token feed, the first position, the cache length and the cache
    prefill's logits or None).  Then in float32 at full width (the bf16
    copy freed) on ``f32_batch_fn(cfg32)``: the flash step (the kernel's
    float32 path) against the softmax core within F32_TOL, and
    ``f32_decode_fn(p32, cfg32, batch, flash_logits)``'s checks (0
    launches with the softmax step).  Prefill ms and tokens/s, decode ms a
    token, device-busy shares and peak memory."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = mm_cfg(arch)
    want = MM_FLASH[arch]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(lm.make_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in lm._leaves(params))
    init_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if n_params != n_params_want:
        raise RuntimeError(f"{cfg.name} has {n_params} parameters, expected "
                           f"{n_params_want}")
    batch, what = batch_fn(cfg)
    log(tag, f"{card}: {cfg.name} init_params {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16), {init_s:.1f} s, peak "
        f"{init_peak:.2f} GB; {what}")
    flash_step = steps.make_prefill_step(cfg)
    soft_step = steps.make_prefill_step(dataclasses.replace(
        cfg, attn_core="softmax"))
    serve_step = steps.make_serve_step(cfg)

    for c in counts.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    flash = flash_step(params, batch)
    torch.cuda.synchronize()
    step_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    step_launches = read_counts(counts)
    only_flash(step_launches, want["step"], f"{cfg.name} prefill step")
    for c in counts.values():
        c.reset()
    soft = soft_step(params, batch)
    torch.cuda.synchronize()
    soft_launches = read_counts(counts)
    only_flash(soft_launches, 0, f"{cfg.name} softmax-core prefill step")
    for c in counts.values():
        c.reset()
    t0 = time.perf_counter()
    with torch.no_grad():
        caches, feed, pos0, cache_len, lg_p = decode_fn(params, cfg, batch)
    dec = []
    for i in range(G):
        _, lg, caches = serve_step(params, caches, feed(i), pos0 + i)
        dec.append(lg[:, 0])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = read_counts(counts)
    only_flash(serve_launches, 0, f"{cfg.name} decode")
    dec = torch.stack(dec, dim=1)
    for name, t in (("flash", flash), ("softmax", soft), ("prefill", lg_p),
                    ("decode", dec)):
        if t is not None and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{cfg.name} {name} logits are not finite")
    if flash.shape != (B, S, cfg.padded_vocab) or dec.shape != (
            B, G, cfg.padded_vocab):
        raise RuntimeError(f"{cfg.name} logits {tuple(flash.shape)}, "
                           f"decode {tuple(dec.shape)}")

    seen = flash_calls_checked(torch, lambda: flash_step(params, batch),
                               f"{cfg.name} bf16")
    shape = (B, cfg.n_heads, cfg.kv_heads, S, S, cfg.head_dim, cfg.head_dim)
    if seen["calls"] != want["step"] or set(seen["shapes"]) != {shape}:
        raise RuntimeError(f"{cfg.name}: {seen['calls']} checked flash "
                           f"calls at {set(seen['shapes'])}")
    log(tag, f"every flash call of the bf16 prefill step ({seen['calls']}, "
        f"all at the decoder's (B, Hq, Hkv, Sq, Skv, d, dv) {shape}) within "
        f"phase 2's criteria of its plain version on its own operands; "
        f"largest max|err| {seen['err']:.3g}")
    p32 = to_float32(params)
    ref32 = steps.make_prefill_step(dataclasses.replace(
        cfg, dtype="float32", attn_core="softmax"))(p32, batch)
    spread = dict(flash_vs_float32=rms_ratio(flash, ref32),
                  softmax_vs_float32=rms_ratio(soft, ref32),
                  flash_vs_float32_max=max_err(flash, ref32),
                  softmax_vs_float32_max=max_err(soft, ref32))
    del ref32
    log(tag, "bfloat16 against the float32 softmax core: RMS ratio flash "
        "{flash_vs_float32:.3g}, softmax {softmax_vs_float32:.3g}; max|diff| "
        "flash {flash_vs_float32_max:.3g}, softmax "
        "{softmax_vs_float32_max:.3g}".format(**spread))
    err = check_lm_close(torch, flash, soft, LM_BF16_TOL,
                         f"{cfg.name} bfloat16, flash prefill step vs "
                         f"softmax core, {what}", rms=LM_BF16_RMS)
    if not (spread["flash_vs_float32"]
            <= LM_BF16_SPREAD * spread["softmax_vs_float32"]):
        raise RuntimeError(f"bfloat16 flash core is further from float32 "
                           f"than {LM_BF16_SPREAD} x the softmax core's: "
                           f"{spread}")
    del flash, soft, lg_p, dec

    runs = {"flash": [], "softmax": []}
    fns = {"flash": lambda: flash_step(params, batch),
           "softmax": lambda: soft_step(params, batch)}
    for name in ("flash", "softmax", "softmax", "flash"):
        runs[name].append(eager_ms(torch, fns[name], iters=3))
    prefill_ms = {k: statistics.mean(v) for k, v in runs.items()}
    nxt, last = feed(G - 1), pos0 + G - 1
    decode_ms = eager_ms(torch, lambda: serve_step(params, caches, nxt, last),
                         iters=10)
    frames = (f", {B * cfg.encoder_seq / prefill_ms['flash'] * 1e3:.0f} "
              "encoder frames/s" if cfg.family == "encdec" else "")
    log("timing", f"{card}: {cfg.name} bf16 prefill step, {what} (CUDA "
        f"events, host included, two runs each in turns): flash "
        f"{runs['flash'][0]:.3f} / {runs['flash'][1]:.3f} ms "
        f"({B * S / prefill_ms['flash'] * 1e3:.0f} tokens/s{frames}), "
        f"softmax core {runs['softmax'][0]:.3f} / {runs['softmax'][1]:.3f} "
        f"ms ({B * S / prefill_ms['softmax'] * 1e3:.0f} tokens/s); decode "
        f"step (batch {B}, cache {cache_len}) {decode_ms:.3f} ms per token "
        f"(the weights read once: "
        f"{n_params * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms); {G} decode steps "
        f"{serve_s:.2f} s (first calls); peak memory of the step "
        f"{step_peak:.2f} GB above the baseline")
    busy = dict(prefill=profile_busy(torch, fns["flash"], 2,
                                     prefill_ms["flash"],
                                     f"{cfg.name} prefill step",
                                     expect={want["fn"]: want["step"]}),
                decode=profile_busy(torch, lambda: serve_step(
                    params, caches, nxt, last), 5, decode_ms,
                    f"{cfg.name} decode step"))
    del params, caches, batch
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b32, what32 = f32_batch_fn(cfg32)
    for c in counts.values():
        c.reset()
    flash32 = steps.make_prefill_step(cfg32)(p32, b32)
    torch.cuda.synchronize()
    f32_launches = read_counts(counts)
    only_flash(f32_launches, want["step"], f"{cfg.name} float32 step")
    for c in counts.values():
        c.reset()
    soft32 = steps.make_prefill_step(dataclasses.replace(
        cfg32, attn_core="softmax"))(p32, b32)
    errs = dict(flash_vs_softmax=check_lm_close(
        torch, flash32, soft32, F32_TOL, f"{cfg.name} float32, flash step "
        f"vs softmax core, {what32}"))
    del soft32
    if f32_decode_fn is not None:
        errs.update(f32_decode_fn(p32, cfg32, b32, flash32))
    torch.cuda.synchronize()
    other = read_counts(counts)
    only_flash(other, 0, f"{cfg.name} float32 softmax core"
               + (", prefill, decode" if f32_decode_fn else ""))
    del p32, flash32, b32
    torch.cuda.empty_cache()
    return dict(launches=step_launches, soft_launches=soft_launches,
                serve_launches=serve_launches, f32_launches=f32_launches,
                f32_other_launches=other, kernel_check=dict(
                    calls=seen["calls"], err=seen["err"]), err=err,
                spread=spread, f32_errs=errs, prefill_ms=prefill_ms,
                prefill_runs=runs, decode_ms=decode_ms, busy=busy,
                init_peak_gb=init_peak, step_peak_gb=step_peak)


def phase_qwen2_vl(torch, counts: dict, card: str) -> dict:
    """Qwen2-VL-7B (28 layers) through phase_full_model at batch 4 x 1024
    with one image per prompt (QWEN_IMAGE: three distinct position
    streams, so M-RoPE is not RoPE): 28 flash launches a prefill step; the
    cache prefill and 32 decode steps fed stub embeddings (decode rotates
    by the scalar pos on all three streams, ROADMAP section 3 fault 17).
    In float32 with text positions, batch 2 x 512 (QWEN_F32): also the
    cache prefill of 480 tokens and teacher-forced decode to 512 against
    the flash step within F32_TOL."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    B, G = SERVE["batch"], SERVE["gen"]
    P = QWEN_IMAGE["text"] + QWEN_IMAGE["rows"] * QWEN_IMAGE["cols"] + \
        QWEN_IMAGE["after"]
    f = QWEN_F32

    def batch_fn(cfg):
        batch = mm_batch(torch, cfg, B, P, 0, QWEN_IMAGE)
        pos = batch["positions"]
        if torch.equal(pos[0], pos[1]) or torch.equal(pos[1], pos[2]):
            raise RuntimeError("the image's position streams are not "
                               "distinct")
        return batch, (f"batch {B} x {P} embeds, one image, positions "
                       f"t/h/w max {[int(pos[i].max()) for i in range(3)]}")

    def decode_fn(params, cfg, batch):
        gen = mm_batch(torch, cfg, B, G, 1, None)["embeds"]
        lg_p, caches = lm.prefill(params, cfg, batch, s_max=P + G)
        return caches, lambda i: gen[:, i:i + 1], P, P + G, lg_p

    def f32_batch_fn(cfg32):
        return (mm_batch(torch, cfg32, f["batch"], f["seq"], 2, None),
                f"batch {f['batch']} x {f['seq']}, text positions")

    def f32_decode_fn(p32, cfg32, b32, flash32):
        emb, Pf = b32["embeds"], f["prefill"]
        with torch.no_grad():
            pre, caches = lm.prefill(p32, cfg32, dict(embeds=emb[:, :Pf]),
                                     s_max=f["seq"])
        serve32, dec = steps.make_serve_step(cfg32), []
        for t in range(Pf, f["seq"]):
            _, lg, caches = serve32(p32, caches, emb[:, t:t + 1], t)
            dec.append(lg[:, 0])
        return dict(
            prefill_vs_forward=check_lm_close(
                torch, pre, flash32[:, :Pf], F32_TOL, f"{cfg32.name} float32 "
                f"cache prefill of {Pf} tokens vs the flash step"),
            decode_vs_forward=check_lm_close(
                torch, torch.stack(dec, dim=1), flash32[:, Pf:], F32_TOL,
                f"{cfg32.name} float32 teacher-forced decode {Pf} -> "
                f"{f['seq']} vs the flash step"))

    return phase_full_model(torch, counts, card, "qwen2_vl", QWEN_ARCH,
                            QWEN_PARAMS, B, P, G, batch_fn, decode_fn,
                            f32_batch_fn, f32_decode_fn)


def phase_whisper(torch, counts: dict, card: str) -> dict:
    """Whisper-large-v3 (32 + 32 layers) through phase_full_model at batch
    8 x 1500 encoder frames x 384 decoder tokens: 32 flash launches a
    prefill step, all the decoder's causal self-attention (none from the
    encoder or the cross-attention); 32 decode steps from init_cache (the
    reference has no cache prefill for encoder-decoder models, and its
    cross k/v stay zero: ROADMAP section 3 fault 18); in float32 the same
    batch."""
    from repro_torch.models import lm
    B, S, G = (WHISPER_SERVE[k] for k in ("batch", "dec_len", "gen"))

    def batch_fn(cfg):
        return mm_batch(torch, cfg, B, S, 0, None), (
            f"batch {B} x {cfg.encoder_seq} frames x {S} tokens")

    def decode_fn(params, cfg, batch):
        caches = lm.init_cache(cfg, B, WHISPER_DEC_POSITIONS, device="cuda")
        return (caches, lambda i: batch["tokens"][:, i:i + 1], 0,
                WHISPER_DEC_POSITIONS, None)

    return phase_full_model(torch, counts, card, "whisper", WHISPER_ARCH,
                            WHISPER_PARAMS, B, S, G, batch_fn, decode_fn,
                            batch_fn)


def phase_mesh(torch, counts: dict, card: str, lm_train: dict) -> dict:
    """The mesh tools on one card.  The dry-run grid (every (arch x shape)
    cell of configs.ARCHS x configs.SHAPES on the abstract 16 x 16 mesh,
    launch/dryrun.py on meta tensors) and the count of InternLM2-1.8B
    FULL's train step at [lm_train]'s shape run on MESH_WORKERS spawned
    processes while this process does (a) the spec trees: every FULL
    config's params and decode_32k caches resolved on the abstract 16 x 16
    and 2 x 16 x 16 meshes, fallback notes counted; (b) launch/train.py on
    host_local_mesh("cuda") (InternLM2 REDUCED, flash core, MESH_TRAIN),
    losses and params equal to the same run without use_mesh= bit for bit
    (deterministic algorithms), MESH_FLASH_PER_STEP flash launches a step;
    (c) the elastic protocol: a mesh run crashed before step MESH_CRASH_AT
    (checkpointed there), plan_rescale(1, 1, global batch), make_mesh of
    its shape on the card, and train(use_mesh=) resumed (its restore places
    every leaf through the new mesh's shardings): the uninterrupted run's
    losses and params bit for bit; a mesh of more devices than the card
    count and placing onto the abstract mesh raise.  Then (d) the grid's
    ok / skipped / FAILED counts and each cell's flops and bytes (any
    FAILED cell fails the phase) and (e) the dry-run's FLOPs of the
    [lm_train] step over its measured median ms: TFLOP/s and the share of
    the card's dense bf16 peak, beside the card's name and power limit."""
    import dataclasses
    import tempfile
    import threading
    from repro_torch import configs
    from repro_torch.data import pipeline as data_mod
    from repro_torch.distributed import SimulatedCrash, elastic
    from repro_torch.launch import dryrun, sharding, specs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    single = mesh_mod.make_production_mesh()
    meshes = (single, mesh_mod.make_production_mesh(multi_pod=True))
    lm_cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                                 remat=LM_TRAIN_PROFILE["remat"])
    grid: dict = {}

    def run_grid(pool):
        try:
            grid["results"] = dryrun.run(configs.ARCHS, list(configs.SHAPES),
                                         [single], pool=pool, verbose=False)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            grid["error"] = e

    pool = dryrun.spawn_pool(MESH_WORKERS)
    try:
        # the [lm_train] count first: the grid's longest cells follow it
        e_future = pool.submit(dryrun.count_step, lm_cfg, "train",
                               LM_TRAIN["seq"], LM_TRAIN["global_batch"],
                               accum=LM_TRAIN["accum"])
        runner = threading.Thread(target=run_grid, args=(pool,),
                                  name="mesh-dryrun")
        runner.start()

        # (a) spec trees and shardings on the abstract meshes
        t0 = time.perf_counter()
        notes = {}
        dec = configs.SHAPES["decode_32k"]
        for arch in configs.ARCHS:
            cfg = configs.get_config(arch)
            trees = ((specs.params_shapes(cfg), lm.param_specs(cfg)),
                     (specs.decode_specs(cfg, dec["seq"], dec["batch"])[0],
                      lm.cache_specs(cfg)))
            for m in meshes:
                rules = sharding.default_rules(m)
                got = []
                for shapes, logical in trees:
                    shard = sharding.tree_shardings(shapes, logical, m, rules)
                    # one sharding a leaf, and one (replicated) for a
                    # cache group that has none (whisper's encoder)
                    n = len(tree_leaves(shapes, lambda t: t is None))
                    if len(tree_leaves(shard)) != n:
                        raise RuntimeError(f"{arch} on {m}: "
                                           f"{len(tree_leaves(shard))} "
                                           f"shardings for {n} leaves")
                    got.append(len(sharding.count_unsharded_fallbacks(
                        shapes, logical, m, rules)))
                notes[f"{arch} {'x'.join(map(str, m.shape.values()))}"] = \
                    tuple(got)
        log("mesh", f"(a) spec trees of the 10 FULL configs (params, "
            f"decode_32k caches) resolved on 16x16 and 2x16x16 in "
            f"{time.perf_counter() - t0:.2f} s; fallback notes (params, "
            f"caches): {notes}")

        # (b) launch/train.py on a one-card mesh against the plain run
        def run_train(**kw):
            for c in counts.values():
                c.reset()
            res = train(LM_ARCH, reduced=True, device="cuda",
                        overrides=dict(attn_core="flash"), verbose=False,
                        **dict(MESH_TRAIN, **kw))
            torch.cuda.synchronize()
            return res, {k: c.value for k, c in counts.items() if c.value}

        def same(a, b, what: str) -> None:
            if a["losses"] != b["losses"] or not all(
                    torch.equal(x, y) for x, y in zip(
                        tree_leaves(a["params"]), tree_leaves(b["params"]))):
                raise RuntimeError(f"{what}: losses {b['losses']} against "
                                   f"{a['losses']}, or params differ")

        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain, _ = run_train()
            one = mesh_mod.host_local_mesh("cuda")
            on_mesh, launches = run_train(use_mesh=one)
            want = dict(flash_attention=MESH_FLASH_PER_STEP
                        * MESH_TRAIN["steps"])
            if launches != want:
                raise RuntimeError(f"train on {one} launched {launches}, "
                                   f"expected {want}")
            same(plain, on_mesh, f"train(use_mesh={one})")
            log("mesh", f"(b) launch/train.py, {LM_ARCH} REDUCED float32 "
                f"flash, {MESH_TRAIN}, on {one}: losses {on_mesh['losses']}"
                f" = the run without use_mesh= bit for bit, params equal; "
                f"launches {launches}")

            # (c) the elastic protocol
            with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
                real = data_mod.TokenPipeline.batch

                def crash(self, step, shard=0):
                    if step == MESH_CRASH_AT:
                        raise SimulatedCrash(f"crash before step "
                                             f"{MESH_CRASH_AT}")
                    return real(self, step, shard)

                data_mod.TokenPipeline.batch = crash
                try:
                    run_train(use_mesh=one, ckpt_dir=d,
                              ckpt_every=MESH_CRASH_AT)
                    raise RuntimeError("the crash did not happen")
                except SimulatedCrash:
                    pass
                finally:
                    data_mod.TokenPipeline.batch = real
                plan = elastic.plan_rescale(1, 1, MESH_TRAIN["global_batch"])
                new = mesh_mod.make_mesh(plan["mesh_shape"],
                                         plan["mesh_axes"], "cuda")
                resumed, r_launches = run_train(
                    use_mesh=new, ckpt_dir=d, ckpt_every=MESH_CRASH_AT,
                    global_batch=plan["global_batch"])
            n_left = MESH_TRAIN["steps"] - MESH_CRASH_AT
            if r_launches != dict(flash_attention=MESH_FLASH_PER_STEP
                                  * n_left):
                raise RuntimeError(f"the resumed run launched {r_launches}")
            same(dict(on_mesh, losses=on_mesh["losses"][MESH_CRASH_AT:]),
                 resumed, "the elastic resume")
        finally:
            torch.use_deterministic_algorithms(False)
        n_dev = torch.cuda.device_count()
        refused = []
        for what, fn in (
                (f"make_mesh(({n_dev + 1}, 1))", lambda: mesh_mod.make_mesh(
                    (n_dev + 1, 1), ("data", "model"), "cuda")),
                ("placing on the abstract 16x16 mesh",
                 lambda: sharding.NamedSharding(single, sharding.P()).place(
                     torch.zeros(1, device="cuda")))):
            try:
                fn()
            except ValueError as e:
                refused.append(f"{what}: {e}")
            else:
                raise RuntimeError(f"{what} did not raise")
        log("mesh", f"(c) crash before step {MESH_CRASH_AT}, plan "
            f"{plan}, resumed on {new}: losses {resumed['losses']} = the "
            f"uninterrupted run's bit for bit, params equal, launches "
            f"{r_launches}; raised: {refused}; (b) and (c) "
            f"{time.perf_counter() - t0:.1f} s")

        runner.join()
        if "error" in grid:
            raise grid["error"]
        e = e_future.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # (d) the dry-run grid
    results = grid["results"]
    n_ok, n_skip, n_fail = dryrun.summary(results)
    for r in results:
        if r["status"] == "ok":
            log("mesh", f"(d) {r['arch']} {r['shape']} {r['mesh']}: flops "
                f"{r['flops']} bytes_accessed {r['bytes_accessed']} ops "
                f"{r['ops']} notes {r['fallback_notes']} trace "
                f"{r['trace_s']:.2f} s")
        elif r["status"] == "FAILED":
            log("mesh", f"(d) FAILED {r['arch']} {r['shape']}: "
                f"{r['error'][:500]}")
    log("mesh", f"(d) dry-run grid on {single}: {n_ok} ok / {n_skip} "
        f"skipped / {n_fail} FAILED")
    if n_fail or not n_ok:
        raise RuntimeError(f"the dry-run grid has {n_fail} FAILED cells")

    # (e) the [lm_train] step's model FLOPs over its measured time
    ms = lm_train["median_ms"]
    rate = e["flops"] / (ms / 1e3)
    share = rate / PEAK_OPS_PER_S["bfloat16"]
    log("mesh", f"(e) {card}: InternLM2-1.8B FULL train step at "
        f"[lm_train]'s shape ({LM_TRAIN}, remat "
        f"{LM_TRAIN_PROFILE['remat']!r}): dry-run {e['flops']} FLOPs (plain "
        f"cores, the remat recompute included), {e['bytes_accessed']} "
        f"bytes, {e['ops']} ops; [lm_train] median {ms:.1f} ms -> "
        f"{rate / 1e12:.2f} TFLOP/s, {100 * share:.2f} % of "
        f"{PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s dense bf16")
    log("mesh", f"{time.perf_counter() - t_phase:.1f} s in all")
    return dict(launches={k: launches.get(k, 0) + r_launches.get(k, 0)
                          for k in counts},
                per_step=dict(flash_attention=MESH_FLASH_PER_STEP),
                notes=notes, grid=(n_ok, n_skip, n_fail),
                lm_train_flops=e["flops"], tflops=rate / 1e12, share=share)


SPIN_CYCLES = 2_000_000
SPIN_KERNEL = "spin_kernel"


def profile_once(torch, fn, iters: int):
    """One torch.profiler window over ``iters`` calls of ``fn``: its device
    rows (us per call, events per call, name), largest first, the wall us
    per call, and each kernel name's device events over the window.  One
    call before the window runs under the profiler's warm-up step, whose
    events are dropped: a window's first kernels can go unrecorded while
    the device tracing starts.  For the same reason the window opens with a
    spin kernel (``torch.cuda._sleep``, about 1 ms) before the first call,
    whose events are dropped too: late in a long run the profiler dropped
    the first kernels of a window's first call (one x @ W and one
    block_diag_spmm of a pubmed forward), as if their timestamps fell
    before the window's start."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=iters, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn()
            if i == iters - 1:
                torch.cuda.synchronize()
            prof.step()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    dev_rows, events = [], {}
    for e in prof.key_averages():
        if e.key.startswith("ProfilerStep") or SPIN_KERNEL in e.key:
            continue   # the schedule's step markers span, not run, kernels
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_rows.append((us / iters, e.count // iters, e.key))
            events[e.key] = events.get(e.key, 0) + e.count
    dev_rows.sort(reverse=True)
    return dev_rows, wall_us, events


def profile_busy(torch, fn, iters: int, median_ms: float, what: str,
                 expect: dict | None = None):
    """Device time per call of ``fn`` from torch.profiler, its top kernels,
    and its share of ``median_ms``; None where the profiler saw no device
    time.  ``expect`` maps a kernel name (a part of its device events' key)
    to its launches per call: a window whose events of that kernel are not
    that many per call (the profiler can carry one window's events into the
    next) is profiled once more, and if it still differs the counts are
    logged and the reading is not measured (None)."""
    for attempt in range(2):
        dev_rows, wall_us, events = profile_once(torch, fn, iters)
        got = {name: sum(c for key, c in events.items() if name in key)
               for name in (expect or {})}
        want = {name: n * iters for name, n in (expect or {}).items()}
        if got == want:
            break
        log("profile", f"{what}: device events {got} over {iters} calls, "
            f"expected {want}" + ("; profiling again" if attempt == 0 else
                                  "; device-busy share not measured"))
    else:
        return None
    for us, cnt, key in dev_rows[:10]:
        log("profile", f"{us:9.1f} us/{what}  x{cnt}  {key[:90]}")
    busy_us = sum(r[0] for r in dev_rows)
    if busy_us <= 0:
        log("profile", f"the profiler recorded no device time: device-busy "
            f"share of a {what} not measured")
        return None
    busy = dict(busy_us=busy_us, share_of_profiled_wall=busy_us / wall_us,
                share_of_median=busy_us / (median_ms * 1e3))
    if expect:
        busy["kernel_events"] = got
    log("profile", f"device busy {busy_us:.1f} us per {what}: "
        f"{100 * busy['share_of_median']:.1f} % of the median {what} "
        f"({median_ms * 1e3:.1f} us), {100 * busy['share_of_profiled_wall']:.1f}"
        f" % of the profiled wall ({wall_us:.1f} us)")
    return busy


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products sum in float32 to the end, as the reference's
    # preferred_element_type=float32 asks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import rwkv6_chunked as rk_mod
    from repro_torch.kernels import tcgnn_tile as tc_mod
    counts = {"block_diag_spmm": bd_mod.launches,
              "bell_spmm": bell_mod.launches,
              "block_diag_spmm_fused": bdf_mod.launches,
              "bell_spmm_fused": bellf_mod.launches,
              "bell_spmm_dw": bellf_mod.dw_launches,
              "tcgnn_spmm": tc_mod.launches,
              "tcgnn_spmm_fused": tc_mod.fused_launches,
              "tcgnn_spmm_dw": tc_mod.dw_launches,
              "block_diag_spmm_dual": bdf_mod.dual_launches,
              "flash_attention": fa_mod.launches,
              "rwkv6_chunked": rk_mod.launches,
              "mamba_scan": ms_mod.launches}

    # 1. build ---------------------------------------------------------------
    phase_build(torch)

    # prepare the pubmed-sized graph (Table-1 row, scale 1.0) -----------------
    graph = graph_mod.synth_dataset("pubmed", scale=1.0, seed=0)
    cfg = gnn.GNNConfig(model="gcn", hidden=16, n_layers=2, comm_size=16,
                        reorder="bfs", inter_buckets=1, selector="fixed",
                        fixed_kernels=("block_diag", "bell"), seed=0)
    t0 = time.perf_counter()
    dec = gnn.prepare(graph, cfg, device="cuda")
    torch.cuda.synchronize()
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]
    tc, tc_t = dec.sub("inter").formats["tcgnn_tile"]
    log("prepare", f"{time.perf_counter() - t0:.2f} s; {graph.name} "
        f"n={graph.n} edges={graph.n_edges} features="
        f"{graph.features.shape[1]} classes={graph.n_classes} "
        f"n_pad={dec.n_pad}; block_diag {tuple(bd.blocks.shape)}, bell "
        f"{tuple(bell.blocks.shape)} ({int(bell.n_valid.sum())} real "
        f"blocks), bell_t {tuple(bell_t.blocks.shape)} "
        f"({int(bell_t.n_valid.sum())} real blocks), tcgnn_tile "
        f"{tuple(tc.tiles.shape)} and {tuple(tc_t.tiles.shape)} "
        f"({real_slot_count(tc.tiles)} and {real_slot_count(tc_t.tiles)} "
        f"real slots); payloads: "
        + ", ".join(f"{s.name} {sorted(s.formats)}" for s in dec.subgraphs))
    sage_cfg = gnn.GNNConfig(model="sage", selector="fixed")
    t0 = time.perf_counter()
    sdec = gnn.prepare(graph, sage_cfg, device="cuda")
    torch.cuda.synchronize()
    log("prepare", f"SAGE (no self-loops, mean norm): "
        f"{time.perf_counter() - t0:.2f} s; n_pad={sdec.n_pad}; block_diag "
        f"{tuple(sdec.intra.formats['block_diag'].blocks.shape)}; nnz "
        + ", ".join(f"{s.name} {s.stats['nnz']}" for s in sdec.subgraphs))

    # 2. kernels against their plain versions --------------------------------
    errs = phase_kernels(torch, dec)
    phase_kernels_train(torch, dec, errs)
    phase_kernels_tcgnn(torch, dec, errs)
    phase_kernels_dual(torch, sdec, errs)
    phase_kernels_flash(torch, errs)
    phase_kernels_rwkv(torch, errs)
    phase_kernels_mamba(torch, errs)

    # 3. forward -------------------------------------------------------------
    plan, params, x, launches_fwd = phase_main(torch, graph, cfg, dec, counts)
    n_fwd = 2
    for k, v in launches_fwd.items():
        want = 2 * n_fwd if k in FORWARD_KERNELS else 0
        if v != want:
            raise RuntimeError(f"{k} launched {v} times in {n_fwd} "
                               f"forwards, expected {want}")

    # 4. gradients, 5. training with fixed plans, 6. the main path ---------
    phase_grads(torch, graph, cfg, dec)
    trained = phase_train(torch, graph, cfg, counts)
    fb = phase_feedback(torch, graph, cfg, dec, counts, trained["params"])
    # 7. SAGE: fixed plans, then its main path -------------------------------
    sage = phase_sage_train(torch, graph, sdec, counts)
    sfb = phase_sage_feedback(torch, graph, counts, sage)
    # 7a. GIN on the Louvain reordering, its structures, the O1 baseline --
    gin = phase_gin(torch, graph, counts)
    gst = phase_gin_structure(torch, counts)
    o1 = phase_o1(torch, gin["dec"])
    # 7a'. GAT, mean/max aggregation, bucket autotuning and k = 4 plans ------
    gat = phase_gat(torch, graph, counts)
    mm = phase_mean_max(torch, graph, gat["dec"], counts)
    tune = phase_autotune(torch, graph, counts, trained["params"],
                        trained["results"])
    # 7a''. mini-batch training: samplers, PlanCache, capped payloads ------
    mb = phase_minibatch(torch, graph, counts, errs)
    # 7a'''. the asynchronous pipeline and checkpoint/resume -------
    pipe = phase_pipeline(torch, graph, counts, mb)
    # 7a''''. retries and fault injection ----------------------------------
    flt = phase_faults(torch, graph, counts, pipe)
    # 7a'''''. the GNN inference server ------------------------------------
    srv = phase_serve(torch, counts, mb)
    # 7b. LM serving: InternLM2-1.8B at full width ----------------------------
    lm2 = phase_lm_two_layer(torch, counts)
    lm32 = phase_lm_f32(torch, counts)
    lms = phase_lm_serve(torch, counts)
    # 7c. LM serving: RWKV6-7B at full width ---------------------------------
    torch.cuda.empty_cache()
    rw2 = phase_rwkv_two_layer(torch, counts)
    rw4 = phase_rwkv_f32(torch, counts)
    torch.cuda.empty_cache()
    rws = phase_rwkv_serve(torch, counts)
    torch.cuda.empty_cache()
    # 7d. LM serving: Jamba-v0.1, one period at full width -----------------
    jr = phase_jamba_reduced(torch, counts)
    jl = phase_jamba_layers(torch, counts)
    torch.cuda.empty_cache()
    js = phase_jamba_serve(torch, counts)
    torch.cuda.empty_cache()
    # 7e. LM training: the trainable scan, the reduced configs card vs CPU,
    # InternLM2-1.8B at full width through launch/train.py
    mt = phase_mamba_trainable(torch)
    ltr = phase_lm_train_reduced(torch, counts)
    torch.cuda.empty_cache()
    ltf = phase_lm_train(torch, counts, card)
    torch.cuda.empty_cache()
    # 7f. the DeepSeek family (MLA, shared experts, MTP): full-width layers
    # card vs CPU, the reduced configs, DeepSeekMoE-16B served whole and
    # DeepSeek-V3 at 4 layers
    dsf = phase_deepseek_f32(torch, counts)
    dsr = phase_deepseek_reduced(torch, counts)
    dss = {}
    for arch in DEEPSEEK_ARCHS:
        torch.cuda.empty_cache()
        dss[arch] = phase_deepseek_serve(torch, counts, arch)
    # 7g. the last two families: Qwen2-VL-7B (M-RoPE) and Whisper-large-v3
    # (encoder-decoder), the reduced configs card vs CPU, both whole
    torch.cuda.empty_cache()
    mmr = phase_mm_reduced(torch, counts)
    qv = phase_qwen2_vl(torch, counts, card)
    wh = phase_whisper(torch, counts, card)
    # 7h. the mesh tools: spec trees, launch/train.py on a one-card mesh,
    # the elastic resume, the meta-tensor dry-run grid
    torch.cuda.empty_cache()
    msh = phase_mesh(torch, counts, card, ltf)
    by_path = {"forward": launches_fwd, "train": trained["launches"],
               "feedback": fb["launches"], "sage_train": sage["launches"],
               "sage_feedback": sfb["launches"],
               "gin_train": gin["launches"],
               "gin_feedback": gin["fb_launches"],
               "gin_structure_forwards": gst["launches"],
               "gat_feedback": gat["launches"],
               "mean_max": mm["launches"],
               "gcn_k4_train": tune["launches"],
               **{f"minibatch_{n}": u for n, u in mb["used"].items()},
               **{f"pipeline_{n}": u for n, u in pipe["used"].items()},
               **{f"faults_{n}": u for n, u in flt["used"].items()},
               **{f"serve_{n}": u for n, u in srv["used"].items()},
               "lm_prefill_step_2_layers_f32": lm2["launches"],
               "lm_prefill_step_f32": lm32["launches"],
               "lm_softmax_prefill_decode_f32": lm32["other_launches"],
               "serve_lm_bf16": lms["serve_launches"],
               "lm_prefill_step_bf16": lms["launches"],
               "rwkv_prefill_step_2_layers_f32": rw2["launches"],
               "rwkv_prefill_step_f32": rw4["launches"],
               "rwkv_chunked_prefill_decode_f32": rw4["other_launches"],
               "serve_rwkv_bf16": rws["serve_launches"],
               "rwkv_prefill_step_bf16": rws["launches"],
               **{f"jamba_reduced_{k}_f32": v
                  for k, v in jr["launches"].items()},
               "jamba_mamba_layer_f32": {k: jl["launches"].get(k, 0)
                                         for k in counts},
               "serve_jamba_bf16": js["serve_launches"],
               "jamba_prefill_step_bf16": js["launches"],
               "jamba_plain_core_prefill_step_bf16": js["xla_launches"],
               "lm_train_bf16": ltf["train_launches"],
               "lm_train_gates_bf16": ltf["gate_launches"],
               **{f"lm_train_reduced_{a}_f32": v
                  for a, v in ltr["launches"].items()},
               "deepseek_full_width_f32": dsf["launches"],
               **{f"deepseek_reduced_{k}_f32": v
                  for k, v in dsr["launches"].items()},
               **{f"{a}_{what}_bf16": d[key] for a, d in dss.items()
                  for what, key in (("serve_lm", "serve_launches"),
                                    ("prefill_step", "launches"),
                                    ("softmax_prefill_step", "soft_launches"),
                                    ("cache_prefill", "prefill_launches"),
                                    ("decode", "decode_launches"))},
               **{f"mm_reduced_{k}": v for k, v in mmr["launches"].items()},
               "mesh_train_f32": msh["launches"],
               **{f"{name}_{what}": res[key]
                  for name, res in (("qwen2_vl", qv), ("whisper", wh))
                  for what, key in (
                      ("prefill_step_bf16", "launches"),
                      ("softmax_prefill_step_bf16", "soft_launches"),
                      ("decode_bf16", "serve_launches"),
                      ("prefill_step_f32", "f32_launches"),
                      ("softmax_f32", "f32_other_launches"))}}
    launches = {k: sum(p[k] for p in by_path.values()) for k in counts}
    for k, v in launches.items():
        if v == 0:
            raise RuntimeError(f"{k} was never launched by the paths driven")

    # 8. timing --------------------------------------------------------------
    fwd_ms = {acc: eager_ms(torch, lambda acc=acc: gnn.forward(
        params, cfg, dec, x, plan, acc=acc)) for acc in (False, True)}
    log("timing", f"forward median (CUDA events, host launch included): "
        f"acc=False {fwd_ms[False]:.4f} ms, acc=True {fwd_ms[True]:.4f} ms")

    # one training step per plan, in turns (unfused, fused, ..., fused,
    # unfused); acc is on (the card's default) unless the name says off
    def step_fn(model_cfg, d, pair, p, xx, acc=None):
        labels, mask = gnn.node_targets(graph, d)
        p = [{k: v.cuda() for k, v in q.items()} for q in p]
        opt = gnn._adam_init(p)
        step = gnn.make_train_step(model_cfg, d, pair, acc=acc)
        return lambda: step(p, opt, xx, labels, mask)

    steps = {name: step_fn(cfg, dec, pair, trained["params"], x)
             for name, pair in dict(PLANS, feedback=fb["plan"]).items()}
    steps["unfused acc off"] = step_fn(cfg, dec, PLANS["unfused"],
                                       trained["params"], x, acc=False)
    steps["feedback acc off"] = step_fn(cfg, dec, fb["plan"],
                                        trained["params"], x, acc=False)
    for name, pair in dict(SAGE_PLANS, sage_feedback=sfb["plan"]).items():
        steps[name] = step_fn(sage_cfg, sdec, pair, sage["params"],
                              sage["x"])
    for name, plan_of in gin["plans"].items():
        steps[name] = step_fn(gin["cfg"], gin["dec"], plan_of, gin["params"],
                              gin["x"])
    steps["gat"] = step_fn(gat["cfg"], gat["dec"], gat["plan"],
                           gat["params"], gat["x"])
    for name, plan_of in tune["plans"].items():
        steps[name] = step_fn(cfg, tune["dec"], plan_of, trained["params"],
                              tune["x"])
    step_runs = {name: [] for name in steps}
    for name in list(steps) + list(steps)[::-1]:
        step_runs[name].append(eager_ms(torch, steps[name]))
    step_ms = {name: statistics.mean(v) for name, v in step_runs.items()}
    log("timing", "training step median (CUDA events, host launch "
        "included; two runs each, in turns): " + ", ".join(
            f"{n} {step_runs[n][0]:.4f} / {step_runs[n][1]:.4f} ms"
            for n in steps))

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(1)
    nb, B = bd.blocks.shape[0], bd.block_size
    nv, nv_t = int(bell.n_valid.sum()), int(bell_t.n_valid.sum())
    bsr, bsr_t = bsr_of(torch, bell), bsr_of(torch, bell_t)
    rows = {"block_diag_spmm": {}, "bell_spmm": {}}
    for F in (16, 3):
        h = torch.randn((dec.n_pad, F), generator=gen, device="cuda")
        xb = h.view(nb, B, F)
        if bsr is not None:
            torch.testing.assert_close(bsr @ h, bell_mod.plain(
                bell.blocks, bell.col_idx, h), **F32_TOL)
        torch.testing.assert_close(torch.bmm(bd.blocks, xb).view(-1, F),
                                   bd_mod.plain(bd.blocks, h), **F32_TOL)
        b_ms, b_by = block_diag_bound(nb, B, F)
        rows["block_diag_spmm"][F] = dict(
            ms=graph_ms(torch, lambda: bd_mod.block_diag_spmm(bd.blocks, h),
                        flush),
            ms_warm_l2=graph_ms(torch, lambda: bd_mod.block_diag_spmm(
                bd.blocks, h)),
            plain_ms=graph_ms(torch, lambda: bd_mod.plain(bd.blocks, h),
                              flush),
            library_ms=graph_ms(torch, lambda: torch.bmm(bd.blocks, xb),
                                flush),
            library_call="torch.bmm(blocks, x.view(nb, B, F))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bd.blocks.shape), [dec.n_pad, F]])
        # the backward's dX pass (the transposed read) and the forward
        # seeded by the GCN bias as the main path passes it (one row
        # repeated), each held against its plain version (same bits twice)
        # before it is timed
        bias = torch.randn((F,), generator=gen, device="cuda")
        bias_row = bias.expand(dec.n_pad, F)
        at = bd.blocks.transpose(1, 2)
        for tag, y_in, transpose, lib, lib_call, seed in (
                ("t", None, True, lambda: torch.bmm(at, xb),
                 "torch.bmm(blocks.transpose(1, 2), x.view(nb, B, F))",
                 "none"),
                ("bias", bias_row, False,
                 lambda: torch.baddbmm(bias, bd.blocks, xb),
                 "torch.baddbmm(bias, blocks, x.view(nb, B, F))", "row")):
            def run(y_in=y_in, transpose=transpose):
                return bd_mod.block_diag_spmm(bd.blocks, h, y_in,
                                              transpose=transpose)
            want = bd_mod.plain(bd.blocks, h, y_in, transpose=transpose)
            torch.testing.assert_close(run(), want, **F32_TOL)
            torch.testing.assert_close(lib().view(-1, F), want, **F32_TOL)
            if not torch.equal(run(), run()):
                raise RuntimeError(f"block_diag_spmm {tag} F={F} gave other "
                                   "bits on a second call")
            b_ms, _ = block_diag_bound(nb, B, F, seed)
            rows["block_diag_spmm"][F].update({
                f"ms_{tag}": graph_ms(torch, run, flush),
                f"library_ms_{tag}": graph_ms(torch, lib, flush),
                f"library_call_{tag}": lib_call,
                f"bound_ms_{tag}": b_ms})
        lib_ms, lib_how = ((None, "none") if bsr is None else
                           yardstick_ms(torch, lambda: bsr @ h, flush,
                                        f"BSR @ x F={F}"))
        b_ms, b_by = bell_spmm_bound(bell, F)
        rows["bell_spmm"][F] = dict(
            ms=graph_ms(torch, lambda: bell_mod.bell_spmm(
                bell.blocks, bell.col_idx, h, n_valid=bell.n_valid), flush),
            plain_ms=graph_ms(torch, lambda: bell_mod.plain(
                bell.blocks, bell.col_idx, h), flush),
            library_ms=lib_ms,
            library_call=f"torch.sparse_bsr_tensor(real blocks) @ x, "
                         f"{lib_how}",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bell.blocks.shape), [nv, "real blocks"],
                   [dec.n_pad, F]])
        # the backward's dX pass: the same kernel over the transpose payload,
        # held against its plain version (same bits twice) before it is timed
        ht = torch.randn((bell_t.n_cols, F), generator=gen, device="cuda")
        want_t = bell_mod.plain(bell_t.blocks, bell_t.col_idx, ht)
        got_t = bell_mod.bell_spmm(bell_t.blocks, bell_t.col_idx, ht,
                                   n_valid=bell_t.n_valid)
        torch.testing.assert_close(got_t, want_t, **F32_TOL)
        if not torch.equal(got_t, bell_mod.bell_spmm(
                bell_t.blocks, bell_t.col_idx, ht, n_valid=bell_t.n_valid)):
            raise RuntimeError(f"bell_spmm over bell_t F={F} gave other bits "
                               "on a second call")
        if bsr_t is not None:
            torch.testing.assert_close(bsr_t @ ht, want_t, **F32_TOL)
        lib_t = ((None, "none") if bsr_t is None else
                 yardstick_ms(torch, lambda: bsr_t @ ht, flush,
                              f"BSR_t @ x F={F}"))[0]
        b_ms, b_by = bell_spmm_bound(bell_t, F)
        rows["bell_spmm"][F].update(
            ms_bell_t=graph_ms(torch, lambda: bell_mod.bell_spmm(
                bell_t.blocks, bell_t.col_idx, ht, n_valid=bell_t.n_valid),
                flush),
            library_ms_bell_t=lib_t, bound_ms_bell_t=b_ms,
            shape_bell_t=[list(bell_t.blocks.shape), [nv_t, "real blocks"],
                          [bell_t.n_cols, F]])
        for k in rows:
            r = rows[k][F]
            log("timing", f"{k} F={F}: {r['ms']:.4f} ms (L2 cold), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms "
                f"({r['library_call']}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})" + "".join(
                    f"; {what} {r[f'ms_{tag}']:.4f} ms, library "
                    f"{r[f'library_ms_{tag}']} ms, bound "
                    f"{r[f'bound_ms_{tag}']:.4f} ms"
                    for tag, what in (("bell_t", "over bell_t"),
                                      ("t", "transposed read"),
                                      ("bias", "bias row as y_in"))
                    if f"ms_{tag}" in r))
    rows.update(time_train_kernels(torch, dec, flush, bsr, bsr_t))
    rows.update(time_tcgnn_kernels(torch, dec, flush))
    rows.update(time_dual_kernel(torch, sdec, flush))
    rows.update(time_flash_kernel(torch, flush))
    rows["flash_attention"].update(time_mla_flash(torch, flush))
    rows.update(time_rwkv_kernel(torch, flush))
    rows.update(time_mamba_kernel(torch, flush))
    del scratch

    # each profile's kernel events are checked against the launches its
    # plan implies (the feedback plans' by plan_launches)
    busy = profile_busy(torch, lambda: gnn.forward(params, cfg, dec, x, plan),
                        5, fwd_ms[True], "forward",
                        expect=device_events(PER_FORWARD["unfused"]))
    per_step = dict(PER_STEP, **SAGE_PER_STEP)
    per_step["unfused acc off"] = PER_STEP["unfused"]
    for name, plan_of, model in (("feedback", fb, "gcn"),
                                 ("feedback acc off", fb, "gcn"),
                                 ("sage_feedback", sfb, "sage")):
        one, none = (plan_launches(plan_of["plan"].layers, n, model)
                     for n in (1, 0))
        per_step[name] = {k: one[k] - none[k] for k in one}
    for name, plan_of in gin["plans"].items():
        one, none = (plan_launches(plan_of.layers, n, "gin",
                                   gin["structures"]) for n in (1, 0))
        per_step[name] = {k: one[k] - none[k] for k in one}
    per_step.update(tune["per_step"])
    per_step["gat"] = {}
    # GAT's step runs no hand kernel: its expectation names every GNN
    # kernel's device functions with no event
    no_kernels = {fn: 0 for fns in DEVICE_FNS.values() for fn in fns}
    busy_step = {name: profile_busy(
        torch, fn, 5, step_ms[name], f"{name} step",
        expect=(no_kernels if name == "gat"
                else device_events(per_step[name])))
        for name, fn in steps.items()}

    # the LMs' counts as read in this run: one bf16 prefill-step call
    # (asserted to be n_layers) and one serve_lm call, prefill and 32
    # decode steps (asserted to be 0), per model
    per_call = dict(PER_STEP, **SAGE_PER_STEP,
                    **{n: per_step[n] for n in gin["plans"]},
                    **{n: per_step[n] for n in tune["plans"]},
                    gat=per_step["gat"],
                    **{f"minibatch_{n}": t for n, t in mb["per_step"].items()},
                    **{f"pipeline_{n}": t
                       for n, t in pipe["per_step"].items()},
                    serve_infer=srv["per_batch"],
                    lm_prefill_step=lms["launches"],
                    serve_lm=lms["serve_launches"],
                    rwkv_prefill_step=rws["launches"],
                    serve_rwkv=rws["serve_launches"],
                    jamba_prefill_step=js["launches"],
                    serve_jamba=js["serve_launches"],
                    lm_train_step=ltf["per_step"],
                    **{f"{a}_prefill_step": d["launches"]
                       for a, d in dss.items()},
                    **{f"serve_{a}": d["serve_launches"]
                       for a, d in dss.items()},
                    **{f"train_step_reduced_{a}": w for a, (_, w) in
                       (LM_TRAIN_REDUCED | MM_TRAIN_REDUCED).items()},
                    qwen2_vl_prefill_step=qv["launches"],
                    whisper_prefill_step=wh["launches"],
                    mesh_train_step=msh["per_step"])
    out = []
    for name, meta in KERNELS.items():
        key = ROW_KEY.get(name, "500x16")
        r = rows[name][key]
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            launches_by_path={p: c[name] for p, c in by_path.items()},
            launches_per_step={p: t.get(name, 0)
                               for p, t in per_call.items()},
            max_abs_err=errs[name]["float32"],
            **({"algo_bound_ms": r["algo_bound_ms"]}
               if "algo_bound_ms" in r else {}),
            max_abs_err_bf16=errs[name]["bfloat16"],
            **({"max_rel_err": errs[name]["float32_rel"],
                "max_rel_err_bf16": errs[name]["bfloat16_rel"]}
               if "float32_rel" in errs[name] else {}),
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            dtype=r.get("dtype", "float32"), width=key,
            by_width={str(k): v for k, v in rows[name].items()}))
    log("done", f"{time.perf_counter() - t_start:.1f} s; forward_ms "
        f"{ {str(k): v for k, v in fwd_ms.items()} }; busy {busy}; "
        f"step_ms {step_ms}; busy per step {busy_step}; feedback plan "
        f"{fb['plan'].layers}, cost-model plan {fb['model_plan']}, model "
        f"agrees {fb['agree'][0]} of {fb['agree'][1]}; GIN: Louvain "
        f"{gin['t_louvain']:.2f} s, prepare {gin['t_prepare']:.2f} s, "
        f"quality {gin['quality']}, feedback plan "
        f"{gin['plans']['gin_feedback'].layers}, structures "
        f"{gin['structures']}, proteins layer 1 priced {gst['priced']}; O1 "
        f"{o1['times']}; GAT feedback plan {gat['plan'].layers}, step "
        f"{gat['result'].step_seconds * 1e3:.3f} ms (host clock); mean/max "
        f"{mm['errs']}; autotune totals {tune['totals']}, committed k = "
        f"{tune['k_best']}, k = {AUTOTUNE_K} nnz {tune['nnz']}, per step "
        f"{tune['per_step']}; minibatch {mb['info']}, fixed card vs CPU "
        f"{mb['fixed']}; pipeline {pipe['info']}, resume {pipe['resume']}; "
        f"faults {flt['info']}; serve {srv['info']}; "
        f"train losses "
        + json.dumps(dict({n: r.losses for n, r in
                           trained["results"].items()},
                          feedback=fb["result"].losses,
                          sage_feedback=sfb["result"].losses,
                          **{n: r.losses for n, r in
                             sage["results"].items()},
                          gin_feedback=gin["result"].losses,
                          gat_feedback=gat["result"].losses,
                          **{n: r.losses for n, r in tune["results"].items()},
                          **{n: r["losses"] for n, r in
                             gin["results"].items()}))
        + f"; LM: 2-layer card vs CPU {lm2['err']:.3g}, float32 errors "
        f"{lm32['errs']}, bf16 flash vs softmax {lms['err']:.3g}, bf16 vs "
        f"float32 {lms['spread']}, argmax "
        f"{lms['agree']}, prefill ms {lms['prefill_ms']}, decode "
        f"{lms['decode_ms']:.3f} ms/token, busy {lms['busy']}; RWKV: "
        f"2-layer card vs CPU {rw2['err']:.3g}, float32 errors "
        f"{rw4['errs']}, bf16 per-layer kernel vs plain {rws['err']:.3g}, "
        f"logits (f32, bf16) {rws['spread']}, argmax {rws['agree']}, "
        f"sensitivity after 32 layers {rws['growth'][-1]:.3g}, prefill ms "
        f"{rws['prefill_ms']}, cache prefill {rws['cache_prefill_s']:.2f} s, "
        f"decode {rws['decode_ms']:.3f} ms/token, busy {rws['busy']}, "
        f"init peak {rws['init_peak_gb']:.2f} GB; Jamba: reduced card vs "
        f"CPU {jr['errs']}, full-width layers {jl['errs']}, MoE drops at "
        f"1.25 {jl['moe_dropped']}, bf16 per-layer kernel vs plain "
        f"{js['layer_check']}, logits kernel vs plain core {js['spread']}, "
        f"argmax {js['agree']}, prefill ms {js['prefill_ms']}, cache prefill "
        f"{js['cache_prefill_ms']:.1f} ms, decode {js['decode_ms']:.3f} "
        f"ms/token, MoE ms {js['moe_ms']}, bf16 dense MoE gate "
        f"{js['moe_bf16']}, busy {js['busy']}, init peak "
        f"{js['init_peak_gb']:.2f} GB, step peak {js['step_peak_gb']:.2f} GB"
        f"; LM train ({card}): mamba_scan_trainable max|err| {mt['errs']}, "
        f"fwd/bwd ms {mt['ms']}; reduced card vs CPU {ltr['info']}; "
        f"InternLM2 FULL train losses {ltf['losses']} "
        f"({ltf['train_s']:.1f} s), repeated batch {ltf['rep_losses']} -> "
        f"{ltf['after']}, flash step {ltf['first']}, softmax core "
        f"{ltf['soft']}, accum 1 {ltf['acc1']}, step ms {ltf['step_ms']} "
        f"({ltf['tokens_per_s']:.0f} tokens/s), peak {ltf['peak_gb']:.2f} "
        f"GB, busy {ltf['busy']}, topk_ef {ltf['topk_ms']:.2f} ms; DeepSeek "
        f"({card}): full-width float32 card vs CPU {dsf['errs']}, reduced "
        f"{dsr['errs']}; " + "; ".join(
            f"{a}: bf16 kernel check {d['kernel_check']}, logits (read) "
            f"{d['spread']}, argmax {d['agree']}, MoE paths "
            f"{d['paths']}, drops {d['drops']}, prefill ms "
            f"{d['prefill_ms']}, decode {d['decode_ms']:.3f} ms/token (floor "
            f"{d['decode_floor_ms']:.3f}), busy {d['busy']}, peaks serve "
            f"{d['serve_peak_gb']:.2f} / init {d['init_peak_gb']:.2f} / step "
            f"{d['step_peak_gb']:.2f} GB" for a, d in dss.items())
        + f"; Qwen2-VL and Whisper ({card}): reduced card vs CPU "
        f"{mmr['errs']}, train {mmr['info']}; Qwen2-VL-7B bf16 kernel check "
        f"{qv['kernel_check']}, flash vs softmax {qv['err']:.3g}, vs float32 "
        f"{qv['spread']}, float32 {qv['f32_errs']}, prefill ms "
        f"{qv['prefill_ms']}, decode {qv['decode_ms']:.3f} ms/token, busy "
        f"{qv['busy']}, peaks init {qv['init_peak_gb']:.2f} / step "
        f"{qv['step_peak_gb']:.2f} GB; Whisper-large-v3 bf16 kernel check "
        f"{wh['kernel_check']}, flash vs softmax {wh['err']:.3g}, vs float32 "
        f"{wh['spread']}, float32 {wh['f32_errs']}, prefill ms "
        f"{wh['prefill_ms']}, decode {wh['decode_ms']:.3f} ms/token, busy "
        f"{wh['busy']}, peaks init {wh['init_peak_gb']:.2f} / step "
        f"{wh['step_peak_gb']:.2f} GB; mesh: dry-run grid (ok, skipped, "
        f"FAILED) {msh['grid']}, InternLM2 train step "
        f"{msh['lm_train_flops']} FLOPs, {msh['tflops']:.2f} TFLOP/s "
        f"({100 * msh['share']:.2f} % of dense bf16 peak, {card})")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
