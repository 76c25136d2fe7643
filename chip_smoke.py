#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own line(s) and its wall seconds; any failure
raises and the script exits non-zero without the final result line:

1. device — the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. build — ``nvcc`` builds ``codegen/csrc/contract.cu`` (B1),
   ``codegen/csrc/contract_q8.cu`` and ``codegen/csrc/contract_chain.cu``
   (B1's int8/fp8, upcast and chain modes), ``codegen/csrc/grouped.cu``
   (B3), ``codegen/csrc/grouped_dw.cu`` (B4),
   ``codegen/csrc/baselines.cu`` (B5, B6, B7) and
   ``codegen/csrc/attention.cu`` (B2) for sm_90a from the
   checkout, one ``nvcc`` per source, all started together; prints
   ptxas's registers and spills per kernel, any ptxas warning and any
   C75xx message (a ``wgmma`` serialization);
3. kernel — the contraction kernel's wrapper against its plain PyTorch
   version (``contract_ref``) at the serving GEMM shapes, M in {4, 128,
   512} (a decode step of 4 lanes, prefills) x (K, N) in {(4096, 4096),
   (4096, 1024), (4096, 12288), (12288, 4096)}
   in bfloat16, plus one float32 case; tolerances are the reference's on
   outputs scaled by max|ref|: float32 (1e-4, 1e-4), bfloat16 (6e-2, 6e-2).
   Each case is timed with CUDA events (L2 flushed before every launch)
   for the kernel, the plain version and ``torch.matmul`` (the library
   yardstick, used nowhere in the port), beside its bound on an H100 SXM:
   max(operations / peak rate, bytes / 3.35 TB/s), bf16 at 989 TFLOP/s,
   f32 at 67 TFLOP/s (B1's and B2's 3xTF32 bodies: 495 / 3); each row names the body that ran (``ring`` with its
   tile and K split, ``narrow`` with its token width and K split, ``mma``,
   ``tc32``, ``fma``) and the kernel's device ms on the profiler beside the
   event-timed ms, which include the host's path to the launch; the M = 4
   rows must run the narrow body, one launch and no other device work
   each (no counter fill, no copy), and so must a decode layer's 7 GEMMs
   through ``ops.dense``; the f32 row must run the tc32 body, one launch
   alone, its bound at 3xTF32's rate with the FMA pipes' beside it;
   per-layer sums at M = 4, 128 and 512;
4. b1-train — B1 at one qwen3-8b layer's training GEMMs at M = 2048 (4 x
   512 tokens): each forward product and its derived backward specs
   ``matmul.dA`` and ``matmul.dB`` as the backward launches them, timed
   as phase 3, with per-layer sums; every row on the ring body with no
   other device kernel in its trace (no copy of a transposed operand);
5. grouped — the grouped MoE kernel's wrapper against its plain version
   (``grouped_ref``) at kimi-k2's expert shapes, bf16: gate/up
   (384 x C, 7168) @ (384, 7168, 2048) and down (384 x C, 2048) @
   (384, 2048, 7168) for C in {16, 8, 4}, one ragged partition with empty,
   size-1 and multi-pass groups, the dX orientation (w's contract axis
   last), one float32 case, a ragged partition with groups of 0 to 700
   rows (several 128-row blocks each) in both orientations, and the MoE
   training path's shapes (32 experts of C = 320: gate/up and down,
   forward and dX), at the same
   tolerances; timed as above, with ``torch.bmm`` over the uniform
   (E, C, K) layout as the library yardstick and the bound counting the
   expert slabs that hold rows;
6. grouped-dw — kernel B4 against ``grouped_dw_ref``: kimi-k2's full
   expert shapes (384 groups of C = 28: gate/up 7168 x 2048 and down
   2048 x 7168, an 11.27 GB output each), the training path's (32 groups
   of C = 320), a ragged partition with empty and size-1 groups (whose
   slabs must be exact zeros), one float32 case; timed as above with
   ``torch.bmm`` of x^T and dout over the (E, C, K) layout; each row
   names its body (bf16 the persistent TMA / ``wgmma`` ring, f32 the FMA
   pipes) and its device ms, and runs one launch and no other device
   work (no fill of the output);
6b. b1-modes — B1's epilogue and weighted-family modes against
   ``contract_ref`` at the fused path's shape (M = 2048, D = 4096, F =
   12288): every epilogue variant (5 activations x norm on/off x
   bf16/f32), then ``weighted_matmul`` and its derived ``.dA``, ``.dB``
   and ``.dg`` in bf16 (``.dg`` twice: the same bits), timed as phase 3
   with ``torch.matmul`` plus the same tail in eager PyTorch as the
   library yardstick, and a plain f32 row against one ``torch.matmul``
   (TF32 off); every bf16 row must run the fused ring and every f32 row
   the tc32 body (3xTF32), each alone (one launch, no copy, cast or fill
   kernel) and witnessed between CUDA events, each with its body and
   device ms; the f32 rows' bound at 3xTF32's rate, the FMA pipes' beside
   it;
6c. baselines — B5, B6 (gelu) and B7 against ``matmul_ref``,
   ``fused_dense_act_ref``, ``weighted_matmul_ref`` at that shape in bf16,
   at a ragged shape the ring takes (1000 x 1000 x 1000, bf16), at one it
   refuses by rule (1000 x 999 x 1001, bf16: the ``mma.sync`` body) and
   at that shape in f32 (the FMA body), B7 also with g = 0 (exact zeros);
   each row with its body (asserted) and profiler device ms, B5, B6 and
   B7 at aligned bf16 on the TMA / ``wgmma``
   ring, at the fused path's shape one launch alone with no other device
   work (no cast or copy of a, b or g); library ``torch.matmul``,
   ``torch.matmul`` + the eager epilogue, ``torch.matmul(a * g, b)``;
6d. b1-quant — B1's 8-bit modes against ``contract_ref``, no epilogue:
    int8 (int32 out, exact equality) and fp8 e4m3 (f32 out, f32 TOL
    scaled) at qwen3-8b's MLP shapes (up 2048 x 4096 x 12288, down 2048 x
    12288 x 4096, W k-major), a ragged product (1000 x 999 x 1001), a
    batched and a transposed fold; library ``torch._int_mm`` /
    ``torch._scaled_mm``, bound at 1979 TOP/s; then one counted pass
    through ``codegen.compile`` of the int8 and fp8 ``weighted_matmul``
    with its derived specs (the upcast body, 8 launches) and the quantized
    chain (2 launches), each held and timed; each row with its body (the
    MLP shapes on the 8-bit ring) and device ms, as phase 3;
7. small model — a 2-layer, 128-aligned qwen3-8b variant in float32 served
   on the card (kernel path) and on the CPU (plain path) from the same
   seeded weights: prefill/decode logits agree, greedy tokens are equal,
   and B1 launches 7 x n_layers times in the prefill and in each decode
   step;
8. small MoE model — the same check for a 2-layer, 128-aligned kimi-k2
   variant (one dense layer, one MoE layer of 8 experts top-2) under
   ``REPRO_MOE_GROUPED=1``; the grouped kernel must launch 3 times per MoE
   layer and forward;
9. small train — one train step of both small variants on the card and
   on the CPU from the same weights and optimizer state: every parameter
   gets a finite non-zero gradient on the card; gradients, loss, grad norm
   and updated parameters agree at the reference's f32 TOL (2e-4, 2e-4);
   B1 launches 28 times per layer, B3 9 and B4 3 times per MoE layer;
9b. fused small — the fused path's seven calls (below) at M = 192, D =
    256, F = 320 in f32 on the card and on the CPU: outputs and gradients
    agree at the f32 TOL (2e-4, 2e-4), each call with its launch counts;
9c. fused path — the fused single-contraction path at full width
    (qwen3-8b's MLP projection, M = 4 x 512, D = 4096, F = 12288, bf16)
    through its public entries only: ``ops.dense_act(act="gelu")`` and
    ``ops.weighted_dense`` forward and ``backward()`` (1 B1 launch forward
    and 3 backward each), ``kernels.matmul.ops.matmul`` and
    ``kernels.fused_dense_act.ops.fused_dense_act`` with ``use_generated``
    true (1 B1 launch) and false (1 launch of B5, B6), and
    ``kernels.fused_rnz.ops.weighted_matmul`` (1 B7 launch); outputs and
    gradients against the plain path on the card at the bf16 TOL; then
    the same calls under ``torch.profiler`` (``profile_fused.json``): no
    library GEMM on the path, and each kernel's device time;
9d. quant path — ``ops.dense(x, w, quant=fmt)`` through the public entry
    at the two MLP shapes and a ragged one (1000 x 999 x 1001), int8 and
    fp8, bf16 inputs: one 8-bit launch
    per call, the output against the plain path of the same call at the
    f32 TOL, the end-to-end error against ``x @ w`` under 0.05 (int8) /
    0.1 (fp8); under ``torch.profiler`` no library GEMM, device time of
    the kernels and of the quantize passes (``profile_quant_path.json``);
9e. chain — ``ops.chain_dense`` forward and ``backward()`` at (R, P, Q, C)
    = (4096, 128, 4096, 128), one qwen3-8b head's (QK^T)V without softmax,
    f32 and bf16: 1 + 3 chain launches, output and cotangents against
    their plain versions (f32 / bf16 TOL), two launches of each spec on
    the same inputs equal bit for bit, each spec timed against
    ``torch.linalg.multi_dot``, no library GEMM in the path's trace
    (``profile_chain_*.json``);
9f. quant small — card vs CPU: the 2-layer f32 model served with
    ``quant="int8"`` (greedy tokens equal, logits within 1e-4 scaled),
    ``ops.dense(quant=)`` (f32 TOL) and ``ops.chain_dense`` with its
    gradients (f32 2e-4, bf16 6e-2);
9g. attn-small — ``ops.attention`` card vs CPU at the reference's test
    shapes (d in (4, 8), (s, t) in ((8, 8), (8, 16), (16, 8)), full and
    causal), a ragged head_dim-128 case (S = 100, T = 77) and a ragged
    causal head_dim-192 one, f32 and bf16: outputs and the three
    gradients, 1 B2 + 3 B1 launches each, every B2 body run (ring, mma,
    tc32, fma); ``kv_lengths`` with a 0 entry, forward and backward: exact
    zeros in that head; every comparison scaled per row;
9h. attn-path — ``ops.attention`` at full width through the public entry:
    one qwen3-8b prefill's attention as capture's rewrite folds it (128
    heads, S = T = 512, d = 128, bf16): (a) causal, (b) causal with the
    serve trace's prompt lengths, (c) causal forward and backward, (d) f32
    at 32 heads, (e) a 4096-token prompt at 32 heads: 5 B2 and 3 B1
    launches, (a), (b), (c) and (e) on B2's ring body and (d) on its
    3xTF32 body, each timed row one launch with no other device work and
    its profiler device ms printed beside its body, its launches counted
    again between CUDA events; (d)'s bound at 3xTF32's rate (495 / 3
    TFLOP/s), the FMA rate's beside it; each forward against
    ``attention_ref`` and (c)'s cotangents
    against the plain path on the card, each row scaled by its own largest
    magnitude (every case checked before any fails); B2, the plain
    version and
    ``scaled_dot_product_attention`` (the library yardstick) timed beside
    the bound; no library attention or GEMM in (a) and (b)'s trace
    (``profile_attn_path.json``);
9i. hof — the paper's HoF formalism on the card: (a) B1 through
    ``codegen.compile`` (``default_schedule`` of the drawn blocks) on CUDA
    f32 tensors at the reference differential suite's six families,
    three seeds each as its ``_draw_case`` draws them plus one case a
    family at extent 32: B1 and the HoF interpreter (``evaluate_variant``,
    numpy, in worker processes meanwhile) against the f64
    einsum at the f32 TOL (1e-4, 1e-4), ``contraction_to_torch`` on CUDA
    f64 at 1e-10, one B1 launch a case by the launchers' counters; (b)
    ``repro_torch.paper``'s Table 1 and Table 2 (b = 16) at n = 384 and
    Fig 3 at n = 1024, b = 64 through ``execute`` and ``lower``, Table 1
    lowered at n = 1024, in f64: every variant equal to ``torch.matmul``
    at rtol 1e-8, its median event-timed ms of 3 after a warm-up, its
    ``cpu_cost`` and einsum calls, the Spearman values and ``torch.matmul``
    f64's ms beside the f64 bound (one ``[hof]`` line a table); (c)
    ``core.autotune.tune`` of a 256^3 matmul with j split by 16 or 64,
    measured on CUDA f64 tensors: the winner correct, a second call a hit
    in ``$CHIP_SMOKE_OUT/hof_tune.json`` with the same ranking;
10. train — the dense training path: ``launch.train``'s ``parse_args``,
    ``run_from_args`` and ``train()`` on qwen3-8b at full width (d_model
    4096, 32 heads, 8 KV heads, d_ff 12288, vocab 151936, bf16) cut to 8
    of 36 layers, batch 4 x 512, 5 steps, f32 moments, peak lr 3e-4,
    data seed 0:
    finite losses and grad norms, B1 launched 28 x 8 x 5 times; step time,
    tokens/s and peak memory;
11. train profile — one more step on the host clock, then under
    ``torch.profiler``: device busy, idle share, the kernels' time split
    into forward and backward launches
    (``$CHIP_SMOKE_OUT/profile_train.json``); the model is freed after;
12. MoE train — the same for kimi-k2 at full per-expert width (d_model
    7168, 64 heads of 112, expert_ff 2048, shared expert 2048, dense_ff
    18432, vocab 163840, bf16) cut to 2 layers (one dense, one MoE) and 32
    of 384 experts, top-8, batch 2 x 512 (C = 320), 3 steps, int8
    moments, peak lr 3e-4, under ``REPRO_MOE_GROUPED=1``: B1 28 x 2, B3 9
    and B4 3 launches per step; then its profile
    (``profile_moe-train.json``);
13. serve — the serving path: ``python -m repro_torch.launch.serve`` (its
    ``main``) on qwen3-8b at full width and depth (36 layers, d_model 4096,
    bf16, about 16.4 GB of seeded random weights) with ``--requests 4
    --prompt-len 512 --max-new 16 --lanes 4 --page-size 128 --rate-hz 0
    --seed 0``; every ``ops.dense`` of a prefill and of a decode step runs
    the kernel, so its launch count must equal 7 x 36 x (prefills + decode
    steps) (q, k, v, o, gate, up, down), with every request complete and
    every token in the vocab;
14. profile — outside the counted run, request 0's prefill again (finite
    logits that give the engine's first token) and one batch-1 decode step,
    each on the host clock and then under ``torch.profiler``: device busy
    time and device time by kernel, fills (of ints: B1's counters) and
    copies, from a whole trace only (a marker record kept first, as
    many B1 records as B1's counter: ``_judge_take``); the decode step
    must launch B1 7 x 36 times and fill no ints;
    the traces land in ``$CHIP_SMOKE_OUT/profile_{prefill,decode}.json``;
14b. fixed-serve — phase 13's trace through ``FixedEngine`` on phase
    13's qwen3-8b parameters (``params=``, no second copy): every request
    complete with tokens in the vocabulary, B1 7 x 36 x (prefill groups +
    decode steps) launches; each request's first-token logits from the
    batched (right-padded) prefill within 6e-2 of max |logit| of a batch-1
    ``api.prefill`` of its prompt; one batched decode step profiled (a
    whole trace): 7 x 36 B1 records, and library GEMMs exactly those of
    36 cached attentions and the f32 unembedding profiled alone; prefill
    ms, decode tok/s and peak memory beside phase 13's;
14c. families — mamba2-130m, zamba2-2.7b, whisper-base and internvl2-1b
    at full width and depth, bf16, seeded weights, through
    ``FixedEngine``: 4 requests of one prompt length (512; whisper 128
    beside 1500 seeded frame embeddings a lane; internvl2 512 after 256
    seeded patches of width 1024), max_new 16, lanes 4: every request
    complete, tokens in the vocabulary, finite prefill and decode logits,
    B1 launches a prefill and a decode step as the config implies (0; 9
    sites x 7 = 63; 72 and 36; 24 x 7 = 168) and over the run; each
    request's first-token logits from the batched prefill within 6e-2 of
    max |logit| of a batch-1 prefill and of a batch of its own prompt in
    every lane (the batched shapes, no other prompt), and, on the same
    weights and inputs in f32, of a batch-1 prefill within 2e-3; batch-1
    bf16 against f32 printed beside them; prefill ms, decode tok/s, peak
    memory;
14d. fixed-small — the f32 smoke config of each of the six families
    (dense, MoE under ``REPRO_MOE_GROUPED=1``, ssm, hybrid, encdec, vlm)
    and ``quant="int8"`` dense and hybrid through ``FixedEngine`` on the
    card and on the CPU: greedy tokens equal, the first group's prefill
    logits within 1e-4 of max |ref|, B1 (and B3 for MoE) launched on the
    card;
15. MoE serve — the MoE path: ``serve.run`` on kimi-k2-1t-a32b at full width
    (d_model 7168, 64 heads of 112, 384 experts top-8, expert_ff 2048, a
    shared expert, dense_ff 18432, vocab 163840, bf16) cut to 2 layers (one
    dense, one MoE: about 39.9 GB of seeded random weights), with the same
    flags as phase 13 and ``REPRO_MOE_GROUPED=1``; the grouped kernel must
    launch 3 x (prefills + decode steps) times and the contraction kernel
    the count derived from the segment plan (7 per dense layer, 4 + 3 per
    MoE layer with a shared expert) x (prefills + decode steps); phase
    13's engine is freed
    first;
16. MoE profile — phase 14 for the kimi-k2 model
    (``$CHIP_SMOKE_OUT/profile_moe_{prefill,decode}.json``);
16b. serve int8 — phase 13's serving path with ``--quant int8``: the tree
    quantized once at load, expanded before every step; requests complete,
    B1 7 x 36 x (prefills + decode steps) launches, the
    ``serve.quant_bytes`` gauge equal
    to the int8 leaves' bytes from their shapes, request 0's prefill
    again with finite logits giving the engine's first token; prefill
    ms, decode tok/s, p50 and peak memory;
16c. search — the variant search on the card under its own plan DB: the
    sweep CLI's ``run`` on qwen3-8b's four prefill projection shapes in
    bf16 with their backward specs (twelve card ladders of B1 tile plans,
    every plan checked and launched once a timed call on its plan; a
    winner other than the launcher's heuristic re-timed against it and
    no slower beyond the timings' spread; winner's and heuristic's event
    and device ms, the model's Spearman value), then phase 13's serving
    run with ``--search-gemms`` (every launch on its ladder's plan, by a
    tally of the launcher's calls, 7 x 36 x (prefills + decode steps) of
    them), a restart that hits every ladder in the plan DB, and
    ``tune_schedule(measure_with=)`` on CUDA operands;
16d. remat-dryrun — the remat policies, causal skip, the one-card
    dry-run and plan-explain (``phase_remat_dryrun``);
16e. capture — whole-model capture (``repro_torch.capture``): (a) the
    conformance trio (``capture.demo_configs``, f32) captured on the card
    against the CPU's ``interpret=True`` capture: the same sites, ops and
    specs, loss and every gradient within 2e-4 scaled, and the launches
    of one loss + gradients each from its sites (B1 per dense site and
    its ``.dA`` / ``.dB``, B2 per motif, B3 / B4 per grouped site, with
    the remat recompute); (b) phase 13's serving run with ``--capture``
    (both steps harvested on fake tensors and swept, no backward specs):
    every request complete, B1 7 x 36 + 1 (the f32 unembedding) a
    forward, B2 36 a prefill (the single-block attention motif), each
    request's first-token logits within 6e-2 of max |logit| of the
    uncaptured prefill's, prefill ms and decode tok/s beside an uncaptured
    engine's on the same weights, each run twice (the second warm: every
    step signature traced);
    (c) phase 10's training cut with ``--capture`` for 3 steps: finite
    losses, step 1's within the bf16 TOL of phase 10's, B1 and B2 a step,
    step ms and peak beside phase 10's; the f32 unembedding's device ms
    on B1 (forward, ``.dA``, ``.dB``, each one launch, with its body and
    ``torch.matmul``'s ms and the plain version's) at M = 2048 and at
    M = 4;
16f. mesh — the mesh tier (``codegen.{collectives,mesh_gen}``,
    ``launch.mesh``, ``ops._mesh_plan_kernel``, the search on a mesh,
    ``serve --mesh``, ``make_train_step(mesh=)``) on ranks that share the
    card: spawned processes joined by gloo, every payload staged through
    pinned host memory (``MESH_TRANSPORT``; the kernels built by the
    parent first).  One world of 4 ranks: (a) ``ring_psum``,
    ``all_reduce``, the ring and naive gather-matmuls on CUDA tensors for
    p in {1, 2, 4} against their oracles (rtol 1e-4, atol 1e-5), a 16 MiB
    all-reduce timed; (b) every sharded variant x collective of
    ``mesh_variants`` on a 2x2 mesh, f32 and bf16, at 256 x 512 x 384
    and qwen3-8b's MLP shapes at M = 512: one B1 launch a call on each
    rank, outputs against single-card B1 and the plain version at the
    reference's TOL, each call timed; (c) ``search_schedule_with_grads``
    of a 256 x 1024 x 1024 f32 product with ``mesh_shape=(2, 2)``, then
    ``ops.dense``'s loss and gradients under the mesh: a
    ``MeshBoundKernel`` forward, ``.dA`` and ``.dB`` (3 B1 launches),
    against the unsharded run at the f32 TOL; (e) 3 steps of
    ``make_train_step(mesh=)`` on qwen3-8b at full width cut to 2 of 36
    layers (four replicas share the card), batch 1 x 256, int8 moments,
    its GEMMs' mesh ladders searched first: finite losses within the bf16
    TOL of rank 0's single-rank steps, 28 x 2 x 3 B1 launches a rank,
    all mesh-bound, every rank's parameters equal, step ms.  Then a world
    of 2 ranks: (d) ``serve.run`` of qwen3-8b at full width and depth
    with ``--engine fixed --mesh 1x2`` (2 x 16.4 GB of weights): 7 x 36
    x forwards B1 launches a rank, all mesh-bound, first-token logits
    against a single-rank prefill within 6e-2 of max |logit|, tokens
    against the same trace served single-rank, prefill ms, decode tok/s,
    bytes staged and peak memory a rank.  A rank that fails or hangs
    fails the phase;
16g. sharded -- steps on DTensor-sharded parameters (the ops' sharding
    rules, ``ops.library.sharded_launch``; ``launch.steps.shard_tree``;
    the model, MoE and AdamW on DTensors; elastic restore; the mesh
    dry-run; capture on a mesh) on ranks that share the card over gloo,
    DTensor's collectives staged through host memory (a ``host`` mesh).
    One world of 4 ranks: (a) every strategy pair of B1 (qwen3-8b's MLP
    projections at M = 512, f32 and bf16; the bias / norm / gelu
    epilogue, the weighted and transposed modes in bf16), B2 (attn-path
    (a)) and B3 / B4 (the MoE train shapes) on DTensors over 2x2, each
    gathered output against the single-card launch and the plain version
    at the TOL, one launch a call a rank; (b) qwen3-8b at full width cut
    to 8 layers on a 2x2 ``tp`` mesh, 2 x 256 tokens, f32 moments, 3
    steps: finite losses, 28 x 8 B1 launches a rank a step, peak a rank
    against the single-card 8-layer step's, step ms, the first step's
    collective bytes a rank equal to the fake 2x2 dry-run's; at 2 layers
    the losses within the bf16 TOL of rank 0 alone; (c) kimi-k2 at the
    MoE train cut, experts on ``model``, grouped, one step with the tokens
    gathered and one under ``REPRO_MOE_CONSTRAINT=1`` (the dispatched
    slots sent by all-to-alls): B3 9 / B4 3 a rank each, each loss within
    the bf16 TOL of rank 0 alone, each step's collective bytes; (d) the
    smoke qwen3-8b, 2 steps and a checkpoint on 2x2.  Then a world of 2: (d) the
    checkpoint restored on 1x2 (every parameter leaf bit for bit, equal
    to the file too), step 3 through a fault loop whose first attempt
    raises ``StepFailure``, within the bf16 TOL of the uninterrupted 2x2
    run; (f) ``serve --capture --mesh 1x2`` of qwen3-8b cut to 4 layers,
    2 x 128 tokens, 4 new: tokens equal uncaptured ``--mesh 1x2``, B1
    and B2 launches a rank.  Meanwhile, in a process of its own: (e) the
    mesh dry-run of qwen3-8b train_4k, prefill_32k, decode_32k and
    kimi-k2 train_4k cut to ``DRYRUN_LAYERS`` at pod and multi-pod on
    fake CUDA tensors (status, per-device flops against one card's, peak,
    collective bytes), ``perf``'s four sharding knobs (and
    ``moe_constraint`` on kimi-k2), and the 2x2 cell
    of (b).  A rank that fails or hangs fails the phase;
17. the phases' seconds, the ``kernels`` JSON line (contract, grouped,
    grouped_dw, matmul, fused_dense_act, fused_rnz, contract_int8,
    contract_fp8, contract_upcast, contract_chain, attention), then the
    card's line,
    then the result line
    ``{"ok": true, "device": {...}}`` last.

Every launch count is read from counters set to 0 just before the run it
counts.  A profiled check (a row that must run one kernel alone, a
profiled serving step) opens its session with a marker, ``MARKERS``
float64 fills, and counts only a whole trace: a marker record kept first,
as many of the kernel's records as its launcher counted
(``_judge_take``); a trace that lost every marker record is taken again,
up to ``TAKES``, and a check with no whole take fails.  The takes each
check needed are printed (``[takes]``) before the phases' seconds.
Everything the script measures also goes to
``$CHIP_SMOKE_OUT/report.json`` (default ``smoke_out/`` beside this
script).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
#: where the report and the profiler traces go (listed in .gitignore)
OUT = os.path.abspath(os.environ.get("CHIP_SMOKE_OUT",
                                     os.path.join(HERE, "smoke_out")))

#: H100 SXM, dense: bf16, f32 (CUDA cores), int8 and fp8 tensor cores
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
            "fp8": 1979e12}
#: f32 products in 3xTF32 (three TF32 products each) on the tensor cores:
#: TF32's dense 495 TFLOP/s over 3, the ceiling of B2's tc32 body
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": (6e-2, 6e-2), "float32": (1e-4, 1e-4)}
SERVE_ARGS = ["--arch", "qwen3-8b", "--requests", "4", "--prompt-len", "512",
              "--max-new", "16", "--lanes", "4", "--page-size", "128",
              "--rate-hz", "0", "--seed", "0", "--device", "cuda"]
#: GEMMs of one layer, (K, N) -> how many of q, k, v, o, gate, up, down
LAYER_GEMMS = {(4096, 4096): 2, (4096, 1024): 2, (4096, 12288): 2,
               (12288, 4096): 1}
KERNELS = ("contract", "grouped", "grouped_dw")
#: the CUDA sources the build phase compiles: B1 (contract, its 8-bit and
#: upcast modes, its chain mode), B3, B4, B5-B7 and B2 (attention)
SOURCES = KERNELS + ("baselines", "contract_q8", "contract_chain",
                     "attention")
#: the hand-written baselines of repro_torch.kernels, by launcher name
BASELINES = ("matmul", "fused_dense_act", "fused_rnz")
#: the fused single-contraction path: qwen3-8b's MLP projection at the
#: train path's M = 4 x 512 tokens, D = 4096, F = 12288, bf16
FUSED_M, FUSED_D, FUSED_F = 4 * 512, 4096, 12288
ACTS = ("relu", "gelu", "tanh", "silu", "id")
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_LAYERS = 2  # the one cut: depth (one dense layer, one MoE layer)
MOE_SERVE_ARGS = ["--arch", MOE_ARCH] + SERVE_ARGS[2:]
#: kimi-k2's expert products, (K, N): gate/up and down
GROUPED_GATE, GROUPED_DOWN = (7168, 2048), (2048, 7168)
N_EXPERTS = 384
#: the dense training path: qwen3-8b at full width cut to 8 of 36 layers,
#: batch 4 x 512 tokens, f32 moments, 5 steps, data seed 0, peak lr 3e-4
#: (AdamWConfig's default; the CLI's 3e-3 is sized for the smoke configs
#: and makes the loss of a 4096-wide model rise within 5 steps)
TRAIN_LAYERS = 8
TRAIN_FLAGS = ["--arch", "qwen3-8b", "--steps", "5", "--batch", "4",
               "--seq", "512", "--moments", "float32", "--lr", "3e-4",
               "--device", "cuda"]
TRAIN_M = 4 * 512
#: the MoE training path: kimi-k2 at full per-expert width cut to 2 layers
#: and 32 of 384 experts (top-8 kept), batch 2 x 512 (C = 320), int8
#: moments, 3 steps
MOE_TRAIN_EXPERTS = 32
MOE_TRAIN_FLAGS = ["--arch", MOE_ARCH, "--steps", "3", "--batch", "2",
                   "--seq", "512", "--moments", "int8", "--lr", "3e-4",
                   "--device", "cuda"]
MOE_TRAIN_C = 320  # capacity: 1.25 x 1024 tokens x top-8 / 32 experts
#: ragged groups of 0 to 700 rows, several of them larger than B3's M tile
GROUPED_LARGE = (0, 1, 129, 700, 64, 65, 320, 200)
#: the B1 launches of one layer of a train step: 7 eligible GEMMs, each run
#: forward, again in the remat recompute, and twice in the backward (dA, dB)
B1_PER_LAYER_STEP = 7 * 4
#: B3 per MoE layer and step: gate, up, down forward and recompute, 3 dX;
#: B4: the 3 dW
B3_PER_MOE_STEP, B4_PER_MOE_STEP = 9, 3
SECONDS = {}  # phase -> wall seconds


#: launches of a plain version per timing (they are the slowest calls
#: timed, and no yardstick of speed): one warm-up and three timed
PLAIN_REPS = dict(reps=3, warmup=1)


def _timed(fn, flush, reps=10, warmup=2):
    """Mean device ms of ``fn()`` over ``reps`` launches, L2 flushed
    before each (the serving GEMMs find their weights cold)."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _kernel_ms(run, flush, kernel, reps=5):
    """(device ms a ``run()`` spends in the port's ``kernel`` (a
    ``_kernel_of`` name), the other device kernels it launched, and their
    device ms a call): ``reps``
    calls under ``torch.profiler`` after one warm-up, L2 flushed before
    each, in a session opened by the marker.  The flush's fill (of bytes)
    is not counted as another; B1's split counters are zeroed once, when
    their pool grows, so a fill of ints in a traced call is one.
    ``_timed``'s ms include the host's path to the launch (about 0.15 ms
    through ``ops``), which hides a short kernel; this is the kernel
    alone.  Only a whole trace counts (a marker record kept first, the
    kernel's records a whole number a call): a take that lost every
    marker record is taken again, and after ``TAKES`` such takes the ms
    are NaN (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, dtype=torch.float64, device="cuda")
    run()
    torch.cuda.synchronize()
    for _ in range(TAKES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_session(marker)
            for _ in range(reps):
                flush.zero_()
                run()
            torch.cuda.synchronize()
        path = os.path.join(OUT, "profile_case.json")
        prof.export_chrome_trace(path)
        records = _device_events(path)
        _, _, by_name = _device_time(path, marker=True)
        mine = [v for k, v in by_name.items() if _kernel_of(k) == kernel]
        count = sum(v[1] for v in mine)
        kept = bool(records) and MARKER_KERNEL in records[0][2]
        if kept and count >= reps and count % reps == 0:
            break
    else:
        print(f"[profile] {kernel}: {TAKES} traces lost the marker's "
              f"records or held {count} launches over {reps} calls; device "
              f"ms not measured", flush=True)
        return float("nan"), [], float("nan")
    others = sorted(k for k in by_name if _kernel_of(k) != kernel
                    and "FillFunctor<unsigned char>" not in k
                    and not k.startswith("Memset"))
    ms = sum(v[0] for v in mine) / reps
    return ms, others, sum(by_name[k][0] for k in others) / reps


#: the device kernel of a profiled session's marker (a float64 fill)
MARKER_KERNEL = "FillFunctor<double>"
#: marker launches that open a session: a session can lose the first of
#: its device records and keep the rest (one record, ten, or every one;
#: more so later in a process: ``scripts/profiler_window.py``), so a
#: session opens with many markers, and one kept shows that every record
#: after it was kept
MARKERS = 32
#: takes of a profiled check before it fails for want of a whole trace (a
#: process can lose every record of two sessions in a row)
TAKES = 6
#: ``_judge_take``'s verdicts other than a failure's reason
WHOLE, LOST = "whole", "lost"


def _marker_records(run, reps=3):
    """The device record names, in order of start, of ``reps`` calls of
    ``run()`` under ``torch.profiler`` after one warm-up, in a session that
    opens with the marker (``MARKERS`` float64 fills) and traces nothing
    else (no flush): what the calls launch on the card, fills and copies
    included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, dtype=torch.float64, device="cuda")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_session(marker)
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    path = os.path.join(OUT, "profile_case.json")
    prof.export_chrome_trace(path)
    return [name for _, _, name in _device_events(path)]


def _open_session(marker):
    """The marker: ``MARKERS`` fills of the float64 ``marker``, first in
    a profiled session."""
    for _ in range(MARKERS):
        marker.fill_(1.0)


def _device_kernels(run, reps=3):
    """{device kernel name: records} of ``_marker_records`` (the library
    yardsticks' kernels, by name), the marker's records left out
    (``_after_marker``)."""
    return dict(collections.Counter(_after_marker(_marker_records(run,
                                                                  reps))))


def _after_marker(names):
    """The record names of a session that opened with the marker, its
    leading marker records (up to ``MARKERS``) left out and no other (a
    later float64 fill is other work)."""
    lead = 0
    while lead < min(MARKERS, len(names)) and MARKER_KERNEL in names[lead]:
        lead += 1
    return list(names[lead:])


def _kernels_after_marker(path):
    """{device kernel name: records} of a trace file's marker session."""
    return dict(collections.Counter(
        _after_marker([name for _, _, name in _device_events(path)])))


def _judge_take(names, kernel, counted, other_ok=None):
    """The verdict on one profiled take of a check.  ``names``: the device
    records of a session that opened with the marker (``MARKERS``
    launches), in order of start; ``counted``: the launches of ``kernel``
    (a ``_kernel_of`` name) that its launcher counted in the session;
    ``other_ok(name)``: which other records the check allows (none by
    default).  ``WHOLE``: a marker record first, then ``counted`` of the
    kernel's and no other record that is not allowed.  ``LOST``: no
    marker record, so the profiler lost a prefix of the session's records
    longer than the marker (at times every record,
    ``scripts/profiler_window.py``): the take shows nothing and is taken
    again.  Anything else is a failure, returned as its reason: other
    device work, more of the kernel's records than launches, or fewer
    where a marker record was kept (the records after a kept one are
    whole)."""
    kept = bool(names) and MARKER_KERNEL in names[0]
    rest = _after_marker(names)
    mine = sum(_kernel_of(n) == kernel for n in rest)
    others = sorted({n for n in rest if _kernel_of(n) != kernel
                     and not (other_ok and other_ok(n))})
    if others:
        return f"other device work {others}"
    if mine > counted:
        return f"{mine} {kernel} records for {counted} launches"
    if not kept:
        return LOST
    if mine < counted:
        return (f"{mine} {kernel} records for {counted} launches, a marker "
                f"record kept")
    return WHOLE


def _launch_witness(run, kernel, what, device_ms=None, reps=3):
    """A second count of ``run()``'s launches of ``kernel`` (a
    ``_kernel_of`` name) at the row ``what``, beside ``_alone``'s: ``reps``
    calls after one warm-up under ``torch.profiler`` with no marker, each
    between two CUDA events, printed; where the kernel's device ms is
    known, a call shorter than half of it between its events (one that ran
    no kernel takes microseconds) fails.  Returns (the kernel's records in
    that trace, the ms between each call's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for start, end in marks:
            start.record()
            run()
            end.record()
        torch.cuda.synchronize()
    path = os.path.join(OUT, "profile_witness.json")
    prof.export_chrome_trace(path)
    _, _, by_name = _device_time(path)
    records = sum(v[1] for k, v in by_name.items() if _kernel_of(k) == kernel)
    event_ms = [start.elapsed_time(end) for start, end in marks]
    on = "" if device_ms is None else f" (device {device_ms:.4f})"
    print(f"[witness] {what}: {records} {kernel} records over {reps} calls "
          f"in a trace without the marker; CUDA events a call "
          f"{[round(x, 4) for x in event_ms]} ms{on}", flush=True)
    if device_ms is not None and device_ms == device_ms and (
        min(event_ms) < 0.5 * device_ms
    ):
        raise AssertionError(f"{what}: a call took {min(event_ms):.4f} ms "
                             f"between its CUDA events, under half the "
                             f"kernel's {device_ms:.4f} ms")
    return records, event_ms


def _launcher(kernel):
    """The launcher of the port's ``kernel`` (a ``_kernel_of`` name) that
    ``_alone`` counts."""
    from repro_torch.codegen import ATTENTION, CONTRACT, GROUPED_DW
    from repro_torch.kernels import _baselines

    return {"contract": CONTRACT, "attention": ATTENTION,
            "grouped_dw": GROUPED_DW,
            "matmul": _baselines.MATMUL,
            "fused_dense_act": _baselines.FUSED_DENSE_ACT,
            "fused_rnz": _baselines.FUSED_RNZ}[kernel]


def _searched_card(spec, dtype):
    """The B1 plan (``CardPlan``) the plan DB's unphased ladder holds for
    ``spec`` at ``dtype``, which ``ops`` launches in place of the
    launcher's heuristic; None where no card ladder stored one."""
    from repro_torch.codegen.cuda_gen import CardPlan
    from repro_torch.codegen.fused_gen import plan_from_dict
    from repro_torch.search import default_plan_db

    _, rung = default_plan_db().best_entry(spec, dtype)
    card = plan_from_dict(rung.get("card"))
    return card if isinstance(card, CardPlan) else None


#: takes each ``_alone`` check needed, by its row, in this run
TAKEN = {}


def _alone(run, kernel, launches, what, reps=3):
    """Raise unless ``reps`` calls of ``run()`` launch ``kernel`` (a
    ``_kernel_of`` name) ``launches`` times each and no other device
    kernel, fill, copy or memset.  The launches are the launcher's own
    count; the trace, opened by the marker, must be whole
    (``_judge_take``): a take that lost every marker record is taken
    again, up to ``TAKES`` in all, and a check with no whole take fails.
    Returns the takes it needed (also kept in ``TAKEN``)."""
    launcher = _launcher(kernel)
    want = launches * reps
    for take in range(1, TAKES + 1):
        before = launcher.launches
        names = _marker_records(run, reps)  # one warm-up call, then reps
        counted = launcher.launches - before - launches
        verdict = (_judge_take(names, kernel, counted) if counted == want
                   else f"{counted} launches by the launcher's count")
        if verdict == WHOLE:
            TAKEN[what] = take
            return take
        if verdict != LOST:
            raise AssertionError(
                f"{what}: {verdict} (expected {want} {kernel} launches over "
                f"{reps} calls and no other device work)")
        print(f"[profile] {what}: take {take} lost the marker's records "
              f"({len(names)} records kept); taken again", flush=True)
    raise AssertionError(f"{what}: {want} {kernel} launches by the "
                         f"launcher's count, but {TAKES} traces lost the "
                         f"marker's records: no whole trace shows what "
                         f"else ran")


def _body(launcher):
    """The body of the launcher's latest launch, with the ring's tile."""
    plan = getattr(launcher, "last_plan", None)
    if not hasattr(plan, "splits"):  # no tile plan, or a fused kernel's
        return launcher.last_body
    return f"{launcher.last_body} {plan.tile_n}x{plan.splits}"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return name, smi


def phase_build():
    from repro_torch.codegen import build

    def one(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        took = dict(zip(SOURCES, pool.map(one, SOURCES)))
    for name in SOURCES:
        build.load(name)
        print(f"[build] {name}.cu -> "
              f"{os.path.relpath(build.library_path(name), HERE)} in "
              f"{took[name]:.1f} s", flush=True)
        for line in _ptxas_lines(build.ptxas_report(name)):
            print(f"[build] {name}: {line}", flush=True)


def _ptxas_lines(report):
    """One line per kernel of a ``-Xptxas -v`` report (its mangled name,
    registers, spill stores and loads), then every warning and every
    C75xx message (``wgmma`` serialized, a ``warpgroup.arrive`` injected)
    as it is."""
    import re

    out, warnings, kernel, spill = [], [], None, ""
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            kernel, spill = hit.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{kernel}: {regs} registers; {spill}")
            kernel = None
        elif "warning" in line.lower() or "(C75" in line:
            warnings.append(line.strip())
    return out + warnings


def _check_close(got, want, dt_name, what, tol=None):
    """Scaled error of ``got`` against ``want`` within ``TOL`` (or
    ``tol``); raises.  Works in slices along the first axis, so an 11 GB
    output needs no f32 copy of itself."""
    rtol, atol = tol or TOL[dt_name]
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    if got.dim() == 0:
        got, want = got[None], want[None]
    step = max(1, 2**28 // max(1, want[0].numel()))
    parts = range(0, want.shape[0], step)
    scale = max(want[i:i + step].float().abs().max().item() for i in parts)
    scale = scale or 1.0
    max_abs = scaled_err = 0.0
    ok = True
    for i in parts:
        w = want[i:i + step].float()
        diff = (got[i:i + step].float() - w).abs()
        ok &= bool((diff / scale <= atol + rtol * w.abs() / scale).all())
        max_abs = max(max_abs, diff.max().item())
        scaled_err = max(scaled_err, (diff / scale).max().item())
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"scaled error {scaled_err}")
    return max_abs, scaled_err


def _row_err(got, want):
    """(max abs, row-scaled) error: each row (the last axis) divided by its
    own largest |want| (1 for an all-zero row).  Attention's rows differ
    in size by far -- a late causal row averages many values, row 0 is one
    value of v -- so one scale for the whole tensor would let a late row
    drift by many times its own size."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True)
    scale = scale.masked_fill(scale == 0, 1.0)
    return diff.max().item(), (diff / scale).max().item()


def _check_rows(got, want, dt_name, what, tol=None):
    """``_row_err`` within the atol of ``TOL`` (or ``tol``); raises."""
    limit = (tol or TOL[dt_name])[1]
    max_abs, row_err = _row_err(got, want)
    if not row_err <= limit:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"row-scaled error {row_err} above {limit}")
    return max_abs, row_err


def phase_kernel():
    import torch

    from repro_torch.codegen import CONTRACT, contract_ref
    from repro_torch.core.enumerate import matmul_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # M = 4: one decode step of the serve path's 4 lanes; 128 and 512:
    # prefills
    cases = [(m, k, n, "bfloat16") for m in (4, 128, 512)
             for (k, n) in LAYER_GEMMS]
    cases.append((128, 4096, 4096, "float32"))
    rows = []
    for m, k, n, dt_name in cases:
        dt = getattr(torch, dt_name)
        a = torch.randn(m, k, generator=gen, device=dev).to(dt)
        b = torch.randn(k, n, generator=gen, device=dev).to(dt)
        spec = matmul_spec(m, k, n)
        got = CONTRACT(a[None], b[None], dt)[0]
        body = _body(CONTRACT)
        want = contract_ref(spec, a, b, out_dtype=dt)
        torch.cuda.synchronize()
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"contract kernel at M={m} K={k} N={n} "
            f"{dt_name}"
        )
        ms = _timed(lambda: CONTRACT(a[None], b[None], dt), flush)
        device_ms, _, _ = _kernel_ms(lambda: CONTRACT(a[None], b[None], dt),
                                  flush, "contract")
        plain_ms = _timed(lambda: contract_ref(spec, a, b, out_dtype=dt),
                          flush, **PLAIN_REPS)
        library_ms = _timed(lambda: torch.matmul(a, b), flush)
        ops = 2.0 * m * n * k
        nbytes = (m * k + k * n + m * n) * a.element_size()
        ops_ms = ops / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        extra = {}
        if dt_name == "float32":
            # the tc32 body, one launch and nothing else; its bound at
            # 3xTF32's rate, the FMA pipes' beside it
            if CONTRACT.last_body != "tc32":
                raise AssertionError(f"kernel M={m} K={k} N={n} float32: "
                                     f"body {body}, expected tc32")
            run = lambda: CONTRACT(a[None], b[None], dt)  # noqa: E731
            what = f"kernel M={m} K={k} N={n} float32"
            extra["takes"] = _alone(run, "contract", 1, what)
            extra["witness_records"], extra["witness_event_ms"] = (
                _launch_witness(run, "contract", what, device_ms))
            extra["fma_bound_ms"] = max(ops_ms, bytes_ms)
            ops_ms = ops / PEAK_3XTF32 * 1e3
        if m < 64 and dt_name == "bfloat16":
            # decode: the narrow body, one launch and nothing else (no
            # counter fill, no operand copy)
            if CONTRACT.last_body != "narrow":
                raise AssertionError(f"kernel M={m} K={k} N={n}: body "
                                     f"{body}, expected the narrow body")
            run = lambda: CONTRACT(a[None], b[None], dt)  # noqa: E731
            what = f"kernel M={m} K={k} N={n}"
            extra["takes"] = _alone(run, "contract", 1, what)
            extra["witness_records"], extra["witness_event_ms"] = (
                _launch_witness(run, "contract", what, device_ms))
        row = dict(M=m, K=k, N=n, dtype=dt_name, body=body, **extra,
                   max_abs_err=max_abs, scaled_err=scaled_err,
                   ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   tflops=ops / ms / 1e9)
        rows.append(row)
        fma = (f", {extra['fma_bound_ms']:.4f} at the FMA pipes"
               if "fma_bound_ms" in extra else "")
        print(f"[kernel] M={m} K={k} N={n} {dt_name} ({body}): scaled err "
              f"{scaled_err:.3g}, {ms:.4f} ms, device {device_ms:.4f} "
              f"(plain {plain_ms:.4f}, torch.matmul {library_ms:.4f}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}{fma}), "
              f"{row['tflops']:.1f} TFLOP/s", flush=True)
    for m in (4, 128, 512):
        part = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in rows
                if r["M"] == m and r["dtype"] == "bfloat16"]
        tot = {key: sum(r[key] * c for r, c in part)
               for key in ("ms", "device_ms", "library_ms", "bound_ms")}
        print(f"[kernel] per layer at M={m} (7 GEMMs, "
              f"{part[0][0]['body'].split()[0]}): {tot['ms']:.4f} ms, device "
              f"{tot['device_ms']:.4f} (torch.matmul {tot['library_ms']:.4f}, "
              f"bound {tot['bound_ms']:.4f}; "
              f"{nbytes_per_layer(m) / tot['device_ms'] / 1e9:.3f} TB/s on "
              f"the device)", flush=True)
    # one decode layer's 7 GEMMs through ops.dense, as the serve path calls
    # them: 7 launches and no other device work
    from repro_torch import ops

    xs = torch.randn(4, 4096, generator=gen, device=dev).to(torch.bfloat16)
    ws = [torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
          for (k, n), c in LAYER_GEMMS.items() for _ in range(c)]
    hs = {4096: xs, 12288: torch.randn(4, 12288, generator=gen,
                                       device=dev).to(torch.bfloat16)}

    def layer():
        for w in ws:
            ops.dense(hs[w.shape[0]], w)

    _alone(layer, "contract", len(ws), "ops.dense at a decode layer's GEMMs")
    _launch_witness(layer, "contract", "ops.dense at a decode layer's GEMMs")
    return rows


def nbytes_per_layer(m):
    """Bytes of a qwen3-8b layer's 7 bf16 GEMMs at M tokens: each input
    read once, each output written once."""
    return sum(c * 2 * (m * k + k * n + m * n)
               for (k, n), c in LAYER_GEMMS.items())


def phase_grouped():
    """Kernel B3 against ``grouped_ref`` at kimi-k2's expert shapes."""
    import numpy as np
    import torch

    from repro_torch import codegen
    from repro_torch.core.enumerate import GroupedSpec, grouped_matmul_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    E = N_EXPERTS
    slabs = {
        shape: torch.randn((E, *shape), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        for shape in (GROUPED_GATE, GROUPED_DOWN)
    }
    rng = np.random.default_rng(0)
    ragged = rng.integers(0, 33, E)
    ragged[::7], ragged[3::11], ragged[5] = 0, 1, 100
    cases = [(name, (c,) * E, shape, "bfloat16", False)
             for c in (16, 8, 4)
             for name, shape in (("gate/up", GROUPED_GATE),
                                 ("down", GROUPED_DOWN))]
    cases += [
        ("ragged", tuple(int(v) for v in ragged), GROUPED_GATE, "bfloat16",
         False),
        ("dX of gate/up", (16,) * E, GROUPED_GATE, "bfloat16", True),
        ("f32", (4,) * E, (1024, 1024), "float32", False),
        # groups larger than one M tile (128-row blocks, ragged tails)
        ("ragged large", GROUPED_LARGE, GROUPED_GATE, "bfloat16", False),
        ("ragged large dX", GROUPED_LARGE, GROUPED_GATE, "bfloat16", True),
    ]
    # the MoE training path: 32 experts of C = 320, forward and dX
    train = (MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS
    cases += [
        ("train gate/up", train, GROUPED_GATE, "bfloat16", False),
        ("train down", train, GROUPED_DOWN, "bfloat16", False),
        ("train dX of gate/up", train, GROUPED_GATE, "bfloat16", True),
        ("train dX of down", train, GROUPED_DOWN, "bfloat16", True),
    ]
    rows = []
    for name, sizes, (k, n), dt_name, contract_last in cases:
        dt = getattr(torch, dt_name)
        G = len(sizes)
        if dt_name == "bfloat16":
            w = slabs[(k, n)][:G]
        else:
            w = torch.randn((G, k, n), generator=gen, device=dev, dtype=dt)
        kx, nx = (n, k) if contract_last else (k, n)  # the product's K, N
        x = torch.randn((sum(sizes), kx), generator=gen, device=dev).to(dt)
        if contract_last:  # grouped_matmul.dX: dout (n, f) . w (g, k, f)
            spec = GroupedSpec(
                name="grouped_matmul.dX",
                operands={"dout": ("n", "f"), "W": ("g", "k", "f")},
                output=("n", "k"),
                extents={"n": sum(sizes), "k": k, "f": n, "g": G},
                group_sizes=sizes,
            )
        else:
            spec = grouped_matmul_spec(sizes, k, n)
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        got = kern(x, w)
        want = codegen.grouped_ref(x, w, sizes, out_dtype=dt,
                                   contract_last=contract_last)
        torch.cuda.synchronize()
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"grouped kernel ({name}, {dt_name})"
        )
        ms = _timed(lambda: kern(x, w), flush)
        plain_ms = _timed(lambda: codegen.grouped_ref(
            x, w, sizes, out_dtype=dt, contract_last=contract_last), flush,
            **PLAIN_REPS)
        library_ms = None
        if len(set(sizes)) == 1:  # one bmm over the (E, C, K) layout
            xb = x.view(G, sizes[0], kx)
            wb = w.transpose(1, 2) if contract_last else w
            library_ms = _timed(lambda: torch.bmm(xb, wb), flush)
        live = sum(1 for v in sizes if v)
        n_rows = sum(sizes)
        ops = 2.0 * n_rows * kx * nx
        nbytes = (n_rows * kx + live * kx * nx + n_rows * nx) * x.element_size()
        ops_ms = ops / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(case=name, C=sizes[0] if len(set(sizes)) == 1 else None,
                   rows=n_rows, groups=live, K=kx, N=nx, dtype=dt_name,
                   max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   gbps=nbytes / ms / 1e6)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[grouped] {name} rows={n_rows} groups={live} K={kx} N={nx} "
              f"{dt_name}: scaled err {scaled_err:.3g}, {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, torch.bmm {lib}, bound {row['bound_ms']:.4f} "
              f"by {row['bound_by']}), {row['gbps']:.0f} GB/s", flush=True)
    del slabs, w, x, got, want, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_b1_train():
    """B1 at one qwen3-8b layer's training GEMMs, M = 2048 tokens (batch 4
    x 512): each forward product and its derived backward specs
    ``matmul.dA`` (dout . W^T) and ``matmul.dB`` (x^T . dout), compiled
    through ``ops._tuned_kernel`` and called with the operands the
    backward hands them, against ``contract_ref``; timed as phase 3, with
    ``torch.matmul`` of the same product as the library yardstick.  Every
    row must run on the ring body and launch no other device kernel (no
    copy of a transposed operand or of the result)."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import CONTRACT, contract_ref
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.grad import derived_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dt, dt_name = torch.bfloat16, "bfloat16"
    m = TRAIN_M
    rows = []
    for k, n in LAYER_GEMMS:
        x = torch.randn(m, k, generator=gen, device=dev).to(dt)
        w = torch.randn(k, n, generator=gen, device=dev).to(dt)
        dout = torch.randn(m, n, generator=gen, device=dev).to(dt)
        spec = matmul_spec(m, k, n)
        dsp = derived_specs(spec)
        cases = (
            ("fwd", spec, (x, w), lambda: torch.matmul(x, w)),
            ("dA", dsp["A"], (dout, w), lambda: torch.matmul(dout, w.T)),
            ("dB", dsp["B"], (dout, x), lambda: torch.matmul(x.T, dout)),
        )
        for what, sp, args, library in cases:
            kern = ops._tuned_kernel(sp, dt)
            got = kern(*args)
            body = _body(CONTRACT)
            want = contract_ref(sp, *args, out_dtype=dt)
            torch.cuda.synchronize()
            max_abs, scaled_err = _check_close(
                got, want, dt_name, f"contract kernel {sp.name} at M={m} "
                f"K={k} N={n}")
            ms = _timed(lambda: kern(*args), flush)
            device_ms, others, _ = _kernel_ms(lambda: kern(*args), flush,
                                           "contract")
            if CONTRACT.last_body != "ring" or others:
                raise AssertionError(
                    f"b1-train {sp.name} M={m} K={k} N={n}: body {body}, "
                    f"other device kernels {others}; expected the ring "
                    f"alone")
            plain_ms = _timed(lambda: contract_ref(sp, *args, out_dtype=dt),
                              flush, **PLAIN_REPS)
            library_ms = _timed(library, flush)
            ops_ = 2.0 * m * n * k
            out_elems = got.numel()
            in_elems = sum(a.numel() for a in args)
            nbytes = (in_elems + out_elems) * 2
            ops_ms = ops_ / PEAK_OPS[dt_name] * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            row = dict(gemm=what, spec=sp.name, M=m, K=k, N=n, dtype=dt_name,
                       body=body, max_abs_err=max_abs, scaled_err=scaled_err,
                       ms=ms, device_ms=device_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                       bytes_ms=bytes_ms,
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes",
                       tflops=ops_ / ms / 1e9)
            rows.append(row)
            print(f"[b1-train] {sp.name} M={m} K={k} N={n} ({body}): "
                  f"scaled err {scaled_err:.3g}, {ms:.4f} ms, device "
                  f"{device_ms:.4f} (plain {plain_ms:.4f}, torch.matmul "
                  f"{library_ms:.4f}, bound {row['bound_ms']:.4f} by "
                  f"{row['bound_by']}), {row['tflops']:.1f} TFLOP/s",
                  flush=True)
    for what in ("fwd", "dA", "dB"):
        part = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in rows
                if r["gemm"] == what]
        tot = {key: sum(r[key] * c for r, c in part)
               for key in ("ms", "device_ms", "plain_ms", "library_ms",
                           "bound_ms")}
        print(f"[b1-train] per layer, {what} (7 GEMMs): {tot['ms']:.4f} ms, "
              f"device {tot['device_ms']:.4f} (plain {tot['plain_ms']:.4f}, "
              f"torch.matmul {tot['library_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f})", flush=True)
    del x, w, dout, got, want, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_grouped_dw():
    """Kernel B4 against ``grouped_dw_ref``: kimi-k2's full expert shapes
    (384 groups of C = 28, a 1024-token step), the MoE training path's
    (32 groups of C = 320), a ragged partition with empty and size-1
    groups, and one float32 case.  Timed as phase 4, with ``torch.bmm``
    over the uniform (E, C, K) layout as the library yardstick; the bound
    counts x, dout and the output once each."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.codegen import GROUPED_DW, grouped_dw_ref
    from repro_torch.core.enumerate import GroupedSpec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(1)
    ragged = rng.integers(0, 57, N_EXPERTS)
    ragged[::7], ragged[3::11] = 0, 1
    full = (28,) * N_EXPERTS
    train = (MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS
    cases = [
        ("gate/up", full, GROUPED_GATE, "bfloat16"),
        ("down", full, GROUPED_DOWN, "bfloat16"),
        ("train gate/up", train, GROUPED_GATE, "bfloat16"),
        ("train down", train, GROUPED_DOWN, "bfloat16"),
        ("ragged", tuple(int(v) for v in ragged), GROUPED_GATE, "bfloat16"),
        ("f32", (0, 1) + (16,) * 62, (1024, 1024), "float32"),
    ]
    rows = []
    for name, sizes, (k1, k2), dt_name in cases:
        dt = getattr(torch, dt_name)
        G, n_rows = len(sizes), sum(sizes)
        x = torch.randn((n_rows, k1), generator=gen, device=dev).to(dt)
        dout = torch.randn((n_rows, k2), generator=gen, device=dev).to(dt)
        # grouped_matmul.dW as the backward builds it: out[g, k, f]
        spec = GroupedSpec(
            name="grouped_matmul.dW",
            operands={"dout": ("n", "f"), "X": ("n", "k")},
            output=("g", "k", "f"),
            extents={"n": n_rows, "k": k1, "f": k2, "g": G},
            group_sizes=sizes,
        )
        kern = ops._tuned_kernel(spec, dt)
        got = kern(dout, x)
        body = _body(GROUPED_DW)
        if body != DW_BODIES[dt_name]:
            raise AssertionError(f"grouped dW kernel ({name}): body {body}, "
                                 f"expected {DW_BODIES[dt_name]}")
        want = grouped_dw_ref(x, dout, sizes, out_dtype=dt)
        torch.cuda.synchronize()
        max_abs, scaled_err = _check_close(
            got, want, dt_name, f"grouped dW kernel ({name}, {dt_name})")
        empty = [g for g, v in enumerate(sizes) if not v]
        if empty and not all(bool((got[g] == 0).all()) for g in empty):
            raise AssertionError(f"grouped dW kernel ({name}): an empty "
                                 f"group's slab is not exact zeros")
        del got, want
        torch.cuda.empty_cache()
        run = lambda: kern(dout, x)  # noqa: E731
        # one launch and no other device record: no fill of the output
        takes = _alone(run, "grouped_dw", 1, f"grouped-dw {name}")
        ms = _timed(run, flush)
        device_ms, _, _ = _kernel_ms(run, flush, "grouped_dw")
        plain_ms = _timed(lambda: grouped_dw_ref(x, dout, sizes,
                                                 out_dtype=dt), flush,
                          **PLAIN_REPS)
        library_ms = None
        if len(set(sizes)) == 1:
            xb = x.view(G, sizes[0], k1).transpose(1, 2)
            db = dout.view(G, sizes[0], k2)
            library_ms = _timed(lambda: torch.bmm(xb, db), flush)
        ops_ = 2.0 * n_rows * k1 * k2
        nbytes = (n_rows * (k1 + k2) + G * k1 * k2) * x.element_size()
        ops_ms = ops_ / PEAK_OPS[dt_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(case=name, C=sizes[0] if len(set(sizes)) == 1 else None,
                   rows=n_rows, groups=G,
                   empty_groups=len(empty), K1=k1, K2=k2, dtype=dt_name,
                   body=body, takes=takes, device_ms=device_ms,
                   max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                   bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   gbps=nbytes / ms / 1e6)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[grouped-dw] {name} rows={n_rows} groups={G} (empty "
              f"{len(empty)}) K1={k1} K2={k2} {dt_name} ({body}, device "
              f"{device_ms:.4f}): scaled err "
              f"{scaled_err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"torch.bmm {lib}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}), {row['gbps']:.0f} GB/s", flush=True)
        del x, dout
        torch.cuda.empty_cache()
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


#: the body each grouped-dw row must run, by its operands' dtype
DW_BODIES = {"bfloat16": "ring", "float32": "fma"}


def _bound(ops, nbytes, dt_name, peak=None):
    """(bound ms, ops ms, bytes ms, what bounds it) on an H100 SXM, the
    operations at ``peak`` (default: ``PEAK_OPS`` of the dtype)."""
    ops_ms = ops / (peak or PEAK_OPS[dt_name]) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms), ops_ms, bytes_ms,
            "operations" if ops_ms >= bytes_ms else "bytes")


def _case_row(tag, what, got, want, dt_name, run, plain, library, ops,
              nbytes, flush, err=None, peak=None, **extra):
    """Check ``got`` against ``want`` (unless ``err``, its (max abs, scaled)
    error, was checked already) and time the kernel call ``run``, its
    plain version and the library yardstick (L2 flushed before each
    launch) beside its bound (operations at ``peak``, by default the
    dtype's); one report row, printed."""
    import torch

    torch.cuda.synchronize()
    max_abs, scaled_err = err or _check_close(got, want, dt_name,
                                              f"{tag} {what}")
    ms = _timed(run, flush)
    plain_ms = _timed(plain, flush, **PLAIN_REPS)
    library_ms = _timed(library, flush) if library is not None else None
    bound_ms, ops_ms, bytes_ms, by = _bound(ops, nbytes, dt_name, peak)
    row = dict(case=what, dtype=dt_name, max_abs_err=max_abs,
               scaled_err=scaled_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, ops_ms=ops_ms,
               bytes_ms=bytes_ms, bound_by=by, tflops=ops / ms / 1e9,
               **extra)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
    on = (f" ({extra['body']}, device {extra['device_ms']:.4f})"
          if "device_ms" in extra else "")
    fma = (f", {extra['fma_bound_ms']:.4f} at the FMA pipes"
           if "fma_bound_ms" in extra else "")
    print(f"[{tag}] {what} {dt_name}{on}: scaled err {scaled_err:.3g}, "
          f"{ms:.4f} ms (plain {plain_ms:.4f}, library {lib}, bound "
          f"{bound_ms:.4f} by {by}{fma}), {row['tflops']:.1f} TFLOP/s",
          flush=True)
    return row


#: the body each b1-modes row must run, by its operands' dtype
MODE_BODIES = {"bfloat16": "ring", "float32": "tc32"}


def _mode_body(launcher, dt_name, run, what):
    """The body of ``launcher``'s latest launch (a b1-modes call): a bf16
    call must have run the fused ring, an f32 one the tc32 body, and
    launch nothing else on the device (no copy of an operand or of the
    result, no cast of g, no counter fill)."""
    body = _body(launcher)
    if launcher.last_body != MODE_BODIES[dt_name]:
        raise AssertionError(f"b1-modes {what}: body {body}, expected "
                             f"{MODE_BODIES[dt_name]}")
    _alone(run, "contract", 1, f"b1-modes {what} {dt_name}")
    return body


def _f32_bound(ops, nbytes):
    """An f32 row's bound at 3xTF32's rate (the tc32 body), and the FMA
    pipes' bound beside it."""
    return dict(peak=PEAK_3XTF32,
                fma_bound_ms=_bound(ops, nbytes, "float32")[0])


def _matmul_then_tail(a, b, epi, vectors):
    """The library yardstick of a product with an epilogue: one
    ``torch.matmul``, then the tail in eager PyTorch ops
    (``Epilogue.apply``)."""
    import torch

    return epi.apply(torch.matmul(a, b).float(), vectors).to(a.dtype)


def phase_b1_modes():
    """B1's new modes against ``contract_ref`` at the fused path's shape
    (M = 2048, D = 4096, F = 12288): every epilogue variant (5 activations
    x norm on/off x bf16/f32; norm off takes scale and bias, norm on bias
    and (mean, var) as ``ops.dense_act``), then ``weighted_matmul`` and its
    derived ``.dA``, ``.dB`` (vector mode) and ``.dg`` (row-reduce mode)
    in bf16, each as the backward launches it.  Library yardsticks:
    ``torch.matmul`` then the same element-wise tail in eager PyTorch."""
    import torch

    from repro_torch import codegen, ops
    from repro_torch.codegen import CONTRACT, contract_ref
    from repro_torch.core.enumerate import matmul_spec, weighted_matmul_spec
    from repro_torch.grad import derived_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    m, d, f = FUSED_M, FUSED_D, FUSED_F
    spec = matmul_spec(m, d, f)
    vec = {"scale": torch.randn(f, generator=gen, device=dev),
           "bias": torch.randn(f, generator=gen, device=dev),
           "mean": torch.randn(f, generator=gen, device=dev) * 0.1,
           "var": torch.rand(f, generator=gen, device=dev) + 0.5}
    rows = []
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        x = (torch.randn(m, d, generator=gen, device=dev) / 8).to(dt)
        w = (torch.randn(d, f, generator=gen, device=dev) / 8).to(dt)
        for norm in (False, True):
            for act in ACTS:
                epi = codegen.Epilogue(act=act, bias=True, scale=not norm,
                                       norm=norm)
                vs = {k: vec[k] for k in epi.vector_names}
                kern = ops._tuned_kernel(spec, dt, epilogue=epi)
                got = kern(x, w, **vs)
                what = f"epilogue {act} {'norm' if norm else 'scale'}"
                body = _mode_body(CONTRACT, dt_name, lambda: kern(x, w, **vs),
                                  what)
                device_ms, _, _ = _kernel_ms(lambda: kern(x, w, **vs), flush,
                                          "contract")
                _launch_witness(lambda: kern(x, w, **vs), "contract",
                                f"b1-modes {what} {dt_name}", device_ms)
                want = contract_ref(spec, x, w, out_dtype=dt, epilogue=epi,
                                    vectors=vs)
                lib = (lambda: _matmul_then_tail(x, w, epi,  # noqa: E731
                                                 vs))
                nbytes = (m * d + d * f + m * f) * x.element_size() + (
                    4 * f * len(vs))
                ops_ = 2.0 * m * d * f
                f32 = (_f32_bound(ops_, nbytes) if dt_name == "float32"
                       else {})
                rows.append(_case_row(
                    "b1-modes", f"{what} M={m} K={d} N={f}", got, want,
                    dt_name,
                    lambda: kern(x, w, **vs),
                    lambda: contract_ref(spec, x, w, out_dtype=dt,
                                         epilogue=epi, vectors=vs),
                    lib, ops_, nbytes, flush, mode="epilogue",
                    act=act, norm=norm, body=body, device_ms=device_ms,
                    **f32))
                del got, want
        if dt_name == "float32":
            # the plain f32 product at the same shape against one
            # torch.matmul in full f32 (main turns TF32 off)
            kern = ops._tuned_kernel(spec, dt)
            got = kern(x, w)
            what = "plain"
            body = _mode_body(CONTRACT, dt_name, lambda: kern(x, w), what)
            device_ms, _, _ = _kernel_ms(lambda: kern(x, w), flush, "contract")
            _launch_witness(lambda: kern(x, w), "contract",
                            f"b1-modes {what} {dt_name}", device_ms)
            want = contract_ref(spec, x, w, out_dtype=dt)
            nbytes = (m * d + d * f + m * f) * 4
            ops_ = 2.0 * m * d * f
            rows.append(_case_row(
                "b1-modes", f"{what} M={m} K={d} N={f}", got, want, dt_name,
                lambda: kern(x, w),
                lambda: contract_ref(spec, x, w, out_dtype=dt),
                lambda: torch.matmul(x, w), ops_, nbytes, flush,
                mode="plain", body=body, device_ms=device_ms,
                **_f32_bound(ops_, nbytes)))
            del got, want
        del x, w
    dt, dt_name = torch.bfloat16, "bfloat16"
    x = (torch.randn(m, d, generator=gen, device=dev) / 8).to(dt)
    w = (torch.randn(d, f, generator=gen, device=dev) / 8).to(dt)
    g = torch.randn(d, generator=gen, device=dev).to(dt)
    dout = (torch.randn(m, f, generator=gen, device=dev) / 8).to(dt)
    wspec = weighted_matmul_spec(m, d, f)
    dsp = derived_specs(wspec)
    cases = (
        ("weighted_matmul", wspec, (x, w, g),
         lambda: torch.matmul(x * g, w)),
        ("weighted_matmul.dA", dsp["A"], (dout, w, g),
         lambda: torch.matmul(dout, w.T) * g),
        ("weighted_matmul.dB", dsp["B"], (dout, x, g),
         lambda: torch.matmul(x.T, dout) * g[:, None]),
        ("weighted_matmul.dg", dsp["g"], (dout, x, w),
         lambda: (torch.matmul(dout, w.T) * x).sum(0)),
    )
    for what, sp, args, lib in cases:
        kern = ops._tuned_kernel(sp, dt)
        got = kern(*args)
        body = _mode_body(CONTRACT, dt_name, lambda: kern(*args), what)
        device_ms, _, _ = _kernel_ms(lambda: kern(*args), flush, "contract")
        _launch_witness(lambda: kern(*args), "contract", f"b1-modes {what}",
                        device_ms)
        want = contract_ref(sp, *args, out_dtype=dt)
        out_elems = want.numel()
        nbytes = (sum(a.numel() for a in args) + out_elems) * 2
        rows.append(_case_row(
            "b1-modes", f"{what} M={m} D={d} F={f}", got, want, dt_name,
            lambda: kern(*args),
            lambda: contract_ref(sp, *args, out_dtype=dt), lib,
            2.0 * m * d * f, nbytes, flush, mode="weighted", spec=what,
            body=body, device_ms=device_ms))
        if what.endswith(".dg"):
            again = kern(*args)
            if not torch.equal(again, got):
                raise AssertionError("weighted_matmul.dg differs between two "
                                     "runs on the same inputs")
        del got, want
    del x, w, g, dout, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_baselines():
    """The hand-written baselines B5 (``matmul_cuda``), B6
    (``fused_dense_act_cuda``, gelu) and B7 (``weighted_matmul_cuda``)
    against their plain versions at the fused path's shape in bf16 (all
    three on the ring body, each also one launch alone with no other
    device work and a launch witness, B7 with g = 0 exact zeros), at a
    ragged shape the ring takes (M = K = N = 1000, bf16), at one it
    refuses by rule (M = 1000, K = 999, N = 1001, bf16: rows of 16 bytes
    TMA cannot read, so ``mma.sync``) and at that shape in f32 (the FMA
    body); blocks = the extents.  Each row with its body (asserted) and
    profiler device ms; library yardsticks ``torch.matmul``,
    ``torch.matmul`` then the epilogue in eager PyTorch,
    ``torch.matmul(a * g, b)``."""
    import torch

    from repro_torch.codegen import Epilogue
    from repro_torch.kernels.fused_dense_act.fused_dense_act import (
        fused_dense_act_cuda,
    )
    from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
    from repro_torch.kernels.fused_rnz.fused_rnz import weighted_matmul_cuda
    from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.matmul.ref import matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    for (m, k, n), dt_name, want_body in (
        ((FUSED_M, FUSED_D, FUSED_F), "bfloat16", "ring"),
        ((1000, 1000, 1000), "bfloat16", "ring"),
        ((1000, 999, 1001), "bfloat16", "mma"),
        ((1000, 999, 1001), "float32", "fma"),
    ):
        dt = getattr(torch, dt_name)
        main = (m, k, n) == (FUSED_M, FUSED_D, FUSED_F)
        a = (torch.randn(m, k, generator=gen, device=dev) / 8).to(dt)
        b = (torch.randn(k, n, generator=gen, device=dev) / 8).to(dt)
        g = torch.randn(k, generator=gen, device=dev).to(dt)
        beta = torch.randn(n, generator=gen, device=dev)
        mean = torch.randn(n, generator=gen, device=dev) * 0.1
        var = torch.rand(n, generator=gen, device=dev) + 0.5
        blk = dict(block_m=m, block_n=n, block_k=k)
        fblk = dict(block_b=m, block_k=n, block_i=k)
        io = (m * k + k * n + m * n) * a.element_size()
        ops_ = 2.0 * m * n * k
        shape = f"M={m} K={k} N={n}"
        cases = (
            ("matmul", lambda: matmul_cuda(a, b, **blk),
             lambda: matmul_ref(a, b), lambda: torch.matmul(a, b), io),
            ("fused_dense_act",
             lambda: fused_dense_act_cuda(a, b, beta, mean, var, act="gelu",
                                          **fblk),
             lambda: fused_dense_act_ref(a, b, beta, mean, var, act="gelu"),
             lambda: _matmul_then_tail(
                 a, b, Epilogue(act="gelu", bias=True, norm=True),
                 {"bias": beta, "mean": mean, "var": var}),
             io + 3 * 4 * n),
            ("fused_rnz", lambda: weighted_matmul_cuda(a, b, g, **blk),
             lambda: weighted_matmul_ref(a, b, g),
             lambda: torch.matmul(a * g, b), io + k * a.element_size()),
        )
        for name, run, plain, lib, nbytes in cases:
            launcher = _launcher(name)
            got, want = run(), plain()
            body = launcher.last_body
            if body != want_body:
                raise AssertionError(f"baselines {name} {shape} {dt_name}: "
                                     f"body {body}, expected {want_body}")
            device_ms, _, _ = _kernel_ms(run, flush, name)
            extra = {}
            if main and body == "ring":
                # one launch and no other device work (no cast or copy of
                # a, b or g)
                what = f"baselines {name} {shape}"
                extra["takes"] = _alone(run, name, 1, what)
                extra["witness_records"], extra["witness_event_ms"] = (
                    _launch_witness(run, name, what, device_ms))
            rows.append(_case_row("baselines", f"{name} {shape}", got, want,
                                  dt_name, run, plain, lib, ops_, nbytes,
                                  flush, kernel=name, M=m, K=k, N=n,
                                  main=main, body=body, device_ms=device_ms,
                                  **extra))
            del got, want
        if dt_name == "bfloat16":
            zero = weighted_matmul_cuda(a, b, torch.zeros_like(g), **blk)
            if not bool((zero == 0).all()):
                raise AssertionError(f"fused_rnz with g = 0 at {shape} is "
                                     f"not exact zeros")
        del a, b
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _baseline_counts():
    from repro_torch.kernels import _baselines

    return {"matmul": _baselines.MATMUL.launches,
            "fused_dense_act": _baselines.FUSED_DENSE_ACT.launches,
            "fused_rnz": _baselines.FUSED_RNZ.launches}


def _zero_baseline_counts():
    from repro_torch.kernels import _baselines

    for k in (_baselines.MATMUL, _baselines.FUSED_DENSE_ACT,
              _baselines.FUSED_RNZ):
        k.launches = 0


def _fused_inputs(m, d, f, dt, device, seed):
    """The fused path's operands: x, w, g, the (F,) epilogue vectors and a
    cotangent, from a seed (on the CPU, then moved)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    t = {"x": torch.randn(m, d, generator=gen) / 8,
         "w": torch.randn(d, f, generator=gen) / 8,
         "g": torch.randn(d, generator=gen),
         "beta": torch.randn(f, generator=gen),
         "mean": torch.randn(f, generator=gen) * 0.1,
         "var": torch.rand(f, generator=gen) + 0.5,
         "cot": torch.randn(m, f, generator=gen)}
    return {k: v.to(device=device, dtype=dt if k in ("x", "w", "g", "cot")
                    else torch.float32) for k, v in t.items()}


def _fused_calls(t, interpret=False):
    """The slice's public entries, in order: (name, forward, backward
    operands or None).  ``interpret`` routes CPU tensors down the kernel
    paths (their plain versions), as the reference's interpret mode."""
    from repro_torch import ops
    from repro_torch.kernels.fused_dense_act.ops import fused_dense_act
    from repro_torch.kernels.fused_rnz.ops import weighted_matmul
    from repro_torch.kernels.matmul.ops import matmul

    x, w, g = t["x"], t["w"], t["g"]
    vec = (t["beta"], t["mean"], t["var"])
    it = dict(interpret=interpret)
    return [
        ("ops.dense_act", lambda *a: ops.dense_act(*a, act="gelu", **it),
         (x, w) + vec),
        ("ops.weighted_dense", lambda *a: ops.weighted_dense(*a, **it),
         (x, w, g)),
        ("kernels.matmul generated", lambda: matmul(x, w, **it), None),
        ("kernels.matmul hand-written",
         lambda: matmul(x, w, use_generated=False, **it), None),
        ("kernels.fused_dense_act generated",
         lambda: fused_dense_act(x, w, *vec, act="gelu", **it), None),
        ("kernels.fused_dense_act hand-written",
         lambda: fused_dense_act(x, w, *vec, act="gelu",
                                 use_generated=False, **it), None),
        ("kernels.fused_rnz", lambda: weighted_matmul(x, w, g, **it), None),
    ]


def _run_fused_calls(t, interpret=False, launches=None):
    """Every call of ``_fused_calls``; the differentiable ones also run
    ``backward()`` with the cotangent.  Returns {name: output} and
    {name: [grads]}; with ``launches`` (a dict) records each call's B1 and
    B5-B7 launch deltas (forward and backward apart)."""
    import torch

    from repro_torch.codegen import CONTRACT

    outs, grads = {}, {}
    for name, fn, args in _fused_calls(t, interpret):
        c0, b0 = CONTRACT.launches, _baseline_counts()
        if args is None:
            outs[name] = fn()
        else:
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            out = fn(*leaves)
            c1 = CONTRACT.launches
            out.backward(t["cot"])
            outs[name] = out.detach()
            grads[name] = [leaf.grad for leaf in leaves]
        if launches is not None:
            b1 = _baseline_counts()
            row = {"contract": CONTRACT.launches - c0,
                   **{k: b1[k] - b0[k] for k in b1}}
            if args is not None:
                row["contract_forward"] = c1 - c0
                row["contract_backward"] = CONTRACT.launches - c1
            launches[name] = row
    if t["x"].is_cuda:
        torch.cuda.synchronize()
    return outs, grads


#: the launches each call of the fused path must make
FUSED_WANT = {
    "ops.dense_act": {"contract": 4, "contract_forward": 1,
                      "contract_backward": 3},
    "ops.weighted_dense": {"contract": 4, "contract_forward": 1,
                           "contract_backward": 3},
    "kernels.matmul generated": {"contract": 1},
    "kernels.matmul hand-written": {"matmul": 1},
    "kernels.fused_dense_act generated": {"contract": 1},
    "kernels.fused_dense_act hand-written": {"fused_dense_act": 1},
    "kernels.fused_rnz": {"fused_rnz": 1},
}


def _plain_fused(t):
    """The plain path of every call on the same tensors: f32 upcasts,
    ``torch.matmul`` and eager element-wise ops, with autograd for the
    gradients."""
    import torch

    from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
    from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref

    x, w, g = t["x"], t["w"], t["g"]
    vec = (t["beta"], t["mean"], t["var"])
    outs, grads = {}, {}
    leaves = [a.detach().float().requires_grad_(True) for a in (x, w) + vec]
    out = fused_dense_act_ref(*leaves, act="gelu")
    out.backward(t["cot"].float())
    outs["ops.dense_act"], grads["ops.dense_act"] = out.detach(), [
        leaf.grad for leaf in leaves]
    leaves = [a.detach().float().requires_grad_(True) for a in (x, w, g)]
    out = torch.matmul(leaves[0] * leaves[2], leaves[1])
    out.backward(t["cot"].float())
    outs["ops.weighted_dense"], grads["ops.weighted_dense"] = out.detach(), [
        leaf.grad for leaf in leaves]
    with torch.no_grad():
        mm = torch.matmul(x.float(), w.float())
        fda = fused_dense_act_ref(x, w, *vec, act="gelu")
        for kind in ("generated", "hand-written"):
            outs[f"kernels.matmul {kind}"] = mm
            outs[f"kernels.fused_dense_act {kind}"] = fda
        outs["kernels.fused_rnz"] = weighted_matmul_ref(x, w, g)
    return outs, grads


def _compare_fused(got, want, dt_name, tag, tol=None, f32_grad_tol=None):
    """Worst scaled error over every output and gradient; with
    ``f32_grad_tol`` (for a bf16 comparison), every f32 gradient is held
    to it and its worst error is returned apart, as
    ``(worst, f32_worst)``."""
    (gout, ggrad), (wout, wgrad) = got, want
    worst = f32_worst = 0.0
    for name in wout:
        _, err = _check_close(gout[name].cpu(), wout[name].cpu(), dt_name,
                              f"{tag} {name} output", tol=tol)
        worst = max(worst, err)
    for name in wgrad:
        for i, (a, b) in enumerate(zip(ggrad[name], wgrad[name])):
            if f32_grad_tol and str(b.dtype) == "torch.float32":
                _, err = _check_close(a.cpu(), b.cpu(), "float32",
                                      f"{tag} {name} f32 grad {i}",
                                      tol=f32_grad_tol)
                f32_worst = max(f32_worst, err)
                continue
            _, err = _check_close(a.cpu(), b.cpu(), dt_name,
                                  f"{tag} {name} grad {i}", tol=tol)
            worst = max(worst, err)
    return (worst, f32_worst) if f32_grad_tol else worst


#: scaled limit for an f32 gradient (dense_act's beta, mean, var) of a
#: bf16 call, card against CPU: both recompute the accumulator and round it
#: to bf16, so one element that rounds to the neighbouring value moves the
#: gradient by about one bf16 ulp of its summed term, far below bf16's TOL
F32_GRAD_OF_BF16_TOL = (5e-3, 5e-3)


def phase_fused_small():
    """The fused path's calls at a small shape (M = 192, D = 256, F = 320)
    on the card (kernels) and on the CPU (plain versions, which the CPU
    tests hold to the JAX reference): in f32, outputs and gradients agree
    at the reference's f32 TOL (2e-4, 2e-4 on gradients); in bf16, at the
    bf16 TOL, and the f32 gradients of the bf16 calls at
    ``F32_GRAD_OF_BF16_TOL``, whose worst reading is printed."""
    import torch

    result = {}
    for dt in (torch.float32, torch.bfloat16):
        cpu = _fused_inputs(192, 256, 320, dt, "cpu", 32)
        card = {k: v.to("cuda") for k, v in cpu.items()}
        launches = {}
        got = _run_fused_calls(card, launches=launches)
        want = _run_fused_calls(cpu, interpret=True)
        name = str(dt).replace("torch.", "")
        if dt == torch.float32:
            worst = _compare_fused(got, want, name, "fused small",
                                   tol=(2e-4, 2e-4))
            extra = ""
        else:
            worst, f32_worst = _compare_fused(
                got, want, name, "fused small bf16",
                f32_grad_tol=F32_GRAD_OF_BF16_TOL)
            result["bf16_f32_grad_worst_scaled_err"] = f32_worst
            extra = (f"; f32 gradients of the bf16 calls within scaled "
                     f"{f32_worst:.3g} (limit {F32_GRAD_OF_BF16_TOL[0]})")
        for call, need in FUSED_WANT.items():
            have = {k: v for k, v in launches[call].items() if v}
            if have != need:
                raise AssertionError(f"fused small {name}: {call} launched "
                                     f"{have}, expected {need}")
        result[f"{name}_worst_scaled_err"] = worst
        print(f"[fused-small] 7 calls, M=192 D=256 F=320 {name}: card vs "
              f"CPU outputs and gradients within scaled {worst:.3g}{extra}; "
              f"launches as expected", flush=True)
    return result


def phase_fused_path():
    """The slice's path at full width through the public entries only:
    ``ops.dense_act(act="gelu")`` and ``ops.weighted_dense`` forward and
    ``backward()``, ``kernels.matmul.ops.matmul`` and
    ``kernels.fused_dense_act.ops.fused_dense_act`` with ``use_generated``
    true and false, ``kernels.fused_rnz.ops.weighted_matmul``, at qwen3-8b's
    MLP projection (M = 2048, D = 4096, F = 12288, bf16).  Launch counts
    from counters zeroed just before; outputs and gradients against the
    plain path on the card at the bf16 TOL; then the same calls once more
    under ``torch.profiler``: no device kernel of the path may be a
    library GEMM (cuBLAS, CUTLASS), and each kernel's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.codegen import CONTRACT

    t = _fused_inputs(FUSED_M, FUSED_D, FUSED_F, torch.bfloat16, "cuda", 33)
    CONTRACT.launches = 0
    _zero_baseline_counts()
    launches = {}
    t0 = time.perf_counter()
    got = _run_fused_calls(t, launches=launches)
    wall = time.perf_counter() - t0
    totals = {"contract": CONTRACT.launches, **_baseline_counts()}
    for name, need in FUSED_WANT.items():
        have = {k: v for k, v in launches[name].items() if v}
        if have != need:
            raise AssertionError(f"fused path: {name} launched {have}, "
                                 f"expected {need}")
    want = _plain_fused(t)
    worst = _compare_fused(got, want, "bfloat16", "fused path")
    del got, want
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_fused_calls(t)
    path = os.path.join(OUT, "profile_fused.json")
    prof.export_chrome_trace(path)
    busy, events, by_name = _device_time(path)
    library = {k: v for k, v in by_name.items()
               if _category(k) == "cublas"}
    if library:
        raise AssertionError(f"fused path: library GEMMs on the path: "
                             f"{sorted(library)}")
    kern_ms = {}
    for k, (ms, n) in by_name.items():
        kern = _kernel_of(k)
        if kern:
            row = kern_ms.setdefault(kern, [0.0, 0])
            row[0] += ms
            row[1] += n
    measured = (f"device busy {busy:.3f} ms over {events} events; "
                + "; ".join(f"{k} {v[0]:.3f} ms over {v[1]}"
                            for k, v in sorted(kern_ms.items()))
                if by_name else "device time not measured (the profiler saw "
                "no device events)")
    print(f"[fused-path] M={FUSED_M} D={FUSED_D} F={FUSED_F} bf16: launches "
          f"{totals} (per call {json.dumps(launches)}); outputs and "
          f"gradients within scaled {worst:.3g} of the plain path; wall "
          f"{wall * 1e3:.1f} ms; no library GEMM; {measured}", flush=True)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=totals, per_call=launches, worst_scaled_err=worst,
                wall_ms=wall * 1e3, device_busy_ms=busy if by_name else None,
                kernels={k: {"ms": v[0], "launches": v[1]}
                         for k, v in kern_ms.items()})


def _small_dense_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen3-8b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512, dtype="float32",
    )


def phase_small_model():
    """The port on the card (kernel path) against the port on the CPU
    (plain path, which the CPU tests hold to the JAX reference)."""
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T

    cfg = _small_dense_config()
    cpu_params = T.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    gpu_params = T._tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=rng)
    lengths = torch.tensor([128, 71])
    before = CONTRACT.launches
    with torch.inference_mode():
        lc, cc = T.prefill(cpu_params, cfg, tokens, 131, lengths=lengths)
        lg, cg = T.prefill(gpu_params, cfg, tokens.cuda(), 131,
                           lengths=lengths.cuda())
        worst = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
        for _ in range(2):
            nxt = torch.randint(0, cfg.vocab, (2, 1), generator=rng)
            lc, cc = T.decode_step(cpu_params, cfg, cc, nxt)
            lg, cg = T.decode_step(gpu_params, cfg, cg, nxt.cuda())
            worst = max(worst, (lg.cpu() - lc).abs().max().item()
                        / lc.abs().max().item())
    if CONTRACT.launches - before != 7 * cfg.n_layers * 3:
        raise AssertionError("small model: a prefill and two decode steps "
                             "did not run the kernel for all 7 x n_layers "
                             "GEMMs of each")
    if not worst <= 1e-4:
        raise AssertionError(f"small model: card and CPU logits differ by "
                             f"{worst} (scaled)")
    outs = {}
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        trace = synthetic_trace(3, vocab=cfg.vocab, seed=5, rate_hz=0.0,
                                prompt_lens=(60, 128), max_news=(4, 6))
        ContinuousEngine(cfg, lanes=2, page_size=128, n_pages=5,
                         max_ctx=256, params=params, device=device).run(trace)
        outs[device] = [r.out_tokens for r in trace]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"small model: greedy tokens differ, card "
                             f"{outs['cuda']} vs CPU {outs['cpu']}")
    print(f"[small] 2-layer f32 model: card vs CPU logits scaled diff "
          f"{worst:.3g}, greedy tokens equal {outs['cuda']}", flush=True)


def _small_moe_config():
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, dtype="float32",
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                expert_ff=256, shared_expert_ff=256,
                                dense_ff=512, first_dense=1),
    )


def _moe_layers(cfg):
    from repro_torch.models.transformer import segment_plan

    return sum(pattern.count("moe") * count
               for pattern, count in segment_plan(cfg))


def phase_small_moe():
    """The MoE model on the card (B1 and B3) against the CPU (plain
    versions), under ``REPRO_MOE_GROUPED=1``."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T

    cfg = _small_moe_config()
    n_moe = _moe_layers(cfg)
    cpu_params = T.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    gpu_params = T._tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=rng)
    lengths = torch.tensor([128, 71])
    c0, g0 = CONTRACT.launches, GROUPED.launches
    with torch.inference_mode():
        lc, cc = T.prefill(cpu_params, cfg, tokens, 131, lengths=lengths)
        lg, cg = T.prefill(gpu_params, cfg, tokens.cuda(), 131,
                           lengths=lengths.cuda())
        worst = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
        for _ in range(2):
            nxt = torch.randint(0, cfg.vocab, (2, 1), generator=rng)
            lc, cc = T.decode_step(cpu_params, cfg, cc, nxt)
            lg, cg = T.decode_step(gpu_params, cfg, cg, nxt.cuda())
            worst = max(worst, (lg.cpu() - lc).abs().max().item()
                        / lc.abs().max().item())
    if GROUPED.launches - g0 != 3 * n_moe * 3:
        raise AssertionError(f"small MoE model: grouped kernel launched "
                             f"{GROUPED.launches - g0} times over 3 "
                             f"forwards, expected {3 * n_moe * 3}")
    want = len(_forward_gemms(cfg)) * 3
    if CONTRACT.launches - c0 != want:
        raise AssertionError(f"small MoE model: contraction kernel launched "
                             f"{CONTRACT.launches - c0} times in a prefill "
                             f"and two decode steps, expected {want}")
    if not worst <= 1e-4:
        raise AssertionError(f"small MoE model: card and CPU logits differ "
                             f"by {worst} (scaled)")
    outs, launched = {}, 0
    for device, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        trace = synthetic_trace(3, vocab=cfg.vocab, seed=5, rate_hz=0.0,
                                prompt_lens=(60, 128), max_news=(4, 6))
        g0 = GROUPED.launches
        stats = ContinuousEngine(cfg, lanes=2, page_size=128, n_pages=5,
                                 max_ctx=256, params=params,
                                 device=device).run(trace)
        launched = GROUPED.launches - g0
        want = 3 * n_moe * (stats["prefills"] + stats["decode_steps"])
        if device == "cuda" and launched != want:
            raise AssertionError(f"small MoE engine: grouped kernel launched "
                                 f"{launched} times, expected {want}")
        outs[device] = [r.out_tokens for r in trace]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"small MoE model: greedy tokens differ, card "
                             f"{outs['cuda']} vs CPU {outs['cpu']}")
    print(f"[small-moe] 2-layer f32 kimi-k2 variant ({cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k}): card vs CPU logits scaled diff "
          f"{worst:.3g}, greedy tokens equal {outs['cuda']}, grouped kernel "
          f"launches in the engine run {launched}", flush=True)


def _launch_counts():
    from repro_torch.codegen import CONTRACT, GROUPED, GROUPED_DW

    return {"contract": CONTRACT.launches, "grouped": GROUPED.launches,
            "grouped_dw": GROUPED_DW.launches}


def _zero_launch_counts():
    from repro_torch.codegen import CONTRACT, GROUPED, GROUPED_DW

    CONTRACT.launches = GROUPED.launches = GROUPED_DW.launches = 0


def _warm_state(params, opt_cfg, seed):
    """An AdamW state with seeded moments (|m| ~ 1e-3, v >= 1e-6) at step
    10, so one update is continuous in the gradient (from a zero state the
    first update is sign(g) and a gradient at roundoff level could flip)."""
    import torch

    from repro_torch.optim import init
    from repro_torch.optim.adamw import leaves

    state = init(params, opt_cfg)
    gen = torch.Generator().manual_seed(seed)
    for (_, m), (_, v) in zip(leaves(state.m), leaves(state.v)):
        m.copy_(torch.randn(m.shape, generator=gen) * 1e-3)
        v.copy_(torch.rand(v.shape, generator=gen) * 1e-3 + 1e-6)
    return state._replace(step=torch.tensor(10, dtype=torch.int32))


def phase_small_train():
    """One train step on the card (kernel paths and their
    ``autograd.Function``s) against the CPU (plain versions, which the CPU
    tests hold to the JAX reference), from the same weights and optimizer
    state: the 2-layer 128-aligned qwen3-8b variant and the small kimi-k2
    variant under ``REPRO_MOE_GROUPED=1`` (f32, batch 2 x 128).  Every
    parameter must receive a finite, non-zero gradient on the card, the
    gradients, loss, grad norm and updated parameters must agree at the
    reference's f32 TOL (2e-4, 2e-4, scaled by max|CPU value|), and the
    step must launch B1 28 times per layer, B3 9 and B4 3 times per MoE
    layer."""
    import torch

    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves, tree_map

    grad_tol = (2e-4, 2e-4)
    out = {}
    for tag, cfg, seed in (("dense", _small_dense_config(), 8),
                           ("moe", _small_moe_config(), 9)):
        api = get_api(cfg)
        n_moe = _moe_layers(cfg)
        opt_cfg = AdamWConfig(lr=3e-3)
        cpu_params = T.init(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
        cpu_state = _warm_state(cpu_params, opt_cfg, seed)
        gpu_state = cpu_state._replace(
            step=cpu_state.step.cuda(),
            m=tree_map(lambda t: t.to("cuda"), cpu_state.m),
            v=tree_map(lambda t: t.to("cuda"), cpu_state.v))
        gen = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab, (2, 129), generator=gen)
        cpu_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        gpu_batch = {k: v.cuda() for k, v in cpu_batch.items()}

        def loss_fn(p, b):
            return api.loss(p, cfg, b)

        lc, gcpu = value_and_grad(loss_fn, cpu_params, cpu_batch)
        lg, ggpu = value_and_grad(loss_fn, gpu_params, gpu_batch)
        worst = 0.0
        for (path, g), (_, want) in zip(leaves(ggpu), leaves(gcpu)):
            name = "/".join(path)
            if not bool(torch.isfinite(g).all()) or not bool(
                (g != 0).any()
            ):
                raise AssertionError(f"small train ({tag}): parameter {name} "
                                     f"got no finite gradient on the card")
            _, err = _check_close(g.cpu(), want, "float32",
                                  f"small train ({tag}) grad of {name}",
                                  tol=grad_tol)
            worst = max(worst, err)
        del gcpu, ggpu
        step = make_train_step(cfg, opt_cfg)
        cpu_params, cpu_state, mc = step(cpu_params, cpu_state, cpu_batch)
        _zero_launch_counts()
        gpu_params, gpu_state, mg = step(gpu_params, gpu_state, gpu_batch)
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = {"contract": B1_PER_LAYER_STEP * cfg.n_layers,
                "grouped": B3_PER_MOE_STEP * n_moe,
                "grouped_dw": B4_PER_MOE_STEP * n_moe}
        if launches != want:
            raise AssertionError(f"small train ({tag}): kernel launches "
                                 f"{launches}, expected {want}")
        for key in ("loss", "grad_norm"):
            _check_close(mg[key].cpu(), mc[key], "float32",
                         f"small train ({tag}) {key}", tol=grad_tol)
        for (path, p), (_, want_p) in zip(leaves(gpu_params),
                                          leaves(cpu_params)):
            _, err = _check_close(p.detach().cpu(), want_p.detach(),
                                  "float32", f"small train ({tag}) updated "
                                  f"{'/'.join(path)}", tol=grad_tol)
            worst = max(worst, err)
        out[tag] = dict(loss_card=float(mg["loss"]), loss_cpu=float(mc["loss"]),
                        grad_norm_card=float(mg["grad_norm"]),
                        grad_norm_cpu=float(mc["grad_norm"]),
                        worst_scaled_err=worst, launches=launches)
        print(f"[small-train] {tag} ({cfg.n_layers} layers, {n_moe} MoE): "
              f"loss card {float(mg['loss']):.6f} vs CPU "
              f"{float(mc['loss']):.6f}, grad norm "
              f"{float(mg['grad_norm']):.6f} vs {float(mc['grad_norm']):.6f}, "
              f"grads and updated params within scaled {worst:.3g}; "
              f"launches {launches}", flush=True)
        del cpu_params, gpu_params, cpu_state, gpu_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(tag, arch, flags, cut):
    """A training path through ``launch.train``'s own entry points: the
    flags through ``parse_args``, the config cut by ``cut`` (depth, and
    experts for the MoE path; every width as published), ``train()`` from
    seed 0.  Checks finite losses and grad norms and the launch counts
    derived from the segment plan; prints the step time (host clock to
    the loss's synchronize), tokens/s and peak memory.  Returns the
    summary and the trained state for the profile."""
    import statistics

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import leaves

    full = get_config(arch)
    cfg = cut(full)
    args = train_mod.parse_args(flags)
    run = train_mod.run_from_args(cfg, args)
    n_moe = _moe_layers(cfg)
    tokens = args.batch * args.seq
    print(f"[{tag}] {arch}: n_layers {full.n_layers} -> {cfg.n_layers}"
          + (f", experts {full.moe.n_experts} -> {cfg.moe.n_experts} "
             f"(top-{cfg.moe.top_k})" if cfg.moe else "")
          + f"; d_model {cfg.d_model}, {cfg.n_heads} x {cfg.hd} heads, "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; batch {args.batch} x {args.seq}, {args.steps} "
          f"steps, {args.moments} moments", flush=True)
    obs.metrics_reset()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    (params, opt_state), losses, report = train_mod.train(run, verbose=False)
    took = time.perf_counter() - t0
    launches = _launch_counts()
    grad_norms = list(obs.histogram("train.grad_norm").values)
    if len(losses) != args.steps or len(grad_norms) != args.steps:
        raise AssertionError(f"{tag}: {len(losses)} losses and "
                             f"{len(grad_norms)} grad norms for "
                             f"{args.steps} steps")
    if not all(map(math.isfinite, losses + grad_norms)):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: "
                             f"{losses}, {grad_norms}")
    want = {"contract": B1_PER_LAYER_STEP * cfg.n_layers * args.steps,
            "grouped": B3_PER_MOE_STEP * n_moe * args.steps,
            "grouped_dw": B4_PER_MOE_STEP * n_moe * args.steps}
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want} (B1 {B1_PER_LAYER_STEP} x "
                             f"{cfg.n_layers} layers, B3 {B3_PER_MOE_STEP} "
                             f"and B4 {B4_PER_MOE_STEP} x {n_moe} MoE "
                             f"layers, x {args.steps} steps)")
    peak = torch.cuda.max_memory_allocated()
    steps_s = list(report.step_times)
    steady = statistics.median(steps_s[1:]) if len(steps_s) > 1 else steps_s[0]
    n_params = sum(t.numel() for _, t in leaves(params))
    summary = dict(arch=arch, n_layers=cfg.n_layers,
                   n_experts=cfg.moe.n_experts if cfg.moe else None,
                   batch=args.batch, seq=args.seq, steps=args.steps,
                   moments=args.moments, params=n_params, losses=losses,
                   grad_norms=grad_norms, step_s=steps_s,
                   steady_step_s=steady, tokens_per_s=tokens / steady,
                   wall_s=took, max_memory_allocated=peak,
                   launches=launches)
    print(f"[{tag}] {n_params / 1e9:.3f} B parameters; losses "
          f"{[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 3) for v in grad_norms]}", flush=True)
    print(f"[{tag}] step times (host clock to the loss's synchronize) "
          f"{[round(v * 1e3, 1) for v in steps_s]} ms; steady "
          f"{steady * 1e3:.1f} ms = {tokens / steady:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches} = expected; wall {took:.1f} s", flush=True)
    return summary, cfg, run, params, opt_state


def _kernel_of(name):
    """The port's kernel a device-kernel name belongs to, or None."""
    import re

    if re.search(r"\battn_(bf16|f32)(_ring|_tc)?_kernel", name):
        return "attention"
    hit = re.search(r"\b(q8_(mma|ring|ring_persistent)_kernel<(true|false)"
                    r"(, \d)?>|"
                    r"upcast_kernel|chain_(bf16|scalar)_kernel)", name)
    if hit:
        word = hit.group(1)
        if word.startswith("q8"):
            return "contract_int8" if "true" in word else "contract_fp8"
        return "contract_upcast" if word.startswith("up") else (
            "contract_chain")
    hit = re.search(r"\bbaseline_(bf16_ring|bf16|f32)_kernel<[^,<>]+, "
                    r"(\d)\b", name)
    if hit:  # B5, B6, B7 by the kind, the template's second argument
        return BASELINES[int(hit.group(2))]
    if re.search(r"\bgrouped_(wgmma|serve)_kernel", name):
        return "grouped"  # B3's 128-row and serving bodies
    hit = re.search(r"\b(grouped_dw|grouped|contract)_"
                    r"(bf16_ring|bf16_narrow|bf16_mma|bf16|f32_tc|f32)"
                    r"(_fused)?_kernel", name)
    return hit.group(1) if hit else None


def _category(name):
    """A device kernel's kind: one of the port's kernels, a cuBLAS product,
    or PyTorch's element-wise, copy, reduction and other kernels."""
    kernel = _kernel_of(name)
    if kernel:
        return kernel
    for key, words in (("cublas", ("gemm", "gemv", "cutlass", "nvjet")),
                       ("copy", ("copy",)), ("reduce", ("reduce_kernel",)),
                       ("elementwise", ("elementwise",))):
        if any(w in name for w in words):
            return key
    return "other"


def _trace_breakdown(path):
    """Device time of a train step's Chrome trace by where each kernel was
    launched.  A launch whose runtime call lies inside a ``grad.*.backward``
    range (the ``autograd.Function`` backwards open one around their GEMMs)
    is a backward GEMM of the port's kernels; the autograd engine's thread
    (the one holding those ranges) also runs the remat recompute and every
    other backward op; ``optim.update`` marks the optimizer; the rest is the
    forward.  Returns ({"<kernel>/<forward|backward>": [ms, launches]},
    {"<phase>/<category>": [ms, launches]}), or None without backward
    ranges in the trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = {"backward": {}, "optimizer": {}}
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        name = e["name"]
        side = ("backward" if name.startswith("grad.")
                and name.endswith(".backward") else
                "optimizer" if name == "optim.update" else None)
        if side:
            ranges[side].setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    if not ranges["backward"]:
        return None
    launch = {}  # correlation -> (in a backward range, phase)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        key = (e["pid"], e["tid"])
        inside = {side: any(a <= e["ts"] <= b for a, b in by.get(key, ()))
                  for side, by in ranges.items()}
        phase = ("optimizer" if inside["optimizer"] else
                 "backward" if key in ranges["backward"] else "forward")
        launch[e.get("args", {}).get("correlation")] = (inside["backward"],
                                                        phase)
    kernels, phases = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        in_bwd, phase = launch.get(e.get("args", {}).get("correlation"),
                                   (False, "forward"))
        kernel = _kernel_of(e["name"])
        rows = [phases.setdefault(f"{phase}/{_category(e['name'])}",
                                  [0.0, 0])]
        if kernel:
            rows.append(kernels.setdefault(
                f"{kernel}/{'backward' if in_bwd else 'forward'}", [0.0, 0]))
        for row in rows:
            row[0] += e["dur"] / 1e3
            row[1] += 1
    return kernels, phases


def phase_train_profile(tag, cfg, run, params, opt_state):
    """Outside the counted run: one more train step timed on the host
    clock to a synchronize, then one under ``torch.profiler``: device busy
    time, idle share of the step's wall time, B1, B3 and B4 time split
    into forward (forward and remat recompute) and backward launches, and
    device time by phase (forward, backward, optimizer) and kind of kernel
    (``_trace_breakdown``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(cfg, run.opt_cfg)
    device = torch.device("cuda")
    batch = train_mod._batch(run, run.steps, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, m = step(params, opt_state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"{tag} profile: non-finite loss")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
    path = os.path.join(OUT, f"profile_{tag}.json")
    prof.export_chrome_trace(path)
    busy, events, by_name = _device_time(path)
    if not by_name:
        print(f"[{tag}-profile] device time not measured (the profiler saw "
              f"no device events); step wall {wall:.1f} ms", flush=True)
        return dict(wall_ms=wall, device_busy_ms=None)
    split = _trace_breakdown(path)
    if split is None:
        raise AssertionError(f"{tag} profile: no grad.*.backward range in "
                             f"the trace")
    kernels, phases = split
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = dict(wall_ms=wall, device_busy_ms=busy, device_events=events,
               idle_share=1 - busy / wall,
               kernels={k: {"ms": v[0], "launches": v[1]}
                        for k, v in sorted(kernels.items())},
               phases={k: {"ms": v[0], "launches": v[1]}
                       for k, v in sorted(phases.items())},
               top=[(k[:60], v[0], v[1]) for k, v in top])
    kern = "; ".join(
        f"{k} {v[0]:.3f} ms over {v[1]} launches ({100 * v[0] / busy:.1f} % "
        f"of device busy)" for k, v in sorted(kernels.items()))
    print(f"[{tag}-profile] one step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms over {events} device events, idle "
          f"{100 * row['idle_share']:.1f} % of the wall; {kern}", flush=True)
    for phase in ("forward", "backward", "optimizer"):
        parts = sorted(((k.split("/")[1], v) for k, v in phases.items()
                        if k.startswith(phase + "/")), key=lambda kv: -kv[1][0])
        total = sum(v[0] for _, v in parts)
        print(f"[{tag}-profile] {phase}: {total:.3f} ms device ("
              + ", ".join(f"{c} {v[0]:.3f} ms over {v[1]}" for c, v in parts)
              + ")", flush=True)
    for k, (ms, n) in top:
        print(f"[{tag}-profile]   {ms:9.3f} ms {n:6d}x {k[:100]}", flush=True)
    return row


def phase_serve():
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    CONTRACT.launches = 0
    t0 = time.perf_counter()
    stats, trace, engine = serve.main(SERVE_ARGS)
    took = time.perf_counter() - t0
    launches = CONTRACT.launches
    cfg = engine.cfg
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    forwards = stats["prefills"] + stats["decode_steps"]
    want = 7 * cfg.n_layers * forwards
    if launches != want:
        raise AssertionError(f"contract kernel launched {launches} times, "
                             f"expected 7 x {cfg.n_layers} x ("
                             f"{stats['prefills']} prefills + "
                             f"{stats['decode_steps']} decode steps) = "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated()
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[serve] {cfg.arch_id} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.vocab} {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}: {json.dumps(summary)}",
          flush=True)
    print(f"[serve] prompts {[len(r.prompt) for r in trace]}, max_new "
          f"{[r.max_new for r in trace]}, kernel launches {launches} = 7 x "
          f"{cfg.n_layers} x ({stats['prefills']} prefills + "
          f"{stats['decode_steps']} decode steps), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB, wall {took:.1f} s",
          flush=True)
    return launches, stats, peak, trace, engine


def _forward_gemms(cfg):
    """(K, N) of every ``ops.dense`` a forward (prefill or decode step)
    runs, from the segment plan: q, k, v, o and the MLP's gate, up, down
    in a dense layer (``dense_ff`` in an MoE config); q, k, v, o and the
    shared expert's three in an MoE layer.  On the card each launches the
    contraction kernel once, at any shape."""
    from repro_torch.models.transformer import segment_plan

    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = [(d, hq), (d, hkv), (d, hkv), (hq, d)]
    m = cfg.moe
    mlp = lambda f: [(d, f), (d, f), (f, d)] if f else []  # noqa: E731
    per_kind = {
        "dense": attn + mlp(m.dense_ff if m is not None and m.dense_ff
                            else cfg.d_ff),
        "moe": attn + mlp(m.shared_expert_ff if m is not None else 0),
    }
    return [g for pattern, count in segment_plan(cfg)
            for kind in pattern for g in per_kind[kind] * count]


def phase_moe_serve():
    """kimi-k2 at full width, cut to 2 layers, through ``serve.run``."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    n_moe = _moe_layers(cfg)
    args = serve.parse_args(MOE_SERVE_ARGS)
    print(f"[moe-serve] reduced: n_layers {full.n_layers} -> {cfg.n_layers} "
          f"(first_dense {cfg.moe.first_dense} + {n_moe} MoE layer); every "
          f"width as published", flush=True)
    torch.cuda.reset_peak_memory_stats()
    CONTRACT.launches = 0
    GROUPED.launches = 0
    t0 = time.perf_counter()
    stats, trace, engine = serve.run(cfg, args)
    took = time.perf_counter() - t0
    launches = {"contract": CONTRACT.launches, "grouped": GROUPED.launches}
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    forwards = stats["prefills"] + stats["decode_steps"]
    gemms = len(_forward_gemms(cfg))
    want = {"grouped": 3 * n_moe * forwards, "contract": gemms * forwards}
    if launches != want:
        raise AssertionError(f"MoE serve: kernel launches {launches}, "
                             f"expected {want} (3 x {n_moe} MoE layer x "
                             f"{forwards} forwards; {gemms} GEMMs x "
                             f"{forwards} forwards)")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"MoE serve: peak memory {peak} B is not under "
                             f"the card's {total} B")
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[moe-serve] {cfg.arch_id} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} experts {cfg.moe.n_experts} top-{cfg.moe.top_k} "
          f"expert_ff {cfg.moe.expert_ff} vocab {cfg.vocab} {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}: {json.dumps(summary)}",
          flush=True)
    print(f"[moe-serve] prefill {stats['prefill_s'] * 1e3:.1f} ms over "
          f"{stats['prefills']} prefills, decode {stats['tok_per_s']:.3f} "
          f"tok/s over {stats['decode_steps']} steps, p50 "
          f"{stats['p50_s'] * 1e3:.1f} ms, p99 {stats['p99_s'] * 1e3:.1f} ms",
          flush=True)
    print(f"[moe-serve] greedy tokens {[list(r.out_tokens) for r in trace]}",
          flush=True)
    print(f"[moe-serve] prompts {[len(r.prompt) for r in trace]}, kernel "
          f"launches {launches} = grouped 3 x {n_moe} x {forwards} forwards, "
          f"contract {gemms} x {forwards} forwards; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f}, wall {took:.1f} s", flush=True)
    return launches, stats, peak, trace, engine


def _device_events(path):
    """[(start us, duration us, name)] of a Chrome trace's device events
    (kernels, copies, memsets), in order of start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in (
                      "kernel", "gpu_memcpy", "gpu_memset"))


def _device_time(path, marker=False):
    """(busy ms, device events, {name: [ms, count]}) over the device
    events of a Chrome trace; busy time is the union of their intervals.
    ``marker``: the session opened with the marker, whose leading
    records are left out (``_after_marker``)."""
    records = _device_events(path)
    if marker:
        records = records[len(records) - len(_after_marker(
            [name for _, _, name in records])):]
    spans, by_name = [], {}
    for ts, dur, name in records:
        spans.append((ts, ts + dur))
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += dur / 1e3
        row[1] += 1
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3, len(spans), by_name


def phase_profile(engine, first, tag=""):
    """Outside the counted run: request 0's prefill again (its logits must
    be finite and give the engine's first token) and one batch-1 decode
    step after it, each timed on the host clock to a synchronize, then
    once more under ``torch.profiler`` for device busy time and device
    time by kernel (the breakdown ``PERF.md`` reads).  ``tag`` prefixes
    the trace files and the printed lines."""
    import torch

    cfg = engine.cfg
    plen = len(first.prompt)
    padded = -(-plen // engine.page_size) * engine.page_size
    toks = torch.zeros((1, padded), dtype=torch.long)
    toks[0, :plen] = torch.as_tensor(first.prompt, dtype=torch.long)
    dev = engine.device
    batch = {"tokens": toks.to(dev),
             "lengths": torch.tensor([plen], device=dev)}
    nxt = torch.tensor([[first.out_tokens[0]]], device=dev)
    steps = {
        "prefill": lambda: engine.api.prefill(engine.params, cfg, batch,
                                              padded + engine.page_size),
        "decode": lambda: engine.api.decode_step(engine.params, cfg,
                                                 caches, nxt),
    }
    out = {}
    with torch.inference_mode():
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, new_caches = step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits from the served "
                                     f"model's {name}")
            if name == "prefill":
                if int(torch.argmax(logits[0, -1])) != first.out_tokens[0]:
                    raise AssertionError("re-run prefill disagrees with the "
                                         "engine's first token")
                caches = new_caches  # the decode step reads these
            # the step's numbers come from a whole trace (_judge_take): its
            # B1 records as many as B1's counter, after a marker record;
            # the decode step of the dense model also fills no int (B1's
            # split counters are zeroed once, by the pool)
            other_ok = ((lambda k: "FillFunctor<int>" not in k)
                        if name == "decode" and not tag else (lambda k: True))
            path, counted, take = _whole_take(
                step, f"{tag}{name}", f"{tag}profile {name}", other_ok)
            busy, events, by_name = _device_time(path, marker=True)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            row = dict(wall_ms=wall, device_busy_ms=busy, device_events=events,
                       top=[(k[:60], v[0], v[1]) for k, v in top], takes=take)
            for kernel in KERNELS:
                hits = [v for k, v in by_name.items() if f"{kernel}_" in k]
                row[f"{kernel}_ms"] = sum(v[0] for v in hits)
                row[f"{kernel}_launches"] = sum(v[1] for v in hits)
            # B1's split counters used to be zeroed (an int fill) before
            # every split GEMM; the pool zeroes them once
            row["int_fills"] = sum(v[1] for k, v in by_name.items()
                                   if "FillFunctor<int>" in k)
            row["fills"] = sum(v[1] for k, v in by_name.items()
                               if "FillFunctor" in k or k.startswith("Memset"))
            row["copies"] = sum(v[1] for k, v in by_name.items()
                                if _category(k) == "copy")
            row["contract_counted"] = counted
            if name == "decode" and not tag and counted != 7 * cfg.n_layers:
                raise AssertionError(
                    f"profiled decode step: {counted} contract launches by "
                    f"its counter (expected 7 x {cfg.n_layers})")
            out[name] = row
            busy_txt = (f"device busy {busy:.3f} ms over {events} device "
                        f"events under the profiler (a whole trace, take "
                        f"{take})")
            what = (f"{padded} tokens" if name == "prefill"
                    else f"1 token after {plen}")
            kernels = "; ".join(
                f"{kernel} kernel {row[f'{kernel}_ms']:.3f} ms over "
                f"{row[f'{kernel}_launches']} launches ("
                f"{100 * row[f'{kernel}_ms'] / max(busy, 1e-9):.1f} % of "
                f"device busy)" for kernel in KERNELS
            )
            print(f"[{tag}profile] {name} ({what}, batch 1): wall "
                  f"{wall:.3f} ms, {busy_txt}; {kernels}; {row['fills']} "
                  f"fills ({row['int_fills']} of ints), {row['copies']} "
                  f"copies", flush=True)
            for k, (ms, n) in top:
                print(f"[{tag}profile]   {ms:9.3f} ms {n:6d}x {k[:100]}",
                      flush=True)
    return out


# --------------------------------------------------------------------------
# slice 5: B1's int8 / fp8 modes, the upcast body and the chain
# --------------------------------------------------------------------------

#: launchers of the slice's kernels, by kernels-line name
NEW_KERNELS = ("contract_int8", "contract_fp8", "contract_upcast",
               "contract_chain")
#: qwen3-8b's MLP products at the train path's M = 4 x 512 tokens: up
#: (D = 4096 -> F = 12288) and down (12288 -> 4096)
QUANT_SHAPES = ((FUSED_M, FUSED_D, FUSED_F), (FUSED_M, FUSED_F, FUSED_D))
#: a ragged ``ops.dense(quant=)`` call: no extent a multiple of 128 (or 16)
QUANT_RAGGED = (1000, 999, 1001)
#: one qwen3-8b head's (QK^T)V without softmax over a 4096-token context
CHAIN_SHAPE = (4096, 128, 4096, 128)


def _new_launchers():
    from repro_torch.codegen import modes

    return {"contract_int8": modes.CONTRACT_INT8,
            "contract_fp8": modes.CONTRACT_FP8,
            "contract_upcast": modes.CONTRACT_UPCAST,
            "contract_chain": modes.CONTRACT_CHAIN}


def _zero_new_counts():
    from repro_torch.codegen import CONTRACT

    CONTRACT.launches = 0
    for launcher in _new_launchers().values():
        launcher.launches = 0


def _new_counts():
    from repro_torch.codegen import CONTRACT

    return {"contract": CONTRACT.launches,
            **{k: v.launches for k, v in _new_launchers().items()}}


def _q_operand(shape, fmt, gen):
    """Seeded 8-bit operands on the card: ints in [-127, 127], or normals
    rounded to e4m3."""
    import torch

    if fmt == "int8":
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)
    return (torch.randn(shape, generator=gen, device="cuda") * 4).to(
        torch.float8_e4m3fn)


def _check_exact(got, want, what):
    """int8's hold: the int32 outputs equal, element for element."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
        torch.equal(got, want)
    ):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: int32 output differs from its plain "
                             f"version in {bad} elements")
    return 0.0, 0.0


def _quant_row(tag, what, fmt, got, want, run, plain, library, ops, nbytes,
               flush, kernel, body, **extra):
    """One b1-quant row: int8 exact, fp8 at the f32 TOL (scaled); timed as
    ``_case_row`` against the 1979 TOP/s 8-bit tensor-core rate, with the
    device ms of ``kernel`` (``_kernel_ms``) and the ``body`` that ran."""
    if fmt == "int8":
        max_abs, scaled_err = _check_exact(got, want, f"{tag} {what}")
    else:
        max_abs, scaled_err = _check_close(got, want, "float32",
                                           f"{tag} {what}")
    ms = _timed(run, flush)
    device_ms, others, other_ms = _kernel_ms(run, flush, kernel)
    plain_ms = _timed(plain, flush, **PLAIN_REPS)
    library_ms = None
    if library is not None:
        try:
            library_ms = _timed(library, flush)
        except RuntimeError as e:  # the library call refuses this layout
            print(f"[{tag}] {what}: library call refused ({str(e)[:120]}); "
                  f"library_ms null", flush=True)
    bound_ms, ops_ms, bytes_ms, by = _bound(ops, nbytes, fmt)
    row = dict(case=what, dtype=fmt, body=body, kernel=kernel,
               max_abs_err=max_abs, scaled_err=scaled_err, ms=ms,
               device_ms=device_ms, other_device_ms=other_ms,
               other_kernels=others, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, ops_ms=ops_ms,
               bytes_ms=bytes_ms, bound_by=by, tops=ops / ms / 1e9, **extra)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
    held = "exact" if fmt == "int8" else f"scaled err {scaled_err:.3g}"
    other = (f", other device work {other_ms:.4f} in {len(others)} "
             f"kernels" if others else "")
    print(f"[{tag}] {what} {fmt} ({kernel}, {body}): {held}, {ms:.4f} ms, "
          f"device {device_ms:.4f}{other} (plain {plain_ms:.4f}, library "
          f"{lib}, bound {bound_ms:.4f} by {by}), {row['tops']:.1f} TOP/s",
          flush=True)
    return row


def _int_mm(a, bt):
    import torch

    return torch._int_mm(a, bt.t())


def _scaled_mm(a, bt, one):
    import torch

    return torch._scaled_mm(a, bt.t(), scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


def phase_b1_quant():
    """B1's 8-bit modes against ``contract_ref``, no epilogue: int8 (int32
    out, exact) and fp8 (f32 out, f32 TOL scaled) at qwen3-8b's MLP shapes
    (up M = 2048, D = 4096, F = 12288; down 2048, 12288, 4096) with W
    k-major as ``ops.dense(quant=)`` writes it, a ragged product (1000 x
    999 x 1001, W n-major), a batched fold (8 x 512 x 1024 x 512) and a
    transposed one (A stored (K, M)).  Library yardsticks (timed, used
    nowhere in the port): ``torch._int_mm`` and ``torch._scaled_mm`` (scales
    1) where they take the shape, else null.  Then, through
    ``codegen.compile``, one pass counted from 0: the int8 and fp8
    ``weighted_matmul`` and its derived ``.dA``, ``.dB``, ``.dg`` at M =
    2048, D = 4096, F = 12288 on the rings (``FAMILY_ROUTES``: int8 on
    the 8-bit ring, fp8's forward on the bf16 k-scale ring and the rest on
    the 8-bit ring; one launch each, none on the upcast body) and the
    quantized chain at CHAIN_SHAPE; then a second pass counted from 0 of
    the upcast body's remaining calls (``_upcast_cases``); each against its
    plain version, its device ms beside the other device work of the call
    (the int8 forward's byte planes and K-major copies); no one library
    call computes them."""
    import torch

    from repro_torch import codegen
    from repro_torch.codegen import contract_ref
    from repro_torch.core import enumerate as E
    from repro_torch.grad import derived_specs

    gen = torch.Generator(device="cuda").manual_seed(50)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    one = torch.ones((), device="cuda")
    rows = []
    launchers = _new_launchers()
    for fmt in ("int8", "fp8"):
        launcher = launchers[f"contract_{fmt}"]
        int_acc = fmt == "int8"
        out_dt = torch.int32 if int_acc else torch.float32
        lib_fn = _int_mm if int_acc else (
            lambda a, bt: _scaled_mm(a, bt, one))
        for m, k, n, kmajor, tag in (
            *((m, k, n, True, f"mlp {'up' if n > k else 'down'}")
              for m, k, n in QUANT_SHAPES),
            (1000, 999, 1001, False, "ragged"),
        ):
            a = _q_operand((m, k), fmt, gen)
            bt = _q_operand((n, k), fmt, gen)
            b = bt.t() if kmajor else bt.t().contiguous()
            spec = E.quantize_spec(E.matmul_spec(m, k, n), fmt=fmt)
            got = launcher(a[None], b[None], out_dt, int_acc=int_acc)[0]
            body = launcher.last_body
            want = contract_ref(spec, a, b, out_dtype=out_dt)
            lib = ((lambda: lib_fn(a, bt)) if kmajor else None)  # noqa: E731
            rows.append(_quant_row(
                "b1-quant", f"{tag} M={m} K={k} N={n}", fmt, got, want,
                lambda: launcher(a[None], b[None], out_dt, int_acc=int_acc),
                lambda: contract_ref(spec, a, b, out_dtype=out_dt), lib,
                2.0 * m * k * n, m * k + k * n + 4 * m * n, flush,
                f"contract_{fmt}", body, shape=tag))
            del a, bt, b, got, want
        # the batched and transposed folds through codegen.compile
        for spec in (E.batched_matmul_spec(8, 512, 1024, 512),
                     E.transposed_matmul_spec(1024, 2048, 1024)):
            spec = E.quantize_spec(spec, fmt=fmt)
            args = [_q_operand([spec.extents[i] for i in ax], fmt, gen)
                    for ax in spec.operands.values()]
            kern = codegen.compile(spec, codegen.default_schedule(spec))
            got = kern(*args)
            body = launcher.last_body
            want = contract_ref(spec, *args, out_dtype=out_dt)
            ext = spec.extents
            size = math.prod(ext.values())
            outs = math.prod(ext[i] for i in spec.output)
            rows.append(_quant_row(
                "b1-quant", f"{spec.name} {dict(ext)}", fmt, got, want,
                lambda: kern(*args),
                lambda: contract_ref(spec, *args, out_dtype=out_dt), None,
                2.0 * size, sum(x.numel() for x in args) + 4 * outs, flush,
                f"contract_{fmt}", body, shape=spec.name))
            del args, got, want
    # the weighted family and the quantized chain through codegen.compile,
    # the public entry: one counted pass (counters from 0), then the checks
    # and the timings
    m, d, f = FUSED_M, FUSED_D, FUSED_F
    cases = []
    for fmt in ("int8", "fp8"):
        base = E.weighted_matmul_spec(m, d, f)
        for spec in [base, *derived_specs(base).values(),
                     E.chain_matmul_spec(*CHAIN_SHAPE)]:
            spec = E.quantize_spec(spec, fmt=fmt)
            args = [_q_operand([spec.extents[i] for i in ax], fmt, gen)
                    for ax in spec.operands.values()]
            cases.append((fmt, spec, args, codegen.compile(
                spec, codegen.default_schedule(spec))))
    ran, counts, outs = _counted_pass(cases, {
        "contract": 1, "contract_int8": 4, "contract_fp8": 3,
        "contract_upcast": 0, "contract_chain": 2}, "compile path")
    compiled = []
    for (fmt, spec, args, kern), got, (kernel, body) in zip(cases, outs,
                                                            ran):
        if spec.name == "chain_matmul":
            r, p, q, c = CHAIN_SHAPE
            ops = 2.0 * min(r * p * q + r * q * c, p * q * c + r * p * c)
        else:
            ops = 2.0 * m * d * f
            if (kernel, body.split(" ")[0]) != FAMILY_ROUTES[fmt][spec.name]:
                raise AssertionError(f"b1-quant {spec.name} {fmt}: ran "
                                     f"{kernel} ({body}), expected "
                                     f"{FAMILY_ROUTES[fmt][spec.name]}")
        mode = "chain" if spec.name == "chain_matmul" else "family"
        compiled.append(_compiled_row(fmt, spec, args, kern, got, ops,
                                      flush, kernel, body, mode))
    del cases, outs
    # the upcast body on its remaining calls, counted from 0 apart
    cases, names = [], []
    for name, spec, dtypes in _upcast_cases(m, d, f):
        args = [_q_operand([spec.extents[i] for i in ax], "int8", gen)
                .to(dt) for ax, dt in zip(spec.operands.values(), dtypes)]
        cases.append(("int8", spec, args, codegen.compile(
            spec, codegen.default_schedule(spec))))
        names.append(name)
    ran, upcast_counts, outs = _counted_pass(cases, {
        "contract": 0, "contract_int8": 0, "contract_fp8": 0,
        "contract_upcast": 2, "contract_chain": 0}, "upcast path")
    direct = [_compiled_row(fmt, spec, args, kern, got, 2.0 * m * d * f,
                            flush, kernel, body, "upcast", name)
              for (fmt, spec, args, kern), got, (kernel, body), name
              in zip(cases, outs, ran, names)]
    del cases, outs, flush
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, compiled=compiled, upcast=direct,
                launches=counts, upcast_launches=upcast_counts)


#: the launcher (``_kernel_of`` name) and body each spec of the 8-bit
#: weighted family runs at the fused path's shape
#: (``cuda_gen.eight_bit_route``)
FAMILY_ROUTES = {
    "int8": {"weighted_matmul": ("contract_int8", "ring"),
             "weighted_matmul.dA": ("contract_int8", "ring"),
             "weighted_matmul.dB": ("contract_int8", "ring"),
             "weighted_matmul.dg": ("contract_int8", "ring")},
    "fp8": {"weighted_matmul": ("contract", "ring"),
            "weighted_matmul.dA": ("contract_fp8", "ring"),
            "weighted_matmul.dB": ("contract_fp8", "ring"),
            "weighted_matmul.dg": ("contract_fp8", "ring")},
}


def _upcast_cases(m, d, f):
    """The upcast body's remaining calls at the fused path's shape, as
    (row name, int8 spec, operand dtypes): a one-sided reduce (A (i, j, r)
    summed over r in int32 first, so the product takes an int32 and an
    int8 operand) and the weighted forward with an int32 g."""
    import torch

    from repro_torch.core import enumerate as E

    one = E.ContractionSpec(name="one_side_reduce",
                            operands={"A": ("i", "j", "r"), "B": ("j", "k")},
                            output=("i", "k"),
                            extents={"i": m, "j": d, "r": 4, "k": f})
    i8 = torch.int8
    return [("one_side_reduce", E.quantize_spec(one, fmt="int8"), (i8, i8)),
            ("weighted_matmul, int32 g",
             E.quantize_spec(E.weighted_matmul_spec(m, d, f), fmt="int8"),
             (i8, i8, torch.int32))]


def _counted_pass(cases, want, what):
    """Run each ``(fmt, spec, args, kern)`` once with the launch counts
    from 0; raise unless they end at ``want`` with one launch a call.
    Returns ([(the launcher's kernel name, its body with the tile)] a
    call, the counts, the outputs)."""
    import torch

    from repro_torch.codegen import CONTRACT

    launchers = dict(_new_launchers(), contract=CONTRACT)
    torch.cuda.synchronize()
    _zero_new_counts()
    ran, outs = [], []
    for fmt, spec, args, kern in cases:
        before = _new_counts()
        outs.append(kern(*args))
        after = _new_counts()
        moved = [k for k in after if after[k] != before[k]]
        if len(moved) != 1 or after[moved[0]] != before[moved[0]] + 1:
            raise AssertionError(f"b1-quant {what}: {spec.name} {fmt} "
                                 f"launched {moved}")
        launcher = launchers[moved[0]]
        ran.append((moved[0], _body(launcher)
                    if hasattr(launcher, "last_body") else "chain"))
        print(f"[b1-quant] {what}: {spec.name} {fmt} -> {moved[0]} "
              f"({ran[-1][1]})", flush=True)
    torch.cuda.synchronize()
    counts = _new_counts()
    if counts != want:
        raise AssertionError(f"b1-quant {what} launched {counts}, expected "
                             f"{want}")
    return ran, counts, outs


def _compiled_row(fmt, spec, args, kern, got, ops, flush, kernel, body,
                  mode, name=None):
    """A b1-quant row of a ``codegen.compile`` call against
    ``contract_ref``, named ``name`` (default: the spec's) and its
    extents."""
    from repro_torch.codegen import contract_ref
    from repro_torch.codegen.cuda_gen import _default_out_dtype

    out_dt = _default_out_dtype(spec, None, args[0].dtype)
    want = contract_ref(spec, *args, out_dtype=out_dt)
    n_out = math.prod(spec.extents[i] for i in spec.output)
    return _quant_row(
        "b1-quant", f"{name or spec.name} {dict(spec.extents)}", fmt, got,
        want,
        lambda: kern(*args),
        lambda: contract_ref(spec, *args, out_dtype=out_dt), None, ops,
        sum(x.numel() * x.element_size() for x in args) + 4 * n_out, flush,
        kernel, body, shape=spec.name, mode=mode)


def _library_gemms(path):
    """Device kernels of a trace that are library GEMMs (cuBLAS, CUTLASS)."""
    _, _, by_name = _device_time(path)
    return sorted(k for k in by_name if _category(k) == "cublas")


def _profile(run, name):
    """``run()`` once under ``torch.profiler``; (trace path, busy ms,
    events, {kernel name: [ms, count]})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(OUT, f"profile_{name}.json")
    prof.export_chrome_trace(path)
    busy, events, by_name = _device_time(path)
    return path, busy, events, by_name


def phase_quant_path():
    """``ops.dense(x, w, quant=fmt)`` through the public entry at qwen3-8b's
    two MLP shapes (bf16 x and w, seeded, M = 2048) and at the ragged
    QUANT_RAGGED, int8 and fp8, f32 out:
    one 8-bit kernel launch per call and no other (counters from 0), the
    output against the plain path of the same call (the same quantization,
    then ``contract_ref`` of the quantized spec with its dequant epilogue)
    at the f32 TOL scaled, and the end-to-end error against the
    unquantized product under the reference's limits (0.05 int8, 0.1 fp8).
    Then the six calls under ``torch.profiler``: no library GEMM, device
    time split into the quantize passes (plain PyTorch ops, as the
    reference's ``jnp`` ops) and the kernel."""
    import torch

    from repro_torch import codegen, ops
    from repro_torch.codegen import contract_ref
    from repro_torch.core import enumerate as E
    from repro_torch.optim.quant import quantize_channels, quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(51)
    inputs = []
    for m, d, f in (*QUANT_SHAPES, QUANT_RAGGED):
        x = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, f, generator=gen, device="cuda")
             / math.sqrt(d)).bfloat16()
        inputs.append((x, w))
    calls = [(fmt, x, w) for fmt in ("int8", "fp8") for x, w in inputs]
    torch.cuda.synchronize()
    _zero_new_counts()
    per_call = []
    outs = []
    for fmt, x, w in calls:
        before = _new_counts()
        outs.append(ops.dense(x, w, quant=fmt, out_dtype=torch.float32))
        after = _new_counts()
        per_call.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    torch.cuda.synchronize()
    counts = _new_counts()
    for (fmt, _, _), have in zip(calls, per_call):
        if have != {f"contract_{fmt}": 1}:
            raise AssertionError(f"quant path: ops.dense(quant={fmt!r}) "
                                 f"launched {have}, expected one "
                                 f"contract_{fmt}")
    rows = []
    for (fmt, x, w), got in zip(calls, outs):
        m, d = x.shape
        f = w.shape[1]
        qx, sx = quantize_tensor(x, fmt)
        qw, sw = quantize_channels(w, fmt)
        spec = E.quantized_matmul_spec(m, d, f, fmt)
        want = contract_ref(spec, qx, qw, out_dtype=torch.float32,
                            epilogue=codegen.Epilogue(dequant=True),
                            vectors={"qscale": (sx * sw).float()})
        max_abs, scaled = _check_close(got, want, "float32",
                                       f"quant path {fmt} M={m} D={d} F={f}")
        full = torch.matmul(x.float(), w.float())
        e2e = ((got - full).abs().max() / full.abs().max().clamp_min(1.0)
               ).item()
        limit = 0.05 if fmt == "int8" else 0.1
        if not e2e < limit:
            raise AssertionError(f"quant path {fmt}: end-to-end error "
                                 f"{e2e} against the bf16 product, limit "
                                 f"{limit}")
        rows.append(dict(fmt=fmt, M=m, D=d, F=f, max_abs_err=max_abs,
                         scaled_err=scaled, e2e_rel_err=e2e))
        del qx, qw, want, full
    del outs

    def run_all():
        for fmt, x, w in calls:
            ops.dense(x, w, quant=fmt, out_dtype=torch.float32)

    run_all()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_all()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    path, busy, events, by_name = _profile(run_all, "quant_path")
    library = _library_gemms(path)
    if library:
        raise AssertionError(f"quant path: library GEMMs on the path: "
                             f"{library}")
    kern_ms = sum(v[0] for k, v in by_name.items() if _kernel_of(k))
    split = dict(device_busy_ms=busy, kernel_ms=kern_ms,
                 quantize_ms=sum(v[0] for k, v in by_name.items()
                                 if not _kernel_of(k)),
                 kernels={k[:80]: v for k, v in by_name.items()
                          if _kernel_of(k)})
    for r in rows:
        print(f"[quant-path] ops.dense(quant={r['fmt']!r}) M={r['M']} "
              f"D={r['D']} F={r['F']}: kernel vs plain scaled err "
              f"{r['scaled_err']:.3g}, end-to-end {r['e2e_rel_err']:.4g} of "
              f"max |x @ w|", flush=True)
    measured = (f"device busy {busy:.3f} ms over {events} events: 8-bit "
                f"kernels {kern_ms:.3f} ms, quantize passes and the rest "
                f"{split['quantize_ms']:.3f} ms" if by_name else
                "device time not measured (the profiler saw no device events)")
    print(f"[quant-path] {len(calls)} calls: launches {counts} (1 per "
          f"call); wall "
          f"{wall:.1f} ms; no library GEMM; {measured}", flush=True)
    del calls, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=counts, per_call=per_call, wall_ms=wall,
                **split)


def _chain_library(spec, arrays):
    """One PyTorch call for the same function: ``torch.linalg.multi_dot``
    over the three matrices in chain order."""
    import torch

    from repro_torch.codegen.cuda_gen import _classify

    fold = _classify(spec)
    ops_ = spec.operands
    r, c = spec.output
    (p,) = [i for i in ops_[fold.a] if i != r]
    (q,) = [i for i in ops_[fold.extra] if i != c]
    mat = lambda name, rows: (arrays[name] if ops_[name][0] == rows  # noqa
                              else arrays[name].t())
    mats = [mat(fold.a, r), mat(fold.b, p), mat(fold.extra, q)]
    return lambda: torch.linalg.multi_dot(mats)


def phase_chain():
    """``ops.chain_dense`` forward and ``backward()`` at CHAIN_SHAPE, f32
    and bf16, through the public entry: 1 + 3 chain launches (counters from
    0), the output and the three cotangents against the plain versions
    (``contract_ref`` of ``chain_matmul`` and its derived specs on the same
    inputs) at the f32 / bf16 TOL; each spec timed (kernel, plain, the
    library call ``torch.linalg.multi_dot``) against its bound (operations
    of the cheaper association without recomputation); then forward and
    backward under ``torch.profiler``: no library GEMM."""
    import torch

    from repro_torch import codegen, ops
    from repro_torch.codegen import contract_ref
    from repro_torch.core import enumerate as E
    from repro_torch.grad import COTANGENT, derived_specs

    r, p, q, c = CHAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(52)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows, paths = [], {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        a, b, cm = ((torch.randn(s, generator=gen, device="cuda")
                     / math.sqrt(s[0])).to(dt)
                    for s in ((r, p), (p, q), (q, c)))
        dout = torch.randn(r, c, generator=gen, device="cuda").to(dt)
        leaves = [t.clone().requires_grad_(True) for t in (a, b, cm)]
        torch.cuda.synchronize()
        _zero_new_counts()
        out = ops.chain_dense(*leaves)
        fwd_launches = _new_counts()["contract_chain"]
        out.backward(dout)
        torch.cuda.synchronize()
        counts = _new_counts()
        if fwd_launches != 1 or counts != {
            "contract": 0, "contract_int8": 0, "contract_fp8": 0,
            "contract_upcast": 0, "contract_chain": 4,
        }:
            raise AssertionError(f"chain {dt_name}: launches {counts} "
                                 f"(forward {fwd_launches}), expected 1 + 3 "
                                 f"chain launches")
        spec = E.chain_matmul_spec(r, p, q, c)
        named = {"A": a, "B": b, "C": cm}
        cases = [(spec, named, out.detach())]
        for wrt, dspec in derived_specs(spec).items():
            arrays = {COTANGENT: dout, **{k: v for k, v in named.items()
                                          if k != wrt}}
            cases.append((dspec, arrays, leaves["ABC".index(wrt)].grad))
        for sp, arrays, got in cases:
            args = [arrays[n] for n in sp.operands]
            want = contract_ref(sp, *args, out_dtype=dt)
            kern = codegen.compile(sp, codegen.default_schedule(sp))
            # the cluster sums T in rank order, no atomics: equal bits
            first, second = kern(*args), kern(*args)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise AssertionError(f"chain {sp.name} {dt_name}: two "
                                     f"launches on the same inputs differ")
            del first, second
            ext = sp.extents
            fold = kern.fold
            rr, cc = sp.output
            (pp,) = [i for i in sp.operands[fold.a] if i != rr]
            (qq,) = [i for i in sp.operands[fold.extra] if i != cc]
            R, P, Q, C = ext[rr], ext[pp], ext[qq], ext[cc]
            ops_min = 2.0 * min(R * P * Q + R * Q * C, P * Q * C + R * P * C)
            nbytes = (sum(x.numel() for x in args) + R * C) * dt.itemsize
            rows.append(_case_row(
                "chain", f"{sp.name} (R, P, Q, C)={(R, P, Q, C)}", got, want,
                dt_name, lambda: kern(*args),
                lambda: contract_ref(sp, *args, out_dtype=dt),
                _chain_library(sp, arrays), ops_min, nbytes, flush,
                spec=sp.name, launches=1, bit_equal=True))
            del want

        def run_path():
            ls = [t.detach().clone().requires_grad_(True)
                  for t in (a, b, cm)]
            ops.chain_dense(*ls).backward(dout)

        path, busy, events, by_name = _profile(run_path, f"chain_{dt_name}")
        library = _library_gemms(path)
        if library:
            raise AssertionError(f"chain {dt_name}: library GEMMs on the "
                                 f"path: {library}")
        chain_ms = sum(v[0] for k, v in by_name.items()
                       if _kernel_of(k) == "contract_chain")
        paths[dt_name] = dict(launches=counts, device_busy_ms=busy,
                              chain_kernel_ms=chain_ms, events=events)
        print(f"[chain] ops.chain_dense {dt_name} (R, P, Q, C) = "
              f"{CHAIN_SHAPE}: forward + backward launches {counts}; no "
              f"library GEMM; device busy {busy:.3f} ms, chain kernel "
              f"{chain_ms:.3f} ms", flush=True)
        del a, b, cm, dout, leaves, out, cases
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, paths=paths)


def phase_quant_small():
    """Card vs CPU at small sizes: the 2-layer f32 model served with
    ``quant="int8"`` (greedy tokens equal; prefill logits of the expanded
    tree within 1e-4 scaled), the operand quantization of f32 and bf16
    tensors (the same bits), ``ops.dense(quant=)`` in int8 and fp8 (f32
    out, f32 TOL scaled) and ``ops.chain_dense`` forward and gradients in
    f32 (2e-4) and bf16 (6e-2)."""
    import torch

    from repro_torch import ops
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as T
    from repro_torch.optim.quant import (dequantize_tree, quantize_channels,
                                         quantize_tensor, quantize_tree)

    cfg = _small_dense_config()
    cpu_params = T.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    outs = {}
    for device in ("cpu", "cuda"):
        params = T._tree_map(lambda t: t.to(device), cpu_params)
        trace = synthetic_trace(3, vocab=cfg.vocab, seed=7, rate_hz=0.0,
                                prompt_lens=(60, 128), max_news=(4, 6))
        ContinuousEngine(cfg, lanes=2, page_size=128, n_pages=5, max_ctx=256,
                         params=params, device=device, quant="int8").run(trace)
        outs[device] = [r.out_tokens for r in trace]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"quant small: int8 greedy tokens differ, card "
                             f"{outs['cuda']} vs CPU {outs['cpu']}")
    rng = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (1, 128), generator=rng)
    with torch.inference_mode():
        lc, _ = T.prefill(dequantize_tree(quantize_tree(cpu_params)), cfg,
                          tokens, 128)
        lg, _ = T.prefill(dequantize_tree(quantize_tree(T._tree_map(
            lambda t: t.to("cuda"), cpu_params))), cfg, tokens.cuda(), 128)
    logit_err = ((lg.cpu() - lc).abs().max() / lc.abs().max()).item()
    if not logit_err <= 1e-4:
        raise AssertionError(f"quant small: card and CPU logits of the int8 "
                             f"tree differ by {logit_err} (scaled)")
    gen = torch.Generator().manual_seed(9)
    dense_err = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(256, 384, generator=gen).to(dt)
        w = (torch.randn(384, 512, generator=gen) / 8).to(dt)
        for fmt in ("int8", "fp8"):
            # the quantization itself: the same bits on the card
            for fn in (quantize_tensor, quantize_channels):
                for a, b in zip(fn(x.cuda(), fmt), fn(x, fmt)):
                    if not torch.equal(a.cpu().view(torch.uint8)
                                       if a.element_size() == 1 else a.cpu(),
                                       b.view(torch.uint8)
                                       if b.element_size() == 1 else b):
                        raise AssertionError(f"quant small: {fn.__name__}"
                                             f"({fmt}) differs card vs CPU")
            got = ops.dense(x.cuda(), w.cuda(), quant=fmt,
                            out_dtype=torch.float32)
            want = ops.dense(x, w, quant=fmt, interpret=True,
                             out_dtype=torch.float32)
            dense_err[f"{fmt} {str(dt)[6:]}"] = _check_close(
                got.cpu(), want, "float32", f"quant small dense {fmt}")[1]
    chain_err = {}
    for dt_name, tol in (("float32", (2e-4, 2e-4)),
                         ("bfloat16", (6e-2, 6e-2))):
        dt = getattr(torch, dt_name)
        base = [(torch.randn(s, generator=gen) / 4).to(dt)
                for s in ((96, 40), (40, 130), (130, 24))]
        dout = torch.randn(96, 24, generator=gen).to(dt)
        res = {}
        for device in ("cpu", "cuda"):
            leaves = [t.detach().clone().to(device).requires_grad_(True)
                      for t in base]
            out = ops.chain_dense(*leaves, interpret=device == "cpu")
            out.backward(dout.to(device))
            res[device] = [out.detach().cpu()] + [t.grad.cpu()
                                                  for t in leaves]
        chain_err[dt_name] = max(
            _check_close(g, w_, dt_name, f"quant small chain {dt_name}",
                         tol=tol)[1]
            for g, w_ in zip(res["cuda"], res["cpu"]))
    print(f"[quant-small] int8-served 2-layer f32 model: greedy tokens equal "
          f"{outs['cuda']}, prefill logits scaled diff {logit_err:.3g}; "
          f"dense(quant) card vs CPU {dense_err}; chain_dense (and grads) "
          f"{chain_err}", flush=True)
    return dict(tokens=outs["cuda"], logit_err=logit_err,
                dense_err=dense_err, chain_err=chain_err)


def phase_serve_int8():
    """qwen3-8b at full width and depth served with ``--quant int8`` and
    the serve phase's flags, through ``serve.main``: every request complete
    with tokens in the vocab, B1 launched 7 x 36 x (prefills + decode
    steps) times (the
    projections run on the expanded bf16 weights, as in the reference),
    the ``serve.quant_bytes`` gauge equal to the bytes of the int8 leaves
    counted from their shapes (1 byte per value, 4 per 256-value block);
    then request 0's prefill again from the expanded tree: finite logits
    that give the engine's first token.  Peak memory is read twice: over
    the load (the bf16 tree drawn, then quantized beside it) and over the
    serving that follows it."""
    import torch

    from repro_torch import obs
    from repro_torch.codegen import CONTRACT
    from repro_torch.launch import serve
    from repro_torch.launch.serving import ContinuousEngine
    from repro_torch.optim.quant import BLOCK, Quantized, dequantize_tree

    torch.cuda.reset_peak_memory_stats()
    obs.metrics_reset()
    CONTRACT.launches = 0
    loaded = {}
    engine_run = ContinuousEngine.run

    def run_after_load(self, *args, **kwargs):
        torch.cuda.synchronize()
        loaded.update(peak=torch.cuda.max_memory_allocated(),
                      held=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return engine_run(self, *args, **kwargs)

    ContinuousEngine.run = run_after_load
    t0 = time.perf_counter()
    try:
        stats, trace, engine = serve.main(SERVE_ARGS + ["--quant", "int8"])
    finally:
        ContinuousEngine.run = engine_run
    took = time.perf_counter() - t0
    launches = CONTRACT.launches
    cfg = engine.cfg
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"serve-int8: request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"serve-int8: request {r.rid}: token "
                                 f"outside the vocab")
    want = 7 * cfg.n_layers * (stats["prefills"] + stats["decode_steps"])
    if launches != want:
        raise AssertionError(f"serve-int8: contract kernel launched "
                             f"{launches} times, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, Quantized):
            leaves.append(math.prod(t.shape))

    walk(engine.params)
    expected = sum(n + 4 * -(-n // BLOCK) for n in leaves)
    gauge = obs.metrics_json()["gauges"].get("serve.quant_bytes")
    if gauge != expected:
        raise AssertionError(f"serve-int8: serve.quant_bytes {gauge}, "
                             f"expected {expected} from the leaf shapes")
    first = trace[0]
    plen = len(first.prompt)
    padded = -(-plen // engine.page_size) * engine.page_size
    toks = torch.zeros((1, padded), dtype=torch.long)
    toks[0, :plen] = torch.as_tensor(first.prompt, dtype=torch.long)
    with torch.inference_mode():
        logits, _ = engine.api.prefill(
            dequantize_tree(engine.params), cfg,
            {"tokens": toks.cuda(),
             "lengths": torch.tensor([plen], device="cuda")}, padded)
        finite = bool(torch.isfinite(logits).all())
        tok = int(torch.argmax(logits[0, -1]))
    if not finite or tok != first.out_tokens[0]:
        raise AssertionError(f"serve-int8: prefill logits finite {finite}, "
                             f"token {tok} vs the engine's "
                             f"{first.out_tokens[0]}")
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[serve-int8] {cfg.arch_id} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} {cfg.dtype} --quant int8: {json.dumps(summary)}",
          flush=True)
    print(f"[serve-int8] {len(leaves)} int8 leaves, serve.quant_bytes "
          f"{gauge} = {gauge / 1e9:.3f} GB (expected from the shapes); "
          f"prefill {stats['prefill_s'] * 1e3:.1f} ms over "
          f"{stats['prefills']}, decode {stats['tok_per_s']:.2f} tok/s, p50 "
          f"{stats['p50_s'] * 1e3:.1f} ms; kernel launches {launches} = 7 x "
          f"{cfg.n_layers} x ({stats['prefills']} prefills + "
          f"{stats['decode_steps']} decode steps); max_memory_allocated "
          f"{loaded['peak'] / 2**30:.2f} GiB over the load, "
          f"{loaded['held'] / 2**30:.2f} GiB held after it, "
          f"{peak / 2**30:.2f} GiB over the serving; wall {took:.1f} s",
          flush=True)
    del engine, trace
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stats=summary, launches=launches, quant_bytes=gauge,
                max_memory_allocated=peak, load_peak=loaded["peak"],
                load_held=loaded["held"], wall_s=took)


# --------------------------------------------------------------------------
# slice 15: the variant search, measured tuning, B1 tiles by the search
# --------------------------------------------------------------------------

#: the four distinct projection shapes of a 512-token qwen3-8b prefill, (M,
#: K, N): q and o, k and v, gate and up, down (the launcher folds the
#: prompt to M = 512: the serving run's launches show it)
SEARCH_SHAPES = ((512, 4096, 4096), (512, 4096, 1024), (512, 4096, 12288),
                 (512, 12288, 4096))
#: card plans a ladder measures beside the launcher's heuristic one
SEARCH_TOPK = 4
#: (M, K, N) of the measured tuning check: a 384-token prompt's k and v
#: projections, a shape no ladder of the sweep or the serving run holds
TUNE_SHAPE = (384, 4096, 1024)
#: ladders the serving run sweeps: 4 prefill shapes with their .dA and .dB,
#: and 4 decode shapes at M = lanes
SEARCH_LADDERS = 4 * 3 + 4


def _rank_rho(a, b):
    """Spearman's rho with tied values at their average rank (a model
    that gives two plans one score ranks neither above the other)."""
    import numpy as np

    def ranks(x):
        x = np.asarray(x, dtype=float)
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x))
        r[order] = np.arange(len(x), dtype=float)
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r - r.mean()

    ra, rb = ranks(a), ranks(b)
    denom = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))
    return float((ra * rb).sum() / denom) if denom else float("nan")


def _ladder_line(label, spec, res, dev):
    """One ``[search]`` line of a card ladder."""
    spearman = _rank_rho
    s = res.stats
    rungs = res.ranked
    rho = spearman([p.score for p in rungs], [p.measured_s for p in rungs])
    base, best = res.baseline(), res.best
    ext = "x".join(str(spec.extents[i]) for i in spec.indices)
    plans = " ".join(f"{p.card.tile_n}x{p.card.splits}="
                     f"{p.measured_s * 1e3:.4f}ms/{p.score * 1e3:.4f}ms"
                     for p in rungs)
    gain = base.measured_s / best.measured_s
    retimed = ("" if dev["retimed"] is None else
               "; re-timed winner %.4f ms, heuristic %.4f ms, spread %.4f ms"
               % dev["retimed"])
    print(f"[search] {spec.name} {ext} [{label}] {best.card.body}: "
          f"considered {s.considered}, cut by the bound {s.pruned_bound}, "
          f"by the beam {s.pruned_beam}, measured {s.measured}; winner "
          f"{best.card.tile_n}x{best.card.splits} {best.measured_s * 1e3:.4f}"
          f" ms, device {dev['winner']:.4f} ms; heuristic "
          f"{base.card.tile_n}x{base.card.splits} "
          f"{base.measured_s * 1e3:.4f} ms, device {dev['heuristic']:.4f} ms"
          f" ({gain:.3f}x){retimed}; plan=measured/predicted {plans}; "
          f"Spearman {rho:.2f}", flush=True)
    return dict(spec=spec.name, extents=ext, label=label,
                body=best.card.body, stats=s.as_dict(),
                winner=tuple(best.card), winner_ms=best.measured_s * 1e3,
                winner_device_ms=dev["winner"], heuristic=tuple(base.card),
                heuristic_ms=base.measured_s * 1e3,
                heuristic_device_ms=dev["heuristic"], rho=rho,
                retimed=dev["retimed"],
                rungs=[dict(plan=tuple(p.card), ms=p.measured_s * 1e3,
                            predicted_ms=p.score * 1e3, err=p.max_err)
                       for p in rungs])


#: phase search (d): the seed of the fused sweeps' operands
FUSED_SWEEP_SEED = 22


def _fused_points():
    """Phase search (d)'s sweep points, (tag, forward spec, whether its
    backward specs are swept too): attention at the attn-path's shapes (a)
    and (e), causal; the grouped forward at the MoE training shape (32
    groups of C = 320, with its dX and dW) and at B3's serving shape (384
    groups of C = 16), kimi-k2's gate/up widths."""
    from repro_torch.core.enumerate import (attention_spec,
                                            uniform_grouped_spec)

    return [
        ("attn (a)", attention_spec(ATTN_HEADS, ATTN_SEQ, ATTN_SEQ, ATTN_DIM,
                                    causal=True), False),
        ("attn (e)", attention_spec(ATTN_LONG_HEADS, ATTN_LONG_SEQ,
                                    ATTN_LONG_SEQ, ATTN_DIM, causal=True),
         False),
        ("moe train", uniform_grouped_spec(MOE_TRAIN_EXPERTS, MOE_TRAIN_C,
                                           *GROUPED_GATE), True),
        ("moe serve", uniform_grouped_spec(N_EXPERTS, 16, *GROUPED_GATE),
         False),
    ]


def _fused_kernel_name(spec):
    """The ``_kernel_of`` name of the fused kernel that runs ``spec``."""
    root = spec.root()
    if root.fused_kind == "attention":
        return "attention"
    return "grouped_dw" if "g" in root.output else "grouped"


def _plan_text(card):
    return "none" if card is None else f"{card.body} {card.block}x{card.ctas}"


class _FusedTally:
    """Every B2 / B3 / B4 launch made inside a ``with`` block, counted by
    (kernel, orientation, the plan it ran) in ``counts`` and listed in
    launch order in ``order``: the launchers' ``__call__`` wrapped for the
    block and restored after it."""

    def __enter__(self):
        from repro_torch.codegen import fused_gen

        self.counts, self.order = collections.Counter(), []
        self._launchers = {"attention": fused_gen.ATTENTION,
                           "grouped": fused_gen.GROUPED,
                           "grouped_dw": fused_gen.GROUPED_DW}
        self._calls = {name: type(l).__call__
                       for name, l in self._launchers.items()}
        for name, launcher in self._launchers.items():
            type(launcher).__call__ = self._tallied(name)
        return self

    def _tallied(self, name):
        real, counts, order = self._calls[name], self.counts, self.order

        def call(launcher, *a, **kw):
            n0 = launcher.launches
            out = real(launcher, *a, **kw)
            if launcher.launches > n0:
                orient = "dX" if kw.get("contract_last") else ""
                counts[(name, orient, launcher.last_plan)] += 1
                order.append((name, orient, launcher.last_plan))
            return out
        return call

    def __exit__(self, *exc):
        for name, launcher in self._launchers.items():
            type(launcher).__call__ = self._calls[name]
        return False

    @staticmethod
    def text(counts):
        return ", ".join(f"{n}{' ' + o if o else ''} on {_plan_text(p)} x{c}"
                         for (n, o, p), c in counts.items()) or "none"

    def split(self, name, last):
        """(the counts of ``name``'s launches before its ``last`` ones, the
        counts of those ``last``)."""
        mine = [key for key in self.order if key[0] == name]
        cut = len(mine) - last
        return (collections.Counter(mine[:cut]),
                collections.Counter(mine[cut:]))


def _fused_ladder(tag, spec, gen, flush):
    """One card ladder of phase search (d), checked and printed; returns
    (its record, the winner's plan)."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import cached_compile
    from repro_torch.search import search_schedule

    root = spec.root()
    args = [torch.randn(tuple(root.extents[i] for i in axes), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
            for axes in root.operands.values()]
    res = search_schedule(spec, dtype=torch.bfloat16, device="cuda",
                          arrays=dict(zip(root.operands, args)),
                          plan_db=ops.default_plan_db())
    cards = [p.card for p in res.ranked]
    base, best = res.baseline(), res.best
    what = f"search (d) {spec.name} [{tag}]"
    if (len(cards) < 2 or None in cards or base is None
            or len(set(cards)) != len(cards)):
        raise AssertionError(f"{what}: plans {cards}: at least two distinct "
                             f"plans, the heuristic's among them")
    if any(p.measured_s is None or not p.max_err <= 5e-2 for p in res.ranked):
        raise AssertionError(f"{what}: a rung unmeasured or off the bf16 TOL")
    if best.measured_s > base.measured_s + max(best.spread_s, base.spread_s):
        raise AssertionError(f"{what}: the kept winner {best.card} is slower "
                             f"than the heuristic {base.card} by more than "
                             f"the larger spread")
    kernel = _fused_kernel_name(spec)
    dev = {}
    for role, rung in (("winner", best), ("heuristic", base)):
        if role == "heuristic" and rung is best:
            dev[role] = dev["winner"]
            continue
        kern = cached_compile(spec, rung.schedule, card=rung.card)
        dev[role] = _kernel_ms(lambda k=kern: k(*args), flush, kernel)[0]
    ext = "x".join(str(root.extents[i]) for i in root.indices)
    rungs = " ".join(f"{_plan_text(p.card)}={p.measured_s * 1e3:.4f}"
                     f"+-{p.spread_s * 1e3:.4f}ms/err{p.max_err:.2e}"
                     + ("*" if p is base else "") for p in res.ranked)
    print(f"[search] (d) {spec.name} {ext} [{tag}] {kernel} "
          f"{best.card.body}: {len(cards)} plans measured; winner "
          f"{_plan_text(best.card)} {best.measured_s * 1e3:.4f} ms, device "
          f"{dev['winner']:.4f} ms; heuristic {_plan_text(base.card)} "
          f"{base.measured_s * 1e3:.4f} ms, device {dev['heuristic']:.4f} ms "
          f"({base.measured_s / best.measured_s:.3f}x); rungs {rungs} "
          f"(* the heuristic)", flush=True)
    record = dict(
        tag=tag, spec=spec.name, extents=ext, kernel=kernel,
        winner=tuple(best.card), winner_ms=best.measured_s * 1e3,
        winner_device_ms=dev["winner"], heuristic=tuple(base.card),
        heuristic_ms=base.measured_s * 1e3,
        heuristic_device_ms=dev["heuristic"],
        rungs=[dict(plan=tuple(p.card), ms=p.measured_s * 1e3,
                    spread_ms=p.spread_s * 1e3, err=p.max_err)
               for p in res.ranked])
    return record, best.card


def _fused_ops(tag, fwd, grads, winners, gen):
    """``ops.attention`` / ``ops.grouped_dense`` (and, with ``grads``, its
    backward) at a point of ``_fused_points`` under the stored plan DB;
    returns ((kernel, orientation) -> the plan each launch of the tally
    must have run, the largest error against the plain versions)."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import fused_gen

    root = fwd.root()
    if root.fused_kind == "attention":
        h, s, t, d = (root.extents[i] for i in "hstd")
        q, k, v = (torch.randn(h, n, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for n in (s, t, t))
        got = ops.attention(q, k, v, causal=True, differentiable=False)
        want = fused_gen.attention_ref(q, k, v, causal=True,
                                       kv_lengths=None,
                                       out_dtype=torch.bfloat16)
        err = _check_rows(got, want, "bfloat16",
                          f"search (d) ops.attention [{tag}]")[1]
        return {("attention", "", winners[(tag, "attention")]): 1}, err
    sizes = tuple(root.group_sizes)
    kdim, fdim = root.extents["k"], root.extents["f"]
    x = torch.randn(sum(sizes), kdim, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(grads)
    w = torch.randn(len(sizes), kdim, fdim, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(grads)
    got = ops.grouped_dense(x, w, sizes, differentiable=grads)
    xd, wd = x.detach(), w.detach()
    want = fused_gen.grouped_ref(xd, wd, sizes, out_dtype=torch.bfloat16)
    err = _check_close(got.detach(), want, "bfloat16",
                       f"search (d) ops.grouped_dense [{tag}]")[1]
    expect = {("grouped", "", winners[(tag, "grouped_matmul")]): 1}
    if grads:
        g = torch.randn(got.shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        dx, dw = torch.autograd.grad(got, (x, w), g)
        err = max(err, _check_close(
            dx, fused_gen.grouped_ref(g, wd, sizes, out_dtype=torch.bfloat16,
                                      contract_last=True),
            "bfloat16", f"search (d) grouped dX [{tag}]")[1], _check_close(
            dw, fused_gen.grouped_dw_ref(xd, g, sizes,
                                         out_dtype=torch.bfloat16),
            "bfloat16", f"search (d) grouped dW [{tag}]")[1])
        expect[("grouped", "dX", winners[(tag, "grouped_matmul.dX")])] = 1
        expect[("grouped_dw", "", winners[(tag, "grouped_matmul.dW")])] = 1
    return expect, err


def _search_fused(flush):
    """Phase search (d): ``search_schedule`` on the card, bf16, at full
    width, of ``attention`` at the attn-path's shapes (a) and (e) (causal),
    ``grouped_matmul`` with its backward specs at the MoE training shape
    (ladders of B3's forward, B3's dX and B4's dW) and at B3's serving
    shape, into the plan DB ``REPRO_PLAN_DB`` names (``_fused_ladder``:
    every candidate of ``space.fused_card_candidates`` measured, the
    heuristic's plan among them, each checked against the f64 oracle at
    the bf16 TOL with one launch of its kernel a timed call, on its plan;
    at least two plans; the kept winner no slower than the heuristic by
    more than the larger of their spreads; every rung printed, and the
    winner's and the heuristic's device ms on the profiler).  Then
    ``ops.attention`` and ``ops.grouped_dense`` (its backward too, at the
    training shape) under the stored DB (``_fused_ops``): every launch of
    B2, B3 and B4, tallied by kernel, orientation and the ``FusedPlan``
    it ran, on its ladder's winner, and each result within the bf16 TOL
    of its plain version."""
    import torch

    from repro_torch.search import sweep_specs

    gen = torch.Generator(device="cuda").manual_seed(FUSED_SWEEP_SEED)
    ladders, winners = [], {}
    for tag, fwd, grads in _fused_points():
        for _, spec in sweep_specs(fwd, with_grads=grads):
            record, winners[(tag, spec.name)] = _fused_ladder(tag, spec, gen,
                                                              flush)
            ladders.append(record)
            _free()

    # every B2 / B3 / B4 launch of the ops, by (kernel, orientation, plan)
    checked = []
    for tag, fwd, grads in _fused_points():
        with _FusedTally() as tally:
            expect, err = _fused_ops(tag, fwd, grads, winners, gen)
        if dict(tally.counts) != expect:
            raise AssertionError(
                f"search (d) [{tag}]: launches by (kernel, orientation, "
                f"plan) {dict(tally.counts)}, each ladder's winner {expect}")
        print(f"[search] (d) ops under the plan DB [{tag}]: "
              f"{tally.text(tally.counts)}, "
              f"each its ladder's winner; error {err:.3e} within the bf16 "
              f"TOL", flush=True)
        checked.append(dict(tag=tag, err=err, launches={
            f"{n} {o}".strip(): tuple(p) for n, o, p in tally.counts}))
        _free()
    return dict(ladders=ladders, ops=checked)


#: phase search (e): the seed of the B1 mode sweeps' operands, and
#: ``dense_act``'s epilogue there (the fused path's)
B1_MODES_SEED = 23
B1_MODES_ACT, B1_MODES_EPS = "gelu", 1e-5


def _b1_mode_points():
    """Phase search (e)'s ladders, (tag, spec, dtype, epilogue):
    ``weighted_matmul`` and its ``.dA``, ``.dB``, ``.dg`` and
    ``dense_act``'s forward (the epilogue ladder) at the fused path's M =
    2048, D = 4096, F = 12288 in bf16; the int8 and fp8 tiers of
    ``matmul`` at ``QUANT_SHAPES[0]`` under the dequant epilogue
    ``ops.dense(quant=)`` launches them with (``quant_tier_epilogue``) and
    the int8 weighted forward there; the chain at ``CHAIN_SHAPE`` in bf16
    and f32."""
    import torch

    from repro_torch import codegen
    from repro_torch.core import enumerate as E
    from repro_torch.search import quant_tier_epilogue, sweep_specs

    bf16 = torch.bfloat16
    weighted = E.weighted_matmul_spec(FUSED_M, FUSED_D, FUSED_F)
    points = [(f"weighted {label}", spec, bf16, None)
              for label, spec in sweep_specs(weighted, with_grads=True)]
    points.append(("dense_act", E.matmul_spec(FUSED_M, FUSED_D, FUSED_F),
                   bf16, codegen.Epilogue(act=B1_MODES_ACT, bias=True,
                                          norm=True, eps=B1_MODES_EPS)))
    for fmt in ("int8", "fp8"):
        spec = E.quantize_spec(E.matmul_spec(*QUANT_SHAPES[0]), fmt=fmt)
        points.append((fmt, spec, getattr(torch, spec.quant.dtype),
                       quant_tier_epilogue(spec, "cuda")))
    points.append(("int8 weighted", E.quantize_spec(weighted, fmt="int8"),
                   torch.int8, None))
    for dt in (bf16, torch.float32):
        points.append((f"chain {str(dt)[6:]}",
                       E.chain_matmul_spec(*CHAIN_SHAPE), dt, None))
    return points


def _mode_operand(shape, dt, gen, kmajor=False):
    """A seeded operand on the card: normals in ``dt`` (rounded to e4m3 for
    fp8), ints in [-4, 4] for int8 (every product and int32 sum exact, so
    the f64 oracle is the int8 one); ``kmajor`` a matrix laid out with its
    first axis unit-stride (an 8-bit W as ``ops.dense(quant=)`` writes
    it)."""
    import torch

    if dt == torch.int8:
        x = torch.randint(-4, 5, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(dt)
    else:
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    return x.t().contiguous().t() if kmajor else x


def _b1_mode_kernel(spec, dt):
    """The ``_kernel_of`` name of the kernel a ladder of ``spec`` at ``dt``
    times."""
    import torch

    root = spec.root()
    if len(root.operands) == 3 and root.name.startswith("chain"):
        return "contract_chain"
    return {torch.int8: "contract_int8",
            torch.float8_e4m3fn: "contract_fp8"}.get(dt, "contract")


def _b1_plan_text(card):
    if card is None:
        return "none"
    if hasattr(card, "tile_n"):
        return f"{card.body} {card.tile_n}x{card.splits}"
    if hasattr(card, "assoc"):
        return f"{card.assoc} cluster {card.cluster}"
    return f"ring ctas {card.ctas}"


def _b1_mode_ladder(tag, spec, dt, epi, gen, flush):
    """One card ladder of phase search (e), checked and printed; returns
    (its record, the winner's plan).  A winner other than the heuristic
    must have won its re-time (``search.confirm.kept``)."""
    from repro_torch import obs, ops
    from repro_torch.codegen import cached_compile
    from repro_torch.search import search_schedule
    from repro_torch.search.measure import epilogue_vectors

    root = spec.root()
    gemm8 = dt.itemsize == 1 and len(root.operands) == 2
    args = [_mode_operand(tuple(root.extents[i] for i in axes), dt, gen,
                          kmajor=gemm8 and axes[0] not in root.output)
            for axes in root.operands.values()]
    kept0 = obs.metrics_json()["counters"].get("search.confirm.kept", 0)
    res = search_schedule(spec, dtype=dt, device="cuda",
                          arrays=dict(zip(root.operands, args)),
                          plan_db=ops.default_plan_db(), epilogue=epi)
    retimed = (obs.metrics_json()["counters"].get("search.confirm.kept", 0)
               - kept0)
    cards = [p.card for p in res.ranked]
    base, best = res.baseline(), res.best
    what = f"search (e) {spec.name} [{tag}]"
    if best is not base and retimed != 1:
        raise AssertionError(f"{what}: the winner {best.card} was kept "
                             f"without surviving its re-time")
    tol = 5e-2 if dt.itemsize == 2 else 1e-3
    if (len(cards) < 2 or None in cards or base is None
            or len(set(cards)) != len(cards)):
        raise AssertionError(f"{what}: plans {cards}: at least two distinct "
                             f"plans, the heuristic's among them")
    if any(p.measured_s is None or not p.max_err <= tol for p in res.ranked):
        raise AssertionError(f"{what}: a rung unmeasured or off the TOL")
    if best.measured_s > base.measured_s + max(best.spread_s, base.spread_s):
        raise AssertionError(f"{what}: the kept winner {best.card} is slower "
                             f"than the heuristic {base.card} by more than "
                             f"the larger spread")
    kernel = _b1_mode_kernel(spec, dt)
    vecs = ({} if epi is None else
            epilogue_vectors(spec, epi, args[0].device))
    dev = {}
    for role, rung in (("winner", best), ("heuristic", base)):
        if role == "heuristic" and rung is best:
            dev[role] = dev["winner"]
            continue
        kern = cached_compile(spec, rung.schedule, card=rung.card,
                              epilogue=epi,
                              out_dtype="float32" if dt.itemsize == 1
                              else None)
        dev[role] = _kernel_ms(lambda k=kern: k(*args, **vecs), flush,
                               kernel)[0]
    ext = "x".join(str(root.extents[i]) for i in root.indices)
    rungs = " ".join(f"{_b1_plan_text(p.card)}={p.measured_s * 1e3:.4f}"
                     f"+-{p.spread_s * 1e3:.4f}ms/err{p.max_err:.2e}"
                     + ("*" if p is base else "") for p in res.ranked)
    print(f"[search] (e) {spec.name} {ext} [{tag}] {kernel}: {len(cards)} "
          f"plans measured; winner {_b1_plan_text(best.card)} "
          f"{best.measured_s * 1e3:.4f} ms, device {dev['winner']:.4f} ms; "
          f"heuristic {_b1_plan_text(base.card)} {base.measured_s * 1e3:.4f}"
          f" ms, device {dev['heuristic']:.4f} ms "
          f"({base.measured_s / best.measured_s:.3f}x"
          f"{', re-timed and kept' if best is not base else ''}); rungs "
          f"{rungs} (* the heuristic)", flush=True)
    record = dict(
        tag=tag, spec=spec.name, extents=ext, kernel=kernel,
        winner=best.card.as_dict(), retimed=best is not base, winner_ms=best.measured_s * 1e3,
        winner_device_ms=dev["winner"], heuristic=base.card.as_dict(),
        heuristic_ms=base.measured_s * 1e3,
        heuristic_device_ms=dev["heuristic"],
        rungs=[dict(plan=p.card.as_dict(), ms=p.measured_s * 1e3,
                    spread_ms=p.spread_s * 1e3, err=p.max_err)
               for p in res.ranked])
    return record, best.card


class _B1Tally:
    """Every launch of ``CONTRACT``, ``CONTRACT_INT8``, ``CONTRACT_FP8``
    and ``CONTRACT_CHAIN`` made inside a ``with`` block, counted by
    (launcher, the plan it ran) in ``counts``: the launchers' classes'
    ``__call__`` wrapped for the block and restored after it."""

    def __enter__(self):
        from repro_torch.codegen import cuda_gen, modes

        self.counts = collections.Counter()
        self._names = {id(cuda_gen.CONTRACT): "contract",
                       id(modes.CONTRACT_INT8): "contract_int8",
                       id(modes.CONTRACT_FP8): "contract_fp8",
                       id(modes.CONTRACT_UPCAST): "contract_upcast",
                       id(modes.CONTRACT_CHAIN): "contract_chain"}
        self._classes = (cuda_gen.ContractLauncher, modes.Contract8Launcher,
                         modes.ChainLauncher)
        self._calls = [c.__call__ for c in self._classes]
        for cls, real in zip(self._classes, self._calls):
            cls.__call__ = self._tallied(real)
        return self

    def _tallied(self, real):
        counts, names = self.counts, self._names

        def call(launcher, *a, **kw):
            n0 = launcher.launches
            out = real(launcher, *a, **kw)
            if launcher.launches > n0:
                ran = (launcher.last_card if hasattr(launcher, "last_card")
                       else launcher.last_plan)
                counts[(names[id(launcher)], ran)] += 1
            return out
        return call

    def __exit__(self, *exc):
        for cls, real in zip(self._classes, self._calls):
            cls.__call__ = real
        return False

    @staticmethod
    def text(counts):
        return ", ".join(f"{n} on {_b1_plan_text(p)} x{c}"
                         for (n, p), c in counts.items()) or "none"


def _b1_mode_ops(winners, gen):
    """The ops under the stored plan DB at phase search (e)'s points:
    ``weighted_dense`` forward and backward, ``dense_act``'s forward,
    ``dense(quant="int8" / "fp8")``, the int8 weighted forward through
    ``ops._tuned_kernel`` (no op takes it) and ``chain_dense`` in bf16 and
    f32.  Returns [(tag, the tally's expected counts, the largest error
    against the plain versions, the call)]: each call is made inside the
    caller's tally."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import Epilogue, contract_ref
    from repro_torch.core import enumerate as E
    from repro_torch.optim.quant import (quantize_channels_kmajor,
                                         quantize_tensor)

    bf16 = torch.bfloat16
    m, d, f = FUSED_M, FUSED_D, FUSED_F
    calls = []

    def weighted():
        x = _mode_operand((m, d), bf16, gen).requires_grad_(True)
        w = _mode_operand((d, f), bf16, gen).requires_grad_(True)
        g = _mode_operand((d,), bf16, gen).requires_grad_(True)
        out = ops.weighted_dense(x, w, g)
        cot = _mode_operand((m, f), bf16, gen)
        dx, dw, dg = torch.autograd.grad(out, (x, w, g), cot)
        spec = E.weighted_matmul_spec(m, d, f)
        from repro_torch.grad import derived_specs

        dsp = derived_specs(spec)
        xd, wd, gd = x.detach(), w.detach(), g.detach()
        pairs = [(out.detach(), contract_ref(spec, xd, wd, gd,
                                             out_dtype=bf16)),
                 (dx, contract_ref(dsp["A"], cot, wd, gd, out_dtype=bf16)),
                 (dw, contract_ref(dsp["B"], cot, xd, gd, out_dtype=bf16)),
                 (dg, contract_ref(dsp["g"], cot, xd, wd, out_dtype=bf16))]
        return max(_check_close(a, b, "bfloat16",
                                f"search (e) weighted_dense [{i}]")[1]
                   for i, (a, b) in enumerate(pairs))

    calls.append(("weighted_dense", [
        ("contract", winners["weighted fwd"]),
        ("contract", winners["weighted dA"]),
        ("contract", winners["weighted dB"]),
        ("contract", winners["weighted dg"])], weighted))

    def dense_act():
        x = _mode_operand((m, d), bf16, gen)
        w = _mode_operand((d, f), bf16, gen)
        beta, mean = (_mode_operand((f,), torch.float32, gen)
                      for _ in range(2))
        var = torch.rand(f, generator=gen, device="cuda") + 0.5
        got = ops.dense_act(x, w, beta, mean, var, act=B1_MODES_ACT,
                            eps=B1_MODES_EPS, differentiable=False)
        epi = Epilogue(act=B1_MODES_ACT, bias=True, norm=True,
                       eps=B1_MODES_EPS)
        want = epi.apply((x.float() @ w.float()), {
            "bias": beta[None], "mean": mean[None], "var": var[None]}).to(
                bf16)
        return _check_close(got, want, "bfloat16",
                            "search (e) ops.dense_act")[1]

    calls.append(("dense_act", [("contract", winners["dense_act"])],
                  dense_act))

    for fmt in ("int8", "fp8"):
        def dense_quant(fmt=fmt):
            qm, qd, qf = QUANT_SHAPES[0]
            x = _mode_operand((qm, qd), bf16, gen)
            w = _mode_operand((qd, qf), bf16, gen)
            with torch.no_grad():
                got = ops.dense(x, w, out_dtype=torch.float32, quant=fmt)
            qx, sx = quantize_tensor(x, fmt)
            qwt, sw = quantize_channels_kmajor(w, fmt)
            want = (qx.float() @ qwt.t().float()) * (sx * sw).float()[None]
            return _check_close(got, want, "float32",
                                f"search (e) ops.dense(quant={fmt!r})")[1]

        calls.append((f"dense {fmt}", [(f"contract_{fmt}", winners[fmt])],
                      dense_quant))

    def weighted_int8():
        spec = E.quantize_spec(E.weighted_matmul_spec(m, d, f), fmt="int8")
        a, b, g = (_mode_operand(shape, torch.int8, gen)
                   for shape in ((m, d), (d, f), (d,)))
        got = ops._tuned_kernel(spec, torch.int8)(a, b, g)
        want = contract_ref(spec, a, b, g, out_dtype=torch.int32)
        return _check_exact(got, want, "search (e) int8 weighted")[1]

    calls.append(("int8 weighted", [("contract_int8",
                                     winners["int8 weighted"])],
                  weighted_int8))

    for dt in (bf16, torch.float32):
        def chain(dt=dt):
            r, p, q, c = CHAIN_SHAPE
            a, b, cc = (_mode_operand(shape, dt, gen)
                        for shape in ((r, p), (p, q), (q, c)))
            got = ops.chain_dense(a, b, cc, differentiable=False)
            want = contract_ref(E.chain_matmul_spec(*CHAIN_SHAPE), a, b, cc,
                                out_dtype=dt)
            return _check_close(got, want, str(dt)[6:],
                                f"search (e) ops.chain_dense {dt}")[1]

        tag = f"chain {str(dt)[6:]}"
        calls.append((tag, [("contract_chain", winners[tag])], chain))
    return calls


def _search_b1_modes(flush):
    """Phase search (e): ``search_schedule`` on the card of B1's modes
    into the plan DB ``REPRO_PLAN_DB`` names (``_b1_mode_points``): the
    weighted family's four specs and ``dense_act``'s epilogue ladder on
    ``card_candidates`` ranked by the cost model, the int8 / fp8 tiers and
    the int8 weighted forward on every plan of the 8-bit ring
    (``Q8Plan``), the chain on every association x cluster
    (``ChainPlan``); each ladder two or more distinct plans, the
    heuristic's among them, every rung checked against the f64 oracle
    (the bf16 TOL; 1e-3 for f32 and the 8-bit tiers), the kept winner no
    slower than the heuristic by more than the larger spread, every rung
    printed, and the winner's and the heuristic's device ms on the
    profiler (``_b1_mode_ladder``).  Then the ops under the stored DB
    (``_b1_mode_ops``): every launch of B1's launchers, tallied by
    (launcher, the plan it ran), on its ladder's winner, and each result
    within its TOL of the plain version (int8 exact)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(B1_MODES_SEED)
    ladders, winners = [], {}
    for tag, spec, dt, epi in _b1_mode_points():
        record, winners[tag] = _b1_mode_ladder(tag, spec, dt, epi, gen,
                                               flush)
        ladders.append(record)
        _free()
    checked = []
    for tag, expect, call in _b1_mode_ops(winners, gen):
        with _B1Tally() as tally:
            err = call()
            torch.cuda.synchronize()
        want = collections.Counter(expect)
        if dict(tally.counts) != dict(want):
            raise AssertionError(
                f"search (e) [{tag}]: launches by (launcher, plan) "
                f"{dict(tally.counts)}, each ladder's winner {dict(want)}")
        print(f"[search] (e) ops under the plan DB [{tag}]: "
              f"{_B1Tally.text(tally.counts)}, each its ladder's winner; "
              f"error {err:.3e} within its TOL", flush=True)
        checked.append(dict(tag=tag, err=err, launches={
            f"{n} {_b1_plan_text(p)}": c for (n, p), c in tally.counts.items()
        }))
        _free()
    return dict(ladders=ladders, ops=checked)


def phase_search(serve13):
    """The variant search on the card, under its own plan DB
    (``$CHIP_SMOKE_OUT/plans_search.json``; ``REPRO_PLAN_DB`` restored
    after).  (a) ``python -m repro_torch.search.sweep`` (its ``run``) on
    ``matmul`` at ``SEARCH_SHAPES`` in bf16 with ``--with-grads``: twelve
    card ladders, each the launcher's heuristic plan and the top
    ``SEARCH_TOPK`` plans of ``card_candidates`` by ``card_plan_cost``,
    every one checked against the f64 oracle at the bf16 TOL with one B1
    launch a timed call on its plan (``search.measure``); the search
    keeps the heuristic's plan first unless another beat its median by
    more than the larger of their spreads, in the ladder's timing and in
    a second of the two alone (``search._keep_heuristic_within_spread``);
    where the
    winner is not the heuristic's plan, the two re-timed by
    ``measure_schedules`` and the winner no slower than the heuristic by
    more than the larger of their spreads (interquartile ranges); for
    each ladder the winner's and the heuristic's device ms on the
    profiler, and the Spearman value of the model's prediction against
    the measurement.  (b) ``serve.main`` with
    phase 13's flags and ``--search-gemms`` of those shapes: the prefill
    runner ladders them with their backward specs, the decode runner at M
    = lanes (the narrow body); every request complete with tokens in the
    vocab, B1 launched 7 x 36 x (prefills + decode steps) times while
    serving, each launch on the plan its shape's phase ladder names (the
    heuristic's where no ladder holds the shape), by a tally of
    ``CONTRACT``'s calls by shape and ``last_card``;
    then a second engine start on the same weights finds every ladder in
    the plan DB (``plandb.hit``) and measures and launches nothing.
    Prefill ms and decode tok/s beside phase 13's.  (c)
    ``codegen.tune_schedule(measure_with=)`` on CUDA bf16 operands at
    ``TUNE_SHAPE`` (no ladder of (a) or (b) holds it): the search
    measures its card ladder into the plan DB, the stored entry is
    measured with the ladder winner's time and plan, and a second call is
    a hit.  (d) ``_search_fused``: the fused kernels' card ladders (B2 at
    the attn-path's two shapes, B3's forward and dX and B4's dW at the
    MoE training shape, B3 at its serving shape) under the same plan DB,
    and ``ops.attention`` / ``ops.grouped_dense`` launching each ladder's
    winner.  (e) ``_search_b1_modes``: B1's weighted family, epilogue,
    8-bit and chain ladders, and the ops launching each winner."""
    import torch

    from repro_torch import obs
    from repro_torch.codegen import (CONTRACT, AutotuneCache, cached_compile,
                                     tune_schedule)
    from repro_torch.codegen.cuda_gen import (CardPlan, ContractLauncher,
                                              _sm_count, card_of,
                                              launch_plan)
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.launch import serve
    from repro_torch.launch.serving import ContinuousEngine
    from repro_torch.search import (PlanDB, measure_schedules,
                                    reference_arrays, sweep)

    path = os.path.join(OUT, "plans_search.json")
    for leftover in (path, path + ".lock"):
        if os.path.exists(leftover):
            os.remove(leftover)
    old = os.environ.get("REPRO_PLAN_DB")
    os.environ["REPRO_PLAN_DB"] = path
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    shapes = ";".join(",".join(map(str, s)) for s in SEARCH_SHAPES)
    try:
        # (a) the sweep
        t0 = time.perf_counter()
        rc, results = sweep.run(["--spec", "matmul", "--shapes", shapes,
                                 "--dtype", "bfloat16", "--with-grads",
                                 "--topk", str(SEARCH_TOPK),
                                 "--device", "cuda"])
        if rc or len(results) != 3 * len(SEARCH_SHAPES):
            raise AssertionError(f"search: the sweep returned {rc} over "
                                 f"{len(results)} ladders")
        ladders = []
        for label, spec, _, res in results:
            cards = [p.card for p in res.ranked]
            base = res.baseline()
            if None in cards or len(set(cards)) != len(cards) or base is None:
                raise AssertionError(f"search {spec.name}: plans {cards}: "
                                     f"each rung must be a distinct plan, "
                                     f"the heuristic's among them")
            if any(p.measured_s is None or not p.max_err <= 5e-2
                   for p in res.ranked):
                raise AssertionError(f"search {spec.name}: a rung unmeasured "
                                     f"or off the bf16 TOL")
            arrays = reference_arrays(spec, "bfloat16")
            args = [torch.from_numpy(arrays[n]).cuda().to(torch.bfloat16)
                    for n in spec.operands]
            dev = {"retimed": None}
            if res.best.card != base.card:
                # the winner won two timings: it must not lose a third
                again = measure_schedules(
                    spec, [res.best.schedule, base.schedule],
                    arrays=dict(zip(spec.operands, args)),
                    dtype=torch.bfloat16, cards=[res.best.card, base.card])
                slack = max(r.spread_s for r in again)
                dev["retimed"] = (again[0].seconds * 1e3,
                                  again[1].seconds * 1e3, slack * 1e3)
                if again[0].seconds > again[1].seconds + slack:
                    raise AssertionError(
                        f"search {spec.name}: the winner "
                        f"{tuple(res.best.card)} re-timed at "
                        f"{dev['retimed'][0]:.4f} ms, the heuristic "
                        f"{tuple(base.card)} at {dev['retimed'][1]:.4f} ms, "
                        f"spread {dev['retimed'][2]:.4f} ms; the ladder "
                        + " ".join(f"{tuple(p.card)}={p.measured_s * 1e3:.4f}"
                                   f"+-{(p.spread_s or 0) * 1e3:.4f}ms"
                                   for p in res.ranked))
            for tag, rung in (("winner", res.best), ("heuristic", base)):
                kern = cached_compile(spec, rung.schedule, card=rung.card)
                dev[tag] = _kernel_ms(lambda k=kern: k(*args), flush,
                                      "contract")[0]
            ladders.append(_ladder_line(label, spec, res, dev))
            del args
        sweep_s = time.perf_counter() - t0

        # (b) serving with the search: B1's launches while serving, by
        # ((batch, M, N, K), the CardPlan each ran)
        snap, tally = {}, collections.Counter()
        engine_run = ContinuousEngine.run
        launcher_call = ContractLauncher.__call__

        def tallied_call(self, a, b, *args, **kw):
            n0 = self.launches
            out = launcher_call(self, a, b, *args, **kw)
            if self is CONTRACT and self.launches > n0:
                tally[((a.shape[0], a.shape[1], b.shape[2], a.shape[2]),
                       self.last_card)] += 1
            return out

        def run_after_search(self, *a, **kw):
            torch.cuda.synchronize()
            snap.update(launches=CONTRACT.launches)
            ContractLauncher.__call__ = tallied_call
            return engine_run(self, *a, **kw)

        ContinuousEngine.run = run_after_search
        t0 = time.perf_counter()
        try:
            stats, trace, engine = serve.main(SERVE_ARGS + [
                "--search-gemms", shapes])
        finally:
            ContinuousEngine.run = engine_run
            ContractLauncher.__call__ = launcher_call
        serve_s = time.perf_counter() - t0
        cfg = engine.cfg
        for r in trace:
            if len(r.out_tokens) != r.max_new or r.state != "finished":
                raise AssertionError(f"search serve: request {r.rid} ended "
                                     f"with {len(r.out_tokens)}/{r.max_new}")
            if not all(0 <= t < cfg.vocab for t in r.out_tokens):
                raise AssertionError(f"search serve: request {r.rid}: token "
                                     f"outside the vocab")
        launches = CONTRACT.launches - snap["launches"]
        want = 7 * cfg.n_layers * (stats["prefills"] + stats["decode_steps"])
        if launches != want or stats["kernel_launches"] != want:
            raise AssertionError(f"search serve: {launches} B1 launches, "
                                 f"expected {want}")
        db = PlanDB(path)
        sms = _sm_count(torch.device("cuda"))
        by_source = collections.Counter()
        if sum(tally.values()) != launches:
            raise AssertionError(f"search serve: {sum(tally.values())} "
                                 f"launches tallied of {launches}")
        for ((batch, m, n, k), card), count in tally.items():
            phase = ("prefill" if (m, k, n) in SEARCH_SHAPES else
                     "decode" if m == engine.lanes and (
                         SEARCH_SHAPES[0][0], k, n) in SEARCH_SHAPES
                     else None)
            if phase:
                _, rung = db.best_entry(matmul_spec(m, k, n), torch.bfloat16,
                                        phase=phase)
                plan = CardPlan.from_dict(rung.get("card"))
            else:
                plan = card_of(card.body, launch_plan(
                    card.body, None, batch, m, n, k, sms)[0])
            if card != plan:
                raise AssertionError(f"search serve: (M, N, K) = {(m, n, k)}"
                                     f" launched {card}, its {phase or 'no'}"
                                     f" ladder names {plan}")
            by_source[f"{phase or 'heuristic'} M={m} {card.body} "
                      f"{card.tile_n}x{card.splits}"] += count
        served = []
        for phase, m in (("prefill", SEARCH_SHAPES[0][0]),
                         ("decode", engine.lanes)):
            for _, k, n in SEARCH_SHAPES:
                rungs = db.get(matmul_spec(m, k, n), torch.bfloat16,
                               phase=phase)["ranked"]
                base = next(r for r in rungs if r["source"] == "default")
                row = dict(phase=phase, shape=(m, k, n),
                           winner=rungs[0]["card"],
                           winner_ms=rungs[0]["measured_s"] * 1e3,
                           heuristic=base["card"],
                           heuristic_ms=base["measured_s"] * 1e3)
                served.append(row)
                print(f"[search] {phase} ladder {m}x{k}x{n}: "
                      + " ".join(f"{r['card']['tile_n']}x"
                                 f"{r['card']['splits']}="
                                 f"{r['measured_s'] * 1e3:.4f}ms"
                                 + ("*" if r is base else "")
                                 for r in rungs)
                      + f" (* the heuristic; winner "
                      f"{row['heuristic_ms'] / row['winner_ms']:.3f}x)",
                      flush=True)
        if not any(key.startswith(f"prefill M={SEARCH_SHAPES[0][0]} ")
                   for key in by_source):
            raise AssertionError(f"search serve: no launch at M = "
                                 f"{SEARCH_SHAPES[0][0]}: {dict(by_source)}")
        laddered = sum(n for key, n in by_source.items()
                       if not key.startswith("heuristic"))
        if (stats["card_plans_applied"], stats["card_plans_skipped"]) != (
                laddered, 0):
            raise AssertionError(
                f"search serve: plans applied {stats['card_plans_applied']}"
                f", skipped {stats['card_plans_skipped']}; {laddered} "
                f"launches ran on a ladder's plan")
        print(f"[search] serve --search-gemms: {launches} B1 launches = 7 x "
              f"{cfg.n_layers} x ({stats['prefills']} prefills + "
              f"{stats['decode_steps']} decode steps), each on its ladder's "
              f"plan (ops.card_plan.applied {stats['card_plans_applied']}, "
              f".skipped {stats['card_plans_skipped']}): "
              f"{json.dumps(dict(sorted(by_source.items())))}; prefill"
              f" {stats['prefill_s'] * 1e3:.1f} ms (phase 13: "
              f"{serve13['prefill_s'] * 1e3:.1f}), decode "
              f"{stats['tok_per_s']:.2f} tok/s (phase 13: "
              f"{serve13['tok_per_s']:.2f}); wall with the sweep "
              f"{serve_s:.1f} s", flush=True)
        obs.metrics_reset()
        n0 = CONTRACT.launches
        t0 = time.perf_counter()
        again = ContinuousEngine(
            cfg, lanes=engine.lanes, page_size=engine.page_size,
            n_pages=1 + engine.lanes * engine.max_pages,
            max_ctx=engine.max_ctx, params=engine.params, device="cuda",
            search_gemms=SEARCH_SHAPES, search_grads=True)
        restart_s = time.perf_counter() - t0
        counters = obs.metrics_json()["counters"]
        hits = counters.get("plandb.hit", 0)
        if hits < SEARCH_LADDERS or counters.get("search.measured", 0) or (
                CONTRACT.launches != n0):
            raise AssertionError(f"search restart: {hits} plan-DB hits of "
                                 f"{SEARCH_LADDERS} ladders, "
                                 f"{counters.get('search.measured', 0)} "
                                 f"measured, {CONTRACT.launches - n0} "
                                 f"launches")
        print(f"[search] restart: {hits} plan-DB hits for {SEARCH_LADDERS} "
              f"ladders, nothing measured or launched, {restart_s:.2f} s",
              flush=True)
        del again, engine, trace
        _free()

        # (c) measured tuning: the tuner defers to the card search, whose
        # ladder the plan DB keeps for ops
        m, k, n = TUNE_SHAPE
        spec = matmul_spec(m, k, n)
        gen = torch.Generator(device="cuda").manual_seed(11)
        arrays = {"A": torch.randn(m, k, generator=gen, device="cuda").to(
                      torch.bfloat16),
                  "B": torch.randn(k, n, generator=gen, device="cuda").to(
                      torch.bfloat16)}
        cache = AutotuneCache(os.path.join(OUT, "tune_search.json"))
        cache.clear()
        first = tune_schedule(spec, dtype=torch.bfloat16, cache=cache,
                              measure_with=arrays)
        second = tune_schedule(spec, dtype=torch.bfloat16, cache=cache,
                               measure_with=arrays)
        with open(cache.path) as f:
            (entry,) = json.load(f).values()
        _, rung = PlanDB(path).best_entry(spec, torch.bfloat16)
        if (cache.hits, cache.misses) != (1, 1) or not entry["measured"] or (
                "card" not in entry or rung.get("card") != entry["card"]
                or rung.get("measured_s") != entry.get("measured_s")) or (
                first.levels != second.levels):
            raise AssertionError(f"search tune: hits {cache.hits}, misses "
                                 f"{cache.misses}, entry {entry}, the plan "
                                 f"DB's winner {rung}")
        print(f"[search] tune_schedule(measure_with=) {m}x{k}x{n} bf16 on the"
              f" card: measured plan {entry['card']} at "
              f"{entry['measured_s'] * 1e3:.4f} ms, the plan DB's winner; "
              f"the second call a hit", flush=True)
        del arrays
        _free()

        # (d) the fused kernels' card plans
        t0 = time.perf_counter()
        fused = _search_fused(flush)
        fused_s = time.perf_counter() - t0
        print(f"[search] (d) {len(fused['ladders'])} fused ladders and the "
              f"ops under them: {fused_s:.1f} s", flush=True)

        # (e) B1's weighted, epilogue, 8-bit and chain modes' card plans
        t0 = time.perf_counter()
        modes = _search_b1_modes(flush)
        modes_s = time.perf_counter() - t0
        print(f"[search] (e) {len(modes['ladders'])} B1 mode ladders and "
              f"the ops under them: {modes_s:.1f} s", flush=True)
    finally:
        if old is None:
            os.environ.pop("REPRO_PLAN_DB", None)
        else:
            os.environ["REPRO_PLAN_DB"] = old
    return dict(ladders=ladders, sweep_s=sweep_s,
                serve={k: v for k, v in stats.items()
                       if k != "tenant_tokens"},
                serve_plans=dict(by_source), serve_ladders=served,
                serve_s=serve_s,
                restart_hits=hits, restart_s=restart_s, tune=entry,
                fused=fused, fused_s=fused_s, b1_modes=modes,
                b1_modes_s=modes_s)


# --------------------------------------------------------------------------
# slice 6: flash attention (B2), ops.attention and its backward
# --------------------------------------------------------------------------

#: one qwen3-8b prefill's attention in the layout capture's rewrite hands to
#: ``ops.attention``: the serve trace's 4 prompts x 32 heads folded over the
#: batch (KV heads repeated), S = T = 512, head_dim 128
ATTN_HEADS, ATTN_SEQ, ATTN_DIM = 4 * 32, 512, 128
#: the serve trace's prompt lengths, each repeated over its 32 heads
ATTN_PROMPTS = (512, 128, 512, 256)
#: a long prompt: 32 heads, S = T = 4096
ATTN_LONG_HEADS, ATTN_LONG_SEQ = 32, 4096
#: library attention kernels (the SDPA yardstick's) that must not appear
LIBRARY_ATTENTION = ("flash", "fmha", "attention", "sdpa", "mem_eff")
#: the B2 body each attn-path row must run (``fused_gen.attention_body``)
ATTN_PATH_BODIES = {"a": "ring", "b": "ring", "c": "ring", "d": "tc32",
                    "e": "ring"}


def _attn_counts():
    from repro_torch.codegen import ATTENTION, CONTRACT

    return {"attention": ATTENTION.launches, "contract": CONTRACT.launches}


def _zero_attn_counts():
    from repro_torch.codegen import ATTENTION, CONTRACT

    ATTENTION.launches = CONTRACT.launches = 0


def _attn_work(h, s, t, d, e, causal, lengths, itemsize):
    """(operations, bytes) this call's data needs: the two products over
    the visible (row, column) pairs only; q and o whole, k and v up to each
    head's length."""
    total_pairs = 0
    kv_rows = 0
    for hh in range(h):
        tl = t if lengths is None else max(0, min(t, int(lengths[hh])))
        kv_rows += tl
        if causal:
            # sum over rows r of min(r + 1, tl)
            full = min(s, tl)
            total_pairs += full * (full + 1) // 2 + max(0, s - full) * tl
        else:
            total_pairs += s * tl
    ops = 2.0 * total_pairs * (d + e)
    nbytes = (h * s * (d + e) + kv_rows * (d + e)) * itemsize
    return ops, nbytes


def _library_attention(path):
    """Device kernels of a trace that are a library's attention or GEMM."""
    _, _, by_name = _device_time(path)
    return sorted(k for k in by_name if _category(k) == "cublas" or (
        _kernel_of(k) is None
        and any(w in k.lower() for w in LIBRARY_ATTENTION)))


def _sdpa(q, k, v, causal, lengths):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    with the same mask (timed here, called nowhere in the port), on the
    folded heads as one batch of H heads (4-D, which its fused backends
    take)."""
    import torch
    import torch.nn.functional as F

    q, k, v = q[None], k[None], v[None]
    if lengths is None:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    _, h, s, _ = q.shape
    t = k.shape[2]
    col = torch.arange(t, device=q.device)
    mask = col[None, None, :] < lengths.to(q.device).reshape(h, 1, 1)
    if causal:
        mask = mask & (col[None, :] <= torch.arange(s, device=q.device)
                       [:, None])[None]
    return lambda: F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=mask[None])


def phase_attn_small():
    """Card vs CPU at the reference's test shapes: ``ops.attention`` in f32
    and bf16, d in (4, 8), (s, t) in ((8, 8), (8, 16), (16, 8)), full and
    causal, then one ragged head_dim-128 case (S = 100, T = 77),
    ``kv_lengths`` with a 0 entry on a causal case, and a ragged causal
    head_dim-192 case: outputs at the f32 / bf16 TOL, the three gradients
    at (2e-4, 2e-4) / bf16 TOL, each row scaled by its own largest
    magnitude, one B2 and three B1 launches each; the head of length 0
    exact zeros, output and cotangents.  The cases run every B2 body
    (ring: bf16 d = 8, 128; mma: bf16 d = 4, 192; tc32: f32 up to 128;
    fma: f32 d = 192)."""
    import torch

    from repro_torch import ops

    from repro_torch.codegen import ATTENTION
    from repro_torch.codegen.fused_gen import ATTENTION_BODIES

    gen = torch.Generator().manual_seed(60)
    cases = [(3, s, t, d, causal, None) for d in (4, 8)
             for s, t in ((8, 8), (8, 16), (16, 8))
             for causal in (False, True)]
    cases += [(4, 100, 77, 128, False, None), (4, 100, 77, 128, True, None),
              (3, 16, 8, 8, True, (8, 3, 0)), (2, 40, 50, 192, True, None)]
    worst = {}
    bodies = {}  # body -> cases it ran
    for dt_name, grad_tol in (("float32", (2e-4, 2e-4)),
                              ("bfloat16", (6e-2, 6e-2))):
        dt = getattr(torch, dt_name)
        for h, s, t, d, causal, lens in cases:
            base = [torch.randn(shape, generator=gen).to(dt)
                    for shape in ((h, s, d), (h, t, d), (h, t, d))]
            dout = torch.randn(h, s, d, generator=gen).to(dt)
            res = {}
            for device in ("cpu", "cuda"):
                leaves = [x.detach().clone().to(device).requires_grad_(True)
                          for x in base]
                lengths = None if lens is None else torch.tensor(
                    lens, dtype=torch.int32, device=device)
                before = _attn_counts()
                out = ops.attention(*leaves, causal=causal,
                                    kv_lengths=lengths,
                                    interpret=device == "cpu")
                out.backward(dout.to(device))
                after = _attn_counts()
                if device == "cuda" and (
                    after["attention"] - before["attention"],
                    after["contract"] - before["contract"],
                ) != (1, 3):
                    raise AssertionError(f"attn-small: {before} -> {after}, "
                                         f"expected 1 B2 and 3 B1 launches")
                if device == "cuda":
                    bodies[ATTENTION.last_body] = bodies.get(
                        ATTENTION.last_body, 0) + 1
                res[device] = [out.detach().cpu()] + [x.grad.cpu()
                                                      for x in leaves]
            what = (f"attn-small h={h} s={s} t={t} d={d} causal={causal} "
                    f"kv_lengths={lens}")
            if lens is not None and not all(bool((x[lens.index(0)] == 0)
                                                 .all())
                                            for x in res["cuda"]):
                raise AssertionError(f"{what}: the head of length 0 is not "
                                     f"exact zeros (output or cotangents)")
            errs = [_check_rows(res["cuda"][0], res["cpu"][0], dt_name,
                                what)]
            errs += [_check_rows(g, w, dt_name, f"{what} grad",
                                 tol=grad_tol)
                     for g, w in zip(res["cuda"][1:], res["cpu"][1:])]
            worst[dt_name] = max(worst.get(dt_name, (0.0, 0.0)),
                                 max(errs, key=lambda x: x[1]),
                                 key=lambda x: x[1])
    print(f"[attn-small] {len(cases)} cases x f32/bf16 (one with kv_lengths "
          f"and a 0 head: exact zeros), forward and backward card vs CPU, "
          f"1 + 3 launches each; cases by B2 body {bodies}; worst (max abs, "
          f"row-scaled) "
          f"{ {k: tuple(round(x, 9) for x in v) for k, v in worst.items()} }",
          flush=True)
    if set(bodies) != set(ATTENTION_BODIES):
        raise AssertionError(f"attn-small: B2 bodies {sorted(bodies)} ran, "
                             f"expected every one of {ATTENTION_BODIES}")
    return dict(cases=len(cases), worst=worst, bodies=bodies)


def phase_attn_path():
    """``ops.attention`` at full width, through the public entry, on one
    qwen3-8b prefill's attention (128 folded heads, S = T = 512, d = 128,
    bf16): (a) causal forward, (b) causal with the trace's prompt lengths,
    (c) causal forward and backward, (d) f32 at 32 heads, (e) a 4096-token
    prompt (32 heads, causal, bf16, forward).  Counters from 0 over the
    five calls: 5 B2 launches and 3 B1 (c's backward); (a), (b), (c) and
    (e) on B2's ring body, (d) on its 3xTF32 body, each timed row one
    launch and no other device work, its device ms from the profiler
    beside the event-timed ms.  Then each forward
    against ``attention_ref`` on the card and c's output and cotangents
    against the card's plain path (``attention_ref`` under autograd), each
    row scaled by its own largest magnitude, at the bf16 / f32 TOL's atol;
    every reading is printed before any failure is raised.  Each forward
    timed (B2, ``attention_ref``, the library
    ``scaled_dot_product_attention`` with the same mask) beside its bound
    ((d)'s operations at 3xTF32's rate, its body's; the FMA rate's bound
    printed beside); each timed row's launches counted again by CUDA
    events (``_launch_witness``);
    (a) and (b) under ``torch.profiler``: no library attention or GEMM."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import ATTENTION, attention_ref

    gen = torch.Generator(device="cuda").manual_seed(61)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def qkv(h, s, dt):
        return [torch.randn(h, s, ATTN_DIM, generator=gen,
                            device="cuda").to(dt) for _ in range(3)]

    bf16, f32 = torch.bfloat16, torch.float32
    lengths = torch.tensor([n for n in ATTN_PROMPTS for _ in range(32)],
                           dtype=torch.int32, device="cuda")
    x_a = qkv(ATTN_HEADS, ATTN_SEQ, bf16)
    x_d = qkv(32, ATTN_SEQ, f32)
    x_e = qkv(ATTN_LONG_HEADS, ATTN_LONG_SEQ, bf16)
    dout = torch.randn(ATTN_HEADS, ATTN_SEQ, ATTN_DIM, generator=gen,
                       device="cuda").to(bf16)
    leaves = [x.clone().requires_grad_(True) for x in x_a]
    torch.cuda.synchronize()
    bodies = {}

    def call(tag, *args, **kwargs):
        out = ops.attention(*args, **kwargs)
        bodies[tag] = ATTENTION.last_body
        return out

    _zero_attn_counts()
    out_a = call("a", *x_a, causal=True)
    out_b = call("b", *x_a, causal=True, kv_lengths=lengths)
    out_c = call("c", *leaves, causal=True)
    out_c.backward(dout)
    out_d = call("d", *x_d, causal=True)
    out_e = call("e", *x_e, causal=True)
    torch.cuda.synchronize()
    counts = _attn_counts()
    if counts != {"attention": 5, "contract": 3}:
        raise AssertionError(f"attn-path: launches {counts}, expected 5 B2 "
                             f"(a-e) and 3 B1 (c's backward)")
    if bodies != ATTN_PATH_BODIES:
        raise AssertionError(f"attn-path: B2 bodies {bodies}, expected "
                             f"{ATTN_PATH_BODIES}")
    for out, tag in ((out_a, "a"), (out_b, "b"), (out_c, "c"),
                     (out_d, "d"), (out_e, "e")):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attn-path ({tag}): non-finite output")

    cases = [
        ("a", "causal", x_a, out_a, None),
        ("b", "causal + kv_lengths", x_a, out_b, lengths),
        ("d", "causal f32", x_d, out_d, None),
        ("e", "causal long prompt", x_e, out_e, None),
    ]
    # every reading first, then the verdict: a fault shows in each case
    readings, failed = {}, []

    def read(key, got, want, dt_name):
        limit = TOL[dt_name][1]
        readings[key] = _row_err(got, want)
        print(f"[attn-path] {key}: max abs err {readings[key][0]:.4g}, "
              f"row-scaled err {readings[key][1]:.4g} (limit {limit:g})",
              flush=True)
        if not readings[key][1] <= limit:
            failed.append(key)

    for tag, what, (q, k, v), got, lens in cases:
        read(f"({tag})", got, attention_ref(q, k, v, causal=True,
                                            kv_lengths=lens,
                                            out_dtype=q.dtype),
             str(q.dtype).replace("torch.", ""))
    # (c): output and cotangents against the card's plain path
    plain = [x.clone().requires_grad_(True) for x in x_a]
    want_c = attention_ref(*plain, causal=True, kv_lengths=None,
                           out_dtype=bf16)
    want_c.backward(dout)
    read("(c) output", out_c.detach(), want_c.detach(), "bfloat16")
    for name, g, w in zip(("dQ", "dK", "dV"), leaves, plain):
        read(f"(c) {name}", g.grad, w.grad, "bfloat16")
    del plain, want_c
    if failed:
        raise AssertionError(f"attn-path: {failed} disagree with the plain "
                             f"version (row-scaled errors "
                             f"{ {k: readings[k][1] for k in failed} })")

    rows = []
    for tag, what, (q, k, v), got, lens in cases:
        h, s, d = q.shape
        dt_name = str(q.dtype).replace("torch.", "")
        ops_, nbytes = _attn_work(h, s, k.shape[1], d, v.shape[2], True,
                                  None if lens is None else lens.tolist(),
                                  q.element_size())
        run = (lambda q=q, k=k, v=v, lens=lens: ATTENTION(
            q, k, v, True, lens, q.dtype))
        # one launch of the row's body, and no other device work
        _alone(run, "attention", 1, f"attn-path ({tag})")
        device_ms, _, _ = _kernel_ms(run, flush, "attention")
        # the second witness: three calls between CUDA events, each as long
        # as the kernel's device time, in a trace that opens with no marker
        records, event_ms = _launch_witness(
            run, "attention", f"attn-path ({tag})", device_ms)
        tc32 = bodies[tag] == "tc32"
        library = _sdpa(q, k, v, True, lens)
        # the yardstick's backend, by its device kernels' names
        library_kernels = sorted(_device_kernels(library, reps=1))
        print(f"[attn-path] ({tag}) library kernels: {library_kernels}",
              flush=True)
        rows.append(_case_row(
            "attn-path", f"({tag}) {what} H={h} S=T={s} d={d}", None, None,
            dt_name, run,
            lambda q=q, k=k, v=v, lens=lens: attention_ref(
                q, k, v, causal=True, kv_lengths=lens, out_dtype=q.dtype),
            library, ops_, nbytes, flush,
            err=readings[f"({tag})"], peak=PEAK_3XTF32 if tc32 else None,
            case_tag=tag, launches=1, body=bodies[tag], device_ms=device_ms,
            witness_records=records, witness_event_ms=event_ms,
            library_kernels=library_kernels))
        if tc32:  # the FMA body's ceiling, as this row's bound was before
            rows[-1]["fma_bound_ms"] = _bound(ops_, nbytes, dt_name)[0]
            print(f"[attn-path] ({tag}) bound at 3xTF32 "
                  f"{rows[-1]['bound_ms']:.4f} ms, at the FMA rate "
                  f"{rows[-1]['fma_bound_ms']:.4f} ms", flush=True)

    # each traced run opens with the marker: a trace drops the first
    # kernel of a session (see _device_kernels)
    marker = torch.zeros(1, dtype=torch.float64, device="cuda")

    def run_c():
        marker.fill_(1.0)
        ls = [x.detach().clone().requires_grad_(True) for x in x_a]
        ops.attention(*ls, causal=True).backward(dout)

    _, busy_c, _, by_c = _profile(run_c, "attn_backward")
    b1_c = sum(v[0] for k, v in by_c.items() if _kernel_of(k) == "contract")
    b2_c = sum(v[0] for k, v in by_c.items() if _kernel_of(k) == "attention")

    def run_ab():
        marker.fill_(1.0)
        ops.attention(*x_a, causal=True)
        ops.attention(*x_a, causal=True, kv_lengths=lengths)

    path, busy, events, by_name = _profile(run_ab, "attn_path")
    library = _library_attention(path)
    if library:
        raise AssertionError(f"attn-path: library attention or GEMM kernels "
                             f"on the path: {library}")
    b2_ms = sum(v[0] for k, v in by_name.items() if _kernel_of(k) ==
                "attention")
    measured = (f"device busy {busy:.3f} ms over {events} events, B2 "
                f"{b2_ms:.3f} ms" if by_name else
                "device time not measured (the profiler saw no device events)")
    grad_err = [readings[k] for k in ("(c) output", "(c) dQ", "(c) dK",
                                      "(c) dV")]
    print(f"[attn-path] launches {counts} (a-e: 5 B2; c's backward: 3 B1); "
          f"(c) output and dQ, dK, dV vs the plain path row-scaled err "
          f"{max(e[1] for e in grad_err):.3g}; (c) forward + backward device "
          f"busy {busy_c:.3f} ms (B2 {b2_c:.3f}, B1 {b1_c:.3f}); (a) + (b) "
          f"under the profiler: no library attention or GEMM, {measured}",
          flush=True)
    del x_a, x_d, x_e, leaves, flush, out_a, out_b, out_c, out_d, out_e
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=counts, grad_err=grad_err,
                backward_busy_ms=busy_c, backward_b1_ms=b1_c,
                backward_b2_ms=b2_c, profile_busy_ms=busy, profile_b2_ms=b2_ms)


# ---------------------------------------------------------------------------
# hof: the paper's HoF formalism (core.interp / lower / execute / autotune
# and repro_torch.paper) on the card
# ---------------------------------------------------------------------------

#: the differential families of the reference's fuzz suite: spec builder
#: name -> (arity, seed offset), with its extent pool and f32 tolerance
HOF_FAMILIES = {
    "matmul": ("matmul_spec", 3, 1000),
    "matvec": ("matvec_spec", 2, 2000),
    "weighted_matmul": ("weighted_matmul_spec", 3, 3000),
    "batched_matmul": ("batched_matmul_spec", 4, 4000),
    "transposed_matmul": ("transposed_matmul_spec", 3, 5000),
    "chain_matmul": ("chain_matmul_spec", 4, 6000),
}
HOF_EXTENTS = (2, 3, 4, 6, 8)
HOF_SEEDS = (0, 1, 2)
#: one more case a family with every extent at this size
HOF_WIDE = 32
HOF_TOL = (1e-4, 1e-4)
#: the lowered form in f64 against the f64 einsum
HOF_LOWER_TOL = 1e-10
#: Table 1 and Table 2 at the reference scripts' size, the lowered Table 1
#: also at the paper's; Fig 3 at the paper's size and block
HOF_N, HOF_PAPER_N, HOF_B2, HOF_FIG3 = 384, 1024, 16, (1024, 64)
#: Table 2 through ``execute`` at a smaller n: its two variants that map
#: over A's and B's rows both call n^2 host einsums (147456 at n = 384,
#: 7-14 s a call, four calls a variant, most of the phase)
HOF_T2_EXECUTE_N = 192
HOF_TUNE_N, HOF_TUNE_SPLITS = 256, {"j": [16, 64]}
#: worker processes for the interpreter's cases (the card's host has 8
#: cores; the two 4-index cases at extent 32 take about 10 s each)
HOF_WORKERS = 6


def _hof_case(family, seed, wide=False):
    """(spec, order, blocks) as the reference's ``_draw_case`` draws them:
    extents from ``HOF_EXTENTS`` (all ``HOF_WIDE`` for the wide case), a
    random loop order shuffled from the same stream, blocks from
    divisors; ``search.candidate_schedule(spec, order, blocks)`` is the
    schedule the reference's differential test compiles."""
    import numpy as np

    from repro_torch.core import enumerate as en

    builder, arity, offset = HOF_FAMILIES[family]
    rng = np.random.default_rng(offset + seed)
    extents = [int(rng.choice(HOF_EXTENTS)) for _ in range(arity)]
    if wide:
        extents = [HOF_WIDE] * arity
    spec = getattr(en, builder)(*extents)
    order = list(spec.indices)
    rng.shuffle(order)
    blocks = {i: int(rng.choice([d for d in range(1, spec.extents[i] + 1)
                                 if spec.extents[i] % d == 0]))
              for i in spec.indices}
    return spec, tuple(order), blocks


def _hof_arrays(spec, seed):
    """The reference's ``reference_arrays``: standard normal f32 operands
    in ``spec.operands`` order from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(
                tuple(spec.extents[i] for i in axes)).astype(np.float32)
            for name, axes in spec.operands.items()}


def _hof_interpret(case):
    """``evaluate_variant`` of one case (the HoF interpreter, numpy on the
    host); run in worker processes, so it imports the port itself."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.core.enumerate import evaluate_variant

    family, seed, wide = case
    spec, _, _ = _hof_case(family, seed, wide)
    return evaluate_variant(spec, spec.indices, _hof_arrays(spec, seed))


def _hof_differential(cases, interpreted):
    """(a): B1 through ``codegen.compile`` on CUDA f32, under
    ``default_schedule`` and under ``search.candidate_schedule`` of the
    case's random order and blocks, and the interpreter (``interpreted``:
    case -> the future of its result) against the f64 einsum at the
    reference's f32 TOL, ``contraction_to_torch`` on CUDA f64 at
    ``HOF_LOWER_TOL``; each compiled case one B1 launch by its launcher's
    count."""
    import numpy as np
    import torch

    from repro_torch import codegen
    from repro_torch.core.enumerate import einsum_formula
    from repro_torch.core.lower import contraction_to_torch
    from repro_torch.search import candidate_schedule

    rtol, atol = HOF_TOL
    rows = []
    for case in cases:
        family, seed, wide = case
        spec, order, blocks = _hof_case(family, seed, wide)
        arrays = _hof_arrays(spec, seed)
        ref = np.einsum(einsum_formula(spec),
                        *(a.astype(np.float64) for a in arrays.values()))
        what = (f"{family} seed {seed} extents {spec.extents} order "
                f"{'/'.join(order)} blocks {blocks}")
        cuda = [torch.as_tensor(a).cuda() for a in arrays.values()]
        launcher = "contract_chain" if family == "chain_matmul" else "contract"
        errs = []
        for sched in (codegen.default_schedule(spec, blocks),
                      candidate_schedule(spec, order, blocks)):
            kern = codegen.compile(spec, sched)
            _zero_new_counts()
            out = kern(*cuda)
            torch.cuda.synchronize()
            counts = _new_counts()
            want = {k: int(k == launcher) for k in counts}
            if counts != want:
                raise AssertionError(f"hof {what}: launches {counts}, "
                                     f"expected {want}")
            got = out.double().cpu().numpy()
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=f"hof: B1 != einsum for "
                                               f"{what}")
            errs.append(float(np.abs(got - ref).max()))
        lowered = contraction_to_torch(spec, spec.indices)(
            *(c.double() for c in cuda)).cpu().numpy()
        np.testing.assert_allclose(
            lowered, ref, rtol=HOF_LOWER_TOL, atol=HOF_LOWER_TOL,
            err_msg=f"hof: contraction_to_torch != einsum for {what}")
        interp = np.asarray(interpreted[case].result(), np.float64)
        np.testing.assert_allclose(
            interp, ref, rtol=rtol, atol=atol,
            err_msg=f"hof: interpreter != einsum for {what}")
        rows.append(dict(case=what, launcher=launcher,
                         b1_err=errs[0], b1_candidate_err=errs[1],
                         interp_err=float(np.abs(interp - ref).max()),
                         lower_err=float(np.abs(lowered - ref).max())))
    return rows


def _hof_line(name, result):
    """One ``[hof]`` line of a table run: each variant's ms, ``cpu_cost``
    and einsum calls, the Spearman values, ``torch.matmul`` f64's ms and
    the f64 bound."""
    rows = " ".join(f"{r['label']}={r['s'] * 1e3:.3f}ms/"
                    f"{r['cost']:.4g}/{r['einsums']}" for r in result["rows"])
    rhos = " ".join(f"{k}={result[k]:.2f}" for k in ("rho_paper", "rho_model")
                    if k in result)
    print(f"[hof] {name} {result['executor']} n={result['n']}: "
          f"variant=ms/cpu_cost/einsums {rows}; {rhos}; torch.matmul f64 "
          f"{result['matmul_s'] * 1e3:.4f} ms, bound "
          f"{result['bound_s'] * 1e3:.4f} ms", flush=True)


def phase_hof():
    """The paper's HoF formalism on the card.  (a) B1 against the
    interpreter: the reference's six differential families, three seeds
    each as its fuzz suite draws them plus one case a family at extent 32,
    compiled with ``default_schedule`` and run on CUDA f32 tensors; B1 and
    ``evaluate_variant`` (on the host, in worker processes meanwhile; the
    pool is closed before (b)) against the f64 einsum at the f32 TOL
    (1e-4, 1e-4), ``contraction_to_torch`` on CUDA f64 at 1e-10, one B1
    launch a case.
    (b) The paper's tables in f64 through ``repro_torch.paper``: Table 1
    and Table 2 (b = 16) at n = 384 through ``execute`` (Table 2 at
    ``HOF_T2_EXECUTE_N``) and ``lower``,
    Table 1 lowered at n = 1024, Fig 3 at n = 1024, b = 64 through both;
    each variant against ``torch.matmul`` at rtol 1e-8 and timed (median
    of 3 event-timed runs after a warm-up).  (c) The tuner:
    ``tune(matmul_spec(256, 256, 256), j in (16, 64), keep=4)`` measured
    on CUDA f64 tensors, its winner correct, and a second call through an
    ``AutotuneCache`` under ``OUT`` a hit with the same ranking; beside
    the measured times each variant's ``cpu_cost`` and ``core.cost``'s
    ``h100_cost`` (host einsum calls plus the card's roofline) with the
    Spearman value of each against the measurement."""
    import contextlib
    import io
    import multiprocessing

    import torch

    from repro_torch.codegen import AutotuneCache
    from repro_torch.core.autotune import tune
    from repro_torch.core.cost import h100_cost
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.core.execute import execute_variant
    from repro_torch.paper import fig3, table1, table2

    cases = [(f, s, False) for f in HOF_FAMILIES for s in HOF_SEEDS]
    cases += [(f, 0, True) for f in HOF_FAMILIES]
    # the interpreter's cases in worker processes, the slowest (extent
    # 32) first, while (a) runs on the card; the pool is closed before
    # (b) and (c), whose host-bound timings it would disturb
    with concurrent.futures.ProcessPoolExecutor(
            HOF_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = {case: pool.submit(_hof_interpret, case)
                   for case in sorted(cases, key=lambda c: not c[2])}
        diff = _hof_differential(cases, pending)
    worst = {k: max(r[k] for r in diff)
             for k in ("b1_err", "b1_candidate_err", "interp_err",
                       "lower_err")}
    print(f"[hof] differential: {len(diff)} cases (6 families x "
          f"{len(HOF_SEEDS)} seeds + 6 at extent {HOF_WIDE}), one B1 launch "
          f"each under default_schedule and under candidate_schedule of a "
          f"random order and blocks; max abs err vs the f64 einsum: B1 f32 "
          f"{worst['b1_err']:.3g} / {worst['b1_candidate_err']:.3g}, "
          f"interpreter f32 {worst['interp_err']:.3g}, contraction_to_torch "
          f"f64 {worst['lower_err']:.3g}", flush=True)

    # (b) the paper's tables; their CSV rows go to the report
    csv = io.StringIO()
    tables = {}
    with contextlib.redirect_stdout(csv):
        for executor in ("execute", "lower"):
            tables[f"table1.{executor}"] = table1.run(HOF_N, executor=executor)
            tables[f"table2.{executor}"] = table2.run(
                HOF_T2_EXECUTE_N if executor == "execute" else HOF_N,
                HOF_B2, executor=executor)
            tables[f"fig3.{executor}"] = fig3.run(*HOF_FIG3,
                                                  executor=executor)
        tables["table1.lower.paper_n"] = table1.run(HOF_PAPER_N,
                                                    executor="lower")
    for name, result in tables.items():
        _hof_line(name.split(".")[0], result)

    # (c) the variant tuner, measured on the card, then from its cache
    dev = torch.device("cuda")
    n = HOF_TUNE_N
    spec = matmul_spec(n, n, n)
    gen = torch.Generator(device=dev).manual_seed(4)
    arrays = {k: torch.randn(n, n, generator=gen, device=dev,
                             dtype=torch.float64) for k in ("A", "B")}
    cache = AutotuneCache(os.path.join(OUT, "hof_tune.json"))
    cache.clear()
    kw = dict(subdiv_candidates=HOF_TUNE_SPLITS, keep=4, measure_with=arrays,
              cache=cache)
    first = tune(spec, **kw)
    second = tune(spec, **kw)
    win = first[0]
    if win.measured_s is None:
        raise AssertionError("hof: the tuner's winner was not measured")
    got = execute_variant(win.spec, win.order, arrays)
    if not torch.allclose(got, arrays["A"] @ arrays["B"], rtol=1e-8,
                          atol=1e-8):
        raise AssertionError(f"hof: the tuner's winner {win.order} is wrong")
    ranking = lambda tvs: [(tv.order, tv.spec.split_chain(), tv.measured_s)  # noqa: E731
                           for tv in tvs]
    if (cache.hits, cache.misses) != (1, 1) or ranking(second) != ranking(first):
        raise AssertionError(f"hof: the tuner's second call did not hit "
                             f"(hits {cache.hits}, misses {cache.misses}) or "
                             f"ranked otherwise")
    tuned = [dict(order="/".join(tv.order), splits=tv.spec.split_chain(),
                  cpu_cost=tv.predicted_cost,
                  h100_cost=h100_cost(tv.spec, tv.order),
                  ms=tv.measured_s * 1e3)
             for tv in first]
    ms = [t["ms"] for t in tuned]
    # ties at their average rank: cpu_cost may give every variant one cost
    rho = {k: _rank_rho([t[k] for t in tuned], ms)
           for k in ("cpu_cost", "h100_cost")}
    print(f"[hof] tune matmul {n}^3, j in {HOF_TUNE_SPLITS['j']}: "
          + " ".join(f"{t['order']}{t['splits']}={t['ms']:.3f}ms/"
                     f"{t['cpu_cost']:.4g}/{t['h100_cost'] * 1e3:.3f}ms"
                     for t in tuned)
          + f" (variant=measured/cpu_cost/h100_cost); the second call hit "
          f"the cache with the same ranking; Spearman vs measured: "
          f"cpu_cost {rho['cpu_cost']:.2f}, h100_cost "
          f"{rho['h100_cost']:.2f}; h100_cost ranks "
          + " > ".join(t["order"] + str(t["splits"]) for t in sorted(
              tuned, key=lambda t: t["h100_cost"])), flush=True)
    _free()
    return dict(differential=diff, worst=worst, tables=tables, tune=tuned,
                tune_rho=rho, csv=csv.getvalue().splitlines())


# --------------------------------------------------------------------------
# slice 16: the fixed-slot server and the four families only it serves
# --------------------------------------------------------------------------

#: the families' full-width runs: arch -> prompt length (whisper's inside
#: its 448-token decoder context, beside 1500 encoder frames a lane: 30 s
#: of audio; internvl2's after its 256 image patches)
FAMILY_PROMPTS = {"mamba2-130m": 512, "zamba2-2.7b": 512,
                  "whisper-base": 128, "internvl2-1b": 512}
WHISPER_FRAMES = 1500
FAMILY_LANES, FAMILY_NEW = 4, 16
#: f32 batched vs batch-1 first-token logits, of max |logit|: five times
#: the most a sound run has shown on the card (4.0e-4, zamba2-2.7b), and
#: far below what a row that read another row's state would move
F32_BATCH_TOL = 2e-3
#: the f32 smoke configs of the six families, card vs CPU
FIXED_SMALL = ("qwen3-8b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-2.7b",
               "whisper-base", "internvl2-1b")


def _b1_per_forward(cfg):
    """B1 launches of one prefill and of one decode step, from the
    config: every ``ops.dense`` of an attention block (q, k, v, o) and of
    an MLP (gate, up, down for SwiGLU; w1, w2 for the GELU MLP).  The
    SSM projections, the cross-attention, the VLM projector and the
    logits are plain products, as the reference's ``jnp.dot``s are."""
    mlp = 3 if cfg.act == "silu" else 2
    if cfg.family in ("dense", "moe", "vlm"):
        n = len(_forward_gemms(cfg))
        return n, n
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        n = (4 + mlp) * (cfg.n_layers // cfg.attn_every)
        return n, n
    if cfg.family == "encdec":
        dec = (4 + mlp) * cfg.n_layers
        return (4 + mlp) * cfg.enc_layers + dec, dec
    raise KeyError(cfg.family)


def _extra_inputs(cfg, lanes, seed, device, frames=WHISPER_FRAMES,
                  dtype=None):
    """The seeded frontend embeddings of encdec (``frames`` of them a
    lane) and vlm (``N_PATCHES`` patches a lane)."""
    import torch

    from repro_torch.models import vlm
    from repro_torch.models.api import N_PATCHES

    gen = torch.Generator().manual_seed(seed)
    dtype = dtype or cfg.param_dtype
    shape = {"encdec": ("frames", (lanes, frames, cfg.d_model)),
             "vlm": ("patches", (lanes, N_PATCHES, vlm.VIT_DIM))}
    if cfg.family not in shape:
        return {}
    key, dims = shape[cfg.family]
    return {key: torch.randn(dims, generator=gen).to(dtype).to(device)}


def _as_requests(trace):
    from repro_torch.launch.serve import Request

    return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in trace]


def _first_logits(server, params, cfg, reqs, max_ctx):
    """The first-token logits of ``reqs`` from one batched prefill (packed
    as the server packs them) and from a batch-1 ``api.prefill`` of each
    prompt with its own frontend row, on ``params`` under ``cfg`` (the
    served ones, or an f32 copy).  Returns (batched (B, V) f32 logits,
    their caches, B1's launches in the batched prefill, [solo (V,) f32
    logits])."""
    import torch

    from repro_torch.codegen import CONTRACT

    extra = {k: v.to(cfg.param_dtype) for k, v in server.extra_batch.items()}
    toks, lengths = server._pack(reqs)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                       device="cuda"), **extra}
    if lengths is not None:
        batch["lengths"] = torch.as_tensor(lengths, dtype=torch.long,
                                           device="cuda")
    with torch.inference_mode():
        before = CONTRACT.launches
        logits, caches = server.api.prefill(params, cfg, batch, max_ctx)
        launches = CONTRACT.launches - before
        solos = []
        for i, r in enumerate(reqs):
            one = {"tokens": torch.as_tensor(r.prompt, dtype=torch.long,
                                             device="cuda")[None]}
            one.update({k: v[i:i + 1] for k, v in extra.items()})
            solo, _ = server.api.prefill(params, cfg, one, max_ctx)
            solos.append(solo[0, -1].float())
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.arch_id}: non-finite prefill logits")
    return logits[:, -1].float(), caches, launches, solos


def _scaled(got, want):
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _replicated(server, params, cfg, reqs, logits, max_ctx):
    """For each request, a batch of its prompt (and frontend row) repeated
    in every lane, prefilled: the batched run's shapes with no other
    prompt beside it.  Returns, per request, max over lanes of each lane's
    first-token logits against the batched run's row, scaled."""
    import torch

    extra = {k: v.to(cfg.param_dtype) for k, v in server.extra_batch.items()}
    lanes = logits.shape[0]
    out = []
    with torch.inference_mode():
        for i, r in enumerate(reqs):
            toks, lengths = server._pack([r] * lanes)
            batch = {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                               device="cuda"),
                     **{k: v[i:i + 1].repeat(lanes, *[1] * (v.dim() - 1))
                        for k, v in extra.items()}}
            if lengths is not None:
                batch["lengths"] = torch.as_tensor(lengths, dtype=torch.long,
                                                   device="cuda")
            rep, _ = server.api.prefill(params, cfg, batch, max_ctx)
            rep = rep[:, -1].float()
            out.append(max(_scaled(rep[j], logits[i])
                           for j in range(lanes)))
    return out


def _fixed_run(engine, trace, what):
    """``Gateway(engine).run(trace)`` with B1's count zeroed just before:
    every request complete with tokens in the vocabulary.  Returns (stats,
    B1 launches, peak bytes, wall s)."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.launch.serving import Gateway

    cfg = engine.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CONTRACT.launches = 0
    GROUPED.launches = 0
    t0 = time.perf_counter()
    stats = Gateway(engine).run(trace)
    took = time.perf_counter() - t0
    launches = CONTRACT.launches
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"{what}: request {r.rid} ended with "
                                 f"{len(r.out_tokens)}/{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"{what}: request {r.rid}: token outside "
                                 f"the vocab")
    return stats, launches, torch.cuda.max_memory_allocated(), took


def _check_b1(launches, stats, per, what):
    want = per[0] * stats["prefills"] + per[1] * stats["decode_steps"]
    if launches != want:
        raise AssertionError(
            f"{what}: B1 launched {launches} times, expected {per[0]} x "
            f"{stats['prefills']} prefill(s) + {per[1]} x "
            f"{stats['decode_steps']} decode step(s) = {want}")
    return want


def _library_gemm_records(path):
    """{library GEMM kernel: records} of a trace's marker session."""
    return {k: n for k, n in _kernels_after_marker(path).items()
            if _category(k) == "cublas"}


def _whole_take(run, name, key, other_ok=lambda k: True):
    """``run()`` once under ``torch.profiler`` in a session opened by the
    marker, taken again while the trace lost the marker's records, up to
    ``TAKES`` times; a take that is neither whole nor lost fails
    (``_judge_take``: B1's records equal its counter, other device work
    where ``other_ok`` allows it).  The trace goes to
    ``profile_<name>.json`` and the takes it needed to ``TAKEN[key]``.
    Returns (trace path, B1 launches counted, takes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.codegen import CONTRACT

    marker = torch.zeros(1, dtype=torch.float64, device="cuda")
    path = os.path.join(OUT, f"profile_{name}.json")
    for take in range(1, TAKES + 1):
        counted = CONTRACT.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _open_session(marker)
            run()
            torch.cuda.synchronize()
        counted = CONTRACT.launches - counted
        prof.export_chrome_trace(path)
        verdict = _judge_take([k for _, _, k in _device_events(path)],
                              "contract", counted, other_ok)
        if verdict == WHOLE:
            TAKEN[key] = take
            return path, counted, take
        if verdict != LOST:
            raise AssertionError(f"profiled {name}: {verdict}")
        print(f"[profile] {name}: take {take} lost the marker's records; "
              f"taken again", flush=True)
    raise AssertionError(f"profiled {name}: {TAKES} traces lost the "
                         f"marker's records")


def _fixed_decode_profile(engine, caches, nxt):
    """One batched decode step of the fixed server under ``torch.profiler``
    (a whole trace): B1's records equal its count, 7 x n_layers, and the
    step's library GEMMs are exactly those of the plain products the
    reference also leaves outside its kernels: n_layers x the cached
    attention (``layers.decode_attention``'s two einsums) and the f32
    unembedding (``layers.logits``), each profiled alone at the step's
    shapes.  So no projection or MLP product runs off B1.  Returns (device
    busy ms, B1 device ms, wall ms, library records)."""
    import torch

    from repro_torch.models import layers as L

    server = engine.server
    cfg = server.cfg
    b = nxt.shape[0]
    kv = caches["seg0"]["dense"]
    step = lambda: server.api.decode_step(  # noqa: E731
        server.params, cfg, caches, nxt[:, None])
    q = torch.randn((b, 1, cfg.n_heads, cfg.hd), device="cuda").to(
        cfg.param_dtype)
    x = torch.randn((b, 1, cfg.d_model), device="cuda").to(cfg.param_dtype)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("fixed decode step: non-finite logits")
        path, counted, _ = _whole_take(step, "fixed_decode",
                                       "fixed-serve decode")
        attn, _, _ = _whole_take(lambda: L.decode_attention(
            q, kv["k"][0], kv["v"][0], kv["len"][0] + 1), "fixed_attention",
            "fixed-serve attention")
        unembed, _, _ = _whole_take(lambda: L.logits(
            server.params["embedding"], cfg, x), "fixed_unembed",
            "fixed-serve unembedding")
    if counted != 7 * cfg.n_layers:
        raise AssertionError(f"fixed decode step: {counted} B1 launches "
                             f"(expected 7 x {cfg.n_layers})")
    library = collections.Counter(_library_gemm_records(path))
    plain = collections.Counter()
    for _ in range(cfg.n_layers):
        plain.update(_library_gemm_records(attn))
    plain.update(_library_gemm_records(unembed))
    if library != plain:
        raise AssertionError(f"fixed decode step: library GEMMs "
                             f"{dict(library)}, but {cfg.n_layers} cached "
                             f"attentions and the f32 unembedding alone run "
                             f"{dict(plain)}")
    busy, _, by_name = _device_time(path, marker=True)
    b1 = sum(v[0] for k, v in by_name.items() if _kernel_of(k) == "contract")
    return busy, b1, wall, dict(library)


def phase_fixed_serve(engine, serve_stats, serve_peak, smi):
    """qwen3-8b at full size through ``FixedEngine``, sharing the serve
    phase's parameters, on the serve phase's trace."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.serving import FixedEngine, synthetic_trace

    args = serve.parse_args(SERVE_ARGS)
    cfg = engine.cfg
    max_ctx = args.prompt_len + args.max_new + 1

    def trace():
        return synthetic_trace(
            args.requests, vocab=cfg.vocab, seed=args.seed,
            rate_hz=args.rate_hz,
            prompt_lens=tuple(sorted({args.prompt_len // 4,
                                      args.prompt_len // 2,
                                      args.prompt_len})),
            max_news=tuple(sorted({args.max_new // 4, args.max_new})))

    fixed = FixedEngine(cfg, lanes=args.lanes, max_ctx=max_ctx,
                        params=engine.params, device="cuda")
    served = trace()
    stats, launches, peak, took = _fixed_run(fixed, served, "fixed-serve")
    per = _b1_per_forward(cfg)
    _check_b1(launches, stats, per, "fixed-serve")
    server = fixed.server
    reqs = _as_requests(trace())
    logits, caches, _, solos = _first_logits(server, server.params, cfg,
                                             reqs, max_ctx)
    worst = max(_scaled(logits[i], solo) for i, solo in enumerate(solos))
    if not worst <= TOL["bfloat16"][0]:
        raise AssertionError(f"fixed-serve: batched and batch-1 first-token "
                             f"logits differ by {worst:.4g} of max |logit| "
                             f"(bf16 TOL {TOL['bfloat16'][0]})")
    nxt = torch.argmax(logits, dim=-1)
    firsts = [r.out_tokens[0] for r in served]
    if nxt.tolist()[:len(firsts)] != firsts:
        raise AssertionError("fixed-serve: re-run batched prefill disagrees "
                             "with the engine's first tokens")
    busy, b1_ms, wall, library = _fixed_decode_profile(fixed, caches, nxt)
    summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
    print(f"[fixed-serve] {cfg.arch_id} {cfg.n_layers} layers through "
          f"FixedEngine (lanes {args.lanes}, max_ctx {max_ctx}): "
          f"{json.dumps(summary)}", flush=True)
    print(f"[fixed-serve] prompts {[len(r.prompt) for r in served]}, "
          f"max_new {[r.max_new for r in served]}; B1 launches {launches} "
          f"= 7 x {cfg.n_layers} x ({stats['prefills']} prefill group + "
          f"{stats['decode_steps']} decode steps); batched vs batch-1 "
          f"first-token logits {worst:.4g} of max |logit|", flush=True)
    print(f"[fixed-serve] fixed: prefill {stats['prefill_s'] * 1e3:.1f} ms "
          f"(one group of {args.lanes}), decode {stats['tok_per_s']:.2f} "
          f"tok/s, max_memory_allocated {peak / 2**30:.2f} GiB; continuous "
          f"(phase serve): prefill {serve_stats['prefill_s'] * 1e3:.1f} ms "
          f"({serve_stats['prefills']} prefills), decode "
          f"{serve_stats['tok_per_s']:.2f} tok/s, max_memory_allocated "
          f"{serve_peak / 2**30:.2f} GiB; on {smi}", flush=True)
    print(f"[fixed-serve] profiled decode step (batch {args.lanes}): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, B1 {b1_ms:.3f} ms over "
          f"{7 * cfg.n_layers} launches, library GEMMs {library} (those "
          f"of {cfg.n_layers} cached attentions and the f32 unembedding)",
          flush=True)
    return dict(stats=summary, launches=launches, peak=peak, wall_s=took,
                batched_vs_solo=worst, decode_busy_ms=busy, decode_b1_ms=b1_ms,
                decode_wall_ms=wall, library=library)


def phase_families(smi):
    """mamba2-130m, zamba2-2.7b, whisper-base and internvl2-1b at full
    width and depth, bf16, seeded weights, through ``FixedEngine``: 4
    requests of one prompt length, max_new 16, lanes 4."""
    import torch

    from repro_torch.codegen import CONTRACT
    from repro_torch.configs import get_config
    from repro_torch.launch.serving import FixedEngine, synthetic_trace
    from repro_torch.models.api import N_PATCHES, get_api

    out = {}
    for arch, plen in FAMILY_PROMPTS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        api = get_api(cfg)
        with torch.inference_mode():
            params = api.init(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), "cuda")
        n_params = sum(t.numel() for t in _tensors(params))
        max_ctx = (plen + FAMILY_NEW + 1
                   + (N_PATCHES if cfg.family == "vlm" else 0))

        def trace():
            return synthetic_trace(FAMILY_LANES, vocab=cfg.vocab, seed=0,
                                   rate_hz=0.0, prompt_lens=(plen,),
                                   max_news=(FAMILY_NEW,))

        engine = FixedEngine(cfg, lanes=FAMILY_LANES, max_ctx=max_ctx,
                             params=params, device="cuda",
                             extra_batch=_extra_inputs(cfg, FAMILY_LANES, 1,
                                                       "cuda"))
        served = trace()
        stats, launches, peak, took = _fixed_run(engine, served, arch)
        per = _b1_per_forward(cfg)
        _check_b1(launches, stats, per, arch)
        server = engine.server
        reqs = _as_requests(trace())
        logits, caches, at_prefill, solos = _first_logits(
            server, server.params, cfg, reqs, max_ctx)
        nxt = torch.argmax(logits, dim=-1)
        if nxt.tolist() != [r.out_tokens[0] for r in served]:
            raise AssertionError(f"{arch}: re-run batched prefill disagrees "
                                 f"with the engine's first tokens")
        # a counted decode step after the batched prefill: the per-forward
        # counts apart
        with torch.inference_mode():
            before = CONTRACT.launches
            step, _ = server.api.decode_step(server.params, cfg, caches,
                                             nxt[:, None])
            at_decode = CONTRACT.launches - before
            if not bool(torch.isfinite(step).all()):
                raise AssertionError(f"{arch}: non-finite decode logits")
        if (at_prefill, at_decode) != per:
            raise AssertionError(f"{arch}: a prefill and a decode step "
                                 f"launched B1 {at_prefill} and {at_decode} "
                                 f"times, expected {per}")
        del caches, step
        # the same weights and inputs in f32: batched vs batch-1 there, and
        # how far bf16's own rounding moves each row
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with torch.inference_mode():
            params32 = _tree_float(params)
        logits32, _, _, solos32 = _first_logits(server, params32, cfg32,
                                                reqs, max_ctx)
        del params32
        bvs = [_scaled(logits[i], s) for i, s in enumerate(solos)]
        bvs32 = [_scaled(logits32[i], s) for i, s in enumerate(solos32)]
        rounding = [_scaled(s, s32) for s, s32 in zip(solos, solos32)]
        same = _replicated(server, server.params, cfg, reqs, logits,
                           max_ctx)
        for what, got, bound in (
                ("batched vs batch-1", bvs, TOL["bfloat16"][0]),
                ("batched vs a batch of the same prompt", same,
                 TOL["bfloat16"][0]),
                ("f32 batched vs batch-1", bvs32, F32_BATCH_TOL)):
            if not all(d <= bound for d in got):
                raise AssertionError(f"{arch}: {what} first-token logits "
                                     f"{got} of max |logit| (bound {bound})")
        summary = {k: v for k, v in stats.items() if k != "tenant_tokens"}
        extra = {k: tuple(v.shape) for k, v in engine.server.extra_batch
                 .items()}
        print(f"[families] {arch} ({cfg.family}) {cfg.n_layers} layers"
              f"{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''} "
              f"d_model {cfg.d_model} vocab {cfg.vocab} {cfg.dtype}, "
              f"{n_params / 1e9:.3f} B params; prompts {plen} x "
              f"{FAMILY_LANES}, {extra or 'no frontend input'}, max_ctx "
              f"{max_ctx}: {json.dumps(summary)}", flush=True)
        print(f"[families] {arch}: B1 {launches} launches = {per[0]} a "
              f"prefill x {stats['prefills']} + {per[1]} a decode step x "
              f"{stats['decode_steps']}; first-token logits of max "
              f"|logit|: batched vs batch-1 {_fmt(bvs)}, vs a batch of the "
              f"same prompt {_fmt(same)} (bound {TOL['bfloat16'][0]}), in "
              f"f32 {_fmt(bvs32)} (bound {F32_BATCH_TOL}); batch-1 bf16 vs "
              f"f32 {_fmt(rounding)}; first tokens "
              f"batched {nxt.tolist()}, batch-1 "
              f"{[int(s.argmax()) for s in solos]}, batch-1 f32 "
              f"{[int(s.argmax()) for s in solos32]}; prefill "
              f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
              f"{stats['tok_per_s']:.2f} tok/s, max_memory_allocated "
              f"{peak / 2**30:.2f} GiB, wall {time.perf_counter() - t0:.1f} "
              f"s; on {smi}", flush=True)
        out[arch] = dict(stats=summary, launches=launches,
                         per_forward=list(per), peak=peak, params=n_params,
                         batched_vs_solo=bvs, batched_vs_same_prompt=same,
                         batched_vs_solo_f32=bvs32,
                         bf16_rounding=rounding, wall_s=took)
        del engine, server, params, logits, logits32
        _free()
    return out


def _tree_float(tree):
    """An f32 copy of a parameter tree."""
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def _fmt(xs):
    return "[" + ", ".join(f"{x:.4g}" for x in xs) + "]"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def phase_fixed_small():
    """The f32 smoke config of each of the six families through
    ``FixedEngine`` on the card and on the CPU from the same weights and
    frontend inputs: greedy tokens equal, the first group's prefill logits
    within 1e-4 of max |ref|; weight-only int8 for dense and hybrid.
    ``REPRO_MOE_GROUPED=1`` is set, so the MoE config runs B3."""
    import torch

    from repro_torch.codegen import CONTRACT, GROUPED
    from repro_torch.configs import get_config
    from repro_torch.launch.serving import FixedEngine, synthetic_trace
    from repro_torch.models import transformer as T
    from repro_torch.models.api import N_PATCHES, get_api

    if os.environ.get("REPRO_MOE_GROUPED") != "1":
        raise AssertionError("fixed-small runs the MoE leg with "
                             "REPRO_MOE_GROUPED=1")
    legs = [(arch, None) for arch in FIXED_SMALL] + [
        ("qwen3-8b", "int8"), ("zamba2-2.7b", "int8")]
    rows = []
    for arch, quant in legs:
        cfg = get_config(arch).smoke()
        cpu_params = get_api(cfg).init(cfg, torch.Generator().manual_seed(3),
                                       "cpu")
        extra = _extra_inputs(cfg, 2, 4, "cpu", frames=12,
                              dtype=torch.float32)
        max_ctx = 9 + 5 + 1 + (N_PATCHES if cfg.family == "vlm" else 0)
        outs, firsts, counts = {}, {}, {}
        for device in ("cpu", "cuda"):
            params = (cpu_params if device == "cpu" else
                      T._tree_map(lambda t: t.to(device), cpu_params))
            trace = synthetic_trace(5, vocab=cfg.vocab, seed=5, rate_hz=0.0,
                                    prompt_lens=(4, 6, 9), max_news=(2, 5))
            engine = FixedEngine(cfg, lanes=2, max_ctx=max_ctx, quant=quant,
                                 params=params, device=device,
                                 extra_batch={k: v.to(device)
                                              for k, v in extra.items()})
            before = (CONTRACT.launches, GROUPED.launches)
            engine.run(trace)
            counts[device] = (CONTRACT.launches - before[0],
                              GROUPED.launches - before[1])
            outs[device] = [list(r.out_tokens) for r in trace]
            with torch.inference_mode():
                toks, lengths = engine.server._pack(_as_requests(trace[:2]))
                logits, _ = engine.server._prefill(toks, lengths)
            firsts[device] = logits.float().cpu()
        tag = f"{arch}{' --quant int8' if quant else ''}"
        if outs["cpu"] != outs["cuda"]:
            raise AssertionError(f"fixed-small {tag}: greedy tokens differ, "
                                 f"card {outs['cuda']} vs CPU {outs['cpu']}")
        worst = ((firsts["cuda"] - firsts["cpu"]).abs().max().item()
                 / firsts["cpu"].abs().max().item())
        if not worst <= 1e-4:
            raise AssertionError(f"fixed-small {tag}: card and CPU prefill "
                                 f"logits differ by {worst:.3g} (scaled)")
        per = _b1_per_forward(cfg)
        if counts["cpu"] != (0, 0) or (per[0] and not counts["cuda"][0]):
            raise AssertionError(f"fixed-small {tag}: kernel launches "
                                 f"{counts} (B1, B3) by device")
        if cfg.family == "moe" and not counts["cuda"][1]:
            raise AssertionError(f"fixed-small {tag}: B3 did not launch")
        print(f"[fixed-small] {tag} ({cfg.family}, f32): card vs CPU prefill "
              f"logits {worst:.3g} scaled, greedy tokens equal "
              f"{outs['cuda']}; card launches B1 {counts['cuda'][0]}, B3 "
              f"{counts['cuda'][1]}", flush=True)
        rows.append(dict(arch=arch, quant=quant, scaled_diff=worst,
                         launches=counts["cuda"]))
    return rows


def attention_entry(small, path):
    """The ``kernels`` entry of B2: the sums over the attn-path's four timed
    forwards (a, b, d, e), its launches over that path's run (a-e), the
    worst error over every B2 case of attn-small and attn-path."""
    rows = path["rows"]
    total = lambda key: sum(r[key] for r in rows)  # noqa: E731
    return {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/codegen/csrc/attention.cu",
        "replaces": "src/repro/codegen/fused_gen.py:140",
        "launches": path["launches"]["attention"],
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [w[0] for w in small["worst"].values()]),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "library_ms": total("library_ms"),
        "body": _bodies(rows),
    }


def new_kernel_entries(quant, quant_path, chain):
    """The ``kernels`` entries of this slice's modes.  int8 / fp8: the raw
    kernel at the quant path's two MLP shapes (up + down), launches of the
    quant path's run; beside them ``weighted_family``, the format's four
    weighted specs through ``codegen.compile`` summed (no one library call
    computes them; fp8's forward runs ``contract``), launches of b1-quant's
    counted compile pass.  upcast: its two remaining calls
    (``_upcast_cases``), launches of their counted pass.  chain:
    ``chain_matmul`` and its three derived specs at CHAIN_SHAPE in bf16,
    launches of the chain path's bf16 run, library
    ``torch.linalg.multi_dot``.  ``max_abs_err`` is the worst over every
    case of the mode."""

    def entry(name, source, parts, errs, launches):
        total = lambda key: sum(r[key] for r in parts)  # noqa: E731
        libs = [r["library_ms"] for r in parts]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "src/repro/codegen/pallas_gen.py:263",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                         else "bytes"),
            "library_ms": None if None in libs else sum(libs),
            "body": _bodies(parts),
        }

    q8 = "src/repro_torch/codegen/csrc/contract_q8.cu"
    out = []
    for fmt in ("int8", "fp8"):
        rows = [r for r in quant["rows"] if r["dtype"] == fmt]
        family = [r for r in quant["compiled"]
                  if r["mode"] == "family" and r["dtype"] == fmt]
        mine = [r for r in family if r["kernel"] == f"contract_{fmt}"]
        total = lambda key: sum(r[key] for r in family)  # noqa: E731
        out.append(dict(
            entry(f"contract_{fmt}", q8,
                  [r for r in rows if r["shape"].startswith("mlp")],
                  rows + mine, quant_path["launches"][f"contract_{fmt}"]),
            weighted_family={
                "launches": {k: sum(r["kernel"] == k for r in family)
                             for k in sorted({r["kernel"] for r in family})},
                "body": _bodies(family),
                "max_abs_err": max(r["max_abs_err"] for r in family),
                "scaled_err": max(r["scaled_err"] for r in family),
                **{key: total(key) for key in (
                    "ms", "device_ms", "other_device_ms", "plain_ms",
                    "bound_ms")}}))
    up = quant["upcast"]
    out.append(entry("contract_upcast", q8, up, up,
                     quant["upcast_launches"]["contract_upcast"]))
    bf16 = [r for r in chain["rows"] if r["dtype"] == "bfloat16"]
    qchain = [r for r in quant["compiled"] if r["mode"] == "chain"]
    out.append(entry("contract_chain",
                     "src/repro_torch/codegen/csrc/contract_chain.cu", bf16,
                     chain["rows"] + qchain,
                     chain["paths"]["bfloat16"]["launches"]
                     ["contract_chain"]))
    return out


def _bodies(rows):
    """The bodies that ran ``rows`` (each row's ``body`` without its
    tile), in order of first appearance, joined by "/"."""
    out = []
    for r in rows:
        body = (r.get("body") or "").split(" ")[0]
        if body and body not in out:
            out.append(body)
    return "/".join(out) or None


def kernels_line(k_rows, b1_rows, g_rows, dw_rows, base_rows, launches,
                 mode_rows):
    """One entry per kernel of the paths, each summed over one layer of one
    training step at the path's shapes (the remat recompute aside): B1 the
    7 forward GEMMs and their 14 derived backward GEMMs of a qwen3-8b
    layer at M = 2048; B3 the gate, up and down forward products and
    their 3 dX of a kimi-k2 MoE layer at 32 experts of C = 320; B4 the 3
    dW of that layer.  B5, B6, B7 (``matmul``, ``fused_dense_act``,
    ``fused_rnz``): one call at the fused path's shape (M = 2048, K = 4096,
    N = 12288, bf16), with the ``body`` that ran it.  ``launches`` are
    those of the dense training run
    (B1), of the MoE training run (B3, B4) and of the fused path's run
    (B5-B7).  Each number is measured above; ``max_abs_err`` is the worst
    over every case of the kernel.  ``body`` names the body that ran the
    entry's rows (B3: its M tile at the training shapes), and B1's
    ``bodies`` every body its measured rows ran (``mode_rows``: b1-modes,
    the f32 rows on tc32)."""
    from repro_torch.codegen.fused_gen import grouped_tile_m
    mult = {"gate/up": 2, "down": 1}
    b1 = [(r, LAYER_GEMMS[(r["K"], r["N"])]) for r in b1_rows]
    b3 = [(r, mult[r["case"].split()[-1]]) for r in g_rows
          if r["case"].startswith("train")]
    b4 = [(r, mult[r["case"].split()[-1]]) for r in dw_rows
          if r["case"].startswith("train")]

    def entry(name, source, replaces, parts, errs):
        total = lambda key: sum(r[key] * c for r, c in parts)  # noqa: E731
        ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total("library_ms"),
        }

    def base_entry(name, replaces):
        # the fused path's shape (bf16); the error over every case
        main = [r for r in base_rows if r["kernel"] == name and r["main"]]
        return dict(entry(name, "src/repro_torch/codegen/csrc/baselines.cu",
                          replaces, [(r, 1) for r in main],
                          [r for r in base_rows if r["kernel"] == name]),
                    body=main[0]["body"])

    train_tile = grouped_tile_m((MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS)
    return {"kernels": [
        dict(entry("contract", "src/repro_torch/codegen/csrc/contract.cu",
                   "src/repro/codegen/pallas_gen.py:263", b1,
                   b1_rows + k_rows),
             body=_bodies(r for r, _ in b1),
             bodies=_bodies(list(b1_rows) + list(k_rows) + list(mode_rows))),
        dict(entry("grouped", "src/repro_torch/codegen/csrc/grouped.cu",
                   "src/repro/codegen/fused_gen.py:243", b3, g_rows),
             body=f"{train_tile}-row tile"),
        dict(entry("grouped_dw", "src/repro_torch/codegen/csrc/grouped_dw.cu",
                   "src/repro/codegen/fused_gen.py:309", b4, dw_rows),
             body=_bodies(r for r, _ in b4)),
    ] + [base_entry(name, replaces) for name, replaces in (
        ("matmul", "src/repro/kernels/matmul/matmul.py:67"),
        ("fused_dense_act",
         "src/repro/kernels/fused_dense_act/fused_dense_act.py:75"),
        ("fused_rnz", "src/repro/kernels/fused_rnz/fused_rnz.py:59"),
    )]}


#: the remat phase: B1 launches of one qwen3-8b layer's loss + gradients
#: (7 forward, 14 backward, and 7 recomputed where nothing is saved) and
#: B3 / B4 launches of one kimi-k2 MoE layer (3 forward, 3 dX, 3 recomputed
#: where nothing is saved; 3 dW), by ``REPRO_REMAT_POLICY``
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")
B1_PER_LAYER_REMAT = {"nothing": 28, "dots": 21, "dots_no_batch": 21}
B3_PER_MOE_REMAT = {"nothing": 9, "dots": 6}
CAUSAL_SKIP_S = 4096
#: timed loss + gradients a policy (the median is reported)
REMAT_REPS = 3
#: the production cells the remat phase dry-runs on fake CUDA tensors, at
#: full width and shape cut in depth to ``DRYRUN_LAYERS`` (kimi-k2: one
#: dense and three MoE layers): a cell's trace time grows with its layers
#: (about a minute for kimi-k2's 61), and the run's time limit holds the
#: mesh phase too
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
                ("qwen3-8b", "decode_32k"), (MOE_ARCH, "train_4k"))
DRYRUN_LAYERS = 4
#: the ladder phase ``search`` wrote whose card rows explain renders
EXPLAIN_SELECTOR = "matmul@512x4096x1024"


def _scaled_err(got, want):
    scale = float(want.detach().float().abs().max()) or 1.0
    return float((got.detach().float() - want.detach().float()).abs().max()
                 ) / scale


def _loss_grads(cfg, params, batch):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import get_api

    api = get_api(cfg)
    return value_and_grad(lambda p, b: api.loss(p, cfg, b), params, batch)


def _seeded_batch(cfg, batch, seq, device):
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, batch_at

    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch_at(data, 0).items()}


def _attention_bmm_ms(prof):
    """Device ms of ``aten::bmm`` (the attention's einsums; the
    projections are B1 and the unembedding an ``aten::mm``)."""
    for evt in prof.key_averages():
        if evt.key == "aten::bmm":
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            return us / 1e3
    return float("nan")


def phase_remat_dryrun(smi):
    """The remat policies, causal skip, the one-card dry-run and plan
    explain (queue A item 6d).

    (a) qwen3-8b at full width cut to ``TRAIN_LAYERS`` layers, 4 x 512
    tokens, bf16, seeded: one loss + gradients (``steps.value_and_grad``)
    under each ``REPRO_REMAT_POLICY``, after one warm-up under a
    ``FlopCounterMode`` (the flops the launches imply), ``REMAT_REPS``
    times: B1 launches ``B1_PER_LAYER_REMAT`` a layer in each (hard), the
    median wall ms, peak memory, the loss
    and every gradient against ``nothing`` at the bf16 TOL (hard; bit for
    bit printed); beside each, the dry-run of the same function on fake
    CUDA tensors (``roofline.op_count``): dot flops, peak and saved bytes.
    (b) kimi-k2 cut as phase ``moe-train`` (2 layers, 32 experts, 2 x 512)
    under ``nothing`` and ``dots``: B3 ``B3_PER_MOE_REMAT`` and B4 3 a MoE
    layer (hard).  (c) (a)'s model forward at 1 x ``CAUSAL_SKIP_S``
    without and with ``REPRO_CAUSAL_SKIP``: logits within the bf16 TOL
    (hard), wall ms and the profiler's device ms in ``aten::bmm``.  (d)
    ``launch.dryrun.run_cell`` on ``DRYRUN_CELLS`` at production width and
    shape cut to ``DRYRUN_LAYERS`` layers on fake CUDA tensors: status
    ``ok`` (hard), trace seconds, dot TFLOP,
    peak GiB and the analytic H100 roofline terms; ``launch.perf``'s
    ``remat_dots`` against the first as baseline.  (e) ``obs.explain`` of
    ``EXPLAIN_SELECTOR`` in phase ``search``'s plan DB: the text names
    each card rung's measured ms (hard)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.codegen import CONTRACT, GROUPED, GROUPED_DW
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, perf
    from repro_torch.launch.steps import eval_params
    from repro_torch.models.api import get_api
    from repro_torch.obs import explain as explain_mod
    from repro_torch.optim.adamw import at_path, leaves
    from repro_torch.roofline.analysis import analyze_cell, param_counts
    from repro_torch.roofline.op_count import count_step

    out = {"policies": {}, "moe": {}, "causal_skip": {}, "dryrun": {}}
    old_policy = os.environ.get("REPRO_REMAT_POLICY")
    tol = TOL["bfloat16"]
    # (a) the remat policies on the dense model
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=TRAIN_LAYERS)
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    batch = _seeded_batch(cfg, 4, 512, "cuda")
    base = None
    try:
        for pol in REMAT_POLICIES:
            os.environ["REPRO_REMAT_POLICY"] = pol
            fc = FlopCounterMode(display=False)
            with fc:
                _loss_grads(cfg, params, batch)
            implied = fc.get_total_flops()
            walls = []
            for rep in range(REMAT_REPS):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_launch_counts()
                t0 = time.perf_counter()
                loss, grads = _loss_grads(cfg, params, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if rep < REMAT_REPS - 1:
                    del loss, grads
            ms = sorted(walls)[len(walls) // 2]
            launches = CONTRACT.launches
            peak = torch.cuda.max_memory_allocated()
            want = B1_PER_LAYER_REMAT[pol] * cfg.n_layers
            if launches != want:
                raise AssertionError(f"remat {pol}: {launches} B1 launches, "
                                     f"expected {want} ("
                                     f"{B1_PER_LAYER_REMAT[pol]} x "
                                     f"{cfg.n_layers} layers)")
            with FakeTensorMode():
                fparams = eval_params(cfg, api, "cuda")
                fbatch = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device="cuda")
                          for k, v in batch.items()}
                dry = count_step(lambda p, b: _loss_grads(cfg, p, b),
                                 fparams, fbatch)
            row = dict(launches=launches, ms=ms, walls_ms=walls,
                       peak_bytes=peak,
                       loss=float(loss), implied_flops=implied,
                       dry_flops=dry["dot_flops"],
                       dry_peak_bytes=dry["peak_live_bytes"],
                       dry_saved_bytes=dry["saved_bytes"])
            if base is None:
                base = (loss, grads)
            else:
                errs = [_scaled_err(loss, base[0])] + [
                    _scaled_err(g, at_path(base[1], path))
                    for path, g in leaves(grads)]
                equal = torch.equal(loss, base[0]) and all(
                    torch.equal(g, at_path(base[1], path))
                    for path, g in leaves(grads))
                row.update(max_scaled_err=max(errs), bitwise=equal)
                if max(errs) > tol[0]:
                    raise AssertionError(
                        f"remat {pol}: loss / gradients {max(errs):.3g} of "
                        f"max |nothing| from nothing's (bf16 TOL {tol[0]})")
                del grads
            out["policies"][pol] = row
            print(f"[remat-dryrun] {pol}: B1 {launches} = {want}; loss + "
                  f"grads {ms:.1f} ms (median of "
                  f"{[round(w, 1) for w in walls]}), peak "
                  f"{peak / 2**30:.2f} GiB; "
                  + (f"vs nothing {row['max_scaled_err']:.3g} scaled, "
                     f"bit for bit {row['bitwise']}; " if pol != "nothing"
                     else "")
                  + f"flops by the launches {implied / 1e12:.3f} T; "
                  f"dry-run {dry['dot_flops'] / 1e12:.3f} T, peak "
                  f"{dry['peak_live_bytes'] / 2**30:.2f} GiB, saved "
                  f"{dry['saved_bytes'] / 2**30:.2f} GiB ({smi})",
                  flush=True)
        del base
        os.environ["REPRO_REMAT_POLICY"] = "nothing"
        # (c) causal skip on the same model, one 4096-token forward
        tokens = _seeded_batch(cfg, 1, CAUSAL_SKIP_S, "cuda")["tokens"]
        logits = {}
        for skip in ("0", "1"):
            os.environ["REPRO_CAUSAL_SKIP"] = skip
            with torch.no_grad():
                api.forward(params, cfg, {"tokens": tokens})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[skip] = api.forward(params, cfg, {"tokens": tokens})
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    api.forward(params, cfg, {"tokens": tokens})
                    torch.cuda.synchronize()
            out["causal_skip"][skip] = dict(ms=ms,
                                            bmm_ms=_attention_bmm_ms(prof))
            print(f"[remat-dryrun] causal skip {skip}: forward 1 x "
                  f"{CAUSAL_SKIP_S} {ms:.1f} ms, attention einsums "
                  f"{out['causal_skip'][skip]['bmm_ms']:.3f} ms device",
                  flush=True)
        os.environ.pop("REPRO_CAUSAL_SKIP", None)
        err = _scaled_err(logits["1"], logits["0"])
        out["causal_skip"]["max_scaled_err"] = err
        out["causal_skip"]["bitwise"] = torch.equal(logits["1"],
                                                    logits["0"])
        print(f"[remat-dryrun] causal skip logits vs unskipped: {err:.3g} "
              f"scaled, bit for bit {out['causal_skip']['bitwise']}",
              flush=True)
        if err > tol[0]:
            raise AssertionError(f"causal skip: logits {err:.3g} of max "
                                 f"|logit| from the unskipped forward's")
        del params, logits, batch
        _free()
        # (b) the MoE cut under nothing and dots
        mcfg = get_config(MOE_ARCH)
        mcfg = dataclasses.replace(
            mcfg, n_layers=MOE_LAYERS,
            moe=dataclasses.replace(mcfg.moe, n_experts=MOE_TRAIN_EXPERTS))
        mapi = get_api(mcfg)
        mparams = mapi.init(mcfg, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        mbatch = _seeded_batch(mcfg, 2, 512, "cuda")
        n_moe = _moe_layers(mcfg)
        for pol, b3 in B3_PER_MOE_REMAT.items():
            os.environ["REPRO_REMAT_POLICY"] = pol
            _zero_launch_counts()
            _loss_grads(mcfg, mparams, mbatch)
            torch.cuda.synchronize()
            got = (GROUPED.launches, GROUPED_DW.launches)
            out["moe"][pol] = dict(grouped=got[0], grouped_dw=got[1])
            print(f"[remat-dryrun] {MOE_ARCH} cut, {pol}: B3 {got[0]}, B4 "
                  f"{got[1]} over {n_moe} MoE layer(s)", flush=True)
            if got != (b3 * n_moe, B4_PER_MOE_STEP * n_moe):
                raise AssertionError(f"remat {pol}: B3 / B4 launches {got}, "
                                     f"expected ({b3 * n_moe}, "
                                     f"{B4_PER_MOE_STEP * n_moe})")
        del mparams, mbatch
        _free()
    finally:
        if old_policy is None:
            os.environ.pop("REPRO_REMAT_POLICY", None)
        else:
            os.environ["REPRO_REMAT_POLICY"] = old_policy
        os.environ.pop("REPRO_CAUSAL_SKIP", None)
    # (d) the dry-run at production width and shape, cut in depth
    res = os.path.join(OUT, "dryrun")
    os.makedirs(res, exist_ok=True)
    cuts = {arch: dataclasses.replace(get_config(arch),
                                      n_layers=DRYRUN_LAYERS)
            for arch, _ in DRYRUN_CELLS}
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, device="cuda", cfg=cuts[arch])
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run {arch} {shape}: {rec}")
        with open(os.path.join(res, f"{arch}__{shape}__1.json"), "w") as f:
            json.dump(rec, f, indent=1)
        row = analyze_cell(rec, param_counts(arch, cuts[arch]))
        out["dryrun"][f"{arch}/{shape}"] = {
            k: row[k] for k in ("lower_s", "flops", "bytes_accessed",
                                "memory", "compute_s", "memory_s",
                                "memory_fused_s", "dominant",
                                "useful_ratio")}
        print(f"[remat-dryrun] dry-run {arch} {shape} ({DRYRUN_LAYERS} of "
              f"{get_config(arch).n_layers} layers): ok, traced in "
              f"{rec['lower_s']} s, dot {rec['flops'] / 1e12:.2f} TFLOP, "
              f"peak {rec['memory']['peak_memory_in_bytes'] / 2**30:.1f} "
              f"GiB, saved {rec['memory']['saved_bytes'] / 2**30:.1f} GiB; "
              f"analytic H100 compute {row['compute_s'] * 1e3:.1f} ms, "
              f"memory {row['memory_s'] * 1e3:.1f} ms (products alone "
              f"{row['memory_fused_s'] * 1e3:.1f}), {row['dominant']}, "
              f"MODEL/counted flops {row['useful_ratio']:.2f}", flush=True)
    arch, shape = DRYRUN_CELLS[0]
    knob = perf.run(arch, shape, ["remat_dots"], device="cuda",
                    out=os.path.join(OUT, "perf"), baseline_dir=res,
                    cfg=cuts[arch])
    out["perf_remat_dots"] = knob.get("vs_baseline")
    # (e) plan-explain of a ladder the search measured on the card
    text = explain_mod.explain(os.path.join(OUT, "plans_search.json"),
                               EXPLAIN_SELECTOR)
    print(text, flush=True)
    with open(os.path.join(OUT, "plans_search.json")) as f:
        entries = explain_mod.match_entries(json.load(f), EXPLAIN_SELECTOR)
    measured = [f"{r['measured_s'] * 1e3:.4f}" for _, e in entries
                for r in e["ranked"] if r.get("card")
                and r.get("measured_s") is not None]
    if not measured or not all(ms in text for ms in measured):
        raise AssertionError(f"explain {EXPLAIN_SELECTOR}: the card's "
                             f"measured ms {measured} not in its text")
    out["explain_card_ms"] = measured
    return out


#: phase capture's training cut: phase 10's flags for 3 steps
CAPTURE_TRAIN_STEPS = 3
#: the card-vs-CPU tolerance of the captured trio's loss and gradients
#: (f32, scaled by max |CPU|; B1's and B2's 3xTF32 against f32 sums)
CAPTURE_TOL = 2e-4


def _capture_launches(cfg):
    """The launches of one captured loss + gradients of a demo config,
    from its layers (every layer checkpointed under ``nothing``): a dense
    site runs B1 forward, again in the recompute and twice backward (.dA,
    .dB), 4; the unembedding, outside the layers, 3; the attention motif
    B2 forward and in the recompute, and its three backward products on
    B1; a grouped site B3 forward, recomputed and its dX, and B4 its dW.
    On the card the MoE router (128 x 128 x 4) launches too; the SSM's
    scan products stay plain (no layout the kernels take)."""
    want = {"contract": 3, "attention": 0, "grouped": 0, "grouped_dw": 0}
    m = cfg.moe
    for layer in range(cfg.n_layers):
        if cfg.family == "ssm":
            want["contract"] += 2 * 4  # in_proj, out_proj
            continue
        want["contract"] += 4 * 4 + 3  # q, k, v, o; the motif's backward
        want["attention"] += 2
        if m is not None and layer >= m.first_dense:
            want["contract"] += 4  # the router
            want["grouped"] += 3 * 3
            want["grouped_dw"] += 3
        else:
            want["contract"] += 3 * 4  # gate, up, down
    return want


def _counts_all():
    from repro_torch.codegen import ATTENTION

    return {**_launch_counts(), "attention": ATTENTION.launches}


def _zero_counts_all():
    from repro_torch.codegen import ATTENTION

    _zero_launch_counts()
    ATTENTION.launches = 0


def phase_capture(smi, train_summary):
    """Whole-model capture on the card: (a) the trio card vs CPU, (b)
    qwen3-8b ``serve --capture`` at full width and depth, (c) qwen3-8b
    ``train --capture`` on phase 10's cut.  See the module docstring."""
    out = {"trio": {}}
    # (a) the conformance trio, card vs CPU, on the reference's MoE path:
    # batched einsums the grouped taint sends to B3 (REPRO_MOE_GROUPED,
    # which phase small-moe set, would make the CPU's experts a loop of
    # plain products and the card's B3 launches, two reports)
    grouped_env = os.environ.pop("REPRO_MOE_GROUPED", None)
    try:
        _capture_trio(out, smi)
    finally:
        if grouped_env is not None:
            os.environ["REPRO_MOE_GROUPED"] = grouped_env
    _free()
    _capture_serve_train(out, smi, train_summary)
    return out


def _capture_trio(out, smi):
    """Phase capture (a): the conformance trio card vs CPU."""
    import torch

    from repro_torch import capture
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import get_api
    from repro_torch.optim.adamw import leaves, tree_map

    for name, cfg in sorted(capture.demo_configs().items()):
        api = get_api(cfg)
        params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab, (capture.DEMO_BATCH,
                                            capture.DEMO_SEQ),
                             generator=torch.Generator().manual_seed(7),
                             dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        gparams = tree_map(lambda t: t.to("cuda"), params)
        gbatch = {k: v.to("cuda") for k, v in batch.items()}

        def loss(p, b, api=api, cfg=cfg):
            return api.loss(p, cfg, b)

        cpu = capture.optimize(loss, interpret=True, label=f"{name}:cpu")
        card = capture.optimize(loss, label=f"{name}:card")
        rep_cpu = cpu.report_for(params, batch)
        rep_card = card.report_for(gparams, gbatch)
        sig = lambda r: [(s.op, s.spec and s.spec.name,  # noqa: E731
                          s.spec and dict(s.spec.extents)) for s in r.sites]
        if sig(rep_card) != sig(rep_cpu):
            raise AssertionError(f"capture {name}: the card's sites "
                                 f"{sig(rep_card)} differ from the CPU's "
                                 f"{sig(rep_cpu)}")
        value_and_grad(card, gparams, gbatch)  # builds, first launches
        torch.cuda.synchronize()
        _zero_counts_all()
        l_card, g_card = value_and_grad(card, gparams, gbatch)
        torch.cuda.synchronize()
        got = _counts_all()
        l_cpu, g_cpu = value_and_grad(cpu, params, batch)
        errs = [_scaled_err(l_card.cpu(), l_cpu)] + [
            _scaled_err(a.cpu(), b)
            for (_, a), (_, b) in zip(leaves(g_card), leaves(g_cpu))]
        want = _capture_launches(cfg)
        out["trio"][name] = dict(cpu=rep_cpu.summary(),
                                 card=rep_card.summary(), launches=got,
                                 max_scaled_err=max(errs))
        print(f"[capture] {name}: {rep_card.summary()} (CPU "
              f"{rep_cpu.dispatched} dispatched); loss + grads card vs CPU "
              f"{max(errs):.3g} scaled; launches {got}", flush=True)
        if max(errs) > CAPTURE_TOL:
            raise AssertionError(f"capture {name}: loss / gradients "
                                 f"{max(errs):.3g} of max |CPU| from the "
                                 f"CPU's (tol {CAPTURE_TOL})")
        if got != want:
            raise AssertionError(f"capture {name}: launches {got}, "
                                 f"expected {want}")


def _capture_serve_train(out, smi, train_summary):
    """Phase capture (b) and (c): qwen3-8b served and trained through
    captured steps."""
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serving import Gateway, ServeRequest
    from repro_torch.models.api import get_api

    # (b) qwen3-8b serve --capture at full width and depth, beside the
    # uncaptured engine on the same seeded weights; each engine serves
    # phase 13's trace, then the same trace again (warm: every step
    # signature traced, every kernel looked up)
    def again(trace):
        return [ServeRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                             arrival_s=r.arrival_s, tenant=r.tenant)
                for r in trace]

    plain_stats, trace, engine = serve.main(SERVE_ARGS)
    plain_warm = Gateway(engine).run(again(trace))
    del engine, trace
    _free()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts_all()
    t0 = time.perf_counter()
    with _FusedTally() as tally:
        stats, trace, engine = serve.main(SERVE_ARGS + ["--capture",
                                                        "--no-search-grads"])
    took = time.perf_counter() - t0
    cfg = engine.cfg
    for r in trace:
        if len(r.out_tokens) != r.max_new or r.state != "finished":
            raise AssertionError(f"capture serve: request {r.rid} ended "
                                 f"with {len(r.out_tokens)}/{r.max_new}")
        if not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"capture serve: request {r.rid}: token "
                                 f"outside the vocab")
    forwards = stats["prefills"] + stats["decode_steps"]
    want_b1 = (7 * cfg.n_layers + 1) * forwards
    want_b2 = cfg.n_layers * stats["prefills"]
    got_b1, got_b2 = stats["kernel_launches"], stats["attention_launches"]
    peak = torch.cuda.max_memory_allocated()
    cs = engine.capture_stats
    for kind, rep in cs["reports"].items():
        print(f"[capture] serve harvest {kind}: {rep.summary()}",
              flush=True)
    swept, served = tally.split("attention", got_b2)
    print(f"[capture] serve sweep: {cs['points']} plan point(s) of "
          f"{cs['specs']} spec(s) in {cs['sweep_s']:.1f} s; B2 launches by "
          f"plan: the sweep's {tally.text(swept)}; the serving's "
          f"{tally.text(served)}", flush=True)
    for label, fn in (("prefill", engine.prefill.step),
                      ("decode", engine.decode.step)):
        for rep in fn.reports:
            print(f"[capture] serve {label} trace: {rep.summary()}",
                  flush=True)
    # each request's first-token logits, captured vs the uncaptured path
    api = get_api(cfg)
    errs = []
    with torch.inference_mode():
        for r in trace:
            toks = torch.as_tensor(r.prompt, dtype=torch.long,
                                   device="cuda")[None]
            n = toks.shape[1]
            lengths = torch.full((1,), n, dtype=torch.long, device="cuda")
            got, _ = engine.prefill.step(engine.params, {"tokens": toks}, n)
            ref, _ = api.prefill(engine.params, cfg,
                                 {"tokens": toks, "lengths": lengths}, n)
            errs.append(_scaled_err(got[0, -1], ref[0, -1]))
            del got, ref
    out["serve"] = dict(
        stats={k: v for k, v in stats.items() if k != "tenant_tokens"},
        b1=got_b1, b2=got_b2, peak_bytes=peak, wall_s=took,
        sweep_points=cs["points"], sweep_s=cs["sweep_s"],
        b2_plans=dict(sweep={_plan_text(p): c for (_, _, p), c in
                             swept.items()},
                      served={_plan_text(p): c for (_, _, p), c in
                              served.items()}),
        first_logits_err=errs)
    print(f"[capture] serve {cfg.arch_id} --capture: B1 {got_b1} (want "
          f"{want_b1} = (7 x {cfg.n_layers} + 1) x {forwards} forwards), "
          f"B2 {got_b2} (want {want_b2} = {cfg.n_layers} x "
          f"{stats['prefills']} prefills); prefill "
          f"{stats['prefill_s'] * 1e3:.1f} ms with its traces (uncaptured "
          f"{plain_stats['prefill_s'] * 1e3:.1f}), decode "
          f"{stats['tok_per_s']:.2f} tok/s with its trace (uncaptured "
          f"{plain_stats['tok_per_s']:.2f}); first-token logits vs "
          f"uncaptured {[round(e, 4) for e in errs]} of max |logit|; "
          f"peak {peak / 2**30:.2f} GiB; wall {took:.1f} s ({smi})",
          flush=True)
    if (got_b1, got_b2) != (want_b1, want_b2):
        raise AssertionError(f"capture serve: B1 {got_b1}, B2 {got_b2}; "
                             f"expected {want_b1}, {want_b2}")
    if max(errs) > TOL["bfloat16"][0]:
        raise AssertionError(f"capture serve: first-token logits "
                             f"{max(errs):.3g} of max |logit| from the "
                             f"uncaptured prefill's")
    _zero_counts_all()
    warm = Gateway(engine).run(again(trace))
    keep = lambda st: {k: v for k, v in st.items()  # noqa: E731
                       if k != "tenant_tokens"}
    out["serve"].update(warm=keep(warm), uncaptured=keep(plain_stats),
                        uncaptured_warm=keep(plain_warm))
    print(f"[capture] serve again (warm: traces cached): prefill "
          f"{warm['prefill_s'] * 1e3:.1f} ms, decode "
          f"{warm['tok_per_s']:.2f} tok/s, B1 {_counts_all()['contract']}, "
          f"B2 {_counts_all()['attention']}; uncaptured again: prefill "
          f"{plain_warm['prefill_s'] * 1e3:.1f} ms, decode "
          f"{plain_warm['tok_per_s']:.2f} tok/s ({smi})", flush=True)
    del engine, trace
    _free()

    # the f32 unembedding on B1, alone: train M = 2048, decode M = 4; its
    # forward and the two derived specs of its backward, each one launch on
    # the tc32 body (the narrow x tile at decode's forward and .dA,
    # matmul.dB's x^T transposed as it is split) and no other device work,
    # within the f32 TOL of its plain version
    from repro_torch.codegen.cuda_gen import contract_ref, tc32_width
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.grad import COTANGENT, derived_specs
    from repro_torch.grad.vjp import apply_spec

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(cfg.d_model, cfg.vocab, device=dev, generator=gen)
    out["unembed"] = {}
    for m in (TRAIN_M, 4):
        x = torch.randn(m, cfg.d_model, device=dev, generator=gen)
        g = torch.randn(m, cfg.vocab, device=dev, generator=gen)
        dsp_fwd = matmul_spec(m, cfg.d_model, cfg.vocab)
        dsp = derived_specs(dsp_fwd)
        calls = {
            "fwd": lambda: ops.dense(x, w, differentiable=False),
            ".dA": lambda: apply_spec(dsp["A"], {COTANGENT: g, "B": w},
                                      out_dtype=torch.float32,
                                      use_kernel=True),
            ".dB": lambda: apply_spec(dsp["B"], {COTANGENT: g, "A": x},
                                      out_dtype=torch.float32,
                                      use_kernel=True),
        }
        libs = {"fwd": lambda: torch.matmul(x, w),
                ".dA": lambda: torch.matmul(g, w.t()),
                ".dB": lambda: torch.matmul(x.t(), g)}
        plains = {"fwd": lambda: contract_ref(dsp_fwd, x, w,
                                              out_dtype=torch.float32),
                  ".dA": lambda: apply_spec(dsp["A"], {COTANGENT: g, "B": w},
                                            out_dtype=torch.float32),
                  ".dB": lambda: apply_spec(dsp["B"], {COTANGENT: g, "A": x},
                                            out_dtype=torch.float32)}
        bound = _bound(2 * m * cfg.d_model * cfg.vocab,
                       4 * (m * cfg.d_model + cfg.d_model * cfg.vocab
                            + m * cfg.vocab), "float32",
                       peak=PEAK_3XTF32)[0]
        specs = {"fwd": dsp_fwd, ".dA": dsp["A"], ".dB": dsp["B"]}
        rows = {}
        launcher = _launcher("contract")
        with torch.no_grad():
            for what, fn in calls.items():
                tag = f"capture unembedding M = {m} {what}"
                got = fn()
                body = _body(launcher)
                width = launcher.last_plan and launcher.last_plan.tile_n
                # the plan a ladder stored for this spec (serve --capture's
                # warm-up sweep measures the decode unembedding's forward),
                # which ops launches in place of the heuristic's
                searched = _searched_card(specs[what], torch.float32)
                # else the product's M: the tokens, or D for matmul.dB's
                # x^T (m-contiguous: the 128-wide tile)
                want_width = (tc32_width(m, narrow_x=True) if what != ".dB"
                              else tc32_width(cfg.d_model))
                if searched is not None:
                    if (launcher.last_body != "tc32"
                            or launcher.last_card != searched):
                        raise AssertionError(
                            f"{tag}: body {body} on {launcher.last_card}, "
                            f"expected the plan DB's tc32 plan {searched}")
                elif launcher.last_body != "tc32" or width != want_width:
                    raise AssertionError(f"{tag}: body {body}, expected tc32 "
                                         f"with an x tile {want_width} wide")
                err = _check_close(got, plains[what](), "float32", tag)
                del got
                _alone(fn, "contract", 1, tag)
                ms = _kernel_ms(fn, flush, "contract")[0]
                rows[what] = dict(device_ms=ms, body=body,
                                  plan="searched" if searched else
                                  "heuristic",
                                  max_abs_err=err[0], scaled_err=err[1],
                                  library_ms=_timed(libs[what], flush,
                                                    reps=3, warmup=1),
                                  plain_ms=_timed(plains[what], flush,
                                                  **PLAIN_REPS),
                                  bound_ms=bound)
                torch.cuda.empty_cache()
        out["unembed"][m] = rows
        print(f"[capture] f32 unembedding {m} x {cfg.d_model} x "
              f"{cfg.vocab} on B1, each one launch alone, device ms (body, "
              f"searched or heuristic plan; "
              f"scaled err vs the plain version; torch.matmul f32 ms; the "
              f"plain version's ms): "
              + ", ".join(f"{k} {v['device_ms']:.3f} ({v['body']}, "
                          f"{v['plan']}; "
                          f"{v['scaled_err']:.3g}; {v['library_ms']:.3f}; "
                          f"plain {v['plain_ms']:.3f})"
                          for k, v in rows.items())
              + f"; bound {bound:.3f} ms each (3xTF32) ({smi})", flush=True)
        del x, g
    del w, flush
    _free()

    # (c) qwen3-8b train --capture on phase 10's cut
    flags = list(TRAIN_FLAGS)
    flags[flags.index("--steps") + 1] = str(CAPTURE_TRAIN_STEPS)
    args = train_mod.parse_args(flags + ["--capture"])
    tcfg = dataclasses.replace(get_config("qwen3-8b"),
                               n_layers=TRAIN_LAYERS)
    run = train_mod.run_from_args(tcfg, args)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts_all()
    (params, state), losses, report = train_mod.train(run, verbose=False)
    torch.cuda.synchronize()
    got = {k: v / args.steps for k, v in _counts_all().items()}
    peak = torch.cuda.max_memory_allocated()
    steps_ms = [v * 1e3 for v in report.step_times]
    want = {"contract": B1_PER_LAYER_STEP * tcfg.n_layers + 3
            + 3 * tcfg.n_layers,
            "attention": 2 * tcfg.n_layers, "grouped": 0, "grouped_dw": 0}
    base = train_summary["losses"][0]
    err = abs(losses[0] - base) / abs(base)
    out["train"] = dict(losses=losses, launches_per_step=got,
                        step_ms=steps_ms, peak_bytes=peak,
                        uncaptured_step_ms=train_summary["steady_step_s"]
                        * 1e3,
                        uncaptured_peak_bytes=train_summary[
                            "max_memory_allocated"],
                        step1_err=err)
    print(f"[capture] train {tcfg.arch_id} ({tcfg.n_layers} layers, "
          f"{args.batch} x {args.seq}) --capture: losses "
          f"{[round(v, 4) for v in losses]} (uncaptured step 1 "
          f"{base:.4f}, {err:.3g} relative); launches a step {got} (want "
          f"{want}); step ms {[round(v, 1) for v in steps_ms]} (uncaptured "
          f"steady {train_summary['steady_step_s'] * 1e3:.1f}); peak "
          f"{peak / 2**30:.2f} GiB (uncaptured "
          f"{train_summary['max_memory_allocated'] / 2**30:.2f}) ({smi})",
          flush=True)
    del params, state
    _free()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"capture train: non-finite loss {losses}")
    if err > TOL["bfloat16"][0]:
        raise AssertionError(f"capture train: step 1 loss {losses[0]} vs "
                             f"the uncaptured {base}")
    if got != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"capture train: launches a step {got}, "
                             f"expected {want}")


# ---------------------------------------------------------------------------
# phase mesh: the mesh tier on ranks that share the card
# ---------------------------------------------------------------------------

#: the mesh phase's worlds are ranks of one process each that share the
#: card, joined by gloo, every collective's payload staged through pinned
#: host memory (gloo takes no CUDA tensor for a point-to-point transfer)
MESH_TRANSPORT = "host"
#: (b): a small product and qwen3-8b's MLP projections at M = 512
MESH_BIND_SHAPES = ((256, 512, 384), (512, 4096, 12288), (512, 12288, 4096))
#: (c): the dense op searched on the mesh with its gradients, f32
MESH_DENSE = (256, 1024, 1024)
#: (d): qwen3-8b at full width and depth served on 2 ranks (2 requests of
#: 128 tokens in one fixed-slot group: prefill M = 2 x 128, decode M = 2),
#: the serving GEMMs swept at the mesh tier first
MESH_SERVE_FLAGS = [
    "--arch", "qwen3-8b", "--requests", "2", "--prompt-len", "128",
    "--max-new", "8", "--lanes", "2", "--rate-hz", "0", "--seed", "0",
    "--device", "cuda", "--engine", "fixed", "--mesh", "1x2",
    "--mesh-transport", MESH_TRANSPORT, "--no-search-grads",
    "--search-gemms", ";".join(f"{m},{k},{n}" for m in (256, 2)
                               for (k, n) in LAYER_GEMMS)]
#: (e): qwen3-8b at full width cut to 2 of 36 layers (four ranks sharing
#: the card each hold a replica: bf16 params and gradients, int8 moments),
#: batch 1 x 256 tokens, 3 steps, peak lr 3e-4
MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 2, 256, 3


def _mesh_rank_setup(db_path):
    import torch

    os.environ["REPRO_PLAN_DB"] = db_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _mesh_collectives():
    """(a): the collectives over 4 ranks' CUDA tensors for p in {1, 2, 4}
    (a (4 / p) x p mesh), each against its oracle at the reference's rtol
    1e-4 / atol 1e-5, remainder payloads among them; then a 16 MiB f32
    all-reduce over the 4 ranks, psum and ring, timed."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.codegen import collectives as C
    from repro_torch.launch.mesh import make_debug_mesh

    out = {"cases": []}
    staged0 = obs.metrics_json()["counters"].get("mesh.host_staged_bytes", 0)
    for p in (1, 2, 4):
        mesh = make_debug_mesh((4 // p, p), ("data", "model"),
                               transport=MESH_TRANSPORT, device="cuda")
        c, dev = mesh.coordinate("model"), mesh.device
        rng = np.random.default_rng(100 + p)
        worst = 0.0
        for case in range(3):
            m_loc = int(rng.integers(1, 65))
            k, n = int(rng.integers(1, 129)), int(rng.integers(1, 129))
            x = rng.standard_normal((p * m_loc, k))
            w = rng.standard_normal((k, n))
            y = rng.standard_normal((p, int(rng.integers(1, 300)),
                                     int(rng.integers(1, 37))))
            xs = torch.tensor(x[c * m_loc:(c + 1) * m_loc],
                              dtype=torch.float32, device=dev)
            wt = torch.tensor(w, dtype=torch.float32, device=dev)
            mine = torch.tensor(y[c], dtype=torch.float32, device=dev)
            for name, got, want in (
                    ("ring_gather_matmul",
                     C.ring_gather_matmul(xs, wt, "model", mesh), x @ w),
                    ("naive_gather_matmul",
                     C.naive_gather_matmul(xs, wt, "model", mesh), x @ w),
                    ("ring_psum", C.ring_psum(mine, "model", mesh),
                     y.sum(0)),
                    ("psum", C.all_reduce(mine, ("model",), "psum", mesh),
                     y.sum(0))):
                if not got.is_cuda:
                    raise AssertionError(f"mesh (a) {name}: a host result")
                worst = max(worst, _check_close(
                    got.double().cpu(), torch.tensor(want), "float32",
                    f"mesh (a) {name} p={p} case {case}",
                    tol=(1e-4, 1e-5))[1])
        out["cases"].append(dict(p=p, max_scaled_err=worst))
    mesh = make_debug_mesh((1, 4), ("data", "model"),
                           transport=MESH_TRANSPORT, device="cuda")
    big = torch.randn(4 * 2**20, device=mesh.device)
    for coll in ("psum", "ring"):
        C.all_reduce(big, ("model",), coll, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            C.all_reduce(big, ("model",), coll, mesh)
        torch.cuda.synchronize()
        out[f"allreduce_16mib_{coll}_ms"] = (time.perf_counter() - t0) / 3e-3
    out["staged_bytes"] = obs.metrics_json()["counters"].get(
        "mesh.host_staged_bytes", 0) - staged0
    return out


def _mesh_bind(mesh):
    """(b): every sharded variant x collective of ``mesh_variants`` on the
    2x2 mesh, f32 and bf16, at ``MESH_BIND_SHAPES``: one B1 launch a call
    on each rank, the output against single-card B1 and the plain version
    at the reference's TOL, one warm call timed (its collectives
    included)."""
    import torch

    from repro_torch.codegen import (CONTRACT, cached_compile, contract_ref,
                                     default_schedule)
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.search.space import make_candidate, mesh_variants

    def timed(kern, a, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(a, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows = []
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    for m, k, n in MESH_BIND_SHAPES:
        spec = matmul_spec(m, k, n)
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            a = torch.randn(m, k, generator=gen, device=mesh.device).to(dt)
            b = torch.randn(k, n, generator=gen, device=mesh.device).to(dt)
            single = cached_compile(spec, default_schedule(spec))
            n0 = CONTRACT.launches
            b1 = single(a, b)
            if CONTRACT.launches - n0 != 1:
                raise AssertionError("mesh (b): single-card B1 not one "
                                     "launch")
            plain = contract_ref(spec, a, b, out_dtype=dt)
            worst, ms, variants = 0.0, [], 0
            for v in mesh_variants(spec, (2, 2)):
                if not v.assignment:
                    continue
                sched = make_candidate(spec, spec.indices, {},
                                       mesh=v.as_dict(),
                                       collective=v.collective).to_schedule()
                kern = cached_compile(spec, sched, mesh=mesh,
                                      collective=v.collective or "psum")
                what = (f"mesh (b) {m}x{k}x{n} {dt_name} {v.assignment} "
                        f"{v.collective or '-'}")
                n0 = CONTRACT.launches
                got = kern(a, b)
                if CONTRACT.launches - n0 != 1:
                    raise AssertionError(f"{what}: {CONTRACT.launches - n0} "
                                         f"B1 launches in a call")
                worst = max(worst, _check_close(got, b1, dt_name,
                                                what + " vs B1")[1],
                            _check_close(got, plain, dt_name,
                                         what + " vs plain")[1])
                ms.append(timed(kern, a, b))
                variants += 1
            rows.append(dict(shape=(m, k, n), dtype=dt_name,
                             variants=variants, max_scaled_err=worst,
                             ms_min=min(ms), ms_median=sorted(ms)[len(ms) // 2],
                             ms_max=max(ms), b1_ms=timed(single, a, b)))
    return rows


def _mesh_dense(mesh):
    """(c): ``search_schedule_with_grads(mesh_shape=(2, 2))`` on the card,
    then ``ops.dense``'s loss and gradients under the mesh: a
    ``MeshBoundKernel`` forward, ``.dA`` and ``.dB``, held against the
    unsharded B1 run at the f32 TOL."""
    import torch

    from repro_torch import obs, ops
    from repro_torch.codegen import CONTRACT, MeshBoundKernel
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.search import default_plan_db, search_schedule_with_grads

    m, k, n = MESH_DENSE
    spec = matmul_spec(m, k, n)
    t0 = time.perf_counter()
    with set_mesh(mesh):  # the search measures over this mesh's ranks
        res = search_schedule_with_grads(
            spec, dtype=torch.float32, beam_width=4, topk=2, repeats=2,
            plan_db=default_plan_db(), mesh_shape=(2, 2), device="cuda")
    search_s = time.perf_counter() - t0
    ladders = {}
    for label, r in res.items():
        best = r.best_sharded()
        if best is None:
            raise AssertionError(f"mesh (c) {label}: no sharded rung")
        single = next((p for p in r.ranked if not p.sharded), None)
        ladders[label] = dict(
            winner=r.best.source, winner_sharded=r.best.sharded,
            sharded_ms=(best.measured_s or float("nan")) * 1e3,
            sharded_plan=" ".join(f"{lvl.index}:{lvl.tier}"
                                  for lvl in best.schedule.levels
                                  if lvl.tier.startswith("mesh:")),
            collective=best.collective or "-",
            single_ms=(single.measured_s if single and single.measured_s
                       else float("nan")) * 1e3)
    with set_mesh(mesh):
        kern = ops._mesh_plan_kernel(spec, torch.float32)
    if not isinstance(kern, MeshBoundKernel):
        raise AssertionError(f"mesh (c): {type(kern).__name__}, not a "
                             f"MeshBoundKernel")
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    x = torch.randn(m, k, generator=gen, device=mesh.device)
    w = torch.randn(k, n, generator=gen, device=mesh.device)

    def run():
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss = (ops.dense(a, b) ** 2).mean()
        loss.backward()
        return loss.detach(), a.grad, b.grad

    base = run()
    obs.metrics_reset()
    n0 = CONTRACT.launches
    with set_mesh(mesh):
        sharded = run()
    launches = CONTRACT.launches - n0
    calls = {k_: v for k_, v in obs.metrics_json()["counters"].items()
             if k_.startswith("mesh.calls.")}
    want = {f"mesh.calls.{s}": 1 for s in ("matmul", "matmul.dA",
                                           "matmul.dB")}
    if calls != want or launches != 3:
        raise AssertionError(f"mesh (c): mesh-bound calls {calls}, B1 "
                             f"launches {launches}; want {want} and 3")
    errs = [_check_close(s, b_, "float32", f"mesh (c) {what}")[1]
            for s, b_, what in zip(sharded, base, ("loss", "dx", "dw"))]
    return dict(shape=MESH_DENSE, search_s=search_s, ladders=ladders,
                calls=calls, launches=launches, scaled_errs=errs)


def _mesh_train(mesh, rank):
    """(e): ``make_train_step(mesh=)`` on the 2x2 mesh at qwen3-8b width,
    depth cut, after the step's GEMMs (with their derived specs) were
    searched at the mesh tier; then on rank 0 the same steps from the same
    weights without the mesh."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.codegen import CONTRACT
    from repro_torch.configs import get_config
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim
    from repro_torch.search import default_plan_db, search_schedule_with_grads

    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              n_layers=MESH_TRAIN_LAYERS)
    from repro_torch.launch.mesh import set_mesh

    t0 = time.perf_counter()
    with set_mesh(mesh):  # the search measures over this mesh's ranks
        for k, n in LAYER_GEMMS:
            search_schedule_with_grads(
                matmul_spec(MESH_TRAIN_SEQ, k, n), dtype=torch.bfloat16,
                beam_width=4, topk=2, repeats=2, plan_db=default_plan_db(),
                mesh_shape=(2, 2), device="cuda")
    search_s = time.perf_counter() - t0
    api = get_api(cfg)
    ocfg = AdamWConfig(lr=3e-4, moments_dtype="int8")
    dc = DataConfig(vocab=cfg.vocab, seq_len=MESH_TRAIN_SEQ, global_batch=1)
    batches = [{k: torch.as_tensor(np.asarray(v)).to(mesh.device)
                for k, v in batch_at(dc, i).items()}
               for i in range(MESH_TRAIN_STEPS)]

    def steps(mesh_or_none):
        params = api.init(cfg, torch.Generator(device=mesh.device)
                          .manual_seed(0), mesh.device)
        state = optim.init(params, ocfg)
        step = make_train_step(cfg, ocfg, mesh=mesh_or_none)
        losses, times = [], []
        obs.metrics_reset()
        n0 = CONTRACT.launches
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            t = time.perf_counter()
            params, state, mtr = step(params, state, b)
            losses.append(float(mtr["loss"]))
            times.append(time.perf_counter() - t)
        calls = sum(v for k, v in obs.metrics_json()["counters"].items()
                    if k.startswith("mesh.calls."))
        digest = sum(float(t.detach().double().sum()) for _, t in
                     optim.leaves(params))
        out = dict(losses=losses, step_ms=[v * 1e3 for v in times],
                   launches=CONTRACT.launches - n0, mesh_calls=calls,
                   digest=digest, peak=torch.cuda.max_memory_allocated())
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        return out

    meshed = steps(mesh)
    dist.barrier()
    single = steps(None) if rank == 0 else None
    dist.barrier()
    meshed["single"] = single
    meshed["search_s"] = search_s
    meshed["steady_ms"] = statistics.median(meshed["step_ms"][1:])
    return meshed


def _mesh_rank4(rank, db_path):
    """The 4-rank world of phase mesh: (a), then (b), (c) and (e) on a 2x2
    mesh."""
    from repro_torch.launch.mesh import make_debug_mesh

    _mesh_rank_setup(db_path)
    out = {"a": _mesh_collectives()}
    mesh = make_debug_mesh((2, 2), ("data", "model"),
                           transport=MESH_TRANSPORT, device="cuda")
    out["b"] = _mesh_bind(mesh)
    out["c"] = _mesh_dense(mesh)
    out["e"] = _mesh_train(mesh, rank)
    return out


def _mesh_serve_rank(rank, db_path):
    """(d): ``serve --mesh 1x2`` of qwen3-8b on this rank (``serve.run``
    of ``MESH_SERVE_FLAGS``); then, outside the mesh on the same weights,
    the first-token logits of one batched prefill with and without the
    mesh and the same trace served single-rank."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.serving import (FixedEngine, Gateway,
                                            synthetic_trace)

    _mesh_rank_setup(db_path)
    args = serve.parse_args(MESH_SERVE_FLAGS)
    cfg = get_config("qwen3-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, trace, engine = serve.run(cfg, args)
    wall = time.perf_counter() - t0
    server = engine.server
    if server.mesh is None:
        raise AssertionError("mesh (d): the world did not host the mesh")
    peak = torch.cuda.max_memory_allocated()
    forwards = stats["prefills"] + stats["decode_steps"]
    reqs = [serve.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in trace]
    toks, lengths = server._pack(reqs)
    with torch.inference_mode():
        with set_mesh(server.mesh):
            meshed, _ = server._prefill(toks, lengths)
        single, _ = server._prefill(toks, lengths)
    rows = []
    for i in range(len(reqs)):  # equal prompts: the last position each
        want, got = single[i, -1].float(), meshed[i, -1].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("mesh (d): non-finite first-token logits")
        rows.append(float((got - want).abs().max() / want.abs().max()))
    plain = FixedEngine(cfg, lanes=args.lanes, max_ctx=server.max_len,
                        params=server.params, device="cuda")
    trace2 = synthetic_trace(
        args.requests, vocab=cfg.vocab, seed=args.seed, rate_hz=args.rate_hz,
        prompt_lens=tuple(sorted({max(1, args.prompt_len // 4),
                                  max(1, args.prompt_len // 2),
                                  args.prompt_len})),
        max_news=tuple(sorted({max(1, args.max_new // 4), args.max_new})))
    single_stats = Gateway(plain).run(trace2)
    same = [r.out_tokens == s.out_tokens for r, s in zip(trace, trace2)]
    return dict(launches=stats["kernel_launches"],
                mesh_calls=stats["mesh_calls"], forwards=forwards,
                staged_bytes=stats["host_staged_bytes"],
                prefill_ms=stats["prefill_s"] * 1e3,
                tok_per_s=stats["tok_per_s"],
                single_prefill_ms=single_stats["prefill_s"] * 1e3,
                single_tok_per_s=single_stats["tok_per_s"],
                logit_errs=rows, same_tokens=same, peak=peak, wall_s=wall,
                tokens=[list(r.out_tokens) for r in trace])


def phase_mesh(smi):
    """The mesh tier (``codegen.{collectives,mesh_gen}``, ``launch.mesh``,
    ``ops._mesh_plan_kernel``, the search on a mesh, ``serve --mesh``,
    ``make_train_step(mesh=)``) on ranks that share the card: one world of
    4 spawned ranks for (a), (b), (c) and (e), one of 2 for (d), gloo
    between them with host-staged payloads.  The parent built every
    kernel already; a rank that fails or hangs fails the phase."""
    import chip_smoke as cs  # the ranks import their bodies by this name

    from repro_torch.launch.mesh import spawn_ranks

    _free()
    db = os.path.join(OUT, "plans_mesh.json")
    t0 = time.perf_counter()
    four = spawn_ranks(cs._mesh_rank4, 4, (db,), store_dir=OUT,
                       timeout_s=540)
    four_s = time.perf_counter() - t0
    r0 = four[0]
    for out in four[1:]:
        if out["e"]["losses"] != r0["e"]["losses"] or \
                out["e"]["digest"] != r0["e"]["digest"]:
            raise AssertionError("mesh (e): the ranks' losses or "
                                 "parameters differ")
        if out["c"]["ladders"].keys() != r0["c"]["ladders"].keys():
            raise AssertionError("mesh (c): the ranks' ladders differ")
    a = r0["a"]
    print(f"[mesh] (a) collectives over 4 ranks sharing the card (gloo, "
          f"{MESH_TRANSPORT}-staged): "
          + ", ".join(f"p={c['p']} max scaled err {c['max_scaled_err']:.3g}"
                      for c in a["cases"])
          + f" (limit 1e-4 / 1e-5); 16 MiB f32 all-reduce psum "
          f"{a['allreduce_16mib_psum_ms']:.2f} ms, ring "
          f"{a['allreduce_16mib_ring_ms']:.2f} ms; staged "
          f"{a['staged_bytes'] / 2**20:.1f} MiB a rank ({smi})", flush=True)
    for row in r0["b"]:
        m, k, n = row["shape"]
        print(f"[mesh] (b) bind_mesh 2x2 {m}x{k}x{n} {row['dtype']}: "
              f"{row['variants']} sharded variants, one B1 launch a call, "
              f"max scaled err vs B1 and plain {row['max_scaled_err']:.3g} "
              f"(TOL {TOL[row['dtype']][0]}); ms a call {row['ms_min']:.2f} "
              f"/ {row['ms_median']:.2f} / {row['ms_max']:.2f} "
              f"(min / median / max) vs single-card B1 {row['b1_ms']:.3f} "
              f"({smi})", flush=True)
    c = r0["c"]
    print(f"[mesh] (c) search {c['shape']} f32 with grads on the 2x2 mesh "
          f"in {c['search_s']:.1f} s: "
          + "; ".join(f"{lbl} winner {d['winner']}"
                      f"{' (sharded)' if d['winner_sharded'] else ''}, best "
                      f"sharded {d['sharded_plan']} {d['collective']} "
                      f"{d['sharded_ms']:.3f} ms vs single-rank "
                      f"{d['single_ms']:.3f} ms"
                      for lbl, d in c["ladders"].items())
          + f"; ops.dense under the mesh: {c['calls']}, {c['launches']} B1 "
          f"launches, loss / dx / dw scaled err "
          f"{[round(e, 8) for e in c['scaled_errs']]} (f32 TOL 1e-4) "
          f"({smi})", flush=True)
    e = r0["e"]
    single = e["single"]
    if not all(map(math.isfinite, e["losses"])):
        raise AssertionError(f"mesh (e): non-finite losses {e['losses']}")
    for got, want in zip(e["losses"], single["losses"]):
        if abs(got - want) > TOL["bfloat16"][1] + TOL["bfloat16"][0] * abs(
                want):
            raise AssertionError(f"mesh (e): losses {e['losses']} vs "
                                 f"single-rank {single['losses']}")
    per_step = B1_PER_LAYER_STEP * MESH_TRAIN_LAYERS * MESH_TRAIN_STEPS
    if e["launches"] != per_step or e["mesh_calls"] != per_step:
        raise AssertionError(f"mesh (e): B1 {e['launches']}, mesh-bound "
                             f"{e['mesh_calls']}; want {per_step} each")
    print(f"[mesh] (e) train qwen3-8b width, {MESH_TRAIN_LAYERS} of 36 "
          f"layers, batch 1 x {MESH_TRAIN_SEQ}, int8 moments, on the 2x2 "
          f"mesh (mesh ladders searched in {e['search_s']:.1f} s): losses "
          f"{[round(v, 4) for v in e['losses']]} vs single-rank "
          f"{[round(v, 4) for v in single['losses']]}; B1 {e['launches']} "
          f"launches a rank, all mesh-bound; step ms "
          f"{[round(v, 1) for v in e['step_ms']]} (single-rank "
          f"{[round(v, 1) for v in single['step_ms']]}); peak "
          f"{e['peak'] / 2**30:.2f} GiB a rank; every rank's parameters "
          f"equal ({smi})", flush=True)
    t1 = time.perf_counter()
    two = spawn_ranks(cs._mesh_serve_rank, 2, (db,), store_dir=OUT,
                      timeout_s=600)
    two_s = time.perf_counter() - t1
    want = 7 * 36 * two[0]["forwards"]
    for rank, d in enumerate(two):
        if d["launches"] != want or d["mesh_calls"] != want:
            raise AssertionError(f"mesh (d) rank {rank}: B1 {d['launches']}, "
                                 f"mesh-bound {d['mesh_calls']}; want {want}")
        if max(d["logit_errs"]) > TOL["bfloat16"][1]:
            raise AssertionError(f"mesh (d) rank {rank}: first-token logits "
                                 f"vs single-rank {d['logit_errs']}")
        if d["tokens"] != two[0]["tokens"]:
            raise AssertionError("mesh (d): the ranks served different "
                                 "tokens")
    for rank, d in enumerate(two):
        print(f"[mesh] (d) serve --mesh 1x2 qwen3-8b full width and depth, "
              f"rank {rank}: B1 {d['launches']} = 7 x 36 x {d['forwards']} "
              f"forwards, all mesh-bound; first-token logits vs single-rank "
              f"{[round(v, 5) for v in d['logit_errs']]} of max |logit| "
              f"(limit 6e-2); tokens equal single-rank {d['same_tokens']}; "
              f"prefill {d['prefill_ms']:.1f} ms, decode "
              f"{d['tok_per_s']:.2f} tok/s (single-rank on the same weights "
              f"{d['single_prefill_ms']:.1f} ms, "
              f"{d['single_tok_per_s']:.2f} tok/s); staged "
              f"{d['staged_bytes'] / 2**20:.1f} MiB; peak "
              f"{d['peak'] / 2**30:.2f} GiB; run {d['wall_s']:.1f} s "
              f"({smi})", flush=True)
    print(f"[mesh] worlds: 4 ranks {four_s:.1f} s, 2 ranks {two_s:.1f} s",
          flush=True)
    return dict(four=r0, serve=two, four_s=four_s, two_s=two_s)


#: phase sharded: steps on DTensor parameters, each rank running the
#: kernels on its own shards (the ops' sharding rules, ``ops.library``), on
#: 2x2 and 1x2 meshes of ranks that share the card (gloo).  (a) the four
#: ops at these shapes: B1 at qwen3-8b's MLP projections (M = 512), B2 at
#: the attention path's (a), B3 / B4 at the MoE training shapes
SHARD_B1 = ((512, 4096, 12288), (512, 12288, 4096))
SHARD_ATTN = (ATTN_HEADS, ATTN_SEQ, ATTN_DIM)
SHARD_GROUPS = (MOE_TRAIN_C,) * MOE_TRAIN_EXPERTS
#: (b) qwen3-8b at full width cut to 4 of 36 layers (half the train
#: cell's cut: each step is host-bound on gloo, 12-21 s at 8 layers),
#: batch 2 x 256 tokens, f32 moments, 3 steps; the losses also at a
#: 2-layer cut against rank 0 alone
SHARD_LAYERS, SHARD_CHECK_LAYERS = 4, 2
SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 2, 256, 3
#: (c) kimi-k2 at the MoE train cut (2 layers, 32 experts), batch 1 x 256
#: tokens, bf16 moments, one step
SHARD_MOE_SEQ = 256
#: (e) the mesh dry-run's cells, cut to DRYRUN_LAYERS on fake CUDA tensors
SHARD_DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
                      ("qwen3-8b", "decode_32k"), (MOE_ARCH, "train_4k"))
#: (f) serve --capture --mesh 1x2: qwen3-8b cut to 4 layers, 2 requests of
#: 128 tokens with 4 new
SHARD_CAPTURE_LAYERS = 4
SHARD_CAPTURE_FLAGS = [
    "--arch", "qwen3-8b", "--requests", "2", "--prompt-len", "128",
    "--max-new", "4", "--lanes", "2", "--rate-hz", "0", "--seed", "0",
    "--device", "cuda", "--engine", "fixed", "--mesh", "1x2",
    "--mesh-transport", MESH_TRANSPORT, "--no-search-grads"]


def _in_turns(make):
    """``make()`` on each rank in turn (rank order, a barrier between), so
    only one rank at a time holds what ``make`` allocates beyond its
    result: the whole-model init a rank then shards and drops."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = make()
            _free()
        dist.barrier()
    return out


def _sharded_init(cfg, mesh, seed=0):
    """``cfg``'s seeded params on the card, placed on ``mesh`` by the
    reference's rules (``shard_tree``), one rank's whole copy at a time."""
    import torch

    from repro_torch.launch.steps import param_shardings, shard_tree
    from repro_torch.models.api import get_api

    api = get_api(cfg)

    def make():
        full = api.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
        return shard_tree(mesh, full, param_shardings(mesh, cfg, api)[2])

    return _in_turns(make)


def _strategy_pairs(rules):
    """Every (data, model) pair of an op's single-dimension strategies:
    its strategies expanded over the 2x2 mesh, each as (output placements,
    operand placements) per mesh dim."""
    return [(a, b) for a in rules for b in rules]


def _place(full, mesh, pls):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, mesh.device_mesh, list(pls),
                             src_data_rank=None)


def _op_cases(mesh, call, single, plain, inputs, rules, dt_name, what,
              counter):
    """Each strategy pair of ``rules``: the operands placed as it says,
    ``call`` on them (one launch of the kernel a rank, at local extents,
    the pair's layout chosen by the op's rule at no cost), the output
    gathered and held against ``single`` (the same op on whole tensors)
    and ``plain`` at the TOL.  Returns (pairs, max scaled err, launches a
    call)."""
    from repro_torch import obs

    worst, pairs, launches = 0.0, 0, set()
    for data, model in _strategy_pairs(rules):
        pls = list(zip(data[1], model[1]))
        try:
            args = [_place(x, mesh, pl) for x, pl in zip(inputs, pls)]
        except (RuntimeError, ValueError):
            continue  # a layout the extents cannot take
        obs.metrics_reset()
        n0 = counter()
        out = call(*args)
        n = counter() - n0
        got = out.full_tensor()
        for want, tag in ((single, "single-card"), (plain, "plain")):
            worst = max(worst, _check_close(got, want, dt_name,
                                            f"sharded (a) {what} vs {tag}")[1])
        ruled = sum(v for k, v in obs.metrics_json()["counters"].items()
                    if k.startswith("ops.dtensor."))
        if n != 1 or ruled != 1:
            raise AssertionError(f"sharded (a) {what} {pls}: {n} launches, "
                                 f"{ruled} calls through the op's rule a "
                                 f"rank; want 1")
        launches.add(n)
        pairs += 1
    return pairs, worst, sorted(launches)


def _sharded_ops():
    """(a): each op's strategies on DTensors over the 2x2 mesh."""
    import torch

    from repro_torch import ops
    from repro_torch.codegen import (ATTENTION, CONTRACT, GROUPED, GROUPED_DW,
                                     attention_ref, contract_ref, grouped_ref)
    from repro_torch.core.enumerate import (grouped_matmul_spec, matmul_spec,
                                            transposed_matmul_spec,
                                            weighted_matmul_spec)
    from repro_torch.grad.derive import derived_specs
    from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.ops import library

    mesh = make_debug_mesh((2, 2), ("data", "model"), device="cuda",
                           transport=MESH_TRANSPORT)
    gen = torch.Generator(device="cuda").manual_seed(97)
    rows = []

    def randn(*shape, dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    def kern(spec, dt, **kw):
        return ops._tuned_kernel(spec, dt, sharded=True, **kw)

    for m, k, n in SHARD_B1:
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            x, w = randn(m, k, dt=dt), randn(k, n, dt=dt)
            spec = matmul_spec(m, k, n)
            rules = library.contract_strategies(kern(spec, dt), 0)
            single = ops.dense(x, w, differentiable=False)
            plain = contract_ref(spec, x, w, out_dtype=dt)
            pairs, err, _ = _op_cases(
                mesh, lambda a, b: ops.dense(a, b, differentiable=False),
                single, plain, (x, w), rules, dt_name,
                f"B1 {m}x{k}x{n} {dt_name}", lambda: CONTRACT.launches)
            rows.append(dict(op="B1 plain", shape=(m, k, n), dtype=dt_name,
                             pairs=pairs, err=err))
    m, k, n = SHARD_B1[0]
    bf16 = torch.bfloat16
    x, w = randn(m, k, dt=bf16), randn(k, n, dt=bf16)
    beta, mean = randn(n, dt=bf16), randn(n, dt=bf16)
    var = randn(n, dt=bf16).abs() + 1
    from repro_torch.codegen import Epilogue

    epi = Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    rules = library.contract_strategies(
        kern(matmul_spec(m, k, n), bf16, epilogue=epi), 3)
    if any(out[0].is_partial() for out, _ in rules):
        raise AssertionError("sharded (a): an epilogue offered a Partial "
                             "output")
    pairs, err, _ = _op_cases(
        mesh, lambda *a: ops.dense_act(*a, act="gelu", differentiable=False),
        ops.dense_act(x, w, beta, mean, var, act="gelu",
                      differentiable=False),
        fused_dense_act_ref(x, w, beta, mean, var, act="gelu",
                            eps=1e-5).to(bf16),
        (x, w, beta, mean, var), rules, "bfloat16",
        "B1 epilogue (bias, norm, gelu)", lambda: CONTRACT.launches)
    rows.append(dict(op="B1 epilogue", shape=(m, k, n), dtype="bfloat16",
                     pairs=pairs, err=err))
    g = randn(k, dt=bf16)
    spec = weighted_matmul_spec(m, k, n)
    pairs, err, _ = _op_cases(
        mesh, lambda a, b, c: ops.weighted_dense(a, b, c,
                                                 differentiable=False),
        ops.weighted_dense(x, w, g, differentiable=False),
        contract_ref(spec, x, w, g, out_dtype=bf16), (x, w, g),
        library.contract_strategies(kern(spec, bf16), 0), "bfloat16",
        "B1 weighted", lambda: CONTRACT.launches)
    rows.append(dict(op="B1 weighted", shape=(m, k, n), dtype="bfloat16",
                     pairs=pairs, err=err))
    xt = x.t().contiguous()
    spec = transposed_matmul_spec(m, k, n)
    pairs, err, _ = _op_cases(
        mesh, lambda a, b: ops.dense_transposed(a, b, differentiable=False),
        ops.dense_transposed(xt, w, differentiable=False),
        contract_ref(spec, xt, w, out_dtype=bf16), (xt, w),
        library.contract_strategies(kern(spec, bf16), 0), "bfloat16",
        "B1 transposed", lambda: CONTRACT.launches)
    rows.append(dict(op="B1 transposed", shape=(m, k, n), dtype="bfloat16",
                     pairs=pairs, err=err))
    # B2: heads
    h, s, d = SHARD_ATTN
    q, kk, v = (randn(h, s, d, dt=bf16) for _ in range(3))
    att_rules = library.attention_strategies(3)
    pairs, err, _ = _op_cases(
        mesh, lambda a, b, c: ops.attention(a, b, c, causal=True,
                                            differentiable=False),
        ops.attention(q, kk, v, causal=True, differentiable=False),
        attention_ref(q, kk, v, causal=True, kv_lengths=None,
                      out_dtype=bf16), (q, kk, v),
        att_rules, "bfloat16", f"B2 {h}x{s}x{d} causal",
        lambda: ATTENTION.launches)
    rows.append(dict(op="B2", shape=SHARD_ATTN, dtype="bfloat16",
                     pairs=pairs, err=err))
    # B3 and B4 at the MoE training shapes
    kd, fd = GROUPED_GATE
    sizes = SHARD_GROUPS
    xg, wg = randn(sum(sizes), kd, dt=bf16), randn(len(sizes), kd, fd,
                                                     dt=bf16)
    spec = grouped_matmul_spec(sizes, kd, fd)
    gk = kern(spec, bf16)
    ok_rules = library.grouped_strategies(gk)
    pairs, err, _ = _op_cases(
        mesh, lambda a, b: ops.grouped_dense(a, b, sizes,
                                             differentiable=False),
        ops.grouped_dense(xg, wg, sizes, differentiable=False),
        grouped_ref(xg, wg, sizes, out_dtype=bf16), (xg, wg), ok_rules,
        "bfloat16", f"B3 {len(sizes)}x{sizes[0]} rows, {kd}->{fd}",
        lambda: GROUPED.launches)
    rows.append(dict(op="B3", shape=(len(sizes), sizes[0], kd, fd),
                     dtype="bfloat16", pairs=pairs, err=err))
    cot = randn(sum(sizes), fd, dt=bf16)
    dw_spec = derived_specs(spec)["W"]
    dwk = kern(dw_spec, bf16)
    names = tuple(dw_spec.operands)
    by_name = {names[0]: cot if "f" in dw_spec.operands[names[0]] else xg,
               names[1]: xg if "f" in dw_spec.operands[names[0]] else cot}
    args = [by_name[nm] for nm in names]
    from repro_torch.codegen.fused_gen import grouped_dw_ref

    lhs = next(by_name[nm] for nm in names
               if dw_spec.output[1] in dw_spec.operands[nm])
    rhs = next(by_name[nm] for nm in names
               if dw_spec.output[2] in dw_spec.operands[nm])
    pairs, err, _ = _op_cases(
        mesh, lambda a, b: dwk(a, b), dwk(*args),
        grouped_dw_ref(lhs, rhs, sizes, out_dtype=bf16), args,
        library.grouped_strategies(dwk), "bfloat16",
        f"B4 {len(sizes)}x{sizes[0]} rows", lambda: GROUPED_DW.launches)
    rows.append(dict(op="B4", shape=(len(sizes), sizes[0], kd, fd),
                     dtype="bfloat16", pairs=pairs, err=err))
    return rows


def _sharded_train(mesh, rank):
    """(b): qwen3-8b cut to SHARD_LAYERS on the 2x2 ``tp`` mesh, then at
    SHARD_CHECK_LAYERS against rank 0 alone."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.codegen import CONTRACT
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dtensor import local
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.steps import make_train_step, shard_tree
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    ocfg = AdamWConfig(lr=3e-4, moments_dtype="float32")

    def batches(cfg):
        dc = DataConfig(vocab=cfg.vocab, seq_len=SHARD_SEQ,
                        global_batch=SHARD_BATCH)
        out = []
        for i in range(SHARD_STEPS):
            b = {k: torch.as_tensor(np.asarray(v)).cuda()
                 for k, v in batch_at(dc, i).items()}
            out.append(b)
        return out

    def place(b):
        return shard_tree(mesh, b, {k: shd.batch_spec_for(
            mesh, tuple(v.shape), seq_axis=1) for k, v in b.items()})

    def run(layers, on_mesh, record=False):
        cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=layers)
        if on_mesh:
            params = _sharded_init(cfg, mesh)
        else:
            params = get_api(cfg).init(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        state = optim.init(params, ocfg)
        step = make_train_step(cfg, ocfg, mesh=mesh if on_mesh else None)
        losses, times, colls = [], [], None
        _free()
        torch.cuda.reset_peak_memory_stats()
        n0 = CONTRACT.launches
        for i, b in enumerate(batches(cfg)):
            b = place(b) if on_mesh else b
            torch.cuda.synchronize()
            t = time.perf_counter()
            if record and i == 0:
                box = {}
                colls = collective_bytes(
                    lambda: box.update(out=step(params, state, b)))
                params, state, mtr = box["out"]
            else:
                params, state, mtr = step(params, state, b)
            losses.append(float(local(mtr["loss"])))
            times.append(time.perf_counter() - t)
        out = dict(losses=losses, step_ms=[v * 1e3 for v in times],
                   launches=CONTRACT.launches - n0,
                   peak=torch.cuda.max_memory_allocated(), collectives=colls)
        del params, state, step
        _free()
        return out

    full = run(SHARD_LAYERS, True, record=True)
    full["steady_ms"] = statistics.median(full["step_ms"][1:])
    dist.barrier()
    check = run(SHARD_CHECK_LAYERS, True)
    dist.barrier()
    single = run(SHARD_CHECK_LAYERS, False) if rank == 0 else None
    dist.barrier()
    return dict(full=full, check=check, single=single)


def _sharded_moe(mesh, rank):
    """(c): kimi-k2 at the MoE train cut, experts on ``model``, one step
    through B3 / B4 at the local groups; rank 0's first loss alone."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.codegen import GROUPED, GROUPED_DW
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dtensor import local
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.steps import make_train_step, shard_tree
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS, moe=dataclasses.replace(
        full.moe, n_experts=MOE_TRAIN_EXPERTS))
    dc = DataConfig(vocab=cfg.vocab, seq_len=SHARD_MOE_SEQ, global_batch=1)
    b = {k: torch.as_tensor(np.asarray(v)).cuda()
         for k, v in batch_at(dc, 0).items()}
    ocfg = AdamWConfig(lr=3e-4, moments_dtype="bfloat16")
    bs = shard_tree(mesh, b, {k: shd.batch_spec_for(
        mesh, tuple(v.shape), seq_axis=1) for k, v in b.items()})
    out = {}
    for key, constraint in (("", False), ("constraint_", True)):
        # REPRO_MOE_CONSTRAINT=1: the dispatched slots reach their
        # experts' ranks by all-to-alls (``models.moe``)
        if constraint:
            os.environ["REPRO_MOE_CONSTRAINT"] = "1"
        try:
            params = _sharded_init(cfg, mesh)
            state = optim.init(params, ocfg)
            step = make_train_step(cfg, ocfg, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            box = {}
            t = time.perf_counter()
            colls = collective_bytes(
                lambda: box.update(out=step(params, state, bs)))
            params, state, mtr = box["out"]
            loss = float(local(mtr["loss"]))
            step_ms = (time.perf_counter() - t) * 1e3
        finally:
            os.environ.pop("REPRO_MOE_CONSTRAINT", None)
        out.update({key + "loss": loss, key + "step_ms": step_ms,
                    key + "grouped": GROUPED.launches,
                    key + "grouped_dw": GROUPED_DW.launches,
                    key + "peak": torch.cuda.max_memory_allocated(),
                    key + "collectives": colls})
        del params, state, step
        _free()
    dist.barrier()
    if rank == 0:
        api = get_api(cfg)
        p = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     "cuda")
        with torch.no_grad():
            out["single_loss"] = float(api.loss(p, cfg, b))
        del p
        _free()
    dist.barrier()
    return out


def _leaf_digests(params):
    """sha1 of each parameter leaf's bytes, gathered whole."""
    import hashlib

    import torch

    from repro_torch.dtensor import is_dtensor
    from repro_torch.optim import adamw as optim

    out = {}
    for path, t in optim.leaves(params):
        full = (t.full_tensor() if is_dtensor(t) else t).detach().cpu()
        bits = full.view(torch.int16 if full.dtype == torch.bfloat16
                         else torch.uint8)
        out["/".join(path)] = hashlib.sha1(bits.numpy().tobytes()).hexdigest()
    return out


def _ckpt_digests(ckpt_dir, step):
    """The same digests of the parameter leaves a checkpoint holds."""
    import hashlib

    import numpy as np

    with np.load(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")) as z:
        return {k.split("\x1f", 1)[1].replace("\x1f", "/"):
                hashlib.sha1(np.ascontiguousarray(z[k]).tobytes()).hexdigest()
                for k in z.files if k.startswith("#0\x1f")}


def _elastic_run(rank, shape, ckpt_dir, resume):
    """(d): the smoke qwen3-8b on a ``shape`` mesh.  Without ``resume``:
    steps 0 and 1, a checkpoint at step 2 (``checkpoint.save`` of the
    DTensor tree: gathered, written by rank 0), then step 2 uninterrupted.
    With it: the checkpoint restored with this mesh's shardings, and step
    2 through a fault loop whose first attempt raises ``StepFailure``, so
    it restores again and replays."""
    import numpy as np
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dtensor import local
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (_meta_params, make_train_step,
                                          opt_shardings, param_shardings,
                                          shard_tree)
    from repro_torch.models.api import get_api
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as optim
    from repro_torch.runtime.fault import (FaultTolerantLoop, LoopConfig,
                                           StepFailure)

    cfg = get_config("qwen3-8b").smoke()
    api = get_api(cfg)
    mesh = make_debug_mesh(shape, ("data", "model"), device="cuda",
                           transport=MESH_TRANSPORT)
    ocfg = AdamWConfig(lr=1e-2)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    step_fn = make_train_step(cfg, ocfg, mesh=mesh)
    losses = {}

    def run(step, state):
        b = {k: torch.as_tensor(np.asarray(v)).cuda()
             for k, v in batch_at(dc, step).items()}
        b = shard_tree(mesh, b, {k: shd.batch_spec_for(
            mesh, tuple(v.shape), seq_axis=1) for k, v in b.items()})
        p, o, m = step_fn(state[0], state[1], b)
        losses[step] = float(local(m["loss"]))
        return (p, o)

    if not resume:
        params = _sharded_init(cfg, mesh)
        state = (params, optim.init(params, ocfg))
        for step in (0, 1):
            state = run(step, state)
        ckpt.save(ckpt_dir, 2, state)
        saved = _leaf_digests(state[0])
        run(2, state)
        return dict(losses=losses, saved=saved)
    p_shard = param_shardings(mesh, cfg, api)[2]
    meta = _meta_params(cfg, api)
    shardings = (p_shard, opt_shardings(mesh, optim.init(meta, ocfg),
                                        p_shard))
    template = (meta, optim.init(meta, ocfg))

    def restore():
        tree, manifest = ckpt.restore(ckpt_dir, template,
                                      shardings=shardings, mesh=mesh)
        return manifest["step"], tree

    start, state = restore()
    restored = _leaf_digests(state[0])
    failed = []

    def one(step, st):
        if not failed:
            failed.append(step)
            raise StepFailure(f"injected at step {step}")
        return run(step, st)

    loop = FaultTolerantLoop(step_fn=one, save_fn=lambda s, st: None,
                             restore_fn=restore,
                             config=LoopConfig(checkpoint_every=1000))
    loop.run(state, start, 1)
    return dict(restored=restored, start=start, losses=losses,
                restores=loop.report.restores, failures=loop.report.failures)


def _capture_mesh_rank(rank, db_path):
    """(f): ``serve --capture --mesh 1x2`` of qwen3-8b cut in depth, then
    the same trace served uncaptured under the mesh; tokens and the B1 /
    B2 launches of the captured run a rank."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    _mesh_rank_setup(db_path)
    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              n_layers=SHARD_CAPTURE_LAYERS)
    params = None
    out = {}
    for tag, extra in (("captured", ["--capture"]), ("plain", [])):
        args = serve.parse_args(SHARD_CAPTURE_FLAGS + extra)
        _free()
        t0 = time.perf_counter()
        stats, trace, engine = serve.run(cfg, args, params=params)
        server = engine.server
        if server.mesh is None:
            raise AssertionError("sharded (f): the world did not host the "
                                 "mesh")
        params = server.params
        # the serving's own launches (the engine's counts from 0 after
        # the capture warm-up's sweep)
        out[tag] = dict(tokens=[list(r.out_tokens) for r in trace],
                        b1=stats["kernel_launches"],
                        b2=stats["attention_launches"],
                        mesh_calls=stats["mesh_calls"],
                        forwards=stats["prefills"] + stats["decode_steps"],
                        wall_s=time.perf_counter() - t0)
        del engine, server, trace
    del params
    _free()
    return out


def _sharded_rank4(rank, db_path, ckpt_dir):
    """The 4-rank world of phase sharded: (a), (b), (c) and the 2x2 half
    of (d)."""
    from repro_torch.launch.mesh import make_debug_mesh

    _mesh_rank_setup(db_path)
    out = {"a": _sharded_ops()}
    _free()
    mesh = make_debug_mesh((2, 2), ("data", "model"), device="cuda",
                           transport=MESH_TRANSPORT)
    out["b"] = _sharded_train(mesh, rank)
    _free()
    os.environ["REPRO_MOE_GROUPED"] = "1"
    out["c"] = _sharded_moe(mesh, rank)
    _free()
    out["d"] = _elastic_run(rank, (2, 2), ckpt_dir, resume=False)
    return out


def _sharded_rank2(rank, db_path, ckpt_dir):
    """The 2-rank world of phase sharded: the 1x2 half of (d), then
    (f)."""
    _mesh_rank_setup(db_path)
    out = {"d": _elastic_run(rank, (1, 2), ckpt_dir, resume=True)}
    _free()
    out["f"] = _capture_mesh_rank(rank, db_path)
    return out


def _sharded_dryrun(out_path):
    """(e), in a process of its own while the ranks run: the mesh
    dry-run's cells at pod and multi-pod, the 2x2 cell of (b) on a fake
    world, and ``perf``'s four sharding knobs on qwen3-8b train_4k."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, perf
    from repro_torch.roofline.analysis import analyze_cell, param_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    res = os.path.join(OUT, "dryrun_mesh")
    os.makedirs(res, exist_ok=True)
    out = {"cells": {}, "knobs": {}}

    def cut(arch):
        return dataclasses.replace(get_config(arch), n_layers=DRYRUN_LAYERS)

    for arch, shape in SHARD_DRYRUN_CELLS:
        one = dryrun.run_cell(arch, shape, device="cuda", cfg=cut(arch))
        for mesh in ("pod", "multipod"):
            rec = dryrun.run_cell(arch, shape, device="cuda", cfg=cut(arch),
                                  mesh=mesh)
            tag = f"{arch}__{shape}__{dryrun.MESHES[mesh][2]}"
            with open(os.path.join(res, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            row = (analyze_cell(rec, param_counts(arch, cut(arch)))
                   if rec["status"] == "ok" else {})
            out["cells"][tag] = dict(
                status=rec["status"], error=rec.get("error"),
                lower_s=rec.get("lower_s"), flops=rec.get("flops"),
                flops_x_chips_vs_one=(rec["flops"] * rec["chips"]
                                      / one["flops"]
                                      if rec["status"] == "ok" else None),
                memory=rec.get("memory"), collectives=rec.get("collectives"),
                compute_s=row.get("compute_s"), memory_s=row.get("memory_s"),
                collective_s=row.get("collective_s"))
    dense, shape = SHARD_DRYRUN_CELLS[0]
    # the four knobs on qwen3-8b, and moe_constraint where it acts: on
    # kimi-k2's MoE layers
    for arch, knob in ([(dense, k) for k in perf.MESH_KNOBS]
                       + [(MOE_ARCH, "moe_constraint")]):
        row = perf.run(arch, shape, [knob], device="cuda",
                       out=os.path.join(OUT, "perf_mesh"), baseline_dir=res,
                       cfg=cut(arch), mesh="pod")
        with open(os.path.join(OUT, "perf_mesh",
                               f"{arch}__{shape}__sp__{knob}.json")) as f:
            colls = json.load(f).get("collectives")
        out["knobs"][f"{knob} {arch}"] = dict(
            status=row["status"], vs_baseline=row.get("vs_baseline"),
            collectives=colls)
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=SHARD_LAYERS)
    rec = dryrun.run_cell("qwen3-8b", "train_4k", device="cuda", cfg=cfg,
                          shape=ShapeConfig("train", SHARD_SEQ, SHARD_BATCH,
                                            "train"), mesh="2x2")
    out["b_2x2"] = dict(status=rec["status"], error=rec.get("error"),
                        collectives=rec.get("collectives"))
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)


def phase_sharded(smi, train_summary):
    """Steps on DTensor-sharded parameters, on ranks that share the card
    over gloo: one world of 4 for (a) the four ops' sharding rules, (b)
    the sharded train step, (c) the sharded MoE step and the 2x2 half of
    (d), one of 2 for (d)'s elastic restart on 1x2 and (f) capture on a
    mesh; (e) the mesh dry-run runs meanwhile in a process of its own.
    The parent built every kernel already; a rank that fails or hangs
    fails the phase."""
    import chip_smoke as cs  # the ranks import their bodies by this name

    from repro_torch.launch.mesh import spawn_ranks

    _free()
    db = os.path.join(OUT, "plans_sharded.json")
    ckpt_dir = os.path.join(OUT, "ckpt_sharded")
    dry_path = os.path.join(OUT, "sharded_dryrun.json")
    dry = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "import chip_smoke as c; c._sharded_dryrun(%r)" % (SRC, dry_path)],
        cwd=HERE)
    try:
        t0 = time.perf_counter()
        four = spawn_ranks(cs._sharded_rank4, 4, (db, ckpt_dir),
                           store_dir=OUT, timeout_s=600)
        four_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        two = spawn_ranks(cs._sharded_rank2, 2, (db, ckpt_dir),
                          store_dir=OUT, timeout_s=420)
        two_s = time.perf_counter() - t1
        if dry.wait(timeout=600) != 0:
            raise AssertionError(f"sharded (e): the dry-run process exited "
                                 f"{dry.returncode}")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    with open(dry_path) as f:
        e = json.load(f)
    r0 = four[0]
    for row in r0["a"]:
        print(f"[sharded] (a) {row['op']} {row['shape']} {row['dtype']} on "
              f"DTensors over the 2x2 mesh: {row['pairs']} strategy pairs, "
              f"one launch a call a rank at local extents, max scaled err vs "
              f"single-card and plain {row['err']:.3g} (TOL "
              f"{TOL[row['dtype']][0]}) ({smi})", flush=True)
    b = r0["b"]
    full, check, single = b["full"], b["check"], b["single"]
    per_step = B1_PER_LAYER_STEP * SHARD_LAYERS * SHARD_STEPS
    for rank, out in enumerate(four):
        got = out["b"]["full"]
        if not all(map(math.isfinite, got["losses"])):
            raise AssertionError(f"sharded (b) rank {rank}: losses "
                                 f"{got['losses']}")
        if got["launches"] != per_step:
            raise AssertionError(f"sharded (b) rank {rank}: B1 "
                                 f"{got['launches']}, want {per_step}")
    for got, want in zip(check["losses"], single["losses"]):
        if abs(got - want) > TOL["bfloat16"][1] + TOL["bfloat16"][0] * abs(
                want):
            raise AssertionError(f"sharded (b): {SHARD_CHECK_LAYERS}-layer "
                                 f"losses {check['losses']} vs rank 0 alone "
                                 f"{single['losses']}")
    want_coll = e["b_2x2"]["collectives"]
    got_coll = full["collectives"]
    if e["b_2x2"]["status"] != "ok" or got_coll != want_coll:
        raise AssertionError(f"sharded (b): collective bytes a rank "
                             f"{got_coll} vs the 2x2 dry-run {e['b_2x2']}")
    single_peak = train_summary.get("max_memory_allocated")
    print(f"[sharded] (b) train qwen3-8b width, {SHARD_LAYERS} of 36 layers, "
          f"2x2 tp, batch {SHARD_BATCH} x {SHARD_SEQ}, f32 moments: losses "
          f"{[round(v, 4) for v in full['losses']]}; B1 {full['launches']} "
          f"launches a rank = {B1_PER_LAYER_STEP} x {SHARD_LAYERS} x "
          f"{SHARD_STEPS}; step ms {[round(v, 1) for v in full['step_ms']]} "
          f"(steady {full['steady_ms']:.1f}); peak "
          f"{full['peak'] / 2**30:.2f} GiB a rank vs the single-card "
          f"{TRAIN_LAYERS}-layer step's {single_peak / 2**30:.2f} GiB "
          f"(ratio {full['peak'] / single_peak:.3f}); collective bytes a "
          f"rank a step {got_coll} = the 2x2 dry-run's exactly; "
          f"{SHARD_CHECK_LAYERS}-layer losses "
          f"{[round(v, 5) for v in check['losses']]} vs rank 0 alone "
          f"{[round(v, 5) for v in single['losses']]} (bf16 TOL) ({smi})",
          flush=True)
    c = r0["c"]
    n_moe = MOE_LAYERS - 1
    for key, how in (("", "tokens gathered"),
                     ("constraint_", "REPRO_MOE_CONSTRAINT=1, all-to-all")):
        for rank, out in enumerate(four):
            got = (out["c"][key + "grouped"], out["c"][key + "grouped_dw"])
            if got != (B3_PER_MOE_STEP * n_moe, B4_PER_MOE_STEP * n_moe):
                raise AssertionError(f"sharded (c) {how} rank {rank}: "
                                     f"B3 / B4 {got}")
        loss, colls = c[key + "loss"], c[key + "collectives"]
        if abs(loss - c["single_loss"]) > TOL["bfloat16"][1] + \
                TOL["bfloat16"][0] * abs(c["single_loss"]):
            raise AssertionError(f"sharded (c) {how}: loss {loss} vs rank "
                                 f"0 alone {c['single_loss']}")
        if key and not colls["all-to-all"]:
            raise AssertionError(f"sharded (c) {how}: no all-to-all ran")
        print(f"[sharded] (c) train {MOE_ARCH} cut ({MOE_LAYERS} layers, "
              f"{MOE_TRAIN_EXPERTS} experts on model), REPRO_MOE_GROUPED=1, "
              f"{how}, 1 x {SHARD_MOE_SEQ} tokens: B3 {c[key + 'grouped']} "
              f"/ B4 {c[key + 'grouped_dw']} launches a rank at "
              f"{MOE_TRAIN_EXPERTS // 2} local groups; loss {loss:.5f} vs "
              f"rank 0 alone {c['single_loss']:.5f} (bf16 TOL); step "
              f"{c[key + 'step_ms']:.1f} ms; peak "
              f"{c[key + 'peak'] / 2**30:.2f} GiB a rank; collective bytes "
              f"a rank {json.dumps(colls)} ({smi})", flush=True)
    d4, d2 = r0["d"], two[0]["d"]
    on_disk = _ckpt_digests(ckpt_dir, 2)
    for rank, out in enumerate(two):
        if out["d"]["restored"] != d4["saved"] or on_disk != d4["saved"]:
            raise AssertionError(f"sharded (d) rank {rank}: the restored "
                                 f"parameters differ from the saved ones")
    want = d4["losses"][2]
    got = d2["losses"][2]
    if d2["start"] != 2 or d2["restores"] != 1 or d2["failures"] != 1:
        raise AssertionError(f"sharded (d): resumed at {d2['start']}, "
                             f"{d2['failures']} failure(s), "
                             f"{d2['restores']} restore(s)")
    if abs(got - want) > TOL["bfloat16"][1] + TOL["bfloat16"][0] * abs(want):
        raise AssertionError(f"sharded (d): step 3 on 1x2 {got} vs 2x2 "
                             f"uninterrupted {want}")
    print(f"[sharded] (d) elastic: qwen3-8b smoke trained 3 steps on 2x2 "
          f"(checkpoint at step 2), restarted as 1x2: restored at step "
          f"{d2['start']}, a StepFailure at step 2 restored and replayed "
          f"({d2['restores']} restore); every parameter leaf restored bit "
          f"for bit ({len(on_disk)} leaves, = the file); step 3 loss "
          f"{got:.6f} vs 2x2 "
          f"uninterrupted {want:.6f} (bf16 TOL) ({smi})", flush=True)
    for tag, cell in e["cells"].items():
        if cell["status"] != "ok":
            raise AssertionError(f"sharded (e) {tag}: {cell}")
        mem = cell["memory"]
        colls = cell["collectives"]
        print(f"[sharded] (e) dry-run {tag} ({DRYRUN_LAYERS} layers, fake "
              f"CUDA): ok in {cell['lower_s']} s; per device "
              f"{cell['flops'] / 1e12:.4f} TFLOP (x chips / one card "
              f"{cell['flops_x_chips_vs_one']:.3f}); peak "
              f"{mem['peak_memory_in_bytes'] / 2**30:.2f} GiB (fits 80 GB: "
              f"{mem['peak_memory_in_bytes'] < 80e9}); collectives "
              + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in
                          colls.items() if k != "count")
              + f" ({colls['count']} ops); analytic H100 compute "
              f"{cell['compute_s'] * 1e3:.2f} ms, memory "
              f"{cell['memory_s'] * 1e3:.2f} ms, collective "
              f"{cell['collective_s'] * 1e3:.2f} ms", flush=True)
    for knob, row in e["knobs"].items():
        if row["status"] != "ok":
            raise AssertionError(f"sharded (e) knob {knob}: {row}")
        deltas = row["vs_baseline"] or {}
        print(f"[sharded] (e) perf --mesh pod --knob {knob} "
              f"train_4k: " + ", ".join(
                  f"{k} {b_ * 1e3:.2f} -> {n_ * 1e3:.2f} ms"
                  for k, (b_, n_) in deltas.items()) + "; collectives "
              + json.dumps(row["collectives"]) + " (analytic)", flush=True)
    f0 = two[0]["f"]
    for rank, out in enumerate(two):
        f = out["f"]
        if f["captured"]["tokens"] != f["plain"]["tokens"]:
            raise AssertionError(f"sharded (f) rank {rank}: captured tokens "
                                 f"{f['captured']['tokens']} vs uncaptured "
                                 f"{f['plain']['tokens']}")
        per = f["captured"]["forwards"]
        want = ((7 * SHARD_CAPTURE_LAYERS + 1) * per, SHARD_CAPTURE_LAYERS)
        if (f["captured"]["b1"], f["captured"]["b2"]) != want:
            raise AssertionError(f"sharded (f) rank {rank}: B1 / B2 "
                                 f"{f['captured']['b1']} / "
                                 f"{f['captured']['b2']}, want {want}")
    print(f"[sharded] (f) serve --capture --mesh 1x2 qwen3-8b width, "
          f"{SHARD_CAPTURE_LAYERS} layers, 2 x 128 tokens + 4 new: tokens "
          f"{f0['captured']['tokens']} = uncaptured --mesh 1x2; B1 "
          f"{f0['captured']['b1']} = (7 x {SHARD_CAPTURE_LAYERS} + 1) x "
          f"{f0['captured']['forwards']} forwards, B2 "
          f"{f0['captured']['b2']} (one a layer's prefill) a rank, "
          f"{f0['captured']['mesh_calls']} mesh-bound (uncaptured B1 "
          f"{f0['plain']['b1']}, B2 {f0['plain']['b2']}, "
          f"{f0['plain']['mesh_calls']} mesh-bound); run "
          f"{f0['captured']['wall_s']:.1f} s, the capture sweep included "
          f"({smi})",
          flush=True)
    print(f"[sharded] worlds: 4 ranks {four_s:.1f} s, 2 ranks {two_s:.1f} s",
          flush=True)
    return dict(four=r0, two=two[0], dryrun=e, four_s=four_s, two_s=two_s)


def _phase(name, fn, *args, **kwargs):
    """Run one phase; print and keep its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    SECONDS[name] = time.perf_counter() - t0
    print(f"[time] {name}: {SECONDS[name]:.1f} s", flush=True)
    return out


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(src/repro_torch not found)")
    sys.path.insert(0, SRC)
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    os.makedirs(OUT, exist_ok=True)
    os.environ.setdefault("REPRO_AUTOTUNE_CACHE",
                          os.path.join(OUT, "autotune.json"))
    os.environ.setdefault("REPRO_PLAN_DB", os.path.join(OUT, "plans.json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _phase("build", phase_build)
    rows = _phase("kernel", phase_kernel)
    b1_rows = _phase("b1-train", phase_b1_train)
    grows = _phase("grouped", phase_grouped)
    dw_rows = _phase("grouped-dw", phase_grouped_dw)
    b1_mode_rows = _phase("b1-modes", phase_b1_modes)
    base_rows = _phase("baselines", phase_baselines)
    quant = _phase("b1-quant", phase_b1_quant)
    _phase("small", phase_small_model)
    os.environ["REPRO_MOE_GROUPED"] = "1"
    _phase("small-moe", phase_small_moe)
    small_train = _phase("small-train", phase_small_train)
    fused_small = _phase("fused-small", phase_fused_small)
    # the fused single-contraction ops at full width (the earlier slice)
    fused = _phase("fused-path", phase_fused_path)
    # the earlier slice's paths: ops.dense(quant=), ops.chain_dense with
    # its backward, and the small card-vs-CPU checks
    quant_path = _phase("quant-path", phase_quant_path)
    chain = _phase("chain", phase_chain)
    quant_small = _phase("quant-small", phase_quant_small)
    # this slice's path: ops.attention forward and backward through B2
    attn_small = _phase("attn-small", phase_attn_small)
    attn = _phase("attn-path", phase_attn_path)
    # the paper's HoF formalism: B1 against the interpreter, the paper's
    # tables through both executors, the variant tuner
    hof = _phase("hof", phase_hof)

    # the training paths of the earlier slice: dense, then MoE
    train, cfg, run, params, state = _phase(
        "train", phase_train, "train", "qwen3-8b", TRAIN_FLAGS,
        lambda c: dataclasses.replace(c, n_layers=TRAIN_LAYERS))
    train_profile = _phase("train-profile", phase_train_profile, "train",
                           cfg, run, params, state)
    del params, state  # free the 8-layer qwen3-8b and its moments
    _free()
    moe_train, cfg, run, params, state = _phase(
        "moe-train", phase_train, "moe-train", MOE_ARCH, MOE_TRAIN_FLAGS,
        lambda c: dataclasses.replace(
            c, n_layers=MOE_LAYERS,
            moe=dataclasses.replace(c.moe, n_experts=MOE_TRAIN_EXPERTS)))
    moe_train_profile = _phase("moe-train-profile", phase_train_profile,
                               "moe-train", cfg, run, params, state)
    del params, state
    _free()
    launches = {"contract": train["launches"]["contract"],
                "grouped": moe_train["launches"]["grouped"],
                "grouped_dw": moe_train["launches"]["grouped_dw"],
                **{k: fused["launches"][k] for k in BASELINES}}

    # the serving paths of the earlier slices
    serve_launches, stats, peak, trace, engine = _phase("serve", phase_serve)
    profiled = _phase("profile", phase_profile, engine, trace[0])
    # this slice's path: the fixed-slot server on qwen3-8b's parameters,
    # the four families only it serves, the six families card vs CPU
    fixed = _phase("fixed-serve", phase_fixed_serve, engine, stats, peak,
                   smi)
    del trace, engine  # free qwen3-8b's 16.4 GB before kimi-k2's 39.9 GB
    _free()
    families = _phase("families", phase_families, smi)
    fixed_small = _phase("fixed-small", phase_fixed_small)
    _free()
    moe_launches, moe_stats, moe_peak, moe_trace, moe_engine = _phase(
        "moe-serve", phase_moe_serve)
    moe_profiled = _phase("moe-profile", phase_profile, moe_engine,
                          moe_trace[0], tag="moe_")
    del moe_trace, moe_engine
    _free()
    # the earlier slice's serving path: weight-only int8 at full width and
    # depth
    serve_int8 = _phase("serve-int8", phase_serve_int8)
    _free()
    # this slice's path: the variant search, its ladders served
    search = _phase("search", phase_search, stats)
    _free()
    # this slice's path: the remat policies over the kernels' ops, causal
    # skip, the one-card dry-run and plan-explain
    remat = _phase("remat-dryrun", phase_remat_dryrun, smi)
    _free()
    # this slice's path: whole-model capture, the trio card vs CPU, then
    # qwen3-8b served and trained through captured steps
    captured = _phase("capture", phase_capture, smi, train)
    _free()
    # the earlier slice's path: the mesh tier on ranks that share the card
    mesh = _phase("mesh", phase_mesh, smi)
    _free()
    # this slice's path: steps on DTensor-sharded parameters
    sharded = _phase("sharded", phase_sharded, smi, train)

    line = kernels_line(rows, b1_rows, grows, dw_rows, base_rows, launches,
                        b1_mode_rows)
    line["kernels"] += new_kernel_entries(quant, quant_path, chain)
    line["kernels"].append(attention_entry(attn_small, attn))
    SECONDS["total"] = time.perf_counter() - t_start
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "cases": rows,
                   "b1_train_cases": b1_rows,
                   "grouped_cases": grows,
                   "grouped_dw_cases": dw_rows,
                   "b1_mode_cases": b1_mode_rows,
                   "baseline_cases": base_rows,
                   "fused_small": fused_small, "fused_path": fused,
                   "small_train": small_train,
                   "train": train, "train_profile": train_profile,
                   "moe_train": moe_train,
                   "moe_train_profile": moe_train_profile,
                   "serve": {k: v for k, v in stats.items()},
                   "serve_launches": serve_launches,
                   "profile": profiled,
                   "max_memory_allocated": peak,
                   "moe_serve": {k: v for k, v in moe_stats.items()},
                   "moe_launches": moe_launches,
                   "moe_profile": moe_profiled,
                   "moe_max_memory_allocated": moe_peak,
                   "b1_quant": quant, "quant_path": quant_path,
                   "chain": chain, "quant_small": quant_small,
                   "attn_small": attn_small, "attn_path": attn,
                   "hof": hof,
                   "serve_int8": serve_int8, "search": search,
                   "fixed_serve": fixed, "families": families,
                   "fixed_small": fixed_small, "remat_dryrun": remat,
                   "capture": captured, "mesh": mesh, "sharded": sharded,
                   "takes": TAKEN, "seconds": SECONDS, **line}, f, indent=1)
    # the takes each profiled check needed for a whole trace
    print(f"[takes] {json.dumps(TAKEN)}", flush=True)
    print(f"[time] phases {json.dumps({k: round(v, 1) for k, v in SECONDS.items()})}",
          flush=True)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
