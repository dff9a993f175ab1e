#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit.  Phases, one result line each:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
   registers and spills (ptxas) of the tensor-core matmul body per CTA
   tile, of the tensor-core attention body per head dim, and of the rows
   (decode) matmul body per dtype; then the L2 flush check
   (``phase_l2_flush``: fixed reads timed after the timers' flush must not
   fall under their bytes bound);
3. matmul — the matmul kernel against its plain version: every epilogue class
   at small ragged shapes (bf16 and f32), N tiles of 2 to 21 at an odd row
   pitch (``NARROW_PARITY``: a CTA over a group of tiles, w read as shifted
   aligned vectors, in every body), then minitron-4b's main-path shapes,
   timed beside the plain version and ``torch.matmul``, and under both the
   default schedule and 64x64 output tiles, each shape with its body, CTA
   tile, K split, CTA count and time over ``torch.matmul``'s in the same
   call; the 256-row shapes checked and timed on each compiled CTA tile of
   the tensor-core body (``wgmma`` where TMA reads the operands, its bits
   the same on every tile and in two runs; ``WGMMA_GROUPS``: groups of
   narrow N tiles at an aligned N); the 4-row (decode) shapes on the rows body also
   timed on the device alone (profiler), and a row's bits checked equal at
   M = 1 and M = 4 and across two runs; then rounding mode
   (``cache_write=False``: partial sums rounded to bf16 after every K tile,
   as the reference does) on the rows body at 4 rows and the tensor-core
   body at 256, K tiles of 16, 128 and 24, and the served path's rounding
   launch (recurrentgemma-2b's decode LM head, K tile 256), each against
   the plain version with the same rounding K tile (the share of elements
   that differ, the largest distance in bf16 values) and timed beside the
   same tiles with f32 sums; and the enc-dec and VLM shapes (``SLICE_MM``:
   whisper-medium's encoder at 1500 rows under the 125-row M tile,
   internvl2-26b's vision projection and decode projections);
4. attention — the flash-attention kernel against its plain version, bf16
   (tensor-core body) and f32 (CUDA-core body), each launch's body checked:
   causal, window, softcap, q_offset, GQA groups 1 and 3, ragged lengths,
   head dims 16 to 256; a prompt's rows bit-equal in one call and in two
   calls split by q_offset; then each served arch's prefill shape, timed
   beside the plain version and ``F.scaled_dot_product_attention`` (event
   time and device time), with its CTA count; and the enc-dec and VLM
   shapes (``SLICE_ATTN``: whisper-medium's non-causal encoder and
   cross-attention at prefill and at decode, Q = 1; internvl2-26b's causal
   prefill behind its vision prefix; ``NARROW_ATTN``: the 181- and
   253-token prefills of whisper-medium's decoder self- and
   cross-attention and of recurrentgemma-2b's local attention, whose
   default Q tiles of 1 and 23 rows put a group of tiles in one CTA), bf16
   and f32 against the plain version and, where the Q tile is narrower than
   Sq, bit for bit against the launch at a Q tile of Sq, bf16 timed alike;
5. scans — the rwkv6 (wkv6) and RG-LRU scan kernels against their plain
   versions, bf16 and f32, from a non-zero initial state: decode (T = 1), a
   prime T (default T tile 1), head dims 16, 32 and 64, 1 to 3 heads, 2560
   channels, a ragged 12 under a tile of 8 and 100 (element-wise staging);
   bit for bit: T = 256 under T tiles 1, 2, 8, 64, 256 and the default,
   (RG-LRU) C tiles 8, 512 and 2560, state continuation (two scans from the
   returned state equal one), a batch row at B = 1 and at B = 4, and two
   runs; then the main-path shapes, each with its CTA count from the
   kernel's geometry function, timed by events and on the device beside
   the plain versions;
6. grouped — the grouped (MoE expert) matmul kernel against its plain
   version in both classes (``moe_gemm_silu_glu``, ``moe_gemm``), bf16 and
   f32: 1, 3 and 8 experts, decode-shaped 4 rows per expert, a ragged row
   count under a tile that does not divide it (rows and tiled bodies), N
   not a multiple of 8, N-outer schedules; then mixtral-8x22b's main-path
   shapes (4 and 256 rows per expert) timed beside the plain version and
   ``torch.bmm`` (for ``moe_gemm``; no one call computes the GLU class),
   with body, CTA tile, K split and count, and at 256 rows on each compiled
   CTA tile; rounding mode on both bodies as in the matmul phase;
7. tuning — the paper's workflow on the card, every second timed by
   ``repro_torch.core.measured_runner.MeasuredRunner`` (the port's kernels
   launched under each schedule, L2 flushed, the stream held behind a sleep
   so CUDA events time the device), on the kernel lists of one 256-token
   prompt at each arch's full width: the runner checked (397x2048x2048's
   default 1-row M tiles, 16 a CTA on the rows body, and 64x64 tiles on the
   tensor cores, each timed once, ordered as the profiler's device times of
   the same launches order them wherever those differ by more than
   ``PRIME_ORDER_MARGIN``; both ratios logged; its times beside the
   profiler's device times on five shapes, the plain decode attention
   among them); one search of 32
   trials each for K2 (minitron-4b), K3 (rwkv6-1.6b) and K4
   (recurrentgemma-2b); then three pairs: starcoder2-7b and stablelm-12b
   fully tuned as donors (their records no slower than the default
   published to a ``ScheduleDB``), minitron-4b's donor picked by Eq. 1 and
   transfer-tuned from it, and minitron-4b fully tuned (a runner of its own)
   until it matches the transfer; dbrx-132b fully tuned and mixtral-8x22b
   transferred from it and fully tuned alike; recurrentgemma-2b at its
   prime 181-token prompt (default M and Q tiles of 1) from the first
   pair's donors alike.  It fails unless every
   transferred kernel is no slower than its default, every kernel (K1,
   K1g, K2, K3, K4) launched in the phase, and every schedule the searches
   chose that launches otherwise than the default, and four random ones per
   searched kernel, agree with the plain version.  Its results go on a
   line of their own, ``{"tuning": ...}``;
8. serve — minitron-4b, rwkv6-1.6b, recurrentgemma-2b, whisper-medium
   (24 encoder and 24 decoder layers, 1500 stub frames) and internvl2-26b
   (48 layers, a 256-token stub vision prefix) at full width and full
   depth, and mixtral-8x22b at full width with 8 of its 56 layers (at
   full depth its bf16 weights, ~280 GB, fit no one card); bf16, random
   weights from a seeded generator on the card, one arch after the other,
   each freed before the next loads: through
   ``repro_torch.launch.serve.main`` (``--preset full``; ``smoke`` for
   mixtral; the reference's zero frames or patch embeddings) and then the
   slot engine directly with 100-400-token prompts (whisper and internvl2
   with seeded random frames or patch embeddings as ``extras``; their
   encoder, decoder and vision-projection layers checked apart, and
   whisper's bidirectional and cross-attention launches counted per class).
   Every request must finish with its token count, the launch counts of
   the arch's kernels must be above 0 (serve.main's as it counts them; the
   engine's set to 0 just before its run and read just after), the
   engine's bf16 prefill GEMMs must all take the matmul's tensor-core body
   (its launches above 0, the CUDA-core body's bf16 launches 0), every
   rows-body launch must take its layout from ``rows_geometry`` (the M = 4
   decode layouts are reported), every bf16 attention launch must take the
   tensor-core body, and the kernel path's prefill logits must agree with
   the plain path's on the same weights, end to end and layer by layer (a
   MoE layer's tokens that the two paths route to different experts
   counted and left out).  For minitron-4b, one torch.profiler capture of
   three decode steps gives the device's busy share and its five ops with
   the most device time; a capture holding fewer kernels of a family than
   the launch counters recorded in its window is refused and taken again,
   at most ``PROFILE_TRIES`` times, and then the share is not measured
   (``capture_shortfall``).  Peak memory is read over weight init alone and
   then over serving (``init_peak_gib``, ``serve_peak_gib``).  The prime
   181-token prompt's matmul launches per body are kept (the recurrent
   archs prefill it unpadded: every default M tile is 1, all rows body);
   K2's launches on 1-row Q tiles and those that put a group of narrow
   tiles in a CTA, by Q tile, are reported: every 1-row-tile launch must be
   grouped, and an arch that prefills unbucketed must make some; likewise
   K1's and K1g's rows launches on narrow M tiles (``matmul_tile_launches``:
   every one with an M tile of at most 8 rows over more rows than one tile
   must put a group of tiles in each CTA);
9. serve_tuned — recurrentgemma-2b at full width served through a schedule
   registry (``launch.serve.make_provider``, ``--target h100``): the tuning
   phase's donor records plus one record in rounding mode (the decode LM
   head), a plan for the decode step, a warm pass (prefill lookups timed on
   the card), the deferred jobs drained, then a timed pass during which a
   record published for a decode instance makes the engine re-plan once.
   It prints the plan's tiers, lookups by tier, plan misses and the
   instances that missed, prefill seconds for the 8 prompts and for the
   181-token one against the serve phase's default run (same-call ratios),
   ms per decode step and the provider's share of a step's host time; it
   fails if the measured runner timed anything in the timed pass, if the
   prime prompt's K1 launches per body (tensor cores and rows) are not
   those its plan entries' M tiles give (none compared also fails; a
   default-tier entry on the tensor cores fails), if a non-default launch served
   disagrees with its plain version, if the prefill logits leave the serve
   bound, or if the engine did not re-plan once;
10. paged — the paged engine (``serving/paged.py``: pages of 16 tokens,
   chunked prefill of 64 tokens, two chunks a step, 4 lanes, 512-token
   contexts) serving the 8 prompts, 16 new tokens each, for minitron-4b
   (K1, K2 at q_offset > 0), rwkv6-1.6b (K1, K3 continued from its state
   chunk by chunk) and recurrentgemma-2b (K1, K4), at full width and depth,
   beside the slot engine with exact-length prefill on the same weights in
   the same call (``phase_paged``: its checks are listed there).  It prints
   per arch the prefill seconds (the chunk calls), ms per decode step and
   decode tok/s beside the slot engine's, the pool's bytes beside the slot
   cache's, the serve peak, launches per kernel and body, and the 1-row-tile
   and grouped-tile launches;
11. spec — speculative decoding on the paged engine, minitron-4b at full
   width, a self-draft of its first two layers, 3 proposals a burst, in
   three regimes (all-accept, all-reject, partial), each against plain
   paged decode on the same target (``phase_spec``).  It prints committed
   tokens per burst, ms per burst beside plain ms per step, and the K1
   bodies the verify launches took;
12. fleet — the serving fleet (``repro_torch.fleet``) at minitron-4b's full
   width and depth on its virtual clock, read from the port's kernels timed
   on the card (the ``h100`` target: ``CachedRunner(MeasuredRunner())``),
   through a registry of the tuning phase's donor records, on the seeded
   trace of 16 requests (32-356-token prompts, 8-16 new tokens): run A, two
   slot replicas of 4 slots, plan-aware routing, prefetch, default SLOs, a
   tracer; run B, one paged replica, speculative ``auto`` over a 2-layer
   self-draft (``phase_fleet``: its checks are listed there).  It prints
   per run the virtual latencies, TTFT and throughput beside the wall
   seconds and their ratio, the measured runner's timings and their wall
   seconds, the service's jobs, each replica's tiers before and after, the
   speedup ledger (A) or the acceptance per class (B), the critical path
   ``trace_report`` attributes, the launches per kernel and body, and the
   phase's peak memory.
13. train — gemma2-2b trained on the kernels, forward and backward
   (``phase_train``).  First K2's backward kernels
   (``csrc/flash_attention_bwd.cu``: bf16 on the tensor cores, f32 on the
   CUDA cores, each launch's body checked; the forward's row log-sum-exp,
   which they read, against ``ref.attention_lse``) against autograd of
   their plain version at five shapes (gemma2's heads with a 128-token
   window and softcap 50, the same global, minitron's GQA, a non-causal
   head, a prime length), bf16 and f32; then timed at gemma2's training
   shapes (and minitron's) beside its forward, its plain version, SDPA's
   forward and backward (same-call ratios) and the times of the CUDA-core
   kernels it replaced, with its CTAs per launch.
   K1's backward (dX and dW as K1 launches) against autograd of the plain
   version for every class gemma2 runs at its training shapes, the tied
   head included, dX and dW timed beside ``torch.matmul``.  Then
   ``repro_torch.launch.train.main`` at full width and full depth (26
   layers, bf16, 4 x 512 tokens, 6 steps, random weights from a seeded
   generator on the card): every loss finite and the last below the first,
   K1 and its backward launched, 26 K2 backward launches a step, every one
   on the bf16 tensor-core body, no plain version reached on the card
   (``ref.cuda_calls``); ms per step (median of
   steps 2-6), tokens/s and peak memory over the steps; its profiled step
   comes from a fresh process (below).  Then gemma2-2b at 2 layers, kernel path
   against plain path on one batch: the loss and every gradient leaf within
   the bounds stated at ``TRAIN_LOSS_REL``.  Then the 2-layer params and
   optimizer state after one step saved and restored bit for bit
   (``checkpoint.CheckpointManager``), and ``train.main`` resumed from that
   checkpoint for 2 more steps.  The ``dots`` remat policy beside ``full``
   (``dots_train``, ``dots_check``): the full-depth run again under
   ``--remat-policy dots``, its first loss bit-equal to ``full``'s, one
   gradient launch fewer per GeGLU layer a step (Z comes from the
   forward), the layers' K1 forward launches once; ms per step and peak GiB
   beside ``full``'s; at 2 layers the same agreement with the plain path
   and two steps bit-equal.  K1's Z output itself is checked in the K1
   phase, in every body (``z_output_checks``); and K1's f32 output mode at
   minitron-4b's ``wo`` at ``model`` 4 and the gradient launch's at
   gemma2-2b's GeGLU ``w_in`` dX at ``model`` 4 (ROADMAP C.13), each against
   its plain version and, rounded, bit-equal to the bf16 launch, timed
   beside it (``f32_output_checks``).
14. train_families — rwkv6-1.6b (12 of 24 layers), recurrentgemma-2b (13
   of 26), mixtral-8x22b (1 of 56 layers: one layer's ~38 GiB of state) and
   whisper-medium (24 encoder + 12 of 24 decoder layers, 1500 stub frames)
   trained on the card at full width (``phase_train_families``).  First the backward kernels of
   their paths against autograd of their plain versions at the families'
   training shapes, each gradient within K1's backward bound, two runs
   bit-equal (K3's, ``csrc/rwkv6_scan_bwd.cu``, at 4·32·512·64 and at
   T = 37 from a state passed in, a batch row bit-equal at B = 1 and
   B = 4, each of its kernels timed on the device; K4's,
   ``csrc/rglru_scan_bwd.cu``, at 4·512·2560 and T = 37, a batch row
   bit-equal at B = 1 and B = 4 and under C tiles 8, 512 and
   2560, its planned launch (CTAs, shared bytes, CTAs an SM) held to
   ``rg.bwd_geometry``, timed by events, on the device and behind a stream
   hold; K1g's, ``GroupedMatmulFn``, at mixtral's expert
   GEMMs with 2048 rows per expert; K2's at whisper's encoder, decoder and
   cross shapes, mixtral's window and recurrentgemma's local layers), timed
   beside their bounds, their plain versions, ``torch.bmm`` (K1g's dX, dW)
   and SDPA (K2).  Then per family ``repro_torch.launch.train.main``
   (``--preset full``, bf16, 4 x 512 tokens, whisper 4 x 448, 4 steps):
   losses finite, each new backward kernel launched as often as the family
   has layers that run it, every K2 backward launch on the bf16
   tensor-core body, no plain version reached on the card; ms per
   step (median of steps 2-4), tokens/s, init and peak memory; its profiled
   step comes from ``--profile-steps``.  Then the kernel path against the
   plain path at 2 layers (mixtral 1; whisper 2 + 2), the bounds of the
   train phase, and two kernel-path steps from the same weights bit-equal;
   then both again under ``dots``.
15. dist — sharded training (``repro_torch.distributed``,
   ``launch.steps.make_sharded_train_step``) at world 1 under NCCL in this
   process, over a ``FileStore`` in a temporary directory (``phase_dist``):
   gemma2-2b at full width and 2 layers, two sharded steps of each strategy
   (``dp``; ``fsdp_tp``, tensor-parallel compute, whose ``model`` axis of one
   rank moves nothing; a 1x1 mesh) against two unsharded ones on the same
   weights and batch — losses, params and optimizer state bit-equal, the
   same kernel launches, the collectives the plan's; the ``dp`` state saved
   (rank 0 writes full leaves), the group destroyed, a fresh one made and
   the state restored by ``elastic_restore``, bit-equal; then full depth,
   6 ``dp`` steps (at one card ``fsdp_tp`` does the same work, and is not
   timed again): ms per step (median of steps 2-6) beside the
   train phase's unsharded step, peak memory, and one step's collectives by
   op, count and bytes, which must be what the planner's
   ``launch.steps.plan_collectives`` gives; then minitron-4b (2 layers)
   served by ``launch.steps.make_sharded_serve_step`` on the (1, 1) mesh,
   plain and sequence-parallel, its prefill, 8 decode steps and caches
   bit-equal to the unsharded ``Model.prefill``/``decode_step``.  The
   collectives are NCCL's; no kernel is added.  Then the TP phase (``phase_tp``): tensor-parallel
   compute with 2 and 4 ranks spawned on cuda:0 over gloo (a CUDA tensor's
   collective staged through host memory, so no time is TP speed):
   gemma2-2b (2 layers, ``model`` 4: 2 q heads and 1 KV head a rank, a
   64000-row vocabulary shard), mixtral-8x22b (1 layer, ``model`` 4: 2
   experts a rank), whisper-medium (2 + 2 layers, ``model`` 4) and
   internvl2-26b (2 layers, ``model`` 4, its vocabulary whole; the step's
   gradient without AdamW's update), rwkv6-1.6b (2 layers) and
   recurrentgemma-2b (3 layers, its first attention layer's one KV head
   computed whole), ``model`` 2, at full width, bf16 and f32 (but mixtral
   and internvl2), one train step
   each, bf16's partial sums reaching every sum over ``model`` in f32
   (ROADMAP C.13): every rank's collectives the
   plan's, every kernel of the family launched, the loss and each gradient
   leaf held to the world-1 step's plain path on the card (bf16 by
   ``path_agreement``'s bounds and control, f32 by the fixed bounds); and
   first the kernels at the local shapes it gives them (K2 with 1 KV head,
   K1g with 2 experts, K4 over 640 channels) against their plain versions.
   Then the sharded-serving phase (``phase_serve_sharded``): minitron-4b (2
   layers, ``model`` 4), recurrentgemma-2b (3 layers, ``model`` 2: its KV
   head's ``head_dim`` split, decode's scores summed over ``model``),
   rwkv6-1.6b (2 layers, ``model`` 2), mixtral-8x22b (1 layer, ``model``
   4), whisper-medium (2 + 2 layers, ``model`` 4: its 1500 frames split
   too) and internvl2-26b (2 layers, ``model`` 4) at full width, ranks
   spawned on cuda:0 over gloo, each a prefill of 2 x 256 tokens and 8
   teacher-forced decode steps through ``make_sharded_serve_step``, plain
   ``fsdp_tp`` and with the prefill's S split over ``model`` (K2 at the
   rank's ``q_offset`` against gathered K/V, K3's and K4's states handed
   from rank to rank); and whisper-medium and recurrentgemma-2b with one
   row on a (2, 1) mesh, 3 decode steps merging each attention's softmax
   over ``data``: the logits held to the world-1 kernel path's by the
   serve bound, the collectives the plan's, K1's f32 output mode launched
   at ``model`` > 1.  Then ``chip_smoke.py --profile-steps`` in a fresh
   process profiles one unsharded and one sharded full-depth step of
   gemma2-2b (busy share, top five ops, the NCCL kernels' share of the busy
   time), one under ``dots``, and one step of each family of
   ``train_families``, each capture held to the launch counters as the
   decode capture is: late in the script every capture of a train step
   lost kernels.
16. examples — ``repro_torch.examples`` ``quickstart`` (step 5: K1 against
   its plain version), ``serve_lm`` and ``train_lm`` (60 steps, the loss
   falls) once on the card (``phase_examples``).
After the scans, K1 on the rows body at ``PRIME_MM`` (``phase_prime_matmul``:
the prime 397-row GEMMs and recurrentgemma-2b's 181-row projection on
1-row M tiles, 16 a CTA, and verify's 16x3072x3072), each checked against
its plain version and bit for bit against the launch at an M tile of 16,
with its M tiles a CTA, CTAs, K split, the CUDA-core floor, its event and
device times beside the plain version and ``torch.matmul``, and its device
time at passes of 4 rows; the 397- and 181-row shapes also at 64x64 tiles.
The chunk shapes of the paged path (K2: a 64-row chunk at q_offset 256 of a
512-row cache; K1: 64x3072x3072 on the tensor cores) are timed after the
grouped phase beside their plain versions, SDPA given the same boolean mask
and ``torch.matmul`` (``phase_chunk_kernels``).  Then every timed row bound
by bytes is held to its bound (``under_bytes_bound``): a time under it
means the timed call read data the flush left in the L2.

Then the tuning line, the examples line, the script's wall time, a
``phase_seconds`` line (each phase's wall seconds and the total), one JSON
line with every kernel's numbers, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --scans-ab PARENT

times the scan kernels of another tree (``PARENT``, a checkout with its
own ``src/``; say, the parent commit unpacked with ``git archive``) against
this tree's at the main-path shapes, K3's backward at rwkv6-1.6b's
training shape (each of its kernels by device time) and K4's backward at
recurrentgemma-2b's (by events, device time, held time, and held time
with no L2 flush), in turns
(parent, this, this, parent), each turn in its own process, and prints the
same-call ratios.  K4's backward also runs at T = 37 from a state and in
f32; at every shape its outputs' bits (sha256 of dx, da and the initial
state's gradient at fixed seeded inputs) must agree between the turns and
the trees, or the script fails.

    python3 chip_smoke.py --head-ab PARENT

times internvl2-26b's LM head (``INTERNVL2_HEAD``: d_model 6144, vocab
92553, so an N tile of 3) in the tree at ``PARENT`` and in this one: the
training forward at 3072 rows, its dX and dW gradient launches and the
forward at 4 rows (decode), each checked against its plain version, by
events and device time beside ``torch.matmul`` on the same operands, in
turns (parent, this, this, parent), each turn in its own process; it prints
the same-call ratios, each launch's body, CTA tile and count in both trees,
and whether the two trees' outputs (sha256 at fixed seeded inputs) have the
same bits.  A tree whose two turns give other bits fails the script.

    python3 chip_smoke.py --attn-ab PARENT

times K2 at ``NARROW_ATTN``'s shapes (each checked against its plain
version and at a Q tile of Sq) and the slot engine's stream of the serve
prompts for whisper-medium and recurrentgemma-2b at full width (each
prompt's prefill seconds, second of two runs; the 181- and 253-token
prompts' one-shot prefill, median of seven) in the tree at ``PARENT`` and
in this one, in turns (parent, this, this, parent), each turn in its own
process; it prints each K2 shape's CTAs and device times in both trees
beside SDPA, each arch's prefill seconds (all eight prompts, the 181- and
253-token ones, one-shot and in the stream), their same-call ratios, and whether every output, the
generated tokens and the 181- and 253-token prompts' prefill logits have
the same sha256 in every turn of both trees; it fails where one differs.

    python3 chip_smoke.py --rows-ab PARENT

times K1 on the rows body at ``ROWS_AB_MM`` (``PRIME_MM`` and decode's
4x3072x3072; each checked as in ``phase_prime_matmul``) and the slot
engine's stream of the serve prompts for whisper-medium, rwkv6-1.6b and
recurrentgemma-2b at full width (the 181-token prompt's one-shot prefill,
median of seven) in the tree at ``PARENT`` and in this one, in turns
(parent, this, this, parent), each turn in its own process; it prints each
K1 shape's M tiles a CTA, CTAs and device times in both trees beside
``torch.matmul`` and the CUDA-core floor, each arch's prefill seconds and
their same-call ratios, and whether every output, the generated tokens and
the 181-token prefill logits have the same sha256 in every turn of both
trees; it fails where one differs.

    python3 chip_smoke.py --mma-ab PARENT

times K1's and K1g's forward tensor-core body at ``MMA_AB_SHAPES`` (each
shape's body, CTA tile and CTAs beside ``torch.matmul`` or ``torch.bmm``),
the gradient launches of ``MMA_AB_GRADS``, one gemma2-2b train step's K1
forward device time and minitron-4b's slot-engine prefill in the tree at
``PARENT`` and in this one, in turns (parent, this, this, parent); it
prints the same-call ratios and, per output, the elements whose bits
differ between the trees, and fails where a digest differs between turns
of one tree, a ``wgmma`` shape is slower than the parent's body by device
time, or a gradient launch's bits differ from the parent's.

    python3 chip_smoke.py --profile-family ARCH

profiles one train step of a ``FAMILIES`` arch alone in a fresh process
(busy time and share, top ops) and prints each kernel's device ms a step.

    python3 chip_smoke.py --dist-ab PARENT

times gemma2-2b's full-depth ``dp`` sharded step and its unsharded step
(world 1, NCCL, 4 x 512 tokens, median of steps 2-6) for the tree at
``PARENT`` (its own ``src/``) and this one, in six turns, parent first
(``dist_ab``), and prints each turn's times and ratio.

    python3 chip_smoke.py --tp-witness

runs the TP phase's rwkv6-1.6b bf16 case (``model`` 2) three times: as the
step is, with the residual stream's sums over ``model`` taken in f32, and
with every sum over ``model`` in f32; each beside the world-1 kernel path
and the tensor-core control, the leaves with the lowest cosines
(``tp_witness``).  Any failure raises: the script
exits non-zero and prints no result.  Times come from CUDA events, each
launch after an L2 flush (the serving path reads weights cold); they
include the host's time to enqueue the call, which is most of a decode-sized
launch, so those shapes also report device time from a profiler trace.  Bounds use
the H100 SXM's published peaks: 3.35 TB/s, 989 TFLOP/s dense bf16 on the
tensor cores, and 67 TFLOP/s f32 on the CUDA cores for the scans, which run
no matrix product.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12

# Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise).
# bf16: the repo's bf16 tolerance (tests/test_kernels_matmul.py::
# test_bfloat16_tolerance), on inputs scaled so outputs are of order one: both
# sides sum exact bf16 products in f32, in different orders, then round once
# to bf16, so they differ by at most about one bf16 ulp of the output.
# f32: the repo's f32 kernel tolerance (tests/test_kernels_*.py).
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# K1's backward at gemma2's training shapes: dX is of order 0.02-0.1, where
# an atol of 3e-2 would pass a dX 25% wrong, so each gradient is held to
# its own scale: |kernel - plain| <= 1e-2·max|plain| + 3e-2·|plain|.  Both
# sides differ by dZ's rounding to bf16 before the products (2^-9 relative)
# and one bf16 rounding of the output: a few tenths of a percent of the
# largest entry.
GRAD_SCALE_ATOL, GRAD_RTOL = 1e-2, 3e-2
# Prefill logits of the full-depth bf16 model, kernel path vs plain path:
# each of ~200 ops rounds its bf16 output in the same places on both paths,
# but f32 sums taken in other orders can round to neighbouring bf16 values,
# and those one-ulp differences (2^-8 relative) carry through the residual
# stream.  How far they grow depends on the arch: minitron-4b and
# recurrentgemma-2b keep them near 1%, but rwkv6-1.6b at random init
# amplifies any difference from layer to layer, so two plain versions that
# differ only in how they accumulate drift as far apart as the kernel path
# does.
# The bound is therefore the larger of 5% of max |plain logit| and twice
# the control: the distance from the plain path to the plain path with its
# matmuls accumulated in f64 instead of f32 (same bf16 roundings, another
# sum order and precision: what the kernels change, with no kernel in it).
LOGITS_REL_BOUND = 0.05
CONTROL_FACTOR = 2.0
# The same comparison without the drift: each layer, run by both paths on
# the plain path's input to that layer, must give a block output (the
# layer's output minus its input) within 2% relative L2 of the plain
# path's.  One layer rounds a handful of ops to bf16 in the same places on
# both paths, a few tenths of a percent apart.
LAYER_REL_BOUND = 0.02
# Scan states, kernel vs plain.  The state is f32 on both sides, computed
# from the same f32 (or bf16-exact) inputs, in the same order over tokens;
# the two differ only where the kernel fuses a multiply and an add into
# one rounding (about one f32 ulp per step), and each step's error is
# damped by the decay (w, a < 1).  So the state is held at the f32
# tolerance whatever the input dtype; y at its dtype's tolerance.
STATE_TOL = F32_TOL

MAIN_KN = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072), (3072, 256000)]
# the expert GEMMs, (class, E, K, N): mixtral-8x22b's up-GEMM (GLU, 2·d_ff
# columns in, d_ff out) and down-GEMM, then dbrx-132b's (16 experts: a w_in
# stack of 2.1e9 elements, 4.2 GB, whose expert offsets pass 2^32 bytes)
MOE_SHAPES = [("moe_gemm_silu_glu", 8, 6144, 32768), ("moe_gemm", 8, 16384, 6144),
              ("moe_gemm_silu_glu", 16, 6144, 21504), ("moe_gemm", 16, 10752, 6144)]
# rows per expert on the main path: decode (4 slots, dropless cap = tokens)
# and a 256-token prefill bucket
MOE_ROWS = (4, 256)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def import_port(src: Path = ROOT / "src"):
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: the port is not beside this script ({src}/repro_torch)")
    sys.path.insert(0, str(src))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median of per-launch CUDA-event times, each launch after an L2 flush:
    128 MiB zeroed, as the measured runner flushes (``flush``: another
    callable, or None for none; ``flush_kernel``, a substring of its
    kernel's name, which device traces leave out)."""

    def __init__(self, torch, flush="zero", flush_kernel=None):
        self.torch = torch
        if flush == "zero":
            flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda").zero_
        self.flush = flush or (lambda: None)
        self.flush_kernel = flush_kernel

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def _kernels(self, fn, iters: int) -> tuple[collections.Counter, collections.Counter]:
        """One torch.profiler capture of ``iters`` calls, each after an L2
        flush: the launches and the summed microseconds per kernel name (the
        flush's own kernel, fills and memsets left out)."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush()
                fn()
            torch.cuda.synchronize()
        names, us = collections.Counter(), collections.Counter()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "FillFunctor" not in e.name and "Memset" not in e.name
                    and (self.flush_kernel is None or self.flush_kernel not in e.name)):
                names[e.name] += 1
                us[e.name] += e.time_range.elapsed_us()
        return names, us

    def device_ms(self, fn, iters: int = 10, captures: int = 3) -> float | None:
        """Mean device time per call: the summed durations of the kernels one
        call launches, each call after an L2 flush, from a torch.profiler
        trace (the flush's own kernel left out).  Unlike :meth:`ms`, it leaves
        out the host's time to enqueue the call.  Captures now and then drop
        device events (all of them, or all but the first calls' worth): a
        capture counts only if it holds ``iters`` times the kernels of a
        capture of one call, name by name; else both are taken again, up to
        ``captures`` times, and then the time is not measured (None)."""
        per = self.kernel_ms(fn, iters, captures)
        return sum(per.values()) if per is not None else None

    def kernel_ms(self, fn, iters: int = 10, captures: int = 3) -> dict | None:
        """Mean device ms per call of each kernel one call launches, by
        name, from the captures :meth:`device_ms` takes (None: not
        measured)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(captures):
            one, _ = self._kernels(fn, 1)
            names, us = self._kernels(fn, iters)
            if one and names == collections.Counter({k: n * iters for k, n in one.items()}):
                return {name: t / iters / 1e3 for name, t in us.items()}
            log("device_ms_capture_dropped", one_call=dict(one), **{f"{iters}_calls": dict(names)})
        log("device_ms_not_measured", captures=captures)
        return None

    def held_ms(self, fn, iters: int = 10, hold_cycles: int = 2_000_000) -> float:
        """Median device time of one call, without the profiler: after the
        flush the stream is held by ``torch.cuda._sleep`` (~1 ms) before the
        start event, so the host enqueues the call while the device waits
        and the events time its kernels back to back, not the host's issue."""
        torch = self.torch
        fn()
        times = []
        for _ in range(iters):
            self.flush()
            torch.cuda._sleep(hold_cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ratio(a: float | None, b: float | None) -> float | None:
    """a / b, or None where either was not measured."""
    return a / b if a is not None and b else None


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(torch, got, want, tol: dict, what: str) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if bool((err > lim).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} exceeds atol {tol['atol']} "
                             f"+ rtol {tol['rtol']}·|plain|")
    return float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


#: kernels whose registers and spills the build phase reports (each
#: instantiation: CTA tiles, head dims, dtypes, rounding mode)
BUILD_BODIES = ("matmul_wgmma_kernel", "matmul_mma_kernel", "attention_mma_kernel",
                "matmul_rows_kernel", "matmul_rows_round_kernel", "attention_bwd_dq_mma_kernel",
                "attention_bwd_dkv_mma_kernel", "attention_bwd_dq_fma_kernel",
                "attention_bwd_dkv_fma_kernel", "rwkv6_scan_bwd_walk_kernel",
                "rwkv6_scan_bwd_kernel", "rglru_scan_bwd_kernel", "matmul_grad_wgmma_kernel",
                "matmul_grad_mma_kernel", "matmul_grad_fma_kernel")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    usage = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=time.monotonic() - t0, library=path.name, ptxas=usage)
    # registers and spills of the tensor-core bodies (per compiled CTA tile
    # or head dim) and of the rows body, per dtype
    bodies, name = {}, None
    for ln in _build.build_log.splitlines():
        for marker in ("Compiling entry function '", "Function properties for "):
            if marker in ln:
                name = ln.split(marker, 1)[1].strip().strip("'")
        if name and ("registers" in ln or "spill" in ln):
            for kernel in BUILD_BODIES:
                if kernel in name:
                    bodies.setdefault(kernel, {}).setdefault(name, []).append(ln.strip())
    for kernel in BUILD_BODIES:
        if kernel not in bodies:
            raise AssertionError(f"the build log shows no {kernel}")
        log(f"build_{kernel}", ptxas=bodies[kernel])


#: a timed row's fields held to its bytes bound
TIMED_FIELDS = ("ms", "device_ms", "held_ms", "plain_ms", "library_ms", "library_device_ms",
                "library_held_ms", "tile64_ms", "tile64_device_ms")


def under_bytes_bound(rows) -> list:
    """The timings of rows bound by bytes that fall under that bound: a read
    from memory cannot, so the timed call found its data in the L2, which
    the flush before it should have evicted."""
    return [{k: r.get(k) for k in ("class", "kind", "arch", "M", "K", "N", "S", "Sq", "T")
             if r.get(k) is not None} | {"field": f, "ms": r[f], "bound_ms": r["bound_ms"]}
            for r in rows if r.get("bound_by") == "bytes"
            for f in TIMED_FIELDS if r.get(f) is not None and r[f] < r["bound_ms"]]


def phase_l2_flush(torch) -> dict:
    """Does the timers' flush evict what the timed call reads?  Two fixed
    reads, each timed hot (no flush), after the timers' flush (zeroing 128
    MiB, a write-only memset: ``Timer`` and ``MeasuredRunner``) and after a
    read-modify-write (bitwise not) of 256 MiB, by events and on the device:
    the sum of a 24 MiB buffer and ``torch.matmul`` at the chunk shape
    64x3072x3072 (w is 18 MiB), both under the card's 50 MB L2.  A read from
    memory takes at least its bytes over the HBM rate, so a time under that
    bound means the data came from the L2.  It fails if a read after the
    timers' flush falls under its bound."""
    g = torch.Generator(device="cuda").manual_seed(23)
    buf = torch.randn(12 * 2 ** 20, generator=g, device="cuda").to(torch.bfloat16)
    x = torch.randn((64, 3072), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3072, 3072), generator=g, device="cuda") / 3072 ** 0.5).to(torch.bfloat16)
    rmw = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timers = {"none": Timer(torch, flush=None), "zero_128MiB": Timer(torch),
              "rmw_256MiB": Timer(torch, flush=lambda: torch.bitwise_not(rmw, out=rmw),
                                  flush_kernel="bitwise_not")}
    reads = {"sum_24MiB": (lambda: buf.sum(), 2 * buf.numel()),
             "matmul_64x3072x3072": (lambda: torch.matmul(x, w),
                                     2 * (64 * 3072 + 3072 * 3072 + 64 * 3072))}
    rows = []
    for read, (fn, nbytes) in reads.items():
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        for flush, timer in timers.items():
            row = {"read": read, "flush": flush, "bytes": nbytes, "bound_ms": b_ms,
                   "ms": timer.ms(fn, iters=20), "device_ms": timer.device_ms(fn, iters=20)}
            if row["device_ms"] is None:
                raise AssertionError(f"l2 flush check: no whole profiler capture of {read}")
            row["under_bound"] = row["device_ms"] < b_ms
            rows.append(row)
            log("l2_flush", **row)
    bad = [r for r in rows if r["flush"] == "zero_128MiB" and r["under_bound"]]
    if bad:
        raise AssertionError(f"reads after the timers' flush fall under their bytes bound: {bad}")
    del buf, x, w, rmw, timers
    torch.cuda.empty_cache()
    return {"rows": rows}


def _mm_inputs(torch, g, m, n, k, class_id, dtype):
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(dtype)
    out_n = n // 2 if "glu" in class_id else n
    bias = torch.randn((n,), generator=g, device="cuda").to(dtype) if class_id in (
        "matmul_bias", "matmul_bias_gelu") else None
    residual = torch.randn((m, out_n), generator=g, device="cuda").to(dtype) \
        if class_id == "matmul_residual" else None
    softcap = 2.0 if class_id == "matmul_lmhead_softcap" else 0.0
    return x, w, dict(bias=bias, residual=residual, softcap=softcap)


@contextlib.contextmanager
def forced_cta_tile(cta):
    """The matmul's tensor-core bodies on one compiled CTA tile, whatever
    ``tiled_geometry`` would choose (to time the choice against the others)."""
    from repro_torch.kernels import matmul as mm

    chosen = mm.tiled_geometry

    def forced(m, n, tile_m, tile_n, groups=1, tiles=mm.MMA_CTA_TILES):
        if cta not in tiles:
            raise AssertionError(f"{cta} is not among the body's CTA tiles {tiles}")
        return (*cta, mm.cta_count(m, n, tile_m, tile_n, *cta))

    mm.tiled_geometry = forced
    try:
        yield
    finally:
        mm.tiled_geometry = chosen


def time_cta_tiles(torch, timer, launch, want, what, body, iters=10) -> dict:
    """Each compiled CTA tile of the tensor-core ``body``: checked against
    the plain version, then timed; {"MxN": ms}.  On the wgmma body the
    launch's bits must be the same on every tile and in two runs (no
    output's sum depends on which rows or columns share its CTA)."""
    from repro_torch.kernels import matmul as mm

    out, first = {}, None
    for cta in mm.CTA_TILES[body]:
        with forced_cta_tile(cta):
            got, again = launch(), launch()
            assert_close(torch, got, want, BF16_TOL, f"{what} on {cta} CTA tiles")
            torch.cuda.synchronize()
            if body == "wgmma":
                first = got if first is None else first
                if not (torch.equal(got, again) and torch.equal(got, first)):
                    raise AssertionError(f"{what}: the wgmma body's bits on {cta} CTA tiles differ "
                                         f"from another run or from {mm.CTA_TILES[body][0]}")
            del got, again
            out["x".join(map(str, cta))] = timer.ms(launch, iters=iters)
    return out


#: rounding mode (``cache_write=False``), per kernel: (class, body, E,
#: rows per expert, K, N, M tile, K tiles).  Each bf16 body at K tiles of 16
#: and 128, and 24, not a multiple of 16 (an MMA step that a tile boundary
#: crosses is split): K1 at minitron's q/o projection, K1g at 8 experts of
#: 3072x1024; and the launch the registry-served path makes in rounding
#: mode, recurrentgemma-2b's decode LM head at its default K tile of 256
ROUND_CASES = {
    "matmul": (("matmul", "rows", None, 4, 3072, 3072, 4, (16, 128, 24)),
               ("matmul", "mma", None, 256, 3072, 3072, 128, (16, 128, 24)),
               ("matmul_lmhead", "rows", None, 4, 2560, 256000, 4, (256,))),
    "moe_gemm": (("moe_gemm", "rows", 8, 4, 3072, 1024, 4, (16, 128, 24)),
                 ("moe_gemm", "mma", 8, 256, 3072, 1024, 128, (16, 128, 24)))}
#: the served path's rounding-mode launch among ROUND_CASES (class, M, K, N, K tile)
ROUND_SERVED = ("matmul_lmhead", 4, 2560, 256000, 256)
#: ulps are counted where |plain| is at least this (outputs are of order
#: one; near zero a sign flip spans thousands of bf16 values for a tiny |err|)
ULP_FLOOR = 2 ** -4


def bf16_ulps(torch, a, b):
    """Per element, how many bf16 values lie between bf16 tensors a and b."""
    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def rounding_cases(torch, timer, family: str) -> list:
    """The kernel in rounding mode on each bf16 body: against the plain
    version with the same ``round_k`` (bf16 tolerance; the share of
    elements that differ and the largest distance in bf16 values), the
    plain version's own distance from f32 sums (what the rounding changes),
    and its time beside the same tiles with f32 sums (``scratch_ms``)."""
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for class_id, body, e, m, k, n, tile_m, k_tiles in ROUND_CASES[family]:
        kernel = "matmul" if e is None else "grouped_matmul"
        if e is None:
            x, w, _ = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
            inst = ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k)
        else:
            x, w = _grouped_inputs(torch, g, e, m, n, k, torch.bfloat16)
            inst = ops.instance(class_id, torch.bfloat16, M=m * e, N=n, K=k, E=e)
        for tile_k in k_tiles:
            tiles = {"M": tile_m, "N": 512, "K": tile_k, **({} if e is None else {"E": 1})}
            cs = concretize(Schedule.make(class_id, tiles, cache_write=False), inst)
            scratch = concretize(Schedule.make(class_id, tiles), inst)
            if mm.round_k_for(cs) != tile_k or mm.round_k_for(scratch) != 0:
                raise AssertionError(f"{class_id} {tiles}: round_k {mm.round_k_for(cs)}")
            if mm.launch_geometry(torch.bfloat16, m, n, k, tile_m, 512, e or 1, tile_k)[0] != body:
                raise AssertionError(f"{class_id} {tiles}: not the {body} body")

            def launch(c, cid=class_id):
                return (mm.launch(x, w, c, class_id=cid) if e is None
                        else mm.grouped_launch(x, w, c, class_id=cid))

            def plain(rk=tile_k, cid=class_id):
                return (ref.matmul(x, w, cid, round_k=rk) if e is None
                        else ref.grouped_matmul(x, w, cid, round_k=rk))
            name = f"{class_id} rounding {body} M{m} K{k} tile {tile_k}"
            before = mm.round_launches[kernel, body]
            got, want, f32 = launch(cs), plain(), plain(0)
            if mm.round_launches[kernel, body] != before + 1:
                raise AssertionError(f"{name}: no rounding-mode launch of the {body} body")
            err = assert_close(torch, got, want, BF16_TOL, name)
            ulps = bf16_ulps(torch, got, want)[want.float().abs() >= ULP_FLOOR]
            b_ms, b_by = bound_ms(2 * (e or 1) * (m * k + k * n + m * n), 2 * (e or 1) * m * n * k)
            row = {"class": class_id, "E": e, "M": m, "K": k, "N": n, "tiles": cs.t, "body": body,
                   "round_k": tile_k, "max_abs_err": err,
                   "differ_share": float((got != want).float().mean()),
                   "max_ulps": int(ulps.max()) if ulps.numel() else 0,
                   "plain_vs_f32_differ_share": float((want != f32).float().mean()),
                   "plain_vs_f32_max_abs": max_err(torch, want, f32),
                   "ms": timer.ms(lambda: launch(cs)),
                   "scratch_ms": timer.ms(lambda: launch(scratch)),
                   "plain_ms": timer.ms(plain, iters=3, warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by,
                   # no one library call rounds partial sums per K tile
                   "library_ms": None}
            row["round_over_scratch"] = row["ms"] / row["scratch_ms"]
            rows.append(row)
            log("matmul_rounding", **row)
            del got, want, f32
        del x, w
    torch.cuda.empty_cache()
    return rows


#: K1's Z output (``launch(..., with_z=True)``, the ``dots`` remat policy's),
#: per body (the name's first word): (name, class, dtype, M, K, N, schedule
#: tiles or None for the default, cache_write).  The rows body unsplit
#: (gemma2's GeGLU up at 4 rows) and split over K (N = 256), in f32, and in
#: rounding mode; the wgmma body at gemma2's training up projection,
#: whisper's gelu with a bias, a ragged aligned shape and a 64-row tile;
#: the mma body at rows of x off 16 bytes (K = 33) and in rounding mode,
#: its K tile of 24 splitting an MMA step; the CUDA-core body (f32)
Z_CASES = (("rows", "matmul_gelu_glu", "bfloat16", 4, 2304, 18432, None, True),
           ("rows_split_k", "matmul_silu_glu", "bfloat16", 4, 3072, 256, None, True),
           ("rows_f32", "matmul_bias_gelu", "float32", 4, 64, 200, None, True),
           ("rows_round", "matmul_bias_gelu", "bfloat16", 4, 3072, 1024,
            {"M": 4, "N": 512, "K": 128}, False),
           ("wgmma", "matmul_gelu_glu", "bfloat16", 2048, 2304, 18432, None, True),
           ("wgmma_bias", "matmul_bias_gelu", "bfloat16", 1500, 1024, 4096, None, True),
           ("wgmma_ragged", "matmul_silu_glu", "bfloat16", 70, 40, 200, None, True),
           ("wgmma_64", "matmul_gelu_glu", "bfloat16", 64, 512, 1024,
            {"M": 64, "N": 256, "K": 512}, True),
           ("mma_ragged", "matmul_silu_glu", "bfloat16", 70, 33, 200, None, True),
           ("mma_round", "matmul_bias_gelu", "bfloat16", 256, 3072, 1024,
            {"M": 128, "N": 512, "K": 24}, False),
           ("fma", "matmul_bias_gelu", "float32", 130, 300, 96, None, True),
           ("fma_glu", "matmul_silu_glu", "float32", 70, 33, 200, None, True))


def z_output_checks(torch, timer) -> list:
    """K1's Z output in every body (:data:`Z_CASES`): Z bit-equal to the
    ``matmul`` (with a bias, ``matmul_bias``) launch of the same schedule
    key, Y's bits the same with and without Z, Z within its dtype's
    tolerance of the plain version; and at gemma2's up projection, the
    launch timed with and without Z (the Z write's cost)."""
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(41)
    rows = []
    for name, class_id, dt, m, k, n, tiles, cache_write in Z_CASES:
        dtype = getattr(torch, dt)
        x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, dtype)
        inst = ops.instance(class_id, dtype, M=m, N=n, K=k)
        cs = (ops.schedule_for(inst) if tiles is None else
              concretize(Schedule.make(class_id, tiles, cache_write=cache_write), inst))
        key = mm.launch_key(x, w, cs, class_id=class_id, **kw)
        body = mm.launch_geometry(dtype, m, n, k, key[0], key[1], round_k=key[3])
        want_body = name.split("_")[0]
        if body[0] != want_body or ("round" in name) != bool(key[3]) or (
                ("split" in name) != (body[3] > 1)):
            raise AssertionError(f"Z check {name}: launch {body}, round_k {key[3]}")
        y0 = mm.launch_as(x, w, key, class_id=class_id, **kw)
        y1, z = mm.launch_as(x, w, key, class_id=class_id, with_z=True, **kw)
        plain_class = "matmul" if kw["bias"] is None else "matmul_bias"
        zk = mm.launch_as(x, w, key, class_id=plain_class, bias=kw["bias"], residual=None,
                          softcap=0.0)
        torch.cuda.synchronize()
        same_y = torch.equal(y0.view(torch.uint8), y1.view(torch.uint8))
        same_z = torch.equal(z.view(torch.uint8), zk.view(torch.uint8))
        if not (same_y and same_z):
            raise AssertionError(f"Z check {name}: Y bits unchanged {same_y}, Z bit-equal to "
                                 f"the {plain_class} launch {same_z}")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = assert_close(torch, z, ref.matmul(x, w, plain_class, bias=kw["bias"],
                                                round_k=key[3]), tol, f"Z {name} vs plain")
        row = {"name": name, "class": class_id, "dtype": dt, "M": m, "K": k, "N": n,
               "key": list(key), "body": body[0], "split_k": body[3], "ctas": body[4],
               "z_bits_equal": same_z, "y_bits_unchanged": same_y, "max_abs_err": err}
        if name == "wgmma":   # gemma2's GeGLU up projection at the training batch
            b_ms, b_by = bound_ms(2 * (m * k + k * n + m * n // 2 + m * n), 2 * m * n * k)
            row.update(without_z_ms=timer.ms(lambda: mm.launch_as(x, w, key, class_id=class_id, **kw)),
                       ms=timer.ms(lambda: mm.launch_as(x, w, key, class_id=class_id, with_z=True,
                                                        **kw)),
                       plain_ms=timer.ms(lambda: ref.matmul(x, w, class_id, with_z=True, **kw),
                                         iters=3, warmup=1),
                       bound_ms=b_ms, bound_by=b_by,
                       # no one library call computes a GLU epilogue
                       library_ms=None)
        rows.append(row)
        del x, w, kw, y0, y1, z, zk
    torch.cuda.empty_cache()
    log("matmul_z", cases=rows)
    return rows


#: the parity sweep's narrow N tiles at an odd row pitch (N = 457 or 92553:
#: each row of w starts at another byte offset mod 16), a CTA covering a
#: group of tiles, w read as shifted aligned vectors: (class, M, N, K,
#: tiles, cache_write).  The rows body (K split; in rounding mode, bf16),
#: the tensor-core body (bf16; f32: the CUDA-core body) plain and in
#: rounding mode, a GLU at an N tile of 2, internvl2-26b's N tile of 3 at
#: its full vocab
#: the wgmma body over groups of narrow N tiles at an aligned N (each
#: group's first column on 16 bytes): (class, M, N, K, tiles)
WGMMA_GROUPS = (("matmul", 200, 1024, 136, {"M": 64, "N": 24, "K": 136}),
                ("matmul_gelu_glu", 130, 512, 64, {"M": 64, "N": 16, "K": 64}),
                ("matmul_bias", 300, 4096, 256, {"M": 128, "N": 40, "K": 256}))
NARROW_PARITY = (("matmul", 4, 457, 640, {"M": 4, "N": 3, "K": 640}, True),
                 ("matmul", 4, 457, 640, {"M": 4, "N": 7, "K": 32}, False),
                 ("matmul_lmhead", 300, 457, 192, {"M": 128, "N": 3, "K": 192}, True),
                 ("matmul_bias", 100, 457, 96, {"M": 64, "N": 21, "K": 32}, False),
                 ("matmul_silu_glu", 70, 458, 96, {"M": 64, "N": 2, "K": 96}, True),
                 ("matmul_lmhead", 4, 92553, 256, {"M": 4, "N": 3, "K": 256}, True))


def phase_matmul(torch, timer) -> dict:
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    # every epilogue class, ragged shapes (rows body: M tile <= 16; tiled: above;
    # N not a multiple of 8, or an N tile of 500, takes the shifted read of w),
    # bf16 and f32; then a custom schedule and NARROW_PARITY
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for class_id in ref.MATMUL_CLASSES:
            for m, n, k in ((5, 40, 24), (3, 50, 17), (4, 1000, 64), (70, 200, 33), (130, 96, 300),
                            (70, 200, 72), (130, 96, 304), (300, 576, 1000), (64, 256, 136)):
                x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, dtype)
                cs = ops.schedule_for(ops.instance(class_id, dtype, M=m, N=n, K=k))
                got = mm.launch(x, w, cs, class_id=class_id, **kw)
                want = ref.matmul(x, w, class_id, **kw)
                name = f"{class_id}/{ops.dtype_name(dtype)}/{m}x{n}x{k}"
                errs[name] = assert_close(torch, got, want, tol, name)
        # a non-default schedule: N-outer rasterisation, ragged M and N tiles
        inst = ops.instance("matmul_silu_glu", dtype, M=37, N=100, K=64)
        cs = concretize(Schedule.make("matmul_silu_glu", {"M": 16, "N": 48, "K": 32},
                                      order=("N", "M", "K")), inst)
        x, w, kw = _mm_inputs(torch, g, 37, 100, 64, "matmul_silu_glu", dtype)
        errs[f"custom_schedule/{ops.dtype_name(dtype)}"] = assert_close(
            torch, mm.launch(x, w, cs, class_id="matmul_silu_glu", **kw),
            ref.matmul(x, w, "matmul_silu_glu", **kw), tol, "custom schedule")
        for cid, m, n, k, tiles, cache_write in NARROW_PARITY:
            cs = concretize(Schedule.make(cid, tiles, cache_write=cache_write),
                            ops.instance(cid, dtype, M=m, N=n, K=k))
            x, w, kw = _mm_inputs(torch, g, m, n, k, cid, dtype)
            name = f"narrow/{cid}/{ops.dtype_name(dtype)}/{m}x{n}x{k}/N tile {tiles['N']}"
            errs[name] = assert_close(torch, mm.launch(x, w, cs, class_id=cid, **kw),
                                      ref.matmul(x, w, cid, round_k=mm.round_k_for(cs), **kw),
                                      tol, name)
        for cid, m, n, k, tiles in WGMMA_GROUPS:
            cs = concretize(Schedule.make(cid, tiles), ops.instance(cid, dtype, M=m, N=n, K=k))
            x, w, kw = _mm_inputs(torch, g, m, n, k, cid, dtype)
            body, _, cta_n, _, _ = mm.launch_geometry(dtype, m, n, k, tiles["M"], tiles["N"])
            if body != ("wgmma" if dtype == torch.bfloat16 else "fma") or (
                    body == "wgmma" and mm.n_group(n, tiles["N"], cta_n) < 2):
                raise AssertionError(f"{cid} {m}x{k}x{n} at N tile {tiles['N']}: {body}, "
                                     f"{cta_n}-column CTAs")
            name = f"wgmma_groups/{cid}/{ops.dtype_name(dtype)}/{m}x{n}x{k}/N tile {tiles['N']}"
            errs[name] = assert_close(torch, mm.launch(x, w, cs, class_id=cid, **kw),
                                      ref.matmul(x, w, cid, **kw), tol, name)
    log("matmul_classes", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL)

    # main-path shapes: M = slots (decode) and a prefill bucket, bf16
    shapes = []
    for m in (4, 256):
        for k, n in MAIN_KN:
            class_id = ("matmul_lmhead" if n == 256000 else
                        "matmul_bias_gelu" if n == 9216 else "matmul")
            x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
            cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k))
            got = mm.launch(x, w, cs, class_id=class_id, **kw)
            want = ref.matmul(x, w, class_id, **kw)
            err = assert_close(torch, got, want, BF16_TOL, f"{class_id} {m}x{k}x{n}")
            body = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"], cs.t["N"])[0]
            if body == "rows":   # a row's bits do not depend on M (nor on the run)
                cs1 = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=1, N=n, K=k))
                one = mm.launch(x[:1].contiguous(), w, cs1, class_id=class_id, **kw)
                again = mm.launch(x, w, cs, class_id=class_id, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(one, got[:1]) and torch.equal(again, got)):
                    raise AssertionError(f"{class_id} {m}x{k}x{n}: rows-body bits depend on M or the run")
                del one, again
            cta_ms = (time_cta_tiles(torch, timer, lambda: mm.launch(x, w, cs, class_id=class_id, **kw),
                                     want, f"{class_id} {m}x{k}x{n}", body)
                      if body in mm.CTA_TILES else None)
            del got, want
            # the same kernel under 64x64 output tiles, sized to fill the card's SMs
            cs64 = concretize(Schedule.make(class_id, {"M": 64, "N": 64, "K": cs.t["K"]}), cs.instance)
            err = max(err, assert_close(torch, mm.launch(x, w, cs64, class_id=class_id, **kw),
                                        ref.matmul(x, w, class_id, **kw), BF16_TOL, "64x64 tiles"))
            row = timed_matmul_row(torch, timer, x, w, kw, class_id, cs, err)
            row.update(cta_tile_ms=cta_ms,
                       tile64_ctas=mm.launch_geometry(x.dtype, m, n, k, cs64.t["M"], cs64.t["N"])[4],
                       tile64_ms=timer.ms(lambda: mm.launch(x, w, cs64, class_id=class_id, **kw)))
            shapes.append(row)
            log("matmul_shape", **row)
            del x, w
    torch.cuda.empty_cache()
    # the enc-dec and VLM slice's shapes: whisper-medium's encoder at 1500
    # rows (default M tile nearest_divisor(1500, 128) = 125, a logical tile
    # the tensor-core body's 64-row CTAs cover masked at its edge) and
    # internvl2-26b's vision projection and decode shapes
    for arch, class_id, m, k, n, tile_m in SLICE_MM:
        x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
        cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k))
        if tile_m is not None and cs.t["M"] != tile_m:
            raise AssertionError(f"{class_id} {m}x{k}x{n}: default M tile {cs.t['M']}, not {tile_m}")
        err = assert_close(torch, mm.launch(x, w, cs, class_id=class_id, **kw),
                           ref.matmul(x, w, class_id, **kw), BF16_TOL, f"{class_id} {m}x{k}x{n}")
        row = {"arch": arch, **timed_matmul_row(torch, timer, x, w, kw, class_id, cs, err)}
        shapes.append(row)
        log("matmul_shape", **row)
        del x, w, kw
        torch.cuda.empty_cache()
    rounding = rounding_cases(torch, timer, "matmul")
    z = z_output_checks(torch, timer)
    f32 = f32_output_checks(torch, timer)
    return {"shapes": shapes, "rounding": rounding, "z": z, "f32": f32,
            "max_abs_err": max([errs[n] for n in errs] + [r["max_abs_err"] for r in shapes])}


#: K1's f32 modes (ROADMAP C.13) at row-parallel shapes: ``y``, minitron-4b's
#: ``wo`` at model 4 (x 4 x 768 at decode, w 768 x 3072: the rows body), and
#: ``y_prefill`` at a 256-row prefill (the wgmma body); ``dx``,
#: gemma2-2b's GeGLU ``w_in`` input gradient at model 4 (dY 2048 x 4608
#: against wᵀ, w 2304 x 4608: the wgmma body)
F32_Y_SHAPE, F32_DX_SHAPE = (4, 768, 3072), (2048, 4608, 2304)
F32_Y_PREFILL_SHAPE = (256, 768, 3072)


def _library_f32(torch, a, b):
    """One PyTorch call with K1's f32 output on bf16 operands
    (``torch.mm(..., out_dtype=)``), or None where this torch has none."""
    try:
        torch.mm(a[:1], b[:, :1], out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return None
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def f32_output_checks(torch, timer) -> list:
    """K1's f32 output mode and the gradient launch's, each against its
    plain version (``ref.matmul(..., out_f32=True)``) at f32's tolerance and
    bit for bit against the bf16 launch once rounded (the same sums), timed
    beside the bf16 launch, the plain version and, where this torch has
    one, ``torch.mm`` with an f32 output."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(43)
    bf = torch.bfloat16
    rows = []
    m, k, n = F32_Y_SHAPE
    x, w, _ = _mm_inputs(torch, g, m, n, k, "matmul", bf)
    cs = ops.schedule_for(ops.instance("matmul", bf, M=m, N=n, K=k))
    pm, pk, pn = F32_Y_PREFILL_SHAPE
    xp, wp, _ = _mm_inputs(torch, g, pm, pn, pk, "matmul", bf)
    csp = ops.schedule_for(ops.instance("matmul", bf, M=pm, N=pn, K=pk))
    dm, dk, dn = F32_DX_SHAPE
    dy = torch.randn((dm, dk), generator=g, device="cuda").to(bf)
    wt = (torch.randn((dn, dk), generator=g, device="cuda") / dk ** 0.5).to(bf).T   # wᵀ, a view
    cases = (("y", lambda out_f32: mm.launch(x, w, cs, out_f32=out_f32),
              lambda: ref.matmul(x, w, out_f32=True), _library_f32(torch, x, w),
              (m, k, n), mm.launch_geometry(bf, m, n, k, cs.t["M"], cs.t["N"])[0]),
             ("y_prefill", lambda out_f32: mm.launch(xp, wp, csp, out_f32=out_f32),
              lambda: ref.matmul(xp, wp, out_f32=True), _library_f32(torch, xp, wp),
              (pm, pk, pn), mm.launch_geometry(bf, pm, pn, pk, csp.t["M"], csp.t["N"])[0]),
             ("dx", lambda out_f32: mm.grad_launch(dy, wt, out_f32=out_f32),
              lambda: ref.matmul(dy, wt, out_f32=True), _library_f32(torch, dy, wt),
              (dm, dk, dn), mm.grad_geometry(dy, wt)["body"]))
    for name, launch, plain, library, (mm_, kk, nn), body in cases:
        if name == "y_prefill" and body != "wgmma":
            raise AssertionError(f"f32 {name}: the {body} body")
        got, low = launch(True), launch(False)
        want = plain()
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got.to(bf), low):
            raise AssertionError(f"f32 {name}: dtype {got.dtype}, rounded equal to the bf16 "
                                 f"launch {torch.equal(got.to(bf), low)}")
        err = assert_close(torch, got, want, F32_TOL, f"f32 {name} vs plain")
        b_ms, b_by = bound_ms(2 * (mm_ * kk + kk * nn) + 4 * mm_ * nn, 2 * mm_ * kk * nn)
        row = {"name": name, "M": mm_, "K": kk, "N": nn, "body": body, "max_abs_err": err,
               "bits_equal_rounded": True, "ms": timer.ms(lambda: launch(True)),
               "bf16_ms": timer.ms(lambda: launch(False)),
               "plain_ms": timer.ms(plain, iters=3, warmup=1),
               "library_ms": timer.ms(library) if library else None,
               "bound_ms": b_ms, "bound_by": b_by}
        if body == "rows":   # decode: the host's time to enqueue a call is most of ms
            row["device_ms"] = timer.device_ms(lambda: launch(True))
            row["bf16_device_ms"] = timer.device_ms(lambda: launch(False))
        rows.append(row)
        del got, low, want
    del x, w, xp, wp, dy, wt
    torch.cuda.empty_cache()
    log("matmul_f32_modes", cases=rows)
    return rows


#: the slice's K1 shapes, (arch, class, M, K, N, default M tile to check):
#: whisper-medium's encoder q/k/v/o and MLP up at 1500 rows; internvl2-26b's
#: vision projection (256 patch rows) and its 4-slot decode MLP and LM head
SLICE_MM = (("whisper-medium", "matmul", 1500, 1024, 1024, 125),
            ("whisper-medium", "matmul_bias_gelu", 1500, 1024, 4096, 125),
            ("internvl2-26b", "matmul", 256, 6144, 6144, None),
            ("internvl2-26b", "matmul_silu_glu", 4, 6144, 2 * 16384, None),
            ("internvl2-26b", "matmul", 4, 16384, 6144, None),
            ("internvl2-26b", "matmul_lmhead", 4, 6144, 92553, None))


def timed_matmul_row(torch, timer, x, w, kw, class_id, cs, err) -> dict:
    """K1 under ``cs`` on (x, w): its launch geometry, its time beside the
    plain version's and, for a class with no epilogue, ``torch.matmul``'s
    (events; a rows-body launch also by device time), and its bound."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    (m, k), n = x.shape, w.shape[1]
    n_out = n // 2 if "glu" in class_id else n
    b_ms, b_by = bound_ms(2 * (m * k + k * n + m * n_out), 2 * m * n * k)
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"], cs.t["N"])
    row = {"class": class_id, "M": m, "K": k, "N": n, "tiles": cs.t,
           "logical_tiles": cs.g["M"] * cs.g["N"], "body": body,
           "cta_tile": [cta_m, cta_n], "split_k": split_k, "ctas": ctas, "max_abs_err": err,
           "ms": timer.ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw)),
           "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw)),
           # one library call computes the same function only without an epilogue
           "library_ms": (timer.ms(lambda: torch.matmul(x, w))
                          if class_id in ("matmul", "matmul_lmhead") else None),
           "bound_ms": b_ms, "bound_by": b_by}
    row["library_ratio"] = row["ms"] / row["library_ms"] if row["library_ms"] else None
    if body == "rows":   # decode: the host's time to enqueue a call is most of ms
        row["device_ms"] = timer.device_ms(lambda: mm.launch(x, w, cs, class_id=class_id, **kw))
        row["library_device_ms"] = (timer.device_ms(lambda: torch.matmul(x, w))
                                    if row["library_ms"] else None)
        row["device_ratio"] = ratio(row["device_ms"], row["library_device_ms"])
    return row


def _attn_inputs(torch, g, b, hq, hkv, sq, skv, d, dtype):
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def phase_attention(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    # (b, hkv, group, sq, skv, d, causal, window, softcap, q_offset)
    cases = [
        (2, 2, 1, 64, 64, 128, True, 0, 0.0, 0),
        (2, 2, 3, 100, 100, 128, True, 0, 0.0, 0),      # GQA 3, ragged
        (1, 2, 3, 77, 77, 128, False, 0, 0.0, 0),       # bidirectional
        (1, 2, 1, 90, 90, 128, True, 16, 0.0, 0),       # sliding window
        (1, 2, 3, 64, 64, 128, True, 0, 20.0, 0),       # softcap
        (1, 2, 1, 33, 200, 128, True, 0, 0.0, 167),     # q_offset (chunk vs cache)
        (1, 2, 3, 1, 300, 128, True, 0, 0.0, 299),      # decode-shaped
        (1, 2, 3, 45, 130, 128, True, 24, 30.0, 85),    # all masks together
        (1, 2, 2, 70, 70, 256, True, 0, 50.0, 0),       # gemma2 head dim
        (1, 2, 1, 40, 40, 256, True, 8, 0.0, 0),
        (1, 2, 2, 50, 50, 16, True, 0, 0.0, 0),         # reduced-config head dim
        (1, 1, 3, 37, 60, 80, True, 8, 0.0, 10),        # head dim padded to 128
    ]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for b, hkv, group, sq, skv, d, causal, window, softcap, q_offset in cases:
            q, k, v = _attn_inputs(torch, g, b, hkv * group, hkv, sq, skv, d, dtype)
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
            cs = ops.schedule_for(ops.instance("flash_attention_causal", dtype, Q=sq, KV=skv,
                                               H=hkv * group, D=d, B=b, window=window))
            body = fa.body_for(dtype)
            before = fa.body_count(body, dtype=dtype)
            got = fa.launch(q, k, v, cs, **kw)
            if fa.body_count(body, dtype=dtype) != before + 1:
                raise AssertionError(f"attention {dtype}: the launch did not take the {body} body")
            want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], **kw)
            name = f"{ops.dtype_name(dtype)}/g{group}/{sq}x{skv}/d{d}/{kw}"
            errs[name] = assert_close(torch, got, want, tol, name)
    log("attention_masks", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL, bodies={f"{b}/{ops.dtype_name(d)}": c
                                 for (b, d), c in sorted(fa.body_launches.items(), key=str)})

    # a prompt attended in one call and in two calls split by q_offset: the
    # same bits row for row, in both bodies
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_inputs(torch, g, 1, 24, 8, 512, 512, 128, dtype)
        whole = ops.flash_attention(q, k, v)
        first = ops.flash_attention(q[:, :, :200].contiguous(), k[:, :, :200].contiguous(),
                                    v[:, :, :200].contiguous())
        second = ops.flash_attention(q[:, :, 200:].contiguous(), k, v, q_offset=200)
        torch.cuda.synchronize()
        if not torch.equal(torch.cat([first, second], dim=2), whole):
            raise AssertionError(f"attention {dtype}: rows differ when the prompt is split by q_offset")
    log("attention_q_offset_split", bit_equal=True, split=[200, 312])

    # each served arch's prefill shape (bf16, the tensor-core body): minitron
    # at buckets 128 and 512, mixtral at bucket 512 (window 4096 > S), and
    # recurrentgemma at the engine's longest prompt (356: 89-row Q tiles),
    # window 2048 > S; its narrow-tile prompts (181, 253) are NARROW_ATTN's
    shapes = []
    for arch, b, hq, hkv, s, d, window in (("minitron-4b", 1, 24, 8, 128, 128, 0),
                                            ("minitron-4b", 1, 24, 8, 512, 128, 0),
                                            ("mixtral-8x22b", 1, 48, 8, 512, 128, 4096),
                                            ("recurrentgemma-2b", 1, 10, 1, 356, 256, 2048)):
        q, k, v = _attn_inputs(torch, g, b, hq, hkv, s, s, d, torch.bfloat16)
        cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=s, KV=s,
                                           H=hq, D=d, B=b, window=window))
        got = fa.launch(q, k, v, cs, window=window)
        want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], window=window)
        err = assert_close(torch, got, want, BF16_TOL, f"attention {arch} S={s}")
        # the yardstick takes GQA expanded to Hq heads (expansion outside the
        # timing); S < window, so the causal mask alone is the same function
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        live = s * (s + 1) / 2            # causal (q, k) pairs this input needs
        flops = 4 * b * hq * live * d
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        b_ms, b_by = bound_ms(nbytes, flops)
        body, cta_q, ctas = fa.attention_geometry(torch.bfloat16, s, cs.t["Q"])
        row = {"arch": arch, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": window,
               "tiles": cs.t, "body": body, "cta_q": cta_q, "ctas": b * hq * ctas,
               "max_abs_err": err,
               "ms": timer.ms(lambda: fa.launch(q, k, v, cs, window=window), iters=20),
               "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"],
                                                                  window=window)),
               "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   q, ke, ve, is_causal=True), iters=20),
               "bound_ms": b_ms, "bound_by": b_by}
        row["library_ratio"] = row["ms"] / row["library_ms"]
        row["device_ms"] = timer.device_ms(lambda: fa.launch(q, k, v, cs, window=window))
        row["library_device_ms"] = timer.device_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
        row["device_ratio"] = ratio(row["device_ms"], row["library_device_ms"])
        # the f32 body at the same shape, for the record (not the served dtype)
        if (arch, s) == ("minitron-4b", 512):
            q32, k32, v32 = q.float(), k.float(), v.float()
            cs32 = ops.schedule_for(ops.instance("flash_attention_causal", torch.float32, Q=s, KV=s,
                                                 H=hq, D=d, B=b, window=0))
            row["fma_f32_ms"] = timer.ms(lambda: fa.launch(q32, k32, v32, cs32), iters=5)
            del q32, k32, v32
        shapes.append(row)
        log("attention_shape", **row)
        del q, k, v, ke, ve, got, want
    slice_rows = [slice_attention_row(torch, timer, g, *case) for case in SLICE_ATTN]
    return {"shapes": shapes, "slice": slice_rows,
            "max_abs_err": max([errs[n] for n in errs] + [r["max_abs_err"]
                                                          for r in shapes + slice_rows])}


#: the K2 shapes with narrow default Q tiles (ROADMAP B.1: a CTA covers a
#: group of them), (arch, class, B, Hq, Hkv, Sq, Skv, D, causal, window):
#: the slot engine's unbucketed 181-token (1-row tiles, 64 a CTA) and
#: 253-token (23-row tiles, 2 a CTA) prefills of whisper-medium's decoder
#: self- and cross-attention (1500 frames) and recurrentgemma-2b's local
#: attention (window 2048 > S); ``--attn-ab`` times these
NARROW_ATTN = (("whisper-medium", "flash_attention_cross", 1, 16, 16, 181, 1500, 64, False, 0),
               ("whisper-medium", "flash_attention_causal", 1, 16, 16, 181, 181, 64, True, 0),
               ("recurrentgemma-2b", "flash_attention_local", 1, 10, 1, 181, 181, 256, True, 2048),
               ("whisper-medium", "flash_attention_cross", 1, 16, 16, 253, 1500, 64, False, 0),
               ("whisper-medium", "flash_attention_causal", 1, 16, 16, 253, 253, 64, True, 0),
               ("recurrentgemma-2b", "flash_attention_local", 1, 10, 1, 253, 253, 256, True, 2048))
#: the slice's K2 shapes, as :data:`NARROW_ATTN`'s: whisper-medium's encoder
#: (bidirectional, 1500 frames) and its cross-attention over the 1500 frames
#: at a 256-row prefill and 4-slot decode (Q = 1); internvl2-26b's causal
#: prefill of a 512-token bucket behind its 256-token vision prefix; and
#: the narrow-tile shapes
SLICE_ATTN = (("whisper-medium", "flash_attention_bidir", 1, 16, 16, 1500, 1500, 64, False, 0),
              ("whisper-medium", "flash_attention_cross", 1, 16, 16, 256, 1500, 64, False, 0),
              ("whisper-medium", "flash_attention_cross", 4, 16, 16, 1, 1500, 64, False, 0),
              ("internvl2-26b", "flash_attention_causal", 1, 48, 8, 768, 768, 128, True, 0),
              *NARROW_ATTN)


def slice_attention_row(torch, timer, g, arch, class_id, b, hq, hkv, sq, skv, d, causal,
                        window) -> dict:
    """K2 at one of the slice's shapes: f32 (CUDA-core body) and bf16
    (tensor-core body) against the plain version and, where the default Q
    tile is narrower than Sq, bit for bit against the launch at a Q tile of
    Sq (one tile, one group: a row's bits do not depend on its CTA); the
    outputs' sha256; then bf16 timed beside the plain version and
    ``F.scaled_dot_product_attention`` (event and device time), with its
    CTA count and bound.  A window is at least Sq (so SDPA's causal mask is
    the same function)."""
    import torch.nn.functional as F

    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    what = f"attention {arch} {class_id} {b}x{hq}/{hkv}x{sq}x{skv}x{d}"
    if 0 < window < sq:
        raise ValueError(f"{what}: window {window} < Sq: SDPA's mask would differ")
    kw = dict(causal=causal, window=window)
    errs, outs = [], []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v = _attn_inputs(torch, g, b, hq, hkv, sq, skv, d, dtype)
        inst = ops.instance(class_id, dtype, Q=sq, KV=skv, H=hq, D=d, B=b, window=window)
        cs = ops.schedule_for(inst)
        body = fa.body_for(dtype)
        before = fa.body_count(body, dtype=dtype)
        got = fa.launch(q, k, v, cs, **kw)
        if fa.body_count(body, dtype=dtype) != before + 1:
            raise AssertionError(f"{what} {dtype}: the launch did not take the {body} body")
        want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], **kw)
        errs.append(assert_close(torch, got, want, tol, f"{what} {dtype}"))
        if cs.t["Q"] < sq:
            whole = concretize(Schedule.make(class_id, {**cs.t, "Q": sq}, order=cs.schedule.order),
                               inst)
            if not torch.equal(fa.launch(q, k, v, whole, **kw), got):
                raise AssertionError(f"{what} {dtype}: the output at Q tile {cs.t['Q']} differs "
                                     f"from the output at Q tile {sq}")
        outs.append(got)
        del want
    # bf16 from here on: the served dtype
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    live = sq * (sq + 1) / 2 if causal else sq * skv   # (q, k) pairs this input needs
    b_ms, b_by = bound_ms(2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d), 4 * b * hq * live * d)
    body, cta_q, ctas = fa.attention_geometry(torch.bfloat16, sq, cs.t["Q"])
    row = {"arch": arch, "class": class_id, "B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "KV": skv,
           "D": d, "causal": causal, "window": window, "tiles": cs.t, "body": body,
           "cta_q": cta_q, "ctas": b * hq * ctas, "f32_max_abs_err": errs[0],
           "max_abs_err": errs[1], "bits_equal_at_tile_sq": cs.t["Q"] < sq or None,
           "f32_digest": digest(torch, outs[:1]), "digest": digest(torch, outs[1:]),
           "ms": timer.ms(lambda: fa.launch(q, k, v, cs, **kw), iters=20),
           "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"], **kw)),
           "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
               q, ke, ve, is_causal=causal), iters=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "device_ms": timer.device_ms(lambda: fa.launch(q, k, v, cs, **kw)),
           "library_device_ms": timer.device_ms(lambda: F.scaled_dot_product_attention(
               q, ke, ve, is_causal=causal))}
    row["library_ratio"] = row["ms"] / row["library_ms"]
    row["device_ratio"] = ratio(row["device_ms"], row["library_device_ms"])
    log("attention_slice_shape", **row)
    return row


def _rw_inputs(torch, g, b, h, t, d, dtype, near_one=False):
    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (n(b, h, t, d).to(dtype) for _ in range(3))
    if near_one:   # the model's decay exp(-exp(w0 + dw)) with w0 = -6: ~0.998
        w = torch.exp(-torch.exp(-6.0 + 0.5 * n(b, h, t, d))).to(dtype)
    else:
        w = (0.05 + 0.9 * torch.sigmoid(n(b, h, t, d))).to(dtype)
    return r, k, v, w, 0.5 * n(h, d), n(b, h, d, d)


def _rg_inputs(torch, g, b, t, c, dtype):
    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return n(b, t, c).to(dtype), torch.sigmoid(n(b, t, c)).to(dtype), n(b, c)


def _rw_cs(torch, dtype, b, h, t, d, tile_t=None):
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import ops

    inst = ops.instance("rwkv6_scan", dtype, T=t, C=h * d, D=d, B=b)
    if tile_t is None:
        return ops.schedule_for(inst)
    return concretize(Schedule.make("rwkv6_scan", {"T": tile_t, "C": h * d}, order=("C", "T")), inst)


def _rg_cs(torch, dtype, b, t, c, tile_t=None, tile_c=None):
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import ops

    inst = ops.instance("rglru_scan", dtype, T=t, C=c, B=b)
    if tile_t is None and tile_c is None:
        return ops.schedule_for(inst)
    dflt = ops.schedule_for(inst).t
    return concretize(Schedule.make("rglru_scan", {"T": tile_t or dflt["T"], "C": tile_c or dflt["C"]},
                                    order=("C", "T")), inst)


# main-path shapes, bf16: rwkv6-1.6b (B, H, T, D, T tile; None: the default
# schedule's) and recurrentgemma-2b (B, T, C): a bucket-sized prefill,
# 4-slot decode and a prime-length prefill (default T tile 1)
RW_MAIN = ((1, 32, 256, 64, None), (4, 32, 1, 64, None), (1, 32, 397, 64, None),
           (1, 32, 397, 64, 397))
RG_MAIN = ((1, 256, 2560), (4, 1, 2560), (1, 397, 2560))


def scan_bounds(kind: str, shape: tuple) -> tuple[float, str]:
    """The least time for one scan: every input and output once over HBM,
    or 7 f32 operations per state element per token on the CUDA cores."""
    if kind == "rwkv6":
        b, h, t, d = shape[:4]
        nbytes = 5 * b * h * t * d * 2 + h * d * 4 + 2 * b * h * d * d * 4
        return bound_ms(nbytes, 7 * b * h * t * d * d, F32_CUDA_CORE_FLOPS)
    b, t, c = shape
    return bound_ms(3 * b * t * c * 2 + 2 * b * c * 4, 7 * b * t * c, F32_CUDA_CORE_FLOPS)


#: K3's backward timed by ``--time-scans``: rwkv6-1.6b's training shape
RW_BWD_TIMED = (4, 32, 512, 64)
#: K4's backward in ``--time-scans`` (B, T, C, dtype, from a state with the
#: final state's gradient): recurrentgemma-2b's training shape in bf16
#: (timed), T = 37 from a state, and the training shape in f32; each
#: turn digests dx, da and the initial state's gradient
RG_BWD_CASES = ((4, 512, 2560, "bfloat16", False), (4, 37, 2560, "bfloat16", True),
                (4, 512, 2560, "float32", False))


def _rg_bwd_inputs(torch, g, b, t, c, dt, with_state):
    """K4's backward inputs, seeded: x, a, the initial state, dy and the
    final state's gradient (None without a state).  a = exp(8·logσ(λ)·r) at
    λ = 2 over the gate r in (0.05, 1): 0.36 to 0.95 (init: 0.60).  Within
    2^-9 of 1 a rounds to bf16 1.0, where da is ±inf in both versions
    (tests/test_torch_backward.py)."""
    x = torch.randn((b, t, c), generator=g, device="cuda").to(dt)
    r_gate = 0.05 + 0.95 * torch.rand((b, t, c), generator=g, device="cuda")
    a = torch.exp(8 * torch.nn.functional.logsigmoid(torch.tensor(2.0)) * r_gate).to(dt)
    h0 = (torch.randn((b, c), generator=g, device="cuda") if with_state
          else torch.zeros((b, c), device="cuda"))
    dy = torch.randn((b, t, c), generator=g, device="cuda").to(dt)
    dh = torch.randn((b, c), generator=g, device="cuda") if with_state else None
    return x, a, h0, dy, dh


def digest(torch, tensors) -> str:
    """sha256 of the tensors' bytes, in order: their bits."""
    h = hashlib.sha256()
    for t in tensors:
        torch.cuda.synchronize()
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def time_scans(torch, timer, plain: bool = True, bwd: bool = False) -> list:
    """The scan kernels of the ``repro_torch`` on ``sys.path`` at the main-path
    shapes: each checked against its plain version, then timed by events
    and on the device (and the plain version by events, if ``plain``); with
    ``bwd``, K3's backward at ``RW_BWD_TIMED`` too, checked against its plain
    version and timed alike, with each of its kernels' device time; and
    K4's backward at ``RG_BWD_CASES``, each checked against its plain
    version and its outputs digested, the first timed by events, on the
    device and behind a stream hold, and behind a hold with no L2 flush
    (``warm_held_ms``: the previous call's inputs partly still in the L2).
    Takes only the wrappers' ``launch`` and ``launch_bwd``, so it times an
    older tree's kernels alike."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    cases = [("rwkv6", s, _rw_inputs(torch, g, *s[:4], torch.bfloat16, near_one=True),
              _rw_cs(torch, torch.bfloat16, *s), rw.launch, ref.rwkv6_scan) for s in RW_MAIN]
    cases += [("rglru", s, _rg_inputs(torch, g, *s, torch.bfloat16), _rg_cs(torch, torch.bfloat16, *s),
               rg.launch, ref.rglru_scan) for s in RG_MAIN]
    for kind, shape, x, cs, kernel, ref_fn in cases:
        y, s = kernel(*x, cs)
        yr, sr = ref_fn(*x)
        err = max(assert_close(torch, y, yr, BF16_TOL, f"{kind} main shape"),
                  assert_close(torch, s, sr, STATE_TOL, f"{kind} main shape state"))
        b_ms, b_by = scan_bounds(kind, shape)
        dims = ("B", "H", "T", "D") if kind == "rwkv6" else ("B", "T", "C")
        row = {"kind": kind, **dict(zip(dims, shape)), "tiles": cs.t, "max_abs_err": err,
               "ms": timer.ms(lambda: kernel(*x, cs)),
               "device_ms": timer.device_ms(lambda: kernel(*x, cs)),
               "plain_ms": timer.ms(lambda: ref_fn(*x), iters=5) if plain else None,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
    if bwd:
        warm = Timer(torch, flush=None)
        b, h, t, d = RW_BWD_TIMED
        dt = torch.bfloat16
        r, k, v, dy = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dt) for _ in range(4))
        w = torch.exp(-torch.exp(-6 + 4 * torch.rand((b, h, t, d), generator=g, device="cuda"))).to(dt)
        u, s0 = torch.randn((h, d), generator=g, device="cuda"), torch.zeros((b, h, d, d), device="cuda")
        cs = _rw_cs(torch, dt, b, h, t, d)
        args = (r, k, v, w, u, s0, dy, None)
        errs = grads_close(torch, ("dr", "dk", "dv", "dw", "du", "dstate"), rw.launch_bwd(*args, cs),
                           ref.rwkv6_scan_bwd(*args), "K3 backward")
        n = b * h * t * d
        b_ms, b_by = bound_ms(9 * 2 * n + 2 * 4 * b * h * d * d + 2 * 4 * h * d,
                              RW_BWD_OPS * b * h * t * d * d, F32_CUDA_CORE_FLOPS)
        rows.append({"kind": "rwkv6_bwd", "B": b, "H": h, "T": t, "D": d, "tiles": cs.t,
                     "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                     "ms": timer.ms(lambda: rw.launch_bwd(*args, cs)),
                     "device_ms": timer.device_ms(lambda: rw.launch_bwd(*args, cs)),
                     "kernels_ms": timer.kernel_ms(lambda: rw.launch_bwd(*args, cs)),
                     "plain_ms": None, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        for i, (b, t, c, dname, with_state) in enumerate(RG_BWD_CASES):
            dt = getattr(torch, dname)
            gi = torch.Generator(device="cuda").manual_seed(60 + i)   # the same inputs in every turn
            args = _rg_bwd_inputs(torch, gi, b, t, c, dt, with_state)
            cs = _rg_cs(torch, dt, b, t, c)
            got = rg.launch_bwd(*args, cs)
            errs = grads_close(torch, ("dx", "da", "dstate"), got, ref.rglru_scan_bwd(*args),
                               "K4 backward", f32=dt == torch.float32)
            row = {"kind": "rglru_bwd", "B": b, "T": t, "C": c, "dtype": dname, "state": with_state,
                   "tiles": cs.t, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "digest": digest(torch, got), "ms": None, "device_ms": None, "held_ms": None,
                   "warm_held_ms": None, "plain_ms": None, "library_ms": None}
            if i == 0:
                row["bound_ms"], row["bound_by"] = rg_bwd_bound(b, t, c)
                row["ms"] = timer.ms(lambda: rg.launch_bwd(*args, cs))
                row["device_ms"] = timer.device_ms(lambda: rg.launch_bwd(*args, cs))
                row["held_ms"] = timer.held_ms(lambda: rg.launch_bwd(*args, cs))
                row["warm_held_ms"] = warm.held_ms(lambda: rg.launch_bwd(*args, cs))
            rows.append(row)
    return rows


def phase_scans(torch, timer) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(3)
    rw_cs = lambda *a, **k: _rw_cs(torch, *a, **k)
    rg_cs = lambda *a, **k: _rg_cs(torch, *a, **k)
    errs = {"rwkv6": {}, "rglru": {}}

    def check(kind, name, x, cs, tol):
        kernel, plain = (rw.launch, ref.rwkv6_scan) if kind == "rwkv6" else (rg.launch, ref.rglru_scan)
        y, s = kernel(*x, cs)
        yr, sr = plain(*x)
        errs[kind][name] = max(assert_close(torch, y, yr, tol, name),
                               assert_close(torch, s, sr, STATE_TOL, name + " state"))
        return y, s

    def same(a, b, what):
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"{what}: y or the state is not bit-identical")

    bits = collections.Counter()   # bit-exact checks passed, by contract
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dn = ops.dtype_name(dtype)
        # K3: decode, prime T (default T tile 1), head dims 16/64, 1 and 3 heads
        for b, h, t, d, near in ((2, 1, 1, 16, False), (4, 3, 1, 64, True),
                                 (1, 3, 97, 64, False), (2, 1, 97, 16, True),
                                 (1, 3, 256, 16, True), (2, 2, 50, 32, False)):
            check("rwkv6", f"rwkv6/{dn}/{b}x{h}x{t}x{d}",
                  _rw_inputs(torch, g, b, h, t, d, dtype, near), rw_cs(dtype, b, h, t, d), tol)
        b, h, t, d = 1, 3, 256, 64
        x = _rw_inputs(torch, g, b, h, t, d, dtype)
        full = check("rwkv6", f"rwkv6/{dn}/T{t}/default", x, rw_cs(dtype, b, h, t, d), tol)
        same(rw.launch(*x, rw_cs(dtype, b, h, t, d)), full, f"rwkv6 {dn} second run")
        bits["rwkv6 runs"] += 1
        for ct in (1, 2, 8, 64, t):
            same(check("rwkv6", f"rwkv6/{dn}/T{t}/tile{ct}", x, rw_cs(dtype, b, h, t, d, ct), tol),
                 full, f"rwkv6 {dn} T tile {ct}")
            bits["rwkv6 T tiles"] += 1
        t1 = 100   # continuation: [0:t1], then [t1:T] from the returned state
        r, k, v, w, u, s0 = x
        part = [z[:, :, :t1].contiguous() for z in (r, k, v, w)]
        rest = [z[:, :, t1:].contiguous() for z in (r, k, v, w)]
        ya, sa = check("rwkv6", f"rwkv6/{dn}/cont1", (*part, u, s0), rw_cs(dtype, b, h, t1, d), tol)
        yb, sb = check("rwkv6", f"rwkv6/{dn}/cont2", (*rest, u, sa), rw_cs(dtype, b, h, t - t1, d), tol)
        same((torch.cat([ya, yb], dim=2), sb), full, f"rwkv6 {dn} state continuation")
        bits["rwkv6 continuation"] += 1
        # a batch row's bits do not depend on B: row 2 of B = 4 against B = 1
        for t in (1, 97):
            r, k, v, w, u, s0 = x4 = _rw_inputs(torch, g, 4, 2, t, 64, dtype, True)
            y4, s4 = check("rwkv6", f"rwkv6/{dn}/B4xT{t}", x4, rw_cs(dtype, 4, 2, t, 64), tol)
            one = [z[2:3].contiguous() for z in (r, k, v, w)]
            same(rw.launch(*one, u, s0[2:3].contiguous(), rw_cs(dtype, 1, 2, t, 64)),
                 (y4[2:3], s4[2:3]), f"rwkv6 {dn} T={t} row at B = 1 and B = 4")
            bits["rwkv6 B=1 vs B=4"] += 1

        # K4: decode, prime T, full width under the default C tile, a C tile
        # above 1024 channels, a ragged C under a tile of 8
        for b, t, c, tile_c in ((2, 1, 2560, None), (4, 1, 2560, None), (1, 97, 2560, None),
                                (1, 64, 2560, 2560), (2, 33, 12, None), (2, 33, 12, 8),
                                (1, 40, 100, None)):
            check("rglru", f"rglru/{dn}/{b}x{t}x{c}/c{tile_c}", _rg_inputs(torch, g, b, t, c, dtype),
                  rg_cs(dtype, b, t, c, tile_c=tile_c), tol)
        b, t, c = 1, 256, 2560
        x = _rg_inputs(torch, g, b, t, c, dtype)
        full = check("rglru", f"rglru/{dn}/T{t}/default", x, rg_cs(dtype, b, t, c), tol)
        same(rg.launch(*x, rg_cs(dtype, b, t, c)), full, f"rglru {dn} second run")
        bits["rglru runs"] += 1
        for ct in (1, 2, 8, 64, t):
            same(check("rglru", f"rglru/{dn}/T{t}/tile{ct}", x, rg_cs(dtype, b, t, c, tile_t=ct), tol),
                 full, f"rglru {dn} T tile {ct}")
            bits["rglru T tiles"] += 1
        for cc in (8, 512, c):
            same(check("rglru", f"rglru/{dn}/T{t}/ctile{cc}", x, rg_cs(dtype, b, t, c, tile_c=cc), tol),
                 full, f"rglru {dn} C tile {cc}")
            bits["rglru C tiles"] += 1
        xs, a, h0 = x
        ya, ha = check("rglru", f"rglru/{dn}/cont1", (xs[:, :t1].contiguous(), a[:, :t1].contiguous(), h0),
                       rg_cs(dtype, b, t1, c), tol)
        yb, hb = check("rglru", f"rglru/{dn}/cont2", (xs[:, t1:].contiguous(), a[:, t1:].contiguous(), ha),
                       rg_cs(dtype, b, t - t1, c), tol)
        same((torch.cat([ya, yb], dim=1), hb), full, f"rglru {dn} state continuation")
        bits["rglru continuation"] += 1
        for t in (1, 97):
            xs, a, h0 = x4 = _rg_inputs(torch, g, 4, t, c, dtype)
            y4, h4 = check("rglru", f"rglru/{dn}/B4xT{t}", x4, rg_cs(dtype, 4, t, c), tol)
            same(rg.launch(*(z[2:3].contiguous() for z in x4), rg_cs(dtype, 1, t, c)),
                 (y4[2:3], h4[2:3]), f"rglru {dn} T={t} row at B = 1 and B = 4")
            bits["rglru B=1 vs B=4"] += 1
    for kind in errs:
        log(f"{kind}_checks", checks=len(errs[kind]), max_abs_err=max(errs[kind].values()),
            tol=BF16_TOL, f32_tol=F32_TOL, state_tol=STATE_TOL,
            bit_exact={k: n for k, n in bits.items() if k.startswith(kind)})

    out = {"rwkv6": [], "rglru": []}
    for row in time_scans(torch, timer):
        kind = row.pop("kind")
        if kind == "rwkv6":
            geo = rw.scan_geometry(row["B"], row["H"], row["T"], row["D"], row["tiles"]["T"])
            row.update(cta_cols=geo[0], key_split=geo[1], stage_t=geo[2], ctas=geo[3])
        else:
            geo = rg.scan_geometry(row["B"], row["T"], row["C"], row["tiles"]["T"], row["tiles"]["C"])
            row.update(cta_c=geo[0], stage_t=geo[1], ctas=geo[2])
        out[kind].append(row)
        log(f"{kind}_shape", **row)
    for kind in out:
        out[kind] = {"shapes": out[kind],
                     "max_abs_err": max([*errs[kind].values(), *(r["max_abs_err"] for r in out[kind])])}
    return out


#: the ``--dist-ab`` turns: the trees in turn, parent first (six turns)
DIST_AB_TURNS = ("parent", "this", "parent", "this", "this", "parent")


def dist_ab(parent: Path) -> int:
    """gemma2-2b's full-depth ``dp`` sharded step (world 1, NCCL) and its
    unsharded step, 4 x 512 tokens, six steps each (median of steps 2-6),
    for the tree at ``parent`` and this one in turns
    (:data:`DIST_AB_TURNS`), each turn in its own process with that tree's
    ``src`` first on the path; prints each turn's medians and their ratio,
    then each tree's."""
    got = collections.defaultdict(list)
    for who in DIST_AB_TURNS:
        tree = parent if who == "parent" else ROOT
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-turn",
                              str(tree / "src")], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            raise AssertionError(f"the dist turn of {tree} failed ({out.returncode})")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        log("dist_turn", who=who, **row)
        got[who].append(row)
    log("dist_ab", **{who: {"dp_ms": [r["dp_ms"] for r in rows],
                            "unsharded_ms": [r["unsharded_ms"] for r in rows],
                            "ratios": [r["ratio"] for r in rows]} for who, rows in got.items()})
    print(nvidia_smi())
    return 0


def dist_turn(torch) -> dict:
    """One ``--dist-ab`` turn on the tree already on the path."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_arch(TRAIN_ARCH)
    batch = {"tokens": torch.from_numpy(SyntheticSource(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)).batch_at(0)
        ["tokens"]).cuda()}
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=DIST_STEPS)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_ab_") as d, nccl_group(torch, d, "s"):
        model = build_model(cfg, "cuda")
        for name in ("unsharded", "dp"):
            full = model.init(0)
            if name == "dp":
                step = steps_mod.make_sharded_train_step(model, opt_cfg, make_test_mesh(model=1),
                                                         strategy="dp")
                params = step.shard_params(full)
                del full
                opt = step.init_opt_state(params)
            else:
                step = steps_mod.make_train_step(model, opt_cfg)
                params, opt = full, steps_mod.init_opt_state(full)
            ms = []
            for _ in range(DIST_STEPS):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                params, opt, _ = step(params, opt, batch)
                torch.cuda.synchronize()
                ms.append((time.monotonic() - t0) * 1e3)
            out[f"{name}_ms"] = statistics.median(ms[1:])
            out[f"{name}_steps"] = ms
            del step, params, opt
            free_engines(torch)
    out["ratio"] = out["dp_ms"] / out["unsharded_ms"]
    return out


def scans_ab(parent: Path) -> int:
    """The scan kernels of the tree at ``parent`` (say, an unpacked parent
    commit) and of this tree, timed at the main-path shapes, K3's backward
    at ``RW_BWD_TIMED`` and K4's at ``RG_BWD_CASES``, in turns — parent,
    this, this, parent — each turn in its own process with that tree's
    ``src`` first on the path.  Prints each turn's rows, then per shape the
    mean event, device and held times and their ratios (parent / this).
    Raises if K4's backward gives other bits in any turn (its outputs'
    digests, at fixed seeded inputs)."""
    got = ab_turns(parent, "--time-scans", "scan",
                   lambda row: (row["kind"], row["B"], row["T"], row["tiles"]["T"],
                                row.get("dtype", "bfloat16"), row.get("state", False)))
    for key, rows in got.items():
        digests = {r["digest"] for who in rows for r in rows[who] if "digest" in r}
        if len(digests) > 1:
            raise AssertionError(f"{key}: the outputs' bits differ between turns or trees: "
                                 f"{ {who: [r.get('digest') for r in rows[who]] for who in rows} }")
        mean = ab_means(rows, ("ms", "device_ms", "held_ms", "warm_held_ms"))
        log("scan_ab", kind=key[0], B=key[1], T=key[2], tile_t=key[3], dtype=key[4], state=key[5],
            bits_equal=bool(digests) or None,
            parent_device_ms=mean["parent"]["device_ms"], device_ms=mean["this"]["device_ms"],
            device_ratio=ratio(mean["parent"]["device_ms"], mean["this"]["device_ms"]),
            parent_held_ms=mean["parent"]["held_ms"], held_ms=mean["this"]["held_ms"],
            held_ratio=ratio(mean["parent"]["held_ms"], mean["this"]["held_ms"]),
            parent_warm_held_ms=mean["parent"]["warm_held_ms"], warm_held_ms=mean["this"]["warm_held_ms"],
            parent_ms=mean["parent"]["ms"], ms=mean["this"]["ms"],
            ratio=ratio(mean["parent"]["ms"], mean["this"]["ms"]))
    print(nvidia_smi())
    return 0


#: ``--head-ab``'s launches of internvl2-26b's LM head (:data:`INTERNVL2_HEAD`):
#: the training forward, dX and dW, and the forward at 4 rows (decode)
HEAD_LAUNCHES = ("fwd", "dx", "dw", "decode")
#: timed calls of each launch in a ``--head-ab`` turn (with one CTA a
#: 3-column tile the forward and dW take 0.56 and 0.93 s a call on an H100)
HEAD_AB_ITERS = 5


def time_head(torch, timer) -> list:
    """One ``--head-ab`` turn, on the ``repro_torch`` on ``sys.path``:
    internvl2-26b's LM head launches (:data:`HEAD_LAUNCHES`) at fixed seeded
    inputs, each checked against its plain version (the forwards at the
    bf16 tolerance, dX and dW at ``GRAD_SCALE_ATOL``·max|plain| +
    ``GRAD_RTOL``·|plain|), then timed by events and on the device
    (profiler) beside ``torch.matmul`` on the same operands, with its body,
    CTA tile and count and its output's sha256."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    t, d, v = INTERNVL2_HEAD
    g = torch.Generator(device="cuda").manual_seed(47)
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=g, device="cuda").to(bf)
    w = (torch.randn((d, v), generator=g, device="cuda") / d ** 0.5).to(bf)
    dz = (torch.randn((t, v), generator=g, device="cuda") / v ** 0.5).to(bf)
    x4 = x[:4].contiguous()
    rows = []
    for launch in HEAD_LAUNCHES:
        if launch in ("fwd", "decode"):
            a, b = (x, w) if launch == "fwd" else (x4, w)
            m, k, n = a.shape[0], d, v
            cs = ops.schedule_for(ops.instance("matmul_lmhead", bf, M=m, N=n, K=k))
            fn = lambda a=a, b=b, cs=cs: mm.launch(a, b, cs, class_id="matmul_lmhead")  # noqa: E731
            geo = mm.launch_geometry(bf, m, n, k, cs.t["M"], cs.t["N"])
            body, cta, ctas = geo[0], geo[1:3], geo[4]
            tol = BF16_TOL
        else:
            a, b = (dz, w.T) if launch == "dx" else (x.T, dz)
            (m, k), n = a.shape, b.shape[1]
            fn = lambda a=a, b=b: mm.grad_launch(a, b)  # noqa: E731
            geo = mm.grad_geometry(a, b)
            body = geo["body"]
            *cta, ctas = mm.grad_cta(body, m, n, geo["tile_m"], geo["tile_n"])
            tol = None
        got = fn()
        want = ref.matmul(a, b)
        scale = float(want.float().abs().max())
        err = assert_close(torch, got, want, tol or dict(rtol=GRAD_RTOL, atol=GRAD_SCALE_ATOL * scale),
                           f"internvl2 head {launch}")
        del want
        row = {"launch": launch, "M": m, "K": k, "N": n, "body": body,
               "cta_tile": f"{cta[0]}x{cta[1]}", "ctas": ctas, "max_abs_err": err,
               "digest": digest(torch, [got]),
               "ms": timer.ms(fn, iters=HEAD_AB_ITERS, warmup=1),
               "device_ms": timer.device_ms(fn, iters=HEAD_AB_ITERS),
               "library_ms": timer.ms(lambda a=a, b=b: torch.matmul(a, b), iters=HEAD_AB_ITERS),
               "library_device_ms": timer.device_ms(lambda a=a, b=b: torch.matmul(a, b),
                                                    iters=HEAD_AB_ITERS)}
        row["bound_ms"], row["bound_by"] = bound_ms(2 * (m * k + k * n + m * n), 2 * m * n * k)
        rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


#: the turns of ``--scans-ab``, ``--head-ab``, ``--attn-ab``, ``--rows-ab`` and ``--mma-ab``
AB_TURNS = ("parent", "this", "this", "parent")


def ab_turns(parent: Path, mode: str, what: str, key, env=None) -> dict:
    """``chip_smoke.py MODE SRC`` for the tree at ``parent`` (say, an
    unpacked parent commit) and for this tree, in turns (:data:`AB_TURNS`),
    each turn in its own process with that tree's ``src`` first on the
    path.  Logs each turn's rows (``{what}_turn``; the turn's own log lines,
    a dropped profiler capture say, as ``{what}_turn_log``) and returns
    them by ``key(row)``, then by tree: {key: {"parent": [...], "this":
    [...]}}, keys in the order the rows came.  ``env(who, first)``: extra
    environment of a turn (``first``: the tree's first turn), or None."""
    got = collections.defaultdict(lambda: {"parent": [], "this": []})
    seen = set()
    for who in AB_TURNS:
        tree = parent if who == "parent" else ROOT
        extra = env(who, who not in seen) if env else None
        seen.add(who)
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), mode, str(tree / "src")],
                             capture_output=True, text=True, timeout=900,
                             env={**os.environ, **extra} if extra else None)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            raise AssertionError(f"{mode} on {tree} failed ({out.returncode})")
        for line in out.stdout.splitlines():
            row = json.loads(line)
            if "phase" in row:
                log(f"{what}_turn_log", who=who, line=row)
                continue
            log(f"{what}_turn", who=who, **row)
            got[key(row)][who].append(row)
    return dict(got)


def ab_means(rows: dict, metrics) -> dict:
    """Each tree's mean of each metric over its turns (None where a turn
    did not measure it)."""
    return {who: {m: (None if any(r.get(m) is None for r in rs) else statistics.mean(r[m] for r in rs))
                  for m in metrics} for who, rs in rows.items()}


def head_ab(parent: Path) -> int:
    """internvl2-26b's LM head launches (:func:`time_head`) of the tree at
    ``parent`` and of this tree, in turns (:func:`ab_turns`).  Prints per
    launch the mean event and device times of each tree, their ratios
    (parent / this), each tree's ratio to ``torch.matmul`` in the same turns
    and whether the two trees' outputs have the same bits.  Raises if a
    tree's two turns give other bits."""
    got = ab_turns(parent, "--time-head", "head", lambda row: row["launch"])
    for launch in HEAD_LAUNCHES:
        rows = got[launch]
        digests = {who: {r["digest"] for r in rows[who]} for who in rows}
        if any(len(d) != 1 for d in digests.values()):
            raise AssertionError(f"{launch}: a tree's two turns give other bits: {digests}")
        mean = ab_means(rows, ("ms", "device_ms", "library_ms", "library_device_ms"))
        p, t = mean["parent"], mean["this"]
        log("head_ab", launch=launch, **{k: rows["this"][0][k] for k in ("M", "K", "N", "body",
                                                                          "cta_tile", "ctas",
                                                                          "bound_ms")},
            parent_cta_tile=rows["parent"][0]["cta_tile"], parent_ctas=rows["parent"][0]["ctas"],
            bits_equal=digests["parent"] == digests["this"],
            parent_device_ms=p["device_ms"], device_ms=t["device_ms"],
            device_ratio=ratio(p["device_ms"], t["device_ms"]),
            parent_ms=p["ms"], ms=t["ms"], ratio=ratio(p["ms"], t["ms"]),
            parent_library_device_ms=p["library_device_ms"],
            library_device_ms=t["library_device_ms"],
            parent_library_ms=p["library_ms"], library_ms=t["library_ms"],
            parent_library_ratio=ratio(p["device_ms"], p["library_device_ms"]),
            library_ratio=ratio(t["device_ms"], t["library_device_ms"]))
    print(nvidia_smi())
    return 0


#: the archs whose slot-engine prefill ``--attn-ab`` times at full width
#: (their prompts prefill unbucketed: 181 and 253 take grouped Q tiles), and
#: the prompt lengths whose prefill logits it digests
ATTN_AB_ARCHS = ("whisper-medium", "recurrentgemma-2b")
ATTN_AB_PROMPTS = (181, 253)
#: timed one-shot prefills of each of those prompts a turn (median): one
#: engine stream's prefill seconds spread by more than K2's gain
ATTN_AB_PREFILLS = 7


def time_attn(torch, timer) -> list:
    """One ``--attn-ab`` turn, on the ``repro_torch`` on ``sys.path``: each
    :data:`NARROW_ATTN` launch at fixed seeded inputs
    (:func:`slice_attention_row`: checked against its plain version and at
    a Q tile of Sq, its outputs' sha256, timed beside SDPA, its CTAs); then
    the slot-engine and one-shot prefills of :data:`ATTN_AB_ARCHS` at
    :data:`ATTN_AB_PROMPTS` (:func:`time_prefills`)."""
    g = torch.Generator(device="cuda").manual_seed(34)
    rows = [{"kind": "attention", **slice_attention_row(torch, timer, g, *case)}
            for case in NARROW_ATTN]
    return rows + time_prefills(torch, ATTN_AB_ARCHS, ATTN_AB_PROMPTS)


def time_prefills(torch, archs, prompt_lens) -> list:
    """For each arch at full width, the slot engine's stream of the serve
    prompts, twice (the first warms up), with each prompt's prefill seconds
    and the sha256 of the generated tokens; and each ``prompt_lens``
    prompt's one-shot prefill (``model.prefill``), its logits' sha256 and
    its median seconds over :data:`ATTN_AB_PREFILLS` calls, each ended by a
    sync.  One row (kind ``prefill``) an arch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    rows = []
    for arch in archs:
        cfg = get_arch(arch)
        model = build_model(cfg, "cuda")
        params = model.init(seed=0)
        extras = serve_extras(torch, cfg)
        prompts = serve_prompts(cfg)
        lens = [len(p) for p in prompts]
        runs = []
        for _ in range(2):
            engine = ServingEngine(model, params, slots=4, max_len=512, extras=extras)
            runs.append(serve_stream(torch, engine, prompts, SERVE_NEW_TOKENS))
            del engine
        if runs[0]["generated"] != runs[1]["generated"]:
            raise AssertionError(f"{arch}: two runs of the slot engine generate other tokens")
        logits, one_shot = {}, {}
        for n in prompt_lens:
            batch = {"tokens": torch.tensor([prompts[lens.index(n)]], dtype=torch.long, device="cuda"),
                     **{k: v[None] for k, v in extras.items()}}
            secs = []
            for _ in range(ATTN_AB_PREFILLS):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out, _ = model.prefill(params, batch, max_len=512)
                torch.cuda.synchronize()
                secs.append(time.monotonic() - t0)
            logits[str(n)] = digest(torch, [out])
            one_shot[f"one_shot_{n}_s"] = statistics.median(secs)
        run = runs[1]
        rows.append({"kind": "prefill", "arch": arch, "prompt_lens": lens,
                     "prompt_prefill_s": run["prompt_prefill_s"], "prefill_s": run["prefill_s"],
                     **{f"prefill_{n}_s": run["prompt_prefill_s"][lens.index(n)]
                        for n in prompt_lens},
                     "warmup_prefill_s": runs[0]["prefill_s"], **one_shot,
                     "tokens_digest": hashlib.sha256(json.dumps(run["generated"]).encode()).hexdigest(),
                     "logits_digests": logits})
        del model, params, runs
        free_engines(torch)
    return rows


def attn_ab(parent: Path) -> int:
    """K2 at its narrow-tile shapes and the slot engine's prefill of
    :data:`ATTN_AB_ARCHS` (:func:`time_attn`) in the tree at ``parent`` and
    in this one, in turns (:func:`ab_turns`).  Prints per K2 shape each
    tree's CTAs, mean device times, their ratio (parent / this) and each
    tree's ratio to SDPA; per arch each tree's mean prefill seconds (all
    eight prompts, and each of :data:`ATTN_AB_PROMPTS`) and their ratios;
    and whether the outputs', tokens' and logits' sha256 are the same in
    every turn of both trees.  Raises, after printing, where any differs."""
    got = ab_turns(parent, "--time-attn", "attn",
                   lambda row: (row["kind"], row["arch"], row.get("class"), row.get("Sq")))
    differ = []
    for (kind, arch, class_id, sq), rows in got.items():
        if kind == "attention":
            keys = ("f32_digest", "digest")
            mean = ab_means(rows, ("ms", "device_ms", "library_device_ms"))
            p, t = mean["parent"], mean["this"]
            fields = dict(class_id=class_id, Sq=sq, KV=rows["this"][0]["KV"],
                          tiles=rows["this"][0]["tiles"], bound_ms=rows["this"][0]["bound_ms"],
                          parent_ctas=rows["parent"][0]["ctas"], ctas=rows["this"][0]["ctas"],
                          parent_device_ms=p["device_ms"], device_ms=t["device_ms"],
                          device_ratio=ratio(p["device_ms"], t["device_ms"]),
                          parent_ms=p["ms"], ms=t["ms"], ratio=ratio(p["ms"], t["ms"]),
                          parent_library_ratio=ratio(p["device_ms"], p["library_device_ms"]),
                          library_ratio=ratio(t["device_ms"], t["library_device_ms"]))
        else:
            keys, fields = prefill_ab_fields(rows, ATTN_AB_PROMPTS)
        same = ab_same(rows, keys)
        if not all(same.values()):
            differ.append((kind, arch, class_id, sq, same))
        log("attn_ab", kind=kind, arch=arch, bits_equal=same, **fields)
    print(nvidia_smi())
    if differ:
        raise AssertionError(f"--attn-ab: bits differ between turns or trees: {differ}")
    return 0


def prefill_ab_fields(rows: dict, prompt_lens) -> tuple:
    """The digests a prefill row of :func:`time_prefills` must keep, and
    its fields for an ``*_ab`` line: each tree's mean prefill seconds (all
    eight prompts, and each of ``prompt_lens`` in the stream and one-shot)
    and their ratios (parent / this)."""
    metrics = ("prefill_s", *(f"{m}_{n}_s" for m in ("prefill", "one_shot") for n in prompt_lens))
    mean = ab_means(rows, metrics)
    return ("tokens_digest", "logits_digests"), {
        k: v for m in metrics for k, v in ((f"parent_{m}", mean["parent"][m]), (m, mean["this"][m]),
                                           (f"{m}_ratio", ratio(mean["parent"][m], mean["this"][m])))}


def ab_same(rows: dict, keys) -> dict:
    """For each key, whether every turn of both trees gave the same value."""
    return {k: len({json.dumps(r[k], sort_keys=True) for rs in rows.values() for r in rs}) == 1
            for k in keys}


#: K1 on the rows body at narrow M tiles and at verify's 16 rows (class, M,
#: K, N): the prime 397-row GEMMs (1-row default tiles, 16 a CTA) beside
#: their 64x64 tiles, recurrentgemma-2b's 181-token projection, verify's
#: 16x3072x3072 (one 16-row tile)
PRIME_MM = (("matmul", 397, 2048, 2048), ("matmul_gelu_glu", 397, 2560, 15360),
            ("matmul", 181, 2560, 2560), ("matmul", 16, 3072, 3072))
#: ``--rows-ab``'s K1 launches: those and decode's 4x3072x3072
ROWS_AB_MM = PRIME_MM + (("matmul", 4, 3072, 3072),)


def rows_alone(m: int) -> list:
    """Rows of an M-row launch that :func:`rows_matmul_row` launches alone:
    the first group's edges, the middle, and the last (ragged) group's."""
    last = (m - 1) // 16 * 16
    return sorted({r for r in (0, 1, 15, 16, m // 2, last, m - 2, m - 1) if 0 <= r < m})


def rows_matmul_row(torch, timer, g, class_id, m, k, n, tile64: bool = False) -> dict:
    """K1 under the default schedule at (m, k, n), bf16, on the rows body:
    checked against its plain version and, bit for bit, against the same
    launch at an M tile of 16 and against each of :func:`rows_alone`'s rows
    launched alone at M = 1 (a 1-row CTA, the 4-row register pass: at a
    prime M the M tile 16 launch has the grouped launch's geometry, so the
    rows alone are what hold the grouped body to the per-row sums); its
    geometry (M tiles a CTA, CTAs, K split), its output's sha256, and its
    event and device times beside the plain version, ``torch.matmul`` (the
    plain class only), the bytes bound and the CUDA-core floor (2·M·N·K over
    the f32 CUDA-core peak: the rows body's FMAs); with ``tile64``, the same
    at 64x64 output tiles (the tensor-core body)."""
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    x, w, kw = _mm_inputs(torch, g, m, n, k, class_id, torch.bfloat16)
    cs = ops.schedule_for(ops.instance(class_id, torch.bfloat16, M=m, N=n, K=k))

    def under(tiles, inst=cs.instance):
        return concretize(Schedule.make(class_id, {**cs.t, **tiles}, order=cs.order), inst)

    want = ref.matmul(x, w, class_id, **kw)
    out = mm.launch(x, w, cs, class_id=class_id, **kw)
    err = assert_close(torch, out, want, BF16_TOL, f"{class_id} M={m}")
    if not torch.equal(out, mm.launch(x, w, under({"M": 16}), class_id=class_id, **kw)):
        raise AssertionError(f"{class_id} {m}x{k}x{n}: M tile {cs.t['M']} and 16 give other bits")
    alone = rows_alone(m)
    one = under({"M": 1}, ops.instance(class_id, torch.bfloat16, M=1, N=n, K=k))
    for r in alone:
        res = kw["residual"][r:r + 1] if kw["residual"] is not None else None
        if not torch.equal(out[r:r + 1], mm.launch(x[r:r + 1].contiguous(), w, one, class_id=class_id,
                                                   **{**kw, "residual": res})):
            raise AssertionError(f"{class_id} {m}x{k}x{n}: row {r} alone gives other bits")
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, cs.t["M"], cs.t["N"])
    b_ms, b_by = bound_ms(2 * (m * k + k * n + m * (n // 2 if "glu" in class_id else n)),
                          2 * m * n * k)
    run = lambda: mm.launch(x, w, cs, class_id=class_id, **kw)  # noqa: E731
    lib = (lambda: torch.matmul(x, w)) if class_id == "matmul" else None
    row = {"class": class_id, "M": m, "K": k, "N": n, "tiles": cs.t, "body": body,
           "m_group": cta_m // cs.t["M"] if body == "rows" else 1, "cta_m": cta_m, "cta_n": cta_n,
           "split_k": split_k, "ctas": ctas, "max_abs_err": err, "bits_equal_tile16": True,
           "bits_equal_rows_alone": alone,
           "digest": digest(torch, [out]),
           "ms": timer.ms(run, iters=5), "device_ms": timer.device_ms(run, iters=5),
           "plain_ms": timer.ms(lambda: ref.matmul(x, w, class_id, **kw), iters=5),
           # one library call computes the same function only without an epilogue
           "library_ms": timer.ms(lib, iters=5) if lib else None,
           "library_device_ms": timer.device_ms(lib, iters=5) if lib else None,
           "bound_ms": b_ms, "bound_by": b_by, "floor_ms": 2 * m * n * k / F32_CUDA_CORE_FLOPS * 1e3}
    if tile64:
        cs64 = under({"M": 64, "N": 64})
        err64 = assert_close(torch, mm.launch(x, w, cs64, class_id=class_id, **kw), want, BF16_TOL,
                             f"{class_id} M={m} 64x64")
        run64 = lambda: mm.launch(x, w, cs64, class_id=class_id, **kw)  # noqa: E731
        row.update(max_abs_err=max(err, err64),
                   tile64_ctas=mm.launch_geometry(x.dtype, m, n, k, 64, 64)[4],
                   tile64_ms=timer.ms(run64, iters=5), tile64_device_ms=timer.device_ms(run64, iters=5))
        # the same-call yardstick: the rows body's time over the tensor-core body's
        row["tile64_ratio"] = row["ms"] / row["tile64_ms"]
    return row


def phase_prime_matmul(torch, timer) -> list:
    """K1 on the rows body at :data:`PRIME_MM` (:func:`rows_matmul_row`),
    the 397-row shapes beside 64x64 output tiles."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for class_id, m, k, n in PRIME_MM:
        row = rows_matmul_row(torch, timer, g, class_id, m, k, n, tile64=m >= 64)
        rows.append(row)
        log("matmul_prime_shape", **row)
    torch.cuda.empty_cache()
    return rows


#: the archs whose slot-engine prefill ``--rows-ab`` times at full width
#: (they prefill unbucketed: 181 takes 1-row M tiles), and the prompt whose
#: prefill logits it digests (the serve phases' ``PRIME_PROMPT``)
ROWS_AB_ARCHS = ("whisper-medium", "rwkv6-1.6b", "recurrentgemma-2b")
ROWS_AB_PROMPTS = (181,)


def time_rows(torch, timer) -> list:
    """One ``--rows-ab`` turn, on the ``repro_torch`` on ``sys.path``: each
    :data:`ROWS_AB_MM` launch at fixed seeded inputs
    (:func:`rows_matmul_row`), then the slot-engine and one-shot prefills of
    :data:`ROWS_AB_ARCHS` at :data:`ROWS_AB_PROMPTS` (:func:`time_prefills`)."""
    g = torch.Generator(device="cuda").manual_seed(35)
    rows = [{"kind": "matmul", "arch": None, **rows_matmul_row(torch, timer, g, *case)}
            for case in ROWS_AB_MM]
    torch.cuda.empty_cache()
    return rows + time_prefills(torch, ROWS_AB_ARCHS, ROWS_AB_PROMPTS)


def rows_ab(parent: Path) -> int:
    """K1 on the rows body (:data:`ROWS_AB_MM`) and the slot engine's
    prefill of :data:`ROWS_AB_ARCHS` (:func:`time_rows`) in the tree at
    ``parent`` and in this one, in turns (:func:`ab_turns`).  Prints per K1
    shape each tree's M tiles a CTA, CTAs, mean event and device times,
    their ratio (parent / this) and each tree's ratio to ``torch.matmul``
    and to the CUDA-core floor; per arch each tree's mean prefill seconds
    and their ratios; and whether the outputs', tokens' and logits' sha256
    are the same in every turn of both trees.  Raises, after printing,
    where any differs."""
    got = ab_turns(parent, "--time-rows", "rows",
                   lambda row: (row["kind"], row["arch"], row.get("class"), row.get("M"),
                                row.get("K"), row.get("N")))
    differ = []
    for (kind, arch, class_id, m, k, n), rows in got.items():
        if kind == "matmul":
            keys = ("digest",)
            mean = ab_means(rows, ("ms", "device_ms", "library_device_ms"))
            p, t = mean["parent"], mean["this"]
            this = rows["this"][0]
            fields = dict(class_id=class_id, M=m, K=k, N=n,
                          **{f: this[f] for f in ("tiles", "bound_ms", "bound_by", "floor_ms")},
                          parent_m_group=rows["parent"][0]["m_group"], m_group=this["m_group"],
                          parent_ctas=rows["parent"][0]["ctas"], ctas=this["ctas"],
                          parent_device_ms=p["device_ms"], device_ms=t["device_ms"],
                          device_ratio=ratio(p["device_ms"], t["device_ms"]),
                          parent_ms=p["ms"], ms=t["ms"], ratio=ratio(p["ms"], t["ms"]),
                          library_device_ms=t["library_device_ms"],
                          parent_library_ratio=ratio(p["device_ms"], p["library_device_ms"]),
                          library_ratio=ratio(t["device_ms"], t["library_device_ms"]),
                          floor_ratio=ratio(t["device_ms"], this["floor_ms"]))
        else:
            keys, fields = prefill_ab_fields(rows, ROWS_AB_PROMPTS)
        same = ab_same(rows, keys)
        if not all(same.values()):
            differ.append((kind, arch, class_id, m, same))
        log("rows_ab", kind=kind, arch=arch, bits_equal=same, **fields)
    print(nvidia_smi())
    if differ:
        raise AssertionError(f"--rows-ab: bits differ between turns or trees: {differ}")
    return 0


#: ``--mma-ab``'s K1 and K1g launches, the forward tensor-core body's main
#: shapes (PERF.md §6): (name, class, E, rows per expert, K, N, with Z).
#: minitron-4b's 256-row prefill and 64-row paged chunk, whisper-medium's
#: encoder (M tile 125), gemma2-2b's GeGLU up at its training batch with and
#: without Z, mixtral-8x22b's and dbrx-132b's expert GEMMs at 256 rows each
MMA_AB_SHAPES = (("k1_prefill", "matmul", 1, 256, 3072, 3072, False),
                 ("k1_chunk", "matmul", 1, 64, 3072, 3072, False),
                 ("k1_whisper_encoder", "matmul", 1, 1500, 1024, 1024, False),
                 ("k1_gemma2_up_z", "matmul_gelu_glu", 1, 2048, 2304, 18432, True),
                 ("k1_gemma2_up", "matmul_gelu_glu", 1, 2048, 2304, 18432, False),
                 ("k1g_mixtral_up", "moe_gemm_silu_glu", 8, 256, 6144, 32768, False),
                 ("k1g_mixtral_down", "moe_gemm", 8, 256, 16384, 6144, False),
                 ("k1g_dbrx_up", "moe_gemm_silu_glu", 16, 256, 6144, 21504, False),
                 ("k1g_dbrx_down", "moe_gemm", 16, 256, 10752, 6144, False))
#: ``--mma-ab``'s gradient launches (``csrc/matmul_grad.cu``, whose helpers
#: moved to ``csrc/wgmma.cuh``: their bits must not change), on the views
#: the backward passes: (name, part, E, rows per expert, K, N of the
#: forward): gemma2-2b's GeGLU up dX and dW, mixtral-8x22b's K1g up dX
MMA_AB_GRADS = (("grad_dx_gemma2_up", "dx", 1, 2048, 2304, 18432),
                ("grad_dw_gemma2_up", "dw", 1, 2048, 2304, 18432),
                ("grad_dx_mixtral_up", "dx", 8, 512, 6144, 32768))
#: ``--mma-ab``'s slot-engine prefill: minitron-4b's eight serve prompts,
#: the 181-token one also one-shot
MMA_AB_ARCHS, MMA_AB_PROMPTS = ("minitron-4b",), (181,)


def mma_ab_row(torch, timer, name, class_id, e, m, k, n, with_z) -> tuple:
    """One ``--mma-ab`` launch at seeded inputs under its default schedule:
    its body and CTA geometry, event and device times beside the library
    call's (``torch.matmul``, ``torch.bmm``; none where an epilogue has no
    one call), its bound and its output's sha256; and the outputs."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(m + k + n + e)
    lead = (e,) if e > 1 else ()
    x = torch.randn((*lead, m, k), generator=g, device="cuda").to(bf)
    w = torch.empty((*lead, k, n), dtype=bf, device="cuda")
    for i in range(e):   # one expert's f32 draw at a time
        (w[i] if e > 1 else w).copy_(torch.randn((k, n), generator=g, device="cuda") / k ** 0.5)
    inst = ops.instance(class_id, bf, M=m * e, N=n, K=k, **({"E": e} if e > 1 else {}))
    cs = ops.schedule_for(inst)
    tile_m, tile_n, _, round_k = mm.schedule_key(cs)
    body, cta_m, cta_n, _, ctas = mm.launch_geometry(bf, m, n, k, tile_m, tile_n, e, round_k)
    if e > 1:
        def launch():
            return mm.grouped_launch(x, w, cs, class_id=class_id)
        library = (lambda: torch.bmm(x, w)) if class_id == "moe_gemm" else None
    else:
        def launch():
            return mm.launch(x, w, cs, class_id=class_id, with_z=with_z)
        library = (lambda: torch.matmul(x, w)) if class_id == "matmul" else None
    out = launch()
    outs = list(out) if isinstance(out, tuple) else [out]
    n_out = n // 2 if "glu" in class_id else n
    b_ms, b_by = bound_ms(2 * e * (m * k + k * n + m * n_out + (m * n if with_z else 0)),
                          2 * e * m * n * k)
    row = {"kind": "matmul", "name": name, "class": class_id, "E": e, "M": m, "K": k, "N": n,
           "with_z": with_z, "tiles": [tile_m, tile_n], "body": body, "cta_tile": [cta_m, cta_n],
           "ctas": e * ctas, "digest": digest(torch, outs),
           "ms": timer.ms(launch, iters=5), "device_ms": timer.device_ms(launch, iters=5),
           "library_ms": timer.ms(library, iters=5) if library else None,
           "library_device_ms": timer.device_ms(library, iters=5) if library else None,
           "bound_ms": b_ms, "bound_by": b_by}
    del x, w
    return row, outs


def mma_ab_grad_row(torch, timer, name, part, e, m, k, n) -> tuple:
    """One ``--mma-ab`` gradient launch at seeded inputs: dX = dZ·wᵀ or
    dW = xᵀ·dZ of the forward x (m, k) · w (k, n), per expert where e > 1,
    on transposed views; its body, device time and output sha256; and the
    output."""
    from repro_torch.kernels import matmul as mm

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(m + k + n + e + 7)
    lead = (e,) if e > 1 else ()
    x = torch.randn((*lead, m, k), generator=g, device="cuda").to(bf)
    w = (torch.randn((*lead, k, n), generator=g, device="cuda") / k ** 0.5).to(bf)
    dz = (torch.randn((*lead, m, n), generator=g, device="cuda") / n ** 0.5).to(bf)
    a, b = (dz, w.transpose(-1, -2)) if part == "dx" else (x.transpose(-1, -2), dz)

    def launch():
        return mm.grouped_grad_launch(a, b) if e > 1 else mm.grad_launch(a, b)
    out = launch()
    row = {"kind": "grad", "name": name, "part": part, "E": e, "M": m, "K": k, "N": n,
           "body": mm.grad_geometry(a, b)["body"], "digest": digest(torch, [out]),
           "device_ms": timer.device_ms(launch, iters=5)}
    del x, w, dz, a, b
    return row, [out]


def k1_step_device_ms(torch) -> dict:
    """One gemma2-2b train step at full depth and the train phase's batch
    (two unprofiled first) under one profiler capture: the device time and
    count of its K1 forward kernels (``matmul_*`` but ``matmul_grad_*``,
    the launches of the forward and of the full remat policy's recompute),
    and its device-busy time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_arch(TRAIN_ARCH)
    np_batch = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)).batch_at(0)
    batch = {"tokens": torch.from_numpy(np_batch["tokens"]).cuda()}
    model = build_model(cfg, "cuda")
    params = model.init(0)
    opt = steps_mod.init_opt_state(params)
    step = steps_mod.make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                                        total_steps=TRAIN_STEPS))
    for _ in range(2):
        step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k1 = [e for e in dev if "matmul_" in e.name and "matmul_grad_" not in e.name]
    summary = profile_summary(torch, prof, wall_us)
    del params, opt, step, model
    free_engines(torch)
    return {"kind": "train_step", "arch": TRAIN_ARCH, "k1_forward_kernels": len(k1),
            "k1_forward_device_ms": sum(e.time_range.elapsed_us() for e in k1) / 1e3,
            "device_busy_ms": summary["device_busy_ms"], "step_ms": wall_us / 1e3}


def time_mma(torch, timer) -> list:
    """One ``--mma-ab`` turn, on the ``repro_torch`` on ``sys.path``: each
    :data:`MMA_AB_SHAPES` launch (:func:`mma_ab_row`) and
    :data:`MMA_AB_GRADS` gradient launch (:func:`mma_ab_grad_row`), each output saved
    under ``$MMA_AB_DUMP`` where that is set (the tree's first turn); one
    gemma2-2b step's K1 forward device time (:func:`k1_step_device_ms`);
    minitron-4b's slot-engine prefill (:func:`time_prefills`)."""
    dump = os.environ.get("MMA_AB_DUMP")
    rows = []
    for case, fn in [(c, mma_ab_row) for c in MMA_AB_SHAPES] + [(c, mma_ab_grad_row)
                                                                 for c in MMA_AB_GRADS]:
        row, outs = fn(torch, timer, *case)
        if dump:
            torch.save([o.cpu() for o in outs], Path(dump) / f"{case[0]}.pt")
        rows.append(row)
        del outs
        torch.cuda.empty_cache()
    rows.append(k1_step_device_ms(torch))
    return rows + time_prefills(torch, MMA_AB_ARCHS, MMA_AB_PROMPTS)


def mma_ab(parent: Path) -> int:
    """K1's and K1g's forward tensor-core body at :data:`MMA_AB_SHAPES`, one
    gemma2-2b train step's K1 forward device time and minitron-4b's slot
    prefill (:func:`time_mma`) in the tree at ``parent`` and in this one,
    in turns (:func:`ab_turns`).  Prints per shape each tree's body, CTA
    tile and CTAs, mean event and device times, their ratio (parent /
    this) and each tree's ratio to the library call; the elements whose
    bits differ between the trees (another instruction may sum in another
    order) and their largest difference; per step and prefill each tree's
    means; per gradient launch each tree's device time and whether its
    bits equal the parent's.  Raises, after printing, where a digest
    differs between turns of one tree, where a shape on this tree's wgmma
    body is slower by device time than the parent's, or where a gradient
    launch's bits differ from the parent's."""
    import tempfile

    import torch

    dumps = Path(tempfile.mkdtemp(prefix="mma_ab_"))
    for who in ("parent", "this"):
        (dumps / who).mkdir()
    got = ab_turns(parent, "--time-mma", "mma",
                   lambda row: (row["kind"], row.get("name"), row.get("arch")),
                   env=lambda who, first: {"MMA_AB_DUMP": str(dumps / who)} if first else None)
    differ, slower, grad_differ = [], [], []

    def bits_vs_parent(name):   # per output: elements that differ, their share, the largest difference
        a = torch.load(dumps / "parent" / f"{name}.pt")
        b = torch.load(dumps / "this" / f"{name}.pt")
        return [{"differ": int((x != y).sum()), "share": float((x != y).float().mean()),
                 "max_abs_diff": float((x.float() - y.float()).abs().max())} for x, y in zip(a, b)]

    for (kind, name, arch), rows in got.items():
        if kind == "grad":
            keys = ("digest",)
            mean = ab_means(rows, ("device_ms",))
            cross = bits_vs_parent(name)
            if any(c["differ"] for c in cross):
                grad_differ.append((name, cross))
            fields = dict(name=name, **{f: rows["this"][0][f] for f in ("part", "E", "M", "K", "N")},
                          parent_body=rows["parent"][0]["body"], body=rows["this"][0]["body"],
                          parent_device_ms=mean["parent"]["device_ms"],
                          device_ms=mean["this"]["device_ms"],
                          device_ratio=ratio(mean["parent"]["device_ms"], mean["this"]["device_ms"]),
                          bits_vs_parent=cross)
        elif kind == "matmul":
            keys = ("digest",)
            mean = ab_means(rows, ("ms", "device_ms", "library_ms", "library_device_ms"))
            p, t = mean["parent"], mean["this"]
            this, par = rows["this"][0], rows["parent"][0]
            cross = bits_vs_parent(name)
            fields = dict(name=name, **{f: this[f] for f in ("class", "E", "M", "K", "N", "with_z",
                                                             "tiles", "bound_ms", "bound_by")},
                          parent_body=par["body"], body=this["body"],
                          parent_cta_tile=par["cta_tile"], cta_tile=this["cta_tile"],
                          parent_ctas=par["ctas"], ctas=this["ctas"],
                          parent_device_ms=p["device_ms"], device_ms=t["device_ms"],
                          device_ratio=ratio(p["device_ms"], t["device_ms"]),
                          parent_ms=p["ms"], ms=t["ms"], ratio=ratio(p["ms"], t["ms"]),
                          library_ms=t["library_ms"], library_device_ms=t["library_device_ms"],
                          parent_library_ratio=ratio(p["device_ms"], t["library_device_ms"]),
                          library_ratio=ratio(t["device_ms"], t["library_device_ms"]),
                          bound_share=ratio(this["bound_ms"], t["device_ms"]),
                          bits_vs_parent=cross)
            if this["body"] == "wgmma" and (t["device_ms"] is None or p["device_ms"] is None
                                            or t["device_ms"] > p["device_ms"]):
                slower.append((name, p["device_ms"], t["device_ms"]))
        elif kind == "train_step":
            keys = ()
            mean = ab_means(rows, ("k1_forward_device_ms", "k1_forward_kernels", "device_busy_ms",
                                   "step_ms"))
            fields = {k: v for m, vs in (("parent", mean["parent"]), ("this", mean["this"]))
                      for k, v in ((f"{m}_{f}", x) for f, x in vs.items())}
            fields["k1_forward_ratio"] = ratio(mean["parent"]["k1_forward_device_ms"],
                                               mean["this"]["k1_forward_device_ms"])
        else:
            keys, fields = prefill_ab_fields(rows, MMA_AB_PROMPTS)
        same = {k: {who: len({json.dumps(r[k], sort_keys=True) for r in rs}) == 1
                    for who, rs in rows.items()} for k in keys}
        if not all(v for s in same.values() for v in s.values()):
            differ.append((kind, name, arch, same))
        log("mma_ab", kind=kind, arch=arch, bits_equal_within_tree=same, **fields)
    for who in ("parent", "this"):
        for f in (dumps / who).iterdir():
            f.unlink()
        (dumps / who).rmdir()
    dumps.rmdir()
    print(nvidia_smi())
    if differ or slower or grad_differ:
        raise AssertionError(f"--mma-ab: bits differ between turns of one tree {differ}; "
                             f"slower than the parent's body by device time {slower}; "
                             f"gradient launches whose bits differ from the parent's {grad_differ}")
    return 0


@contextlib.contextmanager
def tensor_core_matmuls():
    """The plain matmul of the bf16 classes without bias or epilogue
    (``matmul``, ``matmul_lmhead``, ``moe_gemm``) as one library call on the
    tensor cores: cuBLAS's bf16 GEMM, f32 sums rounded once to bf16 (its
    reduced-precision reductions off), forward and backward.  That is the
    arithmetic of K1's ``mma`` body, so this plain version differs from the
    f32 one as the kernel path does: by the tensor cores' accumulation,
    which keeps fewer bits than the CUDA cores' FMA chain."""
    import torch

    from repro_torch.kernels import ref

    plain = ref.matmul
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    def matmul_tc(x, w, class_id="matmul", round_k=0, **kw):
        if (class_id in ("matmul", "matmul_lmhead", "moe_gemm") and x.dtype == torch.bfloat16
                and not round_k and kw.get("bias") is None and kw.get("residual") is None
                and not kw.get("softcap") and not kw.get("out_f32")):
            return torch.matmul(x, w)
        return plain(x, w, class_id, round_k=round_k, **kw)

    ref.matmul = matmul_tc
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        ref.matmul = plain
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced


@contextlib.contextmanager
def f64_accumulation():
    """The plain matmul accumulating in f64 instead of f32: an equally
    valid plain version that rounds to bf16 in the same places."""
    import torch

    from repro_torch.kernels import ref

    plain = ref.matmul

    def matmul64(x, w, class_id="matmul", round_k=0, out_f32=False, **kw):
        # the plain path (backend "ref") never rounds partial sums
        if round_k:
            raise ValueError("the f64 control takes no rounding K tile")
        y = ref.apply_epilogue(torch.matmul(x.double(), w.double()).float(), class_id, **kw)
        return y if out_f32 else y.to(x.dtype)

    ref.matmul = matmul64
    try:
        yield
    finally:
        ref.matmul = plain


def _grouped_inputs(torch, g, e, m, n, k, dtype):
    x = torch.randn((e, m, k), generator=g, device="cuda").to(dtype)
    w = torch.empty((e, k, n), dtype=dtype, device="cuda")
    for i in range(e):   # one expert at a time: mixtral's f32 stack would take 6.4 GB
        w[i] = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    return x, w


def phase_grouped(torch, timer) -> dict:
    from repro_torch.core.schedule import Schedule, concretize
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(5)

    def cs_for(class_id, dtype, e, m, n, k, tiles=None):
        inst = ops.instance(class_id, dtype, M=m * e, N=n, K=k, E=e)
        if tiles is None:
            return ops.schedule_for(inst)
        return concretize(Schedule.make(class_id, {**tiles, "K": k, "E": 1},
                                        order=("N", "M", "E", "K")), inst)

    errs = {}
    # (E, rows per expert, N, K, tiles): E = 1/3/8; decode-shaped 4 rows; a
    # ragged 300 rows under the default tile of 120 (M = 2400) and 13 under a
    # rows-body tile of 8; N not a multiple of 8 (scalar loads); N-outer
    # schedules with ragged M and N tiles in both bodies
    cases = [(1, 5, 40, 24, None), (1, 70, 96, 33, None), (3, 37, 100, 64, None),
             (8, 4, 96, 48, None), (8, 300, 64, 32, None), (3, 13, 64, 40, {"M": 8, "N": 64}),
             (3, 4, 50, 17, None), (3, 70, 50, 33, None),
             (3, 37, 100, 64, {"M": 16, "N": 48}), (3, 100, 100, 64, {"M": 64, "N": 48}),
             # the wgmma body (N and K whole 8s): experts with ragged edges,
             # N-outer tiles, a group of narrow N tiles (16: 8 a 128-column CTA)
             (3, 37, 104, 64, None), (3, 70, 96, 40, None), (8, 130, 256, 96, None),
             (3, 100, 104, 72, {"M": 64, "N": 48}), (3, 130, 512, 64, {"M": 64, "N": 16})]
    f32_bits = 0
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for class_id in ref.GROUPED_CLASSES:
            for e, m, n, k, tiles in cases:
                x, w = _grouped_inputs(torch, g, e, m, n, k, dtype)
                cs = cs_for(class_id, dtype, e, m, n, k, tiles)
                name = f"{class_id}/{ops.dtype_name(dtype)}/{e}x{m}x{n}x{k}/{tiles or 'default'}"
                got = mm.grouped_launch(x, w, cs, class_id=class_id)
                errs[name] = assert_close(torch, got, ref.grouped_matmul(x, w, class_id), tol, name)
                if launch_body(mm, x, w, cs) == "wgmma":   # f32 Y: its sums, unrounded
                    y32 = mm.grouped_launch(x, w, cs, class_id=class_id, out_f32=True)
                    errs[f"{name}/f32"] = assert_close(
                        torch, y32, ref.grouped_matmul(x, w, class_id, out_f32=True), F32_TOL,
                        f"{name} f32 Y")
                    torch.cuda.synchronize()
                    if not torch.equal(y32.to(dtype), got):
                        raise AssertionError(f"{name}: f32 Y does not round to the bf16 launch's bits")
                    f32_bits += 1
    if not f32_bits:
        raise AssertionError("no K1g case took the wgmma body")
    log("grouped_checks", checks=len(errs), max_abs_err=max(errs.values()), tol=BF16_TOL,
        f32_tol=F32_TOL)

    shapes = []
    for m in MOE_ROWS:
        for class_id, e, k, n in MOE_SHAPES:
            x, w = _grouped_inputs(torch, g, e, m, n, k, torch.bfloat16)
            cs = cs_for(class_id, torch.bfloat16, e, m, n, k)
            want = ref.grouped_matmul(x, w, class_id)
            err = assert_close(torch, mm.grouped_launch(x, w, cs, class_id=class_id), want,
                               BF16_TOL, f"{class_id} {e}x{m}x{k}x{n}")
            n_out = n // 2 if class_id == "moe_gemm_silu_glu" else n
            b_ms, b_by = bound_ms(2 * e * (m * k + k * n + m * n_out), 2 * e * m * n * k)
            *_, tile_m, tile_n = mm.grouped_geometry(x, w, cs, class_id)
            body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(x.dtype, m, n, k, tile_m, tile_n, e)
            iters = 10 if m <= 16 else 5
            cta_ms = (time_cta_tiles(torch, timer, lambda: mm.grouped_launch(x, w, cs, class_id=class_id),
                                     want, f"{class_id} {e}x{m}x{k}x{n}", body, iters)
                      if body in mm.CTA_TILES else None)
            del want
            row = {"class": class_id, "E": e, "M": m, "K": k, "N": n,
                   "tiles": {"M": tile_m, "N": tile_n},
                   "logical_tiles": e * -(-m // tile_m) * -(-n // tile_n), "body": body,
                   "cta_tile": [cta_m, cta_n], "split_k": split_k, "ctas": e * ctas,
                   "max_abs_err": err,
                   "cta_tile_ms": cta_ms,
                   "ms": timer.ms(lambda: mm.grouped_launch(x, w, cs, class_id=class_id), iters=iters),
                   "plain_ms": timer.ms(lambda: ref.grouped_matmul(x, w, class_id), iters=iters),
                   # one library call computes the same function only without the GLU
                   "library_ms": (timer.ms(lambda: torch.bmm(x, w), iters=iters)
                                  if class_id == "moe_gemm" else None),
                   "bound_ms": b_ms, "bound_by": b_by}
            row["library_ratio"] = row["ms"] / row["library_ms"] if row["library_ms"] else None
            row["device_ms"] = timer.device_ms(lambda: mm.grouped_launch(x, w, cs, class_id=class_id),
                                               iters=iters)
            row["library_device_ms"] = (timer.device_ms(lambda: torch.bmm(x, w), iters=iters)
                                        if row["library_ms"] else None)
            row["device_ratio"] = ratio(row["device_ms"], row["library_device_ms"])
            shapes.append(row)
            log("grouped_shape", **row)
            del x, w
            torch.cuda.empty_cache()
    rounding = rounding_cases(torch, timer, "moe_gemm")
    return {"shapes": shapes, "rounding": rounding,
            "max_abs_err": max([*errs.values(), *(r["max_abs_err"] for r in shapes)])}


#: the tuning phase's kernel lists: one 256-token prompt (minitron-4b's first
#: power-of-two prefill bucket) at each arch's full width and kernel shapes
TUNE_SHAPE = ("serve_prefill_256", 256, 1, "prefill")
#: trial budgets: each search of one kernel beyond the GEMMs, each donor's
#: full tuning, and the cap on the full tuning that must match a transfer
KERNEL_TRIALS = 32
DONOR_TRIALS = 256
MATCH_TRIALS = 1024
#: the kernels searched alone (arch, tag): K2, K3 and K4; no donor has the
#: two scan classes, so these are the searches that move the scans' schedules
KERNEL_SEARCHES = (("minitron-4b", "attn.global"), ("rwkv6-1.6b", "rwkv.scan"),
                   ("recurrentgemma-2b", "griffin.scan"))
#: (pair, donors, target, the target's prompt tokens, pick the donor by
#: Eq. 1): the main path's dense arch, the repo's MoE transfer
#: (examples/transfer_tuning_demo.py), and recurrentgemma-2b at the prime
#: 181-token prompt its engine serves unpadded (the default schedule's M
#: and Q tiles are 1 there), from the dense donors.  Donors are tuned at
#: TUNE_SHAPE, each once.
TUNE_PAIRS = (("dense", ("starcoder2-7b", "stablelm-12b"), "minitron-4b", 256, True),
              ("moe", ("dbrx-132b",), "mixtral-8x22b", 256, False),
              ("prime", ("starcoder2-7b", "stablelm-12b"), "recurrentgemma-2b", 181, True))
#: random valid schedules per searched kernel held against the plain version
RANDOM_CHECKS = 4
#: the runner's check: the prime prefill GEMM (M, N, K), whose default
#: schedule (M tile 1, the rows body) and 64x64 tiles (the tensor-core body)
#: the runner must order as the profiler's device times of the same launches
#: do, wherever those differ by more than PRIME_ORDER_MARGIN
PRIME_MNK = (397, 2048, 2048)
PRIME_ORDER_MARGIN = 1.2
#: the runner's event time (stream held behind a sleep) beside the
#: profiler's device time: (class, params) of decode and prefill GEMMs, K2, K3
TIMER_CHECKS = (("matmul", dict(M=4, N=3072, K=3072)), ("matmul", dict(M=256, N=3072, K=3072)),
                ("flash_attention_causal", dict(Q=256, KV=256, H=24, D=128, B=1)),
                ("rwkv6_scan", dict(T=256, C=32 * 64, D=64, B=1)),
                # minitron's 4-slot decode attention: the plain masked one (C.6)
                ("flash_attention_causal", dict(Q=1, KV=512, H=24, D=128, B=4)))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def tuning_pair(torch, cached, runner, db, donor_runs, donor_uses, name, donors, target, tokens,
                pick) -> tuple[dict, list]:
    """Full tuning of the donors (each once per phase), the donor pick,
    transfer-tuning of the target, all measured on the card through
    ``cached``; then full tuning of the target until it matches the
    transfer (or its trial cap).

    The match run gets a runner of its own, as a separate tuning run would:
    through ``cached`` it would replay, free, every launch the donors'
    searches timed (dbrx-132b and mixtral-8x22b share two projections).  The
    transferred plan and the defaults are timed on that runner first (by
    ``seconds``, which charges no search), so its stop rule compares model
    seconds of one runner, and neither side's search pays for the defaults."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (AnalyticalRunner, CachedRunner, select_donor, top_donors,
                                  transfer_tune, tune_model)
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.core.runner import telemetry_delta

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    before = runner.telemetry()
    uses = extract_kernels(get_arch(target), ShapeConfig(f"serve_prefill_{tokens}", tokens, 1,
                                                         "prefill"))
    out = {"pair": name, "target": target, "tokens": tokens, "donors": {}}
    for d in donors:
        if d not in donor_runs:
            res = tune_model(donor_uses[d], d, total_trials=DONOR_TRIALS, runner=cached)
            # publish only records no slower than the default on this card:
            # tune_model emits its pool's best five even where none beat the
            # default, and an exact-workload hit would serve such a record as
            # it is (mixtral-8x22b takes dbrx-132b's attention projections so)
            published = [r for r in res.records if r.seconds <= cached.seconds(r.instance)]
            for r in published:
                db.add(r)
            donor_runs[d] = res, len(published)
        res, published = donor_runs[d]
        out["donors"][d] = {"trials": res.total_trials, "search_s": res.search_time_s,
                            "records": len(res.records), "published": published,
                            "wall_s": res.wall_time_s, "untuned_ms": res.untuned_seconds * 1e3,
                            "tuned_ms": res.tuned_seconds * 1e3, "speedup": res.speedup,
                            "measurements": res.runner_telemetry["measurements"],
                            "ties": res.runner_telemetry["ties"]}
    others = [m for m in db.models() if m not in donors]   # the pair's donors alone
    donor = select_donor(uses, db, exclude=others, runner=cached) if pick else donors[0]
    out["eq1"] = [(s.model_id, s.score)
                  for s in top_donors(uses, db, k=len(donors), exclude=others, runner=cached)]
    out["donor"] = donor
    tt = transfer_tune(uses, db, model_id=target, donors=[donor], runner=cached)
    # the same donor schedules under the TPU cost model: what the TPU rules reject
    tpu = transfer_tune(uses, db, model_id=target, donors=[donor],
                        runner=CachedRunner(AnalyticalRunner("tpu-v5e")), donor_target=runner.target)
    tele = telemetry_delta(runner.telemetry(), before)
    own = MeasuredRunner()
    plan = tt.schedule_map()
    own_untuned = sum(u.use_count * own.seconds(u.instance) for u in uses)
    own_transfer = sum(u.use_count * own.seconds(u.instance, plan.get(u.instance.workload_key()))
                       for u in uses)
    full = tune_model(uses, target, total_trials=MATCH_TRIALS, runner=CachedRunner(own),
                      stop_when=lambda search_s, model_s: model_s <= own_transfer)
    matched = full.tuned_seconds <= own_transfer
    out.update({
        "untuned_ms": tt.untuned_seconds * 1e3, "transfer_ms": tt.tuned_seconds * 1e3,
        "speedup": tt.speedup, "coverage": tt.coverage(),
        "transfer_search_s": tt.search_time_s, "transfer_wall_s": tt.wall_time_s,
        "transfer_measurements": tt.measurements,
        "candidates": sum(k.candidates for k in tt.kernels),
        "invalid_card": tt.invalid_transfers, "invalid_tpu_model": tpu.invalid_transfers,
        "kernels": [{"tag": u.tag, "class": u.instance.class_id, "uses": u.use_count,
                     "params": dict(u.instance.params),
                     "untuned_ms": k.untuned_seconds * 1e3, "ms": k.seconds * 1e3,
                     "chosen": k.chosen.t if k.chosen else None,
                     "order": list(k.chosen.order) if k.chosen else None,
                     "exact_hit": k.exact_hit, "candidates": k.candidates, "invalid": k.invalid,
                     "tpu_candidates": kt.candidates, "tpu_invalid": kt.invalid}
                    for u, k, kt in zip(uses, tt.kernels, tpu.kernels)],
        # the match run's own runner: the untuned and transferred models timed there
        "own_untuned_ms": own_untuned * 1e3, "own_transfer_ms": own_transfer * 1e3,
        "full_trials": full.total_trials, "full_search_s": full.search_time_s,
        "full_wall_s": full.wall_time_s, "full_ms": full.tuned_seconds * 1e3,
        "full_speedup": own_untuned / full.tuned_seconds, "matched": matched,
        # with no match, both ratios are lower bounds
        "search_ratio": (full.search_time_s / tt.search_time_s if tt.search_time_s > 0
                         else None),
        "wall_ratio": full.wall_time_s / tt.wall_time_s,
        "runner": tele, "tie_share": tele["ties"] / max(tele["requests"], 1),
        "full_runner": own.telemetry(),
        "full_tie_share": own.ties / max(own.stats.requests, 1),
        "wall_s": time.monotonic() - t0,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if not matched:
        out["match"] = f"not matched in {full.total_trials} trials"
    for k in tt.kernels:
        if not k.seconds <= k.untuned_seconds:
            raise AssertionError(f"{target} {k.instance.class_id}: transferred {k.seconds} s "
                                 f"> untuned {k.untuned_seconds} s")
    chosen = [(k.instance, k.chosen) for k in tt.kernels if k.chosen is not None]
    for res in (*(donor_runs[d][0] for d in donors), full):
        best = {}
        for r in res.records:
            wk = r.instance.workload_key()
            if wk not in best or r.seconds < best[wk].seconds:
                best[wk] = r
        chosen += [(r.instance, r.schedule) for r in best.values()]
    del own
    log("tuning_pair", **out)
    return out, chosen


def phase_tuning(torch, timer):
    """The paper's workflow on the card at full width: the measured runner
    checked against the profiler, one search per kernel beyond the GEMMs,
    then per pair the donors' full tuning, the Eq. 1 pick, transfer-tuning
    and the full tuning needed to match it; every non-default schedule the
    searches chose (and a few random ones) held against the plain version
    (with the rounding K tile where the schedule rounds).  Returns (the
    summary, the donors' ScheduleDB: their records no slower than the
    default, under ``h100``)."""
    import random

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import (CachedRunner, KernelInstance, Schedule, ScheduleDB,
                                  default_schedule, tune_kernel)
    from repro_torch.core.autoscheduler import random_schedule
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.measured_runner import MeasuredRunner
    from repro_torch.core.schedule import ScheduleInvalid
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    t0 = time.monotonic()
    torch.cuda.empty_cache()
    for kmod in (mm, fa, rw, rg):
        kmod.reset_launches()
    runner = MeasuredRunner()
    cached = CachedRunner(runner)
    shape = ShapeConfig(*TUNE_SHAPE)
    archs = {a for a, _ in KERNEL_SEARCHES} | {a for _, d, t, _, _ in TUNE_PAIRS for a in (*d, t)}
    uses = {a: extract_kernels(get_arch(a), shape) for a in sorted(archs)}

    # 1. the runner: the prime shape's ranking, and its event times (the
    # stream held behind a sleep) beside the profiler's device times
    prime = KernelInstance.make("matmul", **dict(zip("MNK", PRIME_MNK)))
    dflt = default_schedule(prime)
    s64 = Schedule.make("matmul", {"M": 64, "N": 64, "K": dflt.t["K"]})
    check = {"shape": list(PRIME_MNK), "default_tiles": dflt.t,
             "default_ms": cached.seconds(prime, dflt) * 1e3,
             "tile64_ms": cached.seconds(prime, s64) * 1e3,
             "measurements": runner.stats.measurements,
             "default_device_ms": timer.device_ms(lambda: runner.run(runner.concrete(prime, dflt))),
             "tile64_device_ms": timer.device_ms(lambda: runner.run(runner.concrete(prime, s64)))}
    check["ratio"] = check["default_ms"] / check["tile64_ms"]
    check["device_ratio"] = ratio(check["default_device_ms"], check["tile64_device_ms"])
    if check["measurements"] != 2 or check["device_ratio"] is None:
        raise AssertionError(f"the runner check: {check}")
    if (max(check["device_ratio"], 1 / check["device_ratio"]) > PRIME_ORDER_MARGIN
            and (check["ratio"] > 1) != (check["device_ratio"] > 1)):
        raise AssertionError(f"the measured runner orders {PRIME_MNK}'s default (tiles {dflt.t}) "
                             f"and 64x64 tiles at {check['ratio']:.3f}, the device at "
                             f"{check['device_ratio']:.3f}")
    check["timer"] = []
    for class_id, params in TIMER_CHECKS:
        inst = KernelInstance.make(class_id, **params)
        cs = runner.concrete(inst, default_schedule(inst))
        check["timer"].append({"class": inst.class_id, "params": dict(inst.params),
                               "runner_ms": runner.seconds(inst) * 1e3,
                               "device_ms": timer.device_ms(lambda: runner.run(cs))})
    log("tuning_runner_check", **check)

    # 2. one search per kernel beyond the GEMMs
    searched, chosen, drawn = [], [], []
    for arch, tag in KERNEL_SEARCHES:
        inst = next(u.instance for u in uses[arch] if u.tag == tag)
        res = tune_kernel(inst, trials=KERNEL_TRIALS, runner=cached)
        row = {"arch": arch, "tag": tag, "class": inst.class_id, "params": dict(inst.params),
               "trials": res.trials, "search_s": res.search_time_s,
               "default_ms": cached.seconds(inst) * 1e3, "best_ms": res.best_seconds * 1e3,
               "best": res.best.t, "order": list(res.best.order),
               "measurements": res.runner_telemetry["measurements"],
               "ties": res.runner_telemetry["ties"]}
        searched.append(row)
        log("tuning_kernel", **row)
        chosen.append((inst, res.best))
        rng = random.Random(0)
        while sum(i is inst for i, _ in drawn) < RANDOM_CHECKS:
            sched = random_schedule(inst, rng)
            try:
                runner.concrete(inst, sched)
            except ScheduleInvalid:
                continue
            drawn.append((inst, sched))

    # 3-4. the pairs
    db, donor_runs, pairs = ScheduleDB(), {}, []
    for name, donors, target, tokens, pick in TUNE_PAIRS:
        row, pair_chosen = tuning_pair(torch, cached, runner, db, donor_runs, uses, name, donors,
                                       target, tokens, pick)
        pairs.append(row)
        chosen += pair_chosen
    launches = {"matmul": mm.launches, "grouped_matmul": mm.grouped_launches,
                "flash_attention": fa.launches, "rwkv6_scan": rw.launches,
                "rglru_scan": rg.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched in the tuning phase: {launches}")

    # 5. every schedule the searches chose that launches otherwise than the
    # default, and the random draws (K3 launches alike under every schedule),
    # against the plain version
    done, errs = {runner.launch_key(runner.concrete(i, default_schedule(i))) for i, _ in chosen}, {}
    for inst, sched in chosen + drawn:
        cs = runner.concrete(inst, sched)
        key = runner.launch_key(cs)
        if key in done and (inst, sched) not in drawn:
            continue
        done.add(key)
        got, want = _outputs(runner.run(cs)), _outputs(runner.run(cs, plain=True))
        name = f"{inst.class_id} {dict(inst.params)} {cs.t} {key[1]}"
        errs[name] = max(assert_close(torch, g, w, BF16_TOL if i == 0 else STATE_TOL, name)
                         for i, (g, w) in enumerate(zip(got, want)))
        del got, want
    log("tuning_checks", checks=len(errs), max_abs_err=max(errs.values()),
        worst=max(errs, key=errs.get), tol=BF16_TOL, state_tol=STATE_TOL, launches=launches)
    summary = {"shape": TUNE_SHAPE, "budgets": {"kernel": KERNEL_TRIALS, "donor": DONOR_TRIALS,
                                                "match_cap": MATCH_TRIALS},
               "runner_check": check, "kernels": searched, "pairs": pairs,
               "checks": len(errs), "max_abs_err": max(errs.values()), "launches": launches,
               "runner": runner.telemetry(), "wall_s": time.monotonic() - t0}
    del runner, cached
    torch.cuda.empty_cache()
    return summary, db


def layerwise_rel_err(torch, model, params, toks, extras=None) -> dict:
    """Each layer run by both paths on the plain path's input to that layer:
    per layer, |kernel - plain| / |plain| of the block output (output minus
    input), in L2.  Returns {"layer", "checked", "block", "routed_alike",
    "route_flips"} lists (the layer's name; the last two hold None for a
    layer without MoE).  ``extras`` are the batch's stub inputs: an enc-dec
    arch's encoder layers come first, each decoder layer then attends to the
    plain path's encoder output; a vision-prefixed arch's first entry is the
    vision projection (its output against the plain path's), and its layers
    take the plain path's prefix.

    A MoE layer's block output changes by a whole expert's output for a
    token whose top-k expert set differs between the paths: a one-ulp
    difference that the attention sub-block leaves in the router's input
    swaps the k-th expert of a token whose k-th and (k+1)-th probabilities
    nearly tie.  So such a layer counts those tokens (route_flips), and its
    checked error is the largest of: the whole-block error over the tokens
    both paths route alike (routed_alike); its attention sub-block's error on
    the layer's input; its MoE sub-block's error on the plain path's
    residual stream after attention, the same on both paths.  The
    whole-block error over every token (block) is reported, not checked."""
    from repro_torch.kernels.ops import use_backend
    from repro_torch.models import lm, mlp

    def rel(got, want, base, rows=None):
        diff, ref_ = got.float() - want.float(), want.float() - base
        if rows is not None:
            diff, ref_ = diff[rows], ref_[rows]
        return float(diff.norm() / ref_.norm())

    cfg = model.cfg
    out = {"layer": [], "checked": [], "block": [], "routed_alike": [], "route_flips": []}

    def dense(name, err):   # a layer checked whole
        out["layer"].append(name)
        out["block"].append(err)
        out["checked"].append(err)
        out["routed_alike"].append(None)
        out["route_flips"].append(None)

    def both(fn, h):   # one layer by the kernel path and the plain path
        out_k = fn(h)
        with use_backend("ref"):
            out_r = fn(h)
        return out_k, out_r

    extras = extras or {}
    if cfg.family == "audio":
        from repro_torch.models import attention, encdec

        frames = extras["frames"]
        h = frames.to(params["enc_pos"].dtype) + params["enc_pos"][None, :frames.shape[1]]
        for j, p in enumerate(params["encoder"]):
            out_k, out_r = both(lambda x: encdec.enc_block(p, cfg, x), h)
            dense(f"enc{j}", rel(out_k, out_r, h.float()))
            h = out_r
        enc = lm.apply_norm(params["enc_norm"], h, cfg.norm)
        h = encdec._dec_embed(params, toks)
        b, s, _ = h.shape
        positions = lm._positions(b, s, h.device)
        for j, p in enumerate(params["decoder"]):
            out_k, out_r = both(lambda x: encdec.dec_block(
                p, cfg, x, enc=enc, positions=positions,
                cache={"self": attention.init_attn_cache(cfg, "G", b, s, x.device)})[0], h)
            dense(f"dec{j}", rel(out_k, out_r, h.float()))
            h = out_r
        return out

    h = lm._embed(params, cfg, toks)
    if cfg.vision_tokens:
        from repro_torch.kernels import ops

        pe = extras["patch_embeds"].to(h.dtype)
        vis_k, vis_r = both(lambda x: ops.matmul(x, params["vis_proj"]), pe)
        dense("vis_proj", rel(vis_k, vis_r, 0.0))
        h = torch.cat([vis_r, h], dim=1)
    b, s, _ = h.shape
    kw = dict(positions=lm._positions(b, s, h.device), pos=None, decode=False)
    for j, kind in enumerate(cfg.layer_kinds):
        p = params["layers"][j]
        fresh = lambda: lm.init_block_cache(cfg, kind, b, max(s, 512), h.device)  # noqa: E731
        out_k, _, _ = lm.apply_block(p, cfg, kind, h, cache=fresh(), **kw)
        with use_backend("ref"):
            out_r, _, _ = lm.apply_block(p, cfg, kind, h, cache=fresh(), **kw)
        if "moe" not in p:
            dense(str(j), rel(out_k, out_r, h.float()))
            h = out_r
            continue
        out["layer"].append(str(j))
        out["block"].append(rel(out_k, out_r, h.float()))

        def experts(x):   # the sorted top-k expert set of each token, (B, S, k)
            xn = lm.ffn_input(p, cfg, x).reshape(b * s, -1)
            return mlp.moe_route(p["moe"], cfg, xn)[2].sort(-1).values.reshape(b, s, -1)

        a_k, _ = lm.apply_mixer(p, cfg, kind, h, cache=fresh(), **kw)
        e_k = experts(h + a_k)
        with use_backend("ref"):
            a_r, _ = lm.apply_mixer(p, cfg, kind, h, cache=fresh(), **kw)
            e_r = experts(h + a_r)
            y_r, _ = lm.apply_ffn(p, cfg, h + a_r)
        y_k, _ = lm.apply_ffn(p, cfg, h + a_r)
        alike = (e_k == e_r).all(-1)
        out["route_flips"].append(int((~alike).sum()))
        if not bool(alike.any()):
            raise AssertionError(f"layer {j}: the two paths route no token alike")
        out["routed_alike"].append(rel(out_k, out_r, h.float(), alike))
        out["checked"].append(max(out["routed_alike"][-1], rel(a_k, a_r, 0.0), rel(y_k, y_r, 0.0)))
        h = out_r
    return out


@contextlib.contextmanager
def traced_rows_geometry():
    """Every call of the matmul's ``rows_geometry`` (one per rows-body
    launch) while the context is open: [((m, n, k, tile_m, tile_n, groups,
    round_k), (cta_n, split_k, ctas)), ...]."""
    from repro_torch.kernels import matmul as mm

    plain, calls = mm.rows_geometry, []

    def traced(m, n, k, tile_m, tile_n, groups=1, round_k=0):
        out = plain(m, n, k, tile_m, tile_n, groups, round_k)
        calls.append(((m, n, k, tile_m, tile_n, groups, round_k), out))
        return out

    mm.rows_geometry = traced
    try:
        yield calls
    finally:
        mm.rows_geometry = plain


#: the profiler label of a schedule provider's ``get`` (profile_decode)
PROVIDER_LABEL = "ScheduleProvider.get"


def profile_summary(torch, prof, wall_us: float) -> dict:
    """A capture's device busy share (the union of its kernel intervals over
    the host-clock window ``wall_us``) and its five ops with the most device
    time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:            # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    ops_ = []
    for avg in prof.key_averages():
        dev = getattr(avg, "self_device_time_total", None)
        if dev is None:
            dev = getattr(avg, "self_cuda_time_total", 0.0)
        if dev > 0:
            ops_.append({"name": avg.key[:120], "calls": avg.count, "device_ms": dev / 1e3})
    ops_.sort(key=lambda o: -o["device_ms"])
    return {"window_ms": wall_us / 1e3, "device_events": len(spans),
            "device_busy_ms": busy / 1e3 if spans else None,
            "device_busy_share": busy / wall_us if spans else None,
            "top_device_ops": ops_[:5]}


#: the kernels of each launch counter, by substrings of their names: every
#: counted launch issues one of them (a rows-body K split adds a second
#: pass, ``matmul_rows_reduce_kernel``, K2's backward its dkv kernel (and,
#: for a split GQA group, ``attention_bwd_parts_kernel``), K3's backward its
#: walk and du kernels, none counted; K1g's launches and both gradient
#: launches, ``matmul_grad_*``, are the matmul family's)
CAPTURE_KERNELS = {"matmul": ("matmul_wgmma_kernel", "matmul_mma_kernel", "matmul_rows_kernel",
                              "matmul_rows_round_kernel", "matmul_fma_kernel", "matmul_grad_"),
                   "flash_attention": ("attention_mma_kernel", "attention_fma_kernel"),
                   "attention_bwd": ("attention_bwd_dq_",),
                   "rwkv6_scan": ("rwkv6_scan_kernel",), "rglru_scan": ("rglru_scan_kernel",),
                   "rwkv6_scan_bwd": ("rwkv6_scan_bwd_kernel",),
                   "rglru_scan_bwd": ("rglru_scan_bwd_kernel",)}
#: profiler captures taken before a busy share is reported as not measured
PROFILE_TRIES = 3


def launch_snapshot() -> dict:
    """The port's launch counters, by :data:`CAPTURE_KERNELS`' families."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    return {"matmul": mm.launches + mm.grouped_launches, "flash_attention": fa.launches,
            "attention_bwd": fa.bwd_launches, "rwkv6_scan": rw.launches,
            "rglru_scan": rg.launches, "rwkv6_scan_bwd": rw.bwd_launches,
            "rglru_scan_bwd": rg.bwd_launches}


def capture_shortfall(torch, prof, before: dict, after: dict) -> dict:
    """The kernel families of which a capture holds fewer kernels than the
    counters recorded launches between ``before`` and ``after``:
    {family: (captured, launched)}.  Empty: the capture is whole."""
    names = collections.Counter(e.name for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    short = {}
    for family, subs in CAPTURE_KERNELS.items():
        launched = after[family] - before[family]
        captured = sum(n for name, n in names.items() if any(s in name for s in subs))
        if captured < launched:
            short[family] = (captured, launched)
    return short


def profile_decode(torch, engine, prompts, steps: int = 3, provider=None) -> dict:
    """One torch.profiler capture of ``steps`` decode steps of a busy slot
    engine: the device's busy share of the window (the union of its kernel
    intervals over the host-clock window, which ends in a sync) and its five
    ops with the most device time.  With ``provider``, each of its ``get``
    calls inside the window is a labelled range, and the host time of those
    ranges over the window is the share of a step the provider takes (the
    label's own cost included).  The capture must hold a kernel for every
    launch the counters recorded in the window (:func:`capture_shortfall`);
    else the requests are served out and new ones profiled, up to
    :data:`PROFILE_TRIES` times, and then the busy share is not measured
    (None; the provider's host share, read from host ranges, still is)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, PROFILE_TRIES + 1):
        for p in prompts:
            engine.add_request(p, max_new_tokens=steps + 2)
        engine.step()                 # one step outside the window
        torch.cuda.synchronize()
        if provider is not None:
            real_get = provider.get

            def labelled(inst):
                with record_function(PROVIDER_LABEL):
                    return real_get(inst)

            provider.get = labelled
        before = launch_snapshot()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                for _ in range(steps):
                    engine.step()
                torch.cuda.synchronize()
                wall_us = (time.monotonic() - t0) * 1e6
        finally:
            if provider is not None:
                del provider.get      # back to the class's method
        after = launch_snapshot()
        while engine.active:
            engine.step()
        short = capture_shortfall(torch, prof, before, after)
        if short:
            log("profile_capture_short", what="decode", attempt=attempt, short=short)
            out = {"steps": steps, "attempt": None, "device_busy_share": None,
                   "not_measured": f"{attempt} captures short of the launch counts"}
        else:
            out = {"steps": steps, "attempt": attempt,
                   "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]},
                   **profile_summary(torch, prof, wall_us)}
        if provider is not None:      # host ranges: a capture short of kernels still has them
            label = next((a for a in prof.key_averages() if a.key == PROVIDER_LABEL), None)
            if label is None:
                raise AssertionError("the profiler recorded no schedule provider range")
            out["provider_calls"] = label.count
            out["provider_host_ms"] = label.cpu_time_total / 1e3
            out["provider_host_share"] = label.cpu_time_total / wall_us
        if not short:
            return out
    log("profile_not_measured", what="decode", tries=PROFILE_TRIES)
    return out


#: the kernels each served arch must launch
SERVE_KERNELS = {"minitron-4b": ("matmul", "flash_attention"),
                 "rwkv6-1.6b": ("matmul", "rwkv6_scan"),
                 "recurrentgemma-2b": ("matmul", "flash_attention", "rglru_scan"),
                 "mixtral-8x22b": ("matmul", "flash_attention", "grouped_matmul"),
                 "dbrx-132b": ("matmul", "flash_attention", "grouped_matmul"),
                 "whisper-medium": ("matmul", "flash_attention"),
                 "internvl2-26b": ("matmul", "flash_attention")}
#: the flash-attention classes an arch must launch, each on the tensor-core
#: body: whisper's encoder and cross-attention are its first non-causal launches
SERVE_ATTENTION_CLASSES = {"whisper-medium": ("flash_attention_bidir", "flash_attention_cross"),
                           "internvl2-26b": ("flash_attention_causal",)}
#: archs served at full width with their depth cut, and the depth: mixtral's
#: 56 layers hold ~140 B bf16 parameters (280 GB); 8 layers hold 20.4 B
#: (40.9 GB) and leave room for the plain path's f32 and f64 copies of one
#: expert's weights in the logits check.  dbrx's 40 layers hold ~132 B;
#: 6 layers hold 20.8 B (41.6 GB), its 16 experts of d_ff 10752 top-4 whole
SERVE_DEPTH = {"mixtral-8x22b": 8, "dbrx-132b": 6}
#: the depth at which ``serve.main`` serves a SERVE_DEPTH arch at full
#: width: the user's entry point for a few seconds' init
SERVE_MAIN_LAYERS = 1


def prefill_logits_check(torch, model, params, toks, what: str, provider=None,
                         extras=None) -> dict:
    """The kernel path's prefill logits (under ``provider``'s schedules)
    against the plain path's on the same weights, within the larger of
    LOGITS_REL_BOUND of max |logit| and CONTROL_FACTOR times the f64
    control; raises beyond it.  ``extras``: the batch's stub inputs."""
    from repro_torch.kernels.ops import use_backend

    batch = {"tokens": toks, **(extras or {})}
    logits_k, _ = model.prefill(params, batch, max_len=512, provider=provider)
    with use_backend("ref"):
        logits_r, _ = model.prefill(params, batch, max_len=512)
        with f64_accumulation():
            logits_c, _ = model.prefill(params, batch, max_len=512)
    torch.cuda.synchronize()
    if tuple(logits_k.shape) != (1, model.cfg.vocab_size) or not bool(torch.isfinite(logits_k).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits_k.shape)} or non-finite")
    diff = max_err(torch, logits_k, logits_r)
    control = max_err(torch, logits_c, logits_r)
    scale = float(logits_r.float().abs().max())
    bound = max(LOGITS_REL_BOUND * scale, CONTROL_FACTOR * control)
    if diff > bound:
        raise AssertionError(f"{what}: prefill logits differ by {diff} > {bound} "
                             f"(max |logit| {scale}, control {control})")
    return {"logits_max_abs_diff": diff, "logits_max_abs": scale,
            "logits_control": control, "logits_bound": bound,
            "argmax_equal": int(logits_k.argmax()) == int(logits_r.argmax())}


#: the prime prompt length among the serve phases' prompts (seed 0): the
#: recurrent archs prefill it unpadded, at default M and Q tiles of 1
PRIME_PROMPT = 181


#: new tokens per request in the engine runs of the serve phases
SERVE_NEW_TOKENS = 16


def serve_extras(torch, cfg) -> dict:
    """The stub inputs of the engine runs: seeded random encoder frames
    (whisper) or patch embeddings (internvl2), of order one, f32, on the
    card, so the encoder and the vision projection see real inputs (the
    reference's entry points serve zeros)."""
    g = torch.Generator(device="cuda").manual_seed(29)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = torch.randn((cfg.encoder_seq, cfg.d_model), generator=g, device="cuda")
    if cfg.vision_tokens:
        extras["patch_embeds"] = torch.randn((cfg.vision_tokens, cfg.d_model), generator=g,
                                             device="cuda")
    return extras


def serve_prompts(cfg) -> list:
    """The serve phases' 8 prompts: 100-400 random tokens each, seed 0
    (lengths 356, 291, 253, 181, 192, 112, 122, 104)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=int(n))]
            for n in rng.integers(100, 401, size=8)]


def body_counts(mm, counter=None) -> dict:
    """The matmul's launches per (kernel, body, dtype) so far (of
    ``counter``, ``mm.body_launches`` by default), as text keys."""
    from repro_torch.kernels import ops

    counter = mm.body_launches if counter is None else counter
    return {f"{kernel}/{body}/{ops.dtype_name(dtype)}": count
            for (kernel, body, dtype), count in sorted(counter.items(), key=str)}


#: why a bf16 K1 or K1g launch above 16 rows may take the mma body
#: (kernels/matmul.py mma_reason): rounding mode, rows of w off 16 bytes
#: (the shifted read), rows or base of x off 16 bytes
MMA_REASONS = ("round", "w_off16", "x_off16")


def forward_bodies(mm, what: str) -> dict:
    """K1's and K1g's bf16 forward launches of a run by tensor-core body
    (the counts since the last reset, less the gradient launches'):
    {kernel: {"wgmma": n, "mma": {reason: n}}}.  Raises unless every mma
    launch is one the rule sends there (:data:`MMA_REASONS`): every other
    launch meeting it ran on wgmma (the kernel refuses any other body)."""
    import torch

    bf, out = torch.bfloat16, {}
    for kernel in ("matmul", "grouped_matmul"):
        fwd = {b: mm.body_launches[kernel, b, bf] - mm.grad_body_launches[kernel, b, bf]
               for b in mm.CTA_TILES}
        reasons = {r: n for (k, r), n in sorted(mm.mma_launches.items()) if k == kernel}
        if fwd["mma"] != sum(reasons.values()) or set(reasons) - set(MMA_REASONS) or fwd["wgmma"] < 0:
            raise AssertionError(f"{what}: {kernel}'s bf16 forward launches by body {fwd}, the mma "
                                 f"body's by reason {reasons}")
        out[kernel] = {"wgmma": fwd["wgmma"], "mma": reasons}
    return out


def merge_forward_bodies(runs: list) -> dict:
    """The sum of several runs' :func:`forward_bodies`."""
    out = {}
    for fb in runs:
        for kernel, v in fb.items():
            o = out.setdefault(kernel, {"wgmma": 0, "mma": {}})
            o["wgmma"] += v["wgmma"]
            for r, n in v["mma"].items():
                o["mma"][r] = o["mma"].get(r, 0) + n
    return out


def launch_body(mm, x, w, cs) -> str:
    """The body a K1 (K1g: 3-D x and w) launch of x and w under ``cs``
    takes: kernels/matmul.py launch_geometry's rule on these tensors."""
    tile_m, tile_n, _, round_k = mm.schedule_key(cs)
    return mm.launch_geometry(x.dtype, x.shape[-2], w.shape[-1], w.shape[-2], tile_m, tile_n,
                              round_k=round_k, aligned=mm.bases16(x, w))[0]


def instance_body(mm, inst, cs) -> str:
    """The body a K1 launch of ``inst`` under ``cs`` takes, its tensors
    16-byte aligned (the allocator's)."""
    import torch

    tile_m, tile_n, _, round_k = mm.schedule_key(cs)
    return mm.launch_geometry(getattr(torch, inst.dtype), inst.p["M"], inst.p["N"], inst.p["K"],
                              tile_m, tile_n, round_k=round_k)[0]


def phase_serve(torch, arch: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_arch(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    torch.cuda.empty_cache()

    # the user's entry point at full width: at full depth, or at
    # SERVE_MAIN_LAYERS layers for an arch whose full depth fits no one
    # card; it counts its own launches
    argv = ["--arch", arch, "--preset", "full", "--device", "cuda"]
    if arch in SERVE_DEPTH:
        argv += ["--layers", str(SERVE_MAIN_LAYERS)]
    res = serve.main(argv)
    if res["requests"] != 8 or res["tokens"] != 8 * 8:
        raise AssertionError(f"serve.main finished {res['requests']} requests / {res['tokens']} tokens")
    if res["layers"] != (SERVE_MAIN_LAYERS if arch in SERVE_DEPTH else cfg.n_layers):
        raise AssertionError(f"serve.main served {res['layers']} layers")
    if min(res["kernel_launches"][k] for k in SERVE_KERNELS[arch]) <= 0:
        raise AssertionError(f"{arch}: serve.main never launched a kernel of its path: "
                             f"{res['kernel_launches']}")

    # the main path, at full width: the slot engine with long prompts of
    # unbucketed lengths for the recurrent archs, power-of-two buckets for
    # minitron; the launch counts are set to 0 just before it, read just
    # after.  Peak memory is read twice: over weight init alone (init draws
    # each weight in f32 before the cast), then from the end of init over
    # serving (weights, caches and the passes' activations)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    init_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    extras = serve_extras(torch, cfg)
    engine = ServingEngine(model, params, slots=4, max_len=512, extras=extras)
    prompts = serve_prompts(cfg)
    for kmod in (mm, fa, rw, rg):
        kmod.reset_launches()
    with traced_rows_geometry() as rows_calls:
        run = serve_stream(torch, engine, prompts, SERVE_NEW_TOKENS)
    launches = serve.kernel_launches()
    bodies = body_counts(mm)
    fwd_bodies = forward_bodies(mm, f"serve {arch}")
    attn_classes = {f"{c}/{b}": n for (c, b), n in sorted(fa.class_launches.items())}
    prime_bodies = run["prime_bodies"]
    # an unbucketed prime prompt: every default M tile is 1, so its K1
    # launches all take the rows body, but for whisper's encoder and cross
    # K/V projections at 1500 frames (M tile 125: the tensor cores, wgmma),
    # six per encoder layer and two per decoder layer
    enc_mma = 6 * cfg.encoder_layers + 2 * cfg.n_layers if cfg.encoder_layers else 0
    if not engine.prefill_buckets and (prime_bodies.get("matmul/wgmma/bfloat16", 0) != enc_mma
                                       or not prime_bodies.get("matmul/rows/bfloat16", 0)):
        raise AssertionError(f"{arch}: the {PRIME_PROMPT}-token prefill's K1 bodies {prime_bodies}")
    # each attention class of the arch launched, all on the tensor-core body
    for c in SERVE_ATTENTION_CLASSES.get(arch, ()):
        if attn_classes.get(f"{c}/mma", 0) <= 0 or attn_classes.get(f"{c}/fma", 0):
            raise AssertionError(f"{arch}: launches per attention class and body {attn_classes}")
    # every bf16 prefill GEMM above 16 rows ran on the tensor cores (wgmma
    # but where the rule names a reason: forward_bodies): none took the
    # CUDA-core body, which is for f32 alone
    if mm.body_count("wgmma") <= 0 or mm.body_count("fma", dtype=torch.bfloat16) != 0:
        raise AssertionError(f"{arch}: launches per matmul body {bodies}")
    # a MoE arch's expert GEMMs: prefill on the tensor cores (T rows per
    # expert), decode on the rows body (4)
    if cfg.n_experts and min(mm.body_count(b, kernel="grouped_matmul", dtype=torch.bfloat16)
                             for b in ("wgmma", "rows")) <= 0:
        raise AssertionError(f"{arch}: K1g's launches per body {bodies}")
    # every rows-body launch (decode, 1-row prefill tiles) took its layout
    # from rows_geometry: one call per launch
    if len(rows_calls) != mm.body_count("rows"):
        raise AssertionError(f"{arch}: {mm.body_count('rows')} rows-body launches, "
                             f"{len(rows_calls)} rows_geometry layouts")
    decode_geometry = collections.Counter(
        f"{n}x{k}/E{e}: split_k {split_k}, {e * ctas} CTAs"
        for (m, n, k, tile_m, tile_n, e, _), (_, split_k, ctas) in rows_calls if m == 4)
    if not decode_geometry:
        raise AssertionError(f"{arch}: no M = 4 decode launch took the rows body")
    # every bf16 attention launch took the tensor-core body
    attn_bodies = {f"{body}/{ops.dtype_name(dtype)}": count
                   for (body, dtype), count in sorted(fa.body_launches.items(), key=str)}
    if "flash_attention" in SERVE_KERNELS[arch] and (
            fa.body_count("mma", dtype=torch.bfloat16) != launches["flash_attention"]
            or fa.body_count("fma", dtype=torch.bfloat16) != 0):
        raise AssertionError(f"{arch}: launches per attention body {attn_bodies}")
    if min(launches[k] for k in SERVE_KERNELS[arch]) <= 0:
        raise AssertionError(f"{arch}: a kernel of the main path was never launched: {launches}")
    # K2 on narrow Q tiles (ROADMAP B.1): every launch on 1-row tiles over
    # Sq > 1 rows put a group of tiles in each CTA; an arch that prefills
    # unbucketed takes them at the prime prompt
    attn_tiles = {"row_tile_launches": fa.row_tile_launches,
                  "grouped_tile_launches": {str(t): n for t, n in
                                            sorted(fa.grouped_tile_launches.items())}}
    if fa.grouped_tile_launches[1] != fa.row_tile_launches or (
            not engine.prefill_buckets and "flash_attention" in SERVE_KERNELS[arch]
            and not fa.row_tile_launches):
        raise AssertionError(f"{arch}: K2 launches on narrow Q tiles {attn_tiles}")
    # K1 and K1g on narrow M tiles (ROADMAP B.1): every rows launch with an
    # M tile of at most 8 rows over more rows than one tile put a group of
    # tiles in each CTA, as the CTAs it launched show (rows_geometry's count,
    # which the C entry re-checks against its own m_group): ceil(M / span)
    # times one tile's strips and K slices, span = 16 // tile tiles' rows,
    # where one CTA a tile would launch ceil(M / tile) times as many.  The
    # wrapper's counters must agree; an arch that prefills unbucketed makes
    # some at the prime prompt
    launched = collections.Counter()
    for (m, n, k, tile_m, tile_n, e, round_k), (_, _, ctas) in rows_calls:
        if tile_m > 8 or m <= tile_m:
            continue
        per_tile = mm.rows_geometry(tile_m, n, k, tile_m, tile_n, e, round_k)[2]
        span = 16 // tile_m * tile_m
        if ctas == -(-m // span) * per_tile < -(-m // tile_m) * per_tile:
            launched[tile_m] += 1
    mm_tiles = {"row_tile_launches": mm.row_tile_launches,
                "grouped_by_ctas": {str(t): n for t, n in sorted(launched.items())},
                **{name: {str(t): n for t, n in sorted(c.items())}
                   for name, c in (("grouped_tile_launches", mm.grouped_tile_launches),
                                   ("narrow_tile_launches", mm.narrow_tile_launches))}}
    if not (launched == mm.narrow_tile_launches == mm.grouped_tile_launches) or (
            not engine.prefill_buckets and not launched):
        raise AssertionError(f"{arch}: K1 launches on narrow M tiles {mm_tiles}")
    # where the decode step's time goes on the device: a profiler capture of
    # three minitron decode steps at 4 busy slots (after the counts are read)
    profile = (profile_decode(torch, engine, prompts[:4]) if arch == "minitron-4b" else None)
    if profile is not None:
        log("decode_profile", arch=arch, **profile)
    serve_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # whisper: the encoder's share of a prefill, one encode of the frames
    encoder_s = None
    if cfg.encoder_layers:
        from repro_torch.models import encdec

        frames = extras["frames"][None]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        encdec.encode(params, cfg, frames)
        torch.cuda.synchronize()
        encoder_s = time.monotonic() - t0

    # kernel path vs plain path on the same weights: the first prompt's
    # prefill, end to end and layer by layer
    toks = torch.tensor([prompts[0]], dtype=torch.long, device="cuda")
    batch_extras = {k: v[None] for k, v in extras.items()}
    logits = prefill_logits_check(torch, model, params, toks, arch, extras=batch_extras)
    layers = layerwise_rel_err(torch, model, params, toks, batch_extras)
    layer_err = layers["checked"]
    if max(layer_err) > LAYER_REL_BOUND:
        raise AssertionError(f"{arch}: a layer's output differs by {max(layer_err)} "
                             f"> {LAYER_REL_BOUND} (per layer: {layers})")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "encoder_layers": cfg.encoder_layers, "vision_tokens": cfg.vision_tokens,
           "params": cfg.param_count(),
           "serve_main": {k: res[k] for k in ("preset", "layers", "requests", "tokens",
                                               "decode_steps", "tok_per_s", "kernel_launches")},
           "requests": run["requests"], "tokens": run["tokens"],
           "prompt_lens": [len(p) for p in prompts], "decode_steps": run["steps"],
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "prompt_prefill_s": run["prompt_prefill_s"], "prime_prefill_body_launches": prime_bodies,
           "matmul_tile_launches": mm_tiles,
           "decode_ms_per_step": run["decode_ms_per_step"],
           "tok_per_s": run["tokens"] / (run["prefill_s"] + run["decode_s"]),
           "decode_tok_per_s": (run["tokens"] - run["requests"]) / run["decode_s"],
           "encoder_s": encoder_s,
           "encoder_share": 8 * encoder_s / run["prefill_s"] if encoder_s else None,
           "launches": launches, "body_launches": bodies, "attention_body_launches": attn_bodies,
           "forward_bodies": fwd_bodies,
           "attention_class_launches": attn_classes, "attention_tile_launches": attn_tiles,
           "decode_rows_geometry": dict(decode_geometry), "decode_profile": profile,
           "init_peak_gib": init_peak_gib, "serve_peak_gib": serve_peak_gib,
           **logits,
           "layer_rel_err_max": max(layer_err), "layer_rel_err": layer_err,
           "layer_names": layers["layer"],
           "layer_block_rel_err": layers["block"],
           "layer_routed_alike_rel_err": layers["routed_alike"],
           "layer_route_flips": layers["route_flips"]}
    log("serve", **row)
    del model, params, engine
    torch.cuda.empty_cache()
    return row


#: the arch served through a registry: K1, K2 and K4 on its path, exact
#: prompt lengths (none of its prefill instances is planned), the prime prompt
TUNED_ARCH = "recurrentgemma-2b"


class ResolutionRecorder:
    """Every schedule a provider hands out while installed: (instance, tier,
    concrete schedule, whether the active plan answered)."""

    def __init__(self, provider):
        self.provider, self.calls = provider, []
        real_get, real_resolve = provider.get, provider.pipeline.resolve
        last = {}

        def resolve(inst, mode=None):
            last["r"] = real_resolve(inst, mode)
            return last["r"]

        def get(inst):
            plan = provider.plan
            r = plan.lookup(inst) if plan is not None else None
            cs = real_get(inst)
            self.calls.append((inst, (r or last["r"]).tier, cs, r is not None))
            return cs

        provider.get, provider.pipeline.resolve = get, resolve

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        del self.provider.get, self.provider.pipeline.resolve


def serve_stream(torch, engine, prompts, new_tokens: int, rec=None, after_admissions=None) -> dict:
    """The serve phases' stream through ``engine``: prefill seconds per
    prompt (add_request syncs on its argmax), decode seconds, steps; each
    prompt's matmul launches per body, the prime prompt's apart, and (with
    ``rec``) the prime prompt's resolutions.  ``after_admissions`` runs
    once, after the last prompt is admitted, between two decode steps."""
    from repro_torch.kernels import matmul as mm

    pending, done = list(prompts), []
    out = {"prompt_prefill_s": [], "prompt_bodies": [], "decode_s": 0.0, "steps": 0}
    while pending or engine.active:
        while pending and engine.free_slots:
            prompt = pending.pop(0)
            bodies0 = collections.Counter(body_counts(mm))
            n0 = len(rec.calls) if rec is not None else 0
            t0 = time.monotonic()
            req = engine.add_request(prompt, max_new_tokens=new_tokens)
            out["prompt_prefill_s"].append(time.monotonic() - t0)
            out["prompt_bodies"].append(dict(collections.Counter(body_counts(mm)) - bodies0))
            if len(prompt) == PRIME_PROMPT:
                out["prime_bodies"] = out["prompt_bodies"][-1]
                out["prime_calls"] = rec.calls[n0:] if rec is not None else []
            if req.done:
                done.append(req)
            if not pending and after_admissions is not None:
                after_admissions()
        t0 = time.monotonic()
        done.extend(engine.step())
        out["decode_s"] += time.monotonic() - t0
        out["steps"] += 1
        if out["steps"] > 1000:
            raise AssertionError("the slot engine did not converge")
    torch.cuda.synchronize()
    if len(done) != len(prompts) or any(len(r.generated) != new_tokens for r in done):
        raise AssertionError(f"engine finished {len(done)} requests with token counts "
                             f"{[len(r.generated) for r in done]}")
    if "prime_bodies" not in out:
        raise AssertionError(f"no {PRIME_PROMPT}-token prompt among {[len(p) for p in prompts]}")
    out["requests"], out["tokens"] = len(done), sum(len(r.generated) for r in done)
    out["generated"] = [r.generated for r in sorted(done, key=lambda r: r.uid)]
    out["prefill_s"] = sum(out["prompt_prefill_s"])
    out["decode_ms_per_step"] = 1e3 * out["decode_s"] / out["steps"]
    return out


def _desc(inst) -> str:
    return f"{inst.class_id} {dict(inst.params)}"


def phase_serve_tuned(torch, db, default_row: dict) -> dict:
    """recurrentgemma-2b at full width served through a schedule registry on
    the card, as a user would (``launch.serve.make_provider`` with
    ``--tuning-registry`` and ``--target h100``): the registry holds the
    tuning phase's donor records; the engine plans its decode step at init.
    Beside them the registry holds one record in rounding mode: the decode
    LM head's default tiles with ``cache_write=False`` (as the autoscheduler
    draws for 30% of its schedules); no other record has its workload, so
    the exact tier serves it and the kernel's rounding mode runs on the main
    path.  A warm pass resolves every prefill instance (exact prompt
    lengths, none planned: service lookups time the default and probe
    donors on the card inside the forward pass), then the deferred jobs are
    drained and the plan refreshed.  Then the timed pass, in which a record
    for a decode instance is published once every prompt is admitted (the
    engine re-plans at the next step boundary), and the measured runner
    must time nothing new.

    Checks: no new timing in the timed pass; at the prime prompt's prefill,
    K1 launches on the tensor-core body exactly where an exact or transfer
    resolution gives an M tile above 16 (the default run: none); every
    distinct non-default launch served agrees with its plain version (the
    same rounding K tile); the first prompt's prefill logits under the
    registry's schedules within the serve bound; one re-plan, two monotone
    plan generations in the timed pass."""
    import tempfile

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.database import Record
    from repro_torch.core.extract import extract_kernels
    from repro_torch.core.schedule import (GLU_CLASSES, Schedule, concretize, default_schedule,
                                           nearest_divisor)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    t_phase = time.monotonic()
    cfg = get_arch(TUNED_ARCH)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="registry-") as root:
        args = serve.parse_args(["--arch", TUNED_ARCH, "--preset", "full", "--device", "cuda",
                                 "--target", "h100", "--tuning-registry", root])
        provider, service = serve.make_provider(args)
        measured = service.runner.inner          # the MeasuredRunner behind the cache
        registry = service.registry              # publishes through it are seen at once
        registry.merge_db(db)
        model = build_model(cfg, "cuda")
        params = model.init(seed=0)
        prompts = serve_prompts(cfg)
        new_tokens = SERVE_NEW_TOKENS

        # the rounding-mode record: the decode step's least-used non-GLU
        # GEMM (the LM head), its default tiles without the f32 scratch
        decode = extract_kernels(cfg, ShapeConfig("serve_decode", 512, 4, "decode"))
        round_use = min((u for u in decode if u.instance.class_id in mm.EPILOGUE
                         and u.instance.class_id not in GLU_CLASSES),
                        key=lambda u: (u.use_count, -u.instance.p["N"]))
        round_inst = round_use.instance
        dflt = default_schedule(round_inst)
        k = round_inst.p["K"]
        tile_k = dflt.t["K"] if dflt.t["K"] < k else nearest_divisor(k, k // 2)
        round_sched = Schedule.make(round_inst.class_id, {**dflt.t, "K": tile_k}, order=dflt.order,
                                    cache_write=False, source="rounding-mode check")
        if mm.round_k_for(concretize(round_sched, round_inst)) != tile_k:
            raise AssertionError(f"{_desc(round_inst)}: {round_sched} does not round")
        round_rec = Record(instance=round_inst, schedule=round_sched,
                           seconds=service.runner.seconds(round_inst, round_sched),
                           model_id="serve/rounding-check", target=service.target)
        registry.publish([round_rec])

        t0 = time.monotonic()
        engine = ServingEngine(model, params, slots=4, max_len=512, provider=provider)
        plan_s = time.monotonic() - t0
        plan_init = {"entries": len(engine.plan), "tiers": engine.plan.tier_counts()}
        rec = ResolutionRecorder(provider)

        # warm pass: the prefill lookups, then the deferred jobs
        t0 = time.monotonic()
        warm = serve_stream(torch, engine, prompts, new_tokens, rec)
        warm_s = time.monotonic() - t0
        warm_calls = rec.take()
        t0 = time.monotonic()
        drained = service.drain()
        drain_s = time.monotonic() - t0
        engine.refresh_plan()
        for inst in {c[0].workload_key(): c[0] for c in warm_calls}.values():
            provider.pipeline.resolve(inst)   # at the new generation, before the timed pass
        if engine.plan.lookup(round_inst).schedule != round_sched:
            raise AssertionError(f"the plan does not serve the rounding-mode record: "
                                 f"{engine.plan.lookup(round_inst)}")

        # the mid-run record: a decode plan entry's schedule under another
        # unroll (the same launch, timed already), default tier first so
        # that it is served
        entries = sorted(engine.plan.items(), key=lambda ur: ur[1].tier != "default")
        mid_use, mid_res = entries[0]
        mid_sched = dataclasses.replace(mid_res.schedule, unroll=4 if mid_res.schedule.unroll != 4 else 16,
                                        source="mid-run publish")
        mid_rec = Record(instance=mid_use.instance, schedule=mid_sched,
                         seconds=service.runner.seconds(mid_use.instance, mid_sched),
                         model_id="serve/mid-run", target=service.target)

        # the timed pass
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        timings0 = measured.stats.measurements
        stats0, svc0 = provider.stats(), service.stats()
        replans0, history0 = engine.replans, len(engine.plan_history)
        timed = serve_stream(torch, engine, prompts, new_tokens, rec,
                             after_admissions=lambda: registry.publish([mid_rec]))
        new_timings = measured.stats.measurements - timings0
        calls = rec.take()
        launches = serve.kernel_launches()
        bodies = body_counts(mm)
        fwd_bodies = forward_bodies(mm, "serve_tuned")
        rounding = {f"{k}/{b}": c for (k, b), c in sorted(mm.round_launches.items())}
        stats1, svc1 = provider.stats(), service.stats()
        history = engine.plan_history[history0:]
        replans = engine.replans - replans0
        if new_timings:
            raise AssertionError(f"the measured runner timed {new_timings} launches in the timed pass")
        if min(launches[k] for k in SERVE_KERNELS[TUNED_ARCH]) <= 0:
            raise AssertionError(f"a kernel of the path was never launched: {launches}")
        if sum(mm.round_launches.values()) <= 0:
            raise AssertionError(f"the rounding-mode record never reached the kernel: {round_rec}")
        if replans != 1 or len(history) != 2 or not history[0][1] < history[1][1]:
            raise AssertionError(f"re-plans {replans}, plan history {history}")
        if engine.plan.lookup(mid_use.instance).schedule != mid_sched and mid_res.tier == "default":
            raise AssertionError("the mid-run record did not become the plan's entry")

        # the prime prompt: each K1 launch on the body its plan entry's M
        # tile gives (the tensor cores exactly where the registry gave a tile
        # above 16, the rows body elsewhere), rows launches included; under
        # the default schedules never the tensor cores
        planned = collections.Counter(
            (f"matmul/{instance_body(mm, inst, cs)}/{inst.dtype}", tier == "default")
            for inst, tier, cs, _ in timed["prime_calls"] if inst.class_id in mm.EPILOGUE)
        want_bodies = collections.Counter()
        for (key, _), n in planned.items():
            want_bodies[key] += n
        got_bodies = collections.Counter({k: n for k, n in timed["prime_bodies"].items()
                                          if k.startswith("matmul/")})
        want_mma = sum(want_bodies[f"matmul/{b}/bfloat16"] for b in mm.CTA_TILES)
        default_mma = sum(planned[f"matmul/{b}/bfloat16", True] for b in mm.CTA_TILES)
        if got_bodies != want_bodies or default_mma or not sum(want_bodies.values()):
            raise AssertionError(f"prime prefill: K1 launches per body {dict(got_bodies)}, planned "
                                 f"{dict(want_bodies)} (default-tier mma {default_mma})")
        if any(default_row["prime_prefill_body_launches"].get(f"matmul/{b}/bfloat16", 0)
               for b in mm.CTA_TILES):
            raise AssertionError("the default run's prime prefill took the tensor-core body")

        # every distinct non-default launch served, against its plain version
        checked, errs, rounding_checked = set(), {}, 0
        slower = []
        for inst, tier, cs, _ in warm_calls + calls:
            if tier == "default":
                continue
            key = measured.launch_key(cs)
            if key in checked:
                continue
            checked.add(key)
            got, want = _outputs(measured.run(cs)), _outputs(measured.run(cs, plain=True))
            name = f"{_desc(inst)} {cs.t} {key[1]}"
            errs[name] = max(assert_close(torch, g, w, BF16_TOL if i == 0 else STATE_TOL, name)
                             for i, (g, w) in enumerate(zip(got, want)))
            rounding_checked += bool(inst.class_id in mm.EPILOGUE and mm.round_k_for(cs))
            del got, want
            ms, dflt = (service.runner.seconds(inst, cs.schedule) * 1e3,
                        service.runner.seconds(inst) * 1e3)
            if ms > dflt:
                slower.append({"instance": _desc(inst), "tier": tier, "tiles": cs.t,
                               "ms": ms, "default_ms": dflt})
        if not rounding_checked:
            raise AssertionError("no rounding-mode launch among those checked")

        toks = torch.tensor([prompts[0]], dtype=torch.long, device="cuda")
        logits = prefill_logits_check(torch, model, params, toks, f"{TUNED_ARCH} (registry)",
                                      provider=provider)
        rec.close()
        profile = profile_decode(torch, engine, prompts[:4], provider=provider)
        misses = collections.Counter(_desc(inst) for inst, _, _, planned in calls if not planned)
        prime_i = [len(p) for p in prompts].index(PRIME_PROMPT)
        row = {
            "arch": TUNED_ARCH, "registry_records": len(db.records()),
            "plan_s": plan_s, "plan_init": plan_init,
            "plan": {"entries": len(engine.plan), "generation": engine.plan.generation,
                     "tiers": engine.plan.tier_counts()},
            "warm_s": warm_s, "warm_prefill_s": warm["prefill_s"], "drained_jobs": drained,
            "drain_s": drain_s,
            "lookups": {"exact": svc1["exact_hits"], "transfer": svc1["transfer_hits"],
                        "default": svc1["default_misses"]},
            "timed_lookups": {t: svc1[k] - svc0[k] for t, k in (("exact", "exact_hits"),
                                                                ("transfer", "transfer_hits"),
                                                                ("default", "default_misses"))},
            "timed_plan_served": {t: stats1["plan_served"][t] - stats0["plan_served"][t]
                                  for t in stats1["plan_served"]},
            "timed_plan_misses": stats1["plan_misses"] - stats0["plan_misses"],
            "timed_missed_instances": dict(misses),
            "timed_new_timings": new_timings,
            "prefill_s": timed["prefill_s"], "default_prefill_s": default_row["prefill_s"],
            "prefill_ratio": timed["prefill_s"] / default_row["prefill_s"],
            "prime_prefill_s": timed["prompt_prefill_s"][prime_i],
            "default_prime_prefill_s": default_row["prompt_prefill_s"][prime_i],
            "prime_prefill_ratio": (timed["prompt_prefill_s"][prime_i]
                                    / default_row["prompt_prefill_s"][prime_i]),
            "prompt_prefill_s": timed["prompt_prefill_s"],
            "decode_steps": timed["steps"], "decode_ms_per_step": timed["decode_ms_per_step"],
            "default_decode_ms_per_step": default_row["decode_ms_per_step"],
            "decode_ratio": timed["decode_ms_per_step"] / default_row["decode_ms_per_step"],
            "launches": launches, "body_launches": bodies, "round_launches": rounding,
            "forward_bodies": fwd_bodies,
            "prime_prefill_body_launches": timed["prime_bodies"],
            "default_prime_prefill_body_launches": default_row["prime_prefill_body_launches"],
            "prime_k1_mma_planned": want_mma,
            "prime_k1_bodies_compared": sum(want_bodies.values()),
            "rounding_record": {"instance": _desc(round_rec.instance),
                                "tiles": round_rec.schedule.t,
                                "shape": [round_inst.class_id, *(round_inst.p[a] for a in "MKN"),
                                          tile_k],
                                "ms": round_rec.seconds * 1e3,
                                "default_ms": service.runner.seconds(round_rec.instance) * 1e3},
            "mid_run_record": {"instance": _desc(mid_use.instance), "tier_before": mid_res.tier,
                               "tier_after": engine.plan.lookup(mid_use.instance).tier},
            "replans": replans, "plan_history": history,
            "checks": len(errs), "rounding_checks": rounding_checked,
            "max_abs_err": max(errs.values()), "slower_than_default": slower,
            **logits, "decode_profile": profile,
            "tuning_service": {k: svc1[k] for k in ("lookups", "jobs_enqueued", "jobs_completed",
                                                    "upgrades", "search_seconds_spent",
                                                    "probe_search_s", "generation")},
            "runner": measured.telemetry(), "wall_s": time.monotonic() - t_phase}
        log("serve_tuned", **row)
        service.close()
        del model, params, engine, provider, service, measured
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the paged engine: chunked prefill and speculative decoding
# ---------------------------------------------------------------------------

#: the paged and spec phases' geometry: 4 lanes, 512-token contexts, pages
#: of 16, chunks of 64, two chunks a step
PAGED = dict(decode_batch=4, max_ctx=512, page_size=16, chunk=64, chunks_per_step=2)
#: the preemption run's pool: 69 usable pages (1104 tokens) where the four
#: longest requests hold 1145 tokens at once (one preemption at seed 0)
PAGED_CUT_POOL = 70
#: extra pages of the fragmented run, held every other one by dummies
PAGED_SHRED = 24
#: the archs of the paged phase, the kernels each must launch (K2 at
#: q_offset > 0 where K2 is among them), and the scan each of its chunks
#: must launch once per recurrent layer.  recurrentgemma's local layers
#: (window 2048) and mixtral-8x22b's sliding-window layers (4096) hold a
#: window longer than the 512-token context: a ring that never wraps, whose
#: chunks take K2 at q_offset as a full-length cache's do (``attn_chunk``).
#: mixtral at its SERVE_DEPTH: K1g at a chunk's rows per expert (dropless),
#: 4 in decode
PAGED_ARCHS = {"minitron-4b": (("matmul", "flash_attention"), None),
               "rwkv6-1.6b": (("matmul", "rwkv6_scan"), "rwkv6_scan"),
               "recurrentgemma-2b": (("matmul", "flash_attention", "rglru_scan"), "rglru_scan"),
               "mixtral-8x22b": (("matmul", "flash_attention", "grouped_matmul"), None)}
#: the spec phase: a draft of minitron-4b's first two layers, 3 proposals a
#: burst (verify M = 4 lanes x 4 positions = 16 rows: K1's rows body, whose
#: bits do not depend on M), the serve prompts' first four
SPEC_K = 3
SPEC_KEEP = 2
SPEC_PROMPTS = 4
SPEC_PARTIAL_DAMP = 0.05


def phase_chunk_kernels(torch, timer) -> dict:
    """The paged path's new launch shapes, timed: K2 at minitron-4b's chunk
    shape (a 64-row chunk at q_offset 256 against the 512-row cache, GQA
    24/8, D = 128) beside its plain version and SDPA given the same boolean
    mask, and K1 at 64x3072x3072 (the chunk's q/o projection, tensor-core
    body) beside its plain version and ``torch.matmul``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(19)
    b, hq, hkv, c, skv, d, off = 1, 24, 8, 64, 512, 128, 256
    q, k, v = _attn_inputs(torch, g, b, hq, hkv, c, skv, d, torch.bfloat16)
    cs = ops.schedule_for(ops.instance("flash_attention_causal", torch.bfloat16, Q=c, KV=skv, H=hq,
                                       D=d, B=b, window=0))
    got = fa.launch(q, k, v, cs, q_offset=off)
    want = ref.chunked_attention(q, k, v, chunk=cs.t["KV"], q_offset=off)
    err_fa = assert_close(torch, got, want, BF16_TOL, "attention at the chunk shape")
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    mask = torch.arange(skv, device="cuda")[None, :] <= off + torch.arange(c, device="cuda")[:, None]
    sdpa = F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    err_sdpa = assert_close(torch, sdpa, want, BF16_TOL, "SDPA at the chunk shape")
    # the rows the causal mask needs: keys 0 .. off + c - 1
    live = c * off + c * (c + 1) / 2
    b_ms, b_by = bound_ms(2 * (2 * b * hq * c * d + 2 * b * hkv * (off + c) * d),
                          4 * b * hq * live * d)
    body, cta_q, ctas = fa.attention_geometry(torch.bfloat16, c, cs.t["Q"])
    attn_row = {"B": b, "Hq": hq, "Hkv": hkv, "C": c, "KV": skv, "D": d, "q_offset": off,
                "tiles": cs.t, "body": body, "ctas": b * hq * ctas, "max_abs_err": err_fa,
                "sdpa_max_abs_err": err_sdpa,
                "ms": timer.ms(lambda: fa.launch(q, k, v, cs, q_offset=off), iters=20),
                "plain_ms": timer.ms(lambda: ref.chunked_attention(q, k, v, chunk=cs.t["KV"],
                                                                   q_offset=off)),
                "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask), iters=20),
                "bound_ms": b_ms, "bound_by": b_by}
    attn_row["device_ms"] = timer.device_ms(lambda: fa.launch(q, k, v, cs, q_offset=off))
    attn_row["library_device_ms"] = timer.device_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    log("chunk_attention", **attn_row)

    m, n, kk = 64, 3072, 3072
    x, w, _ = _mm_inputs(torch, g, m, n, kk, "matmul", torch.bfloat16)
    cs = ops.schedule_for(ops.instance("matmul", torch.bfloat16, M=m, N=n, K=kk))
    body, cta_m, cta_n, split_k, ctas = mm.launch_geometry(torch.bfloat16, m, n, kk, cs.t["M"],
                                                           cs.t["N"])
    if body != "wgmma":
        raise AssertionError(f"K1 at {m}x{kk}x{n} takes the {body} body")
    got = mm.launch(x, w, cs)
    err_mm = assert_close(torch, got, ref.matmul(x, w), BF16_TOL, f"matmul {m}x{kk}x{n}")
    b_ms, b_by = bound_ms(2 * (m * kk + kk * n + m * n), 2 * m * n * kk)
    mm_row = {"class": "matmul", "M": m, "K": kk, "N": n, "tiles": cs.t, "body": body,
              "cta_tile": [cta_m, cta_n], "ctas": ctas, "max_abs_err": err_mm,
              "ms": timer.ms(lambda: mm.launch(x, w, cs), iters=20),
              "plain_ms": timer.ms(lambda: ref.matmul(x, w)),
              "library_ms": timer.ms(lambda: torch.matmul(x, w), iters=20),
              "bound_ms": b_ms, "bound_by": b_by,
              "device_ms": timer.device_ms(lambda: mm.launch(x, w, cs)),
              "library_device_ms": timer.device_ms(lambda: torch.matmul(x, w))}
    log("chunk_matmul", **mm_row)
    return {"attention": attn_row, "matmul": mm_row}


class EngineClock:
    """Host-clock seconds (each call between two syncs), calls, K1
    launches per body and K1g launches per body and rows per expert of a
    paged engine's model calls: ``_chunk``, ``_decode``, ``_spec_step`` and
    ``_verify``.  With ``scan`` (a scan kernel's module) it fails unless
    every chunk launched the scan ``per_chunk`` times (once per recurrent
    layer)."""

    CALLS = ("_chunk", "_decode", "_spec_step", "_verify")

    def __init__(self, torch, engine, scan=None, per_chunk: int = 0, grouped=None):
        from repro_torch.kernels import matmul as mm

        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.bodies = {name: collections.Counter() for name in self.CALLS}
        # K1g launches per (body, rows per expert), from ``grouped``: the
        # list :func:`traced_grouped_launches` fills
        self.grouped = {name: collections.Counter() for name in self.CALLS}
        grouped = [] if grouped is None else grouped
        for name in self.CALLS:
            real = getattr(engine, name)

            def timed(*args, _real=real, _name=name):
                torch.cuda.synchronize()
                scans0, bodies0 = (scan.launches if scan else 0), collections.Counter(body_counts(mm))
                g0 = len(grouped)
                t0 = time.monotonic()
                out = _real(*args)
                torch.cuda.synchronize()
                self.seconds[_name] += time.monotonic() - t0
                self.calls[_name] += 1
                self.bodies[_name] += collections.Counter(body_counts(mm)) - bodies0
                self.grouped[_name].update(grouped[g0:])
                if scan is not None and _name == "_chunk" and scan.launches - scans0 != per_chunk:
                    raise AssertionError(f"a chunk launched the scan {scan.launches - scans0} "
                                         f"times, not {per_chunk}")
                return out

            setattr(engine, name, timed)

    def ms(self, name: str) -> float | None:
        return 1e3 * self.seconds[name] / self.calls[name] if self.calls[name] else None


@contextlib.contextmanager
def traced_grouped_launches():
    """Every K1g launch while the context is open: [(body, rows per
    expert), ...]."""
    from repro_torch.kernels import matmul as mm

    plain, calls = mm.grouped_launch, []

    def traced(x, w, cs, **kw):
        calls.append((launch_body(mm, x, w, cs), x.shape[1]))
        return plain(x, w, cs, **kw)

    mm.grouped_launch = traced
    try:
        yield calls
    finally:
        mm.grouped_launch = plain


def free_engines(torch) -> None:
    """Free the engines dropped so far: ``EngineClock``'s wrappers and
    ``paged_run``'s preemption hook hold their engine in a reference cycle,
    which only the collector breaks, and an engine holds its params and its
    pool; peak memory is read after this."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def paged_run(torch, model, params, prompts, *, fragment: bool = False, scan=None,
              per_chunk: int = 0, grouped=None, **kw):
    """One stream of ``prompts`` (SERVE_NEW_TOKENS each) through a paged
    engine at the PAGED geometry: (engine, requests, clock, wall s, steps).
    ``fragment`` shreds the free list first (PAGED_SHRED extra pages,
    every other one held by a dummy for the whole run); ``grouped``: the
    K1g launches' list (``EngineClock``)."""
    from repro_torch.serving import PagedServingEngine

    geo = dict(PAGED, **kw)
    if fragment:
        geo["pool_pages"] = (geo["decode_batch"] * geo["max_ctx"] // geo["page_size"] + 1
                             + PAGED_SHRED)
    eng = PagedServingEngine(model, params, record_logits=True, **geo)
    eng.preempted_uids = set()
    real_preempt = eng._preempt

    def preempt(uid):
        eng.preempted_uids.add(uid)
        real_preempt(uid)

    eng._preempt = preempt
    if fragment:
        for i in range(PAGED_SHRED):
            eng.table.ensure(10 ** 6 + i, geo["page_size"])
        for i in range(0, PAGED_SHRED, 2):
            eng.table.release(10 ** 6 + i)
        if eng.table.fragmentation() <= 0.0:
            raise AssertionError("the shredded pool is not fragmented")
    clock = EngineClock(torch, eng, scan, per_chunk, grouped)
    t0 = time.monotonic()
    reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    steps = 0
    while eng.in_flight:
        eng.step()
        steps += 1
        if steps > 1000:
            raise AssertionError("the paged engine did not converge")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if not all(r.done and len(r.generated) == SERVE_NEW_TOKENS for r in reqs):
        raise AssertionError(f"paged engine finished with token counts "
                             f"{[len(r.generated) for r in reqs]}")
    return eng, reqs, clock, wall, steps


def first_divergence(torch, model, params, prompt, want, got) -> dict | None:
    """Where a stream ``got`` first leaves ``want`` (the slot engine's):
    the step and the top-2 margin of the logits there, from one prefill of
    the prompt and ``want``'s tokens before that step (None: no divergence).
    A MoE arch's also gives each layer's router margin at that position:
    the k-th largest expert probability less the (k+1)-th."""
    from repro_torch.models import mlp as mlpm

    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if step is None:
        return None
    toks = torch.tensor([prompt + want[:step]], dtype=torch.long, device="cuda")
    inner, probs = mlpm.moe_route, []

    def route(*args, **kw):   # the last position's router probabilities
        out = inner(*args, **kw)
        probs.append(out[0][-1].float())
        return out

    mlpm.moe_route = route
    try:
        logits, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    finally:
        mlpm.moe_route = inner
    top = torch.topk(logits[0].float(), 2).values
    out = {"step": step, "want": want[step], "got": got[step], "margin": float(top[0] - top[1])}
    if probs:
        k = model.cfg.moe_topk
        gaps = [float(p[k - 1] - p[k]) for p in (torch.sort(q, descending=True).values
                                                 for q in probs)]
        out.update(router_margin=min(gaps), router_margins=gaps)
    return out


def slot_prefill_rows(bodies: dict) -> list:
    """The launches of a slot engine's one-shot prefill (``bodies``, its
    matmul launches per body) that took the rows body's sums where the
    paged engine's chunks take the tensor cores': K1 beyond the LM head's
    one row (a prime length's 1-row tiles, ROADMAP B.1), K1g (tiles of at
    most 16 rows per expert) and a MoE arch's f32 router (1-row tiles)."""
    took = []
    if bodies.get("matmul/rows/bfloat16", 0) > 1:
        took.append("K1")
    if bodies.get("grouped_matmul/rows/bfloat16", 0):
        took.append("K1g")
    if bodies.get("matmul/rows/float32", 0):
        took.append("router")
    return took


def _cache_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_paged(torch, srv: list) -> list:
    """The paged engine at full width: minitron-4b (K1, K2), rwkv6-1.6b
    (K1, K3) and recurrentgemma-2b (K1, K2, K4) at full depth, mixtral-8x22b
    (K1, K2, K1g) at its SERVE_DEPTH, at the PAGED geometry, the serve
    phases' 8 prompts and 16 new tokens each, beside the slot engine
    (exact-length prefill) on the same weights, never two engines at once.

    Checks per arch: every request finishes; no prefill padding; each
    stream equals the slot engine's, where a divergence fails unless the
    top-2 margin at the first divergent step is below the logits bound and
    the arch is recurrent or the slot engine's prefill of that prompt took
    the rows body in K1, K1g or the router (:func:`slot_prefill_rows`: the
    prime 181-token prompt's 1-row tiles, where the paged engine's chunks
    run on the tensor cores and sum otherwise; a MoE arch's router margin
    is logged beside); each final chunk's logits within the logits bound
    of the slot engine's one-shot prefill logits (the larger of
    LOGITS_REL_BOUND of max |logit| and the serve phase's bound); the bf16
    matmul never on the CUDA-core body, the attention only on the
    tensor-core body; K2 launched at q_offset > 0 where it is on the path.
    minitron-4b: K1 on both the tensor-core and the rows bodies; a
    fragmented pool gives the same tokens and final-chunk logits, bit for
    bit; a pool cut to PAGED_CUT_POOL pages preempts and gives the
    same streams (a victim's, recomputed on resume, may leave at a near-tie
    only).  rwkv6-1.6b, recurrentgemma-2b: every chunk launches the
    scan once per recurrent layer.  mixtral-8x22b: K1g launched in the
    chunks (at most a chunk's rows per expert, on the tensor cores above 16)
    and in decode (4 rows per expert, on the rows body)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.paged import _leaves

    rows = []
    scans = {"rwkv6_scan": rw, "rglru_scan": rg}
    for arch, (kernels, scan_name) in PAGED_ARCHS.items():
        t_arch = time.monotonic()
        cfg = get_arch(arch)
        if arch in SERVE_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
        srv_row = next(r for r in srv if r["arch"] == cfg.name)
        free_engines(torch)
        model = build_model(cfg, "cuda")
        params = model.init(seed=0)
        prompts = serve_prompts(cfg)

        # the slot engine, exact-length prefill, same weights, same call
        slot = ServingEngine(model, params, slots=PAGED["decode_batch"],
                             max_len=PAGED["max_ctx"], prefill_buckets=False)
        t0 = time.monotonic()
        slot_run = serve_stream(torch, slot, prompts, SERVE_NEW_TOKENS)
        slot_wall = time.monotonic() - t0
        slot_bytes = _cache_bytes(_leaves(slot.cache))
        del slot
        free_engines(torch)

        # the main path: counts set to 0 just before, read just after
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        scan = scans.get(scan_name)
        per_chunk = sum(k == "R" for k in cfg.layer_kinds) if scan else 0
        with traced_grouped_launches() as grouped:
            eng, reqs, clock, wall, steps = paged_run(torch, model, params, prompts, scan=scan,
                                                      per_chunk=per_chunk, grouped=grouped)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = serve.kernel_launches()
        bodies = body_counts(mm)
        fwd_bodies = forward_bodies(mm, f"paged {arch}")
        attn_bodies = {f"{b}/{ops.dtype_name(d)}": n for (b, d), n in fa.body_launches.items()}
        offset_launches, fa_row_tiles = fa.offset_launches, fa.row_tile_launches
        fa_grouped = {str(t): n for t, n in sorted(fa.grouped_tile_launches.items())}
        mm_row_tiles = mm.row_tile_launches
        if eng.prefill_padded_tokens != eng.prefill_true_tokens:
            raise AssertionError(f"{arch}: paged prefill padded {eng.prefill_padded_tokens} "
                                 f"for {eng.prefill_true_tokens} tokens")
        if mm.body_count("fma", dtype=torch.bfloat16) or fa.body_count("fma", dtype=torch.bfloat16):
            raise AssertionError(f"{arch}: a bf16 launch took a CUDA-core body: {bodies}, "
                                 f"{attn_bodies}")
        if min(launches[k] for k in kernels) <= 0 or (
                "flash_attention" in kernels and offset_launches <= 0):
            raise AssertionError(f"{arch}: a kernel of the paged path was never launched: "
                                 f"{launches}, K2 at q_offset > 0 {offset_launches}")
        # K1g: in the chunks at most a chunk's rows per expert (dropless),
        # on the tensor cores above 16; in decode 4 rows on the rows body
        grouped_rows = {name: {f"{b}/{m}": n for (b, m), n in sorted(clock.grouped[name].items())}
                        for name in ("_chunk", "_decode")}
        if cfg.n_experts and (
                not clock.grouped["_chunk"]["wgmma", PAGED["chunk"]]
                or any(m > PAGED["chunk"] or (m > 16 and b != "wgmma")
                       for b, m in clock.grouped["_chunk"])
                or not clock.grouped["_decode"]
                or any(m > PAGED["decode_batch"] or b != "rows" for b, m in clock.grouped["_decode"])):
            raise AssertionError(f"{arch}: K1g launches per body and rows per expert {grouped_rows}")
        pool_bytes = _cache_bytes(eng.leaves)

        # streams against the slot engine's; final-chunk logits against its
        # one-shot prefill logits, within the serve phases' bound: the larger
        # of LOGITS_REL_BOUND of max |logit| and CONTROL_FACTOR times the f64
        # control, the control taken on this prompt where the serve phase's
        # (taken on the first prompt) is not enough
        divergences, logits_err, bounds = [], [], []
        for prompt, want, req, slot_bodies in zip(prompts, slot_run["generated"], reqs,
                                                  slot_run["prompt_bodies"]):
            div = first_divergence(torch, model, params, prompt, want, req.generated)
            toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
            one, _ = model.prefill(params, {"tokens": toks}, max_len=512)
            one = one[0].float().cpu()
            chunk = torch.from_numpy(eng.chunk_logits[req.uid])
            err = float((chunk - one).abs().max())
            bound = max(LOGITS_REL_BOUND * float(one.abs().max()), srv_row["logits_bound"])
            if err > bound:
                bound = max(bound, CONTROL_FACTOR * f64_control(torch, model, params, toks))
            logits_err.append(err)
            bounds.append(bound)
            if err > bound:
                raise AssertionError(f"{arch}: the {len(prompt)}-token prompt's final-chunk logits "
                                     f"differ from one-shot prefill's by {err} > {bound}")
            if div is not None:
                # a prompt whose slot prefill took the rows body in K1 (a
                # prime length's 1-row tiles, ROADMAP B.1), K1g or the f32
                # router sums otherwise than the paged engine's tensor-core
                # chunks, so its stream may leave at a near-tie; any other
                # must be exact
                slot_rows = slot_prefill_rows(slot_bodies)
                div.update(prompt_len=len(prompt), logits_bound=bound,
                           slot_prefill_rows=slot_rows,
                           near_tie_allowed=scan is not None or bool(slot_rows))
                divergences.append(div)
        log("paged_streams", arch=arch, divergences=divergences, logits_bounds=bounds,
            chunk_logits_max_abs_diff=logits_err)
        for div in divergences:
            if not div["near_tie_allowed"] or div["margin"] >= div["logits_bound"]:
                raise AssertionError(f"{arch}: a paged stream leaves the slot engine's: {div}")

        row = {"arch": cfg.name, "layers": cfg.n_layers, "geometry": PAGED,
               "requests": len(reqs), "tokens": sum(len(r.generated) for r in reqs),
               "steps": steps, "chunk_lens": sorted(eng._chunk_lens_run),
               "prefill_s": clock.seconds["_chunk"], "chunks": clock.calls["_chunk"],
               "decode_s": clock.seconds["_decode"], "decode_steps": clock.calls["_decode"],
               "decode_ms_per_step": clock.ms("_decode"),
               "decode_tok_per_s": (sum(len(r.generated) for r in reqs) - len(reqs))
               / clock.seconds["_decode"],
               "wall_s": wall,
               "slot": {"prefill_s": slot_run["prefill_s"],
                        "decode_ms_per_step": slot_run["decode_ms_per_step"],
                        "decode_tok_per_s": (slot_run["tokens"] - slot_run["requests"])
                        / slot_run["decode_s"],
                        "decode_steps": slot_run["steps"], "wall_s": slot_wall},
               "pool_bytes": pool_bytes, "slot_cache_bytes": slot_bytes,
               "serve_peak_gib": peak_gib,
               "launches": launches, "body_launches": bodies, "attention_body_launches": attn_bodies,
               "forward_bodies": fwd_bodies, "attention_offset_launches": offset_launches,
               "row_tile_launches": {"matmul": mm_row_tiles, "flash_attention": fa_row_tiles},
               "grouped_tile_launches": fa_grouped,
               "chunk_body_launches": dict(clock.bodies["_chunk"]),
               "decode_body_launches": dict(clock.bodies["_decode"]),
               "grouped_rows_launches": grouped_rows,
               "divergences": divergences, "chunk_logits_max_abs_diff": logits_err,
               "logits_bounds": bounds}

        if arch == "minitron-4b":
            if offset_launches <= 0 or mm.body_count("wgmma") <= 0 or mm.body_count("rows") <= 0:
                raise AssertionError(f"{arch}: K2 at q_offset > 0 {offset_launches}, K1 bodies "
                                     f"{bodies}")
            fr_eng, fr_reqs, _, _, fr_steps = paged_run(torch, model, params, prompts,
                                                        fragment=True)
            if [r.generated for r in fr_reqs] != [r.generated for r in reqs] or any(
                    not np_equal(fr_eng.chunk_logits[a.uid], eng.chunk_logits[b.uid])
                    for a, b in zip(fr_reqs, reqs)):
                raise AssertionError(f"{arch}: a fragmented pool changed the tokens or logits")
            del fr_eng
            free_engines(torch)
            cut_eng, cut_reqs, _, _, cut_steps = paged_run(torch, model, params, prompts,
                                                           pool_pages=PAGED_CUT_POOL)
            # a victim's generated tokens are prefilled again on resume, in
            # tensor-core chunks where decode ran them on the rows body: its
            # stream may leave at a near-tie; any other stream must be exact
            cut_div = []
            for p, a, b in zip(prompts, reqs, cut_reqs):
                div = first_divergence(torch, model, params, p, a.generated, b.generated)
                if div is not None:
                    div.update(prompt_len=len(p), victim=b.uid in cut_eng.preempted_uids)
                    cut_div.append(div)
            row.update(fragmented={"steps": fr_steps, "bit_equal": True},
                       preempted={"pool_pages": PAGED_CUT_POOL, "steps": cut_steps,
                                  "preemptions": cut_eng.preemptions,
                                  "victims": sorted(cut_eng.preempted_uids),
                                  "divergences": cut_div})
            if cut_eng.preemptions <= 0 or any(not d["victim"] or d["margin"] >= max(bounds)
                                               for d in cut_div):
                raise AssertionError(f"{arch}: the cut pool preempted {cut_eng.preemptions} "
                                     f"times; streams leave the full pool's: {cut_div}")
            del cut_eng
        row["phase_s"] = time.monotonic() - t_arch
        log("paged", **row)
        rows.append(row)
        del model, params, eng, clock
        free_engines(torch)
    return rows


def f64_control(torch, model, params, toks) -> float:
    """The distance between the plain path's prefill logits and the same
    path's with its matmuls accumulated in f64 (see ``f64_accumulation``)."""
    from repro_torch.kernels.ops import use_backend

    with use_backend("ref"):
        plain, _ = model.prefill(params, {"tokens": toks}, max_len=512)
        with f64_accumulation():
            control, _ = model.prefill(params, {"tokens": toks}, max_len=512)
    return max_err(torch, control, plain)


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def phase_spec(torch) -> dict:
    """Speculative decoding on the paged engine, minitron-4b at full width
    and depth: a self-draft of its first SPEC_KEEP layers, SPEC_K proposals
    a burst, the PAGED geometry, SPEC_PROMPTS of the serve prompts, 16 new
    tokens.  Three regimes: all-accept (damp 0: the damped target computes
    the draft's function), all-reject (the draft's LM head rolled by one
    column), partial (damp SPEC_PARTIAL_DAMP).  Checks in each: the
    committed streams equal the plain paged engine's on the same target,
    bit for bit; bursts ran; accepted == proposed, 0, or strictly between
    them; every verify projection took the rows body."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import make_self_draft

    t_phase = time.monotonic()
    cfg = get_arch("minitron-4b")
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)
    prompts = serve_prompts(cfg)[:SPEC_PROMPTS]
    out = {"arch": cfg.name, "spec_k": SPEC_K, "keep_layers": SPEC_KEEP, "geometry": PAGED,
           "prompt_lens": [len(p) for p in prompts], "regimes": {}}
    totals = collections.Counter()
    body_totals, fwd_totals = collections.Counter(), []
    plain = {}
    for regime, damp in (("all_accept", 0.0), ("all_reject", 0.0), ("partial", SPEC_PARTIAL_DAMP)):
        dcfg, dparams, tparams = make_self_draft(cfg, params, keep_layers=SPEC_KEEP, damp=damp)
        if regime == "all_reject":
            dparams = dict(dparams, lm_head=torch.roll(dparams["lm_head"], 1, dims=1))
        if damp not in plain:
            _, p_reqs, p_clock, _, _ = paged_run(torch, model, tparams, prompts)
            plain[damp] = ([r.generated for r in p_reqs], p_clock.ms("_decode"))
            del p_clock
            free_engines(torch)
        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        eng, reqs, clock, wall, steps = paged_run(
            torch, model, tparams, prompts, draft_model=build_model(dcfg, "cuda"),
            draft_params=dparams, spec_k=SPEC_K)
        totals.update(serve.kernel_launches())
        body_totals.update(body_counts(mm))
        fwd_totals.append(forward_bodies(mm, f"spec {regime}"))
        streams, plain_ms = plain[damp]
        equal = [r.generated for r in reqs] == streams
        verify_bodies = dict(clock.bodies["_verify"])
        row = {"damp": damp, "bit_equal_to_plain": equal, "steps": steps, "wall_s": wall,
               "bursts": eng.spec_bursts, "proposed": eng.spec_proposed,
               "accepted": eng.spec_accepted, "committed": eng.spec_committed,
               "committed_per_burst": eng.spec_committed / max(eng.spec_bursts, 1),
               "burst_calls": clock.calls["_spec_step"], "ms_per_burst": clock.ms("_spec_step"),
               "verify_ms": clock.ms("_verify"), "plain_ms_per_step": plain_ms,
               "decode_ms_per_step": clock.ms("_decode"), "verify_body_launches": verify_bodies}
        log("spec", regime=regime, **row)
        out["regimes"][regime] = row
        want_accept = {"all_accept": eng.spec_accepted == eng.spec_proposed,
                       "all_reject": eng.spec_accepted == 0,
                       "partial": 0 < eng.spec_accepted < eng.spec_proposed}[regime]
        if not equal:
            raise AssertionError(f"spec {regime}: the committed streams differ from plain decode's")
        if eng.spec_bursts <= 0 or not want_accept:
            raise AssertionError(f"spec {regime}: {eng.spec_bursts} bursts, accepted "
                                 f"{eng.spec_accepted} of {eng.spec_proposed}")
        if not verify_bodies or any("/rows/" not in key for key in verify_bodies):
            raise AssertionError(f"spec {regime}: verify's K1 bodies {verify_bodies}")
        del eng, clock, dparams, tparams
        free_engines(torch)
    out["launches"], out["body_launches"] = dict(totals), dict(body_totals)
    out["forward_bodies"] = merge_forward_bodies(fwd_totals)
    out["phase_s"] = time.monotonic() - t_phase
    del model, params
    free_engines(torch)
    return out


#: the fleet phase: the seeded trace (the reference's TrafficGenerator
#: parameters) at full-size prompts, run A's slot fleet and run B's paged
#: speculative one, and the self-draft's residual damping in run B (the
#: launcher's default, ``serve_fleet --spec-damp``)
FLEET_TRAFFIC = dict(seed=0, arrival_rate=0.5, short_lens=(32, 128), long_lens=(181, 356),
                     long_frac=0.25, new_tokens=(8, 16), prompt_cap=356)
FLEET_REQUESTS = 16
FLEET_MAX_LEN = 512
FLEET_A = dict(replicas=2, slots=4, policy="plan_aware", prefetch=True, slos="default")
FLEET_B = dict(replicas=1, engine="paged", speculative="auto", spec_k=SPEC_K,
               **{k: v for k, v in PAGED.items() if k != "max_ctx"})
FLEET_CLASS_MIX = {"chat": 0.7, "bulk": 0.3}
FLEET_DAMP = 0.02


class RunnerProbe:
    """A fleet's measured runner, watched: how many timings it made and
    their wall seconds, the kernel launches they made (kept out of the
    serving path's counts), and the launch keys of any timing made while an
    engine call ran (``in_steps``: the fleet must time between steps only)."""

    def __init__(self, torch, measured):
        from repro_torch.kernels import matmul as mm
        from repro_torch.launch import serve

        self.timings, self.wall_s, self.in_steps, self.depth = 0, 0.0, [], 0
        self.launches, self.bodies = collections.Counter(), collections.Counter()
        real = measured._seconds

        def seconds(cs):
            n0 = measured.stats.measurements
            l0, b0 = collections.Counter(serve.kernel_launches()), collections.Counter(body_counts(mm))
            t0 = time.monotonic()
            out = real(cs)
            if measured.stats.measurements != n0:
                self.timings += 1
                self.wall_s += time.monotonic() - t0
                self.launches += collections.Counter(serve.kernel_launches()) - l0
                self.bodies += collections.Counter(body_counts(mm)) - b0
                if self.depth:
                    self.in_steps.append(list(measured.launch_key(cs)))
            return out

        measured._seconds = seconds

    def watch(self, engine) -> None:
        for name in ("add_request", "step"):
            real = getattr(engine, name)

            def call(*args, _real=real, **kw):
                self.depth += 1
                try:
                    return _real(*args, **kw)
                finally:
                    self.depth -= 1

            setattr(engine, name, call)

    def snapshot(self) -> tuple:
        return self.timings, self.wall_s, collections.Counter(self.launches), \
            collections.Counter(self.bodies)


def fleet_run(torch, name: str, model, params, db, bound: float, srv_alone, **kw) -> dict:
    """One fleet run at the h100 target through a registry seeded with the
    tuning phase's donor records: the seeded trace served, its checks, and
    the row printed.  ``srv_alone(prompt, n)`` serves one prompt alone on an
    engine of the same kind and weights (default schedules) and returns its
    tokens.  The launch counts are the serve's, set to 0 just before it and
    read just after, the measured runner's own launches taken out."""
    import contextlib
    import io
    import tempfile

    from repro_torch.fleet import ServingFleet, TrafficGenerator, percentile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve, trace_report
    from repro_torch.obs import Tracer
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.service import ScheduleRegistry

    t_run = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="fleet-") as root:
        registry = ScheduleRegistry(f"{root}/registry")
        registry.merge_db(db)
        tracer = Tracer()
        t0 = time.monotonic()
        fleet = ServingFleet(model.cfg, model, params, max_len=FLEET_MAX_LEN, registry=registry,
                             targets="h100", tracer=tracer, **kw)
        build_s = time.monotonic() - t0
        runner = fleet.runner_for("h100")
        measured = runner.inner
        if type(measured).__name__ != "MeasuredRunner" or fleet.services["h100"].runner is not \
                runner or any(r._runner is not runner for r in fleet.replicas):
            raise AssertionError(f"fleet {name}: the h100 target is not priced by one shared "
                                 f"MeasuredRunner: {type(measured).__name__}")
        probe = RunnerProbe(torch, measured)
        for r in fleet.replicas:
            probe.watch(r.engine)
        build_timings = measured.stats.measurements
        tiers_before = [r.engine.plan.tier_counts() for r in fleet.replicas]
        gen = TrafficGenerator(vocab_size=model.cfg.vocab_size, tick_s=fleet.tick_s,
                               class_mix=FLEET_CLASS_MIX if kw.get("speculative") else None,
                               **FLEET_TRAFFIC)
        trace = gen.trace(FLEET_REQUESTS)
        prompts = {r.uid: (r.prompt, r.max_new_tokens) for r in trace}

        for kmod in (mm, fa, rw, rg):
            kmod.reset_launches()
        before = probe.snapshot()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        try:
            summary = fleet.serve(trace)
        finally:
            fleet.close()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        after = probe.snapshot()
        runner_launches = after[2] - before[2]
        launches = {k: v - runner_launches[k] for k, v in serve.kernel_launches().items()}
        bodies = dict(collections.Counter(body_counts(mm)) - (after[3] - before[3]))
        fwd_bodies = forward_bodies(mm, f"fleet {name}")
        trace_path = f"{root}/trace.json"
        write_chrome_trace(trace_path, tracer)
        with contextlib.redirect_stdout(io.StringIO()):
            report = trace_report.main([trace_path, "--json"])

    # every request completed, or shed for a reason the summary gives
    shed = {fr.uid: fr.shed for fr in fleet.metrics.shed}
    if summary["completed"] + summary["shed"] != FLEET_REQUESTS or any(
            not why for why in shed.values()) or sum(summary["shed_by_reason"].values()) != \
            summary["shed"]:
        raise AssertionError(f"fleet {name}: {summary['completed']} completed, shed {shed}, "
                             f"by reason {summary['shed_by_reason']}")
    if summary["schedule_mismatches"]:
        raise AssertionError(f"fleet {name}: {summary['schedule_mismatches']} schedule mismatches")
    if probe.in_steps:
        raise AssertionError(f"fleet {name}: the measured runner timed {probe.in_steps} while an "
                             "engine call ran")
    if min(launches.get(k, 0) for k in ("matmul", "flash_attention")) <= 0:
        raise AssertionError(f"fleet {name}: the served path did not launch K1 and K2: {launches}")
    if mm.body_count("fma", dtype=torch.bfloat16) or fa.body_count("fma", dtype=torch.bfloat16):
        raise AssertionError(f"fleet {name}: a bf16 launch took a CUDA-core body: {bodies}")
    cp = report["critical_path"]
    if report["latency"]["requests"] != summary["completed"] or cp["attributed_frac"] != 1.0:
        raise AssertionError(f"fleet {name}: trace_report attributes {cp['attributed_frac']} of "
                             f"the critical path over {report['latency']['requests']} requests")

    # each completed request's tokens against the same engine serving its
    # prompt alone; a parting is allowed only at a near-tie (top-2 margin
    # below the serve phase's logits bound): a replica that re-planned
    # mid-stream may sum a projection on another K1 body than the defaults
    t0 = time.monotonic()
    divergences = []
    for fr in sorted(fleet.metrics.completed, key=lambda r: r.uid):
        prompt, n = prompts[fr.uid]
        want = srv_alone(prompt, n)
        if len(fr.generated) != n:
            raise AssertionError(f"fleet {name}: request {fr.uid} made {len(fr.generated)} of "
                                 f"{n} tokens")
        div = first_divergence(torch, model, params, prompt, want, fr.generated)
        if div is not None:
            div.update(uid=fr.uid, prompt_len=len(prompt), bound=bound)
            divergences.append(div)
    alone_s = time.monotonic() - t0
    log(f"fleet_{name}_streams", compared=summary["completed"], divergences=divergences,
        rule=f"a parting allowed only where the top-2 margin is below {bound}", alone_s=alone_s)
    if any(d["margin"] >= bound for d in divergences):
        raise AssertionError(f"fleet {name}: a stream leaves the alone run's: {divergences}")

    done = fleet.metrics.completed
    ttft = [fr.prefill_done_s - fr.arrival_s for fr in done]
    virtual = summary["makespan_s"]
    row = {"run": name, "engine": summary["engine"], "replicas": len(fleet.replicas),
           "requests": FLEET_REQUESTS, "completed": summary["completed"],
           "shed_by_reason": summary["shed_by_reason"], "tokens": summary["tokens"],
           "tick_s": summary["tick_s"], "virtual_s": virtual, "wall_s": wall,
           "wall_over_virtual": wall / virtual,
           "latency_s": summary["latency_s"],
           "ttft_s": {"p50": percentile(ttft, 50), "p95": percentile(ttft, 95)},
           "throughput_tok_per_s_virtual": summary["throughput_tok_per_s"],
           "throughput_tok_per_s_wall": summary["tokens"] / wall,
           "runner": {"build_timings": build_timings, "timings": after[0],
                      "serve_timings": after[0] - before[0], "timing_wall_s": after[1],
                      "serve_timing_wall_s": after[1] - before[1], "in_steps": 0,
                      "launches": dict(after[2])},
           "tuning": {k: summary["tuning"]["h100"][k]
                      for k in ("lookups", "exact_hits", "transfer_hits", "default_misses",
                                "jobs_enqueued", "jobs_completed", "upgrades", "in_flight",
                                "search_seconds_spent")},
           "tiers_before": tiers_before,
           "tiers_after": [r["plan_tiers"] for r in summary["replicas"]],
           "replans": [r["replans"] for r in summary["replicas"]],
           "schedule_mismatches": summary["schedule_mismatches"],
           "critical_path": {"segments": cp["segments"], "attributed_frac": cp["attributed_frac"]},
           "launches": launches, "body_launches": bodies, "divergences": divergences,
           "forward_bodies": fwd_bodies,
           "build_s": build_s, "alone_s": alone_s, "run_s": time.monotonic() - t_run}
    if "speedup_ledger" in summary:
        row["speedup_ledger"] = {k: summary["speedup_ledger"][k]
                                 for k in ("workloads", "tuned_workloads", "realized_speedup",
                                           "attainable_speedup", "realized_fraction", "tiers")}
    if "speculative" in summary:
        # the admit-time decision's inputs: the cells' measured kernel ms and
        # the projected gain at the acceptance prior (auto speculates above 1)
        prior = summary["speculative"]["acceptance"]["prior_alpha"]
        row["speculative"] = {
            "counters": summary["speculative"]["counters"],
            "acceptance": summary["speculative"]["acceptance"],
            "cells_ms": [{"decode": 1e3 * r.decode_cost(), "verify": 1e3 * r.verify_cost(),
                          "draft_decode": 1e3 * r.draft_decode_cost(),
                          "gain_at_prior": r.spec_gain(prior),
                          "verify_top": [[u.instance.class_id, dict(u.instance.params),
                                          u.use_count, 1e3 * s] for u, s in sorted(
                              r.cell_workload_seconds("verify"), key=lambda us: -us[1])[:4]]}
                         for r in fleet.replicas if r.spec_capable]}
    if "slo" in summary:
        row["slo"] = {k: {f: v[f] for f in ("alerting_windows", "evaluations", "alerting_now")}
                      for k, v in summary["slo"].items()}
    log(f"fleet_{name}", **row)
    del fleet, tracer, probe
    free_engines(torch)
    return row


def phase_fleet(torch, db, srv: list) -> list:
    """The serving fleet (``repro_torch.fleet``) at minitron-4b's full width
    and depth, bf16, random weights from seed 0, on its virtual clock read
    from the port's kernels timed on the card (the ``h100`` target:
    ``CachedRunner(MeasuredRunner())``, one per target), through a registry
    of the tuning phase's donor records: FLEET_REQUESTS requests of the
    seeded trace (FLEET_TRAFFIC: 32-356-token prompts, 8-16 new tokens).
    Run A: two slot replicas of 4 slots sharing one copy of the weights,
    plan-aware routing, demand-driven prefetch, default SLOs, a tracer.
    Run B: one paged replica (4 lanes, pages of 16, chunks of 64, two a
    step), speculative ``auto`` over a 2-layer self-draft, spec_k 3,
    chat/bulk traffic.  Checks in each (``fleet_run``): every request
    completed or shed for a reason given; 0 schedule mismatches; the
    measured runner never timed while an engine call ran; K1 and K2
    launched, no bf16 launch on a CUDA-core body; ``trace_report`` over the
    run's Chrome trace attributes 100% of the critical path; each request's
    tokens equal its prompt served alone, or part at a near-tie."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import PagedServingEngine, ServingEngine, make_self_draft

    t_phase = time.monotonic()
    cfg = get_arch("minitron-4b")
    bound = next(r for r in srv if r["arch"] == cfg.name)["logits_bound"]
    free_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    params = model.init(seed=0)

    slot = ServingEngine(model, params, slots=FLEET_A["slots"], max_len=FLEET_MAX_LEN)

    def slot_alone(prompt, n):
        req = slot.add_request(prompt, max_new_tokens=n)
        slot.run_to_completion()
        return req.generated

    rows = [fleet_run(torch, "A", model, params, db, bound, slot_alone, **FLEET_A)]
    del slot
    free_engines(torch)

    dcfg, dparams, tparams = make_self_draft(cfg, params, keep_layers=SPEC_KEEP,
                                             damp=FLEET_DAMP)
    paged = PagedServingEngine(model, tparams, max_ctx=FLEET_MAX_LEN,
                               **{k: v for k, v in PAGED.items() if k != "max_ctx"})

    def paged_alone(prompt, n):
        req = paged.add_request(prompt, max_new_tokens=n)
        paged.run_to_completion()
        return req.generated

    rows.append(fleet_run(torch, "B", model, tparams, db, bound, paged_alone,
                          draft_model=build_model(dcfg, "cuda"), draft_params=dparams,
                          **FLEET_B))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for row in rows:
        row["phase_peak_gib"] = peak
    log("fleet", runs=[r["run"] for r in rows], peak_gib=peak,
        phase_s=time.monotonic() - t_phase)
    del paged, model, params, tparams, dparams
    free_engines(torch)
    return rows


# ---------------------------------------------------------------------------
# train: gemma2-2b trained at full width on the kernels, forward and backward
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma2-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
#: K2 backward shapes checked against autograd of the plain version,
#: (name, B, Hq, Hkv, S, D, causal, window, softcap): gemma2's heads with a
#: window that bites at 512 and softcap 50, the same global, minitron's
#: GQA, a non-causal head and a prime length
ATTN_BWD_CHECKS = (("gemma2_window", 1, 8, 4, 512, 256, True, 128, 50.0),
                   ("gemma2_global", 1, 8, 4, 512, 256, True, 0, 50.0),
                   ("minitron", 1, 24, 8, 512, 128, True, 0, 0.0),
                   ("noncausal", 1, 16, 16, 300, 64, False, 0, 0.0),
                   ("prime", 1, 8, 4, 181, 256, True, 0, 0.0))
#: K2 backward shapes timed: gemma2's two layer kinds at the training batch
#: (the local layer's window, 4096, does not bite at 512 and it has no
#: softcap: SDPA computes the same function), and minitron's heads
ATTN_BWD_TIMED = (("gemma2_local", 4, 8, 4, 512, 256, True, 4096, 0.0),
                  ("gemma2_global", 4, 8, 4, 512, 256, True, 0, 50.0),
                  ("minitron", 1, 24, 8, 512, 128, True, 0, 0.0))
#: K2's backward before its tensor-core redesign (the CUDA-core f32
#: kernels), timed by this script on an NVIDIA H100 80GB HBM3 at 700.00 W:
#: (event ms, held ms) per row name, reported beside this run's times
EARLIER_ATTN_BWD_MS = {"gemma2_local": (3.336, 3.238), "gemma2_global": (3.403, 3.286),
                       "minitron": (1.360, 1.320), "whisper_encoder": (21.90, 21.75),
                       "whisper_self": (1.310, 1.294), "whisper_cross": (6.817, 6.699),
                       "mixtral": (6.512, 6.467), "recurrentgemma": (6.202, 6.083)}
#: gemma2's K1 launches at the training batch (M = 4 x 512 tokens):
#: (name, class, M, K, N): the q, k/v and o projections, the GeGLU up and
#: down projections and the tied, softcapped LM head
MM_BWD_SHAPES = (("q", "matmul", 2048, 2304, 2048), ("kv", "matmul", 2048, 2304, 1024),
                 ("o", "matmul", 2048, 2048, 2304), ("up", "matmul_gelu_glu", 2048, 2304, 18432),
                 ("down", "matmul", 2048, 9216, 2304),
                 ("head", "matmul_lmhead_softcap", 2048, 2304, 256000))
# Kernel path against plain path, end to end: gemma2-2b at full width and 2
# layers, one batch, the loss and every gradient leaf.  Both paths round each
# op's output to bf16 in the same places; f32 sums taken in other orders
# round to neighbouring bf16 values (2^-8 relative), and the backward adds
# one more such rounding per product (dZ enters dX and dW in bf16).  Over
# the ~15 ops between a leaf and the loss that stays within a few percent of
# the leaf's largest gradient entry, and the loss (a mean over 2044
# positions) well inside 0.5%.
TRAIN_LOSS_REL = 5e-3
TRAIN_GRAD_COS = 0.995
TRAIN_GRAD_MAXREL = 5e-2


def attention_bwd_launch(fa, q, k, v, do, cs, kw) -> tuple:
    """One K2 backward as training runs it: the forward with its row
    log-sum-exp, then the backward kernels; fails unless the launch took
    the body its dtype rules (bf16: ``mma``).  (o, lse, grads)."""
    o, lse = fa.launch(q, k, v, cs, with_lse=True, **kw)
    body = fa.body_for(q.dtype)
    before = fa.bwd_body_launches[body, q.dtype]
    grads = fa.launch_bwd(q, k, v, o, lse, do, **kw)
    if fa.bwd_body_launches[body, q.dtype] != before + 1:
        raise AssertionError(f"K2 backward: a {q.dtype} launch did not take the {body} body")
    return o, lse, grads


def attention_bwd_timing(timer, fa, name, q, k, v, o, lse, do, kw, sdpa) -> dict:
    """A K2 backward row's layout and times: body, group parts and column
    blocks (``flash_attention.bwd_geometry``), CTAs and shared bytes (dq,
    dkv) as the library plans the launch (``bwd_library_geometry``; fails
    unless its CTAs are the layout's); event and
    held ms (:meth:`Timer.held_ms`: late in this script the profiler's
    captures of these calls came back empty or with the first few calls
    only); SDPA's forward and backward under autograd where it computes the
    same function (``sdpa`` not None), with the same-call ratios; each
    kernel's device time (profiler); the CUDA-core kernels' times before
    the redesign (``EARLIER_ATTN_BWD_MS``)."""
    b, hq, sq, d = q.shape
    shape = (b, hq, k.shape[1], sq, k.shape[2], d, q.dtype)
    geo, lib = fa.bwd_geometry(*shape), fa.bwd_library_geometry(*shape)
    if (lib["dq_ctas"], lib["dkv_ctas"]) != (geo["dq_ctas"], geo["dkv_ctas"]):
        raise AssertionError(f"K2 backward {name}: the library launches {lib}, the layout says {geo}")
    row = {"body": geo["body"], "parts": geo["parts"], "col_blocks": geo["col_blocks"], **lib,
           "ms": timer.ms(lambda: fa.launch_bwd(q, k, v, o, lse, do, **kw)),
           "held_ms": timer.held_ms(lambda: fa.launch_bwd(q, k, v, o, lse, do, **kw)),
           # each kernel's device time (None where late captures drop events, C.9)
           "kernels_ms": timer.kernel_ms(lambda: fa.launch_bwd(q, k, v, o, lse, do, **kw)),
           "library_ms": None, "library_held_ms": None}
    if sdpa is not None:
        row["library_ms"], row["library_held_ms"] = timer.ms(sdpa), timer.held_ms(sdpa)
    row["sdpa_ratio"] = ratio(row["ms"], row["library_ms"])
    row["sdpa_held_ratio"] = ratio(row["held_ms"], row["library_held_ms"])
    earlier = EARLIER_ATTN_BWD_MS.get(name)
    row["earlier_ms"], row["earlier_held_ms"] = earlier if earlier else (None, None)
    row["speedup_held"] = ratio(row["earlier_held_ms"], row["held_ms"])
    return row


def attention_bwd_phase(torch, timer) -> dict:
    """K2's backward kernels against autograd of their plain version
    (``ref.chunked_attention_bwd``) at ``ATTN_BWD_CHECKS``, bf16 (the
    tensor-core body) and f32 (the CUDA-core body), with the forward's row
    log-sum-exp against ``ref.attention_lse``; then, at ``ATTN_BWD_TIMED``
    (the training batch), checked alike in bf16 and timed
    (:func:`attention_bwd_timing`) beside the plain version and the forward
    kernel; ``bound_share`` is the bound over the held (device) time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(31)

    def inputs(b, hq, hkv, s, d, dtype):
        q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))
        return q, k, v, torch.randn((b, hq, s, d), generator=g, device="cuda").to(dtype)

    def cs_for(dtype, b, hq, s, d, window):
        return ops.schedule_for(ops.instance("flash_attention_causal", dtype, Q=s, KV=s, H=hq,
                                             D=d, B=b, window=window))

    checks, errs = [], {"bf16": 0.0, "f32": 0.0}
    for name, b, hq, hkv, s, d, causal, window, softcap in ATTN_BWD_CHECKS:
        for dtype, tol, key in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
            q, k, v, do = inputs(b, hq, hkv, s, d, dtype)
            kw = dict(causal=causal, window=window, softcap=softcap)
            o, lse, got = attention_bwd_launch(fa, q, k, v, do, cs_for(dtype, b, hq, s, d, window), kw)
            want = ref.chunked_attention_bwd(q, k, v, do, **kw)
            row = {"name": name, "dtype": key, "body": fa.body_for(dtype),
                   "lse": assert_close(torch, lse, ref.attention_lse(q, k, **kw), F32_TOL,
                                       f"attention lse {name} {key}")}
            for grad, a, w in zip(("dq", "dk", "dv"), got, want):
                row[grad] = assert_close(torch, a, w, tol, f"attention backward {name} {key} {grad}")
                errs[key] = max(errs[key], row[grad])
            checks.append(row)
            del q, k, v, do, o, lse, got, want
    log("train_attention_bwd_checks", checks=checks)

    timed = []
    for name, b, hq, hkv, s, d, causal, window, softcap in ATTN_BWD_TIMED:
        q, k, v, do = inputs(b, hq, hkv, s, d, torch.bfloat16)
        kw = dict(causal=causal, window=window, softcap=softcap)
        cs = cs_for(torch.bfloat16, b, hq, s, d, window)
        # at the training batch too (B > 1: the b·Hkv + h/group indexing)
        o, lse, got = attention_bwd_launch(fa, q, k, v, do, cs, kw)
        want = ref.chunked_attention_bwd(q, k, v, do, **kw)
        max_errs = {grad: assert_close(torch, a, w, BF16_TOL, f"attention backward {name} bf16 {grad}")
                    for grad, a, w in zip(("dq", "dk", "dv"), got, want)}
        errs["bf16"] = max(errs["bf16"], *max_errs.values())
        del got, want
        live = sum(min(i + 1, window) if window else i + 1 for i in range(s)) if causal else s * s
        nbytes = 2 * (4 * b * hq * s * d + 4 * b * hkv * s * d)   # q, o, dO, dQ; k, v, dK, dV
        b_ms, b_by = bound_ms(nbytes, 10 * b * hq * live * d)      # 2.5x the forward's 4·live·D
        ke = ve = sdpa = None
        if not softcap and (window == 0 or window >= s):
            # one library call computing the same function: SDPA forward and
            # backward under autograd (the kv heads repeated outside the clock)
            ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

            def sdpa():
                leaves = [t.detach().requires_grad_() for t in (q, ke, ve)]
                out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
                return torch.autograd.grad(out, leaves, do)

        row = {"name": name, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": window,
               "softcap": softcap, "max_abs_err": max_errs, "bound_ms": b_ms, "bound_by": b_by,
               **attention_bwd_timing(timer, fa, name, q, k, v, o, lse, do, kw, sdpa),
               "fwd_ms": timer.ms(lambda: fa.launch(q, k, v, cs, with_lse=True, **kw)),
               "plain_ms": timer.ms(lambda: ref.chunked_attention_bwd(q, k, v, do, **kw), iters=3)}
        row["fwd_bwd_ms"] = row["fwd_ms"] + row["ms"]
        row["bound_share"] = row["bound_ms"] / row["held_ms"]
        timed.append(row)
        log("train_attention_bwd_shape", **row)
        del q, k, v, do, o, lse, ke, ve
    torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed, "max_abs_err": errs["bf16"],
            "f32_max_abs_err": errs["f32"]}


#: a gradient row's fields on the kernels line
GRAD_LINE_FIELDS = ("ms", "held_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_held_ms", "composed_ms", "composed_held_ms", "library_held_ratio",
                    "speedup_held", "bound_share")


def grad_timing(torch, timer, a, b, what: str, iters: int = 10) -> dict:
    """One gradient GEMM ``a @ b`` (per expert for 3-D operands) on the
    views the backward passes: checked against the plain version on the same
    views (``GRAD_SCALE_ATOL``·max|plain| + ``GRAD_RTOL``·|plain|) and two
    launches bit-equal; then timed three ways in turns (new, composed,
    library, library, composed, new), by events (``ms``) and behind a stream
    hold (``held_ms``): the gradient launch (``csrc/matmul_grad.cu``), the
    copy-then-forward composition it replaced (``composed_ms``: contiguous
    copies of the transposed operands and the forward's launch under the
    same default schedule, the copies included) and one library call on the
    same views
    (``torch.matmul``, ``torch.bmm``); the plain version's time
    (``plain_ms``); with the bound and the ratios."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    grouped = a.dim() == 3
    e, (m, k), n = (a.shape[0] if grouped else 1), a.shape[-2:], b.shape[-1]
    if grouped:
        cs = mm.grouped_grad_schedule("moe_gemm", a.dtype, e, m, n, k)
        new = lambda: mm.grouped_grad_launch(a, b)
        composed = lambda: mm.grouped_launch(a.contiguous(), b.contiguous(), cs)
        library = lambda: torch.bmm(a, b)
        plain_fn = lambda: ref.grouped_matmul(a, b)
    else:
        cs = mm.grad_schedule("matmul", a.dtype, m, n, k)
        new = lambda: mm.grad_launch(a, b)
        composed = lambda: mm.launch(a.contiguous(), b.contiguous(), cs)
        library = lambda: torch.matmul(a, b)
        plain_fn = lambda: ref.matmul(a, b)
    plain = plain_fn()
    geo = mm.grad_geometry(a, b)
    body = geo["body"]
    cta = mm.grad_cta(body, m, n, geo["tile_m"], geo["tile_n"], e)
    before = mm.grad_body_launches[("grouped_matmul" if grouped else "matmul"), body, a.dtype]
    got = new()
    if mm.grad_body_launches[("grouped_matmul" if grouped else "matmul"), body, a.dtype] != before + 1:
        raise AssertionError(f"{what}: the launch was not counted under its body {body}")
    scale = float(plain.float().abs().max())
    max_err = assert_close(torch, got, plain, dict(rtol=GRAD_RTOL, atol=GRAD_SCALE_ATOL * scale), what)
    if not bits_equal(torch, got, new()):
        raise AssertionError(f"{what}: two launches differ")
    del got, plain
    b_ms, b_by = bound_ms(2 * e * (m * k + k * n + m * n), 2 * e * m * k * n)
    times = collections.defaultdict(list)
    for key, fn in (("", new), ("composed_", composed), ("library_", library),
                    ("library_", library), ("composed_", composed), ("", new)):
        times[f"{key}ms"].append(timer.ms(fn, iters=iters))
        times[f"{key}held_ms"].append(timer.held_ms(fn, iters=iters))
    row = {"M": m, "K": k, "N": n, "E": e, "body": body, "cta_tile": f"{cta[0]}x{cta[1]}",
           "ctas": cta[2] * e, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": max_err, "max_rel_err": max_err / scale if scale else 0.0,
           **{key: statistics.mean(v) for key, v in times.items()},
           "plain_ms": timer.ms(plain_fn, iters=3)}
    row["library_ratio"] = ratio(row["ms"], row["library_ms"])
    row["library_held_ratio"] = ratio(row["held_ms"], row["library_held_ms"])
    row["speedup_held"] = ratio(row["composed_held_ms"], row["held_ms"])
    row["bound_share"] = row["bound_ms"] / row["held_ms"]
    return row


def matmul_bwd_phase(torch, timer) -> dict:
    """K1's backward (``MatmulFn``: dX and dW as gradient launches, the
    epilogue's derivative elementwise) against autograd of the plain
    version for each class gemma2 runs, at its training shapes (the tied
    head through ``transpose_of``); then dX's and dW's (the head's dE)
    launches checked and timed by :func:`grad_timing` beside the
    copy-then-forward composition and ``torch.matmul`` of the same views,
    and the plain backward whole."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(32)
    rows, err = [], 0.0
    for name, class_id, m, k, n in MM_BWD_SHAPES:
        n_out = n // 2 if "glu" in class_id else n
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        dy = (torch.randn((m, n_out), generator=g, device="cuda") / n_out ** 0.5).to(torch.bfloat16)
        kw = dict(softcap=30.0) if class_id == "matmul_lmhead_softcap" else {}
        tied = name == "head"
        src = w.T.contiguous() if tied else None          # the embedding (V, D)

        def grads(backend):
            xs = x.clone().requires_grad_()
            if tied:
                ws = src.clone().requires_grad_()
                y = ops.matmul(xs, w, class_id=class_id, transpose_of=ws, backend=backend, **kw)
            else:
                ws = w.clone().requires_grad_()
                y = ops.matmul(xs, ws, class_id=class_id, backend=backend, **kw)
            return torch.autograd.grad(y, (xs, ws), dy)

        before = mm.grad_launches
        dx, dw = grads("cuda")
        if mm.grad_launches == before:
            raise AssertionError(f"K1 backward {name}: no gradient launch")
        rx, rw = grads("ref")
        row = {"name": name, "class": class_id, "M": m, "K": k, "N": n, "tied": tied}
        for part, got, want in (("dx", dx, rx), ("dw", dw, rw)):
            scale = float(want.float().abs().max())
            tol = dict(rtol=GRAD_RTOL, atol=GRAD_SCALE_ATOL * scale)
            row[f"{part}_err"] = assert_close(torch, got, want, tol, f"K1 backward {name} {part}")
            row[f"{part}_scale"] = scale                    # max |plain|
            row[f"{part}_rel"] = row[f"{part}_err"] / scale
        err = max(err, row["dx_err"], row["dw_err"])
        # dX = dZ (M, N) @ w^T (N, K); dW = x^T (K, M) @ dZ (M, N) (the tied
        # head's: dZ^T (N, M) @ x (M, K)), on the views MatmulFn.backward passes
        dz = dy if "glu" not in class_id else torch.randn((m, n), generator=g, device="cuda").to(
            torch.bfloat16)
        wt = src if tied else w.T
        a_w, b_w = (dz.T, x) if tied else (x.T, dz)
        for part, (a, b) in (("dx", (dz, wt)), ("dw", (a_w, b_w))):
            row[part] = grad_timing(torch, timer, a, b, f"K1 backward {name} {part}")
        row["plain_ms"] = timer.ms(lambda: grads("ref"), iters=3)   # the plain backward, whole
        rows.append(row)
        log("train_matmul_bwd", **row)
        del x, w, dy, dx, dw, rx, rw, dz, wt, a_w, b_w, src
        torch.cuda.empty_cache()
    return {"shapes": rows, "max_abs_err": err, "max_rel_err": max(max(r["dx_rel"], r["dw_rel"])
                                                                   for r in rows)}


def step_profile(torch, run) -> tuple:
    """``run()`` (one train step) under one torch.profiler capture ending in
    a sync: (its result, :func:`profile_summary` of the window, or None
    where the capture holds fewer kernels than the launch counters recorded
    in it, :func:`capture_shortfall`)."""
    from torch.profiler import ProfilerActivity, profile

    before = launch_snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    after = launch_snapshot()
    short = capture_shortfall(torch, prof, before, after)
    if short:
        log("profile_capture_short", what="train_step", short=short)
        return out, None
    summary = profile_summary(torch, prof, wall_us)
    summary["launches"] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    nccl = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.name.lower())
    summary["nccl_device_ms"] = nccl / 1e3
    summary["nccl_share_of_busy"] = (nccl / 1e3 / summary["device_busy_ms"]
                                     if summary["device_busy_ms"] else None)
    return out, summary


def instrumented_train(torch, argv: list) -> tuple:
    """``repro_torch.launch.train.main(argv)`` with each step timed (host
    clock between syncs) by swapping ``launch.steps.make_train_step``, the
    launch counters set to 0 just before and read just after: (its result,
    {"ms", "losses", "init_gib"}, the counts, wall seconds, peak GiB over
    the steps)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    rec = {"ms": [], "losses": []}
    make_step = steps_mod.make_train_step

    def instrumented(*args, **kwargs):
        step_fn = make_step(*args, **kwargs)

        def step(params, opt, batch):
            i = len(rec["ms"])
            if i == 0:
                torch.cuda.synchronize()
                rec["init_gib"] = torch.cuda.memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.monotonic() - t0) * 1e3)
            rec["losses"].append(float(out[2]["loss"]))
            return out
        return step

    steps_mod.make_train_step = instrumented
    try:
        reset_counts(mm, fa, rw, rg, ref)
        t0 = time.monotonic()
        res = train_mod.main(argv)
        wall_s = time.monotonic() - t0
        counts = train_counts(mm, fa, rw, rg, ref)
    finally:
        steps_mod.make_train_step = make_step
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    free_engines(torch)
    return res, rec, counts, wall_s, peak_gib


def train_counts(mm, fa, rw, rg, ref) -> dict:
    return {"launches": {"matmul": mm.launches, "grouped_matmul": mm.grouped_launches,
                         "flash_attention": fa.launches, "rwkv6_scan": rw.launches,
                         "rglru_scan": rg.launches},
            "matmul_grad_launches": mm.grad_launches, "matmul_z_launches": mm.z_launches,
            "attention_bwd_launches": fa.bwd_launches,
            "grouped_grad_launches": mm.grouped_grad_launches,
            "rwkv6_bwd_launches": rw.bwd_launches, "rglru_bwd_launches": rg.bwd_launches,
            "matmul_f32_launches": mm.f32_launches,
            "matmul_f32_grad_launches": mm.f32_grad_launches,
            "body_launches": body_counts(mm),
            "grad_body_launches": body_counts(mm, mm.grad_body_launches),
            "forward_bodies": forward_bodies(mm, "a training run"),
            "attention_class_launches": {f"{c}/{b}": n for (c, b), n in sorted(fa.class_launches.items())},
            "attention_bwd_body_launches": {f"{b}/{str(d).removeprefix('torch.')}": n
                                            for (b, d), n in sorted(fa.bwd_body_launches.items(), key=str)},
            "plain_cuda_calls": dict(ref.cuda_calls)}


def grad_bodies_check(what: str, counts: dict, mma: int = 0) -> None:
    """Raises unless every gradient launch of a run was counted under a
    body, every bf16 one took ``wgmma`` but ``mma`` of them (the unaligned
    operands: whisper-medium's LM head, two a step) and none took ``fma``
    (f32 takes it: mixtral's router)."""
    gb = counts["grad_body_launches"]
    total = counts["matmul_grad_launches"] + counts["grouped_grad_launches"]
    took = collections.Counter()
    for key, n in gb.items():
        _, body, dtype = key.split("/")
        took[body, dtype] += n
    if (sum(gb.values()) != total or took["fma", "bfloat16"] or took["mma", "bfloat16"] != mma
            or took["mma", "float32"] or took["wgmma", "float32"]):
        raise AssertionError(f"{what}: gradient launches by body {gb} (of {total}; want "
                             f"{mma} bf16 on mma, the other bf16 on wgmma, no bf16 on fma)")


def attention_bwd_all_mma(counts: dict) -> bool:
    """Every K2 backward launch a run counted took the tensor-core body in
    bf16 (training runs bf16)."""
    return counts["attention_bwd_body_launches"].get("mma/bfloat16", 0) == counts["attention_bwd_launches"]


def reset_counts(mm, fa, rw, rg, ref) -> None:
    for module in (mm, fa, rw, rg):
        module.reset_launches()
    ref.reset_calls()


def grad_agreement(torch, got, want) -> dict:
    """Per leaf: cosine and max |kernel - plain| over max |plain|."""
    a, b = got.float().flatten(), want.float().flatten()
    cos = float(torch.dot(a, b) / torch.clamp(a.norm() * b.norm(), min=1e-30))
    return {"cos": cos, "max_rel": float((a - b).abs().max() / torch.clamp(b.abs().max(), min=1e-30))}


def path_agreement(torch, model, params, batch, what: str, control: bool = False) -> dict:
    """The kernel path's loss and gradients against the plain path's
    (``ops.use_backend("ref")``) on one batch: the loss within
    ``TRAIN_LOSS_REL``, every gradient leaf within ``TRAIN_GRAD_COS`` and
    ``TRAIN_GRAD_MAXREL``; raises otherwise.

    With ``control``, the plain path with its bf16 matmuls on the library's
    tensor-core GEMM (:func:`tensor_core_matmuls`) is held to the plain path
    too, and each bound is the larger of the fixed one and
    ``CONTROL_FACTOR`` times the control's distance (the loss's, and each
    leaf's cosine gap and max_rel), as the serve phase bounds prefill
    logits.  rwkv6-1.6b at random init amplifies the tensor cores' rounding
    from layer to layer: at 2 layers this control alone sits at cos 0.958
    and max_rel 0.54 on a leaf (``u``), past the fixed bounds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.tree import leaves, leaves_with_paths

    with ops.use_backend("ref"):
        loss_p, _, grads_p = steps_mod.value_and_grad(model, params, batch)
    plain = leaves(grads_p)

    def against_plain(loss, grads):
        agree = {path: grad_agreement(torch, a, b)
                 for (path, a), b in zip(leaves_with_paths(grads), plain)}
        return {"loss": float(loss), "loss_rel_err": abs(float(loss) - float(loss_p)) / abs(
                    float(loss_p)), "min_cos": min(v["cos"] for v in agree.values()),
                "max_rel": max(v["max_rel"] for v in agree.values()), "leaves": agree}

    loss_k, _, grads_k = steps_mod.value_and_grad(model, params, batch)
    out = {**against_plain(loss_k, grads_k), "plain_loss": float(loss_p)}
    del grads_k
    bound = {"loss_rel": TRAIN_LOSS_REL,
             "leaves": {path: {"cos": TRAIN_GRAD_COS, "max_rel": TRAIN_GRAD_MAXREL}
                        for path in out["leaves"]}}
    if control:
        with ops.use_backend("ref"), tensor_core_matmuls():
            loss_c, _, grads_c = steps_mod.value_and_grad(model, params, batch)
        out["control"] = c = against_plain(loss_c, grads_c)
        del grads_c
        bound["loss_rel"] = max(TRAIN_LOSS_REL, CONTROL_FACTOR * c["loss_rel_err"])
        for path, b in bound["leaves"].items():
            b["cos"] = min(TRAIN_GRAD_COS, 1 - CONTROL_FACTOR * (1 - c["leaves"][path]["cos"]))
            b["max_rel"] = max(TRAIN_GRAD_MAXREL, CONTROL_FACTOR * c["leaves"][path]["max_rel"])
    del grads_p, plain
    out["bounds"] = bound
    out["past_fixed_bounds"] = sorted(
        path for path, v in out["leaves"].items()
        if v["cos"] < TRAIN_GRAD_COS or v["max_rel"] > TRAIN_GRAD_MAXREL)
    bad = [path for path, v in out["leaves"].items()
           if v["cos"] < bound["leaves"][path]["cos"]
           or v["max_rel"] > bound["leaves"][path]["max_rel"]]
    if out["loss_rel_err"] > bound["loss_rel"] or bad:
        log(f"{what}_path_agreement", **out)
        raise AssertionError(f"{what}: kernel path against plain path out of bounds: loss "
                             f"{out['loss_rel_err']} (bound {bound['loss_rel']}), leaves {bad}")
    return out


def phase_train(torch, timer) -> dict:
    """gemma2-2b trained on the card: the backward kernels checked and
    timed, then ``repro_torch.launch.train.main`` at full width and depth
    (26 layers, bf16, 4 x 512 tokens, 6 steps; each step timed and one
    profiled), then the kernel path against the plain path at 2 layers
    (loss and every gradient leaf), then a checkpoint round trip of the
    2-layer model's params and optimizer state (bit for bit) and a resume
    through ``train.main``."""
    import math
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    free_engines(torch)
    attn = attention_bwd_phase(torch, timer)
    mmb = matmul_bwd_phase(torch, timer)
    cfg = get_arch(TRAIN_ARCH)

    # --- the main path: train.main at full width and depth ----------------
    argv = ["--arch", TRAIN_ARCH, "--preset", "full", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--log-every", "1"]
    res, rec, counts, wall_s, peak_gib = instrumented_train(torch, argv)
    if res["steps"] != TRAIN_STEPS or not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"train: {res}, losses {rec['losses']}")
    if not res["last_loss"] < res["first_loss"]:
        raise AssertionError(f"train: the loss did not fall: {res}")
    if counts["launches"]["matmul"] == 0 or counts["matmul_grad_launches"] == 0:
        raise AssertionError(f"train: K1 or its backward never launched: {counts}")
    if counts["attention_bwd_launches"] != cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(f"train: {counts['attention_bwd_launches']} K2 backward launches, "
                             f"want {cfg.n_layers} per step")
    if not attention_bwd_all_mma(counts):
        raise AssertionError(f"train: a K2 backward launch left the bf16 tensor-core body: {counts}")
    if counts["plain_cuda_calls"] or any(counts["launches"][k] for k in ("grouped_matmul",
                                                                          "rwkv6_scan", "rglru_scan")):
        raise AssertionError(f"train: the card reached a plain version: {counts}")
    if counts["body_launches"].get("matmul/fma/bfloat16"):
        raise AssertionError(f"train: a bf16 K1 launch took the CUDA-core body: {counts}")
    grad_bodies_check("train", counts)
    step_ms = statistics.median(rec["ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    main_row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                "params": cfg.param_count(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "steps": res["steps"], "result": res, "losses": rec["losses"],
                "step_ms": rec["ms"], "ms_per_step": step_ms, "tok_per_s": tokens / step_ms * 1e3,
                "init_gib": rec["init_gib"], "peak_gib": peak_gib, "wall_s": wall_s,
                **counts}
    log("train_main", **main_row)
    dots_row = dots_train(torch, cfg, argv, main_row)

    # --- kernel path against plain path at 2 layers ---------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = build_model(cfg2, "cuda")
    params = model.init(5)
    np_batch = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)).batch_at(0)
    batch = {"tokens": torch.from_numpy(np_batch["tokens"]).cuda()}
    vs_plain = {"layers": 2, **path_agreement(torch, model, params, batch, "train")}
    log("train_vs_plain", **vs_plain)
    vs_plain["dots"] = dots_check(torch, model, params, batch, TRAIN_ARCH)

    # --- checkpoint round trip and resume ------------------------------------
    opt = steps_mod.init_opt_state(params)
    step_fn = steps_mod.make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                                           total_steps=3))
    params, opt, _ = step_fn(params, opt, batch)
    bundle = {"params": trainable(params), "opt": opt}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        manager = CheckpointManager(d)
        t0 = time.monotonic()
        manager.save(1, bundle, blocking=False)
        manager.wait()
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        step, restored = manager.restore(tree_map(torch.empty_like, bundle))
        restore_s = time.monotonic() - t0
        differ = [path for (path, a), b in zip(leaves_with_paths(bundle), leaves(restored))
                  if a.dtype != b.dtype or not torch.equal(a.reshape(-1).view(torch.uint8),
                                                           b.reshape(-1).view(torch.uint8))]
        n_leaves = len(leaves(bundle))
        ckpt_gib = sum(a.numel() * a.element_size() for a in leaves(bundle)) / 2 ** 30
        del model, params, opt, bundle, restored, step_fn
        free_engines(torch)
        if step != 1 or differ:
            raise AssertionError(f"checkpoint round trip: step {step}, leaves differ {differ}")
        reset_counts(mm, fa, rw, rg, ref)
        resumed = train_mod.main(["--arch", TRAIN_ARCH, "--preset", "full", "--layers", "2",
                                  "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                                  "--steps", "3", "--ckpt-dir", d, "--resume", "--log-every", "1"])
        resume_counts = train_counts(mm, fa, rw, rg, ref)
    free_engines(torch)
    if resumed["steps"] != 2 or not all(math.isfinite(resumed[k]) for k in ("first_loss", "last_loss")):
        raise AssertionError(f"resume: {resumed}")
    if resume_counts["plain_cuda_calls"] or not resume_counts["attention_bwd_launches"]:
        raise AssertionError(f"resume: {resume_counts}")
    ckpt = {"leaves": n_leaves, "gib": ckpt_gib, "save_s": save_s, "restore_s": restore_s,
            "bit_exact": True, "resumed": resumed}
    log("train_checkpoint", **ckpt)
    return {"attention_bwd": attn, "matmul_bwd": mmb, "main": main_row, "dots": dots_row,
            "vs_plain": vs_plain, "checkpoint": ckpt}


def k1_forward_launches(counts: dict) -> int:
    """K1's forward launches in a run's counts (its launches less its
    gradient launches)."""
    return counts["launches"]["matmul"] - counts["matmul_grad_launches"]


def dots_train(torch, cfg, argv: list, full_row: dict) -> dict:
    """The train phase's main run again under ``--remat-policy dots``: the
    same checks, and against the ``full`` run (``full_row``) the first
    step's loss bit-equal (the same forward), one gradient launch fewer per
    gelu or GLU layer a step (Z comes from the forward) and the layers' K1
    forward launches halved (the recompute launches none).  ms per step
    and peak GiB beside ``full``'s."""
    import math

    res, rec, counts, wall_s, peak_gib = instrumented_train(torch, argv + ["--remat-policy", "dots"])
    steps = res["steps"]
    if steps != TRAIN_STEPS or not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"train dots: {res}, losses {rec['losses']}")
    if rec["losses"][0] != full_row["losses"][0]:
        raise AssertionError(f"train dots: first loss {rec['losses'][0]!r}, full's "
                             f"{full_row['losses'][0]!r}: not bit-equal")
    z_layers = cfg.n_layers   # gemma2: one GeGLU up projection a layer
    grad_full, grad_dots = full_row["matmul_grad_launches"], counts["matmul_grad_launches"]
    fwd_full, fwd_dots = k1_forward_launches(full_row), k1_forward_launches(counts)
    if grad_full - grad_dots != z_layers * steps:
        raise AssertionError(f"train dots: {grad_dots} gradient launches against full's "
                             f"{grad_full}, want {z_layers} fewer a step")
    if fwd_full != 2 * fwd_dots - steps:   # in-layer launches twice under full, the head once
        raise AssertionError(f"train dots: {fwd_dots} K1 forward launches against full's "
                             f"{fwd_full}: the layers' do not run once")
    if counts["plain_cuda_calls"] or not attention_bwd_all_mma(counts) or counts[
            "body_launches"].get("matmul/fma/bfloat16"):
        raise AssertionError(f"train dots: a plain version, a K2 backward off mma or a bf16 K1 "
                             f"launch on fma: {counts}")
    grad_bodies_check("train dots", counts)
    step_ms = statistics.median(rec["ms"][1:])
    row = {"remat_policy": "dots", "steps": steps, "losses": rec["losses"],
           "first_loss_bit_equal_full": True,
           # not required: the gradients may differ where the forward's Z
           # rounds otherwise than the gradient body's recompute
           "losses_bit_equal_full": rec["losses"] == full_row["losses"],
           "step_ms": rec["ms"], "ms_per_step": step_ms,
           "full_ms_per_step": full_row["ms_per_step"],
           "over_full": step_ms / full_row["ms_per_step"],
           "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3, "init_gib": rec["init_gib"],
           "peak_gib": peak_gib, "full_peak_gib": full_row["peak_gib"], "wall_s": wall_s,
           "grad_launches_per_step": grad_dots / steps,
           "full_grad_launches_per_step": grad_full / steps,
           "k1_forward_per_step": fwd_dots / steps, "full_k1_forward_per_step": fwd_full / steps,
           **counts}
    log("train_dots", **row)
    return row


def dots_check(torch, model, params, batch, what: str, control: bool = False) -> dict:
    """The 2-layer checks under ``dots``: the kernel path against the plain
    path (:func:`path_agreement`, the same bounds) and two kernel-path steps
    bit-equal (:func:`steps_bit_equal`)."""
    from repro_torch.distributed.context import using_remat_policy

    with using_remat_policy("dots"):
        out = path_agreement(torch, model, params, batch, f"{what}_dots", control=control)
        free_engines(torch)
        out["steps_bit_equal"] = steps_bit_equal(torch, model, batch)
    log("dots_check", arch=what, **out)
    return out


# ---------------------------------------------------------------------------
# train_families: the MoE, recurrent and audio families trained on the card
# ---------------------------------------------------------------------------

#: (arch, layers kept (0: all), batch, sequence): rwkv6-1.6b at 12 of 24
#: layers and recurrentgemma-2b at 13 of 26 (cut to keep the whole script
#: near 700 s; they were at full depth before, PERF.md §4); mixtral-8x22b
#: at 1 of 56 layers (one layer's state, ~38 GiB at ~14 bytes a parameter,
#: fills half the card); whisper-medium at 12 of its 24 decoder layers
#: (``--layers`` keeps its 24 encoder layers), its decoder's context of 448
#: tokens and 1500 stub frames; internvl2-26b at 6 of 48 layers, 256 stub
#: patches before 512 tokens: 3.48 B parameters at 16 bytes a parameter
#: (bf16 parameter and gradient, AdamW's m, v and f32 master) and the
#: update's f32 temporaries of its 568.6 M-element embedding (6.8 GB); at 4
#: layers the peak was 45.18 GiB, each layer adds 0.39 B parameters (6.2
#: GB).  All at full width, bf16, AdamW at lr 3e-3, remat ``full`` (the
#: trainer's defaults).
FAMILIES = (("rwkv6-1.6b", 12, 4, 512), ("recurrentgemma-2b", 13, 4, 512),
            ("mixtral-8x22b", 1, 4, 512), ("whisper-medium", 12, 4, 448),
            ("internvl2-26b", 6, 4, 512))
#: steps per family: the median of steps 2-4 is the step time
FAMILY_STEPS = 4
#: depth of the kernel-vs-plain check and of the bit-equality steps (both
#: stacks of an encoder-decoder; mixtral keeps its one layer)
FAMILY_CHECK_LAYERS = 2
#: per state element per token, K3's backward: the four products that give
#: dk, dr, dw and dv's shares, G's update (a product and an FMA) and the
#: state's recompute (the same) — 14 f32 operations; K4's backward ~12 per
#: element, far under its bytes
RW_BWD_OPS, RG_BWD_OPS = 14, 12


def rg_bwd_bound(b: int, t: int, c: int) -> tuple[float, str]:
    """K4's backward in bf16: x, a and dy read once, dx and da written once,
    the initial state in and its gradient out (f32); or ``RG_BWD_OPS`` f32
    operations an element on the CUDA cores."""
    n = b * t * c
    return bound_ms(5 * 2 * n + 2 * 4 * b * c, RG_BWD_OPS * n, F32_CUDA_CORE_FLOPS)


def grads_close(torch, names, got, want, what: str, f32: bool = False) -> dict:
    """Each gradient within ``GRAD_SCALE_ATOL``·max|plain| + ``GRAD_RTOL``·|plain|
    (K1's backward bound; f32: 2e-4 of each, the f32 kernel tolerance held
    to the gradient's scale): {name: {max |err|, max |err| / max |plain|}}."""
    out = {}
    share, rtol = (F32_TOL["atol"], F32_TOL["rtol"]) if f32 else (GRAD_SCALE_ATOL, GRAD_RTOL)
    for name, a, b in zip(names, got, want):
        scale = float(b.float().abs().max())
        tol = dict(rtol=rtol, atol=share * scale)
        err = assert_close(torch, a, b, tol, f"{what} {name}")
        out[name] = {"max_abs_err": err, "rel": err / scale if scale else 0.0}
    return out


#: K3's backward before its redesign at 4·32·512·64, bf16 (events), timed by
#: this script on an NVIDIA H100 80GB HBM3 at 700.00 W, reported beside this run's
EARLIER_RW_BWD_MS = 2.338


def rwkv6_bwd_rows(torch, timer) -> list:
    """K3's backward against its plain version (``ref.rwkv6_scan_bwd``) at
    rwkv6-1.6b's training shape (4·32·512·64) in bf16 and f32, and at T =
    37 from a state passed in with the final state's gradient, bf16; each
    twice (bit-equal) and, a batch row alone against the same row at B = 4
    (bit-equal but du, a sum over the batch); the bf16 training shape timed
    beside the plain backward, with each kernel's device time (the walk,
    the reverse walk, du's batch sum) and the earlier kernel's time."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device="cuda").manual_seed(41)
    rows = []
    for name, b, t, with_state, timed, dt in (
            ("train", 4, 512, False, True, torch.bfloat16),
            ("train_f32", 4, 512, False, False, torch.float32),
            ("t37_state", 4, 37, True, False, torch.bfloat16)):
        h, d = 32, 64
        r, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dt) for _ in range(3))
        # w = exp(-exp(w0 + lora)) around rwkv6's init (w0 = -6: 0.9975) and below
        w = torch.exp(-torch.exp(-6 + 4 * torch.rand((b, h, t, d), generator=g, device="cuda")))
        w = w.to(dt)
        u = torch.randn((h, d), generator=g, device="cuda")
        s0 = (torch.randn((b, h, d, d), generator=g, device="cuda") if with_state
              else torch.zeros((b, h, d, d), device="cuda"))
        dy = torch.randn((b, h, t, d), generator=g, device="cuda").to(dt)
        ds = torch.randn((b, h, d, d), generator=g, device="cuda") if with_state else None
        cs = ops.schedule_for(ops.instance("rwkv6_scan", dt, T=t, C=h * d, D=d, B=b))
        args = (r, k, v, w, u, s0, dy, ds)
        got = rw.launch_bwd(*args, cs)
        want = ref.rwkv6_scan_bwd(*args)
        errs = grads_close(torch, ("dr", "dk", "dv", "dw", "du", "dstate"), got, want,
                           f"K3 backward {name}", f32=dt == torch.float32)
        run = rw.launch_bwd(*args, cs)
        if not all(torch.equal(p, q) for p, q in zip(got, run)):
            raise AssertionError(f"K3 backward {name}: two runs differ")
        one = rw.launch_bwd(*(x[2:3].contiguous() for x in (r, k, v, w)), u, s0[2:3].contiguous(),
                            dy[2:3].contiguous(), None if ds is None else ds[2:3].contiguous(),
                            ops.schedule_for(ops.instance("rwkv6_scan", dt, T=t, C=h * d, D=d, B=1)))
        if not all(torch.equal(p[2:3], q) for i, (p, q) in enumerate(zip(got, one)) if i != 4):
            raise AssertionError(f"K3 backward {name}: a batch row differs at B = 1 and B = 4")
        geo, lib = rw.bwd_geometry(b, h, t, d, dt), rw.bwd_library_geometry(b, h, t, d, dt)
        if (lib["ctas"], lib["cluster"]) != (geo["ctas"], geo["cluster"]):
            raise AssertionError(f"K3 backward {name}: the library launches {lib}, the layout says {geo}")
        row = {"name": name, "dtype": str(dt), "B": b, "H": h, "T": t, "D": d, "state": with_state,
               "errors": errs, "bits": {"two_runs": True, "b1_vs_b4": True},
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "max_rel_err": max(e["rel"] for e in errs.values()),
               **lib}
        if timed:
            n = b * h * t * d
            row["bound_ms"], row["bound_by"] = bound_ms(
                9 * 2 * n + 2 * 4 * b * h * d * d + 2 * 4 * h * d,
                RW_BWD_OPS * b * h * t * d * d, F32_CUDA_CORE_FLOPS)
            row["ms"] = timer.ms(lambda: rw.launch_bwd(*args, cs))
            row["kernels_ms"] = timer.kernel_ms(lambda: rw.launch_bwd(*args, cs))
            row["plain_ms"] = timer.ms(lambda: ref.rwkv6_scan_bwd(*args), iters=3)
            row["library_ms"] = None   # no one PyTorch call computes a recurrence
            row["fwd_ms"] = timer.ms(lambda: rw.launch(r, k, v, w, u, s0, cs))
            row["earlier_ms"] = EARLIER_RW_BWD_MS
            row["speedup"] = EARLIER_RW_BWD_MS / row["ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("families_rwkv6_bwd", **row)
        del r, k, v, w, s0, dy, got, want, run, one
    torch.cuda.empty_cache()
    return rows


def rglru_bwd_rows(torch, timer) -> list:
    """K4's backward against its plain version (``ref.rglru_scan_bwd``) at
    recurrentgemma-2b's training shape (4·512·2560) in bf16 and f32, and,
    from a state passed in with the final state's gradient, at T = 37,
    bf16; each bit-equal twice, a batch row at B = 1 against B = 4, and
    under C tiles 8, 512 and 2560 (channels are independent); the launch
    the library plans (CTAs, shared bytes, CTAs an SM) held to
    ``rg.bwd_geometry``; the bf16 training shape timed by events, on the
    device and behind a stream hold, beside the plain backward."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg

    g = torch.Generator(device="cuda").manual_seed(42)
    rows = []
    for name, b, t, with_state, timed, dt in (
            ("train", 4, 512, False, True, torch.bfloat16),
            ("train_f32", 4, 512, False, False, torch.float32),
            ("t37_state", 4, 37, True, False, torch.bfloat16)):
        c = 2560
        args = _rg_bwd_inputs(torch, g, b, t, c, dt, with_state)
        x, a, h0, dy, dh = args
        cs = _rg_cs(torch, dt, b, t, c)
        got = rg.launch_bwd(*args, cs)
        want = ref.rglru_scan_bwd(*args)
        errs = grads_close(torch, ("dx", "da", "dstate"), got, want, f"K4 backward {name}",
                           f32=dt == torch.float32)

        def same(other, what, part=slice(None)):
            torch.cuda.synchronize()
            if not all(torch.equal(p[part].view(torch.uint8), q.view(torch.uint8))
                       for p, q in zip(got, other)):
                raise AssertionError(f"K4 backward {name}: {what}")

        same(rg.launch_bwd(*args, cs), "two runs differ")
        one = [z[2:3].contiguous() if z is not None else None for z in args]
        same(rg.launch_bwd(*one, _rg_cs(torch, dt, 1, t, c)), "a batch row differs at B = 1 and B = 4",
             slice(2, 3))
        for tile_c in (8, 512, c):
            same(rg.launch_bwd(*args, _rg_cs(torch, dt, b, t, c, tile_c=tile_c)),
                 f"C tile {tile_c} changes the bits")
        geo = rg.bwd_geometry(b, t, c, cs.t["C"], dt)
        lib = rg.bwd_library_geometry(b, t, c, cs.t["C"], dt)
        if lib != geo:
            raise AssertionError(f"K4 backward {name}: the library plans {lib}, the layout says {geo}")
        row = {"name": name, "dtype": str(dt), "B": b, "T": t, "C": c, "state": with_state,
               "errors": errs, "bits": {"two_runs": True, "b1_vs_b4": True, "c_tiles": [8, 512, c]},
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "max_rel_err": max(e["rel"] for e in errs.values()),
               **{f: lib[f] for f in ("ctas", "threads", "stage_t", "ring", "smem", "resident")}}
        if timed:
            row["bound_ms"], row["bound_by"] = rg_bwd_bound(b, t, c)
            row["ms"] = timer.ms(lambda: rg.launch_bwd(*args, cs))
            row["device_ms"] = timer.device_ms(lambda: rg.launch_bwd(*args, cs))
            row["held_ms"] = timer.held_ms(lambda: rg.launch_bwd(*args, cs))
            row["bound_share"] = row["bound_ms"] / row["held_ms"]
            row["plain_ms"] = timer.ms(lambda: ref.rglru_scan_bwd(*args), iters=3)
            row["library_ms"] = None   # no one PyTorch call computes a recurrence
            row["fwd_ms"] = timer.ms(lambda: rg.launch(x, a, h0, cs))
        rows.append(row)
        log("families_rglru_bwd", **row)
        del x, a, h0, dy, dh, args, got, want, one
    torch.cuda.empty_cache()
    return rows


#: mixtral-8x22b's expert GEMMs at the training batch (4 x 512 tokens,
#: dropless: cap = 2048 rows per expert): (class, E, M, K, N)
MOE_BWD_SHAPES = (("moe_gemm_silu_glu", 8, 2048, 6144, 32768), ("moe_gemm", 8, 2048, 16384, 6144))


def grouped_bwd_rows(torch, timer) -> list:
    """K1g's backward (``GroupedMatmulFn``: the GLU's pre-activation, dX and
    dW as gradient launches) against autograd of the plain version
    (``ref.grouped_matmul_bwd``) at mixtral's training shapes, bf16; dX's
    and dW's launches checked and timed by :func:`grad_timing` beside the
    copy-then-forward composition and ``torch.bmm`` of the same operands."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(43)
    rows = []
    for class_id, e, m, k, n in MOE_BWD_SHAPES:
        n_out = n // 2 if "glu" in class_id else n
        x, w = _grouped_inputs(torch, g, e, m, n, k, torch.bfloat16)
        dy = (torch.randn((e, m, n_out), generator=g, device="cuda") / n_out ** 0.5).to(torch.bfloat16)
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = mm.grouped_grad_launches
        got = torch.autograd.grad(ops.moe_gemm(xs, ws, class_id=class_id), (xs, ws), dy)
        launched = mm.grouped_grad_launches - before
        del xs, ws
        want = ref.grouped_matmul_bwd(x, w, dy, class_id)
        errs = grads_close(torch, ("dx", "dw"), got, want, f"K1g backward {class_id}")
        del got, want
        torch.cuda.empty_cache()
        row = {"class": class_id, "E": e, "M": m, "K": k, "N": n, "grad_launches": launched,
               "errors": errs, "max_abs_err": max(v["max_abs_err"] for v in errs.values()),
               "max_rel_err": max(v["rel"] for v in errs.values())}
        dz = dy if "glu" not in class_id else torch.randn((e, m, n), generator=g,
                                                          device="cuda").to(torch.bfloat16)
        wt, xt = w.transpose(1, 2), x.transpose(1, 2)      # the views GroupedMatmulFn passes
        for part, (a, b) in (("dx", (dz, wt)), ("dw", (xt, dz))):
            row[part] = grad_timing(torch, timer, a, b, f"K1g backward {class_id} {part}", iters=5)
        # the plain backward, whole (autograd of the plain version, f32 sums)
        row["plain_ms"] = timer.ms(lambda: ref.grouped_matmul_bwd(x, w, dy, class_id), iters=3)
        rows.append(row)
        log("families_grouped_bwd", **row)
        del x, w, dy, dz, wt, xt
        torch.cuda.empty_cache()
    return rows


#: whisper-medium's LM head at its training batch, (tokens, d_model, vocab):
#: its rows of 51865 values are not 16-byte aligned, so both of its gradient
#: launches (dX = dZ·wᵀ, dW = xᵀ·dZ; the head is untied) take ``mma`` with
#: operand modes
WHISPER_HEAD = (4 * 448, 1024, 51865)
#: the bf16 gradient launches a step that take ``mma``, per family: the
#: untied LM heads' dX and dW (rows of 51865 and 92553 values)
FAMILY_GRAD_MMA = {"whisper-medium": 2, "internvl2-26b": 2}


def whisper_head_bwd_rows(torch, timer) -> list:
    """whisper-medium's LM head gradients (:data:`WHISPER_HEAD`) on the
    views ``MatmulFn.backward`` passes, checked and timed by
    :func:`grad_timing`; fails unless both take ``mma``."""
    t, d, v = WHISPER_HEAD
    g = torch.Generator(device="cuda").manual_seed(45)
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=g, device="cuda").to(bf)
    w = (torch.randn((d, v), generator=g, device="cuda") / d ** 0.5).to(bf)
    dz = (torch.randn((t, v), generator=g, device="cuda") / v ** 0.5).to(bf)
    rows = []
    for part, a, b in (("dx", dz, w.T), ("dw", x.T, dz)):
        row = {"name": f"whisper_head_{part}", **grad_timing(torch, timer, a, b,
                                                                f"whisper head {part}")}
        if row["body"] != "mma":
            raise AssertionError(f"whisper head {part}: took {row['body']}, want mma")
        rows.append(row)
        log("families_head_bwd", **row)
    del x, w, dz
    torch.cuda.empty_cache()
    return rows


#: internvl2-26b's LM head on the trainer's path, (M, K, N): 4 rows of 256
#: patches and 512 tokens (the head reads every position), d_model 6144,
#: vocab 92553 = 3 × 30851, so the forward's and dW's N tile is 3 (ROADMAP
#: B.7) and a CTA covers a group of 3-column tiles: 42 in a 128-column
#: ``mma`` CTA, 21 in a 64-column rows strip at decode; rows of 92553 values
#: are not 16-byte aligned, so w and dZ are read as shifted aligned vectors
#: and both gradient launches take ``mma`` with operand modes
INTERNVL2_HEAD = (4 * (256 + 512), 6144, 92553)


def internvl2_head_rows(torch, timer) -> list:
    """internvl2-26b's LM head at :data:`INTERNVL2_HEAD`: the forward (K1,
    ``matmul_lmhead`` under its default schedule) against its plain version
    and timed by :func:`timed_matmul_row` beside ``torch.matmul``; dX and
    dW on the views ``MatmulFn.backward`` passes, checked and timed by
    :func:`grad_timing`; fails unless both gradient launches take ``mma``."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    t, d, v = INTERNVL2_HEAD
    g = torch.Generator(device="cuda").manual_seed(46)
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=g, device="cuda").to(bf)
    w = (torch.randn((d, v), generator=g, device="cuda") / d ** 0.5).to(bf)
    cs = ops.schedule_for(ops.instance("matmul_lmhead", bf, M=t, N=v, K=d))
    err = assert_close(torch, mm.launch(x, w, cs, class_id="matmul_lmhead"),
                       ref.matmul(x, w, "matmul_lmhead"), BF16_TOL, "internvl2 head forward")
    rows = [{"name": "internvl2_head_fwd",
             **timed_matmul_row(torch, timer, x, w, {}, "matmul_lmhead", cs, err)}]
    log("families_head_fwd", **rows[0])
    dz = (torch.randn((t, v), generator=g, device="cuda") / v ** 0.5).to(bf)
    for part, a, b in (("dx", dz, w.T), ("dw", x.T, dz)):
        row = {"name": f"internvl2_head_{part}",
               **grad_timing(torch, timer, a, b, f"internvl2 head {part}")}
        if row["body"] != "mma":
            raise AssertionError(f"internvl2 head {part}: took {row['body']}, want mma")
        rows.append(row)
        log("families_head_bwd", **row)
    del x, w, dz
    torch.cuda.empty_cache()
    return rows


#: K2's backward at the families' attention shapes, (name, B, Hq, Hkv, Sq,
#: Skv, D, causal, window): whisper's encoder (non-causal, 1500 frames), its
#: decoder's self-attention (causal, 448) and cross-attention (448 queries
#: over 1500 frames); mixtral's window (4096: no bite at 512) and
#: recurrentgemma's local layers (2048)
FAMILY_ATTN_BWD = (("whisper_encoder", 4, 16, 16, 1500, 1500, 64, False, 0),
                   ("whisper_self", 4, 16, 16, 448, 448, 64, True, 0),
                   ("whisper_cross", 4, 16, 16, 448, 1500, 64, False, 0),
                   ("mixtral", 4, 48, 8, 512, 512, 128, True, 4096),
                   ("recurrentgemma", 4, 10, 1, 512, 512, 256, True, 2048))


def family_attention_bwd_rows(torch, timer) -> list:
    """K2's backward against autograd of its plain version at the families'
    training shapes, bf16 (the tensor-core body), timed
    (:func:`attention_bwd_timing`) beside the plain backward and SDPA's
    forward and backward (the kv heads repeated outside the clock);
    ``bound_share`` is the bound over the held (device) time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(44)
    rows = []
    for name, b, hq, hkv, sq, skv, d, causal, window in FAMILY_ATTN_BWD:
        bf = torch.bfloat16
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(bf)
        k, v = (torch.randn((b, hkv, skv, d), generator=g, device="cuda").to(bf) for _ in range(2))
        do = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(bf)
        kw = dict(causal=causal, window=window)
        class_id = ("flash_attention_causal" if causal else
                    "flash_attention_cross" if sq != skv else "flash_attention_bidir")
        cs = ops.schedule_for(ops.instance(class_id, bf, Q=sq, KV=skv, H=hq, D=d, B=b,
                                           window=window))
        o, lse, got = attention_bwd_launch(fa, q, k, v, do, cs, kw)
        want = ref.chunked_attention_bwd(q, k, v, do, **kw)
        errs = grads_close(torch, ("dq", "dk", "dv"), got, want, f"K2 backward {name}")
        del got, want
        live = (sum(min(i + 1, window) if window else i + 1 for i in range(sq)) if causal
                else sq * skv)
        nbytes = 2 * (4 * b * hq * sq * d + 4 * b * hkv * skv * d)
        b_ms, b_by = bound_ms(nbytes, 10 * b * hq * live * d)
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

        def sdpa():
            leaves = [t.detach().requires_grad_() for t in (q, ke, ve)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            return torch.autograd.grad(out, leaves, do)

        row = {"name": name, "B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Skv": skv, "D": d,
               "causal": causal, "window": window, "errors": errs,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "bound_ms": b_ms, "bound_by": b_by,
               # SDPA computes the same function where the window does not bite
               **attention_bwd_timing(timer, fa, name, q, k, v, o, lse, do, kw,
                                      sdpa if window == 0 or window >= skv else None),
               "plain_ms": timer.ms(lambda: ref.chunked_attention_bwd(q, k, v, do, **kw), iters=3)}
        row["bound_share"] = row["bound_ms"] / row["held_ms"]
        rows.append(row)
        log("families_attention_bwd", **row)
        del q, k, v, do, o, lse, ke, ve
        torch.cuda.empty_cache()
    return rows


def family_batch(torch, cfg, batch: int, seq: int) -> dict:
    """The trainer's first batch for ``cfg`` (seed 0's synthetic tokens) and
    its stub frontend inputs, on the card."""
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.launch.serve import stub_extras

    tokens = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch)).batch_at(0)["tokens"]
    out = {"tokens": torch.from_numpy(tokens).cuda()}
    for key, v in stub_extras(cfg).items():
        out[key] = torch.from_numpy(v).cuda().expand(batch, *v.shape).contiguous()
    return out


def cut_depth(cfg, layers: int):
    """``cfg`` at ``layers`` layers (an encoder-decoder's both stacks)."""
    return dataclasses.replace(cfg, n_layers=layers,
                               encoder_layers=layers if cfg.encoder_layers else 0)


def family_check_cfg(cfg):
    """The family's config cut to the check depth (both stacks of an
    encoder-decoder)."""
    return cut_depth(cfg, min(cfg.n_layers, FAMILY_CHECK_LAYERS))


def steps_bit_equal(torch, model, batch) -> dict:
    """Two kernel-path train steps from the same weights (seed 5) and the
    same batch, each after a fresh init: their losses and updated params
    bit-equal."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    kept, losses = None, []
    for _ in range(2):
        params = model.init(5)
        opt = steps_mod.init_opt_state(params)
        step = steps_mod.make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                                            total_steps=FAMILY_STEPS))
        losses.append(float(step(params, opt, batch)[2]["loss"]))
        now = [p.clone() for p in leaves(trainable(params))] if kept is None else leaves(
            trainable(params))
        if kept is None:
            kept = now
        else:
            differ = sum(not torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(
                torch.uint8)) for a, b in zip(kept, now))
        del params, opt, step
        free_engines(torch)
    if losses[0] != losses[1] or differ:
        raise AssertionError(f"two kernel-path steps differ: losses {losses}, {differ} leaves")
    return {"losses": losses, "leaves": len(kept), "bit_equal": True}


#: each family's new backward kernel's counter and its launches per step
FAMILY_BWD = {"rwkv6-1.6b": ("rwkv6_bwd_launches", lambda cfg: cfg.n_layers),
              "recurrentgemma-2b": ("rglru_bwd_launches",
                                    lambda cfg: sum(kd == "R" for kd in cfg.layer_kinds)),
              "mixtral-8x22b": ("grouped_grad_launches", lambda cfg: 5 * cfg.n_layers),
              "whisper-medium": ("attention_bwd_launches",
                                 lambda cfg: cfg.encoder_layers + 2 * cfg.n_layers),
              "internvl2-26b": ("attention_bwd_launches", lambda cfg: cfg.n_layers)}


def phase_train_families(torch, timer) -> dict:
    """rwkv6-1.6b, recurrentgemma-2b, mixtral-8x22b (1 layer),
    whisper-medium and internvl2-26b trained on the card: the backward
    kernels of their paths checked against their plain versions at the
    families' training shapes and timed (K3, K4, K1g; K2 at the families'
    attention shapes; the untied LM heads' gradients, internvl2's forward
    too); then per family ``repro_torch.launch.train.main`` at full width
    (``--preset full``, ``FAMILIES``' depth and batch, 4 steps; each step
    timed), the kernel path against the plain path at 2 layers (mixtral: 1;
    internvl2 on seeded patches) and two kernel-path steps bit-equal.  Its
    profiled steps come from ``--profile-steps``."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    free_engines(torch)
    kernels = {"rwkv6_bwd": rwkv6_bwd_rows(torch, timer), "rglru_bwd": rglru_bwd_rows(torch, timer),
               "grouped_bwd": grouped_bwd_rows(torch, timer),
               "attention_bwd": family_attention_bwd_rows(torch, timer),
               "head_bwd": whisper_head_bwd_rows(torch, timer),
               "internvl2_head": internvl2_head_rows(torch, timer)}
    runs = []
    for arch, layers, batch, seq in FAMILIES:
        cfg = get_arch(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        argv = ["--arch", arch, "--preset", "full", "--batch", str(batch), "--seq", str(seq),
                "--steps", str(FAMILY_STEPS), "--log-every", "1"]
        if layers:
            argv += ["--layers", str(layers)]
        res, rec, counts, wall_s, peak_gib = instrumented_train(torch, argv)
        if res["steps"] != FAMILY_STEPS or not all(math.isfinite(x) for x in rec["losses"]):
            raise AssertionError(f"{arch}: {res}, losses {rec['losses']}")
        key, per_step = FAMILY_BWD[arch]
        if counts[key] != per_step(cfg) * FAMILY_STEPS:
            raise AssertionError(f"{arch}: {counts[key]} {key}, want {per_step(cfg)} a step")
        if counts["plain_cuda_calls"] or not counts["matmul_grad_launches"]:
            raise AssertionError(f"{arch}: a plain version on the card, or no K1 backward: {counts}")
        if not attention_bwd_all_mma(counts):
            raise AssertionError(f"{arch}: a K2 backward launch left the bf16 tensor-core body: {counts}")
        if counts["body_launches"].get("matmul/fma/bfloat16"):
            raise AssertionError(f"{arch}: a bf16 K1 launch took the CUDA-core body: {counts}")
        grad_bodies_check(arch, counts, FAMILY_GRAD_MMA.get(arch, 0) * FAMILY_STEPS)
        step_ms = statistics.median(rec["ms"][1:])
        row = {"arch": arch, "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
               "d_model": cfg.d_model, "params": cfg.param_count(), "batch": batch, "seq": seq,
               "steps": res["steps"], "result": res, "losses": rec["losses"],
               "step_ms": rec["ms"], "ms_per_step": step_ms,
               "tok_per_s": batch * seq / step_ms * 1e3, "init_gib": rec["init_gib"],
               "peak_gib": peak_gib, "wall_s": wall_s, **counts}
        log("families_train", **row)

        check = family_check_cfg(cfg)
        model = build_model(check, "cuda")
        params = model.init(5)
        data = family_batch(torch, check, batch, seq)
        if check.vision_tokens:   # seeded patches: vis_proj's gradient is not zero
            data["patch_embeds"] = seeded_extras(torch, check, batch)["patch_embeds"]
        row["vs_plain"] = {"layers": check.n_layers, "encoder_layers": check.encoder_layers,
                           **path_agreement(torch, model, params, data, arch, control=True)}
        del params
        free_engines(torch)
        row["steps_bit_equal"] = steps_bit_equal(torch, model, data)
        log("families_check", arch=arch, vs_plain=row["vs_plain"],
            steps_bit_equal=row["steps_bit_equal"])
        params = model.init(5)
        row["dots"] = dots_check(torch, model, params, data, arch, control=True)
        del params
        free_engines(torch)
        del model, data
        free_engines(torch)
        runs.append(row)
    return {"kernels": kernels, "runs": runs, "f32_check": rwkv6_f32_agreement(torch)}


def rwkv6_f32_agreement(torch) -> dict:
    """C.10: rwkv6-1.6b at 2 layers in f32, the kernel path (every K1 and
    K3 launch and their backward on the f32 bodies: the gradient launches'
    ``fma`` with operand modes) against the plain path on one batch, at the
    fixed ``TRAIN_LOSS_REL``, ``TRAIN_GRAD_COS`` and ``TRAIN_GRAD_MAXREL``,
    no control.  Raises if a leaf leaves them: the bf16 runs' control-relative
    bound would then hide a fault of the port."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import build_model

    arch, _, batch, seq = FAMILIES[0]
    cfg = dataclasses.replace(family_check_cfg(get_arch(arch)), dtype="float32")
    model = build_model(cfg, "cuda")
    params = model.init(5)
    data = family_batch(torch, cfg, batch, seq)
    reset_counts(mm, fa, rw, rg, ref)
    out = {"arch": arch, "layers": cfg.n_layers, "dtype": cfg.dtype,
           **path_agreement(torch, model, params, data, f"{arch}_f32")}
    out["grad_body_launches"] = body_counts(mm, mm.grad_body_launches)
    f32_fma = mm.grad_body_launches["matmul", "fma", torch.float32]
    if not f32_fma or f32_fma != sum(mm.grad_body_launches.values()):
        raise AssertionError(f"{arch} f32: gradient launches {out['grad_body_launches']}, want all on fma")
    out["bwd_launches"] = {"rwkv6_scan_bwd": rw.bwd_launches, "matmul_grad": mm.grad_launches}
    del model, params, data
    free_engines(torch)
    log("families_rwkv6_f32", **out)
    return out


#: the dist phase: gemma2-2b at the train phase's batch; 2 layers for the
#: world-1 bit-equality and the elastic restore, full depth for the timing
DIST_LAYERS = 2
#: full-depth steps, timed as the train phase times its own (the median of
#: all but the first)
DIST_STEPS = TRAIN_STEPS


def bits_equal(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


@contextlib.contextmanager
def nccl_group(torch, directory: str, name: str):
    """A one-rank NCCL process group on cuda:0 over a ``FileStore`` in
    ``directory`` (no network), destroyed on exit."""
    import os

    import torch.distributed as dist

    store = dist.FileStore(os.path.join(directory, name), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_dist(torch, unsharded_ms: float) -> dict:
    """Sharded training on the card (``repro_torch.distributed``) at world
    1 under NCCL, in this process, under both strategies (``dp``: ZeRO-3;
    ``fsdp_tp``: tensor-parallel compute, whose ``model`` axis of one rank
    moves nothing): (1) gemma2-2b at full width and ``DIST_LAYERS`` layers,
    two steps of ``make_sharded_train_step`` (a (1, 1) mesh) against two of
    ``make_train_step`` on the same weights and batch: losses, params and
    optimizer state bit-equal, the same kernel launches, the collectives the
    plan's and none over ``model``; (2) the ``dp`` state saved (rank 0
    writes full leaves), the group destroyed, a fresh one made and the
    state restored by ``elastic_restore``, bit-equal; (3) full depth,
    ``DIST_STEPS`` ``dp`` steps: ms per step (median of all but the first)
    beside the train phase's unsharded step, peak memory and one step's
    collectives by op, held equal to the step's plan (``plan_collectives``,
    the planner's); at one card ``fsdp_tp`` does ``dp``'s work, so it is
    not timed again; (4) minitron-4b at full width and ``DIST_LAYERS``
    layers served by ``make_sharded_serve_step`` on the (1, 1) mesh, plain
    and sequence-parallel: the prefill's and ``SERVE_SHARDED_STEPS``
    decode steps' logits and the caches bit-equal to ``Model.prefill`` /
    ``Model.decode_step`` (the serving engines' calls) on the same weights,
    the collectives the plan's.  Its profiled step is
    :func:`profile_steps`'."""
    import math
    import os
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.distributed.fault import elastic_restore
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models.lm import trainable
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves, leaves_with_paths

    free_engines(torch)
    t_phase = time.monotonic()
    cfg = get_arch(TRAIN_ARCH)
    np_batch = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)).batch_at(0)
    batch = {"tokens": torch.from_numpy(np_batch["tokens"]).cuda()}
    shape = tuple(batch["tokens"].shape)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=DIST_STEPS)
    cfg2 = dataclasses.replace(cfg, n_layers=DIST_LAYERS)

    def issued(snapshot):   # a counter's snapshot as the plan gives it
        return {op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes")}
                     if isinstance(v, dict) else v) for op, v in snapshot.items()}

    def over_model(snapshot):   # tensor-parallel collectives: over the model axis alone
        return sum(v["axes"].get("model", 0) for v in snapshot.values() if isinstance(v, dict))

    equal_rows, mains = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as d:
        # --- 1. world 1: each strategy's sharded step against the unsharded, bit for bit
        with nccl_group(torch, d, "store0"):
            model = build_model(cfg2, "cuda")
            for strategy in ("dp", "fsdp_tp"):
                full = model.init(5)
                step = steps_mod.make_sharded_train_step(model, opt_cfg, make_test_mesh(model=1),
                                                         strategy=strategy)
                params = step.shard_params(full)
                opt = step.init_opt_state(params)
                full_opt = steps_mod.init_opt_state(full)
                plain = steps_mod.make_train_step(model, opt_cfg)
                runs = {}
                for name, fn, p, o in (("unsharded", plain, full, full_opt),
                                       ("sharded", step, params, opt)):
                    reset_counts(mm, fa, rw, rg, ref)
                    losses, per_step = [], []
                    for _ in range(2):
                        step.groups.counter.reset()
                        p, o, metrics = fn(p, o, batch)
                        losses.append(float(metrics["loss"]))
                        per_step.append(step.groups.counter.snapshot())
                    torch.cuda.synchronize()
                    runs[name] = {"losses": losses, **train_counts(mm, fa, rw, rg, ref),
                                  "collectives": per_step[-1]}
                got = {"params": params, "opt": opt}
                want = {"params": trainable(full), "opt": full_opt}
                differ = [path for (path, a), b in zip(leaves_with_paths(got), leaves(want))
                          if not bits_equal(torch, a, b)]
                same_launches = all(runs["sharded"][k] == runs["unsharded"][k] for k in (
                    "launches", "matmul_grad_launches", "attention_bwd_launches",
                    "body_launches"))
                plan = step.plan(shape)
                as_planned = all(issued(c) == plan for c in per_step)
                row = {"layers": DIST_LAYERS, "strategy": strategy, "mesh": "1x1",
                       "leaves": len(leaves(got)), "differ": differ,
                       "losses": runs["sharded"]["losses"],
                       "unsharded_losses": runs["unsharded"]["losses"],
                       "same_launches": same_launches, "collectives_as_planned": as_planned,
                       "model_axis_collectives": over_model(per_step[-1]), "runs": runs}
                equal_rows[strategy] = row
                log(f"dist_world1_equal_{strategy}", **row)
                if (differ or runs["sharded"]["losses"] != runs["unsharded"]["losses"]
                        or not same_launches or not as_planned or row["model_axis_collectives"]):
                    raise AssertionError(f"dist: the {strategy} sharded step at world 1 is not "
                                         f"the unsharded step: leaves differ {differ}, {row}, "
                                         f"plan {plan}")
                if runs["sharded"]["plain_cuda_calls"] or not runs["sharded"][
                        "collectives"].get("reduce_scatter"):
                    raise AssertionError(f"dist: {runs['sharded']}")
                del p, o, metrics, full, full_opt, plain, want
                if strategy == "fsdp_tp":
                    del step, params, opt, got
                    break
                # --- 2. the dp state saved by rank 0, for a fresh group to restore
                sharded = step.state_sharded(opt)
                ck = os.path.join(d, "ckpt")
                t0 = time.monotonic()
                CheckpointManager(ck).save(2, got, sharded=sharded)
                save_s = time.monotonic() - t0
                like = sharded.like
                saved = got
                del step, params, opt, sharded
                free_engines(torch)
            del model
        free_engines(torch)
        with nccl_group(torch, d, "store1"):
            groups = MeshGroups(make_test_mesh(model=1))
            t0 = time.monotonic()
            n, restored = elastic_restore(CheckpointManager(ck), like, cfg2, groups, dp_only=True)
            restore_s = time.monotonic() - t0
            lost = [path for (path, a), b in zip(leaves_with_paths(saved), leaves(restored))
                    if not bits_equal(torch, a.cpu(), b.cpu())]
            elastic_row = {"step": n, "leaves": len(leaves(saved)), "differ": lost,
                           "gib": sum(a.numel() * a.element_size() for a in leaves(saved)) / 2 ** 30,
                           "save_s": save_s, "restore_s": restore_s}
            log("dist_elastic_restore", **elastic_row)
            if n != 2 or lost:
                raise AssertionError(f"dist: elastic restore lost bits: {elastic_row}")
            del saved, restored
            free_engines(torch)

            # --- 3. full depth, dp
            model = build_model(cfg, "cuda")
            for strategy in ("dp",):
                step = steps_mod.make_sharded_train_step(model, opt_cfg, groups.mesh, groups,
                                                         strategy=strategy)
                full = model.init(0)
                params = step.shard_params(full)
                del full
                free_engines(torch)
                opt = step.init_opt_state(params)
                torch.cuda.synchronize()
                init_gib = torch.cuda.memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()
                reset_counts(mm, fa, rw, rg, ref)
                ms, losses, per_step = [], [], None
                for _ in range(DIST_STEPS):
                    groups.counter.reset()
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    out = step(params, opt, batch)
                    torch.cuda.synchronize()
                    ms.append((time.monotonic() - t0) * 1e3)
                    losses.append(float(out[2]["loss"]))
                    per_step = groups.counter.snapshot()
                counts = train_counts(mm, fa, rw, rg, ref)
                peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
                # the planner's count of a step is the step's, op by op
                plan = step.plan(shape)
                if issued(per_step) != plan:
                    raise AssertionError(f"dist: a {strategy} step issued {issued(per_step)}, "
                                         f"its plan says {plan}")
                del step, params, opt, out
                free_engines(torch)
                step_ms = statistics.median(ms[1:])
                mains[strategy] = {
                    "arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
                    "seq": TRAIN_SEQ, "strategy": strategy, "mesh": "1x1", "backend": "nccl",
                    "steps": DIST_STEPS, "losses": losses, "step_ms": ms, "ms_per_step": step_ms,
                    "unsharded_ms_per_step": unsharded_ms,
                    "ratio_to_unsharded": step_ms / unsharded_ms,
                    "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3, "init_gib": init_gib,
                    "peak_gib": peak_gib, "collectives_per_step": per_step,
                    "collectives_as_planned": True, **counts}
                if not all(math.isfinite(x) for x in losses):
                    raise AssertionError(f"dist {strategy}: losses {losses}")
                if (counts["plain_cuda_calls"]
                        or counts["attention_bwd_launches"] != cfg.n_layers * DIST_STEPS
                        or not counts["matmul_grad_launches"]):
                    raise AssertionError(f"dist {strategy}: the full-depth sharded steps' "
                                         f"launches {counts}")
            del model
            free_engines(torch)
            serve_rows = dist_serve_bits(torch, groups)
            del groups
        free_engines(torch)
    full_row = mains["dp"]
    log("dist", **full_row, world1_bit_equal=True, elastic_restore_bit_equal=True,
        seconds=time.monotonic() - t_phase)
    return {"world1": equal_rows["dp"], "world1_fsdp_tp": equal_rows["fsdp_tp"],
            "elastic": elastic_row, "main": full_row, "serve": serve_rows}


#: the dist phase's served arch at (1, 1)
DIST_SERVE_ARCH = "minitron-4b"


def dist_serve_bits(torch, groups) -> list:
    """:func:`phase_dist`'s (4): ``DIST_SERVE_ARCH`` served sharded on the
    world-1 NCCL group's (1, 1) mesh against the unsharded steps, bit for
    bit; returns each mode's run (its launches join the kernels line's
    ``dist`` path)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build_model
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(get_arch(DIST_SERVE_ARCH), n_layers=DIST_LAYERS)
    model = build_model(cfg, "cuda")
    params = model.init(SERVE_SHARDED_SEED)
    toks, feed = serve_sharded_inputs(torch, cfg)
    shape = tuple(toks.shape)

    def serve(prefill, decode):
        logits, cache = prefill({"tokens": toks})
        out, issued = [logits], [groups.counter.snapshot()]
        for t in feed:
            groups.counter.reset()
            logits, cache = decode(cache, t)
            out.append(logits)
            issued.append(groups.counter.snapshot())
        return out, cache, issued

    with torch.no_grad():
        want, want_cache, _ = serve(
            lambda b: model.prefill(params, b, max_len=SERVE_SHARDED_MAX_LEN),
            lambda c, t: model.decode_step(params, c, t))
    rows = []
    for sp in (False, True):
        step = steps_mod.make_sharded_serve_step(model, groups.mesh, groups, seq_parallel=sp)
        local = step.shard_params(params)
        reset_counts(mm, fa, rw, rg, ref)
        groups.counter.reset()
        got, cache, issued = serve(lambda b: step.prefill(local, b, SERVE_SHARDED_MAX_LEN),
                                   lambda c, t: step.decode(local, c, t))
        torch.cuda.synchronize()
        counts = train_counts(mm, fa, rw, rg, ref)
        plans = [step.plan("prefill", shape, SERVE_SHARDED_MAX_LEN)] + [
            step.plan("decode", shape, SERVE_SHARDED_MAX_LEN)] * len(feed)
        as_planned = all({op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes")}
                               if isinstance(v, dict) else v) for op, v in c.items()} == p
                         for c, p in zip(issued, plans))
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if not bits_equal(torch, a, b)]
        want_leaves = dict(leaves_with_paths(want_cache))
        cache_differ = [path for path, a in leaves_with_paths(cache)
                        if not bits_equal(torch, a, want_leaves[path])]
        row = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": "1x1", "backend": "nccl",
               "seq_parallel": sp, "logits_differ": differ, "cache_differ": cache_differ,
               "as_planned": as_planned, **counts}
        log("dist_serve_bit_equal", **{k: row[k] for k in (
            "arch", "layers", "seq_parallel", "logits_differ", "cache_differ", "as_planned",
            "launches")})
        if differ or cache_differ or not as_planned or counts["plain_cuda_calls"]:
            raise AssertionError(f"dist: sharded serving at (1, 1) is not the unsharded "
                                 f"steps': {row}")
        rows.append(row)
        del step, local, cache, got
    del params, model, want, want_cache
    free_engines(torch)
    return rows


#: the TP phase: tensor-parallel compute (``fsdp_tp``) with 2 and 4 ranks on
#: cuda:0 over gloo (NCCL takes one rank a device): (arch, layers, model axis,
#: dtypes); full width, the depth cut (recurrentgemma-2b's third layer is its
#: first attention layer).  rwkv6-1.6b's bf16 case is back (ROADMAP C.13):
#: its ranks' partial sums reach every sum over ``model`` in f32 (K1's f32
#: output and gradient modes, the f32 carrier), where they were rounded to
#: bf16 first and its ``u`` fell past twice the tensor-core control.
#: ``--tp-witness`` runs that case with the sums widened further
#: whisper-medium runs 2 encoder and 2 decoder layers; internvl2-26b's
#: 92553-row vocabulary splits over no model axis, so every rank holds its
#: embedding and head whole (ROADMAP A.9b)
TP_CASES = (("gemma2-2b", 2, 4, ("bfloat16", "float32")), ("mixtral-8x22b", 1, 4, ("bfloat16",)),
            ("rwkv6-1.6b", 2, 2, ("bfloat16", "float32")),
            ("recurrentgemma-2b", 3, 2, ("bfloat16", "float32")),
            ("whisper-medium", 2, 4, ("bfloat16", "float32")),
            ("internvl2-26b", 2, 4, ("bfloat16",)))
#: TP cases whose ranks take the step's gradient and skip AdamW's update:
#: internvl2-26b's whole embedding and head (1.14e9 params a rank) with an
#: f32 master and moments come to ~21 GB a rank, and four ranks do not fit
#: the card (nor does f32 at all)
TP_GRADS_ONLY = ("internvl2-26b",)
#: TP cases run in a group of their own beside the first wave's
TP_BESIDE = ("whisper-medium", "internvl2-26b")
#: the TP phase's batch (one batch shard: the mesh is (1, m)) and seed
TP_BATCH, TP_SEQ, TP_SEED = 2, 256, 7
#: a rank's limit: a hung collective fails the phase
TP_RANK_TIMEOUT = 300
#: the backward kernels' counters the TP phase reads, by kernel line
TP_BWD_COUNTERS = {"matmul_grad_launches": "matmul_bwd",
                   "attention_bwd_launches": "flash_attention_bwd",
                   "grouped_grad_launches": "grouped_matmul_bwd",
                   "rwkv6_bwd_launches": "rwkv6_scan_bwd", "rglru_bwd_launches": "rglru_scan_bwd"}


def tp_kernel_checks(torch) -> list:
    """The kernels at the local shapes tensor-parallel compute gives them,
    against their plain versions, forward and backward (bf16): K2 with 2 q
    heads and 1 KV head a rank (gemma2-2b's local layer at ``model`` 4), K1g
    with 2 experts a rank (mixtral-8x22b's up-GEMM at ``model`` 4, 64 rows an
    expert), K4 over 640 channels (recurrentgemma-2b's 2560 at ``model``
    4)."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf).requires_grad_(True)

    def run(fn, args, backend):
        with ops.use_backend(backend):
            out = fn(*args)
            y = out[0] if isinstance(out, tuple) else out
            dy = torch.ones_like(y) * 0.01
            grads = torch.autograd.grad(y, [a for a in args if a.requires_grad], dy)
        return y, grads

    cases = [
        ("flash_attention_1kv", lambda q, k, v: ops.flash_attention(
            q, k, v, class_id="flash_attention_local", causal=True, window=4096, softcap=0.0),
         (rand(2, 2, 256, 256), rand(2, 1, 256, 256), rand(2, 1, 256, 256))),
        ("grouped_matmul_2_experts", lambda x, w: ops.moe_gemm(x, w, class_id="moe_gemm_silu_glu"),
         (rand(2, 64, 6144, scale=0.1), rand(2, 6144, 32768, scale=0.02))),
        ("rglru_640", lambda x, a: ops.rglru(x, a, torch.zeros((2, 640), device="cuda")),
         (rand(2, 256, 640), (torch.rand((2, 256, 640), generator=g, device="cuda") * 0.5 + 0.4)
          .to(bf).requires_grad_(True))),
    ]
    rows = []
    for name, fn, args in cases:
        y, grads = run(fn, args, "cuda")
        y_ref, grads_ref = run(fn, args, "ref")
        y, y_ref = y.detach(), y_ref.detach()
        err = assert_close(torch, y, y_ref, BF16_TOL, f"tp {name}")
        grad_err = 0.0
        for a, b in zip(grads, grads_ref):
            scale = float(b.float().abs().max())
            grad_err = max(grad_err, assert_close(
                torch, a, b, dict(atol=GRAD_SCALE_ATOL * scale, rtol=GRAD_RTOL), f"tp {name} grad"))
        rows.append({"name": name, "shapes": [list(a.shape) for a in args], "max_abs_err": err,
                     "grad_max_abs_err": grad_err})
    return rows


def seeded_extras(torch, cfg, rows: int) -> dict:
    """:func:`serve_extras`' seeded frames or patch embeddings, one copy a
    row of a batch of ``rows``."""
    return {k: v.expand(rows, *v.shape).contiguous() for k, v in serve_extras(torch, cfg).items()}


def tp_batch(torch, cfg) -> dict:
    """The TP phase's batch: :func:`family_batch`'s tokens with
    :func:`seeded_extras`, so the encoder and the vision projection train
    on real inputs."""
    batch = family_batch(torch, cfg, TP_BATCH, TP_SEQ)
    batch.update(seeded_extras(torch, cfg, TP_BATCH))
    return batch


def tp_reference(torch, arch: str, layers: int, dtype: str) -> dict:
    """The world-1 step of a TP case, on the card: the plain path's loss,
    gradients and MoE routing (``ops.use_backend("ref")``: the reference
    the TP step is held to), and in bf16, per leaf, the control (the plain
    path with its bf16 matmuls on the library's tensor cores,
    :func:`tensor_core_matmuls`) and the world-1 kernel path, each against
    the plain path."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build_model
    from repro_torch.models.lm import uses_moe
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = dataclasses.replace(cut_depth(get_arch(arch), layers), dtype=dtype)
    model = build_model(cfg, "cuda")
    params = model.init(TP_SEED)
    batch = tp_batch(torch, cfg)
    with ops.use_backend("ref"), recorded_routing() as routing:
        loss_p, _, grads_p = steps_mod.value_and_grad(model, params, batch)
    out = {"loss": float(loss_p), "grads": dict(leaves_with_paths(grads_p)),
           "routing": routing[:sum(uses_moe(cfg, kind) for kind in cfg.layer_kinds)],
           "kernel": None}
    runs = []
    if dtype == "bfloat16":       # f32 is held to the fixed bounds: no control
        runs = [("kernel", contextlib.nullcontext), ("control", lambda: _plain_tc(ops))]
    for name, ctx in runs:
        with ctx():
            loss, _, grads = steps_mod.value_and_grad(model, params, batch)
        out[name] = {"loss_rel_err": abs(float(loss) - float(loss_p)) / abs(float(loss_p)),
                     "leaves": {path: grad_agreement(torch, a, b) for (path, a), b in
                                zip(leaves_with_paths(grads), leaves(grads_p))}}
        del grads
    del params, model
    return out


@contextlib.contextmanager
def recorded_routing():
    """Each MoE layer's top-k experts per token (``mlp.moe_route``'s
    indices, on the host), in the order of the calls: the forward's layers
    first, then the recompute's."""
    from repro_torch.models import mlp as mlpm

    inner, calls = mlpm.moe_route, []

    def route(*args, **kw):
        out = inner(*args, **kw)
        calls.append(out[2].sort(dim=-1).values.cpu())
        return out

    mlpm.moe_route = route
    try:
        yield calls
    finally:
        mlpm.moe_route = inner


@contextlib.contextmanager
def _plain_tc(ops):
    with ops.use_backend("ref"), tensor_core_matmuls():
        yield


def _tp_rank(rank, world, d, cases, refs, routings):
    """One rank of the TP phase: join the gloo group, run each case (its
    result, or the traceback, to ``d``)."""
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        import_port()
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                                world_size=world)
        try:
            out = [tp_case(torch, rank, *case, refs[i], routings[i]) for i, case in enumerate(cases)]
        finally:
            dist.destroy_process_group()
            for ref in refs:      # release the parent's tensors before the process exits
                ref.clear()
            torch.cuda.synchronize()
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    except BaseException:
        Path(d, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def tp_case(torch, rank, arch, layers, model_axis, dtype, ref_grads, ref_routing) -> dict:
    """One ``fsdp_tp`` train step of a TP case on this rank
    (``ShardedTrainStep``, the user's entry point): its kernel launches, its
    collectives against the plan (with their sets of axes), the loss, and
    per leaf this rank's gradient shard against its slice of the world-1
    plain-path gradient (``ref_grads``, shared from the parent on the card):
    the dot products, squared norms and largest entries that the parent sums
    over the ranks' distinct shards; and per MoE layer the tokens it routes
    to other experts than the world-1 step did (``ref_routing``).  An arch of
    :data:`TP_GRADS_ONLY` takes the step's gradient and skips the update (no
    optimizer state)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import local_slices, spec_axes
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, leaves_with_paths

    t0 = time.monotonic()
    cfg = dataclasses.replace(cut_depth(get_arch(arch), layers), dtype=dtype)
    model = build_model(cfg, "cuda")
    batch = tp_batch(torch, cfg)
    mesh = make_test_mesh(model=model_axis)
    step = steps_mod.make_sharded_train_step(model, adamw.AdamWConfig(), mesh, strategy="fsdp_tp")
    full = model.init(TP_SEED)
    params = step.shard_params(full)
    del full
    update = arch not in TP_GRADS_ONLY
    opt = step.init_opt_state(params) if update else {}
    seen = {}
    inner = adamw.apply_updates

    def recording(p, grads, state, cfg_, gnorm=None):   # the step's gradient shards
        seen["grads"] = [g.clone() for g in leaves(grads)]
        return inner(p, grads, state, cfg_, gnorm=gnorm) if update else (p, state, {})

    reset_counts(mm, fa, rw, rg, ref)
    step.groups.counter.reset()
    adamw.apply_updates = recording
    try:
        with recorded_routing() as routing:
            _, _, metrics = step(params, opt, batch)
    finally:
        adamw.apply_updates = inner
    rerouted = [int((a != b).any(dim=-1).sum()) for a, b in zip(routing, ref_routing)]
    torch.cuda.synchronize()
    counts = train_counts(mm, fa, rw, rg, ref)
    snap = step.groups.counter.snapshot()
    plan = step.plan(tuple(batch["tokens"].shape), by_axes=True)
    issued = {op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes", "axes")}
                   if isinstance(v, dict) else v) for op, v in snap.items()}
    local_params = sum(t.numel() for t in leaves(params))
    del params, opt                    # the stats below need only the gradient
    torch.cuda.empty_cache()
    stats = {}
    for (path, like), pl, g in zip(leaves_with_paths(step.params.like), step.params.placements,
                                   seen["grads"]):
        b = ref_grads[path][local_slices(tuple(like.shape), pl.spec, mesh, step.groups.coords)]
        stats[path] = {**_shard_stats(torch, g, b),
                       "distinct": any("model" in spec_axes(e) for e in pl.spec)}
    out = {"arch": arch, "dtype": dtype, "model": model_axis, "loss": float(metrics["loss"]),
           "rerouted": rerouted,
           "counts": counts, "collectives": snap, "as_planned": issued == plan,
           "model_gathers": {path: list(pl.gather_axes) for (path, _), pl in
                             zip(leaves_with_paths(step.params.like), step.params.compute)
                             if "model" in pl.gather_axes},
           "local_params": local_params, "stats": stats, "update": update,
           "seconds": time.monotonic() - t0}
    if not out["as_planned"]:
        out["plan"] = plan
    del step, seen, model
    torch.cuda.empty_cache()
    return out


def _shard_stats(torch, a, b) -> dict:
    """Sums of a·b, a·a, b·b and the largest |a - b| and |b| of a gradient
    shard ``a`` and its reference slice ``b`` (a view), in f32 chunks of
    rows: an expert stack's f32 copy would not fit beside the other ranks."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    rows = max(1, (1 << 24) // a2.shape[1])
    out = {"dot": 0.0, "aa": 0.0, "bb": 0.0, "max_diff": 0.0, "max_b": 0.0}
    for x, y in zip(a2.split(rows), b2.split(rows)):
        x, y = x.float(), y.float()
        out["dot"] += float((x * y).sum())
        out["aa"] += float((x * x).sum())
        out["bb"] += float((y * y).sum())
        out["max_diff"] = max(out["max_diff"], float((x - y).abs().max()))
        out["max_b"] = max(out["max_b"], float(y.abs().max()))
    return out


def tp_waves() -> list:
    """The TP phase's groups of ranks, (name, world, cases), in waves whose
    groups run at once: gemma2-2b's 4 ranks beside the 2-rank cases and
    :data:`TP_BESIDE`'s 4 ranks, then mixtral-8x22b's 4 ranks alone (each
    holds ~17 GB at the optimizer's update, beside the parent's world-1
    gradients)."""
    groups = []
    for world in sorted({m for _, _, m, _ in TP_CASES}, reverse=True):
        cases = [(arch, layers, m, dt) for arch, layers, m, dts in TP_CASES if m == world
                 for dt in dts]
        alone = [c for c in cases if c[0] == "mixtral-8x22b"]
        beside = [c for c in cases if c[0] in TP_BESIDE]
        rest = [c for c in cases if c not in alone + beside]
        groups += [(f"world{world}", world, rest)] if rest else []
        groups += [(f"world{world}_encdec_vlm", world, beside)] if beside else []
        groups += [(f"world{world}_mixtral", world, alone)] if alone else []
    together = [g for g in groups if not g[0].endswith("_mixtral")]
    return [w for w in (together, [g for g in groups if g not in together]) if w]


@contextlib.contextmanager
def ranks_allocator():
    """Spawned ranks take the expandable-segments allocator (they inherit
    the environment): four ranks and the parent share one card."""
    import os

    key = "PYTORCH_CUDA_ALLOC_CONF"
    prev = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"
    try:
        yield
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def phase_tp(torch) -> dict:
    """Tensor-parallel compute on one card (``fsdp_tp``, ROADMAP A.9b): the
    kernels at the local shapes it gives them (:func:`tp_kernel_checks`),
    then each case of :data:`TP_CASES` as one train step on a (1, m) mesh,
    m ranks spawned on cuda:0 over gloo (NCCL takes one rank a device; gloo
    stages a CUDA tensor's collective through host memory, so no time here
    is TP speed and none is printed).  Each rank's collectives must be its
    plan's, no leaf the plan keeps local gathered over ``model``, every
    kernel of the family launched; the loss and every gradient leaf (summed
    over the ranks' distinct shards) are held to the world-1 step's plain
    path on the card: bf16 by ``path_agreement``'s bounds and control (the
    plain path on the tensor cores), f32 by the fixed ``TRAIN_LOSS_REL``,
    ``TRAIN_GRAD_COS`` and ``TRAIN_GRAD_MAXREL``.  A token that a MoE layer
    routes to other experts than the world-1 step does (its top-k flipped
    by rounding) is counted; that layer's MoE leaves keep their cosine
    bound and lose their max_rel bound, as the serve phase leaves such
    tokens out of its logits comparison."""
    import math

    free_engines(torch)
    t_phase = time.monotonic()
    kernel_rows = tp_kernel_checks(torch)
    log("tp_kernels", rows=kernel_rows)
    free_engines(torch)
    runs, rows, failed, stages = [], [], [], {}
    stages["parent_gib_at_start"] = torch.cuda.memory_reserved() / 2 ** 30
    for wave in tp_waves():
        t0 = time.monotonic()
        refs = {name: [tp_reference(torch, *(c[:2] + c[3:])) for c in cases]
                for name, _, cases in wave}
        free_engines(torch)
        stages["+".join(refs) + "_references"] = time.monotonic() - t0
        t0 = time.monotonic()
        outs = spawn_tp_ranks(torch, wave, refs)
        stages["+".join(refs) + "_ranks"] = time.monotonic() - t0
        for name, world, cases in wave:
            for i, case in enumerate(cases):
                ranks = [o[i] for o in outs[name]]
                try:
                    rows.append(tp_agreement(torch, case, ranks, refs[name][i]))
                except AssertionError as e:   # every case is run and logged, then the phase fails
                    failed.append(str(e))
                runs.append({"launches": {k: sum(r["counts"]["launches"][k] for r in ranks)
                                          for k in ranks[0]["counts"]["launches"]},
                             "body_launches": dict(sum(
                                 (collections.Counter(r["counts"]["body_launches"]) for r in ranks),
                                 collections.Counter())),
                             "forward_bodies": merge_forward_bodies(
                                 [r["counts"]["forward_bodies"] for r in ranks]),
                             **{k: sum(r["counts"][k] for r in ranks) for k in (
                                 *TP_BWD_COUNTERS, "matmul_f32_launches",
                                 "matmul_f32_grad_launches")}})
        del refs
        free_engines(torch)
        torch.cuda.ipc_collect()           # the references the ranks mapped and released
    stages["parent_gib_at_end"] = torch.cuda.memory_reserved() / 2 ** 30
    out = {"kernels": kernel_rows, "cases": rows, "runs": runs, "stages": stages,
           "seconds": time.monotonic() - t_phase}
    log("tp", **{k: v for k, v in out.items() if k != "runs"})
    if failed:
        raise AssertionError("tp: " + "; ".join(failed))
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"tp: losses {[r['loss'] for r in rows]}")
    if stages["parent_gib_at_end"] > stages["parent_gib_at_start"] + 1:
        raise AssertionError(f"tp: the parent still holds memory after the ranks: {stages}")
    return out


def spawn_tp_ranks(torch, wave, refs, target=None, extra=()) -> dict:
    """Every group of ``wave`` at once, each its own gloo group over a
    ``FileStore`` in a temporary directory; returns each group's per-rank
    results.  The ranks map the parent's world-1 gradients (CUDA IPC, the
    spawn arguments).  ``target``, ``extra``: another rank function than
    :func:`_tp_rank`, and the arguments it takes after :func:`_tp_rank`'s."""
    import tempfile

    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    with contextlib.ExitStack() as stack:
        stack.enter_context(ranks_allocator())
        started = []
        for name, world, cases in wave:
            d = stack.enter_context(tempfile.TemporaryDirectory(prefix=f"chip_smoke_tp_{name}_"))
            procs = [ctx.Process(target=target or _tp_rank,
                                 args=(r, world, d, cases, [ref["grads"] for ref in refs[name]],
                                       [ref["routing"] for ref in refs[name]], *extra))
                     for r in range(world)]
            for p in procs:
                p.start()
            started.append((name, world, d, procs))
        deadline = time.monotonic() + TP_RANK_TIMEOUT
        for *_, procs in started:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        outs, bad = {}, {}
        for name, world, d, procs in started:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            errors = {r: Path(d, f"rank{r}.err").read_text() for r in range(world)
                      if Path(d, f"rank{r}.err").exists()}
            if errors or hung or any(p.exitcode for p in procs):
                bad[name] = {"hung": hung, "exit_codes": [p.exitcode for p in procs],
                             "errors": errors}
                continue
            outs[name] = [torch.load(Path(d, f"rank{r}.pt"), weights_only=False)
                          for r in range(world)]
    if bad:
        raise AssertionError(f"tp: ranks failed: {bad}")
    return outs


def tp_leaves(ranks) -> dict:
    """Per gradient leaf of a TP case, its cosine and max_rel against the
    world-1 plain path, summed over the ranks' distinct shards."""
    leaves = {}
    for path, first in ranks[0]["stats"].items():
        parts = [r["stats"][path] for r in ranks] if first["distinct"] else [first]
        dot, aa, bb = (sum(p[k] for p in parts) for k in ("dot", "aa", "bb"))
        leaves[path] = {"cos": dot / max((aa * bb) ** 0.5, 1e-30),
                        "max_rel": max(p["max_diff"] for p in parts)
                        / max(max(p["max_b"] for p in parts), 1e-30)}
    return leaves


def tp_agreement(torch, case, ranks, ref) -> dict:
    """One TP case's checks over its ranks (see :func:`phase_tp`)."""
    from repro_torch.configs import get_arch

    arch, layers, model_axis, dtype = case
    what = f"tp {arch} {dtype} model={model_axis}"
    for r in ranks:
        if not r["as_planned"]:
            raise AssertionError(f"{what}: collectives {r['collectives']} are not the plan "
                                 f"{r['plan']}")
        if r["counts"]["plain_cuda_calls"]:
            raise AssertionError(f"{what}: the plain version ran on the card: {r['counts']}")
    losses = {r["loss"] for r in ranks}
    if len(losses) != 1:
        raise AssertionError(f"{what}: the ranks' losses differ: {losses}")
    rwkv, moe, griffin = arch == "rwkv6-1.6b", arch == "mixtral-8x22b", arch == "recurrentgemma-2b"
    want = {"matmul", "matmul_grad_launches"}
    want |= {"rwkv6_scan", "rwkv6_bwd_launches"} if rwkv else {"flash_attention",
                                                                "attention_bwd_launches"}
    want |= {"grouped_matmul", "grouped_grad_launches"} if moe else set()
    want |= {"rglru_scan", "rglru_bwd_launches"} if griffin else set()
    counts = ranks[0]["counts"]
    launched = {k for k, n in {**counts["launches"], **counts}.items()
                if isinstance(n, int) and n}
    if not want <= launched:
        raise AssertionError(f"{what}: kernels {sorted(want - launched)} not launched")
    leaves = tp_leaves(ranks)
    loss = ranks[0]["loss"]
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    bound = {"loss_rel": TRAIN_LOSS_REL,
             "leaves": {p: {"cos": TRAIN_GRAD_COS, "max_rel": TRAIN_GRAD_MAXREL} for p in leaves}}
    if dtype == "bfloat16":
        c = ref["control"]
        bound["loss_rel"] = max(TRAIN_LOSS_REL, CONTROL_FACTOR * c["loss_rel_err"])
        for path, b in bound["leaves"].items():
            b["cos"] = min(TRAIN_GRAD_COS, 1 - CONTROL_FACTOR * (1 - c["leaves"][path]["cos"]))
            b["max_rel"] = max(TRAIN_GRAD_MAXREL, CONTROL_FACTOR * c["leaves"][path]["max_rel"])
    # a token routed to other experts than the world-1 step's moves its
    # layer's router and experts' gradients by its whole contribution (the
    # serve phase leaves such tokens out of its logits comparison): there
    # max_rel is not held, the cosine is
    rerouted = ranks[0]["rerouted"]
    moe_layers = [j for j, kind in enumerate(cut_depth(get_arch(arch), layers).layer_kinds)
                  if kind != "R"]
    exempt = {p for p in leaves for j, n in zip(moe_layers, rerouted)
              if n and p.startswith(f"['layers'][{j}]['moe']")}
    bad = [p for p, v in leaves.items() if v["cos"] < bound["leaves"][p]["cos"]
           or (v["max_rel"] > bound["leaves"][p]["max_rel"] and p not in exempt)]
    row = {"arch": arch, "layers": layers, "model": model_axis, "dtype": dtype,
           "ranks": len(ranks), "update": ranks[0]["update"],
           "seconds": max(r["seconds"] for r in ranks),
           "loss": loss, "world1_plain_loss": ref["loss"],
           "loss_rel_err": loss_rel, "loss_bound": bound["loss_rel"],
           "min_cos": min(v["cos"] for v in leaves.values()),
           "max_rel": max(v["max_rel"] for v in leaves.values()),
           "world1_kernel": ref["kernel"] and {
               "loss_rel_err": ref["kernel"]["loss_rel_err"],
               "min_cos": min(v["cos"] for v in ref["kernel"]["leaves"].values()),
               "max_rel": max(v["max_rel"] for v in ref["kernel"]["leaves"].values())},
           "rerouted_tokens": rerouted, "max_rel_not_held": sorted(exempt),
           "model_gathers": ranks[0]["model_gathers"],
           "local_params": [r["local_params"] for r in ranks],
           "collectives_per_rank": {op: v["count"] for op, v in ranks[0]["collectives"].items()
                                    if isinstance(v, dict)},
           "launches": {k: sum(r["counts"]["launches"][k] for r in ranks)
                        for k in ranks[0]["counts"]["launches"]}}
    log("tp_case", **row)
    if loss_rel > bound["loss_rel"] or bad:
        detail = {p: {"tp": leaves[p], "bound": bound["leaves"][p],
                      "world1_kernel": (ref["kernel"] or {}).get("leaves", {}).get(p),
                      "control": ref.get("control", {}).get("leaves", {}).get(p)} for p in bad}
        raise AssertionError(f"{what}: against the world-1 step: loss {loss_rel} (bound "
                             f"{bound['loss_rel']}), leaves {bad}: {detail}")
    return row


#: ``--tp-witness``: a TP case run with its sums over ``model`` reduced in
#: its own dtype (the step as it is) and widened to f32 (``activations``:
#: the residual stream's partial sums, forward and backward; ``all``: every
#: reduction, the replicated leaves' gradients too)
TP_WITNESS_CASE = ("rwkv6-1.6b", 2, 2, "bfloat16")
TP_WITNESS_WIDENINGS = ("none", "activations", "all")


def _tp_widened_rank(rank, world, d, cases, refs, routings, widen):
    """:func:`_tp_rank` with the sums over ``model`` that ``widen`` names
    reduced in f32 (each bf16 operand widened, the sum rounded back)."""
    import_port()
    import torch

    from repro_torch.distributed import collectives as col

    def widened(fn):
        def run(self, x):
            return fn(self, x.float()).to(x.dtype) if x.dtype == torch.bfloat16 else fn(self, x)
        return run

    if widen == "activations":
        tp = col.TensorParallel
        tp._reduce_scatter_last = widened(tp._reduce_scatter_last)
        tp._all_reduce = widened(tp._all_reduce)
    elif widen == "all":
        groups = col.MeshGroups
        inner_rs, inner_ar = groups.reduce_scatter, groups.all_reduce

        def reduce_scatter(self, out, x, axes):
            if x.dtype != torch.bfloat16:
                return inner_rs(self, out, x, axes)
            wide = torch.empty(out.shape, dtype=torch.float32, device=out.device)
            inner_rs(self, wide, x.float(), axes)
            out.copy_(wide)

        def all_reduce(self, x, axes, op=col.dist.ReduceOp.SUM):
            if x.dtype != torch.bfloat16:
                return inner_ar(self, x, axes, op)
            wide = x.float()
            inner_ar(self, wide, axes, op)
            x.copy_(wide)

        groups.reduce_scatter, groups.all_reduce = reduce_scatter, all_reduce
    _tp_rank(rank, world, d, cases, refs, routings)


def tp_witness(torch) -> int:
    """``chip_smoke.py --tp-witness``: where a bf16 TP case's distance from
    the world-1 step comes from.  :data:`TP_WITNESS_CASE` once for each of
    :data:`TP_WITNESS_WIDENINGS`, each held to the world-1 plain path as the
    TP phase holds it (the collectives' bytes, which widening changes, are
    not held to the plan); per run the loss, the smallest cosine and the
    leaves below their bound, beside the world-1 kernel path and the
    control."""
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, layers, model_axis, dtype = case = TP_WITNESS_CASE
    ref = tp_reference(torch, arch, layers, dtype)
    free_engines(torch)
    rows = []
    for widen in TP_WITNESS_WIDENINGS:
        name = f"witness_{widen}"
        ranks = [r[0] for r in spawn_tp_ranks(torch, [(name, model_axis, [case])], {name: [ref]},
                                               target=_tp_widened_rank, extra=(widen,))[name]]
        for r in ranks:
            r["as_planned"] = True
        try:
            tp_agreement(torch, case, ranks, ref)
            held = True
        except AssertionError:
            held = False
        leaves = tp_leaves(ranks)
        worst = sorted(leaves, key=lambda p: leaves[p]["cos"])[:4]
        rows.append({"widen": widen, "held": held, "loss": ranks[0]["loss"],
                     "loss_rel_err": abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"]),
                     "lowest_cos": {p: {"tp": leaves[p]["cos"],
                                        "world1_kernel": ref["kernel"]["leaves"][p]["cos"],
                                        "control": ref["control"]["leaves"][p]["cos"],
                                        "bound": min(TRAIN_GRAD_COS, 1 - CONTROL_FACTOR * (
                                            1 - ref["control"]["leaves"][p]["cos"]))}
                                    for p in worst},
                     "reduced_dtypes": {op: v["dtypes"] for op, v in ranks[0]["collectives"].items()
                                        if isinstance(v, dict)}})
        log("tp_witness", **rows[-1])
    print(json.dumps({"tp_witness": rows, "case": case, "device": nvidia_smi()}), flush=True)
    return 0


def first_whole_capture(torch, what: str, run) -> dict | None:
    """:func:`step_profile` of ``run`` until a capture holds a kernel for
    every launch the counters recorded, at most :data:`PROFILE_TRIES`
    times; None (not measured) after that."""
    for attempt in range(1, PROFILE_TRIES + 1):
        _, summary = step_profile(torch, run)
        if summary is not None:
            return {"attempt": attempt, **summary}
    log("profile_not_measured", what=what, tries=PROFILE_TRIES)
    return None


#: call sites of ``aten::copy_`` kept per step by :func:`copy_split`
COPY_SITES = 10


#: the profiler range each copy op of :func:`copy_split` runs in
COPY_SITE_RANGE = "copy_site: "


def copy_split(torch, run) -> dict:
    """``run()`` (one train step) under a torch.profiler capture, with the
    copies it makes split by call site: ``aten::copy_``'s device ms (its
    kernels' time in the capture) and calls per site, the ``COPY_SITES``
    largest and the rest summed.  A ``TorchDispatchMode`` runs each op
    dispatched on a CUDA tensor (``.to``, ``.float``: ``aten::_to_copy``;
    ``.contiguous``: ``aten::clone``; and every op that copies inside, say
    ``slice_backward``) in a profiler range named for its site: the
    innermost frame of ``repro_torch`` on the Python stack (file:line,
    function), the autograd node running where there is one (torch's own
    nodes copy too), and the op.  The backward runs on the calling thread
    for this step (autograd's multithreading off).  (The profiler's own
    stacks held no Python frame on the card, and CUDA events around each
    copy timed the host's issue too.)"""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sites(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not any(isinstance(t, torch.Tensor) and t.is_cuda for t in args):
                return func(*args, **kwargs)
            frame = sys._getframe(1)
            while frame is not None and "repro_torch/" not in frame.f_code.co_filename:
                frame = frame.f_back
            site = (f"{frame.f_code.co_filename.split('repro_torch/', 1)[1]}:{frame.f_lineno} "
                    f"{frame.f_code.co_name}" if frame else "outside repro_torch")
            node = torch._C._current_autograd_node()
            if node is not None:
                site = f"{site} [{node.name()}]"
            with record_function(f"{COPY_SITE_RANGE}{site} <- {func.__name__.split('.')[0]}"):
                return func(*args, **kwargs)

    with (torch.autograd.set_multithreading_enabled(False),
          profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof):
        with Sites():
            run()
        torch.cuda.synchronize()
    def copy_below(e):   # the dispatcher records a copy op again inside the mode's call
        todo = list(e.cpu_children)
        while todo:
            c = todo.pop()
            if c.name == "aten::copy_":
                return True
            todo += c.cpu_children
        return False

    ms, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if (e.name != "aten::copy_" or e.device_type != torch.autograd.DeviceType.CPU
                or copy_below(e)):
            continue
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        p = e.cpu_parent
        while p is not None and not p.name.startswith(COPY_SITE_RANGE):
            p = p.cpu_parent
        site = p.name.removeprefix(COPY_SITE_RANGE) if p is not None else "no dispatched op above it"
        ms[site] += dev / 1e3
        calls[site] += 1
    top = ms.most_common(COPY_SITES)
    return {"copy_ms": sum(ms.values()), "copy_calls": sum(calls.values()),
            "sites": [{"site": site, "ms": t, "calls": calls[site]} for site, t in top],
            "other_ms": sum(ms.values()) - sum(t for _, t in top),
            "other_sites": max(0, len(ms) - COPY_SITES)}


def profile_steps(torch) -> dict:
    """In a fresh process (``chip_smoke.py --profile-steps``): one profiled
    step of gemma2-2b at full depth and the train phase's batch, unsharded
    (``make_train_step``) and sharded at world 1 under NCCL
    (``make_sharded_train_step``, ``dp``), then one of each of
    ``FAMILIES`` at its depth and batch, each after two unprofiled steps.
    Late in the whole script every capture of a train step held three K1
    kernels fewer than its 653 launches; in a fresh process none
    did.  After each unsharded step's capture, one more step splits its
    copies by call site (:func:`copy_split`)."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticSource
    from repro_torch.distributed.context import using_remat_policy
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_arch(TRAIN_ARCH)
    np_batch = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)).batch_at(0)
    batch = {"tokens": torch.from_numpy(np_batch["tokens"]).cuda()}
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    model = build_model(cfg, "cuda")
    out = {}
    params = model.init(0)
    opt = steps_mod.init_opt_state(params)
    step = steps_mod.make_train_step(model, opt_cfg)
    for _ in range(2):
        step(params, opt, batch)
    out["train"] = first_whole_capture(torch, "train_step", lambda: step(params, opt, batch))
    out["copies"] = {TRAIN_ARCH: copy_split(torch, lambda: step(params, opt, batch))}
    with using_remat_policy("dots"):   # the same step under the dots remat policy
        for _ in range(2):
            step(params, opt, batch)
        out["train_dots"] = first_whole_capture(torch, "train_dots_step",
                                                lambda: step(params, opt, batch))
    del params, opt, step
    free_engines(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as d:
        with nccl_group(torch, d, "store"):
            step = steps_mod.make_sharded_train_step(model, opt_cfg, make_test_mesh(model=1),
                                                     strategy="dp")
            params = step.shard_params(model.init(0))
            opt = step.init_opt_state(params)
            for _ in range(2):
                step(params, opt, batch)
            out["dist"] = first_whole_capture(torch, "dist_step",
                                              lambda: step(params, opt, batch))
            del params, opt, step
    free_engines(torch)
    out["families"] = {}
    for arch, *_ in FAMILIES:
        run = family_step(torch, arch)
        out["families"][arch] = first_whole_capture(torch, f"{arch}_step", run)
        out["copies"][arch] = copy_split(torch, run)
        del run
        free_engines(torch)
    return out


def family_step(torch, arch: str):
    """One train step of ``arch`` at its ``FAMILIES`` depth and batch, as a
    call, after two unprofiled steps."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig

    _, layers, b, seq = next(f for f in FAMILIES if f[0] == arch)
    fcfg = get_arch(arch)
    if layers:
        fcfg = dataclasses.replace(fcfg, n_layers=layers)
    fmodel = build_model(fcfg, "cuda")
    params = fmodel.init(0)
    opt = steps_mod.init_opt_state(params)
    step = steps_mod.make_train_step(fmodel, AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                                         total_steps=FAMILY_STEPS))
    data = family_batch(torch, fcfg, b, seq)
    for _ in range(2):
        step(params, opt, data)
    return lambda: step(params, opt, data)


def profile_family(torch, arch: str) -> dict:
    """``--profile-family ARCH``: one ``FAMILIES`` step alone in a fresh
    process (late in the whole script a capture may lose kernels, C.9): its
    capture (:func:`first_whole_capture`: device busy ms and share, top
    ops) and the device ms a step of each kernel (:meth:`Timer.kernel_ms`,
    no L2 flush)."""
    run = family_step(torch, arch)
    return {"arch": arch, "capture": first_whole_capture(torch, f"{arch}_step", run),
            "kernel_ms": Timer(torch, flush=None).kernel_ms(run, iters=2)}


#: the sharded-serving phase (ROADMAP A.9b): (arch, layers, model axis), at
#: full width with the depth cut (recurrentgemma-2b's third layer is its
#: first attention layer, whose one KV head splits ``head_dim`` over model;
#: mixtral-8x22b's 8 experts split 2 a rank; whisper-medium's 2 encoder and
#: 2 decoder layers, its 16 heads 4 a rank and its 1500 frames 375 a rank
#: under ``seq_parallel``; internvl2-26b's 8 KV heads 2 a rank, its 256
#: patches and 256 tokens 128 a rank, its vocabulary whole); each served
#: with a plain ``fsdp_tp`` prefill and with its S split over model
SERVE_SHARDED_CASES = (("minitron-4b", 2, 4), ("recurrentgemma-2b", 3, 2),
                       ("rwkv6-1.6b", 2, 2), ("mixtral-8x22b", 1, 4),
                       ("whisper-medium", 2, 4), ("internvl2-26b", 2, 4))
#: one row, which a data axis of 2 does not split (``long_500k``'s case):
#: (arch, layers, data axis) on a (data, 1) mesh, plain ``fsdp_tp``; each
#: K/V cache's positions (whisper's frames too) split over data, every
#: attention's softmax merged over it
SERVE_SHARDED_ONE_ROW = (("whisper-medium", 2, 2), ("recurrentgemma-2b", 3, 2))
#: their decode steps: on a data axis every step gathers every weight over
#: it, through host memory under gloo
SERVE_SHARDED_ONE_ROW_STEPS = 3
#: the prompt (2 rows of 256 tokens), the decode steps (teacher-forced),
#: the cache's text positions and the weights' seed
SERVE_SHARDED_BATCH, SERVE_SHARDED_SEQ, SERVE_SHARDED_STEPS = 2, 256, 8
SERVE_SHARDED_MAX_LEN, SERVE_SHARDED_SEED = 512, 9
#: the kernels each family's serving steps must launch
SERVE_SHARDED_KERNELS = {"minitron-4b": ("matmul", "flash_attention"),
                         "recurrentgemma-2b": ("matmul", "flash_attention", "rglru_scan"),
                         "rwkv6-1.6b": ("matmul", "rwkv6_scan"),
                         "mixtral-8x22b": ("matmul", "flash_attention", "grouped_matmul"),
                         "whisper-medium": ("matmul", "flash_attention"),
                         "internvl2-26b": ("matmul", "flash_attention")}
#: the K2 classes each family's serving steps must launch besides
SERVE_SHARDED_CLASSES = {"whisper-medium": ("flash_attention_bidir", "flash_attention_cross")}


def serve_sharded_inputs(torch, cfg, rows: int = SERVE_SHARDED_BATCH,
                         steps: int = SERVE_SHARDED_STEPS) -> tuple:
    """The phase's prompt and its decode steps' tokens, seeded, on the card."""
    g = torch.Generator(device="cpu").manual_seed(SERVE_SHARDED_SEED)
    toks = torch.randint(1, cfg.vocab_size, (rows, SERVE_SHARDED_SEQ), generator=g)
    feed = torch.randint(1, cfg.vocab_size, (steps, rows), generator=g)
    return toks.cuda(), feed.cuda()


def serve_sharded_batch(torch, cfg, rows: int) -> tuple:
    """The prefill batch (the prompt and :func:`serve_extras`' seeded frames
    or patch embeddings, one copy a row) and the decode steps' tokens (a
    one-row case's :data:`SERVE_SHARDED_ONE_ROW_STEPS`)."""
    steps = SERVE_SHARDED_STEPS if rows > 1 else SERVE_SHARDED_ONE_ROW_STEPS
    toks, feed = serve_sharded_inputs(torch, cfg, rows, steps)
    extras = {k: v.expand(rows, *v.shape).contiguous() for k, v in serve_extras(torch, cfg).items()}
    return {"tokens": toks, **extras}, feed


def serve_sharded_reference(torch, arch: str, layers: int, rows: int) -> dict:
    """The world-1 serving steps of a case on the card: the kernel path's
    prefill and decode logits, and per step the f64 control's distance from
    the plain path (the serve phases' control)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ops import use_backend
    from repro_torch.models import build_model

    cfg = cut_depth(get_arch(arch), layers)
    model = build_model(cfg, "cuda")
    params = model.init(SERVE_SHARDED_SEED)
    batch, feed = serve_sharded_batch(torch, cfg, rows)

    def run():
        logits, cache = model.prefill(params, batch, max_len=SERVE_SHARDED_MAX_LEN)
        out = [logits.float().cpu()]
        for t in feed:
            logits, cache = model.decode_step(params, cache, t)
            out.append(logits.float().cpu())
        return out

    kernel = run()
    with use_backend("ref"):
        plain = run()
        with f64_accumulation():
            control = run()
    torch.cuda.synchronize()
    del params, model
    return {"kernel": kernel,
            "control": [max_err(torch, c, p) for c, p in zip(control, plain)]}


def _serve_sharded_rank(rank, world, d, cases, _grads, _routings):
    """One rank of the sharded-serving phase: join the gloo group, serve
    each case plain and sequence-parallel (results, or the traceback, to
    ``d``)."""
    import os
    import traceback

    import torch
    import torch.distributed as dist

    try:
        import_port()
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                                world_size=world)
        try:
            out = [serve_sharded_case(torch, rank, *case[:4], sp) for case in cases
                   for sp in case[4]]
        finally:
            dist.destroy_process_group()
            torch.cuda.synchronize()
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    except BaseException:
        Path(d, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def serve_sharded_case(torch, rank, arch, layers, model_axis, rows, seq_parallel) -> dict:
    """A case's prefill of ``rows`` rows and teacher-forced decode steps on
    this rank through ``make_sharded_serve_step`` (the user's entry point),
    on a (world / model, model) mesh: the gathered logits of each, the
    collectives against the plan, the kernel launches."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import MeshGroups
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model

    t0 = time.monotonic()
    cfg = cut_depth(get_arch(arch), layers)
    model = build_model(cfg, "cuda")
    mesh = make_test_mesh(model=model_axis)
    groups = MeshGroups(mesh)
    step = steps_mod.make_sharded_serve_step(model, mesh, groups, seq_parallel=seq_parallel)
    full = model.init(SERVE_SHARDED_SEED)
    params = step.shard_params(full)
    del full
    torch.cuda.empty_cache()
    batch, feed = serve_sharded_batch(torch, cfg, rows)
    shape = tuple(batch["tokens"].shape)
    counter, plans, issued, logits_out = groups.counter, [], [], []
    reset_counts(mm, fa, rw, rg, ref)
    counter.reset()
    logits, cache = step.prefill(params, batch, SERVE_SHARDED_MAX_LEN)
    issued.append(counter.snapshot())
    plans.append(step.plan("prefill", shape, SERVE_SHARDED_MAX_LEN, by_axes=True))
    local = [logits]
    for t in feed:
        counter.reset()
        logits, cache = step.decode(params, cache, t)
        issued.append(counter.snapshot())
        plans.append(step.plan("decode", shape, SERVE_SHARDED_MAX_LEN, by_axes=True))
        local.append(logits)
    torch.cuda.synchronize()
    counts = train_counts(mm, fa, rw, rg, ref)
    logits_out = [step.full_logits(x, rows).float().cpu() for x in local]
    as_planned = all({op: ({k: v[k] for k in ("count", "operand_bytes", "result_bytes", "axes")}
                           if isinstance(v, dict) else v) for op, v in got.items()} == plan
                     for got, plan in zip(issued, plans))
    out = {"arch": arch, "mesh": list(mesh.shape.values()), "rows": rows,
           "seq_parallel": seq_parallel, "counts": counts,
           "as_planned": as_planned, "logits": logits_out if rank == 0 else None,
           "collectives": {"prefill": issued[0], "decode": issued[1]},
           # a decode step's attentions (self, and whisper's cross)
           "attentions": sum(k != "R" for k in cfg.layer_kinds) * (2 if cfg.encoder_layers else 1),
           "seconds": time.monotonic() - t0}
    if not as_planned:
        out["plans"] = plans[:2]
    del step, params, cache, model
    torch.cuda.empty_cache()
    return out


def serve_sharded_groups() -> list:
    """The sharded-serving phase's groups of ranks, (name, world, cases), all
    run at once: the (1, m) cases by world (whisper-medium's and
    internvl2-26b's 4 ranks a group of their own), each plain and
    ``seq_parallel``, and the one-row cases on (d, 1).  A case: (arch,
    layers, model axis, rows, modes)."""
    modes = (False, True)
    groups = []
    for world in sorted({m for _, _, m in SERVE_SHARDED_CASES}):
        cases = [(a, n, m, SERVE_SHARDED_BATCH, modes) for a, n, m in SERVE_SHARDED_CASES
                 if m == world]
        beside = [c for c in cases if c[0] in TP_BESIDE]
        rest = [c for c in cases if c not in beside]
        groups += [(f"serve_world{world}", world, rest)] if rest else []
        groups += [(f"serve_world{world}_encdec_vlm", world, beside)] if beside else []
    for world in sorted({d for _, _, d in SERVE_SHARDED_ONE_ROW}):
        groups.append((f"serve_one_row{world}", world,
                       [(a, n, 1, 1, (False,)) for a, n, d in SERVE_SHARDED_ONE_ROW if d == world]))
    return groups


def phase_serve_sharded(torch) -> dict:
    """Sharded serving on one card (``make_sharded_serve_step``, ROADMAP
    A.9b): each case of :data:`SERVE_SHARDED_CASES` on a (1, m) mesh, m
    ranks spawned on cuda:0 over gloo (as :func:`phase_tp`: a collective of
    CUDA tensors goes through host memory, so no time here is sharded
    serving's and none is printed), with a plain ``fsdp_tp`` prefill and
    with its S split over model, and each of :data:`SERVE_SHARDED_ONE_ROW`
    with one row on a (d, 1) mesh, then ``SERVE_SHARDED_STEPS``
    teacher-forced decode steps (a one-row case's
    :data:`SERVE_SHARDED_ONE_ROW_STEPS`).  Each prefill's and decode step's logits
    (gathered) are held to the same model's world-1 kernel path on the card
    within the serve phases' bound (the larger of ``LOGITS_REL_BOUND`` of
    max |logit| and ``CONTROL_FACTOR`` times the f64 control); every
    collective is the plan's; the family's kernels (and K2 classes) are
    launched, K1 in its f32 output mode at m > 1 (bf16), a one-row decode
    step merges each attention's softmax over data (two all-reduces an
    attention, whisper's cross attention too), and no plain version
    reaches a CUDA tensor.  Each case's seconds (its slowest rank's) are
    returned for ``phase_seconds``."""
    import math

    free_engines(torch)
    t_phase = time.monotonic()
    wave = serve_sharded_groups()
    refs = {f"{c[0]}/{c[3]}": serve_sharded_reference(torch, c[0], c[1], c[3])
            for _, _, cases in wave for c in cases}
    free_engines(torch)
    dummy = {name: [{"grads": None, "routing": None} for _ in cases] for name, _, cases in wave}
    outs = spawn_tp_ranks(torch, wave, dummy, target=_serve_sharded_rank)
    rows, runs, failed = [], [], []
    for name, world, cases in wave:
        for i, run in enumerate(zip(*outs[name])):
            lead = run[0]
            arch, mesh, sp = lead["arch"], lead["mesh"], lead["seq_parallel"]
            ref = refs[f"{arch}/{lead['rows']}"]
            diffs, bounds = [], []
            for got, want, control in zip(lead["logits"], ref["kernel"], ref["control"]):
                diffs.append(max_err(torch, got, want))
                bounds.append(max(LOGITS_REL_BOUND * float(want.abs().max()),
                                  CONTROL_FACTOR * control))
            launches = {k: sum(r["counts"]["launches"][k] for r in run)
                        for k in lead["counts"]["launches"]}
            classes = sum((collections.Counter(r["counts"]["attention_class_launches"])
                           for r in run), collections.Counter())
            f32 = sum(r["counts"]["matmul_f32_launches"] for r in run)
            plain = sum((collections.Counter(r["counts"]["plain_cuda_calls"]) for r in run),
                        collections.Counter())
            merges = lead["collectives"]["decode"].get("all_reduce", {}).get("axes", {}).get(
                "data", 0)
            want_merges = 0 if mesh[0] == 1 else 2 * lead["attentions"]
            row = {"arch": arch, "mesh": mesh, "rows": lead["rows"], "seq_parallel": sp,
                   "logits_max_abs_diff": diffs, "logits_bound": bounds,
                   "finite": all(math.isfinite(x) for x in diffs),
                   "as_planned": all(r["as_planned"] for r in run), "launches": launches,
                   "attention_classes": dict(classes), "f32_launches": f32,
                   "plain_cuda_calls": dict(plain), "decode_merges_over_data": merges,
                   "collectives": lead["collectives"],
                   "seconds": max(r["seconds"] for r in run)}
            rows.append(row)
            runs.append({"launches": launches,
                         "body_launches": dict(sum((collections.Counter(r["counts"]["body_launches"])
                                                    for r in run), collections.Counter())),
                         "forward_bodies": merge_forward_bodies(
                             [r["counts"]["forward_bodies"] for r in run]),
                         "attention_class_launches": dict(classes),
                         "matmul_f32_launches": f32})
            bad = [j for j, (a, b) in enumerate(zip(diffs, bounds)) if not a <= b]
            missing = [k for k in SERVE_SHARDED_KERNELS[arch] if not launches.get(k)]
            missing += [c for c in SERVE_SHARDED_CLASSES.get(arch, ())
                        if not any(key.split("/")[0] == c and n for key, n in classes.items())]
            no_f32 = mesh[1] > 1 and not f32
            if (bad or not row["as_planned"] or missing or plain or no_f32
                    or merges != want_merges):
                failed.append(f"{arch} mesh={mesh} seq_parallel={sp}: logits past bound at "
                              f"steps {bad}, as planned {row['as_planned']}, kernels not "
                              f"launched {missing}, plain calls {dict(plain)}, f32 launches "
                              f"{f32}, decode merges over data {merges} (want {want_merges})"
                              + ("" if lead.get("plans") is None else f", plans {lead['plans']}"))
    del refs
    free_engines(torch)
    torch.cuda.ipc_collect()
    out = {"cases": rows, "runs": runs, "seconds": time.monotonic() - t_phase}
    log("serve_sharded", **{k: v for k, v in out.items() if k != "runs"})
    if failed:
        raise AssertionError("serve_sharded: " + "; ".join(failed))
    return out


def phase_step_profiles(torch) -> dict:
    """:func:`profile_steps` in a fresh process; returns its result."""
    free_engines(torch)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--profile-steps"],
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"step_profiles"')]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"--profile-steps failed ({out.returncode}):\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    for ln in out.stdout.splitlines():
        if '"profile_' in ln:
            print(ln, flush=True)          # its refused captures
    res = json.loads(lines[-1])["step_profiles"]
    log("step_profiles", **res)
    return res


#: quickstart's step 5, K1 (f32, 64x48x64, N(0, 1) inputs: outputs up to
#: ~30) against its plain version: the f32 tolerance, 2e-4 + 2e-4·|y|
QUICKSTART_ERR = 2e-4 * (1 + 30)


def phase_examples(torch) -> dict:
    """Three of the port's examples once on the card, through their
    ``main`` (what ``python -m repro_torch.examples.<name>`` runs):
    ``quickstart`` (step 5 launches K1), ``serve_lm`` (the slot engine on
    three reduced archs) and ``train_lm`` for 60 steps (it fails unless the
    loss falls).  In this process: a process of its own takes ~10 s to
    reach the card.  The main path's launch counts are not theirs."""
    import importlib
    import io
    import tempfile

    free_engines(torch)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as d:
        runs = {"quickstart": ["--db", str(Path(d) / "db.json")], "serve_lm": [],
                "train_lm": ["--steps", "60", "--out", str(Path(d) / "train_lm")]}
        for name, args in runs.items():
            module = importlib.import_module(f"repro_torch.examples.{name}")
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                module.main(args)
            torch.cuda.synchronize()
            out[name] = {"seconds": time.monotonic() - t0,
                         "stdout": buf.getvalue().strip().splitlines()[-4:]}
            free_engines(torch)
    step5 = next(ln for ln in out["quickstart"]["stdout"] if "kernel-vs-plain max err" in ln)
    err = float(step5.split("max err:")[1].split()[0])
    if not step5.endswith("(cuda)") or err > QUICKSTART_ERR:
        raise AssertionError(f"quickstart's step 5: {step5}")
    log("examples", **out)
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    if argv[:1] == ["--scans-ab"] and len(argv) == 2:
        return scans_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--head-ab"] and len(argv) == 2:
        return head_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--time-head"] and len(argv) == 2:   # one turn of --head-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_head(torch, Timer(torch)):
            print(json.dumps(row), flush=True)
        return 0
    if argv[:1] == ["--attn-ab"] and len(argv) == 2:
        return attn_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--time-attn"] and len(argv) == 2:   # one turn of --attn-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_attn(torch, Timer(torch)):
            print(json.dumps(row), flush=True)
        return 0
    if argv[:1] == ["--rows-ab"] and len(argv) == 2:
        return rows_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--mma-ab"] and len(argv) == 2:
        return mma_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--time-mma"] and len(argv) == 2:   # one turn of --mma-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_mma(torch, Timer(torch)):
            print(json.dumps(row), flush=True)
        return 0
    if argv[:1] == ["--time-rows"] and len(argv) == 2:   # one turn of --rows-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_rows(torch, Timer(torch)):
            print(json.dumps(row), flush=True)
        return 0
    if argv[:1] == ["--profile-steps"] and len(argv) <= 2:   # a fresh process for the captures
        import_port(Path(argv[1]).resolve() if len(argv) == 2 else ROOT / "src")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"step_profiles": profile_steps(torch)}), flush=True)
        return 0
    if argv[:1] == ["--profile-family"] and len(argv) == 2:   # one family's step alone
        import_port()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(profile_family(torch, argv[1])), flush=True)
        print(nvidia_smi())
        return 0
    if argv == ["--tp-witness"]:
        import_port()
        return tp_witness(torch)
    if argv[:1] == ["--dist-ab"] and len(argv) == 2:
        return dist_ab(Path(argv[1]).resolve())
    if argv[:1] == ["--dist-turn"] and len(argv) == 2:   # one turn of --dist-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(dist_turn(torch)), flush=True)
        return 0
    if argv[:1] == ["--time-scans"] and len(argv) == 2:   # one turn of --scans-ab
        import_port(Path(argv[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        for row in time_scans(torch, Timer(torch), plain=False, bwd=True):
            print(json.dumps(row), flush=True)
        return 0
    if argv:
        print(f"chip_smoke.py: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    import_port()
    smi = nvidia_smi()
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0))
    # the plain versions run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_s = {}

    def phase(name, fn, *args):   # each phase's wall seconds
        t0 = time.monotonic()
        out = fn(*args)
        phase_s[name] = time.monotonic() - t0
        return out

    phase("build", phase_build)
    phase("l2_flush", phase_l2_flush, torch)
    timer = Timer(torch)
    mmr = phase("matmul", phase_matmul, torch, timer)
    far = phase("attention", phase_attention, torch, timer)
    scr = phase("scans", phase_scans, torch, timer)
    prime = phase("prime_matmul", phase_prime_matmul, torch, timer)
    grr = phase("grouped", phase_grouped, torch, timer)
    chunk = phase("chunk_kernels", phase_chunk_kernels, torch, timer)
    under = under_bytes_bound(mmr["shapes"] + mmr["rounding"] + far["shapes"] + far["slice"]
                              + scr["rwkv6"]["shapes"] + scr["rglru"]["shapes"] + prime
                              + grr["shapes"] + grr["rounding"]
                              + [chunk["attention"], chunk["matmul"]])
    log("bytes_bound_check", under=under)
    if under:
        raise AssertionError(f"timings under their bytes bound (data left in the L2): {under}")
    tuning, tuned_db = phase("tuning", phase_tuning, torch, timer)
    del timer
    torch.cuda.empty_cache()
    srv = [phase(f"serve/{arch}", phase_serve, torch, arch) for arch in SERVE_KERNELS]
    tuned = phase("serve_tuned", phase_serve_tuned, torch, tuned_db,
                  next(r for r in srv if r["arch"] == TUNED_ARCH))
    paged = phase("paged", phase_paged, torch, srv)
    spec = phase("spec", phase_spec, torch)
    fleet = phase("fleet", phase_fleet, torch, tuned_db, srv)
    train = phase("train", phase_train, torch, Timer(torch))
    under = under_bytes_bound(train["attention_bwd"]["timed"])
    if under:
        raise AssertionError(f"train timings under their bytes bound: {under}")
    fam = phase("train_families", phase_train_families, torch, Timer(torch))
    k = fam["kernels"]
    under = under_bytes_bound([r for r in k["rwkv6_bwd"] + k["rglru_bwd"] if "ms" in r]
                              + k["attention_bwd"]
                              + [r[part] for r in k["grouped_bwd"] for part in ("dx", "dw")]
                              + k["internvl2_head"])
    if under:
        raise AssertionError(f"train_families timings under their bytes bound: {under}")
    dist_r = phase("dist", phase_dist, torch, train["main"]["ms_per_step"])
    tp_r = phase("tp", phase_tp, torch)
    ss_r = phase("serve_sharded", phase_serve_sharded, torch)
    # each TP and sharded-serving case's seconds (inside those phases; the
    # groups of ranks run at once)
    for r in tp_r["cases"]:
        phase_s[f"tp_case/{r['arch']}/{r['dtype']}"] = r["seconds"]
    for r in ss_r["cases"]:
        mode = "sp" if r["seq_parallel"] else "plain"
        phase_s[f"serve_sharded_case/{r['arch']}/{r['mesh'][0]}x{r['mesh'][1]}/{mode}"] = \
            r["seconds"]
    profiles = phase("step_profiles", phase_step_profiles, torch)
    examples = phase("examples", phase_examples, torch)
    train["main"]["profile"], dist_r["main"]["profile"] = profiles["train"], profiles["dist"]
    train["dots"]["profile"] = profiles["train_dots"]
    log("train_dots_profile", profile=profiles["train_dots"])
    for run in fam["runs"]:
        run["profile"] = profiles["families"][run["arch"]]
    log("families_profiles", **{r["arch"]: r["profile"] for r in fam["runs"]})
    # internvl2's LM head (forward by events, dX and dW held) over its
    # profiled step's device-busy time: the head's share of the step
    head = {r["name"]: r for r in fam["kernels"]["internvl2_head"]}
    head_ms = (head["internvl2_head_fwd"]["ms"] + head["internvl2_head_dx"]["held_ms"]
               + head["internvl2_head_dw"]["held_ms"])
    busy = (profiles["families"]["internvl2-26b"] or {}).get("device_busy_ms")
    log("internvl2_head_share", head_ms=head_ms, step_busy_ms=busy,
        share=head_ms / busy if busy else None)
    log("copy_sites", **profiles["copies"])
    # main-path runs, counts read apart
    paths = {"slot": srv, "paged": paged, "spec": [spec], "fleet": fleet,
             "train": [train["main"], train["dots"]],
             "families": fam["runs"], "dist": [dist_r["main"], *dist_r["serve"]],
             "tp": tp_r["runs"], "serve_sharded": ss_r["runs"]}

    def count(r, name, body=None):   # one run's launches of a kernel (of one body)
        if body is None:
            return r["launches"][name]
        return sum(c for key, c in r["body_launches"].items() if key.startswith(f"{name}/{body}/"))

    def by_path(name, body=None):
        return {path: sum(count(r, name, body) for r in rs) for path, rs in paths.items()}

    def served(name, body=None):   # launches summed over the main-path runs
        return sum(by_path(name, body).values())

    def forward_by_path(kernel):   # bf16 forward launches per tensor-core body (forward_bodies)
        out = {}
        for path, rs in paths.items():
            fb = merge_forward_bodies([r["forward_bodies"] for r in rs]).get(kernel)
            if fb and (fb["wgmma"] or fb["mma"]):
                out[path] = fb
        return out

    def wgmma_by_path(kernel):
        return {path: fb["wgmma"] for path, fb in forward_by_path(kernel).items()}

    def class_by_path(class_id):   # K2 launches of one class per path
        return {path: sum(n for r in rs for key, n in r.get("attention_class_launches", {}).items()
                          if key.split("/")[0] == class_id) for path, rs in paths.items()}

    def timed(row, keys):
        return {"shape": {k: row[k] for k in keys},
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    rep_mm = next(r for r in mmr["shapes"] if r["M"] == 4 and r["N"] == 256000)
    rep_fa = next(r for r in far["shapes"] if (r["arch"], r["S"]) == ("minitron-4b", 512))
    # the rows body at decode: K1's q/o projection at 4 slots
    dec_mm = next(r for r in mmr["shapes"] if (r["M"], r["K"], r["N"]) == (4, 3072, 3072))
    rep_rw = scr["rwkv6"]["shapes"][0]
    rep_rg = scr["rglru"]["shapes"][0]
    rep_gr = next(r for r in grr["shapes"] if r["M"] == MOE_ROWS[0] and r["class"] == "moe_gemm")
    # the tensor-core body at prefill: K1's q/o projection, K1g's down-GEMM
    pre_mm = next(r for r in mmr["shapes"] if (r["M"], r["K"], r["N"]) == (256, 3072, 3072))
    pre_gr = next(r for r in grr["shapes"] if r["M"] == MOE_ROWS[1] and r["class"] == "moe_gemm")
    # rounding mode, at the launch the registry-served path makes
    if tuned["rounding_record"]["shape"] != list(ROUND_SERVED):
        raise AssertionError(f"the served rounding launch {tuned['rounding_record']} is not "
                             f"among the timed cases {ROUND_SERVED}")
    rep_round = next(r for r in mmr["rounding"]
                     if (r["class"], r["M"], r["K"], r["N"], r["round_k"]) == ROUND_SERVED)
    # the slice's non-causal K2: whisper's encoder, and its cross-attention
    # at decode (Q = 1), the launch it makes most
    rep_bidir = next(r for r in far["slice"] if r["class"] == "flash_attention_bidir")
    rep_cross = next(r for r in far["slice"] if r["class"] == "flash_attention_cross" and r["Sq"] == 1)
    # K2 on narrow Q tiles, a group of them a CTA: whisper's cross-attention
    # at the prime 181 (1-row tiles); its launches are the slot runs'
    rep_narrow = next(r for r in far["slice"]
                      if r["class"] == "flash_attention_cross" and r["Sq"] == PRIME_PROMPT)
    # K1 on the rows body over a group of narrow M tiles: the prime 397-row
    # GEMM (1-row tiles, 16 a CTA); its launches are the slot runs'
    rep_prime = next(r for r in prime if (r["M"], r["K"], r["N"]) == PRIME_MNK)
    mm_grouped = sum((collections.Counter(r["matmul_tile_launches"]["grouped_tile_launches"])
                      for r in srv), collections.Counter())
    kernels = [
        {"name": "matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "launches": served("matmul"),
         "max_abs_err": mmr["max_abs_err"], **timed(rep_mm, ("class", "M", "K", "N", "split_k", "ctas"))},
        {"name": "matmul_decode", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": "rows",
         "launches": served("matmul", "rows"), "max_abs_err": mmr["max_abs_err"],
         **timed(dec_mm, ("class", "M", "K", "N", "split_k", "ctas"))},
        {"name": "matmul_rows_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": "rows",
         "launches": sum(mm_grouped.values()), "launches_by_path": {"slot": sum(mm_grouped.values())},
         "launches_by_tile": dict(mm_grouped), "max_abs_err": rep_prime["max_abs_err"],
         **{k: rep_prime[k] for k in ("m_group", "device_ms", "library_device_ms", "floor_ms",
                                      "tile64_device_ms")},
         **timed(rep_prime, ("class", "M", "K", "N", "split_k", "ctas"))},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126",
         "body": "mma", "launches": served("flash_attention"), "max_abs_err": far["max_abs_err"],
         **timed(rep_fa, ("B", "Hq", "Hkv", "S", "D", "ctas"))},
        {"name": "rwkv6_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:86", "launches": served("rwkv6_scan"),
         "max_abs_err": scr["rwkv6"]["max_abs_err"], "device_ms": rep_rw["device_ms"],
         **timed(rep_rw, ("B", "H", "T", "D", "ctas"))},
        {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:65", "launches": served("rglru_scan"),
         "max_abs_err": scr["rglru"]["max_abs_err"], "device_ms": rep_rg["device_ms"],
         **timed(rep_rg, ("B", "T", "C", "ctas"))},
        {"name": "grouped_matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "launches": served("grouped_matmul"),
         "body": "rows", "max_abs_err": grr["max_abs_err"],
         **timed(rep_gr, ("class", "E", "M", "K", "N", "split_k", "ctas"))},
        {"name": "matmul_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": pre_mm["body"],
         "launches": sum(wgmma_by_path("matmul").values()),
         "launches_by_path": wgmma_by_path("matmul"),
         "forward_bodies_by_path": forward_by_path("matmul"), "max_abs_err": mmr["max_abs_err"],
         "cta_tile_ms": pre_mm["cta_tile_ms"],
         **timed(pre_mm, ("class", "M", "K", "N", "cta_tile", "ctas"))},
        {"name": "grouped_matmul_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "body": pre_gr["body"],
         "launches": sum(wgmma_by_path("grouped_matmul").values()),
         "launches_by_path": wgmma_by_path("grouped_matmul"),
         "forward_bodies_by_path": forward_by_path("grouped_matmul"),
         "max_abs_err": grr["max_abs_err"],
         **timed(pre_gr, ("class", "E", "M", "K", "N", "cta_tile", "ctas"))},
        {"name": "matmul_kstep_round", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": rep_round["body"],
         "launches": sum(tuned["round_launches"].values()),
         "max_abs_err": max(r["max_abs_err"] for r in mmr["rounding"] + grr["rounding"]),
         **timed(rep_round, ("class", "M", "K", "N", "round_k"))},
        {"name": "flash_attention_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126", "body": "mma",
         "launches": sum(r["attention_offset_launches"] for r in paged),
         "max_abs_err": chunk["attention"]["max_abs_err"],
         **{k: chunk["attention"][k] for k in ("device_ms", "library_device_ms")},
         **timed(chunk["attention"], ("B", "Hq", "Hkv", "C", "KV", "D", "q_offset", "ctas"))},
        {"name": "matmul_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": chunk["matmul"]["body"],
         "launches": sum(c for r in paged for key, c in r["chunk_body_launches"].items()
                         if key.startswith("matmul/wgmma/")),
         "max_abs_err": chunk["matmul"]["max_abs_err"],
         **{k: chunk["matmul"][k] for k in ("device_ms", "library_device_ms")},
         **timed(chunk["matmul"], ("class", "M", "K", "N", "cta_tile", "ctas"))},
        *({"name": c, "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:126", "body": "mma",
           "launches": sum(class_by_path(c).values()), "launches_by_path": class_by_path(c),
           "max_abs_err": row["max_abs_err"], "f32_max_abs_err": row["f32_max_abs_err"],
           **{k: row[k] for k in ("device_ms", "library_device_ms")},
           **timed(row, ("B", "Hq", "Hkv", "Sq", "KV", "D", "causal", "ctas"))}
          for c, row in (("flash_attention_bidir", rep_bidir), ("flash_attention_cross", rep_cross))),
        {"name": "flash_attention_narrow", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126", "body": "mma",
         "launches": sum(sum(r["attention_tile_launches"]["grouped_tile_launches"].values())
                         for r in srv),
         "launches_by_path": {"slot": sum(sum(r["attention_tile_launches"]
                                              ["grouped_tile_launches"].values()) for r in srv)},
         "launches_by_tile": dict(sum((collections.Counter(
             r["attention_tile_launches"]["grouped_tile_launches"]) for r in srv),
             collections.Counter())),
         "max_abs_err": rep_narrow["max_abs_err"], "f32_max_abs_err": rep_narrow["f32_max_abs_err"],
         **{k: rep_narrow[k] for k in ("device_ms", "library_device_ms", "tiles")},
         **timed(rep_narrow, ("B", "Hq", "Hkv", "Sq", "KV", "D", "causal", "ctas"))},
    ]
    # K1 writing Z beside Y (the dots remat policy's), at gemma2's GeGLU up
    # projection: its launches are the train phase's dots run's
    rep_z = next(r for r in mmr["z"] if r["name"] == "wgmma")
    kernels.append(
        {"name": "matmul_with_z", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": rep_z["body"],
         "launches": train["dots"]["matmul_z_launches"],
         "launches_by_path": {"train": train["dots"]["matmul_z_launches"]},
         "max_abs_err": max(r["max_abs_err"] for r in mmr["z"]),
         "without_z_ms": rep_z["without_z_ms"], "z_bits_equal": True, "y_bits_unchanged": True,
         **timed(rep_z, ("class", "M", "K", "N", "ctas"))})
    # the slice's backward kernels: K2's at gemma2's local layer (SDPA's
    # forward and backward beside it), K1's dX at the GeGLU up projection
    rep_bwd = next(r for r in train["attention_bwd"]["timed"] if r["name"] == "gemma2_local")
    rep_up = next(r for r in train["matmul_bwd"]["shapes"] if r["name"] == "up")
    kernels += [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:126",
         "launches": train["main"]["attention_bwd_launches"],
         "max_abs_err": train["attention_bwd"]["max_abs_err"],
         "f32_max_abs_err": train["attention_bwd"]["f32_max_abs_err"],
         **{k: rep_bwd[k] for k in ("body", "dq_ctas", "dkv_ctas", "dq_smem", "dkv_smem", "parts",
                                    "held_ms", "library_held_ms", "sdpa_ratio",
                                    "sdpa_held_ratio", "bound_share", "fwd_ms", "fwd_bwd_ms")},
         "body_launches": {"train": train["main"]["attention_bwd_body_launches"],
                           "families": dict(sum((collections.Counter(r["attention_bwd_body_launches"])
                                                 for r in fam["runs"]), collections.Counter()))},
         **timed(rep_bwd, ("B", "Hq", "Hkv", "S", "D", "window", "softcap"))},
        {"name": "matmul_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul_grad.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": rep_up["dx"]["body"],
         "launches": train["main"]["matmul_grad_launches"],
         "max_abs_err": train["matmul_bwd"]["max_abs_err"],
         "max_rel_err": train["matmul_bwd"]["max_rel_err"],
         "shape": {"class": rep_up["class"], "part": "dx",
                   **{k: rep_up["dx"][k] for k in ("M", "K", "N")}},
         **{k: rep_up["dx"][k] for k in GRAD_LINE_FIELDS},
         "dw": rep_up["dw"],
         "parts": {f"{r['name']}_{part}": {k: r[part][k] for k in ("body", *GRAD_LINE_FIELDS)}
                   for r in train["matmul_bwd"]["shapes"] for part in ("dx", "dw")}},
    ]
    # the families' backward kernels: K1g's dX at mixtral's up-GEMM (dW and
    # the down-GEMM beside it), K3's and K4's at their training shapes
    def fam_count(key):   # a backward counter's launches over the families' runs
        return sum(r[key] for r in fam["runs"])

    rep_gbwd = next(r for r in k["grouped_bwd"] if r["class"] == "moe_gemm_silu_glu")
    rep_rwb = next(r for r in k["rwkv6_bwd"] if "ms" in r)
    rep_rgb = next(r for r in k["rglru_bwd"] if "ms" in r)
    for row in kernels:   # K1's and K2's backward also run on the families' path
        counter = {"flash_attention_bwd": "attention_bwd_launches",
                   "matmul_bwd": "matmul_grad_launches"}.get(row["name"])
        if counter:
            row["launches_by_path"] = {"train": train["main"][counter] + train["dots"][counter],
                                       "families": fam_count(counter)}
            row["launches"] = sum(row["launches_by_path"].values())
    next(r for r in kernels if r["name"] == "flash_attention_bwd")["families"] = [
        {f: r[f] for f in ("name", "body", "dq_ctas", "dkv_ctas", "parts", "ms", "held_ms",
                           "plain_ms", "bound_ms", "bound_by", "bound_share", "library_ms",
                           "library_held_ms", "sdpa_ratio", "sdpa_held_ratio", "max_abs_err")}
        for r in k["attention_bwd"]]
    rep_head = next(r for r in k["head_bwd"] if r["name"] == "whisper_head_dw")
    kernels += [
        {"name": "grouped_matmul_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_grad.cu",
         "replaces": "src/repro/kernels/matmul.py:236", "body": rep_gbwd["dx"]["body"],
         "launches": fam_count("grouped_grad_launches"),
         "max_abs_err": max(r["max_abs_err"] for r in k["grouped_bwd"]),
         "max_rel_err": max(r["max_rel_err"] for r in k["grouped_bwd"]),
         "shape": {"class": rep_gbwd["class"], "E": rep_gbwd["E"], "part": "dx",
                   **{f: rep_gbwd["dx"][f] for f in ("M", "K", "N")}},
         **{f: rep_gbwd["dx"][f] for f in GRAD_LINE_FIELDS},
         "dw": rep_gbwd["dw"],
         "down": next(r for r in k["grouped_bwd"] if r["class"] == "moe_gemm")},
        # the gradient launch's mma body with operand modes: whisper's LM head
        {"name": "matmul_bwd_unaligned", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_grad.cu",
         "replaces": "src/repro/kernels/matmul.py:205", "body": rep_head["body"],
         "launches": sum(r["grad_body_launches"].get("matmul/mma/bfloat16", 0) for r in fam["runs"]),
         "max_abs_err": max(r["max_abs_err"] for r in k["head_bwd"] + k["internvl2_head"][1:]),
         "max_rel_err": max(r["max_rel_err"] for r in k["head_bwd"] + k["internvl2_head"][1:]),
         "shape": {"arch": "whisper-medium", "part": "dw", **{f: rep_head[f] for f in ("M", "K", "N")}},
         **{f: rep_head[f] for f in GRAD_LINE_FIELDS},
         "dx": next(r for r in k["head_bwd"] if r["name"] == "whisper_head_dx"),
         # internvl2-26b's head on its training path: the forward (K1,
         # N tile 3), dX and dW
         "internvl2_head": {r["name"].removeprefix("internvl2_head_"): r
                            for r in k["internvl2_head"]}},
        {"name": "rwkv6_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:86",
         "launches": fam_count("rwkv6_bwd_launches"),
         "max_abs_err": max(r["max_abs_err"] for r in k["rwkv6_bwd"]),
         "max_rel_err": max(r["max_rel_err"] for r in k["rwkv6_bwd"]), "fwd_ms": rep_rwb["fwd_ms"],
         **{f: rep_rwb[f] for f in ("kernels_ms", "bound_share", "walk_smem", "smem")},
         **timed(rep_rwb, ("B", "H", "T", "D", "ctas", "cluster"))},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:65",
         "launches": fam_count("rglru_bwd_launches"),
         "max_abs_err": max(r["max_abs_err"] for r in k["rglru_bwd"]),
         "max_rel_err": max(r["max_rel_err"] for r in k["rglru_bwd"]), "fwd_ms": rep_rgb["fwd_ms"],
         **{f: rep_rgb[f] for f in ("device_ms", "held_ms", "bound_share", "resident", "smem")},
         **timed(rep_rgb, ("B", "T", "C", "ctas"))},
    ]
    for row in kernels:   # the families' backward kernels run on their path alone
        if row["name"] in ("grouped_matmul_bwd", "rwkv6_scan_bwd", "rglru_scan_bwd",
                           "matmul_bwd_unaligned"):
            row["launches_by_path"] = {"families": row["launches"]}
    # each kernel's launches per path (slot engine, paged, spec, fleet, train, families, dist)
    for row in kernels:
        if row["name"] in ("matmul", "flash_attention", "rwkv6_scan", "rglru_scan",
                           "grouped_matmul"):
            row["launches_by_path"] = by_path(row["name"])
        elif row["name"] == "matmul_decode":
            row["launches_by_path"] = by_path("matmul", row["body"])
    for row in kernels:   # the backward kernels' launches on the TP path
        counter = next((c for c, name in TP_BWD_COUNTERS.items() if name == row["name"]), None)
        if counter:
            n = sum(r[counter] for r in tp_r["runs"])
            row["launches_by_path"]["tp"] = n
            row["launches"] += n
    # K1's f32 modes (ROADMAP C.13): the row-parallel products' f32 Y on the
    # sharded-serving and TP paths, the column-parallel products' f32 dX on
    # the TP path
    f32_y = next(r for r in mmr["f32"] if r["name"] == "y")
    f32_dx = next(r for r in mmr["f32"] if r["name"] == "dx")

    def f32_by_path(key):
        return {path: n for path, rs in paths.items()
                if (n := sum(r.get(key, 0) for r in rs))}

    for name, source, row, key in (
            ("matmul_f32_out", "matmul.cu", f32_y, "matmul_f32_launches"),
            ("matmul_grad_f32_out", "matmul_grad.cu", f32_dx, "matmul_f32_grad_launches")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": "src/repro/kernels/matmul.py:205", "body": row["body"],
                        "launches": sum(f32_by_path(key).values()),
                        "launches_by_path": f32_by_path(key), "max_abs_err": row["max_abs_err"],
                        "bf16_ms": row["bf16_ms"], "bits_equal_rounded": row["bits_equal_rounded"],
                        **{k: row[k] for k in ("device_ms", "bf16_device_ms") if k in row},
                        **timed(row, ("M", "K", "N"))})
    print(json.dumps({"tuning": tuning}))
    print(json.dumps({"examples": examples}))
    log("done", seconds=time.monotonic() - t_start)
    print(json.dumps({"phase_seconds": {**phase_s, "total": time.monotonic() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
