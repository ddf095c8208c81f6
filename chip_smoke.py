#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build: the card's name, count and power limit, and the nvcc
   build of ``distributed_ml_pytorch_tpu_torch/csrc/*.cu``; then the
   ``-Xptxas -v`` lines (registers, spills) of K2, the tensor-core K4, of
   K5, K6a and K6b, of K8 and of K7, each source on a line of its own;
2. every kernel against its plain PyTorch version on the card, at the shapes
   of the main path, bit-identical: flat_axpy at AlexNet's padded length;
   relu_pool2 forward and backward at AlexNet's three epilogue shapes at
   batch 64 and 1024 (with and without bias, ties forced or not) on the
   vector route, and at an odd C and a misaligned contiguous view on the
   scalar route, each route read from the per-route launch counts; with the
   kernel's, the plain version's and one library call's time (CUDA events,
   the launches queued behind a busy wait so the card runs them back to
   back) and the byte bound at 3.35 TB/s; relu_pool2 per shape cold (input
   sets in turn, twice the L2) and warm at both batches, beside the launch
   floor (a one-element ``add_``) and the host µs of a forward+backward call
   at batch 64;
3. trainer steps of AlexNet(fused_epilogue=True) against the same steps of
   fused_epilogue=False (cuDNN deterministic, full float32) at batch 64 and
   1024: equal losses and parameters, K2 three times a step each way, all on
   the vector route; then a profile window: the float32 trainer's CLI
   (``training.cli --no-distributed``, AlexNet b64) for two steps with
   ``--profile-dir`` (``utils/tracing.TraceWindow`` on ``torch.profiler``):
   the exported trace holds the K2a and K2b CUDA kernels three times a step
   each and one ``annotate_step`` range a step, ``train#0`` and
   ``train#1``;
4. the DownPour path: a parameter server and two workers in one process
   (threads, in-process transport) through ``run_server``/``train_worker``
   with the CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10)
   and ``--chunked-dispatch off`` (one eager step a dispatch) on synthetic
   CIFAR-10; the kernels' launch counts are zeroed just before and read just
   after, every kernel must have run and ``flat_axpy`` once a step; each
   worker's steps/s from its record 5 on (as before phase 15 existed) and
   its steady steps/s over the window phase 15 reads too;
5. the flash-attention kernels (K4 forward, K5 fused backward, K6a split
   dQ and K6b split dK/dV: the tensor-core kernels for bfloat16, the scalar
   ones for float32) against their plain versions on the same inputs, K6b's
   dK and dV also bit for bit against K5's and K6a's dQ bit for bit between
   two launches, at small shapes (float32 causal and not, head_dim 16 in
   both dtypes and bfloat16 non-causal, 32 and 128 in bfloat16, a ragged s
   200, 100 queries over 300 keys), at the LM's per-layer shape (b8 h12
   s2048 d64, bfloat16, causal: a 32-tile key loop) and at one long shape
   (b1 h2 s16384 d64, bfloat16, causal: a 256-tile key loop, the plain
   versions over the whole score plane), within the stated tolerances;
   timed at the LM shape beside the plain versions,
   ``F.scaled_dot_product_attention`` (the pair K6a + K6b beside its
   backward) and the FLOP bound at 989.4 TFLOP/s;
6. the LM path: ``training.train_lm`` with GPT-2-small (vocab 50304, d 768,
   12 heads, 12 layers, d_ff 3072, bfloat16, RoPE, batch 8 x seq 2048) for
   ``LM_STEPS`` steps on one repeated batch, the attention launch counts
   zeroed just before and read just after (K4 and K5 12 per step, K6 none);
   the loss must fall and every parameter stay finite; then one step from
   the trained weights with the default (fused) backward and one with
   ``bwd_impl="split"`` injected, which must agree; the profiled step's
   "K4 flash_fwd" and "K5 flash_bwd_fused" groups must read the tensor-core
   kernels, and the scalar K5 must not run; the fused and the split step
   timed (one warm-up, three steps, ``utils/devtime``) and one split step
   profiled, whose "K6a flash_bwd_dq" and "K6b flash_bwd_dkv" groups must
   show the tensor-core K6a and K6b 12 times each and no scalar one (a
   profile that records no kernel fails the phase); then
   ``train_lm`` and the serving demo with their default widths (8 heads of
   d_model 128: head_dim 16), launching K4/K5 and K8;
7. the decode-attention kernel (K8) against its reference on the same
   inputs: b32 h12 d64 T16 at C 128, 256 and 383 with per-row t (0, 5, 15)
   and ring_base, through strided live-prefix views, at C 8192, with
   bfloat16 and int8 caches, and float32 at a small shape, within the stated
   bounds; then with the keys split over 1, 2, 4 and 8 blocks, forced, on
   the same inputs (rows with no live key among them), each within the bound
   of the reference and of one block; timed cold (input sets in turn, twice
   the L2) beside the reference, ``F.scaled_dot_product_attention`` over a
   pre-concatenated K/V, and the byte bound, at the decode shape and at b1
   with 2,048 live keys and b8 with 256 (each also at every split count);
8. ``generate()`` on GPT-2-small (vocab 50304, d 768, 12 heads, 12 layers,
   d_ff 3072, bfloat16, learned positions, max_len 384) at batch 32, prompt
   128, 256 new tokens, greedy, the blocked path — once with the bfloat16
   cache and once with ``kv_quant`` (each call timed by
   ``bench_all.timed_generate``, the ``decode`` leg's timing): tokens/s, ms
   per decode step, the byte
   roofline share, peak memory, one profiled decode step; K8 launched 12
   times per padded step and the reference never; the first two blocks
   teacher-forced through K8 and through the reference must agree;
9. the serving engine at the same width through the in-process frontend (8
   slots, cache 512, decode block 16, prefill bucket 16): 16 requests,
   prompts of 16-128 tokens, 32-128 new tokens, odd ones sampled (0.8, top-k
   40, top-p 0.95); every stream complete and in vocabulary; TTFT/TPOT
   percentiles, occupancy, K8 launches and the split count of each; the
   engine must pass K8 a live-prefix view, not its 512-row allocation; K8 on
   the engine's own inputs at its longest cache, at every split count,
   within the bound of the reference and timed cold;
10. the conv-epilogue ladder: the bias+relu kernels (K3a forward, K3b
   backward) bit-identical to their plain versions, with and without bias,
   at (4096, 384), at AlexNet's NHWC tail (256, 4, 4, 384), at an odd C
   (1000, 37) and in bfloat16; timed cold beside the plain versions, one
   library call and the byte bound; then ``bench_all.compute_microbench_phase`` (fused
   against unfused ``relu_pool2`` and ``bias_relu`` at batch 256), the K3
   launch counts zeroed just before and read just after;
11. the fused head update (K7) against ``head_update_plain`` on the same
   inputs at GPT-2-small b8 x 2048 (bf16 h2 and logits from a real h2 @ W
   product, float32 lse, random labels, gscale = mask / sum(mask)) and at
   ``HEAD_SMALL``'s ragged shapes (the float32 kernel, the bf16 element
   loads at V 677, the bf16 TMA route at D 64, 768 and 1024 and at N 20),
   from W = 0 and from W, within ``HEAD_TOL``, each case's route read from
   the per-route launch counts; two launches of the TMA route at
   GPT-2-small bit-identical; timed beside the plain version (the default
   formulation), the product alone and the FLOP bound, with peak memory;
12. the restructured-head GPT-2-small step: ``bench_all.lm_phase`` (config
   6's three legs: tokens/s and MFU), then one step each of
   ``make_fused_head_sgd_step`` with ``use_kernel`` False and True and of the
   AD step ``make_fsdp_lm_train_step`` from the same weights: K7 once per
   ``use_kernel=True`` step, by its TMA route, and never otherwise, K4 and
   K5 12 times each;
   equal losses between the two fused steps and updates within
   ``FUSED_HEAD_UPDATE_TOL``; the AD step within ``AD_LOSS_TOL`` and
   ``AD_UPDATE_TOL``; step ms and peak memory of the three, and one
   profiled ``use_kernel=True`` step;
13. config 1's AlexNet legs through ``bench_all.alexnet_phase`` under
   cuDNN's default algorithm choice, K steps a dispatch as the JAX harness
   runs them (a CUDA graph of one step replayed: batch 64 unfused at 100,
   batch 1024 fused and unfused at 20, and batch 1024 as microbatch-256
   accumulation at 20 updates; images/s and the share of the float32
   peak), then one profiled
   fused step each of the DownPour worker at batch 64 (K1 once) and the
   trainer at batch 1024: K2a and K2b 3 times each on the vector route,
   in the profile and in the wrappers' counts, no launch whose kernel the
   profiler lost, device ms by group and the idle gap before each group's
   launches; then
   the batch-1024 fused step timed under cuDNN's default, deterministic and
   benchmark (autotuned) algorithm choices;
14. the trainer family, under deterministic cuDNN: (a) K2 in bfloat16
   bit-identical to its plain versions at AlexNet's three tails at batch 64
   and 1024 (bias or none, ties forced or not) on the 8-channel vector
   route, and at C 36, an odd C and a misaligned view on the scalar route,
   each route read from the per-route bfloat16 counts; timed cold and warm
   beside the plain versions, ``max_pool2d(relu)`` in bfloat16 and the
   halved byte bound; then AlexNet fused in bfloat16 at batch 1024, 5
   steps a dispatch graphed under cuDNN's default algorithms, timed and one
   dispatch profiled (K2's bfloat16 kernels 3 a step), and one graphed
   dispatch of 2 ``grad_accum_b1024`` updates profiled; (b)
   ``make_scan_train_step`` as a CUDA graph at
   AlexNet fused batch 64, 100 steps a dispatch, against 100 eager steps
   from the same weights: equal losses and parameters; each way's wall
   time a step; one graphed dispatch profiled (K2a/K2b 3 a step, no launch
   lost, the idle share) beside ten eager steps; (c) the
   ``grad_accum_b1024`` update graphed (two dispatches of 2) against four
   eager updates: equal; (d) ``train_single`` through ``training/cli.main``
   on synthetic data (bfloat16, 10 steps a dispatch, accumulation 2, adamw,
   cosine, clipping) run to the end under the profiler (K2's bfloat16
   kernels in it, the vector route in the wrappers' counts), then stopped
   after its step-15 checkpoint and resumed with ``--resume``: the final
   checkpoints and the CSV losses equal;
15. the chunked DownPour worker, under deterministic cuDNN in full float32
   (AlexNet fused, batch 64, n_push = n_pull = 10): (a) one worker chunked
   (each run of 1 or 9 local steps one dispatch of a captured CUDA graph)
   against one per step (eager) from the same weights on the same batches,
   60 steps, against a transport that never replies: every push and the
   final parameters bit for bit, one capture for both run lengths; a
   second 60 steps of each timed (wall ms a step); (b) one 9-step run
   of the chunked worker after the capture profiled (``utils/devprof``: K1
   9 times, K2a and K2b 27 times each among the replay's kernels, no launch
   lost; busy ms a step, idle share), and the boundary's parts timed: the
   install of a 9.9 MB central vector and a snapshot plus push; (c) phase
   4's world with ``--chunked-dispatch on --ckpt-dir build/smoke_ps --wal
   --admission``: each worker's loss falls, the server counts the pushes and
   pulls, nothing is quarantined, the wrappers count each worker's two
   warm-up steps and its capture; steady steps/s beside phase 4's; (d) a
   fresh server restores ``build/smoke_ps`` to (c)'s final central vector,
   ``apply_seq`` and version, bit for bit;
16. the DownPour world as processes on the card, under deterministic cuDNN
   in full float32: (a) one server process and two worker processes over
   TCP on a free port, each started from a short inline script that calls
   ``run_ps_process`` (the CLI's entry) and prints one JSON line, with
   phase 15 (c)'s recipe (AlexNet fused, batch 64, lr 0.008, n_push =
   n_pull = 10, 80 steps a worker on synthetic data, ``--chunked-dispatch
   on``) and every plane on: ``--transport native --reliable --wal
   --admission --ckpt-dir build/smoke_ps_mp``. Each worker's loss falls;
   the server's applied pushes equal the workers' pushes sent and acked;
   nothing given up, dropped on the checksum or quarantined; each worker's
   wrappers count its two warm-up steps and one capture (K1 and K2 run in
   its graph); the native library loaded. Each worker's steady steps/s
   over phase 15 (c)'s window beside 15 (c)'s, and its retries, duplicates
   dropped and window-blocked count and seconds, and every rank's final
   timeout per peer; (b) the same world on the plain wire (``--transport
   python``, no ``--reliable``), the same checks without the acks; (e)
   ``--transport native`` without ``--reliable`` and (f) ``--transport
   python --reliable``, each with its world's checks, so that the four part
   the transport's share of the rate from the reliable layer's (they run
   after (b), before (c)); (c) a fresh server restores ``build/smoke_ps_mp`` to
   (a)'s final central vector, ``apply_seq`` and version bit for bit and
   seeds its transport's dedup from the envelopes of (a)'s applies; (d)
   ``bench_all --legs ps`` (config 3: one server and four worker
   processes, then a server and a chunked worker process against single
   mode, then the chunked device cycle, whose record must show one capture
   and K1's three counted launches), its lines printed. The reliable worlds (a) and (f) run on a
   loss-free wire, so any timeout, retransmit or duplicate on any rank
   fails them, and each rank prints the longest a frame waited for its ack
   against the 1 s timeout floor;
17. the sharded DownPour world as processes on the card, under
   deterministic cuDNN in full float32: two shard-server processes and two
   worker processes through ``run_sharded_ps_process`` (``--world-size 4
   --n-servers 2``), with 16 (a)'s recipe (AlexNet fused, batch 64, lr
   0.008, n_push = n_pull = 10, 80 steps a worker on synthetic data,
   ``--transport native --reliable --wal --admission --ckpt-dir
   build/smoke_sharded``); a sharded worker runs one step a dispatch.
   Each worker's loss falls; for each shard, the pushes applied equal the
   workers' pushes sent there and acked; nothing given up, dropped on the
   checksum or quarantined; 0 timeouts, 0 retries and 0 duplicates on every
   link of every rank; each shard holds exactly its range of ``shard_ranges``;
   each worker's wrappers count K1 once a step and K2a/K2b three a step
   (and the final eval's forward): its kernels ran on the per-step path.
   Each worker's steady steps/s over steps 40-79, and over phase 4's
   window beside phase 4's. Then the same world with one shard server
   (``--n-servers 1`` through the same entry, the same checks): what
   sharding itself costs a worker. A fresh pair of shard servers restores
   ``build/smoke_sharded/shard{0,1}`` bit for bit (slices, ``apply_seq``,
   version); then ``bench_all --legs sharded_ps`` and ``--legs
   transport``, their lines printed. The ``kernels`` line's K1 and K2 launches add phase
   17's workers' counts to phase 4's;
18. long context, at GPT-2-small width (bfloat16, RoPE, remat, the loss in
   2048-token chunks): (a) ``bench_all.lm_32k_phase`` (config 6's
   ``gpt2_small_seq32768_train_throughput``, 1 x 32768), where the flash
   size rule keeps the fused backward: K4 twice a layer a step (forward and
   remat recompute) and K5 once, K6a/K6b never; (b) ``training.train_lm``
   at 4 x 32768 for 2 steps, where the rule picks the split backward by
   itself: K6a and K6b once a layer a step, K5 never. In each, one layer's
   attention inputs are captured inside the step, and K4's out and lse and
   the backward kernels' dQ, dK and dV on them are held against the plain
   versions, computed 2048 query rows at a time
   (``ops.attention.flash_plain_rows``), over every query and key of the
   first and the last (b, h), within ATTN_TOL / LSE_TOL; each loss finite
   and falling; each kernel's ms at the long shape beside its bound and its
   launches a step, and beside the library's on the same tensors (SDPA's
   forward for K4, its backward alone for K5 and the K6a + K6b pair),
   tokens/s, MFU and peak memory;
19. the LM trainer's flags at GPT-2-small widths, 4 of its 12 layers
   (``LM_K_LAYERS``), 8 x 2048 (bfloat16, RoPE, remat, the chunked loss): ``train_lm --steps-per-dispatch 4 --steps 8
   --ckpt-dir --ckpt-every 4`` (one captured step replayed) against eight
   eager AD steps on the same batches, with ``bwd_impl="split"`` injected
   (losses and parameters bit for bit) and with the default fused backward
   (the updates within SPLIT_UPDATE_TOL in relative L2, beside the spread
   of two eager runs); one capture a run; checkpoints at 4 and 8; the
   step-4 checkpoint resumed for 4 more steps equals the uninterrupted run
   (bit for bit under split, within SPLIT_UPDATE_TOL fused); the peak memory
   of the graphed run (its private pool included) and of the eager one, and
   each way's tokens/s (the graphed one also from a run of 16 steps without
   checkpoints, whose saves lie inside ``train_lm``'s timed dispatches);
   then ``bench_all --legs steps_to_accuracy,reliability`` in this process,
   printed with 16 (d)'s device-cycle record. The ``kernels`` line's K4-K6b
   launches add phases 18 and 19 to phase 6's, and their ``max_abs_err``
   is the larger of phase 5's and phase 18's;
20. the optimizer and codec plane on the DownPour world, under
   deterministic cuDNN in full float32: (a) phase 16 (a)'s three processes
   (``--transport native --reliable --wal --admission``, 80 chunked steps a
   worker) with ``--compress int8 --combine adasum``: 16 (a)'s checks, and
   every push framed at the int8 size (620,667 floats at AlexNet's
   2,472,266), the encoder's compression ratio (3.983) and no residual
   reset; each worker's steady steps/s and idle share (1 - steps/s x phase
   15 (b)'s busy ms a step) beside 16 (a)'s, the host ms of each encode,
   decode, Adasum and push's handling, the pushes a second offered and
   applied, the server's queue and the margin of the longest ack wait under
   the 1 s timeout floor; a fresh server restores the directory bit for
   bit; (b) phase 17's sharded world (two shard servers,
   two per-step workers) with ``--compress topk --server-opt sgdm
   --server-lr 0.5 --server-momentum 0.5``: 17's checks, every frame to a
   shard of 1,236,133 elements carrying 12,361 pairs, each shard's
   optimizer over exactly its range (2 x 1,236,133 floats of state), and
   each shard's directory (vector, meta, ``ps_opt.npz``) restored into a
   fresh shard server with the slice and m, v and t bit for bit; (c) a
   server and one chunked worker as threads with ``Asynchronous(...,
   compress="int8", delta_pull=True)``, each pull sent once the reply to
   the last is installed: the first pull a full install, every other a
   top-k delta (98,904 floats a reply against 2,472,280 for a full one), no
   base miss, and the worker's final view equal to the server's tracked
   base bit for bit; (d) ``bench_all --legs wire_bytes``, its
   records printed. The ``kernels`` line's K1 and K2 launches add phase
   20's workers' counts.
21. chaos and the elastic membership plane, under deterministic cuDNN in
   full float32: (a) the elastic world as processes through the entry
   points — ``coord.cli --lease 2.0``, two shard ranks (``training.cli
   --mode ps --world-size 5 --n-servers 2 --coord ... --transport python
   --reliable``, started in rank order so the maps go v1, v2) and two
   AlexNet workers on the card (batch 64, lr 0.008, n_push = n_pull = 10,
   2 epochs of 500 steps, one a dispatch); a third worker (2 epochs of 300
   steps, ``--rejoin``) joins once worker 2 reached step 100, and shard
   rank 1 is killed with
   SIGKILL once worker 2 reached step 250 and the joiner step 20. The
   coordinator must find the death by lease expiry: its maps v1 and v2 on
   the joins, v3 on the expiry (one entry, ``[0, 2472266)``, the survivor's)
   and, once the workers have left, v4 empty on the survivor's clean leave;
   every worker's last map v3; the survivor resized once to the whole
   range, awaiting ``[1236133, 2472266)``; one install of it, every other
   worker's counted in ``dup_installs``, with the CRC32 of the installed
   slice the first installer's; on the survivor, pushes applied plus
   ``stale_dropped`` equal to the pushes all workers sent it, per worker and
   per stamped range, none stamped with the final range dropped; 0 timeouts
   and retries on every link between live peers (the links to the killed
   rank printed); each worker's loss falling over its first and last 4
   steps and its K1/K2 counts the per-step path's; images/s a worker
   before, during and after the rebalance, the detection time (the kill to
   the survivor's map v3); (b) the JAX chaos acceptance world
   (``tests/test_chaos.py``: drop 0.10 and dup 0.05 on the three DownPour
   data codes, seed 42, two AlexNet workers against one server, 16 steps
   at batch 16, cadence 4/4) twice on the card and once on the CPU:
   ``ChaosLog.lines()`` byte-identical across all three, both fault kinds
   fired, each final loss within 0.45 of the fault-free run's; (c)
   ``coord.demo.elastic_scenario`` with AlexNet on the card, worker 2 slowed
   by 0.3 s a step and speculation on: one straggler decision (printed),
   and on every shard one speculated tail applied and the victim's late
   one dropped. The ``kernels`` line's K1 and K2 launches add (a)'s
   workers' counts.
22. the durability and health barriers, in one process at AlexNet batch 64
   on the card (two elastic shard servers with a WAL on the reliable wire,
   two workers as threads), each part
   with the kernel counts zeroed just before and read just after its first
   run: (a) ``coord.drill.recovery_drill`` under its default plan, seed 0:
   a snapshot barrier publishes a manifest, both shards crash silently and
   restore from it and their WALs; the manifest validates, each restored
   apply seq is at least the manifest's, WAL records were replayed, acked
   <= applied for every worker and shard, every shard serves pulls again,
   and the chaos log equals a second run's on the card and a run's on the
   CPU byte for byte; MTTR, restore ms and the records replayed printed;
   (b) ``coord.health.health_scenario``, seed 0: every quarantined push
   nacked and none in a WAL, the poisoned worker's lease revoked, at least
   one watchdog rollback with ``RollbackDone`` from both shards, and each
   shard's rolled-back vector equal bit for bit to a fresh
   ``ParameterServer``'s restore of the same checkpoint and WAL capped at
   the manifest's apply seq; the reject rate, nack round trips and
   rollback MTTR printed; (c) ``coord.drill.coordfail_drill(kill_during=
   "snapshot")``, seed 0: epochs 1 then 2, no member evicted, the new
   life's barrier publishes a manifest; the steps lost, MTTR and restore
   ms printed. Every flat_axpy and relu_pool2 launch of the three first
   runs joins the ``kernels`` line. The drills' files live under a
   temporary directory the phase removes.
23. the multi-tenant scheduler plane, in one process at AlexNet batch 64 on
   the card (two elastic shard servers with a WAL, two workers as threads,
   a training and a serving tenant, a node agent), the kernel counts zeroed
   just before each part's first run and read just after: (a)
   ``coord.drill.sched_drill`` under the default drill plan, seed 0: ok
   with no violation and no error, exactly one preempt and one resume, a
   clean ledger audit, WAL records replayed, the resumed shard
   bit-identical to the parked one, acked <= applied for every worker and
   shard, drops in the chaos log, and the chaos log equal to a second run's
   on the card and a run's on the CPU (LeNet: the log is a function of the
   step script) byte for byte; K1 once and K2 three times each way a
   worker step; (b) ``coord.drill.coordfail_drill(kill_during="preempt")``:
   epochs 1 then 2, no member evicted, no parked rank stranded, the parked
   shard resumed bit for bit; (c) the ``sched`` bench leg's serving burst
   (``bench_all._serving_slot_rate``: vocab 128, d 64, 4 slots, 8 requests
   of 24 tokens, float32, head_dim 32) on the card: K8 launched once per
   layer and decode step the engine took and the reference never, K8 held
   to the reference (float32 tolerance of ``DECODE_TOL``) on the inputs of
   its call at the longest cache, and the goodput uplift of (a)'s day
   priced at its rate. One line each: preempt and resume MTTR, held
   pushes, records replayed, the uplift, wall seconds and the kernel
   counts; every launch joins the ``kernels`` line.
24. gray failure and the serving fleet, the kernel counts zeroed just
   before each part's first run and read just after: (a)
   ``coord.drill.gray_drill`` at AlexNet batch 64 on the card, seed 0, one
   process: the contained leg meets the drill's contract (probation and
   quarantine at least once, no eviction, a recovery, no lease expiry of
   the renewing victim, acked <= applied for every worker and shard, the
   resumed shard bit-identical over its whole range), its chaos log equal
   to a second run's on the card and a LeNet run's on the CPU byte for
   byte, K1 once and K2 three times each way a worker step; then the
   unmanaged leg (``contain=False``): no probation, the victim slice's
   goodput beside the contained leg's, the detection latency and the
   containment MTTR; (b) the serving CLI's default model (vocab 512, d 128,
   8 heads, 2 layers, d_ff 256, float32, head_dim 16) as 3
   ``EngineMember``s of 4 slots behind a ``FleetRouter`` on the in-process
   transport: probation (``note_gray``) bends the first request away from
   an engine without removing it; 12 greedy requests, one engine crashed
   mid-stream, every stream finished and token-identical to an
   uninterrupted run of the same requests on one engine, at least one
   KvMigrate handoff, the migration MTTR; a ``FleetAutoscaler`` on the
   coordinator's ``on_scale`` spawns one engine and retires one; K8
   launched exactly once a layer and decode step over every engine and the
   reference never, and held to the reference (float32 ``DECODE_TOL``) on
   a copy of the inputs of its call at the longest cache. One line each;
   every launch joins the ``kernels`` line.
25. the model families, each part with the kernel counts zeroed just
   before it and read just after: (a) ResNet-18 (GroupNorm) on CIFAR
   shapes, five SGD steps (lr 0.001) on one batch in float32 at b64 and in
   bfloat16 at b256, losses finite and falling; then the DownPour world of
   phase 4 with ``--model resnet18`` (two workers × 20 steps at b64, 44.7 MB
   frames): K1 once a worker step, each worker's loss falling, and K1 at
   ResNet-18's padded flat length (11,174,016 floats) bit-identical to
   ``flat_axpy_plain``, timed beside it; (b) ResNet-50 at 224² with 1000
   classes, five steps in float32 at b32 and in bfloat16 at b256, one more
   bf16 step profiled (``RESNET_GROUPS``); (c) the
   Switch-MoE LM at the ``moe`` leg's widths (GPT-2-small, 4 experts top-1,
   capacity 2.0, bfloat16, 8 × 2048), four SGD steps (lr 0.5) on one
   batch: K4 and K5 once a layer and step, the plain attention never, both
   kernels held to their plain versions (``ATTN_TOL``) on one layer's
   tensors captured inside the step, one more step profiled; (d) its
   greedy ``generate()`` in
   float32 (b8, prompt 64, 33 new tokens: two blocks): K8 once a layer and
   decode step, the reference never, every row equal to the plain decode
   path's, K8 within ``DECODE_TOL`` at its longest cache. Each line carries
   step ms, images or tokens a second, peak memory and the card's
   ``nvidia-smi`` name and power limit; the launches join the ``kernels``
   line, and K1's, K4's, K5's and K8's errors its ``max_abs_err``.

26. the device mesh (``runtime/mesh.py``) and the data- and tensor-parallel
   family, each part with the kernel counts zeroed just before it and read
   just after: (a) a one-rank NCCL world in this process: five sync-DP and
   five FSDP steps of the unfused AlexNet at b64 (float32, lr 0.05, cuDNN
   deterministic), each bit-identical to ``training.trainer.
   make_train_step``'s step from the same init; (b) two processes sharing
   the card over gloo (``MESH_RANKS``): sync DP and FSDP at 2 × b32 against
   the one-rank b64 steps within ``MESH_DP_TOL``, FSDP against sync DP within
   it, a local-SGD round of K = 10 (the ranks' parameters identical after
   the average) and the reference p2p demo; ``param_shard_fraction``, each
   rank's peak memory and its ``host_staged`` printed; (c) GPT-2-small
   widths at 4 of its 12 layers (``MESH_LM_LAYERS``, as (d)) in bfloat16 (RoPE off, learned positions), global batch 8 × 2048
   over the two ranks: ``--mode fsdp`` (4 × 2048 a rank) and ``--mode tp``
   (6 of 12 heads, 25,152 of the 50,304 vocabulary rows a rank), three SGD
   steps each (lr 0.5): losses finite and falling, K4 and K5 once a layer
   and step on each rank (K6 by the size rule), the plain attention never,
   K4 and K5 held to their plain versions (``ATTN_TOL``) on the step's own
   local tensors, and the first step's loss within ``MESH_LM_LOSS_RTOL`` of
   the one-rank step's on the same batch; (d) ``generate_tp`` over the two
   ranks, greedy, float32, GPT-2-small widths (b4, prompt 64, 33 new
   tokens): K8 once a layer and decode step on each rank, the reference
   never, every token equal to ``generate()`` on one rank; (e) checkpoints
   of a sharded state on a one-rank NCCL world in this process, at (c)'s
   widths and batch, the attention's split backward injected (K5's dQ sums
   by atomics, whose order differs run to run): ``train_lm --mode fsdp``
   and ``--mode tp`` for 4 steps checkpointed at step 2, against 2 steps
   and a resume from that checkpoint for 2 more: the losses and the step-4
   global trees equal bit for bit; the checkpoint's bytes and the save and restore seconds
   printed. One line each,
   with the card's ``nvidia-smi`` name and power limit; the launches join
   the ``kernels`` line and K4's, K5's errors its ``max_abs_err``.
27. the parallelism family, part 2, at GPT-2-small widths and 4 of its 12
   layers (``PAR_LAYERS``), each part with
   the attention counts zeroed just before it and read just after: first
   the one-rank references (the LM's first loss, bf16, 8 × 2048; the
   float32 one-stage pipeline at 8 × 512, M = 4; the MoE's first loss and
   aux on a one-rank world); then two processes sharing the card over
   gloo: (a) the causal ring (``--mode sp``, ``{data: 1, seq: 2}``), (b)
   Ulysses, both bf16 8 × 2048, (c) GPipe and 1F1B on two float32 stages;
   then four: (c) dp × pp on 2 × 2, (d) dp × ep on 2 × 2 at phase 25's MoE
   widths, (e) fsdp × tp on 2 × 2 (bf16, 8 × 2048). Two steps each: the
   first loss within ``PAR_LOSS_RTOL`` (bf16) or ``PAR_PP_RTOL`` (the
   float32 pipeline, whose 1F1B losses equal GPipe's) of the reference,
   and, for the bfloat16 parts, the first step's gradient of
   ``PAR_GRAD_PARAM`` within ``PAR_GRAD_RTOL`` of the reference's (the first
   loss of a fresh model barely moves with what its layers compute);
   K4 and K5 (or K6a + K6b by the size rule) as many times as the code
   says (the ring's rank 0 one chunk a layer, rank 1 two; a stage a layer
   it holds and microbatch; the others a layer), the plain attention
   never, and on one rank of each part K4 and K5 held to their plain
   versions on the step's own tensors; each rank's step time, peak memory
   and ``host_staged`` printed.
28. the MPMD pipeline plane (``parallel/mpmd.py``, ``coord/stages.py``) at
   GPT-2-small widths (vocabulary 50,257, 12 heads of 64, max_len 1024),
   its depth cut to 8 layers, 2 a stage, on 4 stages that are threads of
   this process on the card, float32, M = 4 microbatches of 2 × 512 tokens,
   six steps (``MPMD_*``): (a) ``MpmdLocal`` against the one-stage step
   on the same batch (the first two losses within ``MPMD_RTOL``); (b) the
   fault-free fleet (``mpmd_scenario``) with the attention counts zeroed
   just before it and read just after: its losses equal (a)'s at
   ``MPMD_RTOL``, K4 ``2·L·M`` a step on each stage before the last (the
   forward and the backward's recompute) and ``L·M`` on the last (its
   fused loss and backward), K5 ``L·M`` a step on each, K6 and the plain
   attention never (the flight recorders add no launch); tokens/s, the
   bubble fraction, the stage checkpoints' bytes an update, and the run's
   device busy time and idle share (``utils/devprof`` around it) printed,
   and the bubble's ``bubble_attribution`` from the run's flight-recorder
   dumps (``analysis/timeline.py``), which ``bench_all.
   check_bubble_attribution`` must accept with its fractions summing to 1
   within ``MPMD_ATTR_TOL``; (c) ``default_mpmd_plan(0)``,
   stage 1 killed at step 3 after a snapshot at step 1: one restart (its
   MTTR printed), every ``(step, mb)`` applied once, nothing discarded, the
   losses (b)'s at ``MPMD_CHAOS_TOL``; (d) the int8 activation codec fault-free, within
   ``MPMD_INT8_RTOL`` of (b), each stage that shipped at least 3x fewer
   floats on the wire; (e) K4 and K5 held to their plain versions
   (``ATTN_TOL``) on one stage's own tensors from (a), and timed; (f)
   ``python -m distributed_ml_pytorch_tpu_torch.coord.cli --mpmd`` exits 0
   at the scenario's default size (the JAX widths: head_dim 8, which the
   float32 kernels take), started as a process of its own with the weights'
   draw while phase 27 runs (``MpmdBackground``). Each part's checkpoints go
   to a temporary directory under ``build/`` that it removes.

Then the ``kernels`` line, the ``nvidia-smi`` name/power line, and last the
result line ``{"ok": true, "device": {...}}``. Without a card, or without
the package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import hashlib
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: seconds after which a hung run dumps its threads' stacks and exits 1
#: (the run must finish within 1200 s, the kernels' build included)
WATCHDOG_S = 1100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
BF16_FLOPS = 989.4e12      # H100 SXM dense bf16 tensor cores, NVIDIA's data sheet
L2_BYTES = 50 * 2**20      # H100 L2 cache
ALEXNET_PADDED = 2_472_320
#: K2's bit-identity cases, (shape, misaligned, route): AlexNet's three
#: relu->pool tails at the DownPour batch and config 1's batch 1024 (vector
#: route), an odd C and a contiguous view one element into its storage
#: (scalar route)
POOL_CASES = ([((b, h, w, c), False, "vector") for b in (64, 1024)
               for h, w, c in ((8, 8, 64), (4, 4, 192), (2, 2, 256))]
              + [((64, 4, 4, 37), False, "scalar"), ((64, 8, 8, 64), True, "scalar")])
#: AlexNet's relu->pool tails (H, W, C), the conv1, conv2 and conv5
#: outputs, timed at the DownPour batch and config 1's batch 1024
POOL_TAILS = ((8, 8, 64), (4, 4, 192), (2, 2, 256))
POOL_BATCHES = (64, 1024)
#: kernel-name substrings grouping an AlexNet step's device time (first
#: match wins): cuDNN's and PyTorch's convolution kernels by pass
ALEXNET_GROUPS = {
    "K2a relu_pool2_fwd": ["relu_pool2_fwd"],
    "K2b relu_pool2_bwd": ["relu_pool2_bwd"],
    "K1 flat_axpy": ["flat_axpy"],
    "conv wgrad": ["wgrad"],
    "conv dgrad": ["dgrad"],
    "conv fwd": ["fprop", "convolve", "conv2d", "implicit_gemm"],
}
WORKER_STEPS = 80
#: a DownPour worker's steady window opens at the first host read of its
#: losses at or after step STEADY_FROM - 1 (see _steady_record)
STEADY_FROM = 10
ATTN_MAIN = (8, 12, 2048, 64)  # GPT-2-small's per-layer attention shape
#: one long causal case: a 256-tile key loop (ATTN_MAIN's is 32 tiles); the
#: plain versions hold its whole (s, s) float32 score plane, 1 GiB a head
ATTN_LONG = (1, 2, 16384, 64)
ATTN_SMALL = [((2, 2, 256, 64), "float32", True), ((2, 2, 256, 64), "float32", False),
              ((2, 2, 256, 16), "float32", False), ((2, 2, 256, 16), "bfloat16", True),
              ((2, 2, 256, 32), "bfloat16", True), ((2, 2, 256, 128), "bfloat16", True),
              ((2, 2, 200, 64), "bfloat16", True), ((2, 2, 200, 64), "bfloat16", False),
              ((2, 2, 256, 16), "bfloat16", False),
              # 100 queries over 300 keys: (b, h, sq, d) and sk
              ((2, 2, 100, 64), "bfloat16", False, 300)]
#: kernel vs plain version on the same inputs, as (atol, rtol) in |kernel -
#: plain| <= atol + rtol * scale elementwise, where scale is the output's
#: absolute product (``attention.flash_error_scales``: P|V|, |dS||K|, ...).
#: float32: the same sums in other orders, and f32 atomics in K5's dQ.
#: bfloat16 (unit roundoff u = 2^-8): kernel and plain version each round p
#: or dS to bfloat16 against other running maxima or after other sums, at
#: most u of each term, so the sums differ by at most 2u of the absolute
#: product; each rounds its output too, at most u of it: 4u = 2^-6 in all.
#: atol 1e-6 is float32 summation noise; where dS = p (dP - delta) cancels
#: (exactly 0 at a query that sees one key) both sides sum dP in order of d,
#: so the noise left there is the same. The lse (float32 in both dtypes) is
#: held against |lse| at LSE_TOL.
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2.0 ** -6)}
LSE_TOL = (1e-5, 1e-6)
GPT2_SMALL = ["--vocab", "50304", "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
              "--d-ff", "3072", "--dtype", "bfloat16", "--pos-encoding", "rope",
              "--batch", "8", "--seq", "2048"]
LM_STEPS = 10
LM_LR = 0.5
#: relative L2 distance allowed between the split- and fused-backward steps'
#: parameter updates: K5 sums dQ with f32 atomics in run-dependent order, the
#: split kernels in a fixed one, and bfloat16 roundings downstream of dQ
#: (dq cast, then every earlier layer's backward) can land one step apart
SPLIT_UPDATE_TOL = 1e-2
#: K8 against its reference, |kernel - reference| <= atol + rtol * scale with
#: scale = ``decode_error_scale`` (P·|V| over the three parts, P·scale_v·|V8|
#: under int8). float32: the JAX test's tolerance. bfloat16 and int8: the
#: bound of ATTN_TOL — the reference rounds each weight p (times scale_v) to
#: bfloat16 before its P·V products and the kernel does not (at most u =
#: 2^-8 of each term), and each rounds its output: 4u = 2^-6 in all.
DECODE_TOL = {"float32": (2e-6, 2e-5), "bfloat16": (1e-6, 2.0 ** -6)}
DECODE_MAIN = (32, 12, 64, 16)  # b, h, head_dim, ring slots at GPT-2-small decode
GPT2_DECODE = dict(vocab_size=50304, d_model=768, n_heads=12, n_layers=12, d_ff=3072)
GEN_BATCH, GEN_PROMPT, GEN_NEW = 32, 128, 256
#: teacher-forced logits, K8 against the reference on the same tokens: the
#: relative L2 distance of the logits. Each attention output may move by 2^-6
#: of its absolute product (DECODE_TOL) at every layer; bfloat16 logits
#: themselves are rounded at 2^-8. Allowed: 2^-5 over the 32 steps.
TEACHER_TOL = 2.0 ** -5
#: kernel-name substrings grouping one decode step's device time
DECODE_GROUPS = {
    "K8 decode_attention": ["decode_attention_kernel"],
    "matmul": ["gemm", "Gemm", "nvjet", "xmma", "cutlass"],
    "layer_norm": ["layer_norm", "LayerNorm"],
    "index/scatter": ["index", "scatter", "gather"],
}
SERVE_REQUESTS = 16

#: K3 at the ladder's bias+relu tail and the other shapes it is held at
BIAS_RELU_SHAPES = [(4096, 384), (256, 4, 4, 384), (1000, 37)]
#: K7 against head_update_plain on the update, |kernel - plain| <= 2^-23 |W|
#: + atol + rtol * lr * (|dl|^T |h|) elementwise. 2^-23 |W| is each side's
#: one float32 rounding of W - lr dW. bfloat16 (u = 2^-8): each side rounds
#: each dl term to bfloat16, and where the two exponentials differ in their
#: last bits the roundings can land one step apart, 2u = 2^-7 of the term;
#: the products are exact in float32 and their sums differ by order, at most
#: (N - 1) 2^-24 of the absolute product (2^-10 at N = 16384): 2^-7 + 2^-10.
#: float32: that summation bound alone, 2^-14 at N = 1000, held at 2^-12.
#: atol 1e-9 is float32 noise for updates that cancel to near zero.
HEAD_TOL = {"bfloat16": (1e-9, 2.0 ** -7 + 2.0 ** -10), "float32": (1e-9, 2.0 ** -12)}
HEAD_LR = 0.5
GPT2_HEAD = (8 * 2048, 768, 50304)  # N, D, V at GPT-2-small b8 x 2048
#: K7's small cases, (N, D, V, dtype): see phase_head_update
HEAD_SMALL = [(1000, 64, 677, "float32"), (1000, 64, 677, "bfloat16"),
              (1000, 64, 680, "bfloat16"), (1000, 768, 680, "bfloat16"),
              (1000, 1024, 680, "bfloat16"), (20, 768, 64, "bfloat16")]
#: relative L2 distance allowed between the parameter updates of the fused
#: head step with K7 and without: the body's gradients differ only by K5's
#: run-dependent f32 dQ atomics (as SPLIT_UPDATE_TOL), the head's by the
#: order of its float32 sums
FUSED_HEAD_UPDATE_TOL = SPLIT_UPDATE_TOL
#: the AD step against the fused one (bf16): the AD loss rounds each row's CE,
#: the masked sum and the quotient to bfloat16 (u = 2^-8 each, 3u) and divides
#: by sum(mask) = 16376 rounded to 16384 in bfloat16 (2^-11); the fused loss
#: is float32 throughout
AD_LOSS_TOL = 3 * 2.0 ** -8 + 2.0 ** -11
#: their updates: the AD step rounds the lm_head gradient and its dlogits to
#: bfloat16 where the fused step keeps float32, scales every gradient by the
#: same 16376/16384, and K5's atomics differ from run to run (1e-2)
AD_UPDATE_TOL = 2.0 ** -5

#: kernel-name substrings grouping one LM step's device time (first match wins)
PROFILE_GROUPS = {
    "K4 flash_fwd": ["flash_fwd_tc_kernel"],
    "K5 flash_bwd_fused": ["flash_bwd_tc_kernel"],
    "K6a flash_bwd_dq": ["flash_bwd_dq_tc_kernel"],
    # the scalar K6a (float32 only; no profiled step runs it)
    "K6a scalar": ["flash_bwd_dq_kernel"],
    "K6b flash_bwd_dkv": ["flash_bwd_dkv_tc_kernel"],
    # the scalar K5 and K6b (float32 only; no profiled step runs them)
    "K5/K6b scalar": ["flash_bwd_kv_kernel"],
    "K7 fused_head": ["head_update"],
    "matmul": ["gemm", "Gemm", "nvjet", "xmma", "cutlass"],
    "softmax_ce": ["softmax", "nll_loss", "cross_entropy"],
    "layer_norm": ["layer_norm", "LayerNorm"],
}


class SmokeFailure(Exception):
    pass


_T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's record also carries ``t_s``, the seconds
    since the script started, so a run's log gives each phase's share."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.monotonic() - _T0, 3)}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls after 5
    warm-up calls, by ``utils.devtime.device_time`` (CUDA events, the calls
    queued behind a busy wait so host overhead does not show). ``fn`` returns
    a tensor on the card."""
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    return device_time(fn, calls=iters, warmup=5).per_call_ms


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------------ phase 1

def phase_device_and_build(torch):
    from distributed_ml_pytorch_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    t0 = time.monotonic()
    _build.load("fused_update")
    _build.load("fused_conv")
    _build.load("attention")
    _build.load("flash_fwd_tc")
    _build.load("flash_bwd_tc")
    _build.load("decode_attention")
    _build.load("bias_relu")
    _build.load("fused_head")
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for ln in _build.build_logs().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device_and_build", "device": name,
          "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi_line(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_build_s": _build.build_seconds,
          "ptxas": ptxas})
    for src in ("fused_conv", "flash_fwd_tc", "flash_bwd_tc", "decode_attention",
                "fused_head"):
        emit({"phase": f"{src}_ptxas", "lines": [
            ln.strip() for ln in _build.build_logs(src).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]})


# ------------------------------------------------------------------ phase 2

def phase_kernels(torch):
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # K1 flat_axpy at AlexNet's padded length, two alphas, bit-identical
    n = ALEXNET_PADDED
    y0 = torch.randn(n, generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    err = 0.0
    for alpha in (1.0, -0.008):
        yk = fu.flat_axpy_cuda(y0.clone(), x, alpha)
        yp = fu.flat_axpy_plain(y0.clone(), x, alpha)
        torch.cuda.synchronize()
        require(torch.equal(yk, yp), f"flat_axpy kernel != plain at alpha={alpha}")
        err = max(err, float((yk - yp).abs().max()))
    # cold: eight operand pairs in turn (158 MB) so no launch finds its
    # operands in the 50 MB L2; warm: one pair, which fits in L2
    pairs = [(y0.clone(), x.clone()) for _ in range(8)]
    turn = [0]

    def cold(fn):
        def call():
            yb, xb = pairs[turn[0] % len(pairs)]
            turn[0] += 1
            return fn(yb, xb)
        return call

    ybuf = y0.clone()
    out["flat_axpy"] = {
        "max_abs_err": err,
        "ms": device_ms(cold(lambda yb, xb: fu.flat_axpy_cuda(yb, xb, 1.0))),
        "plain_ms": device_ms(cold(lambda yb, xb: fu.flat_axpy_plain(yb, xb, 1.0))),
        "library_ms": device_ms(cold(lambda yb, xb: yb.add_(xb, alpha=1.0))),
        "warm_ms": device_ms(lambda: fu.flat_axpy_cuda(ybuf, x, 1.0)),
        "warm_library_ms": device_ms(lambda: ybuf.add_(x, alpha=1.0)),
        "bound_ms": bound_ms(3 * 4 * n),
        "note": f"n={n}: {3 * 4 * n} B; ms/plain_ms/library_ms cold (L2 flushed "
                f"by rotation), warm_* with the operands L2-resident",
    }

    out.update(_relu_pool2_checks(torch, g))
    pool_line = out.pop("pool_line")
    emit({"phase": "kernels_vs_plain", "ok": True, **out, **pool_line})
    return out


def _pool_bytes(shape, elem_bytes: int = 4) -> dict:
    """Bytes K2 must move at NHWC ``shape`` without bias: the forward reads
    x and writes m (a quarter of x); the backward reads x, m and g and
    writes dx."""
    x = elem_bytes * math.prod(shape)
    return {"fwd": x + x // 4, "bwd": 2 * x + 2 * (x // 4)}


def _pool_input_sets(torch, fc, shape, g, dtype=None):
    """``(x, m, g)`` sets at NHWC ``shape`` (float32 unless ``dtype``),
    enough that their x alone is at least twice the L2, so a call that takes
    them in turn reads its inputs from device memory."""
    dtype = dtype or torch.float32
    elem = torch.finfo(dtype).bits // 8
    n = max(2, -(-2 * L2_BYTES // (elem * math.prod(shape))))
    pooled = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    sets = []
    for _ in range(n):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        sets.append((x, fc.relu_pool2_fwd_plain(x),
                     torch.randn(pooled, generator=g, device="cuda").to(dtype)))
    return sets


def _time_pool_shape(torch, fc, shape, g, dtype=None) -> dict:
    """Device ms of K2a/K2b at NHWC ``shape`` (no bias: AlexNet keeps its
    bias in the conv), cold (input sets in turn) and warm (one set,
    L2-resident as right after the producing conv), beside the byte bound,
    the plain versions and ``max_pool2d(relu)``, cold; float32 unless
    ``dtype``."""
    F = torch.nn.functional
    sets = _pool_input_sets(torch, fc, shape, g, dtype)
    x, m, gr = sets[0]
    nbytes = _pool_bytes(shape, x.element_size())
    return {
        "shape": list(shape), "input_sets": len(sets),
        "fwd_ms": device_ms(_cold(sets, lambda xs, ms, gs: fc.relu_pool2_fwd_cuda(xs))),
        "bwd_ms": device_ms(_cold(
            sets, lambda xs, ms, gs: fc.relu_pool2_bwd_cuda(xs, None, ms, gs))),
        "fwd_warm_ms": device_ms(lambda: fc.relu_pool2_fwd_cuda(x)),
        "bwd_warm_ms": device_ms(lambda: fc.relu_pool2_bwd_cuda(x, None, m, gr)),
        "fwd_bound_ms": bound_ms(nbytes["fwd"]), "bwd_bound_ms": bound_ms(nbytes["bwd"]),
        "fwd_plain_ms": device_ms(
            _cold(sets, lambda xs, ms, gs: fc.relu_pool2_fwd_plain(xs)), 20),
        "bwd_plain_ms": device_ms(
            _cold(sets, lambda xs, ms, gs: fc.relu_pool2_bwd_plain(xs, None, ms, gs)), 20),
        # one library call on the channels_last NCHW view, as the model holds it
        "fwd_library_ms": device_ms(_cold(
            sets, lambda xs, ms, gs: F.max_pool2d(F.relu(xs.permute(0, 3, 1, 2)), 2))),
    }


def _host_us(torch, fn, iters: int = 200) -> float:
    """Host µs a call: wall time over ``iters`` calls with one synchronise at
    the end, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def _pool_host_costs(torch, fc, x, g) -> dict:
    """Host and device µs of one ``relu_pool2`` forward+backward at ``x``'s
    shape: through autograd (as a model's step calls it), through the two
    wrappers alone, and the unfused plain chain through autograd."""
    F = torch.nn.functional

    def autograd():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(fc.relu_pool2(v), v, g)[0]

    def wrappers():
        return fc.relu_pool2_bwd_cuda(x, None, fc.relu_pool2_fwd_cuda(x), g)

    def unfused():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(fc.max_pool_2x2(F.relu(v)), v, g)[0]

    out = {"shape": list(x.shape)}
    for name, fn in (("autograd", autograd), ("wrappers", wrappers),
                     ("unfused_autograd", unfused)):
        out[name] = {"host_us": _host_us(torch, fn), "device_us": 1e3 * device_ms(fn)}
    return out


def _relu_pool2_checks(torch, g):
    """K2a/K2b bit-identical to the plain versions at POOL_CASES (bias or
    none, ties forced or not), each on the route the rule names; then timed
    per shape cold and warm at both batches beside the launch floor, and
    the host cost of a forward+backward call at batch 64."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda")
    err = {"fwd": 0.0, "bwd": 0.0}
    held = []
    for shape, misaligned, want in POOL_CASES:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        # forced ties: half-step values repeat inside windows, and windows of
        # negatives all tie at 0 after relu
        xt = torch.round(xr * 2) / 2
        gr = torch.randn((nb, h // 2, w // 2, c), generator=g, device=dev)
        before = dict(fc.launches)
        for xin in (xr, xt):
            if misaligned:  # a contiguous view one element into its storage
                xin = torch.empty(xin.numel() + 1, device=dev)[1:].view(shape).copy_(xin)
            for bias in (None, torch.randn(c, generator=g, device=dev)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                what = f"{shape} misaligned={misaligned} bias={bias is not None}"
                require(torch.equal(mk, mp), f"relu_pool2 fwd kernel != plain at {what}")
                require(torch.equal(dk, dp), f"relu_pool2 bwd kernel != plain at {what}")
                err["fwd"] = max(err["fwd"], float((mk - mp).abs().max()))
                err["bwd"] = max(err["bwd"], float((dk - dp).abs().max()))
        ran = {k: fc.launches[k] - before[k] for k in fc.launches if k.startswith("relu_pool2")}
        require(ran[f"relu_pool2_fwd.{want}"] == 4 and ran[f"relu_pool2_bwd.{want}"] == 4
                and ran["relu_pool2_fwd"] == 4 and ran["relu_pool2_bwd"] == 4,
                f"relu_pool2 at {shape} (misaligned={misaligned}) ran {ran}, not the {want} "
                f"route")
        held.append({"shape": list(shape), "misaligned": misaligned, "route": want})

    # the launch floor: a one-element add_ by the same timer
    one, two = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    floor = device_ms(lambda: one.add_(two))
    rows = {b: [_time_pool_shape(torch, fc, (b, *t), g) for t in POOL_TAILS]
            for b in POOL_BATCHES}
    x = torch.randn((64, *POOL_TAILS[0]), generator=g, device=dev)
    gx = torch.randn((64, 4, 4, POOL_TAILS[0][2]), generator=g, device=dev)
    host = _pool_host_costs(torch, fc, x, gx)

    def total(batch, key):
        return sum(r[key] for r in rows[batch])

    # the kernels line: the batch-1024 sums of the three tails, cold
    measured = {}
    for k, name in (("fwd", "relu_pool2_fwd"), ("bwd", "relu_pool2_bwd")):
        measured[name] = {
            "max_abs_err": err[k], "ms": total(1024, f"{k}_ms"),
            "plain_ms": total(1024, f"{k}_plain_ms"),
            "library_ms": total(1024, "fwd_library_ms") if k == "fwd" else None,
            "bound_ms": total(1024, f"{k}_bound_ms"), "bound_by": "bytes"}
    measured["pool_line"] = {
        "relu_pool2": {
            "held": held, "launch_floor_ms": floor, "host_fwd_bwd_b64": host,
            "b1024_cold_sum_ms": {k: total(1024, f"{k}_ms") for k in ("fwd", "bwd")},
            "b1024_bound_sum_ms": {k: total(1024, f"{k}_bound_ms") for k in ("fwd", "bwd")},
            "b64_warm_sum_ms": {k: total(64, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b64_cold_sum_ms": {k: total(64, f"{k}_ms") for k in ("fwd", "bwd")},
            "note": "kernels-line K2 rows are the batch-1024 cold sums; b64_warm_sum_ms "
                    "continues the batch-64 sums of earlier runs; library: "
                    "max_pool2d(relu) on the channels_last view (cold)"},
        "pool_shapes": rows[64] + rows[1024]}
    return measured


# ------------------------------------------------------------------ phase 3

def phase_trainer(torch, device="cuda", steps=5, batch=64):
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
        to_device,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    full_float32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    x, y, *_ = load_cifar10(synthetic=True, n_train=steps * batch, n_test=16)
    runs = {}
    for fused in (True, False):
        model = get_model("alexnet", fused_epilogue=fused, seed=0, device=device)
        state = create_train_state(model, SGD(0.008))
        step = make_train_step(model, SGD(0.008))
        before = dict(fc.launches)
        losses = [float(step(state, *to_device(x[i * batch:(i + 1) * batch],
                                               y[i * batch:(i + 1) * batch], device))[1])
                  for i in range(steps)]
        runs[fused] = (losses, ravel_model_params(model),
                       {k: fc.launches[k] - before[k] for k in before})
    (lf, pf, kf), (lu, pu, _ku) = runs[True], runs[False]
    bit_equal = lf == lu and torch.equal(pf, pu)
    param_err = float((pf - pu).abs().max())
    loss_err = max(abs(a - b) for a, b in zip(lf, lu))
    emit({"phase": "trainer_fused_vs_unfused", "steps": steps, "batch": batch,
          "losses_fused": lf, "losses_unfused": lu, "bit_equal": bit_equal,
          "max_param_abs_err": param_err, "max_loss_abs_err": loss_err,
          "k2_launches": kf})
    # the kernels reproduce the unfused chain's numbers exactly, so equality
    # is expected; 1e-6 absolute is allowed only for cuDNN picking a
    # different deterministic algorithm between the two models' calls
    require(param_err <= 1e-6 and loss_err <= 1e-6,
            f"fused and unfused trainer steps disagree: params {param_err}, loss {loss_err}")
    if torch.device(device).type == "cuda":
        require(all(kf[f"relu_pool2_{d}{route}"] == 3 * steps
                    for d in ("fwd", "bwd") for route in ("", ".vector")),
                f"fused trainer steps launched the K2 kernels {kf} times, not 3 a step "
                f"each on the vector route")


#: phase 3's profile window: two float32 AlexNet b64 steps of the trainer's CLI
PROFILE_STEPS = 2


def phase_profile_window(torch, device="cuda", steps=PROFILE_STEPS, batch=64):
    """Phase 3's profile window: ``training.cli --no-distributed`` for
    ``steps`` steps inside ``--profile-dir``; the exported trace's K2 kernels
    and ``annotate_step`` ranges counted."""
    import contextlib
    import io
    import shutil

    from distributed_ml_pytorch_tpu_torch.training import cli

    prof = os.path.join(ROOT, "build", "smoke_profile")
    shutil.rmtree(prof, ignore_errors=True)
    argv = ["--no-distributed", "--backend", device, "--model", "alexnet", "--synthetic-data",
            "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "64",
            "--batch-size", str(batch), "--epochs", "1", "--log-interval", "1000",
            "--log-dir", os.path.join(ROOT, "build", "smoke_runs"), "--profile-dir", prof,
            "--profile-start", "0", "--profile-steps", str(steps)]
    t0 = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # the CLI's per-class report
        rc = cli.main(argv)
    wall = time.monotonic() - t0
    require(rc == 0 and f"wrote profiler trace to {prof}" in out.getvalue(),
            f"the profiled trainer exited {rc}: {out.getvalue()[-1500:]}")
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k2 = {d: sum(f"relu_pool2_{d}" in k for k in kernels) for d in ("fwd", "bwd")}
    # the host's ranges (on the card the trace also mirrors each on the GPU)
    ranges = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("train#"))
    line = {"phase": "trainer_profile_window", "steps": steps, "batch": batch,
            "trace": os.path.relpath(os.path.join(prof, name), ROOT),
            "trace_bytes": os.path.getsize(os.path.join(prof, name)),
            "kernel_events": len(kernels), "k2_kernel_events": k2, "step_ranges": ranges,
            "wall_s": wall}
    if torch.device(device).type == "cuda":
        require(k2 == {"fwd": 3 * steps, "bwd": 3 * steps},
                f"the profile window holds the K2 kernels {k2} times, not 3 a step each")
    require(ranges == [f"train#{i}" for i in range(steps)],
            f"the profile window's annotate_step ranges are {ranges}")
    emit({**line, "ok": True})
    return line


# ------------------------------------------------------------------ phase 4

def _downpour_world(torch, argv, device="cuda", steps=WORKER_STEPS, batch=64, steady=True):
    """A parameter server and two workers as threads of this process on the
    in-process transport, through ``run_server``/``train_worker`` with the
    CLI defaults (AlexNet, batch 64, lr 0.008, n_push = n_pull = 10) plus
    ``argv``, on synthetic CIFAR-10; the kernels' launch counts are zeroed
    just before and read just after. Returns ``(server, per_worker,
    launches, wall_s, records)``; a worker's steady rate runs from its
    record :func:`_steady_record` to its last (``steady=False``: a run too
    short for that window; ``per_worker`` then holds its steps and
    losses)."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    args = build_parser().parse_args([
        "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
        "--batch-size", str(batch), "--log-interval", str(10 * steps),
        "--worker-timeout", "0", "--log-dir", os.path.join(ROOT, "build", "smoke_runs"),
        *argv])
    world = InProcessTransport.create_world(3)
    results, errors = {}, []

    def guard(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    fu.launches = 0
    for k in fc.launches:
        fc.launches[k] = 0
    t0 = time.monotonic()
    # daemon threads: a hung world fails the run below instead of keeping
    # the process alive
    server = threading.Thread(target=guard, daemon=True, args=(
        "server", lambda: tps.run_server(args, world[0])))
    workers = [threading.Thread(target=guard, daemon=True, args=(
        r, lambda r=r: tps.train_worker(args, world[r], device=device))) for r in (1, 2)]
    server.start()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=600)
    server.join(timeout=60)
    wall = time.monotonic() - t0
    launches = {"flat_axpy": fu.launches, **fc.launches}
    require(not errors, "; ".join(errors))
    require(not server.is_alive() and not any(t.is_alive() for t in workers),
            "the DownPour world did not shut down")
    per_worker = {}
    s = _steady_record(steps) if steady else None
    for r in (1, 2):
        _model, logger = results[r]
        recs = logger.records
        losses = [rec["training_loss"] for rec in recs]
        if s is None:
            per_worker[r] = {"steps": len(recs), "losses": losses}
            continue
        rate = (len(recs) - 1 - s) / (recs[-1]["timestamp"]
                                      - recs[s]["timestamp"]).total_seconds()
        per_worker[r] = {"steps": len(recs), "early_loss": sum(losses[:10]) / 10,
                         "late_loss": sum(losses[-10:]) / 10, "steady_from_step": s + 1,
                         "steady_steps_per_s": rate, "steady_images_per_s": rate * batch}
    records = {r: results[r][1].records for r in (1, 2)}
    return results["server"], per_worker, launches, wall, records


def _steady_record(steps):
    """The record that opens a DownPour worker's steady window, the same in
    both dispatch modes: the last of the chunked worker's first loss read
    (every ``LOSS_FLUSH_DISPATCHES`` dispatches) that ends at or after step
    ``STEADY_FROM - 1``. A per-step record and the last record of each read
    are logged just after the host read its step's loss, so the window runs
    between two moments at which the card had finished every step before
    them; nothing in the workers is patched or synchronised for it."""
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps

    k = tps.LOSS_FLUSH_DISPATCHES
    ends = [g + n for g, n in tps.downpour_chunk_schedule(10, 10, 0, steps)[k - 1::k]]
    s = next((e for e in ends if e >= STEADY_FROM), steps) - 1
    require(s < steps - 1, f"no steady window in {steps} steps")
    return s


def phase_downpour(torch, device="cuda", steps=WORKER_STEPS, batch=64):
    """Phase 4: the per-step DownPour world (``--chunked-dispatch off``)."""
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    srv, per_worker, launches, wall, records = _downpour_world(
        torch, ["--chunked-dispatch", "off"], device, steps, batch)
    for r, recs in records.items():
        # the per-step rate as it was read before the steady window existed
        # (every record here is a host read): from record 5 to the last
        span = (recs[-1]["timestamp"] - recs[5]["timestamp"]).total_seconds()
        sps = (len(recs) - 6) / span
        per_worker[r].update(steps_per_s=sps, images_per_s=sps * batch)
    counts = {c.name: n for c, n in srv.message_counts.items() if n}
    emit({"phase": "downpour_world", "workers": 2, "batch": batch, "wall_s": wall,
          "dispatch": "per-step", "per_worker": per_worker, "server_messages": counts,
          "central_finite": bool(__import__("numpy").isfinite(srv.central).all()),
          "launches": launches})
    total_steps = sum(w["steps"] for w in per_worker.values())
    require(all(w["steps"] == steps for w in per_worker.values()), "workers took too few steps")
    require(srv.message_counts[MessageCode.GradientUpdate] >= 2 * (steps // 10),
            "server counted too few GradientUpdates")
    require(srv.message_counts[MessageCode.ParameterRequest] >= 2 * (steps // 10),
            "server counted too few ParameterRequests")
    require(__import__("numpy").isfinite(srv.central).all(), "central vector not finite")
    for r, w in per_worker.items():
        require(w["late_loss"] < w["early_loss"], f"worker {r} loss did not fall: {w}")
    if torch.device(device).type == "cuda":
        # one launch a step: valid for the per-step path only (a graph's
        # replays pass no wrapper)
        require(launches["flat_axpy"] == total_steps,
                f"flat_axpy launched {launches['flat_axpy']} times for {total_steps} steps")
        require(launches["relu_pool2_fwd"] > 0 and launches["relu_pool2_bwd"] > 0,
                f"relu_pool2 kernels not launched on the main path: {launches}")
    return launches, per_worker


# ------------------------------------------------------------------ phase 5

def _err(torch, got, want, scale, tol):
    """(max abs error, max of error / scale, within atol + rtol * scale)."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    ok = bool((diff <= atol + rtol * scale).all())
    return float(diff.max()), float((diff / scale.clamp_min(1e-30)).max()), ok


def _attn_inputs(torch, shape, dtype, g, sk=None):
    b, h, s, d = shape
    mk = lambda n: torch.randn((b * h, n, d), generator=g, device="cuda").to(dtype)
    return mk(s), mk(sk or s), mk(sk or s), mk(s)


def _attn_check(torch, at, shape, dtype_name, causal, g, sk=None):
    """Every kernel against its plain version on one input set (``sk`` keys,
    by default as many as queries); returns ``{kernel: {tensor: (max_abs,
    max error / scale)}}`` and raises on a miss, naming every miss."""
    dtype = getattr(torch, dtype_name)
    tol = ATTN_TOL[dtype_name]
    q, k, v, do = _attn_inputs(torch, shape, dtype, g, sk)
    out_k, lse_k = at.flash_fwd_cuda(q, k, v, causal)
    out_p, lse_p = at.flash_fwd_plain(q, k, v, causal)
    # the backward kernels get the plain forward's lse and delta, so each
    # kernel's error is its own
    delta = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, causal)
    fused = at.flash_bwd_fused_cuda(*args)
    dq_s = at.flash_bwd_dq_cuda(*args)
    dq_again = at.flash_bwd_dq_cuda(*args)
    dk_s, dv_s = at.flash_bwd_dkv_cuda(*args)
    dq_p, dk_p, dv_p = at.flash_bwd_fused_plain(*args)
    sc = at.flash_error_scales(*args)
    torch.cuda.synchronize()
    checks = {
        "flash_fwd": {"out": (out_k, out_p, sc["out"], tol),
                      "lse": (lse_k, lse_p, lse_p.abs(), LSE_TOL)},
        "flash_bwd_fused": {"dq": (fused[0], dq_p, sc["dq"], tol),
                            "dk": (fused[1], dk_p, sc["dk"], tol),
                            "dv": (fused[2], dv_p, sc["dv"], tol)},
        "flash_bwd_dq": {"dq": (dq_s, dq_p, sc["dq"], tol)},
        "flash_bwd_dkv": {"dk": (dk_s, dk_p, sc["dk"], tol), "dv": (dv_s, dv_p, sc["dv"], tol)},
    }
    errs, misses = {}, []
    for kern, tensors in checks.items():
        errs[kern] = {}
        for name, (got, want, scale, t) in tensors.items():
            require(bool(torch.isfinite(got.float()).all()),
                    f"{kern} {name} not finite at {shape} {dtype_name} causal={causal}")
            mx, rel, ok = _err(torch, got, want, scale, t)
            errs[kern][name] = (mx, rel)
            if not ok:
                misses.append(f"{kern} {name}: max abs err {mx}, max err / scale {rel}, "
                              f"(atol, rtol) {t}")
    require(not misses, f"kernel != plain at {shape} {dtype_name} causal={causal}: "
                        f"{'; '.join(misses)}")
    # K6b is K5 without dQ: the same dK and dV, bit for bit
    require(torch.equal(dk_s, fused[1]) and torch.equal(dv_s, fused[2]),
            f"K6b's dK/dV differ from K5's at {shape} {dtype_name} causal={causal}: max "
            f"{float((dk_s.float() - fused[1].float()).abs().max())} / "
            f"{float((dv_s.float() - fused[2].float()).abs().max())}")
    # K6a keeps dQ in registers, with no atomics: the same bits every launch
    require(torch.equal(dq_s, dq_again),
            f"K6a's dQ differs between two launches at {shape} {dtype_name} causal={causal}")
    return errs, (q, k, v, do, lse_p, delta)


def _attn_bytes(shape, dtype_bytes, kern):
    """Bytes each kernel must move once: its tensor inputs and outputs."""
    b, h, s, d = shape
    t = b * h * s * d * dtype_bytes  # one (b*h, s, d) tensor
    r = b * h * s * 4                # one (b*h, s) f32 row vector
    return {"flash_fwd": 4 * t + r,                 # q, k, v -> out, lse
            "flash_bwd_fused": 7 * t + 2 * r,       # q, k, v, do, lse, delta -> dq, dk, dv
            "flash_bwd_dq": 5 * t + 2 * r,          # ... -> dq
            "flash_bwd_dkv": 6 * t + 2 * r}[kern]   # ... -> dk, dv


def phase_attention(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.utils.flops import flash_attention_train_flops

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {}
    for shape, dtype_name, causal, *sk in ATTN_SMALL:
        errs, _ = _attn_check(torch, at, shape, dtype_name, causal, g, *sk)
        cases[f"{shape}{f' sk={sk[0]}' if sk else ''} {dtype_name} causal={causal}"] = errs
    t0 = time.monotonic()
    errs, long_args = _attn_check(torch, at, ATTN_LONG, "bfloat16", True, g)
    long_case = {"shape": ATTN_LONG, "key_tiles": ATTN_LONG[2] // 64,
                 "check_wall_s": time.monotonic() - t0,
                 "k6a_ms": device_ms(lambda: at.flash_bwd_dq_cuda(*long_args, True), 10)}
    del long_args
    cases[f"{ATTN_LONG} bfloat16 causal=True"] = errs
    errs, (q, k, v, do, lse, delta) = _attn_check(torch, at, ATTN_MAIN, "bfloat16", True, g)
    cases[f"{ATTN_MAIN} bfloat16 causal=True"] = errs

    b, h, s, d = ATTN_MAIN
    args = (q, k, v, do, lse, delta, True)
    # one product over the causal score plane, from the ported FLOP count
    # (the fused train step's attention is 7 such products)
    unit = flash_attention_train_flops(b, h, s, d, 1, causal=True, bwd_impl="fused") / 7
    products = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
    iters = 10
    timed = {
        "flash_fwd": lambda: at.flash_fwd_cuda(q, k, v, True),
        "flash_bwd_fused": lambda: at.flash_bwd_fused_cuda(*args),
        "flash_bwd_dq": lambda: at.flash_bwd_dq_cuda(*args),
        "flash_bwd_dkv": lambda: at.flash_bwd_dkv_cuda(*args),
    }
    plain = {
        "flash_fwd": lambda: at.flash_fwd_plain(q, k, v, True),
        "flash_bwd_fused": lambda: at.flash_bwd_fused_plain(*args),
        "flash_bwd_dq": lambda: at.flash_bwd_split_plain(*args),
        "flash_bwd_dkv": lambda: at.flash_bwd_split_plain(*args),
    }
    # the library yardstick: SDPA on (b, h, s, d), forward alone and its
    # backward alone (retained graph), and the two together
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), do4)

    sdpa = {
        "fwd": device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters),
        "bwd": device_ms(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do4, retain_graph=True), iters),
        "fwd_bwd": device_ms(sdpa_fwd_bwd, iters),
    }
    out = {}
    for kern in timed:
        flop_ms = products[kern] * unit / BF16_FLOPS * 1e3
        byte_ms = bound_ms(_attn_bytes(ATTN_MAIN, 2, kern))
        out[kern] = {
            "max_abs_err": max(e[0] for c in cases.values() for e in c[kern].values()),
            "ms": device_ms(timed[kern], iters),
            "plain_ms": device_ms(plain[kern], 3),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": {"flash_fwd": sdpa["fwd"], "flash_bwd_fused": sdpa["bwd"]}.get(kern),
            "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        }
    pair_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    emit({"phase": "attention_vs_plain", "ok": True, "tolerance": ATTN_TOL,
          "k6b_dkv_bit_identical_to_k5": True, "k6a_dq_bit_identical_across_launches": True,
          "lse_tolerance": LSE_TOL, "cases": cases, "long_case": long_case,
          "sdpa_ms": sdpa, "main_shape": ATTN_MAIN,
          "k4_over_sdpa_fwd": out["flash_fwd"]["ms"] / sdpa["fwd"],
          "k4_bound_share": out["flash_fwd"]["bound_ms"] / out["flash_fwd"]["ms"],
          "k5_over_sdpa_bwd": out["flash_bwd_fused"]["ms"] / sdpa["bwd"],
          "k5_bound_share": out["flash_bwd_fused"]["bound_ms"] / out["flash_bwd_fused"]["ms"],
          "k6a_bound_share": out["flash_bwd_dq"]["bound_ms"] / out["flash_bwd_dq"]["ms"],
          "k6b_bound_share": out["flash_bwd_dkv"]["bound_ms"] / out["flash_bwd_dkv"]["ms"],
          # the split pair computes what SDPA's backward computes (dQ, dK, dV)
          "k6_pair_ms": pair_ms, "k6_pair_over_sdpa_bwd": pair_ms / sdpa["bwd"],
          "timed": {k: {kk: vv for kk, vv in v.items() if kk != "max_abs_err"}
                    for k, v in out.items()}})
    return out


# ------------------------------------------------------------------ phase 6

def _zero_attention_launches(at):
    for name in at.launches:
        at.launches[name] = 0


def phase_lm(torch, steps=LM_STEPS):
    import functools

    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time
    from distributed_ml_pytorch_tpu_torch.utils.flops import (
        device_peak_flops,
        lm_train_flops_6nd,
    )

    args = train_lm.parse_args([*GPT2_SMALL, "--steps", str(steps), "--lr", str(LM_LR),
                                "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    _zero_attention_launches(at)
    t0 = time.monotonic()
    res = train_lm.run(args)
    wall = time.monotonic() - t0
    launches = dict(at.launches)
    model = res.state.model
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    n_layers, heads = args.n_layers, args.n_heads
    step_s = res.steady_s / (steps - 1)
    n_matmul = sum(m.weight.numel() for m in model.modules() if isinstance(m, Dense))
    flops = lm_train_flops_6nd(n_matmul, args.batch, args.seq, heads, args.d_model // heads,
                               n_layers)
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    main = {"steps": steps, "losses": res.losses, "params_finite": finite,
            "steps_per_s": 1.0 / step_s, "tokens_per_s": res.tokens_per_s,
            "step_ms": step_s * 1e3, "flops_per_step": flops, "matmul_params": n_matmul,
            "mfu_bf16": flops / step_s / peak if peak else None,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall,
            "launches": launches}
    require(res.losses[-1] < res.losses[0], f"LM loss did not fall: {res.losses}")
    require(finite, "LM parameters not finite after training")
    require(launches["flash_fwd"] == n_layers * steps
            and launches["flash_bwd_fused"] == n_layers * steps,
            f"K4/K5 launched {launches} times for {steps} steps of {n_layers} layers")
    require(launches["flash_bwd_dq"] == 0 and launches["flash_bwd_dkv"] == 0,
            f"the split backward ran on the fused path: {launches}")

    # where one more step's time goes on the card (torch.profiler)
    main["profile"] = kernel_breakdown(
        lambda: res.step_fn(res.state, res.tokens, res.targets), PROFILE_GROUPS)
    require("group_ms" in main["profile"],
            f"the profiled LM step recorded no kernel: {main['profile']}")
    groups = main["profile"]["group_ms"]
    require(groups["K4 flash_fwd"] > 0,
            f"the profiled LM step shows no tensor-core K4: {main['profile']}")
    require(groups["K5 flash_bwd_fused"] > 0 and groups["K5/K6b scalar"] == 0,
            f"the profiled LM step's K5 is not the tensor-core kernel: {main['profile']}")

    # one step from the trained weights, fused and then split; the forward is
    # the same kernel on the same weights, so the losses must be equal
    params = list(model.parameters())
    w0 = [p.detach().clone() for p in params]
    _zero_attention_launches(at)
    _state, loss_f = res.step_fn(res.state, res.tokens, res.targets)
    upd_f = [p.detach() - w for p, w in zip(params, w0)]
    with torch.no_grad():
        for p, w in zip(params, w0):
            p.copy_(w)
    model.set_attn_fn(functools.partial(at.flash_attention, causal=True, bwd_impl="split"))
    _zero_attention_launches(at)
    _state, loss_s = res.step_fn(res.state, res.tokens, res.targets)
    split_launches = dict(at.launches)
    model.set_attn_fn(None)
    upd_s = [p.detach() - w for p, w in zip(params, w0)]
    diff = max(float((a - b).abs().max()) for a, b in zip(upd_s, upd_f))
    scale = max(float(a.abs().max()) for a in upd_f)
    num = sum(float(((a - b).float() ** 2).sum()) for a, b in zip(upd_s, upd_f)) ** 0.5
    den = sum(float((a.float() ** 2).sum()) for a in upd_f) ** 0.5
    split = {"loss_fused": float(loss_f), "loss_split": float(loss_s),
             "max_abs_update_diff": diff, "max_abs_update": scale,
             "rel_update_diff_l2": num / den, "launches": split_launches}

    # both steps timed as the AD step is (one warm-up, three steps, device
    # time), then one split step profiled: K6a and K6b by kernel name
    def one_step():
        return res.step_fn(res.state, res.tokens, res.targets)[1]

    split["fused_step_ms"] = device_time(one_step, calls=3, warmup=1).per_call_ms
    model.set_attn_fn(functools.partial(at.flash_attention, causal=True, bwd_impl="split"))
    split["split_step_ms"] = device_time(one_step, calls=3, warmup=1).per_call_ms
    split["profile"] = kernel_breakdown(one_step, PROFILE_GROUPS)
    model.set_attn_fn(None)
    emit({"phase": "lm_gpt2_small", "config": GPT2_SMALL, "lr": LM_LR, **main,
          "split_step": split})
    require(float(loss_f) == float(loss_s),
            f"split-backward step loss {float(loss_s)} != fused {float(loss_f)}")
    require(split_launches["flash_bwd_dq"] == n_layers and
            split_launches["flash_bwd_dkv"] == n_layers and
            split_launches["flash_bwd_fused"] == 0,
            f"the split step launched {split_launches}")
    require(num / den <= SPLIT_UPDATE_TOL,
            f"split and fused updates differ: relative L2 {num / den} > {SPLIT_UPDATE_TOL}")
    require("group_launches" in split["profile"],
            f"the profiled split step recorded no kernel: {split['profile']}")
    calls = split["profile"]["group_launches"]
    require(calls["K6b flash_bwd_dkv"] == n_layers and calls["K6a flash_bwd_dq"] == n_layers
            and calls["K5/K6b scalar"] == 0 and calls["K6a scalar"] == 0
            and calls["K5 flash_bwd_fused"] == 0,
            f"the profiled split step's backward kernels: {calls}")
    return launches, split_launches


def phase_default_widths(torch):
    """``train_lm`` and the serving demo with no width flags: the JAX
    defaults, d_model 128 in 8 heads (head_dim 16), float32."""
    import contextlib
    import io

    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    args = train_lm.parse_args(["--steps", "3"])
    _zero_attention_launches(at)
    res = train_lm.run(args)
    launches = dict(at.launches)
    da.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = serving_cli.main(["--demo", "4"])
    k8 = da.launches
    emit({"phase": "default_widths", "d_model": args.d_model, "n_heads": args.n_heads,
          "head_dim": args.d_model // args.n_heads, "dtype": args.dtype,
          "train_lm_losses": res.losses, "train_lm_launches": launches,
          "serving_demo_rc": rc, "serving_k8_launches": k8})
    require(all(math.isfinite(x) for x in res.losses),
            f"default-width train_lm losses not finite: {res.losses}")
    require(launches["flash_fwd"] == args.n_layers * 3
            and launches["flash_bwd_fused"] == args.n_layers * 3,
            f"default-width train_lm launched {launches}")
    require(rc == 0 and "serving demo complete" in text.getvalue() and k8 > 0,
            f"default-width serving demo: rc {rc}, K8 launches {k8}")


# ------------------------------------------------------------------ phase 7

def _decode_case(torch, g, b, h, C, T, d, dtype, quant, t, ring_base, pad=0):
    """K8's inputs on the card; the big cache is a live-prefix view of a
    ``C + pad`` allocation."""
    from distributed_ml_pytorch_tpu_torch.models.transformer import quantize_kv

    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q, kn, vn = (mk(b, h, 1, d).to(dtype) for _ in range(3))
    rk, rv = (mk(b, h, T, d).to(dtype) for _ in range(2))
    bk, bv = mk(b, h, C + pad, d), mk(b, h, C + pad, d)
    sk = sv = None
    if quant:
        (bk, sk), (bv, sv) = quantize_kv(bk), quantize_kv(bv)
        sk, sv = sk[:, :, :C], sv[:, :, :C]
    else:
        bk, bv = bk.to(dtype), bv.to(dtype)
    tt = torch.as_tensor(t, dtype=torch.int32, device="cuda")
    rb = torch.as_tensor(ring_base, dtype=torch.int32, device="cuda")
    return (q, kn, vn, bk[:, :, :C], bv[:, :, :C], rk, rv, tt, rb, sk, sv)


def _cold(sets, fn):
    """``fn`` over the input sets in turn, one set a call (for timing cold:
    the sets together hold more than the L2)."""
    turn = [0]

    def call():
        turn[0] += 1
        return fn(*sets[turn[0] % len(sets)])
    return call


def _decode_bytes(args):
    """Bytes K8 must move for these inputs: q, k_new, v_new and out, the
    live keys of K and V (and their scales), the filled ring slots."""
    q, kn, vn, bk, bv, rk, rv, t, rb, sk, _sv = args
    b, h, _, d = q.shape
    live = int(rb.clamp(0, bk.shape[2]).expand(b).sum())
    fill = int(t.clamp(0, rk.shape[2]).expand(b).sum())
    per_key = 2 * d * bk.element_size() + (8 if sk is not None else 0)
    return (4 * b * h * d * q.element_size() + h * live * per_key
            + h * fill * 2 * d * rk.element_size())


def phase_decode_attention(torch):
    import functools

    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, d, T = DECODE_MAIN
    cases = []
    for name, quant in (("bfloat16", False), ("int8", True)):
        for C in (128, 256, 383):
            for t in (0, 5, 15):
                rb = torch.randint(0, C + 1, (b,), generator=g, device="cuda")
                cases.append((f"{name} C={C} t={t} per-row ring_base",
                              (b, h, C, T, d, torch.bfloat16, quant, t, rb, 16)))
        cases.append((f"{name} C=8192", (b, h, 8192, T, d, torch.bfloat16, quant, 7,
                                         8192, 0)))
    for quant in (False, True):
        cases.append((f"float32 small quant={quant}",
                      (2, 2, 40, T, 64, torch.float32, quant, [0, 9], [40, 17], 8)))
    results, misses, worst = {}, [], 0.0
    for label, (cb, ch, C, cT, cd, dtype, quant, t, rb, pad) in cases:
        args = _decode_case(torch, g, cb, ch, C, cT, cd, dtype, quant, t, rb, pad)
        got = da.decode_attention_cuda(*args)
        want = da.decode_attention_reference(*args)
        scale = da.decode_error_scale(*args)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got.float()).all()), f"K8 not finite: {label}")
        tol = DECODE_TOL["float32" if dtype == torch.float32 else "bfloat16"]
        mx, rel, ok = _err(torch, got, want, scale, tol)
        results[label] = {"max_abs_err": mx, "max_err_over_scale": rel}
        worst = max(worst, mx)
        if not ok:
            misses.append(f"{label}: max abs {mx}, max err / scale {rel}, (atol, rtol) {tol}")
    require(not misses, "K8 != reference: " + "; ".join(misses))

    # the keys split over 1, 2, 4 and 8 blocks, forced, on the same inputs:
    # each within the bound of the reference and of one block per (b, h);
    # every fourth row has no live key in the big cache (ring_base 0)
    splits = {}
    for label, (sb, C, quant) in (("b32 C=383 bfloat16", (b, 383, False)),
                                  ("b32 C=383 int8", (b, 383, True)),
                                  ("b8 C=256 bfloat16", (8, 256, False)),
                                  ("b1 C=2048 bfloat16", (1, 2048, False)),
                                  ("b1 C=2048 int8", (1, 2048, True))):
        rb = torch.randint(0, C + 1, (sb,), generator=g, device="cuda")
        rb[::4] = 0
        t = torch.randint(0, T + 1, (sb,), generator=g, device="cuda")
        args = _decode_case(torch, g, sb, h, C, T, d, torch.bfloat16, quant, t, rb, 16)
        want = da.decode_attention_reference(*args)
        scale = da.decode_error_scale(*args)
        one = da.decode_attention_cuda(*args, splits=1)
        tol = DECODE_TOL["bfloat16"]
        splits[label] = {}
        for n in da.SPLITS:
            got = da.decode_attention_cuda(*args, splits=n)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got.float()).all()), f"K8 not finite: {label} S={n}")
            mx, rel, ok = _err(torch, got, want, scale, tol)
            mx1, rel1, ok1 = _err(torch, got, one, scale, tol)
            splits[label][n] = {"max_abs_err": mx, "max_err_over_scale": rel,
                                "vs_one_block_max_abs": mx1}
            worst = max(worst, mx)
            require(ok and ok1, f"K8 {label} at S={n}: against the reference {mx} ({rel} of "
                                f"the scale), against S=1 {mx1} ({rel1}), (atol, rtol) {tol}")

    # timed cold, as in the decode step (each layer reads its own cache):
    # input sets in turn, at least twice the 50 MB L2 in all. The decode
    # shape (256 live keys of a 384-row allocation, 8 ring slots filled,
    # every row alike) in both caches; batch-1 generate() at long context
    # and the serving engine's 8 slots, each also with one block per (b, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed = {}
    for name, sb, live, pad, quant in (("bfloat16", b, 256, 128, False),
                                       ("int8", b, 256, 128, True),
                                       ("b1_live2048", 1, 2048, 256, False),
                                       ("b8_live256", 8, 256, 128, False)):
        first = _decode_case(torch, g, sb, h, live, T, d, torch.bfloat16, quant, 8, live, pad)
        n_sets = -(-2 * L2_BYTES // _decode_bytes(first))
        sets = [first] + [_decode_case(torch, g, sb, h, live, T, d, torch.bfloat16, quant, 8,
                                       live, pad) for _ in range(n_sets - 1)]
        entry = {"b": sb, "live": live, "alloc": live + pad,
                 "splits": da.decode_splits(sb * h, live, sms),
                 "ms": device_ms(_cold(sets, da.decode_attention_cuda), 200),
                 "plain_ms": device_ms(_cold(sets, da.decode_attention_reference), 50),
                 "bound_ms": bound_ms(_decode_bytes(sets[0])), "bound_by": "bytes",
                 "bytes": _decode_bytes(sets[0]), "library_ms": None}
        if sb < b:
            # the small batches at every split count, forced
            entry["ms_by_splits"] = {n: device_ms(_cold(sets, functools.partial(
                da.decode_attention_cuda, splits=n)), 200) for n in da.SPLITS}
        if not quant:
            # SDPA over K/V concatenated beforehand (the concat is not timed)
            sets[:] = [(a[0], torch.cat([a[3], a[5][:, :, :8], a[1]], dim=2),
                        torch.cat([a[4], a[6][:, :, :8], a[2]], dim=2)) for a in sets]
            entry["library_ms"] = device_ms(_cold(sets, F.scaled_dot_product_attention), 200)
        entry["input_sets"] = n_sets
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        timed[name] = entry
    emit({"phase": "decode_attention_vs_plain", "ok": True, "tolerance": DECODE_TOL,
          "cases": results, "forced_splits": splits, "sms": sms,
          "timed_shape": {"b": b, "h": h, "d": d, "T": T, "live": 256, "alloc": 384, "t": 8},
          "timed": timed})
    return {"decode_attention": {"max_abs_err": worst, **timed["bfloat16"]}}


# ------------------------------------------------------------------ phase 8

class _ReferenceCalls:
    """Counts calls of K8's reference while installed (on the card the
    model's decode step must never reach it)."""

    def __init__(self, da):
        self.da, self.n, self.real = da, 0, da.decode_attention_reference

    def __enter__(self):
        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)
        self.da.decode_attention_reference = counted
        return self

    def __exit__(self, *exc):
        self.da.decode_attention_reference = self.real


def _teacher_forced_logits(torch, dec, prompt, feed, n_blocks):
    """Logits of ``n_blocks`` decode blocks that feed the given tokens
    (``feed[:, i]`` at step i), through the blocked decode's own cache
    handling."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    b, p = prompt.shape
    T = dec.decode_block
    cache = gen.init_cache(dec, b, dec.cache_size, T, dec.kv_quant)
    _logits, cache = dec(prompt, torch.arange(p, device="cuda")[None, :], cache=cache)
    big, small = gen.split_cache(cache)
    out = []
    for blk in range(n_blocks):
        live = p + blk * T
        view = gen._tree_slice_big(big, live)
        small = gen.reset_ring_state(small, live)
        for t in range(T):
            step = blk * T + t
            logits, cache = dec(feed[:, step:step + 1],
                                torch.full((b, 1), p + step, device="cuda"),
                                cache=gen.join_cache(view, small))
            _, small = gen.split_cache(cache)
            out.append(logits[:, -1].float())
        big = gen.merge_ring_caches(big, small, live)
    return torch.stack(out, dim=1)


def _decode_step_fn(torch, dec, prompt, live):
    """One single-token decode step of the blocked path at ``live`` cached
    rows (for the profiler)."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    b, p = prompt.shape
    cache = gen.init_cache(dec, b, dec.cache_size, dec.decode_block, dec.kv_quant)
    _logits, cache = dec(prompt, torch.arange(p, device="cuda")[None, :], cache=cache)
    big, small = gen.split_cache(cache)
    small = gen.reset_ring_state(small, live)
    view = gen._tree_slice_big(big, live)
    tok = prompt[:, -1:]
    pos = torch.full((b, 1), live, device="cuda")

    def step():
        with torch.no_grad():
            return dec(tok, pos, cache=gen.join_cache(view, small))
    return step


def phase_generate(torch):
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.models.generate import DECODE_BLOCK, _decode_model
    from distributed_ml_pytorch_tpu_torch.models.transformer import Dense
    from distributed_ml_pytorch_tpu_torch.models import transformer as tr
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    model = TransformerLM(**GPT2_DECODE, max_len=GEN_PROMPT + GEN_NEW, dtype=torch.bfloat16,
                          pos_encoding="learned", seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, GPT2_DECODE["vocab_size"], (GEN_BATCH, GEN_PROMPT), generator=g,
                           device="cuda")
    L, H = GPT2_DECODE["n_layers"], GPT2_DECODE["n_heads"]
    hd = GPT2_DECODE["d_model"] // H
    n_pad = -(-(GEN_NEW - 1) // DECODE_BLOCK) * DECODE_BLOCK
    weight_bytes = 2 * sum(m.weight.numel() for m in model.modules() if isinstance(m, Dense))
    runs = {}
    for name, quant in (("bfloat16", False), ("int8", True)):

        def timed(new):
            # the decode timing bench_all's decode leg takes too
            return bench_all.timed_generate(model, prompt, new, quant)

        timed(DECODE_BLOCK + 1)  # warm-up: cuBLAS handles and algorithms
        _o, t_short = timed(DECODE_BLOCK + 1)
        torch.cuda.reset_peak_memory_stats()
        da.launches = 0
        with _ReferenceCalls(da) as ref:
            out, wall = timed(GEN_NEW)
        launches = da.launches
        step_s = (wall - t_short) / (n_pad - DECODE_BLOCK)
        # bytes a decode step must read: the bf16 weights of every product,
        # plus the average live K/V (and scales) over the padded steps
        avg_live = GEN_PROMPT + (n_pad - 1) / 2
        per_key = 2 * hd * (1 if quant else 2) + (8 if quant else 0)
        kv_bytes = L * GEN_BATCH * H * avg_live * per_key
        step_bytes = weight_bytes + kv_bytes
        res = {"wall_s": wall, "tokens_per_s": GEN_BATCH * GEN_NEW / wall,
               "decode_step_ms": step_s * 1e3, "step_bytes": step_bytes,
               "weight_bytes": weight_bytes, "kv_bytes_avg": kv_bytes,
               "byte_roofline_share": step_bytes / HBM_BYTES_PER_S / step_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "k8_launches": launches, "reference_calls": ref.n,
               "short_run_s": t_short}
        require(out.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW), f"generate shape {out.shape}")
        require(bool(((out >= 0) & (out < GPT2_DECODE["vocab_size"])).all()),
                "generated tokens out of vocabulary")
        require(launches == L * n_pad, f"K8 launched {launches} times, want {L * n_pad}")
        require(ref.n == 0, f"the reference ran {ref.n} times on the card's decode path")

        # one decode step at the mean live length, profiled
        dec = _decode_model(model, GEN_PROMPT + n_pad, DECODE_BLOCK, quant)
        step = _decode_step_fn(torch, dec, prompt, GEN_PROMPT + n_pad // 2)
        step()
        res["profile"] = kernel_breakdown(step, DECODE_GROUPS)

        # teacher forcing: the first two blocks through K8 and through the
        # reference on the same tokens
        feed = out[:, GEN_PROMPT:GEN_PROMPT + 2 * DECODE_BLOCK]
        with torch.no_grad():
            lk = _teacher_forced_logits(torch, dec, prompt, feed, 2)
            tr.decode_attention_step = da.decode_attention_reference
            try:
                lr = _teacher_forced_logits(torch, dec, prompt, feed, 2)
            finally:
                tr.decode_attention_step = da.decode_attention_step
        rel = float((lk - lr).norm() / lr.norm())
        agree = int((lk.argmax(-1) == lr.argmax(-1)).sum())
        res["teacher_forced"] = {"steps": 2 * DECODE_BLOCK, "rel_l2": rel,
                                 "max_abs": float((lk - lr).abs().max()),
                                 "greedy_agree": agree, "of": int(lk.shape[0] * lk.shape[1]),
                                 "bound_rel_l2": TEACHER_TOL}
        require(rel <= TEACHER_TOL,
                f"{name}: teacher-forced logits differ by {rel} (relative L2) > {TEACHER_TOL}")
        runs[name] = res
        del dec, step
    emit({"phase": "generate_gpt2_small", "config": GPT2_DECODE, "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "new_tokens": GEN_NEW, "padded_steps": n_pad, **runs})
    return runs["bfloat16"]["k8_launches"]


# ------------------------------------------------------------------ phase 9

def phase_serving(torch):
    import functools

    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving.engine import ServingEngine
    from distributed_ml_pytorch_tpu_torch.serving.frontend import (
        ServingClient,
        ServingFrontend,
    )
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    vocab = GPT2_DECODE["vocab_size"]
    model = TransformerLM(**GPT2_DECODE, max_len=512, dtype=torch.bfloat16,
                          pos_encoding="learned", seed=1, device="cuda")
    engine = ServingEngine(model, slots=8, cache_size=512, decode_block=16,
                           prefill_bucket=16, max_queue=64)
    warm = engine.submit(np.arange(16), 17)  # cuBLAS handles, the first prefill
    engine.run_until_idle()
    require(warm.done, "warm-up request did not finish")
    engine.reset_metrics()
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(SERVE_REQUESTS):
        prompt = rng.integers(0, vocab, size=int(rng.integers(16, 129)))
        new = int(rng.integers(32, 129))
        kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=i) if i % 2 else {}
        reqs.append((prompt, new, kw))
    world = InProcessTransport.create_world(2)
    frontend = ServingFrontend(engine, world[0])
    client = ServingClient(world[1])
    server = threading.Thread(target=frontend.serve_forever, daemon=True)
    # the split count of every K8 call the engine makes, and a copy of the
    # inputs of its first call at the longest big cache it passed
    chosen, longest = {}, []
    real_splits, real_k8 = da.decode_splits, da.decode_attention_cuda

    def record_splits(bh, C, sms):
        n = real_splits(bh, C, sms)
        chosen[n] = chosen.get(n, 0) + 1
        return n

    def record_inputs(*args):
        if not longest or args[3].shape[2] > longest[0][3].shape[2]:
            longest[:] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)]
        return real_k8(*args)

    da.decode_splits, da.decode_attention_cuda = record_splits, record_inputs
    da.launches = 0
    try:
        with _ReferenceCalls(da) as ref:
            server.start()
            t0 = time.perf_counter()
            rids = [(client.submit(p, n, **kw), n) for p, n, kw in reqs]
            streams = [(n, list(client.stream(rid, timeout=300.0))) for rid, n in rids]
            wall = time.perf_counter() - t0
    finally:
        da.decode_splits, da.decode_attention_cuda = real_splits, real_k8
        frontend.stop()
        server.join(timeout=10)
        for t in world.values():
            t.close()
    launches = da.launches
    summary = engine.slo_summary()
    n_tokens = sum(len(s) for _, s in streams)

    # K8 on the engine's own inputs at its longest cache, cold (copies in
    # turn), at every split count, each held to the reference
    args = longest[0]
    b, h, C = args[3].shape[:3]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_sets = -(-2 * L2_BYTES // _decode_bytes(args))
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(n_sets - 1)]
    want = da.decode_attention_reference(*args)
    scale = da.decode_error_scale(*args)
    engine_k8 = {"b": b, "h": h, "C": C, "live_keys": int(args[8].sum()) * h,
                 "splits": da.decode_splits(b * h, C, sms), "input_sets": n_sets,
                 "bound_ms": bound_ms(_decode_bytes(args)), "ms_by_splits": {},
                 "max_abs_err_by_splits": {}}
    for n in da.SPLITS:
        mx, rel, ok = _err(torch, da.decode_attention_cuda(*args, splits=n), want, scale,
                           DECODE_TOL["bfloat16"])
        require(ok, f"K8 on the engine's inputs at S={n}: {mx} ({rel} of the scale)")
        engine_k8["max_abs_err_by_splits"][n] = mx
        engine_k8["ms_by_splits"][n] = device_ms(_cold(sets, functools.partial(
            da.decode_attention_cuda, splits=n)), 200)
    del sets
    emit({"phase": "serving_engine", "requests": SERVE_REQUESTS, "slots": 8,
          "cache_size": 512, "decode_block": 16, "prefill_bucket": 16, "wall_s": wall,
          "tokens": n_tokens, "tokens_per_s": n_tokens / wall, "k8_launches": launches,
          "k8_splits_chosen": chosen, "k8_at_longest_cache": engine_k8,
          "reference_calls": ref.n, "slo": summary})
    require(sum(chosen.values()) == launches,
            f"K8 chose a split count {sum(chosen.values())} times in {launches} launches")
    require(C < 512, f"the engine passed K8 its whole allocation ({C} rows)")
    require(not server.is_alive(), "the serving loop did not stop")
    for i, (n, toks) in enumerate(streams):
        require(len(toks) == n and all(0 <= t < vocab for t in toks),
                f"request {i}: stream of {len(toks)} tokens (want {n}) or out of vocabulary")
    require(summary["completed"] == SERVE_REQUESTS, f"completed {summary['completed']}")
    require(launches > 0 and ref.n == 0, f"K8 launches {launches}, reference calls {ref.n}")
    return launches


# ------------------------------------------------------------------ phase 10

def phase_conv_epilogue(torch):
    import torch.nn.functional as F

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    g = torch.Generator(device="cuda").manual_seed(10)
    cases = [(shape, torch.float32) for shape in BIAS_RELU_SHAPES]
    cases.append((BIAS_RELU_SHAPES[0], torch.bfloat16))
    checked = []
    errs = {"bias_relu_fwd": 0.0, "bias_relu_bwd": 0.0}
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        ct = torch.randn(shape, generator=g, device="cuda").to(dtype)
        x[0, ..., 0] = -b[0]  # z = 0 exactly: relu and its gradient give 0
        for bias in (None, b):
            yk = fc.bias_relu_fwd_cuda(x, bias)
            dk = fc.bias_relu_bwd_cuda(x, bias, ct)
            yp = fc.bias_relu_fwd_plain(x, bias)
            dp = fc.bias_relu_bwd_plain(x, bias, ct)
            torch.cuda.synchronize()
            what = f"{shape} {dtype} bias={bias is not None}"
            require(torch.equal(yk, yp), f"bias_relu fwd kernel != plain at {what}")
            require(torch.equal(dk, dp), f"bias_relu bwd kernel != plain at {what}")
            errs["bias_relu_fwd"] = max(errs["bias_relu_fwd"], float((yk - yp).abs().max()))
            errs["bias_relu_bwd"] = max(errs["bias_relu_bwd"], float((dk - dp).abs().max()))
            checked.append(what)

    # timed at the ladder's tail, float32 with bias, cold: input sets in
    # turn, their x alone at least twice the 50 MB L2, so each call reads its
    # inputs from device memory as the byte bound assumes; warm_ms times one
    # set that stays in L2, as right after the producing conv
    rows, c = BIAS_RELU_SHAPES[0]
    n = rows * c
    n_sets = -(-2 * L2_BYTES // (4 * n))
    b = torch.randn(c, generator=g, device="cuda")
    sets = [(torch.randn((rows, c), generator=g, device="cuda"),
             torch.randn((rows, c), generator=g, device="cuda")) for _ in range(n_sets)]
    turn = [0]

    def cold(fn):
        def call():
            turn[0] += 1
            return fn(*sets[turn[0] % n_sets])
        return call

    x, ct = sets[0]
    measured = {
        "bias_relu_fwd": {
            "max_abs_err": errs["bias_relu_fwd"],
            "ms": device_ms(cold(lambda xs, _: fc.bias_relu_fwd_cuda(xs, b))),
            "plain_ms": device_ms(cold(lambda xs, _: fc.bias_relu_fwd_plain(xs, b))),
            "library_ms": device_ms(cold(lambda xs, _: F.relu(xs))),
            "warm_ms": device_ms(lambda: fc.bias_relu_fwd_cuda(x, b)),
            "bound_ms": bound_ms(4 * (2 * n + c)), "bound_by": "bytes"},
        "bias_relu_bwd": {
            "max_abs_err": errs["bias_relu_bwd"],
            "ms": device_ms(cold(lambda xs, cs: fc.bias_relu_bwd_cuda(xs, b, cs))),
            "plain_ms": device_ms(cold(lambda xs, cs: fc.bias_relu_bwd_plain(xs, b, cs))),
            "library_ms": device_ms(cold(
                lambda xs, cs: torch.ops.aten.threshold_backward(cs, xs, 0.0))),
            "warm_ms": device_ms(lambda: fc.bias_relu_bwd_cuda(x, b, ct)),
            "bound_ms": bound_ms(4 * (3 * n + c)), "bound_by": "bytes"},
    }

    # the ladder, through the port's bench_all leg (its JSON records print
    # above this phase's line)
    for k in ("bias_relu_fwd", "bias_relu_bwd"):
        fc.launches[k] = 0
    ladder = bench_all.compute_microbench_phase("cuda")
    launches = {k: fc.launches[k] for k in ("bias_relu_fwd", "bias_relu_bwd")}
    emit({"phase": "conv_epilogue", "ok": True, "bit_identical": checked,
          "timed_shape": [rows, c], "timed": measured, "input_sets": n_sets,
          "library_note": "torch.relu(x) / aten.threshold_backward(g, x, 0) without the bias "
                          "add (one call each)",
          "ladder_us": ladder, "launches": launches})
    require(launches["bias_relu_fwd"] > 0 and launches["bias_relu_bwd"] > 0,
            f"the ladder did not launch K3: {launches}")
    return measured, launches


# ------------------------------------------------------------------ phase 11

def _head_inputs(torch, g, n, d, v, dtype, seq=None):
    """K7's inputs: bf16/f32 h2 and logits from a real h2 @ W product,
    float32 lse, random labels, gscale = mask / sum(mask) with the final
    position of every ``seq``-token sequence masked (every 7th row without
    ``seq``)."""
    w = torch.randn((v, d), generator=g, device="cuda") * 0.02
    h2 = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    logits = h2 @ w.to(dtype).t()
    lse = torch.logsumexp(logits.float(), dim=-1)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    mask = torch.ones(n, device="cuda")
    if seq:
        mask.view(-1, seq)[:, -1] = 0.0
    else:
        mask[::7] = 0.0
    return w, h2, logits, lse, labels, mask / mask.sum()


def _head_check(torch, fh, args, dtype_name):
    """K7 against head_update_plain on one input set, from W = 0 (the result
    is -lr dW itself: the sharp check) and from the real W (the update in
    place, where most of its last bits round away against W's): (max abs
    error and max error / bound from W = 0, max error / bound from W);
    raises on a miss."""
    w, h2, logits, lse, labels, gscale = args
    route = fh.head_update_route(h2, logits)
    dl = fh.head_dlogits(h2, logits, lse, labels, gscale)
    scale = HEAD_LR * torch.mm(dl.float().abs().t(), h2.float().abs())
    del dl
    atol, rtol = HEAD_TOL[dtype_name]
    out = []
    for w_in in (torch.zeros_like(w), w):
        wk = w_in.clone()
        before = fh.route_launches[route]
        fh.head_update_cuda(wk, h2, logits, lse, labels, gscale, -HEAD_LR)
        want = fh.head_update_plain(w_in, h2, logits, lse, labels, gscale, HEAD_LR)
        torch.cuda.synchronize()
        require(fh.route_launches[route] == before + 1, f"K7 did not take route {route}")
        require(bool(torch.isfinite(wk).all()),
                f"K7 not finite ({dtype_name}, {tuple(h2.shape)})")
        err = (wk - want).abs()
        ratio = float((err / (2.0 ** -23 * w_in.abs() + atol + rtol * scale)).max())
        require(ratio <= 1.0, f"K7 != plain ({dtype_name}, {route}, N, D = "
                              f"{tuple(h2.shape)}, V = {w.shape[0]}, from "
                              f"{'W' if out else 'zero'}): max abs err {float(err.max())}, "
                              f"err / bound {ratio}")
        out += [float(err.max()), ratio]
    return route, out[0], out[1], out[3]


def phase_head_update(torch):
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as fh

    full_float32()
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = {}
    # V = 677: the float32 kernel and the bf16 element loads; V % 8 == 0: the
    # bf16 TMA route with ragged N and V tiles, at D 64 (one consumer
    # warpgroup, its columns masked), 768 (three), 1024 (two passes over D)
    # and N 20 (less than one stage)
    for n_small, d_small, v_small, dtype in HEAD_SMALL:
        name = str(dtype).split(".")[-1]
        args = _head_inputs(torch, g, n_small, d_small, v_small, getattr(torch, dtype))
        cases[f"N{n_small} D{d_small} V{v_small} {name}"] = _head_check(torch, fh, args, name)
    n, d, v = GPT2_HEAD
    args = _head_inputs(torch, g, n, d, v, torch.bfloat16, seq=2048)
    cases["GPT-2-small b8x2048 bfloat16"] = _head_check(torch, fh, args, "bfloat16")
    require(cases["GPT-2-small b8x2048 bfloat16"][0] == "bf16_tma",
            "GPT-2-small does not take K7's TMA route")

    # timed at GPT-2-small b8 x 2048; the 1.65 GB of logits exceed the L2, so
    # every call is cold
    w, h2, logits, lse, labels, gscale = args
    # two launches from the same W give the same bits (no atomics)
    twice = [w.clone(), w.clone()]
    for wk in twice:
        fh.head_update_cuda(wk, h2, logits, lse, labels, gscale, -HEAD_LR)
    torch.cuda.synchronize()
    bit_identical = torch.equal(twice[0], twice[1])
    require(bit_identical, "K7's TMA route differs between two launches")
    del twice
    wbuf = w.clone()
    dlt = fh.head_dlogits(h2, logits, lse, labels, gscale).t()

    def peak_gb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    kern = lambda: fh.head_update_cuda(wbuf, h2, logits, lse, labels, gscale, -HEAD_LR)
    plain = lambda: fh.head_update_plain(w, h2, logits, lse, labels, gscale, HEAD_LR)
    flop_ms = 2.0 * n * d * v / BF16_FLOPS * 1e3
    byte_ms = bound_ms(2 * n * v + 2 * n * d + 2 * 4 * v * d + n * (4 + 4 + 8))
    timed = {
        "max_abs_err": max(c[1] for c in cases.values()),
        "ms": device_ms(kern, 10),
        "plain_ms": device_ms(plain, 5),
        "library_ms": device_ms(lambda: torch.mm(dlt, h2, out_dtype=torch.float32), 10),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
        "extra_peak_gb": {"kernel": peak_gb(kern), "plain": peak_gb(plain)},
    }
    emit({"phase": "head_update_vs_plain", "ok": True, "tolerance": HEAD_TOL, "lr": HEAD_LR,
          "cases": {k: {"route": rt, "max_abs_err": e, "max_err_over_bound": r,
                        "from_w_err_over_bound": rw}
                    for k, (rt, e, r, rw) in cases.items()},
          "bit_identical_two_launches": bit_identical,
          "timed_shape": {"N": n, "D": d, "V": v, "dtype": "bfloat16", "route": "bf16_tma"},
          "timed": timed,
          "library_note": "plain_ms: head_update_plain, which is the default formulation "
                          "(elementwise dl, one cuBLAS mm, the update); library_ms: the mm "
                          "alone, dl precomputed"})
    return {"fused_head": timed}


# ------------------------------------------------------------------ phase 12

def _rel_l2(torch, a, b):
    num = sum(float(((x - y).float() ** 2).sum()) for x, y in zip(a, b)) ** 0.5
    den = sum(float((y.float() ** 2).sum()) for y in b) ** 0.5
    return num / den


def phase_fused_head_step(torch):
    import numpy as np

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.ops import fused_head as fh
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
        create_lm_train_state,
        next_token_targets,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    # config 6's legs through the port's bench_all (JSON records above)
    rates = bench_all.lm_phase("cuda")
    legs = {m: {"tokens_per_s": float(r), "step_ms": r.step_seconds * 1e3, "mfu_bf16": r.mfu,
                "tflops": r.tflops, "step": r.step_kind} for m, r in rates.items()}

    model = TransformerLM(**bench_all.GPT2_SMALL, dtype=torch.bfloat16, pos_encoding="rope",
                          seed=0, device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.vocab_size, size=(8, 2048)).astype(np.int64)
    tok = torch.from_numpy(tokens).cuda()
    tgt = torch.from_numpy(next_token_targets(tokens)).cuda()
    params = list(model.parameters())
    w0 = [p.detach().clone() for p in params]
    steps = {"default": fh.make_fused_head_sgd_step(model, LM_LR),
             "k7": fh.make_fused_head_sgd_step(model, LM_LR, use_kernel=True),
             "ad": make_fsdp_lm_train_step(model, SGD(LM_LR))}
    state = create_lm_train_state(model, SGD(LM_LR))
    runs = {}
    for kind, step in steps.items():
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
        _zero_attention_launches(at)
        fh.launches = 0
        fh.route_launches.update(dict.fromkeys(fh.route_launches, 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _state, loss = step(state, tok, tgt)
        torch.cuda.synchronize()
        runs[kind] = {"loss": float(loss), "update": [p.detach() - w for p, w in zip(params, w0)],
                      "launches": {"fused_head": fh.launches,
                                   "fused_head_bf16_tma": fh.route_launches["bf16_tma"],
                                   **at.launches},
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    head = [i for i, (name, _) in enumerate(model.named_parameters()) if name == "lm_head.weight"]
    upd = {k: r.pop("update") for k, r in runs.items()}
    cmp = {
        "k7_vs_default": {"rel_update_l2": _rel_l2(torch, upd["k7"], upd["default"]),
                          "lm_head_rel_l2": _rel_l2(torch, [upd["k7"][i] for i in head],
                                                    [upd["default"][i] for i in head])},
        "ad_vs_default": {"rel_update_l2": _rel_l2(torch, upd["ad"], upd["default"]),
                          "rel_loss": abs(runs["ad"]["loss"] - runs["default"]["loss"])
                          / abs(runs["default"]["loss"])},
    }
    del upd

    # step time: one warm-up step and three timed steps of each
    for kind, step in steps.items():
        step(state, tok, tgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, tok, tgt)
        torch.cuda.synchronize()
        runs[kind]["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    profile = kernel_breakdown(lambda: steps["k7"](state, tok, tgt), PROFILE_GROUPS)
    emit({"phase": "fused_head_step_gpt2_small", "lr": LM_LR, "batch": 8, "seq": 2048,
          "bench_all_legs": legs, "steps": runs, "compare": cmp,
          "tolerance": {"fused_head_update": FUSED_HEAD_UPDATE_TOL, "ad_loss": AD_LOSS_TOL,
                        "ad_update": AD_UPDATE_TOL},
          "k7_step_profile": profile})
    n_layers = model.n_layers
    for kind, r in runs.items():
        la = r["launches"]
        want = 1 if kind == "k7" else 0
        require(la["fused_head"] == want and la["fused_head_bf16_tma"] == want,
                f"{kind} step launched K7 {la['fused_head']} times, "
                f"{la['fused_head_bf16_tma']} by its TMA route")
        require(la["flash_fwd"] == n_layers and la["flash_bwd_fused"] == n_layers,
                f"{kind} step launched K4/K5 {la}")
    require(runs["k7"]["loss"] == runs["default"]["loss"],
            f"K7 step loss {runs['k7']['loss']} != default {runs['default']['loss']}")
    require(cmp["k7_vs_default"]["rel_update_l2"] <= FUSED_HEAD_UPDATE_TOL,
            f"K7 and default updates differ: {cmp['k7_vs_default']}")
    require(cmp["ad_vs_default"]["rel_loss"] <= AD_LOSS_TOL
            and cmp["ad_vs_default"]["rel_update_l2"] <= AD_UPDATE_TOL,
            f"AD and fused-head steps differ: {cmp['ad_vs_default']}")
    for m in ("gpt2_small_seq2048_train_throughput", "gpt2_small_seq8192_train_throughput"):
        require(legs[m]["tokens_per_s"] > 0 and legs[m]["mfu_bf16"] is not None,
                f"{m}: {legs[m]}")
    return runs["k7"]["launches"]["fused_head"]


# ------------------------------------------------------------------ phase 13

def phase_alexnet(torch):
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    # the legs and profiles under cuDNN's defaults, as the trainer and the
    # DownPour worker leave them (phase 3 set deterministic algorithms)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    rates = bench_all.alexnet_phase("cuda")
    for metric, r in rates.items():
        require(math.isfinite(r) and r > 0, f"{metric}: {float(r)} images/s")
    for rec in bench_all.RESULTS:
        if rec["metric"].startswith("alexnet_"):
            require(all(math.isfinite(v) for v in rec["warmup_losses"]),
                    f"{rec['metric']}: losses {rec['warmup_losses']}")
    profiles = {}
    for name, step, k1 in (
            ("downpour_b64", bench_all.alexnet_step(64, True, "cuda", downpour=True), 1),
            ("train_b1024", bench_all.alexnet_step(1024, True, "cuda"), 0)):
        for _ in range(3):
            step()
        fu.launches = 0
        for k in fc.launches:
            fc.launches[k] = 0
        want = {"K2a relu_pool2_fwd": 3, "K2b relu_pool2_bwd": 3, "K1 flat_axpy": k1}
        prof = kernel_breakdown(step, ALEXNET_GROUPS, top=12)
        require("busy_ms" in prof and prof["lost_launches"] == 0,
                f"{name}: the profile lost kernels: {prof}")
        n = prof["group_launches"]
        require(all(n[k] == v for k, v in want.items()),
                f"{name}: profiled launches {n} (want {want})")
        # the wrappers' counts over every run of the step the profiler made
        runs = prof["runs"]
        require(fu.launches == k1 * runs
                and fc.launches["relu_pool2_fwd"] == fc.launches["relu_pool2_bwd"] == 3 * runs
                and fc.launches["relu_pool2_fwd.vector"] == 3 * runs
                and fc.launches["relu_pool2_bwd.vector"] == 3 * runs,
                f"{name}: wrapper counts {fc.launches}, flat_axpy {fu.launches} over "
                f"{runs} profiled run(s)")
        profiles[name] = {"step_ms": device_ms(step, 20), **prof}
    # the batch-1024 fused step under each cuDNN algorithm choice
    cudnn_step_ms = {}
    for label, det, bench in (("default", False, False), ("deterministic", True, False),
                              ("benchmark", False, True)):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
        step = bench_all.alexnet_step(1024, True, "cuda")
        cudnn_step_ms[label] = device_ms(step, 20)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    emit({"phase": "alexnet", "ok": True,
          "images_per_s": {m: float(r) for m, r in rates.items()},
          "profiles": profiles, "b1024_fused_step_ms_by_cudnn_setting": cudnn_step_ms})


# ------------------------------------------------------------------ phase 14

#: K2's bfloat16 cases, (shape, misaligned, route): AlexNet's three tails at
#: both batches (vector route: C % 8 == 0), C % 8 != 0 (36) and an odd C,
#: and a contiguous view one element (2 bytes) into its storage (scalar)
POOL_CASES_BF16 = ([((b, h, w, c), False, "vector") for b in POOL_BATCHES
                    for h, w, c in POOL_TAILS]
                   + [((64, 4, 4, 36), False, "scalar"), ((64, 4, 4, 37), False, "scalar"),
                      ((64, 8, 8, 64), True, "scalar")])
#: an AlexNet trainer step's kernel groups, K2's bfloat16 kernels first
TRAINER_GROUPS = {"K2a relu_pool2_bf16_fwd": ["relu_pool2_bf16_fwd"],
                  "K2b relu_pool2_bf16_bwd": ["relu_pool2_bf16_bwd"], **ALEXNET_GROUPS}
#: steps a dispatch of the graphed batch-64 trainer (the JAX harness's SCAN_K)
SCAN_K = 100
#: (d)'s CLI run: synthetic CIFAR-10, 20 steps an epoch, two epochs; the
#: interrupted run stops after its checkpoint at CLI_STOP
CLI_ARGS = ["--no-distributed", "--model", "alexnet", "--dtype", "bfloat16", "--epochs", "2",
            "--synthetic-data", "--synthetic-train-size", "640", "--synthetic-test-size", "128",
            "--batch-size", "32", "--log-interval", "10", "--optimizer", "adamw",
            "--lr-schedule", "cosine", "--grad-clip", "1.0", "--grad-accum", "2",
            "--steps-per-dispatch", "10", "--ckpt-every", "15"]
CLI_STOP, CLI_STEPS = 15, 40


def _relu_pool2_bf16_checks(torch, g):
    """(a) K2a/K2b in bfloat16 bit-identical to the plain versions at
    POOL_CASES_BF16 (bias or none, ties forced or not), each on the route
    the rule names, read from the per-route bfloat16 counts; timed per
    shape cold and warm at both batches beside the launch floor, the plain
    versions, ``max_pool2d(relu)`` in bfloat16 and the halved byte bound."""
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc

    dev, bf = torch.device("cuda"), torch.bfloat16
    err = {"fwd": 0.0, "bwd": 0.0}
    held = []
    for shape, misaligned, want in POOL_CASES_BF16:
        nb, h, w, c = shape
        xr = torch.randn(shape, generator=g, device=dev)
        gr = torch.randn((nb, h // 2, w // 2, c), generator=g, device=dev).to(bf)
        before = dict(fc.launches)
        for xin in (xr.to(bf), (torch.round(xr * 2) / 2).to(bf)):
            if misaligned:
                xin = torch.empty(xin.numel() + 1, device=dev, dtype=bf)[1:].view(
                    shape).copy_(xin)
            for bias in (None, torch.randn(c, generator=g, device=dev).to(bf)):
                mk = fc.relu_pool2_fwd_cuda(xin, bias)
                mp = fc.relu_pool2_fwd_plain(xin, bias)
                dk = fc.relu_pool2_bwd_cuda(xin, bias, mk, gr)
                dp = fc.relu_pool2_bwd_plain(xin, bias, mp, gr)
                torch.cuda.synchronize()
                what = f"bf16 {shape} misaligned={misaligned} bias={bias is not None}"
                require(mk.dtype == bf and torch.equal(mk, mp),
                        f"relu_pool2 fwd kernel != plain at {what}")
                require(dk.dtype == bf and torch.equal(dk, dp),
                        f"relu_pool2 bwd kernel != plain at {what}")
                err["fwd"] = max(err["fwd"], float((mk.float() - mp.float()).abs().max()))
                err["bwd"] = max(err["bwd"], float((dk.float() - dp.float()).abs().max()))
        ran = {k: fc.launches[k] - before[k] for k in fc.launches if k.startswith("relu_pool2")}
        require(all(ran[f"relu_pool2_{d}{key}"] == 4 for d in ("fwd", "bwd")
                    for key in ("", f".bf16.{want}")),
                f"relu_pool2 bf16 at {shape} (misaligned={misaligned}) ran {ran}, not the "
                f"{want} route")
        held.append({"shape": list(shape), "misaligned": misaligned, "route": want})

    one, two = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    floor = device_ms(lambda: one.add_(two))
    rows = {b: [_time_pool_shape(torch, fc, (b, *t), g, bf) for t in POOL_TAILS]
            for b in POOL_BATCHES}

    def total(batch, key):
        return sum(r[key] for r in rows[batch])

    measured = {}
    for k, name in (("fwd", "relu_pool2_fwd.bf16"), ("bwd", "relu_pool2_bwd.bf16")):
        measured[name] = {
            "max_abs_err": err[k], "ms": total(1024, f"{k}_ms"),
            "plain_ms": total(1024, f"{k}_plain_ms"),
            "library_ms": total(1024, "fwd_library_ms") if k == "fwd" else None,
            "bound_ms": total(1024, f"{k}_bound_ms"), "bound_by": "bytes"}
    line = {"held": held, "launch_floor_ms": floor,
            "b1024_cold_sum_ms": {k: total(1024, f"{k}_ms") for k in ("fwd", "bwd")},
            "b1024_warm_sum_ms": {k: total(1024, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b1024_bound_sum_ms": {k: total(1024, f"{k}_bound_ms") for k in ("fwd", "bwd")},
            "b1024_plain_sum_ms": {k: total(1024, f"{k}_plain_ms") for k in ("fwd", "bwd")},
            "b1024_library_fwd_sum_ms": total(1024, "fwd_library_ms"),
            "b64_warm_sum_ms": {k: total(64, f"{k}_warm_ms") for k in ("fwd", "bwd")},
            "b64_cold_sum_ms": {k: total(64, f"{k}_ms") for k in ("fwd", "bwd")},
            "shapes": rows[64] + rows[1024]}
    return measured, line


def _wall_ms(torch, fn) -> float:
    """Host wall ms of ``fn()``, ended by a synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _graphed_vs_eager(torch) -> dict:
    """(b) ``make_scan_train_step`` (a graph of one step replayed) against
    as many eager steps from the same weights on the same batches: AlexNet
    fused, batch 64, K = SCAN_K, SGD lr 0.008, deterministic cuDNN; equal
    losses and parameters. Then each way's wall time for another K steps
    (host synchronisation included: one per dispatch graphed, one a step
    eager, as the per-step trainer reads each loss), one graphed dispatch
    profiled (K2a/K2b 3 a step, no lost launch, the idle share) and ten
    eager steps profiled."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    images, labels = bench_all.make_batch(64, k=SCAN_K)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    runs = {}
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
        tx = ttr.SGD(bench_all.ALEXNET_LR)
        state = ttr.create_train_state(model, tx)
        if graphed:
            scan = ttr.make_scan_train_step(model, tx)
            losses = scan(state, x, y)[1].cpu()
        else:
            step = ttr.make_train_step(model, tx)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(SCAN_K)]).cpu()
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        runs[graphed] = (losses, flat, state)
    require(torch.equal(runs[True][0], runs[False][0]),
            "graphed K-step losses differ from the eager steps'")
    require(torch.equal(runs[True][1], runs[False][1]),
            "graphed K-step parameters differ from the eager steps'")
    require(scan.graphed.captures == 1, f"{scan.graphed.captures} captures, not 1")
    gstate, estate = runs[True][2], runs[False][2]
    graphed_ms = _wall_ms(torch, lambda: scan(gstate, x, y)[1].cpu()) / SCAN_K
    eager_ms = _wall_ms(torch, lambda: [float(step(estate, x[i], y[i])[1])
                                        for i in range(SCAN_K)]) / SCAN_K
    for k in fc.launches:
        fc.launches[k] = 0
    prof = kernel_breakdown(lambda: scan(gstate, x, y)[1], TRAINER_GROUPS, top=12)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"graphed dispatch: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 3 * SCAN_K,
            f"graphed dispatch: K2 launches {n}, not {3 * SCAN_K} each")
    replay_counts = {k: v for k, v in fc.launches.items() if v}
    eager_prof = kernel_breakdown(lambda: [step(estate, x[i], y[i]) for i in range(10)],
                                  TRAINER_GROUPS, top=8)
    return {"steps_per_dispatch": SCAN_K, "batch": 64, "bit_equal": True,
            "graphed_ms_per_step": graphed_ms, "eager_ms_per_step": eager_ms,
            "graphed_images_per_s": 64e3 / graphed_ms, "eager_images_per_s": 64e3 / eager_ms,
            "graphed_profile": prof, "graphed_wrapper_counts_in_profile": replay_counts,
            "eager_profile_10_steps": eager_prof}


def _graphed_accumulation(torch) -> dict:
    """(c) ``grad_accum_b1024`` (batch 1024, microbatch 256, each update the
    sum of batch-64 mean-gradient updates) through
    ``make_scan_accum_train_step``: two dispatches of U = 2 (the graph's
    two eager warm-up updates, then a capture and a replay) against the same
    four updates of ``make_accum_train_step``: equal."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr

    images, labels = bench_all.make_batch(1024, k=4)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    kw = dict(effective_update_batch=bench_all.EFFECTIVE_UPDATE)
    runs = {}
    for graphed in (True, False):
        model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
        tx = ttr.SGD(bench_all.ALEXNET_LR)
        state = ttr.create_train_state(model, tx)
        if graphed:
            scan = ttr.make_scan_accum_train_step(model, tx, bench_all.ACCUM_MICROBATCH, **kw)
            losses = torch.cat([scan(state, x[i:i + 2], y[i:i + 2])[1] for i in (0, 2)])
        else:
            step = ttr.make_accum_train_step(model, tx, bench_all.ACCUM_MICROBATCH, **kw)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(4)])
        runs[graphed] = (losses.cpu(), torch.cat([p.detach().reshape(-1)
                                                  for p in model.parameters()]))
    require(scan.graphed.captures == 1, "the accumulation step was never captured")
    require(torch.equal(runs[True][0], runs[False][0])
            and torch.equal(runs[True][1], runs[False][1]),
            "graphed accumulation updates differ from the eager ones")
    return {"updates": 4, "dispatches": "2 x U=2", "bit_equal": True,
            "losses": runs[True][0].tolist()}


def _bf16_step_profile(torch) -> dict:
    """AlexNet fused in bfloat16 (the trainer's ``--dtype bfloat16``) at
    config 1's batch 1024, SGD lr 0.008, 5 steps a dispatch as a CUDA graph
    under cuDNN's default algorithms: ms a step (``utils/devtime``, beside
    the float32 leg of phase 13) and one dispatch profiled, K2's bfloat16
    kernels 3 times a step each."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.devtime import device_time

    k = 5
    model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda",
                      dtype=torch.bfloat16)
    tx = ttr.SGD(bench_all.ALEXNET_LR)
    state = ttr.create_train_state(model, tx)
    scan = ttr.make_scan_train_step(model, tx)
    images, labels = bench_all.make_batch(1024, k=k)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    losses = scan(state, x, y)[1].cpu().tolist()  # warm-up steps and the capture
    step_ms = device_time(lambda: scan(state, x, y)[1], calls=3, warmup=1).per_call_ms / k
    prof = kernel_breakdown(lambda: scan(state, x, y)[1], TRAINER_GROUPS, top=8)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"bf16 batch-1024 dispatch: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_bf16_fwd"] == n["K2b relu_pool2_bf16_bwd"] == 3 * k
            and n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 0,
            f"bf16 batch-1024 dispatch: K2 launches {n}, not {3 * k} bf16 each")
    return {"batch": 1024, "steps_per_dispatch": k, "step_ms": step_ms,
            "images_per_s": 1024e3 / step_ms, "first_losses": losses, "profile": prof}


def _accum_profile(torch) -> dict:
    """The ``grad_accum_b1024`` update as the leg runs it (batch 1024,
    microbatch 256, update scaled to batch 64, float32, cuDNN's default
    algorithms), graphed: one dispatch of 2 updates profiled after the
    warm-up and the capture, K2a/K2b 3 a microbatch each."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    u, micro = 2, bench_all.ACCUM_MICROBATCH
    model = get_model("alexnet", fused_epilogue=True, seed=0, device="cuda")
    tx = ttr.SGD(bench_all.ALEXNET_LR)
    state = ttr.create_train_state(model, tx)
    scan = ttr.make_scan_accum_train_step(
        model, tx, micro, effective_update_batch=bench_all.EFFECTIVE_UPDATE)
    images, labels = bench_all.make_batch(1024, k=u)
    x, y = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    for _ in range(2):  # the two eager warm-up updates, then the capture and a replay
        scan(state, x, y)[1].cpu()
    prof = kernel_breakdown(lambda: scan(state, x, y)[1], TRAINER_GROUPS, top=8)
    n = prof.get("group_launches", {})
    want = 3 * (1024 // micro) * u
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"graphed accumulation: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == want,
            f"graphed accumulation: K2 launches {n}, not {want} each")
    return {"batch": 1024, "microbatch": micro, "updates_per_dispatch": u,
            "captures": scan.graphed.captures, "profile": prof}


class _Stop(Exception):
    pass


def _tensors(tree) -> list:
    """Every tensor of a nested dict/list, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "shape") else []


def _cli_resume(torch) -> dict:
    """(d) ``train_single`` through ``training/cli.main`` (CLI_ARGS: bf16,
    10 steps a dispatch, accumulation 2, adamw, cosine, clipping): run to
    the end under the profiler (the bfloat16 K2 kernels must be in it, on
    the vector route by the wrappers' counts), then run again, stopped
    right after the checkpoint at step CLI_STOP, and resumed with
    ``--resume``: the final checkpoints (parameters, optimizer state,
    generator) and the CSV losses from the resumed step on equal the
    uninterrupted run's."""
    import csv
    import shutil

    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.training import cli
    from distributed_ml_pytorch_tpu_torch.utils import checkpoint as ck
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

    root = os.path.join(ROOT, "build", "smoke_trainer")

    def argv(tag):
        return [*CLI_ARGS, "--ckpt-dir", os.path.join(root, tag, "ck"),
                "--log-dir", os.path.join(root, tag)]

    def full_run():
        shutil.rmtree(os.path.join(root, "full"), ignore_errors=True)
        require(cli.main(argv("full")) == 0, "the CLI run failed")

    for k in fc.launches:
        fc.launches[k] = 0
    prof = kernel_breakdown(full_run, TRAINER_GROUPS, top=12)
    n = prof.get("group_launches", {})
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"CLI run: the profile lost kernels: {prof}")
    require(n["K2a relu_pool2_bf16_fwd"] > 0 and n["K2b relu_pool2_bf16_bwd"] > 0
            and n["K2a relu_pool2_fwd"] == n["K2b relu_pool2_bwd"] == 0,
            f"CLI run: K2 launches in the profile {n}: the bf16 kernels must run, the "
            f"float32 ones not")
    counts = dict(fc.launches)
    require(all(counts[f"relu_pool2_{d}.bf16.vector"] > 0
                and counts[f"relu_pool2_{d}.bf16.scalar"] == 0 for d in ("fwd", "bwd")),
            f"CLI run: K2 wrapper counts {counts}: not the bf16 vector route")

    shutil.rmtree(os.path.join(root, "cut"), ignore_errors=True)
    real_save = ck.Checkpointer.save

    def save_then_stop(self, step, state, *, force=False):
        accepted = real_save(self, step, state, force=force)
        if accepted and not force and step == CLI_STOP:
            raise _Stop
        return accepted

    ck.Checkpointer.save = save_then_stop
    try:
        cli.main(argv("cut"))
        stopped = False
    except _Stop:
        stopped = True
    finally:
        ck.Checkpointer.save = real_save
    require(stopped, f"the interrupted run was not stopped at step {CLI_STOP}")
    require(cli.main([*argv("cut"), "--resume"]) == 0, "the resumed CLI run failed")

    def final(tag):
        return torch.load(os.path.join(root, tag, "ck", str(CLI_STEPS), "state.pt"),
                          weights_only=True)

    def losses(tag):
        with open(os.path.join(root, tag, "gpu.csv"), newline="") as fh:
            return [(r["iteration"], r["training_loss"], r["test_loss"])
                    for r in csv.DictReader(fh)]

    a, b = final("full"), final("cut")
    require(a["step"] == b["step"] == CLI_STEPS, f"final steps {a['step']}, {b['step']}")
    require(all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"]),
            "resumed run's final parameters differ from the uninterrupted run's")
    require(all(torch.equal(u, v) for u, v in zip(_tensors(a["opt_state"]),
                                                  _tensors(b["opt_state"]))),
            "resumed run's final optimizer state differs from the uninterrupted run's")
    require(torch.equal(a["generator"], b["generator"]), "generator states differ")
    rows_full, rows_cut = losses("full"), losses("cut")
    require(len(rows_full) == CLI_STEPS and rows_cut == rows_full[CLI_STOP:],
            "resumed run's CSV losses differ from the uninterrupted run's")
    return {"argv": CLI_ARGS, "steps": CLI_STEPS, "stopped_at": CLI_STOP, "bit_equal": True,
            "profile": prof, "wrapper_counts": {k: v for k, v in counts.items() if v},
            "final_loss": float(rows_full[-1][1])}


def phase_trainer_family(torch):
    """Phase 14: the trainer family — (a) K2 in bfloat16, a bfloat16
    batch-1024 step and the graphed accumulation update profiled, (b) the graphed
    K-step trainer, (c) the graphed accumulation step, (d) the CLI's
    bfloat16 run with resume. Returns the kernels line's bfloat16 rows and
    their launches (from (d)'s profile: the graph's replays do not pass
    through the wrappers)."""
    g = torch.Generator(device="cuda").manual_seed(14)
    measured, pool_line = _relu_pool2_bf16_checks(torch, g)
    emit({"phase": "trainer_family_relu_pool2_bf16", "ok": True, **pool_line})
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
        emit({"phase": "trainer_family_bf16_b1024", "ok": True, **_bf16_step_profile(torch)})
        emit({"phase": "trainer_family_accum_profile", "ok": True, **_accum_profile(torch)})
        torch.backends.cudnn.deterministic = True
        emit({"phase": "trainer_family_graphed_scan", "ok": True, **_graphed_vs_eager(torch)})
        emit({"phase": "trainer_family_graphed_accum", "ok": True,
              **_graphed_accumulation(torch)})
        run = _cli_resume(torch)
        emit({"phase": "trainer_family_cli_resume", "ok": True, **run})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    n = run["profile"]["group_launches"]
    return measured, {"relu_pool2_fwd.bf16": n["K2a relu_pool2_bf16_fwd"],
                      "relu_pool2_bwd.bf16": n["K2b relu_pool2_bf16_bwd"]}


# ------------------------------------------------------------------ phase 15

#: (a)'s single worker: steps a pass (n_push = n_pull = 10: runs of 1 and 9)
CHUNK_STEPS = 60
#: (c)'s server directory (emptied first: the log is opened for appending)
SMOKE_PS_DIR = os.path.join(ROOT, "build", "smoke_ps")
#: (b)'s profiled run: the 9-step run between two gaps at n_push = n_pull = 10
CHUNK_PROFILE_LEN = 9


def _recording_worker(torch, seed=0):
    """A DownPour worker (AlexNet fused, batch 64's lr 0.008, n_push = n_pull
    = 10) on a transport nobody answers, its pushes recorded."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode

    model = get_model("alexnet", fused_epilogue=True, seed=seed, device="cuda")
    opt = tps.Asynchronous(model, lr=0.008, n_push=10, n_pull=10,
                           transport=InProcessTransport.create_world(2)[1])
    pushes = []

    def record(code, payload):
        if code == MessageCode.GradientUpdate:
            pushes.append(payload.copy())

    opt._send = record
    gen = torch.Generator(device="cuda").manual_seed(1)
    return model, opt, pushes, gen


def _worker_pass(torch, opt, model, gen, x, y, start, chunked):
    """Steps ``[start, start + len(x))`` of one worker, chunked (``boundary``
    and one graph dispatch a run, the losses read once at the end) or per
    step (each loss read, as the per-step worker logs it); returns the host
    wall ms, ended by a synchronisation."""
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device

    n = len(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunked:
        chunk = tps._chunk_step_cache(opt, 64)
        losses = []
        for gap, length in tps.downpour_chunk_schedule(10, 10, start, start + n):
            opt.boundary(gap)
            a = gap - start
            losses.append(chunk(opt.opt_state, x[a:a + length], y[a:a + length], gen))
            opt.idx = gap + length
        torch.cat(losses).cpu()
    else:
        for i in range(n):
            float(loss_and_grads(model, *to_device(x[i], y[i], "cuda"), generator=gen))
            opt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _chunked_vs_per_step(torch):
    """(a) and (b): one worker chunked (graphs) and one per step (eager) from
    the same weights on the same batches, CHUNK_STEPS steps each: pushes and
    final parameters bit for bit, one capture; a second pass of each timed;
    then one 9-step run of the chunked worker profiled (K1 9 times, K2a and
    K2b 27 each, no launch lost) and the boundary's parts timed: an install
    of the central vector and a snapshot plus push."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import downpour_chunk_schedule
    from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown
    from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

    x, y, *_ = load_cifar10(synthetic=True, n_train=3 * CHUNK_STEPS * 64, n_test=16)
    x = x.reshape(3 * CHUNK_STEPS, 64, 32, 32, 3)
    y = y.reshape(3 * CHUNK_STEPS, 64)
    workers = {}
    for chunked in (True, False):
        workers[chunked] = _recording_worker(torch)
    wall_ms = {}
    for p, start in enumerate((0, CHUNK_STEPS)):
        for chunked in (True, False):
            model, opt, pushes, gen = workers[chunked]
            ms = _worker_pass(torch, opt, model, gen, x[start:start + CHUNK_STEPS],
                              y[start:start + CHUNK_STEPS], start, chunked)
            opt._flusher.drain()
            if p == 1:
                wall_ms[chunked] = ms / CHUNK_STEPS
        if p == 0:
            (mc, oc, pc, _), (mp, _op, pp, _) = workers[True], workers[False]
            require(len(pc) == len(pp) == CHUNK_STEPS // 10
                    and all(np.array_equal(a, b) for a, b in zip(pc, pp)),
                    "the chunked worker's pushes differ from the per-step worker's")
            require(all(torch.equal(a, b) for a, b in zip(mc.parameters(), mp.parameters())),
                    "the chunked worker's parameters differ from the per-step worker's")
            captures = oc._chunk_step.graphed.captures
            require(captures == 1, f"{captures} captures, not 1 for every run length")
    (model, opt, _pushes, gen) = workers[True]
    start = 2 * CHUNK_STEPS
    require(downpour_chunk_schedule(10, 10, start, start + 10)[1] == (start + 1, 9),
            "the schedule's second run is not 9 steps")
    _worker_pass(torch, opt, model, gen, x[start:start + 1], y[start:start + 1], start, True)
    chunk = opt._chunk_step
    xs, ys = x[start + 1:start + 10], y[start + 1:start + 10]
    opt.boundary(start + 1)
    prof = kernel_breakdown(lambda: chunk(opt.opt_state, xs, ys, gen), ALEXNET_GROUPS, top=12)
    require("busy_ms" in prof and prof["lost_launches"] == 0,
            f"chunked dispatch: the profile lost kernels: {prof}")
    n = prof["group_launches"]
    want = {"K1 flat_axpy": CHUNK_PROFILE_LEN, "K2a relu_pool2_fwd": 3 * CHUNK_PROFILE_LEN,
            "K2b relu_pool2_bwd": 3 * CHUNK_PROFILE_LEN}
    require(all(n[k] == v for k, v in want.items()),
            f"chunked dispatch: profiled launches {n} (want {want})")
    # the boundary's parts, each ended by a synchronisation: the install of
    # a 9.9 MB central vector; a snapshot handed to the flusher (what the
    # training thread pays), and the same until the flusher has copied it
    # to the host and sent it (what overlaps the next steps)
    central = ravel_model_params(model).cpu().numpy()
    install_ms = statistics_ms(torch, lambda: opt.install(central))
    enqueue_ms = []
    for _ in range(6):
        opt._flusher.drain()
        enqueue_ms.append(_wall_ms(torch, opt._push))
    opt._flusher.drain()
    enqueue_ms = sum(enqueue_ms[1:]) / 5
    push_ms = statistics_ms(torch, lambda: (opt._push(), opt._flusher.drain()))
    opt.finish()
    workers[False][1].finish()
    return {"steps": CHUNK_STEPS, "batch": 64, "bit_equal": True, "captures": 1,
            "chunked_ms_per_step": wall_ms[True], "per_step_ms_per_step": wall_ms[False],
            "chunked_images_per_s": 64e3 / wall_ms[True],
            "per_step_images_per_s": 64e3 / wall_ms[False],
            "profile_9_steps": prof, "busy_ms_per_step": prof["busy_ms"] / CHUNK_PROFILE_LEN,
            "idle_share": prof["idle_share"], "install_ms": install_ms,
            "snapshot_enqueue_ms": enqueue_ms, "snapshot_to_sent_ms": push_ms,
            "boundary_training_thread_ms_per_10_steps": install_ms + enqueue_ms}


def statistics_ms(torch, fn, reps: int = 5) -> float:
    """Mean host wall ms of ``fn()`` over ``reps`` calls, each ended by a
    synchronisation, after one warm-up call."""
    fn()
    return sum(_wall_ms(torch, fn) for _ in range(reps)) / reps


def _chunked_world(torch, per_step_workers) -> dict:
    """(c) and (d): the two-worker world chunked, with the server's log, its
    checkpoint and its admission gate; then a fresh server restores the
    directory."""
    import shutil

    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
    from distributed_ml_pytorch_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    shutil.rmtree(SMOKE_PS_DIR, ignore_errors=True)
    srv, per_worker, launches, wall, _records = _downpour_world(
        torch, ["--chunked-dispatch", "on", "--ckpt-dir", SMOKE_PS_DIR, "--wal",
                "--admission"])
    counts = {c.name: k for c, k in srv.message_counts.items() if k}
    require(all(w["steps"] == WORKER_STEPS for w in per_worker.values()),
            f"chunked workers took too few steps: {per_worker}")
    for r, w in per_worker.items():
        require(w["late_loss"] < w["early_loss"], f"chunked worker {r} loss did not fall: {w}")
    require(srv.message_counts[MessageCode.GradientUpdate] >= 2 * (WORKER_STEPS // 10)
            and srv.message_counts[MessageCode.ParameterRequest] >= 2 * (WORKER_STEPS // 10),
            f"the server counted too few pushes or pulls: {counts}")
    require(srv.quarantined == 0, f"the admission gate quarantined {srv.quarantined} pushes")
    # each worker's wrappers see its eager warm-up steps and the capture
    # (the replays pass none), and K2a its epoch-end eval's one test batch
    per_graph = GRAPH_WARMUP_STEPS + 1
    require(launches["flat_axpy"] == 2 * per_graph
            and launches["relu_pool2_bwd.vector"] == 2 * 3 * per_graph
            and launches["relu_pool2_fwd.vector"] == 2 * 3 * (per_graph + 1),
            f"chunked world wrapper counts {launches} (want {per_graph} steps and one "
            f"eval batch a worker)")
    fresh = ParameterServer(get_model("alexnet", seed=0, device="cpu"), ckpt_dir=SMOKE_PS_DIR,
                            wal=True)
    require(fresh.maybe_restore(), "nothing to restore")
    require(np.array_equal(fresh.central, srv.central) and fresh._apply_seq == srv._apply_seq
            and fresh.staleness.version == srv.staleness.version,
            "the restored server differs from the chunked world's final state")
    fresh.wal.close()
    return {"workers": 2, "batch": 64, "wall_s": wall, "dispatch": "chunked",
            "per_worker": per_worker, "per_step_per_worker": per_step_workers,
            "server_messages": counts, "apply_seq": srv._apply_seq,
            "quarantined": srv.quarantined, "wal_records_replayed": fresh.replayed_updates,
            "restored_bit_equal": True, "wrapper_counts": {
                k: v for k, v in launches.items() if v}}


def phase_chunked_worker(torch, per_step_workers):
    """Phase 15: the chunked DownPour worker, under deterministic cuDNN in
    full float32; returns (c)'s per-worker rates and (b)'s busy ms a step."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32

    full_float32()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        versus = _chunked_vs_per_step(torch)
        emit({"phase": "chunked_worker_vs_per_step", "ok": True, **versus})
        world = _chunked_world(torch, per_step_workers)
        emit({"phase": "chunked_worker_world", "ok": True, **world})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return world["per_worker"], versus["busy_ms_per_step"]


# ------------------------------------------------------------------ phase 16

#: (a)'s server directory (emptied first: the log is opened for appending);
#: the other worlds' beside it
SMOKE_PS_MP_DIR = os.path.join(ROOT, "build", "smoke_ps_mp")
#: phase 16's worlds, in the order they run: (letter, phase name, wire
#: flags, reliable, the transport under the reliable layer). (a) and (b)
#: differ in two things at once; (e) and (f) take one of them each, so the
#: four together part the native transport's share from the reliable
#: layer's
PS_WORLDS = [
    ("a", "ps_processes_reliable_native", ["--transport", "native", "--reliable"], True,
     "NativeTCPTransport"),
    ("b", "ps_processes_plain_python", ["--transport", "python"], False, "TCPTransport"),
    ("e", "ps_processes_plain_native", ["--transport", "native"], False,
     "NativeTCPTransport"),
    ("f", "ps_processes_reliable_python", ["--transport", "python", "--reliable"], True,
     "TCPTransport"),
]
#: seconds a phase-16 process may take
PS_PROCESS_TIMEOUT_S = 300

#: one rank of the PS world: ``python -c _PS_RANK_SRC <json argv> <central
#: path>``. Calls the CLI's entry ``run_ps_process`` with every kernel count
#: zeroed just before, wrapping (never replacing) the functions it calls to
#: see the transport, the server, the worker's log and its chunk step, and
#: prints one JSON line last.
_PS_RANK_SRC = r"""
import json, sys, time
import numpy as np
import torch
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
from distributed_ml_pytorch_tpu_torch.utils import compress, health, wal
from distributed_ml_pytorch_tpu_torch.utils import messaging as msg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

args = build_parser().parse_args(json.loads(sys.argv[1]))
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
seen = {"pushes": 0, "frames": set()}
PUSHES = (MessageCode.GradientUpdate, MessageCode.CompressedUpdate)
#: host ms of each call of the plane's functions: the worker's encode, the
#: server's decode, Adasum, admission, log append and whole handling of one
#: push (decode apart), a pull's reply and a log group's commit
host_ms = {"encode": [], "decode": [], "adasum": [], "admission": [], "wal_append": [],
           "push_handle": [], "pull_reply": [], "commit": []}
#: the wall-clock second each push handling started (server) and each push
#: left (worker): the server's queue is the pushes sent and not yet handled
push_t = []

def timed(mod, name, key):
    real = getattr(mod, name)
    def wrapped(*a, **k):
        if key == "push_handle":
            push_t.append(time.time())
        t0 = time.perf_counter()
        out = real(*a, **k)
        host_ms[key].append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(mod, name, wrapped)

timed(compress.CompressingEncoder, "encode_range", "encode")
timed(tps, "decode_update", "decode")
timed(tps, "adasum_adjust", "adasum")
timed(tps.ParameterServer, "_apply_update", "push_handle")
timed(tps.ParameterServer, "_reply", "pull_reply")
timed(tps.ParameterServer, "_reply_delta", "pull_reply")
timed(tps.ParameterServer, "commit", "commit")
timed(health.GradientAdmission, "evaluate", "admission")
timed(wal.WriteAheadLog, "append", "wal_append")

def wrap(mod, name, after):
    real = getattr(mod, name)
    def wrapped(*a, **k):
        out = real(*a, **k)
        after(out)
        return out
    setattr(mod, name, wrapped)

wrap(msg, "make_transport", lambda t: seen.setdefault("transport", t))
wrap(tps, "run_server", lambda srv: seen.setdefault("server", srv))
wrap(tps, "train_worker", lambda out: seen.setdefault("logger", out[1]))
wrap(tps, "_chunk_step_cache", lambda step: seen.setdefault("chunk", step))
real_send = tps.Asynchronous._send

def counting_send(self, code, payload):
    if code == MessageCode.GradientUpdate:
        seen["pushes"] += 1
        push_t.append(time.time())
    return real_send(self, code, payload)

real_sendv = tps.Asynchronous._sendv

def counting_sendv(self, code, parts):
    if code == MessageCode.CompressedUpdate:
        seen["pushes"] += 1
        push_t.append(time.time())
        seen["frames"].add(sum(int(np.asarray(p).size) for p in parts))
        seen["opt"] = self
    return real_sendv(self, code, parts)

tps.Asynchronous._send = counting_send
tps.Asynchronous._sendv = counting_sendv
fu.launches = 0
for k in fc.launches:
    fc.launches[k] = 0
rc = tps.run_ps_process(args)
t = seen["transport"]
inner = getattr(t, "inner", t)
line = {"rank": args.rank, "rc": rc, "transport": type(t).__name__,
        "inner": type(inner).__name__, "stats": getattr(t, "stats", None),
        "host_ms": {k: (None if not v else {"n": len(v), "mean": sum(v) / len(v),
                                            "max": max(v), "total": sum(v)})
                    for k, v in host_ms.items()},
        "max_ack_s": getattr(t, "max_ack_wait", None),
        "min_ack_slack_s": getattr(t, "min_ack_slack", None),
        "ack_floor_s": getattr(t, "ack_timeout", None), "push_t": push_t,
        "expired": list(getattr(t, "expired", ())),
        # the reliable layer's timeout state per peer at the end of the run
        "peers": {str(d): {"srtt": st.srtt, "rto": st.rto}
                  for d, st in (t._peers.items() if t is not inner else ())}}
if "server" in seen:
    srv = seen["server"]
    np.save(sys.argv[2], srv.central)
    line.update(message_counts={c.name: n for c, n in srv.message_counts.items() if n},
                apply_seq=srv._apply_seq, version=srv.staleness.version,
                quarantined=srv.quarantined, dropped=srv.dropped_bad_updates,
                combine=srv.combine,
                applied_by_sender={str(k): v for k, v in srv.applied_by_sender.items()},
                recent_envelopes=len(srv._recent_envelopes))
else:
    recs = seen["logger"].records
    enc = seen["opt"].encoder if "opt" in seen else None
    line.update(launches={"flat_axpy": fu.launches, **fc.launches},
                captures=seen["chunk"].graphed.captures, pushes_sent=seen["pushes"],
                acked_pushes=(sum(t.acked_count(0, c) for c in PUSHES)
                              if hasattr(t, "acked_count") else None),
                frame_floats=sorted(seen["frames"]),
                encoder=None if enc is None else {
                    "pushes": enc.pushes, "ratio": enc.compression_ratio(),
                    "residual_resets": enc.residual_resets},
                t=[r["timestamp"].timestamp() for r in recs],
                loss=[r["training_loss"] for r in recs])
print("PS_RANK " + json.dumps(line), flush=True)
"""


def _ps_processes(wire, ckpt_dir, backend="cuda", model="alexnet", steps=WORKER_STEPS,
                  batch=64):
    """One server and two worker processes over TCP on a free port, every
    process from :data:`_PS_RANK_SRC` with phase 15 (c)'s recipe plus
    ``--wal --admission --ckpt-dir ckpt_dir`` and ``wire`` (the transport
    flags and any others), through :func:`_run_ranks`."""
    import shutil
    import socket

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("", 0))
        port = str(s.getsockname()[1])
    common = ["--mode", "ps", "--world-size", "3", "--port", port, "--backend", backend,
              "--model", model, "--epochs", "1", "--synthetic-data",
              "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
              "--batch-size", str(batch), "--lr", "0.008", "--num-push", "10",
              "--num-pull", "10", "--log-interval", str(10 * steps), "--worker-timeout", "0",
              "--log-dir", ckpt_dir + "_runs", "--chunked-dispatch", "on", "--wal",
              "--admission", "--ckpt-dir", ckpt_dir, *wire]
    return _run_ranks(_PS_RANK_SRC, {
        rank: (common + ["--rank", str(rank)] + (["--server"] if rank == 0 else []),
               ckpt_dir + ".central.npy") for rank in (0, 1, 2)})


def _run_ranks(src, ranks):
    """Start one process a rank at once, ``python -c src <json argv>
    <central path>`` from ``ranks = {rank: (argv, central path)}``, and
    collect each one's last ``PS_RANK`` JSON line. Returns ``({rank: line},
    wall_s)``; a process that exits non-zero, prints no line or outlives
    :data:`PS_PROCESS_TIMEOUT_S` fails the phase (the others are killed)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    procs = {rank: subprocess.Popen([sys.executable, "-c", src, json.dumps(argv), central],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for rank, (argv, central) in ranks.items()}
    lines, failed = {}, []
    try:
        for rank, p in procs.items():
            try:
                out, err = p.communicate(timeout=PS_PROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} did not finish in {PS_PROCESS_TIMEOUT_S} s")
                break
            found = [ln for ln in out.splitlines() if ln.startswith("PS_RANK ")]
            if p.returncode != 0 or not found:
                failed.append(f"rank {rank} exited {p.returncode}: {err[-3000:]}")
                break
            lines[rank] = json.loads(found[-1][len("PS_RANK "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    require(not failed, "; ".join(failed))
    return lines, time.monotonic() - t0


def _ps_world_checks(lines, reliable, steps=WORKER_STEPS, backend="cuda"):
    """(a)'s and (b)'s checks; returns the per-worker summary."""
    from distributed_ml_pytorch_tpu_torch.training.trainer import GRAPH_WARMUP_STEPS

    srv = lines[0]
    workers = {r: lines[r] for r in (1, 2)}
    applied = sum(srv["message_counts"].get(c, 0) for c in ("GradientUpdate", "CompressedUpdate"))
    sent = sum(w["pushes_sent"] for w in workers.values())
    require(srv["quarantined"] == 0, f"{srv['quarantined']} pushes quarantined")
    require(srv["dropped"] == 0, f"{srv['dropped']} pushes dropped as malformed")
    require(applied == srv["apply_seq"] == sent,
            f"applied {applied}, apply_seq {srv['apply_seq']}, sent {sent}")
    require(all(ln["rc"] == 0 for ln in lines.values()), "a rank returned non-zero")
    s = _steady_record(steps)
    per_worker = {}
    per_graph = GRAPH_WARMUP_STEPS + 1
    for r, w in workers.items():
        loss, t = w["loss"], w["t"]
        require(len(loss) == steps, f"worker {r} logged {len(loss)} of {steps} steps")
        early, late = sum(loss[:10]) / 10, sum(loss[-10:]) / 10
        require(late < early, f"worker {r} loss did not fall: {early} -> {late}")
        if backend == "cuda":
            require(w["captures"] == 1, f"worker {r} captured {w['captures']} graphs, not 1")
            n = w["launches"]
            require(n["flat_axpy"] == per_graph
                    and n["relu_pool2_bwd.vector"] == 3 * per_graph
                    and n["relu_pool2_fwd.vector"] == 3 * (per_graph + 1),
                    f"worker {r} wrapper counts {n} (want {per_graph} steps and one eval "
                    f"batch)")
        steady = (len(t) - 1 - s) / (t[-1] - t[s])
        per_worker[r] = {"steps": len(loss), "early_loss": early, "late_loss": late,
                         "steady_from_step": s + 1, "steady_steps_per_s": steady,
                         "steady_images_per_s": steady * 64, "pushes_sent": w["pushes_sent"],
                         "captures": w["captures"],
                         "wrapper_counts": {k: v for k, v in w["launches"].items() if v}}
        if reliable:
            st = w["stats"]
            per_worker[r].update(acked_pushes=w["acked_pushes"], **{
                k: st.get(k) for k in ("sent", "rto_expired", "retries", "dup_dropped",
                                       "crc_dropped", "gave_up", "window_blocked",
                                       "window_blocked_s", "credit_blocked",
                                       "credit_blocked_s")})
    if reliable:
        acked = sum(w["acked_pushes"] for w in workers.values())
        require(acked == applied, f"acked pushes {acked} != applied {applied}")
        for r, ln in lines.items():
            require(ln["stats"]["gave_up"] == 0 and ln["stats"]["crc_dropped"] == 0,
                    f"rank {r} reliable stats {ln['stats']}")
            # a loss-free wire: a timeout, a retransmit or a duplicate is a fault
            st = ln["stats"]
            require(st["rto_expired"] == 0 and st["retries"] == 0 and st["dup_dropped"] == 0,
                    f"rank {r} timed out on a loss-free wire (longest ack wait "
                    f"{ln['max_ack_s']} s): {st}; every rank's (stats, longest ack wait, "
                    f"timeouts): " + str({q: (lq["stats"], lq["max_ack_s"], lq.get("expired"))
                                          for q, lq in lines.items()}))
            require(ln["transport"] == "ReliableTransport", f"rank {r}: {ln['transport']}")
    return per_worker


def _ps_world_line(lines, reliable, wall, in_process, steps=WORKER_STEPS, backend="cuda"):
    per_worker = _ps_world_checks(lines, reliable, steps, backend)
    srv = lines[0]
    return {"workers": 2, "batch": 64, "wall_s": wall, "processes": 3,
            "transport": {r: [ln["transport"], ln["inner"]] for r, ln in lines.items()},
            "per_worker": per_worker, "in_process_per_worker_15c": in_process,
            "server_messages": srv["message_counts"], "apply_seq": srv["apply_seq"],
            "quarantined": srv["quarantined"], "server_stats": srv["stats"],
            "peer_timeouts": {r: ln["peers"] for r, ln in lines.items() if ln["peers"]},
            "max_ack_s": {r: ln["max_ack_s"] for r, ln in lines.items()},
            "min_ack_slack_s": {r: ln["min_ack_slack_s"] for r, ln in lines.items()},
            "host_ms": {r: {k: v for k, v in ln["host_ms"].items() if v}
                        for r, ln in lines.items()}}


def phase_ps_processes(torch, in_process, backend="cuda", model="alexnet",
                       steps=WORKER_STEPS, bench=True):
    """Phase 16: the DownPour world as processes, (a)-(f); with ``bench``,
    (d) ``bench_all --legs ps``. Returns the device-cycle record (None
    without ``bench``) and (a)'s per-worker summary."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        InProcessTransport,
        ReliableTransport,
    )

    srv = None
    for letter, name, wire, reliable, inner in PS_WORLDS:
        ckpt_dir = SMOKE_PS_MP_DIR if letter == "a" else f"{SMOKE_PS_MP_DIR}_{letter}"
        lines, wall = _ps_processes(wire, ckpt_dir, backend, model, steps)
        for r, ln in lines.items():
            require(ln["inner"] == inner, f"({letter}) rank {r} runs {ln['inner']}")
            require(reliable or ln["transport"] == inner,
                    f"({letter}) rank {r} runs {ln['transport']}")
        line = _ps_world_line(lines, reliable, wall, in_process, steps, backend)
        emit({"phase": name, "ok": True, "world": letter, **line})
        if letter == "a":
            srv, dense_16a = lines[0], line["per_worker"]
    # (c) restore (a)'s directory into a fresh server on a reliable transport
    t = ReliableTransport(InProcessTransport.create_world(3)[0], ack_on_delivery=False)
    fresh = ParameterServer(get_model(model, seed=0, device="cpu"), transport=t,
                            ckpt_dir=SMOKE_PS_MP_DIR, wal=True)
    try:
        require(fresh.maybe_restore(), "nothing to restore")
        central = np.load(SMOKE_PS_MP_DIR + ".central.npy")
        require(np.array_equal(fresh.central, central)
                and fresh._apply_seq == srv["apply_seq"]
                and fresh.staleness.version == srv["version"],
                "the restored server differs from (a)'s final state")
        seeded = {r: len(t._seen.get(r, ())) for r in (1, 2)}
        require(len(fresh._recent_envelopes) == srv["recent_envelopes"] > 0
                and all(seeded.values()),
                f"dedup not seeded from the envelopes: {seeded}")
    finally:
        fresh.wal.close()
        t.detach()
    emit({"phase": "ps_processes_restore", "ok": True, "restored_bit_equal": True,
          "apply_seq": fresh._apply_seq, "envelopes": len(fresh._recent_envelopes),
          "dedup_seeded_per_sender": seeded})
    if bench:
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.bench_all",
                               "--legs", "ps"], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        require(proc.returncode == 0, f"bench_all --legs ps exited {proc.returncode}: "
                                      f"{proc.stderr[-3000:]}")
        records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        require(len(records) == 5, f"bench_all --legs ps printed {len(records)} records")
        cycle = records[-1]
        # the device cycle: one capture serves both run lengths, and K1 is
        # counted at the two warm-up steps and the capture (not the replays)
        require(cycle["metric"] == "async_ps_chunked_device_cycle" and cycle["value"] > 0
                and cycle["captures"] == 1 and cycle["k1_launches"] == 3,
                f"the device cycle's record: {cycle}")
        emit({"phase": "ps_bench_legs", "ok": True, "records": records})
        return cycle, dense_16a
    return None, dense_16a


# ------------------------------------------------------------------ phase 17

#: the sharded world's shard servers' directories (``<dir>/shard<s>``)
SMOKE_SHARDED_DIR = os.path.join(ROOT, "build", "smoke_sharded")
#: shard servers in phase 17's world, then in its one-shard comparison
N_SHARDS, N_SHARDS_COMPARED = 2, 1
#: the window of phase 17's steady rate: steps 40-79
SHARDED_STEADY_FROM = 40

#: one rank of the sharded world: ``python -c _SHARDED_RANK_SRC <json argv>
#: <central path>``. Calls the CLI's entry ``run_sharded_ps_process`` with
#: every kernel count zeroed just before, wrapping (never replacing) the
#: functions it calls to see each transport, the shard server, the worker's
#: log and each shard's pushes, and prints one JSON line last.
_SHARDED_RANK_SRC = r"""
import json, sys
import numpy as np
import torch
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel import sharded_ps as sps
from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
from distributed_ml_pytorch_tpu_torch.utils import messaging as msg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

args = build_parser().parse_args(json.loads(sys.argv[1]))
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
seen = {"transports": [], "pushes": [0] * args.n_servers,
        "frames": [set() for _ in range(args.n_servers)]}
PUSHES = (MessageCode.GradientUpdate, MessageCode.CompressedUpdate)

def wrap(mod, name, after):
    real = getattr(mod, name)
    def wrapped(*a, **k):
        out = real(*a, **k)
        after(out)
        return out
    setattr(mod, name, wrapped)

wrap(msg, "make_transport", seen["transports"].append)
wrap(sps, "make_shard_server", lambda srv: seen.setdefault("server", srv))
wrap(tps, "train_worker", lambda out: seen.setdefault("logger", out[1]))
real_send = sps.ShardedAsynchronous._send

def counting_send(self, shard, code, payload):
    if code == MessageCode.GradientUpdate and not self.shard_down[shard]:
        seen["pushes"][shard] += 1
    return real_send(self, shard, code, payload)

real_sendv = sps.ShardedAsynchronous._sendv

def counting_sendv(self, shard, code, parts):
    if code == MessageCode.CompressedUpdate and not self.shard_down[shard]:
        seen["pushes"][shard] += 1
        seen["frames"][shard].add(sum(int(np.asarray(p).size) for p in parts))
    return real_sendv(self, shard, code, parts)

sps.ShardedAsynchronous._send = counting_send
sps.ShardedAsynchronous._sendv = counting_sendv
fu.launches = 0
for k in fc.launches:
    fc.launches[k] = 0
rc = sps.run_sharded_ps_process(args)
links = [{"transport": type(t).__name__, "inner": type(getattr(t, "inner", t)).__name__,
          "stats": getattr(t, "stats", None), "max_ack_s": getattr(t, "max_ack_wait", None),
          "acked_pushes": (sum(t.acked_count(0, c) for c in PUSHES)
                           if hasattr(t, "acked_count") else None)}
         for t in seen["transports"]]
line = {"rank": args.rank, "rc": rc, "links": links}
if "server" in seen:
    srv = seen["server"]
    np.save(sys.argv[2], srv.central)
    line.update(message_counts={c.name: n for c, n in srv.message_counts.items() if n},
                apply_seq=srv._apply_seq, version=srv.staleness.version,
                quarantined=srv.quarantined, dropped=srv.dropped_bad_updates,
                held=int(srv.central.shape[0]))
    if srv.optimizer is not None:
        opt = srv.optimizer
        np.save(sys.argv[2] + ".m.npy", opt.m)
        np.save(sys.argv[2] + ".v.npy", opt.v)
        line.update(optimizer={"kind": opt.kind, "lo": opt.lo, "hi": opt.hi, "t": opt.t,
                               "state_floats": opt.state_floats()})
else:
    recs = seen["logger"].records
    line.update(launches={"flat_axpy": fu.launches, **fc.launches},
                pushes_sent=seen["pushes"], frame_floats=[sorted(f) for f in seen["frames"]],
                t=[r["timestamp"].timestamp() for r in recs],
                loss=[r["training_loss"] for r in recs])
print("PS_RANK " + json.dumps(line), flush=True)
"""


def _sharded_processes(k, ckpt_dir, backend="cuda", model="alexnet", steps=WORKER_STEPS,
                       batch=64, extra=()):
    """The sharded world: ``k`` shard-server processes and two worker
    processes over TCP (``--world-size k+2 --n-servers k``, ports ``port``
    to ``port + k - 1``), each from :data:`_SHARDED_RANK_SRC`, with phase 16
    (a)'s recipe per step and the flags ``extra``, through
    :func:`_run_ranks`."""
    import shutil

    from distributed_ml_pytorch_tpu_torch.launch import _free_port_block

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    port = _free_port_block(k)
    common = ["--mode", "ps", "--world-size", str(k + 2), "--n-servers",
              str(k), "--port", port, "--backend", backend, "--model", model,
              "--epochs", "1",
              "--synthetic-data", "--synthetic-train-size", str(steps * batch),
              "--synthetic-test-size", "512", "--batch-size", str(batch), "--lr", "0.008",
              "--num-push", "10", "--num-pull", "10", "--log-interval", str(10 * steps),
              "--worker-timeout", "0", "--log-dir", ckpt_dir + "_runs",
              "--transport", "native", "--reliable", "--wal", "--admission",
              "--ckpt-dir", ckpt_dir, *extra]
    return _run_ranks(_SHARDED_RANK_SRC, {
        rank: (common + ["--rank", str(rank)] + (["--server"] if rank < k else []),
               f"{ckpt_dir}.central{rank}.npy") for rank in range(k + 2)})


def _sharded_world(k, ckpt_dir, n_params, per_step_workers, launches, backend, model, steps,
                   extra=()):
    """One sharded world of :func:`_sharded_processes` (with the flags
    ``extra``) and its checks; adds the workers' kernel launches to
    ``launches``; returns ``(lines, line)``: every rank's line and the phase
    line."""
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import shard_ranges

    lines, wall = _sharded_processes(k, ckpt_dir, backend, model, steps, extra=extra)
    ranges = shard_ranges(n_params, k)
    workers = {r: lines[r] for r in range(k, k + 2)}
    require(all(ln["rc"] == 0 for ln in lines.values()), "a rank returned non-zero")
    for r, ln in lines.items():
        for s, link in enumerate(ln["links"]):
            require(link["transport"] == "ReliableTransport"
                    and link["inner"] == "NativeTCPTransport",
                    f"rank {r} link {s} runs {link['transport']} over {link['inner']}")
            st = link["stats"]
            require(st["gave_up"] == 0 and st["crc_dropped"] == 0,
                    f"rank {r} link {s} gave up or dropped on the checksum: {st}")
            require(st["rto_expired"] == 0 and st["retries"] == 0 and st["dup_dropped"] == 0,
                    f"rank {r} link {s} timed out on a loss-free wire (longest ack wait "
                    f"{link['max_ack_s']} s): {st}")
    shards = {}
    for s, (lo, hi) in enumerate(ranges):
        srv = lines[s]
        applied = sum(srv["message_counts"].get(c, 0)
                      for c in ("GradientUpdate", "CompressedUpdate"))
        sent = sum(w["pushes_sent"][s] for w in workers.values())
        acked = sum(w["links"][s]["acked_pushes"] for w in workers.values())
        require(srv["quarantined"] == 0, f"shard {s}: {srv['quarantined']} quarantined")
        require(applied == srv["apply_seq"] == sent == acked,
                f"shard {s}: applied {applied}, apply_seq {srv['apply_seq']}, sent {sent}, "
                f"acked {acked}")
        require(srv["held"] == hi - lo, f"shard {s} holds {srv['held']}, not {hi - lo}")
        require(srv["dropped"] == 0, f"shard {s} dropped {srv['dropped']} pushes")
        shards[s] = {"range": [lo, hi], "applied": applied, "sent": sent, "acked": acked,
                     "messages": srv["message_counts"], "version": srv["version"],
                     "stats": srv["links"][0]["stats"], "max_ack_s": srv["links"][0]["max_ack_s"]}
    per_worker = {}
    s0 = _steady_record(steps)
    for r, w in workers.items():
        loss, t, n = w["loss"], w["t"], w["launches"]
        require(len(loss) == steps, f"worker {r} logged {len(loss)} of {steps} steps")
        early, late = sum(loss[:10]) / 10, sum(loss[-10:]) / 10
        require(late < early, f"worker {r} loss did not fall: {early} -> {late}")
        if backend == "cuda":
            # one step a dispatch: K1 once a step, K2 three a step, plus the
            # final eval's forward (one batch of 512)
            require(n["flat_axpy"] == steps and n["relu_pool2_bwd.vector"] == 3 * steps
                    and n["relu_pool2_fwd.vector"] == 3 * (steps + 1),
                    f"worker {r} wrapper counts {n} (want the per-step path's)")
        for name, v in n.items():
            launches[name] = launches.get(name, 0) + v
        s40 = SHARDED_STEADY_FROM - 1
        per_worker[r] = {
            "early_loss": early, "late_loss": late, "pushes_sent": w["pushes_sent"],
            "steady_steps_per_s_40_79": (len(t) - 1 - s40) / (t[-1] - t[s40]),
            "steady_steps_per_s": (len(t) - 1 - s0) / (t[-1] - t[s0]),
            "phase4_per_step_steady_steps_per_s":
                (per_step_workers or {}).get(r - k + 1, {}).get("steady_steps_per_s"),
            "wrapper_counts": {name: v for name, v in n.items() if v},
            "links": [{key: link[key] for key in ("stats", "max_ack_s", "acked_pushes")}
                      for link in w["links"]]}
    return lines, {"shards": k, "workers": 2, "batch": 64, "wall_s": wall,
                   "per_shard": shards, "per_worker": per_worker}


def phase_sharded_processes(torch, per_step_workers, backend="cuda", model="alexnet",
                            steps=WORKER_STEPS, bench=True):
    """Phase 17: the sharded DownPour world as processes, then the same
    world with one shard (what sharding itself costs the workers); returns
    the workers' summed kernel launch counts."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import make_shard_server
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    host_model = get_model(model, seed=0, device="cpu")
    n_params, launches = flat_size(host_model), {}
    lines, line = _sharded_world(N_SHARDS, SMOKE_SHARDED_DIR, n_params, per_step_workers,
                                 launches, backend, model, steps)
    emit({"phase": "sharded_processes", "ok": True, **line})
    _lines, line = _sharded_world(N_SHARDS_COMPARED, SMOKE_SHARDED_DIR + "_k1", n_params,
                                  per_step_workers, launches, backend, model, steps)
    emit({"phase": "sharded_processes_one_shard", "ok": True, **line})
    # a fresh pair of shard servers restores each directory bit for bit
    restored = {}
    for s in range(N_SHARDS):
        fresh = make_shard_server(host_model, shard=s, n_shards=N_SHARDS,
                                  ckpt_dir=f"{SMOKE_SHARDED_DIR}/shard{s}", wal=True)
        try:
            require(fresh.maybe_restore(), f"shard {s}: nothing to restore")
            central = np.load(f"{SMOKE_SHARDED_DIR}.central{s}.npy")
            require(np.array_equal(fresh.central, central)
                    and fresh._apply_seq == lines[s]["apply_seq"]
                    and fresh.staleness.version == lines[s]["version"],
                    f"the restored shard {s} differs from its final state")
        finally:
            fresh.wal.close()
        restored[s] = {"apply_seq": fresh._apply_seq, "version": fresh.staleness.version}
    emit({"phase": "sharded_restore", "ok": True, "restored_bit_equal": True,
          "shards": restored})
    if not bench:
        return launches
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for legs, count in (("sharded_ps", 8), ("transport", 2)):
        proc = subprocess.run([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.bench_all",
                               "--legs", legs], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        require(proc.returncode == 0, f"bench_all --legs {legs} exited {proc.returncode}: "
                                      f"{proc.stderr[-3000:]}")
        records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        require(len(records) == count,
                f"bench_all --legs {legs} printed {len(records)} records, not {count}")
        emit({"phase": f"{legs}_bench_leg", "ok": True, "records": records})
    return launches


# ------------------------------------------------------------------ phase 18

#: ``train_lm`` at GPT-2-small width on 4 x 32768 tokens: the flash size
#: rule picks the split backward by itself there (its dQ-partials count,
#: 32 key blocks x 4 x 12 x 32768 x 64 x 4 B = 12.9 GB, passes the 6 GiB cap;
#: at 1 x 32768 it is half the cap and the rule keeps the fused K5)
LONG_TRAIN = ["--vocab", "50304", "--d-model", "768", "--n-heads", "12", "--n-layers", "12",
              "--d-ff", "3072", "--dtype", "bfloat16", "--pos-encoding", "rope",
              "--batch", "4", "--seq", "32768", "--remat", "--loss-chunk", "2048",
              "--steps", "2"]
#: the widths and lengths of a CPU rehearsal of phases 18 and 19 (``tiny``)
TINY_LM_ARGS = ["--vocab", "128", "--d-model", "64", "--n-heads", "2", "--n-layers", "2",
                "--d-ff", "128", "--dtype", "bfloat16", "--pos-encoding", "rope"]
TINY_LONG_TRAIN = [*TINY_LM_ARGS, "--batch", "4", "--seq", "256", "--remat", "--loss-chunk",
                   "64", "--steps", "2"]
#: query rows the plain side computes at a time (a 32768-key score block of
#: 2048 rows is 256 MiB in float32)
LONG_ROWS = 2048
#: the tensor-core kernels' launch and the long check's timed calls
LONG_ITERS = 3


def _record_first_call(torch, at, name):
    """Wrap ``ops.attention``'s ``name`` (the autograd backward looks it up
    there at each call): the arguments of its first call, one layer's
    attention inside a step, are kept in the returned dict; every call goes
    through. Returns ``(seen, restore)``."""
    real = getattr(at, name)
    seen = {}

    def wrapper(*args):
        # detached: the plain side must build no autograd graph on them
        seen.setdefault("args", tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                      for a in args))
        return real(*args)

    setattr(at, name, wrapper)
    return seen, lambda: setattr(at, name, real)


def _long_check(torch, at, args, kernels):
    """Each of ``kernels`` on one layer's captured ``(q, k, v, do, lse2,
    delta, causal)`` against the plain versions computed LONG_ROWS query
    rows at a time (``ops.attention.flash_plain_rows``) over every query
    and key of the first and the last (b, h), within ATTN_TOL / LSE_TOL;
    then each kernel timed on all heads. Raises on a miss; returns the
    errors and times."""
    q, k, v, do, lse2, delta, causal = args
    tol = ATTN_TOL["float32" if q.dtype == torch.float32 else "bfloat16"]
    got = {}
    if "flash_fwd" in kernels:
        got["flash_fwd"] = dict(zip(("out", "lse"), at.flash_fwd_cuda(q, k, v, causal)))
    if "flash_bwd_fused" in kernels:
        got["flash_bwd_fused"] = dict(zip(("dq", "dk", "dv"), at.flash_bwd_fused_cuda(*args)))
    if "flash_bwd_dq" in kernels:
        got["flash_bwd_dq"] = {"dq": at.flash_bwd_dq_cuda(*args)}
    if "flash_bwd_dkv" in kernels:
        got["flash_bwd_dkv"] = dict(zip(("dk", "dv"), at.flash_bwd_dkv_cuda(*args)))
    errs, misses = {kern: {} for kern in got}, []
    t0 = time.monotonic()
    for h in (0, q.shape[0] - 1):
        one = [t[h:h + 1] for t in (q, k, v, do, lse2, delta)]
        ref = at.flash_plain_rows(*one, causal, LONG_ROWS)
        for kern, outs in got.items():
            for name, t in outs.items():
                mine = t[h:h + 1]
                require(bool(torch.isfinite(mine.float()).all()),
                        f"{kern} {name} not finite at (b·h) {h} of {tuple(q.shape)}")
                scale, t_ = ((ref["lse"].abs(), LSE_TOL) if name == "lse"
                             else (ref["scales"][name], tol))
                mx, rel, ok = _err(torch, mine, ref[name], scale, t_)
                prev = errs[kern].get(name, (0.0, 0.0))
                errs[kern][name] = (max(prev[0], mx), max(prev[1], rel))
                if not ok:
                    misses.append(f"{kern} {name} (b·h {h}): max abs err {mx}, "
                                  f"max err / scale {rel}, (atol, rtol) {t_}")
        del ref
    require(not misses, f"kernel != plain at {tuple(q.shape)}: {'; '.join(misses)}")
    check_s = time.monotonic() - t0
    del got
    timed = {"flash_fwd": lambda: at.flash_fwd_cuda(q, k, v, causal)[0],
             "flash_bwd_fused": lambda: at.flash_bwd_fused_cuda(*args)[0],
             "flash_bwd_dq": lambda: at.flash_bwd_dq_cuda(*args),
             "flash_bwd_dkv": lambda: at.flash_bwd_dkv_cuda(*args)[0]}
    ms = {kern: device_ms(timed[kern], LONG_ITERS) for kern in kernels}
    return errs, ms, check_s


def _long_sdpa_ms(torch, args):
    """The library yardstick on one layer's captured tensors: SDPA's
    forward, and its backward alone (retained graph), ms on the card;
    ``None`` off it."""
    q, k, v, do, _lse2, _delta, causal = args
    if not q.is_cuda:
        return None
    F = torch.nn.functional
    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    return {"fwd": device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                    is_causal=causal),
                             LONG_ITERS),
            "bwd": device_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                         retain_graph=True), LONG_ITERS)}


def _long_bounds(shape) -> dict:
    """Each attention kernel's least time at ``(b, h, s, d)`` causal bf16:
    the larger of its products over the causal score plane at the bf16 peak
    and its bytes (inputs read once, outputs written once) at 3.35 TB/s."""
    from distributed_ml_pytorch_tpu_torch.utils.flops import flash_attention_train_flops

    b, h, s, d = shape
    unit = flash_attention_train_flops(b, h, s, d, 1, causal=True, bwd_impl="fused") / 7
    out = {}
    for kern, products in (("flash_fwd", 2), ("flash_bwd_fused", 5), ("flash_bwd_dq", 3),
                           ("flash_bwd_dkv", 4)):
        flop_ms = products * unit / BF16_FLOPS * 1e3
        byte_ms = bound_ms(_attn_bytes(shape, 2, kern))
        out[kern] = {"bound_ms": max(flop_ms, byte_ms),
                     "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
    return out


def _long_kernel_lines(errs, ms, bounds, per_step, lib=None):
    """Each kernel's time, bound and errors, beside ``lib`` (SDPA's forward
    for K4, its backward for K5 and the K6a + K6b pair) when the card timed
    it."""
    lib = lib or {}
    out = {kern: {"ms": ms[kern], "bound_ms": bounds[kern]["bound_ms"],
                  "bound_by": bounds[kern]["bound_by"],
                  "bound_share": bounds[kern]["bound_ms"] / ms[kern],
                  "launches_per_step": per_step[kern], "errors": errs[kern]}
           for kern in ms}
    for kern, line in out.items():
        ref = lib.get("fwd" if kern == "flash_fwd" else "bwd")
        line["library_ms"] = ref
        line["library"] = "SDPA fwd" if kern == "flash_fwd" else "SDPA bwd (retained graph)"
        line["over_library"] = None if ref is None else line["ms"] / ref
    if lib and "flash_bwd_dq" in out:
        pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
        out["flash_bwd_dq"]["pair_over_library"] = pair / lib["bwd"]
    return out


def _peak_gb(torch, device, reset=False):
    """Peak device memory in GB since the last reset (None on the CPU)."""
    if device != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 1e9


def phase_long_context(torch, device="cuda", tiny=False):
    """Phase 18: (a) ``bench_all --legs lm_32k`` (1 x 32768, fused: K4 and
    K5) and (b) ``train_lm`` at 4 x 32768 (split by the size rule: K4, K6a
    and K6b), each kernel held against its plain version on one layer's
    tensors captured inside the step; returns the launches of both runs and
    each kernel's largest absolute error. ``tiny`` (with ``device="cpu"``)
    rehearses the phase at the tiny widths."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.flops import (
        device_peak_flops,
        lm_train_flops_6nd,
    )

    widths = bench_all.TINY_LM if tiny else bench_all.GPT2_SMALL
    n_layers, heads = widths["n_layers"], widths["n_heads"]
    d = widths["d_model"] // heads
    seq_a = bench_all.TINY_32K_SEQ if tiny else bench_all.LM_32K_SEQ
    peak = device_peak_flops(torch.cuda.get_device_name(0)) if device == "cuda" else None
    total = {name: 0 for name in at.launches}
    worst = {name: 0.0 for name in at.launches}

    def note_errors(errs):
        for kern, tensors in errs.items():
            worst[kern] = max([worst[kern], *(e[0] for e in tensors.values())])

    # (a) the lm_32k leg, as bench_all runs it
    seen, restore = _record_first_call(torch, at, "flash_bwd_fused_cuda")
    _peak_gb(torch, device, reset=True)
    _zero_attention_launches(at)
    try:
        rate = bench_all.lm_32k_phase(device, tiny=tiny)
    finally:
        restore()
    launches = dict(at.launches)
    rec = bench_all.RESULTS[-1]
    losses = rec["losses"]
    steps = len(losses)
    peak_a = _peak_gb(torch, device)
    require(rec["metric"] == "gpt2_small_seq32768_train_throughput",
            f"the lm_32k leg emitted {rec['metric']}")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"lm_32k losses not finite and falling: {losses}")
    require(launches["flash_fwd"] == 2 * n_layers * steps
            and launches["flash_bwd_fused"] == n_layers * steps
            and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
            f"lm_32k ran {launches} for {steps} steps of {n_layers} layers: the size rule "
            "must keep the fused backward at 1 x 32768 (K4 twice a layer under remat)")
    for name in total:
        total[name] += launches[name]
    args = seen.pop("args")
    shape_a = (1, heads, seq_a, d)
    require(tuple(args[0].shape) == (heads, seq_a, d),
            f"captured q of shape {tuple(args[0].shape)}")
    errs, ms, check_s = _long_check(torch, at, args, ("flash_fwd", "flash_bwd_fused"))
    lib_a = _long_sdpa_ms(torch, args)
    note_errors(errs)
    del args
    per_step = {"flash_fwd": 2 * n_layers, "flash_bwd_fused": n_layers}
    leg = {"tokens_per_s": float(rate), "step_ms": rate.step_seconds * 1e3,
           "mfu_bf16": rate.mfu, "flops_per_step": rate.flops_per_step,
           "peak_mem_gb": peak_a, "losses": losses, "steps": steps, "launches": launches,
           "plain_check_s": check_s,
           "kernels": _long_kernel_lines(errs, ms, _long_bounds(shape_a), per_step, lib_a)}
    emit({"phase": "long_context_fused", "ok": True, "shape": shape_a, "bwd_impl": "fused",
          "checked_bh": [0, heads - 1], "plain_rows_at_a_time": LONG_ROWS,
          "tolerance": ATTN_TOL["bfloat16"], "lse_tolerance": LSE_TOL, **leg})

    # (b) train_lm at 4 x 32768: the size rule alone picks K6a + K6b
    args_b = train_lm.parse_args([*(TINY_LONG_TRAIN if tiny else LONG_TRAIN),
                                  "--device", device])
    seen, restore = _record_first_call(torch, at, "flash_bwd_dq_cuda")
    _peak_gb(torch, device, reset=True)
    _zero_attention_launches(at)
    try:
        res = train_lm.run(args_b)
    finally:
        restore()
    launches = dict(at.launches)
    peak_b = _peak_gb(torch, device)
    steps = args_b.steps
    require(all(math.isfinite(x) for x in res.losses) and res.losses[-1] < res.losses[0],
            f"4 x 32768 losses not finite and falling: {res.losses}")
    require(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == n_layers * steps
            and launches["flash_bwd_fused"] == 0
            and launches["flash_fwd"] == 2 * n_layers * steps,
            f"4 x 32768 ran {launches} for {steps} steps: the size rule must pick the split "
            "backward by itself there")
    for name in total:
        total[name] += launches[name]
    args = seen.pop("args")
    shape_b = (args_b.batch, heads, args_b.seq, d)
    require(tuple(args[0].shape) == (args_b.batch * heads, args_b.seq, d),
            f"captured q of shape {tuple(args[0].shape)}")
    errs, ms, check_s = _long_check(torch, at, args,
                                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    lib_b = _long_sdpa_ms(torch, args)
    note_errors(errs)
    del args
    model = res.state.model
    n_params = sum(p.numel() for p in model.parameters())
    embed = sum(p.numel() for n, p in model.named_parameters() if "embed" in n.lower())
    flops = lm_train_flops_6nd(n_params - embed, args_b.batch, args_b.seq, heads, d, n_layers,
                               remat=True, bwd_impl="split")
    step_s = res.steady_s / (steps - 1)
    per_step = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    emit({"phase": "long_context_split", "ok": True, "shape": shape_b, "bwd_impl": "split",
          "picked_by": "the size rule (no bwd_impl injected)",
          "checked_bh": [0, args_b.batch * heads - 1],
          "plain_rows_at_a_time": LONG_ROWS, "tolerance": ATTN_TOL["bfloat16"],
          "tokens_per_s": res.tokens_per_s, "step_ms": step_s * 1e3,
          "mfu_bf16": flops / step_s / peak if peak else None, "flops_per_step": flops,
          "peak_mem_gb": peak_b, "losses": res.losses, "launches": launches,
          "plain_check_s": check_s,
          "kernels": _long_kernel_lines(errs, ms, _long_bounds(shape_b), per_step, lib_b)})
    del res, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return total, worst


# ------------------------------------------------------------------ phase 19

#: phase 19's LM run: GPT-2-small 8 x 2048 bf16 with remat and the chunked
#: loss (torch.utils.checkpoint inside the captured step), K steps a dispatch
LM_K = 4
#: phase 19 runs GPT-2-small widths at 4 of its 12 layers: its depth is cut
#: to keep the whole run's margin under its time limit
LM_K_LAYERS = 4
LM_K_ARGS = [*GPT2_SMALL[:GPT2_SMALL.index("--n-layers")], "--n-layers", str(LM_K_LAYERS),
             *GPT2_SMALL[GPT2_SMALL.index("--n-layers") + 2:], "--remat", "--loss-chunk", "2048",
             "--steps-per-dispatch", str(LM_K), "--steps", str(2 * LM_K),
             "--ckpt-every", str(LM_K)]
TINY_LM_K_ARGS = [*TINY_LM_ARGS, "--batch", "2", "--seq", "128", "--remat", "--loss-chunk",
                  "64", "--steps-per-dispatch", str(LM_K), "--steps", str(2 * LM_K),
                  "--ckpt-every", str(LM_K)]
SMOKE_LM_DIR = os.path.join(ROOT, "build", "smoke_lm")


def _lm_params(model):
    return [p.detach().clone() for p in model.parameters()]


def _lm_eager(torch, args, attn_fn):
    """``2K`` eager steps of the AD step from the same seeded weights on the
    K-step run's batches, in its order: ``(losses, params, peak GB,
    tokens/s over the second K steps on the host clock, ended by reading
    the last loss)``."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    model = train_lm.build_model(args, args.device)
    if attn_fn is not None:
        model.set_attn_fn(attn_fn)
    tx = SGD(args.lr)
    state = create_lm_train_state(model, tx)
    step = make_fsdp_lm_train_step(model, tx, loss_chunk=args.loss_chunk)
    tokens, targets = train_lm.lm_batches(args)
    tok = torch.from_numpy(tokens.astype(np.int64)).to(args.device)
    tgt = torch.from_numpy(targets.astype(np.int64)).to(args.device)
    _peak_gb(torch, args.device, reset=True)
    losses, t0 = [], 0.0
    for j in range(args.steps // LM_K):
        if j == 1:  # the steady rate over the second K, as train_lm reads its dispatches
            float(losses[-1])
            t0 = time.perf_counter()
        losses += [step(state, tok[i], tgt[i])[1] for i in range(LM_K)]
    float(losses[-1])
    rate = (args.steps - LM_K) * args.batch * args.seq / (time.perf_counter() - t0)
    out = (torch.stack(losses).float().cpu(), _lm_params(model),
           _peak_gb(torch, args.device), rate)
    del model, state
    return out


def _lm_k_run(torch, train_lm, argv, attn_fn, ckpt_dir=None):
    """``train_lm.run`` with K steps a dispatch, checkpointing into
    ``ckpt_dir`` if one is given: ``(losses, params, captures, peak GB,
    start step, tokens/s)``."""
    import shutil

    if ckpt_dir is not None:
        if "--resume" not in argv:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        argv = [*argv, "--ckpt-dir", ckpt_dir]
    args = train_lm.parse_args(argv)
    _peak_gb(torch, args.device, reset=True)
    res = train_lm.run(args, attn_fn=attn_fn)
    out = (torch.tensor(res.losses), _lm_params(res.state.model), res.step_fn.graphed.captures,
           _peak_gb(torch, args.device), res.start_step, res.tokens_per_s)
    del res
    return out


def _resume_from_first_checkpoint(torch, train_lm, argv, attn_fn, ckpt_dir):
    """The K-step run's step-K checkpoint restored into a fresh run that
    trains K more steps (the step-2K checkpoint is removed first, so the
    latest is step K): ``(losses, params, start step)``."""
    import shutil

    shutil.rmtree(os.path.join(ckpt_dir, str(2 * LM_K)))
    argv = list(argv)
    argv[argv.index("--steps") + 1] = str(LM_K)
    losses, params, _captures, _peak, start, _rate = _lm_k_run(
        torch, train_lm, [*argv, "--resume"], attn_fn, ckpt_dir)
    return losses, params, start


def phase_lm_flags(torch, device_cycle, device="cuda", tiny=False):
    """Phase 19: ``train_lm --steps-per-dispatch K`` graphed against eager
    (bit for bit with ``bwd_impl="split"`` injected; the fused backward within
    SPLIT_UPDATE_TOL, beside the spread of two eager runs), one capture, and
    a resume from the step-K checkpoint equal to the uninterrupted run; then
    ``bench_all --legs steps_to_accuracy,reliability``. ``device_cycle`` is
    phase 16 (d)'s ``async_ps_chunked_device_cycle`` record. Returns the
    attention launches of the K-step runs. ``tiny`` (with ``device="cpu"``)
    rehearses the phase at the tiny widths (one capture is then none)."""
    import functools

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.training import train_lm

    split = functools.partial(at.flash_attention, causal=True, bwd_impl="split")
    argv = [*(TINY_LM_K_ARGS if tiny else LM_K_ARGS), "--device", device]
    args = train_lm.parse_args(argv)
    out = {}
    total = {name: 0 for name in at.launches}
    for tag, attn_fn in (("split", split), ("fused", None)):
        ckpt_dir = f"{SMOKE_LM_DIR}_{tag}"
        _zero_attention_launches(at)
        g_loss, g_params, captures, g_peak, _, g_rate = _lm_k_run(torch, train_lm, argv,
                                                                  attn_fn, ckpt_dir)
        launches = dict(at.launches)
        for name in total:
            total[name] += launches[name]
        steps = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
        e_loss, e_params, e_peak, e_rate = _lm_eager(torch, args, attn_fn)
        r_loss, r_params, start = _resume_from_first_checkpoint(torch, train_lm, argv, attn_fn,
                                                                ckpt_dir)
        w0 = _lm_params(train_lm.build_model(args, device))
        upd = lambda ps: [p - w for p, w in zip(ps, w0)]
        line = {"captures": captures, "checkpoints": steps, "resumed_from": start,
                "graphed_losses": g_loss.tolist(), "eager_losses": e_loss.tolist(),
                "resumed_losses": r_loss.tolist(),
                "graphed_peak_mem_gb": g_peak, "eager_peak_mem_gb": e_peak,
                "graphed_tokens_per_s": g_rate, "eager_tokens_per_s": e_rate,
                "launches": launches}
        require(captures == (1 if device == "cuda" else 0), f"{tag}: {captures} captures")
        require(steps == [LM_K, 2 * LM_K], f"{tag}: checkpoints at {steps}")
        require(start == LM_K, f"{tag}: resumed from step {start}, not {LM_K}")
        require(bool(torch.isfinite(g_loss).all()) and g_loss[-1] < g_loss[0],
                f"{tag}: graphed losses not finite and falling: {g_loss.tolist()}")
        if tag == "split":
            require(launches["flash_bwd_fused"] == 0 and launches["flash_bwd_dq"] > 0,
                    f"split: {launches}")
            line["graphed_equals_eager"] = (torch.equal(g_loss, e_loss) and all(
                torch.equal(a, b) for a, b in zip(g_params, e_params)))
            line["resumed_equals_uninterrupted"] = (
                torch.equal(r_loss, g_loss[LM_K:])
                and all(torch.equal(a, b) for a, b in zip(r_params, g_params)))
            out[tag] = line
            require(line["graphed_equals_eager"],
                    "split: the graphed K-step run differs from the eager steps")
            require(line["resumed_equals_uninterrupted"],
                    "split: the resumed run differs from the uninterrupted one")
        else:
            require(launches["flash_bwd_fused"] > 0 and launches["flash_bwd_dq"] == 0,
                    f"fused: {launches}")
            e2_loss, e2_params, _, _ = _lm_eager(torch, args, None)
            # the graphed rate without checkpoints (the runs above save 0.5 GB
            # of state at each K-th step inside train_lm's timed dispatches)
            timing = list(argv)
            timing[timing.index("--steps") + 1] = str(4 * LM_K)
            line["graphed_tokens_per_s_without_checkpoints"] = _lm_k_run(
                torch, train_lm, timing, None)[5]
            line["graphed_vs_eager_rel_l2"] = _rel_l2(torch, upd(g_params), upd(e_params))
            line["eager_vs_eager_rel_l2"] = _rel_l2(torch, upd(e2_params), upd(e_params))
            line["resumed_vs_uninterrupted_rel_l2"] = _rel_l2(torch, upd(r_params),
                                                              upd(g_params))
            line["eager_again_losses"] = e2_loss.tolist()
            line["tolerance"] = SPLIT_UPDATE_TOL
            out[tag] = line
            for key in ("graphed_vs_eager_rel_l2", "resumed_vs_uninterrupted_rel_l2"):
                require(line[key] <= SPLIT_UPDATE_TOL,
                        f"fused: {key} {line[key]} > {SPLIT_UPDATE_TOL}")
        del g_params, e_params, r_params, w0
        if device == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "lm_flags", "ok": True, "config": argv, **out})

    # the last main-path bench legs (the device cycle ran in phase 16 (d))
    first = len(bench_all.RESULTS)
    require(bench_all.main(["--legs", "steps_to_accuracy,reliability", "--device", device,
                            *(["--tiny"] if tiny else [])]) == 0,
            "bench_all --legs steps_to_accuracy,reliability failed")
    records = bench_all.RESULTS[first:]
    names = [r["metric"] for r in records]
    require(names == ["steps_to_99pct_test_accuracy",
                      *(f"ps_transport_roundtrip_python_acks_{m}"
                        for m in ("off", "legacy", "on")),
                      "ps_reliability_layer_overhead", "ps_reliability_ack_tax_recovered"],
            f"the legs emitted {names}")
    sta = records[0]
    require(sta["value"] > 0 or (sta["value"] == -1 and "final_accuracy" in sta),
            f"steps_to_accuracy: {sta}")
    emit({"phase": "main_path_bench_legs", "ok": True,
          "records": [device_cycle, *records]})
    return total


# ------------------------------------------------------------------ phase 20

#: phase 20's directories: (a)'s server, (b)'s shard servers (each emptied
#: first)
SMOKE_CODEC_DIR = os.path.join(ROOT, "build", "smoke_codec")
SMOKE_CODEC_SHARDED_DIR = os.path.join(ROOT, "build", "smoke_codec_sharded")
#: (a): phase 16 (a)'s wire, and int8 pushes combined by Adasum
CODEC_WIRE = ["--transport", "native", "--reliable", "--compress", "int8", "--combine",
              "adasum"]
#: (b): phase 17's sharded world, top-k pushes and a server-side sgdm whose
#: steady step is the plain add's (lr / (1 - momentum) = 1)
CODEC_SHARDED = ["--compress", "topk", "--server-opt", "sgdm", "--server-lr", "0.5",
                 "--server-momentum", "0.5"]
CODEC_SHARDS = 2
#: the frame sizes at AlexNet's 2,472,266 floats: an int8 push (2,415 scales,
#: 618,240 words and the 12-float head), a shard's top-k pairs, a steady
#: delta reply (49,445 pairs and the 14-float head) and a full one
ALEXNET_CODEC_SIZES = {"int8_push": 620_667, "shard_topk_pairs": [12_361, 12_361],
                       "delta_reply": 98_904, "full_reply": 2_472_280}
#: bench_all's wire_bytes leg's record count
WIRE_BYTES_RECORDS = 22


def codec_sizes(n: int, k: int = CODEC_SHARDS) -> dict:
    """The frame sizes, in floats, of phase 20's wires over ``n``
    parameters, from the codecs' own arithmetic."""
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import shard_ranges
    from distributed_ml_pytorch_tpu_torch.utils import codecs
    from distributed_ml_pytorch_tpu_torch.utils.compress import HEAD_LEN, make_codec

    topk = make_codec("topk")
    return {"int8_push": HEAD_LEN + make_codec("int8").wire_floats(n),
            "shard_topk_pairs": [topk.k_for(hi - lo) for lo, hi in shard_ranges(n, k)],
            "delta_reply": 14 + codecs.wire_floats("DeltaParams", n),
            "full_reply": 14 + n}


def _idle_share(steps_per_s, busy_ms_per_step):
    """1 - the device's busy share of a worker's steady window, from phase 15
    (b)'s profiled busy ms a step; None where that was not measured."""
    if busy_ms_per_step is None:
        return None
    return 1.0 - steps_per_s * busy_ms_per_step / 1e3


def _add_launches(launches, counts):
    for name, v in counts.items():
        launches[name] = launches.get(name, 0) + v


def _server_queue(lines):
    """The server's side of a process world from its rank lines: the pushes
    a second the workers offered and the server applied (wall clock, first
    to last), the host ms of one push's decode and handling and the rate
    that allows, the queue (pushes sent and not yet handled, at each
    handling's start, that push included), the margin of the workers'
    longest ack wait under the reliable layer's timeout floor, and the least
    time any worker's frame had left before its own timeout when acked."""
    import bisect

    def rate(ts):
        return (len(ts) - 1) / (ts[-1] - ts[0]) if len(ts) > 1 and ts[-1] > ts[0] else None

    handled = lines[0]["push_t"]
    sent = sorted(t for r, ln in lines.items() if r != 0 for t in ln["push_t"])
    depth = [bisect.bisect_right(sent, t) - i for i, t in enumerate(handled)]
    ms = lines[0]["host_ms"]
    busy = sum(ms[k]["mean"] for k in ("decode", "push_handle") if ms.get(k))
    waits = [ln["max_ack_s"] for r, ln in lines.items() if r != 0]
    slack = [ln["min_ack_slack_s"] for r, ln in lines.items() if r != 0]
    floor = lines[0]["ack_floor_s"]
    return {"offered_pushes_per_s": rate(sent), "server_applied_pushes_per_s": rate(handled),
            "server_ms_a_push": busy, "server_max_pushes_per_s": 1e3 / busy if busy else None,
            "queue_depth_max": max(depth, default=0),
            "queue_depth_mean": sum(depth) / len(depth) if depth else 0.0,
            "ack_floor_s": floor,
            "ack_margin": None if floor is None or None in waits else 1.0 - max(waits) / floor,
            "ack_slack_min_s": None if None in slack else min(slack)}


def _codec_processes(dense_16a, busy_ms_per_step, launches, sizes, backend, model, steps):
    """(a): phase 16 (a)'s world with int8 pushes under Adasum, then a
    restore of its server's directory."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer

    lines, wall = _ps_processes(CODEC_WIRE, SMOKE_CODEC_DIR, backend, model, steps)
    line = _ps_world_line(lines, True, wall, None, steps, backend)
    srv = lines[0]
    require(srv["combine"] == "adasum" and "GradientUpdate" not in srv["message_counts"],
            f"(a) the server combined by {srv['combine']}: {srv['message_counts']}")
    for r in (1, 2):
        w, pw = lines[r], line["per_worker"][r]
        enc = w["encoder"]
        require(w["frame_floats"] == [sizes["int8_push"]],
                f"(a) worker {r} framed pushes of {w['frame_floats']} floats, not "
                f"{sizes['int8_push']}")
        require(enc["pushes"] == w["pushes_sent"] and enc["residual_resets"] == 0,
                f"(a) worker {r}'s encoder: {enc}")
        want = (sizes["full_reply"] - 14) / sizes["int8_push"]  # n over the framed floats
        require(round(enc["ratio"], 3) == round(want, 3),
                f"(a) worker {r}'s compression ratio {enc['ratio']}, not {want}")
        _add_launches(launches, w["launches"])
        dense = (dense_16a or {}).get(r, {}).get("steady_steps_per_s")
        pw.update(encoder=enc, frame_floats=w["frame_floats"][0],
                  idle_share=_idle_share(pw["steady_steps_per_s"], busy_ms_per_step),
                  dense_16a_steady_steps_per_s=dense,
                  dense_16a_idle_share=None if dense is None
                  else _idle_share(dense, busy_ms_per_step))
    fresh = ParameterServer(get_model(model, seed=0, device="cpu"), ckpt_dir=SMOKE_CODEC_DIR,
                            wal=True, combine="adasum")
    try:
        require(fresh.maybe_restore(), "(a) nothing to restore")
        require(np.array_equal(fresh.central, np.load(SMOKE_CODEC_DIR + ".central.npy"))
                and fresh._apply_seq == srv["apply_seq"]
                and fresh.staleness.version == srv["version"],
                "(a) the restored server differs from the world's final state")
    finally:
        fresh.wal.close()
    line.pop("in_process_per_worker_15c")
    return {**line, "server_queue": _server_queue(lines), "wire": CODEC_WIRE,
            "restored_bit_equal": True,
            "idle_share_source": "1 - steady steps/s x phase 15 (b)'s busy ms a step"}


def _codec_sharded(per_step_workers, launches, sizes, backend, model, steps):
    """(b): phase 17's sharded world with top-k pushes and a server-side
    sgdm, then each shard's directory restored, its optimizer state too."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import (
        make_shard_server,
        shard_ranges,
    )
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    host_model = get_model(model, seed=0, device="cpu")
    n = flat_size(host_model)
    lines, line = _sharded_world(CODEC_SHARDS, SMOKE_CODEC_SHARDED_DIR, n, per_step_workers,
                                 launches, backend, model, steps, extra=CODEC_SHARDED)
    for s, (lo, hi) in enumerate(shard_ranges(n, CODEC_SHARDS)):
        srv, pairs = lines[s], sizes["shard_topk_pairs"][s]
        opt = srv["optimizer"]
        require(opt["kind"] == "sgdm" and (opt["lo"], opt["hi"]) == (lo, hi)
                and opt["state_floats"] == 2 * (hi - lo),
                f"(b) shard {s}'s optimizer {opt} over [{lo},{hi})")
        require("GradientUpdate" not in srv["message_counts"],
                f"(b) shard {s} took dense pushes: {srv['message_counts']}")
        for r in range(CODEC_SHARDS, CODEC_SHARDS + 2):
            got = lines[r]["frame_floats"][s]
            require(got == [12 + 2 * pairs],
                    f"(b) worker {r} framed shard {s}'s pushes at {got}, not {pairs} pairs")
        line["per_shard"][s].update(optimizer=opt, topk_pairs=pairs)
        fresh = make_shard_server(host_model, shard=s, n_shards=CODEC_SHARDS,
                                  ckpt_dir=f"{SMOKE_CODEC_SHARDED_DIR}/shard{s}", wal=True,
                                  server_opt="sgdm", server_opt_kw={"lr": 0.5, "momentum": 0.5})
        try:
            require(fresh.maybe_restore(), f"(b) shard {s}: nothing to restore")
            base = f"{SMOKE_CODEC_SHARDED_DIR}.central{s}.npy"
            require(np.array_equal(fresh.central, np.load(base))
                    and np.array_equal(fresh.optimizer.m, np.load(base + ".m.npy"))
                    and np.array_equal(fresh.optimizer.v, np.load(base + ".v.npy"))
                    and fresh.optimizer.t == opt["t"]
                    and fresh._apply_seq == srv["apply_seq"],
                    f"(b) the restored shard {s} differs from its final state")
        finally:
            fresh.wal.close()
    return {**line, "extra": CODEC_SHARDED, "restored_bit_equal": True}


#: seconds a paced pull of (c) waits for the reply to the one before it
DELTA_PULL_WAIT_S = 60


def _delta_pull_world(torch, launches, sizes, device, model, steps, batch=64):
    """(c): a server and one chunked worker as threads of this process on the
    in-process transport, the worker ``Asynchronous(compress="int8",
    delta_pull=True)``; every pull after the first is answered by a top-k
    delta against the view the server tracks for it.

    The chunked worker's host runs ahead of the card, so unpaced pulls leave
    in bursts, each carrying a stamp the server has already moved past, and
    most are answered in full (on an H100, 5-7 full replies of 8).
    Here each pull waits until the reply to the one before it is installed,
    so its stamp is the base the server tracks and the delta rung is what
    runs."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
    from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport

    args = build_parser().parse_args([
        "--model", model, "--world-size", "2", "--epochs", "1", "--synthetic-data",
        "--synthetic-train-size", str(steps * batch), "--synthetic-test-size", "512",
        "--batch-size", str(batch), "--log-interval", str(10 * steps), "--worker-timeout", "0",
        "--chunked-dispatch", "on", "--log-dir", os.path.join(ROOT, "build", "smoke_runs")])
    world = InProcessTransport.create_world(2)
    results, errors, opts = {}, [], []

    class PacedPulls(tps.Asynchronous):
        """Sends a pull only once the reply to the last one is installed."""
        pulls, pull_wait_s = 0, 0.0

        def _pull_payload(self, link):
            t0 = time.monotonic()
            lst = self.listener
            while lst.full_installs + lst.delta_installs < self.pulls:
                require(time.monotonic() - t0 < DELTA_PULL_WAIT_S,
                        f"(c) pull {self.pulls}'s reply not installed in {DELTA_PULL_WAIT_S} s")
                time.sleep(0.0005)
            self.pull_wait_s += time.monotonic() - t0
            self.pulls += 1
            return super()._pull_payload(link)

    def factory(model_, tx):
        opts.append(PacedPulls(model_, lr=args.lr, n_push=args.num_push, n_pull=args.num_pull,
                               tx=tx, transport=world[1], compress="int8", delta_pull=True))
        return opts[0]

    def guard(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    fu.launches = 0
    for k in fc.launches:
        fc.launches[k] = 0
    server = threading.Thread(target=guard, daemon=True, args=(
        "server", lambda: tps.run_server(args, world[0])))
    worker = threading.Thread(target=guard, daemon=True, args=(
        "worker", lambda: tps.train_worker(args, world[1], device=device, opt_factory=factory)))
    t0 = time.monotonic()
    server.start()
    worker.start()
    worker.join(timeout=600)
    server.join(timeout=60)
    wall = time.monotonic() - t0
    require(not errors, "(c) " + "; ".join(errors))
    require(not server.is_alive() and not worker.is_alive(), "(c) the world did not shut down")
    _add_launches(launches, {"flat_axpy": fu.launches, **fc.launches})
    srv, opt = results["server"], opts[0]
    lst = opt.listener
    answered = srv.delta_replies + srv.full_replies
    require(answered == opt.pulls >= 2 and lst.full_installs == srv.full_replies == 1
            and lst.delta_installs == srv.delta_replies == answered - 1
            and lst.delta_base_miss == 0,
            f"(c) {opt.pulls} pulls; installs full {lst.full_installs} delta "
            f"{lst.delta_installs} base misses {lst.delta_base_miss}; replies full "
            f"{srv.full_replies} delta {srv.delta_replies}")
    base = srv._pull_bases[1]
    require(lst._held == base[:2] and np.array_equal(lst._view, base[2]),
            "(c) the worker's view differs from the server's tracked base")
    require(srv.delta_reply_wire_floats == srv.full_replies * sizes["full_reply"]
            + srv.delta_replies * sizes["delta_reply"],
            f"(c) {srv.delta_reply_wire_floats} reply floats for {srv.full_replies} full and "
            f"{srv.delta_replies} delta replies")
    recs = results["worker"][1].records
    losses = [r["training_loss"] for r in recs]
    require(len(losses) == steps and sum(losses[-10:]) < sum(losses[:10]),
            f"(c) the worker's loss did not fall over {len(losses)} steps")
    return {"wall_s": wall, "steps": steps, "pulls_answered": answered,
            "pull_wait_s": opt.pull_wait_s,
            "full_replies": srv.full_replies, "delta_replies": srv.delta_replies,
            "full_installs": lst.full_installs, "delta_installs": lst.delta_installs,
            "delta_base_miss": lst.delta_base_miss, "view_bit_equal": True,
            "reply_floats_full": sizes["full_reply"], "reply_floats_delta": sizes["delta_reply"],
            "pushes": opt.encoder.pushes, "compression_ratio": opt.encoder.compression_ratio(),
            "early_loss": sum(losses[:10]) / 10, "late_loss": sum(losses[-10:]) / 10}


def phase_codec_plane(torch, dense_16a, busy_ms_per_step, per_step_workers, backend="cuda",
                      model="alexnet", steps=WORKER_STEPS, bench_args=("--legs", "wire_bytes")):
    """Phase 20: the optimizer and codec plane on the DownPour world, (a)-(d);
    returns the workers' summed kernel launch counts."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    n = flat_size(get_model(model, seed=0, device="cpu"))
    sizes = codec_sizes(n)
    if model == "alexnet":
        require(sizes == ALEXNET_CODEC_SIZES, f"AlexNet's frame sizes {sizes}")
    launches = {}
    emit({"phase": "codec_processes", "ok": True,
          **_codec_processes(dense_16a, busy_ms_per_step, launches, sizes, backend, model,
                             steps)})
    emit({"phase": "codec_sharded_processes", "ok": True,
          **_codec_sharded(per_step_workers, launches, sizes, backend, model, steps)})
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        emit({"phase": "codec_delta_pull", "ok": True,
              **_delta_pull_world(torch, launches, sizes, backend, model, steps)})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.bench_all",
                           *bench_args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    require(proc.returncode == 0, f"bench_all {' '.join(bench_args)} exited "
                                  f"{proc.returncode}: {proc.stderr[-3000:]}")
    records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require(len(records) == WIRE_BYTES_RECORDS,
            f"bench_all --legs wire_bytes printed {len(records)} records")
    emit({"phase": "wire_bytes_bench_leg", "ok": True, "records": records})
    return launches


# ------------------------------------------------------------------ main

K4_SRC = "distributed_ml_pytorch_tpu_torch/csrc/flash_fwd_tc.cu"
K5_SRC = "distributed_ml_pytorch_tpu_torch/csrc/flash_bwd_tc.cu"
KERNEL_ROWS = [
    ("flat_axpy", "distributed_ml_pytorch_tpu_torch/csrc/fused_update.cu",
     "distributed_ml_pytorch_tpu/ops/fused_update.py:57"),
    ("relu_pool2_fwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:321"),
    ("relu_pool2_bwd", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:311"),
    ("flash_fwd", K4_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:311"),
    ("flash_bwd_fused", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:563"),
    ("flash_bwd_dq", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:592"),
    ("flash_bwd_dkv", K5_SRC, "distributed_ml_pytorch_tpu/ops/attention.py:605"),
    ("decode_attention", "distributed_ml_pytorch_tpu_torch/csrc/decode_attention.cu",
     "distributed_ml_pytorch_tpu/ops/decode_attention.py:128"),
    ("fused_head", "distributed_ml_pytorch_tpu_torch/csrc/fused_head.cu",
     "distributed_ml_pytorch_tpu/ops/fused_head.py:105"),
    ("relu_pool2_fwd.bf16", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:321"),
    ("relu_pool2_bwd.bf16", "distributed_ml_pytorch_tpu_torch/csrc/fused_conv.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:311"),
    ("bias_relu_fwd", "distributed_ml_pytorch_tpu_torch/csrc/bias_relu.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:177"),
    ("bias_relu_bwd", "distributed_ml_pytorch_tpu_torch/csrc/bias_relu.cu",
     "distributed_ml_pytorch_tpu/ops/fused_conv.py:177"),
]


# ------------------------------------------------------------------ phase 21

#: (a)'s elastic world: the coordinator's lease (s), the steps of an epoch
#: of each first worker and of the joiner, and their epochs (AlexNet runs
#: ~80 per-step steps/s a worker on the card: the first workers must still
#: be training well after the death is found), the step of the first worker
#: at which the third worker starts and at which shard rank 1 is killed
#: (once the joiner has trained ELASTIC_JOINER_WARM steps), and a
#: process's time limit
ELASTIC_LEASE = 2.0
ELASTIC_STEPS, ELASTIC_JOINER_STEPS = 500, 300
ELASTIC_EPOCHS, ELASTIC_JOINER_EPOCHS = 2, 2
ELASTIC_JOIN_AT, ELASTIC_KILL_AT, ELASTIC_JOINER_WARM = 100, 250, 20
ELASTIC_TIMEOUT_S = 300
SMOKE_ELASTIC_DIR = os.path.join(ROOT, "build", "smoke_elastic")
#: (b): the JAX chaos acceptance world (tests/test_chaos.py): two workers
#: against one server, 16 steps at batch 16, lr 0.05, cadence 4/4, drop 0.10
#: and dup 0.05 on the three DownPour data codes, seed 42, and its corridor
CHAOS_STEPS, CHAOS_BATCH, CHAOS_LR, CHAOS_CADENCE, CHAOS_SEED = 16, 16, 0.05, 4, 42
CHAOS_CORRIDOR = 0.45
#: (c): a worker slowed by this many s a step, the steps, the lease
SPEC_SLOW_S, SPEC_STEPS, SPEC_LEASE = 0.3, 12, 2.0

#: one rank of the elastic world: ``python -c _ELASTIC_RANK_SRC <json argv>``.
#: Calls the CLI's entry ``run_sharded_ps_process`` (which takes the
#: ``--coord`` path) with every kernel count zeroed just before, wrapping
#: (never replacing) the functions it calls, and prints ``ELASTIC_STEP`` lines
#: as the worker trains and one ``PS_RANK`` JSON line last.
_ELASTIC_RANK_SRC = r"""
import json, sys, time, zlib
import numpy as np
import torch
from distributed_ml_pytorch_tpu_torch.coord import elastic as el
from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel import sharded_ps as sps
from distributed_ml_pytorch_tpu_torch.training.cli import build_parser
from distributed_ml_pytorch_tpu_torch.utils import messaging as msg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode, _join16

args = build_parser().parse_args(json.loads(sys.argv[1]))
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
if len(sys.argv) > 2:
    # a late joiner: started with the others, it joins once the gate exists
    if args.backend == "cuda":
        torch.zeros(1, device="cuda")
    import os
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.02)
base_port = int(args.port)
seen = {"transports": [], "sent": {}, "sent_by_range": {}, "installs_sent": [],
        "cutovers": [], "resizes": [], "applied": {}, "dropped": {}, "installed": []}

def crc(values):
    return zlib.crc32(np.ascontiguousarray(values, np.float32).tobytes()) & 0xFFFFFFFF

def wrap(mod, name, after):
    real = getattr(mod, name)
    def wrapped(*a, **k):
        out = real(*a, **k)
        after(a, out)
        return out
    setattr(mod, name, wrapped)

# the worker: its transports by the server id their port names
wrap(msg, "make_transport",
     lambda a, t: seen["transports"].append((int(a[3]) - base_port + 1, t)))
wrap(tps, "train_worker", lambda a, out: seen.setdefault("logger", out[1]))
wrap(sps.ShardedAsynchronous, "apply_shard_map",
     lambda a, out: seen["cutovers"].append([a[1].version, time.time()]))

real_step = sps.ShardedAsynchronous.step
# a CPU rehearsal paces its fast workers so the death lands mid-run
pace = float(__import__("os").environ.get("SMOKE_ELASTIC_STEP_S", "0"))
def step(self, *a, **k):
    seen["opt"] = self
    real_step(self, *a, **k)
    if pace:
        time.sleep(pace)
    if self.idx % 10 == 0:
        print(f"ELASTIC_STEP {self.idx} {time.time()}", flush=True)
sps.ShardedAsynchronous.step = step

real_send = sps.ShardedAsynchronous._send
def counting_send(self, shard, code, payload):
    sid = self.server_ids[shard]
    up = not self.shard_down[shard]
    real_send(self, shard, code, payload)
    if not (up and not self.shard_down[shard]):
        return
    if code == MessageCode.ShardPush:
        stamp = f"{sid}:{_join16(payload[2], payload[3])}:{_join16(payload[4], payload[5])}"
        seen["sent"][str(sid)] = seen["sent"].get(str(sid), 0) + 1
        seen["sent_by_range"][stamp] = seen["sent_by_range"].get(stamp, 0) + 1
    elif code == MessageCode.RangeInstall:
        seen["installs_sent"].append({"server": sid, "lo": _join16(payload[0], payload[1]),
                                      "hi": _join16(payload[2], payload[3]),
                                      "crc": crc(payload[4:]), "t": time.time()})
sps.ShardedAsynchronous._send = counting_send

# the shard server
real_init = el.ElasticShardServer.__init__
def init(self, *a, **k):
    real_init(self, *a, **k)
    seen["server"] = self
el.ElasticShardServer.__init__ = init

real_entry = el.ElasticShardServer._apply_entry
def apply_entry(self, m):
    before = (self.lo, self.hi)
    real_entry(self, m)
    if (self.lo, self.hi) != before:
        seen["resizes"].append({"version": m.version, "from": list(before),
                                "to": [self.lo, self.hi], "t": time.time(),
                                "awaiting": list(self.pending_install or ())})
el.ElasticShardServer._apply_entry = apply_entry

real_handle = el.ElasticShardServer._handle_locked
def handle(self, sender, code, payload):
    dropped = self.stats["stale_dropped"]
    installs = self.stats["installs"]
    real_handle(self, sender, code, payload)
    if code == MessageCode.ShardPush:
        key = f"{sender}:{_join16(payload[2], payload[3])}:{_join16(payload[4], payload[5])}"
        box = seen["dropped"] if self.stats["stale_dropped"] > dropped else seen["applied"]
        box[key] = box.get(key, 0) + 1
    elif code == MessageCode.RangeInstall and self.stats["installs"] > installs:
        seen["installed"].append({"sender": sender, "lo": _join16(payload[0], payload[1]),
                                  "hi": _join16(payload[2], payload[3]),
                                  "crc": crc(payload[4:]), "t": time.time()})
el.ElasticShardServer._handle_locked = handle

fu.launches = 0
for k in fc.launches:
    fc.launches[k] = 0
rc = sps.run_sharded_ps_process(args)
links = {str(sid): {"stats": getattr(t, "stats", None), "max_ack_s": getattr(t, "max_ack_wait", None)}
         for sid, t in seen["transports"]}
line = {"rank": args.rank, "rc": rc}
if "server" in seen:
    srv = seen["server"]
    star = srv.transport
    line.update(server_id=srv.server_id, lo=srv.lo, hi=srv.hi, map_version=srv.map_version,
                stats=srv.stats, resizes=seen["resizes"], applied=seen["applied"],
                dropped=seen["dropped"], installed=seen["installed"],
                apply_seq=srv.ps._apply_seq, star_stats=getattr(star, "stats", None),
                star_max_ack_s=getattr(star, "max_ack_wait", None))
else:
    opt = seen["opt"]
    recs = seen["logger"].records
    line.update(launches={"flat_axpy": fu.launches, **fc.launches}, map_version=opt.map_version,
                server_ids=opt.server_ids, sent=seen["sent"], sent_by_range=seen["sent_by_range"],
                installs_sent=seen["installs_sent"], cutovers=seen["cutovers"], links=links,
                t=[r["timestamp"].timestamp() for r in recs],
                loss=[r["training_loss"] for r in recs])
print("PS_RANK " + json.dumps(line), flush=True)
"""


class _Proc:
    """A child process whose stdout and stderr lines are read, each with
    the wall-clock second it arrived, on threads of their own."""

    def __init__(self, argv, env):
        self.p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        self.out, self.err = [], []
        self._readers = [threading.Thread(target=self._read, args=(f, box), daemon=True)
                         for f, box in ((self.p.stdout, self.out), (self.p.stderr, self.err))]
        for r in self._readers:
            r.start()

    @staticmethod
    def _read(f, box):
        for ln in f:
            box.append((time.time(), ln.rstrip("\n")))

    def first(self, prefix, box="out"):
        """The first line starting with ``prefix``: ``(t, line)`` or None."""
        for t, ln in list(getattr(self, box)):
            if ln.startswith(prefix):
                return t, ln
        return None

    def last_step(self):
        steps = [int(ln.split()[1]) for _t, ln in list(self.out)
                 if ln.startswith("ELASTIC_STEP ")]
        return steps[-1] if steps else -1

    def finish(self, timeout):
        try:
            self.p.wait(timeout=timeout)
        finally:
            if self.p.poll() is None:
                self.p.kill()
                self.p.wait()
            for r in self._readers:
                r.join(timeout=10)

    def rank_line(self):
        found = [ln for _t, ln in self.out if ln.startswith("PS_RANK ")]
        return json.loads(found[-1][len("PS_RANK "):]) if found else None

    def tail(self, n=3000):
        return "\n".join(ln for _t, ln in self.err)[-n:]


def _wait_for(cond, timeout, what, procs):
    """Poll ``cond()`` every 50 ms; fail the phase after ``timeout`` s or
    when a process of ``procs`` ended early."""
    deadline = time.monotonic() + timeout
    while not cond():
        for name, pr in procs.items():
            if pr.p.poll() is not None and pr.p.returncode != 0:
                raise SmokeFailure(f"{name} exited {pr.p.returncode} while waiting for {what}: "
                                   f"{pr.tail()}")
        if time.monotonic() > deadline:
            raise SmokeFailure(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.05)


def _window_rate(t, a, b, batch):
    """images/s of the step times ``t`` (one a step) within [a, b)."""
    ts = [x for x in t if a <= x < b]
    if len(ts) < 3:
        return None
    return batch * (len(ts) - 1) / (ts[-1] - ts[0])


def _elastic_processes(backend, model, steps, joiner_steps, join_at, kill_at, joiner_warm,
                       batch=64, epochs=1, joiner_epochs=1):
    """(a)'s world: the coordinator, two shard ranks and two workers
    (``epochs`` of ``steps``), a third worker (``joiner_epochs`` of
    ``joiner_steps``) at ``join_at``, shard rank 1 killed at ``kill_at``;
    returns ``(coordinator, {rank: PS_RANK line}, kill time, join time,
    the survivor)``."""
    import shutil
    import signal

    from distributed_ml_pytorch_tpu_torch.launch import _free_port, _free_port_block

    shutil.rmtree(SMOKE_ELASTIC_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cport, port = _free_port(), _free_port_block(2)
    coord = _Proc([sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.coord.cli",
                   "--port", cport, "--model", model, "--lease", str(ELASTIC_LEASE)], env)
    common = ["--mode", "ps", "--world-size", "5", "--n-servers", "2", "--port", port,
              "--coord", f"localhost:{cport}", "--backend", backend, "--model", model,
              "--synthetic-data", "--synthetic-test-size", "512",
              "--batch-size", str(batch), "--lr", "0.008", "--num-push", "10",
              "--num-pull", "10", "--log-interval", str(10 * steps), "--worker-timeout", "0",
              "--transport", "python", "--reliable", "--log-dir", SMOKE_ELASTIC_DIR]

    def rank(r, n_steps, n_epochs=1, extra=(), gate=()):
        argv = common + ["--rank", str(r), "--synthetic-train-size", str(n_steps * batch),
                         "--epochs", str(n_epochs), *extra]
        return _Proc([sys.executable, "-c", _ELASTIC_RANK_SRC, json.dumps(argv), *gate], env)

    procs = {"coordinator": coord}
    try:
        _wait_for(lambda: coord.first("coordinator on") is not None, 120, "the coordinator",
                  procs)
        # the shard servers join in rank order (v1, then v2), and the
        # workers start under map v2
        procs["shard 0"] = rank(0, steps)
        _wait_for(lambda: procs["shard 0"].first("shard 1: map v1", "err"), 120,
                  "shard server 1 on map v1", procs)
        procs["shard 1"] = rank(1, steps)
        _wait_for(lambda: all(procs[f"shard {s}"].first(f"shard {s + 1}: map v2", "err")
                              for s in (0, 1)), 120, "both shard servers on map v2", procs)
        gate = os.path.join(SMOKE_ELASTIC_DIR, "join")
        os.makedirs(SMOKE_ELASTIC_DIR, exist_ok=True)
        # the joiner's process starts now and joins at the gate: its start-up
        # would otherwise outlast a fast world
        procs["worker 4"] = rank(4, joiner_steps, joiner_epochs, ["--rejoin"], [gate])
        procs["worker 2"] = rank(2, steps, epochs)
        procs["worker 3"] = rank(3, steps, epochs)
        first = procs["worker 2"]
        _wait_for(lambda: first.last_step() >= join_at, ELASTIC_TIMEOUT_S,
                  f"worker 2 at step {join_at}", procs)
        with open(gate, "w"):
            pass
        joined_at = time.time()
        _wait_for(lambda: first.last_step() >= kill_at
                  and procs["worker 4"].last_step() >= joiner_warm, ELASTIC_TIMEOUT_S,
                  f"worker 2 at step {kill_at} and worker 4 at {joiner_warm}", procs)
        victim = procs.pop("shard 1")
        victim.p.send_signal(signal.SIGKILL)
        killed_at = time.time()
        victim.finish(30)
        lines = {}
        for name in ("worker 2", "worker 3", "worker 4", "shard 0"):
            pr = procs[name]
            pr.finish(ELASTIC_TIMEOUT_S)
            line = pr.rank_line()
            require(pr.p.returncode == 0 and line is not None,
                    f"{name} exited {pr.p.returncode}: {pr.tail()}")
            lines[int(name.split()[1])] = line
        coord.p.send_signal(signal.SIGINT)
        coord.finish(60)
        return coord, lines, killed_at, joined_at, procs["shard 0"]
    finally:
        for pr in list(procs.values()) + [coord]:
            if pr.p.poll() is None:
                pr.p.kill()
                pr.p.wait()


def _coordinator_summary(coord):
    """The coordinator's decision lines and its ``fleet at exit`` state."""
    import ast

    events = [ln[len("event: "):] for _t, ln in coord.out if ln.startswith("event: ")]
    fleet = coord.first("fleet at exit: ")
    require(fleet is not None, f"the coordinator printed no fleet state: {coord.tail()}")
    return events, ast.literal_eval(fleet[1][len("fleet at exit: "):])


def phase_elastic_processes(backend="cuda", model="alexnet", steps=ELASTIC_STEPS,
                            joiner_steps=ELASTIC_JOINER_STEPS, join_at=ELASTIC_JOIN_AT,
                            kill_at=ELASTIC_KILL_AT, joiner_warm=ELASTIC_JOINER_WARM,
                            batch=64, epochs=ELASTIC_EPOCHS,
                            joiner_epochs=ELASTIC_JOINER_EPOCHS):
    """Phase 21 (a): the elastic world as processes through the entry
    points; returns the workers' summed kernel launch counts."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    n = flat_size(get_model(model, seed=0, device="cpu"))
    t0 = time.monotonic()
    coord, lines, killed_at, joined_at, survivor_proc = _elastic_processes(
        backend, model, steps, joiner_steps, join_at, kill_at, joiner_warm, batch, epochs,
        joiner_epochs)
    wall = time.monotonic() - t0
    events, fleet = _coordinator_summary(coord)
    srv = lines[0]
    workers = {r: lines[r] for r in (2, 3, 4)}
    want_steps = {2: steps * epochs, 3: steps * epochs, 4: joiner_steps * joiner_epochs}
    n_evals = {2: epochs, 3: epochs, 4: joiner_epochs}
    # --- the map sequence: v1 and v2 on the shard joins, v3 on the death
    maps = [e for e in events if e.startswith("shard map v")]
    require(any("shard 2 lease expired" in e for e in events),
            f"the coordinator never expired shard 2's lease: {events}")
    final = f"shard map v3 on lease expiry: s1=[0,{n})"
    require(maps[:3] == [f"shard map v1 on join of shard server 1: s1=[0,{n})",
                         f"shard map v2 on join of shard server 2: s1=[0,{n // 2 + n % 2}), "
                         f"s2=[{n // 2 + n % 2},{n})", final],
            f"map sequence {maps}")
    # the survivor's clean leave after the workers drain empties the map
    require(maps[3:] == ["shard map v4 on leave of shard server 1: EMPTY"],
            f"maps after v3: {maps[3:]}")
    require(fleet["version"] == 4 and fleet["map"] == [], f"fleet at exit {fleet}")
    for r, w in workers.items():
        require(w["map_version"] == 3 and w["server_ids"] == [1],
                f"worker {r} ended on map v{w['map_version']} {w['server_ids']} "
                f"(cutovers {w['cutovers']}; its {len(w['t'])} steps ran from "
                f"{w['t'][0] - killed_at:.2f} to {w['t'][-1] - killed_at:.2f} s after the "
                f"kill; the join {joined_at - killed_at:.2f} s)")
    # --- the install: one resize to the whole range awaiting the fresh
    # part, one install, every other worker's a duplicate, the CRC carried
    fresh = [n // 2 + n % 2, n]
    whole = [r for r in srv["resizes"] if r["to"] == [0, n] and r["version"] == 3]
    require(len(whole) == 1 and whole[0]["awaiting"] == fresh,
            f"the survivor's resizes {srv['resizes']}")
    require(srv["stats"]["installs"] == 1 and len(srv["installed"]) == 1,
            f"installs {srv['stats']} {srv['installed']}")
    installed = srv["installed"][0]
    senders = {r: [i for i in w["installs_sent"] if [i["lo"], i["hi"]] == fresh]
               for r, w in workers.items()}
    n_sent = sum(len(v) for v in senders.values())
    require(srv["stats"]["dup_installs"] == n_sent - 1,
            f"dup_installs {srv['stats']['dup_installs']} of {n_sent} installs sent")
    first_installer = 2 + installed["sender"] - 1  # star rank s is global rank s + 1
    sent_crc = [i["crc"] for i in senders.get(first_installer, [])]
    require(sent_crc == [installed["crc"]],
            f"installed CRC {installed['crc']} vs worker {first_installer}'s {sent_crc}")
    # --- the accounting on the survivor: applied + stale = sent, exactly
    sent = sum(w["sent"].get("1", 0) for w in workers.values())
    applied = sum(srv["applied"].values())
    stale = sum(srv["dropped"].values())
    require(applied + stale == sent and applied == srv["apply_seq"],
            f"survivor applied {applied} + stale {stale} != sent {sent} "
            f"(apply_seq {srv['apply_seq']})")
    require(not any(k.endswith(f":0:{n}") for k in srv["dropped"]),
            f"pushes stamped with the final range dropped: {srv['dropped']}")
    for r, w in workers.items():
        # the survivor's keys are "<star rank>:<lo>:<hi>" (star rank = r - 1),
        # the worker's "<server id>:<lo>:<hi>"
        mine = {k.split(":", 1)[1]: v for k, v in w["sent_by_range"].items()
                if k.startswith("1:")}
        got = {}
        for box in (srv["applied"], srv["dropped"]):
            for k, v in box.items():
                sender, stamp = k.split(":", 1)
                if int(sender) == r - 1:
                    got[stamp] = got.get(stamp, 0) + v
        require(got == mine, f"worker {r}: sent by stamp {mine}, the survivor saw {got}")
    # --- the wire: no timeout on any link between live peers
    exempt = {}
    for r, w in workers.items():
        for sid, link in w["links"].items():
            st = link["stats"]
            if sid == "2":
                exempt[r] = {k: st[k] for k in ("rto_expired", "retries", "gave_up")}
                continue
            require(st["rto_expired"] == 0 and st["retries"] == 0 and st["gave_up"] == 0,
                    f"worker {r}'s link to server {sid} timed out: {st}")
    st = srv["star_stats"]
    require(st["rto_expired"] == 0 and st["retries"] == 0,
            f"the survivor's star timed out: {st}")
    # --- completion and the kernels
    launches, per_worker = {}, {}
    detected = survivor_proc.first("shard 1: map v3", "err")
    require(detected is not None, "the survivor never logged map v3")
    for r, w in workers.items():
        loss, t, cnt = w["loss"], w["t"], w["launches"]
        require(len(loss) == want_steps[r], f"worker {r} logged {len(loss)} steps")
        early, late = sum(loss[:4]) / 4, sum(loss[-4:]) / 4
        require(late < early, f"worker {r} loss did not fall: {early} -> {late}")
        if backend == "cuda":
            k = want_steps[r]
            # the evaluation at each epoch's end is one forward
            require(cnt["flat_axpy"] == k and cnt["relu_pool2_bwd.vector"] == 3 * k
                    and cnt["relu_pool2_fwd.vector"] == 3 * (k + n_evals[r]),
                    f"worker {r} wrapper counts {cnt} (want the per-step path's)")
        _add_launches(launches, cnt)
        cut = [c for c in w["cutovers"] if c[0] == 3]
        require(len(cut) == 1, f"worker {r} cutovers {w['cutovers']}")
        cut_t = cut[0][1]
        per_worker[r] = {
            "steps": len(loss), "early_loss": early, "late_loss": late,
            "images_per_s_before": _window_rate(t, killed_at - 5.0, killed_at, batch),
            "images_per_s_during": _window_rate(t, killed_at, cut_t, batch),
            "images_per_s_after": _window_rate(t, cut_t, t[-1] + 1, batch),
            "adopted_v3_s_after_kill": cut_t - killed_at, "pushes_sent": w["sent"],
            "installs_sent": len(senders[r]),
            "wrapper_counts": {name: v for name, v in cnt.items() if v}}
    emit({"phase": "elastic_processes", "ok": True, "lease_s": ELASTIC_LEASE,
          "wall_s": wall, "n_params": n, "map_events": maps,
          "detected_s": detected[0] - killed_at, "per_worker": per_worker,
          "survivor": {"stats": srv["stats"], "resizes": srv["resizes"],
                       "installed": installed, "applied": applied, "stale_dropped": stale,
                       "sent_to_it": sent, "dropped_by_stamp": srv["dropped"],
                       "star_stats": st},
          "links_to_the_killed_rank": exempt, "coordinator_events": events})
    return launches


def chaos_ps_world(torch, plan, model="alexnet", device="cuda", steps=CHAOS_STEPS,
                   batch=CHAOS_BATCH, lr=CHAOS_LR, cadence=CHAOS_CADENCE, n_workers=2):
    """The JAX chaos acceptance world (``tests/test_chaos.py::_run_ps_world``)
    on the port: one ``ParameterServer`` and ``n_workers`` ``Asynchronous``
    workers on ``device`` as threads over an in-process world, under
    ``plan`` (or none). Returns ``(per-worker losses, chaos log or None,
    server)``."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.data import load_cifar10
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Asynchronous, ParameterServer
    from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_world

    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)
    world, log = make_world(n_workers + 1, plan=plan)
    server = ParameterServer(get_model(model, seed=0, device="cpu"), transport=world[0],
                             n_workers=n_workers)
    server_thread = threading.Thread(target=server.run, kwargs={"timeout": 180})
    server_thread.start()
    results, errors = {}, []

    def worker(rank):
        try:
            net = get_model(model, fused_epilogue=True, seed=0, device=device)
            opt = Asynchronous(net, lr=lr, n_push=cadence, n_pull=cadence,
                               transport=world[rank])
            gen = torch.Generator(device=device).manual_seed(rank)
            losses = []
            for step in range(steps):
                sel = np.random.default_rng(rank * 100 + step).integers(0, len(x), batch)
                loss = loss_and_grads(net, *to_device(x[sel], y[sel], device), generator=gen)
                opt.step()
                losses.append(float(loss))
            opt.finish()
            results[rank] = losses
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(1, n_workers + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    server_thread.join(timeout=60)
    for t in world.values():
        t.close()
    require(not errors and not server_thread.is_alive(),
            f"chaos world: errors {errors}, server alive {server_thread.is_alive()}")
    return results, log, server


def acceptance_plan():
    """(b)'s plan: the JAX acceptance plan, drop 0.10 and dup 0.05 on the
    three DownPour data codes, seed 42."""
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule
    from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

    return ChaosPlan([FaultRule(code=int(c), drop=0.10, dup=0.05)
                      for c in (MessageCode.GradientUpdate, MessageCode.ParameterRequest,
                                MessageCode.ParameterUpdate)], seed=CHAOS_SEED)


def phase_chaos_world(torch, model="alexnet", device="cuda"):
    """Phase 21 (b): the chaos acceptance world twice on ``device`` and once
    on the CPU, byte-identical logs, both fault kinds fired, the loss in
    the fault-free run's corridor."""
    import numpy as np

    def final(results):
        return float(np.mean([np.mean(v[-6:]) for v in results.values()]))

    t0 = time.monotonic()
    clean, _, _ = chaos_ps_world(torch, None, model, device)
    runs = [chaos_ps_world(torch, acceptance_plan(), model, d) for d in (device, device, "cpu")]
    logs = [log.lines() for _r, log, _s in runs]
    require(logs[0] and logs[0] == logs[1], "the chaos log differs between two runs")
    require(logs[0] == logs[2], "the chaos log on the device differs from the CPU's")
    counts = runs[0][1].counts()
    require(counts.get("drop", 0) > 0 and counts.get("dup", 0) > 0, f"faults fired {counts}")
    finals = [final(r) for r, _l, _s in runs]
    for f in finals:
        require(abs(f - final(clean)) < CHAOS_CORRIDOR,
                f"final loss {f} outside {CHAOS_CORRIDOR} of the fault-free {final(clean)}")
    for _r, _l, srv in runs:
        require(np.isfinite(srv.central).all(), "a chaos run left nonfinite central params")
    emit({"phase": "elastic_chaos_world", "ok": True, "model": model, "device": device,
          "wall_s": time.monotonic() - t0, "log_lines": logs[0].count("\n"),
          "log_crc32": __import__("zlib").crc32(logs[0].encode()), "counts": counts,
          "clean_final_loss": final(clean), "final_losses": finals,
          "applied": [s._apply_seq for _r, _l, s in runs]})
    return logs[0]


def phase_speculation(model="alexnet", device="cuda", steps=SPEC_STEPS, slow_s=SPEC_SLOW_S):
    """Phase 21 (c): ``coord.demo.elastic_scenario`` with a slowed worker
    and speculation on: the backup pushes the task's stand-in tail at its
    end, the victim its late copy; every shard applies one per task and
    drops every late tail."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.coord.demo import elastic_scenario

    tasks, pushed = {}, {}

    def hook(j, step, opt):
        if j not in tasks:
            tasks[j] = []
            real = opt.coord._on_speculate
            def on_speculate(*a, _real=real, _box=tasks[j]):
                _box.append(a)
                _real(*a)
            opt.coord._on_speculate = on_speculate
        if step != steps - 1:
            return
        victim = j == 2
        if not victim:
            # the backup: wait (bounded) for the straggler to be found
            deadline = time.monotonic() + 60
            while not tasks[j] and time.monotonic() < deadline:
                time.sleep(0.05)
        if tasks[j]:
            tid = tasks[j][0][0]
            upd = np.zeros(opt._flat_n, np.float32)
            upd[:8] = 1e-3  # the tail's stand-in contribution
            opt.push_speculative(tid, upd)
            pushed[j] = (tid, time.monotonic())

    t0 = time.monotonic()
    out = elastic_scenario(steps=steps, n_workers=2, n_shards=2, slow_worker=2,
                           slow_factor=slow_s, speculation=True, lease=SPEC_LEASE,
                           model=model, device=device, step_hook=hook)
    require(out["ok"], f"speculation scenario: {out['errors']}")
    decisions = [e for e in out["events"] if e.startswith("straggler:")]
    task_ids = {t[0] for v in tasks.values() for t in v}
    require(len(decisions) == len(task_ids) == 1 and set(pushed) == {1, 2},
            f"decisions {decisions}, tasks {tasks}, pushed {pushed}")
    late = 1 if pushed[2][1] > pushed[1][1] else 0
    for sid, st in out["stats"].items():
        require(st["spec_applied"] == len(task_ids) and st["spec_dropped"] == late == 1,
                f"shard {sid}: spec_applied {st['spec_applied']}, spec_dropped "
                f"{st['spec_dropped']} (tasks {len(task_ids)}, late tails {late})")
    emit({"phase": "elastic_speculation", "ok": True, "model": model, "device": device,
          "wall_s": time.monotonic() - t0, "slow_s_per_step": slow_s,
          "straggler_decisions": decisions, "tasks": {str(j): v for j, v in tasks.items()},
          "backup_pushed_s_before_victim": pushed[2][1] - pushed[1][1],
          "shard_stats": {str(k): v for k, v in out["stats"].items()}})


def phase_elastic(torch, backend="cuda", model="alexnet", processes=None):
    """Phase 21: (a) the elastic world as processes, (b) the chaos
    acceptance world, (c) speculation; returns (a)'s workers' launches.
    ``processes`` overrides (a)'s step counts (a CPU rehearsal's)."""
    launches = phase_elastic_processes(backend, model, **(processes or {}))
    phase_chaos_world(torch, model, backend)
    phase_speculation(model, backend)
    return launches


#: phase 22: the drills' batch (the DownPour batch) and the worlds' sizes
DRILL_BATCH, DRILL_WORKERS, DRILL_SHARDS = 64, 2, 2


def _zero_kernel_counts() -> None:
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu

    fu.launches = 0
    for k in fc.launches:
        fc.launches[k] = 0


def _kernel_counts() -> dict:
    from distributed_ml_pytorch_tpu_torch.ops import fused_conv as fc
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu

    return {"flat_axpy": fu.launches, "relu_pool2_fwd": fc.launches["relu_pool2_fwd"],
            "relu_pool2_bwd": fc.launches["relu_pool2_bwd"]}


def _require_step_counts(counts, device_steps, forwards, what):
    """K1 once a worker step that updated, K2 three times a forward and a
    backward (AlexNet's three relu->pool tails)."""
    require(counts["flat_axpy"] == device_steps
            and counts["relu_pool2_fwd"] == 3 * forwards
            and counts["relu_pool2_bwd"] == 3 * forwards,
            f"{what}: kernel counts {counts} for {device_steps} updates, {forwards} steps")


def _drill_run(torch, fn, base, **kw):
    """One first run of a phase 22 part: counts zeroed just before, read
    just after; its state under ``base``."""
    os.makedirs(base, exist_ok=True)
    if kw.get("device") == "cuda":
        torch.cuda.synchronize()
    _zero_kernel_counts()
    out = fn(base_dir=base, **kw)
    if kw.get("device") == "cuda":
        torch.cuda.synchronize()
    return out, _kernel_counts()


def phase_recovery_drill(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 22 (a); returns its first run's kernel counts."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, recovery_drill
    from distributed_ml_pytorch_tpu_torch.coord.manifest import FleetManifest

    t0 = time.monotonic()
    kw = dict(seed=0, plan=default_drill_plan(0), model=model, batch=batch)
    out, counts = _drill_run(torch, recovery_drill, os.path.join(tmp, "drill0"),
                             device=device, **kw)
    require(out["ok"], f"recovery drill: errors {out['errors']}, events {out['events'][-6:]}")
    manifest = FleetManifest.from_dict(out["manifest"]).validate()
    for i, seq in out["restored_apply_seqs"].items():
        require(seq >= manifest.entry_for(1 + i).apply_seq,
                f"shard {i} restored apply seq {seq} behind the manifest's")
    require(len(out["restored_apply_seqs"]) == DRILL_SHARDS, "not every shard restored")
    require(out["replayed_updates"] > 0, "the restore replayed no WAL record")
    require(out["accounting_ok"], f"acked {out['acked']} > applied {out['applied']}")
    require(out["served_again"] and out["mttr_s"] is not None,
            "a restored shard never served a pull")
    steps = sum(len(v) for v in out["losses"].values())
    if device == "cuda":
        _require_step_counts(counts, steps, steps, "recovery drill")
    again = recovery_drill(base_dir=os.path.join(tmp, "drill1"), device=device, **kw)
    # a run on the CPU already is the CPU's run
    on_cpu = (again if device == "cpu" else
              recovery_drill(base_dir=os.path.join(tmp, "drill2"), device="cpu", **kw))
    require(again["ok"] and on_cpu["ok"], f"a comparison drill failed: {again['errors']} "
            f"{on_cpu['errors']}")
    log = out["chaos_lines"]
    require(log and log == again["chaos_lines"], "the drill's chaos log differs between runs")
    require(log == on_cpu["chaos_lines"], "the drill's chaos log on the card differs from the "
            "CPU's")
    emit({"phase": "recovery_drill", "ok": True, "model": model, "device": device,
          "batch": batch, "mttr_ms": out["mttr_s"] * 1e3, "restore_ms": out["restore_s"] * 1e3,
          "replayed_records": out["replayed_updates"],
          "restored_apply_seqs": out["restored_apply_seqs"],
          "manifest_apply_seqs": {s.server_id: s.apply_seq for s in manifest.shards},
          "acked": out["acked"], "applied": out["applied"], "chaos_counts": out["chaos_counts"],
          "mttr_ms_runs": [r["mttr_s"] * 1e3 for r in (out, again, on_cpu)],
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    return counts


def phase_health(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 22 (b); returns the run's kernel counts."""
    from distributed_ml_pytorch_tpu_torch.coord.health import health_scenario

    t0 = time.monotonic()
    base = os.path.join(tmp, "health")
    out, counts = _drill_run(torch, health_scenario, base, seed=0, model=model, device=device,
                             batch=batch)
    require(out["ok"], f"health scenario: errors {out['errors']}, events {out['events'][-8:]}")
    require(out["nacks_explicit"] and out["quarantined_total"] > 0,
            f"quarantined {out['quarantined_total']}, nacks {out['nacks_sent_total']}")
    # matched by delivery envelope as the records were appended, before the
    # rollback dropped the log's tail: the scaled (finite) pushes count too
    require(out["wal_clean"] and out["quarantined_in_wal"] == 0,
            f"{out['quarantined_in_wal']} quarantined push(es) appended to a WAL, "
            f"{out['wal_appended']} appended in all")
    require(any("worker 4 lease REVOKED" in e for e in out["events"]),
            "the poisoned worker (coordinator rank 4) was not revoked")
    require(out["rollbacks"] >= 1 and out["rollback_reports"] == [1, 2],
            f"rollbacks {out['rollbacks']}, RollbackDone from {out['rollback_reports']}")
    require(out["rollback_bit_identical"] is True,
            "a shard's rollback differs from a fresh restore of the same files")
    applied = sum(sum(d.values()) for d in out["applied"].values())
    seen = applied + out["quarantined_total"]
    steps = sum(len(v) for v in out["losses"].values())
    emit({"phase": "health", "ok": True, "model": model, "device": device, "batch": batch,
          "reject_rate_pct": 100.0 * out["quarantined_total"] / seen if seen else 0.0,
          "nack_round_trips": sum(out["worker_nacks"].values()),
          "rollback_mttr_ms": out["rollback_mttr_s"] * 1e3,
          "rollbacks": out["rollbacks"], "revoked_workers": out["revoked_workers"],
          "quarantined": out["quarantined_total"], "chaos_counts": out["chaos_counts"],
          "steps": steps, "probes": out["probes"], "wal_appended": out["wal_appended"],
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    if device == "cuda":
        # the poisoned worker's loss probes while the watchdog is armed are
        # forwards of their own
        require(0 < counts["flat_axpy"] <= steps
                and counts["relu_pool2_fwd"] == 3 * (steps + out["probes"])
                and counts["relu_pool2_bwd"] == 3 * steps,
                f"health: kernel counts {counts} for {steps} steps, {out['probes']} probes")
    return counts


def phase_coordfail(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 22 (c); returns the run's kernel counts."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import coordfail_drill

    t0 = time.monotonic()
    steps = 20
    out, counts = _drill_run(torch, coordfail_drill, os.path.join(tmp, "coordfail"), seed=0,
                             steps=steps, kill_during="snapshot", model=model, device=device,
                             batch=batch)
    require(out["ok"], f"coordfail drill: errors {out['errors']}, violations "
            f"{out['violations']}, events {out['events2'][-6:]}")
    require(out["epochs"] == (1, 2), f"epochs {out['epochs']}")
    require(not out["evictions"], f"members evicted: {out['evictions']}")
    require(out["manifests_written"][1] >= 1, "the new life published no manifest")
    done = sum(len(v) for v in out["losses"].values())
    if device == "cuda":
        _require_step_counts(counts, done, done, "coordfail drill")
    emit({"phase": "coordfail", "ok": True, "model": model, "device": device, "batch": batch,
          "steps_lost": steps * DRILL_WORKERS - done, "mttr_ms": out["mttr_s"] * 1e3,
          "restore_ms": out["restore_s"] * 1e3, "outage_ms": out["outage_s"] * 1e3,
          "restored_members": out["restored_members"], "epochs": out["epochs"],
          "stale_epoch_dropped": out["stale_epoch_dropped"],
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    return counts


def phase_durability(torch, model="alexnet", device="cuda"):
    """Phase 22: (a) the recovery drill, (b) the health scenario, (c) the
    coordinator-failure drill; returns their first runs' kernel counts."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_durability_")
    launches = {}
    try:
        for part in (phase_recovery_drill, phase_health, phase_coordfail):
            _add_launches(launches, part(torch, tmp, model, device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_sched_drill(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 23 (a); returns ``(first run's output, its kernel counts)``."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import default_drill_plan, sched_drill

    t0 = time.monotonic()
    kw = dict(seed=0, plan=default_drill_plan(0), batch=batch)
    out, counts = _drill_run(torch, sched_drill, os.path.join(tmp, "sched0"), model=model,
                             device=device, **kw)
    s = out["sched"]
    require(out["ok"] and not out["violations"] and not out["errors"],
            f"sched drill: violations {out['violations']}, errors {out['errors']}, events "
            f"{out['events'][-8:]}")
    require(s["preempts_done"] == 1 and s["resumes_done"] == 1,
            f"{s['preempts_done']} preempt(s), {s['resumes_done']} resume(s)")
    require(s["audit"] == [], f"ledger audit: {s['audit']}")
    require(out["replayed_updates"] > 0, "the resume replayed no WAL record")
    require(out["bit_identical"] is True, "the resumed shard differs from the parked one")
    require(all(a <= out["applied"][i][j] for i, w in out["acked"].items() for j, a in w.items()),
            f"acked {out['acked']} > applied {out['applied']}")
    require(out["chaos_counts"].get("drop", 0) > 0, f"no drop in {out['chaos_counts']}")
    steps = sum(len(v) for v in out["losses"].values())
    if device == "cuda":
        _require_step_counts(counts, steps, steps, "sched drill")
    again = sched_drill(base_dir=os.path.join(tmp, "sched1"), model=model, device=device, **kw)
    on_cpu = sched_drill(base_dir=os.path.join(tmp, "sched2"), model="lenet", device="cpu",
                         **dict(kw, batch=16))
    require(again["ok"] and on_cpu["ok"], f"a comparison drill failed: {again['violations']} "
            f"{again['errors']} {on_cpu['violations']} {on_cpu['errors']}")
    log = out["chaos_lines"]
    require(log and log == again["chaos_lines"], "the sched drill's chaos log differs between "
            "runs")
    require(log == on_cpu["chaos_lines"], "the sched drill's chaos log on the card differs from "
            "the CPU's")
    emit({"phase": "sched_drill", "ok": True, "model": model, "device": device, "batch": batch,
          "preempt_mttr_ms": s["preempt_mttr_s"][0] * 1e3,
          "resume_mttr_ms": s["resume_mttr_s"][0] * 1e3,
          "preempt_mttr_ms_runs": [r["sched"]["preempt_mttr_s"][0] * 1e3
                                   for r in (out, again, on_cpu)],
          "resume_mttr_ms_runs": [r["sched"]["resume_mttr_s"][0] * 1e3
                                  for r in (out, again, on_cpu)],
          "held_pushes": out["held_pushes"], "replayed_records": out["replayed_updates"],
          "apply_seq_parked": out["apply_seq_parked"], "acked": out["acked"],
          "applied": out["applied"], "chaos_counts": out["chaos_counts"], "steps": steps,
          "day_s": out["wall_s"], "peak_window_s": out["peak_window_s"],
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    return out, counts


def phase_coordfail_preempt(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 23 (b); returns the run's kernel counts."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import coordfail_drill

    t0 = time.monotonic()
    steps = 20
    out, counts = _drill_run(torch, coordfail_drill, os.path.join(tmp, "coordfail_preempt"),
                             seed=0, steps=steps, kill_during="preempt", model=model,
                             device=device, batch=batch)
    require(out["ok"], f"coordfail preempt drill: errors {out['errors']}, violations "
            f"{out['violations']}, events {out['events2'][-8:]}")
    require(out["epochs"] == (1, 2), f"epochs {out['epochs']}")
    require(not out["evictions"], f"members evicted: {out['evictions']}")
    require(out["stranded"] == [], f"parked rank(s) stranded: {out['stranded']}")
    require(out["resumes_done"] == 1 and out["bit_identical"] is True,
            f"resumes {out['resumes_done']}, bit-identical {out['bit_identical']}")
    done = sum(len(v) for v in out["losses"].values())
    if device == "cuda":
        _require_step_counts(counts, done, done, "coordfail preempt drill")
    emit({"phase": "coordfail_preempt", "ok": True, "model": model, "device": device,
          "batch": batch, "steps_lost": steps * DRILL_WORKERS - done,
          "mttr_ms": out["mttr_s"] * 1e3, "restore_ms": out["restore_s"] * 1e3,
          "outage_ms": out["outage_s"] * 1e3, "epochs": out["epochs"],
          "restored_members": out["restored_members"],
          "replayed_records": out["replayed_updates"], "grants": out["grants"],
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    return counts


def phase_sched_serving(torch, drill_out, device="cuda"):
    """Phase 23 (c): the ``sched`` leg's serving burst; returns its K8
    launches. On the card: one K8 launch per layer and decode step the
    engine took, none of the reference, and K8 held to the reference on
    the inputs of its call at the longest cache."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving.cache import SlotKVPool

    t0 = time.monotonic()
    if device == "cuda":
        torch.cuda.synchronize()
    # the decode steps the engine takes, and a copy of the inputs of K8's
    # first call at the longest big cache it passed
    steps, longest = [0], []
    real_block, real_k8 = SlotKVPool.decode_block_step, da.decode_attention_cuda

    def count_block(pool, *args):
        steps[0] += pool.decode_block
        return real_block(pool, *args)

    def record_inputs(*args):
        if not longest or args[3].shape[2] > longest[0][3].shape[2]:
            longest[:] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)]
        return real_k8(*args)

    SlotKVPool.decode_block_step, da.decode_attention_cuda = count_block, record_inputs
    da.launches = 0
    try:
        with _ReferenceCalls(da) as ref:
            rate, ttft_p50 = bench_all._serving_slot_rate(device)
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        SlotKVPool.decode_block_step, da.decode_attention_cuda = real_block, real_k8
    k8 = da.launches
    # one decode attention per layer and decode step: K8 on the card, the
    # reference (and never K8) on the CPU
    n_layers = bench_all.TINY_LM["n_layers"]
    calls, other = (k8, ref.n) if device == "cuda" else (ref.n, k8)
    require(steps[0] > 0 and calls == n_layers * steps[0] and other == 0,
            f"the serving burst ran K8 {k8} and the reference {ref.n} times on {device}, want "
            f"{n_layers} layers x {steps[0]} decode steps of one of them")
    check = None
    if device == "cuda":
        args = longest[0]
        tol = DECODE_TOL["float32"]
        mx, rel, ok = _err(torch, da.decode_attention_cuda(*args),
                           da.decode_attention_reference(*args), da.decode_error_scale(*args),
                           tol)
        b, h, C, d = args[3].shape
        check = {"b": b, "h": h, "C": C, "head_dim": d, "dtype": str(args[0].dtype),
                 "max_abs_err": mx, "max_err_over_scale": rel, "tolerance": tol}
        require(args[0].dtype == torch.float32, f"the burst ran K8 at {args[0].dtype}")
        require(ok, f"K8 on the burst's inputs (C={C}, head_dim {d}): {mx} ({rel} of the "
                "scale)")
    uplift, extra = bench_all.sched_goodput(drill_out, rate, ttft_p50)
    emit({"phase": "sched_serving", "ok": True, "device": device,
          "serve_tokens_per_s": rate, "serve_ttft_p50_ms": ttft_p50,
          "sched_goodput_uplift": uplift, "goodput": extra, "decode_steps": steps[0],
          "reference_calls": ref.n, "k8_at_longest_cache": check,
          "wall_s": time.monotonic() - t0, "kernel_counts": {"decode_attention": k8}})
    return k8


def phase_sched(torch, model="alexnet", device="cuda"):
    """Phase 23: (a) the scheduler drill, (b) the coordinator's death with
    a shard parked, (c) the serving burst that prices the borrowed slot;
    returns every launch of their first runs."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_sched_")
    try:
        out, launches = phase_sched_drill(torch, tmp, model, device)
        launches = dict(launches)
        _add_launches(launches, phase_coordfail_preempt(torch, tmp, model, device))
        launches["decode_attention"] = phase_sched_serving(torch, out, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ phase 24

#: (b)'s fleet: engines, slots each, requests, their generation lengths
FLEET_ENGINES, FLEET_SLOTS, FLEET_REQUESTS, FLEET_NEW = 3, 4, 12, (40, 64)


def phase_gray_drill(torch, tmp, model="alexnet", device="cuda", batch=DRILL_BATCH):
    """Phase 24 (a); returns the contained leg's first run's kernel counts."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import gray_drill

    t0 = time.monotonic()
    out, counts = _drill_run(torch, gray_drill, os.path.join(tmp, "gray0"), seed=0,
                             model=model, device=device, batch=batch)
    g = out["gray"]
    require(out["ok"] and not out["violations"] and not out["errors"],
            f"gray drill: violations {out['violations']}, errors {out['errors']}, events "
            f"{out['events'][-8:]}")
    require(g["probations"] >= 1 and g["quarantines"] >= 1 and g["evictions"] == 0
            and g["recoveries"] >= 1, f"gray ladder {g}")
    require(out["bit_identical"] is True, "the resumed shard differs from the parked one")
    require(not [e for e in out["events"] if "lease expired" in e and " 1 " in e],
            "the renewing victim's lease expired")
    require(all(a <= out["applied"][i][j] for i, w in out["acked"].items() for j, a in w.items()),
            f"acked {out['acked']} > applied {out['applied']}")
    require(out["chaos_counts"].get("gray-partition", 0) > 0,
            f"no gray partition in {out['chaos_counts']}")
    steps = sum(len(v) for v in out["losses"].values())
    if device == "cuda":
        _require_step_counts(counts, steps, steps, "gray drill")
    kw = dict(seed=0, model=model, device=device, batch=batch)
    # a run on the CPU already is the CPU's run
    again = (out if device == "cpu"
             else gray_drill(base_dir=os.path.join(tmp, "gray1"), **kw))
    on_cpu = (out if device == "cpu"
              else gray_drill(base_dir=os.path.join(tmp, "gray2"),
                              **dict(kw, model="lenet", device="cpu", batch=16)))
    require(again["ok"] and on_cpu["ok"], f"a comparison drill failed: {again['violations']} "
            f"{again['errors']} {on_cpu['violations']} {on_cpu['errors']}")
    log = out["chaos_lines"]
    require(log and log == again["chaos_lines"], "the gray drill's chaos log differs between "
            "runs")
    require(log == on_cpu["chaos_lines"], "the gray drill's chaos log on the card differs from "
            "the CPU's")
    off = gray_drill(base_dir=os.path.join(tmp, "gray_off"), contain=False, **kw)
    require(off["ok"] and off["gray"]["probations"] == 0 and off["fixed_wall_s"] is not None,
            f"the unmanaged leg: {off['violations']} {off['errors']} {off['gray']}")
    require(off["chaos_lines"] == log, "the unmanaged leg's chaos log differs")
    emit({"phase": "gray_drill", "ok": True, "model": model, "device": device, "batch": batch,
          "detect_latency_ms": out["detect_latency_s"] * 1e3,
          "containment_mttr_ms": out["containment_mttr_s"] * 1e3,
          "detect_latency_ms_runs": [r["detect_latency_s"] * 1e3 for r in (out, again, on_cpu)],
          "containment_mttr_ms_runs": [r["containment_mttr_s"] * 1e3
                                       for r in (out, again, on_cpu)],
          "victim_slice_goodput_contained": sum(out["applied"][0].values()) / out["wall_s"],
          "victim_slice_goodput_unmanaged": sum(off["applied"][0].values()) / off["wall_s"],
          "fixed_wall_s": [out["fixed_wall_s"], off["fixed_wall_s"]],
          "day_s": [out["wall_s"], off["wall_s"]], "gray": g,
          "replayed_records": out["replayed_updates"], "acked": out["acked"],
          "applied": out["applied"], "chaos_counts": out["chaos_counts"], "steps": steps,
          "wall_s": time.monotonic() - t0, "kernel_counts": counts})
    return counts


def _fleet_requests(vocab):
    """(b)'s greedy requests: seeded prompts of 4-19 tokens and their lengths."""
    import numpy as np

    rng = np.random.default_rng(24)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 20))).astype(np.int32),
             int(rng.integers(*FLEET_NEW))) for _ in range(FLEET_REQUESTS)]


def phase_fleet(torch, device="cuda", width=()):
    """Phase 24 (b); returns its K8 launches. ``width`` are serving CLI
    flags over the defaults (the CPU rehearsal's narrower model)."""
    import numpy as np

    from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
        KIND_ENGINE,
        Coordinator,
        encode_join,
        encode_renew,
    )
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.serving import cli as serving_cli
    from distributed_ml_pytorch_tpu_torch.serving.cache import SlotKVPool
    from distributed_ml_pytorch_tpu_torch.serving.fleet import (
        EngineMember,
        FleetAutoscaler,
        FleetRouter,
    )
    from distributed_ml_pytorch_tpu_torch.serving.frontend import ServingClient
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode

    t0 = time.monotonic()
    args = serving_cli.parse_args(["--backend", device, "--slots", str(FLEET_SLOTS), *width])
    lm = serving_cli.build_model(args)
    requests = _fleet_requests(args.vocab)
    # the uninterrupted run: every request on one engine, outside the count
    ref_engine = serving_cli.make_engine(lm, args)
    handles = [ref_engine.submit(p, n, request_id=i) for i, (p, n) in enumerate(requests)]
    ref_engine.run_until_idle()
    want = [h.tokens for h in handles]
    require(all(len(w) == n for w, (_, n) in zip(want, requests)), "the reference run fell short")

    def warmed(engine_id):
        engine = serving_cli.make_engine(lm, args)
        w = engine.submit(np.zeros(args.prefill_bucket, np.int32), 2)
        engine.run_until_idle()
        require(w.done, "an engine's warm-up did not finish")
        engine.reset_metrics()
        return EngineMember(engine_id, engine)

    if device == "cuda":
        torch.cuda.synchronize()
    steps, longest = [0], []
    real_block, real_k8 = SlotKVPool.decode_block_step, da.decode_attention_cuda

    def count_block(pool, *a):
        steps[0] += pool.decode_block
        return real_block(pool, *a)

    def record_inputs(*a):
        if not longest or a[3].shape[2] > longest[0][3].shape[2]:
            longest[:] = [tuple(x.clone() if torch.is_tensor(x) else x for x in a)]
        return real_k8(*a)

    SlotKVPool.decode_block_step, da.decode_attention_cuda = count_block, record_inputs
    da.launches = 0
    world = InProcessTransport.create_world(2)
    router = None
    try:
        with _ReferenceCalls(da) as ref:
            members = [warmed(i).start() for i in range(FLEET_ENGINES)]
            # a crash reads as dead at once (``alive``); the probe's timeout
            # only guards against a silent serve loop
            router = FleetRouter(world[0], members, probe_timeout=30.0)
            serve = threading.Thread(target=router.serve_forever, daemon=True)
            serve.start()
            client = ServingClient(world[1], resume_after=0.25)
            # probation bends the first request (a tie, which engine 0 would
            # win) away from engine 0 without marking it down
            router.note_gray(0)
            rids = [client.submit(*requests[0])]
            require(_wait(lambda: len(router._routes) == 1, 30), "the first request never routed")
            with router._routes_lock:
                first_engine = [r.engine_id for r in router._routes.values()][0]
            gray_up = router.fleet_summary()["engines"][0]["up"]
            require(first_engine != 0 and gray_up,
                    f"probation routed to engine {first_engine}, engine 0 up {gray_up}")
            router.clear_gray(0)
            rids += [client.submit(p, n) for p, n in requests[1:]]
            victim = {}

            def mid_stream():
                with router._routes_lock:
                    for r in router._routes.values():
                        if not r.done and r.engine_id >= 0 and len(r.tokens) >= 2:
                            victim["id"] = r.engine_id
                            return True
                return False

            require(_wait(mid_stream, 60), "no stream ever got mid-decode")
            members[victim["id"]].crash()
            got = [list(client.stream(r, timeout=300)) for r in rids]
            summary = router.fleet_summary()
            # the autoscaler on the coordinator's advice: engine renewals
            # past the high mark spawn one, below the low mark retire one
            next_id = [FLEET_ENGINES]

            def factory():
                next_id[0] += 1
                return warmed(next_id[0])

            scaler = FleetAutoscaler(router, factory, min_engines=1, max_engines=FLEET_ENGINES + 1)
            now = [1000.0]
            coord = Coordinator(None, 8, engine_occ_high=0.8, engine_occ_low=0.2,
                                scale_cooldown=1.0, on_scale=scaler.on_scale,
                                clock=lambda: now[0])
            for rank in (1, 2):
                coord.handle(rank, MessageCode.CoordJoin, encode_join(KIND_ENGINE, 1))
                coord.handle(rank, MessageCode.LeaseRenew, encode_renew(1, 95, 2, 50.0))
            up = coord.check_engine_scaling()
            require(up == "up" and scaler.quiesce(120), f"scale-up advice {up}")
            n_up = len(router.members)
            for rank in (1, 2):
                coord.handle(rank, MessageCode.LeaseRenew, encode_renew(1, 5, 0, 1.0))
            now[0] += 2.0
            down = coord.check_engine_scaling()
            require(down == "down" and scaler.quiesce(120), f"scale-down advice {down}")
            scaled = scaler.summary()
            tail = client.generate(*requests[1], timeout=120)
            router.stop()
            serve.join(timeout=10)
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        SlotKVPool.decode_block_step, da.decode_attention_cuda = real_block, real_k8
        if router is not None:
            router.stop()
        for t in world.values():
            t.close()
    k8 = da.launches
    identical = [g == w for g, w in zip(got, want)]
    first_diff = None
    if not all(identical):
        i = identical.index(False)
        j = next((k for k, (a, b) in enumerate(zip(got[i], want[i])) if a != b),
                 min(len(got[i]), len(want[i])))
        first_diff = {"request": i, "position": j, "migrated_len": len(got[i]),
                      "reference_len": len(want[i])}
    require(all(len(g) == n for g, (_, n) in zip(got, requests)),
            f"a stream fell short: {[len(g) for g in got]}")
    require(all(identical), f"a migrated stream differs from the uninterrupted run: {first_diff}")
    require(summary["migrations"] >= 1 and summary["migration_failures"] == 0
            and summary["handoffs"] >= 1 and summary["handoff_drops"] == 0
            and summary["mttr_s"] is not None, f"fleet summary {summary}")
    require(n_up == FLEET_ENGINES + 1 and scaled["scaled_up"] == 1
            and scaled["scaled_down"] == 1 and scaled["n_engines"] == FLEET_ENGINES,
            f"autoscaler {scaled} (after the scale-up: {n_up} engines)")
    require(tail == want[1], "the scaled fleet served a request differently")
    calls, other = (k8, ref.n) if device == "cuda" else (ref.n, k8)
    require(steps[0] > 0 and calls == args.n_layers * steps[0] and other == 0,
            f"the fleet ran K8 {k8} and the reference {ref.n} times on {device}, want "
            f"{args.n_layers} layers x {steps[0]} decode steps of one of them")
    check = None
    if device == "cuda":
        a = longest[0]
        tol = DECODE_TOL["float32"]
        mx, rel, ok = _err(torch, da.decode_attention_cuda(*a), da.decode_attention_reference(*a),
                           da.decode_error_scale(*a), tol)
        b, h, C, d = a[3].shape
        check = {"b": b, "h": h, "C": C, "head_dim": d, "dtype": str(a[0].dtype),
                 "max_abs_err": mx, "max_err_over_scale": rel, "tolerance": tol}
        require(ok, f"K8 on the fleet's inputs (C={C}, head_dim {d}): {mx} ({rel} of the scale)")
    emit({"phase": "fleet", "ok": True, "device": device, "engines": FLEET_ENGINES,
          "slots": FLEET_SLOTS, "requests": FLEET_REQUESTS,
          "tokens": sum(len(g) for g in got), "crashed_engine": victim["id"],
          "migrations": summary["migrations"], "handoffs": summary["handoffs"],
          "handoff_wire_floats": summary["handoff_wire_floats"],
          "handoff_dense_floats": summary["handoff_dense_floats"],
          "migration_mttr_ms": summary["mttr_s"] * 1e3, "gray_first_engine": first_engine,
          "autoscaler": scaled, "decode_steps": steps[0], "reference_calls": ref.n,
          "k8_at_longest_cache": check, "wall_s": time.monotonic() - t0,
          "kernel_counts": {"decode_attention": k8}})
    return k8


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return False


def phase_gray_fleet(torch, model="alexnet", device="cuda", width=()):
    """Phase 24: (a) the gray drill, (b) the serving fleet; returns every
    launch of their first runs."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke_gray_")
    try:
        launches = dict(phase_gray_drill(torch, tmp, model, device))
        launches["decode_attention"] = phase_fleet(torch, device, width)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------------ phase 25

#: phase 25's ResNet trainer steps, (model, image size, classes, dtype,
#: batch): config 4's CIFAR shapes and config 5's ImageNet shapes
RESNET_CASES = (("resnet18", 32, 10, "float32", 64), ("resnet18", 32, 10, "bfloat16", 256),
                ("resnet50", 224, 1000, "float32", 32),
                ("resnet50", 224, 1000, "bfloat16", 256))
#: the CPU rehearsal's cases: the same models at batch 4 (ResNet-50 at 72 x
#: 72, still the ImageNet stem)
TINY_RESNET_CASES = (("resnet18", 32, 10, "float32", 4), ("resnet18", 32, 10, "bfloat16", 4),
                     ("resnet50", 72, 10, "float32", 4), ("resnet50", 72, 10, "bfloat16", 4))
#: steps on one batch, and their lr: the recipe's 0.008 does not bring a
#: fresh GroupNorm ResNet's loss down within five steps, in either package
RESNET_STEPS, RESNET_LR = 5, 0.001
#: the ResNet-18 DownPour world: two workers of this many steps at batch 64
RESNET_DOWNPOUR_STEPS = 20
#: the MoE LM (config 6's MoE leg: GPT-2-small widths, 4 experts top-1,
#: capacity factor 2.0, bf16, 8 x 2048): SGD steps on one batch and their lr
MOE_STEPS, MOE_LR = 4, 0.5
#: MoE generate(): batch, prompt and new tokens (two decode blocks), float32
MOE_GEN = (8, 64, 33)
#: kernel-name substrings grouping a ResNet step's device time (first match
#: wins): cuDNN's convolutions by pass, PyTorch's GroupNorm kernels, the
#: dtype casts and copies around them, the other elementwise passes
RESNET_GROUPS = {
    "conv wgrad": ["wgrad"],
    "conv dgrad": ["dgrad"],
    "conv fwd": ["fprop", "implicit_gemm", "convolve", "conv2d"],
    "group_norm": ["GroupNorm", "group_norm", "RowwiseMoments", "ComputeFusedParams",
                   "ComputeInternalGradients", "Compute1dBackward", "GammaBeta",
                   "ComputeBackward"],
    "copy/cast": ["copy", "convert"],
    "elementwise": ["elementwise", "reduce_kernel", "relu", "threshold"],
}


def _card(torch, device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    return nvidia_smi_line() if device == "cuda" else "cpu"


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _resnet_steps(torch, name, image, classes, dtype, batch, device, profile=False):
    """RESNET_STEPS SGD steps (lr RESNET_LR) of a seed-0 ResNet on one
    ``bench_all.make_batch`` batch through ``training.trainer``'s step;
    ``profile``: one more step under ``utils/devprof`` on the card. Returns
    the part's line."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )

    _peak_gb(torch, device, reset=True)
    model = get_model(name, num_classes=classes, seed=0, device=device, dtype=dtype,
                      input_size=image)
    tx = SGD(RESNET_LR)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx)
    images, labels = bench_all.make_batch(batch, shape=(image, image, 3), n_classes=classes)
    x, y = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        losses.append(float(step(state, x, y)[1]))
        times.append(time.perf_counter() - t0)
    step_s = sum(times[1:]) / (len(times) - 1)
    n_params = sum(p.numel() for p in model.parameters())
    line = {"model": name, "image": image, "classes": classes, "dtype": dtype,
            "batch": batch, "params": n_params, "losses": losses,
            "step_ms": step_s * 1e3, "images_per_s": batch / step_s,
            "peak_mem_gb": _peak_gb(torch, device), "card": _card(torch, device)}
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"{name} {dtype} b{batch}: losses not finite and falling: {losses}")
    if profile and device == "cuda":
        from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

        line["profile"] = kernel_breakdown(lambda: step(state, x, y)[1], RESNET_GROUPS)
    del model, state, step
    return line


def phase_resnet(torch, device="cuda", tiny=False):
    """Phase 25 (a), (b): ResNet trainer steps, then the ResNet-18 DownPour
    world and K1 at ResNet-18's flat length; returns ``(K1 launches, K1's
    largest error)``."""
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.ops import fused_update as fu
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import init_downpour_accumulator

    full_float32()
    t0 = time.monotonic()
    cases = TINY_RESNET_CASES if tiny else RESNET_CASES
    # the last case (ResNet-50 bf16) profiled: where a step's time goes
    lines = [_resnet_steps(torch, *case, device, profile=i == len(cases) - 1)
             for i, case in enumerate(cases)]
    emit({"phase": "resnet_trainer_steps", "ok": True, "steps": RESNET_STEPS,
          "lr": RESNET_LR, "runs": lines, "wall_s": time.monotonic() - t0})

    # (a) the DownPour world of ResNet-18: K1 once a worker step
    steps = RESNET_DOWNPOUR_STEPS
    batch = 8 if tiny else 64
    srv, per_worker, launches, wall, _records = _downpour_world(
        torch, ["--chunked-dispatch", "off", "--model", "resnet18", "--lr", str(RESNET_LR)],
        device, steps, batch, steady=False)
    total = sum(w["steps"] for w in per_worker.values())
    np = __import__("numpy")
    model = get_model("resnet18", seed=0, device=device)
    _flat, n, pad, _acc = init_downpour_accumulator(model)
    del model
    # K1 at ResNet-18's padded flat length, against its plain version
    g = torch.Generator(device=device).manual_seed(25)
    y0 = torch.randn(n + pad, generator=g, device=device)
    x = torch.randn(n + pad, generator=g, device=device)
    err, k1 = 0.0, None
    if device == "cuda":
        for alpha in (1.0, -RESNET_LR):
            yk = fu.flat_axpy_cuda(y0.clone(), x, alpha)
            yp = fu.flat_axpy_plain(y0.clone(), x, alpha)
            torch.cuda.synchronize()
            require(torch.equal(yk, yp), f"flat_axpy kernel != plain at n={n + pad}, "
                    f"alpha={alpha}")
            err = max(err, float((yk - yp).abs().max()))
        k1 = {"n": n + pad, "max_abs_err": err,
              "ms": device_ms(lambda: fu.flat_axpy_cuda(y0, x, 1.0)),
              "plain_ms": device_ms(lambda: fu.flat_axpy_plain(y0, x, 1.0)),
              "bound_ms": bound_ms(3 * 4 * (n + pad))}
    emit({"phase": "resnet_downpour_world", "ok": True, "model": "resnet18", "workers": 2,
          "batch": batch, "steps": steps, "flat_floats": n, "frame_mb": 4 * n / 1e6,
          "wall_s": wall, "per_worker": per_worker, "launches": launches,
          "central_finite": bool(np.isfinite(srv.central).all()), "k1_at_resnet18": k1,
          "card": _card(torch, device)})
    require(srv.central.shape[0] == n, f"the server's vector has {srv.central.shape[0]} "
            f"floats, ResNet-18 {n}")
    require(bool(np.isfinite(srv.central).all()), "central vector not finite")
    for r, w in per_worker.items():
        ls = w["losses"]
        require(w["steps"] == steps, f"worker {r} took {w['steps']} steps of {steps}")
        require(all(math.isfinite(v) for v in ls) and sum(ls[-5:]) < sum(ls[:5]),
                f"worker {r}'s ResNet-18 loss did not fall: {ls}")
    if device == "cuda":
        require(launches["flat_axpy"] == total,
                f"flat_axpy launched {launches['flat_axpy']} times for {total} steps")
    return launches["flat_axpy"], err


def _plain_attention_calls(at):
    """Counts calls of the attention kernels' plain versions while
    installed (on the card the model's step must never reach them)."""
    names = ("flash_fwd_plain", "flash_bwd_fused_plain", "flash_bwd_split_plain")

    class Calls:
        n = 0

        def __enter__(self):
            self.real = {name: getattr(at, name) for name in names}
            for name, fn in self.real.items():
                def counted(*a, _fn=fn, **k):
                    self.n += 1
                    return _fn(*a, **k)
                setattr(at, name, counted)
            return self

        def __exit__(self, *exc):
            for name, fn in self.real.items():
                setattr(at, name, fn)

    return Calls()


def phase_moe(torch, device="cuda", tiny=False):
    """Phase 25 (c), (d): the MoE LM's SGD steps (K4, K5) and its greedy
    ``generate()`` on the blocked path (K8); returns ``(launches, errors)``."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
        create_lm_train_state,
        next_token_targets,
    )
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    np = __import__("numpy")
    widths = bench_all.TINY_LM if tiny else bench_all.GPT2_SMALL
    batch, seq = ((bench_all.TINY_MOE_BATCH, bench_all.TINY_MOE_SEQ) if tiny
                  else (bench_all.MOE_BATCH, bench_all.MOE_SEQ))
    n_layers, heads = widths["n_layers"], widths["n_heads"]
    d = widths["d_model"] // heads
    moe_kw = dict(n_experts=bench_all.MOE_EXPERTS, capacity_factor=bench_all.MOE_CAPACITY)

    # (c) SGD steps at the bench widths, bf16, one batch
    _peak_gb(torch, device, reset=True)
    moe = MoETransformerLM(**widths, **moe_kw, max_len=seq, dtype=torch.bfloat16, seed=0,
                           device=device)
    tx = SGD(MOE_LR)
    state = create_lm_train_state(moe, tx)
    step = make_fsdp_lm_train_step(moe, tx)
    tok = np.random.default_rng(0).integers(0, widths["vocab_size"], (batch, seq))
    targets = torch.from_numpy(next_token_targets(tok).astype(np.int64)).to(device)
    tokens = torch.from_numpy(tok.astype(np.int64)).to(device)
    seen, restore = _record_first_call(torch, at, "flash_bwd_fused_cuda")
    _zero_attention_launches(at)
    losses, times = [], []
    try:
        with _plain_attention_calls(at) as plain:
            for _ in range(MOE_STEPS):
                _sync(torch, device)
                t0 = time.perf_counter()
                state, loss = step(state, tokens, targets)
                losses.append(float(loss))
                times.append(time.perf_counter() - t0)
    finally:
        restore()
    launches = dict(at.launches)
    peak = _peak_gb(torch, device)
    step_s = sum(times[1:]) / (len(times) - 1)
    flops = bench_all.moe_lm_flops(moe, batch, seq)
    profile = None
    if device == "cuda":
        from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

        profile = kernel_breakdown(lambda: step(state, tokens, targets)[1], PROFILE_GROUPS)
    lb = [float(v.detach()) for v in moe.load_balance_losses()]
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"MoE losses not finite and falling: {losses}")
    require(launches["flash_fwd"] == n_layers * MOE_STEPS
            and launches["flash_bwd_fused"] == n_layers * MOE_STEPS
            and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
            f"the MoE steps launched {launches} for {MOE_STEPS} steps of {n_layers} layers")
    if device == "cuda":
        require(plain.n == 0, f"the MoE step reached the plain attention {plain.n} times")
    args = seen.pop("args")
    require(tuple(args[0].shape) == (batch * heads, seq, d),
            f"captured q of shape {tuple(args[0].shape)}")
    errs, ms, check_s = _long_check(torch, at, args, ("flash_fwd", "flash_bwd_fused"))
    del args, state, step
    emit({"phase": "moe_lm_steps", "ok": True, "widths": widths, **moe_kw,
          "capacity": moe.blocks()[0].moe.capacity(seq), "dtype": "bfloat16",
          "batch": batch, "seq": seq, "lr": MOE_LR, "losses": losses,
          "load_balance": lb, "step_ms": step_s * 1e3, "tokens_per_s": batch * seq / step_s,
          "flops_per_step": flops, "tflops": flops / step_s / 1e12, "peak_mem_gb": peak,
          "launches": launches, "plain_attention_calls": plain.n, "plain_check_s": check_s,
          "kernels": {k: {"ms": ms[k], "errors": errs[k]} for k in ms},
          "tolerance": ATTN_TOL["bfloat16"], "profile": profile, "card": _card(torch, device)})
    del moe
    if device == "cuda":
        torch.cuda.empty_cache()

    # (d) greedy generate() on the blocked path, float32: K8 in every step
    b, p, new = MOE_GEN
    moe = MoETransformerLM(**widths, **moe_kw, max_len=p + new + gen.DECODE_BLOCK,
                           dtype=torch.float32, seed=1, device=device)
    blocked, padded = gen.uses_block_decode(moe, p, new)
    n_pad = padded - p
    require(blocked, f"MoE generate at prompt {p}, {new} new tokens is not on the blocked path")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, widths["vocab_size"], (b, p))).to(device)
    longest, real_k8 = [], da.decode_attention_cuda

    def record_inputs(*a):
        if not longest or a[3].shape[2] > longest[0][3].shape[2]:
            longest[:] = [tuple(t.clone() if torch.is_tensor(t) else t for t in a)]
        return real_k8(*a)

    da.decode_attention_cuda = record_inputs
    da.launches = 0
    try:
        with _ReferenceCalls(da) as ref:
            _sync(torch, device)
            t0 = time.perf_counter()
            out = gen.generate(moe, prompt, new)
            _sync(torch, device)
            wall = time.perf_counter() - t0
    finally:
        da.decode_attention_cuda = real_k8
    k8 = da.launches
    with torch.no_grad():
        plain_out = gen._generate_plain(gen._decode_model(moe, p + new), new, 0.0, 0, 1.0,
                                        gen.init_cache(moe, b, p + new), prompt, 0)
    calls, other = (k8, ref.n) if device == "cuda" else (ref.n, k8)
    require(out.shape == (b, p + new), f"MoE generate shape {tuple(out.shape)}")
    require(calls == n_layers * n_pad and other == 0,
            f"MoE generate ran K8 {k8} and the reference {ref.n} times on {device}, want "
            f"{n_layers} layers x {n_pad} decode steps of one of them")
    same = int((out == plain_out).all(dim=1).sum())
    check = None
    if device == "cuda":
        a = longest[0]
        tol = DECODE_TOL["float32"]
        mx, rel, ok = _err(torch, da.decode_attention_cuda(*a),
                           da.decode_attention_reference(*a), da.decode_error_scale(*a), tol)
        bb, h, C, hd = a[3].shape
        check = {"b": bb, "h": h, "C": C, "head_dim": hd, "max_abs_err": mx,
                 "max_err_over_scale": rel, "tolerance": tol}
        require(ok, f"K8 on MoE generate's inputs (C={C}): {mx} ({rel} of the scale)")
    emit({"phase": "moe_generate", "ok": True, "widths": widths, **moe_kw,
          "dtype": "float32", "batch": b, "prompt": p, "new_tokens": new,
          "padded_steps": n_pad, "wall_s": wall, "tokens_per_s": b * new / wall,
          "k8_launches": k8, "reference_calls": ref.n, "rows_equal_plain_path": same,
          "k8_at_longest_cache": check, "card": _card(torch, device)})
    require(same == b, f"MoE generate on the blocked path matches the plain decode path in "
            f"{same} of {b} rows")
    del moe
    if device == "cuda":
        torch.cuda.empty_cache()
    errors = {k: max(e[0] for e in errs[k].values()) for k in errs}
    if check is not None:
        errors["decode_attention"] = check["max_abs_err"]
    return {"flash_fwd": launches["flash_fwd"], "flash_bwd_fused": launches["flash_bwd_fused"],
            "decode_attention": k8}, errors


def phase_model_families(torch, device="cuda", tiny=False):
    """Phase 25: the ResNets and the Switch-MoE LM; returns ``(launches,
    errors)`` to join the ``kernels`` line."""
    t0 = time.monotonic()
    k1, k1_err = phase_resnet(torch, device, tiny)
    launches, errors = phase_moe(torch, device, tiny)
    launches["flat_axpy"] = k1
    errors["flat_axpy"] = k1_err
    emit({"phase": "model_families", "ok": True, "launches": launches,
          "wall_s": time.monotonic() - t0, "card": _card(torch, device)})
    return launches, errors


# ------------------------------------------------------------------ phase 26

MESH_RANKS = 2
MESH_DP_STEPS, MESH_DP_BATCH, MESH_LR = 5, 64, 0.05
#: two ranks of b32 against one of b64 (float32 AlexNet, five SGD steps):
#: gloo adds the two halves' gradients and cuDNN picks its algorithms per
#: batch, so the sums differ in order (about 1e-6 relative a step)
MESH_DP_TOL = dict(rtol=1e-4, atol=1e-5)
MESH_LOCAL_K = 10
MESH_LM_BATCH, MESH_LM_SEQ, MESH_LM_STEPS = 8, 2048, 3
#: the first step's loss over two ranks against one rank's, bfloat16: the
#: one-rank loss is a bfloat16 number near ln(50304) = 10.8, whose spacing
#: there is 2^-4 (0.6 %); the tp loss is summed in float32
MESH_LM_LOSS_RTOL = 1e-2
MESH_GEN = (4, 64, 33)  # batch, prompt, new tokens: the blocked path, two blocks
#: phase 26's LM and generate_tp run GPT-2-small widths at 4 of its 12 layers:
#: their depth is cut to keep the whole run's margin under its time limit
MESH_LM_LAYERS = 4


def _mesh_widths(tiny):
    from distributed_ml_pytorch_tpu_torch import bench_all

    return (bench_all.TINY_LM if tiny
            else dict(bench_all.GPT2_SMALL, n_layers=MESH_LM_LAYERS))
TINY_MESH = dict(dp_batch=8, lm_batch=4, lm_seq=128, gen=(2, 8, 20))


def _flat_params(torch, model):
    return torch.cat([p.detach().float().reshape(-1).cpu() for p in model.parameters()])


def _mesh_alexnet(device):
    """A seed-0 unfused AlexNet (the mesh modes build the unfused CNN)."""
    from distributed_ml_pytorch_tpu_torch.models import get_model

    return get_model("alexnet", seed=0, device=device)


def _mesh_dp_steps(torch, mesh, device, batch):
    """Sync-DP and FSDP steps of this rank's rows, MESH_DP_STEPS each;
    returns their losses, parameters (flat, host), step ms, the FSDP
    state's shard fraction and the peak memory."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.parallel import fsdp, sync
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, create_train_state

    images, labels = bench_all.make_batch(batch)
    bx, by = sync.shard_batch(mesh, images, labels)
    out = {}
    for name in ("sync", "fsdp"):
        _peak_gb(torch, device, reset=True)
        model = _mesh_alexnet(device)
        tx = SGD(MESH_LR)
        if name == "sync":
            state = sync.replicate(mesh, create_train_state(model, tx))
            step = sync.make_sync_train_step(model, tx, mesh)
        else:
            state = fsdp.create_fsdp_train_state(model, tx, mesh)
            step = fsdp.make_fsdp_train_step(model, tx, mesh)
        losses, times = [], []
        for _ in range(MESH_DP_STEPS):
            _sync(torch, device)
            t0 = time.perf_counter()
            losses.append(float(step(state, bx, by)[1]))
            times.append(time.perf_counter() - t0)
        rec = {"losses": losses, "step_ms": 1e3 * sum(times[1:]) / (len(times) - 1),
               "peak_mem_gb": _peak_gb(torch, device)}
        if name == "fsdp":
            rec["param_shard_fraction"] = fsdp.param_shard_fraction(state)
            state.sharding.gather()
        out[name] = (rec, _flat_params(torch, model))
    out["sync"][0]["all_reduce_ms"] = _collective_ms(
        torch, device, lambda t: mesh.all_reduce(t, "data"), ALEXNET_PADDED)
    return out


def _collective_ms(torch, device, op, n, reps=5):
    """Host ms of ``op`` on a float32 tensor of ``n`` elements on
    ``device`` (one warm-up, then the mean of ``reps``, each synchronized)."""
    t = torch.ones(n, device=device)
    op(t)
    times = []
    for _ in range(reps):
        _sync(torch, device)
        t0 = time.perf_counter()
        op(t)
        _sync(torch, device)
        times.append(time.perf_counter() - t0)
    return 1e3 * sum(times) / reps


def _mesh_one_rank(torch, device, backend, batch):
    """Phase 26 (a): a one-rank world of ``backend``: sync DP and FSDP
    against ``make_train_step``, bit for bit."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        SGD,
        create_train_state,
        make_train_step,
    )

    images, labels = bench_all.make_batch(batch)
    single = _mesh_alexnet(device)
    tx = SGD(MESH_LR)
    state = create_train_state(single, tx)
    step = make_train_step(single, tx)
    x, y = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
    losses = [float(step(state, x, y)[1]) for _ in range(MESH_DP_STEPS)]
    ref = _flat_params(torch, single)
    del single, state, step
    got = run_threaded(1, lambda w: _mesh_dp_steps(torch, make_mesh(world=w), device, batch),
                       backend=backend, device=device, timeout_s=600.0)[0]
    for name, (rec, flat) in got.items():
        require(rec["losses"] == losses and torch.equal(flat, ref),
                f"one-rank {backend} {name} steps differ from make_train_step's: losses "
                f"{rec['losses']} vs {losses}, max param diff "
                f"{float((flat - ref).abs().max())}")
    return {"losses": losses, "ref": ref, "runs": {k: v[0] for k, v in got.items()}}


#: phase 26 (e): a run of this many steps checkpointed halfway, against half
#: of it and a resume from that checkpoint for the rest
MESH_CKPT_STEPS = 4


def _mesh_sharded_resume(torch, device, tiny, tmp):
    """Phase 26 (e): ``train_lm``'s fsdp and tp modes on a one-rank world in
    this process (NCCL on the card), resumed from a sharded checkpoint
    against the uninterrupted run; the checkpoint's bytes and a save's and a
    restore's seconds timed on the resumed state. The attention's split
    backward is injected, as phase 19 does: K5's dQ sums by atomics, in an
    order that differs run to run, and the pair repeats bit for bit."""
    import functools

    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import fsdp_layout
    from distributed_ml_pytorch_tpu_torch.parallel.tensor_parallel import tp_layout
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import run_threaded
    from distributed_ml_pytorch_tpu_torch.training import train_lm
    from distributed_ml_pytorch_tpu_torch.utils.checkpoint import STATE_FILE, ShardedCheckpointer

    widths = _mesh_widths(tiny)
    batch, seq = ((TINY_MESH["lm_batch"], TINY_MESH["lm_seq"]) if tiny
                  else (MESH_LM_BATCH, MESH_LM_SEQ))
    backend = "nccl" if device == "cuda" else "gloo"
    split = functools.partial(at.flash_attention, causal=True, bwd_impl="split")
    half = MESH_CKPT_STEPS // 2
    flags = ["--world-size", "1", "--device", device, "--vocab", str(widths["vocab_size"]),
             "--d-model", str(widths["d_model"]), "--n-heads", str(widths["n_heads"]),
             "--n-layers", str(widths["n_layers"]), "--d-ff", str(widths["d_ff"]),
             "--seq", str(seq), "--batch", str(batch), "--dtype", "bfloat16",
             "--lr", str(LM_LR), "--ckpt-every", str(half)]
    out = {}
    for mode in ("fsdp", "tp"):
        whole, cut, timed = (os.path.join(tmp, f"ckpt_{mode}_{k}") for k in ("whole", "cut",
                                                                               "timed"))
        base = ["--mode", mode, *flags]

        def train(argv, time_it=False):
            def rank(world):
                args = train_lm.parse_args(argv)
                res = train_lm.run(args, attn_fn=split)
                if not time_it:
                    return res, None
                state = res.state
                mesh, layout = ((state.sharding.mesh, fsdp_layout) if mode == "fsdp"
                                else (state.model.tp_mesh, tp_layout))
                ck = ShardedCheckpointer(timed, mode=mode, mesh=mesh, layout_fn=layout,
                                         background=False)
                _sync(torch, device)
                t0 = time.perf_counter()
                ck.save(MESH_CKPT_STEPS, state, force=True)
                save_s = time.perf_counter() - t0
                full = train_lm.build_model(args, device)  # the model a resume loads into
                _sync(torch, device)
                t0 = time.perf_counter()
                payload, _ = ck.load()
                ck.restore_params(payload, full)
                ck.restore_placed(state, payload)
                _sync(torch, device)
                return res, {"save_s": save_s, "restore_s": time.perf_counter() - t0}
            return run_threaded(1, rank, backend=backend, device=device, timeout_s=600.0)[0]

        t0 = time.monotonic()
        full, _ = train([*base, "--steps", str(MESH_CKPT_STEPS), "--ckpt-dir", whole])
        first, _ = train([*base, "--steps", str(half), "--ckpt-dir", cut])
        resumed, times = train([*base, "--steps", str(half), "--ckpt-dir", cut, "--resume"],
                               time_it=True)
        wall = time.monotonic() - t0
        trees = [torch.load(os.path.join(d, str(MESH_CKPT_STEPS), STATE_FILE),
                            weights_only=True) for d in (whole, cut)]
        same = (sorted(trees[0]["params"]) == sorted(trees[1]["params"])
                and all(torch.equal(trees[0]["params"][k], trees[1]["params"][k])
                        for k in trees[0]["params"])
                and torch.equal(trees[0]["opt_state"]["count"], trees[1]["opt_state"]["count"]))
        require(resumed.start_step == half and first.losses == full.losses[:half]
                and resumed.losses == full.losses[half:] and same,
                f"{mode}: the resumed run ({resumed.losses}, from step {resumed.start_step}) "
                f"differs from the uninterrupted one ({full.losses}); trees equal: {same}")
        ck_bytes = os.path.getsize(os.path.join(whole, str(half), STATE_FILE))
        out[mode] = {"losses": full.losses, "resumed_losses": resumed.losses,
                     "bit_equal": True, "checkpoint_bytes": ck_bytes,
                     "leaves": len(trees[0]["params"]), **times, "wall_s": wall}
        del full, first, resumed, trees
        if device == "cuda":
            torch.cuda.empty_cache()
    return {"backend": backend, "world": "1 rank", "widths": widths, "batch": batch,
            "seq": seq, "dtype": "bfloat16", "steps": MESH_CKPT_STEPS, "checkpoint_at": half,
            "modes": out}


def _mesh_lm_model(torch, widths, seq, dtype, seed, device):
    from distributed_ml_pytorch_tpu_torch.models import TransformerLM

    return TransformerLM(**widths, max_len=seq, dtype=dtype, seed=seed, device=device)


def _mesh_lm_batch(widths, batch, seq):
    np = __import__("numpy")
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import next_token_targets

    tok = np.random.default_rng(0).integers(0, widths["vocab_size"], (batch, seq))
    return tok, next_token_targets(tok)


def _mesh_lm_rank(torch, world, device, tiny):
    """Phase 26 (c) on one rank: fsdp, then tp, MESH_LM_STEPS steps each."""
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.parallel import fsdp
    from distributed_ml_pytorch_tpu_torch.parallel import tensor_parallel as tpm
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    widths = _mesh_widths(tiny)
    batch, seq = ((TINY_MESH["lm_batch"], TINY_MESH["lm_seq"]) if tiny
                  else (MESH_LM_BATCH, MESH_LM_SEQ))
    tokens, targets = _mesh_lm_batch(widths, batch, seq)
    out = {}
    for mode, shape in (("fsdp", {"data": MESH_RANKS}),
                        ("tp", {"data": 1, "model": MESH_RANKS})):
        mesh = make_mesh(shape, world)
        _peak_gb(torch, device, reset=True)
        lm = _mesh_lm_model(torch, widths, seq, torch.bfloat16, 0, device)
        tx = SGD(LM_LR)
        if mode == "fsdp":
            state = fsdp.create_fsdp_train_state(lm, tx, mesh)
            step = fsdp.make_fsdp_lm_train_step(lm, tx, mesh)
            tok, tgt = fsdp.shard_fsdp_batch(mesh, tokens, targets)
        else:
            state = tpm.create_tp_train_state(lm, tx, mesh)
            step = tpm.make_tp_train_step(lm, tx, mesh)
            tok, tgt = tpm.shard_tp_batch(mesh, tokens, targets)
        check = device == "cuda" and mesh.rank == (0 if mode == "tp" else 1)
        seen, restore = _record_first_call(torch, at, "flash_bwd_fused_cuda")
        _zero_attention_launches(at)
        losses, times = [], []
        try:
            with _plain_attention_calls(at) as plain:
                for _ in range(MESH_LM_STEPS):
                    _sync(torch, device)
                    t0 = time.perf_counter()
                    losses.append(float(step(state, tok, tgt)[1]))
                    times.append(time.perf_counter() - t0)
        finally:
            restore()
        launches = dict(at.launches)
        rec = {"losses": losses, "step_ms": 1e3 * sum(times[1:]) / (len(times) - 1),
               "rank_batch": list(tok.shape), "layers": widths["n_layers"],
               "launches": launches,
               "plain_attention_calls": plain.n, "peak_mem_gb": _peak_gb(torch, device),
               "host_staged": mesh.host_staged}
        if mode == "fsdp":
            rec["param_shard_fraction"] = fsdp.param_shard_fraction(state)
            sh = state.sharding
            rec["gather_ms"] = _collective_ms(torch, device, lambda t: (sh.gather(), sh.free()),
                                              1, reps=2)
        else:
            rec["heads"] = lm.blocks()[0].attn.n_heads
            rec["vocab_rows"] = lm.lm_head.weight.shape[0]
            # one of the 48 float32 sums a step: a block's (batch, seq, d) output
            rec["all_reduce_ms"] = _collective_ms(
                torch, device, lambda t: mesh.all_reduce(t, "model"),
                batch * seq * widths["d_model"])
        args = seen.pop("args", None)
        if args is not None:
            rec["q_shape"] = list(args[0].shape)
        if check:
            errs, ms, check_s = _long_check(torch, at, args, ("flash_fwd", "flash_bwd_fused"))
            rec["kernels"] = {k: {"ms": ms[k], "errors": errs[k]} for k in ms}
            rec["plain_check_s"] = check_s
        out[mode] = rec
        del lm, state, step, args
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _mesh_gen_shape(tiny):
    return _mesh_widths(tiny), (TINY_MESH["gen"] if tiny else MESH_GEN)


def _mesh_gen_model(torch, tiny, device):
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    widths, (b, p, new) = _mesh_gen_shape(tiny)
    lm = _mesh_lm_model(torch, widths, p + new + gen.DECODE_BLOCK, torch.float32, 1, device)
    prompt = __import__("numpy").random.default_rng(3).integers(0, widths["vocab_size"], (b, p))
    return lm, prompt, new


def _mesh_gen_rank(torch, world, device, tiny):
    """Phase 26 (d) on one rank: greedy ``generate_tp`` over the ranks."""
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    from distributed_ml_pytorch_tpu_torch.ops import decode_attention as da
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh

    lm, prompt, new = _mesh_gen_model(torch, tiny, device)
    mesh = make_mesh({"data": 1, "model": MESH_RANKS}, world)
    da.launches = 0
    with _ReferenceCalls(da) as ref:
        _sync(torch, device)
        t0 = time.perf_counter()
        out = gen.generate_tp(lm, prompt, new, mesh)
        _sync(torch, device)
        wall = time.perf_counter() - t0
    blocked, padded = gen.uses_block_decode(lm, prompt.shape[1], new)
    return {"tokens": out.cpu().tolist(), "k8_launches": da.launches,
            "reference_calls": ref.n, "blocked": blocked, "padded_steps": padded - prompt.shape[1],
            "n_layers": lm.n_layers, "wall_s": wall, "host_staged": mesh.host_staged}


def mesh_child(rank: int, port: str, out_path: str, device: str = "cuda", tiny: bool = False,
               parts: str = "dp,lm,gen") -> None:
    """One of the MESH_RANKS processes of phase 26 (b)-(d): joins the gloo
    world on ``port`` and writes its part's results to ``out_path`` (JSON)
    and ``out_path + ".pt"`` (the CNN parameters)."""
    import torch

    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.parallel import p2p
    from distributed_ml_pytorch_tpu_torch.parallel.local_sgd import make_local_sgd_round
    from distributed_ml_pytorch_tpu_torch.parallel.sync import shard_batch
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import init_distributed, make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, create_train_state

    world = init_distributed("gloo", "localhost", port, MESH_RANKS, rank, device=device)
    if device == "cuda":
        full_float32()
        torch.backends.cudnn.deterministic = True
    out, tensors = {"rank": rank}, {}
    if "dp" in parts:
        from distributed_ml_pytorch_tpu_torch import bench_all

        mesh = make_mesh(world=world)
        batch = TINY_MESH["dp_batch"] if tiny else MESH_DP_BATCH
        got = _mesh_dp_steps(torch, mesh, device, batch)
        out["dp"] = {k: v[0] for k, v in got.items()}
        tensors = {k: v[1] for k, v in got.items()}
        model = _mesh_alexnet(device)
        tx = SGD(MESH_LR)
        state = create_train_state(model, tx)
        xs, ys = bench_all.make_batch(batch, seed=1, k=MESH_LOCAL_K)
        _, losses = make_local_sgd_round(model, tx, mesh)(state,
                                                         *shard_batch(mesh, xs, ys, dim=1))
        flat = _flat_params(torch, model)
        out["local_sgd"] = {"k": MESH_LOCAL_K, "losses": losses.tolist(), "step": state.step,
                            "param_sum": float(flat.double().sum()),
                            "param_sha256": hashlib.sha256(flat.numpy().tobytes()).hexdigest()}
        out["p2p_demo"] = p2p.run_demo(mesh=mesh).tolist()
        out["host_staged_dp"] = mesh.host_staged
    if "lm" in parts:
        out["lm"] = _mesh_lm_rank(torch, world, device, tiny)
    if "gen" in parts:
        out["gen"] = _mesh_gen_rank(torch, world, device, tiny)
    torch.save(tensors, out_path + ".pt")
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def _mesh_processes(device, tiny, parts, tmp):
    """Run MESH_RANKS ``mesh_child`` processes; returns their results."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port

    port = _free_port()
    paths = [os.path.join(tmp, f"mesh_rank{r}.json") for r in range(MESH_RANKS)]
    code = ("import sys, chip_smoke; chip_smoke.mesh_child(int(sys.argv[1]), sys.argv[2], "
            "sys.argv[3], sys.argv[4], sys.argv[5] == '1', sys.argv[6])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port, paths[r], device,
                               "1" if tiny else "0", parts], cwd=ROOT)
             for r in range(MESH_RANKS)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(c == 0 for c in codes), f"phase 26's rank processes exited with {codes}")
    out = []
    for path in paths:
        with open(path) as fh:
            out.append(json.load(fh))
    return out, paths


def phase_mesh(torch, device="cuda", tiny=False, parts="dp,lm,gen,ckpt"):
    """Phase 26: the one-rank NCCL world here, then the two-process gloo
    worlds; returns ``(launches, errors)`` to join the ``kernels`` line."""
    import shutil
    import tempfile

    np = __import__("numpy")
    gen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    t0 = time.monotonic()
    card = _card(torch, device)
    if device == "cuda":
        full_float32()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "decode_attention": 0}
    errors = {}
    tmp = tempfile.mkdtemp(prefix="mesh26_", dir=os.path.join(ROOT, "build")
                           if os.path.isdir(os.path.join(ROOT, "build")) else None)
    try:
        one = None
        if "dp" in parts:
            backend = "nccl" if device == "cuda" else "gloo"
            batch = TINY_MESH["dp_batch"] if tiny else MESH_DP_BATCH
            one = _mesh_one_rank(torch, device, backend, batch)
            emit({"phase": "mesh_one_rank", "ok": True, "backend": backend, "world": "1 rank",
                  "model": "alexnet", "batch": batch, "steps": MESH_DP_STEPS,
                  "losses": one["losses"], "bit_identical_to_make_train_step": True,
                  "runs": one["runs"], "card": card})
        ref_loss = ref_tokens = None
        if "lm" in parts:
            widths = _mesh_widths(tiny)
            batch, seq = ((TINY_MESH["lm_batch"], TINY_MESH["lm_seq"]) if tiny
                          else (MESH_LM_BATCH, MESH_LM_SEQ))
            lm = _mesh_lm_model(torch, widths, seq, torch.bfloat16, 0, device)
            tok, tgt = (torch.from_numpy(a.astype(np.int64)).to(device)
                        for a in _mesh_lm_batch(widths, batch, seq))
            step = make_fsdp_lm_train_step(lm, SGD(LM_LR))
            ref_loss = float(step(create_lm_train_state(lm, SGD(LM_LR)), tok, tgt)[1])
            del lm, step, tok, tgt
        if "gen" in parts:
            lm, prompt, new = _mesh_gen_model(torch, tiny, device)
            ref_tokens = gen.generate(lm, torch.from_numpy(prompt).to(device), new).cpu().tolist()
            del lm
        if device == "cuda":
            torch.cuda.empty_cache()
        ranks, paths = _mesh_processes(device, tiny, parts, tmp)
        if "dp" in parts:
            _mesh_dp_checks(torch, one, ranks, paths, card)
        if "lm" in parts:
            _mesh_lm_checks(ranks, ref_loss, device, card, launches, errors)
        if "gen" in parts:
            _mesh_gen_checks(ranks, ref_tokens, device, card, launches, tiny)
        if "ckpt" in parts:
            emit({"phase": "mesh_sharded_resume", "ok": True,
                  **_mesh_sharded_resume(torch, device, tiny, tmp), "card": card})
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "mesh", "ok": True, "launches": launches, "wall_s": time.monotonic() - t0,
          "card": card})
    return launches, errors


def _mesh_dp_checks(torch, one, ranks, paths, card):
    np = __import__("numpy")
    flats = [torch.load(p + ".pt") for p in paths]
    for name in ("sync", "fsdp"):
        for r, (rank, flat) in enumerate(zip(ranks, flats)):
            losses = rank["dp"][name]["losses"]
            require(np.allclose(losses, one["losses"], **MESH_DP_TOL),
                    f"rank {r} {name} 2 x b32 losses {losses} vs one rank's b64 "
                    f"{one['losses']} beyond {MESH_DP_TOL}")
            require(np.allclose(flat[name].numpy(), one["ref"].numpy(), **MESH_DP_TOL),
                    f"rank {r} {name} parameters beyond {MESH_DP_TOL} of one rank's: max diff "
                    f"{float((flat[name] - one['ref']).abs().max())}")
        require(torch.equal(flats[0][name], flats[1][name]),
                f"{name}: the ranks' parameters differ")
    require(np.allclose(flats[0]["fsdp"].numpy(), flats[0]["sync"].numpy(), **MESH_DP_TOL),
            "FSDP parameters beyond MESH_DP_TOL of sync DP's")
    fsdp_eq_sync = bool(torch.equal(flats[0]["fsdp"], flats[0]["sync"]))
    loc = [rank["local_sgd"] for rank in ranks]
    require(loc[0]["param_sha256"] == loc[1]["param_sha256"]
            and all(r["step"] == MESH_LOCAL_K for r in loc)
            and all(math.isfinite(v) for v in loc[0]["losses"]),
            f"local-SGD round: {loc}")
    demo = [rank["p2p_demo"] for rank in ranks]
    require(all(d == [1.0, 1.0] for d in demo), f"p2p demo values {demo}")
    emit({"phase": "mesh_two_ranks_dp", "ok": True, "world": f"{MESH_RANKS} processes "
          "sharing the card over gloo", "model": "alexnet",
          "steps": MESH_DP_STEPS, "tolerance": MESH_DP_TOL, "fsdp_bit_equal_sync": fsdp_eq_sync,
          "per_rank": [{"rank": r["rank"], **{k: r["dp"][k] for k in ("sync", "fsdp")},
                        "host_staged": r["host_staged_dp"]} for r in ranks],
          "local_sgd": {"k": MESH_LOCAL_K, "losses": loc[0]["losses"]}, "p2p_demo": demo[0],
          "card": card})


def _mesh_lm_checks(ranks, ref_loss, device, card, launches, errors):
    for mode in ("fsdp", "tp"):
        recs = [rank["lm"][mode] for rank in ranks]
        for r, rec in enumerate(recs):
            ls, n = rec["losses"], rec["launches"]
            require(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
                    f"{mode} rank {r}: losses not finite and falling: {ls}")
            require(abs(ls[0] - ref_loss) <= MESH_LM_LOSS_RTOL * abs(ref_loss),
                    f"{mode} rank {r}: first loss {ls[0]} vs one rank's {ref_loss} beyond "
                    f"rtol {MESH_LM_LOSS_RTOL}")
            layers = rec["layers"]
            fused = n["flash_bwd_fused"] == layers * MESH_LM_STEPS and n["flash_bwd_dq"] == 0
            split = n["flash_bwd_fused"] == 0 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] \
                == layers * MESH_LM_STEPS
            if device == "cuda":
                require(n["flash_fwd"] == layers * MESH_LM_STEPS and (fused or split),
                        f"{mode} rank {r} launched {n} for {MESH_LM_STEPS} steps of "
                        f"{layers} layers")
                require(rec["plain_attention_calls"] == 0,
                        f"{mode} rank {r} reached the plain attention "
                        f"{rec['plain_attention_calls']} times")
            for name in launches:
                if name in n:
                    launches[name] += n[name]
            for kern, k in rec.get("kernels", {}).items():
                errors[kern] = max(errors.get(kern, 0.0),
                                   max(e[0] for e in k["errors"].values()))
        emit({"phase": f"mesh_lm_{mode}", "ok": True, "world": f"{MESH_RANKS} processes "
              "sharing the card over gloo", "dtype": "bfloat16", "lr": LM_LR,
              "one_rank_first_loss": ref_loss, "loss_rtol": MESH_LM_LOSS_RTOL,
              "per_rank": recs, "card": card})


def _mesh_gen_checks(ranks, ref_tokens, device, card, launches, tiny):
    recs = [rank["gen"] for rank in ranks]
    for r, rec in enumerate(recs):
        want = rec["n_layers"] * rec["padded_steps"]
        k8, refs = ((rec["k8_launches"], rec["reference_calls"]) if device == "cuda"
                    else (rec["reference_calls"], rec["k8_launches"]))
        require(rec["blocked"] and k8 == want and refs == 0,
                f"generate_tp rank {r}: K8 {rec['k8_launches']}, reference "
                f"{rec['reference_calls']}, want {want} of one on {device}")
        require(rec["tokens"] == ref_tokens,
                f"generate_tp rank {r}'s tokens differ from generate() on one rank")
        launches["decode_attention"] += rec["k8_launches"]
    emit({"phase": "mesh_generate_tp", "ok": True, "world": f"{MESH_RANKS} processes "
          "sharing the card over gloo", "dtype": "float32",
          "shape": list(_mesh_gen_shape(tiny)[1]),
          "per_rank": [{k: v for k, v in rec.items() if k != "tokens"} for rec in recs],
          "tokens_equal_generate": True, "card": card})


PAR_RANKS, PAR_WIDE = 2, 4  # the (a)-(c) world and the (c')-(e) world
#: GPT-2-small's depth cut to make room for phase 28 (the gloo traffic of
#: (a), (b), (d) and (e) grows with the layers)
PAR_LAYERS = 4
PAR_LM_BATCH, PAR_LM_SEQ, PAR_STEPS = 8, 2048, 2
PAR_PP_BATCH, PAR_PP_SEQ, PAR_PP_M, PAR_PP_LR = 8, 512, 4, 0.1
#: a bfloat16 first loss over the ranks against one rank's (as
#: MESH_LM_LOSS_RTOL): the one-rank loss is a bfloat16 number near ln(50304),
#: spaced 2^-4 there (0.6 %)
PAR_LOSS_RTOL = 1e-2
#: the float32 pipeline against its one-stage step on the same microbatches:
#: the same kernels on the same rows, the stages only split the layers; and
#: 1F1B against GPipe (the same units in another order)
PAR_PP_RTOL = 1e-5
#: the parameter whose first-step gradient (all-reduced, as the optimizer
#: takes it) the bfloat16 parts hold against the one-rank step's: the first
#: loss of a fresh model sits near ln(V) whatever its layers compute, while
#: this gradient moves with every layer above it (a non-causal ring moved it
#: by 0.83 in a CPU trial at narrow widths; the bfloat16 rounding by 0.013)
PAR_GRAD_PARAM = "block_0.LayerNorm_0.weight"
#: ``‖g - g_ref‖ / ‖g_ref‖`` of that gradient, in float32
PAR_GRAD_RTOL = 0.1
TINY_PAR = dict(lm_batch=4, lm_seq=192, pp_batch=4, pp_seq=32, pp_m=2)


def _par_shapes(tiny):
    from distributed_ml_pytorch_tpu_torch import bench_all

    widths = bench_all.TINY_LM if tiny else dict(bench_all.GPT2_SMALL, n_layers=PAR_LAYERS)
    if tiny:
        return (widths, TINY_PAR["lm_batch"], TINY_PAR["lm_seq"], TINY_PAR["pp_batch"],
                TINY_PAR["pp_seq"], TINY_PAR["pp_m"])
    return widths, PAR_LM_BATCH, PAR_LM_SEQ, PAR_PP_BATCH, PAR_PP_SEQ, PAR_PP_M


def _pp_cfg(widths, seq):
    from distributed_ml_pytorch_tpu_torch.parallel.pipeline import PipelineLMConfig

    return PipelineLMConfig(vocab_size=widths["vocab_size"], d_model=widths["d_model"],
                            n_heads=widths["n_heads"], n_layers=widths["n_layers"],
                            d_ff=widths["d_ff"], max_len=seq)


def _moe_model(torch, widths, seq, device):
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM

    return MoETransformerLM(**widths, n_experts=bench_all.MOE_EXPERTS,
                            capacity_factor=bench_all.MOE_CAPACITY, max_len=seq,
                            dtype=torch.bfloat16, seed=0, device=device)


def _first_grad(tx, model, offset=0):
    """``tx`` made to keep the float32 gradient of :data:`PAR_GRAD_PARAM`
    from its first update (the ``grads`` it takes follow
    ``model.named_parameters()``); returns the dict that receives it, as
    ``grad`` (this rank's rows of it) beside ``grad_offset``, the first row's
    index in the whole parameter."""
    j = [n for n, _ in model.named_parameters()].index(PAR_GRAD_PARAM)
    seen, update = {"grad_offset": offset}, tx.update

    def recording(grads, state, params=None):
        if "grad" not in seen:
            seen["grad"] = grads[j].detach().float().reshape(-1).cpu().tolist()
        return update(grads, state, params)

    tx.update = recording
    return seen


def _par_steps(torch, at, mesh, device, step, check, grad=None):
    """``step()`` PAR_STEPS times with the attention launches zeroed just
    before and read just after, the plain versions counted, the first
    backward kernel call's tensors kept; on ``check`` (and the card) K4 and
    K5 held to their plain versions on them. Returns the rank's record,
    with ``grad`` (:func:`_first_grad`'s dict) merged in."""
    seen, restore = _record_first_call(torch, at, "flash_bwd_fused_cuda")
    _zero_attention_launches(at)
    losses, times = [], []
    try:
        with _plain_attention_calls(at) as plain:
            for _ in range(PAR_STEPS):
                _sync(torch, device)
                t0 = time.perf_counter()
                losses.append(float(step()))
                _sync(torch, device)
                times.append(time.perf_counter() - t0)
    finally:
        restore()
    rec = {"losses": losses, "step_ms": 1e3 * times[-1], "first_step_ms": 1e3 * times[0],
           "launches": dict(at.launches), "plain_attention_calls": plain.n,
           "peak_mem_gb": _peak_gb(torch, device), "host_staged": mesh.host_staged,
           **(grad or {})}
    args = seen.pop("args", None)
    if args is not None:
        rec["q_shape"] = list(args[0].shape)
        rec["dtype"] = str(args[0].dtype).replace("torch.", "")
    if check and device == "cuda":
        require(args is not None, "no fused backward call to hold against its plain version")
        errs, ms, check_s = _long_check(torch, at, args, ("flash_fwd", "flash_bwd_fused"))
        rec["kernels"] = {k: {"ms": ms[k], "errors": errs[k]} for k in ms}
        rec["plain_check_s"] = check_s
    return rec


def _par_sp_part(torch, at, world, device, tiny, mode):
    """Phase 27 (a)/(b) on one rank: the ring (``sp``) or Ulysses step over
    ``{"data": 1, "seq": 2}`` from the seed-0 weights."""
    from distributed_ml_pytorch_tpu_torch.parallel import seq_parallel as sp
    from distributed_ml_pytorch_tpu_torch.parallel.ulysses import make_ulysses_train_step
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    widths, batch, seq = _par_shapes(tiny)[:3]
    mesh = make_mesh({"data": 1, "seq": PAR_RANKS}, world)
    _peak_gb(torch, device, reset=True)
    lm = _mesh_lm_model(torch, widths, seq, torch.bfloat16, 0, device)
    tx = SGD(LM_LR)
    grad = _first_grad(tx, lm)
    state = sp.create_lm_train_state(lm, tx)
    make = sp.make_sp_train_step if mode == "sp" else make_ulysses_train_step
    step = make(lm, tx, mesh)
    tok, tgt = sp.shard_lm_batch(mesh, *_mesh_lm_batch(widths, batch, seq))
    rec = _par_steps(torch, at, mesh, device, lambda: step(state, tok, tgt)[1],
                     check=mesh.rank == PAR_RANKS - 1, grad=grad)
    rec.update(rank_tokens=list(tok.shape), layers=widths["n_layers"])
    del lm, state, step
    return rec


def _par_pp_part(torch, at, world, device, tiny, schedule, shape):
    """Phase 27 (c) on one rank: the float32 pipeline over ``shape``."""
    from distributed_ml_pytorch_tpu_torch.parallel import pipeline as pp
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    widths, _b, _s, batch, seq, m = _par_shapes(tiny)
    cfg = _pp_cfg(widths, seq)
    mesh = make_mesh(shape, world)
    _peak_gb(torch, device, reset=True)
    tx = SGD(PAR_PP_LR)
    model_axis = "model" if "model" in shape else None
    data_axis = "data" if "data" in shape else None
    state = pp.create_pp_train_state(cfg, tx, mesh, model_axis=model_axis, seed=0)
    step = pp.make_pp_train_step(cfg, tx, mesh, m, schedule=schedule, data_axis=data_axis,
                                 model_axis=model_axis)
    tok, tgt = pp.microbatch(*_mesh_lm_batch(widths, batch, seq), m)
    rec = _par_steps(torch, at, mesh, device, lambda: step(state, tok, tgt)[1],
                     check=mesh.rank == 0)
    rec.update(stage=state.stage, layers_here=len(state.model.blocks), microbatches=m,
               peak_stash=state.peak_stash, schedule=schedule)
    del state, step
    return rec


def _par_moe_part(torch, at, world, device, tiny):
    """Phase 27 (d) on one rank: dp × ep on ``{"data": 2, "expert": 2}``."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.parallel import expert_parallel as ep
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    widths = _par_shapes(tiny)[0]
    batch, seq = ((bench_all.TINY_MOE_BATCH * 2, bench_all.TINY_MOE_SEQ) if tiny
                  else (bench_all.MOE_BATCH, bench_all.MOE_SEQ))
    mesh = make_mesh({"data": 2, "expert": 2}, world)
    _peak_gb(torch, device, reset=True)
    moe = _moe_model(torch, widths, seq, device)
    tx = SGD(MOE_LR)
    state = ep.create_ep_train_state(moe, tx, mesh)
    grad = _first_grad(tx, moe)
    step = ep.make_ep_train_step(moe, tx, mesh)
    tok, tgt = ep.shard_ep_batch(mesh, *_mesh_lm_batch(widths, batch, seq))
    aux = []

    def one():
        _, (loss, a) = step(state, tok, tgt)
        aux.append(float(a))
        return loss

    rec = _par_steps(torch, at, mesh, device, one, check=mesh.rank == 0, grad=grad)
    rec.update(aux=aux, rank_tokens=list(tok.shape), layers=widths["n_layers"],
               experts_here=moe.blocks()[0].moe.n_local)
    del moe, state, step
    return rec


def _par_composite_part(torch, at, world, device, tiny):
    """Phase 27 (e) on one rank: dp × fsdp × tp on ``{"data": 1, "fsdp": 2,
    "model": 2}``."""
    from distributed_ml_pytorch_tpu_torch.parallel import composite as cp
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    widths, batch, seq = _par_shapes(tiny)[:3]
    mesh = make_mesh({"data": 1, "fsdp": 2, "model": 2}, world)
    _peak_gb(torch, device, reset=True)
    lm = _mesh_lm_model(torch, widths, seq, torch.bfloat16, 0, device)
    tx = SGD(LM_LR)
    state, specs = cp.create_composite_train_state(lm, tx, mesh)
    # the parameter's rows on this rank: FSDP splits its one dim over fsdp
    require(specs[PAR_GRAD_PARAM] == ("fsdp",), f"{PAR_GRAD_PARAM} laid out as "
            f"{specs[PAR_GRAD_PARAM]}, not split over fsdp alone")
    grad = _first_grad(tx, lm, mesh.axis_index("fsdp") * widths["d_model"]
                       // mesh.axis_size("fsdp"))
    step = cp.make_composite_train_step(lm, tx, mesh, specs)
    tok, tgt = cp.shard_composite_batch(mesh, *_mesh_lm_batch(widths, batch, seq))
    rec = _par_steps(torch, at, mesh, device, lambda: step(state, tok, tgt)[1],
                     check=mesh.rank == 0, grad=grad)
    rec.update(rank_tokens=list(tok.shape), layers=widths["n_layers"],
               heads_here=lm.blocks()[0].attn.n_heads)
    del lm, state, step
    return rec


def par_child(rank: int, n: int, port: str, out_path: str, device: str = "cuda",
              tiny: bool = False) -> None:
    """One rank of phase 27's worlds of ``n`` processes sharing the card
    over gloo: 2 ranks run (a) sp, (b) ulysses and (c) GPipe and 1F1B on 2
    stages; 4 ranks run (c) dp × pp on 2 × 2, (d) dp × ep and (e) fsdp × tp.
    Writes the records to ``out_path`` (JSON)."""
    import torch

    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import init_distributed

    world = init_distributed("gloo", "localhost", port, n, rank, device=device)
    if device == "cuda":
        full_float32()
    else:
        torch.set_num_threads(1)
    out = {"rank": rank}
    if n == PAR_RANKS:
        out["sp"] = _par_sp_part(torch, at, world, device, tiny, "sp")
        out["ulysses"] = _par_sp_part(torch, at, world, device, tiny, "ulysses")
        for sched in ("gpipe", "1f1b"):
            out[f"pp_{sched}"] = _par_pp_part(torch, at, world, device, tiny, sched,
                                              {"stage": 2})
    else:
        out["pp_dp"] = _par_pp_part(torch, at, world, device, tiny, "gpipe",
                                    {"data": 2, "stage": 2})
        out["moe"] = _par_moe_part(torch, at, world, device, tiny)
        out["composite"] = _par_composite_part(torch, at, world, device, tiny)
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def _par_processes(n, device, tiny, tmp):
    """Run ``n`` ``par_child`` processes; returns their records."""
    from distributed_ml_pytorch_tpu_torch.launch import _free_port

    port = _free_port()
    paths = [os.path.join(tmp, f"par{n}_rank{r}.json") for r in range(n)]
    code = ("import sys, chip_smoke; chip_smoke.par_child(int(sys.argv[1]), int(sys.argv[2]), "
            "sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6] == '1')")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), port, paths[r],
                               device, "1" if tiny else "0"], cwd=ROOT)
             for r in range(n)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(c == 0 for c in codes), f"phase 27's {n} rank processes exited with {codes}")
    out = []
    for path in paths:
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def _par_references(torch, device, tiny):
    """The one-rank steps phase 27 holds its worlds to: the LM's first loss
    and first :data:`PAR_GRAD_PARAM` gradient (bf16, the global batch), the
    one-stage pipeline's losses (float32, a one-rank world of the card's
    backend) and the MoE's first ``(loss, aux)`` and gradient on a one-rank
    ``{"data": 1, "expert": 1}`` world."""
    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.parallel import expert_parallel as ep
    from distributed_ml_pytorch_tpu_torch.parallel import pipeline as pp
    from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
    from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
    from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    np = __import__("numpy")
    widths, batch, seq, pp_batch, pp_seq, m = _par_shapes(tiny)
    lm = _mesh_lm_model(torch, widths, seq, torch.bfloat16, 0, device)
    tok, tgt = (torch.from_numpy(a.astype(np.int64)).to(device)
                for a in _mesh_lm_batch(widths, batch, seq))
    tx = SGD(LM_LR)
    grad = _first_grad(tx, lm)
    step = make_fsdp_lm_train_step(lm, tx)
    ref = {"lm": float(step(create_lm_train_state(lm, tx), tok, tgt)[1]),
           "lm_grad": grad["grad"]}
    del lm, step, tok, tgt
    backend = "nccl" if device == "cuda" else "gloo"

    def pp_one(world):
        mesh = make_mesh({"stage": 1}, world)
        cfg = _pp_cfg(widths, pp_seq)
        state = pp.create_pp_train_state(cfg, SGD(PAR_PP_LR), mesh, seed=0)
        s = pp.make_pp_train_step(cfg, SGD(PAR_PP_LR), mesh, m)
        t, g = pp.microbatch(*_mesh_lm_batch(widths, pp_batch, pp_seq), m)
        return [float(s(state, t, g)[1]) for _ in range(PAR_STEPS)]

    ref["pp"] = run_threaded(1, pp_one, backend=backend, device=device, timeout_s=600.0)[0]
    mb, ms = ((bench_all.TINY_MOE_BATCH * 2, bench_all.TINY_MOE_SEQ) if tiny
              else (bench_all.MOE_BATCH, bench_all.MOE_SEQ))

    def moe_one(world):
        mesh = make_mesh({"data": 1, "expert": 1}, world)
        moe = _moe_model(torch, widths, ms, device)
        tx = SGD(MOE_LR)
        state = ep.create_ep_train_state(moe, tx, mesh)
        grad = _first_grad(tx, moe)
        s = ep.make_ep_train_step(moe, tx, mesh)
        t, g = ep.shard_ep_batch(mesh, *_mesh_lm_batch(widths, mb, ms))
        loss, aux = s(state, t, g)[1]
        return float(loss), float(aux), grad["grad"]

    *ref["moe"], ref["moe_grad"] = run_threaded(1, moe_one, backend=backend, device=device,
                                                timeout_s=600.0)[0]
    if device == "cuda":
        torch.cuda.empty_cache()
    return ref


def _expected_attention(part, rec, steps):
    """The K4 launches a rank's part must show: the causal ring's rank
    ``i`` attends to the chunks of ranks ``0..i``, its own and the past
    ones, ``i + 1`` a layer (rank 0 launches nothing for the future chunk
    of rank 1); Ulysses, the MoE and the composite step one a layer; a
    pipeline stage one a layer it holds and microbatch."""
    if part == "sp":
        return rec["layers"] * (rec["rank"] % PAR_RANKS + 1) * steps
    if part.startswith("pp"):
        return rec["layers_here"] * rec["microbatches"] * steps
    return rec["layers"] * steps


def _grad_rel_err(got, offset, want):
    """``‖g - g_ref‖ / ‖g_ref‖`` over the rows of the reference gradient
    ``want`` that this rank holds, from ``offset`` on."""
    ref = want[offset:offset + len(got)]
    num = math.sqrt(sum((a - b) ** 2 for a, b in zip(got, ref)))
    return num / math.sqrt(sum(b * b for b in ref))


def _par_checks(part, ranks, want_loss, rtol, device, card, launches, errors, world,
                want_grad=None):
    recs = []
    for r, rank in enumerate(ranks):
        rec = dict(rank[part], rank=r)
        ls, n = rec["losses"], rec["launches"]
        require(all(math.isfinite(v) for v in ls),
                f"{part} rank {r}: losses not finite: {ls}")
        require(abs(ls[0] - want_loss) <= rtol * abs(want_loss),
                f"{part} rank {r}: first loss {ls[0]} vs one rank's {want_loss} beyond "
                f"rtol {rtol}")
        if want_grad is not None:
            got = rec.pop("grad")
            require(len(got) and all(math.isfinite(v) for v in got),
                    f"{part} rank {r}: no finite {PAR_GRAD_PARAM} gradient")
            rec["grad_rel_err"] = _grad_rel_err(got, rec["grad_offset"], want_grad)
            require(rec["grad_rel_err"] <= PAR_GRAD_RTOL,
                    f"{part} rank {r}: the first {PAR_GRAD_PARAM} gradient is "
                    f"{rec['grad_rel_err']} from one rank's (relative), beyond "
                    f"{PAR_GRAD_RTOL}")
        want = _expected_attention(part, rec, PAR_STEPS)
        fused = n["flash_bwd_fused"] == want and n["flash_bwd_dq"] == 0
        split = n["flash_bwd_fused"] == 0 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == want
        if device == "cuda":
            require(n["flash_fwd"] == want and (fused or split),
                    f"{part} rank {r} launched {n}, want {want} K4 and as many K5 (or K6a "
                    f"+ K6b) in {PAR_STEPS} steps")
            require(rec["plain_attention_calls"] == 0,
                    f"{part} rank {r} reached the plain attention "
                    f"{rec['plain_attention_calls']} times")
        rec["expected_k4"] = want
        for name in launches:
            launches[name] += n.get(name, 0)
        for kern, k in rec.get("kernels", {}).items():
            errors[kern] = max(errors.get(kern, 0.0), max(e[0] for e in k["errors"].values()))
        recs.append(rec)
    emit({"phase": f"parallel_{part}", "ok": True, "world": world,
          "one_rank_first_loss": want_loss, "loss_rtol": rtol,
          "grad_rtol": None if want_grad is None else PAR_GRAD_RTOL, "per_rank": recs,
          "card": card})
    return recs


def phase_parallel(torch, device="cuda", tiny=False):
    """Phase 27: the one-rank references here, then the 2-process and the
    4-process gloo worlds; returns ``(launches, errors)`` to join the
    ``kernels`` line."""
    import shutil
    import tempfile

    from distributed_ml_pytorch_tpu_torch.device import full_float32

    t0 = time.monotonic()
    card = _card(torch, device)
    if device == "cuda":
        full_float32()
    launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    errors = {}
    tmp = tempfile.mkdtemp(prefix="par27_", dir=os.path.join(ROOT, "build")
                           if os.path.isdir(os.path.join(ROOT, "build")) else None)
    try:
        ref = _par_references(torch, device, tiny)
        emit({"phase": "parallel_references", "ok": True, "world": "1 rank",
              "lm_first_loss": ref["lm"], "pp_losses": ref["pp"], "moe_first": ref["moe"],
              "grad_param": PAR_GRAD_PARAM, "card": card})
        two = _par_processes(PAR_RANKS, device, tiny, tmp)
        w2 = f"{PAR_RANKS} processes sharing the card over gloo"
        w4 = f"{PAR_WIDE} processes sharing the card over gloo"
        for part in ("sp", "ulysses"):
            _par_checks(part, two, ref["lm"], PAR_LOSS_RTOL, device, card, launches, errors,
                        w2 + ", {data: 1, seq: 2}", ref["lm_grad"])
        g = _par_checks("pp_gpipe", two, ref["pp"][0], PAR_PP_RTOL, device, card, launches,
                        errors, w2 + ", {stage: 2}")
        f = _par_checks("pp_1f1b", two, ref["pp"][0], PAR_PP_RTOL, device, card, launches,
                        errors, w2 + ", {stage: 2}")
        for a, b in zip(g, f):
            require(all(abs(x - y) <= PAR_PP_RTOL * abs(y)
                        for x, y in zip(b["losses"], a["losses"])),
                    f"1F1B losses {b['losses']} differ from GPipe's {a['losses']}")
            require(all(abs(x - y) <= PAR_PP_RTOL * abs(y)
                        for x, y in zip(a["losses"], ref["pp"])),
                    f"GPipe losses {a['losses']} differ from one stage's {ref['pp']}")
            require(b["peak_stash"] <= PAR_RANKS, f"1F1B kept {b['peak_stash']} graphs")
        four = _par_processes(PAR_WIDE, device, tiny, tmp)
        _par_checks("pp_dp", four, ref["pp"][0], PAR_PP_RTOL, device, card, launches, errors,
                    w4 + ", {data: 2, stage: 2}")
        moe = _par_checks("moe", four, ref["moe"][0], PAR_LOSS_RTOL, device, card, launches,
                          errors, w4 + ", {data: 2, expert: 2}", ref["moe_grad"])
        for rec in moe:
            require(abs(rec["aux"][0] - ref["moe"][1]) <= PAR_LOSS_RTOL * abs(ref["moe"][1]),
                    f"moe aux {rec['aux'][0]} vs one rank's {ref['moe'][1]}")
        _par_checks("composite", four, ref["lm"], PAR_LOSS_RTOL, device, card, launches,
                    errors, w4 + ", {data: 1, fsdp: 2, model: 2}", ref["lm_grad"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "parallel", "ok": True, "launches": launches,
          "wall_s": time.monotonic() - t0, "card": card})
    return launches, errors


# ------------------------------------------------------------------ phase 28

#: phase 28: GPT-2-small widths (the published vocabulary), depth cut to 8
#: layers, 2 a stage (each update's stage checkpoints about 0.54 GB), on 4
#: stages that are threads of this process; float32, M microbatches of
#: MB x SEQ tokens, STEPS steps, plain SGD at LR
MPMD_WIDTHS = dict(vocab_size=50257, d_model=768, n_heads=12, d_ff=3072, max_len=1024)
MPMD_LAYERS, MPMD_STAGES, MPMD_M, MPMD_MB, MPMD_SEQ = 8, 4, 4, 2, 512
MPMD_STEPS, MPMD_LR = 6, 0.1
TINY_MPMD = dict(widths=dict(vocab_size=64, d_model=64, n_heads=2, d_ff=128, max_len=128),
                 layers=4, mb=2, seq=128, steps=4)
#: the fleet against MpmdLocal and MpmdLocal against one stage: the same
#: kernels on the same rows, the stages only split the layers
MPMD_RTOL = 1e-5
#: the stage killed under chaos against the fault-free fleet (replay
#: rebuilds the same updates)
MPMD_CHAOS_TOL = (1e-5, 1e-6)
#: the int8 activation codec against the dense fleet (bounded loss)
MPMD_INT8_RTOL = 5e-3
#: the bubble attribution's fractions (each stage's exclusive states, which
#: sum to its wall clock by construction) must sum to 1 within this
MPMD_ATTR_TOL = 0.02
#: (stage, step) killed and the step whose end triggers the snapshot
MPMD_KILL, MPMD_SNAPSHOT_AT = (1, 3), 1
MPMD_GROUPS = {
    "K4 flash_fwd (f32)": ["flash_fwd_kernel"],
    "K5 flash_bwd_fused (f32)": ["flash_bwd_kv_kernel"],
    "K6a flash_bwd_dq (f32)": ["flash_bwd_dq_kernel"],
    "matmul": ["gemm", "Gemm", "nvjet", "xmma", "cutlass"],
    "softmax_ce": ["softmax", "nll_loss", "cross_entropy"],
    "layer_norm": ["layer_norm", "LayerNorm"],
}


def _mpmd_shapes(tiny):
    from distributed_ml_pytorch_tpu_torch.parallel.pipeline import PipelineLMConfig

    if tiny:
        t = TINY_MPMD
        return (PipelineLMConfig(**t["widths"], n_layers=t["layers"]), t["mb"], t["seq"],
                t["steps"])
    return (PipelineLMConfig(**MPMD_WIDTHS, n_layers=MPMD_LAYERS), MPMD_MB, MPMD_SEQ,
            MPMD_STEPS)


def _mpmd_expected(cfg, steps):
    """Phase 28 (b)'s attention launches, from the schedule: a stage
    before the last runs K4 in each microbatch's forward and again in the
    backward's recompute and K5 in the backward; the last stage's fused
    loss and backward one of each; L layers a stage."""
    L = cfg.n_layers // MPMD_STAGES
    per = L * MPMD_M * steps
    return {"flash_fwd": (MPMD_STAGES - 1) * 2 * per + per,
            "flash_bwd_fused": MPMD_STAGES * per, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _close_losses(got, want, rtol, atol=0.0):
    return len(got) == len(want) and all(
        math.isfinite(a) and abs(a - b) <= atol + rtol * abs(b) for a, b in zip(got, want))


class MpmdBackground:
    """What phase 28 starts ahead of itself (while phase 27's rank processes
    run): its weights, the whole model drawn on the host from seed 0 on a
    thread (about 15 s at its width), and (f), ``python -m
    distributed_ml_pytorch_tpu_torch.coord.cli --mpmd`` as a process of its
    own, its output in files under ``build/``."""

    def __init__(self, tiny=False, device="cuda"):
        import tempfile

        from distributed_ml_pytorch_tpu_torch.parallel.pipeline import init_pp_params

        self._out = {}
        self._thread = threading.Thread(
            target=lambda: self._out.update(full=init_pp_params(_mpmd_shapes(tiny)[0], 0)),
            daemon=True)
        self._thread.start()
        build = os.path.join(ROOT, "build")
        self.dir = tempfile.mkdtemp(prefix="mpmd28_cli_",
                                    dir=build if os.path.isdir(build) else None)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.argv = [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.coord.cli",
                     "--mpmd", *(["--backend", device] if device != "cuda" else [])]
        self._files = [open(os.path.join(self.dir, name), "w+") for name in ("out", "err")]
        self._proc = subprocess.Popen(self.argv, cwd=ROOT, env=env, stdout=self._files[0],
                                      stderr=self._files[1], text=True)

    def params(self):
        self._thread.join()
        require("full" in self._out, "phase 28's weights were not drawn")
        return self._out["full"]

    def stop(self):
        """Kill (f)'s process if it still runs (a phase failed before 28)
        and remove its files."""
        if not self._files[0].closed:
            self.cli(timeout=0)

    def cli(self, timeout=600):
        """``(exit code, stdout, stderr)`` of (f), once it ended (killed
        past ``timeout`` seconds)."""
        import shutil

        try:
            code = self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            code = self._proc.wait()
        texts = []
        for fh in self._files:
            fh.seek(0)
            texts.append(fh.read())
            fh.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        return code, texts[0], texts[1]


def phase_mpmd(torch, device="cuda", tiny=False, background=None):
    """Phase 28 (see the module docstring); ``background`` is the
    :class:`MpmdBackground` started ahead of it (started here when None).
    Returns ``(launches, errors)`` to join the ``kernels`` line."""
    import shutil
    import tempfile

    from distributed_ml_pytorch_tpu_torch import bench_all
    from distributed_ml_pytorch_tpu_torch.analysis import timeline
    from distributed_ml_pytorch_tpu_torch.coord import stages as st
    from distributed_ml_pytorch_tpu_torch.device import full_float32
    from distributed_ml_pytorch_tpu_torch.ops import attention as at
    from distributed_ml_pytorch_tpu_torch.parallel import mpmd

    t0 = time.monotonic()
    bg = background if background is not None else MpmdBackground(tiny, device)
    card = _card(torch, device)
    if device == "cuda":
        full_float32()
    cfg, mb, seq, steps = _mpmd_shapes(tiny)
    S, M = MPMD_STAGES, MPMD_M
    ranges = mpmd.stage_param_ranges(cfg, S)
    full = bg.params()
    toks, tgts = st.scenario_data(0, steps, M, mb, seq, cfg.vocab_size)
    tokens_per_step = M * mb * seq
    build = os.path.join(ROOT, "build")
    tmp = tempfile.mkdtemp(prefix="mpmd28_", dir=build if os.path.isdir(build) else None)
    try:
        # (a) the oracle, the first fused backward's tensors kept for (e)
        seen, restore = _record_first_call(torch, at, "flash_bwd_fused_cuda")
        try:
            local = mpmd.MpmdLocal(cfg, S, M, MPMD_LR, params=full, device=device)
            local_losses = [local.step(a, b) for a, b in zip(toks, tgts)]
        finally:
            restore()
        del local
        one = mpmd.MpmdLocal(cfg, 1, 1, MPMD_LR, params=full, device=device)
        one_losses = [one.step(a.reshape(1, M * mb, seq), b.reshape(1, M * mb, seq))
                      for a, b in zip(toks[:2], tgts[:2])]
        del one
        if device == "cuda":
            torch.cuda.empty_cache()
        require(_close_losses(local_losses[:2], one_losses, MPMD_RTOL),
                f"MpmdLocal's first losses {local_losses[:2]} vs one stage's {one_losses} "
                f"beyond rtol {MPMD_RTOL}")
        emit({"phase": "mpmd_oracle", "ok": True, "losses": local_losses,
              "one_stage_losses": one_losses, "rtol": MPMD_RTOL, "stages": S,
              "layers": cfg.n_layers, "microbatches": f"{M} x {mb} x {seq}",
              "ranges": ranges, "card": card})

        def fleet(**kw):
            base = tempfile.mkdtemp(dir=tmp)
            try:
                out = st.mpmd_scenario(base_dir=base, seed=0, n_stages=S, n_microbatches=M,
                                       mb=mb, seq=seq, lr=MPMD_LR, cfg=cfg, params=full,
                                       device=device, **{"steps": steps, **kw})
                # the flight recorders' dumps, merged before the directory goes
                out["timeline"] = timeline.analyze(out["obs_dir"])
            finally:
                shutil.rmtree(base, ignore_errors=True)
            require(out["ok"], f"mpmd fleet {kw}: errors {out['errors']}, "
                               f"events {out['events'][-6:]}")
            require(out["applied_ok"] and out["discarded_applies"] == 0,
                    f"mpmd fleet {kw}: applied {out['applied']}, discarded "
                    f"{out['discarded_applies']}")
            return out

        def rates(out):
            wall = out["wall_s"]
            return {"tokens_per_s": tokens_per_step * (len(out["losses"]) - 1) / wall,
                    "bubble_fraction": max(0.0, 1.0 - out["busy_s"] / (S * wall)),
                    "wall_s": wall, "busy_s": out["busy_s"]}

        # (b) the fault-free fleet, the attention counted from zero in each
        # run (the profiler repeats a run that lost a kernel), profiled
        runs = {}

        def steady_run():
            _zero_attention_launches(at)
            with _plain_attention_calls(at) as plain:
                runs["out"] = fleet()
            runs["launches"], runs["plain"] = dict(at.launches), plain.n

        profile = None
        if device == "cuda":
            from distributed_ml_pytorch_tpu_torch.utils.devprof import kernel_breakdown

            profile = kernel_breakdown(steady_run, MPMD_GROUPS)
        else:
            steady_run()
        steady, launches = runs["out"], runs["launches"]
        want = _mpmd_expected(cfg, steps)
        if device == "cuda":
            require(launches == want and runs["plain"] == 0,
                    f"mpmd fleet launched {launches} with {runs['plain']} plain attention "
                    f"calls, want {want} and none")
        require(_close_losses(steady["losses"], local_losses, MPMD_RTOL),
                f"fleet losses {steady['losses']} vs MpmdLocal's {local_losses}")
        report = steady["timeline"]
        attribution = bench_all.check_bubble_attribution(report["bubble_attribution"])
        attr_sum = sum(attribution["fractions"].values())
        require(attribution["stages"] == S and abs(attr_sum - 1.0) <= MPMD_ATTR_TOL,
                f"the bubble's attribution {attribution} sums to {attr_sum}")
        emit({"phase": "mpmd_fleet", "ok": True, "losses": steady["losses"],
              **rates(steady), "bubble_attribution": attribution,
              "attribution_sum": attr_sum, "attribution_tol": MPMD_ATTR_TOL,
              "members": {m["member"]: m["fractions"] for m in report["members"]
                          if m["plane"] == "mpmd"},
              "wire_attribution": report["wire_attribution"],
              "journeys": {k: report["journeys"][k] for k in ("correlated_units",
                                                             "cross_member_units")},
              "dumps": report["n_dumps"], "ring_dropped_spans": report["ring_dropped_spans"],
              "launches": launches, "expected_launches": want,
              "plain_attention_calls": runs["plain"],
              "ckpt_bytes_per_update": 4 * ranges[-1][1],
              "stage_stats": {k: {n: v[n] for n in ("fwd", "bwd", "updates", "busy_s")}
                              for k, v in steady["stats"].items()},
              "profiled": profile is not None, "profile": profile, "card": card})

        # (c) a stage's death under chaos
        kill_stage, kill_at = MPMD_KILL
        chaos = fleet(kill_stage=kill_stage, kill_at_step=kill_at,
                      snapshot_at_step=MPMD_SNAPSHOT_AT, plan=st.default_mpmd_plan(0))
        require(chaos["stage_restarts"] == 1 and chaos["stage_mttr_s"] is not None,
                f"mpmd chaos run: {chaos['stage_restarts']} restarts, events "
                f"{chaos['events'][-6:]}")
        require(_close_losses(chaos["losses"], steady["losses"], *MPMD_CHAOS_TOL),
                f"chaos losses {chaos['losses']} vs the fault-free {steady['losses']}")
        emit({"phase": "mpmd_stage_death", "ok": True, "losses": chaos["losses"],
              "stage_mttr_ms": chaos["stage_mttr_s"] * 1e3, "timings": chaos["timings"],
              "chaos": chaos["chaos_counts"], "driver_stats": chaos["driver_stats"],
              "reshipped": {k: v["reshipped"] for k, v in chaos["stats"].items()},
              **rates(chaos), "tol": MPMD_CHAOS_TOL, "card": card})

        # (d) the int8 activation codec, fault-free
        q = fleet(act_codec="int8")
        require(_close_losses(q["losses"], steady["losses"], MPMD_INT8_RTOL),
                f"int8 losses {q['losses']} vs dense {steady['losses']}")
        lossy = {k: (v["act_wire_floats"], v["act_dense_floats"])
                 for k, v in q["stats"].items() if v["act_dense_floats"]}
        require(len(lossy) == S and all(w * 3 <= d for w, d in lossy.values()),
                f"int8 wire floats (wire, dense) {lossy}")
        emit({"phase": "mpmd_int8", "ok": True, "losses": q["losses"],
              "rtol": MPMD_INT8_RTOL, "wire_vs_dense_floats": lossy, **rates(q),
              "card": card})

        # (e) K4 and K5 on one stage's own tensors from (a)
        errors = {}
        if device == "cuda":
            args = seen.pop("args", None)
            require(args is not None, "no fused backward call to hold against its plain version")
            errs, ms, check_s = _long_check(torch, at, args, ("flash_fwd", "flash_bwd_fused"))
            errors = {k: max(e[0] for e in errs[k].values()) for k in errs}
            emit({"phase": "mpmd_kernels", "ok": True, "q_shape": list(args[0].shape),
                  "dtype": str(args[0].dtype).replace("torch.", ""), "errors": errs,
                  "ms": ms, "plain_check_s": check_s, "card": card})

        # (f) the entry point, started ahead (MpmdBackground)
        code, out, err = bg.cli()
        require(code == 0, f"coord.cli --mpmd exited {code}: {out[-2000:]} {err[-2000:]}")
        summary = [ln for ln in out.splitlines() if ln.startswith("mpmd scenario:")]
        emit({"phase": "mpmd_cli", "ok": True, "argv": bg.argv[1:],
              "summary": summary[-1][:600] if summary else None, "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "mpmd", "ok": True, "launches": launches,
          "wall_s": time.monotonic() - t0, "card": card})
    return launches, errors


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import distributed_ml_pytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAILED: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    # a hang dumps every thread's stack and fails the run inside its limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    mpmd_ahead = None
    try:
        phase_device_and_build(torch)
        measured = phase_kernels(torch)
        phase_trainer(torch)
        phase_trainer(torch, steps=2, batch=1024)
        phase_profile_window(torch)
        launches, per_step_workers = phase_downpour(torch)
        measured.update(phase_attention(torch))
        lm_launches, split_launches = phase_lm(torch)
        # K4/K5 from the LM run; K6a/K6b from the split step, the model path
        # that runs them
        launches.update({k: lm_launches[k] for k in ("flash_fwd", "flash_bwd_fused")})
        launches.update({k: split_launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")})
        phase_default_widths(torch)
        measured.update(phase_decode_attention(torch))
        launches["decode_attention"] = phase_generate(torch)
        phase_serving(torch)
        k3, k3_launches = phase_conv_epilogue(torch)
        measured.update(k3)
        launches.update(k3_launches)
        measured.update(phase_head_update(torch))
        launches["fused_head"] = phase_fused_head_step(torch)
        phase_alexnet(torch)
        bf16_measured, bf16_launches = phase_trainer_family(torch)
        measured.update(bf16_measured)
        launches.update(bf16_launches)
        in_process, busy_ms_per_step = phase_chunked_worker(torch, per_step_workers)
        device_cycle, dense_16a = phase_ps_processes(torch, in_process)
        sharded = phase_sharded_processes(torch, per_step_workers)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd"):
            launches[name] += sharded[name]
        # the long-context runs (K4 with K5, then with K6a + K6b) and the
        # K-step LM runs add their attention launches; the kernels' errors
        # at 32768 tokens join phase 5's
        long_launches, long_errors = phase_long_context(torch)
        for name, err in long_errors.items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
        for counts in (long_launches, phase_lm_flags(torch, device_cycle)):
            for name, n in counts.items():
                launches[name] += n
        codec = phase_codec_plane(torch, dense_16a, busy_ms_per_step, per_step_workers)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd"):
            launches[name] += codec[name]
        elastic = phase_elastic(torch)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd"):
            launches[name] += elastic[name]
        durability = phase_durability(torch)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd"):
            launches[name] += durability[name]
        sched = phase_sched(torch)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd", "decode_attention"):
            launches[name] += sched[name]
        gray_fleet = phase_gray_fleet(torch)
        for name in ("flat_axpy", "relu_pool2_fwd", "relu_pool2_bwd", "decode_attention"):
            launches[name] += gray_fleet[name]
        families, family_errors = phase_model_families(torch)
        for name, n in families.items():
            launches[name] += n
        for name, err in family_errors.items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
        mesh_launches, mesh_errors = phase_mesh(torch)
        for name, n in mesh_launches.items():
            launches[name] += n
        for name, err in mesh_errors.items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
        mpmd_ahead = MpmdBackground()
        par_launches, par_errors = phase_parallel(torch)
        for name, n in par_launches.items():
            launches[name] += n
        for name, err in par_errors.items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
        mpmd_launches, mpmd_errors = phase_mpmd(torch, background=mpmd_ahead)
        for name, n in mpmd_launches.items():
            launches[name] += n
        for name, err in mpmd_errors.items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
        smi = nvidia_smi_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if mpmd_ahead is not None:
            mpmd_ahead.stop()
    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m.get("bound_by", "bytes"),
                        "library_ms": m["library_ms"]})
    faulthandler.cancel_dump_traceback_later()
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
