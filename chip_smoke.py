#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: needs CUDA; prints the card's name and power limit
     (``nvidia-smi``); TF32 off for f32 matmuls and convolutions;
  2. build: the twelve CUDA kernels of the port from the five sources in
     the checkout (``nvcc``, one process per source, started together),
     with each kernel's registers and spills from ``-Xptxas -v``: no
     spill and no stack frame in the wgmma, quantize_tiles, quantize_ef
     and top-k libraries, and every instantiation of the wgmma kernel
     (head dims 32, 64, 128, 192, 256 x 1 and 2 consumer warpgroups) in
     the report;
  3. kernels vs plain versions on the card.  ``quantize_tiles``,
     ``quantize_ef``, ``dequant_accum``, ``topk_ef`` and ``topk_mask`` are
     held BIT-EQUAL (NaN for NaN): quantize_tiles over a sweep of tiles
     (64 to 1024 on its warp route, 4096 on its block route), lengths,
     input types and a NaN tile, including every length the gemma-2b,
     gemma2-9b, deepseek-v2-lite-16b (at 4 x 256 and at phase 14 (e)'s
     4 x 8192), qwen3-moe-30b-a3b and jamba-v0.1-52b (16 layers) serving
     runs write, at their tiles (256, 512 and 64 of MLA's latents, 128; and
     dequantize must round-trip within s/254), the training wire over the CPU tests' cases (ragged lengths,
     decays, ratios, rank counts 1, 2, 4 and 8 at lengths that are and
     are not multiples of 16, zero tiles, exact halves, NaN tiles, f32
     and bf16 for topk_mask; dequant_accum and the top-k kernels at tile
     1024, their warp routes, and 2048, their block routes) and at every
     bucket length of the training path, called as the path calls them
     (the residual written in place; quantize_tiles and topk_mask as the
     encode without error feedback).  ``flash_attention`` is held within a stated tolerance,
     element by element (f32: rtol = atol = 1e-5; bf16: 2 bf16 ulps of
     the element plus 2 of its row's largest magnitude) over the JAX
     kernel tests' shapes and more (hd 32 to 256, 192 among them, G 1 to
     68, ragged T, grids of one and two consumer warpgroups) x f32 (the SIMT route) /
     bf16 (the wgmma route) x window, softcap, window+softcap, non-causal
     and non-causal+window, rows with no valid key, and at the prefill
     shapes of gemma2-9b (global and local layers, softcap 50) and gemma-2b
     in both f32 and bf16, jamba-v0.1-52b's attention prefill (GQA 32/8,
     hd 128), and the encoder-decoder's non-causal shapes (the encoder,
     T = S = 512, and the cross-attention, T = 32 and T = 1 against S =
     512; hd 64) in bf16 (wgmma) and f32 (SIMT), each timed against its
     plain version, its bound and SDPA; its pre-pass ``nonfinite_tiles``
     is held
     bit-equal, and the NaN rule (NaN exactly where the plain version has
     NaN, for an inf or NaN of v in a skipped key tile) on both routes.
     Then kernel, plain-version, bound and library times at the serving
     and training paths' shapes, the library being one PyTorch call that
     computes the same function where there is one (SDPA; flex_attention
     compiled, for the softcap shapes); flash on both routes (the SIMT
     kernel on the same bf16 inputs), and gates: the wgmma route, pre-pass
     included, no slower than the library call and 5x faster than the
     SIMT kernel's recorded time at the gemma2-9b prefill; the warp
     routes faster than the block kernels' recorded times: topk_ef 2x,
     topk_mask 3x (f32) and dequant_accum 1.4x (one rank) at the largest
     bucket, and quantize_tiles 3x at the gemma2-9b prefill writes;
  4. small references: the reduced gemma-2b, gemma2-9b and gemma3-4b in
     f32 on the card (prefill through the flash kernel) agree with the
     port's CPU path (plain versions) for prefill logits and four
     vector-position decode steps, the two new ones past their window's
     ring wrap; and gemma-2b for two int8_fused training steps (all held
     against the JAX package by the tests);
  5. the serving path at full width: ``repro_torch.launch.serve`` with
     gemma-2b (18 layers, d_model 2048, vocab 256000, bf16, random
     weights from seed 0), int8 paged KV, continuous batching, 8 requests
     of 128 prompt + 64 new tokens through 4 slots;
  6. information only: the share of tokens at temperature 0 that the
     engine shares with ``run_static`` and ``generate``, and a profile of
     ten decode ticks (device-busy share, top kernels);
  7. gemma2-9b served at full width (42 layers alternating a 4096 window
     and global attention, GQA 16/8 heads, softcaps 50 and 30, untied
     head, 10.2 B parameters in bf16, random weights from seed 0), int8
     paged KV in two length groups, 4 requests of 6144 prompt + 32 new
     tokens through 4 slots: the prompts outrun the window, so the window
     mask, the kernel's tile skipping and the ring caches' wrap all run;
     the prefill time of one admission, and a profile of five decode
     ticks;
  8. the training path at full width: ``repro_torch.launch.train`` with
     gemma-2b, Adam, batch 4 x seq 512, 3 steps on an NCCL group of world
     1, once each with ``--sync comm --compressor int8_fused``, ``--sync
     comm --compressor topk_fused``, both of them again with
     ``--no-error-feedback``, and ``--sync vanilla``; step time, tokens/s,
     peak memory and a ``torch.profiler`` view of one more step per run;
  9. the explicit collectives at world 4 on the one card: 4 spawned
     processes on a gloo group (NCCL refuses two ranks on one device), card
     tensors staged through pinned host memory.  ``PlanExecutor`` runs
     int8_fused with error feedback on ``ring_fused`` for 3 rounds over
     the wire's first and largest buckets (73728 and 603979776 f32, each
     rank's gradients drawn on the card from seed + rank): every rank's
     result bit-equal (a digest of the bits), quantize_ef once and
     quantize_tiles 2·p = 8 times per bucket and round, all on the warp
     route; int8_fused (the gather wire, dequant_accum at w = 4) and
     topk_fused on ``ring`` at the 9437184 bucket, each bit-equal across
     ranks and to the same executor on the CPU (gloo, plain versions),
     one launch per bucket; every algorithm on a (2, 2) mesh, bit-equal
     across ranks and to its CPU schedule; seconds per round, staged
     bytes, a profiled round split into kernels, plain ops, staging copies
     and host; quantize_tiles on every row of the (4, m) hop buffers at
     both buckets' chunk lengths (m = 9216 and 75497472 f32) and
     dequant_accum at w = 4, each held bit-equal to its plain version,
     then timed by graph replay;
 10. the rounds axis: (a) ``repro_torch.launch.train`` at phase 8's full
     width, 4 steps each, with ``--local-sgd 2 --sync comm --compressor
     int8_fused`` (2 parameter rounds, each through the int8_fused wire
     on the params-minus-anchor delta), ``--lag 4`` with int8_fused (a
     probe every step, at least one sync and one reuse) and
     ``--push-pull 2 2`` with topk_fused (2 pushes, 2 dense fetches):
     round counts, step times, peak memory (against the reckoning of 26
     bytes a parameter, checked before the first run) and one profiled
     step with a round split into wire kernels, other device work and
     host; (b) reduced gemma-2b in f32: 4 local-SGD steps with int8_fused
     rounds and 4 LAG steps at θ = 4 (a sync, then reuse steps) agree
     between the card and the CPU (phase 4's tolerance, the same round
     counts, gated as in (a)), and a checkpoint — 2 steps, save,
     load into a fresh session, 2 steps — is bit-equal to the
     uninterrupted 4-step run on the card and restores on the CPU bit for
     bit; (c) 4 spawned ranks (``launch/dist.py:spawn``) on a gloo group on
     the one card, gemma-2b at full width with 1 layer, SGD, local SGD
     τ = 2 with int8_fused rounds on psum (the gather wire,
     dequant_accum at w = 4), global batch 4 x seq 128, 4 steps: before
     each round the ranks' parameters differ and after it they are
     bit-equal (digests of the bits); then, with the card free again,
     quantize_ef (residual written in place) and dequant_accum on a
     (4, n) stack of payloads, at every delta-bucket length of that run,
     each held bit-equal to its plain version;
 11. the communication planner: (a) ``repro_torch.launch.train --sync
     auto --topology commodity_cluster`` at phase 8's full width (Adam,
     batch 4 x seq 512, 3 steps, NCCL world 1): the backward measured on
     the card (``profile_backward``), the search's host time, the winner
     (one of the priced arms) and every bucket, step times, peak memory and
     a profiled step split into wire kernels, other device work and host;
     the executor's plan is the planned one bucket for bucket; (b) 4
     spawned ranks on a gloo group on the one card, gemma-2b at full width
     with 1 layer, SGD, ``plan_auto`` with local SGD τ = 2 on
     ``device:4@fast_ici`` at a pinned 30 ms backward, global batch 4 x seq
     128, 4 steps: every rank's plan digest equal and the plan the port's
     planner makes on the CPU from the same inputs (printed beside it), the
     ranks' parameters different before each round and bit-equal after it;
     then the kernels of each run at its plan's packed bucket lengths (and,
     at world 4, every row of the ring_fused hop buffers), each held
     bit-equal to its plain version;
 12. sharded data parallelism: (a) ``repro_torch.launch.train`` at phase
     8's full width with ``--sync comm --compressor int8_fused
     --parallelism shard`` (NCCL world 1, 3 steps): the rows of the f32
     master and Adam's moments hold exactly the layout's reckoning, the
     allocator holds the parameters, the rows and the EF residuals after
     the run (no replicated moment alive), the peak within a reckoning
     printed before the run; step times, a profiled step, and the
     largest difference from phase 8's replicated int8_fused parameters
     (printed, not gated); (b) reduced gemma-2b in f32 on 4 spawned
     ranks over gloo on the one card: 3 steps of the sharded and the
     replicated step on one plan, dense ``ring`` and ``int8_fused`` on
     ``ring`` with Adam (parameters, gathered master rows and moments,
     EF residuals bit-equal on every rank) and LAMB on dense ``ring``
     (rtol 2e-5, atol 1e-7); the int8_fused session's checkpoint, saved
     at world 4, restores here into a world-1 sharded session and a
     replicated one bit for bit; (c) 4 spawned ranks, gemma-2b at full
     width with 1 layer, Adam, global batch 4 x seq 128, ``plan_auto``
     on ``commodity_cluster`` at a pinned 30 ms backward with the spec
     ``shard`` and a memory budget halfway between the layout's
     replicated moments and its sharded rows: the plan
     ``every_step_sharded``, every rank's digest equal to the port's
     CPU planner's, parameters bit-equal across ranks after every step,
     the rows' bytes the layout's reckoning; then the same plan run
     replicated, for the per-rank peak, state bytes, staged bytes and
     step times beside the sharded run's; then the kernels of (c) at
     its packed bucket lengths, each bit-equal to its plain version;
 13. pipeline parallelism: (a) ``repro_torch.launch.train`` at phase 8's
     full width with ``--sync comm --compressor int8_fused --parallelism
     micro=4`` (the degenerate pipe: S = 1, 4 micro-batches accumulated
     in f32, the wire per layer row; NCCL world 1, 3 steps): 164 per-row
     buckets (2 shared + 18 x 9), the peak within a reckoning printed
     before the run, step times, tokens/s, a profiled step and the
     largest difference from phase 8's int8_fused parameters (printed,
     not gated); (b) reduced gemma-2b in f32 at 4 layers on 4 spawned
     ranks over gloo on the one card, M = 4, 3 steps, Adam, dense psum,
     int8_fused and topk_fused on ring: pipe(2) x data(2) against S = 1 x
     data(2), losses, merged parameters and moments and EF residuals
     bit-equal on every rank and across the ranks, and the card within
     phase 4's tolerance of the same S = 2 run on the CPU; (c) gemma-2b at
     full width in two stages on 2 spawned ranks over gloo (the depth 18
     when a printed reckoning leaves 8 GiB of the card free, else cut),
     M = 4, Adam, int8_fused, 3 steps: per-rank peak, staged bytes split
     into the activation hops and the shared cells' pipe all-reduce, step
     times, and the merged parameters bit-equal to the world-1 S = 1 run
     of the same depth (at depth 18, (a)'s);
 14. the MoE and MLA families: first, with the card free, the kernels at
     their new shapes (d) — flash in bf16 at deepseek-v2-lite-16b's MLA
     prefill (q/k head dim 192, v padded from 128; T = 128, a ragged B =
     2 x T = 75, and 4096) and at qwen3-moe-30b-a3b's (GQA 32/4, head
     dim 128), both on the wgmma route, within phase 3's tolerance and NaN
     where the plain version has NaN, timed against the plain version,
     the bound and SDPA; at MLA's shapes the SIMT kernel too, by direct
     call, held the same way: the wgmma route must be 4x faster than it at
     T = 128 and 20x at T = 4096 (phase 3 holds quantize_tiles at the
     int8 pools' lengths);
     reduced f32 references on the card
     (moe_ffn's expert choices and keep mask equal to the CPU's at
     capacity factor 0.5, phase 4's prefill + decode check, MLA's naive
     and absorbed decodes within phase 4's tolerance); then (a)
     deepseek-v2-lite-16b (64 routed experts top-6 and 2 shared, 15.65 B
     parameters; 14 of its 27 MLA layers) and (b) qwen3-moe-30b-a3b (128
     experts top-8, 30.53 B parameters; 24 of its 48 layers), cut in
     depth for the call's time, served at full width with phase
     5's traffic, bf16 from seed 0, int8 paged KV, the peak within a
     reckoning printed before each run (weights, pool, the largest
     transient, + 1 GiB), tokens/s, TTFT, the tick and its device-busy
     share; (c) qwen3-moe-30b-a3b trained at full width and 4 layers
     (cut from 48 when 20 B a parameter fits 70 GiB, else 2), Adam,
     int8_fused, batch 4 x seq 512, NCCL world 1, 3 steps: the drop tap's
     ``moe capacity:`` line, step times, tokens/s, peak, a profiled step
     split into wire kernels, other device work and host; then
     quantize_ef and dequant_accum bit-equal at every bucket length of
     (c) and timed at the largest (a stacked expert leaf); (e)
     deepseek-v2-lite-16b served with long prompts (phase 7's traffic: 4
     requests of 4096 + 32 tokens through 4 slots, max_len 8192), the
     peak within its reckoning + 1 GiB, then one 4096-token admission
     timed alone (median of 3) and profiled (flash's device share), beside
     the reckoned SIMT cost of the same admission (27 x (d)'s SIMT time);
 15. the Mamba, xLSTM and encoder-decoder families, bf16 weights from
     seed 0: first, with the card free, reduced f32 references on the card
     against the CPU from the same weights (mamba_forward with its state
     and two mamba_decode steps, the same for mLSTM and sLSTM, seamless's
     encode with a prefill and a decode step, and phase 4's prefill + four
     decode steps for jamba and xlstm; phase 4's tolerance); then (a)
     jamba-v0.1-52b served at full width cut to 16 of its 32 layers (for
     memory: 26.05 B parameters; two 8-layer Jamba blocks, so one segment
     of 2 repeats) and (b) xlstm-125m at full width, each with phase 5's
     traffic and int8 paged KV, the peak within a reckoning printed before
     the run (weights, pool, the per-slot recurrent state, the largest
     transient, + 1 GiB), tokens/s, TTFT, the tick, its device-busy share
     and launches a tick; (c) seamless-m4t-large-v2 at full width (24 + 24
     layers), one-shot ``generate`` of 64 tokens for 4 prompts of 32
     tokens over 512 bf16 frames: flash 72 at the prefill + 24 per decode
     step, all on wgmma, finite logits, the prefill time and the time per
     token, the peak within its reckoning; (d) the CLI's one-shot path for
     seamless at full width cut to 2 + 2 layers, with the f32 frames the
     CLI draws: the encoder's and the cross-attention's flash on SIMT, the
     decoder's self-attention on wgmma, and the reference's dtypes (f32
     memory and cross K/V, bf16 self K/V and logits); (e) xlstm-125m
     trained at full width and 4 of its 12 layers (one period of 3 mLSTM
     + 1 sLSTM, cut for time: the recurrences run as eager loops), Adam,
     int8_fused, batch 4 x seq 256, NCCL world 1, 3 steps: finite
     losses, the peak within a reckoning that counts the chunked remat
     (printed beside the ones without it), step times and a profiled
     step (device events only); then quantize_ef and dequant_accum
     bit-equal at every bucket length of (e), timed at the largest;
 16. tensor and expert parallelism, calibration and drift re-planning,
     each reckoning printed before its run: (a) gemma-2b at full width
     (18 layers unless two ranks at phase 8's bytes a parameter pass 70
     GiB) trained with tp = 2 on two spawned gloo ranks on the one card,
     each holding its half of every FFN (``convert.tp_slice``) under
     ``tp_region``, Adam, int8_fused on the rank's one-rank data group,
     batch 4 x seq 512, 3 steps: both ranks' losses bit-equal; against
     the unsharded run at NCCL world 1 on the same weights, losses within
     rtol 3e-4, the first step's gradients (before the DP edge) and
     Adam's first moment after 3 steps within 4e-2 of each leaf's L2
     norm, and every parameter within the Adam envelope (2 x 3.2 x the
     summed learning rates + 2 bf16 ulps); the first step's gradients
     bit-equal to the control, that run with every FFN's halves summed
     apart (``mlp_blocked``); every step's staged bytes the
     reckoning (2 activation all-reduces a layer, each copied to the host
     and back, + the DP edge's codes, scales and loss), and the reference
     TP check's model in f32 bit-equal to ``mlp_blocked(blocks=2)``; (b)
     ``moe_ffn`` at qwen3-moe-30b-a3b's widths (128 experts, top 8, 768
     wide, bf16), 2 x 512 tokens a rank, ep = 2 and ep = 4 on gloo groups
     of the spawned ranks, both all-to-all variants, router frozen, Adam
     (lr 0.05) on the expert leaves for 3 steps, against one process
     running ``groups=ep`` on the same tokens: drop counts equal, 2 + 2
     all-to-alls a step, each rank's loss bit-equal to the one process's
     over that rank's tokens, expert parameters and both moments
     bit-equal (the moments by digests);
     (c) ``measure_compression_costs`` on the card at the reference's set
     and sizes (quantize_ef 15, dequant_accum at w = 8 12, topk_ef 15
     launches, warp routes, nothing else), its table written as the
     ``--compression-costs`` JSON and read back by ``plan_auto``;
     ``calibrate_topology`` at NCCL world 1 (degenerate) and on the gloo
     world of 4 (card tensors staged); the three kernels bit-equal and
     timed at the calibration's sizes; (d) ``train --sync auto
     --calibrate --replan-drift-pct --replan-every`` at phase 8's full
     width, world 1: the drift table, the record's calibration and drift
     blocks with the reference's keys, at most one re-plan; the CLI's
     ``--parallelism dp=2,tp=2`` (gemma-2b) and ``dp=2,ep=2``
     (qwen3-moe-30b-a3b), reduced, on the gloo world of 4: ``final
     loss`` with the spec in ``describe()``; every CLI run launches the
     wire kernels its arm's plan names (each arm's rounds apart where a
     re-plan installs another).  ``python3 chip_smoke.py
     --phase 16`` runs the build and this phase alone;
 17. the elastic runtime: (a) ``repro_torch.launch.train`` at phase 8's
     full width (gemma-2b cut to 4 of its 18 layers, the call's time
     budget: a 9.65 GB checkpoint; Adam, batch 4 x seq 512, NCCL world
     1) with ``--sync comm --compressor int8_fused --no-error-feedback
     --elastic --topology node:2@datacenter,device:4@fast_ici
     --fault-trace kill:3@2,kill:7@2 --steps 4`` (one reshard: with a
     second checkpoint the run's disk writes would near ~45 GiB),
     its checkpoint under ``build/elastic_tmp`` (the disk's free space
     checked first, the directory removed after), beside an unfaulted
     4-step run of the same wire in this process: the events exactly 8 ->
     6 on node:2@datacenter,device:3@fast_ici at step 2, 4 grad rounds;
     the losses, the parameters and both moments (digests
     of the bits) bit-equal to the unfaulted run's; quantize_tiles and
     dequant_accum = buckets x steps on the warp routes in both runs, 0
     for every other kernel; the memory allocated before each spawn
     within 0.5 GiB of its value before the first session; the peak
     within a reckoning printed before the run (one session's state + the
     restored copy + the unfaulted run's step transients); the
     checkpoint's bytes (reckoned from the leaves, then on disk), each
     save's and load's seconds, GB/s and sha256 seconds, each spawn's
     seconds (the load apart) and the host's peak RSS; (b) reduced
     gemma-2b in f32, each scenario on the card and on the CPU (a gloo
     group of the one rank) from the same weights: vanilla Adam on the 8
     -> 6 -> 8 trace (bit-equal on the card to its unfaulted run),
     ``plan=True`` on kill:3@2,kill:7@2 (the plan keys at the reshard,
     the record's topology node:2@datacenter,device:3@fast_ici at world
     6), local SGD tau = 2 under slow:1x4@1 (one backpressure event, tau
     4), every step under slow:1x6@1 with ``plan=True`` on
     device:8@fast_ici (one re-plan, installed, then local SGD), and
     int8_fused with EF across one reshard (the EF residuals start afresh
     after it: the checkpoint holds only params and opt): events, notes,
     plan keys, records and round counts on the card equal the CPU's,
     losses within phase 4's tolerance.  ``python3 chip_smoke.py --phase
     17`` runs the build and this phase alone;
 18. the dry run and the op analysis (``repro_torch.launch.{dryrun,
     op_analysis}``): (a) ``python -m repro_torch.launch.dryrun`` for
     gemma-2b at train_4k (``--microbatches 1``), prefill_32k and
     decode_32k, rank 0 of the 16x16 mesh on CPU fake tensors, three
     processes started together on the host, each trace's seconds
     printed and its record's keys checked (the host processes of (a)
     and (b) start before phase 17 and run beside it); (b) on the card at
     world 1 (NCCL), one full-width gemma-2b step of each phase counted by
     the op analysis while the kernels run — train at 1 x 4096 tokens
     (Adam), prefill at 1 x 4096 (flash on its wgmma route) and one decode
     tick of the engine at 32 slots with the int8 pool — each held equal,
     in dot FLOPs, bytes and per-kernel calls, to a fake-tensor trace of
     the same step and shape on the host, where the plain versions run,
     and its kernel calls to the wrappers' launch counters
     (``nonfinite_tiles`` once per flash call).  No time is compared.
     ``python3 chip_smoke.py --phase 18`` runs the build and this phase
     alone;
 19. serving under the reference's model-axis layout
     (``sharding_ctx.serve_region``), four ranks of a gloo world on the
     card at tp = 4, each drawing only its share of the weights
     (``convert.serve_init``), ``make_prefill_step`` then donated
     ``make_decode_step`` steps: (a) gemma2-9b at full width and depth,
     B = 2, a 2048-token prompt, 8 steps (the kv heads split); (b)
     gemma-2b at full width with a 4096-entry cache in four blocks of
     1024 (one kv head: the length split and the split-KV combine), 8
     steps; (c) qwen3-moe-30b-a3b at full width and 4 layers, 32 experts
     a rank, no drop, 4 steps.  Each case's logits bit-equal on the four
     ranks and within ``P19_LOGITS_RTOL`` (relative L2 a step) of the
     unsharded steps on the card (argmax agreement printed as weak
     evidence); flash on the wgmma route on every rank's head block;
     per-rank peaks against the reckoning, staged bytes, prefill and step
     times printed.  (d) rank 0's counts of (a)'s prefill and first step
     equal, in dot FLOPs, bytes, kernel calls and collectives per axis,
     a fake-tensor trace of the same rank (a ``fake`` process group of
     world 4, on the host, started before phase 17).  Phase 3 times flash
     at the ranks' shapes.  It writes nothing to disk but the ranks'
     JSON.  ``python3 chip_smoke.py --phase 19`` runs the build, those
     flash shapes and this phase alone.

Every main-path run (5, 7, each of 8, each of 9 on every rank, each of
10 (a) and (c), each of 11 on every rank, and 12 (a) and both runs of
12 (c) on every rank, and 13 (a) and (c) on every rank, and 14 (a), (b),
(c) and (e), and 15 (a)–(e), and 16 (a) on both ranks, (c) and (d), and
both runs of 17 (a), and the three steps of 18 (b), and 19 on every
rank and case) sets
every kernel launch counter
to 0 just before it and reads them just after: each kernel of that run
must have launched exactly as often as the run's structure says, and
every other kernel 0 times.  Serving: quantize_tiles = paged leaves x
(admissions + decode ticks), all on the warp route (4 paged leaves for
deepseek-v2-lite-16b: c_kv and k_rope of its two segments); flash_attention
and its pre-pass = attention layers x admissions (2 x 8 for jamba cut
to 16 layers, 0 for xlstm, whose pool has no paged leaf and quantizes
nothing), all of them on the route ``route(dtype, head_dim)`` gives —
wgmma and none on SIMT for every family, MLA's head dim 192 included;
seamless one-shot: flash = 3 x 24 at the prefill + 24 per decode step,
all wgmma with bf16 frames; with f32 frames, the encoder's and the
cross-attention's on SIMT and the decoder's self-attention on wgmma; the
xlstm training run as 8's int8_fused run; the MoE training
run as 8's int8_fused run, and its drop tap routing each choice once
per forward; training: the wire's kernels = buckets x
steps, all on their warp routes (int8_fused: quantize_ef and
dequant_accum; topk_fused: topk_ef; without error feedback, int8_fused:
quantize_tiles and dequant_accum, topk_fused: topk_mask), flash 0 (the
training path keeps the differentiable chunked attention); world 4: as
stated in 9; the rounds axis: the wire's kernels = buckets x the ROUNDS
that run the wire, not x steps — parameter rounds for local SGD
(quantize_ef and dequant_accum on the delta buckets, at world 4 on every
rank), gradient syncs for LAG (quantize_ef and dequant_accum) and
push/pull (topk_ef, push steps only), all on the warp route, and 0 for
every other kernel; the planner: what the executed plan derives bucket by
bucket (``plan_launches``: topk_ef per topk_fused bucket and gradient
sync; per int8_fused bucket and parameter round, quantize_ef once and,
on ring_fused at world 4, quantize_tiles 2·p = 8 times), all on the warp
route, 0 for every other kernel; sharded: the int8_fused run as 8's
(quantize_ef and dequant_accum = buckets x steps), the planned world-4
runs as 11's (``plan_launches``: topk_ef per topk_fused bucket and
step); the pipeline: quantize_ef and dequant_accum once per leaf of the
per-row tree and step (164 x 3 at world 1, 83 x 3 on each stage of
(c)), all on the warp route; tensor parallelism: as 8's int8_fused run
on each rank's tree; calibration: the fused hooks' calls at the three
sizes (encode 5, decode 4 a size), warp routes; elastic: as 8's no-EF
int8_fused run, in every generation of the session; the dry run's card
steps: flash and its pre-pass = 18 at the prefill, quantize_tiles = 2
(the pool's paged leaves) at the decode tick, 0 for every other kernel
and at the train step; serving under the model axis: flash and its
pre-pass = the attention layers at the prefill on every rank (42, 18 and
4), all wgmma, 0 at the decode steps.  Launches made in
phases 3, 4, 6, 10 (b),
12 (b), 13 (b), 15's small references and 17 (b), and by the
checks and timings of 9, 10, 11, 12, 14 and 15, are not counted.  It
prints a ``{"kernels": [...]}``
JSON line with all twelve kernels (launches per run and per route) and,
last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
QUANT_TILES = (64, 256, 1024, 4096)       # 4096: quantize_tiles' block route
QUANT_OPS_PER_ELEMENT = 7       # abs, max, div, mul, round, 2 clamps

SLOTS, MAX_LEN, PAGE = 4, 256, 16
SERVE_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--quantize", "int8",
              "--engine", "continuous", "--batch", str(SLOTS),
              "--requests", "8", "--prompt-len", "128", "--gen", "64",
              "--max-len", str(MAX_LEN), "--page-size", str(PAGE),
              "--seed", "0"]

GEMMA2_SLOTS, GEMMA2_PROMPT, GEMMA2_MAX_LEN = 4, 6144, 8192
GEMMA2_SERVE_ARGS = ["--arch", "gemma2-9b", "--no-reduced", "--quantize",
                     "int8", "--engine", "continuous", "--batch",
                     str(GEMMA2_SLOTS), "--requests", "4", "--prompt-len",
                     str(GEMMA2_PROMPT), "--gen", "32", "--max-len",
                     str(GEMMA2_MAX_LEN), "--page-size", str(PAGE),
                     "--seed", "0"]

# flash attention sweep: the JAX kernel tests' (B, T, H, KV, hd), ragged T,
# hd 256 at G = 2 and 8, MLA's hd 192 at G = 2, grids of 128-row blocks
# (two consumer warpgroups on the wgmma route: B x H x ceil(T / 128) >= the
# SM count) with ragged T, and the variants; then the prefill shapes of the
# serving path
FLASH_SHAPES = ((1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 128, 8, 1, 32),
                (2, 128, 4, 4, 128), (1, 200, 4, 2, 64), (2, 11, 4, 1, 32),
                (1, 192, 4, 2, 256), (1, 128, 8, 1, 256),
                (1, 75, 4, 2, 192), (1, 1000, 136, 2, 64),
                (2, 300, 34, 2, 128), (2, 300, 34, 2, 192),
                (1, 520, 48, 8, 256))
FLASH_VARIANTS = ({}, {"window": 64}, {"softcap": 30.0},
                  {"window": 64, "softcap": 20.0}, {"causal": False},
                  {"causal": False, "window": 64})
FLASH_PATH_SHAPES = {   # name: (B, T, H, KV, hd, kwargs)
    "gemma2_9b_prefill_global": (1, GEMMA2_PROMPT, 16, 8, 256,
                                 {"softcap": 50.0}),
    "gemma2_9b_prefill_local": (1, GEMMA2_PROMPT, 16, 8, 256,
                                {"softcap": 50.0, "window": 4096}),
    "gemma_2b_prefill": (1, 128, 8, 1, 256, {}),
    # jamba-v0.1-52b's attention layers (phase 15 (a)): GQA 32/8, hd 128
    "jamba_prefill": (1, 128, 32, 8, 128, {}),
}

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
TRAIN_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", str(TRAIN_STEPS), "--seed", "0", "--log-every", "1"]
NO_EF = ["--no-error-feedback"]
TRAIN_RUNS = {   # run name: (extra CLI flags, kernels each bucket launches)
    "int8_fused": (["--sync", "comm", "--compressor", "int8_fused"],
                   ("quantize_ef", "dequant_accum", "dequant_accum[warp]")),
    "topk_fused": (["--sync", "comm", "--compressor", "topk_fused"],
                   ("topk_ef", "topk_ef[warp]")),
    "int8_fused_no_ef": (["--sync", "comm", "--compressor", "int8_fused",
                          *NO_EF],
                         ("quantize_tiles", "quantize_tiles[warp]",
                          "dequant_accum", "dequant_accum[warp]")),
    "topk_fused_no_ef": (["--sync", "comm", "--compressor", "topk_fused",
                          *NO_EF], ("topk_mask", "topk_mask[warp]")),
    "vanilla": (["--sync", "vanilla"], ()),
}
TILE = 1024
BLOCK_TILE = 2048   # the training wire sweeps' tile on the block routes
EF_SIZES = (1024, 1000, 2065, 4096)
RATIOS = (0.01, 0.05, 0.25)
ITERS = 16
# operations per element, for the bounds (f32, outside the tensor cores)
QEF_OPS = 10          # g + decay*e (2), abs, max, div, mul, round, clamp (2),
#                       residual (2): rounded to 10
TOPK_OPS = 3 + 2 * ITERS      # EF add (2), abs; per round a compare and an add
KERNEL_SOURCES = {
    # the wgmma route, which every serving path takes (bf16; hd 256, 128
    # and MLA's 192)
    "flash_attention": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention.py:79",
                        "flash_attention_pallas"),
    # the SIMT route (f32; bf16 at head dims outside the wgmma set): on
    # no serving path since MLA's 192 took the wgmma route
    "flash_attention_simt": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:79",
                             "flash_attention_pallas"),
    # the pre-pass of both routes: it stands in for the Pallas kernel's
    # visit of every key tile (the NaN rule), so it replaces a part of it
    "nonfinite_tiles": ("src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:79",
                       "flash_attention_pallas"),
    # the warp route, which every serving write takes (tiles <= 1024)
    "quantize_tiles": ("src/repro_torch/csrc/quantize_tiles.cu",
                       "src/repro/kernels/quantize_ef.py:99",
                       "quantize_pallas"),
    # the block route (tiles > 1024)
    "quantize_tiles_block": ("src/repro_torch/csrc/quantize_tiles.cu",
                             "src/repro/kernels/quantize_ef.py:99",
                             "quantize_pallas"),
    "quantize_ef": ("src/repro_torch/csrc/quantize_ef.cu",
                    "src/repro/kernels/quantize_ef.py:63",
                    "quantize_ef_pallas"),
    # the warp route, which the int8_fused wire takes (tile 1024)
    "dequant_accum": ("src/repro_torch/csrc/quantize_ef.cu",
                      "src/repro/kernels/quantize_ef.py:126",
                      "dequant_accum_pallas"),
    # the block route (tiles 1025 to 8192)
    "dequant_accum_block": ("src/repro_torch/csrc/quantize_ef.cu",
                            "src/repro/kernels/quantize_ef.py:126",
                            "dequant_accum_pallas"),
    # the warp route, which the topk_fused wire takes (tile 1024)
    "topk_ef": ("src/repro_torch/csrc/topk_mask.cu",
                "src/repro/kernels/topk_mask.py:99", "topk_ef_pallas"),
    # the block route (tiles 1025 to 8192)
    "topk_ef_block": ("src/repro_torch/csrc/topk_mask.cu",
                      "src/repro/kernels/topk_mask.py:99", "topk_ef_pallas"),
    # the warp route, which the topk_fused wire without error feedback
    # takes (tile 1024)
    "topk_mask": ("src/repro_torch/csrc/topk_mask.cu",
                  "src/repro/kernels/topk_mask.py:65", "topk_mask_pallas"),
    # the block route (tiles 1025 to 8192)
    "topk_mask_block": ("src/repro_torch/csrc/topk_mask.cu",
                        "src/repro/kernels/topk_mask.py:65",
                        "topk_mask_pallas"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sweep_input(torch, n: int, tile: int, dtype, device):
    """Gaussian values, an all-zero first tile (when there are two or more
    tiles) and exact-half rounding values in the last tile."""
    g = torch.Generator(device).manual_seed(n * 31 + tile)
    x = torch.randn(n, generator=g, device=device) * 3.0
    if n >= 2 * tile:
        x[:tile] = 0.0
    start = (n - 1) // tile * tile
    k = min(n - start, 64)
    if k >= 2:
        x[start] = 127.0
        x[start + 1:start + k] = torch.arange(1, k, device=device) - 32 + 0.5
    return x.to(dtype)


def same(torch, a, b) -> bool:
    """Equal shapes, types and values, with NaN equal to NaN at the same
    places (the payload bits of a NaN may differ between devices)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def max_err(torch, a, b) -> float:
    """max |a - b| over entries that are not NaN on both sides."""
    d = (a.double() - b.double()).abs()
    d = d[~(torch.isnan(a) & torch.isnan(b))]
    return float(d.max().item()) if d.numel() else 0.0


def ef_inputs(torch, n: int, seed: int, nan: bool, device):
    """g: Gaussian with an all-zero first tile and exact halves in the
    last (as sweep_input); e: a smaller Gaussian, zero on those tiles; a
    NaN in the second tile when ``nan``."""
    gen = torch.Generator(device).manual_seed(seed)
    g = sweep_input(torch, n, TILE, torch.float32, device)
    e = torch.randn(n, generator=gen, device=device) * 0.5
    if n >= 2 * TILE:
        e[:TILE] = 0.0
    e[(n - 1) // TILE * TILE:] = 0.0
    if nan:
        g[TILE + 5] = float("nan")
    return g, e


def _median_ms(torch, run, reps: int, inner: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def call_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Per-call time of ``inner`` back-to-back eager calls (median of
    ``reps``, CUDA events, after a warm-up): includes the host's launch
    cost whenever the host is slower than the device."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_ms(torch, run, reps, inner)


def events_ms(torch, fn, reps: int = 5) -> float:
    """Device time per call of a long-running call (milliseconds each, at
    the largest bucket): CUDA events around single eager calls, median of
    ``reps`` after a warm-up; the host's launch cost is hidden by the
    call's length."""
    fn()
    torch.cuda.synchronize()
    return _median_ms(torch, fn, reps, 1)


def loop_ms(torch, fn) -> float:
    """Device time per call of a call of a millisecond or more, whose host
    work (allocation, tensor maps, launches) would show in the time of a
    single eager call: CUDA events around 5 back-to-back calls, median of
    5 after a warm-up."""
    return call_ms(torch, fn, reps=5, inner=5)


_WARMUP_STREAM = []


def device_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed (median of ``reps``), so no host launch cost is counted.  The
    warm-up calls run on one side stream, made once: cuBLAS keeps a
    workspace for every stream that has run a matmul until the process
    ends, so a new stream per timing would leave one more workspace
    allocated in every later phase's peak."""
    if not _WARMUP_STREAM:
        _WARMUP_STREAM.append(torch.cuda.Stream())
    side = _WARMUP_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(torch, graph.replay, reps, inner)


def quantize_bound_ms(n: int, tile: int, in_bytes: int):
    """Least time for the quantize on the card: bytes moved (input read
    once, q and scales written once) over the HBM rate, or operations over
    the f32 rate, whichever is larger."""
    nbytes = n * in_bytes + n + 4 * (-(-n // tile))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * QUANT_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quantize_timing(torch, ref, quantize_tiles_cuda, n: int, tile: int):
    """Kernel, plain-version and bound times of quantize_tiles on n bf16
    values, in turns (plain, kernel, kernel, plain) within this call; the
    kernel through its wrapper, which allocates q and scales per call;
    10^8 elements and more with CUDA events around single calls, the rest
    in CUDA graphs."""
    x = torch.randn(n, device="cuda").to(torch.bfloat16)

    def kern():
        return quantize_tiles_cuda(x, tile)

    def plain():
        return ref.quantize_tiles_ref(x, tile=tile)
    timer = events_ms if n >= 1 << 26 else device_ms
    p0, k0 = timer(torch, plain), timer(torch, kern)
    k1, p1 = timer(torch, kern), timer(torch, plain)
    b_ms, by = quantize_bound_ms(n, tile, 2)
    out = {"n": n, "tile": tile, "dtype": "bfloat16",
           "ms": min(k0, k1), "plain_ms": min(p0, p1),
           "call_ms": call_ms(torch, kern),
           "plain_call_ms": call_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "timer": ("cuda events, eager" if timer is events_ms
                     else "cuda graph")}
    del x
    torch.cuda.empty_cache()
    return out


def phase_kernels(torch, ops, ref, quantize_tiles_cuda, path_shapes):
    """quantize_tiles against its plain version, bit-equal, over the sweep
    (QUANT_TILES, both routes) and every length the serving pools write,
    each launch on the route of its tile; then times at the path shapes
    (the warp route) and, at the gemma2-9b ring write's length, of the
    block route at tile 4096.  Returns (worst |kernel - plain|, warp-route
    timings, block-route timings)."""
    from repro_torch.kernels.dispatch import tile_route
    dev = torch.device("cuda")
    worst = 0.0
    cases = 0
    for tile in sorted(set(QUANT_TILES) | {t for _, t in
                                           path_shapes.values()}):
        route = tile_route(tile)
        sizes = {tile, 3 * tile + 17, 18 * 4 * 256, 18 * 128 * 256}
        sizes |= {n for n, t in path_shapes.values() if t == tile}
        for n in sorted(sizes):
            for dtype in (torch.float32, torch.bfloat16):
                for nan in ((False, True) if n >= 3 * tile else (False,)):
                    x = sweep_input(torch, n, tile, dtype, dev)
                    if nan:       # a NaN tile: NaN scale, int8 codes 0
                        x[tile + 3] = float("nan")
                    r0 = ops.route_counts()["quantize_tiles"][route]
                    qk, sk = ops.quantize_tiles(x, tile=tile)
                    qp, sp = ref.quantize_tiles_ref(x, tile=tile)
                    torch.cuda.synchronize()
                    if ops.route_counts()["quantize_tiles"][route] != r0 + 1:
                        fail(f"quantize_tiles at tile {tile} did not take "
                             f"the {route} route")
                    err = max(max_err(torch, qk, qp), max_err(torch, sk, sp))
                    worst = max(worst, err)
                    if not (same(torch, qk, qp) and same(torch, sk, sp)):
                        fail(f"quantize_tiles differs from the plain version "
                             f"at n={n} tile={tile} {dtype} nan={nan}: max "
                             f"err {err}")
                    cases += 1
                    if nan:
                        if not (torch.isnan(sk[1]) and
                                not qk[tile:2 * tile].any()):
                            fail("quantize_tiles: the NaN tile's scale is "
                                 "not NaN or its codes are not 0")
                        continue
                    deq = ops.dequantize(qk, sk, tile=tile)
                    # s/254 from rounding to nearest, plus f32 rounding of
                    # (x / s) * 127 and of q * (s / 127): a few ulp of s
                    srep = torch.repeat_interleave(sk, tile)[:n]
                    bound = srep / 254.0 + srep * 2.0 ** -20
                    if not (x.float() - deq).abs().le(bound).all():
                        fail(f"dequantize round trip beyond s/254 at n={n} "
                             f"tile={tile} {dtype}")
    print(f"kernels: quantize_tiles bit-equal to the plain version in "
          f"{cases} cases (tiles {QUANT_TILES} and the paths' "
          f"{sorted({t for _, t in path_shapes.values()})}: the warp route up to 1024, "
          f"the block route above; f32 and bf16, zero tiles, exact halves, "
          f"NaN tiles), each on its tile's route; dequantize within s/254",
          flush=True)
    timings = {name: quantize_timing(torch, ref, quantize_tiles_cuda, n,
                                     tile)
               for name, (n, tile) in path_shapes.items()}
    ring = "gemma2_9b_prefill_write_4096"
    block = {f"{ring}_tile4096": quantize_timing(
        torch, ref, quantize_tiles_cuda, path_shapes[ring][0], 4096)}
    return worst, timings, block


def quantize_path_shapes(cfg, slots: int, max_len: int,
                         page: int) -> dict:
    """{name: (n, tile)}: the flat lengths that the int8 pool of ``cfg``'s
    serving run (``slots`` x ``max_len``, pages of ``page``) hands
    ``quantize_tiles``, from the pool's own leaf layout.  An admission
    writes one slot's whole row of each paged leaf (repeats x length x KV
    x hd), a decode tick one entry per slot (repeats x slots x KV x hd);
    the tile is hd.  Leaves of equal lengths share a name."""
    leaves = paged_leaves_of(cfg, slots, max_len, page)
    lengths = sorted({m.length for _, m, _, _ in leaves})
    tag = cfg.name.replace("-", "_")
    out = {}
    for _, m, shape, _ in leaves:
        numel, tile = math.prod(shape), shape[-1]
        out[f"{tag}_decode_write"] = (numel // m.length, tile)
        name = f"{tag}_prefill_write"
        if len(lengths) > 1:
            name += f"_{m.length}"
        out[name] = (numel // slots, tile)
    return out


def paged_leaves_of(cfg, slots: int, max_len: int, page: int):
    """[(name, meta, spec shape, n_pages)] of every paged cache leaf of
    ``cfg``'s int8 pool at ``slots`` x ``max_len``, pages of ``page``."""
    from repro_torch._tree import tree_leaves, tree_map_with_path
    from repro_torch.models import Model
    from repro_torch.models.transformer import CacheLeafMeta
    from repro_torch.serve.kv_cache import PagedDecodeCache
    cache = PagedDecodeCache(Model(cfg), slots, max_len, page,
                             quantize="int8", build_pool=False)
    named = []
    tree_map_with_path(lambda path, s: named.append(
        ("_".join(map(str, path)), s.shape)), cache.specs)
    metas = tree_leaves(cache.meta,
                        is_leaf=lambda x: isinstance(x, CacheLeafMeta))
    return [(name, m, shape, cache.allocators[m.length].n_pages)
            for (name, shape), m in zip(named, metas) if m.kind == "paged"]


def pool_write_shapes(cfg, slots: int = SLOTS, max_len: int = MAX_LEN,
                      suffix: str = "") -> dict:
    """{name + suffix: (n, tile)}: every length ``cfg``'s int8 pool
    hands ``quantize_tiles`` in a run of ``slots`` x ``max_len`` (phase
    5's traffic by default), pages of PAGE, per paged leaf: an admission
    writes one slot's row (repeats x length x rest), a tick one entry per
    slot; the tile is the leaf's trailing dim (512 for MLA's c_kv, 64 for
    its k_rope, hd for K/V)."""
    tag = cfg.name.replace("-", "_")
    out = {}
    for name, m, shape, _ in paged_leaves_of(cfg, slots, max_len, PAGE):
        numel = math.prod(shape)
        out[f"{tag}_{name}_prefill_write{suffix}"] = (numel // slots,
                                                     shape[-1])
        out[f"{tag}_{name}_decode_write{suffix}"] = (numel // m.length,
                                                    shape[-1])
    return out


def attention_layers(cfg) -> int:
    """Layers of a decoder-only stack whose prefill runs flash (attention
    and MLA mixers)."""
    return sum(seg.repeats for seg in cfg.stack_plan()
               for s in seg.period if s.mixer in ("attn", "mla"))


def state_bytes_of(cfg, slots: int, max_len: int) -> int:
    """Bytes of the per-slot state leaves (the recurrent mixers' states)
    of ``cfg``'s serving pool at ``slots`` x ``max_len``."""
    from repro_torch._tree import tree_leaves
    from repro_torch.models import Model
    from repro_torch.models.transformer import CacheLeafMeta
    from repro_torch.serve.kv_cache import PagedDecodeCache
    cache = PagedDecodeCache(Model(cfg), slots, max_len, PAGE,
                             quantize="int8", build_pool=False)
    metas = tree_leaves(cache.meta,
                        is_leaf=lambda x: isinstance(x, CacheLeafMeta))
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s, m in zip(tree_leaves(cache.specs), metas)
               if m.kind == "state")


def phase_train_kernels(torch, ops, ref) -> dict:
    """The training wire's four kernels against their plain versions on
    the card, bit-equal (NaN for NaN) over the CPU tests' cases plus the
    largest bucket's length rounded to a ragged size; dequant_accum and
    the top-k kernels at tile 1024 and at BLOCK_TILE, each launch checked
    on the route of its tile.  Returns the worst |kernel - plain| per
    kernel (0.0 when every case is bit-equal)."""
    from repro_torch.kernels.dispatch import tile_route
    dev = torch.device("cuda")
    worst = {k: 0.0 for k in ("quantize_ef", "dequant_accum", "topk_ef",
                              "topk_mask")}
    cases = {k: 0 for k in worst}

    def check(name, got, want, what):
        err = max(max_err(torch, a, b) for a, b in zip(got, want))
        worst[name] = max(worst[name], err)
        cases[name] += 1
        if not all(same(torch, a, b) for a, b in zip(got, want)):
            fail(f"{name} differs from the plain version at {what}: max err "
                 f"{err}")

    def routed(name, tile, call):
        """``call()``, which must launch ``name`` once on tile's route."""
        route = tile_route(tile)
        r0 = ops.route_counts()[name][route]
        out = call()
        if ops.route_counts()[name][route] != r0 + 1:
            fail(f"{name} at tile {tile} did not take the {route} route")
        return out

    for n in EF_SIZES + (3 * 2**20 + 17,):
        for nan in ((False, True) if n >= 2 * TILE else (False,)):
            g, e = ef_inputs(torch, n, seed=n, nan=nan, device=dev)
            for decay in (1.0, 0.9):
                what = f"n={n} decay={decay} nan={nan}"
                got = ops.quantize_ef(g, e, decay=decay, tile=TILE)
                want = ref.quantize_ef_ref(g, e, decay=decay, tile=TILE)
                torch.cuda.synchronize()
                check("quantize_ef", got, want, what)
                for tile in (TILE, BLOCK_TILE):
                    q, _, sc = ref.quantize_ef_ref(g, e, decay=decay,
                                                   tile=tile)
                    for w in (1, 2, 4, 8):
                        qw = torch.stack([q.roll(r) for r in range(w)])
                        sw = torch.stack([sc * (1 + r) for r in range(w)])
                        got = (routed("dequant_accum", tile,
                                      lambda: ops.dequant_accum(
                                          qw, sw, tile=tile)),)
                        want = (ref.dequant_accum_ref(qw, sw, tile=tile),)
                        torch.cuda.synchronize()
                        check("dequant_accum", got, want,
                              f"{what} w={w} tile={tile}")
                for ratio in RATIOS:
                    for tile in (TILE, BLOCK_TILE):
                        got = routed("topk_ef", tile, lambda: ops.topk_ef(
                            g, e, ratio=ratio, tile=tile, iters=ITERS,
                            decay=decay))
                        want = ref.topk_ef_ref(g, e, ratio=ratio, tile=tile,
                                               iters=ITERS, decay=decay)
                        torch.cuda.synchronize()
                        check("topk_ef", got, want,
                              f"{what} ratio={ratio} tile={tile}")
            for ratio in RATIOS:
                for dtype in (torch.float32, torch.bfloat16):
                    for tile in (TILE, BLOCK_TILE):
                        x = g.to(dtype)
                        got = (routed("topk_mask", tile, lambda: ops.topk_mask(
                            x, ratio=ratio, tile=tile, iters=ITERS)),)
                        want = (ref.topk_mask_bisect_ref(
                            x, ratio=ratio, tile=tile, iters=ITERS),)
                        torch.cuda.synchronize()
                        check("topk_mask", got, want,
                              f"n={n} nan={nan} ratio={ratio} {dtype} "
                              f"tile={tile}")
    print(f"kernels: training wire bit-equal to the plain versions "
          f"(NaN for NaN) in {cases} cases (lengths {EF_SIZES} and "
          f"{3 * 2**20 + 17}, decays 1.0/0.9, ratios {RATIOS}, ranks "
          f"1/2/4/8, zero tiles, exact halves, NaN tiles, topk_mask f32 and "
          f"bf16; dequant_accum and top-k at tiles {TILE} and {BLOCK_TILE}: "
          f"their warp and block routes)", flush=True)
    return worst


def train_bucket_sizes(cfg):
    """Element counts of the training path's buckets (the 32 MiB fusion
    rule over gemma-2b's parameter leaves), in sync order."""
    from repro_torch.core.schedule.planner import form_bucket_indices
    from repro_torch.models import Model
    from repro_torch.models.layers import desc_leaves
    sizes = [math.prod(d.shape) for d in desc_leaves(Model(cfg).param_desc())]
    return [sum(sizes[i] for i in b)
            for b in form_bucket_indices([4 * s for s in sizes], 32 * 2**20)]


def bound(nbytes: float, ops_: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` at the HBM
    rate and doing ``ops_`` f32 operations at the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_path_kernels(torch, ops, ref, buckets, timed) -> dict:
    """The training-wire kernels at every bucket length of the training
    path, called through their wrappers as the path calls them:
    quantize_ef and topk_ef (ratio 0.01, decay 1.0) write the new residual
    into e's buffer, dequant_accum decodes one rank's quantize_ef payload
    (world 1), and quantize_tiles and topk_mask encode the same bucket
    without error feedback.  Each result is held bit-equal (NaN for NaN)
    to the plain version on the same inputs.  Then, at the lengths named
    in ``timed``, kernel, plain-version and bound times in turns (plain,
    kernel, kernel, plain): long calls with CUDA events, short ones by
    CUDA-graph replay; the routes at their tiles (1024: warp, BLOCK_TILE:
    block), dequant_accum also at 4 ranks and topk_mask also in bf16.
    Returns {kernel: {shape name: timing dict}}."""
    from repro_torch.kernels.quantize import quantize_tiles_cuda
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.kernels.topk_mask import topk_ef_cuda, topk_mask_cuda
    dev = torch.device("cuda")
    k = max(1, int(TILE * 0.01))
    k_block = max(1, int(BLOCK_TILE * 0.01))
    out = {name: {} for name in (
        "quantize_tiles", "quantize_ef", "dequant_accum",
        "dequant_accum_block", "topk_ef", "topk_ef_block", "topk_mask",
        "topk_mask_block")}
    shape_of = {n: name for name, n in timed.items()}

    def check(name, got, want, n):
        torch.cuda.synchronize()
        if not all(same(torch, a, b) for a, b in zip(got, want)):
            err = max(max_err(torch, a, b) for a, b in zip(got, want))
            fail(f"{name} differs from the plain version at the training "
                 f"path's bucket length n={n}: max err {err}")

    for n in sorted(set(buckets)):
        gen = torch.Generator(dev).manual_seed(n)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        want = ref.quantize_ef_ref(g, e, tile=TILE)
        got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
        check("quantize_ef", got, want, n)
        q1, s1 = got[0][None], got[2][None]
        del want, got
        check("dequant_accum", (ops.dequant_accum(q1, s1, tile=TILE),),
              (ref.dequant_accum_ref(q1, s1, tile=TILE),), n)
        buf.copy_(e)
        want = ref.topk_ef_ref(g, e, tile=TILE)
        got = ops.topk_ef(g, buf, tile=TILE, e_out=buf)
        check("topk_ef", got, want, n)
        del want, got
        check("quantize_tiles", ops.quantize_tiles(g, tile=TILE),
              ref.quantize_tiles_ref(g, tile=TILE), n)
        check("topk_mask", (ops.topk_mask(g, tile=TILE),),
              (ref.topk_mask_bisect_ref(g, tile=TILE),), n)
        shape = shape_of.get(n)
        if shape is None:
            del g, e, buf, q1, s1
            torch.cuda.empty_cache()
            continue
        nt, ntb = -(-n // TILE), -(-n // BLOCK_TILE)
        g16 = g.to(torch.bfloat16)
        q4 = q1.repeat(4, 1)
        s4 = torch.cat([s1 * (1 + r) for r in range(4)])
        qb, sb = quantize_tiles_cuda(g, BLOCK_TILE)
        q1b, s1b = qb[None], sb[None]
        q4b = q1b.repeat(4, 1)
        s4b = torch.cat([s1b * (1 + r) for r in range(4)])
        del qb, sb

        def accum_bound(w, ntiles):
            return bound(w * n + 4 * w * ntiles + 4 * n, 2 * w * n)

        # (kernel, shape, tile, dtype, kernel call, plain call, bound)
        cases = [
            ("quantize_tiles", shape, TILE, "float32",
             lambda: quantize_tiles_cuda(g, TILE),
             lambda: ref.quantize_tiles_ref(g, tile=TILE),
             bound(5 * n + 4 * nt, QUANT_OPS_PER_ELEMENT * n)),
            ("quantize_ef", shape, TILE, "float32",
             lambda: quantize_ef_cuda(g, buf, 1.0, TILE, buf),
             lambda: ref.quantize_ef_ref(g, e, tile=TILE),
             bound(13 * n + 4 * nt, QEF_OPS * n)),
            ("dequant_accum", shape, TILE, "float32",
             lambda: dequant_accum_cuda(q1, s1, TILE),
             lambda: ref.dequant_accum_ref(q1, s1, tile=TILE),
             accum_bound(1, nt)),
            ("dequant_accum", f"{shape}_w4", TILE, "float32",
             lambda: dequant_accum_cuda(q4, s4, TILE),
             lambda: ref.dequant_accum_ref(q4, s4, tile=TILE),
             accum_bound(4, nt)),
            ("dequant_accum_block", shape, BLOCK_TILE, "float32",
             lambda: dequant_accum_cuda(q1b, s1b, BLOCK_TILE),
             lambda: ref.dequant_accum_ref(q1b, s1b, tile=BLOCK_TILE),
             accum_bound(1, ntb)),
            ("dequant_accum_block", f"{shape}_w4", BLOCK_TILE, "float32",
             lambda: dequant_accum_cuda(q4b, s4b, BLOCK_TILE),
             lambda: ref.dequant_accum_ref(q4b, s4b, tile=BLOCK_TILE),
             accum_bound(4, ntb)),
            ("topk_ef", shape, TILE, "float32",
             lambda: topk_ef_cuda(g, buf, k, TILE, ITERS, 1.0, buf),
             lambda: ref.topk_ef_ref(g, e, tile=TILE),
             bound(16 * n, TOPK_OPS * n)),
            ("topk_ef_block", shape, BLOCK_TILE, "float32",
             lambda: topk_ef_cuda(g, buf, k_block, BLOCK_TILE, ITERS, 1.0,
                                  buf),
             lambda: ref.topk_ef_ref(g, e, tile=BLOCK_TILE),
             bound(16 * n, TOPK_OPS * n)),
        ]
        for x, suffix in ((g, ""), (g16, "_bf16")):
            nbytes = 2 * x.element_size() * n
            cases += [
                ("topk_mask", shape + suffix, TILE, str(x.dtype)[6:],
                 lambda x=x: topk_mask_cuda(x, k, TILE, ITERS),
                 lambda x=x: ref.topk_mask_bisect_ref(x, tile=TILE),
                 bound(nbytes, (1 + 2 * ITERS) * n)),
                ("topk_mask_block", shape + suffix, BLOCK_TILE,
                 str(x.dtype)[6:],
                 lambda x=x: topk_mask_cuda(x, k_block, BLOCK_TILE, ITERS),
                 lambda x=x: ref.topk_mask_bisect_ref(x, tile=BLOCK_TILE),
                 bound(nbytes, (1 + 2 * ITERS) * n))]
        big = n > 2**24
        timer = events_ms if big else device_ms
        for name, key, tile, dtype, kern, plain, (b_ms, by) in cases:
            p0, k0 = timer(torch, plain), timer(torch, kern)
            k1, p1 = timer(torch, kern), timer(torch, plain)
            out[name][key] = {
                "n": n, "dtype": dtype, "tile": tile,
                "ms": min(k0, k1), "plain_ms": min(p0, p1),
                "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                "timer": "cuda events, eager" if big else "cuda graph"}
            torch.cuda.synchronize()
        del g, e, buf, q1, s1, g16, q4, s4, q1b, s1b, q4b, s4b, cases
        torch.cuda.empty_cache()
    print(f"kernels: training wire bit-equal to the plain versions at every "
          f"bucket length of the training path {sorted(set(buckets))} "
          f"(residual written in place, dequant_accum at w=1, "
          f"quantize_tiles and topk_mask as the encode without error "
          f"feedback)", flush=True)
    return out


def bf16_ulp(torch, x):
    """The bfloat16 ulp at |x|, 2^(floor(log2 |x|) - 7), and 0 at 0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.exp2((e - 8).float()), 0.0)


def flash_close(torch, got, want):
    """(ok, max |got - want|, worst |got - want| / tolerance) of the flash
    kernel against its plain version, element by element.  f32: rtol =
    atol = 1e-5 (the same sums in another order).  bf16: 2 bf16 ulps of
    the element plus 2 of its row's largest magnitude (the row is one
    query and head over hd): p is rounded to bf16 at another running max,
    which moves an output by a few 2^-9 of the row's weighted |v|, and the
    output's own rounding can flip by an ulp."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf"), float("inf")
    if not bool(torch.isfinite(g).all()):
        return False, float("inf"), float("inf")
    d = (g - w).abs()
    if got.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        row = w.abs().amax(dim=-1, keepdim=True)
        tol = 2 * bf16_ulp(torch, w) + 2 * bf16_ulp(torch, row)
    share = torch.where(d > 0, d / tol, 0.0).max().item()
    return share <= 1.0, d.max().item(), share


def attention_pairs(T: int, S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head and batch row: the work the
    mask leaves (queries and keys at positions 0 … T-1 and 0 … S-1)."""
    qp = np.arange(T, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    if causal:
        hi = np.minimum(S - 1, qp)
    elif window:
        hi = np.minimum(S - 1, qp + window - 1)
    else:
        hi = np.full_like(qp, S - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(B, T, S, H, KV, hd, elt_bytes, kw):
    """(least time in ms, what bounds it, operations, bytes): q, k, v read
    once and out written once at the HBM rate, against 4·B·H·hd
    operations per unmasked pair (two products) at the bf16 tensor-core
    rate for bf16 inputs (their products are exact in f32) or the f32
    rate."""
    nbytes = elt_bytes * (2 * B * T * H * hd + 2 * B * S * KV * hd)
    n_ops = 4 * B * H * hd * attention_pairs(T, S, kw.get("causal", True),
                                             kw.get("window"))
    rate = BF16_OPS_PER_S if elt_bytes == 2 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, n_ops, nbytes


def flex_library(torch, q, k, v, window, softcap):
    """One PyTorch call computing the flash kernel's causal function with
    a logit softcap: ``flex_attention`` compiled by ``torch.compile``,
    with the softcap as its ``score_mod``, the causal (and window) mask as
    its block mask, and GQA.  Timed here only; the port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    T, S = q.shape[1], k.shape[1]

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi
        return keep if window is None else keep & (qi - ki < window)

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)
    mask = create_block_mask(mask_mod, None, None, T, S, device=q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    compiled = torch.compile(flex_attention, dynamic=False)

    def library():
        return compiled(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True).transpose(1, 2)
    return library


def flash_inputs(torch, B, T, S, H, KV, hd, dtype, seed):
    """Gaussian q (B, T, H, hd), k and v (B, S, KV, hd) on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, T, H, hd), (B, S, KV, hd),
                               (B, S, KV, hd)))


def nan_rule_check(torch, ops, ref, flash_cuda, tiles_cuda):
    """The NaN rule on the card, both routes (f32 and bf16 through the
    wrapper, and bf16 forced onto the SIMT kernel): v holds an inf, a NaN
    and a -inf at keys that query tiles skip; the kernel's NaN places must
    be the plain version's, and the rest within :func:`flash_close`.  The
    pre-pass is held bit-equal to its plain version on the same v.
    Returns the number of cases."""
    cases = 0
    for dtype, kernel in ((torch.float32, "simt"),
                          (torch.bfloat16, "wgmma"),
                          (torch.bfloat16, "simt")):
        for kw in ({"window": 64}, {}, {"causal": False, "window": 64},
                   {"window": 64, "softcap": 30.0}):
            q, k, v = flash_inputs(torch, 1, 330, 330, 4, 2, 64, dtype, 3)
            v[0, 0, 0, 1] = float("inf")       # skipped from row 128 on
            v[0, 250, 1, 5] = float("nan")     # skipped by rows < 192
            v[0, 70, 0, 7] = float("-inf")
            tiles = tiles_cuda(v)
            want_tiles = ref.nonfinite_tiles_ref(v)
            got = flash_cuda(q, k, v, tiles, kw.get("causal", True),
                             kw.get("window"), kw.get("softcap"), kernel)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            what = f"{dtype} {kernel} {kw}"
            if not torch.equal(tiles, want_tiles):
                fail(f"nonfinite_tiles differs from the plain version at "
                     f"{what}")
            nan, inf = torch.isnan(want), torch.isinf(want)
            if not (nan.any() and torch.equal(torch.isnan(got), nan)
                    and torch.equal(got[inf], want[inf])):
                fail(f"flash_attention NaN rule broken at {what}: "
                     f"{int(torch.isnan(got).sum())} NaN, plain "
                     f"{int(nan.sum())}")
            ok, err, share = flash_close(torch, got.masked_fill(nan | inf, 0),
                                         want.masked_fill(nan | inf, 0))
            if not ok:
                fail(f"flash_attention differs from the plain version off "
                     f"the non-finite places at {what}: max err {err}, "
                     f"{share:.3f} of the tolerance")
            cases += 1
    return cases


def time_turns(torch, timer, plain, kerns):
    """Plain and kernel times in turns (plain, kernels, kernels reversed,
    plain) within this call: (min plain ms, [min ms of each kernel])."""
    p0 = timer(torch, plain)
    first = [timer(torch, k) for k in kerns]
    second = [timer(torch, k) for k in reversed(kerns)][::-1]
    p1 = timer(torch, plain)
    return min(p0, p1), [min(a, b) for a, b in zip(first, second)]


# the SIMT flash kernel (bf16) at the gemma2-9b prefill when it was the only
# route, ms on an H100 80GB HBM3 at 700 W (PERF.md, kernel table): the wgmma
# route must be 5x faster
SIMT_RECORDED_MS = {"gemma2_9b_prefill_global": 17.812799,
                 "gemma2_9b_prefill_local": 14.631296}


def check_flash_gates(timings) -> None:
    """The wgmma route (pre-pass included) is no slower than the library
    call at every path shape that has one, and at least 5x faster than
    the SIMT kernel's recorded time at the gemma2-9b prefill."""
    for name, t in timings.items():
        lib = t["library_ms"]
        if lib is not None and t["ms"] > lib:
            fail(f"flash_attention wgmma at {name}: {t['ms']:.4f} ms, slower "
                 f"than the library call ({lib:.4f} ms)")
        if name in SIMT_RECORDED_MS and 5 * t["ms"] > SIMT_RECORDED_MS[name]:
            fail(f"flash_attention wgmma at {name}: {t['ms']:.4f} ms, not 5x "
                 f"faster than the SIMT kernel's recorded "
                 f"{SIMT_RECORDED_MS[name]} ms")
    print("flash gates: the wgmma route is no slower than the library call "
          "at " + ", ".join(f"{n} ({t['ms'] * 1e3:.3f} vs "
                            f"{t['library_ms'] * 1e3:.3f} us)"
                            for n, t in timings.items()
                            if t["library_ms"] is not None)
          + "; at least 5x faster than the SIMT kernel's recorded time at "
          + ", ".join(
              f"{n} ({SIMT_RECORDED_MS[n] / timings[n]['ms']:.2f}x)"
              for n in SIMT_RECORDED_MS), flush=True)


# the one-block-per-tile kernels at the shapes that the warp route now
# takes, when they were the only route, ms on an H100 80GB HBM3 at 700 W
# (PERF.md, kernel table): (recorded ms, the factor by which the warp
# route must be faster)
BLOCK_RECORDED_MS = {
    ("topk_ef", "largest_bucket"): (8.224832, 2.0),
    ("topk_mask", "largest_bucket"): (8.143840, 3.0),
    ("dequant_accum", "largest_bucket"): (1.802720, 1.4),
    ("quantize_tiles", "gemma2_9b_prefill_write_4096"): (1.186592, 3.0),
    ("quantize_tiles", "gemma2_9b_prefill_write_8192"): (2.311680, 3.0)}


def check_tile_gates(timings) -> None:
    """The warp routes of the tile kernels against the block kernels'
    recorded times (``BLOCK_RECORDED_MS``); ``timings`` maps kernel ->
    shape -> timing dict."""
    for (kernel, shape), (recorded, factor) in BLOCK_RECORDED_MS.items():
        ms = timings[kernel][shape]["ms"]
        if factor * ms > recorded:
            fail(f"{kernel} warp route at {shape}: {ms:.6f} ms, not "
                 f"{factor}x faster than the block kernel's recorded "
                 f"{recorded} ms")
    print("tile gates: the warp route is faster than the block kernel's "
          "recorded time by " + ", ".join(
              f"{recorded / timings[k][sh]['ms']:.2f}x (at least {f}x) for "
              f"{k} at {sh}"
              for (k, sh), (recorded, f) in BLOCK_RECORDED_MS.items()),
          flush=True)


def phase_flash(torch, ops, ref, flash_cuda, tiles_cuda):
    """The flash kernels against their plain version on the card, within
    :func:`flash_close`, over FLASH_SHAPES x f32/bf16 x FLASH_VARIANTS
    (bf16 takes the wgmma route, f32 the SIMT one), rows with no valid key
    in both, the NaN rule, and the path shapes in f32 and bf16; then times
    at the path shapes (bf16, in turns): the wgmma route through its
    wrapper call (pre-pass included), the SIMT kernel on the same inputs,
    the pre-pass alone, the plain version and the library call.  Returns
    (worst |kernel - plain|, {route: timings}, pre-pass timings)."""
    import torch.nn.functional as F
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = 0
    ops.reset_launch_counts()

    def check(q, k, v, kw, what):
        nonlocal cases
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, share = flash_close(torch, got, want)
        e0, s0 = worst[q.dtype]
        worst[q.dtype] = (max(e0, err), max(s0, share))
        cases += 1
        if not ok:
            fail(f"flash_attention differs from the plain version at {what}: "
                 f"max err {err}, {share:.3f} of the tolerance")
        return err, share

    for i, (B, T, H, KV, hd) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            for j, kw in enumerate(FLASH_VARIANTS):
                q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, dtype,
                                       100 * i + j)
                check(q, k, v, kw, f"{(B, T, H, KV, hd)} {dtype} {kw}")
    for dtype in (torch.float32, torch.bfloat16):   # rows with no key
        for causal in (True, False):
            kw = {"causal": causal, "window": 20}
            q, k, v = flash_inputs(torch, 1, 150, 40, 2, 1, 32, dtype, 7)
            check(q, k, v, kw, f"T=150 S=40 {dtype} {kw}")
    routes = ops.route_counts()["flash_attention"]
    n_bf16 = (len(FLASH_SHAPES) * len(FLASH_VARIANTS) + 2)
    if routes != {"wgmma": n_bf16, "simt": cases - n_bf16}:
        fail(f"flash routes {routes}: bf16 cases must take the wgmma "
             f"kernel ({n_bf16}) and f32 ones the SIMT kernel "
             f"({cases - n_bf16})")
    nan_cases = nan_rule_check(torch, ops, ref, flash_cuda, tiles_cuda)
    print(f"kernels: flash NaN rule held on both routes in {nan_cases} cases "
          f"(NaN exactly where the plain version has NaN; pre-pass "
          f"bit-equal)", flush=True)

    timings = {"wgmma": {}, "simt": {}}
    tiles_timings = {}
    for name, (B, T, H, KV, hd, kw) in FLASH_PATH_SHAPES.items():
        held = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, dtype, T + H)
            held[str(dtype).split(".")[-1]] = check(
                q, k, v, kw, f"the path shape {name} {dtype}")
        print(f"flash_attention {name} {[B, T, H, KV, hd]} {kw}: max |Δ| "
              f"{held['float32'][0]:.3e} in f32 ({held['float32'][1]:.4f} of "
              f"its tolerance), {held['bfloat16'][0]:.3e} in bf16 "
              f"({held['bfloat16'][1]:.4f} of its tolerance)", flush=True)
        causal, window = kw.get("causal", True), kw.get("window")
        softcap = kw.get("softcap")
        # q, k, v: the bf16 inputs, timed from here
        simt_ok = flash_close(torch, flash_cuda(q, k, v, tiles_cuda(v), causal,
                                                window, softcap, "simt"),
                              ref.flash_attention_ref(q, k, v, **kw))
        if not simt_ok[0]:
            fail(f"the SIMT kernel differs from the plain version at {name} "
                 f"bf16: max err {simt_ok[1]}")
        if not torch.equal(tiles_cuda(v), ref.nonfinite_tiles_ref(v)):
            fail(f"nonfinite_tiles differs from the plain version at {name}")

        def wgmma():          # the wrapper's call: pre-pass + kernel
            return flash_cuda(q, k, v, tiles_cuda(v), causal, window,
                              softcap, "wgmma")

        def simt():
            return flash_cuda(q, k, v, tiles_cuda(v), causal, window,
                              softcap, "simt")

        # the pre-pass reads a v that is not in L2, as after the prefill's
        # projections of other layers: 4 copies of v, one per launch in
        # turn (4 x 25 MB at gemma2-9b, twice the 50 MB L2)
        v_turns = [v.clone() for _ in range(4)]
        turn = [0]

        def tiles_only():
            turn[0] = (turn[0] + 1) % len(v_turns)
            return tiles_cuda(v_turns[turn[0]])

        def plain():
            return ref.flash_attention_ref(q, k, v, **kw)

        def tiles_plain():
            return ref.nonfinite_tiles_ref(v)
        if softcap is not None:      # every path shape is causal
            library = flex_library(torch, q, k, v, window, softcap)
            note = ("torch.compile(flex_attention)(score_mod=softcap, "
                    "block_mask=causal/window, enable_gqa=True)")
        elif window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal,
                    enable_gqa=True).transpose(1, 2)
            note = "F.scaled_dot_product_attention(is_causal, enable_gqa)"
        else:
            library, note = None, "n/a"
        timer = loop_ms if T > 1024 else device_ms
        plain_ms, (w_ms, s_ms) = time_turns(torch, timer, plain,
                                            [wgmma, simt])
        lib_ms = lib_err = None
        if library is not None:
            lib_ms = min(timer(torch, library), timer(torch, library))
            lib_err = (library().float() - plain().float()).abs().max().item()
        tiles_timer = device_ms
        sp_plain, (sp_ms,) = time_turns(torch, tiles_timer, tiles_plain,
                                        [tiles_only])
        b_ms, by, n_ops, nbytes = flash_bound(B, T, T, H, KV, hd, 2, kw)
        v_bytes = v.numel() * v.element_size()
        tiles_bytes = 4 * (-(-T // 64)) * B * KV * (1 + -(-hd // 32))
        sb_ms = (v_bytes + tiles_bytes) / HBM_BYTES_PER_S * 1e3
        tiles_timings[name] = {
            "shape": [B, T, KV, hd], "dtype": "bfloat16", "ms": sp_ms,
            "plain_ms": sp_plain, "bound_ms": sb_ms, "bound_by": "bytes",
            "library_ms": None, "timer": "cuda graph, v not in L2"}
        del v_turns
        for route, ms in (("wgmma", w_ms), ("simt", s_ms)):
            timings[route][name] = {
                "shape": [B, T, H, KV, hd], "dtype": "bfloat16", **kw,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "ops": n_ops, "bytes": nbytes,
                "tflops": n_ops / ms / 1e9, "library_ms": lib_ms,
                "library_note": note, "library_max_abs_err": lib_err,
                "max_abs_err_f32": held["float32"][0],
                "share_of_tolerance_f32": held["float32"][1],
                "max_abs_err_bf16": (held["bfloat16"][0] if route == "wgmma"
                                     else simt_ok[1]),
                "share_of_tolerance_bf16": (held["bfloat16"][1]
                                            if route == "wgmma"
                                            else simt_ok[2]),
                "includes_prepass": True,
                "timer": ("cuda events, 5 eager calls back to back"
                          if T > 1024 else "cuda graph")}
        del q, k, v, library
        torch.cuda.empty_cache()
    (e32, s32), (e16, s16) = worst[torch.float32], worst[torch.bfloat16]
    print(f"kernels: flash_attention within tolerance of the plain version "
          f"in {cases} cases (shapes {FLASH_SHAPES}, f32 (SIMT) and bf16 "
          f"(wgmma), variants {FLASH_VARIANTS}, rows with no valid key, the "
          f"path shapes {list(FLASH_PATH_SHAPES)} in f32 and bf16); worst "
          f"|Δ| {e32:.3e} in f32 ({s32:.4f} of the tolerance), {e16:.3e} in "
          f"bf16 ({s16:.4f} of the tolerance)", flush=True)
    return max(e32, e16), timings, tiles_timings


SMALL_REFS = {   # arch: (config overrides, prompt length, max_len)
    "gemma-2b": ({}, 16, 24),
    # G = 2 as in the full configs; gemma3-4b keeps two segments (2
    # repeats of its 6-layer period and a 4-layer tail, as the full 5 x 6
    # + 4); prompts longer than the reduced window (32)
    "gemma2-9b": ({"num_kv_heads": 2}, 40, 48),
    "gemma3-4b": ({"num_kv_heads": 2, "num_layers": 16}, 40, 48),
}


def phase_small_reference(torch, arch: str, refs=None):
    """A reduced config (``refs``, default ``SMALL_REFS``) in f32: the
    card's logits (prefill
    through the flash kernel) against the CPU path's (plain versions) on
    the same weights and tokens, for the prefill and four vector-position
    decode steps (max|Δ| <= 1e-4 · max|logit|; TF32 is off, so the
    difference is summation order only)."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    over, T, max_len = (SMALL_REFS if refs is None else refs)[arch]
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    params_gpu = tree_map(lambda t: t.to("cuda"), params)
    g = torch.Generator("cpu").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, T), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        logits, cache = model.prefill(p, {"tokens": tokens.to(dev)},
                                      max_len=max_len)
        seq = [logits.float().cpu()]
        for i in range(4):
            pos = torch.tensor([T + i, T - 3 + i], device=dev)
            logits, cache = model.decode_step(p, forced[i].to(dev), cache,
                                              pos)
            seq.append(logits.float().cpu())
        out[dev] = torch.stack(seq)
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    scale = out["cpu"].abs().max().item()
    if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4 * scale):
        fail(f"reduced {arch} on the card disagrees with the CPU path: "
             f"max|Δ|={err} vs 1e-4·{scale}")
    print(f"small reference: reduced {arch} f32 ({cfg.num_layers} layers, "
          f"window {cfg.window_size}, G {cfg.num_heads // cfg.num_kv_heads}"
          f", qk_norm {cfg.qk_norm}), prefill of {T} tokens + 4 vector-pos "
          f"decode steps, card vs CPU max|Δlogit|={err:.3e} "
          f"(max|logit|={scale:.3e})", flush=True)


def phase_small_train_reference(torch):
    """Reduced gemma-2b in f32, two int8_fused steps on the card against
    the port's CPU path from the same weights and data (TF32 is off, so
    the two differ by summation order only).  The step-1 loss must agree
    to 1e-5 relative and the step-2 loss to 1e-4 (an int8 code that flips
    between the devices moves a synced entry by s/127)."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    kw = dict(arch="gemma-2b", reduced=True, steps=2, batch=4, seq=64,
              lr=3e-3, warmup=1)
    out = {}
    for dev in ("cuda", "cpu"):
        # the card's session makes the default NCCL group; the CPU session
        # syncs over a gloo group of the same single rank
        group = dist.new_group(ranks=[0], backend="gloo") \
            if dev == "cpu" else None
        sess = TrainSession(SessionConfig(device=dev, **kw),
                            strategy=make_strategy(
                                "every_step", group=group,
                                sync=SyncConfig(compressor="int8_fused")),
                            params=params, group=group)
        losses = sess.run(2)
        out[dev] = (losses, [p.detach().float().cpu()
                             for p in tree_leaves(sess.params)])
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
    dparam = max((a - b).abs().max().item() for a, b in zip(pc, ph))
    if not (all(math.isfinite(x) for x in lc) and rel[0] <= 1e-5
            and rel[1] <= 1e-4):
        fail(f"reduced gemma-2b training on the card disagrees with the CPU "
             f"path: losses {lc} vs {lh}")
    print(f"small reference: reduced gemma-2b f32, 2 int8_fused steps, card "
          f"vs CPU: losses {lc} vs {lh} (max rel diff {max(rel):.3e}), max "
          f"|Δparam| {dparam:.3e}", flush=True)


# the training wire's kernels, by their names in the profiler's events
WIRE_KERNELS = ("quantize_ef_kernel", "quantize_tiles_warp_kernel",
                "quantize_tiles_block_kernel", "dequant_accum_warp_kernel",
                "dequant_accum_block_kernel", "topk_ef_warp_kernel",
                "topk_ef_block_kernel", "topk_mask_warp_kernel",
                "topk_mask_block_kernel")


def profile_step(torch, session, card, name: str, cpu: bool = True) -> dict:
    """One more training step under ``torch.profiler``: its wall time,
    device-busy share, the compression kernels' share of device time and
    the top device kernels.  ``cpu=False`` records the device's kernels
    only (a step of 10^5 launches and more, whose host events would take
    minutes to read back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        session.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {name}: the profiler recorded no device events "
              f"(device time not measured) [{card}]", flush=True)
        return {"wall_ms": wall * 1e3, "busy_share": None}
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    wire_us = sum(us for k, (us, _) in by_name.items()
                  if any(w in k for w in WIRE_KERNELS))
    res = {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
           "busy_share": busy_us / (wall * 1e6),
           "wire_kernel_ms": wire_us / 1e3,
           "wire_kernel_share": wire_us / busy_us,
           "device_launches": len(kernels)}
    print(f"profile {name} [{card}]: one step {wall * 1e3:.3f} ms profiled, "
          f"device busy {busy_us / 1e3:.3f} ms = {res['busy_share']:.4f} of "
          f"it, {len(kernels)} kernel launches; compression kernels "
          f"{wire_us / 1e3:.3f} ms = {res['wire_kernel_share']:.4f} of device "
          f"time", flush=True)
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / 1e3:9.3f} ms {n:5d} launches {kname[:100]}",
              flush=True)
    return res


def run_training(torch, ops, train, card, keep=None) -> dict:
    """The training path at full width, once per entry of TRAIN_RUNS, each
    with every kernel counter set to 0 just before and read just after;
    then one profiled step.  Each run's state is freed before the next;
    ``keep``, a dict, receives a host copy of the int8_fused run's final
    parameters (phase 12 compares the sharded run with them)."""
    from repro_torch._tree import tree_leaves
    results = {}
    for name, (flags, wire) in TRAIN_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        session = train.main(TRAIN_ARGS + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        if session.device.type != "cuda":
            fail(f"training {name} ran on {session.device}, not on the card")
        losses = list(session.losses)
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"training {name}: losses {losses}")
        n_buckets = (session.synchronizer.plan.n_buckets
                     if session.synchronizer is not None else 0)
        for kname, count in launches.items():
            want = n_buckets * TRAIN_STEPS if kname in wire else 0
            if count != want or (kname in wire and want <= 0):
                fail(f"training {name}: kernel {kname} launched {count} "
                     f"times, expected {want} (= {n_buckets} buckets x "
                     f"{TRAIN_STEPS} steps for the run's wire kernels, 0 for "
                     f"the others)")
        times = session.step_times
        step_ms = statistics.median(times[1:]) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        res = {"losses": losses, "step_ms": step_ms,
               "step_ms_all": [t * 1e3 for t in times],
               "tokens_per_s": tokens / (step_ms / 1e3),
               "peak_bytes": peak, "n_buckets": n_buckets,
               "launches": launches, "run_s": seconds,
               "params": session.num_params()}
        print(f"training {name} [{card}]: {session.model_cfg.name} "
              f"{res['params']} params bf16, batch {TRAIN_BATCH} x seq "
              f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, losses "
              f"{[round(x, 4) for x in losses]}; step time (median of steps "
              f"2-{TRAIN_STEPS}) {step_ms:.3f} ms, all steps "
              f"{[round(t, 1) for t in res['step_ms_all']]} ms; tokens/s "
              f"{res['tokens_per_s']:.1f}; peak memory "
              f"{peak / 2**30:.3f} GiB; {n_buckets} buckets; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if keep is not None and name == "int8_fused":
            keep[name] = [p.detach().cpu() for p in
                          tree_leaves(session.params)]
        res["profile"] = profile_step(torch, session, card, name)
        results[name] = res
        del session
        gc.collect()
        torch.cuda.empty_cache()
    return results


def path_counts(ops) -> dict:
    """Every wrapper's launch count, and per route of the wrappers that
    have routes (``flash_attention[wgmma]``, ``quantize_tiles[warp]``,
    ``topk_ef[block]``, ...)."""
    return {**ops.launch_counts(),
            **{f"{kernel}[{r}]": n
               for kernel, routes in ops.route_counts().items()
               for r, n in routes.items()}}


def check_main_path(torch, run, launches, card) -> None:
    """A serving run's results: every request complete with valid tokens,
    no page leaked, the quantize kernel launched once per paged leaf per
    admission and per decode tick, all on the warp route, the flash
    kernel and its pre-pass once per attention (or MLA) layer per
    admission (none for xlstm-125m, which has neither), every
    flash launch on the route ``route`` gives the model's dtype and head
    dim (``flash_route_of``: wgmma for every family, MLA's head dim 192
    included, none on the SIMT one), no training-wire kernel, finite
    full-width prefill logits."""
    eng, cfg = run.engines[0], run.cfg
    n_req, n_new = len(run.requests), run.requests[0].max_new
    if len(run.completions) != n_req:
        fail(f"{len(run.completions)} of {n_req} requests completed")
    for c in run.completions:
        # ids of the padded vocabulary: greedy decoding of random weights
        # may pick a padding row (xlstm-125m's 50304 pad to 50432), as the
        # reference's engine may
        valid = (c.tokens >= 0) & (c.tokens < cfg.padded_vocab)
        if len(c.tokens) != n_new or not valid.all():
            fail(f"request {c.rid}: bad tokens {c.tokens[:8]}...")
    eng.cache.check()
    live = sum(len(a.live_pages()) for a in eng.cache.allocators.values())
    if live:
        fail(f"{live} pages still live after draining")
    leaves = eng.cache.paged_leaves()
    n_attn = attention_layers(cfg)
    flash = n_attn * eng.prefills
    quant = leaves * (eng.prefills + eng.decode_ticks)
    fr = flash_route_of(cfg)
    expected = {"quantize_tiles": quant, "quantize_tiles[warp]": quant,
                "flash_attention": flash, "nonfinite_tiles": flash,
                f"flash_attention[{fr}]": flash}
    # a model with attention layers must launch them
    required = expected if n_attn else {}
    for name, n in launches.items():
        want = expected.get(name, 0)
        if n != want or (name in required and want <= 0):
            fail(f"{cfg.name} serving: kernel {name} launched {n} times, "
                 f"expected {want} (quantize_tiles = {leaves} paged leaves "
                 f"x ({eng.prefills} admissions + {eng.decode_ticks} decode "
                 f"ticks), all on the warp route, flash_attention and "
                 f"nonfinite_tiles = {n_attn} attention layers x "
                 f"{eng.prefills} admissions, all on the {fr} route, 0 on "
                 f"the block route, the other flash route and the training "
                 f"wire)")
    prompt = torch.as_tensor(run.requests[0].prompt, device=eng.device)
    logits, _ = run.model.prefill(run.params, {"tokens": prompt.long()[None]},
                                  max_len=eng.cfg.max_len)
    if tuple(logits.shape) != (1, 1, cfg.padded_vocab) or \
            not torch.isfinite(logits.float()).all():
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits.float()).all())}")
    s = run.summary
    print(f"main path: {cfg.name} d_model {cfg.d_model} x {cfg.num_layers} "
          f"layers, {cfg.param_dtype}, int8 paged KV, {n_req} requests, "
          f"{s['tokens']} tokens, {eng.prefills} admissions, "
          f"{eng.decode_ticks} decode ticks, quantize_tiles launches "
          f"{launches['quantize_tiles']} (= {leaves} x ({eng.prefills} + "
          f"{eng.decode_ticks}); warp route "
          f"{launches['quantize_tiles[warp]']}, block route "
          f"{launches['quantize_tiles[block]']}), flash_attention launches "
          f"{launches['flash_attention']} (= {n_attn} attention layers x "
          f"{eng.prefills}; wgmma route {launches['flash_attention[wgmma]']},"
          f" SIMT route {launches['flash_attention[simt]']}), nonfinite_tiles "
          f"{launches['nonfinite_tiles']}", flush=True)
    print(f"serving [{card}]: tokens/s={s['tokens_per_s']:.2f} "
          f"p50 per-token latency={s['p50_s'] * 1e3:.3f} ms "
          f"p99={s['p99_s'] * 1e3:.3f} ms mean TTFT="
          f"{s['mean_ttft_s'] * 1e3:.3f} ms makespan={s['makespan_s']:.3f} s "
          f"(serve run {run.seconds:.2f} s)", flush=True)


def compare_static(torch, run, card) -> None:
    """Information only: the share of tokens at temperature 0 that the
    unquantized engine shares with run_static and with generate (batch
    size and position-vector changes may move bf16 sums on the card), and
    that the int8 engine shares with the unquantized one."""
    from repro_torch.launch import serve
    from repro_torch.serve import Engine, run_static
    eng, reqs = run.engines[0], run.requests
    n_new = reqs[0].max_new
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              device=eng.device).long()
    eng_none = Engine(run.model, run.params,
                      dataclasses.replace(eng.cfg, quantize=None))
    cont = {c.rid: c.tokens for c in eng_none.run(reqs)}
    stat = {c.rid: c.tokens for c in run_static(
        run.model, run.params, reqs, eng.cfg.max_batch, eng.cfg.max_len)}
    gen = serve.generate(run.model, run.params, prompts, gen=n_new,
                         max_len=eng.cfg.max_len).cpu().numpy()
    q8 = {c.rid: c.tokens for c in run.completions}
    total = n_new * len(reqs)

    def share(other):
        return sum(int((cont[r.rid] == other[r.rid]).sum())
                   for r in reqs) / total
    # row 0's prefill logits alone (the engine's batch 1) and inside the
    # batch of all prompts (generate's batch): tokens can agree while the
    # bits differ, e.g. when random weights make greedy decoding repeat one
    # token
    one, _ = run.model.prefill(run.params, {"tokens": prompts[:1]},
                               max_len=eng.cfg.max_len)
    many, _ = run.model.prefill(run.params, {"tokens": prompts},
                                max_len=eng.cfg.max_len)
    dlog = (one[0].float() - many[0].float()).abs().max().item()
    distinct = len({int(t) for c in cont.values() for t in c})
    print(f"prefill logits of one prompt at batch 1 vs batch {len(reqs)}: "
          f"max|Δ|={dlog:.3e} (bit-equal: {dlog == 0.0}); {distinct} "
          f"distinct tokens in the unquantized engine's output", flush=True)
    print(f"bit-identity (information): unquantized engine vs run_static "
          f"{share(stat):.4f}, vs generate {share(gen):.4f}; int8 engine vs "
          f"unquantized engine {share(q8):.4f} of tokens equal [{card}]",
          flush=True)


def profile_ticks(torch, model, params, scfg, requests, card,
                  ticks: int = 10) -> dict:
    """Information only: where a decode tick's time goes.  Four requests
    are admitted into a fresh int8 engine, then ``ticks`` pure decode ticks
    are timed bare and again under ``torch.profiler``; prints the wall
    time per tick, the device-busy share and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine
    eng = Engine(model, params, scfg)
    for r in requests[:4]:
        eng.submit(r)
    for _ in range(4):                      # one admission per tick
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile: bare decode tick {bare * 1e3:.3f} ms; the profiler "
              f"recorded no device events (device time not measured) "
              f"[{card}]", flush=True)
        return {"tick_ms": bare * 1e3, "busy_share": None}
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    print(f"profile [{card}]: decode tick at batch 4 {bare * 1e3:.3f} ms "
          f"bare, {wall / ticks * 1e3:.3f} ms profiled; device busy "
          f"{busy_us / ticks / 1e3:.3f} ms per tick = "
          f"{busy_us / ticks / (bare * 1e6):.4f} of a bare tick, "
          f"{busy_us / (wall * 1e6):.4f} of a profiled one; "
          f"{len(kernels) / ticks:.1f} kernel launches per tick", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"  {us / ticks:9.2f} us/tick {n / ticks:6.1f} launches/tick "
              f"{name[:100]}", flush=True)
    return {"tick_ms": bare * 1e3, "busy_ms": busy_us / ticks / 1e3,
            "busy_share": busy_us / ticks / (bare * 1e6),
            "launches_per_tick": len(kernels) / ticks}


def run_gemma2_serving(torch, ops, serve, card) -> dict:
    """gemma2-9b served at full width (GEMMA2_SERVE_ARGS), with every
    kernel counter set to 0 just before and read just after, checked as
    the main path; then the prefill of one 6144-token admission timed
    alone (host clock around synchronised calls, median of 3) and a
    profile of five decode ticks.  Everything is freed before it
    returns."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(GEMMA2_SERVE_ARGS)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    check_main_path(torch, run, launches, card)
    peak = torch.cuda.max_memory_allocated()
    eng = run.engines[0]
    prompt = torch.as_tensor(run.requests[0].prompt,
                             device=eng.device).long()[None]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.model.prefill(run.params, {"tokens": prompt},
                          max_len=eng.cfg.max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"summary": run.summary, "seconds": run.seconds,
           "admissions": eng.prefills, "decode_ticks": eng.decode_ticks,
           "launches": launches, "peak_bytes": peak,
           "prefill_s": statistics.median(times), "prefill_s_all": times,
           "params": run.cfg.num_params()}
    print(f"gemma2-9b serving [{card}]: {res['params']} params bf16; "
          f"prefill of one {prompt.shape[1]}-token admission "
          f"{res['prefill_s'] * 1e3:.3f} ms (median of "
          f"{[round(t * 1e3, 1) for t in times]}); peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    model, params, scfg, reqs = run.model, run.params, eng.cfg, run.requests
    del run, eng
    gc.collect()
    torch.cuda.empty_cache()
    res["profile"] = profile_ticks(torch, model, params, scfg, reqs, card,
                                   ticks=5)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 9. the explicit collectives at world 4 on the one card
# ---------------------------------------------------------------------------

W4 = 4
W4_ROUNDS = 3
W4_SEED = 0
W4_SMALL = 10007    # the (2, 2) mesh's buffer: chunk rows off 16 bytes
W4_TIMEOUT_S = 600
RING_FUSED_STREAMS = 2   # ring_fused's encodes: streams x p per axis


def ring_fused_hops(n: int) -> list:
    """The chunk lengths ceil(part/p) at which ring_fused at world 4 hands
    quantize_tiles the rows of its (p, m) hop buffers, for a bucket of n
    (split into streams at round(n·i/streams), as ring_fused does)."""
    b = [round(n * i / RING_FUSED_STREAMS)
         for i in range(RING_FUSED_STREAMS + 1)]
    return sorted({-(-(hi - lo) // W4) for lo, hi in zip(b, b[1:]) if hi > lo})


def digest(torch, x):
    """Two order-free checksums of a tensor's bits (f32 or bf16; int64
    sums, wrapping, of the bits and of the bits times a position weight),
    so that ranks compare a 2.4 GB result without moving it."""
    bits = x.detach().reshape(-1).view({2: torch.int16,
                                        4: torch.int32}[x.element_size()])
    sums = torch.zeros(2, dtype=torch.int64, device=x.device)
    for off in range(0, bits.numel(), 1 << 24):
        b = bits[off:off + (1 << 24)].to(torch.int64)
        w = torch.arange(off, off + b.numel(), device=b.device) % 65521 + 1
        sums += torch.stack([b.sum(), (b * w).sum()])
    return sums.cpu()


def w4_gate(ok: bool, msg: str) -> None:
    if not ok:
        fail(f"world-4 phase, rank {os.environ.get('RANK', '?')}: {msg}")


def w4_launch_gate(counts, want: dict, what: str) -> None:
    """Every wrapper's count in ``counts`` (``path_counts``) equals
    ``want`` (0 where it names none)."""
    got = {k: v for k, v in counts.items() if v}
    w4_gate(got == {k: v for k, v in want.items() if v},
            f"{what}: launches {got}, expected {want}")


def world4_child(rank: int, world: int, store: str, out_dir: str,
                 sizes: dict) -> None:
    """One rank of the world-4 phase: a gloo group of 4 processes on the
    one card (NCCL refuses two ranks on one device), card tensors staged
    through pinned host memory for every transfer.  Writes its results to
    ``out_dir/rank<r>.json``; any failed gate exits non-zero."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import GradientSynchronizer, SyncConfig
    from repro_torch.core import PlanExecutor
    from repro_torch.core.collectives import ALGOS, all_gather, allreduce
    from repro_torch.core.collectives import p2p
    from repro_torch.core.schedule.planner import BucketPlan, CommPlan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quantize import quantize_tiles_cuda
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.launch.dist import init_group, mesh_axes
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=W4, rank=rank,
               store_path=store)
    dev = torch.device("cuda")
    res = {"rank": rank}

    def same_on_all_ranks(x) -> bool:
        """x's bits (its digest above 4M elements) equal on every rank."""
        mine = (x.reshape(-1).view(torch.int32) if x.numel() <= 1 << 22
                else digest(torch, x))
        rows = all_gather(mine)
        return all(torch.equal(rows[r], rows[0]) for r in range(W4))

    # -- 9.1 int8_fused with EF on ring_fused, the wire's real buckets -----
    first, largest = sizes["first"], sizes["largest"]
    plan = CommPlan(buckets=(
        BucketPlan(leaves=(1,), compressor="int8_fused", algo="ring_fused",
                   bucket_bytes=4 * first),
        BucketPlan(leaves=(0,), compressor="int8_fused", algo="ring_fused",
                   bucket_bytes=4 * largest)))
    ex = PlanExecutor(plan)
    gen = torch.Generator(dev).manual_seed(W4_SEED + rank)
    grads = {"a": torch.randn(largest, generator=gen, device=dev),
             "b": torch.randn(first, generator=gen, device=dev)}
    state = ex.init_state(grads)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    round_s = []
    for _ in range(W4_ROUNDS):
        t0 = time.perf_counter()
        synced, state = ex(grads, state)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        for k, v in synced.items():
            w4_gate(torch.isfinite(v).all().item(), f"ring_fused {k} "
                    f"not finite")
            w4_gate(same_on_all_ranks(v), f"ring_fused result {k} "
                    f"({v.numel()} f32) differs between ranks")
        del synced
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    per = len(plan.buckets) * W4_ROUNDS
    hops = RING_FUSED_STREAMS * W4 * per         # 2p per bucket and round
    w4_launch_gate(counts, {"quantize_ef": per, "quantize_tiles": hops,
                            "quantize_tiles[warp]": hops},
                   "int8_fused on ring_fused")
    peak = torch.cuda.max_memory_allocated()
    res["ring_fused"] = {"round_s": round_s, "staged_bytes": staged,
                         "launches": counts, "peak_bytes": peak,
                         "buckets": [first, largest]}

    # one more round under the profiler (rank 0 records; all take part)
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            synced, state = ex(grads, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res["profile"] = w4_breakdown(prof, wall)
    else:
        synced, state = ex(grads, state)
        torch.cuda.synchronize()
    del synced, state, grads, ex
    torch.cuda.empty_cache()

    # -- 9.2 the gather wire and the exact ring at the 9437184 bucket -------
    mid = sizes["mid"]
    gen = torch.Generator(dev).manual_seed(W4_SEED + 100 + rank)
    g2 = {"g": torch.randn(mid, generator=gen, device=dev)}
    wires = {"int8_fused_ring": ("int8_fused", {"quantize_ef": 1,
                                                "dequant_accum": 1,
                                                "dequant_accum[warp]": 1}),
             "topk_fused_ring": ("topk_fused", {"topk_ef": 1,
                                                "topk_ef[warp]": 1})}
    for name, (comp, want) in wires.items():
        cfg = SyncConfig(compressor=comp, algo="ring")
        card = GradientSynchronizer(cfg)
        st = card.init_state(g2)
        dist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, st = card(g2, st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = path_counts(ops)
        w4_launch_gate(counts, want, name)
        w4_gate(same_on_all_ranks(out["g"]), f"{name} differs between ranks")
        cpu = GradientSynchronizer(cfg)
        gc_ = {"g": g2["g"].cpu()}
        out_c, st_c = cpu(gc_, cpu.init_state(gc_))
        flips = int((out["g"].cpu() != out_c["g"]).sum())
        e_flips = int((st["error"][0].cpu() != st_c["error"][0]).sum())
        w4_gate(flips == 0 and e_flips == 0,
                f"{name}: the card differs from the same executor on the CPU "
                f"(gloo, plain versions) at {flips} synced entries and "
                f"{e_flips} residual entries")
        res[name] = {"seconds": secs, "launches": counts}
        if comp == "int8_fused":
            # dequant_accum at w = 4 on this bucket's gathered payloads,
            # timed on rank 0 while the others wait at the next barrier
            q, _, sc = quantize_ef_cuda(g2["g"], torch.zeros_like(g2["g"]),
                                        1.0, TILE, None)
            qg, sg = all_gather(q), all_gather(sc)
            if rank == 0:
                w4_gate(same(torch, dequant_accum_cuda(qg, sg, TILE),
                             ref.dequant_accum_ref(qg, sg, tile=TILE)),
                        f"dequant_accum at w = {W4}, n={mid} differs from "
                        f"the plain version")
                res["dequant_accum_w4"] = w4_time(
                    torch, lambda: dequant_accum_cuda(qg, sg, TILE),
                    lambda: ref.dequant_accum_ref(qg, sg), mid,
                    bound(W4 * mid + 4 * W4 * -(-mid // TILE) + 4 * mid,
                          2 * W4 * mid))
            del q, sc, qg, sg
        del out, st, out_c, st_c
    del g2
    torch.cuda.empty_cache()

    # -- 9.3 every algorithm on a (2, 2) mesh ------------------------------
    axes = mesh_axes((2, 2))
    gen = torch.Generator(dev).manual_seed(W4_SEED + 200 + rank)
    x = torch.randn(W4_SMALL, generator=gen, device=dev)
    exact = all_gather(x.double()).sum(0).cpu()
    res["algos"] = {}
    for algo in ALGOS:
        dist.barrier()
        ops.reset_launch_counts()
        got = allreduce(x.clone(), algo, axes)
        torch.cuda.synchronize()
        counts = path_counts(ops)
        # ring_fused: streams x p encodes on each of the 2 axes of size 2
        n_q = 2 * RING_FUSED_STREAMS * 2 if algo == "ring_fused" else 0
        w4_launch_gate(counts, {"quantize_tiles": n_q,
                                "quantize_tiles[warp]": n_q}, algo)
        want = allreduce(x.cpu(), algo, axes)
        w4_gate(torch.equal(got.cpu().view(torch.int32),
                            want.view(torch.int32)),
                f"{algo} on the (2, 2) mesh: the card differs from the same "
                f"schedule on the CPU (plain versions)")
        w4_gate(same_on_all_ranks(got), f"{algo} differs between ranks")
        err = float((got.cpu().double() - exact).abs().max())
        # the reference's check_collectives: ring_fused within 5% of the
        # largest sum, the exact schedules within 1e-4
        limit = (0.05 * float(exact.abs().max()) if algo == "ring_fused"
                 else 1e-4)
        w4_gate(err <= limit, f"{algo}: max |error| {err} > {limit}")
        res["algos"][algo] = {"max_abs_err": err, "launches": counts}

    # -- 9.4 quantize_tiles at the ring_fused hops' lengths (rank 0) -------
    # 9.1 holds the ranks to each other only, so here every row of a
    # (p, m) hop buffer, at each bucket's chunk length m, is held bit-equal
    # to the plain version on the same row; then the largest hop is timed
    if rank == 0:
        for n_bucket in (first, largest):
            for m in ring_fused_hops(n_bucket):
                a = torch.randn(W4, m, generator=gen, device=dev)
                for r in range(W4):
                    got = quantize_tiles_cuda(a[r], TILE)
                    want = ref.quantize_tiles_ref(a[r], tile=TILE)
                    w4_gate(all(same(torch, g_, w_)
                                for g_, w_ in zip(got, want)),
                            f"quantize_tiles on row {r} of the ({W4}, {m}) "
                            f"ring_fused hop buffer of the {n_bucket} bucket "
                            f"differs from the plain version")
                    del got, want
        # a is now the largest bucket's hop buffer: time one of its rows
        m = a.shape[1]
        xh = a[1]
        res["quantize_tiles_hop"] = w4_time(
            torch, lambda: quantize_tiles_cuda(xh, TILE),
            lambda: ref.quantize_tiles_ref(xh, tile=TILE), m,
            bound(5 * m + 4 * -(-m // TILE), QUANT_OPS_PER_ELEMENT * m))
        del a, xh
        torch.cuda.empty_cache()
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def w4_time(torch, kern, plain, n, bound_) -> dict:
    """Kernel and plain-version device times in turns (plain, kernel,
    kernel, plain), by CUDA-graph replay: the calls last 0.1-0.2 ms, so
    CUDA events around eager calls would count the host's launch work."""
    p0, k0 = device_ms(torch, plain), device_ms(torch, kern)
    k1, p1 = device_ms(torch, kern), device_ms(torch, plain)
    return {"n": n, "tile": TILE, "dtype": "float32", "ms": min(k0, k1),
            "plain_ms": min(p0, p1), "bound_ms": bound_[0],
            "bound_by": bound_[1], "library_ms": None,
            "timer": "cuda graph"}


def w4_breakdown(prof, wall: float) -> dict:
    """One profiled ring_fused round on rank 0, split by device time:
    the port's kernels, the host staging copies (memcpy to and from
    pinned memory), the plain PyTorch ops (dequantize, add, pad, cast,
    division); the rest of the wall time is the host (gloo transfers,
    Python, launches)."""
    from torch.autograd import DeviceType
    split = {"kernels_ms": 0.0, "staging_copies_ms": 0.0, "plain_ops_ms": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in WIRE_KERNELS):
            split["kernels_ms"] += ms
        elif "Memcpy" in e.name or "memcpy" in e.name:
            split["staging_copies_ms"] += ms
        else:
            split["plain_ops_ms"] += ms
    busy = sum(split.values())
    return {**split, "device_events": n, "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "host_ms": wall * 1e3 - busy}


def phase_world4(torch, card, sizes: dict) -> dict:
    """Four spawned ranks on the one card (``world4_child``, through
    ``launch/dist.py:spawn``); every library is built already (phase 2),
    so no rank runs ``nvcc``.  A rank that fails fails the run; the others
    are stopped."""
    import shutil
    from repro_torch.launch.dist import spawn
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "world4"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        spawn(world4_child, W4, args=(str(out_dir), sizes),
              timeout=W4_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"world-4 phase: {e}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(W4)]
    for name in ("ring_fused", "int8_fused_ring", "topk_fused_ring"):
        if any(r[name]["launches"] != ranks[0][name]["launches"]
               for r in ranks):
            fail(f"world-4 phase {name}: ranks launched differently")
    r0 = ranks[0]
    rf = r0["ring_fused"]
    print(f"world 4 on one card over gloo [{card}]: int8_fused with EF on "
          f"ring_fused, buckets {rf['buckets']}, {W4_ROUNDS} rounds: "
          f"seconds per round by rank "
          f"{[[round(s, 4) for s in r['ring_fused']['round_s']] for r in ranks]}"
          f"; staged bytes per rank {[r['ring_fused']['staged_bytes'] for r in ranks]}"
          f"; peak memory per rank "
          f"{[round(r['ring_fused']['peak_bytes'] / 2**30, 3) for r in ranks]}"
          f" GiB; launches {dict((k, v) for k, v in rf['launches'].items() if v)}"
          f"; all ranks bit-equal", flush=True)
    pr = r0["profile"]
    print(f"world 4 ring_fused round profiled on rank 0 [{card}]: wall "
          f"{pr['wall_ms']:.3f} ms; device busy {pr['device_busy_ms']:.3f} ms"
          f" = kernels {pr['kernels_ms']:.3f} + plain ops (dequantize, add, "
          f"pad, cast, divide) {pr['plain_ops_ms']:.3f} + staging copies "
          f"{pr['staging_copies_ms']:.3f}; host (gloo transfers, Python) "
          f"{pr['host_ms']:.3f} ms", flush=True)
    for name in ("int8_fused_ring", "topk_fused_ring"):
        r = r0[name]
        print(f"world 4 {name} at the {sizes['mid']} bucket [{card}]: "
              f"{r['seconds'] * 1e3:.3f} ms on rank 0, bit-equal across "
              f"ranks and to the CPU executor (gloo, plain versions); "
              f"launches {dict((k, v) for k, v in r['launches'].items() if v)}",
              flush=True)
    print(f"world 4 on a (2, 2) mesh at n={W4_SMALL}: "
          f"{ {a: r['max_abs_err'] for a, r in r0['algos'].items()} } max "
          f"|error| to the exact sum; each bit-equal across ranks and to "
          f"its CPU schedule", flush=True)
    for key in ("quantize_tiles_hop", "dequant_accum_w4"):
        t = r0[key]
        print(f"world 4 {key} n={t['n']} tile={t['tile']} f32: device time "
              f"kernel {t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f}"
              f" us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.3f} of the bound ({t['timer']}); "
              f"bit-equal to the plain version [{card}]", flush=True)
    return r0


# ---------------------------------------------------------------------------
# 10. the rounds axis: local SGD, LAG and push/pull
# ---------------------------------------------------------------------------

ROUNDS_STEPS = 4
ROUNDS_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
               "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
               "--steps", str(ROUNDS_STEPS), "--seed", "0",
               "--log-every", "1"]
INT8_WIRE = ("quantize_ef", "dequant_accum", "dequant_accum[warp]")
ROUNDS_RUNS = {   # run name: (extra CLI flags, the wire's kernels per
    #               bucket, the rounds that run the wire)
    "local_sgd": (["--local-sgd", "2", "--sync", "comm", "--compressor",
                   "int8_fused"], INT8_WIRE, "param"),
    "lag": (["--lag", "4", "--sync", "comm", "--compressor", "int8_fused"],
            INT8_WIRE, "grad"),
    "push_pull": (["--push-pull", "2", "2", "--sync", "comm", "--compressor",
                   "topk_fused"], ("topk_ef", "topk_ef[warp]"), "grad"),
}
# (grad, param, control) rounds of 4 steps; LAG's are data-dependent
ROUNDS_EXPECT = {"local_sgd": (0, 2, 0), "push_pull": (2, 2, 0)}
# bytes held per parameter by the local-SGD run at its round: bf16 params
# (2), Adam's f32 moments (8), the f32 anchor (4) and parameter EF (4), the
# f32 delta (4) and its reduction (4)
LOCAL_SGD_BYTES_PER_PARAM = 26
W4_ROUNDS_SESSION = dict(arch="gemma-2b", layers=1, steps=ROUNDS_STEPS,
                         batch=4, seq=128, optimizer="sgd", lr=3e-3,
                         warmup=1, seed=0)


def round_step(session) -> bool:
    """Whether the session's next step runs a parameter round (local SGD
    and push/pull decide without a probe)."""
    sched = session.strategy.scheduler
    action, _ = sched.round(session.step, session._sched_state)
    return action.param_round


def profile_round(torch, session, card, name: str) -> dict:
    """One more step that holds a round (local SGD and push/pull: the next
    step with a parameter round, the steps before it run unprofiled; LAG:
    the next step, probe included) under ``torch.profiler``: its wall time
    split into the wire kernels, the other device work (the model, Adam,
    casts, packing, the probe's sums: plain ops) and the host; with the
    parameter round's own wall time where the step holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if session.strategy.scheduler.has_param_rounds:
        while not round_step(session):
            session.step_once()
    round_ms = []
    if session.strategy.scheduler.has_param_rounds:
        inner = session._param_round

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t) * 1e3)
            return out
        session._param_round = timed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        session.step_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if round_ms:
        session._param_round = inner
    wire = other = 0.0
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        ms = e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in WIRE_KERNELS):
            wire += ms
        else:
            other += ms
    res = {"wall_ms": wall * 1e3, "wire_kernels_ms": wire,
           "plain_ops_ms": other, "device_events": n,
           "host_ms": wall * 1e3 - wire - other,
           "param_round_ms": round_ms[0] if round_ms else None}
    what = ("parameter round" if round_ms else "probe and its round"
            if session.strategy.scheduler.needs_grad_probe
            else "gradient sync")
    print(f"profile rounds {name} [{card}]: one step with a {what} "
          f"{res['wall_ms']:.3f} ms = wire kernels {wire:.3f} + other device "
          f"work (model, Adam, casts, packing) {other:.3f} + host "
          f"{res['host_ms']:.3f} ms ({n} device events)"
          + (f"; its parameter round {round_ms[0]:.3f} ms" if round_ms
             else ""), flush=True)
    return res


def run_rounds(torch, ops, train, card) -> dict:
    """Phase 10 (a): the three schedulers at full width through the CLI,
    each with every kernel counter set to 0 just before and read just
    after: the wire's kernels launch once per bucket per ROUND that runs
    the wire (parameter rounds for local SGD, gradient syncs for LAG and
    push/pull), the rest 0."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    free, total = torch.cuda.mem_get_info()
    params = sum(math.prod(d.shape) for d in
                 tree_leaves(Model(get_config("gemma-2b")).param_desc()))
    need = LOCAL_SGD_BYTES_PER_PARAM * params
    print(f"rounds memory reckoning [{card}]: local SGD with int8_fused "
          f"rounds holds {LOCAL_SGD_BYTES_PER_PARAM} B per parameter at its "
          f"round = {need / 2**30:.2f} GiB for {params} parameters; the card "
          f"has {free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB",
          flush=True)
    if need > free:
        fail(f"the local-SGD run needs ~{need / 2**30:.2f} GiB, the card has "
             f"{free / 2**30:.2f} GiB free")
    results = {}
    for name, (flags, wire, carrier) in ROUNDS_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        session = train.main(ROUNDS_ARGS + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_counts(ops)
        peak = torch.cuda.max_memory_allocated()
        if session.device.type != "cuda":
            fail(f"rounds {name} ran on {session.device}, not on the card")
        losses = list(session.losses)
        if len(losses) != ROUNDS_STEPS or not all(map(math.isfinite, losses)):
            fail(f"rounds {name}: losses {losses}")
        split = (session.grad_rounds, session.param_rounds,
                 session.control_rounds)
        if name in ROUNDS_EXPECT and split != ROUNDS_EXPECT[name]:
            fail(f"rounds {name}: (grad, param, control) rounds {split}, "
                 f"expected {ROUNDS_EXPECT[name]}")
        if name == "lag" and not (split[1] == 0
                                  and split[2] == ROUNDS_STEPS
                                  and 1 <= split[0] < ROUNDS_STEPS):
            fail(f"rounds lag: (grad, param, control) rounds {split}: "
                 f"needs a probe every step and both a sync and a reuse")
        reducer = (session.synchronizer if carrier == "grad"
                   else session.strategy.param_reducer)
        n_buckets = reducer.plan.n_buckets
        rounds = split[0] if carrier == "grad" else split[1]
        for kname, count in launches.items():
            want = n_buckets * rounds if kname in wire else 0
            if count != want or (kname in wire and want <= 0):
                fail(f"rounds {name}: kernel {kname} launched {count} "
                     f"times, expected {want} (= {n_buckets} buckets x "
                     f"{rounds} {carrier} rounds for the wire's kernels, 0 "
                     f"for the others)")
        times = [t * 1e3 for t in session.step_times]
        res = {"losses": losses, "step_ms_all": times,
               "step_ms": statistics.median(times[1:]),
               "grad_rounds": split[0], "param_rounds": split[1],
               "control_rounds": split[2], "comm_rounds":
               session.comm_rounds, "peak_bytes": peak,
               "n_buckets": n_buckets, "launches": launches,
               "run_s": seconds}
        print(f"rounds {name} [{card}]: {session.model_cfg.name} bf16, batch "
              f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {ROUNDS_STEPS} steps, "
              f"losses {[round(x, 4) for x in losses]}; step times "
              f"{[round(t, 1) for t in times]} ms (median of steps 2-"
              f"{ROUNDS_STEPS} {res['step_ms']:.3f}); comm rounds "
              f"{session.comm_rounds} = grad {split[0]} + param {split[1]}, "
              f"control {split[2]}; peak memory {peak / 2**30:.3f} GiB; "
              f"{n_buckets} buckets; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        res["profile"] = profile_round(torch, session, card, name)
        results[name] = res
        del session, reducer
        gc.collect()
        torch.cuda.empty_cache()
    return results


def phase_small_rounds_reference(torch, card) -> dict:
    """Phase 10 (b), reduced gemma-2b in f32: four local-SGD steps with
    int8_fused parameter rounds and four LAG steps with the int8_fused
    wire, on the card and on the port's CPU path (plain versions, a gloo
    group of the one rank), from the same weights and data: the same
    round counts, gated on both devices as in (a), step-1 losses within
    1e-5 and the others within 1e-4 relative (phase 4's training
    tolerance).  LAG's θ = 4 gives a sync and then reuse steps: at this
    size ||g - g_last||² / ||g||² stays near 1.6-2.1 after the first
    step (the CPU path's probes), so θ = 0.5 would sync on every step and
    never run the reuse program.  Then a checkpoint on the
    card: 2 steps, save, load into a fresh session, 2 more steps — losses
    and parameters bit-equal to an uninterrupted 4-step run; and the
    card's checkpoint loads on the CPU bit for bit."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    kw = dict(arch="gemma-2b", reduced=True, steps=ROUNDS_STEPS, batch=4,
              seq=64, lr=3e-3, warmup=1)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    sync = SyncConfig(compressor="int8_fused")
    out = {}
    for name, skw in (("local_sgd", dict(period=2)),
                      ("lag", dict(threshold=4.0))):
        runs = {}
        for dev in ("cuda", "cpu"):
            group = gloo if dev == "cpu" else None
            sess = TrainSession(SessionConfig(device=dev, **kw),
                                strategy=make_strategy(name, group=group,
                                                       sync=sync, **skw),
                                params=params, group=group)
            losses = sess.run(ROUNDS_STEPS)
            runs[dev] = (losses, (sess.grad_rounds, sess.param_rounds,
                                  sess.control_rounds))
        (lc, rc), (lh, rh) = runs["cuda"], runs["cpu"]
        for split in (rc, rh):
            grad, param, control = split
            if name == "local_sgd" and split != ROUNDS_EXPECT[name]:
                fail(f"reduced gemma-2b local_sgd: (grad, param, control) "
                     f"rounds {split}, expected {ROUNDS_EXPECT[name]}")
            if name == "lag" and not (param == 0 and control == ROUNDS_STEPS
                                      and 1 <= grad < ROUNDS_STEPS):
                fail(f"reduced gemma-2b lag: (grad, param, control) rounds "
                     f"{split}: needs a probe every step and both a sync "
                     f"and a reuse")
        rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
        if rc != rh or not (all(map(math.isfinite, lc)) and rel[0] <= 1e-5
                            and max(rel) <= 1e-4):
            fail(f"reduced gemma-2b {name} on the card disagrees with the CPU"
                 f" path: losses {lc} vs {lh}, rounds {rc} vs {rh}")
        print(f"small reference rounds [{card}]: reduced gemma-2b f32, "
              f"{ROUNDS_STEPS} {name} steps ({skw}, int8_fused), card vs "
              f"CPU: losses "
              f"{lc} vs {lh} (max rel diff {max(rel):.3e}); (grad, param, "
              f"control) rounds {rc} on both", flush=True)
        out[name] = {"losses_card": lc, "losses_cpu": lh,
                     "max_rel_diff": max(rel), "rounds": rc}

    # the checkpoint: vanilla Adam on the card, resumed mid-run
    ckpt = str(ROOT / "build" / "rounds_checkpoint" / "ck")

    def card_session():
        return TrainSession(SessionConfig(device="cuda", **kw), params=params)

    whole = card_session()
    whole.run(ROUNDS_STEPS)
    first = card_session()
    first.run(2)
    first.save_checkpoint(ckpt)
    resumed = card_session()
    if resumed.load_checkpoint(ckpt) != 2:
        fail("checkpoint: the resumed session is not at step 2")
    later = resumed.run(ROUNDS_STEPS - 2)
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(resumed.params),
                          tree_leaves(whole.params)))
    if first.losses + later != whole.losses or not same_params:
        fail(f"checkpoint: resumed losses {first.losses + later} vs "
             f"uninterrupted {whole.losses}, parameters bit-equal "
             f"{same_params}")
    host = TrainSession(SessionConfig(device="cpu", **kw), group=gloo)
    host.load_checkpoint(ckpt)
    on_cpu = all(torch.equal(a, b.cpu()) for a, b in
                 zip(tree_leaves(host.params), tree_leaves(first.params)))
    if not on_cpu:
        fail("checkpoint: the card's checkpoint restores differently on the "
             "CPU")
    print(f"checkpoint [{card}]: reduced gemma-2b, 2 steps + save + load + "
          f"2 steps on the card = the uninterrupted 4-step run bit for bit "
          f"(losses {whole.losses}); the card's checkpoint restores on the "
          f"CPU bit for bit", flush=True)
    out["checkpoint"] = {"losses": whole.losses, "bit_equal": True,
                         "cpu_restore_bit_equal": True}
    return out


def params_digest(torch, params):
    """(leaves, 2) int64: ``digest`` of every leaf."""
    from repro_torch._tree import tree_leaves
    return torch.stack([digest(torch, p) for p in tree_leaves(params)])


def watch_param_rounds(torch, sess) -> list:
    """Wrap the built session's parameter round so that each round appends
    (digest of the parameters before it, after it, its seconds) to the
    returned list."""
    inner = sess._param_round
    rounds = []

    def watched(params, anchor, red_state, rng):
        pre = params_digest(torch, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(params, anchor, red_state, rng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rounds.append((pre, params_digest(torch, out[0]), secs))
        return out

    sess._param_round = watched
    return rounds


def gate_rounds_differ_then_agree(torch, rounds, world: int) -> None:
    """Before each round the ranks' parameters differ; after it they are
    bit-equal (digests gathered over the default group)."""
    from repro_torch.core.collectives import all_gather
    for i, (pre, post, _) in enumerate(rounds):
        pres, posts = all_gather(pre), all_gather(post)
        w4_gate(not all(torch.equal(pres[r], pres[0]) for r in range(world)),
                f"round {i}: the ranks' parameters are equal before it")
        w4_gate(all(torch.equal(posts[r], posts[0]) for r in range(world)),
                f"round {i}: the ranks' parameters differ after it")


def spawn_world4(torch, child, name: str, args: tuple,
                 world: int = 4) -> list:
    """``world`` (default four) spawned ranks of ``child`` on the one card
    (``launch/dist.py:spawn``), each writing ``rank{r}.json`` under
    ``build/<name>``; a rank that fails fails the run, and so do ranks
    whose launch counts differ.  The ranks share the card's memory, so
    their allocators map segments on demand (expandable segments) rather
    than keep fragments reserved.  Returns (ranks' results, seconds)."""
    import shutil
    from repro_torch.launch.dist import spawn
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn(child, world, args=(str(out_dir), *args),
              timeout=W4_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"{name} phase: {e}")
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    if any(r["launches"] != ranks[0]["launches"] for r in ranks):
        fail(f"{name} phase: ranks launched differently")
    return ranks, seconds


def rounds_w4_child(rank: int, world: int, store: str, out_dir: str) -> None:
    """Phase 10 (c), one rank: gemma-2b at full width with 1 layer, SGD,
    local SGD τ = 2 with int8_fused parameter rounds on psum (the gather
    wire: dequant_accum at w = 4), a gloo group of 4 processes on the one
    card.  Before each round the ranks' parameters differ, after it they
    are bit-equal (digests of the bits, gathered); quantize_ef and
    dequant_accum launch once per delta bucket per round."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.core.collectives import p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    sess = TrainSession(
        SessionConfig(device="cuda", **W4_ROUNDS_SESSION),
        strategy=make_strategy("local_sgd", group=group, period=2,
                               sync=SyncConfig(compressor="int8_fused")),
        group=group)
    sess._build()
    rounds = watch_param_rounds(torch, sess)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    losses = sess.run(ROUNDS_STEPS)
    torch.cuda.synchronize()
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    plan = sess.strategy.param_reducer.plan
    n_buckets = plan.n_buckets
    sizes = [p.numel() for p in tree_leaves(sess.params)]
    w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
    w4_gate((sess.grad_rounds, sess.param_rounds) == (0, 2) and
            len(rounds) == 2, f"rounds (grad, param) = "
            f"{(sess.grad_rounds, sess.param_rounds)}, expected (0, 2)")
    per = n_buckets * len(rounds)
    w4_launch_gate(counts, {"quantize_ef": per, "dequant_accum": per,
                            "dequant_accum[warp]": per},
                   "local SGD int8_fused rounds")
    gate_rounds_differ_then_agree(torch, rounds, world)
    res = {"rank": rank, "losses": losses,
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "round_s": [r[2] for r in rounds], "staged_bytes": staged,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_buckets": n_buckets, "launches": counts,
           "bucket_lengths": [sum(sizes[i] for i in b.leaves)
                              for b in plan.buckets],
           "params": sess.num_params()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_rounds_world4(torch, card) -> dict:
    """Four spawned ranks of ``rounds_w4_child`` on the one card."""
    ranks, seconds = spawn_world4(torch, rounds_w4_child, "rounds_world4",
                                  ())
    r0 = ranks[0]
    print(f"rounds world 4 on one card over gloo [{card}]: gemma-2b d_model "
          f"2048 x 1 layer ({r0['params']} params bf16), SGD, local SGD "
          f"τ=2 with int8_fused rounds on psum, global batch 4 x seq 128, "
          f"{ROUNDS_STEPS} steps: losses {r0['losses']}; round seconds by "
          f"rank {[[round(s, 4) for s in r['round_s']] for r in ranks]}; "
          f"step ms by rank "
          f"{[[round(t, 1) for t in r['step_ms_all']] for r in ranks]}; "
          f"staged bytes per rank {[r['staged_bytes'] for r in ranks]}; "
          f"peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; "
          f"{r0['n_buckets']} buckets; launches "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; ranks differ"
          f" before each round and are bit-equal after it ({seconds:.1f} s)",
          flush=True)
    return {**r0, "round_s_by_rank": [r["round_s"] for r in ranks],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
            "seconds": seconds}


def check_rounds_w4_kernels(torch, ops, ref, lengths, card) -> None:
    """The int8_fused wire's kernels at every delta-bucket length of the
    world-4 run, with the card free again: quantize_ef writing the new
    residual into e's buffer, as the round calls it, and dequant_accum on
    a (4, n) stack of four ranks' payloads (the gathered shape of that
    run; 4 n comes near 2**31 at the embedding's bucket), each held
    bit-equal (NaN for NaN) to its plain version on the same inputs.  The
    gates of (c) compare the ranks with each other, which a deterministic
    wrong kernel passes."""
    dev = torch.device("cuda")
    for n in sorted(set(lengths)):
        gen = torch.Generator(dev).manual_seed(W4_SEED + 300 + n % 65521)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        want = ref.quantize_ef_ref(g, e, tile=TILE)
        got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
        torch.cuda.synchronize()
        if got[1].data_ptr() != buf.data_ptr() or not all(
                same(torch, a, b) for a, b in zip(got, want)):
            fail(f"rounds world-4 kernels: quantize_ef at the delta bucket "
                 f"length n={n} differs from the plain version or did not "
                 f"write the residual in place")
        q, sc = got[0], got[2]
        del g, e, buf, want, got
        torch.cuda.empty_cache()
        q4 = torch.stack([q.roll(r * 997) for r in range(W4)])
        s4 = torch.stack([sc * (1 + r) for r in range(W4)])
        del q, sc
        got = ops.dequant_accum(q4, s4, tile=TILE)
        torch.cuda.synchronize()
        ok = same(torch, got, ref.dequant_accum_ref(q4, s4, tile=TILE))
        del q4, s4, got
        torch.cuda.empty_cache()
        if not ok:
            fail(f"rounds world-4 kernels: dequant_accum at w = {W4}, n={n} "
                 f"differs from the plain version")
    print(f"rounds world-4 kernels [{card}]: quantize_ef (residual in place) "
          f"and dequant_accum at w = {W4} bit-equal to their plain versions "
          f"at every delta-bucket length {sorted(set(lengths))}", flush=True)


def phase_rounds(torch, ops, ref, train, card) -> dict:
    """Phase 10: (a) the three schedulers at full width, (b) the reduced
    card-vs-CPU runs and the checkpoint, (c) local SGD at world 4, then
    its kernels at its bucket lengths against their plain versions."""
    full = run_rounds(torch, ops, train, card)
    small = phase_small_rounds_reference(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    world4 = phase_rounds_world4(torch, card)
    check_rounds_w4_kernels(torch, ops, ref, world4["bucket_lengths"], card)
    return {"full_width": full, "small_reference": small, "world4": world4}

# ---------------------------------------------------------------------------
# 11. the communication planner: --sync auto at world 1 and at world 4
# ---------------------------------------------------------------------------

AUTO_ARGS = TRAIN_ARGS + ["--sync", "auto", "--topology",
                          "commodity_cluster"]
AUTO_W4_TOPOLOGY = "device:4@fast_ici"
AUTO_W4_T_BWD_S = 0.030
AUTO_W4_STEPS = 4
AUTO_W4_PERIOD = 2
AUTO_W4_SESSION = dict(arch="gemma-2b", layers=1, steps=AUTO_W4_STEPS,
                       batch=4, seq=128, optimizer="sgd", lr=3e-3, warmup=1,
                       seed=0)


def plan_launches(plan, rounds: int, world: int) -> dict:
    """The wire-kernel launches a plan makes in ``rounds`` rounds over one
    data axis of ``world`` ranks, derived bucket by bucket: topk_fused
    launches topk_ef (with error feedback) or topk_mask once per bucket
    and round; int8_fused quantize_ef (with error feedback) or
    quantize_tiles once, then dequant_accum once on the gather wire, or,
    on ring_fused at world > 1, quantize_tiles once per stream and hop
    (2·p); every other compressor runs plain ops.  All on the warp route
    (tile 1024)."""
    want: dict = {}

    def add(kernel, n):
        for k in (kernel, f"{kernel}[warp]"):
            want[k] = want.get(k, 0) + n
        if kernel == "quantize_ef":          # a wrapper without routes
            del want["quantize_ef[warp]"]

    for b in plan.buckets:
        ef = b.error_feedback and b.compressor != "none"
        if b.compressor == "topk_fused":
            add("topk_ef" if ef and b.fused else "topk_mask", rounds)
        elif b.compressor == "int8_fused":
            add("quantize_ef" if ef and b.fused else "quantize_tiles", rounds)
            if b.algo == "ring_fused":
                if world > 1:
                    add("quantize_tiles", RING_FUSED_STREAMS * world * rounds)
            elif b.fused:
                add("dequant_accum", rounds)
    return want


def bucket_lengths(plan, params) -> list:
    """Each bucket's packed length (elements), from the leaves it packs."""
    from repro_torch._tree import tree_leaves
    sizes = [math.prod(p.shape) for p in tree_leaves(params)]
    return [sum(sizes[i] for i in b.leaves) for b in plan.buckets]


def describe_buckets(plan, lengths) -> str:
    return "; ".join(
        f"{j}: {b.algo}/{b.compressor} leaves {list(b.leaves)} n={n} "
        f"({b.bucket_bytes} B priced)"
        for j, (b, n) in enumerate(zip(plan.buckets, lengths)))


def run_auto(torch, ops, train, card) -> dict:
    """Phase 11 (a): ``--sync auto --topology commodity_cluster`` through
    the CLI at phase 8's full width, NCCL world 1, every kernel counter
    set to 0 just before and read just after: the backward measured on
    the card, the executed plan the planned one bucket for bucket, the
    winner one of the priced arms, the wire kernels exactly as the plan
    derives them (``plan_launches``), losses finite; then a profiled
    step."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = train.main(AUTO_ARGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if session.device.type != "cuda":
        fail(f"auto ran on {session.device}, not on the card")
    planned = session.planned
    sp, executed = planned["strategy_plan"], planned["executed"]
    if sp.key not in planned["arms"] or planned["arms"][sp.key] is not sp:
        fail(f"auto: the winner {sp.key} is not one of the priced arms "
             f"{sorted(planned['arms'])}")
    if executed is not sp:
        fail(f"auto: the winner {sp.key} did not run ({executed.key} did)")
    st = session.strategy
    reducer = st.param_reducer if sp.schedule.kind == "local_sgd" \
        else st.grad_reducer
    if reducer is None or reducer.plan.buckets != sp.comm.buckets:
        fail(f"auto: the executor's plan is not the planned one: "
             f"{None if reducer is None else reducer.plan.describe()} vs "
             f"{sp.comm.describe()}")
    losses = list(session.losses)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"auto: losses {losses}")
    rounds = (session.param_rounds if sp.schedule.kind == "local_sgd"
              else session.grad_rounds)
    want = plan_launches(reducer.plan, rounds, session.world)
    if not any(want.values()):
        fail(f"auto: the plan {sp.key} runs no kernel of the port")
    for kname, count in launches.items():
        if count != want.get(kname, 0):
            fail(f"auto: kernel {kname} launched {count} times, expected "
                 f"{want.get(kname, 0)} (derived from the plan: "
                 f"{ {k: v for k, v in want.items() if v} } over {rounds} "
                 f"rounds)")
    lengths = bucket_lengths(reducer.plan, session.params)
    times = [t * 1e3 for t in session.step_times]
    res = {"t_backward_s": planned["t_backward_s"],
           "search_s": planned["search_s"], "winner": sp.key,
           "modeled_step_s": sp.modeled_step_s,
           "arms": sorted(planned["arms"]), "digest": planned["digest"],
           "buckets": [[b.algo, b.compressor, list(b.leaves), n,
                        b.bucket_bytes]
                       for b, n in zip(reducer.plan.buckets, lengths)],
           "losses": losses, "step_ms_all": times,
           "step_ms": statistics.median(times[1:]), "peak_bytes": peak,
           "launches": launches, "run_s": seconds,
           "rounds": rounds}
    print(f"auto world 1 [{card}]: {session.model_cfg.name} bf16, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps on "
          f"commodity_cluster (world 256, a planning model): backward "
          f"measured {planned['t_backward_s'] * 1e3:.3f} ms, the search "
          f"{planned['search_s']:.3f} s of host time, winner {sp.key} "
          f"(modeled {sp.modeled_step_s * 1e3:.3f} ms/step, "
          f"{len(planned['arms'])} arms); buckets "
          f"{describe_buckets(reducer.plan, lengths)}; losses "
          f"{[round(x, 4) for x in losses]}; step times "
          f"{[round(t, 1) for t in times]} ms (median of steps 2-"
          f"{TRAIN_STEPS} {res['step_ms']:.3f}); peak memory "
          f"{peak / 2**30:.3f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} } (= the plan's "
          f"{ {k: v for k, v in want.items() if v} }); run {seconds:.1f} s",
          flush=True)
    res["profile"] = profile_round(torch, session, card, "auto")
    res["wire"] = [(b.compressor, dict(b.compressor_args), n)
                   for b, n in zip(reducer.plan.buckets, lengths)]
    del session, reducer, st
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_auto_kernels(torch, ops, ref, wire, world: int, what: str,
                       card) -> None:
    """The kernels of an executed plan at every packed bucket length it
    runs them at, each bit-equal (NaN for NaN) to its plain version on
    the same inputs, called as the path calls them: topk_ef and
    quantize_ef write the residual into e's buffer; dequant_accum decodes
    the bucket's payload at ``world`` ranks (the gather wire at world 1);
    on ring_fused at world > 1, quantize_tiles on every row of the
    (p, m) hop buffers at the bucket's chunk lengths."""
    dev = torch.device("cuda")
    done = []
    for comp, args, n in wire:
        if comp not in ("topk_fused", "int8_fused"):
            continue
        gen = torch.Generator(dev).manual_seed(W4_SEED + 500 + n % 65521)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.randn(n, generator=gen, device=dev) * 0.1
        buf = e.clone()
        if comp == "topk_fused":
            ratio = float(args.get("ratio", 0.01))
            want = ref.topk_ef_ref(g, e, ratio=ratio, tile=TILE)
            got = ops.topk_ef(g, buf, ratio=ratio, tile=TILE, e_out=buf)
            name = "topk_ef"
        else:
            want = ref.quantize_ef_ref(g, e, tile=TILE)
            got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
            name = "quantize_ef"
        torch.cuda.synchronize()
        if got[1].data_ptr() != buf.data_ptr() or not all(
                same(torch, a, b) for a, b in zip(got, want)):
            fail(f"{what}: {name} at the planned bucket length n={n} "
                 f"differs from the plain version or did not write the "
                 f"residual in place")
        done.append((name, n))
        if comp == "int8_fused" and world == 1:
            q1, s1 = got[0][None], got[2][None]
            if not same(torch, ops.dequant_accum(q1, s1, tile=TILE),
                        ref.dequant_accum_ref(q1, s1, tile=TILE)):
                fail(f"{what}: dequant_accum at n={n} differs from the "
                     f"plain version")
            done.append(("dequant_accum", n))
            del q1, s1
        del g, e, buf, want, got
        torch.cuda.empty_cache()
        if comp == "int8_fused" and world > 1:
            for m in ring_fused_hops(n):
                a = torch.randn(world, m, generator=gen, device=dev)
                for r in range(world):
                    got = ops.quantize_tiles(a[r], tile=TILE)
                    want = ref.quantize_tiles_ref(a[r], tile=TILE)
                    if not all(same(torch, x, y) for x, y in zip(got, want)):
                        fail(f"{what}: quantize_tiles on row {r} of the "
                             f"({world}, {m}) ring_fused hop buffer of the "
                             f"n={n} bucket differs from the plain version")
                    del got, want
                done.append(("quantize_tiles", m))
                del a
                torch.cuda.empty_cache()
    print(f"{what} kernels [{card}]: bit-equal to their plain versions at "
          f"the planned lengths {done}", flush=True)


def auto_w4_child(rank: int, world: int, store: str, out_dir: str,
                  expect: dict) -> None:
    """Phase 11 (b), one rank: gemma-2b at full width with 1 layer, SGD,
    ``plan_auto`` with a pinned local-SGD scheduler (τ = 2) on
    ``device:4@fast_ici`` at a pinned backward of 30 ms, a gloo group of
    4 processes on the one card.  Gates: the rank's plan is ``expect``
    (the port's planner on the CPU, same inputs) and every rank's digest
    is equal; 2 parameter rounds, before each the ranks differ and after
    it they are bit-equal; the wire kernels as ``plan_launches`` derives
    them from the plan."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import (SessionConfig, TrainSession, plan_decision,
                                 plan_digest)
    from repro_torch.core import get_scheduler
    from repro_torch.core.collectives import all_gather, p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.report import render_strategy_plan
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    sess = TrainSession(SessionConfig(device="cuda", **AUTO_W4_SESSION),
                        group=group)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    t0 = time.perf_counter()
    sp = sess.plan_auto(topology=AUTO_W4_TOPOLOGY,
                        t_backward_s=AUTO_W4_T_BWD_S,
                        scheduler=get_scheduler("local_sgd",
                                                period=AUTO_W4_PERIOD))
    plan_s = time.perf_counter() - t0
    if rank == 0:
        print(render_strategy_plan(
            sp, arms=sess.planned["arms"],
            baselines=sess.planned["baselines"],
            t_backward_s=sess.planned["t_backward_s"]), flush=True)
    mine = torch.tensor(list(bytes.fromhex(plan_digest(sp))),
                        dtype=torch.int64)
    every = all_gather(mine, group)
    w4_gate(all(torch.equal(every[r], every[0]) for r in range(world)),
            "the ranks' plan digests differ")
    w4_gate(plan_decision(sp) == expect,
            f"the plan {plan_decision(sp)} is not the port's CPU plan "
            f"{expect}")
    sess._build()
    rounds = watch_param_rounds(torch, sess)
    losses = sess.run(AUTO_W4_STEPS)
    torch.cuda.synchronize()
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    plan = sess.strategy.param_reducer.plan
    w4_gate(plan.buckets == sp.comm.buckets,
            "the executor's plan is not the planned one")
    w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
    n_rounds = AUTO_W4_STEPS // AUTO_W4_PERIOD
    w4_gate((sess.grad_rounds, sess.param_rounds) == (0, n_rounds) and
            len(rounds) == n_rounds,
            f"rounds (grad, param) = {(sess.grad_rounds, sess.param_rounds)}"
            f", expected (0, {n_rounds})")
    want = plan_launches(plan, n_rounds, world)
    w4_gate(any(want.values()), "the plan runs no kernel of the port")
    w4_launch_gate(counts, want, "auto local SGD rounds")
    gate_rounds_differ_then_agree(torch, rounds, world)
    lengths = bucket_lengths(plan, sess.params)
    res = {"rank": rank, "losses": losses, "plan_s": plan_s,
           "winner": sp.key, "digest": sess.planned["digest"],
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "round_s": [r[2] for r in rounds], "staged_bytes": staged,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "n_buckets": plan.n_buckets, "launches": counts,
           "buckets": describe_buckets(plan, lengths),
           "wire": [(b.compressor, dict(b.compressor_args), n)
                    for b, n in zip(plan.buckets, lengths)],
           "params": sess.num_params()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def auto_w4_expected() -> dict:
    """The world-4 run's plan as the port's planner makes it on the CPU,
    from the same leaf sizes (``param_desc``: nothing allocated), backward
    time, topology and scheduler."""
    from repro_torch.api import plan_decision
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import (Topology, profiles_from_grads,
                                           serial_round_plan)
    from repro_torch.core.schedule.planner import local_sgd_arm
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(AUTO_W4_SESSION["arch"]),
                              num_layers=AUTO_W4_SESSION["layers"])
    profiles = profiles_from_grads(Model(cfg).param_desc(), AUTO_W4_T_BWD_S)
    topo = Topology.from_spec(AUTO_W4_TOPOLOGY)
    rp = serial_round_plan(profiles, topo, topo.world)
    return plan_decision(local_sgd_arm(rp, AUTO_W4_T_BWD_S, AUTO_W4_PERIOD))


def phase_auto_world4(torch, card) -> dict:
    """Four spawned ranks of ``auto_w4_child`` on the one card, after the
    port's planner made the same plan on the CPU."""
    expect = auto_w4_expected()
    wires = sorted({(b[1], b[2]) for b in expect["buckets"]})
    print(f"auto world 4: the port's planner on the CPU plans "
          f"{expect['key']} with {len(expect['buckets'])} buckets {wires} "
          f"for {AUTO_W4_TOPOLOGY} at a backward of "
          f"{AUTO_W4_T_BWD_S * 1e3:.0f} ms", flush=True)
    ranks, seconds = spawn_world4(torch, auto_w4_child, "auto_world4",
                                  (expect,))
    r0 = ranks[0]
    print(f"auto world 4 on one card over gloo [{card}]: gemma-2b d_model "
          f"2048 x 1 layer ({r0['params']} params bf16), SGD, --sync auto "
          f"--local-sgd {AUTO_W4_PERIOD} --topology {AUTO_W4_TOPOLOGY} "
          f"--plan-backward-ms {AUTO_W4_T_BWD_S * 1e3:.0f}, global batch "
          f"4 x seq 128, {AUTO_W4_STEPS} steps: the plan {r0['winner']} "
          f"(digest {r0['digest'][:16]}, equal on every rank, = the CPU "
          f"planner's) planned in {[round(r['plan_s'], 3) for r in ranks]} "
          f"s; buckets {r0['buckets']}; losses {r0['losses']}; round "
          f"seconds by rank {[[round(s, 4) for s in r['round_s']] for r in ranks]}"
          f"; step ms by rank "
          f"{[[round(t, 1) for t in r['step_ms_all']] for r in ranks]}; "
          f"staged bytes per rank {[r['staged_bytes'] for r in ranks]}; peak "
          f"memory per rank "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; "
          f"launches { {k: v for k, v in r0['launches'].items() if v} }; "
          f"ranks differ before each round and are bit-equal after it "
          f"({seconds:.1f} s)", flush=True)
    return {**r0, "expect": expect,
            "round_s_by_rank": [r["round_s"] for r in ranks],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
            "seconds": seconds}


def phase_auto(torch, ops, ref, train, card) -> dict:
    """Phase 11: (a) ``--sync auto`` at world 1 at full width, then its
    kernels at its bucket lengths; (b) the planned local-SGD rounds at
    world 4, then their kernels at that plan's bucket and hop lengths."""
    from repro_torch.launch.dist import destroy_group
    world1 = run_auto(torch, ops, train, card)
    destroy_group()
    check_auto_kernels(torch, ops, ref, world1["wire"], 1, "auto world 1",
                       card)
    world4 = phase_auto_world4(torch, card)
    check_auto_kernels(torch, ops, ref, world4["wire"], W4, "auto world 4",
                       card)
    return {"world1": world1, "world4": world4}



# ---------------------------------------------------------------------------
# 12. sharded data parallelism: world 1 at full width, world 4 on one card
# ---------------------------------------------------------------------------

SHARD_FLAGS = ["--sync", "comm", "--compressor", "int8_fused",
               "--parallelism", "shard"]
# bytes held per parameter through the sharded step: bf16 params (2) and
# grads (2), the f32 master (4), Adam's f32 moments over the rows (8), the
# int8_fused EF residual (4) and the f32 gradient shards (4)
SHARD_BYTES_PER_PARAM = 24
# above that: the backward's activations and one bucket's temporaries
SHARD_PEAK_SLACK = 16 * 2**30
SHARD_SMALL_STEPS = 3
SHARD_SMALL_SESSION = dict(arch="gemma-2b", reduced=True,
                           steps=SHARD_SMALL_STEPS, batch=4, seq=32,
                           lr=3e-3, warmup=1, seed=0)
SHARD_SMALL_WIRES = {   # name: (SyncConfig kwargs, optimizers)
    "dense_ring": (dict(algo="ring"), ("adam", "lamb")),
    "int8_fused_ring": (dict(compressor="int8_fused", algo="ring"),
                        ("adam",)),
}
SHARD_W4_TOPOLOGY = "commodity_cluster"
SHARD_W4_T_BWD_S = 0.030
SHARD_W4_STEPS = 3
SHARD_W4_SESSION = dict(arch="gemma-2b", layers=1, steps=SHARD_W4_STEPS,
                        batch=4, seq=128, optimizer="adam", lr=3e-3,
                        warmup=1, seed=0)


def rows_bytes(state) -> int:
    """Bytes of a sharded session's rows (master and moments)."""
    rows = list(state["master"]) + [r for v in state["opt"].values()
                                    for r in v]
    return sum(r.numel() * r.element_size() for r in rows)


def tensors_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def run_sharded(torch, ops, train, card, replicated_params) -> dict:
    """Phase 12 (a): ``--sync comm --compressor int8_fused --parallelism
    shard`` through the CLI at phase 8's full width, NCCL world 1, every
    kernel counter set to 0 just before and read just after: quantize_ef
    and dequant_accum once per bucket and step, all on the warp route, 0
    for every other kernel; the rows' bytes equal the layout's reckoning;
    what the allocator holds after the run is the parameters, the rows
    and the EF residuals (no replicated moment alive); the peak within the
    reckoning printed before the run.  Then the largest difference from
    phase 8's replicated int8_fused parameters (printed, not gated: the
    f32 master keeps bits the replicated bf16 update rounds away) and a
    profiled step."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    params = sum(math.prod(d.shape) for d in
                 tree_leaves(Model(get_config("gemma-2b")).param_desc()))
    need = SHARD_BYTES_PER_PARAM * params
    print(f"sharded memory reckoning [{card}]: the sharded int8_fused step "
          f"holds {SHARD_BYTES_PER_PARAM} B per parameter = "
          f"{need / 2**30:.2f} GiB for {params} parameters, and the peak "
          f"may add {SHARD_PEAK_SLACK / 2**30:.0f} GiB of activations and "
          f"bucket temporaries; the card has {free / 2**30:.2f} GiB free of "
          f"{total / 2**30:.2f} GiB", flush=True)
    if need > free:
        fail(f"the sharded run needs ~{need / 2**30:.2f} GiB, the card has "
             f"{free / 2**30:.2f} GiB free")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = train.main(TRAIN_ARGS + SHARD_FLAGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    alive = torch.cuda.memory_allocated()
    if session.device.type != "cuda":
        fail(f"sharded ran on {session.device}, not on the card")
    layout = session.layout
    if layout is None or not session.strategy.shard_state:
        fail("sharded: the session did not build the sharded step")
    losses = list(session.losses)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"sharded: losses {losses}")
    n_buckets = len(layout.buckets)
    for kname, count in launches.items():
        want = n_buckets * TRAIN_STEPS if kname in INT8_WIRE else 0
        if count != want or (kname in INT8_WIRE and want <= 0):
            fail(f"sharded: kernel {kname} launched {count} times, expected "
                 f"{want} (= {n_buckets} buckets x {TRAIN_STEPS} steps for "
                 f"quantize_ef and dequant_accum on the warp route, 0 for "
                 f"the others)")
    state = rows_bytes(session.opt_state)
    reckoned = layout.opt_bytes_per_worker("adam", True)
    if sorted(session.opt_state) != ["master", "opt"] or state != reckoned:
        fail(f"sharded: the rows hold {state} B, the layout reckons "
             f"{reckoned} B ({sorted(session.opt_state)})")
    held = (tensors_bytes(tree_leaves(session.params)) + state +
            tensors_bytes(session.sync_state.get("error", [])))
    if alive - held > 2**30:
        fail(f"sharded: the allocator holds {alive} B after the run, the "
             f"parameters, rows and EF residuals {held} B: a replicated "
             f"moment (or another step-long buffer) is still alive")
    if peak > need + SHARD_PEAK_SLACK:
        fail(f"sharded: peak {peak / 2**30:.3f} GiB above the reckoning "
             f"{need / 2**30:.2f} + {SHARD_PEAK_SLACK / 2**30:.0f} GiB")
    dmax = 0.0
    for p, r in zip(tree_leaves(session.params), replicated_params):
        d = (p.float() - r.to(p.device).float()).abs().max().item()
        dmax = max(dmax, d)
    times = [t * 1e3 for t in session.step_times]
    res = {"losses": losses, "step_ms_all": times,
           "step_ms": statistics.median(times[1:]), "peak_bytes": peak,
           "reckoning_bytes": need, "alive_bytes": alive,
           "held_bytes": held, "state_bytes": state,
           "replicated_state_bytes": layout.opt_bytes_per_worker(
               "adam", False),
           "n_buckets": n_buckets, "launches": launches, "run_s": seconds,
           "max_abs_diff_vs_replicated": dmax}
    print(f"sharded world 1 [{card}]: {session.model_cfg.name} bf16, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, int8_fused, "
          f"--parallelism shard: losses {[round(x, 4) for x in losses]}; "
          f"step times {[round(t, 1) for t in times]} ms (median of steps 2-"
          f"{TRAIN_STEPS} {res['step_ms']:.3f}); rows {state} B = the "
          f"layout's reckoning (3 x 4 B x {sum(b.m for b in layout.buckets)}"
          f"), replicated moments would be "
          f"{res['replicated_state_bytes']} B; after the run the allocator "
          f"holds {alive / 2**30:.3f} GiB, the parameters + rows + EF "
          f"residuals {held / 2**30:.3f} GiB; peak memory "
          f"{peak / 2**30:.3f} GiB (reckoning {need / 2**30:.2f} GiB + "
          f"activations); launches "
          f"{ {k: v for k, v in launches.items() if v} }; largest |Δ| of "
          f"the bf16 parameters from phase 8's replicated int8_fused run "
          f"{dmax:.6g} (not gated); run {seconds:.1f} s", flush=True)
    res["profile"] = profile_round(torch, session, card, "sharded")
    del session, layout
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tree_digests(torch, tree) -> dict:
    """``digest`` of every leaf of a tree, by its checkpoint key."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    return {k: digest(torch, v).tolist()
            for k, v in _flatten_with_paths(tree).items()}


def shard_small_child(rank: int, world: int, store: str,
                      out_dir: str) -> None:
    """Phase 12 (b), one rank: reduced gemma-2b in f32 on a gloo group of
    4 processes on the one card, 3 steps each of a sharded session and a
    replicated one on the same plan (``sharded_plan_from_config``), for
    dense ``ring`` and ``int8_fused`` on ``ring`` with Adam, and LAMB on
    dense ``ring``.  Adam: losses, parameters, the gathered master rows,
    the gathered moments and the EF residuals bit-equal; LAMB within
    rtol 2e-5, atol 1e-7.  Then the int8_fused session saves its
    checkpoint (rank 0 writes it and the digests of the saved state)."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import (PlanExecutor, SyncConfig, SyncStrategy,
                                  get_scheduler, make_strategy)
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    res = {"rank": rank, "compared": []}

    def equal(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    saver = None
    for name, (kw, opts) in SHARD_SMALL_WIRES.items():
        for opt in opts:
            scfg = SessionConfig(device="cuda", optimizer=opt,
                                 **SHARD_SMALL_SESSION)
            sh = TrainSession(scfg, strategy=make_strategy(
                "every_step", group=group, sync=SyncConfig(**kw),
                parallelism="shard"), group=group)
            sh.run(SHARD_SMALL_STEPS)
            plan = sh.synchronizer.plan
            rp = TrainSession(scfg, strategy=SyncStrategy(
                get_scheduler("every_step"),
                grad_reducer=PlanExecutor(plan, group)), group=group)
            rp.run(SHARD_SMALL_STEPS)
            full = sh.full_opt_state()
            what = f"{name}/{opt}"
            w4_gate(equal(full["master"], sh.params),
                    f"{what}: the gathered master rows are not the params")
            if opt == "lamb":
                worst = max(((a - b).abs() - 1e-7 - 2e-5 * b.abs()).max()
                            .item() for a, b in zip(tree_leaves(sh.params),
                                                    tree_leaves(rp.params)))
                w4_gate(worst <= 0.0, f"{what}: sharded and replicated "
                        f"parameters beyond rtol 2e-5, atol 1e-7 ({worst})")
            else:
                w4_gate(sh.losses == rp.losses, f"{what}: losses "
                        f"{sh.losses} vs {rp.losses}")
                w4_gate(equal(sh.params, rp.params),
                        f"{what}: parameters differ from the replicated run")
                w4_gate(all(equal(full[k], rp.opt_state[k])
                            for k in ("m", "v")),
                        f"{what}: moments differ from the replicated run")
                errs = [(a, b) for a, b in zip(
                    sh.sync_state.get("error", []),
                    rp.sync_state.get("error", [])) if a is not None]
                w4_gate(all(torch.equal(a, b) for a, b in errs),
                        f"{what}: EF residuals differ")
            res["compared"].append([what, sh.losses,
                                    [b.m for b in sh.layout.buckets]])
            if name == "int8_fused_ring":
                saver = (sh, full)
            else:
                del sh, full
            del rp
            gc.collect()
    sh, full = saver
    path = os.path.join(out_dir, "ck")
    sh.save_checkpoint(path)
    if rank == 0:
        res["saved"] = {"params": tree_digests(torch, sh.params),
                        "opt": tree_digests(torch, full),
                        "step": sh.step}
    res["launches"] = path_counts(ops)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_shard_small(torch, card) -> dict:
    """Phase 12 (b): four spawned ranks of ``shard_small_child``, then the
    world-4 checkpoint restored here into a world-1 sharded session and a
    replicated one: their parameters and full optimizer state (with the
    f32 master where kept) equal the saved state bit for bit."""
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.launch.dist import destroy_group
    ranks, seconds = spawn_world4(torch, shard_small_child, "shard_small",
                                  ())
    saved = ranks[0]["saved"]
    path = str(ROOT / "build" / "shard_small" / "ck")
    kw = SHARD_SMALL_WIRES["int8_fused_ring"][0]
    restored = {}
    for tag, strategy in (("world1_sharded", make_strategy(
            "every_step", sync=SyncConfig(**kw), parallelism="shard")),
                          ("replicated", None)):
        sess = TrainSession(SessionConfig(device="cuda",
                                          **SHARD_SMALL_SESSION),
                            strategy=strategy)
        step = sess.load_checkpoint(path)
        sess._build()
        opt = tree_digests(torch, sess.full_opt_state())
        want = saved["opt"] if tag != "replicated" else {
            k: v for k, v in saved["opt"].items()
            if not k.startswith("master/")}
        if step != saved["step"] or opt != want or \
                tree_digests(torch, sess.params) != saved["params"]:
            fail(f"sharded checkpoint: the world-4 state restored into the "
                 f"{tag} session differs (step {step} vs {saved['step']}; "
                 f"optimizer leaves {len(opt)} vs {len(want)})")
        restored[tag] = {"step": step, "opt_leaves": len(opt)}
        del sess
        gc.collect()
        destroy_group()
    print(f"sharded world 4 bit-equality [{card}]: reduced gemma-2b f32 on "
          f"gloo, {SHARD_SMALL_STEPS} steps each: "
          f"{[c[0] for c in ranks[0]['compared']]} sharded == replicated bit "
          f"for bit on every rank (parameters, gathered master, moments, EF; "
          f"lamb within rtol 2e-5), losses "
          f"{[[c[0], c[1]] for c in ranks[0]['compared']]}; the world-4 "
          f"checkpoint restores into a world-1 sharded session "
          f"({restored['world1_sharded']['opt_leaves']} optimizer leaves "
          f"with the master) and a replicated one "
          f"({restored['replicated']['opt_leaves']} leaves) bit for bit "
          f"({seconds:.1f} s)", flush=True)
    return {"compared": ranks[0]["compared"], "restored": restored,
            "seconds": seconds}


def shard_w4_child(rank: int, world: int, store: str, out_dir: str,
                   expect: dict, budget_gb: float, mode: str) -> None:
    """Phase 12 (c), one rank: gemma-2b at full width with 1 layer, Adam,
    global batch 4 x seq 128, ``plan_auto`` on ``commodity_cluster`` at a
    pinned 30 ms backward, pinned to the ``shard`` spec under a memory
    budget, a gloo group of 4 processes on the one card; ``mode``
    "replicated" runs the same plan replicated instead.  Gates: the plan
    is ``expect`` and every rank's digest is equal; the parameters are
    bit-equal across ranks after every step; the wire kernels as
    ``plan_launches`` derives them from the plan."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import (SessionConfig, TrainSession, plan_decision,
                                 plan_digest)
    from repro_torch.core import (PlanExecutor, SyncStrategy,
                                  get_scheduler)
    from repro_torch.core.collectives import all_gather, p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    sess = TrainSession(SessionConfig(device="cuda", **SHARD_W4_SESSION),
                        group=group)
    sp = sess.plan_auto(topology=SHARD_W4_TOPOLOGY,
                        t_backward_s=SHARD_W4_T_BWD_S, parallelism="shard",
                        memory_budget_gb=budget_gb)
    every = all_gather(torch.tensor(list(bytes.fromhex(plan_digest(sp))),
                                    dtype=torch.int64), group)
    w4_gate(all(torch.equal(every[r], every[0]) for r in range(world)),
            "the ranks' plan digests differ")
    w4_gate(sp.key == "every_step_sharded" and plan_decision(sp) == expect,
            f"the plan {plan_decision(sp)} is not the port's CPU plan "
            f"{expect}")
    if mode == "replicated":
        plan = dataclasses.replace(sp.comm, shard_state=False)
        sess.strategy = SyncStrategy(get_scheduler("every_step"),
                                     grad_reducer=PlanExecutor(plan,
                                                               sess.axes))
    sess._build()
    plan = sess.synchronizer.plan
    w4_gate(plan.buckets == sp.comm.buckets,
            "the executor's plan is not the planned one")
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    step_ms = []
    for s in range(SHARD_W4_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.step_once()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        digests = all_gather(params_digest(torch, sess.params), group)
        w4_gate(all(torch.equal(digests[r], digests[0])
                    for r in range(world)),
                f"step {s}: the ranks' parameters differ")
    counts = path_counts(ops)
    staged = p2p.staged_bytes()
    peak = torch.cuda.max_memory_allocated()
    want = plan_launches(plan, SHARD_W4_STEPS, world)
    w4_gate(any(want.values()), "the plan runs no kernel of the port")
    w4_launch_gate(counts, want, f"{mode} world 4")
    w4_gate(all(map(math.isfinite, sess.losses)), f"losses {sess.losses}")
    if mode == "sharded":
        state = rows_bytes(sess.opt_state)
        reckoned = sess.layout.opt_bytes_per_worker("adam", True)
        w4_gate(state == reckoned, f"rows {state} B, reckoned {reckoned} B")
    else:
        state = tensors_bytes(t for v in sess.opt_state.values()
                              for t in tree_leaves(v))
    lengths = bucket_lengths(plan, sess.params)
    res = {"rank": rank, "mode": mode, "losses": sess.losses,
           "winner": sp.key, "digest": sess.planned["digest"],
           "step_ms_all": step_ms, "staged_bytes_per_step":
           staged / SHARD_W4_STEPS, "state_bytes": state,
           "peak_bytes": peak, "launches": counts,
           "n_buckets": plan.n_buckets,
           "buckets": describe_buckets(plan, lengths),
           "wire": [(b.compressor, dict(b.compressor_args), n)
                    for b, n in zip(plan.buckets, lengths)],
           "params": sess.num_params()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def decision_digest(decision: dict) -> str:
    """sha256 of a plan decision (``api.plan_digest``'s canonical JSON)."""
    import hashlib
    return hashlib.sha256(json.dumps(decision, sort_keys=True)
                          .encode()).hexdigest()


def shard_w4_inputs(torch) -> tuple:
    """(the port's CPU plan of the world-4 run, from the same leaf sizes,
    backward time, topology, spec and budget as ``plan_auto``; the budget
    in GiB, halfway between the layout's replicated Adam moments and its
    sharded rows at world 4; both reckonings in bytes)."""
    from repro_torch.api import plan_decision
    from repro_torch.configs import get_config
    from repro_torch.core import ShardLayout, SyncConfig
    from repro_torch.core.grad_sync import sharded_plan_from_config
    from repro_torch.core.schedule import (PipelineAxis, TensorAxis,
                                           Topology, plan_rounds,
                                           profiles_from_grads)
    from repro_torch.models import Model
    from repro_torch._tree import tree_map
    s = SHARD_W4_SESSION
    cfg = dataclasses.replace(get_config(s["arch"]), num_layers=s["layers"])
    desc = Model(cfg).param_desc()
    # shapes only: tensors on the meta device allocate nothing
    meta = tree_map(lambda d: torch.empty(d.shape, device="meta"), desc,
                    is_leaf=lambda d: hasattr(d, "init"))
    layout = ShardLayout.from_plan(
        sharded_plan_from_config(SyncConfig(), meta), meta, (W4,))
    rep = layout.opt_bytes_per_worker("adam", False, moments=2.0)
    sh = layout.opt_bytes_per_worker("adam", True, moments=2.0)
    budget_gb = (rep + sh) / 2 / 2**30
    tokens = float(s["batch"] * s["seq"])
    topo = Topology.from_spec(SHARD_W4_TOPOLOGY)
    best, _ = plan_rounds(
        profiles_from_grads(desc, SHARD_W4_T_BWD_S), topo, topo.world,
        opt_name="adam", opt_moments=2.0,
        memory_budget_bytes=budget_gb * 2**30,
        pipeline=PipelineAxis(global_tokens=tokens,
                              bytes_per_token=float(cfg.d_model * 4)),
        tensor=TensorAxis(global_tokens=tokens,
                          bytes_per_token=float(cfg.d_model * 4),
                          n_layers=cfg.num_layers),
        parallelism="shard")
    return plan_decision(best), budget_gb, rep, sh


def phase_shard_world4(torch, card) -> dict:
    """Phase 12 (c): the sharded run of ``shard_w4_child`` on four spawned
    ranks, then the replicated run of the same plan, each after the
    port's planner made the plan on the CPU."""
    expect, budget_gb, rep, sh = shard_w4_inputs(torch)
    wires = sorted({(b[1], b[2]) for b in expect["buckets"]})
    print(f"sharded world 4: the port's planner on the CPU plans "
          f"{expect['key']} with {len(expect['buckets'])} buckets {wires} "
          f"for {SHARD_W4_TOPOLOGY} at a backward of "
          f"{SHARD_W4_T_BWD_S * 1e3:.0f} ms, the spec 'shard' and a budget "
          f"of {budget_gb:.4f} GiB (halfway between the layout's replicated "
          f"Adam moments, {int(rep)} B, and its sharded rows at world 4, "
          f"{int(sh)} B); its plan digest {decision_digest(expect)}",
          flush=True)
    runs = {}
    for mode in ("sharded", "replicated"):
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"sharded world 4, {mode} run: the card has "
              f"{free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB "
              f"before the spawn", flush=True)
        ranks, seconds = spawn_world4(torch, shard_w4_child,
                                      f"shard_world4_{mode}",
                                      (expect, budget_gb, mode))
        runs[mode] = (ranks, seconds)
    (sr, ss), (rr, rs) = runs["sharded"], runs["replicated"]
    r0 = sr[0]
    if r0["digest"] != decision_digest(expect):
        fail(f"sharded world 4: the ranks' plan digest {r0['digest']} is not "
             f"the CPU planner's {decision_digest(expect)}")
    for a, b in zip(sr, rr):
        if a["digest"] != b["digest"] or a["launches"] != b["launches"]:
            fail("sharded world 4: the sharded and replicated runs planned "
                 "or launched differently")
    saved = [b["peak_bytes"] - a["peak_bytes"] for a, b in zip(sr, rr)]
    print(f"sharded world 4 on one card over gloo [{card}]: gemma-2b d_model "
          f"2048 x 1 layer ({r0['params']} params bf16), Adam, --sync auto "
          f"--topology {SHARD_W4_TOPOLOGY} --plan-backward-ms "
          f"{SHARD_W4_T_BWD_S * 1e3:.0f} --parallelism shard, global batch "
          f"4 x seq 128, {SHARD_W4_STEPS} steps: the plan {r0['winner']} "
          f"(digest {r0['digest']}, equal on every rank; the CPU planner's "
          f"decision equal); buckets {r0['buckets']}; losses sharded "
          f"{r0['losses']} replicated {rr[0]['losses']}; step ms by rank "
          f"sharded {[[round(t, 1) for t in r['step_ms_all']] for r in sr]}"
          f" replicated "
          f"{[[round(t, 1) for t in r['step_ms_all']] for r in rr]}; staged "
          f"bytes per rank and step sharded "
          f"{[r['staged_bytes_per_step'] for r in sr]} replicated "
          f"{[r['staged_bytes_per_step'] for r in rr]}; optimizer state per "
          f"rank sharded {[r['state_bytes'] for r in sr]} B (reckoning 3 x "
          f"4 B x Σm = {int(sh)} B) replicated "
          f"{[r['state_bytes'] for r in rr]} B (2 x 4 B x n = {int(rep)} "
          f"B); peak memory per rank sharded "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in sr]} GiB "
          f"replicated {[round(r['peak_bytes'] / 2**30, 3) for r in rr]} "
          f"GiB, lower by {[round(x / 2**30, 3) for x in saved]} GiB; "
          f"launches { {k: v for k, v in r0['launches'].items() if v} }; "
          f"parameters bit-equal across ranks after every step ({ss:.1f} + "
          f"{rs:.1f} s)", flush=True)
    return {"sharded": r0, "replicated": rr[0], "expect": expect,
            "budget_gb": budget_gb, "reckoning": {"replicated": rep,
                                                  "sharded": sh},
            "peak_bytes_by_rank": {"sharded": [r["peak_bytes"] for r in sr],
                                   "replicated": [r["peak_bytes"]
                                                  for r in rr]},
            "step_ms_by_rank": {"sharded": [r["step_ms_all"] for r in sr],
                                "replicated": [r["step_ms_all"]
                                               for r in rr]},
            "seconds": {"sharded": ss, "replicated": rs}}


def phase_shard(torch, ops, ref, train, card, replicated_params) -> dict:
    """Phase 12: (a) the sharded int8_fused run at world 1 at full width;
    (b) sharded == replicated bit for bit at world 4 on reduced gemma-2b,
    and the world-4 checkpoint restored at world 1 and replicated; (c)
    the planner's sharded arm at world 4, beside a replicated run of the
    same plan, then its kernels at its packed bucket lengths."""
    from repro_torch.launch.dist import destroy_group
    world1 = run_sharded(torch, ops, train, card, replicated_params)
    destroy_group()
    small = phase_shard_small(torch, card)
    world4 = phase_shard_world4(torch, card)
    check_auto_kernels(torch, ops, ref, world4["sharded"]["wire"], W4,
                       "sharded world 4", card)
    return {"world1": world1, "small": small, "world4": world4}


# ---------------------------------------------------------------------------
# 13. pipeline parallelism
# ---------------------------------------------------------------------------

PIPE_M = 4
PIPE_FLAGS = ["--sync", "comm", "--compressor", "int8_fused",
              "--parallelism", f"micro={PIPE_M}"]
# bytes held per parameter through the micro-batched step's sync: bf16
# params (2), Adam's f32 moments (8), the int8_fused EF residual (4), the
# f32 gradient accumulators (4) and the synced f32 gradients (4); plus
# one more f32 embedding (``pipe_reckoning``)
PIPE_BYTES_PER_PARAM = 22
# what the peak may hold above the reckoning: one micro-batch's
# activations and temporaries (1.14 GiB at (a) and none at (c) on an H100,
# PERF.md §6), with room, and well under the 9.3 GiB of a leaked f32 copy
# of the gradient tree
PIPE_PEAK_SLACK = 4 * 2**30
PIPE_SMALL_STEPS = 3
PIPE_SMALL_SESSION = dict(arch="gemma-2b", reduced=True, layers=4,
                          steps=PIPE_SMALL_STEPS, batch=8, seq=32, lr=3e-3,
                          warmup=1, seed=0, optimizer="adam")
PIPE_SMALL_WIRES = {   # name: SyncConfig kwargs (per-row buckets)
    "dense_psum": dict(),
    "int8_fused_ring": dict(compressor="int8_fused", algo="ring"),
    "topk_fused_ring": dict(compressor="topk_fused", algo="ring"),
}
PIPE_FREE_GIB = 8          # what (c)'s two ranks must leave of the card


def pipe_reckoning(cfg, layers: int, stages: int) -> tuple:
    """(parameters of one stage, bytes one stage's process holds through
    its sync): 22 B a parameter and one more f32 embedding (the second
    owner's accumulator of the tied table at S = 1; at S > 1 the pipe
    all-reduce's result beside its input)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.models import Model
    desc = Model(dataclasses.replace(cfg, num_layers=layers)).param_desc()
    total = sum(math.prod(d.shape) for d in tree_leaves(desc))
    rows = sum(math.prod(d.shape) for d in tree_leaves(desc["stack"]))
    emb = math.prod(desc["embed"]["table"].shape)
    per_stage = total - rows + rows // stages
    return per_stage, PIPE_BYTES_PER_PARAM * per_stage + 4 * emb


def pipe_session_config(layers: int):
    """The SessionConfig that ``TRAIN_ARGS`` give the CLI, at ``layers``."""
    from repro_torch.api import SessionConfig
    return SessionConfig(arch="gemma-2b", layers=layers, steps=TRAIN_STEPS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-3,
                         warmup=20, optimizer="adam", seed=0, device="cuda")


def stage_leaf_lengths(session) -> list:
    """The distinct lengths of the leaves a pipeline session's DP edge
    syncs, one bucket each: its per-row tree, as the step builds it."""
    from repro_torch.launch.steps import unstack_rows
    tree = {"shared": session._params["shared"],
            "rows": unstack_rows(session._params["rows"],
                                 session.staged.layout.rows_per_stage)}
    return sorted(set(bucket_lengths(session.synchronizer.plan, tree)))


def run_pipe_world1(torch, ops, train, card, replicated_params) -> dict:
    """Phase 13 (a): the degenerate pipe at full width through the CLI,
    ``--sync comm --compressor int8_fused --parallelism micro=4`` (NCCL
    world 1, Adam, batch 4 x seq 512, 3 steps), every kernel counter set
    to 0 just before and read just after: quantize_ef and dequant_accum
    once per layer-row leaf and step (164 = 2 shared + 18 x 9), all on
    the warp route, 0 for every other kernel; losses finite; the peak
    within the reckoning printed before the run; step times, tokens/s, a
    profiled step; the largest difference from phase 8's int8_fused
    parameters (printed, not gated: phase 8 fuses leaves into 32 MiB
    buckets, so its int8 tiles and scales are not these)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    cfg = get_config("gemma-2b")
    params, need = pipe_reckoning(cfg, cfg.num_layers, 1)
    print(f"pipeline memory reckoning [{card}]: the micro-batched int8_fused "
          f"step holds {PIPE_BYTES_PER_PARAM} B per parameter and one more "
          f"f32 embedding (the second owner's accumulator of the tied "
          f"table) = {need / 2**30:.2f} GiB for {params} parameters, 2 B "
          f"per parameter + the embedding more than phase 8's step; the "
          f"peak may add {PIPE_PEAK_SLACK / 2**30:.0f} GiB of activations "
          f"and temporaries; the card has {free / 2**30:.2f} GiB free of "
          f"{total / 2**30:.2f} GiB", flush=True)
    if need > free:
        fail(f"the pipeline run needs ~{need / 2**30:.2f} GiB, the card has "
             f"{free / 2**30:.2f} GiB free")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = train.main(TRAIN_ARGS + PIPE_FLAGS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if session.device.type != "cuda":
        fail(f"pipeline ran on {session.device}, not on the card")
    if session.staged is None or session.strategy.micro_batches != PIPE_M:
        fail("pipeline: the session did not build the micro-batched step")
    losses = list(session.losses)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"pipeline: losses {losses}")
    n_leaves = session.synchronizer.plan.n_buckets
    want_leaves = 2 + cfg.num_layers * 9
    if n_leaves != want_leaves:
        fail(f"pipeline: {n_leaves} per-row buckets, expected "
             f"{want_leaves} (2 shared + {cfg.num_layers} rows x 9)")
    for kname, count in launches.items():
        want = n_leaves * TRAIN_STEPS if kname in INT8_WIRE else 0
        if count != want:
            fail(f"pipeline: kernel {kname} launched {count} times, "
                 f"expected {want} (= {n_leaves} leaves x {TRAIN_STEPS} "
                 f"steps for quantize_ef and dequant_accum on the warp "
                 f"route, 0 for the others)")
    if peak > need + PIPE_PEAK_SLACK:
        fail(f"pipeline: peak {peak / 2**30:.3f} GiB above the reckoning "
             f"{need / 2**30:.2f} + {PIPE_PEAK_SLACK / 2**30:.0f} GiB")
    merged = tree_leaves(session.params)
    dmax = 0.0
    for p, r in zip(merged, replicated_params):
        dmax = max(dmax, (p.float() - r.to(p.device).float()).abs().max()
                   .item())
    times = [t * 1e3 for t in session.step_times]
    step_ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"losses": losses, "step_ms_all": times, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak,
           "reckoning_bytes": need, "n_buckets": n_leaves,
           "launches": launches, "run_s": seconds,
           "max_abs_diff_vs_phase8": dmax,
           "leaf_lengths": stage_leaf_lengths(session),
           "param_digests": [digest(torch, p).tolist() for p in merged]}
    del merged
    print(f"pipeline micro-batched world 1 [{card}]: {session.model_cfg.name}"
          f" bf16, batch {TRAIN_BATCH} x seq {TRAIN_SEQ} in {PIPE_M} "
          f"micro-batches, {TRAIN_STEPS} steps, int8_fused per layer row: "
          f"losses {[round(x, 4) for x in losses]}; step times "
          f"{[round(t, 1) for t in times]} ms (median of steps 2-"
          f"{TRAIN_STEPS} {step_ms:.3f}); tokens/s "
          f"{res['tokens_per_s']:.1f}; peak memory {peak / 2**30:.3f} GiB "
          f"(reckoning {need / 2**30:.2f} GiB + activations); {n_leaves} "
          f"per-row buckets; launches "
          f"{ {k: v for k, v in launches.items() if v} }; largest |Δ| of "
          f"the bf16 parameters from phase 8's int8_fused run {dmax:.6g} "
          f"(not gated); run {seconds:.1f} s", flush=True)
    res["profile"] = profile_round(torch, session, card, "pipeline")
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pipe_small_child(rank: int, world: int, store: str,
                     out_dir: str) -> None:
    """Phase 13 (b), one rank of 4 on a gloo group on the one card:
    reduced gemma-2b in f32 at 4 layers, M = 4, 3 steps, Adam, for each
    wire of ``PIPE_SMALL_WIRES``: S = 2 x dp 2 on the card (all 4 ranks),
    S = 1 x dp 2 on the card (a session on this rank's data group) and
    S = 2 x dp 2 on the CPU, from one set of weights.  Gates: the two
    card runs' losses, merged parameters, merged moments and EF residuals
    bit-equal, on every rank; the card within phase 4's tolerance of the
    CPU (losses 1e-5 relative at step 1, 1e-4 after)."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group, mesh_axes
    from repro_torch.models import Model
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    # this rank's data group of a pipe(2) x data(2) mesh: the S = 1 runs
    _, data = mesh_axes((2, world // 2))
    cfg = dataclasses.replace(reduced(get_config("gemma-2b")),
                              num_layers=PIPE_SMALL_SESSION["layers"])
    params0 = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    stage = rank // (world // 2)
    res = {"rank": rank, "compared": []}

    def equal(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def session(kw, dev, spec, group):
        sess = TrainSession(SessionConfig(device=dev, **PIPE_SMALL_SESSION),
                            strategy=make_strategy(
                                "every_step", group=group,
                                sync=SyncConfig(**kw), parallelism=spec),
                            params=params0, group=group)
        sess.run(PIPE_SMALL_STEPS)
        return sess

    ops.reset_launch_counts()
    for name, kw in PIPE_SMALL_WIRES.items():
        s2 = session(kw, "cuda", f"pp=2,micro={PIPE_M}", dist.group.WORLD)
        s1 = session(kw, "cuda", f"micro={PIPE_M}", data)
        cpu = session(kw, "cpu", f"pp=2,micro={PIPE_M}", dist.group.WORLD)
        p2, p1, pc = s2.params, s1.params, cpu.params
        e2 = s2.sync_state.get("error", [])
        e1 = s1.sync_state.get("error", [])
        n_shared = len(tree_leaves(s2._params["shared"]))
        n_row = len(e2) - n_shared
        mine = e1[stage * n_row:(stage + 1) * n_row] + e1[len(e1) - n_shared:]
        w4_gate(s2.losses == s1.losses, f"{name}: losses S=2 "
                f"{s2.losses} vs S=1 {s1.losses}")
        w4_gate(equal(p2, p1), f"{name}: parameters S=2 != S=1")
        w4_gate(equal(s2.full_opt_state(), s1.full_opt_state()),
                f"{name}: moments S=2 != S=1")
        w4_gate(len(e2) == len(mine) and all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(e2, mine)), f"{name}: EF residuals S=2 != S=1")
        rel = [abs(a - b) / abs(b) for a, b in zip(s2.losses, cpu.losses)]
        w4_gate(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4,
                f"{name}: card losses {s2.losses} vs CPU {cpu.losses}")
        dparam = max((a.float().cpu() - b.float()).abs().max().item()
                     for a, b in zip(tree_leaves(p2), tree_leaves(pc)))
        res["compared"].append({
            "wire": name, "losses": s2.losses, "cpu_losses": cpu.losses,
            "max_rel_loss": max(rel), "max_abs_param_vs_cpu": dparam,
            "ef_leaves": sum(e is not None for e in e2),
            "digests": [digest(torch, x).tolist() for x in tree_leaves(p2)]})
        del s2, s1, cpu, p2, p1, pc, e2, e1, mine
        gc.collect()
    res["launches"] = path_counts(ops)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_pipe_small(torch, card) -> dict:
    """Phase 13 (b): four spawned ranks of ``pipe_small_child``; their
    digests of the merged parameters must agree across the ranks."""
    ranks, seconds = spawn_world4(torch, pipe_small_child, "pipe_small", ())
    for i, c in enumerate(ranks[0]["compared"]):
        if any(r["compared"][i]["digests"] != c["digests"] for r in ranks):
            fail(f"pipeline world 4: the ranks' merged parameters differ "
                 f"({c['wire']})")
    compared = [{k: v for k, v in c.items() if k != "digests"}
                for c in ranks[0]["compared"]]
    print(f"pipeline S=1 == S=2 on the card [{card}]: reduced gemma-2b f32, "
          f"{PIPE_SMALL_SESSION['layers']} layers, M={PIPE_M}, "
          f"{PIPE_SMALL_STEPS} steps, Adam, 4 ranks on gloo: "
          f"{[c['wire'] for c in compared]} bit-equal between pipe(2) x "
          f"data(2) and S=1 x data(2) (losses, merged parameters and "
          f"moments, EF residuals) on every rank, and across the ranks; "
          f"card vs CPU: max rel loss "
          f"{[c['max_rel_loss'] for c in compared]}, max |Δparam| "
          f"{[c['max_abs_param_vs_cpu'] for c in compared]} "
          f"({seconds:.1f} s)", flush=True)
    return {"compared": compared, "seconds": seconds,
            "launches": ranks[0]["launches"]}


def pipe_big_child(rank: int, world: int, store: str, out_dir: str,
                   layers: int) -> None:
    """Phase 13 (c), one of the 2 stages: gemma-2b at full width with
    ``layers`` layers, pipe(2) x data(1) on a gloo group on the one card,
    M = 4, Adam, int8_fused, batch 4 x seq 512, 3 steps: this rank's
    launches (quantize_ef and dequant_accum once per leaf of its stage
    tree and step), peak from before the session's construction, the
    lengths of its DP edge's leaves, staged bytes split into the
    activation hops and the shared cells' pipe all-reduce, step times,
    and digests of the merged parameters."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.api import TrainSession
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.core.collectives import p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    group = dist.group.WORLD
    # the peak from before the session: its construction draws only this
    # stage's rows and makes only their moments
    torch.cuda.reset_peak_memory_stats()
    sess = TrainSession(pipe_session_config(layers), strategy=make_strategy(
        "every_step", group=group, sync=SyncConfig(compressor="int8_fused"),
        parallelism=f"pp=2,micro={PIPE_M}"), group=group)
    p2p.reset_staged_bytes()
    ops.reset_launch_counts()
    staged = []
    for _ in range(TRAIN_STEPS):
        sess.run(1)
        staged.append(dict(sess._sync.staged))
    torch.cuda.synchronize()
    launches = path_counts(ops)
    n_leaves = sess.synchronizer.plan.n_buckets
    w4_gate(sess.staged is not None and sess.staged.layout.n_stages == 2,
            "the session did not build a 2-stage pipe")
    w4_gate(all(map(math.isfinite, sess.losses)), f"losses {sess.losses}")
    w4_launch_gate(launches, {k: n_leaves * TRAIN_STEPS for k in INT8_WIRE},
                   "pipe stage")
    res = {"rank": rank, "launches": launches, "n_leaves": n_leaves,
           "losses": sess.losses,
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "leaf_lengths": stage_leaf_lengths(sess), "staged": staged}
    params = sess.params               # gathered over the pipe: collective
    if rank == 0:
        res["digests"] = [digest(torch, p).tolist()
                          for p in tree_leaves(params)]
    del params
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def run_pipe_reference(torch, layers: int) -> dict:
    """A world-1 S = 1 run of phase 13 (a)'s configuration at ``layers``
    layers (the reference of a depth-cut (c)): digests of its
    parameters."""
    from repro_torch._tree import tree_leaves
    from repro_torch.api import TrainSession
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.launch.dist import destroy_group
    session = TrainSession(pipe_session_config(layers),
                           strategy=make_strategy(
                               "every_step",
                               sync=SyncConfig(compressor="int8_fused"),
                               parallelism=f"micro={PIPE_M}"))
    session.run(TRAIN_STEPS)
    out = {"param_digests": [digest(torch, p).tolist()
                             for p in tree_leaves(session.params)]}
    del session
    destroy_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipe_big(torch, card, world1) -> dict:
    """Phase 13 (c): two stages of gemma-2b at full width on the one card.
    The depth is 18 if the reckoning leaves ``PIPE_FREE_GIB`` of the card
    free with both ranks, else cut (kept even) and printed.  Gates: each
    rank's launches, finite losses equal on both ranks, and the merged
    parameters bit-equal to a world-1 S = 1 run of the same depth and M —
    phase 13 (a)'s run at depth 18; each rank's peak, its construction
    included, within its stage's reckoning and ``PIPE_PEAK_SLACK``."""
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma-2b")
    free, total = torch.cuda.mem_get_info()
    layers = cfg.num_layers
    while True:
        per_stage, need = pipe_reckoning(cfg, layers, 2)
        if free - 2 * need >= PIPE_FREE_GIB * 2**30 or layers <= 2:
            break
        layers -= 2
    cut = "" if layers == cfg.num_layers else \
        f" (cut from {cfg.num_layers} so that both ranks fit)"
    print(f"pipeline S=2 memory reckoning [{card}]: {layers} layers{cut}, "
          f"{per_stage} parameters a stage, {need / 2**30:.2f} GiB a rank "
          f"through its sync, {2 * need / 2**30:.2f} GiB for both; the card "
          f"has {free / 2**30:.2f} GiB free of {total / 2**30:.2f}",
          flush=True)
    if free - 2 * need < PIPE_FREE_GIB * 2**30:
        fail(f"two pipeline stages need ~{2 * need / 2**30:.2f} GiB, the "
             f"card has {free / 2**30:.2f} GiB free")
    ranks, seconds = spawn_world4(torch, pipe_big_child, "pipe_big",
                                  (layers,), world=2)
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"pipeline S=2: the stages report different losses "
             f"{ranks[0]['losses']} vs {ranks[1]['losses']}")
    for r in ranks:
        if r["peak_bytes"] > need + PIPE_PEAK_SLACK:
            fail(f"pipeline S=2: rank {r['rank']} peak "
                 f"{r['peak_bytes'] / 2**30:.3f} GiB (construction "
                 f"included) above its stage's reckoning "
                 f"{need / 2**30:.2f} + {PIPE_PEAK_SLACK / 2**30:.0f} GiB")
    want = 2 + 9 * (layers // 2)
    if any(r["n_leaves"] != want for r in ranks):
        fail(f"pipeline S=2: {[r['n_leaves'] for r in ranks]} leaves a "
             f"stage, expected {want}")
    ref = world1 if layers == cfg.num_layers else \
        run_pipe_reference(torch, layers)
    if ranks[0]["digests"] != ref["param_digests"]:
        fail(f"pipeline S=2 at {layers} layers: the merged parameters differ "
             f"from the world-1 S=1 run's")
    hops = [sum(st["hops"] for st in r["staged"]) for r in ranks]
    pipe = [sum(st["pipe"] for st in r["staged"]) for r in ranks]
    print(f"pipeline S=2 [{card}]: gemma-2b full width, {layers} layers, "
          f"pipe(2) x data(1) on gloo, M={PIPE_M}, int8_fused, Adam, "
          f"{TRAIN_STEPS} steps: losses {ranks[0]['losses']} (both ranks); "
          f"merged parameters bit-equal to the world-1 S=1 run; launches "
          f"per rank {ranks[0]['launches'].get('quantize_ef')} quantize_ef "
          f"/ {ranks[0]['launches'].get('dequant_accum')} dequant_accum "
          f"(= {want} x {TRAIN_STEPS}, warp route); peak per rank, "
          f"construction included, "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB "
          f"(reckoning {need / 2**30:.2f} GiB); "
          f"staged per rank over {TRAIN_STEPS} steps: activation hops "
          f"{[round(h / 1e6, 3) for h in hops]} MB, the shared cells' "
          f"pipe all-reduce {[round(x / 1e9, 3) for x in pipe]} GB; step "
          f"times {[[round(t, 1) for t in r['step_ms_all']] for r in ranks]}"
          f" ms ({seconds:.1f} s)", flush=True)
    return {"layers": layers, "ranks": [
        {k: v for k, v in r.items() if k != "digests"} for r in ranks],
        "seconds": seconds, "launches": ranks[0]["launches"]}


def phase_pipe(torch, ops, ref, train, card, replicated_params) -> dict:
    """Phase 13: (a) the degenerate pipe at full width (world 1); (b)
    S = 1 == S = 2 bit for bit at world 4 on reduced gemma-2b and the card
    within tolerance of the CPU; (c) two stages at full width; then, with
    the card free, quantize_ef (residual in place) and dequant_accum (the
    gather wire at data world 1, as in (a) and (c)) bit-equal to their
    plain versions at every leaf length that (a) and (c) ran them at."""
    from repro_torch.launch.dist import destroy_group
    world1 = run_pipe_world1(torch, ops, train, card, replicated_params)
    destroy_group()
    small = phase_pipe_small(torch, card)
    big = phase_pipe_big(torch, card, world1)
    world1.pop("param_digests")
    lengths = sorted(set(world1["leaf_lengths"]).union(
        *(r["leaf_lengths"] for r in big["ranks"])))
    check_auto_kernels(torch, ops, ref,
                       [("int8_fused", {}, n) for n in lengths], 1,
                       "pipeline (a) and (c)", card)
    return {"world1": world1, "small": small, "big": big,
            "checked_lengths": lengths}


# ---------------------------------------------------------------------------
# 14. the MoE and MLA families
# ---------------------------------------------------------------------------

MOE_SERVE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")
# (a) and (b) serve at about half depth, for the call's time: their ticks
# and admissions are host-bound and scale with the layers, and every block
# kind (MLA's dense first layer, the MoE layers) stays on the path
MOE_SERVE_CUT = {"deepseek-v2-lite-16b": {"num_layers": 14},
                 "qwen3-moe-30b-a3b": {"num_layers": 24}}
# what a serving run's peak may hold above its reckoning (weights, pool and
# the largest transient): a prefill's and a tick's activations and logits
SERVE_ROOM = 2**30
MOE_TRAIN_ARCH = "qwen3-moe-30b-a3b"
# phase 8's measured peak per parameter (46.08 GiB over 2.51 B parameters
# with int8_fused and Adam, PERF.md §5): bf16 params and grads, Adam's f32
# moments, the EF residual and the synced f32 gradients
MOE_TRAIN_BYTES_PER_PARAM = 20
MOE_TRAIN_BUDGET = 70 * 2**30
MOE_TRAIN_ARGS = ["--arch", MOE_TRAIN_ARCH, "--no-reduced", "--optimizer",
                  "adam", "--batch", str(TRAIN_BATCH), "--seq",
                  str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--seed", "0",
                  "--log-every", "1", "--sync", "comm", "--compressor",
                  "int8_fused"]
# the prefill attention of the new families (bf16), all on the wgmma
# route: MLA's q/k head dim 128 + 64 = 192 with v padded from 128 to it,
# and qwen3-moe's GQA 32/4 at head dim 128; the serving path's prompt of
# 128 tokens, a ragged pair of 75, and (e)'s 4096
NEW_FLASH_SHAPES = {   # name: (B, T, H, KV, hd, v's width before padding)
    "deepseek_v2_lite_prefill": (1, 128, 16, 16, 192, 128),
    "deepseek_v2_lite_prefill_ragged": (2, 75, 16, 16, 192, 128),
    "deepseek_v2_lite_prefill_4096": (1, 4096, 16, 16, 192, 128),
    "qwen3_moe_prefill": (1, 128, 32, 4, 128, 128),
}
# how much faster than the SIMT kernel, timed in the same run, the wgmma
# route must be at MLA's prefill shapes (head dim 192)
MLA_SIMT_FACTORS = {"deepseek_v2_lite_prefill": 4.0,
                    "deepseek_v2_lite_prefill_4096": 20.0}
# (e): deepseek-v2-lite-16b served with phase 7's traffic at a 4096-token
# prompt: 4 requests of 4096 + 32 tokens through 4 slots, max_len 8192
MLA_LONG_ARCH, MLA_LONG_PROMPT = "deepseek-v2-lite-16b", 4096


def serve_args(arch: str) -> list:
    """Phase 5's traffic (SERVE_ARGS) for ``arch``."""
    args = list(SERVE_ARGS)
    args[args.index("--arch") + 1] = arch
    return args


def flash_route_of(cfg) -> str:
    """The flash route of a model's prefill: ``route`` of its compute
    dtype at its attention head dim (MLA's q/k head dim)."""
    from repro_torch.kernels.flash_attention import route
    from repro_torch.models.model import resolve_dtype
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.hd
    return route(resolve_dtype(cfg.compute_dtype), hd)


def serving_reckoning(cfg, slots: int = SLOTS, max_len: int = MAX_LEN,
                      prompt: int = 128) -> dict:
    """Bytes that ``cfg``'s full-width int8 serving run (``slots`` x
    ``max_len``, prompts of ``prompt`` tokens) holds at its peak, from its shapes: the bf16 weights;
    the int8 pool (codes and f32 scales per cached entry, the trash page
    included) and its per-slot recurrent state; and the largest transient,
    either the f32 draw of one leaf (one leading slice of a leaf above
    ``layers.SLICED_DRAW_ELEMENTS``) while the weights are made, a decode
    tick's gather of the k chosen experts' three matrices per slot, with
    a permuted copy for its einsum, a decode tick's gather of the int8
    pool into the linear cache (``PagedDecodeCache.gather``: while the
    largest leaf is dequantized, its int8 copy and three f32 temporaries
    — the codes, the repeated scales, their product — 13 bytes an entry,
    beside the bf16 linear caches of the other leaves), or an
    admission's prefill: the bf16 cache it emits for every layer at
    ``max_len`` before the pool takes it, and one layer's bf16 q, k, v
    and attention output at ``prompt``."""
    from repro_torch.models import Model, count_params
    from repro_torch.models.layers import SLICED_DRAW_ELEMENTS, desc_leaves
    pool = emitted = 0
    entries = []
    for _, m, shape, n_pages in paged_leaves_of(cfg, slots, max_len, PAGE):
        rest = shape[m.batch_axis + 2:]
        rows = (shape[0] if m.batch_axis == 1 else 1) * n_pages * PAGE * \
            math.prod(rest[:-1])
        pool += rows * rest[-1] + 4 * rows
        emitted += 2 * math.prod(shape) // slots
        entries.append(math.prod(shape))
    linear = (13 * max(entries) + 2 * (sum(entries) - max(entries))
              if entries else 0)
    state = state_bytes_of(cfg, slots, max_len)
    draws = []
    for d in desc_leaves(Model(cfg).param_desc()):
        n = math.prod(d.shape)
        draws.append(4 * (n // d.shape[0] if n > SLICED_DRAW_ELEMENTS else n))
    ff = cfg.moe_d_ff or cfg.d_ff
    gather = 2 * 3 * slots * cfg.top_k * cfg.d_model * ff * 2
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.hd
    prefill = emitted + 2 * 4 * prompt * cfg.num_heads * hd
    weights = 2 * count_params(cfg)
    return {"weights": weights, "pool": pool, "state": state,
            "draw": max(draws), "gather": gather, "linear": linear,
            "prefill": prefill,
            "total": weights + pool + state + max(max(draws), gather,
                                                  linear, prefill)}


def serve_checked(torch, ops, serve, card, cfg, args: list, rk: dict):
    """``serve.main(args, cfg)`` (``cfg``: the configuration served, at
    full width) with every kernel counter set to 0 just before and read
    just after, checked as the main path (flash on the wgmma route), the
    peak within the reckoning ``rk`` printed before the run (+
    SERVE_ROOM).  Returns (run, launches, peak bytes)."""
    arch = cfg.name
    print(f"serving {arch}: reckoning {rk['total'] / 1e9:.3f} GB = weights "
          f"{rk['weights'] / 1e9:.3f} GB (bf16) + int8 pool "
          f"{rk['pool'] / 1e9:.4f} GB + recurrent state "
          f"{rk['state'] / 1e9:.4f} GB + the largest transient of a leaf's "
          f"f32 draw ({rk['draw'] / 1e9:.3f} GB), a tick's expert gather "
          f"({rk['gather'] / 1e9:.3f} GB), a tick's gather of the pool "
          f"into the linear cache ({rk['linear'] / 1e9:.3f} GB) and an "
          f"admission's prefill ({rk['prefill'] / 1e9:.3f} GB); the peak "
          f"may hold {SERVE_ROOM / 2**30:.0f} GiB more", flush=True)
    if rk["total"] + SERVE_ROOM > torch.cuda.get_device_properties(
            0).total_memory:
        fail(f"serving {arch}: the reckoning does not fit the card")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve.main(args, cfg)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    if flash_route_of(run.cfg) != "wgmma":
        fail(f"{arch}: prefill attention on the {flash_route_of(run.cfg)} "
             f"route")
    check_main_path(torch, run, launches, card)
    if peak > rk["total"] + SERVE_ROOM:
        fail(f"serving {arch}: peak {peak / 1e9:.3f} GB beyond the reckoning "
             f"{rk['total'] / 1e9:.3f} GB + {SERVE_ROOM / 2**30:.0f} GiB")
    return run, launches, peak


def cut(arch: str, over: dict):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **over)


def run_full_width_serving(torch, ops, serve, card, arch: str,
                           over: dict = None) -> dict:
    """Phases 14 (a) / (b) and 15 (a) / (b): ``arch`` (its depth cut by
    ``over``, where given) served at full width with phase 5's traffic
    through :func:`serve_checked` (int8 paged KV, 4 slots, 8 requests of
    128 + 64 tokens), the peak within a reckoning printed before the run
    (weights, int8 pool, the per-slot recurrent state, the largest
    transient, + 1 GiB); then five profiled decode ticks (tick time,
    device-busy share, launches a tick)."""
    over = over or {}
    cfg = cut(arch, over)
    rk = serving_reckoning(cfg)
    print(f"serving {arch}: {cfg.num_layers} layers "
          f"({attention_layers(cfg)} with attention), "
          f"{cfg.num_params()} parameters; per-slot recurrent state "
          f"{rk['state'] / 1e6:.3f} MB for {SLOTS} slots", flush=True)
    run, launches, peak = serve_checked(torch, ops, serve, card, cfg,
                                        serve_args(arch), rk)
    eng = run.engines[0]
    res = {"layers": cfg.num_layers, "summary": run.summary,
           "seconds": run.seconds, "admissions": eng.prefills,
           "decode_ticks": eng.decode_ticks, "launches": launches,
           "peak_bytes": peak, "reckoning": rk,
           "params": cfg.num_params(),
           "attention_layers": attention_layers(cfg)}
    model, params, scfg, reqs = run.model, run.params, eng.cfg, run.requests
    del run, eng
    gc.collect()
    torch.cuda.empty_cache()
    res["profile"] = profile_ticks(torch, model, params, scfg, reqs, card,
                                   ticks=5)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    s, p = res["summary"], res["profile"]
    busy = p.get("busy_share")
    print(f"serving {arch} [{card}]: {res['params']} params bf16, "
          f"{res['layers']} layers; tokens/s={s['tokens_per_s']:.3f} mean "
          f"TTFT={s['mean_ttft_s'] * 1e3:.3f} ms p50 per-token latency="
          f"{s['p50_s'] * 1e3:.3f} ms; decode tick {p['tick_ms']:.3f} ms, "
          f"device busy "
          f"{'not measured' if busy is None else f'{busy:.4f}'} of it, "
          f"{p.get('launches_per_tick', 'not measured')} launches a tick; "
          f"flash {launches['flash_attention']} launches (wgmma "
          f"{launches['flash_attention[wgmma]']}), quantize_tiles "
          f"{launches['quantize_tiles']} (warp "
          f"{launches['quantize_tiles[warp]']}); peak {peak / 1e9:.3f} GB "
          f"within the reckoning {rk['total'] / 1e9:.3f} GB + "
          f"{SERVE_ROOM / 2**30:.0f} GiB (serve run {res['seconds']:.2f} s)",
          flush=True)
    return res


# flash's kernels (both routes and the pre-pass), by their names in the
# profiler's events
FLASH_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel",
                 "nonfinite_tiles_kernel")


def run_mla_long_serving(torch, ops, serve, card, simt_ms: float) -> dict:
    """Phase 14 (e): deepseek-v2-lite-16b served at full width with phase
    7's traffic at MLA_LONG_PROMPT tokens (4 requests of 4096 + 32 through
    4 slots, max_len 8192) through :func:`serve_checked`: every request
    admitted once, so flash launches 27 x 4 times, all on wgmma.  Then one
    4096-token admission (``model.prefill``) timed alone (host clock
    around synchronised calls, median of 3) and once under
    ``torch.profiler`` (flash's device time and share), beside the
    reckoned SIMT cost of the same admission: the layers x ``simt_ms``,
    (d)'s SIMT kernel time at T = 4096."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = list(GEMMA2_SERVE_ARGS)
    args[args.index("--arch") + 1] = MLA_LONG_ARCH
    args[args.index("--prompt-len") + 1] = str(MLA_LONG_PROMPT)
    cfg = cut(MLA_LONG_ARCH, {})
    rk = serving_reckoning(cfg, GEMMA2_SLOTS, GEMMA2_MAX_LEN, MLA_LONG_PROMPT)
    run, launches, peak = serve_checked(torch, ops, serve, card, cfg, args,
                                        rk)
    eng, cfg = run.engines[0], run.cfg
    if eng.prefills != len(run.requests):
        fail(f"{MLA_LONG_ARCH} long prompts: {eng.prefills} admissions for "
             f"{len(run.requests)} requests")
    prompt = torch.as_tensor(run.requests[0].prompt,
                             device=eng.device).long()[None]

    def admit():
        return run.model.prefill(run.params, {"tokens": prompt},
                                 max_len=eng.cfg.max_len)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    flash_us = sum(e.time_range.elapsed_us() for e in kernels
                   if any(k in e.name for k in FLASH_KERNELS))
    res = {"summary": run.summary, "seconds": run.seconds,
           "admissions": eng.prefills, "decode_ticks": eng.decode_ticks,
           "launches": launches, "peak_bytes": peak, "reckoning": rk,
           "prompt": MLA_LONG_PROMPT,
           "admission_s": statistics.median(times),
           "admission_s_all": times, "profiled_admission_ms": wall * 1e3,
           "busy_ms": busy_us / 1e3 if kernels else None,
           "flash_ms": flash_us / 1e3 if kernels else None,
           "simt_reckoned_ms": cfg.num_layers * simt_ms}
    s = run.summary
    measured = ("the profiler recorded no device events (not measured)"
                if not kernels else
                f"profiled {wall * 1e3:.3f} ms, device busy "
                f"{busy_us / 1e3:.3f} ms, flash with its pre-pass "
                f"{flash_us / 1e3:.3f} ms = {flash_us / busy_us:.4f} of the "
                f"busy time")
    print(f"serving {MLA_LONG_ARCH} long prompts [{card}]: "
          f"tokens/s={s['tokens_per_s']:.3f} mean TTFT="
          f"{s['mean_ttft_s'] * 1e3:.3f} ms; peak {peak / 1e9:.3f} GB within "
          f"the reckoning {rk['total'] / 1e9:.3f} GB + "
          f"{SERVE_ROOM / 2**30:.0f} GiB (serve run {run.seconds:.2f} s); "
          f"one {MLA_LONG_PROMPT}-token admission "
          f"{res['admission_s'] * 1e3:.3f} ms (median of "
          f"{[round(t * 1e3, 1) for t in times]}), {measured}; on the SIMT "
          f"route its flash would take {cfg.num_layers} x "
          f"{simt_ms * 1e3:.3f} us = {res['simt_reckoned_ms']:.3f} ms "
          f"(reckoned from (d))", flush=True)
    del run, eng, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_moe_training(torch, ops, train, card) -> dict:
    """Phase 14 (c): qwen3-moe-30b-a3b at full width and cut depth (4
    layers when MOE_TRAIN_BYTES_PER_PARAM x the parameters fits
    MOE_TRAIN_BUDGET, else 2), Adam, ``--sync comm --compressor
    int8_fused``, NCCL world 1, 3 steps: the session is built from the
    CLI's flags by the CLI's own ``fixed_strategy``, with the depth cut.
    Gates: quantize_ef and dequant_accum = buckets x steps, on the warp
    route, every other kernel 0; losses finite; the drop tap routed every
    choice once per forward.  Prints the CLI's ``moe capacity:`` line,
    step times, tokens/s, the peak and a profiled step."""
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import destroy_group
    from repro_torch.launch.report import render_moe_drops
    from repro_torch.models import count_params
    cfg = get_config(MOE_TRAIN_ARCH)

    def reckon(layers):
        return MOE_TRAIN_BYTES_PER_PARAM * count_params(
            dataclasses.replace(cfg, num_layers=layers))
    layers = 4 if reckon(4) <= MOE_TRAIN_BUDGET else 2
    n_params = reckon(layers) // MOE_TRAIN_BYTES_PER_PARAM
    print(f"training {MOE_TRAIN_ARCH}: {layers} of {cfg.num_layers} layers "
          f"(reduced depth; widths full): reckoning "
          f"{MOE_TRAIN_BYTES_PER_PARAM} B x {n_params} parameters = "
          f"{reckon(layers) / 2**30:.3f} GiB (4 layers: "
          f"{reckon(4) / 2**30:.3f} GiB, budget "
          f"{MOE_TRAIN_BUDGET / 2**30:.0f} GiB)", flush=True)
    args = train.build_parser().parse_args(MOE_TRAIN_ARGS)
    par = train.resolve_cli_parallelism(args)
    strategy = train.fixed_strategy(args, train.scheduler_from_args(args),
                                    par, None)
    destroy_group()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = TrainSession(SessionConfig(
        arch=args.arch, layers=layers, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device="cuda"),
        strategy=strategy)
    session.run(args.steps, log_every=args.log_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if session.device.type != "cuda":
        fail(f"MoE training ran on {session.device}, not on the card")
    losses = list(session.losses)
    if len(losses) != args.steps or not all(map(math.isfinite, losses)):
        fail(f"MoE training: losses {losses}")
    n_buckets = session.synchronizer.plan.n_buckets
    wire = ("quantize_ef", "dequant_accum", "dequant_accum[warp]")
    for kname, count in launches.items():
        want = n_buckets * args.steps if kname in wire else 0
        if count != want or (kname in wire and want <= 0):
            fail(f"MoE training: kernel {kname} launched {count} times, "
                 f"expected {want} (= {n_buckets} buckets x {args.steps} "
                 f"steps for quantize_ef and dequant_accum on the warp "
                 f"route, 0 for the others)")
    mcfg = session.model_cfg
    routed = args.steps * layers * args.batch * args.seq * mcfg.top_k
    if session.routed_tokens != routed:
        fail(f"MoE training: the drop tap routed {session.routed_tokens} "
             f"token-choices, expected {routed} (steps x layers x tokens x "
             f"top_k: each choice once per forward)")
    print(render_moe_drops(session.dropped_tokens, session.routed_tokens,
                           mcfg.capacity_factor), flush=True)
    times = session.step_times
    step_ms = statistics.median(times[1:]) * 1e3
    res = {"layers": layers, "losses": losses, "step_ms": step_ms,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": args.batch * args.seq / (step_ms / 1e3),
           "peak_bytes": peak, "n_buckets": n_buckets,
           "launches": launches, "run_s": seconds,
           "params": session.num_params(),
           "dropped": session.dropped_tokens, "routed": session.routed_tokens,
           "reckoning_bytes": reckon(layers),
           "lengths": sorted(set(bucket_lengths(session.synchronizer.plan,
                                                session.params)))}
    print(f"training {MOE_TRAIN_ARCH} [{card}]: {layers} layers, "
          f"{res['params']} params bf16, batch {args.batch} x seq "
          f"{args.seq}, losses {[round(x, 4) for x in losses]}; step time "
          f"(median of steps 2-{args.steps}) {step_ms:.3f} ms, all steps "
          f"{[round(t, 1) for t in res['step_ms_all']]} ms; tokens/s "
          f"{res['tokens_per_s']:.1f}; peak {peak / 2**30:.3f} GiB "
          f"(reckoning {reckon(layers) / 2**30:.3f}); {n_buckets} buckets; "
          f"launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    prof = profile_step(torch, session, card, "moe_int8_fused")
    if prof.get("busy_share") is not None:
        prof["host_ms"] = prof["wall_ms"] - prof["busy_ms"]
        prof["other_device_ms"] = prof["busy_ms"] - prof["wire_kernel_ms"]
        print(f"profile moe_int8_fused [{card}]: {prof['wall_ms']:.3f} ms = "
              f"wire kernels {prof['wire_kernel_ms']:.3f} + other device "
              f"work {prof['other_device_ms']:.3f} + host (the rest) "
              f"{prof['host_ms']:.3f} ms", flush=True)
    res["profile"] = prof
    del session
    gc.collect()
    torch.cuda.empty_cache()
    destroy_group()
    return res


def new_flash_kernels(torch, ops, ref, flash_cuda, tiles_cuda) -> dict:
    """Phase 14 (d), flash: at NEW_FLASH_SHAPES in bf16, through
    ``ops.flash_attention`` on the route ``route`` gives (wgmma, at MLA's
    head dim 192 as at qwen3-moe's 128), held to the plain version within
    :func:`flash_close` and, with a NaN in v at a key in the last key
    tile, which the first query tile skips, NaN exactly where the plain
    version has NaN; at MLA's shapes the SIMT kernel too, by direct call,
    held the same way.  Then kernel (pre-pass included), plain and SDPA
    times in turns and the bound; the wgmma route must be
    MLA_SIMT_FACTORS faster than the SIMT kernel.  Returns {route: {shape
    name: timing}}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import route
    out = {"simt": {}, "wgmma": {}}
    for i, (name, (B, T, H, KV, hd, vw)) in enumerate(
            NEW_FLASH_SHAPES.items()):
        r = route(torch.bfloat16, hd)
        if r != "wgmma":
            fail(f"flash_attention at {name}: bf16 at head dim {hd} routed "
                 f"to {r}")
        q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, torch.bfloat16,
                               500 + i)
        v[..., vw:] = 0.0                 # MLA's zero padding of v
        vn = v.clone()
        vn[0, T - 5, 1, 5] = float("nan")       # skipped by rows < 64
        want = ref.flash_attention_ref(q, k, v)
        wn = ref.flash_attention_ref(q, k, vn)
        if not torch.isnan(wn).any():
            fail(f"flash_attention at {name}: the plain version has no NaN")
        routes = ["wgmma"] + (["simt"] if hd == 192 else [])
        held = {}
        for kernel in routes:
            r0 = ops.route_counts()["flash_attention"][kernel]
            if kernel == "wgmma":
                got = ops.flash_attention(q, k, v, causal=True)
                gn = ops.flash_attention(q, k, vn, causal=True)
            else:
                got = flash_cuda(q, k, v, tiles_cuda(v), True, None, None,
                                 "simt")
                gn = flash_cuda(q, k, vn, tiles_cuda(vn), True, None, None,
                                "simt")
            torch.cuda.synchronize()
            if ops.route_counts()["flash_attention"][kernel] != r0 + 2 * (
                    kernel == "wgmma"):
                fail(f"flash_attention at {name} did not take the {kernel} "
                     f"route")
            ok, err, share = flash_close(torch, got, want)
            if not ok:
                fail(f"flash_attention ({kernel}) differs from the plain "
                     f"version at {name}: max err {err}, {share:.3f} of the "
                     f"tolerance")
            if not torch.equal(torch.isnan(gn), torch.isnan(wn)):
                fail(f"flash_attention ({kernel}) NaN rule broken at {name}")
            held[kernel] = (err, share)
            del got, gn
        del vn, wn

        def timed(kernel):
            return lambda: flash_cuda(q, k, v, tiles_cuda(v), True, None,
                                      None, kernel)

        def plain():
            return ref.flash_attention_ref(q, k, v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        timer = loop_ms if T > 1024 else device_ms
        plain_ms, k_ms = time_turns(torch, timer, plain,
                                    [timed(kn) for kn in routes])
        lib_ms = min(timer(torch, library), timer(torch, library))
        lib_err = (library().float() - want.float()).abs().max().item()
        b_ms, by, n_ops, nbytes = flash_bound(B, T, T, H, KV, hd, 2, {})
        timer_note = ("cuda events, 5 eager calls back to back"
                      if T > 1024 else "cuda graph")
        for kernel, ms in zip(routes, k_ms):
            err, share = held[kernel]
            out[kernel][name] = {
                "shape": [B, T, H, KV, hd], "dtype": "bfloat16",
                "v_width_before_padding": vw, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "ops": n_ops,
                "bytes": nbytes, "tflops": n_ops / ms / 1e9,
                "library_ms": lib_ms,
                "library_note": "F.scaled_dot_product_attention(is_causal, "
                                "enable_gqa)",
                "library_max_abs_err": lib_err, "max_abs_err_bf16": err,
                "share_of_tolerance_bf16": share, "includes_prepass": True,
                "timer": timer_note}
            print(f"flash_attention {kernel} route {name} "
                  f"{[B, T, H, KV, hd]} bf16: within tolerance ({share:.4f} "
                  f"of it), NaN rule held; device time kernel with its "
                  f"pre-pass {ms * 1e3:.3f} us ({n_ops / ms / 1e9:.2f} "
                  f"TFLOP/s), plain {plain_ms * 1e3:.3f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({by}), {b_ms / ms:.4f} of the bound,"
                  f" library {lib_ms * 1e3:.3f} us by SDPA (kernel / SDPA "
                  f"{ms / lib_ms:.3f}) [{timer_note}]", flush=True)
        if name in MLA_SIMT_FACTORS:
            w, sm = out["wgmma"][name]["ms"], out["simt"][name]["ms"]
            if MLA_SIMT_FACTORS[name] * w > sm:
                fail(f"flash_attention wgmma at {name}: {w * 1e3:.3f} us, "
                     f"not {MLA_SIMT_FACTORS[name]}x faster than the SIMT "
                     f"kernel's {sm * 1e3:.3f} us in this run")
            print(f"flash gate: at {name} the wgmma route is {sm / w:.2f}x "
                  f"faster than the SIMT kernel (at least "
                  f"{MLA_SIMT_FACTORS[name]}x), SDPA / wgmma "
                  f"{lib_ms / w:.3f}", flush=True)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    return out


def phase_small_moe_mla(torch, card) -> None:
    """Phase 14, small references on the card in f32 (TF32 off): for both
    new MoE families at reduced size, ``moe_ffn`` at capacity factor 0.5
    on the card and on the CPU from the same weights and inputs — the same
    expert choices and the same keep mask, the outputs within 1e-4 of the
    largest |output| (phase 4's tolerance); phase 4's prefill + four
    vector-position decode steps, card against CPU; and MLA's naive and
    absorbed decodes on the card within the same tolerance of each
    other."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    for arch in MOE_SERVE_ARCHS:
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  capacity_factor=0.5)
        params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
        seg = next(i for i, s in enumerate(cfg.stack_plan())
                   if s.period[0].ffn == "moe")
        ffn = params["stack"][seg][0]["ffn"]
        if cfg.stack_plan()[seg].repeats > 1:
            ffn = tree_map(lambda t: t[0], ffn)
        g = torch.Generator("cpu").manual_seed(1)
        ffn = dict(ffn, router=torch.randn(ffn["router"].shape, generator=g))
        x = torch.randn((2, 64, cfg.d_model), generator=g)
        res = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), ffn)
            xd = x.to(dev)
            _, experts, _ = moe_mod._route(cfg, xd.reshape(-1, cfg.d_model)
                                           @ p["router"])
            N, k, E = 128, cfg.top_k, cfg.num_experts
            cap = int(max(1, N * k / E * cfg.capacity_factor))
            _, keep = moe_mod.dispatch_plan(experts, E, 1, cap)
            out, aux = moe_mod.moe_ffn(p, cfg, xd)
            res[dev] = (experts.cpu(), keep.cpu(), out.cpu(), aux.cpu())
        (ec, kc, oc, ac), (eg, kg, og, ag) = res["cpu"], res["cuda"]
        err = (og - oc).abs().max().item()
        scale = oc.abs().max().item()
        if not (torch.equal(ec, eg) and torch.equal(kc, kg)):
            bad = (kc != kg).nonzero()[:4].tolist()
            fail(f"{arch} reduced: moe_ffn routes or keeps differently on the "
                 f"card, e.g. (group, choice) {bad}")
        if not (err <= 1e-4 * scale and abs(ag.item() - ac.item())
                <= 1e-4 * abs(ac.item())):
            fail(f"{arch} reduced: moe_ffn on the card differs from the CPU "
                 f"path: max|Δ| {err} vs 1e-4·{scale}")
        print(f"small reference: reduced {arch} f32 moe_ffn at capacity "
              f"factor 0.5, card vs CPU: expert choices and keep mask equal "
              f"({int((~kc).sum())} of {kc.numel()} choices dropped), "
              f"max|Δout| {err:.3e} (max|out| {scale:.3e})", flush=True)
        phase_small_reference(torch, arch, MOE_SMALL_REFS)
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    model = Model(cfg)
    params = tree_map(lambda t: t.to("cuda"), model.init(
        torch.Generator("cpu").manual_seed(0)))
    g = torch.Generator("cpu").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g).cuda()
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=24)
    tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g).cuda()
    pos = torch.tensor([16, 13], device="cuda")
    naive, _ = model.decode_step(params, tok, cache, pos, mla_absorb=False)
    absorbed, _ = model.decode_step(params, tok, cache, pos, mla_absorb=True)
    err = (naive - absorbed).abs().max().item()
    scale = naive.abs().max().item()
    if not (torch.isfinite(absorbed).all() and err <= 1e-4 * scale):
        fail(f"MLA absorbed decode differs from the naive one on the card: "
             f"max|Δ| {err} vs 1e-4·{scale}")
    print(f"small reference: reduced deepseek-v2-lite-16b f32 on the card, "
          f"MLA naive vs absorbed decode (vector positions) max|Δlogit| "
          f"{err:.3e} (max|logit| {scale:.3e})", flush=True)


MOE_SMALL_REFS = {   # arch: (config overrides, prompt length, max_len)
    "deepseek-v2-lite-16b": ({}, 16, 24),
    "qwen3-moe-30b-a3b": ({}, 16, 24),
}


def phase_moe(torch, ops, ref, serve, train, card, flash_cuda,
              tiles_cuda) -> dict:
    """Phase 14: (d) flash at the new families' shapes and the small
    references (the card free; phase 3 holds quantize_tiles at their
    pools' lengths), then (a) deepseek-v2-lite-16b and (b)
    qwen3-moe-30b-a3b served at full width, (c) qwen3-moe-30b-a3b trained
    at full width and cut depth, and quantize_ef / dequant_accum bit-equal
    at every bucket length of (c), timed at its largest (an expert leaf),
    and (e) deepseek-v2-lite-16b served with 4096-token prompts."""
    t0 = time.perf_counter()
    print(f"phase 14: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated at its start", flush=True)
    flash = new_flash_kernels(torch, ops, ref, flash_cuda, tiles_cuda)
    phase_small_moe_mla(torch, card)
    serving = {arch: run_full_width_serving(torch, ops, serve, card, arch,
                                            MOE_SERVE_CUT[arch])
               for arch in MOE_SERVE_ARCHS}
    training = run_moe_training(torch, ops, train, card)
    lengths = training["lengths"]
    wire = train_path_kernels(torch, ops, ref, lengths,
                              {"qwen3_moe_expert_bucket": max(lengths)})
    long = run_mla_long_serving(
        torch, ops, serve, card,
        flash["simt"]["deepseek_v2_lite_prefill_4096"]["ms"])
    seconds = time.perf_counter() - t0
    print(f"phase 14 took {seconds:.1f} s", flush=True)
    return {"flash": flash, "serving": serving, "training": training,
            "wire": wire, "long": long, "seconds": seconds}


# ---------------------------------------------------------------------------
# 15. the last three families: Mamba (jamba), xLSTM, the encoder-decoder
# ---------------------------------------------------------------------------

# (a): jamba-v0.1-52b at full width cut to 16 of its 32 layers, for memory
# (32 layers are 51.57 B parameters = 103.1 GB in bf16; 16 are two 8-layer
# Jamba blocks = 26.05 B = 52.1 GB): one segment of period 8 x 2 repeats,
# so stacked state and paged leaves appear as at full depth (x 4)
JAMBA_ARCH, JAMBA_CUT = "jamba-v0.1-52b", {"num_layers": 16}
XLSTM_ARCH = "xlstm-125m"
SEAMLESS_ARCH = "seamless-m4t-large-v2"
# (c): one-shot generate at full width, bf16 frames (Model.input_specs's
# dtype): batch 4, 512 frames, 32-token prompts, 64 new tokens
SEAMLESS_BATCH, SEAMLESS_FRAMES = 4, 512
SEAMLESS_PROMPT, SEAMLESS_GEN = 32, 64
# (d): the CLI's one-shot path with the f32 frames it draws, full width
# cut to 2 + 2 layers
SEAMLESS_F32_CUT = {"num_layers": 2, "num_encoder_layers": 2}
SEAMLESS_F32_ARGS = ["--arch", SEAMLESS_ARCH, "--no-reduced", "--batch",
                     "4", "--prompt-len", "32", "--gen", "8", "--seed", "0"]
# (e): xlstm-125m trained at full width and 4 of its 12 layers (one
# period: 3 mLSTM + 1 sLSTM), for time: its recurrences run as eager loops,
# ~43k launches a layer and step with the remat's recomputes
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_LAYERS = 256, 4
XLSTM_TRAIN_ARGS = ["--arch", XLSTM_ARCH, "--no-reduced", "--optimizer",
                    "adam", "--batch", str(TRAIN_BATCH), "--seq",
                    str(XLSTM_TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
                    "--seed", "0", "--log-every", "1", "--sync", "comm",
                    "--compressor", "int8_fused"]
# phase 3: the encoder-decoder's flash shapes, T queries against S keys.
# (c), 512 bf16 frames: the encoder (T = S = 512), the cross-attention at
# prefill (the 32-token prompt) and at decode (T = 1), non-causal, and the
# decoder's causal self-attention at the prompt (also (d)'s, in bf16).
# (d), as many f32 frames as prompt tokens (32): the encoder, whose shape
# is also the cross-attention's at prefill, and the cross-attention at
# decode
ENCDEC_FLASH_SHAPES = {   # name: (B, T, S, H, KV, hd, causal)
    "seamless_encoder": (4, 512, 512, 16, 16, 64, False),
    "seamless_cross_prefill": (4, 32, 512, 16, 16, 64, False),
    "seamless_cross_decode": (4, 1, 512, 16, 16, 64, False),
    "seamless_decoder_self_prefill": (4, 32, 32, 16, 16, 64, True),
    "seamless_encoder_32_frames": (4, 32, 32, 16, 16, 64, False),
    "seamless_cross_decode_32_frames": (4, 1, 32, 16, 16, 64, False),
}
NEW_SMALL_REFS = {   # arch: (config overrides, prompt length, max_len)
    JAMBA_ARCH: ({}, 16, 24),
    XLSTM_ARCH: ({}, 16, 24),
}


def encdec_flash_kernels(torch, ops, ref, flash_cuda, tiles_cuda) -> dict:
    """Phase 3, the encoder-decoder's flash shapes (ENCDEC_FLASH_SHAPES,
    hd 64): through ``ops.flash_attention`` in bf16 (the wgmma route, the
    path of 15 (c) and of (d)'s decoder) and in f32 (the SIMT route, the
    path of (d)'s encoder and cross-attention), each held to the plain
    version within :func:`flash_close`, each launch on its route; then
    kernel (pre-pass included), plain and SDPA times in turns (graph
    replay) and the bound.  Returns {route: {name: timing}}, the f32 rows
    named with ``_f32``."""
    import torch.nn.functional as F
    out = {"wgmma": {}, "simt": {}}
    for i, (name, (B, T, S, H, KV, hd, causal)) in enumerate(
            ENCDEC_FLASH_SHAPES.items()):
        for dtype, kernel in ((torch.bfloat16, "wgmma"),
                              (torch.float32, "simt")):
            q, k, v = flash_inputs(torch, B, T, S, H, KV, hd, dtype, 700 + i)
            r0 = ops.route_counts()["flash_attention"][kernel]
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if ops.route_counts()["flash_attention"][kernel] != r0 + 1:
                fail(f"flash_attention at {name} {dtype} did not take the "
                     f"{kernel} route")
            ok, err, share = flash_close(torch, got, want)
            if not ok:
                fail(f"flash_attention ({kernel}) differs from the plain "
                     f"version at {name} {dtype}: max err {err}, "
                     f"{share:.3f} of the tolerance")

            def timed():
                return flash_cuda(q, k, v, tiles_cuda(v), causal, None, None,
                                  kernel)

            def plain():
                return ref.flash_attention_ref(q, k, v, causal=causal)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal).transpose(1, 2)
            plain_ms, (k_ms,) = time_turns(torch, device_ms, plain, [timed])
            lib_ms = min(device_ms(torch, library), device_ms(torch, library))
            lib_err = (library().float() - want.float()).abs().max().item()
            elt = 2 if dtype == torch.bfloat16 else 4
            b_ms, by, n_ops, nbytes = flash_bound(B, T, S, H, KV, hd, elt,
                                                  {"causal": causal})
            row = name if kernel == "wgmma" else f"{name}_f32"
            dname = str(dtype).split(".")[-1]
            out[kernel][row] = {
                "shape": [B, T, S, H, KV, hd], "dtype": dname,
                "causal": causal, "ms": k_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "ops": n_ops,
                "bytes": nbytes, "tflops": n_ops / k_ms / 1e9,
                "library_ms": lib_ms,
                "library_note": "F.scaled_dot_product_attention("
                                f"is_causal={causal})",
                "library_max_abs_err": lib_err, "max_abs_err": err,
                "share_of_tolerance": share, "includes_prepass": True,
                "timer": "cuda graph"}
            print(f"flash_attention {kernel} route {row} q {[B, T, H, hd]} "
                  f"k/v {[B, S, KV, hd]} {dname} "
                  f"{'causal' if causal else 'non-causal'}: within "
                  f"tolerance ({share:.4f} of it); device time kernel with "
                  f"its pre-pass {k_ms * 1e3:.3f} us, plain "
                  f"{plain_ms * 1e3:.3f} us, bound {b_ms * 1e3:.3f} us "
                  f"({by}), {b_ms / k_ms:.4f} of the bound, library "
                  f"{lib_ms * 1e3:.3f} us by SDPA (kernel / SDPA "
                  f"{k_ms / lib_ms:.3f}) [cuda graph]", flush=True)
            del q, k, v, qt, kt, vt, got, want
    torch.cuda.empty_cache()
    return out


def phase_small_new_families(torch, card) -> None:
    """Phase 15, small references on the card in f32 (TF32 off): at
    reduced size, from the same weights and inputs on the card and on the
    CPU, ``mamba_forward`` (with its state) and two ``mamba_decode``
    steps, the same for ``mlstm_*`` and ``slstm_*``, and seamless's
    ``encode`` with ``Model.prefill`` and one decode step, each within
    1e-4 of the largest |output| (phase 4's tolerance); then phase 4's
    prefill + four vector-position decode steps for jamba and xlstm."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.models import ssm, xlstm

    def held(what, cpu, gpu):
        a, b = tree_leaves(cpu), [t.cpu() for t in tree_leaves(gpu)]
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(a, b))
        scale = max(x.float().abs().max().item() for x in a)
        if not (all(torch.isfinite(y.float()).all() for y in b)
                and err <= 1e-4 * scale):
            fail(f"{what} on the card differs from the CPU path: max|Δ| "
                 f"{err} vs 1e-4·{scale}")
        print(f"small reference: {what} f32, card vs CPU max|Δ| {err:.3e} "
              f"(max|out| {scale:.3e})", flush=True)

    def recurrent(arch, mixer, fwd, dec):
        cfg = reduced(get_config(arch))
        params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
        i = [s.mixer for s in cfg.stack_plan()[0].period].index(mixer)
        p = params["stack"][0][i]["mixer"]
        g = torch.Generator("cpu").manual_seed(3)
        x = torch.randn((2, 16, cfg.d_model), generator=g)
        steps = [torch.randn((2, 1, cfg.d_model), generator=g)
                 for _ in range(2)]
        res = {}
        for dev in ("cpu", "cuda"):
            pd = tree_map(lambda t: t.to(dev), p)
            out, st = fwd(pd, cfg, x.to(dev), return_state=True)
            outs = [out]
            for xt in steps:
                o, st = dec(pd, cfg, xt.to(dev), st)
                outs.append(o)
            res[dev] = (outs, st)
        held(f"reduced {arch} {mixer} forward + state + 2 decode steps",
             res["cpu"], res["cuda"])

    recurrent(JAMBA_ARCH, "mamba", ssm.mamba_forward, ssm.mamba_decode)
    recurrent(XLSTM_ARCH, "mlstm", xlstm.mlstm_forward, xlstm.mlstm_decode)
    recurrent(XLSTM_ARCH, "slstm", xlstm.slstm_forward, xlstm.slstm_decode)

    from repro_torch.models import encdec
    cfg = reduced(get_config(SEAMLESS_ARCH))
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    g = torch.Generator("cpu").manual_seed(4)
    src = torch.randn((2, 24, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        memory = encdec.encode(p["encdec"], cfg, src.to(dev))
        logits, cache = model.prefill(p, {"tokens": tokens.to(dev),
                                          "src": src.to(dev)}, max_len=12)
        step, _ = model.decode_step(p, tok.to(dev), cache, 8)
        res[dev] = [memory, logits, step]
    held(f"reduced {SEAMLESS_ARCH} encode + prefill + 1 decode step",
         res["cpu"], res["cuda"])
    for arch in NEW_SMALL_REFS:
        phase_small_reference(torch, arch, NEW_SMALL_REFS)


def seamless_cache_bytes(cfg, batch: int, max_len: int, src_len: int,
                         elt: int) -> int:
    """Bytes of the encoder-decoder's decode cache: the self K/V at
    ``max_len`` and the cross K/V at ``src_len``, every decoder layer."""
    per = 2 * cfg.num_kv_heads * cfg.hd * elt * batch
    return cfg.num_layers * per * (max_len + src_len)


def run_seamless_oneshot(torch, ops, serve, card) -> dict:
    """Phase 15 (c): seamless-m4t-large-v2 at full width (24 + 24 layers),
    bf16 weights from seed 0, one-shot ``generate`` of SEAMLESS_GEN tokens
    for SEAMLESS_BATCH prompts of SEAMLESS_PROMPT tokens over
    SEAMLESS_FRAMES bf16 frames, with every kernel counter set to 0 just
    before and read just after.  Gates: flash = 72 at the prefill (24
    encoder, 24 decoder self, 24 cross layers) + 24 (cross, T = 1) per
    decode step, all on wgmma, and its pre-pass as often; no other kernel;
    finite prefill logits; the peak within a reckoning printed before the
    run (weights, three copies of the cache — the one read, the per-layer
    copies and the stacked new one — and 1 GiB).  Prints the prefill time
    (median of 3 timed alone) and the time per generated token: its
    decode loop timed alone, warm, from the last timed prefill's cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(SEAMLESS_ARCH)
    B, S, P, G = SEAMLESS_BATCH, SEAMLESS_FRAMES, SEAMLESS_PROMPT, \
        SEAMLESS_GEN
    max_len = P + G
    weights = 2 * cfg.num_params()
    cache_bytes = seamless_cache_bytes(cfg, B, max_len, S, 2)
    reckoning = weights + 3 * cache_bytes
    print(f"serving {SEAMLESS_ARCH} one-shot: reckoning "
          f"{reckoning / 1e9:.3f} GB = weights {weights / 1e9:.3f} GB "
          f"(bf16) + 3 x the cache {cache_bytes / 1e9:.4f} GB; the peak "
          f"may hold "
          f"{SERVE_ROOM / 2**30:.0f} GiB more", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    frames = torch.randn((B, S, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device="cuda")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve.generate(model, params, prompts, G, max_len, src=frames)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    flash = 3 * L + L * (G - 1)
    expected = {"flash_attention": flash, "flash_attention[wgmma]": flash,
                "nonfinite_tiles": flash}
    for name, n in launches.items():
        if n != expected.get(name, 0):
            fail(f"{SEAMLESS_ARCH} one-shot: kernel {name} launched {n} "
                 f"times, expected {expected.get(name, 0)} (flash = 3 x {L} "
                 f"at the prefill + {L} x {G - 1} decode steps, all on "
                 f"wgmma, its pre-pass as often, 0 for the others)")
    if tuple(toks.shape) != (B, G) or not bool(
            ((toks >= 0) & (toks < cfg.padded_vocab)).all()):
        fail(f"{SEAMLESS_ARCH} one-shot: tokens {tuple(toks.shape)}")
    if peak > reckoning + SERVE_ROOM:
        fail(f"{SEAMLESS_ARCH} one-shot: peak {peak / 1e9:.3f} GB beyond "
             f"the reckoning {reckoning / 1e9:.3f} GB + 1 GiB")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts,
                                               "src": frames},
                                      max_len=max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(logits.shape) != (B, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        fail(f"{SEAMLESS_ARCH} prefill logits: shape {tuple(logits.shape)} "
             f"finite {bool(torch.isfinite(logits.float()).all())}")
    prefill_s = statistics.median(times)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G - 1):       # generate's decode loop
        step, cache = model.decode_step(params, tok, cache, P + i)
        tok = torch.argmax(step[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    per_token_ms = (time.perf_counter() - t0) / (G - 1) * 1e3
    res = {"params": cfg.num_params(), "launches": launches,
           "peak_bytes": peak, "reckoning_bytes": reckoning,
           "generate_s": gen_s, "prefill_ms": prefill_s * 1e3,
           "prefill_ms_all": [t * 1e3 for t in times],
           "per_token_ms": per_token_ms,
           "tokens_per_s": B * G / gen_s}
    print(f"serving {SEAMLESS_ARCH} one-shot [{card}]: {res['params']} "
          f"params bf16, {cfg.num_encoder_layers} + {L} layers, batch {B} x "
          f"{S} bf16 frames x {P}-token prompts, {G} new tokens in "
          f"{gen_s:.3f} s ({res['tokens_per_s']:.1f} tokens/s); prefill "
          f"{prefill_s * 1e3:.3f} ms (median of "
          f"{[round(t * 1e3, 1) for t in times]}), "
          f"{per_token_ms:.3f} ms per generated token (its decode loop "
          f"alone); flash "
          f"{launches['flash_attention']} launches = 3 x {L} + {L} x "
          f"{G - 1}, all wgmma; peak {peak / 1e9:.3f} GB within the "
          f"reckoning {reckoning / 1e9:.3f} GB + 1 GiB", flush=True)
    del model, params, frames, logits, cache, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_seamless_f32_frames(torch, ops, serve, card) -> dict:
    """Phase 15 (d): the one-shot path of ``repro_torch.launch.serve
    --arch seamless-m4t-large-v2`` at full width cut to 2 + 2 layers,
    with the f32 frames that the CLI draws.  The gate is the routes of the
    promotion: the encoder's and the cross-attention's flash (f32 memory)
    on SIMT, the decoder's self-attention (bf16) on wgmma.  Then, on f32
    frames of the same shape, the dtypes the reference gives: f32 memory
    and cross K/V, bf16 self K/V and logits."""
    from repro_torch.models import encdec
    cfg = cut(SEAMLESS_ARCH, SEAMLESS_F32_CUT)
    args = SEAMLESS_F32_ARGS
    B, P = int(args[args.index("--batch") + 1]), \
        int(args[args.index("--prompt-len") + 1])
    G = int(args[args.index("--gen") + 1])
    ops.reset_launch_counts()
    run = serve.main(args, cfg)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    Le, L = cfg.num_encoder_layers, cfg.num_layers
    simt, wgmma = Le + L + L * (G - 1), L
    expected = {"flash_attention": simt + wgmma,
                "flash_attention[simt]": simt,
                "flash_attention[wgmma]": wgmma,
                "nonfinite_tiles": simt + wgmma}
    for name, n in launches.items():
        if n != expected.get(name, 0):
            fail(f"{SEAMLESS_ARCH} f32 frames: kernel {name} launched {n} "
                 f"times, expected {expected.get(name, 0)} (SIMT: {Le} "
                 f"encoder + {L} cross x {G} steps; wgmma: {L} decoder "
                 f"self at the prefill)")
    if run.tokens.shape != (B, G):
        fail(f"{SEAMLESS_ARCH} f32 frames: tokens {run.tokens.shape}")
    g = torch.Generator("cuda").manual_seed(2)
    src = torch.randn((B, P, cfg.d_model), generator=g, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda")
    memory = encdec.encode(run.params["encdec"], cfg, src)
    logits, cache = run.model.prefill(run.params, {"tokens": tokens,
                                                   "src": src}, max_len=P + G)
    dtypes = {"memory": memory.dtype, "cross_k": cache["cross_k"].dtype,
              "self_k": cache["self"]["k"].dtype, "logits": logits.dtype}
    want = {"memory": torch.float32, "cross_k": torch.float32,
            "self_k": torch.bfloat16, "logits": torch.bfloat16}
    if dtypes != want or not bool(torch.isfinite(logits.float()).all()):
        fail(f"{SEAMLESS_ARCH} f32 frames: dtypes {dtypes}, expected {want}")
    print(f"serving {SEAMLESS_ARCH} f32 frames [{card}]: {Le} + {L} layers "
          f"(cut from {cut(SEAMLESS_ARCH, {}).num_encoder_layers} + "
          f"{cut(SEAMLESS_ARCH, {}).num_layers}), batch {B}, {P} frames "
          f"and prompt tokens, {G} new: flash on SIMT "
          f"{launches['flash_attention[simt]']} (= {Le} encoder + {L} x {G} "
          f"cross), on wgmma {launches['flash_attention[wgmma]']} (the "
          f"decoder's self-attention); dtypes "
          f"{ {k: str(v).split('.')[-1] for k, v in dtypes.items()} } as "
          f"the reference's (run {run.seconds:.2f} s)", flush=True)
    res = {"launches": launches, "seconds": run.seconds,
           "dtypes": {k: str(v) for k, v in dtypes.items()}}
    del run, memory, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    return res


def xlstm_reckoning(cfg, batch: int, seq: int) -> dict:
    """Bytes xlstm-125m's training step holds at its peak: phase 8's 20
    bytes a parameter (bf16 parameters and gradients, Adam's f32 moments,
    the EF residual, the synced f32 gradients), the chunked remat's
    boundary carries (seq / mlstm_chunk per mLSTM layer) and one chunk of
    per-step carries with one step's ~4 carry-sized intermediates, the
    logits of the cross-entropy's chunk (bf16, f32 and f32 gradient and
    bf16 copies: 12 bytes an entry), and 1 GiB.  Beside it, the reckoning
    without remat: every step's carry and intermediates kept, for every
    mLSTM layer."""
    from repro_torch.models.xlstm import MLSTM_PF
    di = MLSTM_PF * cfg.d_model
    H = cfg.num_heads
    dh = di // H
    carry = 4 * batch * H * (dh * dh + dh + 1)
    n_mlstm = sum(seg.repeats for seg in cfg.stack_plan()
                  for s in seg.period if s.mixer == "mlstm")
    c = cfg.mlstm_chunk
    params = 20 * cfg.num_params()
    boundaries = n_mlstm * (seq // c) * carry
    chunk = c * carry + 4 * carry
    logits = 12 * batch * seq * cfg.padded_vocab
    return {"params": params, "boundaries": boundaries, "chunk": chunk,
            "logits": logits, "carry": carry, "mlstm_layers": n_mlstm,
            "total": params + boundaries + chunk + logits + SERVE_ROOM,
            "no_remat": n_mlstm * seq * 4 * carry}


def run_xlstm_training(torch, ops, train, card) -> dict:
    """Phase 15 (e): xlstm-125m at full width and XLSTM_TRAIN_LAYERS
    layers, from XLSTM_TRAIN_ARGS (Adam, ``--sync comm --compressor
    int8_fused``, batch 4 x seq 256, NCCL world 1, 3 steps): the session
    is built from the CLI's flags by the CLI's own ``fixed_strategy``,
    with the depth cut, and every kernel counter set to 0 just before and
    read just after.  Gates: finite losses, quantize_ef and dequant_accum
    = buckets x steps on the warp route, every other kernel 0, the peak
    within the reckoning printed before the run (with the chunked remat;
    the reckonings without it, at this depth and at the full 12 layers,
    are printed beside it).  Prints step times and a profiled step's
    device-busy share (device events only)."""
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.launch.dist import destroy_group
    full = cut(XLSTM_ARCH, {})
    cfg = cut(XLSTM_ARCH, {"num_layers": XLSTM_TRAIN_LAYERS})
    rk = xlstm_reckoning(cfg, TRAIN_BATCH, XLSTM_TRAIN_SEQ)
    full_rk = xlstm_reckoning(full, TRAIN_BATCH, XLSTM_TRAIN_SEQ)
    print(f"training {XLSTM_ARCH}: {cfg.num_layers} of {full.num_layers} "
          f"layers (reduced depth; widths full), reckoning "
          f"{rk['total'] / 2**30:.3f} GiB "
          f"= 20 B x {cfg.num_params()} parameters "
          f"({rk['params'] / 2**30:.3f} GiB) + the remat's boundary carries "
          f"({rk['mlstm_layers']} mLSTM layers x {XLSTM_TRAIN_SEQ} / "
          f"{cfg.mlstm_chunk} x {rk['carry'] / 1e6:.3f} MB = "
          f"{rk['boundaries'] / 2**30:.3f} GiB) + one chunk "
          f"({rk['chunk'] / 2**30:.3f} GiB) + the loss chunk's logits "
          f"({rk['logits'] / 2**30:.3f} GiB) + 1 GiB; without remat the "
          f"mLSTM steps alone would keep {rk['no_remat'] / 1e9:.1f} GB "
          f"({full_rk['no_remat'] / 1e9:.1f} GB at {full.num_layers} "
          f"layers)", flush=True)
    args = train.build_parser().parse_args(XLSTM_TRAIN_ARGS)
    strategy = train.fixed_strategy(args, train.scheduler_from_args(args),
                                    train.resolve_cli_parallelism(args),
                                    None)
    destroy_group()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session = TrainSession(SessionConfig(
        arch=args.arch, layers=cfg.num_layers, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, warmup=args.warmup,
        optimizer=args.optimizer, seed=args.seed, device="cuda"),
        strategy=strategy)
    session.run(args.steps, log_every=args.log_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    if session.device.type != "cuda":
        fail(f"xlstm training ran on {session.device}, not on the card")
    losses = list(session.losses)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"xlstm training: losses {losses}")
    n_buckets = session.synchronizer.plan.n_buckets
    wire = ("quantize_ef", "dequant_accum", "dequant_accum[warp]")
    for kname, count in launches.items():
        want = n_buckets * TRAIN_STEPS if kname in wire else 0
        if count != want or (kname in wire and want <= 0):
            fail(f"xlstm training: kernel {kname} launched {count} times, "
                 f"expected {want} (= {n_buckets} buckets x {TRAIN_STEPS} "
                 f"steps for quantize_ef and dequant_accum on the warp "
                 f"route, 0 for the others)")
    if peak > rk["total"]:
        fail(f"xlstm training: peak {peak / 2**30:.3f} GiB beyond the "
             f"reckoning {rk['total'] / 2**30:.3f} GiB")
    times = session.step_times
    step_ms = statistics.median(times[1:]) * 1e3
    res = {"layers": cfg.num_layers, "losses": losses, "step_ms": step_ms,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": TRAIN_BATCH * XLSTM_TRAIN_SEQ / (step_ms / 1e3),
           "peak_bytes": peak, "reckoning": rk,
           "no_remat_full_depth": full_rk["no_remat"], "n_buckets": n_buckets,
           "launches": launches, "run_s": seconds,
           "params": session.num_params(),
           "lengths": sorted(set(bucket_lengths(session.synchronizer.plan,
                                                session.params)))}
    print(f"training {XLSTM_ARCH} [{card}]: {cfg.num_layers} layers, "
          f"{res['params']} params bf16, "
          f"batch {TRAIN_BATCH} x seq {XLSTM_TRAIN_SEQ}, losses "
          f"{[round(x, 4) for x in losses]}; step time (median of steps "
          f"2-{TRAIN_STEPS}) {step_ms:.3f} ms, all steps "
          f"{[round(t, 1) for t in res['step_ms_all']]} ms; tokens/s "
          f"{res['tokens_per_s']:.1f}; peak {peak / 2**30:.3f} GiB within "
          f"the reckoning {rk['total'] / 2**30:.3f} GiB; {n_buckets} "
          f"buckets; launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    res["profile"] = profile_step(torch, session, card, "xlstm_int8_fused",
                                  cpu=False)
    del session
    gc.collect()
    torch.cuda.empty_cache()
    destroy_group()
    return res


def phase_new_families(torch, ops, ref, serve, train, card) -> dict:
    """Phase 15: the small references (card free), then (a) jamba and (b)
    xlstm served at full width, (c) seamless one-shot at full width, (d)
    its f32-frame promotion, (e) xlstm trained at full width, and the
    wire kernels bit-equal at every bucket length of (e), timed at the
    largest."""
    t0 = time.perf_counter()
    print(f"phase 15: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated at its start", flush=True)
    phase_small_new_families(torch, card)
    serving = {JAMBA_ARCH: run_full_width_serving(torch, ops, serve, card,
                                                  JAMBA_ARCH, JAMBA_CUT),
               XLSTM_ARCH: run_full_width_serving(torch, ops, serve, card,
                                                  XLSTM_ARCH)}
    oneshot = run_seamless_oneshot(torch, ops, serve, card)
    f32_frames = run_seamless_f32_frames(torch, ops, serve, card)
    training = run_xlstm_training(torch, ops, train, card)
    lengths = training["lengths"]
    wire = train_path_kernels(torch, ops, ref, lengths,
                              {"xlstm_largest_bucket": max(lengths)})
    seconds = time.perf_counter() - t0
    print(f"phase 15 took {seconds:.1f} s", flush=True)
    return {"serving": serving, "oneshot": oneshot, "f32_frames": f32_frames,
            "training": training, "wire": wire, "seconds": seconds}


# ---------------------------------------------------------------------------
# 16. tensor and expert parallelism, calibration and drift re-planning
# ---------------------------------------------------------------------------

P16_DIR = "phase16"
P16_WORLD = 4
TP = 2
TP_SESSION = dict(arch="gemma-2b", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, optimizer="adam", seed=0)
# phase 8's measured peak per parameter: 46.08 GiB for gemma-2b's 2.51 B
# parameters (Adam, int8_fused, batch 4 x 512, on an H100 80GB HBM3 at 700 W)
TP_BYTES_PER_PARAM = 46.08 * 2**30 / 2_506_172_416
TP_BUDGET = 70 * 2**30        # both ranks, with the other children's room
# (a) against the unsharded run, bf16: the tp ranks sum two partial
# products where the unsharded run sums one matmul.  The backward shows
# in the first step's gradients (taken before the DP edge) and in Adam's
# first moment after 3 steps (a linear map of the synced, int8
# gradients); the parameters cannot show it, since Adam moves each entry
# by about lr whatever its gradient.  Gradients and moment: each leaf's
# relative L2 gap.  The control is the unsharded process with every
# FFN's two halves summed apart (``mlp_blocked``): the tp ranks'
# arithmetic without the ranks, so their gradients must equal its bit
# for bit (gap 0), and its own gap from the plain run, bf16's, is the
# tp ranks' gap too.
# Measured on an H100 80GB HBM3 at 700 W, the same in three runs: loss
# 3.1e-5, gradients 3.04e-2 (the control's too), first moment 3.18e-2.
TP_LOSS_RTOL = 3e-4
TP_GRAD_RTOL = 4e-2
TP_BLOCKED_RTOL = 0.0
TP_MOMENT_RTOL = 4e-2
ADAM_GAIN = 3.2               # |m̂ / sqrt(v̂)| bound of b1 = 0.9, b2 = 0.999
EP_ARCH = "qwen3-moe-30b-a3b"
EP_SIZES = (2, 4)
EP_BATCH, EP_SEQ = 2, 512
EP_LR = 0.05                  # the reference check's inline Adam
EP_SEED = 16
TINY_TP = dict(d=16, dff=32, vocab=64, batch=4, seq=12)
CLI_W4 = {"tp": ["--arch", "gemma-2b", "--parallelism", "dp=2,tp=2"],
          "ep": ["--arch", EP_ARCH, "--parallelism", "dp=2,ep=2"]}
CLI_W4_BASE = ["--device", "cuda", "--reduced", "--steps", "2", "--batch",
               "4", "--seq", "32", "--sync", "auto", "--plan-backward-ms",
               "20", "--seed", "0"]
REPLAN_PCT, REPLAN_EVERY = 0.001, 2
DRIFT_KEYS = {"plan_key", "modeled_step_s", "modeled_wall_step_s",
              "measured_step_s", "steps_measured", "drift_frac", "drift_pct",
              "comm_fit_err_s", "t_backward_err_s", "measured_spread_s",
              "fit_error_s", "within_fit_error", "replans", "replan_events",
              "arms"}
CALIBRATION_KEYS = {"version", "world", "tiers"}


def tp_reckoning(layers: int) -> dict:
    """A tp rank's parameters (the shared leaves whole, its half of every
    FFN) at ``layers`` layers, the peak at phase 8's bytes per parameter,
    and the staged bytes of one step's tp wire: per layer two all-reduces
    of the (batch, seq, d_model) bf16 activations (the forward's ``g``
    and the backward's ``f``; the per-layer checkpoint's recomputation
    stops at the last tensor the backward needs, before the forward's
    all-reduce), each copied to the host and back: the nominal 4
    activation transfers a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=layers)
    total = count_params(cfg)
    ffn = layers * 3 * cfg.d_model * cfg.d_ff
    per_rank = total - ffn + ffn // TP
    act = TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * {
        "bfloat16": 2, "float32": 4}[cfg.compute_dtype]
    return {"layers": layers, "params_total": total, "ffn_params": ffn,
            "params_per_rank": per_rank,
            "peak_per_rank": per_rank * TP_BYTES_PER_PARAM,
            "tp_staged_per_step": layers * 2 * 2 * act}


def p16_dp_staged(session) -> int:
    """Staged bytes of one step's int8_fused DP edge on a one-rank gloo
    group: every bucket's int8 codes and f32 tile scales copied to the
    host and back by the all-gather, and the f32 loss by its mean over
    the group."""
    n = bucket_lengths(session.synchronizer.plan, session.params)
    return sum(2 * (x + 4 * -(-x // TILE)) for x in n) + 2 * 4


def bf16_ulp_of(torch, x):
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def p16_reference(torch, layers: int) -> dict:
    """(a)'s other side: gemma-2b at ``layers`` layers, unsharded, NCCL
    world 1, the same int8_fused session for 3 steps on the same weights;
    the first step's gradients (before the DP edge) of the control (every
    FFN's two halves summed apart, ``mlp_blocked``) must lie within
    TP_GRAD_RTOL (relative L2) of the plain run's; the control's (host
    bf16), its final
    parameters (host bf16) and Adam's first moment (host f32) go to
    ``build/phase16_ref/ref_g_blocked.pt``, ``ref_params.pt`` and
    ``ref_m.pt`` for the tp ranks to compare with."""
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.launch.dist import destroy_group
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import transformer
    from repro_torch.models.layers import mlp_blocked
    out_dir = ROOT / "build" / f"{P16_DIR}_ref"
    out_dir.mkdir(parents=True, exist_ok=True)
    sess = TrainSession(SessionConfig(layers=layers, device="cuda",
                                      **TP_SESSION),
                        strategy=make_strategy(
                            "every_step",
                            sync=SyncConfig(compressor="int8_fused")))
    _, g = loss_and_grads(sess.model, sess.params, sess.batch(0))
    plain = {k: v.detach().cpu() for k, v in _flatten_with_paths(g).items()}
    del g
    mlp = transformer.mlp
    transformer.mlp = lambda p, x, act: mlp_blocked(p, x, act, blocks=TP)
    try:
        _, g = loss_and_grads(sess.model, sess.params, sess.batch(0))
    finally:
        transformer.mlp = mlp
    blocked = _flatten_with_paths(g)
    control = {}
    for k, v in blocked.items():
        want = plain[k].to("cuda", torch.float32)
        norm = float(torch.linalg.vector_norm(want))
        gap = float(torch.linalg.vector_norm(v.float() - want))
        control[k] = gap / norm if norm else gap
        if control[k] > TP_GRAD_RTOL:
            fail(f"{k}: the control's first-step gradient {control[k]} "
                 f"(relative L2) from the plain run's, beyond "
                 f"{TP_GRAD_RTOL}")
        del want
    torch.save({k: v.detach().cpu() for k, v in blocked.items()},
               out_dir / "ref_g_blocked.pt")
    del g, blocked, plain
    sess.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    flat = {k: v.detach().cpu() for k, v in
            _flatten_with_paths(sess.params).items()}
    torch.save(flat, out_dir / "ref_params.pt")
    del flat
    m = {k: v.detach().cpu() for k, v in
         _flatten_with_paths(sess.opt_state["m"]).items()}
    torch.save(m, out_dir / "ref_m.pt")
    res = {"losses": list(sess.losses),
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "lr": [sess._lr(s) for s in range(TRAIN_STEPS)],
           "g_blocked_path": str(out_dir / "ref_g_blocked.pt"),
           "control_gap": {"max": max(control.values()),
                           "median": statistics.median(control.values())},
           "path": str(out_dir / "ref_params.pt"),
           "m_path": str(out_dir / "ref_m.pt")}
    del sess, m
    destroy_group()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def p16_adam(torch, p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The reference checks' inline Adam, moments in f32, the parameter
    updated in f32 and cast back to its type."""
    m = b1 * m + (1 - b1) * g.float()
    v = b2 * v + (1 - b2) * g.float() * g.float()
    tt = torch.tensor(float(t), device=p.device)
    mh = m / (1 - torch.tensor(b1, device=p.device) ** tt)
    vh = v / (1 - torch.tensor(b2, device=p.device) ** tt)
    return (p.float() - lr * mh / (torch.sqrt(vh) + eps)).to(p.dtype), m, v


def p16_tiny_tp(torch, rank: int, tp_group) -> dict:
    """(a)'s reduced f32 leg: the reference TP check's model (embedding,
    gated MLP of 16 x 32, head) in f32 on the card, 3 Adam steps of
    ``mlp_tp`` on the two ranks against ``mlp_blocked(blocks=2)`` on each;
    every leaf and both moments bit-equal."""
    import torch.nn.functional as F
    from repro_torch.convert import mlp_slice
    from repro_torch.models.layers import mlp_blocked, mlp_tp
    c = TINY_TP
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    p0 = {"emb": torch.randn(c["vocab"], c["d"], generator=gen,
                             device=dev) * 0.1,
          "wi_gate": torch.randn(c["d"], c["dff"], generator=gen,
                                 device=dev) * 0.3,
          "wi_up": torch.randn(c["d"], c["dff"], generator=gen,
                               device=dev) * 0.3,
          "wo": torch.randn(c["dff"], c["d"], generator=gen, device=dev) * .3,
          "out": torch.randn(c["d"], c["vocab"], generator=gen,
                             device=dev) * 0.1,
          "b": torch.zeros(c["vocab"], device=dev)}
    toks = [torch.randint(0, c["vocab"], (c["batch"], c["seq"]),
                          generator=gen, device=dev) for _ in range(3)]

    def run(params, mlp_fn):
        p = dict(params)
        m = {k: torch.zeros_like(x) for k, x in p.items()}
        v = {k: torch.zeros_like(x) for k, x in p.items()}
        for s in range(3):
            q = {k: x.detach().clone().requires_grad_(True)
                 for k, x in p.items()}
            tk = toks[s]
            x = q["emb"][tk[:, :-1]]
            h = x + mlp_fn(q, x)
            lp = F.log_softmax(h @ q["out"] + q["b"], dim=-1)
            loss = -torch.mean(torch.gather(lp, -1, tk[:, 1:, None]))
            loss.backward()
            for k in p:
                p[k], m[k], v[k] = p16_adam(torch, p[k], q[k].grad, m[k],
                                            v[k], s + 1, 0.05)
        return p, m, v

    tp = run(dict(p0, **mlp_slice(p0, rank, TP)),
             lambda q, x: mlp_tp(q, x, group=tp_group))
    blocked = run(p0, lambda q, x: mlp_blocked(q, x, blocks=TP))
    want = [dict(t, **mlp_slice(t, rank, TP)) for t in blocked]
    equal = all(torch.equal(a[k], b[k]) for a, b in zip(tp, want)
                for k in a)
    w4_gate(equal, "the f32 tp leg differs from mlp_blocked(blocks=2)")
    return {"bit_equal": equal}


def tp_share(want, key: str, rank: int):
    """This tp rank's part of an unsharded leaf (``convert.tp_slice``'s
    cut: the FFN's ``wi_gate`` / ``wi_up`` on their output dim, ``wo`` on
    its input dim, every other leaf whole)."""
    if "/ffn/" in key and key.rsplit("/", 1)[1] in ("wi_gate", "wi_up"):
        n = want.shape[-1] // TP
        return want.narrow(-1, rank * n, n)
    if "/ffn/" in key and key.endswith("/wo"):
        n = want.shape[-2] // TP
        return want.narrow(-2, rank * n, n)
    return want


def rel_gaps(torch, mine: dict, ref_path: str, rank: int) -> dict:
    """Each leaf's relative L2 gap, ||mine - ref|| / ||ref||, between
    this tp rank's flat tree and its part (``tp_share``) of the unsharded
    run's, read from ``ref_path``."""
    ref = torch.load(ref_path, mmap=True)
    out = {}
    for key, x in mine.items():
        want = tp_share(ref[key], key, rank).to("cuda", torch.float32)
        gap = float(torch.linalg.vector_norm(x.float() - want))
        norm = float(torch.linalg.vector_norm(want))
        out[key] = gap / norm if norm else gap
        del want
    return out


def gate_rel_gaps(gaps: dict, limit: float, what: str) -> dict:
    for key, r in gaps.items():
        w4_gate(r <= limit, f"{key}: {what} {r} (relative L2) from the "
                f"unsharded run's, beyond {limit}")
    top = max(gaps, key=gaps.get)
    return {"max": gaps[top], "max_leaf": top,
            "median": statistics.median(gaps.values()), "limit": limit}


def p16_tp(torch, rank: int, tp_group, data_group, layers: int,
           ref_g_blocked_path: str, ref_path: str,
           ref_m_path: str) -> dict:
    """(a), one of the two tp ranks: gemma-2b at full width (``layers``
    layers), this rank's half of every FFN (``convert.tp_slice``), the
    Megatron wire under ``tp_region`` on a gloo group of the two ranks,
    Adam, int8_fused on the rank's one-rank data group, batch 4 x 512, 3
    steps.  Gates: quantize_ef and dequant_accum once per bucket and step
    (warp route), every step's staged bytes = the tp wire's reckoning +
    the DP edge's codes and scales, the first step's gradient of every
    leaf bit-equal to the control's (``mlp_blocked``; ``p16_reference``
    holds the control within TP_GRAD_RTOL of the unsharded run), Adam's
    first moment after the steps within TP_MOMENT_RTOL (relative L2) of
    the unsharded run's,
    and every parameter within the Adam envelope of the unsharded
    run's."""
    from repro_torch._tree import tree_map
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.convert import tp_slice
    from repro_torch.core import SyncConfig, make_strategy
    from repro_torch.core.collectives import p2p
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.models.sharding_ctx import tp_region
    from repro_torch.configs import get_config
    res = {"tiny_f32": p16_tiny_tp(torch, rank, tp_group)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=layers)
    full = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    params = tp_slice(full, rank, TP)
    del full
    gc.collect()
    sess = TrainSession(SessionConfig(layers=layers, device="cuda",
                                      **TP_SESSION),
                        strategy=make_strategy(
                            "every_step", group=data_group,
                            sync=SyncConfig(compressor="int8_fused")),
                        params=params, group=data_group)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rk = tp_reckoning(layers)
    with tp_region(tp_group):
        # the first step's gradients on the unchanged weights
        _, g = loss_and_grads(sess.model, sess.params, sess.batch(0))
        blocked_gap = gate_rel_gaps(
            rel_gaps(torch, _flatten_with_paths(g), ref_g_blocked_path,
                     rank),
            TP_BLOCKED_RTOL, "the first step's gradient against the "
            "control's (mlp_blocked; bit-equal expected)")
        del g
        gc.collect()
        torch.cuda.empty_cache()
    p2p.reset_staged_bytes()
    ops.reset_launch_counts()
    staged = []
    with tp_region(tp_group):
        for _ in range(TRAIN_STEPS):
            before = p2p.staged_bytes()
            sess.run(1)
            staged.append(p2p.staged_bytes() - before)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    n_buckets = sess.synchronizer.plan.n_buckets
    w4_launch_gate(launches, {k: n_buckets * TRAIN_STEPS for k in INT8_WIRE},
                   "tp rank")
    dp = p16_dp_staged(sess)
    w4_gate(all(s == rk["tp_staged_per_step"] + dp for s in staged),
            f"staged bytes a step {staged}, expected the tp wire's "
            f"{rk['tp_staged_per_step']} + the DP edge's {dp}")
    losses = list(sess.losses)
    w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
    # against the unsharded run: this rank's part of its first moment,
    # where the backward shows, then of its parameters
    m_gap = gate_rel_gaps(
        rel_gaps(torch, _flatten_with_paths(sess.opt_state["m"]),
                 ref_m_path, rank),
        TP_MOMENT_RTOL, "Adam's first moment")
    ref = torch.load(ref_path, mmap=True)
    lr = sum(sess._lr(s) for s in range(TRAIN_STEPS))
    worst, n_diff, n_all = 0.0, 0, 0
    for key, p in _flatten_with_paths(tree_map(
            lambda t: t.detach(), sess.params)).items():
        want = tp_share(ref[key], key, rank).to("cuda")
        d = (p.float() - want.float()).abs()
        env = 2 * ADAM_GAIN * lr + 2 * bf16_ulp_of(torch, want)
        worst = max(worst, float(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        w4_gate(bool((d <= env).all()),
                f"{key}: |Δ| up to {float(d.max())} beyond the Adam "
                f"envelope {2 * ADAM_GAIN * lr} + 2 bf16 ulps")
        del want, d, env
    res.update({
        "layers": layers, "launches": launches, "n_buckets": n_buckets,
        "losses": losses, "staged_per_step": staged, "dp_staged": dp,
        "reckoning": rk, "step_ms_all": [t * 1e3 for t in sess.step_times],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "blocked_gap": blocked_gap, "m_gap": m_gap,
        "params_max_abs_diff": worst,
        "params_differing": n_diff, "params_compared": n_all,
        "adam_envelope": 2 * ADAM_GAIN * lr})
    del sess, ref
    gc.collect()
    torch.cuda.empty_cache()
    return res


def p16_experts(torch, cfg):
    """qwen3-moe-30b-a3b's expert leaves at full width (bf16, the model's
    init scales) and a router of its "small" scale, from EP_SEED."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(EP_SEED)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    bf = torch.bfloat16

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)
    router = draw((d, E), 0.02)
    experts = {"wi_gate": draw((E, d, ff), d ** -0.5),
               "wi_up": draw((E, d, ff), d ** -0.5),
               "wo": draw((E, ff, d), ff ** -0.5)}
    return router, experts


def p16_tokens(torch, cfg, rank: int):
    gen = torch.Generator("cuda").manual_seed(EP_SEED + 100 + rank)
    return torch.randn((EP_BATCH, EP_SEQ, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def p16_moe_steps(torch, cfg, router, experts, x, parts=1, **kw):
    """3 steps of the reference EP check: loss sum(out²) of ``moe_ffn``,
    the router frozen, Adam (EP_LR) on the expert leaves.  The tokens
    take a gradient too, as a layer's input activations do, so the
    dispatch's reverse exchange runs in the backward beside the
    combine's.  Returns (the experts, m, v, losses, step seconds, drop
    counts); a step's entry of ``losses`` is the list of sum(out²) over
    each of ``parts`` equal blocks of the batch (one rank's tokens each,
    where one process runs the group's), taken beside the loss."""
    from repro_torch.models import moe
    p = dict(experts)
    m = {k: torch.zeros(x_.shape, device="cuda") for k, x_ in p.items()}
    v = {k: torch.zeros(x_.shape, device="cuda") for k, x_ in p.items()}
    losses, times = [], []
    moe.drain_drop_tap()
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        q = {k: t.detach().clone().requires_grad_(True) for k, t in p.items()}
        out, _ = moe.moe_ffn(dict(q, router=router), cfg,
                             x.detach().requires_grad_(True), **kw)
        loss = torch.sum(out.float() ** 2)
        with torch.no_grad():
            losses.append([float(torch.sum(o.float() ** 2))
                           for o in out.chunk(parts)])
        loss.backward()
        for k in p:
            p[k], m[k], v[k] = p16_adam(torch, p[k], q[k].grad, m[k], v[k],
                                        s + 1, EP_LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return p, m, v, losses, times, moe.drain_drop_tap()


def per_expert_digests(torch, t) -> list:
    return [digest(torch, t[e]).tolist() for e in range(t.shape[0])]


def p16_ep(torch, rank: int, groups: dict) -> dict:
    """(b), this rank's part: ``moe_ffn`` at qwen3-moe-30b-a3b's widths
    with expert parallelism over gloo groups on the one card (ep = 2 on
    ranks 0-1, ep = 4 on all four), both all-to-all variants, against one
    process (the group's rank 0) running ``groups=ep`` on the same tokens.
    Gates: the group's drop counts sum to the one process's, 4
    all-to-alls a step (2 forward, 2 backward), each rank's loss bit-equal
    to the one process's over that rank's tokens, and every expert
    parameter and both Adam moments bit-equal to the one process's (the
    moments by digests)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import experts_slice
    from repro_torch.core.collectives import all_gather, p2p
    import repro_torch.core.collectives.api as capi
    from repro_torch.models import moe
    cfg = get_config(EP_ARCH)
    router, experts = p16_experts(torch, cfg)
    calls = [0]
    real = capi.all_to_all

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    capi.all_to_all = counted
    moe.enable_drop_tap(True)
    out = {}
    try:
        for ep, (group, members) in groups.items():
            if rank not in members:
                continue
            me = members.index(rank)
            res = {}
            if me == 0:
                xs = torch.cat([p16_tokens(torch, cfg, r) for r in members])
                p, m, v, losses, times, drops = p16_moe_steps(
                    torch, cfg, router, experts, xs, parts=ep, groups=ep)
                want = {"p": p, "m": {k: per_expert_digests(torch, t)
                                      for k, t in m.items()},
                        "v": {k: per_expert_digests(torch, t)
                              for k, t in v.items()}}
                res["one_process"] = {"losses": losses, "drops": drops,
                                      "step_ms": [t * 1e3 for t in times]}
                del m, v, xs
            x = p16_tokens(torch, cfg, rank)
            mine = experts_slice(experts, me, ep)
            for variant in ("direct", "ring"):
                calls[0] = 0
                p2p.reset_staged_bytes()
                p, m, v, losses, times, drops = p16_moe_steps(
                    torch, cfg, router, mine, x, ep_axis=group,
                    a2a_variant=variant)
                staged = p2p.staged_bytes()
                w4_gate(calls[0] == 4 * TRAIN_STEPS,
                        f"ep={ep} {variant}: {calls[0]} all-to-alls in "
                        f"{TRAIN_STEPS} steps, expected 2 forward + 2 "
                        f"backward a step")
                losses = [l for (l,) in losses]
                w4_gate(all(map(math.isfinite, losses)), f"losses {losses}")
                every = all_gather(torch.tensor(drops, device="cuda"), group)
                # f64 holds each f32 loss exactly
                every_loss = all_gather(torch.tensor(
                    losses, dtype=torch.float64, device="cuda"), group)
                gathered = {k: all_gather(t, group) for k, t in p.items()}
                dig = {t: {k: all_gather(torch.tensor(
                    per_expert_digests(torch, x_), device="cuda"), group)
                    for k, x_ in tree.items()} for t, tree in
                    (("m", m), ("v", v))}
                leg = {"losses": losses, "drops": list(drops),
                       "step_ms": [t * 1e3 for t in times],
                       "staged_bytes": staged, "a2a_calls": calls[0]}
                if me == 0:
                    total = every.sum(0).tolist()
                    w4_gate(total == list(res["one_process"]["drops"]),
                            f"ep={ep} {variant}: drops {total} != the one "
                            f"process's {res['one_process']['drops']}")
                    ranks_loss = every_loss.reshape(len(members),
                                                    TRAIN_STEPS).T.tolist()
                    w4_gate(ranks_loss == res["one_process"]["losses"],
                            f"ep={ep} {variant}: the ranks' losses "
                            f"{ranks_loss} != the one process's over their "
                            f"tokens {res['one_process']['losses']}")
                    worst, bits = 0.0, True
                    for k, g in gathered.items():
                        g = g.reshape(want["p"][k].shape)
                        d = (g.float() - want["p"][k].float()).abs()
                        worst = max(worst, float(d.max()))
                        bits &= torch.equal(g, want["p"][k])
                    w4_gate(bits, f"ep={ep} {variant}: expert parameters "
                            f"differ from the one process's (max |Δ| "
                            f"{worst})")
                    moments = all(
                        dig[t][k].reshape(-1, 2).tolist() == want[t][k]
                        for t in ("m", "v") for k in dig[t])
                    w4_gate(moments, f"ep={ep} {variant}: Adam moments' "
                            f"digests differ from the one process's")
                    leg.update({"params_bit_equal": bool(bits),
                                "params_max_abs_diff": worst,
                                "moments_bit_equal": moments,
                                "losses_bit_equal": True,
                                "drops_total": total})
                res[variant] = leg
                del p, m, v, gathered, dig
                gc.collect()
                torch.cuda.empty_cache()
            out[f"ep{ep}"] = res
            dist.barrier(group)
    finally:
        capi.all_to_all = real
        moe.enable_drop_tap(False)
    del router, experts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def session_wire_launches(sess, since=(0, 0)) -> dict:
    """The wire-kernel launches (``plan_launches``) that a session's
    rounds since ``since`` = (gradient rounds, parameter rounds) made
    under its built strategy: its gradient reducer's plan once per
    gradient round, its parameter reducer's once per parameter round."""
    want: dict = {}
    reducers = ((sess.synchronizer, sess.grad_rounds - since[0]),
                (getattr(sess.strategy, "param_reducer", None),
                 sess.param_rounds - since[1]))
    for reducer, rounds in reducers:
        plan = getattr(reducer, "plan", None)
        if plan is not None and rounds:
            for k, n in plan_launches(plan, rounds, sess.world).items():
                want[k] = want.get(k, 0) + n
    return want


def p16_cli(torch, rank: int) -> dict:
    """(d)'s world-4 part: the CLI with ``--parallelism dp=2,tp=2``
    (gemma-2b) and ``dp=2,ep=2`` (qwen3-moe-30b-a3b), reduced, ``--sync
    auto``, on the world's gloo group (the run of ``launch/train.py``'s
    ``run`` on the group, as ``--data-parallel`` runs it where each rank
    has a card).  Gates: each runs to ``final loss`` with the spec in
    ``describe()``, and launches the wire kernels its arm's plan names
    (``session_wire_launches``)."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    out = {}
    for name, flags in CLI_W4.items():
        args = train.build_parser().parse_args(CLI_W4_BASE + flags)
        buf = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            sess = train.run(args, rank, group=dist.group.WORLD)
        spec = flags[3].split(",")[1]
        desc = sess.strategy.describe()
        w4_gate(f"[{spec}" in desc, f"{name}: describe() {desc!r}")
        w4_gate(sess.device.type == "cuda", f"{name} ran on {sess.device}")
        w4_launch_gate(path_counts(ops), session_wire_launches(sess),
                       f"cli {name}")
        if rank == 0:
            last = buf.getvalue().strip().splitlines()[-1]
            w4_gate(last.startswith("final loss ") and last.endswith(desc),
                    f"{name}: last line {last!r}")
        out[name] = {"losses": list(sess.losses), "describe": desc,
                     "key": sess.planned["strategy_plan"].key,
                     "launches": path_counts(ops),
                     "lines": buf.getvalue().strip().splitlines()[-3:]}
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    return out


def p16_child(rank: int, world: int, store: str, out_dir: str,
              tp_layers: int, ref_g_blocked_path: str,
              ref_path: str, ref_m_path: str) -> None:
    """Phase 16, one of four ranks of a gloo group on the one card: (b)
    the expert-parallel legs, (c) the collective calibration of the
    world, (d) the CLI's tp / ep specs, then (a) tensor parallelism at
    full width on ranks 0 and 1 (ranks 2 and 3 wait)."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.schedule import calibration
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    # every rank makes every group, in one order
    pair = dist.new_group([0, 1])
    tp_group = dist.new_group([0, 1])
    ones = [dist.new_group([r]) for r in range(world)]
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["ep"] = p16_ep(torch, rank, {2: (pair, [0, 1]),
                                     4: (dist.group.WORLD,
                                         list(range(world)))})
    res["ep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cal = calibration.calibrate_topology(device="cuda")
    res["calibration"] = cal.to_json()
    res["calibration_describe"] = cal.describe()
    res["calibration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["cli"] = p16_cli(torch, rank)
    res["cli_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if rank < TP:
        res["tp"] = p16_tp(torch, rank, tp_group, ones[rank], tp_layers,
                           ref_g_blocked_path, ref_path,
                           ref_m_path)
    res["tp_s"] = time.perf_counter() - t0
    res["launches"] = {}      # spawn_world4 compares ranks' counts
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def calibration_kernels(torch, ops, ref) -> dict:
    """(c)'s kernels at the calibration's sizes (CAL_SIZES): quantize_ef
    and topk_ef (the fused encodes, residual in place) and dequant_accum
    at w = CAL_WORLD = 8 (the fused decode of the payload stacked 8
    times), each held bit-equal to its plain version, then timed in turns
    against it (CUDA-graph replay) beside its bound."""
    from repro_torch.core.schedule.calibration import CAL_SIZES, CAL_WORLD
    from repro_torch.kernels.quantize_ef import (dequant_accum_cuda,
                                                 quantize_ef_cuda)
    from repro_torch.kernels.topk_mask import topk_ef_cuda
    dev = torch.device("cuda")
    k = max(1, int(TILE * 0.01))
    out = {"quantize_ef": {}, "dequant_accum": {}, "topk_ef": {}}
    for n in CAL_SIZES:
        gen = torch.Generator(dev).manual_seed(n)
        g = torch.randn(n, generator=gen, device=dev)
        e = torch.zeros(n, device=dev)
        buf = e.clone()
        got = ops.quantize_ef(g, buf, tile=TILE, e_out=buf)
        want = ref.quantize_ef_ref(g, e, tile=TILE)
        q, s = got[0], got[2]
        qw, sw = q.repeat(CAL_WORLD, 1), s.repeat(CAL_WORLD, 1)
        buf2 = e.clone()
        checks = [("quantize_ef", got, want),
                  ("dequant_accum", (ops.dequant_accum(qw, sw, tile=TILE),),
                   (ref.dequant_accum_ref(qw, sw, tile=TILE),)),
                  ("topk_ef", ops.topk_ef(g, buf2, tile=TILE, e_out=buf2),
                   ref.topk_ef_ref(g, e, tile=TILE))]
        torch.cuda.synchronize()
        for name, a, b in checks:
            if not all(same(torch, x, y) for x, y in zip(a, b)):
                fail(f"{name} differs from the plain version at the "
                     f"calibration size n={n}")
        nt = -(-n // TILE)
        w = CAL_WORLD
        shape = f"calibration_{n}"
        out["quantize_ef"][shape] = w4_time(
            torch, lambda: quantize_ef_cuda(g, buf, 1.0, TILE, buf),
            lambda: ref.quantize_ef_ref(g, e, tile=TILE), n,
            bound(13 * n + 4 * nt, QEF_OPS * n))
        out["dequant_accum"][f"{shape}_w{w}"] = w4_time(
            torch, lambda: dequant_accum_cuda(qw, sw, TILE),
            lambda: ref.dequant_accum_ref(qw, sw, tile=TILE), n,
            bound(w * n + 4 * w * nt + 4 * n, 2 * w * n))
        out["topk_ef"][shape] = w4_time(
            torch, lambda: topk_ef_cuda(g, buf, k, TILE, ITERS, 1.0, buf),
            lambda: ref.topk_ef_ref(g, e, tile=TILE), n,
            bound(16 * n, TOPK_OPS * n))
        del g, e, buf, buf2, q, s, qw, sw, got, want, checks
        torch.cuda.empty_cache()
    return out


def p16_calibration(torch, ops, ref, card) -> dict:
    """(c) in this process: ``measure_compression_costs`` on the card at
    the reference's set and sizes (every kernel launch it makes held to
    its count and route), the fitted table with its quality, written as
    the ``--compression-costs`` JSON and read back by ``plan_auto``; then
    ``calibrate_topology`` at NCCL world 1 (one rank: the degenerate
    fit), and the kernels timed at the calibration's sizes."""
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.core.schedule.calibration import (CAL_SIZES, CAL_WORLD,
                                                       CALIBRATION_SET,
                                                       calibrate_topology,
                                                       measure_compression_costs)
    from repro_torch.launch.dist import destroy_group, init_group
    repeats = 3
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tab = measure_compression_costs(repeats=repeats, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_counts(ops)
    n = len(CAL_SIZES)
    # encode: the payload call, the discarded call and the timed repeats;
    # decode: the discarded call and the timed repeats
    want = {"quantize_ef": n * (repeats + 2),
            "dequant_accum": n * (repeats + 1),
            "dequant_accum[warp]": n * (repeats + 1),
            "topk_ef": n * (repeats + 2), "topk_ef[warp]": n * (repeats + 2)}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"calibration: kernel launches {got}, expected {want} (every "
             f"fused hook of CALIBRATION_SET at {n} sizes; dequant_accum at "
             f"w = {CAL_WORLD}, warp routes)")
    print(f"calibration: measure_compression_costs at {list(CAL_SIZES)} f32 "
          f"({[c for c, _ in CALIBRATION_SET]}), {seconds:.3f} s, kernel "
          f"launches {got} [{card}]", flush=True)
    quality = {k: (rms, r2, deg) for k, rms, r2, deg in tab.quality}
    for key, bw, c0 in tab.entries:
        rms, r2, deg = quality[key]
        print(f"  {key}: {bw / 1e9:.3f} GB/s + {c0 * 1e6:.3f} us, rms "
              f"{rms * 1e6:.3f} us, R² {r2:.4f}"
              + (" [degenerate]" if deg else "") + f" [{card}]", flush=True)
    out_dir = ROOT / "build" / P16_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "compression_costs.json"
    path.write_text(json.dumps(tab.to_json(), indent=1))
    sess = TrainSession(SessionConfig(arch="gemma-2b", reduced=True,
                                      batch=2, seq=32, device="cuda"))
    sess.plan_auto(topology="commodity_cluster", t_backward_s=0.05,
                   compression_costs=str(path))
    back = sess.planned["cost_table"]
    if back is None or back.entries != tab.entries or \
            back.cal_world != CAL_WORLD:
        fail("calibration: the --compression-costs JSON did not read back "
             "into plan_auto's cost table")
    print(f"calibration: {path.name} read back by plan_auto "
          f"(commodity_cluster, winner {sess.planned['strategy_plan'].key})",
          flush=True)
    del sess
    destroy_group()
    init_group(torch.device("cuda"))
    t0 = time.perf_counter()
    topo = calibrate_topology(device="cuda")
    topo_s = time.perf_counter() - t0
    fit = topo.fit_for("data")
    if not fit.degenerate or topo.world != 1:
        fail(f"calibration at NCCL world 1: {topo.describe()}")
    print(f"{topo.describe()} (NCCL world 1, {topo_s:.3f} s) [{card}]",
          flush=True)
    destroy_group()
    kernels = calibration_kernels(torch, ops, ref)
    for name, per_shape in kernels.items():
        for shape, t in per_shape.items():
            print(f"{name} {shape} n={t['n']}: device time kernel "
                  f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} "
                  f"us, bound {t['bound_ms'] * 1e3:.3f} us "
                  f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of the "
                  f"bound ({t['timer']}) [{card}]", flush=True)
    return {"table": tab.to_json(), "seconds": seconds, "launches": launches,
            "nccl_world1": topo.to_json(), "nccl_world1_s": topo_s,
            "kernels": kernels}


def p16_cli_world1(torch, ops, train, card) -> dict:
    """(d) at world 1: ``train --arch gemma-2b --sync auto --calibrate
    --replan-drift-pct REPLAN_PCT --replan-every REPLAN_EVERY`` at full
    width (batch 4 x 512, 3 steps).  Gates: the calibration and the drift
    table are printed, the re-written record carries the calibration and
    drift blocks with the reference's keys, no more re-plans ran than
    ``max_replans`` (1), and the run launched the wire kernels that its
    arm's plan names, before and after each re-plan
    (``session_wire_launches``)."""
    import contextlib
    import io
    from repro_torch.api import TrainSession
    from repro_torch.launch import paths
    from repro_torch.launch.dist import destroy_group
    # a re-plan may install another arm: count each arm's rounds apart
    want, since = {}, [(0, 0)]
    real = TrainSession._replan

    def watched(self, *a, **kw):
        for k, n in session_wire_launches(self, since[-1]).items():
            want[k] = want.get(k, 0) + n
        since.append((self.grad_rounds, self.param_rounds))
        return real(self, *a, **kw)
    flags = TRAIN_ARGS + ["--sync", "auto", "--calibrate",
                          "--replan-drift-pct", str(REPLAN_PCT),
                          "--replan-every", str(REPLAN_EVERY)]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    TrainSession._replan = watched
    try:
        with contextlib.redirect_stdout(buf):
            sess = train.main(flags)
    finally:
        TrainSession._replan = real
    seconds = time.perf_counter() - t0
    for k, n in session_wire_launches(sess, since[-1]).items():
        want[k] = want.get(k, 0) + n
    launches = path_counts(ops)
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"the CLI at world 1 launched {got}, its arms' plans name "
             f"{want}")
    text = buf.getvalue()
    print(text, end="", flush=True)
    for want in ("calibrated topology: data:1@calibrated",
                 "modeled vs measured (", "plan record (with drift): "):
        if want not in text:
            fail(f"the CLI at world 1 did not print {want!r}")
    rec = json.loads((Path(paths.COMM_PLANS) / "gemma-2b.json").read_text())
    if set(rec.get("drift", {})) != DRIFT_KEYS or \
            set(rec.get("calibration", {})) != CALIBRATION_KEYS:
        fail(f"the plan record's drift / calibration blocks: "
             f"{sorted(rec.get('drift', {}))}, "
             f"{sorted(rec.get('calibration', {}))}")
    if not 0 <= rec["drift"]["replans"] <= 1 or \
            sess.replans != rec["drift"]["replans"]:
        fail(f"replans {sess.replans} (record {rec['drift']['replans']}), "
             f"max_replans 1")
    res = {"seconds": seconds, "losses": list(sess.losses),
           "step_ms_all": [t * 1e3 for t in sess.step_times],
           "replans": sess.replans, "events": sess.replan_events,
           "drift": rec["drift"], "calibration": rec["calibration"],
           "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"cli --sync auto --calibrate --replan-drift-pct {REPLAN_PCT} "
          f"--replan-every {REPLAN_EVERY} [{card}]: {seconds:.1f} s, "
          f"losses {[round(x, 4) for x in sess.losses]}, measured "
          f"{rec['drift']['measured_step_s'] * 1e3:.3f} ms/step against "
          f"modeled wall {rec['drift']['modeled_wall_step_s'] * 1e3:.3f} "
          f"(drift {rec['drift']['drift_pct']:+.1f}%), replans "
          f"{sess.replans}", flush=True)
    del sess
    destroy_group()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_parallel(torch, ops, ref, train, card) -> dict:
    """Phase 16: (a) tensor parallelism at full width and (b) expert
    parallelism at full width (one spawned gloo world of four on the card,
    with (c)'s world-4 calibration and (d)'s world-4 CLI runs), then (c)
    the calibration in this process and (d) the CLI at world 1."""
    t0 = time.perf_counter()
    print(f"phase 16: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated at its start", flush=True)
    layers = 18
    while layers > 2 and TP * tp_reckoning(layers)["peak_per_rank"] > \
            TP_BUDGET:
        layers -= 2
    rk = tp_reckoning(layers)
    print(f"tensor parallelism (a): gemma-2b tp={TP} at {layers} of 18 "
          f"layers: {rk['params_per_rank'] / 1e9:.3f} B parameters a rank "
          f"({rk['ffn_params'] // TP / 1e9:.3f} B of the "
          f"{rk['ffn_params'] / 1e9:.3f} B FFN); reckoning "
          f"{rk['peak_per_rank'] / 2**30:.2f} GiB a rank, "
          f"{TP * rk['peak_per_rank'] / 2**30:.2f} GiB for both (budget "
          f"{TP_BUDGET / 2**30:.0f} GiB); tp wire staged "
          f"{rk['tp_staged_per_step'] / 1e6:.1f} MB a step a rank "
          f"({layers} layers x 2 all-reduces x 2 copies x 8 MiB)",
          flush=True)
    ref_run = p16_reference(torch, layers)
    print(f"tensor parallelism (a): the unsharded run at world 1, losses "
          f"{[round(x, 5) for x in ref_run['losses']]} [{card}]",
          flush=True)
    ranks, seconds = spawn_world4(torch, p16_child, P16_DIR,
                                  (layers, ref_run["g_blocked_path"],
                                   ref_run["path"],
                                   ref_run["m_path"]), world=P16_WORLD)
    tp = [r["tp"] for r in ranks[:TP]]
    if tp[0]["losses"] != tp[1]["losses"]:
        fail(f"tp ranks' losses differ: {tp[0]['losses']} / "
             f"{tp[1]['losses']}")
    for s, (a, b) in enumerate(zip(tp[0]["losses"], ref_run["losses"])):
        if abs(a - b) > TP_LOSS_RTOL * abs(b):
            fail(f"tp loss at step {s}: {a} against the unsharded {b}, "
                 f"beyond rtol {TP_LOSS_RTOL}")
    a = tp[0]
    step_ms = statistics.median(a["step_ms_all"][1:])
    print(f"tensor parallelism (a) [{card}]: losses "
          f"{[round(x, 5) for x in a['losses']]} (rank 1 bit-equal; the "
          f"unsharded run {[round(x, 5) for x in ref_run['losses']]}); "
          + "; ".join(
              f"{what}: relative L2 gap up to "
              f"{max(r[k]['max'] for r in tp)} ({tp[0][k]['max_leaf']} on "
              f"rank 0; median {tp[0][k]['median']}; limit "
              f"{tp[0][k]['limit']})"
              for k, what in (("blocked_gap", "the first step's gradients "
                                              "against the control"),
                              ("m_gap", "Adam's first moment after 3 "
                                        "steps")))
          + f"; the control's first-step gradients against the "
          f"unsharded run's: relative L2 gap up to "
          f"{ref_run['control_gap']['max']} (median "
          f"{ref_run['control_gap']['median']}; limit {TP_GRAD_RTOL}); "
          f"parameters: max |Δ| {max(r['params_max_abs_diff'] for r in tp)}, "
          f"{sum(r['params_differing'] for r in tp)} of "
          f"{sum(r['params_compared'] for r in tp)} entries differ, Adam "
          f"envelope {a['adam_envelope']}; f32 leg bit-equal to "
          f"mlp_blocked(blocks=2): {a['tiny_f32']['bit_equal']}; staged "
          f"{a['staged_per_step'][0] / 1e6:.1f} MB a step (tp wire "
          f"{a['reckoning']['tp_staged_per_step'] / 1e6:.1f} + DP edge "
          f"{a['dp_staged'] / 1e6:.1f}); step {step_ms:.1f} ms (all "
          f"{[round(t, 1) for t in a['step_ms_all']]}); peak "
          f"{a['peak_bytes'] / 2**30:.2f} GiB a rank; launches "
          f"{ {k: v for k, v in a['launches'].items() if v} }", flush=True)
    for ep in EP_SIZES:
        r0 = ranks[0]["ep"][f"ep{ep}"]
        for variant in ("direct", "ring"):
            leg = r0[variant]
            print(f"expert parallelism (b) ep={ep} {variant} [{card}]: "
                  f"{EP_ARCH} widths, {128 // ep} experts a rank, "
                  f"{EP_BATCH} x {EP_SEQ} tokens a rank; drops "
                  f"{leg['drops_total']} = the one process's "
                  f"{r0['one_process']['drops']}; expert parameters "
                  f"bit-equal {leg['params_bit_equal']} (max |Δ| "
                  f"{leg['params_max_abs_diff']}), moments bit-equal "
                  f"{leg['moments_bit_equal']}, losses of the ranks "
                  f"bit-equal {leg['losses_bit_equal']}; {leg['a2a_calls']} "
                  f"all-to-alls in {TRAIN_STEPS} steps; staged "
                  f"{leg['staged_bytes'] / 1e6:.1f} MB; steps "
                  f"{[round(t, 1) for t in leg['step_ms']]} ms (one "
                  f"process: {[round(t, 1) for t in r0['one_process']['step_ms']]})",
                  flush=True)
    cal4 = ranks[0]["calibration"]
    print(f"calibration on the gloo world of 4 (rank 0, card tensors "
          f"staged) [{card}]:\n{ranks[0]['calibration_describe']}",
          flush=True)
    for name, r in ranks[0]["cli"].items():
        print(f"cli world 4 {name}: {r['lines'][-1]}", flush=True)
    calib = p16_calibration(torch, ops, ref, card)
    cli1 = p16_cli_world1(torch, ops, train, card)
    seconds_all = time.perf_counter() - t0
    print(f"phase 16 took {seconds_all:.1f} s (the spawned world "
          f"{seconds:.1f} s: ep {ranks[0]['ep_s']:.1f}, calibration "
          f"{ranks[0]['calibration_s']:.1f}, cli {ranks[0]['cli_s']:.1f}, "
          f"tp {ranks[0]['tp_s']:.1f})", flush=True)
    return {"tp": tp, "tp_reference": ref_run,
            "ep": {k: ranks[0]["ep"][k] for k in ranks[0]["ep"]},
            "calibration_world4": cal4, "cli_world4": ranks[0]["cli"],
            "calibration": calib, "cli_world1": cli1,
            "spawn_s": seconds, "seconds": seconds_all,
            "launches": {"tp_rank0": tp[0]["launches"],
                         "calibration": calib["launches"],
                         "cli_world1": cli1["launches"]}}


# -- phase 17: the elastic runtime -------------------------------------------

ELASTIC_TOPOLOGY = "node:2@datacenter,device:4@fast_ici"
ELASTIC_SURVIVORS = "node:2@datacenter,device:3@fast_ici"
ELASTIC_TRACE = "kill:3@2,kill:7@2,restore:3@4,restore:7@4"   # 8 -> 6 -> 8
# (a): phase 8's full width and batch, the int8_fused wire without error
# feedback (no state outside params and opt, so a faulted run must equal
# the unfaulted one bit for bit), through one reshard, at 4 of gemma-2b's
# 18 layers: the whole call's 1200 s hold phase 19 only with a shorter
# round trip (at 18 layers its 25.06 GB checkpoint took 152-181 s, a
# third of it sha256; at 9 layers 15.15 GB took 96-108 s and the call
# 1142 s; at 4 it is 9.65 GB); a run is held to about 45 GiB of disk
# writes, of which phase 16 writes ~19; the 6 -> 8 leg runs in (b)
ELASTIC_FULL_TRACE = "kill:3@2,kill:7@2"
ELASTIC_LAYERS = 4
ELASTIC_STEPS = 4
ELASTIC_EVENTS = [(2, "reshard", 8, 6, ELASTIC_SURVIVORS)]
ELASTIC_ARGS = ["--arch", "gemma-2b", "--no-reduced", "--optimizer", "adam",
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(ELASTIC_STEPS), "--seed", "0",
                "--log-every", "1", *TRAIN_RUNS["int8_fused_no_ef"][0]]
ELASTIC_FLAGS = ["--elastic", "--topology", ELASTIC_TOPOLOGY,
                 "--fault-trace", ELASTIC_FULL_TRACE]
ELASTIC_WIRE = TRAIN_RUNS["int8_fused_no_ef"][1]
ELASTIC_MEMORY_SLACK = 0.5 * 2**30    # allocated before a spawn vs before
#                                       the first session
# (b): reduced gemma-2b in f32, card against CPU; name: (trace, topology,
# steps run, runtime config, strategy)
ELASTIC_SMALL = dict(arch="gemma-2b", reduced=True, steps=6, batch=4, seq=64,
                     lr=3e-3, warmup=1)
ELASTIC_SCENARIOS = {
    "vanilla": (ELASTIC_TRACE, ELASTIC_TOPOLOGY, 6, {}, None),
    "auto": ("kill:3@2,kill:7@2", ELASTIC_TOPOLOGY, 4,
             dict(plan=True, t_backward_s=0.05), None),
    "local_sgd": ("slow:1x4@1", ELASTIC_TOPOLOGY, 6, {}, "local_sgd"),
    "replan": ("slow:1x6@1", "device:8@fast_ici", 5,
               dict(plan=True, t_backward_s=0.5), None),
    "int8_fused_ef": ("kill:3@2,kill:7@2", ELASTIC_TOPOLOGY, 4, {},
                      "int8_fused"),
}


def tree_bit_digests(torch, tree) -> list:
    """``digest`` of every leaf, as lists (the bits of a 2.5 B-parameter
    state compared without a host copy)."""
    from repro_torch._tree import tree_leaves
    return [digest(torch, x).tolist() for x in tree_leaves(tree)]


def elastic_reckoning(cfg) -> dict:
    """The checkpoint of gemma-2b's Adam session, reckoned from its leaves
    (meta tensors of the model's shapes): the parameters in their dtype,
    Adam's two f32 moments."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.layers import desc_leaves
    from repro_torch.models.model import resolve_dtype
    leaves = desc_leaves(Model(cfg).param_desc())
    n = sum(math.prod(d.shape) for d in leaves)
    params = n * torch.empty((), dtype=resolve_dtype(cfg.param_dtype)) \
        .element_size()
    return {"params": n, "param_bytes": params, "moment_bytes": 2 * 4 * n,
            "bytes": params + 2 * 4 * n, "leaves": 3 * len(leaves)}


class ElasticProbes:
    """For (a)'s run: wraps the runtime's ``_spawn``, the session's
    ``save_checkpoint`` / ``load_checkpoint`` and the checkpoint's
    ``_sha256_file`` to record the memory allocated before each spawn, the
    seconds of each save, load and spawn (the factory and the topology,
    the load apart), and the sha256 seconds of the saves and the loads.
    Only times and memory are read; every call goes through unchanged."""

    def __init__(self, torch):
        from repro_torch.api import TrainSession
        from repro_torch.checkpoint import checkpoint as ck
        from repro_torch.elastic.runtime import ElasticRuntime
        self.torch = torch
        self.targets = [(ElasticRuntime, "_spawn"),
                        (TrainSession, "save_checkpoint"),
                        (TrainSession, "load_checkpoint"),
                        (ck, "_sha256_file")]
        self.rec = {k: [] for k in ("allocated_before_spawn", "spawn_s",
                                    "save_s", "load_s", "sha256_save_s",
                                    "sha256_load_s")}
        self._in = "save"

    def _timed(self, key, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.rec[key].append(time.perf_counter() - t0)
        return out

    def __enter__(self):
        spawn, save, load, sha = [getattr(o, n) for o, n in self.targets]
        probes = self

        def _spawn(rt, topo, restore_from):
            probes.rec["allocated_before_spawn"].append(
                probes.torch.cuda.memory_allocated())
            loads = sum(probes.rec["load_s"])
            out = probes._timed("spawn_s",
                                lambda: spawn(rt, topo, restore_from))
            probes.rec["spawn_s"][-1] -= sum(probes.rec["load_s"]) - loads
            return out

        def save_checkpoint(sess, path):
            probes._in = "save"
            probes.rec["sha256_save_s"].append(0.0)
            out = probes._timed("save_s", lambda: save(sess, path))
            print(f"  elastic: saved at step {sess.step} in "
                  f"{probes.rec['save_s'][-1]:.2f} s (sha256 "
                  f"{probes.rec['sha256_save_s'][-1]:.2f} s)", flush=True)
            return out

        def load_checkpoint(sess, path):
            probes._in = "load"
            probes.rec["sha256_load_s"].append(0.0)
            out = probes._timed("load_s", lambda: load(sess, path))
            print(f"  elastic: loaded in {probes.rec['load_s'][-1]:.2f} s "
                  f"(sha256 {probes.rec['sha256_load_s'][-1]:.2f} s)",
                  flush=True)
            return out

        def _sha256_file(path, chunk=1 << 20):
            # summed into the save or load it belongs to (a save hashes
            # its payload and its manifest)
            t0 = time.perf_counter()
            out = sha(path, chunk)
            probes.rec[f"sha256_{probes._in}_s"][-1] += \
                time.perf_counter() - t0
            return out

        self._orig = [spawn, save, load, sha]
        for (o, n), f in zip(self.targets, (_spawn, save_checkpoint,
                                            load_checkpoint, _sha256_file)):
            setattr(o, n, f)
        return self.rec

    def __exit__(self, *exc):
        for (o, n), f in zip(self.targets, self._orig):
            setattr(o, n, f)


def host_peak_rss() -> int:
    """This process's peak resident set so far, in bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class elastic_depth:
    """Within the block, the sessions the CLI builds (``api.get_config``)
    take gemma-2b cut to ``ELASTIC_LAYERS`` layers, its widths whole."""

    def __enter__(self):
        from repro_torch import api
        self._orig = api.get_config
        api.get_config = lambda arch: dataclasses.replace(
            self._orig(arch), num_layers=ELASTIC_LAYERS)
        return self

    def __exit__(self, *exc):
        from repro_torch import api
        api.get_config = self._orig


def p17_full_width(torch, ops, train, card) -> dict:
    """Phase 17 (a): gemma-2b at phase 8's full width, ``ELASTIC_LAYERS``
    deep, through the CLI's ``--elastic`` on the 8 -> 6 -> 8 trace,
    against an unfaulted run of the same wire in this process."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    rk = elastic_reckoning(dataclasses.replace(get_config("gemma-2b"),
                                               num_layers=ELASTIC_LAYERS))
    tmp = ROOT / "build" / "elastic_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    free = shutil.disk_usage(tmp).free
    print(f"elastic (a) reckoning: checkpoint {rk['bytes'] / 1e9:.3f} GB "
          f"({rk['leaves']} leaves: parameters {rk['param_bytes'] / 1e9:.3f} "
          f"GB, Adam's moments {rk['moment_bytes'] / 1e9:.3f} GB f32), "
          f"the same on the card for one session's state; the disk under "
          f"build/ has {free / 1e9:.1f} GB free", flush=True)
    if free < rk["bytes"]:
        fail(f"elastic (a): {free / 1e9:.1f} GB free under {tmp}, the "
             f"reshard's checkpoint needs {rk['bytes'] / 1e9:.1f} GB")

    def counted(argv):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with elastic_depth():
            out = train.main(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, path_counts(ops)

    def gate_launches(launches, n_buckets, what):
        for kname, count in launches.items():
            want = n_buckets * ELASTIC_STEPS if kname in ELASTIC_WIRE else 0
            if count != want or (kname in ELASTIC_WIRE and want <= 0):
                fail(f"elastic (a) {what}: kernel {kname} launched {count} "
                     f"times, expected {want} (= {n_buckets} buckets x "
                     f"{ELASTIC_STEPS} steps on the warp routes, 0 for the "
                     f"others)")

    def state_digests(sess):
        return {"params": tree_bit_digests(torch, sess.params),
                "m": tree_bit_digests(torch, sess.opt_state["m"]),
                "v": tree_bit_digests(torch, sess.opt_state["v"])}

    gc.collect()
    torch.cuda.empty_cache()
    base0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    whole, whole_s, whole_launches = counted(ELASTIC_ARGS)
    n_buckets = whole.synchronizer.plan.n_buckets
    gate_launches(whole_launches, n_buckets, "unfaulted run")
    state = torch.cuda.memory_allocated() - base0
    transient = torch.cuda.max_memory_allocated() - base0 - state
    want = {"losses": list(whole.losses), **state_digests(whole)}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reckoned_peak = 2 * rk["bytes"] + transient
    print(f"elastic (a) unfaulted run [{card}]: {ELASTIC_STEPS} steps in "
          f"{whole_s:.1f} s, losses {[round(x, 4) for x in want['losses']]}, "
          f"state on the card {state / 2**30:.3f} GiB (reckoned "
          f"{rk['bytes'] / 2**30:.3f}), the step's transients "
          f"{transient / 2**30:.3f} GiB; the elastic run's peak reckoning: "
          f"one session's state + the restored copy + the step's transients "
          f"= {reckoned_peak / 2**30:.3f} GiB", flush=True)

    tempfile.tempdir, old_tmp = str(tmp), tempfile.tempdir
    rss0 = host_peak_rss()
    torch.cuda.reset_peak_memory_stats()
    try:
        with ElasticProbes(torch) as rec:
            rt, run_s, launches = counted(ELASTIC_ARGS + ELASTIC_FLAGS)
    finally:
        tempfile.tempdir = old_tmp
    peak = torch.cuda.max_memory_allocated() - base
    rss = host_peak_rss()
    sess = rt.session
    if sess.device.type != "cuda":
        fail(f"elastic (a) ran on {sess.device}, not on the card")
    events = [(e.step, e.kind, e.old_world, e.new_world, e.topology)
              for e in rt.events]
    if events != ELASTIC_EVENTS or rt.grad_rounds != ELASTIC_STEPS:
        fail(f"elastic (a): events {events}, grad rounds {rt.grad_rounds}; "
             f"expected {ELASTIC_EVENTS} and {ELASTIC_STEPS}")
    if sess.synchronizer.plan.n_buckets != n_buckets:
        fail(f"elastic (a): {sess.synchronizer.plan.n_buckets} buckets, the "
             f"unfaulted run {n_buckets}")
    gate_launches(launches, n_buckets, "the --elastic run")
    got = {"losses": list(rt.losses), **state_digests(sess)}
    ckpt = Path(rt.cfg.checkpoint_dir) / "elastic.npz"
    on_disk = ckpt.stat().st_size
    dtype = sess.model_cfg.param_dtype
    del rt, sess
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    same = {k: got[k] == want[k] for k in want}
    if not all(same.values()):
        # is the unfaulted run itself repeatable on this card?
        again, _, _ = counted(ELASTIC_ARGS)
        repeat = {"losses": list(again.losses), **state_digests(again)}
        del again
        gc.collect()
        torch.cuda.empty_cache()
        fail(f"elastic (a): the faulted run differs from the unfaulted one "
             f"(bit-equal: {same}; losses {got['losses']} vs "
             f"{want['losses']}); a second unfaulted run is bit-equal to the "
             f"first: { {k: repeat[k] == want[k] for k in want} }")
    spawned = rec["allocated_before_spawn"]
    if max(abs(a - base) for a in spawned) > ELASTIC_MEMORY_SLACK:
        fail(f"elastic (a): allocated before the spawns "
             f"{[round(a / 2**30, 3) for a in spawned]} GiB, before the first "
             f"session {base / 2**30:.3f} GiB (slack 0.5 GiB)")
    if peak > reckoned_peak:
        fail(f"elastic (a): peak {peak / 2**30:.3f} GiB over the reckoning "
             f"{reckoned_peak / 2**30:.3f} GiB")
    res = {"events": events, "losses": got["losses"], "n_buckets": n_buckets,
           "launches": launches, "unfaulted_launches": whole_launches,
           "run_s": run_s, "unfaulted_s": whole_s,
           "checkpoint_reckoned_bytes": rk["bytes"],
           "checkpoint_disk_bytes": on_disk,
           "save_s": rec["save_s"], "load_s": rec["load_s"],
           "sha256_save_s": rec["sha256_save_s"],
           "sha256_load_s": rec["sha256_load_s"],
           "spawn_s": rec["spawn_s"],
           "allocated_before_spawn": spawned, "allocated_base": base,
           "state_bytes": state, "transient_bytes": transient,
           "peak_bytes": peak, "reckoned_peak_bytes": reckoned_peak,
           "host_peak_rss_before": rss0, "host_peak_rss": rss}
    saves = ", ".join(
        f"{s:.2f} s ({on_disk / s / 1e9:.2f} GB/s; sha256 {h:.2f} s)"
        for s, h in zip(rec["save_s"], rec["sha256_save_s"]))
    loads = ", ".join(
        f"{s:.2f} s ({on_disk / s / 1e9:.2f} GB/s; sha256 {h:.2f} s)"
        for s, h in zip(rec["load_s"], rec["sha256_load_s"]))
    print(f"elastic (a) [{card}]: gemma-2b cut to {ELASTIC_LAYERS} of 18 "
          f"layers, {rk['params']} params, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {dtype}, int8_fused without "
          f"EF, "
          f"{ELASTIC_FULL_TRACE}: events {events}; {ELASTIC_STEPS} losses, "
          f"parameters and both moments bit-equal to the unfaulted run; "
          f"launches { {k: v for k, v in launches.items() if v} } "
          f"(= {n_buckets} buckets x {ELASTIC_STEPS} steps); run "
          f"{run_s:.1f} s", flush=True)
    print(f"elastic (a) round trip [{card}]: checkpoint {on_disk / 1e9:.3f} "
          f"GB on disk (reckoned {rk['bytes'] / 1e9:.3f}); saves {saves}; "
          f"loads {loads} (warm: the file was just written); spawns "
          f"(factory + topology, the load apart) "
          f"{[round(s, 2) for s in rec['spawn_s']]} s; allocated before "
          f"each spawn {[round(a / 2**30, 3) for a in spawned]} GiB (before "
          f"the first session {base / 2**30:.3f}); peak "
          f"{peak / 2**30:.3f} GiB above it (reckoning "
          f"{reckoned_peak / 2**30:.3f}); host peak RSS "
          f"{rss / 2**30:.2f} GiB (before the run {rss0 / 2**30:.2f})",
          flush=True)
    return res


def elastic_summary(rt) -> dict:
    """What the card's and the CPU's runtimes must agree on: the events,
    their table, the round counters, the installed scheduler, the plan
    record's world and topology."""
    from repro_torch.launch.report import (comm_plan_record,
                                           render_elastic_events)
    s = rt.session
    sched = s.strategy.scheduler if s.strategy is not None else None
    out = {"events": [dataclasses.asdict(e) for e in rt.events],
           "render": render_elastic_events(rt.events),
           "rounds": [rt.grad_rounds, rt.param_rounds, rt.control_rounds],
           "scheduler": sched and [
               sched.name, getattr(getattr(sched, "cfg", None), "period",
                                   None)]}
    if s.planned:
        rec = comm_plan_record(s.planned["strategy_plan"].comm)
        out["record"] = [rec["world"], rec.get("topology", {}).get("spec")]
    return out


def p17_small(torch, card) -> dict:
    """Phase 17 (b): reduced gemma-2b in f32, each scenario of
    ``ELASTIC_SCENARIOS`` on the card and on the CPU (a gloo group of the
    one rank) from the same weights."""
    import shutil
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.api import SessionConfig, TrainSession
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import SyncConfig, SyncStrategy, make_strategy
    from repro_torch.core.strategy import get_scheduler
    from repro_torch.elastic import (ElasticConfig, ElasticRuntime,
                                     FaultSchedule, SimulatedExecutor)
    from repro_torch.launch.dist import init_group
    from repro_torch.models import Model
    cfg = reduced(get_config("gemma-2b"))
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0))
    init_group(torch.device("cuda"), world_size=None)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    root = ROOT / "build" / "elastic_small"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for name, (trace, topo, steps, rcfg, strat) in ELASTIC_SCENARIOS.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            group = gloo if dev == "cpu" else None

            def factory(dev=dev, group=group, strat=strat):
                s = TrainSession(SessionConfig(device=dev, **ELASTIC_SMALL),
                                 params=params, group=group)
                if strat == "local_sgd":
                    s.strategy = SyncStrategy(
                        scheduler=get_scheduler("local_sgd", period=2))
                elif strat == "int8_fused":
                    s.strategy = make_strategy(
                        "every_step", group=group,
                        sync=SyncConfig(compressor="int8_fused"))
                return s
            fresh = []            # per step: no residual before it

            def executor(session, step, alive, slow,
                         inner=SimulatedExecutor()):
                fresh.append(session.sync_state is None)
                return inner(session, step, alive, slow)
            rt = ElasticRuntime(
                factory, FaultSchedule.from_spec(trace, 8),
                ElasticConfig(topology=topo,
                              checkpoint_dir=str(root / name / dev), **rcfg),
                executor=executor)
            rt.run(steps)
            runs[dev] = (rt, fresh)
        (rc, fc), (rh, _) = runs["cuda"], runs["cpu"]
        sc, sh = elastic_summary(rc), elastic_summary(rh)
        lc, lh = rc.losses, rh.losses
        rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
        if sc != sh or len(lc) != steps or not (
                all(map(math.isfinite, lc)) and rel[0] <= 1e-5
                and max(rel) <= 1e-4):
            fail(f"elastic (b) {name}: the card's run {sc} with losses {lc} "
                 f"disagrees with the CPU's {sh} with losses {lh}")
        kinds = [e["kind"] for e in sc["events"]]
        if name == "vanilla":
            whole = factory(dev="cuda", group=None)
            whole.run(steps)
            if whole.losses != lc or not all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves(whole.params),
                        tree_leaves(rc.session.params))):
                fail(f"elastic (b) vanilla: the faulted card run {lc} is not "
                     f"bit-equal to its unfaulted run {whole.losses}")
            del whole
        elif name == "auto":
            if sc["record"] != [6, ELASTIC_SURVIVORS] or \
                    not sc["events"][0]["plan_key"]:
                fail(f"elastic (b) auto: record {sc['record']}, events "
                     f"{sc['events']}")
        elif name == "local_sgd":
            if kinds != ["backpressure"] or sc["scheduler"] != \
                    ["local_sgd", 4]:
                fail(f"elastic (b) local_sgd: events {sc['events']}, "
                     f"scheduler {sc['scheduler']}")
        elif name == "replan":
            if kinds != ["replan"] or \
                    not sc["events"][0]["note"].startswith("installed") or \
                    sc["scheduler"][0] != "local_sgd":
                fail(f"elastic (b) replan: events {sc['events']}, scheduler "
                     f"{sc['scheduler']}")
        elif name == "int8_fused_ef":
            with open(root / name / "cuda" / "elastic.json") as f:
                keys = json.load(f)["keys"]
            # a fresh session before steps 0 and 2 (the reshard): its EF
            # residuals are made, zero, at that step's build
            if fc != [True, False, True, False] or not all(
                    k.startswith(("params/", "opt/")) for k in keys):
                fail(f"elastic (b) int8_fused_ef: fresh EF state before each "
                     f"step {fc}, checkpoint keys {keys[:4]}...")
        out[name] = {**sc, "losses_card": lc, "losses_cpu": lh,
                     "max_rel_diff": max(rel)}
        print(f"elastic (b) {name} [{card}]: reduced gemma-2b f32, {trace} "
              f"on {topo}, {steps} steps: card = CPU in events "
              f"{[(e['step'], e['kind'], e['note']) for e in sc['events']]}"
              f", plan keys {[e['plan_key'] for e in sc['events']]}, rounds "
              f"{sc['rounds']}, scheduler {sc['scheduler']}; losses max rel "
              f"diff {max(rel):.3e}", flush=True)
        del runs, rc, rh
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_elastic(torch, ops, train, card) -> dict:
    """Phase 17: (a) the elastic runtime at full width through the CLI,
    (b) its scenarios reduced, the card against the CPU."""
    from repro_torch.launch.dist import destroy_group
    t0 = time.perf_counter()
    print(f"phase 17: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated at its start", flush=True)
    full = p17_full_width(torch, ops, train, card)
    t1 = time.perf_counter()
    small = p17_small(torch, card)
    destroy_group()
    seconds = time.perf_counter() - t0
    print(f"phase 17 took {seconds:.1f} s ((a) {t1 - t0:.1f} s, (b) "
          f"{seconds - (t1 - t0):.1f} s) [{card}]", flush=True)
    return {"full_width": full, "small": small, "seconds": seconds,
            "full_width_s": t1 - t0,
            "launches": {"elastic_int8_fused_no_ef": full["launches"],
                         "elastic_unfaulted": full["unfaulted_launches"]}}


# -- phase 18: the dry run and the op analysis ------------------------------

# (a) the dry-run CLI at the 16x16 mesh's rank 0, on CPU fake tensors, one
# process per shape, all started together; train at one micro-batch (the
# same program as at the reference's 4, whose trace takes 4x as long on
# the host, ~160 s against the phase's 90 s)
DRYRUN_ARCH = "gemma-2b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 240
# (b) one full-width step of each phase on the card at world 1: train and
# prefill at 1 x 4096 tokens, and one decode tick of the engine at 32 slots
# with the int8 pool (every slot at position 100 of max_len 4096)
P18_TOKENS = (1, 4096)
P18_SLOTS, P18_MAX_LEN, P18_POS = 32, 4096, 100
# each step's kernel calls, by kernel and route: flash on every one of
# gemma-2b's 18 layers at the prefill (wgmma: bf16, head dim 256), the
# pool's two paged leaves (K and V of one segment) at the tick
P18_WANT = {"train": {}, "prefill": {"flash_attention[wgmma]": 18},
            "decode_tick": {"quantize_tiles[warp]": 2}}


def p18_cli_start(out_dir: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for shape in DRYRUN_SHAPES:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                DRYRUN_ARCH, "--shape", shape, "--out", str(out_dir)]
        if shape == "train_4k":
            argv += ["--microbatches", "1"]
        procs[shape] = subprocess.Popen(argv, cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    return procs


def p18_cli_finish(procs: dict, out_dir: Path, t0: float, card) -> dict:
    """(a)'s records: each process exits 0 with its ``[ok]`` line, and
    each record has the reference's keys and a layout."""
    out = {}
    for shape, proc in procs.items():
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            fail(f"dry run (a): {DRYRUN_ARCH} {shape} still tracing after "
                 f"{DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0 or f"[ok] {DRYRUN_ARCH} {shape} 16x16" \
                not in log:
            fail(f"dry run (a): {DRYRUN_ARCH} {shape} exited "
                 f"{proc.returncode}: {log[-2000:]}")
        rec = json.loads((out_dir / f"{DRYRUN_ARCH}_{shape}_16x16_baseline"
                                    f".json").read_text())
        missing = {"arch", "shape", "variant", "mesh", "devices", "phase",
                   "memory_analysis", "cost_analysis", "hlo", "trace_s",
                   "layout"} - set(rec)
        if missing or rec["hlo"]["dot_flops_per_device"] <= 0:
            fail(f"dry run (a): the {shape} record lacks {sorted(missing)} "
                 f"or has no dot FLOPs")
        mem, h = rec["memory_analysis"], rec["hlo"]
        print(f"dry run (a) {DRYRUN_ARCH} {shape} 16x16 rank 0 "
              f"({rec['layout']['program']}): trace {rec['trace_s']} s on the "
              f"host, dot {h['dot_flops_per_device']:.4e} FLOP, bytes "
              f"{h['memory_bytes_per_device']:.4e}, wire "
              f"{h['collective_wire_bytes_by_axis']}, args "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, temp "
              f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB, "
              f"{h['aten_ops']} aten ops [{card}]", flush=True)
        out[shape] = {"trace_s": rec["trace_s"], "hlo": h, "memory": mem}
    return out


def p18_program(torch, model, params, phase: str, device, mode=None):
    """(fn, args) of one phase's step on ``params`` on ``device`` (made
    under ``mode``, a FakeTensorMode, for the fake-tensor trace)."""
    import contextlib

    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.optim import make_optimizer
    from repro_torch.serve.engine import Engine, ServeConfig
    with mode if mode is not None else contextlib.nullcontext():
        if phase == "train":
            opt = make_optimizer("adam", lr=1e-4)
            tokens = torch.zeros(P18_TOKENS, dtype=torch.int32, device=device)
            return make_train_step(model, opt), (
                params, opt.init(params), {"tokens": tokens}, 0)
        if phase == "prefill":
            tokens = torch.zeros(P18_TOKENS, dtype=torch.int32, device=device)
            return make_prefill_step(model), (params, {"tokens": tokens})
        eng = Engine(model, params, ServeConfig(
            max_batch=P18_SLOTS, max_len=P18_MAX_LEN, page_size=PAGE,
            quantize="int8"))
        for slot in range(P18_SLOTS):
            eng.cache.alloc(slot, P18_POS + 1)
        return eng._decode_on_device, eng._decode_inputs(
            np.zeros((P18_SLOTS, 1), np.int64),
            np.full(P18_SLOTS, P18_POS, np.int64),
            np.ones(P18_SLOTS, bool))


P18_PHASES = ("train", "prefill", "decode_tick")


def p18_fake_counts(out_path: str) -> None:
    """(b)'s fake-tensor traces, in a process of their own beside the card
    (``python3 -c "...; chip_smoke.p18_fake_counts(OUT)"``): each phase's
    step on CPU fake tensors, its counts written to ``out_path``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dist import destroy_group, init_group
    from repro_torch.models.model import Model
    model = Model(get_config(DRYRUN_ARCH))
    init_group(torch.device("cpu"))
    out = {}
    for phase in P18_PHASES:
        mode = FakeTensorMode()
        fake = model.abstract_params(mode=mode)
        fn, args = p18_program(torch, model, fake, phase, "cpu", mode)
        t0 = time.perf_counter()
        with mode:
            _, st = op_analysis.trace(fn, args, table=True)
        out[phase] = {"dot_flops": st.dot_flops,
                      "memory_bytes": st.memory_bytes,
                      "kernel_calls": st.kernel_calls,
                      "aten_ops": st.aten_ops, "op_counts": st.op_counts,
                      "fake_s": time.perf_counter() - t0}
    destroy_group()
    Path(out_path).write_text(json.dumps(out))


def p18_fake_start(out_path: Path):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.p18_fake_counts({str(out_path)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def p18_card_vs_fake(torch, ops, card, fake_proc, fake_path: Path,
                     t0: float) -> dict:
    """(b): each phase's step counted on the card, where the kernels run,
    against its trace on CPU fake tensors, where the plain versions run
    (:func:`p18_fake_counts`, in its own process meanwhile): dot FLOPs,
    bytes and per-kernel calls equal; the calls equal to the wrappers'
    launch counters (``nonfinite_tiles``, flash's pre-pass, once per
    flash call), every other counter 0.  No time is compared."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dist import init_group
    from repro_torch.models.model import Model
    model = Model(get_config(DRYRUN_ARCH))
    dev = torch.device("cuda")
    init_group(dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    got = {}
    for phase in P18_PHASES:
        fn, args = p18_program(torch, model, params, phase, dev)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        _, st = op_analysis.trace(fn, args, table=True)
        torch.cuda.synchronize()
        got[phase] = (st, time.perf_counter() - t1, path_counts(ops))
        del fn, args
        for t in tree_leaves(params):
            t.requires_grad_(False)       # the next phase's step: no graph
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    try:
        log, _ = fake_proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fake_proc.kill()
        fail(f"op analysis (b): the fake traces still running after "
             f"{DRYRUN_TIMEOUT_S} s")
    if fake_proc.returncode != 0:
        fail(f"op analysis (b): the fake traces exited "
             f"{fake_proc.returncode}: {log[-2000:]}")
    fakes = json.loads(fake_path.read_text())
    out = {}
    for phase in P18_PHASES:
        st, card_s, launches = got[phase]
        want = fakes[phase]
        same = (st.dot_flops == want["dot_flops"]
                and st.memory_bytes == want["memory_bytes"]
                and st.kernel_calls == want["kernel_calls"])
        if not same:
            ops_ = {k: list(v) for k, v in st.op_counts.items()}
            diff = {k: (ops_.get(k), want["op_counts"].get(k))
                    for k in set(ops_) | set(want["op_counts"])
                    if ops_.get(k) != want["op_counts"].get(k)}
            fail(f"op analysis (b) {phase}: the card counts dot "
                 f"{st.dot_flops!r} FLOP, {st.memory_bytes!r} bytes, "
                 f"kernels {st.kernel_calls}; the fake trace "
                 f"{want['dot_flops']!r}, {want['memory_bytes']!r}, "
                 f"{want['kernel_calls']}; ops that differ (calls, FLOP, "
                 f"bytes): {diff}")
        calls = dict(st.kernel_calls)
        calls["nonfinite_tiles"] = calls.get("flash_attention", 0)
        for name in ops.launch_counts():
            if launches[name] != calls.get(name, 0):
                fail(f"op analysis (b) {phase}: {name} launched "
                     f"{launches[name]} times, the op analysis counted "
                     f"{calls.get(name, 0)} calls")
        want_routes = P18_WANT[phase]
        want_calls = {k.split("[")[0]: n for k, n in want_routes.items()}
        if st.kernel_calls != want_calls or any(
                launches[k] != n for k, n in want_routes.items()):
            fail(f"op analysis (b) {phase}: kernel calls "
                 f"{st.kernel_calls}, launches {launches}; the step's "
                 f"structure gives {want_routes}")
        print(f"op analysis (b) {DRYRUN_ARCH} {phase} at world 1 (the card "
              f"{card_s:.2f} s, the fake trace {want['fake_s']:.2f} s on the "
              f"host): dot {st.dot_flops:.6e} FLOP, bytes "
              f"{st.memory_bytes:.6e}, kernel calls {st.kernel_calls} = the "
              f"launch counters { {k: v for k, v in launches.items() if v} }; "
              f"card {st.aten_ops} aten ops, fake {want['aten_ops']} "
              f"[{card}]", flush=True)
        out[phase] = {"dot_flops": st.dot_flops,
                      "memory_bytes": st.memory_bytes,
                      "kernel_calls": st.kernel_calls,
                      "aten_ops": [st.aten_ops, want["aten_ops"]],
                      "card_s": card_s, "fake_s": want["fake_s"],
                      "launches": launches}
    return out


def phase_dryrun_start() -> dict:
    """Phase 18's host work, started before phase 17 (whose host is busy
    with one checkpoint's disk and hash, not its cores): (a)'s three
    dry-run processes and (b)'s fake-tensor traces in a fourth.  They
    touch neither the card nor the launch counters."""
    import shutil
    out_dir = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    fake_path = out_dir / "fake_counts.json"
    return {"out_dir": out_dir, "cli": p18_cli_start(out_dir),
            "fake_path": fake_path, "fake": p18_fake_start(fake_path),
            "t0": time.perf_counter()}


def phase_dryrun(torch, ops, card, started=None) -> dict:
    """Phase 18: (b) counts each phase's step on the card against its
    fake trace, then (a)'s records are read; the host processes of
    :func:`phase_dryrun_start` (started here when not before)."""
    from repro_torch.launch.dist import destroy_group
    if started is None:
        started = phase_dryrun_start()
    t0 = time.perf_counter()
    counts = p18_card_vs_fake(torch, ops, card, started["fake"],
                              started["fake_path"], t0)
    destroy_group()
    t1 = time.perf_counter()
    cli = p18_cli_finish(started["cli"], started["out_dir"], t0, card)
    seconds = time.perf_counter() - t0
    print(f"phase 18 took {seconds:.1f} s ((b) {t1 - t0:.1f} s; its host "
          f"processes started {t0 - started['t0']:.1f} s before it) "
          f"[{card}]", flush=True)
    return {"cli": cli, "counts": counts, "seconds": seconds,
            "counts_s": t1 - t0, "host_head_start_s": t0 - started["t0"],
            "launches": {f"dryrun_{k}": v["launches"]
                         for k, v in counts.items()}}


# -- phase 19: serving under the reference's model-axis layout --------------

# four ranks of a gloo world on the one card, tp = 4 (the whole world), the
# rank's share drawn leaf by leaf (``convert.serve_init``: no rank holds
# the whole tree), make_prefill_step then donated decode steps under
# ``serve_region``; each case against the unsharded steps on the card
P19_WORLD = 4
P19_DIR = "phase19"
P19_CASES = {   # name: (arch, config overrides, batch, prompt, max_len, steps)
    # 8 kv heads over 4 ranks (the kv split), 42 layers: global and a
    # window of 4096 (above the cache's 2056 entries, so whole)
    "gemma2_9b": ("gemma2-9b", {}, 2, 2048, 2056, 8),
    # one kv head: the length split, 4096 entries in 4 blocks of 1024; the
    # prompt ends in the third block and the steps cross into the fourth
    "gemma_2b": ("gemma-2b", {}, 2, 3068, 4096, 8),
    # 4 of 48 layers, 32 of the 128 experts a rank, capacity factor E / k
    # = 16 (a capacity of every token: no drop); 4 kv heads, one a rank
    "qwen3_moe": ("qwen3-moe-30b-a3b", {"num_layers": 4,
                                        "capacity_factor": 16.0},
                  2, 256, 260, 4),
}
# the rank's flash calls per admission, all on the wgmma route
P19_FLASH = {"gemma2_9b": 42, "gemma_2b": 18, "qwen3_moe": 4}
# logits of the tp ranks against the unsharded steps on the card, relative
# L2 gap of each step's (B, vocab) logits: every layer's wo and FFN
# partials are rounded to bf16 before the all-reduce sums them (the
# unsharded GEMM rounds its f32 sum once), ~2^-9 relative a sum, two sums
# a layer; those gaps walk through up to 42 residual layers and the final
# norm.  Bound at 5e-2, the phase-16 gradient bound's order (4e-2).  The
# MoE case's control routes as rank 0 routed (``p19_route_replay``): a
# bf16 gap in a router's input flips near-tied choices, each of which
# moves its token's output by a whole expert's; the flips are counted
P19_LOGITS_RTOL = 5e-2
# the ranks' flash shapes, timed in phase 3: q (B, T, H / tp, hd) against
# k / v (B, T, KV / tp or the one kv head, hd)
P19_FLASH_SHAPES = {   # name: (B, T, H, KV, hd, kwargs)
    "gemma2_9b_tp4_rank": (2, 2048, 4, 2, 256, {"softcap": 50.0,
                                                 "window": 4096}),
    "gemma_2b_tp4_rank": (2, 3068, 2, 1, 256, {}),
    "qwen3_moe_tp4_rank": (2, 256, 8, 1, 128, {}),
}
P19_COUNTED = "gemma2_9b"   # (d): rank 0's prefill and first decode step


def p19_config(case: str):
    from repro_torch.configs import get_config
    arch, over = P19_CASES[case][:2]
    return dataclasses.replace(get_config(arch), **over)


def p19_tokens(torch, cfg, case: str, device):
    """The case's prompt (B, T) and forced decode tokens (steps, B, 1),
    int64, from a numpy seed: the same in every process."""
    _, _, B, T, _, steps = P19_CASES[case]
    rng = np.random.default_rng(190 + list(P19_CASES).index(case))
    prompt = rng.integers(0, cfg.vocab_size, (B, T))
    forced = rng.integers(0, cfg.vocab_size, (steps, B, 1))
    return (torch.from_numpy(prompt).to(device),
            torch.from_numpy(forced).to(device))


class p19_route_record:
    """Within the block, every ``moe._route`` call's expert choices (each
    row's in choice order, int lists) are appended to ``calls``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe._route

        def route(cfg, logits):
            w, e, aux = self._orig(cfg, logits)
            self.calls.append(e.cpu().tolist())
            return w, e, aux
        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._orig


class p19_route_replay:
    """Within the block, the ``n``-th ``moe._route`` call takes the expert
    choices of ``calls[n]`` (rank 0's, in its order) in place of its own,
    each weighted by its own softmax there, renormalized as ``_route``
    does; ``flipped`` counts, per call, the rows whose own choices (as a
    set) differ."""

    def __init__(self, torch, calls):
        self.torch, self.calls, self.flipped = torch, calls, []

    def __enter__(self):
        from repro_torch.models import moe
        torch = self.torch
        self._orig = moe._route

        def route(cfg, logits):
            w, e, aux = self._orig(cfg, logits)
            want = torch.tensor(self.calls[len(self.flipped)],
                                dtype=e.dtype, device=e.device)
            self.flipped.append(int((e.sort(-1).values !=
                                     want.sort(-1).values).any(-1).sum()))
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            w = probs.gather(-1, want)
            w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
            return w, want, aux
        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._orig


def p19_control(torch, case: str, routes=None) -> dict:
    """The unsharded steps on the card (whole model, world 1): prefill and
    ``steps`` decode steps; logits on the host (f32).  ``routes``: the
    expert choices of every ``_route`` call to replay
    (:class:`p19_route_replay`)."""
    import contextlib
    from repro_torch.models.model import Model
    _, _, B, T, ML, steps = P19_CASES[case]
    cfg = p19_config(case)
    model = Model(cfg)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(dev).manual_seed(0))
    prompt, forced = p19_tokens(torch, cfg, case, dev)
    logits = []
    replay = p19_route_replay(torch, routes) if routes is not None \
        else contextlib.nullcontext()
    with torch.no_grad(), replay:
        out, cache = model.prefill(params, {"tokens": prompt}, ML)
        logits.append(out.float().cpu())
        for i in range(steps):
            out, cache = model.decode_step(params, forced[i], cache, T + i,
                                           inplace=True)
            logits.append(out.float().cpu())
    del params, cache, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": torch.stack(logits),
            "flipped": replay.flipped if routes is not None else None}


def p19_steps(model, case: str) -> tuple:
    """The case's prefill step (its cache ``max_len`` long) and its
    donated decode step, as a rank and the fake trace run them."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    return (make_prefill_step(model, P19_CASES[case][4]),
            make_decode_step(model, donate=True))


def p19_stats(st) -> dict:
    return {"dot_flops": st.dot_flops, "memory_bytes": st.memory_bytes,
            "kernel_calls": dict(st.kernel_calls),
            "collective_counts": dict(st.collective_counts),
            "wire": dict(st.collective_wire_bytes_by_axis),
            "aten_ops": st.aten_ops, "op_counts": st.op_counts}


def p19_fake_counts(out_path: str) -> None:
    """(d)'s fake-tensor traces, in a process of their own (``python3 -c
    "...; chip_smoke.p19_fake_counts(OUT)"``): rank 0 of a ``fake``
    process group of world 4, its share of the parameters as fake
    tensors, the prefill and the first decode step of
    :data:`P19_COUNTED` counted on CPU fake tensors (the plain versions
    run), the counts written to ``out_path``."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.convert import serve_slice
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import _fake_store
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import serve_region
    case = P19_COUNTED
    ML = P19_CASES[case][4]
    cfg = p19_config(case)
    model = Model(cfg)
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=P19_WORLD)
    mode = FakeTensorMode()
    with mode:
        params = serve_slice(model.abstract_params(mode=mode), cfg, 0,
                             P19_WORLD)
    _, _, B, T, _, _ = P19_CASES[case]
    prefill, decode = p19_steps(model, case)
    out = {}
    with mode, serve_region(dist.group.WORLD, (), ML), torch.no_grad():
        t0 = time.perf_counter()
        (_, cache), st = op_analysis.trace(prefill, (
            params, {"tokens": torch.zeros((B, T), dtype=torch.int64)}),
            table=True)
        out["prefill"] = {**p19_stats(st), "fake_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        _, st = op_analysis.trace(decode, (
            params, torch.zeros((B, 1), dtype=torch.int64), cache, T),
            table=True)
        out["decode"] = {**p19_stats(st), "fake_s": time.perf_counter() - t0}
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def p19_fake_start() -> tuple:
    """(process, path) of (d)'s fake traces, started now; the path lies
    outside ``build/phase19``, which the spawned world empties."""
    path = ROOT / "build" / "phase19_fake" / "fake_counts.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.p19_fake_counts({str(path)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), path


def p19_reckoning(params, cache) -> int:
    """The rank's parameters and decode cache, in bytes."""
    from repro_torch._tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(params) + tree_leaves(cache))


def p19_rank_case(torch, ops, rank: int, case: str, shared) -> dict:
    """One case on this rank: its share of the weights, the prefill, then
    the donated decode steps, under ``serve_region`` over the world; rank
    0 counts :data:`P19_COUNTED`'s prefill and first step (the op
    analysis, its ops beside the kernels), writes its logits into
    ``shared`` (a host tensor in shared memory) and records its expert
    choices."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.convert import serve_init
    from repro_torch.core.collectives import p2p
    from repro_torch.launch import op_analysis
    from repro_torch.models.layers import desc_leaves
    from repro_torch.models.model import Model
    from repro_torch.models.sharding_ctx import serve_region
    _, _, B, T, ML, steps = P19_CASES[case]
    cfg = p19_config(case)
    model = Model(cfg)
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve_init(cfg, torch.Generator(dev).manual_seed(0), rank,
                        P19_WORLD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prompt, forced = p19_tokens(torch, cfg, case, dev)
    counted = rank == 0 and case == P19_COUNTED
    counts = {}
    logits, step_ms = [], []
    dist.barrier()
    ops.reset_launch_counts()
    p2p.reset_staged_bytes()
    routes = p19_route_record()
    prefill, decode = p19_steps(model, case)
    with torch.no_grad(), serve_region(dist.group.WORLD, (), ML), routes:
        args = (params, {"tokens": prompt})
        t0 = time.perf_counter()
        if counted:
            (out, cache), st = op_analysis.trace(prefill, args, table=True)
            counts["prefill"] = p19_stats(st)
        else:
            out, cache = prefill(*args)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        logits.append(out.float())
        staged_prefill = p2p.staged_bytes()
        for i in range(steps):
            args = (params, forced[i], cache, T + i)
            t0 = time.perf_counter()
            if counted and i == 0:
                (out, new), st = op_analysis.trace(decode, args, table=True)
                counts["decode"] = p19_stats(st)
            else:
                out, new = decode(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if new is not cache:
                raise RuntimeError("the donated decode returned another cache")
            logits.append(out.float())
    launches = path_counts(ops)
    got = torch.stack(logits)                       # (steps + 1, B, 1, V)
    if rank == 0:
        shared.copy_(got)
    draw = max(math.prod(d.shape) for d in desc_leaves(model.param_desc()))
    res = {"logits_digest": [digest(torch, x).tolist() for x in got],
           "prefill_s": prefill_s, "step_ms": step_ms, "init_s": init_s,
           "staged_bytes": p2p.staged_bytes(),
           "staged_prefill_bytes": staged_prefill,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "init_peak_bytes": init_peak,
           "reckoning_bytes": p19_reckoning(params, cache),
           "draw_bytes": 6 * draw,
           "cache_shapes": sorted({tuple(t.shape)
                                   for t in tree_leaves(cache)}),
           "routes": routes.calls if rank == 0 else None,
           "launches": launches, "counts": counts}
    del params, cache, out, new, got, logits
    gc.collect()
    torch.cuda.empty_cache()
    return res


def p19_child(rank: int, world: int, store: str, out_dir: str,
              shared: dict) -> None:
    """Phase 19, one of four ranks of a gloo group on the one card: every
    case of :data:`P19_CASES` in turn at tp = 4."""
    os.environ["RANK"] = str(rank)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import init_group
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(torch.device("cpu"), world_size=world, rank=rank,
               store_path=store)
    res = {"rank": rank}
    for case in P19_CASES:
        res[case] = p19_rank_case(torch, ops, rank, case, shared[case])
    res["launches"] = {case: res[case]["launches"] for case in P19_CASES}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def p19_check_counts(card_counts: dict, fake_proc, fake_path: Path,
                     t0: float) -> dict:
    """(d): rank 0's card counts of the prefill and the first decode step
    equal its fake trace's in dot FLOPs, bytes, kernel calls and
    collectives (counts and wire a mesh axis)."""
    try:
        log, _ = fake_proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fake_proc.kill()
        fail(f"serve tp (d): the fake traces still running after "
             f"{DRYRUN_TIMEOUT_S} s")
    if fake_proc.returncode != 0:
        fail(f"serve tp (d): the fake traces exited {fake_proc.returncode}: "
             f"{log[-2000:]}")
    fakes = json.loads(fake_path.read_text())
    out = {}
    for phase in ("prefill", "decode"):
        got, want = card_counts[phase], fakes[phase]
        keys = ("dot_flops", "memory_bytes", "kernel_calls",
                "collective_counts", "wire")
        if any(got[k] != want[k] for k in keys):
            ops_ = got["op_counts"]
            diff = {k: (ops_.get(k), want["op_counts"].get(k))
                    for k in set(ops_) | set(want["op_counts"])
                    if ops_.get(k) != want["op_counts"].get(k)}
            fail(f"serve tp (d) {phase}: the card counts "
                 f"{ {k: got[k] for k in keys} }, the fake trace "
                 f"{ {k: want[k] for k in keys} }; ops that differ (calls, "
                 f"FLOP, bytes): {diff}")
        out[phase] = {k: got[k] for k in keys}
        out[phase].update(aten_ops=[got["aten_ops"], want["aten_ops"]],
                          fake_s=want["fake_s"])
    return out


def phase_serve_tp(torch, ops, card, fake=None) -> dict:
    """Phase 19: the four ranks (one spawned gloo world on the card), then
    each case's control in this process and the case's gates, and (d)
    against the fake traces (started here when not before, ``fake``:
    (process, path))."""
    t_all = time.perf_counter()
    if fake is None:
        fake = p19_fake_start()
    t0 = time.perf_counter()
    # rank 0's logits come back through shared host memory, not the disk
    shared = {}
    for case, (_, _, B, T, ML, steps) in P19_CASES.items():
        V = p19_config(case).padded_vocab
        shared[case] = torch.zeros((steps + 1, B, 1, V)).share_memory_()
    ranks, spawn_s = spawn_world4(torch, p19_child, P19_DIR, (shared,),
                                  world=P19_WORLD)
    control_s = 0.0
    out = {"spawn_s": spawn_s, "cases": {}}
    for case, (arch, _, B, T, ML, steps) in P19_CASES.items():
        rs = [r[case] for r in ranks]
        if any(r["logits_digest"] != rs[0]["logits_digest"] for r in rs):
            fail(f"serve tp {case}: the ranks' logits differ")
        routes = rs[0]["routes"] if p19_config(case).num_experts else None
        t2 = time.perf_counter()
        control = p19_control(torch, case, routes)
        control_s += time.perf_counter() - t2
        got, want = shared[case], control["logits"]
        diff = (got - want).reshape(steps + 1, -1)
        gaps = (diff.norm(dim=1)
                / want.reshape(steps + 1, -1).norm(dim=1)).tolist()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        flipped = control["flipped"]
        if not max(gaps) <= P19_LOGITS_RTOL:
            fail(f"serve tp {case}: logits {gaps} (relative L2 gap a step) "
                 f"from the unsharded steps, beyond {P19_LOGITS_RTOL}")
        path = {"flash_attention": P19_FLASH[case],
                "flash_attention[wgmma]": P19_FLASH[case],
                "nonfinite_tiles": P19_FLASH[case]}
        for r in rs:
            launched = {k: v for k, v in r["launches"].items() if v}
            if launched != path:
                fail(f"serve tp {case}: launches {launched}, the path gives "
                     f"{path}")
        peak = sum(r["peak_bytes"] for r in rs)
        print(f"serve tp (phase 19) {case}: {arch} tp={P19_WORLD}, B={B}, "
              f"prompt {T}, cache {ML} ({rs[0]['cache_shapes']} a rank), "
              f"{steps} donated steps [{card}]: logits bit-equal on the 4 "
              f"ranks; against the unsharded steps relative L2 gap "
              f"{[round(g, 5) for g in gaps]} (limit {P19_LOGITS_RTOL}), "
              f"max |Δ| {diff.abs().max().item():.4g} of |logit| up to "
              f"{want.abs().max().item():.4g}, argmax agreement "
              f"{agree:.4f} (weak evidence: random weights)"
              + ("" if flipped is None else
                 f"; the control routed as rank 0 did: its own choices "
                 f"differ in {sum(flipped)} of "
                 f"{sum(len(c) for c in routes)} token-rows over "
                 f"{len(flipped)} routings ({flipped})")
              + f"; prefill {[round(r['prefill_s'], 3) for r in rs]} "
              f"s, steps {[round(t, 1) for t in rs[0]['step_ms']]} ms (rank "
              f"0); peak a rank serving "
              f"{[round(r['peak_bytes'] / 2**30, 2) for r in rs]} GiB (all "
              f"{peak / 2**30:.2f}) against the reckoning of parameters and "
              f"cache {rs[0]['reckoning_bytes'] / 2**30:.2f} GiB; drawing "
              f"the share {rs[0]['init_peak_bytes'] / 2**30:.2f} GiB (the "
              f"largest leaf's f32 draw and cast "
              f"{rs[0]['draw_bytes'] / 2**30:.2f} GiB beside the share) in "
              f"{rs[0]['init_s']:.1f} s; staged "
              f"{rs[0]['staged_bytes'] / 1e6:.1f} MB a rank "
              f"(prefill {rs[0]['staged_prefill_bytes'] / 1e6:.1f}); "
              f"launches {rs[0]['launches']['flash_attention[wgmma]']} "
              f"flash on wgmma a rank", flush=True)
        out["cases"][case] = {k: v for k, v in rs[0].items()
                              if k not in ("counts", "logits_digest",
                                           "routes")}
        out["cases"][case].update(
            peak_bytes_ranks=[r["peak_bytes"] for r in rs],
            rel_l2_gap=gaps, max_abs_diff=diff.abs().max().item(),
            token_agreement=agree, flipped_rows=flipped)
    counts = p19_check_counts(ranks[0][P19_COUNTED]["counts"], *fake, t0)
    for phase, c in counts.items():
        print(f"serve tp (d) {P19_COUNTED} {phase}, rank 0 of 4 [{card}]: "
              f"the card's counts equal the fake trace's: dot "
              f"{c['dot_flops']:.6e} FLOP, bytes {c['memory_bytes']:.6e}, "
              f"kernels {c['kernel_calls']}, collectives "
              f"{c['collective_counts']}, wire {c['wire']}; aten ops card "
              f"{c['aten_ops'][0]}, fake {c['aten_ops'][1]} (fake trace "
              f"{c['fake_s']:.2f} s)", flush=True)
    out["counts"] = counts
    out["control_s"] = control_s
    out["seconds"] = time.perf_counter() - t_all
    out["launches"] = {f"serve_tp_{case}": ranks[0][case]["launches"]
                       for case in P19_CASES}
    print(f"phase 19 took {out['seconds']:.1f} s (the spawned world "
          f"{spawn_s:.1f} s, the controls {out['control_s']:.1f} s) "
          f"[{card}]", flush=True)
    return out


def tp_flash_kernels(torch, ops, ref, flash_cuda, tiles_cuda) -> dict:
    """Phase 3, flash at phase 19's rank shapes (:data:`P19_FLASH_SHAPES`,
    bf16, causal): through ``ops.flash_attention`` on its wgmma route,
    held to the plain version within :func:`flash_close`; then kernel
    (pre-pass included), plain and SDPA (``enable_gqa``) times in turns
    and the bound."""
    import torch.nn.functional as F
    out = {}
    for i, (name, (B, T, H, KV, hd, kw)) in enumerate(
            P19_FLASH_SHAPES.items()):
        q, k, v = flash_inputs(torch, B, T, T, H, KV, hd, torch.bfloat16,
                               900 + i)
        r0 = ops.route_counts()["flash_attention"]["wgmma"]
        got = ops.flash_attention(q, k, v, causal=True, **kw)
        want = ref.flash_attention_ref(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        if ops.route_counts()["flash_attention"]["wgmma"] != r0 + 1:
            fail(f"flash_attention at {name} did not take the wgmma route")
        ok, err, share = flash_close(torch, got, want)
        if not ok:
            fail(f"flash_attention differs from the plain version at {name}:"
                 f" max err {err}, {share:.3f} of the tolerance")

        def timed():
            return flash_cuda(q, k, v, tiles_cuda(v), True, kw.get("window"),
                              kw.get("softcap"), "wgmma")

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=True, **kw)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        timer = loop_ms if T > 1024 else device_ms
        plain_ms, (k_ms,) = time_turns(torch, timer, plain, [timed])
        lib_ms = min(timer(torch, library), timer(torch, library))
        b_ms, by, n_ops, nbytes = flash_bound(B, T, T, H, KV, hd, 2,
                                              {"causal": True,
                                               "window": kw.get("window")})
        note = "F.scaled_dot_product_attention(is_causal=True, enable_gqa)"
        if kw.get("softcap"):
            note += " without the softcap (no SDPA call caps the logits)"
        out[name] = {
            "shape": [B, T, T, H, KV, hd], "dtype": "bfloat16",
            "kwargs": kw, "ms": k_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "ops": n_ops, "bytes": nbytes,
            "tflops": n_ops / k_ms / 1e9, "library_ms": lib_ms,
            "library_note": note, "max_abs_err": err,
            "max_abs_err_bf16": err, "share_of_tolerance": share,
            "includes_prepass": True,
            "timer": "cuda events" if T > 1024 else "cuda graph"}
        print(f"flash_attention wgmma route {name} q {[B, T, H, hd]} k/v "
              f"{[B, T, KV, hd]} bf16 {kw}: within tolerance ({share:.4f} of "
              f"it); device time kernel with its pre-pass {k_ms * 1e3:.3f} "
              f"us, plain {plain_ms * 1e3:.3f} us, bound {b_ms * 1e3:.3f} us "
              f"({by}), {b_ms / k_ms:.4f} of the bound, library "
              f"{lib_ms * 1e3:.3f} us by {note} (kernel / SDPA "
              f"{k_ms / lib_ms:.3f}) [{out[name]['timer']}]", flush=True)
        del q, k, v, qt, kt, vt, got, want
    torch.cuda.empty_cache()
    return out


def kernel_name(mangled: str) -> str:
    """A short name of a mangled kernel template: its name, then its
    element type and integer template arguments."""
    m = re.search(r"([a-z_]+_kernel)I(.*?)EEv", mangled)
    if not m:
        m = re.search(r"([a-z_]+_kernel)", mangled)
        return m.group(1) if m else mangled[:60]
    args = m.group(2)
    kind = ["bf16"] if "bfloat16" in args else ["f32"] if args[:1] == "f" \
        else []
    return f"{m.group(1)}<{', '.join(kind + re.findall(r'Li(\d+)E', args + 'E'))}>"


# libraries whose every kernel must compile with no spill and no stack
# frame (register arrays indexed at run time would land in a stack frame),
# and, for the tensor-core attention kernel, no serialized wgmma pipeline
PTXAS_STRICT = ("flash_attention_wgmma", "quantize_tiles", "quantize_ef",
                "topk_mask")
PTXAS_CLEAN = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def check_wgmma_instantiations(log: str) -> None:
    """Fail unless the wgmma library's ``-Xptxas -v`` report (which
    ``check_ptxas`` holds to no spill) holds every instantiation the
    launcher can reach: each head dim of ``WGMMA_HEAD_DIMS`` at 1 and 2
    consumer warpgroups."""
    from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
    found = {kernel_name(line.split("'")[1]) for line in log.splitlines()
             if "Compiling entry function" in line}
    want = {f"flash_wgmma_kernel<{hd}, {nc}>" for hd in WGMMA_HEAD_DIMS
            for nc in (1, 2)}
    if want - found:
        fail(f"ptxas: the wgmma library lacks {sorted(want - found)}")
    print(f"ptxas: the wgmma library holds {len(want)} instantiations "
          f"(head dims {WGMMA_HEAD_DIMS} x 1 and 2 consumer warpgroups), "
          f"none spilling", flush=True)


def check_ptxas(name: str, log: str) -> None:
    """Print each kernel's registers and spills from the ``-Xptxas -v``
    report of library ``name``; fail, for the libraries of
    ``PTXAS_STRICT``, on a spill, a stack frame or a serialized wgmma."""
    kernel = "?"
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name} {kernel}: {line}")
        if name in PTXAS_STRICT and (
                "Performance Loss" in line or
                ("spill" in line and not line.startswith(PTXAS_CLEAN))):
            fail(f"ptxas: {name} {kernel}: {line}")


def kernel_line(name, launches, max_err_, timings, main_shape,
                routes=None) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; ``launches`` maps each
    main-path run to the kernel's count there, and ``routes`` (for a
    wrapper with routes) maps each of its routes to such a map."""
    source, replaces, tpu_fn = KERNEL_SOURCES[name]
    t = timings[main_shape]
    total = sum(launches.values())
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_function": tpu_fn, "checked": True,
        "launches": total, "launches_on_path": total,
        "launches_by_run": launches, "launches_by_route": routes,
        "max_abs_err": max_err_,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
        "library_note": t.get("library_note") or
        "no single PyTorch call computes this function",
        "main_shape": main_shape, "shapes": timings}


def main() -> None:
    # torch.compile (the flex_attention library timing) keeps its caches
    # under build/, beside the port's kernels
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.flash_attention import (
            flash_attention_cuda, nonfinite_tiles_cuda)
        from repro_torch.kernels.quantize import quantize_tiles_cuda
        from repro_torch.launch import serve, train
        from repro_torch.launch.dist import destroy_group
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not beside this script: {e}")

    # each phase's start, seconds into the run (the whole call's budget)
    t_run = time.perf_counter()

    def timeline(what: str) -> None:
        print(f"[{time.perf_counter() - t_run:.1f} s] {what} starts",
              flush=True)

    # -- 1. device --------------------------------------------------------
    # the CPU side of the small training reference runs a gloo group of one
    # rank; loopback spares gloo a lookup of the host's name
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    try:
        libs = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in libs:
        check_ptxas(name, build.build_log(name))
    check_wgmma_instantiations(build.build_log("flash_attention_wgmma"))
    if sys.argv[1:] in (["--phase", "16"], ["--phase", "17"],
                        ["--phase", "18"], ["--phase", "19"]):
        # phase 16, 17, 18 or 19 alone, after the build (a quicker check of
        # its slice; 19 with its flash shapes of phase 3)
        if sys.argv[2] == "16":
            alone = {"parallel": phase_parallel(torch, ops, ref, train,
                                                card)}
        elif sys.argv[2] == "17":
            alone = {"elastic": phase_elastic(torch, ops, train, card)}
        elif sys.argv[2] == "18":
            alone = {"dryrun": phase_dryrun(torch, ops, card)}
        else:
            alone = {"tp_flash": tp_flash_kernels(
                torch, ops, ref, flash_attention_cuda, nonfinite_tiles_cuda),
                "serve_tp": phase_serve_tp(torch, ops, card)}
        print(json.dumps({**alone, "card": card}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": kind,
                                                 "count": count}}))
        return

    # -- 3. kernels vs plain versions ---------------------------------------
    flash_err, flash_timings, tiles_timings = phase_flash(
        torch, ops, ref, flash_attention_cuda, nonfinite_tiles_cuda)
    for route, per_shape in flash_timings.items():
        for name, t in per_shape.items():
            lib = t["library_note"]
            if t["library_ms"] is not None:
                lib = (f"{t['library_ms'] * 1e3:.3f} us, max |Δ| "
                       f"{t['library_max_abs_err']:.3e} to the plain version, "
                       f"by {lib}")
            print(f"flash_attention {route} route {name} {t['shape']} bf16: "
                  f"device time kernel with its pre-pass "
                  f"{t['ms'] * 1e3:.3f} us ({t['tflops']:.2f} TFLOP/s), "
                  f"plain {t['plain_ms'] * 1e3:.3f} us, bound "
                  f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), "
                  f"{t['bound_ms'] / t['ms']:.4f} of the bound, library {lib} "
                  f"({t['timer']}) [{card}]", flush=True)
    for name, t in tiles_timings.items():
        print(f"nonfinite_tiles {name} v {t['shape']} bf16: device time "
              f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} us, "
              f"bound {t['bound_ms'] * 1e3:.3f} us (bytes), "
              f"{t['bound_ms'] / t['ms']:.4f} of the bound ({t['timer']}) "
              f"[{card}]", flush=True)
    check_flash_gates(flash_timings["wgmma"])
    encdec_flash = encdec_flash_kernels(torch, ops, ref, flash_attention_cuda,
                                        nonfinite_tiles_cuda)
    tp_flash = tp_flash_kernels(torch, ops, ref, flash_attention_cuda,
                                nonfinite_tiles_cuda)
    # the serving paths' shapes: one tile (head_dim) per cached entry, for
    # all stacked layers of a leaf at once; the pools of the runs cut in
    # depth at the run's depth (suffixed with it: on the path) and at the
    # configuration's own (checked and timed, on no path)
    cfg = get_config("gemma-2b")
    depth_cut = {**MOE_SERVE_CUT, JAMBA_ARCH: JAMBA_CUT}
    path_shapes = {**quantize_path_shapes(cfg, SLOTS, MAX_LEN, PAGE),
                   **quantize_path_shapes(get_config("gemma2-9b"),
                                          GEMMA2_SLOTS, GEMMA2_MAX_LEN, PAGE),
                   **pool_write_shapes(get_config(MLA_LONG_ARCH),
                                       GEMMA2_SLOTS, GEMMA2_MAX_LEN, "_long")}
    for arch, over in depth_cut.items():
        path_shapes.update(pool_write_shapes(get_config(arch)))
        path_shapes.update(pool_write_shapes(
            cut(arch, over), suffix=f"_{over['num_layers']}_layers"))
    q_err, timings, q_block = phase_kernels(torch, ops, ref,
                                            quantize_tiles_cuda, path_shapes)
    for name, t in [*timings.items(), *q_block.items()]:
        route = "block" if name in q_block else "warp"
        print(f"quantize_tiles {route} route {name} n={t['n']} "
              f"tile={t['tile']} bf16: "
              f"device time kernel {t['ms'] * 1e3:.3f} us, plain "
              f"{t['plain_ms'] * 1e3:.3f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bound_by']}); eager call kernel "
              f"{t['call_ms'] * 1e3:.3f} us, plain "
              f"{t['plain_call_ms'] * 1e3:.3f} us ({t['timer']}) [{card}]",
              flush=True)
    train_err = phase_train_kernels(torch, ops, ref)
    buckets = train_bucket_sizes(cfg)
    train_shapes = {"largest_bucket": max(buckets), "first_bucket": buckets[0]}
    train_timings = train_path_kernels(torch, ops, ref, buckets, train_shapes)
    for name, per_shape in train_timings.items():
        for shape, t in per_shape.items():
            print(f"{name} {shape} n={t['n']} tile={t['tile']} "
                  f"{t['dtype']}: device time kernel "
                  f"{t['ms'] * 1e3:.3f} us, plain {t['plain_ms'] * 1e3:.3f} "
                  f"us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}),"
                  f" {t['bound_ms'] / t['ms']:.3f} of the bound "
                  f"({t['timer']}) [{card}]", flush=True)
    check_tile_gates({"quantize_tiles": timings,
                      **{k: train_timings[k]
                         for k in ("topk_ef", "topk_mask",
                                   "dequant_accum")}})

    timeline("phase 4")
    # -- 4. small references ----------------------------------------------
    for arch in SMALL_REFS:
        phase_small_reference(torch, arch)
    phase_small_train_reference(torch)

    timeline("phase 5")
    # -- 5. the serving path at full width ----------------------------------
    ops.reset_launch_counts()
    run = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = path_counts(ops)
    if run.engines[0].device.type != "cuda":
        fail(f"the engine ran on {run.engines[0].device}, not on the card")
    check_main_path(torch, run, launches, card)

    timeline("phase 6")
    # -- 6. static vs continuous, and a profile (information only) --------
    compare_static(torch, run, card)
    profile_ticks(torch, run.model, run.params, run.engines[0].cfg,
                  run.requests, card)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    timeline("phase 7")
    # -- 7. gemma2-9b served at full width -----------------------------------
    gemma2 = run_gemma2_serving(torch, ops, serve, card)
    s = gemma2["summary"]
    print(f"serving gemma2-9b [{card}]: tokens/s={s['tokens_per_s']:.3f} "
          f"p50 per-token latency={s['p50_s'] * 1e3:.3f} ms "
          f"p99={s['p99_s'] * 1e3:.3f} ms mean TTFT="
          f"{s['mean_ttft_s'] * 1e3:.3f} ms makespan={s['makespan_s']:.3f} s "
          f"(serve run {gemma2['seconds']:.2f} s)", flush=True)

    timeline("phase 8")
    # -- 8. the training path at full width ---------------------------------
    kept = {}
    trained = run_training(torch, ops, train, card, kept)
    destroy_group()

    timeline("phase 9")
    # -- 9. the explicit collectives at world 4 on the one card -------------
    world4 = phase_world4(torch, card, {"first": buckets[0],
                                        "mid": buckets[1],
                                        "largest": max(buckets)})

    timeline("phase 10")
    # -- 10. the rounds axis -------------------------------------------------
    rounds = phase_rounds(torch, ops, ref, train, card)
    destroy_group()

    timeline("phase 11")
    # -- 11. the communication planner ----------------------------------------
    auto = phase_auto(torch, ops, ref, train, card)

    timeline("phase 12")
    # -- 12. sharded data parallelism -------------------------------------------
    shard = phase_shard(torch, ops, ref, train, card, kept["int8_fused"])

    timeline("phase 13")
    # -- 13. pipeline parallelism ----------------------------------------------
    pipe = phase_pipe(torch, ops, ref, train, card, kept.pop("int8_fused"))

    timeline("phase 14")
    # -- 14. the MoE and MLA families ------------------------------------------
    moe = phase_moe(torch, ops, ref, serve, train, card, flash_attention_cuda,
                    nonfinite_tiles_cuda)

    timeline("phase 15")
    # -- 15. the Mamba, xLSTM and encoder-decoder families --------------------
    new = phase_new_families(torch, ops, ref, serve, train, card)

    timeline("phase 16")
    # -- 16. tensor / expert parallelism, calibration, drift re-planning ------
    par = phase_parallel(torch, ops, ref, train, card)

    timeline("phase 17")
    # -- 17. the elastic runtime, with phase 18's and 19's host processes
    # beside it ---------------------------------------------------------------
    dryrun_host = phase_dryrun_start()
    p19_fake = p19_fake_start()
    elastic = phase_elastic(torch, ops, train, card)

    timeline("phase 18")
    # -- 18. the dry run and the op analysis -----------------------------------
    dryrun = phase_dryrun(torch, ops, card, dryrun_host)

    timeline("phase 19")
    # -- 19. serving under the reference's model-axis layout, tp = 4 ----------
    serve_tp = phase_serve_tp(torch, ops, card, p19_fake)

    serving = {"gemma-2b": launches, "gemma2-9b": gemma2["launches"],
               **{arch: r["launches"] for arch, r in moe["serving"].items()},
               f"{MLA_LONG_ARCH}_long": moe["long"]["launches"],
               **{arch: r["launches"] for arch, r in new["serving"].items()},
               f"{SEAMLESS_ARCH}_oneshot": new["oneshot"]["launches"],
               f"{SEAMLESS_ARCH}_f32_frames":
                   new["f32_frames"]["launches"],
               "dryrun_prefill": dryrun["launches"]["dryrun_prefill"],
               "dryrun_decode_tick": dryrun["launches"]["dryrun_decode_tick"],
               **serve_tp["launches"]}

    def runs_of(name, runs):
        return {run_name: r[name] for run_name, r in runs.items()}

    def routes_of(kernel, runs):
        return {route: runs_of(f"{kernel}[{route}]", runs)
                for route in ops.KERNEL_ROUTES[kernel]}

    train_runs = {k: r["launches"] for k, r in trained.items()}
    # rank 0's counts (every rank's are gated equal)
    train_runs.update({f"world4_{k}": world4[k]["launches"] for k in
                       ("ring_fused", "int8_fused_ring", "topk_fused_ring")})
    train_runs.update({f"world4_mesh_{a}": r["launches"]
                       for a, r in world4["algos"].items()})
    train_runs.update({f"rounds_{k}": r["launches"]
                       for k, r in rounds["full_width"].items()})
    train_runs["rounds_world4_local_sgd"] = rounds["world4"]["launches"]
    train_runs["auto_world1"] = auto["world1"]["launches"]
    train_runs["auto_world4_local_sgd"] = auto["world4"]["launches"]
    train_runs["shard_world1"] = shard["world1"]["launches"]
    train_runs["shard_world4"] = shard["world4"]["sharded"]["launches"]
    train_runs["shard_world4_replicated"] = \
        shard["world4"]["replicated"]["launches"]
    train_runs["pipe_world1_micro"] = pipe["world1"]["launches"]
    train_runs["pipe_s2_stage"] = pipe["big"]["launches"]
    train_runs["moe_qwen3_int8_fused"] = moe["training"]["launches"]
    train_runs["xlstm_int8_fused"] = new["training"]["launches"]
    train_runs.update({f"parallel_{k}": v
                       for k, v in par["launches"].items()})
    train_runs.update(elastic["launches"])
    train_runs["dryrun_train"] = dryrun["launches"]["dryrun_train"]
    flash_routes = routes_of("flash_attention", serving)
    quant_routes = routes_of("quantize_tiles", {**serving, **train_runs})
    quant_shapes = {**timings, **{f"train_{k}": t for k, t in
                                  train_timings["quantize_tiles"].items()},
                    "world4_ring_fused_hop": world4["quantize_tiles_hop"]}
    train_timings["dequant_accum"]["world4_mid_bucket_w4"] = \
        world4["dequant_accum_w4"]
    for kernel, per_shape in [*moe["wire"].items(), *new["wire"].items(),
                              *par["calibration"]["kernels"].items()]:
        train_timings[kernel].update(per_shape)
    for route in ("wgmma", "simt"):
        flash_timings[route].update(moe["flash"][route])
        flash_timings[route].update(encdec_flash[route])
    flash_timings["wgmma"].update(tp_flash)
    flash_err = max([flash_err] + [t["max_abs_err_bf16"]
                                   for per in moe["flash"].values()
                                   for t in per.values()]
                    + [t["max_abs_err"] for t in tp_flash.values()]
                    + [t["max_abs_err"] for per in encdec_flash.values()
                       for t in per.values()])
    kernels = [
        kernel_line("flash_attention", flash_routes["wgmma"], flash_err,
                    flash_timings["wgmma"], "gemma2_9b_prefill_global",
                    flash_routes),
        # the SIMT route: on the f32-frame path of 15 (d) (the encoder and
        # the cross-attention), timed by direct call at
        # deepseek-v2-lite-16b's MLA prefill
        kernel_line("flash_attention_simt", flash_routes["simt"], flash_err,
                    flash_timings["simt"], "deepseek_v2_lite_prefill",
                    flash_routes),
        kernel_line("nonfinite_tiles", runs_of("nonfinite_tiles", serving),
                    0.0, tiles_timings, "gemma2_9b_prefill_global"),
        kernel_line("quantize_tiles", quant_routes["warp"], q_err,
                    quant_shapes, "gemma2_9b_prefill_write_8192",
                    quant_routes),
        kernel_line("quantize_tiles_block", quant_routes["block"], q_err,
                    q_block, "gemma2_9b_prefill_write_4096_tile4096",
                    quant_routes)]
    kernels.append(kernel_line("quantize_ef",
                               runs_of("quantize_ef", train_runs),
                               train_err["quantize_ef"],
                               train_timings["quantize_ef"],
                               "largest_bucket"))
    for kernel in ("dequant_accum", "topk_ef", "topk_mask"):
        routes = routes_of(kernel, train_runs)
        for name, route in ((kernel, "warp"), (f"{kernel}_block", "block")):
            kernels.append(kernel_line(name, routes[route], train_err[kernel],
                                       train_timings[name], "largest_bucket",
                                       routes))
    training = {k: {f: v for f, v in r.items() if f != "params"}
                for k, r in trained.items()}
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"world4": world4, "card": card}))
    print(json.dumps({"rounds": rounds, "card": card}))
    print(json.dumps({"auto": auto, "card": card}))
    print(json.dumps({"shard": shard, "card": card}))
    print(json.dumps({"pipeline": pipe, "card": card}))
    print(json.dumps({"moe": moe, "card": card}))
    print(json.dumps({"new_families": new, "encdec_flash": encdec_flash,
                      "card": card}))
    print(json.dumps({"parallel": par, "card": card}))
    print(json.dumps({"elastic": elastic, "card": card}))
    print(json.dumps({"dryrun": dryrun, "card": card}))
    print(json.dumps({"serve_tp": serve_tp, "tp_flash": tp_flash,
                      "card": card}))
    print(json.dumps({"serving_gemma2_9b": gemma2, "card": card}))
    print(json.dumps({"kernels": kernels, "card": card}))
    timeline("the result lines")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
