#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero):

1. build the hand-written kernels from csrc/ (one nvcc per source, in
   parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, at C=64, at a ragged N, with all-zero weights,
   (quantize_int8 / dequantize_int8) bitwise at Np, 9 blocks, 61,705
   blocks and the round engine's 8 x Np, quantize at the unpadded N = 1,
   255, 257 and 1,974,303 and through Int8Codec().encode against the
   plain version of x padded with zeros, a NaN and an inf in a ragged
   tail block, quantize at head.w1's and head.w2's 4-byte starts (slices
   of the flat delta, 12 bytes past a 16-byte boundary) against the plain
   version and the aligned kernel on a copy, head.w1 timed beside that
   copy, ptxas' registers and spills (none), each timed beside a
   device copy moving the same bytes at Np and 8 x Np, the encode beside
   F.pad then the kernel, and the encode and dequantize_int8 as one
   device kernel a call in the profiler,
   (fedavg_reduce, in fp32 and bf16) bitwise against the composition it
   replaced in both forms with integer weights and as one device kernel a
   call in the profiler, timed beside a device copy moving the same bytes,
   (fedavg_reduce at C = 2 and 64, dequant_reduce at C = 6 and 64) with
   FedBuff's staleness weights n / (1 + s) ** 0.5 in both forms, within
   4C units of 2**-24 * sum_c |w_c x_c| of the plain version,
   (dequant_reduce) at C = 6, 64 and a ragged 3 blocks, bitwise against
   the composition it replaced and its model in both forms with integer
   weights, as one device kernel a call in the profiler (C = 6 and 64),
   ptxas' registers (<= 64) and spills (none), timed in both forms beside
   a device copy moving the same bytes,
   (topk_scatter_reduce) on disjoint, repeated, unsorted, out-of-range and
   empty payloads and twice on one payload, bitwise against the composition
   it replaced in both forms (normalize True and False), within 2C - 1 ulps
   with non-integer weights, as one device kernel a call in the profiler,
   (collective_pack / collective_unpack, single vector) at every
   head-model leaf size and Np on half-way points, NaN and a sum of 4
   ranks' codes, timed at every leaf size and Np, and (the int8
   collective's leaf-table trio: collective_absmax, collective_pack over
   every leaf, collective_unpack) at the head model's five leaves, two of
   them at unaligned starts, bitwise against its plain versions and
   against the per-leaf composition it replaced on edge values (half-way
   points, +-0, +-127 s, NaN, inf and zero blocks), update-like values,
   a live and a masked rank, ptxas' spills and stack frames (none), each
   part timed at Np beside its bound and the trio against that
   composition in turns, and time kernel (through its
   ops wrapper, and as a bare launch), plain version and the library call
   where there is one;
3. drive the paper's Flower loop at the full width of
   mobilenet-head-office31 -- Server.run + FedAvg + BandwidthCodecPolicy
   over 6 Jetson TX2 clients (Int8) and 2 datacenter-class clients (Null),
   3 rounds -- with the launch counts set to 0 just before and read just
   after, and check counts, device, accuracy and wire bytes;
3b. the same over the paper's mixed fleet: 4 phones (TopK), 4 Jetsons
   (Int8), 2 datacenter-class clients (Null), then its reduced-width
   card-vs-CPU replay as in phase 4;
3c. the rest of the strategy family on the mixed fleet at full width, 3
   rounds each: FedTau (tau = the Jetson TX2 GPU's full round), FedProx
   (mu = 0.01), FedAdam, FedYogi, FedAvgM and FedBuff (K = 5, under its own
   policy), with the launch counts read every round against what it
   dispatched and aggregated, the global and server state on the card,
   FedTau's budgets and History.steps, FedBuff's stale updates and
   FedOpt's moments; FedAdam over the four phones alone (TopK) leaving
   every coordinate no client sent bitwise unchanged; each strategy's
   reduced-width card run replayed in order through a CPU strategy of the
   same config (globals and moments within rtol=atol=1e-6); a profiled
   FedAdam round;
3d. the paper's tables (repro_torch.benchmarks.paper_tables: table2a,
   table2b, table3 at their defaults) on the card and on the CPU: labels,
   simulated minutes and kJ equal, accuracy within 0.02, and the tables'
   trends;
4. run the phase-3 loop at reduced width on the card and on the CPU (where
   the plain versions run) from the same seed, replay the card's uploads
   through the CPU aggregation, and compare;
5. profile a steady full-width round of each fleet: host seconds by FL
   stage, the card's busy time and its top kernels (torch.profiler);
6. the round engine (make_round_step) at full width, parallel and
   sequential, each with the Null, Int8 and TopK codecs: 8 clients, 8 local
   steps of batch 32, tau budgets 2-8, one client dropped in round 2, with
   launch counts per round, host seconds per round and the card's busy
   time in a profiled fourth round;
7. the mesh round step at full width: 4 ranks on the one card over gloo
   (NCCL takes one rank per card), a ("pod", 2) x ("data", 2) client mesh,
   one client per rank, 3 rounds each of Int8 x fp32 collective, Int8 x
   int8 collective (rank 0 masked in round 2), Null x int8 and TopK x fp32,
   with launch counts per rank and round (the int8 collective: 1
   collective_absmax, 1 pack and 1 unpack) and the collective's
   all-reduces (the int8 one: a MAX and an int32 SUM a tier), the int8
   rounds' host seconds beside the fp32 ones, every round of every case held
   against the vmap fp32 round step from the same state (within bounds
   set a priori: for the int8 collective half a shared block scale per
   live client and residual), the held-out eval loss, a profiled fourth
   round; then a 1 x 1 mesh on NCCL, held the same way;
8. the dense transformer serving path: flash_attention and
   decode_attention held against their plain versions in phase 2 (the
   serving shapes in bf16, fp32 and bf16 at D = 32-256, a window, a
   q_offset, ragged Sq and Skv, not causal, rows with no valid key,
   linear / random / ring-arc / all-invalid decode masks, decode at the
   Jamba slice's 64 heads, at position 0 (most splits empty), at S = 1 and
   16,384, in one split and in more splits than tiles, each twice bitwise)
   and timed beside scaled_dot_product_attention, both also at the Jamba
   slice's 64 heads;
   the flash library's SASS must hold HGMMA (cuobjdump) and ptxas must
   report no spill in its wgmma kernels;
   then qwen3-0.6b at full width from init(seed) on the card through
   launch.serve.generate (B=8, prompt 1024, context 2048, 32 new tokens)
   with exactly 28 flash launches per prefill and 28 decode launches per
   step, tokens/s end to end and decoded from unsynchronized generate
   calls, prefill ms and decode ms per step each synchronized on its own,
   one profiled prefill and decode step (card busy,
   the attention kernels, idle share), prefill + decode against the
   longer prefill, and the card against the port on the CPU, each within
   a bound set a priori;
9. the hybrid serving path: selective_scan held against its plain version
   in phase 2 (the serving shape in bf16; S = 1 and 1000, Di = 300, N = 5,
   8, 16 and 64, with and without an initial state, fp32 and bf16 x, long
   memory: the model's dt and A over 1024 steps), whether its state is
   bitwise the plain version's, ptxas' spills (none) and its inner loop's
   SASS instructions a state element a step, and timed beside its bound
   (bytes, fp32 operations and exponentials); then
   one 8-layer period of jamba-1.5-large-398b at full width without its
   experts (8,999,034,880 params) from init(seed) on the card through
   launch.serve.generate at phase 8's shape, with exactly 7 selective_scan
   and 1 flash launch per prefill and 1 decode launch (no scan) per step,
   measured and checked as phase 8 is (the CPU check at a 32-token
   prompt);
10. ResNet-18 / CIFAR-10 at full width (N = 11,173,962, 62 leaves) from
   init(0): the FL kernels at its shapes -- quantize_int8,
   dequantize_int8 and Int8Codec().encode at N, dequant_reduce at C = 4,
   fedavg_reduce at C = 2, topk_scatter_reduce at C = 4 and k = 111,739,
   the collective trio over the 62 leaves at their real starts -- bitwise
   against their plain versions or the compositions they replaced, each
   timed through its wrapper and as a bare launch beside its bound and a
   device copy of the same bytes; then, with the launch counts read every
   round, (a) repro_torch.examples.heterogeneous_cutoff.run (2 Jetson TX2
   GPU + 2 CPU clients, FedTau at tau 0 and at the GPU's round under
   BandwidthCodecPolicy, 3 rounds each: 4 quantize, 4 dequantize and 1
   dequant_reduce a round, the Int8 wires billed at N, the cutoff's
   budgets, accuracy rising), its round 2 split by host stage and round 3
   profiled, and its reduced-width card run (1 round a tau run) replayed
   through a CPU FedTau and held against the CPU run; (b) the mixed fleet
   of 2 phones (TopK), 2 Jetsons (Int8) and 2 datacenter-class clients
   (Null) under FedAvg, 2 rounds, every FL kernel once a reduce; (c) the
   round engine as phase 6 at 2 rounds a case, parallel Int8's profiled;
   (d) the mesh's int8 collective with the Int8 uplink on phase 7's 4
   gloo ranks, 2 rounds, held against the vmap fp32 round step.  Each
   leg's seconds printed.
11. population mode on mobilenet-head-office31 at full width (N =
   1,974,303): (a) Population.synthetic(1,000,000) of the mixed fleet's
   seven classes, the from_profiles churn trace, cohort 16, FedAvg under
   BandwidthCodecPolicy, a LazyClientPool of 64 over a CohortState, 3
   rounds: each round's launches against its cohort's codec groups (a
   quantize and a dequantize an Int8 client, a reduce a reported group,
   nothing else), its billed bytes against the cohort's wires, the pool's
   live clients, accuracy rising; round 2 split by host stage (sampling,
   materializing, properties, fit, aggregate, evaluate), round 3 profiled;
   (b) 48 devices, a pool of 8 and a store of 32 rows, 4 rounds (store
   evictions, rehydrated clients), the run at N == cohort size through
   population mode and the list path (History equal, the global bitwise),
   and the spill run's reduced-width card-vs-CPU replay as in phase 4;
   (c) make_round_step (parallel, C = 8) with Int8 and TopK, its residual
   rows through CohortState.gather / scatter bitwise against the state
   threaded on the card, the eviction replay bitwise, gather and scatter of
   the (8, N) block timed beside one copy of it each way; (d) a round
   setup (CostAwareFedAvg.sample_cohort, step_jitter_for, gather, scatter
   at C = 16) at 10^3 and 10^6 devices, the median at 10^6 within 2x (or
   2 ms) of 10^3, <= 2 bytes a device; (e) straggler_bench.py's population
   row: 60 devices, cohort 8, Deadline at 1.25x a Jetson's round, 3 rounds
   each of CostAwareFedAvg (every cohort predicted feasible) and blind
   FedAvg (no fewer drops).
12. the scanned multi-round trainer (Server.run_scanned: the whole run as
   one CUDA graph, captured once and replayed) on mobilenet-head-office31
   at full width over tests/test_scan.py's mixed fleet (a TPU-class chip,
   2 Jetsons, 3 phones) under a Deadline at 1.25x a Jetson's round with
   the mobiles churning, 8 local steps of batch 32: parallel Null, Int8
   and TopK (frac 0.05, a cohort of 4), sequential Int8 and parallel Null
   under FedAdam, each at R = 8 bitwise the per-round driver
   (reference=True) on the final globals, every stacked output and the
   History, with the launches of the warm-up round, the capture (R times
   a round's), the reference run and a replay (none), and a second call
   replaying without a second capture; parallel Int8 with one batch
   reused every round at R = 8 and 32: rounds/s of the graph and of the
   driver (median of 5 calls after one warm-up call), capture seconds,
   the graph's kernel nodes and its memory pool (flat in R within 5%); one
   profiler session over a graph call and a driver call (each kernel's
   name R times a round's launches; the card's idle share against the
   unprofiled call) and a TopK graph call.
13. the segmented and mixed wire on mobilenet-head-office31 at full width,
   N = 1,974,303 in the 5 segments of SegmentMap.from_tree (head.w1 and
   head.w2 at unaligned starts): (a) Server.run on the mixed fleet with
   BandwidthCodecPolicy's three codecs on the map, 3 rounds: 20 quantize,
   20 dequantize and one reduce a codec group and segment (5 each) a
   round, nothing else; every wire's num_bytes its codec's wire_bytes; the
   grouped per-segment reduce against the per-client dense decode on the
   CPU (float64) within 1e-6 of its largest value; round 3 profiled; then
   2 rounds with the flat codecs and 2 with SegmentMap.flat, bitwise;
   (b) LoRACodec(rank=4, factor_codec=Int8Codec()) on the smoke fleet, 3
   rounds: 18,103 B a client against 2,005,155 for Int8, the frozen base
   decoding to exact zeros, 64 quantize and 128 dequantize a round, the
   loss falling; (c) make_round_step on the mixed fleet (C = 10, 8 steps
   of batch 32), parallel and sequential, with the policy's MixedCodec and
   a segmented bank of LoRA phones and Int8: launches a round, a masked
   client with NaN data leaving the global and every row bitwise (its own
   row carried), host s a round, a profiled round's busy time; (d)
   population mode with Int8 on the map: Server.run over 10^6 devices,
   cohort 16, a pool of 8 spilling leafwise rows, 2 rounds; the store's
   leafwise gather / scatter bitwise, an evicted device back as zeros;
   gather / scatter of the (8, N) block and a round setup at 10^6 devices
   against the flat store in turns; (e) run_scanned on the scan fleet at
   R = 8 with the policy's MixedCodec, Int8 on the map and a bank of LoRA
   phones on the map: the graph bitwise the per-round driver, the
   launches of the warm-up round, the capture (R times) and a replay
   (none), rounds/s of both drivers, capture s, kernel nodes, pool bytes.
14. MoE and dense-family serving: flash_attention and decode_attention
   held and timed in phase 2 at these heads too (H = KV = 32 at D = 80,
   H = KV = 16, 32 over 8); then, one after the other, each freeing its
   weights, deepseek-moe-16b at full width (16,879,568,896 params),
   mixtral-8x7b cut from 32 to 16 layers (23,482,470,400), granite-8b
   (8,254,689,280) and stablelm-3b (2,795,443,200) through phase 8's
   serving function at its shape, one flash launch a layer per prefill and
   one decode launch a layer per step, nothing else; bounds 2**-8 *
   sqrt(roundings a layer * layers); the MoE legs with each layer's drop
   fraction, the MoE layer's device time by stage at the prefill's and a
   decode step's input, the expert bytes a decode step reads, moe_forward
   on the card against the CPU on identical inputs under
   set_sync_debug_mode("error"), the card-vs-CPU check on the first 4
   layers, and the consistency and CPU checks held only where the runs
   route alike (and drop nothing), flips and drops reported.
15. MLA and frontend serving: flash_attention held and timed in phase 2 at
   minicpm3-4b's MLA prefill (qk width 96, V zero-padded from 64: the
   padded columns exact zeros, the kept ones against SDPA on the unpadded
   V), paligemma-3b's 8 heads over 1 at D = 256 over 1280 positions and
   musicgen-medium's 24 x 64 over 1088, decode_attention at paligemma's
   and musicgen's caches; then, each freeing its weights, minicpm3-4b
   (4,073,875,968 params), paligemma-3b (2,511,022,080) and musicgen-medium
   (1,819,708,416) at full width through phase 8's serving function, the
   frontend legs after their numpy-drawn frontend embeddings (256 and 64
   positions): 62 flash launches a prefill and none a decode step
   (minicpm: the absorbed decode has no kernel), 18 / 18 and 48 / 48
   (paligemma, musicgen), nothing else; bounds 2**-8 * sqrt(roundings a
   layer * layers); the card-vs-CPU check on the first 4 layers; minicpm's
   decode step of the whole stack under set_sync_debug_mode("error"), and
   layer 0's mla_forward and its mla_decode at the first three decode
   positions against the CPU on identical inputs.
16. xLSTM serving: xlstm-1.3b at full width, nothing cut (3,579,976,016
   params: 6 sLSTM layers of 4 x 512 and 42 mLSTM layers of 4 x 1024)
   through phase 8's serving function at its shape: no hand-written kernel
   launches in a prefill or a decode step, nothing else; bounds 2**-8 *
   sqrt(roundings of the layers) (sLSTM 11, mLSTM 14); the card-vs-CPU
   check on the first 4 layers (sLSTM, mLSTM x 3); a decode step of the
   whole stack under set_sync_debug_mode("error"); layer 0's slstm_forward
   and layer 1's mLSTM prefill, (C, n, m) and mlstm_decode at the next
   three positions against the CPU on identical inputs; the mLSTM's fp32
   quadratic form and final state timed beside their fp32 bound, the sLSTM
   recurrence's host ms and device events a prefill, one mLSTM decode
   layer timed.  A serving trace over 8 MB gzipped is replaced by the
   profiler's per-op summary (DIR/<leg>_<phase>_trace.ops.txt).
17. LM fine-tuning (dense transformer training): (a) the forward's lse and
   the hand-written flash backward (flash_attention_bwd) against
   ref.attention_with_lse / ref.attention_bwd and autograd of
   ref.attention within 2e-5 (fp32) / 2e-2 (bf16) of each tensor's
   max-abs, two calls bitwise equal, at the training shape (B·C = 8, S =
   512, H 16 over KV 8, D 128, causal) in bf16 and fp32, GQA 32/8, D = 80
   and 64, a window at a q_offset, ragged S = 300, not causal at D = 256,
   rows with no valid key (also bf16 at D = 256 under a window), and the
   widths the training slices launch (paligemma's 8 over 1 at D = 256,
   also over phase 19's 768 positions, MLA's qk 96, at 16 heads and at
   phase 19's 40, musicgen's 24 x 64); at the training shape, phase 18's
   and phase 19's two, the backward and the forward with lse timed
   through the wrapper and as a
   bare launch, bf16's dQ and dK / dV kernels also alone, beside their
   bounds, the plain backward and scaled_dot_product_attention's forward
   and backward; ptxas' registers and spills of the 12 backward kernels,
   none in the six wgmma ones (bf16's tensor-core route); (b) qwen3-0.6b
   at full width cut to 2 layers: loss_fn's value and every leaf's
   gradient on the card against the port's CPU route on identical inputs,
   fp32 (2 x 512 tokens) and bf16 (1 x 256); (c) qwen3-0.6b at full width
   (28 layers, 596,049,920 params, bf16) on make_round_step in parallel
   mode as repro_torch/examples/federated_llm_finetune.py builds it (C = 4
   clients, 2 x 512 tokens, 2 local steps, sgd(0.1), FedAvg, 3 rounds)
   with the fp32 wire, Int8 and LoRA rank 4 with Int8 factors: per round
   exactly 56 flash forward and 56 backward launches (one a layer and
   local step for the whole cohort) and the codec's (none for fp32's
   leafwise mean; Int8 a quantize, a dequantize and a dequant_reduce a
   segment; LoRA those of each fallback segment and a quantize and a
   dequantize of each matrix segment's factors), no kernels.ref call,
   finite losses and params; round seconds, trained tokens/s, peak memory,
   and a profiled fourth Int8 round (card idle share, the flash backward's
   share of card time; DIR/lm_finetune_round_trace.json.gz); (d) the
   example at its defaults on the card (8 rounds): the last round's loss
   below the first's;
18. MoE fine-tuning (MoE transformer training): (a) one deepseek-moe-16b
   MoE layer at full width (64 experts of 1408 top-6 + 2 shared, d 2048)
   under vmap(grad_and_value) over C = 2 clients of 2 x 512 tokens, fp32
   and bf16, with no host sync: two evaluations bitwise equal, the routes
   against the CPU's (flips reported), fp32 gradients within relative L2
   1e-4 of the CPU's where a client's routes agree, the bf16 step's device
   ms by stage (router, dispatch, expert products, combine, shared
   experts; forward and backward); (b) deepseek-moe-16b at full width cut
   to 2 layers (1,595,156,480 params, bf16) on make_round_step as phase
   17's leg c with C = 2 and the fp32, Int8 and LoRA wires: exactly 4
   flash forward and 4 backward launches a round and the codec's, each
   MoE layer's aux terms and drop fraction, peak memory under 76 GB, a
   profiled fourth Int8 round with its MoE stages' shares
   (DIR/moe_finetune_round_trace.json.gz); (c) the example at --arch
   mixtral-8x7b --codec lora --rank 4 on the card (reduced, 8 rounds):
   finite losses, the last below the first.  Phase 17's leg a times the
   flash backward at this path's 16 x 16 x 128.
19. MLA and frontend-token fine-tuning: (a) one minicpm3-4b MLA layer at
   full width (d 2560, 40 heads, qk 64 + 32 over v 64 zero-padded to 96,
   ranks 768 / 256) under vmap(grad_and_value) over C = 2 clients of 2 x
   512 tokens, fp32 and bf16, with no host sync and no kernels.ref call:
   two evaluations bitwise equal, one flash forward and one backward
   launch each, fp32 loss and every gradient (x's too) within relative
   L2 2e-5 of the CPU's; (b) minicpm3-4b at full width cut to 8 layers
   (689,428,992 params, bf16) on make_round_step as phase 17's leg c with
   C = 2 and the fp32, Int8 and LoRA wires: exactly 16 flash forward and
   16 backward launches a round and the codec's, a profiled fourth Int8
   round (DIR/mla_finetune_round_trace.json.gz); (c) paligemma-3b whole
   (2,511,022,080 params, bf16): one grad_and_value(loss_fn) step on 2 x
   512 tokens after the 256 frontend positions and SGD(0.01), the loss
   finite and positive, every updated leaf finite, frontend_proj.w's
   gradient finite and nonzero, exactly 18 flash forward and 18 backward
   launches (8 heads over 1 at D = 256); (d) 2-layer cuts of paligemma-3b
   and musicgen-medium at full width in fp32, 1 x 128 text tokens after
   the frontend positions: the loss and every gradient leaf within
   relative L2 2e-5 of the CPU's.  Phase 17's leg a holds and times the
   flash backward at this path's 40 x 96 and paligemma's 8 over 1 at D =
   256 over 768 positions.
20. hybrid Mamba fine-tuning: (a) the training forward (the state written
   every 8 steps) and the selective scan backward kernel at the layer
   leg's shape (B·C = 4, S = 512, Di = 16384, N = 16, bf16 and fp32, G = 2
   with A shared and per client), S = 1, 37, 1000, Di = 300, N = 5, 8, 32,
   64, an initial state with its gradient, a final-state cotangent, long
   memory, G = 1, 2, 4: one launch each, every gradient within relative L2
   1e-5 (a bf16 dx 2**-8) of ref.selective_scan_bwd and of autograd of
   ref.selective_scan, at Di <= 300 bitwise the kernel model, two calls
   bitwise equal, no ptxas spill; the backward timed (wrapper and bare)
   beside its bound and the plain version, the forward with checkpoints
   against the forward without; (b) one jamba mamba mixer at full width
   (d 8192, d_inner 16384, N 16, dt_rank 512) under vmap(grad_and_value)
   over C = 2 clients of 2 x 512 tokens, fp32 and bf16, params shared and
   per client, with no host sync and no kernels.ref call: two evaluations
   bitwise equal, 1 + 1 scan launches each, every fp32 gradient within
   relative L2 2e-5 of the CPU's and the loss within 2e-5 of its terms'
   magnitudes (at 128 positions); (c) jamba at
   full width cut to 1 layer without experts (2,098,077,696 params, bf16)
   on make_round_step as phase 17's leg c with C = 2 and the fp32, Int8 and
   LoRA wires, client-parallel on the allocator's expandable segments (in
   fixed segments its 68 GB fragmented the pool): exactly 2 + 2 scan
   launches a round and the codec's, peak under 76 GB, a profiled fourth
   Int8 round
   (DIR/hybrid_finetune_round_trace.json.gz); (d) phase 9's 8-layer period
   (8,999,034,880 params, bf16): one grad_and_value(loss_fn) step on 2 x
   512 tokens and SGD(0.01) leaf by leaf, 7 + 7 scan and 1 + 1 flash
   launches, every gradient finite and nonzero, peak under 76 GB; (e) the
   2-layer [mamba, attn] cut at full width in fp32, 1 x 128 tokens: the
   loss and every gradient leaf within relative L2 2e-5 of the CPU's.

Every phase's seconds are printed after it and again at the end.

Prints the card's nvidia-smi name and power limit and a {"kernels": [...]}
line, and ends with {"ok": true, "device": {...}}.  The full report goes
to DIR/chip_smoke.json and the profiled round's trace to
DIR/round3_trace.json, DIR/mixed_fleet_round3_trace.json,
DIR/fedadam_mixed_fleet_round3_trace.json, DIR/resnet_round3_trace.json.gz
and DIR/population_round3_trace.json.gz, the serving traces to
DIR/<leg>_{prefill,decode}_trace.json.gz for the legs serving, hybrid,
deepseek, mixtral16, granite, stablelm, minicpm, paligemma, musicgen and
xlstm, phase 17's profiled round to DIR/lm_finetune_round_trace.json.gz,
phase 18's to DIR/moe_finetune_round_trace.json.gz, phase 19's to
DIR/mla_finetune_round_trace.json.gz and phase 20's to
DIR/hybrid_finetune_round_trace.json.gz (DIR defaults to smoke_out).  If
``repro_torch`` cannot be imported (the script run away from the
repository's ``src/``), it says so on stdout and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores (1980 MHz)
H100_SMS = 132
# dense bf16 on the tensor cores: 4 tensor cores an SM, 1024 FLOP a clock each.
# The data sheet's 989 TFLOP/s is this at 1830 MHz; the bounds take the
# card's own maximum SM clock (1980 MHz on the H100 SXM: 1070 TFLOP/s), the
# clock the fp32 rate and the selective scan's exponentials assume too.
BF16_FLOP_PER_CLOCK_PER_SM = 4096
BLOCK = 256
N_PARAMS = 1_974_303          # mobilenet-head-office31, frozen base included
REPORT = {"checks": [], "timings": []}
T_START = time.perf_counter()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(name: str, ok: bool, **info) -> None:
    REPORT["checks"].append({"name": name, "ok": bool(ok), **info})
    print(f"[{'ok' if ok else 'FAIL'}] {name} {json.dumps(info, default=str)}", flush=True)
    if not ok:
        raise SystemExit(f"check failed: {name} {json.dumps(info, default=str)[:4000]}")


# ---------------- timing ----------------
_FLUSH = None


def time_ms(fn, iters: int = 30, lead_cycles: int = 0) -> float:
    """Median device time of one call.  Before each call a 512 MB memset
    evicts the 50 MB L2 (the server meets freshly decoded wires mostly
    cold) and keeps the card busy while the host enqueues the call, so the
    events bracket the device work and not the host's launch overhead.  A
    call whose host side outlasts the memset (autograd's dispatch of a
    library backward) gets ``lead_cycles`` more of a device-side sleep."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def allocator_settings(setting: str) -> None:
    """Set the CUDA caching allocator's option ``setting`` for what it
    allocates from here on (``PYTORCH_CUDA_ALLOC_CONF``'s syntax)."""
    set_ = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (set_ or torch.cuda.memory._set_allocator_settings)(setting)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bf16_flop_per_s() -> float:
    """The card's dense bf16 tensor-core peak at its maximum SM clock."""
    return H100_SMS * BF16_FLOP_PER_CLOCK_PER_SM * max_sm_clock_hz()


def bound(nbytes: int, flops: int, peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def delta_like(rng, shape, device="cuda"):
    """Update-delta-like fp32 values spanning several magnitudes, with one
    all-zero quantization block (scale 0 -> 1)."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-5, -1, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1)[:BLOCK] = 0.0
    return torch.from_numpy(x).to(device)


# ---------------- phase 2: kernels against their plain versions ----------------
def kernel_phase(rng) -> dict:
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda")
    rows = {}
    tol = dict(rtol=1e-6, atol=1e-6)

    def launch(lib, fn, counter, *args):
        """The bare kernel launch (``launch_ms``).  ``ms`` times the ops
        wrapper instead -- checks, allocation and any work around the
        launch -- which is the work ``plain_ms`` times too."""
        return lambda: _cuda.launch(lib, fn, counter, dev, *args)

    one_kernel_a_call_check(dev)

    rows.update(codec_kernel_checks(rng, dev, launch))

    rows["dequant_reduce"] = dequant_reduce_kernel_checks(rng, dev, tol, launch)
    rows["fedavg_reduce"] = fedavg_kernel_checks(dev, tol, launch)
    fedbuff_weight_checks(dev)
    rows["topk_scatter_reduce"] = topk_kernel_checks(dev, tol, launch)
    collective_kernel_checks(dev, launch)
    rows.update(collective_leaf_checks(dev, launch))
    rows.update(attention_kernel_checks(dev, launch))
    rows["selective_scan"] = scan_kernel_checks(dev, launch)
    return rows


NP_MAIN = (N_PARAMS // BLOCK + 1) * BLOCK   # the codec's padded length, 1,974,528
ENGINE_C = 8                               # phase 6's clients: encode_batch quantizes (C * Np,)


def ptxas_report(lib: str, name_of) -> dict:
    """ptxas' registers and spills per kernel of library ``lib``, read from
    the build log ``_cuda.build`` keeps beside it, and printed.
    ``name_of`` maps a "Compiling entry function" line to the kernel's
    label, or to None for a kernel not reported."""
    import re

    from repro_torch.kernels import _cuda

    ptxas, name = {}, None
    for line in _cuda.build_log(lib).splitlines():
        if "Compiling entry function" in line:
            name = name_of(line)
            if name:
                ptxas[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            ptxas[name].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                               spill_loads=int(m[3]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            ptxas[name]["registers"] = int(m[1])
    for name, info in ptxas.items():
        print(f"ptxas {name}: {info}", flush=True)
    return ptxas


def no_spill(ptxas: dict) -> bool:
    return all(v.get("spill_stores") == 0 == v.get("spill_loads") for v in ptxas.values())


def codec_build_checks() -> dict:
    """ptxas' registers and spills of the codec kernels (quantize at an
    aligned and at any 4-byte start, dequantize): no spill in any."""
    ptxas = ptxas_report("quantize", lambda line: next(
        (k for k in ("dequantize_int8_kernel", "quantize_int8_unaligned_kernel",
                     "quantize_int8_kernel") if k in line), None))
    check("ptxas reports the three codec kernels, and no spill in any",
          len(ptxas) == 3 and no_spill(ptxas), kernels=ptxas)
    return ptxas


def codec_kernel_checks(rng, dev, launch) -> dict:
    """quantize_int8 / dequantize_int8 against their plain versions,
    bitwise: at Np and at 9 blocks (the main and ragged cases); quantize at
    N = 1, 255, 257 and 1,974,303 (the codec's unpadded delta) against the
    plain version of x padded with zeros, and ``Int8Codec().encode`` at
    N = 1,974,303 likewise; a NaN and an inf in a ragged tail block (that
    block's scale NaN, the other blocks' codes and scales bitwise);
    dequantize at a block count that is no multiple of the grid
    (61,705 blocks); both at the round engine's C * Np = 8 x 1,974,528.
    Timed at Np and at C * Np: the ops wrapper, the bare launch, the plain
    version, dequantize's library call and a device copy moving the same
    bytes; and the codec's encode at N = 1,974,303 (one launch) beside the
    pad then the kernel.  ptxas' registers and spills go in the rows."""
    import torch.nn.functional as F

    from repro_torch.core.compression import Int8Codec
    from repro_torch.kernels import ops, ref

    def padded(x):
        return F.pad(x, (0, (-x.numel()) % BLOCK))

    def codes_agree(label, x, q, s):
        """-> (max |difference|, the plain version's codes and scales)"""
        qr, sr = ref.quantize_int8(padded(x))
        err = max(float((q.int() - qr.int()).abs().max()), float((s - sr).abs().max()))
        check(f"quantize_int8 bitwise the plain version of x padded with zeros [{label}, "
              f"N={x.numel()}]", torch.equal(q, qr) and torch.equal(s, sr),
              codes_differing=int((q != qr).sum()), max_abs_err=err)
        return err, qr, sr

    ptxas = codec_build_checks()
    rows = {}
    for label, n_blocks in (("main", NP_MAIN // BLOCK), ("ragged", 9),
                            ("round engine, C * Np", ENGINE_C * NP_MAIN // BLOCK),
                            ("no multiple of the grid", 61_705)):
        x = delta_like(rng, (n_blocks * BLOCK,))
        q, s = ops.quantize_int8(x)
        q_err, qr, sr = codes_agree(label, x, q, s)
        xd = ops.dequantize_int8(q, s)
        xr = ref.dequantize_int8(qr, sr)
        dq_err = float((xd - xr).abs().max())
        check(f"dequantize_int8 bitwise [{label}, Np={x.numel()}]", torch.equal(xd, xr),
              max_abs_err=dq_err)
        if label not in ("main", "round engine, C * Np"):
            continue
        lib = torch.mul(q.view(-1, BLOCK), s[:, None]).reshape(-1)
        check(f"dequantize_int8's library call (q.view(-1, 256) * s[:, None]) bitwise "
              f"[Np={x.numel()}]", torch.equal(lib, xr))
        qo, so, xo = torch.empty_like(q), torch.empty_like(s), torch.empty_like(xd)
        moved = nbytes(x, q, s)  # the same for both directions
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        b_ms, b_by = bound(moved, 6 * x.numel())
        qrow = dict(
            source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:41",
            max_abs_err=q_err,
            ms=time_ms(lambda: ops.quantize_int8(x)),
            launch_ms=time_ms(launch("quantize", "repro_quantize_int8", "quantize_int8",
                                     x.data_ptr(), qo.data_ptr(), so.data_ptr(), x.numel(),
                                     n_blocks)),
            plain_ms=time_ms(lambda: ref.quantize_int8(x)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            # a device copy moving the same bytes (half read, half written)
            copy_ms=time_ms(lambda: dst.copy_(src)),
            shape=f"x ({x.numel()},) fp32", bytes=moved, ptxas=ptxas["quantize_int8_kernel"],
        )
        b_ms, b_by = bound(moved, xd.numel())
        drow = dict(
            source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:69",
            max_abs_err=dq_err,
            ms=time_ms(lambda: ops.dequantize_int8(q, s)),
            launch_ms=time_ms(launch("quantize", "repro_dequantize_int8", "dequantize_int8",
                                     q.data_ptr(), s.data_ptr(), xo.data_ptr(), n_blocks)),
            plain_ms=time_ms(lambda: ref.dequantize_int8(q, s)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.mul(q.view(-1, BLOCK), s[:, None])),
            copy_ms=time_ms(lambda: dst.copy_(src)),
            shape=f"q ({q.numel()},) int8", bytes=moved, ptxas=ptxas["dequantize_int8_kernel"],
        )
        del src, dst
        if label == "main":
            rows["quantize_int8"], rows["dequantize_int8"] = qrow, drow
        else:
            REPORT["timings"] += [{"name": "quantize_int8", "case": label, **qrow},
                                  {"name": "dequantize_int8", "case": label, **drow}]

    # the unpadded lengths the codec hands quantize
    for n in (1, 255, 257, N_PARAMS):
        x = delta_like(rng, (n,)) if n > BLOCK else torch.from_numpy(
            (rng.normal(size=n) * 1e-3).astype(np.float32)).to(dev)
        q, s = ops.quantize_int8(x)
        codes_agree("unpadded", x, q, s)
        check(f"quantize_int8: the pad's codes are 0 [N={n}]", not q[n:].any())
    delta = delta_like(rng, (N_PARAMS,))
    enc = Int8Codec().encode(delta)
    codes_agree("Int8Codec().encode", delta, enc["q"], enc["scale"])
    rows["quantize_int8"].update(
        encode_ms=time_ms(lambda: Int8Codec().encode(delta)),
        # the encode as it was before quantize took any N: F.pad, then the kernel
        pad_then_kernel_ms=time_ms(lambda: ops.quantize_int8(padded(delta))),
        encode_shape=f"delta ({N_PARAMS},) fp32",
    )

    # a NaN and an inf in the tail block of a ragged N: its scale is NaN as
    # the plain version's (torch.amax); every other block stays bitwise
    n = 4 * BLOCK + 77
    x = delta_like(rng, (n,))
    x[4 * BLOCK + 5], x[4 * BLOCK + 60] = float("nan"), float("inf")
    q, s = ops.quantize_int8(x)
    qr, sr = ref.quantize_int8(padded(x))
    check("quantize_int8: a NaN and an inf in a ragged tail block poison only its scale "
          f"[N={n}]",
          bool(torch.isnan(s[4]) and torch.isnan(sr[4]))
          and torch.equal(s[:4], sr[:4]) and torch.equal(q[:4 * BLOCK], qr[:4 * BLOCK]))

    # a segment's slice of the flat delta: head.w1 and head.w2 start 12
    # bytes past a 16-byte boundary (the segmented wire's Int8 encode);
    # one launch of the 4-byte-start kernel, bitwise the plain version and
    # the aligned kernel on a copy; timed at head.w1 beside that copy
    delta = delta_like(rng, (N_PARAMS,))
    for name, off, size in (("head.w1", 1_638_687, 327_680), ("head.w2", 1_966_367, 7_936)):
        x = delta[off:off + size]
        before = ops.launch_counts()["quantize_int8"]
        q, s = ops.quantize_int8(x)
        err, _, _ = codes_agree(f"{name} at its offset {off}", x, q, s)
        qa, sa = ops.quantize_int8(x.clone())
        check(f"quantize_int8 at {name}'s 4-byte start ({x.data_ptr() % 16} bytes past 16): one "
              "launch, bitwise the aligned kernel on a copy",
              ops.launch_counts()["quantize_int8"] == before + 2 and x.data_ptr() % 16 == 12
              and torch.equal(q, qa) and torch.equal(s, sa))
        if name != "head.w1":
            continue
        aligned = x.clone()
        n_blocks = -(-size // BLOCK)
        qo, so = torch.empty_like(q), torch.empty_like(s)
        moved = nbytes(x, q, s)
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        b_ms, b_by = bound(moved, 6 * size)
        REPORT["timings"].append(dict(
            name="quantize_int8", case="head.w1 at its 4-byte start", max_abs_err=err,
            ms=time_ms(lambda: ops.quantize_int8(x)),
            launch_ms=time_ms(launch("quantize", "repro_quantize_int8", "quantize_int8",
                                     x.data_ptr(), qo.data_ptr(), so.data_ptr(), size, n_blocks)),
            aligned_ms=time_ms(lambda: ops.quantize_int8(aligned)),
            aligned_launch_ms=time_ms(launch("quantize", "repro_quantize_int8", "quantize_int8",
                                             aligned.data_ptr(), qo.data_ptr(), so.data_ptr(),
                                             size, n_blocks)),
            plain_ms=time_ms(lambda: ref.quantize_int8(padded(x))),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            copy_ms=time_ms(lambda: dst.copy_(src)),
            shape=f"x ({size},) fp32 at float {off}", bytes=moved,
            ptxas=ptxas["quantize_int8_unaligned_kernel"]))
        del src, dst
    return rows


def reduce_build_checks() -> dict:
    """ptxas' registers and spills of the Int8 reduce kernel: no spill, and
    at most 64 registers (its launch bound of 4 CTAs of 256 threads an
    SM)."""
    ptxas = ptxas_report("dequant_reduce", lambda line: (
        "dequant_reduce_kernel" if "dequant_reduce_kernel" in line else None))
    info = ptxas.get("dequant_reduce_kernel", {})
    check("ptxas reports dequant_reduce_kernel at <= 64 registers, and no spill",
          bool(info) and no_spill(ptxas) and 0 < info.get("registers", 0) <= 64, kernel=info)
    return info


def dequant_reduce_kernel_checks(rng, dev, tol, launch) -> dict:
    """dequant_reduce against its plain version: C=6 (the fleet's Int8
    group) and C=64 at Np, and a ragged 3 blocks at C=3, within
    rtol=atol=1e-6 with non-integer weights; with integer weights bitwise
    the one-launch model and the composition it replaced in both forms
    (the weights normalized around the old kernel's chain, and
    normalize=False against that mean then ``ops._denormalize``); all-zero
    weights give zeros in both forms (one device kernel a call:
    ``one_kernel_a_call_check``).  Timed at C=6 and C=64: the ops wrapper
    in both forms, the bare launch, the plain version (the CPU route's
    composition on the card for normalize=False) and a device copy moving
    the same bytes (half read, half written).  ptxas' registers and spills
    go in the row."""
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_kernel_models import dequant_reduce_composition, dequant_reduce_one_launch

    ptxas = reduce_build_checks()
    row = None
    for label, c, npad in (("main", 6, NP_MAIN), ("C=64", 64, NP_MAIN), ("ragged", 3, 3 * BLOCK)):
        x = delta_like(rng, (c, npad))
        qr, sr = ref.quantize_int8(x.reshape(-1))
        q, s = qr.reshape(c, npad), sr.reshape(c, npad // BLOCK)
        del x, qr, sr
        w = torch.from_numpy((rng.random(c) * 500 + 10).astype(np.float32)).to(dev)
        out, exp = ops.dequant_reduce(q, s, w), ref.dequant_reduce(q, s, w)
        err = float((out - exp).abs().max())
        check(f"dequant_reduce within rtol=atol=1e-6 [{label}: C={c}, Np={npad}]",
              torch.allclose(out, exp, **tol), max_abs_err=err)
        for normalize in (True, False):
            zero = ops.dequant_reduce(q, s, torch.zeros_like(w), normalize=normalize)
            check(f"dequant_reduce zero weights -> zeros [{label}, normalize={normalize}]",
                  not zero.any() and not zero.isnan().any())
        wi = torch.from_numpy(rng.integers(10, 500, c).astype(np.float32)).to(dev)
        mean = ops.dequant_reduce(q, s, wi)
        summed = ops.dequant_reduce(q, s, wi, normalize=False)
        old_mean = dequant_reduce_composition(q, s, wi)
        check(f"dequant_reduce bitwise the composition it replaced and its model, integer "
              f"weights, normalize True and False [{label}]",
              torch.equal(mean, old_mean)
              and torch.equal(mean, dequant_reduce_one_launch(q, s, wi))
              and torch.equal(summed, ops._denormalize(old_mean, wi))
              and torch.equal(summed, dequant_reduce_composition(q, s, wi, normalize=False))
              and torch.equal(summed, dequant_reduce_one_launch(q, s, wi, normalize=False)),
              mean_differing=int((mean != old_mean).sum()),
              summed_differing=int((summed != ops._denormalize(old_mean, wi)).sum()))
        if label == "ragged":
            continue
        wf, outo = w.contiguous(), torch.empty_like(out)
        moved = nbytes(q, s, w, out)
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        b_ms, b_by = bound(moved, 3 * q.numel())
        plain = {True: lambda: ref.dequant_reduce(q, s, w),
                 # the CPU route's composition, on the card
                 False: lambda: ops._denormalize(ref.dequant_reduce(q, s, w), w)}
        for normalize in (True, False):
            timing = dict(
                source="src/repro_torch/kernels/csrc/dequant_reduce.cu",
                replaces="src/repro/kernels/dequant_reduce.py:77",
                max_abs_err=err,
                ms=time_ms(lambda: ops.dequant_reduce(q, s, w, normalize=normalize)),
                launch_ms=time_ms(launch("dequant_reduce", "repro_dequant_reduce",
                                         "dequant_reduce", q.data_ptr(), s.data_ptr(),
                                         wf.data_ptr(), outo.data_ptr(), c, npad,
                                         int(normalize))),
                plain_ms=time_ms(plain[normalize]),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                # a device copy moving the same bytes (the floor of this timing)
                copy_ms=time_ms(lambda: dst.copy_(src)),
                shape=f"q ({c}, {npad}) int8" + ("" if normalize else ", normalize=False"),
                bytes=moved, ptxas=ptxas,
            )
            if label == "main" and normalize:
                row = timing
            else:
                case = label if normalize else f"{label}, normalize=False"
                REPORT["timings"].append({"name": "dequant_reduce", "case": case, **timing})
        del src, dst
    return row


def fedavg_kernel_checks(dev, tol, launch) -> dict:
    """fedavg_reduce against its plain version: C=2 (the smoke fleet's Null
    group) and C=64 at full width in fp32 and bf16, and a ragged N, within
    rtol=atol=1e-6 (one bf16 ulp) with non-integer weights; with integer
    weights bitwise the composition it replaced in both forms (the mean,
    and normalize=False against the old kernel's mean then
    ``ops._denormalize``); all-zero weights give zeros in both forms (one
    device kernel a call: ``one_kernel_a_call_check``).  Timed at C=2,
    C=64 and bf16: the
    ops wrapper in both forms, the bare launch, the plain version, the
    cuBLAS gemv ``wn @ u`` and a device copy moving the same bytes (half
    read, half written: the floor of this timing)."""
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, str(ROOT / "tests"))
    # the kernel's arithmetic in plain torch: for integer weights, the
    # composition it replaced (weights normalized by safe_weight_sum around
    # the old kernel's fmaf chain, then ops._denormalize)
    from torch_kernel_models import fedavg_one_launch

    rng = np.random.default_rng(19)
    f32, bf16 = torch.float32, torch.bfloat16
    row = None
    for label, c, n, dtype in (
        ("main", 2, N_PARAMS, f32), ("C=64", 64, N_PARAMS, f32), ("bf16", 2, N_PARAMS, bf16),
        ("C=64, bf16", 64, N_PARAMS, bf16), ("ragged", 3, 1001, f32),
        ("ragged, bf16", 3, 1001, bf16),
    ):
        u = delta_like(rng, (c, n)).to(dtype)
        w = torch.from_numpy((rng.random(c) * 500 + 10).astype(np.float32)).to(dev)
        out, exp = ops.fedavg_reduce(u, w), ref.fedavg_reduce(u, w)
        # bf16: the two fp32 sums may straddle a bf16 rounding edge -> one ulp
        t = tol if dtype == f32 else dict(rtol=2**-7, atol=1e-8)
        err = float((out.float() - exp.float()).abs().max())
        check(f"fedavg_reduce within {t} [{label}: C={c}, N={n}, {dtype}]",
              out.dtype == dtype and torch.allclose(out.float(), exp.float(), **t),
              max_abs_err=err)
        for normalize in (True, False):
            zero = ops.fedavg_reduce(u, torch.zeros_like(w), normalize=normalize)
            check(f"fedavg_reduce zero weights -> zeros [{label}, normalize={normalize}]",
                  not zero.any() and not zero.isnan().any())
        wi = torch.from_numpy(rng.integers(10, 500, c).astype(np.float32)).to(dev)
        mean = ops.fedavg_reduce(u, wi)
        summed = ops.fedavg_reduce(u, wi, normalize=False)
        old_mean = fedavg_one_launch(u, wi)
        check(f"fedavg_reduce bitwise the composition it replaced, integer weights, normalize "
              f"True and False [{label}]",
              torch.equal(mean, old_mean)
              and torch.equal(summed, ops._denormalize(old_mean, wi))
              and torch.equal(summed, fedavg_one_launch(u, wi, normalize=False))
              and torch.equal(summed, ops._denormalize(mean, wi)),
              mean_differing=int((mean != old_mean).sum()),
              summed_differing=int((summed != ops._denormalize(old_mean, wi)).sum()))
        if label.startswith("ragged") or label == "C=64, bf16":
            continue
        wf, outo = w.contiguous(), torch.empty_like(out)
        wn_lib = (w / w.sum()).to(dtype)
        entry = "repro_fedavg_reduce_f32" if dtype == f32 else "repro_fedavg_reduce_bf16"
        moved = nbytes(u, w, out)
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        b_ms, b_by = bound(moved, 2 * u.numel())
        plain = {True: lambda: ref.fedavg_reduce(u, w),
                 # the CPU route's composition, on the card
                 False: lambda: ops._denormalize(ref.fedavg_reduce(u, w), w)}
        for normalize in (True, False):
            timing = dict(
                source="src/repro_torch/kernels/csrc/fedavg_reduce.cu",
                replaces="src/repro/kernels/fedavg_reduce.py:56",
                max_abs_err=err,
                ms=time_ms(lambda: ops.fedavg_reduce(u, w, normalize=normalize)),
                launch_ms=time_ms(launch("fedavg_reduce", entry, "fedavg_reduce",
                                         u.data_ptr(), wf.data_ptr(), outo.data_ptr(), c, n,
                                         int(normalize))),
                plain_ms=time_ms(plain[normalize]),
                # the yardstick: one library call (cuBLAS gemv) on the same inputs
                library_ms=time_ms(lambda: wn_lib @ u),
                bound_ms=b_ms, bound_by=b_by,
                # a device copy moving the same bytes (the floor of this timing)
                copy_ms=time_ms(lambda: dst.copy_(src)),
                shape=f"u ({c}, {n}) {dtype}" + ("" if normalize else ", normalize=False"),
                bytes=moved,
            )
            if label == "main" and normalize:
                row = timing
            else:
                case = label if normalize else f"{label}, normalize=False"
                REPORT["timings"].append({"name": "fedavg_reduce", "case": case, **timing})
        del src, dst
    return row


def fedbuff_weight_checks(dev) -> None:
    """The Null and Int8 reduces with FedBuff's staleness weights, n / (1 +
    s) ** 0.5 for s = 0-4 (``FedBuffStrategy._fit_weights``): the first
    non-integer weights on Server.run's path, where the weight sum the
    launch forms in client order and PyTorch's may round apart.  Stated
    before the first run: both forms within 4C units of 2**-24 * sum_c
    |w_c x_c| (over sum w for the mean) of the plain version, the
    first-order rounding budget of two such reduces
    (``tests/torch_kernel_models.py``'s ``reduce_error_units``).  fedavg at
    C = 2 and 64 over N, dequant_reduce at C = 6 and 64 over Np."""
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_kernel_models import fedbuff_weights, reduce_error_units

    rng = np.random.default_rng(23)
    for name, c in (("fedavg_reduce", 2), ("fedavg_reduce", 64), ("dequant_reduce", 6),
                    ("dequant_reduce", 64)):
        w = fedbuff_weights(rng.integers(10, 500, c)).to(dev)
        if name == "fedavg_reduce":
            x = delta_like(rng, (c, N_PARAMS))
            run = lambda normalize: ops.fedavg_reduce(x, w, normalize=normalize)
            plain = ref.fedavg_reduce(x, w)
        else:
            qr, sr = ref.quantize_int8(delta_like(rng, (c, NP_MAIN)).reshape(-1))
            q, s = qr.reshape(c, NP_MAIN), sr.reshape(c, NP_MAIN // BLOCK)
            x = ref.dequantize_int8(qr, sr).reshape(c, NP_MAIN)
            run = lambda normalize: ops.dequant_reduce(q, s, w, normalize=normalize)
            plain = ref.dequant_reduce(q, s, w)
        for normalize in (True, False):
            want = plain if normalize else ops._denormalize(plain, w)
            units = reduce_error_units(run(normalize), want, x, w, normalize=normalize)
            check(f"{name} with FedBuff weights within 4C = {4 * c} units of the plain version "
                  f"[C={c}, normalize={normalize}]", units <= 4 * c, units=units,
                  weights=w[:5].tolist())
        del x


# the head model's leaves padded to 256 (base.w, head.b1, head.b2, head.w1,
# head.w2), then the padded total Np
COLLECTIVE_SIZES = (1_638_400, 256, 256, 327_680, 7_936, 1_974_528)
# the single-vector pack and unpack (the TPU kernels' counterparts, the
# parent's per-leaf path) are timed at every leaf size and at Np
COLLECTIVE_TIMED = {1_638_400: "base.w", 256: "head.b1, head.b2", 327_680: "head.w1",
                    7_936: "head.w2", 1_974_528: "Np, single vector"}


def collective_edge_values(rng, n: int, dev):
    """x and power-of-two scales (so (k + 1/2) * s is exact): half-way
    points, zeros, +-127 s, values past it, NaN and inf, and one block zero
    with scale 1."""
    nb = n // BLOCK
    s = (2.0 ** rng.integers(-14, 0, nb)).astype(np.float32)
    k = rng.integers(-140, 140, (nb, BLOCK)) + np.where(rng.random((nb, BLOCK)) < 0.5, 0.5, 0.0)
    x = (k * s[:, None]).astype(np.float32)
    x[:, :8] = np.asarray([0.0, -0.0, 127.0, -127.0, 127.5, -128.5, np.nan, np.inf],
                          np.float32) * s[:, None]
    if nb > 1:
        x[-1], s[-1] = 0.0, 1.0
    return torch.from_numpy(x.reshape(-1)).to(dev), torch.from_numpy(s).to(dev)


def collective_kernel_checks(dev, launch) -> None:
    """The single-vector collective_pack / collective_unpack against their
    plain versions at every head-model leaf size and at Np: bitwise on edge
    values, on four ranks' update-like values against their shared scales,
    and on the int32 sum of the four; the sum exact to one fp32 rounding;
    timed at every leaf size and at Np (REPORT["timings"])."""
    from repro_torch.kernels import collective_quant, ops, ref

    rng = np.random.default_rng(14)
    to_time = dict(COLLECTIVE_TIMED)
    for n in COLLECTIVE_SIZES:
        x, s = collective_edge_values(rng, n, dev)
        q = ops.collective_pack(x, s)
        check(f"collective_pack bitwise on half-way points, zeros, +-127 s, NaN, inf [N={n}]",
              torch.equal(q, ref.collective_pack(x, s)),
              codes_differing=int((q != ref.collective_pack(x, s)).sum()))
        check(f"collective_unpack bitwise on those codes [N={n}]",
              torch.equal(ops.collective_unpack(q, s), ref.collective_unpack(q, s)))
        xs = delta_like(rng, (4, n), dev)
        am = xs.abs().reshape(4, -1, BLOCK).amax(dim=(0, 2))  # the MAX all-reduce
        s = torch.where(am == 0, torch.ones_like(am), am / torch.full_like(am, 127.0))
        qs = [ops.collective_pack(x, s) for x in xs]
        pack_err = max(int((q - ref.collective_pack(x, s)).abs().max()) for x, q in zip(xs, qs))
        check(f"collective_pack bitwise on 4 ranks' values, shared scales [N={n}]",
              pack_err == 0, max_abs_err=pack_err)
        one = ops.collective_unpack(qs[0], s)
        total = sum(qs)
        summed = ops.collective_unpack(total, s)
        unpack_err = max(float((one - ref.collective_unpack(qs[0], s)).abs().max()),
                         float((summed - ref.collective_unpack(total, s)).abs().max()))
        check(f"collective_unpack bitwise on one pack and on the int32 sum of 4 [N={n}]",
              unpack_err == 0.0, max_abs_err=unpack_err)
        each = sum(ref.collective_unpack(q, s) for q in qs)
        # exactly summable: the int32 sum loses nothing, so unpack(sum) and
        # sum(unpack) differ only by fp32 roundings: one of the total, and
        # of the 4 products and 3 additions, each under 2**-24 x 4 x 127 s
        sum_err = float(((summed - each).abs() / s.repeat_interleave(BLOCK)).max())
        check(f"collective: unpack(sum of packs) = sum of unpacks within fp32 rounding [N={n}]",
              sum_err <= 8 * 4 * 127 * 2.0 ** -24, max_err_in_scales=sum_err)
        leaf = to_time.pop(n, None)  # 256 stands twice: timed once
        if leaf is None:
            continue
        lib = torch.mul(total.view(-1, BLOCK), s[:, None]).reshape(-1)
        check(f"collective_unpack's library call (q.view(-1, 256) * s[:, None]) bitwise [N={n}]",
              torch.equal(lib, ref.collective_unpack(total, s)))
        x = xs[0]
        qo, xo = torch.empty_like(q), torch.empty_like(one)
        table, _ = collective_quant._table([x], None)  # x its one leaf, no fold
        b_ms, b_by = bound(nbytes(x, s, qs[0]), 3 * n)
        pack = dict(
            source="src/repro_torch/kernels/csrc/collective_quant.cu",
            replaces="src/repro/kernels/collective_quant.py:57",
            max_abs_err=float(pack_err),
            ms=time_ms(lambda: ops.collective_pack(x, s)),
            launch_ms=time_ms(launch("collective_quant", "repro_collective_pack",
                                     "collective_pack", table, 1, None, None, s.data_ptr(), 0,
                                     qo.data_ptr(), None, None, n // BLOCK)),
            plain_ms=time_ms(lambda: ref.collective_pack(x, s)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"x ({n},) fp32 ({leaf})", bytes=nbytes(x, s, qs[0]),
        )
        b_ms, b_by = bound(nbytes(total, s, summed), n)
        unpack = dict(
            source="src/repro_torch/kernels/csrc/collective_quant.cu",
            replaces="src/repro/kernels/collective_quant.py:85",
            max_abs_err=unpack_err,
            ms=time_ms(lambda: ops.collective_unpack(total, s)),
            launch_ms=time_ms(launch("collective_quant", "repro_collective_unpack",
                                     "collective_unpack", total.data_ptr(), s.data_ptr(),
                                     xo.data_ptr(), n // BLOCK)),
            plain_ms=time_ms(lambda: ref.collective_unpack(total, s)),
            bound_ms=b_ms, bound_by=b_by,
            # one PyTorch call computes it: the int32 -> fp32 promotion and
            # one rounded product per element, bitwise the plain version
            library_ms=time_ms(lambda: torch.mul(total.view(-1, BLOCK), s[:, None])),
            shape=f"q ({n},) int32 ({leaf})", bytes=nbytes(total, s, summed),
        )
        REPORT["timings"] += [{"name": "collective_pack", "case": leaf, **pack},
                              {"name": "collective_unpack", "case": leaf, **unpack}]


# the head model's leaves in JAX's order, as the mesh round step hands them
# to CompressedPsum.psum_leaves
HEAD_LEAVES = (("base.w", 1_638_400), ("head.b1", 256), ("head.b2", 31),
               ("head.w1", 327_680), ("head.w2", 7_936))
LEAF_CASES = ("edges", "deltas", "live", "masked")


def collective_leaf_inputs(rng, dev, case: str):
    """The head model's five leaves as the mesh round step gives them to
    ``psum_leaves``: views of one flat (N,) decode at JAX's leaf offsets
    (head.w1 and head.w2 start 12 bytes past a 16-byte boundary), the
    residual rows views of one flat (Np,) buffer at their first blocks
    (the previous round's), the weight (one fp32) and the live flag.
    "edges": weight 1/2, zero residuals and d = 2 eff exactly, where each
    block of eff holds 127 s (its absmax, so the derived scale is s, a
    power of two), +-0, -127 s and half-way points (k + 1/2) s; base.w's
    block 3 holds a NaN, block 5 an inf, block 7 zeros (scale 1).
    "deltas": update-like values and residuals, weight 123, no mask;
    "live": the same with live True; "masked": live False, weight 0 (the
    round step folds the mask into it)."""
    from repro_torch.kernels.collective_quant import first_blocks

    sizes = [n for _, n in HEAD_LEAVES]
    if case == "edges":
        parts = []
        for n in sizes:
            nb = -(-n // BLOCK)
            s = 2.0 ** rng.integers(-14, 0, (nb, 1))
            k = rng.integers(-126, 127, (nb, BLOCK)) + np.where(rng.random((nb, BLOCK)) < 0.5,
                                                                  0.5, 0.0)
            k[:, :4] = [127.0, 0.0, -0.0, -127.0]
            parts.append((k * s).astype(np.float32).reshape(-1)[:n])
        eff = np.concatenate(parts)
        eff[3 * BLOCK + 9], eff[5 * BLOCK + 9] = np.nan, np.inf
        eff[7 * BLOCK:8 * BLOCK] = 0.0
        flat = torch.from_numpy(2 * eff).to(dev)
        r_flat = torch.zeros(NP_MAIN, device=dev)
        wf = torch.full((1,), 0.5, device=dev)
    else:
        flat = delta_like(rng, (sum(sizes),), dev)
        r_flat = delta_like(rng, (NP_MAIN,), dev) * 1e-3
        wf = torch.full((1,), 0.0 if case == "masked" else 123.0, device=dev)
    ds = list(torch.split(flat, sizes))
    rs = [r_flat[BLOCK * b:BLOCK * b + n] for b, n in zip(first_blocks(sizes), sizes)]
    live = {"live": True, "masked": False}.get(case)
    return ds, wf, rs, None if live is None else torch.tensor(live, device=dev)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, a NaN matching any NaN (the card makes its own NaN bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


def collective_leaf_checks(dev, launch) -> dict:
    """The int8 collective's leaf-table trio (collective_absmax,
    collective_pack over every leaf, collective_unpack at Np) at the head
    model's five leaves, bitwise (NaN as NaN) against its plain versions
    and against the per-leaf composition it replaced (the parent's psum
    code, leaf by leaf) with the plain single-vector versions and with
    this tree's single-vector kernels, in every case of LEAF_CASES; the
    build's registers, spills and stack frames; each part timed at Np
    beside its bound, and the trio against that composition in turns
    (composition, trio, trio, composition)."""
    from repro_torch.kernels import collective_quant, ops, ref

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_kernel_models import collective_per_leaf

    ptxas = ptxas_report("collective_quant", lambda line: next(
        (k for k in ("collective_absmax_kernel", "collective_pack_kernel",
                     "collective_unpack_kernel") if k in line), None))
    check("ptxas reports the three collective kernels, no spill and no stack frame in any "
          "(the leaf table read in place)", len(ptxas) == 3 and no_spill(ptxas) and all(
              v.get("stack_frame") == 0 for v in ptxas.values()), kernels=ptxas)
    sizes = [n for _, n in HEAD_LEAVES]
    starts = collective_quant.first_blocks(sizes)
    rng = np.random.default_rng(22)
    for case in LEAF_CASES:
        ds, wf, rs, lv = collective_leaf_inputs(rng, dev, case)
        absmax = ops.collective_absmax(ds, wf, rs, lv)
        q, s, new = ops.collective_pack_leaves(ds, wf, rs, absmax, lv)
        total = ops.collective_unpack(q, s)
        plain = ref.collective_pack_leaves(ds, wf, rs, absmax, lv)
        check(f"collective leaf table [{case}]: absmax, codes, scales, residuals and totals "
              "bitwise their plain versions",
              same_bits(absmax, ref.collective_absmax(ds, wf, rs, lv))
              and torch.equal(q, plain[0]) and same_bits(s, plain[1])
              and same_bits(new, plain[2]) and same_bits(total, ref.collective_unpack(q, s)),
              codes_differing=int((q != plain[0]).sum()))
        for label, pack, unpack in (
                ("the plain single-vector versions", ref.collective_pack, ref.collective_unpack),
                ("the single-vector kernels", ops.collective_pack, ops.collective_unpack)):
            per_leaf = collective_per_leaf(ds, wf, rs, lv, pack, unpack)
            ok = all(
                same_bits(absmax[a:b], am) and same_bits(s[a:b], sc)
                and torch.equal(q[BLOCK * a:BLOCK * b], code)
                and same_bits(total[BLOCK * a:BLOCK * a + n], tot)
                and same_bits(new[BLOCK * a:BLOCK * a + n], row)
                for (am, sc, code, tot, row), a, b, n in zip(per_leaf, starts, starts[1:], sizes))
            check(f"collective leaf table [{case}]: bitwise the per-leaf composition (each "
                  f"leaf's psum) with {label}", ok)
        if case == "edges":
            check("collective leaf table [edges]: NaN block NaN scale, inf block inf, zero "
                  "block 1, the others their power of two",
                  bool(torch.isnan(s[3])) and bool(torch.isinf(s[5])) and float(s[7]) == 1.0,
                  scales=[float(x) for x in s[:8]])
        if case == "masked":
            check("collective leaf table [masked]: zero codes, every residual row carried",
                  not q.any() and all(torch.equal(new[BLOCK * a:BLOCK * a + n], r)
                                      for a, n, r in zip(starts, sizes, rs)))

    # timing at the main path's call: update-like leaves, no mask
    ds, wf, rs, lv = collective_leaf_inputs(rng, dev, "deltas")
    absmax = ops.collective_absmax(ds, wf, rs, lv)
    q, s, new = ops.collective_pack_leaves(ds, wf, rs, absmax, lv)
    total = ops.collective_unpack(q, s)
    table, n_blocks = collective_quant._table(ds, rs)
    am_o, q_o, s_o, r_o, t_o = (torch.empty_like(t) for t in (absmax, q, s, new, total))
    shape = "the head model's 5 leaves (N = 1,974,303, Np = 1,974,528, Nb = 7,713)"
    rows = {}
    b_ms, b_by = bound(nbytes(*ds, *rs, wf, absmax), 3 * N_PARAMS)
    rows["collective_absmax"] = dict(
        source="src/repro_torch/kernels/csrc/collective_quant.cu",
        replaces="src/repro/core/compression.py:1285",
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.collective_absmax(ds, wf, rs, lv)),
        launch_ms=time_ms(launch("collective_quant", "repro_collective_absmax",
                                 "collective_absmax", table, len(ds), wf.data_ptr(), None,
                                 am_o.data_ptr(), n_blocks)),
        plain_ms=time_ms(lambda: ref.collective_absmax(ds, wf, rs, lv)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"eff of {shape}", bytes=nbytes(*ds, *rs, wf, absmax),
    )
    b_ms, b_by = bound(nbytes(*ds, *rs, wf, absmax, q, s, new), 8 * N_PARAMS)
    rows["collective_pack"] = dict(
        source="src/repro_torch/kernels/csrc/collective_quant.cu",
        replaces="src/repro/kernels/collective_quant.py:57",
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.collective_pack_leaves(ds, wf, rs, absmax, lv)),
        launch_ms=time_ms(launch("collective_quant", "repro_collective_pack", "collective_pack",
                                 table, len(ds), wf.data_ptr(), None, absmax.data_ptr(), 1,
                                 q_o.data_ptr(), s_o.data_ptr(), r_o.data_ptr(), n_blocks)),
        plain_ms=time_ms(lambda: ref.collective_pack_leaves(ds, wf, rs, absmax, lv)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"codes and residuals of {shape}", bytes=nbytes(*ds, *rs, wf, absmax, q, s, new),
    )
    b_ms, b_by = bound(nbytes(q, s, total), NP_MAIN)
    rows["collective_unpack"] = dict(
        source="src/repro_torch/kernels/csrc/collective_quant.cu",
        replaces="src/repro/kernels/collective_quant.py:85",
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.collective_unpack(q, s)),
        launch_ms=time_ms(launch("collective_quant", "repro_collective_unpack",
                                 "collective_unpack", q.data_ptr(), s.data_ptr(), t_o.data_ptr(),
                                 n_blocks)),
        plain_ms=time_ms(lambda: ref.collective_unpack(q, s)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.mul(q.view(-1, BLOCK), s[:, None])),
        shape=f"totals of {shape}", bytes=nbytes(q, s, total),
    )
    for name, r in rows.items():
        r["ptxas"] = ptxas[f"{name}_kernel"]

    def trio():
        a = ops.collective_absmax(ds, wf, rs, lv)
        codes, scales, _ = ops.collective_pack_leaves(ds, wf, rs, a, lv)
        return ops.collective_unpack(codes, scales)

    def composition():
        return collective_per_leaf(ds, wf, rs, lv, ops.collective_pack, ops.collective_unpack)

    turns = [time_ms(composition), time_ms(trio), time_ms(trio), time_ms(composition)]
    REPORT["collective_in_turns"] = {"per_leaf_composition_ms": [turns[0], turns[3]],
                                     "trio_ms": [turns[1], turns[2]]}
    print(f"collective at the head model's 5 leaves, in turns: the per-leaf composition (the "
          f"parent's psum code, this tree's single-vector kernels) {turns[0] * 1e3:.2f} / "
          f"{turns[3] * 1e3:.2f} us, the leaf-table trio {turns[1] * 1e3:.2f} / "
          f"{turns[2] * 1e3:.2f} us; bound of the trio "
          f"{sum(r['bound_ms'] for r in rows.values()) * 1e3:.2f} us", flush=True)
    return rows


TOPK_K = 19_743               # TopKCodec(frac=0.01).k_of(N_PARAMS)


# ---------------- phase 8's kernels: flash and decode attention ----------------
# qwen3-0.6b's serving shape: B=8, prompt 1024, context 2048, H=16, KV=8, D=128
SERVE_B, SERVE_PROMPT, SERVE_CONTEXT, SERVE_TOKENS = 8, 1024, 2048, 32
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def attention_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """The (query, key) pairs that attend: the work these inputs need."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def decode_slots(valid: torch.Tensor) -> int:
    """The (batch row, cache slot) pairs whose K and V the decode function
    needs: the valid slots, or every slot of a row with none valid (its
    output is the uniform mean over them)."""
    per_row = valid.sum(1)
    return int(torch.where(per_row > 0, per_row, valid.shape[1]).sum())


def flash_build_checks() -> dict:
    """The built flash library: its SASS holds HGMMA (the bf16 route runs
    on the tensor cores; a missing cuobjdump fails the check), and ptxas'
    registers and spills for each flash kernel, none in the wgmma ones."""
    import os
    import re
    import shutil

    from repro_torch.kernels import _cuda

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check("cuobjdump is there to read the flash library's SASS", os.path.exists(tool),
          path=tool)
    sass = subprocess.run([tool, "-sass", str(_cuda.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    n_hgmma = sass.count("HGMMA")
    print(f"flash_attention SASS: {n_hgmma} HGMMA instructions", flush=True)
    check("the flash library's SASS holds HGMMA", n_hgmma > 0, hgmma=n_hgmma)

    def name_of(line):
        entry = re.search(r"Compiling entry function '\S*?(flash_attention_kernel\w*?)I(\w*?)Li"
                          r"(\d+)E", line)
        if entry:
            kind, dtype, dp = entry.groups()
            return f"{kind}<{'float, ' if dtype == 'f' else ''}{dp}>"
        return None

    ptxas = ptxas_report("flash_attention", name_of)
    wgmma = {k: v for k, v in ptxas.items() if "wgmma" in k}
    check("ptxas reports every flash kernel, and no spill in the wgmma ones",
          len(ptxas) == 6 and len(wgmma) == 3 and no_spill(wgmma), kernels=ptxas)
    return {"hgmma": n_hgmma, "ptxas": ptxas}


def attention_kernel_checks(dev, launch) -> dict:
    """flash_attention and decode_attention against their plain versions
    (``kernels/ref.py``) on the card, within 2e-5 (fp32) / 2e-2 (bf16):
    the serving shapes in bf16; fp32 (the CUDA-core route) and bf16 (the
    wgmma route) at D = 32, 64, 128, 256; a window, a q_offset, ragged Sq =
    1000 and 17, Skv not a multiple of the key tile, not causal, rows with
    no valid key, a bf16 item that walks every key tile with rows with and
    without a valid key (D = 128 and 256); decode with the linear mask, a
    random mask, ring arcs (whole tiles invalid before, between and after
    the valid slots), at the Jamba slice's 64 heads, at position 0 (every
    split but one empty), at S = 1 and 16,384, in one split (rounds of 64
    tiles), an all-invalid row (also in more splits than tiles), fp32, D =
    256 and G = 4, every decode case twice and bitwise.  The serving shapes,
    the Jamba slice's flash and decode shapes (64 query heads), phase 14's
    (H = KV = 32 at D = 80, H = KV = 16, 32 over 8) and phase 15's (MLA's
    qk width 96 with V zero-padded from 64, its padded columns exact zeros
    and the kept ones against SDPA on the unpadded V; 8 heads over 1 at D =
    256 over 1280 positions and in decode; H = KV = 24 at D = 64 over 1088)
    are checked and timed: through the ops wrapper, as a bare launch, the
    plain version and scaled_dot_product_attention (never on the port's
    path), and so is the fp32 flash route at the serving shape; decode also
    at 4 CTAs an SM.
    Then the flash library's SASS and ptxas report
    (``flash_build_checks``)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def agree(name, out, exp, dtype):
        tol = ATTN_TOL[dtype]
        err = float((out.float() - exp.float()).abs().max())
        check(f"{name} within rtol=atol={tol} of its plain version", out.dtype == dtype
              and out.shape == exp.shape and bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), exp.float(), rtol=tol, atol=tol),
              max_abs_err=err)
        return err

    bf16, f32 = torch.bfloat16, torch.float32
    bf16_peak = bf16_flop_per_s()
    print(f"bf16 tensor-core peak at the card's maximum SM clock: {bf16_peak / 1e12:.1f} "
          f"TFLOP/s", flush=True)
    flash_cases = [  # label, B, Sq, Skv, H, KV, D, dtype, window, q_offset, causal
        ("main", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 16, 8, 128, bf16, None, 0, True),
        ("fp32 D=32", 2, 256, 256, 4, 2, 32, f32, None, 0, True),
        ("fp32 D=64", 2, 256, 256, 4, 2, 64, f32, None, 0, True),
        ("fp32 D=128", 2, 256, 256, 4, 2, 128, f32, None, 0, True),
        ("fp32 D=256", 2, 256, 256, 4, 2, 256, f32, None, 0, True),
        ("window 128", 2, 512, 512, 8, 2, 64, bf16, 128, 0, True),
        ("fp32 window 100, D=40", 1, 300, 300, 6, 3, 40, f32, 100, 0, True),
        ("q_offset 256", 2, 128, 384, 8, 4, 128, f32, None, 256, True),
        ("ragged Sq=1000", 2, 1000, 1000, 16, 8, 128, bf16, None, 0, True),
        ("ragged Sq=17", 2, 17, 17, 16, 8, 128, f32, None, 0, True),
        ("ragged Sq=17 at q_offset 128", 2, 17, 145, 16, 8, 128, bf16, 64, 128, True),
        ("not causal", 1, 65, 130, 4, 4, 64, f32, None, 0, False),
        ("rows with no valid key", 1, 8, 8, 2, 1, 32, f32, 3, 20, True),
        # the bf16 route (wgmma): D_pad 64 / 128 / 256, key tiles of 128 (32 at 256)
        ("bf16 D=32", 2, 256, 256, 4, 2, 32, bf16, None, 0, True),
        ("bf16 D=64", 2, 256, 256, 4, 2, 64, bf16, None, 0, True),
        ("bf16 D=256", 2, 256, 256, 4, 2, 256, bf16, None, 0, True),
        ("bf16 not causal", 1, 65, 130, 4, 4, 64, bf16, None, 0, False),
        ("bf16 q_offset 256", 2, 128, 384, 8, 4, 128, bf16, None, 256, True),
        ("bf16 rows with no valid key", 1, 8, 8, 2, 1, 32, bf16, 3, 20, True),
        ("bf16 Skv=333, not a multiple of the key tile", 2, 200, 333, 8, 2, 128, bf16, None,
         133, True),
        ("bf16 D=256, Skv=77, not causal", 1, 100, 77, 4, 1, 256, bf16, None, 0, False),
        # the first item walks every key tile; its rows from 115 on have no valid key
        ("bf16 item mixing rows with and without a valid key, 3 key tiles", 2, 256, 300, 4,
         2, 128, bf16, 16, 200, True),
        ("bf16 item mixing rows with and without a valid key, D=256, 10 key tiles", 2, 256,
         300, 4, 2, 256, bf16, 16, 200, True),
    ]
    for label, b, sq, skv, h, kv, d, dtype, window, q_off, causal in flash_cases:
        q, k, v = randn(b, sq, h, d, dtype=dtype), randn(b, skv, kv, d, dtype=dtype), \
            randn(b, skv, kv, d, dtype=dtype)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out, exp = ops.flash_attention(q, k, v, **kw), ref.attention(q, k, v, **kw)
        err = agree(f"flash_attention [{label}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                    f"{dtype}, window {window}, q_offset {q_off}, causal {causal}]",
                    out, exp, dtype)
        if label != "main":
            continue
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        check("flash_attention's library call (scaled_dot_product_attention, causal, GQA) "
              "within 2e-2 of the plain version [main]",
              torch.allclose(sdpa.float(), exp.float(), rtol=2e-2, atol=2e-2),
              max_abs_err=float((sdpa.float() - exp.float()).abs().max()))
        o = torch.empty_like(q)
        pairs = attention_pairs(sq, skv, causal, window, q_off)
        b_ms, b_by = bound(nbytes(q, k, v, out), 4 * b * h * d * pairs, bf16_peak)
        rows["flash_attention"] = dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:102",
            max_abs_err=err,
            ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            launch_ms=time_ms(launch(
                "flash_attention", "repro_flash_attention_bf16", "flash_attention",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, sq, skv, h,
                kv, d, 1, -1, 0, float(d ** -0.5))),
            plain_ms=time_ms(lambda: ref.attention(q, k, v, **kw)),
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, flops=4 * b * h * d * pairs,
            peak_flop_per_s=bf16_peak,
            shape=f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {skv}, {kv}, {d}) bf16 causal",
            bytes=nbytes(q, k, v, out),
        )

    # on lines of their own: the Jamba slice's attention layer (64 query heads
    # over 8 KV heads), phase 14's (stablelm-3b: MHA at D = 80, which the
    # wgmma route pads to 128; deepseek-moe-16b: MHA; granite-8b and
    # mixtral-8x7b: GQA 32/8), phase 15's (minicpm3-4b's MLA prefill: qk
    # width 96, V zero-padded from 64 to 96, over its 1024 positions;
    # paligemma-3b: 8 heads over 1 at D = 256, 256 frontend positions before
    # the 1024; musicgen-medium: MHA 24 x 64, 64 frontend positions), and
    # the fp32 route (the CUDA-core kernel) at the serving shape beside its
    # bound at the fp32 rate outside the tensor cores
    wgmma = ("repro_flash_attention_bf16", bf16_peak)
    for case, h, kv, d, dtype, (entry, peak), sq, dv in (
            ("Jamba head shape", 64, 8, 128, bf16, wgmma, SERVE_PROMPT, None),
            ("stablelm-3b head shape, D=80", 32, 32, 80, bf16, wgmma, SERVE_PROMPT, None),
            ("deepseek-moe-16b head shape", 16, 16, 128, bf16, wgmma, SERVE_PROMPT, None),
            ("granite-8b / mixtral-8x7b head shape", 32, 8, 128, bf16, wgmma, SERVE_PROMPT,
             None),
            ("minicpm3-4b MLA head shape, D=96, V zero-padded from 64", 40, 40, 96, bf16, wgmma,
             SERVE_PROMPT, 64),
            ("paligemma-3b head shape, D=256, G=8", 8, 1, 256, bf16, wgmma, SERVE_PROMPT + 256,
             None),
            ("musicgen-medium head shape", 24, 24, 64, bf16, wgmma, SERVE_PROMPT + 64, None),
            ("fp32 route, serving shape", 16, 8, 128, f32,
             ("repro_flash_attention_f32", FP32_FLOP_PER_S), SERVE_PROMPT, None)):
        b = SERVE_B
        q, k = randn(b, sq, h, d, dtype=dtype), randn(b, sq, kv, d, dtype=dtype)
        v_in = randn(b, sq, kv, dv or d, dtype=dtype)
        # MLA's call: V padded with zero columns to the qk width (mla_forward)
        v = torch.nn.functional.pad(v_in, (0, d - dv)) if dv else v_in
        out, exp = ops.flash_attention(q, k, v), ref.attention(q, k, v)
        err = agree(f"flash_attention [{case}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                    f"v {tuple(v.shape)}, {dtype}, causal]", out, exp, dtype)
        # the library call computes the layer's own function: SDPA takes a V
        # narrower than Q and K, scaling by Q's width as MLA does
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v_in.transpose(1, 2)
        o = torch.empty_like(q)
        pairs = attention_pairs(sq, sq, True, None, 0)
        flops = 4 * b * h * d * pairs
        b_ms, b_by = bound(nbytes(q, k, v, out), flops, peak)
        extra = {}
        if dv:
            check(f"flash_attention [{case}]: the padded V's output columns are exact zeros",
                  not bool(out[..., dv:].any()))
            sdpa = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True).transpose(1, 2)
            # what the unpadded function needs: V and the output at dv, P . V over dv
            mla_flops = 2 * b * h * (d + dv) * pairs
            mla_bytes = nbytes(q, k, v_in) + out[..., :dv].numel() * out.element_size()
            m_ms, m_by = bound(mla_bytes, mla_flops, peak)
            extra = dict(
                unpadded_bound_ms=m_ms, unpadded_bound_by=m_by, unpadded_flops=mla_flops,
                unpadded_bytes=mla_bytes, v_bytes_padded_over_unpadded=d / dv,
                pv_flops_padded_over_unpadded=d / dv,
                library_max_abs_err=float((sdpa.float() - out[..., :dv].float()).abs().max()))
            check(f"flash_attention [{case}]: the kept columns within rtol=atol=2e-2 of "
                  "scaled_dot_product_attention on the unpadded V",
                  torch.allclose(sdpa.float(), out[..., :dv].float(), rtol=2e-2, atol=2e-2),
                  **extra)
            del sdpa
        REPORT["timings"].append(dict(
            name="flash_attention", case=case, max_abs_err=err, **extra,
            ms=time_ms(lambda: ops.flash_attention(q, k, v)),
            launch_ms=time_ms(launch(
                "flash_attention", entry, "flash_attention", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), None, b, sq, sq, h, kv, d, 1, -1, 0,
                float(d ** -0.5))),
            plain_ms=time_ms(lambda: ref.attention(q, k, v), iters=5),
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, flops=flops, peak_flop_per_s=peak,
            bytes=nbytes(q, k, v, out),
            shape=f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {sq}, {kv}, {d}) {dtype} causal"
                  + (f", V zero-padded from {dv}" if dv else ""),
        ))
        del q, k, v, v_in, o, out, exp, qt, kt, vt
    rows["flash_build"] = flash_build_checks()

    from repro_torch.kernels import decode_attention as dk

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def decode_launch(q, kc, vc, valid):
        """The bare decode launch (split kernel and combine) at the
        wrapper's default split count."""
        b, h, d = q.shape
        sl, kv = kc.shape[1], kc.shape[2]
        d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
        tiles = -(-sl // dk.tile_slots(d_pad, q.element_size()))
        splits = dk.default_splits(b, kv, tiles, sms)
        o = torch.empty_like(q)
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=dev)
        entry = "repro_decode_attention_bf16" if q.dtype == bf16 else "repro_decode_attention_f32"
        fn = launch("decode_attention", entry, "decode_attention", q.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), valid.data_ptr(), o.data_ptr(), ws.data_ptr(), b, sl, h, kv,
                    d, splits, ws.numel(), float(d ** -0.5))
        return fn, splits

    s = SERVE_CONTEXT
    decode_cases = [  # label, B, S, H, KV, D, dtype, mask, splits (None: the wrapper's)
        ("main", SERVE_B, s, 16, 8, 128, bf16, "linear", None),
        ("Jamba head shape", SERVE_B, s, 64, 8, 128, bf16, "linear", None),
        ("random mask", SERVE_B, s, 16, 8, 128, bf16, "random", None),
        ("ring arcs", SERVE_B, s, 16, 8, 128, bf16, "arcs", None),
        ("linear mask at position 0: most splits empty", SERVE_B, s, 16, 8, 128, bf16, "first",
         None),
        ("S=1", SERVE_B, 1, 16, 8, 128, bf16, "linear", None),
        ("S=16384", SERVE_B, 16384, 16, 8, 128, bf16, "linear", None),
        ("S=16384 in one split: 3 rounds of 64 tiles", SERVE_B, 16384, 16, 8, 128, bf16,
         "linear", 1),
        ("fp32 D=64, G=4, ring arcs, ragged S", 3, 1000, 8, 2, 64, f32, "arcs", None),
        ("fp32", SERVE_B, s, 16, 8, 128, f32, "random", None),
        ("fp32 D=256", 2, 300, 8, 4, 256, f32, "random", None),
        ("fp32 D=64, G=4, ragged S", 2, 1000, 8, 2, 64, f32, "linear", None),
        ("an all-invalid row", 2, 256, 4, 2, 128, f32, "none", None),
        ("an all-invalid row, more splits than tiles", 2, 256, 4, 2, 128, f32, "none", 16),
        ("stablelm-3b head shape, D=80", SERVE_B, s, 32, 32, 80, bf16, "linear", None),
        ("deepseek-moe-16b head shape", SERVE_B, s, 16, 16, 128, bf16, "linear", None),
        ("granite-8b / mixtral-8x7b head shape", SERVE_B, s, 32, 8, 128, bf16, "linear", None),
        ("paligemma-3b head shape, D=256, G=8", SERVE_B, s, 8, 1, 256, bf16, "linear", None),
        ("musicgen-medium head shape", SERVE_B, s, 24, 24, 64, bf16, "linear", None),
    ]
    for label, b, sl, h, kv, d, dtype, mask, splits in decode_cases:
        q, kc, vc = randn(b, h, d, dtype=dtype), randn(b, sl, kv, d, dtype=dtype), \
            randn(b, sl, kv, d, dtype=dtype)
        pos = SERVE_PROMPT + SERVE_TOKENS // 2 if sl == s else sl // 2
        if mask == "linear":
            valid = (torch.arange(sl, device=dev) <= pos)[None].expand(b, sl).contiguous()
        elif mask == "first":
            valid = (torch.arange(sl, device=dev) == 0)[None].expand(b, sl).contiguous()
        elif mask == "random":
            valid = torch.rand(b, sl, generator=gen, device=dev) > 0.25
            valid[:, 0] = True
        elif mask == "arcs":  # row i: a ring's window of sl // 3 slots ending at slot i * sl // b
            age = (torch.arange(b, device=dev)[:, None] * (sl // b)
                   - torch.arange(sl, device=dev)[None]) % sl
            valid = age < sl // 3
        else:
            valid = torch.rand(b, sl, generator=gen, device=dev) > 0.25
            valid[0] = False
        if splits is None:
            out = ops.decode_attention(q, kc, vc, kv_valid=valid)
            again = ops.decode_attention(q, kc, vc, kv_valid=valid)
        else:
            out = dk.decode_attention(q, kc, vc, kv_valid=valid, splits=splits)
            again = dk.decode_attention(q, kc, vc, kv_valid=valid, splits=splits)
        exp = ref.decode_attention(q, kc, vc, kv_valid=valid)
        err = agree(f"decode_attention [{label}: q {tuple(q.shape)}, cache {tuple(kc.shape)}, "
                    f"{dtype}, {mask} mask, splits {splits or 'default'}]", out, exp, dtype)
        check(f"decode_attention two launches bitwise equal [{label}]", torch.equal(out, again))
        if label != "main" and "head shape" not in label:
            continue
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        mask4 = valid[:, None, None, :]
        # the K and V of the valid slots only: the output does not depend on the rest
        slots = decode_slots(valid)
        need = nbytes(q, valid, out) + 2 * slots * kv * d * kc.element_size()
        b_ms, b_by = bound(need, 4 * h * d * slots, bf16_peak)
        bare, n_splits = decode_launch(q, kc, vc, valid)
        # beside the wrapper's one wave at 2 CTAs an SM: the grid sized for
        # 4 CTAs an SM (B*KV*splits >= 4 * SMs), which runs in two waves
        splits4 = -(-4 * sms // (b * kv))
        timing = dict(
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:83",
            max_abs_err=err,
            ms=time_ms(lambda: ops.decode_attention(q, kc, vc, kv_valid=valid)),
            launch_ms=time_ms(bare),
            plain_ms=time_ms(lambda: ref.decode_attention(q, kc, vc, kv_valid=valid)),
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask4, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, flops=4 * h * d * slots, splits=n_splits,
            splits_4_ctas_per_sm=splits4,
            ms_4_ctas_per_sm=time_ms(lambda: dk.decode_attention(q, kc, vc, kv_valid=valid,
                                                                 splits=splits4)),
            shape=f"q ({b}, {h}, {d}), caches ({b}, {sl}, {kv}, {d}) bf16, linear mask, "
                  f"{slots // b} of {sl} slots valid, {n_splits} splits",
            bytes=need,
        )
        if label == "main":
            rows["decode_attention"] = timing
        else:
            REPORT["timings"].append({"name": "decode_attention", "case": label, **timing})
        del qt, kt, vt, mask4
    return rows


# ---------------- phase 9's kernel: the mamba selective scan ----------------
# the Jamba slice's prefill: B=8, prompt 1024, d_inner 16384, d_state 16
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
MUFU_EX2_PER_CLOCK_PER_SM = 16   # Hopper: 4 SFUs in each of an SM's 4 partitions


def scan_bound(b: int, s: int, di: int, n: int, moved: int) -> dict:
    """The scan's least time: its bytes at 3.35 TB/s, its fp32 operations
    (6 a state element a step, 3 a channel a step) at 67 TFLOP/s, and its
    B*S*Di*N exponentials, one MUFU ex2 each, at 16 a clock per SM at the
    card's maximum SM clock; the largest binds."""
    clock = max_sm_clock_hz()
    flops = 6 * b * s * di * n + 3 * b * s * di
    exps = b * s * di * n
    t = {"bytes": moved / HBM_BYTES_PER_S, "flops": flops / FP32_FLOP_PER_S,
         "exps": exps / (MUFU_EX2_PER_CLOCK_PER_SM * H100_SMS * clock)}
    worst = max(t, key=t.get)
    return dict(bound_ms=t[worst] * 1e3, bound_by="bytes" if worst == "bytes" else "operations",
                bound_terms_us={k: v * 1e6 for k, v in t.items()}, flops=flops,
                exponentials=exps, sm_clock_hz=clock, bytes=moved)


def scan_build_checks() -> dict:
    """The built scan library: ptxas' registers and spills for each
    selective_scan kernel (no spill in any), and, from its SASS
    (cuobjdump), the instructions of the bf16 N_MAX = 16 kernel's inner
    loop -- of the innermost loops that hold a MUFU.EX2, the unrolled one
    with the most -- per state element a step (one ex2 each), by opcode."""
    import os
    import re
    import shutil

    from repro_torch.kernels import _cuda

    def name_of(line):
        entry = re.search(r"Compiling entry function '\S*?selective_scan_kernelI(f|13__nv_bfloat16)"
                          r"Li(\d+)E", line)
        if entry:
            return f"selective_scan_kernel<{'float' if entry[1] == 'f' else 'bf16'}, {entry[2]}>"
        return None

    ptxas = ptxas_report("selective_scan", name_of)
    check("ptxas reports every selective_scan kernel, and no spill in any",
          len(ptxas) == 8 and no_spill(ptxas), kernels=ptxas)

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check("cuobjdump is there to read the scan library's SASS", os.path.exists(tool), path=tool)
    sass = subprocess.run([tool, "-sass", str(_cuda.library_path("selective_scan"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if re.match(r"\S*selective_scan_kernelI13__nv_bfloat16Li16E", f))
    code = [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []  # (first, last address) of each back edge's loop that holds an ex2
    for addr, ins in code:
        m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", ins)
        if m and int(m[1], 16) <= addr and any(
                "MUFU.EX2" in i for a, i in code if int(m[1], 16) <= a <= addr):
            loops.append((int(m[1], 16), addr))
    # the innermost loops (none inside them), and of those the unrolled body:
    # the one with the most ex2s, not the remainder steps after it
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops)]
    bodies = [[i for a, i in code if lo <= a <= hi] for lo, hi in inner]
    span = max(bodies, key=lambda body: sum("MUFU.EX2" in i for i in body))
    ex2 = sum("MUFU.EX2" in i for i in span)
    ops_ = {}
    for ins in span:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        ops_[op.split(".")[0]] = ops_.get(op.split(".")[0], 0) + 1
    per_state = len(span) / ex2
    print(f"selective_scan_kernel<bf16, 16> inner loop: {len(span)} SASS instructions for {ex2} "
          f"state steps (MUFU.EX2): {per_state:.2f} a state element a step; {ops_}", flush=True)
    check("the scan's inner loop found in the SASS", ex2 >= 16, ex2=ex2, instructions=len(span))
    return {"ptxas": ptxas, "loop_instructions": len(span), "loop_ex2": ex2,
            "instructions_per_state_step": per_state, "loop_opcodes": ops_}


def scan_inputs(gen, b, s, di, n, dtype, init, *, long_memory=False, dev="cuda"):
    """x ~ 0.5 N in ``dtype``; dt = softplus(N) and A = -exp(0.3 N) (the
    reference tests' draws), or with ``long_memory`` as the model makes
    them (models/layers/mamba.py:39-49): dt log-uniform in [1e-3, 1e-1]
    and A = -exp(log(1..N)) in every channel, so exp(dt A) stays near 1 and
    the state carries hundreds of steps; B, C, D ~ N; a N initial state."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, s, di, scale=0.5).to(dtype)
    if long_memory:
        u = torch.rand((b, s, di), generator=gen, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        a = -torch.exp(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)))
        a = a.expand(di, n).contiguous()
    else:
        dt = torch.nn.functional.softplus(randn(b, s, di))
        a = -torch.exp(randn(di, n, scale=0.3))
    bm, cm, d = randn(b, s, n), randn(b, s, n), randn(di)
    return x, dt, a, bm, cm, d, (randn(b, di, n) if init else None)


def scan_kernel_checks(dev, launch) -> dict:
    """selective_scan against its plain version (``kernels/ref.py``) on the
    card, y within 1e-5 (fp32) / one bf16 ulp, the state within 1e-5 (and
    whether it is bitwise): the serving shape in bf16, S = 1 and S = 1000,
    Di = 300 (not a multiple of the kernel's 128 channels a block, nor of
    its 8-column rows), N = 5, 8, 16, 64, with and without an initial
    state, fp32 and bf16 x, and long memory (the model's dt and A, S =
    1024) in both.  The serving shape is timed through the ops wrapper, as
    a bare launch and the plain version; no single PyTorch call computes
    the scan.  Then the library's registers, spills and inner loop
    (``scan_build_checks``)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, B, S, Di, N, x dtype, initial state, long memory
        ("main", SERVE_B, SERVE_PROMPT, 16384, 16, bf16, False, False),
        ("S=1, Di=300, init", 2, 1, 300, 16, f32, True, False),
        ("S=1000, Di=300, N=8, init", 2, 1000, 300, 8, bf16, True, False),
        ("S=1000, Di=300", 2, 1000, 300, 16, f32, False, False),
        ("N=64, init", 1, 1000, 256, 64, f32, True, False),
        ("N=64, bf16", 2, 77, 300, 64, bf16, False, False),
        ("N=5", 2, 33, 128, 5, bf16, False, False),
        ("long memory, Di=300", 2, 1024, 300, 16, bf16, False, True),
        ("long memory, Di=300, fp32", 2, 1024, 300, 16, f32, False, True),
    ]
    row = None
    for label, b, sl, di, n, dtype, init, long_memory in cases:
        x, dt, a, bm, cm, d, h0 = scan_inputs(gen, b, sl, di, n, dtype, init,
                                              long_memory=long_memory, dev=dev)
        y, h = ops.selective_scan(x, dt, a, bm, cm, d, init_state=h0)
        y_exp, h_exp = ref.selective_scan(x, dt, a, bm, cm, d, init_state=h0)
        tol = SCAN_TOL[dtype]
        err = float((y.float() - y_exp.float()).abs().max())
        h_err = float((h - h_exp).abs().max())
        check(f"selective_scan [{label}: x {tuple(x.shape)} {dtype}, N={n}] y within "
              f"rtol=atol={tol}, state within 1e-5 of its plain version",
              y.dtype == dtype and h.dtype == f32 and bool(torch.isfinite(y.float()).all())
              and torch.allclose(y.float(), y_exp.float(), rtol=tol, atol=tol)
              and torch.allclose(h, h_exp, rtol=1e-5, atol=1e-5),
              max_abs_err=err, state_max_abs_err=h_err,
              state_bitwise=bool(torch.equal(h, h_exp)))
        if label != "main":
            continue
        yo, ho = torch.empty_like(x), torch.empty_like(h)
        row = dict(
            source="src/repro_torch/kernels/csrc/selective_scan.cu",
            replaces="src/repro/kernels/selective_scan.py:86",
            max_abs_err=err,
            ms=time_ms(lambda: ops.selective_scan(x, dt, a, bm, cm, d)),
            launch_ms=time_ms(launch(
                "selective_scan", "repro_selective_scan_bf16", "selective_scan",
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                d.data_ptr(), None, yo.data_ptr(), ho.data_ptr(), None, b, sl, di, n, di, 1)),
            plain_ms=time_ms(lambda: ref.selective_scan(x, dt, a, bm, cm, d), iters=5),
            library_ms=None,
            shape=f"x ({b}, {sl}, {di}) bf16, N {n}, no initial state",
            **scan_bound(b, sl, di, n, nbytes(x, dt, a, bm, cm, d, y, h)),
        )
        del yo, ho
    row["build"] = scan_build_checks()
    # the inner loop's instructions at one warp instruction a clock on each
    # of an SM's 4 schedulers: the floor the plain roundings set
    row["issue_floor_ms"] = (row["build"]["instructions_per_state_step"] * row["exponentials"]
                             / 32 / (4 * H100_SMS * row["sm_clock_hz"]) * 1e3)
    print(f"selective_scan issue floor at the serving shape: {row['issue_floor_ms'] * 1e3:.2f} us "
          f"(kernel {row['launch_ms'] * 1e3:.2f} us bare, MUFU bound {row['bound_ms'] * 1e3:.2f} "
          f"us)", flush=True)
    return row


def topk_payload(gen, c: int, k: int, n: int, dev, *, disjoint=False):
    """A canonical TopK wire (distinct indices, ascending per row), values
    like update deltas, weights like example counts."""
    if disjoint:
        idx = torch.randperm(n, generator=gen, device=dev)[: c * k].reshape(c, k)
    else:
        idx = torch.rand(c, n, generator=gen, device=dev).topk(k, dim=1).indices
    idx = idx.sort(dim=1).values.to(torch.int32)
    val = torch.randn(c, k, generator=gen, device=dev) * 1e-2
    w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
    return idx, val, w


def topk_composition(idx, val, w, n: int, *, normalize=True):
    """The weighted mean of a canonical TopK wire as the kernel orders it,
    in plain torch: each client's products fl(w_c * val) added into a zero
    (N,) accumulator in client order (a row's indices are distinct, so no
    two of its adds meet), divided by safe_weight_sum(w) computed around it
    and, with ``normalize=False``, multiplied back by it: the composition
    the wrapper ran before the weight sum and the product moved inside the
    launch."""
    from repro_torch.utils.pytree import safe_weight_sum

    acc = torch.zeros(n, dtype=torch.float32, device=idx.device)
    for c in range(idx.shape[0]):
        i = idx[c].long()
        acc[i] = acc[i] + w[c] * val[c]
    wsum = safe_weight_sum(w)
    mean = acc / wsum
    return mean if normalize else mean * wsum


# profiler sessions a profiled check may take when a session's record
# lost device activities (the one-kernel-a-call check, phase 18's stages)
PROFILE_SESSIONS = 3


def one_kernel_a_call_check(dev) -> None:
    """The one-launch reduces are one device kernel an ops call in both
    forms: fedavg_reduce at C=2 and C=64 in fp32 and at C=2 in bf16,
    topk_scatter_reduce at C=4 and C=64, dequant_reduce at C=6 and C=64,
    normalize True and False; and the
    Int8 codec's encode of the unpadded (N,) delta (no pad or copy kernel)
    and ops.dequantize_int8 at Np are one kernel each.  Each call is run
    and synchronized in turn inside ONE profiler session, the first of the
    process; the device activities it saw, in time order, must be exactly
    one kernel of the called function per call.  (Short profiler sessions
    after the first few of a process can stop recording device activity,
    so the calls share one.)  A session whose record only lost activities
    -- fewer than the calls, each one it kept the kernel expected there,
    in order -- says nothing of the kernels and is taken again, up to
    ``PROFILE_SESSIONS`` sessions; a kernel the calls did not name, or
    one out of its place, fails at once."""
    from functools import partial

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compression import Int8Codec
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(19)
    calls = []  # (label, kernel name, call)
    for c, dtype in ((2, torch.float32), (64, torch.float32), (2, torch.bfloat16)):
        u = (torch.randn(c, N_PARAMS, generator=gen, device=dev) * 1e-3).to(dtype)
        w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
        calls += [(f"fedavg_reduce C={c} {dtype} normalize={nz}", "fedavg_reduce_kernel",
                   partial(ops.fedavg_reduce, u, w, normalize=nz)) for nz in (True, False)]
    for c in (4, 64):
        idx, val, w = topk_payload(gen, c, TOPK_K, N_PARAMS, dev)
        calls += [(f"topk_scatter_reduce C={c} normalize={nz}", "topk_scatter_reduce_kernel",
                   partial(ops.topk_scatter_reduce, idx, val, w, N_PARAMS, normalize=nz))
                  for nz in (True, False)]
    for c in (6, 64):
        q, s = ops.quantize_int8(torch.randn(c * NP_MAIN, generator=gen, device=dev) * 1e-3)
        q, s = q.reshape(c, NP_MAIN), s.reshape(c, NP_MAIN // BLOCK)
        w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
        calls += [(f"dequant_reduce C={c} normalize={nz}", "dequant_reduce_kernel",
                   partial(ops.dequant_reduce, q, s, w, normalize=nz)) for nz in (True, False)]
    delta = torch.randn(N_PARAMS, generator=gen, device=dev) * 1e-3
    q, s = ops.quantize_int8(delta)
    calls += [("Int8Codec().encode N=1,974,303", "quantize_int8_kernel",
               partial(Int8Codec().encode, delta)),
              ("dequantize_int8 Np=1,974,528", "dequantize_int8_kernel",
               partial(ops.dequantize_int8, q, s))]
    for _, _, call in calls:
        call()
    torch.cuda.synchronize()
    expected = [kernel for _, kernel, _ in calls]

    def short(name: str) -> str:
        return name.split("<")[0].split()[-1]

    def only_lost(names: list) -> bool:
        """``names`` is ``expected`` with some kernels missing and none added."""
        rest = iter(expected)
        return len(names) < len(expected) and all(
            any(short(n) == k for k in rest) for n in names)

    sessions = []
    while len(sessions) < PROFILE_SESSIONS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, _, call in calls:
                call()
                torch.cuda.synchronize()
        seen = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        names = [e.name.split("::")[-1].split("(")[0] for e in seen]
        sessions.append(names)
        if not only_lost(names):
            break
        print(f"one_kernel_a_call_check: profiler session {len(sessions)} recorded "
              f"{len(names)} of {len(calls)} kernels: {names}", file=sys.stderr, flush=True)
    check("fedavg_reduce, topk_scatter_reduce and dequant_reduce (normalize True and False), "
          "the Int8 encode and dequantize_int8 are one device kernel a call ["
          + "; ".join(label for label, _, _ in calls) + "]",
          [short(n) for n in names] == expected,
          kernels=names, sessions=len(sessions), lost_sessions=sessions[:-1])


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in units of b's last place (fp32)."""
    ulp = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) - b.abs()
    return float(((a - b).abs() / ulp).max())


def topk_kernel_checks(dev, tol, launch) -> dict:
    """topk_scatter_reduce against its plain version: C=4 (the mixed fleet's
    TopK group) and C=64 at full width, bitwise against the composition it
    replaced (integer weights) in both forms, within 2C - 1 ulps of it with
    non-integer weights (one device kernel per call in both forms:
    ``one_kernel_a_call_check``); then the edge payloads."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.scatter_reduce import TILE, workspace_ints
    from repro_torch.utils.pytree import safe_weight_sum

    gen = torch.Generator(device=dev).manual_seed(13)
    row = None
    for label, c in (("main", 4), ("C=64", 64)):
        idx, val, w = topk_payload(gen, c, TOPK_K, N_PARAMS, dev)
        out, exp = ops.topk_scatter_reduce(idx, val, w, N_PARAMS), ref.topk_scatter_reduce(idx, val, w, N_PARAMS)
        err = float((out - exp).abs().max())
        check(f"topk_scatter_reduce within rtol=atol=1e-6 [{label}: C={c}, k={TOPK_K}, N={N_PARAMS}]",
              torch.allclose(out, exp, **tol), max_abs_err=err)
        check(f"topk_scatter_reduce two launches bitwise equal [{label}]",
              torch.equal(out, ops.topk_scatter_reduce(idx, val, w, N_PARAMS)))
        summed = ops.topk_scatter_reduce(idx, val, w, N_PARAMS, normalize=False)
        check(f"topk_scatter_reduce bitwise the composition it replaced, integer weights, "
              f"normalize True and False [{label}]",
              torch.equal(out, topk_composition(idx, val, w, N_PARAMS))
              and torch.equal(summed, topk_composition(idx, val, w, N_PARAMS, normalize=False))
              and torch.equal(summed, out * safe_weight_sum(w)))
        di, dv, dw = topk_payload(gen, c, TOPK_K, N_PARAMS, dev, disjoint=True)
        check(f"topk_scatter_reduce bitwise on disjoint rows [{label}]",
              torch.equal(ops.topk_scatter_reduce(di, dv, dw, N_PARAMS),
                          ref.topk_scatter_reduce(di, dv, dw, N_PARAMS)))
        # weights that are not integers: the two weight sums may round apart
        fw = torch.rand(c, generator=gen, device=dev) * 300 + 0.1
        ulps = ulps_apart(ops.topk_scatter_reduce(di, dv, fw, N_PARAMS),
                          ref.topk_scatter_reduce(di, dv, fw, N_PARAMS))
        check(f"topk_scatter_reduce within 2C - 1 = {2 * c - 1} ulps of the plain version, "
              f"non-integer weights, disjoint rows [{label}]", ulps <= 2 * c - 1, ulps=ulps)
        wf = w.contiguous()
        wsum = safe_weight_sum(wf)
        ws = torch.empty(workspace_ints(c, TOPK_K, N_PARAMS), dtype=torch.int32, device=dev)
        outo = torch.empty_like(out)
        valid = (idx >= 0) & (idx < N_PARAMS)
        sidx = torch.where(valid, idx, 0).reshape(-1).long()
        contrib = (torch.where(valid, val, 0.0) * wf[:, None]).reshape(-1)
        b_ms, b_by = bound(nbytes(idx, val, w, out), 2 * idx.numel())
        plain = {True: lambda: ref.topk_scatter_reduce(idx, val, w, N_PARAMS),
                 # the CPU route's composition, on the card
                 False: lambda: ops._denormalize(ref.topk_scatter_reduce(idx, val, w, N_PARAMS),
                                                 w)}
        # the yardstick: one index_add_ on the same sanitized, weighted,
        # flattened inputs into a zero fill (the weighted sum), plus the
        # normalization for the mean
        library = {True: lambda: torch.zeros(N_PARAMS, device=dev).index_add_(
                       0, sidx, contrib) / wsum,
                   False: lambda: torch.zeros(N_PARAMS, device=dev).index_add_(
                       0, sidx, contrib)}
        for normalize in (True, False):
            timing = dict(
                source="src/repro_torch/kernels/csrc/topk_scatter_reduce.cu",
                replaces="src/repro/kernels/scatter_reduce.py:108",
                max_abs_err=err,
                ms=time_ms(lambda: ops.topk_scatter_reduce(idx, val, w, N_PARAMS,
                                                           normalize=normalize)),
                launch_ms=time_ms(launch("topk_scatter_reduce", "repro_topk_scatter_reduce",
                                         "topk_scatter_reduce", idx.data_ptr(), val.data_ptr(),
                                         wf.data_ptr(), outo.data_ptr(), ws.data_ptr(), c,
                                         TOPK_K, N_PARAMS, ws.numel(), int(normalize))),
                plain_ms=time_ms(plain[normalize]),
                library_ms=time_ms(library[normalize]),
                bound_ms=b_ms, bound_by=b_by,
                # the (N,) fp32 write alone, as one fill (the kernel's floor here)
                zero_fill_ms=time_ms(lambda: outo.zero_()),
                shape=f"idx/val ({c}, {TOPK_K}), N={N_PARAMS}"
                      + ("" if normalize else ", normalize=False"),
                bytes=nbytes(idx, val, w, out),
            )
            if label == "main" and normalize:
                row = timing
            else:
                case = label if normalize else f"{label}, normalize=False"
                REPORT["timings"].append({"name": "topk_scatter_reduce", "case": case, **timing})

    # canonical wires down the kernel's long paths: more entries of a row in
    # one tile than a CTA has threads, and more rows than one group of 256
    n = 20_000
    for label, c, k, span in (("3000 entries in one tile", 3, 3000, TILE + 100),
                              ("C=300 rows", 300, 40, n)):
        idx = torch.rand(c, span, generator=gen, device=dev).topk(k, dim=1).indices
        idx = idx.sort(dim=1).values.to(torch.int32)
        val = torch.randn(c, k, generator=gen, device=dev) * 1e-2
        w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
        out, exp = ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n)
        check(f"topk_scatter_reduce within rtol=atol=1e-6, two launches bitwise, and bitwise "
              f"the composition it replaced [{label}]",
              torch.allclose(out, exp, **tol) and torch.equal(out, ops.topk_scatter_reduce(idx, val, w, n))
              and torch.equal(out, topk_composition(idx, val, w, n)),
              max_abs_err=float((out - exp).abs().max()))

    # foreign wires: unsorted rows with repeats, out-of-range indices
    idx = torch.randint(0, n, (5, 300), generator=gen, device=dev, dtype=torch.int32)
    idx[1, :10] = torch.tensor([-1, n, 2**31 - 1, -(2**31), 0, 0, n - 1, n - 1, 5, 5],
                               dtype=torch.int32, device=dev)
    val = torch.randn(5, 300, generator=gen, device=dev) * 1e-2
    w = torch.randint(10, 500, (5,), generator=gen, device=dev).to(torch.float32)
    out, exp = ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n)
    check("topk_scatter_reduce within rtol=atol=1e-6 [unsorted rows, repeated and "
          "out-of-range indices]", torch.allclose(out, exp, **tol),
          max_abs_err=float((out - exp).abs().max()))
    drop = ops.topk_scatter_reduce(
        torch.tensor([[0, -1, 256, 5, 2**30, 255]], dtype=torch.int32, device=dev),
        torch.ones(1, 6, device=dev), torch.ones(1, device=dev), 256)
    keep = torch.zeros(256, device=dev)
    keep[[0, 5, 255]] = 1.0
    check("topk_scatter_reduce drops negative and >= N indices", torch.equal(drop, keep))
    zero = ops.topk_scatter_reduce(idx, val, torch.zeros_like(w), n)
    check("topk_scatter_reduce zero weights -> zeros", not zero.any() and not zero.isnan().any())
    for c, k in ((3, 0), (0, 7)):
        empty = ops.topk_scatter_reduce(torch.zeros(c, k, dtype=torch.int32, device=dev),
                                        torch.zeros(c, k, device=dev), torch.ones(c, device=dev), n)
        check(f"topk_scatter_reduce C={c}, k={k} -> zeros", empty.shape == (n,) and not empty.any())
    summed = ops.topk_scatter_reduce(idx, val, w, n, normalize=False)
    check("topk_scatter_reduce normalize=False = mean x safe_weight_sum(w)",
          torch.equal(summed, out * safe_weight_sum(w)))
    return row


# ---------------- phases 3-4: the Flower loop ----------------
PROFILE_FLEET = ["jetson-tx2-gpu"] * 3 + ["jetson-tx2-cpu"] * 3 + ["tpu-v5e-chip"] * 2
# the paper's mixed fleet: Android phones (TopK), Jetsons (Int8), datacenter (Null)
MIXED_FLEET = (["pixel-4", "pixel-3", "pixel-2", "galaxy-tab-s6"]
               + ["jetson-tx2-gpu"] * 2 + ["jetson-tx2-cpu"] * 2 + ["tpu-v5e-chip"] * 2)
# local SGD's rate by model family, in the Flower loop, the round engine
# and the mesh: the head model's 0.1; from the ResNet's init(0) an SGD step
# at 0.1 raises the loss of the very batch it steps on (at 0.01 it falls)
LOCAL_LR = {"head": 0.1, "cnn": 0.01}


def model_data(model, n: int, seed: int):
    """``n`` synthetic examples for ``model``: frozen-base features for the
    head model, NHWC images for the ResNet (the heterogeneous-cutoff
    example's Gaussian mixture, noise 1.2)."""
    from repro_torch.data.synthetic import make_classification, make_features

    cfg = model.cfg
    if model.arch.family == "cnn":
        return make_classification(n=n, num_classes=cfg.num_classes, noise=1.2, seed=seed,
                                   shape=(cfg.image_size, cfg.image_size, cfg.channels))
    return make_features(n=n, num_classes=cfg.num_classes, feature_dim=cfg.feature_dim,
                         seed=seed)


def trainable_mask_of(model, params):
    """The model's frozen/trainable split, or None (every leaf trains)."""
    return None if model.trainable_mask is None else model.trainable_mask(params)


def stage_timed(fn, stage: str, stage_s: dict):
    """``fn`` adding its host seconds, synchronized, to ``stage_s[stage]``."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stage_s[stage] = stage_s.get(stage, 0.0) + time.perf_counter() - t0
        return out
    return call


def instrument_clients(clients, stage_s: dict | None = None, dispatched: list | None = None):
    """``instrument``'s client half: with ``stage_s`` every ``fit`` /
    ``evaluate`` adds its host seconds to it; with ``dispatched`` every
    ``fit`` appends its client id."""
    if dispatched is not None:
        def logged(fn, cid):
            def call(ins):
                dispatched.append(cid)
                return fn(ins)
            return call
        for c in clients:
            c.fit = logged(c.fit, c.client_id)
    if stage_s is not None:
        for c in clients:
            c.fit = stage_timed(c.fit, "fit", stage_s)
            c.evaluate = stage_timed(c.evaluate, "evaluate", stage_s)


def instrument(clients, strategy, on_round=None, stage_s: dict | None = None,
               agg_log: list | None = None, dispatched: list | None = None):
    """Wraps, on these instances, what a phase reads of a Server run, and
    returns the MetricsLogger to give the Server: ``on_round()`` runs at the
    end of every round; with ``stage_s`` every client ``fit`` / ``evaluate``
    and the strategy's ``aggregate_fit`` add their host seconds
    (synchronized) to it; with ``agg_log`` every ``aggregate_fit`` appends
    (rnd, results, global in, global out, server state out), the globals
    and the state copied to the CPU; with ``dispatched`` every client
    ``fit`` appends its client id."""
    from repro_torch.utils.logging import MetricsLogger
    from repro_torch.utils.pytree import tree_map

    class RoundHook(MetricsLogger):
        def log(self, event, **kv):
            super().log(event, **kv)
            if on_round is not None:
                on_round()

    instrument_clients(clients, stage_s, dispatched)
    if stage_s is not None:
        strategy.aggregate_fit = stage_timed(strategy.aggregate_fit, "aggregate_fit", stage_s)
    if agg_log is not None:
        def recorded(fn):
            def call(rnd, results, global_params):
                out = fn(rnd, results, global_params)
                agg_log.append((rnd, results, tree_map(lambda t: t.cpu(), global_params),
                                tree_map(lambda t: t.cpu(), out),
                                tree_map(lambda t: t.cpu(), strategy._server_state)))
                return out
            return call
        strategy.aggregate_fit = recorded(strategy.aggregate_fit)
    return RoundHook("server", stream=sys.stderr)


def flower_loop(arch, device, n_rounds: int, fleet=PROFILE_FLEET, make_strategy=None,
                **probe):
    """The paper's Flower loop on the smoke fleet, instrumented by
    ``instrument(clients, strategy, **probe)``.  ``make_strategy(cost_model,
    clients)`` builds the strategy (default: FedAvg under
    BandwidthCodecPolicy at the family's ``LOCAL_LR``); one with a
    ``make_policy`` (FedBuff) runs under the policy it makes."""
    from repro_torch.core import (
        PROFILES, BandwidthCodecPolicy, FedAvg, Server, TorchClient,
        make_cost_model_for,
    )
    from repro_torch.data.federated import dirichlet_partition
    from repro_torch.models import build_model

    model = build_model(arch, device=device)
    data = model_data(model, 2000, seed=0)
    shards = dirichlet_partition(data, n_clients=len(fleet), alpha=1.0, seed=0)
    params = model.init(0)
    mask = trainable_mask_of(model, params)
    clients = [
        TorchClient(client_id=s.client_id, loss_fn=model.loss_fn, dataset=s,
                    batch_size=32, trainable_mask=mask, device_profile=p, device=device)
        for s, p in zip(shards, fleet)
    ]
    cost_model = make_cost_model_for(params, [PROFILES[p] for p in fleet])
    strategy = (FedAvg(local_epochs=2, local_lr=LOCAL_LR[model.arch.family],
                       codec_policy=BandwidthCodecPolicy())
                if make_strategy is None else make_strategy(cost_model, clients))
    server = Server(
        strategy=strategy, clients=clients, cost_model=cost_model, device=device,
        policy=getattr(strategy, "make_policy", lambda: None)(),
        logger=instrument(clients, strategy, **probe),
    )
    return params, cost_model, server.run(params, num_rounds=n_rounds)


def main_path_phase() -> dict:
    from repro_torch.core import BandwidthCodecPolicy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_size

    stamps: list[float] = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cost_model, (final, history) = flower_loop(
        "mobilenet-head-office31", "cuda", 3,
        on_round=lambda: stamps.append(time.perf_counter()),
    )
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0

    n = tree_size(params)
    check("full width: N = 1,974,303 params", n == N_PARAMS, n_params=n)
    per_round = {"quantize_int8": 6, "dequantize_int8": 6, "dequant_reduce": 1, "fedavg_reduce": 1}
    check("main path launched every kernel (6+6+1+1 per round)",
          all(counts[k] == 3 * v for k, v in per_round.items()), launches=counts)
    check("global params on cuda", all(t.is_cuda for t in tree_leaves(final)))
    accs = [r.eval_acc for r in history.rounds]
    check("accuracy finite and rising (round 3 > round 1)",
          all(math.isfinite(a) for a in accs) and accs[-1] > accs[0], eval_acc=accs)
    policy = BandwidthCodecPolicy()
    expect = 6 * policy.int8.wire_bytes(n) + 2 * policy.null.wire_bytes(n) + 8 * cost_model.update_bytes
    check("comm_bytes = codec wires + downlinks",
          all(r.comm_bytes == expect for r in history.rounds),
          comm_bytes=[r.comm_bytes for r in history.rounds], expected=expect)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"launches": counts, "round_wall_s": round_s, "run_wall_s": wall,
            "eval_acc": accs, "train_loss": [r.train_loss for r in history.rounds]}


def mixed_fleet_phase(arch="mobilenet-head-office31", fleet=MIXED_FLEET,
                      n_rounds: int = 3) -> dict:
    """Phase 3b (and phase 10's leg b): a mixed fleet at full width under
    FedAvg -- phones TopK, Jetsons Int8, datacenter-class Null -- with the
    launch counts set to 0 before the run and read and set to 0 at the end
    of every round: per round one quantize and one dequantize an Int8
    client and one launch of each codec group's reduce, nothing else.
    Accuracy finite and higher in the last round than in the first."""
    from repro_torch.core import BandwidthCodecPolicy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_size

    label = "mixed fleet" if arch == "mobilenet-head-office31" else f"{arch} mixed fleet"
    n_int8 = sum(p.startswith("jetson") for p in fleet)
    n_null = sum(p.startswith("tpu") for p in fleet)
    n_topk = len(fleet) - n_int8 - n_null
    stamps: list[float] = []
    by_round: list[dict] = []

    def on_round():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        by_round.append(ops.launch_counts())
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cost_model, (final, history) = flower_loop(arch, "cuda", n_rounds, on_round=on_round,
                                                       fleet=fleet)
    n = tree_size(params)
    want = {k: 0 for k in by_round[0]}
    want.update(quantize_int8=n_int8, dequantize_int8=n_int8, dequant_reduce=1,
                fedavg_reduce=1, topk_scatter_reduce=1)
    check(f"{label}: launches per round {n_int8}/{n_int8}/1/1/1 (quantize, dequantize, "
          "dequant_reduce, fedavg_reduce, topk_scatter_reduce; TopK clients launch none), "
          "nothing else", all(c == want for c in by_round),
          launches=[{k: v for k, v in c.items() if v} for c in by_round])
    check(f"{label}: global params on cuda", all(t.is_cuda for t in tree_leaves(final)))
    accs = [r.eval_acc for r in history.rounds]
    check(f"{label}: accuracy finite and rising (round {n_rounds} > round 1)",
          all(math.isfinite(a) for a in accs) and accs[-1] > accs[0], eval_acc=accs)
    policy = BandwidthCodecPolicy()
    expect = (n_topk * policy.topk.wire_bytes(n) + n_int8 * policy.int8.wire_bytes(n)
              + n_null * policy.null.wire_bytes(n) + len(fleet) * cost_model.update_bytes)
    check(f"{label}: comm_bytes = codec wires + downlinks",
          all(r.comm_bytes == expect for r in history.rounds),
          comm_bytes=[r.comm_bytes for r in history.rounds], expected=expect)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"launches": {k: sum(c[k] for c in by_round) for k in want},
            "launches_by_round": by_round, "round_wall_s": round_s, "eval_acc": accs,
            "train_loss": [r.train_loss for r in history.rounds], "n_params": n}


def reduced_parity_phase(fleet=PROFILE_FLEET, loop=None, name: str | None = None) -> None:
    """The card (kernels) against the CPU (plain versions) at reduced width.

    1. Replay: every round's uploads that reached the card's
       ``aggregate_fit`` go through a CPU strategy's ``aggregate_fit`` against
       the same global; the new globals differ only by the reduces' summation
       order (rtol=atol=1e-6), so a wrong weight or a dropped codec group
       shows.
    2. The same 2-round run on both devices from the same seed: History must
       be equal.  Local SGD differs in the last bits between the devices, so
       an Int8 code on a rounding edge may flip and a TopK entry on the
       selection edge may change; the final params may differ by 1e-5 plus,
       for every code that differs between the two runs' wires, that code's
       change times its block scale times its client's weight share, and for
       every TopK index sent by one run only, its |value| times the weight
       share.

    ``loop(arch, device, **probe)`` runs the 2 rounds (default: the Flower
    loop on ``fleet``); ``name`` labels the checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import FedAvg, Int8Codec, TopKCodec
    from repro_torch.core.protocol import wire_to_enc
    from repro_torch.utils.pytree import tree_flatten_to_vector

    arch = get_config("mobilenet-head-office31").reduced()
    if name is None:
        name = "reduced width" if fleet is PROFILE_FLEET else "mixed fleet, reduced width"
    if loop is None:
        def loop(arch, device, **probe):
            return flower_loop(arch, device, 2, fleet=fleet, **probe)
    card_log, cpu_log = [], []
    _, _, (on_card, h_card) = loop(arch, "cuda", agg_log=card_log)[:3]
    _, _, (on_cpu, h_cpu) = loop(arch, "cpu", agg_log=cpu_log)[:3]

    replay_err = 0.0
    cpu_strategy = FedAvg(local_epochs=2, local_lr=0.1)
    for rnd, results, g_in, g_out, _ in card_log:
        want = tree_flatten_to_vector(cpu_strategy.aggregate_fit(rnd, results, g_in))
        got = tree_flatten_to_vector(g_out)
        replay_err = max(replay_err, float((got - want).abs().max()))
        check(f"{name}: round {rnd} card aggregate = CPU aggregate of the same "
              f"uploads (rtol=atol=1e-6)", torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              max_abs_err=float((got - want).abs().max()))

    atol, flipped = 1e-5, 0
    for (_, card_res, *_), (_, cpu_res, *_) in zip(card_log, cpu_log, strict=True):
        wsum = sum(r.num_examples for _, r in card_res)
        for (_, a), (_, b) in zip(card_res, cpu_res, strict=True):
            kind = type(a.parameters.codec)
            if kind not in (Int8Codec, TopKCodec):
                continue
            ea, eb = wire_to_enc(a.parameters, "cpu"), wire_to_enc(b.parameters, "cpu")
            if kind is TopKCodec:
                va = dict(zip(ea["idx"].tolist(), ea["val"].tolist()))
                vb = dict(zip(eb["idx"].tolist(), eb["val"].tolist()))
                for i in set(va) ^ set(vb):
                    flipped += 1
                    atol += abs(va.get(i, vb.get(i))) * a.num_examples / wsum
                continue
            dq = (ea["q"].int() - eb["q"].int()).abs().reshape(-1, BLOCK)
            scale = torch.maximum(ea["scale"], eb["scale"]).reshape(-1, 1)
            flipped += int((dq > 0).sum())
            atol += float((dq * scale).sum()) * a.num_examples / wsum
    err = float((tree_flatten_to_vector(on_card).cpu() - tree_flatten_to_vector(on_cpu)).abs().max())
    check(f"{name}: card vs CPU run (atol = 1e-5 + the differing wire entries' share)",
          err <= atol and all(
              (x.comm_bytes, x.wall_time_s, x.energy_j) == (y.comm_bytes, y.wall_time_s, y.energy_j)
              for x, y in zip(h_card.rounds, h_cpu.rounds, strict=True)),
          max_abs_err=err, atol=atol, codes_differing=flipped, replay_max_abs_err=replay_err)


PORT_KERNELS = ("quantize_int8_kernel", "quantize_int8_unaligned_kernel", "dequant_reduce_kernel", "fedavg_reduce_kernel",
                "topk_scatter_reduce_kernel", "collective_absmax_kernel",
                "collective_pack_kernel", "collective_unpack_kernel")
# the serving paths' kernels by wrapper, as the profiler names them
SERVING_KERNELS = {
    "flash_attention": ("flash_attention_kernel",),
    "decode_attention": ("decode_attention_split_kernel", "decode_attention_combine_kernel"),
    "selective_scan": ("selective_scan_kernel",),
}


def export_gzipped_trace(prof, trace: Path) -> None:
    """The profiler's chrome trace as ``trace``.gz: a round of many clients'
    steps is tens of MB of JSON, and a chip call brings back 64 MiB.  Level
    6, not gzip's 9: on ResNet's 169 MB round a third of the time for 8%
    more bytes."""
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as raw, gzip.open(f"{trace}.gz", "wb", compresslevel=6) as packed:
        shutil.copyfileobj(raw, packed)
    trace.unlink()


# a profiled call's trace is kept below this gzipped size, else its
# per-op summary (an xLSTM prefill holds ~10^5 kernel events)
TRACE_LIMIT_BYTES = 8 << 20


def export_trace_or_summary(prof, trace: Path) -> dict:
    """``export_gzipped_trace``, then, where the gzipped trace passes
    ``TRACE_LIMIT_BYTES``, the profiler's per-op summary in its place."""
    export_gzipped_trace(prof, trace)
    packed = Path(f"{trace}.gz")
    size = packed.stat().st_size
    if size <= TRACE_LIMIT_BYTES:
        return {"trace_gz_bytes": size, "trace": str(packed)}
    packed.unlink()
    summary = trace.with_suffix(".ops.txt")
    summary.write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    return {"trace_gz_bytes": size, "summary": str(summary)}


def device_time(prof, skip=()) -> tuple[float, dict]:
    """A profiler run's card busy time (the union of its device intervals,
    us) and device time by kernel name, leaving out the device events named
    in ``skip``: a ``record_function`` range under CPU activity also lays
    its span on the device timeline, gaps included."""
    from torch.autograd import DeviceType

    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in skip:
            spans.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return union_us(spans), by_kernel


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_phase(card: str, out_dir: Path, fleet=PROFILE_FLEET, make_strategy=None,
                  label: str | None = None) -> dict:
    """Where a steady full-width round's time goes, on a fresh 3-round run
    of the same loop: round 2's host seconds split by FL stage (each stage
    synchronized), round 3 under torch.profiler (device activity only) for
    the card's busy time and its kernels.  The profiler's own cost inflates
    round 3's wall time, so the card's idle share is taken against round 2,
    which does the same device work without it."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    stage_s: dict = {}
    marks: list[float] = []
    split: dict = {}

    def on_round():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if len(marks) == 1:
            stage_s.clear()
        elif len(marks) == 2:
            split.update(stage_s)
            prof.start()
        elif len(marks) == 3:
            prof.stop()

    flower_loop("mobilenet-head-office31", "cuda", 3, on_round=on_round, stage_s=stage_s,
                fleet=fleet, make_strategy=make_strategy)
    round2_s, round3_s = marks[1] - marks[0], marks[2] - marks[1]
    split["other"] = round2_s - sum(split.values())
    busy_us, by_kernel = device_time(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    ours_us = sum(us for name, us in by_kernel.items() if any(k in name for k in PORT_KERNELS))
    if label is None:
        label = "" if fleet is PROFILE_FLEET else "mixed fleet "
    prof.export_chrome_trace(str(out_dir / f"{label.replace(' ', '_')}round3_trace.json"))
    out = {
        "round2_host_s": round2_s, "round2_stage_s": split,
        "round3_profiled_s": round3_s, "round3_device_busy_ms": busy_us / 1e3,
        "device_idle_share_vs_round2": 1.0 - busy_us / 1e6 / round2_s,
        "round3_port_kernels_us": ours_us, "round3_top_device_us": top,
    }
    print(f"{label}round 2 host split: {json.dumps({k: round(v, 4) for k, v in split.items()})} "
          f"of {round2_s:.4f} s ({card})", flush=True)
    print(f"{label}round 3 profiled: card busy {busy_us / 1e3:.3f} ms, of which the port's "
          f"kernels {ours_us:.1f} us; idle {out['device_idle_share_vs_round2']:.4f} of "
          f"round 2's {round2_s:.4f} s ({card})", flush=True)
    for name, us in top:
        print(f"  {us:10.1f} us  {name[:100]}", flush=True)
    return out


# ---------------- phase 3c: the strategy family on the mixed fleet ----------------
FAMILY = ("fedtau", "fedprox", "fedadam", "fedyogi", "fedavgm", "fedbuff")
# FedBuff's buffer: half the mixed fleet.  At its default K = 2 the two
# datacenter clients fill every buffer first and no update is ever stale;
# at K = 5 stale Int8 and TopK updates reach the reduces in rounds 2 and 3
FEDBUFF_K = 5
# each reported codec group's reduce, by codec
GROUP_REDUCE = {"Int8Codec": "dequant_reduce", "NullCodec": "fedavg_reduce",
                "TopKCodec": "topk_scatter_reduce"}


def family_strategy(name: str, log: dict | None = None):
    """``flower_loop``'s ``make_strategy`` for strategy ``name`` under
    BandwidthCodecPolicy, at phase 3's local work (2 epochs, lr 0.1):
    FedTau's tau is the Jetson TX2 GPU's full round (``tau_for_profile``,
    paper Table 3), FedProx's mu 0.01, FedBuff with K = FEDBUFF_K (staleness
    up to 4) under its own policy.  With ``log``, the strategy,
    its cost model, the clients and each client's codec go there, and
    every ``aggregate_fit`` appends its reported (client, codec,
    staleness) to ``log["reported"]``."""

    def make(cost_model, clients):
        from repro_torch.core import (
            BandwidthCodecPolicy, FedProx, FedTau, STRATEGIES, tau_from_reference_processor,
        )

        kw = dict(local_epochs=2, local_lr=0.1, codec_policy=BandwidthCodecPolicy())
        if name == "fedtau":
            spe = clients[0].steps_per_epoch()
            tau = tau_from_reference_processor(cost_model, "jetson-tx2-gpu", epochs=2,
                                               steps_per_epoch=spe)
            strategy = FedTau(tau_s=tau, cost_model=cost_model, steps_per_epoch=spe, **kw)
        elif name == "fedprox":
            strategy = FedProx(mu=0.01, **kw)
        elif name == "fedbuff":
            strategy = STRATEGIES[name](buffer_size=FEDBUFF_K, **kw)
        else:
            strategy = STRATEGIES[name](**kw)
        if log is not None:
            inner = strategy.aggregate_fit

            def logged(rnd, results, global_params):
                log["reported"].append([(cid, type(r.parameters.codec).__name__, r.staleness)
                                        for cid, r in results])
                return inner(rnd, results, global_params)

            strategy.aggregate_fit = logged
            log.update(strategy=strategy, cost_model=cost_model, clients=clients, codec={
                c.client_id: type(strategy.codec_for_client(c.client_id, c.properties())).__name__
                for c in clients})
        return strategy

    return make


def family_run(name: str, card: str) -> dict:
    """One strategy at full width on the mixed fleet, 3 rounds, the launch
    counts read and set to 0 at the end of every round and held against
    what the round dispatched and aggregated: each dispatched Int8 client
    one quantize_int8 and one dequantize_int8, each codec group among the
    reported results one launch of its reduce, nothing else."""
    from repro_torch.core import FedOpt, FedTau
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves

    log: dict = {"reported": []}
    dispatched: list[int] = []
    per_round, marks, moments = [], [], []

    def on_round():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        seen = sum(len(r) for _, _, r in per_round)  # aggregate_fit calls already read
        per_round.append((ops.launch_counts(), list(dispatched), log["reported"][seen:]))
        dispatched.clear()
        ops.reset_launch_counts()
        if len(marks) == 2 and isinstance(log["strategy"], FedOpt):
            moments.append(any(float(t.abs().sum()) > 0
                               for t in tree_leaves(log["strategy"]._server_state)))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, (final, history) = flower_loop(
        "mobilenet-head-office31", "cuda", 3, on_round=on_round, fleet=MIXED_FLEET,
        make_strategy=family_strategy(name, log), dispatched=dispatched)
    strategy, codec_of = log["strategy"], log["codec"]
    launches = []
    for rnd, (counts, sent, reported) in enumerate(per_round, 1):
        reported = [row for rows in reported for row in rows]
        int8_sent = sum(codec_of[cid] == "Int8Codec" for cid in sent)
        want = {k: 0 for k in counts}
        want.update(quantize_int8=int8_sent, dequantize_int8=int8_sent)
        for codec in {codec for _, codec, _ in reported}:
            want[GROUP_REDUCE[codec]] = 1
        check(f"{name}: round {rnd} launches (an Int8 client sent: 1 quantize + 1 dequantize; "
              f"a reported codec group: 1 reduce)", counts == want, launches=counts,
              expected=want, dispatched=sent, reported=reported)
        launches.append(counts)
    check(f"{name}: global params and server state on cuda",
          all(t.is_cuda for t in tree_leaves(final))
          and all(t.is_cuda for t in tree_leaves(strategy._server_state)))
    losses = [r.train_loss for r in history.rounds]
    check(f"{name}: train loss finite", all(math.isfinite(x) for x in losses), train_loss=losses)
    info = {}
    if isinstance(strategy, FedTau):
        clients = log["clients"]
        budgets = strategy.client_step_budgets([c.client_id for c in clients])
        full = strategy.local_epochs * strategy.steps_per_epoch
        cut = [b for b, p in zip(budgets, MIXED_FLEET) if p == "jetson-tx2-cpu"]
        steps = sum(min(b, strategy.local_epochs * c.steps_per_epoch())
                    for b, c in zip(budgets, clients))
        check(f"{name}: jetson-tx2-cpu clients cut below the full {full} steps, History.steps "
              f"= the budgets' sum {steps}",
              all(b < full for b in cut) and all(r.steps == steps for r in history.rounds),
              budgets=budgets, steps=[r.steps for r in history.rounds], tau_s=strategy.tau_s)
        info["budgets"] = budgets
    if name == "fedbuff":
        stale = [r.staleness_mean for r in history.rounds]
        check(f"{name}: some update reported stale", any(s > 0 for s in stale),
              staleness_mean=stale, participants=[r.participants for r in history.rounds])
        info["staleness_mean"] = stale
    if isinstance(strategy, FedOpt):
        check(f"{name}: server moments nonzero after round 2", moments == [True])
    round_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    print(f"{name}: rounds {', '.join(f'{x:.4f}' for x in round_s)} s host wall, train loss "
          f"{', '.join(f'{x:.4f}' for x in losses)}, eval acc "
          f"{', '.join(f'{r.eval_acc:.4f}' for r in history.rounds)} ({card})",
          flush=True)
    return {"launches": launches, "round_wall_s": round_s, "train_loss": losses,
            "eval_acc": [r.eval_acc for r in history.rounds],
            "participants": [r.participants for r in history.rounds], **info}


def fedadam_topk_zeros_check() -> dict:
    """FedAdam over a TopK-only fleet (the four phones) at full width: the
    pseudo-gradient is exactly zero where no client sent a value, so those
    coordinates of the global come out of the card bitwise unchanged."""
    from repro_torch.core.protocol import wire_to_enc
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_flatten_to_vector

    agg_log: list = []
    ops.reset_launch_counts()
    flower_loop("mobilenet-head-office31", "cuda", 1, agg_log=agg_log, fleet=MIXED_FLEET[:4],
                make_strategy=family_strategy("fedadam"))
    counts = ops.launch_counts()
    (_, results, g_in, g_out, _), = agg_log
    touched = torch.zeros(N_PARAMS, dtype=torch.bool)
    for _, r in results:
        touched[wire_to_enc(r.parameters, "cpu")["idx"].long()] = True
    g_in, g_out = tree_flatten_to_vector(g_in), tree_flatten_to_vector(g_out)
    untouched = ~touched
    check("fedadam, TopK-only fleet: the coordinates no client sent are bitwise unchanged on "
          "the card (one TopK reduce, no other kernel)",
          0 < int(touched.sum()) < N_PARAMS
          and torch.equal(g_out[untouched], g_in[untouched])
          and not torch.equal(g_out[touched], g_in[touched])
          and counts["topk_scatter_reduce"] == 1 and sum(counts.values()) == 1,
          sent=int(touched.sum()), launches=counts)
    return {"sent": int(touched.sum()), "launches": counts}


def family_replay(name: str) -> float:
    """The card's uploads at reduced width, replayed in order through a CPU
    strategy of the same config: the new globals, and FedOpt's moments as
    they evolve, within rtol=atol=1e-6 of the card's (the reduces' summation
    order)."""
    from repro_torch.configs.base import get_config
    from repro_torch.utils.pytree import tree_flatten_to_vector

    log: dict = {"reported": []}
    card_log: list = []
    flower_loop(get_config("mobilenet-head-office31").reduced(), "cuda", 3, agg_log=card_log,
                fleet=MIXED_FLEET, make_strategy=family_strategy(name, log))
    cpu_strategy = family_strategy(name)(log["cost_model"], log["clients"])
    worst = 0.0
    for rnd, results, g_in, g_out, state in card_log:
        want = tree_flatten_to_vector(cpu_strategy.aggregate_fit(rnd, results, g_in))
        got = tree_flatten_to_vector(g_out)
        pairs = [(got, want)]
        if state:
            pairs.append((tree_flatten_to_vector(state),
                          tree_flatten_to_vector(cpu_strategy._server_state)))
        err = max(float((a - b).abs().max()) for a, b in pairs)
        worst = max(worst, err)
        check(f"{name}, reduced width: round {rnd} card global{' and state' if state else ''} = "
              f"the CPU strategy's on the same uploads (rtol=atol=1e-6)",
              all(torch.allclose(a, b, rtol=1e-6, atol=1e-6) for a, b in pairs),
              max_abs_err=err)
    return worst


def strategy_family_phase(card: str, out_dir: Path) -> dict:
    """Phase 3c: the rest of the strategy family behind Server.run on the
    mixed fleet (phones TopK, Jetsons Int8, datacenter Null)."""
    out = {name: family_run(name, card) for name in FAMILY}
    out["fedadam_topk_only"] = fedadam_topk_zeros_check()
    out["replay_max_abs_err"] = {name: family_replay(name) for name in FAMILY}
    out["profile_fedadam"] = profile_phase(card, out_dir, MIXED_FLEET,
                                           make_strategy=family_strategy("fedadam"),
                                           label="fedadam mixed fleet ")
    check("fedadam profiled round: the card did work", out["profile_fedadam"]
          ["round3_device_busy_ms"] > 0, busy_ms=out["profile_fedadam"]["round3_device_busy_ms"])
    return out


# ---------------- phase 3d: the paper's tables ----------------
def paper_tables_phase(card: str) -> dict:
    """The twin's table2a, table2b and table3 at their default arguments on
    the card and on the CPU: labels, simulated minutes and kJ equal (the
    cost arithmetic does not depend on the device), accuracy within 0.02;
    2a's time and energy rise with E, 2b's energy with C, and Table 3's
    cutoff rows take less time than the CPU fleet without one."""
    from repro_torch.benchmarks import paper_tables

    out = {}
    for name in ("table2a", "table2b", "table3"):
        table = getattr(paper_tables, name)
        t0 = time.perf_counter()
        rows = table(device="cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_rows = table(device="cpu")
        cpu_s = time.perf_counter() - t0
        for (label, acc, minutes, kj), (_, cpu_acc, _, _) in zip(rows, cpu_rows, strict=True):
            print(f"{name} {label}: acc {acc:.4f} (CPU {cpu_acc:.4f}), {minutes:.4f} sim min, "
                  f"{kj:.4f} sim kJ ({card})", flush=True)
        check(f"{name}: labels, minutes and kJ equal on the card and the CPU, accuracy within "
              f"0.02", [r[0] for r in rows] == [r[0] for r in cpu_rows]
              and all((a[2], a[3]) == (b[2], b[3]) and abs(a[1] - b[1]) <= 0.02
                      for a, b in zip(rows, cpu_rows)), card=rows, cpu=cpu_rows)
        out[name] = {"rows": rows, "cpu_rows": cpu_rows, "card_s": card_s, "cpu_s": cpu_s}
    t2a, t2b = out["table2a"]["rows"], out["table2b"]["rows"]
    check("table2a: time and energy rise with E",
          all(a[2] < b[2] and a[3] < b[3] for a, b in zip(t2a, t2a[1:])))
    check("table2b: energy rises with C", all(a[3] < b[3] for a, b in zip(t2b, t2b[1:])))
    t3 = {label: minutes for label, _, minutes, _ in out["table3"]["rows"]}
    check("table3: the cutoff rows take less time than CPU tau=0",
          t3["CPU tau=GPU"] < t3["CPU tau=0"] and t3["CPU tau=1.12xGPU"] < t3["CPU tau=0"],
          minutes=t3)
    return out


ENGINE_BUDGETS = [8, 7, 6, 5, 4, 3, 2, 8]   # the tau cutoff, in local steps
ENGINE_DROP = 3                             # the client masked out of round 2


def round_engine_phase(card: str, arch="mobilenet-head-office31", rounds: int = 3,
                       profiled=None) -> dict:
    """Phase 6 (and phase 10's leg c): make_round_step on ``arch`` at full
    width, parallel and sequential x Null / Int8 / TopK, ``rounds`` rounds
    each (8 clients, 8 local steps of batch 32; round 2 masks a client).
    Every round starts from launch counts of 0 and ends synchronized.  In
    each (mode, codec) case of ``profiled`` (every case where None) one
    more round, the same work as the last, runs under torch.profiler for
    the card's busy time; its idle share is taken against the last."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        FedAvg, Int8Codec, NullCodec, RoundSpec, TopKCodec, make_round_step,
    )
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_size

    c, steps, b = 8, 8, 32
    label = "engine" if arch == "mobilenet-head-office31" else f"{arch} engine"
    model = build_model(arch, device="cuda")
    params = model.init(0)
    n = tree_size(params)
    data = model_data(model, c * steps * b, seed=1)
    batches = {
        "x": torch.from_numpy(data.x.reshape(c, steps, b, *data.x.shape[1:])).cuda(),
        "y": torch.from_numpy(data.y.reshape(c, steps, b)).cuda(),
    }
    weights = torch.from_numpy(np.random.default_rng(2).integers(50, 400, c).astype(np.float32)).cuda()
    budgets = torch.tensor(ENGINE_BUDGETS, dtype=torch.int32, device="cuda")
    drop = torch.ones(c, device="cuda")
    drop[ENGINE_DROP] = 0.0
    # launches a round: (quantize, dequantize, dequant_reduce, topk_scatter_reduce)
    expect = {
        ("parallel", "NullCodec"): (0, 0, 0, 0), ("parallel", "Int8Codec"): (1, 1, 1, 0),
        ("parallel", "TopKCodec"): (0, 0, 0, 1), ("sequential", "NullCodec"): (0, 0, 0, 0),
        ("sequential", "Int8Codec"): (c, c, 0, 0), ("sequential", "TopKCodec"): (0, 0, 0, 0),
    }
    out, first_round = {}, {}
    for (mode, name), want in expect.items():
        codec = {"NullCodec": NullCodec(), "Int8Codec": Int8Codec(), "TopKCodec": TopKCodec()}[name]
        step = make_round_step(model.loss_fn, sgd(LOCAL_LR[model.arch.family]), FedAvg(),
                               RoundSpec(max_steps=steps, execution_mode=mode, codec=codec),
                               trainable_mask=trainable_mask_of(model, params))
        g, state = params, codec.init_client_state(c, n)
        losses, host_s, counts = [], [], []
        for rnd in range(rounds):
            mask = drop if rnd == 1 else None
            state_in = state
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            g, _, state, met = step(g, (), state, batches, weights, budgets, rnd, mask)
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t0)
            counts.append(ops.launch_counts())
            losses.append(float(met["client_loss_mean"]))
            if rnd == 0:
                first_round[(mode, name)] = tree_flatten_to_vector(g)
            if rnd == 1 and name != "NullCodec":
                check(f"{label} {mode} {name}: the dropped client's residual row is bitwise "
                      "unchanged",
                      torch.equal(state[ENGINE_DROP], state_in[ENGINE_DROP]))
        got = [(k["quantize_int8"], k["dequantize_int8"], k["dequant_reduce"],
                k["topk_scatter_reduce"]) for k in counts]
        check(f"{label} {mode} {name}: launches per round {want} "
              "(quantize, dequantize, dequant_reduce, topk_scatter_reduce), no fedavg_reduce",
              all(x == want for x in got) and all(k["fedavg_reduce"] == 0 for k in counts),
              launches=got)
        check(f"{label} {mode} {name}: client loss falls over {rounds} rounds",
              all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], loss=losses)
        check(f"{label} {mode} {name}: global params finite on cuda",
              bool(torch.isfinite(tree_flatten_to_vector(g)).all()) and tree_flatten_to_vector(g).is_cuda)
        out[f"{mode}/{name}"] = {"host_s": host_s, "loss": losses, "launches": got}
        seen = ""
        if profiled is None or (mode, name) in profiled:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            step(g, (), state, batches, weights, budgets, rounds, None)
            torch.cuda.synchronize()
            prof.stop()
            busy_us, by_kernel = device_time(prof)
            ours_us = sum(us for k, us in by_kernel.items()
                          if any(p in k for p in PORT_KERNELS))
            idle = 1.0 - busy_us / 1e6 / host_s[-1]
            out[f"{mode}/{name}"].update(device_busy_ms=busy_us / 1e3, port_kernels_us=ours_us,
                                         device_idle_share_vs_last_round=idle)
            seen = (f"; profiled round: card busy {busy_us / 1e3:.3f} ms (the port's kernels "
                    f"{ours_us:.1f} us), idle {idle:.4f} of round {rounds}")
        print(f"{label} {mode} {name}: host s per round {[round(x, 4) for x in host_s]}{seen} "
              f"({card})", flush=True)
    par, seq = first_round[("parallel", "NullCodec")], first_round[("sequential", "NullCodec")]
    check(f"{label}: parallel Null = sequential Null after round 1 within the bf16 "
          "accumulator's atol=rtol=2e-3 (tests/test_fl_engine.py:94)",
          torch.allclose(par, seq, rtol=2e-3, atol=2e-3), max_abs_err=float((par - seq).abs().max()))
    return out


# ---------------- phase 7: the mesh round step ----------------
MESH_AXES = ("pod", "data")
MESH_C, MESH_STEPS, MESH_B = 4, 8, 32
MESH_BUDGETS = [8, 7, 6, 5]
MESH_CASES = (("fp32", "Int8Codec"), ("int8", "Int8Codec"), ("int8", "NullCodec"),
              ("fp32", "TopKCodec"))
MESH_MASKED = ("int8", "Int8Codec")   # rank 0 sits out its round 2
# launches per rank per round: (quantize, dequantize, collective_absmax,
# collective_pack, collective_unpack); every other kernel 0
MESH_LAUNCHED = ("quantize_int8", "dequantize_int8", "collective_absmax", "collective_pack",
                 "collective_unpack")
MESH_LAUNCHES = {("fp32", "Int8Codec"): (1, 1, 0, 0, 0), ("int8", "Int8Codec"): (1, 1, 1, 1, 1),
                 ("int8", "NullCodec"): (0, 0, 1, 1, 1), ("fp32", "TopKCodec"): (0, 0, 0, 0, 0)}
# the int8 collective's all-reduces per rank per round, one each a tier:
# (MAX over the fp32 absmax, SUM over the int32 codes)
MESH_COLLECTIVE_CALLS = {"fp32": (0, 0), "int8": (2, 2)}
TRANSPORT = "gloo, host-staged, 4 ranks on one card"


def mesh_codec(name):
    from repro_torch.core import Int8Codec, NullCodec, TopKCodec

    return {"NullCodec": NullCodec, "Int8Codec": Int8Codec, "TopKCodec": TopKCodec}[name]()


def mesh_mask(case, rnd: int, c: int = MESH_C):
    """The clients' mask of a mesh round: in MESH_MASKED's round 2 client 0
    sits out; otherwise None (every client takes part)."""
    if case == MESH_MASKED and rnd == 1 and c == MESH_C:
        return np.asarray([0.0] + [1.0] * (c - 1), np.float32)
    return None


def mesh_inputs(model, dev):
    """The round engine's data for C = 4 clients (8 local steps of batch
    32), their weights and tau budgets, and an evaluation batch held out
    from the same draw (same class centres)."""
    c, steps, b = MESH_C, MESH_STEPS, MESH_B
    n_train, n_eval = c * steps * b, 512
    data = model_data(model, n_train + n_eval, seed=1)
    x, y = data.x[:n_train], data.y[:n_train]
    batches = {"x": torch.from_numpy(x.reshape(c, steps, b, *x.shape[1:])).to(dev),
               "y": torch.from_numpy(y.reshape(c, steps, b)).to(dev)}
    weights = torch.from_numpy(np.random.default_rng(2).integers(50, 400, c).astype(np.float32)).to(dev)
    budgets = torch.tensor(MESH_BUDGETS, dtype=torch.int32, device=dev)
    return batches, weights, budgets, {"x": torch.from_numpy(data.x[n_train:]).to(dev),
                                       "y": torch.from_numpy(data.y[n_train:]).to(dev)}


class QuantizeLog:
    """Keeps the value the last ``ops.quantize_int8`` call quantized (the
    Int8 uplink's delta plus its carried residual), on the host, while
    installed; the launch and its count stay the package's own."""

    def __init__(self):
        self.x = None

    def __enter__(self):
        from repro_torch.kernels import ops

        self.inner = ops.quantize_int8

        def logged(x, block=BLOCK):
            self.x = x.detach().to("cpu", torch.float32).numpy().reshape(-1)
            return self.inner(x, block=block)

        ops.quantize_int8 = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.quantize_int8 = self.inner


def mesh_rank(mesh, arch, cases, n_rounds: int, profiled: bool) -> dict:
    """One rank of phase 7 (and of phase 10's leg d): ``arch`` at full
    width, this rank's client, ``n_rounds`` rounds of every (collective,
    codec) case with the launch counts set to 0 before each round and read
    after it, then (with ``profiled``) one more round, rank 0's under
    torch.profiler.  Returns host data only: per round the host seconds,
    launches and metrics, rank 0's new global, this rank's uplink residual
    row and the value its Int8 uplink quantized, the all-reduces it made
    (MAX calls, SUM calls over int32, all calls), and for the int8
    collective rank 0's shared block scales and the largest |residual| /
    (scale / 2) of this rank's new collective residual row; the final
    global's digest and eval loss."""
    import hashlib

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FedAvg, RoundSpec, init_collective_residual, make_round_step
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves, tree_map, tree_size

    dev = torch.device("cuda", torch.cuda.current_device())
    # train as vmap_reference does (deterministic_convs): a rank is a
    # spawned process of its own, so the flags stay set until it ends
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = build_model(arch, device=dev)
    params = model.init(0)
    n = tree_size(params)
    batches, weights, budgets, ev = mesh_inputs(model, dev)
    r = mesh.rank

    # read the shared scales collective_pack_leaves derives (split per model
    # leaf), and count the all-reduces; the launches, the calls and their
    # counts stay the package's own
    packed, pack, calls, all_reduce = [], ops.collective_pack_leaves, [], dist.all_reduce

    def logged_pack(ds, wf, rs, absmax, live=None):
        q, scales, new_r = pack(ds, wf, rs, absmax, live)
        starts = ops.first_blocks(d.shape[0] for d in ds)
        packed.extend(scales[a:b] for a, b in zip(starts, starts[1:]))
        return q, scales, new_r

    def counted_all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((op == dist.ReduceOp.MAX, tensor.dtype))
        return all_reduce(tensor, op=op, group=group, async_op=async_op)

    ops.collective_pack_leaves, dist.all_reduce = logged_pack, counted_all_reduce

    def mine(t):
        return tree_map(lambda x: x[r:r + 1], t)

    def flat(tree):
        return tree_flatten_to_vector(tree).cpu().numpy()

    out = {}
    for collective, name in cases:
        codec = mesh_codec(name)
        step = make_round_step(
            model.loss_fn, sgd(LOCAL_LR[model.arch.family]), FedAvg(),
            RoundSpec(max_steps=MESH_STEPS, execution_mode="parallel", codec=codec,
                      collective=collective),
            trainable_mask=trainable_mask_of(model, params), mesh=mesh, client_axes=MESH_AXES,
        )
        state = codec.init_client_state(1, n, device=dev)
        if collective == "int8":
            state = (state, init_collective_residual(params, 1))
        g = params
        rec = {"host_s": [], "launches": [], "metrics": [], "params": [], "codec_rows": [],
               "uplink_x": [], "scales": [], "resid_over_half_scale": [], "all_reduces": []}
        for rnd in range(n_rounds):
            m = mesh_mask((collective, name), rnd)
            mask = None if m is None else torch.tensor(m[r:r + 1], device=dev)
            state_in = state
            torch.cuda.synchronize()
            dist.barrier()
            packed.clear()
            calls.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with QuantizeLog() as uplink:
                g, _, state, met = step(g, (), state, mine(batches), mine(weights),
                                        mine(budgets), rnd, mask)
                torch.cuda.synchronize()
            rec["host_s"].append(time.perf_counter() - t0)
            rec["launches"].append(ops.launch_counts())
            rec["all_reduces"].append((sum(is_max for is_max, _ in calls),
                                       sum(not m and t == torch.int32 for m, t in calls),
                                       len(calls)))
            rec["metrics"].append({k: float(v) for k, v in met.items()})
            rec["uplink_x"].append(uplink.x)
            if mask is not None:
                pairs = list(zip(tree_leaves(state_in), tree_leaves(state), strict=True))
                rec["masked_rows_same"] = all(torch.equal(a, b) for a, b in pairs)
                rec["rows_changed"] = any(not torch.equal(a, b) for a, b in pairs)
            if r == 0:
                rec["params"].append(flat(g))
            codec_state, coll = state if collective == "int8" else (state, None)
            rec["codec_rows"].append(flat(codec_state) if tree_leaves(codec_state) else None)
            if coll is not None:
                if r == 0:
                    rec["scales"].append([sc.cpu().numpy() for sc in packed])
                if m is None or m[r] > 0:
                    # round-half-even leaves |eff - code * s| <= s / 2
                    rec["resid_over_half_scale"].append(max(
                        float((row.reshape(-1).abs()
                               / (sc.repeat_interleave(BLOCK)[:row.numel()] / 2)).max())
                        for row, sc in zip(tree_leaves(coll), packed, strict=True)))
        flat_g = tree_flatten_to_vector(g)
        rec["params_sha"] = hashlib.sha256(flat_g.cpu().numpy().tobytes()).hexdigest()
        rec["eval_loss"] = float(model.loss_fn(g, ev)[0])
        if profiled:
            prof = profile(activities=[ProfilerActivity.CUDA]) if r == 0 else None
            torch.cuda.synchronize()
            dist.barrier()
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            step(g, (), state, mine(batches), mine(weights), mine(budgets), n_rounds, None)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
                busy_us, by_kernel = device_time(prof)
                rec["profile"] = {
                    "round_s": round_s, "busy_ms": busy_us / 1e3,
                    "idle_share_vs_last_round": 1.0 - busy_us / 1e6 / rec["host_s"][-1],
                    "memcpy_dtoh_us": sum(us for k, us in by_kernel.items() if "DtoH" in k),
                    "memcpy_htod_us": sum(us for k, us in by_kernel.items() if "HtoD" in k),
                    "port_kernels_us": sum(us for k, us in by_kernel.items()
                                           if any(p in k for p in PORT_KERNELS)),
                    "top": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6],
                }
        out[(collective, name)] = rec
    if profiled:
        out["breakdown"] = mesh_breakdown(mesh, model, params, mine(batches), mine(budgets))
    return out


def mesh_breakdown(mesh, model, params, batches, budgets) -> dict:
    """Where a mesh round's host seconds go, each part synchronized, the
    median of 5: one client's local update alone, and the fp32 collective's
    transport alone (every leaf's all-reduce over both tiers, inner first,
    on the card's tensors)."""
    import torch.distributed as dist

    from repro_torch.core import RoundSpec, make_client_update
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_leaves, tree_map

    update = make_client_update(model.loss_fn, sgd(LOCAL_LR[model.arch.family]),
                                RoundSpec(max_steps=MESH_STEPS, execution_mode="parallel"),
                                trainable_mask_of(model, params))
    groups = mesh.tier_groups(MESH_AXES)
    local, transport = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(params, tree_map(lambda x: x[0], batches), budgets[0])
        torch.cuda.synchronize()
        local.append(time.perf_counter() - t0)
        leaves = [x.clone() for x in tree_leaves(params)]
        dist.barrier()
        t0 = time.perf_counter()
        for x in leaves:
            for group in reversed(groups):
                dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        transport.append(time.perf_counter() - t0)
    return {"local_update_s": statistics.median(local),
            "fp32_allreduce_s": statistics.median(transport)}


def mesh_cases(card: str, arch: str, cases, n_rounds: int, profiled: bool):
    """Run ``cases`` on a ("pod", 2) x ("data", 2) mesh of 4 gloo ranks on
    the one card, ``arch`` at full width, each rank one client, and check
    every case: launches per rank per round, the collective's all-reduces,
    one global on every rank, client loss falling, the masked rank's rows,
    the collective residual, and every round against the vmap fp32 round
    step.  Returns (the ranks' records, the model, its init, the inputs,
    the per-case report, the spawn's wall seconds)."""
    from repro_torch.launch import run_local_mesh
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    ranks = run_local_mesh(mesh_rank, pod=2, data=2, backend="gloo", device="cuda",
                           args=(arch, cases, n_rounds, profiled), timeout_s=900)
    wall = time.perf_counter() - t0
    model = build_model(arch, device="cuda")
    params = model.init(0)
    inputs = mesh_inputs(model, torch.device("cuda"))
    out = {}
    prefix = "mesh" if arch == "mobilenet-head-office31" else f"{arch} mesh"
    for case in cases:
        collective, name = case
        recs = [rk[case] for rk in ranks]
        label = f"{prefix} {collective} collective x {name}"
        want = MESH_LAUNCHES[case]
        got = [[tuple(k[o] for o in MESH_LAUNCHED) for k in rec["launches"]] for rec in recs]
        others = all(k[o] == 0 for rec in recs for k in rec["launches"]
                     for o in ("fedavg_reduce", "dequant_reduce", "topk_scatter_reduce"))
        check(f"{label}: launches per rank per round {want} ({', '.join(MESH_LAUNCHED)}), "
              "no reduce kernel",
              all(x == want for g in got for x in g) and others, launches=got[0])
        calls = [[c[:2] for c in rec["all_reduces"]] for rec in recs]
        check(f"{label}: the collective's all-reduces per rank per round "
              f"{MESH_COLLECTIVE_CALLS[collective]} (MAX over fp32, SUM over int32; one each "
              "a tier)", all(c == MESH_COLLECTIVE_CALLS[collective] for g in calls for c in g),
              all_reduces=recs[0]["all_reduces"])
        check(f"{label}: the new global is the same on every rank",
              len({rec["params_sha"] for rec in recs}) == 1)
        losses = [m["client_loss_mean"] for m in recs[0]["metrics"]]
        check(f"{label}: client loss finite and falling over {n_rounds} rounds",
              all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], loss=losses)
        if case == MESH_MASKED:
            check(f"{label}: rank 0 masked in round 2 keeps its codec and collective "
                  "residual rows bitwise; the live ranks' rows changed",
                  recs[0]["masked_rows_same"] and all(rec["rows_changed"] for rec in recs[1:]))
        if collective == "int8":
            norms = [m["collective_residual_norm_mean"] for m in recs[0]["metrics"]]
            check(f"{label}: collective residual bounded (round {n_rounds} <= 3 x round 1)",
                  all(math.isfinite(x) for x in norms) and norms[-1] <= 3 * max(norms[0], 1e-12),
                  collective_residual_norm_mean=norms)
        vmap_reference(model, params, *inputs[:3], case, recs, label)
        prof = recs[0].get("profile")
        seen = "" if prof is None else (
            f"; profiled round: card busy {prof['busy_ms']:.3f} ms (the port's kernels "
            f"{prof['port_kernels_us']:.1f} us, Memcpy DtoH {prof['memcpy_dtoh_us']:.1f} us, "
            f"HtoD {prof['memcpy_htod_us']:.1f} us), idle {prof['idle_share_vs_last_round']:.4f} "
            f"of round {n_rounds}")
        print(f"{label}: host s per round {[round(x, 4) for x in recs[0]['host_s']]} (rank 0; "
              f"ranks' max {[round(max(rec['host_s'][i] for rec in recs), 4) for i in range(n_rounds)]})"
              f"{seen}; {TRANSPORT} ({card})", flush=True)
        out[f"{collective}/{name}"] = {
            "host_s": [rec["host_s"] for rec in recs], "launches": got[0],
            "all_reduces": recs[0]["all_reduces"],
            "metrics": recs[0]["metrics"], "eval_loss": recs[0]["eval_loss"], "profile": prof,
        }
    return ranks, model, params, inputs, out, wall


def mesh_phase(card: str) -> dict:
    """Phase 7: the mesh round step at full width on a ("pod", 2) x
    ("data", 2) mesh of 4 gloo ranks on the one card, each rank one client,
    3 rounds of every case in MESH_CASES; then a 1 x 1 mesh on NCCL.  The
    kernels were built by phase 1, so no rank compiles."""
    ranks, model, params, inputs, cases, wall = mesh_cases(
        card, "mobilenet-head-office31", MESH_CASES, 3, True)
    out = {"wall_s": wall, "transport": TRANSPORT, **cases}
    for name in ("Int8Codec", "NullCodec"):
        fp32 = out.get(f"fp32/{name}")
        fp32_s = "" if fp32 is None else (
            f" against the fp32 collective's {[round(x, 4) for x in fp32['host_s'][0]]}")
        print(f"mesh {name} uplink: the int8 collective's host s per round (rank 0) "
              f"{[round(x, 4) for x in out[f'int8/{name}']['host_s'][0]]}{fp32_s}; "
              f"{TRANSPORT} ({card})", flush=True)
    out["breakdown"] = ranks[0]["breakdown"]
    print(f"mesh round parts (rank 0, median of 5): local update "
          f"{out['breakdown']['local_update_s']:.4f} s, fp32 all-reduce of every leaf over "
          f"both tiers {out['breakdown']['fp32_allreduce_s']:.4f} s; {TRANSPORT} ({card})",
          flush=True)
    # the eval batch is held out from the training draw, so training moves
    # its loss: a collective that moved nothing would fail here
    l_0 = float(model.loss_fn(params, inputs[3])[0])
    l_fp = ranks[0][("fp32", "Int8Codec")]["eval_loss"]
    l_i8 = ranks[0][("int8", "Int8Codec")]["eval_loss"]
    check("mesh: held-out eval loss falls over 3 rounds, and the int8 collective's is within "
          "rel 5e-2 of fp32's (Int8 uplink)",
          l_fp < l_0 and l_i8 < l_0 and abs(l_i8 - l_fp) <= 5e-2 * abs(l_fp),
          eval_loss_init=l_0, eval_loss_int8=l_i8, eval_loss_fp32=l_fp)
    out["eval_loss"] = {"init": l_0, "fp32": l_fp, "int8": l_i8}
    out["launches"] = {k: sum(c[k] for case in MESH_CASES for c in ranks[0][case]["launches"])
                       for k in ("collective_absmax", "collective_pack", "collective_unpack")}
    out["nccl"] = nccl_single_rank(model, params, *inputs[:3], card)
    print(f"mesh phase: {wall:.1f} s wall for the 4 gloo ranks, spawn included ({card})",
          flush=True)
    return out


# vmap_reference's limits by model family: the largest |difference|
# between what a live client's Int8 uplink quantizes on its rank and in
# the reference, the share of uplink codes or TopK selections that may
# differ, and the metrics' rtol.  The head model's matmuls agree bitwise:
# phase 7's limits.  The ResNet's convs do not: vmap runs them through
# its batching rule, which sums in another order than a rank's direct
# calls even at C = 1 and with cuDNN deterministic in both (one client's
# 8 local steps 1.9e-4 to 2.9e-4 apart on an H100; 1e-3 allows 3x that);
# a code near a half-way point then differs (test_torch_mesh.py's
# RESNET_FLIPS) and the losses move with the updates (up to 3.9e-4
# relative on an H100).
MESH_VS_VMAP = {"head": (0.0, 1e-4, 1e-5), "cnn": (1e-3, 1e-2, 1e-3)}


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms, its autotuner off, while installed
    (a no-op for the head model, which runs no conv).  The mesh ranks and
    ``vmap_reference`` train the same client in two processes; without
    it, cuDNN's choices alone move one client's 8 local ResNet steps by up
    to 1.9e-4 between two equal calls (on an H100)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def vmap_reference(model, params, batches, weights, budgets, case, recs, label) -> None:
    """Each round of a mesh case against the port's vmap-parallel round
    step (no mesh, the same inputs), started from the state the mesh round
    started from (its global and uplink residual rows), so no difference
    carries into later rounds.  The step runs one client at a time (C = 1:
    vmap runs a conv of several clients as one grouped conv, which sums in
    another order than a rank's) under ``deterministic_convs``, as the
    ranks run, and the clients' results combine into the weighted mean in
    float64 on the host: new global, residual rows and metrics.

    The limits are the family's ``MESH_VS_VMAP`` (tol, flips, rtol).  What
    every live client's Int8 uplink quantizes (update plus carried
    residual) is within tol of its rank's (the head model: bitwise); at
    most flips of the uplink codes or TopK selections differ (a residual
    that moved past 2 tol).  Params within rtol=atol=1e-6 plus two a-priori
    terms, over the weight sum: with tol 0 a code or selection that
    differs moves its client's decoded delta by its residual's change
    (under one block scale: both residuals are under half of it), and
    otherwise every decoded entry may move by its quantized value's and
    its residual's changes, times the client's weight; and for the int8
    collective, each live client's carried residual and new residual,
    each at most half its shared block scale (round-half-even; every rank
    checks its new row against that), 1e-4 for fp32 rounding.  Metrics
    within rtol, with tol > 0 the mean residual norm also within the mean
    norm of the rows' gaps."""
    from repro_torch.core import FedAvg, RoundSpec, make_round_step
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import (
        tree_flatten_to_vector, tree_leaves, tree_map, tree_size, tree_unflatten_from_vector,
    )

    collective, name = case
    c = len(recs)
    tol, flips, rtol = MESH_VS_VMAP[model.arch.family]
    codec = mesh_codec(name)
    step = make_round_step(model.loss_fn, sgd(LOCAL_LR[model.arch.family]), FedAvg(),
                           RoundSpec(max_steps=MESH_STEPS, execution_mode="parallel", codec=codec),
                           trainable_mask=trainable_mask_of(model, params))
    dev = weights.device
    n = tree_size(params)
    sizes = [x.numel() for x in tree_leaves(params)]
    g, state = params, codec.init_client_state(c, n, device=dev)
    w = weights[:c].cpu().numpy().astype(np.float64)
    s_in = np.zeros((c, n), np.float32)  # the scale behind each client's carried residual
    if collective == "int8":
        ratio = max(x for rec in recs for x in rec["resid_over_half_scale"])
        check(f"{label}: every live rank's new collective residual within half its block "
              "scale, every round", ratio <= 1 + 1e-4, max_resid_over_half_scale=ratio)
    for rnd in range(len(recs[0]["params"])):
        m = mesh_mask(case, rnd, c)
        live = np.ones(c) if m is None else m.astype(np.float64)
        g0 = tree_flatten_to_vector(g).cpu().numpy().astype(np.float64)
        moved, rows_v, mets = [], [], []
        d_eff = np.zeros((c, n), np.float32)  # |quantized value, rank - reference|, live clients
        for k in range(c):
            with deterministic_convs(), QuantizeLog() as uplink:
                g_k, _, row, met = step(
                    g, (), tree_map(lambda x: x[k:k + 1], state),
                    {key: v[k:k + 1] for key, v in batches.items()}, weights[k:k + 1],
                    budgets[k:k + 1], rnd, None if m is None else torch.from_numpy(m[k:k + 1]).to(dev))
            moved.append(tree_flatten_to_vector(g_k).cpu().numpy() - g0)
            rows_v.append(None if not tree_leaves(row) else row.cpu().numpy()[0])
            mets.append({key: float(v) for key, v in met.items()})
            if uplink.x is not None and live[k] > 0:
                d_eff[k] = np.abs(uplink.x[:n] - recs[k]["uplink_x"][rnd])
        if recs[0]["uplink_x"][rnd] is not None:
            check(f"{label}: round {rnd + 1}: what every live client's Int8 uplink quantized "
                  "equals its rank's " + ("bitwise" if tol == 0 else f"within {tol:g}"),
                  float(d_eff.max()) <= tol, max_abs_err=float(d_eff.max()))
        wsum = float((w * live).sum())
        want = g0 + (w * live) @ np.stack(moved) / wsum
        got = recs[0]["params"][rnd]
        allowed, info, met_atol = np.zeros(n), {}, {}
        if recs[0]["codec_rows"][rnd] is not None:
            rows = np.stack([rec["codec_rows"][rnd] for rec in recs])
            gap = np.abs(rows - np.stack(rows_v))
            differs = gap > 1e-6 + 1e-6 * np.abs(rows) + 2 * tol
            info["uplink_entries_differing"] = int(differs.sum())
            check(f"{label}: round {rnd + 1}: uplink codes differing from the vmap round's "
                  f"at most {flips:g} of the entries",
                  differs.sum() <= flips * rows.size, **info)
            # |d decoded| <= |d quantized| + |d residual|
            allowed += (w * live) @ (gap * differs if tol == 0 else gap + d_eff)
            if tol > 0:  # the mean residual norm moves by at most the gaps' mean norm
                met_atol["residual_norm_mean"] = float(np.linalg.norm(gap, axis=1).mean())
            state = torch.from_numpy(rows).to(dev)
        if collective == "int8":
            s_now = np.concatenate([np.repeat(sc, BLOCK)[:k] for sc, k in
                                    zip(recs[0]["scales"][rnd], sizes, strict=True)])
            allowed += (live[:, None] * (s_in + s_now[None, :])).sum(axis=0) / 2 * (1 + 1e-4)
            s_in = np.where(live[:, None] > 0, s_now[None, :], s_in)
        err = np.abs(got - want)
        bound = 1e-6 + 1e-6 * np.abs(want) + allowed / wsum
        check(f"{label}: round {rnd + 1} = the vmap fp32 round from the same state within "
              "rtol=atol=1e-6 + the a-priori terms",
              bool(np.all(err <= bound)), max_abs_err=float(err.max()),
              worst_err_over_bound=float((err / bound).max()), **info)
        on = [k for k in range(c) if live[k] > 0]
        m_vmap = {
            "client_loss_mean": sum(w[k] * mets[k]["client_loss_mean"] for k in on) / wsum,
            "client_loss_max": max(mets[k]["client_loss_max"] for k in on),
            "steps_total": sum(mets[k]["steps_total"] for k in on),
            **({"residual_norm_mean": float(np.mean([x["residual_norm_mean"] for x in mets]))}
               if "residual_norm_mean" in mets[0] else {}),
        }
        m_mesh = recs[0]["metrics"][rnd]
        extra = {"collective_residual_norm_mean"} if collective == "int8" else set()
        check(f"{label}: round {rnd + 1} metrics = the vmap round's (rtol {rtol:g})",
              set(m_mesh) == set(m_vmap) | extra and all(
                  math.isclose(m_mesh[k], m_vmap[k], rel_tol=rtol, abs_tol=met_atol.get(k, 0.0))
                  for k in m_vmap),
              mesh=m_mesh, vmap=m_vmap)
        g = tree_unflatten_from_vector(torch.from_numpy(got).to(dev), params)


def nccl_single_rank(model, params, batches, weights, budgets, card) -> dict:
    """A 1 x 1 mesh on NCCL (one rank, client 0), one round of each
    collective with the Null uplink, against the C = 1 vmap round
    (``vmap_reference``): fp32 within rtol=atol=1e-6; int8 within that
    plus half the block scale over the weight, what one rank's pack ->
    unpack may round away."""
    from repro_torch.launch import run_local_mesh

    cases = (("fp32", "NullCodec"), ("int8", "NullCodec"))
    t0 = time.perf_counter()
    (rank,) = run_local_mesh(mesh_rank, pod=1, data=1, backend="nccl", device="cuda",
                             args=(model.arch.name, cases, 1, False), timeout_s=600)
    wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for case in cases:
        rec = rank[case]
        vmap_reference(model, params, batches, weights, budgets, case, [rec],
                       f"nccl 1x1 mesh, {case[0]} collective")
        want = 1 if case[0] == "int8" else 0
        check(f"nccl 1x1 mesh, {case[0]} collective: {want} collective_absmax, pack and unpack "
              f"launch, the collective's all-reduces {MESH_COLLECTIVE_CALLS[case[0]]}",
              all(rec["launches"][0][k] == want for k in
                  ("collective_absmax", "collective_pack", "collective_unpack"))
              and rec["all_reduces"][0][:2] == MESH_COLLECTIVE_CALLS[case[0]],
              launches=rec["launches"][0], all_reduces=rec["all_reduces"][0])
        out[case[0]] = {"host_s": rec["host_s"]}
    print(f"nccl 1x1 mesh: host s per round fp32 {out['fp32']['host_s'][0]:.4f}, int8 "
          f"{out['int8']['host_s'][0]:.4f}; {wall:.1f} s wall with spawn ({card})", flush=True)
    return out


# ---------------- phase 10: ResNet-18 / CIFAR-10 at full width ----------------
RESNET = "resnet18-cifar10"
RESNET_N = 11_173_962          # 62 leaves
RESNET_NP = 11_174_144         # the codec's padded length, 43,649 blocks
RESNET_TOPK_K = 111_739        # TopKCodec(frac=0.01).k_of(RESNET_N)
RESNET_INT8_WIRE = 11_348_558  # Int8Codec().wire_bytes(RESNET_N): N + 4 ceil(N / 256)
# leg b: 2 phones (TopK), 2 Jetsons (Int8), 2 datacenter-class clients (Null)
RESNET_MIXED_FLEET = ["pixel-4", "pixel-3", "jetson-tx2-gpu", "jetson-tx2-cpu",
                      "tpu-v5e-chip", "tpu-v5e-chip"]
RESNET_MESH_CASES = (("int8", "Int8Codec"),)
# leg c: the one engine case profiled (reading every case's profile took
# about a minute of the phase on an H100 host)
RESNET_ENGINE_PROFILED = (("parallel", "Int8Codec"),)
# cuDNN's convolution kernels, as the profiler names them
CONV_KERNELS = ("conv", "xmma", "implicit", "fprop", "dgrad", "wgrad", "cudnn")


def copy_of_ms(moved: int, dev) -> float:
    """A device copy moving ``moved`` bytes (half read, half written), timed
    as ``time_ms`` times a kernel."""
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src))


def resnet_kernel_checks(dev, card: str, head_rows: dict) -> dict:
    """Phase 10's kernels at ResNet-18's shapes: quantize_int8 and
    dequantize_int8 at N = 11,173,962 (Np = 11,174,144) and
    ``Int8Codec().encode`` bitwise their plain versions; dequant_reduce at
    C = 4, fedavg_reduce at C = 2 and topk_scatter_reduce at C = 4, k =
    111,739 bitwise the compositions they replaced with integer weights in
    both forms; the collective trio over the ResNet's 62 leaves at their
    real starts in one flat decode bitwise its plain versions.  Each timed
    through its ops wrapper and as a bare launch, beside its plain version,
    its library call where there is one, its bound and a device copy of
    the same bytes; the ratio to the copy printed beside the head model's
    (phase 2), whose operands fit in the 50 MB L2."""
    import torch.nn.functional as F

    from repro_torch.core.compression import Int8Codec
    from repro_torch.kernels import _cuda, collective_quant, ops, ref
    from repro_torch.kernels.scatter_reduce import workspace_ints
    from repro_torch.utils.pytree import safe_weight_sum, tree_leaves

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_kernel_models import (
        dequant_reduce_composition, dequant_reduce_one_launch, fedavg_one_launch,
    )

    def launch(lib, fn, counter, *args):
        return lambda: _cuda.launch(lib, fn, counter, dev, *args)

    rng = np.random.default_rng(62)
    nb = RESNET_NP // BLOCK
    rows = {}

    def row(name, replaces, moved, flops, ms, launch_ms, plain_ms, library_ms, shape, err):
        b_ms, b_by = bound(moved, flops)
        rows[name] = dict(
            source=head_rows[name]["source"], replaces=replaces, max_abs_err=err, ms=ms,
            launch_ms=launch_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
            bound_by=b_by, copy_ms=copy_of_ms(moved, dev), shape=shape, bytes=moved)

    # the Int8 uplink codec at N
    x = delta_like(rng, (RESNET_N,))
    xp = F.pad(x, (0, RESNET_NP - RESNET_N))
    q, s = ops.quantize_int8(x)
    qr, sr = ref.quantize_int8(xp)
    enc = Int8Codec().encode(x)
    check(f"resnet: quantize_int8 and Int8Codec().encode bitwise the plain version of x padded "
          f"with zeros [N={RESNET_N}, Np={RESNET_NP}], the wire {RESNET_INT8_WIRE} B",
          torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(enc["q"], qr)
          and torch.equal(enc["scale"], sr)
          and Int8Codec().wire_bytes(RESNET_N) == RESNET_INT8_WIRE,
          codes_differing=int((q != qr).sum()))
    xd = ops.dequantize_int8(q, s)
    check(f"resnet: dequantize_int8 bitwise [Np={RESNET_NP}]",
          torch.equal(xd, ref.dequantize_int8(qr, sr)))
    qo, so, xo = torch.empty_like(q), torch.empty_like(s), torch.empty_like(xd)
    row("quantize_int8", "src/repro/kernels/quantize.py:41", nbytes(x, q, s), 6 * RESNET_N,
        time_ms(lambda: ops.quantize_int8(x)),
        time_ms(launch("quantize", "repro_quantize_int8", "quantize_int8", x.data_ptr(),
                       qo.data_ptr(), so.data_ptr(), RESNET_N, nb)),
        time_ms(lambda: ref.quantize_int8(F.pad(x, (0, RESNET_NP - RESNET_N)))), None,
        f"x ({RESNET_N},) fp32", 0.0)
    rows["quantize_int8"]["encode_ms"] = time_ms(lambda: Int8Codec().encode(x))
    row("dequantize_int8", "src/repro/kernels/quantize.py:69", nbytes(q, s, xd), RESNET_NP,
        time_ms(lambda: ops.dequantize_int8(q, s)),
        time_ms(launch("quantize", "repro_dequantize_int8", "dequantize_int8", q.data_ptr(),
                       s.data_ptr(), xo.data_ptr(), nb)),
        time_ms(lambda: ref.dequantize_int8(q, s)),
        time_ms(lambda: torch.mul(q.view(-1, BLOCK), s[:, None])), f"q ({RESNET_NP},) int8", 0.0)
    del x, xp, xd, xo, qr, sr, enc

    # the Int8 reduce at the Jetson fleet's C = 4
    c = 4
    q4, s4 = ref.quantize_int8(delta_like(rng, (c * RESNET_NP,)))
    q4, s4 = q4.reshape(c, RESNET_NP), s4.reshape(c, nb)
    wi = torch.from_numpy(rng.integers(10, 500, c).astype(np.float32)).to(dev)
    outs = {nz: ops.dequant_reduce(q4, s4, wi, normalize=nz) for nz in (True, False)}
    check("resnet: dequant_reduce bitwise its one-launch model and the composition it "
          f"replaced, integer weights, normalize True and False [C={c}, Np={RESNET_NP}]",
          all(torch.equal(outs[nz], dequant_reduce_one_launch(q4, s4, wi, normalize=nz))
              and torch.equal(outs[nz], dequant_reduce_composition(q4, s4, wi, normalize=nz))
              for nz in (True, False)))
    err = float((outs[True] - ref.dequant_reduce(q4, s4, wi)).abs().max())
    outo = torch.empty_like(outs[True])
    row("dequant_reduce", "src/repro/kernels/dequant_reduce.py:77",
        nbytes(q4, s4, wi, outs[True]), 3 * q4.numel(),
        time_ms(lambda: ops.dequant_reduce(q4, s4, wi)),
        time_ms(launch("dequant_reduce", "repro_dequant_reduce", "dequant_reduce",
                       q4.data_ptr(), s4.data_ptr(), wi.data_ptr(), outo.data_ptr(), c,
                       RESNET_NP, 1)),
        time_ms(lambda: ref.dequant_reduce(q4, s4, wi)), None,
        f"q ({c}, {RESNET_NP}) int8", err)
    rows["dequant_reduce"]["normalize_false_ms"] = time_ms(
        lambda: ops.dequant_reduce(q4, s4, wi, normalize=False))
    del q4, s4, outs, outo

    # the Null reduce at the datacenter pair's C = 2
    c = 2
    u = delta_like(rng, (c, RESNET_N))
    wi = torch.from_numpy(rng.integers(10, 500, c).astype(np.float32)).to(dev)
    outs = {nz: ops.fedavg_reduce(u, wi, normalize=nz) for nz in (True, False)}
    check(f"resnet: fedavg_reduce bitwise the composition it replaced, integer weights, "
          f"normalize True and False [C={c}, N={RESNET_N}]",
          all(torch.equal(outs[nz], fedavg_one_launch(u, wi, normalize=nz))
              for nz in (True, False)))
    err = float((outs[True] - ref.fedavg_reduce(u, wi)).abs().max())
    outo, wn = torch.empty_like(outs[True]), wi / wi.sum()
    row("fedavg_reduce", "src/repro/kernels/fedavg_reduce.py:56", nbytes(u, wi, outs[True]),
        2 * u.numel(), time_ms(lambda: ops.fedavg_reduce(u, wi)),
        time_ms(launch("fedavg_reduce", "repro_fedavg_reduce_f32", "fedavg_reduce",
                       u.data_ptr(), wi.data_ptr(), outo.data_ptr(), c, RESNET_N, 1)),
        time_ms(lambda: ref.fedavg_reduce(u, wi)), time_ms(lambda: wn @ u),
        f"u ({c}, {RESNET_N}) fp32", err)
    del u, outs, outo

    # the TopK reduce at the phones' C = 4, k = 1% of N
    c, k = 4, RESNET_TOPK_K
    gen = torch.Generator(device=dev).manual_seed(62)
    idx, val, w = topk_payload(gen, c, k, RESNET_N, dev)
    outs = {nz: ops.topk_scatter_reduce(idx, val, w, RESNET_N, normalize=nz)
            for nz in (True, False)}
    check(f"resnet: topk_scatter_reduce bitwise the composition it replaced, integer weights, "
          f"normalize True and False [C={c}, k={k}, N={RESNET_N}]",
          all(torch.equal(outs[nz], topk_composition(idx, val, w, RESNET_N, normalize=nz))
              for nz in (True, False)))
    err = float((outs[True] - ref.topk_scatter_reduce(idx, val, w, RESNET_N)).abs().max())
    ws = torch.empty(workspace_ints(c, k, RESNET_N), dtype=torch.int32, device=dev)
    outo, wsum = torch.empty_like(outs[True]), safe_weight_sum(w)
    sidx, contrib = idx.reshape(-1).long(), (val * w[:, None]).reshape(-1)
    row("topk_scatter_reduce", "src/repro/kernels/scatter_reduce.py:108",
        nbytes(idx, val, w, outs[True]), 2 * idx.numel(),
        time_ms(lambda: ops.topk_scatter_reduce(idx, val, w, RESNET_N)),
        time_ms(launch("topk_scatter_reduce", "repro_topk_scatter_reduce", "topk_scatter_reduce",
                       idx.data_ptr(), val.data_ptr(), w.data_ptr(), outo.data_ptr(),
                       ws.data_ptr(), c, k, RESNET_N, ws.numel(), 1)),
        time_ms(lambda: ref.topk_scatter_reduce(idx, val, w, RESNET_N)),
        time_ms(lambda: torch.zeros(RESNET_N, device=dev).index_add_(0, sidx, contrib) / wsum),
        f"idx/val ({c}, {k}), N={RESNET_N}", err)
    del outs, outo, ws

    # the int8 collective's trio over the 62 leaves, at their real starts
    from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
    from repro_torch.models import resnet

    sizes = [t.numel() for t in tree_leaves(resnet.init_params(CNN_CONFIG, 0, device="cpu"))]
    ds = list(torch.split(delta_like(rng, (RESNET_N,)), sizes))
    starts = collective_quant.first_blocks(sizes)  # each leaf padded to whole blocks
    r_flat = delta_like(rng, (BLOCK * starts[-1],)) * 1e-3
    rs = [r_flat[BLOCK * b:BLOCK * b + n] for b, n in zip(starts, sizes)]
    wf = torch.full((1,), 123.0, device=dev)
    absmax = ops.collective_absmax(ds, wf, rs, None)
    cq, cs, new = ops.collective_pack_leaves(ds, wf, rs, absmax, None)
    total = ops.collective_unpack(cq, cs)
    plain = ref.collective_pack_leaves(ds, wf, rs, absmax, None)
    check(f"resnet: the collective trio over the {len(sizes)} leaves ({RESNET_N} values, "
          f"{sum(d.data_ptr() % 16 != 0 for d in ds)} starting off a 16-byte boundary): "
          "absmax, codes, scales, residuals and totals bitwise their plain versions",
          len(sizes) == 62 and sum(sizes) == RESNET_N
          and same_bits(absmax, ref.collective_absmax(ds, wf, rs, None))
          and torch.equal(cq, plain[0]) and same_bits(cs, plain[1])
          and same_bits(new, plain[2]) and same_bits(total, ref.collective_unpack(cq, cs)),
          codes_differing=int((cq != plain[0]).sum()))
    table, n_blocks = collective_quant._table(ds, rs)
    am_o, q_o, s_o, r_o, t_o = (torch.empty_like(t) for t in (absmax, cq, cs, new, total))
    shape = f"the ResNet's {len(sizes)} leaves (N = {RESNET_N}, Nb = {n_blocks})"
    row("collective_absmax", "src/repro/core/compression.py:1285",
        nbytes(*ds, *rs, wf, absmax), 3 * RESNET_N,
        time_ms(lambda: ops.collective_absmax(ds, wf, rs, None)),
        time_ms(launch("collective_quant", "repro_collective_absmax", "collective_absmax",
                       table, len(ds), wf.data_ptr(), None, am_o.data_ptr(), n_blocks)),
        time_ms(lambda: ref.collective_absmax(ds, wf, rs, None)), None, f"eff of {shape}", 0.0)
    row("collective_pack", "src/repro/kernels/collective_quant.py:57",
        nbytes(*ds, *rs, wf, absmax, cq, cs, new), 8 * RESNET_N,
        time_ms(lambda: ops.collective_pack_leaves(ds, wf, rs, absmax, None)),
        time_ms(launch("collective_quant", "repro_collective_pack", "collective_pack", table,
                       len(ds), wf.data_ptr(), None, absmax.data_ptr(), 1, q_o.data_ptr(),
                       s_o.data_ptr(), r_o.data_ptr(), n_blocks)),
        time_ms(lambda: ref.collective_pack_leaves(ds, wf, rs, absmax, None)), None,
        f"codes and residuals of {shape}", 0.0)
    row("collective_unpack", "src/repro/kernels/collective_quant.py:85",
        nbytes(cq, cs, total), cq.numel(), time_ms(lambda: ops.collective_unpack(cq, cs)),
        time_ms(launch("collective_quant", "repro_collective_unpack", "collective_unpack",
                       cq.data_ptr(), cs.data_ptr(), t_o.data_ptr(), n_blocks)),
        time_ms(lambda: ref.collective_unpack(cq, cs)),
        time_ms(lambda: torch.mul(cq.view(-1, BLOCK), cs[:, None])), f"totals of {shape}", 0.0)

    for name, r in rows.items():
        head = head_rows.get(name, {})
        at_head = ("" if "copy_ms" not in head else
                   f"; at the head model {head['ms'] / head['copy_ms']:.3f}x its copy")
        lib = "" if r["library_ms"] is None else f", library {r['library_ms'] * 1e3:.2f} us"
        print(f"resnet {name}: {r['shape']}: kernel {r['ms'] * 1e3:.2f} us (bare launch "
              f"{r['launch_ms'] * 1e3:.2f} us), plain {r['plain_ms'] * 1e3:.2f} us{lib}, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bytes'] / 1e6:.2f} MB), a device copy of the "
              f"same bytes {r['copy_ms'] * 1e3:.2f} us: {r['ms'] / r['copy_ms']:.3f}x the copy"
              f"{at_head} ({card})", flush=True)
    return rows


@contextlib.contextmanager
def instrumented_example(**probe):
    """``repro_torch.examples.heterogeneous_cutoff``, whose ``run`` builds
    its clients, strategy and a Server a tau run inside, with the module's
    ``Server`` swapped while installed for one that first calls
    ``instrument(clients, strategy, **probe)`` (each client once: both runs
    share them) and takes the logger it returns."""
    from repro_torch.examples import heterogeneous_cutoff as example

    real, seen = example.Server, set()

    def server(*, strategy, clients, **kw):
        fresh = [c for c in clients if id(c) not in seen]
        seen.update(id(c) for c in clients)
        return real(strategy=strategy, clients=clients,
                    logger=instrument(fresh, strategy, **probe), **kw)

    example.Server = server
    try:
        yield
    finally:
        example.Server = real


def resnet_example_leg(card: str, out_dir: Path) -> dict:
    """Leg (a): ``repro_torch.examples.heterogeneous_cutoff.run`` at full
    width on the card, both tau runs of 3 rounds (2 Jetson TX2 GPU and 2
    CPU clients, FedTau under BandwidthCodecPolicy: every uplink Int8).
    The launch counts are read and set to 0 at the end of every round:
    exactly 4 quantize, 4 dequantize and 1 dequant_reduce.  Every round's
    comm bytes are 4 Int8 wires at N (11,348,558 B each) and 4 downlinks
    of 4N; the cutoff cuts the CPU clients' budgets, History.steps and the
    simulated minutes; accuracy finite and rising in both runs.  The first
    run's round 2 is split into host seconds by stage and its round 3 runs
    under torch.profiler: the card's busy time and idle share (against
    round 2), the FL kernels' us against the convs'."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
    from repro_torch.examples import heterogeneous_cutoff as example
    from repro_torch.kernels import ops

    prof = profile(activities=[ProfilerActivity.CUDA])
    marks, by_round, stage_s, split = [], [], {}, {}

    def on_round():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        by_round.append(ops.launch_counts())
        ops.reset_launch_counts()
        if len(marks) == 1:
            stage_s.clear()
        elif len(marks) == 2:
            split.update(stage_s)
            prof.start()
        elif len(marks) == 3:
            prof.stop()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with instrumented_example(on_round=on_round, stage_s=stage_s):
        runs = example.run(CNN_CONFIG, device="cuda", rounds=3)
    want = {k: 0 for k in by_round[0]}
    want.update(quantize_int8=4, dequantize_int8=4, dequant_reduce=1)
    check("resnet example: launches per round 4 quantize, 4 dequantize, 1 dequant_reduce, "
          "nothing else (6 rounds)", len(by_round) == 6 and all(c == want for c in by_round),
          launches=[{k: v for k, v in c.items() if v} for c in by_round])
    per_round = 4 * (RESNET_INT8_WIRE + 4 * RESNET_N)
    out = {"launches_by_round": by_round, "runs": []}
    for run in runs:
        h, label = run["history"], run["label"]
        accs = [r.eval_acc for r in h.rounds]
        check(f"resnet example [{label}]: every round's comm bytes = 4 Int8 wires at N "
              f"({RESNET_INT8_WIRE} B) + 4 downlinks of 4N = {per_round}, accuracy finite and "
              "rising (round 3 > round 1)",
              all(r.comm_bytes == per_round for r in h.rounds)
              and all(math.isfinite(a) for a in accs) and accs[-1] > accs[0],
              comm_bytes=[r.comm_bytes for r in h.rounds], eval_acc=accs)
        out["runs"].append({"label": label, "tau_s": run["tau_s"], "budgets": run["budgets"],
                            "eval_acc": accs, "steps": [r.steps for r in h.rounds],
                            "sim_minutes": h.total_time_s / 60, "sim_kj": h.total_energy_j / 1e3,
                            "comm_bytes": [r.comm_bytes for r in h.rounds]})
    (b0, h0), (b1, h1) = ((r["budgets"], r["history"]) for r in runs)
    full = b0[0]
    check("resnet example: tau = 0 gives every client its full budget; tau = the GPU's round "
          "cuts the CPU clients' (1, 3) and no GPU client's, and with them History.steps and "
          "the simulated minutes",
          b0 == [full] * 4 and [b1[0], b1[2]] == [full, full] and b1[1] < full
          and b1[3] < full and all(x.steps < y.steps for x, y in zip(h1.rounds, h0.rounds))
          and h1.total_time_s < h0.total_time_s,
          budgets=[b0, b1], steps=[[r.steps for r in h.rounds] for h in (h0, h1)],
          tau_s=runs[1]["tau_s"])
    round_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    round2_s = marks[1] - marks[0]
    split["other"] = round2_s - sum(split.values())
    busy_us, by_kernel = device_time(prof)
    fl_us = sum(us for name, us in by_kernel.items() if any(k in name for k in PORT_KERNELS))
    conv_us = sum(us for name, us in by_kernel.items()
                  if any(k in name.lower() for k in CONV_KERNELS))
    export_gzipped_trace(prof, out_dir / "resnet_round3_trace.json")  # ~10^5 kernels
    out["profile"] = {
        "round2_host_s": round2_s, "round2_stage_s": split, "round3_device_busy_ms": busy_us / 1e3,
        "device_idle_share_vs_round2": 1.0 - busy_us / 1e6 / round2_s,
        "round3_fl_kernels_us": fl_us, "round3_conv_kernels_ms": conv_us / 1e3,
        "round3_top_device_us": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10],
    }
    out["round_wall_s"] = round_s
    check("resnet example: the profiled round's card did work, the FL kernels among it",
          busy_us > 0 and fl_us > 0, busy_ms=busy_us / 1e3, fl_kernels_us=fl_us)
    for run in out["runs"]:
        print(f"resnet example [{run['label']}]: acc {run['eval_acc']}, {run['sim_minutes']:.4f} "
              f"sim min, {run['sim_kj']:.4f} sim kJ, comm {run['comm_bytes'][0]} B a round, "
              f"step budgets {run['budgets']} ({card})", flush=True)
    print(f"resnet example: rounds {', '.join(f'{x:.4f}' for x in round_s)} s host wall; round 2 "
          f"host split {json.dumps({k: round(v, 4) for k, v in split.items()})} of "
          f"{round2_s:.4f} s; round 3 profiled: card busy {busy_us / 1e3:.3f} ms, idle "
          f"{out['profile']['device_idle_share_vs_round2']:.4f} of round 2, the FL kernels "
          f"{fl_us:.1f} us against the convs' {conv_us / 1e3:.3f} ms ({card})", flush=True)
    for name, us in out["profile"]["round3_top_device_us"]:
        print(f"  {us:10.1f} us  {name[:100]}", flush=True)
    return out


def resnet_example_replay(card: str) -> dict:
    """Leg (a) at reduced width on the card and on the CPU, 1 round each:
    every round's uploads that reached the card's ``aggregate_fit`` replayed
    through a CPU FedTau against the same global (rtol=atol=1e-6, the
    reduces' summation order), and the two runs' labels, budgets, comm
    bytes, simulated seconds and joules and steps equal, accuracy within
    0.02 (local SGD on cuDNN's convs and on the CPU's)."""
    from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
    from repro_torch.core import FedTau
    from repro_torch.examples import heterogeneous_cutoff as example
    from repro_torch.utils.pytree import tree_flatten_to_vector

    card_log: list = []
    with instrumented_example(agg_log=card_log):
        on_card = example.run(CNN_CONFIG.reduced(), device="cuda", rounds=1)
    on_cpu = example.run(CNN_CONFIG.reduced(), device="cpu", rounds=1)
    worst, strategy = 0.0, FedTau(local_epochs=3, local_lr=0.05)
    for rnd, results, g_in, g_out, _ in card_log:
        want = tree_flatten_to_vector(strategy.aggregate_fit(rnd, results, g_in))
        got = tree_flatten_to_vector(g_out)
        worst = max(worst, float((got - want).abs().max()))
        check(f"resnet example, reduced width: round {rnd} card aggregate = CPU aggregate of the "
              "same uploads (rtol=atol=1e-6)", torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              max_abs_err=float((got - want).abs().max()))

    def facts(run):
        return (run["label"], run["budgets"], [(r.comm_bytes, r.wall_time_s, r.energy_j, r.steps)
                                               for r in run["history"].rounds])

    accs = [(a["history"].final_accuracy(), b["history"].final_accuracy())
            for a, b in zip(on_card, on_cpu, strict=True)]
    check("resnet example, reduced width: card and CPU runs give equal labels, budgets, comm "
          "bytes, simulated seconds, joules and steps, accuracy within 0.02",
          [facts(r) for r in on_card] == [facts(r) for r in on_cpu]
          and all(abs(a - b) <= 0.02 for a, b in accs), accuracy_card_cpu=accs,
          replay_max_abs_err=worst)
    print(f"resnet example, reduced width: card vs CPU final accuracy {accs}; replay max abs "
          f"err {worst:.3e} ({card})", flush=True)
    return {"replay_max_abs_err": worst, "accuracy_card_cpu": accs}


def resnet_phase(card: str, out_dir: Path, head_rows: dict) -> dict:
    """Phase 10: ResNet-18 / CIFAR-10 at full width (N = 11,173,962, 62
    leaves) from init(0): the FL kernels at its shapes, then legs (a) the
    heterogeneous-cutoff example, its reduced-width card-vs-CPU replay, (b)
    the mixed fleet under FedAvg, 2 rounds, (c) the round engine, 2 rounds
    a case, (d) the mesh's int8 collective with the Int8 uplink, 2 rounds;
    each leg's seconds."""
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_size

    t0 = time.perf_counter()
    params = build_model(RESNET, device="cuda").init(0)
    check("resnet: full width, 62 leaves, N = 11,173,962 params on cuda",
          tree_size(params) == RESNET_N and len(tree_leaves(params)) == 62
          and all(t.is_cuda for t in tree_leaves(params)), n_params=tree_size(params))
    del params
    out = {"leg_seconds": {}}

    def leg(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        out["leg_seconds"][name] = time.perf_counter() - t
        return result

    out["kernels"] = leg("kernels", resnet_kernel_checks, torch.device("cuda"), card, head_rows)
    out["example"] = leg("a", resnet_example_leg, card, out_dir)
    out["example_replay"] = leg("a replay", resnet_example_replay, card)
    out["mixed_fleet"] = leg("b", mixed_fleet_phase, RESNET, RESNET_MIXED_FLEET, 2)
    out["engine"] = leg("c", round_engine_phase, card, RESNET, 2, RESNET_ENGINE_PROFILED)
    *_, out["mesh"], out["mesh_wall_s"] = leg("d", mesh_cases, card, RESNET, RESNET_MESH_CASES,
                                              2, False)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10 (ResNet-18): {out['seconds']:.2f} s, by leg "
          f"{json.dumps({k: round(v, 2) for k, v in out['leg_seconds'].items()})} ({card})",
          flush=True)
    return out


# ---------------- phase 11: population mode ----------------
HEAD = "mobilenet-head-office31"
# the mixed fleet's seven device classes, drawn uniformly: under
# BandwidthCodecPolicy the phones ship TopK, the Jetsons Int8 and the
# datacenter-class chip Null
POP_MIX = tuple(dict.fromkeys(MIXED_FLEET))
POP_N = 1_000_000             # leg a: the quickstart's scale, ten times over
POP_COHORT = 16
# leg b: a pool and a store smaller than what the rounds touch, so clients
# are evicted and rehydrated and store rows are evicted
POP_SPILL = dict(n_devices=48, pool_capacity=8, store_capacity=32, n_shards=8,
                 n_examples=1024)
POP_ENGINE_COHORT = [11, 5, 900_001, 3, 42, 77, 123_456, 8]   # leg c, C = 8
POP_SETUP_NS = (1_000, 1_000_000)                              # leg d
POP_SETUP_ROUNDS = 20
POP_SETUP_FLOOR_MS = 2.0      # benchmarks/population_bench.py's absolute floor
# leg e: benchmarks/straggler_bench.py's population row
STRAGGLER_N, STRAGGLER_COHORT, STRAGGLER_SHARD = 60, 8, 32
STRAGGLER_MIX = ("jetson-tx2-gpu", "pixel-2", "pixel-3")


def codec_group(name: str) -> str:
    """The codec BandwidthCodecPolicy gives device class ``name``."""
    from repro_torch.core import PROFILES, BandwidthCodecPolicy, ClientProperties

    p = PROFILES[name]
    return type(BandwidthCodecPolicy().codec_for(ClientProperties(
        client_id=0, device_profile=name, uplink_mbps=p.uplink_mbps,
        downlink_mbps=p.downlink_mbps))).__name__


def population_loop(arch, device, n_rounds: int, *, n_devices: int, pool_capacity: int = 64,
                    store_capacity: int = 4096, n_shards: int = 5,
                    n_examples: int = 2000, churn: bool = True, legacy: bool = False,
                    stage_s: dict | None = None, dispatched: list | None = None,
                    codec_policy=None, store_codec=None, **probe):
    """Population mode on ``arch``: ``Population.synthetic(n_devices,
    POP_MIX, seed=0)``, FedAvg under BandwidthCodecPolicy at the family's
    ``LOCAL_LR``, cohort ``POP_COHORT``, the ``from_profiles`` churn trace (with
    ``churn``), and a ``LazyClientPool`` whose clients share ``n_shards``
    shards of ``n_examples`` examples by ``cid % n_shards`` (as the
    quickstart's do) and spill their residuals into a ``CohortState`` (of
    TopK rows, or of ``store_codec``'s; ``codec_policy`` in place of
    BandwidthCodecPolicy).
    With ``legacy`` the same clients run as a list on the list-of-clients
    path.  With ``stage_s`` every pool materialization, ``sample_cohort``
    and client ``properties`` add their host seconds to it too; the rest of
    the probe goes to ``instrument``.  Returns the params, the cost model,
    (final, History), the pool and the population."""
    from repro_torch.core import (
        AvailabilityTrace, BandwidthCodecPolicy, CohortState, CostModel, FedAvg,
        LazyClientPool, Population, Server, TopKCodec, TorchClient, make_cost_model_for,
    )
    from repro_torch.data.federated import ClientDataset, dirichlet_partition
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_bytes, tree_size

    model = build_model(arch, device=device)
    shards = dirichlet_partition(model_data(model, n_examples, seed=0), n_clients=n_shards,
                                 alpha=1.0, seed=0)
    params = model.init(0)
    mask = trainable_mask_of(model, params)
    pop = Population.synthetic(n_devices, mix=POP_MIX, seed=0)
    strategy = FedAvg(local_epochs=2, local_lr=LOCAL_LR[model.arch.family],
                      codec_policy=BandwidthCodecPolicy() if codec_policy is None else codec_policy)

    def factory(cid):
        shard = shards[cid % n_shards]
        c = TorchClient(client_id=cid, loss_fn=model.loss_fn, batch_size=32,
                        dataset=ClientDataset(client_id=cid, x=shard.x, y=shard.y),
                        trainable_mask=mask, device_profile=pop.profile(cid).name, device=device)
        instrument_clients([c], stage_s, dispatched)
        if stage_s is not None:
            c.properties = stage_timed(c.properties, "properties", stage_s)
        return c

    logger = instrument([], strategy, stage_s=stage_s, **probe)
    trace = AvailabilityTrace.from_profiles(pop, seed=0) if churn else None
    if legacy:
        server = Server(strategy=strategy, clients=[factory(c) for c in range(n_devices)],
                        cost_model=make_cost_model_for(params, [pop.profile(c) for c in
                                                                range(n_devices)]),
                        availability=trace, device=device, logger=logger)
        return params, server.cost_model, server.run(params, num_rounds=n_rounds), None, pop
    if stage_s is not None:
        strategy.sample_cohort = stage_timed(strategy.sample_cohort, "sample_cohort", stage_s)
        factory = stage_timed(factory, "materialize", stage_s)
    store = CohortState(TopKCodec() if store_codec is None else store_codec, tree_size(params),
                        capacity=store_capacity, device=device)
    pool = LazyClientPool(pop, factory, capacity=pool_capacity, state_store=store)
    server = Server(strategy=strategy, clients=pool, population=pop, cohort_size=POP_COHORT,
                    cost_model=CostModel(profiles=[], update_bytes=tree_bytes(params),
                                         population=pop),
                    availability=trace, device=device, logger=logger)
    return params, server.cost_model, server.run(params, num_rounds=n_rounds), pool, pop


def population_scale_leg(card: str, out_dir: Path, dev="cuda", arch=HEAD) -> dict:
    """Leg (a): 10^6 devices of ``POP_MIX``, cohort 16, churn, FedAvg under
    BandwidthCodecPolicy, ``LazyClientPool(capacity=64)`` over a
    ``CohortState``, 3 rounds.  Every round: the launch counts (set to 0 at
    the end of the round before) against the dispatched codec groups --
    one quantize and one dequantize an Int8 client, one reduce a group that
    reported, nothing else --, the billed bytes against the cohort's wires,
    the pool's live clients.  Round 2's host seconds by stage, round 3
    under torch.profiler (its idle share against round 2)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import BandwidthCodecPolicy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_size

    prof = profile(activities=[ProfilerActivity.CUDA])
    stage_s, dispatched, marks, by_round, ids_by_round, splits = {}, [], [], [], [], []

    def on_round():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        by_round.append(ops.launch_counts())
        ops.reset_launch_counts()
        ids_by_round.append(list(dispatched))
        dispatched.clear()
        splits.append(dict(stage_s))
        stage_s.clear()
        if len(marks) == 2:
            prof.start()
        elif len(marks) == 3:
            prof.stop()

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cost_model, (final, history), pool, pop = population_loop(
        arch, dev, 3, n_devices=POP_N, stage_s=stage_s, dispatched=dispatched,
        on_round=on_round)
    n = tree_size(params)
    policy = BandwidthCodecPolicy()
    codecs = {"Int8Codec": policy.int8, "TopKCodec": policy.topk, "NullCodec": policy.null}
    label = f"population ({POP_N:,} devices, cohort {POP_COHORT})"
    check(f"{label}: packed fleet <= 2 bytes a device", pop.nbytes / len(pop) <= 2.0,
          bytes_per_device=pop.nbytes / len(pop))
    groups_by_round = []
    for rnd, (ids, counts, rec) in enumerate(zip(ids_by_round, by_round, history.rounds), 1):
        groups = {k: 0 for k in codecs}
        for cid in ids:
            groups[codec_group(pop.profile(cid).name)] += 1
        groups_by_round.append(groups)
        want = {k: 0 for k in counts}
        want.update(quantize_int8=groups["Int8Codec"], dequantize_int8=groups["Int8Codec"],
                    dequant_reduce=int(groups["Int8Codec"] > 0),
                    topk_scatter_reduce=int(groups["TopKCodec"] > 0),
                    fedavg_reduce=int(groups["NullCodec"] > 0))
        check(f"{label}: round {rnd} launches = its codec groups {groups} (a quantize and a "
              "dequantize an Int8 client, a reduce a group), nothing else",
              counts == want and rec.participants == len(ids) == POP_COHORT,
              launches={k: v for k, v in counts.items() if v}, participants=rec.participants)
        expect = (sum(codecs[codec_group(pop.profile(c).name)].wire_bytes(n) for c in ids)
                  + len(ids) * cost_model.update_bytes)
        check(f"{label}: round {rnd} comm_bytes = the cohort's codec wires + downlinks",
              rec.comm_bytes == expect, comm_bytes=rec.comm_bytes, expected=expect)
    check(f"{label}: the pool holds at most its 64 live clients, the global on cuda",
          pool.live <= pool.capacity and all(t.device.type == torch.device(dev).type
                                             for t in tree_leaves(final)),
          live=pool.live, materializations=pool.materializations)
    accs = [r.eval_acc for r in history.rounds]
    check(f"{label}: accuracy over the round's cohort finite and rising (round 3 > round 1)",
          all(math.isfinite(a) for a in accs) and accs[-1] > accs[0], eval_acc=accs)
    round_s = [b - a for a, b in zip(marks, marks[1:])]
    split = dict(splits[1])
    split["other"] = round_s[0] - sum(split.values())
    busy_us, by_kernel = device_time(prof)
    ours_us = sum(us for k, us in by_kernel.items() if any(p in k for p in PORT_KERNELS))
    idle = 1.0 - busy_us / 1e6 / round_s[0]
    export_gzipped_trace(prof, out_dir / "population_round3_trace.json")
    launches = {k: sum(c[k] for c in by_round) for k in by_round[0]}
    print(f"{label}: round 2 host split {json.dumps({k: round(v, 4) for k, v in split.items()})} "
          f"of {round_s[0]:.4f} s; round 3 profiled {round_s[1]:.4f} s: card busy "
          f"{busy_us / 1e3:.3f} ms, the FL kernels {ours_us:.1f} us, idle {idle:.4f} of round 2; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})} ({card})", flush=True)
    return {"launches": launches, "launches_by_round": by_round, "groups": groups_by_round,
            "round2_stage_s": split, "round_s": round_s, "round1_stage_s": splits[0],
            "run_wall_s": time.perf_counter() - t0, "round3_device_busy_ms": busy_us / 1e3,
            "round3_fl_kernels_us": ours_us, "device_idle_share_vs_round2": idle,
            "eval_acc": accs, "live": pool.live, "materializations": pool.materializations}


def population_spill_leg(card: str, dev="cuda", arch=HEAD) -> dict:
    """Leg (b): ``POP_SPILL`` (48 devices, cohort 16, a pool of 8 live
    clients over a store of 32 rows), 4 rounds: clients are evicted and
    rehydrated and store rows evicted.  Then the same loop at N == cohort
    size (no churn, the pool larger than the fleet) through population mode
    and the list path: History's time, energy, bytes, participants and
    losses equal, the final global bitwise.  Last, the spill run at reduced
    width on the card and the CPU, held as phase 4 holds the Flower loop."""
    from repro_torch.utils.pytree import tree_flatten_to_vector

    _, _, (final, history), pool, _ = population_loop(arch, dev, 4, **POP_SPILL)
    store = pool.state_store
    check("population spill: store evictions > 0 and materializations > live clients",
          store.evictions > 0 and pool.materializations > pool.live,
          store_evictions=store.evictions, store_rows=len(store),
          materializations=pool.materializations, live=pool.live,
          participants=[r.participants for r in history.rounds])
    accs = [r.eval_acc for r in history.rounds]
    check("population spill: accuracy finite, global on the card",
          all(math.isfinite(a) for a in accs)
          and tree_flatten_to_vector(final).device.type == torch.device(dev).type,
          eval_acc=accs)
    runs = {}
    for legacy in (False, True):
        _, _, runs[legacy], *_ = population_loop(
            arch, dev, 3, n_devices=POP_COHORT, pool_capacity=2 * POP_COHORT, churn=False,
            legacy=legacy, n_shards=8, n_examples=1024)
    (g_pop, h_pop), (g_leg, h_leg) = runs[False], runs[True]
    fields = ("wall_time_s", "energy_j", "comm_bytes", "participants", "steps", "train_loss",
              "eval_loss", "eval_acc")
    same = all(getattr(a, f) == getattr(b, f) for a, b in zip(h_pop.rounds, h_leg.rounds,
                                                              strict=True) for f in fields)
    check(f"population at N == cohort size ({POP_COHORT}) = the list path: History equal, "
          "the final global bitwise",
          same and torch.equal(tree_flatten_to_vector(g_pop), tree_flatten_to_vector(g_leg)),
          participants=[r.participants for r in h_pop.rounds],
          max_abs_err=float((tree_flatten_to_vector(g_pop) - tree_flatten_to_vector(g_leg))
                            .abs().max()))
    if torch.device(dev).type == "cuda":
        reduced_parity_phase(loop=lambda arch, device, **probe: population_loop(
            arch, device, 2, **POP_SPILL, **probe), name="population spill, reduced width")
    return {"store_evictions": store.evictions, "materializations": pool.materializations,
            "live": pool.live, "eval_acc": accs}


def population_engine_leg(card: str, dev="cuda", arch=HEAD) -> dict:
    """Leg (c): ``make_round_step`` (parallel) at full width, C = 8 (8 local
    steps of batch 32, phase 6's budgets), Int8 and TopK, 3 rounds with the
    residual rows resident only while sampled (``CohortState.gather`` /
    ``scatter`` over ``POP_ENGINE_COHORT``) against the same rounds with the
    state threaded on the card: globals and metrics bitwise every round,
    the threaded rows and ``store.gather`` after round 3 bitwise, phase 6's
    launches a round.  The eviction replay: a store of one row, each round
    bitwise the round with the lost rows zeroed by hand.  Then the gather
    and scatter of the (8, N) block timed beside one copy of its bytes
    each way."""
    from repro_torch.core import (CohortState, FedAvg, Int8Codec, RoundSpec, TopKCodec,
                                  make_round_step)
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_size

    c, steps, b = 8, 8, 32
    cohort = POP_ENGINE_COHORT
    model = build_model(arch, device=dev)
    params = model.init(0)
    n = tree_size(params)
    data = model_data(model, c * steps * b, seed=1)
    batches = {
        "x": torch.from_numpy(data.x.reshape(c, steps, b, *data.x.shape[1:])).to(dev),
        "y": torch.from_numpy(data.y.reshape(c, steps, b)).to(dev),
    }
    weights = torch.from_numpy(np.random.default_rng(2).integers(50, 400, c)
                               .astype(np.float32)).to(dev)
    budgets = torch.tensor(ENGINE_BUDGETS, dtype=torch.int32, device=dev)
    want = {"Int8Codec": (1, 1, 1, 0), "TopKCodec": (0, 0, 0, 1)}

    def same(a, b):
        return torch.equal(tree_flatten_to_vector(a), tree_flatten_to_vector(b))

    def same_metrics(a, b):
        return set(a) == set(b) and all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                                        for k in a)

    out = {}
    for name, codec in (("Int8Codec", Int8Codec()), ("TopKCodec", TopKCodec())):
        step = make_round_step(model.loss_fn, sgd(LOCAL_LR[model.arch.family]), FedAvg(),
                               RoundSpec(max_steps=steps, execution_mode="parallel", codec=codec),
                               trainable_mask=trainable_mask_of(model, params))
        g, state, threaded = params, codec.init_client_state(c, n, device=dev), []
        for rnd in range(3):
            g, _, state, met = step(g, (), state, batches, weights, budgets, rnd)
            threaded.append((g, met))
        store = CohortState(codec, n, capacity=16, device=dev)
        gp, counts, ok = params, [], []
        for rnd in range(3):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            dense = store.gather(cohort)
            gp, _, dense, met = step(gp, (), dense, batches, weights, budgets, rnd)
            store.scatter(cohort, dense)
            counts.append(ops.launch_counts())
            ok.append(same(gp, threaded[rnd][0]) and same_metrics(met, threaded[rnd][1]))
        got = [(k["quantize_int8"], k["dequantize_int8"], k["dequant_reduce"],
                k["topk_scatter_reduce"]) for k in counts]
        check(f"population engine {name}: 3 rounds through CohortState.gather / scatter bitwise "
              "the threaded rounds (globals, metrics), the rows after round 3 bitwise, launches "
              f"{want[name]} a round (quantize, dequantize, dequant_reduce, topk_scatter_reduce)",
              all(ok) and torch.equal(store.gather(cohort), state)
              and all(x == want[name] for x in got), rounds_bitwise=ok, launches=got)

        tight = CohortState(codec, n, capacity=1, device=dev)
        g1, g2, fresh = params, params, CohortState(codec, n, capacity=16, device=dev)
        ok = []
        for rnd in range(3):
            dense = tight.gather(cohort)
            g1, _, dense, m1 = step(g1, (), dense, batches, weights, budgets, rnd)
            tight.scatter(cohort, dense)
            zeroed = fresh.gather(cohort)
            zeroed[: c - 1] = 0.0  # what the tight store's evictions reset
            g2, _, zeroed, m2 = step(g2, (), zeroed, batches, weights, budgets, rnd)
            fresh.scatter(cohort, zeroed)
            ok.append(same(g1, g2) and same_metrics(m1, m2)
                      and bool(torch.isfinite(m1["residual_norm_mean"])))
        check(f"population engine {name}: after evictions (a store of 1 row) every round "
              "bitwise the round with the lost rows zeroed", all(ok) and tight.evictions > 0,
              rounds_bitwise=ok, evictions=tight.evictions)
        out[name] = {"launches": got}

    store = CohortState(Int8Codec(), n, capacity=16, device=dev)
    block = torch.randn(c, n, device=dev)
    host = torch.randn(c, n)
    store.scatter(cohort, block)

    def host_ms(fn, iters=7):
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    moved = c * n * 4
    out["copies"] = {
        "gather_ms": host_ms(lambda: store.gather(cohort)),
        "scatter_ms": host_ms(lambda: store.scatter(cohort, block)),
        "h2d_ms": host_ms(lambda: host.to(dev)),
        "d2h_ms": host_ms(lambda: block.cpu()),
        "bytes": moved,
    }
    r = out["copies"]
    print(f"population engine: gather of the (8, N) block {r['gather_ms']:.3f} ms, scatter "
          f"{r['scatter_ms']:.3f} ms; one copy of its {moved / 1e6:.1f} MB host to device "
          f"{r['h2d_ms']:.3f} ms, device to host {r['d2h_ms']:.3f} ms ({card})", flush=True)
    return out


def population_setup_leg(card: str, dev="cuda") -> dict:
    """Leg (d), ``benchmarks/population_bench.py``'s guard on the card: one
    round setup is ``CostAwareFedAvg.sample_cohort`` (availability streamed,
    deadline 30 s) + ``step_jitter_for`` + ``CohortState.gather`` of the
    cohort's (16, N) rows to the card + ``scatter`` back, at the head
    model's N; the median of 20 at 10^6 devices stays within 2x of (or
    2 ms above) the median at 10^3, and the fleet packs into <= 2 bytes a
    device."""
    from repro_torch.core import (AvailabilityTrace, CohortState, CostAwareFedAvg, CostModel,
                                  Population, TopKCodec)

    rows = {}
    for n_dev in POP_SETUP_NS:
        pop = Population.synthetic(n_dev, seed=0)
        trace = AvailabilityTrace.from_profiles(pop, seed=0, jitter_std=0.1)
        cm = CostModel(profiles=[], update_bytes=4 * N_PARAMS, population=pop)
        strategy = CostAwareFedAvg(expected_steps=20)
        store = CohortState(TopKCodec(frac=0.01), N_PARAMS, capacity=64, device=dev)
        times, sizes = [], []
        for rnd in range(1, POP_SETUP_ROUNDS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cohort = strategy.sample_cohort(rnd, pop, POP_COHORT, availability=trace,
                                            cost_model=cm, deadline_s=30.0)
            trace.step_jitter_for(rnd, cohort)
            dense = store.gather(cohort)
            store.scatter(cohort, dense + 1.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            sizes.append(len(cohort))
        rows[n_dev] = {"round_setup_ms": statistics.median(times), "min_ms": min(times),
                       "bytes_per_device": pop.nbytes / len(pop), "store_rows": len(store),
                       "store_evictions": store.evictions, "cohorts": sizes}
    small, big = (rows[k] for k in POP_SETUP_NS)
    t_small, t_big = small["round_setup_ms"], big["round_setup_ms"]
    check(f"population round setup flat in N: {t_big:.2f} ms at {POP_SETUP_NS[1]:,} devices "
          f"within 2x of (or {POP_SETUP_FLOOR_MS} ms above) {t_small:.2f} ms at "
          f"{POP_SETUP_NS[0]:,}; <= 2 bytes a device",
          t_big <= max(2.0 * t_small, t_small + POP_SETUP_FLOOR_MS)
          and big["bytes_per_device"] <= 2.0
          and all(s == POP_COHORT for r in rows.values() for s in r["cohorts"]),
          rows={k: {x: v[x] for x in ("round_setup_ms", "min_ms", "bytes_per_device")}
                for k, v in rows.items()})
    print(f"population round setup (C = {POP_COHORT}, N = {N_PARAMS:,}): median "
          + ", ".join(f"{r['round_setup_ms']:.3f} ms at {k:,} devices" for k, r in rows.items())
          + f" ({card})", flush=True)
    return {str(k): v for k, v in rows.items()}


def population_deadline_leg(card: str, dev="cuda", arch=HEAD) -> dict:
    """Leg (e), ``benchmarks/straggler_bench.py``'s population row on the
    card: 60 devices of ``STRAGGLER_MIX``, cohort 8, ``Deadline(tau)`` at
    1.25x a Jetson TX2 GPU's round (2 steps, the full model both ways), 3
    rounds each of ``CostAwareFedAvg`` and blind ``FedAvg``: every
    cost-aware cohort is predicted feasible, and the cost-aware run drops
    no more clients than the blind one."""
    from repro_torch.core import (PROFILES, CostAwareFedAvg, CostModel, Deadline, FedAvg,
                                  LazyClientPool, Population, Server, TorchClient,
                                  deadline_feasible)
    from repro_torch.data.federated import ClientDataset
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_bytes

    model = build_model(arch, device=dev)
    data = model_data(model, STRAGGLER_N * STRAGGLER_SHARD, seed=0)
    params = model.init(0)
    mask = trainable_mask_of(model, params)
    pop = Population.synthetic(STRAGGLER_N, mix=STRAGGLER_MIX, seed=0)
    cm = CostModel(profiles=[], update_bytes=tree_bytes(params), population=pop)
    spe = STRAGGLER_SHARD // 16
    jet = PROFILES["jetson-tx2-gpu"]
    tau = 1.25 * (spe * jet.step_time_s + jet.comm_time_s(cm.update_bytes, cm.update_bytes))
    out = {"tau_s": tau}
    for label, strategy in (
        ("cost-aware", CostAwareFedAvg(local_epochs=1, local_lr=0.1, expected_steps=spe)),
        ("blind", FedAvg(local_epochs=1, local_lr=0.1)),
    ):
        dispatched, by_round = [], []

        def factory(cid):
            lo = cid * STRAGGLER_SHARD
            c = TorchClient(client_id=cid, loss_fn=model.loss_fn, batch_size=16,
                            dataset=ClientDataset(client_id=cid, x=data.x[lo:lo + STRAGGLER_SHARD],
                                                  y=data.y[lo:lo + STRAGGLER_SHARD]),
                            trainable_mask=mask, device_profile=pop.profile(cid).name, device=dev)
            instrument_clients([c], dispatched=dispatched)
            return c

        def on_round():
            by_round.append(list(dispatched))
            dispatched.clear()

        server = Server(strategy=strategy,
                        clients=LazyClientPool(pop, factory, capacity=STRAGGLER_N), cost_model=cm, policy=Deadline(tau=tau), population=pop,
                        cohort_size=STRAGGLER_COHORT, device=dev,
                        logger=instrument([], strategy, on_round=on_round))
        _, hist = server.run(params, num_rounds=3)
        feasible = [bool(deadline_feasible(pop.expected_round_s(
            ids, steps=spe, up_bytes=cm.update_bytes, down_bytes=cm.update_bytes), tau).all())
            for ids in by_round]
        out[label] = {"dropped": sum(r.dropped for r in hist.rounds),
                      "participants": [r.participants for r in hist.rounds],
                      "predicted_feasible": feasible, "sim_s": hist.total_time_s,
                      "sim_j": hist.total_energy_j,
                      "classes": [sorted(pop.profile(c).name for c in ids) for ids in by_round]}
    aware, blind = out["cost-aware"], out["blind"]
    check(f"population under Deadline(tau = {tau:.3f} s): every cost-aware cohort predicted "
          "feasible, and it drops no more clients than blind sampling",
          all(aware["predicted_feasible"]) and aware["dropped"] <= blind["dropped"],
          aware={k: aware[k] for k in ("dropped", "participants", "predicted_feasible")},
          blind={k: blind[k] for k in ("dropped", "participants", "predicted_feasible")})
    return out


def population_phase(card: str, out_dir: Path) -> dict:
    """Phase 11: population mode on the head model at full width (N =
    1,974,303), legs (a) 10^6 devices with the codec fleet, (b) spill and
    rehydration, (c) the round engine over CohortState, (d) round setup flat
    in N, (e) cost-aware sampling under a Deadline."""
    t0 = time.perf_counter()
    out = {"scale": population_scale_leg(card, out_dir), "spill": population_spill_leg(card),
           "engine": population_engine_leg(card), "setup": population_setup_leg(card),
           "deadline": population_deadline_leg(card)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 (population mode): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 12: the scanned multi-round trainer ----------------
# tests/test_scan.py's mixed fleet (benchmarks/scan_bench.py's): one fast
# chip, two Jetsons, three phones; a Deadline at 1.25x a Jetson's round and
# the mobiles churning at 0.3 drop some clients in some rounds
SCAN_FLEET = ["tpu-v5e-chip", "jetson-tx2-gpu", "jetson-tx2-gpu", "pixel-2", "pixel-2", "pixel-3"]
SCAN_ROUNDS, SCAN_STEPS, SCAN_BATCH = 8, 8, 32
SCAN_TIMED_ROUNDS = (8, 32)
SCAN_CALLS = 5                # timed calls a driver, after one warm-up call
SCAN_LAUNCHED = ("quantize_int8", "dequantize_int8", "dequant_reduce", "topk_scatter_reduce")
# case -> (execution mode, codec, cohort size, strategy, launches a round of SCAN_LAUNCHED)
SCAN_CASES = {
    "parallel Null": ("parallel", "NullCodec", None, "FedAvg", (0, 0, 0, 0)),
    "parallel Int8": ("parallel", "Int8Codec", None, "FedAvg", (1, 1, 1, 0)),
    "parallel TopK cohort 4": ("parallel", "TopKCodec", 4, "FedAvg", (0, 0, 0, 1)),
    "sequential Int8": ("sequential", "Int8Codec", None, "FedAvg", (6, 6, 0, 0)),
    "parallel Null FedAdam": ("parallel", "NullCodec", None, "FedAdam", (0, 0, 0, 0)),
}
SCAN_POOL_SLACK = 0.05        # the graph's pool at R = 32 within 5% of R = 8's


def graph_nodes(graph) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a captured graph, read from its kept
    cudaGraph_t through the driver API."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(0), 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value


def window_device_time(prof, window: str) -> tuple[float, float, float, dict]:
    """(host us, card busy us, device span us, launches by name) of the
    device activity (kernels, copies, fills) inside the profiler window
    ``record_function(window)``, which ends synchronized.  The span runs
    from the first device activity's start to the last one's end; the
    window's own annotation on the device timeline is left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    w = next(e for e in events if e.name == window and e.device_type == DeviceType.CPU)
    lo, hi = w.time_range.start, w.time_range.end
    spans, names = [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA and lo <= e.time_range.start <= hi and e.name != window:
            spans.append((e.time_range.start, e.time_range.end))
            names[e.name] = names.get(e.name, 0) + 1
    span = max(b for _, b in spans) - min(a for a, _ in spans) if spans else 0.0
    return hi - lo, union_us(spans), span, names


def kernel_launches_in(names: dict, kernel: str) -> int:
    """Device launches of ``kernel`` (a `__global__` name) among profiler
    event names; dequantize_int8_kernel is not quantize_int8_kernel."""
    import re

    pat = re.compile(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])")
    return sum(n for name, n in names.items() if pat.search(name))


def scanned_trainer_phase(card: str, out_dir: Path, dev="cuda", arch=HEAD) -> dict:
    """Phase 12: Server.run_scanned (one CUDA graph of the whole run) on
    ``arch`` at full width over SCAN_FLEET, a Deadline and churn, 8 local
    steps of batch 32, each of SCAN_CASES at R = 8: the graph against the
    per-round driver (``reference=True``) bitwise on the final globals,
    every stacked output and the History; the launches of the warm-up
    round, of the capture (R times the round's) and of the reference run;
    a second call replays without a second capture, bitwise the first.
    Then parallel Int8 with one batch reused every round
    (``stacked_batches=False``) at R = 8 and 32: rounds/s of the graph and
    of the reference driver (the median of SCAN_CALLS calls after one
    warm-up call; capture apart), capture seconds, kernel nodes and the
    graph's memory pool (flat in R); one profiler session holds a replay
    of the Int8 and the TopK graph (each kernel's name R times a round's
    launches) and a reference run, for the card's idle share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.core as T
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_leaves, tree_size

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    model = build_model(arch, device=dev)
    params = model.init(0)
    n = tree_size(params)
    c, steps, b = len(SCAN_FLEET), SCAN_STEPS, SCAN_BATCH
    profiles = [T.PROFILES[p] for p in SCAN_FLEET]
    cm = T.CostModel(profiles=profiles, update_bytes=4 * n)
    tau = 1.25 * cm.client_round_cost(1, steps).t_total_s
    trace = T.AvailabilityTrace.from_profiles(profiles, seed=0, mobile_dropout=0.3,
                                              jitter_std=0.1)
    mask = trainable_mask_of(model, params)
    opt = sgd(LOCAL_LR[model.arch.family])
    data = model_data(model, SCAN_ROUNDS * c * steps * b, seed=5)
    stacked_batches = {
        "x": torch.from_numpy(data.x.reshape(SCAN_ROUNDS, c, steps, b, -1)).to(dev),
        "y": torch.from_numpy(data.y.reshape(SCAN_ROUNDS, c, steps, b)).to(dev),
    }
    one_batch = {k: v[0].clone() for k, v in stacked_batches.items()}
    weights = torch.from_numpy(
        np.random.default_rng(6).integers(50, 400, c).astype(np.float32)).to(dev)

    def server(case):
        _, _, cohort, strategy, _ = SCAN_CASES[case]
        srv = T.Server(strategy=getattr(T, strategy)(), clients=[], cost_model=cm,
                       policy=T.Deadline(tau=tau), availability=trace, cohort_size=cohort,
                       device=dev)
        srv.logger.quiet = True
        return srv

    def spec(case):
        mode, codec, *_ = SCAN_CASES[case]
        kw = {"frac": 0.05} if codec == "TopKCodec" else {}
        return T.RoundSpec(max_steps=steps, execution_mode=mode, codec=getattr(T, codec)(**kw))

    def run(srv, case, rounds, batches, stacked, reference=False):
        sync()
        ops.reset_launch_counts()
        out = srv.run_scanned(params, rounds, loss_fn=model.loss_fn, opt=opt, spec=spec(case),
                              batches=batches, weights=weights, stacked_batches=stacked,
                              trainable_mask=mask, reference=reference)
        sync()
        k = ops.launch_counts()
        return out, tuple(k[name] for name in SCAN_LAUNCHED) + (k["fedavg_reduce"],)

    def same(a, b) -> bool:
        (ga, ha, sa), (gb, hb, sb) = a, b
        return (all(torch.equal(x, y) for x, y in zip(tree_leaves(ga), tree_leaves(gb)))
                and set(sa) == set(sb)
                and all(sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k],
                                                                      equal_nan=True)
                        for k in sa)
                and repr(ha.rounds) == repr(hb.rounds))  # NaN-equal, every float exact

    R = SCAN_ROUNDS
    out = {"cases": {}, "timed": {}}
    servers, timed = {}, {}
    for case, (mode, codec, cohort, strategy, per_round) in SCAN_CASES.items():
        srv = servers[case] = server(case)
        first, counts = run(srv, case, R, stacked_batches, True)
        (multi, _), = srv._scan_fns.values()
        cap = multi.last_capture
        second, counts2 = run(srv, case, R, stacked_batches, True)
        ref, ref_counts = run(server(case), case, R, stacked_batches, True, reference=True)
        warm = tuple(cap["warmup_launches"][k] for k in SCAN_LAUNCHED)
        captured = tuple(cap["capture_launches"][k] for k in SCAN_LAUNCHED)
        want = tuple(R * x for x in per_round)
        hist = first[1]
        check(f"scanned {case}: the graph, R = {R}, bitwise the per-round driver (globals, "
              "every stacked output, the History)", same(first, ref),
              participants=[r.participants for r in hist.rounds],
              dropped=[r.dropped for r in hist.rounds])
        check(f"scanned {case}: launches of the warm-up round {per_round}, of the capture "
              f"R x that, of the reference run the same; none in a replay "
              "(quantize, dequantize, dequant_reduce, topk_scatter_reduce)",
              warm == per_round and captured == want and ref_counts[:4] == want
              and counts[:4] == tuple(w + x for w, x in zip(warm, captured))
              and counts2 == (0,) * 5 and counts[4] == ref_counts[4] == 0,
              warmup=warm, capture=captured, reference=ref_counts[:4], replay=counts2)
        check(f"scanned {case}: a second call replays the one graph (no second capture), "
              "bitwise the first", multi.captures == 1 and same(first, second))
        if case != "parallel Null FedAdam":
            losses = [r.train_loss for r in hist.rounds]
            check(f"scanned {case}: train loss finite and falling, some clients dropped and "
                  "some reporting", all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0] and sum(r.dropped for r in hist.rounds) > 0
                  and all(r.participants > 0 for r in hist.rounds), loss=losses)
        out["cases"][case] = {
            "capture_s": cap["seconds"], "pool_bytes": cap["pool_bytes"],
            "launches_capture": captured, "launches_reference": ref_counts[:4],
            "participants": [r.participants for r in hist.rounds],
            "dropped": [r.dropped for r in hist.rounds],
            "train_loss": [r.train_loss for r in hist.rounds],
            "wall_s": hist.total_time_s, "energy_j": hist.total_energy_j,
        }
        print(f"scanned {case}: R = {R}, capture {cap['seconds']:.3f} s, pool "
              f"{cap['pool_bytes'] / 2**20:.1f} MiB, launches captured {captured}, "
              f"participants {out['cases'][case]['participants']} ({card})", flush=True)

    # rounds/s with one batch reused every round, graph against the driver
    case = "parallel Int8"
    for rounds in SCAN_TIMED_ROUNDS:
        row = {}
        for driver, reference in (("graph", False), ("reference", True)):
            srv = timed[(rounds, driver)] = server(case)
            t0 = time.perf_counter()
            run(srv, case, rounds, one_batch, False, reference=reference)
            row[f"{driver}_first_call_s"] = time.perf_counter() - t0
            secs = []
            for _ in range(SCAN_CALLS):
                t0 = time.perf_counter()
                run(srv, case, rounds, one_batch, False, reference=reference)
                secs.append(time.perf_counter() - t0)
            row[f"{driver}_s"] = statistics.median(secs)
            row[f"{driver}_calls_s"] = secs
            row[f"{driver}_rounds_per_s"] = rounds / row[f"{driver}_s"]
            if not reference:
                (multi, _), = srv._scan_fns.values()
                cap = multi.last_capture
                row.update(capture_s=cap["seconds"], pool_bytes=cap["pool_bytes"],
                           captures=multi.captures)
                if dev == "cuda":
                    row["kernel_nodes"], row["graph_nodes"] = graph_nodes(cap["graph"])
        out["timed"][rounds] = row
        check(f"scanned {case}, R = {rounds}, one batch reused: one capture for "
              f"{1 + SCAN_CALLS} calls", row["captures"] == 1)
        print(f"scanned {case}, R = {rounds}, stacked_batches=False: graph "
              f"{row['graph_rounds_per_s']:.2f} rounds/s ({row['graph_s']:.4f} s a call), "
              f"reference {row['reference_rounds_per_s']:.2f} rounds/s "
              f"({row['reference_s']:.4f} s), capture {row['capture_s']:.3f} s apart, "
              f"{row.get('kernel_nodes')} kernel nodes of {row.get('graph_nodes')}, pool "
              f"{row['pool_bytes'] / 2**20:.2f} MiB ({card})", flush=True)
    lo, hi = (out["timed"][r] for r in SCAN_TIMED_ROUNDS)
    # what the longer run keeps beyond the shorter: its per-round outputs,
    # each a small block of the allocator (512 B), ten a round at most
    stacked_allowance = (SCAN_TIMED_ROUNDS[1] - SCAN_TIMED_ROUNDS[0]) * 10 * 512
    check(f"scanned {case}: the graph's memory pool flat in R (R = {SCAN_TIMED_ROUNDS[1]} "
          f"within {SCAN_POOL_SLACK:.0%} of R = {SCAN_TIMED_ROUNDS[0]}, apart from the "
          "stacked outputs)",
          hi["pool_bytes"] <= (1 + SCAN_POOL_SLACK) * lo["pool_bytes"] + stacked_allowance,
          pool_bytes={r: out["timed"][r]["pool_bytes"] for r in SCAN_TIMED_ROUNDS})

    # one profiler session: a call of the Int8 graph and of the reference
    # driver as timed above (R = 8), and a call of the TopK graph; the idle
    # share is the card's busy time against the unprofiled median call
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    windows = {
        "graph parallel Int8": (timed[(R, "graph")], case, one_batch, False, False),
        "reference parallel Int8": (timed[(R, "reference")], case, one_batch, False, True),
        "graph parallel TopK cohort 4": (servers["parallel TopK cohort 4"],
                                         "parallel TopK cohort 4", stacked_batches, True, False),
    }
    prof.start()
    for window, (srv, name, batches, stacked, reference) in windows.items():
        with record_function(window):
            run(srv, name, R, batches, stacked, reference=reference)
    prof.stop()
    export_gzipped_trace(prof, out_dir / "scanned_trace.json")
    prof_out = {}
    for window, (_, name, _, _, reference) in windows.items():
        host_us, busy_us, span_us, names = window_device_time(prof, window)
        got = tuple(kernel_launches_in(names, f"{k}_kernel") for k in SCAN_LAUNCHED)
        want = tuple(R * x for x in SCAN_CASES[name][4])
        check(f"scanned {window}: the profiled call shows each kernel R x a round's "
              "launches", got == want, launches=got)
        prof_out[window] = {"host_us": host_us, "busy_us": busy_us, "span_us": span_us,
                            "device_kernels": sum(names.values()), "launches": got}
        if name == case:
            call_us = lo["reference_s" if reference else "graph_s"] * 1e6
            prof_out[window]["idle"] = 1.0 - busy_us / call_us
        print(f"scanned profile, {window}, R = {R}: card busy {busy_us / 1e3:.3f} ms of a "
              f"{span_us / 1e3:.3f} ms device span, {sum(names.values())} device activities"
              + (f", idle {prof_out[window]['idle']:.4f} of the unprofiled call"
                 if "idle" in prof_out[window] else "") + f" ({card})", flush=True)
    out["profile"] = prof_out
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12 (scanned trainer): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 13: the segmented and mixed wire ----------------
# the head model's leaves as SegmentMap.from_tree names them: (name, offset)
HEAD_SEGMENTS = (("['base']['w']", 0), ("['head']['b1']", 1_638_400),
                 ("['head']['b2']", 1_638_656), ("['head']['w1']", 1_638_687),
                 ("['head']['w2']", 1_966_367))
LORA_WIRE = 18_103            # LoRACodec(rank=4, factor_codec=Int8Codec()) on the head map
LORA_SEGMENT_WIRE = (10_400, 260, 35, 6_240, 1_168)   # base.w a+b, the biases on Int8, w1, w2
INT8_WIRE = 2_005_155         # Int8Codec(), flat and on the head map alike
SEG_DROP = 4                  # leg c's masked client: the first Jetson, row 0 of the Int8 group
SEG_LAUNCHED = ("quantize_int8", "dequantize_int8", "dequant_reduce", "topk_scatter_reduce",
                "fedavg_reduce")
# launches a round of SEG_LAUNCHED, each derived from the codecs' structure:
# (a) Server.run on MIXED_FLEET, every codec on the 5-segment map: a
#     quantize and a dequantize an Int8 client and segment (4 x 5), one
#     reduce a codec group and segment (5 each);
SEG_SERVER_LAUNCHES = (20, 20, 5, 5, 5)
# (b) LoRA (Int8 factors) on the smoke fleet's 8 clients: a client encodes 3
#     LoRA segments as 2 factors each and the 2 biases on Int8 (8 quantize,
#     8 dequantize for its residual); the server densifies every client (8
#     dequantize each), no reduce
SEG_LORA_LAUNCHES = (64, 128, 0, 0, 0)
# (c) the round engine on MIXED_FLEET: the policy's bank (TopK, Int8, Null
#     groups) and a segmented bank of LoRA phones and Int8 for the rest
SEG_ENGINE_BANKS = {
    "policy bank": {"parallel": (1, 1, 1, 1, 0), "sequential": (4, 4, 0, 0, 0)},
    # parallel: LoRA's 3 segments x 2 factors + 2 fallback biases (8, 8, 2),
    # the Int8 group's 5 segments (5, 5, 5); sequential: 4 phones x 8, 6 x 5
    "LoRA + Int8 on the map": {"parallel": (13, 13, 7, 0, 0), "sequential": (62, 62, 0, 0, 0)},
}
# (e) the scanned trainer on SCAN_FLEET (a TPU-class chip, 2 Jetsons, 3 phones)
SEG_SCAN_CASES = {
    "mixed": (1, 1, 1, 1, 0),
    "Int8 on the map": (5, 5, 5, 0, 0),
    "mixed with LoRA phones, on the map": (13, 13, 7, 0, 0),
}
SEG_SCAN_CALLS = 3            # timed calls a driver, after the first


class OneCodec:
    """A codec policy that gives every client the same codec."""

    def __init__(self, codec):
        self.codec = codec

    def codec_for(self, properties):
        return self.codec


def launch_tuple(counts: dict) -> tuple:
    return tuple(counts[k] for k in SEG_LAUNCHED)


def only_these(counts: dict) -> bool:
    """No kernel outside SEG_LAUNCHED launched."""
    return not any(v for k, v in counts.items() if k not in SEG_LAUNCHED)


def head_segments(arch=HEAD, dev="cuda"):
    from repro_torch.core import SegmentMap
    from repro_torch.models import build_model

    return SegmentMap.from_tree(build_model(arch, device=dev).init(0))


def segmented_policy(segs):
    """BandwidthCodecPolicy with every codec on ``segs`` (None: flat)."""
    from repro_torch.core import BandwidthCodecPolicy

    base = BandwidthCodecPolicy()
    if segs is None:
        return base
    return BandwidthCodecPolicy(topk=base.topk.with_segments(segs),
                                int8=base.int8.with_segments(segs),
                                null=base.null.with_segments(segs))


def seg_flower_loop(arch, dev, n_rounds, fleet, codec_policy, **probe):
    from repro_torch.core import FedAvg

    return flower_loop(arch, dev, n_rounds, fleet=fleet, make_strategy=lambda cm, clients: FedAvg(
        local_epochs=2, local_lr=LOCAL_LR["head"], codec_policy=codec_policy), **probe)


def round_probe(prof=None, profiled_round: int = 3):
    """(on_round, stamps, by_round): the launch counts read and set to 0 at
    the end of every round, synchronized; with ``prof`` the profiler on for
    round ``profiled_round``."""
    from repro_torch.kernels import ops

    stamps, by_round = [], []

    def on_round():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        by_round.append(ops.launch_counts())
        ops.reset_launch_counts()
        if prof is not None and len(stamps) == profiled_round - 1:
            prof.start()
        elif prof is not None and len(stamps) == profiled_round:
            prof.stop()

    return on_round, stamps, by_round


def segmented_server_leg(card: str, segs, dev="cuda", arch=HEAD) -> dict:
    """Leg (a): Server.run on MIXED_FLEET with BandwidthCodecPolicy's three
    codecs on the head model's map, 3 rounds: SEG_SERVER_LAUNCHES a round;
    every wire's num_bytes its codec's wire_bytes; each round's grouped
    reduce against the per-client dense decode (on the CPU, float64); round 3
    profiled.  Then 2 rounds with the flat codecs and 2 with SegmentMap.flat:
    bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SegmentMap
    from repro_torch.core.strategy.base import Strategy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves

    prof = profile(activities=[ProfilerActivity.CUDA])
    on_round, stamps, by_round = round_probe(prof)
    agg_log: list = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cm, (final, hist) = seg_flower_loop(arch, dev, 3, MIXED_FLEET, segmented_policy(segs),
                                                on_round=on_round, agg_log=agg_log)
    n = segs.n_params
    got = [launch_tuple(c) for c in by_round]
    check("segmented wire, Server.run on the mixed fleet: launches a round "
          f"{SEG_SERVER_LAUNCHES} (quantize, dequantize, dequant_reduce, topk_scatter_reduce, "
          "fedavg_reduce: one reduce a codec group and segment), nothing else",
          all(g == SEG_SERVER_LAUNCHES for g in got) and all(only_these(c) for c in by_round),
          launches=got)
    wires = [(type(r.parameters.codec).__name__, r.parameters.num_bytes,
              r.parameters.codec.wire_bytes(n), r.parameters.codec.segments == segs)
             for _, results, *_ in agg_log for _, r in results]
    check("segmented wire: every CompressedParameters.num_bytes is its codec's wire_bytes, "
          "every codec on the head map",
          all(b == w and on_map for _, b, w, on_map in wires),
          wires=sorted({(k, b) for k, b, _, _ in wires}))
    errs = []
    for _, results, g_in, g_out, _ in agg_log:
        flat_in = tree_flatten_to_vector(g_in).double()
        rows = torch.stack([tree_flatten_to_vector(Strategy.fitres_parameters(r, g_in)).double()
                            for _, r in results]) - flat_in
        w = torch.tensor([float(r.num_examples) for _, r in results], dtype=torch.float64)
        want = (w[:, None] * rows).sum(0) / w.sum()
        out = tree_flatten_to_vector(g_out)
        gap = ((out.double() - flat_in) - want).abs()
        # 1e-6 of the largest averaged delta, plus the final fp32 add's rounding
        allowed = 1e-6 * float(want.abs().max()) + out.abs().double() * 2.0 ** -24
        errs.append((float(gap.max()), float(want.abs().max()), bool((gap <= allowed).all())))
    check("segmented wire: each round's grouped per-segment reduce is the per-client dense "
          "decode's weighted mean (float64, CPU) within 1e-6 of its largest value",
          all(ok for *_, ok in errs), max_abs_err=[e for e, _, _ in errs],
          largest=[m for _, m, _ in errs])
    accs = [r.eval_acc for r in hist.rounds]
    check("segmented wire: accuracy finite and rising", all(math.isfinite(a) for a in accs)
          and accs[-1] > accs[0], eval_acc=accs)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    busy_us, by_kernel = device_time(prof)
    ours_us = sum(us for k, us in by_kernel.items() if any(p in k for p in PORT_KERNELS))

    finals = {}
    for label, pol in (("flat", segmented_policy(None)),
                       ("SegmentMap.flat", segmented_policy(SegmentMap.flat(n)))):
        _, _, (g, h) = seg_flower_loop(arch, dev, 2, MIXED_FLEET, pol)
        finals[label] = (g, h)
    (ga, ha), (gb, hb) = finals.values()
    check("segmented wire: Server.run with SegmentMap.flat bitwise the flat codecs (TopK, "
          "Int8, Null), 2 rounds: the global and History",
          all(torch.equal(a, b) for a, b in zip(tree_leaves(ga), tree_leaves(gb)))
          and repr(ha.rounds) == repr(hb.rounds))
    print(f"segmented wire, Server.run on the mixed fleet (5 segments): host s per round "
          f"{[round(x, 4) for x in round_s]}; round 3 profiled: card busy {busy_us / 1e3:.3f} ms, "
          f"the port's kernels {ours_us:.1f} us, idle {1 - busy_us / 1e6 / round_s[1]:.4f} of "
          f"round 2 ({card})", flush=True)
    return {"launches": got, "round_wall_s": round_s, "device_busy_ms": busy_us / 1e3,
            "port_kernels_us": ours_us, "idle_share_vs_round2": 1 - busy_us / 1e6 / round_s[1],
            "dense_decode_max_abs_err": [e for e, _, _ in errs], "eval_acc": accs,
            "train_loss": [r.train_loss for r in hist.rounds]}


def lora_server_leg(card: str, segs, dev="cuda", arch=HEAD) -> dict:
    """Leg (b): LoRACodec(rank=4, factor_codec=Int8Codec()) on the head map
    for the smoke fleet's 8 clients, 3 rounds of Server.run: LORA_WIRE bytes
    a client, by segment LORA_SEGMENT_WIRE, against INT8_WIRE; the frozen
    base decodes to exact zeros; SEG_LORA_LAUNCHES a round; the loss falls."""
    from repro_torch.core import Int8Codec, LoRACodec
    from repro_torch.core.protocol import wire_to_enc
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves

    lora = LoRACodec(rank=4, factor_codec=Int8Codec()).with_segments(segs)
    n = segs.n_params
    on_round, stamps, by_round = round_probe()
    agg_log: list = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cm, (final, hist) = seg_flower_loop(arch, dev, 3, PROFILE_FLEET, OneCodec(lora),
                                                on_round=on_round, agg_log=agg_log)
    got = [launch_tuple(c) for c in by_round]
    sizes = {r.parameters.num_bytes for _, results, *_ in agg_log for _, r in results}
    by_seg = tuple(lora.segment_wire_bytes(s) for s in segs)
    check(f"LoRA wire: {LORA_WIRE:,} B a client (by segment {LORA_SEGMENT_WIRE}) against "
          f"{INT8_WIRE:,} for Int8, flat and on the map",
          sizes == {LORA_WIRE} == {lora.wire_bytes(n)} and by_seg == LORA_SEGMENT_WIRE
          and Int8Codec().wire_bytes(n) == Int8Codec().with_segments(segs).wire_bytes(n)
          == INT8_WIRE, sizes=sorted(sizes), by_segment=by_seg)
    base_zero = [bool((lora.decode_segment(wire_to_enc(r.parameters, dev).payloads[0], segs[0])
                       == 0).all())
                 for _, results, *_ in agg_log for _, r in results]
    check("LoRA wire: the frozen base.w decodes to exact zeros from every client's wire",
          all(base_zero), wires=len(base_zero))
    check(f"LoRA wire: launches a round {SEG_LORA_LAUNCHES} (Int8 factors and biases; the "
          "LoRA group densifies client by client, no reduce)",
          all(g == SEG_LORA_LAUNCHES for g in got) and all(only_these(c) for c in by_round),
          launches=got)
    losses = [r.train_loss for r in hist.rounds]
    check("LoRA wire: the train loss finite and falling", all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], loss=losses)
    check(f"LoRA wire: global params finite on {dev}",
          all(t.device.type == torch.device(dev).type and bool(torch.isfinite(t).all())
              for t in tree_leaves(final)))
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print(f"LoRA wire (rank 4, Int8 factors) on the smoke fleet: {LORA_WIRE:,} B a client "
          f"against {INT8_WIRE:,}; host s per round {[round(x, 4) for x in round_s]}; loss "
          f"{[round(x, 4) for x in losses]} ({card})", flush=True)
    return {"launches": got, "round_wall_s": round_s, "train_loss": losses,
            "eval_acc": [r.eval_acc for r in hist.rounds], "wire_bytes": LORA_WIRE}


def segmented_engine_leg(card: str, segs, dev="cuda", arch=HEAD) -> dict:
    """Leg (c): make_round_step on MIXED_FLEET (C = 10, 8 local steps of
    batch 32), parallel and sequential, for each of SEG_ENGINE_BANKS: round
    1, round 2 with SEG_DROP masked (and again with its data NaN: the
    global and every row bitwise, its own row carried unchanged), round 3,
    and a fourth round profiled (idle share against round 3)."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as T
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves

    c, steps, b = len(MIXED_FLEET), 8, 32
    model = build_model(arch, device=dev)
    params = model.init(0)
    n = segs.n_params
    data = model_data(model, c * steps * b, seed=1)
    batches = {
        "x": torch.from_numpy(data.x.reshape(c, steps, b, *data.x.shape[1:])).to(dev),
        "y": torch.from_numpy(data.y.reshape(c, steps, b)).to(dev),
    }
    garbled = {"x": batches["x"].clone(), "y": batches["y"]}
    garbled["x"][SEG_DROP] = float("nan")
    weights = torch.from_numpy(np.random.default_rng(2).integers(50, 400, c)
                               .astype(np.float32)).to(dev)
    budgets = torch.full((c,), steps, dtype=torch.int32, device=dev)
    drop = torch.ones(c, device=dev)
    drop[SEG_DROP] = 0.0
    phones = tuple(0 if p.startswith(("pixel", "galaxy")) else 1 for p in MIXED_FLEET)
    banks = {
        "policy bank": T.MixedCodec.from_policy(T.BandwidthCodecPolicy(),
                                                [T.PROFILES[p] for p in MIXED_FLEET]),
        "LoRA + Int8 on the map": T.MixedCodec(
            codecs=(T.LoRACodec(rank=4, factor_codec=T.Int8Codec()), T.Int8Codec()),
            assignment=phones).with_segments(segs),
    }
    out = {}
    for bank, codec in banks.items():
        g_drop = codec.assignment[SEG_DROP]
        row = codec.assignment[:SEG_DROP].count(g_drop)
        for mode, want in SEG_ENGINE_BANKS[bank].items():
            step = T.make_round_step(model.loss_fn, sgd(LOCAL_LR["head"]), T.FedAvg(),
                                     T.RoundSpec(max_steps=steps, execution_mode=mode, codec=codec),
                                     trainable_mask=trainable_mask_of(model, params))
            g, state = params, codec.init_client_state(c, n, device=dev)
            host_s, counts, losses = [], [], []
            for rnd in range(3):
                mask = drop if rnd == 1 else None
                state_in = state
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                g_new, _, state, met = step(g, (), state, batches, weights, budgets, rnd, mask)
                torch.cuda.synchronize()
                host_s.append(time.perf_counter() - t0)
                counts.append(ops.launch_counts())
                losses.append(float(met["client_loss_mean"]))
                if rnd == 1:
                    g_nan, _, s_nan, _ = step(g, (), state_in, garbled, weights, budgets, rnd, mask)
                    check(f"segmented engine {bank} {mode}: client {SEG_DROP} masked with NaN "
                          "data leaves the global and every residual row bitwise, its own "
                          "row carried unchanged",
                          all(torch.equal(x, y) for x, y in zip(tree_leaves(g_new),
                                                                tree_leaves(g_nan)))
                          and all(torch.equal(x, y) for x, y in zip(tree_leaves(state),
                                                                    tree_leaves(s_nan)))
                          and all(torch.equal(x[row], y[row])
                                  for x, y in zip(tree_leaves(state[g_drop]),
                                                  tree_leaves(state_in[g_drop]))))
                g = g_new
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            step(g, (), state, batches, weights, budgets, 3, None)
            torch.cuda.synchronize()
            prof.stop()
            busy_us, _ = device_time(prof)
            got = [launch_tuple(k) for k in counts]
            check(f"segmented engine {bank} {mode}: launches a round {want} (quantize, "
                  "dequantize, dequant_reduce, topk_scatter_reduce, fedavg_reduce), nothing else",
                  all(x == want for x in got) and all(only_these(k) for k in counts),
                  launches=got)
            check(f"segmented engine {bank} {mode}: the loss finite and falling over 3 rounds, "
                  "the global finite",
                  all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                  and bool(torch.isfinite(tree_flatten_to_vector(g)).all()), loss=losses)
            idle = 1.0 - busy_us / 1e6 / host_s[2]
            print(f"segmented engine {bank} {mode}: host s per round "
                  f"{[round(x, 4) for x in host_s]}; launches a round {want}; profiled round: "
                  f"card busy {busy_us / 1e3:.3f} ms, idle {idle:.4f} of round 3 ({card})",
                  flush=True)
            out[f"{bank}/{mode}"] = {"host_s": host_s, "loss": losses, "launches": got,
                                     "device_busy_ms": busy_us / 1e3,
                                     "idle_share_vs_round3": idle}
    return out


def segmented_population_leg(card: str, segs, dev="cuda", arch=HEAD) -> dict:
    """Leg (d): population mode with Int8Codec on the head map: Server.run
    over 10^6 devices, cohort 16, a pool of 8 spilling into a segmented
    CohortState, 2 rounds (5 quantize and 5 dequantize a dispatched client,
    5 dequant_reduce a round); the store's leafwise gather and scatter
    bitwise, an evicted device back as zeros; gather / scatter of the (8, N)
    block and a round setup at 10^6 devices (C = 16), against the flat
    store in turns."""
    from repro_torch.core import (AvailabilityTrace, CohortState, CostAwareFedAvg, CostModel,
                                  Int8Codec, Population)
    from repro_torch.kernels import ops

    int8s = Int8Codec().with_segments(segs)
    n = segs.n_params
    dispatched, marks = [], []
    count_round, stamps, by_round = round_probe()

    def on_round():
        count_round()
        marks.append(len(dispatched))

    ops.reset_launch_counts()
    _, _, (final, hist), pool, _ = population_loop(
        arch, dev, 2, n_devices=POP_N, pool_capacity=8, codec_policy=OneCodec(int8s),
        store_codec=int8s, dispatched=dispatched, on_round=on_round)
    fits = [b - a for a, b in zip([0] + marks[:-1], marks)]
    got = [launch_tuple(c) for c in by_round]
    reported = [r.participants for r in hist.rounds]
    want = [(5 * f, 5 * f, 5 if p else 0, 0, 0) for f, p in zip(fits, reported)]
    store = pool.state_store
    rows_ok = all(isinstance(r, tuple) and len(r) == len(segs)
                  and all(x.shape == (s.size,) for x, s in zip(r, segs))
                  for r in store._rows.values())
    check("segmented population: launches a round 5 quantize and 5 dequantize a fit, 5 "
          "dequant_reduce with reporters, nothing else; the pool spilled leafwise rows",
          got == want and all(only_these(c) for c in by_round) and len(store) > 0 and rows_ok,
          launches=got, fits=fits, reported=reported, spilled_rows=len(store))

    cohort = POP_ENGINE_COHORT
    rng = np.random.default_rng(7)
    seg_store = CohortState(int8s, n, capacity=len(cohort), device=dev)
    put = {cid: tuple(torch.from_numpy(rng.normal(size=s.size).astype(np.float32)) for s in segs)
           for cid in cohort}
    for cid, r in put.items():
        seg_store.put_row(cid, r)
    block = seg_store.gather(cohort)
    ok_gather = all(torch.equal(block[i][j].cpu(), put[cid][i])
                    for i in range(len(segs)) for j, cid in enumerate(cohort))
    seg_store.scatter(cohort, block)
    again = seg_store.gather(cohort)
    ok_scatter = all(torch.equal(a, b) for a, b in zip(block, again))
    seg_store.put_row(10**6 - 1, put[cohort[0]])  # one row past capacity: the oldest goes
    evicted = seg_store.gather([cohort[0]])
    check("segmented population store: leafwise gather bitwise the rows put in, scatter then "
          "gather bitwise, an evicted device back as zeros",
          ok_gather and ok_scatter and seg_store.evictions == 1
          and all(not bool(e.any()) for e in evicted))

    def host_ms(fn, iters=7):
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    flat_store = CohortState(Int8Codec(), n, capacity=16, device=dev)
    flat_store.scatter(cohort, torch.randn(len(cohort), n, device=dev))
    seg_block = tuple(torch.randn(len(cohort), s.size, device=dev) for s in segs)
    flat_block = torch.randn(len(cohort), n, device=dev)
    copies = {}
    for turn in ("flat", "segmented", "segmented", "flat"):
        st, blk = (flat_store, flat_block) if turn == "flat" else (seg_store, seg_block)
        copies.setdefault(turn, []).append((host_ms(lambda: st.gather(cohort)),
                                            host_ms(lambda: st.scatter(cohort, blk))))
    pop = Population.synthetic(POP_N, seed=0)
    trace = AvailabilityTrace.from_profiles(pop, seed=0, jitter_std=0.1)
    cm = CostModel(profiles=[], update_bytes=4 * n, population=pop)
    strategy = CostAwareFedAvg(expected_steps=20)
    setup = {}
    for turn in ("flat", "segmented", "segmented", "flat"):
        st = CohortState(Int8Codec() if turn == "flat" else int8s, n, capacity=64, device=dev)
        times = []
        for rnd in range(1, 11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = strategy.sample_cohort(rnd, pop, POP_COHORT, availability=trace, cost_model=cm,
                                         deadline_s=30.0)
            trace.step_jitter_for(rnd, ids)
            dense = st.gather(ids)
            st.scatter(ids, dense)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        setup.setdefault(turn, []).append(statistics.median(times))
    print(f"segmented population: (8, N) gather / scatter ms, segmented "
          f"{[tuple(round(x, 3) for x in t) for t in copies['segmented']]}, flat "
          f"{[tuple(round(x, 3) for x in t) for t in copies['flat']]}; round setup at "
          f"{POP_N:,} devices (C = {POP_COHORT}) segmented "
          f"{[round(x, 3) for x in setup['segmented']]} ms, flat "
          f"{[round(x, 3) for x in setup['flat']]} ({card})", flush=True)
    return {"launches": got, "fits": fits, "reported": reported,
            "gather_scatter_ms": copies, "round_setup_ms": setup,
            "train_loss": [r.train_loss for r in hist.rounds]}


def segmented_scan_leg(card: str, segs, dev="cuda", arch=HEAD) -> dict:
    """Leg (e): Server.run_scanned (one CUDA graph) on SCAN_FLEET with phase
    12's Deadline, churn and shape at R = 8, for each of SEG_SCAN_CASES: the
    graph bitwise the per-round driver (globals, stacked outputs, History),
    the warm-up round's launches and R times them in the capture, none in a
    replay; rounds/s of both drivers (the median of SEG_SCAN_CALLS calls
    after the first), capture seconds, kernel nodes, the graph's pool."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_leaves

    model = build_model(arch, device=dev)
    params = model.init(0)
    n = segs.n_params
    c, steps, b, R = len(SCAN_FLEET), SCAN_STEPS, SCAN_BATCH, SCAN_ROUNDS
    profiles = [T.PROFILES[p] for p in SCAN_FLEET]
    cm = T.CostModel(profiles=profiles, update_bytes=4 * n)
    tau = 1.25 * cm.client_round_cost(1, steps).t_total_s
    trace = T.AvailabilityTrace.from_profiles(profiles, seed=0, mobile_dropout=0.3, jitter_std=0.1)
    data = model_data(model, R * c * steps * b, seed=5)
    batches = {"x": torch.from_numpy(data.x.reshape(R, c, steps, b, -1)).to(dev),
               "y": torch.from_numpy(data.y.reshape(R, c, steps, b)).to(dev)}
    weights = torch.from_numpy(np.random.default_rng(6).integers(50, 400, c)
                               .astype(np.float32)).to(dev)
    # one optimizer and mask for every call: run_scanned's memo keys on their ids
    opt, mask = sgd(LOCAL_LR["head"]), trainable_mask_of(model, params)
    policy_bank = T.MixedCodec.from_policy(T.BandwidthCodecPolicy(), profiles)
    lora_bank = T.MixedCodec(
        codecs=(T.NullCodec(), T.Int8Codec(), T.LoRACodec(rank=4, factor_codec=T.Int8Codec())),
        assignment=policy_bank.assignment).with_segments(segs)
    codecs = {"mixed": policy_bank, "Int8 on the map": T.Int8Codec().with_segments(segs),
              "mixed with LoRA phones, on the map": lora_bank}
    check("segmented scan: the policy bank on SCAN_FLEET is Null, Int8, TopK by class",
          [type(policy_bank.codecs[g]).__name__ for g in policy_bank.assignment]
          == ["NullCodec", "Int8Codec", "Int8Codec", "TopKCodec", "TopKCodec", "TopKCodec"])

    def server():
        srv = T.Server(strategy=T.FedAvg(), clients=[], cost_model=cm, policy=T.Deadline(tau=tau),
                       availability=trace, device=dev)
        srv.logger.quiet = True
        return srv

    def run(srv, codec, reference=False):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = srv.run_scanned(params, R, loss_fn=model.loss_fn, opt=opt,
                              spec=T.RoundSpec(max_steps=steps, execution_mode="parallel",
                                               codec=codec),
                              batches=batches, weights=weights, trainable_mask=mask,
                              reference=reference)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, ops.launch_counts()

    def same(a, b) -> bool:
        (ga, ha, sa), (gb, hb, sb) = a, b
        return (all(torch.equal(x, y) for x, y in zip(tree_leaves(ga), tree_leaves(gb)))
                and set(sa) == set(sb)
                and all(np.array_equal(sa[k], sb[k], equal_nan=True) for k in sa)
                and repr(ha.rounds) == repr(hb.rounds))

    out = {}
    for case, per_round in SEG_SCAN_CASES.items():
        codec = codecs[case]
        srv = server()
        first, first_s, counts = run(srv, codec)
        (multi, _), = srv._scan_fns.values()
        cap = multi.last_capture
        graph_s, replay_counts = [], []
        for _ in range(SEG_SCAN_CALLS):
            again, secs, k = run(srv, codec)
            graph_s.append(secs)
            replay_counts.append(k)
        ref_srv = server()
        ref, _, ref_counts = run(ref_srv, codec, reference=True)
        ref_s = [run(ref_srv, codec, reference=True)[1] for _ in range(SEG_SCAN_CALLS)]
        warm = launch_tuple(cap["warmup_launches"])
        captured = launch_tuple(cap["capture_launches"])
        check(f"segmented scan {case}: the graph, R = {R}, bitwise the per-round driver and a "
              "replay bitwise the first call, one capture for all the calls",
              same(first, ref) and same(first, again) and multi.captures == 1
              and len(srv._scan_fns) == 1)
        check(f"segmented scan {case}: launches of the warm-up round {per_round}, of the "
              "capture R x that, of the reference run the same, none in a replay",
              warm == per_round and captured == tuple(R * x for x in per_round)
              and launch_tuple(ref_counts) == captured
              and not any(v for k in replay_counts for v in k.values()),
              warmup=warm, capture=captured, reference=launch_tuple(ref_counts))
        losses = [r.train_loss for r in first[1].rounds]
        check(f"segmented scan {case}: train loss finite and falling",
              all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], loss=losses)
        nodes = graph_nodes(cap["graph"])
        row = {"capture_s": cap["seconds"], "pool_bytes": cap["pool_bytes"],
               "kernel_nodes": nodes[0], "graph_nodes": nodes[1],
               "graph_rounds_per_s": R / statistics.median(graph_s), "graph_calls_s": graph_s,
               "reference_rounds_per_s": R / statistics.median(ref_s), "reference_calls_s": ref_s,
               "first_call_s": first_s, "launches_capture": captured,
               "dropped": [r.dropped for r in first[1].rounds], "train_loss": losses}
        out[case] = row
        print(f"segmented scan {case}: R = {R}, graph {row['graph_rounds_per_s']:.2f} rounds/s, "
              f"driver {row['reference_rounds_per_s']:.2f} rounds/s, capture "
              f"{cap['seconds']:.3f} s, {nodes[0]} kernel nodes of {nodes[1]}, pool "
              f"{cap['pool_bytes'] / 2**20:.1f} MiB ({card})", flush=True)
    return out


def segmented_wire_phase(card: str, out_dir: Path) -> dict:
    """Phase 13: the segmented and mixed wire on the head model at full
    width (N = 1,974,303 in 5 segments), legs (a) Server.run on the mixed
    fleet, every codec on the map, (b) LoRA on Server.run, (c) the round
    engine with two MixedCodec banks, (d) population mode with Int8 on the
    map, (e) the scanned trainer with MixedCodec, Int8 on the map and LoRA
    phones in the graph."""
    t0 = time.perf_counter()
    segs = head_segments()
    check("segmented wire: the head model's map is 5 segments at "
          + ", ".join(f"{name} {off:,}" for name, off in HEAD_SEGMENTS),
          tuple((s.name, s.offset) for s in segs) == HEAD_SEGMENTS
          and segs.n_params == N_PARAMS)
    out = {"server": segmented_server_leg(card, segs), "lora": lora_server_leg(card, segs),
           "engine": segmented_engine_leg(card, segs),
           "population": segmented_population_leg(card, segs),
           "scan": segmented_scan_leg(card, segs)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13 (the segmented and mixed wire): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phases 8-9: the transformer serving paths ----------------
QWEN3_PARAMS = 596_049_920    # qwen3-0.6b, embeddings tied
# xlstm-1.3b at full width, from the JAX package's init shapes
# (tests/test_torch_xlstm.py): 7,213,704,512 B in bf16
XLSTM_PARAMS = 3_579_976_016
# one 8-layer period of jamba-1.5-large-398b without its experts (phase 9),
# counted from the JAX package's init shapes (tests/test_torch_hybrid.py)
JAMBA_SLICE_PARAMS = 8_999_034_880
# a priori bounds for two bf16 runs of the same stack that round at other
# places (kernel against plain, card against CPU, prefill against decode):
# unit roundoff 2**-8 per rounding, errors adding in random directions over
# the roundings of the residual stream's inputs.  qwen3-0.6b: ~6 a layer,
# 28 layers, 2**-8 * sqrt(6 * 28) = 5.1e-2 relative L2 on the logits.  The
# Jamba slice: ~24 a layer (a mamba mixer rounds its conv's 4 products and
# 3 sums, the bias add, silu's 4 steps on x and on z, the scan's output,
# the gate product and 3 projections; the MLP ~8), 8 layers:
# 2**-8 * sqrt(24 * 8) = 5.4e-2
LOGITS_REL_L2 = 5e-2
JAMBA_LOGITS_REL_L2 = 2 ** -8 * math.sqrt(24 * 8)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64, on the card if either tensor is there
    (the host's float64 pass over a billion-parameter tree takes tens of
    seconds)."""
    dev = a.device if a.is_cuda else b.device
    a, b = a.to(dev).double(), b.to(dev).double()
    return float((a - b).norm() / b.norm())


class MoEProbe:
    """While active, records every call of the port's MoE layer: each
    token's chosen experts (sorted; their order moves no pair of the
    dispatch), the drop fraction, the aux terms, and the first call's
    params and input.
    It wraps ``router_topk`` and ``moe_forward`` in their module, where
    the transformer looks them up; the tensors stay on their device."""

    def __init__(self):
        self.routes, self.drops, self.aux, self.first = [], [], [], None

    def __enter__(self):
        from repro_torch.models.layers import moe

        self._moe, self._router, self._forward = moe, moe.router_topk, moe.moe_forward

        def router(cfg, params, x):
            topv, topi, aux = self._router(cfg, params, x)
            self.routes.append(torch.sort(topi, dim=-1).values)
            return topv, topi, aux

        def forward(cfg, params, x, **kw):
            if self.first is None:
                self.first = (params, x.clone())
            out, aux = self._forward(cfg, params, x, **kw)
            self.drops.append(aux["moe_drop_frac"])
            self.aux.append(aux)
            return out, aux

        moe.router_topk, moe.moe_forward = router, forward
        return self

    def __exit__(self, *exc):
        self._moe.router_topk, self._moe.moe_forward = self._router, self._forward

    def drop_fracs(self) -> list[float]:
        return [float(d) for d in self.drops]


def routing_flips(a: list, b: list) -> list[int]:
    """Per MoE call, the tokens whose chosen experts differ between two
    probes' records of the same calls."""
    assert len(a) == len(b), (len(a), len(b))
    return [int((x.cpu() != y.cpu()).any(-1).sum()) for x, y in zip(a, b)]


def frontend_of(cfg, rng, b: int, device) -> dict:
    """A config with frontend tokens: ``{"frontend": (b, F, frontend_dim)}``
    fp32 normals drawn from ``rng`` (as ``launch/serve.py`` draws them);
    otherwise ``{}``, drawing nothing."""
    if not cfg.frontend_tokens:
        return {}
    fd = cfg.frontend_dim or cfg.d_model
    fe = rng.normal(size=(b, cfg.frontend_tokens, fd)).astype(np.float32)
    return {"frontend": torch.from_numpy(fe).to(device)}


def serving_phase(card: str, out_dir: Path, *, cfg, tag: str, n_params: int,
                  prefill_launches: dict, step_launches: dict, rel_l2_bound: float,
                  cpu_prompt: int, cpu_layers: int | None = None,
                  cpu_bound: float | None = None,
                  consistency_cut: tuple[int, float] | None = None) -> dict:
    """One transformer at full width from ``init(seed)`` on the card,
    served through ``launch.serve.generate``: B=8, prompt 1024 (after the
    config's frontend embeddings, numpy-drawn fp32, if it has them),
    context 2048, 32 new tokens, with the launch counts set to 0 just before and
    read just after (exactly ``prefill_launches`` per prefill and
    ``step_launches`` per decode step, no other kernel).  The end-to-end
    rates come from unsynchronized ``generate`` runs, as a user calls it
    (one of 32 tokens and one of the prefill alone: repeats would take
    the script past its time limit); a
    further run synchronizes around each prefill / decode step to time and
    count it on its own.  Then one prefill and one decode step under the
    profiler (traces ``{tag}_{prefill,decode}_trace.json.gz``), the
    prefill/decode consistency check at full width
    within ``rel_l2_bound``, and the card against the CPU (on the first
    ``cpu_layers`` layers, views of the stacked leaves, within
    ``cpu_bound``; by default the whole stack within ``rel_l2_bound``).
    An MoE stack also runs ``moe_layer_phase``, and its consistency and
    CPU checks hold their bounds only where the runs compared route every
    token alike (and, prefill against decode, neither prefill dropped a
    pair): differing routings and drop fractions are reported.  An MLA
    stack also runs ``mla_layer_phase``, an xLSTM stack
    ``xlstm_layer_phase``.  With ``consistency_cut`` = (layers, bound) the
    consistency check is held on the stack's first ``layers`` layers
    within ``bound`` and the whole stack's error is reported beside it.  A
    frontend config's consistency check prefills the frontend and t[:-1]
    and decodes t[-1].  A trace whose gzipped size passes
    ``TRACE_LIMIT_BYTES`` is replaced by the profiler's per-op summary."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_size
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    check(f"{tag}: init(seed) on the card at full width", tree_size(params) == n_params
          and all(t.device.type == "cuda" for t in leaves), n_params=tree_size(params),
          init_s=init_s, param_bytes=sum(t.numel() * t.element_size() for t in leaves))

    calls = {"prefill": [], "decode_step": []}

    def timed(fn, log):
        def call(*args):
            torch.cuda.synchronize()
            before, t = ops.launch_counts(), time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            log.append((time.perf_counter() - t,
                        {k: after[k] - before[k] for k in after if after[k] != before[k]}))
            return out
        return call

    served = dataclasses.replace(model, prefill=timed(model.prefill, calls["prefill"]),
                                 decode_step=timed(model.decode_step, calls["decode_step"]))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT))
                              .astype(np.int32)).cuda()
    fe = frontend_of(cfg, rng, SERVE_B, device=model.device)
    batch = {"tokens": prompt, **fe}
    n_pos = SERVE_PROMPT + cfg.frontend_tokens

    def wall(n_tokens):
        t0 = time.perf_counter()
        gen = generate(model, params, prompt, n_tokens=n_tokens, context_len=SERVE_CONTEXT,
                       frontend=fe.get("frontend"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, gen

    wall(2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    wall_s, gen = wall(SERVE_TOKENS)  # the main path: one generate call, unsynchronized
    launches = ops.launch_counts()
    n_steps = SERVE_TOKENS - 1
    check(f"{tag}: generate's tokens", tuple(gen.shape) == (SERVE_B, SERVE_TOKENS)
          and gen.dtype == torch.int32 and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          shape=tuple(gen.shape))
    prefill_wall_s = wall(1)[0]

    # per call, synchronized around each: a per-layer statistic beside the rates
    ops.reset_launch_counts()
    again = generate(served, params, prompt, n_tokens=SERVE_TOKENS, context_len=SERVE_CONTEXT,
                     frontend=fe.get("frontend"))
    check(f"{tag}: the synchronized run generates the same tokens", torch.equal(again, gen))
    total = {k: prefill_launches.get(k, 0) + n_steps * step_launches.get(k, 0)
             for k in {**prefill_launches, **step_launches}}
    check(f"{tag}: exactly {prefill_launches} per prefill, {step_launches} per decode step, "
          "no other kernel", len(calls["prefill"]) == 1
          and len(calls["decode_step"]) == n_steps
          and calls["prefill"][0][1] == prefill_launches
          and all(c == step_launches for _, c in calls["decode_step"])
          and {k: v for k, v in launches.items() if v} == total
          and ops.launch_counts() == launches,
          launches=launches, prefill=calls["prefill"][0][1])
    prefill_s = calls["prefill"][0][0]
    step_s = [t for t, _ in calls["decode_step"]]
    decode_s = statistics.median(step_s)
    out = {
        "wall_s": wall_s, "prefill_only_wall_s": prefill_wall_s,
        "end_to_end_tokens_per_s": SERVE_B * SERVE_TOKENS / wall_s,
        "decode_tokens_per_s": SERVE_B * n_steps / (wall_s - prefill_wall_s),
        "prefill_ms": prefill_s * 1e3, "decode_ms_per_token": decode_s * 1e3,
        "decode_ms_all": [t * 1e3 for t in step_s],
        "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / prefill_s,
        "prefill_positions_per_s": SERVE_B * n_pos / prefill_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "init_s": init_s,
        "first_tokens": gen[:2].tolist(),
    }
    print(f"{tag} B={SERVE_B} prompt {SERVE_PROMPT}"
          f"{f' after {cfg.frontend_tokens} frontend positions' if fe else ''} "
          f"context {SERVE_CONTEXT}, "
          f"unsynchronized generate: {SERVE_TOKENS} tokens in "
          f"{wall_s:.4f} s ("
          f"{out['end_to_end_tokens_per_s']:.1f} tokens/s end to end), the prefill alone "
          f"{prefill_wall_s:.4f} s, so {n_steps} decode steps "
          f"{(wall_s - prefill_wall_s) * 1e3:.2f} ms ({out['decode_tokens_per_s']:.1f} tokens/s); "
          f"synchronized per call: prefill {prefill_s * 1e3:.2f} ms, decode step median "
          f"{decode_s * 1e3:.3f} ms (steps 2-{SERVE_TOKENS}: {min(step_s) * 1e3:.2f}-"
          f"{max(step_s) * 1e3:.2f}); peak {out['peak_memory_gb']:.2f} GB; launches {launches} "
          f"({card})", flush=True)

    # one prefill and one decode step under the profiler: card busy time,
    # the port's kernels, idle share against the unprofiled call's time
    with torch.inference_mode():
        for phase in ("prefill", "decode"):
            prof = profile(activities=[ProfilerActivity.CUDA])
            if phase == "prefill":
                torch.cuda.synchronize()
                prof.start()
                _, cache = model.prefill(params, batch, SERVE_CONTEXT)
                torch.cuda.synchronize()
                prof.stop()
                host_s = prefill_s
            else:
                tok = gen[:, :1].contiguous()
                for _ in range(3):
                    _, cache = model.decode_step(params, {"tokens": tok}, cache, SERVE_CONTEXT)
                torch.cuda.synchronize()
                prof.start()
                _, cache = model.decode_step(params, {"tokens": tok}, cache, SERVE_CONTEXT)
                torch.cuda.synchronize()
                prof.stop()
                host_s = decode_s
            busy_us, by_kernel = device_time(prof)
            port_us = {k: sum(us for name, us in by_kernel.items()
                              if any(p in name for p in names))
                       for k, names in SERVING_KERNELS.items()}
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            out[f"{phase}_profile"] = {
                "device_busy_ms": busy_us / 1e3, "port_kernels_us": port_us,
                "idle_share": 1.0 - busy_us / 1e6 / host_s, "top_device_us": top,
                "device_events": sum(1 for e in prof.events()
                                     if e.device_type == DeviceType.CUDA),
                **export_trace_or_summary(prof, out_dir / f"{tag}_{phase}_trace.json"),
            }
            prof_out = out[f"{phase}_profile"]
            kept = "the per-op summary kept instead" if "summary" in prof_out else "kept"
            print(f"{tag} {phase} profiled: card busy {busy_us / 1e3:.3f} ms, the port's "
                  f"kernels {({k: round(v, 1) for k, v in port_us.items() if v})} us; idle "
                  f"{prof_out['idle_share']:.4f} of the unprofiled {host_s * 1e3:.3f} ms; "
                  f"{prof_out['device_events']} device events, trace "
                  f"{prof_out['trace_gz_bytes']} B gzipped ({kept}) ({card})", flush=True)
            for name, us in top:
                print(f"  {us:10.1f} us  {name[:100]}", flush=True)
    del cache
    if cfg.moe is not None:
        out["moe"] = moe_layer_phase(model, params, prompt, card, tag=tag,
                                     decode_ms=decode_s * 1e3)
    if cfg.mla is not None:
        out["mla"] = mla_layer_phase(model, params, prompt, card, tag=tag)
    if any(spec.kind in XLSTM_ROUNDINGS for spec in cfg.layer_plan()):
        out["xlstm"] = xlstm_layer_phase(model, params, prompt, card, tag=tag)

    # prefill(t[:s]) + decode(t[s]) against prefill(t[:s+1]), at full width
    # (a frontend config's prefills both after the same frontend embeddings)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)).cuda()
    fe2 = {k: v[:2] for k, v in fe.items()}
    ctx = 512 + cfg.frontend_tokens

    def consistency(m, p):
        with torch.inference_mode():
            with MoEProbe() as whole:
                full, _ = m.prefill(p, {"tokens": toks, **fe2}, ctx)
            with MoEProbe() as parts:
                _, cache = m.prefill(p, {"tokens": toks[:, :-1], **fe2}, ctx)
                step, _ = m.decode_step(p, {"tokens": toks[:, -1:]}, cache, ctx)
        return full, step, whole, parts

    full, step, whole, parts = consistency(model, params)
    err = max(rel_l2(step[i, -1], full[i, -1]) for i in range(2))
    close = bool(torch.allclose(step.float(), full.float(), atol=0.15, rtol=0.15))
    n_moe = len(whole.routes)
    # the longer prefill's routing of each token against the shorter
    # prefill's (tokens 0-255) and the decode step's (token 256)
    flips = routing_flips(whole.routes, [
        torch.cat([a.view(2, 256, -1), b.view(2, 1, -1)], 1).view(2 * 257, -1)
        for a, b in zip(parts.routes[:n_moe], parts.routes[n_moe:])])
    drops = {"longer": whole.drop_fracs(), "shorter": parts.drop_fracs()[:n_moe]}
    held = not any(flips) and not any(drops["longer"] + drops["shorter"])
    max_abs_err = float((step.float() - full.float()).abs().max())
    if consistency_cut is None:
        check(f"{tag}, full width: prefill + decode = the longer prefill's logits (relative L2 "
              f"<= {rel_l2_bound:.4f}, elementwise atol = rtol = 0.15 as "
              "tests/test_models_smoke.py)"
              + (", held where no pair dropped and no routing differs" if n_moe else ""),
              not held or (err <= rel_l2_bound and close), rel_l2=err, held=held,
              max_abs_err=max_abs_err)
    else:
        layers, bound = consistency_cut
        full_c, step_c, _, _ = consistency(*first_layers(model, params, layers))
        err_c = max(rel_l2(step_c[i, -1], full_c[i, -1]) for i in range(2))
        check(f"{tag}, full width, the first {layers} layers: prefill + decode = the longer "
              f"prefill's logits (relative L2 <= {bound:.4f}, elementwise atol = rtol = 0.15 "
              f"as tests/test_models_smoke.py); the whole stack's reported",
              err_c <= bound and bool(torch.allclose(step_c.float(), full_c.float(),
                                                     atol=0.15, rtol=0.15)),
              rel_l2=err_c, whole_stack_rel_l2=err, whole_stack_max_abs_err=max_abs_err)
        out["prefill_decode_rel_l2_cut"] = {"layers": layers, "rel_l2": err_c}
        print(f"{tag} prefill + decode against the longer prefill: the first {layers} layers "
              f"{err_c:.3e} (bound {bound:.4f}), the whole stack {err:.3e}, max abs "
              f"{max_abs_err:.3f}, reported ({card})", flush=True)
        del full_c, step_c
    out["prefill_decode_rel_l2"] = err
    if n_moe:
        out["prefill_decode_moe"] = {"held": held, "routing_flips": flips, "drop_frac": drops}
        print(f"{tag} prefill + decode against the longer prefill: relative L2 {err:.3e} "
              f"({'held' if held else 'not held'} within {rel_l2_bound:.4f}); (token, layer) "
              f"routings differing {sum(flips)} of {2 * 257 * n_moe}; drop fractions, longer "
              f"prefill max {max(drops['longer']):.4f} mean "
              f"{statistics.mean(drops['longer']):.4f}, shorter max "
              f"{max(drops['shorter']):.4f} ({card})", flush=True)
    del full, step

    out["card_vs_cpu"] = card_vs_cpu(model, params, rng, card, tag=tag,
                                     bound=cpu_bound or rel_l2_bound, prompt_len=cpu_prompt,
                                     layers=cpu_layers)
    return out


def first_layers(model, params, layers: int):
    """The model cut to its first ``layers`` layers, on its device, and
    their params: views of the stacked leaves (per-layer views, the cut
    built without ``scan_layers``, where it ends inside one period)."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cut = dataclasses.replace(model.arch, n_layers=layers)
    period = model.arch.plan_period
    if cut.scan_layers and cut.plan_period == period:
        blocks = tree_map(lambda t: t[: layers // period], params["blocks"])
    elif cut.scan_layers:
        cut = dataclasses.replace(cut, scan_layers=False)
        blocks = tuple(tree_map(lambda t, j=i // period: t[j], params["blocks"][i % period])
                       for i in range(layers))
    else:
        blocks = params["blocks"][:layers]
    return build_model(cut, device=model.device), {**params, "blocks": blocks}


def card_vs_cpu(model, params, rng, card: str, *, tag: str, bound: float,
                prompt_len: int, layers: int | None = None) -> dict:
    """The same full-width bf16 params on the card and, copied, through the
    port on the CPU (the plain versions): a ``prompt_len``-token prompt
    (B=1; after the same frontend embeddings where the config has them)
    and 4 decode steps, both fed the CPU's greedy tokens.  Each
    step's logits within ``bound`` relative L2; the card's top-1 token
    equal to the CPU's wherever the CPU's top-1 / top-2 margin exceeds
    ``bound`` times its largest logit.  With ``layers``, both run the
    stack's first ``layers`` layers (views of the stacked leaves).  In an
    MoE stack the bound and the top-1 check hold at the steps up to the
    first whose routing differs anywhere between the two runs; the
    differing (token, layer) routings are reported."""
    import os

    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    torch.set_num_threads(os.cpu_count() or 1)
    if layers is not None:
        model, params = first_layers(model, params, layers)
    cpu_model = build_model(model.arch, device="cpu")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = torch.from_numpy(rng.integers(0, model.arch.vocab_size, (1, prompt_len))
                            .astype(np.int32))
    fe = frontend_of(model.arch, rng, 1, device="cpu")
    ctx, n_steps = 2 * (prompt_len + model.arch.frontend_tokens), 4
    t0 = time.perf_counter()
    with torch.inference_mode(), MoEProbe() as cpu_routes:
        logits, cache = cpu_model.prefill(cpu_params, {"tokens": toks, **fe}, ctx)
        cpu_logits, feed = [logits[0, -1]], []
        for _ in range(n_steps):
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            feed.append(tok)
            logits, cache = cpu_model.decode_step(cpu_params, {"tokens": tok}, cache, ctx)
            cpu_logits.append(logits[0, -1])
        cpu_s = time.perf_counter() - t0
    with torch.inference_mode(), MoEProbe() as card_routes:
        logits, cache = model.prefill(params, {"tokens": toks.cuda(),
                                               **{k: v.cuda() for k, v in fe.items()}}, ctx)
        card_logits = [logits[0, -1].cpu()]
        for tok in feed:
            logits, cache = model.decode_step(params, {"tokens": tok.cuda()}, cache, ctx)
            card_logits.append(logits[0, -1].cpu())
    del cpu_params, cache
    # (token, layer) routings differing a step: the prefill, then each decode step
    per_call = routing_flips(card_routes.routes, cpu_routes.routes)
    n_moe = len(per_call) // (n_steps + 1)
    flips = [sum(per_call[i * n_moe:(i + 1) * n_moe]) for i in range(n_steps + 1)]
    out = {"cpu_s": cpu_s, "rel_l2": [], "top1_equal": [], "margin_over_threshold": [],
           "layers": model.arch.n_layers, "routing_flips": flips if n_moe else None}
    for i, (g, c) in enumerate(zip(card_logits, cpu_logits, strict=True)):
        err = rel_l2(g, c)
        top2 = torch.topk(c.float(), 2)
        margin = float(top2.values[0] - top2.values[1])
        threshold = bound * float(c.float().abs().max())
        same = int(torch.argmax(g.float())) == int(top2.indices[0])
        out["rel_l2"].append(err)
        out["top1_equal"].append(same)
        out["margin_over_threshold"].append(margin / threshold)
        held = not any(flips[: i + 1])
        check(f"{tag}: card against CPU, full width ({model.arch.n_layers} layers), "
              f"{'prefill' if i == 0 else f'decode step {i}'}: logits within relative L2 "
              f"{bound:.4f}, top-1 equal where the CPU's margin exceeds the bound"
              + (", held where no routing differs" if n_moe else ""),
              not held or (err <= bound and (same or margin <= threshold)), held=held,
              rel_l2=err, top1_equal=same, margin=margin, threshold=threshold)
    print(f"{tag} card vs CPU (full width, {model.arch.n_layers} layers, B=1, "
          f"{prompt_len}-token prompt, {n_steps} steps): relative L2 "
          f"{[f'{e:.2e}' for e in out['rel_l2']]} (bound {bound:.4f}), top-1 equal "
          f"{out['top1_equal']}"
          + (f"; (token, layer) routings differing a step {flips} of "
             f"{[prompt_len * n_moe] + [n_moe] * n_steps}" if n_moe else "")
          + f"; CPU run {cpu_s:.1f} s ({card})", flush=True)
    return out


def dense_serving_phase(card: str, out_dir: Path) -> dict:
    """Phase 8: qwen3-0.6b at full width (28 layers, d_model 1024, 16 heads,
    8 KV heads, head_dim 128, d_ff 3072, vocab 151,936, bf16): 28 flash
    launches per prefill, 28 decode launches per step."""
    from repro_torch.configs.base import get_config

    cfg = get_config("qwen3-0.6b")
    return serving_phase(card, out_dir, cfg=cfg, tag="serving", n_params=QWEN3_PARAMS,
                         prefill_launches={"flash_attention": cfg.n_layers},
                         step_launches={"decode_attention": cfg.n_layers},
                         rel_l2_bound=LOGITS_REL_L2, cpu_prompt=128)


def hybrid_serving_phase(card: str, out_dir: Path) -> dict:
    """Phase 9: one 8-layer period of jamba-1.5-large-398b at full width
    without its experts (depth cut 72 -> 8, MoE removed; plan [mamba x 4,
    attn, mamba x 3]; d_model 8192, d_inner 16384, d_state 16, d_conv 4,
    64 heads, 8 KV heads, d_ff 24576, vocab 65,536, untied lm_head, bf16,
    stacked layers): 7 selective_scan and 1 flash launch per prefill, 1
    decode launch and no scan per step; the CPU check at a 32-token
    prompt."""
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), n_layers=8, moe=None)
    kinds = [spec.kind for spec in cfg.layer_plan()]
    return serving_phase(card, out_dir, cfg=cfg, tag="hybrid", n_params=JAMBA_SLICE_PARAMS,
                         prefill_launches={"selective_scan": kinds.count("mamba"),
                                           "flash_attention": kinds.count("attn")},
                         step_launches={"decode_attention": kinds.count("attn")},
                         rel_l2_bound=JAMBA_LOGITS_REL_L2, cpu_prompt=32)


# ---------------- phase 14: MoE and dense-family serving ----------------
# (tag, arch, depth cut or None, params counted from the JAX package's init
# shapes: tests/test_torch_moe.py).  Mixtral's 32 layers are 93.41 GB in
# bf16, more than the card holds: 16 layers are 46.97 GB.
SERVING_LEGS = (
    ("deepseek", "deepseek-moe-16b", None, 16_879_568_896),
    ("mixtral16", "mixtral-8x7b", 16, 23_482_470_400),
    ("granite", "granite-8b", None, 8_254_689_280),
    ("stablelm", "stablelm-3b", None, 2_795_443_200),
)
# Phase 14's a-priori bounds, derived as phases 8 and 9's are: 2**-8 *
# sqrt(roundings a layer * layers) relative L2 on the logits.  A layer's
# attention and norms round ~6 times on the residual stream's path (qwen3's
# count, DENSE_ROUNDINGS); an MoE feed-forward adds its gated FFN (the gate
# and up products, silu's 4 steps, the gate product, the down product: 8),
# the scale's cast to bf16 and its product (2), the k fold steps of the
# combine, and with shared experts their gated MLP (8) and its add (1):
# deepseek-moe-16b 8 + 2 + 6 + 9 = 25, mixtral-8x7b 8 + 2 + 2 = 12.
DENSE_ROUNDINGS = 6
# the MoE legs' card-against-CPU check runs the first 4 layers of the same
# weights (a full CPU copy would take 33.77 / 46.97 GB of host memory)
MOE_CPU_LAYERS = 4
# moe_forward on identical bf16 inputs, card against CPU: the chosen experts
# must be equal wherever the CPU's k-th / (k+1)-th router-logit gap exceeds
# this (the fp32 logits differ only in summation order, held within half of it)
MOE_GAP_EPS = 1e-3
MOE_CHECK_TOKENS = 128        # the layer check's positions of 2 prompts: CPU-sized


def moe_roundings(cfg) -> int:
    mc = cfg.moe
    return 8 + 2 + mc.top_k + (9 if mc.n_shared_experts else 0)


def moe_layer_phase(model, params, prompt, card: str, *, tag: str, decode_ms: float) -> dict:
    """An MoE leg's layer-level measurements, outside the counted main
    path.  (1) One probed prefill of the serving prompt and a decode step:
    each layer's drop fraction (a decode step, capacity 1, drops none) and
    layer 0's inputs.  (2) The layer's device time split into router,
    dispatch (sort, count, scatter), expert GEMMs and combine (and the
    shared experts), each timed on layer 0's prefill and decode inputs,
    times the MoE layers.  (3) The expert bytes a decode step reads: JAX's
    buffer runs every expert of every layer, empty slots included.  (4)
    moe_forward on the card against the port on the CPU on identical bf16
    inputs (layer 0's, 2 prompts' first 128 positions, and its decode
    input), the card's run under ``set_sync_debug_mode("error")`` (a host
    sync fails it): the router logits within MOE_GAP_EPS / 2, the chosen
    experts equal wherever the gap exceeds MOE_GAP_EPS, the output within
    2**-8 * sqrt(moe_roundings) relative L2 over the tokens routed alike."""
    from repro_torch.models.layers import moe as moe_lib
    from repro_torch.models.layers.mlp import mlp_forward
    from repro_torch.utils.pytree import tree_map

    cfg, mc = model.arch, model.arch.moe
    e, k, d, dff = mc.n_experts, mc.top_k, cfg.d_model, moe_lib.expert_ff_dim(cfg)
    n_moe = sum(spec.moe for spec in cfg.layer_plan())
    with torch.inference_mode():
        with MoEProbe() as pre:
            _, cache = model.prefill(params, {"tokens": prompt}, SERVE_CONTEXT)
        with MoEProbe() as dec:
            model.decode_step(params, {"tokens": prompt[:, -1:]}, cache, SERVE_CONTEXT)
    del cache
    out = {"prefill_drop_frac": pre.drop_fracs(), "decode_drop_frac": dec.drop_fracs()}
    check(f"{tag}: a decode step drops no pair (capacity 1 at cf 2.0)",
          not any(out["decode_drop_frac"]), drop=out["decode_drop_frac"])
    p0, x_pre = pre.first
    x_dec = dec.first[1]

    def stages(x, cf):
        b, s, _ = x.shape
        cap = moe_lib.capacity_of(s, k, e, cf)
        flat = x.reshape(b * s, d)
        topv, topi, _ = moe_lib.router_topk(cfg, p0, flat)
        topv, topi = topv.view(b, s, k), topi.view(b, s, k)
        buf, dst, scale, src, _ = moe_lib.dispatch(x, topi, topv, e=e, k=k, capacity=cap)
        ob = moe_lib.expert_ffn(p0, buf, cfg.act)
        t = {
            "router": time_ms(lambda: moe_lib.router_topk(cfg, p0, flat), iters=10),
            "dispatch": time_ms(lambda: moe_lib.dispatch(x, topi, topv, e=e, k=k,
                                                         capacity=cap), iters=10),
            "expert_gemms": time_ms(lambda: moe_lib.expert_ffn(p0, buf, cfg.act), iters=10),
            "combine": time_ms(lambda: moe_lib.combine(ob, dst, scale, src, s=s), iters=10),
        }
        if mc.n_shared_experts:
            t["shared"] = time_ms(lambda: mlp_forward(p0["shared"], x, cfg.act), iters=10)
        t["layer"] = time_ms(lambda: moe_lib.moe_forward(cfg, p0, x, capacity_factor=cf),
                             iters=10)
        flops = 3 * 2 * e * b * cap * d * dff
        return {"ms": t, "capacity": cap, "expert_gemm_flops": flops,
                "expert_gemm_tflop_per_s": flops / (t["expert_gemms"] * 1e-3) / 1e12}

    with torch.inference_mode():
        out["prefill_stages"] = stages(x_pre, 1.25)
        out["decode_stages"] = stages(x_dec, 2.0)
    expert_bytes = n_moe * 3 * e * d * dff * 2
    out["decode_expert_bytes"] = expert_bytes
    out["decode_expert_bound_ms"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    for phase, x in (("prefill", x_pre), ("decode", x_dec)):
        st = out[f"{phase}_stages"]
        print(f"{tag} MoE layer at the {phase}'s input {tuple(x.shape)} "
              f"(capacity {st['capacity']}), device ms a layer: "
              f"{({n: round(v, 4) for n, v in st['ms'].items()})}; x {n_moe} layers: "
              f"{({n: round(v * n_moe, 3) for n, v in st['ms'].items()})}; expert GEMMs "
              f"{st['expert_gemm_tflop_per_s']:.1f} TFLOP/s ({card})", flush=True)
    print(f"{tag} decode step: {decode_ms:.3f} ms synchronized, its expert weights "
          f"{expert_bytes / 1e9:.2f} GB (every expert of {n_moe} layers: JAX's buffer "
          f"semantics) >= {out['decode_expert_bound_ms']:.3f} ms at 3.35 TB/s; prefill drop "
          f"fraction a layer mean {statistics.mean(out['prefill_drop_frac']):.4f}, max "
          f"{max(out['prefill_drop_frac']):.4f} ({card})", flush=True)

    bound_layer = 2 ** -8 * math.sqrt(moe_roundings(cfg))
    cpu_p = tree_map(lambda t: t.cpu(), p0)
    out["card_vs_cpu_layer"] = {}
    for phase, x, cf in (("prefill", x_pre[:2, :MOE_CHECK_TOKENS].contiguous(), 1.25),
                         ("decode", x_dec, 2.0)):
        flat = x.reshape(-1, d)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, _ = moe_lib.moe_forward(cfg, p0, x, capacity_factor=cf)
                _, got_i, _ = moe_lib.router_topk(cfg, p0, flat)
                got_logits = torch.matmul(flat.float(), p0["router"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want, _ = moe_lib.moe_forward(cfg, cpu_p, x.cpu(), capacity_factor=cf)
            _, want_i, _ = moe_lib.router_topk(cfg, cpu_p, flat.cpu())
            want_logits = torch.matmul(flat.cpu().float(), cpu_p["router"])
        logit_err = float((got_logits.cpu() - want_logits).abs().max())
        top = torch.sort(want_logits, dim=-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        differ = (torch.sort(got_i.cpu(), -1).values != torch.sort(want_i, -1).values).any(-1)
        alike = ~differ.view(x.shape[0], x.shape[1])
        err = rel_l2(got.cpu()[alike], want[alike])
        out["card_vs_cpu_layer"][phase] = dict(
            rel_l2=err, bound=bound_layer, logit_err=logit_err, routing_flips=int(differ.sum()),
            flips_above_eps=int((differ & (gap > MOE_GAP_EPS)).sum()),
            smallest_gap=float(gap.min()))
        check(f"{tag}: moe_forward on the card against the CPU on identical bf16 inputs "
              f"({phase}: {tuple(x.shape)}, cf {cf}), no host sync: router logits within "
              f"{MOE_GAP_EPS / 2}, experts equal where the gap exceeds {MOE_GAP_EPS}, output "
              f"within relative L2 {bound_layer:.4f} over the tokens routed alike",
              logit_err <= MOE_GAP_EPS / 2 and not bool((differ & (gap > MOE_GAP_EPS)).any())
              and err <= bound_layer, **out["card_vs_cpu_layer"][phase])
    print(f"{tag} moe_forward card vs CPU on identical inputs: "
          f"{json.dumps(out['card_vs_cpu_layer'])} ({card})", flush=True)
    return out


def moe_dense_serving_phase(card: str, out_dir: Path) -> dict:
    """Phase 14: deepseek-moe-16b at full width (MHA 16 x 128, 64 experts
    top-6 + 2 shared, every layer MoE), mixtral-8x7b cut to 16 layers (GQA
    32/8, 8 experts top-2; its window of 4096 exceeds the context, so no
    ring), granite-8b (GQA 32/8, theta 1e7) and stablelm-3b (MHA 32 x 80,
    LayerNorm) at full width, each through ``serving_phase`` at phase 8's
    shape with one flash launch a layer per prefill and one decode launch
    a layer per step, no other kernel; the MoE legs with
    ``moe_layer_phase`` and their CPU check on the first 4 layers.  Each
    leg frees its weights before the next."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    out = {}
    for tag, arch, depth, n_params in SERVING_LEGS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        per_layer = DENSE_ROUNDINGS + (moe_roundings(cfg) if cfg.moe is not None else 0)
        cpu_layers = min(MOE_CPU_LAYERS, cfg.n_layers) if cfg.moe is not None else None
        t0 = time.perf_counter()
        out[tag] = serving_phase(
            card, out_dir, cfg=cfg, tag=tag, n_params=n_params,
            prefill_launches={"flash_attention": cfg.n_layers},
            step_launches={"decode_attention": cfg.n_layers},
            rel_l2_bound=2 ** -8 * math.sqrt(per_layer * cfg.n_layers), cpu_prompt=32,
            cpu_layers=cpu_layers,
            cpu_bound=2 ** -8 * math.sqrt(per_layer * (cpu_layers or cfg.n_layers)))
        out[tag].update(arch=arch, depth_cut=depth, seconds=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 14 leg {tag} ({arch}{f', depth cut to {depth}' if depth else ''}): "
              f"{out[tag]['seconds']:.2f} s ({card})", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 (MoE and dense-family serving): {out['seconds']:.2f} s ({card})",
          flush=True)
    return out


# ---------------- phase 15: MLA and frontend serving ----------------
# (tag, arch, params counted from the JAX package's init shapes:
# tests/test_torch_mla.py); each at full width, nothing cut
MLA_FRONTEND_LEGS = (
    ("minicpm", "minicpm3-4b", 4_073_875_968),
    ("paligemma", "paligemma-3b", 2_511_022_080),
    ("musicgen", "musicgen-medium", 1_819_708_416),
)
# An MLA layer's roundings on the residual stream's path, counted as phase
# 14 counts them: the query side's two products, its norm and RoPE (4), the
# latent's product, norm and RoPE (3), the per-head K and V products (2), P
# before P . V (1), the attention output and wo (2).  The frontend legs'
# layers are DENSE_ROUNDINGS'.
MLA_ROUNDINGS = 12
MLA_FRONTEND_CPU_LAYERS = 4   # the card-against-CPU check's layers
MLA_CHECK_TOKENS = 128        # mla_layer_phase: 2 prompts' first 128 positions ...
MLA_CHECK_SLOTS = 256         # ... in a 256-slot latent cache, then 3 decode positions


def mla_layer_phase(model, params, prompt, card: str, *, tag: str) -> dict:
    """An MLA leg's checks outside the counted main path.  (1) After a
    prefill of the serving prompt, one decode step of the whole stack
    under ``set_sync_debug_mode("error")``: nothing in it waits on the
    card.  (2) Layer 0's mixer on the card against the port on the CPU on
    identical bf16 inputs (layer 0's normed input at 2 prompts' first 128
    positions, then at the next 3): ``mla_forward`` (the flash kernel with
    V zero-padded against the plain attention) and its latents, then
    ``mla_decode`` at the first three decode positions from the same cache
    (the card's latents, copied), the first of them under the sync debug
    mode, each output and the caches after within 2**-8 *
    sqrt(MLA_ROUNDINGS) relative L2.  (3) One layer's absorbed decode at
    the serving shape timed, and the fp32 copies of ``wk_b`` and ``wv_b``
    it makes a step."""
    from repro_torch.models.layers import attention as attn_lib
    from repro_torch.models.layers import mla as mla_lib
    from repro_torch.models.layers.embeddings import embed
    from repro_torch.models.layers.norms import apply_norm
    from repro_torch.utils.pytree import tree_map

    cfg, bf16, dev = model.arch, torch.bfloat16, model.device
    out = {}
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": prompt}, SERVE_CONTEXT)
        torch.cuda.synchronize()
        error, logits = None, None
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = model.decode_step(params, {"tokens": prompt[:, -1:]}, cache,
                                              SERVE_CONTEXT)
        except RuntimeError as err:
            error = repr(err)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    check(f"{tag}: a decode step of the whole stack (B={SERVE_B}, context {SERVE_CONTEXT}) "
          "under set_sync_debug_mode('error'): no host sync, finite logits",
          error is None and bool(torch.isfinite(logits).all()), error=error)

    blk = (tree_map(lambda t: t[0], params["blocks"][0]) if cfg.scan_layers
           else params["blocks"][0])   # layer 0 (views of the stacked leaves)
    p0, cpu_p = blk["mixer"], tree_map(lambda t: t.cpu(), blk["mixer"])
    n, slots = MLA_CHECK_TOKENS, MLA_CHECK_SLOTS
    bound_layer = 2 ** -8 * math.sqrt(MLA_ROUNDINGS)
    errs = {}
    with torch.inference_mode():
        h = apply_norm(cfg, blk["norm1"], embed(params["embed"], prompt[:2, :n + 3]).to(bf16))
        x_pre = h[:, :n].contiguous()
        got = mla_lib.mla_forward(cfg, p0, x_pre)
        want = mla_lib.mla_forward(cfg, cpu_p, x_pre.cpu())
        for name, a, b in zip(("prefill", "prefill c_kv", "prefill k_rope"), got, want):
            errs[name] = rel_l2(a, b)
        caches = {}
        for where in ("card", "cpu"):
            caches[where] = mla_lib.init_mla_cache(cfg, 2, slots, bf16,
                                                   device=dev if where == "card" else "cpu")
            caches[where]["c_kv"][:, :n] = got[1]
            caches[where]["k_rope"][:, :n] = got[2]
        for i, pos in enumerate(range(n, n + 3)):
            x = h[:, n + i:n + i + 1].contiguous()
            valid = attn_lib.kv_valid(2, slots, pos, ring=False, device=dev)
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                o_card, _ = mla_lib.mla_decode(cfg, p0, x, caches["card"], pos, ring=False,
                                               valid=valid)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            o_cpu, _ = mla_lib.mla_decode(cfg, cpu_p, x.cpu(), caches["cpu"], pos, ring=False,
                                          valid=valid.cpu())
            errs[f"decode at {pos}"] = rel_l2(o_card, o_cpu)
        for key in ("c_kv", "k_rope"):
            errs[f"cache {key} after"] = rel_l2(caches["card"][key], caches["cpu"][key])
    out["card_vs_cpu_layer"] = errs
    check(f"{tag}: layer 0's mla_forward (flash, V zero-padded) and mla_decode at the first 3 "
          f"decode positions on the card against the CPU on identical bf16 inputs, the first "
          f"step without a host sync: each within relative L2 {bound_layer:.4f}",
          all(e <= bound_layer for e in errs.values()), **errs)

    # (3) one layer's absorbed decode at the serving shape, and its fp32 weight copies
    with torch.inference_mode():
        c8 = mla_lib.init_mla_cache(cfg, SERVE_B, SERVE_CONTEXT, bf16, device=dev)
        x8 = torch.randn(SERVE_B, 1, cfg.d_model, device=dev).to(bf16)
        pos = SERVE_PROMPT + SERVE_TOKENS // 2
        v8 = attn_lib.kv_valid(SERVE_B, SERVE_CONTEXT, pos, ring=False, device=dev)
        out["decode_layer_ms"] = time_ms(
            lambda: mla_lib.mla_decode(cfg, p0, x8, c8, pos, ring=False, valid=v8), iters=10)
        out["fp32_weight_copies_ms"] = time_ms(
            lambda: (p0["wk_b"].to(torch.float32), p0["wv_b"].to(torch.float32)), iters=10)
    out["fp32_weight_copy_bytes_a_step"] = cfg.n_layers * 6 * (
        p0["wk_b"].numel() + p0["wv_b"].numel())   # 2 B read, 4 B written an element
    print(f"{tag} MLA layer card vs CPU: {json.dumps(errs)} (bound {bound_layer:.4f}); one "
          f"layer's absorbed decode at B={SERVE_B}, {SERVE_CONTEXT} slots "
          f"{out['decode_layer_ms']:.4f} ms (event brackets, host enqueue included), its fp32 "
          f"wk_b / wv_b copies {out['fp32_weight_copies_ms']:.4f} ms, "
          f"{out['fp32_weight_copy_bytes_a_step'] / 1e6:.1f} MB a step over {cfg.n_layers} "
          f"layers ({card})", flush=True)
    return out


def mla_frontend_serving_phase(card: str, out_dir: Path) -> dict:
    """Phase 15: minicpm3-4b (MLA: 62 layers, 40 heads, qk width 96, V 64,
    latent 256; its decode the absorbed fp32 form, no kernel), paligemma-3b
    (vlm: 256 frontend positions of width 1152, 8 heads over 1 at D = 256,
    vocab 257,216) and musicgen-medium (audio: 64 frontend positions of
    width 768, MHA 24 x 64, LayerNorm) at full width, each through
    ``serving_phase`` at phase 8's shape (the frontend legs' prompts after
    their frontend embeddings): minicpm 62 flash launches a prefill and no
    kernel a decode step, plus ``mla_layer_phase``; paligemma 18 and 18
    decode launches; musicgen 48 and 48; no other kernel.  Bounds 2**-8 *
    sqrt(roundings a layer * layers) (MLA_ROUNDINGS, DENSE_ROUNDINGS); the
    card against the CPU on the first 4 layers.  Each leg frees its
    weights before the next."""
    import gc

    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    out = {}
    for tag, arch, n_params in MLA_FRONTEND_LEGS:
        cfg = get_config(arch)
        mla = cfg.mla is not None
        per_layer = MLA_ROUNDINGS if mla else DENSE_ROUNDINGS
        t0 = time.perf_counter()
        out[tag] = serving_phase(
            card, out_dir, cfg=cfg, tag=tag, n_params=n_params,
            prefill_launches={"flash_attention": cfg.n_layers},
            step_launches={} if mla else {"decode_attention": cfg.n_layers},
            rel_l2_bound=2 ** -8 * math.sqrt(per_layer * cfg.n_layers), cpu_prompt=32,
            cpu_layers=MLA_FRONTEND_CPU_LAYERS,
            cpu_bound=2 ** -8 * math.sqrt(per_layer * MLA_FRONTEND_CPU_LAYERS))
        out[tag].update(arch=arch, seconds=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 15 leg {tag} ({arch}): {out[tag]['seconds']:.2f} s ({card})", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 (MLA and frontend serving): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 16: xLSTM serving ----------------
# An xLSTM layer's roundings on the residual stream's path, counted as
# phases 14 and 15 count them.  mLSTM: its norm (1), up_proj (1), the q, k
# and v products (3), the quadratic form's (or the recurrent step's) output
# cast to bf16 (1), the head-wise norm (1), silu's 4 steps on z (4), the
# gate product (1), down_proj (1), the residual add (1): 14.  sLSTM: its
# norm (1), w_in (1), the fp32 h cast to bf16 (1), up (1), silu's 4 steps
# on g (4), the gate product (1), down (1), the residual add (1): 11.  The
# gates, the recurrence, the states and the head-wise norms run in fp32.
XLSTM_ROUNDINGS = {"mlstm": 14, "slstm": 11}
XLSTM_CPU_LAYERS = 4          # the card-against-CPU check: sLSTM, mLSTM x 3
XLSTM_CHECK_TOKENS = 128      # xlstm_layer_phase: 2 prompts' first 128 positions, then 3


def xlstm_bound(cfg, layers: int | None = None) -> float:
    """2**-8 * sqrt(the roundings of the stack's first ``layers`` layers)."""
    plan = cfg.layer_plan()[:layers]
    return 2 ** -8 * math.sqrt(sum(XLSTM_ROUNDINGS[spec.kind] for spec in plan))


def xlstm_layer_phase(model, params, prompt, card: str, *, tag: str) -> dict:
    """An xLSTM leg's checks and layer timings outside the counted main
    path.  (1) After a prefill of the serving prompt, one decode step of
    the whole stack under ``set_sync_debug_mode("error")``.  (2) On the
    card against the port on the CPU, on identical bf16 inputs: layer 0's
    ``slstm_forward`` (its output and fp32 carry) on its normed input at 2
    prompts' first 128 positions; layer 1's mLSTM prefill (its output and
    (C, n, m)) on its normed input after layer 0, then ``mlstm_decode`` at
    the next three positions from that state (the card's, copied), the
    first step under the sync debug mode; each within 2**-8 *
    sqrt(XLSTM_ROUNDINGS of the layer) relative L2.  (2b) Every layer's
    decode at position 256 from the state of its own 256-token prefill
    against its 257-token prefill's output there, both fed the 257-token
    run's inputs to that layer (2 prompts), within the same bounds: the
    state handoff held at every layer without the stack's drift between
    runs that round apart.  (3) At the serving
    shape (B=8, 1024 positions, layer 1's projections of the serving
    prompt): the device ms of the mLSTM's fp32 quadratic form and of the
    prefill's final state beside their bound at the fp32 peak; one
    ``slstm_forward``'s host ms and its device events (kernel launches and
    copies), times the sLSTM layers a prefill; one layer's mLSTM decode
    step's device ms beside the bytes its state moves."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import xlstm
    from repro_torch.models.layers.embeddings import embed
    from repro_torch.models.layers.norms import apply_norm
    from repro_torch.utils.pytree import tree_map
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, bf16 = model.arch, torch.bfloat16
    out = {}
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": prompt}, SERVE_CONTEXT)
        torch.cuda.synchronize()
        error, logits = None, None
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = model.decode_step(params, {"tokens": prompt[:, -1:]}, cache,
                                              SERVE_CONTEXT)
        except RuntimeError as err:
            error = repr(err)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    del cache
    check(f"{tag}: a decode step of the whole stack (B={SERVE_B}, after a {SERVE_PROMPT}-token "
          "prefill) under set_sync_debug_mode('error'): no host sync, finite logits",
          error is None and bool(torch.isfinite(logits).all()), error=error)

    period = cfg.plan_period
    blk = [tree_map(lambda t, j=i // period: t[j], params["blocks"][i % period])
           if cfg.scan_layers else params["blocks"][i] for i in range(2)]
    assert [cfg.layer_plan()[i].kind for i in range(2)] == ["slstm", "mlstm"]
    cpu_p = [tree_map(lambda t: t.cpu(), b["mixer"]) for b in blk]
    n = XLSTM_CHECK_TOKENS
    bounds = {kind: 2 ** -8 * math.sqrt(r) for kind, r in XLSTM_ROUNDINGS.items()}
    errs = {}
    with torch.inference_mode():
        x0 = embed(params["embed"], prompt[:2, :n + 3]).to(bf16)
        h0 = apply_norm(cfg, blk[0]["norm1"], x0)
        got = xlstm.slstm_forward(cfg, blk[0]["mixer"], h0)
        want = xlstm.slstm_forward(cfg, cpu_p[0], h0.cpu())
        errs["slstm output"] = rel_l2(got[0], want[0])
        errs.update({f"slstm carry {k}": rel_l2(got[1][k], want[1][k]) for k in want[1]})
        h1 = apply_norm(cfg, blk[1]["norm1"], x0 + got[0])
        x_pre = h1[:, :n].contiguous()
        got = xlstm.mlstm_forward(cfg, blk[1]["mixer"], x_pre)
        want = xlstm.mlstm_forward(cfg, cpu_p[1], x_pre.cpu())
        errs["mlstm prefill"] = rel_l2(got[0], want[0])
        errs.update({f"mlstm prefill {k}": rel_l2(got[1][k], want[1][k]) for k in want[1]})
        caches = {"card": got[1], "cpu": {k: v.to("cpu", copy=True) for k, v in got[1].items()}}
        for i in range(3):
            x = h1[:, n + i:n + i + 1].contiguous()
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                o_card, _ = xlstm.mlstm_decode(cfg, blk[1]["mixer"], x, caches["card"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            o_cpu, _ = xlstm.mlstm_decode(cfg, cpu_p[1], x.cpu(), caches["cpu"])
            errs[f"mlstm decode at {n + i}"] = rel_l2(o_card, o_cpu)
        errs.update({f"mlstm cache {k} after": rel_l2(caches["card"][k], caches["cpu"][k])
                     for k in ("C", "n", "m")})
    out["card_vs_cpu_layer"] = errs
    check(f"{tag}: layer 0's slstm_forward and layer 1's mLSTM prefill, (C, n, m) and "
          "mlstm_decode at the next 3 positions on the card against the CPU on identical bf16 "
          f"inputs, the first step without a host sync: each within relative L2 "
          f"{bounds['slstm']:.4f} (sLSTM) / {bounds['mlstm']:.4f} (mLSTM)",
          all(e <= bounds[name[:5]] for name, e in errs.items()), **errs)

    # (2b) every layer's decode at position 256 against the longer prefill's
    # output there, on identical inputs: the stack's inputs of the 257-token
    # prefill, each layer's state from its own 256-token prefill
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 257))
                            .astype(np.int32)).to(model.device)
    layer_errs = []
    with torch.inference_mode():
        x = embed(params["embed"], toks).to(bf16)
        for spec, p in tfm._layers(cfg, params["blocks"]):
            forward, decode = tfm._RECURRENT[spec.kind]
            h = apply_norm(cfg, p["norm1"], x)
            longer, _ = forward(cfg, p["mixer"], h)
            _, state = forward(cfg, p["mixer"], h[:, :-1])
            step, _ = decode(cfg, p["mixer"], h[:, -1:], state)
            layer_errs.append(rel_l2(step, longer[:, -1:]))
            x = x + longer
    out["prefill_decode_per_layer"] = layer_errs
    kinds = [spec.kind for spec in cfg.layer_plan()]
    check(f"{tag}: each of the {cfg.n_layers} layers' decode at position 256 from its "
          "256-token prefill's state against its 257-token prefill's output there, on the "
          "longer prefill's inputs: within relative L2 2**-8 * sqrt(the layer's roundings)",
          all(e <= bounds[k] for e, k in zip(layer_errs, kinds)),
          max_slstm=max(e for e, k in zip(layer_errs, kinds) if k == "slstm"),
          max_mlstm=max(e for e, k in zip(layer_errs, kinds) if k == "mlstm"))

    # (3) the layers at the serving shape
    f32_peak = 67e12   # H100 SXM fp32 on the CUDA cores (datasheet peak)
    with torch.inference_mode():
        x = apply_norm(cfg, blk[1]["norm1"], embed(params["embed"], prompt).to(bf16))
        x_in, _ = torch.chunk(torch.matmul(x, blk[1]["mixer"]["up_proj"]), 2, dim=-1)
        q, k, v, ig, lf = xlstm._mlstm_qkv_gates(cfg, blk[1]["mixer"], x_in)
        b, s, h, d = q.shape
        quad_flop = 2 * 2 * b * h * s * s * d      # q . k^T and P . V over every key
        state_flop = 2 * b * h * s * d * d
        out["mlstm_quadratic_ms"] = time_ms(lambda: xlstm.mlstm_parallel(q, k, v, ig, lf),
                                            iters=10)
        out["mlstm_final_state_ms"] = time_ms(lambda: xlstm._mlstm_final_state(k, v, ig, lf),
                                              iters=10)
        out["mlstm_quadratic_bound_ms"] = quad_flop / f32_peak * 1e3
        out["mlstm_final_state_bound_ms"] = state_flop / f32_peak * 1e3
        del q, k, v, x_in
        h0 = apply_norm(cfg, blk[0]["norm1"], embed(params["embed"], prompt).to(bf16))
        xlstm.slstm_forward(cfg, blk[0]["mixer"], h0)   # warm
        host_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xlstm.slstm_forward(cfg, blk[0]["mixer"], h0)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        out["slstm_forward_host_ms_all"] = host_ms
        out["slstm_forward_host_ms"] = statistics.median(host_ms)
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        xlstm.slstm_forward(cfg, blk[0]["mixer"], h0)
        torch.cuda.synchronize()
        prof.stop()
        busy_us, _ = device_time(prof)
        out["slstm_forward_device_events"] = sum(1 for e in prof.events()
                                                 if e.device_type == DeviceType.CUDA)
        out["slstm_forward_busy_ms"] = busy_us / 1e3
        n_slstm = sum(spec.kind == "slstm" for spec in cfg.layer_plan())
        out["slstm_prefill_host_ms"] = n_slstm * out["slstm_forward_host_ms"]
        out["slstm_prefill_device_events"] = n_slstm * out["slstm_forward_device_events"]
        c8 = xlstm.init_mlstm_cache(cfg, SERVE_B, device=model.device)
        x8 = torch.randn(SERVE_B, 1, cfg.d_model, device=model.device).to(bf16)
        out["mlstm_decode_layer_ms"] = time_ms(
            lambda: xlstm.mlstm_decode(cfg, blk[1]["mixer"], x8, c8), iters=10)
        out["mlstm_state_bytes_a_layer"] = c8["C"].numel() * 4
    print(f"{tag} xLSTM layers card vs CPU: {json.dumps(errs)} (bounds {bounds}); each "
          f"layer's decode against the longer prefill: {[f'{e:.2e}' for e in layer_errs]}; "
          f"at B={b}, "
          f"S={s}, H={h}, D={d}: the mLSTM's fp32 quadratic form {out['mlstm_quadratic_ms']:.3f} "
          f"ms (bound {out['mlstm_quadratic_bound_ms']:.3f} at 67 TFLOP/s), its final state "
          f"{out['mlstm_final_state_ms']:.3f} ms (bound {out['mlstm_final_state_bound_ms']:.3f})"
          f"; one slstm_forward {out['slstm_forward_host_ms']:.1f} ms host (median of "
          f"{[round(t, 1) for t in host_ms]}), "
          f"{out['slstm_forward_device_events']} device events, card busy "
          f"{out['slstm_forward_busy_ms']:.1f} ms; x {n_slstm} layers a prefill: "
          f"{out['slstm_prefill_host_ms']:.1f} ms, {out['slstm_prefill_device_events']} events; "
          f"one layer's mLSTM decode step {out['mlstm_decode_layer_ms']:.4f} ms (event brackets, "
          f"host enqueue included; its C {out['mlstm_state_bytes_a_layer'] / 1e6:.1f} MB) "
          f"({card})", flush=True)
    return out


def xlstm_serving_phase(card: str, out_dir: Path) -> dict:
    """Phase 16: xlstm-1.3b at full width, nothing cut (48 layers, sLSTM
    at 0, 8, ..., 40 with 4 heads of 512, mLSTM elsewhere at d_inner 4096
    with 4 heads of 1024, no FFN, vocab 50,304, untied lm_head, bf16,
    stacked by the period of 8), through ``serving_phase`` at phase 8's
    shape: no hand-written kernel launches in a prefill or a decode step
    (the mixers are matrix products and elementwise ops, in fp32 where
    JAX's are), plus ``xlstm_layer_phase``.  Bounds 2**-8 * sqrt(the
    roundings of the layers, ``XLSTM_ROUNDINGS``).  The card against the
    CPU and prefill + decode against the longer prefill are held on the
    first 4 layers, the latter reported over the whole stack too: with
    random weights two bf16 runs of this stack that round apart drift
    ~8e-3 a layer, coherently, on the card and on the CPU alike (0.39 at
    layer 48; fp32 5.2e-4), past any bound that adds roundings in random
    directions.  ``xlstm_layer_phase`` holds the decode against the
    prefill at every layer on identical inputs.  The weights are freed at
    the end."""
    import gc

    from repro_torch.configs.base import get_config

    t0 = time.perf_counter()
    cfg = get_config("xlstm-1.3b")
    cut_bound = xlstm_bound(cfg, XLSTM_CPU_LAYERS)
    out = serving_phase(card, out_dir, cfg=cfg, tag="xlstm", n_params=XLSTM_PARAMS,
                        prefill_launches={}, step_launches={}, rel_l2_bound=xlstm_bound(cfg),
                        cpu_prompt=32, cpu_layers=XLSTM_CPU_LAYERS, cpu_bound=cut_bound,
                        consistency_cut=(XLSTM_CPU_LAYERS, cut_bound))
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 16 (xLSTM serving): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 17: LM fine-tuning (dense transformer training) ----------------
# qwen3-0.6b at full width on make_round_step, parallel mode, as
# repro_torch/examples/federated_llm_finetune.py builds it
LM_ARCH = "qwen3-0.6b"
LM_C, LM_B, LM_SEQ, LM_STEPS, LM_ROUNDS, LM_RANK = 4, 2, 512, 2, 3, 4
LM_CODECS = ("fp32", "int8", "lora")
LM_PROFILED = "int8"            # the codec of the profiled fourth round
LM_CPU_LAYERS = 2               # leg b: the stack cut to its first 2 layers
# leg b's bounds, set before the first card run: fp32 sums in other orders
# (the flash kernels, cuBLAS against the CPU's GEMMs): 1e-5 on the loss,
# relative L2 1e-4 a gradient leaf; bf16 as the serving leg's logits (P
# rounded to bf16 on the card's flash route, other roundings' order)
LM_CPU_BOUND = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, LOGITS_REL_L2)}
LM_CPU_TOKENS = {"float32": (LM_B, LM_SEQ), "bfloat16": (1, 256)}   # leg b's batch
FL_LAUNCHED = ("fedavg_reduce", "quantize_int8", "dequantize_int8", "dequant_reduce",
               "topk_scatter_reduce", "collective_absmax", "collective_pack",
               "collective_unpack", "decode_attention", "selective_scan")
# ~2 ms at the 1980 MHz maximum SM clock: time for autograd to enqueue
# SDPA's backward before the timed window opens (leg a's yardstick)
SDPA_BWD_LEAD_CYCLES = 4_000_000
# leg a: label, B, Sq, Skv, H, KV, D, dtype, window, q_offset, causal
FLASH_BWD_CASES = [
    ("training shape", LM_C * LM_B, LM_SEQ, LM_SEQ, 16, 8, 128, torch.bfloat16, None, 0, True),
    ("fp32, training shape", LM_C * LM_B, LM_SEQ, LM_SEQ, 16, 8, 128, torch.float32, None, 0,
     True),
    ("GQA 32/8", 2, 512, 512, 32, 8, 128, torch.bfloat16, None, 0, True),
    ("stablelm-3b heads, D=80", 2, 512, 512, 32, 32, 80, torch.bfloat16, None, 0, True),
    ("D=64", 2, 512, 512, 8, 2, 64, torch.bfloat16, None, 0, True),
    ("fp32 D=64", 2, 512, 512, 8, 2, 64, torch.float32, None, 0, True),
    ("window 100 at q_offset 256", 2, 128, 384, 8, 4, 64, torch.bfloat16, 100, 256, True),
    ("ragged S=300", 2, 300, 300, 16, 8, 128, torch.bfloat16, None, 0, True),
    ("fp32 ragged S=300, D=256, not causal", 1, 300, 300, 4, 4, 256, torch.float32, None, 0,
     False),
    ("rows with no valid key", 1, 8, 24, 2, 1, 40, torch.float32, 3, 20, True),
    ("bf16 rows with no valid key", 1, 8, 24, 2, 1, 40, torch.bfloat16, 3, 20, True),
    # the widths the next training slices launch (ROADMAP item 15)
    ("paligemma-3b's 8 over 1 at D = 256", 2, 512, 512, 8, 1, 256, torch.bfloat16, None, 0,
     True),
    ("MLA's qk 96", 2, 512, 512, 16, 16, 96, torch.bfloat16, None, 0, True),
    ("musicgen-medium's 24 x 64", 2, 512, 512, 24, 24, 64, torch.bfloat16, None, 0, True),
    # rows from 115 on have no valid key; at D = 256 the dK / dV kernel's
    # four passes and 32-row tiles
    ("bf16 rows with no valid key, window 16, D = 256", 2, 200, 300, 4, 2, 256, torch.bfloat16,
     16, 200, True),
    # phase 18's shape: the vmapped cohort of 2 clients x 2 sequences (MHA)
    ("deepseek-moe-16b's 16 x 16 x 128", 4, 512, 512, 16, 16, 128, torch.bfloat16, None, 0,
     True),
    # phase 19's: minicpm3-4b's cohort of 2 x 2 sequences at 40 heads of qk 96
    # (V zero-padded from 64), and paligemma-3b's step, 256 frontend + 512
    # text positions
    ("minicpm3-4b's 40 x 96", 4, 512, 512, 40, 40, 96, torch.bfloat16, None, 0, True),
    ("paligemma-3b's 8 over 1 at D = 256, 768 positions", 2, 768, 768, 8, 1, 256,
     torch.bfloat16, None, 0, True),
]
# the cases timed beside their bounds and SDPA; the first is the kernel row's
FLASH_BWD_TIMED = ("training shape", "fp32, training shape", "deepseek-moe-16b's 16 x 16 x 128",
                   "minicpm3-4b's 40 x 96", "paligemma-3b's 8 over 1 at D = 256, 768 positions")


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: the attention tolerances' measure."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def flash_backward_checks(dev) -> dict:
    """Leg a: the forward's lse and the backward kernel (dq, dk, dv) against
    ``ref.attention_with_lse`` / ``ref.attention_bwd`` on the same inputs
    (the kernel's own out and lse) and against autograd of
    ``ref.attention``, within 2e-5 (fp32) / 2e-2 (bf16) of each tensor's
    max-abs, at ``FLASH_BWD_CASES``, and two calls bitwise equal; at the
    training shape (bf16 and fp32) the forward with lse and the backward
    timed through the wrapper and as a bare launch (bf16: also the dQ and
    the dK / dV kernel alone) beside their bounds (the backward's five
    products 10·B·H·D·pairs at the dtype's peak, or its bytes), the plain
    backward, and scaled_dot_product_attention's forward and backward
    (never on the port's path).  Then ptxas' registers and spills of the
    backward kernels, none in the wgmma ones.  -> the backward's kernel row
    (bf16, training shape)."""
    import re

    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    bf16_peak = bf16_flop_per_s()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = None
    for label, b, sq, skv, h, kv, d, dtype, window, q_off, causal in FLASH_BWD_CASES:
        q, k, v, dout = (torch.randn(s, generator=gen, device=dev).to(dtype) for s in
                         ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d)))
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out, lse = fk.flash_attention_fwd(q, k, v, **kw)
        grads = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        bitwise = all(torch.equal(g, a) for g, a in zip(grads, again))
        del again
        exp_out, exp_lse = ref.attention_with_lse(q, k, v, **kw)
        plain = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        ref.attention(qr, kr, vr, **kw).backward(dout)
        auto = (qr.grad, kr.grad, vr.grad)
        tol = ATTN_TOL[dtype]
        errs = {"out": max_rel(out, exp_out), "lse": max_rel(lse, exp_lse),
                **{f"{n}_plain": max_rel(g, p) for n, g, p in zip("qkv", grads, plain)},
                **{f"{n}_autograd": max_rel(g, a) for n, g, a in zip("qkv", grads, auto)}}
        check(f"flash_attention_bwd [{label}: q {tuple(q.shape)}, k {tuple(k.shape)}, {dtype}, "
              f"window {window}, q_offset {q_off}, causal {causal}]: lse, dq, dk, dv within "
              f"{tol} of each tensor's max-abs (plain versions, autograd of ref.attention), "
              f"two calls bitwise equal",
              all(g.dtype == dtype and g.shape == p.shape and bool(torch.isfinite(g).all())
                  for g, p in zip(grads, plain)) and max(errs.values()) <= tol and bitwise,
              bitwise=bitwise, **errs)
        del qr, kr, vr, auto, exp_out, exp_lse
        if label not in FLASH_BWD_TIMED:
            continue
        pairs = attention_pairs(sq, skv, causal, window, q_off)
        peak = bf16_peak if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        bwd_bytes = nbytes(q, k, v, out, lse, dout, *grads)
        bwd_flops = 10 * b * h * d * pairs
        b_ms, b_by = bound(bwd_bytes, bwd_flops, peak)
        f_ms, f_by = bound(nbytes(q, k, v, out, lse), 4 * b * h * d * pairs, peak)
        o, ls = torch.empty_like(q), torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        sfx = "bf16" if dtype == torch.bfloat16 else "f32"
        mask_args = (int(causal), -1 if window is None else window, q_off, float(d ** -0.5))
        fwd_bare = lambda: _cuda.launch(  # noqa: E731
            "flash_attention", f"repro_flash_attention_{sfx}", "flash_attention", dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ls.data_ptr(), b, sq, skv,
            h, kv, d, *mask_args)
        bwd_bare = lambda: _cuda.launch(  # noqa: E731
            "flash_attention", f"repro_flash_attention_bwd_{sfx}", "flash_attention_bwd", dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b,
            sq, skv, h, kv, d, *mask_args)

        def bwd_part(part):  # 1: the dQ kernel (and delta), 2: the dK / dV kernel
            return lambda: _cuda.launch(
                "flash_attention", "repro_flash_attention_bwd_bf16_parts", "flash_attention_bwd",
                dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                b, sq, skv, h, kv, d, *mask_args, part)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        timing = dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:102",
            max_abs_err=max(float((g.float() - p.float()).abs().max())
                            for g, p in zip(grads, plain)),
            ms=time_ms(lambda: fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)),
            launch_ms=time_ms(bwd_bare),
            plain_ms=time_ms(lambda: ref.attention_bwd(q, k, v, out, lse, dout, **kw), iters=5),
            library_ms=time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                           retain_graph=True),
                               lead_cycles=SDPA_BWD_LEAD_CYCLES),
            bound_ms=b_ms, bound_by=b_by, flops=bwd_flops, bytes=bwd_bytes,
            peak_flop_per_s=peak,
            fwd_lse_ms=time_ms(lambda: fk.flash_attention_fwd(q, k, v, **kw)),
            fwd_lse_launch_ms=time_ms(fwd_bare),
            fwd_ms=time_ms(lambda: fk.flash_attention(q, k, v, **kw)),
            fwd_bound_ms=f_ms, fwd_bound_by=f_by,
            sdpa_fwd_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
            shape=f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {skv}, {kv}, {d}) {dtype} causal",
        )
        timing["sdpa_fwd_bwd_ms"] = timing["sdpa_fwd_ms"] + timing["library_ms"]
        parts = ""
        if dtype == torch.bfloat16:
            bwd_bare()  # delta for the dK / dV kernel alone
            timing["dq_kernel_ms"] = time_ms(bwd_part(1))
            timing["dkv_kernel_ms"] = time_ms(bwd_part(2))
            parts = (f"; the dQ kernel alone {timing['dq_kernel_ms'] * 1e3:.2f} us, the dK / dV "
                     f"kernel {timing['dkv_kernel_ms'] * 1e3:.2f} us")
        print(f"flash_attention_bwd [{label}] {timing['shape']}: backward {timing['ms'] * 1e3:.2f} "
              f"us (bare {timing['launch_ms'] * 1e3:.2f}), bound {b_ms * 1e3:.2f} us ({b_by}: "
              f"{bwd_flops / 1e9:.2f} GFLOP, {bwd_bytes / 1e6:.2f} MB), plain "
              f"{timing['plain_ms'] * 1e3:.2f} us, SDPA's backward "
              f"{timing['library_ms'] * 1e3:.2f} us; forward with lse "
              f"{timing['fwd_lse_ms'] * 1e3:.2f} us (bare {timing['fwd_lse_launch_ms'] * 1e3:.2f}, "
              f"without lse {timing['fwd_ms'] * 1e3:.2f}), bound {f_ms * 1e3:.2f} us ({f_by}), "
              f"SDPA's forward {timing['sdpa_fwd_ms'] * 1e3:.2f} us{parts}", flush=True)
        if label == FLASH_BWD_TIMED[0]:
            row = timing
        else:
            REPORT["timings"].append({"name": "flash_attention_bwd", "case": label, **timing})
        del q, k, v, dout, out, lse, grads, plain, o, ls, dq, dk, dv, delta, qt, kt, vt, ot

    def name_of(line):
        entry = re.search(r"Compiling entry function '\S*?(flash_attention_bwd_\w+?_kernel"
                          r"(?:_wgmma)?)I(f?)Li(\d+)E", line)
        if entry:
            kind, dtype, dp = entry.groups()
            return f"{kind}<{'float, ' if dtype == 'f' else ''}{dp}>"
        return None

    row["ptxas"] = ptxas_report("flash_attention", name_of)
    wgmma = {k: v for k, v in row["ptxas"].items() if "wgmma" in k}
    check("ptxas reports the 12 backward kernels (dQ, dK/dV x 3 head dims: fp32 on the CUDA "
          "cores, bf16 wgmma), no spill and no stack frame in the wgmma ones",
          len(row["ptxas"]) == 12 and len(wgmma) == 6 and no_spill(wgmma)
          and all(v.get("stack_frame") == 0 for v in wgmma.values()), kernels=row["ptxas"])
    return row


def lm_batch(cfg, rnd: int, dev, *, clients=LM_C, steps=LM_STEPS, batch=LM_B, seq=LM_SEQ):
    """The example's round batch (``lm_round_batch``, seed ``rnd``) on ``dev``."""
    from repro_torch.data.loader import lm_round_batch

    arrays = lm_round_batch(n_clients=clients, steps=steps, batch_size=batch, seq_len=seq,
                            vocab_size=cfg.vocab_size, seed=rnd)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def lm_card_vs_cpu(card: str, dtype: str) -> dict:
    """Leg b: qwen3-0.6b at full width cut to its first 2 layers, one client,
    one batch: ``loss_fn``'s value and every leaf's gradient
    (``torch.func.grad_and_value``) on the card against the port's CPU route
    on identical params and tokens, within ``LM_CPU_BOUND``; one flash
    forward and one backward launch a layer on the card."""
    import dataclasses
    import os

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_CPU_LAYERS, dtype=dtype)
    card_m, cpu_m = build_model(cfg), build_model(cfg, device="cpu")
    params = card_m.init(0)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    b, s = LM_CPU_TOKENS[dtype]
    batch = {k: v[0, 0] for k, v in lm_batch(cfg, 1, "cpu", clients=1, steps=1, batch=b,
                                             seq=s).items()}
    t0 = time.perf_counter()
    want, (want_loss, _) = torch.func.grad_and_value(cpu_m.loss_fn, has_aux=True)(
        cpu_params, batch)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    got, (got_loss, _) = torch.func.grad_and_value(card_m.loss_fn, has_aux=True)(
        params, {k: v.cuda() for k, v in batch.items()})
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    loss_tol, leaf_tol = LM_CPU_BOUND[dtype]
    loss_err = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    leaf_errs = [rel_l2(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True)]
    check(f"lm fine-tune, {dtype}: card against CPU at full width ({LM_CPU_LAYERS} layers, "
          f"{b} x {s} tokens): loss within {loss_tol} relative, every gradient leaf within "
          f"relative L2 {leaf_tol}; 1 flash forward and 1 backward launch a layer",
          loss_err <= loss_tol and max(leaf_errs) <= leaf_tol
          and launches["flash_attention"] == launches["flash_attention_bwd"] == LM_CPU_LAYERS,
          loss=float(got_loss), cpu_loss=float(want_loss), loss_rel_err=loss_err,
          max_leaf_rel_l2=max(leaf_errs), cpu_s=cpu_s)
    print(f"lm fine-tune card vs CPU ({dtype}, {LM_CPU_LAYERS} of 28 layers, {b} x {s} tokens): "
          f"loss {float(got_loss):.6f} vs {float(want_loss):.6f} ({loss_err:.2e}), leaves' "
          f"relative L2 max {max(leaf_errs):.2e} median {statistics.median(leaf_errs):.2e}; "
          f"CPU {cpu_s:.1f} s ({card})", flush=True)
    del params, got, cpu_params, want
    return {"loss_rel_err": loss_err, "leaf_rel_l2": leaf_errs, "cpu_s": cpu_s}


def codec_launches(codec, name: str) -> dict:
    """What one parallel round launches beyond attention: Null's fp32 wire
    is a leafwise weighted mean (no kernel), Int8 a quantize, a dequantize
    and a dequant_reduce a segment, LoRA the same for each fallback
    (non-matrix) segment plus a quantize and a dequantize of each matrix
    segment's factor pair."""
    if name == "fp32":
        return {}
    segs = list(codec.segments)
    if name == "int8":
        n = len(segs)
        return {"quantize_int8": n, "dequantize_int8": n, "dequant_reduce": n}
    n_lora = sum(codec._use_lora(s) for s in segs)
    n_fb = len(segs) - n_lora
    return {"quantize_int8": n_fb + 2 * n_lora, "dequantize_int8": n_fb + 2 * n_lora,
            "dequant_reduce": n_fb}


class RefTrap:
    """A context in which any call of ``kernels.ref`` raises: nothing on
    the card may reach a plain version."""

    def __enter__(self):
        from repro_torch.kernels import ref

        self.saved = {n: f for n, f in vars(ref).items()
                      if callable(f) and getattr(f, "__module__", None) == ref.__name__}

        def trap(name):
            def raise_(*args, **kwargs):
                raise AssertionError(f"kernels.ref.{name} reached on the card path")
            return raise_

        for n in self.saved:
            setattr(ref, n, trap(n))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        for n, f in self.saved.items():
            setattr(ref, n, f)
        return False


def lm_round_leg(card: str, out_dir: Path, cfg, params, name: str, dev="cuda", *,
                 clients: int = LM_C, trace: str = "lm_finetune_round_trace.json") -> dict:
    """Leg c for one codec: ``make_round_step`` (parallel, ``sgd(0.1)``,
    FedAvg) with the example's ``build_codec(name, params, LM_RANK)``,
    ``clients`` clients (C), batch 2 x 512 tokens, 2 local steps, 3 rounds
    of the example's batches, each round synchronized and timed, its launch
    counts set to 0 just before and read just after: exactly one flash
    forward and backward launch an attention layer and a selective_scan
    forward and backward a mamba layer, a local step, for the cohort (the
    vmap fold), ``codec_launches`` a round, nothing else, and no
    ``kernels.ref`` call; finite losses and params.  An MoE config also reports each
    layer's aux terms and drop fraction on client 0's first batch at the
    trained params.  The profiled codec runs a fourth round under the
    profiler (``DIR/<trace>.gz``): busy, idle, the flash, scan and codec
    kernels' shares, and an MoE config's stages (``moe_stage_us``)."""
    from repro_torch.core import FedAvg, RoundSpec, make_round_step
    from repro_torch.examples.federated_llm_finetune import build_codec
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_leaves, tree_size
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = tree_size(params)
    codec, int8 = build_codec(name, params, LM_RANK)
    strategy = FedAvg()
    round_step = make_round_step(build_model(cfg, device=dev).loss_fn, sgd(0.1), strategy,
                                 RoundSpec(max_steps=LM_STEPS, execution_mode="parallel",
                                           codec=codec))
    weights = torch.ones((clients,), device=dev)
    budgets = torch.full((clients,), LM_STEPS, dtype=torch.int32, device=dev)
    state, client_state = strategy.init_state(params), codec.init_client_state(clients, n,
                                                                               device=dev)
    kinds = [spec.kind for spec in cfg.layer_plan()]
    per_round = {k: v for k, v in (
        ("flash_attention", kinds.count("attn") * LM_STEPS),
        ("flash_attention_bwd", kinds.count("attn") * LM_STEPS),
        ("selective_scan", kinds.count("mamba") * LM_STEPS),
        ("selective_scan_bwd", kinds.count("mamba") * LM_STEPS)) if v}
    per_round.update(codec_launches(codec, name))
    g, losses, walls, launches = params, [], [], []
    torch.cuda.reset_peak_memory_stats()
    with RefTrap():
        for rnd in range(1, LM_ROUNDS + 1):
            batch = lm_batch(cfg, rnd, dev, clients=clients)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            g, state, client_state, metrics = round_step(g, state, client_state, batch,
                                                         weights, budgets, rnd)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append({k: v for k, v in ops.launch_counts().items() if v})
            losses.append(float(metrics["client_loss_mean"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(g))
    check(f"lm fine-tune [{name}] {cfg.name}: {LM_ROUNDS} rounds of C = {clients} at full "
          f"width ({cfg.n_layers} layers): finite losses and params; exactly {per_round} a "
          f"round, nothing else, no kernels.ref call",
          finite and all(math.isfinite(x) for x in losses)
          and all(c == per_round for c in launches),
          losses=losses, launches=launches, expected=per_round)
    round_s = statistics.median(walls)
    tokens = clients * LM_STEPS * LM_B * LM_SEQ
    out = {"round_s": walls, "round_s_median": round_s, "losses": losses,
           "launches_a_round": launches[0], "peak_memory_gb": peak_gb,
           "trained_tokens_per_s": tokens / round_s,
           "wire_bytes_a_client": codec.wire_bytes(n), "int8_wire_bytes": int8.wire_bytes(n)}
    print(f"lm fine-tune [{name}] {cfg.name} full width, {cfg.n_layers} layers ({n:,} params), "
          f"C={clients} x {LM_STEPS} steps x {LM_B} x {LM_SEQ}: round s "
          f"{[round(w, 4) for w in walls]} (median "
          f"{round_s:.4f}, {out['trained_tokens_per_s']:.0f} trained tokens/s), losses "
          f"{[round(x, 4) for x in losses]}, launches a round {launches[0]}, peak "
          f"{peak_gb:.2f} GB, wire {out['wire_bytes_a_client']:,} B a client "
          f"({out['int8_wire_bytes'] / out['wire_bytes_a_client']:.1f}x under Int8's) "
          f"({card})", flush=True)
    if cfg.moe is not None:
        out["moe_layers"] = moe_layer_terms(cfg, g, lm_batch(cfg, 1, dev, clients=1))
        print(f"  {cfg.name} [{name}] each MoE layer at the trained params (client 0's first "
              f"batch): {json.dumps(out['moe_layers'])} ({card})", flush=True)
    if name == LM_PROFILED:
        batch = lm_batch(cfg, LM_ROUNDS + 1, dev, clients=clients)
        moe = cfg.moe is not None
        prof = profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU] if moe else
                       [ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        with MoEStages() if moe else contextlib.nullcontext():
            prof.start()
            g, state, client_state, _ = round_step(g, state, client_state, batch, weights,
                                                   budgets, LM_ROUNDS + 1)
            torch.cuda.synchronize()
            prof.stop()
        busy_us, by_kernel = device_time(prof, MoEStages.WINDOWS)
        check(f"lm fine-tune [{name}]: the profiled round recorded card time", busy_us > 0,
              device_busy_us=busy_us)
        bwd_us = sum(us for k, us in by_kernel.items() if "flash_attention_bwd" in k)
        fwd_us = sum(us for k, us in by_kernel.items() if "flash_attention_kernel" in k)
        codec_us = sum(us for k, us in by_kernel.items()
                       if "quantize_int8" in k or "dequant_reduce" in k)
        scan_bwd_us = sum(us for k, us in by_kernel.items() if "selective_scan_bwd" in k)
        scan_us = sum(us for k, us in by_kernel.items() if "selective_scan_kernel" in k)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        out["profile"] = {
            "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e6 / round_s,
            "flash_bwd_ms": bwd_us / 1e3, "flash_bwd_share": bwd_us / busy_us,
            "flash_fwd_ms": fwd_us / 1e3, "flash_fwd_share": fwd_us / busy_us,
            "codec_ms": codec_us / 1e3, "codec_share": codec_us / busy_us,
            "scan_ms": scan_us / 1e3, "scan_share": scan_us / busy_us,
            "scan_bwd_ms": scan_bwd_us / 1e3, "scan_bwd_share": scan_bwd_us / busy_us,
            "top_device_us": top,
            "device_events": sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA),
        }
        if moe:
            out["profile"]["moe_stage_ms"] = {
                st: {k: us / 1e3 for k, us in v.items()} for st, v in moe_stage_us(prof).items()}
            out["profile"]["moe_stage_share"] = {
                st: (v["fwd"] + v["bwd"]) * 1e3 / busy_us
                for st, v in out["profile"]["moe_stage_ms"].items()}
        out["profile"].update(export_trace_or_summary(prof, out_dir / trace))
        p = out["profile"]
        print(f"lm fine-tune [{name}] {cfg.name} round {LM_ROUNDS + 1} profiled: card busy "
              f"{p['device_busy_ms']:.2f} ms, idle {p['idle_share']:.4f} of the unprofiled "
              f"median {round_s * 1e3:.2f} ms; flash backward {p['flash_bwd_ms']:.2f} ms "
              f"({p['flash_bwd_share']:.4f} of busy), forward {p['flash_fwd_ms']:.2f} ms "
              f"({p['flash_fwd_share']:.4f}); selective scan backward {p['scan_bwd_ms']:.2f} "
              f"ms ({p['scan_bwd_share']:.4f}), forward {p['scan_ms']:.2f} ms "
              f"({p['scan_share']:.4f}); codec kernels {p['codec_ms']:.2f} ms "
              f"({p['codec_share']:.4f}); {p['device_events']} device events, trace "
              f"{p['trace_gz_bytes']} B gzipped ({card})", flush=True)
        if moe:
            print(f"  MoE stages, device ms (forward, backward) and share of busy: "
                  f"{json.dumps(p['moe_stage_ms'])}; {json.dumps(p['moe_stage_share'])}",
                  flush=True)
        for k, us in top:
            print(f"  {us:10.1f} us  {k[:100]}", flush=True)
    del g, state, client_state
    return out


def lm_reduced_leg(card: str, argv: tuple = ()) -> dict:
    """Leg d: the example itself on the card at its defaults (qwen3-0.6b
    reduced to d_model 128 and 2 layers, 4 clients, 4 local steps of 2 x 64
    tokens, 8 rounds, fp32 wire), or with ``argv``: the loss of the last
    round below the first's, all finite."""
    import contextlib
    import io
    import re

    from repro_torch.examples import federated_llm_finetune as example

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        params, last = example.main(list(argv))
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r"mean client CE loss: (\S+)", text.getvalue())]
    args = " ".join(argv) or "its defaults"
    check(f"lm fine-tune example at {args} on the card: 8 finite round losses, the last "
          "below the first", len(losses) == 8 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and losses[-1] == round(last, 4), losses=losses)
    print(f"lm fine-tune example ({args}) on the card: losses {losses}, {seconds:.2f} s "
          f"({card})", flush=True)
    return {"losses": losses, "seconds": seconds}


def lm_finetune_phase(card: str, out_dir: Path) -> dict:
    """Phase 17: dense transformer training.  (a) the flash backward kernel
    and the forward's lse against their plain versions
    (``flash_backward_checks``); (b) the card against the CPU on a 2-layer
    cut of qwen3-0.6b at full width, fp32 and bf16 (``lm_card_vs_cpu``);
    (c) qwen3-0.6b at full width (bf16, 28 layers, 596,049,920 params) on
    the round engine with the fp32, Int8 and LoRA wires (``lm_round_leg``);
    (d) the example at its defaults (``lm_reduced_leg``)."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    out = {"flash_bwd_row": flash_backward_checks(torch.device("cuda"))}
    out["card_vs_cpu"] = {dt: lm_card_vs_cpu(card, dt) for dt in ("float32", "bfloat16")}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    params = build_model(cfg).init(0)
    out["rounds"] = {name: lm_round_leg(card, out_dir, cfg, params, name) for name in LM_CODECS}
    # the main path's launches: the flash kernels' in the Int8 leg's 3 rounds
    out["launches"] = {k: LM_ROUNDS * v
                       for k, v in out["rounds"][LM_PROFILED]["launches_a_round"].items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced"] = lm_reduced_leg(card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17 (LM fine-tuning): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 18: MoE fine-tuning (MoE transformer training) ----------------
# deepseek-moe-16b at full width (d_model 2048, MHA 16 x 128, 64 routed
# experts of 1408 top-6 + 2 shared, vocab 102,400), its depth cut 28 -> 2,
# on make_round_step, parallel mode, as the example builds it: 28 layers
# are 16.4B params, which do not train client-parallel on one card
MOE_FT_ARCH = "deepseek-moe-16b"
MOE_FT_LAYERS = 2
MOE_FT_PARAMS = 1_595_156_480   # JAX's init shapes at 2 layers (tests/test_torch_moe_train.py)
MOE_FT_C = 2
MOE_FT_PEAK_GB = 76.0           # the peak the 2-layer cut must stay under (else 1 layer)
MOE_LAYER_C, MOE_LAYER_B, MOE_LAYER_S = 2, 2, 512   # leg a: one layer's cohort
# leg a's bound, set before the first card run: phase 17 leg b's fp32 bound
# (fp32 sums in other orders on the card and the CPU), a gradient leaf's
# relative L2, held for each client whose routes agree
MOE_LAYER_BOUND = 1e-4
MOE_EXAMPLE_ARGV = ("--arch", "mixtral-8x7b", "--codec", "lora", "--rank", "4")


class MoEStages:
    """While active, each stage of the port's MoE layer runs inside
    ``record_function("moe <stage>")``: the router (``router_topk``), the
    dispatch, the expert products (``expert_ffn``), the combine and the
    shared experts (the MoE module's ``mlp_forward``)."""

    NAMES = {"router": "router_topk", "dispatch": "dispatch", "experts": "expert_ffn",
             "combine": "combine", "shared": "mlp_forward"}
    WINDOWS = tuple(f"moe {st}" for st in NAMES)

    def __enter__(self):
        from repro_torch.models.layers import moe

        self.saved = {st: getattr(moe, fn) for st, fn in self.NAMES.items()}

        def wrap(stage, fn):
            def run(*args, **kwargs):
                with torch.profiler.record_function(f"moe {stage}"):
                    return fn(*args, **kwargs)
            return run

        for st, fn in self.saved.items():
            setattr(moe, self.NAMES[st], wrap(st, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.models.layers import moe

        for st, fn in self.saved.items():
            setattr(moe, self.NAMES[st], fn)
        return False


def moe_stage_us(prof, cost=lambda e: sum(k.duration for k in e.kernels if k.name != e.name)
                 ) -> dict:
    """Device us of each MoE stage's forward and backward kernels in a
    profile (CPU and CUDA activity) taken under ``MoEStages``; ``cost`` is
    what a CPU op adds (its kernels' device us, not the span its own
    ``record_function`` lays on the device timeline; its own CPU us in a
    CPU rehearsal).  A kernel belongs to the CPU op that launched it; an op
    under a ``moe <stage>``
    window is that stage's forward.  A backward op runs under autograd's
    ``evaluate_function`` of a node whose sequence number is that of the
    forward op that made it: the last forward op to start with that number
    (the ops after it see the counter it moved on).  -> {stage: {"fwd",
    "bwd"}}."""
    from torch.autograd import DeviceType

    windows = dict(zip(MoEStages.WINDOWS, MoEStages.NAMES))

    def ancestry(e):
        stage = node = None
        while e is not None:
            if e.name in windows and stage is None:
                stage = windows[e.name]
            if e.name.startswith("autograd::engine::evaluate_function") and node is None:
                node = e.sequence_nr
            e = e.cpu_parent
        return stage, node

    cpu = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    # the forward's thread: autograd's device threads count sequence numbers of their own
    forward = {e.thread for e in cpu if e.name in windows}
    stage_of_node, out = {}, {st: {"fwd": 0.0, "bwd": 0.0} for st in MoEStages.NAMES}
    seen = []
    for e in cpu:
        stage, node = ancestry(e)
        seen.append((e, stage, node))
        if node is None and e.sequence_nr >= 0 and e.thread in forward:
            stage_of_node[e.sequence_nr] = stage
    for e, stage, node in seen:
        us = cost(e)
        if not us:
            continue
        if stage is not None and node is None:
            out[stage]["fwd"] += us
        elif node is not None and stage_of_node.get(node) is not None:
            out[stage_of_node[node]]["bwd"] += us
    return out


def moe_layer_terms(cfg, params, batch) -> dict:
    """Each MoE layer's ``moe_aux``, ``moe_z`` and drop fraction in
    ``loss_fn`` (no gradient) on one client's first local batch."""
    from repro_torch.models import build_model

    one = {k: v[0, 0] for k, v in batch.items()}
    with torch.no_grad(), MoEProbe() as probe:
        build_model(cfg, device=one["tokens"].device).loss_fn(params, one)
    return {k: [float(a[k]) for a in probe.aux] for k in ("moe_aux", "moe_z", "moe_drop_frac")}


def moe_layer_loss(cfg):
    """One MoE layer's training loss for a client: its output against a
    fixed weight, plus ``moe_loss`` -> (loss, (the chosen experts, sorted,
    the drop fraction))."""
    from repro_torch.models.layers import moe

    def loss(params, x, w):
        routes = []
        router = moe.router_topk

        def recorded(cfg_, p, xf):
            topv, topi, aux = router(cfg_, p, xf)
            routes.append(torch.sort(topi, dim=-1).values)
            return topv, topi, aux

        moe.router_topk = recorded
        try:
            out, aux = moe.moe_forward(cfg, params, x)
        finally:
            moe.router_topk = router
        return ((out.float() * w).mean() + moe.moe_loss(aux, cfg),
                (routes[0], aux["moe_drop_frac"]))
    return loss


def moe_layer_train_leg(card: str, dev="cuda") -> dict:
    """Leg a: one deepseek-moe-16b MoE layer at full width under
    ``vmap(grad_and_value)`` over C = 2 clients of 2 x 512 tokens, params
    shared (a round's first step), in fp32 and bf16, on the card under
    ``set_sync_debug_mode("error")``: two evaluations bitwise equal; each
    client's chosen experts against the port's CPU route on the same
    inputs (flips reported; none where the k-th / (k+1)-th router-logit gap
    exceeds MOE_GAP_EPS); in fp32 each routed-alike client's loss within
    1e-5 and every gradient leaf within relative L2 MOE_LAYER_BOUND of the
    CPU's.  The bf16 step timed, and its device ms by stage, forward and
    backward, from one profiler session."""
    import dataclasses
    import types

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import moe
    from repro_torch.utils.pytree import tree_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile

    base = get_config(MOE_FT_ARCH)
    d, k = base.d_model, base.moe.top_k
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        dt = torch.float32 if dtype == "float32" else torch.bfloat16
        gen = torch.Generator(device=dev)
        gen.manual_seed(18)
        params = moe.init_moe(gen, cfg, dt, device=dev)
        x = torch.randn((MOE_LAYER_C, MOE_LAYER_B, MOE_LAYER_S, d), generator=gen,
                        device=dev).to(dt)
        w = torch.randn(x.shape, generator=gen, device=dev)
        step = torch.func.vmap(torch.func.grad_and_value(moe_layer_loss(cfg), has_aux=True),
                               in_dims=(None, 0, 0))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, (loss, (routes, drop)) = step(params, x, w)
            again, (again_loss, _) = step(params, x, w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        bitwise = torch.equal(loss, again_loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again), strict=True))
        del again
        cpu_p = tree_map(lambda t: t.cpu(), params)
        xc = x.cpu()
        logits = torch.matmul(xc.float().reshape(MOE_LAYER_C, -1, d), cpu_p["router"])
        top = torch.sort(logits, dim=-1, descending=True).values
        gap = top[..., k - 1] - top[..., k]
        r = {"bitwise": bitwise, "drop_frac": [float(v) for v in drop],
             "loss": [float(v) for v in loss]}
        t0 = time.perf_counter()
        if dtype == "float32":
            want, (want_loss, (want_routes, _)) = step(cpu_p, xc, w.cpu())
        else:
            want_routes = torch.stack([
                torch.sort(moe.router_topk(cfg, cpu_p, xc[c].reshape(-1, d))[1], -1).values
                for c in range(MOE_LAYER_C)])
        r["cpu_s"] = time.perf_counter() - t0
        differ = (routes.cpu() != want_routes).any(-1)
        r["routing_flips"] = [int(v) for v in differ.sum(-1)]
        r["flips_above_eps"] = int((differ & (gap > MOE_GAP_EPS)).sum())
        r["smallest_gap"] = float(gap.min())
        ok = bitwise and r["flips_above_eps"] == 0 and all(math.isfinite(v) for v in r["loss"])
        if dtype == "float32":
            alike = [c for c in range(MOE_LAYER_C) if not bool(differ[c].any())]
            r["clients_compared"] = alike
            r["loss_rel_err"] = [abs(float(loss[c]) - float(want_loss[c])) / abs(
                float(want_loss[c])) for c in alike]
            r["leaf_rel_l2"] = [max(rel_l2(g[c], h[c]) for g, h in zip(
                tree_leaves(got), tree_leaves(want), strict=True)) for c in alike]
            ok = (ok and bool(alike) and max(r["loss_rel_err"]) <= 1e-5
                  and max(r["leaf_rel_l2"]) <= MOE_LAYER_BOUND)
            del want
        check(f"moe layer training [{dtype}]: deepseek-moe-16b's layer at full width, "
              f"vmap(grad) over C = {MOE_LAYER_C} x {MOE_LAYER_B} x {MOE_LAYER_S} tokens, no host "
              f"sync: two evaluations bitwise equal, routes equal to the CPU's where the gap "
              f"exceeds {MOE_GAP_EPS}" + ("" if dtype == "bfloat16" else
                                           f", loss within 1e-5 and every gradient leaf within "
                                           f"relative L2 {MOE_LAYER_BOUND} of the CPU's for each "
                                           f"client routed alike"), ok, **r)
        r["step_ms"] = time_ms(lambda: step(params, x, w), iters=5)
        if dtype == "bfloat16":
            # the second of two steps: the session's first launches can reach
            # the trace without the CPU op that made them.  A session in which
            # a stage read no card time is taken again (a record that lost
            # activities), up to PROFILE_SESSIONS sessions
            lost = []
            while True:
                active = []
                prof = profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU],
                               schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                               on_trace_ready=lambda p: active.append(p.events()))
                torch.cuda.synchronize()
                with MoEStages():
                    prof.start()
                    for _ in range(2):
                        step(params, x, w)
                        torch.cuda.synchronize()
                        prof.step()
                    prof.stop()
                seen = types.SimpleNamespace(events=lambda: active[0])
                busy_us, _ = device_time(seen, MoEStages.WINDOWS)
                r["profiled_busy_ms"] = busy_us / 1e3
                r["stage_ms"] = {st: {kk: us / 1e3 for kk, us in v.items()}
                                 for st, v in moe_stage_us(seen).items()}
                staged = busy_us > 0 and all(v["fwd"] > 0 and v["bwd"] > 0
                                             for v in r["stage_ms"].values())
                if staged or len(lost) + 1 == PROFILE_SESSIONS:
                    break
                lost.append(r["stage_ms"])
                print(f"moe layer training [bfloat16]: profiler session {len(lost)} read a "
                      f"stage without card time: {json.dumps(r['stage_ms'])}",
                      file=sys.stderr, flush=True)
            check("moe layer training [bfloat16]: the profiled step's stages recorded card time",
                  staged, stage_ms=r["stage_ms"], lost_sessions=lost)
        print(f"moe layer training [{dtype}] deepseek-moe-16b full-width layer, C={MOE_LAYER_C} x "
              f"{MOE_LAYER_B} x {MOE_LAYER_S}: step {r['step_ms']:.3f} ms (forward and backward, "
              f"the cohort), bitwise {bitwise}, drop {r['drop_frac']}, route flips against the "
              f"CPU {r['routing_flips']} (smallest gap {r['smallest_gap']:.2e})"
              + (f", loss rel err {r['loss_rel_err']}, max leaf rel L2 {r['leaf_rel_l2']}"
                 if dtype == "float32" else
                 f"; device ms by stage (forward, backward) {json.dumps(r['stage_ms'])} of "
                 f"{r['profiled_busy_ms']:.3f} busy") + f"; CPU {r['cpu_s']:.1f} s ({card})",
              flush=True)
        out[dtype] = r
        del params, x, w, got, cpu_p, xc
    return out


def moe_finetune_phase(card: str, out_dir: Path) -> dict:
    """Phase 18: MoE training.  (a) one deepseek-moe-16b MoE layer at full
    width under ``vmap(grad)`` (``moe_layer_train_leg``); (b) deepseek-moe-16b
    at full width cut to ``MOE_FT_LAYERS`` layers (bf16, 1,595,156,480
    params) on the round engine with the fp32, Int8 and LoRA wires, C = 2
    (``lm_round_leg``), its peak memory under MOE_FT_PEAK_GB; (c) the
    reference's documented MoE command, the example at ``--arch
    mixtral-8x7b --codec lora --rank 4`` (reduced) on the card
    (``lm_reduced_leg``).  Phase 17's leg a holds the flash backward at
    this path's head shape."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_size

    t0 = time.perf_counter()
    out = {"layer": moe_layer_train_leg(card)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_FT_ARCH), n_layers=MOE_FT_LAYERS)
    params = build_model(cfg).init(0)
    n = tree_size(params)
    check(f"moe fine-tune: {MOE_FT_ARCH} at full width cut to {MOE_FT_LAYERS} layers has JAX's "
          f"{MOE_FT_PARAMS:,} params", n == MOE_FT_PARAMS, params=n)
    out["rounds"] = {name: lm_round_leg(card, out_dir, cfg, params, name, clients=MOE_FT_C,
                                        trace="moe_finetune_round_trace.json")
                     for name in LM_CODECS}
    peak = max(r["peak_memory_gb"] for r in out["rounds"].values())
    check(f"moe fine-tune: peak memory under {MOE_FT_PEAK_GB} GB at {MOE_FT_LAYERS} layers",
          peak <= MOE_FT_PEAK_GB, peak_gb=peak)
    out["launches"] = {k: LM_ROUNDS * v
                       for k, v in out["rounds"][LM_PROFILED]["launches_a_round"].items()}
    out.update(arch=MOE_FT_ARCH, depth_cut=MOE_FT_LAYERS, params=n, clients=MOE_FT_C)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["example"] = lm_reduced_leg(card, MOE_EXAMPLE_ARGV)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (MoE fine-tuning): {out['seconds']:.2f} s ({card})", flush=True)
    return out


# ---------------- phase 19: MLA and frontend-token fine-tuning ----------------
# minicpm3-4b at full width (d 2560, 40 heads, qk 64 + 32 over v 64, ranks
# 768 / 256, vocab 73,448), its depth cut 62 -> 8 (the 62 layers' 4.07B
# params do not train client-parallel on one card), on make_round_step as
# phase 17's leg c with C = 2; paligemma-3b whole (18 layers, 256 frontend
# positions of 1152, 8 heads over 1 at D = 256, vocab 257,216) for one
# value_and_grad step, as tests/test_models_smoke.py:43 trains it
MLA_FT_ARCH = "minicpm3-4b"
MLA_FT_LAYERS = 8
MLA_FT_PARAMS = 689_428_992     # JAX's init shapes at 8 layers (tests/test_torch_mla_train.py)
MLA_FT_C = 2
VLM_FT_ARCH = "paligemma-3b"
VLM_FT_PARAMS = 2_511_022_080   # JAX's init shapes, whole
VLM_FT_B, VLM_FT_SEQ, VLM_FT_LR = 2, 512, 0.01
# leg d: 2-layer cuts at full width, card against CPU in fp32, B = 1 and 128
# text tokens after the frontend positions (the CPU side stays short)
FRONTEND_CPU_LAYERS = 2
FRONTEND_CPU_PARAMS = {"paligemma-3b": 749_348_864, "musicgen-medium": 82_983_936}
FRONTEND_CPU_TOKENS = (1, 128)
MLA_LAYER_C, MLA_LAYER_B, MLA_LAYER_S = 2, 2, 512   # leg a: one layer's cohort
# legs a and d's bound, set before the first card run: flash's fp32
# tolerance (ATTN_TOL), a gradient's relative L2 against the CPU's (fp32 sums
# in other orders: the flash kernels, cuBLAS against the CPU's GEMMs)
MLA_FT_BOUND = ATTN_TOL[torch.float32]


def mla_layer_loss(cfg):
    """One MLA layer's training loss for a client: its output against a
    fixed fp32 weight."""
    from repro_torch.models.layers import mla

    def loss(params, x, w):
        return (mla.mla_forward(cfg, params, x)[0].float() * w).sum()
    return loss


def mla_layer_train_leg(card: str, dev="cuda") -> dict:
    """Leg a: one minicpm3-4b MLA layer at full width under
    ``vmap(grad_and_value)`` over C = 2 clients of 2 x 512 tokens, params
    shared (a round's first step), the norm scales drawn away from zero,
    in fp32 and bf16, on the card under ``set_sync_debug_mode("error")``:
    two evaluations bitwise equal, one flash forward and one backward
    launch an evaluation (the cohort folded into B), no ``kernels.ref``
    call; in fp32 each client's loss and the gradient of x and of every
    leaf within relative L2 MLA_FT_BOUND of the port's CPU route on the
    same inputs.  Each step timed."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import mla
    from repro_torch.utils.pytree import tree_leaves, tree_map

    base = get_config(MLA_FT_ARCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        dt = torch.float32 if dtype == "float32" else torch.bfloat16
        gen = torch.Generator(device=dev)
        gen.manual_seed(19)
        params = mla.init_mla(gen, cfg, dt, device=dev)
        for key in ("q_norm", "kv_norm"):
            params[key] = 0.1 * torch.randn(params[key].shape, generator=gen, device=dev)
        x = torch.randn((MLA_LAYER_C, MLA_LAYER_B, MLA_LAYER_S, cfg.d_model), generator=gen,
                        device=dev).to(dt)
        w = torch.randn(x.shape, generator=gen, device=dev)
        step = torch.func.vmap(torch.func.grad_and_value(mla_layer_loss(cfg), argnums=(0, 1)),
                               in_dims=(None, 0, 0))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with RefTrap():
                got, loss = step(params, x, w)
                again, again_loss = step(params, x, w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        bitwise = torch.equal(loss, again_loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again), strict=True))
        del again
        r = {"bitwise": bitwise, "launches_two_evaluations": launches,
             "loss": [float(v) for v in loss]}
        ok = (bitwise and launches == {"flash_attention": 2, "flash_attention_bwd": 2}
              and all(math.isfinite(v) for v in r["loss"])
              and all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(got)))
        if dtype == "float32":
            t0 = time.perf_counter()
            want, want_loss = step(tree_map(lambda t: t.cpu(), params), x.cpu(), w.cpu())
            r["cpu_s"] = time.perf_counter() - t0
            r["loss_rel_err"] = max(abs(float(a) - float(b)) / abs(float(b))
                                    for a, b in zip(loss, want_loss))
            r["leaf_rel_l2"] = {k: rel_l2(g, h) for k, g, h in zip(
                ["x"] + sorted(params), [got[1]] + [got[0][k] for k in sorted(params)],
                [want[1]] + [want[0][k] for k in sorted(params)])}
            worst = max(r["leaf_rel_l2"].values())
            ok = ok and r["loss_rel_err"] <= MLA_FT_BOUND and worst <= MLA_FT_BOUND
            del want
        check(f"mla layer training [{dtype}]: minicpm3-4b's layer at full width (40 heads, qk "
              f"96 over v 64), vmap(grad) over C = {MLA_LAYER_C} x {MLA_LAYER_B} x "
              f"{MLA_LAYER_S} tokens, no host sync, no kernels.ref call: two evaluations "
              f"bitwise equal, 1 flash forward and 1 backward launch each"
              + ("" if dtype == "bfloat16" else
                 f", each client's loss and the gradient of x and every leaf within relative "
                 f"L2 {MLA_FT_BOUND} of the CPU's"), ok, **r)
        r["step_ms"] = time_ms(lambda: step(params, x, w), iters=5)
        print(f"mla layer training [{dtype}] minicpm3-4b full-width layer, C={MLA_LAYER_C} x "
              f"{MLA_LAYER_B} x {MLA_LAYER_S}: step {r['step_ms']:.3f} ms (forward and backward, "
              f"the cohort), bitwise {bitwise}, launches {launches}"
              + (f", loss rel err {r['loss_rel_err']:.2e}, max leaf rel L2 "
                 f"{max(r['leaf_rel_l2'].values()):.2e}; CPU {r['cpu_s']:.1f} s"
                 if dtype == "float32" else "") + f" ({card})", flush=True)
        out[dtype] = r
        del params, x, w, got
    return out


def frontend_step_leg(card: str, dev="cuda") -> dict:
    """Leg c: paligemma-3b whole (18 layers, bf16) for the reference smoke
    test's step: ``grad_and_value(loss_fn)`` on B = 2 of 512 tokens after
    the 256 frontend positions, then p - 0.01 g.  The loss finite and
    positive, every updated leaf finite, ``frontend_proj.w``'s gradient
    finite and nonzero; 18 flash forward and 18 backward launches (8 heads
    over 1 at D = 256) and nothing else, no ``kernels.ref`` call; the step
    timed (synchronized), its peak memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size

    cfg = get_config(VLM_FT_ARCH)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    n = tree_size(params)
    batch = lm_batch(cfg, 1, dev, clients=1, steps=1, batch=VLM_FT_B, seq=VLM_FT_SEQ)
    batch = {k: v[0, 0] for k, v in batch.items()}
    batch.update(frontend_of(cfg, np.random.default_rng(19), VLM_FT_B, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with RefTrap():
        for _ in range(2):   # the first step builds, the second is timed
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            grads, (loss, met) = torch.func.grad_and_value(model.loss_fn, has_aux=True)(
                params, batch)
            new = tree_map(lambda p, g: p - VLM_FT_LR * g.to(p.dtype), params, grads)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fgrad = grads["frontend_proj"]["w"]
    want = {"flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    r = {"params": n, "loss": float(loss), "ce": float(met["ce"]), "launches": launches,
         "step_s": walls, "peak_memory_gb": peak_gb,
         "frontend_grad_abs_max": float(fgrad.float().abs().max()),
         "tokens": VLM_FT_B * (cfg.frontend_tokens + VLM_FT_SEQ)}
    check(f"frontend fine-tune: {VLM_FT_ARCH} whole ({n:,} params = JAX's {VLM_FT_PARAMS:,}), "
          f"one value_and_grad step and SGD({VLM_FT_LR}) on {VLM_FT_B} x ({cfg.frontend_tokens} "
          f"frontend + {VLM_FT_SEQ}) tokens: loss finite and positive, every updated leaf "
          f"finite, frontend_proj.w's gradient finite and nonzero, exactly {want} and no "
          f"kernels.ref call",
          n == VLM_FT_PARAMS and math.isfinite(r["loss"]) and r["loss"] > 0
          and all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(new))
          and bool(torch.isfinite(fgrad.float()).all()) and r["frontend_grad_abs_max"] > 0
          and launches == want, **r)
    print(f"frontend fine-tune {VLM_FT_ARCH} whole ({n:,} params), {VLM_FT_B} x "
          f"({cfg.frontend_tokens} + {VLM_FT_SEQ}) tokens: loss {r['loss']:.4f}, step s "
          f"{[round(x, 4) for x in walls]}, {r['tokens'] / walls[-1]:.0f} trained tokens/s, "
          f"peak {peak_gb:.2f} GB, launches {launches}, |grad frontend_proj.w|max "
          f"{r['frontend_grad_abs_max']:.3e} ({card})", flush=True)
    del params, grads, new, model
    return r


def frontend_card_vs_cpu(card: str, arch: str) -> dict:
    """Leg d: ``arch`` at full width cut to FRONTEND_CPU_LAYERS layers, fp32,
    one client's batch of FRONTEND_CPU_TOKENS text tokens after the
    frontend positions: ``loss_fn``'s value and every leaf's gradient
    (``frontend_proj.w`` included) on the card within relative L2
    MLA_FT_BOUND of the port's CPU route on identical params and inputs;
    one flash forward and one backward launch a layer, no ``kernels.ref``
    call on the card."""
    import dataclasses
    import os

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size

    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(get_config(arch), n_layers=FRONTEND_CPU_LAYERS, dtype="float32")
    card_m, cpu_m = build_model(cfg), build_model(cfg, device="cpu")
    params = card_m.init(0)
    n = tree_size(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    b, s = FRONTEND_CPU_TOKENS
    batch = {k: v[0, 0] for k, v in lm_batch(cfg, 1, "cpu", clients=1, steps=1, batch=b,
                                             seq=s).items()}
    batch.update(frontend_of(cfg, np.random.default_rng(20), b, "cpu"))
    t0 = time.perf_counter()
    want, (want_loss, _) = torch.func.grad_and_value(cpu_m.loss_fn, has_aux=True)(
        cpu_params, batch)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with RefTrap():
        got, (got_loss, _) = torch.func.grad_and_value(card_m.loss_fn, has_aux=True)(
            params, {k: v.cuda() for k, v in batch.items()})
        launches = {k: v for k, v in ops.launch_counts().items() if v}
    torch.cuda.synchronize()
    loss_err = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    leaf_errs = [rel_l2(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True)]
    front = rel_l2(got["frontend_proj"]["w"], want["frontend_proj"]["w"])
    per_layer = {"flash_attention": FRONTEND_CPU_LAYERS,
                 "flash_attention_bwd": FRONTEND_CPU_LAYERS}
    check(f"frontend fine-tune, fp32: {arch} at full width cut to {FRONTEND_CPU_LAYERS} layers "
          f"({n:,} params = JAX's {FRONTEND_CPU_PARAMS[arch]:,}), {b} x ({cfg.frontend_tokens} "
          f"frontend + {s}) tokens, card against CPU: loss and every gradient leaf "
          f"(frontend_proj.w included) within relative L2 {MLA_FT_BOUND}; exactly {per_layer}, "
          f"no kernels.ref call",
          n == FRONTEND_CPU_PARAMS[arch] and loss_err <= MLA_FT_BOUND
          and max(leaf_errs) <= MLA_FT_BOUND and launches == per_layer,
          loss=float(got_loss), cpu_loss=float(want_loss), loss_rel_err=loss_err,
          max_leaf_rel_l2=max(leaf_errs), frontend_proj_rel_l2=front, launches=launches,
          cpu_s=cpu_s)
    print(f"frontend fine-tune card vs CPU ({arch}, fp32, {FRONTEND_CPU_LAYERS} layers, {b} x "
          f"({cfg.frontend_tokens} + {s}) tokens): loss {float(got_loss):.6f} vs "
          f"{float(want_loss):.6f} ({loss_err:.2e}), leaves' relative L2 max "
          f"{max(leaf_errs):.2e} median {statistics.median(leaf_errs):.2e}, frontend_proj.w "
          f"{front:.2e}; CPU {cpu_s:.1f} s ({card})", flush=True)
    del params, got, cpu_params, want
    return {"loss_rel_err": loss_err, "leaf_rel_l2": leaf_errs, "frontend_proj_rel_l2": front,
            "cpu_s": cpu_s}


def mla_frontend_finetune_phase(card: str, out_dir: Path) -> dict:
    """Phase 19: MLA and frontend-token training.  (a) one minicpm3-4b MLA
    layer at full width under ``vmap(grad)`` (``mla_layer_train_leg``); (b)
    minicpm3-4b at full width cut to ``MLA_FT_LAYERS`` layers (bf16,
    689,428,992 params) on the round engine with the fp32, Int8 and LoRA
    wires, C = 2 (``lm_round_leg``); (c) paligemma-3b whole, one
    value_and_grad step and an SGD update (``frontend_step_leg``); (d)
    2-layer cuts of paligemma-3b and musicgen-medium at full width, the
    card against the CPU in fp32 (``frontend_card_vs_cpu``).  Phase 17's
    leg a holds and times the flash backward at this path's MLA and
    paligemma shapes."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_size

    out = {"layer": mla_layer_train_leg(card)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MLA_FT_ARCH), n_layers=MLA_FT_LAYERS)
    params = build_model(cfg).init(0)
    n = tree_size(params)
    check(f"mla fine-tune: {MLA_FT_ARCH} at full width cut to {MLA_FT_LAYERS} layers has JAX's "
          f"{MLA_FT_PARAMS:,} params", n == MLA_FT_PARAMS, params=n)
    out["rounds"] = {name: lm_round_leg(card, out_dir, cfg, params, name, clients=MLA_FT_C,
                                        trace="mla_finetune_round_trace.json")
                     for name in LM_CODECS}
    out["launches"] = {k: LM_ROUNDS * v
                       for k, v in out["rounds"][LM_PROFILED]["launches_a_round"].items()}
    out.update(arch=MLA_FT_ARCH, depth_cut=MLA_FT_LAYERS, params=n, clients=MLA_FT_C)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["frontend_step"] = frontend_step_leg(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = {arch: frontend_card_vs_cpu(card, arch) for arch in FRONTEND_CPU_PARAMS}
    return out


# ---------------- phase 20: hybrid Mamba fine-tuning ----------------
# jamba-1.5-large-398b at full width (d_model 8192, d_inner 16384, d_state
# 16, dt_rank 512, 64 heads over 8 KV heads, d_ff 24576, vocab 65,536),
# its depth and experts cut: 398B params do not fit one card
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_FT_PARAMS = 2_098_077_696    # leg c: 1 layer without experts, [mamba]
HYBRID_CPU_PARAMS = 2_853_068_800   # leg e: 2 layers by reduced()'s plan rule, [mamba, attn]
# (config change, params from JAX's init shapes, layer kinds):
# tests/test_torch_mamba_train.py holds the counts against JAX's eval_shape
HYBRID_CUTS = (
    ({"n_layers": 1, "moe": None}, HYBRID_FT_PARAMS, ["mamba"]),
    ({"n_layers": 2, "moe": None, "attn_layer_period": 2, "attn_layer_offset": 1},
     HYBRID_CPU_PARAMS, ["mamba", "attn"]),
    ({"n_layers": 8, "moe": None}, JAMBA_SLICE_PARAMS, ["mamba"] * 4 + ["attn"] + ["mamba"] * 3),
)
HYBRID_FT_C = 2
HYBRID_PEAK_GB = 76.0           # legs c and d: the peak each must stay under
HYBRID_LAYER_C, HYBRID_LAYER_B, HYBRID_LAYER_S = 2, 2, 512   # leg b: one layer's cohort
HYBRID_LAYER_CPU_S = 128        # leg b: the fp32 evaluation held against the CPU
HYBRID_STEP_B, HYBRID_STEP_SEQ, HYBRID_STEP_LR = 2, 512, 0.01   # leg d
HYBRID_CPU_TOKENS = (1, 128)    # leg e
# legs b and e's bound, set before the first card run: phase 19's (a
# gradient's relative L2 against the CPU's; fp32 sums in other orders: the
# scan's reductions, cuBLAS against the CPU's GEMMs)
HYBRID_FT_BOUND = MLA_FT_BOUND
# leg b's loss, a sum of 2 x 128 x 8192 fp32 products that cancels to
# ~3e-4 of their magnitudes: its error against the CPU's over the sum of
# the terms' magnitudes.  An H100 read 5.0e-9 in every run; the limit
# leaves 20x.  TF32 products in the mixer (10 mantissa bits for 23)
# would scale each term's error by ~2**13 and read ~4e-5.
HYBRID_LOSS_OF_TERMS = 1e-7
# leg a's a-priori bounds, relative L2 an output: fp32 1e-5 -- the states
# are bitwise the plain version's, so the gradients differ only by the
# order of fp32 sums (over N, over 16,384 channels for dB and dC, over
# B·S for dA and dD, FMAs) carried by the reverse recurrence, a few
# hundred ulps at most; a bf16 dx 2**-8: one rounding of fp32 values that
# differ in their last bits can land on either bf16 neighbour
SCAN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}
# leg a: label, B, S, Di, N, x dtype, groups, initial state, final-state
# cotangent, long memory, groups' A and D equal (a vmapped cohort's first
# local step: the global params unmapped)
SCAN_BWD_CASES = [
    ("layer shape, shared A", HYBRID_LAYER_C * HYBRID_LAYER_B, HYBRID_LAYER_S, 16384, 16,
     torch.bfloat16, 2, False, False, False, True),
    ("layer shape, per-client A", HYBRID_LAYER_C * HYBRID_LAYER_B, HYBRID_LAYER_S, 16384, 16,
     torch.bfloat16, 2, False, True, False, False),
    ("layer shape, fp32", HYBRID_LAYER_C * HYBRID_LAYER_B, HYBRID_LAYER_S, 16384, 16,
     torch.float32, 2, False, True, False, False),
    ("S=1, Di=300, init", 2, 1, 300, 16, torch.float32, 1, True, True, False, False),
    ("S=37, Di=300, N=5, init", 2, 37, 300, 5, torch.bfloat16, 1, True, False, False, False),
    ("S=1000, Di=300, N=8", 2, 1000, 300, 8, torch.float32, 1, False, True, False, False),
    ("N=32, G=4", 4, 100, 300, 32, torch.float32, 4, True, True, False, False),
    ("N=64, init", 1, 1000, 256, 64, torch.float32, 1, True, True, False, False),
    ("N=64, bf16, G=2", 2, 77, 300, 64, torch.bfloat16, 2, False, False, False, False),
    ("long memory, Di=300", 2, 1024, 300, 16, torch.bfloat16, 1, False, True, True, False),
    ("long memory, fp32, init", 2, 1024, 300, 16, torch.float32, 1, True, True, True, False),
]
SCAN_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
# the one case at the layer's width held against torch autograd of the
# plain forward too (the Di <= 300 cases hold every path against it; at
# the layer's width autograd's 512-step graph takes seconds a case)
SCAN_BWD_AUTOGRAD_AT_WIDTH = "layer shape, fp32"


def scan_bwd_bound(b: int, s: int, di: int, n: int, moved: int) -> dict:
    """The scan backward's least time: its bytes (inputs read once,
    gradients written once; the forward's checkpoints are this kernel's
    design, not the function's, and are left out) at 3.35 TB/s; its fp32
    operations (6 a state element a step to recompute the state, 12 for
    the reverse terms: g, du, a_t h g, ddt's and dA's sums, dB's product,
    the carry; and dC's product and the two channel sums, 3) at 67
    TFLOP/s; and one exponential a state element a step (a_t, which the
    kernel keeps from the recompute) at 16 a clock per SM; the largest
    binds."""
    clock = max_sm_clock_hz()
    steps = b * s * di * n
    flops = 21 * steps + 6 * b * s * di
    t = {"bytes": moved / HBM_BYTES_PER_S, "flops": flops / FP32_FLOP_PER_S,
         "exps": steps / (MUFU_EX2_PER_CLOCK_PER_SM * H100_SMS * clock)}
    worst = max(t, key=t.get)
    return dict(bound_ms=t[worst] * 1e3, bound_by="bytes" if worst == "bytes" else "operations",
                bound_terms_us={k: v * 1e6 for k, v in t.items()}, flops=flops,
                exponentials=steps, sm_clock_hz=clock, bytes=moved)


def scan_bwd_inputs(gen, b, s, di, n, dtype, groups, init, dh, long_memory, shared, dev):
    """``scan_inputs``' draws with A (G, Di, N) and D (G, Di) -- each group
    its own, or one repeated (``shared``) -- dy ~ N in x's dtype and an
    optional final-state cotangent."""
    x, dt, a, bm, cm, d, h0 = scan_inputs(gen, b, s, di, n, dtype, init,
                                          long_memory=long_memory, dev=dev)
    if shared:
        a, d = a.expand(groups, di, n).contiguous(), d.expand(groups, di).contiguous()
    else:
        a = torch.stack([a * (1 + 0.05 * k) for k in range(groups)])
        d = torch.stack([d * (1 - 0.1 * k) for k in range(groups)])
    dy = torch.randn((b, s, di), generator=gen, device=dev).to(dtype)
    dhf = torch.randn((b, di, n), generator=gen, device=dev) if dh else None
    return x, dt, a, bm, cm, d, dy, h0, dhf


def scan_bwd_build_checks() -> dict:
    """ptxas' registers and spills for the eight selective_scan_bwd kernels
    and the sum kernel: no spill in any, at most 128 registers a backward
    thread; and the blocks an SM the runtime grants each backward
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its 512 threads
    and shared memory): one, 16 warps, in each."""
    import ctypes
    import re

    from repro_torch.kernels import _cuda

    def name_of(line):
        entry = re.search(r"Compiling entry function '\S*?selective_scan_bwd_kernelI"
                          r"(f|13__nv_bfloat16)Li(\d+)E", line)
        if entry:
            return f"selective_scan_bwd_kernel<{'float' if entry[1] == 'f' else 'bf16'}, {entry[2]}>"
        return "selective_scan_bwd_sum_kernel" if "selective_scan_bwd_sum_kernel" in line else None

    ptxas = ptxas_report("selective_scan", name_of)
    query = _cuda.library("selective_scan").repro_selective_scan_bwd_blocks_per_sm
    for name, info in ptxas.items():
        entry = re.fullmatch(r"selective_scan_bwd_kernel<(\w+), (\d+)>", name)
        if entry:
            out = ctypes.c_int64(0)
            info["query_rc"] = query(int(entry[2]), int(entry[1] == "bf16"), ctypes.byref(out))
            info["blocks_per_sm"] = out.value
            info["warps_per_sm"] = out.value * 512 // 32
    bwd = {k: v for k, v in ptxas.items() if "blocks_per_sm" in v}
    check("ptxas reports the 8 selective_scan_bwd kernels and the sum kernel, no spill in any, "
          "at most 128 registers a backward thread, each backward one 512-thread block (16 warps) "
          "an SM", len(ptxas) == 9 and len(bwd) == 8 and no_spill(ptxas)
          and all(v.get("registers", 999) <= 128 and v["query_rc"] == 0
                  and v["blocks_per_sm"] == 1 for v in bwd.values()), kernels=ptxas)
    return ptxas


def scan_backward_checks(dev) -> dict:
    """Leg a: the training forward (checkpoints every 8 steps) and the
    backward kernel at ``SCAN_BWD_CASES``: one launch of each a call; the
    forward's y and state bitwise the serving forward's; every gradient
    against ``ref.selective_scan_bwd`` and against torch autograd of
    ``ref.selective_scan`` (at Di <= 300 and in
    ``SCAN_BWD_AUTOGRAD_AT_WIDTH``) on the same inputs within
    ``SCAN_BWD_TOL`` (relative L2); at S <= 100 and Di <= 300 bitwise
    ``tests/torch_kernel_models.py``'s ``scan_bwd_kernel_order`` (the
    checkpoints too; the model steps through time in a few hundred small
    ops a step); two calls bitwise equal.  At the layer leg's shape
    (per-client A) the backward timed through the wrapper and as a bare
    launch beside its bound and the plain version (the check's one call,
    event-timed: half a second a call), and the forward with checkpoints
    against the forward without (wrapper and bare).  Then ptxas.  -> the
    backward's kernel row."""
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels import selective_scan as sk
    from torch_kernel_models import scan_bwd_kernel_order

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    row = None
    for label, b, sl, di, n, dtype, groups, init, dh, long_memory, shared in SCAN_BWD_CASES:
        t_case = time.perf_counter()
        x, dt, a, bm, cm, d, dy, h0, dhf = scan_bwd_inputs(gen, b, sl, di, n, dtype, groups, init,
                                                           dh, long_memory, shared, dev)
        kw = dict(init_state=h0, groups=groups)
        ops.reset_launch_counts()
        y, h, ck = sk.selective_scan_fwd(x, dt, a, bm, cm, d, **kw)
        grads = sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf, **kw)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        again = sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf, **kw)
        bitwise = all(torch.equal(g, q) for g, q in zip(grads, again) if g is not None)
        del again
        ys, hs = sk.selective_scan(x, dt, a, bm, cm, d, **kw)
        same_fwd = torch.equal(y, ys) and torch.equal(h, hs)
        del ys, hs
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        plain = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, dh_final=dhf, **kw)
        marks[1].record()
        autograd = di <= 300 or label == SCAN_BWD_AUTOGRAD_AT_WIDTH
        auto = [None] * len(SCAN_BWD_NAMES)
        if autograd:
            leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, d)]
            h0r = None if h0 is None else h0.clone().requires_grad_()
            yr, hr = ref.selective_scan(*leaves, init_state=h0r, groups=groups)
            loss = (yr.float() * dy.float()).sum() + (0 if dhf is None else (hr * dhf).sum())
            loss.backward()
            auto = [t.grad for t in leaves] + [None if h0r is None else h0r.grad]
            del yr, hr, loss, leaves, h0r
        errs, ok = {}, bitwise and same_fwd and launches == {"selective_scan": 1,
                                                              "selective_scan_bwd": 1}
        for name, g, p, q in zip(SCAN_BWD_NAMES, grads, plain, auto):
            if g is None:
                ok = ok and p is None and q is None
                continue
            tol = SCAN_BWD_TOL[dtype if name == "dx" else torch.float32]
            errs[f"{name}_plain"] = rel_l2(g, p)
            ok = (ok and g.shape == p.shape and bool(torch.isfinite(g.float()).all())
                  and errs[f"{name}_plain"] <= tol)
            if autograd:
                errs[f"{name}_autograd"] = rel_l2(g, q)
                ok = ok and errs[f"{name}_autograd"] <= tol
        info = {}
        modelled = sl <= 100 and di <= 300
        if modelled:
            model, model_ck, same_states = scan_bwd_kernel_order(x, dt, a, bm, cm, d, dy,
                                                                 dh_final=dhf, **kw)
            info["model_bitwise"] = (torch.equal(ck, model_ck) and same_states and all(
                torch.equal(g, m) for g, m in zip(grads, model) if g is not None))
            ok = ok and info["model_bitwise"]
            del model, model_ck
        check(f"selective_scan_bwd [{label}: x {tuple(x.shape)} {dtype}, N={n}, G={groups}, "
              f"init {init}, dh {dh}, long memory {long_memory}]: one forward and one backward "
              f"launch, the forward bitwise the serving forward, every gradient within "
              f"relative L2 {SCAN_BWD_TOL[torch.float32]} (a bf16 dx {SCAN_BWD_TOL[torch.bfloat16]}) "
              f"of ref.selective_scan_bwd" + (" and of autograd of ref.selective_scan"
                                              if autograd else "") + ", two calls "
              f"bitwise equal" + (", bitwise the kernel model" if modelled else ""),
              ok, bitwise=bitwise, launches=launches, seconds=time.perf_counter() - t_case,
              **errs, **info)
        del auto
        if label != "layer shape, per-client A":
            del x, dt, a, bm, cm, d, dy, h0, dhf, y, h, ck, grads, plain
            continue
        outs = [torch.empty_like(t) for t in (x, dt, bm, cm, a, d)]   # dx, ddt, dB, dC, dA, dD
        n_max = next(m for m in sk.N_BUCKETS if n <= m)
        part = torch.empty((-(-di // sk.bwd_channels(n)), b, sl, 2, n_max), device=dev)
        arow, drow = torch.empty((b, di, n), device=dev), torch.empty((b, di), device=dev)
        yo, ho = torch.empty_like(y), torch.empty_like(h)
        fwd_args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    d.data_ptr(), None,
                    yo.data_ptr(), ho.data_ptr())
        bare = lambda: _cuda.launch(  # noqa: E731
            "selective_scan", "repro_selective_scan_bwd_bf16", "selective_scan_bwd", dev,
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            d.data_ptr(), dy.data_ptr(), ck.data_ptr(),
            dhf.data_ptr(), *(t.data_ptr() for t in outs), None, part.data_ptr(),
            arow.data_ptr(), drow.data_ptr(), b, sl, di, n, di, groups, part.shape[0])
        fwd_bare = lambda keep: lambda: _cuda.launch(  # noqa: E731
            "selective_scan", "repro_selective_scan_bf16", "selective_scan", dev, *fwd_args,
            ck.data_ptr() if keep else None, b, sl, di, n, di, groups)
        moved = nbytes(x, dt, a, bm, cm, d, dy, dhf, *grads[:6])
        row = dict(
            source="src/repro_torch/kernels/csrc/selective_scan.cu",
            replaces="src/repro/kernels/ref.py:169",
            max_abs_err=max(float((g.float() - p.float()).abs().max())
                            for g, p in zip(grads, plain) if g is not None),
            ms=time_ms(lambda: sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf,
                                                     **kw), iters=10),
            launch_ms=time_ms(bare, iters=10),
            plain_ms=marks[0].elapsed_time(marks[1]),
            library_ms=None,
            fwd_ckpt_ms=time_ms(lambda: sk.selective_scan_fwd(x, dt, a, bm, cm, d, **kw),
                                iters=10),
            fwd_ms=time_ms(lambda: sk.selective_scan(x, dt, a, bm, cm, d, **kw), iters=10),
            fwd_ckpt_launch_ms=time_ms(fwd_bare(True), iters=10),
            fwd_launch_ms=time_ms(fwd_bare(False), iters=10),
            checkpoint_bytes=nbytes(ck),
            shape=f"x ({b}, {sl}, {di}) bf16, N {n}, G {groups}, a final-state cotangent",
            **scan_bwd_bound(b, sl, di, n, moved),
        )
        print(f"selective_scan_bwd [{label}] {row['shape']}: backward {row['ms'] * 1e3:.2f} us "
              f"(bare {row['launch_ms'] * 1e3:.2f}; {row['ms'] / row['bound_ms']:.2f}x the bound), "
              f"bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']}: {json.dumps({k: round(v, 2) for k, v in row['bound_terms_us'].items()})} "
              f"us, {moved / 1e6:.2f} MB), plain {row['plain_ms'] * 1e3:.2f} us (one call); the forward "
              f"with checkpoints {row['fwd_ckpt_ms'] * 1e3:.2f} us (bare "
              f"{row['fwd_ckpt_launch_ms'] * 1e3:.2f}, {row['checkpoint_bytes'] / 1e6:.2f} MB "
              f"of checkpoints), without {row['fwd_ms'] * 1e3:.2f} us (bare "
              f"{row['fwd_launch_ms'] * 1e3:.2f})", flush=True)
        del x, dt, a, bm, cm, d, dy, h0, dhf, y, h, ck, grads, plain, outs, part, arow, drow, yo, ho
    row["ptxas"] = scan_bwd_build_checks()
    return row


def mamba_layer_loss(cfg):
    """One mamba mixer's training loss for a client: its output against a
    fixed fp32 weight -> (loss, the sum of its terms' magnitudes)."""
    from repro_torch.models.layers import mamba

    def loss(params, x, w):
        terms = mamba.mamba_forward(cfg, params, x)[0].float() * w
        return terms.sum(), terms.abs().sum().detach()
    return loss


def mamba_layer_train_leg(card: str, dev="cuda") -> dict:
    """Leg b: one Jamba mamba mixer at full width under
    ``vmap(grad_and_value)`` over C = 2 clients of 2 x 512 tokens, in fp32
    and bf16, the params shared (a round's first step) and per client
    (later steps), on the card under ``set_sync_debug_mode("error")``: two
    evaluations bitwise equal, one scan forward and one backward launch an
    evaluation (the cohort folded into B and the groups), no
    ``kernels.ref`` call; in fp32 with shared params the gradient of x and
    of every leaf within relative L2 HYBRID_FT_BOUND of the port's CPU
    route on the same inputs, and each client's loss within
    HYBRID_LOSS_OF_TERMS of the sum of its terms' magnitudes (the loss
    cancels to ~3e-4 of them, and its raw relative error moves between
    runs on identical inputs: 1.48e-5 and 3.35e-5 on an H100), the
    sequence cut to HYBRID_LAYER_CPU_S positions (the CPU's GEMMs at full
    width take the time).  Each step timed."""
    import dataclasses
    import os

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import mamba
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.set_num_threads(os.cpu_count() or 1)
    base = dataclasses.replace(get_config(HYBRID_ARCH), moe=None)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(20)
        params = mamba.init_mamba(gen, cfg, dt, device=dev)
        x = torch.randn((HYBRID_LAYER_C, HYBRID_LAYER_B, HYBRID_LAYER_S, cfg.d_model),
                        generator=gen, device=dev).to(dt)
        w = torch.randn(x.shape, generator=gen, device=dev)
        grad = torch.func.grad_and_value(mamba_layer_loss(cfg), argnums=(0, 1), has_aux=True)
        for shared in (True, False):
            p = params if shared else tree_map(lambda t: torch.stack([t, 1.01 * t]), params)
            step = torch.func.vmap(grad, in_dims=(None if shared else 0, 0, 0))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with RefTrap():
                    got, (loss, _) = step(p, x, w)
                    again, (again_loss, _) = step(p, x, w)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            bitwise = torch.equal(loss, again_loss) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again),
                                                  strict=True))
            del again
            tag = f"{dtype}, {'shared' if shared else 'per-client'} params"
            r = {"bitwise": bitwise, "launches_two_evaluations": launches,
                 "loss": [float(v) for v in loss]}
            ok = (bitwise and launches == {"selective_scan": 2, "selective_scan_bwd": 2}
                  and all(math.isfinite(v) for v in r["loss"])
                  and all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(got)))
            if dtype == "float32" and shared:
                xs, ws = x[:, :, :HYBRID_LAYER_CPU_S], w[:, :, :HYBRID_LAYER_CPU_S]
                with RefTrap():
                    mine, (mine_loss, _) = step(p, xs, ws)
                t0 = time.perf_counter()
                want, (want_loss, want_mag) = step(tree_map(lambda t: t.cpu(), p), xs.cpu(),
                                                   ws.cpu())
                r["cpu_s"] = time.perf_counter() - t0
                r["loss_rel_err"] = max(abs(float(a) - float(b)) / abs(float(b))
                                        for a, b in zip(mine_loss, want_loss))
                r["loss_err_of_terms"] = max(abs(float(a) - float(b)) / float(m)
                                             for a, b, m in zip(mine_loss, want_loss, want_mag))
                r["leaf_rel_l2"] = {k: rel_l2(g, h) for k, g, h in zip(
                    ["x"] + sorted(params), [mine[1]] + [mine[0][k] for k in sorted(params)],
                    [want[1]] + [want[0][k] for k in sorted(params)])}
                worst = max(r["leaf_rel_l2"].values())
                ok = (ok and r["loss_err_of_terms"] <= HYBRID_LOSS_OF_TERMS
                      and worst <= HYBRID_FT_BOUND)
                del want, mine
            check(f"mamba layer training [{tag}]: jamba's mixer at full width (d 8192, d_inner "
                  f"16384, N 16, dt_rank 512), vmap(grad) over C = {HYBRID_LAYER_C} x "
                  f"{HYBRID_LAYER_B} x {HYBRID_LAYER_S} tokens, no host sync, no kernels.ref "
                  f"call: two evaluations bitwise equal, 1 scan forward and 1 backward launch "
                  f"each" + ("" if "cpu_s" not in r else
                             f", the gradient of x and every leaf within relative L2 "
                             f"{HYBRID_FT_BOUND} of the CPU's, each client's loss within "
                             f"{HYBRID_LOSS_OF_TERMS} of its terms' magnitudes (at "
                             f"{HYBRID_LAYER_CPU_S} positions)"), ok, **r)
            r["step_ms"] = time_ms(lambda: step(p, x, w), iters=5)
            print(f"mamba layer training [{tag}] jamba full-width mixer, C={HYBRID_LAYER_C} x "
                  f"{HYBRID_LAYER_B} x {HYBRID_LAYER_S}: step {r['step_ms']:.3f} ms (forward "
                  f"and backward, the cohort), bitwise {bitwise}, launches {launches}"
                  + ("" if "cpu_s" not in r else
                     f", loss rel err {r['loss_rel_err']:.2e} ({r['loss_err_of_terms']:.2e} of "
                     f"its terms' magnitudes), max leaf rel L2 "
                     f"{max(r['leaf_rel_l2'].values()):.2e}; CPU {r['cpu_s']:.1f} s")
                  + f" ({card})", flush=True)
            out[tag] = r
            del got, p
        del params, x, w
    return out


def hybrid_step_leg(card: str, dev="cuda") -> dict:
    """Leg d: phase 9's 8-layer period of Jamba (no experts, bf16,
    8,999,034,880 params) for the reference smoke test's step:
    ``grad_and_value(loss_fn)`` on B = 2 of 512 tokens, then p - 0.01 g
    leaf by leaf in place (18 GB of params beside 18 GB of gradients).
    The loss finite and positive, every gradient leaf finite and nonzero,
    every updated leaf finite; 7 + 7 scan and 1 + 1 flash launches and
    nothing else, no ``kernels.ref`` call; the step timed (synchronized),
    its peak memory under HYBRID_PEAK_GB."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_size

    change, n_want, kinds = HYBRID_CUTS[2]
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **change)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    n = tree_size(params)
    batch = lm_batch(cfg, 1, dev, clients=1, steps=1, batch=HYBRID_STEP_B, seq=HYBRID_STEP_SEQ)
    batch = {k: v[0, 0] for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, finite_grads, nonzero = [], True, True
    with RefTrap():
        for _ in range(2):   # the first step builds, the second is timed
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            grads, (loss, met) = torch.func.grad_and_value(model.loss_fn, has_aux=True)(
                params, batch)
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            finite_grads = all(bool(torch.isfinite(g.float()).all()) for g in tree_leaves(grads))
            nonzero = all(bool((g != 0).any()) for g in tree_leaves(grads))
            for p, g in zip(tree_leaves(params), tree_leaves(grads), strict=True):
                p.sub_(HYBRID_STEP_LR * g.to(p.dtype))
            del grads
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": kinds.count("attn"), "flash_attention_bwd": kinds.count("attn"),
            "selective_scan": kinds.count("mamba"), "selective_scan_bwd": kinds.count("mamba")}
    r = {"params": n, "loss": float(loss), "ce": float(met["ce"]), "launches": launches,
         "step_s": walls, "peak_memory_gb": peak_gb, "tokens": HYBRID_STEP_B * HYBRID_STEP_SEQ}
    check(f"hybrid fine-tune: {HYBRID_ARCH}'s 8-layer period ({n:,} params = JAX's "
          f"{n_want:,}, {kinds}), one value_and_grad step and SGD({HYBRID_STEP_LR}) on "
          f"{HYBRID_STEP_B} x {HYBRID_STEP_SEQ} tokens: loss finite and positive, every gradient "
          f"finite and nonzero, every updated leaf finite, exactly {want} and no kernels.ref "
          f"call, peak under {HYBRID_PEAK_GB} GB",
          n == n_want and math.isfinite(r["loss"]) and r["loss"] > 0 and finite_grads
          and nonzero and all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(params))
          and launches == want and peak_gb < HYBRID_PEAK_GB, **r)
    print(f"hybrid fine-tune {HYBRID_ARCH} 8-layer period ({n:,} params), {HYBRID_STEP_B} x "
          f"{HYBRID_STEP_SEQ} tokens: loss {r['loss']:.4f}, step s {[round(x, 4) for x in walls]}, "
          f"{r['tokens'] / walls[-1]:.0f} trained tokens/s, peak {peak_gb:.2f} GB, launches "
          f"{launches} ({card})", flush=True)
    del params, model
    return r


def hybrid_card_vs_cpu(card: str) -> dict:
    """Leg e: Jamba at full width cut to 2 layers by ``reduced()``'s plan
    rule ([mamba, attn], no experts, 2,853,068,800 params), fp32, one
    client's batch of HYBRID_CPU_TOKENS: ``loss_fn``'s value and every
    leaf's gradient on the card within relative L2 HYBRID_FT_BOUND of the
    port's CPU route on identical params and tokens; 1 + 1 scan and 1 + 1
    flash launches, no ``kernels.ref`` call on the card."""
    import dataclasses
    import os

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size

    torch.set_num_threads(os.cpu_count() or 1)
    change, n_want, kinds = HYBRID_CUTS[1]
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **change, dtype="float32")
    card_m, cpu_m = build_model(cfg), build_model(cfg, device="cpu")
    params = card_m.init(0)
    n = tree_size(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    b, s = HYBRID_CPU_TOKENS
    batch = {k: v[0, 0] for k, v in lm_batch(cfg, 1, "cpu", clients=1, steps=1, batch=b,
                                             seq=s).items()}
    t0 = time.perf_counter()
    want, (want_loss, _) = torch.func.grad_and_value(cpu_m.loss_fn, has_aux=True)(
        cpu_params, batch)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with RefTrap():
        got, (got_loss, _) = torch.func.grad_and_value(card_m.loss_fn, has_aux=True)(
            params, {k: v.cuda() for k, v in batch.items()})
        launches = {k: v for k, v in ops.launch_counts().items() if v}
    torch.cuda.synchronize()
    loss_err = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    leaf_errs = [rel_l2(g, w)
                 for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True)]
    expected = {"flash_attention": 1, "flash_attention_bwd": 1, "selective_scan": 1,
                "selective_scan_bwd": 1}
    check(f"hybrid fine-tune, fp32: {HYBRID_ARCH} at full width cut to {kinds} ({n:,} params "
          f"= JAX's {n_want:,}), {b} x {s} tokens, card against CPU: loss and every gradient "
          f"leaf within relative L2 {HYBRID_FT_BOUND}; exactly {expected}, no kernels.ref call",
          n == n_want and loss_err <= HYBRID_FT_BOUND and max(leaf_errs) <= HYBRID_FT_BOUND
          and launches == expected,
          loss=float(got_loss), cpu_loss=float(want_loss), loss_rel_err=loss_err,
          max_leaf_rel_l2=max(leaf_errs), launches=launches, cpu_s=cpu_s)
    print(f"hybrid fine-tune card vs CPU ({HYBRID_ARCH}, fp32, {kinds}, {b} x {s} tokens): "
          f"loss {float(got_loss):.6f} vs {float(want_loss):.6f} ({loss_err:.2e}), leaves' "
          f"relative L2 max {max(leaf_errs):.2e} median {statistics.median(leaf_errs):.2e}; "
          f"CPU {cpu_s:.1f} s ({card})", flush=True)
    del params, got, cpu_params, want
    return {"loss_rel_err": loss_err, "leaf_rel_l2": leaf_errs, "cpu_s": cpu_s}


def hybrid_finetune_phase(card: str, out_dir: Path) -> dict:
    """Phase 20: hybrid Mamba training.  (a) the training forward and the
    selective scan backward kernel against their plain versions
    (``scan_backward_checks``); (b) one Jamba mamba mixer at full width
    under ``vmap(grad)`` (``mamba_layer_train_leg``); (c) Jamba at full
    width cut to 1 layer without experts ([mamba], bf16, 2,098,077,696
    params) on the round engine with the fp32, Int8 and LoRA wires, C = 2
    (``lm_round_leg``, on the allocator's expandable segments), its peak
    under HYBRID_PEAK_GB; (d) phase 9's 8-layer
    period, one value_and_grad step and an SGD update (``hybrid_step_leg``);
    (e) the 2-layer [mamba, attn] cut at full width, the card against the
    CPU in fp32 (``hybrid_card_vs_cpu``)."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_size

    seconds = {}
    t0 = time.perf_counter()
    out = {"scan_bwd_row": scan_backward_checks(torch.device("cuda"))}
    seconds["a"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["layer"] = mamba_layer_train_leg(card)
    seconds["b"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    change, n_want, kinds = HYBRID_CUTS[0]
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **change)
    params = build_model(cfg).init(0)
    n = tree_size(params)
    check(f"hybrid fine-tune: {HYBRID_ARCH} at full width cut to {kinds} has JAX's "
          f"{n_want:,} params", n == n_want, params=n)
    # client-parallel the Int8 rounds allocate up to 68 GB of the card's 80;
    # in the allocator's fixed segments the (C, N) fp32 blocks of the
    # embedding segment fragment the pool (an H100 refused a 4 GiB block
    # with 15-18.5 GiB cached and unused), and Jamba's own
    # sequential mode holds three (C, N) fp32 residual copies (73 GB).  So
    # the leg's wires run client-parallel on expandable segments, each from
    # an empty cache, and the allocator returns to fixed segments after.
    gc.collect()
    torch.cuda.empty_cache()
    allocator_settings("expandable_segments:True")
    try:
        out["rounds"] = {}
        for name in LM_CODECS:
            gc.collect()
            torch.cuda.empty_cache()
            out["rounds"][name] = lm_round_leg(card, out_dir, cfg, params, name,
                                               clients=HYBRID_FT_C,
                                               trace="hybrid_finetune_round_trace.json")
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        allocator_settings("expandable_segments:False")
    peak = max(r["peak_memory_gb"] for r in out["rounds"].values())
    check(f"hybrid fine-tune: the rounds' peak under {HYBRID_PEAK_GB} GB client-parallel",
          peak < HYBRID_PEAK_GB, peak_memory_gb=peak)
    out["launches"] = {k: LM_ROUNDS * v
                       for k, v in out["rounds"][LM_PROFILED]["launches_a_round"].items()}
    out.update(arch=HYBRID_ARCH, depth_cut=cfg.n_layers, params=n, clients=HYBRID_FT_C)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["step"] = hybrid_step_leg(card)
    seconds["d"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["card_vs_cpu"] = hybrid_card_vs_cpu(card)
    seconds["e"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["leg_seconds"] = seconds
    print(f"phase 20 legs' seconds: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"({card})", flush=True)
    return out


def aside(r: dict) -> str:
    """A timing's yardsticks beside the kernel's own: the TopK reduce's
    output fill, the copy floor (FedAvg reduce, codec), the codec's encode
    and ptxas' registers, decode attention at 4 CTAs an SM."""
    out = ""
    if "zero_fill_ms" in r:
        out += f", the (N,) fp32 fill alone {r['zero_fill_ms'] * 1e3:.2f} us"
    if "copy_ms" in r:
        out += f", a device copy moving the same bytes {r['copy_ms'] * 1e3:.2f} us"
    if "encode_ms" in r:
        out += (f"; Int8Codec().encode of a {r['encode_shape']} {r['encode_ms'] * 1e3:.2f} us, "
                f"F.pad then the kernel {r['pad_then_kernel_ms'] * 1e3:.2f} us")
    if "aligned_ms" in r:
        out += (f"; the aligned kernel on a copy {r['aligned_ms'] * 1e3:.2f} us (bare "
                f"{r['aligned_launch_ms'] * 1e3:.2f} us)")
    if "ptxas" in r:
        out += f"; ptxas {r['ptxas']}"
    if "ms_4_ctas_per_sm" in r:
        out += (f", at {r['splits_4_ctas_per_sm']} splits (4 CTAs an SM) "
                f"{r['ms_4_ctas_per_sm'] * 1e3:.2f} us")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=Path("smoke_out"),
                        help="directory for the JSON report and the round trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _cuda
    except ImportError as err:  # e.g. the script copied without the repository's src/
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'}: {err!r}", flush=True)
        return 1

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    built = _cuda.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        print(f"built {name}.cu in {info['seconds']:.2f} s", flush=True)
        print(info["log"], file=sys.stderr)
    print(f"kernel build: {build_s:.2f} s wall ({len(built)} sources, parallel nvcc)", flush=True)
    REPORT["build_s"] = build_s

    args.out.mkdir(parents=True, exist_ok=True)
    seconds = REPORT["phase_seconds"] = {}

    def timed(label: str, fn, *fn_args):
        """Run one phase; print and keep its seconds."""
        t = time.perf_counter()
        result = fn(*fn_args)
        seconds[label] = time.perf_counter() - t
        print(f"phase {label}: {seconds[label]:.2f} s ({card})", flush=True)
        return result

    rows = timed("2 (kernels)", kernel_phase, rng)
    loop = timed("3 (Flower loop)", main_path_phase)
    mixed = timed("3b (mixed fleet)", mixed_fleet_phase)
    timed("4 (reduced-width parity)", reduced_parity_phase)
    timed("4b (mixed fleet's parity)", reduced_parity_phase, MIXED_FLEET)
    REPORT["profile"] = timed("5 (profile)", profile_phase, card, args.out)
    REPORT["profile_mixed_fleet"] = timed("5b (mixed fleet's profile)", profile_phase, card,
                                          args.out, MIXED_FLEET)
    REPORT["strategy_family"] = timed("3c (strategy family)", strategy_family_phase,
                                               card, args.out)
    REPORT["paper_tables"] = timed("3d (paper tables)", paper_tables_phase, card)
    REPORT["engine"] = timed("6 (round engine)", round_engine_phase, card)
    mesh = REPORT["mesh"] = timed("7 (mesh)", mesh_phase, card)
    serving = REPORT["serving"] = timed("8 (dense serving)", dense_serving_phase, card, args.out)
    hybrid = REPORT["hybrid"] = timed("9 (hybrid serving)", hybrid_serving_phase, card,
                                      args.out)
    REPORT["resnet"] = timed("10 (ResNet-18)", resnet_phase, card, args.out, rows)
    population = REPORT["population"] = timed("11 (population)", population_phase, card,
                                              args.out)
    REPORT["scanned"] = timed("12 (scanned trainer)", scanned_trainer_phase, card, args.out)
    REPORT["segmented"] = timed("13 (segmented wire)", segmented_wire_phase, card, args.out)
    REPORT["moe_serving"] = timed("14 (MoE and dense serving)", moe_dense_serving_phase, card,
                                  args.out)
    REPORT["mla_frontend_serving"] = timed("15 (MLA and frontend serving)",
                                           mla_frontend_serving_phase, card, args.out)
    REPORT["xlstm_serving"] = timed("16 (xLSTM serving)", xlstm_serving_phase, card, args.out)
    lm = REPORT["lm_finetune"] = timed("17 (LM fine-tuning)", lm_finetune_phase, card, args.out)
    rows["flash_attention_bwd"] = lm["flash_bwd_row"]
    REPORT["moe_finetune"] = timed("18 (MoE fine-tuning)", moe_finetune_phase, card, args.out)
    REPORT["mla_frontend_finetune"] = timed("19 (MLA and frontend fine-tuning)",
                                            mla_frontend_finetune_phase, card, args.out)
    hybrid_ft = REPORT["hybrid_finetune"] = timed("20 (hybrid Mamba fine-tuning)",
                                                  hybrid_finetune_phase, card, args.out)
    rows["selective_scan_bwd"] = hybrid_ft["scan_bwd_row"]
    for k, s in enumerate(loop["round_wall_s"], 1):
        print(f"round {k}: {s:.4f} s host wall ({card})", flush=True)
    for k, s in enumerate(mixed["round_wall_s"], 1):
        print(f"mixed fleet round {k}: {s:.4f} s host wall, eval acc "
              f"{mixed['eval_acc'][k - 1]:.4f} ({card})", flush=True)

    for label, t in seconds.items():
        print(f"phase {label}: {t:.2f} s ({card})", flush=True)
    pop_launches = {k: v for k, v in population["scale"]["launches"].items() if v}
    print(f"phase 11 (population, {POP_N:,} devices, 3 rounds) launches: "
          f"{json.dumps(pop_launches)} ({card})", flush=True)

    kernels = []
    for name in ("quantize_int8", "dequantize_int8", "dequant_reduce", "fedavg_reduce",
                 "topk_scatter_reduce", "collective_absmax", "collective_pack",
                 "collective_unpack",
                 "flash_attention", "flash_attention_bwd", "decode_attention",
                 "selective_scan", "selective_scan_bwd"):
        r = rows[name]
        # each kernel's launches on the path that runs it: phase 3's loop,
        # for the TopK reduce phase 3b's mixed fleet, for the collective
        # kernels phase 7's mesh (rank 0, rounds 1-3 of every case), for
        # the attention kernels phase 8's serving run, for the scan phase
        # 9's, for the flash backward phase 17's Int8 rounds, for the scan
        # backward phase 20's Int8 rounds
        path = {"topk_scatter_reduce": mixed, "collective_absmax": mesh,
                "collective_pack": mesh, "collective_unpack": mesh, "flash_attention": serving,
                "flash_attention_bwd": lm, "decode_attention": serving,
                "selective_scan": hybrid, "selective_scan_bwd": hybrid_ft}.get(name, loop)
        launches = path["launches"][name]
        check(f"{name} launched on its path", launches > 0, launches=launches)
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        lib = "" if r["library_ms"] is None else f", library {r['library_ms'] * 1e3:.2f} us"
        print(f"{name}: {r['shape']}: kernel {r['ms'] * 1e3:.2f} us (bare launch "
              f"{r['launch_ms'] * 1e3:.2f} us), plain "
              f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bytes'] / 1e6:.2f} MB), launches {launches}{aside(r)} ({card})",
              flush=True)
    for t in REPORT["timings"]:
        lib = "" if t["library_ms"] is None else f", library {t['library_ms'] * 1e3:.2f} us"
        print(f"{t['name']} [{t['case']}]: {t['shape']}: kernel {t['ms'] * 1e3:.2f} us (bare "
              f"launch {t['launch_ms'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.2f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us"
              f"{aside(t)} ({card})", flush=True)

    REPORT.update(card=card, kernels=kernels, main_path=loop, mixed_fleet=mixed, rows=rows)
    REPORT["total_s"] = time.perf_counter() - T_START
    print(f"chip_smoke total: {REPORT['total_s']:.2f} s ({card})", flush=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1, default=str))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
