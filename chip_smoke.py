#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit (nvidia-smi); fail without CUDA.
2. Build the port's CUDA kernels from veles_tpu_torch/csrc/ (nvcc, one
   process per source, all at once) and print the build seconds, then
   BUILD lines: each compiled kernel function's registers, stack, local
   memory (spills land there) and static shared memory, its stack frame's
   spill stores and loads as ptxas reports them, the dynamic
   shared memory K6 and K7 take per block at each head width and K3 at
   AlexNet's two LRN widths, and K4's and K2's at AlexNet's two LRN
   inputs with the blocks of each instance an SM holds at its registers.
3. KERNEL lines. Each kernel is held against its plain PyTorch version on
   the same inputs and timed beside its plain version and the least time
   the card could take, each launch with a cold L2 cache (median of 25):
   - K2 (LRN forward) and K4 (fused LRN -> max pool forward) at both
     AlexNet LRN shapes at the serving ring's batch 64, K2 also beside the
     one PyTorch call computing the same function (F.local_response_norm,
     checked first to agree). Both must give the plain version's bits,
     also through their run-time (generic) instances and with 4-byte
     copies (x not 16-byte aligned), each timed. Before them, K4 small
     checks (K4 lines: K5's small-check shapes below and a 2x2 stride 3
     pool whose last window lies wholly past the edge, -inf there) and
     K2 small checks (K2 lines: K3's small-check shapes below), each
     bit-equal to the plain version (NaN where it has NaN);
   - K3 (LRN backward) and K5 (fused LRN -> max pool backward: a route
     launch, then a gather and LRN-backward launch) at both shapes at the
     training batch 128, on post-ReLU inputs (half zeros, so pooling
     windows tie as they do in training), and K1 (the SGD update)
     over all 16 AlexNet leaves (62,378,344 parameters), each leaf at its
     own learning rate. K3 is timed beside the one PyTorch call computing
     its function, the autograd backward of F.local_response_norm (on
     the NCHW view, checked first to agree with the plain version within
     1e-5 + 1e-4*|plain|); no single PyTorch call computes K5 or K1.
   K1-K5 within 1e-6 + 1e-5*|plain| (the same f32 arithmetic in the same
   order, so at most the rsqrt approximation differs). K3 must give the
   plain version's bits at both shapes, also through its run-time
   (generic) instance and with 4-byte copies (x not 16-byte aligned),
   each timed beside the compile-time instance's 16-byte copies. Before
   the AlexNet shapes, K3 small checks (K3 lines: row counts that leave
   a ragged last tile, C = 3, 40 and 70, LRN n = 3, an all-zero input,
   NaNs in x, rows of 4098 and 4100 channels cut into channel tiles),
   each bit-equal to the plain version (NaN where it has NaN), and K5
   small checks (K5 lines) at shapes the AlexNet ones miss:
   ceil-mode windows clipped on both axes, C = 3 and C = 40 and 70 (below
   and between its 32-channel tiles), an all-zero input (every window
   ties), windows holding a NaN (which route nowhere), and 3x3 stride 1
   and 2x2 stride 2; each within the same gate, NaN where the plain
   version has NaN, and reported bit-equal or not. K5 runs AlexNet's
   geometry as an instance with it compiled in: at both shapes it is
   also timed through the run-time (generic) instance, which must give
   the same bits, and the generic instance is timed at AlexNet's layer-2
   input under 3x3 stride 1 windows (KERNEL lrn_maxpool_backward L2
   3x3/1; in chip_smoke.json, not in the {"kernels"} line).
   - K6 (flash attention forward: O and the row logsumexp) and K7 (its
     backward: dQ, dK, dV) at the char-transformer's shapes, q, k, v of
     (32, 4096, 4, 16) and, at 2 heads, (32, 4096, 2, 32), causal,
     within 4e-6 + 4e-5*|plain| (forward) and 1e-5 + 1e-4*|plain|
     (backward): a fifth of the JAX package's own
     kernel-vs-golden tolerances (the online softmax sums in another order
     than the plain version's materialised one; the backward's products
     run on the tensor cores as 3xTF32, f32-accurate but summed in
     another order: both kernels run their products on the tensor cores
     as 3xTF32). K6 and K7 must also give the same bits on a second call
     (they use no atomics). Their bounds are their operations at the
     card's dense TF32 rate, three TF32 products per f32 product, with
     the f32 CUDA-core bound beside them (bound_f32_ms). Beside each, the one
     PyTorch call computing the same function:
     F.scaled_dot_product_attention(..., is_causal=True) in f32 for K6,
     autograd of that call for K7 (each checked first to agree with the
     plain version within the JAX package's tolerances, 2e-5 +
     2e-4*|plain| and 5e-5 + 5e-4*|plain|; the backend PyTorch dispatches
     it to is printed); also at 1 head of 64, (32, 4096, 1, 64). Before
     that, K6 and K7 at every head width they are compiled for (8, 16,
     32, 64) on a ragged S = 200, causal or not, KV forward or reversed,
     with and without a dropout mask (FLASH lines).
   - The LRN kernels' bf16 instances (bf16 in device memory, f32
     arithmetic, each output rounded once): first at every small-check
     shape above (K4, K2 and K3, K5 bf16 lines), then at both AlexNet
     LRN shapes at the training batch 128 on post-ReLU inputs rounded to
     bf16 (KERNEL *_bf16 lines): each must give its plain version's bits
     (NaN where it has NaN), also through the generic instance and with x
     2 bytes off alignment, and is timed on the same cold timer beside
     the f32 instance on the same values; K2 beside
     F.local_response_norm on the bf16 tensor and K3 beside its autograd,
     each held first within 2^-6 + 2^-4*|plain| of the plain version
     (each of the library's operations rounds to bf16). Bounds: one read
     of each bf16 input and one write of each output.
   CONV_STEM: the `conv_stem` op at AlexNet's conv1 (batch 128,
   227x227x3, 96 kernels 11x11 at stride 4, linear: behind the strict
   ReLU a few outputs within an ulp of zero route their gradients apart),
   f32 with TF32 off and then bf16: `s2d` (the space-to-depth rewrite) held
   against `direct` (cuDNN at stride 4), the forward and the weight and
   bias gradients (f32: the forward within 1e-5 + 1e-5*|direct|, each
   gradient within 1e-5*|direct| + 1e-5 of its largest magnitude; bf16:
   2^-7 of each and of the largest), and both timed in turns, forward
   and forward + backward (CUDA events, median of 25).
4. SERVE: serve the full-width AlexNet (227x227x3, fc 4096, 1000 classes,
   ring of 64) through the same function the CLI uses, under
   lrn_maxpool=fused and again under composed, with one seed. POST 1, 8
   and 64 rows over loopback HTTP; check 200, shapes (rows, 1000), finite
   softmax rows summing to 1, the same classes under both settings, and
   the served outputs against the plain forward on the card (max abs 1e-5:
   only the LRN's rsqrt rounding differs, carried linearly to
   probabilities of ~1e-3). Launch counters are zeroed just before each
   setting's requests and read just after: K4 must have launched under
   fused, K2 under composed. FORWARD lines time each step of one ring.
5. TRAIN: train the full-width AlexNet one epoch (4 train steps of 128 and
   one validation step) through the function the `--fused` CLI uses (the
   batches come through the device feed), under fused and again under
   composed, from one seed; counters zeroed just before each and read
   just after: K4, K5 and K1 must have launched under fused, K2, K3 and
   K1 under composed (the backward kernel, K5 or K3, exactly twice per
   train step), and the loss be finite. Each step's device time comes
   from CUDA events around it (since the device feed, the batch's upload
   is not inside them).
   TRAIN bf16 fused / composed: the same epoch at
   root.common.precision_type=bfloat16 (bf16 compute over f32 master
   weights): the LRN kernels' bf16 instances only (K4 and K5 under fused,
   K2 and K3 under composed, the backward one exactly twice per train
   step), no f32 LRN instance, K1 on the f32 leaves, every step's
   compute dtype bf16 and its leaves and velocities f32 afterwards.
   FEED: the full-width AlexNet, batch 128, bf16 over f32 master
   weights, lrn_maxpool fused, through `launcher.train` with the device
   feed: 1280 train and 128 validation images of 227x227x3 uint8, made
   from --seed (default 1234) by quantizing class prototypes plus noise,
   packed with a mean image by `pack_arrays` under chiprun_out/feed_data
   (deleted after the phase), trained 2 epochs (a) on the uint8 wire (the
   step normalizes on the card), (b) on the f32 wire from the same
   memmap, (c) from the synthetic loader on its f32 wire, each at
   feed_ahead 1, 0, 0, 1. Each run's counts are zeroed just before it and
   read just after (K4 and K5's bf16 instances and K1; K5 twice per train
   step; no other instance); it prints the train steps' device ms by
   CUDA events (the upload is no longer inside them), the host ms per
   train step and the train samples/s over the second epoch's train pass
   (synchronized at both ends), and the feed's loader_block_s,
   put_block_s and device_sync_s. It fails unless the native gather
   built and ran, the uint8 wire's batch is 128*227*227*3 bytes plus the
   labels' and mask's (the f32 wire's image bytes exactly 4x), the host
   buffers are pinned, the copies run on a stream other than the
   default one, x is gathered straight into a pinned buffer (only y and
   w copied on the host), every turn of a wire gives the first turn's
   bits (the loss, the n_err history, every parameter and velocity), and
   the uint8 wire's head weights lie within 1e-5 + 1e-4*|f32| of the f32
   wire's. Then a child process (a process's first profiler session is
   the one that records memcpys) profiles 8 steady train steps of (a)
   at feed_ahead=1 (CUDA activity only): the batch's HtoD copies must be
   pinned, on a stream other than the kernels', none may start only
   after compute-stream work that was queued when its copy was issued
   (by the runtime calls' correlation), and they must overlap the
   kernels (chiprun_out/feed_profile.json).
   RESUME: on FEED's packed memmap (kept until RESUME ends), the same
   AlexNet (dropout 0.5 as the sample has it, feed_ahead 1) trained 3
   epochs through `launcher.train` from a workflow file this script
   writes into a temporary directory, which rebuilds the sample's
   workflow with snapshot_config (keep_last 2; (a) codec none, (b) the
   default gz): (a) in process, the uninterrupted run against the same
   argv cut at 2 epochs and resumed from its newest snapshot (`-s`, max_epochs 3), which must be the one
   of epoch 2's validation pass, after epoch 1's 10 train steps (the
   resumed run trains 20 steps: trained weights, non-zero velocities, a
   dropout stream past its seed's position): the same bits in every
   parameter and velocity, the history, best_validation_err, the epoch
   counter and the loss, the sidecar verified, and the resumed run's
   counts (zeroed just before it, read just after) exactly K1 16 and K5
   bf16 2 a train step, K4 bf16 2 a train or validation step; each run
   prints its snapshots' export seconds and bytes, the import seconds,
   the move to the card, and the host ms a train step over its last
   epoch's train pass; (b) `python -m veles_tpu_torch ... --fused
   --supervise` with VELES_FAULT_PLAN=kill@epoch=2 in a child: exit 0,
   one restart from a snapshot, the final TRAINED line equal to (a)'s
   uninterrupted run's, and the time to recover (the kill to the
   restarted child's first step, from RESUMEMARK lines the workflow
   file prints); (c) `--serve 0 -s SNAPSHOT` through `launcher.serve`:
   a 1-row /predict within 1e-5 of the restored workflow's forward on
   the card, K4 launched twice; (a)'s newest snapshot is kept for SERVE
   WIRES.
   SERVE WIRES: the full-width AlexNet (seed 1234, init="scaled",
   written by the phase as an uncompressed snapshot and served with -s)
   on a 64-row ring through `launcher.serve` with --serve-quantize f32,
   bf16 and int8 under lrn_maxpool=fused, and bf16 again under
   composed: 1- and 8-row /predict requests, the counters zeroed just
   before and read just after holding exactly the wire's K2/K4 instance
   twice a round (K4 f32 for f32 and int8, which decodes to f32 first;
   K4 and K2 bf16 for bf16) and nothing else. The reference is the
   plain forward through the same wire on the card: the served
   workflow's parameters decoded by the plain functions
   (reference.serve_quantize_weight and dequantize_blockwise for int8,
   a bf16 cast for bf16), never the server's placed copies, every LRN
   through its plain version, no fused pair. The outputs lie within SERVE_ATOL of it, and the logits (the
   server's own wire forward before its softmax, which a fresh AlexNet
   would flatten to within about 3e-5 of 1/1000) within LOGIT_ULPS
   epsilons of the wire's compute type times the largest logit, a bound
   at most LRN_SIGNAL_SHARE of how far the logits move with every LRN
   left out.
   Each non-f32 wire lies within WIRE_F32_TOL (0.05, the JAX rule) of
   the f32 wire's outputs; the lines give the wire's and the f32 model
   bytes, and one ring's forward in device ms (CUDA events, mean of 10).
   The merge core (--serve-dispatch merge --serve-batch 8): 1, 3 and 8
   rows at buckets 1, 4 and 8, one dispatch each, K4 exactly 6, against
   the plain forward. On the f32 ring (started with --serve-watch-mirror
   on an empty DirMirror in the script's output directory, OUT, polled
   every second), while a thread keeps posting 1-row requests that must
   all get 200: a perturbed AlexNet (params x 1.01) swapped in answers
   as the plain forward of the candidate's own params, its logits at
   least MOVED_X logit bounds from the boot's; POST /rollback restores
   the boot generation's outputs and logits bit for bit; a NaN candidate
   is refused (nonfinite) and a toy AlexNet (geometry); then RESUME's
   snapshot, pushed to the mirror, is applied by the watcher as the
   generation named by its sidecar digest and answers as the plain
   forward of the snapshot's own params (Snapshotter.import_), its
   logits at least MOVED_X bounds from the generation before. The mirror
   is deleted after the phase.
   FLEET: two replicas of the full-width AlexNet of SERVE WIRES (a fresh
   seed-1234 init="scaled" snapshot served with -s), f32, 64-row rings,
   lrn_maxpool=fused, started in this process by `launcher.serve` with
   --serve-replicas 2 --serve-announce DIR (DIR under the script's
   output directory, removed after the phase), behind a ServingRouter
   over DIR whose RouterCore evicts after FLEET_TTL_S of beacon silence
   (the phase polls the bus itself between requests). It fails unless
   replica 2's start ran no nvcc and loaded no kernel library
   (`InferenceServer.kernel_builds`); 16 requests of 1-8 rows through the
   router, the counters zeroed just before and read just after, are all
   answered 200 by both replicas (their requests sum to 16 plus the
   router's hedges), K4 launched exactly twice each replica's round and
   nothing else, each answer within SERVE_ATOL of the plain forward; the
   same requests again, through the router and straight to a replica
   back to back, give the router's added host ms a request; a candidate (params x 1.01) swapped into both replicas, then
   POST /rollback through the router, gives both replicas' boot outputs
   and logits back bit for bit, every request meanwhile answered 200;
   the served generation exported (veles_tpu_torch/export.py) and run on
   2 rows by the port's native engine on the host, within 3e-4 * |card| +
   3e-5 of the card's served softmax (the package's bytes, the export
   seconds, the engine's host ms a row printed); replica 1's beacon
   draining, no request reaches it after the router's next poll; replica
   2's beacon silenced, every request answered until the router evicts
   it, more than FLEET_TTL_S after the last beat it saw. FLEET lines.
   AOT (after FLEET): the serialized serving program (serving_aot.py).
   A fresh seed-1234 init="scaled" AlexNet snapshot served by
   `launcher.serve` with $VELES_SERVING_AOT_CACHE naming a cache in a
   temporary directory must report an exported program; then, for the
   f32, bf16 and int8 wires on a ring of B rows (fused), an eager
   server, a server exporting its program into a fresh cache and a fresh
   server loading it (aot_source "cache", 0 exports) must give the eager
   ring's answers bit for bit; AOT_ROUNDS rounds through the loaded
   program, counters zeroed just before and read just after, launch K4
   (its bf16 instance on the bf16 wire) exactly twice a round and
   nothing else; a flipped byte of the stored blob is refused with one
   warning and the program exported anew. Each start's host seconds, the
   program's export and load seconds, the .pt2's bytes and a ring
   round's device ms eager and through the program (CUDA events). AOT
   lines.
   DP (after AOT): data-parallel training over torch.distributed at
   world size 1 on NCCL (the machine has one card). (a) `launcher.train`
   with `-l 127.0.0.1:PORT --n-processes 1 --zero-sharding on`, one epoch
   of the full-width f32 AlexNet, fused: K1 exactly 16 a train step (on
   the ZeRO slices), K4 twice a step, K5 twice a train step, nothing
   else (TRAIN dp lines). (b) In f32 and bf16, the full-width AlexNet at
   dropout 0, the local step and the dp step (ZeRO on) from one state,
   DP_STEPS steps each on one batch of TB rows: the dp state gathered
   within the TRAIN gates of the local state (bf16: the update distance
   within 2^-7; bit equality reported), the dp steps' launches exact
   (K1 16, K4 2, K5 2 a step), host and device ms a step of both in turns
   (local, dp, dp, local), the optimizer-state bytes with ZeRO on and off
   and the plan's bytes a rank at 2, 4 and 8 ranks, memstats' figures (DP
   lines). (c) Two processes on the one card (NCCL refuses two ranks on
   one device): a gloo group over CUDA tensors, one ZeRO step of the toy
   AlexNet against the local step, or a line saying why the card allows
   none (DP two ranks).
   TP (after DP): tensor parallelism, the fused step's gspmd mode (the
   JAX megatron plan, parallel/tp.py) on the full-width AlexNet at TB
   rows, dropout 0.5, TP_STEPS steps. (a) World size 1 on NCCL, mode
   "gspmd" at model 1, in f32 and bf16: the local step's bits from the
   same state and dropout stream position under PyTorch's deterministic
   algorithms, K1 16, K4 2 and K5 2 a step exactly (TP lines). (b) Two
   gloo processes over CUDA tensors on the one card, data 1 x model 2,
   f32 and bf16, against the local step from the same state and masks:
   f32 parameters within 1e-5; the bf16 update no further from the f32
   local step's than the bf16 local step's (plus TP_BF16_SLACK); every
   rank K1 16, K4 2, K5 2 a step; a rank's parameter and optimizer bytes
   within TP_SHARE of the local step's; gloo's host ms a step (no TP
   figure). The script exits non-zero where (b) does not run (TP two
   ranks lines). (c) The full-width char-transformer (32 windows of
   4096, 4 causal heads of 16, FFN 128, seed 1234) under the JAX plan's
   last-dim rule for attention and MoE and the single-weight rule for
   the sequence layers, TP_STEPS steps: (c1) world size 1 on NCCL, mode
   "gspmd" at model 1, dense f32 and bf16: the local step's bits, K6 1,
   K7 1 and K1 13 a step exactly (TP transformer lines); (c2) two gloo
   processes on the card, data 1 x model 2: dense f32 and bf16, MoE (8
   experts of hidden 128, capacity factor 2.0) f32, and one head of 64
   (a head straddling the ranks) f32 for TP_CT_ONE_STEPS step, against
   the local step from the same state: f32 parameters within 1e-5, bf16
   as (b); every rank K6 1 and K7 1 a train step (on its 2 heads, or on
   the gathered head) and K1 13 (14 with MoE); a rank's parameter and
   optimizer elements TP_CT_ELEMENTS of the local step's; gloo's host ms
   a step (no TP figure) (TP transformer two ranks lines). The phase's
   seconds.
   GRANULAR: the full-width AlexNet one epoch (4 train minibatches of 128
   and one validation minibatch, dropout 0.5 as the sample has it)
   through the granular Unit/Workflow graph, `launcher.train` without
   --fused (the CLI's mode without --fused and --serve), on the torch
   backend; counters zeroed just before and read just after must equal
   what the unit firings predict — K2 once per LRN forward firing (2 a
   minibatch), K3 once per LRN backward firing and K1 once per leaf per
   gradient-unit firing (2 and 16 a train minibatch whose update runs;
   the last one's is skipped once the Decision completes) — and every
   other instance, K4 and K5 among them, zero; the loss finite. GRANULAR
   lines print the host ms of each minibatch's pulse cycle (from one
   loader firing to the next; the evaluator's loss syncs each) and each
   unit's mean run_time. Then, at dropout 0, one granular epoch with
   the state captured at each loader firing: each granular update must
   equal the fused step's from the same state on the same batch, every
   parameter and velocity within TRAIN_ATOL + TRAIN_RTOL*|fused|; the
   fused step chained over those batches from the first state is held
   against the granular end state and reported, not gated (float noise
   can flip a max-pool near tie, as in 6 (c)); the fused step's
   synchronized host ms per train step print beside the granular cycles.
   GRANULAR transformer: the char-transformer at its own widths (embed
   64, 4 heads of 16, ffn 128, vocabulary 18, minibatch 32) at seq_len
   4096, 2 epochs through the granular graph (`launcher.train` without
   --fused, the torch backend; one train minibatch of the sample text's 3
   windows and one validation window an epoch); counters zeroed just
   before and read just after must equal what the firings predict — K6
   once per attention forward firing and once more in each attention
   gradient unit's vjp, K7 once per vjp, K1 once per leaf (13) per
   gradient-unit firing (the last train minibatch's update is skipped
   once the Decision completes: 5, 1 and 13 in all) — nothing else, the
   loss finite; host ms per pulse cycle and each unit's mean run_time
   printed. Then, over a text of 32 train windows and one validation
   window, 3 granular epochs (2 updates, the second from non-zero
   velocities): each granular update equals the fused step's from the
   same state on the same batch, every parameter and velocity within
   TRAIN_ATOL + TRAIN_RTOL*|fused|, the fused step's synchronized host
   ms per train step printed beside the granular cycles.
   GRANULAR RESUME: the full-width AlexNet (synthetic loader of 640
   train and 128 validation images, dropout 0.5) 3 granular epochs
   through `launcher.train` from a workflow file this script writes,
   which rebuilds the sample's workflow with snapshot_config (codec none,
   keep_last 2) and asks PyTorch for its deterministic algorithms
   (cuDNN's gradients and the max-pool backward's index_add_ are not
   bit-stable from one run to the next otherwise; the mode is restored
   after the phase): (a) the uninterrupted run (its launches its
   firings'),
   against the same argv cut at 2 epochs and resumed from its newest
   snapshot with -s, which must hold an epoch counter past 0 (epoch 2's
   validation pass): the same bits in every parameter and velocity, the
   history, best_validation_err, the epoch counter and the loss; the
   resumed run's counts (zeroed just before it, read just after) exactly
   its own firings' K2, K3 and K1; each run's snapshot export and import
   seconds and bytes printed; (b) `python -m veles_tpu_torch ...
   --supervise` without --fused, VELES_FAULT_PLAN=kill@epoch=2, in a
   child: exit 0, one restart from a snapshot, the final TRAINED line
   (a)'s uninterrupted run's.
   TRAIN transformer: train the char-transformer at its own widths (embed
   64, 4 heads of 16, ffn 128, vocabulary 18, minibatch 32) at seq_len
   4096 for 2 epochs through the same function (1 validation window, so
   an epoch is one train and one validation minibatch); counters zeroed
   just before and read just after: K6 once per train and validation
   step, K7 and K1 x 13 leaves once per train step, exactly, nothing
   else, and the loss finite.
   TRAIN transformer bf16: one epoch at root.common.precision_type=
   bfloat16, K6 and K7 in f32 behind the attention function's casts, with
   the same exact counts.
   TRAIN transformer n_heads=2: one epoch of the same at 2 heads of 32,
   with the same exact counts (K6 and K7 at head width 32; the unit's
   variant printed); then an attention unit at 1 head of 128, a width
   K6/K7 are not compiled for, must be refused on the card under "auto"
   (ValueError), with no fallback to the einsum.
   TRAIN transformer n_heads=1: one epoch of the same at 1 head of 64
   (K6 and K7 at head width 64), with the same exact counts.
   MOE: the char-transformer at the same widths with its FFN a switch
   mixture of 8 experts (hidden 128, capacity factor 2.0, residual;
   routed by index, ops/moe.py): (a) one epoch through the same function
   with the same exact counts (K1 x 14 leaves); (b) one full-width step
   (32 distinct windows) through the kernels against the same step
   through the plain versions from one state, within 6 (a)'s tolerance,
   exactly K6, K7 once and K1 x 14, the tokens the capacity dropped and
   each expert's load, and the card's peak bytes; (c) host and device ms
   a step (CUDA events, 3 steps, in turns) of the MoE step beside the
   dense-FFN step, then one step of each under torch.profiler: the aten
   operators with the most device time (MOE profile lines).
   EP: (a) `-l` with `--ep` at world size 1 on NCCL, one epoch of the MoE
   char-transformer through the CLI's function, exact counts; (b) the
   full-width MoE step expert-parallel (one rank holds all 8 experts)
   against the local step from one state, 3 steps: bf16 bit for bit,
   f32 within 1e-7; exact launches; host and device ms a step of each in
   turns; the modeled exchange bytes; (c) two gloo ranks on the one card
   (the MoE sample, 8 experts, zero-drop capacity) one step against the
   local step, or the reason there is none.
   PP: the dense char-transformer at full width as a 4-stage GPipe
   pipeline on the one card (`build_pipeline_step(devices=[card] * 4,
   n_microbatches=4)`, embed | attention | FFN | head): 3 steps against
   the local fused step from one seed, the losses and every parameter
   within 6 (a)'s tolerance, exactly 4 K6 and 4 K7 a step (one a
   microbatch) and no K1 (the pipeline's update is plain); host and
   device ms a step of each in turns; then `--pp 4` through the CLI's
   function, one epoch, one stage on the one card, exact counts.
   SAMPLES: BASELINE configurations 1 and 2, MNIST (784 -> 100 -> 10)
   and CIFAR-10 (conv 32 5x5 -> max pool -> LRN -> conv 32 5x5 -> avg
   pool -> FC 64 -> softmax 10), each at its sample's own sizes and
   defaults (10 epochs; MNIST 1000 train and 200 validation rows,
   CIFAR-10 2000 and 400, minibatch 100, synthetic data) through the
   CLI's function, `--fused` and granular (`-b torch`), counters zeroed
   just before and read just after: fused, K1 once per leaf per train
   step and, for CIFAR-10, K2 once per train and validation step and K3
   once per train step (its LRN follows a max pool: no pair claims it);
   granular, the unit firings' counts as in GRANULAR; nothing else, the
   loss finite and the best validation error under a fifth of the
   validation rows. Host seconds and the validation error per epoch are
   printed. Then CIFAR-10's fused step, 3 steps on the card against the
   same steps on the CPU from one seed, on batches of 2 rows without
   near ties (as in 6 (c)), within 1e-7 + 1e-4*|cpu|; then a stack of
   input_normalize, max-abs pooling, log activation, stochastic pooling
   and tanh activation one granular epoch on the card: every unit fired,
   its output on the card, and the validation confusion matrix's counts
   sum to the validation rows. Before the runs, K2 and K3 are held
   against their plain versions at CIFAR-10's LRN input, (100, 16, 16,
   32), the shape both modes give them, within the KERNEL tolerance and
   timed as in 3 (the KERNEL cifar10 lines; in the {"kernels"} line as
   each entry's "cifar10_shape"). The phase's seconds are printed.
6. Held on the card (TF32 off, as the step runs):
   (a) the first full-width AlexNet train step through the kernels against
       the same step with every kernel swapped for its plain version, from
       one state and batch: the loss, and every leaf and velocity after
       the update, within 1e-7 + 1e-4*|plain| (the LRN and update
       arithmetic is the same; cuDNN's weight-gradient sums are not
       bit-stable);
   (b) fused against composed on that step: the same n_err, the loss
       within the same tolerance;
   (c) the toy AlexNet (input 67, width 1/8, fc 64, 16 classes, batch 8,
       dropout 0) for 3 steps on the card against the same 3 steps on the
       CPU from one seed — the CPU path tier-1 holds against the JAX
       package — under the same tolerance. Each batch is one whose CPU
       forward has no max-pool window with its two largest values, and no
       ReLU input, within 1e-5 of the layer's largest magnitude of each
       other (or of zero): there two f32 implementations may route the
       gradient differently, which is the max's and the ReLU's
       discontinuity, not a fault;
   (d) one full-width char-transformer train step at seq_len 4096 (32
       distinct windows of a longer synthetic text) through the kernels
       against the same step through the plain versions, from one state:
       the loss and every leaf and velocity within the tolerance of (a),
       n_err equal but for tokens whose two largest logits tie within
       1e-5 of the largest logit magnitude;
   (e) the toy transformer (embed 16, 2 heads of 8, ffn 24, seq_len 256,
       minibatch 4, the flash gate forced on) for 3 steps on the card
       against the same 3 steps on the CPU from one seed, on batches
       without such logit ties, within the same tolerance.
   (a') the first full-width bf16 train step through the kernels against
       the same step through the plain versions, from one state and
       batch, and (c') the toy AlexNet's bf16 steps, card against CPU
       (the card's state copied from the CPU's before each step): the
       distance between the two updates over every leaf (and between the
       velocities), relative to the update's norm, within 2^-7, twice
       bf16's unit roundoff; the loss within 2^-8; n_err equal (in (c')
       but for rows whose two largest logits lie within two bf16 ulps).
   (d') the step of (d) in bf16 over f32 master weights (K6 and K7 in f32
       behind the attention function's casts) through the kernels against
       the plain versions, held as (a') is, n_err but for tokens whose two
       largest logits lie within two bf16 ulps.
   A profiler pass over one more full-width step of each model splits its
   device time by kernel family (chiprun_out/train_profile.json and
   transformer_profile.json; the bf16 steps' in train_bf16_profile.json
   and transformer_bf16_profile.json), and SPLIT lines time the
   forward+loss,
   backward and update of each by CUDA events, with AlexNet's backward
   under fused less that under composed on a line of its own.
   AUTOTUNE (last, so that no winner is selected for another phase): the
   kernel search (ops/templates.py, ops/autotune.py). (i) Each generated
   launch shape of K1-K4 against its plain version at the main path's
   shapes with the kernel's own check (K1's 4 blocks on AlexNet's 16
   leaves within KERNEL_RTOL; K2's and K3's 4 tiles and K4's 12 bands at
   AlexNet's LRN and norm->pool inputs at batch TB, f32 and bf16: the
   same bits), K6 at kv_order fwd and rev with and without the dropout
   mask and K7 with and without it at ATT_SHAPES[0] (the FLASH
   tolerances), each point timed (median of 25 by CUDA events, the points
   in turns); every point's Python footprint rule against the kernel's
   own `*_smem_bytes`. (ii) Every `conv_stem` point at conv1 against
   `direct` (an `epi=lrn` point against `direct` and the plain LRN), f32
   and bf16, at CONV_STEM's tolerances. (iii) The full-width bf16
   AlexNet through
   `launcher.train` with `--fused --autotune --autotune-budget 48` at
   batch 256 and a fresh cache in a temporary directory: a timed winner
   for each of lrn, maxpool, conv_stem, lrn_maxpool, sgd_update and
   flash_attn, every timed trial with a passing ledger record, no point
   failing to launch, the pruned and alias points printed; the same
   command again: no timing call, the same winners; a plain `--fused`
   run: its variant table names the winners and the launch counters show
   exactly their kernels; one step under the winners against one under
   the same step through the plain versions (the update distance within
   2^-7) and against one under the defaults from one state on one batch
   (within 2^-7, or where a winner rounds otherwise than the defaults —
   a stem packed space to depth or accumulated in f32, an LRN rounding
   its intermediates to bf16 — within twice the control: the distance of
   the defaults' bf16 step from their f32 step; `autotune_step_tolerance`).
   AUTOTUNE lines.
7. Print one {"kernels": [...]} line, then the card line and the closing
   {"ok": true, "device": {...}} line.

The script leaves PyTorch's TF32 defaults as they are: the server's
forward and the train step turn TF32 off for themselves (an f32 step
computes in f32; a bf16 step's products sum in f32), and the plain
forward and the per-step times here run
under the same `backends.full_f32`. Any failure raises before the last
line, and the exit code is then not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
ALEXNET = os.path.join(REPO, "veles_tpu_torch", "samples", "alexnet.py")
CHAR_TRANSFORMER = os.path.join(REPO, "veles_tpu_torch", "samples",
                                "char_transformer.py")
#: the BASELINE configurations 1 and 2 (SAMPLES lines)
SAMPLES = {"mnist": os.path.join(REPO, "veles_tpu_torch", "samples",
                                 "mnist.py"),
           "cifar10": os.path.join(REPO, "veles_tpu_torch", "samples",
                                   "cifar10.py")}
#: CIFAR-10's LRN input on the sample's path: minibatch 100, 32x32
#: images through the 5x5 conv of 32 kernels (padding 2) and the 2x2
#: max pool
CIFAR_LRN_SHAPE = (100, 16, 16, 32)
#: rows of CIFAR-10's card-against-CPU steps (SAMPLES cifar10 card vs
#: cpu): few, so that a draw without near ties comes soon
CIFAR_CHECK_ROWS = 2
B = 64                  # the ring, and the forward kernels' batch
TB = 128                # the training minibatch, and K3/K5's batch
HW, N_CLASSES = 227, 1000
#: (H, W, C) of AlexNet's two LRN inputs (each followed by a 3x3/2 pool)
LRN_SHAPES = ((55, 55, 96), (27, 27, 256))
#: AlexNet's 16 parameter leaves (HWIO conv weights, (fan_in, units) FC)
LEAVES = ((11, 11, 3, 96), (96,), (5, 5, 96, 256), (256,),
          (3, 3, 256, 384), (384,), (3, 3, 384, 384), (384,),
          (3, 3, 384, 256), (256,), (9216, 4096), (4096,), (4096, 4096),
          (4096,), (4096, 1000), (1000,))
#: extra CLI arguments of the served and trained model (none: full width)
SERVE_ARGS: list = []
TRAIN_ARGS: list = []
#: the toy AlexNet of the card-against-CPU check (c)
TOY_ARGS = dict(input_hw=67, width_mult=0.125, fc_width=64, n_classes=16,
                minibatch_size=8, n_train=8, n_validation=8, init="scaled")
#: the char-transformer's train runs: seq_len 4096 (the flash gate's
#: smallest S), one validation window
CT_SEQ = 4096
CT_TRAIN_ARGS = [f"root.char_transformer.loader.seq_len={CT_SEQ}",
                 "root.char_transformer.loader.n_validation=1"]
#: q, k, v of the transformer's attention, (B, S, H, D): the sample's 4
#: heads of 16, 2 heads of 32 (TRAIN transformer n_heads=2) and 1 of 64
#: (TRAIN transformer n_heads=1)
ATT_SHAPES = ((32, CT_SEQ, 4, 16), (32, CT_SEQ, 2, 32), (32, CT_SEQ, 1, 64))
#: a head width K6 and K7 are not compiled for: refused on the card
REFUSED_HEAD_DIM = 128
#: the toy transformer of the card-against-CPU check (e)
CT_TOY = {"embed": 16, "n_heads": 2, "ffn": 24, "loader.seq_len": 256,
          "loader.minibatch_size": 4, "loader.n_validation": 4}
K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5
LR, MOMENTUM, DECAY = 0.01, 0.9, 5e-4
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
SERVE_ATOL = 1e-5
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-7
#: K6/K7 against their plain versions: a fifth of the JAX package's
#: kernel-vs-golden tolerances (SDPA_* below), which runs on an H100
#: allowed (max abs err 1.9e-6 forward, 7.2e-7 backward)
FLASH_FWD_RTOL, FLASH_FWD_ATOL = 4e-5, 4e-6
FLASH_BWD_RTOL, FLASH_BWD_ATOL = 1e-4, 1e-5
#: SDPA against the plain versions: the JAX package's tolerances
SDPA_FWD_RTOL, SDPA_FWD_ATOL = 2e-4, 2e-5
SDPA_BWD_RTOL, SDPA_BWD_ATOL = 5e-4, 5e-5
TIE_TAU = 1e-5
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "chiprun_out")
#: (name substring, HBM bytes/s, f32 non-tensor FLOP/s, dense TF32
#: tensor-core FLOP/s) — NVIDIA's data-sheet peaks (TF32 without sparsity:
#: half the sheets' sparse figures)
CARDS = (("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12),
         ("H200", 4.8e12, 67e12, 495e12),
         ("H100", 3.35e12, 67e12, 495e12))


def card_peaks(name: str):
    """(bytes/s, f32 FLOP/s, TF32 FLOP/s, the table's name) of a card."""
    for key, bw, flops, tf32 in CARDS:
        if key in name:
            return bw, flops, tf32, key
    print(f"chip_smoke: no peak table for {name!r}; bounds use the H100 "
          f"SXM's", flush=True)
    return 3.35e12, 67e12, 495e12, "H100 (assumed)"


def print_resource_usage(libs):
    """One BUILD line per compiled kernel function: its registers, stack
    and local memory (spills land there) and static shared memory, as
    cuobjdump reads them from the built library. Returns each library's
    functions' registers ({} where cuobjdump did not run)."""
    regs = {}
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump"))
    for name, path in libs.items():
        try:
            out = subprocess.run([tool, "-res-usage", str(path)],
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout
        except (OSError, subprocess.SubprocessError) as e:
            print(f"BUILD resource usage not read: {e}", flush=True)
            return {}
        for func, usage in re.findall(r"Function (\S+?):\s+(REG:[^\n]*)",
                                      out):
            print(f"BUILD {name} {func}: {usage.strip()}", flush=True)
            regs.setdefault(name, {})[func] = int(
                re.match(r"REG:(\d+)", usage).group(1))
    return regs


def print_spills(kernels):
    """BUILD lines from ptxas: each kernel function's stack frame and the
    bytes of it that are spill stores and loads (cuobjdump's STACK does
    not tell a spill from a local array). Compiles each source once more
    to a cubin with `-Xptxas -v`, all at once, flags as the build's."""
    import tempfile
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        procs = {name: subprocess.Popen(
            [kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"{name}.cubin"),
             str(kernels.CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for name, (src, _) in kernels.KERNELS.items()}
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed for {name}:\n"
                                   f"{log}")
            for func, frame, stores, loads in re.findall(
                    r"Function properties for (\S+)\n\s*(\d+) bytes stack "
                    r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                    r"loads", log):
                print(f"BUILD ptxas {name} {func}: {frame} B stack frame, "
                      f"{stores} B spill stores, {loads} B spill loads",
                      flush=True)


def print_flash_smem(libs, kernels):
    """BUILD lines: the dynamic shared memory one K6 block and one K7
    block take at each compiled head width, as the kernels' own sources
    compute it (cuobjdump reads only the static size)."""
    for name in ("flash_attention_forward", "flash_attention_backward"):
        lib = ctypes.CDLL(str(libs[name]))
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_int
        sizes = ", ".join(f"D {d}: {smem(d)} B"
                          for d in kernels.FLASH_HEAD_DIMS)
        print(f"BUILD {name} dynamic shared memory per block: {sizes}",
              flush=True)


def print_lrn_backward_smem(libs):
    """BUILD line: the dynamic shared memory one K3 block takes at each of
    AlexNet's LRN widths, as the kernel's own source computes it."""
    lib = ctypes.CDLL(str(libs["lrn_backward"]))
    smem = lib.lrn_backward_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_int
    sizes = ", ".join(f"C {c}: {smem(c, N // 2, 0)} B"
                      for _, _, c in LRN_SHAPES)
    print(f"BUILD lrn_backward dynamic shared memory per block: {sizes}",
          flush=True)


#: an H100 SM's limits on the blocks it holds at once: registers (a
#: warp's allocated in units of 256), shared memory (1 KB more a block),
#: threads and blocks
SM_REGS, REG_UNIT, SM_SMEM, BLOCK_SMEM_EXTRA = 65536, 256, 233472, 1024
SM_THREADS, SM_BLOCKS = 2048, 32
#: threads of a K4 and of a K2 block (the sources' kThreads)
LRN_FORWARD_THREADS = 256


def blocks_per_sm(regs: int, smem: int, threads: int) -> int:
    """The blocks of `threads` threads, `regs` registers a thread and
    `smem` bytes of dynamic shared memory that one SM holds at once."""
    warp_regs = -(-regs * 32 // REG_UNIT) * REG_UNIT
    return min(SM_BLOCKS, SM_THREADS // threads,
               SM_REGS // (warp_regs * (threads // 32)),
               SM_SMEM // (smem + BLOCK_SMEM_EXTRA))


def print_forward_smem(libs, regs):
    """BUILD lines: the dynamic shared memory one K4 block takes at each of
    AlexNet's LRN inputs under its 3x3/2 pool and one K2 block at each of
    its LRN widths, as the kernels' own sources size them, and the blocks
    an SM holds of each instance at the registers cuobjdump read."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    k4 = ctypes.CDLL(str(libs["lrn_maxpool_forward"])).\
        lrn_maxpool_forward_smem_bytes
    k4.argtypes = [ctypes.c_int] * 12
    k4.restype = ctypes.c_int
    k2 = ctypes.CDLL(str(libs["lrn_forward"])).lrn_forward_smem_bytes
    k2.argtypes = [ctypes.c_int] * 3
    k2.restype = ctypes.c_int
    for layer, (h, w, c) in zip(("L1", "L2"), LRN_SHAPES):
        for name, smem in (
                ("lrn_maxpool_forward",
                 k4(h, w, c, *pool_out_hw(h, w, 3, 3, 2, 2), 3, 3, 2, 2,
                    N // 2, 0, 0)),
                ("lrn_forward", k2(c, N // 2, 0))):
            if smem < 0:
                raise RuntimeError(f"{name} refuses AlexNet's {layer}")
            parts = []
            for func, r in sorted(regs.get(name, {}).items()):
                # the generic instance's template arguments are all -1;
                # the bf16 instance takes __nv_bfloat16 pointers
                what = ("generic" if "Lin1E" in func else "compile-time") \
                    + (" bf16" if "bfloat16" in func else "")
                parts.append(f"{what} instance ({r} registers) "
                             f"{blocks_per_sm(r, smem, LRN_FORWARD_THREADS)} "
                             f"blocks an SM")
            print(f"BUILD {name} {layer} ({h}x{w}x{c}): {smem} B dynamic "
                  f"shared memory per block, "
                  f"{', '.join(parts) or 'registers not read'}", flush=True)


class ColdTimer:
    """Median device time of one call, each launch preceded by a write of
    a buffer twice the 50 MB L2, so no input is left in L2 by the last
    repetition."""

    def __init__(self, device, reps: int = 25) -> None:
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        self.reps = reps

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def lrn_ops(numel: int) -> int:
    """f32 operations one LRN output needs: n squares, n-1 adds, the
    scale (k + alpha*sum: 2), sqrt, rsqrt, two products for s^(-3/4) and
    the final product: 2n + 6."""
    return numel * (2 * N + 6)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol {atol} + rtol "
            f"{rtol}; max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def small_input(rs, shape, kind):
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "nan":
        x[0, 2, 2, 3] = x[1, 13, 15, 39] = x[1, 6, 0, 0] = np.nan
    return x


def assert_same_bits(name: str, got: torch.Tensor, want: torch.Tensor):
    """The same bits as the plain version, NaN exactly where it has NaN;
    returns the count of NaN."""
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        raise AssertionError(f"{name}: NaN at other places than the plain "
                             f"version's")
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    if not torch.equal(got, want):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: not the plain version's bits (max "
                             f"abs err {err:.3e})")
    return int(nan.sum())


def forward_small_checks(kernels, dev):
    """K4 and K2 against their plain versions at K4_SMALL's and K2_SMALL's
    shapes: the same bits, NaN exactly where the plain version has NaN."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    rs = np.random.RandomState(11)
    for what, shape, ksize, stride, kind in K4_SMALL:
        x = torch.from_numpy(small_input(rs, shape, kind)).to(dev)
        got = kernels.lrn_maxpool_forward(x, K, ALPHA, BETA, N, ksize,
                                          stride)
        want = kernels.lrn_maxpool_forward_plain(x, K, ALPHA, BETA, N,
                                                 ksize, stride)
        torch.cuda.synchronize()
        nan = assert_same_bits(f"lrn_maxpool_forward {what}", got, want)
        oh, ow = pool_out_hw(shape[1], shape[2], *ksize, *stride)
        print(f"K4 {what} x {list(shape)} {ksize[0]}x{ksize[1]}/"
              f"{stride[0]}x{stride[1]} -> {oh}x{ow}: {nan} NaN, "
              f"{int(torch.isneginf(want).sum())} -inf, bit-equal",
              flush=True)
    for what, shape, n, kind in K2_SMALL:
        x = torch.from_numpy(small_input(rs, shape, kind)).to(dev)
        got = kernels.lrn_forward(x, K, ALPHA, BETA, n)
        want = kernels.lrn_forward_plain(x, K, ALPHA, BETA, n)
        torch.cuda.synchronize()
        nan = assert_same_bits(f"lrn_forward {what}", got, want)
        print(f"K2 {what} x {list(shape)} n {n}: {nan} NaN, bit-equal",
              flush=True)


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """`x` again, one float into a buffer: contiguous but not 16-byte
    aligned, so the LRN kernels stage it by 4-byte copies."""
    xm = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    xm.copy_(x)
    return xm


def kernel_phase(kernels, dev, bw, flops):
    """Hold K2 and K4 against their plain versions and time them: the
    small checks, then AlexNet's two LRN inputs at the ring's batch, where
    each must give the plain version's bits, also through its generic
    instance and with 4-byte copies, each timed."""
    forward_small_checks(kernels, dev)
    timer = ColdTimer(dev)
    rs = np.random.RandomState(0)
    rows = {"lrn_forward": [], "lrn_maxpool_forward": []}
    for layer, hwc in zip(("L1", "L2"), LRN_SHAPES):
        shape = (B,) + hwc
        # post-ReLU activations: half the inputs are zeros, so pooling
        # windows tie as they do on the served path
        x = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                             .astype(np.float32)).to(dev)
        xm = misaligned(x)
        nbytes = x.numel() * 4
        with torch.inference_mode():
            # -- K2 --------------------------------------------------------
            yk = kernels.lrn_forward(x, K, ALPHA, BETA, N)
            yp = kernels.lrn_forward_plain(x, K, ALPHA, BETA, N)
            yg = kernels.lrn_forward(x, K, ALPHA, BETA, N, generic=True)
            y4 = kernels.lrn_forward(xm, K, ALPHA, BETA, N)
            torch.cuda.synchronize()
            err = check_close(f"lrn_forward {layer}", yk, yp, KERNEL_RTOL,
                              KERNEL_ATOL)
            for what, other in (("plain version", yp),
                                ("generic instance", yg),
                                ("4-byte copies", y4)):
                if not torch.equal(yk, other):
                    raise AssertionError(f"lrn_forward {layer}: the {what} "
                                         f"gives other bits")

            def lib():
                return F.local_response_norm(x.permute(0, 3, 1, 2), size=N,
                                             alpha=ALPHA * N, beta=BETA,
                                             k=K)
            check_close(f"F.local_response_norm {layer}",
                        lib().permute(0, 2, 3, 1), yp, 1e-4, 1e-5)
            bound = max(2 * nbytes / bw, lrn_ops(x.numel()) / flops) * 1e3
            rows["lrn_forward"].append({
                "shape": list(shape), "max_abs_err": err,
                "ms": timer(lambda: kernels.lrn_forward(x, K, ALPHA, BETA,
                                                        N)),
                "generic_ms": timer(lambda: kernels.lrn_forward(
                    x, K, ALPHA, BETA, N, generic=True)),
                "copy4_ms": timer(lambda: kernels.lrn_forward(
                    xm, K, ALPHA, BETA, N)),
                "plain_ms": timer(lambda: kernels.lrn_forward_plain(
                    x, K, ALPHA, BETA, N)),
                "library_ms": timer(lib), "bound_ms": bound,
                "bound_by": ("bytes" if 2 * nbytes / bw
                             >= lrn_ops(x.numel()) / flops
                             else "operations")})
            # -- K4 --------------------------------------------------------
            zk = kernels.lrn_maxpool_forward(x, K, ALPHA, BETA, N)
            zp = kernels.lrn_maxpool_forward_plain(x, K, ALPHA, BETA, N)
            zg = kernels.lrn_maxpool_forward(x, K, ALPHA, BETA, N,
                                             generic=True)
            z4 = kernels.lrn_maxpool_forward(xm, K, ALPHA, BETA, N)
            torch.cuda.synchronize()
            err = check_close(f"lrn_maxpool_forward {layer}", zk, zp,
                              KERNEL_RTOL, KERNEL_ATOL)
            for what, other in (("plain version", zp),
                                ("generic instance", zg),
                                ("4-byte copies", z4)):
                if not torch.equal(zk, other):
                    raise AssertionError(f"lrn_maxpool_forward {layer}: the "
                                         f"{what} gives other bits")
            t_bytes = (nbytes + zk.numel() * 4) / bw
            t_ops = (lrn_ops(x.numel()) + zk.numel() * 8) / flops
            rows["lrn_maxpool_forward"].append({
                "shape": list(shape), "out_shape": list(zk.shape),
                "max_abs_err": err,
                "ms": timer(lambda: kernels.lrn_maxpool_forward(
                    x, K, ALPHA, BETA, N)),
                "generic_ms": timer(lambda: kernels.lrn_maxpool_forward(
                    x, K, ALPHA, BETA, N, generic=True)),
                "copy4_ms": timer(lambda: kernels.lrn_maxpool_forward(
                    xm, K, ALPHA, BETA, N)),
                "plain_ms": timer(lambda: kernels.lrn_maxpool_forward_plain(
                    x, K, ALPHA, BETA, N)),
                "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        for name in rows:
            r = rows[name][-1]
            print(f"KERNEL {name} {layer} {r['shape']}: ms "
                  f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['library_ms']} bound_ms {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) max_abs_err {r['max_abs_err']:.3e}",
                  flush=True)
            print(f"KERNEL {name} {layer}: bit-equal to the plain version; "
                  f"generic instance ms {r['generic_ms']:.4f}, 4-byte copies "
                  f"(x not 16-byte aligned) ms {r['copy4_ms']:.4f}, both "
                  f"bit-equal (compile-time instance, 16-byte copies "
                  f"{r['ms']:.4f})", flush=True)
        del x, xm, yk, yp, yg, y4, zk, zp, zg, z4
    return rows


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def post(url: str, x: np.ndarray):
    body = json.dumps({"inputs": x.tolist()}).encode()
    req = urllib.request.Request(url + "/predict", data=body, method="POST")
    req.add_header("Content-Type", "application/json")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, resp = r.status, json.loads(r.read())
    return status, resp, time.perf_counter() - t0


def get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def wire_params(wire: str, params, device):
    """A workflow's parameters (a tuple of {name: tensor}) as `wire`
    serves them, decoded on `device` by the plain functions and not by
    the server's: a >=2-D float leaf whose last axis holds a whole block
    through `reference.serve_quantize_weight` and `dequantize_blockwise`
    for int8, every float leaf cast for bf16, the leaves as they are for
    f32."""
    from veles_tpu_torch.ops import reference
    out = []
    for layer in params:
        d = {}
        for k, t in layer.items():
            t = torch.as_tensor(t).detach()
            if wire == "int8" and t.dim() >= 2 and t.is_floating_point() \
                    and t.shape[-1] >= INT8_BLOCK:
                a = t.cpu().numpy().astype(np.float32)
                q, s = reference.serve_quantize_weight(a, INT8_BLOCK)
                t = torch.from_numpy(np.ascontiguousarray(
                    reference.dequantize_blockwise(q, s, INT8_BLOCK)[
                        :, :a.shape[-1]].reshape(a.shape)))
            elif wire == "bf16" and t.is_floating_point():
                t = t.to(torch.bfloat16)
            d[k] = t.to(device)
        out.append(d)
    return tuple(out)


def padded(srv, x: np.ndarray, rows=None) -> torch.Tensor:
    """`x` in the first rows of a zeroed batch of the server's ring (or
    of `rows`: a merge bucket), on the card."""
    pad = np.zeros(((rows or srv.ring_slots),) + x.shape[1:], np.float32)
    pad[:len(x)] = x
    return torch.from_numpy(pad).to(srv.device)


def plain_forward(srv, kernels, x: np.ndarray, params=None, rows=None,
                  lrn: bool = True):
    """The served model on the card through `srv`'s wire, with every LRN
    through its plain version and no fused pair: the reference the served
    outputs are held against. `params` is a workflow's parameter tuple
    (the served workflow's by default), decoded by `wire_params`, so the
    reference shares none of the server's wire transform or placement;
    the bf16 wire takes a bf16 input, an f32 wire computes in full f32.
    `lrn=False` leaves every LRN out (what a K2/K4 that skipped its
    normalisation would serve). Rows are padded as `padded` pads them.
    Returns (probabilities, logits) of x's rows, f32."""
    from veles_tpu_torch.backends import full_f32
    with torch.inference_mode(), full_f32(srv.device):
        ps = wire_params(srv.quantize, srv._fwd.params() if params is None
                         else params, srv.device)
        h = padded(srv, x, rows)
        if srv.quantize == "bf16":
            h = h.to(torch.bfloat16)
        for u, p in zip(srv._fwd.forwards, ps):
            if getattr(u, "variant_op", None) == "lrn":
                if lrn:
                    h = kernels.lrn_forward_plain(h, u.k, u.alpha, u.beta,
                                                  u.n)
            else:
                h = u.fused_apply(p, h, train=False)
        z = h.float()
        return (torch.softmax(z, dim=-1)[:len(x)].cpu().numpy(),
                z[:len(x)].cpu().numpy())


def served_logits(srv, x: np.ndarray, rows=None) -> np.ndarray:
    """The logits the server's own wire forward gives x's rows under its
    live generation, padded as `padded` pads them: the call
    `InferenceServer._serve` makes before its softmax."""
    with torch.inference_mode():
        z = srv._sv(srv._gens.params, padded(srv, x, rows),
                    srv._fwd._forward, srv._shapes)
        return z.float()[:len(x)].cpu().numpy()


def logit_tol(wire: str, ref: np.ndarray) -> float:
    """LOGIT_ULPS machine epsilons of the wire's compute type (bf16 for
    the bf16 wire, f32 for f32 and int8) times the largest reference
    logit."""
    dt = torch.bfloat16 if wire == "bf16" else torch.float32
    return LOGIT_ULPS * torch.finfo(dt).eps * float(np.abs(ref).max())


def layer_times(srv, x: np.ndarray) -> list:
    """Device ms of each step of the served forward on one ring (mean of
    10 after a warm-up), with the unit names of the plan."""
    from veles_tpu_torch.backends import full_f32
    fwd = srv._fwd
    h0 = torch.from_numpy(x).to(srv.device)
    out = []
    with torch.inference_mode(), full_f32(srv.device):
        for _ in range(2):
            fwd._forward(fwd.params(), h0)
        torch.cuda.synchronize()
        h = h0
        for i, (kind, j, v) in enumerate(fwd._plan):
            if kind == "skip":
                continue
            u = fwd.forwards[i]

            def step(h=h, u=u, kind=kind, j=j, v=v, i=i):
                if kind == "pair":
                    return fwd._apply_fused_pair(v, u, fwd.forwards[j],
                                                 fwd.params()[i], h)
                if v is not None:
                    return u.fused_apply(fwd.params()[i], h, variant=v)
                return u.fused_apply(fwd.params()[i], h)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            step()
            start.record()
            for _ in range(10):
                nxt = step()
            end.record()
            end.synchronize()
            name = type(u).__name__ + (
                "+" + type(fwd.forwards[j]).__name__ if kind == "pair"
                else "")
            out.append((name, start.elapsed_time(end) / 10))
            h = nxt
    return out


def serve_phase(launcher, kernels, dev):
    """Serve the full-width AlexNet under both lrn_maxpool settings."""
    rs = np.random.RandomState(1)
    # float64 rounded to 3 decimals: short JSON numbers (a 64-row request
    # is ~80 MB of JSON); the server reads them as the float32 values
    # plain_forward gets
    requests = [rs.randn(rows, HW, HW, 3).round(3)
                for rows in sorted({1, min(8, B), B})]
    served, launches = {}, {name: 0 for name in kernels.INSTANCES}
    # what the CLI runs under: PyTorch's defaults, which let cuDNN use TF32
    tf32_default = tf32_flags()
    print(f"SERVE: process TF32 flags (cudnn, matmul) {tf32_default}",
          flush=True)
    for setting in ("fused", "composed"):
        t0 = time.perf_counter()
        srv = launcher.serve([ALEXNET, "--serve", "0", "-r", "1234",
                              "--lrn-maxpool", setting, "--serve-ring",
                              str(B), "--serve-max-body", str(1 << 30),
                              *SERVE_ARGS])
        try:
            if srv.device != dev:
                raise AssertionError(f"served on {srv.device}, not {dev}")
            print(f"SERVE {setting}: server up in "
                  f"{time.perf_counter() - t0:.2f} s on {srv.device}, "
                  f"variants {srv._fwd.variant_table()}", flush=True)
            url = f"http://127.0.0.1:{srv.port}"
            # -- the main path: counts zeroed just before, read just after
            kernels.reset_launch_counts()
            outs = []
            for x in requests:
                status, resp, dt = post(url, x)
                if status != 200:
                    raise AssertionError(f"/predict answered {status}")
                out = np.asarray(resp["outputs"], np.float64)
                outs.append((out, resp["classes"]))
                print(f"SERVE {setting}: {len(x)} rows -> 200 in "
                      f"{dt * 1e3:.1f} ms (JSON both ways included)",
                      flush=True)
            counts = kernels.launch_counts()
            print(f"SERVE {setting}: launches {counts}", flush=True)
            if tf32_flags() != tf32_default:
                raise AssertionError(f"serving changed the process's TF32 "
                                     f"flags: {tf32_default} -> "
                                     f"{tf32_flags()}")
            for name, c in counts.items():
                launches[name] += c
            want = {"fused": "lrn_maxpool_forward",
                    "composed": "lrn_forward"}[setting]
            if counts[want] <= 0:
                raise AssertionError(f"{want} never launched under "
                                     f"lrn_maxpool={setting}")
            # -- checks off the main path
            for x, (out, classes) in zip(requests, outs):
                if out.shape != (len(x), N_CLASSES):
                    raise AssertionError(f"outputs shaped {out.shape}")
                if not np.isfinite(out).all():
                    raise AssertionError("non-finite outputs")
                if np.abs(out.sum(axis=1) - 1).max() > 1e-4:
                    raise AssertionError("softmax rows do not sum to 1")
                if classes != out.argmax(axis=1).tolist():
                    raise AssertionError("classes are not the argmax")
                ref, _ = plain_forward(srv, kernels, x.astype(np.float32))
                err = float(np.abs(out - ref).max())
                if err > SERVE_ATOL:
                    raise AssertionError(
                        f"served vs plain forward: max abs err {err:.3e} "
                        f"> {SERVE_ATOL}")
                print(f"SERVE {setting}: {len(x)} rows vs plain forward "
                      f"max abs err {err:.3e}", flush=True)
            served[setting] = [c for _, c in outs]
            for path in ("/healthz", "/info"):
                status, _ = get(url, path)
                if status != 200:
                    raise AssertionError(f"{path} answered {status}")
            ring = rs.randn(B, HW, HW, 3).astype(np.float32)
            steps = layer_times(srv, ring)
            total = sum(ms for _, ms in steps)
            print(f"FORWARD {setting}: ring of {B} in {total:.3f} ms "
                  f"(sum of steps): " + ", ".join(
                      f"{n} {ms:.3f}" for n, ms in steps), flush=True)
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()
    if served["fused"] != served["composed"]:
        raise AssertionError("fused and composed served different classes")
    return launches


def lrn_grad_ops(numel: int) -> int:
    """f32 operations of one LRN gradient element: s and d as in the
    forward (n + 6), t = g*x*d/s (3), the window sum of t (n - 1) and
    dx = g*d - c2*x*tsum (4): 2n + 12."""
    return numel * (2 * N + 12)


def leaf_lr(shape) -> float:
    """AlexNet's per-leaf learning rate: biases (1-D) at twice the lr."""
    return LR * (2.0 if len(shape) == 1 else 1.0)


#: K5 small checks: (what, x shape, window, stride, input); the AlexNet
#: shapes pool exactly and their C divides by K5's 32-channel tiles
K5_SMALL = (("clipped both axes, C 40", (2, 14, 16, 40), (3, 3), (2, 2),
             "relu"),
            ("C 3", (2, 14, 16, 3), (3, 3), (2, 2), "relu"),
            ("C 70", (2, 9, 11, 70), (3, 3), (2, 2), "relu"),
            ("all zero", (2, 14, 16, 40), (3, 3), (2, 2), "zero"),
            ("NaN windows", (2, 14, 16, 40), (3, 3), (2, 2), "nan"),
            ("3x3 stride 1", (2, 13, 15, 40), (3, 3), (1, 1), "relu"),
            ("2x2 stride 2", (2, 13, 15, 40), (2, 2), (2, 2), "relu"))


#: K4 small checks: K5's and a 2x2 stride 3 pool whose last pooled row
#: and column lie wholly past the edge (-inf there); (what, x shape,
#: window, stride, input)
K4_SMALL = K5_SMALL + (("empty last window, 2x2 stride 3",
                        (2, 12, 12, 40), (2, 2), (3, 3), "relu"),)


def k5_small_checks(kernels, dev):
    """K5 against its plain version at K5_SMALL's shapes: within the
    kernel gate, NaN exactly where the plain version has NaN."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    rs = np.random.RandomState(8)
    for what, shape, ksize, stride, kind in K5_SMALL:
        x = small_input(rs, shape, kind)
        oh, ow = pool_out_hw(shape[1], shape[2], *ksize, *stride)
        g = rs.randn(shape[0], oh, ow, shape[3]).astype(np.float32)
        xt, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        got = kernels.lrn_maxpool_backward(xt, gt, K, ALPHA, BETA, N, ksize,
                                           stride)
        want = kernels.lrn_maxpool_backward_plain(xt, gt, K, ALPHA, BETA, N,
                                                  ksize, stride)
        torch.cuda.synchronize()
        nan = want.isnan()
        if not torch.equal(got.isnan(), nan):
            raise AssertionError(f"lrn_maxpool_backward {what}: NaN at "
                                 f"other places than the plain version's")
        got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
        err = check_close(f"lrn_maxpool_backward {what}", got, want,
                          KERNEL_RTOL, KERNEL_ATOL)
        print(f"K5 {what} x {list(shape)} {ksize[0]}x{ksize[1]}/"
              f"{stride[0]}x{stride[1]}: max abs err {err:.3e}, "
              f"{int(nan.sum())} NaN, bit-equal {torch.equal(got, want)}",
              flush=True)


#: K3 small checks: (what, x shape, LRN n, input); K3's tiles are whole
#: rows (32 of 96 channels, 12 of 256 at AlexNet's widths), or runs of
#: 3072 channels of wider rows
K3_SMALL = (("ragged last tile, C 96", (3, 5, 9, 96), 5, "relu"),
            ("ragged last tile, C 256", (3, 5, 7, 256), 5, "relu"),
            ("C 3", (2, 14, 16, 3), 5, "relu"),
            ("C 40", (2, 14, 16, 40), 5, "relu"),
            ("C 70", (2, 9, 11, 70), 5, "relu"),
            ("LRN n 3", (2, 14, 16, 40), 3, "relu"),
            ("all zero", (2, 14, 16, 40), 5, "zero"),
            ("NaN in x", (2, 14, 16, 40), 5, "nan"),
            ("channel tiles, C 4098", (1, 3, 5, 4098), 5, "relu"),
            ("channel tiles, C 4100", (1, 3, 5, 4100), 5, "relu"))


#: K2 small checks: K3's (ragged last tiles, rows of 4098 and 4100
#: channels cut into channel tiles); (what, x shape, LRN n, input)
K2_SMALL = K3_SMALL


def k3_small_checks(kernels, dev):
    """K3 against its plain version at K3_SMALL's shapes: the same bits,
    NaN exactly where the plain version has NaN."""
    rs = np.random.RandomState(10)
    for what, shape, n, kind in K3_SMALL:
        x = small_input(rs, shape, kind)
        g = rs.randn(*shape).astype(np.float32)
        xt, gt = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
        got = kernels.lrn_backward(xt, gt, K, ALPHA, BETA, n)
        want = kernels.lrn_backward_plain(xt, gt, K, ALPHA, BETA, n)
        torch.cuda.synchronize()
        nan = assert_same_bits(f"lrn_backward {what}", got, want)
        print(f"K3 {what} x {list(shape)} n {n}: {nan} NaN, bit-equal",
              flush=True)


def backward_kernel_phase(kernels, dev, bw, flops):
    """Hold K3, K5 and K1 against their plain versions at the training
    path's shapes and time them."""
    k3_small_checks(kernels, dev)
    k5_small_checks(kernels, dev)
    timer = ColdTimer(dev)
    rs = np.random.RandomState(2)
    rows = {"lrn_backward": [], "lrn_maxpool_backward": [],
            "sgd_update": []}
    for layer, hwc in zip(("L1", "L2"), LRN_SHAPES):
        shape = (TB,) + hwc
        x = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                             .astype(np.float32)).to(dev)
        g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
        nbytes = x.numel() * 4
        # -- K3 ---------------------------------------------------------------
        xm = misaligned(x)
        dk = kernels.lrn_backward(x, g, K, ALPHA, BETA, N)
        dp = kernels.lrn_backward_plain(x, g, K, ALPHA, BETA, N)
        dg = kernels.lrn_backward(x, g, K, ALPHA, BETA, N, generic=True)
        d4 = kernels.lrn_backward(xm, g, K, ALPHA, BETA, N)
        torch.cuda.synchronize()
        err = check_close(f"lrn_backward {layer}", dk, dp, KERNEL_RTOL,
                          KERNEL_ATOL)
        for what, other in (("plain version", dp), ("generic instance", dg),
                            ("4-byte copies", d4)):
            if not torch.equal(dk, other):
                raise AssertionError(f"lrn_backward {layer}: the {what} "
                                     f"gives other bits")
        leaf = x.clone().requires_grad_(True)
        y = F.local_response_norm(leaf.permute(0, 3, 1, 2), size=N,
                                  alpha=ALPHA * N, beta=BETA, k=K)
        g_nchw = g.permute(0, 3, 1, 2)

        def lib():
            return torch.autograd.grad(y, leaf, g_nchw, retain_graph=True)[0]
        lib_err = check_close(f"autograd of F.local_response_norm {layer}",
                              lib(), dp, 1e-4, 1e-5)
        t_bytes, t_ops = 3 * nbytes / bw, lrn_grad_ops(x.numel()) / flops
        rows["lrn_backward"].append({
            "shape": list(shape), "max_abs_err": err,
            "ms": timer(lambda: kernels.lrn_backward(x, g, K, ALPHA, BETA,
                                                     N)),
            "generic_ms": timer(lambda: kernels.lrn_backward(
                x, g, K, ALPHA, BETA, N, generic=True)),
            "copy4_ms": timer(lambda: kernels.lrn_backward(xm, g, K, ALPHA,
                                                           BETA, N)),
            "plain_ms": timer(lambda: kernels.lrn_backward_plain(
                x, g, K, ALPHA, BETA, N)),
            "library_ms": timer(lib),
            "library": "autograd of F.local_response_norm",
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        r = rows["lrn_backward"][-1]
        print(f"KERNEL lrn_backward {layer}: bit-equal to the plain version; "
              f"generic instance ms {r['generic_ms']:.4f}, 4-byte copies (x "
              f"not 16-byte aligned) ms {r['copy4_ms']:.4f}, both bit-equal "
              f"(compile-time instance, 16-byte copies {r['ms']:.4f}); "
              f"library = autograd of F.local_response_norm, max abs err "
              f"against the plain version {lib_err:.3e}", flush=True)
        del dk, dp, dg, d4, xm, g, leaf, y, g_nchw
        # -- K5 ---------------------------------------------------------------
        oh = -(-(hwc[0] - 3) // 2) + 1
        ow = -(-(hwc[1] - 3) // 2) + 1
        gp = torch.from_numpy(rs.randn(TB, oh, ow, hwc[2])
                              .astype(np.float32)).to(dev)
        dk = kernels.lrn_maxpool_backward(x, gp, K, ALPHA, BETA, N)
        dp = kernels.lrn_maxpool_backward_plain(x, gp, K, ALPHA, BETA, N)
        torch.cuda.synchronize()
        err = check_close(f"lrn_maxpool_backward {layer}", dk, dp,
                          KERNEL_RTOL, KERNEL_ATOL)
        t_bytes = (2 * nbytes + gp.numel() * 4) / bw
        # the LRN values (2n + 6), the window maxima (8 compares per
        # pooled output), the routed sums (at most 4) and the gradient
        t_ops = ((2 * N + 6 + 4) * x.numel() + lrn_grad_ops(x.numel())
                 + 8 * gp.numel()) / flops
        # the same geometry through the run-time instance: the same bits,
        # and what AlexNet's compile-time constants buy
        dg = kernels.lrn_maxpool_backward(x, gp, K, ALPHA, BETA, N,
                                          generic=True)
        torch.cuda.synchronize()
        if not torch.equal(dg, dk):
            raise AssertionError(f"lrn_maxpool_backward {layer}: the "
                                 f"generic instance gives other bits")
        rows["lrn_maxpool_backward"].append({
            "shape": list(shape), "g_shape": list(gp.shape),
            "max_abs_err": err,
            "ms": timer(lambda: kernels.lrn_maxpool_backward(
                x, gp, K, ALPHA, BETA, N)),
            "generic_ms": timer(lambda: kernels.lrn_maxpool_backward(
                x, gp, K, ALPHA, BETA, N, generic=True)),
            "plain_ms": timer(lambda: kernels.lrn_maxpool_backward_plain(
                x, gp, K, ALPHA, BETA, N)),
            "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        for name in ("lrn_backward", "lrn_maxpool_backward"):
            print_kernel_line(name, layer, rows[name][-1])
        r = rows["lrn_maxpool_backward"][-1]
        print(f"KERNEL lrn_maxpool_backward {layer} generic instance: ms "
              f"{r['generic_ms']:.4f} (compile-time instance "
              f"{r['ms']:.4f}), bit-equal", flush=True)
        del x, gp, dk, dp, dg
    other = k5_other_geometry(kernels, dev, bw, flops, timer)
    # -- K1: one update of every AlexNet leaf ---------------------------------
    def leaf(shape, scale):
        return torch.from_numpy((scale * rs.randn(*shape))
                                .astype(np.float32)).to(dev)
    ps = [leaf(sh, 0.01) for sh in LEAVES]
    gs = [leaf(sh, 1e-3) for sh in LEAVES]
    vs = [leaf(sh, 1e-3) for sh in LEAVES]
    pk, vk = [p.clone() for p in ps], [v.clone() for v in vs]

    def update(fn, p_list, v_list):
        for sh, p, g, v in zip(LEAVES, p_list, gs, v_list):
            fn(p, g, v, leaf_lr(sh), MOMENTUM, DECAY)

    update(kernels.sgd_update, pk, vk)
    update(kernels.sgd_update_plain, ps, vs)
    torch.cuda.synchronize()
    err = max(max(check_close(f"sgd_update p {sh}", a, b, KERNEL_RTOL,
                              KERNEL_ATOL),
                  check_close(f"sgd_update v {sh}", c, d, KERNEL_RTOL,
                              KERNEL_ATOL))
              for sh, a, b, c, d in zip(LEAVES, pk, ps, vk, vs))
    n = sum(p.numel() for p in ps)
    t_bytes, t_ops = 5 * 4 * n / bw, 6 * n / flops
    rows["sgd_update"].append({
        "shape": f"{len(LEAVES)} AlexNet leaves", "elements": n,
        "max_abs_err": err,
        "ms": timer(lambda: update(kernels.sgd_update, pk, vk)),
        "plain_ms": timer(lambda: update(kernels.sgd_update_plain, ps, vs)),
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    print_kernel_line("sgd_update", "all", rows["sgd_update"][-1])
    del ps, gs, vs, pk, vk
    torch.cuda.empty_cache()
    return rows, other


def k5_other_geometry(kernels, dev, bw, flops, timer):
    """K5 at a pool geometry other than AlexNet's, at the training size:
    AlexNet's layer-2 input (128, 27, 27, 256) under 3x3 stride 1
    windows, through the generic instance (up to 9 windows cover an input
    pixel, against AlexNet's 4)."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    ksize, stride = (3, 3), (1, 1)
    rs = np.random.RandomState(9)
    shape = (TB,) + LRN_SHAPES[1]
    x = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                         .astype(np.float32)).to(dev)
    oh, ow = pool_out_hw(shape[1], shape[2], *ksize, *stride)
    gp = torch.from_numpy(rs.randn(TB, oh, ow, shape[3])
                          .astype(np.float32)).to(dev)
    dk = kernels.lrn_maxpool_backward(x, gp, K, ALPHA, BETA, N, ksize,
                                      stride)
    dp = kernels.lrn_maxpool_backward_plain(x, gp, K, ALPHA, BETA, N, ksize,
                                            stride)
    torch.cuda.synchronize()
    err = check_close("lrn_maxpool_backward 3x3/1", dk, dp, KERNEL_RTOL,
                      KERNEL_ATOL)
    t_bytes = (2 * x.numel() + gp.numel()) * 4 / bw
    t_ops = ((2 * N + 6 + 9) * x.numel() + lrn_grad_ops(x.numel())
             + 8 * gp.numel()) / flops
    row = {"shape": list(shape), "g_shape": list(gp.shape),
           "window": "3x3/1", "max_abs_err": err,
           "ms": timer(lambda: kernels.lrn_maxpool_backward(
               x, gp, K, ALPHA, BETA, N, ksize, stride)),
           "plain_ms": timer(lambda: kernels.lrn_maxpool_backward_plain(
               x, gp, K, ALPHA, BETA, N, ksize, stride)),
           "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print_kernel_line("lrn_maxpool_backward", "L2 3x3/1", row)
    del x, gp, dk, dp
    return row


def print_kernel_line(name, layer, r):
    rate = f", {r['bound_rate']}" if "bound_rate" in r else ""
    f32 = (f" bound_f32_ms {r['bound_f32_ms']:.4f}" if "bound_f32_ms" in r
           else "")
    print(f"KERNEL {name} {layer} {r['shape']}: ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
          f"{r['bound_ms']:.4f} ({r['bound_by']}{rate}){f32} max_abs_err "
          f"{r['max_abs_err']:.3e}", flush=True)


def heads_first(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def attention_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs one head computes: the causal mask keeps
    S(S+1)/2 of the S^2."""
    return s * (s + 1) // 2 if causal else s * s


def sdpa_backend(q, k, v) -> str:
    """The backend F.scaled_dot_product_attention dispatches these causal
    inputs to (flash, memory-efficient, cuDNN or math), as PyTorch's own
    dispatcher chooses it. (Not read from a profiler trace: a profiler
    session this early loses the later profiles' memcpy records.)"""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def flash_small_checks(kernels, dev):
    """K6 and K7 at every head width they are compiled for, on a ragged
    S, causal or not, KV forward or reversed, with and without a dropout
    mask, against their plain versions."""
    rs = np.random.RandomState(5)
    worst = [0.0, 0.0]
    s, bh = 200, 6
    for d in kernels.FLASH_HEAD_DIMS:
        q, k, v, g = (torch.from_numpy(rs.randn(bh, s, d).astype(np.float32))
                      .to(dev) for _ in range(4))
        mask = torch.from_numpy(((rs.rand(bh, s, d) < 0.8) / 0.8)
                                .astype(np.float32)).to(dev)
        for causal, order, m in ((False, "fwd", None), (True, "fwd", None),
                                 (True, "rev", None), (False, "rev", None),
                                 (True, "fwd", mask)):
            what = f"d {d} causal {causal} kv {order} mask {m is not None}"
            o, lse = kernels.flash_attention_forward(q, k, v, causal, None,
                                                     order, m)
            op, lp = kernels.flash_attention_forward_plain(q, k, v, causal,
                                                           None, order, m)
            worst[0] = max(worst[0], check_close(
                f"flash forward {what}", o, op, FLASH_FWD_RTOL,
                FLASH_FWD_ATOL), check_close(
                f"flash lse {what}", lse, lp, FLASH_FWD_RTOL,
                FLASH_FWD_ATOL))
            di = (g * o).sum(-1, keepdim=True)
            do = g if m is None else g * m
            got = kernels.flash_attention_backward(q, k, v, do, lse, di,
                                                   causal)
            want = kernels.flash_attention_backward_plain(q, k, v, do, lse,
                                                          di, causal)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                worst[1] = max(worst[1], check_close(
                    f"flash backward {name} {what}", a, b, FLASH_BWD_RTOL,
                    FLASH_BWD_ATOL))
    torch.cuda.synchronize()
    print(f"FLASH K6/K7 at head widths {kernels.FLASH_HEAD_DIMS}, S={s}, "
          f"B*H={bh}, causal/not, kv fwd/rev, with/without mask: max abs "
          f"err forward {worst[0]:.3e}, backward {worst[1]:.3e}", flush=True)


def flash_kernel_phase(kernels, dev, bw, flops, tf32):
    """Hold K6 and K7 against their plain versions at the transformer's
    shapes (4 heads of 16, 2 of 32), beside SDPA, and time them; both
    must also repeat bit for bit."""
    flash_small_checks(kernels, dev)
    timer = ColdTimer(dev)
    rs = np.random.RandomState(6)
    rows = {"flash_attention_forward": [], "flash_attention_backward": []}
    for shape in ATT_SHAPES:
        b, s, h, d = shape
        q, k, v, g = (heads_first(torch.from_numpy(
            rs.randn(*shape).astype(np.float32)).to(dev)) for _ in range(4))
        pairs = b * h * attention_pairs(s, True)
        row_bytes = b * h * s * d * 4
        # -- K6 -----------------------------------------------------------
        ok, lk = kernels.flash_attention_forward(q, k, v, True)
        op, lp = kernels.flash_attention_forward_plain(q, k, v, True)
        torch.cuda.synchronize()
        err = max(check_close("flash_attention_forward O", ok, op,
                              FLASH_FWD_RTOL, FLASH_FWD_ATOL),
                  check_close("flash_attention_forward lse", lk, lp,
                              FLASH_FWD_RTOL, FLASH_FWD_ATOL))
        # no atomics: a second call on the same inputs gives the same bits
        again = kernels.flash_attention_forward(q, k, v, True)
        for n, first, second in zip(("O", "lse"), (ok, lk), again):
            if not torch.equal(first, second):
                raise AssertionError(f"flash_attention_forward {n}: two "
                                     f"calls on the same inputs differ")
        print("KERNEL flash_attention_forward: two calls bit-identical",
              flush=True)
        del again
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=True)
        lib_err = check_close("F.scaled_dot_product_attention",
                              lib_fwd().reshape(b * h, s, d), op,
                              SDPA_FWD_RTOL, SDPA_FWD_ATOL)
        backend = sdpa_backend(q4, k4, v4)
        t_bytes = (4 * row_bytes + b * h * s * 4) / bw
        # the function's two products per kept pair (Q·Kᵀ, P·V), each
        # three TF32 products on the tensor cores for f32 accuracy
        # (3xTF32), as K6 executes them. Beside it, the same work in f32
        # on the CUDA cores.
        t_ops = 3 * 4 * d * pairs / tf32
        t_f32 = 4 * d * pairs / flops
        rows["flash_attention_forward"].append({
            "shape": list(shape), "causal": True, "max_abs_err": err,
            "ms": timer(lambda: kernels.flash_attention_forward(q, k, v,
                                                                True)),
            "plain_ms": timer(lambda: kernels.flash_attention_forward_plain(
                q, k, v, True)),
            "library_ms": timer(lib_fwd), "library": f"sdpa {backend}",
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": "3xTF32, tensor cores",
            "bound_f32_ms": max(t_bytes, t_f32) * 1e3})
        print_kernel_line("flash_attention_forward", "causal",
                          rows["flash_attention_forward"][-1])
        print(f"KERNEL flash_attention_forward: library = "
              f"F.scaled_dot_product_attention(is_causal=True) f32, "
              f"backend {backend}, max abs err against the plain version "
              f"{lib_err:.3e}", flush=True)
        del op, lp
        # -- K7 -----------------------------------------------------------
        di = (g * ok).sum(-1, keepdim=True)
        got = kernels.flash_attention_backward(q, k, v, g, lk, di, True)
        want = kernels.flash_attention_backward_plain(q, k, v, g, lk, di,
                                                      True)
        torch.cuda.synchronize()
        err = max(check_close(f"flash_attention_backward {n}", a, w,
                              FLASH_BWD_RTOL, FLASH_BWD_ATOL)
                  for n, a, w in zip(("dq", "dk", "dv"), got, want))
        # no atomics: a second call on the same inputs gives the same bits
        again = kernels.flash_attention_backward(q, k, v, g, lk, di, True)
        for n, first, second in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(first, second):
                raise AssertionError(f"flash_attention_backward {n}: two "
                                     f"calls on the same inputs differ")
        print("KERNEL flash_attention_backward: two calls bit-identical",
              flush=True)
        del again
        leaves = [t.view(b, h, s, d).clone().requires_grad_(True)
                  for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        g4 = g.view(b, h, s, d)

        def lib_bwd():
            return torch.autograd.grad(out, leaves, g4, retain_graph=True)
        lib_err = max(check_close(f"autograd of SDPA {n}",
                                  a.reshape(b * h, s, d), w, SDPA_BWD_RTOL,
                                  SDPA_BWD_ATOL)
                      for n, a, w in zip(("dq", "dk", "dv"), lib_bwd(),
                                         want))
        backend = sdpa_backend(*leaves)
        t_bytes = (7 * row_bytes + 2 * b * h * s * 4) / bw
        # the function's five products per kept pair (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO,
        # dS·K, dSᵀ·Q), each three TF32 products on the tensor cores for
        # f32 accuracy (3xTF32); K7 executes seven, recomputing two in
        # each launch. Beside it, the same work in f32 on the CUDA cores.
        t_ops = 3 * 10 * d * pairs / tf32
        t_f32 = 10 * d * pairs / flops
        rows["flash_attention_backward"].append({
            "shape": list(shape), "causal": True, "max_abs_err": err,
            "ms": timer(lambda: kernels.flash_attention_backward(
                q, k, v, g, lk, di, True)),
            "plain_ms": timer(lambda: kernels.flash_attention_backward_plain(
                q, k, v, g, lk, di, True)),
            "library_ms": timer(lib_bwd),
            "library": f"sdpa backward {backend}",
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": "3xTF32, tensor cores",
            "bound_f32_ms": max(t_bytes, t_f32) * 1e3})
        print_kernel_line("flash_attention_backward", "causal",
                          rows["flash_attention_backward"][-1])
        print(f"KERNEL flash_attention_backward: library = autograd of "
              f"F.scaled_dot_product_attention(is_causal=True) f32, "
              f"backend {backend}, max abs err against the plain version "
              f"{lib_err:.3e}", flush=True)
        del q, k, v, g, ok, lk, di, got, want, leaves, out, q4, k4, v4, g4
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def timed_steps():
    """Record CUDA events around every FusedTrainStep.train and .evaluate
    call in the block; yields the list of (kind, start, end)."""
    from veles_tpu_torch.parallel.fused import FusedTrainStep

    events = []
    inner = {"train": FusedTrainStep.train,
             "evaluate": FusedTrainStep.evaluate}

    def timed(kind):
        def call(self, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner[kind](self, *args, **kwargs)
            end.record()
            events.append((kind, start, end))
            return out
        return call

    FusedTrainStep.train = timed("train")
    FusedTrainStep.evaluate = timed("evaluate")
    try:
        yield events
    finally:
        FusedTrainStep.train = inner["train"]
        FusedTrainStep.evaluate = inner["evaluate"]


def train_run(launcher, kernels, dev, label, argv):
    """One `launcher.train(argv)` run with the launch counters zeroed just
    before it and read just after, and CUDA events around every step;
    prints the TRAIN lines and returns (workflow, counts)."""
    tf32_default = tf32_flags()
    with timed_steps() as events:
        t0 = time.perf_counter()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    steps = [(kind, s.elapsed_time(e)) for kind, s, e in events]
    loss = wf.evaluator.loss
    print(f"TRAIN {label}: {wf.decision.epoch_number} epoch(s) in "
          f"{wall:.2f} s of host time (data, init and steps) on "
          f"{wf.device}; step device ms (CUDA events) "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in steps), flush=True)
    print(f"TRAIN {label}: train-pass loss {loss}; history "
          f"{wf.decision.history}; launches {counts}", flush=True)
    if wf.device != dev:
        raise AssertionError(f"trained on {wf.device}, not {dev}")
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if tf32_flags() != tf32_default:
        raise AssertionError("training changed the process's TF32 flags")
    return wf, counts


def train_phase(launcher, kernels, dev):
    """Train the full-width AlexNet one epoch under both lrn_maxpool
    settings through `launcher.train`, the `--fused` CLI's function."""
    launches = {}
    want = {"fused": ("lrn_maxpool_forward", "lrn_maxpool_backward",
                      "sgd_update"),
            "composed": ("lrn_forward", "lrn_backward", "sgd_update")}
    for setting in ("fused", "composed"):
        wf, counts = train_run(
            launcher, kernels, dev, setting,
            [ALEXNET, "--fused", "-r", "1234", "--lrn-maxpool", setting,
             "root.alexnet.decision.max_epochs=1", *TRAIN_ARGS])
        launches[setting] = counts
        for name, c in counts.items():
            if name in want[setting] and c <= 0:
                raise AssertionError(f"{name} never launched under "
                                     f"lrn_maxpool={setting}")
            if name not in want[setting] and c != 0:
                raise AssertionError(f"{name} launched {c} times under "
                                     f"lrn_maxpool={setting}")
        # the backward kernel: once per LRN layer (two) per train step
        backward = want[setting][1]
        steps = wf.decision.epoch_number * -(-wf.loader.class_lengths[2]
                                             // wf.loader.minibatch_size)
        if counts[backward] != 2 * steps:
            raise AssertionError(f"{backward} launched {counts[backward]} "
                                 f"times in {steps} train steps under "
                                 f"lrn_maxpool={setting}, not twice each")
        print(f"TRAIN {setting}: {backward} twice in each of {steps} train "
              f"steps", flush=True)
        del wf
        torch.cuda.empty_cache()
    return launches


def transformer_run(launcher, kernels, dev, label, argv, epochs):
    """`epochs` epochs of the char-transformer at seq_len 4096 through
    `launcher.train`; every launch count is exact: K6 once per train and
    validation step, K7 and K1 x leaves once per train step, nothing
    else."""
    wf, counts = train_run(
        launcher, kernels, dev, label,
        [CHAR_TRANSFORMER, "--fused", "-r", "1234", *CT_TRAIN_ARGS, *argv,
         f"root.char_transformer.decision.max_epochs={epochs}"])
    loader = wf.loader
    if loader.seq_len != CT_SEQ or tuple(loader.sample_shape) != (CT_SEQ,
                                                                  18):
        raise AssertionError(f"trained seq_len {loader.seq_len}, samples "
                             f"{loader.sample_shape}")
    unit = wf.forwards[1]
    variant = unit.variant_effective()
    mb = loader.minibatch_size
    train_steps = -(-loader.class_lengths[2] // mb)
    valid_steps = -(-loader.class_lengths[1] // mb)
    done = wf.decision.epoch_number
    leaves = sum(len(u.param_arrays()) for u in wf.forwards)
    n_params = sum(t.numel() for u in wf.forwards
                   for t in u.param_arrays().values())
    want = {name: 0 for name in counts}
    want.update({
        "flash_attention_forward": done * (train_steps + valid_steps),
        "flash_attention_backward": done * train_steps,
        "sgd_update": done * train_steps * leaves})
    print(f"TRAIN {label}: {done} epoch(s) of {train_steps} train and "
          f"{valid_steps} validation minibatch(es) of {mb} x {CT_SEQ}, "
          f"{unit.n_heads} heads of {unit.head_dim}, attention variant "
          f"{variant}, {leaves} leaves ({n_params} parameters): launches "
          f"expected {want}", flush=True)
    if done != epochs or variant != "kernel" or counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want} "
                             f"(epochs {done}, variant {variant})")
    del wf
    torch.cuda.empty_cache()
    return counts


def transformer_train_phase(launcher, kernels, dev):
    """Train the char-transformer (4 heads of 16) at seq_len 4096 for two
    epochs through `launcher.train`."""
    return transformer_run(launcher, kernels, dev, "transformer", [], 2)


def transformer_wide_head_phase(launcher, kernels, dev):
    """One epoch of the char-transformer at seq_len 4096 with 2 heads of
    32 through `launcher.train`: K6 and K7 at head width 32. Then the unit
    at 1 head of 128, a width they are not compiled for, must be refused
    on the card under "auto" (no fallback to the einsum)."""
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    counts = transformer_run(launcher, kernels, dev, "transformer n_heads=2",
                             ["root.char_transformer.n_heads=2"], 1)
    d = REFUSED_HEAD_DIM
    wide = MultiHeadAttention(n_heads=1, use_flash="auto")
    wide.initialize((CT_SEQ, d), dev)
    x = torch.randn(1, CT_SEQ, d, device=dev)
    try:
        wide.fused_apply(wide.param_arrays(), x)
    except ValueError as e:
        print(f"TRAIN transformer n_heads=2: 1 head of {wide.head_dim} at "
              f"S={CT_SEQ}, variant {wide.variant_effective()}, refused on "
              f"the card: {e}", flush=True)
    else:
        raise AssertionError(f"attention at head width {wide.head_dim} ran "
                             f"on the card")
    return counts


def transformer_one_head_phase(launcher, kernels, dev):
    """One epoch (one train and one validation step) of the
    char-transformer at seq_len 4096 with 1 head of 64 through
    `launcher.train`: K6 and K7 at head width 64, exact counts."""
    return transformer_run(launcher, kernels, dev, "transformer n_heads=1",
                           ["root.char_transformer.n_heads=1"], 1)


@contextlib.contextmanager
def plain_kernels(kernels):
    """Every kernel wrapper swapped for its plain version: the autograd
    functions and the update variant call the wrappers by module name."""
    names = ("sgd_update", "lrn_forward", "lrn_backward",
             "lrn_maxpool_forward", "lrn_maxpool_backward",
             "flash_attention_forward", "flash_attention_backward")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(kernels, n, f)


def clone_state(state):
    return {"params": tuple({k: t.detach().clone().requires_grad_(True)
                             for k, t in layer.items()}
                            for layer in state["params"]),
            "vel": tuple({k: t.clone() for k, t in layer.items()}
                         for layer in state["vel"]),
            "lr_scale": state["lr_scale"]}


def compare_states(what, got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    """Max abs error over every leaf and velocity; raises beyond
    atol + rtol*|want|."""
    err = 0.0
    for slot in ("params", "vel"):
        for i, (a, b) in enumerate(zip(got[slot], want[slot])):
            for k in a:
                err = max(err, check_close(
                    f"{what}: {slot} unit {i} {k}", a[k].detach().cpu(),
                    b[k].detach().cpu(), rtol, atol))
    return err


def check_loss(what, got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    if not abs(got - want) <= atol + rtol * abs(want):
        raise AssertionError(f"{what}: loss {got} != {want}")


def step_split_ms(step, state, x, y, w):
    """Device ms of the forward (with the loss), the backward and the
    update of one train step, by CUDA events between the three parts of
    FusedTrainStep.train's body (repeated here to place the events)."""
    from veles_tpu_torch.backends import full_f32
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    xb, yb, wb = step._batch(x, y, w)
    leaves = [t for layer in state["params"] for t in layer.values()]
    ev[0].record()
    with torch.enable_grad(), full_f32(step.device):
        out = step.fwd._forward(state["params"], xb, train=True,
                                gen=step.gen)
        loss, _ = step._loss_metrics(out, yb, wb)
        ev[1].record()
        grads = iter(torch.autograd.grad(loss, leaves))
        ev[2].record()
    with torch.no_grad():
        for p, v, cfg in zip(state["params"], state["vel"], step.cfgs):
            if p:
                step._sgd.apply(p, {k: next(grads) for k in p}, v, cfg,
                                lr_scale=state["lr_scale"])
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def kernel_family(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "flash" in low:
        return "flash"
    if "lrn" in low or "max_pool" in low or "maxpool" in low:
        return "lrn/pool"
    if "sgd_update" in low:
        return "update"
    # cuDNN's FFT convolutions run complex (cf32) GEMMs and flip filters
    if any(t in low for t in ("conv", "cudnn", "wgrad", "dgrad", "fprop",
                              "implicit", "cf32", "flip_filter")):
        return "conv"
    # cuBLAS's Hopper bf16 GEMMs are named nvjet_*
    if any(t in low for t in ("gemm", "gemv", "cublas", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_step(step, state, x, y, w, out_name="train_profile.json"):
    """Device time of one train step by kernel family, from
    torch.profiler's CUDA activity, the batch already on the card; the
    kernels' table goes to chiprun_out/`out_name`."""
    from torch.profiler import ProfilerActivity, profile
    # the batch on the card first, as the device feed hands it to the
    # step on the main path
    x, y, w = step._batch(x, y, w)
    step.train(state, x, y, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step.train(state, x, y, w)
        torch.cuda.synchronize()
    kernels_us = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        kernels_us[e.name] = kernels_us.get(e.name, 0.0) + float(us)
    families = {}
    for name, us in kernels_us.items():
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + us / 1e3
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, out_name), "w") as f:
        json.dump({"ms_by_family": families,
                   "us_by_kernel": dict(sorted(kernels_us.items(),
                                               key=lambda kv: -kv[1]))},
                  f, indent=1)
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]
    print(f"PROFILE one fused train step ({out_name}), device ms by family "
          f"{ {k: round(v, 4) for k, v in families.items()} }; top "
          "kernels (us): " + "; ".join(f"{n[:60]} {us:.1f}"
                                        for n, us in top), flush=True)
    return families


def step_checks(kernels, variants, dev):
    """(a) kernels against plain versions and (b) fused against composed,
    on the first full-width train step from one state and batch; then
    the step's split by CUDA events and by profiler."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    wf.initialize(dev)
    steps = {}
    for setting in ("fused", "composed"):
        variants.select("lrn_maxpool", setting)
        steps[setting] = wf.build_fused_step()
    variants.clear_selection("lrn_maxpool")
    s0 = steps["fused"].init_state()
    rs = np.random.RandomState(3)
    mb, shape = wf.loader.minibatch_size, wf.loader.sample_shape
    x = rs.randn(mb, *shape).astype(np.float32)
    y = rs.randint(0, wf.n_classes, mb)
    w = np.ones(mb, np.float32)

    def run(setting, plain=False):
        st = clone_state(s0)
        # every run draws the same dropout masks
        steps[setting].gen = prng.get().torch_generator(dev)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            st, (loss, n_err) = steps[setting].train(st, x, y, w)
        torch.cuda.synchronize()
        return st, float(loss), int(n_err)

    kst, kloss, kerr = run("fused")
    pst, ploss, perr = run("fused", plain=True)
    check_loss("(a) kernel vs plain step", kloss, ploss)
    if kerr != perr:
        raise AssertionError(f"(a) n_err {kerr} != {perr}")
    err_a = compare_states("(a) kernel vs plain step", kst, pst)
    print(f"CHECK (a) first full-width train step, kernels vs plain "
          f"versions: loss {kloss} vs {ploss}, n_err {kerr} vs {perr}, "
          f"max abs err over every leaf and velocity {err_a:.3e} "
          f"(tolerance {TRAIN_ATOL} + {TRAIN_RTOL}*|plain|)", flush=True)
    cst, closs, cerr = run("composed")
    check_loss("(b) fused vs composed step", kloss, closs)
    if kerr != cerr:
        raise AssertionError(f"(b) n_err {kerr} != {cerr}")
    diff = max(float((a[k] - b[k]).detach().abs().max())
               for slot in ("params", "vel")
               for a, b in zip(kst[slot], cst[slot]) for k in a)
    print(f"CHECK (b) fused vs composed: loss {kloss} vs {closs}, n_err "
          f"{kerr} vs {cerr}; max abs leaf difference {diff:.3e}",
          flush=True)
    del kst, pst, cst
    split = {}
    for setting in ("fused", "composed"):
        st = clone_state(s0)
        step_split_ms(steps[setting], st, x, y, w)       # warm
        split[setting] = [step_split_ms(steps[setting], st, x, y, w)
                          for _ in range(3)]
        print(f"SPLIT {setting}: forward+loss, backward, update device ms "
              f"(3 steps, CUDA events) {split[setting]}", flush=True)
    gap = [f[1] - c[1] for f, c in zip(split["fused"], split["composed"])]
    print(f"SPLIT backward fused - composed ms (3 steps): {gap}", flush=True)
    families = profile_step(steps["fused"], clone_state(s0), x, y, w)
    del wf, steps, s0
    torch.cuda.empty_cache()
    return {"a_max_abs_err": err_a, "split": split,
            "profile_ms": families}


def near_ties(step, state, x, tau=TIE_TAU) -> bool:
    """True when the CPU forward of `x` holds a max-pool window whose two
    largest values, a ReLU input, or a row's two largest logits lie within
    tau of the layer's largest magnitude of each other (or of zero): two
    f32 implementations may decide such a max or sign differently."""
    from veles_tpu_torch.ops import functional as fn

    def pool_tie(y, ksize, stride):
        ky, kx = ksize
        sy, sx = stride
        _, h, wd, _ = y.shape
        oh, ow = fn.pool_out_hw(h, wd, ky, kx, sy, sx)
        yp = torch.nn.functional.pad(
            y, (0, 0, 0, (ow - 1) * sx + kx - wd, 0, (oh - 1) * sy + ky - h),
            value=float("-inf"))
        taps = torch.stack([yp[:, dy:dy + (oh - 1) * sy + 1:sy,
                               dx:dx + (ow - 1) * sx + 1:sx]
                            for dy in range(ky) for dx in range(kx)])
        top = taps.topk(2, dim=0).values
        gap = top[0] - top[1]
        return bool(((gap > 0) & (gap <= tau * y.abs().max())).any())

    h = torch.from_numpy(x)
    fwd = step.fwd
    with torch.inference_mode():
        for i, (kind, j, v) in enumerate(fwd._plan):
            u, p = fwd.forwards[i], state["params"][i]
            if kind == "skip":
                continue
            if kind == "pair":
                nxt = fwd.forwards[j]
                y = fn.lrn_forward(h, u.k, u.alpha, u.beta, u.n)
                if pool_tie(y, nxt.ksize, nxt.stride):
                    return True
                h = fn.maxpool_forward(y, nxt.ksize, nxt.stride)
                continue
            if getattr(u, "variant_op", None) == "maxpool" \
                    and pool_tie(h, u.ksize, u.stride):
                return True
            if getattr(u, "activation", None) == "strictrelu":
                if hasattr(u, "padding"):
                    pre = fn.conv2d_forward(h, p["weights"], p["bias"],
                                            u.stride, u.padding)
                else:
                    pre = fn.all2all_forward(h, p["weights"], p["bias"])
                if bool((pre.abs() <= tau * pre.abs().max()).any()):
                    return True
            kw = {"variant": v} if v is not None else {}
            h = u.fused_apply(p, h, train=False, **kw)
        top = h.topk(2, dim=-1).values
        return bool(((top[:, 0] - top[:, 1])
                     <= tau * h.abs().max()).any())


def toy_card_vs_cpu(dev):
    """(c) 3 train steps of the toy AlexNet on the card against the same
    steps on the CPU, from one seed, on batches without near ties."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    steps, states = {}, {}
    for d in ("cpu", dev):
        prng.seed_all(1234)
        wf = alexnet.create_workflow(**TOY_ARGS)
        for u in wf.forwards:
            if hasattr(u, "dropout_ratio"):
                u.dropout_ratio = 0.0
        wf.initialize(d)
        steps[d] = wf.build_fused_step()
        states[d] = steps[d].init_state()
    compare_states("(c) initial state", states[dev], states["cpu"], 0.0, 0.0)
    rs = np.random.RandomState(4)
    shape = (TOY_ARGS["minibatch_size"], TOY_ARGS["input_hw"],
             TOY_ARGS["input_hw"], 3)
    for i in range(3):
        for draw in range(100):
            x = rs.randn(*shape).astype(np.float32)
            y = rs.randint(0, TOY_ARGS["n_classes"], shape[0])
            w = np.ones(shape[0], np.float32)
            if not near_ties(steps["cpu"], states["cpu"], x):
                break
        else:
            raise AssertionError("(c): 100 batches in a row with near ties")
        out = {}
        for d in ("cpu", dev):
            states[d], (loss, n_err) = steps[d].train(states[d], x, y, w)
            out[d] = (float(loss), int(n_err))
        check_loss(f"(c) step {i} card vs cpu", out[dev][0], out["cpu"][0])
        if out[dev][1] != out["cpu"][1]:
            raise AssertionError(f"(c) step {i}: n_err {out[dev][1]} != "
                                 f"{out['cpu'][1]}")
        err = compare_states(f"(c) step {i} card vs cpu", states[dev],
                             states["cpu"])
        print(f"CHECK (c) toy step {i} (batch draw {draw}) card vs cpu: "
              f"loss {out[dev][0]} vs {out['cpu'][0]}, n_err {out[dev][1]} "
              f"vs {out['cpu'][1]}, max abs err over every leaf and "
              f"velocity {err:.3e}", flush=True)


@contextlib.contextmanager
def ct_config(overrides):
    """`root.char_transformer` overrides for a block, restored after it."""
    from veles_tpu_torch.config import root
    node = root.char_transformer
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


def logit_ties(step, state, x, tau=TIE_TAU) -> int:
    """Tokens of `x` whose two largest logits lie within tau of the
    largest logit magnitude of each other: there two f32 implementations
    may pick different classes."""
    with torch.inference_mode():
        out = step.fwd._forward(state["params"],
                                torch.as_tensor(x, device=step.device))
        top = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
        return int(((top[:, 0] - top[:, 1]) <= tau * out.abs().max()).sum())


def transformer_step_checks(kernels, dev, compute_dtype=None):
    """(d) one full-width char-transformer train step at seq_len 4096
    through the kernels against the same step through the plain versions,
    from one state and one batch of 32 distinct windows; then the step's
    split by CUDA events and by profiler. At compute_dtype "bfloat16",
    (d'): the same in bf16 over f32 master weights, held as (a') is."""
    bf16 = compute_dtype == "bfloat16"
    tag, label = ("(d')", "transformer bf16") if bf16 else ("(d)",
                                                            "transformer")
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.loader.text import synthetic_text
    from veles_tpu_torch.samples import char_transformer
    prng.seed_all(1234)
    mb = ATT_SHAPES[0][0]
    with ct_config({"loader.seq_len": CT_SEQ, "loader.n_validation": 1,
                    "loader.minibatch_size": mb}):
        wf = char_transformer.create_workflow(
            text=synthetic_text((mb + 1) * CT_SEQ + 1))
    wf.initialize(dev)
    loader = wf.loader
    if loader.class_lengths != [0, 1, mb]:
        raise AssertionError(f"(d) windows {loader.class_lengths}")
    step = wf.build_fused_step(compute_dtype)
    table = step.variant_table()
    if table != {"flash_attn": "kernel", "sgd_update": "kernel"}:
        raise AssertionError(f"{tag} variants {table}")
    if step.compute_dtype != compute_dtype:
        raise AssertionError(f"{tag} computes in {step.compute_dtype}")
    s0 = step.init_state()
    loader.run()
    while loader.minibatch_class != TRAIN:
        loader.run()
    x, y, w = (loader.minibatch_data, loader.minibatch_labels,
               loader.minibatch_valid)
    if len(set(loader.minibatch_indices.tolist())) != mb or not w.all():
        raise AssertionError("(d) the batch is not 32 distinct windows")

    def run(plain):
        st = clone_state(s0)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            st, (loss, n_err) = step.train(st, x, y, w)
        torch.cuda.synchronize()
        return st, float(loss), int(n_err)

    kernels.reset_launch_counts()
    kst, kloss, kerr = run(False)
    counts = kernels.launch_counts()
    if counts["flash_attention_forward"] != 1 \
            or counts["flash_attention_backward"] != 1:
        raise AssertionError(f"{tag} the kernel step launched {counts}")
    pst, ploss, perr = run(True)
    with plain_kernels(kernels):
        ties = (logit_near_ties_bf16 if bf16 else logit_ties)(step, s0, x)
    if abs(kerr - perr) > ties:
        raise AssertionError(f"{tag} n_err {kerr} != {perr} beyond the "
                             f"{ties} tied tokens")
    if bf16:
        check_loss(f"{tag} bf16 kernel vs plain transformer step", kloss,
                   ploss, BF16_U, 0.0)
        dist = update_distance(s0, kst, pst)
        check_update_distance(f"{tag} bf16 kernel vs plain transformer "
                              f"step", dist)
        print(f"CHECK {tag} full-width bf16 transformer step at S={CT_SEQ}, "
              f"kernels vs plain versions: loss {kloss} vs {ploss}, n_err "
              f"{kerr} vs {perr} ({ties} tokens with near-tied logits), "
              f"update distance relative to the update's norm {dist} "
              f"(tolerance {BF16_STEP_RTOL})", flush=True)
        out = {"d_update_distance": dist}
    else:
        check_loss("(d) kernel vs plain transformer step", kloss, ploss)
        err_d = compare_states("(d) kernel vs plain transformer step", kst,
                               pst)
        print(f"CHECK (d) full-width transformer step at S={CT_SEQ}, "
              f"kernels vs plain versions: loss {kloss} vs {ploss}, n_err "
              f"{kerr} vs {perr} ({ties} tokens with tied logits), max abs "
              f"err over every leaf and velocity {err_d:.3e} (tolerance "
              f"{TRAIN_ATOL} + {TRAIN_RTOL}*|plain|)", flush=True)
        out = {"d_max_abs_err": err_d}
    del kst, pst
    st = clone_state(s0)
    step_split_ms(step, st, x, y, w)       # warm
    split = [step_split_ms(step, st, x, y, w) for _ in range(3)]
    print(f"SPLIT {label}: forward+loss, backward, update device ms "
          f"(3 steps, CUDA events) {split}", flush=True)
    families = profile_step(step, clone_state(s0), x, y, w,
                            f"{label.replace(' ', '_')}_profile.json")
    del wf, step, s0, st
    torch.cuda.empty_cache()
    out.update({"d_loss": [kloss, ploss], "d_n_err": [kerr, perr],
                "d_tied_tokens": ties, "split": split,
                "profile_ms": families})
    return out


def toy_transformer_card_vs_cpu(kernels, dev):
    """(e) 3 train steps of the toy transformer, its flash gate forced
    on, on the card against the same steps on the CPU, from one seed, on
    batches of distinct train windows without tied logits."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import char_transformer
    steps, states, wfs = {}, {}, {}
    for d in ("cpu", dev):
        prng.seed_all(1234)
        with ct_config(CT_TOY):
            wf = char_transformer.create_workflow()
        wf.forwards[1].use_flash = "on"
        wf.initialize(d)
        steps[d] = wf.build_fused_step()
        states[d] = steps[d].init_state()
        wfs[d] = wf
    compare_states("(e) initial state", states[dev], states["cpu"], 0.0, 0.0)
    loader = wfs["cpu"].loader
    n_valid, mb = loader.class_lengths[1], loader.minibatch_size
    rs = np.random.RandomState(7)
    kernels.reset_launch_counts()
    for i in range(3):
        for draw in range(100):
            idx = n_valid + rs.choice(len(loader.data) - n_valid, mb,
                                      replace=False)
            x = loader.data[idx]
            y = loader.labels[idx].reshape(-1)
            w = np.ones(mb, np.float32)
            if logit_ties(steps["cpu"], states["cpu"], x) == 0:
                break
        else:
            raise AssertionError("(e): 100 batches in a row with tied "
                                 "logits")
        out = {}
        for d in ("cpu", dev):
            states[d], (loss, n_err) = steps[d].train(states[d], x, y, w)
            out[d] = (float(loss), int(n_err))
        check_loss(f"(e) step {i} card vs cpu", out[dev][0], out["cpu"][0])
        if out[dev][1] != out["cpu"][1]:
            raise AssertionError(f"(e) step {i}: n_err {out[dev][1]} != "
                                 f"{out['cpu'][1]}")
        err = compare_states(f"(e) step {i} card vs cpu", states[dev],
                             states["cpu"])
        print(f"CHECK (e) toy transformer step {i} (batch draw {draw}) card "
              f"vs cpu: loss {out[dev][0]} vs {out['cpu'][0]}, n_err "
              f"{out[dev][1]} vs {out['cpu'][1]}, max abs err over every "
              f"leaf and velocity {err:.3e}", flush=True)
    counts = kernels.launch_counts()
    if counts["flash_attention_forward"] != 3 \
            or counts["flash_attention_backward"] != 3:
        raise AssertionError(f"(e) the card steps launched {counts}")


# ---------------------------------------------------------------------------
# bf16 compute over f32 master weights
# ---------------------------------------------------------------------------

#: bf16's unit roundoff
BF16_U = 2.0 ** -8
#: a library call on bf16 tensors (each of its operations rounds to bf16:
#: x², the window mean, the scale, the power, the quotient) against the
#: plain version (f32 arithmetic rounded once): a few bf16 roundings
BF16_LIB_RTOL, BF16_LIB_ATOL = 2 ** -4, 2 ** -6
#: a bf16 train step against another (the kernels' against the plain
#: versions', the card's against the CPU's) from one state: the distance
#: of the two updates over every leaf (and of the velocities), relative to
#: the update's norm, within twice the unit roundoff (the argument is at
#: bf16_step_checks and toy_bf16_card_vs_cpu)
BF16_STEP_RTOL = 2 * BF16_U
BF16_ARGS = ["root.common.precision_type=bfloat16"]
#: the LRN kernels' bf16 instances, as the launch record names them
BF16_KERNELS = ("lrn_forward_bf16", "lrn_backward_bf16",
                "lrn_maxpool_forward_bf16", "lrn_maxpool_backward_bf16")


def misaligned_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 `x` again, one element into a buffer: contiguous but 2 bytes
    off 16-byte alignment, so the bf16 instances stage it element by
    element."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    start = (-(buf.data_ptr() // 2)) % 8 + 1
    xm = buf[start:start + x.numel()].view(x.shape)
    xm.copy_(x)
    if xm.data_ptr() % 16 != 2:
        raise AssertionError("misaligned_bf16: not 2 bytes off alignment")
    return xm


def bf16(rs, shape, relu=False) -> torch.Tensor:
    """A seeded normal tensor (post-ReLU where `relu`) rounded to bf16."""
    a = rs.randn(*shape)
    if relu:
        a = np.maximum(a, 0)
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def bf16_small_checks(kernels, dev):
    """The bf16 instances of K4, K2, K3 and K5 against their plain versions
    at the f32 instances' small-check shapes: the same bits, NaN exactly
    where the plain version has NaN."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    rs = np.random.RandomState(12)

    def x_of(shape, kind):
        return torch.from_numpy(small_input(rs, shape, kind)).to(
            torch.bfloat16).to(dev)

    for what, shape, ksize, stride, kind in K4_SMALL:
        x = x_of(shape, kind)
        nan = assert_same_bits(
            f"lrn_maxpool_forward_bf16 {what}",
            kernels.lrn_maxpool_forward(x, K, ALPHA, BETA, N, ksize, stride),
            kernels.lrn_maxpool_forward_plain(x, K, ALPHA, BETA, N, ksize,
                                              stride))
        print(f"K4 bf16 {what} x {list(shape)}: {nan} NaN, bit-equal",
              flush=True)
    for what, shape, n, kind in K2_SMALL:
        x = x_of(shape, kind)
        g = bf16(rs, shape).to(dev)
        nan = assert_same_bits(f"lrn_forward_bf16 {what}",
                               kernels.lrn_forward(x, K, ALPHA, BETA, n),
                               kernels.lrn_forward_plain(x, K, ALPHA, BETA,
                                                         n))
        nan_b = assert_same_bits(
            f"lrn_backward_bf16 {what}",
            kernels.lrn_backward(x, g, K, ALPHA, BETA, n),
            kernels.lrn_backward_plain(x, g, K, ALPHA, BETA, n))
        print(f"K2, K3 bf16 {what} x {list(shape)} n {n}: {nan}, {nan_b} "
              f"NaN, bit-equal", flush=True)
    for what, shape, ksize, stride, kind in K5_SMALL:
        x = x_of(shape, kind)
        oh, ow = pool_out_hw(shape[1], shape[2], *ksize, *stride)
        g = bf16(rs, (shape[0], oh, ow, shape[3])).to(dev)
        nan = assert_same_bits(
            f"lrn_maxpool_backward_bf16 {what}",
            kernels.lrn_maxpool_backward(x, g, K, ALPHA, BETA, N, ksize,
                                         stride),
            kernels.lrn_maxpool_backward_plain(x, g, K, ALPHA, BETA, N,
                                               ksize, stride))
        print(f"K5 bf16 {what} x {list(shape)}: {nan} NaN, bit-equal",
              flush=True)
    torch.cuda.synchronize()


def bf16_kernel_row(kernels, timer, name, layer, args, margs, f32_args,
                    t_bytes, t_ops, lib=None):
    """The bf16 instance of kernel `name` on `args` (x first) against its
    plain version: the same bits, also through the generic instance and
    with x 2 bytes off alignment (`margs`); then each timed on the cold
    timer beside the f32 instance on `f32_args` (the same values in f32)
    and the plain version, and `lib` (a PyTorch call on the bf16 tensors,
    held first within BF16_LIB_RTOL/ATOL of the plain version)."""
    wrap, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    hyper = (K, ALPHA, BETA, N)
    got = wrap(*args, *hyper)
    want = plain(*args, *hyper)
    others = {"generic instance": wrap(*args, *hyper, generic=True),
              "x 2 bytes off alignment": wrap(*margs, *hyper)}
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name} bf16 {layer}: returned {got.dtype}")
    assert_same_bits(f"{name}_bf16 {layer}", got, want)
    for what, other in others.items():
        assert_same_bits(f"{name}_bf16 {layer} {what}", other, want)
    lib_err = None
    if lib is not None:
        lib_err = check_close(f"{name}_bf16 {layer} library", lib()[1],
                              want.float(), BF16_LIB_RTOL, BF16_LIB_ATOL)
    row = {"shape": list(args[0].shape), "dtype": "bfloat16",
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "ms": timer(lambda: wrap(*args, *hyper)),
           "generic_ms": timer(lambda: wrap(*args, *hyper, generic=True)),
           "copy2_ms": timer(lambda: wrap(*margs, *hyper)),
           "f32_ms": timer(lambda: wrap(*f32_args, *hyper)),
           "plain_ms": timer(lambda: plain(*args, *hyper)),
           "library_ms": None if lib is None else timer(lambda: lib()[0]),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print_kernel_line(f"{name}_bf16", layer, row)
    print(f"KERNEL {name}_bf16 {layer}: bit-equal to the plain version, "
          f"also the generic instance (ms {row['generic_ms']:.4f}) and x 2 "
          f"bytes off alignment (ms {row['copy2_ms']:.4f}); the f32 "
          f"instance on the same values ms {row['f32_ms']:.4f}"
          + ("" if lib is None else f"; library max abs err against the "
             f"plain version {lib_err:.3e}"), flush=True)
    return row


def bf16_kernel_phase(kernels, dev, bw, flops):
    """The LRN kernels' bf16 instances: the small checks at bf16, then
    AlexNet's two LRN inputs at the training batch on post-ReLU inputs
    rounded to bf16, each kernel bit-equal to its plain version and timed
    beside its f32 instance, K2 and K3 beside their PyTorch calls."""
    from veles_tpu_torch.ops.functional import pool_out_hw
    bf16_small_checks(kernels, dev)
    timer = ColdTimer(dev)
    rs = np.random.RandomState(13)
    rows = {name: [] for name in BF16_KERNELS}
    for layer, (h, w, c) in zip(("L1", "L2"), LRN_SHAPES):
        shape = (TB, h, w, c)
        oh, ow = pool_out_hw(h, w, 3, 3, 2, 2)
        x = bf16(rs, shape, relu=True).to(dev)
        g = bf16(rs, shape).to(dev)
        gp = bf16(rs, (TB, oh, ow, c)).to(dev)
        xm = misaligned_bf16(x)
        x32, g32, gp32 = x.float(), g.float(), gp.float()
        nb, pb = x.numel() * 2, gp.numel() * 2   # bytes of x and of gp

        def lrn_lib():
            y = F.local_response_norm(x.permute(0, 3, 1, 2), size=N,
                                      alpha=ALPHA * N, beta=BETA, k=K)
            return y, y.permute(0, 2, 3, 1).float()

        leaf = x.clone().requires_grad_(True)
        y_lib = F.local_response_norm(leaf.permute(0, 3, 1, 2), size=N,
                                      alpha=ALPHA * N, beta=BETA, k=K)
        g_nchw = g.permute(0, 3, 1, 2)

        def grad_lib():
            dx = torch.autograd.grad(y_lib, leaf, g_nchw,
                                     retain_graph=True)[0]
            return dx, dx.float()

        rows["lrn_forward_bf16"].append(bf16_kernel_row(
            kernels, timer, "lrn_forward", layer, (x,), (xm,), (x32,),
            2 * nb / bw, lrn_ops(x.numel()) / flops, lrn_lib))
        rows["lrn_backward_bf16"].append(bf16_kernel_row(
            kernels, timer, "lrn_backward", layer, (x, g), (xm, g),
            (x32, g32), 3 * nb / bw, lrn_grad_ops(x.numel()) / flops,
            grad_lib))
        del leaf, y_lib, g_nchw
        rows["lrn_maxpool_forward_bf16"].append(bf16_kernel_row(
            kernels, timer, "lrn_maxpool_forward", layer, (x,), (xm,),
            (x32,), (nb + pb) / bw,
            (lrn_ops(x.numel()) + gp.numel() * 8) / flops))
        rows["lrn_maxpool_backward_bf16"].append(bf16_kernel_row(
            kernels, timer, "lrn_maxpool_backward", layer, (x, gp), (xm, gp),
            (x32, gp32), (2 * nb + pb) / bw,
            ((2 * N + 6 + 4) * x.numel() + lrn_grad_ops(x.numel())
             + 8 * gp.numel()) / flops))
        del x, g, gp, xm, x32, g32, gp32
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def watched_steps():
    """Every FusedTrainStep built in the block, and the dtypes its states'
    leaves and velocities hold after each train call."""
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    seen = {"steps": [], "dtypes": set()}
    init, train = FusedTrainStep.__init__, FusedTrainStep.train

    def spy_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen["steps"].append(self)

    def spy_train(self, *args, **kwargs):
        out = train(self, *args, **kwargs)
        seen["dtypes"].update(t.dtype for slot in ("params", "vel")
                              for layer in out[0][slot]
                              for t in layer.values())
        return out

    FusedTrainStep.__init__, FusedTrainStep.train = spy_init, spy_train
    try:
        yield seen
    finally:
        FusedTrainStep.__init__, FusedTrainStep.train = init, train


@contextlib.contextmanager
def precision_type_kept():
    """root.common.precision_type as it was before the block, after it
    (a CLI override sets it for the process)."""
    from veles_tpu_torch.config import root
    prev = root.common.precision_type
    try:
        yield
    finally:
        root.common.precision_type = prev


@contextlib.contextmanager
def alexnet_config_kept():
    """root.alexnet as it was before the block, after it: the CLI's
    overrides (a data_path among them) set it for the process, and the
    sample, once imported as a module, does not register its defaults
    again."""
    from veles_tpu_torch.config import root
    saved = root.alexnet.to_dict()
    try:
        yield
    finally:
        root.alexnet = saved


def check_bf16_steps(label, seen):
    """The steps of a bf16 run computed in bf16 over f32 master weights."""
    dtypes = {s.compute_dtype for s in seen["steps"]}
    if dtypes != {"bfloat16"} or seen["dtypes"] != {torch.float32}:
        raise AssertionError(f"{label}: steps in {dtypes}, leaves and "
                             f"velocities {seen['dtypes']}")
    print(f"TRAIN {label}: compute dtype bfloat16, master leaves and "
          f"velocities float32 after every step", flush=True)


def train_bf16_phase(launcher, kernels, dev):
    """Train the full-width AlexNet one epoch at
    root.common.precision_type=bfloat16 under both lrn_maxpool settings
    through `launcher.train`: the LRN kernels' bf16 instances only, the
    backward one exactly twice per train step, K1 on the f32 leaves."""
    launches = {}
    want = {"fused": ("lrn_maxpool_forward_bf16", "lrn_maxpool_backward_bf16",
                      "sgd_update"),
            "composed": ("lrn_forward_bf16", "lrn_backward_bf16",
                         "sgd_update")}
    for setting in ("fused", "composed"):
        label = f"bf16 {setting}"
        with precision_type_kept(), watched_steps() as seen:
            wf, counts = train_run(
                launcher, kernels, dev, label,
                [ALEXNET, "--fused", "-r", "1234", "--lrn-maxpool", setting,
                 "root.alexnet.decision.max_epochs=1", *BF16_ARGS,
                 *TRAIN_ARGS])
        check_bf16_steps(label, seen)
        launches[setting] = counts
        for name, c in counts.items():
            if name in want[setting] and c <= 0:
                raise AssertionError(f"{name} never launched in {label}")
            if name not in want[setting] and c != 0:
                raise AssertionError(f"{name} launched {c} times in {label}")
        backward = want[setting][1]
        steps = wf.decision.epoch_number * -(-wf.loader.class_lengths[2]
                                             // wf.loader.minibatch_size)
        if counts[backward] != 2 * steps:
            raise AssertionError(f"{backward} launched {counts[backward]} "
                                 f"times in {steps} train steps in {label}, "
                                 f"not twice each")
        print(f"TRAIN {label}: {backward} twice in each of {steps} train "
              f"steps; no f32 LRN instance launched", flush=True)
        del wf
        torch.cuda.empty_cache()
    return launches


def transformer_bf16_phase(launcher, kernels, dev):
    """One epoch of the char-transformer at seq_len 4096 at
    root.common.precision_type=bfloat16: K6 and K7 in f32 behind the
    attention function's casts, with transformer_run's exact counts."""
    with precision_type_kept(), watched_steps() as seen:
        counts = transformer_run(launcher, kernels, dev, "transformer bf16",
                                 BF16_ARGS, 1)
    check_bf16_steps("transformer bf16", seen)
    return counts


def update_distance(before, a, b):
    """{slot: ||(b - before) - (a - before)|| / ||b - before||} over every
    leaf of the params and of the velocities: how far step a's update lies
    from step b's, relative to b's (states on any device)."""
    out = {}
    for slot in ("params", "vel"):
        num = den = 0.0
        for l0, la, lb in zip(before[slot], a[slot], b[slot]):
            for k in l0:
                t0 = l0[k].detach().double().cpu()
                da = la[k].detach().double().cpu() - t0
                db = lb[k].detach().double().cpu() - t0
                num += float(((da - db) ** 2).sum())
                den += float((db ** 2).sum())
        out[slot] = (num / den) ** 0.5
    return out


def check_update_distance(what, dist):
    if max(dist.values()) > BF16_STEP_RTOL:
        raise AssertionError(f"{what}: update distance {dist} beyond "
                             f"{BF16_STEP_RTOL}")


def bf16_step_checks(kernels, variants, dev):
    """(a') the first full-width bf16 train step through the kernels
    against the same step through the plain versions, from one state and
    batch; then its SPLIT and profile beside the f32 step's.

    The gate: K2-K5's bf16 instances give their plain versions' bits and
    cuDNN's and cuBLAS's forward sums are the same in both runs, so the
    forward and each pooling window's routing are the same; the backward
    may differ where cuDNN's or cuBLAS's bf16 gradient sums (f32 partial
    sums, one rounding) are taken in another order, one bf16 ulp of a
    gradient element at most, carried linearly: within u of the update's
    norm. The update distance is held within 2u (BF16_STEP_RTOL), the loss
    within u, n_err exactly."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    wf.initialize(dev)
    steps = {}
    for setting in ("fused", "composed"):
        variants.select("lrn_maxpool", setting)
        steps[setting] = wf.build_fused_step(compute_dtype="bfloat16")
    variants.clear_selection("lrn_maxpool")
    s0 = steps["fused"].init_state()
    rs = np.random.RandomState(3)
    mb, shape = wf.loader.minibatch_size, wf.loader.sample_shape
    x = rs.randn(mb, *shape).astype(np.float32)
    y = rs.randint(0, wf.n_classes, mb)
    w = np.ones(mb, np.float32)

    def run(setting, plain=False):
        st = clone_state(s0)
        steps[setting].gen = prng.get().torch_generator(dev)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            st, (loss, n_err) = steps[setting].train(st, x, y, w)
        torch.cuda.synchronize()
        return st, float(loss), int(n_err)

    kernels.reset_launch_counts()
    kst, kloss, kerr = run("fused")
    counts = kernels.launch_counts()
    pst, ploss, perr = run("fused", plain=True)
    if counts["lrn_maxpool_backward_bf16"] != 2:
        raise AssertionError(f"(a') the bf16 step launched {counts}")
    check_loss("(a') bf16 kernel vs plain step", kloss, ploss, BF16_U, 0.0)
    if kerr != perr:
        raise AssertionError(f"(a') n_err {kerr} != {perr}")
    dist = update_distance(s0, kst, pst)
    check_update_distance("(a') bf16 kernel vs plain step", dist)
    print(f"CHECK (a') first full-width bf16 train step, kernels vs plain "
          f"versions: loss {kloss} vs {ploss}, n_err {kerr} vs {perr}, "
          f"update distance relative to the update's norm {dist} "
          f"(tolerance {BF16_STEP_RTOL})", flush=True)
    del kst, pst
    split = {}
    for setting in ("fused", "composed"):
        st = clone_state(s0)
        step_split_ms(steps[setting], st, x, y, w)       # warm
        split[setting] = [step_split_ms(steps[setting], st, x, y, w)
                          for _ in range(3)]
        print(f"SPLIT bf16 {setting}: forward+loss, backward, update device "
              f"ms (3 steps, CUDA events) {split[setting]}", flush=True)
    families = profile_step(steps["fused"], clone_state(s0), x, y, w,
                            "train_bf16_profile.json")
    del wf, steps, s0
    torch.cuda.empty_cache()
    return {"a_update_distance": dist, "split": split,
            "profile_ms": families}


def state_on(state, dev):
    """A copy of `state` on `dev`, its leaves trainable."""
    return {"params": tuple({k: t.detach().to(dev, copy=True)
                             .requires_grad_(True) for k, t in layer.items()}
                            for layer in state["params"]),
            "vel": tuple({k: t.detach().to(dev, copy=True)
                          for k, t in layer.items()}
                         for layer in state["vel"]),
            "lr_scale": state["lr_scale"]}


def logit_near_ties_bf16(step, state, x) -> int:
    """Rows (tokens) of `x` whose two largest bf16 logits (the step's
    forward) lie within two bf16 ulps of each other: there a one-ulp
    difference in a logit may move the argmax, and n_err with it."""
    out = step.fwd._forward(state["params"],
                            torch.as_tensor(x, device=step.device))
    top = out.reshape(-1, out.shape[-1]).topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
    return int(((top[:, 0] - top[:, 1]) <= 2 * ulp).sum())


def toy_bf16_card_vs_cpu(dev):
    """(c') 3 bf16 train steps of the toy AlexNet on the card against the
    same steps on the CPU, from one seed, the card's state copied from the
    CPU's before each step (so no difference compounds).

    The gate: both compute every bf16 product and convolution with f32
    sums rounded once, so they differ where the two libraries' summation
    orders move a value across a bf16 rounding tie, one ulp; in bf16 such
    a value may sit at a pooling window's or a ReLU's tie and move a
    gradient there. Measured against the JAX package on the CPU, that
    leaves the update 3.1e-3 to 4.7e-3 of its norm apart
    (tests/test_torch_bf16.py), so the update distance is held within 2u
    (BF16_STEP_RTOL), the loss within u, and n_err but for rows whose two
    largest logits lie within two bf16 ulps."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    steps, states = {}, {}
    for d in ("cpu", dev):
        prng.seed_all(1234)
        wf = alexnet.create_workflow(**TOY_ARGS)
        for u in wf.forwards:
            if hasattr(u, "dropout_ratio"):
                u.dropout_ratio = 0.0
        wf.initialize(d)
        steps[d] = wf.build_fused_step(compute_dtype="bfloat16")
        states[d] = steps[d].init_state()
    compare_states("(c') initial state", states[dev], states["cpu"], 0.0, 0.0)
    rs = np.random.RandomState(4)
    shape = (TOY_ARGS["minibatch_size"], TOY_ARGS["input_hw"],
             TOY_ARGS["input_hw"], 3)
    dists = []
    for i in range(3):
        x = rs.randn(*shape).astype(np.float32)
        y = rs.randint(0, TOY_ARGS["n_classes"], shape[0])
        w = np.ones(shape[0], np.float32)
        before = state_on(states["cpu"], "cpu")
        states[dev] = state_on(states["cpu"], dev)
        ties = logit_near_ties_bf16(steps["cpu"], states["cpu"], x)
        out = {}
        for d in ("cpu", dev):
            states[d], (loss, n_err) = steps[d].train(states[d], x, y, w)
            out[d] = (float(loss), int(n_err))
        check_loss(f"(c') step {i} card vs cpu", out[dev][0], out["cpu"][0],
                   BF16_U, 0.0)
        if abs(out[dev][1] - out["cpu"][1]) > ties:
            raise AssertionError(f"(c') step {i}: n_err {out[dev][1]} != "
                                 f"{out['cpu'][1]} ({ties} logit ties)")
        dist = update_distance(before, states[dev], states["cpu"])
        check_update_distance(f"(c') step {i} card vs cpu", dist)
        dists.append(dist)
        print(f"CHECK (c') toy bf16 step {i} card vs cpu: loss "
              f"{out[dev][0]} vs {out['cpu'][0]}, n_err {out[dev][1]} vs "
              f"{out['cpu'][1]} ({ties} rows with logit near ties), update "
              f"distance relative to the update's norm {dist} (tolerance "
              f"{BF16_STEP_RTOL})", flush=True)
    return dists


# ---------------------------------------------------------------------------
# FEED: the device feed on the full-width bf16 AlexNet
# ---------------------------------------------------------------------------

#: the FEED phase's packed set: FEED_VALID validation and FEED_TRAIN train
#: images of 227x227x3 uint8, made from --seed by quantizing FEED_PROTOS
#: class prototypes plus noise, with a mean image (~218 MB)
FEED_TRAIN, FEED_VALID, FEED_PROTOS = 1280, 128, 64
FEED_EPOCHS = 2
#: feed_ahead of each wire's runs, in turns
FEED_TURNS = (1, 0, 0, 1)
#: the FEED phase's wires: (label, float wire pinned, memmap)
FEED_WIRES = (("memmap uint8", False, True), ("memmap f32", True, True),
              ("synthetic f32", True, False))
#: the uint8 wire against the f32 wire on the head weights: the JAX
#: package's test tolerance (tests/test_device_feed.py:249-259)
WIRE_RTOL, WIRE_ATOL = 1e-4, 1e-5
#: the overlap profile's window: train steps of the second epoch
FEED_PROFILE_FROM, FEED_PROFILE_STEPS = 11, 8
#: the queued upload after that window: a spin kernel of this many SM
#: cycles (about 20 ms at an H100's 1.98 GHz, longer at lower clocks) on
#: the compute stream, then one batch-sized uint8 upload
FEED_SPIN_CYCLES = 40_000_000


def pack_feed_data(out_dir: str, seed: int) -> str:
    """FEED's packed set, made from `seed` with numpy in chunks."""
    from veles_tpu_torch.loader import memmap as mm
    rs = np.random.RandomState(seed)
    shape = (HW, HW, 3)
    n = FEED_VALID + FEED_TRAIN
    protos = np.clip(127.5 + 48.0 * rs.randn(FEED_PROTOS, *shape), 0,
                     255).astype(np.int16)
    labels = rs.randint(0, FEED_PROTOS, n).astype(np.int64)
    data = np.empty((n,) + shape, np.uint8)
    acc = np.zeros(shape, np.float64)
    for lo in range(0, n, TB):
        hi = min(lo + TB, n)
        noise = rs.randint(-24, 25, (hi - lo,) + shape).astype(np.int16)
        data[lo:hi] = np.clip(protos[labels[lo:hi]] + noise, 0, 255)
        acc += data[lo:hi].sum(axis=0, dtype=np.float64)
    mean = (acc / n / 127.5 - 1.0).astype(np.float32)
    return mm.pack_arrays(out_dir, data, labels, [0, FEED_VALID, FEED_TRAIN],
                          shard_mb=64.0, mean_image=mean)


def feed_argv(data_dir, memmap: bool, ahead: int, seed: int):
    argv = [ALEXNET, "--fused", "-r", str(seed), "--lrn-maxpool", "fused",
            "--feed-ahead", str(ahead),
            f"root.alexnet.decision.max_epochs={FEED_EPOCHS}", *BF16_ARGS]
    if memmap:
        return argv + [f"root.alexnet.loader.data_path={data_dir}"]
    return argv + [f"root.alexnet.loader.n_train={FEED_TRAIN}",
                   f"root.alexnet.loader.n_validation={FEED_VALID}"]


@contextlib.contextmanager
def float_wire(pinned: bool):
    """run_fused with uint8_wire=False (the f32 wire) in the block."""
    if not pinned:
        yield
        return
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    inner = StandardWorkflow.run_fused

    def run_fused(self, *args, **kwargs):
        kwargs["uint8_wire"] = False
        return inner(self, *args, **kwargs)

    StandardWorkflow.run_fused = run_fused
    try:
        yield
    finally:
        StandardWorkflow.run_fused = inner


@contextlib.contextmanager
def train_calls(hooks):
    """Call hooks[i] = (before, after) around the i-th
    FusedTrainStep.train call of the block (0-based)."""
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    inner = FusedTrainStep.train
    calls = [0]

    def train(self, *args, **kwargs):
        i = calls[0]
        calls[0] += 1
        before, after = hooks.get(i, (None, None))
        if before is not None:
            before()
        out = inner(self, *args, **kwargs)
        if after is not None:
            after()
        return out

    FusedTrainStep.train = train
    try:
        yield calls
    finally:
        FusedTrainStep.train = inner


def trained_state(wf):
    """Every parameter and velocity the run wrote back, cloned on the
    card."""
    out = []
    for u in wf.forwards:
        out += [t.detach().clone() for t in u.param_arrays().values()]
    for g in wf.gds:
        out += [getattr(g, a).detach().clone()
                for a in sorted(vars(g)) if a.startswith("vel_")
                and isinstance(getattr(g, a), torch.Tensor)]
    return out


def feed_run(launcher, kernels, dev, label, argv, pinned_float, ahead):
    """One FEED run: 2 epochs through `launcher.train(argv)`, counts
    zeroed just before and read just after, CUDA events around each step,
    and the host clock over the second epoch's train pass (synchronized
    at both ends). Checks the feed (pinned slots, a copy stream other
    than the default one, one upload per batch, the lookahead) and the
    launches; returns a record."""
    from veles_tpu_torch.loader.device_feed import PinnedStreamPut
    steps = FEED_TRAIN // TB
    clock = {}

    def mark(key):
        def at():
            torch.cuda.synchronize()
            clock[key] = time.perf_counter()
        return at

    hooks = {steps: (mark("t0"), None), 2 * steps - 1: (None, mark("t1"))}
    with precision_type_kept(), float_wire(pinned_float), \
            timed_steps() as events, train_calls(hooks):
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
    torch.cuda.synchronize()
    st = wf.feed_stats
    put = wf.device_feed.put
    host_s = clock["t1"] - clock["t0"]
    step_ms = [s.elapsed_time(e) for kind, s, e in events if kind == "train"]
    rec = {"label": label, "ahead": ahead,
           "host_ms_per_step": host_s / steps * 1e3,
           "samples_per_s": steps * TB / host_s,
           "train_step_ms_events": step_ms,
           "steady_step_ms_events": float(np.median(step_ms[steps:])),
           "loss": wf.evaluator.loss, "history": wf.decision.history,
           "pinned_buffers": put.pool.allocated,
           "gather": getattr(wf.loader, "gather_used", None),
           "launches": counts,
           **{k: st[k] for k in ("batches", "bytes_per_batch", "uint8_wire",
                                 "loader_block_s", "put_block_s",
                                 "device_sync_s", "on_demand")}}
    print(f"FEED {label} feed_ahead={ahead}: host ms "
          f"per steady train step {rec['host_ms_per_step']:.3f}, train "
          f"samples/s {rec['samples_per_s']:.1f}; train step device ms "
          f"(CUDA events, upload not included) median "
          f"{rec['steady_step_ms_events']:.3f} of "
          + ", ".join(f"{ms:.3f}" for ms in step_ms)
          + f"; loader_block_s {st['loader_block_s']}, put_block_s "
          f"{st['put_block_s']}, device_sync_s {st['device_sync_s']}, "
          f"on_demand {st['on_demand']}, bytes_per_batch "
          f"{st['bytes_per_batch']}, gather {rec['gather']}, pinned "
          f"buffers {put.pool.allocated}; loss {rec['loss']}", flush=True)
    if wf.device != dev or not np.isfinite(rec["loss"]):
        raise AssertionError(f"FEED {label}: on {wf.device}, loss "
                             f"{rec['loss']}")
    if wf.decision.epoch_number != FEED_EPOCHS:
        raise AssertionError(f"FEED {label}: {wf.decision.epoch_number} "
                             f"epochs")
    if not isinstance(put, PinnedStreamPut) or not put.pinned():
        raise AssertionError(f"FEED {label}: the upload is {put!r}, not "
                             f"from pinned slots")
    if put.stream.cuda_stream == torch.cuda.default_stream(dev).cuda_stream:
        raise AssertionError(f"FEED {label}: copies on the default stream")
    if put.uploads != st["batches"] or st["ahead"] != ahead:
        raise AssertionError(f"FEED {label}: {put.uploads} uploads of "
                             f"{st['batches']} batches, ahead {st['ahead']}")
    # x gathered straight into the pool's pinned buffers: only y and w
    # (a few hundred bytes each) are copied on the host
    if put.host_copies != 2 * st["batches"]:
        raise AssertionError(f"FEED {label}: {put.host_copies} host copies "
                             f"into pinned buffers for {st['batches']} "
                             f"batches, not 2 each (y, w)")
    if st["on_demand"] != (1 if ahead else st["batches"]):
        raise AssertionError(f"FEED {label}: {st['on_demand']} batches "
                             f"produced on demand at feed_ahead={ahead}")
    want = ("lrn_maxpool_forward_bf16", "lrn_maxpool_backward_bf16",
            "sgd_update")
    for name, c in counts.items():
        if (name in want) != (c > 0):
            raise AssertionError(f"FEED {label}: {name} launched {c} times")
    if counts["lrn_maxpool_backward_bf16"] != 2 * steps * FEED_EPOCHS:
        raise AssertionError(
            f"FEED {label}: lrn_maxpool_backward_bf16 launched "
            f"{counts['lrn_maxpool_backward_bf16']} times in "
            f"{steps * FEED_EPOCHS} train steps, not twice each")
    state = trained_state(wf)
    head = wf.forwards[-1].weights.detach().clone()
    del wf
    torch.cuda.empty_cache()
    return rec, state, head


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def feed_profile(data_dir: str, seed: int) -> dict:
    """Run wire (a) at feed_ahead=1 under torch.profiler over
    FEED_PROFILE_STEPS train steps of the second epoch, in a child process
    (only a process's first profiler session records memcpys here), and
    read the HtoD copies' streams and overlap with the step's kernels;
    then, in the same session, queued_upload's copy against the spin
    kernel queued before it."""
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--feed-profile",
         data_dir, "--seed", str(seed)], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("FEEDPROFILE ")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"the FEED profile child failed "
                             f"({r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    prof = json.loads(lines[-1][len("FEEDPROFILE "):])
    s = prof["summary"]
    print(f"FEED profile (memmap uint8, feed_ahead=1, "
          f"{FEED_PROFILE_STEPS} steady train steps; "
          f"chiprun_out/feed_profile.json): {s['batch_copies']} batch "
          f"copies, {s['batch_overlap_share']:.3f} of their time under the "
          f"step's kernels; " + json.dumps(
              {k: v for k, v in s.items() if k != "batch_copy_rows"}),
          flush=True)
    if not s["batch_copies"]:
        raise AssertionError("FEED profile: no HtoD copy of a batch")
    if s["batch_copies_on_compute_stream"] or not s["batch_copies_pinned"]:
        raise AssertionError(f"FEED profile: batch copies not all pinned "
                             f"and on a side stream: {s}")
    if s["batch_copies_that_waited_for_compute"] \
            or s["batch_copies_without_issue_record"]:
        raise AssertionError(f"FEED profile: a batch copy waited for the "
                             f"compute stream's queued work: {s}")
    # the loop's copies can overlap only the compute work queued when
    # they are issued: none is where the host fell behind the card
    if s["batch_copies_issued_with_work_pending"] \
            and not s["batch_overlap_ms"] > 0:
        raise AssertionError(f"FEED profile: no batch copy overlaps a "
                             f"kernel of the step: {s}")
    q = s["queued_upload"]
    print(f"FEED queued upload (a {q and q['spin_ms']} ms spin kernel "
          f"on the compute stream, then one batch upload): "
          + json.dumps(q), flush=True)
    if q is None or q["copy"] is None:
        raise AssertionError(f"FEED profile: no spin kernel or no copy of "
                             f"the queued upload: {q}")
    if "Pinned" not in q["copy"] or q["stream"] == q["spin_stream"] \
            or not q["overlap_ms"] > 0 \
            or not q["start_after_spin_start_ms"] < q["spin_ms"]:
        raise AssertionError(f"FEED profile: the upload issued behind a "
                             f"queued spin kernel did not run under it "
                             f"from a pinned buffer on a side stream: {q}")
    return s


def feed_overlap(events):
    """(summary, GPU events) of a chrome trace's batch copies: their
    streams, whether pinned, their overlap with the compute stream's
    kernels, and whether any waited for compute work queued before it
    was issued. A copy is on its stream once its runtime call returns
    (on an H100 it began within a few microseconds of that, 15-30 us
    after the call began: each row's `issue_call_ms` and
    `start_after_issue_ms`): compute work that ended before then was not
    pending when the copy was queued, and a copy that began after that
    work did not wait for it. queued_upload's copy and spin kernel are
    read apart (queued_copy), under "queued_upload"."""
    gpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # the runtime call that issued each kernel and copy
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    # queued_upload's events (from its spin kernel's launch on, the card
    # drained before it) are read apart from the training loop's
    spins = [e for e in gpu if e["cat"] == "kernel"
             and "spin_kernel" in e["name"]]
    upload = None
    if spins:
        spin = spins[-1]
        call = calls.get(spin["args"].get("correlation"))
        cut = min(spin["ts"], call["ts"] if call is not None
                  else spin["ts"])
        tail = [e for e in gpu if e["ts"] >= cut]
        gpu = [e for e in gpu if e["ts"] < cut]
        upload = queued_copy(spin, tail)
    issued = {c: e["ts"] for c, e in calls.items()}
    kern = [e for e in gpu if e["cat"] == "kernel"]
    streams: dict = {}
    for e in kern:
        s = e["args"].get("stream")
        streams[s] = streams.get(s, 0) + 1
    compute = max(streams, key=streams.get)
    on_compute = [e for e in kern if e["args"].get("stream") == compute]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in on_compute]
    htod = [e for e in gpu if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    # the image tensor's copy: the batch's largest by far
    big = max((e.get("args", {}).get("bytes", 0) for e in htod), default=0)
    batch = [e for e in htod if e.get("args", {}).get("bytes", 0)
             >= max(big // 2, 1)] if big else htod
    rows = []
    for e in batch:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        ov = sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans)
        call = calls.get(e["args"].get("correlation"))
        at = None if call is None else call["ts"]
        queued = None if call is None else call["ts"] + call.get("dur", 0)

        def pending_at(t):
            # compute-stream work issued before the copy's call and not
            # done at t
            return [k["ts"] + k["dur"] for k in on_compute
                    if issued.get(k["args"].get("correlation"), at) < at
                    and k["ts"] + k["dur"] > t] if call is not None else []

        # a copy that waited for the work pending when it was queued
        # began after that work ended
        pending = pending_at(queued)
        rows.append({"name": e["name"], "stream": e["args"].get("stream"),
                     "bytes": e["args"].get("bytes"), "ms": e["dur"] / 1e3,
                     "overlap_ms": ov / 1e3, "issued": call is not None,
                     # the runtime call's own time; when the copy began,
                     # and when the work pending at its queueing ended,
                     # each after the call's start
                     "issue_call_ms": (queued - at) / 1e3
                     if call is not None else None,
                     "start_after_issue_ms": (t0 - at) / 1e3
                     if call is not None else None,
                     "pending_end_after_issue_ms":
                     (max(pending) - at) / 1e3 if pending else None,
                     "pending_at_call_start": len(pending_at(at)),
                     "pending_at_issue": len(pending),
                     "waited_for_compute": bool(pending)
                     and t0 >= max(pending)})
    summary = {
        "compute_stream": compute, "kernel_streams": streams,
        "htod_copies": len(htod),
        "htod_streams": sorted({e["args"].get("stream") for e in htod}),
        "batch_copies": len(rows),
        "batch_copies_on_compute_stream": sum(r["stream"] == compute
                                              for r in rows),
        "batch_copies_pinned": all("Pinned" in r["name"] for r in rows),
        "batch_copies_issued_with_work_pending": sum(
            r["pending_at_issue"] > 0 for r in rows),
        "batch_copies_that_waited_for_compute": sum(
            r["waited_for_compute"] for r in rows),
        "batch_copies_without_issue_record": sum(not r["issued"]
                                                 for r in rows),
        "batch_copy_ms": sum(r["ms"] for r in rows),
        "batch_overlap_ms": sum(r["overlap_ms"] for r in rows),
        "batch_copy_rows": rows,
        "kernel_ms": sum(b - a for a, b in spans) / 1e3}
    summary["batch_overlap_share"] = (summary["batch_overlap_ms"]
                                      / max(summary["batch_copy_ms"], 1e-9))
    # the range of each copy's start after its runtime call returned, and
    # of the calls' own times
    after = [r["start_after_issue_ms"] - r["issue_call_ms"] for r in rows
             if r["issued"]]
    call_ms = [r["issue_call_ms"] for r in rows if r["issued"]]
    summary["copy_start_after_call_return_ms"] = \
        [min(after), max(after)] if after else None
    summary["copy_call_ms"] = [min(call_ms), max(call_ms)] if call_ms \
        else None
    summary["queued_upload"] = upload
    return summary, gpu


def queued_copy(spin, tail) -> dict:
    """queued_upload's batch copy against the spin kernel queued before
    it: its stream, whether pinned, when it began after the spin began,
    and how much of it ran under the spin."""
    a, b = spin["ts"], spin["ts"] + spin["dur"]
    htod = [e for e in tail if e["cat"] == "gpu_memcpy"
            and "HtoD" in e["name"]]
    if not htod:
        return {"spin_ms": (b - a) / 1e3, "copy": None}
    e = max(htod, key=lambda e: e.get("args", {}).get("bytes", 0))
    t0, t1 = e["ts"], e["ts"] + e["dur"]
    return {"spin_ms": (b - a) / 1e3,
            "spin_stream": spin["args"].get("stream"),
            "copy": e["name"], "stream": e["args"].get("stream"),
            "bytes": e["args"].get("bytes"), "ms": e["dur"] / 1e3,
            "start_after_spin_start_ms": (t0 - a) / 1e3,
            "overlap_ms": max(0.0, min(t1, b) - max(t0, a)) / 1e3}


def queued_upload(dev) -> None:
    """After the training loop's window: the card drained, one
    batch-sized uint8 upload through a fresh `PinnedStreamPut`, issued
    right behind a spin kernel of FEED_SPIN_CYCLES on the compute stream.
    Whether the loop's own copies find compute work queued depends on
    the host keeping ahead of the card; this one always does, so its
    copy runs under the spin unless the upload waits for the compute
    stream (feed_overlap reads it)."""
    from veles_tpu_torch.loader.device_feed import PinnedStreamPut
    torch.cuda.synchronize()
    put = PinnedStreamPut(dev)
    x = put.empty((TB, HW, HW, 3), np.uint8)
    x.fill(1)
    torch.cuda._sleep(FEED_SPIN_CYCLES)
    put((x,))
    torch.cuda.synchronize()


def feed_profile_main(data_dir: str, seed: int) -> int:
    """The child of feed_profile: one profiled run, its summary printed on
    a FEEDPROFILE line."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, REPO)
    from veles_tpu_torch import launcher
    from veles_tpu_torch.ops import kernels
    kernels.build()
    # CUDA activity only (kernels, copies and the runtime calls that
    # issued them): recording every CPU op slows the host enough to leave
    # the card idle between steps, with nothing queued to overlap
    prof = profile(activities=[ProfilerActivity.CUDA])

    def stop():
        queued_upload(torch.device("cuda", torch.cuda.current_device()))
        prof.stop()

    last = FEED_PROFILE_FROM + FEED_PROFILE_STEPS - 1
    with precision_type_kept(), \
            train_calls({FEED_PROFILE_FROM: (prof.start, None),
                         last: (None, stop)}):
        launcher.train(feed_argv(data_dir, True, 1, seed))
    os.makedirs(OUT, exist_ok=True)
    tmp = os.path.join(OUT, "feed_trace.tmp.json")
    prof.export_chrome_trace(tmp)
    with open(tmp) as f:
        trace = json.load(f)
    os.remove(tmp)
    summary, gpu = feed_overlap(trace["traceEvents"])
    with open(os.path.join(OUT, "feed_profile.json"), "w") as f:
        json.dump({"summary": summary, "gpu_events": gpu}, f)
    print("FEEDPROFILE " + json.dumps({"summary": summary}), flush=True)
    return 0


def feed_phase(launcher, kernels, dev, seed: int, data_dir: str):
    """FEED: the full-width AlexNet, batch 128, bf16 over f32 master
    weights, lrn_maxpool fused, 2 epochs per run through
    `launcher.train`: (a) the uint8 wire from a packed memmap (packed
    into `data_dir`, which the caller deletes), (b) the f32 wire from the
    same memmap, (c) the synthetic loader's f32 wire, each at feed_ahead
    1, 0, 0, 1. Returns (launches of each wire's first run, the
    records)."""
    from veles_tpu_torch import native_gather
    shutil.rmtree(data_dir, ignore_errors=True)
    t0 = time.perf_counter()
    pack_feed_data(data_dir, seed)
    print(f"FEED packed {FEED_VALID} + {FEED_TRAIN} images of "
          f"{HW}x{HW}x3 uint8 in {time.perf_counter() - t0:.2f} s; "
          f"native gather {native_gather.available()} "
          f"({native_gather.last_error or native_gather.library_path()})",
          flush=True)
    if not native_gather.available():
        raise AssertionError("the native gather did not build: "
                             f"{native_gather.last_error}")
    x_bytes = TB * HW * HW * 3
    records, launches, states, heads = [], {}, {}, {}
    for label, pinned_float, memmap in FEED_WIRES:
        for turn, ahead in enumerate(FEED_TURNS):
            rec, state, head = feed_run(
                launcher, kernels, dev, label,
                feed_argv(data_dir, memmap, ahead, seed), pinned_float,
                ahead)
            records.append(rec)
            want = x_bytes * (1 if not pinned_float else 4) + TB * 12
            if rec["bytes_per_batch"] != want or \
                    rec["uint8_wire"] != (not pinned_float):
                raise AssertionError(
                    f"FEED {label}: {rec['bytes_per_batch']} bytes a "
                    f"batch (uint8 {rec['uint8_wire']}), not {want}")
            if memmap and rec["gather"] != "native":
                raise AssertionError(f"FEED {label}: the {rec['gather']}"
                                     f" gather ran, not the native one")
            metrics = (rec["loss"], rec["history"])
            if turn == 0:
                launches[label] = rec["launches"]
                states[label], heads[label] = state, head
                first = metrics
            else:
                rec["same_bits_as_first"] = (
                    metrics == first and same_bits(state, states[label]))
            del state, head
        same = [r["same_bits_as_first"] for r in records[-3:]]
        print(f"FEED {label}: turns {FEED_TURNS} give the same bits as "
              f"the first: {same}", flush=True)
        if not all(same):
            raise AssertionError(f"FEED {label}: feed_ahead 1 and 0 "
                                 f"give different bits")
    a, b = heads["memmap uint8"], heads["memmap f32"]
    err = float((a - b).abs().max())
    print(f"FEED uint8 wire against f32 wire: head weights max abs "
          f"difference {err} (tolerance {WIRE_ATOL} + {WIRE_RTOL}"
          f"*|f32|)", flush=True)
    if not torch.allclose(a, b, rtol=WIRE_RTOL, atol=WIRE_ATOL):
        raise AssertionError("FEED: the uint8 wire does not track the "
                             "f32 wire")
    del states, heads, a, b
    torch.cuda.empty_cache()
    profile = feed_profile(data_dir, seed)
    return launches, {"runs": records, "profile": profile,
                      "head_max_abs_diff": err}


#: RESUME: the FEED phase's packed memmap; full-width AlexNet, bf16 over f32
#: master weights, fused, batch 128, the sample's dropout, feed_ahead 1,
#: RESUME_EPOCHS epochs of 10 train + 1 validation steps, (a)'s cut run
#: RESUME_CUT of them; the snapshot settings a workflow file adds
#: (keep_last 2; (a)'s runs uncompressed, codec none, to save the time of
#: their gzip exports; (b)'s supervised run the Snapshotter's default gz,
#: so that the default codec is exported and restored at full width and
#: the time to recover stays one series) and the fault the supervised
#: run takes
RESUME_EPOCHS, RESUME_CUT, RESUME_KEEP, RESUME_FAULT = \
    3, 2, 2, "kill@epoch=2"
#: the workflow file RESUME writes: the AlexNet sample's workflow rebuilt
#: with snapshot_config (the sample has none, as the JAX sample has
#: none); a restored run trains on to root.alexnet.decision.max_epochs.
#: With root.resume.marks set, it prints RESUMEMARK lines of the host
#: clock: at each closed epoch, and in a restored run where the module
#: was imported (the interpreter and torch up), where load() returned
#: (the snapshot imported) and after its first train step
#: (synchronized).
RESUME_WORKFLOW = '''
import time

IMPORTED = time.time()

from veles_tpu_torch.config import root
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.resume.snapshot_dir = "."
root.resume.compression = ""
root.resume.marks = 0


def create_workflow():
    wf = alexnet.create_workflow()
    return StandardWorkflow(
        layers=wf.layers_config, loader=wf.loader, loss=wf.loss,
        n_classes=wf.n_classes,
        decision_config=root.alexnet.decision.to_dict(),
        gd_config=root.alexnet.gd.to_dict(),
        snapshot_config={"directory": root.resume.snapshot_dir,
                         "prefix": "alexnet",
                         "compression": root.resume.compression,
                         "keep_last": %d},
        name="AlexNetWorkflow")


def marks(wf, restored, loaded):
    import torch
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    from veles_tpu_torch.resilience import hooks
    hooks.add_epoch_hook(lambda e: print(f"RESUMEMARK epoch {e} "
                                         f"{time.time()!r}", flush=True))
    if restored:
        print(f"RESUMEMARK imported {IMPORTED!r}", flush=True)
        print(f"RESUMEMARK restored {loaded!r} {wf.decision.epoch_number}",
              flush=True)
        inner = FusedTrainStep.train

        def train(self, *args, **kwargs):
            out = inner(self, *args, **kwargs)
            FusedTrainStep.train = inner
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            print(f"RESUMEMARK first_step {time.time()!r}", flush=True)
            return out

        FusedTrainStep.train = train


def run(load, main):
    wf, restored = load(create_workflow)
    loaded = time.time()
    if restored:
        wf.decision.max_epochs = root.alexnet.decision.max_epochs
        wf.decision.complete = False
    if root.resume.marks:
        marks(wf, restored, loaded)
    main()
''' % RESUME_KEEP


def resume_argv(wf_file, data_dir, snap_dir, epochs, seed):
    return [wf_file, "--fused", "-r", str(seed), "--lrn-maxpool", "fused",
            "--feed-ahead", "1",
            f"root.alexnet.loader.data_path={data_dir}",
            f"root.alexnet.decision.max_epochs={epochs}",
            f"root.resume.snapshot_dir={snap_dir}", *BF16_ARGS, *TRAIN_ARGS]


def trained_line(wf) -> str:
    """The CLI's TRAINED line for `wf` (launcher.main prints it)."""
    dec = wf.decision
    return (f"TRAINED {dec.epoch_number} epochs: loss {wf.evaluator.loss} "
            f"best_err {dec.best_validation_err} history {dec.history}")


@contextlib.contextmanager
def snapshot_clock():
    """Host seconds of every Snapshotter.export and import_ in the block,
    and of moving a restored workflow to the card (StandardWorkflow.place
    of a restored workflow)."""
    from veles_tpu_torch.snapshotter import Snapshotter
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    seen = {"export": [], "import": [], "place": []}
    export, import_, place = (Snapshotter.export, Snapshotter.import_,
                              StandardWorkflow.place)

    def timed_export(self):
        t0 = time.perf_counter()
        path = export(self)
        seen["export"].append((time.perf_counter() - t0,
                               os.path.getsize(path)))
        return path

    def timed_import(path, restore_prng=True):
        t0 = time.perf_counter()
        wf = import_(path, restore_prng)
        seen["import"].append((time.perf_counter() - t0,
                               os.path.getsize(path)))
        return wf

    def timed_place(self, device=None):
        restored = self.restored and not self.is_initialized
        t0 = time.perf_counter()
        place(self, device)
        if restored:
            torch.cuda.synchronize()
            seen["place"].append(time.perf_counter() - t0)

    Snapshotter.export = timed_export
    Snapshotter.import_ = staticmethod(timed_import)
    StandardWorkflow.place = timed_place
    try:
        yield seen
    finally:
        Snapshotter.export, StandardWorkflow.place = export, place
        Snapshotter.import_ = staticmethod(import_)


def resume_run(launcher, kernels, label, argv, epochs):
    """One RESUME run through `launcher.train(argv)`, which trains
    `epochs` epochs: counts zeroed just before and read just after, CUDA
    events around each step, the host clock over the last epoch's train
    pass (synchronized at both ends), the snapshot clock. Returns
    (workflow, record)."""
    steps = FEED_TRAIN // TB
    clock = {}

    def mark(key):
        def at():
            torch.cuda.synchronize()
            clock[key] = time.perf_counter()
        return at

    last = (epochs - 1) * steps
    hooks = {last: (mark("t0"), None),
             last + steps - 1: (None, mark("t1"))}
    with precision_type_kept(), snapshot_clock() as snaps, \
            timed_steps() as events, train_calls(hooks) as calls:
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
    torch.cuda.synchronize()
    kinds = [kind for kind, _, _ in events]
    rec = {"label": label, "launches": counts,
           "train_steps": kinds.count("train"),
           "eval_steps": kinds.count("evaluate"),
           "exports": snaps["export"], "imports": snaps["import"],
           "place_s": snaps["place"], "line": trained_line(wf)}
    if "t1" in clock:
        rec["host_ms_per_step"] = (clock["t1"] - clock["t0"]) / steps * 1e3
    print(f"RESUME {label}: {calls[0]} train steps, "
          f"{rec['eval_steps']} validation steps; host ms per train step "
          f"over the last epoch's train pass "
          f"{rec.get('host_ms_per_step', float('nan')):.3f}; snapshot "
          f"exports (s, bytes) {snaps['export']}; imports (s, bytes) "
          f"{snaps['import']}; restored workflow to the card "
          f"{snaps['place']} s; {rec['line']}", flush=True)
    return wf, rec


def check_resumed_launches(rec):
    """The resumed run's launches: K1 16, K4 and K5 bf16 twice a train
    step (K4 also twice a validation step), nothing else."""
    train, ev = rec["train_steps"], rec["eval_steps"]
    want = {"sgd_update": 16 * train,
            "lrn_maxpool_forward_bf16": 2 * (train + ev),
            "lrn_maxpool_backward_bf16": 2 * train}
    got = {name: c for name, c in rec["launches"].items() if c}
    if got != want or not train:
        raise AssertionError(f"RESUME {rec['label']}: launches {got} in "
                             f"{train} train and {ev} validation steps, "
                             f"not {want}")
    print(f"RESUME {rec['label']}: launches {got}: K1 16, K4 2 and K5 2 "
          f"a train step", flush=True)


def supervised_resume(argv, snap_dir, work):
    """RESUME (b): `--fused --supervise` of `argv` in a child process
    under RESUME_FAULT. Returns (stdout, stderr, report, seconds)."""
    report = os.path.join(work, "supervise_report.json")
    env = dict(os.environ, PYTHONPATH=REPO, VELES_FAULT_PLAN=RESUME_FAULT)
    env.pop("VELES_FAULT_STATE", None)
    cmd = [sys.executable, "-m", "veles_tpu_torch", *argv, "--supervise",
           "--snapshot-dir", snap_dir, "--snapshot-prefix", "alexnet",
           "--supervise-report", report, "root.resume.marks=1",
           "root.resume.compression=gz"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or not os.path.exists(report):
        raise AssertionError(f"RESUME (b): the supervisor exited "
                             f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-5000:]}")
    with open(report) as f:
        return r.stdout, r.stderr, json.load(f), wall


def resume_serve(launcher, kernels, dev, wf_file, snap):
    """RESUME (c): `--serve 0 -s SNAP` answers a 1-row /predict; its
    softmax against the restored workflow's forward on the card, on the
    same 64-row ring. Returns (launches, max abs difference)."""
    from veles_tpu_torch.backends import full_f32
    from veles_tpu_torch.snapshotter import Snapshotter
    x = np.random.RandomState(5).randn(1, HW, HW, 3).round(3)
    srv = launcher.serve([wf_file, "--serve", "0", "-s", snap,
                          "--lrn-maxpool", "fused", "--serve-ring",
                          str(B), "--serve-max-body", str(1 << 30),
                          *SERVE_ARGS])
    try:
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        status, resp, dt = post(f"http://127.0.0.1:{srv.port}", x)
        counts = kernels.launch_counts()
    finally:
        srv.stop()
    if status != 200:
        raise AssertionError(f"RESUME (c): /predict answered {status}")
    got = np.asarray(resp["outputs"], np.float64)
    wf = Snapshotter.import_(snap, restore_prng=False)
    wf.place(dev)
    fwd = wf.build_forward()
    ring = np.zeros((B, HW, HW, 3), np.float32)
    ring[0] = x[0]
    with torch.inference_mode(), full_f32(dev):
        want = torch.softmax(fwd._forward(
            fwd.params(), torch.from_numpy(ring).to(dev)), dim=-1)
    want = want[:1].double().cpu().numpy()
    err = float(np.abs(got - want).max())
    print(f"RESUME (c) --serve 0 -s {os.path.basename(snap)}: 1 row -> "
          f"200 in {dt * 1e3:.1f} ms, softmax max abs difference from the "
          f"restored workflow's forward on the card {err:.3e} (tolerance "
          f"{SERVE_ATOL}); launches {counts}", flush=True)
    if got.shape != (1, N_CLASSES) or not err <= SERVE_ATOL:
        raise AssertionError(f"RESUME (c): outputs {got.shape}, max abs "
                             f"difference {err}")
    if {k: c for k, c in counts.items() if c} != {"lrn_maxpool_forward": 2}:
        raise AssertionError(f"RESUME (c): launches {counts}, not K4 "
                             f"twice (one ring round)")
    del wf, fwd
    return counts, err


def resume_phase(launcher, kernels, dev, seed: int, data_dir: str,
                 keep_dir=None):
    """RESUME on the FEED phase's packed memmap: (a) in process, an
    uninterrupted run of RESUME_EPOCHS epochs against a run cut after
    RESUME_CUT epochs and restored from its newest snapshot, taken after
    train steps (the same bits in params,
    velocities, history, best_validation_err, the epoch counter, the
    loss); (b) through the CLI, `--fused --supervise` under RESUME_FAULT
    against (a)'s uninterrupted run, and the time to recover; (c) `--serve
    0 -s SNAPSHOT` against the restored workflow's forward. With
    `keep_dir`, (a)'s newest snapshot moves there. Returns (launches by
    path, the record)."""
    work = tempfile.mkdtemp(prefix="veles_resume_")
    with alexnet_config_kept():
        try:
            out = resume_runs(launcher, kernels, dev, seed, data_dir, work)
            if keep_dir is not None:
                # (a)'s newest cut snapshot and its sidecar, for SERVE
                # WIRES' watcher
                from veles_tpu_torch.snapshotter import Snapshotter
                snap = Snapshotter.latest(os.path.join(work, "cut"),
                                          prefix="alexnet")
                for p in (snap, snap + ".sha256"):
                    shutil.move(p, keep_dir)
            return out
        finally:
            shutil.rmtree(work, ignore_errors=True)


def resume_runs(launcher, kernels, dev, seed, data_dir, work):
    """resume_phase's runs, in the temporary directory `work`."""
    from veles_tpu_torch.snapshotter import Snapshotter
    wf_file = os.path.join(work, "alexnet_snapshots.py")
    with open(wf_file, "w") as f:
        f.write(RESUME_WORKFLOW)
    dirs = {k: os.path.join(work, k) for k in ("whole", "cut", "sup")}
    # (a) the uninterrupted run
    whole, rec_whole = resume_run(
        launcher, kernels, "(a) uninterrupted",
        resume_argv(wf_file, data_dir, dirs["whole"], RESUME_EPOCHS,
                    seed), RESUME_EPOCHS)
    want, want_line = trained_state(whole), rec_whole["line"]
    want_meta = (whole.decision.history, whole.decision.epoch_number,
                 whole.decision.best_validation_err,
                 whole.evaluator.loss)
    del whole
    torch.cuda.empty_cache()
    # (a) the same argv at RESUME_CUT epochs, then resumed from its newest
    # snapshot: epoch RESUME_CUT's validation pass, after the train steps
    # of the epochs before it
    cut, rec_cut = resume_run(
        launcher, kernels, f"(a) {RESUME_CUT} epochs",
        resume_argv(wf_file, data_dir, dirs["cut"], RESUME_CUT, seed),
        RESUME_CUT)
    del cut
    snap = Snapshotter.latest(dirs["cut"], prefix="alexnet")
    if snap is None or not Snapshotter.verify(snap) \
            or not os.path.exists(snap + ".sha256"):
        raise AssertionError(f"RESUME (a): no verified snapshot in "
                             f"{os.listdir(dirs['cut'])}")
    resumed, rec = resume_run(
        launcher, kernels, "(a) resumed",
        resume_argv(wf_file, data_dir, dirs["cut"], RESUME_EPOCHS,
                    seed) + ["-s", snap], RESUME_EPOCHS - RESUME_CUT + 1)
    # the snapshot held epoch RESUME_CUT - 1's counter: the resumed run
    # trained the epochs from there, not from the seed's weights
    want_steps = (RESUME_EPOCHS - RESUME_CUT + 1) * (FEED_TRAIN // TB)
    if rec["train_steps"] != want_steps:
        raise AssertionError(f"RESUME (a): the resumed run trained "
                             f"{rec['train_steps']} steps, not "
                             f"{want_steps}: {os.path.basename(snap)} is "
                             f"not the snapshot taken after train steps")
    got = trained_state(resumed)
    got_meta = (resumed.decision.history, resumed.decision.epoch_number,
                resumed.decision.best_validation_err,
                resumed.evaluator.loss)
    if resumed.device != dev:
        raise AssertionError(f"RESUME (a): resumed on {resumed.device}")
    same = same_bits(got, want) and got_meta == want_meta
    print(f"RESUME (a) resumed from {os.path.basename(snap)} "
          f"({os.path.getsize(snap)} bytes, sidecar verified) against "
          f"the uninterrupted run: the same bits in {len(got)} "
          f"parameters and velocities, history, best_validation_err, "
          f"epoch counter and loss: {same}", flush=True)
    if not same:
        raise AssertionError(f"RESUME (a): the resumed run differs: "
                             f"{got_meta} against {want_meta}")
    check_resumed_launches(rec)
    del resumed, got, want
    torch.cuda.empty_cache()
    # (b) through the CLI, under the supervisor
    out, err, report, wall = supervised_resume(
        resume_argv(wf_file, data_dir, dirs["sup"], RESUME_EPOCHS,
                    seed), dirs["sup"], work)
    attempts = report["attempts"]
    lines = [ln for ln in out.splitlines() if ln.startswith("TRAINED")]
    marks = {}
    for ln in out.splitlines():
        if ln.startswith("RESUMEMARK "):
            m = ln.split()
            key = f"{m[1]} {m[2]}" if m[1] == "epoch" else m[1]
            marks.setdefault(key, m[2:] if m[1] != "epoch" else m[3:])
    t = {k: float(v[0]) for k, v in marks.items()}
    # the first "epoch 2" mark is the killed child's, just before the
    # kill; the others are the restarted child's
    recover = (t["first_step"] - t["epoch 2"]
               if {"first_step", "epoch 2"} <= set(t) else None)
    split = ({"kill_to_imported": t["imported"] - t["epoch 2"],
              "snapshot_import": t["restored"] - t["imported"],
              "restored_to_first_step": t["first_step"]
              - t["restored"]} if recover is not None
             and {"imported", "restored"} <= set(t) else None)
    print(f"RESUME (b) --fused --supervise under {RESUME_FAULT}: exit "
          f"0 in {wall:.2f} s; attempts "
          + "; ".join(f"{a['attempt']}: {a['reason']} {a['exit_codes']}"
                      f" at epoch {a['epoch_reached']} from "
                      f"{os.path.basename(a['snapshot'] or '<fresh>')}"
                      for a in attempts)
          + f" (its epoch counter "
          f"{marks.get('restored', [None, None])[1]}); time to "
          f"recover (the kill to the restarted child's first step, "
          f"host clock) {recover} s: {split}", flush=True)
    print(f"RESUME (b) {lines[-1] if lines else '<no TRAINED line>'}",
          flush=True)
    # kill@epoch=2 fires in the Decision's epoch hook, before the loop's
    # snapshot branch: the restart resumes from the snapshot of epoch 2's
    # validation pass, which holds epoch 1's counter
    if len(attempts) != 2 or attempts[0]["exit_codes"] != [-9] \
            or attempts[0]["epoch_reached"] != 2 \
            or not attempts[1]["snapshot"] \
            or marks.get("restored", [None, None])[1] != "1" \
            or attempts[1]["reason"] != "ok" or recover is None:
        raise AssertionError(f"RESUME (b): attempts {attempts}, "
                             f"marks {marks}:\n{err[-3000:]}")
    if lines[-1:] != [want_line]:
        raise AssertionError(f"RESUME (b): {lines[-1:]} is not the "
                             f"uninterrupted run's {want_line}")
    # (c) serve the resumed run's newest snapshot
    serve_counts, serve_err = resume_serve(
        launcher, kernels, dev, wf_file,
        Snapshotter.latest(dirs["cut"], prefix="alexnet"))
    record = {"uninterrupted": rec_whole, "cut": rec_cut,
              "resumed": rec, "snapshot_bytes": os.path.getsize(snap),
              "supervised": {"attempts": attempts, "wall_s": wall,
                             "recover_s": recover,
                             "recover_split_s": split,
                             "restored_epoch": marks.get(
                                 "restored", [None, None])[1],
                             "line": lines[-1]},
              "serve_max_abs_err": serve_err}
    return {"resume": rec["launches"],
            "resume_serve": serve_counts}, record


# ---------------------------------------------------------------------------
# the rest of the local fused step: gradient accumulation, Adam,
# train_repeat / train_many and the state checkpoint
# ---------------------------------------------------------------------------

#: ACCUM: one update of ACCUM_BATCH rows (5 of them pad rows) as ACCUM_K
#: microbatches against one update of the same rows; the CLI epoch's K
ACCUM_BATCH, ACCUM_K, ACCUM_CLI_K, ACCUM_PAD = 1024, 8, 4, 5
#: ADAM: the lr of the Adam runs, the CLI run's train steps, and the bound
#: on elements that the kernels' step and the plain versions' step move
#: in opposite directions (Adam moves every element by about ±lr at its
#: first step, so a gradient near zero whose sign two cuDNN summation
#: orders give differently moves 2·lr apart: about one in a million of
#: the 62,378,344 parameters)
ADAM_LR, ADAM_STEPS, ADAM_FLIP_MAX = 1e-4, 3, 64
#: REPEAT: train_repeat's k on one resident batch; train_many's batches
REPEAT_K, MANY_K = 20, 4
#: the kernels of the full-width bf16 step, as the launch record names
#: them: K4's and K5's bf16 instances and K1
K4_BF16, K5_BF16, K1 = ("lrn_maxpool_forward_bf16",
                        "lrn_maxpool_backward_bf16", "sgd_update")
#: AlexNet's parameter leaves, each one K1 launch per SGD update
N_LEAVES = len(LEAVES)


def full_width_step(dev, optimizer="sgd", dropout=None):
    """The full-width AlexNet from seed 1234 and its fused step in bf16
    over f32 master weights, lrn_maxpool fused: `optimizer` on every
    gradient twin (Adam at ADAM_LR), dropout at the sample's ratio unless
    `dropout` is given."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import variants
    from veles_tpu_torch.samples import alexnet
    variants.select("lrn_maxpool", "fused")
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    for u in wf.forwards:
        if dropout is not None and hasattr(u, "dropout_ratio"):
            u.dropout_ratio = dropout
    for g in wf.gds:
        g.optimizer = optimizer
        if optimizer == "adam":
            g.learning_rate = ADAM_LR
    wf.initialize(dev)
    return wf, wf.build_fused_step(compute_dtype="bfloat16")


def card_batch(dev, n, seed, pad=0):
    """n rows of AlexNet's input, labels and pad mask (the last `pad`
    rows 0), drawn on the card from `seed`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, HW, HW, 3), generator=gen, device=dev)
    y = torch.randint(0, N_CLASSES, (n,), generator=gen, device=dev)
    w = torch.ones(n, device=dev)
    if pad:
        w[-pad:] = 0.0
    return x, y, w


def copy_state(state):
    """A copy of a fused state on its device (SGD velocities, or Adam's
    moments and t), its leaves trainable."""
    from veles_tpu_torch.ops.optim import is_adam_state

    def vel(layer):
        if is_adam_state(layer):
            return {"m": {k: t.clone() for k, t in layer["m"].items()},
                    "v": {k: t.clone() for k, t in layer["v"].items()},
                    "t": layer["t"].clone()}
        return {k: t.clone() for k, t in layer.items()}
    return {"params": tuple({k: t.detach().clone().requires_grad_(True)
                             for k, t in layer.items()}
                            for layer in state["params"]),
            "vel": tuple(vel(layer) for layer in state["vel"]),
            "lr_scale": state["lr_scale"]}


def state_tensors(state):
    """Every tensor of a fused state, in a fixed order."""
    from veles_tpu_torch.ops.optim import is_adam_state
    out = []
    for layer in state["params"]:
        out += [t.detach() for t in layer.values()]
    for layer in state["vel"]:
        if is_adam_state(layer):
            out += list(layer["m"].values()) + list(layer["v"].values())
            out.append(layer["t"])
        else:
            out += list(layer.values())
    return out


def check_counts(what, counts, want):
    """Each kernel of `want` launched exactly that often, every other
    kernel never."""
    bad = {k: c for k, c in counts.items() if c != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {bad}, want {want} and no "
                             f"other kernel")


@contextlib.contextmanager
def last_train_state():
    """The step and the state of the block's last FusedTrainStep.train
    call: {"step", "state"}."""
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    inner, last = FusedTrainStep.train, {}

    def train(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        last["step"], last["state"] = self, out[0]
        return out

    FusedTrainStep.train = train
    try:
        yield last
    finally:
        FusedTrainStep.train = inner


def accum_checks(kernels, dev, seed):
    """ACCUM (a)-(c): one train_accum(k=ACCUM_K) of ACCUM_BATCH rows
    against one train of the same rows, from one state, dropout 0: the
    update distance within BF16_STEP_RTOL of the update's norm and the
    loss within BF16_U, as (a') holds a bf16 step (both take the same
    rows through the same kernels, bit-equal to their plain versions;
    cuDNN's and cuBLAS's bf16 sums over 128 rows and over 1024 differ in
    order, and the microbatch gradients are added in f32); the peak device
    memory of each call, the accumulated one's below the full one's; the
    exact launches."""
    wf, step = full_width_step(dev, dropout=0.0)
    s0 = step.init_state()
    x, y, w = card_batch(dev, ACCUM_BATCH, seed, pad=ACCUM_PAD)

    def run(accum):
        st = copy_state(s0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if accum:
            st, (loss, n_err) = step.train_accum(st, x, y, ACCUM_K, w)
        else:
            st, (loss, n_err) = step.train(st, x, y, w)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        return st, {"loss": float(loss), "n_err": int(n_err),
                    "peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "resident_bytes": before, "s": secs}, counts

    ast, arec, acounts = run(True)
    fst, frec, fcounts = run(False)
    for label, rec in (("accumulated", arec), ("full batch", frec)):
        above = rec["peak_bytes"] - rec["resident_bytes"]
        print(f"ACCUM (b) {label}: peak device memory "
              f"{rec['peak_bytes']} bytes ({above} above the "
              f"{rec['resident_bytes']} resident before the call); loss "
              f"{rec['loss']}, n_err {rec['n_err']}, {rec['s']:.3f} s of "
              f"host time", flush=True)
    if not arec["peak_bytes"] < frec["peak_bytes"]:
        raise AssertionError("ACCUM (b): the accumulated update's peak "
                             "memory is not below the full batch's")
    check_counts("ACCUM (c) accumulated", acounts,
                 {K4_BF16: 2 * ACCUM_K, K5_BF16: 2 * ACCUM_K,
                  K1: N_LEAVES})
    check_counts("ACCUM (c) full batch", fcounts,
                 {K4_BF16: 2, K5_BF16: 2, K1: N_LEAVES})
    check_loss("ACCUM (a) accumulated vs full batch", arec["loss"],
               frec["loss"], BF16_U, 0.0)
    dist = update_distance(s0, ast, fst)
    check_update_distance("ACCUM (a) accumulated vs full batch", dist)
    print(f"ACCUM (a) train_accum(k={ACCUM_K}) of {ACCUM_BATCH} rows "
          f"({ACCUM_PAD} pad) against train of the same rows: update "
          f"distance relative to the update's norm {dist} (tolerance "
          f"{BF16_STEP_RTOL}), loss within {BF16_U}; (c) launches "
          f"accumulated {acounts[K4_BF16]}/{acounts[K5_BF16]}/"
          f"{acounts[K1]} (K4/K5/K1), full batch {fcounts[K4_BF16]}/"
          f"{fcounts[K5_BF16]}/{fcounts[K1]}", flush=True)
    del wf, step, s0, ast, fst, x, y, w
    torch.cuda.empty_cache()
    return acounts, {"accumulated": arec, "full": frec,
                     "update_distance": dist}


def accum_epoch(launcher, kernels, dev, seed, data_dir):
    """ACCUM (d): one epoch through `launcher.train` with --accum
    ACCUM_CLI_K on FEED's packed uint8 memmap: exact launches per train
    minibatch (K1 once per leaf, K4 and K5 twice per microbatch) and per
    validation batch (K4 twice)."""
    argv = feed_argv(data_dir, True, 1, seed) + [
        "root.alexnet.decision.max_epochs=1", "--accum", str(ACCUM_CLI_K)]
    with precision_type_kept(), alexnet_config_kept():
        wf, counts = train_run(launcher, kernels, dev,
                               f"accum {ACCUM_CLI_K} memmap", argv)
    steps, val = FEED_TRAIN // TB, -(-FEED_VALID // TB)
    if wf.decision.epoch_number != 1:
        raise AssertionError(f"ACCUM (d): {wf.decision.epoch_number} "
                             f"epochs")
    check_counts("ACCUM (d)", counts,
                 {K1: N_LEAVES * steps,
                  K5_BF16: 2 * ACCUM_CLI_K * steps,
                  K4_BF16: 2 * ACCUM_CLI_K * steps + 2 * val})
    print(f"ACCUM (d) --accum {ACCUM_CLI_K}: {steps} train minibatches of "
          f"{TB} as {ACCUM_CLI_K} microbatches and {val} validation batch; "
          f"K1 {N_LEAVES} and K5 {2 * ACCUM_CLI_K} per train minibatch, "
          f"K4 {2 * ACCUM_CLI_K} per train minibatch and 2 per validation "
          f"batch; loss {wf.evaluator.loss}", flush=True)
    rec = {"loss": wf.evaluator.loss, "history": wf.decision.history}
    del wf
    torch.cuda.empty_cache()
    return counts, rec


def adam_distance(before, a, b):
    """{"params", "m", "v"}: ||Δa − Δb|| / ||Δb|| over every leaf, of the
    parameters' updates from `before` and of the moments (zero before);
    and the count of parameter elements the two moved in opposite
    directions."""
    sums = {s: [0.0, 0.0] for s in ("params", "m", "v")}
    flips = 0
    for l0, la, lb, va, vb in zip(before["params"], a["params"],
                                  b["params"], a["vel"], b["vel"]):
        for k in l0:
            t0 = l0[k].detach().double()
            da = la[k].detach().double() - t0
            db = lb[k].detach().double() - t0
            flips += int(((da * db) < 0).sum())
            pairs = (("params", da, db),
                     ("m", va["m"][k].double(), vb["m"][k].double()),
                     ("v", va["v"][k].double(), vb["v"][k].double()))
            for slot, x, y in pairs:
                sums[slot][0] += float(((x - y) ** 2).sum())
                sums[slot][1] += float((y ** 2).sum())
    return {s: (n / d) ** 0.5 for s, (n, d) in sums.items()}, flips


def adam_checks(kernels, dev, seed):
    """ADAM (a): the first full-width Adam step in bf16 through the
    kernels against the same step through the plain versions, from one
    state, batch and dropout stream: the update distance of the
    parameters and of both moments within BF16_STEP_RTOL, the loss within
    BF16_U, the sign flips counted and at most ADAM_FLIP_MAX; the
    kernels' launches exact (no K1: every layer is Adam)."""
    from veles_tpu_torch import prng
    wf, step = full_width_step(dev, "adam")
    if "sgd_update" in step.variant_table():
        raise AssertionError("ADAM (a): an all-Adam step reports an SGD "
                             "update")
    s0 = step.init_state()
    x, y, w = card_batch(dev, TB, seed + 1)

    def run(plain):
        st = copy_state(s0)
        step.gen = prng.get().torch_generator(dev)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            st, (loss, n_err) = step.train(st, x, y, w)
        torch.cuda.synchronize()
        return st, float(loss), int(n_err)

    kernels.reset_launch_counts()
    kst, kloss, kerr = run(False)
    counts = kernels.launch_counts()
    pst, ploss, perr = run(True)
    check_counts("ADAM (a)", counts, {K4_BF16: 2, K5_BF16: 2})
    check_loss("ADAM (a) kernels vs plain", kloss, ploss, BF16_U, 0.0)
    dist, flips = adam_distance(s0, kst, pst)
    check_update_distance("ADAM (a) kernels vs plain", dist)
    ts = {int(v["t"]) for v, p in zip(kst["vel"], kst["params"]) if p}
    print(f"ADAM (a) first full-width Adam step (lr {ADAM_LR}), kernels "
          f"vs plain versions: loss {kloss} vs {ploss}, n_err {kerr} vs "
          f"{perr}, update distance relative to the update's norm "
          f"(params, m, v) {dist} (tolerance {BF16_STEP_RTOL}); elements "
          f"moved in opposite directions {flips} (at most "
          f"{ADAM_FLIP_MAX}); t {ts}; launches K4 {counts[K4_BF16]}, K5 "
          f"{counts[K5_BF16]}, K1 {counts[K1]}", flush=True)
    if flips > ADAM_FLIP_MAX or ts != {1}:
        raise AssertionError(f"ADAM (a): {flips} sign flips, t {ts}")
    del wf, step, s0, kst, pst
    torch.cuda.empty_cache()
    return counts, {"update_distance": dist, "sign_flips": flips,
                    "loss": [kloss, ploss]}


def adam_cli(launcher, kernels, dev, seed):
    """ADAM (b): ADAM_STEPS train steps and one validation batch through
    `launcher.train` with root.alexnet.gd.optimizer=adam: no K1, K5 twice
    per train step, K4 twice per train or validation step, `t` the train
    steps in every layer with parameters (0 in the others). Returns the
    launches, the record, and the run's step and trained state."""
    argv = [ALEXNET, "--fused", "-r", str(seed), "--lrn-maxpool", "fused",
            "root.alexnet.gd.optimizer=adam",
            f"root.alexnet.gd.learning_rate={ADAM_LR}",
            f"root.alexnet.loader.n_train={ADAM_STEPS * TB}",
            f"root.alexnet.loader.n_validation={TB}",
            "root.alexnet.decision.max_epochs=1", *BF16_ARGS]
    with precision_type_kept(), alexnet_config_kept(), \
            last_train_state() as last:
        wf, counts = train_run(launcher, kernels, dev, "adam", argv)
    step, state = last["step"], last["state"]
    check_counts("ADAM (b)", counts, {K5_BF16: 2 * ADAM_STEPS,
                                      K4_BF16: 2 * ADAM_STEPS + 2})
    ts = [int(v["t"]) for v in state["vel"]]
    want = [ADAM_STEPS if p else 0 for p in state["params"]]
    from veles_tpu_torch.ops.optim import is_adam_state
    if ts != want or not all(is_adam_state(v) for v in state["vel"]):
        raise AssertionError(f"ADAM (b): t {ts}, want {want}")
    print(f"ADAM (b) {ADAM_STEPS} train steps through the CLI with "
          f"root.alexnet.gd.optimizer=adam: t {ts}; launches K1 "
          f"{counts[K1]}, K5 {counts[K5_BF16]}, K4 {counts[K4_BF16]}; "
          f"loss {wf.evaluator.loss}", flush=True)
    return counts, {"t": ts, "loss": wf.evaluator.loss}, step, state


def ckpt_phase(dev, step, state, seed):
    """CKPT: (a) save_state of ADAM (b)'s full-width Adam state into a
    temporary directory, its bytes and the save and restore seconds; (b)
    the restored tensors the saved bits, and the next step from the
    restored state the next step's bits from the saved one (dropout at
    the sample's ratio: the stream's position rides in the file); (c) a
    step of the toy AlexNet refuses the checkpoint with
    CheckpointGeometryError."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.parallel import checkpoint
    from veles_tpu_torch.samples import alexnet
    work = tempfile.mkdtemp(prefix="veles_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_state(state, work)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = checkpoint.restore_state(step, work)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n = sum(t.numel() for layer in state["params"]
                for t in layer.values())
        same = same_bits(state_tensors(restored), state_tensors(state))
        print(f"CKPT (a) save_state of the full-width Adam state ({n} "
              f"parameters, as many m and v, t {ADAM_STEPS}): {nbytes} "
              f"bytes in {save_s:.3f} s; restore_state {restore_s:.3f} s; "
              f"(b) the restored tensors the saved bits: {same}",
              flush=True)
        if not same:
            raise AssertionError("CKPT (b): the restored state differs")
        del restored
        x, y, w = card_batch(dev, TB, seed + 2)
        want, (wloss, werr) = step.train(state, x, y, w)
        again = checkpoint.restore_state(step, work)   # the stream too
        got, (gloss, gerr) = step.train(again, x, y, w)
        torch.cuda.synchronize()
        same = (same_bits(state_tensors(got), state_tensors(want))
                and float(gloss) == float(wloss) and int(gerr) == int(werr))
        print(f"CKPT (b) the next step from the restored state against the "
              f"next step from the saved one: the same bits in every "
              f"leaf, moment, t and the loss ({float(gloss)}): {same}",
              flush=True)
        if not same:
            raise AssertionError("CKPT (b): the restored state trains "
                                 "differently")
        del want, got, again
        prng.seed_all(1234)
        toy = alexnet.create_workflow(**TOY_ARGS)
        toy.initialize(dev)
        try:
            checkpoint.restore_state(toy.build_fused_step(), work)
        except checkpoint.CheckpointGeometryError as e:
            mismatches = e.mismatches
        else:
            raise AssertionError("CKPT (c): the toy AlexNet loaded the "
                                 "full-width checkpoint")
        if not mismatches:
            raise AssertionError("CKPT (c): no mismatches named")
        print(f"CKPT (c) the toy AlexNet's step refuses it: "
              f"CheckpointGeometryError with {len(mismatches)} mismatched "
              f"leaves, e.g. {mismatches[0]!r}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "parameters": n, "toy_mismatches": len(mismatches)}


def repeat_checks(kernels, dev, seed):
    """REPEAT: train_repeat(k=REPEAT_K) on one resident batch against
    REPEAT_K train calls on it, and train_many over MANY_K stacked
    batches against MANY_K train calls, from one state at dropout 0: the
    same bits in every leaf, velocity, loss and n_err; the host ms per
    step of each (synchronized at both ends; information, no gate); the
    exact launches of the train_repeat and train_many calls."""
    wf, step = full_width_step(dev, dropout=0.0)
    s0 = step.init_state()
    x, y, w = card_batch(dev, TB, seed + 3)
    step.train(copy_state(s0), x, y, w)                      # warm

    def timed(fn):
        st = copy_state(s0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, (losses, errs) = fn(st)
        torch.cuda.synchronize()
        return st, losses, errs, time.perf_counter() - t0, \
            kernels.launch_counts()

    def loop(batches):
        def run(st):
            losses, errs = [], []
            for xb, yb, wb in batches:
                st, (loss, err) = step.train(st, xb, yb, wb)
                losses.append(loss)
                errs.append(err)
            return st, (torch.stack(losses), torch.stack(errs))
        return run

    rec, counts = {}, {}
    lst, ll, le, lsec, _ = timed(loop([(x, y, w)] * REPEAT_K))
    rst, rl, re_, rsec, counts["repeat"] = timed(
        lambda st: step.train_repeat(st, x, y, REPEAT_K, w))
    same = (same_bits(state_tensors(rst), state_tensors(lst))
            and torch.equal(rl, ll) and torch.equal(re_, le))
    rec["repeat"] = {"same_bits": same, "loop_ms_per_step":
                     lsec * 1e3 / REPEAT_K, "repeat_ms_per_step":
                     rsec * 1e3 / REPEAT_K}
    print(f"REPEAT train_repeat(k={REPEAT_K}) on one resident batch of "
          f"{TB} against {REPEAT_K} train calls: the same bits in every "
          f"leaf, velocity, loss and n_err: {same}; host ms per step "
          f"{rec['repeat']['repeat_ms_per_step']:.3f} (train_repeat) and "
          f"{rec['repeat']['loop_ms_per_step']:.3f} (train loop); "
          f"launches {counts['repeat'][K4_BF16]}/{counts['repeat'][K5_BF16]}"
          f"/{counts['repeat'][K1]} (K4/K5/K1)", flush=True)
    del lst, rst
    batches = [card_batch(dev, TB, seed + 4 + i) for i in range(MANY_K)]
    xs, ys, ws = (torch.stack(t) for t in zip(*batches))
    lst, ll, le, lsec, _ = timed(loop(batches))
    mst, ml, me, msec, counts["many"] = timed(
        lambda st: step.train_many(st, xs, ys, ws))
    same_many = (same_bits(state_tensors(mst), state_tensors(lst))
                 and torch.equal(ml, ll) and torch.equal(me, le))
    rec["many"] = {"same_bits": same_many, "loop_ms_per_step":
                   lsec * 1e3 / MANY_K, "many_ms_per_step":
                   msec * 1e3 / MANY_K}
    print(f"REPEAT train_many over {MANY_K} stacked batches against "
          f"{MANY_K} train calls: the same bits: {same_many}; host ms per "
          f"step {rec['many']['many_ms_per_step']:.3f} (train_many) and "
          f"{rec['many']['loop_ms_per_step']:.3f} (train loop); launches "
          f"{counts['many'][K4_BF16]}/{counts['many'][K5_BF16]}/"
          f"{counts['many'][K1]} (K4/K5/K1)", flush=True)
    if not (same and same_many):
        raise AssertionError("REPEAT: train_repeat or train_many differs "
                             "from the train loop")
    for label, k in (("repeat", REPEAT_K), ("many", MANY_K)):
        check_counts(f"REPEAT {label}", counts[label],
                     {K4_BF16: 2 * k, K5_BF16: 2 * k, K1: N_LEAVES * k})
    del wf, step, s0, lst, mst, xs, ys, ws, batches
    torch.cuda.empty_cache()
    return counts, rec


def local_step_phase(launcher, kernels, dev, seed, data_dir):
    """ACCUM, ADAM, REPEAT and CKPT at full width (227x227x3, fc 4096,
    1000 classes, bf16 over f32 master weights, lrn_maxpool fused); each
    run's counters zeroed just before it and read just after. Returns
    (launches by path, the record)."""
    launches, rec, secs = {}, {}, {}
    with alexnet_config_kept():
        t0 = time.perf_counter()
        launches["accum"], rec["accum"] = accum_checks(kernels, dev, seed)
        launches["accum_cli"], rec["accum_cli"] = accum_epoch(
            launcher, kernels, dev, seed, data_dir)
        secs["ACCUM"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches["adam"], rec["adam"] = adam_checks(kernels, dev, seed)
        launches["adam_cli"], rec["adam_cli"], step, state = adam_cli(
            launcher, kernels, dev, seed)
        secs["ADAM"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["ckpt"] = ckpt_phase(dev, step, state, seed)
        secs["CKPT"] = time.perf_counter() - t0
        del step, state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts, rec["repeat"] = repeat_checks(kernels, dev, seed)
        launches["repeat"], launches["many"] = counts["repeat"], \
            counts["many"]
        secs["REPEAT"] = time.perf_counter() - t0
    from veles_tpu_torch.ops import variants
    variants.clear_selection("lrn_maxpool")
    rec["seconds"] = secs
    print("LOCAL phase seconds " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in secs.items()),
          flush=True)
    return launches, rec


@contextlib.contextmanager
def loader_pulses():
    """Record every Loader.run of the block: (perf_counter after it, the
    minibatch's class); yields the list."""
    from veles_tpu_torch.loader.base import Loader
    inner = Loader.run
    seen = []

    def run(self):
        inner(self)
        seen.append((time.perf_counter(), int(self.minibatch_class)))

    Loader.run = run
    try:
        yield seen
    finally:
        Loader.run = inner


def granular_want(wf, since=None) -> dict:
    """The launches the unit firings predict: K2 once per LRN forward
    firing, K3 once per LRN backward firing, K1 once per parameter leaf
    per gradient-unit firing; nothing else. `since`: the units' run
    counts (by index in `wf.units`) before the firings to count."""
    from veles_tpu_torch.znicz.normalization import (LRNormalizerBackward,
                                                     LRNormalizerUnit)
    before = since or [0] * len(wf.units)

    def fired(u):
        return u.run_count - before[wf.units.index(u)]
    return {
        "lrn_forward": sum(fired(u) for u in wf.fwd_units
                           if isinstance(u, LRNormalizerUnit)),
        "lrn_backward": sum(fired(g) for g in wf.gds
                            if isinstance(g, LRNormalizerBackward)),
        "sgd_update": sum(len(g._pnames) * fired(g) for g in wf.gds)}


def granular_state(wf):
    """Every forward unit's parameters and its gradient unit's velocities
    (zeros before the first update made them), cloned on the card: one
    {name: (param, velocity)} per forward unit."""
    n = len(wf.forwards)
    out = []
    for i, u in enumerate(wf.forwards):
        g = wf.gds[n - 1 - i]
        out.append({k: (t.detach().clone(),
                        torch.zeros_like(t) if g.velocity(k) is None
                        else g.velocity(k).detach().clone())
                    for k, t in u.param_arrays().items()})
    return out


@torch.no_grad()
def load_state(state, snap):
    """Write a `granular_state` into a fused step's state."""
    for p, v, layer in zip(state["params"], state["vel"], snap):
        for k, (t, vel) in layer.items():
            p[k].copy_(t)
            v[k].copy_(vel)


def compare_granular(what, state, snap, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                     gate=True):
    """The granular `snap` against a fused step's state, leaf by leaf:
    (max abs err, elements beyond the tolerance); raises where `gate`."""
    worst, beyond = 0.0, 0
    for i, (p, v, layer) in enumerate(zip(state["params"], state["vel"],
                                          snap)):
        for k, (t, vel) in layer.items():
            for name, got, want in ((k, t, p[k].detach()),
                                    (f"velocity {k}", vel, v[k])):
                diff = (got - want).abs()
                worst = max(worst, float(diff.max()))
                beyond += int((diff > atol + rtol * want.abs()).sum())
                if gate:
                    check_close(f"{what} unit {i} {name}", got, want,
                                rtol, atol)
    return worst, beyond


def granular_equals_fused(dev):
    """The full-width AlexNet at dropout 0: one granular epoch (torch
    backend), the state captured at each loader firing. Each update the
    granular units made (the last train minibatch's is skipped once the
    Decision completes) must equal the fused step's from the same state
    on the same batch, every parameter and velocity within
    TRAIN_ATOL + TRAIN_RTOL*|fused|. The fused step chained over the same
    batches from the first state is also held against the granular end
    state and reported, not gated: once the two paths' float noise has
    moved the weights, a max-pool window whose two largest values lie
    within it may route its gradient to the other tap (the max's
    discontinuity, CHECK (c)). Prints the fused step's synchronized host
    ms per train step."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.base import TRAIN, Loader
    from veles_tpu_torch.samples import alexnet

    def build():
        # the sample's full-width defaults, whatever earlier phases left
        # in root.alexnet (the sample registers them once a process)
        prng.seed_all(1234)
        root.alexnet.decision.max_epochs = 1
        root.alexnet.loader.data_path = ""
        wf = alexnet.create_workflow(
            minibatch_size=TB, input_hw=227, n_classes=1000,
            width_mult=1.0, fc_width=4096, n_train=4 * TB,
            n_validation=TB)
        for layer in wf.forwards:
            if hasattr(layer, "dropout_ratio"):
                layer.dropout_ratio = 0.0
        wf.initialize(device=dev)
        return wf

    g = build()
    train = []      # (state before the minibatch, x, y, w)
    inner = Loader.run

    def capture(self):
        before = granular_state(g)
        inner(self)
        if self.minibatch_class == TRAIN:
            train.append((before, self.minibatch_data.copy(),
                          self.minibatch_labels.copy(),
                          self.minibatch_valid.copy()))
    Loader.run = capture
    try:
        g.run()
    finally:
        Loader.run = inner
    end = granular_state(g)
    updates = g.gds[0].run_count
    del g
    f = build()
    step = f.build_fused_step()
    state = step.init_state()
    worst, fused_ms = 0.0, []
    for k in range(updates):
        before, x, y, w = train[k]
        after = train[k + 1][0] if k + 1 < len(train) else end
        load_state(state, before)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, (loss, _) = step.train(state, x, y, w)
        float(loss)
        fused_ms.append(1e3 * (time.perf_counter() - t0))
        worst = max(worst, compare_granular(f"GRANULAR update {k}", state,
                                            after)[0])
    load_state(state, train[0][0])
    for _, x, y, w in train[:updates]:
        state, _ = step.train(state, x, y, w)
    chained, beyond = compare_granular("GRANULAR chained", state, end,
                                       gate=False)
    print(f"GRANULAR dropout 0: each of {updates} granular updates equals "
          f"the fused step's from the same state on the same batch within "
          f"{TRAIN_ATOL} + {TRAIN_RTOL}*|fused| (max abs err {worst:.3e}); "
          f"chained over the {updates} batches from the first state: max "
          f"abs err {chained:.3e}, {beyond} elements beyond (not gated); "
          f"fused host ms per train step (synchronized) "
          + ", ".join(f"{ms:.1f}" for ms in fused_ms), flush=True)
    del f, step, state, train, end
    torch.cuda.empty_cache()
    return {"updates": updates, "max_abs_err": worst,
            "chained_max_abs_err": chained, "chained_beyond": beyond,
            "fused_host_ms": fused_ms}


def granular_phase(launcher, kernels, dev):
    """GRANULAR: the full-width AlexNet one epoch (4 train minibatches of
    128 and one validation minibatch, dropout 0.5 as the sample has it)
    through the granular Unit/Workflow graph — `launcher.train` without
    --fused, the CLI's function, on the torch backend: counters zeroed
    just before and read just after must equal the unit firings' (K2 per
    LRN forward firing, K3 per LRN backward firing, K1 per leaf per
    gradient-unit firing), K4, K5 and every other instance zero. Prints
    the host ms of each train minibatch's pulse cycle and each unit's
    mean run_time; then `granular_equals_fused`. Returns (counts,
    record)."""
    with alexnet_config_kept(), loader_pulses() as pulses:
        t0 = time.perf_counter()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train([ALEXNET, "-r", "1234",
                             "root.alexnet.decision.max_epochs=1",
                             *TRAIN_ARGS])
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        end = time.perf_counter()
    if wf.device != dev or wf.backend_device.backend_name != "torch":
        raise AssertionError(f"granular run on {wf.backend_device}")
    want = granular_want(wf)
    check_counts("GRANULAR", counts, want)
    loss = wf.evaluator.loss
    if not np.isfinite(loss):
        raise AssertionError(f"GRANULAR: non-finite loss {loss}")
    # a pulse cycle: from one loader firing to the next (the last to the
    # end of the run); the first train minibatch's holds the warm-up
    marks = [t for t, _ in pulses] + [end]
    cycles = [(cls, 1e3 * (marks[i + 1] - marks[i]))
              for i, (_, cls) in enumerate(pulses)]
    train_ms = [ms for cls, ms in cycles if cls == 2]
    print(f"GRANULAR: {wf.decision.epoch_number} epoch in "
          f"{end - t0:.2f} s of host time; host ms per train minibatch "
          + ", ".join(f"{ms:.1f}" for ms in train_ms)
          + "; validation " + ", ".join(f"{ms:.1f}" for cls, ms in cycles
                                        if cls != 2), flush=True)
    print(f"GRANULAR: loss {loss}; history {wf.decision.history}; "
          f"launches {counts} = the firings' {want}", flush=True)
    print("GRANULAR unit mean run_time ms: " + ", ".join(
        f"{u.name} {1e3 * u.run_time / u.run_count:.2f} (x{u.run_count})"
        for u in wf.units if u.run_count), flush=True)
    rec = {"launches": counts, "want": want, "train_host_ms": train_ms,
           "loss": loss, "units": {f"{i}:{u.name}": [u.run_count,
                                                   u.run_time]
                                   for i, u in enumerate(wf.units)}}
    del wf
    torch.cuda.empty_cache()
    with alexnet_config_kept():
        rec["vs_fused"] = granular_equals_fused(dev)
    return counts, rec


# ---------------------------------------------------------------------------
# CONV_STEM, GRANULAR transformer, GRANULAR RESUME
# ---------------------------------------------------------------------------

#: AlexNet's conv1: x (128, 227, 227, 3), 96 kernels of 11x11 at stride 4
STEM_X, STEM_W, STEM_STRIDE = (TB, HW, HW, 3), (11, 11, 3, 96), 4
#: s2d against direct in f32: the forward within STEM_RTOL, STEM_ATOL (the
#: JAX package's s2d test), a gradient within STEM_RTOL and STEM_ATOL of
#: its largest magnitude (a weight gradient sums N*OH*OW = 387,200
#: products here, in another order in each lowering); in bf16 each value
#: within STEM_BF16 relative and STEM_BF16 of the largest magnitude (two
#: bf16 roundings of sums taken in another order)
STEM_RTOL, STEM_ATOL, STEM_BF16 = 1e-5, 1e-5, 2.0 ** -7
STEM_REPS = 25


def time_turns(fns, reps=STEM_REPS):
    """Median device ms of each callable, by CUDA events, the callables
    run in turns (each once per round, `reps` rounds after a warm-up
    round)."""
    for f in fns.values():
        f()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, f in fns.items():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            times[k].append((s, e))
    torch.cuda.synchronize()
    return {k: float(np.median([s.elapsed_time(e) for s, e in v]))
            for k, v in times.items()}


def conv_stem_phase(dev):
    """CONV_STEM: the `conv_stem` op's two lowerings at AlexNet's conv1
    (batch 128, 227x227x3, 96 kernels 11x11/4), f32 with TF32 off and
    then bf16: `s2d`'s forward and its weight and bias gradients held
    against `direct`'s on the same inputs and upstream gradient, then
    both timed in turns (forward, and forward + backward), median of 25
    by CUDA events. The activation is linear: behind conv1's strict ReLU
    the two lowerings' outputs, a few ulps apart, put some outputs within
    1e-6 of zero on either side of it, whose gradients (about 1 each)
    then route differently (the ReLU's discontinuity, not the
    lowering's). Returns the record."""
    from veles_tpu_torch.backends import full_f32
    from veles_tpu_torch.ops import variants
    rs = np.random.RandomState(17)
    x32 = torch.from_numpy(rs.randn(*STEM_X).astype(np.float32)).to(dev)
    w32 = torch.from_numpy(
        (rs.randn(*STEM_W) * 0.01).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(rs.randn(STEM_W[-1]).astype(np.float32)
                           * 0.1).to(dev)
    oh = (HW - STEM_W[0]) // STEM_STRIDE + 1
    g32 = torch.from_numpy(rs.randn(TB, oh, oh, STEM_W[-1]).astype(
        np.float32)).to(dev)
    stride = (STEM_STRIDE, STEM_STRIDE)
    rec = {}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, w, b, g = (t.to(dtype) for t in (x32, w32, b32, g32))

        def run(name, backward, x=x, w=w, b=b, g=g):
            v = variants.get("conv_stem", name)
            wt = w.detach().requires_grad_(backward)
            bt = b.detach().requires_grad_(backward)
            with full_f32(dev), torch.set_grad_enabled(backward):
                y = v.apply(x, wt, bt, stride, (0, 0), "linear")
                if not backward:
                    return y, None, None
                dw, db = torch.autograd.grad(y, [wt, bt], g)
            return y.detach(), dw, db

        got = run("s2d", True)
        want = run("direct", True)
        errs = {}
        for name, a, e in zip(("y", "dw", "db"), got, want):
            a, e = a.float(), e.float()
            top = float(e.abs().max())
            if dtype == torch.float32:
                rtol = STEM_RTOL
                atol = STEM_ATOL if name == "y" else STEM_ATOL * top
            else:
                rtol, atol = STEM_BF16, STEM_BF16 * top
            check_close(f"CONV_STEM {label} s2d vs direct {name}", a, e,
                        rtol, atol)
            errs[name] = float((a - e).abs().max())
        ms = time_turns({
            "direct": lambda: run("direct", False),
            "s2d": lambda: run("s2d", False),
            "direct_fwd_bwd": lambda: run("direct", True),
            "s2d_fwd_bwd": lambda: run("s2d", True)})
        print(f"CONV_STEM {label} AlexNet conv1 {STEM_X} * {STEM_W} / "
              f"{STEM_STRIDE}: s2d vs direct max abs err {errs} (f32: "
              f"{STEM_RTOL}*|direct| + {STEM_ATOL}, of the largest "
              f"gradient for dw, db; bf16: {STEM_BF16} of each and of the "
              f"largest); device ms (median of {STEM_REPS}, in turns): "
              f"forward direct {ms['direct']:.4f}, s2d {ms['s2d']:.4f}; "
              f"forward + backward direct {ms['direct_fwd_bwd']:.4f}, "
              f"s2d {ms['s2d_fwd_bwd']:.4f}", flush=True)
        rec[label] = {"max_abs_err": errs, "ms": ms}
        del got, want
    torch.cuda.empty_cache()
    return rec


#: the granular char-transformer's runs: the CLI's 2 epochs (one train
#: minibatch of 3 windows and one validation window each, the sample's
#: text), and GT_CHECK_EPOCHS over a text of 32 train windows and one
#: validation window for the granular-against-fused check (2 updates,
#: the second from non-zero velocities)
GT_EPOCHS, GT_CHECK_EPOCHS = 2, 3


def granular_transformer_want(wf) -> dict:
    """The launches the firings predict: K6 once per attention forward
    firing and once per vjp (each attention gradient-unit firing), K7 once
    per vjp, K1 once per leaf per gradient-unit firing; nothing else."""
    from veles_tpu_torch.znicz.attention import AttentionUnit, \
        GDMultiHeadAttention
    vjp = sum(g.run_count for g in wf.gds
              if isinstance(g, GDMultiHeadAttention))
    return {"flash_attention_forward": vjp + sum(
                u.run_count for u in wf.fwd_units
                if isinstance(u, AttentionUnit)),
            "flash_attention_backward": vjp,
            "sgd_update": sum(len(g._pnames) * g.run_count
                              for g in wf.gds)}


def granular_transformer_equals_fused(dev):
    """The full-width char-transformer at seq_len 4096 over a text of 32
    train windows and one validation window, GT_CHECK_EPOCHS granular
    epochs (torch backend), the state captured at each loader firing:
    each update the granular units made must equal the fused step's from
    the same state on the same batch, every parameter and velocity within
    TRAIN_ATOL + TRAIN_RTOL*|fused|. Prints the fused step's synchronized
    host ms per train step."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN, Loader
    from veles_tpu_torch.loader.text import synthetic_text
    from veles_tpu_torch.samples import char_transformer
    mb = ATT_SHAPES[0][0]

    def build():
        prng.seed_all(1234)
        with ct_config({"loader.seq_len": CT_SEQ,
                        "loader.n_validation": 1,
                        "loader.minibatch_size": mb,
                        "decision.max_epochs": GT_CHECK_EPOCHS}):
            wf = char_transformer.create_workflow(
                text=synthetic_text((mb + 1) * CT_SEQ + 1))
        wf.initialize(device=dev)
        return wf

    g = build()
    train = []
    with loader_pulses() as pulses:
        inner = Loader.run

        def capture(self):
            before = granular_state(g)
            inner(self)
            if self.minibatch_class == TRAIN:
                train.append((before, self.minibatch_data.copy(),
                              self.minibatch_labels.copy(),
                              self.minibatch_valid.copy()))
        Loader.run = capture
        try:
            g.run()
        finally:
            Loader.run = inner
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    end = granular_state(g)
    updates = g.gds[0].run_count
    del g
    # each pulse cycle, from one loader firing to the next (it holds the
    # next state's capture, a copy of 13 small leaves)
    marks = [t for t, _ in pulses] + [t_end]
    cycles = [(cls, 1e3 * (marks[i + 1] - marks[i]))
              for i, (_, cls) in enumerate(pulses)]
    f = build()
    step = f.build_fused_step()
    state = step.init_state()
    worst, fused_ms = 0.0, []
    for k in range(updates):
        before, x, y, w = train[k]
        after = train[k + 1][0] if k + 1 < len(train) else end
        load_state(state, before)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, (loss, _) = step.train(state, x, y, w)
        float(loss)
        fused_ms.append(1e3 * (time.perf_counter() - t0))
        worst = max(worst, compare_granular(
            f"GRANULAR transformer update {k}", state, after)[0])
    if updates != GT_CHECK_EPOCHS - 1:
        raise AssertionError(f"GRANULAR transformer: {updates} granular "
                             f"updates in {GT_CHECK_EPOCHS} epochs")
    print(f"GRANULAR transformer: each of {updates} granular updates "
          f"equals the fused step's from the same state on the same batch "
          f"of {mb} windows within {TRAIN_ATOL} + {TRAIN_RTOL}*|fused| "
          f"(max abs err {worst:.3e}); fused host ms per train step "
          f"(synchronized) " + ", ".join(f"{ms:.1f}" for ms in fused_ms)
          + "; the granular run's host ms per pulse cycle (class: 1 "
          "validation, 2 train; a cycle's end holds the next state's "
          "capture) " + ", ".join(f"{c}:{ms:.1f}" for c, ms in cycles),
          flush=True)
    del f, step, state, train, end
    torch.cuda.empty_cache()
    return {"updates": updates, "max_abs_err": worst,
            "fused_host_ms": fused_ms, "granular_cycles_ms": cycles}


def granular_transformer_phase(launcher, kernels, dev):
    """GRANULAR transformer: the char-transformer at its own widths (embed
    64, 4 heads of 16, ffn 128, vocabulary 18, minibatch 32) at seq_len
    4096 for GT_EPOCHS epochs through the granular graph — `launcher.train`
    without --fused, on the torch backend: counters zeroed just before and
    read just after must equal the firings' (granular_transformer_want),
    nothing else launched, the loss finite. Prints each minibatch's host
    ms of its pulse cycle and each unit's mean run_time; then
    `granular_transformer_equals_fused`. Returns (counts, record)."""
    from veles_tpu_torch.config import root
    saved = root.char_transformer.to_dict()
    try:
        with loader_pulses() as pulses:
            t0 = time.perf_counter()
            # -- the main path: counts zeroed just before, read just after
            kernels.reset_launch_counts()
            wf = launcher.train([
                CHAR_TRANSFORMER, "-r", "1234", *CT_TRAIN_ARGS,
                f"root.char_transformer.decision.max_epochs={GT_EPOCHS}"])
            counts = kernels.launch_counts()
            torch.cuda.synchronize()
            end = time.perf_counter()
    finally:
        root.char_transformer.update(saved)
    if wf.device != dev or wf.backend_device.backend_name != "torch":
        raise AssertionError(f"granular run on {wf.backend_device}")
    att = wf.forwards[1]
    variant = att.variant_effective()
    want = granular_transformer_want(wf)
    print(f"GRANULAR transformer: {wf.decision.epoch_number} epochs at "
          f"S={wf.loader.seq_len}, {att.n_heads} heads of {att.head_dim}, "
          f"attention variant {variant}; launches {counts} = the "
          f"firings' {want}", flush=True)
    check_counts("GRANULAR transformer", counts, want)
    if variant != "kernel" or wf.decision.epoch_number != GT_EPOCHS \
            or not want["flash_attention_backward"]:
        raise AssertionError(f"GRANULAR transformer: variant {variant}, "
                             f"{wf.decision.epoch_number} epochs, {want}")
    loss = wf.evaluator.loss
    if not np.isfinite(loss):
        raise AssertionError(f"GRANULAR transformer: non-finite loss {loss}")
    marks = [t for t, _ in pulses] + [end]
    cycles = [(cls, 1e3 * (marks[i + 1] - marks[i]))
              for i, (_, cls) in enumerate(pulses)]
    print(f"GRANULAR transformer: {end - t0:.2f} s of host time; host ms "
          f"per pulse cycle (class: 1 validation, 2 train) "
          + ", ".join(f"{cls}:{ms:.1f}" for cls, ms in cycles)
          + f"; loss {loss}; history {wf.decision.history}", flush=True)
    print("GRANULAR transformer unit mean run_time ms: " + ", ".join(
        f"{u.name} {1e3 * u.run_time / u.run_count:.2f} (x{u.run_count})"
        for u in wf.units if u.run_count), flush=True)
    rec = {"launches": counts, "want": want, "cycles_ms": cycles,
           "loss": loss, "history": wf.decision.history,
           "units": {f"{i}:{u.name}": [u.run_count, u.run_time]
                     for i, u in enumerate(wf.units)}}
    del wf
    torch.cuda.empty_cache()
    rec["vs_fused"] = granular_transformer_equals_fused(dev)
    return counts, rec


#: GRANULAR RESUME: the full-width AlexNet (synthetic loader, dropout 0.5)
#: through the granular graph, GR_EPOCHS uninterrupted against GR_CUT and
#: resumed with -s; snapshots uncompressed (codec none), keep_last 2; 640
#: train images (5 minibatches an epoch: 4 updates, so every snapshot
#: follows updates; 1280 until the TP phase came and the script passed
#: 850 s, a granular minibatch costing ~0.7 s under the deterministic
#: algorithms; at 384 the cut run's newest snapshot holds epoch 0)
GR_EPOCHS, GR_CUT, GR_FAULT = 3, 2, "kill@epoch=2"
GR_ARGS = ["root.alexnet.loader.n_train=640"]
GRANULAR_RESUME_WORKFLOW = '''
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.gresume.snapshot_dir = "."
root.gresume.init = "reference"
# bit for bit from one run to the next on the card: cuDNN's weight and
# data gradients and the max-pool backward's index_add_ (atomics) take
# PyTorch's deterministic algorithms
torch.use_deterministic_algorithms(True, warn_only=True)


def create_workflow():
    wf = alexnet.create_workflow(init=root.gresume.init)
    return StandardWorkflow(
        layers=wf.layers_config, loader=wf.loader, loss=wf.loss,
        n_classes=wf.n_classes,
        decision_config=root.alexnet.decision.to_dict(),
        gd_config=root.alexnet.gd.to_dict(),
        snapshot_config={"directory": root.gresume.snapshot_dir,
                         "prefix": "alexnet", "compression": "",
                         "keep_last": 2},
        name="AlexNetWorkflow")


def run(load, main):
    wf, restored = load(create_workflow)
    if restored:
        wf.decision.max_epochs = root.alexnet.decision.max_epochs
        wf.decision.complete = False
    main()
'''


def granular_resume_argv(wf_file, snap_dir, epochs):
    return [wf_file, "-r", "1234", "root.alexnet.loader.data_path=",
            f"root.alexnet.decision.max_epochs={epochs}",
            f"root.gresume.snapshot_dir={snap_dir}", *GR_ARGS, *TRAIN_ARGS]


@contextlib.contextmanager
def imported_counts():
    """Every workflow Snapshotter.import_ restores in the block, as it was
    restored: its units' run counts and its epoch counter."""
    from veles_tpu_torch.snapshotter import Snapshotter
    inner = Snapshotter.import_
    seen = []

    def import_(path, restore_prng=True):
        wf = inner(path, restore_prng)
        seen.append({"run_counts": [u.run_count for u in wf.units],
                     "epoch": wf.decision.epoch_number})
        return wf

    Snapshotter.import_ = staticmethod(import_)
    try:
        yield seen
    finally:
        Snapshotter.import_ = staticmethod(inner)


def granular_resume_run(launcher, kernels, label, argv):
    """One GRANULAR RESUME run through `launcher.train(argv)` without
    --fused: counts zeroed just before and read just after, the snapshot
    clock. Returns (workflow, record)."""
    with snapshot_clock() as snaps, imported_counts() as restored:
        t0 = time.perf_counter()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"label": label, "launches": counts, "wall_s": wall,
           "exports": snaps["export"], "imports": snaps["import"],
           "line": trained_line(wf),
           "restored": restored[0] if restored else None}
    print(f"GRANULAR RESUME {label}: {wall:.2f} s of host time; snapshot "
          f"exports (s, bytes) {snaps['export']}; imports (s, bytes) "
          f"{snaps['import']}; launches {counts}; {rec['line']}",
          flush=True)
    return wf, rec


def granular_resume_phase(launcher, kernels, dev):
    """GRANULAR RESUME: (a) the full-width AlexNet (dropout 0.5, synthetic
    loader) GR_EPOCHS granular epochs with snapshot_config (codec none)
    against the same run cut at GR_CUT epochs and resumed from its newest
    snapshot with -s: the same bits in every parameter and velocity, the
    history, best_validation_err, the epoch counter and the loss; the
    resumed run's launches exactly its firings' (K2, K3, K1); (b)
    `--supervise` of the same command line under GR_FAULT in a child: exit
    0, one restart from a snapshot, the final TRAINED line (a)'s
    uninterrupted run's. Returns (launches by path, record)."""
    from veles_tpu_torch.snapshotter import Snapshotter
    work = tempfile.mkdtemp(prefix="veles_gresume_")
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        with alexnet_config_kept():
            wf_file = os.path.join(work, "alexnet_granular.py")
            with open(wf_file, "w") as f:
                f.write(GRANULAR_RESUME_WORKFLOW)
            dirs = {k: os.path.join(work, k) for k in ("whole", "cut",
                                                      "sup")}
            whole, rec_whole = granular_resume_run(
                launcher, kernels, "(a) uninterrupted",
                granular_resume_argv(wf_file, dirs["whole"], GR_EPOCHS))
            check_counts("GRANULAR RESUME (a) uninterrupted",
                         rec_whole["launches"], granular_want(whole))
            want, want_line = trained_state(whole), rec_whole["line"]
            want_meta = (whole.decision.history, whole.decision.epoch_number,
                         whole.decision.best_validation_err,
                         whole.evaluator.loss)
            del whole
            torch.cuda.empty_cache()
            cut, rec_cut = granular_resume_run(
                launcher, kernels, f"(a) {GR_CUT} epochs",
                granular_resume_argv(wf_file, dirs["cut"], GR_CUT))
            del cut
            snap = Snapshotter.latest(dirs["cut"], prefix="alexnet")
            if snap is None or not Snapshotter.verify(snap):
                raise AssertionError(f"GRANULAR RESUME (a): no verified "
                                     f"snapshot in {os.listdir(dirs['cut'])}")
            resumed, rec = granular_resume_run(
                launcher, kernels, "(a) resumed",
                granular_resume_argv(wf_file, dirs["cut"], GR_EPOCHS)
                + ["-s", snap])
            restored_epoch = rec["restored"]["epoch"]
            # a snapshot taken after train minibatches (the trained
            # weights, velocities, a dropout stream past its seed's
            # position), the resumed run's launches its own firings'
            if restored_epoch < 1:
                raise AssertionError(f"GRANULAR RESUME (a): "
                                     f"{os.path.basename(snap)} holds epoch "
                                     f"{restored_epoch}, before any update")
            delta = granular_want(resumed, rec["restored"]["run_counts"])
            check_counts("GRANULAR RESUME (a) resumed", rec["launches"],
                         delta)
            if not delta["sgd_update"]:
                raise AssertionError("GRANULAR RESUME (a): the resumed run "
                                     "trained nothing")
            got = trained_state(resumed)
            got_meta = (resumed.decision.history,
                        resumed.decision.epoch_number,
                        resumed.decision.best_validation_err,
                        resumed.evaluator.loss)
            if resumed.device != dev:
                raise AssertionError(f"GRANULAR RESUME (a): resumed on "
                                     f"{resumed.device}")
            same = same_bits(got, want) and got_meta == want_meta
            print(f"GRANULAR RESUME (a) resumed from "
                  f"{os.path.basename(snap)} ({os.path.getsize(snap)} "
                  f"bytes, sidecar verified; epoch counter "
                  f"{restored_epoch}) "
                  f"against the uninterrupted run: the same bits in "
                  f"{len(got)} parameters and velocities, history, "
                  f"best_validation_err, epoch counter and loss: {same}; "
                  f"launches {rec['launches']} = its firings' {delta}",
                  flush=True)
            if not same:
                diff = [(i, float((a - b).abs().max()))
                        for i, (a, b) in enumerate(zip(got, want))
                        if not torch.equal(a, b)]
                raise AssertionError(f"GRANULAR RESUME (a): the resumed run "
                                     f"differs: {got_meta} against "
                                     f"{want_meta}; tensors (index, max "
                                     f"abs diff) {diff}")
            del resumed, got, want
            torch.cuda.empty_cache()
            report = os.path.join(work, "supervise_report.json")
            env = dict(os.environ, PYTHONPATH=REPO,
                       VELES_FAULT_PLAN=GR_FAULT)
            env.pop("VELES_FAULT_STATE", None)
            cmd = [sys.executable, "-m", "veles_tpu_torch",
                   *granular_resume_argv(wf_file, dirs["sup"], GR_EPOCHS),
                   "--supervise", "--snapshot-dir", dirs["sup"],
                   "--snapshot-prefix", "alexnet", "--supervise-report",
                   report]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t0
            if r.returncode != 0 or not os.path.exists(report):
                raise AssertionError(f"GRANULAR RESUME (b): the supervisor "
                                     f"exited {r.returncode}:\n"
                                     f"{r.stdout[-3000:]}\n"
                                     f"{r.stderr[-5000:]}")
            with open(report) as f:
                attempts = json.load(f)["attempts"]
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("TRAINED")]
            print(f"GRANULAR RESUME (b) --supervise (granular) under "
                  f"{GR_FAULT}: exit 0 in {wall:.2f} s; attempts "
                  + "; ".join(f"{a['attempt']}: {a['reason']} "
                              f"{a['exit_codes']} at epoch "
                              f"{a['epoch_reached']} from "
                              f"{os.path.basename(a['snapshot'] or '-')}"
                              for a in attempts), flush=True)
            print(f"GRANULAR RESUME (b) "
                  f"{lines[-1] if lines else '<no TRAINED line>'}",
                  flush=True)
            if len(attempts) != 2 or attempts[0]["exit_codes"] != [-9] \
                    or not attempts[1]["snapshot"] \
                    or attempts[1]["reason"] != "ok":
                raise AssertionError(f"GRANULAR RESUME (b): attempts "
                                     f"{attempts}:\n{r.stderr[-3000:]}")
            if lines[-1:] != [want_line]:
                raise AssertionError(f"GRANULAR RESUME (b): {lines[-1:]} is "
                                     f"not the uninterrupted run's "
                                     f"{want_line}")
        record = {"uninterrupted": rec_whole, "cut": rec_cut,
                  "resumed": rec, "snapshot_bytes": os.path.getsize(snap),
                  "supervised": {"attempts": attempts, "wall_s": wall,
                                 "line": lines[-1]}}
        return {"granular_resume": rec["launches"]}, record
    finally:
        # the workflow file's deterministic mode stays with this phase
        torch.use_deterministic_algorithms(deterministic)
        shutil.rmtree(work, ignore_errors=True)


@contextlib.contextmanager
def epoch_marks():
    """Record the host clock at every Decision run that closes an epoch
    in the block: yields the list of (perf_counter, history record)."""
    from veles_tpu_torch.znicz.decision import DecisionGD
    inner = DecisionGD.run
    marks = []

    def run(self):
        n = len(self.history)
        inner(self)
        if len(self.history) > n:
            marks.append((time.perf_counter(), self.history[-1]))

    DecisionGD.run = run
    try:
        yield marks
    finally:
        DecisionGD.run = inner


def sample_want(wf, fused: bool) -> dict:
    """The launches a sample's run must have made. Granular: the unit
    firings' (`granular_want`). Fused: K1 once per leaf per train step, K2
    once per LRN layer per train and validation step, K3 once per LRN
    layer per train step (CIFAR-10's LRN follows a max pool, so no pair
    claims it), nothing else."""
    if not fused:
        return granular_want(wf)
    from veles_tpu_torch.znicz.normalization import LRNormalizerForward
    loader, epochs = wf.loader, wf.decision.epoch_number
    mb = loader.minibatch_size
    train = epochs * -(-loader.class_lengths[2] // mb)
    valid = epochs * -(-loader.class_lengths[1] // mb)
    lrn = sum(isinstance(u, LRNormalizerForward) for u in wf.forwards)
    want = {"sgd_update": train * sum(len(u.param_arrays())
                                      for u in wf.forwards)}
    if lrn:
        want["lrn_forward"] = lrn * (train + valid)
        want["lrn_backward"] = lrn * train
    return want


def sample_run(launcher, kernels, dev, name: str, fused: bool):
    """One sample trained through `launcher.train` (the CLI's function)
    at its own sizes and defaults, `--fused` or granular on the torch
    backend, counters zeroed just before and read just after: the
    launches must be exactly `sample_want`'s, the loss finite, and the
    best validation error under a fifth of the validation rows. Prints
    host seconds and the validation error per epoch."""
    mode = "fused" if fused else "granular"
    argv = [SAMPLES[name], "-r", "1234",
            *(["--fused"] if fused else ["-b", "torch"])]
    with epoch_marks() as marks:
        t0 = time.perf_counter()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        end = time.perf_counter()
    want = sample_want(wf, fused)
    check_counts(f"SAMPLES {name} {mode}", counts, want)
    if wf.device != dev:
        raise AssertionError(f"SAMPLES {name} {mode}: trained on "
                             f"{wf.device}")
    loss = wf.evaluator.loss
    if not np.isfinite(loss):
        raise AssertionError(f"SAMPLES {name} {mode}: non-finite loss "
                             f"{loss}")
    n_valid = wf.loader.class_lengths[1]
    best = wf.decision.best_validation_err
    ticks = [t0] + [t for t, _ in marks]
    epoch_s = [ticks[i + 1] - ticks[i] for i in range(len(marks))]
    valid_err = [rec["valid_err"] for _, rec in marks]
    print(f"SAMPLES {name} {mode}: {wf.decision.epoch_number} epochs of "
          f"{wf.loader.class_lengths[2]} train and {n_valid} validation "
          f"rows (minibatch {wf.loader.minibatch_size}) in "
          f"{end - t0:.2f} s of host time; host s per epoch "
          + ", ".join(f"{t:.3f}" for t in epoch_s)
          + "; validation errors per epoch "
          + ", ".join(f"{e:g}" for e in valid_err)
          + f"; best {best}", flush=True)
    print(f"SAMPLES {name} {mode}: launches {counts} = expected {want}",
          flush=True)
    if best is None or best >= 0.2 * n_valid:
        raise AssertionError(f"SAMPLES {name} {mode}: best validation "
                             f"error {best} of {n_valid} rows")
    rec = {"launches": counts, "epoch_host_s": epoch_s,
           "valid_err": valid_err, "best_valid_err": best,
           "host_s": end - t0}
    del wf
    torch.cuda.empty_cache()
    return counts, rec


def cifar_card_vs_cpu(dev):
    """3 fused steps of CIFAR-10 (the sample's layers and widths, dropout
    free) on the card against the same steps on the CPU from one seed,
    every leaf and velocity within TRAIN_ATOL + TRAIN_RTOL*|cpu|, on
    batches of CIFAR_CHECK_ROWS rows without near ties."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import cifar10
    steps, states = {}, {}
    for d in ("cpu", dev):
        prng.seed_all(1234)
        wf = cifar10.create_workflow()
        wf.initialize(d)
        steps[d] = wf.build_fused_step()
        states[d] = steps[d].init_state()
    compare_states("SAMPLES cifar10 initial state", states[dev],
                   states["cpu"], 0.0, 0.0)
    rs = np.random.RandomState(4)
    worst = 0.0
    for i in range(3):
        for draw in range(200):
            x = rs.randn(CIFAR_CHECK_ROWS, 32, 32, 3).astype(np.float32)
            y = rs.randint(0, 10, CIFAR_CHECK_ROWS)
            if not near_ties(steps["cpu"], states["cpu"], x):
                break
        else:
            raise AssertionError("SAMPLES cifar10 card vs cpu: 200 "
                                 "batches in a row with near ties")
        out = {}
        for d in ("cpu", dev):
            states[d], (loss, n_err) = steps[d].train(states[d], x, y)
            out[d] = (float(loss), int(n_err))
        check_loss(f"SAMPLES cifar10 step {i} card vs cpu", out[dev][0],
                   out["cpu"][0])
        if out[dev][1] != out["cpu"][1]:
            raise AssertionError(f"SAMPLES cifar10 step {i}: n_err "
                                 f"{out[dev][1]} != {out['cpu'][1]}")
        err = compare_states(f"SAMPLES cifar10 step {i} card vs cpu",
                             states[dev], states["cpu"])
        worst = max(worst, err)
        print(f"SAMPLES cifar10 fused step {i} (batch draw {draw}) card vs "
              f"cpu: loss {out[dev][0]} vs {out['cpu'][0]}, n_err "
              f"{out[dev][1]} vs {out['cpu'][1]}, max abs err over every "
              f"leaf and velocity {err:.3e}", flush=True)
    return worst


#: the unit families of the slice that neither sample holds, in one graph
#: (the JAX package's tests/test_conv_units.py style)
STACK_LAYERS = [
    {"type": "input_normalize", "scale": 0.5, "offset": 0.0},
    {"type": "conv_strictrelu", "n_kernels": 8, "kx": 3, "ky": 3,
     "padding": (1, 1), "weights_stddev": 0.1},
    {"type": "maxabs_pooling", "ksize": (2, 2)},
    {"type": "activation_log"},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "ky": 3,
     "weights_stddev": 0.1},
    {"type": "stochastic_pooling", "ksize": (2, 2)},
    {"type": "activation_tanh"},
    {"type": "softmax", "output_sample_shape": 4, "weights_stddev": 0.05},
]


def stack_phase(dev):
    """The max-abs and stochastic pooling, log and tanh activation and
    input normalization units in one graph, one granular epoch on the
    card (torch backend) with the validation confusion matrix kept: every
    unit fired on the card, and the matrix's counts sum to the validation
    rows."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    prng.seed_all(1234)
    loader = SyntheticClassifierLoader(
        n_classes=4, sample_shape=(12, 12, 1), n_validation=80,
        n_train=240, minibatch_size=40, noise=0.5)
    wf = StandardWorkflow(
        layers=STACK_LAYERS, loader=loader, loss="softmax", n_classes=4,
        decision_config={"max_epochs": 1, "fail_iterations": 50},
        gd_config={"learning_rate": 0.05, "gradient_moment": 0.9},
        plot_config={"confusion": True}, name="ChipStack")
    t0 = time.perf_counter()
    wf.initialize(device=dev, backend="torch")
    wf.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for u in list(wf.fwd_units) + list(wf.gds):
        if u.run_count <= 0:
            raise AssertionError(f"SAMPLES stack: {u.name} never ran")
    if wf.device != dev or wf.backend_device.backend_name != "torch":
        raise AssertionError(f"SAMPLES stack: ran on {wf.backend_device}")
    for u in wf.fwd_units:
        # where the unit's torch_run left its output (devmem() would
        # move it)
        where = u.output._dev.device
        if where != dev:
            raise AssertionError(f"SAMPLES stack: {u.name}'s output on "
                                 f"{where}")
    conf = wf.evaluator.confusion_matrix.mem
    n_valid = wf.loader.class_lengths[1]
    if int(conf.sum()) != n_valid:
        raise AssertionError(f"SAMPLES stack: confusion counts "
                             f"{int(conf.sum())} != {n_valid} validation "
                             f"rows")
    print(f"SAMPLES stack (input_normalize, maxabs_pooling, activation_log, "
          f"stochastic_pooling, activation_tanh) granular on {dev}: "
          f"{secs:.2f} s; unit firings "
          + ", ".join(f"{u.name} x{u.run_count}" for u in wf.fwd_units)
          + f"; validation error {wf.decision.epoch_n_err[1]}; confusion "
          f"matrix {conf.tolist()} sums to the {n_valid} validation rows",
          flush=True)
    return {"seconds": secs, "confusion": conf.tolist()}


def sample_lrn_checks(kernels, dev, bw, flops):
    """K2 and K3 against their plain versions at CIFAR_LRN_SHAPE, the
    shape the CIFAR-10 sample gives them in both modes (AlexNet's LRN
    constants, the `lrn` layer's defaults), within KERNEL_RTOL/ATOL, and
    timed as the KERNEL lines time them. Returns a row per kernel."""
    timer = ColdTimer(dev)
    rs = np.random.RandomState(5)
    shape = CIFAR_LRN_SHAPE
    # the LRN follows a strict-ReLU conv and a max pool: post-ReLU values
    x = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                         .astype(np.float32)).to(dev)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
    nbytes = x.numel() * 4
    x_nchw = x.permute(0, 3, 1, 2)
    leaf = x.clone().requires_grad_(True)
    y = F.local_response_norm(leaf.permute(0, 3, 1, 2), size=N,
                              alpha=ALPHA * N, beta=BETA, k=K)
    g_nchw = g.permute(0, 3, 1, 2)
    cases = {
        "lrn_forward": (
            lambda: kernels.lrn_forward(x, K, ALPHA, BETA, N),
            lambda: kernels.lrn_forward_plain(x, K, ALPHA, BETA, N),
            lambda: F.local_response_norm(x_nchw, size=N, alpha=ALPHA * N,
                                          beta=BETA, k=K).permute(0, 2, 3,
                                                                  1),
            "F.local_response_norm", 2 * nbytes / bw,
            lrn_ops(x.numel()) / flops),
        "lrn_backward": (
            lambda: kernels.lrn_backward(x, g, K, ALPHA, BETA, N),
            lambda: kernels.lrn_backward_plain(x, g, K, ALPHA, BETA, N),
            lambda: torch.autograd.grad(y, leaf, g_nchw,
                                        retain_graph=True)[0],
            "autograd of F.local_response_norm", 3 * nbytes / bw,
            lrn_grad_ops(x.numel()) / flops)}
    rows = {}
    for name, (kern, plain, lib, lib_name, t_bytes, t_ops) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = check_close(f"lrn {name} cifar10", got, want, KERNEL_RTOL,
                          KERNEL_ATOL)
        same = bool(torch.equal(got, want))
        lib_err = check_close(f"{lib_name} cifar10", lib(), want, 1e-4,
                              1e-5)
        rows[name] = {
            "shape": list(shape), "max_abs_err": err, "bit_equal": same,
            "ms": timer(kern), "plain_ms": timer(plain),
            "library_ms": timer(lib), "library": lib_name,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        r = rows[name]
        print(f"KERNEL {name} cifar10 {r['shape']}: ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) max_abs_err {err:.3e}, "
              f"{'bit-equal to' if same else 'other bits than'} the plain "
              f"version; library = {lib_name}, max abs err against the "
              f"plain version {lib_err:.3e}", flush=True)
    del x, g, x_nchw, leaf, y, g_nchw
    return rows


def samples_phase(launcher, kernels, dev, bw, flops):
    """SAMPLES: MNIST and CIFAR-10 at their sample sizes in both modes,
    CIFAR-10's fused step card against CPU, and the unit stack. Returns
    (launches by path, record)."""
    t0 = time.perf_counter()
    launches, rec = {}, {"lrn_kernels": sample_lrn_checks(kernels, dev, bw,
                                                          flops)}
    for name in SAMPLES:
        for fused in (True, False):
            mode = "fused" if fused else "granular"
            launches[f"{name}_{mode}"], rec[f"{name}_{mode}"] = sample_run(
                launcher, kernels, dev, name, fused)
    rec["cifar10_card_vs_cpu"] = cifar_card_vs_cpu(dev)
    rec["stack"] = stack_phase(dev)
    rec["seconds"] = time.perf_counter() - t0
    print(f"SAMPLES phase: {rec['seconds']:.2f} s", flush=True)
    return launches, rec


# ---------------------------------------------------------------------------
# AUTOTUNE: the kernel search (ops/templates.py, ops/autotune.py)
# ---------------------------------------------------------------------------

#: the search's run: the full-width bf16 AlexNet at batch 256, one train
#: and one validation minibatch, `--autotune-budget AT_BUDGET`: the six
#: template ops' incumbent floors add up to 19 (a budget of 16 would
#: leave the last of them untimed), and 29 trials more let each op's
#: descent move its axes
AT_BATCH, AT_BUDGET = 256, 48
AT_ARGS = [f"root.alexnet.loader.minibatch_size={AT_BATCH}",
           f"root.alexnet.loader.n_train={AT_BATCH}",
           f"root.alexnet.loader.n_validation={AT_BATCH}",
           "root.alexnet.decision.max_epochs=1", *BF16_ARGS]
#: the ops the search's report must name a timed winner for
AT_OPS = ("lrn", "maxpool", "conv_stem", "lrn_maxpool", "sgd_update",
          "flash_attn")
#: K1's, K2/K3's and K4's generated launch shapes
AT_THREADS = (128, 256, 512, 1024)
AT_TILES = (1536, 3072, 6144, 12288)
AT_BANDS = tuple((rb, cb) for rb in (1, 2, 3, 4) for cb in (8, 16, 32))
#: lrn lowerings whose intermediate values round to bf16 (the JAX
#: package's banded matmul computes in the step's dtype)
AT_BF16_ROUNDING = ("banded_matmul", "cached_residual")


def autotune_step_tolerance(winners, control):
    """The update distance a bf16 step under `winners` may lie from the
    defaults' step: BF16_STEP_RTOL where the winners round as the
    defaults do (the kernels' launch shapes, the pool's lowerings and the
    update's block change no bit; `composed` routes a pool window on its
    rounded LRN values, as K2 writes them); where a winner rounds
    otherwise (an LRN that rounds its intermediates to bf16, a stem that
    packs space to depth or accumulates in f32: conv1's bf16 outputs an
    ulp apart, which every later layer and the max pools' routing carry
    into the update), twice `control`, the distance of the defaults' bf16
    step from their f32 step on the same state and batch: each bf16 step
    lies about that far from the f32 one, so two that round otherwise lie
    within twice it of each other (the triangle inequality). The stem's
    points are held op by op at 2^-7 (autotune_stem_checks)."""
    from veles_tpu_torch.ops import templates
    stem = templates.parse_point("conv_stem", winners.get("conv_stem"))
    pack = stem[1] if stem else {"pack": winners.get("conv_stem", "direct"),
                                 "acc": "native"}
    same = winners.get("lrn") not in AT_BF16_ROUNDING and \
        pack.get("pack") == "direct" and pack.get("acc") == "native"
    return BF16_STEP_RTOL if same else 2 * control


def autotune_stem_checks(dev):
    """Every `conv_stem` point at AlexNet's conv1 (CONV_STEM's inputs:
    batch TB, 227x227x3, 96 kernels 11x11/4, linear), f32 with TF32 off
    and bf16, held against `direct` on the same inputs, an `epi=lrn`
    point with AlexNet's LRN after it (K2/K3 in the point, the plain
    version after `direct`): the forward and the weight and bias
    gradients at CONV_STEM's tolerances (f32: STEM_RTOL, STEM_ATOL, of the
    largest for a gradient; bf16: STEM_BF16 of each value and of the
    largest). Returns {dtype: {point: {y, dw, db: max abs err}}}."""
    from veles_tpu_torch.backends import full_f32
    from veles_tpu_torch.ops import functional as fn
    from veles_tpu_torch.ops import templates, variants
    rs = np.random.RandomState(17)
    x32 = torch.from_numpy(rs.randn(*STEM_X).astype(np.float32)).to(dev)
    w32 = torch.from_numpy(
        (rs.randn(*STEM_W) * 0.01).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(rs.randn(STEM_W[-1]).astype(np.float32)
                           * 0.1).to(dev)
    oh = (HW - STEM_W[0]) // STEM_STRIDE + 1
    g32 = torch.from_numpy(rs.randn(TB, oh, oh, STEM_W[-1]).astype(
        np.float32)).to(dev)
    stride = (STEM_STRIDE, STEM_STRIDE)
    epi = {"k": K, "alpha": ALPHA, "beta": BETA, "n": N}
    (t,) = templates.templates_for("conv_stem")
    rec = {}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, w, b, g = (v.to(dtype) for v in (x32, w32, b32, g32))

        def run(apply, lrn, kw):
            wt = w.detach().requires_grad_(True)
            bt = b.detach().requires_grad_(True)
            with full_f32(dev):
                y = apply(x, wt, bt, stride, (0, 0), "linear", **kw)
                if lrn:
                    y = fn.lrn_forward(y, **epi)
                dw, db = torch.autograd.grad(y, [wt, bt], g)
            return y.detach(), dw, db

        direct = variants.get("conv_stem", "direct").apply
        want = {False: run(direct, False, {}), True: run(direct, True, {})}
        rec[label] = {}
        for cfg in t.configs():
            name = t.name(cfg)
            lrn = cfg["epi"] == "lrn"
            got = run(variants.get("conv_stem", name).apply, False,
                      {"epilogue": epi} if lrn else {})
            errs = {}
            for part, a, e in zip(("y", "dw", "db"), got, want[lrn]):
                a, e = a.float(), e.float()
                top = float(e.abs().max())
                if dtype == torch.float32:
                    rtol = STEM_RTOL
                    atol = STEM_ATOL if part == "y" else STEM_ATOL * top
                else:
                    rtol, atol = STEM_BF16, STEM_BF16 * top
                errs[part] = check_close(
                    f"AUTOTUNE conv_stem {label} {name} vs direct"
                    f"{' + LRN' if lrn else ''} {part}", a, e, rtol, atol)
            rec[label][name] = errs
            del got
        del want
        print(f"AUTOTUNE conv_stem {label}: every point at conv1 "
              f"{STEM_X} * {STEM_W} / {STEM_STRIDE} against direct (an "
              f"epi=lrn point against direct + the plain LRN), y, dw, db "
              f"max abs err {rec[label]} (f32: {STEM_RTOL}*|direct| + "
              f"{STEM_ATOL}, of the largest gradient for dw, db; bf16: "
              f"{STEM_BF16} of each and of the largest)", flush=True)
    torch.cuda.empty_cache()
    return rec


def autotune_smem_checks(libs, kernels):
    """Each generated K2/K3/K4 point's Python footprint (the search's
    pruning reads it) against the kernel's own `*_smem_bytes` at the main
    path's shapes, and K6/K7's at every compiled head width; returns the
    footprints by point."""
    from veles_tpu_torch.ops.functional import pool_out_hw

    def entry(name, n):
        f = getattr(ctypes.CDLL(str(libs[name])), f"{name}_smem_bytes")
        f.argtypes = [ctypes.c_int] * n
        f.restype = ctypes.c_int
        return f

    k2, k3 = entry("lrn_forward", 3), entry("lrn_backward", 3)
    k4 = entry("lrn_maxpool_forward", 12)
    k6, k7 = (entry(f"flash_attention_{d}", 1)
              for d in ("forward", "backward"))
    out, checked = {}, 0
    for _, _, c in LRN_SHAPES:
        for tile in (0,) + AT_TILES:
            for name, f, mirror in (
                    ("lrn_forward", k2, kernels.lrn_forward_smem_bytes),
                    ("lrn_backward", k3, kernels.lrn_backward_smem_bytes)):
                got, want = mirror(c, N // 2, tile), f(c, N // 2, tile)
                if got != want:
                    raise AssertionError(f"AUTOTUNE {name} C {c} tile "
                                         f"{tile}: footprint rule {got} B, "
                                         f"kernel {want} B")
                out[f"{name} C {c} tile {tile}"] = want
                checked += 1
    for h, w, c in LRN_SHAPES:
        geo = (h, w, c, *pool_out_hw(h, w, 3, 3, 2, 2), 3, 3, 2, 2, N // 2)
        for rb, cb in ((0, 0),) + AT_BANDS:
            got = kernels.lrn_maxpool_forward_smem_bytes(*geo, rb, cb)
            want = k4(*geo, rb, cb)
            if got != want:
                raise AssertionError(f"AUTOTUNE lrn_maxpool_forward {h}x{w}"
                                     f"x{c} band {rb}x{cb}: footprint rule "
                                     f"{got} B, kernel {want} B")
            out[f"lrn_maxpool_forward {h}x{w}x{c} band {rb}x{cb}"] = want
            checked += 1
    for d in kernels.FLASH_HEAD_DIMS:
        for name, f, mirror in (
                ("forward", k6, kernels.flash_attention_forward_smem_bytes),
                ("backward", k7,
                 kernels.flash_attention_backward_smem_bytes)):
            if mirror(d) != f(d):
                raise AssertionError(f"AUTOTUNE flash_attention_{name} D "
                                     f"{d}: footprint rule {mirror(d)} B, "
                                     f"kernel {f(d)} B")
            out[f"flash_attention_{name} D {d}"] = f(d)
            checked += 1
    print(f"AUTOTUNE footprints: {checked} points' Python rules equal the "
          f"kernels' *_smem_bytes ({out})", flush=True)
    return out


def autotune_point_times(label, fns, card):
    """Device ms (median of STEM_REPS by CUDA events, the points in turns)
    of each point; prints one line with the card's name and power limit."""
    ms = time_turns(fns)
    print(f"AUTOTUNE {label}: device ms on {card} (median of {STEM_REPS}, "
          f"in turns) " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
          flush=True)
    return ms


def autotune_kernel_phase(libs, kernels, dev, card):
    """Every generated point of K1-K4 against its plain version at the
    main path's shapes (AlexNet's 16 leaves; its LRN and norm->pool
    inputs at batch TB, f32 and bf16) with each kernel's own check (K2-K4:
    the same bits; K1: KERNEL_RTOL), K6/K7 under kv_order=rev and drop=1
    at ATT_SHAPES[0], each footprint rule against its kernel, and each
    point timed. Returns {kernel: {point: ms}} and the footprints."""
    smem = autotune_smem_checks(libs, kernels)
    rs = np.random.RandomState(18)
    times = {}
    # -- K1 -------------------------------------------------------------------
    ps = [torch.from_numpy((0.01 * rs.randn(*sh)).astype(np.float32))
          .to(dev) for sh in LEAVES]
    gs = [torch.from_numpy((1e-3 * rs.randn(*sh)).astype(np.float32))
          .to(dev) for sh in LEAVES]
    vs = [torch.from_numpy((1e-3 * rs.randn(*sh)).astype(np.float32))
          .to(dev) for sh in LEAVES]

    def update(p_list, v_list, threads=None):
        for sh, p, g, v in zip(LEAVES, p_list, gs, v_list):
            if threads is None:
                kernels.sgd_update_plain(p, g, v, leaf_lr(sh), MOMENTUM,
                                         DECAY)
            else:
                kernels.sgd_update(p, g, v, leaf_lr(sh), MOMENTUM, DECAY,
                                   threads=threads)

    pp, vp = [p.clone() for p in ps], [v.clone() for v in vs]
    update(pp, vp)
    work = {}
    for threads in AT_THREADS:
        pk, vk = [p.clone() for p in ps], [v.clone() for v in vs]
        update(pk, vk, threads)
        torch.cuda.synchronize()
        for sh, a, b, c, d in zip(LEAVES, pk, pp, vk, vp):
            check_close(f"AUTOTUNE sgd_update threads {threads} p {sh}", a,
                        b, KERNEL_RTOL, KERNEL_ATOL)
            check_close(f"AUTOTUNE sgd_update threads {threads} v {sh}", c,
                        d, KERNEL_RTOL, KERNEL_ATOL)
        work[f"cuda_rows[threads={threads}]"] = (
            lambda pk=pk, vk=vk, t=threads: update(pk, vk, t))
    print(f"AUTOTUNE sgd_update: each of {len(AT_THREADS)} block sizes on "
          f"AlexNet's {len(LEAVES)} leaves within rtol {KERNEL_RTOL}, atol "
          f"{KERNEL_ATOL} of the plain version", flush=True)
    times["sgd_update"] = autotune_point_times(
        f"sgd_update {len(LEAVES)} leaves", work, card)
    del ps, gs, vs, pp, vp, work
    # -- K2, K3, K4 at AlexNet's shapes, f32 and bf16 -------------------------
    for layer, hwc in zip(("L1", "L2"), LRN_SHAPES):
        shape = (TB,) + hwc
        x32 = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                               .astype(np.float32)).to(dev)
        g32 = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
        for dt, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            x, g = x32.to(dt), g32.to(dt)
            y0 = kernels.lrn_forward_plain(x, K, ALPHA, BETA, N)
            d0 = kernels.lrn_backward_plain(x, g, K, ALPHA, BETA, N)
            z0 = kernels.lrn_maxpool_forward_plain(x, K, ALPHA, BETA, N)
            fwd, bwd, pool = {}, {}, {}
            for tile in AT_TILES:
                assert_same_bits(f"AUTOTUNE lrn_forward{sfx} {layer} tile "
                                 f"{tile}", kernels.lrn_forward(
                                     x, K, ALPHA, BETA, N, tile=tile), y0)
                assert_same_bits(f"AUTOTUNE lrn_backward{sfx} {layer} tile "
                                 f"{tile}", kernels.lrn_backward(
                                     x, g, K, ALPHA, BETA, N, tile=tile), d0)
                fwd[f"tile={tile}"] = (lambda t=tile, x=x: kernels
                                       .lrn_forward(x, K, ALPHA, BETA, N,
                                                    tile=t))
                bwd[f"tile={tile}"] = (lambda t=tile, x=x, g=g: kernels
                                       .lrn_backward(x, g, K, ALPHA, BETA,
                                                     N, tile=t))
            for rb, cb in AT_BANDS:
                assert_same_bits(
                    f"AUTOTUNE lrn_maxpool_forward{sfx} {layer} band {rb}x"
                    f"{cb}", kernels.lrn_maxpool_forward(
                        x, K, ALPHA, BETA, N, rb=rb, cb=cb), z0)
                pool[f"rb={rb},cb={cb}"] = (
                    lambda r=rb, c=cb, x=x: kernels.lrn_maxpool_forward(
                        x, K, ALPHA, BETA, N, rb=r, cb=c))
            print(f"AUTOTUNE {layer} {list(shape)} {dt}: K2 and K3 at "
                  f"tiles {AT_TILES}, K4 at {len(AT_BANDS)} bands: each "
                  f"bit-equal to its plain version", flush=True)
            for name, fns in (("lrn_forward", fwd), ("lrn_backward", bwd),
                              ("lrn_maxpool_forward", pool)):
                ms = autotune_point_times(f"{name}{sfx} {layer}", fns, card)
                for k, v in ms.items():
                    times.setdefault(name + sfx, {}).setdefault(k, 0.0)
                    times[name + sfx][k] += v
            del y0, d0, z0, fwd, bwd, pool, x, g
        del x32, g32
        torch.cuda.empty_cache()
    # -- K6 / K7 under kv_order=rev and drop=1 --------------------------------
    shape = ATT_SHAPES[0]
    q, k, v, g = (heads_first(torch.from_numpy(
        rs.randn(*shape).astype(np.float32)).to(dev)) for _ in range(4))
    mask = (torch.from_numpy((rs.random_sample(q.shape) < 0.9)
                             .astype(np.float32)) / 0.9).to(dev)
    fwd, bwd = {}, {}
    for kv in ("fwd", "rev"):
        for drop in (0, 1):
            m = mask if drop else None
            name = f"kv_order={kv},drop={drop}"
            ok, lk = kernels.flash_attention_forward(q, k, v, True, None,
                                                     kv, m)
            op, lp = kernels.flash_attention_forward_plain(q, k, v, True,
                                                           None, kv, m)
            check_close(f"AUTOTUNE flash_attention_forward {name} O", ok,
                        op, FLASH_FWD_RTOL, FLASH_FWD_ATOL)
            check_close(f"AUTOTUNE flash_attention_forward {name} lse", lk,
                        lp, FLASH_FWD_RTOL, FLASH_FWD_ATOL)
            fwd[name] = (lambda kv=kv, m=m: kernels.flash_attention_forward(
                q, k, v, True, None, kv, m))
            if kv == "fwd":
                do = g if m is None else g * m
                di = torch.sum(g * op, dim=-1, keepdim=True)
                got = kernels.flash_attention_backward(q, k, v, do, lp, di,
                                                       True)
                want = kernels.flash_attention_backward_plain(
                    q, k, v, do, lp, di, True)
                for nm, a, b in zip(("dq", "dk", "dv"), got, want):
                    check_close(f"AUTOTUNE flash_attention_backward drop="
                                f"{drop} {nm}", a, b, FLASH_BWD_RTOL,
                                FLASH_BWD_ATOL)
                bwd[f"drop={drop}"] = (
                    lambda do=do, di=di, lp=lp: kernels
                    .flash_attention_backward(q, k, v, do, lp, di, True))
            del ok, lk, op
    print(f"AUTOTUNE flash {list(shape)} causal: K6 at kv_order fwd and "
          f"rev, with and without the dropout mask, and K7 with and "
          f"without it, within the FLASH tolerances of their plain "
          f"versions", flush=True)
    times["flash_attention_forward"] = autotune_point_times(
        f"flash_attention_forward {list(shape)}", fwd, card)
    times["flash_attention_backward"] = autotune_point_times(
        f"flash_attention_backward {list(shape)}", bwd, card)
    del q, k, v, g, mask, fwd, bwd
    torch.cuda.empty_cache()
    return times, smem


def autotune_want(step, n_train, n_eval):
    """The launches `n_train` train steps and `n_eval` evaluations of
    `step` make, from its plan: K4/K5 per claimed (LRN, pool) pair, K2/K3
    per LRN on a kernel lowering (a stem's epilogue included), in the
    instance of the point's io (io=f32: the f32 one), K1 per SGD leaf per
    train step; nothing else."""
    from veles_tpu_torch.ops import optim, templates
    bf16 = step.compute_dtype == "bfloat16"
    fwd, bwd = {}, {}

    def add(table, name, io):
        inst = name + ("_bf16" if bf16 and io != "f32" else "")
        table[inst] = table.get(inst, 0) + 1

    for i, (kind, _, v) in enumerate(step.fwd._plan):
        if v is None or kind == "skip":
            continue
        parsed = templates.parse_point(v.op, v.name)
        io = parsed[1].get("io", "native") if parsed else "native"
        if kind == "pair" and step.forwards[i].variant_op == "lrn":
            add(fwd, "lrn_maxpool_forward", io)
            add(bwd, "lrn_maxpool_backward", io)
        elif (kind == "pair" and v.op == "conv_stem") \
                or (v.op == "lrn" and v.kernel):
            add(fwd, "lrn_forward", io)
            add(bwd, "lrn_backward", io)
    want = {k: n * (n_train + n_eval) for k, n in fwd.items()}
    want.update({k: n * n_train for k, n in bwd.items()})
    if step._sgd.kernel:
        leaves = sum(len(p) for p, c in zip(step.fwd.params(), step.cfgs)
                     if isinstance(c, optim.SGDConfig))
        want["sgd_update"] = leaves * n_train
    return want


def autotune_table_faults(step, table, winners):
    """Where the step's variant table does not name what the winners
    run: the stem, the pool after conv5 and the update their winners; the
    LRN->pool op its winner where that is a fused point (else no entry);
    the LRN op its winner where an LRN unit is left unclaimed."""
    from veles_tpu_torch.ops import variants
    want = {op: winners[op] for op in ("conv_stem", "maxpool", "sgd_update")}
    if variants.get("lrn_maxpool", winners["lrn_maxpool"]).fused:
        want["lrn_maxpool"] = winners["lrn_maxpool"]
    elif "lrn_maxpool" in table:
        return {"lrn_maxpool": table["lrn_maxpool"]}
    claimed = {k for i, j, _ in step.fwd.pairs for k in (i, j)}
    if any(u.variant_op == "lrn" and i not in claimed
           for i, u in enumerate(step.forwards)):
        want["lrn"] = winners["lrn"]
    return {op: (table.get(op), name) for op, name in want.items()
            if table.get(op) != name}


def autotune_run(launcher, kernels, dev, label, argv):
    """One `launcher.train(argv)` run, the launch counters zeroed just
    before it and read just after; (workflow, counts, train steps,
    evaluations, the last step built)."""
    from veles_tpu_torch.ops import autotune
    with timed_steps() as events, watched_steps() as seen:
        t0 = time.perf_counter()
        before = dict(autotune.TIMINGS)
        kernels.reset_launch_counts()
        wf = launcher.train(argv)
        counts = kernels.launch_counts()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    timings = {k: autotune.TIMINGS[k] - before[k] for k in before}
    n_train = sum(1 for kind, _, _ in events if kind == "train")
    n_eval = sum(1 for kind, _, _ in events if kind == "evaluate")
    print(f"AUTOTUNE {label}: {wall:.2f} s of host time; timing calls "
          f"{timings}; {n_train} train steps and {n_eval} evaluations "
          f"outside the search; launches {counts}", flush=True)
    if not np.isfinite(wf.evaluator.loss):
        raise AssertionError(f"AUTOTUNE {label}: non-finite loss")
    return wf, counts, timings, seen["steps"][-1], n_train, n_eval


def autotune_search_phase(launcher, kernels, dev):
    """The full-width bf16 AlexNet through `launcher.train` with `--fused
    --autotune --autotune-budget AT_BUDGET` at batch AT_BATCH and a fresh
    cache: a winner and its timings for each of AT_OPS, every timed trial
    gated, no point failing to launch; again with the same cache: no
    timing call, the same winners; then a plain `--fused` run: its table
    names the winners and it launches exactly their kernels; and one
    step under the winners against one under the defaults from one state
    on one batch. Returns the record."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import templates, variants
    from veles_tpu_torch.samples import alexnet
    argv = [ALEXNET, "--fused", "-r", "1234", *AT_ARGS, *TRAIN_ARGS]
    rec = {}
    saved_env = os.environ.get("VELES_AUTOTUNE_CACHE")
    os.makedirs(OUT, exist_ok=True)
    work = tempfile.mkdtemp(prefix="autotune_", dir=OUT)
    os.environ["VELES_AUTOTUNE_CACHE"] = os.path.join(work, "autotune.json")
    try:
        with precision_type_kept(), alexnet_config_kept():
            wf, counts, timings, _, _, _ = autotune_run(
                launcher, kernels, dev, "search",
                argv + ["--autotune", "--autotune-budget", str(AT_BUDGET)])
        report = wf.autotune_report
        del wf
        timed = passed = 0
        for op in AT_OPS:
            r = report.get(op) or {}
            if r.get("source") != "searched" or not r.get("timings_s"):
                raise AssertionError(f"AUTOTUNE search: no timed winner for "
                                     f"{op}: {r}")
            for t in r["trace"]:
                if t["outcome"] == "error":
                    raise AssertionError(f"AUTOTUNE search: {op}/"
                                         f"{t['variant']} failed: "
                                         f"{t['error']}")
                if t["outcome"] == "timed":
                    timed += 1
                    passed += templates.passed(op, t["variant"])
            print(f"AUTOTUNE search {op}: winner {r['variant']} "
                  f"({r['timer']}), trials {r['trials']}/{r['budget']}, "
                  f"outcomes {r['outcomes']}, pruned {r['pruned']}, "
                  f"aliases {r['aliases']}, ms "
                  + ", ".join(f"{k} {v * 1e3:.4f}"
                              for k, v in r["timings_s"].items()),
                  flush=True)
        if passed != timed:
            raise AssertionError(f"AUTOTUNE search: {timed - passed} of "
                                 f"{timed} timed trials had no passing "
                                 f"ledger record")
        print(f"AUTOTUNE search: {timed} timed trials, each with a passing "
              f"ledger record (budget {AT_BUDGET}, batch {AT_BATCH})",
              flush=True)
        winners = {op: report[op]["variant"] for op in report}
        rec["search"] = {"winners": winners, "timed_trials": timed,
                         "timings": timings,
                         "report": {op: {k: r.get(k) for k in (
                             "variant", "source", "timings_s", "outcomes",
                             "pruned", "aliases", "trials", "budget",
                             "timer")} for op, r in report.items()}}
        # -- a rerun: every winner from the cache, no timing call ----------
        variants.clear_selection()
        templates.clear_ledger()
        with precision_type_kept(), alexnet_config_kept():
            wf, _, timings, _, _, _ = autotune_run(
                launcher, kernels, dev, "cache hit",
                argv + ["--autotune", "--autotune-budget", str(AT_BUDGET)])
        again = {op: r["variant"] for op, r in wf.autotune_report.items()}
        del wf
        if any(timings.values()) or again != winners:
            raise AssertionError(f"AUTOTUNE cache hit: timing calls "
                                 f"{timings}, winners {again} (searched "
                                 f"{winners})")
        print(f"AUTOTUNE cache hit: no timing call, the same winners "
              f"{again}", flush=True)
        # -- a plain --fused run applies the winners -----------------------
        variants.clear_selection()
        with precision_type_kept(), alexnet_config_kept():
            wf, counts, timings, step, n_train, n_eval = autotune_run(
                launcher, kernels, dev, "plain --fused", argv)
        selected = wf.autotune_applied
        if variants.selection_table():
            raise AssertionError(f"AUTOTUNE plain --fused: the run left "
                                 f"{variants.selection_table()} selected")
        table = step.variant_table()
        want = autotune_want(step, n_train, n_eval)
        if any(timings.values()):
            raise AssertionError(f"AUTOTUNE plain --fused timed {timings}")
        for op, name in winners.items():
            if selected.get(op) != name:
                raise AssertionError(f"AUTOTUNE plain --fused: {op} "
                                     f"applied {selected.get(op)}, the "
                                     f"cache's winner is {name}")
        if autotune_table_faults(step, table, winners):
            raise AssertionError(
                f"AUTOTUNE plain --fused: table {table} does not name the "
                f"winners {winners}: "
                f"{autotune_table_faults(step, table, winners)}")
        check_counts("AUTOTUNE plain --fused", counts, want)
        print(f"AUTOTUNE plain --fused: variant table {table}; launches "
              f"exactly the winners' kernels {want} ({n_train} train "
              f"steps, {n_eval} evaluations)", flush=True)
        rec["plain_fused"] = {"table": table, "launches": counts}
        del wf, step
        torch.cuda.empty_cache()
        # -- one step under the winners against the same step through the
        # plain versions, and against one under the defaults ---------------
        prng.seed_all(1234)
        wf = alexnet.create_workflow()
        wf.initialize(dev)
        for op, name in winners.items():
            variants.select(op, name)
        tuned = wf.build_fused_step(compute_dtype="bfloat16")
        variants.clear_selection()
        default = wf.build_fused_step(compute_dtype="bfloat16")
        default32 = wf.build_fused_step(compute_dtype="float32")
        state0 = default.init_state()
        x, y, w = card_batch(dev, TB, 91)
        after = {}
        for label, step in (("winners", tuned), ("plain", tuned),
                            ("defaults", default),
                            ("defaults_f32", default32)):
            after[label] = copy_state(state0)
            step.gen = torch.Generator(dev).manual_seed(5)
            with plain_kernels(kernels) if label == "plain" \
                    else contextlib.nullcontext():
                step.train(after[label], x, y, w)
        torch.cuda.synchronize()
        # the control: how far the defaults' bf16 rounding puts their
        # update from the f32 step's
        control = update_distance(state0, after["defaults"],
                                  after["defaults_f32"])
        rec["step_distance"] = {"control_defaults_vs_f32": control,
                                "winners_vs_f32": update_distance(
                                    state0, after["winners"],
                                    after["defaults_f32"])}
        for other, tol in (("plain", BF16_STEP_RTOL),
                           ("defaults", autotune_step_tolerance(
                               winners, max(control.values())))):
            dist = update_distance(state0, after["winners"], after[other])
            if max(dist.values()) > tol:
                raise AssertionError(f"AUTOTUNE winners' step against the "
                                     f"{other}' step: update distance "
                                     f"{dist} beyond {tol}")
            rec["step_distance"][other] = {"distance": dist,
                                           "tolerance": tol}
        print(f"AUTOTUNE winners' step ({tuned.variant_table()}) from one "
              f"state on one batch of {TB}: update distance to the same "
              f"step through the plain versions "
              f"{rec['step_distance']['plain']}, to the defaults' step "
              f"({default.variant_table()}) "
              f"{rec['step_distance']['defaults']}; the control, the "
              f"defaults' bf16 step against their f32 step, {control}; the "
              f"winners' against the f32 step "
              f"{rec['step_distance']['winners_vs_f32']}", flush=True)
        del wf, tuned, default, default32, state0, after, x, y, w
    finally:
        variants.clear_selection()
        templates.clear_ledger()
        if saved_env is None:
            os.environ.pop("VELES_AUTOTUNE_CACHE", None)
        else:
            os.environ["VELES_AUTOTUNE_CACHE"] = saved_env
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts, rec


# ---------------------------------------------------------------------------
# SERVE WIRES: the bf16 and int8 wires, the merge core, hot swap, rollback
# and the watcher over a snapshot mirror, at full width
# ---------------------------------------------------------------------------

#: (wire, lrn_maxpool setting) of each served ring; the instance of K2/K4
#: each must launch, two a ring round (AlexNet's two LRN -> pool pairs)
WIRE_RUNS = (("f32", "fused", "lrn_maxpool_forward"),
             ("bf16", "fused", "lrn_maxpool_forward_bf16"),
             ("int8", "fused", "lrn_maxpool_forward"),
             ("bf16", "composed", "lrn_forward_bf16"))
#: the int8 wire's block (the JAX package's, along a leaf's last axis)
INT8_BLOCK = 64
#: a wire's served logits against its plain forward's on the card (the
#: same parameters decoded by the plain functions, every LRN through its
#: plain version, no fused pair): at most this many machine epsilons of
#: the wire's compute type (f32 for f32 and int8, bf16 for bf16) times
#: the largest reference logit, i.e. at most two ulps of that logit;
#: both sides run the same arithmetic, and K2/K4 are bit-equal to their
#: plain versions
LOGIT_ULPS = 1
#: that bound at most this share of how far the logits move when every
#: LRN is left out (what a K2/K4 that skipped its normalisation serves)
LRN_SIGNAL_SHARE = 0.1
#: a swapped-in or watcher-applied generation's logits at least this many
#: logit bounds from the boot generation's: the check tells the params
#: apart
MOVED_X = 100
#: a non-f32 wire against the f32 wire's outputs (the JAX rule)
WIRE_F32_TOL = 0.05
#: the merge core's requests and the buckets they must run at
MERGE_ROWS, MERGE_BUCKETS = (1, 3, 8), [1, 4, 8]
#: the watcher's poll period in this phase (seconds)
WATCH_POLL_S = "1"


def wire_ring_ms(srv, reps: int = 10) -> float:
    """Device ms of one ring round's forward through the wire (mean of
    `reps` after a warm-up; CUDA events)."""
    x = torch.from_numpy(np.random.RandomState(4).randn(
        srv.ring_slots, HW, HW, 3).astype(np.float32)).to(srv.device)
    params = srv._gens.params
    srv._serve(params, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        srv._serve(params, x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def serve_wire_run(launcher, kernels, dev, snap, wire, setting, want,
                   requests, extra=()):
    """Serve the full-width AlexNet of snapshot `snap` through `wire`
    under `setting`: each request answered, held against the plain
    forward through the wire, exact launches of `want` on the main path,
    the bytes and the ring's device ms. Returns (server, (outputs,
    logits), launches, record); the caller stops the server."""
    t0 = time.perf_counter()
    srv = launcher.serve([ALEXNET, "--serve", "0", "-s", snap,
                          "--lrn-maxpool", setting, "--serve-ring", str(B),
                          "--serve-quantize", wire, "--serve-max-body",
                          str(1 << 30), *extra, *SERVE_ARGS])
    try:
        up = time.perf_counter() - t0
        if srv.device != dev:
            raise AssertionError(f"served on {srv.device}, not {dev}")
        url = f"http://127.0.0.1:{srv.port}"
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        outs = []
        for x in requests:
            status, resp, dt = post(url, x)
            if status != 200:
                raise AssertionError(f"/predict answered {status}")
            outs.append(np.asarray(resp["outputs"], np.float64))
        counts = kernels.launch_counts()
        launched = {k: c for k, c in counts.items() if c}
        if launched != {want: 2 * len(requests)}:
            raise AssertionError(f"SERVE WIRES {wire} {setting}: launches "
                                 f"{launched}, not {want} twice a round")
        # -- checks off the main path
        errs, zerrs, tols, signals, spreads, logits = [], [], [], [], [], []
        for x, out in zip(requests, outs):
            if out.shape != (len(x), N_CLASSES) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"outputs {out.shape}, finite "
                                     f"{np.isfinite(out).all()}")
            xf = x.astype(np.float32)
            ref, ref_z = plain_forward(srv, kernels, xf)
            z = served_logits(srv, xf)
            logits.append(z)
            errs.append(float(np.abs(out - ref).max()))
            zerrs.append(float(np.abs(z - ref_z).max()))
            tols.append(logit_tol(wire, ref_z))
            signals.append(float(np.abs(plain_forward(
                srv, kernels, xf, lrn=False)[1] - ref_z).max()))
            spreads.append(float(np.abs(out - 1 / N_CLASSES).max()))
        tol, signal = min(tols), min(signals)
        if max(errs) > SERVE_ATOL or max(zerrs) > tol \
                or tol > LRN_SIGNAL_SHARE * signal:
            raise AssertionError(
                f"SERVE WIRES {wire} {setting}: served vs plain forward "
                f"{errs} (> {SERVE_ATOL}?), logits {zerrs} (> {tol}?), the "
                f"bound against {LRN_SIGNAL_SHARE} of the LRN's {signal}")
        info = srv.model_info()
        ms = wire_ring_ms(srv)
        rec = {"wire": wire, "setting": setting, "up_s": up,
               "launches": launched, "max_abs_err_vs_plain": max(errs),
               "tolerance": SERVE_ATOL, "logit_err_vs_plain": max(zerrs),
               "logit_tolerance": tol, "logits_without_lrn_moved": signal,
               "outputs_from_uniform": max(spreads),
               "param_bytes": info["param_bytes"], "ring_ms": ms,
               "variants": info["variants"]}
        print(f"SERVE WIRES {wire} {setting}: up in {up:.2f} s; "
              f"{'/'.join(str(len(x)) for x in requests)} rows -> 200, "
              f"launches {launched}; vs plain forward through the wire: "
              f"outputs max abs err {max(errs):.3e} (tolerance "
              f"{SERVE_ATOL}; the outputs at most {max(spreads):.3e} from "
              f"1/{N_CLASSES}), logits max abs err {max(zerrs):.3e} "
              f"(tolerance {tol:.3e}: {LOGIT_ULPS} epsilon of the wire's "
              f"type times the largest logit; every LRN left out moves "
              f"them {signal:.3e}); "
              f"params {info['param_bytes']['wire']} B on the wire, "
              f"{info['param_bytes']['f32']} B in f32; ring of {B} "
              f"{ms:.4f} device ms", flush=True)
        return srv, (outs, logits), counts, rec
    except BaseException:
        srv.stop()
        raise


def merge_run(launcher, kernels, dev, snap):
    """--serve-dispatch merge --serve-batch 8 on snapshot `snap`: 1, 3 and
    8 rows run at buckets 1, 4 and 8, one dispatch each, against the
    plain forward."""
    srv = launcher.serve([ALEXNET, "--serve", "0", "-s", snap,
                          "--lrn-maxpool", "fused", "--serve-dispatch",
                          "merge", "--serve-batch", str(MERGE_BUCKETS[-1]),
                          "--serve-max-body", str(1 << 30), *SERVE_ARGS])
    try:
        url = f"http://127.0.0.1:{srv.port}"
        shapes = []
        inner = srv._forward_now

        def counted(x):
            shapes.append(len(x))
            return inner(x)

        srv._forward_now = counted
        rs = np.random.RandomState(6)
        requests = [rs.randn(n, HW, HW, 3).round(3) for n in MERGE_ROWS]
        before = srv.n_dispatches
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        outs = []
        for x in requests:
            status, resp, _ = post(url, x)
            if status != 200:
                raise AssertionError(f"merge /predict answered {status}")
            outs.append(np.asarray(resp["outputs"], np.float64))
        counts = kernels.launch_counts()
        launched = {k: c for k, c in counts.items() if c}
        if shapes != MERGE_BUCKETS or srv.n_dispatches - before != 3 \
                or launched != {"lrn_maxpool_forward": 6}:
            raise AssertionError(f"merge: buckets {shapes}, dispatches "
                                 f"{srv.n_dispatches - before}, launches "
                                 f"{launched}")
        errs, zerrs, tols = [], [], []
        for x, out, b in zip(requests, outs, MERGE_BUCKETS):
            xf = x.astype(np.float32)
            ref, ref_z = plain_forward(srv, kernels, xf, rows=b)
            errs.append(float(np.abs(out - ref).max()))
            zerrs.append(float(np.abs(served_logits(srv, xf, rows=b)
                                      - ref_z).max()))
            tols.append(logit_tol("f32", ref_z))
        if max(errs) > SERVE_ATOL or max(zerrs) > min(tols):
            raise AssertionError(f"merge vs plain forward {errs}, logits "
                                 f"{zerrs} (> {min(tols)}?)")
        print(f"SERVE WIRES merge: {list(MERGE_ROWS)} rows -> buckets "
              f"{shapes}, {srv.n_dispatches - before} dispatches, launches "
              f"{launched}; vs plain forward max abs err {max(errs):.3e} "
              f"(tolerance {SERVE_ATOL}), logits {max(zerrs):.3e} "
              f"(tolerance {min(tols):.3e})", flush=True)
        return counts, {"rows": list(MERGE_ROWS), "buckets": shapes,
                        "launches": launched, "max_abs_err": max(errs),
                        "logit_err": max(zerrs)}
    finally:
        srv.stop()


def served_snapshot(dev, directory: str) -> str:
    """The full-width AlexNet SERVE WIRES serves, as an uncompressed
    snapshot in `directory`: seed 1234, init="scaled" (Kaiming convs,
    LeCun FC). Its logits follow the input through every layer; under the
    sample's reference stddevs they hardly depend on it, and its
    near-uniform outputs would hide a wrong LRN."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.snapshotter import Snapshotter
    prng.seed_all(1234)
    wf = alexnet.create_workflow(init="scaled")
    wf.initialize(dev)
    return Snapshotter(wf, prefix="alexnet_scaled", directory=directory,
                       compression="").export()


def candidate_alexnet(snap: str, factor: float):
    """The served snapshot's AlexNet with every parameter times `factor`
    (on the host, as a watcher's import leaves it)."""
    from veles_tpu_torch.snapshotter import Snapshotter
    wf = Snapshotter.import_(snap, restore_prng=False)
    with torch.no_grad():
        for u in wf.forwards:
            for t in u.param_arrays().values():
                t.mul_(factor)
    return wf


class Hammer:
    """A thread posting 1-row requests until stopped, keeping each
    status: requests must keep getting 200 through swaps and refusals."""

    def __init__(self, url, x):
        self.url, self.x, self.statuses = url, x, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            try:
                self.statuses.append(post(self.url, self.x)[0])
            except urllib.error.HTTPError as e:
                self.statuses.append(e.code)
            except Exception as e:  # noqa: BLE001 — recorded, then fails
                self.statuses.append(repr(e))

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(120)
        if self.thread.is_alive():
            raise AssertionError("request thread still running")


def swap_checks(srv, kernels, dev, snap):
    """On the f32 ring: a perturbed AlexNet (params x 1.01) swapped in
    answers as the plain forward of the candidate's own params, its
    logits at least MOVED_X logit bounds from the boot generation's;
    /rollback restores the boot's outputs and logits bit for bit; a NaN
    candidate and a geometry mismatch are refused while requests keep
    getting 200."""
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.serving import SwapRefused
    url = f"http://127.0.0.1:{srv.port}"
    x = np.random.RandomState(9).randn(8, HW, HW, 3).round(3)
    xf = x.astype(np.float32)
    status, resp, _ = post(url, x)
    before = resp["outputs"]
    z_boot = served_logits(srv, xf)
    boot = srv.generation()
    cand = candidate_alexnet(snap, 1.01)
    ref, ref_z = plain_forward(srv, kernels, xf, params=cand.params_host())
    tol = logit_tol("f32", ref_z)
    t0 = time.perf_counter()
    with Hammer(url, x[:1]) as h:
        gen = srv.swap_params(cand, source="chip_smoke")
        swap_s = time.perf_counter() - t0
        status, resp, _ = post(url, x)
        swapped = np.asarray(resp["outputs"], np.float64)
        z_swap = served_logits(srv, xf)
        req = urllib.request.Request(url + "/rollback", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            rb = json.loads(r.read())["generation"]
        status, resp, _ = post(url, x)
        restored = resp["outputs"]
        z_back = served_logits(srv, xf)
        refusals = {}
        # the candidate's own tensors: the server placed copies of them
        with torch.no_grad():
            next(iter(cand.forwards[0].param_arrays().values())).fill_(
                float("nan"))
        # the toy AlexNet with a head of its own: another geometry
        toy = alexnet.create_workflow(**dict(
            TOY_ARGS, n_classes=TOY_ARGS["n_classes"] + 1))
        toy.initialize(dev)
        for name, wf in (("nan", cand), ("geometry", toy)):
            try:
                srv.swap_params(wf)
                refusals[name] = "applied"
            except SwapRefused as e:
                refusals[name] = e.reason
        del toy
        live = srv.generation()
    codes = sorted(set(map(str, h.statuses)))
    err = float(np.abs(swapped - ref).max())
    zerr = float(np.abs(z_swap - ref_z).max())
    moved = float(np.abs(z_swap - z_boot).max())
    back = restored == before and np.array_equal(z_back, z_boot)
    print(f"SERVE WIRES swap: params x 1.01 swapped in {swap_s:.2f} s "
          f"(generation {gen['digest'][:12]}), 8 rows vs the plain forward "
          f"of the candidate's params: outputs max abs err {err:.3e} "
          f"(tolerance {SERVE_ATOL}), logits {zerr:.3e} (tolerance "
          f"{tol:.3e}), the logits moved {moved:.3e} from boot (at least "
          f"{MOVED_X} x {tol:.3e}); /rollback -> {rb['digest'][:12]} "
          f"({rb['source']}), outputs and logits bit for bit the boot's: "
          f"{back}; refused {refusals}; {len(h.statuses)} requests "
          f"meanwhile, statuses {codes}", flush=True)
    if err > SERVE_ATOL or zerr > tol or moved < MOVED_X * tol \
            or gen["digest"] == boot["digest"] \
            or rb["digest"] != boot["digest"] or not back \
            or refusals != {"nan": "nonfinite", "geometry": "geometry"} \
            or live["digest"] != boot["digest"] or codes != ["200"]:
        raise AssertionError(f"SERVE WIRES swap: err {err}, logits {zerr} "
                             f"(tolerance {tol}), moved {moved}, rollback "
                             f"{rb}, bits back {back}, refusals {refusals}, "
                             f"live {live}, statuses {codes}")
    del cand
    torch.cuda.empty_cache()
    return {"swap_s": swap_s, "max_abs_err_vs_plain": err,
            "logit_err_vs_plain": zerr, "logit_tolerance": tol,
            "logits_moved_from_boot": moved, "rollback_bits_equal": back,
            "refusals": refusals, "requests_meanwhile": len(h.statuses)}


def watcher_check(srv, kernels, snap, mirror_dir):
    """The ring's WeightWatcher (--serve-watch-mirror) applies an AlexNet
    snapshot an earlier phase wrote, pushed to a DirMirror: the served
    generation becomes the snapshot's sidecar digest and answers as the
    plain forward of the snapshot's own params, its logits at least
    MOVED_X logit bounds from the generation before."""
    from veles_tpu_torch.resilience.mirror import DirMirror
    from veles_tpu_torch.snapshotter import Snapshotter
    url = f"http://127.0.0.1:{srv.port}"
    x = np.random.RandomState(10).randn(1, HW, HW, 3).round(3)
    xf = x.astype(np.float32)
    z_prev = served_logits(srv, xf)
    with open(snap + ".sha256") as f:
        digest = f.read().split()[0]
    t0 = time.perf_counter()
    if not DirMirror(mirror_dir).push(snap):
        raise AssertionError("the snapshot mirror push did not verify")
    push_s = time.perf_counter() - t0
    deadline = time.time() + 300
    while srv.generation()["digest"] != digest and time.time() < deadline:
        time.sleep(0.2)
    applied_s = time.perf_counter() - t0
    gen = srv.generation()
    st = srv.watcher.status()
    status, resp, _ = post(url, x)
    ref, ref_z = plain_forward(
        srv, kernels, xf,
        params=Snapshotter.import_(snap, restore_prng=False).params_host())
    tol = logit_tol("f32", ref_z)
    err = float(np.abs(np.asarray(resp["outputs"], np.float64)
                       - ref).max())
    z = served_logits(srv, xf)
    zerr = float(np.abs(z - ref_z).max())
    moved = float(np.abs(z - z_prev).max())
    print(f"SERVE WIRES watcher: {os.path.basename(snap)} "
          f"({os.path.getsize(snap)} bytes) pushed to a DirMirror in "
          f"{push_s:.2f} s, applied {applied_s:.2f} s after the push start "
          f"as generation {gen['digest'][:12]} ({gen['source']}); watcher "
          f"{ {k: st[k] for k in ('n_polls', 'n_applied', 'n_refused')} }; "
          f"1 row -> {status}, vs the plain forward of the snapshot's "
          f"params: outputs max abs err {err:.3e} (tolerance {SERVE_ATOL}), "
          f"logits {zerr:.3e} (tolerance {tol:.3e}), the logits moved "
          f"{moved:.3e} from the generation before (at least {MOVED_X} x "
          f"{tol:.3e})", flush=True)
    if gen["digest"] != digest or gen["source"] != "watcher" \
            or status != 200 or err > SERVE_ATOL or zerr > tol \
            or moved < MOVED_X * tol:
        raise AssertionError(f"SERVE WIRES watcher: generation {gen}, "
                             f"status {st}, err {err}, logits {zerr} "
                             f"(tolerance {tol}), moved {moved}")
    return {"snapshot_bytes": os.path.getsize(snap), "push_s": push_s,
            "applied_s": applied_s, "watcher": st,
            "max_abs_err_vs_plain": err, "logit_err_vs_plain": zerr,
            "logit_tolerance": tol, "logits_moved": moved}


def serve_wires_phase(launcher, kernels, dev, snap):
    """SERVE WIRES: the full-width AlexNet of `served_snapshot` on a
    64-row ring through each wire (f32, bf16, int8 under fused; bf16
    also under composed), each non-f32 wire within WIRE_F32_TOL of the
    f32 wire; the merge core; on the f32 ring (with its watcher) hot
    swap, rollback and refusals, then the watcher applying `snap`
    (RESUME's snapshot). Returns (launches by path, the record)."""
    served = tempfile.mkdtemp(prefix="veles_served_alexnet_")
    mirror_dir = os.path.join(OUT, "serve_mirror")
    shutil.rmtree(mirror_dir, ignore_errors=True)
    os.makedirs(mirror_dir)
    launches, rec, outs = {}, {"wires": []}, {}
    prev_poll = os.environ.get("VELES_WATCH_POLL_S")
    os.environ["VELES_WATCH_POLL_S"] = WATCH_POLL_S
    try:
        boot = served_snapshot(dev, served)
        rs = np.random.RandomState(2)
        requests = [rs.randn(n, HW, HW, 3).round(3) for n in (1, 8)]
        for wire, setting, want in WIRE_RUNS:
            first = wire == "f32"
            srv, out, counts, r = serve_wire_run(
                launcher, kernels, dev, boot, wire, setting, want, requests,
                ("--serve-watch-mirror", mirror_dir) if first else ())
            try:
                launches[f"serve_wires_{wire}_{setting}"] = counts
                outs[(wire, setting)] = out
                if first:
                    r["swap"] = swap_checks(srv, kernels, dev, boot)
                    r["watcher"] = watcher_check(srv, kernels, snap,
                                                 mirror_dir)
            finally:
                srv.stop()
                del srv
                torch.cuda.empty_cache()
            if not first:
                (p, z), (pf, zf) = out, outs[("f32", "fused")]
                d = max(float(np.abs(a - b).max()) for a, b in zip(p, pf))
                dz = max(float(np.abs(a - b).max()) for a, b in zip(z, zf))
                scale = max(float(np.abs(b).max()) for b in zf)
                r["max_abs_vs_f32_wire"] = d
                r["logits_vs_f32_wire"] = dz
                print(f"SERVE WIRES {wire} {setting}: vs the f32 wire max "
                      f"abs difference {d:.3e} (tolerance {WIRE_F32_TOL}); "
                      f"logits {dz:.3e} (the f32 logits' largest "
                      f"magnitude {scale:.3e})", flush=True)
                if d > WIRE_F32_TOL:
                    raise AssertionError(f"{wire} wire {d} from f32")
            rec["wires"].append(r)
        launches["serve_wires_merge"], rec["merge"] = merge_run(
            launcher, kernels, dev, boot)
    finally:
        if prev_poll is None:
            os.environ.pop("VELES_WATCH_POLL_S", None)
        else:
            os.environ["VELES_WATCH_POLL_S"] = prev_poll
        shutil.rmtree(mirror_dir, ignore_errors=True)
        shutil.rmtree(served, ignore_errors=True)
    return launches, rec


#: FLEET: the router's beacon TTL in the phase (the default is 20 s), and
#: the rows of its 16 requests
FLEET_TTL_S = 5.0
FLEET_ROWS = (1, 2, 3, 4, 5, 6, 7, 8, 8, 7, 6, 5, 4, 3, 2, 1)
#: the native engine against the card's served softmax (the JAX
#: package's engine-vs-golden tolerance)
NATIVE_RTOL, NATIVE_ATOL = 3e-4, 3e-5


def host_cpu() -> str:
    """The host CPU's model name, architecture and logical cores (beside
    every host time)."""
    import platform
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    name = next((info[k] for k in ("model name", "cpu model", "hardware")
                 if info.get(k)), "")
    if not name and info.get("vendor_id"):
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return (f"{name or platform.processor() or 'CPU model not reported'}, "
            f"{platform.machine()}, {os.cpu_count()} logical cores")


def fleet_idle(servers, timeout=120.0) -> None:
    """Wait until no replica has a request in flight or queued (a hedged
    duplicate may still be running when its client got the answer)."""
    deadline = time.time() + timeout
    while any(s.health()["inflight"] or s.health()["pending"]
              for s in servers):
        if time.time() > deadline:
            raise AssertionError("FLEET: replicas never went idle")
        time.sleep(0.05)


def fleet_requests(router, servers, kernels, rs):
    """16 requests of 1-8 rows through the router, the counts zeroed just
    before and read just after: every one answered 200, both replicas
    dispatched, K4 exactly twice each replica's round and nothing else;
    then each answer against the plain forward, and the same requests
    straight to a replica (the router's added host ms)."""
    url = f"http://127.0.0.1:{router.port}"
    xs = [rs.randn(n, HW, HW, 3).round(3) for n in FLEET_ROWS]
    reqs0 = [s.n_requests for s in servers]
    rounds0 = [s.n_dispatches for s in servers]
    hedged0 = router.n_hedged
    kernels.reset_launch_counts()
    outs, t_router = [], []
    for x in xs:
        status, resp, dt = post(url, x)
        if status != 200:
            raise AssertionError(f"FLEET: the router answered {status}")
        outs.append(np.asarray(resp["outputs"], np.float64))
        t_router.append(dt)
    fleet_idle(servers)
    counts = kernels.launch_counts()
    rounds = [s.n_dispatches - r for s, r in zip(servers, rounds0)]
    spread = [s.n_requests - r for s, r in zip(servers, reqs0)]
    hedged = router.n_hedged - hedged0
    want = {name: 0 for name in counts}
    want["lrn_maxpool_forward"] = 2 * sum(rounds)
    print(f"FLEET requests: {len(xs)} of {min(FLEET_ROWS)}-{max(FLEET_ROWS)} "
          f"rows through the router, all 200; replicas' requests {spread} "
          f"(hedged {hedged}), rounds {rounds}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != want:
        raise AssertionError(f"FLEET launches {counts}, want {want}")
    if min(spread) < 1 or sum(spread) != len(xs) + hedged:
        raise AssertionError(f"FLEET: replicas answered {spread} for "
                             f"{len(xs)} requests and {hedged} hedges")
    err = 0.0
    for x, out in zip(xs, outs):
        if out.shape != (len(x), N_CLASSES) or not np.isfinite(out).all():
            raise AssertionError(f"FLEET: outputs shaped {out.shape}")
        ref, _ = plain_forward(servers[0], kernels, x.astype(np.float32))
        err = max(err, float(np.abs(out - ref).max()))
    # the router's added host time: each request again, through the router
    # and straight to a replica back to back, in alternating order; a pair
    # whose routed leg was hedged (a duplicate parsed in this one process)
    # is counted apart
    t_via, t_direct, pair_hedged = [], [], []
    for i, x in enumerate(xs):
        s = servers[i % len(servers)]
        for leg in ((0, 1) if i % 2 else (1, 0)):
            if leg:
                h0 = router.n_hedged
                t_via.append(post(url, x)[2])
                fleet_idle(servers)
                pair_hedged.append(router.n_hedged > h0)
            else:
                t_direct.append(post(f"http://127.0.0.1:{s.port}", x)[2])
    added = [(a - b) * 1e3 for a, b in zip(t_via, t_direct)]
    clean = [a for a, h in zip(added, pair_hedged) if not h]
    dup = [a for a, h in zip(added, pair_hedged) if h]
    print(f"FLEET requests: vs the plain forward max abs err {err:.3e} "
          f"(tolerance {SERVE_ATOL}); host ms a request in pairs, through "
          f"the router {np.mean(t_via) * 1e3:.1f} (mean), straight to a "
          f"replica {np.mean(t_direct) * 1e3:.1f}: the router adds "
          f"{np.mean(clean):.1f} ms (median {np.median(clean):.1f}, range "
          f"{min(clean):.1f} to {max(clean):.1f}) over {len(clean)} "
          f"unhedged pairs; {len(dup)} hedged pairs add "
          f"{np.mean(dup) if dup else 0.0:.1f} ms (mean) [{host_cpu()}]",
          flush=True)
    if err > SERVE_ATOL:
        raise AssertionError(f"FLEET: {err} from the plain forward")
    return counts, {"replica_requests": spread, "replica_rounds": rounds,
                    "hedged": hedged, "max_abs_err_vs_plain": err,
                    "router_ms": [t * 1e3 for t in t_router],
                    "paired_router_ms": [t * 1e3 for t in t_via],
                    "paired_direct_ms": [t * 1e3 for t in t_direct],
                    "paired_hedged": pair_hedged,
                    "router_added_ms_mean": float(np.mean(clean)),
                    "router_added_ms_median": float(np.median(clean)),
                    "hedged_pairs_added_ms": dup}


def fleet_rollback(router, servers, snap, rs):
    """A candidate (params x 1.01) swapped into both replicas, then POST
    /rollback through the router: both replicas give their boot outputs
    and logits back bit for bit, every request meanwhile answered."""
    url = f"http://127.0.0.1:{router.port}"
    x = rs.randn(2, HW, HW, 3).round(3)
    xf = x.astype(np.float32)
    boot = [(post(f"http://127.0.0.1:{s.port}", x)[1]["outputs"],
             served_logits(s, xf)) for s in servers]
    cand = candidate_alexnet(snap, 1.01)
    with Hammer(url, x[:1]) as h:
        for s in servers:
            s.swap_params(cand, source="chip_smoke")
        swapped = [post(f"http://127.0.0.1:{s.port}", x)[1]["outputs"]
                   for s in servers]
        t0 = time.perf_counter()
        req = urllib.request.Request(url + "/rollback", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            status, rb = r.status, json.loads(r.read())
        rb_s = time.perf_counter() - t0
        back = [(post(f"http://127.0.0.1:{s.port}", x)[1]["outputs"],
                 served_logits(s, xf)) for s in servers]
    codes = sorted(set(map(str, h.statuses)))
    bits = all(a[0] == b[0] and np.array_equal(a[1], b[1])
               for a, b in zip(boot, back))
    moved = all(o != b[0] for o, b in zip(swapped, boot))
    applied = sorted(r for r, o in rb["replicas"].items() if o["applied"])
    print(f"FLEET rollback: params x 1.01 swapped into both replicas (the "
          f"outputs moved: {moved}); /rollback through the router -> "
          f"{status} in {rb_s:.3f} s, applied on {applied}; both replicas' "
          f"outputs and logits bit for bit their boot ones: {bits}; "
          f"{len(h.statuses)} requests meanwhile, statuses {codes}",
          flush=True)
    if status != 200 or applied != sorted(s.replica for s in servers) \
            or not bits or not moved or codes != ["200"]:
        raise AssertionError(f"FLEET rollback: {status} {rb}, bits {bits}, "
                             f"moved {moved}, statuses {codes}")
    del cand
    return {"rollback_s": rb_s, "bits_equal": bits,
            "requests_meanwhile": len(h.statuses)}


def fleet_drain_evict(router, servers, beacons, rs):
    """Replica 0's beacon drains: no request reaches replica 0 after the
    router's next poll. Replica 1's beacon is then silenced (no goodbye:
    a crash): requests keep reaching it, every one answered, until the
    router evicts it after FLEET_TTL_S of silence."""
    url = f"http://127.0.0.1:{router.port}"
    x = rs.randn(1, HW, HW, 3).round(3)
    t0 = time.perf_counter()
    beacons[0].drain()
    router.poll_once()
    drain_s = time.perf_counter() - t0
    view = router.fleet()
    before = [s.n_requests for s in servers]
    for _ in range(4):
        if post(url, x)[0] != 200:
            raise AssertionError("FLEET drain: a request failed")
    fleet_idle(servers)
    after_drain = [s.n_requests - b for s, b in zip(servers, before)]
    print(f"FLEET drain: replica {servers[0].replica} draining, routable "
          f"{view['routable']} after the poll {drain_s * 1e3:.1f} ms after "
          f"the drain; 4 requests -> replicas {after_drain}", flush=True)
    if view["routable"] != 1 or after_drain[0] != 0:
        raise AssertionError(f"FLEET drain: routable {view['routable']}, "
                             f"requests {after_drain}")
    rid = servers[1].replica
    t0 = time.perf_counter()
    beacons[1].silence()
    statuses = []
    while rid in router._core.live():
        if time.perf_counter() - t0 > 10 * FLEET_TTL_S:
            raise AssertionError("FLEET: the silenced replica never left")
        # the router's time of the last beat it saw advance
        last_beat = router._core.replicas[rid].last_seen
        statuses.append(post(url, x)[0])
        router.poll_once()
    evict_s = time.perf_counter() - t0
    silent_s = time.monotonic() - last_beat
    codes = sorted(set(map(str, statuses)))
    print(f"FLEET evict: {rid}'s beacon silenced, evicted {evict_s:.2f} s "
          f"later, {silent_s:.2f} s after its last beat the router saw (TTL "
          f"{FLEET_TTL_S} s; beacons beat every {beacons[1].interval_s} s); "
          f"{len(statuses)} requests meanwhile, statuses {codes}",
          flush=True)
    if silent_s <= FLEET_TTL_S or codes != ["200"]:
        raise AssertionError(f"FLEET evict: {silent_s} s silent, statuses "
                             f"{codes}")
    return {"drain_poll_ms": drain_s * 1e3, "after_drain": after_drain,
            "evict_s": evict_s, "silent_s": silent_s,
            "requests_while_silent": len(statuses)}


def fleet_export(router, srv, rs):
    """The served AlexNet exported (the live generation's tensors) and run
    by the port's native engine on the host: 2 rows within
    NATIVE_RTOL / NATIVE_ATOL of the card's served softmax."""
    from veles_tpu_torch.export import export_workflow
    from veles_tpu_torch.native_engine import NativeEngine, build_library
    x = rs.randn(2, HW, HW, 3).round(3)
    card = np.asarray(post(f"http://127.0.0.1:{router.port}", x)[1][
        "outputs"], np.float64)
    pkg = tempfile.mkdtemp(prefix="veles_native_", dir=OUT)
    try:
        t0 = time.perf_counter()
        export_workflow(srv.workflow, pkg, params=srv._gens.params)
        export_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(pkg, f))
                     for f in os.listdir(pkg))
        t0 = time.perf_counter()
        build_library()
        build_s = time.perf_counter() - t0
        with NativeEngine(pkg) as eng:
            t0 = time.perf_counter()
            got = eng.infer(x.astype(np.float32)).astype(np.float64)
            infer_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(pkg, ignore_errors=True)
    err = float(np.abs(got - card).max())
    excess = float((np.abs(got - card)
                    - (NATIVE_ATOL + NATIVE_RTOL * np.abs(card))).max())
    print(f"FLEET export: the served AlexNet exported in {export_s:.2f} s, "
          f"{nbytes} bytes (topology.json + weights.bin); the native engine "
          f"(g++ build {build_s:.2f} s) on 2 rows in {infer_s:.2f} s, "
          f"{infer_s / 2 * 1e3:.1f} host ms a row [{host_cpu()}]; vs the "
          f"card's served softmax max abs err {err:.3e} (rtol "
          f"{NATIVE_RTOL}, atol {NATIVE_ATOL})", flush=True)
    if got.shape != card.shape or excess > 0:
        raise AssertionError(f"FLEET export: the engine {err} from the card")
    return {"export_s": export_s, "package_bytes": nbytes,
            "engine_build_s": build_s, "engine_ms_per_row": infer_s / 2 * 1e3,
            "max_abs_err_vs_card": err}


def fleet_phase(launcher, kernels, dev):
    """FLEET: two full-width AlexNet replicas (f32, 64-row rings, fused)
    started by `launcher.serve --serve-replicas 2 --serve-announce DIR`
    in this process, behind a ServingRouter over DIR with a short beacon
    TTL: requests, launches, 0 kernel builds for replica 2, the fleet
    rollback, the drain, the eviction, then the native export. Returns
    (the requests' launches, the record)."""
    from veles_tpu_torch.resilience.mirror import DirMirror
    from veles_tpu_torch.serving_router import RouterCore, ServingRouter
    t_phase = time.perf_counter()
    bus = os.path.join(OUT, "fleet_bus")
    shutil.rmtree(bus, ignore_errors=True)
    served = tempfile.mkdtemp(prefix="veles_fleet_alexnet_")
    srv = router = None
    try:
        snap = served_snapshot(dev, served)
        t0 = time.perf_counter()
        srv = launcher.serve([ALEXNET, "--serve", "0", "-s", snap,
                              "--lrn-maxpool", "fused", "--serve-ring",
                              str(B), "--serve-max-body", str(1 << 30),
                              "--serve-replicas", "2", "--serve-announce",
                              bus, *SERVE_ARGS])
        up_s = time.perf_counter() - t0
        servers, beacons = srv.fleet.servers, srv.fleet.beacons
        builds = [s.kernel_builds for s in servers]
        print(f"FLEET: 2 replicas {[s.replica for s in servers]} up in "
              f"{up_s:.2f} s on {[str(s.device) for s in servers]}, "
              f"variants {srv._fwd.variant_table()}; kernel builds by "
              f"replica {builds}", flush=True)
        if any(s.device != dev for s in servers) or builds[1] != {
                "nvcc": 0, "loads": 0}:
            raise AssertionError(f"FLEET: devices, builds {builds}")
        # the poller idles: the phase polls the bus itself, between
        # requests, so no request races an eviction
        router = ServingRouter(DirMirror(bus), poll_s=3600.0,
                               max_body=1 << 30,
                               core=RouterCore(beacon_ttl_s=FLEET_TTL_S)
                               ).start()
        if router.fleet()["routable"] != 2:
            raise AssertionError(f"FLEET: router sees {router.fleet()}")
        rs = np.random.RandomState(12)
        counts, rec = fleet_requests(router, servers, kernels, rs)
        rec["up_s"] = up_s
        rec["kernel_builds"] = builds
        rec["rollback"] = fleet_rollback(router, servers, snap, rs)
        rec["export"] = fleet_export(router, srv, rs)
        rec.update(fleet_drain_evict(router, servers, beacons, rs))
        rec["router_counters"] = router.counters()
    finally:
        if router is not None:
            router.stop()
        if srv is not None:
            srv.stop()
        shutil.rmtree(bus, ignore_errors=True)
        shutil.rmtree(served, ignore_errors=True)
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"FLEET: the phase in {rec['seconds']:.2f} s", flush=True)
    return counts, rec


# ---------------------------------------------------------------------------
# AOT: the serialized serving program (serving_aot.py)
# ---------------------------------------------------------------------------

#: the wires AOT serves and the forward LRN kernel each launches (fused)
AOT_WIRES = (("f32", "lrn_maxpool_forward"),
             ("bf16", "lrn_maxpool_forward_bf16"),
             ("int8", "lrn_maxpool_forward"))
#: ring rounds through a loaded program whose launches are counted
AOT_ROUNDS = 3


def aot_round(srv, x: torch.Tensor) -> torch.Tensor:
    """One ring round of host rows `x`, its answer on the host."""
    host, done = srv._forward_ring(x)
    if done is not None:
        done.synchronize()
    return host.clone()


def serve_enqueue_ms(srv, reps: int = 10) -> float:
    """Host ms to enqueue one ring round's forward through the wire (mean
    of `reps` after a warm-up, the card synchronized after them): where
    it exceeds the round's device ms, the card waits on the host."""
    x = torch.from_numpy(np.random.RandomState(4).randn(
        srv.ring_slots, HW, HW, 3).astype(np.float32)).to(srv.device)
    params = srv._gens.params
    srv._serve(params, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        srv._serve(params, x)
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def aot_wire(kernels, dev, wf, wire, k4, index, x, warned):
    """One wire of AOT: an eager server, a cold start exporting its
    program into `index`, a fresh server loading it, and after a flipped
    blob byte a third exporting anew with one warning; each start's
    seconds, the answers bit-equal to the eager ring's, K4 exactly 2 a
    round through the loaded program. Returns (launches, record)."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.serving_aot import ServingAotCache
    r = {}

    def start(cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = InferenceServer(wf, ring_slots=B, quantize=wire, device=dev,
                              aot_cache=cache)
        torch.cuda.synchronize()
        return srv, time.perf_counter() - t0

    eager, r["eager_start_s"] = start(None)
    want = aot_round(eager, x)
    r["eager_ring_ms"] = wire_ring_ms(eager)
    r["eager_enqueue_ms"] = serve_enqueue_ms(eager)
    del eager
    cold, r["export_start_s"] = start(index)
    warm, r["load_start_s"] = start(index)
    if (cold.aot_source, cold.aot_compiles) != ("export", 1) or \
            (warm.aot_source, warm.aot_compiles) != ("cache", 0):
        raise AssertionError(f"AOT {wire}: sources {cold.aot_source}, "
                             f"{warm.aot_source}")
    r["export_s"], r["load_s"] = cold.aot_seconds, warm.aot_seconds
    entry = ServingAotCache(index).entry(warm._aot_signature)
    r["pt2_bytes"] = entry["bytes"]
    for srv in (cold, warm):
        assert_same_bits(f"AOT {wire} {srv.aot_source}", aot_round(srv, x),
                         want)
    del cold
    # -- the main path: counts zeroed just before, read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(AOT_ROUNDS):
        aot_round(warm, x)
    counts = kernels.launch_counts()
    check_counts(f"AOT {wire} loaded program", counts,
                 {k4: 2 * AOT_ROUNDS})
    r["program_ring_ms"] = wire_ring_ms(warm)
    r["program_enqueue_ms"] = serve_enqueue_ms(warm)
    del warm
    # a tampered blob: refused with one warning, exported anew
    with open(entry["file"], "r+b") as f:
        f.seek(entry["bytes"] // 2)
        byte = f.read(1)
        f.seek(entry["bytes"] // 2)
        f.write(bytes([byte[0] ^ 1]))
    seen = len(warned)
    third, r["tampered_start_s"] = start(index)
    if third.aot_source != "export" or len(warned) != seen + 1 \
            or "sha256" not in warned[-1]:
        raise AssertionError(f"AOT {wire}: a tampered blob gave "
                             f"{third.aot_source}, warnings "
                             f"{warned[seen:]}")
    assert_same_bits(f"AOT {wire} re-exported", aot_round(third, x), want)
    del third
    torch.cuda.empty_cache()
    print(f"AOT {wire}: start {r['eager_start_s']:.3f} s eager, "
          f"{r['export_start_s']:.3f} s exporting (program "
          f"{r['export_s']:.3f} s), {r['load_start_s']:.3f} s loading "
          f"(program {r['load_s']:.3f} s); .pt2 {r['pt2_bytes']} B; the "
          f"same bits as the eager ring; ring round {r['eager_ring_ms']:.4f}"
          f" ms eager, {r['program_ring_ms']:.4f} ms through the program "
          f"(CUDA events), host ms to enqueue it {r['eager_enqueue_ms']:.4f}"
          f" eager, {r['program_enqueue_ms']:.4f} through the program; "
          f"{k4} {2 * AOT_ROUNDS} in {AOT_ROUNDS} rounds; a "
          f"flipped blob byte refused ({warned[-1][:60]}...) and exported "
          f"anew in {r['tampered_start_s']:.3f} s", flush=True)
    return counts, r


def aot_phase(launcher, kernels, dev):
    """AOT: SERVE WIRES' full-width AlexNet on a ring of B rows, `fused`:
    the CLI exporting its f32 program where $VELES_SERVING_AOT_CACHE names
    a cache, then for each wire `aot_wire`. Returns (the loaded programs'
    launches by wire, the record)."""
    from veles_tpu_torch.serving_aot import AOT_CACHE_ENV, ServingAotCache
    from veles_tpu_torch.snapshotter import Snapshotter
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="veles_aot_")
    warned = []
    inner = ServingAotCache.warning

    def warning(self, msg, *args):
        warned.append(msg % args)
        inner(self, msg, *args)

    ServingAotCache.warning = warning
    rec = {"wires": {}}
    launches = {}
    try:
        snap = served_snapshot(dev, work)
        x = torch.from_numpy(np.random.RandomState(21).randn(
            B, HW, HW, 3).astype(np.float32)).pin_memory()
        os.environ[AOT_CACHE_ENV] = os.path.join(work, "cli_aot.json")
        try:
            t0 = time.perf_counter()
            cli = launcher.serve([ALEXNET, "--serve", "0", "-s", snap,
                                  "--lrn-maxpool", "fused", "--serve-ring",
                                  str(B), *SERVE_ARGS])
            rec["cli_start_s"] = time.perf_counter() - t0
        finally:
            del os.environ[AOT_CACHE_ENV]
        info = cli.model_info()["aot"]
        cli.stop()
        del cli
        if info != {"source": "export", "compiles": 1}:
            raise AssertionError(f"AOT: the CLI's server reports {info}")
        print(f"AOT: the CLI served its exported program ({info}) after "
              f"{rec['cli_start_s']:.2f} s (snapshot import included)",
              flush=True)
        wf = Snapshotter.import_(snap, restore_prng=False)
        wf.place(dev)
        index = os.path.join(work, "serving_aot.json")
        for wire, k4 in AOT_WIRES:
            launches[f"aot_{wire}"], rec["wires"][wire] = aot_wire(
                kernels, dev, wf, wire, k4, index, x, warned)
    finally:
        ServingAotCache.warning = inner
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"AOT: the phase in {rec['seconds']:.2f} s", flush=True)
    return launches, rec


# ---------------------------------------------------------------------------
# DP: data-parallel training over torch.distributed
# ---------------------------------------------------------------------------

#: steps compared and timed at world size 1
DP_STEPS = 3
#: world sizes whose ZeRO optimizer-state bytes a rank would hold, from
#: the plan (mesh.zero_plan_local_elems): a prediction beside the
#: measured world-1 bytes
DP_PLAN_WORLDS = (2, 4, 8)
DP_TWO_RANKS = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
rank, port = int(sys.argv[1]), sys.argv[2]
from veles_tpu_torch import prng
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.parallel import distributed, mesh as M
from veles_tpu_torch.samples import alexnet
kernels.build()
distributed.initialize_distributed(f"127.0.0.1:{port}", rank, 2,
                                   backend="gloo", timeout_s=60)
mesh = M.make_mesh(device="cuda:0")
prng.seed_all(1234)
wf = alexnet.create_workflow(**json.loads(sys.argv[3]))
for u in wf.forwards:
    if hasattr(u, "dropout_ratio"):
        u.dropout_ratio = 0.0
wf.initialize(mesh.device)
gen = torch.Generator().manual_seed(5)
n = wf.loader.minibatch_size
x = torch.randn((n,) + tuple(wf.loader.sample_shape), generator=gen)
y = torch.randint(0, wf.n_classes, (n,), generator=gen)
dp = wf.build_fused_step(mesh=mesh, zero_sharding="on")
sd = dp.init_state()
local = wf.build_fused_step()
sl = local.init_state()
sd, (ld, _) = dp.train(sd, x, y)
sl, (ll, _) = local.train(sl, x, y)
full = dp.gather_state(sd)
err = max(float((a - b).abs().max()) for la, lb in
          zip(full["params"], sl["params"]) for a, b in
          zip(la.values(), lb.values()))
if rank == 0:
    print("DPTWO " + json.dumps({"loss_dp": float(ld), "loss_local":
          float(ll), "param_err": err, "device": str(mesh.device)}),
          flush=True)
distributed.shutdown_distributed()
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_cli_run(launcher, kernels, dev):
    """DP (a): `launcher.train` with `-l` at world size 1 on NCCL,
    `--zero-sharding on`, one epoch of the full-width f32 AlexNet,
    `fused`: exact launches (K1 16 a train step on the ZeRO slices, K4
    twice a step, K5 twice a train step). Returns the counts."""
    argv = [ALEXNET, "-l", f"127.0.0.1:{free_port()}", "--n-processes", "1",
            "--zero-sharding", "on", "-r", "1234", "--lrn-maxpool", "fused",
            "root.alexnet.decision.max_epochs=1", *TRAIN_ARGS]
    wf, counts = train_run(launcher, kernels, dev, "dp", argv)
    cl = wf.loader.class_lengths
    mb = wf.loader.minibatch_size
    train = -(-cl[2] // mb)
    passes = train + sum(-(-c // mb) for c in cl[:2] if c)
    check_counts("TRAIN dp", counts,
                 {"sgd_update": N_LEAVES * train,
                  "lrn_maxpool_forward": 2 * passes,
                  "lrn_maxpool_backward": 2 * train})
    print(f"TRAIN dp: K1 {N_LEAVES} a train step on the ZeRO slices, K4 "
          f"twice in each of {passes} steps, K5 twice in each of {train} "
          f"train steps", flush=True)
    del wf
    torch.cuda.empty_cache()
    return counts


def dp_step_run(kernels, dev, mesh, compute_dtype):
    """DP (b) at one compute dtype: the full-width AlexNet, dropout 0,
    the local step and the dp step (ZeRO on) from one state on one batch,
    DP_STEPS steps each: the states within the TRAIN gates (bf16: the
    update distance within 2^-7), the dp steps' exact launches, host and
    device ms a step of each, the optimizer-state bytes. Returns
    (launches, record)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.parallel.mesh import zero_plan, zero_plan_local_elems
    from veles_tpu_torch.samples import alexnet
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    for u in wf.forwards:
        if hasattr(u, "dropout_ratio"):
            u.dropout_ratio = 0.0
    wf.initialize(dev)
    local = wf.build_fused_step(compute_dtype=compute_dtype)
    dp = wf.build_fused_step(compute_dtype=compute_dtype, mesh=mesh,
                             zero_sharding="on")
    off = wf.build_fused_step(compute_dtype=compute_dtype, mesh=mesh,
                              zero_sharding="off")
    sl, sd = local.init_state(), dp.init_state()
    before = copy_state(sl)
    x, y, w = card_batch(dev, TB, 77)
    for _ in range(DP_STEPS):
        sl, (ll, _) = local.train(sl, x, y, w)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    for _ in range(DP_STEPS):
        sd, (ld, _) = dp.train(sd, x, y, w)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    sfx = "_bf16" if compute_dtype else ""
    check_counts(f"DP {compute_dtype or 'f32'}", counts,
                 {"sgd_update": N_LEAVES * DP_STEPS,
                  f"lrn_maxpool_forward{sfx}": 2 * DP_STEPS,
                  f"lrn_maxpool_backward{sfx}": 2 * DP_STEPS})
    full = dp.gather_state(sd)
    bits = all(torch.equal(a, b) for a, b in zip(state_tensors(full),
                                                  state_tensors(sl)))
    rec = {"bit_equal_to_local": bits}
    if compute_dtype:
        dist = update_distance(before, full, sl)
        check_update_distance(f"DP bf16 ({DP_STEPS} steps)", dist)
        rec["update_distance"] = dist
    else:
        rec["max_abs_err"] = compare_states("DP f32", full, sl)
    check_loss(f"DP {compute_dtype or 'f32'}", float(ld), float(ll))
    # the replicated dp update (ZeRO off: an all-reduce per gradient)
    so = off.init_state()
    for _ in range(DP_STEPS):
        so, (lo, _) = off.train(so, x, y, w)
    if compute_dtype:
        check_update_distance(f"DP bf16 ZeRO off ({DP_STEPS} steps)",
                              update_distance(before, so, sl))
    else:
        rec["zero_off_max_abs_err"] = compare_states("DP f32 ZeRO off", so,
                                                     sl)
    check_loss(f"DP {compute_dtype or 'f32'} ZeRO off", float(lo),
               float(ll))

    def timed(step, state):
        host, dev_ms = [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step.train(state, x, y, w)
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        return state, host, dev_ms
    def busy(step, state):
        """The card's busy ms a step (the sum of its kernels' and copies'
        device time by torch.profiler's CUDA activity) over DP_STEPS
        steps, and the host ms the profiled steps took."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DP_STEPS):
                state, _ = step.train(state, x, y, w)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / DP_STEPS
        us = 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "device_time", None)
                us += float(e.cuda_time if t is None else t)
        return state, us / 1e3 / DP_STEPS, host

    # in turns: local, dp, dp, local
    sl, h1, d1 = timed(local, sl)
    sd, h2, d2 = timed(dp, sd)
    sd, h3, d3 = timed(dp, sd)
    sl, h4, d4 = timed(local, sl)
    rec.update({"local_host_ms": h1 + h4, "local_device_ms": d1 + d4,
                "dp_host_ms": h2 + h3, "dp_device_ms": d2 + d3})
    sl, rec["local_busy_ms"], rec["local_profiled_host_ms"] = busy(local, sl)
    sd, rec["dp_busy_ms"], rec["dp_profiled_host_ms"] = busy(dp, sd)
    rec["optimizer_state_bytes"] = {
        "zero_on": dp.optimizer_state_bytes(sd),
        "zero_off": off.optimizer_state_bytes(so),
        "local": local.optimizer_state_bytes(sl)}
    rec["zero_plan_bytes_per_rank"] = {
        n: 4 * sum(zero_plan_local_elems(zero_plan(u.param_arrays(), n))
                   for u in wf.forwards) for n in DP_PLAN_WORLDS}
    rec["collective_accounting"] = {
        k: v for k, v in dp.collective_accounting().items()
        if k in ("variant", "elements", "n_shards", "dcn_bytes",
                 "ici_bytes")}
    rec["variant_table"] = dp.variant_table()
    label = compute_dtype or "f32"
    med = {k: float(np.median(v)) for k, v in rec.items()
           if k.endswith("_ms")}
    import torch.distributed as dist
    print(f"DP {label}: world size 1 on {mesh.device} "
          f"({dist.get_backend()}), ZeRO on "
          f"({rec['variant_table'].get('grad_reduce')}): {DP_STEPS} steps "
          f"against the local step's, "
          + ("bit-equal" if bits else "not bit-equal")
          + (f", update distance {max(rec['update_distance'].values()):.3e}"
             if compute_dtype else f", max abs err {rec['max_abs_err']:.3e}")
          + f"; launches {counts}; median ms a step: local host "
          f"{med['local_host_ms']:.3f} device {med['local_device_ms']:.3f},"
          f" dp host {med['dp_host_ms']:.3f} device "
          f"{med['dp_device_ms']:.3f} (CUDA events, in turns); the card "
          f"busy {rec['local_busy_ms']:.3f} ms a step local, "
          f"{rec['dp_busy_ms']:.3f} dp (torch.profiler, the sum of its "
          f"kernels and copies; {rec['local_profiled_host_ms']:.3f} and "
          f"{rec['dp_profiled_host_ms']:.3f} host ms a profiled step)",
          flush=True)
    print(f"DP {label}: optimizer-state bytes a rank "
          f"{rec['optimizer_state_bytes']}; by the ZeRO plan at "
          f"{list(DP_PLAN_WORLDS)} ranks {rec['zero_plan_bytes_per_rank']}; "
          f"modeled bytes a step {rec['collective_accounting']}",
          flush=True)
    del wf, local, dp, off, sl, sd, so, full
    torch.cuda.empty_cache()
    return counts, rec


def dp_two_ranks():
    """DP (c): two ranks on the one card. NCCL refuses two ranks of one
    communicator on one device, so the two processes join a gloo group
    with their tensors on cuda:0 and take one step of the toy AlexNet with
    ZeRO on, held against the local step; where gloo cannot run the
    step's collectives on CUDA tensors, the line says why and the check
    stays at world size 1. Returns the record."""
    work = tempfile.mkdtemp(prefix="veles_dp2_")
    script = os.path.join(work, "two_ranks.py")
    with open(script, "w") as f:
        f.write(DP_TWO_RANKS)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    toy = json.dumps({k: v for k, v in TOY_ARGS.items()})
    procs = [subprocess.Popen([sys.executable, script, str(r), port, toy],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    line = [ln for out in outs for ln in out.splitlines()
            if ln.startswith("DPTWO ")]
    if line and all(p.returncode == 0 for p in procs):
        rec = json.loads(line[0][len("DPTWO "):])
        if not rec["param_err"] <= 1e-5 or not np.isfinite(rec["loss_dp"]):
            raise AssertionError(f"DP two ranks: {rec}")
        print(f"DP two ranks: gloo over CUDA tensors on one card, ZeRO on, "
              f"toy AlexNet: one step within {rec['param_err']:.3e} of the "
              f"local step's parameters (loss {rec['loss_dp']} against "
              f"{rec['loss_local']})", flush=True)
        return dict(rec, ran=True)
    last = [ln for out in outs for ln in out.splitlines()
            if "Error" in ln or "error" in ln]
    why = (last[-1] if last else outs[-1][-300:] if outs else "no output")
    print(f"DP two ranks: none on this card — NCCL refuses two ranks on "
          f"one device, and gloo over CUDA tensors failed: {why.strip()}; "
          f"the chip check stays at world size 1", flush=True)
    return {"ran": False, "why": why.strip()[:500]}


def dp_phase(launcher, kernels, dev):
    """DP: (a) the CLI's dp run at world size 1, (b) the dp step against
    the local step in f32 and bf16 with memstats' figures, (c) two ranks
    on the one card where the card allows. Returns (launches by path,
    record)."""
    from veles_tpu_torch.parallel import distributed, memstats
    from veles_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    launches = {"dp_cli": dp_cli_run(launcher, kernels, dev)}
    rec = {}
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        mesh = make_mesh()
        for dt in (None, "bfloat16"):
            label = dt or "f32"
            launches[f"dp_{label}"], rec[label] = dp_step_run(
                kernels, dev, mesh, dt)
        rec["memstats"] = memstats.device_memory_stats()
        rec["memory_limits"] = memstats.device_memory_limits()
        print(f"DP memstats: {rec['memstats']}; limits "
              f"{rec['memory_limits']}", flush=True)
    finally:
        distributed.shutdown_distributed()
    rec["two_ranks"] = dp_two_ranks()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"DP: the phase in {rec['seconds']:.2f} s", flush=True)
    return launches, rec


# ---------------------------------------------------------------------------
# TP: tensor parallelism, the fused step's gspmd mode (parallel/tp.py)
# ---------------------------------------------------------------------------

#: steps of each TP check
TP_STEPS = 3
#: TP (b) bf16: the two ranks' update no further from the f32 local
#: step's than the bf16 local step's is, plus one bf16 unit roundoff. A
#: row-parallel product rounds each rank's partial sum to bf16 before
#: the all-reduce, the local step rounds the whole sum once: the two bf16
#: updates differ by about as much as each differs from the f32 one
#: (0.0093 apart, 0.0117 and 0.0118 from f32 on an H100, 3 steps at 128
#: rows), beyond BF16_STEP_RTOL, which holds bf16 steps of the same
#: roundings to each other
TP_BF16_SLACK = BF16_U
#: a rank's share of the local step's parameter and optimizer bytes at
#: model 2 (every leaf the megatron plan shards halved; the replicated
#: biases of the row-parallel layers, 5,736 of 62,378,344 elements, whole)
TP_SHARE = (0.5, 0.501)
TP_TWO_RANKS = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
rank, port = int(sys.argv[1]), sys.argv[2]
cfg = json.loads(sys.argv[3])
from veles_tpu_torch import prng
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.parallel import distributed, memstats, mesh as M
from veles_tpu_torch.samples import alexnet
kernels.build()
distributed.initialize_distributed(f"127.0.0.1:{port}", rank, 2,
                                   backend="gloo", timeout_s=600)
mesh = M.make_mesh(model=2, device="cuda:0")
dev = mesh.device
n = cfg["steps"]
out = {"mesh": str(mesh), "device": str(dev)}


def distance(a, b, before):
    # ||(a - before) - (b - before)|| / ||b - before|| over the leaves,
    # and per layer
    num = mv = 0.0
    layers = []
    for la, lb, l0 in zip(a, b, before):
        n_ = sum(float(((x.double() - y.double()) ** 2).sum())
                 for x, y in zip(la, lb))
        m_ = sum(float(((y.double() - z.double()) ** 2).sum())
                 for y, z in zip(lb, l0))
        num, mv = num + n_, mv + m_
        layers.append((n_ / m_) ** 0.5 if m_ else 0.0)
    return (num / mv) ** 0.5, layers


ref32 = None
for label, dt in (("f32", None), ("bf16", "bfloat16")):
    prng.seed_all(1234)
    wf = alexnet.create_workflow()          # dropout 0.5
    wf.initialize(dev)
    tp = wf.build_fused_step(compute_dtype=dt, mesh=mesh, mode="gspmd")
    local = wf.build_fused_step(compute_dtype=dt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    x = torch.randn((cfg["rows"], cfg["hw"], cfg["hw"], 3), generator=gen,
                    device=dev)
    y = torch.randint(0, cfg["classes"], (cfg["rows"],), generator=gen,
                      device=dev)
    st, sl = tp.init_state(), local.init_state()
    before = [[t.detach().clone() for t in layer.values()]
              for layer in sl["params"]]
    pos = tp.gen.get_state()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        st, (lt, _) = tp.train(st, x, y)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    # the local step draws the same dropout masks from the same stream
    tp.gen.set_state(pos)
    for _ in range(n):
        sl, (ll, _) = local.train(sl, x, y)
    full = tp.gather_state(st)
    got = [[t.detach() for t in layer.values()] for layer in full["params"]]
    want = [[t.detach() for t in layer.values()] for layer in sl["params"]]
    dist_local, by_layer = distance(got, want, before)
    if ref32 is None:
        ref32 = [[t.clone() for t in layer] for layer in want]
    got, want = sum(got, []), sum(want, [])
    vel_got = [t for layer in full["vel"] for t in layer.values()]
    vel_want = [t for layer in sl["vel"] for t in layer.values()]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out[label] = {
        "loss_tp": float(lt), "loss_local": float(ll),
        "param_err": max(float((a - b).abs().max())
                         for a, b in zip(got, want)),
        "vel_err": max(float((a - b).abs().max())
                       for a, b in zip(vel_got, vel_want)),
        "update_distance": dist_local,
        "update_distance_by_layer": by_layer,
        # each bf16 step's distance to the f32 local step's update
        "to_f32_tp": distance([[t.detach() for t in layer.values()]
                               for layer in full["params"]], ref32,
                              before)[0],
        "to_f32_local": distance([[t.detach() for t in layer.values()]
                                  for layer in sl["params"]], ref32,
                                 before)[0],
        "launches": counts, "host_ms": host,
        "param_bytes": nbytes([t for layer in st["params"]
                               for t in layer.values()]),
        "local_param_bytes": nbytes(want),
        "opt_bytes": sum(tp.optimizer_state_bytes(st).values()),
        "local_opt_bytes": sum(local.optimizer_state_bytes(sl).values()),
        "roles": tp.fwd.tp.roles, "table": tp.variant_table(),
        "memstats": memstats.device_memory_stats()}
    del wf, tp, local, st, sl, full, got, want, before
    torch.cuda.empty_cache()
every = [None, None]
torch.distributed.all_gather_object(every, out)
if rank == 0:
    print("TPTWO " + json.dumps(every), flush=True)
distributed.shutdown_distributed()
"""


def tp_solo_run(kernels, dev, mesh, compute_dtype):
    """TP (a) at one compute dtype: the full-width AlexNet at the DP
    phase's batch, dropout 0.5, the local step and the step with
    mode="gspmd" at model 1 from one state, the same dropout stream
    position and PyTorch's deterministic algorithms (cuDNN's sums
    otherwise change with the call): the same bits, the gspmd steps'
    exact launches. Returns (launches, record)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    wf.initialize(dev)
    local = wf.build_fused_step(compute_dtype=compute_dtype)
    tp = wf.build_fused_step(compute_dtype=compute_dtype, mesh=mesh,
                             mode="gspmd")
    sl, st = local.init_state(), tp.init_state()
    x, y, w = card_batch(dev, TB, 77)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pos = local.gen.get_state()
        for _ in range(TP_STEPS):
            sl, (ll, _) = local.train(sl, x, y, w)
        tp.gen.set_state(pos)
        torch.cuda.synchronize()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        for _ in range(TP_STEPS):
            st, (lt, _) = tp.train(st, x, y, w)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        torch.use_deterministic_algorithms(deterministic)
    sfx = "_bf16" if compute_dtype else ""
    label = compute_dtype or "f32"
    check_counts(f"TP {label}", counts,
                 {"sgd_update": N_LEAVES * TP_STEPS,
                  f"lrn_maxpool_forward{sfx}": 2 * TP_STEPS,
                  f"lrn_maxpool_backward{sfx}": 2 * TP_STEPS})
    bits = all(torch.equal(a, b) for a, b in zip(state_tensors(st),
                                                  state_tensors(sl)))
    if not bits or float(lt) != float(ll):
        raise AssertionError(
            f"TP {label}: the gspmd step at model 1 is not the local "
            f"step's bits (max abs err "
            f"{compare_states(f'TP {label}', st, sl, 1.0, 1.0):.3e}, loss "
            f"{float(lt)} against {float(ll)})")
    rec = {"bit_equal_to_local": bits, "loss": float(lt),
           "zero": tp.zero_reason, "variant_table": tp.variant_table()}
    print(f"TP {label}: world size 1 on {mesh.device}, mode gspmd at model "
          f"1, dropout 0.5: {TP_STEPS} steps bit-equal to the local step's "
          f"(deterministic algorithms); launches {counts}", flush=True)
    del wf, local, tp, sl, st
    torch.cuda.empty_cache()
    return counts, rec


def tp_two_ranks():
    """TP (b): two gloo processes over CUDA tensors on the one card (NCCL
    refuses two ranks on one device), data 1 x model 2, the full-width
    AlexNet at TB rows, dropout 0.5, TP_STEPS steps in f32 and bf16
    against the local step from the same state and masks: the gathered
    parameters within 1e-5 (f32; bf16: the update as near the f32 local
    step's as the bf16 local step's, TP_BF16_SLACK), every rank's K1 16,
    K4 2 and K5 2 a step, a rank's
    parameter and optimizer bytes about half the local step's. Raises
    where it does not run. Returns the record."""
    work = tempfile.mkdtemp(prefix="veles_tp2_")
    script = os.path.join(work, "two_ranks.py")
    with open(script, "w") as f:
        f.write(TP_TWO_RANKS)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cfg = json.dumps({"steps": TP_STEPS, "rows": TB, "hw": HW,
                      "classes": N_CLASSES})
    procs = [subprocess.Popen([sys.executable, script, str(r), port, cfg],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    line = [ln for out in outs for ln in out.splitlines()
            if ln.startswith("TPTWO ")]
    if not line or any(p.returncode != 0 for p in procs):
        tail = "\n".join(out[-3000:] for out in outs)
        raise AssertionError(f"TP two ranks did not run:\n{tail}")
    ranks = json.loads(line[0][len("TPTWO "):])
    rec = {"ranks": ranks}
    for label in ("f32", "bf16"):
        sfx = "_bf16" if label == "bf16" else ""
        for r, got in enumerate(ranks):
            g = got[label]
            check_counts(f"TP two ranks {label} rank {r}", g["launches"],
                         {"sgd_update": N_LEAVES * TP_STEPS,
                          f"lrn_maxpool_forward{sfx}": 2 * TP_STEPS,
                          f"lrn_maxpool_backward{sfx}": 2 * TP_STEPS})
            for what in ("param", "opt"):
                share = g[f"{what}_bytes"] / g[f"local_{what}_bytes"]
                if not TP_SHARE[0] <= share <= TP_SHARE[1]:
                    raise AssertionError(
                        f"TP two ranks {label} rank {r}: {what} bytes "
                        f"{g[f'{what}_bytes']} of the local step's "
                        f"{g[f'local_{what}_bytes']} ({share:.5f})")
            if label == "f32" and not g["param_err"] <= 1e-5:
                raise AssertionError(f"TP two ranks f32 rank {r}: {g}")
            if label == "bf16" and not g["to_f32_tp"] <= \
                    g["to_f32_local"] + TP_BF16_SLACK:
                raise AssertionError(f"TP two ranks bf16 rank {r}: {g}")
            if not np.isfinite(g["loss_tp"]):
                raise AssertionError(f"TP two ranks {label}: loss {g}")
        g = ranks[0][label]
        print(f"TP two ranks {label}: gloo over CUDA tensors on one card, "
              f"data 1 x model 2, the full-width AlexNet at {TB} rows, "
              f"dropout 0.5, {TP_STEPS} steps: parameters within "
              f"{g['param_err']:.3e} of the local step's (velocities "
              f"{g['vel_err']:.3e}, update distance "
              f"{g['update_distance']:.3e}; to the f32 local step's "
              f"update {g['to_f32_tp']:.3e}, the local step's "
              f"{g['to_f32_local']:.3e}); loss {g['loss_tp']} against "
              f"{g['loss_local']}; a rank holds {g['param_bytes']} parameter "
              f"and {g['opt_bytes']} optimizer bytes of the local step's "
              f"{g['local_param_bytes']} and {g['local_opt_bytes']}; "
              f"launches a rank {g['launches']}; host ms a step "
              f"{[round(t, 1) for t in g['host_ms']]} (gloo stages every "
              f"collective through the host: no TP figure); roles "
              f"{g['roles']}", flush=True)
    return rec


#: TP (c2): the straddling head's steps (n_heads=1, D 64: q, k and v
#: all-gathered, K6 / K7 on the whole head on each rank)
TP_CT_ONE_STEPS = 1
#: TP (c2): a rank's elements of the parameters (and of the SGD
#: velocities) and the local step's, by the plan at model 2, with and
#: without MoE: the replicated 4096 x 64 `pos` table dominates (its
#: embed's weights, attention's four matrices and the softmax head's
#: halved; the FFN's w2 and b2, MoE's nothing, replicated)
TP_CT_ELEMENTS = {"dense": (284009, 297490), "moe": (338098, 414034)}
TP_CT_TWO_RANKS = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
rank, port = int(sys.argv[1]), sys.argv[2]
cfg = json.loads(sys.argv[3])
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.loader.text import synthetic_text
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.parallel import distributed, memstats, mesh as M
from veles_tpu_torch.samples import char_transformer
kernels.build()
distributed.initialize_distributed(f"127.0.0.1:{port}", rank, 2,
                                   backend="gloo", timeout_s=600)
mesh = M.make_mesh(model=2, device="cuda:0")
dev = mesh.device
out = {"mesh": str(mesh), "device": str(dev)}


def workflow(experts, heads):
    # chip_smoke.py ct_workflow's: 32 windows of 4096 from seed 1234
    prng.seed_all(1234)
    node = root.char_transformer
    saved = node.to_dict()
    mb, seq = cfg["rows"], cfg["seq"]
    for k, v in {"loader.seq_len": seq, "loader.n_validation": 1,
                 "loader.minibatch_size": mb, "moe_experts": experts,
                 "moe_capacity_factor": 2.0, "n_heads": heads}.items():
        node.override(k, v)
    try:
        wf = char_transformer.create_workflow(
            text=synthetic_text((mb + 1) * seq + 1))
    finally:
        node.update(saved)
    wf.initialize(dev)
    loader = wf.loader
    loader.run()
    while loader.minibatch_class != TRAIN:
        loader.run()
    return wf, (loader.minibatch_data, loader.minibatch_labels,
                loader.minibatch_valid)


def distance(a, b, before):
    # ||(a - before) - (b - before)|| / ||b - before|| over the leaves
    num = mv = 0.0
    for x, y, z in zip(a, b, before):
        num += float(((x.double() - y.double()) ** 2).sum())
        mv += float(((y.double() - z.double()) ** 2).sum())
    return (num / mv) ** 0.5


def leaves(state, slot="params"):
    return [t.detach() for layer in state[slot] for t in layer.values()]


ref32 = None
for label, experts, heads, dt, n in cfg["runs"]:
    wf, batch = workflow(experts, heads)
    tp = wf.build_fused_step(compute_dtype=dt, mesh=mesh, mode="gspmd")
    local = wf.build_fused_step(compute_dtype=dt)
    st, sl = tp.init_state(), local.init_state()
    before = [t.clone() for t in leaves(sl)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        st, (lt, et) = tp.train(st, *batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    for _ in range(n):
        sl, (ll, el) = local.train(sl, *batch)
    full = tp.gather_state(st)
    got, want = leaves(full), leaves(sl)
    if label == "dense f32":
        ref32 = [t.clone() for t in want]
    rec = {
        "loss_tp": float(lt), "loss_local": float(ll),
        "n_err_tp": int(et), "n_err_local": int(el),
        "param_err": max(float((a - b).abs().max())
                         for a, b in zip(got, want)),
        "vel_err": max(float((a - b).abs().max()) for a, b in
                       zip(leaves(full, "vel"), leaves(sl, "vel"))),
        "update_distance": distance(got, want, before),
        "launches": counts, "host_ms": host,
        "elements": sum(t.numel() for t in leaves(st)),
        "local_elements": sum(t.numel() for t in want),
        "opt_bytes": sum(tp.optimizer_state_bytes(st).values()),
        "local_opt_bytes": sum(local.optimizer_state_bytes(sl).values()),
        "roles": tp.fwd.tp.roles, "table": tp.variant_table(),
        "memstats": memstats.device_memory_stats()}
    if dt is not None:
        # each bf16 step's distance to the f32 local step's update
        rec["to_f32_tp"] = distance(got, ref32, before)
        rec["to_f32_local"] = distance(want, ref32, before)
    out[label] = rec
    del wf, tp, local, st, sl, full, got, want, before
    torch.cuda.empty_cache()
every = [None, None]
torch.distributed.all_gather_object(every, out)
if rank == 0:
    print("TPCTTWO " + json.dumps(every), flush=True)
distributed.shutdown_distributed()
"""


def tp_ct_solo_run(kernels, dev, mesh, compute_dtype):
    """TP (c1) at one compute dtype: the full-width char-transformer, the
    local step and the step with mode="gspmd" at model 1 from one state
    on one batch: the same bits, the gspmd steps' exact launches (K6 and
    K7 1 a step, K1 13). Returns (launches, record)."""
    wf, batch = ct_workflow(dev, 0)
    local = wf.build_fused_step(compute_dtype=compute_dtype)
    tp = wf.build_fused_step(compute_dtype=compute_dtype, mesh=mesh,
                             mode="gspmd")
    sl, st = local.init_state(), tp.init_state()
    leaves = sum(len(u.param_arrays()) for u in wf.forwards)
    for _ in range(TP_STEPS):
        sl, (ll, _) = local.train(sl, *batch)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    for _ in range(TP_STEPS):
        st, (lt, _) = tp.train(st, *batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    label = compute_dtype or "f32"
    check_counts(f"TP transformer {label}", counts,
                 {"sgd_update": leaves * TP_STEPS,
                  "flash_attention_forward": TP_STEPS,
                  "flash_attention_backward": TP_STEPS})
    bits = all(torch.equal(a, b) for a, b in zip(state_tensors(st),
                                                  state_tensors(sl)))
    if not bits or float(lt) != float(ll):
        err = compare_states(f"TP transformer {label}", st, sl, 1.0, 1.0)
        raise AssertionError(
            f"TP transformer {label}: the gspmd step at model 1 is not the "
            f"local step's bits (max abs err {err:.3e}, loss {float(lt)} "
            f"against {float(ll)})")
    rec = {"bit_equal_to_local": bits, "loss": float(lt),
           "variant_table": tp.variant_table()}
    print(f"TP transformer {label}: world size 1 on {mesh.device}, mode "
          f"gspmd at model 1, 32 x {CT_SEQ}: {TP_STEPS} steps bit-equal to "
          f"the local step's; launches {counts}", flush=True)
    del wf, local, tp, sl, st
    torch.cuda.empty_cache()
    return counts, rec


def tp_ct_two_ranks():
    """TP (c2): two gloo processes over CUDA tensors on the one card, data
    1 x model 2, the full-width char-transformer dense in f32 and bf16,
    with MoE in f32 and with one head of 64 in f32, each against the
    local step from the same state on the same batch: f32 parameters
    within 1e-5, bf16 as TP (b) holds it; every rank's K6 1, K7 1 a train
    step and K1 one a leaf; a rank's parameter and optimizer elements
    TP_CT_ELEMENTS. Raises where it does not run. Returns (launches by
    path, the record)."""
    work = tempfile.mkdtemp(prefix="veles_tp_ct2_")
    script = os.path.join(work, "two_ranks.py")
    with open(script, "w") as f:
        f.write(TP_CT_TWO_RANKS)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = [("dense f32", 0, 4, None, TP_STEPS),
            ("dense bf16", 0, 4, "bfloat16", TP_STEPS),
            ("moe f32", MOE_EXPERTS, 4, None, TP_STEPS),
            ("one head f32", 0, 1, None, TP_CT_ONE_STEPS)]
    cfg = json.dumps({"rows": ATT_SHAPES[0][0], "seq": CT_SEQ,
                      "runs": runs})
    procs = [subprocess.Popen([sys.executable, script, str(r), port, cfg],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    line = [ln for out in outs for ln in out.splitlines()
            if ln.startswith("TPCTTWO ")]
    if not line or any(p.returncode != 0 for p in procs):
        tail = "\n".join(out[-3000:] for out in outs)
        raise AssertionError(f"TP transformer two ranks did not run:\n"
                             f"{tail}")
    ranks = json.loads(line[0][len("TPCTTWO "):])
    launches = {}
    for label, experts, heads, dt, n in runs:
        leaves = 14 if experts else 13
        elements = TP_CT_ELEMENTS["moe" if experts else "dense"]
        for r, got in enumerate(ranks):
            g = got[label]
            check_counts(f"TP transformer two ranks {label} rank {r}",
                         g["launches"],
                         {"sgd_update": leaves * n,
                          "flash_attention_forward": n,
                          "flash_attention_backward": n})
            launches[f"tp_ct_rank{r}_{label.replace(' ', '_')}"] = \
                g["launches"]
            if (g["elements"], g["local_elements"]) != elements \
                    or (g["opt_bytes"], g["local_opt_bytes"]) != \
                    tuple(4 * e for e in elements):
                raise AssertionError(
                    f"TP transformer two ranks {label} rank {r}: elements "
                    f"{g['elements']} of {g['local_elements']}, optimizer "
                    f"bytes {g['opt_bytes']} of {g['local_opt_bytes']}, "
                    f"not {elements}")
            if dt is None and not g["param_err"] <= 1e-5:
                raise AssertionError(
                    f"TP transformer two ranks {label} rank {r}: {g}")
            if dt is not None and not g["to_f32_tp"] <= \
                    g["to_f32_local"] + TP_BF16_SLACK:
                raise AssertionError(
                    f"TP transformer two ranks {label} rank {r}: {g}")
            if not np.isfinite(g["loss_tp"]):
                raise AssertionError(f"TP transformer two ranks {label}: "
                                     f"loss {g}")
        g = ranks[0][label]
        extra = (f"; to the f32 local step's update {g['to_f32_tp']:.3e}, "
                 f"the local step's {g['to_f32_local']:.3e}"
                 if dt is not None else "")
        print(f"TP transformer two ranks {label}: gloo over CUDA tensors on "
              f"one card, data 1 x model 2, 32 x {CT_SEQ}, {n} step(s): "
              f"parameters within {g['param_err']:.3e} of the local step's "
              f"(velocities {g['vel_err']:.3e}, update distance "
              f"{g['update_distance']:.3e}{extra}); loss {g['loss_tp']} "
              f"against {g['loss_local']}, n_err {g['n_err_tp']} against "
              f"{g['n_err_local']}; a rank holds {g['elements']} of the "
              f"local step's {g['local_elements']} parameter elements "
              f"({g['elements'] / g['local_elements']:.4f}; optimizer "
              f"bytes {g['opt_bytes']} of {g['local_opt_bytes']}); "
              f"launches a rank {g['launches']}; host ms a step "
              f"{[round(t, 1) for t in g['host_ms']]} (gloo stages every "
              f"collective through the host: no TP figure); roles "
              f"{g['roles']}; flash lowering "
              f"{g['table'].get('flash_attn')}", flush=True)
    return launches, {"ranks": ranks}


def tp_phase(launcher, kernels, dev):
    """TP: (a) the gspmd step at model 1 on NCCL (world size 1) bit-equal
    to the local step in f32 and bf16, (b) two gloo ranks at model 2 on
    the one card; (c) the same for the char-transformer (c1, c2).
    Returns (launches by path, record)."""
    from veles_tpu_torch.parallel import distributed
    from veles_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    launches, rec = {}, {}
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        mesh = make_mesh()
        for dt in (None, "bfloat16"):
            label = dt or "f32"
            launches[f"tp_{label}"], rec[label] = tp_solo_run(
                kernels, dev, mesh, dt)
        for dt in (None, "bfloat16"):
            label = dt or "f32"
            launches[f"tp_ct_{label}"], rec[f"transformer_{label}"] = \
                tp_ct_solo_run(kernels, dev, mesh, dt)
    finally:
        distributed.shutdown_distributed()
    rec["two_ranks"] = tp_two_ranks()
    t_ct = time.perf_counter()
    two_ct_launches, rec["transformer_two_ranks"] = tp_ct_two_ranks()
    launches.update(two_ct_launches)
    rec["transformer_two_ranks"]["seconds"] = time.perf_counter() - t_ct
    print(f"TP transformer two ranks: in "
          f"{rec['transformer_two_ranks']['seconds']:.2f} s", flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"TP: the phase in {rec['seconds']:.2f} s", flush=True)
    return launches, rec


# ---------------------------------------------------------------------------
# MOE, EP, PP: the switch mixture of experts, expert parallelism and the
# GPipe pipeline on the char-transformer at seq_len 4096
# ---------------------------------------------------------------------------

#: the MoE char-transformer: TRAIN transformer's widths, the dense FFN
#: swapped for 8 experts of hidden 128 at capacity factor 2.0
MOE_EXPERTS = 8
MOE_ARGS = [f"root.char_transformer.moe_experts={MOE_EXPERTS}",
            "root.char_transformer.moe_capacity_factor=2.0"]
#: steps a side of each timed comparison (in turns: a, b, b, a)
MOE_TIMED_STEPS = 3
EP_STEPS = 3
EP_F32_ATOL = 1e-7
PP_STAGES = 4
PP_MICRO = 4
PP_STEPS = 3


def ct_workflow(dev, experts: int):
    """The full-width char-transformer (32 distinct windows of 4096 of a
    longer synthetic text, seed 1234) on the card, its FFN an
    `experts`-expert MoE (0: the dense FFN), with its first train
    minibatch (x, y, w)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.loader.text import synthetic_text
    from veles_tpu_torch.samples import char_transformer
    prng.seed_all(1234)
    mb = ATT_SHAPES[0][0]
    with ct_config({"loader.seq_len": CT_SEQ, "loader.n_validation": 1,
                    "loader.minibatch_size": mb, "moe_experts": experts,
                    "moe_capacity_factor": 2.0}):
        wf = char_transformer.create_workflow(
            text=synthetic_text((mb + 1) * CT_SEQ + 1))
    wf.initialize(dev)
    loader = wf.loader
    loader.run()
    while loader.minibatch_class != TRAIN:
        loader.run()
    return wf, (loader.minibatch_data, loader.minibatch_labels,
                loader.minibatch_valid)


@contextlib.contextmanager
def moe_routes():
    """Record every routing of the block: (tokens, capacity, dropped,
    each expert's load)."""
    from veles_tpu_torch.ops import moe as om
    seen = []
    inner = om.top1_route

    def route(probs, capacity):
        out = inner(probs, capacity)
        seen.append({"tokens": int(probs.shape[0]),
                     "capacity": int(capacity),
                     "dropped": int((~out[2]).sum()),
                     "loads": torch.bincount(
                         out[0], minlength=probs.shape[1]).tolist()})
        return out
    om.top1_route = route
    try:
        yield seen
    finally:
        om.top1_route = inner


def timed_train(step, state, batch, n):
    """n steps of `step` on one batch: (state, host ms, device ms a step
    by CUDA events)."""
    host, dev_ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step.train(state, *batch)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return state, host, dev_ms


def in_turns(a, b, n=MOE_TIMED_STEPS):
    """(step, state, batch) pairs a and b timed a, b, b, a: {"a_host_ms",
    "a_device_ms", "b_host_ms", "b_device_ms"} (every step's)."""
    out = {}
    for key, (step, state, batch) in (("a", a), ("b", b), ("b", b),
                                      ("a", a)):
        _, host, dev_ms = timed_train(step, state, batch, n)
        out.setdefault(f"{key}_host_ms", []).extend(host)
        out.setdefault(f"{key}_device_ms", []).extend(dev_ms)
    return out


def medians(rec):
    return {k: float(np.median(v)) for k, v in rec.items()}


def top_ops(step, state, batch, n=8):
    """One step under torch.profiler: the card's ms in all and the n
    operators with the most self device time, [(name, ms, calls)]."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step.train(state, *batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        us = float(e.self_cuda_time_total if t is None else t)
        if us > 0 and e.key.startswith("aten::"):
            rows.append((e.key, us / 1e3, int(e.count)))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return total, rows[:n]


def moe_phase(launcher, kernels, dev):
    """MOE: (a) one epoch of the MoE char-transformer through the CLI's
    `--fused`, exact counts; (b) one step through the kernels against the
    plain versions, its drops and peak bytes; (c) its host and device ms
    a step beside the dense-FFN step's. Returns (launches, record)."""
    t0 = time.perf_counter()
    launches = {"train_moe": transformer_run(launcher, kernels, dev, "moe",
                                             MOE_ARGS, 1)}
    wf, batch = ct_workflow(dev, MOE_EXPERTS)
    moe = wf.forwards[2]
    step = wf.build_fused_step()
    leaves = sum(len(u.param_arrays()) for u in wf.forwards)
    s0 = step.init_state()

    def run(plain):
        st = clone_state(s0)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            st, (loss, n_err) = step.train(st, *batch)
        torch.cuda.synchronize()
        return st, float(loss), int(n_err)

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    kernels.reset_launch_counts()
    with moe_routes() as routes:
        kst, kloss, kerr = run(False)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check_counts("MOE step", counts,
                 {"flash_attention_forward": 1,
                  "flash_attention_backward": 1, "sgd_update": leaves})
    launches["moe_step"] = counts
    pst, ploss, perr = run(True)
    check_loss("MOE kernel vs plain step", kloss, ploss)
    err = compare_states("MOE kernel vs plain step", kst, pst)
    [r] = routes
    e, c, d = MOE_EXPERTS, r["capacity"], moe.wr.shape[0]
    rec = {"loss": [kloss, ploss], "n_err": [kerr, perr],
           "max_abs_err": err, "route": r, "leaves": leaves,
           "peak_bytes": peak, "resident_bytes": base,
           "buffer_bytes": {"ECD": 4 * e * c * d,
                            "ECH": 4 * e * c * moe.hidden,
                            "NEC_never_built": 4 * r["tokens"] * e * c}}
    print(f"MOE step at S={CT_SEQ}, {MOE_EXPERTS} experts of hidden "
          f"{moe.hidden}, capacity {c} of {r['tokens']} tokens: kernels vs "
          f"plain versions loss {kloss} vs {ploss}, n_err {kerr} vs {perr}, "
          f"max abs err over every leaf and velocity {err:.3e}; launches "
          f"{counts}; {r['dropped']} tokens dropped, loads {r['loads']}; "
          f"peak {peak} B on the card ({base} resident before; the "
          f"(E, C, D) buffer {rec['buffer_bytes']['ECD']} B, (E, C, H) "
          f"{rec['buffer_bytes']['ECH']} B; an (N, E, C) mask would be "
          f"{rec['buffer_bytes']['NEC_never_built']} B)", flush=True)
    del kst, pst
    dense_wf, dense_batch = ct_workflow(dev, 0)
    dense = dense_wf.build_fused_step()
    timed = medians(in_turns(
        (dense, dense.init_state(), dense_batch),
        (step, clone_state(s0), batch)))
    rec["ms"] = {"dense_host": timed["a_host_ms"],
                 "dense_device": timed["a_device_ms"],
                 "moe_host": timed["b_host_ms"],
                 "moe_device": timed["b_device_ms"]}
    print(f"MOE ms a step (median of {2 * MOE_TIMED_STEPS}, CUDA events, in "
          f"turns): MoE host {timed['b_host_ms']:.3f} device "
          f"{timed['b_device_ms']:.3f}, dense FFN host "
          f"{timed['a_host_ms']:.3f} device {timed['a_device_ms']:.3f}",
          flush=True)
    rec["profile"] = {}
    for label, st, stt, b in (("moe", step, clone_state(s0), batch),
                              ("dense", dense, dense.init_state(),
                               dense_batch)):
        total, rows = top_ops(st, stt, b)
        rec["profile"][label] = {"aten_self_ms": total, "top": rows}
        print(f"MOE profile {label}: {total:.3f} ms of the card's time in "
              f"aten operators (torch.profiler, one step); the most: "
              + ", ".join(f"{k} {ms:.3f} ({c})" for k, ms, c in rows),
              flush=True)
    del wf, dense_wf, step, dense, s0
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    print(f"MOE: the phase in {rec['seconds']:.2f} s", flush=True)
    return launches, rec


EP_TWO_RANKS = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
rank, port = int(sys.argv[1]), sys.argv[2]
from veles_tpu_torch import prng
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.parallel import distributed, mesh as M
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
kernels.build()
distributed.initialize_distributed(f"127.0.0.1:{port}", rank, 2,
                                   backend="gloo", timeout_s=60)
mesh = M.make_mesh(device="cuda:0")
prng.seed_all(1234)
wf = StandardWorkflow(
    layers=[{"type": "all2all_tanh", "output_sample_shape": 64,
             "weights_stddev": 0.1},
            {"type": "moe", "n_experts": 8, "hidden": 128,
             "capacity_factor": 8.0, "weights_stddev": 0.1},
            {"type": "softmax", "output_sample_shape": 8,
             "weights_stddev": 0.05}],
    loader=SyntheticClassifierLoader(n_classes=8, sample_shape=(32,),
                                     n_validation=64, n_train=64,
                                     minibatch_size=64),
    loss="softmax", n_classes=8, gd_config={"learning_rate": 0.05,
                                            "gradient_moment": 0.9})
wf.initialize(mesh.device)
gen = torch.Generator().manual_seed(5)
x = torch.randn((64, 32), generator=gen)
y = torch.randint(0, 8, (64,), generator=gen)
ep = wf.build_fused_step(mesh=mesh, ep=True)
se = ep.init_state()
local = wf.build_fused_step()
sl = local.init_state()
se, (le, _) = ep.train(se, x, y)
sl, (ll, _) = local.train(sl, x, y)
full = ep.gather_state(se)
err = max(float((a - b).abs().max()) for la, lb in
          zip(full["params"], sl["params"]) for a, b in
          zip(la.values(), lb.values()))
split = list(se["params"][1]["w1"].shape)
if rank == 0:
    print("EPTWO " + json.dumps({"loss_ep": float(le), "loss_local":
          float(ll), "param_err": err, "w1_local_shape": split,
          "device": str(mesh.device)}), flush=True)
distributed.shutdown_distributed()
"""


def ep_two_ranks():
    """EP (c): two gloo ranks on the one card, 4 experts each, one step
    of the MoE sample's net at zero-drop capacity against the local
    step; where gloo cannot exchange CUDA tensors, the reason. Returns
    the record."""
    work = tempfile.mkdtemp(prefix="veles_ep2_")
    script = os.path.join(work, "two_ranks.py")
    with open(script, "w") as f:
        f.write(EP_TWO_RANKS)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    line = [ln for out in outs for ln in out.splitlines()
            if ln.startswith("EPTWO ")]
    if line and all(p.returncode == 0 for p in procs):
        rec = json.loads(line[0][len("EPTWO "):])
        if not rec["param_err"] <= 1e-5 or not np.isfinite(rec["loss_ep"]) \
                or rec["w1_local_shape"][0] != 4:
            raise AssertionError(f"EP two ranks: {rec}")
        print(f"EP two ranks: gloo over CUDA tensors on one card, 4 of 8 "
              f"experts a rank (w1 {rec['w1_local_shape']}): one step "
              f"within {rec['param_err']:.3e} of the local step's "
              f"parameters (loss {rec['loss_ep']} against "
              f"{rec['loss_local']})", flush=True)
        return dict(rec, ran=True)
    last = [ln for out in outs for ln in out.splitlines()
            if "Error" in ln or "error" in ln]
    why = (last[-1] if last else outs[-1][-300:] if outs else "no output")
    print(f"EP two ranks: none on this card — NCCL refuses two ranks on "
          f"one device, and gloo's exchange over CUDA tensors failed: "
          f"{why.strip()}; the chip check stays at world size 1",
          flush=True)
    return {"ran": False, "why": why.strip()[:500]}


def ep_step_run(kernels, dev, mesh, compute_dtype):
    """EP (b) at one compute dtype: the full-width MoE step with the
    experts sharded over the mesh's one rank against the local step from
    one state, EP_STEPS steps each on one batch. Returns (launches,
    record)."""
    wf, batch = ct_workflow(dev, MOE_EXPERTS)
    leaves = sum(len(u.param_arrays()) for u in wf.forwards)
    local = wf.build_fused_step(compute_dtype=compute_dtype)
    ep = wf.build_fused_step(compute_dtype=compute_dtype, mesh=mesh,
                             ep=True)
    sl, se = local.init_state(), ep.init_state()
    for _ in range(EP_STEPS):
        sl, (ll, _) = local.train(sl, *batch)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    for _ in range(EP_STEPS):
        se, (le, _) = ep.train(se, *batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    label = compute_dtype or "f32"
    check_counts(f"EP {label}", counts,
                 {"flash_attention_forward": EP_STEPS,
                  "flash_attention_backward": EP_STEPS,
                  "sgd_update": leaves * EP_STEPS})
    full = ep.gather_state(se)
    bits = all(torch.equal(a, b) for a, b in zip(state_tensors(full),
                                                  state_tensors(sl)))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(state_tensors(full), state_tensors(sl)))
    rec = {"bit_equal_to_local": bits, "max_abs_err": err,
           "loss": [float(le), float(ll)], "zero": ep.zero_reason,
           "collective_accounting": ep.collective_accounting(),
           "optimizer_state_bytes": {"ep": ep.optimizer_state_bytes(se),
                                     "local":
                                     local.optimizer_state_bytes(sl)}}
    if compute_dtype and not bits:
        raise AssertionError(f"EP bf16: not bit-equal to the local step "
                             f"(max abs err {err:.3e})")
    if not err <= EP_F32_ATOL:
        raise AssertionError(f"EP {label}: max abs err {err:.3e} beyond "
                             f"{EP_F32_ATOL}")
    rec.update(medians(in_turns((local, sl, batch), (ep, se, batch))))
    print(f"EP {label}: world size 1 on {mesh.device}, 8 experts on the "
          f"rank, {EP_STEPS} steps against the local step's: "
          + ("bit-equal" if bits else f"max abs err {err:.3e}")
          + f"; launches {counts}; median ms a step (CUDA events, in "
          f"turns): local host {rec['a_host_ms']:.3f} device "
          f"{rec['a_device_ms']:.3f}, ep host {rec['b_host_ms']:.3f} "
          f"device {rec['b_device_ms']:.3f}; modeled exchange "
          f"{rec['collective_accounting']['exchanges']} all-to-alls of "
          f"{rec['collective_accounting']['elements'] // max(1, rec['collective_accounting']['exchanges'])} "
          f"elements a step; {ep.zero_reason}", flush=True)
    del wf, local, ep, sl, se, full
    torch.cuda.empty_cache()
    return counts, rec


def ep_phase(launcher, kernels, dev):
    """EP: (a) the CLI's `-l --ep` at world size 1, one epoch; (b) the
    expert-parallel step against the local step, bf16 and f32; (c) two
    gloo ranks on the card. Returns (launches by path, record)."""
    from veles_tpu_torch.parallel import distributed
    from veles_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    argv = ["-l", f"127.0.0.1:{free_port()}", "--n-processes", "1", "--ep",
            *MOE_ARGS]
    launches = {"ep_cli": transformer_run(launcher, kernels, dev, "ep", argv,
                                          1)}
    rec = {}
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 0, 1)
    try:
        mesh = make_mesh()
        for dt in ("bfloat16", None):
            label = dt or "f32"
            launches[f"ep_{label}"], rec[label] = ep_step_run(
                kernels, dev, mesh, dt)
    finally:
        distributed.shutdown_distributed()
    rec["two_ranks"] = ep_two_ranks()
    rec["seconds"] = time.perf_counter() - t0
    print(f"EP: the phase in {rec['seconds']:.2f} s", flush=True)
    return launches, rec


def pp_phase(launcher, kernels, dev):
    """PP: the 4-stage pipeline on the one card against the local fused
    step, then `--pp 4` through the CLI. Returns (launches, record)."""
    t0 = time.perf_counter()
    wf_l, batch = ct_workflow(dev, 0)
    local = wf_l.build_fused_step()
    sl = local.init_state()
    wf_p, _ = ct_workflow(dev, 0)
    pp = wf_p.build_pipeline_step(devices=[dev] * PP_STAGES,
                                  n_microbatches=PP_MICRO)
    stages = [[type(u).__name__ for u in st] for st in pp.stages]
    if [len(st) for st in stages] != [1] * PP_STAGES:
        raise AssertionError(f"PP stages {stages}")
    sp = pp.init_state()
    losses, counts = [], None
    for i in range(PP_STEPS):
        sl, (ll, el) = local.train(sl, *batch)
        torch.cuda.synchronize()
        # -- the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        sp, (lp, ep) = pp.train(sp, *batch)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
        check_loss(f"PP step {i}", float(lp), float(ll))
        losses.append((float(lp), float(ll), int(ep), int(el)))
    check_counts("PP", counts,
                 {"flash_attention_forward": PP_MICRO * PP_STEPS,
                  "flash_attention_backward": PP_MICRO * PP_STEPS})
    got = pp.params_dicts(sp)
    err = 0.0
    for layer, want in zip(got, sl["params"]):
        for k, t in want.items():
            w = t.detach().cpu().numpy()
            bad = np.abs(layer[k] - w) > TRAIN_ATOL + TRAIN_RTOL * np.abs(w)
            err = max(err, float(np.abs(layer[k] - w).max()))
            if bad.any():
                raise AssertionError(f"PP {k}: max abs err {err:.3e}")
    rec = {"stages": stages, "losses": losses, "max_abs_err": err,
           "launches": counts, "stage_param_bytes": pp.stage_param_bytes(),
           "bubble": (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)}
    rec.update(medians(in_turns((local, sl, batch), (pp, sp, batch))))
    print(f"PP: {PP_STAGES} stages on {dev} {stages}, {PP_MICRO} "
          f"microbatches of {batch[0].shape[0] // PP_MICRO}, {PP_STEPS} "
          f"steps against the local fused step: losses (pp, local, n_err "
          f"pp, local) {losses}, max abs err over every parameter "
          f"{err:.3e}; launches {counts}; stage bytes "
          f"{rec['stage_param_bytes']}; median ms a step (CUDA events, in "
          f"turns): local host {rec['a_host_ms']:.3f} device "
          f"{rec['a_device_ms']:.3f}, pipeline host {rec['b_host_ms']:.3f} "
          f"device {rec['b_device_ms']:.3f} (bubble "
          f"{rec['bubble']:.3f} of a schedule across cards)", flush=True)
    del wf_l, wf_p, local, pp, sl, sp
    torch.cuda.empty_cache()
    # the CLI: one stage on the one card
    wf, cli = train_run(launcher, kernels, dev, "pp",
                        [CHAR_TRANSFORMER, "--pp", str(PP_MICRO), "-r",
                         "1234", *CT_TRAIN_ARGS,
                         "root.char_transformer.decision.max_epochs=1"])
    mb = wf.loader.minibatch_size
    train = -(-wf.loader.class_lengths[2] // mb)
    valid = -(-wf.loader.class_lengths[1] // mb)
    check_counts("TRAIN pp", cli,
                 {"flash_attention_forward": PP_MICRO * (train + valid),
                  "flash_attention_backward": PP_MICRO * train})
    print(f"TRAIN pp: --pp {PP_MICRO}, one stage on {wf.device} of "
          f"{torch.cuda.device_count()} visible card(s): {train} train and "
          f"{valid} validation step(s), K6 and K7 once a microbatch, no K1",
          flush=True)
    rec["cli"] = {"launches": cli, "history": wf.decision.history}
    del wf
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    print(f"PP: the phase in {rec['seconds']:.2f} s", flush=True)
    return {"pp_step": counts, "train_pp": cli}, rec


def autotune_phase(launcher, kernels, libs, dev, card):
    """AUTOTUNE: the generated points of K1-K4 and K6/K7 held and timed,
    then the search on the main path. Returns (the plain --fused run's
    launches, the record)."""
    t0 = time.perf_counter()
    times, smem = autotune_kernel_phase(libs, kernels, dev, card)
    stem = autotune_stem_checks(dev)
    counts, rec = autotune_search_phase(launcher, kernels, dev)
    rec.update({"point_ms": times, "footprints": smem, "conv_stem": stem,
                "seconds": time.perf_counter() - t0})
    print(f"AUTOTUNE: {rec['seconds']:.1f} s", flush=True)
    return counts, rec


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Drive the port on one card.")
    p.add_argument("--seed", type=int, default=1234,
                   help="seed of the FEED phase's packed images")
    p.add_argument("--feed-profile", metavar="DIR", default=None,
                   help=argparse.SUPPRESS)   # feed_profile's child
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on an NVIDIA card", file=sys.stderr)
        return 2
    if args.feed_profile is not None:
        return feed_profile_main(args.feed_profile, args.seed)
    # a plain --fused run applies the autotune cache's winners: every
    # phase reads a cache of this run's own, so that none under HOME
    # changes what a phase launches
    os.makedirs(OUT, exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="autotune_cache_", dir=OUT)
    os.environ["VELES_AUTOTUNE_CACHE"] = os.path.join(cache_dir,
                                                      "autotune.json")
    try:
        return run_phases(args)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases(args) -> int:
    """Every phase in turn, then the records and the last lines."""
    sys.path.insert(0, REPO)
    from veles_tpu_torch import launcher
    from veles_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    bw, flops, tf32, table = card_peaks(torch.cuda.get_device_name(0))
    print(f"peaks ({table}): {bw / 1e12} TB/s, {flops / 1e12} f32 TFLOP/s, "
          f"{tf32 / 1e12} TF32 TFLOP/s; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"BUILD {len(libs)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    regs = print_resource_usage(libs)
    print_spills(kernels)
    print_flash_smem(libs, kernels)
    print_lrn_backward_smem(libs)
    print_forward_smem(libs, regs)
    rows = kernel_phase(kernels, dev, bw, flops)
    backward_rows, k5_other = backward_kernel_phase(kernels, dev, bw, flops)
    rows.update(backward_rows)
    rows.update(flash_kernel_phase(kernels, dev, bw, flops, tf32))
    rows.update(bf16_kernel_phase(kernels, dev, bw, flops))
    conv_stem = conv_stem_phase(dev)
    by_path = {"serve": serve_phase(launcher, kernels, dev)}
    for setting, counts in train_phase(launcher, kernels, dev).items():
        by_path[f"train_{setting}"] = counts
    for setting, counts in train_bf16_phase(launcher, kernels, dev).items():
        by_path[f"train_bf16_{setting}"] = counts
    data_dir = os.path.join(OUT, "feed_data")
    kept = tempfile.mkdtemp(prefix="veles_kept_snapshot_")
    try:
        try:
            feed_launches, feed = feed_phase(launcher, kernels, dev,
                                             args.seed, data_dir)
            resume_launches, resume = resume_phase(
                launcher, kernels, dev, args.seed, data_dir, keep_dir=kept)
            local_launches, local = local_step_phase(
                launcher, kernels, dev, args.seed, data_dir)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        [snap] = [os.path.join(kept, n) for n in os.listdir(kept)
                  if not n.endswith(".sha256")]
        t0 = time.perf_counter()
        with alexnet_config_kept():
            serve_wires_launches, serve_wires = serve_wires_phase(
                launcher, kernels, dev, snap)
        serve_wires["seconds"] = time.perf_counter() - t0
        print(f"SERVE WIRES: the phase in {serve_wires['seconds']:.2f} s",
              flush=True)
        with alexnet_config_kept():
            by_path["fleet"], fleet = fleet_phase(launcher, kernels, dev)
        with alexnet_config_kept():
            aot_launches, aot = aot_phase(launcher, kernels, dev)
        by_path.update(aot_launches)
        with alexnet_config_kept():
            dp_launches, dp = dp_phase(launcher, kernels, dev)
        by_path.update(dp_launches)
        with alexnet_config_kept():
            tp_launches, tp = tp_phase(launcher, kernels, dev)
        by_path.update(tp_launches)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    by_path.update(serve_wires_launches)
    for label, counts in feed_launches.items():
        by_path[f"feed_{label.replace(' ', '_')}"] = counts
    by_path.update(resume_launches)
    by_path.update(local_launches)
    by_path["granular"], granular = granular_phase(launcher, kernels, dev)
    by_path["granular_transformer"], granular_transformer = \
        granular_transformer_phase(launcher, kernels, dev)
    granular_resume_launches, granular_resume = granular_resume_phase(
        launcher, kernels, dev)
    by_path.update(granular_resume_launches)
    by_path["train_transformer"] = transformer_train_phase(launcher,
                                                           kernels, dev)
    by_path["train_transformer_d32"] = transformer_wide_head_phase(
        launcher, kernels, dev)
    by_path["train_transformer_d64"] = transformer_one_head_phase(
        launcher, kernels, dev)
    moe_launches, moe = moe_phase(launcher, kernels, dev)
    by_path.update(moe_launches)
    ep_launches, ep = ep_phase(launcher, kernels, dev)
    by_path.update(ep_launches)
    pp_launches, pp = pp_phase(launcher, kernels, dev)
    by_path.update(pp_launches)
    sample_launches, samples = samples_phase(launcher, kernels, dev, bw,
                                              flops)
    by_path.update({f"samples_{k}": c for k, c in sample_launches.items()})
    by_path["train_transformer_bf16"] = transformer_bf16_phase(
        launcher, kernels, dev)
    from veles_tpu_torch.ops import variants
    checks = step_checks(kernels, variants, dev)
    toy_card_vs_cpu(dev)
    checks["transformer"] = transformer_step_checks(kernels, dev)
    toy_transformer_card_vs_cpu(kernels, dev)
    checks["bf16"] = bf16_step_checks(kernels, variants, dev)
    checks["bf16"]["c_update_distance"] = toy_bf16_card_vs_cpu(dev)
    checks["transformer_bf16"] = transformer_step_checks(kernels, dev,
                                                         "bfloat16")
    # last: its winners are selected for no other phase
    by_path["autotune_fused"], autotune = autotune_phase(launcher, kernels,
                                                         libs, dev, card)

    pallas = "veles_tpu/ops/pallas_kernels.py"
    meta = {
        "sgd_update": ("veles_tpu_torch/csrc/sgd_update.cu",
                       f"{pallas}:97"),
        "lrn_forward": ("veles_tpu_torch/csrc/lrn_forward.cu",
                        f"{pallas}:164"),
        "lrn_backward": ("veles_tpu_torch/csrc/lrn_backward.cu",
                         f"{pallas}:171"),
        "lrn_maxpool_forward": (
            "veles_tpu_torch/csrc/lrn_maxpool_forward.cu", f"{pallas}:349"),
        "lrn_maxpool_backward": (
            "veles_tpu_torch/csrc/lrn_maxpool_backward.cu",
            f"{pallas}:362"),
        "flash_attention_forward": (
            "veles_tpu_torch/csrc/flash_attention_forward.cu",
            f"{pallas}:479"),
        "flash_attention_backward": (
            "veles_tpu_torch/csrc/flash_attention_backward.cu",
            f"{pallas}:553, :595")}
    # the bf16 instances: the same sources and TPU kernels
    meta.update({name: meta[name[:-len("_bf16")]] for name in BF16_KERNELS})
    entries = []
    for name, per_shape in rows.items():
        lib = [r["library_ms"] for r in per_shape]
        entries.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name]
                                 for path, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            # a served or trained batch runs each LRN kernel once per
            # AlexNet shape, and K1 once per leaf: the times below are the
            # sums over the shapes (K2, K4 at batch 64; K3, K5 and the
            # bf16 instances at 128; K6,
            # K7 once at each of the transformer's head widths, 16, 32
            # and 64, one call per train step of each TRAIN transformer
            # run)
            "ms": sum(r["ms"] for r in per_shape),
            "plain_ms": sum(r["plain_ms"] for r in per_shape),
            "bound_ms": sum(r["bound_ms"] for r in per_shape),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in per_shape)
                         else "operations"),
            "library_ms": None if None in lib else sum(lib),
            "shapes": per_shape})
        for key in ("generic_ms", "copy4_ms", "copy2_ms", "f32_ms"):
            # the generic instance, the 4-byte copies (x not 16-byte
            # aligned), a bf16 instance's copies of x 2 bytes off
            # alignment and its f32 instance on the same values, summed
            # like ms, where the kernel has them
            if all(key in r for r in per_shape):
                entries[-1][key] = sum(r[key] for r in per_shape)
        if name in samples["lrn_kernels"]:
            # K2 and K3 at CIFAR-10's LRN input, held and timed apart from
            # AlexNet's shapes (not in the sums above)
            r = samples["lrn_kernels"][name]
            entries[-1]["cifar10_shape"] = r
            entries[-1]["max_abs_err"] = max(entries[-1]["max_abs_err"],
                                             r["max_abs_err"])
        if name in autotune["point_ms"]:
            # the kernel search's generated launch shapes at the main
            # path's shapes, each timed beside the others (AUTOTUNE lines)
            entries[-1]["search_point_ms"] = autotune["point_ms"][name]
        if "bound_f32_ms" in per_shape[0]:
            # K6's and K7's bounds at the tensor cores' TF32 rate, and
            # beside them in f32 on the CUDA cores
            entries[-1]["bound_rate"] = per_shape[0]["bound_rate"]
            entries[-1]["bound_f32_ms"] = sum(r["bound_f32_ms"]
                                              for r in per_shape)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": entries, "launches": by_path,
                   "checks": checks, "k5_other_geometry": k5_other,
                   "feed": feed, "resume": resume, "local_step": local,
                   "granular": granular,
                   "granular_transformer": granular_transformer,
                   "granular_resume": granular_resume,
                   "conv_stem": conv_stem, "samples": samples,
                   "autotune": autotune, "serve_wires": serve_wires,
                   "fleet": fleet, "aot": aot, "dp": dp, "tp": tp,
                   "moe": moe,
                   "ep": ep, "pp": pp},
                  f, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
