#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit (nvidia-smi); fail without CUDA.
2. Build the port's CUDA kernels from veles_tpu_torch/csrc/ (nvcc, one
   process per source, all at once) and print the build seconds, then
   BUILD lines: each compiled kernel function's registers, stack, local
   memory (spills land there) and static shared memory, its stack frame's
   spill stores and loads as ptxas reports them, the dynamic
   shared memory K6 takes per block at each head width and K3 at
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
     it to is printed). Before that, K6 and
     K7 at every head width they are compiled for (8, 16, 32) on a
     ragged S = 200, causal or not, KV forward or reversed, with and
     without a dropout mask (FLASH lines).
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
   variant printed); then an attention unit at 1 head of 64, a width
   K6/K7 are not compiled for, must be refused on the card under "auto"
   (ValueError), with no fallback to the einsum.
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
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
ALEXNET = os.path.join(REPO, "veles_tpu_torch", "samples", "alexnet.py")
CHAR_TRANSFORMER = os.path.join(REPO, "veles_tpu_torch", "samples",
                                "char_transformer.py")
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
#: heads of 16, and 2 heads of 32 (TRAIN transformer n_heads=2)
ATT_SHAPES = ((32, CT_SEQ, 4, 16), (32, CT_SEQ, 2, 32))
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
    """BUILD line: the dynamic shared memory one K6 block takes at each
    compiled head width, as the kernel's own source computes it
    (cuobjdump reads only the static size)."""
    lib = ctypes.CDLL(str(libs["flash_attention_forward"]))
    smem = lib.flash_attention_forward_smem_bytes
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int
    sizes = ", ".join(f"D {d}: {smem(d)} B" for d in kernels.FLASH_HEAD_DIMS)
    print(f"BUILD flash_attention_forward dynamic shared memory per block: "
          f"{sizes}", flush=True)


def print_lrn_backward_smem(libs):
    """BUILD line: the dynamic shared memory one K3 block takes at each of
    AlexNet's LRN widths, as the kernel's own source computes it."""
    lib = ctypes.CDLL(str(libs["lrn_backward"]))
    smem = lib.lrn_backward_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
    sizes = ", ".join(f"C {c}: {smem(c, N // 2)} B"
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
    k4.argtypes = [ctypes.c_int] * 10
    k4.restype = ctypes.c_int
    k2 = ctypes.CDLL(str(libs["lrn_forward"])).lrn_forward_smem_bytes
    k2.argtypes = [ctypes.c_int] * 2
    k2.restype = ctypes.c_int
    for layer, (h, w, c) in zip(("L1", "L2"), LRN_SHAPES):
        for name, smem in (
                ("lrn_maxpool_forward",
                 k4(h, w, c, *pool_out_hw(h, w, 3, 3, 2, 2), 3, 3, 2, 2,
                    N // 2)),
                ("lrn_forward", k2(c, N // 2))):
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


def plain_forward(srv, kernels, x: np.ndarray) -> np.ndarray:
    """The served model on the card in full f32 with every LRN through its
    plain version and no fused pair: the reference the served outputs are
    held against. Rows are padded into the same 64-row ring the server
    runs."""
    from veles_tpu_torch.backends import full_f32
    ring = np.zeros((srv.ring_slots,) + x.shape[1:], np.float32)
    ring[:len(x)] = x
    h = torch.from_numpy(ring).to(srv.device)
    with torch.inference_mode(), full_f32(srv.device):
        for u, p in zip(srv._fwd.forwards, srv._fwd.params()):
            if getattr(u, "variant_op", None) == "lrn":
                h = kernels.lrn_forward_plain(h, u.k, u.alpha, u.beta, u.n)
            else:
                h = u.fused_apply(p, h, train=False)
        return torch.softmax(h, dim=-1)[:len(x)].cpu().numpy()


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
                    return fwd._apply_fused_pair(v, u, fwd.forwards[j], h)
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
                ref = plain_forward(srv, kernels, x.astype(np.float32))
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
    at 1 head of 64, a width they are not compiled for, must be refused on
    the card under "auto" (no fallback to the einsum)."""
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    counts = transformer_run(launcher, kernels, dev, "transformer n_heads=2",
                             ["root.char_transformer.n_heads=2"], 1)
    wide = MultiHeadAttention(n_heads=1, use_flash="auto")
    wide.initialize((CT_SEQ, 64), dev)
    x = torch.randn(1, CT_SEQ, 64, device=dev)
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
    read the HtoD copies' streams and overlap with the step's kernels."""
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
    if not s["batch_overlap_ms"] > 0:
        raise AssertionError(f"FEED profile: no batch copy overlaps a "
                             f"kernel of the step: {s}")
    return s


def feed_overlap(events):
    """(summary, GPU events) of a chrome trace's batch copies: their
    streams, whether pinned, their overlap with the compute stream's
    kernels, and whether any waited for compute work queued before it
    was issued."""
    gpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # when the host issued each kernel and copy (the runtime call's start)
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
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
        at = issued.get(e["args"].get("correlation"))
        # compute-stream work queued before the copy was issued and not
        # done by then: a copy that waited for it ran after the step
        pending = [k["ts"] + k["dur"] for k in on_compute
                   if at is not None
                   and issued.get(k["args"].get("correlation"), at) < at
                   and k["ts"] + k["dur"] > at]
        rows.append({"name": e["name"], "stream": e["args"].get("stream"),
                     "bytes": e["args"].get("bytes"), "ms": e["dur"] / 1e3,
                     "overlap_ms": ov / 1e3, "issued": at is not None,
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
    return summary, gpu


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
        torch.cuda.synchronize()
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


def feed_phase(launcher, kernels, dev, seed: int):
    """FEED: the full-width AlexNet, batch 128, bf16 over f32 master
    weights, lrn_maxpool fused, 2 epochs per run through
    `launcher.train`: (a) the uint8 wire from a packed memmap, (b) the f32
    wire from the same memmap, (c) the synthetic loader's f32 wire, each
    at feed_ahead 1, 0, 0, 1. Returns (launches of each wire's first run,
    the records)."""
    from veles_tpu_torch import native_gather
    data_dir = os.path.join(OUT, "feed_data")
    shutil.rmtree(data_dir, ignore_errors=True)
    try:
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
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return launches, {"runs": records, "profile": profile,
                      "head_max_abs_diff": err}


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
    by_path = {"serve": serve_phase(launcher, kernels, dev)}
    for setting, counts in train_phase(launcher, kernels, dev).items():
        by_path[f"train_{setting}"] = counts
    for setting, counts in train_bf16_phase(launcher, kernels, dev).items():
        by_path[f"train_bf16_{setting}"] = counts
    feed_launches, feed = feed_phase(launcher, kernels, dev, args.seed)
    for label, counts in feed_launches.items():
        by_path[f"feed_{label.replace(' ', '_')}"] = counts
    by_path["train_transformer"] = transformer_train_phase(launcher,
                                                           kernels, dev)
    by_path["train_transformer_d32"] = transformer_wide_head_phase(
        launcher, kernels, dev)
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
            # K7 once at each of the transformer's head widths, 16 and 32,
            # one call per train step of each TRAIN transformer run)
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
                   "feed": feed}, f, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
