"""What calling K2 and K4 through their operators costs the eager paths.

K2 and K4 are also the `torch.library` operators `veles::lrn_forward`
and `veles::lrn_maxpool_forward` (veles_tpu_torch/ops/kernels.py), so
that a `torch.export` program keeps the hand kernels; the LRN autograd
functions call them while a program is traced, and the kernels' ctypes
wrappers otherwise. This script times, on the card, in the port found
at --root (default: the directory that holds this script), and so
compares a tree with another whose functions call otherwise:

- per call, at batch 1 of AlexNet's two LRN shapes (a kernel of a few
  microseconds, so the host's dispatch shows): host us of the autograd
  function (`LRNMaxPoolFunction`, `LRNFunction`), and, where the tree
  has the operators, of each operator against its wrapper on the same
  tensor;
- the full-width AlexNet's fused train step (batch 128, `lrn_maxpool`
  fused: K4/K5, K1), f32 and bf16 over f32 masters: host ms and device
  ms a step over STEPS steps queued back to back, the card synchronized
  at both ends (CUDA events for the device);
- a 64-row ring round of the eager server per wire (f32, bf16, int8,
  `InferenceServer._serve`): device ms (CUDA events) and host ms to
  enqueue it;
- with `dp` among --sections, the same train step data-parallel at world
  size 1 on NCCL (ZeRO on, as chip_smoke.py's DP), f32 and bf16.

It prints one JSON line and writes it to --out. Two trees are compared
in one call, in turns (A, B, B, A): unpack the other tree into a
directory that .gitignore lists and give it as --root.

    python3 op_dispatch_cost.py [--root DIR] [--label NAME] [--out FILE]
        [--sections per_call,train,ring,dp]

It needs a card; the weights are random, from seed 1234.
"""

import argparse
import json
import os
import subprocess
import sys
import time

#: steps, ring rounds and calls timed (after a warm-up of as many)
STEPS, ROUNDS, CALLS = 20, 20, 400
#: AlexNet: the training minibatch, the ring, the input side, classes
TB, RING, HW, N_CLASSES = 128, 64, 227, 1000
#: AlexNet's LRN (k, alpha, beta, n) and pool, and its two LRN inputs
LRN = (2.0, 1e-4, 0.75, 5)
POOL = ((3, 3), (2, 2))
SHAPES = ((1, 55, 55, 96), (1, 27, 27, 256))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def host_us(torch, fn, calls: int = CALLS) -> float:
    """Host us a call of `fn()` over `calls` calls, after as many as a
    warm-up, the card synchronized at both ends."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def per_call(torch, kernels, dev):
    """Host us a call of the autograd functions, the operators and the
    wrappers, in turns (wrapper, operator, operator, wrapper)."""
    out = {}
    has_ops = hasattr(kernels, "lrn_maxpool_forward_op")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            x = torch.randn(shape, device=dev).to(dtype)
            key = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} " \
                  f"{'x'.join(map(str, shape))}"
            r = {"lrn_maxpool_function": host_us(
                     torch, lambda: kernels.LRNMaxPoolFunction.apply(
                         x, *LRN, *POOL)),
                 "lrn_function": host_us(
                     torch, lambda: kernels.LRNFunction.apply(x, *LRN))}
            if has_ops:
                ks, st = [list(v) for v in POOL]
                calls = {
                    "lrn_maxpool_wrapper": lambda: kernels
                    .lrn_maxpool_forward(x, *LRN, *POOL),
                    "lrn_maxpool_operator": lambda: kernels
                    .lrn_maxpool_forward_op(x, *LRN, ks, st, 0, 0),
                    "lrn_wrapper": lambda: kernels.lrn_forward(x, *LRN),
                    "lrn_operator": lambda: kernels.lrn_forward_op(
                        x, *LRN, 0)}
                turns = {k: [] for k in calls}
                for order in (("wrapper", "operator"),
                              ("operator", "wrapper")):
                    for kind in order:
                        for name in ("lrn_maxpool", "lrn"):
                            k = f"{name}_{kind}"
                            turns[k].append(host_us(torch, calls[k]))
                r.update(turns)
            out[key] = r
    return out


def train_steps(torch, dev, compute_dtype, mesh=None):
    """The full-width AlexNet's fused step (data-parallel on `mesh`, ZeRO
    on, where given): host and device ms a step over STEPS steps queued
    back to back, twice."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    wf.initialize(dev)
    kw = {} if mesh is None else {"mesh": mesh, "zero_sharding": "on"}
    step = wf.build_fused_step(compute_dtype=compute_dtype, **kw)
    state = step.init_state()
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    x = torch.randn((TB, HW, HW, 3), generator=gen, device=dev)
    y = torch.randint(0, N_CLASSES, (TB,), generator=gen, device=dev)
    w = torch.ones(TB, device=dev)
    for _ in range(STEPS):
        state, _ = step.train(state, x, y, w)
    rec = {"host_ms": [], "device_ms": []}
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(STEPS):
            state, _ = step.train(state, x, y, w)
        end.record()
        end.synchronize()
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3 / STEPS)
        rec["device_ms"].append(start.elapsed_time(end) / STEPS)
    del wf, step, state
    torch.cuda.empty_cache()
    return rec


def dp_steps(torch, dev, compute_dtype):
    """`train_steps` data-parallel: one rank of a process group on NCCL."""
    import socket

    from veles_tpu_torch.parallel import distributed
    from veles_tpu_torch.parallel.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_distributed(f"127.0.0.1:{port}", 0, 1)
    try:
        return train_steps(torch, dev, compute_dtype, mesh=make_mesh())
    finally:
        distributed.shutdown_distributed()


def ring_rounds(torch, dev, wire):
    """A 64-row eager ring round through `wire`: device ms and host ms to
    enqueue, over ROUNDS rounds, twice."""
    import numpy as np
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import alexnet
    from veles_tpu_torch.serving import InferenceServer
    prng.seed_all(1234)
    wf = alexnet.create_workflow()
    srv = InferenceServer(wf, ring_slots=RING, quantize=wire, device=dev)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        RING, HW, HW, 3).astype(np.float32)).to(dev)
    params = srv._gens.params
    for _ in range(ROUNDS):
        srv._serve(params, x)
    rec = {"device_ms": [], "enqueue_ms": []}
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(ROUNDS):
            srv._serve(params, x)
        enqueue = (time.perf_counter() - t0) * 1e3 / ROUNDS
        end.record()
        end.synchronize()
        rec["enqueue_ms"].append(enqueue)
        rec["device_ms"].append(start.elapsed_time(end) / ROUNDS)
    del srv, wf
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose veles_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for the record")
    p.add_argument("--out", help="also write the JSON record here")
    p.add_argument("--sections", default="per_call,train,ring",
                   help="comma-separated: per_call, train, ring, dp")
    args = p.parse_args(argv)
    sections = set(args.sections.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("op_dispatch_cost.py needs a card", file=sys.stderr)
        return 1
    import veles_tpu_torch
    from veles_tpu_torch.ops import kernels
    if not os.path.abspath(veles_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {veles_tpu_torch.__file__}, not the "
                           f"tree at {root}")
    kernels.build()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rec = {"label": args.label, "root": root, "card": card_line(),
           "torch": torch.__version__,
           "operators": hasattr(kernels, "lrn_maxpool_forward_op")}
    if "per_call" in sections:
        rec["per_call_us"] = per_call(torch, kernels, dev)
    if "train" in sections:
        rec["train"] = {dt or "f32": train_steps(torch, dev, dt)
                        for dt in (None, "bfloat16")}
    if "ring" in sections:
        rec["ring"] = {wire: ring_rounds(torch, dev, wire)
                       for wire in ("f32", "bf16", "int8")}
    if "dp" in sections:
        rec["dp"] = {dt or "f32": dp_steps(torch, dev, dt)
                     for dt in (None, "bfloat16")}
    rec["seconds"] = time.perf_counter() - t0
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
