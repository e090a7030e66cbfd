"""The multi-process bootstrap of a data-parallel run, and the
scaling-efficiency harness.

The port's counterpart of `veles_tpu/parallel/distributed.py`. The
reference's master (`-l`) / slave (`-m`) become the coordinator and the
workers of one `torch.distributed` process group, one process per card:
`initialize_distributed` joins it over TCP (the coordinator's address,
every process's rank, the world size, all given: nothing on the machine
tells a program of a cluster), on NCCL, one card a process, or on gloo
where the caller asks for the CPU. Every process then runs the same step (the fused dp
mode, parallel/fused.py), and the gradient reduction is a collective
inside it.

Differences from the JAX module: a world of one process is initialized
too (the JAX function returns early there), so that the dp step's
collectives run on one card; and the group is given a timeout
(`timeout_s`), so that a lost peer fails the collective that waits for
it instead of hanging the run.
"""

from __future__ import annotations

import datetime
import time
from typing import Any, Dict, Optional

#: seconds a collective waits for a lost peer before it fails
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(coordinator: str, process_id: int = 0,
                           n_processes: int = 1,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join (or found, for process 0) the process group of
    `n_processes` at `coordinator` ("host:port"). `backend`: "nccl" (the
    default: one card a process, refused without CUDA) or "gloo", which
    the caller names to run on the CPU. Idempotent; returns the
    backend."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    if backend is None:
        backend = "nccl"
    if backend == "nccl":
        from veles_tpu_torch.parallel.mesh import default_device
        torch.cuda.set_device(default_device(process_id))
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=addr, world_size=int(n_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return backend


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """Rank 0 of the group, or a process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# scaling-efficiency harness
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(step_fn, state, batch_fn, *, warmup: int = 3,
                       steps: int = 20, device=None) -> float:
    """Samples/s of `step_fn(state, x, y) -> (state, aux)` fed by
    `batch_fn() -> (x, y)`: on the card the steps are timed by CUDA
    events around them (the card's time), on the CPU by the host
    clock."""
    import torch
    for _ in range(warmup):
        x, y = batch_fn()
        state, _ = step_fn(state, x, y)
    _sync(device)
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        t0, t1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        h0 = time.perf_counter()
    n_samples = 0
    for _ in range(steps):
        x, y = batch_fn()
        state, _ = step_fn(state, x, y)
        n_samples += int(x.shape[0])
    if cuda:
        t1.record()
        t1.synchronize()
        seconds = t0.elapsed_time(t1) / 1e3
    else:
        seconds = time.perf_counter() - h0
    return n_samples / seconds


def scaling_efficiency(workflow, *, mesh, batch_per_chip: int,
                       warmup: int = 3, steps: int = 20) -> Dict[str, Any]:
    """Weak scaling on this process group: samples/s/card of the local
    step on `batch_per_chip` rows (every rank alone, no collectives)
    against the dp step on `mesh` over a global batch of
    `mesh.size * batch_per_chip` rows. With one rank the result is
    trivially 1 and `trivial` says so."""
    import numpy as np
    n = mesh.size
    shape = tuple(workflow.loader.sample_shape)
    rng = np.random.RandomState(0)

    def bench(step, rows):
        x = rng.randn(rows, *shape).astype(np.float32)
        y = rng.randint(0, workflow.n_classes, rows)
        state = step.init_state()
        return measure_throughput(step.train, state, lambda: (x, y),
                                  warmup=warmup, steps=steps,
                                  device=mesh.device)

    per_chip_1 = bench(workflow.build_fused_step(), batch_per_chip)
    per_chip_n = per_chip_1
    if n > 1:
        per_chip_n = bench(workflow.build_fused_step(mesh=mesh),
                           n * batch_per_chip) / n
    return {"chips": n, "measured_chips": n,
            "samples_per_sec_per_chip_1": per_chip_1,
            "samples_per_sec_per_chip_n": per_chip_n,
            "scaling_efficiency": (per_chip_n / per_chip_1
                                   if per_chip_1 > 0 else 0.0),
            "trivial": n == 1}
