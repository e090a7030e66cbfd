"""Per-device memory accounting: the measured side of every memory claim
(the ZeRO optimizer-state cut, batch sizing).

The port's counterpart of `veles_tpu/parallel/memstats.py`, on PyTorch's
caching allocator:

- `bytes_per_device(tensors)` attributes the bytes of the given tensors
  to their devices (`"cuda:0"`, `"cpu"`): one rule for every per-device
  figure the port reports (`FusedTrainStep.optimizer_state_bytes`);
- `device_memory_limits()` is each card's total memory
  (`torch.cuda.mem_get_info`), the denominator of a static memory model;
- `device_memory_stats()` is the allocator's own view of each card:
  the bytes its live tensors hold (`memory_allocated`), the peak
  (`max_memory_allocated`, what an out-of-memory is made of), the bytes
  reserved from the card and the count of live allocations.

Both device functions never initialize CUDA: a process that has not
touched a card (the supervisor's parent, a CPU run) gets None, as the
JAX functions return None without a backend.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, Optional


def bytes_per_device(tensors: Iterable[Any]) -> Dict[str, int]:
    """{device: bytes} of `tensors` (anything not a tensor is skipped)."""
    import torch
    out: Dict[str, int] = {}
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        key = str(t.device)
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def _cuda_ready() -> bool:
    """True when torch is imported and CUDA has been initialized in this
    process (the never-initializes guard)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 — a build without CUDA
        return False


def device_memory_limits() -> Optional[Dict[str, int]]:
    """{card index: total bytes} of every card this process sees, or None
    where CUDA is not initialized."""
    if not _cuda_ready():
        return None
    import torch
    return {str(i): int(torch.cuda.mem_get_info(i)[1])
            for i in range(torch.cuda.device_count())}


def device_memory_stats() -> Optional[Dict[str, Any]]:
    """Compact per-card memory snapshot of the caching allocator (keys as
    the JAX function's, the card index as a string), or None where CUDA
    is not initialized."""
    if not _cuda_ready():
        return None
    import torch
    live: Dict[str, int] = {}
    peak: Dict[str, int] = {}
    reserved: Dict[str, int] = {}
    n_live = 0
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        live[str(i)] = int(torch.cuda.memory_allocated(i))
        peak[str(i)] = int(torch.cuda.max_memory_allocated(i))
        reserved[str(i)] = int(torch.cuda.memory_reserved(i))
        n_live += int(ms.get("active.all.current", 0))
    return {"n_live_arrays": n_live,
            "live_bytes": live,
            "live_bytes_max": max(live.values(), default=0),
            "bytes_in_use": live,
            "peak_bytes": peak,
            "peak_bytes_max": max(peak.values(), default=0),
            "reserved_bytes": reserved}
