"""Process-wide epoch hook registry.

The port's copy of `veles_tpu/resilience/hooks.py`. The Decision calls
:func:`fire_epoch` once per completed training epoch. Heartbeat writers
and epoch-keyed fault injection register here.

Why a module-level registry instead of hooks on the Workflow object:
snapshots pickle the ENTIRE workflow graph (snapshotter.py),
and heartbeat/fault hooks are closures over process-local state (file
paths, fault plans) that must never ride into a snapshot nor survive
into a restored run. Heartbeats and faults are per-process concerns, so
the registry is per-process too.

Zero-cost when empty: `fire_epoch` is one truthiness check per epoch
(not per step), invisible next to an epoch of training.
"""

from __future__ import annotations

from typing import Callable, List

_EPOCH_HOOKS: List[Callable[[int], None]] = []


def add_epoch_hook(fn: Callable[[int], None]) -> Callable[[int], None]:
    """Register `fn(epoch_number)` to run at every epoch boundary.
    Returns `fn` so callers can keep the handle for removal."""
    _EPOCH_HOOKS.append(fn)
    return fn


def remove_epoch_hook(fn: Callable[[int], None]) -> None:
    """Deregister a hook; missing hooks are ignored (teardown paths may
    run twice)."""
    try:
        _EPOCH_HOOKS.remove(fn)
    except ValueError:
        pass


def clear_epoch_hooks() -> None:
    """Drop every hook (test isolation)."""
    del _EPOCH_HOOKS[:]


def fire_epoch(epoch: int) -> None:
    """Run all registered hooks with the completed epoch number. A hook
    may legitimately not return (kill/hang faults) — so hooks run in
    registration order and heartbeat writers must register BEFORE fault
    hooks (the launcher does)."""
    if not _EPOCH_HOOKS:
        return
    for fn in list(_EPOCH_HOOKS):
        fn(epoch)
