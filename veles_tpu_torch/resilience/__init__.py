"""Resilience layer of the port: checkpoint-restart for one host.

The port's counterpart of `veles_tpu/resilience/`, for a single host:

- `supervisor.py` — a `Supervisor` that spawns `python -m
  veles_tpu_torch …`, detects its death and its hangs (a heartbeat file
  touched every epoch) and restarts it from `Snapshotter.latest` with a
  bounded retry budget, exponential backoff with jitter and a
  no-progress cutoff;
- `backoff.py` — the jittered exponential backoff it waits by;
- `faults.py` — deterministic fault injection (`VELES_FAULT_PLAN`):
  `kill@epoch=K`, `hang@epoch=K`, `nan@step=K`,
  `corrupt_snapshot@write=K`, `mirror_corrupt@push=K`;
- `hooks.py` — the process-wide epoch hook registry the Decision fires
  at each epoch boundary (heartbeats and epoch-keyed faults ride it);
- `clock.py` — the time seam of the supervisor's loop;
- `mirror.py` — the snapshot mirror (a second directory or an HTTP blob
  store) the Snapshotter pushes to, restores read from and the serving
  watcher polls.

The cross-host cluster comes with the many-GPU slice. Import-light (the standard library only, no torch): the
supervisor process must never initialize CUDA on the card its children
train on.
"""

from __future__ import annotations

#: the training loop's non-finite-loss guard tripped: the model state is
#: poisoned, so the supervisor rolls back ONE snapshot (the newest one
#: may already embed the divergence) before retrying.
EXIT_NONFINITE = 81

#: the supervisor gave up: retry budget exhausted, or no epoch progress
#: across consecutive restarts (restart-crash loop).
EXIT_GIVEUP = 82

#: a child was killed by the supervisor after its heartbeat went stale.
EXIT_STALLED = 83


class NonFiniteLossError(RuntimeError):
    """Raised by the Decision's non-finite-loss guard
    (``run_fused(nonfinite_guard=True)`` / ``--nonfinite-guard``). The
    launcher maps it to :data:`EXIT_NONFINITE` so a supervising process
    can tell "diverged" from "crashed"."""
