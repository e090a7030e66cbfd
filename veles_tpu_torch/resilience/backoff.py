"""Jittered exponential backoff.

The port's copy of `backoff_delay` from `veles_tpu/resilience/backoff.py`
(the supervisor's restart wait; the retrying callers there, the mirror
and the cluster, come with the many-GPU slice): ``min(base * 2^streak,
cap)`` scaled by a random jitter factor in ``[1, 1 + jitter)``. The
exponent is clamped BEFORE the multiply — ``2 ** streak`` overflows
float around streak 1030 — and the jitter decorrelates restarts.

Import-light on purpose (stdlib only): the supervisor process uses this
and must never initialize CUDA.
"""

from __future__ import annotations

import random

#: clamp for the exponent: far past any real cap crossing, far below
#: float overflow (2**30 * any sane base saturates every cap)
MAX_EXPONENT = 30


def backoff_delay(streak: int, *, base: float, cap: float,
                  jitter: float = 0.25) -> float:
    """Delay before retry number ``streak`` (0-based: the first retry
    after the first failure passes 0)."""
    if base <= 0.0:
        return 0.0
    delay = min(base * (2 ** min(max(int(streak), 0), MAX_EXPONENT)),
                cap)
    return delay * (1.0 + jitter * random.random())
