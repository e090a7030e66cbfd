"""Jittered exponential backoff.

The port's copy of `veles_tpu/resilience/backoff.py`: `backoff_delay`
(the supervisor's restart wait, the serving watcher's poll stretch) is
``min(base * 2^streak, cap)`` scaled by a random jitter factor in
``[1, 1 + jitter)``, and `call_with_backoff` retries a call by it within
a wall-clock budget (the HTTP mirror's transient failures; the
cluster's callers come with the many-GPU slice). The exponent is
clamped BEFORE the multiply — ``2 ** streak`` overflows float around
streak 1030 — and the jitter decorrelates restarts.

Import-light on purpose (stdlib only): the supervisor process uses this
and must never initialize CUDA.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

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


def call_with_backoff(fn: Callable, *, attempts: int, base: float,
                      cap: float, total: Optional[float] = None,
                      retry_on: Tuple[Type[BaseException], ...]
                      = (Exception,),
                      jitter: float = 0.25,
                      sleep: Callable[[float], None] = time.sleep,
                      clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` up to ``attempts`` times, sleeping a `backoff_delay`
    between failures of the ``retry_on`` kinds; the last failure
    re-raises. ``total`` bounds the seconds of all attempts and sleeps:
    when the next wait would cross it, the failure re-raises at once."""
    deadline = None if total is None else clock() + float(total)
    n = max(int(attempts), 1)
    for streak in range(n):
        try:
            return fn()
        except retry_on:
            if streak + 1 >= n:
                raise
            delay = backoff_delay(streak, base=base, cap=cap, jitter=jitter)
            if deadline is not None and clock() + delay >= deadline:
                raise
            sleep(delay)
    raise RuntimeError("unreachable")
