"""Clock seam of the control loops.

The port's copy of `veles_tpu/resilience/clock.py`: the supervisor, the
generation ledger, the mirror's read retries and the serving fleet's
router and beacons read and sleep on time through a :class:`Clock`, so
a test can hand them one it owns: :class:`VirtualClock` (the router's
eviction tests), or a substitute that skips the supervisor's restart
backoff (tests/test_torch_supervisor.py). Production uses
:data:`SYSTEM_CLOCK`, which delegates to the ``time`` module.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """System clock: thin delegating wrapper over the ``time`` module.

    Subclass and override all three methods together — the loops assume
    ``sleep(s)`` advances ``monotonic()`` by at least ``s``. The
    supervisor reads ``time()`` against heartbeat-file mtimes, so a
    substitute keeps ``time()`` on the wall clock.
    """

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


#: Shared default. Stateless, so one instance serves every loop.
SYSTEM_CLOCK = Clock()


class VirtualClock(Clock):
    """Deterministic clock for tests.

    ``monotonic()`` and ``time()`` read one virtual counter (``time()``
    adds a fixed wall offset so timestamps look plausible in meta
    records); ``sleep(s)`` advances it by exactly ``s`` and returns at
    once; ``advance(s)`` pushes time forward without any agent sleeping.
    """

    def __init__(self, start: float = 0.0, wall_offset: float = 1.7e9):
        self._now = float(start)
        self._wall_offset = float(wall_offset)
        self._lock = threading.Lock()
        self.total_slept = 0.0

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def time(self) -> float:
        with self._lock:
            return self._now + self._wall_offset

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)
        with self._lock:
            self.total_slept += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot advance a clock backwards: {seconds}")
        with self._lock:
            self._now += float(seconds)
