"""Clock seam of the supervisor's loop.

The port's copy of `veles_tpu/resilience/clock.py`: the supervisor
reads and sleeps on time through a :class:`Clock`, so a test can hand
it one that skips the restart backoff (tests/test_torch_supervisor.py).
Production uses :data:`SYSTEM_CLOCK`, which delegates to the ``time``
module. (The JAX package's `VirtualClock` serves its model checker,
which the port does not have.)
"""

from __future__ import annotations

import time


class Clock:
    """System clock: thin delegating wrapper over the ``time`` module
    (the JAX copy's ``monotonic``, which the supervisor does not read,
    is left out).

    The supervisor reads ``time()`` against heartbeat-file mtimes, so a
    substitute keeps ``time()`` on the wall clock.
    """

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


#: Shared default. Stateless, so one instance serves every loop.
SYSTEM_CLOCK = Clock()
