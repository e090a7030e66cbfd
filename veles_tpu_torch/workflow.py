"""Workflow: a container of units that self-schedules a pulse-driven graph.

The port's copy of `veles_tpu/workflow.py` (parity: reference
`veles/workflow.py`: `Workflow`, `StartPoint`, `EndPoint`, `Repeater`) —
`initialize()` walks all units (device injection, allocation, retrying
units whose data links are not ready yet); `run()` fires the start point
and pumps pulses until the end point runs or `stop()` is called; a
per-unit accumulated run-time table is reported at the end (the
reference's built-in profiler).

Scheduling: a single-threaded event loop, as in the JAX package (the
reference used a thread pool because OpenCL kernel enqueues block; CUDA
launches are asynchronous already). The loop is deterministic: units
fire in pulse-arrival order.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional

from veles_tpu_torch.units import Container, TrivialUnit, Unit


class StartPoint(TrivialUnit):
    pass


class EndPoint(TrivialUnit):
    """Running the end point stops the owning workflow's pump."""

    def run(self) -> None:
        self.workflow.on_end_point()


class Repeater(TrivialUnit):
    """OR-gate merge unit used to close training loops (parity: reference
    `Repeater` in `veles/workflow.py`)."""

    or_gate = True


class Workflow(Container):
    """A Unit that contains units and runs them as a pulse-driven graph."""

    def __init__(self, workflow: Optional[Unit] = None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self.stopped = False
        self.device = None
        self._queue: deque = deque()
        self.run_total_time = 0.0

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, device=None, **kwargs: Any) -> None:
        """Initialize all units. Units may return False to be retried after
        the others (mirrors the reference's deferred-initialization loop).
        (The JAX package's static graph verifier, `verify=`, has no
        counterpart in the port.)"""
        self.device = device
        super().initialize(**kwargs)
        pending = list(self.units)
        while pending:
            retry = []
            for unit in pending:
                if unit.initialize(device=device, **kwargs) is False:
                    retry.append(unit)
                else:
                    unit._initialized = True
            if len(retry) == len(pending):
                names = [u.name for u in retry]
                raise RuntimeError(
                    f"workflow initialization deadlock; unresolved: {names}")
            pending = retry

    def schedule(self, unit: Unit) -> None:
        self._queue.append(unit)

    def run(self) -> None:
        """Pump pulses from start_point until end_point or stop()."""
        self.stopped = False
        start = time.perf_counter()
        self._queue.clear()
        for unit in self.units:  # clear stale pulses from any previous run
            for src in unit._links_from:
                unit._links_from[src] = False
        self.schedule(self.start_point)
        try:
            while self._queue and not self.stopped:
                self._queue.popleft().fire()
        finally:
            # teardown must run even when a unit raised (Ctrl-C mid-run
            # used to leave prefetch/plotter threads alive): every unit's
            # stop() is invoked, failures logged, none masking the
            # original exception
            self.run_total_time += time.perf_counter() - start
            self._stop_units()

    def on_end_point(self) -> None:
        self.stopped = True

    def _stop_units(self) -> None:
        for unit in self.units:
            if unit is self:
                continue
            try:
                unit.stop()
            except Exception as e:   # noqa: BLE001 — teardown best-effort
                self.warning("stop() of %s failed: %s", unit.name, e)

    def stop(self) -> None:
        """Stop the pump loop AND release unit-owned background resources
        (prefetch pools, plotter renderer threads) — callable from any
        thread and idempotent."""
        self.stopped = True
        self._stop_units()

    # -- reporting -----------------------------------------------------------

    def print_stats(self) -> str:
        """Per-unit accumulated wall-time table (the reference's end-of-run
        profiler); returns the formatted table and logs it."""
        total = self.run_total_time
        rows = sorted((u for u in self.units if u.run_count),
                      key=lambda u: -u.run_time)
        lines = [f"{'unit':<32} {'runs':>8} {'time':>10} {'%':>6}"]
        for u in rows:
            pct = 100.0 * u.run_time / total if total > 0 else 0.0
            lines.append(
                f"{u.name:<32} {u.run_count:>8} {u.run_time:>9.3f}s {pct:>5.1f}%")
        lines.append(f"{'TOTAL':<32} {'':>8} {total:>9.3f}s")
        table = "\n".join(lines)
        self.info("run-time stats:\n%s", table)
        return table
