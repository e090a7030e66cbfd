"""Per-unit distributed-training protocol interface.

The port's copy of `veles_tpu/distributable.py` (parity: reference
`veles/distributable.py`, `IDistributable`): the per-unit
generate/apply-data-for-slave/master protocol that the JAX package's
`Loader` mixes in (the minibatch index job piece). Gradients never travel
through it: a many-card run averages them inside its step. Methods raise
NotImplementedError: each implementor overrides the subset of the
protocol it serves, and an unimplemented hook fails loudly instead of
silently doing nothing.
"""

from __future__ import annotations

from typing import Any, Optional


class IDistributable:
    """Duck-typed interface (the reference used zope.interface)."""

    def generate_data_for_slave(self, slave: Any) -> Any:
        """Master -> slave job piece (reference semantics: weights /
        index ranges; here: row masks, leases)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not hand out slave jobs")

    def apply_data_from_master(self, data: Any) -> None:
        """Slave applies a job piece / role directive from the master."""
        raise NotImplementedError(
            f"{type(self).__name__} does not accept master data")

    def generate_data_for_master(self) -> Any:
        """Slave -> master update piece (reference: weight deltas /
        metrics; here: metrics, snapshot state)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not report to a master")

    def apply_data_from_slave(self, data: Any, slave: Optional[Any] = None
                              ) -> None:
        """Master ingests a slave's update piece (here: posted fitness
        results)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not ingest slave updates")

    def drop_slave(self, slave: Any) -> None:
        """Slave disconnected; re-queue its outstanding work (reference
        fault model). Implemented for real by the population-parallel
        lease queue; the SPMD train step's equivalent is
        restart-from-snapshot (snapshotter.py)."""
        raise NotImplementedError(
            f"{type(self).__name__} tracks no per-slave work")
