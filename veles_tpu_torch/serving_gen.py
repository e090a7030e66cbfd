"""Blue/green weight generations of the serving tier.

The port's copy of `veles_tpu/serving_gen.py`: one object owns the live
(label, params) pair, the one previous pair kept on the device as the
rollback target, the swap counter and the digests rolled back from, so
that each transition (boot, commit, rollback) is one method call that
publishes the label and the params together.

The params handle is opaque here (the server's tree of tensors on the
card). Not thread-safe by itself: `InferenceServer` calls every mutator
under its condition lock, and its ring reads `params` once per round
without it (one attribute load).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set, Tuple

from veles_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock


class GenerationLedger:
    """The live (label, params) pair, one previous pair as the rollback
    target, the swap counter, and the rolled-back digests the
    WeightWatcher skips."""

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self._clock = clock or SYSTEM_CLOCK
        #: the live generation label: {"digest", "since", "source"}
        self.generation: Dict[str, Any] = {
            "digest": "boot", "since": self._clock.time(),
            "source": "boot"}
        self.prev_gen: Optional[Dict[str, Any]] = None
        #: the live params, read by the ring once per round
        self.params: Any = None
        self.prev_params: Any = None
        self.n_swaps = 0
        #: digests rolled back FROM: the watcher does not re-apply them
        #: until a new digest is pushed
        self.rolled_back: Set[str] = set()

    def boot(self, digest: str, params: Any,
             source: str = "boot") -> Dict[str, Any]:
        """Publish the startup generation (nothing to roll back to)."""
        self.params = params
        self.generation = {"digest": digest,
                           "since": self._clock.time(),
                           "source": source}
        return dict(self.generation)

    def commit(self, digest: str, source: str,
               params: Any) -> Dict[str, Any]:
        """Make a validated candidate the live generation; the outgoing
        pair becomes the rollback target."""
        self.prev_params = self.params
        self.prev_gen = dict(self.generation)
        self.params = params
        self.generation = {"digest": digest,
                           "since": self._clock.time(),
                           "source": source}
        self.n_swaps += 1
        return dict(self.generation)

    def rollback(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Swap the live and previous pairs and pin the outgoing digest.
        Returns (restored label, outgoing label); LookupError when no
        previous generation is resident."""
        if self.prev_params is None:
            raise LookupError("no previous generation is resident")
        self.params, self.prev_params = self.prev_params, self.params
        outgoing = dict(self.generation)
        restored = dict(self.prev_gen or {})
        self.generation = {"digest": restored.get("digest", "boot"),
                           "since": self._clock.time(),
                           "source": "rollback"}
        self.prev_gen = outgoing
        self.rolled_back.add(str(outgoing["digest"]))
        self.n_swaps += 1
        return dict(self.generation), outgoing

    def snapshot(self) -> Dict[str, Any]:
        """A copy of the live label."""
        return dict(self.generation)
