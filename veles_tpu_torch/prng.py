"""Seeded PRNG registry: numpy RandomState streams for host code,
`torch.Generator` streams for device randomness.

The port's counterpart of `veles_tpu/prng.py`. The host half is the same
numpy `RandomState` stream under the same `get` / `seed_all` rules, so
weight fills and shuffles under one seed come out bit-identical to the
JAX package's. Device randomness cannot match jax keys; it comes from
torch generators seeded from the same seed. `device_stream(device)` is
the generator's stream on a device type: made once, it advances across
every step built on it (the fused train step draws its dropout masks
from it), as the JAX step draws a new key split from the registry
(`next_key`) rather than restarting from the seed. A pickled generator
carries its numpy state and each device stream's position
(`torch.Generator.get_state()`, a CPU byte tensor), and
`snapshot_registry` / `restore_registry` carry the whole registry
through a snapshot, so a restored run continues the streams of the run
it was taken from.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class RandomGenerator:
    """A named generator: a numpy `RandomState` (shuffles, weight fills on
    the host) plus its device streams, seeded from the same seed."""

    def __init__(self, name: str, seed: int = 1234) -> None:
        self.name = name
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self.state = np.random.RandomState(self._seed)
        #: device type -> the stream made there
        self._streams: Dict[str, torch.Generator] = {}
        #: device type -> a restored stream position, applied when the
        #: stream is made
        self._stream_states: Dict[str, torch.Tensor] = {}

    # -- host (numpy) --------------------------------------------------------

    def shuffle(self, arr) -> None:
        self.state.shuffle(arr)

    def permutation(self, n: int) -> np.ndarray:
        return self.state.permutation(n)

    def randint(self, low: int, high: Optional[int] = None, size=None):
        return self.state.randint(low, high, size)

    def fill_uniform(self, shape, low: float, high: float,
                     dtype=np.float32) -> np.ndarray:
        """Weight-init fill (parity: reference `Forward` uniform fills)."""
        return self.state.uniform(low, high, size=shape).astype(dtype)

    def fill_normal(self, shape, mean: float = 0.0, stddev: float = 1.0,
                    dtype=np.float32) -> np.ndarray:
        return self.state.normal(mean, stddev, size=shape).astype(dtype)

    # -- device (torch) ------------------------------------------------------

    def torch_generator(self, device) -> torch.Generator:
        """A fresh `torch.Generator` on `device`, seeded from this
        generator's seed (two calls draw the same numbers)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self._seed)
        return gen

    def device_stream(self, device) -> torch.Generator:
        """This generator's stream on `device`'s type: made on first use
        from the seed, or from the position a restored pickle carried,
        and the same object afterwards, so it advances across the steps
        that draw from it."""
        kind = torch.device(device).type
        gen = self._streams.get(kind)
        if gen is None:
            gen = self.torch_generator(device)
            restored = self._stream_states.pop(kind, None)
            if restored is not None:
                gen.set_state(restored)
            self._streams[kind] = gen
        return gen

    def __getstate__(self):
        streams = dict(self._stream_states)
        streams.update({k: g.get_state() for k, g in self._streams.items()})
        return {"name": self.name, "_seed": self._seed,
                "np_state": self.state.get_state(), "streams": streams}

    def __setstate__(self, state):
        self.name = state["name"]
        self.seed(state["_seed"])
        self.state.set_state(state["np_state"])
        self._stream_states = dict(state["streams"])


_generators: Dict[str, RandomGenerator] = {}
_base_seed: Optional[int] = None


def get(name: str = "default",
        seed: Optional[int] = None) -> RandomGenerator:
    """Fetch (creating on first use) the named global generator. An
    explicit `seed` wins; otherwise a prior `seed_all(s)` governs
    generators created later too: they get s + registration_index, exactly
    as if they had existed at seed_all time (the JAX package's rule)."""
    gen = _generators.get(name)
    if gen is None:
        if seed is None:
            seed = (_base_seed + len(_generators)
                    if _base_seed is not None else 1234)
        gen = _generators[name] = RandomGenerator(name, seed)
    return gen


def seed_all(seed: int) -> None:
    """Reseed every registered generator — and every FUTURE one —
    deterministically."""
    global _base_seed
    _base_seed = int(seed)
    for i, gen in enumerate(_generators.values()):
        gen.seed(seed + i)


def snapshot_registry() -> dict:
    """A picklable copy of the global registry (the base seed and every
    generator with its streams' positions). The Snapshotter embeds it in
    every snapshot: shuffles and dropout masks draw from it outside the
    workflow, and restoring it is what makes a resumed run continue the
    uninterrupted run's streams."""
    return {"base_seed": _base_seed, "generators": dict(_generators)}


def restore_registry(snap: dict) -> None:
    """Install a registry captured by `snapshot_registry` (resume)."""
    global _base_seed
    _base_seed = snap["base_seed"]
    _generators.clear()
    _generators.update(snap["generators"])
