"""Seeded PRNG registry: numpy RandomState streams for host code,
`torch.Generator`s for device randomness.

The port's counterpart of `veles_tpu/prng.py`. The host half is the same
numpy `RandomState` stream under the same `get` / `seed_all` rules, so
weight fills and shuffles under one seed come out bit-identical to the
JAX package's. Device randomness cannot match jax keys; it comes from a
`torch.Generator` seeded from the same seed (the fused train step draws
its dropout masks from one).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class RandomGenerator:
    """A named generator: a numpy `RandomState` (shuffles, weight fills on
    the host) plus the seed its device generators start from."""

    def __init__(self, name: str, seed: int = 1234) -> None:
        self.name = name
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self.state = np.random.RandomState(self._seed)

    # -- host (numpy) --------------------------------------------------------

    def shuffle(self, arr) -> None:
        self.state.shuffle(arr)

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
        generator's seed."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self._seed)
        return gen


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
