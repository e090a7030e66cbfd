"""Loader base: the minibatch engine, reduced to what serving and the
fused training loop need.

The port's counterpart of `veles_tpu/loader/base.py`: the three sample
classes (TEST=0, VALIDATION=1, TRAIN=2), the seeded per-epoch shuffle of
the train set, and static-size minibatches whose final one per class wraps
around with a `minibatch_valid` pad mask. The index math and every draw
from `prng.get()` happen in the JAX package's order, so the same seed
gives the same minibatch sequence — and leaves the default generator in
the same state for the weight fills that follow. `minibatch_class`,
`last_minibatch` and `class_lengths` drive the Decision. Class-balanced
sampling, prefetching and the device feed come with a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from veles_tpu_torch import prng

TEST, VALIDATION, TRAIN = 0, 1, 2


class Loader:
    """Subclasses implement `load_data()` (fill `class_lengths` and
    `sample_shape`) and `fill_minibatch(indices)`."""

    def __init__(self, minibatch_size: int = 100,
                 shuffle_train: bool = True,
                 name: Optional[str] = None) -> None:
        self.name = name or type(self).__name__
        self.minibatch_size = int(minibatch_size)
        self.shuffle_train = shuffle_train
        self.class_lengths: List[int] = [0, 0, 0]
        #: per-sample shape every minibatch row (and every served request
        #: row) has
        self.sample_shape: Tuple[int, ...] = ()
        self.minibatch_data: Optional[np.ndarray] = None
        self.minibatch_labels: Optional[np.ndarray] = None
        self.minibatch_indices: Optional[np.ndarray] = None
        #: (minibatch_size,) 0/1 pad mask: 0 on wrap-around filler rows
        self.minibatch_valid: Optional[np.ndarray] = None
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.epoch_ended = False
        self.epoch_number = 0
        self._schedule: List[Tuple[int, int, bool]] = []
        self._cursor = 0
        self._indices_per_class: List[np.ndarray] = [
            np.empty(0, np.int64)] * 3

    # -- subclass contract ---------------------------------------------------

    def load_data(self) -> None:
        raise NotImplementedError

    def fill_minibatch(self, indices: np.ndarray) -> None:
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------

    def initialize(self) -> None:
        self.load_data()
        offset = 0
        for cls in (TEST, VALIDATION, TRAIN):
            n = self.class_lengths[cls]
            self._indices_per_class[cls] = np.arange(
                offset, offset + n, dtype=np.int64)
            offset += n
        self._start_epoch()

    def _start_epoch(self) -> None:
        if self.shuffle_train:
            prng.get().shuffle(self._indices_per_class[TRAIN])
        self._schedule = []
        for cls in (TEST, VALIDATION, TRAIN):
            n = self.class_lengths[cls]
            if n == 0:
                continue
            n_batches = -(-n // self.minibatch_size)  # ceil
            for b in range(n_batches):
                self._schedule.append((cls, b, b == n_batches - 1))
        self._cursor = 0

    def run(self) -> None:
        """Produce the next minibatch of the schedule."""
        cls, b, last = self._schedule[self._cursor]
        idx = self._indices_per_class[cls]
        lo = b * self.minibatch_size
        take = np.arange(lo, lo + self.minibatch_size) % len(idx)
        chosen = idx[take]
        self.minibatch_class = cls
        self.last_minibatch = last
        self.minibatch_indices = chosen
        self.minibatch_valid = (np.arange(lo, lo + self.minibatch_size)
                                < len(idx)).astype(np.float32)
        self.fill_minibatch(chosen)
        self._cursor += 1
        self.epoch_ended = self._cursor >= len(self._schedule)
        if self.epoch_ended:
            self.epoch_number += 1
            self._start_epoch()
