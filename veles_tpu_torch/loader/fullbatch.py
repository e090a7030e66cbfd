"""FullBatchLoader: the whole dataset resident in host memory.

The port's counterpart of `veles_tpu/loader/fullbatch.py`: samples are
indexed out of big host arrays laid out test|validation|train.
"""

from __future__ import annotations

import numpy as np

from veles_tpu_torch.loader.base import Loader


class FullBatchLoader(Loader):
    """Subclasses (or callers) populate `data`/`labels` via
    `bind_arrays`; everything else is inherited minibatch bookkeeping."""

    data = None     # (total, ...sample shape)
    labels = None   # (total,) int labels

    def bind_arrays(self, data: np.ndarray, labels: np.ndarray,
                    n_test: int, n_validation: int, n_train: int) -> None:
        if len(data) != n_test + n_validation + n_train:
            raise ValueError(
                f"{len(data)} samples for splits "
                f"{(n_test, n_validation, n_train)}")
        self.data = np.ascontiguousarray(data)
        self.labels = np.ascontiguousarray(labels)
        self.class_lengths = [n_test, n_validation, n_train]
        self.sample_shape = tuple(self.data.shape[1:])

    def fill_minibatch(self, indices: np.ndarray) -> None:
        out = self.empty_minibatch((len(indices),) + self.data.shape[1:],
                                   self.data.dtype)
        # the indices are the schedule's, all in range: "clip" spares
        # np.take the buffered copy its default "raise" makes
        np.take(self.data, indices, axis=0, out=out, mode="clip")
        self.minibatch_data = out
        self.minibatch_labels = self.labels[indices]
