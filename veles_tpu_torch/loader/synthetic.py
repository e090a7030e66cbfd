"""Deterministic synthetic datasets (class prototype + gaussian noise).

The port's counterpart of `veles_tpu/loader/synthetic.py`: the same seed
gives the same samples as `SyntheticClassifierLoader` there. The samples
are made at the first minibatch rather than at `initialize`: a server only
needs `sample_shape`, and the full-size AlexNet split is ~400 MB of
floats it would never read; for the same reason a pickle (a snapshot)
leaves them out, and the restored loader makes them again.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def make_classification(n_per_class: Tuple[int, int, int], n_classes: int,
                        sample_shape: Tuple[int, ...], noise: float = 0.35,
                        seed: int = 4242) -> Tuple[np.ndarray, np.ndarray]:
    """Class-prototype + gaussian-noise dataset laid out test|valid|train.
    Deterministic for a given seed regardless of split sizes."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, *sample_shape).astype(np.float32)
    datas, labels = [], []
    for count in n_per_class:  # (test, validation, train) per class
        if count == 0:
            datas.append(np.empty((0,) + tuple(sample_shape), np.float32))
            labels.append(np.empty(0, np.int64))
            continue
        lab = np.tile(np.arange(n_classes), -(-count // n_classes))[:count]
        x = protos[lab] + noise * rng.randn(count, *sample_shape
                                            ).astype(np.float32)
        perm = rng.permutation(count)
        datas.append(x[perm].astype(np.float32))
        labels.append(lab[perm])
    return np.concatenate(datas), np.concatenate(labels)


class SyntheticClassifierLoader(FullBatchLoader):
    """FullBatchLoader over make_classification data; `autoencoder`
    makes the targets the inputs (MSE reconstruction workflows)."""

    def __init__(self, n_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (28, 28),
                 n_test: int = 0, n_validation: int = 200,
                 n_train: int = 1000, noise: float = 0.35,
                 data_seed: int = 4242, autoencoder: bool = False,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.n_classes = n_classes
        self.sample_shape = tuple(sample_shape)
        self.split = (n_test, n_validation, n_train)
        self.noise = noise
        self.data_seed = data_seed
        self.autoencoder = autoencoder

    def load_data(self) -> None:
        # the split sizes fix the index bookkeeping; the samples come on
        # first use (see the module docstring)
        self.class_lengths = list(self.split)

    def __getstate__(self):
        d = super().__getstate__()
        # made again from the seed at the first minibatch after a restore:
        # a snapshot holds no copy of the samples
        d.pop("data", None)
        d.pop("labels", None)
        return d

    def fill_minibatch(self, indices: np.ndarray) -> None:
        if self.data is None:
            data, labels = make_classification(
                self.split, self.n_classes, self.sample_shape, self.noise,
                self.data_seed)
            self.bind_arrays(data, data.copy() if self.autoencoder
                             else labels, *self.split)
        super().fill_minibatch(indices)
