"""Dropout unit: identity when not training.

The port's counterpart of `DropoutForward` in
`veles_tpu/znicz/dropout.py`. Serving runs with train=False, where dropout
is the identity (dropout.py:74-76 there). Masks drawn from a
`torch.Generator` come with the training slice.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.znicz.nn_units import Forward


class DropoutForward(Forward):

    def __init__(self, dropout_ratio: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.dropout_ratio = dropout_ratio

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def fused_apply(self, params, x, *, train=False):
        if train:
            raise NotImplementedError(
                "dropout masks come with the training slice; the serving "
                "slice runs train=False")
        return x
