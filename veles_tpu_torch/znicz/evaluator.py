"""Softmax evaluator: the loss, the error's derivative and the metrics.

The port's counterpart of `EvaluatorSoftmax` in
`veles_tpu/znicz/evaluator.py`. In the fused loop it is the holder of one
class pass's `loss` (the pad-mask weighted mean cross-entropy) and
`n_err` (misclassified valid rows), which `StandardWorkflow` writes at
each class-pass boundary and the Decision reads; the step computes them
(parallel/fused.py). In the granular graph it is a unit: from the softmax
unit's probabilities (`input`), the loader's labels and pad mask
(`sample_weights`), each firing computes the minibatch's loss, `n_err`
and `err_output` — (probs − onehot)·w / Σw, the error with respect to the
logits that `GDSoftmax` takes — with the golden `reference.softmax_ce` on
the numpy backend and `functional.softmax_ce` on the unit's device on the
torch one, whose two scalars cross to the host once per minibatch for
the Decision. The confusion matrix comes with a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import dev, host


class EvaluatorSoftmax(AcceleratedUnit):

    def __init__(self, workflow=None, n_classes: int = 10,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.n_classes = n_classes
        self.input = Array()        # the softmax unit's probabilities
        self.labels = Array()
        #: (N,) sample weights: StandardWorkflow links the loader's pad
        #: mask here; unlinked, every row weighs 1
        self.sample_weights = Array()
        self.err_output = Array()
        self.loss = 0.0
        self.n_err = 0

    def _weights(self):
        w = self.sample_weights
        return None if w is None or (isinstance(w, Array) and not w) \
            else w

    def numpy_run(self) -> None:
        probs = host(self.input)
        w = self._weights()
        loss, err, n_err, _ = ref.softmax_ce(
            probs, host(self.labels), self.n_classes,
            weights=(np.ones(len(probs), np.float32) if w is None
                     else host(w)))
        self.loss = loss
        self.err_output.mem = err
        self.n_err = n_err

    def torch_run(self) -> None:
        d = self.device
        w = self._weights()
        loss, err, n_err = fn.softmax_ce(
            dev(self.input, d), dev(self.labels, d), self.n_classes,
            weights=None if w is None else dev(w, d))
        self.err_output.set_devmem(err)
        # the scalars cross to the host here: the Decision is host logic
        self.loss = float(loss)
        self.n_err = int(n_err)
