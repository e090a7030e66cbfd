"""Softmax evaluator of the fused training loop.

The port's counterpart of `EvaluatorSoftmax` in
`veles_tpu/znicz/evaluator.py` as the fused loop uses it: the holder of
one class pass's `loss` (the pad-mask weighted mean cross-entropy) and
`n_err` (misclassified valid rows), which `StandardWorkflow` writes at each
class-pass boundary and the Decision reads. The step itself computes
them (parallel/fused.py). The confusion matrix comes with a later slice.
"""

from __future__ import annotations

from typing import Optional


class EvaluatorSoftmax:

    def __init__(self, n_classes: int = 10,
                 name: Optional[str] = None) -> None:
        self.name = name or type(self).__name__
        self.n_classes = n_classes
        self.loss = 0.0
        self.n_err = 0
