"""Evaluators: the loss, the error's derivative and the metrics.

The port's counterparts of `EvaluatorSoftmax` and `EvaluatorMSE` in
`veles_tpu/znicz/evaluator.py`. In the fused loop an evaluator is the
holder of one class pass's `loss` (the pad-mask weighted mean) and
`n_err`, which `StandardWorkflow` writes at each class-pass boundary and
the Decision reads; the step computes them (parallel/fused.py). In the
granular graph it is a unit: from the last layer's output (`input`), the
loader's labels or targets and pad mask (`sample_weights`), each firing
computes the minibatch's loss, `n_err` and `err_output` with the golden
of ops/reference.py on the numpy backend and the functional op on the
unit's device on the torch one, whose scalars cross to the host once per
minibatch for the Decision.

`EvaluatorSoftmax` takes the softmax unit's probabilities and integer
labels; `err_output` is (probs − onehot)·w / Σw, the error with respect
to the logits that `GDSoftmax` takes, `n_err` the misclassified valid
rows. Its confusion matrix (`compute_confusion`, on by default, as in
the JAX unit) counts true class by row and predicted class by column,
exact int64 counts in both backends (`functional.confusion`). On the
torch backend the running matrix stays on the unit's device and crosses
to the host only when `confusion_matrix.mem` is read. With
`confusion_split` None the granular graph adds every minibatch to it
(the JAX unit's legacy accumulation); with a class index (the loader's
VALIDATION, 1) it holds that split's latest pass: the matrix restarts at
the pass's first minibatch. The fused loop fills it only where a split
is set, from the step's `confusion` companion, once per pass, as the JAX
loop does. Behind a per-token head (transformer.py's SeqSoftmaxUnit, N·S
rows of probabilities against the loader's flat (N·S,) labels) each of
the loader's N sample weights covers its S rows, in both backends.

`EvaluatorMSE` (JAX :131-166) takes the network's output and the
loader's targets (`minibatch_labels`); `loss` is the per-sample summed
squared error over the batch's valid rows, `err_output` its derivative,
and `n_err` the loss itself, the metric the Decision tracks.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import dev, host


class EvaluatorBase(AcceleratedUnit):

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input = Array()        # the last layer's output
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

    def _host_weights(self, n: int) -> np.ndarray:
        w = self._weights()
        if w is None:
            return np.ones(n, np.float32)
        w = host(w)
        return np.repeat(w, self._w_repeat(n, len(w)))

    @staticmethod
    def _w_repeat(n: int, nw: int) -> int:
        """How many rows each sample weight covers: 1, or S where a
        per-token head flattened (N, S) rows to N·S while the loader's
        pad mask stays per sample (JAX evaluator.py initialize)."""
        if n != nw and n % nw:
            raise ValueError(f"sample_weights ({nw}) incompatible with "
                             f"evaluator rows ({n})")
        return n // nw


class EvaluatorSoftmax(EvaluatorBase):

    def __init__(self, workflow=None, n_classes: int = 10,
                 compute_confusion: bool = True, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.n_classes = n_classes
        self.compute_confusion = compute_confusion
        self.labels = Array()
        #: (C, C) int64 counts, true class by row
        self.confusion_matrix = Array(
            np.zeros((n_classes, n_classes), np.int64))
        #: None: every minibatch adds to the matrix; a class index: only
        #: that split's, the matrix holding its latest pass (set
        #: `minibatch_class` from the loader)
        self.confusion_split: Optional[int] = None
        self.minibatch_class = None
        #: inside a pass of the confusion split
        self._in_split = False

    def _note_confusion(self, conf, device=None) -> None:
        """Add one minibatch's counts by the split rule (the class
        docstring); at the first minibatch of a pass of the split, the
        matrix restarts. `device` None: `conf` is a host array; else a
        tensor there, added to the matrix's device copy."""
        if not self.compute_confusion:
            return
        split = self.confusion_split
        if split is not None:
            if self.minibatch_class != split:
                self._in_split = False
                return
            if not self._in_split:
                self.reset_metrics()
                self._in_split = True
        m = self.confusion_matrix
        if device is None:
            m.mem = m.mem + conf
        else:
            m.set_devmem(m.devmem(device) + conf)

    def reset_metrics(self) -> None:
        self.confusion_matrix.reset(
            np.zeros((self.n_classes, self.n_classes), np.int64))

    def numpy_run(self) -> None:
        probs = host(self.input)
        loss, err, n_err, conf = ref.softmax_ce(
            probs, host(self.labels), self.n_classes,
            weights=self._host_weights(len(probs)))
        self.loss = loss
        self.err_output.mem = err
        self.n_err = n_err
        self._note_confusion(conf)

    def torch_run(self) -> None:
        d = self.device
        probs = dev(self.input, d)
        w = self._weights()
        if w is not None:
            w = dev(w, d)
            w = w.repeat_interleave(self._w_repeat(len(probs), len(w)))
        loss, err, n_err, conf = fn.softmax_ce(
            probs, dev(self.labels, d), self.n_classes, weights=w)
        self.err_output.set_devmem(err)
        # the scalars cross to the host here: the Decision is host logic
        self.loss = float(loss)
        self.n_err = int(n_err)
        self._note_confusion(conf, d)


class EvaluatorMSE(EvaluatorBase):

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.target = Array()
        self.n_err = 0.0

    def numpy_run(self) -> None:
        y = host(self.input)
        loss, err = ref.mse(y, host(self.target),
                            weights=self._host_weights(len(y)))
        self.loss = loss
        self.err_output.mem = err
        self.n_err = loss   # the Decision tracks the MSE as the error

    def torch_run(self) -> None:
        d = self.device
        w = self._weights()
        y = dev(self.input, d)
        loss, err = fn.mse(y, dev(self.target, d).to(y.dtype),
                           weights=None if w is None else dev(w, d))
        self.err_output.set_devmem(err)
        self.loss = float(loss)
        self.n_err = self.loss
