"""Decision: the training loop's epoch bookkeeping and stop rule.

The port's counterpart of `DecisionGD` in `veles_tpu/znicz/decision.py`
(decision.py:91-149 there): per minibatch it adds the evaluator's `n_err`
to its class's running total; at the end of a class pass it records the
pass's total, tracks the best validation error (the train error when
there is no validation set) with `improved`, and at the end of a train
pass closes the epoch: one `history` record, then `complete` once
`max_epochs` is reached or the error has not improved for
`fail_iterations` epochs. It reads the loader's `minibatch_class`,
`last_minibatch` and `class_lengths` and the evaluator's `n_err`.
It is a unit of the granular graph (one firing per minibatch, after the
evaluator), and the fused loop calls its `run()` after every minibatch.
`complete` and `improved` are `mutable.Bool`s, as in the JAX package: in
the granular graph `complete` blocks the loop's repeater and opens the
end point, and with the loader's `not_train` it skips the gradient
units; they are `BoolField`s, so a plain assignment sets the Bool and
the gates composed from it stay live. At each closed epoch it fires the
process's epoch hooks (`resilience/hooks.py`: heartbeats, epoch-keyed
faults; JAX decision.py:149). With `nonfinite_guard` armed it raises
`NonFiniteLossError` on a non-finite loss before it counts anything
(JAX :93-100), so a poisoned state never looks improved and is never
snapshotted; a pickle leaves the guard out (JAX :39): a restored run
arms it again from its own command line.
"""

from __future__ import annotations

import math
from typing import Optional

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.loader.base import TEST, TRAIN, VALIDATION
from veles_tpu_torch.mutable import BoolField
from veles_tpu_torch.resilience import NonFiniteLossError
from veles_tpu_torch.resilience.hooks import fire_epoch


class DecisionGD(AcceleratedUnit):

    #: raise NonFiniteLossError the moment the evaluator's loss is NaN or
    #: inf; armed per run by instance attribute, and a class attribute so
    #: that a pickle, which leaves the instance's out, never carries it
    nonfinite_guard = False

    #: the stop rule's verdict: gates the loop (see the module docstring)
    complete = BoolField()
    #: this minibatch closed a class pass with a new best error
    improved = BoolField()

    def __init__(self, loader, evaluator, max_epochs: Optional[int] = None,
                 fail_iterations: int = 100, workflow=None,
                 name: Optional[str] = None) -> None:
        super().__init__(workflow, name=name)
        self.loader = loader
        self.evaluator = evaluator
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.epoch_number = 0
        self.epoch_n_err = [0.0, 0.0, 0.0]       # per class (test/valid/train)
        self.best_validation_err: Optional[float] = None
        #: one record per completed train pass
        self.history: list = []
        self._accum = [0.0, 0.0, 0.0]
        self._epochs_since_improvement = 0

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("nonfinite_guard", None)
        return d

    def numpy_run(self) -> None:
        cls = int(self.loader.minibatch_class)
        if self.nonfinite_guard and not math.isfinite(
                float(self.evaluator.loss)):
            raise NonFiniteLossError(
                f"non-finite loss {float(self.evaluator.loss)!r} at epoch "
                f"{self.epoch_number} (class {cls} pass)")
        self._accum[cls] += float(self.evaluator.n_err)
        self.improved <<= False
        if not self.loader.last_minibatch:
            return
        # end of this class's pass
        self.epoch_n_err[cls] = self._accum[cls]
        self._accum[cls] = 0.0
        if cls == VALIDATION or (cls == TRAIN and
                                 self.loader.class_lengths[VALIDATION] == 0):
            err = self.epoch_n_err[cls]
            if (self.best_validation_err is None
                    or err < self.best_validation_err):
                self.best_validation_err = err
                self.improved <<= True
                self._epochs_since_improvement = 0
            else:
                self._epochs_since_improvement += 1
        if cls == TRAIN:
            self.epoch_number += 1
            self.history.append({
                "epoch": self.epoch_number,
                "train_err": float(self.epoch_n_err[TRAIN]),
                "valid_err": float(self.epoch_n_err[VALIDATION]),
                "test_err": float(self.epoch_n_err[TEST]),
                "best_err": (None if self.best_validation_err is None
                             else float(self.best_validation_err)),
            })
            self.info(
                "epoch %d: train_err=%g valid_err=%g test_err=%g best=%s",
                self.epoch_number, self.epoch_n_err[TRAIN],
                self.epoch_n_err[VALIDATION], self.epoch_n_err[TEST],
                self.best_validation_err)
            if ((self.max_epochs is not None
                 and self.epoch_number >= self.max_epochs)
                    or self._epochs_since_improvement
                    >= self.fail_iterations):
                self.complete <<= True
            # the process's epoch boundary: heartbeats, epoch-keyed faults
            fire_epoch(self.epoch_number)
