"""StandardWorkflow: the chain built from a declarative layer list, and
the fused training loop that drives it.

The port's counterpart of `veles_tpu/znicz/standard_workflow.py`: a loader,
the forward units of `layers` (`{"type": <name>, ...kwargs}` dicts
resolved through `LAYER_TYPES`), the softmax evaluator, the Decision and
one gradient twin per forward unit holding its update hyperparameters
(built in reverse order, as there). `initialize(device)` initializes the
loader (its seeded train shuffle comes first, as in the JAX package) and
then each forward unit in order, propagating sample shapes and filling
parameters from the same numpy streams.

`run_fused` trains through the fused step (parallel/fused.py) in the JAX
package's loop (`_run_with_step`, standard_workflow.py:419-736 there),
here synchronous: the loader produces each minibatch, the step trains on
it or evaluates it, loss·weight and n_err add up on the device, the host
syncs once per class pass to hand the evaluator the pass's totals, and
the Decision runs after every minibatch; the trained state is written
back into the units at the end. The DeviceFeed, snapshots, telemetry,
gradient accumulation, meshes and the granular Unit/Workflow graph come
with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from veles_tpu_torch.backends import DeviceLike, make_device
from veles_tpu_torch.loader.base import TRAIN, Loader
from veles_tpu_torch.znicz import all2all, attention, conv, dropout, \
    normalization, pooling, transformer
from veles_tpu_torch.znicz.decision import DecisionGD
from veles_tpu_torch.znicz.evaluator import EvaluatorSoftmax
from veles_tpu_torch.znicz.nn_units import Forward, gd_for

#: layer-type name -> forward unit class
#: (AlexNet's and the char-transformer's types; the JAX package's other
#: activation flavors come with a later slice)
LAYER_TYPES: Dict[str, type] = {
    "all2all": all2all.All2All,
    "all2all_strictrelu": all2all.All2AllStrictRELU,
    "softmax": all2all.All2AllSoftmax,
    "conv": conv.Conv,
    "conv_strictrelu": conv.ConvStrictRELU,
    "norm": normalization.LRNormalizerForward,
    "lrn": normalization.LRNormalizerForward,
    "max_pooling": pooling.MaxPooling,
    "dropout": dropout.DropoutForward,
    "attention": attention.MultiHeadAttention,
    "seq_linear": transformer.SeqLinear,
    "seq_ffn": transformer.SeqFFN,
    "seq_softmax": transformer.SeqSoftmax,
}


class StandardWorkflow:
    """loader + declarative layer list -> forwards, evaluator, decision and
    gradient twins."""

    def __init__(self, layers: Sequence[Dict[str, Any]] = (),
                 loader: Optional[Loader] = None, loss: str = "softmax",
                 n_classes: int = 10,
                 decision_config: Optional[Dict[str, Any]] = None,
                 gd_config: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None) -> None:
        if loader is None:
            raise ValueError("StandardWorkflow needs a loader")
        if loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {loss!r}")
        self.name = name or type(self).__name__
        self.layers_config = list(layers)
        self.loss = loss
        self.n_classes = n_classes
        self.loader = loader
        units: List[Forward] = []
        for spec in self.layers_config:
            spec = dict(spec)
            kind = spec.pop("type")
            if kind not in LAYER_TYPES:
                raise ValueError(
                    f"unknown layer type {kind!r}; registered types: "
                    f"{sorted(LAYER_TYPES)}")
            units.append(LAYER_TYPES[kind](**spec))
        self.forwards = nn.ModuleList(units)
        self.evaluator = EvaluatorSoftmax(n_classes=n_classes)
        self.decision = DecisionGD(self.loader, self.evaluator,
                                   **(decision_config or {}))
        self.gds = [gd_for(type(fwd))(**(gd_config or {}))
                    for fwd in reversed(units)]
        self.device: Optional[torch.device] = None

    @property
    def is_initialized(self) -> bool:
        return self.device is not None

    def initialize(self, device: DeviceLike = None) -> None:
        """Initialize the loader, then each forward unit in order, with its
        parameters on `device` (the card unless "cpu" is asked for)."""
        dev = make_device(device)
        self.loader.initialize()
        shape: Tuple[int, ...] = tuple(self.loader.sample_shape)
        for u in self.forwards:
            shape = tuple(u.initialize(shape, dev))
        self.device = dev

    def to(self, device: DeviceLike) -> "StandardWorkflow":
        """Move the initialized parameters to `device`."""
        dev = make_device(device)
        self.forwards.to(dev)
        self.device = dev
        return self

    def params_host(self) -> Tuple[Dict[str, np.ndarray], ...]:
        """One `{name: ndarray}` per forward unit — the format the JAX
        package's server builds (serving.py:539-541)."""
        return tuple({k: t.detach().cpu().numpy()
                      for k, t in u.param_arrays().items()}
                     for u in self.forwards)

    def build_forward(self):
        """The fused forward over this workflow's units (see
        parallel/fused.py); resolves its lowerings now."""
        from veles_tpu_torch.parallel.fused import FusedForward
        return FusedForward(self)

    # -- fused training -------------------------------------------------------

    def build_fused_step(self, compute_dtype: Optional[str] = None):
        """The fused train step over this workflow's units (see
        parallel/fused.py); resolves its lowerings now. `compute_dtype`
        ("bfloat16": bf16 compute over f32 master weights) falls back to
        root.common.precision_type when None."""
        from veles_tpu_torch.parallel.fused import FusedTrainStep
        return FusedTrainStep(self, compute_dtype=compute_dtype)

    def run_fused(self, epochs: Optional[int] = None,
                  device: DeviceLike = None) -> None:
        """Train with the fused step until the Decision completes
        (`epochs` overrides its `max_epochs`), on `device` (the card unless
        "cpu" is asked for) if not initialized yet."""
        if epochs is not None:
            self.decision.max_epochs = epochs
        if not self.is_initialized:
            self.initialize(device)
        self._run_with_step(self.build_fused_step())

    def _run_with_step(self, step) -> None:
        """Drive `step` through the Loader + Decision bookkeeping. A step's
        loss is the weighted mean over its minibatch: scaled by the
        minibatch's valid-row weight, the class pass's total is the exact
        weighted mean even when its last minibatch wraps."""
        state = step.init_state()
        loader, ev, dec = self.loader, self.evaluator, self.decision
        acc_loss = acc_err = None
        acc_w = 0.0
        try:
            while not dec.complete:
                loader.run()
                x, y, w = (loader.minibatch_data, loader.minibatch_labels,
                           loader.minibatch_valid)
                if loader.minibatch_class == TRAIN:
                    state, (loss, n_err) = step.train(state, x, y, w)
                else:
                    loss, n_err = step.evaluate(state, x, y, w)
                bw = float(w.sum())
                acc_loss = loss * bw if acc_loss is None \
                    else acc_loss + loss * bw
                acc_w += bw
                acc_err = n_err if acc_err is None else acc_err + n_err
                if loader.last_minibatch:
                    # the one host sync of the class pass
                    ev.loss = float(acc_loss) / max(acc_w, 1.0)
                    ev.n_err = int(acc_err)
                    acc_loss = acc_err = None
                    acc_w = 0.0
                else:
                    ev.loss = 0.0
                    ev.n_err = 0
                dec.run()
        finally:
            step.write_back(state)
