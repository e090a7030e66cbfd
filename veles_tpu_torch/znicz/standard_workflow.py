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
package's loop (`_run_with_step`, standard_workflow.py:419-736 there):
batches come through the DeviceFeed (loader/device_feed.py), which
uploads batch k+1 while step k runs; the step trains on each or
evaluates it, loss·weight and n_err add up on the device, the host syncs
once per class pass to hand the evaluator the pass's totals (timed into
the feed's `device_sync_s`), and the Decision runs after every
minibatch; the trained state is written back into the units at the end.
A loader that offers the uint8 wire (`wire_format()`, the memmap loader)
is switched to raw bytes for the run and the step normalizes them on the
card (`_wire_spec`). Snapshots, telemetry, gradient accumulation,
meshes and the granular Unit/Workflow graph come with later slices.
"""

from __future__ import annotations

import time
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
        #: the DeviceFeed of the last fused run, and its counters
        self.device_feed = None
        self.feed_stats: Optional[Dict[str, Any]] = None

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

    def build_fused_step(self, compute_dtype: Optional[str] = None,
                         input_normalize: Optional[Dict[str, Any]] = None):
        """The fused train step over this workflow's units (see
        parallel/fused.py); resolves its lowerings now. `compute_dtype`
        ("bfloat16": bf16 compute over f32 master weights) falls back to
        root.common.precision_type when None; `input_normalize` is the
        uint8 wire's prologue spec."""
        from veles_tpu_torch.parallel.fused import FusedTrainStep
        return FusedTrainStep(self, compute_dtype=compute_dtype,
                              input_normalize=input_normalize)

    def _wire_spec(self, uint8_wire="auto") -> Optional[Dict[str, Any]]:
        """The uint8 wire's negotiation with the loader: where the loader
        offers raw bytes (`wire_format()`), the prologue spec the step is
        built with and the emit the loader switches to for the run.
        `uint8_wire=False` pins the host-normalized float wire: a loader
        constructed with emit="uint8" switches to float emission for the
        run, since raw bytes without a prologue would train on 0..255.
        (The JAX package returns None first where the graph holds its own
        `input_normalize` layer; the port has no such unit yet.)"""
        if not uint8_wire:
            if getattr(self.loader, "emit", None) == "uint8" \
                    and hasattr(self.loader, "set_emit"):
                return {"emit": "float32", "normalize": None}
            return None
        return self.loader.wire_format()

    def run_fused(self, epochs: Optional[int] = None,
                  device: DeviceLike = None, uint8_wire="auto",
                  feed_ahead: Optional[int] = None) -> None:
        """Train with the fused step until the Decision completes
        (`epochs` overrides its `max_epochs`), on `device` (the card unless
        "cpu" is asked for) if not initialized yet. Batches reach the
        card through the DeviceFeed; a loader offering the uint8 wire
        sends raw bytes, which the step normalizes on the card
        (`uint8_wire=False` pins the float wire); `feed_ahead` is the
        feed's lookahead (default 1, 0 uploads each batch on demand)."""
        if epochs is not None:
            self.decision.max_epochs = epochs
        if not self.is_initialized:
            self.initialize(device)
        wire = self._wire_spec(uint8_wire)
        step = self.build_fused_step(
            input_normalize=wire["normalize"] if wire else None)
        self._run_with_step(step, wire=wire, feed_ahead=feed_ahead)

    def _run_with_step(self, step, wire: Optional[Dict[str, Any]] = None,
                       feed_ahead: Optional[int] = None) -> None:
        """Drive `step` through the Loader + Decision bookkeeping, the
        batches coming through the DeviceFeed (uploaded by the previous
        iteration's prefetch, which runs after the Decision). A step's
        loss is the weighted mean over its minibatch: scaled by the
        minibatch's valid-row weight, the class pass's total is the exact
        weighted mean even when its last minibatch wraps."""
        from veles_tpu_torch.loader.device_feed import DeviceFeed

        state = step.init_state()
        loader, ev, dec = self.loader, self.evaluator, self.decision
        # the negotiated wire is the run's: the loader's emit comes back
        # afterwards, and a pickle meanwhile keeps the constructed one
        prev_emit = getattr(loader, "emit", None)
        if wire is not None and hasattr(loader, "set_emit"):
            loader.set_emit(wire["emit"])
            loader._emit_pristine = prev_emit
        feed = DeviceFeed.for_step(
            loader, step, ahead=1 if feed_ahead is None else feed_ahead)
        #: the feed of the last run (its put, its counters)
        self.device_feed = feed
        # the loader gathers straight into the feed's pinned buffers
        loader.out_alloc = getattr(feed.put, "empty", None)
        acc_loss = acc_err = None
        acc_w = 0.0
        try:
            while not dec.complete:
                b = feed.next()
                if b.minibatch_class == TRAIN:
                    state, (loss, n_err) = step.train(state, b.x, b.y, b.w)
                else:
                    loss, n_err = step.evaluate(state, b.x, b.y, b.w)
                bw = float(b.w_host.sum())
                acc_loss = loss * bw if acc_loss is None \
                    else acc_loss + loss * bw
                acc_w += bw
                acc_err = n_err if acc_err is None else acc_err + n_err
                if b.last_minibatch:
                    # the one host sync of the class pass, timed so the
                    # feed's counters split blocked time into loader and
                    # card
                    t_sync = time.perf_counter()
                    ev.loss = float(acc_loss) / max(acc_w, 1.0)
                    ev.n_err = int(acc_err)
                    feed.note_device_sync(time.perf_counter() - t_sync)
                    acc_loss = acc_err = None
                    acc_w = 0.0
                else:
                    ev.loss = 0.0
                    ev.n_err = 0
                if b.epoch_ended:
                    self.feed_stats = feed.stats()
                dec.run()
                # now batch k+1: its upload runs under step k
                if not dec.complete:
                    feed.prefetch()
        finally:
            feed.stop()
            loader.out_alloc = None
            self.feed_stats = feed.stats()
            if wire is not None and hasattr(loader, "set_emit") \
                    and prev_emit is not None:
                loader.set_emit(prev_emit)
                loader._emit_pristine = None
            step.write_back(state)
