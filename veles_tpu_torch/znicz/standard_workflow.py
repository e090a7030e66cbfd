"""StandardWorkflow: the unit graph built from a declarative layer list,
its granular pulse loop, and the fused training loop that drives the
same units.

The port's counterpart of `veles_tpu/znicz/standard_workflow.py`, a
`Workflow`: a loader, the forward layers of `layers` (`{"type": <name>,
...kwargs}` dicts resolved through `LAYER_TYPES`; `forwards` holds them,
the `nn.Module`s the fused step and the server run) with one granular
node per layer (`fwd_units`, nn_units.ForwardUnit), the evaluator of the
`loss` (softmax: `EvaluatorSoftmax` on the labels; "mse":
`EvaluatorMSE` on the loader's targets, JAX :91-96), the Decision and one
gradient unit per layer (`gds`, built in reverse order, as there).
`plot_config={"confusion": True}` keeps the softmax evaluator's
confusion matrix of each validation pass, in both modes (JAX :177-183;
the port draws no plots, so the matrix stays in
`evaluator.confusion_matrix`). The control wiring is the JAX package's
(:66-155 there):

    start → repeater → loader → fwd_units… → evaluator → decision
      → gds… (reverse) → repeater;  decision → end_point

with the gates of `_wire_gates` (:229-255 there): the gradient units skip
non-train minibatches and every minibatch once the Decision is complete,
the repeater is blocked once complete, and the end point is blocked
until then. `initialize(device, backend)` initializes every unit in
graph order — the loader (its seeded train shuffle) first, then each
forward node, which fills its layer's parameters from the same numpy
streams as the JAX units, on the backend's device: "torch" (the default;
the card unless "cpu" is asked for) or "numpy" (the host goldens of
ops/reference.py). `run()` pumps pulses until the Decision completes —
the granular mode: one firing per unit per minibatch, the LRN units
through K2 and K3 and every gradient unit's update through K1 on the
card — and `run_epochs(n)` sets the Decision's `max_epochs` first.

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
card (`_wire_spec`).

Snapshots (`snapshot_config`, the Snapshotter's keywords; JAX :125-129):
in the granular graph the Snapshotter is a unit after the Decision, at
the end of the pulse's gradient chain, gated on the Decision's
`improved` (`_wire_gates`): it pickles a pulse whose updates have all
run, with the loader's cursor at the next minibatch, and a restored
workflow's `initialize` moves its tensors to the backend's device and
keeps what the snapshot holds, so `run()` continues at the next pulse.
In the fused loop, where the Decision marks an improvement, the loop
writes the trained state back into the units and the gradient twins and
runs the Snapshotter, after `dec.run()` and before `feed.prefetch()`, so
the
pickled loader cursor is the consumed batch's + 1 (JAX :700-708); a
lookahead deeper than 1 would pickle a cursor past batches not yet
trained, so `feed_ahead > 1` is clamped to 1 where a snapshotter runs
(JAX :517-523). A pickled workflow keeps its tensors (the Snapshotter
writes them as host bytes) and drops its device and its device feed;
`restored` marks it, and `place(device)` moves such a workflow to the
card where a fresh one is initialized from the seed streams.
`nonfinite_guard` arms the Decision's guard for the run, and a
`nan@step=K` fault plan (`resilience/faults.py`) replaces the K-th train
step's loss with NaN. `accum_steps=K` trains each minibatch through the
step's `train_accum` (K microbatches, one update; JAX :449-465), the
feed, the snapshots and the Decision unchanged. The fused loop and the
granular graph share the layers' parameters and the gradient units'
velocities, so either continues from where the other stopped.

`run_fused(mesh=..., ep=True)` trains data-parallel with the MoE
layers' experts sharded over the ranks (parallel/fused.py). `run_pipelined`
(JAX :390-416) trains the chain as a GPipe pipeline
(parallel/pipeline.py `PipelineTrainStep`, `build_pipeline_step`): one
stage per visible card by default, capped at the unit count (one card:
one stage; `--device cpu`: one CPU stage), through the same loop, feed,
Decision and snapshots. Telemetry comes with a later slice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from veles_tpu_torch.backends import Device, DeviceLike, make_backend, \
    make_device
from veles_tpu_torch.loader.base import TRAIN, VALIDATION, Loader
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Repeater, Workflow
from veles_tpu_torch.znicz import activation, all2all, attention, conv, \
    dropout, moe, normalization, pooling, transformer
# the gradient units register their pairs with the layers when imported
from veles_tpu_torch.znicz import gd, gd_conv, gd_pooling  # noqa: F401
from veles_tpu_torch.znicz.decision import DecisionGD
from veles_tpu_torch.znicz.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, gd_for, \
    unit_for

#: layer-type name -> forward layer class (the JAX package's types of
#: the all2all, conv, pooling, normalization, activation, dropout,
#: attention and mixture-of-experts families)
LAYER_TYPES: Dict[str, type] = {
    "all2all": all2all.All2All,
    "all2all_tanh": all2all.All2AllTanh,
    "all2all_relu": all2all.All2AllRELU,
    "all2all_strictrelu": all2all.All2AllStrictRELU,
    "all2all_sigmoid": all2all.All2AllSigmoid,
    "softmax": all2all.All2AllSoftmax,
    "conv": conv.Conv,
    "conv_tanh": conv.ConvTanh,
    "conv_relu": conv.ConvRELU,
    "conv_strictrelu": conv.ConvStrictRELU,
    "conv_sigmoid": conv.ConvSigmoid,
    "norm": normalization.LRNormalizerForward,
    "lrn": normalization.LRNormalizerForward,
    "input_normalize": normalization.InputNormalize,
    "max_pooling": pooling.MaxPooling,
    "maxabs_pooling": pooling.MaxAbsPooling,
    "avg_pooling": pooling.AvgPooling,
    "stochastic_pooling": pooling.StochasticPooling,
    "activation_tanh": activation.ActivationTanh,
    "activation_relu": activation.ActivationRELU,
    "activation_strictrelu": activation.ActivationStrictRELU,
    "activation_sigmoid": activation.ActivationSigmoid,
    "activation_log": activation.ActivationLog,
    "dropout": dropout.DropoutForward,
    "attention": attention.MultiHeadAttention,
    "seq_linear": transformer.SeqLinear,
    "seq_ffn": transformer.SeqFFN,
    "seq_softmax": transformer.SeqSoftmax,
    "moe": moe.MoELayer,
}


class AccumulatingStep:
    """`step` with `train` computing each minibatch's gradient as
    `accum_steps` microbatches before its one update (`train_accum`);
    every other attribute is the step's."""

    def __init__(self, step, accum_steps: int) -> None:
        self.step = step
        self.accum_steps = accum_steps

    def __getattr__(self, name):
        return getattr(self.step, name)

    def train(self, state, x, y, w=None):
        return self.step.train_accum(state, x, y, self.accum_steps, w)


class StandardWorkflow(Workflow):
    """loader + declarative layer list -> forwards and their granular
    nodes, evaluator, decision, gradient units and, with
    `snapshot_config`, a Snapshotter (a unit of the granular graph, and
    run by the fused loop)."""

    def __init__(self, layers: Sequence[Dict[str, Any]] = (),
                 loader: Optional[Loader] = None, loss: str = "softmax",
                 n_classes: int = 10,
                 decision_config: Optional[Dict[str, Any]] = None,
                 gd_config: Optional[Dict[str, Any]] = None,
                 snapshot_config: Optional[Dict[str, Any]] = None,
                 plot_config: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None, workflow=None) -> None:
        if loader is None:
            raise ValueError("StandardWorkflow needs a loader")
        if loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {loss!r}")
        super().__init__(workflow, name=name or type(self).__name__)
        self.layers_config = list(layers)
        self.loss = loss
        self.n_classes = n_classes
        self.repeater = Repeater(self, name="repeater")
        self.loader = loader
        if loader.workflow is not self:
            if loader.workflow is not None:
                # a loader taken from another workflow's graph leaves that
                # graph's pulses behind (its repeater would hold this
                # graph's loader gate shut)
                loader.unlink_all()
            self.add_unit(loader)
            loader.workflow = self

        # -- forwards: the layers, and their nodes ------------------------
        layers_: List[Forward] = []
        for spec in self.layers_config:
            spec = dict(spec)
            kind = spec.pop("type")
            if kind not in LAYER_TYPES:
                raise ValueError(
                    f"unknown layer type {kind!r}; registered types: "
                    f"{sorted(LAYER_TYPES)}")
            layers_.append(LAYER_TYPES[kind](**spec))
        self.forwards = nn.ModuleList(layers_)
        self.fwd_units: List[ForwardUnit] = []
        prev: Unit = self.loader
        prev_attr = "minibatch_data"
        for layer in layers_:
            u = unit_for(type(layer))(self, layer=layer)
            u.link_attrs(prev, ("input", prev_attr),
                         ("input_sample_shape", "sample_shape"))
            if hasattr(u, "link_loader"):  # dropout reads minibatch_class
                u.link_loader(self.loader)
            self.fwd_units.append(u)
            prev, prev_attr = u, "output"

        # -- evaluator ------------------------------------------------------
        if loss == "softmax":
            self.evaluator = EvaluatorSoftmax(self, n_classes=n_classes)
            self.evaluator.link_attrs(self.loader,
                                      ("labels", "minibatch_labels"),
                                      "minibatch_class")
            if (plot_config or {}).get("confusion"):
                # each validation pass's matrix (the JAX plot's)
                self.evaluator.confusion_split = VALIDATION
        else:
            self.evaluator = EvaluatorMSE(self)
            self.evaluator.link_attrs(self.loader,
                                      ("target", "minibatch_labels"))
        self.evaluator.link_attrs(self.loader,
                                  ("sample_weights", "minibatch_valid"))
        self.evaluator.link_attrs(prev, ("input", prev_attr))

        # -- decision -------------------------------------------------------
        self.decision = DecisionGD(self.loader, self.evaluator,
                                   workflow=self, **(decision_config or {}))

        # -- gradient chain (reverse order) ---------------------------------
        self.gds: List[Unit] = []
        err_src: Unit = self.evaluator
        err_attr = "err_output"
        for fwd in reversed(self.fwd_units):
            g = gd_for(type(fwd.layer))(self, **(gd_config or {}))
            g.link_forward(fwd)
            g.link_attrs(err_src, ("err_output", err_attr))
            self.gds.append(g)
            err_src, err_attr = g, "err_input"

        self.snapshotter = None
        if snapshot_config is not None:
            from veles_tpu_torch.snapshotter import Snapshotter
            self.snapshotter = Snapshotter(self, **snapshot_config)
            # gating (link_decision) happens in _wire_gates below

        # -- control wiring --------------------------------------------------
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        prev_u: Unit = self.loader
        for u in self.fwd_units:
            u.link_from(prev_u)
            prev_u = u
        self.evaluator.link_from(prev_u)
        self.decision.link_from(self.evaluator)
        prev_u = self.decision
        for g in self.gds:
            g.link_from(prev_u)
            prev_u = g
        if self.snapshotter is not None:
            # after the Decision and the whole gradient chain of the pulse
            # (the JAX graph links it from the Decision, :155-156 there,
            # where it fires before the later gradient units of a train
            # minibatch): a snapshot holds every update of its pulse
            self.snapshotter.link_from(prev_u)
        self.repeater.link_from(prev_u)
        self.end_point.link_from(self.decision)
        self._wire_gates()

        #: the backend Device of the granular units (None until
        #: initialize); `device` is its torch device, the fused step's
        self.backend_device: Optional[Device] = None
        #: True for a workflow unpickled from a snapshot: initialized,
        #: its tensors on the host until `place` moves them
        self.restored = False
        #: the DeviceFeed of the last fused run, and its counters
        self.device_feed = None
        self.feed_stats: Optional[Dict[str, Any]] = None

    def _wire_gates(self) -> None:
        """(Re)build the derived gate Bools (JAX :229-255). Called from
        __init__ and from initialize(): a pickle freezes derived Bools to
        plain values, so a restored workflow derives them again."""
        for g, fwd in zip(self.gds, reversed(self.fwd_units)):
            g.link_forward(fwd)
        # skip weight updates on test/validation minibatches; freeze the
        # chain entirely once training completed
        for g in self.gds:
            g.gate_skip = self.loader.not_train | self.decision.complete
        self.end_point.gate_block = ~self.decision.complete
        # once complete, the loop-back pulse must die at the repeater
        self.repeater.gate_block = self.decision.complete
        if self.snapshotter is not None:
            self.snapshotter.link_decision(self.decision)

    @property
    def is_initialized(self) -> bool:
        return self.device is not None

    def __getstate__(self):
        d = super().__getstate__()
        # the feed (pinned pool, side stream, events) and its counters
        # are the run's; the device is where the tensors were, not where
        # the pickle's host bytes come back
        d["device_feed"] = None
        d["feed_stats"] = None
        d["device"] = None
        d["backend_device"] = None
        d["restored"] = True
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self.snapshotter is not None:
            self.snapshotter.link_decision(self.decision)

    def place(self, device: DeviceLike = None) -> None:
        """Ready the workflow on `device` (the card unless "cpu" is asked
        for): a fresh workflow is initialized, a restored one is moved
        there (never refilled from the seed streams: its weights, cursor
        and counters are the snapshot's), and an initialized one asked
        for another device moves."""
        if not self.is_initialized:
            if self.restored:
                self.to(device)
            else:
                self.initialize(device)
        elif device is not None and make_device(device) != self.device:
            self.to(device)

    def initialize(self, device=None, backend: Optional[str] = None,
                   **kwargs: Any) -> None:
        """Initialize every unit in graph order: the loader, then each
        forward node (filling its layer's parameters), the evaluator, the
        Decision and the gradient units. `device` is a torch device or
        its name (the card unless "cpu" is asked for) or a backend
        `Device`; `backend` "torch" (the default) or "numpy" (the host
        goldens, on the CPU) builds one from it. A restored workflow's
        tensors move to that device first, and its units keep what the
        snapshot holds: the parameters and velocities, the loader's
        schedule, cursor and shuffle, the counters."""
        bdev = device if isinstance(device, Device) \
            else make_backend(backend, device)
        if self.restored:
            self.to(bdev.torch_device)
        self._wire_gates()
        try:
            super().initialize(device=bdev, **kwargs)
        except BaseException:
            self.device = None
            raise
        self.backend_device = bdev
        self.device = bdev.torch_device
        self.restored = False

    def to(self, device: DeviceLike) -> "StandardWorkflow":
        """Move the parameters and the gradient units' velocities to
        `device` (raises where it is the card and CUDA is absent)."""
        dev = make_device(device)
        self.forwards.to(dev)
        for g in self.gds:
            for k, v in list(vars(g).items()):
                if isinstance(v, torch.Tensor):
                    setattr(g, k, v.to(dev))
        self.device = dev
        return self

    # -- the granular loop ----------------------------------------------------

    def run(self) -> None:
        """Pump pulses until the Decision completes (the granular mode);
        a restored workflow continues at the pulse after its snapshot's.
        A loader offering the uint8 wire emits floats for the run: the
        graph has no normalize prologue."""
        if not self.is_initialized:
            raise RuntimeError("initialize the workflow before run()")
        wire = self._wire_spec(uint8_wire=False)
        prev_emit = getattr(self.loader, "emit", None)
        if wire is not None:
            self.loader.set_emit(wire["emit"])
        try:
            super().run()
        finally:
            if wire is not None:
                self.loader.set_emit(prev_emit)

    def run_epochs(self, n: Optional[int] = None, device=None,
                   backend: Optional[str] = None) -> None:
        """Initialize (if needed) and run until the Decision completes
        (`n` sets its `max_epochs`)."""
        if n is not None:
            self.decision.max_epochs = n
        if not self.is_initialized:
            self.initialize(device=device, backend=backend)
        self.run()

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
                         input_normalize: Optional[Dict[str, Any]] = None,
                         mesh=None, mode: str = "auto",
                         zero_sharding: Any = "auto", ep: bool = False):
        """The fused train step over this workflow's units (see
        parallel/fused.py); resolves its lowerings now. `compute_dtype`
        ("bfloat16": bf16 compute over f32 master weights) falls back to
        root.common.precision_type when None; `input_normalize` is the
        uint8 wire's prologue spec; `mesh` (parallel/mesh.make_mesh) makes
        it a data-parallel step, its update ZeRO-sharded by
        `zero_sharding` ("auto", "on", "off"), its MoE experts sharded over
        the ranks with `ep`, or under `mode="gspmd"` (the "auto" choice
        where the mesh has a model axis) a tensor-parallel one."""
        from veles_tpu_torch.parallel.fused import FusedTrainStep
        return FusedTrainStep(self, compute_dtype=compute_dtype,
                              input_normalize=input_normalize, mesh=mesh,
                              mode=mode, zero_sharding=zero_sharding, ep=ep)

    def build_pipeline_step(self, devices=None, n_microbatches: int = 4,
                            boundaries=None,
                            compute_dtype: Optional[str] = None,
                            input_normalize: Optional[Dict[str, Any]] = None):
        """The chain as a GPipe pipeline over the stage `devices`
        (parallel/pipeline.py; default one stage per visible card, repeats
        allowed) in `n_microbatches` microbatches (JAX :313-323). The
        workflow must be initialized first."""
        from veles_tpu_torch.parallel.pipeline import PipelineTrainStep, \
            make_stage_mesh
        return PipelineTrainStep(self, make_stage_mesh(devices),
                                 n_microbatches, boundaries=boundaries,
                                 compute_dtype=compute_dtype,
                                 input_normalize=input_normalize)

    def autotune(self, compute_dtype: Optional[str] = None,
                 **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Time the candidate lowerings of every tunable op this workflow
        holds (LRN, max pooling, the stem convolution, the LRN->pool pair,
        the SGD update, attention) on its device, keep the winners
        selected, so that the next `build_fused_step` / `run_fused` runs
        them, and cache them (ops/autotune.py `autotune_workflow`; `budget=
        N` searches the generated points). Initializes the workflow on the
        card first unless it is. Returns the per-op report. CLI:
        `--autotune [--autotune-budget N]` (JAX standard_workflow.py:302)."""
        from veles_tpu_torch.ops.autotune import autotune_workflow
        if not self.is_initialized:
            self.place(None)
        return autotune_workflow(self, compute_dtype=compute_dtype,
                                 device=self.device, **kwargs)

    def _wire_spec(self, uint8_wire="auto") -> Optional[Dict[str, Any]]:
        """The uint8 wire's negotiation with the loader: where the loader
        offers raw bytes (`wire_format()`), the prologue spec the step is
        built with and the emit the loader switches to for the run.
        `uint8_wire=False` pins the host-normalized float wire: a loader
        constructed with emit="uint8" switches to float emission for the
        run, since raw bytes without a prologue would train on 0..255.
        None where the graph holds its own `input_normalize` layer: it
        normalizes on the card already (JAX :326-339)."""
        if any(isinstance(u, normalization.InputNormalize)
               for u in self.forwards):
            return None
        if not uint8_wire:
            if getattr(self.loader, "emit", None) == "uint8" \
                    and hasattr(self.loader, "set_emit"):
                return {"emit": "float32", "normalize": None}
            return None
        return self.loader.wire_format()

    def run_fused(self, epochs: Optional[int] = None,
                  device: DeviceLike = None, uint8_wire="auto",
                  feed_ahead: Optional[int] = None,
                  nonfinite_guard: bool = False,
                  accum_steps: Optional[int] = None, mesh=None,
                  mode: str = "auto", zero_sharding: Any = "auto",
                  ep: bool = False) -> None:
        """Train with the fused step until the Decision completes
        (`epochs` overrides its `max_epochs`), on `device` (the card unless
        "cpu" is asked for; see `place`). Batches reach the card through
        the DeviceFeed; a loader offering the uint8 wire sends raw bytes,
        which the step normalizes on the card (`uint8_wire=False` pins
        the float wire); `feed_ahead` is the feed's lookahead (default 1,
        0 uploads each batch on demand). `nonfinite_guard` raises
        NonFiniteLossError at the first non-finite class-pass loss.
        `accum_steps=K` (K > 1) computes each train minibatch's gradient
        as K microbatches before its one update (activation memory
        O(minibatch/K), the full batch's gradient). `mesh` (the process
        group's, parallel/mesh.make_mesh) trains data-parallel: every rank
        runs this loop on the same global minibatches, trains on its rows
        of each (the loader produces only those), and the coordinator
        alone writes the snapshots; the workflow lives on the mesh's
        device. `mode` is the step's ("auto": dp, or gspmd where the mesh
        has a model axis: tensor parallelism); `zero_sharding` gates the
        ZeRO update (JAX :509-515, :732); `ep` shards the MoE experts
        over the ranks."""
        if epochs is not None:
            self.decision.max_epochs = epochs
        if mesh is not None:
            device = mesh.device
        self.place(device)
        wire = self._wire_spec(uint8_wire)
        step = self.build_fused_step(
            input_normalize=wire["normalize"] if wire else None,
            mesh=mesh, mode=mode, zero_sharding=zero_sharding, ep=ep)
        if accum_steps and accum_steps > 1:
            step = AccumulatingStep(step, accum_steps)
        self._run_with_step(step, wire=wire, feed_ahead=feed_ahead,
                            nonfinite_guard=nonfinite_guard)

    def run_pipelined(self, devices=None, n_microbatches: int = 4,
                      epochs: Optional[int] = None,
                      device: DeviceLike = None, boundaries=None,
                      compute_dtype: Optional[str] = None,
                      nonfinite_guard: bool = False, uint8_wire="auto",
                      feed_ahead: Optional[int] = None) -> None:
        """Train as a GPipe pipeline with the Loader / Decision /
        Snapshotter loop and the DeviceFeed of `run_fused` (JAX
        :390-416). `devices`: the stage devices; by default one stage per
        visible card, capped at the unit count, or the one CPU stage
        where `device` asks for the CPU (without a card and without that,
        refused). The CLI's `--pp M` (M = `n_microbatches`)."""
        if epochs is not None:
            self.decision.max_epochs = epochs
        if devices is None:
            dev = make_device(device)
            if device is None and dev.type == "cuda":
                from veles_tpu_torch.parallel.pipeline import \
                    make_stage_mesh
                devices = make_stage_mesh()[:max(1, len(self.forwards))]
            else:
                devices = [dev]
        self.place(devices[0])
        wire = self._wire_spec(uint8_wire)
        step = self.build_pipeline_step(
            devices, n_microbatches, boundaries=boundaries,
            compute_dtype=compute_dtype,
            input_normalize=wire["normalize"] if wire else None)
        self._run_with_step(step, wire=wire, feed_ahead=feed_ahead,
                            nonfinite_guard=nonfinite_guard)

    def _run_with_step(self, step, wire: Optional[Dict[str, Any]] = None,
                       feed_ahead: Optional[int] = None,
                       nonfinite_guard: bool = False) -> None:
        """Drive `step` through the Loader + Decision bookkeeping, the
        batches coming through the DeviceFeed (uploaded by the previous
        iteration's prefetch, which runs after the Decision and the
        snapshot). A step's loss is the weighted mean over its minibatch:
        scaled by the minibatch's valid-row weight, the class pass's
        total is the exact weighted mean even when its last minibatch
        wraps."""
        from veles_tpu_torch.loader.device_feed import DeviceFeed
        from veles_tpu_torch.resilience.faults import active_plan

        fault_plan = active_plan()   # None unless a plan is set
        state = step.init_state()
        loader, ev, dec = self.loader, self.evaluator, self.decision
        # the negotiated wire is the run's: the loader's emit comes back
        # afterwards, and a pickle meanwhile keeps the constructed one
        prev_emit = getattr(loader, "emit", None)
        if wire is not None and hasattr(loader, "set_emit"):
            loader.set_emit(wire["emit"])
            loader._emit_pristine = prev_emit
        ahead = 1 if feed_ahead is None else feed_ahead
        if self.snapshotter is not None:
            self.snapshotter.initialize()
            if ahead > 1:
                # a snapshot taken with k pending batches pickles a loader
                # cursor k past the trained batch: the restore would skip
                # them
                self.warning("feed_ahead=%d clamped to 1: snapshots need "
                             "an exact-resume loader cursor", ahead)
                ahead = 1
        # the Decision raises before it counts a non-finite pass
        dec.nonfinite_guard = bool(nonfinite_guard)
        feed = DeviceFeed.for_step(loader, step, ahead=ahead)
        #: the feed of the last run (its put, its counters)
        self.device_feed = feed
        # the loader gathers straight into the feed's pinned buffers
        loader.out_alloc = getattr(feed.put, "empty", None)
        # a dp or gspmd rank produces only the rows it trains on (each
        # rank is a process of its own; the JAX package does this across
        # hosts)
        prev_rows_fn = getattr(loader, "local_rows_fn", None)
        dp = getattr(step, "mode", "local") in ("dp", "gspmd")
        if dp and step.n_data > 1 and hasattr(loader, "local_rows_fn"):
            loader.local_rows_fn = step.local_rows
        from veles_tpu_torch.parallel.distributed import is_coordinator
        writes_snapshots = not dp or is_coordinator()
        acc_loss = acc_err = acc_conf = None
        acc_w = 0.0
        # the confusion companion runs on the passes of the evaluator's
        # split (JAX :586-601), its counts summed on the device
        conf_split = (getattr(ev, "confusion_split", None)
                      if getattr(ev, "compute_confusion", False) else None)
        try:
            while not dec.complete:
                b = feed.next()
                if b.minibatch_class == TRAIN:
                    state, (loss, n_err) = step.train(state, b.x, b.y, b.w)
                    if fault_plan is not None and fault_plan.nan_at_step():
                        loss = float("nan")   # a deterministic divergence
                else:
                    loss, n_err = step.evaluate(state, b.x, b.y, b.w)
                    if b.minibatch_class == conf_split:
                        m = step.confusion(state, b.x, b.y, ev.n_classes,
                                           b.w)
                        if m is not None:
                            acc_conf = m if acc_conf is None \
                                else acc_conf + m
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
                    ev.n_err = (int(acc_err) if self.loss == "softmax"
                                else float(acc_err))
                    if acc_conf is not None:
                        # the split's latest pass, as the granular
                        # evaluator keeps it
                        ev.confusion_matrix.mem = acc_conf.cpu().numpy()
                    feed.note_device_sync(time.perf_counter() - t_sync)
                    acc_loss = acc_err = acc_conf = None
                    acc_w = 0.0
                else:
                    ev.loss = 0.0
                    ev.n_err = 0
                if b.epoch_ended:
                    self.feed_stats = feed.stats()
                dec.run()
                if self.snapshotter is not None and dec.improved:
                    # every rank gathers (a collective under ZeRO), the
                    # coordinator writes
                    step.write_back(state)
                    if writes_snapshots:
                        self.snapshotter.run()
                # now batch k+1: its upload runs under step k, and the
                # snapshot above pickled the consumed batch's cursor
                if not dec.complete:
                    feed.prefetch()
        finally:
            feed.stop()
            loader.out_alloc = None
            if hasattr(loader, "local_rows_fn"):
                loader.local_rows_fn = prev_rows_fn
            self.feed_stats = feed.stats()
            if wire is not None and hasattr(loader, "set_emit") \
                    and prev_emit is not None:
                loader.set_emit(prev_emit)
                loader._emit_pristine = None
            step.write_back(state)
