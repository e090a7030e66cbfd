"""Pipeline parallelism: GPipe microbatch pipelining over a list of stage
devices.

The port's counterpart of `veles_tpu/parallel/pipeline.py`. The JAX
module runs one process over a mesh "stage" axis: a `lax.scan` of M + S
- 1 ticks in which every device applies its stage and `ppermute`s the
result to the next. The port runs PyTorch's way, one process over an
ordered list of devices (`make_stage_mesh`), one a stage, repeats
allowed, so that S stages can share one card: at tick t stage s runs
microbatch t - s on its own device, and its output moves to the next
stage's device (`.to(device)`, asynchronous between cards). Every stage
runs only its own units (the JAX "switch" dispatch; its "select" form
works around a fault of the JAX CPU backend and has no counterpart).
The bubble is the GPipe (S-1)/(M+S-1). The gradients come from one
autograd pass over the whole schedule.

- `pipeline_apply` / `make_pipeline`: the homogeneous primitive, every
  stage `stage_fn(params, x) -> y` of one width, the per-stage
  parameters stacked on a leading dim of S.
- `split_stages`: the contiguous partition of a workflow's forward chain,
  balanced by parameter count, or at explicit `boundaries`.
- `PipelineTrainStep`: a StandardWorkflow's chain trained as S
  heterogeneous stages. Each stage's parameters are one flat f32 row on
  its own device (stage-resident: a card holds its stages' rows only),
  with a row of coefficient groups beside it (group 2i + 1 + is_bias of
  unit i: the layer's lr, or the bias lr, its momentum, weight decay and
  L1) through which the SGD + momentum update runs elementwise on the
  rows: plain tensor operations, as the JAX step's fused VPU pass (its
  update runs outside Pallas too). Each unit runs the lowering the
  registry resolves for it at build (the attention unit K6 forward and
  K7 backward on the card where its gate admits S); adjacent LRN and
  pooling units are not fused across a stage. The loss, n_err, the pad
  mask and the per-token heads are the fused step's (`loss_metrics`),
  on the last stage's device, over the microbatches' outputs in order;
  `compute_dtype` casts the inputs and each stage's parameters (the
  loss in f32), `input_normalize` is the uint8 wire's prologue on the
  first stage's device. Stochastic units (dropout, stochastic pooling)
  and Adam are refused, as in the JAX step. Unlike the JAX step, the
  activations are not padded to one width between stages (no scan carry
  needs it).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from veles_tpu_torch.backends import DeviceLike, full_f32, make_device
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import variants


def pipeline_apply(stage_fn: Callable, params: Sequence[Any],
                   xs: torch.Tensor, devices: Sequence[torch.device]
                   ) -> torch.Tensor:
    """Run the (M, mb, ...) microbatches `xs` through S = len(devices)
    stages in the GPipe order: at tick t (M + S - 1 of them) stage s
    applies `stage_fn(params[s], x)` on devices[s] to microbatch t - s.
    Returns the (M, mb, ...) outputs on the last stage's device.
    Differentiable."""
    s, m = len(devices), xs.shape[0]
    outs: List[Optional[torch.Tensor]] = [None] * m
    inbox: List[Optional[torch.Tensor]] = [None] * s
    for t in range(m + s - 1):
        sent: List[Optional[torch.Tensor]] = [None] * s
        for si in range(s):
            mb = t - si
            if not 0 <= mb < m:
                continue
            x = xs[mb].to(devices[si]) if si == 0 else inbox[si]
            y = stage_fn(params[si], x)
            if si == s - 1:
                outs[mb] = y
            else:
                sent[si + 1] = y.to(devices[si + 1], non_blocking=True)
        inbox = sent
    return torch.stack(outs)


def make_pipeline(devices: Sequence[DeviceLike], stage_fn: Callable):
    """`run(params_stacked, xs)`: the pipeline over `devices` with every
    leaf of the `params_stacked` dict holding S stages on its leading dim
    (stage s's slice moved to its device) and xs (M, mb, D) microbatches.
    Differentiable."""
    devs = make_stage_mesh(devices)

    def run(params_stacked: Dict[str, torch.Tensor], xs: torch.Tensor):
        per = [{k: v[si].to(devs[si]) for k, v in params_stacked.items()}
               for si in range(len(devs))]
        return pipeline_apply(stage_fn, per, torch.as_tensor(xs), devs)
    return run


def make_stage_mesh(devices: Optional[Sequence[DeviceLike]] = None
                    ) -> List[torch.device]:
    """The ordered stage devices, one a stage (a device may repeat):
    `devices` resolved (`backends.make_device`: the card unless "cpu" is
    asked for), or every visible card."""
    if devices is None:
        make_device(None)           # raises without CUDA
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [make_device(d) for d in devices]


def _param_count(u) -> float:
    return float(sum(np.prod(tuple(a.shape)) if a is not None else 0.0
                     for a in u.param_arrays().values()))


def split_stages(forwards: Sequence, n_stages: int,
                 boundaries: Optional[Sequence[int]] = None) -> List[List]:
    """Partition the forward chain into `n_stages` contiguous stages. The
    default boundaries balance the cumulative parameter count (JAX
    pipeline.py:127-165, number for number); `boundaries` (the unit
    indices where a new stage starts) override them."""
    units = list(forwards)
    if n_stages > len(units):
        raise ValueError(
            f"{n_stages} stages but only {len(units)} units — build the "
            "stage mesh over at most len(forwards) devices")
    if boundaries is not None:
        if len(boundaries) != n_stages - 1:
            raise ValueError(
                f"boundaries must list the {n_stages - 1} stage-start "
                f"indices (got {len(boundaries)})")
        if list(boundaries) != sorted(set(boundaries)) or (
                boundaries and (boundaries[0] < 1
                                or boundaries[-1] >= len(units))):
            raise ValueError(f"boundaries must be strictly increasing "
                             f"unit indices in [1, {len(units) - 1}]: "
                             f"{boundaries}")
        bounds = [0] + list(boundaries) + [len(units)]
    else:
        costs = np.asarray([max(1.0, _param_count(u)) for u in units])
        cum = np.cumsum(costs) / costs.sum()
        bounds = [0]
        for s in range(1, n_stages):
            i = int(np.searchsorted(cum, s / n_stages)) + 1
            bounds.append(min(max(i, bounds[-1] + 1),
                              len(units) - (n_stages - s)))
        bounds.append(len(units))
    stages = [units[bounds[i]:bounds[i + 1]] for i in range(n_stages)]
    assert all(stages), f"empty stage: bounds={bounds}"
    return stages


class PipelineTrainStep:
    """Train a StandardWorkflow's chain as an S-stage GPipe pipeline over
    `devices` (`make_stage_mesh`), the minibatch split into
    `n_microbatches`.

    state = {"params": [one flat f32 row a stage, on its device],
             "vel":    [its SGD velocities, alike],
             "lr_scale": the schedule's lr multiplier (a float)}
    """

    def __init__(self, workflow, devices: Sequence[DeviceLike],
                 n_microbatches: int,
                 boundaries: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[str] = None,
                 input_normalize: Optional[Dict[str, Any]] = None) -> None:
        from veles_tpu_torch.parallel.fused import COMPUTE_DTYPES, \
            pair_gd_configs
        if not workflow.is_initialized:
            raise RuntimeError("initialize the workflow before building "
                               "its pipeline step")
        if n_microbatches < 1:
            raise ValueError(f"n_microbatches must be >= 1 (got "
                             f"{n_microbatches})")
        self.devices = make_stage_mesh(devices)
        #: the first stage's device, where the batches are uploaded
        self.device = self.devices[0]
        self.n_micro = int(n_microbatches)
        self.forwards = list(workflow.forwards)
        for u in self.forwards:
            if getattr(u, "fused_needs_gen", False):
                raise ValueError(
                    f"{type(u).__name__} needs per-step random numbers; the "
                    "pipeline schedule draws none — use FusedTrainStep for "
                    "stochastic chains")
        self.loss_kind = workflow.loss
        if self.loss_kind == "softmax" and not getattr(
                self.forwards[-1], "fused_emits_logits", False):
            raise ValueError(
                "pipelined softmax loss needs a final layer that emits "
                "logits (All2AllSoftmax, SeqSoftmax) for log-softmax CE")
        if compute_dtype is not None and compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype {compute_dtype!r}: the port "
                             f"computes in {sorted(COMPUTE_DTYPES)}")
        #: "bfloat16", "float32" or None (f32, no cast), as given
        self.compute_dtype = compute_dtype
        self._dtype = (None if compute_dtype in (None, "float32")
                       else COMPUTE_DTYPES[compute_dtype])
        self.input_normalize = None
        if input_normalize:
            self.input_normalize = dict(input_normalize)
            mean = self.input_normalize.get("mean")
            if mean is not None:
                self.input_normalize["mean"] = torch.as_tensor(
                    mean, dtype=torch.float32, device=self.device)
        self.gd_units, self.cfgs = pair_gd_configs(workflow)
        from veles_tpu_torch.ops import optim
        if any(isinstance(c, optim.AdamConfig) for c in self.cfgs):
            raise ValueError(
                "PipelineTrainStep supports the SGD family only "
                "(gd_config optimizer='adam' -> use FusedTrainStep)")
        self.stages = split_stages(self.forwards, len(self.devices),
                                   boundaries)
        self._ranges = []
        i = 0
        for st in self.stages:
            self._ranges.append((i, i + len(st)))
            i += len(st)
        #: per unit, the lowering it runs (resolved now, as the fused
        #: forward's plan), or None for a fixed one
        self._plan = [variants.resolve(u.variant_op, unit=u)
                      if variants.has_op(getattr(u, "variant_op", None)
                                         or "") else None
                      for u in self.forwards]
        self._build_param_layout()

    # -- stage-resident flat parameter layout ---------------------------------

    def _build_param_layout(self) -> None:
        """`_layouts[s]`: (unit, name, shape, lo, hi) slices of stage s's
        row; each element's coefficient group (2i + 1 + is_bias, the pad
        group 0 frozen) and the (4, G) lr / momentum / decay / L1 table
        on each stage's device (JAX pipeline.py:249-287)."""
        self._layouts = []
        for lo_u, hi_u in self._ranges:
            off, lay = 0, []
            for i in range(lo_u, hi_u):
                for name, t in self.forwards[i].param_arrays().items():
                    size = int(t.numel())
                    lay.append((i, name, tuple(t.shape), off, off + size))
                    off += size
            self._layouts.append(lay)
        n_groups = 2 * len(self.forwards) + 1
        tabs = np.zeros((4, n_groups), np.float32)
        self._gid = []
        for si, lay in enumerate(self._layouts):
            gid = np.zeros(max(1, lay[-1][4] if lay else 1), np.int64)
            for i, name, shape, lo, hi in lay:
                cfg = self.cfgs[i]
                bias = len(shape) == 1
                g = 1 + 2 * i + int(bias)
                gid[lo:hi] = g
                lr = cfg.lr * (cfg.lr_bias_mult
                               if bias and cfg.lr_bias_mult != 1.0 else 1.0)
                tabs[:, g] = (lr, cfg.momentum, cfg.weight_decay,
                              cfg.l1_decay)
            self._gid.append(torch.as_tensor(gid, device=self.devices[si]))
        self._tabs = [torch.as_tensor(tabs, device=d) for d in self.devices]

    def stage_param_bytes(self) -> List[int]:
        """The f32 bytes of each stage's parameter row."""
        return [4 * (lay[-1][4] if lay else 0) for lay in self._layouts]

    # -- state ----------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """Each stage's row from the units' parameters, on its device, and
        zero velocities (the JAX step's)."""
        params, vel = [], []
        for si, lay in enumerate(self._layouts):
            dev = self.devices[si]
            parts = [self.forwards[i].param_arrays()[name].detach()
                     .reshape(-1).to(dev, torch.float32)
                     for i, name, _, _, _ in lay]
            row = (torch.cat(parts) if parts
                   else torch.zeros(1, device=dev)).clone()
            params.append(row.requires_grad_(True))
            vel.append(torch.zeros_like(row))
        return {"params": params, "vel": vel, "lr_scale": 1.0}

    def _unflatten(self, si: int, row: torch.Tensor
                   ) -> Dict[int, Dict[str, torch.Tensor]]:
        out: Dict[int, Dict[str, torch.Tensor]] = {
            i: {} for i in range(*self._ranges[si])}
        for i, name, shape, lo, hi in self._layouts[si]:
            out[i][name] = row[lo:hi].view(shape)
        return out

    def params_dicts(self, state) -> tuple:
        """One {name: host array} per forward unit, from the rows."""
        out = [dict() for _ in self.forwards]
        for si, row in enumerate(state["params"]):
            for i, p in self._unflatten(si, row.detach()).items():
                out[i].update({k: t.cpu().numpy().copy()
                               for k, t in p.items()})
        return tuple(out)

    @torch.no_grad()
    def write_back(self, state: Dict[str, Any]) -> None:
        """Copy the rows into the units' parameters (the velocities stay
        in the state, as the JAX step leaves them)."""
        for si, row in enumerate(state["params"]):
            for i, p in self._unflatten(si, row.detach()).items():
                for k, t in self.forwards[i].param_arrays().items():
                    t.copy_(p[k])

    # -- the schedule -----------------------------------------------------------

    def _stage_fn(self, train: bool):
        def run(si_row, x):
            si, row = si_row
            params = self._unflatten(si, row)
            for i in range(*self._ranges[si]):
                p = params[i]
                if self._dtype is not None:
                    p = {k: t.to(self._dtype) for k, t in p.items()}
                kw: Dict[str, Any] = {"train": train}
                if self._plan[i] is not None:
                    kw["variant"] = self._plan[i]
                x = self.forwards[i].fused_apply(p, x, **kw)
            return x
        return run

    def _microbatches(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % self.n_micro:
            raise ValueError(f"batch of {n} not divisible into "
                             f"{self.n_micro} microbatches")
        from veles_tpu_torch.parallel.fused import apply_input_normalize
        x = apply_input_normalize(self.input_normalize, x)
        if self._dtype is not None:
            x = x.to(self._dtype)
        return x.reshape((self.n_micro, n // self.n_micro)
                         + tuple(x.shape[1:]))

    def _flags(self):
        """Full f32 products on the stages' cards (backends.full_f32)."""
        cards = [d for d in self.devices if d.type == "cuda"]
        return full_f32(cards[0]) if cards else contextlib.nullcontext()

    def _forward(self, state, x, train: bool) -> torch.Tensor:
        """The last stage's output of the whole batch (the microbatches'
        in order), f32, on the last stage's device."""
        xs = self._microbatches(x)
        outs = pipeline_apply(self._stage_fn(train),
                              list(enumerate(state["params"])), xs,
                              self.devices)
        return outs.reshape((x.shape[0],) + tuple(outs.shape[2:])) \
            .to(torch.float32)

    def _batch(self, x, y, w):
        dev, last = self.device, self.devices[-1]
        x = torch.as_tensor(x, device=dev)
        if self.input_normalize is None:
            x = x.to(torch.float32)
        y = torch.as_tensor(y, device=last)
        y = y.long() if self.loss_kind == "softmax" else y.to(torch.float32)
        w = (torch.ones(x.shape[0], device=last) if w is None else
             torch.as_tensor(w, dtype=torch.float32, device=last))
        return x, y, w

    def train(self, state, x, y, w=None):
        """One pipelined step on a minibatch (`w` the pad mask, None ==
        all ones); updates `state` in place and returns `(state, (loss,
        n_err))`, the metrics 0-d tensors on the last stage's device."""
        from veles_tpu_torch.parallel.fused import loss_metrics
        x, y, w = self._batch(x, y, w)
        rows = state["params"]
        with torch.enable_grad(), self._flags():
            out = self._forward(state, x, train=True)
            loss, n_err = loss_metrics(self.loss_kind, out, y, w)
            grads = torch.autograd.grad(loss, rows)
        self._update(state, grads)
        return state, (loss.detach(), n_err)

    @torch.no_grad()
    def _update(self, state, grads) -> None:
        """SGD + momentum on every stage's row, coefficients gathered by
        group (JAX pipeline.py:464-476)."""
        scale = state["lr_scale"]
        for si, (p, v, g) in enumerate(zip(state["params"], state["vel"],
                                           grads)):
            tabs, gid = self._tabs[si], self._gid[si]
            lr = tabs[0][gid] * scale
            reg = g + tabs[2][gid] * p + tabs[3][gid] * torch.sign(p)
            v.copy_(tabs[1][gid] * v - lr * reg)
            p.add_(v)

    def evaluate(self, state, x, y, w=None):
        """Forward-only `(loss, n_err)` of a minibatch (the pad mask's
        rows drop out)."""
        from veles_tpu_torch.parallel.fused import loss_metrics
        x, y, w = self._batch(x, y, w)
        with torch.inference_mode(), self._flags():
            out = self._forward(state, x, train=False)
            return loss_metrics(self.loss_kind, out, y, w)

    def confusion(self, state, x, y, n_classes: int, w=None):
        """(C, C) confusion counts of a minibatch, as the fused step's;
        None for a head that is not one label per sample."""
        if self.loss_kind != "softmax":
            return None
        x, y, w = self._batch(x, y, w)
        if y.numel() != x.shape[0]:
            return None
        with torch.inference_mode(), self._flags():
            out = self._forward(state, x, train=False)
            if out.dim() != 2:
                return None
            return fn.confusion(y, out.argmax(dim=-1), n_classes, w)
