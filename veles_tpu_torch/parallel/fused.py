"""The fused step of a StandardWorkflow: the whole forward chain as one
call, with the cross-op fusion of adjacent (LRN, max pooling) pairs, and
the training step built on it.

The port's counterpart of `FusedTrainStep` in
`veles_tpu/parallel/fused.py` in local mode, one device:
`FusedForward` is its forward half (`_forward`, `_pair_fusion`,
`fusion_pairs`, `_apply_fused_pair`), which the server serves from;
`FusedTrainStep` adds the loss, the backward and the update (`init_state`,
`train`, `evaluate`, `write_back`, `variant_table`). The JAX package
resolves lowerings when it traces; PyTorch runs eagerly, so both resolve
them once, when built, into a fixed plan — a server keeps serving, and a
step keeps training, what it was built with whatever the registry selects
later. Inside the plan, a unit whose lowering depends on its input's
shape still decides per call, as the JAX unit does per trace: the
attention unit runs the plan's `flash_attn` variant where its gate
admits the sequence length and the einsum golden elsewhere, and
`variant_table` reports what it runs (`variant_effective`). The rule
that a claimed pool is a pass-through is the JAX package's.

Compute dtype (the JAX step's `compute_dtype`, fused.py:165-174 and
:686-736 there): None falls back to `root.common.precision_type` unless
that is "float32"; an explicit argument wins. Under "bfloat16" the
forward casts x and every parameter leaf to bf16 once per call, with a
differentiable `.to`, so that `torch.autograd.grad` over the f32 master
leaves returns f32 gradients (the cast's VJP, as in JAX), runs the units
in bf16 and casts their output to f32 before the loss; the state, the
velocities and the update stay f32.

Input normalize (the uint8 wire's prologue, the JAX step's
`input_normalize`, applied at :683-685 there): `apply_input_normalize`
converts a uint8 x to f32 and applies the loader's affine on the card,
in the JAX function's order and operations, before the compute-dtype
cast. A batch that the device feed uploaded arrives as tensors on the
step's device and is taken as it is: no second copy, no host sync.

Differences from the JAX step: the step updates its state in place (the
JAX step returns a new one); its dropout masks come from a
`torch.Generator` the step owns instead of the state's key; the backward
is `torch.autograd.grad` over the parameter leaves, through the kernels'
autograd functions (ops/kernels.py). Velocities follow the JAX package's
names (`vel_w` / `vel_b` for weights / bias, `vel_<name>` otherwise;
`GradientDescentBase.vel_attr`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from veles_tpu_torch import prng
from veles_tpu_torch.backends import full_f32
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import optim, variants

#: compute dtypes the fused step takes, by the names
#: root.common.precision_type and `compute_dtype` give them
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_input_normalize(spec: Optional[Dict[str, Any]],
                          x: torch.Tensor) -> torch.Tensor:
    """The uint8 wire's prologue: x to f32, `* scale + offset`, `- mean`
    (a multiplication by the scale, as the JAX function does), in f32.
    No-op when `spec` is None."""
    if spec is None:
        return x
    x = x.to(torch.float32) * spec.get("scale", 1.0) \
        + spec.get("offset", 0.0)
    mean = spec.get("mean")
    if mean is not None:
        x = x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    return x


def resolve_compute_dtype(compute_dtype: Optional[str]) -> Optional[str]:
    """The JAX step's rule: an explicit `compute_dtype` wins; None falls
    back to root.common.precision_type unless that is "float32" (no cast:
    the parameters are already f32 master weights)."""
    if compute_dtype is None:
        pt = getattr(root.common, "precision_type", None)
        if pt and pt != "float32":
            compute_dtype = pt
    if compute_dtype is not None and compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {compute_dtype!r}: the port "
                         f"computes in {sorted(COMPUTE_DTYPES)}")
    return compute_dtype


class FusedForward:
    """Forward chain of `workflow` on its device, lowerings and compute
    dtype fixed at build time."""

    def __init__(self, workflow, compute_dtype: Optional[str] = None,
                 input_normalize: Optional[Dict[str, Any]] = None) -> None:
        if not workflow.is_initialized:
            raise RuntimeError("initialize the workflow before building "
                               "its fused forward")
        #: "bfloat16", "float32" or None (f32, no cast)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self._dtype = (None if self.compute_dtype is None
                       else COMPUTE_DTYPES[self.compute_dtype])
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self.device: torch.device = workflow.device
        #: the uint8 wire's prologue spec (None: x arrives normalized),
        #: its mean image on the device once
        self.input_normalize = None
        if input_normalize:
            self.input_normalize = dict(input_normalize)
            mean = self.input_normalize.get("mean")
            if mean is not None:
                self.input_normalize["mean"] = torch.as_tensor(
                    mean, dtype=torch.float32, device=self.device)
        self.pairs = self.fusion_pairs()
        claimed = {j: i for i, j, _ in self.pairs}
        fused = {i: (j, v) for i, j, v in self.pairs}
        #: per unit: ("pair", j, variant) | ("skip", i, None) |
        #: ("unit", None, variant-or-None)
        self._plan: List[Tuple[str, Optional[int], Optional[object]]] = []
        for i, u in enumerate(self.forwards):
            if i in claimed:
                self._plan.append(("skip", claimed[i], None))
            elif i in fused:
                self._plan.append(("pair",) + fused[i])
            elif variants.has_op(getattr(u, "variant_op", None) or ""):
                self._plan.append(("unit", None, variants.resolve(
                    u.variant_op, unit=u)))
            else:
                self._plan.append(("unit", None, None))

    # -- cross-op fusion ------------------------------------------------------

    def _pair_fusion(self, u, nxt):
        """The FUSED variant claiming the adjacent (u, nxt) pair, or None
        (a composed selection, or a per-layer override on either
        side)."""
        if nxt is None:
            return None
        if getattr(u, "variant_override", None) is not None \
                or getattr(nxt, "variant_override", None) is not None:
            return None
        if getattr(u, "variant_op", None) == "lrn" \
                and getattr(nxt, "variant_op", None) == "maxpool":
            v = variants.resolve("lrn_maxpool")
            return v if v.fused else None
        return None

    def fusion_pairs(self):
        """[(i, i+1, Variant), ...] adjacent unit pairs the CURRENT
        registry selections claim, left to right (a unit joins at most one
        pair). Resolved fresh per call."""
        out = []
        claimed: set = set()
        fwds = self.forwards
        for i, u in enumerate(fwds[:-1]):
            if i in claimed or (i + 1) in claimed:
                continue
            v = self._pair_fusion(u, fwds[i + 1])
            if v is not None:
                out.append((i, i + 1, v))
                claimed.update((i, i + 1))
        return out

    @staticmethod
    def _apply_fused_pair(v, u, nxt, x):
        """Run one claimed (LRN, max pooling) pair through the fused
        variant; the pooling unit is a pass-through."""
        return v.apply(x, k=u.k, alpha=u.alpha, beta=u.beta, n=u.n,
                       ksize=tuple(nxt.ksize), stride=tuple(nxt.stride))

    # -- forward --------------------------------------------------------------

    def params(self) -> Tuple[Dict[str, torch.Tensor], ...]:
        """The units' parameters, one `{name: tensor}` per forward unit."""
        return tuple(u.param_arrays() for u in self.forwards)

    def _forward(self, params, x: torch.Tensor, train: bool = False,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward `x` (NHWC, on this forward's device) through the plan
        in the compute dtype (an f32 step: full f32, no TF32, on the card;
        see `backends.full_f32`); returns the last unit's output
        (logits for a softmax head) in f32. `train=False` runs under
        `torch.inference_mode()`; `train=True` records the autograd graph
        in the caller's grad mode and hands `gen` to the units that draw
        random numbers (dropout)."""
        mode = contextlib.nullcontext() if train else torch.inference_mode()
        with mode, full_f32(self.device):
            x = apply_input_normalize(self.input_normalize, x)
            if self._dtype is not None:
                # once per call; differentiable, so the gradients of the
                # f32 master leaves come back f32
                x = x.to(self._dtype)
                params = tuple({k: t.to(self._dtype) for k, t in p.items()}
                               for p in params)
            for i, (kind, j, v) in enumerate(self._plan):
                u = self.forwards[i]
                if kind == "skip":
                    continue
                if kind == "pair":
                    x = self._apply_fused_pair(v, u, self.forwards[j], x)
                    continue
                kw: Dict[str, Any] = {"train": train}
                if v is not None:
                    kw["variant"] = v
                if u.fused_needs_gen:
                    kw["gen"] = gen
                x = u.fused_apply(params[i], x, **kw)
        return x.to(torch.float32)

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this forward runs. A claimed pair reports the
        fused variant for `lrn_maxpool`, and `lrn_maxpool/<name>` for the
        `lrn` op unless an unclaimed LRN unit runs its own lowering; a unit
        with `variant_effective` reports what a call at its initialized
        shape runs."""
        table: Dict[str, str] = {}
        for u, (kind, _, v) in zip(self.forwards, self._plan):
            if kind == "unit" and v is not None:
                effective = getattr(u, "variant_effective", None)
                table[u.variant_op] = (effective(v) if effective is not None
                                       else v.name)
        for _, _, v in self.pairs:
            table["lrn_maxpool"] = v.name
            table.setdefault("lrn", f"lrn_maxpool/{v.name}")
        return table


def pair_gd_configs(workflow):
    """(gd_units, SGD configs) aligned with workflow.forwards — each forward
    keeps its gradient twin's hyperparameters (`workflow.gds` is built in
    reverse order)."""
    gds = list(workflow.gds)
    n = len(list(workflow.forwards))
    gd_units = [gds[n - 1 - i] for i in range(n)]
    cfgs = [optim.SGDConfig(lr=g.learning_rate, momentum=g.gradient_moment,
                            weight_decay=g.weights_decay,
                            l1_decay=g.l1_decay,
                            lr_bias_mult=g.learning_rate_bias)
            for g in gd_units]
    return gd_units, cfgs


class FusedTrainStep:
    """One training step of a StandardWorkflow: forward, softmax
    cross-entropy, backward, SGD update, on the workflow's device.

    state = {"params": tuple of {name: leaf} (one per forward unit),
             "vel":    the matching velocities,
             "lr_scale": the schedule's lr multiplier (a float)}
    """

    def __init__(self, workflow, compute_dtype: Optional[str] = None,
                 input_normalize: Optional[Dict[str, Any]] = None) -> None:
        if workflow.loss != "softmax":
            raise NotImplementedError(
                f"the fused step trains a softmax head; loss "
                f"{workflow.loss!r} comes with a later slice")
        if not getattr(workflow.forwards[-1], "fused_emits_logits", False):
            raise ValueError(
                "fused softmax loss needs a final layer that emits logits "
                "(All2AllSoftmax, SeqSoftmax) for log-softmax CE")
        self.fwd = FusedForward(workflow, compute_dtype, input_normalize)
        #: the uint8 wire's prologue spec, None without one
        self.input_normalize = self.fwd.input_normalize
        #: "bfloat16", "float32" or None, by the JAX step's rule
        self.compute_dtype = self.fwd.compute_dtype
        self.forwards = self.fwd.forwards
        self.device = self.fwd.device
        self.gd_units, self.cfgs = pair_gd_configs(workflow)
        #: the update's lowering, fixed at build like the forward's
        self._sgd = variants.resolve("sgd_update")
        #: the dropout masks' source (the JAX step folds its state key)
        self.gen = prng.get().torch_generator(self.device)

    def fusion_pairs(self):
        return self.fwd.fusion_pairs()

    # -- state <-> units ------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """A copy of the units' parameters as trainable leaves, and the
        velocities the gradient twins hold (zeros where they hold
        none)."""
        params = tuple(
            {k: t.detach().clone().requires_grad_(True)
             for k, t in u.param_arrays().items()}
            for u in self.forwards)
        vel = []
        for g, p in zip(self.gd_units, params):
            layer = {}
            for k, t in p.items():
                seed = g.velocity(k)
                layer[k] = (seed.detach().to(self.device, copy=True)
                            if seed is not None
                            else torch.zeros_like(t, requires_grad=False))
            vel.append(layer)
        return {"params": params, "vel": tuple(vel), "lr_scale": 1.0}

    @torch.no_grad()
    def write_back(self, state: Dict[str, Any]) -> None:
        """Copy the state's parameters into the units and its velocities
        into the gradient twins."""
        for u, g, p, v in zip(self.forwards, self.gd_units, state["params"],
                              state["vel"]):
            for k, t in u.param_arrays().items():
                t.copy_(p[k])
                setattr(g, g.vel_attr(k), v[k].clone())

    # -- steps ----------------------------------------------------------------

    def _batch(self, x, y, w):
        """The batch as tensors on the step's device: tensors already
        there (the device feed's) are taken as they are; host arrays are
        uploaded. x stays uint8 where the prologue normalizes it."""
        x = torch.as_tensor(x, device=self.device)
        if self.input_normalize is None:
            x = x.to(torch.float32)
        y = torch.as_tensor(y, device=self.device).long()
        w = (torch.ones(x.shape[0], device=self.device) if w is None else
             torch.as_tensor(w, dtype=torch.float32, device=self.device))
        return x, y, w

    @staticmethod
    def _loss_metrics(out, y, w):
        """(weighted mean cross-entropy, misclassified valid labels): the
        pad mask's zero rows drop out of both, and of the gradient. The
        JAX step's rule (fused.py:781-801 there): the (N,) sample weights
        cover (N,) classifier labels, (N, S) per-token labels, or flat
        (N·S,) labels, each sample's weight repeated over its S
        consecutive tokens, and the denominator is the weight sum times
        the tokens per sample."""
        if y.dim() == w.dim() and y.shape[0] != w.shape[0] \
                and y.shape[0] % w.shape[0] == 0:
            wt = w.repeat_interleave(y.shape[0] // w.shape[0])
        else:
            wt = w.reshape(w.shape + (1,) * (y.dim() - w.dim())) \
                .broadcast_to(y.shape)
        tokens = wt.numel() // w.numel()
        loss = fn.ce_loss_from_logits(out, y, weights=wt,
                                      denom=w.sum() * tokens)
        wrong = (out.reshape(-1, out.shape[-1]).argmax(dim=-1)
                 != y.reshape(-1))
        n_err = (wrong & (wt.reshape(-1) > 0)).sum()
        return loss, n_err

    def train(self, state, x, y, w=None):
        """One training step on a minibatch (host arrays or tensors; `y`
        holds (N,) labels or flat (N·S,) per-token ones; `w` is the
        Loader's (N,) pad mask, None == all ones). Updates `state`
        in place and returns `(state, (loss, n_err))`, the metrics as 0-d
        tensors on the device (no host sync)."""
        x, y, w = self._batch(x, y, w)
        leaves = [t for layer in state["params"] for t in layer.values()]
        with torch.enable_grad(), full_f32(self.device):
            out = self.fwd._forward(state["params"], x, train=True,
                                    gen=self.gen)
            loss, n_err = self._loss_metrics(out, y, w)
            grads = iter(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            for p, v, cfg in zip(state["params"], state["vel"], self.cfgs):
                if p:
                    g = {k: next(grads) for k in p}
                    self._sgd.apply(p, g, v, cfg, lr_scale=state["lr_scale"])
        return state, (loss.detach(), n_err)

    def evaluate(self, state, x, y, w=None):
        """Forward-only `(loss, n_err)` of a validation/test minibatch."""
        x, y, w = self._batch(x, y, w)
        with torch.inference_mode():
            out = self.fwd._forward(state["params"], x)
            return self._loss_metrics(out, y, w)

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this step runs: the forward's, and the
        update's."""
        table = self.fwd.variant_table()
        table["sgd_update"] = self._sgd.name
        return table
