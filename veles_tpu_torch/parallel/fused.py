"""The fused step of a StandardWorkflow: the whole forward chain as one
call, with the cross-op fusion of adjacent (LRN, max pooling) pairs, and
the training step built on it.

The port's counterpart of `FusedTrainStep` in
`veles_tpu/parallel/fused.py` in local mode, one device:
`FusedForward` is its forward half (`_forward`, `_pair_fusion`,
`fusion_pairs`, `_apply_fused_pair`), which the server serves from;
`FusedTrainStep` adds the loss, the backward and the update (`init_state`,
`train`, `train_accum`, `train_repeat`, `train_many`, `evaluate`,
`confusion`, `write_back`, `variant_table`). The loss is the workflow's:
the softmax cross-entropy from the last layer's logits, or the MSE of
its output against the loader's targets (`ops.functional.mse`, the JAX
step's `ox.mse(out, y, weights=w, denom=denom)`, fused.py:805 there),
whose `n_err` is the loss itself. The JAX package
resolves lowerings when it traces; PyTorch runs eagerly, so both resolve
them once, when built, into a fixed plan — a server keeps serving, and a
step keeps training, what it was built with whatever the registry selects
later. Inside the plan, a unit whose lowering depends on its input's
shape still decides per call, as the JAX unit does per trace: the
attention unit runs the plan's `flash_attn` variant where its gate
admits the sequence length and the einsum golden elsewhere, and
`variant_table` reports what it runs (`variant_effective`). The rule
that a claimed unit is a pass-through is the JAX package's: an LRN claims
the max pooling after it under a fused `lrn_maxpool` point, and an auto
stem convolution the LRN after it under an `epi=lrn` `conv_stem` point
(the earlier pair wins a shared LRN). Generated points (`base[...]`,
ops/templates.py) resolve like hand-written ones.

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

The update (the JAX step's `_apply_update`, local mode): per layer, the
SGD rule through the `sgd_update` lowering (K1), or Adam
(`ops/optim.py`, plain tensor operations as in the JAX package, which
computes Adam in XLA) where the gradient twin's `optimizer` is "adam";
an Adam layer's state is `{"m", "v", "t"}` and its moments stay in the
state (`write_back` copies only its parameters; parallel/checkpoint.py
carries them). `train_accum(k)` sums the gradients of k microbatches,
each normalized by the full batch's weight sum, before one update;
`train_repeat` and `train_many` are k calls of `train` in a Python loop,
their metrics stacked on the device (the JAX package's are one
`lax.scan` dispatch).

Differences from the JAX step: the step updates its state in place (the
JAX step returns a new one); its dropout masks come from the PRNG
registry's device stream (`prng.RandomGenerator.device_stream`, one
`torch.Generator` per device type that advances across steps and
builds) instead of the state's key, and every unit that draws
(`fused_needs_gen`: dropout, stochastic pooling) draws from it in turn
where the JAX step folds the unit's index into the key; the backward
is `torch.autograd.grad` over the parameter leaves, through the kernels'
autograd functions (ops/kernels.py). Velocities follow the JAX package's
names (`vel_w` / `vel_b` for weights / bias, `vel_<name>` otherwise;
`GradientDescentBase.vel_attr`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.backends import full_f32
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import optim, templates, variants

#: compute dtypes the fused step takes, by the names
#: root.common.precision_type and `compute_dtype` give them
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_input_normalize(spec: Optional[Dict[str, Any]],
                          x: torch.Tensor,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The uint8 wire's prologue and the InputNormalize layer's affine:
    x to `dtype` (f32 when None), `* scale + offset`, `- mean` (a
    multiplication by the scale, as the JAX function does). Below f32
    (the layer behind the fused step's bf16 entry cast) the constants are
    rounded to `dtype` first, as the JAX layer's `jnp.asarray(c, dt)`
    rounds them. No-op when `spec` is None."""
    if spec is None:
        return x
    dt = torch.float32 if dtype is None else dtype
    scale, offset = spec.get("scale", 1.0), spec.get("offset", 0.0)
    if dt != torch.float32:
        scale, offset = (torch.tensor(c, dtype=dt, device=x.device)
                         for c in (scale, offset))
    x = x.to(dt) * scale + offset
    mean = spec.get("mean")
    if mean is not None:
        x = x - torch.as_tensor(mean, dtype=dt, device=x.device)
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
        (a composed selection, a per-layer override on either side, a
        max-abs pooling, which never fuses, or a convolution that is no
        auto stem). The pairs (JAX fused.py:612-646): an LRN and the max
        pooling after it under a fused `lrn_maxpool` point, and an auto
        stem and the LRN after it under an `epi=lrn` `conv_stem` point."""
        if nxt is None:
            return None
        if getattr(u, "variant_override", None) is not None \
                or getattr(nxt, "variant_override", None) is not None:
            return None
        op_a = getattr(u, "variant_op", None)
        op_b = getattr(nxt, "variant_op", None)
        if op_a == "lrn" and op_b == "maxpool" \
                and not getattr(nxt, "use_abs", False):
            return templates.fusion_point("lrn_maxpool")
        if op_a == "conv_stem" and op_b == "lrn":
            if u.s2d != "auto" or u.weights is None \
                    or not u._s2d_applicable(u.weights.shape[2]):
                return None
            return templates.fusion_point("conv_stem")
        return None

    def fusion_pairs(self):
        """[(i, i+1, Variant), ...] adjacent unit pairs the CURRENT
        registry selections claim, left to right: a unit joins at most one
        pair, so where a stem's epilogue and an LRN->pool point both want
        one LRN, the stem takes it and that pool runs alone. Resolved
        fresh per call."""
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
    def _apply_fused_pair(v, u, nxt, params_u, x):
        """Run one claimed pair through the fused variant; the trailing
        unit is a pass-through. An (LRN, max pooling) pair: the LRN's
        hyperparameters and the pool's window; a (stem, LRN) pair: the
        convolution with the LRN's hyperparameters as its epilogue."""
        if getattr(u, "variant_op", None) == "lrn":
            return v.apply(x, k=u.k, alpha=u.alpha, beta=u.beta, n=u.n,
                           ksize=tuple(nxt.ksize), stride=tuple(nxt.stride))
        return v.apply(x, params_u["weights"], params_u["bias"], u.stride,
                       u.padding, u.activation,
                       epilogue={"k": nxt.k, "alpha": nxt.alpha,
                                 "beta": nxt.beta, "n": nxt.n})

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
                    x = self._apply_fused_pair(v, u, self.forwards[j],
                                               params[i], x)
                    continue
                kw: Dict[str, Any] = {"train": train}
                if v is not None:
                    kw["variant"] = v
                if u.fused_needs_gen:
                    kw["gen"] = gen
                x = u.fused_apply(params[i], x, **kw)
        return x.to(torch.float32)

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this forward runs (JAX fused.py:1405-1450):
        each unclaimed unit's lowering (a unit with `variant_effective`
        reports what a call at its initialized shape runs, or nothing);
        a claimed (LRN, pool) pair reports its point for `lrn_maxpool` and
        `lrn_maxpool/<name>` for the `lrn` and `maxpool` ops where no
        unclaimed unit of them runs its own, and a claimed (stem, LRN)
        pair its point for `conv_stem` and `conv_stem/<name>` for `lrn`
        likewise."""
        table: Dict[str, str] = {}
        for u, (kind, _, v) in zip(self.forwards, self._plan):
            if kind == "unit" and v is not None:
                effective = getattr(u, "variant_effective", None)
                name = effective(v) if effective is not None else v.name
                if name is not None:
                    table[u.variant_op] = name
        for i, j, v in self.pairs:
            a, b = self.forwards[i], self.forwards[j]
            if a.variant_op == "lrn":
                table["lrn_maxpool"] = v.name
                table.setdefault("lrn", f"lrn_maxpool/{v.name}")
                table.setdefault("maxpool", f"lrn_maxpool/{v.name}")
            else:
                table.setdefault("conv_stem", v.name)
                table.setdefault(b.variant_op, f"conv_stem/{v.name}")
        return table


#: the update rules a gradient twin's `optimizer` names
OPTIMIZERS = ("sgd", "adam")


def pair_gd_configs(workflow):
    """(gd_units, update configs) aligned with workflow.forwards — each
    forward keeps its gradient twin's hyperparameters (`workflow.gds` is
    built in reverse order). A twin whose `optimizer` is "adam" gets an
    AdamConfig, any other an SGDConfig; the attribute is read here, when
    the step is built (fused.py:110-133 in the JAX package)."""
    gds = list(workflow.gds)
    n = len(list(workflow.forwards))
    gd_units = [gds[n - 1 - i] for i in range(n)]
    cfgs = []
    for g in gd_units:
        kind = getattr(g, "optimizer", "sgd")
        if kind not in OPTIMIZERS:
            raise ValueError(f"{g.name}: optimizer {kind!r}; the fused "
                             f"step updates with {OPTIMIZERS}")
        if kind == "adam":
            cfgs.append(optim.AdamConfig(
                lr=g.learning_rate, b1=getattr(g, "adam_beta1", 0.9),
                b2=getattr(g, "adam_beta2", 0.999),
                eps=getattr(g, "adam_eps", 1e-8),
                weight_decay=g.weights_decay))
        else:
            cfgs.append(optim.SGDConfig(
                lr=g.learning_rate, momentum=g.gradient_moment,
                weight_decay=g.weights_decay, l1_decay=g.l1_decay,
                lr_bias_mult=g.learning_rate_bias))
    return gd_units, cfgs


class FusedTrainStep:
    """One training step of a StandardWorkflow: forward, loss (softmax
    cross-entropy or MSE), backward, update (SGD or Adam per layer), on
    the workflow's device.

    state = {"params": tuple of {name: leaf} (one per forward unit),
             "vel":    per unit, the SGD velocities {name: tensor}, or
                       the Adam state {"m": {...}, "v": {...}, "t": 0-d
                       int32 tensor},
             "lr_scale": the schedule's lr multiplier (a float)}
    """

    def __init__(self, workflow, compute_dtype: Optional[str] = None,
                 input_normalize: Optional[Dict[str, Any]] = None) -> None:
        #: "softmax" or "mse" (StandardWorkflow admits no other)
        self.loss_kind = workflow.loss
        if self.loss_kind == "softmax" and not getattr(
                workflow.forwards[-1], "fused_emits_logits", False):
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
        #: the SGD update's lowering, fixed at build like the forward's
        self._sgd = variants.resolve("sgd_update")
        #: the dropout masks' source: the registry's device stream, which
        #: advances across steps and builds and rides in a snapshot (the
        #: JAX step draws a new key split, fused.py:470 there)
        self.gen = prng.get().device_stream(self.device)

    def fusion_pairs(self):
        return self.fwd.fusion_pairs()

    # -- state <-> units ------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """A copy of the units' parameters as trainable leaves; for an SGD
        layer the velocities its gradient twin holds (zeros where it holds
        none), for an Adam layer zero moments and `t` = 0 (the twin holds
        no moments: a snapshot resume restarts them, as in the JAX
        package)."""
        params = tuple(
            {k: t.detach().clone().requires_grad_(True)
             for k, t in u.param_arrays().items()}
            for u in self.forwards)
        vel = []
        for g, p, cfg in zip(self.gd_units, params, self.cfgs):
            if isinstance(cfg, optim.AdamConfig):
                vel.append(optim.adam_init(p, self.device))
                continue
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
        """Copy the state's parameters into the units, and an SGD layer's
        velocities into its gradient twin (an Adam layer's moments stay in
        the state)."""
        for u, g, p, v, cfg in zip(self.forwards, self.gd_units,
                                   state["params"], state["vel"], self.cfgs):
            adam = isinstance(cfg, optim.AdamConfig)
            for k, t in u.param_arrays().items():
                t.copy_(p[k])
                if not adam:
                    setattr(g, g.vel_attr(k), v[k].clone())

    # -- steps ----------------------------------------------------------------

    def _batch(self, x, y, w):
        """The batch as tensors on the step's device: tensors already
        there (the device feed's) are taken as they are; host arrays are
        uploaded. x stays uint8 where the prologue normalizes it; y is
        integer labels for the softmax loss, f32 targets for the MSE."""
        x = torch.as_tensor(x, device=self.device)
        if self.input_normalize is None:
            x = x.to(torch.float32)
        y = torch.as_tensor(y, device=self.device)
        y = y.long() if self.loss_kind == "softmax" else \
            y.to(torch.float32)
        w = (torch.ones(x.shape[0], device=self.device) if w is None else
             torch.as_tensor(w, dtype=torch.float32, device=self.device))
        return x, y, w

    def _loss_metrics(self, out, y, w, wsum=None):
        """(loss, n_err) of one batch. The MSE: the per-sample summed
        squared error over the valid rows (denominator the weight sum, or
        `wsum`), n_err the loss itself. The softmax head: (weighted mean
        cross-entropy, misclassified valid labels): the
        pad mask's zero rows drop out of both, and of the gradient. The
        JAX step's rule (fused.py:781-801 there): the (N,) sample weights
        cover (N,) classifier labels, (N, S) per-token labels, or flat
        (N·S,) labels, each sample's weight repeated over its S
        consecutive tokens, and the denominator is the weight sum times
        the tokens per sample. `wsum` overrides that weight sum: gradient
        accumulation passes the full batch's, so the microbatches' losses
        and gradients sum to the full batch's mean."""
        if self.loss_kind == "mse":
            loss, _ = fn.mse(out, y.reshape(out.shape), weights=w,
                             denom=w.sum() if wsum is None else wsum)
            return loss, loss.detach()
        if y.dim() == w.dim() and y.shape[0] != w.shape[0] \
                and y.shape[0] % w.shape[0] == 0:
            wt = w.repeat_interleave(y.shape[0] // w.shape[0])
        else:
            wt = w.reshape(w.shape + (1,) * (y.dim() - w.dim())) \
                .broadcast_to(y.shape)
        tokens = wt.numel() // w.numel()
        loss = fn.ce_loss_from_logits(
            out, y, weights=wt,
            denom=(w.sum() if wsum is None else wsum) * tokens)
        wrong = (out.reshape(-1, out.shape[-1]).argmax(dim=-1)
                 != y.reshape(-1))
        n_err = (wrong & (wt.reshape(-1) > 0)).sum()
        return loss, n_err

    def _grads(self, state, x, y, w, wsum=None):
        """(gradients, one tuple per layer aligned with state["params"],
        loss, n_err) of one batch already on the device; the autograd
        graph is freed before this returns."""
        leaves = [t for layer in state["params"] for t in layer.values()]
        with torch.enable_grad(), full_f32(self.device):
            out = self.fwd._forward(state["params"], x, train=True,
                                    gen=self.gen)
            loss, n_err = self._loss_metrics(out, y, w, wsum)
            flat = iter(torch.autograd.grad(loss, leaves))
        grads = tuple({k: next(flat) for k in p} for p in state["params"])
        return grads, loss.detach(), n_err

    @torch.no_grad()
    def _apply_update(self, state, grads) -> None:
        """One update of every layer in place: Adam where the layer's
        config is Adam, the `sgd_update` lowering (K1) elsewhere."""
        for p, g, v, cfg in zip(state["params"], grads, state["vel"],
                                self.cfgs):
            if not p:
                continue
            if isinstance(cfg, optim.AdamConfig):
                optim.adam_update(p, g, v, cfg, lr_scale=state["lr_scale"])
            else:
                self._sgd.apply(p, g, v, cfg, lr_scale=state["lr_scale"])

    def train(self, state, x, y, w=None):
        """One training step on a minibatch (host arrays or tensors; `y`
        holds (N,) labels or flat (N·S,) per-token ones; `w` is the
        Loader's (N,) pad mask, None == all ones). Updates `state`
        in place and returns `(state, (loss, n_err))`, the metrics as 0-d
        tensors on the device (no host sync)."""
        x, y, w = self._batch(x, y, w)
        grads, loss, n_err = self._grads(state, x, y, w)
        self._apply_update(state, grads)
        return state, (loss, n_err)

    def train_accum(self, state, x, y, k: int, w=None):
        """ONE update from the gradient of the full (N,) batch, computed
        as k microbatches of N/k rows, one after another, each one's
        autograd graph freed before the next runs (activation memory
        O(N/k)). Each microbatch's loss is normalized by the full batch's
        weight sum, so the summed gradient is the full batch's mean
        gradient, pad rows included; the loss and n_err are the sums over
        the microbatches; dropout draws from the device stream,
        microbatch after microbatch (`train_accum`, fused.py:1526-1580,
        and `_accum_body`, :1028-1073, in the JAX package). Returns
        `(state, (loss, n_err))` for the whole batch."""
        n = int(np.shape(x)[0])
        if n % k:
            raise ValueError(f"batch {n} not divisible by k={k}")
        if int(np.shape(y)[0]) != n:
            # the JAX function reshapes y to (k, N/k) + y.shape[1:]: flat
            # (N·S,) per-token labels do not split into k microbatches
            raise ValueError(
                f"train_accum splits x {tuple(np.shape(x))} and y "
                f"{tuple(np.shape(y))} into {k} microbatches along the "
                f"first dimension: y needs {n} rows, one per sample")
        m = n // k
        x, y, w = self._batch(x, y, w)
        wsum = w.sum()
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        n_err = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(k):
            rows = slice(i * m, (i + 1) * m)
            grads, mloss, merr = self._grads(state, x[rows], y[rows],
                                             w[rows], wsum)
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    for key in a:
                        a[key].add_(g[key])
            del grads
            loss = loss + mloss
            n_err = n_err + merr
        self._apply_update(state, acc)
        return state, (loss, n_err)

    def train_repeat(self, state, x, y, k: int, w=None):
        """k updates on ONE minibatch, uploaded once and kept on the
        device (the JAX package's benchmark loop, fused.py:1476-1524
        there). Returns `(state, (losses, n_errs))` with a leading
        dimension of k, tensors on the device (no host sync)."""
        x, y, w = self._batch(x, y, w)
        losses, errs = [], []
        for _ in range(k):
            state, (loss, n_err) = self.train(state, x, y, w)
            losses.append(loss)
            errs.append(n_err)
        return state, (torch.stack(losses), torch.stack(errs))

    def train_many(self, state, xs, ys, ws=None):
        """len(xs) training steps over stacked minibatches: xs (K, N,
        ...), ys (K, N, ...), ws (K, N) or None, uploaded once
        (fused.py:1582-1632 in the JAX package). Returns `(state,
        (losses, n_errs))` with a leading dimension of K, tensors on the
        device (no host sync)."""
        xs = torch.as_tensor(xs, device=self.device)
        ys = torch.as_tensor(ys, device=self.device)
        if ws is not None:
            ws = torch.as_tensor(ws, dtype=torch.float32,
                                 device=self.device)
        losses, errs = [], []
        for i in range(xs.shape[0]):
            state, (loss, n_err) = self.train(
                state, xs[i], ys[i], None if ws is None else ws[i])
            losses.append(loss)
            errs.append(n_err)
        return state, (torch.stack(losses), torch.stack(errs))

    def evaluate(self, state, x, y, w=None):
        """Forward-only `(loss, n_err)` of a validation/test minibatch."""
        x, y, w = self._batch(x, y, w)
        with torch.inference_mode():
            out = self.fwd._forward(state["params"], x)
            return self._loss_metrics(out, y, w)

    def confusion(self, state, x, y, n_classes: int, w=None):
        """(C, C) int64 confusion counts, true class by row and predicted
        by column, of one minibatch's rows of weight > 0 (the pad mask),
        from a forward-only pass on the device (no host sync): the fused
        loop's companion of the granular evaluator's matrix (JAX
        fused.py:1363). None for a head that is not one label per sample
        (the MSE, a per-token head)."""
        if self.loss_kind != "softmax":
            return None
        x, y, w = self._batch(x, y, w)
        if y.numel() != x.shape[0]:
            return None
        with torch.inference_mode():
            out = self.fwd._forward(state["params"], x)
            if out.dim() != 2:
                return None
            return fn.confusion(y, out.argmax(dim=-1), n_classes, w)

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this step runs: the forward's, and the SGD
        update's where at least one layer updates with SGD (the JAX
        step's rule, fused.py:1460-1465 there)."""
        table = self.fwd.variant_table()
        if any(isinstance(c, optim.SGDConfig) for c in self.cfgs):
            table["sgd_update"] = self._sgd.name
        return table
