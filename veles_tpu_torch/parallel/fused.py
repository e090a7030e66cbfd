"""The fused step of a StandardWorkflow: the whole forward chain as one
call, with the cross-op fusion of adjacent (LRN, max pooling) pairs, and
the training step built on it.

The port's counterpart of `FusedTrainStep` in
`veles_tpu/parallel/fused.py`, in its local, dp and gspmd modes:
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

Data parallelism (`mesh=`, mode "dp"; JAX fused.py:147-250, :417-580,
:809-1026). The JAX dp mode is one process over the local devices
(`shard_map` over the data axis); the port's is PyTorch's: ONE PROCESS
PER CARD, the mesh's process group the data axis (parallel/mesh.py,
parallel/distributed.py), every rank running this step on the global
batch. `train` takes the GLOBAL minibatch (N rows, the loader's), checks
that N divides the data axis (`_check_batch`) and keeps this rank's
rows, [d*N/D, (d+1)*N/D) for data shard d of D (`local_rows`), before
it uploads them: the loss is normalized by the GLOBAL weight sum
(`_global_wsum`, an all-reduce), so the ranks' gradients sum to the
global batch's mean gradient, and the loss and n_err come back summed
over the ranks. Dropout draws a stream per rank (`_shard_step_key`): rank
0 the registry's device stream, as the local step, every other rank a
generator of its own seeded from that stream and its rank at build, so
the ranks' masks are independent and one rank is the local step. The
update:

- replicated (ZeRO off): the gradients all-reduced (`_reduce_grads`),
  then the local update on the full leaves;
- ZeRO (`zero_sharding`, JAX :253-290, :942-1026): every rank owns a
  1/D slice of each flat, zero-padded leaf (mesh.zero_plan) and only
  that slice of its velocity or Adam moments; the flat gradient is
  reduce-scattered through the `grad_reduce` lowering (its f32, bf16,
  int8_block, int8_ef and hier2 points, ops/variants.py; int8_ef
  carries its residual in the state's "ef" slot), the `sgd_update`
  lowering (K1) updates the rank's slice with the leaf's own learning
  rate (its ORIGINAL rank decides the bias multiplier: ZeroLeaf.ndim),
  or Adam its slices, and an all-gather rebuilds every leaf. The pad's
  gradient is zero, so its velocity stays zero. The port does the true
  reduce-scatter; the JAX `GRAD_TRANSPOSE_PSUM` branch (:992, a
  jax-version workaround with the same numbers) has no counterpart.

`zero_sharding` "auto" (the default) shards the update wherever the data
axis has more than one rank, "off" keeps it replicated, and "on" shards
it at any size, one rank included (the JAX step degrades "on" to the
replicated update there; the port keeps the sharded path, so that one
card runs it). `write_back` all-gathers the velocities (a collective:
every rank calls it), `gather_state` / `shard_state` turn a ZeRO state
into the local layout and back (a checkpoint restores at another world
size), and `optimizer_state_bytes` / `collective_accounting` are the
JAX step's.

Expert parallelism (`ep=True`, mode "dp" only; JAX fused.py:212-236,
:695-708, :1087-1095): the expert leaves each forward unit declares in
`ep_params` (the MoE layer's w1, b1, w2, b2) are sharded on their leading
dim over the data axis, rank d holding experts [d*E/D, (d+1)*E/D) in its
state, parameters and velocities (or Adam moments) alike; the router and
every other leaf stay replicated. The forward hands the MoE units the
mesh (`FusedForward.ep_mesh`), which then exchange their slot buffers
with `all_to_all_single` (ops/moe.py `moe_forward_ep`); the expert
gradients arrive through the exchange's backward and are not
all-reduced, the replicated leaves' are, and K1 updates each rank's
expert slices. ZeRO is inactive under `ep`. `gather_state` /
`shard_state` / `write_back` all-gather and slice the expert leaves (a
checkpoint holds the gathered state, so it restores at another world
size), `optimizer_state_bytes` counts a rank's E/D experts, and
`collective_accounting` models the exchanges' bytes.

Tensor parallelism (mode "gspmd", the "auto" choice where the mesh has a
model axis above 1; JAX fused.py:181-190, :1229-1310): the JAX step hands
the partitioner its megatron plan; the port runs the same plan as an
explicit program, one process per rank (parallel/tp.py): each rank holds
its blocks of every leaf the plan shards (`_tp_plan`: column-parallel and
row-parallel weights alternating, the bias with a column shard; the
multi-matrix families, attention and MoE, on the last dim of every leaf
that divides; a leaf that does not divide replicated), in its
parameters and velocities (or Adam moments) alike, and its forward runs
each unit on them with the megatron collectives over its model group
(`Mesh.tp_groups`); the kernels run there as in the local step (K4 / K5
on the gathered channels of a sharded LRN, K6 / K7 on each rank's
heads, or on every head where the heads straddle the ranks, K1 on each
rank's blocks, one launch a leaf), where the JAX gspmd mode leaves
Pallas for XLA's lowerings (a `pallas_call` cannot be partitioned). The rows are the data axis's, as in dp; the metrics,
the weight sum and the gradients are summed over the rank's data group
only (a model group's ranks hold the same rows), and not at all at one
data shard, where the step is the local step's program. Dropout draws the
global batch's mask on every rank and keeps its block, so a gspmd step
at any mesh draws the local step's masks. ZeRO is inactive; `ep` is
refused, as in JAX. `gather_state` / `write_back` all-gather the blocks
over the model group, `shard_state` slices them (a checkpoint holds the
gathered state, so it restores at another model size or in local mode).
A MoE layer routes the global batch as one over the data shards, as
the JAX gspmd step does. At model 1 the plan replicates every leaf; at
model > 1 a parameterised unit without a rank program is refused. The
seq mode comes with the next slice.
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
from veles_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                           zero_ef_plan, zero_flatten,
                                           zero_plan, zero_unflatten)
from veles_tpu_torch.parallel.tp import (RankForward, leaf_full, leaf_part,
                                         tp_plan)

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
        #: the dp mesh whose ranks hold E/R experts each, handed to the
        #: units that declare `ep_params` (FusedTrainStep(ep=True) sets
        #: it); None runs every expert locally
        self.ep_mesh = None
        #: the tensor-parallel rank program (parallel/tp.py RankForward;
        #: FusedTrainStep(mode="gspmd") sets it through `set_tp`); None
        #: runs every unit on whole tensors
        self.tp = None
        self._build_plan()

    def set_tp(self, tp) -> None:
        """Run the chain as tensor-parallel rank `tp` (a RankForward):
        the plan is made again, since a column-parallel stem claims no
        LRN epilogue."""
        self.tp = tp
        self._build_plan()

    def _build_plan(self) -> None:
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
            if v is not None and (self.tp is None
                                  or self.tp.pair_allowed(i)):
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
        random numbers (dropout). Under tensor parallelism (`tp`) `params`
        are this rank's shards and each unit runs through `tp.run`; the
        output is whole on every rank."""
        mode = contextlib.nullcontext() if train else torch.inference_mode()
        with mode, full_f32(self.device):
            x = apply_input_normalize(self.input_normalize, x)
            if self._dtype is not None:
                # once per call; differentiable, so the gradients of the
                # f32 master leaves come back f32
                x = x.to(self._dtype)
                params = tuple({k: t.to(self._dtype) for k, t in p.items()}
                               for p in params)
            sharded = False
            for i, (kind, j, v) in enumerate(self._plan):
                u = self.forwards[i]
                if kind == "skip":
                    continue
                if kind == "pair":
                    def call(x, u=u, j=j, v=v, p=params[i]):
                        return self._apply_fused_pair(
                            v, u, self.forwards[j], p, x)
                else:
                    kw: Dict[str, Any] = {"train": train}
                    if v is not None:
                        kw["variant"] = v
                    if u.fused_needs_gen:
                        kw["gen"] = gen
                    if self.ep_mesh is not None \
                            and getattr(u, "ep_params", ()):
                        kw["ep_mesh"] = self.ep_mesh

                    def call(x, u=u, kw=kw, p=params[i], **extra):
                        return u.fused_apply(p, x, **kw, **extra)
                if self.tp is None:
                    x = call(x)
                else:
                    x, sharded = self.tp.run(
                        i, u, call, x, sharded,
                        draws=kind == "unit" and u.fused_needs_gen and train)
            if sharded:
                x = self.tp.whole(x)
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


def loss_metrics(loss_kind: str, out: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, wsum=None):
    """(loss, n_err) of one batch's output `out` (logits for the softmax
    head). The MSE: the per-sample summed squared error over the valid
    rows (denominator the weight sum, or `wsum`), n_err the loss itself.
    The softmax head: (weighted mean cross-entropy, misclassified valid
    labels): the pad mask's zero rows drop out of both, and of the
    gradient. The JAX step's rule (fused.py:781-801 there): the (N,)
    sample weights cover (N,) classifier labels, (N, S) per-token labels,
    or flat (N·S,) labels, each sample's weight repeated over its S
    consecutive tokens, and the denominator is the weight sum times the
    tokens per sample. `wsum` overrides that weight sum: gradient
    accumulation passes the full batch's, so the microbatches' losses and
    gradients sum to the full batch's mean."""
    if loss_kind == "mse":
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
                 input_normalize: Optional[Dict[str, Any]] = None,
                 mesh=None, mode: str = "auto",
                 zero_sharding: Any = "auto", ep: bool = False) -> None:
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
        self.mesh = mesh
        self.mode = self._resolve_mode(mode)
        #: expert parallelism over the data axis (checked now)
        self.ep = bool(ep)
        if self.ep:
            self._check_ep()
            self.fwd.ep_mesh = mesh
        if self.mode == "gspmd":
            # the rank's shards of the megatron plan (refuses a unit
            # without a rank program at model > 1)
            self.fwd.set_tp(RankForward(self.forwards, mesh))
        #: ZeRO update sharding, resolved now for every later reader
        #: (state layout, update, write_back, reports)
        self.zero_active, self.zero_reason = \
            self._resolve_zero(zero_sharding)
        self._zero_plan_cache = None
        self._gr_cache = None
        #: the dropout masks' source: the registry's device stream, which
        #: advances across steps and builds and rides in a snapshot (the
        #: JAX step draws a new key split, fused.py:470 there); a dp rank
        #: past the first its own (`_shard_step_key`)
        self.gen = self._shard_step_key()

    def fusion_pairs(self):
        return self.fwd.fusion_pairs()

    def _tp_plan(self):
        """(per-layer {param: spec}, per-layer output-sharded flags) of
        the megatron plan over the mesh's model axis (parallel/tp.py
        `tp_plan`, JAX fused.py:1253-1310): a spec is the axis name or
        None per dim, () for a replicated leaf, as the JAX
        PartitionSpec's tuple reads. Every leaf replicated outside
        gspmd."""
        if self.fwd.tp is not None:
            return self.fwd.tp.plan, list(self.fwd.tp.out_flags)
        return tp_plan(self.forwards, 1)

    # -- modes and the data axis (JAX fused.py:177-290) ----------------------

    def _resolve_mode(self, mode: str) -> str:
        """"auto": local without a mesh, seq / gspmd where the mesh has
        such an axis, else dp (the JAX rule). seq is refused until the
        slice that ports it; a dp or gspmd mesh must hold the step's
        device."""
        mesh = self.mesh
        if mode == "auto":
            if mesh is None:
                mode = "local"
            elif mesh.shape.get(SEQ_AXIS, 1) > 1:
                mode = "seq"
            elif mesh.shape.get(MODEL_AXIS, 1) > 1:
                mode = "gspmd"
            else:
                mode = "dp"
        if mode == "seq":
            raise NotImplementedError(
                "mode='seq': the sequence-parallel fused step (ring and "
                "Ulysses attention) comes with the next many-GPU slice "
                "(ROADMAP Queue 1 item 1(b)); this port trains in 'local', "
                "'dp' and 'gspmd' modes")
        if mode not in ("local", "dp", "gspmd"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode in ("dp", "gspmd"):
            if mesh is None:
                raise ValueError(f"mode={mode!r} requires a mesh")
            if torch.device(mesh.device) != self.device:
                raise ValueError(
                    f"the workflow lives on {self.device}, the mesh's "
                    f"rank on {mesh.device}: place the workflow on the "
                    f"rank's device")
        return mode

    @property
    def n_data(self) -> int:
        """Ranks along the data axis (1 in local mode)."""
        return (self.mesh.shape[DATA_AXIS] if self.mode in ("dp", "gspmd")
                else 1)

    @property
    def n_model(self) -> int:
        """Ranks along the model axis (1 but in gspmd mode)."""
        return self.mesh.shape[MODEL_AXIS] if self.mode == "gspmd" else 1

    @property
    def _sums_data(self) -> bool:
        """Whether the loss's weight sum, the metrics and the gradients
        are summed over the data axis: always in dp, in gspmd where it
        has more than one rank (one is the local step's own sums)."""
        return self.mode == "dp" or (self.mode == "gspmd"
                                     and self.n_data > 1)

    def _data_group(self):
        """The group of the ranks that hold other rows and the same
        shards: the mesh's in dp, the rank's data group in gspmd (a
        model group's ranks hold the same rows: summing over them would
        count each sample `model` times)."""
        return (self.mesh.tp_groups()[1] if self.mode == "gspmd"
                else self.mesh.group)

    def _resolve_zero(self, req: Any) -> Tuple[bool, str]:
        """The ZeRO verdict: (active, reason). "on"/True shards the dp
        update at any data-axis size, "auto" (the default) where it has
        more than one rank, "off"/False never; local mode never does."""
        if req in (False, "off"):
            return False, "zero-sharding disabled by request"
        if req not in (True, "on", "auto", None):
            raise ValueError(f"zero_sharding must be on/off/auto "
                             f"(got {req!r})")
        if self.mode != "dp":
            reason = (f"zero-sharding inactive: mode {self.mode!r} "
                      "(covered: the explicit shard_map 'dp' update; "
                      "gspmd relies on the partitioner, local has one "
                      "replica)")
        elif self.ep:
            reason = ("zero-sharding inactive: ep=True already shards "
                      "expert tensors over the data axis (the "
                      "composition is not covered by this build)")
        elif self.n_data < 2 and req not in (True, "on"):
            reason = ("zero-sharding inactive: data axis has a single "
                      "shard (nothing to shard the update over)")
        else:
            return True, "active"
        import logging
        log = logging.getLogger("veles_torch.fused")
        (log.warning if req in (True, "on") else log.debug)("%s", reason)
        return False, reason

    # -- expert parallelism (JAX fused.py:212-236, :1087-1095) ---------------

    def _check_ep(self) -> None:
        """The JAX step's refusals: ep needs the dp mode, a forward unit
        that declares `ep_params`, and an expert count the data axis
        divides."""
        if self.mode != "dp":
            raise ValueError(
                f"ep=True needs the explicit shard_map 'dp' mode "
                f"(got mode={self.mode!r}): expert tensors are sharded "
                "via per-param shard_map specs")
        n_data = self.n_data
        any_ep = False
        for u in self.forwards:
            for name in getattr(u, "ep_params", ()):
                any_ep = True
                t = u.param_arrays().get(name)
                e = t.shape[0] if t is not None else u.n_experts
                if e % n_data:
                    raise ValueError(
                        f"{type(u).__name__}: {e} experts not divisible by "
                        f"the data axis ({n_data})")
        if not any_ep:
            raise ValueError(
                "ep=True but no forward unit declares ep_params — the "
                "step would silently run plain DP")

    def ep_names(self, i: int) -> Tuple[str, ...]:
        """The expert leaves of forward unit i this step shards (none
        without `ep`)."""
        return tuple(getattr(self.forwards[i], "ep_params", ())) \
            if self.ep else ()

    def _ep_part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a full expert leaf (a view)."""
        e_loc = t.shape[0] // self.n_data
        d = self.mesh.data_index
        return t[d * e_loc:(d + 1) * e_loc]

    def _ep_full(self, part: torch.Tensor) -> torch.Tensor:
        """The full expert leaf whose leading-dim blocks the ranks hold."""
        import torch.distributed as dist
        full = part.new_empty((part.shape[0] * self.n_data,)
                              + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(full, part.detach().contiguous(),
                                    group=self.mesh.group)
        return full

    def _ep_map(self, state, leaf_fn) -> Dict[str, Any]:
        """`state` with `leaf_fn` applied to every expert leaf of the
        parameters and of the velocities or Adam moments."""
        return self._map_leaves(
            state, lambda i, k, t: leaf_fn(t) if k in self.ep_names(i)
            else t)

    def _tp_map(self, state, leaf_fn) -> Dict[str, Any]:
        """`state` with `leaf_fn(tensor, spec)` applied to every leaf the
        megatron plan shards."""
        plan = self.fwd.tp.plan
        return self._map_leaves(
            state, lambda i, k, t: leaf_fn(t, plan[i][k])
            if plan[i].get(k) else t)

    def _map_leaves(self, state, leaf_fn) -> Dict[str, Any]:
        """`state` with `leaf_fn(layer index, name, tensor)` applied to
        every leaf of the parameters and of the velocities or Adam
        moments."""
        params, vel = [], []
        for i, (p, v) in enumerate(zip(state["params"], state["vel"])):
            def conv(layer):
                return {k: leaf_fn(i, k, t) for k, t in layer.items()}
            params.append(conv(p))
            if optim.is_adam_state(v):
                vel.append({"m": conv(v["m"]), "v": conv(v["v"]),
                            "t": v["t"]})
            else:
                vel.append(conv(v))
        return {"params": tuple(params), "vel": tuple(vel),
                "lr_scale": state["lr_scale"]}

    def _shard_step_key(self) -> torch.Generator:
        """This rank's dropout stream: the registry's device stream for
        the local step, every gspmd rank and dp data shard 0; for dp shard
        d > 0 a generator of its own, seeded at build from a draw of the
        registry's stream (which every rank holds alike) plus d, so the
        shards' masks are independent of each other and a new build draws
        new ones (the JAX step folds the shard index into the step key,
        fused.py:825 there). A gspmd rank draws the global batch's masks
        and keeps its block (parallel/tp.py RankPart), as the JAX gspmd
        step partitions one mask (its key is not folded there)."""
        gen = prng.get().device_stream(self.device)
        if self.mode != "dp" or self.mesh.data_index == 0:
            return gen
        base = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=self.device))
        own = torch.Generator(device=self.device)
        own.manual_seed((base + self.mesh.data_index) % 2 ** 63)
        return own

    def zero_plans(self):
        """Per-layer {param: ZeroLeaf} plan over the data axis, from the
        units' shapes, cached (state, update, write_back and the
        accounting read the same plan)."""
        if self._zero_plan_cache is None:
            self._zero_plan_cache = tuple(
                zero_plan(u.param_arrays(), self.n_data)
                for u in self.forwards)
        return self._zero_plan_cache

    def _grad_reduce_variant(self):
        """The grad_reduce lowering this step runs, resolved once (the
        EF slot's geometry depends on it)."""
        if self._gr_cache is None:
            self._gr_cache = variants.resolve("grad_reduce")
        return self._gr_cache

    def ef_active(self) -> bool:
        """True when the update carries the error-feedback residual slot:
        ZeRO active and the selected grad_reduce point stateful."""
        return self.zero_active and bool(
            self._grad_reduce_variant().apply.gr_config["ef"])

    def ef_lens(self):
        """Per-layer {param: per-rank residual length} (mesh.zero_ef_plan
        under the selected point's rule). Call only when ef_active()."""
        name = self._grad_reduce_variant().name
        return tuple(
            zero_ef_plan(plan, lambda padded: variants.grad_reduce_resid_len(
                name, padded, self.n_data, self.mesh.n_hosts))
            for plan in self.zero_plans())

    def collective_accounting(self) -> Optional[Dict[str, Any]]:
        """Modeled per-rank bytes a train step's grad_reduce exchange (and
        the parameter all-gather) moves, under the selected point and the
        link geometry (variants.grad_reduce_bytes); under `ep`, the MoE
        exchanges' (`ep_accounting`); None otherwise."""
        if self.ep:
            return self.ep_accounting()
        if not self.zero_active:
            return None
        v = self._grad_reduce_variant()
        elems = sum(lp.padded for plan in self.zero_plans()
                    for lp in plan.values())
        acct = variants.grad_reduce_bytes(v.name, elems, self.n_data,
                                          self.mesh.n_hosts)
        acct.update(op="grad_reduce", variant=v.name, elements=elems,
                    n_shards=self.n_data)
        return acct

    def ep_accounting(self) -> Dict[str, Any]:
        """The expert exchanges of one train step on the loader's global
        minibatch: per MoE layer two all-to-alls forward and their two
        transposes backward, each sending this rank's (E, C, D) slot
        buffer, C the capacity of its rows' tokens, of which (D-1)/D
        leaves the rank. Bytes at the compute dtype's item size (modeled:
        the buffer takes the dtype its input promotes to)."""
        n = self.n_data
        rows = self.fwd.workflow.loader.minibatch_size // n
        item = 4 if self.compute_dtype in (None, "float32") else 2
        layers = []
        for u in self.forwards:
            if not getattr(u, "ep_params", ()):
                continue
            tokens = rows * u.input_tokens_per_sample()
            e, d = u.wr.shape[1], u.wr.shape[0]
            elems = e * u.capacity(tokens) * d
            layers.append({"tokens": tokens, "capacity": u.capacity(tokens),
                           "elements": elems})
        per = sum(lay["elements"] for lay in layers)
        return {"op": "moe_all_to_all", "n_shards": n,
                "exchanges": 4 * len(layers), "layers": layers,
                "elements": 4 * per,
                "egress_bytes": int(4 * per * item * (n - 1) / n)}

    def optimizer_state_bytes(self, state) -> Dict[str, int]:
        """{device: bytes} the optimizer state (velocities, Adam moments
        and steps) holds on this rank: the measured form of the ZeRO
        memory claim (parallel/memstats.bytes_per_device)."""
        from torch.utils._pytree import tree_leaves

        from veles_tpu_torch.parallel.memstats import bytes_per_device
        return bytes_per_device(tree_leaves(state["vel"]))

    def local_rows(self, n: int) -> np.ndarray:
        """Boolean (n,) mask of the GLOBAL batch rows this rank trains on:
        its data shard's block; all rows in local mode and where the data
        axis does not divide n (JAX fused.py:538-569)."""
        mask = np.ones(n, bool)
        if self.n_data > 1 and n % self.n_data == 0:
            block = n // self.n_data
            mask[:] = False
            d = self.mesh.data_index
            mask[d * block:(d + 1) * block] = True
        return mask

    def _check_batch(self, n: int) -> None:
        """The fed batch must divide the data axis."""
        if self.mode in ("dp", "gspmd") and n % self.n_data:
            raise ValueError(
                f"batch of {n} not divisible by the mesh data axis "
                f"({self.n_data} shards)")

    def _rows(self, x, y, w, k: int = 1):
        """This rank's rows of a global batch (host arrays are sliced
        before they are uploaded); `k` microbatches each give the rank
        its block, as the JAX step shards each microbatch. Identity in
        local mode and at one data shard."""
        if self.mode not in ("dp", "gspmd"):
            return x, y, w
        n = int(np.shape(x)[0])
        self._check_batch(n // k)
        if self.n_data == 1:
            return x, y, w
        d = self.mesh.data_index
        m = n // k                  # a microbatch's rows
        b = m // self.n_data        # this rank's rows of each

        def take(a):
            if a is None:
                return None
            per = int(np.shape(a)[0]) // n   # flat per-token labels: S
            if k == 1:
                return a[d * b * per:(d + 1) * b * per]
            tail = tuple(np.shape(a)[1:])
            return a.reshape((k, m * per) + tail)[
                :, d * b * per:(d + 1) * b * per].reshape(
                    (k * b * per,) + tail)
        return take(x), take(y), take(w)

    def _global_wsum(self, w: torch.Tensor) -> torch.Tensor:
        """The global weight sum (an all-reduce of the data shards' sums
        in dp and gspmd; the local sum otherwise)."""
        s = w.sum()
        if self._sums_data:
            import torch.distributed as dist
            dist.all_reduce(s, group=self._data_group())
        return s

    def _psum(self, *ts) -> None:
        """Each of `ts` summed over the data shards, in place (dp and
        gspmd; nothing otherwise)."""
        if self._sums_data:
            import torch.distributed as dist
            for t in ts:
                dist.all_reduce(t, group=self._data_group())

    # -- state <-> units ------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """A copy of the units' parameters as trainable leaves; for an SGD
        layer the velocities its gradient twin holds (zeros where it holds
        none), for an Adam layer zero moments and `t` = 0 (the twin holds
        no moments: a snapshot resume restarts them, as in the JAX
        package). Under ZeRO each velocity and moment is this rank's flat
        slice of its zero-padded leaf (JAX fused.py:417-484), and a
        stateful grad_reduce point adds the zero residuals ("ef")."""
        params = tuple(
            {k: self._part(i, k, t.detach()).clone().requires_grad_(True)
             for k, t in u.param_arrays().items()}
            for i, u in enumerate(self.forwards))
        plans = (self.zero_plans() if self.zero_active
                 else (None,) * len(params))
        vel = []
        for i, (g, p, cfg, plan) in enumerate(zip(self.gd_units, params,
                                                  self.cfgs, plans)):
            if isinstance(cfg, optim.AdamConfig):
                st = optim.adam_init(p, self.device)
                if plan is not None:
                    for slot in ("m", "v"):
                        st[slot] = {k: torch.zeros(plan[k].local,
                                                   device=self.device)
                                    for k in p}
                vel.append(st)
                continue
            layer = {}
            for k, t in p.items():
                seed = g.velocity(k)
                if plan is not None:
                    flat = torch.zeros(plan[k].padded, device=self.device)
                    if seed is not None:
                        flat[:plan[k].size] = seed.detach().reshape(-1)
                    layer[k] = self._my_slice(flat, plan[k]).clone()
                else:
                    if seed is not None:
                        seed = self._part(i, k, seed)
                    layer[k] = (seed.detach().to(self.device, copy=True)
                                if seed is not None
                                else torch.zeros_like(t,
                                                      requires_grad=False))
            vel.append(layer)
        state = {"params": params, "vel": tuple(vel), "lr_scale": 1.0}
        if self.ef_active():
            state["ef"] = tuple(
                {k: torch.zeros(n, device=self.device)
                 for k, n in lens.items()} for lens in self.ef_lens())
        return state

    def _part(self, i: int, k: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf `k` of forward unit i (a view): its
        experts under `ep`, its block of the megatron plan in gspmd, else
        the leaf itself."""
        if k in self.ep_names(i):
            return self._ep_part(t)
        if self.fwd.tp is not None:
            tp = self.fwd.tp
            return leaf_part(t, tp.plan[i][k], tp.index, tp.m)
        return t

    def _my_slice(self, flat: torch.Tensor, lp) -> torch.Tensor:
        """This rank's [d*local, (d+1)*local) slice of a flat vector."""
        d = self.mesh.data_index
        return flat[d * lp.local:(d + 1) * lp.local]

    def _all_gather(self, part: torch.Tensor, lp) -> torch.Tensor:
        """The (padded,) flat vector whose slices the ranks hold."""
        import torch.distributed as dist
        full = part.new_empty(lp.padded)
        dist.all_gather_into_tensor(full, part.contiguous(),
                                    group=self.mesh.group)
        return full

    @torch.no_grad()
    def gather_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A ZeRO state in the local layout: every velocity and moment
        all-gathered to its leaf's shape (a collective: every rank calls
        it), the EF residuals dropped (a restore at another world size
        restarts them at zero, as the JAX checkpoint does). Under `ep` the
        expert leaves of the parameters and velocities (moments) are
        all-gathered, in gspmd every leaf the megatron plan shards (over
        the model group). Any other state is returned as it is."""
        if self.ep:
            return self._ep_map(state, self._ep_full)
        if self.n_model > 1:
            tp = self.fwd.tp
            return self._tp_map(state, lambda t, spec: leaf_full(
                t, spec, tp.group, tp.m))
        if not self.zero_active:
            return state
        vel = []
        for layer, plan in zip(state["vel"], self.zero_plans()):
            def full(t, lp):
                return zero_unflatten(self._all_gather(t, lp), lp).clone()
            if optim.is_adam_state(layer):
                vel.append({"m": {k: full(t, plan[k])
                                  for k, t in layer["m"].items()},
                            "v": {k: full(t, plan[k])
                                  for k, t in layer["v"].items()},
                            "t": layer["t"]})
            else:
                vel.append({k: full(t, plan[k]) for k, t in layer.items()})
        return {"params": state["params"], "vel": tuple(vel),
                "lr_scale": state["lr_scale"]}

    @torch.no_grad()
    def shard_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """`gather_state`'s inverse: a local-layout state with this rank's
        ZeRO slices (zero residuals where the point is stateful), its
        experts under `ep`, or its blocks of the megatron plan in
        gspmd."""
        if self.ep or self.n_model > 1:
            def part(i, k, t):
                mine = self._part(i, k, t)
                return t if mine is t else mine.clone()
            out = self._map_leaves(state, part)
            out["params"] = tuple(
                {k: t.detach().requires_grad_(True) for k, t in p.items()}
                for p in out["params"])
            return out
        if not self.zero_active:
            return state
        vel = []
        for layer, plan in zip(state["vel"], self.zero_plans()):
            def part(t, lp):
                return self._my_slice(zero_flatten(t.detach(), lp),
                                      lp).clone()
            if optim.is_adam_state(layer):
                vel.append({"m": {k: part(t, plan[k])
                                  for k, t in layer["m"].items()},
                            "v": {k: part(t, plan[k])
                                  for k, t in layer["v"].items()},
                            "t": layer["t"]})
            else:
                vel.append({k: part(t, plan[k]) for k, t in layer.items()})
        out = {"params": state["params"], "vel": tuple(vel),
               "lr_scale": state["lr_scale"]}
        if self.ef_active():
            out["ef"] = tuple(
                {k: torch.zeros(n, device=self.device)
                 for k, n in lens.items()} for lens in self.ef_lens())
        return out

    @torch.no_grad()
    def write_back(self, state: Dict[str, Any]) -> None:
        """Copy the state's parameters into the units, and an SGD layer's
        velocities into its gradient twin (an Adam layer's moments stay in
        the state). Under ZeRO the velocities are all-gathered first: a
        collective, which every rank calls."""
        state = self.gather_state(state)
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
        """(loss, n_err) of one batch (`loss_metrics`)."""
        return loss_metrics(self.loss_kind, out, y, w, wsum)

    def _grads(self, state, x, y, w, wsum=None):
        """(gradients, one tuple per layer aligned with state["params"],
        loss, n_err) of one batch already on the device; the autograd
        graph is freed before this returns."""
        leaves = [t for layer in state["params"] for t in layer.values()]
        if wsum is None and self._sums_data:
            wsum = self._global_wsum(w)
        with torch.enable_grad(), full_f32(self.device):
            out = self.fwd._forward(state["params"], x, train=True,
                                    gen=self.gen)
            loss, n_err = self._loss_metrics(out, y, w, wsum)
            flat = iter(torch.autograd.grad(loss, leaves))
        grads = tuple({k: next(flat) for k in p} for p in state["params"])
        return grads, loss.detach(), n_err

    @torch.no_grad()
    def _reduce_grads(self, grads):
        """The replicated dp update's gradient all-reduce (JAX fused.py:865;
        the global-mean normalization is in the ranks' partials already):
        one all-reduce per leaf but the expert leaves under `ep`; in gspmd
        over the rank's data group, a sharded leaf's gradient being whole
        for its block on each rank of a model group. Identity in local
        mode, at one gspmd data shard and under ZeRO, whose
        reduce-scatter is the reduction."""
        if not self._sums_data or self.zero_active:
            return grads
        import torch.distributed as dist
        out = []
        for i, layer in enumerate(grads):
            # a collective takes contiguous tensors; autograd may return a
            # gradient in its input's layout (a convolution's channels-last
            # weight gradient)
            layer = {k: t.contiguous() for k, t in layer.items()}
            experts = self.ep_names(i)
            for k, t in layer.items():
                # an expert leaf's gradient came through the exchange's
                # backward: it is this rank's experts' already
                if k not in experts:
                    dist.all_reduce(t, group=self._data_group())
            out.append(layer)
        return tuple(out)

    @torch.no_grad()
    def _apply_update_zero(self, state, grads) -> None:
        """The ZeRO update (JAX fused.py:942-1026): per leaf, the flat
        padded gradient reduce-scattered through the grad_reduce lowering
        (threading the EF residual where the point is stateful), this
        rank's slice of the leaf updated over its slice of the state (the
        `sgd_update` lowering, K1, with the leaf's own learning rate, or
        Adam), and the slices all-gathered into the leaf."""
        reduce = self._grad_reduce_variant().apply
        ef_state = state.get("ef") if self.ef_active() else None
        scale = state["lr_scale"]
        for li, (p, g, v, cfg, plan) in enumerate(
                zip(state["params"], grads, state["vel"], self.cfgs,
                    self.zero_plans())):
            if not p:
                continue
            adam = isinstance(cfg, optim.AdamConfig)
            if adam:
                v["t"].add_(1)
                b1t, b2t = optim.adam_step_factors(cfg, v["t"])
            for k in p:
                lp = plan[k]
                flat_g = zero_flatten(g[k], lp)
                if ef_state is not None:
                    g_loc, resid = reduce(flat_g, self.mesh,
                                          ef_state[li][k])
                    ef_state[li][k].copy_(resid)
                else:
                    g_loc = reduce(flat_g, self.mesh)
                p_loc = self._my_slice(zero_flatten(p[k].detach(), lp),
                                       lp).clone()
                if adam:
                    new_p, m, vv = optim.adam_leaf(
                        p_loc, g_loc, v["m"][k], v["v"][k], cfg, b1t, b2t,
                        cfg.lr * scale)
                    v["m"][k].copy_(m)
                    v["v"][k].copy_(vv)
                    p_loc = new_p
                else:
                    # the leaf's own lr (its original rank decides the
                    # bias multiplier), through the registry's lowering
                    lr = optim.sgd_leaf_lr(cfg, lp.ndim, lr_scale=scale)
                    self._sgd.apply({k: p_loc}, {k: g_loc}, {k: v[k]},
                                    cfg._replace(lr=lr, lr_bias_mult=1.0),
                                    lr_scale=1.0)
                p[k].copy_(zero_unflatten(self._all_gather(p_loc, lp), lp))

    @torch.no_grad()
    def _apply_update(self, state, grads) -> None:
        """One update of every layer in place: Adam where the layer's
        config is Adam, the `sgd_update` lowering (K1) elsewhere; under
        ZeRO the sharded update."""
        if self.zero_active:
            self._apply_update_zero(state, grads)
            return
        grads = self._reduce_grads(grads)
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
        return self._train_rows(state, *self._batch(*self._rows(x, y, w)))

    def _train_rows(self, state, x, y, w):
        """One step on this rank's rows, already on the device."""
        grads, loss, n_err = self._grads(state, x, y, w)
        self._apply_update(state, grads)
        self._psum(loss, n_err)
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
        x, y, w = self._batch(*self._rows(x, y, w, k))
        m = m // self.n_data
        wsum = self._global_wsum(w)
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
        self._psum(loss, n_err)
        return state, (loss, n_err)

    def train_repeat(self, state, x, y, k: int, w=None):
        """k updates on ONE minibatch, uploaded once and kept on the
        device (the JAX package's benchmark loop, fused.py:1476-1524
        there). Returns `(state, (losses, n_errs))` with a leading
        dimension of k, tensors on the device (no host sync)."""
        x, y, w = self._batch(*self._rows(x, y, w))
        losses, errs = [], []
        for _ in range(k):
            state, (loss, n_err) = self._train_rows(state, x, y, w)
            losses.append(loss)
            errs.append(n_err)
        return state, (torch.stack(losses), torch.stack(errs))

    def train_many(self, state, xs, ys, ws=None):
        """len(xs) training steps over stacked minibatches: xs (K, N,
        ...), ys (K, N, ...), ws (K, N) or None, uploaded once
        (fused.py:1582-1632 in the JAX package). Returns `(state,
        (losses, n_errs))` with a leading dimension of K, tensors on the
        device (no host sync)."""
        self._check_batch(int(np.shape(xs)[1]))
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
        """Forward-only `(loss, n_err)` of a validation/test minibatch (in
        dp, of the global batch: the ranks' sums)."""
        x, y, w = self._batch(*self._rows(x, y, w))
        wsum = self._global_wsum(w) if self._sums_data else None
        with torch.inference_mode():
            out = self.fwd._forward(state["params"], x)
            loss, n_err = self._loss_metrics(out, y, w, wsum)
        if self._sums_data:
            loss, n_err = loss.clone(), n_err.clone()
            self._psum(loss, n_err)
        return loss, n_err

    def confusion(self, state, x, y, n_classes: int, w=None):
        """(C, C) int64 confusion counts, true class by row and predicted
        by column, of one minibatch's rows of weight > 0 (the pad mask),
        from a forward-only pass on the device (no host sync): the fused
        loop's companion of the granular evaluator's matrix (JAX
        fused.py:1363). None for a head that is not one label per sample
        (the MSE, a per-token head)."""
        if self.loss_kind != "softmax":
            return None
        x, y, w = self._batch(*self._rows(x, y, w))
        if y.numel() != x.shape[0]:
            return None
        with torch.inference_mode():
            out = self.fwd._forward(state["params"], x)
            if out.dim() != 2:
                return None
            m = fn.confusion(y, out.argmax(dim=-1), n_classes, w)
        if self._sums_data:
            m = m.clone()
            self._psum(m)
        return m

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this step runs: the forward's, and the SGD
        update's where at least one layer updates with SGD (the JAX
        step's rule, fused.py:1460-1465 there)."""
        table = self.fwd.variant_table()
        if any(isinstance(c, optim.SGDConfig) for c in self.cfgs):
            table["sgd_update"] = self._sgd.name
        if self.zero_active:
            # the ZeRO reduce-scatter's lowering (JAX fused.py:1450-1459)
            table["grad_reduce"] = self._grad_reduce_variant().name
        return table
