"""Tensor parallelism of the fused step (mode "gspmd"): the JAX package's
megatron column/row plan, run as an explicit program of one process per
rank.

The JAX gspmd mode (veles_tpu/parallel/fused.py:1229-1310 there) annotates
the parameters with `_tp_plan`'s PartitionSpecs and lets XLA's partitioner
place the collectives. The port has no partitioner: each rank holds its
shards of the same plan (`tp_plan`, rule for rule the JAX function) and
`RankForward` runs each unit on them with the collectives placed by hand
over the rank's model group (`Mesh.tp_groups`):

- column-parallel (the output dim of a 2-D (in, out) or 4-D HWIO weight
  sharded, and the bias with it): the unit's own forward on the rank's
  output columns; a replicated input passes megatron's *f* (`_CopyIn`:
  identity forward, all-reduce backward), a channel-sharded one is
  all-gathered first (`_Gather` with `partial`: the backward
  reduce-scatters the ranks' partial gradients);
- row-parallel (the contraction dim sharded): the rank's partial product
  without the bias, summed by megatron's *g* (`_ReduceOut`: all-reduce
  forward, identity backward), then the bias and the activation (the
  units' `reduce=`). An FC layer whose channel-sharded input is an image
  (a flatten: the rank's channel slice is a strided set of the flattened
  rows, the JAX shard a contiguous block) all-gathers the channels,
  flattens and keeps its row block;
- a unit the plan leaves replicated: its forward on the whole input (a
  sharded one all-gathered, `_Gather` without `partial`: the backward
  keeps the rank's slice of the replicas' equal gradients);
- a unit without parameters (the plan's incoming flag): a per-channel one
  (`tp_channel_local`: activations, dropout, the pooling flavors) runs on
  the rank's channels; any other (the LRN, a fused LRN -> max pooling
  pair, InputNormalize) all-gathers the channels, runs on all of them
  (K4 / K5, K2 / K3 under `composed`) and keeps the rank's slice, the
  gather's backward reduce-scattering;
- a draw (dropout's mask, stochastic pooling's noise) is made for the
  global batch and the unsharded features from the registry stream,
  which every rank holds alike, and the rank takes its (rows, channels)
  block (`RankPart`): one mask per model group, and a gspmd step at any
  mesh draws the local step's masks.

The activation the plan marks sharded is the rank's 1/model block of the
last dim (channels of NHWC, features of an FC output). An auto stem's
`epi=lrn` pair is not claimed under a column-parallel stem (its LRN needs
every channel of the convolution): the stem runs its `epi=none` twin, the
LRN after it gathers (the fused step's `variant_table` says so).
Parameterised units other than the convolutions and the All2All family
(attention, the transformer blocks, MoE: the JAX last-dim rule, fused.py:
1299-1306 there) are refused at model > 1: they come with ROADMAP Queue 1
item 1(a2). At model 1 every leaf is replicated and any workflow runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from veles_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

#: a leaf's plan: () replicated, else one axis name or None per dim
Spec = Tuple[Optional[str], ...]


def _covered(u) -> bool:
    """The unit families the plan shards: the convolutions and the
    All2All family (the softmax head included)."""
    from veles_tpu_torch.znicz.all2all import All2All
    from veles_tpu_torch.znicz.conv import Conv
    return isinstance(u, (Conv, All2All))


def tp_plan(forwards: Sequence[Any], m: int
            ) -> Tuple[Tuple[Dict[str, Spec], ...], List[bool]]:
    """(per-layer {param: spec}, per-layer "output feature-sharded"
    flags) of the megatron plan over a model axis of `m` ranks, from the
    units' shapes (JAX `_tp_plan`, veles_tpu/parallel/fused.py:1253-1310):
    a 2-D (in, out) or 4-D HWIO weight is row-parallel where its input
    arrives sharded and its contraction dim divides, else
    column-parallel where its output dim divides (the bias with it where
    it divides), else replicated; a unit without parameters keeps the
    incoming flag; a leaf that does not divide stays replicated. Raises
    NotImplementedError at m > 1 for a parameterised unit of another
    family."""
    plan: List[Dict[str, Spec]] = []
    out_flags: List[bool] = []
    act_sh = False
    for u in forwards:
        arrs = {k: a for k, a in u.param_arrays().items() if a is not None}
        pd: Dict[str, Spec] = {k: () for k in u.param_arrays()}
        if m == 1:
            plan.append(pd)
            out_flags.append(False)
            continue
        if arrs and not _covered(u):
            raise NotImplementedError(
                f"{type(u).__name__} under tensor parallelism (model={m}): "
                "the gspmd step shards the convolutions and the All2All "
                "family; attention, the transformer blocks and MoE (the "
                "JAX last-dim rule) come with ROADMAP Queue 1 item 1(a2)")
        out_sh = act_sh if not arrs else False
        w = arrs.get("weights")
        if w is not None and w.dim() in (2, 4):
            in_ax = 0 if w.dim() == 2 else 2
            out_ax = w.dim() - 1
            if act_sh and w.shape[in_ax] % m == 0:
                pd["weights"] = tuple(MODEL_AXIS if d == in_ax else None
                                      for d in range(w.dim()))
                out_sh = False
            elif w.shape[out_ax] % m == 0:
                pd["weights"] = tuple(MODEL_AXIS if d == out_ax else None
                                      for d in range(w.dim()))
                b = arrs.get("bias")
                if b is not None and b.dim() == 1 and not b.shape[0] % m:
                    pd["bias"] = (MODEL_AXIS,)
                out_sh = True
            else:
                out_sh = False
        plan.append(pd)
        out_flags.append(out_sh)
        act_sh = out_sh
    return tuple(plan), out_flags


def shard_dim(spec: Spec) -> Optional[int]:
    """The dim `spec` shards over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def leaf_part(t: torch.Tensor, spec: Spec, index: int, m: int
              ) -> torch.Tensor:
    """Rank `index`'s block of a full leaf (a view; the leaf itself where
    `spec` replicates it)."""
    d = shard_dim(spec)
    if d is None:
        return t
    size = t.shape[d] // m
    return t.narrow(d, index * size, size)


def leaf_full(part: torch.Tensor, spec: Spec, group, m: int
              ) -> torch.Tensor:
    """The full leaf whose blocks the model group's ranks hold (an
    all-gather along the sharded dim: every rank of the group calls
    it); `part` itself where `spec` replicates the leaf."""
    d = shard_dim(spec)
    if d is None:
        return part
    return _all_gather(part.detach(), group, m, d)


# -- collectives along a dim ------------------------------------------------


def _all_gather(x: torch.Tensor, group, m: int, dim: int = -1
                ) -> torch.Tensor:
    """The ranks' blocks of `x` concatenated along `dim`, in rank order
    (contiguous)."""
    import torch.distributed as dist
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(m)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, group, m: int, dim: int = -1
                    ) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the ranks' `g`."""
    import torch.distributed as dist
    inp = g.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // m,) + tuple(inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' `t`, in a new tensor."""
    import torch.distributed as dist
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced over the
    model group (the ranks' column shards each give a partial one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: the row shards' partial products all-reduced,
    identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        return _all_reduce(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' channel blocks all-gathered along the last dim. Its
    backward: where the consumer's gradient is partial (a column shard,
    or a slice taken after the consumer), the ranks' gradients
    reduce-scattered; where the consumer is replicated (every rank
    computes the same), this rank's slice of the equal gradients."""

    @staticmethod
    def forward(ctx, x, group, m, index, partial):
        ctx.group, ctx.m, ctx.index, ctx.partial = group, m, index, partial
        ctx.width = x.shape[-1]
        return _all_gather(x, group, m)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.group, ctx.m), None, None, None, \
                None
        return g.narrow(-1, ctx.index * ctx.width, ctx.width), None, None, \
            None, None


class RankPart:
    """This rank's block of a draw made for the global batch and the
    unsharded features: rows [row0, row0 + rows) of `n_rows`, and where
    the activation is channel-sharded, `channels` = (n_ch, ch0, ch):
    channels [ch0, ch0 + ch) of n_ch. A unit that draws
    (`fused_needs_gen`) takes it as `part=`: it draws at `global_shape`
    and keeps `take`."""

    def __init__(self, n_rows: int, row0: int, rows: int,
                 channels: Optional[Tuple[int, int, int]] = None) -> None:
        self.n_rows, self.row0, self.rows = n_rows, row0, rows
        self.channels = channels

    def global_shape(self, shape, ch_axis: int = -1) -> Tuple[int, ...]:
        out = list(shape)
        out[0] = self.n_rows
        if self.channels is not None:
            out[ch_axis] = self.channels[0]
        return tuple(out)

    def take(self, t: torch.Tensor, ch_axis: int = -1) -> torch.Tensor:
        t = t.narrow(0, self.row0, self.rows)
        if self.channels is not None:
            t = t.narrow(ch_axis, self.channels[1], self.channels[2])
        return t


class RankForward:
    """The rank's program of the plan: which role each forward unit
    plays, and how it runs on the rank's shards (`run`). `mesh` gives
    the model group and this rank's data and model indices."""

    def __init__(self, forwards: Sequence[Any], mesh) -> None:
        self.forwards = list(forwards)
        self.m = mesh.shape[MODEL_AXIS]
        self.n_data = mesh.shape[DATA_AXIS]
        self.index = mesh.model_index
        self.data_index = mesh.data_index
        self.plan, self.out_flags = tp_plan(self.forwards, self.m)
        self._mesh = mesh
        #: per unit: "column", "row", "replicated" or "free"
        self.roles = []
        for u, pd in zip(self.forwards, self.plan):
            w = pd.get("weights", ())
            if not u.param_arrays():
                role = "free"
            elif shard_dim(w) is None:
                role = "replicated"
            elif shard_dim(w) == len(w) - 1:
                role = "column"
            else:
                role = "row"
            if role == "column" and len(getattr(
                    u, "output_sample_shape", ())) > 1:
                raise NotImplementedError(
                    f"{u.name}: a column-parallel FC layer of output "
                    f"shape {u.output_sample_shape} (its shard of the "
                    "flat outputs is no block of the last dim)")
            self.roles.append(role)

    @property
    def group(self):
        """The model group (made at the first collective, on every rank
        at the same point of the same program)."""
        return self._mesh.tp_groups()[0]

    def pair_allowed(self, i: int) -> bool:
        """Whether unit i may lead a fused pair: an auto stem's `epi=lrn`
        pair needs every output channel of its convolution, so not under
        a column-parallel stem."""
        return self.roles[i] != "column"

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """A channel-sharded output made whole for a replicated consumer
        (the loss)."""
        return self._gather(x, False)

    def part(self, x: torch.Tensor, sharded: bool) -> Optional[RankPart]:
        """This rank's block of the global draws for activation `x`; None
        where it is the whole (one data shard, not sharded)."""
        if self.n_data == 1 and not sharded:
            return None
        rows = x.shape[0]
        ch = None
        if sharded:
            c = x.shape[-1]
            ch = (c * self.m, self.index * c, c)
        return RankPart(rows * self.n_data, self.data_index * rows, rows, ch)

    def _gather(self, x, partial: bool):
        return _Gather.apply(x, self.group, self.m, self.index, partial)

    def _slice(self, y: torch.Tensor) -> torch.Tensor:
        c = y.shape[-1] // self.m
        return y.narrow(-1, self.index * c, c)

    def run(self, i: int, u, call, x: torch.Tensor, sharded: bool,
            draws: bool) -> Tuple[torch.Tensor, bool]:
        """Unit i (or the pair it leads) on the rank's shards: `call(x,
        **extra)` runs it; returns (its output, whether that output is
        channel-sharded). `draws`: the unit takes `part=`."""
        role = self.roles[i]
        extra: Dict[str, Any] = {}
        if role == "column":
            x = self._gather(x, True) if sharded else \
                _CopyIn.apply(x, self.group)
            return call(x), True
        if role == "row":
            if not sharded:
                raise RuntimeError(f"{u.name}: a row-parallel unit fed a "
                                   "replicated activation")
            if x.dim() > 2 and u.param_arrays()["weights"].dim() == 2:
                # a flatten into the FC layer: the JAX shard is a block
                # of the flattened rows, not the rank's channel slice
                full = self._gather(x, True).reshape(x.shape[0], -1)
                rows = full.shape[1] // self.m
                x = full.narrow(1, self.index * rows, rows)
            return call(x, reduce=lambda y: _ReduceOut.apply(
                y, self.group)), False
        if role == "replicated":
            if sharded:
                x = self._gather(x, False)
            if draws:
                extra["part"] = self.part(x, False)
            return call(x, **extra), False
        # a unit without parameters
        if not sharded:
            if draws:
                extra["part"] = self.part(x, False)
            return call(x, **extra), False
        if getattr(u, "tp_channel_local", False):
            if draws:
                extra["part"] = self.part(x, True)
            return call(x, **extra), True
        full = self._gather(x, True)
        if draws:
            extra["part"] = self.part(full, False)
        y = call(full, **extra)
        if y.shape[-1] != full.shape[-1]:
            raise NotImplementedError(
                f"{u.name}: a unit without parameters that changes the "
                "channel count, on a channel-sharded activation")
        return self._slice(y), True
