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
last dim (channels of NHWC, features of an FC output or of a sequence
layer's (N, S, E) output). An auto stem's `epi=lrn` pair is not claimed
under a column-parallel stem (its LRN needs every channel of the
convolution): the stem runs its `epi=none` twin, the LRN after it
gathers (the fused step's `variant_table` says so).

The multi-matrix families (attention, MoE) take the JAX plan's last-dim
rule (fused.py:1299-1306 there): every leaf of two or more dims whose
last dim divides is sharded on it, and the output is feature-sharded
where one such leaf's last dim is the output's. The sequence layers
(SeqLinear, SeqFFN, SeqSoftmax: one 2-D `weights`) take the column/row
branch, their other leaves (`pos`, `w2`, `b2`) replicated. These units
run their own rank programs (`tp_program`: `fused_apply(..., tp=)` with
a `UnitRank`), in roles "column", "row", "lastdim" and "replicated":
position-wise, so a row-parallel one contracts the rank's feature rows
of an (N, S, E) input without any flatten, and a replicated leaf of
which the rank uses a block (`pos` beside a column-parallel SeqLinear,
`w2` and `b2` of a column-parallel SeqFFN, a leaf of attention or MoE
the rule leaves whole) passes megatron's *f*, so that its gradient is
all-reduced over the model group and every rank updates it alike. A
parameterised unit of another family (no rank program) is refused at
model > 1. At model 1 every leaf is replicated and any workflow runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from veles_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

#: a leaf's plan: () replicated, else one axis name or None per dim
Spec = Tuple[Optional[str], ...]


def _has_rank_program(u) -> bool:
    """Whether the rank program covers a parameterised unit: the
    convolutions and the All2All family through the generic column and
    row roles, the units that declare `tp_program` through their own."""
    from veles_tpu_torch.znicz.all2all import All2All
    from veles_tpu_torch.znicz.conv import Conv
    return isinstance(u, (Conv, All2All)) or getattr(u, "tp_program",
                                                     False)


def tp_plan(forwards: Sequence[Any], m: int
            ) -> Tuple[Tuple[Dict[str, Spec], ...], List[bool]]:
    """(per-layer {param: spec}, per-layer "output feature-sharded"
    flags) of the megatron plan over a model axis of `m` ranks, from the
    units' shapes (JAX `_tp_plan`, veles_tpu/parallel/fused.py:1253-1310):
    a 2-D (in, out) or 4-D HWIO `weights` is row-parallel where its
    input arrives sharded and its contraction dim divides, else
    column-parallel where its output dim divides (the bias with it where
    it divides), else replicated, the unit's other leaves replicated; a
    unit without such a weight (attention, MoE) shards every leaf of two
    or more dims on its last dim where that divides, its output sharded
    where one such leaf's last dim is the output's (`out_sample_shape`);
    a unit without parameters keeps the incoming flag; a leaf that does
    not divide stays replicated."""
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
        elif arrs:
            shape = getattr(u, "out_sample_shape", None)
            out_dim = shape[-1] if shape else None
            for k, a in arrs.items():
                if a.dim() >= 2 and a.shape[-1] % m == 0:
                    pd[k] = (None,) * (a.dim() - 1) + (MODEL_AXIS,)
                    if out_dim is not None and a.shape[-1] == out_dim:
                        out_sh = True
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


class _ScatterOut(torch.autograd.Function):
    """The ranks' partial products summed and scattered along the last
    dim, this rank keeping its block (a row-parallel product whose
    output stays feature-sharded); the backward all-gathers the blocks'
    gradients."""

    @staticmethod
    def forward(ctx, y, group, m):
        ctx.group, ctx.m = group, m
        return _reduce_scatter(y, group, m)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.m), None, None


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
        #: per unit: "column", "row", "lastdim", "replicated" or "free"
        self.roles = []
        for u, pd in zip(self.forwards, self.plan):
            w = pd.get("weights", ())
            own = getattr(u, "tp_program", False)
            if not u.param_arrays():
                role = "free"
            elif self.m > 1 and not _has_rank_program(u):
                raise NotImplementedError(
                    f"{u.name} ({type(u).__name__}) under tensor "
                    f"parallelism (model={self.m}): the unit has no rank "
                    "program")
            elif all(shard_dim(s) is None for s in pd.values()):
                role = "replicated"
            elif shard_dim(w) is None:
                role = "lastdim"
            elif shard_dim(w) == len(w) - 1:
                role = "column"
            else:
                role = "row"
            if role == "column" and not own and len(getattr(
                    u, "output_sample_shape", ())) > 1:
                raise NotImplementedError(
                    f"{u.name}: a column-parallel FC layer of output "
                    f"shape {u.output_sample_shape} (its shard of the "
                    "flat outputs is no block of the last dim)")
            if hasattr(u, "tp_check") and role != "free":
                u.tp_check(role, pd, self.m)
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

    @property
    def data_group(self):
        """The rank's data group (None at one data shard)."""
        return self._mesh.tp_groups()[1]

    def _slice(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a whole tensor along `dim`."""
        c = y.shape[dim] // self.m
        return y.narrow(dim, self.index * c, c)

    def run(self, i: int, u, call, x: torch.Tensor, sharded: bool,
            draws: bool) -> Tuple[torch.Tensor, bool]:
        """Unit i (or the pair it leads) on the rank's shards: `call(x,
        **extra)` runs it; returns (its output, whether that output is
        channel-sharded). `draws`: the unit takes `part=`."""
        role = self.roles[i]
        extra: Dict[str, Any] = {}
        if getattr(u, "tp_program", False) and role != "free":
            # the unit's own rank program (sequence layers, attention,
            # MoE): position-wise, it takes the activation as it comes
            if role == "row" and not sharded:
                raise RuntimeError(f"{u.name}: a row-parallel unit fed a "
                                   "replicated activation")
            if role == "replicated" and sharded:
                x = self._gather(x, False)
                sharded = False
            return call(x, tp=UnitRank(self, i, sharded)), \
                self.out_flags[i]
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


class UnitRank:
    """What a unit's own rank program (`fused_apply(..., tp=)`, units
    with `tp_program`) is handed: its role and plan, whether its input
    arrives feature-sharded, and the collectives over the model group
    (the data group's for MoE's global routing). Every consumer in such
    a program is partial (a column shard, or the rank's block of the
    output) unless it says otherwise."""

    def __init__(self, fwd: RankForward, i: int, sharded: bool) -> None:
        self.role = fwd.roles[i]
        self.spec = fwd.plan[i]
        self.sharded = sharded
        self.m = fwd.m
        self.n_data, self.data_index = fwd.n_data, fwd.data_index
        self._fwd = fwd

    def is_sharded(self, leaf: str) -> bool:
        """Whether the plan shards `leaf` (on its last dim)."""
        return shard_dim(self.spec.get(leaf, ())) is not None

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The unit's input made whole for partial consumers: a sharded
        one all-gathered (the backward reduce-scatters), a replicated one
        through megatron's f (the backward all-reduces)."""
        if self.sharded:
            return self.gather(x)
        return self.copy_in(x)

    def gather(self, x: torch.Tensor, partial: bool = True
               ) -> torch.Tensor:
        """The ranks' last-dim blocks of `x` all-gathered; `partial`
        False where every rank consumes the whole alike."""
        return self._fwd._gather(x, partial)

    def copy_in(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's f: `t` itself, its gradient all-reduced over the
        model group (a replicated leaf's, zero off the block the rank
        used, so summed into the whole gradient on every rank)."""
        return _CopyIn.apply(t, self._fwd.group)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        """Megatron's g: the ranks' partial products summed."""
        return _ReduceOut.apply(y, self._fwd.group)

    def scatter_out(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' partial products summed, this rank's last-dim
        block kept."""
        return _ScatterOut.apply(y, self._fwd.group, self.m)

    def mine(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a whole tensor along `dim`."""
        return self._fwd._slice(t, dim)

    def counts_before(self, counts: torch.Tensor) -> torch.Tensor:
        """Per expert, the tokens that the data shards before this rank's
        route to it (their rows precede this shard's in the global batch,
        which the JAX gspmd step routes as one), from every shard's
        `counts`: an all-gather over the data group."""
        import torch.distributed as dist
        every = [torch.empty_like(counts) for _ in range(self.n_data)]
        dist.all_gather(every, counts.contiguous(),
                        group=self._fwd.data_group)
        return sum(every[:self.data_index], torch.zeros_like(counts))
