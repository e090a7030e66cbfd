"""Switch mixture of experts: top-1 routing by index, the experts' FFN,
and the expert-parallel exchange.

The port's counterpart of `veles_tpu/ops/moe.py`. The JAX functions
route through dense one-hot masks: `top1_dispatch` builds `dispatch` and
`combine` as (N, E, C) tensors and the slots are filled and read back
by einsums over them. At the char-transformer's full width (N = 32 x
4096 tokens, E = 8 experts, C = 2N/E = 32,768 slots) such a mask has
3.4e10 elements, 137 GB in f32, so the port computes the same function
by index and never builds an (N, E, C) tensor:

- each token's expert is the argmax of its router probabilities, the
  first one on ties (`torch.argmax`, as `jnp.argmax`);
- its slot is the count of earlier tokens routed to the same expert, in
  integers (`top1_route`; the JAX function counts in the probabilities'
  dtype, which in bf16 counts exactly only up to 256);
- a token whose slot is at or past the capacity is dropped;
- `dispatch_rows` copies the kept tokens' rows into an (E, C, D) buffer
  (the rows the JAX einsum "nd,nec->ecd" sums with ones and zeros),
  `expert_ffn` runs every expert on its slots (a batched product, as the
  JAX package computes it outside Pallas), and `combine_rows` reads each
  kept token's row back and multiplies it by its gate (the JAX einsum
  "ecd,nec->nd" with the combine mask); a dropped token gets zeros.

In f32 both forms select the same rows and multiply each by 1 or by the
gate, adding only zeros, so they agree up to the experts' products.
Gradients flow through the gate and the experts, never through the
argmax or the count. `top1_dispatch` returns the dense masks for small N,
so that tests can hold the routing against the JAX function's masks.

Under the fused step's tensor parallelism (parallel/tp.py) `moe_forward`
runs on one rank's blocks of the JAX plan's last-dim rule: `wr`'s expert
columns give the rank's router logits, `w1` / `b1` its block of the
hidden, `w2` / `b2` its block of D, and `gather` all-gathers the logits
(so that every rank routes alike, each logit a whole contraction) and
the hidden between the experts' two products; `counts_before` offsets
the slots by the tokens the data shards before this one route to each
expert, so that a gspmd step over several data shards routes its global
batch as one, as the JAX gspmd step does.

`moe_forward_ep` is the expert-parallel form over a `torch.distributed`
group: every rank routes its own tokens over all E experts and holds
E/R of them (`w1`, `b1`, `w2`, `b2` sliced on their leading dim, the
router replicated); the (E, C, D) buffer is exchanged so that each rank
receives its experts' slots from every rank (`all_to_all_single`, in
an autograd function whose backward is the same exchange of the
gradients), the local experts run on (E/R, R*C, D), and a second
exchange returns the results. The capacity is per source rank, as in
the JAX function.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from veles_tpu_torch.ops import functional as fn


def router_probs(x: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    """x (N, D), wr (D, E) -> (N, E) softmax router probabilities."""
    return torch.softmax(fn.matmul(x, wr), dim=-1)


def default_capacity(n_tokens: int, n_experts: int) -> int:
    """The JAX functions' capacity when none is given: 2N/E, at least 1."""
    return max(1, (2 * n_tokens) // n_experts)


def top1_route(probs: torch.Tensor, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Switch routing by index: (expert, slot, keep, gate), each (N,).
    `expert` is the argmax (the first on ties), `slot` the number of
    earlier tokens routed to the same expert (an integer count, kept or
    not, as the JAX prefix count), `keep` is slot < capacity, and `gate`
    the token's probability of its expert (differentiable)."""
    n, e = probs.shape
    with torch.no_grad():
        expert = probs.argmax(dim=-1)
        # (E, N): each expert's running count along its contiguous row (a
        # scan along the outer dim of (N, E) takes ~25 ms at 131,072 x 8
        # on an H100; along the inner one, microseconds)
        onehot = torch.nn.functional.one_hot(expert, e).t().contiguous()
        slot = onehot.cumsum(1).gather(0, expert[None])[0] - 1
        keep = slot < capacity
    gate = probs.gather(1, expert[:, None])[:, 0]
    return expert, slot, keep, gate


def top1_dispatch(probs: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX function's dense masks, (dispatch, combine), each (N, E, C)
    in the probabilities' dtype: token n occupies slot c of expert e, and
    combine is dispatch times the gate. For tests at small N: the port's
    forward routes by index (`top1_route`) and never builds these."""
    n, e = probs.shape
    expert, slot, keep, gate = top1_route(probs, capacity)
    dispatch = probs.new_zeros(n, e, capacity)
    rows = keep.nonzero()[:, 0]
    dispatch[rows, expert[rows], slot[rows]] = 1
    return dispatch, dispatch * gate[:, None, None]


def dispatch_rows(x: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                  keep: torch.Tensor, n_experts: int, capacity: int,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The (E, C, D) slot buffer: each kept token's row of x (N, D) at its
    expert's slot, zeros in the empty slots. A dropped token is written
    to one spare row past the buffer, which is cut off (no host sync for
    the kept count); gradients reach the kept rows only."""
    d = x.shape[1]
    dt = x.dtype if dtype is None else dtype
    spare = n_experts * capacity
    idx = torch.where(keep, expert * capacity + slot,
                      torch.full_like(expert, spare))
    buf = x.new_zeros(spare + 1, d, dtype=dt)
    buf = buf.index_copy(0, idx, x.to(dt))
    return buf[:spare].view(n_experts, capacity, d)


def combine_rows(ye: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(N, D): each kept token's row of the experts' output (E, C, D)
    times its gate, zeros for a dropped token; in the dtype the JAX
    einsum with the combine mask promotes to."""
    e, c, d = ye.shape
    dt = torch.promote_types(ye.dtype, gate.dtype)
    idx = torch.where(keep, expert * c + slot, torch.zeros_like(expert))
    w = torch.where(keep, gate, torch.zeros_like(gate)).to(dt)
    return ye.reshape(e * c, d).to(dt).index_select(0, idx) * w[:, None]


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               gather: Optional[Callable] = None) -> torch.Tensor:
    """Every expert's 2-layer FFN on its slots: xe (E, C, D), w1 (E, D, H),
    b1 (E, H), w2 (E, H, D), b2 (E, D) -> (E, C, D); relu(xe·w1 + b1)·w2
    + b2, in the dtype the JAX einsums promote to. `gather` makes a
    block of the hidden (w1 sharded on H) whole for w2."""
    t = torch.promote_types(xe.dtype, w1.dtype)
    h = torch.relu(torch.bmm(xe.to(t), w1.to(t)) + b1[:, None, :])
    if h.shape[-1] != w2.shape[1]:
        h = gather(h)
    t = torch.promote_types(h.dtype, w2.dtype)
    return torch.bmm(h.to(t), w2.to(t)) + b2[:, None, :]


def moe_forward(x: torch.Tensor, wr: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                capacity: Optional[int] = None,
                gather: Optional[Callable] = None,
                counts_before: Optional[Callable] = None) -> torch.Tensor:
    """All experts local: x (N, D) -> (N, D). On a tensor-parallel rank
    (`wr` sharded on its experts, w1 / b1 on H, w2 / b2 on D) `gather`
    all-gathers a last-dim block over the model group and the result is
    the rank's block of D; `counts_before(counts)` gives, per expert, the
    tokens routed to it in the rows before x's in the global batch (None:
    x is the whole batch)."""
    n = x.shape[0]
    e = w1.shape[0]
    if capacity is None:
        capacity = default_capacity(n, e)
    logits = fn.matmul(x, wr)
    if logits.shape[-1] != e:
        logits = gather(logits)
    probs = torch.softmax(logits, dim=-1)
    expert, slot, keep, gate = top1_route(probs, capacity)
    if counts_before is not None:
        slot = slot + counts_before(torch.bincount(expert,
                                                   minlength=e))[expert]
        keep = slot < capacity
    xe = dispatch_rows(x, expert, slot, keep, e, capacity,
                       torch.promote_types(x.dtype, probs.dtype))
    ye = expert_ffn(xe, w1, b1, w2, b2, gather)
    return combine_rows(ye, expert, slot, keep, gate)


class AllToAll(torch.autograd.Function):
    """`all_to_all_single` of equal chunks along dim 0 over `group`: chunk
    j of rank i lands at position i of rank j. The exchange is its own
    transpose, so the backward sends the gradients back the same way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def moe_forward_ep(x: torch.Tensor, wr: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   group=None, capacity: Optional[int] = None
                   ) -> torch.Tensor:
    """Expert-parallel MoE over the ranks of `group` (None: the default
    group): x (N_loc, D) this rank's tokens, wr (D, E) replicated, w1 /
    b1 / w2 / b2 this rank's E/R experts (rank r holds experts [r*E/R,
    (r+1)*E/R)). Returns (N_loc, D). `capacity` is per source rank
    (default 2*N_loc/E)."""
    import torch.distributed as dist
    n_ranks = dist.get_world_size(group)
    n_loc, d = x.shape
    e_total = wr.shape[1]
    e_loc = w1.shape[0]
    if e_loc * n_ranks != e_total:
        raise ValueError(f"{e_loc} local experts x {n_ranks} ranks != "
                         f"{e_total} routed experts")
    if capacity is None:
        capacity = default_capacity(n_loc, e_total)
    probs = router_probs(x, wr)
    expert, slot, keep, gate = top1_route(probs, capacity)
    xe = dispatch_rows(x, expert, slot, keep, e_total, capacity,
                       torch.promote_types(x.dtype, probs.dtype))
    # (E, C, D) = (R, E/R, C, D): after the exchange position i holds
    # rank i's slots of this rank's experts
    xe = AllToAll.apply(xe, group)
    xe = xe.reshape(n_ranks, e_loc, capacity, d).transpose(0, 1) \
        .reshape(e_loc, n_ranks * capacity, d)
    ye = expert_ffn(xe, w1, b1, w2, b2)
    ye = ye.reshape(e_loc, n_ranks, capacity, d).transpose(0, 1)
    ye = AllToAll.apply(ye, group).reshape(e_total, capacity, d)
    return combine_rows(ye, expert, slot, keep, gate)
