"""The device mesh of a data-parallel run, and the ZeRO update-sharding
plan over its data axis.

The port's counterpart of `veles_tpu/parallel/mesh.py`. The canonical
axes are the JAX package's: "data" (the batch sharded, gradients
reduced), "model" (tensor parallelism) and "seq" (sequence
parallelism). The JAX mesh is an array of the devices one process sees;
the port runs PyTorch's way, ONE PROCESS PER CARD, so its `Mesh` is the
process group (`torch.distributed`, initialized by
parallel/distributed.py) with the axis sizes laid over its ranks, this
rank's place in it and this rank's device. Only the data axis runs in
this slice: a "model" or "seq" axis above 1 is the gspmd / seq modes,
which the fused step refuses until a later slice.

ZeRO (arxiv 2004.13336; JAX mesh.py:33-133): instead of every replica
all-reducing the full gradient and applying the full update, each rank
owns a 1/N slice of every parameter leaf (and ONLY that slice of the
optimizer state), reduce-scatters the gradient, updates its slice, and
all-gathers the fresh parameters. A leaf whose element count N does not
divide is flattened and zero-padded to the next multiple: the pad's
gradient is zero, so its velocity stays zero and the update leaves it
zero, and the all-gather drops it again. `zero_leaf`, `zero_plan`,
`zero_plan_local_elems` and `zero_ef_plan` are pure and give the JAX
functions' values; `zero_flatten` / `zero_unflatten` are their tensor
halves. `serve_plan` comes with `--serve-mesh`.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class ZeroLeaf:
    """One parameter leaf's slot in the update-sharding plan: flattened,
    zero-padded to `padded` elements, split into equal `local`-sized
    slices along the data axis (rank k owns [k*local, (k+1)*local))."""

    shape: Tuple[int, ...]   # the leaf's original (unflattened) shape
    size: int                # prod(shape)
    padded: int              # size rounded up to a multiple of n_shards
    local: int               # padded // n_shards — one shard's slice

    @property
    def ndim(self) -> int:
        """Original rank: the bias convention (1-D leaves get the bias lr
        multiplier, ops/optim.sgd_leaf_lr) must survive the flattening."""
        return len(self.shape)


def zero_leaf(shape: Sequence[int], n_shards: int) -> ZeroLeaf:
    """Plan one leaf: the pad-to-divisible remainder rule along "data"."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1 (got {n_shards})")
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape)) if shape else 1
    padded = ((size + n_shards - 1) // n_shards) * n_shards
    return ZeroLeaf(shape=shape, size=size, padded=padded,
                    local=padded // n_shards)


def _tree_map(fn, tree, is_leaf=None):
    """`fn` over the leaves of nested dicts / tuples / lists."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def zero_plan(tree: Any, n_shards: int) -> Any:
    """Per-leaf update-sharding plan: every array-like leaf of `tree`
    (parameters, or anything shaped like them) to its ZeroLeaf."""
    return _tree_map(lambda a: zero_leaf(
        tuple(a.shape) if hasattr(a, "shape") else np.shape(a), n_shards),
        tree)


def zero_flatten(a: torch.Tensor, leaf: ZeroLeaf) -> torch.Tensor:
    """A leaf as its (padded,) flat vector, the pad zeros (a view where
    there is no pad)."""
    flat = a.reshape(-1)
    if leaf.padded != leaf.size:
        flat = torch.cat([flat, flat.new_zeros(leaf.padded - leaf.size)])
    return flat


def zero_unflatten(flat: torch.Tensor, leaf: ZeroLeaf) -> torch.Tensor:
    """A (padded,) flat vector back in the leaf's shape (the pad
    dropped)."""
    return flat[:leaf.size].reshape(leaf.shape)


def zero_plan_local_elems(plan: Any) -> int:
    """Per-SHARD element count of one layer's plan: the sum of the local
    slice lengths, pad included (the optimizer-state bytes a rank holds
    are this times the slots times the item size)."""
    total = 0

    def add(lp):
        nonlocal total
        if isinstance(lp, ZeroLeaf):
            total += lp.local
    _tree_map(add, plan, is_leaf=lambda x: isinstance(x, ZeroLeaf))
    return total


def zero_ef_plan(plan: Any, resid_len) -> Any:
    """The optional error-feedback slot of the plan: every ZeroLeaf of a
    `zero_plan` tree to the per-shard residual length a stateful
    `grad_reduce` variant carries for it; `resid_len(padded)` is the
    variant's rule (ops/variants.grad_reduce_resid_len)."""
    return _tree_map(lambda lp: resid_len(lp.padded), plan,
                     is_leaf=lambda x: isinstance(x, ZeroLeaf))


def mesh_shape(n_devices: int, model: int = 1, seq: int = 1,
               data: Optional[int] = None) -> Dict[str, int]:
    """Resolve an axis-size dict; `data` defaults to whatever is left."""
    if n_devices % (model * seq):
        raise ValueError(
            f"{n_devices} devices not divisible by model({model})*seq({seq})")
    if data is None:
        data = n_devices // (model * seq)
    if data * model * seq != n_devices:
        raise ValueError(
            f"data({data})*model({model})*seq({seq}) != {n_devices} devices")
    return {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq}


class Mesh:
    """The (data, seq, model) layout of a process group: `shape` (axis
    sizes, the JAX `mesh.shape`), `axis_names`, this process's `rank`
    of `size`, its `device`, the `group` (None: the default group) and
    the number of hosts the group spans (`n_hosts`). A rank is one card
    (or one CPU process under gloo): "data" is outermost, as in the JAX
    layout, so data shard d holds ranks [d*seq*model, (d+1)*seq*model)."""

    def __init__(self, shape: Dict[str, int], rank: int, device,
                 group=None, n_hosts: int = 1) -> None:
        self.shape = dict(shape)
        self.axis_names = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
        self.rank = int(rank)
        self.size = int(np.prod(list(self.shape.values())))
        self.device = torch.device(device)
        self.group = group
        self.n_hosts = int(n_hosts)
        self._subgroups: Dict[Tuple[int, int], Any] = {}
        self._tp_groups = None

    @property
    def data_index(self) -> int:
        """This rank's shard along the data axis."""
        return self.rank // (self.shape[SEQ_AXIS] * self.shape[MODEL_AXIS])

    @property
    def seq_index(self) -> int:
        """This rank's shard along the seq axis."""
        return (self.rank // self.shape[MODEL_AXIS]) % self.shape[SEQ_AXIS]

    @property
    def model_index(self) -> int:
        """This rank's shard along the model axis (innermost)."""
        return self.rank % self.shape[MODEL_AXIS]

    def tp_groups(self):
        """(model group, data group) of this rank: the `model` ranks of
        its (data, seq) cell, and the ranks of its (seq, model) index
        along the data axis (rank = d*seq*model + s*model + m, the JAX
        layout). Where an axis spans the whole mesh its group is the
        mesh's own; where it has one rank, None for the model group (no
        model collective runs). Made on first use, every group by every
        rank in the same order (`new_group` is a collective), and kept."""
        if self._tp_groups is None:
            d_n = self.shape[DATA_AXIS]
            s_n, m_n = self.shape[SEQ_AXIS], self.shape[MODEL_AXIS]
            if m_n == 1:
                model = None
                data = (self.group if s_n == 1
                        else self._new_groups(
                            [[d * s_n + s for d in range(d_n)]
                             for s in range(s_n)], self.seq_index))
            elif d_n == 1 and s_n == 1:
                model, data = self.group, None
            else:
                cells = [[(d * s_n + s) * m_n + m for m in range(m_n)]
                         for d in range(d_n) for s in range(s_n)]
                model = self._new_groups(
                    cells, self.data_index * s_n + self.seq_index)
                lines = [[(d * s_n + s) * m_n + m for d in range(d_n)]
                         for s in range(s_n) for m in range(m_n)]
                data = self._new_groups(
                    lines, self.seq_index * m_n + self.model_index)
            self._tp_groups = (model, data)
        return self._tp_groups

    def _new_groups(self, members, mine: int):
        """`new_group` of each list of mesh ranks in `members`, in order;
        returns the `mine`-th (the one holding this rank)."""
        import torch.distributed as dist
        # the group's ranks in the world, by their rank in the group
        ranks = (dist.get_process_group_ranks(self.group)
                 if self.group is not None
                 else list(range(dist.get_world_size())))
        out = None
        for k, ms in enumerate(members):
            g = dist.new_group([ranks[r] for r in ms])
            if k == mine:
                out = g
        return out

    def subgroups(self, n_hosts: int, n_local: int):
        """(the local group holding this rank, the cross group holding
        it) of the (hosts x local) factorization of the data axis, by
        rank in the mesh's group: local group h = ranks [h*n_local,
        (h+1)*n_local), cross group l = ranks {h*n_local + l}. Made on
        first use (every rank of the world must ask, in the same order:
        `new_group` is a collective) and kept."""
        key = (int(n_hosts), int(n_local))
        if key not in self._subgroups:
            local = self._new_groups(
                [[h * n_local + k for k in range(n_local)]
                 for h in range(n_hosts)], self.rank // n_local)
            cross = self._new_groups(
                [[h * n_local + k for h in range(n_hosts)]
                 for k in range(n_local)], self.rank % n_local)
            self._subgroups[key] = (local, cross)
        return self._subgroups[key]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, hosts={self.n_hosts})")


def default_device(rank: int):
    """This rank's card: `LOCAL_RANK`, else the rank modulo the cards
    this host sees. Without CUDA it refuses as `backends.make_device`
    does: a rank runs on the CPU only where the caller asks for it
    (`make_mesh(device="cpu")`, the CLI's --device cpu)."""
    import os

    from veles_tpu_torch.backends import make_device
    if not torch.cuda.is_available():
        make_device("cuda")       # raises: the CPU must be asked for
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(1, torch.cuda.device_count())))
    return torch.device("cuda", local)


def make_mesh(model: int = 1, seq: int = 1, data: Optional[int] = None,
              device=None, group=None) -> Mesh:
    """The mesh over the initialized process group (parallel/distributed.
    py `initialize_distributed`): axis sizes from its world size
    (`mesh_shape`), this rank, its device (`device`, else
    `default_device`), and the hosts the group spans (the ranks'
    host names, all-gathered once)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_distributed "
                           "first")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    shape = mesh_shape(world, model=model, seq=seq, data=data)
    dev = torch.device(device) if device is not None \
        else default_device(rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=group)
    return Mesh(shape, rank, dev, group=group, n_hosts=len(set(names)))


def is_multihost(mesh) -> bool:
    """True when `mesh` spans more than one host (its ranks' collectives
    cross the network, not only the host's links)."""
    return mesh is not None and getattr(mesh, "n_hosts", 1) > 1
