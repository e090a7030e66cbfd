"""Switch mixture-of-experts layer, its granular node and its gradient
unit.

The port's counterpart of `veles_tpu/znicz/moe.py`. `MoELayer` is a top-1
(switch) MoE FFN with the router `wr` (D, E) and the experts' FFNs `w1`
(E, D, H), `b1` (E, H), `w2` (E, H, D), `b2` (E, D), filled from the
seeded numpy streams in the JAX unit's order (wr, w1, w2; b1 and b2
zeros), so one seed gives bit-identical parameters in both packages.

Input forms (`route`): (N, D) classifier features route each SAMPLE;
(N, S, D) sequence activations route each TOKEN and keep their shape
(the MoE-transformer block, `residual` adding x). "auto" treats a 3-D
input as a token sequence, "sample" flattens every sample to one routing
row. `capacity(n)` is the per-expert slot budget, int(capacity_factor *
n / n_experts), at least 1; tokens past it are dropped (the residual
keeps them alive). A restored snapshot trained under another `route`
mode is refused when the router's width does not match.

The forward is ops/moe.py's routing by index (no (N, E, C) mask). The
fused data-parallel step with `ep=True` (parallel/fused.py) hands the
layer its mesh (`fused_apply(..., ep_mesh=mesh)`, the port's handle in
place of the JAX unit's `ep_axis_name`): the layer then runs
`moe_forward_ep` over the mesh's process group with this rank's E/R
experts (`ep_params`, sharded on their leading dim; the router stays
replicated), every rank's capacity its own tokens' (JAX :126-135:
dense and expert-parallel forms drop the same tokens only where no
capacity binds). Without a mesh it runs the dense local form.

Under the fused step's tensor parallelism (mode "gspmd", parallel/tp.py)
the JAX plan's last-dim rule shards `wr` on its experts, `w1` / `b1` on
H and `w2` / `b2` on D (`fused_apply(..., tp=)`): the rank routes the
gathered input on the gathered router logits (every rank alike), runs
its block of the hidden, gathers it, and returns its block of D (the
residual adds x's); a leaf the rule leaves whole passes megatron's f.
Over several data shards the routing and the capacity are the global
batch's, as in the JAX gspmd step (ops/moe.py `moe_forward`). `ep`
stays exclusive with it, as in JAX.

In the granular graph the layer's node is a `VJPForwardUnit` and its
gradient unit `GDMoELayer` the vjp of the same forward (the argmax has
no gradient: the gate and the experts do), velocities `vel_wr`,
`vel_w1`, `vel_b1`, `vel_w2`, `vel_b2`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from veles_tpu_torch.ops import moe as om
from veles_tpu_torch.znicz.nn_units import Forward, GradientDescentVJP, \
    VJPForwardUnit, register_gd, register_unit

ROUTES = ("auto", "token", "sample")


class MoELayer(Forward):
    """Top-1 (switch) MoE FFN: (N, D) -> (N, D), or (N, S, D) -> (N, S, D)
    routed per token; y = x + moe(x) when `residual`."""

    #: leaves sharded on their leading (expert) dim when the fused step
    #: runs expert-parallel; the router wr stays replicated
    ep_params = ("w1", "b1", "w2", "b2")
    #: runs its own tensor-parallel rank program (parallel/tp.py)
    tp_program = True

    def __init__(self, n_experts: int = 4, hidden: int = 64,
                 capacity_factor: float = 2.0, residual: bool = False,
                 route: str = "auto", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got "
                             f"{route!r}")
        self.n_experts = n_experts
        self.hidden = hidden
        self.capacity_factor = capacity_factor
        self.residual = residual
        self.route = route
        self.wr = self.w1 = self.b1 = self.w2 = self.b2 = None
        #: the per-sample input shape the layer was initialized for (the
        #: exporter resolves "auto" from its rank)
        self.input_shape: Optional[tuple] = None

    def param_arrays(self) -> Dict[str, Any]:
        if self.wr is None:
            return {}
        return {"wr": self.wr, "w1": self.w1, "b1": self.b1, "w2": self.w2,
                "b2": self.b2}

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens
                          / self.n_experts))

    def _token_wise(self, ndim: int) -> bool:
        """Whether an input of `ndim` dimensions (the batch's included)
        routes per token."""
        if self.route == "token":
            return True
        if self.route == "sample":
            return False
        return ndim == 3

    def token_wise(self) -> bool:
        """The resolved route of the initialized layer."""
        return self._token_wise(len(self.input_shape) + 1)

    def input_tokens_per_sample(self) -> int:
        """Routing tokens in one sample: S of an (S, D) sequence, else 1."""
        return int(self.input_shape[0]) if self.token_wise() else 1

    def initialize(self, sample_shape, device):
        sample_shape = tuple(sample_shape)
        token_wise = self._token_wise(len(sample_shape) + 1)
        d = int(sample_shape[-1]) if token_wise \
            else int(np.prod(sample_shape))
        if self.wr is not None and self.wr.shape[0] != d:
            raise ValueError(
                f"{self.name}: router expects feature dim "
                f"{self.wr.shape[0]} but input routes dim {d} — a "
                "restored snapshot trained under a different `route` "
                f"mode? (route={self.route!r}, input {sample_shape})")
        if self.wr is None:
            e, h = self.n_experts, self.hidden
            std = self.weights_stddev or self.default_stddev(d)
            self.wr = self._param(self._fill((d, e), self.weights_filling,
                                             std), device)
            self.w1 = self._param(self._fill((e, d, h), self.weights_filling,
                                             std), device)
            self.b1 = self._param(np.zeros((e, h), np.float32), device)
            self.w2 = self._param(self._fill(
                (e, h, d), self.weights_filling,
                self.weights_stddev or self.default_stddev(h)), device)
            self.b2 = self._param(np.zeros((e, d), np.float32), device)
        self.input_shape = sample_shape
        return sample_shape if token_wise else (d,)

    def tp_check(self, role, spec, m) -> None:
        """The last-dim rule's program returns the rank's block of D: w2
        sharded wherever another leaf is."""
        if role == "lastdim" and not spec["w2"]:
            raise NotImplementedError(
                f"{self.name}: the router or the hidden sharded with w2 "
                f"replicated (D {self.w2.shape[-1]} does not divide over "
                f"{m} ranks)")

    def _tokens(self, params, x2: torch.Tensor, ep_mesh, tp
                ) -> torch.Tensor:
        args = (x2, params["wr"], params["w1"], params["b1"], params["w2"],
                params["b2"])
        if ep_mesh is not None:
            return om.moe_forward_ep(*args, group=ep_mesh.group,
                                     capacity=self.capacity(x2.shape[0]))
        if tp is None:
            return om.moe_forward(*args,
                                  capacity=self.capacity(x2.shape[0]))
        if tp.role == "lastdim":
            args = (x2,) + tuple(
                params[k] if tp.is_sharded(k) else tp.copy_in(params[k])
                for k in ("wr", "w1", "b1", "w2", "b2"))
        return om.moe_forward(
            *args, capacity=self.capacity(x2.shape[0] * tp.n_data),
            gather=tp.gather,
            counts_before=tp.counts_before if tp.n_data > 1 else None)

    def fused_apply(self, params, x, *, train=False, ep_mesh=None, tp=None):
        """`ep_mesh`: the dp mesh whose ranks hold E/R experts each (the
        fused step's under `ep=True`); None runs every expert here.
        `tp`: this rank's part of the tensor-parallel plan
        (parallel/tp.py UnitRank; the output is the rank's block of D in
        the role "lastdim"), None on whole tensors."""
        if tp is not None and tp.role == "lastdim":
            x = tp.whole(x)
        if self._token_wise(x.dim()):
            n, s, d = x.shape
            y = self._tokens(params, x.reshape(n * s, d), ep_mesh, tp)
            y = y.reshape(n, s, y.shape[-1])
        else:
            x = x.reshape(x.shape[0], -1)
            y = self._tokens(params, x, ep_mesh, tp)
        if not self.residual:
            return y
        return (x if y.shape[-1] == x.shape[-1] else tp.mine(x)) + y


@register_unit(MoELayer)
class MoEUnit(VJPForwardUnit):
    """(N, D) -> (N, D) or (N, S, D) -> (N, S, D), one firing per
    minibatch, every expert on the unit's device."""


@register_gd(MoELayer)
class GDMoELayer(GradientDescentVJP):
    """The vjp of the dense routing forward and the update of wr, w1, b1,
    w2 and b2 (`vel_wr`, `vel_w1`, `vel_b1`, `vel_w2`, `vel_b2`)."""
