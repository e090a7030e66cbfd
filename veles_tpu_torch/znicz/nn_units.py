"""Forward base unit of the port: an `nn.Module` holding a layer's
parameters, filled on the host from the seeded numpy streams.

The port's counterpart of `Forward` in `veles_tpu/znicz/nn_units.py`:
`weights_filling` "uniform" draws from ±stddev·√3 (so its std matches a
gaussian fill), `weights_stddev` None means LeCun 1/√fan_in, and the bias
falls back to the weights' stddev. The draws come from `prng.get()` in the
JAX package's order, so one seed gives bit-identical parameters.

Layouts at the boundary are the JAX package's (conv weights HWIO, FC
weights (fan_in, units), activations NHWC). Parameters are trainable
`nn.Parameter`s; serving runs them under `torch.inference_mode()`.

`GradientDescentBase` is the counterpart of the JAX package's gradient
unit as the fused train step reads it: the holder of one layer's update
hyperparameters (same names and defaults) and of its momentum
velocities, which the step seeds itself from and writes back to. They
are named as the JAX package names them: `vel_w` / `vel_b` for the leaves
`weights` / `bias`, `vel_<name>` for every other leaf (`vel_wq`,
`vel_pos`, `vel_w2`, ...; `_vel_attr` in veles_tpu/parallel/fused.py).
`register_gd` / `gd_for` pair each forward class with its gradient unit.
The granular per-unit backward (`gd.py`, `gd_conv.py`, `gd_pooling.py`
there, and the `jax.vjp` twins of the attention and sequence units)
comes with a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from veles_tpu_torch import prng


#: forward unit class -> its gradient unit class
MATCHED_GD: Dict[type, type] = {}


def register_gd(forward_cls: type):
    """Class decorator pairing a gradient unit with its forward unit."""

    def deco(gd_cls: type) -> type:
        MATCHED_GD[forward_cls] = gd_cls
        return gd_cls

    return deco


def gd_for(forward_cls: type) -> type:
    """The gradient unit class of a forward unit class, walking the MRO so
    subclasses inherit their base's pairing."""
    for cls in forward_cls.__mro__:
        if cls in MATCHED_GD:
            return MATCHED_GD[cls]
    raise KeyError(f"no GD unit registered for {forward_cls.__name__}")


class Forward(nn.Module):
    """Base of all forward layers. Subclasses implement
    `initialize(sample_shape, device) -> output sample shape` (filling
    their parameters there) and `fused_apply(params, x, train=...)`."""

    #: registry op this unit consults (None: a fixed lowering)
    variant_op: Optional[str] = None
    #: explicit per-layer lowering (wins over the registry selection)
    variant_override: Optional[str] = None
    #: the fused step hands this unit its torch.Generator (`gen=`)
    fused_needs_gen = False

    def __init__(self, weights_filling: str = "uniform",
                 weights_stddev: Optional[float] = None,
                 bias_filling: str = "uniform",
                 bias_stddev: Optional[float] = None,
                 include_bias: bool = True,
                 name: Optional[str] = None) -> None:
        super().__init__()
        self.name = name or type(self).__name__
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        self.include_bias = include_bias
        self.weights: Optional[nn.Parameter] = None
        self.bias: Optional[nn.Parameter] = None

    # -- parameter init helpers ----------------------------------------------

    def _fill(self, shape: Tuple[int, ...], filling: str,
              stddev: float) -> np.ndarray:
        gen = prng.get()
        if filling == "uniform":
            lim = stddev * np.sqrt(3.0)
            return gen.fill_uniform(shape, -lim, lim, np.float32)
        if filling == "gaussian":
            return gen.fill_normal(shape, 0.0, stddev, np.float32)
        raise ValueError(f"unknown filling {filling!r}")

    def default_stddev(self, fan_in: int) -> float:
        """LeCun-style 1/√fan_in when the config gave no stddev."""
        return 1.0 / np.sqrt(max(fan_in, 1))

    def init_params(self, w_shape: Tuple[int, ...], fan_in: int,
                    device: torch.device) -> None:
        if self.weights is None:
            stddev = self.weights_stddev or self.default_stddev(fan_in)
            self.weights = self._param(
                self._fill(w_shape, self.weights_filling, stddev), device)
        if self.bias is None:
            if self.include_bias:
                bstd = self.bias_stddev or self.weights_stddev \
                    or self.default_stddev(fan_in)
                b = self._fill((w_shape[-1],), self.bias_filling, bstd)
            else:
                b = np.zeros((w_shape[-1],), np.float32)
            self.bias = self._param(b, device)

    @staticmethod
    def _param(a: np.ndarray, device: torch.device) -> nn.Parameter:
        return nn.Parameter(torch.from_numpy(a).to(device))

    # -- pytree view ----------------------------------------------------------

    def param_arrays(self) -> Dict[str, torch.Tensor]:
        """The unit's parameters by name — the keys the JAX package's
        `param_arrays()` uses; `{}` for parameterless layers."""
        if self.weights is None:
            return {}
        return {"weights": self.weights, "bias": self.bias}

    def initialize(self, sample_shape: Tuple[int, ...],
                   device: torch.device) -> Tuple[int, ...]:
        raise NotImplementedError

    def fused_apply(self, params: Dict[str, Any], x: torch.Tensor, *,
                    train: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fused_apply(self.param_arrays(), x, train=False)


#: the leaves whose velocities keep the reference's short names
_VEL_ALIASES = {"weights": "vel_w", "bias": "vel_b"}


@register_gd(Forward)
class GradientDescentBase:
    """One layer's update hyperparameters, as the JAX package names them
    (nn_units.py:148-180 there): `learning_rate`, `gradient_moment`
    (momentum), `weights_decay` (L2), `l1_decay`, `learning_rate_bias`
    (the bias lr multiplier, 2 by default, the reference's convention),
    `optimizer` ("sgd", the reference rule, or "adam") with
    `adam_beta1`, `adam_beta2` and `adam_eps`, plus one momentum velocity
    per parameter leaf, under `vel_attr(name)` (None until a fused run
    writes it back; an Adam layer's moments stay in the fused state and
    travel through parallel/checkpoint.py, not through this unit)."""

    def __init__(self, learning_rate: float = 0.01,
                 gradient_moment: float = 0.0,
                 weights_decay: float = 0.0, l1_decay: float = 0.0,
                 learning_rate_bias: float = 2.0,
                 optimizer: str = "sgd", adam_beta1: float = 0.9,
                 adam_beta2: float = 0.999, adam_eps: float = 1e-8,
                 name: Optional[str] = None) -> None:
        self.name = name or type(self).__name__
        self.learning_rate = learning_rate
        self.gradient_moment = gradient_moment
        self.weights_decay = weights_decay
        self.l1_decay = l1_decay
        self.learning_rate_bias = learning_rate_bias
        #: read by the fused step when it is built (pair_gd_configs)
        self.optimizer = optimizer
        self.adam_beta1 = adam_beta1
        self.adam_beta2 = adam_beta2
        self.adam_eps = adam_eps
        self.vel_w: Optional[torch.Tensor] = None
        self.vel_b: Optional[torch.Tensor] = None

    @staticmethod
    def vel_attr(name: str) -> str:
        """The attribute holding the velocity of parameter leaf `name`."""
        return _VEL_ALIASES.get(name, f"vel_{name}")

    def velocity(self, name: str) -> Optional[torch.Tensor]:
        """The velocity of leaf `name`, or None before a fused run wrote
        it back."""
        return getattr(self, self.vel_attr(name), None)
