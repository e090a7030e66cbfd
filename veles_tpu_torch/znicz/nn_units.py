"""Forward base unit of the port: an `nn.Module` holding a layer's
parameters, filled on the host from the seeded numpy streams; the
granular graph's node around it; and the gradient unit.

The port's counterpart of `veles_tpu/znicz/nn_units.py`. `Forward` is a
layer: `weights_filling` "uniform" draws from ±stddev·√3 (so its std
matches a gaussian fill), `weights_stddev` None means LeCun 1/√fan_in, and
the bias falls back to the weights' stddev. The draws come from
`prng.get()` in the JAX package's order, so one seed gives bit-identical
parameters. Layouts at the boundary are the JAX package's (conv weights
HWIO, FC weights (fan_in, units), activations NHWC). Parameters are
trainable `nn.Parameter`s; serving runs them under
`torch.inference_mode()`, the fused step (parallel/fused.py) through
`fused_apply`.

`ForwardUnit` is the layer's node in the granular Unit/Workflow graph
(the JAX `Forward` as a unit): it holds the layer, not a copy of it —
`weights` and `bias` are `memory.TensorView`s of the layer's parameters,
so the granular units, the fused step and a snapshot share one set of
weights, and a fused run after a granular one continues from its
weights. `input` is linked to the upstream unit's output (the loader's
`minibatch_data` for the first layer), `output` is an `Array`, and
`input_sample_shape` is linked to the upstream `sample_shape`, so that
`initialize` fills the layer's parameters in graph order, as the JAX
units fill theirs. Each layer module registers its layer's node with
`register_unit`; `unit_for` finds it.

`GradientDescentBase` is the gradient unit (the JAX package's, as a unit):
the holder of one layer's update hyperparameters (same names and
defaults), of `lr_scale` (which `lr_adjust.LearningRateAdjust` drives)
and of its momentum velocities, and, in its subclasses (gd.py,
gd_conv.py, gd_pooling.py, normalization.py, dropout.py), the granular
backward: `err_output` in, `err_input` out, the update in place. The
velocities are named as the JAX package names them: `vel_w` / `vel_b` for
the leaves `weights` / `bias`, `vel_<name>` for every other leaf
(`vel_wq`, `vel_pos`, `vel_w2`, ...; `_vel_attr` in
veles_tpu/parallel/fused.py). They are tensors, None until a run makes
them — the fused step seeds itself from them and writes them back, a
granular update makes zeros where there are none — and
`vel_array(name)` is their `Array` view. The granular update goes
through the registry's `sgd_update` lowering (K1 on the card, the exact
tree rule where `l1_decay` is not 0), `_sgd_host` is the numpy golden's.
`register_gd` / `gd_for` pair each forward class with its gradient unit.

`VJPForwardUnit` and `GradientDescentVJP` (JAX nn_units.py:210-291) are
the node and the gradient unit of the layers whose backward has no
hand-derived twin, the attention and sequence layers: the node runs the
layer's differentiable forward `apply_model`, and the twin differentiates
that same forward at the unit's input and parameters, afresh at each firing
(`torch.autograd.grad`, as the JAX twin re-traces `jax.vjp`), for
`err_input` and the parameter gradients, then updates every leaf with
the JAX twin's `SGDConfig` (its lr_bias_mult left at 2.0, whatever
`learning_rate_bias` says), through the registry's `sgd_update` (K1) on
the torch backend, by the tree rule of ops/optim.py on the numpy one.
No autograd graph outlives a firing. On the numpy backend both run the
same torch ops on CPU tensors with the flash gate shut
(`allow_flash=False`): the JAX package's numpy run of these units is
jax on the host, not a numpy golden. The velocities keep the port's one
naming (`vel_w`, `vel_b`, `vel_<leaf>`); convert.py maps the JAX twin's
`vel_weights` / `vel_bias` onto it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array, TensorView, target_device
from veles_tpu_torch.ops import optim, variants


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


#: layer class -> its node class in the granular graph
MATCHED_UNIT: Dict[type, type] = {}


def register_unit(layer_cls: type):
    """Class decorator pairing a granular node class with its layer."""

    def deco(unit_cls: type) -> type:
        MATCHED_UNIT[layer_cls] = unit_cls
        return unit_cls

    return deco


def unit_for(layer_cls: type) -> type:
    """The granular node class of a layer class, walking the MRO."""
    for cls in layer_cls.__mro__:
        if cls in MATCHED_UNIT:
            return MATCHED_UNIT[cls]
    raise KeyError(f"no granular unit registered for {layer_cls.__name__}")


# -- the values a granular unit reads: Arrays, or the loader's arrays ---------


def host(value) -> Optional[np.ndarray]:
    """The host numpy view of an `Array`/`TensorView`, a tensor or an
    ndarray (the loader's minibatch arrays)."""
    if value is None or isinstance(value, np.ndarray):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value.mem


def dev(value, device) -> Optional[torch.Tensor]:
    """`value` (as `host` takes it) as a tensor on `device`."""
    if value is None:
        return None
    if isinstance(value, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(value))
        return t.to(target_device(device), non_blocking=False)
    if isinstance(value, torch.Tensor):
        return value.to(target_device(device))
    return value.devmem(device)


def shape_of(value) -> Optional[Tuple[int, ...]]:
    if value is None:
        return None
    s = value.shape
    return None if s is None else tuple(s)


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
    #: the per-sample output shape, recorded when the unit's node
    #: initializes it (None before)
    out_sample_shape: Optional[Tuple[int, ...]] = None

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

    def apply_model(self, params: Dict[str, Any], x: torch.Tensor,
                    allow_flash: bool = True) -> torch.Tensor:
        """The differentiable forward a `VJPForwardUnit` runs and its
        `GradientDescentVJP` twin differentiates (the JAX units'
        `_apply`); `allow_flash=False` keeps a layer with a flash gate on
        its einsum golden."""
        return self.fused_apply(params, x)


@register_unit(Forward)
class ForwardUnit(AcceleratedUnit):
    """A layer's node in the granular graph. The layer classes' modules
    subclass it with the layer's `numpy_run` (the goldens of
    ops/reference.py) and `torch_run` (tensor operations and the port's
    kernels on the unit's device); this base, the node of the layers
    that train in the fused step only, runs neither."""

    def __init__(self, workflow=None, layer: Optional[Forward] = None,
                 **kwargs: Any) -> None:
        if layer is None:
            raise ValueError(f"{type(self).__name__} wraps a layer "
                             "(layer=)")
        kwargs.setdefault("name", layer.name)
        super().__init__(workflow, **kwargs)
        self.layer = layer
        self.input = Array()
        self.output = Array()
        #: per-sample shape of `input` (linked upstream) and of `output`
        self.input_sample_shape: Optional[Tuple[int, ...]] = None
        self.sample_shape: Optional[Tuple[int, ...]] = None

    @property
    def weights(self) -> TensorView:
        return TensorView(self.layer, "weights")

    @property
    def bias(self) -> TensorView:
        return TensorView(self.layer, "bias")

    def __getattr__(self, name: str) -> Any:
        # every other parameter leaf of the layer (wq, pos, w2, ...) is a
        # TensorView too
        layer = self.__dict__.get("layer")
        if layer is not None and not name.startswith("_") \
                and name in layer.param_arrays():
            return TensorView(layer, name)
        return super().__getattr__(name)

    def param_names(self) -> Tuple[str, ...]:
        return tuple(self.layer.param_arrays())

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        """Fill the layer's parameters on the unit's device (the layer
        keeps parameters it already has) once the upstream sample shape
        is known."""
        if self.input_sample_shape is None:
            return False
        self.sample_shape = tuple(self.layer.initialize(
            tuple(self.input_sample_shape), target_device(device)))
        # the tensor-parallel plan's last-dim rule reads the output's
        # last dim (parallel/tp.py tp_plan)
        self.layer.out_sample_shape = self.sample_shape
        return super().initialize(device=device, **kwargs)

    def _no_granular(self) -> None:
        raise NotImplementedError(
            f"{type(self.layer).__name__} has no granular unit: register "
            "one for it (register_unit); its forward runs in the fused "
            "step only")

    def numpy_run(self) -> None:
        self._no_granular()

    def torch_run(self) -> None:
        self._no_granular()


#: the leaves whose velocities keep the reference's short names
_VEL_ALIASES = {"weights": "vel_w", "bias": "vel_b"}


@register_gd(Forward)
class GradientDescentBase(AcceleratedUnit):
    """One layer's update hyperparameters, as the JAX package names them
    (nn_units.py:148-180 there): `learning_rate`, `gradient_moment`
    (momentum), `weights_decay` (L2), `l1_decay`, `learning_rate_bias`
    (the bias lr multiplier, 2 by default, the reference's convention),
    `optimizer` ("sgd", the reference rule, or "adam") with
    `adam_beta1`, `adam_beta2` and `adam_eps`, `lr_scale`, plus one
    momentum velocity per parameter leaf, under `vel_attr(name)` (None
    until a run makes it; an Adam layer's moments stay in the fused state
    and travel through parallel/checkpoint.py, not through this unit; the
    granular backward keeps the reference's SGD rule, as the JAX units
    do)."""

    def __init__(self, workflow=None, learning_rate: float = 0.01,
                 gradient_moment: float = 0.0,
                 weights_decay: float = 0.0, l1_decay: float = 0.0,
                 learning_rate_bias: float = 2.0,
                 optimizer: str = "sgd", adam_beta1: float = 0.9,
                 adam_beta2: float = 0.999, adam_eps: float = 1e-8,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
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
        #: the schedule's lr multiplier (lr_adjust.LearningRateAdjust)
        self.lr_scale = 1.0
        self.err_output = Array()
        self.err_input = Array()
        self.vel_w: Optional[torch.Tensor] = None
        self.vel_b: Optional[torch.Tensor] = None
        #: the parameter leaves this unit updates (set by link_forward)
        self._pnames: Tuple[str, ...] = ()

    @staticmethod
    def vel_attr(name: str) -> str:
        """The attribute holding the velocity of parameter leaf `name`."""
        return _VEL_ALIASES.get(name, f"vel_{name}")

    def velocity(self, name: str) -> Optional[torch.Tensor]:
        """The velocity of leaf `name`, or None before a run made it."""
        return getattr(self, self.vel_attr(name), None)

    def vel_array(self, name: str) -> TensorView:
        """The `Array` view of leaf `name`'s velocity."""
        return TensorView(self, self.vel_attr(name))

    def link_forward(self, fwd: ForwardUnit) -> "GradientDescentBase":
        """Wire the standard data links to the forward twin (parity: the
        reference StandardWorkflow linked weights/bias/input/output); the
        parameter leaves are linked once the twin has filled them
        (`initialize`)."""
        self.link_attrs(fwd, "input", "output")
        self._fwd = fwd
        self._link_params()
        return self

    def _link_params(self) -> None:
        fwd = self.__dict__.get("_fwd")
        if fwd is not None:
            self._pnames = fwd.param_names()
            if self._pnames:
                self.link_attrs(fwd, *self._pnames)

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        fwd = self.__dict__.get("_fwd")
        if fwd is not None and not fwd.is_initialized:
            return False
        self._link_params()
        return super().initialize(device=device, **kwargs)

    # -- the update ------------------------------------------------------------

    def params(self) -> Dict[str, torch.Tensor]:
        """The twin's parameter leaves as tensors (the layer's own
        storage: an update in place is the layer's)."""
        return {n: getattr(self, n).devmem() for n in self._pnames}

    def _ensure_velocity(self) -> None:
        """Zero velocities like the leaves where there are none (or where
        they lie on another device than the leaves)."""
        for n, p in self.params().items():
            v = self.velocity(n)
            if v is None or v.shape != p.shape:
                setattr(self, self.vel_attr(n), torch.zeros_like(p))
            elif v.device != p.device:
                setattr(self, self.vel_attr(n), v.to(p.device))

    def sgd_config(self) -> optim.SGDConfig:
        return optim.SGDConfig(
            lr=self.learning_rate, momentum=self.gradient_moment,
            weight_decay=self.weights_decay, l1_decay=self.l1_decay,
            lr_bias_mult=self.learning_rate_bias)

    @torch.no_grad()
    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        """The torch backend's update of every leaf in place, through the
        registry's `sgd_update` lowering (K1 on the card)."""
        self._ensure_velocity()
        vel = {n: self.velocity(n) for n in grads}
        variants.resolve("sgd_update").apply(
            self.params(), grads, vel, self.sgd_config(),
            float(self.lr_scale))

    def _sgd_host(self, p: np.ndarray, g: np.ndarray, v: np.ndarray,
                  bias: bool) -> Tuple[np.ndarray, np.ndarray]:
        """The numpy golden's update of one leaf (JAX nn_units.py
        `_sgd_host`)."""
        lr = self.learning_rate * self.lr_scale
        if bias:
            lr *= self.learning_rate_bias
        if self.weights_decay:
            g = g + self.weights_decay * p
        if self.l1_decay:
            g = g + self.l1_decay * np.sign(p)
        v_new = self.gradient_moment * v - lr * g
        return p + v_new, v_new

    def _update_host(self, grads: Dict[str, np.ndarray]) -> None:
        """The numpy backend's update, each leaf written into the layer's
        storage."""
        self._ensure_velocity()
        for n, g in grads.items():
            p, v = getattr(self, n), self.vel_array(n)
            new_p, new_v = self._sgd_host(p.mem, g, v.mem,
                                          n == "bias")
            p.mem = new_p
            v.mem = new_v

    def _no_granular(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no granular backward: register a "
            "gradient unit for the layer (register_gd); it trains in the "
            "fused step only")

    def numpy_run(self) -> None:
        self._no_granular()

    def torch_run(self) -> None:
        self._no_granular()

    def __getstate__(self):
        st = super().__getstate__()
        st.pop("_fwd", None)
        return st


class VJPForwardUnit(ForwardUnit):
    """The node of a layer whose gradient twin is a `GradientDescentVJP`:
    `output` is `emit` of the layer's `apply_model` at the unit's input,
    on the unit's device (torch backend) or on CPU tensors of the host
    arrays with the flash gate shut (numpy backend)."""

    def emit(self, y: torch.Tensor) -> torch.Tensor:
        """The unit's output from the model's (a softmax head turns its
        logits into flattened probabilities)."""
        return y

    def numpy_run(self) -> None:
        with torch.no_grad():
            y = self.layer.apply_model(self.layer.param_arrays(),
                                       dev(self.input, None),
                                       allow_flash=False)
            self.output.mem = self.emit(y).numpy()

    def torch_run(self) -> None:
        self.output.set_devmem(self.emit(self.layer.apply_model(
            self.layer.param_arrays(), dev(self.input, self.device))))


class GradientDescentVJP(GradientDescentBase):
    """The gradient unit of a `VJPForwardUnit`: err_output (the error with
    respect to the twin's output, reshaped to the model's output where a
    head flattened it) in; `err_input` and the update of every parameter
    leaf from one differentiation of the layer's `apply_model` at the
    unit's input and parameters (JAX nn_units.py:210-291)."""

    def sgd_config(self) -> optim.SGDConfig:
        # the JAX twin builds SGDConfig(lr, momentum, weight_decay,
        # l1_decay) (nn_units.py:244-249 there): every 1-D leaf gets the
        # default lr_bias_mult, 2.0
        return optim.SGDConfig(
            lr=self.learning_rate, momentum=self.gradient_moment,
            weight_decay=self.weights_decay, l1_decay=self.l1_decay)

    def _vjp(self, device, allow_flash: bool):
        """(err_input, {leaf: gradient}) of the layer's forward at the
        unit's input and parameters, on `device`; the graph is local to
        the call."""
        layer = self._fwd.layer
        params = {n: p.detach().requires_grad_(True)
                  for n, p in self.params().items()}
        x = dev(self.input, device).detach().requires_grad_(True)
        with torch.enable_grad():
            y = layer.apply_model(params, x, allow_flash=allow_flash)
            err_y = dev(self.err_output, device).reshape(y.shape)
            got = torch.autograd.grad(y, [x, *params.values()], err_y)
        return got[0], dict(zip(params, got[1:]))

    def numpy_run(self) -> None:
        err_x, grads = self._vjp(None, allow_flash=False)
        self._ensure_velocity()
        optim.sgd_update(self.params(), grads,
                         {n: self.velocity(n) for n in grads},
                         self.sgd_config(), float(self.lr_scale))
        self.err_input.mem = err_x.numpy()

    def torch_run(self) -> None:
        err_x, grads = self._vjp(self.device, allow_flash=True)
        self.err_input.set_devmem(err_x)
        self._update(grads)
