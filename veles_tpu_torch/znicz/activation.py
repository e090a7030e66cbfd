"""Standalone activation units and their gradient unit.

The port's counterparts of `ActivationTanh`, `ActivationRELU`,
`ActivationStrictRELU`, `ActivationSigmoid`, `ActivationLog` and
`ActivationBackward` in `veles_tpu/znicz/activation.py` (:26-127 there;
parity: reference `veles/znicz/activation.py`): y = act(x), shape
preserving, no parameters, for an activation that is not folded into an
All2All or Conv layer. The functions are `functional.act_forward` /
`act_backward` (the goldens `reference.act_*` on the numpy backend). The
backward is expressed from the forward's output, the reference's memory
model, and the log flavor (asinh) reads the input as well.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, \
    GradientDescentBase, dev, host, register_gd, register_unit


class ActivationForward(Forward):
    """y = act(x)."""

    activation = "linear"
    #: elementwise: runs on a tensor-parallel rank's channels
    tp_channel_local = True

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def fused_apply(self, params, x, *, train=False):
        return fn.act_forward(self.activation, x)


class ActivationTanh(ActivationForward):
    activation = "tanh"


class ActivationRELU(ActivationForward):
    activation = "relu"


class ActivationStrictRELU(ActivationForward):
    activation = "strictrelu"


class ActivationSigmoid(ActivationForward):
    activation = "sigmoid"


class ActivationLog(ActivationForward):
    activation = "log"


@register_unit(ActivationForward)
class ActivationUnit(ForwardUnit):
    """The layer's forward, one firing per minibatch."""

    def numpy_run(self) -> None:
        self.output.mem = ref.act_forward(self.layer.activation,
                                          host(self.input))

    def torch_run(self) -> None:
        self.output.set_devmem(fn.act_forward(
            self.layer.activation, dev(self.input, self.device)))


@register_gd(ActivationForward)
class ActivationBackward(GradientDescentBase):
    """err_input = act'·err_output, from the forward's output (and its
    input, for the log flavor)."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.activation = "linear"

    def link_forward(self, fwd):
        self.activation = fwd.layer.activation
        return super().link_forward(fwd)

    def numpy_run(self) -> None:
        self.err_input.mem = ref.act_backward(
            self.activation, host(self.output), host(self.err_output),
            host(self.input))

    def torch_run(self) -> None:
        d = self.device
        self.err_input.set_devmem(fn.act_backward(
            self.activation, dev(self.output, d), dev(self.err_output, d),
            dev(self.input, d)))
