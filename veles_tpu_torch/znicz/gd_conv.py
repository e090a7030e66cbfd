"""Gradient units for convolutional layers.

The port's counterpart of `veles_tpu/znicz/gd_conv.py` (:29-123 there;
parity: reference `veles/znicz/gd_conv.py`): `GradientDescentConv`,
`GDTanhConv`, `GDRELUConv`, `GDStrictRELUConv` and `GDSigmoidConv`.
The activation's derivative is taken from the forward OUTPUT; the
convolution's is PyTorch's: `aten.convolution_backward` of the linear
convolution on its channels-last view — err_input, dW (back to HWIO) and
db in one call, with no forward recomputed — where the JAX unit takes
`jax.vjp`; the numpy backend runs the golden `reference.conv2d_backward`.
The update goes through the registry's `sgd_update` lowering, K1 on the
card.
"""

from __future__ import annotations

from typing import Any

import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz import conv
from veles_tpu_torch.znicz.nn_units import GradientDescentBase, dev, host, \
    register_gd


def conv2d_vjp(x: torch.Tensor, w: torch.Tensor, pre: torch.Tensor,
               stride, padding):
    """(err_x, dW, db) of y = conv2d(x, W) + b given dL/dy = `pre`, all
    NHWC / HWIO at the boundary."""
    gx, gw, gb = torch.ops.aten.convolution_backward(
        pre.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        fn.conv_weight_oihw(w), [w.shape[-1]], list(stride), list(padding),
        [1, 1], False, [0, 0], 1, [True, True, True])
    return (gx.permute(0, 2, 3, 1).contiguous(),
            gw.permute(2, 3, 1, 0).contiguous(), gb)


@register_gd(conv.Conv)
class GradientDescentConv(GradientDescentBase):
    """Backward of the Conv family; needs the twin's stride and padding,
    which `link_forward` captures with the standard data links."""

    activation = "linear"

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.stride = (1, 1)
        self.padding = (0, 0)

    def link_forward(self, fwd):
        self.stride = fwd.layer.stride
        self.padding = fwd.layer.padding
        return super().link_forward(fwd)

    def numpy_run(self) -> None:
        err_x, dw, db = ref.conv2d_backward(
            host(self.input), self.weights.mem, host(self.output),
            host(self.err_output), self.stride, self.padding,
            self.activation)
        self._update_host({"weights": dw, "bias": db})
        self.err_input.mem = err_x

    def torch_run(self) -> None:
        d = self.device
        pre = fn.act_backward(self.activation, dev(self.output, d),
                              dev(self.err_output, d))
        err_x, dw, db = conv2d_vjp(dev(self.input, d), self.weights.devmem(),
                                   pre, self.stride, self.padding)
        self.err_input.set_devmem(err_x)
        self._update({"weights": dw, "bias": db})


@register_gd(conv.ConvTanh)
class GDTanhConv(GradientDescentConv):
    activation = "tanh"


@register_gd(conv.ConvRELU)
class GDRELUConv(GradientDescentConv):
    activation = "relu"


@register_gd(conv.ConvStrictRELU)
class GDStrictRELUConv(GradientDescentConv):
    activation = "strictrelu"


@register_gd(conv.ConvSigmoid)
class GDSigmoidConv(GradientDescentConv):
    activation = "sigmoid"
