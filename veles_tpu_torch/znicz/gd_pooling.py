"""Gradient unit of the max pooling layer.

The port's counterpart of `GDMaxPooling` in `veles_tpu/znicz/gd_pooling.py`
(:51-76 there; parity: reference `veles/znicz/gd_pooling.py`): no
parameters, only the error's routing. Each window's error is added at the
flat winner offset its forward recorded (`input_offset`): the golden
`reference.stochastic_pool_backward` (the JAX numpy path's scatter, which
drops out-of-range sentinel offsets), or `functional.pool_scatter` on the
unit's device. Windows that overlap (AlexNet's 3×3/2) and share a winner
add there. The max-abs, average and stochastic flavors come with their
forwards.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz import pooling
from veles_tpu_torch.znicz.nn_units import GradientDescentBase, dev, host, \
    register_gd, shape_of


@register_gd(pooling.MaxPooling)
class GDMaxPooling(GradientDescentBase):
    """err_input = err_output scattered to the recorded winners."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.ksize = (2, 2)
        self.stride = (2, 2)

    def link_forward(self, fwd):
        self.ksize = fwd.layer.ksize
        self.stride = fwd.layer.stride
        super().link_forward(fwd)
        self.link_attrs(fwd, "input_offset")
        return self

    def numpy_run(self) -> None:
        self.err_input.mem = ref.stochastic_pool_backward(
            host(self.err_output), self.input_offset.mem,
            shape_of(self.input))

    def torch_run(self) -> None:
        d = self.device
        self.err_input.set_devmem(fn.pool_scatter(
            dev(self.err_output, d), self.input_offset.devmem(d),
            shape_of(self.input)))
