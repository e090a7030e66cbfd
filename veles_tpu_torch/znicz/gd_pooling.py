"""Gradient units of the pooling layers.

The port's counterparts of `GDMaxPooling`, `GDMaxAbsPooling`,
`GDStochasticPooling` and `GDAvgPooling` in
`veles_tpu/znicz/gd_pooling.py` (:73-108 there; parity: reference
`veles/znicz/gd_pooling.py`): no parameters, only the error's routing.
`GDMaxPooling` serves the three flavors that record winners (the
max-abs layer is a max pooling).

- The flavors whose forward records winners (max, max-abs, stochastic)
  add each window's error at the flat winner offset in `input_offset`:
  the golden `reference.stochastic_pool_backward` (the JAX numpy path's
  scatter, which drops out-of-range sentinel offsets), or
  `functional.pool_scatter` on the unit's device, which drops them too.
  Windows that overlap (AlexNet's 3×3/2) and share a winner add there.
- Average pooling spreads each window's error over the pixels it covers,
  divided by their count: the golden `reference.avgpool_backward`, or
  `functional.avgpool_backward`.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz import pooling
from veles_tpu_torch.znicz.nn_units import GradientDescentBase, dev, host, \
    register_gd, shape_of


class GDPoolingBase(GradientDescentBase):
    """No parameters: the twin's geometry, captured in link_forward."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.ksize = (2, 2)
        self.stride = (2, 2)

    def link_forward(self, fwd):
        self.ksize = fwd.layer.ksize
        self.stride = fwd.layer.stride
        return super().link_forward(fwd)


@register_gd(pooling.MaxPooling)
@register_gd(pooling.StochasticPooling)
class GDMaxPooling(GDPoolingBase):
    """err_input = err_output scattered to the recorded winners (the max,
    max-abs and stochastic flavors)."""

    def link_forward(self, fwd):
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


@register_gd(pooling.AvgPooling)
class GDAvgPooling(GDPoolingBase):
    """err_input = each window's error over its pixel count, spread over
    the window."""

    def numpy_run(self) -> None:
        self.err_input.mem = ref.avgpool_backward(
            host(self.err_output), shape_of(self.input), self.ksize,
            self.stride)

    def torch_run(self) -> None:
        self.err_input.set_devmem(fn.avgpool_backward(
            dev(self.err_output, self.device), shape_of(self.input),
            self.ksize, self.stride))
