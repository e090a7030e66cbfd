"""Pooling units: max, max-abs, average and stochastic.

The port's counterparts of `MaxPooling`, `MaxAbsPooling`, `AvgPooling`
and `StochasticPooling` in `veles_tpu/znicz/pooling.py`: ceil-mode
geometry (edge windows truncate), stride defaulting to the window.

- Max pooling pads with -inf. When an LRN unit precedes it and the
  `lrn_maxpool` selection is a fused point, the LRN unit claims its work
  and it passes through (parallel/fused.py).
- Max-abs pooling keeps the signed value of each window's largest |x|,
  the first in row-major window order on a tie (the JAX fused lowering,
  the gather of `maxpool_forward_with_idx`). It never fuses with an LRN.
- Average pooling divides each window's sum by the pixels it covers.
- Stochastic pooling samples a window element with probability
  proportional to its positive part (Gumbel-max); a window with nothing
  positive gives 0. The fused step hands it the step's generator (the
  registry's device stream, as dropout's); at evaluation it averages, as
  the JAX unit does.

Each layer's node in the granular graph (JAX pooling.py `numpy_run` /
`xla_run`) runs the golden of ops/reference.py on the numpy backend and
the functional op on the unit's device on the torch one. The flavors that
record winners keep them in `input_offset`, flat int64 offsets into the
input by the JAX rule; the stochastic node draws its numpy samples from
the default generator's numpy stream, as the JAX numpy path does, and its
torch samples from the registry's device stream. The gradient units are
in gd_pooling.py.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, dev, host, \
    register_unit


class Pooling(Forward):
    """The common geometry: ksize (ky, kx), stride defaulting to ksize,
    the ceil-mode output size; no parameters."""

    def __init__(self, ksize: Tuple[int, int] = (2, 2),
                 stride: Optional[Tuple[int, int]] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ksize = tuple(ksize)
        self.stride = tuple(stride) if stride is not None else self.ksize

    def initialize(self, sample_shape, device):
        h, w, c = sample_shape
        return fn.pool_out_hw(h, w, *self.ksize, *self.stride) + (c,)


class MaxPooling(Pooling):
    #: the op name fusion pairing matches on (the JAX package's "maxpool"
    #: registry op; the port has one lowering, so no registry entry)
    variant_op = "maxpool"
    use_abs = False

    def fused_apply(self, params, x, *, train=False):
        if self.use_abs:
            return fn.maxpool_forward_with_idx(x, self.ksize, self.stride,
                                               use_abs=True)[0]
        return fn.maxpool_forward(x, self.ksize, self.stride)


class MaxAbsPooling(MaxPooling):
    use_abs = True


class AvgPooling(Pooling):

    def fused_apply(self, params, x, *, train=False):
        return fn.avgpool_forward(x, self.ksize, self.stride)


class StochasticPooling(Pooling):

    fused_needs_gen = True

    def fused_apply(self, params, x, *, train=False, gen=None):
        if not train:   # deterministic at evaluation: the average
            return fn.avgpool_forward(x, self.ksize, self.stride)
        if gen is None:
            raise ValueError("a training stochastic pooling needs the "
                             "step's torch.Generator (gen=)")
        return fn.stochastic_pool_forward_with_idx(
            x, self.ksize, self.stride, generator=gen)[0]


@register_unit(MaxPooling)
class MaxPoolingUnit(ForwardUnit):
    """The pooled output and the winners' flat offsets (`input_offset`,
    int64), one firing per minibatch; max or max-abs by the layer."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input_offset = Array()

    def numpy_run(self) -> None:
        u = self.layer
        y, idx = ref.maxpool_forward(host(self.input), u.ksize, u.stride,
                                     u.use_abs)
        self.output.mem = y
        self.input_offset.mem = idx

    def torch_run(self) -> None:
        u = self.layer
        y, idx = fn.maxpool_forward_with_idx(dev(self.input, self.device),
                                             u.ksize, u.stride, u.use_abs)
        self.output.set_devmem(y)
        self.input_offset.set_devmem(idx)


@register_unit(AvgPooling)
class AvgPoolingUnit(ForwardUnit):
    """The averaged output, one firing per minibatch."""

    def numpy_run(self) -> None:
        u = self.layer
        self.output.mem = ref.avgpool_forward(host(self.input), u.ksize,
                                              u.stride)

    def torch_run(self) -> None:
        u = self.layer
        self.output.set_devmem(fn.avgpool_forward(
            dev(self.input, self.device), u.ksize, u.stride))


@register_unit(StochasticPooling)
class StochasticPoolingUnit(MaxPoolingUnit):
    """A sample per window and its flat offset (`input_offset`; x.size
    for a window with nothing positive), drawn anew at every firing,
    validation minibatches included, as the JAX unit draws them."""

    def numpy_run(self) -> None:
        u = self.layer
        y, idx = ref.stochastic_pool_forward(
            host(self.input), prng.get().state, u.ksize, u.stride)
        self.output.mem = y
        self.input_offset.mem = idx

    def torch_run(self) -> None:
        u = self.layer
        d = self.torch_device
        y, idx = fn.stochastic_pool_forward_with_idx(
            dev(self.input, d), u.ksize, u.stride,
            generator=prng.get().device_stream(d))
        self.output.set_devmem(y)
        self.input_offset.set_devmem(idx)
