"""Max pooling unit.

The port's counterpart of `MaxPooling` in `veles_tpu/znicz/pooling.py`:
ceil-mode geometry (edge windows truncate) with -inf padding, stride
defaulting to the window. When an LRN unit precedes it and the
`lrn_maxpool` selection is a fused point, the LRN unit claims this unit's
work and it passes through (parallel/fused.py). The max-abs, average and
stochastic flavors wait for a later slice.

`MaxPoolingUnit` is the layer's node in the granular graph (JAX
pooling.py `numpy_run` / `xla_run`): the pooled output and, in
`input_offset`, each window's winner as a flat offset into the input, by
the JAX rule (the first maximum in row-major window order; the golden
`reference.maxpool_forward`, or `functional.maxpool_forward_with_idx`).
Its gradient twin, `GDMaxPooling`, is in gd_pooling.py.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, dev, host, \
    register_unit


class MaxPooling(Forward):
    #: the op name fusion pairing matches on (the JAX package's "maxpool"
    #: registry op; the port has one lowering, so no registry entry)
    variant_op = "maxpool"

    def __init__(self, ksize: Tuple[int, int] = (2, 2),
                 stride: Optional[Tuple[int, int]] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ksize = tuple(ksize)
        self.stride = tuple(stride) if stride is not None else self.ksize

    def initialize(self, sample_shape, device):
        h, w, c = sample_shape
        return fn.pool_out_hw(h, w, *self.ksize, *self.stride) + (c,)

    def fused_apply(self, params, x, *, train=False):
        return fn.maxpool_forward(x, self.ksize, self.stride)


@register_unit(MaxPooling)
class MaxPoolingUnit(ForwardUnit):
    """The pooled output and the winners' flat offsets (`input_offset`,
    int64), one firing per minibatch."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input_offset = Array()

    def numpy_run(self) -> None:
        u = self.layer
        y, idx = ref.maxpool_forward(host(self.input), u.ksize, u.stride)
        self.output.mem = y
        self.input_offset.mem = idx

    def torch_run(self) -> None:
        u = self.layer
        y, idx = fn.maxpool_forward_with_idx(dev(self.input, self.device),
                                             u.ksize, u.stride)
        self.output.set_devmem(y)
        self.input_offset.set_devmem(idx)
