"""Max pooling unit.

The port's counterpart of `MaxPooling` in `veles_tpu/znicz/pooling.py`:
ceil-mode geometry (edge windows truncate) with -inf padding, stride
defaulting to the window. When an LRN unit precedes it and the
`lrn_maxpool` selection is a fused point, the LRN unit claims this unit's
work and it passes through (parallel/fused.py). The max-abs, average and
stochastic flavors wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward


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
