"""Fully-connected forward units (linear, scaled tanh, strict ReLU,
softmax head).

The port's counterpart of `veles_tpu/znicz/all2all.py`: y = act(x·W + b)
with W (fan_in, units) and image inputs flattened in NHWC (H·W·C) order.
`All2AllSoftmax` emits LOGITS, as the JAX package's fused path does; the
server applies the softmax.
"""

from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward


class All2All(Forward):
    """y = act(x·W + b); W: (fan_in, units)."""

    activation = "linear"

    def __init__(self, output_sample_shape: Union[int, Sequence[int]] = 10,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)

    @property
    def n_output(self) -> int:
        return int(np.prod(self.output_sample_shape))

    def initialize(self, sample_shape, device):
        fan_in = int(np.prod(sample_shape))
        self.init_params((fan_in, self.n_output), fan_in, device)
        return self.output_sample_shape

    def fused_apply(self, params, x, *, train=False):
        y = fn.all2all_forward(x, params["weights"], params["bias"],
                               self.activation)
        return y.reshape((-1,) + self.output_sample_shape)


class All2AllTanh(All2All):
    """y = 1.7159·tanh(0.6666·(x·W + b)), the reference's scaled tanh."""

    activation = "tanh"


class All2AllStrictRELU(All2All):
    activation = "strictrelu"


class All2AllSoftmax(All2All):
    """Linear layer whose softmax is applied by the consumer: the forward
    emits logits (all2all.py:125-130 in the JAX package)."""

    fused_emits_logits = True

    def fused_apply(self, params, x, *, train=False):
        return fn.all2all_forward(x, params["weights"], params["bias"])
