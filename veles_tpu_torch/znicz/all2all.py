"""Fully-connected forward units (linear, scaled tanh, strict ReLU,
softmax head).

The port's counterpart of `veles_tpu/znicz/all2all.py`: y = act(x·W + b)
with W (fan_in, units) and image inputs flattened in NHWC (H·W·C) order.
`All2AllSoftmax` emits LOGITS, as the JAX package's fused path does; the
server applies the softmax.

`All2AllUnit` and `All2AllSoftmaxUnit` are the layers' nodes in the
granular graph (JAX all2all.py `numpy_run` / `xla_run`); the softmax node
outputs PROBABILITIES and `max_idx`, the per-sample argmax, as the JAX
granular unit does. Their gradient twins are in gd.py.
"""

from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, dev, host, \
    register_unit


def _product(x, params, activation, reduce=None):
    """act(x·W + b); under `reduce` the product is summed by it before
    the bias."""
    if reduce is None:
        return fn.all2all_forward(x, params["weights"], params["bias"],
                                  activation)
    y = reduce(x.reshape(x.shape[0], -1) @ params["weights"])
    return fn.act_forward(activation, y + params["bias"])


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

    def fused_apply(self, params, x, *, train=False, reduce=None):
        """`reduce`: tensor parallelism's row-parallel sum
        (parallel/tp.py), applied to the product of this rank's input
        rows before the bias and the activation. A column shard (fewer
        outputs than the layer's) stays flat."""
        y = _product(x, params, self.activation, reduce)
        if y.shape[-1] != self.n_output:
            return y
        return y.reshape((-1,) + self.output_sample_shape)


class All2AllTanh(All2All):
    """y = 1.7159·tanh(0.6666·(x·W + b)), the reference's scaled tanh."""

    activation = "tanh"


class All2AllRELU(All2All):
    """y = ln(1 + e^(x·W + b)), the reference's smooth RELU."""

    activation = "relu"


class All2AllStrictRELU(All2All):
    activation = "strictrelu"


class All2AllSigmoid(All2All):
    activation = "sigmoid"


class All2AllSoftmax(All2All):
    """Linear layer whose softmax is applied by the consumer: the forward
    emits logits (all2all.py:125-130 in the JAX package)."""

    fused_emits_logits = True

    def fused_apply(self, params, x, *, train=False, reduce=None):
        return _product(x, params, "linear", reduce)


@register_unit(All2All)
class All2AllUnit(ForwardUnit):
    """y = act(x·W + b) of the layer, one firing per minibatch."""

    def numpy_run(self) -> None:
        a = self.layer
        self.output.mem = ref.all2all_forward(
            host(self.input), self.weights.mem, self.bias.mem,
            a.activation).reshape((-1,) + a.output_sample_shape)

    def torch_run(self) -> None:
        a = self.layer
        self.output.set_devmem(a.fused_apply(
            a.param_arrays(), dev(self.input, self.device)))


@register_unit(All2AllSoftmax)
class All2AllSoftmaxUnit(ForwardUnit):
    """softmax(x·W + b): `output` holds the probabilities, `max_idx` the
    per-sample argmax (the reference kernel emitted it for the
    evaluator)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.max_idx = Array()

    def numpy_run(self) -> None:
        x = host(self.input)
        x2 = x.reshape(len(x), -1)
        probs = ref.softmax(x2 @ self.weights.mem + self.bias.mem)
        self.output.mem = probs
        self.max_idx.mem = probs.argmax(axis=1)

    def torch_run(self) -> None:
        a = self.layer
        probs = torch.softmax(a.fused_apply(
            a.param_arrays(), dev(self.input, self.device)), dim=-1)
        self.output.set_devmem(probs)
        self.max_idx.set_devmem(probs.argmax(dim=1))
