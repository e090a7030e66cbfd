"""Dropout unit: y = x·mask while training, the identity otherwise.

The port's counterpart of `DropoutForward` in
`veles_tpu/znicz/dropout.py` (dropout.py:74-78 there): the mask is
pre-scaled, (u < keep) / keep. The JAX package draws u from the step's
key folded with the unit's index; the port draws it from the step's
explicit `torch.Generator`, which the fused forward hands to this unit.
The two streams cannot agree, so the parity tests replace `make_mask`,
the one function every mask comes from, with the JAX package's masks.

In the granular graph, `DropoutUnit` (JAX dropout.py:80-107) applies a
mask on TRAIN minibatches (`minibatch_class`, linked from the loader)
and keeps it in `mask` for `DropoutBackward` (:109-140 there), which
multiplies the error by it. The numpy backend draws the mask from the
default generator's numpy stream with the golden
`reference.make_dropout_mask`, as the JAX numpy path does, bit for bit;
the torch backend through `make_mask` from the registry's device stream
(`prng.RandomGenerator.device_stream`), a new mask at every firing.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch import prng
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, \
    GradientDescentBase, dev, host, register_gd, register_unit, shape_of

#: where every training mask comes from: (shape, drop_prob, generator,
#: device, dtype=) -> pre-scaled mask
make_mask = fn.dropout_mask


class DropoutForward(Forward):

    fused_needs_gen = True
    #: elementwise: runs on a tensor-parallel rank's channels
    tp_channel_local = True

    def __init__(self, dropout_ratio: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.dropout_ratio = dropout_ratio

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def fused_apply(self, params, x, *, train=False, gen=None, part=None):
        """`part` (parallel/tp.py `RankPart`): x is a block of the global
        batch's activation; the mask is drawn for the whole and the
        block kept, so every rank of a model group draws the same."""
        if not train:
            return x
        if gen is None:
            raise ValueError("a training dropout needs the step's "
                             "torch.Generator (gen=)")
        # the mask in x's dtype (the compute dtype), as the JAX unit
        # draws it (dropout.py:84 there)
        if part is None:
            return x * make_mask(x.shape, self.dropout_ratio, gen,
                                 x.device, dtype=x.dtype)
        return x * part.take(make_mask(part.global_shape(x.shape),
                                       self.dropout_ratio, gen, x.device,
                                       dtype=x.dtype))


@register_unit(DropoutForward)
class DropoutUnit(ForwardUnit):
    """y = x·mask on TRAIN minibatches, the identity on the others."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.mask = Array()
        self.minibatch_class = TRAIN

    def link_loader(self, loader) -> None:
        self.link_attrs(loader, "minibatch_class")

    @property
    def training(self) -> bool:
        return self.minibatch_class == TRAIN

    def numpy_run(self) -> None:
        x = host(self.input)
        if not self.training:
            self.output.mem = x.copy()
            return
        self.mask.mem = ref.make_dropout_mask(
            prng.get().state, shape_of(self.input),
            self.layer.dropout_ratio)
        self.output.mem = ref.dropout_forward(x, self.mask.mem)

    def torch_run(self) -> None:
        d = self.torch_device
        x = dev(self.input, d)
        if not self.training:
            self.output.set_devmem(x)
            return
        mask = make_mask(x.shape, self.layer.dropout_ratio,
                         prng.get().device_stream(d), d, dtype=x.dtype)
        self.mask.set_devmem(mask)
        self.output.set_devmem(x * mask)


@register_gd(DropoutForward)
class DropoutBackward(GradientDescentBase):
    """err_input = err_output·mask (the identity before any training
    forward made a mask)."""

    def link_forward(self, fwd):
        super().link_forward(fwd)
        self.link_attrs(fwd, "mask")
        return self

    def numpy_run(self) -> None:
        err = host(self.err_output)
        if not self.mask:
            self.err_input.mem = err.copy()
            return
        self.err_input.mem = ref.dropout_backward(err, self.mask.mem)

    def torch_run(self) -> None:
        err = dev(self.err_output, self.device)
        if not self.mask:
            self.err_input.set_devmem(err)
            return
        self.err_input.set_devmem(err * self.mask.devmem(self.device))
