"""Dropout unit: y = x·mask while training, the identity otherwise.

The port's counterpart of `DropoutForward` in
`veles_tpu/znicz/dropout.py` (dropout.py:74-78 there): the mask is
pre-scaled, (u < keep) / keep. The JAX package draws u from the step's
key folded with the unit's index; the port draws it from the step's
explicit `torch.Generator`, which the fused forward hands to this unit.
The two streams cannot agree, so the parity tests replace `make_mask`,
the one function every mask comes from, with the JAX package's masks.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward

#: where every training mask comes from: (shape, drop_prob, generator,
#: device, dtype=) -> pre-scaled mask
make_mask = fn.dropout_mask


class DropoutForward(Forward):

    fused_needs_gen = True

    def __init__(self, dropout_ratio: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.dropout_ratio = dropout_ratio

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def fused_apply(self, params, x, *, train=False, gen=None):
        if not train:
            return x
        if gen is None:
            raise ValueError("a training dropout needs the step's "
                             "torch.Generator (gen=)")
        # the mask in x's dtype (the compute dtype), as the JAX unit
        # draws it (dropout.py:84 there)
        return x * make_mask(x.shape, self.dropout_ratio, gen, x.device,
                             dtype=x.dtype)
