"""Pooling units: max, max-abs, average and stochastic.

The port's counterparts of `MaxPooling`, `MaxAbsPooling`, `AvgPooling`
and `StochasticPooling` in `veles_tpu/znicz/pooling.py`: ceil-mode
geometry (edge windows truncate), stride defaulting to the window.

- Max pooling pads with -inf, through the registry op `maxpool` in the
  fused step (`reduce_window` by default, or `slices`; `lowering=` pins
  the layer's). When an LRN unit precedes it and the `lrn_maxpool`
  selection is a fused point, the LRN unit claims its work and it passes
  through (parallel/fused.py).
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

from typing import Any, Dict, Optional, Tuple

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Array
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.ops import variants
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, dev, host, \
    register_unit


class Pooling(Forward):
    """The common geometry: ksize (ky, kx), stride defaulting to ksize,
    the ceil-mode output size; no parameters."""

    #: per channel: runs on a tensor-parallel rank's channels
    tp_channel_local = True

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
    """Max pooling through the registry op `maxpool` (its lowering
    decides the backward: `reduce_window`, the default, or `slices`);
    `lowering` pins this layer's, as the JAX unit's does."""

    variant_op = "maxpool"
    use_abs = False

    def __init__(self, ksize: Tuple[int, int] = (2, 2),
                 stride: Optional[Tuple[int, int]] = None,
                 lowering: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(ksize, stride, **kwargs)
        if lowering is not None:
            variants.get("maxpool", lowering)   # validates
        self.variant_override = lowering

    def variant_signature(self, sample_shape) -> Optional[Dict[str, Any]]:
        """The kernel search's cache-key payload at the per-sample input
        shape (JAX pooling.py:112-120); None under a per-layer override."""
        if self.variant_override is not None:
            return None
        return {"sample_shape": list(sample_shape), "dtype": "float32",
                "params": {"ksize": list(self.ksize),
                           "stride": list(self.stride),
                           "use_abs": bool(self.use_abs)}}

    def fused_apply(self, params, x, *, train=False, variant=None):
        """`variant`: the lowering the fused forward resolved at build
        time; None resolves it now."""
        v = variant or variants.resolve("maxpool", unit=self)
        return v.apply(x, self.ksize, self.stride, self.use_abs)


class MaxAbsPooling(MaxPooling):
    use_abs = True


class AvgPooling(Pooling):

    def fused_apply(self, params, x, *, train=False):
        return fn.avgpool_forward(x, self.ksize, self.stride)


class StochasticPooling(Pooling):

    fused_needs_gen = True

    def fused_apply(self, params, x, *, train=False, gen=None, part=None):
        """`part` (parallel/tp.py `RankPart`): x is a block of the global
        batch's activation; the noise is drawn for the whole, (N, OH, OW,
        C, ky·kx), and the block kept."""
        if not train:   # deterministic at evaluation: the average
            return fn.avgpool_forward(x, self.ksize, self.stride)
        if gen is None:
            raise ValueError("a training stochastic pooling needs the "
                             "step's torch.Generator (gen=)")
        if part is None:
            return fn.stochastic_pool_forward_with_idx(
                x, self.ksize, self.stride, generator=gen)[0]
        oh, ow = fn.pool_out_hw(x.shape[1], x.shape[2], *self.ksize,
                                *self.stride)
        shape = part.global_shape((x.shape[0], oh, ow, x.shape[-1],
                                   self.ksize[0] * self.ksize[1]), -2)
        return fn.stochastic_pool_forward_with_idx(
            x, self.ksize, self.stride,
            noise=part.take(fn.gumbel_noise(shape, gen, x.device, x.dtype),
                            -2))[0]


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
