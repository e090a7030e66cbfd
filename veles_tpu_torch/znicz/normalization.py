"""Local response normalization (AlexNet-style, across channels) and the
input normalization layer.

The port's counterpart of `LRNormalizerForward` in
`veles_tpu/znicz/normalization.py`: y = x·(k + α·Σ_window x²)^(−β) over a
window of n channels (odd n only). Its forward resolves the registry op
`lrn` (ops/variants.py) — K2 forward and K3 backward on the card. When
the `lrn_maxpool` selection is a fused point and a max pooling follows,
the fused forward lets this unit claim the pooling's work
(parallel/fused.py).

In the granular graph, `LRNormalizerUnit` runs the layer's forward (the
golden `reference.lrn_forward`, or the registry's `lrn` lowering: K2 on
the card) and `LRNormalizerBackward`, its gradient twin (JAX
normalization.py:152-193), the closed-form backward (the golden
`reference.lrn_backward`, or K3 on the card: `kernels.lrn_backward`,
which raises on the card rather than take its plain version). The
granular graph claims no pooling: its LRN and pooling units run
separately.

`InputNormalize` (JAX normalization.py:196-287): y = x·scale + offset −
mean image, a parameterless leading layer for a loader that ships raw
uint8 (the loader's `mean_image` where `use_loader_mean`), computed by
the fused step's prologue function (`parallel/fused.py`
`apply_input_normalize`) in both modes, on the numpy backend by the
same formula in numpy. Its gradient unit, `GDInputNormalize`, multiplies
the error by `scale` (the affine's derivative; the input may be uint8).
A graph that holds this layer normalizes on the card itself, so the
fused loop negotiates no uint8 wire prologue for it
(`StandardWorkflow._wire_spec`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from veles_tpu_torch.ops import kernels
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.ops import variants
from veles_tpu_torch.parallel import fused
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, \
    GradientDescentBase, dev, host, register_gd, register_unit


class LRNormalizerForward(Forward):
    variant_op = "lrn"

    def __init__(self, k: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75, n: int = 5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if n % 2 == 0:
            # every twin (kernels, plain version, JAX package, goldens)
            # uses a ±n//2 window; even n would mean n+1 taps
            raise ValueError(f"LRN window n must be odd, got {n}")
        self.k = k
        self.alpha = alpha
        self.beta = beta
        self.n = n

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def variant_signature(self, sample_shape) -> Optional[Dict[str, Any]]:
        """The kernel search's cache-key payload of this layer at its
        per-sample input shape (JAX normalization.py:126-136; the batch is
        left out, so a winner applies at any batch); None under a
        per-layer override."""
        if self.variant_override is not None:
            return None
        return {"sample_shape": list(sample_shape), "dtype": "float32",
                "params": {"k": self.k, "alpha": self.alpha,
                           "beta": self.beta, "n": self.n}}

    def fused_apply(self, params, x, *, train=False, variant=None):
        """`variant`: the lowering a fused forward resolved for this unit
        at build time; None resolves it now."""
        v = variant or variants.resolve("lrn", unit=self)
        return v.apply(x, k=self.k, alpha=self.alpha, beta=self.beta,
                       n=self.n)


@register_unit(LRNormalizerForward)
class LRNormalizerUnit(ForwardUnit):
    """The layer's forward, one firing per minibatch."""

    def numpy_run(self) -> None:
        u = self.layer
        self.output.mem = ref.lrn_forward(host(self.input), u.k, u.alpha,
                                          u.beta, u.n)

    def torch_run(self) -> None:
        u = self.layer
        self.output.set_devmem(u.fused_apply(
            {}, dev(self.input, self.device).contiguous()))


@register_gd(LRNormalizerForward)
class LRNormalizerBackward(GradientDescentBase):
    """err_input = the LRN's gradient at `input` given `err_output`."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.k = 2.0
        self.alpha = 1e-4
        self.beta = 0.75
        self.n = 5

    def link_forward(self, fwd):
        u = fwd.layer
        self.k, self.alpha, self.beta, self.n = u.k, u.alpha, u.beta, u.n
        return super().link_forward(fwd)

    def numpy_run(self) -> None:
        self.err_input.mem = ref.lrn_backward(
            host(self.input), host(self.err_output), self.k, self.alpha,
            self.beta, self.n)

    def torch_run(self) -> None:
        d = self.device
        self.err_input.set_devmem(kernels.lrn_backward(
            dev(self.input, d).contiguous(),
            dev(self.err_output, d).contiguous(), self.k, self.alpha,
            self.beta, self.n))


class InputNormalize(Forward):
    """y = x·scale + offset − mean, x uint8 or float."""

    def __init__(self, scale: float = 1.0 / 127.5, offset: float = -1.0,
                 use_loader_mean: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.scale = scale
        self.offset = offset
        self.use_loader_mean = use_loader_mean
        #: the loader's mean image (host f32), set when the graph
        #: initializes; None without one
        self.mean: Optional[np.ndarray] = None

    def initialize(self, sample_shape, device):
        return tuple(sample_shape)

    def spec(self) -> Dict[str, Any]:
        return {"scale": self.scale, "offset": self.offset,
                "mean": self.mean}

    def fused_apply(self, params, x, *, train=False):
        # a floating x keeps its dtype (the fused step's bf16 entry
        # cast); an integer one computes in f32, as the JAX layer does
        return fused.apply_input_normalize(
            self.spec(), x, x.dtype if x.is_floating_point() else None)


@register_unit(InputNormalize)
class InputNormalizeUnit(ForwardUnit):
    """The layer's affine, one firing per minibatch; reads the loader's
    mean image when it initializes."""

    def link_loader(self, loader) -> None:
        self._loader = loader

    def initialize(self, device=None, **kwargs: Any):
        u = self.layer
        if u.use_loader_mean and u.mean is None:
            u.mean = getattr(self.__dict__.get("_loader"), "mean_image",
                             None)
        return super().initialize(device=device, **kwargs)

    def numpy_run(self) -> None:
        u = self.layer
        y = host(self.input).astype(np.float32) * u.scale + u.offset
        if u.mean is not None:
            y = y - u.mean
        self.output.mem = y

    def torch_run(self) -> None:
        self.output.set_devmem(fused.apply_input_normalize(
            self.layer.spec(), dev(self.input, self.device)))


@register_gd(InputNormalize)
class GDInputNormalize(GradientDescentBase):
    """err_input = err_output·scale; no parameters, no update."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.scale = 1.0

    def link_forward(self, fwd):
        self.scale = fwd.layer.scale
        return super().link_forward(fwd)

    def numpy_run(self) -> None:
        self.err_input.mem = host(self.err_output) * self.scale

    def torch_run(self) -> None:
        err = dev(self.err_output, self.device)
        self.err_input.set_devmem(err * self.scale)
