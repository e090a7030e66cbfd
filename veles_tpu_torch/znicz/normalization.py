"""Local response normalization unit (AlexNet-style, across channels).

The port's counterpart of `LRNormalizerForward` in
`veles_tpu/znicz/normalization.py`: y = x·(k + α·Σ_window x²)^(−β) over a
window of n channels (odd n only). Its forward resolves the registry op
`lrn` (ops/variants.py) — K2 forward and K3 backward on the card. When
the `lrn_maxpool` selection is a fused point and a max pooling follows,
the fused forward lets this unit claim the pooling's work
(parallel/fused.py).
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.ops import variants
from veles_tpu_torch.znicz.nn_units import Forward


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

    def fused_apply(self, params, x, *, train=False, variant=None):
        """`variant`: the lowering a fused forward resolved for this unit
        at build time; None resolves it now."""
        v = variant or variants.resolve("lrn", unit=self)
        return v.apply(x, k=self.k, alpha=self.alpha, beta=self.beta,
                       n=self.n)
