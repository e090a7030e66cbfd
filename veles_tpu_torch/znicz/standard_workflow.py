"""StandardWorkflow: the forward chain built from a declarative layer list.

The port's counterpart of `veles_tpu/znicz/standard_workflow.py`, reduced
to the serving slice: a loader plus the forward units of `layers`
(`{"type": <name>, ...kwargs}` dicts resolved through `LAYER_TYPES`).
`initialize(device)` initializes the loader (its seeded train shuffle
comes first, as in the JAX package) and then each forward unit in order,
propagating sample shapes and filling parameters from the same numpy
streams. The evaluator, decision, gradient chain and the Unit/Workflow
gate graph come with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from veles_tpu_torch.backends import DeviceLike, make_device
from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.znicz import all2all, conv, dropout, normalization, \
    pooling
from veles_tpu_torch.znicz.nn_units import Forward

#: layer-type name -> forward unit class
#: (the serving slice's types; the JAX package's other activation
#: flavors come with a later slice)
LAYER_TYPES: Dict[str, type] = {
    "all2all": all2all.All2All,
    "all2all_strictrelu": all2all.All2AllStrictRELU,
    "softmax": all2all.All2AllSoftmax,
    "conv": conv.Conv,
    "conv_strictrelu": conv.ConvStrictRELU,
    "norm": normalization.LRNormalizerForward,
    "lrn": normalization.LRNormalizerForward,
    "max_pooling": pooling.MaxPooling,
    "dropout": dropout.DropoutForward,
}


class StandardWorkflow:
    """loader + declarative layer list -> the forward chain."""

    def __init__(self, layers: Sequence[Dict[str, Any]] = (),
                 loader: Optional[Loader] = None, loss: str = "softmax",
                 n_classes: int = 10,
                 name: Optional[str] = None) -> None:
        if loader is None:
            raise ValueError("StandardWorkflow needs a loader")
        if loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {loss!r}")
        self.name = name or type(self).__name__
        self.layers_config = list(layers)
        self.loss = loss
        self.n_classes = n_classes
        self.loader = loader
        units: List[Forward] = []
        for spec in self.layers_config:
            spec = dict(spec)
            kind = spec.pop("type")
            if kind not in LAYER_TYPES:
                raise ValueError(
                    f"unknown layer type {kind!r}; registered types: "
                    f"{sorted(LAYER_TYPES)}")
            units.append(LAYER_TYPES[kind](**spec))
        self.forwards = nn.ModuleList(units)
        self.device: Optional[torch.device] = None

    @property
    def is_initialized(self) -> bool:
        return self.device is not None

    def initialize(self, device: DeviceLike = None) -> None:
        """Initialize the loader, then each forward unit in order, with its
        parameters on `device` (the card unless "cpu" is asked for)."""
        dev = make_device(device)
        self.loader.initialize()
        shape: Tuple[int, ...] = tuple(self.loader.sample_shape)
        for u in self.forwards:
            shape = tuple(u.initialize(shape, dev))
        self.device = dev

    def to(self, device: DeviceLike) -> "StandardWorkflow":
        """Move the initialized parameters to `device`."""
        dev = make_device(device)
        self.forwards.to(dev)
        self.device = dev
        return self

    def params_host(self) -> Tuple[Dict[str, np.ndarray], ...]:
        """One `{name: ndarray}` per forward unit — the format the JAX
        package's server builds (serving.py:539-541)."""
        return tuple({k: t.detach().cpu().numpy()
                      for k, t in u.param_arrays().items()}
                     for u in self.forwards)

    def build_forward(self):
        """The fused forward over this workflow's units (see
        parallel/fused.py); resolves its lowerings now."""
        from veles_tpu_torch.parallel.fused import FusedForward
        return FusedForward(self)
