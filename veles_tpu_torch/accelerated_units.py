"""Backend-polymorphic units: the numpy golden path and the torch path.

The port's counterpart of `veles_tpu/accelerated_units.py` (parity:
reference `veles/accelerated_units.py`, `AcceleratedUnit`):
`initialize()` dispatches to `f"{backend}_init"` and `run()` to
`f"{backend}_run"`, the backend being the `backend_name` of the unit's
device (backends.py). `torch_*` takes the place of the JAX package's
`xla_*`: a unit's `torch_run` runs its work as tensor operations and the
port's kernels on the unit's device, and the default `torch_run` calls
`numpy_run`, so host-only units (the loader, the decision) need one code
path. A torch firing runs under `torch.no_grad()` and in full f32
(`backends.full_f32`: no TF32 convolutions or products on the card).
There is no jit: PyTorch runs eagerly, so the granular mode is the
debuggable one by construction.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from veles_tpu_torch.backends import Device, full_f32
from veles_tpu_torch.memory import target_device
from veles_tpu_torch.units import Unit


class AcceleratedUnit(Unit):
    """A unit whose work is device-dispatched."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.device: Optional[Device] = None

    @property
    def backend(self) -> str:
        """Dispatch key from Device.backend_name; a None device (host-only
        use, tests) resolves to "torch" on the CPU."""
        return getattr(self.device, "backend_name", "torch")

    @property
    def torch_device(self) -> torch.device:
        """Where this unit's tensors live (the CPU without a device)."""
        return target_device(self.device)

    def initialize(self, device: Optional[Device] = None,
                   **kwargs: Any) -> Optional[bool]:
        self.device = device
        ret = getattr(self, f"{self.backend}_init")()
        if ret is False:
            return False
        return super().initialize(device=device, **kwargs)

    def run(self) -> None:
        if self.backend == "torch":
            # a granular firing records no autograd graph, and computes in
            # full f32 on the card (backends.full_f32), as the fused f32
            # step does
            with torch.no_grad(), full_f32(self.torch_device):
                self.torch_run()
            return
        getattr(self, f"{self.backend}_run")()

    # Override points. Default: torch falls back to the numpy
    # implementation so host-side units need only one code path.
    def numpy_init(self) -> Optional[bool]:
        return None

    def torch_init(self) -> Optional[bool]:
        return self.numpy_init()

    def numpy_run(self) -> None:
        pass

    def torch_run(self) -> None:
        self.numpy_run()
