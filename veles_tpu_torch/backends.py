"""Device choice for the port: the card by default, the CPU on request.

The port's counterpart of `veles_tpu/backends.py`. `make_device` gives the
`torch.device` the fused step, the server and the loops run on: asking
for the card where CUDA is absent raises; nothing falls back to the CPU
on its own. The granular unit graph dispatches on a backend `Device`
(`make_backend`): `NumpyDevice` (`backend_name` "numpy", the golden host
path of `ops/reference.py`) or `TorchDevice` ("torch", the counterpart of
the JAX package's `XLADevice`: each unit's `torch_run` on the card, or on
the CPU where that is asked for). Units read `torch_device` from either:
the numpy backend's is the CPU, where its parameters live.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

from veles_tpu_torch.logger import Logger

DeviceLike = Union[None, str, torch.device]


@contextlib.contextmanager
def full_f32(dev: Optional[torch.device]) -> Iterator[None]:
    """Accumulate the block's convolutions and matrix products in full f32
    on the card, whatever their input dtype. The flags are process-wide
    and read when an op is launched, so they are set for the block and
    restored after it; nothing to do on the CPU.

    - `torch.backends.cudnn.allow_tf32` off: PyTorch lets cuDNN run f32
      convolutions in TF32 by default, rounding their inputs to a 10-bit
      mantissa; off, f32 convolutions stay f32.
    - `torch.backends.cuda.matmul.allow_tf32` off: the same for f32
      matrix products (off by default already).
    - `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
      off: cuBLAS may otherwise add the split-K partial sums of a bf16
      GEMM in bf16; off, they are added in f32, as XLA accumulates a bf16
      product of the JAX step.
    """
    if dev is None or dev.type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def make_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card ("cuda"); "cpu" must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI --device cpu) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def device_name(dev: Optional[torch.device]) -> str:
    """Human-readable name of a device (the card's product name)."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


class Device(Logger):
    """Base backend device. `backend_name` selects which `<backend>_init`
    / `<backend>_run` methods an AcceleratedUnit dispatches to."""

    backend_name = "abstract"

    def __init__(self) -> None:
        self.pid = None

    @property
    def torch_device(self) -> torch.device:
        """Where the tensors of this backend's units live."""
        return torch.device("cpu")

    def sync(self) -> None:
        """Block until outstanding device work completes."""

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class NumpyDevice(Device):
    """Pure-host golden backend (parity: reference `NumpyDevice`)."""

    backend_name = "numpy"


class TorchDevice(Device):
    """The port's compute backend: one `torch.device`, the card unless the
    CPU is asked for (`make_device`'s rule)."""

    backend_name = "torch"

    def __init__(self, device: DeviceLike = None) -> None:
        super().__init__()
        self.device = make_device(device)

    @property
    def torch_device(self) -> torch.device:
        return self.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # a pickle keeps the device's kind; the card's index is this
    # process's
    def __getstate__(self):
        return {"type": self.device.type}

    def __setstate__(self, state):
        self.pid = None
        self.device = torch.device(state["type"])

    def __repr__(self) -> str:
        return f"<TorchDevice {self.device}>"


#: the backends of the granular graph, by their CLI names
BACKENDS = ("torch", "numpy")


def make_backend(backend: Optional[str] = None,
                 device: DeviceLike = None) -> Device:
    """The backend Device of a granular run: "torch" (the default) on
    `device` (the card unless "cpu" is asked for), or "numpy", which runs
    on the host whatever `device` says."""
    backend = backend or "torch"
    if backend == "numpy":
        return NumpyDevice()
    if backend == "torch":
        return TorchDevice(device)
    raise ValueError(f"unknown backend {backend!r} (expected one of "
                     f"{BACKENDS})")
