"""Device choice for the port: the card by default, the CPU on request.

The port's counterpart of `veles_tpu/backends.py`, reduced to a
`torch.device`. Asking for the card where CUDA is absent raises;
nothing falls back to the CPU on its own. (The `Array` of `memory.py` and
the granular per-unit backend dispatch come with a later slice.)
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

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
