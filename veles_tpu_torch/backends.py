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
    """Run the block's convolutions and matrix products in full f32 on
    the card. PyTorch lets cuDNN convolutions use TF32 by default, which
    rounds their inputs to a 10-bit mantissa. The two flags are
    process-wide and read when an op is launched, so they are cleared for
    the block and restored after it. Nothing to do on the CPU."""
    if dev is None or dev.type != "cuda":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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
