"""Array: the host/device memory model of the granular units.

The port's counterpart of `veles_tpu/memory.py` (parity: reference
`veles/memory.py`, `Array`): a host numpy array paired with a device
buffer, here a torch tensor, with the reference's explicit coherence
(`map_read` / `map_write` / `map_invalidate` / `unmap`) and a pickle of
the host side only, so snapshots hold no device memory.

- `mem` is the host view, pulled from the device when the device side is
  fresher; `devmem(device)` is the tensor on the unit's device (a
  `backends.Device`, a `torch.device`, or None for the CPU), pushed from
  the host when the host side is fresher; `set_devmem(t)` stores a
  device result with no host transfer until someone maps for read.
- On the CPU the two sides are one memory: the host view of a CPU tensor
  is `tensor.numpy()` and the tensor of a host array is
  `torch.from_numpy(array)`, so both stay fresh and a write through
  either is the other's.

`TensorView` is an Array over a tensor that another object keeps — a
layer's `nn.Parameter`, a gradient unit's velocity: it reads the tensor
where it is when asked and writes into it in place, so the granular
units, the fused step and a snapshot all see one set of weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def target_device(device) -> torch.device:
    """The torch device behind `device`: a `backends.Device` (its
    `torch_device`), a torch device or its name; None and the numpy
    backend mean the host CPU."""
    if device is None:
        return torch.device("cpu")
    if isinstance(device, (str, torch.device)):
        return torch.device(device)
    return torch.device(getattr(device, "torch_device", None) or "cpu")


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """`a` as a CPU tensor sharing its memory (a copy only where numpy
    marks it read-only)."""
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class Array:
    """Host numpy array + lazily materialized torch tensor."""

    def __init__(self, data: Optional[Any] = None) -> None:
        self._host: Optional[np.ndarray] = None
        self._dev: Optional[torch.Tensor] = None
        self._host_fresh = True    # which side holds the latest data
        self._dev_fresh = False
        if data is not None:
            self.reset(data)

    # -- (re)binding ---------------------------------------------------------

    def reset(self, data: Any) -> "Array":
        """Bind new contents (numpy, a torch tensor, list, or scalar)."""
        if isinstance(data, torch.Tensor):
            self.set_devmem(data)
        else:
            self._host = np.ascontiguousarray(data)
            self._dev = None
            self._host_fresh, self._dev_fresh = True, False
        return self

    @property
    def initialized(self) -> bool:
        return self._host is not None or self._dev is not None

    # -- host side -----------------------------------------------------------

    def _shared(self) -> bool:
        """Whether host and device are one memory (a CPU tensor)."""
        return self._dev is not None and self._dev.device.type == "cpu" \
            and self._host is not None and self._host_fresh \
            and self._dev_fresh

    @property
    def mem(self) -> Optional[np.ndarray]:
        """Host view; pulls from the device when the device side is
        fresher."""
        if not self._host_fresh and self._dev_fresh:
            t = self._dev.detach()
            if t.device.type == "cpu":
                # one memory: the view stays the tensor's
                self._host = t.resolve_conj().numpy()
            else:
                self._host = t.cpu().numpy()
            self._host_fresh = True
        return self._host

    @mem.setter
    def mem(self, value: Any) -> None:
        self.reset(value)

    def map_read(self) -> None:
        self.mem  # ensure host copy is current

    def map_write(self) -> None:
        self.mem
        if not self._shared():
            self._dev_fresh = False  # host will be mutated

    def map_invalidate(self) -> None:
        # Host will be fully overwritten; skip the device->host pull.
        if self._host is None and self._dev is not None:
            self._host = np.empty(tuple(self._dev.shape),
                                  _np_dtype(self._dev.dtype))
        self._host_fresh, self._dev_fresh = True, False

    def unmap(self) -> None:
        """End host access; device copy refreshes lazily on next `.devmem`."""

    # -- device side ---------------------------------------------------------

    def devmem(self, device=None) -> Optional[torch.Tensor]:
        """Device view on `device` (see `target_device`); pushes from the
        host when the host side is fresher, and moves a tensor that lies
        elsewhere."""
        target = target_device(device)
        if self._host_fresh and not self._dev_fresh:
            if self._host is None:
                return None
            t = _host_tensor(self._host)
            self._dev = t if target.type == "cpu" else t.to(target)
            self._dev_fresh = True
        elif self._dev is not None and not _on(self._dev, target):
            self._dev = self._dev.to(target)
        return self._dev

    def set_devmem(self, value: torch.Tensor) -> None:
        """Store a device-side result (no host transfer until someone maps
        for read)."""
        self._dev = value
        self._dev_fresh, self._host_fresh = True, False

    # -- conveniences --------------------------------------------------------

    @property
    def shape(self):
        src = self._host if self._host is not None else self._dev
        return None if src is None else tuple(src.shape)

    @property
    def dtype(self):
        if self._host is not None:
            return self._host.dtype
        return None if self._dev is None else _np_dtype(self._dev.dtype)

    @property
    def size(self) -> int:
        s = self.shape
        return 0 if s is None else int(np.prod(s)) if s else 1

    def __len__(self) -> int:
        s = self.shape
        return 0 if s is None else s[0]

    def __bool__(self) -> bool:
        return self.initialized

    def __getitem__(self, idx):
        return self.mem[idx]

    def __setitem__(self, idx, value):
        self.map_write()
        self._host[idx] = value

    def __repr__(self) -> str:
        if not self.initialized:
            return "Array(<empty>)"
        side = "host" if self._host_fresh else "dev"
        return f"Array({self.shape}, {self.dtype}, fresh={side})"

    # -- pickling: host-resident only (parity: reference Array.__getstate__) -

    def __getstate__(self):
        return {"host": self.mem}

    def __setstate__(self, state):
        self._host = state["host"]
        self._dev = None
        self._host_fresh, self._dev_fresh = True, False


def _on(t: torch.Tensor, target: torch.device) -> bool:
    """Whether `t` lies on `target` (a target without an index: any
    device of its type)."""
    if target.index is None:
        return t.device.type == target.type
    return t.device == target


def _np_dtype(dt: torch.dtype):
    """The numpy dtype of a torch dtype (bfloat16, which numpy lacks,
    reads as float32: its host copies are widened)."""
    if dt == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dt).numpy().dtype


class TensorView:
    """An Array over the tensor `getattr(owner, attr)` that `owner` keeps
    (a layer's `weights`, a gradient unit's `vel_w`). Nothing is cached:
    every access reads the attribute, so a tensor the owner moves or
    replaces is followed. `mem` is its host view (the tensor's own memory
    on the CPU, a copy from the card); `devmem` the tensor itself on its
    own device; `reset` / `mem =` copy into it in place.
    A pickle holds the host values, as an Array's does."""

    def __init__(self, owner: Any, attr: str) -> None:
        self.owner = owner
        self.attr = attr

    @property
    def tensor(self) -> Optional[torch.Tensor]:
        t = getattr(self.owner, self.attr, None)
        return None if t is None else t.detach()

    @property
    def initialized(self) -> bool:
        return self.tensor is not None

    @property
    def mem(self) -> Optional[np.ndarray]:
        t = self.tensor
        return None if t is None else t.cpu().numpy()

    @mem.setter
    def mem(self, value: Any) -> None:
        self.reset(value)

    def reset(self, data: Any) -> "TensorView":
        t = self.tensor
        src = data if isinstance(data, torch.Tensor) \
            else torch.as_tensor(np.asarray(data))
        with torch.no_grad():
            t.copy_(src.reshape(t.shape))
        return self

    def devmem(self, device=None) -> Optional[torch.Tensor]:
        return self.tensor

    @property
    def shape(self):
        t = self.tensor
        return None if t is None else tuple(t.shape)

    @property
    def dtype(self):
        t = self.tensor
        return None if t is None else _np_dtype(t.dtype)

    def __bool__(self) -> bool:
        return self.initialized

    def __reduce__(self):
        return Array, (self.mem,)
