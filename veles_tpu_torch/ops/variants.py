"""Lowering-variant registry of the serving slice: the ops `lrn` and
`lrn_maxpool` and their candidate lowerings.

The port's counterpart of `veles_tpu/ops/variants.py`, with the same
`select` / `resolve` precedence (variants.py:152-232 there): a unit's
per-instance `variant_override`, then the global selection, then the op's
default. What the TPU registry gates on Pallas availability the port gates
on the device: a variant marked `cpu_only` serves CPU tensors only, and on
the card an op resolves to its kernel variant instead.

- `lrn`: `kernel` (K2, the counterpart of `pallas_one_pass`; on a CPU
  tensor its wrapper takes the plain version) and `plain` (CPU only).
- `lrn_maxpool`: `composed` (the member ops run separately: the `lrn` op,
  then the plain ceil-mode pool) and `fused` (K4, the counterpart of
  `fused[rt=2,io=native,fuse=1]`). A `fused` selection lets an LRN unit
  claim the max pooling that follows it (parallel/fused.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels


@dataclass(frozen=True)
class Variant:
    """One candidate lowering for a tunable op. `cpu_only` variants never
    run on the card; `fused` marks a cross-op fusion point."""

    op: str
    name: str
    apply: Callable[..., Any]
    cpu_only: bool = False
    fused: bool = False
    doc: str = ""


@dataclass
class _OpSpec:
    op: str
    default: str
    on_cuda: str            # what a cpu_only resolution becomes on the card
    doc: str = ""
    variants: Dict[str, Variant] = field(default_factory=dict)


_OPS: Dict[str, _OpSpec] = {}
#: global op -> variant-name selection (CLI flags / tools write it)
_selection: Dict[str, str] = {}
_lock = threading.Lock()


def register_op(op: str, default: str, on_cuda: Optional[str] = None,
                doc: str = "") -> None:
    _OPS[op] = _OpSpec(op=op, default=default, on_cuda=on_cuda or default,
                       doc=doc)


def register(variant: Variant) -> Variant:
    spec = _OPS.get(variant.op)
    if spec is None:
        raise KeyError(f"unknown tunable op {variant.op!r}; register_op "
                       f"first (known: {sorted(_OPS)})")
    spec.variants[variant.name] = variant
    return variant


def has_op(op: str) -> bool:
    return op in _OPS


def _spec(op: str) -> _OpSpec:
    try:
        return _OPS[op]
    except KeyError:
        raise KeyError(f"unknown tunable op {op!r} "
                       f"(registered: {sorted(_OPS)})") from None


def get(op: str, name: str) -> Variant:
    v = _spec(op).variants.get(name)
    if v is None:
        raise KeyError(f"unknown variant {name!r} for op {op!r} "
                       f"(registered: {sorted(_spec(op).variants)})")
    return v


def select(op: str, name: str) -> None:
    """Pin op's lowering globally (validates both names)."""
    get(op, name)
    with _lock:
        _selection[op] = name


def selected(op: str) -> Optional[str]:
    return _selection.get(op)


def clear_selection(op: Optional[str] = None) -> None:
    with _lock:
        if op is None:
            _selection.clear()
        else:
            _selection.pop(op, None)


def resolve(op: str, unit: Any = None,
            device: Optional[torch.device] = None) -> Variant:
    """The variant to run NOW on `device`. Precedence: the unit's
    `variant_override`, the global selection, the op's default. On the
    card a `cpu_only` variant gives way to the op's kernel lowering."""
    spec = _spec(op)
    name = getattr(unit, "variant_override", None) if unit is not None \
        else None
    if name is None:
        name = _selection.get(op, spec.default)
    v = get(op, name)
    if v.cpu_only and device is not None and device.type == "cuda":
        v = get(op, spec.on_cuda)
    return v


# ===========================================================================
# Registered ops
# ===========================================================================

# -- LRN forward: apply(x, *, k, alpha, beta, n) -> y ------------------------


def _lrn_kernel(x, *, k, alpha, beta, n):
    return kernels.lrn_forward(x, k, alpha, beta, n)


def _lrn_plain(x, *, k, alpha, beta, n):
    return kernels.lrn_forward_plain(x, k, alpha, beta, n)


register_op(
    "lrn", default="kernel", on_cuda="kernel",
    doc="AlexNet across-channel LRN forward")
register(Variant("lrn", "kernel", _lrn_kernel,
                 doc="K2: one-pass CUDA kernel (csrc/lrn_forward.cu)"))
register(Variant("lrn", "plain", _lrn_plain, cpu_only=True,
                 doc="plain PyTorch shifted-add window (CPU tensors)"))


# -- lrn_maxpool: apply(x, *, k, alpha, beta, n, ksize, stride) -> pooled ---


def _lrn_maxpool_composed(x, *, k, alpha, beta, n, ksize, stride):
    y = resolve("lrn", device=x.device).apply(x, k=k, alpha=alpha,
                                              beta=beta, n=n)
    return fn.maxpool_forward(y, tuple(ksize), tuple(stride))


def _lrn_maxpool_fused(x, *, k, alpha, beta, n, ksize, stride):
    return kernels.lrn_maxpool_forward(x, k, alpha, beta, n, ksize, stride)


register_op(
    "lrn_maxpool", default="fused",
    doc="cross-op fusion of an adjacent (lrn, max pooling) unit pair")
register(Variant("lrn_maxpool", "composed", _lrn_maxpool_composed,
                 doc="the member ops run separately: the LRN writes its "
                     "output, the pool reads it back"))
register(Variant("lrn_maxpool", "fused", _lrn_maxpool_fused, fused=True,
                 doc="K4: LRN and pool in one pass, only the pooled "
                     "output written (csrc/lrn_maxpool_forward.cu)"))
