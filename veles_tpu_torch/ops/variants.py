"""Lowering-variant registry of the port: the ops `lrn`, `lrn_maxpool`,
`sgd_update`, `flash_attn` and `conv_stem` and their candidate
lowerings.

The port's counterpart of `veles_tpu/ops/variants.py`, with the same
`select` / `resolve` precedence (variants.py:152-232 there): a unit's
per-instance `variant_override`, then the global selection, then the op's
default. Every entry selects a path that runs; a kernel wrapper takes its
plain version on a CPU tensor by itself, so no entry is device-gated.

- `lrn`: `kernel` (K2 forward, K3 backward through `LRNFunction`; the
  counterpart of `pallas_one_pass`).
- `lrn_maxpool`: `composed` (a marker: no pair is claimed, the member ops
  run separately — the `lrn` op, then the plain ceil-mode pool) and
  `fused` (K4 forward, K5 backward through `LRNMaxPoolFunction`; the
  counterpart of `fused[rt=2,io=native,fuse=1]`). A `fused` selection lets
  an LRN unit claim the max pooling that follows it (parallel/fused.py).
- `sgd_update`: `kernel` (K1 per leaf; the counterpart of
  `pallas_rows[rt=8]`, and like that template it takes the tree rule when
  `l1_decay` is not 0: the kernel has no L1 term) and `tree` (the per-leaf
  tensor rule of ops/optim.py, the counterpart of `xla_tree`).
- `flash_attn`: `kernel` (K6 forward, K7 backward through
  `FlashAttentionFunction`; the counterpart of `pallas`) and `mha` (the
  einsum golden of ops/attention.py, the counterpart of `xla_mha`). The
  attention unit consults it only where its gate sends a sequence to the
  blocked kernel (znicz/attention.py).
- `conv_stem`: `direct` (the default, `F.conv2d` at the layer's stride)
  and `s2d` (the space-to-depth rewrite, `functional.
  conv2d_space_to_depth`), the JAX package's two hand-written points; its
  generated pack x acc x epi search waits for the kernel search. Where the
  JAX package defaults to `s2d` (its TPU measurement), the port keeps
  `direct` until a measurement on the card decides.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from veles_tpu_torch.ops import attention, functional, kernels, optim


@dataclass(frozen=True)
class Variant:
    """One candidate lowering for a tunable op. `fused` marks a cross-op
    fusion point; a variant without `apply` is a marker that the caller
    reads and does not run."""

    op: str
    name: str
    apply: Optional[Callable[..., Any]] = None
    fused: bool = False
    doc: str = ""


@dataclass
class _OpSpec:
    op: str
    default: str
    doc: str = ""
    variants: Dict[str, Variant] = field(default_factory=dict)


_OPS: Dict[str, _OpSpec] = {}
#: global op -> variant-name selection (CLI flags / tools write it)
_selection: Dict[str, str] = {}
_lock = threading.Lock()


def register_op(op: str, default: str, doc: str = "") -> None:
    _OPS[op] = _OpSpec(op=op, default=default, doc=doc)


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


def resolve(op: str, unit: Any = None) -> Variant:
    """The variant to run NOW. Precedence: the unit's `variant_override`,
    the global selection, the op's default."""
    spec = _spec(op)
    name = getattr(unit, "variant_override", None) if unit is not None \
        else None
    if name is None:
        name = _selection.get(op, spec.default)
    return get(op, name)


# ===========================================================================
# Registered ops
# ===========================================================================

# -- LRN: apply(x, *, k, alpha, beta, n) -> y, differentiable ---------------


def _lrn_kernel(x, *, k, alpha, beta, n):
    return kernels.LRNFunction.apply(x, k, alpha, beta, n)


register_op("lrn", default="kernel",
            doc="AlexNet across-channel LRN, forward and backward")
register(Variant("lrn", "kernel", _lrn_kernel,
                 doc="K2 forward (csrc/lrn_forward.cu), K3 backward "
                     "(csrc/lrn_backward.cu)"))


# -- lrn_maxpool: apply(x, *, k, alpha, beta, n, ksize, stride) -> pooled ---


def _lrn_maxpool_fused(x, *, k, alpha, beta, n, ksize, stride):
    return kernels.LRNMaxPoolFunction.apply(x, k, alpha, beta, n,
                                            tuple(ksize), tuple(stride))


register_op(
    "lrn_maxpool", default="fused",
    doc="cross-op fusion of an adjacent (lrn, max pooling) unit pair. The "
        "default differs from the JAX package's, which is composed "
        "(veles_tpu/ops/variants.py:327-329) and reaches a fused point "
        "only when its kernel search selects one; the port has no search "
        "yet, and its default keeps K4 and K5 on the main path")
register(Variant("lrn_maxpool", "composed",
                 doc="marker: no pair is claimed; the LRN writes its "
                     "output, the pool reads it back"))
register(Variant("lrn_maxpool", "fused", _lrn_maxpool_fused, fused=True,
                 doc="K4 forward (csrc/lrn_maxpool_forward.cu), K5 "
                     "backward (csrc/lrn_maxpool_backward.cu): only the "
                     "pooled output written"))


# -- sgd_update: apply(params, grads, vel, cfg, lr_scale) in place ----------


def _sgd_kernel(params, grads, vel, cfg, lr_scale=1.0):
    if cfg.l1_decay:
        # the kernel has no L1 term: the exact rule wins over the lowering
        # (templates.py:648-652 in the JAX package)
        optim.sgd_update(params, grads, vel, cfg, lr_scale)
        return
    for key, p in params.items():
        kernels.sgd_update(p, grads[key], vel[key],
                           optim.sgd_leaf_lr(cfg, p.ndim, lr_scale),
                           cfg.momentum, cfg.weight_decay)


register_op("sgd_update", default="kernel",
            doc="SGD + momentum + weight decay update of one layer's leaves")
register(Variant("sgd_update", "kernel", _sgd_kernel,
                 doc="K1 per leaf (csrc/sgd_update.cu)"))
register(Variant("sgd_update", "tree", optim.sgd_update,
                 doc="per-leaf tensor rule (ops/optim.py)"))


# -- flash_attn: apply(q, k, v, scale=None, causal=False) -> (B, S, H, D) ---


def _flash_kernel(q, k, v, scale=None, causal=False):
    return kernels.FlashAttentionFunction.apply(q, k, v, causal, scale)


register_op("flash_attn", default="kernel",
            doc="local multi-head attention of long sequences, forward "
                "and backward")
register(Variant("flash_attn", "kernel", _flash_kernel,
                 doc="K6 forward (csrc/flash_attention_forward.cu), K7 "
                     "backward (csrc/flash_attention_backward.cu): the "
                     "(S, S) scores never reach device memory"))
register(Variant("flash_attn", "mha", attention.mha_forward,
                 doc="the einsum golden (ops/attention.py mha_forward): "
                     "an (S, S) score tensor per head"))


# -- conv_stem: apply(x, w, b, stride, padding, activation) -> y ------------
#    A Conv with s2d="auto" consults it where its stride is square and > 1
#    and its input has fewer than 8 channels (znicz/conv.py).


def _conv_direct(x, w, b, stride, padding, activation):
    return functional.conv2d_forward(x, w, b, stride, padding, activation)


def _conv_s2d(x, w, b, stride, padding, activation):
    return functional.conv2d_forward(x, w, b, stride, padding, activation,
                                     s2d=True)


register_op(
    "conv_stem", default="direct",
    doc="strided thin-channel (cin < 8) entry convolution. The default "
        "differs from the JAX package's, which is s2d "
        "(veles_tpu/ops/variants.py:339-363, chosen by its TPU "
        "measurement); on the card the choice waits for a benchmark cell")
register(Variant("conv_stem", "direct", _conv_direct,
                 doc="F.conv2d at the layer's stride (cuDNN)"))
register(Variant("conv_stem", "s2d", _conv_s2d,
                 doc="space-to-depth repack (functional."
                     "conv2d_space_to_depth): a stride-1 F.conv2d over "
                     "b*b*C channels, the same sums in another order"))
