"""Lowering-variant registry of the port: the ops `lrn`, `maxpool`,
`lrn_maxpool`, `sgd_update`, `flash_attn` and `conv_stem`, their
hand-written candidate lowerings, and the generated points of the kernel
search (ops/templates.py).

The port's counterpart of `veles_tpu/ops/variants.py`, with the same
`select` / `resolve` precedence (variants.py:152-232 there): a unit's
per-instance `variant_override`, then the global selection, then the op's
default. Every entry selects a path that runs; a kernel wrapper takes its
plain version on a CPU tensor by itself, so no entry is device-gated and
the JAX package's `fallback` (its stand-in where Pallas cannot run) has
no counterpart: a kernel that cannot run fails. `kernel=True` marks a
lowering that launches the port's own kernels (the JAX `pallas` flag);
`tunable=False` a marker the search never times; `generated=True` a
point of a template, named `base[axis=value,...]`, which `get`
materializes from its name alone (a cached winner in a fresh process).
Generated points are kept apart from the hand-written ones, so
`variants_for` lists what was registered by hand.

- `lrn`: `kernel` (the default: K2 forward, K3 backward through
  `LRNFunction`; the counterpart of `pallas_one_pass`), and the JAX
  package's `banded_matmul` and `cached_residual` (a banded matmul for
  the window sum, recomputing or keeping s and d for the backward:
  `functional.BandedLRNFunction`); generated `cuda[tile,io]`.
- `maxpool`: `reduce_window` (the default: `functional.maxpool_forward`,
  the port's pool so far; the max-abs flavor gathers its winner) and
  `slices` (a max-fold over shifted strided slices); generated
  `gen[algo,fold]`.
- `lrn_maxpool`: `composed` (no pair is claimed, the member ops run
  separately; its `apply`, K2/K3 and the pool, is the contract's and the
  bench's) and `fused` (K4 forward, K5 backward through
  `LRNMaxPoolFunction`; the counterpart of `fused[rt=2,io=native,
  fuse=1]`); generated `fused[rb,cb,io,fuse]`. A fused selection lets an
  LRN unit claim the max pooling that follows it (parallel/fused.py).
- `sgd_update`: `kernel` (K1 per leaf; the counterpart of
  `pallas_rows[rt=8]`, and like that template it takes the tree rule when
  `l1_decay` is not 0: the kernel has no L1 term) and `tree` (the per-leaf
  tensor rule of ops/optim.py, the counterpart of `xla_tree`); generated
  `cuda_rows[threads]`.
- `flash_attn`: `kernel` (K6 forward, K7 backward through
  `FlashAttentionFunction`; the counterpart of `pallas`) and `mha` (the
  einsum golden of ops/attention.py, the counterpart of `xla_mha`); the
  attention unit consults it only where its gate sends a sequence to the
  blocked kernel (znicz/attention.py); generated
  `cuda[blk_q,blk_k,kv_order,drop]`.
- `conv_stem`: `direct` (the default, `F.conv2d` at the layer's stride)
  and `s2d` (the space-to-depth rewrite, `functional.
  conv2d_space_to_depth`); generated `gen[pack,acc,epi]`, whose `epi=lrn`
  points claim the LRN after the stem.

The defaults stay what the port ran before the search: `lrn_maxpool`
`fused` where the JAX default is `composed`, `conv_stem` `direct` where
it is `s2d`. `--autotune` (ops/autotune.py) times the candidates on the
card and selects the winners, which a later run applies from its cache.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.ops import attention, functional, kernels, optim


@dataclass(frozen=True)
class Variant:
    """One candidate lowering for a tunable op. `fused` marks a cross-op
    fusion point; a variant without `apply` is a marker that the caller
    reads and does not run. `kernel` marks a lowering that launches the
    port's kernels, `tunable=False` a variant the search does not time,
    `generated` a template point."""

    op: str
    name: str
    apply: Optional[Callable[..., Any]] = None
    fused: bool = False
    kernel: bool = False
    tunable: bool = True
    generated: bool = False
    doc: str = ""


@dataclass
class _OpSpec:
    op: str
    default: str
    doc: str = ""
    variants: Dict[str, Variant] = field(default_factory=dict)
    #: template points materialized by name (ops/templates.py)
    generated: Dict[str, Variant] = field(default_factory=dict)


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
    table = spec.generated if variant.generated else spec.variants
    table[variant.name] = variant
    return variant


def ops() -> List[str]:
    return sorted(_OPS)


def has_op(op: str) -> bool:
    return op in _OPS


def variants_for(op: str) -> List[Variant]:
    """The op's hand-written variants, in registration order."""
    return list(_spec(op).variants.values())


def _spec(op: str) -> _OpSpec:
    try:
        return _OPS[op]
    except KeyError:
        raise KeyError(f"unknown tunable op {op!r} "
                       f"(registered: {sorted(_OPS)})") from None


def _lookup(op: str, name: Any) -> Optional[Variant]:
    """The registered variant, or a template point materialized from its
    name (the path a cached generated winner takes in a fresh process)."""
    spec = _spec(op)
    v = spec.variants.get(name) or spec.generated.get(name)
    if v is None and isinstance(name, str) and "[" in name:
        from veles_tpu_torch.ops import templates
        v = templates.materialize(op, name)
    return v


def get(op: str, name: str) -> Variant:
    v = _lookup(op, name)
    if v is None:
        raise KeyError(f"unknown variant {name!r} for op {op!r} "
                       f"(registered: {sorted(_spec(op).variants)})")
    return v


def has(op: str, name: Any) -> bool:
    return op in _OPS and _lookup(op, name) is not None


def select(op: str, name: str) -> None:
    """Pin op's lowering globally (validates both names)."""
    get(op, name)
    with _lock:
        _selection[op] = name


def selected(op: str) -> Optional[str]:
    return _selection.get(op)


def effective(op: str) -> str:
    """The variant name resolve() gives absent per-unit overrides."""
    return _selection.get(op, _spec(op).default)


def clear_selection(op: Optional[str] = None) -> None:
    with _lock:
        if op is None:
            _selection.clear()
        else:
            _selection.pop(op, None)


def selection_table(include_defaults: bool = False) -> Dict[str, str]:
    """{op: variant-name}: the explicit selections, and with
    `include_defaults` every op (its default where nothing is selected)."""
    if not include_defaults:
        return dict(_selection)
    return {op: effective(op) for op in _OPS}


@contextlib.contextmanager
def selection_kept():
    """Restore the global selection on exit, whatever was selected or
    cleared inside (a run's cached or tuned winners stay the run's)."""
    with _lock:
        saved = dict(_selection)
    try:
        yield
    finally:
        with _lock:
            _selection.clear()
            _selection.update(saved)


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


def _lrn_banded(x, *, k, alpha, beta, n):
    return functional.BandedLRNFunction.apply(x, k, alpha, beta, n, False)


def _lrn_cached(x, *, k, alpha, beta, n):
    return functional.BandedLRNFunction.apply(x, k, alpha, beta, n, True)


register_op("lrn", default="kernel",
            doc="AlexNet across-channel LRN, forward and backward")
register(Variant("lrn", "kernel", _lrn_kernel, kernel=True,
                 doc="K2 forward (csrc/lrn_forward.cu), K3 backward "
                     "(csrc/lrn_backward.cu)"))
register(Variant("lrn", "banded_matmul", _lrn_banded,
                 doc="banded-matmul window sum; the backward recomputes s "
                     "and d"))
register(Variant("lrn", "cached_residual", _lrn_cached,
                 doc="the same lowering, s and d kept from the forward: "
                     "one window sum less in the backward for two "
                     "activation-sized residuals"))


# -- maxpool: apply(x, ksize, stride, use_abs) -> y, differentiable ---------


def _maxpool_reduce_window(x, ksize, stride, use_abs):
    if use_abs:
        return functional.maxpool_forward_with_idx(
            x, tuple(ksize), tuple(stride), use_abs=True)[0]
    return functional.maxpool_forward(x, tuple(ksize), tuple(stride))


def _maxpool_slices(x, ksize, stride, use_abs):
    return functional.maxpool_forward_slices(x, tuple(ksize), tuple(stride),
                                             use_abs)


register_op("maxpool", default="reduce_window",
            doc="max and max-abs pooling in the fused step; the variants "
                "differ in what the backward lowers to")
register(Variant("maxpool", "reduce_window", _maxpool_reduce_window,
                 doc="F.max_pool2d over the -inf-padded input (the max-abs "
                     "flavor: the winner's gather); backward: the index "
                     "scatter"))
register(Variant("maxpool", "slices", _maxpool_slices,
                 doc="max-fold over ky*kx shifted strided slices; "
                     "backward: elementwise selects"))


# -- lrn_maxpool: apply(x, *, k, alpha, beta, n, ksize, stride) -> pooled ---


def _lrn_maxpool_composed(x, *, k, alpha, beta, n, ksize, stride):
    return functional.maxpool_forward(
        kernels.LRNFunction.apply(x, k, alpha, beta, n), tuple(ksize),
        tuple(stride))


def _lrn_maxpool_fused(x, *, k, alpha, beta, n, ksize, stride):
    return kernels.LRNMaxPoolFunction.apply(x, k, alpha, beta, n,
                                            tuple(ksize), tuple(stride))


register_op(
    "lrn_maxpool", default="fused",
    doc="cross-op fusion of an adjacent (lrn, max pooling) unit pair. The "
        "default differs from the JAX package's, which is composed "
        "(veles_tpu/ops/variants.py:327-329) and reaches a fused point "
        "only when its kernel search selects one; the port keeps K4 and "
        "K5 on the main path unless its own search, run on the card, "
        "selects otherwise")
register(Variant("lrn_maxpool", "composed", _lrn_maxpool_composed,
                 kernel=True,
                 doc="no pair is claimed: the member units run their own "
                     "ops' lowerings, the LRN writing its output and the "
                     "pool reading it back; `apply` (K2/K3, then the "
                     "ceil-mode pool) is what the contract and the bench "
                     "run"))
register(Variant("lrn_maxpool", "fused", _lrn_maxpool_fused, fused=True,
                 kernel=True,
                 doc="K4 forward (csrc/lrn_maxpool_forward.cu), K5 "
                     "backward (csrc/lrn_maxpool_backward.cu): only the "
                     "pooled output written"))


# -- sgd_update: apply(params, grads, vel, cfg, lr_scale) in place ----------


def sgd_kernel_update(params, grads, vel, cfg, lr_scale=1.0, threads=0):
    """K1 per leaf with `threads` a block (0: its default); the tree rule
    where `l1_decay` is not 0 (the kernel has no L1 term: the exact rule
    wins over the lowering, templates.py:648-652 in the JAX package)."""
    if cfg.l1_decay:
        optim.sgd_update(params, grads, vel, cfg, lr_scale)
        return
    for key, p in params.items():
        kernels.sgd_update(p, grads[key], vel[key],
                           optim.sgd_leaf_lr(cfg, p.ndim, lr_scale),
                           cfg.momentum, cfg.weight_decay, threads=threads)


register_op("sgd_update", default="kernel",
            doc="SGD + momentum + weight decay update of one layer's leaves")
register(Variant("sgd_update", "kernel", sgd_kernel_update, kernel=True,
                 doc="K1 per leaf (csrc/sgd_update.cu)"))
register(Variant("sgd_update", "tree", optim.sgd_update,
                 doc="per-leaf tensor rule (ops/optim.py)"))


# -- flash_attn: apply(q, k, v, scale=None, causal=False) -> (B, S, H, D) ---


def _flash_kernel(q, k, v, scale=None, causal=False):
    return kernels.FlashAttentionFunction.apply(q, k, v, causal, scale)


register_op("flash_attn", default="kernel",
            doc="local multi-head attention of long sequences, forward "
                "and backward")
register(Variant("flash_attn", "kernel", _flash_kernel, kernel=True,
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
        "measurement); the port's search decides on the card")
register(Variant("conv_stem", "direct", _conv_direct,
                 doc="F.conv2d at the layer's stride (cuDNN)"))
register(Variant("conv_stem", "s2d", _conv_s2d,
                 doc="space-to-depth repack (functional."
                     "conv2d_space_to_depth): a stride-1 F.conv2d over "
                     "b*b*C channels, the same sums in another order"))
