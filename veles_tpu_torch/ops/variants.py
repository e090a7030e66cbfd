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
- `serve_forward`: the serving wire of the model's parameters, `f32`
  (the default), `bf16` and `int8` (`serve_prepare_params` on the host,
  `serve_forward_apply` on the device; the JAX package's names and rules,
  ops/variants.py:740-895 there). It has no template, so the search
  never times it; its equivalence contract gates the non-f32 wires
  before the server serves them.

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

import torch

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


# -- grad_reduce: apply(flat, mesh, resid=None) -> this rank's slice -------
#    The ZeRO update's reduction (JAX variants.py:394-690): every rank
#    holds its partial of a (padded,) flat gradient (the global-mean
#    normalization already in it), and each gets back the summed slice
#    it owns, [rank*local, (rank+1)*local), over the mesh's process
#    group (parallel/mesh.py):
#
#    - f32: `reduce_scatter_tensor` in the gradient dtype, exact;
#    - bf16: the same in bf16 (bytes /2), summed back in f32;
#    - int8_block: each rank codes the rows bound for each member as
#      per-block absmax int8 (blk 256: `q8_encode`, bit for bit
#      ops/reference.quantize_blockwise) with f32 scales, and an
#      `all_to_all_single` of the codes and one of the scales takes each
#      row to its owner, which decodes and sums in f32 (bytes ~/4);
#    - int8_ef: int8_block with error feedback: the quantization
#      residual (x + resid - decode(code(x + resid))) rides in the ZeRO
#      state's "ef" slot and is added back before the next coding;
#    - hier2: two levels over the (hosts x local) factorization of the
#      ranks (`grad_reduce_geometry`): a reduce-scatter inside each
#      host's group in the gradient dtype, then one across the hosts'
#      groups of the 1/n_local partials (cross-host bytes /n_local);
#      exact f32, the flat scatter where the factorization degenerates.
#
#    The template-generated `wire[dt,blk,ef,hier]` points come with the
#    kernel search's second half. `grad_reduce_bytes` is the JAX byte
#    model, modeled from the collective's algorithm and the plan sizes.

GRAD_REDUCE_LOCAL_ENV = "VELES_GRAD_REDUCE_LOCAL"

#: canonical configs of the named family members (JAX variants.py:407)
_GR_NAMED: Dict[str, Dict[str, Any]] = {
    "f32": {"dt": "f32", "blk": 0, "ef": 0, "hier": 0},
    "bf16": {"dt": "bf16", "blk": 0, "ef": 0, "hier": 0},
    "int8_block": {"dt": "int8", "blk": 256, "ef": 0, "hier": 0},
    "int8_ef": {"dt": "int8", "blk": 256, "ef": 1, "hier": 0},
    "hier2": {"dt": "f32", "blk": 0, "ef": 0, "hier": 1},
}


def grad_reduce_local_request(n_shards: int,
                              n_hosts: Optional[int] = None) -> int:
    """The UNCLAMPED request for the ranks of one host's group:
    $VELES_GRAD_REDUCE_LOCAL (an explicit geometry, as in the JAX
    function: CPU tests, odd topologies), else the mesh's ranks a host
    (`n_hosts`, the hosts `make_mesh` counted; the ranks laid out host
    by host, as --process-id numbers them), else $LOCAL_WORLD_SIZE (the
    processes on this host, as a launcher such as torchrun sets it; the
    JAX function reads the host's device count), else `n_shards` (one
    host)."""
    import os
    raw = os.environ.get(GRAD_REDUCE_LOCAL_ENV)
    if not raw and n_hosts:
        return n_shards // int(n_hosts)
    raw = raw or os.environ.get("LOCAL_WORLD_SIZE")
    if raw:
        try:
            return int(raw)
        except ValueError:
            return 0
    return n_shards


def grad_reduce_geometry(n_shards: int,
                         n_hosts: Optional[int] = None) -> tuple:
    """(n_hosts, n_local): the request clamped to the largest divisor of
    `n_shards` it does not exceed, so the groups tile the ranks; (1, n)
    or (n, 1) make the hierarchy degenerate to the flat exchange."""
    loc = grad_reduce_local_request(n_shards, n_hosts)
    loc = max(1, min(int(loc), n_shards))
    while n_shards % loc:
        loc -= 1
    return n_shards // loc, loc


def grad_reduce_config(name: Any) -> Optional[Dict[str, Any]]:
    """Canonical EFFECTIVE config {dt, blk, ef, hier} of a named
    grad_reduce variant (None for any other name): error feedback and
    the block are int8-only, so they read 0 for a float wire."""
    cfg = _GR_NAMED.get(name)
    if cfg is None:
        return None
    cfg = dict(cfg)
    if cfg["dt"] != "int8":
        cfg["ef"] = 0
        cfg["blk"] = 0
    return cfg


def grad_reduce_resid_len(name: str, padded: int, n_shards: int,
                          n_hosts: Optional[int] = None) -> Optional[int]:
    """Per-rank error-feedback residual length of one (padded,) flat leaf
    under `name`, None for a stateless variant: the flat int8+EF exchange
    codes the whole partial (padded elements), the hierarchical one only
    the cross-host leg's 1/n_local slice."""
    cfg = grad_reduce_config(name)
    if not cfg or not cfg["ef"]:
        return None
    if cfg["hier"]:
        h, loc = grad_reduce_geometry(n_shards, n_hosts)
        if h > 1 and loc > 1:
            return padded // loc
    return padded


def grad_reduce_bytes(name: str, n_elems: int, n_shards: int,
                      n_hosts: Optional[int] = None) -> Dict[str, Any]:
    """Modeled per-rank egress bytes a train step's exchange moves (and
    the parameter all-gather's), split into the cross-host leg ("dcn")
    and the in-host leg ("ici", the JAX names) under the (hosts x local)
    geometry (`n_hosts` as in `grad_reduce_local_request`): the JAX
    function (variants.py:468-504), number for number."""
    cfg = grad_reduce_config(name) or dict(_GR_NAMED["f32"])
    h, loc = grad_reduce_geometry(n_shards, n_hosts)
    item = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}[cfg["dt"]]
    if cfg["dt"] == "int8" and cfg["blk"]:
        item += 4.0 / cfg["blk"]      # the scales ride the same exchange
    n = n_shards
    if cfg["hier"] and h > 1 and loc > 1:
        ici = n_elems * (loc - 1) / loc * 4.0
        dcn = (n_elems / loc) * (h - 1) / h * item
    else:
        dcn = n_elems * (n - loc) / n * item
        ici = n_elems * (loc - 1) / n * item
    return {"dcn_bytes": int(dcn), "ici_bytes": int(ici),
            "allgather_dcn_bytes": int(n_elems / n * (n - loc) * 4.0),
            "allgather_ici_bytes": int(n_elems / n * (loc - 1) * 4.0),
            "geometry": {"hosts": h, "local": loc},
            "config": cfg}


def q8_encode(x2: torch.Tensor, blk: int):
    """ops/reference.quantize_blockwise over the last axis of a 2-D
    (rows, cols) f32 tensor, cols zero-padded up to a block multiple, bit
    for bit: (codes int8 (rows, colsp), scales f32 (rows, colsp//blk))."""
    rows, cols = x2.shape
    pad = (-cols) % blk
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(rows, pad)], dim=1)
    xb = x2.reshape(rows, -1, blk)
    absmax = xb.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q.reshape(rows, -1), scale


def _reduce_scatter(out, inp, group):
    import torch.distributed as dist
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def _q8_exchange(x, group, blk, resid, local, want_resid):
    """Blockwise-int8 exchange-and-accumulate over `group`: row j of `x`
    (rows = the group's size, local columns) is bound for its j-th
    member; code each row (with `resid` added first), send codes and
    scales to their owners by `all_to_all_single`, decode and sum in f32.
    Returns (my summed (local,) slice, the new residual or None)."""
    import torch.distributed as dist
    if resid is not None:
        x = x + resid.reshape(x.shape)
    q, s = q8_encode(x, blk)
    new_resid = None
    if want_resid:
        new_resid = (x - q8_decode(q, s, blk)[:, :local]).reshape(-1)
    q_r, s_r = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_r, q, group=group)
    dist.all_to_all_single(s_r, s, group=group)
    return q8_decode(q_r, s_r, blk)[:, :local].sum(dim=0), new_resid


def grad_reduce_apply(cfg: Dict[str, Any]) -> Callable[..., Any]:
    """The one grad_reduce apply of a config point: `apply(flat, mesh,
    resid=None)` reduces the rank's (padded,) flat partial over
    `mesh.group` and returns its summed (padded/N,) slice, or (slice,
    new residual) for a stateful (EF) point; `resid=None` means a zero
    residual. `apply.gr_config` names the point."""
    dt = cfg["dt"]
    blk = int(cfg.get("blk") or 256)
    ef = bool(cfg.get("ef")) and dt == "int8"
    hier = bool(cfg.get("hier"))

    def apply(flat, mesh, resid=None):
        n = mesh.size
        h, loc = grad_reduce_geometry(n, mesh.n_hosts)
        two_level = hier and h > 1 and loc > 1
        local = flat.shape[0] // n
        new_resid = None
        if two_level:
            lgroup, cgroup = mesh.subgroups(h, loc)
            # in-host leg: rank (host hh, local ll) gets row ll of the
            # (loc, h, local) layout — the partials of the slices
            # {hh' * loc + ll}, summed over its host's group
            x = flat.to(torch.float32).reshape(h, loc, local) \
                .transpose(0, 1).contiguous().reshape(-1)
            x = _reduce_scatter(x.new_empty(h * local), x,
                                lgroup).reshape(h, local)
            if dt == "int8":
                out, new_resid = _q8_exchange(
                    x, cgroup, blk, resid if ef else None, local, ef)
            else:
                w = x.to(torch.bfloat16) if dt == "bf16" else x
                out = _reduce_scatter(w.new_empty(local), w.reshape(-1),
                                      cgroup).to(torch.float32)
        elif dt == "int8":
            out, new_resid = _q8_exchange(
                flat.to(torch.float32).reshape(n, local), mesh.group, blk,
                resid if ef else None, local, ef)
        elif dt == "bf16":
            w = flat.to(torch.bfloat16)
            out = _reduce_scatter(w.new_empty(local), w,
                                  mesh.group).to(torch.float32)
        else:
            out = _reduce_scatter(flat.new_empty(local), flat.contiguous(),
                                  mesh.group)
        out = out.to(flat.dtype)
        return (out, new_resid) if ef else out

    apply.gr_config = {"dt": dt, "blk": blk if dt == "int8" else 0,
                       "ef": int(ef), "hier": int(hier)}
    return apply


register_op(
    "grad_reduce", default="f32",
    doc="ZeRO weight-update reduce-scatter of the ranks' partial "
        "gradients over the process group (the compressed and "
        "hierarchical points trade gradient bits and exchange topology "
        "for cross-host bytes — EQuARX, arxiv 2506.17615)")
register(Variant("grad_reduce", "f32",
                 grad_reduce_apply(_GR_NAMED["f32"]), tunable=False,
                 doc="exact: reduce_scatter_tensor in the gradient dtype"))
register(Variant("grad_reduce", "bf16",
                 grad_reduce_apply(_GR_NAMED["bf16"]), tunable=False,
                 doc="wire dtype bf16 (bytes /2), summed back in f32"))
register(Variant("grad_reduce", "int8_block",
                 grad_reduce_apply(_GR_NAMED["int8_block"]),
                 tunable=False,
                 doc="blockwise-scaled int8 codes (blk 256) and f32 "
                     "scales by all_to_all_single, decoded and summed in "
                     "f32: bytes ~0.26x the f32 scatter"))
register(Variant("grad_reduce", "int8_ef",
                 grad_reduce_apply(_GR_NAMED["int8_ef"]), tunable=False,
                 doc="int8_block + error feedback: the coding residual "
                     "rides in the ZeRO state's 'ef' slot and is added "
                     "back before the next coding"))
register(Variant("grad_reduce", "hier2",
                 grad_reduce_apply(_GR_NAMED["hier2"]), tunable=False,
                 doc="two-level (hosts x local): an in-host "
                     "reduce-scatter, then the cross-host one of the "
                     "1/n_local partials; exact f32"))


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


# -- serve_forward: apply(prepared, x, forward, shapes=None) -> f32 output --
#    The serving tier's wire format for the model's parameters
#    (veles_tpu/ops/variants.py:740-895 in the JAX package). `forward` is
#    the server's dense forward ((params, x) -> out: FusedForward._forward),
#    `prepared` the parameter tree after the wire's host transform
#    (`serve_prepare_params`), moved to the device, and `shapes` the
#    original leaf shapes (to undo the int8 padding). Equivalence
#    contract: templates._serve_contract; the server refuses a non-f32
#    wire without a passing ledger record and probes it against the f32
#    forward of the served model at startup (serving.py).
#
#    - f32:  the trained parameters as they are;
#    - bf16: parameters cast to bf16 on the host (model bytes /2), the
#      input cast at entry, so the forward computes in bf16 (the LRN
#      kernels' bf16 instances), the output returned in f32;
#    - int8: weight-only: >=2-D float leaves whose last axis holds a
#      whole block of 64 become per-block absmax codes and f32 scales
#      (ops/reference.serve_quantize_weight, model bytes ~/4), decoded to
#      f32 on the device each call (plain tensor operations, as the JAX
#      package decodes in XLA outside any Pallas kernel); biases and
#      narrower leaves stay f32. The leaves keep the JAX package's
#      layouts (convert.params_from_jax does not transpose), so the
#      blocks run along the same axis and the codes are the JAX
#      package's bit for bit.

_SERVE_NAMED: Dict[str, Dict[str, Any]] = {
    "f32": {"wire": "f32", "blk": 0},
    "bf16": {"wire": "bf16", "blk": 0},
    "int8": {"wire": "int8", "blk": 64},
}


def serve_forward_config(name: Any) -> Optional[Dict[str, Any]]:
    """Canonical config {wire, blk} of a serve_forward variant name (None
    for a foreign name)."""
    cfg = _SERVE_NAMED.get(name)
    return dict(cfg) if cfg is not None else None


def _host_array(a):
    """A parameter leaf as a numpy array (a tensor copied to the host)."""
    import numpy as np
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _serve_quantizable(a, blk: int) -> bool:
    """int8-wire eligibility: a >=2-D float leaf whose last axis holds at
    least one whole block (a narrower one would be padded up to the block
    and come out larger than its f32 form)."""
    import numpy as np
    arr = _host_array(a)
    return (arr.ndim >= 2 and arr.shape[-1] >= blk
            and np.issubdtype(arr.dtype, np.floating))


def serve_prepare_params(name: str, params):
    """Host-side wire transform of a (tuple of {name: leaf}) f32 parameter
    tree into `name`'s serving format, as CPU tensors. Returns (prepared,
    shapes): int8 leaves become {"q": codes, "s": scales} from the
    reference quantizer, bf16 leaves are cast (round to nearest even, as
    numpy's bfloat16 cast in the JAX package), f32 leaves pass through;
    `shapes` holds each original leaf shape."""
    import numpy as np

    from veles_tpu_torch.ops import reference
    cfg = _SERVE_NAMED[name]
    prepared, shapes = [], []
    for layer in params:
        pl: Dict[str, Any] = {}
        sl: Dict[str, tuple] = {}
        for k, a in layer.items():
            arr = _host_array(a)
            sl[k] = tuple(int(s) for s in arr.shape)
            if cfg["wire"] == "int8" and _serve_quantizable(arr, cfg["blk"]):
                q, s = reference.serve_quantize_weight(
                    arr.astype(np.float32), cfg["blk"])
                pl[k] = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
            elif cfg["wire"] == "bf16" \
                    and np.issubdtype(arr.dtype, np.floating):
                pl[k] = torch.from_numpy(
                    np.ascontiguousarray(arr)).to(torch.bfloat16)
            else:
                pl[k] = torch.from_numpy(np.ascontiguousarray(arr))
        prepared.append(pl)
        shapes.append(sl)
    return tuple(prepared), tuple(shapes)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_param_bytes(prepared) -> int:
    """Bytes of a prepared (or a plain f32) parameter tree: what the wire
    holds on the device beside the model's f32 bytes."""
    total = 0
    for leaf in _leaves(prepared):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(_host_array(leaf).nbytes)
    return total


def serve_to_device(prepared, device):
    """The prepared tree's tensors on `device` (one copy each)."""
    if isinstance(prepared, dict):
        return {k: serve_to_device(v, device) for k, v in prepared.items()}
    if isinstance(prepared, (tuple, list)):
        return tuple(serve_to_device(v, device) for v in prepared)
    return prepared.to(device)


def q8_decode(q: torch.Tensor, scale: torch.Tensor, blk: int):
    """Codes times scales in f32, (rows, cols) (the JAX `q8_decode`,
    veles_tpu/ops/variants.py:549-554; ops/reference.dequantize_blockwise
    bit for bit: each value one exact product rounded once)."""
    rows = q.shape[0]
    xb = q.reshape(rows, -1, blk).to(torch.float32)
    return (xb * scale[..., None]).reshape(rows, -1)


def _serve_restore(cfg, prepared, shapes):
    """Inverse of serve_prepare_params on the device: the tree the dense
    forward takes (int8 leaves decoded to f32; bf16 leaves stay bf16, so
    that the forward computes in bf16)."""
    out = []
    for li, layer in enumerate(prepared):
        d = {}
        for k, v in layer.items():
            if isinstance(v, dict) and "q" in v:
                shp = tuple(shapes[li][k])
                d[k] = q8_decode(v["q"], v["s"], cfg["blk"])[
                    :, :shp[-1]].reshape(shp)
            else:
                d[k] = v
        out.append(d)
    return tuple(out)


def serve_forward_apply(cfg: Dict[str, Any]) -> Callable[..., Any]:
    """The one serve_forward apply of a config point; `apply.sv_config`
    names the wire for the equivalence contract."""
    cfg = dict(cfg)

    def apply(prepared, x, forward, shapes=None):
        params = _serve_restore(cfg, prepared, shapes)
        if cfg["wire"] == "bf16":
            x = x.to(torch.bfloat16)
        return forward(params, x).to(torch.float32)

    apply.sv_config = cfg
    return apply


register_op(
    "serve_forward", default="f32",
    doc="the serving tier's wire format for the model's parameters: f32, "
        "bf16 (bytes /2) and weight-only blockwise int8 (bytes ~/4); a "
        "non-f32 wire serves only with a passing equivalence record and "
        "within 0.05 of the f32 forward of the served model. No template: "
        "the kernel search never times it")
register(Variant("serve_forward", "f32",
                 serve_forward_apply(_SERVE_NAMED["f32"]),
                 doc="the trained f32 parameters as they are"))
register(Variant("serve_forward", "bf16",
                 serve_forward_apply(_SERVE_NAMED["bf16"]),
                 doc="parameters stored and computed in bf16 (the LRN "
                     "kernels' bf16 instances), output in f32"))
register(Variant("serve_forward", "int8",
                 serve_forward_apply(_SERVE_NAMED["int8"]),
                 doc="weight-only per-block absmax int8 (blk 64), quantized "
                     "on the host by ops/reference.serve_quantize_weight, "
                     "decoded to f32 on the device each call"))
