"""The kernel search's generated candidates: each tunable op's axes, the
candidate a point of them builds, the equivalence ledger that gates a
candidate before anything times it, and the microbenches that time the
ops below the unit graph.

The port's counterpart of `veles_tpu/ops/templates.py`:

- a `KernelTemplate` names an op's axes and builds the op's `apply` from
  any point of them. For the port's kernels the axes are their launch
  shapes, run-time arguments of the CUDA sources since this slice (the
  constants of ops/kernels.py turned parameters): K1's block
  (`sgd_update` `cuda_rows[threads]`), K2's and K3's tile (`lrn`
  `cuda[tile,io]`), K4's band (`lrn_maxpool` `fused[rb,cb,io,fuse]`),
  and for K6/K7 the key order and the dropout epilogue they already take
  (`flash_attn` `cuda[blk_q,blk_k,kv_order,drop]`, whose block axes hold
  only the compiled 64). `maxpool` `gen[algo,fold]` and `conv_stem`
  `gen[pack,acc,epi]` are plain PyTorch, their names and configs the JAX
  package's letter for letter (an `epi=lrn` point runs the LRN through K2
  and K3). `io=f32` under a bf16 step is no new instance: the point casts
  to f32, runs the f32 instance and casts back, as the JAX
  `lrn_pallas(..., io_dtype="f32")` does.
- a point's name, `base[axis=value,...]`, is its identity in the
  registry and the cache: `variants.get` materializes it from the name
  alone (`materialize`), so a cached winner applies in a fresh process.
- `smem_footprint(config, shapes, dtype)` takes the place of the JAX
  `vmem_footprint`: the dynamic shared memory a block of the point's
  kernel takes at the op's shapes, from the Python mirrors of the
  sources' plans in ops/kernels.py (-1 where the plan refuses the
  point). analysis/resources.py holds it against the card's budget.
- `bench_key(config, shapes, dtype)` names what the point executes at
  those shapes: K2's plan caps a block at 48 KB and K4's shrinks its band
  until it fits, so distinct configs may launch the same kernel; every
  `fuse=0` point of `lrn_maxpool` is the composed pair. The search times
  one point of each key.
- the EQUIVALENCE LEDGER: `check_equivalence` runs the op's contract (a
  candidate's forward and backward against the goldens of
  ops/reference.py the JAX contract uses, the composed golden for fused
  points) on the device the search runs on, and records the outcome for
  this process; `bench_candidate` and the search's timed trial refuse a
  point without a passing record (`UngatedCandidateError`).

`serve_forward` (the serving wire, ops/variants.py) has a contract and
no template: the server gates a non-f32 wire on its record, and the
search never times it.

A bench times its op at the main path's shapes with CUDA events on the
card and with `perf_counter` on the CPU (at small shapes there: a CPU
time says nothing of the card).
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.backends import full_f32, make_device
from veles_tpu_torch.ops import attention, functional, kernels, optim
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.ops import variants

__all__ = [
    "Axis", "KernelTemplate", "register_template", "templates_for",
    "template_ops", "materialize", "space_signature",
    "check_equivalence", "equivalence_record", "passed", "clear_ledger",
    "ledger_table", "bench_candidate", "UngatedCandidateError",
    "fusion_members", "fusion_config", "fusion_point", "time_call",
]


class UngatedCandidateError(RuntimeError):
    """Raised when something tries to time a candidate that has no
    passing equivalence record in this process."""


@dataclass(frozen=True)
class Axis:
    """One typed tuning axis: a name and its finite choice set."""

    name: str
    choices: Tuple[Any, ...]
    doc: str = ""

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"axis {self.name!r} has no choices")


@dataclass
class KernelTemplate:
    """An op's axes and a builder that turns one point of them into the
    op's `apply`. `seed` is the coordinate descent's start: today's
    launch. `kernel`: the points launch the port's kernels."""

    op: str
    base: str
    axes: Tuple[Axis, ...]
    build: Callable[[Dict[str, Any]], Callable[..., Any]]
    seed: Dict[str, Any]
    kernel: bool = True
    doc: str = ""
    #: (config, shapes, dtype) -> hashable key of what the point executes
    #: at those shapes; the search times one point of each key
    bench_key: Optional[Callable[..., Any]] = None
    #: the axis whose non-off value makes a point claim a neighbour's work
    fuse_axis: Optional[str] = None
    #: the member ops a pure-fusion op's points compose
    fuses: Tuple[str, ...] = ()
    #: (config, shapes, dtype) -> bytes of dynamic shared memory a block
    #: takes, -1 where the kernel's plan refuses the point; None: no rule
    #: (no kernel), never pruned
    smem_footprint: Optional[Callable[..., int]] = None

    def __post_init__(self):
        self.seed = self.validate(self.seed)

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"template {self.op}/{self.base}: no axis {name!r}")

    def validate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Canonicalize a config: every axis present, every value in its
        choice set, declaration order."""
        out = {}
        for a in self.axes:
            if a.name not in config:
                raise KeyError(f"template {self.op}/{self.base}: config "
                               f"missing axis {a.name!r}")
            v = config[a.name]
            if v not in a.choices:
                raise ValueError(
                    f"template {self.op}/{self.base}: {a.name}={v!r} not "
                    f"in {a.choices}")
            out[a.name] = v
        extra = set(config) - set(out)
        if extra:
            raise KeyError(f"template {self.op}/{self.base}: unknown "
                           f"axes {sorted(extra)}")
        return out

    @property
    def size(self) -> int:
        return math.prod(len(a.choices) for a in self.axes)

    def configs(self) -> List[Dict[str, Any]]:
        """The full cross product, declaration-ordered."""
        points: List[Dict[str, Any]] = [{}]
        for a in self.axes:
            points = [{**p, a.name: c} for p in points for c in a.choices]
        return points

    def name(self, config: Dict[str, Any]) -> str:
        cfg = self.validate(config)
        inner = ",".join(f"{k}={cfg[k]}" for k in cfg)
        return f"{self.base}[{inner}]"

    _NAME_RE = re.compile(r"^(?P<base>[A-Za-z0-9_]+)\[(?P<cfg>[^\]]*)\]$")

    def parse(self, name: str) -> Optional[Dict[str, Any]]:
        """The config a generated name encodes; None when the name is not
        this template's (another base, an unknown axis, a value outside
        the space: a stale cache degrades, it does not crash)."""
        m = self._NAME_RE.match(name)
        if m is None or m.group("base") != self.base:
            return None
        cfg: Dict[str, Any] = {}
        for part in filter(None, m.group("cfg").split(",")):
            if "=" not in part:
                return None
            k, _, raw = part.partition("=")
            try:
                ax = self.axis(k)
            except KeyError:
                return None
            val: Any = int(raw) if raw.lstrip("-").isdigit() else raw
            if val not in ax.choices:
                return None
            cfg[k] = val
        try:
            return self.validate(cfg)
        except (KeyError, ValueError):
            return None


_TEMPLATES: Dict[str, List[KernelTemplate]] = {}


def register_template(t: KernelTemplate) -> KernelTemplate:
    _TEMPLATES.setdefault(t.op, []).append(t)
    return t


def templates_for(op: str) -> List[KernelTemplate]:
    return list(_TEMPLATES.get(op, ()))


def template_ops() -> List[str]:
    return sorted(_TEMPLATES)


def parse_point(op: str, name: Any):
    """(template, config) of a generated name of `op`, or None."""
    if not isinstance(name, str):
        return None
    for t in templates_for(op):
        cfg = t.parse(name)
        if cfg is not None:
            return t, cfg
    return None


#: fuse-axis values that mean "do not fuse": the composed point
_FUSE_OFF = (0, "none", "off", None)


def fusion_config(op: str, name: Any) -> Optional[Dict[str, Any]]:
    """The config of `name` if it is a FUSED point of one of op's
    templates (its fuse axis on); None for composed or foreign names."""
    parsed = parse_point(op, name)
    if parsed is None or parsed[0].fuse_axis is None:
        return None
    t, cfg = parsed
    return cfg if cfg.get(t.fuse_axis) not in _FUSE_OFF else None


def materialize(op: str, name: str) -> Optional["variants.Variant"]:
    """Register-on-demand: a generated name back into a registry entry;
    None when no template of `op` owns the name."""
    parsed = parse_point(op, name)
    if parsed is None:
        return None
    t, cfg = parsed
    return variants.register(variants.Variant(
        op=op, name=t.name(cfg), apply=t.build(cfg),
        fused=fusion_config(op, name) is not None, kernel=t.kernel,
        generated=True, doc=f"generated from template {t.base} at {cfg}"))


def fusion_members(op: str) -> Tuple[str, ...]:
    """The member ops a pure-fusion op's points claim (() elsewhere)."""
    out: List[str] = []
    for t in templates_for(op):
        for m in t.fuses:
            if m not in out:
                out.append(m)
    return tuple(out)


def fusion_point(op: str, unit: Any = None):
    """The variant `op` resolves to now if it is a fused point (the
    hand-written `lrn_maxpool` `fused` or a template point with its fuse
    axis on), else None: the gate of the claimed-pair rule."""
    v = variants.resolve(op, unit=unit)
    return v if v.fused else None


def space_signature(op: str) -> List[Dict[str, Any]]:
    """Cache-key payload of a template-searched op: the space itself (a
    changed axis or choice set invalidates old decisions)."""
    return [{"template": t.base,
             "axes": {a.name: list(a.choices) for a in t.axes},
             "seed": dict(t.seed)} for t in templates_for(op)]


# ===========================================================================
# Equivalence ledger
# ===========================================================================

#: op -> contract(apply, device) -> detail dict; raises on a mismatch
CONTRACTS: Dict[str, Callable[..., Dict[str, Any]]] = {}
#: (op, variant-name) -> {"status": "pass"|"fail", ...}, for this process
_LEDGER: Dict[Tuple[str, str], Dict[str, Any]] = {}


def check_equivalence(op: str, name: str, force: bool = False,
                      device=None) -> Dict[str, Any]:
    """Run op's contract on the named candidate on `device` (the card
    unless the CPU is asked for) and record the outcome. Idempotent per
    (op, name) unless `force`."""
    rec = _LEDGER.get((op, name))
    if rec is not None and not force:
        return rec
    dev = make_device(device)
    contract = CONTRACTS.get(op)
    if contract is None:
        rec = {"status": "fail",
               "error": f"op {op!r} has no equivalence contract"}
    else:
        try:
            v = variants.get(op, name)
            rec = {"status": "pass", "device": str(dev),
                   **(contract(v.apply, dev) or {})}
        except Exception as e:  # noqa: BLE001 — a failing candidate is
            # data (the search skips it), never a search abort
            rec = {"status": "fail", "device": str(dev),
                   "error": f"{e!s:.300}"}
    _LEDGER[(op, name)] = rec
    return rec


def equivalence_record(op: str, name: str) -> Optional[Dict[str, Any]]:
    rec = _LEDGER.get((op, name))
    return dict(rec) if rec else None


def passed(op: str, name: str) -> bool:
    rec = _LEDGER.get((op, name))
    return bool(rec) and rec.get("status") == "pass"


def clear_ledger() -> None:
    _LEDGER.clear()


def ledger_table() -> Dict[str, str]:
    return {f"{op}/{name}": rec.get("status", "?")
            for (op, name), rec in _LEDGER.items()}


# ===========================================================================
# Microbenches: how a candidate below the unit graph is timed
# ===========================================================================

#: op -> bench(apply, repeats, device) -> seconds per call
BENCHES: Dict[str, Callable[..., float]] = {}


def bench_candidate(op: str, name: str, repeats: int = 2,
                    device=None) -> float:
    """Seconds per forward (+ backward where differentiable) call of the
    named candidate at the op's bench shapes; refuses a candidate without
    a passing ledger record."""
    if not passed(op, name):
        raise UngatedCandidateError(
            f"{op}/{name}: refusing to time a candidate with no passing "
            "equivalence record")
    dev = make_device(device)
    return BENCHES[op](variants.get(op, name).apply, repeats, dev)


def time_call(fn: Callable[[], Any], repeats: int,
              device: torch.device) -> float:
    """Seconds of the fastest of `repeats` calls of `fn` after one
    warm-up call: CUDA events around each call on the card,
    `perf_counter` on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(max(1, repeats)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _t(a: np.ndarray, device, grad: bool = False) -> torch.Tensor:
    """A copy of `a` on `device` (an in-place candidate must not write
    into the golden's inputs)."""
    return torch.tensor(a, device=device).requires_grad_(grad)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _fwd_bwd(apply, *args, **kw):
    """A bench's unit of work: the forward and the backward of its output
    summed, through the candidate."""
    def run():
        leaves = [a for a in args if isinstance(a, torch.Tensor)
                  and a.requires_grad]
        y = apply(*args, **kw)
        torch.autograd.grad(y.float().sum(), leaves)
    return run


def _is_narrow(dtype) -> bool:
    return dtype is not None and str(dtype) in ("bfloat16", "torch.bfloat16")


def _bench_dtype(device: torch.device) -> torch.dtype:
    """The main path's compute dtype on the card (bf16 over f32 master
    weights); f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


#: the main path's shapes (AlexNet at batch 128 on the card) and small
#: ones on the CPU
_LRN_INPUTS = {"cuda": ((128, 55, 55, 96), (128, 27, 27, 256)),
               "cpu": ((8, 6, 6, 16),)}
_HALF = 2   # AlexNet's LRN n = 5


def _lrn_shapes(shapes: Dict[str, Any]) -> List[int]:
    """The op's channel widths (`shapes_from_signatures`), else AlexNet's."""
    return [int(c) for c in shapes.get("c")
            or [s[-1] for s in _LRN_INPUTS["cuda"]]]


def _io_eff(io: str, dtype) -> str:
    """The instance a point launches: `io=f32` and an f32 step both run
    the f32 one."""
    return "native" if io == "native" and _is_narrow(dtype) else "f32"


# -- lrn: K2's and K3's tile + the staging dtype ----------------------------


def _lrn_build(cfg):
    tile, io = cfg["tile"], cfg["io"]

    def apply(x, *, k, alpha, beta, n):
        xin = x.to(torch.float32) if io == "f32" else x
        return kernels.LRNFunction.apply(xin, k, alpha, beta, n,
                                         tile).to(x.dtype)
    return apply


def _lrn_contract(apply, device):
    rs = np.random.RandomState(3)
    k, alpha, beta, n = 2.0, 1e-4, 0.75, 5
    # JAX's (2, 4, 4, 16), and AlexNet's widths with ragged last tiles
    for shape in ((2, 4, 4, 16), (2, 9, 11, 96), (1, 5, 7, 256)):
        x = rs.randn(*shape).astype(np.float32)
        g = rs.randn(*shape).astype(np.float32)
        xt = _t(x, device, True)
        with full_f32(device):
            y = apply(xt, k=k, alpha=alpha, beta=beta, n=n)
            (dx,) = torch.autograd.grad(y, [xt], _t(g, device))
        np.testing.assert_allclose(_np(y), ref.lrn_forward(
            x, k, alpha, beta, n), atol=2e-5, err_msg=f"{shape}")
        np.testing.assert_allclose(_np(dx), ref.lrn_backward(
            x, g, k, alpha, beta, n), atol=2e-5, err_msg=f"{shape} bwd")
    return {"checked": "lrn fwd+bwd vs ops.reference at C 16, 96, 256 "
                       "(ragged last tiles), atol 2e-5"}


def _lrn_bench(apply, repeats, device):
    dt = _bench_dtype(device)
    gen = torch.Generator(device).manual_seed(0)
    xs = [torch.randn(s, generator=gen, device=device).to(dt)
          .requires_grad_(True) for s in _LRN_INPUTS[device.type]]
    runs = [_fwd_bwd(apply, x, k=2.0, alpha=1e-4, beta=0.75, n=5)
            for x in xs]
    return time_call(lambda: [r() for r in runs], repeats, device)


def _lrn_plans(cfg, shapes):
    return tuple((kernels.lrn_rows_plan(c, _HALF, cfg["tile"]),
                  kernels.lrn_rows_plan(c, _HALF, cfg["tile"], True))
                 for c in _lrn_shapes(shapes))


def _lrn_smem(cfg, shapes, dtype):
    """The larger of K2's and K3's block at each of the op's widths."""
    plans = _lrn_plans(cfg, shapes)
    if any(p is None for pair in plans for p in pair):
        return -1
    return max(p[2] for pair in plans for p in pair)


def _lrn_bench_key(cfg, shapes, dtype):
    plans = tuple(tuple(p[:2] if p else None for p in pair)
                  for pair in _lrn_plans(cfg, shapes))
    return (_io_eff(cfg["io"], dtype), plans)


register_template(KernelTemplate(
    op="lrn", base="cuda",
    axes=(Axis("tile", (1536, 3072, 6144, 12288),
               doc="K2's and K3's own elements of a block (whole rows of "
                   "C channels, or one row's run), capped by the 48 KB "
                   "their plans allow"),
          Axis("io", ("native", "f32"),
               doc="device memory's dtype: the step's (bf16 under a bf16 "
                   "step, half the bytes) or f32 (cast around the f32 "
                   "instances)")),
    build=_lrn_build, seed={"tile": 3072, "io": "native"},
    bench_key=_lrn_bench_key, smem_footprint=_lrn_smem,
    doc="K2/K3 over their tile x staging dtype (the hand-written `kernel` "
        "is tile 3072, native)"))
CONTRACTS["lrn"] = _lrn_contract
BENCHES["lrn"] = _lrn_bench


# -- flash_attn: the compiled tiles, the key order and the dropout epilogue -


def _flash_build(cfg):
    kv_order, drop = cfg["kv_order"], cfg["drop"]

    def apply(q, k, v, scale=None, causal=False, drop_mask=None):
        return kernels.FlashAttentionFunction.apply(
            q, k, v, causal, scale, kv_order,
            drop_mask if drop else None)
    #: the contract and the bench read the fuse axis off the closure, so
    #: that a fused point is checked and timed with its mask
    apply.fusion_drop = drop
    return apply


def _flash_contract(apply, device):
    rs = np.random.RandomState(7)
    b, s, h, d = 1, 256, 2, 8
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    w = rs.randn(b, s, h, d).astype(np.float32)
    wt = _t(w, device)

    def grads(fn, *extra):
        ts = [_t(a, device, True) for a in (q, k, v)]
        with full_f32(device):
            out = fn(*ts, *extra)
            gs = torch.autograd.grad((out * wt).sum(), ts)
        return out, gs

    for causal in (False, True):
        got, gg = grads(lambda *a: apply(*a, causal=causal))
        np.testing.assert_allclose(_np(got), ref.mha_forward(
            q, k, v, causal=causal), rtol=2e-4, atol=2e-5)
        _, gw = grads(lambda *a: attention.mha_forward(*a, causal=causal))
        for nm, a, e in zip("qkv", gg, gw):
            np.testing.assert_allclose(_np(a), _np(e), rtol=5e-4,
                                       atol=5e-5, err_msg=nm)
    checked = ("flash fwd vs ops.reference.mha_forward + bwd vs the "
               "einsum golden's autograd, causal and not")
    if getattr(apply, "fusion_drop", 0):
        mask = ref.make_dropout_mask(np.random.RandomState(17),
                                     (b, s, h, d), 0.4).astype(np.float32)
        mt = _t(mask, device)
        got, gg = grads(lambda *a: apply(*a, causal=True, drop_mask=mt))
        np.testing.assert_allclose(
            _np(got), ref.attn_dropout_forward(q, k, v, mask, causal=True),
            rtol=2e-4, atol=2e-5)
        _, gw = grads(lambda *a: attention.mha_forward(*a, causal=True)
                      * mt)
        for nm, a, e in zip("qkv", gg, gw):
            np.testing.assert_allclose(_np(a), _np(e), rtol=5e-4,
                                       atol=5e-5, err_msg=f"drop {nm}")
        checked += " + dropout epilogue vs the composed attn_dropout golden"
    return {"checked": checked}


#: the char-transformer's bench shape on the card, small on the CPU
_FLASH_SHAPE = {"cuda": (32, 4096, 4, 16), "cpu": (1, 256, 1, 8)}


def _flash_bench(apply, repeats, device):
    shape = _FLASH_SHAPE[device.type]
    gen = torch.Generator(device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               .requires_grad_(True) for _ in range(3))
    kw = {"causal": True}
    if getattr(apply, "fusion_drop", 0):
        kw["drop_mask"] = (torch.rand(shape, generator=gen, device=device)
                           < 0.5).float() * 2.0
    run = _fwd_bwd(apply, q, k, v, **kw)
    with full_f32(device):
        return time_call(run, repeats, device)


def _flash_smem(cfg, shapes, dtype):
    """The larger of K6's and K7's block at the op's head width."""
    d = int(shapes.get("d") or _FLASH_SHAPE["cuda"][3])
    fwd = kernels.flash_attention_forward_smem_bytes(d)
    bwd = kernels.flash_attention_backward_smem_bytes(d)
    return -1 if min(fwd, bwd) < 0 else max(fwd, bwd)


register_template(KernelTemplate(
    op="flash_attn", base="cuda",
    axes=(Axis("blk_q", (64,), doc="query rows a block (the compiled "
                                   "Tiles<D>: flash_common.cuh)"),
          Axis("blk_k", (64,), doc="key rows a streamed tile (compiled)"),
          Axis("kv_order", ("fwd", "rev"),
               doc="the forward's key-tile visit order (the online "
                   "softmax does not depend on it; K6's reverse_kv)"),
          Axis("drop", (0, 1),
               doc="FUSE axis: the pre-scaled dropout mask applied in K6's "
                   "final write; gated by the composed attn_dropout "
                   "golden")),
    build=_flash_build,
    seed={"blk_q": 64, "blk_k": 64, "kv_order": "fwd", "drop": 0},
    bench_key=lambda cfg, shapes, dtype: tuple(cfg.values()),
    fuse_axis="drop", smem_footprint=_flash_smem,
    doc="K6/K7 over key order x dropout epilogue (the hand-written "
        "`kernel` is fwd, no mask)"))
CONTRACTS["flash_attn"] = _flash_contract
BENCHES["flash_attn"] = _flash_bench


# -- sgd_update: K1's block -------------------------------------------------


def _sgd_build(cfg):
    threads = cfg["threads"]

    def apply(params, grads, vel, cfg_, lr_scale=1.0):
        variants.sgd_kernel_update(params, grads, vel, cfg_, lr_scale,
                                   threads=threads)
    return apply


def _sgd_contract(apply, device):
    rs = np.random.RandomState(11)
    cfg = optim.SGDConfig(lr=0.05, momentum=0.9, weight_decay=1e-3,
                          lr_bias_mult=2.0)
    params = {"weights": rs.randn(33, 17).astype(np.float32),
              "bias": rs.randn(5).astype(np.float32)}
    grads = {k: rs.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    vel = {k: rs.randn(*v.shape).astype(np.float32)
           for k, v in params.items()}
    pt, gt, vt = ({k: _t(a, device) for k, a in d.items()}
                  for d in (params, grads, vel))
    apply(pt, gt, vt, cfg, 0.5)
    for k in params:
        lr = cfg.lr * 0.5 * (cfg.lr_bias_mult if params[k].ndim == 1
                             else 1.0)
        pg, vg = ref.sgd_momentum_update(params[k], grads[k], vel[k], lr,
                                         cfg.momentum, cfg.weight_decay)
        np.testing.assert_allclose(_np(pt[k]), pg, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(_np(vt[k]), vg, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    return {"checked": "sgd+momentum+wd vs ops.reference, incl. the 1-D "
                       "bias lr multiplier, rtol 1e-5"}


#: AlexNet's 16 leaves on the card (its widths at 1000 classes), small on
#: the CPU
_SGD_LEAVES = {"cuda": ((11, 11, 3, 96), (96,), (5, 5, 96, 256), (256,),
                        (3, 3, 256, 384), (384,), (3, 3, 384, 384), (384,),
                        (3, 3, 384, 256), (256,), (9216, 4096), (4096,),
                        (4096, 4096), (4096,), (4096, 1000), (1000,)),
               "cpu": ((256, 65), (65,))}


def _sgd_bench(apply, repeats, device):
    cfg = optim.SGDConfig(lr=0.01, momentum=0.9, weight_decay=1e-4)
    gen = torch.Generator(device).manual_seed(2)
    leaves = _SGD_LEAVES[device.type]
    p, g, v = ({f"l{i}": torch.randn(s, generator=gen, device=device)
                for i, s in enumerate(leaves)} for _ in range(3))
    return time_call(lambda: apply(p, g, v, cfg), repeats, device)


register_template(KernelTemplate(
    op="sgd_update", base="cuda_rows",
    axes=(Axis("threads", (128, 256, 512, 1024),
               doc="K1's threads a block (grid-stride over float4s)"),),
    build=_sgd_build, seed={"threads": 256},
    bench_key=lambda cfg, shapes, dtype: (cfg["threads"],),
    smem_footprint=lambda cfg, shapes, dtype: 0,
    doc="K1 over its block (the hand-written `kernel` is 256 threads)"))
CONTRACTS["sgd_update"] = _sgd_contract
BENCHES["sgd_update"] = _sgd_bench


# -- maxpool: forward algorithm x the slices fold's combine DAG -------------


def _maxpool_build(cfg):
    algo, fold = cfg["algo"], cfg["fold"]

    def apply(x, ksize, stride, use_abs):
        if algo == "reduce_window":
            return variants.get("maxpool", "reduce_window").apply(
                x, ksize, stride, use_abs)
        return functional.maxpool_forward_slices(
            x, tuple(ksize), tuple(stride), use_abs, fold=fold)
    return apply


def _maxpool_contract(apply, device):
    rs = np.random.RandomState(9)
    x = rs.randn(2, 7, 7, 6).astype(np.float32)
    for use_abs in (False, True):
        xt = _t(x, device, True)
        y = apply(xt, (3, 3), (2, 2), use_abs)
        yg, idx = ref.maxpool_forward(x, (3, 3), (2, 2), use_abs)
        np.testing.assert_allclose(_np(y), yg, atol=1e-6,
                                   err_msg=f"use_abs={use_abs}")
        g = rs.randn(*yg.shape).astype(np.float32)
        (dx,) = torch.autograd.grad(y, [xt], _t(g, device))
        np.testing.assert_allclose(_np(dx), ref.maxpool_backward(
            g, idx, x.shape), atol=1e-6, err_msg=f"use_abs={use_abs} bwd")
    return {"checked": "maxpool fwd+bwd (max + maxabs) vs ops.reference, "
                       "atol 1e-6"}


def _maxpool_bench(apply, repeats, device):
    shape = (128, 55, 55, 96) if device.type == "cuda" else (8, 13, 13, 8)
    gen = torch.Generator(device).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=device) \
        .to(_bench_dtype(device)).requires_grad_(True)
    return time_call(_fwd_bwd(apply, x, (3, 3), (2, 2), False), repeats,
                     device)


register_template(KernelTemplate(
    op="maxpool", base="gen",
    axes=(Axis("algo", ("reduce_window", "slices"),
               doc="forward lowering (what the backward lowers to: the "
                   "index scatter vs selects)"),
          Axis("fold", ("linear", "tree"),
               doc="slices combine-DAG: left fold vs pairwise tree; inert "
                   "for reduce_window")),
    build=_maxpool_build,
    seed={"algo": "reduce_window", "fold": "linear"}, kernel=False,
    bench_key=lambda cfg, shapes, dtype: (
        cfg["algo"], cfg["fold"] if cfg["algo"] == "slices" else "-"),
    doc="max/maxabs pooling over algorithm x backward combine shape"))
CONTRACTS["maxpool"] = _maxpool_contract
BENCHES["maxpool"] = _maxpool_bench


# -- conv_stem: packing x accumulator dtype x the LRN epilogue --------------


def _conv_stem_build(cfg):
    pack, acc, epi = cfg["pack"], cfg["acc"], cfg["epi"]

    def apply(x, w, b, stride, padding, activation, epilogue=None):
        y = functional.conv2d_forward(x, w, b, tuple(stride),
                                      tuple(padding), activation,
                                      s2d=pack == "s2d", acc=acc)
        if epi == "lrn" and epilogue is not None:
            # the claimed successor's LRN, through K2 and K3
            y = kernels.LRNFunction.apply(y, epilogue["k"],
                                          epilogue["alpha"],
                                          epilogue["beta"], epilogue["n"])
        return y
    apply.fusion_epi = epi
    return apply


def _conv_stem_contract(apply, device):
    rs = np.random.RandomState(13)
    x = rs.randn(2, 19, 19, 3).astype(np.float32)
    w = (rs.randn(5, 5, 3, 8) * 0.1).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    stride, padding, act = (4, 4), (0, 0), "strictrelu"

    def run(g, **kw):
        ts = [_t(a, device, True) for a in (x, w, b)]
        with full_f32(device):
            y = apply(*ts, stride, padding, act, **kw)
            return y, torch.autograd.grad(y, ts, _t(g, device))

    yg = ref.conv2d_forward(x, w, b, stride, padding, act)
    g = rs.randn(*yg.shape).astype(np.float32)
    y, (dx, dw, db) = run(g)
    np.testing.assert_allclose(_np(y), yg, rtol=1e-4, atol=1e-4)
    gx, gw, gb = ref.conv2d_backward(x, w, yg, g, stride, padding, act)
    np.testing.assert_allclose(_np(dx), gx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dw), gw, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(db), gb, rtol=1e-4, atol=1e-4)
    checked = ("stem conv fwd+bwd (stride-4 thin-channel) vs "
               "ops.reference, rtol 1e-4")
    if getattr(apply, "fusion_epi", "none") == "lrn":
        epi = {"k": 2.0, "alpha": 1e-3, "beta": 0.75, "n": 5}
        y2g = ref.conv_lrn_forward(x, w, b, stride, padding, act, **epi)
        g2 = rs.randn(*y2g.shape).astype(np.float32)
        y2, (dx2, dw2, db2) = run(g2, epilogue=epi)
        np.testing.assert_allclose(_np(y2), y2g, rtol=1e-4, atol=1e-4)
        gx2, gw2, gb2 = ref.conv_lrn_backward(x, w, b, g2, stride, padding,
                                              act, **epi)
        np.testing.assert_allclose(_np(dx2), gx2, rtol=1e-4, atol=1e-4,
                                   err_msg="epi dx")
        np.testing.assert_allclose(_np(dw2), gw2, rtol=1e-4, atol=1e-3,
                                   err_msg="epi dw")
        np.testing.assert_allclose(_np(db2), gb2, rtol=1e-4, atol=1e-4,
                                   err_msg="epi db")
        checked += " + LRN epilogue vs the composed conv_lrn golden"
    return {"checked": checked}


def _conv_stem_bench(apply, repeats, device):
    n, hw, co = (128, 227, 96) if device.type == "cuda" else (4, 35, 16)
    dt = _bench_dtype(device)
    gen = torch.Generator(device).manual_seed(5)
    x = torch.randn((n, hw, hw, 3), generator=gen, device=device).to(dt)
    w = (torch.randn((11, 11, 3, co), generator=gen, device=device)
         * 0.05).to(dt).requires_grad_(True)
    b = torch.randn((co,), generator=gen, device=device).to(dt) \
        .requires_grad_(True)
    kw = {}
    if getattr(apply, "fusion_epi", "none") == "lrn":
        kw["epilogue"] = {"k": 2.0, "alpha": 1e-4, "beta": 0.75, "n": 5}
    with full_f32(device):
        return time_call(_fwd_bwd(apply, x, w, b, (4, 4), (0, 0),
                                  "strictrelu", **kw), repeats, device)


register_template(KernelTemplate(
    op="conv_stem", base="gen",
    axes=(Axis("pack", ("direct", "s2d"),
               doc="input packing: the strided conv vs the exact "
                   "space-to-depth rewrite"),
          Axis("acc", ("native", "f32"),
               doc="the convolution's accumulation under sub-f32 compute: "
                   "the backend's vs pinned f32"),
          Axis("epi", ("none", "lrn"),
               doc="FUSE axis: the successor LRN unit's work claimed after "
                   "the stem (through K2/K3); gated by the composed "
                   "conv_lrn golden")),
    build=_conv_stem_build,
    seed={"pack": "s2d", "acc": "native", "epi": "none"}, kernel=False,
    bench_key=lambda cfg, shapes, dtype: (
        cfg["pack"], cfg["acc"] if _is_narrow(dtype) else "native",
        cfg["epi"]),
    fuse_axis="epi",
    doc="strided thin-channel entry conv over packing x accumulator x "
        "LRN-epilogue fusion"))
CONTRACTS["conv_stem"] = _conv_stem_contract
BENCHES["conv_stem"] = _conv_stem_bench


# -- lrn_maxpool: the searched cross-op fusion ------------------------------


def _lrn_pool_build(cfg):
    rb, cb, io, fuse = cfg["rb"], cfg["cb"], cfg["io"], cfg["fuse"]
    if not fuse:
        # the composed point: the LRN (K2/K3), then the ceil-mode pool
        def apply(x, *, k, alpha, beta, n, ksize, stride):
            y = kernels.LRNFunction.apply(x, k, alpha, beta, n)
            return functional.maxpool_forward(y, tuple(ksize),
                                              tuple(stride))
        return apply

    def apply(x, *, k, alpha, beta, n, ksize, stride):
        xin = x.to(torch.float32) if io == "f32" else x
        return kernels.LRNMaxPoolFunction.apply(
            xin, k, alpha, beta, n, tuple(ksize), tuple(stride), rb,
            cb).to(x.dtype)
    return apply


def _lrn_pool_contract(apply, device):
    rs = np.random.RandomState(21)
    k, alpha, beta, n = 2.0, 1e-4, 0.75, 5
    ksize, stride = (3, 3), (2, 2)
    # JAX's 8x8 (a ceil-mode edge window) and 9x9 at C 16, and C 40 over
    # 27x27: two channel tiles, bands ragged at every rb and cb
    for shape in ((2, 8, 8, 16), (2, 9, 9, 16), (1, 27, 27, 40)):
        x = rs.randn(*shape).astype(np.float32)
        xt = _t(x, device, True)
        yg = ref.lrn_maxpool_forward(x, k, alpha, beta, n, ksize, stride)
        g = rs.randn(*yg.shape).astype(np.float32)
        with full_f32(device):
            y = apply(xt, k=k, alpha=alpha, beta=beta, n=n, ksize=ksize,
                      stride=stride)
            (dx,) = torch.autograd.grad(y, [xt], _t(g, device))
        np.testing.assert_allclose(_np(y), yg, atol=2e-5,
                                   err_msg=f"{shape}")
        np.testing.assert_allclose(
            _np(dx), ref.lrn_maxpool_backward(x, g, k, alpha, beta, n,
                                              ksize, stride),
            atol=2e-5, err_msg=f"{shape} bwd")
    return {"checked": "LRN+maxpool fwd+bwd vs the COMPOSED ops.reference "
                       "golden (ceil-mode edge windows, two channel "
                       "tiles), atol 2e-5"}


#: AlexNet's two norm->pool inputs (H, W, C), 3x3/2 pools
_POOL_INPUTS = {"cuda": ((55, 55, 96), (27, 27, 256)), "cpu": ((13, 13, 16),)}


def _lrn_pool_bench(apply, repeats, device):
    nb = 128 if device.type == "cuda" else 8
    dt = _bench_dtype(device)
    gen = torch.Generator(device).manual_seed(8)
    runs = [_fwd_bwd(apply, torch.randn((nb,) + s, generator=gen,
                                        device=device).to(dt)
                     .requires_grad_(True), k=2.0, alpha=1e-4, beta=0.75,
                     n=5, ksize=(3, 3), stride=(2, 2))
            for s in _POOL_INPUTS[device.type]]
    return time_call(lambda: [r() for r in runs], repeats, device)


def _lrn_pool_plans(cfg, shapes):
    ky, kx = shapes.get("ksize") or (3, 3)
    sy, sx = shapes.get("stride") or (2, 2)
    out = []
    for h, w, c in shapes.get("inputs") or _POOL_INPUTS["cuda"]:
        oh, ow = functional.pool_out_hw(h, w, ky, kx, sy, sx)
        out.append(kernels.lrn_maxpool_plan(h, w, c, oh, ow, ky, kx, sy,
                                            sx, _HALF, cfg["rb"],
                                            cfg["cb"]))
    return tuple(out)


def _lrn_pool_smem(cfg, shapes, dtype):
    """K4's block at each of the op's inputs; 0 for a composed point
    (K2 and K3 at their own tile, which always fits)."""
    if not cfg["fuse"]:
        return 0
    plans = _lrn_pool_plans(cfg, shapes)
    return -1 if None in plans else max(p[2] for p in plans)


def _lrn_pool_bench_key(cfg, shapes, dtype):
    if not cfg["fuse"]:
        return ("composed",)
    return (_io_eff(cfg["io"], dtype),
            tuple(p[:2] if p else None
                  for p in _lrn_pool_plans(cfg, shapes)))


register_template(KernelTemplate(
    op="lrn_maxpool", base="fused",
    axes=(Axis("rb", (1, 2, 3, 4), doc="K4's pooled rows a band"),
          Axis("cb", (8, 16, 32), doc="K4's pooled columns a band at most"),
          Axis("io", ("native", "f32"),
               doc="device memory's dtype (the lrn template's axis)"),
          Axis("fuse", (0, 1),
               doc="FUSE axis: 0 = the composed members (K2, K3 and the "
                   "pool), 1 = K4 forward and K5 backward over the pair")),
    build=_lrn_pool_build,
    seed={"rb": 3, "cb": 16, "io": "native", "fuse": 1},
    bench_key=_lrn_pool_bench_key, fuse_axis="fuse",
    fuses=("lrn", "maxpool"), smem_footprint=_lrn_pool_smem,
    doc="the (lrn, maxpool) pair over K4's band x staging dtype x fuse on "
        "or off, every point gated on the composed golden (the "
        "hand-written `fused` is 3 x 16, native)"))
CONTRACTS["lrn_maxpool"] = _lrn_pool_contract
BENCHES["lrn_maxpool"] = _lrn_pool_bench


# ===========================================================================
# serve_forward: the serving wire (no template: the search never times it)
# ===========================================================================


def _serve_contract(apply, device):
    """The JAX package's `_serve_contract` (ops/templates.py:1230-1306
    there): a 24 -> 96 -> 4 tanh MLP whose first weight is wide enough
    for the int8 block (quantized) and whose second is not (left f32).
    The int8 transform must be ops/reference.serve_quantize_weight bit
    for bit; the f32 and int8 forwards must meet the numpy golden of the
    same transform (2e-5); every wire must stay within its serving
    tolerance of the unquantized f32 forward (1e-5 f32; 5e-2 bf16, int8)."""
    cfg = apply.sv_config
    rs = np.random.RandomState(7)
    w1 = (rs.randn(24, 96) * 0.2).astype(np.float32)
    b1 = (rs.randn(96) * 0.1).astype(np.float32)
    w2 = (rs.randn(96, 4) * 0.2).astype(np.float32)
    b2 = (rs.randn(4) * 0.1).astype(np.float32)
    params = ({"weights": w1, "bias": b1}, {"weights": w2, "bias": b2})
    x = rs.randn(8, 24).astype(np.float32)

    def forward(p, xb):
        h = torch.tanh(xb @ p[0]["weights"] + p[0]["bias"])
        return h @ p[1]["weights"] + p[1]["bias"]

    name = {v["wire"]: k for k, v in variants._SERVE_NAMED.items()}[
        cfg["wire"]]
    prepared, shapes = variants.serve_prepare_params(name, params)
    if cfg["wire"] == "int8":
        for w, layer in ((w1, prepared[0]), (w2, prepared[1])):
            if w.shape[-1] >= cfg["blk"]:
                qg, sg = ref.serve_quantize_weight(w, cfg["blk"])
                np.testing.assert_array_equal(layer["weights"]["q"].numpy(),
                                              qg)
                np.testing.assert_array_equal(layer["weights"]["s"].numpy(),
                                              sg)
            else:
                np.testing.assert_array_equal(layer["weights"].numpy(), w)
    with torch.inference_mode(), full_f32(device):
        out = _np(apply(variants.serve_to_device(prepared, device),
                        _t(x, device), forward, shapes))
    f32 = ref.serve_forward_mlp(x, ((w1, b1), (w2, b2)))
    if cfg["wire"] == "int8":
        deq = []
        for w, b in ((w1, b1), (w2, b2)):
            if w.shape[-1] >= cfg["blk"]:
                q, s = ref.serve_quantize_weight(w, cfg["blk"])
                w = ref.dequantize_blockwise(q, s, cfg["blk"])[
                    :, :w.shape[-1]].reshape(w.shape)
            deq.append((w, b))
        np.testing.assert_allclose(out, ref.serve_forward_mlp(x, deq),
                                   rtol=2e-5, atol=2e-5)
    elif cfg["wire"] == "f32":
        np.testing.assert_allclose(out, f32, rtol=2e-5, atol=2e-5)
    tol = {"f32": 1e-5, "bf16": 5e-2, "int8": 5e-2}[cfg["wire"]]
    err = float(np.max(np.abs(out - f32)))
    if err > tol:
        raise AssertionError(
            f"serve_forward/{name}: max |out - f32| = {err:.2e} exceeds the "
            f"{tol} serving tolerance")
    return {"checked": f"wire transform bitwise vs ops.reference + forward "
                       f"vs serve_forward_mlp golden; |out - f32| max "
                       f"{err:.2e} <= {tol}"}


CONTRACTS["serve_forward"] = _serve_contract
