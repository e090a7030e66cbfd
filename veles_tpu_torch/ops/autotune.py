"""The kernel search: time the candidate lowerings of a workflow's tunable
ops on the card, keep the winners selected, and cache them by device.

The port's counterpart of `veles_tpu/ops/autotune.py`. Two tiers, one
cache:

1. Flat enumeration (`autotune_workflow` without a budget): for each
   tunable op a workflow holds (discover_tunables: its `lrn`, `maxpool`,
   `conv_stem` and `flash_attn` units), every hand-written candidate,
   each gated by its contract first (ops/templates.py's ledger), timed in
   the workflow's own fused step: one `FusedTrainStep.train_repeat`
   window of `steps` steps at a time, the candidates in turns, `repeats`
   rounds, the fastest window winning.
2. The budgeted search (`budget=N`, CLI `--autotune-budget N`): the ops
   with a template, each by coordinate descent over its space from the
   template's seed after its hand-written incumbents, with the trials
   split by `priority_order` / `allocate_budget` (the per-op cost shares
   of LAYER_PROFILE.json, or the given order without one). The search
   times in rounds: an axis' alternatives beside the leader so far and
   the axis' current point, in turns, the round's fastest leading on.
   Workflow ops are timed in the step; ops below the unit graph
   (`flash_attn` where no attention unit runs it, and `sgd_update`)
   through their template's microbench. Every trial is
   gated: no passing ledger record, no timing (`UngatedCandidateError`);
   a kernel the card's shared memory cannot hold, or whose plan refuses
   the point, is pruned without timing and refused by the timed trial
   itself (`InfeasibleCandidateError`, analysis/resources.py); points
   that execute the same kernel at the op's shapes (`bench_key`) are
   timed once. Each trial's outcome is `timed`, `equiv_fail`, `error`
   (a point that failed to launch: the report says so, and nothing falls
   back to a plain version under its name), `pruned` or `alias`.

Decisions persist in a JSON file (`VELES_AUTOTUNE_CACHE`, else
~/.cache/veles_tpu_torch/autotune.json), keyed by (the CUDA device's name,
the op, the per-sample signatures of every instance of the op, the
compute dtype as `FusedTrainStep` resolves it): a winner tuned at one
batch applies at another. The file has the JAX package's schema, so both
packages may share one; their keys never meet (the port's device names:
`torch.cuda.get_device_name`, or "cpu (torch)"). A corrupt file or a
version skew logs once and re-tunes. A cache hit selects the stored winner
with no timing; a generated winner re-materializes from its name.
`apply_cached` is what a plain `--fused` run does: cache hits only, and
no winner whose kernel no longer fits.

Entry points: `autotune_workflow` (= `StandardWorkflow.autotune()` = CLI
`--autotune [--autotune-budget N]`), `search_workflow` and
`veles_tpu_torch/tools/autotune.py`. They run on the card unless the
caller asks for the CPU (`device="cpu"`), where the kernels' plain
versions run and a time says nothing of the card.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from veles_tpu_torch.analysis import resources as res
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.ops import templates, variants

__all__ = ["AutotuneCache", "autotune_workflow", "apply_cached",
           "discover_tunables", "discover_fusions", "op_cache_key",
           "default_cache_path", "search_workflow", "search_op",
           "priority_order", "allocate_budget", "incumbent_floor",
           "default_profile_path", "device_name", "TIMINGS"]

_log = logging.getLogger("veles_torch.autotune")

#: timing calls made in this process: "in_graph" (one per timed window
#: set of a fused step) and "microbench" (one per template bench); a
#: rerun that finds every winner cached adds none
TIMINGS: Dict[str, int] = {"in_graph": 0, "microbench": 0}


def default_cache_path() -> str:
    return (os.environ.get("VELES_AUTOTUNE_CACHE")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "veles_tpu_torch", "autotune.json"))


class AutotuneCache:
    """On-disk JSON decision cache: {key: record}, each record the winner
    and the timings that chose it. Schema-tagged: a corrupt file, another
    schema or a version skew logs ONCE and reads as empty (the tuner
    re-times; the next `put` rewrites the file at the current version).
    `put` keeps the entries it does not own, and replaces the file
    atomically."""

    SCHEMA = "veles-autotune"
    VERSION = 2

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, Any]] = None

    def _load(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        try:
            with open(self.path) as f:
                raw = json.load(f)
            entries = raw.get("entries")
            if raw.get("schema", self.SCHEMA) != self.SCHEMA \
                    or raw.get("version") != self.VERSION \
                    or not isinstance(entries, dict):
                raise ValueError(
                    f"schema/version skew (want {self.SCHEMA} "
                    f"v{self.VERSION}, file says "
                    f"{raw.get('schema', '<none>')} v{raw.get('version')})")
            self._data = entries
        except FileNotFoundError:
            self._data = {}
        except (OSError, ValueError, AttributeError) as e:
            _log.warning("autotune cache %s unreadable (%s): re-tuning",
                         self.path, e)
            self._data = {}
        return self._data

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        rec = self._load().get(key)
        return dict(rec) if isinstance(rec, dict) else None

    def put(self, key: str, record: Dict[str, Any]) -> None:
        data = self._load()
        data[key] = record
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"schema": self.SCHEMA, "version": self.VERSION,
                       "entries": data}, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


def _device(device) -> torch.device:
    """The search's device: the card unless the CPU is asked for (raises
    where there is no card)."""
    return make_device(device)


def device_name(device) -> str:
    """The cache's device key: the CUDA device's name, or "cpu (torch)"
    (apart from the JAX package's "cpu")."""
    dev = _device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return f"{dev.type} (torch)"


def _resolve_compute_dtype(compute_dtype: Any) -> Optional[str]:
    """The compute dtype as the fused step resolves it (None: f32)."""
    from veles_tpu_torch.parallel.fused import resolve_compute_dtype
    cd = resolve_compute_dtype(compute_dtype)
    return None if cd in (None, "float32") else cd


def op_cache_key(device_kind: str, op: str, signatures: List[Dict],
                 compute_dtype: Any = None) -> str:
    """One key per (device, op, the configuration of every instance of
    the op in the workflow: one registry selection covers them all),
    canonicalized so that dict order cannot split keys."""
    blob = json.dumps(signatures, sort_keys=True, default=str)
    h = hashlib.sha256(blob.encode()).hexdigest()[:16]
    cd = str(compute_dtype) if compute_dtype is not None else "f32"
    return f"{device_kind}|{op}|{cd}|{h}"


def _layers(wf):
    """(layer, its per-sample input shape) of each forward layer."""
    for unit, layer in zip(getattr(wf, "fwd_units", ()),
                           getattr(wf, "forwards", ())):
        shape = getattr(unit, "input_sample_shape", None)
        if shape is not None:
            yield layer, tuple(int(s) for s in shape)


def discover_tunables(wf) -> Dict[str, List[Dict]]:
    """{op: [signature, ...]} of every tunable op the workflow holds: a
    layer opts in with `variant_signature(sample_shape)` (None where it
    is not tunable as configured: an override, a conv the stem rewrite
    does not apply to, a sequence the flash gate keeps out)."""
    found: Dict[str, List[Dict]] = {}
    for layer, shape in _layers(wf):
        op = getattr(layer, "variant_op", None)
        sig_fn = getattr(layer, "variant_signature", None)
        if op is None or sig_fn is None:
            continue
        sig = sig_fn(shape)
        if sig is not None:
            found.setdefault(op, []).append(sig)
    return found


def discover_fusions(wf) -> Dict[str, List[Dict]]:
    """{fusion op: [signature, ...]} of every adjacent pair a fusion
    template could claim (an LRN followed by a max pooling, no override
    on either side: the gate of FusedForward's pairs); each signature
    joins both members'."""
    found: Dict[str, List[Dict]] = {}
    layers = list(_layers(wf))
    for (a, sa), (b, sb) in zip(layers, layers[1:]):
        if getattr(a, "variant_op", None) != "lrn" \
                or getattr(b, "variant_op", None) != "maxpool" \
                or getattr(b, "use_abs", False):
            continue
        if a.variant_override is not None or b.variant_override is not None:
            continue
        sig_a, sig_b = a.variant_signature(sa), b.variant_signature(sb)
        if sig_a is None or sig_b is None:
            continue
        found.setdefault("lrn_maxpool", []).append(
            {"lrn": sig_a, "maxpool": sig_b})
    return found


@contextlib.contextmanager
def _suspend_fusions(op: str):
    """While a MEMBER op's candidates time, a fusion op claiming it stands
    down (a claimed pair would not run the member's lowering, so every
    candidate would time the same): its unfused incumbent is selected —
    `composed`, not the port's default, which is the fused point (the
    JAX package's default is composed, so clearing sufficed there). The
    selection is restored after, even on an error."""
    suspended: Dict[str, Optional[str]] = {}
    for fop in templates.template_ops():
        if op in templates.fusion_members(fop):
            suspended[fop] = variants.selected(fop)
            unfused = next(v.name for v in variants.variants_for(fop)
                           if not v.fused)
            variants.select(fop, unfused)
    try:
        yield
    finally:
        for fop, prev in suspended.items():
            if prev is None:
                variants.clear_selection(fop)
            else:
                variants.select(fop, prev)


class _StepTimer:
    """A fused step of the workflow built under the CURRENT selection
    (its plan is fixed at build), a state, and a synthetic batch on the
    device, warmed by one window; `window()` times `steps` steps by
    `train_repeat` (CUDA events on the card). The step draws its dropout
    masks from a generator of its own, so the run's stream does not
    move."""

    def __init__(self, wf, compute_dtype, steps: int, batch: Optional[int],
                 device: torch.device) -> None:
        self.steps = steps
        self.device = device
        self.step = wf.build_fused_step(compute_dtype=compute_dtype)
        self.step.gen = torch.Generator(device).manual_seed(0)
        self.state = self.step.init_state()
        unit = wf.fwd_units[0]
        b = int(batch or wf.loader.minibatch_size)
        shape = (b,) + tuple(unit.input_sample_shape)
        gen = torch.Generator(device).manual_seed(0)
        self.x = torch.randn(shape, generator=gen, device=device)
        tokens = self._tokens(wf)
        if self.step.loss_kind == "softmax":
            hi = max(2, int(getattr(wf, "n_classes", 0) or 2))
            self.y = torch.randint(0, hi, (b * tokens,), generator=gen,
                                   device=device)
        else:
            out = tuple(wf.fwd_units[-1].sample_shape)
            self.y = torch.randn((b,) + out, generator=gen, device=device)
        self.window()

    @staticmethod
    def _tokens(wf) -> int:
        """Labels a sample: 1 for a classifier, the sequence length of a
        per-token head ((S, V) logits a sample)."""
        out = tuple(wf.fwd_units[-1].sample_shape)
        return math.prod(out[:-1]) if len(out) > 1 else 1

    def window(self) -> float:
        """Seconds per step of one window of `steps` steps."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.step.train_repeat(self.state, self.x, self.y, self.steps)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.steps
        t0 = time.perf_counter()
        self.step.train_repeat(self.state, self.x, self.y, self.steps)
        return (time.perf_counter() - t0) / self.steps


def _time_in_turns(wf, op: str, names: List[str], compute_dtype,
                   steps: int, repeats: int, batch: Optional[int],
                   device: torch.device) -> Dict[str, Any]:
    """Candidates of `op` timed in the fused step (the flat tier, and a
    round of the search): a step per candidate (each built under its
    selection), then `repeats` rounds of one window each, the candidates
    in turns; {name: the fastest window's seconds per step, or the
    error of a candidate that failed to build or launch}."""
    TIMINGS["in_graph"] += 1
    timers: Dict[str, _StepTimer] = {}
    out: Dict[str, Any] = {}
    for name in names:
        variants.select(op, name)
        try:
            timers[name] = _StepTimer(wf, compute_dtype, steps, batch,
                                      device)
        except Exception as e:  # noqa: BLE001 — one broken candidate
            # must not abort the tune; the report names it
            out[name] = f"error: {e!s:.200}"
    times: Dict[str, List[float]] = {n: [] for n in timers}
    for _ in range(max(1, repeats)):
        for name in list(timers):
            try:
                times[name].append(timers[name].window())
            except Exception as e:  # noqa: BLE001 — as above
                out[name] = f"error: {e!s:.200}"
                del timers[name], times[name]
    out.update({n: min(t) for n, t in times.items()})
    timers.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def apply_cached(wf, *, compute_dtype=None,
                 cache: Optional[AutotuneCache] = None,
                 cache_path: Optional[str] = None,
                 device=None) -> Dict[str, str]:
    """Select the cached winners of this workflow's tunable ops with no
    timing (hits only; a miss keeps the current selection): per op the
    searched key (the workflow's signatures and the template's space),
    then the flat tier's; the template ops below the unit graph by their
    space key. A winner whose kernel no longer fits the card (or a
    tightened $VELES_SMEM_BUDGET) is refused. Returns {op: variant}."""
    dev = _device(device)
    cache = cache or AutotuneCache(cache_path)
    kind = device_name(dev)
    compute_dtype = _resolve_compute_dtype(compute_dtype)
    tunables = dict(discover_tunables(wf))
    tunables.update(discover_fusions(wf))
    keys: Dict[str, List[str]] = {}
    for op, sigs in tunables.items():
        space = templates.space_signature(op)
        keys[op] = ([op_cache_key(kind, op, sigs + space, compute_dtype)]
                    if space else []) \
            + [op_cache_key(kind, op, sigs, compute_dtype)]
    for op in templates.template_ops():
        keys.setdefault(op, [op_cache_key(
            kind, op, templates.space_signature(op), compute_dtype)])
    applied: Dict[str, str] = {}
    for op, ks in keys.items():
        for key in ks:
            hit = cache.get(key)
            if hit is None or not variants.has(op, hit.get("variant")):
                continue
            ver = res.kernel_verdict(
                op, hit["variant"],
                shapes=res.shapes_from_signatures(op, tunables.get(op)),
                dtype=compute_dtype, device=dev)
            if ver is not None:
                _log.warning(
                    "autotune cache: refusing %s winner %r — %s (%d B "
                    "against %s B)", op, hit["variant"], ver["reason"],
                    ver["footprint"], ver["smem_budget"])
                continue
            variants.select(op, hit["variant"])
            applied[op] = hit["variant"]
            break
    return applied


#: ops below the unit graph the budgeted search of a workflow covers
#: through their microbench: the step's SGD leg resolves `sgd_update`, and
#: `flash_attn` is searched whatever the workflow holds, so that a cache
#: names a winner for every template op of the card
BELOW_GRAPH_OPS = ("sgd_update", "flash_attn")


def autotune_workflow(wf, *, compute_dtype=None, steps: int = 4,
                      repeats: int = 3, batch: Optional[int] = None,
                      cache: Optional[AutotuneCache] = None,
                      cache_path: Optional[str] = None,
                      force: bool = False,
                      ops: Optional[List[str]] = None,
                      budget: Optional[int] = None,
                      profile_path: Optional[str] = None,
                      smem_budget: Optional[int] = None,
                      device=None) -> Dict[str, Dict[str, Any]]:
    """Tune every tunable op of the (initialized) workflow, leave the
    winners selected, and return a report per op:

        {op: {"variant", "source": "cache"|"tuned"|"searched"|"skipped"|
              "error", "timings_s" (timed ops), "key", ...}}

    Without `budget` the flat tier; with one, the template ops (the
    workflow's, its fusion pairs and BELOW_GRAPH_OPS) go to
    `search_workflow` and the rest to the flat tier. `force` re-times
    cache hits."""
    dev = _device(device)
    cache = cache or AutotuneCache(cache_path)
    kind = device_name(dev)
    compute_dtype = _resolve_compute_dtype(compute_dtype)
    tunables = discover_tunables(wf)
    if ops:
        tunables = {k: v for k, v in tunables.items() if k in ops}
    report: Dict[str, Dict[str, Any]] = {}
    searchable: List[str] = []
    if budget:
        searchable = [op for op in tunables
                      if templates.templates_for(op)
                      and op in templates.CONTRACTS]
        extra = list(discover_fusions(wf))
        if any(getattr(g, "optimizer", "sgd") != "adam"
               for g in getattr(wf, "gds", ())):
            extra.append("sgd_update")
        extra.append("flash_attn")
        for op in extra:
            if (not ops or op in ops) and op in templates.CONTRACTS \
                    and op not in searchable:
                searchable.append(op)
        report.update(search_workflow(
            wf, ops=searchable, budget=budget, cache=cache,
            compute_dtype=compute_dtype, profile_path=profile_path,
            steps=steps, repeats=repeats, batch=batch, force=force,
            smem_budget=smem_budget, device=dev))
    for op in sorted(set(tunables) - set(searchable)):
        key = op_cache_key(kind, op, tunables[op], compute_dtype)
        hit = None if force else cache.get(key)
        if hit is not None and variants.has(op, hit.get("variant")):
            variants.select(op, hit["variant"])
            report[op] = {"variant": hit["variant"], "source": "cache",
                          "key": key}
            continue
        # the flat tier is the hand-written set, each gated first
        timings: Dict[str, Any] = {}
        cands = []
        for v in variants.variants_for(op):
            if not v.tunable or v.generated:
                continue
            eq = templates.check_equivalence(op, v.name, device=dev)
            if eq["status"] == "pass":
                cands.append(v.name)
            else:
                timings[v.name] = f"equiv_fail: {eq.get('error', '')}"
        prev = variants.selected(op)
        with _suspend_fusions(op):
            timings.update(_time_in_turns(wf, op, cands, compute_dtype,
                                          steps, repeats, batch, dev))
        ok = {k: v for k, v in timings.items() if isinstance(v, float)}
        if not ok:
            if prev is None:
                variants.clear_selection(op)
            else:
                variants.select(op, prev)
            report[op] = {"variant": variants.effective(op),
                          "source": "error", "timings_s": timings,
                          "key": key}
            continue
        winner = min(ok, key=ok.get)
        variants.select(op, winner)
        rounded = {k: (round(v, 7) if isinstance(v, float) else v)
                   for k, v in timings.items()}
        cache.put(key, {"variant": winner, "timings_s": rounded,
                        "device_kind": kind, "steps": steps,
                        "repeats": repeats, "tuned_at": time.time()})
        report[op] = {"variant": winner, "source": "tuned",
                      "timings_s": rounded, "key": key}
    return report


# ===========================================================================
# The budgeted search over generated candidates (ops/templates.py)
# ===========================================================================


def default_profile_path() -> str:
    return os.environ.get("VELES_LAYER_PROFILE_PATH", "LAYER_PROFILE.json")


def priority_order(ops: List[str],
                   profile_path: Optional[str] = None) -> List[tuple]:
    """[(op, share), ...] most expensive first, from the per-op cost
    shares of LAYER_PROFILE.json ($VELES_LAYER_PROFILE_PATH); ops the
    profile does not name keep their order with share 0, and no profile
    keeps the given order. A pure fusion op is charged the combined
    share of its members."""
    shares: Dict[str, float] = {}
    path = profile_path or default_profile_path()
    try:
        with open(path) as f:
            prof = json.load(f)
        raw = prof.get("ops", {})
        shares = {str(k): float(v) for k, v in raw.items()
                  if isinstance(v, (int, float))}
    except (OSError, ValueError, AttributeError):
        pass

    def share_of(op: str) -> float:
        s = shares.get(op, 0.0)
        for m in templates.fusion_members(op):
            s += shares.get(m, 0.0)
        return s

    return sorted(((op, share_of(op)) for op in ops), key=lambda kv: -kv[1])


def incumbent_floor(op: str) -> int:
    """Per-op minimum trials: every hand-written incumbent and at least
    one generated point."""
    hand = [v for v in variants.variants_for(op)
            if v.tunable and not v.generated]
    return len(hand) + 1


def allocate_budget(ordered: List[tuple], budget: int,
                    floors: Optional[Dict[str, int]] = None
                    ) -> Dict[str, int]:
    """Split a total trial budget across ops in proportion to their
    shares, each with its floor (`floors`, default 2); a budget too small
    for every floor goes to the highest shares first."""
    if not ordered:
        return {}

    def floor_of(op: str) -> int:
        return max(1, (floors or {}).get(op, 2))

    total_share = sum(s for _, s in ordered)
    out: Dict[str, int] = {}
    remaining = budget - sum(floor_of(op) for op, _ in ordered)
    if remaining < 0:
        left = budget
        for op, _ in ordered:
            out[op] = min(floor_of(op), left)
            left -= out[op]
        return out
    for op, share in ordered:
        frac = (share / total_share) if total_share > 0 \
            else 1.0 / len(ordered)
        out[op] = floor_of(op) + int(remaining * frac)
    leak = budget - sum(out.values())
    if leak > 0:
        out[ordered[0][0]] += leak
    return out


def _prune_verdict(op: str, template, cfg, shapes, compute_dtype,
                   device, budget) -> Optional[Dict[str, Any]]:
    """The search's pruning: None when the point fits (or its template
    has no rule), else the verdict. A seam of its own, so that a test can
    take it away and see the timed trial refuse the point by itself."""
    return res.kernel_verdict(op, template.name(cfg), shapes=shapes,
                              dtype=compute_dtype, device=device,
                              budget=budget)


#: new points a round of the search times at most, beside its leader
ROUND_POINTS = 4


def search_op(op: str, *, budget: int,
              cache: Optional[AutotuneCache] = None,
              cache_path: Optional[str] = None,
              compute_dtype: Any = None, force: bool = False,
              repeats: int = 3,
              workflow_sigs: Optional[List[Dict]] = None,
              in_graph_timer: Optional[
                  Callable[[List[str]], Dict[str, Any]]] = None,
              smem_shapes: Optional[Dict[str, Any]] = None,
              smem_budget: Optional[int] = None,
              device=None) -> Dict[str, Any]:
    """Budgeted coordinate descent over one op: its hand-written
    candidates first, then each template's space one axis at a time from
    the seed, then unseen points in order while budget is left. Every
    trial is gated (the ledger, then the kernel verdict) before it is
    timed; pruned and alias points spend no budget. The search times in
    rounds: a round's new points (an axis' alternatives, at most
    ROUND_POINTS) beside the leader so far and the axis' current point,
    in turns, and the round's fastest leads on; no time is compared with
    one of another round. The leader at the end wins, and is selected
    and cached with the full trace. `in_graph_timer(names)` times the
    named candidates in turns in the caller's fused step ({name: seconds
    a step, or the error of one that failed}); without one, each
    candidate's template microbench times it."""
    dev = _device(device)
    cache = cache or AutotuneCache(cache_path)
    kind = device_name(dev)
    compute_dtype = _resolve_compute_dtype(compute_dtype)
    sigs = list(workflow_sigs or []) + templates.space_signature(op)
    key = op_cache_key(kind, op, sigs, compute_dtype)
    hit = None if force else cache.get(key)
    if hit is not None and variants.has(op, hit.get("variant")):
        ver = res.kernel_verdict(op, hit["variant"], shapes=smem_shapes,
                                 dtype=compute_dtype, device=dev,
                                 budget=smem_budget)
        if ver is None:
            variants.select(op, hit["variant"])
            return {"variant": hit["variant"], "source": "cache",
                    "key": key, "trials": 0}
        _log.warning("autotune cache: refusing %s winner %r — %s; "
                     "re-searching", op, hit["variant"], ver["reason"])
    if budget < 1:
        return {"variant": variants.effective(op), "source": "skipped",
                "key": key, "trials": 0, "trace": [], "budget": budget}
    prev = variants.selected(op)
    #: each timed point's reading in the last round that timed it
    timings: Dict[str, float] = {}
    trace: List[Dict[str, Any]] = []
    rounds: List[Dict[str, float]] = []
    tried: set = set()
    state: Dict[str, Any] = {"trials": 0, "leader": None}
    sbudget = res.smem_budget(dev, override=smem_budget)
    pruned: set = set()
    aliases: Dict[str, str] = {}

    def _timeable(name: str) -> None:
        """Refuse to time a candidate with no passing ledger record, or
        whose kernel does not fit, whatever the caller checked."""
        if not templates.passed(op, name):
            raise templates.UngatedCandidateError(
                f"{op}/{name}: refusing to time a candidate with no "
                "passing ops.reference equivalence record")
        ver = res.kernel_verdict(op, name, shapes=smem_shapes,
                                 dtype=compute_dtype, device=dev,
                                 budget=sbudget)
        if ver is not None:
            raise res.InfeasibleCandidateError(
                f"{op}/{name}: refusing to time a candidate whose kernel "
                f"needs {ver['footprint']} B of shared memory a block "
                f"against {ver['smem_budget']} B ({ver['reason']})")

    def _time(names: List[str]) -> Dict[str, Any]:
        for name in names:
            _timeable(name)
        if in_graph_timer is not None:
            return in_graph_timer(names)
        out: Dict[str, Any] = {}
        for name in names:
            TIMINGS["microbench"] += 1
            try:
                out[name] = templates.bench_candidate(op, name, repeats, dev)
            except templates.UngatedCandidateError:
                raise
            except Exception as e:  # noqa: BLE001 — reported, below
                out[name] = f"error: {e!s:.200}"
        return out

    def round_(fresh: List[str], keep: tuple = ()) -> Dict[str, float]:
        """Gate each fresh name (one trial each, an equivalence failure
        too, while budget is left), then time the passing ones beside
        the leader and the timed names of `keep`, in turns; the round's
        fastest leads. Returns the round's readings (none where no fresh
        point passed: nothing is timed then)."""
        admitted: List[Dict[str, Any]] = []
        for name in fresh:
            if name in tried or state["trials"] >= budget:
                continue
            tried.add(name)
            state["trials"] += 1
            rec: Dict[str, Any] = {"variant": name}
            try:
                eq = templates.check_equivalence(op, name, device=dev)
                if eq["status"] == "pass":
                    admitted.append(rec)
                    continue
                rec.update(outcome="equiv_fail", error=eq.get("error", ""))
            except Exception as e:  # noqa: BLE001 — a contract that
                # cannot run is reported, never timed
                rec.update(outcome="error", error=f"{e!s:.200}")
                _log.warning("autotune: %s/%s failed: %s", op, name, e)
            trace.append(rec)
        if not admitted:
            return {}
        group = [n for n in (state["leader"], *keep) if n in timings]
        group = list(dict.fromkeys(group + [r["variant"]
                                            for r in admitted]))
        readings = _time(group)
        for rec in admitted:
            got = readings.get(rec["variant"], "error: not timed")
            if isinstance(got, float):
                rec.update(outcome="timed", time_s=round(got, 7))
            else:
                # a point that fails to launch is reported, never timed
                # under another's name
                rec.update(outcome="error", error=got)
                _log.warning("autotune: %s/%s failed: %s", op,
                             rec["variant"], got)
            trace.append(rec)
        ok = {n: t for n, t in readings.items() if isinstance(t, float)}
        timings.update(ok)
        if ok:
            rounds.append({n: round(t, 7) for n, t in ok.items()})
            state["leader"] = min(ok, key=ok.get)
        return ok

    round_([v.name for v in variants.variants_for(op)
            if v.tunable and not v.generated])

    seen_bench: Dict[Any, str] = {}

    def gen_name(t, cfg) -> Optional[str]:
        """The point's name, or None where it is pruned or an alias (its
        trace entry written once)."""
        name = t.name(cfg)
        if name in pruned or name in aliases:
            return None
        ver = _prune_verdict(op, t, cfg, smem_shapes, compute_dtype, dev,
                             sbudget)
        if ver is not None:
            pruned.add(name)
            trace.append({"variant": name, "outcome": "pruned", **ver})
            _log.info("pruned %s/%s: %s (%d B against %s B), never timed",
                      op, name, ver["reason"], ver["footprint"],
                      ver["smem_budget"])
            return None
        if t.bench_key is not None:
            bk = t.bench_key(cfg, dict(smem_shapes or {}), compute_dtype)
            first = seen_bench.setdefault(bk, name)
            if first != name:
                aliases[name] = first
                trace.append({"variant": name, "outcome": "alias",
                              "of": first})
                return None
        return name

    for t in templates.templates_for(op):
        cur = dict(t.seed)
        seed = gen_name(t, cur)
        if seed is not None:
            round_([seed])
        improved = True
        while improved and state["trials"] < budget:
            improved = False
            for axis in t.axes:
                if state["trials"] >= budget:
                    break
                alts: Dict[str, Any] = {}
                for c in axis.choices:
                    if c != cur[axis.name]:
                        name = gen_name(t, {**cur, axis.name: c})
                        if name is not None and name not in tried:
                            alts[name] = c
                here = t.name(cur)
                ok = round_(list(alts)[:ROUND_POINTS], keep=(here,))
                ok = {n: ok[n] for n in (here, *alts) if n in ok}
                if ok and min(ok, key=ok.get) != here:
                    cur[axis.name] = alts[min(ok, key=ok.get)]
                    improved = True
        pending: List[str] = []
        for cfg in t.configs():
            if state["trials"] + len(pending) >= budget:
                break
            name = gen_name(t, cfg)
            if name is not None and name not in tried:
                pending.append(name)
            if len(pending) == ROUND_POINTS:
                round_(pending)
                pending = []
        round_(pending)

    outcomes = {o: sum(1 for r in trace if r["outcome"] == o)
                for o in ("timed", "equiv_fail", "error", "pruned",
                          "alias")}
    if not timings:
        if prev is None:
            variants.clear_selection(op)
        else:
            variants.select(op, prev)
        return {"variant": variants.effective(op), "source": "error",
                "trace": trace, "key": key, "trials": state["trials"],
                "outcomes": outcomes}
    winner = state["leader"]
    variants.select(op, winner)
    parsed = templates.parse_point(op, winner)
    record = {
        "variant": winner, "config": parsed[1] if parsed else None,
        "timings_s": {k: round(v, 7) for k, v in timings.items()},
        "rounds": rounds, "trace": trace, "outcomes": outcomes,
        "equivalence": {r["variant"]: ("fail" if r["outcome"] ==
                                       "equiv_fail" else "pass")
                        for r in trace
                        if r["outcome"] in ("timed", "equiv_fail")},
        "pruned": sorted(pruned), "aliases": dict(sorted(aliases.items())),
        "budget": budget, "trials": state["trials"],
        "timer": "in_graph" if in_graph_timer is not None
        else "microbench",
        "device_kind": kind, "repeats": repeats, "tuned_at": time.time(),
    }
    cache.put(key, record)
    return {**record, "source": "searched", "key": key}


def search_workflow(wf=None, *, ops: Optional[List[str]] = None,
                    budget: int = 32,
                    cache: Optional[AutotuneCache] = None,
                    cache_path: Optional[str] = None,
                    compute_dtype: Any = None,
                    profile_path: Optional[str] = None,
                    steps: int = 4, repeats: int = 3,
                    batch: Optional[int] = None, force: bool = False,
                    smem_budget: Optional[int] = None,
                    device=None) -> Dict[str, Dict[str, Any]]:
    """The budgeted search over every template op in `ops` (None: all;
    an empty list: none): the workflow's ops timed in its fused step, the
    others by their microbench; member ops before the fusion op that
    claims them; the budget split by `allocate_budget` with
    `incumbent_floor` floors."""
    dev = _device(device)
    cache = cache or AutotuneCache(cache_path)
    all_ops = templates.template_ops() if ops is None else list(ops)
    all_ops = [op for op in all_ops
               if templates.templates_for(op) and op in templates.CONTRACTS]
    wf_sigs: Dict[str, List[Dict]] = {}
    if wf is not None:
        wf_sigs = discover_tunables(wf)
        wf_sigs.update(discover_fusions(wf))
    ordered = priority_order(all_ops, profile_path)
    ordered.sort(key=lambda kv: bool(templates.fusion_members(kv[0])))
    shares = allocate_budget(
        ordered, budget,
        floors={op: incumbent_floor(op) for op, _ in ordered})
    report: Dict[str, Dict[str, Any]] = {}
    for op, share in ordered:
        timer = None
        if wf is not None and op in wf_sigs:
            timer = functools.partial(
                _time_in_turns, wf, op, compute_dtype=compute_dtype,
                steps=steps, repeats=repeats, batch=batch, device=dev)
        with _suspend_fusions(op):
            report[op] = search_op(
                op, budget=shares[op], cache=cache,
                compute_dtype=compute_dtype, force=force, repeats=repeats,
                workflow_sigs=wf_sigs.get(op), in_graph_timer=timer,
                smem_shapes=res.shapes_from_signatures(op, wf_sigs.get(op)),
                smem_budget=smem_budget, device=dev)
        report[op]["priority_share"] = share
    return report


def report_lines(report: Dict[str, Dict[str, Any]]) -> List[str]:
    """One `AUTOTUNE op: winner (source) ...` line per op of a report:
    the trials against the op's budget, the outcomes, the pruned and
    alias points, and the timings in ms a step (in the fused step) or a
    call (microbench)."""
    lines = []
    for op, rec in sorted(report.items()):
        line = f"AUTOTUNE {op}: {rec['variant']} ({rec['source']})"
        if rec.get("trials"):
            line += (f" trials={rec['trials']}/{rec.get('budget', '?')}"
                     f" share={rec.get('priority_share', 0):.2f}")
        if rec.get("outcomes"):
            line += " " + " ".join(f"{k}={v}" for k, v in
                                   rec["outcomes"].items() if v)
        if rec.get("pruned"):
            line += f" pruned={','.join(rec['pruned'])}"
        if rec.get("aliases"):
            line += " aliases=" + ",".join(
                f"{a}->{b}" for a, b in rec["aliases"].items())
        for k, v in sorted((rec.get("timings_s") or {}).items()):
            line += f" {k}=" + (v if isinstance(v, str)
                                else f"{v * 1e3:.4f}ms")
        lines.append(line)
    return lines
