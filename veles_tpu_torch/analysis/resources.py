"""The kernel ledger: whether a generated point's kernel fits the card's
shared memory, before anything times it.

The port's counterpart of ledger 1 of `veles_tpu/analysis/resources.py`
(:85-283 there), with the card's shared memory where the TPU has VMEM:
every kernel template of ops/templates.py carries `smem_footprint(config,
shapes, dtype)`, the dynamic shared memory a block of the point's kernel
takes at the op's shapes, from the Python mirrors of the sources' plans
in ops/kernels.py. A point is infeasible when that footprint is above the
budget, or when the kernel's own plan refuses the point (the mirror's
-1: K4 at a band that cannot fit 48 KB, K2 at a tile that is no multiple
of 4): the budgeted search skips it without timing it or spending budget
(trial outcome `pruned`), the search's timed trial refuses one
independently (`InfeasibleCandidateError`, the twin of
`templates.UngatedCandidateError`), and `apply_cached` refuses a cached
winner that no longer fits.

The budget is read from the card (torch's `shared_memory_per_block_optin`,
227 KB on an H100); `VELES_SMEM_BUDGET` overrides it (what-if runs,
tests). On the CPU there is none unless overridden, as in the JAX
package, and only a plan's refusal prunes. The workflow memory ledger
(:285-617 there) waits for the many-GPU slice.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

from veles_tpu_torch.analysis.findings import SEV_ERROR, Finding

__all__ = ["SMEM_BUDGET_ENV", "InfeasibleCandidateError", "smem_budget",
           "kernel_footprint", "kernel_verdict", "shapes_from_signatures",
           "kernel_findings"]

_log = logging.getLogger("veles_torch.resources")

#: env override of the card's shared-memory budget (bytes a block)
SMEM_BUDGET_ENV = "VELES_SMEM_BUDGET"


class InfeasibleCandidateError(RuntimeError):
    """Raised when something tries to TIME a generated point whose
    kernel's shared memory exceeds the budget or whose plan the kernel
    refuses."""


def smem_budget(device=None, override: Optional[int] = None
                ) -> Optional[int]:
    """Bytes of dynamic shared memory a block may take on `device`:
    `override`, then $VELES_SMEM_BUDGET, then the card's opt-in maximum;
    None on the CPU (no budget: only a plan's refusal prunes)."""
    if override is not None:
        return int(override)
    env = os.environ.get(SMEM_BUDGET_ENV)
    if env:
        try:
            return int(env)
        except ValueError:
            _log.warning("%s=%r is not an integer byte count; ignoring",
                         SMEM_BUDGET_ENV, env)
    if device is None:
        return None
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev)
               .shared_memory_per_block_optin)


def kernel_footprint(op: str, name: Any,
                     shapes: Optional[Dict[str, Any]] = None,
                     dtype: Any = None) -> Optional[int]:
    """The dynamic shared memory (bytes) of a block of the named
    generated point at `shapes` (missing keys: the bench shapes), -1
    where the kernel's plan refuses it; None for a hand-written or
    foreign name, or a template without a rule (never pruned)."""
    from veles_tpu_torch.ops import templates
    parsed = templates.parse_point(op, name)
    if parsed is None or parsed[0].smem_footprint is None:
        return None
    t, cfg = parsed
    return int(t.smem_footprint(cfg, dict(shapes or {}), dtype))


def kernel_verdict(op: str, name: Any,
                   shapes: Optional[Dict[str, Any]] = None,
                   dtype: Any = None, device=None,
                   budget: Optional[int] = None
                   ) -> Optional[Dict[str, Any]]:
    """None when the point fits (or nothing is known of it); else
    {"footprint", "smem_budget", "reason"}: the one rule the search's
    pruning, its timed trial and `apply_cached` share."""
    f = kernel_footprint(op, name, shapes=shapes, dtype=dtype)
    if f is None:
        return None
    b = smem_budget(device, override=budget)
    if f < 0:
        return {"footprint": f, "smem_budget": b,
                "reason": "the kernel's plan refuses the point"}
    if b is not None and f > b:
        return {"footprint": f, "smem_budget": b,
                "reason": "above the shared-memory budget"}
    return None


def shapes_from_signatures(op: str, sigs) -> Dict[str, Any]:
    """The footprint rules' `shapes` for a workflow op from its autotune
    signatures (ops/autotune.py `discover_tunables` / `discover_fusions`):
    every instance, since one registry selection covers them all."""
    out: Dict[str, Any] = {}
    for sig in sigs or ():
        if not isinstance(sig, dict):
            continue
        if op == "lrn_maxpool":
            pool = (sig.get("maxpool") or {}).get("params") or {}
            lrn = sig.get("lrn") or {}
            ss = lrn.get("sample_shape")
            if ss and len(ss) == 3:
                out.setdefault("inputs", []).append(
                    [int(v) for v in ss])
            if pool.get("ksize"):
                out["ksize"] = [int(v) for v in pool["ksize"]]
                out["stride"] = [int(v) for v in pool["stride"]]
            continue
        ss = sig.get("sample_shape")
        if op == "lrn" and ss:
            out.setdefault("c", [])
            if int(ss[-1]) not in out["c"]:
                out["c"].append(int(ss[-1]))
        elif op == "flash_attn" and ss:
            out["s"] = max(out.get("s", 0), int(ss[0]))
            if sig.get("head_dim"):
                out["d"] = max(out.get("d", 0), int(sig["head_dim"]))
    return out


def kernel_findings(sigs: Optional[Dict[str, List[Dict]]] = None,
                    device=None, budget: Optional[int] = None,
                    dtype: Any = None) -> List[Finding]:
    """`smem-over-budget` findings for every template op whose current
    selection is a generated point that the card cannot launch at the
    workflow's shapes (`sigs`: {op: signatures}); clean when every
    selection fits."""
    from veles_tpu_torch.ops import templates, variants
    out: List[Finding] = []
    for op in templates.template_ops():
        name = variants.effective(op)
        shapes = shapes_from_signatures(op, (sigs or {}).get(op))
        ver = kernel_verdict(op, name, shapes=shapes, dtype=dtype,
                             device=device, budget=budget)
        if ver is None:
            continue
        out.append(Finding(
            "smem-over-budget", SEV_ERROR, f"{op}/{name}",
            f"selected generated point needs {ver['footprint']} B of "
            f"shared memory a block at {shapes or 'the bench shapes'} "
            f"against a budget of {ver['smem_budget']} B "
            f"({ver['reason']}): its launch would fail on the card; "
            f"re-run the search (it prunes this point) or pick another",
            f"footprint {ver['footprint']}/{ver['smem_budget']} B"))
    return out
