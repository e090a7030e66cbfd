"""The fused forward of a StandardWorkflow: the whole forward chain as one
call, with the cross-op fusion of adjacent (LRN, max pooling) pairs.

The port's counterpart of the forward half of `FusedTrainStep` in
`veles_tpu/parallel/fused.py` (`_forward` with train=False in f32 on one
device, `_pair_fusion`, `fusion_pairs`, `_apply_fused_pair`,
`variant_table`). The JAX package resolves lowerings when it traces;
PyTorch runs eagerly, so `FusedForward` resolves them once, when it is
built, into a fixed plan — a server keeps serving what it was built with
whatever the registry selects later. The rule that a claimed pool is a
pass-through is the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from veles_tpu_torch.backends import full_f32
from veles_tpu_torch.ops import variants


class FusedForward:
    """Forward chain of `workflow` on its device, lowerings fixed at
    build time."""

    def __init__(self, workflow) -> None:
        if not workflow.is_initialized:
            raise RuntimeError("initialize the workflow before building "
                               "its fused forward")
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self.device: torch.device = workflow.device
        self.pairs = self.fusion_pairs()
        claimed = {j: i for i, j, _ in self.pairs}
        fused = {i: (j, v) for i, j, v in self.pairs}
        #: per unit: ("pair", j, variant) | ("skip", i, None) |
        #: ("unit", None, variant-or-None)
        self._plan: List[Tuple[str, Optional[int], Optional[object]]] = []
        for i, u in enumerate(self.forwards):
            if i in claimed:
                self._plan.append(("skip", claimed[i], None))
            elif i in fused:
                self._plan.append(("pair",) + fused[i])
            elif variants.has_op(getattr(u, "variant_op", None) or ""):
                self._plan.append(("unit", None, variants.resolve(
                    u.variant_op, unit=u, device=self.device)))
            else:
                self._plan.append(("unit", None, None))

    # -- cross-op fusion ------------------------------------------------------

    def _pair_fusion(self, u, nxt):
        """The FUSED variant claiming the adjacent (u, nxt) pair, or None
        (a composed selection, or a per-layer override on either
        side)."""
        if nxt is None:
            return None
        if getattr(u, "variant_override", None) is not None \
                or getattr(nxt, "variant_override", None) is not None:
            return None
        if getattr(u, "variant_op", None) == "lrn" \
                and getattr(nxt, "variant_op", None) == "maxpool":
            v = variants.resolve("lrn_maxpool", device=self.device)
            return v if v.fused else None
        return None

    def fusion_pairs(self):
        """[(i, i+1, Variant), ...] adjacent unit pairs the CURRENT
        registry selections claim, left to right (a unit joins at most one
        pair). Resolved fresh per call."""
        out = []
        claimed: set = set()
        fwds = self.forwards
        for i, u in enumerate(fwds[:-1]):
            if i in claimed or (i + 1) in claimed:
                continue
            v = self._pair_fusion(u, fwds[i + 1])
            if v is not None:
                out.append((i, i + 1, v))
                claimed.update((i, i + 1))
        return out

    @staticmethod
    def _apply_fused_pair(v, u, nxt, x):
        """Run one claimed (LRN, max pooling) pair through the fused
        variant; the pooling unit is a pass-through."""
        return v.apply(x, k=u.k, alpha=u.alpha, beta=u.beta, n=u.n,
                       ksize=tuple(nxt.ksize), stride=tuple(nxt.stride))

    # -- forward --------------------------------------------------------------

    def params(self) -> Tuple[Dict[str, torch.Tensor], ...]:
        """The units' parameters, one `{name: tensor}` per forward unit."""
        return tuple(u.param_arrays() for u in self.forwards)

    @torch.inference_mode()
    def _forward(self, params, x: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
        """Forward `x` (NHWC, on this forward's device) through the plan,
        in full f32 (no TF32) on the card; returns the last unit's output
        (logits for a softmax head)."""
        if train:
            raise NotImplementedError("the training forward comes with the "
                                      "training slice")
        with full_f32(self.device):
            for i, (kind, j, v) in enumerate(self._plan):
                u = self.forwards[i]
                if kind == "skip":
                    continue
                if kind == "pair":
                    x = self._apply_fused_pair(v, u, self.forwards[j], x)
                elif v is not None:
                    x = u.fused_apply(params[i], x, train=False, variant=v)
                else:
                    x = u.fused_apply(params[i], x, train=False)
        return x

    def variant_table(self) -> Dict[str, str]:
        """{op: variant-name} this forward runs. A claimed pair reports the
        fused variant for `lrn_maxpool`, and `lrn_maxpool/<name>` for the
        `lrn` op unless an unclaimed LRN unit runs its own lowering."""
        table: Dict[str, str] = {}
        for u, (kind, _, v) in zip(self.forwards, self._plan):
            if kind == "unit" and v is not None:
                table[u.variant_op] = v.name
        for _, _, v in self.pairs:
            table["lrn_maxpool"] = v.name
            table.setdefault("lrn", f"lrn_maxpool/{v.name}")
        return table
