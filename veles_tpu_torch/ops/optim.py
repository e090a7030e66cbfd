"""The SGD weight-update rule (parity: reference `GradientDescentBase` in
`veles/znicz/nn_units.py`: learning rate, momentum (`gradient_moment`),
L1/L2 weight decay, the bias learning-rate multiplier).

The port's copy of the SGD half of `veles_tpu/ops/optim.py` on tensors:
v ← μ·v − lr·(g + λ2·w + λ1·sign(w)); w ← w + v, each leaf with its own
lr (`sgd_leaf_lr`). It is NOT `torch.optim.SGD`, whose rule
(v ← μ·v + g, w ← w − lr·v) drifts from this one once the lr changes and
keeps velocities in other units. Where the JAX package returns new
arrays, the port updates the tensors in place. Adam comes with a later
slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class SGDConfig(NamedTuple):
    lr: float = 0.01
    momentum: float = 0.0          # reference: gradient_moment
    weight_decay: float = 0.0      # L2 (reference: weights_decay)
    l1_decay: float = 0.0          # L1 (reference: l1_vs_l2 blend split out)
    lr_bias_mult: float = 2.0      # reference: bias lr multiplier convention


def sgd_leaf_lr(cfg: SGDConfig, ndim: int, lr_scale: float = 1.0) -> float:
    """Effective lr of ONE leaf: the schedule scale, and the bias
    convention — 1-D leaves get the bias multiplier."""
    lr = cfg.lr * lr_scale
    if ndim == 1 and cfg.lr_bias_mult != 1.0:
        lr = lr * cfg.lr_bias_mult
    return lr


def sgd_leaf(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
             cfg: SGDConfig, lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new p, new v) of one leaf; `lr` is already fully resolved."""
    reg = g
    if cfg.weight_decay:
        reg = reg + cfg.weight_decay * p
    if cfg.l1_decay:
        reg = reg + cfg.l1_decay * torch.sign(p)
    v_new = cfg.momentum * v - lr * reg
    return p + v_new, v_new


@torch.no_grad()
def sgd_update(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               velocity: Dict[str, torch.Tensor], cfg: SGDConfig,
               lr_scale: float = 1.0) -> None:
    """Apply `sgd_leaf` to every leaf of one layer, in place."""
    for key, p in params.items():
        new_p, new_v = sgd_leaf(p, grads[key], velocity[key], cfg,
                                sgd_leaf_lr(cfg, p.ndim, lr_scale))
        velocity[key].copy_(new_v)
        p.copy_(new_p)
