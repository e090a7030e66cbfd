"""The weight-update rules (parity: reference `GradientDescentBase` in
`veles/znicz/nn_units.py`: learning rate, momentum (`gradient_moment`),
L1/L2 weight decay, the bias learning-rate multiplier), and Adam.

The port's copy of `veles_tpu/ops/optim.py` on tensors, one device (the
ZeRO slices of the many-GPU slice are not here). SGD:
v ← μ·v − lr·(g + λ2·w + λ1·sign(w)); w ← w + v, each leaf with its own
lr (`sgd_leaf_lr`). It is NOT `torch.optim.SGD`, whose rule
(v ← μ·v + g, w ← w − lr·v) drifts from this one once the lr changes and
keeps velocities in other units. Adam is the JAX rule (:102-148 there),
not `torch.optim.Adam`: L2 `weight_decay` is added to the gradient (not
AdamW), no bias lr multiplier, no L1, `lr = cfg.lr * lr_scale`, and the
step is `lr * (m / b1t) / (sqrt(v / b2t) + eps)` in that order, with the
bias corrections `1 - b ** t` computed in f32 on the device from the
state's int32 `t` (never read back to the host). Where the JAX package
returns new arrays, the port updates the tensors in place.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from veles_tpu_torch.ops import functional


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


class AdamConfig(NamedTuple):
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def adam_init(params: Dict[str, torch.Tensor],
              device: torch.device) -> Dict[str, Any]:
    """One layer's Adam state: zero moments like its leaves, and the
    step counter `t`, a 0-d int32 tensor on `device` (a layer without
    parameters keeps empty moment dicts)."""
    def zeros():
        return {k: torch.zeros_like(t, requires_grad=False)
                for k, t in params.items()}
    return {"m": zeros(), "v": zeros(),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def is_adam_state(layer) -> bool:
    """Whether one layer's optimizer state is Adam's (`adam_init`'s
    {"m", "v", "t"}) rather than SGD velocities."""
    return isinstance(layer, dict) and set(layer) == {"m", "v", "t"}


def adam_step_factors(cfg: AdamConfig, t: torch.Tensor):
    """Bias-correction denominators for step `t` (already incremented):
    `1 - b ** t` in f32, as the JAX function takes `t.astype(float32)`
    under a weakly typed Python base."""
    tf = t.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=t.device), tf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=t.device), tf)
    return b1t, b2t


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, cfg: AdamConfig, b1t: torch.Tensor,
              b2t: torch.Tensor, lr: float):
    """(new p, new m, new v) of one leaf; `lr` is the schedule-scaled
    cfg.lr, `b1t` / `b2t` come from adam_step_factors."""
    if cfg.weight_decay:
        g = g + cfg.weight_decay * p
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
    step = lr * (m_new / b1t) / (functional.sqrt(v_new / b2t) + cfg.eps)
    return p - step, m_new, v_new


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                cfg: AdamConfig, lr_scale: float = 1.0) -> None:
    """Apply `adam_leaf` to every leaf of one layer and advance the
    layer's `t`, all in place and on the device."""
    state["t"].add_(1)
    b1t, b2t = adam_step_factors(cfg, state["t"])
    lr = cfg.lr * lr_scale
    for key, p in params.items():
        new_p, new_m, new_v = adam_leaf(p, grads[key], state["m"][key],
                                        state["v"][key], cfg, b1t, b2t, lr)
        state["m"][key].copy_(new_m)
        state["v"][key].copy_(new_v)
        p.copy_(new_p)
