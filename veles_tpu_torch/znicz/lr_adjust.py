"""Learning-rate scheduling unit.

The port's copy of `veles_tpu/znicz/lr_adjust.py` (:20-122 there; parity:
reference `veles/znicz/lr_adjust.py`): the Caffe-era policy set (fixed /
step / multistep / exp / inv / poly) applied over training iterations to
the `lr_scale` of the gradient units it is linked to (`link_gds`). Wired
into the granular loop after the gradient chain, one firing per train
minibatch is one iteration; each gradient unit hands its `lr_scale` to
the update at its next firing (the K1 launch's learning rate on the
card), so a schedule change rebuilds nothing.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from veles_tpu_torch.units import Unit


def step_policy(base: float, gamma: float, step: int):
    """lr(it) = base · gamma^floor(it/step)."""
    return lambda it: base * (gamma ** (it // step))


def exp_policy(base: float, gamma: float):
    """lr(it) = base · gamma^it."""
    return lambda it: base * (gamma ** it)


def inv_policy(base: float, gamma: float, power: float):
    """lr(it) = base / (1 + gamma·it)^power (the Caffe-era 'inv')."""
    return lambda it: base / ((1.0 + gamma * it) ** power)


def fixed_policy(base: float):
    """lr(it) = base."""
    return lambda it: base


def poly_policy(base: float, power: float, max_iter: int):
    """lr(it) = base · (1 − it/max_iter)^power, clamped at 0."""
    if max_iter <= 0:
        raise ValueError(f"poly policy needs max_iter > 0, got {max_iter}")
    return lambda it: base * max(1.0 - it / max_iter, 0.0) ** power


def multistep_policy(base: float, gamma: float, steps):
    """lr(it) = base · gamma^(#{s in steps : it ≥ s})."""
    steps = sorted(steps)
    return lambda it: base * (gamma ** sum(1 for s in steps if it >= s))


#: one source of truth: name -> builder over the full cfg tuple
_BUILDERS = {
    "step": lambda b, g, s, p, m, ms: step_policy(b, g, s),
    "exp": lambda b, g, s, p, m, ms: exp_policy(b, g),
    "inv": lambda b, g, s, p, m, ms: inv_policy(b, g, p),
    "fixed": lambda b, g, s, p, m, ms: fixed_policy(b),
    "poly": lambda b, g, s, p, m, ms: poly_policy(b, p, m),
    "multistep": lambda b, g, s, p, m, ms: multistep_policy(b, g, ms),
}
_POLICIES = tuple(sorted(_BUILDERS))


def _build_policy(policy, base, gamma, step, power, max_iter, steps):
    try:
        builder = _BUILDERS[policy]
    except KeyError:
        raise ValueError(f"unknown lr policy {policy!r}") from None
    return builder(base, gamma, step, power, max_iter, steps)


class LearningRateAdjust(Unit):
    """Applies a policy to every linked GD unit's `lr_scale` each firing
    (wire it after the gradient chain; one firing per training
    minibatch = one 'iteration' like the reference)."""

    def __init__(self, workflow=None, policy: str = "exp",
                 base: float = 1.0, gamma: float = 0.999,
                 step: int = 100, power: float = 0.75,
                 max_iter: int = 10000,
                 steps: Optional[Iterable[int]] = None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown lr policy {policy!r}; one of {sorted(_POLICIES)}")
        self.policy_name = policy
        # an explicit empty list means "no decay steps", not the default
        steps = tuple(steps) if steps is not None else (1000, 5000)
        self._cfg = (policy, base, gamma, step, power, max_iter, steps)
        self._policy = _build_policy(*self._cfg)
        self.iteration = 0
        self.gd_units: list = []

    def link_gds(self, gds: Iterable[Unit]) -> "LearningRateAdjust":
        self.gd_units = list(gds)
        return self

    @property
    def current_scale(self) -> float:
        return float(self._policy(self.iteration))

    def run(self) -> None:
        scale = self.current_scale
        for g in self.gd_units:
            g.lr_scale = scale
        self.iteration += 1

    # policy closures don't pickle; rebuild from the stored config
    def __getstate__(self):
        d = super().__getstate__()
        d.pop("_policy", None)
        return d

    def __setstate__(self, state):
        super().__setstate__(state)
        self._policy = _build_policy(*self._cfg)
