"""Carry the JAX package's parameters into the port.

`params_from_jax(params, device, workflow=None)` takes parameters in the
format the JAX package's server builds — a tuple with one
`{name: np.ndarray}` per forward unit (veles_tpu/serving.py:539-541) —
and returns the port's: the same tuple of dicts, as float32 tensors on
`device`. The layouts are the same in both packages (conv weights HWIO,
FC weights (fan_in, units)), so the conversion is the identity on the
values and only checks them. Given a built workflow, it checks every
unit's names and shapes against the workflow's and loads the values into
it; any mismatch raises.

`state_from_jax(state, device, step=None)` carries a JAX fused-step state
(`FusedTrainStep.init_state()` there: `params`, `vel`, `lr_scale`, and a
PRNG key the port has no use for) across as the port step's state, with
the same checks against `step`'s units; `state_to_numpy(state)` turns
the port's state into host arrays for comparisons.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch.backends import DeviceLike, make_device


def params_from_jax(params: Sequence[Dict[str, np.ndarray]],
                    device: DeviceLike = None,
                    workflow=None) -> Tuple[Dict[str, torch.Tensor], ...]:
    dev = make_device(device)
    params = tuple(params)
    out = []
    for i, layer in enumerate(params):
        if not isinstance(layer, dict):
            raise TypeError(f"unit {i}: expected a {{name: array}} dict, "
                            f"got {type(layer).__name__}")
        conv = {}
        for name, a in layer.items():
            arr = np.asarray(a)
            if not np.issubdtype(arr.dtype, np.floating):
                raise TypeError(f"unit {i} {name!r}: {arr.dtype} is not a "
                                f"float parameter")
            # a copy: the JAX package's host arrays are read-only, and the
            # port's step updates its tensors in place
            conv[name] = torch.tensor(np.asarray(arr, np.float32),
                                      device=dev)
        out.append(conv)
    out = tuple(out)
    if workflow is not None:
        _load_into(workflow, out)
    return out


def state_from_jax(state: Dict[str, Any], device: DeviceLike = None,
                   step=None) -> Dict[str, Any]:
    """The port step's state from a JAX fused state: `params` as trainable
    leaves and `vel` as tensors on `device`, `lr_scale` as a float.
    Given `step`, the names and shapes of both must be its units'."""
    params = params_from_jax(state["params"], device)
    vel = params_from_jax(state["vel"], device)
    for name, layers in (("params", params), ("vel", vel)):
        try:
            if step is not None:
                _check_against(step.forwards, layers)
        except ValueError as e:
            raise ValueError(f"state[{name!r}]: {e}") from None
    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    return {"params": params, "vel": vel,
            "lr_scale": float(np.asarray(state["lr_scale"]))}


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """`params` and `vel` as tuples of {name: ndarray}, `lr_scale` as a
    float."""
    def host(layers):
        return tuple({k: t.detach().cpu().numpy() for k, t in layer.items()}
                     for layer in layers)
    return {"params": host(state["params"]), "vel": host(state["vel"]),
            "lr_scale": float(state["lr_scale"])}


def _check_against(units, params: Tuple[Dict[str, torch.Tensor], ...]):
    """Raise unless `params` has the names and shapes of `units`'s."""
    units = list(units)
    if len(params) != len(units):
        raise ValueError(f"{len(params)} parameter sets for "
                         f"{len(units)} forward units")
    for i, (u, layer) in enumerate(zip(units, params)):
        have = u.param_arrays()
        if set(have) != set(layer):
            raise ValueError(
                f"unit {i} ({type(u).__name__}): parameter names "
                f"{sorted(layer)} != {sorted(have)}")
        for name, t in have.items():
            if tuple(layer[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"unit {i} ({type(u).__name__}) {name!r}: shape "
                    f"{tuple(layer[name].shape)} != {tuple(t.shape)}")


def _load_into(workflow, params: Tuple[Dict[str, torch.Tensor], ...]):
    units = list(workflow.forwards)
    _check_against(units, params)
    with torch.no_grad():
        for u, layer in zip(units, params):
            for name, t in u.param_arrays().items():
                t.copy_(layer[name])
