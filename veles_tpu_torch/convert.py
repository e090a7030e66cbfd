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
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

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
            conv[name] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32)).to(dev)
        out.append(conv)
    out = tuple(out)
    if workflow is not None:
        _load_into(workflow, out)
    return out


def _load_into(workflow, params: Tuple[Dict[str, torch.Tensor], ...]):
    units = list(workflow.forwards)
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
    with torch.no_grad():
        for u, layer in zip(units, params):
            for name, t in u.param_arrays().items():
                t.copy_(layer[name])
