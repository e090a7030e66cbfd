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
the same checks against `step`'s units; an Adam layer's `vel` is
`{"m": {...}, "v": {...}, "t": int32}` in both packages, and given
`step`, a layer is Adam exactly where the step's config is.
`state_to_numpy(state)` turns the port's state into host arrays for
comparisons.

Every leaf travels by its name, so a MoE layer's `wr`, `w1`, `b1`, `w2`,
`b2` and their velocities (`vel_wr`, ... in both packages) cross like any
other layer's.

`granular_from_jax(jax_workflow, workflow)` carries a JAX granular
workflow's units into the port's initialized workflow of the same layer
list: each forward unit's parameter `Array`s (`weights`, `bias`, ...)
into the layer's tensors, each gradient unit's velocities and
`lr_scale` — a JAX VJP twin (the attention and sequence layers' `jax.vjp`
units) keeps `vel_<leaf>` for every leaf, `vel_weights` and `vel_bias`
included, where the port's units keep one naming, `vel_w` / `vel_b` /
`vel_<leaf>` (`_jax_velocity`, after veles_tpu/parallel/fused.py
`_vel_attr`) — the evaluator's last metrics, the Decision's counters and
the loader's schedule, cursor and shuffled indices, so the port's graph
continues the JAX run (the shuffle stream itself is the PRNG
registry's). It
reads the JAX units' host views (`.mem`), never JAX itself.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch.backends import DeviceLike, make_device
from veles_tpu_torch.ops import optim


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
    leaves, `vel` as tensors on `device` (an Adam layer's moments, and
    its `t` as a 0-d int32 tensor), `lr_scale` as a float. Given `step`,
    the names and shapes of every leaf and moment must be its units', and
    each layer's update rule its config's."""
    dev = make_device(device)
    params = params_from_jax(state["params"], dev)
    vel = tuple(_vel_from_jax(i, layer, dev)
                for i, layer in enumerate(state["vel"]))
    if step is not None:
        checks = [("params", params)] + [
            ("vel", tuple(v[slot] if optim.is_adam_state(v) else v
                          for v in vel))
            for slot in ("m", "v")]
        for name, layers in checks:
            try:
                _check_against(step.forwards, layers)
            except ValueError as e:
                raise ValueError(f"state[{name!r}]: {e}") from None
        for i, (layer, cfg) in enumerate(zip(vel, step.cfgs)):
            rule = "Adam" if isinstance(cfg, optim.AdamConfig) else "SGD"
            if ("Adam" if optim.is_adam_state(layer) else "SGD") != rule:
                raise ValueError(f"state['vel'] unit {i}: the step updates "
                                 f"this layer with {rule}")
    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    return {"params": params, "vel": vel,
            "lr_scale": float(np.asarray(state["lr_scale"]))}


def _vel_from_jax(i: int, layer, dev: torch.device):
    """One layer's SGD velocities or Adam state as tensors on `dev`."""
    if not optim.is_adam_state(layer):
        return params_from_jax((layer,), dev)[0]
    m, v = params_from_jax((layer["m"], layer["v"]), dev)
    t = np.asarray(layer["t"])
    if t.shape != () or not np.issubdtype(t.dtype, np.integer):
        raise ValueError(f"state['vel'] unit {i}: Adam's t must be an "
                         f"integer scalar, not {t.dtype}{t.shape}")
    return {"m": m, "v": v,
            "t": torch.tensor(int(t), dtype=torch.int32, device=dev)}


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """`params` and `vel` as tuples of {name: ndarray} (an Adam layer's
    `vel` as {"m": {...}, "v": {...}, "t": np.int32}), `lr_scale` as a
    float."""
    def host(layer):
        return {k: t.detach().cpu().numpy() for k, t in layer.items()}

    def host_vel(layer):
        if optim.is_adam_state(layer):
            return {"m": host(layer["m"]), "v": host(layer["v"]),
                    "t": np.int32(int(layer["t"]))}
        return host(layer)
    return {"params": tuple(host(p) for p in state["params"]),
            "vel": tuple(host_vel(v) for v in state["vel"]),
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


#: the Decision's counters and the loader's cursor that a granular run
#: carries across
_DECISION_STATE = ("epoch_number", "epoch_n_err", "best_validation_err",
                   "history", "_accum", "_epochs_since_improvement")
_LOADER_STATE = ("epoch_number", "_cursor", "_schedule")


def _jax_velocity(jg, name: str, port_attr: str):
    """The JAX gradient unit's velocity Array of leaf `name`, or None
    where it has none yet: `vel_<name>` (a VJP twin's, every leaf), else
    the port's attribute, the reference's short name for `weights` and
    `bias` (`vel_w` / `vel_b`)."""
    for attr in (f"vel_{name}", port_attr):
        jv = getattr(jg, attr, None)
        if jv is not None and jv:
            return jv
    return None


def granular_from_jax(jax_workflow, workflow) -> None:
    jf, pf = list(jax_workflow.forwards), list(workflow.forwards)
    if len(jf) != len(pf):
        raise ValueError(f"{len(jf)} JAX forward units for {len(pf)} "
                         f"layers")
    params = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()
                    if a} for u in jf)
    _load_into(workflow, params_from_jax(params, workflow.device))
    for i, (jg, pg) in enumerate(zip(jax_workflow.gds, workflow.gds)):
        for name in pg._pnames:
            jv = _jax_velocity(jg, name, pg.vel_attr(name))
            if jv is None:
                continue
            v = np.asarray(jv.mem, np.float32)
            p = getattr(pg, name).devmem()
            if v.shape != tuple(p.shape):
                raise ValueError(f"gradient unit {i} {pg.vel_attr(name)}: "
                                 f"shape {v.shape} != {tuple(p.shape)}")
            setattr(pg, pg.vel_attr(name),
                    torch.tensor(v, device=p.device))
        pg.lr_scale = float(jg.lr_scale)
    je, pe = jax_workflow.evaluator, workflow.evaluator
    pe.loss, pe.n_err = float(je.loss), int(je.n_err)
    jd, pd = jax_workflow.decision, workflow.decision
    for k in _DECISION_STATE:
        setattr(pd, k, copy.deepcopy(getattr(jd, k)))
    pd.complete = bool(jd.complete)
    jl, pl = jax_workflow.loader, workflow.loader
    for k in _LOADER_STATE:
        setattr(pl, k, copy.deepcopy(getattr(jl, k)))
    pl._indices_per_class = [np.array(a, np.int64)
                             for a in jl._indices_per_class]
