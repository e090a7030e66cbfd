"""Checkpoint of the fused step's state: `save_state` / `restore_state`.

The port's counterpart of `veles_tpu/parallel/checkpoint.py` for the
local state of one device. The Snapshotter's whole-workflow pickle holds
the parameters and the SGD velocities (`write_back` puts them into the
units and the gradient twins), but not Adam's moments, which live only in
the step's state: this module carries the whole state, moments and `t`
included.

The port's own format, not Orbax's: one file `state.pt` in the
directory, written by `torch.save` to a temporary file, fsynced and
renamed into place (a reader never sees a torn file), and read with
`torch.load(weights_only=True)`. It holds every tensor of the state as a
host tensor under its key path (`params/<unit>/<leaf>`,
`vel/<unit>/<leaf>` for an SGD layer, `vel/<unit>/m/<leaf>`,
`vel/<unit>/v/<leaf>` and `vel/<unit>/t` for an Adam layer, `lr_scale`),
and the position of the dropout stream the step draws from
(`prng/<device type>`): the JAX state's PRNG key has no counterpart in
the port's state, whose masks come from the registry's device stream, so
the stream's position rides beside the tensors and a restore puts it
back into the step's stream. Training then continues from a restored
state as it would have from the saved one, dropout included.

`restore_state(step, directory)` builds its target from the step's units
and update configs (shapes and dtypes read on the host, as the JAX
function uses `eval_shape`: nothing is allocated before the file is
read), compares it with the file leaf by leaf, and raises
`CheckpointGeometryError` naming every leaf that differs, before any
tensor reaches the device or the stream moves: a checkpoint that does not
match is never loaded in part. A file that cannot be read (cut short,
not a checkpoint) raises a RuntimeError from the reader.

A data-parallel state (JAX `_vel_reshard_restore`, `_target_shardings`):
`save_state(state, dir, step)` gathers a ZeRO state into the local
layout first (`FusedTrainStep.gather_state`, a collective: every rank
calls it) and the coordinator alone writes it; `restore_state` gives
every rank its own slices of the restored state (`shard_state`), so a
checkpoint restores at any world size. An expert-parallel state (`ep`:
each rank holding E/R experts of every MoE layer) and a tensor-parallel
one (gspmd: each rank holding its blocks of the megatron plan) are
gathered and sharded the same way, so they too restore at another world
or model size, or in local mode. The
error-feedback residual of
an int8_ef update is not saved: a restore restarts it at zero, as the
JAX module does across data-axis sizes. The stream restored is the
registry's (rank 0's; a rank past the first keeps its own).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, List, Tuple

import torch

from veles_tpu_torch import prng
from veles_tpu_torch.ops import optim

#: what the file holds, checked on restore
FORMAT = "veles_tpu_torch.fused_state/1"
FILE = "state.pt"


class CheckpointGeometryError(RuntimeError):
    """A restore hit a mismatch between the saved state and the restore
    target: leaves on one side only, or other shapes or dtypes (a
    checkpoint of a differently shaped model, another update rule, another
    device's stream). `mismatches` holds one line per leaf, so the fix
    (rebuild the step as it was saved, or point at the right checkpoint)
    shows in the message."""

    def __init__(self, message: str, mismatches=None) -> None:
        super().__init__(message)
        self.mismatches = list(mismatches or [])


def _state_leaves(state: Dict[str, Any]) -> Iterator[Tuple[str, Any]]:
    """(key path, tensor) of every tensor in the state."""
    for i, layer in enumerate(state["params"]):
        for k, t in layer.items():
            yield f"params/{i}/{k}", t
    for i, layer in enumerate(state["vel"]):
        if optim.is_adam_state(layer):
            for slot in ("m", "v"):
                for k, t in layer[slot].items():
                    yield f"vel/{i}/{slot}/{k}", t
            yield f"vel/{i}/t", layer["t"]
        else:
            for k, t in layer.items():
                yield f"vel/{i}/{k}", t


def _state_device(state: Dict[str, Any]) -> torch.device:
    for layer in state["params"]:
        for t in layer.values():
            return t.device
    return torch.device("cpu")


def save_state(state: Dict[str, Any], directory: str, step=None) -> str:
    """Write `state` (a FusedTrainStep state) and the position of its
    device's dropout stream to `directory`/state.pt; returns the path.
    With the dp or gspmd `step` that trains it, the state is gathered
    first (every rank must call) and only the coordinator writes."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, FILE)
    if step is not None:
        state = step.gather_state(state)
        from veles_tpu_torch.parallel.distributed import is_coordinator
        if getattr(step, "mode", "local") in ("dp", "gspmd") \
                and not is_coordinator():
            return path
    os.makedirs(directory, exist_ok=True)
    leaves = {key: t.detach().to("cpu", copy=True)
              for key, t in _state_leaves(state)}
    leaves["lr_scale"] = torch.tensor(float(state["lr_scale"]),
                                      dtype=torch.float64)
    dev = _state_device(state)
    leaves[f"prng/{dev.type}"] = prng.get().device_stream(dev).get_state()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"format": FORMAT, "leaves": leaves}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _target(step) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{key path: (shape, dtype)} of the state `step` trains, from its
    units' parameters and update configs: host metadata only."""
    out = {}
    for i, (u, cfg) in enumerate(zip(step.forwards, step.cfgs)):
        shapes = {k: (tuple(t.shape), t.dtype)
                  for k, t in u.param_arrays().items()}
        for k, sd in shapes.items():
            out[f"params/{i}/{k}"] = sd
        if isinstance(cfg, optim.AdamConfig):
            for slot in ("m", "v"):
                for k, sd in shapes.items():
                    out[f"vel/{i}/{slot}/{k}"] = sd
            out[f"vel/{i}/t"] = ((), torch.int32)
        else:
            for k, sd in shapes.items():
                out[f"vel/{i}/{k}"] = sd
    out["lr_scale"] = ((), torch.float64)
    stream = step.gen.get_state()
    out[f"prng/{step.device.type}"] = (tuple(stream.shape), stream.dtype)
    return out


def _describe(shape, dtype) -> str:
    return f"{tuple(shape)}/{str(dtype).replace('torch.', '')}"


def _mismatches(saved: Dict[str, torch.Tensor], want) -> List[str]:
    """One line per leaf on one side only or of another shape or dtype,
    in the JAX module's words."""
    lines = []
    for k in sorted(set(saved) | set(want)):
        if k not in want:
            lines.append(f"{k}: in checkpoint only (saved "
                         f"{_describe(saved[k].shape, saved[k].dtype)})")
        elif k not in saved:
            lines.append(f"{k}: in restore target only (want "
                         f"{_describe(*want[k])})")
        elif _describe(saved[k].shape, saved[k].dtype) \
                != _describe(*want[k]):
            lines.append(f"{k}: saved "
                         f"{_describe(saved[k].shape, saved[k].dtype)} != "
                         f"target {_describe(*want[k])}")
    return lines


def restore_state(step, directory: str) -> Dict[str, Any]:
    """The state saved by `save_state` in `directory`, on `step`'s device,
    its parameters trainable; the step's dropout stream is set to the
    saved position. Raises CheckpointGeometryError, before anything is
    loaded, where the file does not hold the state `step` trains."""
    path = os.path.join(os.path.abspath(directory), FILE)
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
        raise RuntimeError(f"checkpoint at {path} is unreadable (cut "
                           f"short, or not a checkpoint): {e}") from e
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise RuntimeError(f"{path} is not a {FORMAT} checkpoint")
    saved = blob["leaves"]
    mismatches = _mismatches(saved, _target(step))
    if mismatches:
        head = mismatches[:12]
        more = len(mismatches) - len(head)
        detail = "\n  ".join(head) + (f"\n  … and {more} more"
                                      if more else "")
        raise CheckpointGeometryError(
            f"checkpoint at {path} does not match the step's state "
            f"geometry ({len(mismatches)} mismatched leaves) — rebuild the "
            f"step with the save-time layer configuration or point at the "
            f"right checkpoint:\n  {detail}", mismatches)
    dev = step.device

    def put(key: str) -> torch.Tensor:
        return saved[key].to(dev)

    params, vel = [], []
    for i, (u, cfg) in enumerate(zip(step.forwards, step.cfgs)):
        names = list(u.param_arrays())
        params.append({k: put(f"params/{i}/{k}").requires_grad_(True)
                       for k in names})
        if isinstance(cfg, optim.AdamConfig):
            vel.append({slot: {k: put(f"vel/{i}/{slot}/{k}")
                               for k in names} for slot in ("m", "v")})
            vel[-1]["t"] = put(f"vel/{i}/t")
        else:
            vel.append({k: put(f"vel/{i}/{k}") for k in names})
    prng.get().device_stream(dev).set_state(saved[f"prng/{dev.type}"])
    state = {"params": tuple(params), "vel": tuple(vel),
             "lr_scale": float(saved["lr_scale"])}
    return step.shard_state(state)
