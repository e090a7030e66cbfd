"""The persisted serving program: a server's ring forward, exported once
per (model, ring shape, wire) and loaded by the next start.

The port's counterpart of `veles_tpu/serving_aot.py`. The JAX module
persists a compiled XLA executable so that a replica's restart pays a
deserialization instead of a compile. The port has no compile to spare
(its kernels are built once per checkout, ops/kernels.py `build`), so
what it persists is the same thing as a portable program: a
`torch.export` of the ring forward of one wire (f32, bf16, or int8 with
its decode inside the program) at the ring's fixed shape, saved with
`torch.export.save` (a `.pt2`). The kernels K2 and K4 appear in it as
the operators `veles::lrn_forward` and `veles::lrn_maxpool_forward`
(ops/kernels.py), so that a loaded program calls the hand kernels;
loading imports ops/kernels.py first, which registers them. The
parameters are inputs of the program, not constants in it: a hot swap
(`InferenceServer.swap_params`) and a rollback feed a loaded program
new parameters without exporting it again, which is why the signature
keeps the model's geometry (`model_signature`) apart from its values.

The cache keeps the JAX module's persistence discipline:

- an explicitly schema-tagged atomic-JSON index (`{"schema", "version",
  "entries"}`) plus one blob per program, both written tmp-then-
  `os.replace` so readers never see a torn file;
- a corrupt index, an unknown schema, a version skew, a missing or
  sha256-mismatched blob, or a failed load each log ONE warning and the
  caller exports anew — never a failed start;
- the full build signature (`serve_signature`: the model's layer and
  parameter geometry, the ring shape, the wire, the lowerings the forward
  runs, the torch version and the device kind) is hashed into the key AND
  stored verbatim in the entry: a key hit whose stored signature does not
  match the request is REFUSED with a warning.

Trust model: the cache directory is operator-local state with the same
trust level as the autotune cache — a serialized program IS code, so
never point `VELES_SERVING_AOT_CACHE` at a directory less trusted than
the python environment itself. The sha256 in the index detects
corruption, not tampering (whoever can edit the blob can edit the
index).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

from veles_tpu_torch.logger import Logger

__all__ = ["AOT_CACHE_ENV", "ServingAotCache", "call_trees",
           "default_aot_path", "export_forward", "model_signature",
           "serve_signature"]

#: env override for the cache location (the autotune-cache convention)
AOT_CACHE_ENV = "VELES_SERVING_AOT_CACHE"


def default_aot_path() -> str:
    """Index path: `$VELES_SERVING_AOT_CACHE`, else beside the autotune
    cache (`~/.cache/veles_tpu_torch/serving_aot.json`)."""
    return (os.environ.get(AOT_CACHE_ENV)
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "veles_tpu_torch", "serving_aot.json"))


def _dtype_name(a) -> str:
    """A leaf's dtype by the JAX package's name ("float32", ...)."""
    return str(getattr(a, "dtype", "float32")).split(".")[-1]


def model_signature(workflow) -> list:
    """Per forward unit, its type's name and each parameter's shape and
    dtype: the geometry the served forward was built for, which a hot
    swap candidate must match verbatim."""
    layers = []
    for u in getattr(workflow, "forwards", ()):
        layers.append({
            "type": type(u).__name__,
            "params": {k: [list(getattr(a, "shape", ()) or ()),
                           _dtype_name(a)]
                       for k, a in u.param_arrays().items()},
        })
    return layers


def _device_kind(device) -> str:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def serve_signature(workflow, mesh, ring_slots: int, quantize: str,
                    softmax: bool, sample_shape,
                    variants: Optional[Dict[str, str]] = None,
                    device=None) -> Dict[str, Any]:
    """The FULL build signature of one serving program: the model's
    layer and parameter geometry, the mesh (None: one card, until
    `--serve-mesh`), the ring shape, the wire, the lowerings the forward
    runs (`variants`: a re-tuned lowering must not serve a stale
    program), the torch version and the device kind. One rule for the
    cache key, the stored entry and the load-time check."""
    import torch
    return {
        "model": model_signature(workflow),
        "mesh": mesh,
        "ring_slots": int(ring_slots),
        "sample_shape": [int(s) for s in sample_shape],
        "quantize": str(quantize),
        "softmax": bool(softmax),
        "variants": dict(variants or {}),
        "torch": torch.__version__,
        "device_kind": _device_kind(device if device is not None
                                    else workflow.device),
    }


def call_trees(args: Tuple) -> Tuple[Any, Any]:
    """(in_spec, out_spec) of a serving program called as `fn(*args) ->
    one tensor`: the flat argument order (the ring batch, then every
    parameter leaf, layer by layer, int8 leaves as their codes and
    scales), a pure function of the host-side structure of the arguments.
    A loaded program whose own specs differ is refused."""
    import torch
    from torch.utils import _pytree
    return (_pytree.tree_structure((tuple(args), {})),
            _pytree.tree_structure(torch.zeros(1)))


def export_forward(fn, x, params):
    """`torch.export` of `fn(params, x) -> tensor` at the shapes of `x`
    and `params` (the program's arguments, in that order: `(x,
    params)`), traced without gradients. `fn` must reach the kernels
    through their operators (ops/kernels.py `lrn_forward_op`,
    `lrn_maxpool_forward_op`), which the program then calls: the trace
    runs inside `kernels.operators_traced()`."""
    import torch

    from veles_tpu_torch.ops import kernels

    class _Forward(torch.nn.Module):
        def forward(self, x, params):
            return fn(params, x)

    with torch.no_grad(), kernels.operators_traced():
        program = torch.export.export(_Forward(), (x, params),
                                      strict=False)
    # the program keeps its example inputs, the parameters among them, to
    # save them beside the graph: a program is not a copy of the weights
    try:
        program.example_inputs = None
    except AttributeError:      # a torch whose program cannot drop them
        pass
    return program


class ServingAotCache(Logger):
    """On-disk (index JSON + blob per program) cache of exported serving
    programs. `load` returns a loaded `torch.export.ExportedProgram` or
    None (a miss is silent; a refusal or a corrupt artifact warns once,
    and the caller exports anew); `store` persists a freshly exported
    one atomically."""

    SCHEMA = "veles-serving-aot"
    VERSION = 1

    def __init__(self, path: Optional[str] = None) -> None:
        super().__init__()
        self.path = path or default_aot_path()
        self._data: Optional[Dict[str, Any]] = None

    # -- index ---------------------------------------------------------------

    def _load_index(self) -> Dict[str, Any]:
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
                    f"{raw.get('schema', '<none>')} "
                    f"v{raw.get('version')})")
            self._data = entries
        except FileNotFoundError:
            self._data = {}
        except (OSError, ValueError, AttributeError) as e:
            # once per cache object: _data keeps the empty dict
            self.warning("serving AOT cache %s unreadable (%s): "
                         "exporting anew", self.path, e)
            self._data = {}
        return self._data

    def _write_index(self, data: Dict[str, Any]) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"schema": self.SCHEMA, "version": self.VERSION,
                       "entries": data}, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)  # atomic: readers never see a torn file

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def key(signature: Dict[str, Any]) -> str:
        blob = json.dumps(signature, sort_keys=True, default=str)
        h = hashlib.sha256(blob.encode()).hexdigest()[:16]
        kind = signature.get("device_kind") or "local"
        return f"{kind}|serve|{h}"

    def _blob_path(self, key: str) -> str:
        base = os.path.splitext(self.path)[0]
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in key)
        return f"{base}.{safe}.pt2"

    def entry(self, signature: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The index entry stored under `signature`'s key, or None."""
        entry = self._load_index().get(self.key(signature))
        return entry if isinstance(entry, dict) else None

    # -- load / store --------------------------------------------------------

    def load(self, signature: Dict[str, Any], in_spec=None):
        """The persisted program for `signature`, loaded — or None after
        ONE warning (a miss is silent; a refusal or corruption warns).
        `in_spec` is `call_trees(args)[0]` of the caller's arguments: a
        program taking another argument structure is refused."""
        key = self.key(signature)
        entry = self.entry(signature)
        if entry is None:
            return None
        if entry.get("signature") != signature:
            # a key collision, a hand-edited index, or an artifact
            # exported for another (model, ring, wire) build
            self.warning(
                "serving AOT cache: refusing stale artifact %s — stored "
                "signature does not match this (model, ring, wire) "
                "build; exporting anew", key)
            return None
        blob_path = entry.get("file") or self._blob_path(key)
        try:
            with open(blob_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            self.warning("serving AOT cache: blob %s unreadable (%s): "
                         "exporting anew", blob_path, e)
            return None
        if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
            self.warning(
                "serving AOT cache: blob %s corrupt (sha256 mismatch): "
                "exporting anew", blob_path)
            return None
        try:
            import io

            import torch

            # the program calls veles:: operators: register them first
            from veles_tpu_torch.ops import kernels  # noqa: F401
            program = torch.export.load(io.BytesIO(blob))
            if in_spec is not None \
                    and program.call_spec.in_spec != in_spec:
                raise ValueError("the program takes another argument "
                                 "structure than this server's")
            return program
        except Exception as e:  # noqa: BLE001 — a bad artifact must
            # degrade to an export, never fail the server start
            self.warning("serving AOT cache: load of %s failed (%s): "
                         "exporting anew", blob_path, e)
            return None

    def store(self, signature: Dict[str, Any], program) -> Optional[str]:
        """Save `program` (`torch.export.save`) and persist blob + index
        entry atomically. Returns the blob path, or None when it cannot
        be saved (logged once; the server still serves the program it
        exported, and the next start exports again)."""
        import io

        import torch
        try:
            buf = io.BytesIO()
            torch.export.save(program, buf)
            blob = buf.getvalue()
        except Exception as e:  # noqa: BLE001 — persistence is an
            # optimization; the exported program still serves
            self.warning("serving AOT cache: the program cannot be "
                         "saved (%s): the next start exports again", e)
            return None
        key = self.key(signature)
        blob_path = self._blob_path(key)
        tmp = f"{blob_path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(blob_path) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, blob_path)
            data = self._load_index()
            data[key] = {
                "signature": signature,
                "file": blob_path,
                "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": len(blob),
            }
            self._write_index(data)
        except OSError as e:
            self.warning("serving AOT cache: persist to %s failed (%s)",
                         blob_path, e)
            return None
        return blob_path
