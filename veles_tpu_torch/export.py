"""Forward export: package a trained workflow for the native engine.

The port's copy of `veles_tpu/export.py` (:1-180): a workflow's forward
chain becomes a portable package, `topology.json` (format
`veles_tpu-package-v1`: the forward layers, each with its arrays'
offsets and shapes) and `weights.bin` (the arrays as raw little-endian
float32 blobs, back to back), which `native/znicz_engine.cpp` runs on
the host with no PyTorch in the loop (native_engine.py). The package is
the JAX exporter's, key for key and byte for byte on the same weights.

The weights are the workflow's own tensors (`params_host()`: what the
fused step wrote back and the server serves), or a parameter tree given
as `params`. Every unit family of the port has an exporter but stochastic
pooling, which, like a unit with no native twin in the JAX package, is
refused. The MoE exporter is the JAX `_export_moe` (the resolved route in
the spec); the LSTM exporter comes with its unit.

`export_program` is the counterpart of the JAX module's
`export_stablehlo` (:182 there): the fused eval forward as a portable
program, a `torch.export` `.pt2` in place of StableHLO text.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: unit-class name -> exporter: (layer, {name: host array}) ->
#: (layer_dict, [arrays to pack])
_EXPORTERS: Dict[str, Callable] = {}


def _exporter(*class_names: str):
    def deco(fn):
        for n in class_names:
            _EXPORTERS[n] = fn
        return fn
    return deco


@_exporter("All2All", "All2AllTanh", "All2AllRELU", "All2AllStrictRELU",
           "All2AllSigmoid")
def _export_all2all(u, p) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    return ({"type": "all2all", "activation": u.activation},
            [p["weights"], p["bias"]])


@_exporter("All2AllSoftmax")
def _export_softmax(u, p):
    return ({"type": "all2all", "activation": "linear", "softmax": True},
            [p["weights"], p["bias"]])


@_exporter("Conv", "ConvTanh", "ConvRELU", "ConvStrictRELU", "ConvSigmoid")
def _export_conv(u, p):
    return ({"type": "conv", "activation": u.activation,
             "stride": list(u.stride), "padding": list(u.padding)},
            [p["weights"], p["bias"]])


@_exporter("MaxPooling", "MaxAbsPooling")
def _export_maxpool(u, p):
    # the engine pools in ceil mode with truncated edge windows, as the
    # port's forward does (pooling.Pooling, fn.pool_out_hw)
    return ({"type": "max_pooling", "ksize": list(u.ksize),
             "stride": list(u.stride),
             "use_abs": bool(getattr(u, "use_abs", False))}, [])


@_exporter("AvgPooling")
def _export_avgpool(u, p):
    return ({"type": "avg_pooling", "ksize": list(u.ksize),
             "stride": list(u.stride)}, [])


@_exporter("LRNormalizerForward")
def _export_lrn(u, p):
    return ({"type": "lrn", "k": u.k, "alpha": u.alpha, "beta": u.beta,
             "n": u.n}, [])


@_exporter("DropoutForward")
def _export_dropout(u, p):
    # inference: dropout is identity (the reference exported it the same way)
    return ({"type": "identity"}, [])


@_exporter("ActivationTanh", "ActivationRELU", "ActivationStrictRELU",
           "ActivationSigmoid", "ActivationLog")
def _export_activation(u, p):
    return ({"type": "activation", "activation": u.activation}, [])


@_exporter("SeqLinear", "SeqSoftmax")
def _export_seq_linear(u, p):
    # SeqSoftmax flattens to (N*S, V) with a per-position softmax — the
    # engine mirrors that layout (native/znicz_engine.cpp:seq_linear)
    spec = {"type": ("seq_softmax" if type(u).__name__ == "SeqSoftmax"
                     else "seq_linear"),
            "activation": u.activation}
    arrays = [p["weights"]]
    if u.pos_embed:
        spec["pos_embed"] = True
        arrays.append(p["pos"])
    arrays.append(p["bias"])
    return spec, arrays


@_exporter("SeqFFN")
def _export_seq_ffn(u, p):
    return ({"type": "seq_ffn", "activation": u.activation},
            [p["weights"], p["bias"], p["w2"], p["b2"]])


@_exporter("MultiHeadAttention")
def _export_attention(u, p):
    return ({"type": "attention", "head_dim": int(u.head_dim),
             "causal": bool(u.causal), "residual": bool(u.residual)},
            [p["wq"], p["wk"], p["wv"], p["wo"]])


@_exporter("MoELayer")
def _export_moe(u, p):
    # the resolved route rides in the spec (the engine cannot resolve
    # "auto" against the training-time shapes); the arrays in router-then-
    # expert order
    return ({"type": "moe", "n_experts": int(u.n_experts),
             "hidden": int(u.hidden),
             "capacity_factor": float(u.capacity_factor),
             "residual": bool(u.residual),
             "route": "token" if u.token_wise() else "sample"},
            [p["wr"], p["w1"], p["b1"], p["w2"], p["b2"]])


@_exporter("InputNormalize")
def _export_input_normalize(u, p):
    # the engine applies y = x*scale + offset - mean, so uint8-pipeline
    # models deploy with their training-time normalization baked in
    arrays = ([np.asarray(u.mean, np.float32)]
              if u.mean is not None else [])
    return ({"type": "affine", "scale": float(u.scale),
             "offset": float(u.offset)}, arrays)


def export_workflow(workflow, directory: str,
                    params: Optional[Sequence[Dict[str, Any]]] = None
                    ) -> str:
    """Write topology.json + weights.bin for the workflow's forward chain
    into `directory` (made if absent) and return it. `params` (one
    `{name: array}` per forward unit, as `params_host()` gives them)
    replaces the workflow's own weights. Raises ValueError on a unit with
    no native twin, and before writing anything."""
    forwards = list(workflow.forwards)
    if params is None:
        params = workflow.params_host()
    params = list(params)
    if len(params) != len(forwards):
        raise ValueError(f"{len(params)} parameter sets for "
                         f"{len(forwards)} forward units")
    blobs: List[np.ndarray] = []
    layers: List[Dict[str, Any]] = []
    for u, p in zip(forwards, params):
        name = type(u).__name__
        if name not in _EXPORTERS:
            raise ValueError(f"no native exporter for unit {name}; export "
                             f"the fused forward via export_program "
                             f"instead")
        spec, arrays = _EXPORTERS[name](
            u, {k: np.asarray(a.detach().cpu() if hasattr(a, "detach")
                              else a) for k, a in p.items()})
        offset = sum(int(a.size) for a in blobs)
        packed = []
        for a in arrays:
            a = np.ascontiguousarray(a, np.float32)
            packed.append({"offset": offset, "shape": list(a.shape)})
            offset += int(a.size)
            blobs.append(a)
        spec["arrays"] = packed
        layers.append(spec)
    manifest = {
        "format": "veles_tpu-package-v1",
        "input_shape": list(workflow.loader.sample_shape),
        "layers": layers,
    }
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "topology.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(directory, "weights.bin"), "wb") as f:
        for a in blobs:
            f.write(a.astype("<f4").tobytes())
    return directory


def export_program(workflow, path: str, batch: int = 1) -> str:
    """Write the fused eval forward (the logits, as `FusedForward._forward`
    returns them) at `batch` rows as a `torch.export` program to `path`
    (a `.pt2`) and return it: the port's counterpart of the JAX
    `export_stablehlo` (veles_tpu/export.py:182). As the StableHLO module
    takes the parameters as arguments, the program takes them as inputs:
    `torch.export.load(path).module()(x, params)` with x (batch, *sample
    shape) f32 on the workflow's device and params one `{name: tensor}`
    per forward unit (`workflow.build_forward().params()`). K2 and K4 are
    calls of the `veles::` operators: import
    `veles_tpu_torch.ops.kernels` before loading it (a program is code:
    load only what you would run)."""
    import torch

    from veles_tpu_torch.serving_aot import export_forward
    fwd = workflow.build_forward()
    params = tuple({k: t.detach() for k, t in layer.items()}
                   for layer in fwd.params())
    x = torch.zeros((int(batch),) + tuple(workflow.loader.sample_shape),
                    dtype=torch.float32, device=fwd.device)
    torch.export.save(export_forward(fwd._forward, x, params), path)
    return path
