"""The serving signature's model-geometry block.

The port's part of `veles_tpu/serving_aot.py` that a hot swap needs:
`model_signature` (:57-73 there), the per-layer parameter shapes and
dtypes the server was built for, which `InferenceServer.swap_params`
holds a candidate to verbatim. The persisted serving artifact of the
JAX module (`ServingAotCache`, `serve_signature`, `call_trees`: a
compiled executable stored per model, ring shape and wire) comes with a
later slice, as a `torch.export` / AOTInductor package or a CUDA graph
of the fixed-shape ring.
"""

from __future__ import annotations

__all__ = ["model_signature"]


def _dtype_name(a) -> str:
    """A leaf's dtype by the JAX package's name ("float32", ...)."""
    return str(getattr(a, "dtype", "float32")).split(".")[-1]


def model_signature(workflow) -> list:
    """Per forward unit, its type's name and each parameter's shape and
    dtype: the geometry the served forward was built for."""
    layers = []
    for u in getattr(workflow, "forwards", ()):
        layers.append({
            "type": type(u).__name__,
            "params": {k: [list(getattr(a, "shape", ()) or ()),
                           _dtype_name(a)]
                       for k, a in u.param_arrays().items()},
        })
    return layers
