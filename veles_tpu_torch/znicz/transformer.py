"""Sequence-preserving (position-wise) layers of a transformer language
model.

The port's counterpart of `veles_tpu/znicz/transformer.py` in the fused
path, local mode: activations keep their (N, S, D) structure,
parameters are filled from the same numpy stream in the same order
(weights, bias, then the unit's own leaves), so one seed gives
bit-identical parameters in both packages.

- `SeqLinear`: y = act(x·W + b), plus the learned position table `pos`
  (`max_seq` rows, S by default) when `pos_embed` — the embedding layer
  of a transformer fed one-hot tokens.
- `SeqFFN`: y = x + W2·act(W1·x + b1) + b2, the reference's scaled tanh
  by default.
- `SeqSoftmax`: the per-token head; emits (N, S, V) logits for the fused
  step's per-token cross-entropy.

Their products promote as the JAX package's `@` does (`fn.matmul`): the
f32 activations after a bf16 step's einsum attention meet bf16 weights
in f32.

The sequence-sharded ("seq") mode and megatron tensor parallelism come
with the many-GPU slice; the granular path's flattened probabilities
with the granular graph.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward


class SeqLinear(Forward):
    """Position-wise linear: x (N, S, Din) -> act(x·W + b [+ pos[:S]])
    (N, S, Dout); W (Din, Dout). Velocities `vel_w`, `vel_b` and, with
    `pos_embed`, `vel_pos`."""

    def __init__(self, output_features: int = 64, activation: str = "linear",
                 pos_embed: bool = False, max_seq: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.output_features = output_features
        self.activation = activation
        self.pos_embed = pos_embed
        self.max_seq = max_seq
        self.pos = None

    def param_arrays(self) -> Dict[str, Any]:
        if self.weights is None:
            return {}
        out = {"weights": self.weights, "bias": self.bias}
        if self.pos_embed:
            out["pos"] = self.pos
        return out

    def initialize(self, sample_shape, device):
        s, din = sample_shape
        dout = self.output_features
        self.init_params((din, dout), din, device)
        if self.pos_embed:
            smax = self.max_seq or s
            if smax < s:
                raise ValueError(
                    f"pos_embed table max_seq={smax} shorter than the "
                    f"input sequence length {s}")
            if self.pos is None:
                std = self.weights_stddev or self.default_stddev(din)
                self.pos = self._param(
                    self._fill((smax, dout), self.weights_filling, std),
                    device)
        return (s, dout)

    def fused_apply(self, params, x, *, train=False):
        y = fn.matmul(x, params["weights"]) + params["bias"]
        if self.pos_embed:
            y = y + params["pos"][:x.shape[1]][None]
        return fn.act_forward(self.activation, y)


class SeqFFN(Forward):
    """Transformer FFN block with residual: x (N, S, E) -> (N, S, E),
    hidden width `hidden`; W1 is `weights` (E, hidden), W2 is `w2`
    (hidden, E). Velocities `vel_w`, `vel_b`, `vel_w2`, `vel_b2`."""

    def __init__(self, hidden: int = 128, activation: str = "tanh",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.hidden = hidden
        self.activation = activation
        self.w2 = None
        self.b2 = None

    def param_arrays(self) -> Dict[str, Any]:
        if self.weights is None:
            return {}
        return {"weights": self.weights, "bias": self.bias, "w2": self.w2,
                "b2": self.b2}

    def initialize(self, sample_shape, device):
        s, e = sample_shape
        h = self.hidden
        self.init_params((e, h), e, device)
        if self.w2 is None:
            std = self.weights_stddev or self.default_stddev(h)
            self.w2 = self._param(self._fill((h, e), self.weights_filling,
                                             std), device)
            self.b2 = self._param(np.zeros((e,), np.float32), device)
        return (s, e)

    def fused_apply(self, params, x, *, train=False):
        hmid = fn.act_forward(self.activation,
                              fn.matmul(x, params["weights"])
                              + params["bias"])
        return x + fn.matmul(hmid, params["w2"]) + params["b2"]


class SeqSoftmax(SeqLinear):
    """Per-position softmax head: x (N, S, E) -> logits (N, S, V); the
    fused step's cross-entropy applies the log-softmax. Velocities
    `vel_w`, `vel_b`."""

    fused_emits_logits = True
