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

In the granular graph (JAX transformer.py:32-254) each layer's node runs
the same forward (nn_units.VJPForwardUnit), and its gradient twin is the
vjp of it (nn_units.GradientDescentVJP): `SeqSoftmaxUnit` emits the
probabilities flattened to (N·S, V), so the softmax evaluator scores
per-token rows against the loader's flat labels, and its twin reshapes
the evaluator's (N·S, V) error, the error with respect to the logits,
back to the (N, S, V) logits it differentiates.

Under the fused step's tensor parallelism (mode "gspmd", parallel/tp.py)
each layer runs its own rank program (`fused_apply(..., tp=)`): one 2-D
`weights`, column- or row-parallel by the JAX plan's single-weight rule,
its other leaves (`pos`, `w2`, `b2`) replicated. The sequence-sharded
("seq") mode comes with the next many-GPU slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward, GradientDescentVJP, \
    VJPForwardUnit, register_gd, register_unit


class SeqLinear(Forward):
    """Position-wise linear: x (N, S, Din) -> act(x·W + b [+ pos[:S]])
    (N, S, Dout); W (Din, Dout). Velocities `vel_w`, `vel_b` and, with
    `pos_embed`, `vel_pos`."""

    #: runs its own tensor-parallel rank program (parallel/tp.py)
    tp_program = True

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

    def fused_apply(self, params, x, *, train=False, tp=None):
        """`tp`: this rank's part of the tensor-parallel plan
        (parallel/tp.py UnitRank), None on whole tensors."""
        pos = params.get("pos") if self.pos_embed else None
        if tp is not None and tp.role == "row":
            # x is the rank's block of the features: its rows' partial
            # product, summed; the bias and `pos` replicated
            y = tp.reduce_out(fn.matmul(x, params["weights"])) \
                + params["bias"]
        else:
            if tp is not None and tp.role == "column":
                x = tp.whole(x)
                if pos is not None:
                    # the rank adds its columns of the replicated table;
                    # the table's gradient, zero off them, is all-reduced
                    # (megatron's f), so every rank updates it alike
                    pos = tp.mine(tp.copy_in(pos))
            y = fn.matmul(x, params["weights"]) + params["bias"]
        if pos is not None:
            y = y + pos[:x.shape[1]][None]
        return fn.act_forward(self.activation, y)


class SeqFFN(Forward):
    """Transformer FFN block with residual: x (N, S, E) -> (N, S, E),
    hidden width `hidden`; W1 is `weights` (E, hidden), W2 is `w2`
    (hidden, E). Velocities `vel_w`, `vel_b`, `vel_w2`, `vel_b2`."""

    #: runs its own tensor-parallel rank program (parallel/tp.py)
    tp_program = True

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

    def tp_check(self, role, spec, m) -> None:
        """A column-parallel W1 scatters the output over E: E divides."""
        if role == "column" and self.w2.shape[1] % m:
            raise NotImplementedError(
                f"{self.name}: a column-parallel W1 with an output width "
                f"{self.w2.shape[1]} that {m} ranks do not divide")

    def fused_apply(self, params, x, *, train=False, tp=None):
        """`tp`: this rank's part of the tensor-parallel plan
        (parallel/tp.py UnitRank), None on whole tensors."""
        w1, b1, w2, b2 = (params[k] for k in ("weights", "bias", "w2",
                                              "b2"))
        if tp is not None and tp.role == "row":
            # x is the rank's block of E (the char-transformer's FFN
            # after attention): its rows' partial product summed, then
            # b1, the activation, w2 and b2, replicated and alike on
            # every rank; the residual adds the whole x
            hmid = fn.act_forward(self.activation,
                                  tp.reduce_out(fn.matmul(x, w1)) + b1)
            return tp.gather(x, partial=False) + fn.matmul(hmid, w2) + b2
        if tp is not None and tp.role == "column":
            # a replicated input: the rank's block of the hidden times
            # w2's matching rows, the partial products reduce-scattered
            # over E (the output is the rank's block of E). w2 and b2 are
            # replicated leaves of which the rank uses a block: their
            # gradients, zero off it, are all-reduced (megatron's f)
            x = tp.whole(x)
            hmid = fn.act_forward(self.activation, fn.matmul(x, w1) + b1)
            y = tp.scatter_out(fn.matmul(hmid, tp.mine(tp.copy_in(w2), 0)))
            return tp.mine(x) + y + tp.mine(tp.copy_in(b2))
        hmid = fn.act_forward(self.activation, fn.matmul(x, w1) + b1)
        return x + fn.matmul(hmid, w2) + b2


class SeqSoftmax(SeqLinear):
    """Per-position softmax head: x (N, S, E) -> logits (N, S, V); the
    fused step's cross-entropy applies the log-softmax. Velocities
    `vel_w`, `vel_b`."""

    fused_emits_logits = True


@register_unit(SeqLinear)
@register_unit(SeqFFN)
class SeqUnit(VJPForwardUnit):
    """A position-wise layer's node: (N, S, D) in, (N, S, D') out."""


@register_unit(SeqSoftmax)
class SeqSoftmaxUnit(VJPForwardUnit):
    """softmax of the logits, flattened to (N·S, V) for the evaluator
    (JAX transformer.py:192-229)."""

    def emit(self, y: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(y, dim=-1)
        return probs.reshape(-1, probs.shape[-1])


@register_gd(SeqLinear)
class GDSeqLinear(GradientDescentVJP):
    """Velocities `vel_w`, `vel_b` and, with `pos_embed`, `vel_pos`."""


@register_gd(SeqFFN)
class GDSeqFFN(GradientDescentVJP):
    """Velocities `vel_w`, `vel_b`, `vel_w2`, `vel_b2`."""


@register_gd(SeqSoftmax)
class GDSeqSoftmax(GradientDescentVJP):
    """err_output arrives (N·S, V) from the evaluator, probs − onehot, the
    error with respect to the logits: the twin differentiates the (N, S,
    V) logits with it reshaped to their shape (the JAX twin's
    `_err_reshape`)."""
