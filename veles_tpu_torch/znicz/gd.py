"""Gradient units for fully-connected layers.

The port's counterpart of `veles_tpu/znicz/gd.py` (:28-119 there; parity:
reference `veles/znicz/gd.py`): `GradientDescent` (the linear twin),
`GDTanh`, `GDRELU`, `GDStrictRELU`, `GDSigmoid` and `GDSoftmax`. The
softmax twin receives the error with respect to the LOGITS from the
evaluator (probs − onehot), so its activation derivative is the
identity, the reference's convention.

The backward is the reference's: pre = act_backward(y, err_output),
dW = x·ᵀpre, db = Σ pre, err_input = pre·Wᵀ — the golden
`reference.all2all_backward` on the numpy backend, the same products in
f32 on the unit's device on the torch one, where the update goes through
the registry's `sgd_update` lowering, K1 on the card.
"""

from __future__ import annotations

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz import all2all
from veles_tpu_torch.znicz.nn_units import GradientDescentBase, dev, host, \
    register_gd


@register_gd(all2all.All2All)
class GradientDescent(GradientDescentBase):
    """Backward of the All2All family; `activation` mirrors the forward
    twin's and drives the output-expressed derivative."""

    activation = "linear"

    def numpy_run(self) -> None:
        y, ey = host(self.output), host(self.err_output)
        err_x, dw, db = ref.all2all_backward(
            host(self.input), self.weights.mem, y.reshape(len(y), -1),
            ey.reshape(len(ey), -1), self.activation)
        self._update_host({"weights": dw, "bias": db})
        self.err_input.mem = err_x

    def torch_run(self) -> None:
        d = self.device
        x = dev(self.input, d)
        y, ey = dev(self.output, d), dev(self.err_output, d)
        pre = fn.act_backward(self.activation, y.reshape(len(y), -1),
                              ey.reshape(len(ey), -1))
        x2 = x.reshape(len(x), -1)
        w = self.weights.devmem()
        # err_input before the update, which writes w in place
        self.err_input.set_devmem((pre @ w.T).reshape(x.shape))
        self._update({"weights": x2.T @ pre, "bias": pre.sum(dim=0)})


@register_gd(all2all.All2AllTanh)
class GDTanh(GradientDescent):
    activation = "tanh"


@register_gd(all2all.All2AllRELU)
class GDRELU(GradientDescent):
    activation = "relu"


@register_gd(all2all.All2AllStrictRELU)
class GDStrictRELU(GradientDescent):
    activation = "strictrelu"


@register_gd(all2all.All2AllSigmoid)
class GDSigmoid(GradientDescent):
    activation = "sigmoid"


@register_gd(all2all.All2AllSoftmax)
class GDSoftmax(GradientDescent):
    """err_output from the softmax evaluator is already with respect to
    the logits (probs − onehot): the derivative pass-through is the
    identity."""

    activation = "linear"
